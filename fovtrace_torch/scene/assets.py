"""OBJ assets -> Scene: materials, textures, multi-model scenes
(counterpart of `fovtrace/scene/assets.py`).

  - each model is an OBJ file, a material kind (diffuse, reflection,
    refraction) and a 4x4 transform baked into world-space vertices
  - a diffuse model gets one material row per MTL record (Kd and its
    map_Kd texture); reflective and refractive models get the fixed
    parameter sets of `Materials.create`
  - every map_Kd texture is loaded (PPM, BMP, PNG), resized nearest to
    one common size and stacked into the scene's texture atlas

Scenes are built on the host (numpy, the native BVH builder, CPU
tensors for the pack) and then moved to their device once.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import List, Optional, Sequence, Tuple

import numpy as np

from fovtrace_torch import native
from fovtrace_torch.scene import image_io
from fovtrace_torch.scene import obj as obj_mod
from fovtrace_torch.scene import procedural
from fovtrace_torch.scene.scene import (MATL_DIFFUSE, MATL_REFLECTION,
                                        MATL_REFRACTION, Materials,
                                        ParallelogramLight, Scene,
                                        merge_meshes, transform_vertices)

_KIND_BY_NAME = {"diffuse": MATL_DIFFUSE, "reflection": MATL_REFLECTION,
                 "refraction": MATL_REFRACTION}


@dataclasses.dataclass
class ModelSpec:
    """One model of a multi-model scene: file, material kind, transform."""

    path: str
    material: str = "diffuse"            # diffuse | reflection | refraction
    scale: float = 1.0
    translate: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    transform: Optional[np.ndarray] = None   # a full 4x4 overrides the two
    kd: Optional[Tuple[float, float, float]] = None  # overrides the albedo

    def matrix(self) -> np.ndarray:
        if self.transform is not None:
            return np.asarray(self.transform, np.float32)
        m = np.eye(4, dtype=np.float32)
        m[0, 0] = m[1, 1] = m[2, 2] = self.scale
        m[:3, 3] = self.translate
        return m


def _load_texture(path: str) -> Optional[np.ndarray]:
    """A PPM / BMP / PNG albedo texture as float32 [H,W,3] in [0,1]; None
    for another extension or a file that cannot be read (the material
    then has no texture, as in the reference). A PNG first needs the
    unfilter library: that it fails to build or load raises here, and is
    not taken for an unreadable file."""
    low = path.lower()
    if low.endswith(".png"):
        native.png_lib()
    try:
        if low.endswith((".ppm", ".pgm")):
            img = image_io.load_ppm(path)
        elif low.endswith(".bmp"):
            img = image_io.load_bmp(path)
        elif low.endswith(".png"):
            img = image_io.load_png(path)
        else:
            return None
    except (OSError, ValueError):
        return None
    return img[..., :3].astype(np.float32)


def _resize_nearest(img: np.ndarray, h: int, w: int) -> np.ndarray:
    ys = (np.arange(h) * img.shape[0] // h).clip(0, img.shape[0] - 1)
    xs = (np.arange(w) * img.shape[1] // w).clip(0, img.shape[1] - 1)
    return img[ys[:, None], xs[None, :]]


def build_texture_atlas(images: Sequence[np.ndarray],
                        max_dim: int = 1024) -> np.ndarray:
    """Textures of any sizes as one [N,H,W,3] atlas: each resampled
    (nearest) to the largest height and width, capped at max_dim."""
    if not images:
        return np.ones((1, 1, 1, 3), np.float32)
    h = min(max_dim, max(im.shape[0] for im in images))
    w = min(max_dim, max(im.shape[1] for im in images))
    return np.stack([im if im.shape[:2] == (h, w)
                     else _resize_nearest(im, h, w)
                     for im in images]).astype(np.float32)


def _diffuse_rows(mtl: dict, obj_dir: str, textures: List[np.ndarray],
                  kd_override=None) -> List[dict]:
    """Material rows of a diffuse model, one per MTL record (Kd, and
    map_Kd appended to `textures`)."""
    rows = []
    for name in list(mtl.keys()) or ["__default__"]:
        rec = mtl.get(name, {}) or {}
        kd = kd_override or rec.get("kd", (0.7, 0.7, 0.7))
        tex_id = -1
        map_kd = rec.get("map_kd")
        if map_kd:
            img = _load_texture(map_kd if os.path.isabs(map_kd)
                                else os.path.join(obj_dir, map_kd))
            if img is not None:
                tex_id = len(textures)
                textures.append(img)
        rows.append({"kind": MATL_DIFFUSE, "kd": tuple(kd),
                     "texture_id": tex_id})
    return rows


def _specular_row(kind: int, kd_override=None) -> dict:
    """The one material row of a reflective or refractive model."""
    kd = kd_override or ((0.7, 0.7, 0.7) if kind == MATL_REFLECTION
                         else (1.0, 1.0, 1.0))
    return {"kind": kind, "kd": tuple(kd), "texture_id": -1}


def _vertex_normals_for(verts: np.ndarray, tris: np.ndarray) -> np.ndarray:
    """Area-weighted vertex normals of a model without vn records."""
    tris = np.asarray(tris, np.int64)
    fv0 = verts[tris[:, 0]]
    fn = np.cross(verts[tris[:, 1]] - fv0, verts[tris[:, 2]] - fv0)
    normals = np.zeros_like(verts)
    for k in range(3):
        np.add.at(normals, tris[:, k], fn)
    lens = np.linalg.norm(normals, axis=-1, keepdims=True)
    return (normals / np.maximum(lens, 1e-12)).astype(np.float32)


def _build(vertices, triangles, mat_ids, mat_rows, normals, uvs, light,
           envmap, atlas, device) -> Scene:
    materials = Materials.create(
        kinds=[r["kind"] for r in mat_rows], kds=[r["kd"] for r in mat_rows],
        textures=[r["texture_id"] for r in mat_rows])
    scene = Scene.build(vertices, triangles, mat_ids, materials,
                        normals=normals, uvs=uvs, light=light, envmap=envmap,
                        textures=atlas)
    return scene.with_bvh().to(device)


def scene_from_objs(models: Sequence[ModelSpec],
                    light: Optional[ParallelogramLight] = None,
                    envmap: Optional[np.ndarray] = None,
                    light_power: float = 810.0, max_texture_dim: int = 1024,
                    device="cuda") -> Scene:
    """One flat Scene from OBJ models, each with its material kind and
    transform."""
    all_v, all_t, all_m, all_n, all_uv = [], [], [], [], []
    mat_rows: List[dict] = []
    textures: List[np.ndarray] = []
    voffsets: List[int] = []
    voff = 0
    for spec in models:
        voffsets.append(voff)
        verts, tris, normals, uvs, face_mat, mtl = obj_mod.load_obj(spec.path)
        verts = transform_vertices(verts, spec.matrix())
        if normals is not None and spec.transform is not None:
            # a general transform moves normals by its inverse transpose
            lin = np.asarray(spec.transform, np.float32)[:3, :3]
            normals = normals @ np.linalg.inv(lin)
            lens = np.linalg.norm(normals, axis=-1, keepdims=True)
            normals = normals / np.maximum(lens, 1e-12)
        kind = _KIND_BY_NAME[spec.material]
        base = len(mat_rows)
        if kind == MATL_DIFFUSE:
            mat_rows.extend(_diffuse_rows(mtl, os.path.dirname(spec.path),
                                          textures, spec.kd))
            # faces before any usemtl (-1) take the model's first material
            fm = np.where(face_mat >= 0, face_mat, 0).astype(np.int32) + base
        else:
            mat_rows.append(_specular_row(kind, spec.kd))
            fm = np.full((tris.shape[0],), base, np.int32)
        all_v.append(verts)
        all_t.append(np.asarray(tris, np.int64) + voff)
        all_m.append(fm)
        all_n.append(normals)
        all_uv.append(uvs)
        voff += verts.shape[0]

    # Scene.build derives normals only when the whole array is None, so a
    # model without them gets its own here, and a model without uvs zeros
    normals = None
    if any(n is not None for n in all_n):
        normals = np.concatenate([
            n if n is not None and n.shape[0] == v.shape[0]
            else _vertex_normals_for(v, t - vo)
            for v, n, t, vo in zip(all_v, all_n, all_t, voffsets)], axis=0)
    uvs = None
    if any(u is not None for u in all_uv):
        uvs = np.concatenate([
            u if u is not None and u.shape[0] == v.shape[0]
            else np.zeros((v.shape[0], 2), np.float32)
            for v, u in zip(all_v, all_uv)], axis=0)
    lt = ParallelogramLight.default(light_power) if light is None else light
    return _build(np.concatenate(all_v, axis=0), np.concatenate(all_t, axis=0),
                  np.concatenate(all_m, axis=0), mat_rows, normals, uvs, lt,
                  envmap, build_texture_atlas(textures, max_texture_dim),
                  device)


def scene_from_obj(path: str, material: str = "diffuse", **kw) -> Scene:
    """One OBJ file as a scene (the CLI's `--scene path.obj`)."""
    return scene_from_objs([ModelSpec(path=path, material=material)], **kw)


def scene_from_spec(path: str, device="cuda") -> Scene:
    """A multi-model scene from a JSON spec file (the CLI's
    `--scene spec.json`):

    {"models": [{"path": "...", "material": "refraction",
                 "scale": 0.25, "translate": [0, 0, 0], "kd": [...]}, ...],
     "light_power": 810.0, "envmap": "path.hdr"}

    Relative paths are taken from the spec file's directory."""
    with open(path) as f:
        spec = json.load(f)
    base = os.path.dirname(os.path.abspath(path))
    resolve = lambda p: p if os.path.isabs(p) else os.path.join(base, p)
    models = [ModelSpec(path=resolve(m["path"]),
                        material=m.get("material", "diffuse"),
                        scale=float(m.get("scale", 1.0)),
                        translate=tuple(m.get("translate", (0.0, 0.0, 0.0))),
                        kd=tuple(m["kd"]) if "kd" in m else None)
              for m in spec["models"]]
    envmap = (image_io.load_hdr(resolve(spec["envmap"]))
              if spec.get("envmap") else None)
    return scene_from_objs(models, envmap=envmap,
                           light_power=float(spec.get("light_power", 810.0)),
                           device=device)


def reference_assets_scene(resource_dir: str, vokselia_extent: int = 4,
                           light_power: float = 810.0,
                           device="cuda") -> Scene:
    """The reference renderer's five-model composition from its resource
    directory: every asset is read from `resource_dir`, the geometry is
    the procedural stand-ins (the resources hold no OBJ meshes):

      CedarCity.hdr                        the envmap
      grid.ppm                             ground plane, diffuse, textured
      vokselia_spawn/vokselia_spawn.{mtl,png}
                                           voxel world, diffuse, 'Stone' Kd
                                           and the PNG texture
      bunny/bunny.{mtl,PPM}                icosphere, refraction, textured
      (none)                               sphere, reflection; box, refraction
    """
    rd = resource_dir
    envmap = image_io.load_hdr(os.path.join(rd, "CedarCity.hdr"))
    textures: List[np.ndarray] = []

    def tex(path) -> int:
        img = _load_texture(path)
        if img is None:
            return -1
        textures.append(img)
        return len(textures) - 1

    grid_tex = tex(os.path.join(rd, "grid.ppm"))
    vok_tex = tex(os.path.join(rd, "vokselia_spawn", "vokselia_spawn.png"))
    bunny_tex = tex(os.path.join(rd, "bunny", "bunny.PPM"))
    bunny_mtl = obj_mod.load_mtl(os.path.join(rd, "bunny", "bunny.mtl"))
    bunny_kd = (next(iter(bunny_mtl.values()))["kd"] if bunny_mtl
                else (0.75, 0.75, 0.75))
    vok_mtl = obj_mod.load_mtl(os.path.join(rd, "vokselia_spawn",
                                            "vokselia_spawn.mtl"))
    vok_kd = vok_mtl.get("Stone", {}).get("kd", (0.47, 0.47, 0.47))
    mat_rows = [
        {"kind": MATL_DIFFUSE, "kd": (0.8, 0.8, 0.8),
         "texture_id": grid_tex},                       # 0 ground
        {"kind": MATL_DIFFUSE, "kd": tuple(vok_kd),
         "texture_id": vok_tex},                        # 1 vokselia
        {"kind": MATL_REFRACTION, "kd": tuple(bunny_kd),
         "texture_id": bunny_tex},                      # 2 bunny
        {"kind": MATL_REFLECTION, "kd": (0.7, 0.7, 0.75),
         "texture_id": -1},                             # 3 earth
        {"kind": MATL_REFRACTION, "kd": (0.95, 0.95, 0.95),
         "texture_id": -1},                             # 4 box
    ]
    m = procedural._mesh
    meshes = [
        m(procedural.plane(10.0, 0.0), 0),
        m(procedural.voxel_world(extent=vokselia_extent, base_y=0.0), 1),
        m(procedural.icosphere(0.5, (2.2, 0.7, 1.2), subdiv=3), 2),
        m(procedural.uv_sphere(0.7, (-2.0, 0.9, 1.5)), 3),
        m(procedural.box((0.7, 0.7, 0.7), (0.0, 0.35, 2.6)), 4),
    ]
    vertices, triangles, mat_ids, normals, uvs = merge_meshes(meshes)
    return _build(vertices, triangles, mat_ids, mat_rows, normals, uvs,
                  ParallelogramLight.default(light_power), envmap,
                  build_texture_atlas(textures), device)


def reference_models(asset_dir: str) -> List[ModelSpec]:
    """The reference renderer's five models as OBJ files in `asset_dir`
    (user-supplied): ground and vokselia_spawn diffuse, box 0.01x and
    bunny 0.25x refraction, earth 0.01x reflection."""
    j = lambda name: os.path.join(asset_dir, name)
    return [ModelSpec(j("ground.obj"), "diffuse"),
            ModelSpec(j("vokselia_spawn.obj"), "diffuse"),
            ModelSpec(j("box.obj"), "refraction", scale=0.01),
            ModelSpec(j("bunny.obj"), "refraction", scale=0.25),
            ModelSpec(j("earth.obj"), "reflection", scale=0.01)]
