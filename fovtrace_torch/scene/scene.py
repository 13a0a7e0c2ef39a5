"""Scene: flat triangle soup, SoA materials, area light, envmap
(counterpart of `fovtrace/scene/scene.py`).

Frozen dataclasses of tensors. A scene is built on the host — numpy for
the mesh, the native BVH builder for the leaf order, CPU tensors for the
intersection pack — and then moved to its device once with `to(device)`.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

MATL_DIFFUSE = 0
MATL_REFLECTION = 1
MATL_REFRACTION = 2


def _to(obj, device):
    """Copy of a dataclass of tensors (nested) with every tensor on `device`."""
    kw = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if isinstance(v, torch.Tensor):
            v = v.to(device)
        elif dataclasses.is_dataclass(v):
            v = _to(v, device)
        kw[f.name] = v
    return dataclasses.replace(obj, **kw)


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x, np.float32))


def _fma(x: torch.Tensor, y: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """x * y + z with one float32 rounding (computed exactly in float64)."""
    return (x.double() * y.double() + z.double()).float()


def host_cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Row cross product for the host-side build, rounded as the
    reference's build rounds it: a1*b2 - a2*b1 as one fused multiply-add
    over the rounded second product (XLA's CPU code contracts it so)."""
    ax, ay, az = a[..., 0], a[..., 1], a[..., 2]
    bx, by, bz = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack([_fma(ay, bz, -(az * by)), _fma(az, bx, -(ax * bz)),
                        _fma(ax, by, -(ay * bx))], dim=-1)


def host_norm(a: torch.Tensor) -> torch.Tensor:
    """Row 2-norm for the host-side build: the sum of squares accumulated
    by fused multiply-adds, as the reference's build rounds it, and a
    correctly rounded square root (PyTorch's float32 CPU sqrt is not)."""
    acc = a[..., 0] * a[..., 0]
    acc = _fma(a[..., 1], a[..., 1], acc)
    return torch.sqrt(_fma(a[..., 2], a[..., 2], acc).double()).float()


@dataclasses.dataclass(frozen=True)
class ParallelogramLight:
    corner: torch.Tensor    # [3]
    v1: torch.Tensor        # [3]
    v2: torch.Tensor        # [3]
    normal: torch.Tensor    # [3]
    emission: torch.Tensor  # [3]

    @classmethod
    def create(cls, corner, v1, v2, emission) -> "ParallelogramLight":
        corner, v1, v2 = _f32(corner), _f32(v1), _f32(v2)
        n = host_cross(v1, v2)
        n = n / host_norm(n)
        return cls(corner=corner, v1=v1, v2=v2, normal=n,
                   emission=_f32(emission))

    @classmethod
    def default(cls, power: float = 810.0) -> "ParallelogramLight":
        """The reference's ceiling light."""
        return cls.create(corner=(343.0, 548.6, 227.0), v1=(-130.0, 0.0, 0.0),
                          v2=(0.0, 0.0, 105.0), emission=(power,) * 3)

    @property
    def area(self) -> torch.Tensor:
        return host_norm(host_cross(self.v1, self.v2))

    def replace(self, **kw) -> "ParallelogramLight":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class Materials:
    """SoA material table indexed by per-triangle mat_id."""

    kind: torch.Tensor              # [M] int32
    kd: torch.Tensor                # [M,3]
    ks: torch.Tensor                # [M,3]
    phong_exp: torch.Tensor         # [M]
    reflectivity_n: torch.Tensor    # [M,3]
    ior: torch.Tensor               # [M]
    extinction: torch.Tensor        # [M,3]
    refraction_color: torch.Tensor  # [M,3]
    reflection_color: torch.Tensor  # [M,3]
    fresnel_exponent: torch.Tensor  # [M]
    fresnel_minimum: torch.Tensor   # [M]
    fresnel_maximum: torch.Tensor   # [M]
    shadow_attenuation: torch.Tensor  # [M,3]
    texture_id: torch.Tensor        # [M] int32 (-1 = none)

    @classmethod
    def create(cls, kinds, kds, textures=None, **overrides) -> "Materials":
        m = len(kinds)

        def arr(name, default, dim=None):
            v = overrides.get(name)
            if v is not None:
                return _f32(v)
            if dim is None:
                return torch.full((m,), default, dtype=torch.float32)
            return _f32(np.tile(np.asarray(default, np.float32), (m, 1)))

        tex = (torch.as_tensor(np.asarray(textures, np.int32))
               if textures is not None
               else torch.full((m,), -1, dtype=torch.int32))
        return cls(
            kind=torch.as_tensor(np.asarray(kinds, np.int32)),
            kd=_f32(kds),
            ks=arr("ks", (1.0, 1.0, 1.0), dim=3),
            phong_exp=arr("phong_exp", 88.0),
            reflectivity_n=arr("reflectivity_n", (0.05, 0.05, 0.05), dim=3),
            ior=arr("ior", 1.4),
            extinction=arr("extinction", (0.0, 0.0, 0.0), dim=3),
            refraction_color=arr("refraction_color", (1.0, 1.0, 1.0), dim=3),
            reflection_color=arr("reflection_color", (1.0, 1.0, 1.0), dim=3),
            fresnel_exponent=arr("fresnel_exponent", 3.0),
            fresnel_minimum=arr("fresnel_minimum", 0.1),
            fresnel_maximum=arr("fresnel_maximum", 1.0),
            shadow_attenuation=arr("shadow_attenuation", (1.0, 1.0, 1.0),
                                   dim=3),
            texture_id=tex,
        )

    def replace(self, **kw) -> "Materials":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class Scene:
    """World-space triangle soup padded to a multiple of 128 triangles
    (degenerate padding triangles carry mat_id -1)."""

    v0: torch.Tensor        # [T,3]
    e1: torch.Tensor        # [T,3] v1 - v0
    e2: torch.Tensor        # [T,3] v2 - v0
    n0: torch.Tensor        # [T,3] shading normals
    n1: torch.Tensor
    n2: torch.Tensor
    uv0: torch.Tensor       # [T,2]
    uv1: torch.Tensor
    uv2: torch.Tensor
    mat_id: torch.Tensor    # [T] int32
    materials: Materials
    light: ParallelogramLight
    envmap: torch.Tensor    # [He,We,3] lat-long HDR
    textures: torch.Tensor  # [Ntex,Ht,Wt,3]
    bbox_min: torch.Tensor  # [3]
    bbox_max: torch.Tensor  # [3]

    # flattened BVH (with_bvh; triangles are then in leaf order)
    bvh_nodes_min: Optional[torch.Tensor] = None
    bvh_nodes_max: Optional[torch.Tensor] = None
    bvh_left: Optional[torch.Tensor] = None
    bvh_right: Optional[torch.Tensor] = None
    bvh_leaf: Optional[torch.Tensor] = None
    bvh_max_stack: int = 0

    # intersection pack (with_pack; see kernels.cluster_isect.compute_pack)
    isect_coef: Optional[torch.Tensor] = None    # [NC, 16, 4c]
    isect_aux: Optional[torch.Tensor] = None     # [NC, 8, c]
    cluster_aabb: Optional[torch.Tensor] = None  # [NC, 8]

    # per-triangle shading attributes [T, 24]: n0 n1 n2 (9), geometric
    # normal (3), uv0 uv1 uv2 (6), mat_id (1), zero pad (5)
    tri_attr: Optional[torch.Tensor] = None

    @property
    def num_triangles(self) -> int:
        return self.v0.shape[0]

    @property
    def device(self) -> torch.device:
        return self.v0.device

    def replace(self, **kw) -> "Scene":
        return dataclasses.replace(self, **kw)

    def to(self, device) -> "Scene":
        return _to(self, device)

    def with_bvh(self, max_leaf: int = 16) -> "Scene":
        """Build the BVH on the host, reorder the triangles into leaf
        order, and compute the intersection pack."""
        from fovtrace_torch.scene import bvh as bvh_mod

        mat_id = self.mat_id.cpu().numpy()
        flat = bvh_mod.build_bvh(self.v0.cpu().numpy(), self.e1.cpu().numpy(),
                                 self.e2.cpu().numpy(), mat_id >= 0,
                                 max_leaf=max_leaf)
        keys = ("v0", "e1", "e2", "n0", "n1", "n2", "uv0", "uv1", "uv2",
                "mat_id")
        re = bvh_mod.reorder_scene_arrays(
            {k: getattr(self, k).cpu().numpy() for k in keys}, flat.order)
        t = lambda a: torch.as_tensor(a).to(self.device)
        return self.replace(
            **{k: t(v) for k, v in re.items()},
            bvh_nodes_min=t(flat.nodes_min), bvh_nodes_max=t(flat.nodes_max),
            bvh_left=t(flat.nodes_left), bvh_right=t(flat.nodes_right),
            bvh_leaf=t(flat.nodes_leaf), bvh_max_stack=flat.max_depth + 2,
        ).with_pack()

    def with_pack(self) -> "Scene":
        """Compute the cluster intersection pack and the packed shading
        attribute rows."""
        from fovtrace_torch.kernels import cluster_isect

        coef, aux, clusters = cluster_isect.compute_pack(self)
        gn = host_cross(self.e1, self.e2)
        gn = gn / torch.clamp_min(host_norm(gn), 1e-20)[:, None]
        attr = torch.cat(
            [self.n0, self.n1, self.n2, gn, self.uv0, self.uv1, self.uv2,
             self.mat_id[:, None].to(torch.float32),
             torch.zeros((self.num_triangles, 5), dtype=torch.float32,
                         device=self.device)], dim=1)
        return self.replace(isect_coef=coef, isect_aux=aux,
                            cluster_aabb=clusters, tri_attr=attr)

    @classmethod
    def build(cls, vertices, triangles, mat_ids, materials: Materials,
              normals=None, uvs=None, light: Optional[ParallelogramLight] = None,
              envmap=None, textures=None, pad_to: int = 128) -> "Scene":
        """Triangle soup from an indexed mesh (numpy in, CPU tensors out)."""
        vertices = np.asarray(vertices, np.float32)
        triangles = np.asarray(triangles, np.int64)
        mat_ids = np.asarray(mat_ids, np.int32)
        t = triangles.shape[0]

        if normals is None:
            # area-weighted vertex normals from face normals
            fv0 = vertices[triangles[:, 0]]
            fn = np.cross(vertices[triangles[:, 1]] - fv0,
                          vertices[triangles[:, 2]] - fv0)
            normals = np.zeros_like(vertices)
            for k in range(3):
                np.add.at(normals, triangles[:, k], fn)
            lens = np.linalg.norm(normals, axis=-1, keepdims=True)
            normals = normals / np.maximum(lens, 1e-12)
        if uvs is None:
            uvs = np.zeros((vertices.shape[0], 2), np.float32)

        pad = (-t) % pad_to
        tv0 = vertices[triangles[:, 0]]
        tv1 = vertices[triangles[:, 1]]
        tv2 = vertices[triangles[:, 2]]

        def padv(a, fill=0.0):
            return np.concatenate(
                [a, np.full((pad,) + a.shape[1:], fill, a.dtype)], axis=0)

        if envmap is None:
            envmap = np.zeros((8, 16, 3), np.float32)
        if textures is None:
            textures = np.ones((1, 1, 1, 3), np.float32)
        if light is None:
            light = ParallelogramLight.default()
        bbox_min = (vertices.min(axis=0) if len(vertices)
                    else np.zeros(3, np.float32))
        bbox_max = (vertices.max(axis=0) if len(vertices)
                    else np.ones(3, np.float32))

        tt = lambda a: torch.as_tensor(np.ascontiguousarray(a))
        corner = lambda k: padv(normals[triangles[:, k]].astype(np.float32))
        uvk = lambda k: padv(uvs[triangles[:, k]].astype(np.float32))
        return cls(
            v0=tt(padv(tv0)), e1=tt(padv(tv1 - tv0)), e2=tt(padv(tv2 - tv0)),
            n0=tt(corner(0)), n1=tt(corner(1)), n2=tt(corner(2)),
            uv0=tt(uvk(0)), uv1=tt(uvk(1)), uv2=tt(uvk(2)),
            mat_id=tt(np.concatenate([mat_ids, np.full((pad,), -1, np.int32)])),
            materials=materials,
            light=light,
            envmap=tt(np.asarray(envmap, np.float32)),
            textures=tt(np.asarray(textures, np.float32)),
            bbox_min=tt(np.asarray(bbox_min, np.float32)),
            bbox_max=tt(np.asarray(bbox_max, np.float32)),
        )


def merge_meshes(meshes):
    """Concatenate mesh dicts (vertices, triangles, mat_id, optional
    normals/uvs) into one indexed soup."""
    all_v, all_t, all_m, all_n, all_uv = [], [], [], [], []
    voff = 0
    for m in meshes:
        v = np.asarray(m["vertices"], np.float32)
        t = np.asarray(m["triangles"], np.int64)
        all_v.append(v)
        all_t.append(t + voff)
        all_m.append(np.full((t.shape[0],), m["mat_id"], np.int32))
        all_n.append(m.get("normals"))
        all_uv.append(m.get("uvs"))
        voff += v.shape[0]
    normals = (np.concatenate(all_n, axis=0)
               if all(n is not None for n in all_n) else None)
    uvs = (np.concatenate(all_uv, axis=0)
           if all(u is not None for u in all_uv) else None)
    return (np.concatenate(all_v, axis=0), np.concatenate(all_t, axis=0),
            np.concatenate(all_m, axis=0), normals, uvs)
