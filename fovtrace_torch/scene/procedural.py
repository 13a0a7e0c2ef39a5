"""Procedural scenes (counterpart of `fovtrace/scene/procedural.py`).

The earth scene (reflective sphere, refractive box, diffuse ground) and
the box scene. The geometry is the reference package's numpy code, so a
scene built here is the same triangle soup, in the same leaf order, as
the reference's.
"""

from __future__ import annotations

import numpy as np

from fovtrace_torch.scene.scene import (MATL_DIFFUSE, MATL_REFLECTION,
                                        MATL_REFRACTION, Materials,
                                        ParallelogramLight, Scene,
                                        merge_meshes)


def plane(size: float = 20.0, y: float = 0.0):
    """Ground plane: 2 triangles."""
    s = size
    vertices = np.array([[-s, y, -s], [s, y, -s], [s, y, s], [-s, y, s]],
                        np.float32)
    triangles = np.array([[0, 2, 1], [0, 3, 2]], np.int64)
    uvs = np.array([[0, 0], [1, 0], [1, 1], [0, 1]], np.float32) * (size / 2.0)
    normals = np.tile(np.array([[0.0, 1.0, 0.0]], np.float32), (4, 1))
    return vertices, triangles, normals, uvs


def box(size=(1.0, 1.0, 1.0), center=(0.0, 0.0, 0.0)):
    """Axis-aligned box: 12 triangles."""
    sx, sy, sz = [s / 2.0 for s in size]
    cx, cy, cz = center
    corners = np.array(
        [[cx - sx, cy - sy, cz - sz], [cx + sx, cy - sy, cz - sz],
         [cx + sx, cy + sy, cz - sz], [cx - sx, cy + sy, cz - sz],
         [cx - sx, cy - sy, cz + sz], [cx + sx, cy - sy, cz + sz],
         [cx + sx, cy + sy, cz + sz], [cx - sx, cy + sy, cz + sz]],
        np.float32)
    faces = [(0, 3, 2, 1), (4, 5, 6, 7), (0, 1, 5, 4), (3, 7, 6, 2),
             (0, 4, 7, 3), (1, 2, 6, 5)]
    vertices, triangles, normals, uvs = [], [], [], []
    for f in faces:
        base = len(vertices)
        quad = corners[list(f)]
        n = np.cross(quad[1] - quad[0], quad[3] - quad[0])
        n = n / np.linalg.norm(n)
        vertices.extend(quad)
        normals.extend([n] * 4)
        uvs.extend([[0, 0], [1, 0], [1, 1], [0, 1]])
        triangles.append([base, base + 1, base + 2])
        triangles.append([base, base + 2, base + 3])
    return (np.asarray(vertices, np.float32), np.asarray(triangles, np.int64),
            np.asarray(normals, np.float32), np.asarray(uvs, np.float32))


def uv_sphere(radius: float = 1.0, center=(0.0, 0.0, 0.0), lat: int = 32,
              lon: int = 64):
    """UV sphere."""
    cx, cy, cz = center
    vertices, normals, uvs = [], [], []
    for i in range(lat + 1):
        theta = np.pi * i / lat
        for j in range(lon + 1):
            phi = 2.0 * np.pi * j / lon
            n = np.array([np.sin(theta) * np.cos(phi), np.cos(theta),
                          np.sin(theta) * np.sin(phi)], np.float32)
            vertices.append(np.array([cx, cy, cz], np.float32) + radius * n)
            normals.append(n)
            uvs.append([j / lon, 1.0 - i / lat])
    triangles = []
    stride = lon + 1
    for i in range(lat):
        for j in range(lon):
            a = i * stride + j
            b = a + 1
            c = a + stride
            d = c + 1
            if i != 0:
                triangles.append([a, b, c])
            if i != lat - 1:
                triangles.append([b, d, c])
    return (np.asarray(vertices, np.float32), np.asarray(triangles, np.int64),
            np.asarray(normals, np.float32), np.asarray(uvs, np.float32))


def checker_envmap(h: int = 64, w: int = 128, bright: float = 1.0):
    """Procedural lat-long sky: horizon gradient plus a sun disc."""
    ys = np.linspace(0, 1, h)[:, None]
    sky = np.stack([0.35 + 0.4 * ys, 0.45 + 0.4 * ys, 0.7 + 0.3 * ys],
                   axis=-1) * np.ones((h, w, 3))
    cy, cx = int(h * 0.25), int(w * 0.7)
    yy, xx = np.mgrid[0:h, 0:w]
    d2 = (yy - cy) ** 2 + (xx - cx) ** 2
    sun = np.exp(-d2 / 18.0)[..., None] * np.array([8.0, 7.5, 6.0])
    return (bright * (sky + sun)).astype(np.float32)


def _default_materials() -> Materials:
    """0 ground diffuse, 1 diffuse white, 2 reflect, 3 refract."""
    return Materials.create(
        kinds=[MATL_DIFFUSE, MATL_DIFFUSE, MATL_REFLECTION, MATL_REFRACTION],
        kds=[[0.8, 0.8, 0.8], [0.75, 0.75, 0.75], [0.7, 0.7, 0.75],
             [0.95, 0.95, 0.95]])


def _assemble(meshes, device, light_power=810.0) -> Scene:
    vertices, triangles, mat_ids, normals, uvs = merge_meshes(meshes)
    scene = Scene.build(vertices, triangles, mat_ids,
                        materials=_default_materials(), normals=normals,
                        uvs=uvs, light=ParallelogramLight.default(light_power),
                        envmap=checker_envmap())
    # BVH leaf order + cluster pack on the host, then one upload
    return scene.with_bvh().to(device)


def _mesh(parts, mat_id):
    v, t, n, uv = parts
    return {"vertices": v, "triangles": t, "mat_id": mat_id, "normals": n,
            "uvs": uv}


def box_scene(device="cpu") -> Scene:
    """Ground plane and a diffuse box."""
    return _assemble([_mesh(plane(8.0, 0.0), 0),
                      _mesh(box((1.0, 1.0, 1.0), (0.0, 0.5, 0.0)), 1)], device)


def earth_scene(device="cpu") -> Scene:
    """Reflective "earth" sphere, refractive box and ground (5,616
    triangles with padding)."""
    return _assemble([_mesh(plane(8.0, 0.0), 0),
                      _mesh(uv_sphere(0.8, (0.0, 1.0, 0.0)), 2),
                      _mesh(box((0.8, 0.8, 0.8), (-2.0, 0.4, 1.2)), 3)],
                     device)


SCENES = {"box": box_scene, "earth": earth_scene}
