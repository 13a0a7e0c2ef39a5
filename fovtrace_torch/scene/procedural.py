"""Procedural scenes (counterpart of `fovtrace/scene/procedural.py`).

Every scene of the reference: box, bunny, earth, multi, vokselia and the
170k-triangle city. The geometry is the reference package's numpy code,
so a scene built here is the same triangle soup, in the same leaf order,
as the reference's.
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


def icosphere(radius: float = 1.0, center=(0.0, 0.0, 0.0), subdiv: int = 3):
    """Subdivided icosahedron (the "bunny" stand-in)."""
    t = (1.0 + np.sqrt(5.0)) / 2.0
    verts = np.array(
        [[-1, t, 0], [1, t, 0], [-1, -t, 0], [1, -t, 0],
         [0, -1, t], [0, 1, t], [0, -1, -t], [0, 1, -t],
         [t, 0, -1], [t, 0, 1], [-t, 0, -1], [-t, 0, 1]], np.float64)
    verts /= np.linalg.norm(verts, axis=1, keepdims=True)
    faces = [(0, 11, 5), (0, 5, 1), (0, 1, 7), (0, 7, 10), (0, 10, 11),
             (1, 5, 9), (5, 11, 4), (11, 10, 2), (10, 7, 6), (7, 1, 8),
             (3, 9, 4), (3, 4, 2), (3, 2, 6), (3, 6, 8), (3, 8, 9),
             (4, 9, 5), (2, 4, 11), (6, 2, 10), (8, 6, 7), (9, 8, 1)]
    verts = list(map(tuple, verts))
    cache = {}

    def midpoint(a, b):
        key = (min(a, b), max(a, b))
        if key in cache:
            return cache[key]
        m = np.asarray(verts[a]) + np.asarray(verts[b])
        m /= np.linalg.norm(m)
        verts.append(tuple(m))
        cache[key] = len(verts) - 1
        return cache[key]

    for _ in range(subdiv):
        new_faces = []
        for (a, b, c) in faces:
            ab, bc, ca = midpoint(a, b), midpoint(b, c), midpoint(c, a)
            new_faces += [(a, ab, ca), (b, bc, ab), (c, ca, bc), (ab, bc, ca)]
        faces = new_faces

    v = np.asarray(verts, np.float32)
    n = v.copy()
    v = v * radius + np.asarray(center, np.float32)
    u = 0.5 + np.arctan2(n[:, 2], n[:, 0]) / (2 * np.pi)
    w = 0.5 - np.arcsin(np.clip(n[:, 1], -1, 1)) / np.pi
    return (v, np.asarray(faces, np.int64), n,
            np.stack([u, w], axis=1).astype(np.float32))


def voxel_world(seed: int = 7, extent: int = 6, base_y: float = 0.0):
    """Blocky terrain of 0.5-unit boxes on a 2*extent square grid, 1-4
    boxes tall (the vokselia_spawn stand-in)."""
    rng = np.random.default_rng(seed)
    meshes = []
    for ix in range(-extent, extent):
        for iz in range(-extent, extent):
            h = int(1 + 2.5 * (np.sin(ix * 0.7) * np.cos(iz * 0.5) * 0.5 + 0.5)
                    + rng.integers(0, 2))
            for iy in range(h):
                meshes.append(box((0.5, 0.5, 0.5),
                                  (ix * 0.5 + 0.25, base_y + iy * 0.5 + 0.25,
                                   iz * 0.5 + 0.25)))
    vs, ts, ns, uvs = [], [], [], []
    off = 0
    for v, t, n, uv in meshes:
        vs.append(v)
        ts.append(t + off)
        ns.append(n)
        uvs.append(uv)
        off += v.shape[0]
    return (np.concatenate(vs), np.concatenate(ts), np.concatenate(ns),
            np.concatenate(uvs))


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


def box_scene(device="cuda") -> Scene:
    """Ground plane and a diffuse box."""
    return _assemble([_mesh(plane(8.0, 0.0), 0),
                      _mesh(box((1.0, 1.0, 1.0), (0.0, 0.5, 0.0)), 1)], device)


def bunny_scene(device="cuda") -> Scene:
    """Refractive icosphere ("bunny") and ground."""
    return _assemble([_mesh(plane(8.0, 0.0), 0),
                      _mesh(icosphere(0.6, (0.0, 0.8, 0.0), subdiv=3), 3)],
                     device)


def earth_scene(device="cuda") -> Scene:
    """Reflective "earth" sphere, refractive box and ground (5,616
    triangles with padding)."""
    return _assemble([_mesh(plane(8.0, 0.0), 0),
                      _mesh(uv_sphere(0.8, (0.0, 1.0, 0.0)), 2),
                      _mesh(box((0.8, 0.8, 0.8), (-2.0, 0.4, 1.2)), 3)],
                     device)


def multi_object_scene(device="cuda") -> Scene:
    """Every material kind together: diffuse box, reflective sphere,
    refractive icosphere, ground."""
    return _assemble([_mesh(plane(8.0, 0.0), 0),
                      _mesh(box((1.0, 1.0, 1.0), (1.5, 0.5, -0.5)), 1),
                      _mesh(uv_sphere(0.7, (0.0, 0.9, 0.8), lat=24, lon=48), 2),
                      _mesh(icosphere(0.5, (-1.6, 0.7, 0.6), subdiv=3), 3)],
                     device)


def vokselia_scene(device="cuda", extent: int = 6) -> Scene:
    """Voxel world (the vokselia_spawn stand-in) on a ground plane."""
    return _assemble([_mesh(plane(10.0, 0.0), 0),
                      _mesh(voxel_world(extent=extent), 1)], device)


def city_meshes() -> list:
    """The city scene's meshes: ground, a 64x64-column voxel city, the
    earth scene's sphere (raised) and box."""
    return [_mesh(plane(40.0, 0.0), 0), _mesh(voxel_world(extent=32), 1),
            _mesh(uv_sphere(0.8, (0.0, 2.2, 0.0), lat=48, lon=96), 2),
            _mesh(box((0.8, 0.8, 0.8), (-2.0, 0.4, 1.2)), 3)]


def city_scene(device="cuda") -> Scene:
    """The large scene (`city_meshes`), 170,368 triangles after padding,
    1,332 clusters of 128. Its pack is far over the 4 MiB residency
    threshold, so it takes the streaming kernels with two clusters per
    schedule entry."""
    return _assemble(city_meshes(), device)


SCENES = {"box": box_scene, "bunny": bunny_scene, "earth": earth_scene,
          "multi": multi_object_scene, "vokselia": vokselia_scene,
          "city": city_scene}
