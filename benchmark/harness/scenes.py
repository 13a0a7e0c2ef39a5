"""The cells' scenes as plain arrays: a frozen copy of the port's
procedural mesh generators (fovtrace_torch/scene/procedural.py as of the
benchmark's first version) and the assembly of a configuration's meshes,
materials, light and envmap. Both the program and the reference are
handed these arrays; each derives its own acceleration structures.
"""

from __future__ import annotations

import numpy as np


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


GENERATORS = {"plane": plane, "box": box, "uv_sphere": uv_sphere,
              "icosphere": icosphere, "voxel_world": voxel_world}


def merge_meshes(meshes):
    """Concatenate mesh dicts (vertices, triangles, mat_id, normals, uvs)
    into one indexed soup."""
    all_v, all_t, all_m, all_n, all_uv = [], [], [], [], []
    voff = 0
    for m in meshes:
        v = np.asarray(m["vertices"], np.float32)
        t = np.asarray(m["triangles"], np.int64)
        all_v.append(v)
        all_t.append(t + voff)
        all_m.append(np.full((t.shape[0],), m["mat_id"], np.int32))
        all_n.append(m["normals"])
        all_uv.append(m["uvs"])
        voff += v.shape[0]
    cat = lambda xs: np.concatenate(xs, axis=0)
    return cat(all_v), cat(all_t), cat(all_m), cat(all_n), cat(all_uv)


def _arg(v):
    return tuple(v) if isinstance(v, list) else v


def mesh_arrays(config: dict) -> dict:
    """{vertices, triangles, mat_ids, normals, uvs} of the configuration's
    meshes, in the order it lists them."""
    parts = []
    for m in config["meshes"]:
        gen = GENERATORS[m["generator"]]
        v, t, n, uv = gen(**{k: _arg(a) for k, a in m["args"].items()})
        parts.append({"vertices": v, "triangles": t, "normals": n, "uvs": uv,
                      "mat_id": m["material"]})
    v, t, mid, n, uv = merge_meshes(parts)
    return {"vertices": v, "triangles": t, "mat_ids": mid, "normals": n,
            "uvs": uv}


def envmap_array(config: dict) -> np.ndarray:
    e = config["envmap"]
    if e["kind"] != "checker":
        raise ValueError(f"envmap kind {e['kind']!r}")
    return checker_envmap(e["height"], e["width"], e["bright"])


def material_columns(config: dict) -> dict:
    """Every column of the material table, as Materials.create takes them
    (kinds, kds, then each other column as an override)."""
    m = config["materials"]
    cols = {k: v for k, v in m.items() if k not in ("kind", "kd",
                                                       "texture_id")}
    return {"kinds": m["kind"], "kds": m["kd"], "textures": m["texture_id"],
            **cols}
