"""Wavefront OBJ / MTL loading to flat numpy arrays (counterpart of
`fovtrace/scene/obj.py`).

Files without material groups take the native parser
(`native.load_obj_native`); files with `usemtl` need per-face materials
and take the Python parser, as in the reference. Either way the v/vt/vn
triplets are deduplicated into one vertex stream in order of first use:
the BVH's leaf order, and so the intersection pack's 128-triangle
clusters, follow the vertex order, so it must be the reference's.
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Tuple

import numpy as np


def load_mtl(path: str) -> Dict[str, dict]:
    """Parse a .mtl file -> {name: {kd, ks, ns, d, map_kd}}; {} when the
    file does not exist."""
    mats: Dict[str, dict] = {}
    cur: Optional[dict] = None
    if not os.path.exists(path):
        return mats
    with open(path, "r", errors="replace") as f:
        for line in f:
            parts = line.split()
            if not parts or parts[0].startswith("#"):
                continue
            key = parts[0]
            if key == "newmtl":
                cur = {"kd": (0.8, 0.8, 0.8), "ks": (0.0, 0.0, 0.0),
                       "ns": 32.0, "d": 1.0, "map_kd": None}
                mats[parts[1]] = cur
            elif cur is None:
                continue
            elif key == "Kd":
                cur["kd"] = tuple(float(x) for x in parts[1:4])
            elif key == "Ks":
                cur["ks"] = tuple(float(x) for x in parts[1:4])
            elif key == "Ns":
                cur["ns"] = float(parts[1])
            elif key == "d":
                cur["d"] = float(parts[1])
            elif key == "map_Kd":
                cur["map_kd"] = parts[-1]
    return mats


def load_obj(path: str) -> Tuple[np.ndarray, np.ndarray, Optional[np.ndarray],
                                 Optional[np.ndarray], np.ndarray,
                                 Dict[str, dict]]:
    """Load an OBJ file.

    Returns (vertices [V,3], triangles [T,3], normals [V,3] or None,
    uvs [V,2] or None, face_material [T] int32, materials dict)."""
    from fovtrace_torch import native

    with open(path, "rb") as f:
        has_groups = b"usemtl" in f.read()
    if not has_groups:
        out = native.load_obj_native(path)
        if out is not None:
            pos, tris, normals, uvs = out
            return (pos, tris, normals, uvs,
                    np.zeros((tris.shape[0],), np.int32), {})
    return _load_obj_py(path)


def _resolve(i: np.ndarray, n: int) -> np.ndarray:
    """OBJ's 1-based (or, if negative, from-the-end) indices -> 0-based."""
    return np.where(i > 0, i - 1, n + i)


def _load_obj_py(path: str):
    positions, normals, uvs = [], [], []
    corners = []    # (v, vt, vn) of each triangle corner, as written
    tri_mat = []
    mtl: Dict[str, dict] = {}
    mat_names = []
    cur_mat = -1
    with open(path, "r", errors="replace") as f:
        for line in f:
            parts = line.split()
            if not parts or parts[0].startswith("#"):
                continue
            key = parts[0]
            if key == "v":
                positions.append([float(x) for x in parts[1:4]])
            elif key == "vn":
                normals.append([float(x) for x in parts[1:4]])
            elif key == "vt":
                uvs.append([float(x) for x in parts[1:3]])
            elif key == "mtllib":
                mtl.update(load_mtl(os.path.join(os.path.dirname(path),
                                                 parts[1])))
            elif key == "usemtl":
                if parts[1] not in mat_names:
                    mat_names.append(parts[1])
                cur_mat = mat_names.index(parts[1])
            elif key == "f":
                idx = []
                for vtx in parts[1:]:
                    comp = vtx.split("/")
                    idx.append((int(comp[0]),
                                int(comp[1]) if len(comp) > 1 and comp[1]
                                else 0,
                                int(comp[2]) if len(comp) > 2 and comp[2]
                                else 0))
                for k in range(1, len(idx) - 1):    # fan triangulation
                    corners.extend((idx[0], idx[k], idx[k + 1]))
                    tri_mat.append(cur_mat)

    ordered_mtl = {name: mtl.get(name, {}) for name in mat_names}
    face_mat = np.asarray(tri_mat, np.int32)
    if not corners:
        return (np.zeros((0,), np.float32), np.zeros((0,), np.int64), None,
                None, face_mat, ordered_mtl)
    positions = np.asarray(positions, np.float32)
    keys = np.asarray(corners, np.int64)                    # [3T, 3]
    # one vertex per distinct (v, vt, vn) triplet, numbered in order of
    # first use
    uniq, first, inverse = np.unique(keys, axis=0, return_index=True,
                                     return_inverse=True)
    order = np.argsort(first, kind="stable")
    rank = np.empty_like(order)
    rank[order] = np.arange(order.size)
    triangles = rank[inverse.reshape(-1)].reshape(-1, 3).astype(np.int64)
    vi, ti, ni = uniq[order].T
    vertices = positions[_resolve(vi, len(positions))]

    def attribute(rows, ids, width):
        if not rows:
            return None
        arr = np.asarray(rows, np.float32)
        out = np.zeros((ids.size, width), np.float32)
        used = ids != 0
        out[used] = arr[_resolve(ids[used], len(arr))]
        return out

    norms = attribute(normals, ni, 3)
    if norms is not None and not np.any(norms):
        norms = None
    return (vertices, triangles, norms, attribute(uvs, ti, 2), face_mat,
            ordered_mtl)
