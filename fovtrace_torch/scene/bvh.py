"""Host-side BVH build (counterpart of `fovtrace/scene/bvh.py`).

The binned-SAH BVH2 comes from the repository's native builder
(`native/fovnative.cpp`), compiled with g++ at first use into the
checkout's `build/` directory and called through ctypes. Triangles are
reordered into leaf order, which is also the order the intersection
pack's 128-triangle clusters are cut from — so the leaf order must be,
and is, the reference package's own.
"""

from __future__ import annotations

import ctypes
import dataclasses

import numpy as np

from fovtrace_torch import _build

_SOURCE = _build.REPO_ROOT / "native" / "fovnative.cpp"
_lib = None


@dataclasses.dataclass
class FlatBVH:
    nodes_min: np.ndarray    # [Nn,3] f32
    nodes_max: np.ndarray    # [Nn,3] f32
    nodes_left: np.ndarray   # [Nn] i32  inner: left child; leaf: tri start
    nodes_right: np.ndarray  # [Nn] i32  inner: right child; leaf: tri count
    nodes_leaf: np.ndarray   # [Nn] i32  1 = leaf
    order: np.ndarray        # [T'] i64  leaf-order triangle ids, -1 = pad
    max_depth: int


def _compile(srcs, out):
    # the reference package's own flags (fovtrace/native.py), so both
    # builders make the same floating-point decisions
    return ["g++", "-O3", "-march=native", "-fPIC", "-shared", "-std=c++17",
            "-o", out, *srcs]


def _get_lib() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        path = _build.build_library("fovnative", [_SOURCE], _compile)
        lib = ctypes.CDLL(str(path))
        c = ctypes
        fp = c.POINTER(c.c_float)
        i32p = c.POINTER(c.c_int32)
        lib.fov_bvh_build.restype = c.c_void_p
        lib.fov_bvh_build.argtypes = [fp, fp, fp, c.POINTER(c.c_uint8),
                                      c.c_int64, c.c_int, c.c_int, c.c_int]
        lib.fov_bvh_num_nodes.restype = c.c_int64
        lib.fov_bvh_num_nodes.argtypes = [c.c_void_p]
        lib.fov_bvh_order_len.restype = c.c_int64
        lib.fov_bvh_order_len.argtypes = [c.c_void_p]
        lib.fov_bvh_max_depth.restype = c.c_int32
        lib.fov_bvh_max_depth.argtypes = [c.c_void_p]
        lib.fov_bvh_copy.restype = None
        lib.fov_bvh_copy.argtypes = [c.c_void_p, fp, fp, i32p, i32p, i32p,
                                     c.POINTER(c.c_int64)]
        lib.fov_bvh_free.restype = None
        lib.fov_bvh_free.argtypes = [c.c_void_p]
        _lib = lib
    return _lib


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def build_bvh(v0: np.ndarray, e1: np.ndarray, e2: np.ndarray,
              valid: np.ndarray, max_leaf: int = 16, leaf_align: int = 16,
              num_bins: int = 16) -> FlatBVH:
    """Binned-SAH BVH2 over triangles (v0, v0+e1, v0+e2); `valid` masks
    out padding triangles."""
    if not np.any(valid):
        raise ValueError("empty scene")
    lib = _get_lib()
    v0 = np.ascontiguousarray(v0, np.float32)
    e1 = np.ascontiguousarray(e1, np.float32)
    e2 = np.ascontiguousarray(e2, np.float32)
    valid = np.ascontiguousarray(valid, np.uint8)
    h = lib.fov_bvh_build(_ptr(v0, ctypes.c_float), _ptr(e1, ctypes.c_float),
                          _ptr(e2, ctypes.c_float),
                          _ptr(valid, ctypes.c_uint8), v0.shape[0],
                          max_leaf, leaf_align, num_bins)
    if not h:
        raise RuntimeError("native BVH build failed")
    try:
        nn = lib.fov_bvh_num_nodes(h)
        nodes_min = np.empty((nn, 3), np.float32)
        nodes_max = np.empty((nn, 3), np.float32)
        left = np.empty((nn,), np.int32)
        right = np.empty((nn,), np.int32)
        leaf = np.empty((nn,), np.int32)
        order = np.empty((lib.fov_bvh_order_len(h),), np.int64)
        lib.fov_bvh_copy(h, _ptr(nodes_min, ctypes.c_float),
                         _ptr(nodes_max, ctypes.c_float),
                         _ptr(left, ctypes.c_int32),
                         _ptr(right, ctypes.c_int32),
                         _ptr(leaf, ctypes.c_int32),
                         _ptr(order, ctypes.c_int64))
        max_depth = int(lib.fov_bvh_max_depth(h))
    finally:
        lib.fov_bvh_free(h)
    return FlatBVH(nodes_min, nodes_max, left, right, leaf, order, max_depth)


def reorder_scene_arrays(scene_arrays: dict, order: np.ndarray) -> dict:
    """Gather per-triangle numpy arrays into leaf order; order == -1
    entries become degenerate padding triangles (zero edges, mat_id -1)."""
    out = {}
    safe = np.maximum(order, 0)
    for k, a in scene_arrays.items():
        g = np.asarray(a)[safe]
        if k in ("e1", "e2"):
            g = np.where((order >= 0)[:, None], g, 0.0).astype(np.float32)
        if k == "mat_id":
            g = np.where(order >= 0, g, -1).astype(np.int32)
        out[k] = g
    return out
