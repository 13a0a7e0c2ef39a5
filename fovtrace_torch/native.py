"""ctypes bindings of the host runtime (counterpart of `fovtrace/native.py`).

Two small shared libraries, each compiled with g++ at first use into the
checkout's `build/` directory (`_build.build_library`):

  fovnative     `native/fovnative.cpp`, the repository's binned-SAH BVH
                builder and OBJ parser, built with the reference
                package's own flags so both make the same floating-point
                decisions
  png_unfilter  `fovtrace_torch/csrc/png_unfilter.cpp`, the PNG row
                filters (`scene/image_io.load_png`)

Unlike the reference, nothing falls back to Python when a library does
not build or load: that raises.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import numpy as np

from fovtrace_torch import _build

_FOVNATIVE = _build.REPO_ROOT / "native" / "fovnative.cpp"
_PNG = _build.REPO_ROOT / "fovtrace_torch" / "csrc" / "png_unfilter.cpp"


def _compile(srcs, out):
    return ["g++", "-O3", "-march=native", "-fPIC", "-shared", "-std=c++17",
            "-o", out, *srcs]


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


@functools.lru_cache(maxsize=None)
def get_lib() -> ctypes.CDLL:
    """The fovnative library (BVH build, OBJ parse), built on first use."""
    lib = ctypes.CDLL(str(_build.build_library("fovnative", [_FOVNATIVE],
                                               _compile)))
    c = ctypes
    fp, i32p, i64p = (c.POINTER(c.c_float), c.POINTER(c.c_int32),
                      c.POINTER(c.c_int64))
    sigs = {
        "fov_bvh_build": (c.c_void_p, [fp, fp, fp, c.POINTER(c.c_uint8),
                                       c.c_int64, c.c_int, c.c_int, c.c_int]),
        "fov_bvh_num_nodes": (c.c_int64, [c.c_void_p]),
        "fov_bvh_order_len": (c.c_int64, [c.c_void_p]),
        "fov_bvh_max_depth": (c.c_int32, [c.c_void_p]),
        "fov_bvh_copy": (None, [c.c_void_p, fp, fp, i32p, i32p, i32p, i64p]),
        "fov_bvh_free": (None, [c.c_void_p]),
        "fov_obj_load": (c.c_void_p, [c.c_char_p]),
        "fov_obj_num_vertices": (c.c_int64, [c.c_void_p]),
        "fov_obj_num_tris": (c.c_int64, [c.c_void_p]),
        "fov_obj_has_normals": (c.c_int32, [c.c_void_p]),
        "fov_obj_has_uvs": (c.c_int32, [c.c_void_p]),
        "fov_obj_copy": (None, [c.c_void_p, fp, fp, fp, i64p]),
        "fov_obj_free": (None, [c.c_void_p]),
    }
    for name, (res, args) in sigs.items():
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = res, args
    return lib


@functools.lru_cache(maxsize=None)
def png_lib() -> ctypes.CDLL:
    """The PNG row-filter library, built on first use."""
    lib = ctypes.CDLL(str(_build.build_library("png_unfilter", [_PNG],
                                               _compile)))
    u8p = ctypes.POINTER(ctypes.c_uint8)
    lib.fov_png_unfilter.restype = ctypes.c_int64
    lib.fov_png_unfilter.argtypes = [u8p, ctypes.c_int64, ctypes.c_int64,
                                     ctypes.c_int64, u8p]
    return lib


def build_bvh_native(v0: np.ndarray, e1: np.ndarray, e2: np.ndarray,
                     valid: np.ndarray, max_leaf: int = 16,
                     leaf_align: int = 16, num_bins: int = 16) -> dict:
    """Native binned-SAH BVH2: the flat arrays of `scene.bvh.FlatBVH`."""
    lib = get_lib()
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
        out = dict(nodes_min=np.empty((nn, 3), np.float32),
                   nodes_max=np.empty((nn, 3), np.float32),
                   nodes_left=np.empty((nn,), np.int32),
                   nodes_right=np.empty((nn,), np.int32),
                   nodes_leaf=np.empty((nn,), np.int32),
                   order=np.empty((lib.fov_bvh_order_len(h),), np.int64))
        lib.fov_bvh_copy(h, _ptr(out["nodes_min"], ctypes.c_float),
                         _ptr(out["nodes_max"], ctypes.c_float),
                         _ptr(out["nodes_left"], ctypes.c_int32),
                         _ptr(out["nodes_right"], ctypes.c_int32),
                         _ptr(out["nodes_leaf"], ctypes.c_int32),
                         _ptr(out["order"], ctypes.c_int64))
        out["max_depth"] = int(lib.fov_bvh_max_depth(h))
    finally:
        lib.fov_bvh_free(h)
    return out


def load_obj_native(path: str) -> Optional[Tuple[np.ndarray, np.ndarray,
                                                 Optional[np.ndarray],
                                                 Optional[np.ndarray]]]:
    """Native OBJ parse -> (positions [V,3], tris [T,3] int64, normals or
    None, uvs or None); None when the file cannot be opened or holds no
    face (the Python parser then says why, or returns empty arrays)."""
    lib = get_lib()
    h = lib.fov_obj_load(str(path).encode())
    if not h:
        return None
    try:
        nv, nt = lib.fov_obj_num_vertices(h), lib.fov_obj_num_tris(h)
        pos = np.empty((nv, 3), np.float32)
        norm = np.empty((nv, 3), np.float32)
        uv = np.empty((nv, 2), np.float32)
        tris = np.empty((nt, 3), np.int64)
        lib.fov_obj_copy(h, _ptr(pos, ctypes.c_float),
                         _ptr(norm, ctypes.c_float), _ptr(uv, ctypes.c_float),
                         _ptr(tris, ctypes.c_int64))
        has_n, has_uv = lib.fov_obj_has_normals(h), lib.fov_obj_has_uvs(h)
    finally:
        lib.fov_obj_free(h)
    return pos, tris, (norm if has_n else None), (uv if has_uv else None)


def png_unfilter(raw: bytes, h: int, stride: int, bpp: int) -> np.ndarray:
    """Decoded [h, stride] uint8 rows of a PNG image's inflated IDAT
    stream (h rows of a filter-type byte and `stride` filtered bytes)."""
    if len(raw) < h * (stride + 1):
        raise ValueError(f"PNG data holds {len(raw)} bytes; {h} rows of "
                         f"{stride + 1} need {h * (stride + 1)}")
    src = np.frombuffer(raw, np.uint8, h * (stride + 1))
    out = np.empty((h, stride), np.uint8)
    bad = png_lib().fov_png_unfilter(_ptr(src, ctypes.c_uint8), h, stride,
                                     bpp, _ptr(out, ctypes.c_uint8))
    if bad:
        ft = src[(bad - 1) * (stride + 1)]
        raise ValueError(f"bad PNG filter {ft}")
    return out
