"""Host-side BVH build (counterpart of `fovtrace/scene/bvh.py`).

The binned-SAH BVH2 comes from the repository's native builder
(`native/fovnative.cpp`, bound in `fovtrace_torch.native`); unlike the
reference, no Python builder stands behind it. Triangles are
reordered into leaf order, which is also the order the intersection
pack's 128-triangle clusters are cut from — so the leaf order must be,
and is, the reference package's own.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class FlatBVH:
    nodes_min: np.ndarray    # [Nn,3] f32
    nodes_max: np.ndarray    # [Nn,3] f32
    nodes_left: np.ndarray   # [Nn] i32  inner: left child; leaf: tri start
    nodes_right: np.ndarray  # [Nn] i32  inner: right child; leaf: tri count
    nodes_leaf: np.ndarray   # [Nn] i32  1 = leaf
    order: np.ndarray        # [T'] i64  leaf-order triangle ids, -1 = pad
    max_depth: int

    @property
    def num_nodes(self) -> int:
        return len(self.nodes_min)


def build_bvh(v0: np.ndarray, e1: np.ndarray, e2: np.ndarray,
              valid: np.ndarray, max_leaf: int = 16, leaf_align: int = 16,
              num_bins: int = 16) -> FlatBVH:
    """Binned-SAH BVH2 over triangles (v0, v0+e1, v0+e2) by the native
    builder; `valid` masks out padding triangles."""
    if not np.any(valid):
        raise ValueError("empty scene")
    from fovtrace_torch import native

    return FlatBVH(**native.build_bvh_native(
        v0, e1, e2, valid, max_leaf=max_leaf, leaf_align=leaf_align,
        num_bins=num_bins))


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
