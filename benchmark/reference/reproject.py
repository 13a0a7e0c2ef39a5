"""Temporal cache validation (counterpart of `fovtrace/core/reproject.py`).

The frame-to-frame history is a [4, H, W] tensor (rgb sum, sample
count) beside an [H, W] depth cache; both are fetched at each pixel's
reprojected position in one [H*W, 5] row gather.
"""

from __future__ import annotations

import torch

from reference import vec
from reference.vec import Vec3


def reproject_indices(ru, rv, width: int, height: int):
    """Clamped integer previous-frame indices and the in-range mask.
    ru, rv: [H,W] pixel-space uv into the previous frame (-1 = miss)."""
    in_range = ((ru > -1.0) & (rv > -1.0)
                & (ru >= 0.0) & (ru < width - 0.5)
                & (rv >= 0.0) & (rv < height - 0.5))
    qx = torch.clamp(torch.round(ru), 0, width - 1).to(torch.int64)
    qy = torch.clamp(torch.round(rv), 0, height - 1).to(torch.int64)
    return in_range, qy, qx


def fetch_cache(history, depth_cache, qy, qx):
    """One row gather of the combined cache: [H*W, 5] rows of
    (r, g, b, count, previous depth) at the reprojected pixels."""
    rows = torch.stack([history[0], history[1], history[2], history[3],
                        depth_cache], dim=-1)
    return rows[qy, qx].reshape(-1, 5)


def validate_cache(ru, rv, position: Vec3, depth_cache, prev_eye,
                   width: int, height: int, epsilon: float, history):
    """Per-pixel cache validity by depth agreement.

    Returns (is_valid [H,W] float, qy, qx, fetched [H*W, 5])."""
    in_range, qy, qx = reproject_indices(ru, rv, width, height)
    fetched = fetch_cache(history, depth_cache, qy, qx)
    prev_depth = fetched[:, 4].reshape(ru.shape)
    cur_depth = vec.length(position - vec.of(prev_eye))
    hit = (prev_depth - cur_depth).abs() < epsilon
    is_valid = (in_range & hit).to(torch.float32)
    return is_valid, qy, qx, fetched


def history_from_fetch(fetched, is_valid):
    """[H*W, 5] fetched rows -> [4, H, W] history planes, zero where the
    reprojected entry is invalid."""
    h, w = is_valid.shape
    planes = fetched[:, :4].T.reshape(4, h, w)
    return torch.where((is_valid > 0.0)[None], planes, 0.0)


def fetch_history(history_cache, qy, qx, is_valid):
    """History alone at the reprojected pixels, zero where invalid:
    [4, H, W] from history_cache [4, H, W] (validate_cache's combined
    fetch serves the frame)."""
    ok = is_valid > 0.0
    f = history_cache.permute(1, 2, 0)[qy, qx]
    return torch.where(ok[None], f.permute(2, 0, 1), 0.0)
