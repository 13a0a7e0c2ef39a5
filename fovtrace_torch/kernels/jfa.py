"""Jump-flooding Voronoi fill (counterpart of `fovtrace/kernels/jfa.py`).

Every pixel tracks its nearest sample ("seed") over log2 rounds of
8-neighbour taps at halving steps. The flood carries one packed int32
plane (seed_y << 16 | seed_x, -1 = no seed yet) and the distance plane;
the seeds' colours are fetched once at the end with one row gather.

Distances use the reference's normalised-uv metric, sqrt((dx/W)^2 +
(dy/H)^2), with a strict-less update in the reference's tap order, so
the seed assignment is the reference's.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from fovtrace_torch.core import mathx


def _shift_packed(p, dy: int, dx: int):
    """Roll the packed plane by (dy, dx); taps from off screen are -1."""
    h, w = p.shape
    out = torch.roll(p, shifts=(dy, dx), dims=(0, 1))
    ys = torch.arange(h, device=p.device)[:, None]
    xs = torch.arange(w, device=p.device)[None, :]
    valid = (ys - dy >= 0) & (ys - dy < h) & (xs - dx >= 0) & (xs - dx < w)
    return torch.where(valid, out, -1)


def max_step(height: int, width: int) -> int:
    """Smallest power of two >= half the larger screen side."""
    s = 1
    while s < max(height, width) // 2:
        s *= 2
    return s


def jump_flood_packed(alpha: torch.Tensor) -> torch.Tensor:
    """alpha [H,W] (> 0 marks seeds) -> packed [H,W] int32 nearest-seed
    plane (-1 where no seed was reached: only in a frame with none)."""
    h, w = alpha.shape
    dev = alpha.device
    yy = torch.arange(h, dtype=torch.int32, device=dev)[:, None].expand(h, w)
    xx = torch.arange(w, dtype=torch.int32, device=dev)[None, :].expand(h, w)
    inv_w, inv_h = float(np.float32(1.0 / w)), float(np.float32(1.0 / h))

    is_seed = alpha > 0.0
    packed = torch.where(is_seed, yy * 65536 + xx, -1).to(torch.int32)
    dist = torch.where(is_seed, 0.0, float("inf"))

    step = max_step(h, w)
    while step >= 1:
        for dy in (-step, 0, step):
            for dx in (-step, 0, step):
                if dy == 0 and dx == 0:
                    continue
                np_ = _shift_packed(packed, dy, dx)
                ny = torch.div(np_, 65536, rounding_mode="floor")
                nx = np_ - ny * 65536
                ndx = (nx - xx).to(torch.float32) * inv_w
                ndy = (ny - yy).to(torch.float32) * inv_h
                ndist = mathx.sqrt_rn(ndx * ndx + ndy * ndy)
                better = (np_ >= 0) & ((packed < 0) | (ndist < dist))
                packed = torch.where(better, np_, packed)
                dist = torch.where(better, ndist, dist)
        step //= 2
    return packed


def _unpack(packed):
    safe = packed.clamp_min(0)
    sy = torch.div(safe, 65536, rounding_mode="floor")
    return packed >= 0, sy, safe - sy * 65536


def packed_coord(packed: torch.Tensor) -> torch.Tensor:
    """Packed plane -> [H,W,4]: xy the nearest seed's normalised uv, w
    its validity (the reference's coordinate texture)."""
    h, w = packed.shape
    valid, sy, sx = _unpack(packed)
    vf = valid.to(torch.float32)
    u = (sx.to(torch.float32) + 0.5) / w
    v = (sy.to(torch.float32) + 0.5) / h
    return torch.stack([u * vf, v * vf, torch.zeros_like(u), vf], dim=-1)


def packed_gather_rows(packed: torch.Tensor, rows: torch.Tensor,
                       fallback: torch.Tensor) -> torch.Tensor:
    """Each pixel's nearest-seed row of rows [H*W, C]; `fallback`
    [H,W,C] where no seed was reached."""
    h, w = packed.shape
    valid, sy, sx = _unpack(packed)
    out = rows[(sy * w + sx).reshape(-1).long()].reshape(h, w, rows.shape[1])
    return torch.where(valid[..., None], out, fallback)


def jump_flood(sparse_color: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """JFA from a sparse [H,W,4] colour buffer (alpha > 0 marks seeds).
    Returns (coord [H,W,4], colour [H,W,4])."""
    packed = jump_flood_packed(sparse_color[..., 3])
    color = packed_gather_rows(packed, sparse_color.reshape(-1, 4),
                               sparse_color)
    return packed_coord(packed), color
