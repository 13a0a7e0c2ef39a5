"""Foveated sample masks and stream compaction (counterpart of
`fovtrace/kernels/sampling.py`).

Compaction is a stable cumsum scatter into a static budget. Indices that
fall outside the budget go to one extra sink slot, which is sliced off
(the reference drops them with an out-of-bounds scatter).
"""

from __future__ import annotations

import numpy as np
import torch

from fovtrace_torch.app.profiler import span
from fovtrace_torch.core import mathx

# 4x4 dither masks, 1 = sample
MASK_25 = np.asarray([[1, 1, 0, 0], [1, 1, 0, 0], [1, 1, 1, 1], [1, 1, 1, 1]],
                     bool)
MASK_50 = np.asarray([[1, 1, 0, 0], [1, 1, 0, 0], [0, 0, 1, 1], [0, 0, 1, 1]],
                     bool)
MASK_75 = np.asarray([[1, 1, 0, 0], [1, 1, 0, 0], [0, 0, 0, 0], [0, 0, 0, 0]],
                     bool)


def gaze_distance(height: int, width: int, gaze_px, device,
                  row_offset: int = 0, block_h: int | None = None
                  ) -> torch.Tensor:
    """|pixel - gaze| / |screen diagonal|, [H,W] (rows [row_offset,
    row_offset + block_h) of it with block_h set)."""
    gy, gx = gaze_px
    bh = height if block_h is None else block_h
    py = (torch.arange(bh, dtype=torch.float32, device=device)
          + float(row_offset))[:, None]
    px = torch.arange(width, dtype=torch.float32, device=device)[None, :]
    d = mathx.sqrt_rn((px - gx) ** 2 + (py - gy) ** 2)
    return d / float(np.sqrt(np.float32(float(width) ** 2
                                        + float(height) ** 2)))


def weier_sample_rate(gaze_dist, aperture: float, p_min: float = 0.05):
    """Weier et al.'s linear falloff: 1 inside r0, p_min beyond 2 r0."""
    r0 = aperture
    r1 = aperture * 2.0
    ramp = 1.0 - (1.0 - p_min) * ((gaze_dist - r0) / (r1 - r0))
    return torch.where(gaze_dist < r0, 1.0,
                       torch.where(gaze_dist > r1, p_min, ramp))


def author_sample_rate(gaze_dist, aperture: float):
    """The author's rational falloff."""
    alpha = ((1.0 / 0.8) - 1.0) / (aperture ** 2)
    return torch.clamp(1.0 / (alpha * (2.0 * gaze_dist) ** 2 + 1.0), 0.0,
                       1.0)


def logpolar_sampling(height: int, width: int, gaze_px, device,
                      kernel_scale: float = 0.25, row_offset: int = 0,
                      block_h: int | None = None):
    """[H,W] bool: a pixel is sampled iff it comes back to within
    sqrt(1.5 sqrt 2) px through the quarter-size log-polar buffer, its
    (u, v) rounded to that buffer's texels on the way. Each pixel is
    independent, so a row-sharded tile evaluates its rows [row_offset,
    row_offset + block_h) of the one global pattern."""
    from fovtrace_torch.kernels import logpolar

    gy, gx = gaze_px
    kh = int(height * kernel_scale)
    kw = int(width * kernel_scale)
    bh = height if block_h is None else block_h
    py = (torch.arange(bh, dtype=torch.float32, device=device)
          + float(row_offset))[:, None]
    px = torch.arange(width, dtype=torch.float32, device=device)[None, :]
    py, px = py.expand(bh, width), px.expand(bh, width)
    u, v = logpolar.forward_coords(px, py, gx, gy, kw, kh)
    x2, y2 = logpolar.inverse_coords(torch.round(u), torch.round(v), gx, gy,
                                     kw, kh)
    d = mathx.sqrt_rn((px - x2) ** 2 + (py - y2) ** 2)
    return d < float(np.sqrt(np.sqrt(np.float32(2.0)) * np.float32(1.5)))


def masked_sampling(height: int, width: int, gaze_dist, saliency,
                    aperture: float = 0.07, extra_sample_rate: int = 8):
    """Binary dither-mask decision [H,W] bool: full inside r0, 25-mask to
    1.5 r0, 50-mask to 2 r0; saliency bands add samples; a sparse
    1/extra^2 grid floors the periphery. The tables index [x % 4][y % 4],
    as in the reference. Each table is built on the host and uploaded in
    a blocking copy (span fov.sync.dither_table)."""
    dev = gaze_dist.device
    r0 = aperture
    r1 = r0 * 1.5
    r2 = r0 * 2.0
    ys = np.arange(height)[:, None] % 4
    xs = np.arange(width)[None, :] % 4

    def tab(m):
        with span("fov.sync.dither_table"):
            return torch.as_tensor(m[xs, ys], device=dev)
    m25, m50, m75 = tab(MASK_25), tab(MASK_50), tab(MASK_75)
    false = torch.zeros((), dtype=torch.bool, device=dev)

    sample = torch.where(
        gaze_dist < r0, True,
        torch.where(gaze_dist <= r1, m25,
                    torch.where(gaze_dist <= r2, m50, false)))
    g0, g1, g2 = 0.01, 0.4, 0.6
    s = saliency
    sal_extra = torch.where(
        (s > g0) & (s < g1), m75,
        torch.where((s >= g1) & (s < g2), m50,
                    torch.where(s >= g2, m25, false)))
    rows = torch.arange(height, device=dev)[:, None] % extra_sample_rate == 0
    cols = torch.arange(width, device=dev)[None, :] % extra_sample_rate == 0
    sal_extra = torch.where(s <= g0, rows & cols, sal_extra)
    return sample | sal_extra


def compact_mask_rank(mask: torch.Tensor, budget: int):
    """Stable compaction of a flat bool mask into `budget` slots.

    Returns (idx [budget] i64 source positions, active [budget] bool,
    rank [N] i64 slot of each selected lane, gate [N] bool: landed
    inside the budget). Set lanes beyond the budget are dropped."""
    n = mask.shape[0]
    dev = mask.device
    pos = torch.cumsum(mask.to(torch.int64), 0) - 1
    gate = mask & (pos < budget)
    dest = torch.where(gate, pos, budget)
    idx = torch.zeros((budget + 1,), dtype=torch.int64, device=dev)
    idx[dest] = torch.arange(n, dtype=torch.int64, device=dev)
    total = mask.sum()
    active = torch.arange(budget, device=dev) < total
    rank = torch.where(gate, pos, 0)
    return idx[:budget], active, rank, gate


def compact_mask_keyed_rank(mask: torch.Tensor, key: torch.Tensor, nkeys: int,
                            budget: int):
    """Stable key-major compaction: selected lanes are packed bucket 0
    first, then bucket 1, ..., in original order inside each bucket;
    overflow drops from the tail buckets. Returns (idx, active, rank,
    gate) as compact_mask_rank."""
    n = mask.shape[0]
    dev = mask.device
    dest = torch.full((n,), budget, dtype=torch.int64, device=dev)
    offset = torch.zeros((), dtype=torch.int64, device=dev)
    for k in range(nkeys):
        sel = mask & (key == k)
        seli = sel.to(torch.int64)
        r = offset + torch.cumsum(seli, 0) - 1
        dest = torch.where(sel & (r < budget), r, dest)
        offset = offset + seli.sum()
    idx = torch.zeros((budget + 1,), dtype=torch.int64, device=dev)
    idx[dest] = torch.arange(n, dtype=torch.int64, device=dev)
    active = torch.arange(budget, device=dev) < offset
    gate = dest < budget
    rank = torch.where(gate, dest, 0)
    return idx[:budget], active, rank, gate


def direction_octant(d) -> torch.Tensor:
    """[N] i64 in [0, 8): sign octant of an SoA direction."""
    return ((d.x < 0.0).to(torch.int64) * 4 + (d.y < 0.0).to(torch.int64) * 2
            + (d.z < 0.0).to(torch.int64))


class _ExpandByRank(torch.autograd.Function):
    @staticmethod
    def forward(ctx, rows, rank, gate, idx, active):
        ctx.save_for_backward(idx, active)
        return rows[rank] * gate.to(rows.dtype)[:, None]

    @staticmethod
    def backward(ctx, ct):
        idx, active = ctx.saved_tensors
        # slot j's cotangent is that of the one lane it landed on
        return ct[idx] * active.to(ct.dtype)[:, None], None, None, None, None


class _CompactGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, rows, idx, rank, gate):
        ctx.save_for_backward(rank, gate)
        return rows[idx]

    @staticmethod
    def backward(ctx, ct):
        rank, gate = ctx.saved_tensors
        return ct[rank] * gate.to(ct.dtype)[:, None], None, None, None


def expand_by_rank(rows, rank, gate, idx, active):
    """Compacted rows [B, C] back to source lanes [N, C]:
    out[p] = rows[rank[p]] * gate[p].

    (rank, gate) and (idx, active) are the two directions of one stable
    compaction (compact_mask_rank), so the adjoint is the inverse gather
    rows_bar[j] = ct[idx[j]] * active[j], not autograd's scatter-add of
    N rows into B (every dropped lane would add into row 0)."""
    return _ExpandByRank.apply(rows, rank, gate, idx, active)


def compact_gather(rows, idx, rank, gate):
    """Source rows [N, C] into compacted slots [B, C]: out[j] = rows[idx[j]].
    The adjoint is the inverse gather rows_bar[p] = ct[rank[p]] * gate[p];
    slots past the compacted count (which read row 0) send nothing back."""
    return _CompactGather.apply(rows, idx, rank, gate)
