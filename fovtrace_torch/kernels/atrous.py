"""Edge-aware A-Trous wavelet denoiser (counterpart of
`fovtrace/kernels/atrous.py`): a 25-tap B3-spline kernel with per-tap
colour, normal and position weights; the step doubles and n_phi halves
every iteration.
"""

from __future__ import annotations

import torch

from fovtrace_torch.core import vec
from fovtrace_torch.core.vec import Vec3

_KERNEL = [
    [1 / 256, 1 / 64, 3 / 128, 1 / 64, 1 / 256],
    [1 / 64, 1 / 16, 3 / 32, 1 / 16, 1 / 64],
    [3 / 128, 3 / 32, 9 / 64, 3 / 32, 3 / 128],
    [1 / 64, 1 / 16, 3 / 32, 1 / 16, 1 / 64],
    [1 / 256, 1 / 64, 3 / 128, 1 / 64, 1 / 256],
]


def atrous_step_v(color: Vec3, position: Vec3, normal: Vec3, c_phi, n_phi,
                  p_phi, step: int, row_valid=None) -> Vec3:
    """One 25-tap pass at the given step width (planar [H,W]).

    row_valid: optional [H] bool, the rows that are screen rows. A
    row-sharded tile passes its rows padded with halos, zero past the
    screen's edges; masking those taps gives the single-frame filter's
    out-of-bounds behaviour (dist.recon)."""
    h, w = color.x.shape
    dev = color.x.device
    ys = torch.arange(h, device=dev)[:, None]
    xs = torch.arange(w, device=dev)[None, :]
    acc = vec.zeros((h, w), dev)
    cum_w = torch.zeros((h, w), device=dev)
    for j in range(5):
        for i in range(5):
            dy = (j - 2) * step
            dx = (i - 2) * step
            roll = lambda p: torch.roll(p, shifts=(dy, dx), dims=(0, 1))
            valid = (ys - dy >= 0) & (ys - dy < h) & (xs - dx >= 0) & (xs - dx < w)
            if row_valid is not None:
                valid = valid & torch.roll(row_valid, dy)[:, None]
            ctap = color.map(roll)
            dc = color - ctap
            c_w = torch.clamp_max(torch.exp(-vec.dot(dc, dc) / c_phi), 1.0)
            dn = normal - normal.map(roll)
            n_w = torch.clamp_max(
                torch.exp(-(vec.dot(dn, dn) / (step * step)) / n_phi), 1.0)
            dp = position - position.map(roll)
            p_w = torch.clamp_max(torch.exp(-vec.dot(dp, dp) / p_phi), 1.0)
            weight = torch.where(valid, c_w * n_w * p_w * _KERNEL[j][i], 0.0)
            acc = acc + ctap * weight
            cum_w = cum_w + weight
    return acc * (1.0 / torch.clamp_min(cum_w, 1e-20))


def atrous_denoise_v(color: Vec3, position: Vec3, normal: Vec3,
                     iterations: int = 1, c_phi: float = 1.0,
                     n_phi: float = 0.5, p_phi: float = 0.5) -> Vec3:
    """Iterated A-Trous: step doubles, n_phi halves."""
    out = color
    step = 1
    nphi = n_phi
    for _ in range(iterations):
        out = atrous_step_v(out, position, normal, c_phi, nphi, p_phi, step)
        step *= 2
        nphi *= 0.5
    return out
