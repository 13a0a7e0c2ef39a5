"""Sibson (nearest-natural-neighbour) reconstruction (counterpart of
`fovtrace/kernels/sibson.py`).

Each pixel's disc radius is its distance to the nearest seed (the JFA
coordinate buffer), bounded by `max_radius` pixels; the output is the
mean of the JFA colour field over the pixels inside the disc, and a
pixel whose disc holds none keeps its nearest seed's colour.

The (2R+1)^2 window is swept row offset by row offset, each column
offset a slice of the padded planar channels; the sums run in the
reference's order (row offsets outer, column offsets inner), so they
round as its sums do.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from fovtrace_torch.core import mathx


def sibson_interpolate(coord: torch.Tensor, color: torch.Tensor,
                       max_radius: int = 16) -> torch.Tensor:
    """coord, color: [H,W,4] JFA outputs. Returns [H,W,4]."""
    h, w = color.shape[0], color.shape[1]
    r = max_radius
    dev = color.device
    f32 = np.float32

    ys = (torch.arange(h, dtype=torch.float32, device=dev)[:, None] + 0.5) / h
    xs = (torch.arange(w, dtype=torch.float32, device=dev)[None, :] + 0.5) / w
    dx_uv = coord[..., 0] - xs
    dy_uv = coord[..., 1] - ys
    # the reference's compiled norm contracts the second square into an
    # FMA; whether a seed's own offset lies inside the disc is decided in
    # the last ulp, so the rounding must be the same
    dist = mathx.sqrt_rn(mathx.fma(dy_uv, dy_uv, dx_uv * dx_uv))
    dist = torch.clamp_max(dist, float(f32(r) / f32(min(h, w))))
    d2 = dist * dist

    # planar padded channels: r, g, b and in-screen validity
    planes = torch.cat([color[..., :3].permute(2, 0, 1),
                        torch.ones((1, h, w), device=dev)])
    padded = F.pad(planes, (r, r, r, r))            # [4, H+2r, W+2r]

    inv_w2 = f32(1.0 / (w * w))
    inv_h2 = f32(1.0 / (h * h))
    acc = torch.zeros((4, h, w), device=dev)        # r, g, b, count
    for dy in range(-r, r + 1):
        rows = padded[:, r + dy:r + dy + h]
        dyf2 = f32(dy * dy) * inv_h2
        for dx in range(-r, r + 1):
            win = rows[:, :, r + dx:r + dx + w]
            rad2 = float(dyf2 + f32(dx * dx) * inv_w2)
            inside = ((rad2 <= d2) & (win[3] > 0.0)).to(torch.float32)
            acc = acc + inside * win        # validity is 0 or 1: the count
    cnt = acc[3]
    has = cnt > 0.0
    inv = 1.0 / torch.clamp_min(cnt, 1.0)
    rgb = torch.where(has, acc[:3] * inv, color[..., :3].permute(2, 0, 1))
    return torch.cat([rgb.permute(1, 2, 0), torch.ones((h, w, 1),
                                                       device=dev)], dim=-1)
