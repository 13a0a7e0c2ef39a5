"""Tone mapping, accumulation and visualisation colour maps
(counterpart of `fovtrace/core/color.py`)."""

from __future__ import annotations

import math

import torch

from fovtrace_torch.app.profiler import span
from fovtrace_torch.core import mathx


def _uncharted2_curve(x):
    A, B, C, D, E, F = 0.15, 0.50, 0.10, 0.20, 0.02, 0.30
    return ((x * (A * x + C * B) + D * E) / (x * (A * x + B) + D * F)) - E / F


def uncharted2_tonemap(color: torch.Tensor, exposure_bias: float = 2.0,
                       gamma: float = 2.2) -> torch.Tensor:
    """Uncharted2 filmic curve. Like the reference it raises to the power
    2.2 (not 1/2.2)."""
    result = _uncharted2_curve(exposure_bias * color)
    with span("fov.sync.tonemap_white"):
        white = torch.tensor(11.2, dtype=torch.float32, device=color.device)
    white = _uncharted2_curve(white)
    result = result * (1.0 / white)
    return torch.pow(torch.clamp_min(result, 0.0), gamma)


def accumulate_to_color(accum: torch.Tensor) -> torch.Tensor:
    """[..., 4] running sum (rgb, sample count) -> [..., 4] mean colour;
    alpha is 1 where samples exist, else the input alpha."""
    w = accum[..., 3:4]
    rgb = torch.where(w > 0.0, accum[..., :3] * mathx.safe_inv_pos(w),
                      accum[..., :3])
    a = torch.where(w[..., 0] > 0.0, 1.0, accum[..., 3])
    return torch.cat([rgb, a[..., None]], dim=-1)


def cool2warm(intensity: torch.Tensor) -> torch.Tensor:
    """Blue -> green -> red ramp, [...] -> [..., 3]."""
    i = intensity
    lo = torch.stack([torch.zeros_like(i), i * 2.0, 1.0 - i * 2.0], dim=-1)
    hi = torch.stack([(i - 0.5) * 2.0, (1.0 - i) * 2.0, torch.zeros_like(i)],
                     dim=-1)
    return torch.where(i[..., None] <= 0.5, lo, hi)


def heatmap(intensity: torch.Tensor) -> torch.Tensor:
    """The saliency view's colour map, [...] -> [..., 3]."""
    i = intensity
    half_pi = math.pi / 2.0
    return torch.stack([torch.cos(i * half_pi - half_pi),
                        torch.sin(i * math.pi) * 1.5,
                        torch.cos(i * half_pi)], dim=-1)


def linearize_depth(d, near, far):
    """Window depth in [0, 1] -> eye-space distance."""
    depth_sample = 2.0 * d - 1.0
    return 2.0 * near * far / (far + near - depth_sample * (far - near))
