"""Tone mapping (counterpart of `fovtrace/core/color.py`)."""

from __future__ import annotations

import torch


def _uncharted2_curve(x):
    A, B, C, D, E, F = 0.15, 0.50, 0.10, 0.20, 0.02, 0.30
    return ((x * (A * x + C * B) + D * E) / (x * (A * x + B) + D * F)) - E / F


def uncharted2_tonemap(color: torch.Tensor, exposure_bias: float = 2.0,
                       gamma: float = 2.2) -> torch.Tensor:
    """Uncharted2 filmic curve. Like the reference it raises to the power
    2.2 (not 1/2.2)."""
    result = _uncharted2_curve(exposure_bias * color)
    white = _uncharted2_curve(torch.tensor(11.2, dtype=torch.float32,
                                           device=color.device))
    result = result * (1.0 / white)
    return torch.pow(torch.clamp_min(result, 0.0), gamma)
