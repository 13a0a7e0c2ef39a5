"""Row-layout vector helpers (counterpart of `fovtrace/core/mathx.py`).

Only what the forward frame uses: the camera basis and the NaN-free
reciprocal the accumulation and reconstruction stages divide by.
"""

from __future__ import annotations

import torch


def safe_inv_pos(x: torch.Tensor) -> torch.Tensor:
    """1/x where x > 0, else 0 — NaN-free in the backward pass too (the
    untaken branch divides by a safe 1, not by 0)."""
    pos = x > 0.0
    safe = torch.where(pos, x, 1.0)
    return torch.where(pos, 1.0 / safe, 0.0)


def norm(v, eps: float = 1e-20):
    return torch.sqrt(torch.clamp_min(torch.sum(v * v, dim=-1, keepdim=True),
                                      eps))


def normalize(v, eps: float = 1e-20):
    return v / norm(v, eps)


def cross(a, b):
    return torch.linalg.cross(a, b, dim=-1)
