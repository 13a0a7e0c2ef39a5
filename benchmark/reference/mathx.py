"""Row-layout vector helpers (counterpart of `fovtrace/core/mathx.py`).

What the frame uses: the camera basis, the NaN-free reciprocal the
accumulation and reconstruction stages divide by, a correctly rounded
float32 square root and a fused multiply-add; and the quaternions of the
camera's pose helpers.
"""

from __future__ import annotations

import numpy as np
import torch


def safe_inv_pos(x: torch.Tensor) -> torch.Tensor:
    """1/x where x > 0, else 0 — NaN-free in the backward pass too (the
    untaken branch divides by a safe 1, not by 0)."""
    pos = x > 0.0
    safe = torch.where(pos, x, 1.0)
    return torch.where(pos, 1.0 / safe, 0.0)


def norm(v, eps: float = 1e-20):
    return sqrt_rn(torch.clamp_min(torch.sum(v * v, dim=-1, keepdim=True),
                                      eps))


def normalize(v, eps: float = 1e-20):
    return v / norm(v, eps)


def cross(a, b):
    return torch.linalg.cross(a, b, dim=-1)


def sqrt_rn(x: torch.Tensor) -> torch.Tensor:
    """float32 square root, correctly rounded on every device, as the
    reference's compiled code rounds it. PyTorch's vectorised float32 CPU
    sqrt is off by an ulp for some inputs; its CUDA sqrt is exact."""
    if x.is_cuda:
        return torch.sqrt(x)
    return torch.sqrt(x.double()).float()


def fma(x, y, z) -> torch.Tensor:
    """x * y + z with one float32 rounding, where the reference's compiled
    code contracts a multiply and an add into a fused multiply-add. Any
    of the three may be a Python number (taken as float32, as the
    reference's weakly typed constants are). On CUDA, addcmul's kernel
    computes it as one fused multiply-add; on the CPU it runs in float64,
    where the product is exact."""
    ref = next(a for a in (x, y, z) if isinstance(a, torch.Tensor))
    if ref.is_cuda:
        x, y, z = (a if isinstance(a, torch.Tensor) else
                   torch.full((), a, dtype=torch.float32, device=ref.device)
                   for a in (x, y, z))
        return torch.addcmul(z, x, y)
    d = lambda a: (a.double() if isinstance(a, torch.Tensor)
                   else float(np.float32(a)))
    return (d(x) * d(y) + d(z)).float()


# --- quaternions [w, x, y, z] (the camera's rotate / rotate_around)
def quat_from_axis_angle(axis, angle) -> torch.Tensor:
    """Unit quaternion for a rotation of `angle` radians about `axis`."""
    axis = torch.as_tensor(axis, dtype=torch.float32)
    axis = normalize(axis)
    half = torch.as_tensor(angle, dtype=torch.float32,
                           device=axis.device) * 0.5
    return torch.cat([torch.cos(half)[None], torch.sin(half) * axis])


def quat_mul(q1, q2) -> torch.Tensor:
    w1, x1, y1, z1 = q1[0], q1[1], q1[2], q1[3]
    w2, x2, y2, z2 = q2[0], q2[1], q2[2], q2[3]
    return torch.stack([
        w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
    ])


def quat_rotate(q, v) -> torch.Tensor:
    """Vector(s) v [..., 3] rotated by the unit quaternion q."""
    qv = q[1:4].expand_as(v)
    t = 2.0 * cross(qv, v)
    return v + q[0] * t + cross(qv, t)
