"""The envmap's bilinear, edge-clamped lookup, plain PyTorch (autograd
gives the gradients with respect to the coordinates and the map)."""

from __future__ import annotations

import torch

from reference import mathx


def _fma(x, y, z):
    """mathx.fma in float32 (one rounding; addcmul on the card), x * y + z
    in float64 (gradcheck)."""
    if x.dtype == torch.float64:
        return x * y + z
    return mathx.fma(x, y, z)


def _taps(fx, fy, h, w):
    """(x0, x1, y0, y1, wx, wy): the edge-clamped taps around (fx, fy)
    and the bilinear weights, as render/shade.py computed them."""
    x0 = torch.clamp(torch.floor(fx).to(torch.int64), 0, w - 1)
    y0 = torch.clamp(torch.floor(fy).to(torch.int64), 0, h - 1)
    wx = fx - x0
    wy = fy - y0
    x1 = torch.clamp_max(x0 + 1, w - 1)
    y1 = torch.clamp_max(y0 + 1, h - 1)
    return x0, x1, y0, y1, wx, wy


def _corners(fx, fy, envmap):
    """(c00, c01, c10, c11 [N, 3], wx, wy) of the four taps."""
    h, w = envmap.shape[0], envmap.shape[1]
    x0, x1, y0, y1, wx, wy = _taps(fx, fy, h, w)
    flat = envmap.reshape(-1, 3)
    return (flat[y0 * w + x0], flat[y0 * w + x1], flat[y1 * w + x0],
            flat[y1 * w + x1], wx, wy)


def lookup_plain(fx, fy, envmap, scale: float) -> torch.Tensor:
    """[3, N]: the bilinear, edge-clamped lookup times `scale`, the
    render path's expression before the kernel."""
    c00, c01, c10, c11, wx, wy = _corners(fx, fy, envmap)

    def bilerp(k):
        top = _fma(c00[:, k], 1 - wx, c01[:, k] * wx)
        bottom = _fma(c10[:, k], 1 - wx, c11[:, k] * wx)
        return _fma(top, 1 - wy, bottom * wy)

    return torch.stack([bilerp(0), bilerp(1), bilerp(2)]) * scale
