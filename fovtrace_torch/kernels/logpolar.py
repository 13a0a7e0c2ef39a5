"""Log-polar foveated transform, forward and inverse (counterpart of
`fovtrace/kernels/logpolar.py`).

L = log of the largest gaze-to-corner distance. Forward maps (x, y) ->
(u, v) with u = (log r / L)^4 * buffer width and v the angle scaled to
the buffer height; inverse maps back. The buffer is a quarter of the
screen on each side. The coordinate maps are differentiable; the
resampling gathers the nearest texel.
"""

from __future__ import annotations

import math

import torch

from fovtrace_torch.core import mathx


def _f32(x, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=like.device)


def _log_max_corner(gx, gy, width, height, like):
    """log of the largest corner distance; gx, gy, width and height are
    whole numbers, so the squares are exact as in the reference."""
    g = lambda a, b: mathx.sqrt_rn(_f32(a * a + b * b, like))
    m = torch.maximum(torch.maximum(g(gx, gy), g(width - gx, height - gy)),
                      torch.maximum(g(gx, height - gy), g(width - gx, gy)))
    return torch.log(m)


def _pow4(x):
    x2 = x * x
    return x2 * x2


def forward_coords(x, y, gx, gy, buf_w: int, buf_h: int):
    """Screen (x, y) -> log-polar buffer (u, v), float."""
    xp = x - gx
    yp = y - gy
    L = _log_max_corner(gx, gy, buf_w, buf_h, x)
    r = mathx.sqrt_rn(xp * xp + yp * yp)
    u = _pow4(torch.log(torch.clamp_min(r, 1e-6)) / L) * buf_w
    ang = torch.atan2(yp, xp)
    ang = ang + torch.where(yp < 0.0, 2.0 * math.pi, 0.0)
    v = ang * (buf_h / (2.0 * math.pi))
    return u, v


def inverse_coords(u, v, gx, gy, buf_w: int, buf_h: int):
    """Log-polar buffer (u, v) -> screen (x, y), float."""
    L = _log_max_corner(gx, gy, buf_w, buf_h, u)
    B = (2.0 * math.pi) / buf_h
    K = torch.pow(torch.clamp_min(u / buf_w, 0.0), 0.25)
    r = torch.exp(L * K)
    return r * torch.cos(B * v) + gx, r * torch.sin(B * v) + gy


def forward_transform(img: torch.Tensor, gaze_px, scale: float = 0.25):
    """Screen image [H,W,C] -> log-polar image [H*scale, W*scale, C]."""
    h, w = img.shape[0], img.shape[1]
    bh, bw = int(h * scale), int(w * scale)
    gy, gx = gaze_px
    dev = img.device
    vu = torch.arange(bh, dtype=torch.float32, device=dev)[:, None].expand(
        bh, bw)
    uu = torch.arange(bw, dtype=torch.float32, device=dev)[None, :].expand(
        bh, bw)
    x, y = inverse_coords(uu, vu, gx, gy, bw, bh)
    xi = torch.clamp(torch.round(x), 0, w - 1).long()
    yi = torch.clamp(torch.round(y), 0, h - 1).long()
    return img[yi, xi]


def inverse_transform(lp_img: torch.Tensor, out_shape, gaze_px):
    """Log-polar image back to screen space [H,W,C]."""
    h, w = out_shape
    bh, bw = lp_img.shape[0], lp_img.shape[1]
    gy, gx = gaze_px
    dev = lp_img.device
    yy = torch.arange(h, dtype=torch.float32, device=dev)[:, None].expand(h, w)
    xx = torch.arange(w, dtype=torch.float32, device=dev)[None, :].expand(h, w)
    u, v = forward_coords(xx, yy, gx, gy, bw, bh)
    ui = torch.clamp(torch.round(u), 0, bw - 1).long()
    vi = torch.clamp(torch.round(v), 0, bh - 1).long()
    return lp_img[vi, ui]
