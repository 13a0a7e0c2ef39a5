"""Per-pixel saliency field (counterpart of `fovtrace/kernels/saliency.py`).

  saliency = ((R-G + B-Y)/2 + L + orientation) / 3
  saliency = max(saliency, normal_gradient) * depth_saliency
  saliency = max(saliency, velocity) * shadow_term

computed at 4x4 block granularity: every block-sampled term is read at
its block's corner pixel, so it is computed on the corner grid and
broadcast back.
"""

from __future__ import annotations

import numpy as np
import torch

from fovtrace_torch.core import mathx

_SOBEL_GX = ((-1.0, 0.0, 1.0), (-2.0, 0.0, 2.0), (-1.0, 0.0, 1.0))
_SOBEL_GY = ((-1.0, -2.0, -1.0), (0.0, 0.0, 0.0), (1.0, 2.0, 1.0))
# sqrt(2 pi) rounded in float32, as the reference computes it
_SQRT_2PI = float(np.sqrt(np.float32(2.0 * np.pi)))
# The reference's compiled frame divides by 3 and 6 as multiplications by
# the float32 reciprocals. The difference matters: on flat-albedo regions
# the Sobel gy is a rounding residual, and the orientation term
# atan(gy / 1e-12) takes its sign, which moves whole 4x4 blocks of the
# sample mask.
_THIRD = float(np.float32(1.0) / np.float32(3.0))
_SIXTH = float(np.float32(1.0) / np.float32(6.0))


def _shift2d(img, dy: int, dx: int):
    """Shift with zero fill (out-of-bounds taps contribute 0)."""
    out = torch.roll(img, shifts=(dy, dx), dims=(0, 1))
    h, w = img.shape[0], img.shape[1]
    ys = torch.arange(h, device=img.device)[:, None]
    xs = torch.arange(w, device=img.device)[None, :]
    valid = (ys - dy >= 0) & (ys - dy < h) & (xs - dx >= 0) & (xs - dx < w)
    return torch.where(valid, out, 0.0)


def sobel(gray, scale: int = 1):
    """Sobel (gx, gy) with taps at offset * scale."""
    gx = torch.zeros_like(gray)
    gy = torch.zeros_like(gray)
    for j in range(3):
        for i in range(3):
            tap = _shift2d(gray, -(j - 1) * scale, -(i - 1) * scale)
            gx = gx + tap * _SOBEL_GX[j][i]
            gy = gy + tap * _SOBEL_GY[j][i]
    return gx, gy


def rgby_opponency(rgb):
    """RGBY colour opponency of a planar Vec3 -> (R-G, B-Y, L)."""
    r, g, b = rgb.x, rgb.y, rgb.z
    R = r - (g + b) / 2.0
    G = g - (r + b) / 2.0
    B = b - (r + g) / 2.0
    Y = (r + g) / 2.0 - (r - g).abs() / 2.0 - b
    L = (r + g + b) * _THIRD
    return R - G, B - Y, L


def depth_saliency(depth, theta, focal):
    """Depth-of-field Gaussian around the gaze focal depth."""
    dd = depth - focal
    d = 0.4 * theta
    ad = 1.0 * theta
    return 1.0 / (d * _SQRT_2PI) * torch.exp(-(dd * dd) / (d * d)) * ad


# 1 / (m sqrt(2 pi)) with m = -0.4, rounded step by step in float32
_VEL_K = float(np.float32(1.0) / (np.float32(-0.4) * np.float32(_SQRT_2PI)))


def velocity_map(velocity):
    """Motion-sensitivity curve."""
    m = -0.4
    am = 20.0
    v = (velocity / am) ** 2
    return _VEL_K * torch.exp(-v / (m * m)) + 1.0


def compute_saliency(gbuf, gaze_px, bbox_diag, block: int = 4,
                     row_offset: int = 0, focal=None):
    """Saliency field [H,W] from the planar G-buffers. gaze_px: (gy, gx)
    ints; bbox_diag: the scene bbox diagonal (for the DOF width).

    A row-sharded tile passes `row_offset`, the global row of its local
    row 0 (a multiple of `block`, so the corner grid stays the global
    one), and `focal`, the gaze pixel's depth, which one tile owns
    (dist.sharding)."""
    h, w = gbuf["depth"].shape
    dev = gbuf["depth"].device
    if h % block == 0 and w % block == 0:
        corner = lambda img: img[::block, ::block]
        corner_scale = 1

        def bcast(c):
            hb, wb = c.shape
            return c[:, None, :, None].expand(hb, block, wb, block).reshape(
                h, w)
    else:
        ys = (torch.arange(h, device=dev) // block) * block
        xs = (torch.arange(w, device=dev) // block) * block
        corner = lambda img: img[ys[:, None], xs[None, :]]
        corner_scale = block
        bcast = lambda c: c

    alb_c = gbuf["albedo"].map(corner)
    rg_b, by_b, lum_b = rgby_opponency(alb_c)
    gray_c = (alb_c.x + alb_c.y + alb_c.z) * _THIRD
    gx, gy = sobel(gray_c, scale=corner_scale)
    orient = torch.atan(gy / torch.where(gx.abs() < 1e-12, 1e-12, gx))

    theta = bbox_diag * 0.005
    if focal is None:
        focal = gbuf["depth"][gaze_px[0], gaze_px[1]]
    s_depth_c = depth_saliency(corner(gbuf["depth"]), theta, focal)
    s_shadow = bcast(corner(gbuf["shadow"]))

    nrm = gbuf["normal"]
    ngray_c = corner((nrm.x + nrm.y + nrm.z) * _SIXTH + 0.5)
    ngx, ngy = sobel(ngray_c, scale=corner_scale)
    s_normal_grad = mathx.sqrt_rn(ngx ** 2 + ngy ** 2)

    # velocity from the reprojection offset is per pixel, in global
    # pixel coordinates (those of reproject_u / v)
    px = torch.arange(w, dtype=torch.float32, device=dev)[None, :]
    py = (torch.arange(h, dtype=torch.float32, device=dev)
          + float(row_offset))[:, None]
    qu, qv = gbuf["reproject_u"], gbuf["reproject_v"]
    vel = 0.5 * mathx.sqrt_rn((px - qu) ** 2 + (py - qv) ** 2)
    vel = torch.where((qu < 0.0) & (qv < 0.0), 0.0, vel)
    s_velocity = velocity_map(vel)

    sal_c = ((rg_b + by_b) / 2.0 + lum_b + orient) * _THIRD
    sal_c = torch.maximum(sal_c, s_normal_grad)
    sal_c = sal_c * s_depth_c
    return torch.maximum(bcast(sal_c), s_velocity) * s_shadow
