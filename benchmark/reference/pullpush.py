"""Pull-push pyramid hole filling (counterpart of
`fovtrace/kernels/pullpush.py`): pull averages the valid samples of each
2x2 quad level by level; push fills each level's holes from a 3x3 blur
of the upsampled coarser level and keeps valid fine samples.
"""

from __future__ import annotations

from typing import List, Tuple

import torch

from reference import mathx, vec
from reference.vec import Vec3

_PUSH_W = [[1 / 16, 1 / 8, 1 / 16], [1 / 8, 1 / 4, 1 / 8],
           [1 / 16, 1 / 8, 1 / 16]]


def _pull_level_v(rgb: Vec3, a) -> Tuple[Vec3, torch.Tensor]:
    """[H,W] planes -> [H/2,W/2]: alpha-weighted quad average; alpha out
    = any valid sample."""
    h, w = a.shape
    quad = lambda p: p.reshape(h // 2, 2, w // 2, 2).sum(dim=(1, 3))
    sa = quad(a)
    inv = mathx.safe_inv_pos(sa)
    out = Vec3(quad(rgb.x * a) * inv, quad(rgb.y * a) * inv,
               quad(rgb.z * a) * inv)
    return out, (sa > 0.0).to(torch.float32)


def _upsample2(p):
    return p.repeat_interleave(2, dim=0).repeat_interleave(2, dim=1)


def _blur3_v(rgb: Vec3, a) -> Tuple[Vec3, torch.Tensor]:
    """3x3 normalized blur over valid samples."""
    h, w = a.shape
    dev = a.device
    ax = torch.zeros((h, w), device=dev)
    ay = torch.zeros((h, w), device=dev)
    az = torch.zeros((h, w), device=dev)
    wacc = torch.zeros((h, w), device=dev)
    ys = torch.arange(h, device=dev)[:, None]
    xs = torch.arange(w, device=dev)[None, :]
    for j in range(3):
        for i in range(3):
            dy, dx = j - 1, i - 1
            sh = lambda p: torch.roll(p, shifts=(-dy, -dx), dims=(0, 1))
            valid = (ys + dy >= 0) & (ys + dy < h) & (xs + dx >= 0) & (xs + dx < w)
            wgt = _PUSH_W[j][i] * torch.where(valid, sh(a), 0.0)
            ax = ax + sh(rgb.x) * wgt
            ay = ay + sh(rgb.y) * wgt
            az = az + sh(rgb.z) * wgt
            wacc = wacc + wgt
    inv = mathx.safe_inv_pos(wacc)
    return Vec3(ax * inv, ay * inv, az * inv), (wacc > 0.0).to(torch.float32)


def _fill_from_v(fine_rgb: Vec3, fine_a, fb_rgb: Vec3, fb_a):
    """Keep valid fine samples; fill holes from the fallback."""
    return vec.where(fine_a > 0.0, fine_rgb, fb_rgb), torch.maximum(fine_a, fb_a)


def max_levels(h: int, w: int) -> int:
    lv = 0
    while (h % (2 ** (lv + 1)) == 0 and w % (2 ** (lv + 1)) == 0
           and min(h, w) // (2 ** (lv + 1)) >= 1):
        lv += 1
    return lv


def pull_push_v(rgb: Vec3, alpha, levels: int | None = None):
    """Fill holes in sparse planar (rgb, alpha); returns dense planar
    (rgb, alpha)."""
    h, w = alpha.shape
    max_lv = max_levels(h, w)
    levels = max_lv if levels is None else min(levels, max_lv)
    pyramid: List[Tuple[Vec3, torch.Tensor]] = [(rgb, alpha)]
    for _ in range(levels):
        pyramid.append(_pull_level_v(*pyramid[-1]))
    c_rgb, c_a = pyramid[-1]
    c_rgb, c_a = _fill_from_v(c_rgb, c_a, *_blur3_v(c_rgb, c_a))
    for lv in range(levels - 1, -1, -1):
        f_rgb, f_a = pyramid[lv]
        fh, fw = f_a.shape
        up_rgb = c_rgb.map(lambda p: _upsample2(p)[:fh, :fw])
        up_a = _upsample2(c_a)[:fh, :fw]
        fill_rgb, fill_a = _blur3_v(up_rgb, up_a)
        c_rgb, c_a = _fill_from_v(f_rgb, f_a, fill_rgb, fill_a)
    return c_rgb, c_a
