"""Row-sharded reconstruction (counterpart of `fovtrace/dist/recon.py`).

  pull-push  the pull levels stay local while the tile's row count is
             even (and halves to at least 8); the small rest of the
             pyramid is gathered and finished by the single-frame
             `pull_push_v` (the same depth, so the same result), then
             pushed back down locally with a 1-row halo per level. The
             push blur's weights are alpha-gated, so the zero halos past
             the screen's edges are the single-frame out-of-bounds taps.
  A-Trous    2 * step halo rows of colour, position and normal per
             iteration, the rows past the screen's edges masked from the
             tap weights; gathered when the halo outgrows the tile.
  JFA, Sibson
             the flood's first steps span the screen: the sparse buffer
             is gathered and the single-frame kernels run on every rank.

All take and return planar [bh, W] rows (Vec3 of planes).
"""

from __future__ import annotations

import torch

from fovtrace_torch.core.vec import Vec3
from fovtrace_torch.dist.collectives import (Mesh, all_gather_rows,
                                             gather_planes, my_rows)
from fovtrace_torch.dist.halo import crop_rows, halo_pad_planes
from fovtrace_torch.kernels import atrous as atrous_mod
from fovtrace_torch.kernels import jfa as jfa_mod
from fovtrace_torch.kernels import pullpush as pp_mod
from fovtrace_torch.kernels import sibson as sibson_mod


def pull_push_sharded(rgb: Vec3, alpha, mesh: Mesh):
    """Row-sharded pull-push, equal to `pullpush.pull_push_v` on the
    gathered frame. Planar in and out."""
    pyramid = [(rgb, alpha)]
    while (pyramid[-1][1].shape[0] % 2 == 0
           and pyramid[-1][1].shape[0] // 2 >= 8
           and pyramid[-1][1].shape[1] % 2 == 0):
        pyramid.append(pp_mod._pull_level_v(*pyramid[-1]))
    top_rgb, top_a = pyramid[-1]
    bh = top_a.shape[0]
    gx, gy, gz, ga = gather_planes([*top_rgb, top_a], mesh)
    f_rgb, f_a = pp_mod.pull_push_v(Vec3(gx, gy, gz), ga)
    c_rgb, c_a = f_rgb.map(lambda p: my_rows(p, mesh, bh)), \
        my_rows(f_a, mesh, bh)
    for lv in range(len(pyramid) - 2, -1, -1):
        px, py, pz, pa = halo_pad_planes([*c_rgb, c_a], 1, mesh)
        up = pp_mod._upsample2
        fill_rgb, fill_a = pp_mod._blur3_v(Vec3(up(px), up(py), up(pz)),
                                           up(pa))
        crop = lambda p: p[2:-2]
        c_rgb, c_a = pp_mod._fill_from_v(*pyramid[lv], fill_rgb.map(crop),
                                         crop(fill_a))
    return c_rgb, c_a


def atrous_sharded(color: Vec3, pos: Vec3, norm: Vec3, iterations: int,
                   c_phi, n_phi, p_phi, mesh: Mesh, y0: int,
                   height: int) -> Vec3:
    """Row-sharded A-Trous, equal to `atrous.atrous_denoise_v` on the
    gathered frame: 2 * step halo rows per iteration, or gather, filter
    and slice when the halo exceeds the tile's height. Planar in/out."""
    bh = color.x.shape[0]
    dev = color.x.device
    out = color
    step = 1
    nphi = n_phi
    for _ in range(iterations):
        halo = 2 * step
        if halo > bh:   # more than one neighbour away: gather instead
            full = gather_planes([*out, *pos, *norm], mesh)
            filt = atrous_mod.atrous_step_v(
                Vec3(*full[0:3]), Vec3(*full[3:6]), Vec3(*full[6:9]),
                c_phi, nphi, p_phi, step)
            out = filt.map(lambda p: my_rows(p, mesh, bh))
        else:
            pad = halo_pad_planes([*out, *pos, *norm], halo, mesh)
            grow = torch.arange(bh + 2 * halo, device=dev) - halo + y0
            row_valid = (grow >= 0) & (grow < height)
            filt = atrous_mod.atrous_step_v(
                Vec3(*pad[0:3]), Vec3(*pad[3:6]), Vec3(*pad[6:9]), c_phi,
                nphi, p_phi, step, row_valid=row_valid)
            out = filt.map(lambda p: crop_rows(p, halo))
        step *= 2
        nphi *= 0.5
    return out


def jfa_sharded(shading_rows: torch.Tensor, mesh: Mesh):
    """JFA of the gathered [bh, W, 4] sparse buffer: this tile's (coord
    rows, colour rows)."""
    bh = shading_rows.shape[0]
    coord, color = jfa_mod.jump_flood(all_gather_rows(shading_rows, mesh))
    return my_rows(coord, mesh, bh), my_rows(color, mesh, bh)


def sibson_sharded(shading_rows: torch.Tensor, mesh: Mesh,
                   max_radius: int) -> torch.Tensor:
    """Sibson interpolation of the gathered sparse buffer: this tile's
    [bh, W, 4] rows."""
    bh = shading_rows.shape[0]
    coord, color = jfa_mod.jump_flood(all_gather_rows(shading_rows, mesh))
    return my_rows(sibson_mod.sibson_interpolate(coord, color, max_radius),
                   mesh, bh)
