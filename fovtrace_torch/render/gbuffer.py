"""Full-resolution primary-ray G-buffer (counterpart of
`fovtrace/render/gbuffer.py`).

One closest-hit pass and one binary shadow ray toward the light's far
corner per pixel, giving planar buffers: position, geometric normal,
shadow, view depth, albedo, previous-frame reprojection uv. Rays are
traced in 16x16 screen-tile order, so each 256-ray block is one compact
tile with a tight bundle for the cluster culling.
"""

from __future__ import annotations

import torch

from fovtrace_torch.core import vec
from fovtrace_torch.kernels import intersect as isect

TILE = 16


def _can_swizzle(height: int, width: int) -> bool:
    return height % TILE == 0 and width % TILE == 0


def swizzle_to_tiles(x, height: int, width: int):
    """Scanline-flat [H*W, ...] -> 16x16 tile-major flat."""
    ch = x.shape[1:]
    x = x.reshape((height // TILE, TILE, width // TILE, TILE) + ch)
    x = x.permute((0, 2, 1, 3) + tuple(range(4, 4 + len(ch))))
    return x.reshape((height * width,) + ch)


def unswizzle_from_tiles(x, height: int, width: int):
    """Inverse of swizzle_to_tiles."""
    ch = x.shape[1:]
    x = x.reshape((height // TILE, width // TILE, TILE, TILE) + ch)
    x = x.permute((0, 2, 1, 3) + tuple(range(4, 4 + len(ch))))
    return x.reshape((height * width,) + ch)


def shadow_rays(scene, rd_f, hit, surf, config):
    """The one-sample binary shadow ray of each pixel, toward the light's
    far corner: (origins, directions, t_max, relevant). Misses and
    back-facing pixels get t_max = -1, which the kernel culls."""
    valid = hit.valid
    point = vec.where(valid, surf["point"], 0.0)
    light = scene.light
    to_l = vec.of(light.corner + light.v1 + light.v2) - point
    ldist = vec.length(to_l)
    l = to_l * (1.0 / torch.clamp_min(ldist, 1e-20))
    n_ff = vec.faceforward(surf["normal"], -rd_f, surf["gnormal"])
    ndl = vec.dot(n_ff, l)
    ln = vec.of(light.normal)
    lndl = ln.x * l.x + ln.y * l.y + ln.z * l.z
    relevant = valid & (ndl > 0.0) & (lndl > 0.0)
    tmax = torch.where(relevant, ldist - config.scene_epsilon, -1.0)
    return point + n_ff * config.scene_epsilon, l, tmax, relevant


def trace_gbuffer(scene, camera, prev_camera, width: int, height: int,
                  config, y0: int | None = None,
                  block_h: int | None = None) -> dict:
    """Planar G-buffers (see the module docstring), plus `rays_traced`:
    primary rays and the shadow rays actually issued.

    With y0 / block_h set, traces only rows [y0, y0 + block_h), the
    row-sharded frame's block (dist.sharding). A row block is traced in
    scanline order, not in 16x16 tiles, as the reference's is."""
    bh = height if block_h is None else block_h
    ro, rd = camera.primary_rays_v(width, height, y0=y0 or 0, block_h=bh)
    ro_f = ro.map(lambda a: a.reshape(-1))
    rd_f = rd.map(lambda a: a.reshape(-1))
    sw = block_h is None and _can_swizzle(height, width)
    if sw:
        swz = lambda a: swizzle_to_tiles(a, height, width)
        ro_f, rd_f = ro_f.map(swz), rd_f.map(swz)

    hit, surf = isect.intersect_surface_v(
        scene, ro_f, rd_f, config.scene_epsilon, isect.BIG_T,
        backend=config.intersect_backend)
    valid = hit.valid
    point = vec.where(valid, surf["point"], 0.0)
    gnormal = vec.where(valid, surf["gnormal"], 0.0)
    depth = torch.where(valid, vec.length(point - vec.of(camera.eye)), 0.0)

    origin, l, shadow_tmax, relevant = shadow_rays(scene, rd_f, hit, surf,
                                                   config)
    atten = isect.occlusion_v(scene, origin, l, config.scene_epsilon,
                              shadow_tmax, backend=config.intersect_backend)
    shadow = torch.where(relevant, (vec.max3(atten) > 0.0).to(torch.float32),
                         0.0)
    albedo = vec.where(valid, surf["kd"], 0.0)

    # reverse reprojection into the previous frame's screen
    ru, rv = prev_camera.world_to_screen_v(point, width, height)
    ru = torch.where(valid, ru, -1.0)
    rv = torch.where(valid, rv, -1.0)

    if sw:
        unsw = lambda a: unswizzle_from_tiles(a, height, width)
        point, gnormal, albedo = point.map(unsw), gnormal.map(unsw), \
            albedo.map(unsw)
        shadow, depth, ru, rv, valid = (unsw(shadow), unsw(depth), unsw(ru),
                                        unsw(rv), unsw(valid))
    r2 = lambda a: a.reshape(bh, width)
    return {
        "position": point.map(r2),
        "normal": gnormal.map(r2),
        "shadow": r2(shadow),
        "depth": r2(depth),
        "albedo": albedo.map(r2),
        "reproject_u": r2(ru),
        "reproject_v": r2(rv),
        "hit_valid": r2(valid),
        "rays_traced": bh * width + relevant.sum(),
    }
