"""The row-sharded frame (counterpart of `fovtrace/dist/sharding.py`).

The screen's rows are split into equal blocks, one per rank of the
process group (`make_mesh`), and each rank renders its block:

  - scene, materials and camera: every rank holds all of them
  - G-buffer, saliency, sampling and shading per row block; the six
    G-buffer planes the saliency reads get an 8-row halo, so its
    cross-tile Sobel taps are exact (dist.halo)
  - the gaze pixel belongs to one tile: its depth (the saliency's focal
    depth) and position (the thin-lens focus) are summed over the ranks
  - temporal reuse reads the previous frame at arbitrary reprojected
    pixels, so the history and depth caches are gathered once per frame
  - each tile compacts its own mask into its own budget
    (`tile_budget`); overflow is counted in `rays_dropped`
  - seeds and jitter come from global pixel ids, so every tiling traces
    the same rays
  - pull-push and A-Trous run on halos, JFA and Sibson gathered
    (dist.recon)

With a budget that drops nothing, `render_sharded` equals
`pipeline.render_frame` pixel for pixel, history included. A tile's
height must be a multiple of 8, which keeps the dither tables and the
sparse sampling floor globally aligned. A row block is traced in
scanline order, not in the single frame's 16x16 tiles.

A frame opens the single frame's spans (`app.profiler.span`, listed in
render.pipeline) under the same names, and each collective its
fov.coll.<op> span. The caches are gathered first, in a fov.sampling /
fov.sampling.cache span of their own, so a sharded frame holds two
fov.sampling spans.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from fovtrace_torch.app.profiler import span
from fovtrace_torch.config import RenderConfig, pin_fp32
from fovtrace_torch.core import color as colorx
from fovtrace_torch.core import reproject, vec
from fovtrace_torch.core.vec import Vec3
from fovtrace_torch.dist import collectives as coll
from fovtrace_torch.dist import halo as halo_mod
from fovtrace_torch.dist import launch
from fovtrace_torch.dist import recon as recon_mod
from fovtrace_torch.dist.collectives import Mesh
from fovtrace_torch.kernels import saliency, sampling
from fovtrace_torch.render import gbuffer as gbuffer_mod
from fovtrace_torch.render import pipeline

SALIENCY_HALO = 8   # covers the scale-4 Sobel taps at the 4x4 block corners


def make_mesh(n_devices: int | None = None, device="cuda") -> Mesh:
    """The row tiles over the process group's ranks (launch.global_mesh);
    `n_devices`, when given, must be the group's size."""
    mesh = launch.global_mesh(device)
    if n_devices is not None and n_devices != mesh.size:
        raise ValueError(f"{n_devices} tiles asked for, but the process "
                         f"group has {mesh.size} ranks")
    return mesh


def tile_budget(config: RenderConfig, n_tiles: int, block_h: int) -> int:
    """Per-tile compaction budget: sharded_budget_factor x the equal
    share, padded to 1024, capped at the tile's size."""
    eq = config.ray_budget / max(1, n_tiles)
    b = int(eq * config.sharded_budget_factor)
    b = max(1024, (b + 1023) // 1024 * 1024)
    return min(b, block_h * config.width)


def block_height(config: RenderConfig, mesh: Mesh) -> int:
    assert config.height % mesh.size == 0, "the height must divide the ranks"
    bh = config.height // mesh.size
    assert bh % 8 == 0, ("a tile's height must be a multiple of 8 (dither "
                         f"and sparse-floor alignment); got {bh}")
    return bh


def _reconstruct(shading_rgb: Vec3, shading_alpha, gbuf, config, mesh, y0):
    """pipeline.stage_reconstruct on a row block (dist.recon), each
    filter in its span."""
    recon = config.reconstruction
    extras: Dict[str, torch.Tensor] = {}
    out_rgb, out_a = shading_rgb, shading_alpha
    if recon == "none":
        return out_rgb, out_a, extras
    if recon in ("jfa", "sibson", "all"):
        sh_rows = torch.cat([vec.to_rows(shading_rgb),
                             shading_alpha[..., None]], dim=-1)
        if recon in ("jfa", "all"):
            with span("fov.reconstruct.jfa"):
                _, extras["jfa"] = recon_mod.jfa_sharded(sh_rows, mesh)
            out_rgb = vec.from_rows(extras["jfa"][..., :3])
            out_a = extras["jfa"][..., 3]
        if recon in ("sibson", "all"):
            with span("fov.reconstruct.sibson"):
                extras["sibson"] = recon_mod.sibson_sharded(
                    sh_rows, mesh, config.sibson_max_radius)
            out_rgb = vec.from_rows(extras["sibson"][..., :3])
            out_a = extras["sibson"][..., 3]
    if recon in ("pullpush", "atrous", "all"):
        with span("fov.reconstruct.pullpush"):
            pp_rgb, pp_a = recon_mod.pull_push_sharded(shading_rgb,
                                                       shading_alpha, mesh)
        extras["pullpush"] = torch.cat([vec.to_rows(pp_rgb),
                                        pp_a[..., None]], dim=-1)
        out_rgb, out_a = pp_rgb, pp_a
        if recon in ("atrous", "all"):
            with span("fov.reconstruct.atrous"):
                at = recon_mod.atrous_sharded(
                    pp_rgb, gbuf["position"], gbuf["normal"],
                    config.atrous_iterations, config.atrous_c_phi,
                    config.atrous_n_phi, config.atrous_p_phi, mesh, y0,
                    config.height)
            extras["atrous"] = torch.cat([vec.to_rows(at), pp_a[..., None]],
                                         dim=-1)
            out_rgb = at
    return out_rgb, out_a, extras


def render_sharded(scene, camera, gaze_px, state: pipeline.FrameState,
                   config: RenderConfig, mesh: Mesh
                   ) -> Tuple[Dict[str, torch.Tensor], pipeline.FrameState]:
    """This rank's block of one frame, with temporal state.

    `state` holds this rank's [4, bh, W] history and [bh, W] depth rows
    (initial_state_sharded). The contract is pipeline.render_frame's on
    the block: image_rgb / image_alpha and, with full_outputs, the row
    buffers hold this tile's rows; gaze_target, ray_count, rays_dropped
    and rays_traced are the frame's, the same on every rank."""
    with span("fov.frame"):
        return _render_block(scene, camera, gaze_px, state, config, mesh)


def _render_block(scene, camera, gaze_px, state: pipeline.FrameState,
                  config: RenderConfig, mesh: Mesh):
    pin_fp32(mesh.device)
    gaze_px = (int(gaze_px[0]), int(gaze_px[1]))
    gy, gx = gaze_px
    h, w = config.height, config.width
    bh = block_height(config, mesh)
    y0 = mesh.rank * bh
    dev = mesh.device

    # the temporal caches are read at arbitrary reprojected pixels
    with span("fov.sampling"), span("fov.sampling.cache"):
        caches = coll.all_gather_rows(
            torch.cat([state.history, state.depth_cache[None]]), mesh, dim=1)
    hist_full, depth_full = caches[:4], caches[4]

    # ---- 1. G-buffer rows --------------------------------------------------
    with span("fov.gbuffer"):
        gbuf = gbuffer_mod.trace_gbuffer(scene, camera, state.prev_camera, w,
                                         h, config, y0=y0, block_h=bh)

    # ---- 2. sampling: cache check, saliency on halos, mask -----------------
    with span("fov.sampling"):
        with span("fov.sampling.cache"):
            is_valid, _, _, fetched = reproject.validate_cache(
                gbuf["reproject_u"], gbuf["reproject_v"], gbuf["position"],
                depth_full, state.prev_camera.eye, w, h,
                config.cache_epsilon, history=hist_full)
            if not config.temporal:
                is_valid = torch.zeros_like(is_valid)
        # the gaze pixel's depth and position, from the tile that owns it
        p = gbuf["position"]
        gaze_rows = torch.zeros(4, dtype=torch.float32, device=dev)
        if y0 <= gy < y0 + bh:
            ly = gy - y0
            gaze_rows = torch.stack([gbuf["depth"][ly, gx], p.x[ly, gx],
                                     p.y[ly, gx], p.z[ly, gx]])
        gaze_rows = coll.all_reduce_sum(gaze_rows, mesh)
        focal, gaze_target = gaze_rows[0], gaze_rows[1:]

        with span("fov.sampling.saliency"):
            planes = [*gbuf["albedo"], gbuf["depth"], *gbuf["normal"],
                      gbuf["shadow"], gbuf["reproject_u"],
                      gbuf["reproject_v"]]
            pad = halo_mod.halo_pad_planes(planes, SALIENCY_HALO, mesh)
            gbuf_pad = {"albedo": Vec3(*pad[0:3]), "depth": pad[3],
                        "normal": Vec3(*pad[4:7]), "shadow": pad[7],
                        "reproject_u": pad[8], "reproject_v": pad[9]}
            sal = halo_mod.crop_rows(saliency.compute_saliency(
                gbuf_pad, gaze_px, pipeline.bbox_diagonal(scene),
                config.saliency_block, row_offset=y0 - SALIENCY_HALO,
                focal=focal), SALIENCY_HALO)
        # the dither tables and the sparse floor stay aligned: y0 % 8 == 0
        with span("fov.sampling.mask"):
            mask = pipeline.sample_mask(sal, gaze_px, state.frame, config,
                                        y0=y0)

    # ---- 3. per-tile compaction (scanline order) ---------------------------
    with span("fov.compact"):
        budget = tile_budget(config, mesh.size, bh)
        idx, active, rank, gate = sampling.compact_mask_rank(
            mask.reshape(-1), budget)

    # ---- 4. shading (global pixel ids) and the temporal accumulate ---------
    with span("fov.shade"):
        (shading_rgb, shading_alpha), history, traced_mask, shade_rays = \
            pipeline.stage_shade(scene, camera, idx, active, fetched,
                                 is_valid, state, config, gaze_target, rank,
                                 gate, y0=y0)

    # the frame's counters, in one collective (float64 holds them exactly)
    mask_count = mask.sum()
    counts = coll.all_reduce_sum(torch.stack([
        mask_count, mask_count - gate.sum(),
        gbuf["rays_traced"] + shade_rays]).to(torch.float64), mesh)
    ray_count, rays_dropped, rays_traced = counts.to(torch.int64).unbind()

    # ---- 5. reconstruction --------------------------------------------------
    with span("fov.reconstruct"):
        image_rgb, image_alpha, extras = _reconstruct(
            shading_rgb, shading_alpha, gbuf, config, mesh, y0)

    outputs: Dict[str, torch.Tensor] = {
        "image_rgb": image_rgb,
        "image_alpha": image_alpha,
        "gaze_target": gaze_target,
        "ray_count": ray_count,
        "rays_dropped": rays_dropped,
        "rays_traced": rays_traced,
    }
    if config.full_outputs:
        outputs.update({
            "image": vec.to_rows(image_rgb),
            "position": vec.to_rows(gbuf["position"]),
            "normal": vec.to_rows(gbuf["normal"]),
            "depth": gbuf["depth"],
            "albedo": vec.to_rows(gbuf["albedo"]),
            "weight": torch.stack([gbuf["reproject_u"], gbuf["reproject_v"],
                                   is_valid, torch.zeros_like(is_valid)],
                                  dim=-1),
            "shading": torch.cat([vec.to_rows(shading_rgb),
                                  shading_alpha[..., None]], dim=-1),
            "saliency": sal,
            "saliency_view": colorx.heatmap(sal),
            "mask": mask,
            "traced": traced_mask,
        })
        outputs.update(extras)
    new_state = pipeline.FrameState(history=history,
                                    depth_cache=gbuf["depth"],
                                    prev_camera=camera,
                                    frame=state.frame + 1)
    return outputs, new_state


def initial_state_sharded(camera, config: RenderConfig, mesh: Mesh
                          ) -> pipeline.FrameState:
    """FrameState whose history and depth caches hold this rank's rows."""
    bh = block_height(config, mesh)
    dev = mesh.device
    return pipeline.FrameState(
        history=torch.zeros((4, bh, config.width), device=dev),
        depth_cache=torch.zeros((bh, config.width), device=dev),
        prev_camera=camera,
        frame=torch.zeros((), dtype=torch.int64, device=dev))


def gather_frame(outputs: Dict[str, torch.Tensor], mesh: Mesh
                 ) -> Dict[str, torch.Tensor]:
    """The whole frame's outputs from every rank's block (row buffers
    gathered, the frame's scalars as they are), on every rank."""
    out = {}
    for k, v in outputs.items():
        if isinstance(v, Vec3):
            out[k] = Vec3(*coll.gather_planes(list(v), mesh))
        elif v.dim() >= 2:
            out[k] = coll.all_gather_rows(v, mesh)
        else:
            out[k] = v
    return out
