"""Per-frame render pipeline, plain PyTorch.

  gbuffer      primary-ray G-buffer and shadow term   (reference.gbuffer)
  sampling     cache validation, saliency, sample mask
  compact      the mask, compacted in 16x16 tile order into the static
               ray budget
  shade        wavefront path trace of the compacted rays + temporal
               accumulation                            (reference.shade)
  reconstruct  pull-push hole filling, then A-Trous

Frame-to-frame state is an explicit `FrameState`. `render_frame` takes
an optional `quantize` function, applied to every float tensor that
crosses a stage boundary (the benchmark's control: bfloat16 storage
between stages).
"""

from __future__ import annotations

import dataclasses
import torch

from reference.config import RenderConfig, pin_fp32
from reference import color as colorx
from reference import mathx, reproject, rng, vec
from reference.camera import Camera
from reference.vec import Vec3
from reference import atrous, pullpush, saliency, sampling
from reference import gbuffer as gbuffer_mod
from reference import shade as shade_mod


@dataclasses.dataclass(frozen=True)
class FrameState:
    history: torch.Tensor      # [4,H,W] accumulated rgb + sample count
    depth_cache: torch.Tensor  # [H,W] view depth of the previous frame
    prev_camera: Camera
    frame: torch.Tensor        # 0-d int64

    @classmethod
    def initial(cls, camera: Camera, config: RenderConfig) -> "FrameState":
        h, w = config.height, config.width
        dev = camera.device
        return cls(history=torch.zeros((4, h, w), device=dev),
                   depth_cache=torch.zeros((h, w), device=dev),
                   prev_camera=camera,
                   frame=torch.zeros((), dtype=torch.int64, device=dev))

    def detach(self) -> "FrameState":
        """The same state cut from any autograd graph."""
        cam = self.prev_camera
        return FrameState(
            history=self.history.detach(),
            depth_cache=self.depth_cache.detach(),
            prev_camera=cam.replace(**{
                f.name: getattr(cam, f.name).detach()
                for f in dataclasses.fields(cam)
                if isinstance(getattr(cam, f.name), torch.Tensor)}),
            frame=self.frame)


def stage_gbuffer(scene, camera, prev_camera, config: RenderConfig):
    return gbuffer_mod.trace_gbuffer(scene, camera, prev_camera, config.width,
                                     config.height, config)


def bbox_diagonal(scene) -> torch.Tensor:
    """The scene bbox's diagonal (the saliency's depth-of-field width)."""
    d = scene.bbox_max - scene.bbox_min
    return mathx.sqrt_rn(d[0] * d[0] + d[1] * d[1] + d[2] * d[2])


def sample_mask(sal, gaze_px, frame, config: RenderConfig, y0: int = 0):
    """The sample mask of rows [y0, y0 + bh) in the configured sampling
    mode, bh being the saliency's rows (the whole frame, or a sharded
    tile's block: every mode evaluates the one global pattern)."""
    h, w = config.height, config.width
    bh = sal.shape[0]
    dev = sal.device
    gdist = sampling.gaze_distance(h, w, gaze_px, dev, row_offset=y0,
                                   block_h=bh)
    mode = config.sampling_mode
    if mode == "full":
        return torch.ones((bh, w), dtype=torch.bool, device=dev)
    if mode in ("weier", "author"):
        # stochastic falloffs: one uniform draw per pixel and frame
        if mode == "weier":
            rate = sampling.weier_sample_rate(gdist, config.aperture,
                                              config.p_min)
        else:
            rate = sampling.author_sample_rate(gdist, config.aperture)
        pix = torch.arange(bh * w, dtype=torch.int64, device=dev) + y0 * w
        return rng.rnd(rng.pixel_seed(pix.reshape(bh, w), frame))[0] < rate
    # masked: the dither tables and the sparse floor index the block's own
    # rows, so a tile's y0 must be a multiple of 8
    return sampling.masked_sampling(bh, w, gdist, sal, config.aperture,
                                    config.extra_sample_rate)


def stage_sampling(scene, gbuf, gaze_px, state: FrameState,
                   config: RenderConfig):
    """Cache validation, saliency and the sample mask. Returns (mask,
    saliency, is_valid, fetched cache rows, gaze_target, ray_count)."""
    h, w = config.height, config.width
    is_valid, _, _, fetched = reproject.validate_cache(
        gbuf["reproject_u"], gbuf["reproject_v"], gbuf["position"],
        state.depth_cache, state.prev_camera.eye, w, h, config.cache_epsilon,
        history=state.history)
    if not config.temporal:
        is_valid = torch.zeros_like(is_valid)
    sal = saliency.compute_saliency(gbuf, gaze_px, bbox_diagonal(scene),
                                    config.saliency_block)
    mask = sample_mask(sal, gaze_px, state.frame, config)
    p = gbuf["position"]
    gy, gx = gaze_px
    gaze_target = torch.stack([p.x[gy, gx], p.y[gy, gx], p.z[gy, gx]])
    return mask, sal, is_valid, fetched, gaze_target, mask.sum()


def stage_compact(mask, config: RenderConfig):
    """Compaction in 16x16 tile order: each 256-ray block of the list is
    one compact screen tile. Returns (idx [budget] scanline pixel ids,
    active [budget], rank [H*W], gate [H*W] landed in the budget)."""
    h, w = config.height, config.width
    if not gbuffer_mod._can_swizzle(h, w):
        return sampling.compact_mask_rank(mask.reshape(-1), config.ray_budget)
    mask_sw = gbuffer_mod.swizzle_to_tiles(mask.reshape(-1), h, w)
    idx_sw, active, rank_sw, gate_sw = sampling.compact_mask_rank(
        mask_sw, config.ray_budget)
    # tile-major position -> scanline pixel id
    tw = w // 16
    ty = idx_sw // (tw * 256)
    r1 = idx_sw % (tw * 256)
    tx = r1 // 256
    r2 = r1 % 256
    idx = (ty * 16 + r2 // 16) * w + tx * 16 + r2 % 16
    rank = gbuffer_mod.unswizzle_from_tiles(rank_sw, h, w)
    gate = gbuffer_mod.unswizzle_from_tiles(gate_sw, h, w)
    return idx, active, rank, gate


def shade_front(camera: Camera, idx, fetched, is_valid, state: FrameState,
                config: RenderConfig, gaze_target, y0: int = 0):
    """The compacted front's rays, one per budget slot (pixel ids `idx`,
    the padding slots' too): (origins, dirs, seeds), jittered in the
    pixel and seeded from the global pixel id and, where history exists,
    the frame."""
    h, w = config.height, config.width
    gidx = idx + y0 * w
    py = (gidx // w).to(torch.float32)
    px = (gidx % w).to(torch.float32)
    hrows = fetched[idx].T                                 # [5, budget]
    vray = is_valid.reshape(-1)[idx] > 0.0
    hist_count = torch.where(vray, hrows[3], 0.0)

    # the seed depends on the frame only once history exists
    seed_frame = torch.where(hist_count > 0.0, state.frame, 0)
    seeds = rng.pixel_seed(gidx, seed_frame)
    j1, seeds = rng.rnd(seeds)
    j2, seeds = rng.rnd(seeds)
    ndc_x = (px + j1 - 0.5) / w * 2.0 - 1.0
    ndc_y = (py + j2 - 0.5) / h * 2.0 - 1.0
    _, dirs = camera.unproject_v(ndc_x, ndc_y, float(w) / float(h))
    origins = vec.splat(camera.eye, dirs.shape)
    if config.dof:
        u1, seeds = rng.rnd(seeds)
        u2, seeds = rng.rnd(seeds)
        focus = torch.linalg.vector_norm(gaze_target - camera.eye)
        origins, dirs = camera.thin_lens_perturb_v(dirs, focus,
                                                   config.lens_radius, u1, u2)
    return origins, dirs, seeds


def stage_shade(scene, camera: Camera, idx, active, fetched, is_valid,
                state: FrameState, config: RenderConfig, gaze_target, rank,
                gate, y0: int = 0):
    """Foveated path trace of the compacted rays and the temporal
    accumulate. Returns ((shading rgb, alpha), history [4,H,W],
    traced mask [H,W], rays_traced). A row-sharded tile passes its first
    row `y0` (its pixel ids `idx` are then local to its [bh, W] rows):
    seeds and jitter come from the global pixel ids, so every tiling
    traces the same rays."""
    bh, w = is_valid.shape
    c_history = reproject.history_from_fetch(fetched, is_valid)
    origins, dirs, seeds = shade_front(camera, idx, fetched, is_valid, state,
                                       config, gaze_target, y0)
    radiance, shade_aux = shade_mod.shade_v(scene, origins, dirs, seeds,
                                            config, active=active)
    tm = radiance.map(lambda c: colorx.uncharted2_tonemap(
        c, config.exposure_bias))

    # temporal accumulate as a gather through the inverse compaction map
    act = active.to(torch.float32)
    rows5 = torch.stack([tm.x * act, tm.y * act, tm.z * act, act, act],
                        dim=-1)                            # [B, 5]
    acc = sampling.expand_by_rank(rows5, rank.reshape(-1), gate.reshape(-1),
                                  idx, active).T           # [5, H*W]
    history = c_history + acc[:4].reshape(4, bh, w)
    traced_mask = acc[4].reshape(bh, w)
    cnt = history[3]
    inv = mathx.safe_inv_pos(cnt)
    shading_rgb = Vec3(history[0] * inv, history[1] * inv, history[2] * inv)
    shading_alpha = (cnt > 0.0).to(torch.float32)
    return (shading_rgb, shading_alpha), history, traced_mask, \
        shade_aux["rays_traced"]


def stage_reconstruct(shading_rgb: Vec3, shading_alpha, gbuf,
                      config: RenderConfig):
    """Pull-push, then A-Trous when the configuration asks for it.
    Returns (image rgb, image alpha)."""
    recon = config.reconstruction
    if recon == "none":
        return shading_rgb, shading_alpha
    if recon not in ("pullpush", "atrous"):
        raise ValueError(f"reconstruction {recon!r} is not in the reference")
    pp_rgb, pp_a = pullpush.pull_push_v(shading_rgb, shading_alpha)
    if recon == "pullpush":
        return pp_rgb, pp_a
    at = atrous.atrous_denoise_v(
        pp_rgb, gbuf["position"], gbuf["normal"], config.atrous_iterations,
        config.atrous_c_phi, config.atrous_n_phi, config.atrous_p_phi)
    return at, pp_a


def _keep(x):
    return x


def _quantized(gbuf: dict, quantize) -> dict:
    out = {}
    for k, v in gbuf.items():
        if isinstance(v, Vec3):
            out[k] = v.map(quantize)
        elif isinstance(v, torch.Tensor) and v.is_floating_point():
            out[k] = quantize(v)
        else:
            out[k] = v
    return out


def render_frame(scene, camera: Camera, gaze_px, state: FrameState,
                 config: RenderConfig, quantize=_keep):
    """Render one frame. gaze_px: (gy, gx) pixel coordinates.

    Returns (outputs, new_state). Outputs hold image_rgb / image_alpha
    (planar), gaze_target, ray_count, rays_dropped, rays_traced, and the
    stages' results the benchmark compares: the G-buffer planes (`gbuf`),
    the sample mask and the traced mask."""
    pin_fp32(camera.device)
    gaze_px = (int(gaze_px[0]), int(gaze_px[1]))
    gbuf = _quantized(stage_gbuffer(scene, camera, state.prev_camera,
                                    config), quantize)
    mask, sal, is_valid, fetched, gaze_target, ray_count = stage_sampling(
        scene, gbuf, gaze_px, state, config)
    idx, active, rank, gate = stage_compact(mask, config)
    (shading_rgb, shading_alpha), history, traced_mask, shade_rays = \
        stage_shade(scene, camera, idx, active, fetched, is_valid, state,
                    config, gaze_target, rank, gate)
    shading_rgb, history = shading_rgb.map(quantize), quantize(history)
    image_rgb, image_alpha = stage_reconstruct(shading_rgb, shading_alpha,
                                               gbuf, config)
    outputs = {
        "image_rgb": image_rgb.map(quantize),
        "image_alpha": image_alpha,
        "gaze_target": gaze_target,
        "ray_count": ray_count,
        "rays_dropped": ray_count - gate.sum(),
        "rays_traced": gbuf["rays_traced"] + shade_rays,
        "gbuf": gbuf,
        "mask": mask,
        "traced": traced_mask,
    }
    new_state = FrameState(history=history, depth_cache=gbuf["depth"],
                           prev_camera=camera, frame=state.frame + 1)
    return outputs, new_state
