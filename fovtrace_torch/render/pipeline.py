"""Per-frame render pipeline (counterpart of `fovtrace/render/pipeline.py`).

  gbuffer      primary-ray G-buffer and shadow term   (render.gbuffer)
  sampling     cache validation, saliency, sample mask
  compact      the mask, compacted in 16x16 tile order into the static
               ray budget
  shade        wavefront path trace of the compacted rays + temporal
               accumulation                            (render.shade)
  reconstruct  JFA Voronoi fill and Sibson, or pull-push hole filling
               then A-Trous

Frame-to-frame state is an explicit `FrameState`. Counters come back as
device tensors; nothing in a frame waits for the device.
`render_frame_staged` (also `render.staged`'s, the reference's module)
runs the same frame with each stage timed (`app.profiler.StageTimer.stage`, named as the reference's report
columns GB, Sampling, Optimize, Shading, JFA, SI, PPI, AT).

Every frame opens the program's spans (`app.profiler.span`: fov.frame,
fov.gbuffer, fov.sampling{,.cache,.saliency,.mask}, fov.compact,
fov.shade with fov.shade.bounce<k>, fov.reconstruct{,.jfa,.sibson,
.pullpush,.atrous}), which are torch.profiler ranges while a profiler
runs and cost a flag check otherwise; a timer's stages enclose the
spans of the same stage.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, Tuple

import torch

from fovtrace_torch.app.profiler import span
from fovtrace_torch.config import RenderConfig, pin_fp32
from fovtrace_torch.core import color as colorx
from fovtrace_torch.core import mathx, reproject, rng, vec
from fovtrace_torch.core.camera import Camera
from fovtrace_torch.core.vec import Vec3
from fovtrace_torch.kernels import (atrous, jfa, pullpush, saliency,
                                    sampling, sibson)
from fovtrace_torch.render import gbuffer as gbuffer_mod
from fovtrace_torch.render import shade as shade_mod


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


def untimed(name: str):
    """The stage context of an untimed frame: it times nothing and waits
    for nothing."""
    return contextlib.nullcontext({})


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
    if mode == "logpolar":
        return sampling.logpolar_sampling(h, w, gaze_px, dev, row_offset=y0,
                                          block_h=bh)
    # masked: the dither tables and the sparse floor index the block's own
    # rows, so a tile's y0 must be a multiple of 8
    return sampling.masked_sampling(bh, w, gdist, sal, config.aperture,
                                    config.extra_sample_rate)


def stage_sampling(scene, gbuf, gaze_px, state: FrameState,
                   config: RenderConfig):
    """Cache validation, saliency and the sample mask. Returns (mask,
    saliency, is_valid, fetched cache rows, gaze_target, ray_count)."""
    h, w = config.height, config.width
    with span("fov.sampling.cache"):
        is_valid, _, _, fetched = reproject.validate_cache(
            gbuf["reproject_u"], gbuf["reproject_v"], gbuf["position"],
            state.depth_cache, state.prev_camera.eye, w, h,
            config.cache_epsilon, history=state.history)
        if not config.temporal:
            is_valid = torch.zeros_like(is_valid)
    with span("fov.sampling.saliency"):
        sal = saliency.compute_saliency(gbuf, gaze_px, bbox_diagonal(scene),
                                        config.saliency_block)
    with span("fov.sampling.mask"):
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
                      config: RenderConfig, stage=untimed):
    """JFA and Sibson, or pull-push then A-Trous, or all four (the image
    is then A-Trous'), or none. Returns (image rgb, image alpha, extras
    for the full outputs). Each filter runs in its `stage` context (JFA,
    SI, PPI, AT)."""
    recon = config.reconstruction
    extras: Dict[str, torch.Tensor] = {}
    if recon == "none":
        return shading_rgb, shading_alpha, extras
    out_rgb, out_a = shading_rgb, shading_alpha
    if recon in ("jfa", "sibson", "all"):
        sh_rows = torch.cat([vec.to_rows(shading_rgb),
                             shading_alpha[..., None]], dim=-1)
        with stage("JFA") as box, span("fov.reconstruct.jfa"):
            box["result"] = coord, jfa_color = jfa.jump_flood(sh_rows)
        extras["jfa"] = jfa_color
        out_rgb, out_a = vec.from_rows(jfa_color[..., :3]), jfa_color[..., 3]
        if recon in ("sibson", "all"):
            with stage("SI") as box, span("fov.reconstruct.sibson"):
                box["result"] = sib = sibson.sibson_interpolate(
                    coord, jfa_color, config.sibson_max_radius)
            extras["sibson"] = sib
            out_rgb, out_a = vec.from_rows(sib[..., :3]), sib[..., 3]
    if recon in ("pullpush", "atrous", "all"):
        with stage("PPI") as box, span("fov.reconstruct.pullpush"):
            box["result"] = pp_rgb, pp_a = pullpush.pull_push_v(
                shading_rgb, shading_alpha)
        if config.full_outputs:
            extras["pullpush"] = torch.cat([vec.to_rows(pp_rgb),
                                            pp_a[..., None]], dim=-1)
        out_rgb, out_a = pp_rgb, pp_a
        if recon in ("atrous", "all"):
            with stage("AT") as box, span("fov.reconstruct.atrous"):
                box["result"] = at = atrous.atrous_denoise_v(
                    pp_rgb, gbuf["position"], gbuf["normal"],
                    config.atrous_iterations, config.atrous_c_phi,
                    config.atrous_n_phi, config.atrous_p_phi)
            if config.full_outputs:
                extras["atrous"] = torch.cat([vec.to_rows(at),
                                              pp_a[..., None]], dim=-1)
            out_rgb, out_a = at, pp_a
    return out_rgb, out_a, extras


def render_frame(scene, camera: Camera, gaze_px, state: FrameState,
                 config: RenderConfig) -> Tuple[Dict[str, torch.Tensor],
                                                FrameState]:
    """Render one frame. gaze_px: (gy, gx) pixel coordinates.

    Returns (outputs, new_state). Outputs always hold image_rgb /
    image_alpha (planar), gaze_target, ray_count, rays_dropped (mask
    pixels that found no compaction slot) and rays_traced (primary +
    shadow + every wavefront ray); with config.full_outputs also the
    row-layout view buffers."""
    return render_frame_staged(scene, camera, gaze_px, state, config)


def render_frame_staged(scene, camera: Camera, gaze_px, state: FrameState,
                        config: RenderConfig, timer=None
                        ) -> Tuple[Dict[str, torch.Tensor], FrameState]:
    """render_frame with each stage (GB, Sampling, Optimize, Shading,
    then stage_reconstruct's) run in `timer.stage(name)`
    (`app.profiler.StageTimer`), which waits for the result the stage
    leaves in the context's dict under "result"; with no timer, nothing
    is timed or waited for. The outputs and new state are the same
    either way, and so are the program's spans (the module docstring),
    which open inside the timer's stage of the same name."""
    with span("fov.frame"):
        return _render_frame(scene, camera, gaze_px, state, config,
                             untimed if timer is None else timer.stage)


def _render_frame(scene, camera: Camera, gaze_px, state: FrameState,
                  config: RenderConfig, stage):
    pin_fp32(camera.device)
    gaze_px = (int(gaze_px[0]), int(gaze_px[1]))
    with stage("GB") as box, span("fov.gbuffer"):
        box["result"] = gbuf = stage_gbuffer(scene, camera,
                                             state.prev_camera, config)
    with stage("Sampling") as box, span("fov.sampling"):
        box["result"] = mask, sal, is_valid, fetched, gaze_target, \
            ray_count = stage_sampling(scene, gbuf, gaze_px, state, config)
    with stage("Optimize") as box, span("fov.compact"):
        box["result"] = idx, active, rank, gate = stage_compact(mask, config)
    with stage("Shading") as box, span("fov.shade"):
        box["result"] = (shading_rgb, shading_alpha), history, traced_mask, \
            shade_rays = stage_shade(scene, camera, idx, active, fetched,
                                     is_valid, state, config, gaze_target,
                                     rank, gate)
    with span("fov.reconstruct"):
        image_rgb, image_alpha, extras = stage_reconstruct(
            shading_rgb, shading_alpha, gbuf, config, stage)

    outputs: Dict[str, torch.Tensor] = {
        "image_rgb": image_rgb,
        "image_alpha": image_alpha,
        "gaze_target": gaze_target,
        "ray_count": ray_count,
        "rays_dropped": ray_count - gate.sum(),
        "rays_traced": gbuf["rays_traced"] + shade_rays,
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
    new_state = FrameState(history=history, depth_cache=gbuf["depth"],
                           prev_camera=camera, frame=state.frame + 1)
    return outputs, new_state


GRAD_PARAMS = ("emission", "kd", "eye", "target")


def grad_step(scene, camera: Camera, gaze_px, state: FrameState | None,
              config: RenderConfig):
    """One forward and backward pass of the bench's loss,
    vec.mean_reduce(image_rgb), with respect to the light's emission, the
    materials' kd and the camera's eye and target (GRAD_PARAMS).

    `state` is a constant: it is detached, so repeated steps neither keep
    nor reach an earlier frame's graph. With state None the frame starts
    from FrameState.initial of the differentiated camera, as the goldens'
    gradient fingerprints do. Returns (loss, {name: gradient}, outputs),
    all detached."""
    leaf = lambda t: t.detach().clone().requires_grad_(True)
    emission, kd = leaf(scene.light.emission), leaf(scene.materials.kd)
    eye, target = leaf(camera.eye), leaf(camera.target)
    s2 = scene.replace(light=scene.light.replace(emission=emission),
                       materials=scene.materials.replace(kd=kd))
    c2 = camera.replace(eye=eye, target=target)
    st = FrameState.initial(c2, config) if state is None else state.detach()
    out, _ = render_frame(s2, c2, gaze_px, st, config)
    loss = vec.mean_reduce(out["image_rgb"])
    loss.backward()
    grads = dict(zip(GRAD_PARAMS, (emission.grad, kd.grad, eye.grad,
                                   target.grad)))
    out = {k: v.map(torch.Tensor.detach) if isinstance(v, Vec3)
           else v.detach() for k, v in out.items()}
    return loss.detach(), grads, out


def render_sequence(scene, cameras, gazes, config: RenderConfig,
                    state: FrameState | None = None):
    """Render a camera/gaze trajectory; returns ([H,W,3] images, state)."""
    if state is None:
        state = FrameState.initial(cameras[0], config)
    frames = []
    for cam, gaze in zip(cameras, gazes):
        out, state = render_frame(scene, cam, gaze, state, config)
        frames.append(vec.to_rows(out["image_rgb"]))
    return frames, state
