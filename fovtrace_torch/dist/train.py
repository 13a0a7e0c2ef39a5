"""The inverse-rendering train step over the row tiles (counterpart of
`fovtrace/dist/train.py`).

Every rank holds the same parameters (camera pose, gaze, light, albedos,
envmap) and renders its block of the screen's rows. The loss is the mean
square error over the whole frame, the sum of every rank's share; each
rank's gradients are summed over the ranks before the optimizer step, so
the parameters stay identical on every rank. The cluster intersection
kernels run in every bounce of every step; no gradient reaches them (the
hit is re-derived with autograd ops, kernels/intersect.py).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Tuple

import torch

from fovtrace_torch.config import RenderConfig, pin_fp32
from fovtrace_torch.core import color as colorx
from fovtrace_torch.core import rng, vec
from fovtrace_torch.core.camera import Camera
from fovtrace_torch.dist import collectives as coll
from fovtrace_torch.dist.collectives import Mesh
from fovtrace_torch.kernels import pullpush, sampling
from fovtrace_torch.render import shade as shade_mod


@dataclasses.dataclass(frozen=True)
class TrainParams:
    """The differentiable parameters."""

    eye: torch.Tensor             # [3] camera position
    target: torch.Tensor          # [3] camera look-at
    gaze_uv: torch.Tensor         # [2] gaze position in [0, 1]^2
    light_emission: torch.Tensor  # [3]
    kd: torch.Tensor              # [M, 3] material albedos
    envmap: torch.Tensor          # [He, We, 3] lat-long radiance; its
    #                               gradient flows through the bilinear
    #                               miss lookup (shade.envmap_lookup_v)

    def tensors(self) -> Tuple[torch.Tensor, ...]:
        return tuple(getattr(self, f.name) for f in dataclasses.fields(self))

    def replace(self, **kw) -> "TrainParams":
        return dataclasses.replace(self, **kw)

    def map(self, fn: Callable) -> "TrainParams":
        return TrainParams(*(fn(t) for t in self.tensors()))


def init_params(scene, camera: Camera) -> TrainParams:
    return TrainParams(
        eye=camera.eye,
        target=camera.target,
        gaze_uv=torch.tensor([0.5, 0.5], dtype=torch.float32,
                             device=camera.device),
        light_emission=scene.light.emission,
        kd=scene.materials.kd,
        envmap=scene.envmap,
    )


def leaves(params: TrainParams) -> TrainParams:
    """Fresh copies of the parameters that autograd and an optimizer
    update (leaf tensors with requires_grad)."""
    return params.map(lambda t: t.detach().clone().requires_grad_(True))


def _apply_params(scene, camera: Camera, params: TrainParams):
    cam = camera.replace(eye=params.eye, target=params.target)
    sc = scene.replace(
        light=scene.light.replace(emission=params.light_emission),
        materials=scene.materials.replace(kd=params.kd),
        envmap=params.envmap,
    )
    return sc, cam


def render_rows_dense(scene, camera: Camera, params: TrainParams, y0: int,
                      block_h: int, config: RenderConfig, frame):
    """Every pixel of rows [y0, y0 + block_h), traced (the loss needs
    every pixel): [block_h, W, 3] tonemapped radiance, a function of the
    parameters that `scene` and `camera` carry (_apply_params)."""
    h, w = config.height, config.width
    _, rd = camera.primary_rays_block(w, h, y0, block_h)
    rd = vec.from_rows(rd.reshape(-1, 3))
    ro = vec.splat(camera.eye, rd.shape)
    pix = torch.arange(block_h * w, dtype=torch.int64,
                       device=camera.device) + y0 * w
    seeds = rng.pixel_seed(pix, torch.as_tensor(frame, device=pix.device))
    radiance, _ = shade_mod.shade_v(scene, ro, rd, seeds, config)
    img = colorx.uncharted2_tonemap(vec.to_rows(radiance),
                                    config.exposure_bias)
    return img.reshape(block_h, w, 3)


def render_rows_foveated(scene, camera: Camera, params: TrainParams,
                         y0: int, block_h: int, config: RenderConfig, frame,
                         soft: bool = False):
    """The foveated render of rows [y0, y0 + block_h), differentiable in
    the gaze: params.gaze_uv drives a Weier sampling-rate falloff, and
    the sampled radiance is reconstructed by the alpha-weighted pull-push
    pyramid. The gradient reaches gaze_uv through the sample weights:

      soft=True   the expected reconstruction, rate * img + (1 - rate) *
                  blur(img): a hole takes its neighbours' mean, a sample
                  keeps its value. Smooth in the gaze.
      soft=False  one Bernoulli mask and the real pull-push, with a
                  straight-through alpha (its value is the hard mask, its
                  gradient the rate's): the estimator of the soft loss.

    Returns [block_h, W, 3] reconstructed rows."""
    h, w = config.height, config.width
    img = render_rows_dense(scene, camera, params, y0, block_h, config,
                            frame)
    gaze = (params.gaze_uv[1] * (h - 1), params.gaze_uv[0] * (w - 1))
    gdist = sampling.gaze_distance(h, w, gaze, camera.device,
                                   row_offset=y0, block_h=block_h)
    rate = sampling.weier_sample_rate(gdist, config.aperture, config.p_min)
    rgb = vec.from_rows(img)
    if soft:
        blur_rgb, _ = pullpush._blur3_v(rgb, torch.ones_like(rate))
        out = rgb * rate + blur_rgb * (1.0 - rate)
    else:
        gidx = (torch.arange(block_h * w, dtype=torch.int64,
                             device=camera.device) + y0 * w
                ).reshape(block_h, w)
        u01 = rng.rnd(rng.pixel_seed(
            gidx, torch.as_tensor(frame, device=gidx.device) + 7919))[0]
        hard = (u01 < rate).to(torch.float32)
        alpha = hard + rate - rate.detach()     # straight through
        # rgb is not premultiplied: the pull averages rgb * alpha over
        # alpha, the push gates its taps by alpha
        out, _ = pullpush.pull_push_v(rgb, alpha)
    return vec.to_rows(out)


def make_loss_and_grad(scene, camera: Camera, config: RenderConfig,
                       mesh: Mesh, foveated: bool = False,
                       soft_mask: bool = False):
    """(params, target_rows [bh, W, 3] of this rank, frame) -> (loss,
    gradients as TrainParams), both summed over the ranks: the loss is
    sum((img - target)^2) over the frame / (H * W * 3)."""
    assert config.height % mesh.size == 0, "the height must divide the ranks"
    block_h = config.height // mesh.size
    y0 = mesh.rank * block_h
    n = config.height * config.width * 3

    def loss_and_grad(params: TrainParams, target_rows, frame):
        pin_fp32(mesh.device)
        sc, cam = _apply_params(scene, camera, params)
        if foveated:
            img = render_rows_foveated(sc, cam, params, y0, block_h, config,
                                       frame, soft=soft_mask)
        else:
            img = render_rows_dense(sc, cam, params, y0, block_h, config,
                                    frame)
        local = torch.sum((img - target_rows) ** 2)
        grads = torch.autograd.grad(local / n, params.tensors(),
                                    allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(params.tensors(), grads)]
        # one collective for the loss and every gradient
        flat = coll.all_reduce_sum(torch.cat(
            [local.detach().reshape(1)] + [g.reshape(-1) for g in grads]),
            mesh)
        parts = flat[1:].split([g.numel() for g in grads])
        return flat[0] / n, TrainParams(*(v.view_as(g)
                                          for v, g in zip(parts, grads)))

    return loss_and_grad


def make_optimizer(params: TrainParams, lr: float = 1e-2
                   ) -> torch.optim.Optimizer:
    """Adam over the parameter leaves, as `optax.adam(lr)`."""
    return torch.optim.Adam(params.tensors(), lr=lr)


def make_train_step(scene, camera: Camera, config: RenderConfig,
                    mesh: Mesh, foveated: bool = False,
                    soft_mask: bool = False):
    """(params (leaves), optimizer, target_rows, frame) -> loss: one
    step that updates `params` in place. foveated=True renders
    render_rows_foveated (the gradient reaches params.gaze_uv);
    soft_mask picks its smooth expected-coverage estimator."""
    loss_and_grad = make_loss_and_grad(scene, camera, config, mesh,
                                       foveated, soft_mask)

    def train_step(params: TrainParams, optimizer, target_rows, frame):
        loss, grads = loss_and_grad(params, target_rows, frame)
        for p, g in zip(params.tensors(), grads.tensors()):
            p.grad = g
        optimizer.step()
        return loss

    return train_step


def broadcast_params(params: TrainParams, mesh: Mesh) -> None:
    """Rank 0's parameters on every rank (in place)."""
    coll.broadcast_(params.tensors(), mesh)
