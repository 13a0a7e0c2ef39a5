"""The dense inverse-rendering step, plain PyTorch: the mean square error
of a dense render against a target, its gradients with respect to the
parameters (autograd, summed over blocks of rows so that it fits), and
one Adam update written out.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Tuple

import torch

from reference import color as colorx
from reference import rng, vec
from reference.camera import Camera
from reference.config import RenderConfig, pin_fp32
from reference import shade as shade_mod


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
    #                               miss lookup (shade.envmap_lookup_v:
    #                               envmap.EnvmapLookup's adjoint)

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


def loss_and_grad(scene, camera: Camera, params: TrainParams, target,
                  frame: int, config: RenderConfig, block_rows: int,
                  quantize=None):
    """(loss, gradients as TrainParams): sum((img - target)^2) over the
    frame / (H * W * 3), rendered and differentiated `block_rows` rows at
    a time. `quantize` (the control) rounds each block's image before
    the loss."""
    pin_fp32(camera.device)
    h, w = config.height, config.width
    n = h * w * 3
    leaves = params.map(lambda t: t.detach().clone().requires_grad_(True))
    grads = [torch.zeros_like(p) for p in leaves.tensors()]
    loss = torch.zeros((), dtype=torch.float64, device=camera.device)
    for y0 in range(0, h, block_rows):
        bh = min(block_rows, h - y0)
        sc, cam = _apply_params(scene, camera, leaves)
        img = render_rows_dense(sc, cam, leaves, y0, bh, config, frame)
        if quantize is not None:
            img = quantize(img)
        local = torch.sum((img - target[y0:y0 + bh]) ** 2)
        gs = torch.autograd.grad(local / n, leaves.tensors(),
                                 allow_unused=True)
        for acc, g in zip(grads, gs):
            if g is not None:
                acc += g
        loss += local.detach().double()
    return (loss / n).float(), TrainParams(*grads)


@dataclasses.dataclass
class Adam:
    """torch.optim.Adam's update with its defaults (betas 0.9 / 0.999,
    eps 1e-8, no weight decay), written out."""

    lr: float
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    step: int = 0
    m: tuple = ()
    v: tuple = ()

    def update(self, params: TrainParams, grads: TrainParams) -> TrainParams:
        if not self.m:
            self.m = tuple(torch.zeros_like(p) for p in params.tensors())
            self.v = tuple(torch.zeros_like(p) for p in params.tensors())
        self.step += 1
        out, ms, vs = [], [], []
        for p, g, m, v in zip(params.tensors(), grads.tensors(), self.m,
                              self.v):
            m = self.b1 * m + (1.0 - self.b1) * g
            v = self.b2 * v + (1.0 - self.b2) * g * g
            c1 = 1.0 - self.b1 ** self.step
            c2 = math.sqrt(1.0 - self.b2 ** self.step)
            out.append(p - self.lr * (m / c1) / (v.sqrt() / c2 + self.eps))
            ms.append(m)
            vs.append(v)
        self.m, self.v = tuple(ms), tuple(vs)
        return TrainParams(*out)
