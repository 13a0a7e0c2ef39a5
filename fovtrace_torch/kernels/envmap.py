"""The environment map's bilinear lookup and its adjoint (counterpart of
the quad-table gather in `fovtrace/render/shade.py` `envmap_lookup_v`,
and of its gradient with respect to the map and to the texel
coordinates).

`EnvmapLookup.apply(fx, fy, envmap, scale)` reads, for each of N rays,
the four edge-clamped taps of the [H, W, 3] float32 map around the
continuous texel coordinates (fx, fy), blends them bilinearly, scales
them, and returns the [3, N] SoA block; its backward gives d fx, d fy
(`dxy`) and, when the map needs a gradient, sums the cotangent into the
map's texels, deterministically (`adjoint`). On CUDA tensors each
direction launches the hand-written kernels of `csrc/envmap.cu`; on CPU
tensors it runs the plain PyTorch versions (`lookup_plain`, `dxy_plain`,
`adjoint_plain`); any other device raises. The wrappers count their
launches and the plain versions their calls (`counters`), in
`kernels.CALLS` beside the cluster kernels'.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch
from torch.autograd.function import once_differentiable

from fovtrace_torch import _build, kernels
from fovtrace_torch.core import mathx

_CSRC = Path(__file__).resolve().parent.parent / "csrc" / "envmap.cu"

# bytes of adjoint scratch per map entry (texel channel): a 64-bit sum and
# a 32-bit max (csrc/envmap.cu `fov_envmap_adjoint`)
SCRATCH_BYTES = 12

COUNTED = ("envmap_lookup", "envmap_dxy", "envmap_adjoint",
           "envmap_lookup_plain", "envmap_dxy_plain", "envmap_adjoint_plain")


def c_signatures() -> dict:
    """{C entry point: (argtypes, restype)} of the envmap library."""
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    # the tensors' pointers, then n, h, w, scale and the stream
    return {"fov_envmap_lookup": ([p] * 4 + [i] * 3 + [f, p], i),
            "fov_envmap_dxy": ([p] * 6 + [i] * 3 + [f, p], i),
            "fov_envmap_adjoint": ([p] * 5 + [i] * 3 + [f, p], i)}


@functools.cache
def load_cuda_library() -> ctypes.CDLL:
    """The compiled envmap library (built at first use)."""
    from fovtrace_torch.kernels import cluster_isect as ci

    return _build.load_library("fovtrace_envmap", [_CSRC], ci._nvcc_command,
                               c_signatures())


def _check(fx: torch.Tensor, fy: torch.Tensor, h: int, w: int,
           **more: torch.Tensor) -> None:
    """Validate what the kernels (and their plain versions) take: [N]
    coordinates and the named tensors (the [H, W, 3] map, the [3, N]
    cotangent) of one float type, float32 (float64 too on the CPU, for
    gradcheck), contiguous, on one device, cpu or cuda; N and H x W
    below 2^31."""
    dev = fx.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"the envmap lookup runs on cpu or cuda, not {dev}")
    floats = (torch.float32, torch.float64) if dev.type == "cpu" else \
        (torch.float32,)
    named = {"fx": fx, "fy": fy, **more}
    for name, t in named.items():
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, fx on {dev}")
        if t.dtype not in floats or t.dtype != fx.dtype:
            raise TypeError(f"{name} must be torch.float32 like fx, got "
                            f"{t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    n = fx.shape[0]
    if fx.dim() != 1 or fy.shape != fx.shape:
        raise ValueError(f"fx and fy must be [N], got {tuple(fx.shape)} and "
                         f"{tuple(fy.shape)}")
    if "envmap" in more and (more["envmap"].dim() != 3
                             or more["envmap"].shape[2] != 3):
        raise ValueError(f"the envmap must be [H, W, 3], got "
                         f"{tuple(more['envmap'].shape)}")
    if "g" in more and tuple(more["g"].shape) != (3, n):
        raise ValueError(f"the cotangent must be [3, {n}], got "
                         f"{tuple(more['g'].shape)}")
    if h < 1 or w < 1 or h * w >= 2 ** 31 or n >= 2 ** 31:
        raise ValueError(f"the kernels take N and H x W below 2^31, got N "
                         f"{n}, H {h}, W {w}")


# ------------------------------------------------------- plain versions
def _fma(x, y, z):
    """mathx.fma in float32 (one rounding; addcmul on the card), x * y + z
    in float64 (gradcheck)."""
    if x.dtype == torch.float64:
        return x * y + z
    return mathx.fma(x, y, z)


def _taps(fx, fy, h, w):
    """(x0, x1, y0, y1, wx, wy): the edge-clamped taps around (fx, fy)
    and the bilinear weights, as render/shade.py computed them."""
    x0 = torch.clamp(torch.floor(fx).to(torch.int64), 0, w - 1)
    y0 = torch.clamp(torch.floor(fy).to(torch.int64), 0, h - 1)
    wx = fx - x0
    wy = fy - y0
    x1 = torch.clamp_max(x0 + 1, w - 1)
    y1 = torch.clamp_max(y0 + 1, h - 1)
    return x0, x1, y0, y1, wx, wy


def _corners(fx, fy, envmap):
    """(c00, c01, c10, c11 [N, 3], wx, wy) of the four taps."""
    h, w = envmap.shape[0], envmap.shape[1]
    x0, x1, y0, y1, wx, wy = _taps(fx, fy, h, w)
    flat = envmap.reshape(-1, 3)
    return (flat[y0 * w + x0], flat[y0 * w + x1], flat[y1 * w + x0],
            flat[y1 * w + x1], wx, wy)


def lookup_plain(fx, fy, envmap, scale: float) -> torch.Tensor:
    """[3, N]: the bilinear, edge-clamped lookup times `scale`, the
    render path's expression before the kernel."""
    kernels.CALLS["envmap_lookup_plain"] += 1
    c00, c01, c10, c11, wx, wy = _corners(fx, fy, envmap)

    def bilerp(k):
        top = _fma(c00[:, k], 1 - wx, c01[:, k] * wx)
        bottom = _fma(c10[:, k], 1 - wx, c11[:, k] * wx)
        return _fma(top, 1 - wy, bottom * wy)

    return torch.stack([bilerp(0), bilerp(1), bilerp(2)]) * scale


def dxy_plain(fx, fy, envmap, g, scale: float):
    """(d fx, d fy) [N]: the cotangent `g` [3, N] through the bilinear
    weights, in the kernel's op order, which is autograd's through the
    four-gather expression: per channel, with gs = g * scale, gt = gs *
    (1 - wy) and gb = gs * wy, the float32 products gb * c11, gb * c10,
    gt * c01, gt * c00 (d wx) and gs * bottom, gs * top (d wy), added
    with their signs one by one, channel 2 first."""
    kernels.CALLS["envmap_dxy_plain"] += 1
    c00, c01, c10, c11, wx, wy = _corners(fx, fy, envmap)
    dfx = dfy = None
    for k in (2, 1, 0):
        top = _fma(c00[:, k], 1 - wx, c01[:, k] * wx)
        bottom = _fma(c10[:, k], 1 - wx, c11[:, k] * wx)
        gs = g[k] * scale
        gt, gb = gs * (1 - wy), gs * wy
        dx = [gb * c11[:, k], -(gb * c10[:, k]), gt * c01[:, k],
              -(gt * c00[:, k])]
        dy = [gs * bottom, -(gs * top)]
        for t in dx:
            dfx = t if dfx is None else dfx + t
        for t in dy:
            dfy = t if dfy is None else dfy + t
    return dfx, dfy


def tap_terms(fx, fy, g, h: int, w: int, scale: float) -> list:
    """[(texel [N] int64, terms [3, N])] of the four taps, 00, 01, 10, 11:
    each ray's cotangent times its tap's weight, in the kernel's op
    order (g * scale, times 1 - wy or wy, times 1 - wx or wx)."""
    x0, x1, y0, y1, wx, wy = _taps(fx, fy, h, w)
    gs = g * scale
    gt, gb = gs * (1 - wy), gs * wy
    return [(y0 * w + x0, gt * (1 - wx)), (y0 * w + x1, gt * wx),
            (y1 * w + x0, gb * (1 - wx)), (y1 * w + x1, gb * wx)]


def adjoint_plain(fx, fy, g, h: int, w: int, scale: float) -> torch.Tensor:
    """[H, W, 3]: the four taps' terms summed into their texels, in
    float64, tap by tap and ray by ray on the CPU (deterministic there),
    then rounded to g's type."""
    kernels.CALLS["envmap_adjoint_plain"] += 1
    acc = torch.zeros(h * w * 3, dtype=torch.float64, device=g.device)
    chan = torch.arange(3, device=g.device)
    for texel, terms in tap_terms(fx, fy, g, h, w, scale):
        acc.index_add_(0, (texel[:, None] * 3 + chan).reshape(-1),
                       terms.T.reshape(-1).double())
    return acc.to(g.dtype).reshape(h, w, 3)


# ------------------------------------------------------------- wrappers
def _launch(name: str, tensors, ints, scale: float) -> None:
    """`kernels.launch` of the library's fov_`name` with n, h, w and the
    scale."""
    kernels.launch(load_cuda_library(), name, tensors, *ints, scale)


def lookup(fx, fy, envmap, scale: float) -> torch.Tensor:
    """[3, N]: the map's bilinear lookup at (fx, fy) times `scale`.
    Launches `envmap_lookup_kernel` on CUDA tensors, the plain version
    on CPU tensors."""
    h, w = envmap.shape[0], envmap.shape[1]
    _check(fx, fy, h, w, envmap=envmap)
    if fx.device.type == "cpu":
        return lookup_plain(fx, fy, envmap, scale)
    n = fx.shape[0]
    out = torch.empty((3, n), dtype=torch.float32, device=fx.device)
    if n:
        _launch("envmap_lookup", (fx, fy, envmap, out), (n, h, w), scale)
    return out


def dxy(fx, fy, envmap, g, scale: float):
    """(d fx, d fy) [N] of <lookup(fx, fy, envmap, scale), g>. Launches
    `envmap_dxy_kernel` on CUDA tensors, the plain version on CPU
    tensors."""
    h, w = envmap.shape[0], envmap.shape[1]
    _check(fx, fy, h, w, envmap=envmap, g=g)
    if fx.device.type == "cpu":
        return dxy_plain(fx, fy, envmap, g, scale)
    n = fx.shape[0]
    dfx, dfy = torch.empty_like(fx), torch.empty_like(fy)
    if n:
        _launch("envmap_dxy", (fx, fy, envmap, g, dfx, dfy), (n, h, w),
                scale)
    return dfx, dfy


def adjoint(fx, fy, g, h: int, w: int, scale: float) -> torch.Tensor:
    """[H, W, 3]: the gradient of <lookup(fx, fy, envmap, scale), g> with
    respect to the map, the same bits on every run. Launches the three
    adjoint kernels on CUDA tensors, the plain version on CPU tensors."""
    _check(fx, fy, h, w, g=g)
    if fx.device.type == "cpu":
        return adjoint_plain(fx, fy, g, h, w, scale)
    n = fx.shape[0]
    if not n:
        return torch.zeros((h, w, 3), dtype=torch.float32, device=fx.device)
    out = torch.empty((h, w, 3), dtype=torch.float32, device=fx.device)
    scratch = torch.empty((SCRATCH_BYTES * 3 * h * w,), dtype=torch.uint8,
                          device=fx.device)
    _launch("envmap_adjoint", (fx, fy, g, scratch, out), (n, h, w), scale)
    return out


class EnvmapLookup(torch.autograd.Function):
    """(fx [N], fy [N], envmap [H, W, 3], scale) -> [3, N], differentiable
    in fx, fy and the map. The forward saves only fx, fy and the map, so
    a recompute under torch.utils.checkpoint runs it again from
    scratch; the backward computes the map's gradient only when it is
    asked for."""

    @staticmethod
    def forward(ctx, fx, fy, envmap, scale):
        ctx.save_for_backward(fx, fy, envmap)
        ctx.scale = scale
        return lookup(fx, fy, envmap, scale)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        fx, fy, envmap = ctx.saved_tensors
        g = g.contiguous()
        dfx = dfy = denv = None
        if ctx.needs_input_grad[0] or ctx.needs_input_grad[1]:
            dfx, dfy = dxy(fx, fy, envmap, g, ctx.scale)
        if ctx.needs_input_grad[2]:
            denv = adjoint(fx, fy, g, envmap.shape[0], envmap.shape[1],
                           ctx.scale)
        return dfx, dfy, denv, None


def counters() -> dict:
    """The envmap kernels' launches and the plain versions' calls so
    far."""
    return {k: kernels.CALLS[k] for k in COUNTED}
