"""The closest-hit kernel's cost per live cluster, in parts (counterpart
of `scripts/microbench_inner.py`).

    python -m fovtrace_torch.scripts.microbench_inner [--device cuda]

Six kernels walk the same flat schedule of earth's primary rays and each
does one part of the closest-hit kernel's work per (ray block, live
cluster) step, with no front-to-back break:

  loop     the schedule walk alone: the sum of the cluster ids
  slab     the walk and the per-ray slab test against the cluster's AABB
  mm_lane  the walk and the dot products of each ray with the cluster's
           4c coefficient columns, cluster-strided [16, NC*4c] layout
  mm_lead  the same from the cluster-contiguous [NC, 16, 4c] layout
  mm_bf16  mm_lead with rays and coefficients in bf16
  full     slab cull, float32 dot products and the Moller-Trumbore
           epilogue: the closest t

The script read an older pack and schedule (a flat [NB*NC] id schedule,
[N, 16] ray rows, a [16, NC*4c] pack) that the JAX package no longer
builds. `build_inputs` makes those layouts from today's pack and
schedule: 2048x1024 primary rays (2,097,152) of the camera at eye
(3, 2.5, 4) -> target (0, 0.8, 0) in 16x16 tile order. `plain` is each
variant's plain PyTorch version, stepping over schedule slots and
vectorised over ray blocks; `run_variant` launches the CUDA kernel
(csrc/probes.cu: persistent CTAs on a ticket, a producer warp feeding a
TMA ring; mm_bf16 on the tensor cores) on a CUDA tensor and runs the
plain version on a CPU tensor.

Each body's inner-loop instruction mix per (ray, triangle) pair:
`python -m fovtrace_torch.scripts.sass_mix` on the built probe library.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
import time

import torch

from fovtrace_torch import kernels
from fovtrace_torch.config import pin_fp32
from fovtrace_torch.core.camera import Camera
from fovtrace_torch.kernels import cluster_isect as ci
from fovtrace_torch.kernels.intersect import BIG_T, DET_EPS
from fovtrace_torch.render import gbuffer
from fovtrace_torch.scripts import (MICRO_VARIANTS, block_order,
                                    check_aligned, check_tensors, launched,
                                    load_probe_library)

RB = ci.RAY_BLOCK
NAMES = {"loop": "loop overhead only",
         "slab": "loop + slab",
         "mm_lane": "loop + matmul lane-slice f32",
         "mm_lead": "loop + matmul 3-D leading-dim f32",
         "mm_bf16": "loop + matmul 3-D leading-dim bf16",
         "full": "loop + slab + matmul3D f32 + epilogue"}


@dataclasses.dataclass
class MicroInputs:
    """The script's inputs. Row i of `sched` holds all NC cluster ids of
    ray block i, its counts[i] live ones first, front to back."""

    rays: torch.Tensor       # [N, 16] f32 ray rows (pack_raysT's rows)
    sched: torch.Tensor      # [NB * NC] i32 cluster ids
    counts: torch.Tensor     # [NB] i32 live clusters per block
    cb_flat: torch.Tensor    # [NC * 8] f32 cluster AABBs
    coef_lane: torch.Tensor  # [16, NC * 4c] f32
    coef_lead: torch.Tensor  # [NC, 16, 4c] f32, the port's pack
    coef_bf16: torch.Tensor  # [NC, 16, 4c] bf16

    @property
    def nb(self) -> int:
        return self.counts.shape[0]

    @property
    def nc(self) -> int:
        return self.cb_flat.shape[0] // 8

    @property
    def c(self) -> int:
        return self.coef_lead.shape[2] // 4

    def coef(self, variant: str):
        """The coefficient layout `variant` reads (None: none)."""
        return {"mm_lane": self.coef_lane, "mm_lead": self.coef_lead,
                "mm_bf16": self.coef_bf16,
                "full": self.coef_lead}.get(variant)

    def args(self, variant: str) -> tuple:
        return (self.rays, self.sched, self.counts, self.cb_flat,
                self.coef(variant))


def build_inputs(scene, width: int = 2048, height: int = 1024) -> MicroInputs:
    """The script's inputs from today's pack and schedule, on the
    scene's device: the camera's width x height primary rays in 16x16
    tile order, the id field of `cluster_schedule`'s rows (a flat
    schedule needs M == 1, as earth has), and the pack in the three
    coefficient layouts."""
    dev = scene.cluster_aabb.device
    coef, clusters = scene.isect_coef, scene.cluster_aabb
    nc = clusters.shape[0]
    if ci.pick_members(nc) != 1:
        raise ValueError(f"{nc} clusters schedule as superclusters; the "
                         "microbenchmark takes a flat schedule (M == 1)")
    cam = Camera.create(eye=(3.0, 2.5, 4.0), target=(0.0, 0.8, 0.0),
                        device=dev)
    ro, rd = cam.primary_rays_v(width, height)
    swz = lambda a: gbuffer.swizzle_to_tiles(a.reshape(-1), height, width)
    raysT, _ = ci.pack_raysT(ro.map(swz), rd.map(swz), 1e-3, BIG_T)
    schedmask, counts, _ = ci.cluster_schedule(raysT, clusters)
    return MicroInputs(
        rays=raysT.permute(0, 2, 1).reshape(-1, 16).contiguous(),
        sched=(schedmask[:, :nc] & 0xFFFF).reshape(-1).contiguous(),
        counts=counts,
        cb_flat=clusters.reshape(-1).contiguous(),
        coef_lane=coef.permute(1, 0, 2).reshape(16, -1).contiguous(),
        coef_lead=coef,
        coef_bf16=coef.to(torch.bfloat16))


# ------------------------------------------------------- plain versions
def ray_slab(rb, box, upper):
    """The per-ray slab test (the script's `pi._ray_slab`): rays rb
    [B, 256, 16] against boxes [B, 8], upper [B, 256] -> [B, 256] bool,
    the ray enters the box before `upper` and before it leaves."""
    lo = (box[:, None, 0:3] - rb[..., 0:3]) * rb[..., 12:15]
    hi = (box[:, None, 3:6] - rb[..., 0:3]) * rb[..., 12:15]
    near, far = torch.minimum(lo, hi), torch.maximum(lo, hi)
    tenter = torch.maximum(torch.maximum(near[..., 0], near[..., 1]),
                           torch.maximum(near[..., 2], rb[..., 10]))
    texit = torch.minimum(torch.minimum(far[..., 0], far[..., 1]),
                          torch.minimum(far[..., 2], upper))
    return tenter <= texit


def full_t(res, c: int):
    """k_full's epilogue on [B, 256, 4c] products: t on a hit past 1e-3,
    else 1e30 ([B, 256, c])."""
    t_num, det, u_num, v_num = res.split(c, dim=2)
    ud = u_num * det
    vd = v_num * det
    big = det.abs() > DET_EPS
    ok = big & (ud >= 0.0) & (vd >= 0.0) & (ud + vd <= det * det)
    t = t_num / torch.where(big, det, 1.0)
    return torch.where(ok & (t > 1e-3), t, BIG_T)


def plain(variant, rays, sched, counts, cb_flat, coef=None, stats=None):
    """Plain PyTorch version of `variant`: [N, 1] f32. Steps over the
    schedule slots; at slot l every block with more than l entries takes
    its l-th cluster. The dot products contract all 16 rows, as the
    script does. `stats`, a dict, receives "steps": the (block, entry)
    steps that ran the dot products (full: those the slab vote let
    through)."""
    kernels.CALLS["micro_plain"] += 1
    dev = rays.device
    pin_fp32(dev)
    nb = counts.shape[0]
    nc = cb_flat.shape[0] // 8
    rb = rays.view(nb, RB, 16)
    row = sched.view(nb, nc)
    boxes = cb_flat.view(nc, 8)
    val = torch.full((nb, RB), 0.0 if variant == "loop" else BIG_T,
                     dtype=torch.float32, device=dev)
    if variant == "mm_lane":
        c4 = coef.shape[1] // nc
        slab = lambda jc: coef.view(16, nc, c4)[:, jc].permute(1, 0, 2)
    elif variant == "mm_bf16":
        c4 = coef.shape[2]
        slab = lambda jc: coef[jc].float()
        rb = rb.to(torch.bfloat16).float()
    elif coef is not None:
        c4 = coef.shape[2]
        slab = lambda jc: coef[jc]
    steps = 0
    n_slots = int(counts.max()) if nb else 0
    for l in range(n_slots):
        b = torch.nonzero(counts > l).squeeze(1)
        jc = row[b, l].long()
        if variant == "loop":
            val[b] = val[b] + jc.to(torch.float32)[:, None]
        elif variant == "slab":
            vote = ray_slab(rb[b], boxes[jc], val[b]).any(dim=1)
            val[b] = torch.where(vote[:, None], val[b] * 0.5, val[b])
        else:
            chunk = max(1, ci._PLAIN_CHUNK_BYTES // (RB * c4 * 4))
            for bb, jj in zip(b.split(chunk), jc.split(chunk)):
                if variant == "full":
                    vote = ray_slab(rb[bb], boxes[jj], val[bb]).any(dim=1)
                    bb, jj = bb[vote], jj[vote]
                res = torch.bmm(rb[bb], slab(jj))             # [B,256,4c]
                t = full_t(res, c4 // 4) if variant == "full" else res
                val[bb] = torch.minimum(val[bb], t.amin(dim=2))
                steps += bb.shape[0]
    if stats is not None:
        stats["steps"] = steps
    return val.reshape(-1, 1)


# ------------------------------------------------------- kernel wrapper
def _check(variant, rays, sched, counts, cb_flat, coef):
    """Validate the inputs of `variant`; returns (nb, nc, c)."""
    if variant not in MICRO_VARIANTS:
        raise ValueError(f"variant must be one of {MICRO_VARIANTS}")
    want = [(rays, torch.float32, "rays"), (sched, torch.int32, "sched"),
            (counts, torch.int32, "counts"),
            (cb_flat, torch.float32, "cb_flat")]
    if variant in ("loop", "slab"):
        if coef is not None:
            raise ValueError(f"{variant} reads no coefficients")
    else:
        if coef is None:
            raise ValueError(f"{variant} needs coefficients")
        want.append((coef, torch.bfloat16 if variant == "mm_bf16"
                     else torch.float32, "coef"))
    check_tensors(want, rays.device)
    nb = counts.shape[0]
    if cb_flat.dim() != 1 or cb_flat.shape[0] % 8:
        raise ValueError("cb_flat must be [NC * 8]")
    nc = cb_flat.shape[0] // 8
    if tuple(rays.shape) != (nb * RB, 16) or counts.dim() != 1:
        raise ValueError(f"rays must be [NB * {RB}, 16] and counts [NB]")
    if tuple(sched.shape) != (nb * nc,):
        raise ValueError(f"sched must be [NB * NC] = [{nb * nc}]")
    c = 0
    if variant == "mm_lane":
        if coef.dim() != 2 or coef.shape[0] != 16 or \
                coef.shape[1] % (4 * nc):
            raise ValueError(f"mm_lane's coef must be [16, NC * 4c], got "
                             f"{tuple(coef.shape)}")
        c = coef.shape[1] // (4 * nc)
    elif coef is not None:
        if coef.dim() != 3 or coef.shape[:2] != (nc, 16) or coef.shape[2] % 4:
            raise ValueError(f"{variant}'s coef must be [NC, 16, 4c], got "
                             f"{tuple(coef.shape)}")
        c = coef.shape[2] // 4
    return nb, nc, c


def grid(variant: str, nb: int, c: int) -> int:
    """The persistent grid micro_kernel<variant> takes for nb ray blocks
    of cluster width c on the current card (as many CTAs as fit, at most
    nb)."""
    n = load_probe_library().fov_micro_ctas(MICRO_VARIANTS.index(variant),
                                            nb, c)
    if n < 0:
        raise RuntimeError(f"micro_{variant}: CUDA error {-n} sizing the "
                           "grid")
    return n


def run_variant(variant, rays, sched, counts, cb_flat, coef=None):
    """Variant `variant` of the microbenchmark: [N, 1] f32. On a CUDA
    tensor it launches micro_kernel<variant> (csrc/probes.cu) on the
    persistent grid (or `forced_grid`'s), on a CPU tensor it runs
    `plain`; any other device raises. Every count must be at most NC; the
    kernel takes c a multiple of 16 and 16-byte aligned rays, AABBs and
    coefficients."""
    nb, nc, c = _check(variant, rays, sched, counts, cb_flat, coef)
    if rays.device.type == "cpu":
        return plain(variant, rays, sched, counts, cb_flat, coef)
    if c % 16:
        raise ValueError(f"the kernel takes c a multiple of 16, got {c}")
    check_aligned([(rays, "rays"), (cb_flat, "cb_flat")]
                  + ([(coef, "coef")] if coef is not None else []))
    out = torch.empty((nb * RB, 1), dtype=torch.float32, device=rays.device)
    if nb:
        _launch(variant, rays, sched, counts, cb_flat, coef, out, nc, c)
    return out


def _launch(variant, rays, sched, counts, cb_flat, coef, out, nc, c):
    """Launch micro_kernel<variant> on the current stream, its ray blocks
    in `block_order` (longest first by default; no order passed for
    ascending) through a zeroed ticket; count the launch."""
    order, ctas = block_order(counts)
    ticket = torch.zeros(1, dtype=torch.int32, device=rays.device)
    launched(getattr(load_probe_library(), f"fov_micro_{variant}"),
             rays.data_ptr(), sched.data_ptr(), counts.data_ptr(),
             cb_flat.data_ptr(), None if coef is None else coef.data_ptr(),
             None if order is None else order.data_ptr(),
             ticket.data_ptr(), out.data_ptr(),
             counts.shape[0], nc, c, ctas, name=f"micro_{variant}",
             dev=rays.device)


def mean_ms(fn, dev, iters: int, warmup: int = 1) -> float:
    """Mean ms per call of `fn`: CUDA events around `iters` calls on a
    CUDA device, the host clock on the CPU."""
    for _ in range(warmup):
        fn()
    if dev.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        return (time.perf_counter() - t0) / iters * 1e3
    torch.cuda.synchronize(dev)
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(iters):
        fn()
    t1.record()
    torch.cuda.synchronize(dev)
    return t0.elapsed_time(t1) / iters


def main(argv=None) -> int:
    from fovtrace_torch.scene import procedural

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default="cuda")
    p.add_argument("--width", type=int, default=2048)
    p.add_argument("--height", type=int, default=1024)
    p.add_argument("--iters", type=int, default=10)
    args = p.parse_args(argv)
    dev = torch.device(args.device)
    inp = build_inputs(procedural.earth_scene(dev), args.width, args.height)
    live = int(inp.counts.sum())
    print(f"[micro] nb={inp.nb} nc={inp.nc} c={inp.c} live={live}",
          file=sys.stderr)
    for v in MICRO_VARIANTS:
        ms = mean_ms(lambda: run_variant(v, *inp.args(v)), dev,
                     iters=args.iters, warmup=3)
        where = (f"{grid(v, inp.nb, inp.c)} CTAs" if dev.type == "cuda"
                 else dev.type)
        print(f"[micro] {NAMES[v]:44s} {ms:9.2f} ms  "
              f"{ms * 1e6 / max(live, 1):8.2f} ns per live step  "
              f"[{where}]", file=sys.stderr, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
