"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each prints its own lines and its wall time; any failure exits
non-zero):
  card           require CUDA; print the card's name and power limit
  build          compile the CUDA kernels from fovtrace_torch/csrc (four
                 libraries, one nvcc each, in parallel); each kernel's
                 registers and spills from the log kept beside its
                 library, whichever process built it (none allowed in
                 the render path's four cluster kernel builds)
  kernels earth  the resident kernels against their plain PyTorch
                 versions (earth: 4,096 seeded random rays, the primary
                 rays and the G-buffer shadow rays of a 256x256 frame);
                 on each set, and on blocks that alternate near and far
                 hits, the persistent grid forced to 1 CTA, 3 CTAs and
                 the full grid, the ray blocks taken longest first and
                 in ascending order, gives the default launch's results
                 and work counts bit for bit (on one CTA, a bound of an
                 earlier block must not end the next block's walk)
  kernels forced-stream
                 earth forced onto the streaming route (M = 1): closest
                 hit bit for bit the resident kernel's, occlusion bit for
                 bit or within 1e-6 (the order of a transparent member's
                 Fresnel product); multi forced to M = 16
                 (MAX_SCHED = 4, repacked) against the plain versions
  city build     host build of the 170k-triangle city scene and its route
  kernels city   the streaming kernels against their plain versions on
                 city (the same three ray sets); every ray block split
                 over 8 CTAs gives the same ids and t, and occlusion
                 within 1e-6
  main earth     the CLI's render path on earth at 1920x1088 with the
                 bench configuration, 3 frames of the circle gaze; counts
                 kernel launches and plain/brute calls during that run
                 (the material gather and the envmap lookup launched,
                 neither backward)
  main city      the same on city, through the streaming kernels
  profile        per-stage times (render.staged: a synchronise after each
                 stage, the reference's report names GB, Sampling,
                 Optimize, Shading, PPI, AT) and a torch.profiler summary
                 of one frame of each scene
  timing         each kernel, its plain version and its bound at the
                 main path's shapes: the 1920x1088 G-buffer and the
                 bounce-0 front of the earth (resident) and city
                 (streaming) frames, with the pairs the warps computed,
                 the bound of those pairs, and histograms of the member
                 clusters tested per block and computed per ray; the
                 resident pair's persistent grid, its time with the ray
                 blocks in ascending order, the wrapper's device time
                 beside the kernel (profiled), and its inputs through
                 the streaming kernels (bit for bit the same results);
                 the streaming kernels without the heavy-block split,
                 with and without the split CTAs in the grid (what the
                 CTAs that return at once cost); then each kernel's
                 launches x (kernel - bound), the order of the redesign
  probe micro    the six microbenchmark kernels (csrc/probes.cu) against
                 their plain versions at the script's 2,097,152 earth
                 primary rays (loop and slab bit for bit), and on forced
                 grids of 1 and 2 CTAs in both orders bit for bit the
                 default grid's; each one's time, bound, share of the
                 bound, ns per live (block, entry) step and per step past
                 the cull and persistent grid, beside closest_kernel's ns
                 per visited cluster on the earth G-buffer; each body's
                 inner-loop instruction mix from the probe library's SASS
                 (mm_bf16 must issue HMMA)
  probe dma      the schedule-row copy probe at the script's size against
                 its numpy check and the plain version, then at the city
                 G-buffer's schedule (8,160 blocks, SW 768) against the
                 plain version, timed against its bytes bound with the
                 bytes it copies and the table bytes it reads from L2;
                 both on forced grids too; then a table too large for a
                 shared-memory slice (the global-memory path)
  main earth fwd+bwd
                 bench.py's default step (pipeline.grad_step: the gradient
                 of the mean image with respect to emission, kd, eye and
                 target) on earth at 1920x1088, one warm and 3 timed steps:
                 ms/step, Mrays/s (the forward's rays_traced), peak memory,
                 gradient norms (finite, nonzero), launches per step (the
                 material gather and adjoint among them), the camera
                 inverse's host round trips per step; then a torch.profiler
                 summary of one step (forward and backward device time,
                 busy share, the costliest backward functions, each tied
                 to the forward source line that made its autograd node,
                 and IndexBackward0 by forward source: none may come from
                 material_lookup_v or render/shade.py); the envmap's
                 d(fx, fy) launched, its adjoint not (no envmap trained)
  main earth fwd+bwd remat
                 the same with remat_shade: peak memory beside the run
                 without, one more closest-hit and occlusion launch per
                 bounce (and two more material gathers), gradients within
                 rtol 1e-4
  main city fwd+bwd
                 the fwd+bwd step on city through the streaming kernels
  material       the material table's gather and adjoint (csrc/material.cu)
                 against their plain versions at the CPU tests' shapes
                 (4,096 rays, K 21 and 4, M 4 and 24, one material, most
                 lanes misses) and the seeded 1920x1088 front, then at the
                 three lookups of an earth bench frame (the G-buffer's,
                 bounce 0's surface and shade): the gather bit for bit,
                 the adjoint within 1e-5 x sum |g| of each entry's lanes
                 and equal on two runs; at the frame's shapes each
                 kernel's time beside its plain version's, its bytes
                 bound, and the library calls (index_select, index_add_,
                 the aten gather's backward)
  envmap         the envmap's lookup, d(fx, fy) and adjoint
                 (csrc/envmap.cu) against their plain versions at the CPU
                 tests' maps and directions (8x16, 64x128, 5x7; poles,
                 seam, zero, NaN and inf directions), the seeded worst
                 cases at the 1920x1088 front (every ray in one texel,
                 uniform rays, 70% zero cotangent) and an 800x1600 map,
                 then the lookups of one earth bench frame and the
                 adjoints of one dense train step (its real cotangents):
                 the lookup and d(fx, fy) bit for bit, the adjoint within
                 1e-5 x sum |g w| of each entry's terms and equal on two
                 runs; at the bench frame's and the train step's bounce 0
                 each kernel's time beside its plain version's, its bytes
                 bound and the library calls (grid_sample and its
                 backward's d grid and d input, index_add_ of the four
                 taps, the four gathers' IndexBackward0), each kernel and
                 library call again queued behind a spin (device time
                 alone), and the host's ms for one lookup's forward and
                 backward through EnvmapLookup and through the expression
                 it replaced
  bench          `python -m fovtrace_torch.bench`'s run (bench.py's twin),
                 in this process at 1920x1088, --iters 5 --warmup 1: earth
                 fwd+bwd --selfcheck, earth --forward-only and city
                 --forward-only --selfcheck; each JSON line has bench.py's
                 four keys and a finite positive value, no ray dropped,
                 the selfcheck above 0.999, and the timed steps launched
                 the route's cluster kernels (resident on earth, streaming
                 on city), the envmap lookup (and, fwd+bwd, its d(fx, fy)),
                 no envmap adjoint, and no plain version or brute oracle
  parity         256x256 frames with the kernels vs with the plain
                 versions (earth, city); a 64x64 earth frame vs
                 tests/golden/earth.npz
  grad parity    the 64x64 earth golden's gradient fingerprint (rtol 2e-3)
  modes          earth at 1920x1088 with reconstruction jfa, sibson (R 16)
                 and all, and sampling weier, author and logpolar: budget
                 from a probe frame, one warm and one timed frame, stage
                 times, finite images and no rays dropped; then the three
                 64x64 mode goldens (earth_jfa against its golden; the
                 stale earth_sibson and earth_logpolar against the port's
                 CPU frames)
  assets build   writes seeded scene files (tests/torch_asset_files.py):
                 a resource directory as reference_assets_scene reads it
                 (CedarCity.hdr 800x1600 in RLE scanlines and
                 vokselia_spawn.png 2048x2048 with rows in all five PNG
                 filters, the reference's own sizes; grid.ppm 512x512,
                 bunny.PPM 256x256, the .mtl files), city's mesh as an OBJ
                 twice (geometry only: the native parser; with vt / vn,
                 usemtl groups and a PNG map_Kd: the Python parser) and a
                 JSON spec (the textured city scaled and moved, a glass
                 icosphere, the HDR); times each load step on the host
                 and loads the three scenes with the CLI's loader
                 (triangles, route: the asset scene resident, the others
                 streaming)
  main assets    the CLI's run on the resource directory at 1920x1088 (the
                 bench configuration, --profile-stages, --report, a BMP
                 dump): launches, no plain / brute / bvh call, peak memory,
                 stage columns, a lit finite image, the BMP read back by
                 image_io.load_bmp equal to the frame; then a profiled
                 frame (device time, busy share, top kernels)
  main city-obj, main spec
                 the same on the city OBJ and the spec (streaming kernels;
                 both through the texel gather on that route)
  parity assets  the resident kernels against their plain versions on the
                 asset scene's ray sets, and its 256x256 frame with the
                 kernels against the plain versions
  bvh            the bvh backend (plain torch) on earth's 256x256 primary
                 rays against the cluster kernels (the same ids, refined t
                 within rtol 1e-4 / atol 1e-5), its time and device
                 launches; a 256x256 frame with intersect_backend bvh
                 against the cluster route's (mask, counts, image MAE)
  quality        scripts.quality_eval's --quick rows at 960x544 (20
                 frames of the fixed centre gaze, 8 of warm-up): masked x
                 pullpush and x atrous against the full-sampling ground
                 truth; 0 rays dropped, the rows and ray % beside the CPU's
                 12.95%, launches, masked x pullpush's fovea at 99.0 dB
  sweep          scripts.aperture_sweep's six apertures at 1920x1088, 3
                 timed frames each: ray %, ms/frame, Mrays/s, launches
  scaling        scripts.scaling_bench: one NCCL rank at 1920x1088, one
                 and two gloo ranks sharing the card at 256x256 (rank
                 processes of the script): ms/frame, Mrays/s, efficiency,
                 rank 0's launches
  dist 1-rank    an NCCL process group of one; the bench frame through
                 dist.sharding.render_sharded (rows in scanline order) and
                 through render_frame, in turns, 3 circle-gaze frames: the
                 mask bit for bit, ray_count equal, no ray dropped, image
                 and history at rtol 2e-4 / atol 2e-5; ms/frame of both,
                 the sharded frames' launches, the cluster kernels' device
                 time in a frame of each; one city frame (the streaming
                 pair on row-major blocks: a hit at equal t may go to the
                 other triangle, so the image is held to MAE < 5e-3 and
                 the mask to < 0.1% flipped pixels)
  dist 2-rank    two processes of this script on the one card in a gloo
                 group (all-reduce and broadcast of CUDA tensors), earth
                 at 256x256: two sharded frames and a dense train step,
                 against this process's one-rank run (masks bit for bit,
                 frames at the tolerance above, loss and gradients at
                 rtol 1e-4)
  train          dist.train's dense and foveated (hard) steps on earth at
                 1920x1088 (app/optimize's configuration: max_depth 2,
                 diffuse_max_depth 1, reconstruction none), one warm and
                 two timed each: ms/step, peak memory, Mrays/s, loss,
                 gradient norms (finite; nonzero, but gaze_uv's in the
                 dense step), launches per step (the material kernels and
                 the envmap's, its adjoint once a bounce: the step trains
                 the envmap), and a torch.profiler summary of a step as in
                 main earth fwd+bwd (no IndexBackward0 from
                 render/shade.py)
  optimize       `python -m fovtrace_torch.app.optimize --scene box` with
                 --ckpt: 60 steps at 128x128 (the loss falls; its exit
                 code printed), 80 on the same directory (resumes at 60),
                 40 then 60 on another, whose step-60 parameters equal the
                 first run's (rtol 1e-6), and tests/test_checkpoint.py's
                 32x32 8-step run (exit 0); each run launched the material
                 and envmap kernels (the envmap adjoint too) and no plain
                 version
No plain version, brute oracle or bvh traversal runs on any card path
(PATH_PLAIN). Neither probe runs on a render path: their kernels'
launches on the main paths are 0.

    python3 chip_smoke.py --probe-times [ROOT]

times only the two probes' kernels, of this checkout or of the one at
ROOT (a parent's `git archive`), by their device time and their call.

    python3 chip_smoke.py --attribution [ROOT]

runs only the earth fwd+bwd step and the two train steps, each with its
attributed profile, of this checkout or of the one at ROOT.
The line before last is the card's name and power limit, the one before
it the kernels' JSON line, and the last line is the JSON result.
"""

from __future__ import annotations

import ast
import contextlib
import dataclasses
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

SEED = 7
GAZE_CFG = dict(reconstruction="atrous", max_depth=4, diffuse_max_depth=1)
DEVICE = "cuda"
W, H = 1920, 1088      # the main paths' frame
RES = 256              # the kernel checks' and parity frames' side
NCHK = 4096            # seeded random rays per kernel check
SRC = "fovtrace_torch/csrc/cluster_isect.cu"
PROBE_SRC = "fovtrace_torch/csrc/probes.cu"
MATERIAL_SRC = "fovtrace_torch/csrc/material.cu"
ENVMAP_SRC = "fovtrace_torch/csrc/envmap.cu"
REPLACES = {"closest_hit": "fovtrace/kernels/pallas_isect.py:518",
            "occlusion": "fovtrace/kernels/pallas_isect.py:806",
            "closest_hit_stream": "fovtrace/kernels/pallas_isect.py:577",
            "occlusion_stream": "fovtrace/kernels/pallas_isect.py:850",
            "micro_inner": "scripts/microbench_inner.py:70",
            "smem_dma": "scripts/probe_smem_dma.py:23",
            # the material table's lookup (no Pallas kernel: a select
            # chain / row gather) and its gradient with respect to the table
            "material_lookup": "fovtrace/kernels/intersect.py:401",
            "material_lookup_adjoint": "fovtrace/kernels/intersect.py:401",
            # the envmap's bilinear lookup (no Pallas kernel: a quad-table
            # gather) and its gradients, with respect to the texel
            # coordinates and to the map
            "envmap_lookup": "fovtrace/render/shade.py:41",
            "envmap_dxy": "fovtrace/render/shade.py:41",
            "envmap_adjoint": "fovtrace/render/shade.py:41"}
KERNELS = tuple(REPLACES)
SOURCES = {**dict.fromkeys(KERNELS[:4], SRC),
           **dict.fromkeys(KERNELS[4:6], PROBE_SRC),
           **dict.fromkeys(KERNELS[6:8], MATERIAL_SRC),
           **dict.fromkeys(KERNELS[8:], ENVMAP_SRC)}
# the launch counters of the material kernels, by their JSON names
MATERIAL_COUNTERS = {"material_lookup": "material_gather",
                     "material_lookup_adjoint": "material_adjoint"}
# plain versions, brute oracles and bvh traversals: no card path may run
# one (their counters must stay 0)
PATH_PLAIN = ("closest_hit_plain", "occlusion_plain", "intersect_brute",
              "occlusion_brute", "intersect_bvh", "occlusion_bvh",
              "material_gather_plain", "material_adjoint_plain",
              "envmap_lookup_plain", "envmap_dxy_plain",
              "envmap_adjoint_plain")
# H100 SXM peaks (NVIDIA data sheet): float32 outside the tensor cores,
# dense bf16 on the tensor cores, and HBM3 bandwidth
PEAK_F32 = 67e12
PEAK_BF16 = 989e12
PEAK_BYTES = 3.35e12
# operations per (ray, triangle) pair: the four 10-term dot products
# (40 FMAs = 80) and the epilogue's 13: ud, vd, det*det, ud + vd, |det|,
# 1/det, t_num * inv_det and 6 compares (|det| > eps, ud >= 0, vd >= 0,
# ud + vd <= det^2, t > t_min, t < t_max)
OPS_PER_PAIR = 93
# the microbenchmark's operations per ray and step: the slab test (6
# subtractions, 6 multiplies, 6 min/max of the slab ends, 6 of tenter and
# texit, 1 compare) and the halving; per (ray, triangle) pair, the four
# 10-term dot products (80; rows 10-15 of the pack are zero) and a
# 4-way running min (mm) or k_full's epilogue (ud, vd, det*det, ud + vd,
# |det|, t_num / det, 5 compares, the running min: 12)
OPS_SLAB = 26
OPS_MM_PAIR = 84
OPS_FULL_PAIR = 92
# the render path's cluster kernels, whose builds may not spill
RENDER_KERNELS = ("closest_kernel", "occlusion_kernel",
                  "closest_stream_kernel", "occlusion_stream_kernel")


def spills(log: str) -> dict:
    """{kernel: (spill store bytes, spill load bytes)} from ptxas -v."""
    out, fn = {}, None
    for line in log.splitlines():
        if "Function properties for" in line:
            fn = line.split("Function properties for")[1].strip()
        elif fn and "spill stores" in line:
            nums = [int(x) for x in line.replace(",", " ").split()
                    if x.isdigit()]
            out[fn] = (nums[1], nums[2])
            fn = None
    return out


def render_spills(log: str) -> dict:
    """`spills` of the render path's four cluster kernels, by name;
    raises unless the log reports each of them."""
    found = {}
    for fn, v in spills(log).items():
        m = re.search(r"\d+([a-z_]+_kernel)", fn)
        if m and m.group(1) in RENDER_KERNELS:
            found[m.group(1)] = v
    if sorted(found) != sorted(RENDER_KERNELS):
        raise AssertionError("no ptxas report of the four render-path "
                             f"cluster kernels: {sorted(found)}")
    return found


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True, text=True)
    return out.stdout.strip().splitlines()[0]


def dev_us(event) -> float:
    """A profiler event's own device time in microseconds."""
    return getattr(event, "self_device_time_total",
                   getattr(event, "self_cuda_time_total", 0.0))


def device_launches(fn, calls: int = 1) -> dict:
    """{kernel name: (device ms, launches)} over `calls` calls of fn,
    after one call that is not traced, from torch.profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return {e.key: (dev_us(e) / 1e3, e.count) for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and dev_us(e) > 0}


def device_ms(fn) -> dict:
    """{kernel name: device ms} of one call of fn, from torch.profiler."""
    return {k: ms for k, (ms, _) in device_launches(fn).items()}


def own_ms(fn, name: str, calls: int = 5, tries: int = 5):
    """(device ms per launch of the kernel whose name holds `name`, device
    ms per call of the call's other kernels, traces that missed some of
    its launches) over `calls` calls of fn, each of which launches that
    kernel once; the first of up to `tries` traces that records all
    `calls` launches counts. Traces do miss launches: on the H100 traces
    of 20 calls of the copy probe (parent's kernel and redesign alike)
    recorded 19, 0, and in one process none in five traces. No complete
    trace fails the smoke: nothing stands in for the kernel's time."""
    for missed in range(tries):
        got = device_launches(fn, calls)
        own = [v for k, v in got.items() if name in k]
        if sum(n for _, n in own) == calls:
            rest = sum(ms for k, (ms, _) in got.items() if name not in k)
            return sum(ms for ms, _ in own) / calls, rest / calls, missed
    raise AssertionError(f"none of {tries} traces of {calls} calls records "
                         f"every launch of {name}")


def queued_ms(fn, iters: int = 20) -> float:
    """Device ms per call of fn, for a call that launches one kernel and
    nothing else (the copy probe's, which traces miss: `own_ms`): CUDA
    events around `iters` calls queued behind a spin on the card, so the
    host's time to launch them is hidden; a host slower than the spin
    fails. A call's share is its kernel and the gap between two kernels
    on one stream."""
    fn()
    torch.cuda.synchronize()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    ev[0].record()
    torch.cuda._sleep(50_000_000)
    ev[1].record()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    host = (time.perf_counter() - t0) * 1e3
    ev[2].record()
    torch.cuda.synchronize()
    spin = ev[0].elapsed_time(ev[1])
    assert host < spin, f"queueing took {host:.3f} ms, the spin {spin:.3f}"
    return ev[1].elapsed_time(ev[2]) / iters


def host_ms(fn, iters: int = 50) -> float:
    """Host ms per call of fn over `iters` calls after a warm one, the
    card idle before them (what the call costs the host, its kernels
    queued, not waited for)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    ms = (time.perf_counter() - t0) * 1e3 / iters
    torch.cuda.synchronize()
    return ms


def cuda_ms(fn, iters: int, warmup: int = 1) -> float:
    """Mean ms per call from CUDA events around `iters` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(iters):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / iters


class Phases:
    """Prints each phase's wall time when the next one starts."""

    def __init__(self):
        self.name, self.t0 = None, time.perf_counter()

    def start(self, name):
        self.end()
        self.name, self.t0 = name, time.perf_counter()

    def end(self):
        if self.name:
            print(f"[{self.name}] phase wall {time.perf_counter() - self.t0:.2f} s",
                  flush=True)
        self.name = None


def kernel_name(kind, scene):
    """The launch counter of `kind` on this scene's route."""
    from fovtrace_torch.kernels import cluster_isect as ci

    nc, c = scene.cluster_aabb.shape[0], scene.isect_coef.shape[2] // 4
    return kind + ("_stream" if ci.route(nc, c) == "stream" else "")


def compare(name, scene, ro, rd, tmin, tmax, dev, errs):
    """Kernel vs plain version on one ray set; records the agreement
    under the name of the kernel the scene's route takes."""
    from fovtrace_torch.kernels import cluster_isect as ci
    from fovtrace_torch.kernels import intersect as isect

    raysT, n = ci.pack_raysT(ro, rd, tmin, tmax)
    sched, counts, params = ci.cluster_schedule(raysT, scene.cluster_aabb)
    coef, aux = scene.isect_coef, scene.isect_aux
    kw_c = dict(rec=scene.isect_rec)
    kw_o = dict(rec=scene.isect_rec, tflags=scene.isect_tflags)
    tk, ik = ci.closest_hit(raysT, coef, sched, counts, params, **kw_c)
    tp, ip = ci.closest_hit_plain(raysT, coef, sched, counts, params)
    ok_k = (ik.reshape(-1)[:n] >= 0)
    ok_p = (ip.reshape(-1)[:n] >= 0)
    flips = int((ok_k != ok_p).sum())
    hits = int(ok_p.sum())
    same = int(((ik == ip).reshape(-1)[:n] & ok_p).sum())
    z = torch.zeros(n, device=dev)
    ref = lambda t, i: isect.refine_hit_v(scene, ro, rd, isect.Hit(
        t.reshape(-1)[:n], i.reshape(-1)[:n], z, z)).t
    rk, rp = ref(tk, ik), ref(tp, ip)
    both = ok_k & ok_p
    t_err = float((rk - rp)[both].abs().max()) if hits else 0.0
    t_ok = bool(torch.allclose(rk[both], rp[both], rtol=1e-3, atol=1e-4))
    frac = same / max(hits, 1)
    kc, ko = kernel_name("closest_hit", scene), kernel_name("occlusion", scene)
    print(f"[kernels] {name}: {kc} {n} rays, {hits} hits, hit/miss flips "
          f"{flips}, identical ids {frac:.5f}, refined t max |err| "
          f"{t_err:.3e}")
    assert flips == 0, f"{name}: {flips} hit/miss flips"
    assert frac >= 0.995, f"{name}: only {frac:.5f} identical ids"
    assert t_ok, f"{name}: refined t off by {t_err}"

    ak = torch.stack(ci.occlusion(raysT, coef, aux, sched, counts, params,
                                  **kw_o))
    ap = torch.stack(ci.occlusion_plain(raysT, coef, aux, sched, counts,
                                        params))
    a_err = float((ak - ap).abs().max())
    print(f"[kernels] {name}: {ko} max |err| {a_err:.3e}, occluded "
          f"{float((ap.amax(0) == 0).float().mean()):.4f}")
    assert torch.allclose(ak, ap, rtol=1e-4, atol=1e-4), \
        f"{name}: occlusion off by {a_err}"
    if kc.endswith("_stream"):
        with ci.forced_split("all"):
            t2, i2 = ci.closest_hit(raysT, coef, sched, counts, params,
                                    **kw_c)
            a2 = torch.stack(ci.occlusion(raysT, coef, aux, sched, counts,
                                          params, **kw_o))
        d = float((a2 - ak).abs().max())
        same = torch.equal(t2, tk) and torch.equal(i2, ik)
        print(f"[kernels] {name}: every block split over 8 CTAs vs as "
              f"routed: closest hit bit for bit {same}, occlusion max |diff| "
              f"{d:.3e}")
        assert same, f"{name}: split closest hit differs"
        assert d <= 1e-6, f"{name}: split occlusion off by {d}"
    errs[kc] = max(errs.get(kc, 0.0), t_err)
    errs[ko] = max(errs.get(ko, 0.0), a_err)


def near_far_rays(dev, nb=6):
    """Rays straight down onto earth's sphere (radius 0.8 at (0, 1, 0))
    in nb ray blocks that alternate near and far: from 0.2 above its top
    (every best hit within ~0.2), then from 8.2 above it (every hit
    beyond 8), so that a near block's bound lies below every entry of
    the far block after it."""
    from fovtrace_torch.core.vec import Vec3
    from fovtrace_torch.kernels import intersect as isect

    rng = np.random.default_rng(13)
    jit = rng.uniform(-0.2, 0.2, size=(nb * 256, 3))
    y = np.where(np.arange(nb * 256) // 256 % 2 == 0, 2.0, 10.0)
    ro = np.stack([jit[:, 0], y, jit[:, 2]], 1)
    rd = np.tile([0.0, -1.0, 0.0], (nb * 256, 1))
    v = lambda a: Vec3(*[torch.tensor(a[:, k], dtype=torch.float32,
                                      device=dev) for k in range(3)])
    return v(ro), v(rd), isect.BIG_T


def resident_grids(label, scene, sets):
    """The resident pair with its persistent grid forced to 1 CTA, 3
    CTAs and as many as fit, taking the ray blocks longest first and in
    ascending order: the default launch's (t, idx, ar, ag, ab) and work
    counts (visited, ray_visited) bit for bit on every ray set. Every
    set's default launch is held against the plain versions by
    `compare`, but for the near / far blocks, whose closest hit is held
    here: every ray hits, with the plain version's ids."""
    from fovtrace_torch.kernels import cluster_isect as ci

    for name, (ro, rd, tmax) in sets.items():
        raysT, _ = ci.pack_raysT(ro, rd, 1e-3, tmax)
        sched, counts, params = ci.cluster_schedule(raysT, scene.cluster_aabb)
        nb = raysT.shape[0]

        def run():
            work = [torch.zeros_like(counts) for _ in range(4)]
            ch = ci.closest_hit(raysT, scene.isect_coef, sched, counts,
                                params, work[0], rec=scene.isect_rec,
                                ray_visited=work[1])
            oc = ci.occlusion(raysT, scene.isect_coef, scene.isect_aux,
                              sched, counts, params, work[2],
                              rec=scene.isect_rec, tflags=scene.isect_tflags,
                              ray_visited=work[3])
            return (*ch, *oc, *work)
        ref = run()
        if name == "nearfar":
            _, ip = ci.closest_hit_plain(raysT, scene.isect_coef, sched,
                                         counts, params)
            assert bool((ip >= 0).all()) and torch.equal(ref[1], ip), \
                f"{label} {name}: closest hit differs from the plain ids"
        c = scene.isect_coef.shape[2] // 4
        full = [ci.resident_ctas(k, nb, c) for k in ("closest_hit",
                                                    "occlusion")]
        bad = []
        for ctas, order in [(n, o) for n in (1, 3, 0)
                            for o in ("longest", "ascending")]:
            with ci.forced_grid(ctas, order):
                got = run()
            if not all(torch.equal(x, y) for x, y in zip(ref, got)):
                bad.append((ctas, order))
        torch.cuda.synchronize()
        print(f"[kernels] {label} {name}: resident pair on 1, 3 and all "
              f"{full} CTAs ({nb} ray blocks), longest first and ascending: "
              f"bit for bit the default launch's (t, idx, ar, ag, ab, "
              f"visited, ray_visited): {not bad}")
        assert not bad, f"{label} {name}: grid/order changed results {bad}"


def ray_sets(scene, cam, dev):
    """{name: (ro, rd, t_max)}: NCHK seeded random rays around the
    scene, the RES x RES primary rays in tile order, and the shadow rays
    of that frame's G-buffer."""
    from fovtrace_torch.config import RenderConfig
    from fovtrace_torch.core.vec import Vec3
    from fovtrace_torch.kernels import intersect as isect
    from fovtrace_torch.render import gbuffer

    rng = np.random.default_rng(SEED)
    nchk = NCHK
    ctr = ((scene.bbox_min + scene.bbox_max) / 2.0).cpu().numpy()
    ext = float(torch.linalg.vector_norm(scene.bbox_max - scene.bbox_min))
    ro = ctr + rng.normal(size=(nchk, 3)).astype(np.float32) * ext
    rd = rng.normal(size=(nchk, 3)).astype(np.float32)
    rd /= np.linalg.norm(rd, axis=-1, keepdims=True)
    v = lambda a: Vec3(*[torch.as_tensor(a[:, k], dtype=torch.float32,
                                         device=dev) for k in range(3)])
    out = {f"random{nchk}": (v(ro), v(rd), isect.BIG_T)}
    pro, prd = cam.primary_rays_v(RES, RES)
    swz = lambda a: gbuffer.swizzle_to_tiles(a.reshape(-1), RES, RES)
    pro, prd = pro.map(swz), prd.map(swz)
    out[f"primary{RES}"] = (pro, prd, isect.BIG_T)
    hit, surf = isect.intersect_surface_v(scene, pro, prd, 1e-3, isect.BIG_T)
    cfg = RenderConfig(width=RES, height=RES, **GAZE_CFG)
    so, sd, stmax, _ = gbuffer.shadow_rays(scene, prd, hit, surf, cfg)
    out[f"shadow{RES}"] = (so, sd, stmax)
    return out


def bound(kind, args, visited):
    """(bound_ms, bound_by) of one launch: the larger of its operations
    over the float32 peak and its bytes over the HBM rate. Pairs are the
    (ray, triangle) pairs of the member clusters the kernel tested
    (`visited`); bytes count the rays, counts and outputs once, the
    schedule entries walked, and rows 0-9 of every cluster some block
    tested once (plus its aux rows 0-4 for a transparent cluster in
    occlusion)."""
    from fovtrace_torch.kernels import cluster_isect as ci

    raysT, coef = args[0], args[1]
    sched, counts = (args[2], args[3]) if kind == "closest_hit" else \
        (args[3], args[4])
    nb, nc, c = raysT.shape[0], coef.shape[0], coef.shape[2] // 4
    m = ci.pick_members(nc)
    nsc, sw = nc // m, sched.shape[1] // 2
    dev = raysT.device
    in_row = torch.arange(nsc, device=dev)[None, :] < counts[:, None].long()
    if m == 1:
        live = in_row[..., None]
    else:
        bits = sched[:, sw:sw + nsc]
        live = (((bits[..., None] >> torch.arange(m, device=dev)) & 1) == 1) \
            & in_row[..., None]
    live = live.reshape(nb, -1)
    walked = live & (live.long().cumsum(1) <= visited[:, None].long())
    cid = ((sched[:, :nsc] & 0xFFFF).long()[..., None] * m
           + torch.arange(m, device=dev)).reshape(nb, -1)
    used = torch.zeros(nc, dtype=torch.bool, device=dev)
    used[cid[walked]] = True
    entries = int(walked.reshape(nb, nsc, m).any(-1).sum())
    slab = int(used.sum()) * 10 * 4 * c * 4     # coefficient rows 0-9
    out_bytes = nb * 256 * (8 if kind == "closest_hit" else 12)
    if kind == "occlusion":
        tflags = ci.cluster_tflags(args[2])
        slab += int((used & (tflags == 1)).sum()) * 5 * c * 4
    nbytes = raysT.numel() * 4 + nb * 4 + entries * 8 + slab + out_bytes
    pairs = int(visited.sum()) * 256 * c
    t_ops = pairs * OPS_PER_PAIR / PEAK_F32 * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    by = "operations" if t_ops >= t_bytes else "bytes"
    return max(t_ops, t_bytes), by, pairs, nbytes


def probe_calls() -> dict:
    """Launches of the probe kernels and calls of their plain versions
    since the counters were last reset."""
    from fovtrace_torch import kernels

    return {k: v for k, v in kernels.CALLS.items()
            if k.startswith(("micro_", "smem_dma"))}


def bench_probe_frac(scene, cam, **extra):
    """bench.py's budget sizing at W x H, the package's
    (`fovtrace_torch.bench.size_budget`): one probe frame; if the mask is
    denser than the budget, the fraction covers it plus 2%. `extra`
    overrides the bench configuration (a sampling mode, say)."""
    from fovtrace_torch import bench

    return bench.size_budget(scene, cam, (H // 2, W // 2),
                             bench.bench_config(W, H).replace(**extra))


# the [bench] phase's runs of fovtrace_torch.bench: (label, scene, flags)
BENCH_RUNS = (("earth fwd+bwd", "earth", ("--selfcheck",)),
              ("earth fwd", "earth", ("--forward-only",)),
              ("city fwd", "city", ("--forward-only", "--selfcheck")))
BENCH_KEYS = ["metric", "unit", "value", "vs_baseline"]


def bench_phase(scenes, card):
    """fovtrace_torch.bench's run in this process at W x H (--iters 5
    --warmup 1) on each of BENCH_RUNS, its scene already on the card: the
    last stdout line is its JSON line with bench.py's four keys and a
    finite positive value, no ray dropped, the selfcheck above 0.999, and
    the timed steps launched the route's two cluster kernels and no plain
    version, brute oracle or bvh traversal (the counts are zeroed before
    the timed steps and read after them)."""
    import io
    import math

    from fovtrace_torch import bench

    for label, name, flags in BENCH_RUNS:
        t0 = time.perf_counter()
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            res = bench.run(["--scene", name, "--width", str(W), "--height",
                             str(H), "--iters", "5", "--warmup", "1", *flags],
                            scene=scenes[name])
        lines = out.getvalue().splitlines()
        line = json.loads(lines[-1])
        wall = time.perf_counter() - t0
        print(f"[bench] {label}: {lines[-1]}  [{card}]")
        assert sorted(line) == BENCH_KEYS, line
        assert math.isfinite(line["value"]) and line["value"] > 0, line
        assert res["rays_dropped"] == 0, res
        if "--selfcheck" in flags:
            assert res["selfcheck"] > 0.999, res["selfcheck"]
        route = "" if name == "earth" else "_stream"
        other = "_stream" if name == "earth" else ""
        path_launches(f"bench {label}", res["per_step"],
                      (f"closest_hit{route}", f"occlusion{route}",
                       "material_gather", "envmap_lookup",
                       *(() if "--forward-only" in flags else
                         ("material_adjoint", "envmap_dxy"))))
        # the bench trains no envmap: its adjoint never runs
        assert not res["per_step"].get("envmap_adjoint"), res["per_step"]
        for k in (f"closest_hit{other}", f"occlusion{other}"):
            assert k not in res["per_step"], (label, res["per_step"])
        ms = res["step_ms"]
        pad = res["padding"]
        print(f"[bench] {label}: {res['ms']:.2f} ms/step (host clock, mean), "
              f"stream time per step median {float(np.median(ms)):.2f} / min "
              f"{min(ms):.2f} / max {max(ms):.2f} ms, peak device memory "
              f"{res['peak_gib']:.2f} GiB, rays_traced {res['rays_traced']} "
              f"(ray_count {res['ray_count']}), {pad['padding']} padding "
              f"slots in bounce 0 of which {pad['continuing']} continue, "
              f"selfcheck {res['selfcheck']}, camera inverse round trips "
              f"per step {res['inv4_per_step']:g}; run {wall:.1f} s  [{card}]")


def main_path(label, scene_name, scene, cam, card, extra=()):
    """The CLI's run on one scene at W x H, 3 frames (`extra`: more CLI
    arguments); returns (launch counts during exactly that run, bench
    config, steady ms/frame, the run's stats)."""
    from fovtrace_torch.app import cli
    from fovtrace_torch.kernels import cluster_isect as ci

    need, frac, cfg = bench_probe_frac(scene, cam)
    print(f"[{label}] mask covers {100 * need:.2f}% of pixels -> "
          f"ray_budget_frac {frac}")
    args = cli.build_argparser().parse_args([
        "--device", DEVICE, "--scene", scene_name, "--width", str(W),
        "--height", str(H), "--frames", "3", "--gaze", "circle",
        "--reconstruction", "atrous", "--max-depth", "4", "--gi-depth", "1",
        "--ray-budget-frac", str(frac), *extra])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ci.reset_counters()
    stats = cli.run(args, scene=scene)
    torch.cuda.synchronize()
    counts = ci.counters()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    out = stats["out"]
    img = torch.stack([out["image_rgb"].x, out["image_rgb"].y,
                       out["image_rgb"].z])
    mean = float(img.mean())
    print(f"[{label}] counts during the run: {json.dumps(counts)}")
    print(f"[{label}] rays_dropped per frame {stats['rays_dropped']}, "
          f"ray_count {stats['ray_count']}, image mean {mean:.4f}, "
          f"finite {bool(torch.isfinite(img).all())}")
    assert max(stats["rays_dropped"]) == 0, "the budget truncated the mask"
    assert bool(torch.isfinite(img).all()), "non-finite image"
    assert 0.05 < mean < 0.95, f"implausible frame mean {mean}"
    for k in PATH_PLAIN:
        assert counts.get(k, 0) == 0, (k, counts)
    assert not probe_calls(), probe_calls()
    print(f"[{label}] peak device memory {peak:.2f} GiB  [{card}]")
    for f, (ms, rays) in enumerate(zip(stats["frame_ms"],
                                       stats["rays_traced"])):
        print(f"[{label}] frame {f}: {ms:.2f} ms, rays_traced {rays}, "
              f"{rays / ms / 1e3:.2f} Mrays/s  [{card}]")
    steady = float(np.mean(stats["frame_ms"][1:]))
    rays = float(np.mean(stats["rays_traced"][1:]))
    print(f"[{label}] {scene_name} {W}x{H} steady {steady:.2f} ms/frame, "
          f"{rays:.0f} rays_traced/frame, {rays / steady / 1e3:.2f} Mrays/s "
          f"[{card}]")
    return counts, cfg, steady, stats


def capture_inputs(scene, cam, cfg):
    """The (closest_hit, occlusion) arguments of one bench frame, as
    (positional, keyword) pairs in call order: [0] the G-buffer pass,
    [1] bounce 0."""
    from fovtrace_torch.kernels import cluster_isect as ci
    from fovtrace_torch.render import pipeline

    captured = {"closest_hit": [], "occlusion": []}
    real = {"closest_hit": ci.closest_hit, "occlusion": ci.occlusion}

    def recorder(name):
        def call(*a, **kw):
            captured[name].append((a, kw))
            return real[name](*a, **kw)
        return call

    ci.closest_hit, ci.occlusion = recorder("closest_hit"), \
        recorder("occlusion")
    try:
        pipeline.render_frame(scene, cam, (H // 2, W // 2),
                              pipeline.FrameState.initial(cam, cfg), cfg)
    finally:
        ci.closest_hit, ci.occlusion = real["closest_hit"], real["occlusion"]
    return captured


def stage_times(scene, cam, cfg, st, gaze) -> dict:
    """ms of each stage of one frame (render.staged: a synchronise after
    each stage), by the reference's report names."""
    from fovtrace_torch.app.profiler import StageTimer
    from fovtrace_torch.render import staged

    timer = StageTimer()
    torch.cuda.synchronize()
    staged.render_frame_staged(scene, cam, gaze, st, cfg, timer)
    return timer.means()


def fmt_stages(ms: dict) -> str:
    return (", ".join(f"{k} {v:.2f}" for k, v in ms.items())
            + f"; sum {sum(ms.values()):.2f}")


def frame_profile(label, scene, cam, cfg, steady_ms, card):
    """Stage times of one frame (a synchronise after each stage), then a
    torch.profiler pass over another: device kernels launched, summed
    device time, its share of the unprofiled steady frame, top kernels."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from fovtrace_torch.render import pipeline

    gaze = (H // 2, W // 2)
    st = pipeline.FrameState.initial(cam, cfg)
    _, st = pipeline.render_frame(scene, cam, gaze, st, cfg)
    ms = stage_times(scene, cam, cfg, st, gaze)
    print(f"[profile] {label} stages (ms, each ending in a synchronise): "
          f"{fmt_stages(ms)}  [{card}]")

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        pipeline.render_frame(scene, cam, gaze, st, cfg)
        torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    kern = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and dev_us(e) > 0]
    total = sum(dev_us(e) for e in kern) / 1e3
    launched = sum(e.count for e in kern)
    top = sorted(kern, key=lambda e: -dev_us(e))[:6]
    print(f"[profile] {label} profiled frame: {launched} device kernels, "
          f"summed device time {total:.2f} ms in a {wall:.2f} ms wall with "
          f"the profiler on; {100 * total / steady_ms:.1f}% of the "
          f"{steady_ms:.2f} ms steady frame  [{card}]")
    for e in top:
        print(f"[profile] {label}   {dev_us(e) / 1e3:8.2f} ms  {e.count:5d} x "
              f"{e.key[:90]}")


def time_schedule(scene, raysT, card):
    """CUDA-event time and peak device memory of the schedule build
    (block_liveness, then the sort) at one captured shape."""
    from fovtrace_torch.kernels import cluster_isect as ci

    live_ms = cuda_ms(lambda: ci.block_liveness(raysT, scene.cluster_aabb),
                      iters=5)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    sched_ms = cuda_ms(lambda: ci.cluster_schedule(raysT, scene.cluster_aabb),
                       iters=5)
    peak = (torch.cuda.max_memory_allocated() - base) / 2**20
    print(f"[timing] cluster_schedule {raysT.shape[0]} blocks x "
          f"{scene.cluster_aabb.shape[0]} clusters: {sched_ms:.3f} ms "
          f"(block_liveness {live_ms:.3f} ms), peak transient {peak:.0f} MiB "
          f"[{card}]")


def histogram(values, edges=(0, 1, 2, 4, 8, 16, 32, 64, 128, 256)):
    """Counts of `values` per bin [lo, hi) of `edges`, the last open."""
    v = values.float().cpu()
    bins = []
    for lo, hi in zip(edges, edges[1:] + (float("inf"),)):
        n = int(((v >= lo) & (v < hi)).sum())
        if n:
            bins.append(f"[{lo},{hi}) {n}")
    return (f"min {float(v.min()):.2f} mean {float(v.mean()):.2f} max "
            f"{float(v.max()):.2f}; " + ", ".join(bins))


def time_kernels(scene, captured, card, errs, times, kernel_iters,
                 plain_iters):
    """Kernel (CUDA events), plain version and bound at the captured
    G-buffer and bounce-0 shapes; checks kernel against plain there.
    Each kernel with the pairs its warps computed, the bound of those
    pairs, and the histograms of member clusters tested per block and
    computed per ray. The streaming kernels also without the heavy-block
    split, with and without the split CTAs in the grid; the resident
    kernels' persistent grid, their time with the ray blocks in
    ascending order, the wrapper's device work beside the kernel's, and
    their inputs through the streaming kernels."""
    from fovtrace_torch.kernels import cluster_isect as ci

    real = {"closest_hit": ci.closest_hit, "occlusion": ci.occlusion}
    plain = {"closest_hit": ci.closest_hit_plain,
             "occlusion": ci.occlusion_plain}
    for kind in ("closest_hit", "occlusion"):
        name = kernel_name(kind, scene)
        stream = name.endswith("_stream")
        for label, call in (("gbuffer", 0), ("bounce0", 1)):
            a, kw = captured[kind][call]
            nb, c = a[0].shape[0], a[1].shape[2] // 4
            k_ms = cuda_ms(lambda: real[kind](*a, **kw), iters=kernel_iters)
            po = None

            def run_plain():
                nonlocal po
                po = plain[kind](*a)
            p_ms = cuda_ms(run_plain, iters=plain_iters, warmup=0)
            visited = torch.zeros(nb, dtype=torch.int32, device=a[0].device)
            rv = torch.zeros_like(visited)
            ko = real[kind](*a, **kw, visited=visited, ray_visited=rv)
            torch.cuda.synchronize()
            if kind == "closest_hit":
                flips = int(((ko[1] >= 0) != (po[1] >= 0)).sum())
                same = float(((ko[1] == po[1]) & (po[1] >= 0)).sum()) / \
                    max(1, int((po[1] >= 0).sum()))
                assert flips == 0, f"{name} {label}: {flips} hit/miss flips"
                assert same >= 0.995, f"{name} {label}: ids {same}"
                agree = f"0 flips, identical ids {same:.5f}"
            else:
                err = float(max((x - y).abs().max() for x, y in zip(ko, po)))
                errs[name] = max(errs[name], err)
                assert all(torch.allclose(x, y, rtol=1e-4, atol=1e-4)
                           for x, y in zip(ko, po)), f"{name} {label}: {err}"
                agree = f"max |err| {err:.3e}"
            b_ms, by, pairs, nbytes = bound(kind, a, visited)
            print(f"[timing] {name} {label} ({nb * ci.RAY_BLOCK} ray slots, "
                  f"{int(visited.sum())} member clusters tested, {pairs} "
                  f"pairs, {nbytes} B): kernel {k_ms:.3f} ms, plain "
                  f"{p_ms:.3f} ms, bound {b_ms:.3f} ms ({by}), {agree}  "
                  f"[{card}]", flush=True)
            # the warps' own exits: the pairs they computed
            wpairs = int(rv.sum()) * c
            w_ms = max(wpairs * OPS_PER_PAIR / PEAK_F32,
                       nbytes / PEAK_BYTES) * 1e3
            computed = (f"warps computed {wpairs} pairs "
                        f"({wpairs / max(pairs, 1):.3f} of the block pairs), "
                        f"computed-pairs bound {w_ms:.3f} ms beside the block "
                        f"bound {b_ms:.3f} ms")
            counts = a[3 if kind == "closest_hit" else 4]
            if stream:
                # no ray block split: with no CTA for a split, then with
                # the 8 nb split CTAs launched and returning at once
                split_ms = {}
                for mode in ("none", "idle"):
                    with ci.forced_split(mode):
                        split_ms[mode] = cuda_ms(
                            lambda: real[kind](*a, **kw), iters=kernel_iters)
                heavy = int((counts > ci.STREAM_HEAVY).sum())
                print(f"[timing] {name} {label}: {heavy} heavy blocks (> "
                      f"{ci.STREAM_HEAVY} live entries) split over 8 CTAs "
                      f"in {k_ms:.3f} ms; no block split "
                      f"{split_ms['none']:.3f} ms, and with the "
                      f"{8 * nb} idle split CTAs launched "
                      f"{split_ms['idle']:.3f} ms (they cost "
                      f"{split_ms['idle'] - split_ms['none']:.3f} ms); "
                      f"{computed}  [{card}]")
            else:
                # the persistent grid; the ray blocks in ascending order
                # instead of longest first; the wrapper's device time
                # (ticket sort and zero fills beside it)
                ctas = ci.resident_ctas(kind, nb, c)
                with ci.forced_grid(0, "ascending"):
                    asc_ms = cuda_ms(lambda: real[kind](*a, **kw),
                                     iters=kernel_iters)
                # the wrapper's own device work beside the kernel
                dev = device_ms(lambda: real[kind](*a, **kw))
                kname = "closest_kernel" if kind == "closest_hit" else \
                    "occlusion_kernel"
                own = sum(v for k, v in dev.items() if kname in k)
                other = sum(dev.values()) - own
                # the same inputs through the streaming kernel (forced
                # route; M = 1, bit for bit equal)
                saved = ci._COEF_RESIDENT_BYTES
                ci._COEF_RESIDENT_BYTES = 0
                try:
                    s_ms = cuda_ms(lambda: real[kind](*a, **kw),
                                   iters=kernel_iters)
                    so = real[kind](*a, **kw)
                finally:
                    ci._COEF_RESIDENT_BYTES = saved
                s_diff = float(max((x - y).abs().max()
                                   for x, y in zip(so, ko)))
                s_same = all(torch.equal(x, y) for x, y in zip(so, ko))
                assert s_same or (kind == "occlusion" and s_diff <= 1e-6), \
                    f"{name} {label}: streaming kernel differs by {s_diff}"
                print(f"[timing] {name} {label}: {ctas} persistent CTAs for "
                      f"{nb} ray blocks ({int((counts > 0).sum())} with live "
                      f"entries), longest first in {k_ms:.3f} ms (profiled: "
                      f"the kernel {own:.3f} ms, the ticket sort and zero "
                      f"fills {other:.3f} ms of device time), ascending "
                      f"order {asc_ms:.3f} ms; {computed}  [{card}]")
                print(f"[timing] {name} {label} through the streaming "
                      f"kernel (forced route): {s_ms:.3f} ms against the "
                      f"resident {k_ms:.3f} ms, results bit for bit equal "
                      f"{s_same} (max |diff| {s_diff:.3e})  [{card}]")
            print(f"[timing] {name} {label} member clusters tested per "
                  f"block: {histogram(visited)}")
            print(f"[timing] {name} {label} member clusters computed "
                  f"per ray (block mean): {histogram(rv / 256.0)}",
                  flush=True)
            times[(name, label)] = (k_ms, p_ms, b_ms, by, int(visited.sum()))


def micro_bound(variant, inp, steps):
    """(bound_ms, bound_by) of one microbenchmark variant on `inp`: its
    operations (per live step, and per (ray, triangle) pair of the
    `steps` that ran the dot products) over the float32 peak (mm_bf16's
    bf16 dot products over the bf16 peak, added), against the bytes it
    must move over the HBM rate: counts, the live schedule entries and
    the output once, the [N, 16] ray rows and the AABBs for all but
    loop, rows 0-9 of every cluster's coefficients for the matmul
    variants."""
    live = int(inp.counts.sum())
    n = inp.rays.shape[0]
    nbytes = inp.nb * 4 + live * 4 + n * 4
    ops = live * 256
    t_bf16 = 0.0
    if variant != "loop":
        nbytes += inp.rays.numel() * 4 + inp.cb_flat.numel() * 4
    if variant in ("slab", "full"):
        ops = live * 256 * OPS_SLAB
    coef = inp.coef(variant)
    if coef is not None:
        nbytes += inp.nc * 10 * 4 * inp.c * coef.element_size()
        per_pair = OPS_FULL_PAIR if variant == "full" else OPS_MM_PAIR
        pairs = steps * 256 * inp.c
        if variant == "mm_bf16":
            t_bf16 = pairs * 80 / PEAK_BF16 * 1e3
            per_pair -= 80
        ops += pairs * per_pair
    t_ops = ops / PEAK_F32 * 1e3 + t_bf16
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes")


PROBE_GRIDS = ((1, "longest"), (1, "ascending"), (2, "longest"),
               (2, "ascending"))


def probe_micro(earth, card, times, results, lib):
    """The microbenchmark at the script's size: each variant against its
    plain version on the persistent grid, and on forced grids of 1 and 2
    CTAs in both orders bit for bit the default grid's; then its time,
    bound, share of the bound and ns per live step and per step past the
    cull, beside closest_kernel's ns per visited cluster on the earth
    G-buffer; then each body's inner-loop mix from the library's SASS
    (mm_bf16 must issue HMMA)."""
    from fovtrace_torch.scripts import MICRO_VARIANTS, forced_grid
    from fovtrace_torch.scripts import microbench_inner as mb
    from fovtrace_torch.scripts import sass_mix

    inp = mb.build_inputs(earth)
    live = int(inp.counts.sum())
    print(f"[probe micro] nb={inp.nb} nc={inp.nc} c={inp.c} live={live} "
          f"({inp.rays.shape[0]} rays, {live / inp.nb:.2f} live clusters "
          f"per block)")
    for v in MICRO_VARIANTS:
        args = inp.args(v)
        stats, po = {}, None

        def run_plain():
            nonlocal po
            po = mb.plain(v, *args, stats=stats)
        p_ms = cuda_ms(run_plain, iters=1, warmup=0)
        ko = mb.run_variant(v, *args)
        torch.cuda.synchronize()
        assert ko.shape == po.shape == (inp.rays.shape[0], 1)
        assert bool(torch.isfinite(ko).all()), f"{v}: non-finite output"
        if v in ("loop", "slab"):
            # integer sums and halvings: exact in any order
            err = float((ko - po).abs().max())
            assert torch.equal(ko, po), f"{v}: not bit-equal, {err}"
            agree = "bit-equal"
        elif v == "full":
            # the kernel contracts 10 rows in FMA, the plain version 16 in
            # cuBLAS: t within rtol 1e-3 / atol 1e-4 (the closest-hit
            # gate), at most 0.5% hit/miss flips
            hk, hp = ko < 1e30, po < 1e30
            flips = int((hk != hp).sum())
            both = hk & hp
            err = float((ko - po)[both].abs().max())
            assert flips <= 0.005 * ko.numel(), f"full: {flips} flips"
            assert bool(torch.allclose(ko[both], po[both], rtol=1e-3,
                                       atol=1e-4)), f"full: t off by {err}"
            agree = (f"{flips} flips, {int(hp.sum())} hits, t max |err| "
                     f"{err:.3e}")
        else:
            # float32 sums of 10 (kernel) and 16 (plain) terms in another
            # order, |values| below ~100 (mm_bf16: the tensor cores' sums
            # of exact bf16 products): rtol 1e-4 / atol 1e-4
            err = float((ko - po).abs().max())
            assert bool(torch.allclose(ko, po, rtol=1e-4, atol=1e-4)), \
                f"{v}: off by {err}"
            agree = f"max |err| {err:.3e}"
        # each block is one CTA's whole: no grid or order changes a bit
        for ctas, order in PROBE_GRIDS:
            with forced_grid(ctas, order):
                kf = mb.run_variant(v, *args)
            torch.cuda.synchronize()
            assert torch.equal(kf, ko), f"{v}: grid {ctas} {order} differs"
        k_ms = cuda_ms(lambda: mb.run_variant(v, *args), iters=20)
        own, rest, missed = own_ms(
            lambda: mb.run_variant(v, *args),
            f"micro_kernel<{MICRO_VARIANTS.index(v)}>")
        b_ms, by = micro_bound(v, inp, stats.get("steps", 0))
        steps = stats.get("steps", live) if v == "full" else live
        print(f"[probe micro] {v:8s} call {k_ms:.4f} ms (device: kernel "
              f"{own:.4f} ms a launch + {rest:.4f} ms of ticket order and "
              f"fills; {missed} traces missed launches), plain "
              f"{p_ms:.3f} ms, bound {b_ms:.4f} ms ({by}), kernel at "
              f"{100 * b_ms / own:.1f}% of the bound, "
              f"{own * 1e6 / live:.3f} ns per live step, "
              f"{own * 1e6 / max(steps, 1):.3f} ns per step past the cull "
              f"({steps}), grid {mb.grid(v, inp.nb, inp.c)} CTAs (forced "
              f"1 / 2 CTAs, both orders: bit-equal), {agree}  [{card}]",
              flush=True)
        results[v] = (k_ms, p_ms, b_ms, by, err)
    k_ms, visited = times[("closest_hit", "gbuffer")][0], \
        times[("closest_hit", "gbuffer")][4]
    print(f"[probe micro] closest_hit earth G-buffer: {k_ms:.4f} ms over "
          f"{visited} visited clusters, {k_ms * 1e6 / visited:.3f} ns per "
          f"visited cluster  [{card}]")
    mix = sass_mix.report(lib, tag="[probe micro] sass")
    bf16 = f"micro_kernel<{MICRO_VARIANTS.index('mm_bf16')}>"
    hmma = sum(lp["counts"]["HMMA"] for lp in mix.get(bf16, []))
    assert hmma > 0, "mm_bf16's inner loop issues no HMMA"
    print(f"[probe micro] mm_bf16 inner loop: {hmma} HMMA")


def dma_city_args(city_gbuffer, dma):
    """The copy probe's arguments at the city G-buffer's schedule rows:
    (counts [NB], sched [NB, SW], raysT [NB, 16, 256], a seeded table
    [NSC, 256]), from closest_hit's captured G-buffer arguments."""
    from fovtrace_torch.kernels import cluster_isect as ci

    raysT, coef, schedmask, counts, _ = city_gbuffer
    sw = schedmask.shape[1] // 2
    nsc = coef.shape[0] // ci.pick_members(coef.shape[0])
    rng = np.random.default_rng(SEED)
    table = torch.from_numpy(rng.normal(size=(nsc, dma.R))
                             .astype(np.float32)).to(raysT.device)
    return counts, schedmask[:, :sw].contiguous(), raysT, table


def embedding_bag_call(args):
    """The copy probe's library yardstick on its arguments: one
    F.embedding_bag with per-sample weights computes the weighted row
    sums (all but the final + rays[b, 0, :]); a callable."""
    import torch.nn.functional as F

    counts, sched, _, table = args
    live = torch.arange(sched.shape[1], device=sched.device)[None, :] \
        < counts[:, None]
    ents = sched[live]
    offsets = torch.cumsum(counts, 0, dtype=torch.int64) - counts.long()
    ids = (ents % 65536).long()
    w = torch.div(ents, 65536, rounding_mode="floor").to(torch.float32)
    return lambda: F.embedding_bag(ids, table, offsets, mode="sum",
                                   per_sample_weights=w)


def probe_dma(city_gbuffer, card):
    """The schedule-row copy probe: the script's size against its numpy
    check and the plain version, then the city G-buffer's schedule rows
    (its real counts and entries, seeded table) against the plain
    version, timed against its bytes bound, with the bytes it copies and
    the table bytes it reads from L2, and the kernel's own device time
    (profiled) beside the call's; at both sizes forced grids of 1 and 2
    CTAs in both orders give the same bits; then a table too large for a
    shared-memory slice (the global-memory path). Returns (call ms, plain
    ms, bound ms, bound_by, library ms, max |err|) at the city shape."""
    from fovtrace_torch.scripts import forced_grid
    from fovtrace_torch.scripts import probe_smem_dma as dma

    def same_on_grids(args, want, label):
        for ctas, order in PROBE_GRIDS:
            with forced_grid(ctas, order):
                got = dma.smem_dma(*args)
            torch.cuda.synchronize()
            assert torch.equal(got, want), f"smem_dma {label}: grid " \
                f"{ctas} {order} differs"

    dev = torch.device(DEVICE)
    arrays = dma.make_inputs()
    small = [torch.from_numpy(a).to(dev) for a in arrays]
    ko = dma.smem_dma(*small)
    po = dma.plain(*small)
    torch.cuda.synchronize()
    n_err = float(np.abs(ko.cpu().numpy()
                         - dma.numpy_reference(*arrays)).max())
    err = float((ko - po).abs().max())
    print(f"[probe dma] script size (NB {dma.NB}, NSC {dma.NSC}, SW "
          f"{dma.NSC_PAD}): table slice of {dma.table_lanes(dma.NSC)} lanes "
          f"in shared memory, grid {dma.grid(dma.NB, dma.NSC)} CTAs; max err "
          f"vs the numpy check {n_err:.3e}, vs plain {err:.3e}")
    assert n_err == 0.0, "MISMATCH against the script's numpy check"
    assert torch.equal(ko, po), "smem_dma differs from its plain version"
    same_on_grids(small, ko, "script size")

    args = dma_city_args(city_gbuffer, dma)
    counts, sched, raysT, table = args
    nb, sw, nsc = counts.shape[0], sched.shape[1], table.shape[0]
    po = None

    def run_plain():
        nonlocal po
        po = dma.plain(*args)
    p_ms = cuda_ms(run_plain, iters=1, warmup=0)
    ko = dma.smem_dma(*args)
    torch.cuda.synchronize()
    err = max(err, float((ko - po).abs().max()))
    assert torch.equal(ko, po), "smem_dma differs from its plain version"
    np.testing.assert_array_equal(ko.cpu().numpy(), dma.numpy_reference(
        *(a.cpu().numpy() for a in args)))
    same_on_grids(args, ko, "city rows")
    # one shared-memory limit per kernel function: a launch on a smaller
    # table between two at the city's must not leave it too low
    mid = [torch.from_numpy(a).to(dev) for a in
           dma.make_inputs(nb=64, nsc=100, sw=128, seed=SEED)]
    assert torch.equal(dma.smem_dma(*mid), dma.plain(*mid))
    assert torch.equal(dma.smem_dma(*args), ko), "city rows after NSC 100"
    k_ms = cuda_ms(lambda: dma.smem_dma(*args), iters=20)
    own = queued_ms(lambda: dma.smem_dma(*args))
    # the bytes it must move: counts, the live entries, ray row 0 of each
    # block, the table and the output once; a multiply and an add per
    # live entry and lane
    live = int(counts.sum())
    nbytes = nb * 4 + live * 4 + 2 * nb * dma.R * 4 + table.numel() * 4
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = live * dma.R * 2 / PEAK_F32 * 1e3
    b_ms, by = max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else \
        "operations"
    ctas, lay, lanes = dma.grid(nb, nsc), dma.layout(), dma.table_lanes(nsc)
    moved = dma.traffic(counts, lanes, nsc, ctas)
    # what does not scale with the entries: every count 0 leaves the
    # table slices' load and each block's ray-row copy and store
    zeros = (torch.zeros_like(counts), sched, raysT, table)
    assert torch.equal(dma.smem_dma(*zeros), dma.plain(*zeros))
    own0 = queued_ms(lambda: dma.smem_dma(*zeros))
    loads = dma.warp_entries(counts, lanes, ctas, lay["warps"])
    bag = embedding_bag_call(args)
    lib_ms = cuda_ms(bag, iters=20)
    lib_err = float((bag() + raysT[:, 0, :] - po).abs().max()
                    / po.abs().max())
    print(f"[probe dma] city G-buffer rows (NB {nb}, NSC {nsc}, SW {sw}, "
          f"{live} live entries, {nbytes} B): call {k_ms:.4f} ms (device: "
          f"kernel {own:.4f} ms a launch, queued behind a spin: its only "
          f"launch), "
          f"plain {p_ms:.3f} ms, bound {b_ms:.4f} ms ({by}), kernel at "
          f"{100 * b_ms / own:.1f}% of the bound, embedding_bag "
          f"{lib_ms:.4f} ms (its sums + row 0 vs plain: max |err| / max "
          f"|out| {lib_err:.1e}); grid {ctas} CTAs of {lay['warps']} warps, "
          f"{lay['ring']} chunks of {lay['ch']} entries in flight a warp, "
          f"table slice of {lanes} lanes in shared memory; copied "
          f"{moved['copy_bytes']} B of live row prefixes (whole rows: "
          f"{nb * sw * 4} B) and {moved['ray_bytes']} B of ray rows 0, "
          f"table read from L2 {moved['table_bytes']} B; with every "
          f"count 0 the kernel takes {own0:.4f} ms; entries per warp (the "
          f"static round robin): busiest {int(loads.max())}, mean "
          f"{float(loads.float().mean()):.1f}; "
          f"kernel bit-equal to plain and the numpy check, and on the "
          f"forced grids  "
          f"[{card}]", flush=True)
    # a table no shared-memory slice holds: read from global memory
    big = dma.make_inputs(nb=64, nsc=2048, sw=2048, seed=SEED)
    big[0][0] = 2048
    bargs = [torch.from_numpy(a).to(dev) for a in big]
    kb = dma.smem_dma(*bargs)
    torch.cuda.synchronize()
    assert dma.table_lanes(2048) == 0
    assert torch.equal(kb, dma.plain(*bargs)), "smem_dma (global table)"
    np.testing.assert_array_equal(kb.cpu().numpy(),
                                  dma.numpy_reference(*big))
    same_on_grids(bargs, kb, "global table")
    print(f"[probe dma] NSC 2048 (no slice fits: the table read from "
          f"global memory), NB 64, a row live to its end: bit-equal to "
          f"plain and the numpy check on the default and forced grids")
    return k_ms, p_ms, b_ms, by, lib_ms, err


def forced_stream(earth, earth_sets, multi_cpu, dev, errs):
    """Earth forced onto the streaming route equals the resident kernels
    bit for bit; multi forced to M > 1 equals its plain version."""
    from fovtrace_torch.core.camera import Camera
    from fovtrace_torch.kernels import cluster_isect as ci

    saved = (ci._COEF_RESIDENT_BYTES, ci.MAX_SCHED)
    for name, (ro, rd, tmax) in earth_sets.items():
        raysT, _ = ci.pack_raysT(ro, rd, 1e-3, tmax)
        sched, counts, params = ci.cluster_schedule(raysT, earth.cluster_aabb)
        a = (raysT, earth.isect_coef, sched, counts, params)
        o = (raysT, earth.isect_coef, earth.isect_aux, sched, counts, params)
        kw = dict(rec=earth.isect_rec)
        res = (*ci.closest_hit(*a, **kw),
               *ci.occlusion(*o, tflags=earth.isect_tflags, **kw))
        ci._COEF_RESIDENT_BYTES = 0
        try:
            assert ci.route(earth.cluster_aabb.shape[0], 128) == "stream"
            st = (*ci.closest_hit(*a, **kw),
                  *ci.occlusion(*o, tflags=earth.isect_tflags, **kw))
            torch.cuda.synchronize()
            same = [torch.equal(x, y) for x, y in zip(res, st)]
            d = max(float((x - y).abs().max())
                    for x, y in zip(res[2:], st[2:]))
            print(f"[kernels] forced-stream earth {name}: stream == "
                  f"resident bit for bit (t, idx, ar, ag, ab): {same}; "
                  f"occlusion max |diff| {d:.3e}")
            assert all(same[:2]), f"forced-stream earth {name}: {same}"
            assert d <= 1e-6, f"forced-stream earth {name}: {d}"
        finally:
            ci._COEF_RESIDENT_BYTES = saved[0]
    ci.MAX_SCHED, ci._COEF_RESIDENT_BYTES = 4, 0
    try:
        multi = multi_cpu.with_pack().to(dev)   # repack under the grouping
        nc = multi.cluster_aabb.shape[0]
        print(f"[kernels] forced-stream multi: NC {nc}, M "
              f"{ci.pick_members(nc)}, route {ci.route(nc, 128)}")
        cam = Camera.create(eye=(3.0, 2.5, 4.0), target=(0.0, 0.8, 0.0),
                            device=dev)
        for name, (ro, rd, tmax) in ray_sets(multi, cam, dev).items():
            compare(f"multi M={ci.pick_members(nc)} {name}", multi, ro, rd,
                    1e-3, tmax, dev, errs)
    finally:
        ci._COEF_RESIDENT_BYTES, ci.MAX_SCHED = saved


def frame_parity(label, scene, cam):
    """A RES x RES frame with the kernels vs with the plain versions."""
    from fovtrace_torch.config import RenderConfig
    from fovtrace_torch.kernels import cluster_isect as ci
    from fovtrace_torch.render import pipeline

    small = RenderConfig(width=RES, height=RES, ray_budget_frac=0.6,
                         **GAZE_CFG)
    st = pipeline.FrameState.initial(cam, small)
    ci.reset_counters()
    ok, _ = pipeline.render_frame(scene, cam, (RES // 2, RES // 2), st, small)
    used = {k: v for k, v in ci.counters().items() if v}
    real = ci.closest_hit, ci.occlusion
    # the plain versions take no pack-time inputs
    ci.closest_hit = lambda *a, **kw: ci.closest_hit_plain(*a)
    ci.occlusion = lambda *a, **kw: ci.occlusion_plain(*a)
    try:
        op, _ = pipeline.render_frame(scene, cam, (RES // 2, RES // 2), st,
                                      small)
    finally:
        ci.closest_hit, ci.occlusion = real
    mae = float((ok["image"] - op["image"]).abs().mean())
    print(f"[parity] {label} {RES}x{RES} kernels {used} vs plain: ray_count "
          f"{int(ok['ray_count'])} / {int(op['ray_count'])}, image MAE "
          f"{mae:.3e}")
    assert int(ok["ray_count"]) == int(op["ray_count"])
    assert mae < 5e-3


def grad_norms(grads) -> str:
    return ", ".join(f"|d {k}| {float(g.norm()):.6e}" for k, g in grads.items())


def fwd_bwd(label, scene, cam, cfg, card, steps):
    """bench.py's fwd+bwd (pipeline.grad_step: the gradient of the mean
    image with respect to emission, kd, eye and target, the state of one
    earlier frame held constant) at cfg, one warm step and `steps` timed
    ones, each ending in a synchronise. The launch counts cover exactly
    the timed steps. Returns (grads of the last step, steady ms/step,
    state, counts per step)."""
    from fovtrace_torch import kernels
    from fovtrace_torch.kernels import cluster_isect as ci
    from fovtrace_torch.render import pipeline

    gaze = (H // 2, W // 2)
    with torch.no_grad():
        _, st = pipeline.render_frame(scene, cam, gaze,
                                      pipeline.FrameState.initial(cam, cfg),
                                      cfg)
    pipeline.grad_step(scene, cam, gaze, st, cfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    ci.reset_counters()
    ms = []
    for _ in range(steps):
        t0 = time.perf_counter()
        loss, grads, out = pipeline.grad_step(scene, cam, gaze, st, cfg)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    counts = ci.counters()
    inv_syncs = kernels.CALLS["inv4_host"] / steps
    peak = torch.cuda.max_memory_allocated() / 2**30
    rays = int(out["rays_traced"])
    steady = float(np.mean(ms))
    per_step = {k: v / steps for k, v in counts.items()}
    print(f"[{label}] steps {', '.join(f'{t:.2f}' for t in ms)} ms; steady "
          f"{steady:.2f} ms/step, rays_traced {rays} (forward), "
          f"{rays / steady / 1e3:.2f} Mrays/s; peak memory {peak:.2f} GiB "
          f"({base / 2**30:.2f} GiB before the steps); loss "
          f"{float(loss):.6f}  [{card}]")
    print(f"[{label}] {grad_norms(grads)}")
    print(f"[{label}] launches per step {json.dumps(per_step)}; camera "
          f"inverse host round trips (device syncs) per step {inv_syncs:g}")
    assert int(out["rays_dropped"]) == 0, "the budget truncated the mask"
    for k, g in grads.items():
        assert bool(torch.isfinite(g).all()), (k, g)
        assert float(g.abs().sum()) > 0, f"zero gradient for {k}"
    for k in PATH_PLAIN:
        assert counts.get(k, 0) == 0, (k, counts)
    return grads, steady, st, per_step, peak


def _parents(e):
    """A profiler event's enclosing CPU events, innermost first."""
    p = e.cpu_parent
    while p is not None:
        yield p
        p = p.cpu_parent


BWD_TAG = "autograd::engine::evaluate_function: "


def _port_frame(traceback_lines):
    """"fovtrace_torch/<file>:<line> <function>" of the innermost frame
    in the port's package of a formatted Python stack, else None."""
    for line in reversed(traceback_lines or ()):
        m = re.search(r'File "[^"]*/fovtrace_torch/([^"]+)", line (\d+), '
                      r"in (\S+)", line)
        if m:
            return f"fovtrace_torch/{m.group(1)}:{m.group(2)} {m.group(3)}"
    return None


@contextlib.contextmanager
def recording_sources(sources: dict):
    """Inside the block, autograd keeps each node's forward Python stack
    (anomaly mode, without its NaN checks), and every backward pass
    (torch.autograd.backward, which Tensor.backward calls, or
    torch.autograd.grad) first walks its graph and records, by each
    node's sequence number, the innermost frame of the port that made
    it (`_port_frame`) into `sources`. A backward function's profiler
    event carries the same sequence number. (The card's PyTorch records
    no Python frames in a with_stack profile.)"""
    real_backward, real_grad = torch.autograd.backward, torch.autograd.grad

    def walk(roots):
        roots = [roots] if isinstance(roots, torch.Tensor) else list(roots)
        todo = [t.grad_fn for t in roots if t.grad_fn is not None]
        seen = set()
        while todo:
            node = todo.pop()
            key = (node.name(), node._sequence_nr())
            if key in seen:
                continue
            seen.add(key)
            sources.setdefault(key[1], _port_frame(
                node.metadata.get("traceback_")))
            todo.extend(f for f, _ in node.next_functions if f is not None)

    def backward(tensors, *args, **kwargs):
        walk(tensors)
        return real_backward(tensors, *args, **kwargs)

    def grad(outputs, *args, **kwargs):
        walk(outputs)
        return real_grad(outputs, *args, **kwargs)

    torch.autograd.backward, torch.autograd.grad = backward, grad
    try:
        with torch.autograd.set_detect_anomaly(True, check_nan=False):
            yield
    finally:
        torch.autograd.backward, torch.autograd.grad = real_backward, \
            real_grad


def backward_attribution(prof, sources: dict) -> dict:
    """{(backward function, forward source): [device ms, calls]}: each
    top-level backward function of a profile (autograd's
    evaluate_function events; one nested in another counts in its outer
    one) with its device time, and the source that made its node, by
    sequence number (`recording_sources`)."""
    out = {}
    for e in prof.events():
        if e.name.startswith(BWD_TAG) and not any(
                p.name.startswith(BWD_TAG) for p in _parents(e)):
            key = (e.name[len(BWD_TAG):],
                   sources.get(e.sequence_nr) or "(no source in the port)")
            acc = out.setdefault(key, [0.0, 0])
            acc[0] += (e.device_time_total if hasattr(e, "device_time_total")
                       else e.cuda_time_total) / 1e3
            acc[1] += 1
    return out


def fwd_bwd_profile(label, step, steady_ms, card):
    """torch.profiler over one fwd+bwd step (`step()`): device kernels,
    summed device time split into forward and backward (the backward is
    what runs under autograd's evaluate_function events, a remat
    recompute included), the device's busy share of the unprofiled step,
    and the backward functions with the most device time, each with the
    forward source line whose op made it (`recording_sources`,
    `backward_attribution`). Returns that attribution."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    sources = {}
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]
                 ) as prof, recording_sources(sources):
        step()
        torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    kern = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and dev_us(e) > 0]
    total = sum(dev_us(e) for e in kern) / 1e3
    launched = sum(e.count for e in kern)
    bwd = backward_attribution(prof, sources)
    bwd_ms = sum(ms for ms, _ in bwd.values())
    print(f"[{label} profile] one step: {launched} device kernels, summed "
          f"device time {total:.2f} ms (forward {total - bwd_ms:.2f}, "
          f"backward {bwd_ms:.2f}) in a {wall:.2f} ms wall with the profiler "
          f"on; device busy {100 * total / steady_ms:.1f}% of the "
          f"{steady_ms:.2f} ms steady step  [{card}]")
    for (name, src), (ms, n) in sorted(bwd.items(),
                                       key=lambda kv: -kv[1][0])[:10]:
        print(f"[{label} profile]   backward {ms:8.2f} ms {n:4d} x "
              f"{name[:40]} <- {src}")
    index = {src: v for (name, src), v in bwd.items()
             if name == "IndexBackward0"}
    print(f"[{label} profile] IndexBackward0 by forward source: " + (
        "; ".join(f"{src}: {ms:.2f} ms in {n}" for src, (ms, n) in
                  sorted(index.items(), key=lambda kv: -kv[1][0]))
        or "none") + f"  [{card}]")
    top = sorted(kern, key=lambda e: -dev_us(e))[:6]
    for e in top:
        print(f"[{label} profile]   kernel {dev_us(e) / 1e3:8.2f} ms "
              f"{e.count:5d} x {e.key[:80]}")
    return bwd


# ---- the material table's lookup and its adjoint (csrc/material.cu) ------
# the CPU tests' shapes (tests/test_torch_material.py): (rays, materials,
# how the ids are drawn) at the shade's K = 21 and the surface's K = 4;
# then the bench front, seeded
MATERIAL_CASES = {"select-chain": (NCHK, 4, "uniform"),
                  "row-gather": (NCHK, 24, "uniform"),
                  "one-material": (NCHK, 4, "one"),
                  "misses": (NCHK, 4, "misses"),
                  "bench-front": (W * H, 4, "misses")}


def material_inputs(n, m, how, k, seed=SEED):
    """(ids [n] int32, table [m, k], cotangent [k, n]) on the card from a
    numpy seed; misses are clamped to row 0, as the render path does."""
    r = np.random.default_rng(seed)
    mat_id = r.integers(0, m, size=n).astype(np.int32)
    if how == "one":
        mat_id[:] = m - 2
    elif how == "misses":
        mat_id[r.random(n) < 0.7] = -1
    ids = torch.tensor(np.maximum(mat_id, 0), dtype=torch.int32,
                       device=DEVICE)
    table = torch.tensor(r.normal(size=(m, k)).astype(np.float32),
                         device=DEVICE)
    g = torch.tensor(r.normal(size=(k, n)).astype(np.float32), device=DEVICE)
    return ids, table, g


def capture_lookups(scene, cam, cfg):
    """The (ids, table) of each material lookup of one bench frame, in
    call order: [0] the G-buffer's surface columns (K = 4), then per
    bounce the surface's and the shade's (K = 21)."""
    from fovtrace_torch.kernels import material
    from fovtrace_torch.render import pipeline

    got, real = [], material.gather

    def recorder(ids, table):
        got.append((ids.clone(), table.detach().clone()))
        return real(ids, table)

    material.gather = recorder
    try:
        with torch.no_grad():
            pipeline.render_frame(scene, cam, (H // 2, W // 2),
                                  pipeline.FrameState.initial(cam, cfg), cfg)
        torch.cuda.synchronize()
    finally:
        material.gather = real
    return got


def check_material(label, ids, table, g):
    """The gather bit for bit its plain version; the adjoint within 1e-5
    x sum |g| of each entry's lanes, and the same bits on a second run.
    Returns (gather max abs err, adjoint max abs err, the adjoint's
    largest error over its tolerance)."""
    from fovtrace_torch.kernels import material

    m = table.shape[0]
    got = material.gather(ids, table)
    adj = [material.adjoint(ids, g, m) for _ in range(2)]
    torch.cuda.synchronize()
    want_g = material.gather_plain(ids, table)
    want_a = material.adjoint_plain(ids, g, m)
    scale = material.adjoint_plain(ids, g.abs(), m)
    g_err = float((got - want_g).abs().max())
    diff = (adj[0] - want_a).abs()
    a_err = float(diff.max())
    over = float((diff / (1e-5 * scale).clamp_min(1e-30)).max())
    same = torch.equal(adj[0], adj[1])
    print(f"[material] {label}: N {ids.shape[0]}, M {m}, K {table.shape[1]}: "
          f"gather max abs err {g_err:.3e} (bit for bit "
          f"{torch.equal(got, want_g)}), adjoint max abs err {a_err:.3e}, "
          f"{over:.3f} of the 1e-5 x sum |g| tolerance at worst, two runs "
          f"equal {same}")
    assert torch.equal(got, want_g), label
    assert bool((diff <= 1e-5 * scale).all()), label
    assert same, label
    return g_err, a_err, over


def material_bound(n, m, k) -> float:
    """ms to move what the gather (or the adjoint) must: n ids read, k x
    n floats written (read), the [m, k] table read (written), over the
    HBM rate; its operations (none, or one add per value) take far
    less at the float32 peak."""
    return (4 * n + 4 * k * n + 4 * m * k) / PEAK_BYTES * 1e3


def material_phase(earth, cam, cfg, card):
    """The material kernels against their plain versions at the CPU
    tests' shapes, the seeded bench front and the lookups of one earth
    bench frame (its G-buffer front and bounce 0's two); at the frame's
    shapes each kernel's time (CUDA events, 20 calls), its plain
    version's, its bound, and the library calls that compute the same:
    index_select + .T.contiguous() for the gather, index_add_ and the
    aten gather's backward (IndexBackward0) for the adjoint. Returns
    ({JSON name: (ms, plain_ms, bound_ms, bound_by, library_ms)}, {JSON
    name: max abs err})."""
    from fovtrace_torch.kernels import material

    errs = {"material_lookup": 0.0, "material_lookup_adjoint": 0.0}
    for case, (n, m, how) in MATERIAL_CASES.items():
        for k in (21, 4):
            ge, ae, _ = check_material(f"{case} K {k}",
                                       *material_inputs(n, m, how, k))
            errs["material_lookup"] = max(errs["material_lookup"], ge)
            errs["material_lookup_adjoint"] = max(
                errs["material_lookup_adjoint"], ae)
    lookups = capture_lookups(earth, cam, cfg)
    shapes = {"G-buffer": lookups[0], "bounce-0 surface": lookups[1],
              "bounce-0 shade": lookups[2]}
    assert [t.shape[1] for _, t in shapes.values()] == [4, 4, 21], \
        [t.shape for _, t in shapes.values()]
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    rows = {}
    for label, (ids, table) in shapes.items():
        n, (m, k) = ids.shape[0], table.shape
        g = torch.randn((k, n), generator=gen, device=DEVICE)
        ge, ae, _ = check_material(f"{label} of the earth bench frame", ids,
                                   table, g)
        errs["material_lookup"] = max(errs["material_lookup"], ge)
        errs["material_lookup_adjoint"] = max(
            errs["material_lookup_adjoint"], ae)
        lids = ids.long()
        leaf = table.clone().requires_grad_(True)
        gT = g.T
        times = {
            "gather": cuda_ms(lambda: material.gather(ids, table), iters=20),
            "gather plain": cuda_ms(lambda: material.gather_plain(ids, table),
                                    iters=3),
            "index_select": cuda_ms(lambda: torch.index_select(
                table, 0, lids).T.contiguous(), iters=20),
            "adjoint": cuda_ms(lambda: material.adjoint(ids, g, m), iters=20),
            "adjoint plain": cuda_ms(
                lambda: material.adjoint_plain(ids, g, m), iters=3),
            "index_add_": cuda_ms(lambda: torch.zeros(
                (m, k), device=DEVICE).index_add_(0, lids, gT), iters=20),
            "IndexBackward0": cuda_ms(lambda: torch.autograd.grad(
                leaf[lids], leaf, gT), iters=3)}
        bound_ms = material_bound(n, m, k)
        print(f"[material] {label} N {n}, M {m}, K {k}: " + ", ".join(
            f"{name} {ms:.4f}" for name, ms in times.items())
            + f" ms; bound {bound_ms:.4f} ms (bytes) each way  [{card}]")
        rows[label] = (times, bound_ms)
    times, bound_ms = rows["G-buffer"]
    row = {"material_lookup": (times["gather"], times["gather plain"],
                               bound_ms, "bytes", times["index_select"]),
           "material_lookup_adjoint": (
               times["adjoint"], times["adjoint plain"], bound_ms, "bytes",
               times["index_add_"])}
    return row, errs


# ---- the envmap's bilinear lookup and its adjoint (csrc/envmap.cu) -------
# (map [h, w] and its fill, rays, how the coordinates are drawn): the CPU
# tests' maps with their directions (tests/test_torch_envmap.py), then
# seeded worst cases at the 1920x1088 front: every ray in one texel,
# uniform rays, 70% zero cotangent (a hit's), and a file scene's HDR map
ENVMAP_CASES = {"8x16": ((8, 16), "exponential", NCHK, "directions"),
                "64x128": ((64, 128), "checker", NCHK, "directions"),
                "5x7": ((5, 7), "exponential", NCHK, "directions"),
                "one-texel": ((64, 128), "checker", W * H, "one"),
                "uniform": ((64, 128), "checker", W * H, "uniform"),
                "misses": ((64, 128), "checker", W * H, "misses"),
                "hdr": ((800, 1600), "exponential", W * H, "uniform")}
# both poles, the seam (either sign of zero), a zero, a NaN and +-inf
ENVMAP_SPECIAL = np.array(
    [[0, 0, 0, -0.0, 0, np.nan, np.inf, -np.inf, np.inf, 0, 1, -1],
     [1, -1, 0.3, 0.3, 0, 0, 0, 0, np.inf, -np.inf, 0, 0],
     [0, 0, -1, -1, 0, 0, 0, 1, np.inf, 0, -0.0, -0.0]], np.float32)


def envmap_inputs(case, seed=SEED):
    """(fx, fy [n], map [h, w, 3], cotangent [3, n]) on the card from a
    numpy seed; "directions" (unit vectors after the special ones) go
    through the render path's texel coordinates."""
    from fovtrace_torch.core.vec import Vec3
    from fovtrace_torch.render import shade
    from fovtrace_torch.scene import procedural

    (h, w), fill, n, how = ENVMAP_CASES[case]
    r = np.random.default_rng(seed)
    env = (procedural.checker_envmap(h, w) if fill == "checker" else
           r.exponential(size=(h, w, 3)).astype(np.float32))
    g = r.normal(size=(3, n)).astype(np.float32)
    t = lambda a: torch.tensor(a, device=DEVICE)
    if how == "directions":
        d = r.normal(size=(3, n))
        d = (d / np.linalg.norm(d, axis=0)).astype(np.float32)
        d[:, :ENVMAP_SPECIAL.shape[1]] = ENVMAP_SPECIAL
        fx, fy = shade.envmap_texel_coords(Vec3(*[t(d[k]) for k in range(3)]),
                                           h, w)
        return fx, fy, t(env), t(g)
    if how == "one":
        fx, fy = 70 + r.random(n, np.float32), 20 + r.random(n, np.float32)
    else:
        fx = r.random(n, np.float32) * (w - 1)
        fy = r.random(n, np.float32) * (h - 1)
        if how == "misses":
            g[:, r.random(n) < 0.7] = 0.0
    return t(fx), t(fy), t(env), t(g)


def same_values(a, b) -> bool:
    """Equal values, NaN where the other has NaN."""
    nan = torch.isnan(a)
    return torch.equal(nan, torch.isnan(b)) and torch.equal(a[~nan], b[~nan])


def envmap_adjoint_error(got, fx, fy, g, h, w, scale):
    """A map adjoint `got` against the plain version's: (inf and NaN where
    it has them, the finite entries' max abs err, their largest error
    over 1e-5 x sum |g w| of the entry's terms, the nonfinite entries)."""
    from fovtrace_torch.kernels import envmap

    want = envmap.adjoint_plain(fx, fy, g, h, w, scale)
    # sum |g w| per entry: the weights are >= 0 for coordinates on the map
    tol = 1e-5 * envmap.adjoint_plain(fx, fy, g.abs(), h, w, scale)
    fin = torch.isfinite(want)
    diff = (got - want).abs()[fin]
    over = diff / tol[fin].clamp_min(1e-30)
    top = lambda t: float(t.max()) if t.numel() else 0.0
    return (same_values(torch.where(fin, 0.0, got), torch.where(fin, 0.0, want)),
            top(diff), top(over), int((~fin).sum()))


def check_envmap(label, fx, fy, env, g, scale):
    """The lookup and d(fx, fy) bit for bit their plain versions (NaN
    where they have NaN); the adjoint within 1e-5 x sum |g w| of each
    entry's terms (inf and NaN where the plain version has them), and
    the same bits on a second run. Returns ({JSON name: max abs err},
    the adjoint's largest error over its tolerance)."""
    from fovtrace_torch.kernels import envmap

    h, w = env.shape[:2]
    out = envmap.lookup(fx, fy, env, scale)
    dfx, dfy = envmap.dxy(fx, fy, env, g, scale)
    adj = [envmap.adjoint(fx, fy, g, h, w, scale) for _ in range(2)]
    torch.cuda.synchronize()
    want = envmap.lookup_plain(fx, fy, env, scale)
    want_x, want_y = envmap.dxy_plain(fx, fy, env, g, scale)
    nonfinite_same, a_err, over, nonfinite = envmap_adjoint_error(
        adj[0], fx, fy, g, h, w, scale)
    same = torch.equal(adj[0].view(torch.int32), adj[1].view(torch.int32))
    err = lambda a, b: float(torch.nan_to_num((a - b).abs(), 0.0).max()) \
        if a.numel() else 0.0
    errs = {"envmap_lookup": err(out, want),
            "envmap_dxy": max(err(dfx, want_x), err(dfy, want_y)),
            "envmap_adjoint": a_err}
    print(f"[envmap] {label}: N {fx.shape[0]}, map {h}x{w}: lookup bit for "
          f"bit {same_values(out, want)}, d(fx, fy) bit for bit "
          f"{same_values(dfx, want_x) and same_values(dfy, want_y)}; adjoint "
          f"max abs err {a_err:.3e}, {over:.3e} of the 1e-5 x sum |g w| "
          f"tolerance at worst, {nonfinite} nonfinite entries (as the plain "
          f"version's {nonfinite_same}), two runs equal {same}")
    assert same_values(out, want), label
    assert same_values(dfx, want_x) and same_values(dfy, want_y), label
    assert nonfinite_same and over <= 1.0, (label, over)
    assert same, label
    return errs, over


def capture_envmap(earth, cam, cfg, mesh_dev):
    """The lookups of one earth bench frame ([(fx, fy, map)] per bounce)
    and the adjoints of one dense train step at W x H ([(fx, fy, g, h, w,
    scale)] per bounce, the real cotangents), recorded at the wrappers."""
    from fovtrace_torch.config import RenderConfig
    from fovtrace_torch.core.camera import Camera
    from fovtrace_torch.dist import sharding as shd
    from fovtrace_torch.dist import train
    from fovtrace_torch.kernels import envmap
    from fovtrace_torch.render import pipeline

    looked, adjoints = [], []
    real_lookup, real_adjoint = envmap.lookup, envmap.adjoint

    def lookup(fx, fy, env, scale):
        looked.append((fx.clone(), fy.clone(), env.detach().clone(), scale))
        return real_lookup(fx, fy, env, scale)

    def adjoint(fx, fy, g, h, w, scale):
        adjoints.append((fx.clone(), fy.clone(), g.clone(), h, w, scale))
        return real_adjoint(fx, fy, g, h, w, scale)

    envmap.lookup, envmap.adjoint = lookup, adjoint
    try:
        with torch.no_grad():
            pipeline.render_frame(earth, cam, (H // 2, W // 2),
                                  pipeline.FrameState.initial(cam, cfg), cfg)
        frame = list(looked)
        tcfg = RenderConfig(width=W, height=H, max_depth=2,
                            diffuse_max_depth=1, reconstruction="none")
        tcam = Camera.create(eye=TRAIN_EYE, target=TRAIN_TARGET,
                             device=mesh_dev)
        true = train.init_params(earth, tcam)
        with torch.no_grad():
            target = train.render_rows_dense(earth, tcam, true, 0, H, tcfg, 0)
        params = train.leaves(true.replace(eye=true.eye + 0.25))
        train.make_loss_and_grad(earth, tcam, tcfg,
                                 shd.make_mesh(None, mesh_dev))(params,
                                                                target, 1)
        torch.cuda.synchronize()
    finally:
        envmap.lookup, envmap.adjoint = real_lookup, real_adjoint
    return frame, adjoints[::-1]     # the backward runs the last bounce first


def envmap_bound(n, h, w, kind) -> float:
    """ms to move what each kernel must, over the HBM rate: fx and fy read
    (8 B a ray); the lookup writes [3, n] and reads the map, d(fx, fy)
    reads the [3, n] cotangent and the map and writes two floats a ray,
    the adjoint reads the cotangent and writes the map. Their operations
    (a few dozen float operations a ray) take far less at the float32
    peak."""
    per_ray = {"lookup": 8 + 12, "dxy": 8 + 12 + 8, "adjoint": 8 + 12}[kind]
    return (per_ray * n + 12 * h * w) / PEAK_BYTES * 1e3


def envmap_phase(earth, cam, cfg, card):
    """The envmap kernels against their plain versions at the CPU tests'
    shapes, the seeded worst cases and the lookups of one earth bench
    frame and one dense train step (its real cotangents); at the bench
    frame's bounce 0 and the train step's bounce 0 each kernel's time
    (CUDA events), its plain version's, its bound and the library calls
    that compute the same (grid_sample for the lookup; its backward's d
    grid for d(fx, fy); index_add_ of the four taps' terms, grid_sample's
    d input and the four-gather expression's IndexBackward0 for the
    adjoint); the host's ms for one lookup's forward and backward in the
    fwd+bwd step, the Function against the expression it replaced. Returns ({JSON name: (ms, plain_ms, bound_ms, bound_by,
    library_ms)}, {JSON name: max abs err})."""
    import torch.nn.functional as F

    from fovtrace_torch.kernels import envmap

    errs = dict.fromkeys(("envmap_lookup", "envmap_dxy", "envmap_adjoint"),
                         0.0)

    def keep(e):
        for k, v in e.items():
            errs[k] = max(errs[k], v)

    for case in ENVMAP_CASES:
        keep(check_envmap(case, *envmap_inputs(case), cfg.envmap_scale)[0])
    frame, adjoints = capture_envmap(earth, cam, cfg, cam.device)
    assert len(frame) == cfg.max_depth and len(adjoints) == 2, \
        (len(frame), len(adjoints))
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    for b, (fx, fy, env, scale) in enumerate(frame):
        g = torch.randn((3, fx.shape[0]), generator=gen, device=DEVICE)
        keep(check_envmap(f"bench frame bounce {b}", fx, fy, env, g,
                          scale)[0])
    for b, (fx, fy, g, h, w, scale) in enumerate(adjoints):
        keep(check_envmap(f"dense train step bounce {b} (its cotangent)", fx,
                          fy, earth.envmap.contiguous(), g, scale)[0])
    rows = {}
    shapes = {"bench frame bounce 0": (*frame[0][:3],
                                       torch.randn((3, frame[0][0].shape[0]),
                                                   generator=gen,
                                                   device=DEVICE)),
              "dense train step bounce 0": (adjoints[0][0], adjoints[0][1],
                                            earth.envmap.contiguous(),
                                            adjoints[0][2])}
    scale = cfg.envmap_scale
    for label, (fx, fy, env, g) in shapes.items():
        n, (h, w) = fx.shape[0], env.shape[:2]
        # the library yardsticks: grid_sample's bilinear border lookup at
        # the same texel coordinates; the four taps' terms added by one
        # index_add_; autograd's backward of the four row gathers
        grid = torch.stack([fx / (w - 1) * 2 - 1, fy / (h - 1) * 2 - 1],
                           -1).view(1, 1, n, 2)
        img = env.permute(2, 0, 1)[None].contiguous()
        taps = envmap.tap_terms(fx, fy, g, h, w, scale)
        chan = torch.arange(3, device=DEVICE)
        idx = torch.cat([(t[:, None] * 3 + chan).reshape(-1) for t, _ in taps])
        vals = torch.cat([v.T.reshape(-1) for _, v in taps])
        leaf = env.clone().requires_grad_(True)
        x0, x1, y0, y1, _, _ = envmap._taps(fx, fy, h, w)

        def gathers():
            flat = leaf.reshape(-1, 3)
            return torch.stack([flat[y0 * w + x0], flat[y0 * w + x1],
                                flat[y1 * w + x0], flat[y1 * w + x1]])

        picked = gathers()
        gt = torch.ones_like(picked)
        # grid_sample's backward: d input is the map's adjoint, d grid is
        # d(fx, fy) times (w - 1) / 2 and (h - 1) / 2
        gs = (g * scale).view(1, 3, 1, n)
        gsb = lambda mask: torch.ops.aten.grid_sampler_2d_backward(
            gs, img, grid, 0, 1, True, mask)
        # (call, its CUDA-event iterations): the kernels and library calls
        # 20, the plain versions and IndexBackward0 3
        calls = {
            "lookup": (lambda: envmap.lookup(fx, fy, env, scale), 20),
            "lookup plain": (
                lambda: envmap.lookup_plain(fx, fy, env, scale), 3),
            "grid_sample": (lambda: F.grid_sample(
                img, grid, mode="bilinear", padding_mode="border",
                align_corners=True), 20),
            "dxy": (lambda: envmap.dxy(fx, fy, env, g, scale), 20),
            "dxy plain": (
                lambda: envmap.dxy_plain(fx, fy, env, g, scale), 3),
            "grid_sampler_2d_backward d grid": (
                lambda: gsb([False, True]), 20),
            "adjoint": (
                lambda: envmap.adjoint(fx, fy, g, h, w, scale), 20),
            "adjoint plain": (
                lambda: envmap.adjoint_plain(fx, fy, g, h, w, scale), 3),
            "index_add_": (lambda: torch.zeros(
                h * w * 3, device=DEVICE).index_add_(0, idx, vals), 20),
            "grid_sampler_2d_backward d input": (
                lambda: gsb([True, False]), 20),
            "IndexBackward0": (lambda: torch.autograd.grad(
                picked, leaf, gt, retain_graph=True), 3)}
        times = {k: cuda_ms(fn, it) for k, (fn, it) in calls.items()}
        # the kernels and library calls again, queued behind a spin: the
        # card's time alone, without the host's per call
        queued = {k: queued_ms(fn) for k, (fn, it) in calls.items()
                  if it == 20}
        bounds = {k: envmap_bound(n, h, w, k)
                  for k in ("lookup", "dxy", "adjoint")}
        live = int((g != 0).any(0).sum())
        print(f"[envmap] {label}: N {n} ({live} with a nonzero cotangent), "
              f"map {h}x{w}: " + ", ".join(f"{k} {ms:.4f}"
                                          for k, ms in times.items())
              + " ms; bounds (bytes) " + ", ".join(
                  f"{k} {ms:.4f}" for k, ms in bounds.items())
              + f" ms  [{card}]")
        print(f"[envmap] {label}: queued behind a spin (device ms a call): "
              + ", ".join(f"{k} {ms:.4f}" for k, ms in queued.items()))
        # the library's d grid against d(fx, fy) where no edge clamps
        dfx, dfy = envmap.dxy(fx, fy, env, g, scale)
        dgrid = gsb([False, True])[1].view(n, 2)
        inner = (fx > 0) & (fx < w - 1) & (fy > 0) & (fy < h - 1) & \
            ((dfx != 0) | (dfy != 0))
        # (a map that varies along one axis has d fx = 0 exactly: one scale
        # for both)
        d_lib = torch.stack([dgrid[:, 0] * (2 / (w - 1)),
                             dgrid[:, 1] * (2 / (h - 1))])[:, inner]
        d_own = torch.stack([dfx, dfy])[:, inner]
        lib_err = float((d_lib - d_own).abs().max()
                        / d_own.abs().max().clamp_min(1e-30)) \
            if bool(inner.any()) else 0.0
        print(f"[envmap] {label}: grid_sampler_2d_backward's d grid against "
              f"d(fx, fy) on the {int(inner.sum())} lanes off the edges: "
              f"max abs diff {lib_err:.3e} of the largest")
        rows[label] = (times, bounds)
    # the host's cost of one lookup's forward and backward as the fwd+bwd
    # step runs it (d(fx, fy), no map gradient): the Function against the
    # four-gather expression it replaced
    fx, fy, env, _ = shapes["bench frame bounce 0"]
    fxl, fyl = (t.clone().requires_grad_(True) for t in (fx, fy))
    g = torch.randn((3, fx.shape[0]), generator=gen, device=DEVICE)
    host = {"EnvmapLookup": lambda: torch.autograd.grad(
                envmap.EnvmapLookup.apply(fxl, fyl, env, scale), (fxl, fyl),
                g),
            "four-gather expression": lambda: torch.autograd.grad(
                envmap.lookup_plain(fxl, fyl, env, scale), (fxl, fyl), g)}
    host = {k: host_ms(fn) for k, fn in host.items()}
    more = cfg.max_depth * (host["EnvmapLookup"]
                            - host["four-gather expression"])
    print("[envmap] host ms per lookup forward + backward (d(fx, fy)) at the "
          "bench frame's bounce 0: " + ", ".join(
              f"{k} {ms:.4f}" for k, ms in host.items())
          + f"; {cfg.max_depth} a fwd+bwd step: {more:+.4f} ms/step  "
          f"[{card}]")
    times, bounds = rows["dense train step bounce 0"]
    row = {"envmap_lookup": (times["lookup"], times["lookup plain"],
                             bounds["lookup"], "bytes", times["grid_sample"]),
           "envmap_dxy": (times["dxy"], times["dxy plain"], bounds["dxy"],
                          "bytes", times["grid_sampler_2d_backward d grid"]),
           "envmap_adjoint": (times["adjoint"], times["adjoint plain"],
                              bounds["adjoint"], "bytes",
                              times["index_add_"])}
    return row, errs


def golden_grad_parity(earth, cam):
    """tests/golden/earth.npz's gradient fingerprint, from the golden's
    loss (the mean image of one 64x64 frame started from the
    differentiated camera), at the golden's rtol 2e-3."""
    from fovtrace_torch.config import RenderConfig
    from fovtrace_torch.render import pipeline

    ref = np.load(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                               "tests", "golden", "earth.npz"))
    gcfg = RenderConfig(width=64, height=64, reconstruction="atrous",
                        max_depth=3, diffuse_max_depth=1, ray_budget_frac=0.6)
    _, g, _ = pipeline.grad_step(earth, cam, (32, 32), None, gcfg)
    fp = np.asarray([f(g[k]) for k in ("emission", "kd", "eye")
                     for f in (lambda t: float(t.norm()),
                               lambda t: float(t.mean()))])
    want = ref["grad_fp"]
    rel = np.abs(fp - want) / np.abs(want)
    print(f"[grad parity] 64x64 earth grad_fp {np.array2string(fp, precision=6)}"
          f" vs golden {np.array2string(want, precision=6)}: max relative "
          f"error {rel.max():.3e} (rtol 2e-3)")
    np.testing.assert_allclose(fp, want, rtol=2e-3, atol=1e-7)


MODES = (("jfa", dict(reconstruction="jfa")),
         ("sibson", dict(reconstruction="sibson", sibson_max_radius=16)),
         ("all", dict(reconstruction="all", sibson_max_radius=16)),
         ("weier", dict(sampling_mode="weier")),
         ("author", dict(sampling_mode="author")),
         ("logpolar", dict(sampling_mode="logpolar")))


def modes(earth, cam, card):
    """Earth at W x H in each sampling mode and reconstruction the bench
    does not run: budget sized by a probe frame, one warm frame, one
    timed frame, then its stage times."""
    from fovtrace_torch.render import pipeline

    gaze = (H // 2, W // 2)
    for name, extra in MODES:
        need, frac, cfg = bench_probe_frac(earth, cam, **extra)
        st = pipeline.FrameState.initial(cam, cfg)
        _, st = pipeline.render_frame(earth, cam, gaze, st, cfg)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out, st = pipeline.render_frame(earth, cam, gaze, st, cfg)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        img = torch.stack(list(out["image_rgb"]))
        print(f"[modes] {name}: mask {100 * need:.2f}% -> ray_budget_frac "
              f"{frac}; frame {ms:.2f} ms, rays_traced "
              f"{int(out['rays_traced'])}, rays_dropped "
              f"{int(out['rays_dropped'])}, image mean {float(img.mean()):.4f}"
              f"  [{card}]")
        print(f"[modes] {name} stages: "
              f"{fmt_stages(stage_times(earth, cam, cfg, st, gaze))}")
        assert int(out["rays_dropped"]) == 0, name
        assert bool(torch.isfinite(img).all()), name


def mode_goldens(earth, cam):
    """The three 64x64 mode goldens on the card. earth_jfa is held to its
    golden. earth_sibson and earth_logpolar are stale: the reference's own
    frames miss them (sibson max 0.118; log-polar masks 1,235 pixels, the
    golden 4,095), so the card's frames are held to the port's CPU
    frames, which the CPU tests hold to the jitted reference."""
    from fovtrace_torch.config import RenderConfig
    from fovtrace_torch.core.camera import Camera
    from fovtrace_torch.render import pipeline

    root = os.path.dirname(os.path.abspath(__file__))
    cam_cpu = Camera.create(eye=(3.0, 2.5, 4.0), target=(0.0, 0.8, 0.0),
                            device="cpu")
    earth_cpu = earth.to("cpu")
    for name in ("earth_jfa", "earth_sibson", "earth_logpolar"):
        ref = np.load(os.path.join(root, "tests", "golden", f"{name}.npz"))
        spec = json.loads(str(ref["spec"]))
        kw = dict(width=64, height=64, reconstruction="atrous", max_depth=3,
                  diffuse_max_depth=1, ray_budget_frac=0.6)
        kw.update({k: v for k, v in spec.items() if k != "scene"})
        cfg = RenderConfig(**kw)
        frames = []
        for sc, cm in ((earth, cam), (earth_cpu, cam_cpu)):
            st = pipeline.FrameState.initial(cm, cfg)
            for _ in range(2):
                out, st = pipeline.render_frame(sc, cm, (32, 32), st, cfg)
            frames.append((out["image"].cpu().numpy(), int(out["ray_count"])))
        (img, rc), (cpu_img, cpu_rc) = frames
        golden = ref["image"].astype(np.float32)
        want, want_rc, against = (golden, int(ref["ray_count"]), "golden") \
            if name == "earth_jfa" else (cpu_img, cpu_rc, "CPU port frame")
        err = np.abs(img - want)
        gerr = np.abs(img - golden)
        print(f"[modes golden] {name}: vs the {against} ray_count {rc} / "
              f"{want_rc}, MAE {err.mean():.3e}, max {err.max():.3e}, pixels "
              f"> 0.1: {int((err.max(-1) > 0.1).sum())}; vs the golden "
              f"ray_count {rc} / {int(ref['ray_count'])}, MAE "
              f"{gerr.mean():.3e}, max {gerr.max():.3e}")
        assert rc == want_rc, name
        assert err.mean() < 5e-3 and err.max() < 0.1, name


# ---- what foveation buys: the quality harness, the sweep, the scaling bench
QUALITY_W, QUALITY_H = 960, 544   # scripts/quality_eval.py's defaults
QUALITY_FRAMES, QUALITY_WARMUP = 20, 8
# the masked frame's ray % at that configuration from the port's plain
# versions on a CPU (fixed centre gaze, aperture 0.07, two frames; the
# JAX reference's masks are the same bit for bit)
CPU_RAY_PCT = 12.95


def path_launches(label, counts, kernels=("closest_hit", "occlusion")):
    """Print a path's counts; fail unless each of `kernels` launched and
    no plain version, brute oracle or bvh traversal ran."""
    print(f"[{label}] counts during the run: "
          f"{json.dumps({k: v for k, v in counts.items() if v})}")
    for k in kernels:
        assert counts.get(k, 0) > 0, (label, k, counts)
    for k in PATH_PLAIN:
        assert counts.get(k, 0) == 0, (label, k, counts)


def quality_phase(earth, cam, card):
    """quality_eval's --quick rows at its full size: masked x {pullpush,
    atrous} against the full-sampling ground truth, 20 frames of the
    fixed centre gaze, 8 of warm-up. No ray dropped (quality_rows
    raises), and masked x pullpush's fovea at 99.0 dB: every fovea pixel
    bit for bit the ground truth's."""
    from fovtrace_torch.app import trajectory
    from fovtrace_torch.kernels import cluster_isect as ci
    from fovtrace_torch.scripts import quality_eval as qe

    w, h = QUALITY_W, QUALITY_H
    gazes, _ = trajectory.make("fixed", h, w, QUALITY_FRAMES)
    base = dict(width=w, height=h, max_depth=4, diffuse_max_depth=1,
                aperture=0.07, ray_budget_frac=0.55, full_outputs=False)
    torch.cuda.synchronize()
    ci.reset_counters()
    t0 = time.perf_counter()
    rows = qe.quality_rows(earth, cam, gazes, base, qe.QUICK_MODES,
                           qe.QUICK_RECONS, QUALITY_WARMUP, DEVICE)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    path_launches("quality", ci.counters())
    for r in rows:
        print(f"[quality] {json.dumps(r)}")
        print(f"[quality] {r['mode']} x {r['recon']}: ray % "
              f"{r['ray_pct']:.4f} on the card, {CPU_RAY_PCT} on a CPU "
              f"(plain versions)  [{card}]")
        assert all(np.isfinite(v) for k, v in r.items()
                   if k not in ("mode", "recon")), r
    print(f"[quality] {QUALITY_FRAMES} ground-truth frames and "
          f"{len(rows)} x {QUALITY_FRAMES} foveated frames at {w}x{h} with "
          f"their metrics: {secs:.2f} s  [{card}]")
    pp = {r["recon"]: r for r in rows}["pullpush"]
    # the fovea pixel by pixel: the two runs again, every frame compared
    from fovtrace_torch.config import RenderConfig

    gt, _ = qe.render_run(earth, cam, gazes, RenderConfig(
        **{**base, "ray_budget_frac": 1.0}, sampling_mode="full",
        reconstruction="none"))
    fov, _ = qe.render_run(earth, cam, gazes, RenderConfig(
        **base, sampling_mode="masked", reconstruction="pullpush"))
    fovea = qe.annulus_masks(h, w, gazes[0], base["aperture"], DEVICE)[0]
    differ = [int(((a.clamp(0, 1) != b.clamp(0, 1)).any(-1) & fovea).sum())
              for a, b in zip(fov, gt)]
    worst = max(float(((a.clamp(0, 1) - b.clamp(0, 1)).abs().amax(-1)
                       * fovea).max()) for a, b in zip(fov, gt))
    print(f"[quality] masked x pullpush: fovea {pp['psnr_fovea']} dB over "
          f"frames {QUALITY_WARMUP}-{QUALITY_FRAMES - 1}; of its "
          f"{int(fovea.sum())} pixels, those that differ from the ground "
          f"truth in frames 0-{QUALITY_FRAMES - 1}: {differ} (largest "
          f"difference {worst:.3e})")
    assert pp["psnr_fovea"] == 99.0, pp


def sweep_phase(earth, cam, card):
    """aperture_sweep's six apertures at W x H, 3 timed frames each."""
    from fovtrace_torch.kernels import cluster_isect as ci
    from fovtrace_torch.scripts import aperture_sweep as sw

    torch.cuda.synchronize()
    ci.reset_counters()
    rows = sw.sweep_rows(earth, cam, W, H, sw.APERTURES, iters=3)
    torch.cuda.synchronize()
    path_launches("sweep", ci.counters())
    for r in rows:
        print(f"[sweep] {json.dumps(r)}  [{card}]")
        assert r["rays_traced"] > 0 and np.isfinite(r["frame_ms"]), r
    pct = [r["ray_pct"] for r in rows]
    assert pct == sorted(pct), "the mask must grow with the aperture"


def scaling_phase(tmp, card):
    """scaling_bench's groups: one NCCL rank at W x H, then one and two
    gloo ranks sharing the card at DIST_RES (rank processes of the
    script; rank 0's launch counts come back in its row)."""
    from fovtrace_torch.scripts import scaling_bench as sb

    for argv in (["--ranks", "1", "--width", str(W), "--height", str(H)],
                 ["--ranks", "1", "2", "--backend", "gloo", "--width",
                  str(DIST_RES), "--height", str(DIST_RES)]):
        args = sb.build_argparser().parse_args(
            [*argv, "--iters", "3", "--out", tmp])
        rows = sb.scaling_rows(args)
        assert [r["ranks"] for r in rows] == args.ranks, rows
        for r in rows:
            print(f"[scaling] {json.dumps(r)}")
            path_launches(f"scaling {sb.backend_of(args)} {r['ranks']}",
                          r["launches"])
            assert r["rays_dropped"] == 0 and r["rays_traced"] > 0, r
        print("\n".join(f"[scaling] {line}" for line in
                        sb.report(args, rows).splitlines() if line))
    print(f"[scaling] the parent's card: {card}")


# ---- the row-sharded frame, the train step, app/optimize ------------------
DIST_RES = 256          # the 2-rank checks' frame side
# tests/test_dist.py's tolerance, sharded frame against the single frame
DIST_RTOL, DIST_ATOL = 2e-4, 2e-5
TRAIN_EYE, TRAIN_TARGET = (3.0, 2.5, 4.0), (0.0, 0.6, 0.0)   # optimize's
CLUSTER_KERNELS = ("closest_kernel", "occlusion_kernel",
                   "closest_stream_kernel", "occlusion_stream_kernel")


def cluster_device_ms(fn) -> dict:
    """The four cluster kernels' summed device ms in one call of fn."""
    ms = device_ms(fn)
    out = {}
    for k in CLUSTER_KERNELS:
        # "closest_kernel" is no substring of "closest_stream_kernel"
        out[k] = sum(v for name, v in ms.items() if k in name)
    return out


def launches_since(before: dict) -> dict:
    from fovtrace_torch.kernels import cluster_isect as ci

    return {k: v - before.get(k, 0) for k, v in ci.counters().items()}


def check_frame(label, got, want, got_state, want_state, exact=True):
    """A sharded frame against render_frame's: the counters, then the
    mask bit for bit and the image and history at tests/test_dist.py's
    tolerance (exact), or (not exact: the streaming kernels may pick
    another of two triangles hit at the same t when the ray blocks
    differ) the image within the golden frames' tolerance, MAE < 5e-3,
    and fewer than 0.1% of the mask's pixels flipped. Returns (mask
    pixels that differ, pixels whose G-buffer normal differs)."""
    assert int(got["ray_count"]) == int(want["ray_count"]) or not exact, \
        label
    assert int(got["rays_dropped"]) == 0 == int(want["rays_dropped"]), label
    flips = int((got["mask"] != want["mask"]).sum())
    normals = int((got["normal"] != want["normal"]).any(-1).sum())
    if exact:
        assert flips == 0, f"{label}: mask differs"
        torch.testing.assert_close(got["image"], want["image"],
                                   rtol=DIST_RTOL, atol=DIST_ATOL,
                                   msg=f"{label}: image")
        torch.testing.assert_close(got_state.history, want_state.history,
                                   rtol=DIST_RTOL, atol=DIST_ATOL,
                                   msg=f"{label}: history")
    else:
        mae = float((got["image"] - want["image"]).abs().mean())
        assert mae < 5e-3 and flips < 1e-3 * got["mask"].numel(), \
            (label, mae, flips)
    return flips, normals


def dist_one_rank(label, scene, cam, cfg, mesh, card, frames, exact=True):
    """`frames` circle-gaze frames through render_sharded on `mesh` and
    through render_frame, in turns, each ending in a synchronise; then
    the four cluster kernels' device time in one frame of each (row-major
    ray blocks against 16x16 tiles). Returns the sharded frames' launch
    counts."""
    from fovtrace_torch.app import trajectory
    from fovtrace_torch.dist import sharding as shd
    from fovtrace_torch.render import pipeline

    cfg = cfg.replace(full_outputs=True)
    gazes, _ = trajectory.make("circle", H, W, frames)
    st1 = pipeline.FrameState.initial(cam, cfg)
    stn = shd.initial_state_sharded(cam, cfg, mesh)
    ms1, msn, counts = [], [], {}
    for f, gaze in enumerate(gazes):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        o1, st1 = pipeline.render_frame(scene, cam, gaze, st1, cfg)
        torch.cuda.synchronize()
        ms1.append((time.perf_counter() - t0) * 1e3)
        before = launches_since({})
        t0 = time.perf_counter()
        on, stn = shd.render_sharded(scene, cam, gaze, stn, cfg, mesh)
        torch.cuda.synchronize()
        msn.append((time.perf_counter() - t0) * 1e3)
        for k, v in launches_since(before).items():
            counts[k] = counts.get(k, 0) + v
        flips, normals = check_frame(f"{label} frame {f}", on, o1, stn, st1,
                                     exact)
        err = (on["image"] - o1["image"]).abs()
        print(f"[{label}] frame {f}: render_sharded {msn[-1]:.2f} ms, "
              f"render_frame {ms1[-1]:.2f} ms; ray_count "
              f"{int(on['ray_count'])} / {int(o1['ray_count'])}, rays_dropped "
              f"0, mask pixels that differ {flips}, G-buffer normals that "
              f"differ {normals}, image MAE {float(err.mean()):.3e} max "
              f"{float(err.max()):.3e}, rays_traced {int(on['rays_traced'])} "
              f"/ {int(o1['rays_traced'])}  [{card}]")
    for k in PATH_PLAIN:
        assert counts.get(k, 0) == 0, (k, counts)
    print(f"[{label}] launches in the {frames} sharded frames: "
          f"{json.dumps(counts)}")
    if frames > 1:
        print(f"[{label}] steady (after frame 0): render_sharded "
              f"{np.mean(msn[1:]):.2f} ms/frame, render_frame "
              f"{np.mean(ms1[1:]):.2f} ms/frame  [{card}]")
    gaze = gazes[-1]
    k1 = cluster_device_ms(lambda: pipeline.render_frame(scene, cam, gaze,
                                                         st1, cfg))
    kn = cluster_device_ms(lambda: shd.render_sharded(scene, cam, gaze, stn,
                                                      cfg, mesh))
    print(f"[{label}] cluster kernels' device ms in one frame, row-major "
          f"blocks (render_sharded) / 16x16 tiles (render_frame): "
          + ", ".join(f"{k} {kn[k]:.3f} / {k1[k]:.3f}" for k in kn if k1[k])
          + f"  [{card}]")
    return counts


def small_dist_run(mesh, card):
    """The 2-rank comparison's work, on `mesh`: two sharded earth frames at
    DIST_RES (bench configuration, budget fraction 1.0), gathered, and one
    dense train step's loss and gradients at DIST_RES (optimize's
    configuration)."""
    from fovtrace_torch.app import trajectory
    from fovtrace_torch.config import RenderConfig
    from fovtrace_torch.core.camera import Camera
    from fovtrace_torch.dist import collectives as coll
    from fovtrace_torch.dist import sharding as shd
    from fovtrace_torch.dist import train
    from fovtrace_torch.scene import procedural

    dev = mesh.device
    earth = procedural.earth_scene(dev)
    cam = Camera.create(eye=(3.0, 2.5, 4.0), target=(0.0, 0.8, 0.0),
                        device=dev)
    cfg = RenderConfig(width=DIST_RES, height=DIST_RES, ray_budget_frac=1.0,
                       **GAZE_CFG)
    gazes, _ = trajectory.make("circle", DIST_RES, DIST_RES, 2)
    st = shd.initial_state_sharded(cam, cfg, mesh)
    res, ms = {}, []
    for f, gaze in enumerate(gazes):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out, st = shd.render_sharded(earth, cam, gaze, st, cfg, mesh)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        full = shd.gather_frame(out, mesh)
        for k in ("mask", "image", "ray_count", "rays_dropped"):
            res[f"{k}{f}"] = full[k]
        res[f"history{f}"] = coll.all_gather_rows(st.history, mesh, dim=1)
    tcfg = RenderConfig(width=DIST_RES, height=DIST_RES, max_depth=2,
                        diffuse_max_depth=1, reconstruction="none")
    tcam = Camera.create(eye=TRAIN_EYE, target=TRAIN_TARGET, device=dev)
    bh = DIST_RES // mesh.size
    true = train.init_params(earth, tcam)
    with torch.no_grad():
        target = train.render_rows_dense(earth, tcam, true, mesh.rank * bh,
                                         bh, tcfg, 0)
    params = train.leaves(true.replace(eye=true.eye + 0.25))
    train.broadcast_params(params, mesh)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loss, grads = train.make_loss_and_grad(earth, tcam, tcfg, mesh)(
        params, target, 0)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3
    res["loss"] = loss
    res.update({f"grad_{f.name}": g for f, g in
                zip(dataclasses.fields(grads), grads.tensors())})
    print(f"[dist {mesh.size}-rank] rank {mesh.rank}: {DIST_RES}x{DIST_RES} "
          f"frames {', '.join(f'{t:.2f}' for t in ms)} ms; dense train step "
          f"(loss and gradients) {step_ms:.2f} ms  [{card}]", flush=True)
    return res


def dist_worker(argv) -> int:
    """One rank of the [dist 2-rank] phase: `chip_smoke.py --dist-worker
    RANK WORLD INIT_URL OUT`. The ranks share one card, so the group is
    gloo (NCCL refuses two ranks on one device); its collectives move CUDA
    tensors by all-reduce and broadcast only."""
    rank, world, url, out = int(argv[0]), int(argv[1]), argv[2], argv[3]
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from fovtrace_torch.config import pin_fp32
    from fovtrace_torch.dist import launch

    pin_fp32("cuda")
    launch.init_distributed(url, world, rank, device="cuda", backend="gloo")
    mesh = launch.global_mesh("cuda")
    res = small_dist_run(mesh, card_line())
    if rank == 0:
        torch.save({k: v.detach().cpu() for k, v in res.items()}, out)
    launch.shutdown()
    return 0


def dist_two_ranks(one, tmp, card):
    """Two rank processes on the one card; rank 0's gathered result
    against this process's one-rank result `one`: the masks bit for bit,
    the frames and the train step within their tolerances."""
    url = f"file://{tmp}/rdzv2"
    out = os.path.join(tmp, "rank0.pt")
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__),
                               "--dist-worker", str(r), "2", url, out],
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=600)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for log in logs:
        print("\n".join(line for line in log.splitlines()
                        if line.startswith("[dist")))
    codes = [p.returncode for p in procs]
    assert codes == [0, 0], (codes, "\n".join(logs)[-3000:])
    print(f"[dist 2-rank] two processes on one card, a gloo group "
          f"(all-reduce and broadcast of CUDA tensors); wall "
          f"{time.perf_counter() - t0:.2f} s with their start")
    two = torch.load(out, weights_only=True)
    for f in range(2):
        err = (two[f"image{f}"] - one[f"image{f}"].cpu()).abs()
        off = err > DIST_ATOL + DIST_RTOL * one[f"image{f}"].cpu().abs()
        herr = (two[f"history{f}"] - one[f"history{f}"].cpu()).abs()
        print(f"[dist 2-rank] frame {f} against one rank: mask pixels that "
              f"differ {int((two[f'mask{f}'] != one[f'mask{f}'].cpu()).sum())}"
              f", ray_count {int(two[f'ray_count{f}'])} / "
              f"{int(one[f'ray_count{f}'])}, image max |err| "
              f"{float(err.max()):.3e} MAE {float(err.mean()):.3e}, pixels "
              f"off the tolerance {int(off.any(-1).sum())}, history max "
              f"|err| {float(herr.max()):.3e}")
    for f in range(2):
        assert torch.equal(two[f"mask{f}"], one[f"mask{f}"].cpu()), f
        for k in ("ray_count", "rays_dropped"):
            assert int(two[f"{k}{f}"]) == int(one[f"{k}{f}"]), (k, f)
        assert int(two[f"rays_dropped{f}"]) == 0
        for k in ("image", "history"):
            torch.testing.assert_close(two[f"{k}{f}"], one[f"{k}{f}"].cpu(),
                                       rtol=DIST_RTOL, atol=DIST_ATOL,
                                       msg=f"{k} frame {f}")
    worst = {}
    for k in [k for k in one if k == "loss" or k.startswith("grad_")]:
        a, b = two[k], one[k].cpu()
        # rtol 1e-4; the floor only for components near 0
        torch.testing.assert_close(a, b, rtol=1e-4,
                                   atol=1e-6 * float(b.abs().max()), msg=k)
        worst[k] = float(((a - b).abs() / b.abs().clamp_min(1e-30)).max())
    print(f"[dist 2-rank] masks bit for bit, frames within rtol {DIST_RTOL} "
          f"/ atol {DIST_ATOL}; train step's largest relative difference "
          f"per tensor {json.dumps({k: float(f'{v:.3e}') for k, v in worst.items()})}")


def dense_rays(scene, cam, cfg) -> int:
    """rays_traced of render_rows_dense's shade of the whole frame."""
    from fovtrace_torch.core import rng, vec
    from fovtrace_torch.render import shade

    with torch.no_grad():
        _, rd = cam.primary_rays_block(cfg.width, cfg.height, 0, cfg.height)
        rd = vec.from_rows(rd.reshape(-1, 3))
        pix = torch.arange(rd.x.shape[0], device=cam.device)
        seeds = rng.pixel_seed(pix, torch.zeros_like(pix))
        _, aux = shade.shade_v(scene, vec.splat(cam.eye, rd.shape), rd, seeds,
                               cfg)
    return int(aux["rays_traced"])


def train_steps(earth, mesh, card, steps=2):
    """One warm and `steps` timed train steps, dense and foveated (hard),
    on earth at W x H in optimize's configuration, one rank."""
    import importlib.util

    from fovtrace_torch.config import RenderConfig
    from fovtrace_torch.core.camera import Camera
    from fovtrace_torch.dist import train

    ported = importlib.util.find_spec("fovtrace_torch.kernels.envmap")
    cfg = RenderConfig(width=W, height=H, max_depth=2, diffuse_max_depth=1,
                       reconstruction="none")
    cam = Camera.create(eye=TRAIN_EYE, target=TRAIN_TARGET, device=mesh.device)
    true = train.init_params(earth, cam)
    with torch.no_grad():
        target = train.render_rows_dense(earth, cam, true, 0, H, cfg, 0)
    rays = dense_rays(earth, cam, cfg)
    per_step = {}
    for foveated in (False, True):
        label = "train foveated" if foveated else "train dense"
        params = train.leaves(true.replace(
            eye=true.eye + 0.25, light_emission=true.light_emission * 1.5,
            gaze_uv=torch.tensor([0.45, 0.55], device=mesh.device)))
        opt = train.make_optimizer(params, 2e-2)
        loss_and_grad = train.make_loss_and_grad(earth, cam, cfg, mesh,
                                                 foveated=foveated)
        step = train.make_train_step(earth, cam, cfg, mesh,
                                     foveated=foveated)
        step(params, opt, target, 0)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        before = launches_since({})
        ms = []
        for s in range(steps):
            t0 = time.perf_counter()
            loss, grads = loss_and_grad(params, target, s + 1)
            for p, g in zip(params.tensors(), grads.tensors()):
                p.grad = g
            opt.step()
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        counts = {k: v / steps for k, v in launches_since(before).items()}
        peak = torch.cuda.max_memory_allocated() / 2**30
        steady = float(np.mean(ms))
        norms = {f.name: float(g.norm()) for f, g in
                 zip(dataclasses.fields(grads), grads.tensors())}
        print(f"[{label}] {W}x{H} earth, max_depth 2: steps "
              f"{', '.join(f'{t:.2f}' for t in ms)} ms; {steady:.2f} ms/step, "
              f"{rays} rays_traced a step (the forward), "
              f"{rays / steady / 1e3:.2f} Mrays/s; peak memory {peak:.2f} GiB "
              f"({base / 2**30:.2f} GiB before the steps); loss "
              f"{float(loss):.6f}  [{card}]")
        print(f"[{label}] gradient norms "
              + ", ".join(f"|d {k}| {v:.6e}" for k, v in norms.items()))
        print(f"[{label}] launches per step {json.dumps(counts)}")
        for k, g in zip(norms, grads.tensors()):
            assert bool(torch.isfinite(g).all()), (label, k)
            if k == "gaze_uv" and not foveated:
                assert norms[k] == 0.0, (label, k)   # the dense render
            else:
                assert norms[k] > 0.0, (label, k)
        for k in PATH_PLAIN:
            assert counts.get(k, 0) == 0, (k, counts)
        assert counts["closest_hit"] > 0 and counts["occlusion"] > 0, counts
        per_step[label] = counts
        bwd = fwd_bwd_profile(label, lambda: loss_and_grad(params, target, 3),
                              steady, card)
        if ported:   # a parent checkout (--attribution ROOT) may predate it
            # the envmap is trained: its taps' adjoint is the kernel's, a
            # launch per bounce, and no IndexBackward0 comes from the shade
            assert counts["envmap_adjoint"] == counts["envmap_lookup"] == \
                cfg.max_depth, counts
            assert not [key for key in bwd if key[0] == "IndexBackward0"
                        and "render/shade.py" in key[1]], bwd
    return per_step


def optimize_runs(tmp, card):
    """app/optimize as a user runs it, `--scene box` with --ckpt: the
    README's 60 steps at the default 128x128 (the loss must fall; the
    exit code is the run's verdict on the eye error, printed: the
    reference's own run of this command ends at eye error 0.487 > 0.3,
    exit 1, on the CPU); again with --steps 80 on the same directory
    (must resume at 60); a run cut at 40 and resumed to 60, whose
    parameters must equal the uninterrupted run's at step 60 (rtol
    1e-6); and tests/test_checkpoint.py's configuration (32x32, 8 steps,
    --perturb 0.25, --lr 3e-2), which must exit 0."""
    from fovtrace_torch.dist import checkpoint as ckpt

    def run(steps, d, *extra):
        t0 = time.perf_counter()
        p = subprocess.run([sys.executable, "-m", "fovtrace_torch.app.optimize",
                            "--scene", "box", "--steps", str(steps), "--ckpt",
                            d, *extra], capture_output=True, text=True,
                           timeout=600)
        wall = time.perf_counter() - t0
        lines = [line for line in p.stderr.splitlines()
                 if line.startswith("[optimize]")]
        print(f"[optimize] --steps {steps} --ckpt {os.path.basename(d)} "
              f"{' '.join(extra)}: exit {p.returncode}, process wall "
              f"{wall:.2f} s; " + " | ".join(
                  line for line in lines if "done" in line
                  or "resumed" in line or "launches" in line))
        assert p.returncode in (0, 1) and "done in" in p.stderr, \
            p.stderr[-3000:]
        # the run's kernel launches: the material and envmap kernels on its
        # steps, and no plain version
        launched, = [ast.literal_eval(line.split(": ", 1)[1]) for line in lines
                     if "kernel launches and plain calls" in line]
        assert launched.get("material_gather", 0) > 0 and \
            launched.get("material_adjoint", 0) > 0, launched
        assert launched.get("envmap_lookup", 0) > 0 and \
            launched.get("envmap_adjoint", 0) > 0, launched
        assert not set(PATH_PLAIN) & set(launched), launched
        return p.returncode, p.stderr

    whole, cut = os.path.join(tmp, "whole"), os.path.join(tmp, "cut")
    _, err = run(60, whole)
    losses = [float(m) for m in re.findall(r"loss=([0-9.]+)", err)]
    assert losses[-1] < losses[0], losses
    _, err = run(80, whole)
    assert "resumed from step 60" in err, err[-3000:]
    run(40, cut)
    _, err = run(60, cut)
    assert "resumed from step 40" in err, err[-3000:]
    _, a = ckpt.restore(whole, step=60)
    _, b = ckpt.restore(cut, step=60)
    for k in a["params"]:
        torch.testing.assert_close(b["params"][k], a["params"][k], rtol=1e-6,
                                   atol=0, msg=k)
    print(f"[optimize] cut at 40 and resumed: parameters at step 60 equal "
          f"the uninterrupted run's (rtol 1e-6)  [{card}]")
    rc, err = run(8, os.path.join(tmp, "small"), "--width", "32",
                  "--height", "32", "--perturb", "0.25", "--lr", "3e-2")
    assert rc == 0, err[-3000:]


# ---- scenes from files (scene/{assets,obj,image_io}.py, the CLI's loader)
# CedarCity.hdr and vokselia_spawn.png at the reference's own sizes
# (tests/test_assets.py:101, 117); grid.ppm and bunny.PPM at sizes chosen
# here; the atlas then holds three 1024x1024 textures
ASSET_SIZES = dict(hdr=(800, 1600), png=2048, grid=512, bunny=256)
# the procedural stand-ins of reference_assets_scene at vokselia_extent 4:
# plane, voxel world, icosphere, uv sphere, box
ASSET_TRIANGLES = 2 + 1776 + 1280 + 3968 + 12
STAGES = ("GB", "Sampling", "Optimize", "Shading", "JFA", "SI", "PPI", "AT")


def timed(fn):
    t0 = time.perf_counter()
    out = fn()
    return out, time.perf_counter() - t0


def asset_writers():
    """tests/torch_asset_files.py, the seeded scene-file writers of the
    CPU tests (numpy and fovtrace_torch only)."""
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(
        __file__)), "tests"))
    import torch_asset_files
    return torch_asset_files


def assets_build(tmp, dev):
    """Write the file scenes into tmp, time each load step on the host,
    and load the three scenes through the CLI's loader onto the card.
    Returns {label: (path, scene)}."""
    from fovtrace_torch.app import cli
    from fovtrace_torch.kernels import cluster_isect as ci
    from fovtrace_torch.scene import assets, image_io, obj, procedural
    from fovtrace_torch.scene import bvh as bvh_mod

    taf = asset_writers()
    res = os.path.join(tmp, "resource")
    glass = [procedural._mesh(procedural.icosphere(0.6, (0.0, 0.0, 0.0),
                                                   subdiv=3), 0)]
    _, s_write = timed(lambda: (
        taf.write_resource_dir(res, **ASSET_SIZES),
        taf.write_mesh_scene(tmp, procedural.city_meshes(), "city",
                             textured=False),
        taf.write_mesh_scene(tmp, procedural.city_meshes(), "city_tex",
                             textured=True, tex_size=1024),
        taf.write_mesh_scene(tmp, glass, "glass", textured=False)))
    city, city_tex, glass = (os.path.join(tmp, f"{n}.obj")
                             for n in ("city", "city_tex", "glass"))
    spec = taf.write_spec(tmp, city_tex, glass,
                          os.path.join(res, "CedarCity.hdr"))
    print(f"[assets build] wrote {res} (CedarCity.hdr 800x1600 in RLE "
          f"scanlines, vokselia_spawn/vokselia_spawn.png 2048x2048 RGB with "
          f"rows in all five PNG filters, grid.ppm 512x512, bunny/bunny.PPM "
          f"256x256, the two .mtl), city.obj (geometry only), city_tex.obj "
          f"(v/vt/vn, four usemtl groups, a 1024x1024 PNG map_Kd), "
          f"glass.obj and spec.json in {s_write:.2f} s")
    steps = {}
    env, steps["HDR decode"] = timed(lambda: image_io.load_hdr(
        os.path.join(res, "CedarCity.hdr")))
    png_path = os.path.join(res, "vokselia_spawn", "vokselia_spawn.png")
    png, steps["PNG decode"] = timed(lambda: image_io.load_png(png_path))
    side = ASSET_SIZES["png"]
    assert env.shape == (*ASSET_SIZES["hdr"], 3) and png.shape == (side,
                                                                   side, 3)
    geo, steps["OBJ parse native"] = timed(lambda: obj.load_obj(city))
    tex, steps["OBJ parse Python"] = timed(lambda: obj.load_obj(city_tex))
    np.testing.assert_array_equal(geo[0], tex[0])
    np.testing.assert_array_equal(geo[1], tex[1])
    assert geo[2] is None and tex[2] is not None and len(tex[5]) == 4
    textures = [assets._load_texture(os.path.join(res, *p)) for p in
                (("grid.ppm",), ("vokselia_spawn", "vokselia_spawn.png"),
                 ("bunny", "bunny.PPM"))]
    atlas, steps["atlas"] = timed(lambda: assets.build_texture_atlas(
        textures))
    a_side = min(1024, max(ASSET_SIZES[k] for k in ("png", "grid", "bunny")))
    assert atlas.shape == (3, a_side, a_side, 3)
    scenes = {}
    for label, path in (("assets", res), ("city-obj", city), ("spec", spec)):
        sc, sec = timed(lambda: cli.load_scene(path, dev))
        nc, c = sc.cluster_aabb.shape[0], sc.isect_coef.shape[2] // 4
        real = int((sc.mat_id >= 0).sum())
        pack = sc.isect_coef.numel() * sc.isect_coef.element_size()
        print(f"[assets build] {label}: cli.load_scene {sec:.2f} s; {real} "
              f"triangles ({sc.num_triangles} after padding), NC {nc}, pack "
              f"{pack / 1e6:.2f} MB, route {ci.route(nc, c)}; textures "
              f"{tuple(sc.textures.shape)}, envmap {tuple(sc.envmap.shape)}")
        scenes[label] = (path, sc)
    for label in ("assets", "city-obj"):
        host = scenes[label][1].to("cpu")
        _, steps[f"BVH {label}"] = timed(lambda: bvh_mod.build_bvh(
            host.v0.numpy(), host.e1.numpy(), host.e2.numpy(),
            host.mat_id.numpy() >= 0))
        _, steps[f"pack {label}"] = timed(host.with_pack)
    print("[assets build] seconds per load step on the host: " + ", ".join(
        f"{k} {v:.3f}" for k, v in steps.items()))
    route = lambda sc: ci.route(sc.cluster_aabb.shape[0],
                                sc.isect_coef.shape[2] // 4)
    a = scenes["assets"][1]
    assert int((a.mat_id >= 0).sum()) == ASSET_TRIANGLES
    assert route(a) == "resident" and tuple(a.textures.shape) == \
        atlas.shape and tuple(a.envmap.shape) == env.shape
    assert route(scenes["city-obj"][1]) == "stream"
    assert route(scenes["spec"][1]) == "stream"
    return scenes


def file_scene_run(label, path, scene, cam, card, tmp, route):
    """main_path on a scene from files, through the CLI with
    --profile-stages, --report and a BMP dump: the stage columns, and
    the BMP read back by load_bmp equal to the frame's buffer; then a
    profiled frame (frame_profile). `route` is the kernel pair the scene
    must take ("" resident, "_stream")."""
    from fovtrace_torch.app import cli
    from fovtrace_torch.scene import image_io

    out_dir = os.path.join(tmp, label.replace(" ", "_"))
    report = out_dir + ".csv"
    counts, cfg, steady, stats = main_path(
        label, path, scene, cam, card, extra=(
            "--profile-stages", "--out", out_dir, "--format", "bmp",
            "--report", report))
    other = "_stream" if route == "" else ""
    for k in ("closest_hit", "occlusion"):
        assert counts[k + route] > 0 and counts[k + other] == 0, counts
    with open(report) as f:
        header = f.readline().strip().split(",")
    rows = stats["timer"].frame_rows[1:]
    stage_ms = {k: float(np.mean([r[k] for r in rows])) for k in header
                if k in STAGES}
    print(f"[{label}] --report columns {header}")
    print(f"[{label}] steady stages (ms, a synchronise after each): "
          f"{fmt_stages(stage_ms)}  [{card}]")
    assert list(stage_ms) == ["GB", "Sampling", "Optimize", "Shading",
                              "PPI", "AT"] and "Total" in header, header
    bmp = image_io.load_bmp(os.path.join(out_dir, "frame_final_a0.070.bmp"))
    want = cli.to_u8_image("image", stats["out"]) / np.float32(255.0)
    same = bool(np.array_equal(bmp, want))
    print(f"[{label}] frame_final_a0.070.bmp {bmp.shape} read back by "
          f"image_io.load_bmp equals the frame's buffer: {same}")
    assert same
    frame_profile(label.split()[-1], scene, cam, cfg, steady, card)
    return counts, cfg, steady


def bvh_phase(earth, cam, card):
    """The plain-torch bvh backend on earth: its hits on the RES x RES
    primary rays against the cluster kernels' (the same ids, refined t
    within rtol 1e-4 / atol 1e-5, as tests/test_bvh.py), its time and
    device launches; then a RES x RES frame with intersect_backend="bvh"
    against the cluster route's frame."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from fovtrace_torch.config import RenderConfig
    from fovtrace_torch.kernels import bvh_traverse
    from fovtrace_torch.kernels import cluster_isect as ci
    from fovtrace_torch.kernels import intersect as isect
    from fovtrace_torch.render import gbuffer, pipeline

    ro, rd = cam.primary_rays_v(RES, RES)
    swz = lambda a: gbuffer.swizzle_to_tiles(a.reshape(-1), RES, RES)
    ro, rd = ro.map(swz), rd.map(swz)
    run = lambda: bvh_traverse.intersect_bvh(earth, ro, rd, 1e-3,
                                             isect.BIG_T)
    hb = run()
    ms = cuda_ms(run, iters=3, warmup=0)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    launched = sum(e.count for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA)
    hc = ci.intersect_cluster(earth, ro, rd, 1e-3, isect.BIG_T)
    kms = cuda_ms(lambda: ci.intersect_cluster(earth, ro, rd, 1e-3,
                                               isect.BIG_T), iters=10)
    tb = isect.refine_hit_v(earth, ro, rd, hb).t
    tc = isect.refine_hit_v(earth, ro, rd, hc).t
    hit = hc.tri >= 0
    same = int((hb.tri == hc.tri).sum())
    t_err = float(((tb - tc).abs() / tc.abs().clamp_min(1e-30))[hit].max())
    print(f"[bvh] earth {RES}x{RES} primary rays ({ro.x.numel()}): "
          f"intersect_bvh {ms:.2f} ms, {launched} device kernels a call, "
          f"against intersect_cluster (closest_kernel) {kms:.3f} ms; "
          f"{int(hit.sum())} hits, identical ids {same} of {ro.x.numel()}, "
          f"refined t max relative diff {t_err:.3e}  [{card}]")
    assert same == ro.x.numel(), "bvh and cluster ids differ"
    torch.testing.assert_close(tb[hit], tc[hit], rtol=1e-4, atol=1e-5)

    outs = {}
    for backend in ("bvh", "cluster"):
        cfg = RenderConfig(width=RES, height=RES, ray_budget_frac=0.6,
                           intersect_backend=backend, **GAZE_CFG)
        st = pipeline.FrameState.initial(cam, cfg)
        ci.reset_counters()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out, _ = pipeline.render_frame(earth, cam, (RES // 2, RES // 2), st,
                                       cfg)
        torch.cuda.synchronize()
        outs[backend] = (out, ci.counters(),
                         (time.perf_counter() - t0) * 1e3)
    (b, cb, ms_b), (c, cc, ms_c) = outs["bvh"], outs["cluster"]
    mae = float((b["image"] - c["image"]).abs().mean())
    calls = {k: cb[k] for k in ("intersect_bvh", "occlusion_bvh")}
    print(f"[bvh] earth {RES}x{RES} frame, intersect_backend bvh: {ms_b:.1f} "
          f"ms, {json.dumps(calls)}, against cluster {ms_c:.1f} ms; mask "
          f"equal {torch.equal(b['mask'], c['mask'])}, ray_count "
          f"{int(b['ray_count'])} / {int(c['ray_count'])}, rays_traced "
          f"{int(b['rays_traced'])} / {int(c['rays_traced'])}, image MAE "
          f"{mae:.3e}  [{card}]")
    assert calls["intersect_bvh"] > 0 and calls["occlusion_bvh"] > 0
    for k in ("closest_hit", "occlusion", "closest_hit_stream",
              "occlusion_stream", "closest_hit_plain", "occlusion_plain",
              "intersect_brute", "occlusion_brute", "material_gather_plain",
              "material_adjoint_plain"):
        assert cb[k] == 0, (k, cb)
    assert torch.equal(b["mask"], c["mask"])
    assert int(b["ray_count"]) == int(c["ray_count"])
    assert mae < 5e-3


def probe_times(root: str) -> int:
    """`python3 chip_smoke.py --probe-times [ROOT]`: the two probes'
    kernels of the checkout at ROOT (this file's own by default; a
    parent's `git archive` to compare with), on the inputs [probe micro]
    and [probe dma] time: each micro variant at earth's 2,097,152 primary
    rays and smem_dma at the city G-buffer's schedule rows, with
    F.embedding_bag beside it. Per kernel: three measurements of its
    device ms per launch, as the smoke takes them (micro: complete
    torch.profiler traces of 20 calls, `own_ms`; smem_dma, its call's only
    launch: `queued_ms`), and the wrapper's call (CUDA events
    over 20 calls). It uses only the probe modules' entry points that
    every version of them has had, so a parent's kernels and the
    change's are measured alike. Prints one JSON line."""
    root = os.path.abspath(root)
    sys.path.insert(0, root)
    import fovtrace_torch
    from fovtrace_torch.config import pin_fp32
    from fovtrace_torch.core.camera import Camera
    from fovtrace_torch.scene import procedural
    from fovtrace_torch.scripts import MICRO_VARIANTS
    from fovtrace_torch.scripts import microbench_inner as mb
    from fovtrace_torch.scripts import probe_smem_dma as dma

    assert fovtrace_torch.__file__.startswith(root + os.sep), \
        fovtrace_torch.__file__
    dev = torch.device(DEVICE)
    pin_fp32(dev)
    card = card_line()
    rows = {}

    def measure(name, fn, kernel):
        call = cuda_ms(fn, iters=20)
        if kernel is None:      # the call's only launch
            got = [(queued_ms(fn), 0.0, 0) for _ in range(3)]
            how = "queued behind a spin"
        else:
            got = [own_ms(fn, kernel, calls=20) for _ in range(3)]
            how = f"{sum(g[2] for g in got)} traces missed launches"
        rows[name] = dict(kernel_ms=[g[0] for g in got], call_ms=call)
        ks = " / ".join(f"{k:.4f}" for k in rows[name]["kernel_ms"])
        print(f"[probe times] {name:14s} kernel {ks} ms a launch ({how}), "
              f"call {call:.4f} ms  [{card}]", flush=True)

    print(f"[probe times] {os.path.dirname(fovtrace_torch.__file__)}")
    inp = mb.build_inputs(procedural.earth_scene(dev))
    for i, v in enumerate(MICRO_VARIANTS):
        measure(f"micro_{v}", lambda: mb.run_variant(v, *inp.args(v)),
                f"micro_kernel<{i}>")
    cam = Camera.create(eye=(3.0, 2.5, 4.0), target=(0.0, 0.8, 0.0),
                        device=dev)
    city = procedural.city_scene(dev)
    _, _, cfg = bench_probe_frac(city, cam)
    args = dma_city_args(capture_inputs(city, cam, cfg)["closest_hit"][0][0],
                         dma)
    measure("smem_dma", lambda: dma.smem_dma(*args), None)
    rows["embedding_bag"] = dict(call_ms=cuda_ms(embedding_bag_call(args),
                                                 iters=20))
    print(f"[probe times] embedding_bag  call "
          f"{rows['embedding_bag']['call_ms']:.4f} ms  [{card}]")
    print(json.dumps({"root": root, "card": card, "times": rows}))
    return 0


def attribution(root: str) -> int:
    """`python3 chip_smoke.py --attribution [ROOT]`: the checkout at
    ROOT's (this file's own by default; a parent's `git archive` to
    compare with) earth fwd+bwd step at W x H in the bench configuration
    (`fwd_bwd`, 3 timed steps) and the dense and foveated train steps
    (`train_steps`, on a process group of one), each with a profile that
    ties every backward function to the forward source line that made it
    (`fwd_bwd_profile`). It uses only entry points that the port has had
    since its training path, so a parent's package and the change's are
    measured alike."""
    root = os.path.abspath(root)
    sys.path.insert(0, root)
    import fovtrace_torch
    from fovtrace_torch.config import pin_fp32
    from fovtrace_torch.core.camera import Camera
    from fovtrace_torch.dist import launch
    from fovtrace_torch.dist import sharding as shd
    from fovtrace_torch.render import pipeline
    from fovtrace_torch.scene import procedural

    assert fovtrace_torch.__file__.startswith(root + os.sep), \
        fovtrace_torch.__file__
    dev = torch.device(DEVICE)
    pin_fp32(dev)
    card = card_line()
    print(f"[attribution] {os.path.dirname(fovtrace_torch.__file__)}  "
          f"[{card}]", flush=True)
    cam = Camera.create(eye=(3.0, 2.5, 4.0), target=(0.0, 0.8, 0.0),
                        device=dev)
    earth = procedural.earth_scene(dev)
    _, _, cfg = bench_probe_frac(earth, cam)
    _, step, st, _, _ = fwd_bwd("attribution earth fwd+bwd", earth, cam, cfg,
                                card, steps=3)
    fwd_bwd_profile("attribution earth fwd+bwd", lambda: pipeline.grad_step(
        earth, cam, (H // 2, W // 2), st, cfg), step, card)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_attribution_")
    try:
        launch.init_distributed(f"file://{tmp}/rdzv", 1, 0, device=dev)
        train_steps(earth, shd.make_mesh(1, dev), card)
    finally:
        launch.shutdown()
        shutil.rmtree(tmp, ignore_errors=True)
    return 0


def main() -> int:
    if len(sys.argv) > 1 and sys.argv[1] == "--dist-worker":
        return dist_worker(sys.argv[2:])
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this smoke "
              "test needs an NVIDIA GPU", file=sys.stderr)
        return 1
    here = os.path.dirname(os.path.abspath(__file__))
    if len(sys.argv) > 1 and sys.argv[1] == "--probe-times":
        return probe_times(sys.argv[2] if len(sys.argv) > 2 else here)
    if len(sys.argv) > 1 and sys.argv[1] == "--attribution":
        return attribution(sys.argv[2] if len(sys.argv) > 2 else here)
    from fovtrace_torch import _build
    from fovtrace_torch.config import RenderConfig, pin_fp32
    from fovtrace_torch.core.camera import Camera
    from fovtrace_torch.kernels import cluster_isect as ci
    from fovtrace_torch.kernels import envmap, material
    from fovtrace_torch.render import pipeline
    from fovtrace_torch.scene import procedural
    from fovtrace_torch.scripts import load_probe_library

    dev = torch.device(DEVICE)
    pin_fp32(dev)
    ph = Phases()
    # ---- card ---------------------------------------------------------------
    ph.start("card")
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(f"[card] {card} | torch {torch.__version__} cuda "
          f"{torch.version.cuda} | devices {torch.cuda.device_count()}")

    # ---- build --------------------------------------------------------------
    ph.start("build")
    t0 = time.perf_counter()
    # one nvcc per source, all started together
    with ThreadPoolExecutor(4) as pool:
        libs = [f.result()._name for f in [
            pool.submit(ci.load_cuda_library), pool.submit(load_probe_library),
            pool.submit(material.load_cuda_library),
            pool.submit(envmap.load_cuda_library)]]
    print(f"[build] CUDA kernels built in {time.perf_counter() - t0:.2f} s")
    logs = [_build.build_log(lib) for lib in libs]
    for lib, log in zip(libs, logs):
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "Compiling" in line:
                print(f"[build] {os.path.basename(lib)}: {line.strip()}")
    spilled = {k: v for k, v in render_spills(logs[0]).items() if any(v)}
    assert not spilled, f"cluster kernels spill registers: {spilled}"
    print(f"[build] no spills in the render path's cluster kernels: "
          f"{', '.join(RENDER_KERNELS)}")

    cam = Camera.create(eye=(3.0, 2.5, 4.0), target=(0.0, 0.8, 0.0),
                        device=dev)
    earth = procedural.earth_scene(dev)
    errs: dict = {}

    # ---- kernels vs plain: earth (resident) ----------------------------------
    ph.start("kernels earth")
    earth_sets = ray_sets(earth, cam, dev)
    for name, (ro, rd, tmax) in earth_sets.items():
        compare(f"earth {name}", earth, ro, rd, 1e-3, tmax, dev, errs)
    resident_grids("earth", earth,
                   {**earth_sets, "nearfar": near_far_rays(dev)})

    # ---- forced onto the streaming route -------------------------------------
    ph.start("kernels forced-stream")
    forced_stream(earth, earth_sets, procedural.multi_object_scene("cpu"),
                  dev, errs)

    # ---- city build -----------------------------------------------------------
    ph.start("city build")
    t0 = time.perf_counter()
    city = procedural.city_scene(dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    nc, c = city.cluster_aabb.shape[0], city.isect_coef.shape[2] // 4
    m = ci.pick_members(nc)
    r = ci.route(nc, c)
    t0 = time.perf_counter()
    city.to("cpu").with_bvh()
    bvh_s = time.perf_counter() - t0
    print(f"[city build] {city.num_triangles} triangles, NC {nc}, c {c}, "
          f"M {m}, NSC {nc // m}, route {r}; city_scene (mesh, BVH, leaf "
          f"order and pack on the host CPU, upload) {build_s:.2f} s, of "
          f"which a with_bvh over its 170k triangles takes {bvh_s:.2f} s")
    assert (nc, m, r) == (1332, 2, "stream")

    # ---- kernels vs plain: city (streaming) ----------------------------------
    ph.start("kernels city")
    for name, (ro, rd, tmax) in ray_sets(city, cam, dev).items():
        compare(f"city {name}", city, ro, rd, 1e-3, tmax, dev, errs)

    # ---- main paths at full size ---------------------------------------------
    ph.start("main earth")
    counts_e, cfg_e, steady_e, _ = main_path("main earth", "earth", earth,
                                             cam, card)
    assert counts_e["closest_hit"] > 0 and counts_e["occlusion"] > 0
    assert counts_e["closest_hit_stream"] == 0 and \
        counts_e["occlusion_stream"] == 0
    # a forward frame looks the table and the envmap up, no backward
    assert counts_e["material_gather"] > 0 and \
        counts_e["material_adjoint"] == 0, counts_e
    assert counts_e["envmap_lookup"] > 0 and \
        counts_e["envmap_dxy"] == counts_e["envmap_adjoint"] == 0, counts_e
    ph.start("main city")
    counts_c, cfg_c, steady_c, _ = main_path("main city", "city", city, cam,
                                             card)
    assert counts_c["closest_hit_stream"] > 0 and \
        counts_c["occlusion_stream"] > 0
    assert counts_c["closest_hit"] == 0 and counts_c["occlusion"] == 0
    assert counts_c["material_gather"] > 0, counts_c
    assert counts_c["envmap_lookup"] > 0, counts_c
    launches = {k: counts_e[k] for k in ("closest_hit", "occlusion",
                                         "envmap_lookup")}
    launches.update({k: counts_c[k] for k in ("closest_hit_stream",
                                              "occlusion_stream")})
    launches.update(micro_inner=0, smem_dma=0)   # no render path runs them

    # ---- the main paths' backward pass (bench.py's default fwd+bwd) -------
    ph.start("main earth fwd+bwd")
    g_e, step_e, st_e, per_e, peak_e = fwd_bwd("main earth fwd+bwd", earth,
                                               cam, cfg_e, card, steps=3)
    assert per_e["closest_hit"] > 0 and per_e["occlusion"] > 0, per_e
    assert per_e["material_gather"] > 0 and per_e["material_adjoint"] > 0, \
        per_e
    # the eye and target reach the directions: d(fx, fy), and no adjoint
    # (the step does not train the envmap)
    assert per_e["envmap_dxy"] == per_e["envmap_lookup"] > 0 and \
        per_e["envmap_adjoint"] == 0, per_e
    # the JSON line's material and d(fx, fy) launches: the 3 timed fwd+bwd
    # steps'
    launches.update({name: round(3 * per_e[c])
                     for name, c in MATERIAL_COUNTERS.items()})
    launches["envmap_dxy"] = round(3 * per_e["envmap_dxy"])
    bwd_e = fwd_bwd_profile("main earth fwd+bwd", lambda: pipeline.grad_step(
        earth, cam, (H // 2, W // 2), st_e, cfg_e), step_e, card)
    assert not [key for key in bwd_e if key[0] == "IndexBackward0"
                and ("material_lookup_v" in key[1]
                     or "render/shade.py" in key[1])], bwd_e
    ph.start("main earth fwd+bwd remat")
    remat = cfg_e.replace(remat_shade=True)
    g_r, step_r, _, per_r, peak_r = fwd_bwd("main earth fwd+bwd remat",
                                            earth, cam, remat, card, steps=2)
    # the backward runs every shade bounce again, its kernels included
    for k in ("closest_hit", "occlusion"):
        assert per_r[k] == per_e[k] + cfg_e.max_depth, (k, per_r, per_e)
    # and every bounce's lookups (surface and shade) once more
    assert per_r["material_gather"] == \
        per_e["material_gather"] + 2 * cfg_e.max_depth, (per_r, per_e)
    assert per_r["envmap_lookup"] == \
        per_e["envmap_lookup"] + cfg_e.max_depth, (per_r, per_e)
    worst = max(float(((g_r[k] - g_e[k]).abs()
                       / g_e[k].abs().clamp_min(1e-30)).max()) for k in g_e)
    print(f"[main earth fwd+bwd remat] peak memory {peak_r:.2f} GiB with "
          f"remat_shade vs {peak_e:.2f} GiB without; {step_r:.2f} vs "
          f"{step_e:.2f} ms/step; gradients' largest relative difference "
          f"{worst:.3e}  [{card}]")
    for k in g_e:   # rtol 1e-4; the floor only for components near 0
        torch.testing.assert_close(g_r[k], g_e[k], rtol=1e-4,
                                   atol=1e-6 * float(g_e[k].abs().max()))
    ph.start("main city fwd+bwd")
    _, step_c, st_c, per_c, _ = fwd_bwd("main city fwd+bwd", city, cam,
                                        cfg_c, card, steps=2)
    assert per_c["closest_hit_stream"] > 0 and per_c["occlusion_stream"] > 0
    assert per_c["closest_hit"] == 0 and per_c["occlusion"] == 0
    assert per_c["material_gather"] > 0 and per_c["material_adjoint"] > 0
    assert per_c["envmap_dxy"] > 0 and per_c["envmap_adjoint"] == 0, per_c
    fwd_bwd_profile("main city fwd+bwd", lambda: pipeline.grad_step(
        city, cam, (H // 2, W // 2), st_c, cfg_c), step_c, card)

    # ---- the material kernels against their plain versions ----------------
    ph.start("material")
    material_row, material_errs = material_phase(earth, cam, cfg_e, card)

    # ---- the envmap kernels against their plain versions ------------------
    ph.start("envmap")
    envmap_row, envmap_errs = envmap_phase(earth, cam, cfg_e, card)

    # ---- fovtrace_torch.bench, bench.py's twin ------------------------------
    ph.start("bench")
    bench_phase({"earth": earth, "city": city}, card)

    ph.start("profile")
    frame_profile("earth", earth, cam, cfg_e, steady_e, card)
    frame_profile("city", city, cam, cfg_c, steady_c, card)

    # ---- kernel times at the main paths' shapes ------------------------------
    ph.start("timing")
    times = {}
    time_kernels(earth, capture_inputs(earth, cam, cfg_e), card, errs, times,
                 kernel_iters=20, plain_iters=1)
    captured = capture_inputs(city, cam, cfg_c)
    time_kernels(city, captured, card, errs, times, kernel_iters=20,
                 plain_iters=1)
    time_schedule(city, captured["closest_hit"][0][0][0], card)
    # the redesign order: what each kernel loses to its bound per 3-frame
    # run, launches x the mean of (kernel - bound) over its two shapes
    loss = {name: launches[name] * sum(times[(name, s)][0] - times[(name, s)][2]
                                       for s in ("gbuffer", "bounce0")) / 2
            for name in KERNELS[:4]}
    print("[timing] launches x (kernel - bound), mean of the G-buffer and "
          "bounce-0 shapes: " + ", ".join(
              f"{n} {ms:.1f} ms" for n, ms in sorted(loss.items(),
                                                     key=lambda kv: -kv[1]))
          + f"  [{card}]")

    # ---- the probes: the last two TPU kernels' counterparts ----------------
    ph.start("probe micro")
    ci.reset_counters()
    micro = {}
    probe_micro(earth, card, times, micro, libs[1])
    ph.start("probe dma")
    dma_res = probe_dma(captured["closest_hit"][0][0], card)
    probe_counts = probe_calls()
    print(f"[probe dma] launches in the probe phases: "
          f"{json.dumps(probe_counts)}")
    for k in [f"micro_{v}" for v in micro] + ["micro_plain", "smem_dma",
                                               "smem_dma_plain"]:
        assert probe_counts.get(k, 0) >= 1, (k, probe_counts)
    # the JSON line's (ms, plain_ms, bound_ms, bound_by): the G-buffer
    # shape for the render kernels, `full` and the city rows for the probes
    row = {name: times[(name, "gbuffer")][:4] for name in KERNELS[:4]}
    row["micro_inner"], errs["micro_inner"] = micro["full"][:4], \
        micro["full"][4]
    row["smem_dma"], errs["smem_dma"] = dma_res[:4], dma_res[5]
    library = {"smem_dma": dma_res[4]}
    for name, r in {**material_row, **envmap_row}.items():
        row[name], library[name] = r[:4], r[4]
    errs.update(material_errs)
    errs.update(envmap_errs)

    # ---- frame parity ---------------------------------------------------------
    ph.start("parity")
    frame_parity("earth", earth, cam)
    frame_parity("city", city, cam)
    golden = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "tests", "golden", "earth.npz")
    ref = np.load(golden)
    gcfg = RenderConfig(width=64, height=64, reconstruction="atrous",
                        max_depth=3, diffuse_max_depth=1, ray_budget_frac=0.6)
    st = pipeline.FrameState.initial(cam, gcfg)
    for _ in range(2):
        go, st = pipeline.render_frame(earth, cam, (32, 32), st, gcfg)
    gimg = go["image"].cpu().numpy()
    want = ref["image"].astype(np.float32)
    gmae = float(np.abs(gimg - want).mean())
    gmax = float(np.abs(gimg - want).max())
    print(f"[parity] 64x64 vs tests/golden/earth.npz: ray_count "
          f"{int(go['ray_count'])} / {int(ref['ray_count'])}, MAE {gmae:.3e}, "
          f"max {gmax:.3e}")
    assert int(go["ray_count"]) == int(ref["ray_count"])
    assert gmae < 5e-3 and gmax < 0.1
    ph.start("grad parity")
    golden_grad_parity(earth, cam)

    # ---- the other sampling modes and reconstructions ------------------------
    ph.start("modes")
    modes(earth, cam, card)
    mode_goldens(earth, cam)

    # ---- scenes from files, and the bvh backend ------------------------------
    ph.start("assets build")
    atmp = tempfile.mkdtemp(prefix="chip_smoke_assets_")
    try:
        files = assets_build(atmp, dev)
        ph.start("main assets")
        path, assets_sc = files["assets"]
        file_scene_run("main assets", path, assets_sc, cam, card, atmp,
                       route="")
        ph.start("main city-obj")
        file_scene_run("main city-obj", *files["city-obj"], cam, card, atmp,
                       route="_stream")
        ph.start("main spec")
        file_scene_run("main spec", *files["spec"], cam, card, atmp,
                       route="_stream")
        ph.start("parity assets")
        for name, (ro, rd, tmax) in ray_sets(assets_sc, cam, dev).items():
            compare(f"assets {name}", assets_sc, ro, rd, 1e-3, tmax, dev,
                    errs)
        frame_parity("assets", assets_sc, cam)
    finally:
        shutil.rmtree(atmp, ignore_errors=True)
    ph.start("bvh")
    bvh_phase(earth, cam, card)

    # ---- what foveation buys: quality, aperture sweep, scaling -------------
    ph.start("quality")
    quality_phase(earth, cam, card)
    ph.start("sweep")
    sweep_phase(earth, cam, card)
    ph.start("scaling")
    stmp = tempfile.mkdtemp(prefix="chip_smoke_scaling_")
    try:
        scaling_phase(stmp, card)
    finally:
        shutil.rmtree(stmp, ignore_errors=True)

    # ---- the row-sharded frame, the train step, app/optimize ----------------
    from fovtrace_torch.dist import launch
    from fovtrace_torch.dist import sharding as shd

    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        ph.start("dist 1-rank")
        launch.init_distributed(f"file://{tmp}/rdzv1", 1, 0, device=dev)
        mesh = shd.make_mesh(1, dev)
        print(f"[dist 1-rank] process group: backend "
              f"{torch.distributed.get_backend()}, world "
              f"{torch.distributed.get_world_size()}, {mesh.device}")
        dist_counts = dist_one_rank("dist 1-rank", earth, cam, cfg_e, mesh,
                                    card, frames=3)
        assert dist_counts["closest_hit"] > 0 and \
            dist_counts["occlusion"] > 0, dist_counts
        city_counts = dist_one_rank("dist 1-rank city", city, cam, cfg_c,
                                    mesh, card, frames=1, exact=False)
        assert city_counts["closest_hit_stream"] > 0 and \
            city_counts["occlusion_stream"] > 0, city_counts
        ph.start("dist 2-rank")
        one = small_dist_run(mesh, card)
        dist_two_ranks(one, tmp, card)
        ph.start("train")
        per_t = train_steps(earth, mesh, card)
        for counts in per_t.values():
            assert counts["material_gather"] > 0 and \
                counts["material_adjoint"] > 0, counts
        # the JSON line's envmap adjoint launches: the 2 timed steps of each
        # train step's (the only paths that train the envmap)
        launches["envmap_adjoint"] = round(sum(
            2 * counts["envmap_adjoint"] for counts in per_t.values()))
        launch.shutdown()
        ph.start("optimize")
        optimize_runs(tmp, card)
        ph.end()
    finally:
        launch.shutdown()
        shutil.rmtree(tmp, ignore_errors=True)

    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": SOURCES[name],
         "replaces": REPLACES[name], "launches": launches[name],
         "max_abs_err": errs[name],
         "ms": row[name][0], "plain_ms": row[name][1],
         "bound_ms": row[name][2], "bound_by": row[name][3],
         "library_ms": library.get(name)}
        for name in KERNELS]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
