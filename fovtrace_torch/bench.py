"""Headline benchmark of the port: Mrays/s of the foveated frame at 1080p,
fwd+bwd by default (counterpart of the root `bench.py`).

    python -m fovtrace_torch.bench                       # earth, fwd+bwd
    python -m fovtrace_torch.bench --forward-only --scene city --selfcheck
    python -m fovtrace_torch.bench --device cpu --width 64 --height 64

Prints ONE JSON line on stdout, {"metric", "value", "unit",
"vs_baseline"}, as `bench.py` does, with two differences:
  - `metric` names what ran: "fwd" under --forward-only, and the scene
    and size where they differ from earth at 1920x1088;
  - `vs_baseline` is the value over this bench's first number on the
    card for the same (scene, mode, width, height) (`BASELINES`, with
    the card's name and power limit), null where there is none or the
    card has another name; no TPU target carries over.

Ray accounting is `bench.py`'s: the numerator is the frame's
`rays_traced` (G-buffer primary and shadow rays, then per shade bounce
a closest-hit and a shadow ray per budget slot, the first bounce's
padding slots included), valid only when `rays_dropped` is 0. The
configuration, the fixed centre gaze, the probe frame that sizes the
budget, the selfcheck's rays and the timing loop (warm-up steps, then
`--iters` steps and one synchronise; the mean) are `bench.py`'s.

Runs on the card unless given `--device cpu` (each kernel wrapper then
runs its plain version); asked for `cuda` with no card, it exits
non-zero. Diagnostics go to stderr: the card, the mask share, ray_count
beside rays_traced, the first bounce's padding slots and whether their
ray continues (`padding_check`), per-step stream time from CUDA events,
peak device memory, launches per step of each cluster kernel and plain
version, and the camera inverse's host round trips per step.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time

import numpy as np
import torch

from fovtrace_torch import kernels
from fovtrace_torch.config import RenderConfig, pin_fp32
from fovtrace_torch.core import vec
from fovtrace_torch.core.camera import Camera
from fovtrace_torch.kernels import cluster_isect as ci
from fovtrace_torch.kernels import intersect as isect
from fovtrace_torch.render import pipeline
from fovtrace_torch.render import shade as shade_mod
from fovtrace_torch.scene import procedural

EYE, TARGET = (3.0, 2.5, 4.0), (0.0, 0.8, 0.0)
BASE_FRAC = 0.50
SELFCHECK_RAYS = 4096
SELFCHECK_SEED = 7
DEFAULT_SIZE = (1920, 1088)

# This bench's first numbers on the card, vs_baseline's denominators:
# (scene, mode, width, height) -> (Mrays/s, the card as nvidia-smi names
# it with its power limit), each the first run of `python -m
# fovtrace_torch.bench --scene S [--forward-only] --selfcheck` at the
# defaults (--iters 10 --warmup 2).
H100 = "NVIDIA H100 80GB HBM3, 700.00 W"
BASELINES = {
    ("earth", "fwd+bwd", 1920, 1088): (11.50, H100),
    ("earth", "fwd", 1920, 1088): (46.77, H100),
    ("city", "fwd+bwd", 1920, 1088): (12.61, H100),
    ("city", "fwd", 1920, 1088): (34.07, H100),
}


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="fovtrace_torch's headline bench (bench.py's twin)")
    p.add_argument("--width", type=int, default=DEFAULT_SIZE[0])
    p.add_argument("--height", type=int, default=DEFAULT_SIZE[1])
    p.add_argument("--scene", default="earth",
                   choices=sorted(procedural.SCENES))
    p.add_argument("--iters", type=int, default=10)
    p.add_argument("--warmup", type=int, default=2)
    p.add_argument("--forward-only", action="store_true")
    p.add_argument("--selfcheck", action="store_true",
                   help="hold the cluster kernels to the brute-force oracle "
                        "on 4,096 seeded rays before timing")
    p.add_argument("--device", default="cuda",
                   help="torch device (cuda, cuda:1, cpu); cuda with no "
                        "card exits non-zero")
    return p


def bench_config(width: int, height: int) -> RenderConfig:
    """bench.py's configuration: masked sampling, A-Trous, max_depth 4,
    diffuse_max_depth 1, budget 0.50, no display buffers."""
    return RenderConfig(width=width, height=height, reconstruction="atrous",
                        max_depth=4, diffuse_max_depth=1,
                        ray_budget_frac=BASE_FRAC, full_outputs=False)


def budget_frac(ray_count: int, rays_dropped: int, n_pixels: int,
                frac: float = BASE_FRAC) -> float:
    """bench.py's budget sizing after its probe frame: `frac` unless the
    mask is denser than it (or dropped rays), else the mask's share plus
    2% rounded up to a twentieth, at most 1. The ceiling is taken in
    float32, as `jnp.ceil` takes it in bench.py."""
    need = ray_count / n_pixels
    if rays_dropped > 0 or need > frac:
        return min(1.0, float(np.ceil(np.float32((need + 0.02) * 20))) / 20)
    return frac


def size_budget(scene, cam: Camera, gaze, config: RenderConfig):
    """Render one probe frame at `config` and size the budget from it
    (`budget_frac`). Returns (the mask's share of the pixels, the
    fraction, the config with it)."""
    with torch.no_grad():
        probe, _ = pipeline.render_frame(
            scene, cam, gaze, pipeline.FrameState.initial(cam, config),
            config)
    n_pixels = config.width * config.height
    need = int(probe["ray_count"]) / n_pixels
    frac = budget_frac(int(probe["ray_count"]), int(probe["rays_dropped"]),
                       n_pixels, config.ray_budget_frac)
    return need, frac, config.replace(ray_budget_frac=frac)


def selfcheck(scene, dev) -> float:
    """bench.py's parity gate: 4,096 rays from seed 7 scattered around the
    scene's bounding box, the cluster route (the CUDA kernels on the
    card, resident or streaming as routed; the plain versions on the
    CPU) against the brute-force oracle. Returns the share of rays with
    the same winner or an equal t (rtol 1e-4, atol 1e-5); exits unless
    it is above 0.999."""
    r = np.random.default_rng(SELFCHECK_SEED)
    lo, hi = scene.bbox_min.cpu().numpy(), scene.bbox_max.cpu().numpy()
    ctr = (lo + hi) / np.float32(2.0)
    ext = float(np.linalg.norm(hi - lo))
    ro = ctr + r.normal(size=(SELFCHECK_RAYS, 3)).astype(np.float32) * ext
    rd = r.normal(size=(SELFCHECK_RAYS, 3)).astype(np.float32)
    rd /= np.linalg.norm(rd, axis=-1, keepdims=True)
    rov = vec.from_rows(torch.as_tensor(ro, device=dev))
    rdv = vec.from_rows(torch.as_tensor(rd, device=dev))
    hits = [isect.intersect_v(scene, rov, rdv, 1e-3, isect.BIG_T,
                              backend=b) for b in ("cluster", "brute")]
    (tp, ip), (tb, ib) = [(h.t.cpu().numpy(), h.tri.cpu().numpy())
                          for h in hits]
    agree = (ip == ib) | np.isclose(tp, tb, rtol=1e-4, atol=1e-5)
    frac = float(agree.mean())
    log(f"selfcheck cluster-vs-brute agreement: {frac:.4f}")
    if not frac > 0.999:
        raise SystemExit(f"selfcheck: the cluster route and brute force "
                         f"disagree ({frac:.4f} of {SELFCHECK_RAYS} rays "
                         "agree, 0.999 needed)")
    return frac


def padding_check(scene, cam: Camera, gaze, state, config: RenderConfig):
    """Whether the first bounce's padding slots stop there, on this frame.

    The padding slots of the compacted front carry copies of one pixel's
    ray. The port traces and counts them in the first bounce and stops
    them there; the reference lets them bounce on, so its rays_traced
    is larger wherever that ray continues. Returns {"padding": slots,
    "continuing": padding slots alive after bounce 0, "rays_traced": the
    frame's count, "reference_rays_traced": the count with the padding
    bouncing on}; the two counts are equal when none continues."""
    dev = cam.device
    with torch.no_grad():
        gbuf = pipeline.stage_gbuffer(scene, cam, state.prev_camera, config)
        mask, _, is_valid, fetched, gaze_target, _ = pipeline.stage_sampling(
            scene, gbuf, gaze, state, config)
        idx, active, _, _ = pipeline.stage_compact(mask, config)
        ro, rd, seeds = pipeline.shade_front(cam, idx, fetched, is_valid,
                                             state, config, gaze_target)
        n = idx.shape[0]
        go = shade_mod._bounce(
            scene, config, 0, ro, rd, vec.full((n,), 1.0, dev), seeds,
            torch.zeros((n,), dtype=torch.int32, device=dev),
            torch.ones((n,), dtype=torch.bool, device=dev))[6]
        counts = [int(gbuf["rays_traced"] + shade_mod.shade_v(
            scene, ro, rd, seeds, config, active=a)[1]["rays_traced"])
            for a in (active, None)]
    return {"padding": int((~active).sum()),
            "continuing": int((go & ~active).sum()),
            "rays_traced": counts[0], "reference_rays_traced": counts[1]}


def metric_name(scene: str, forward_only: bool, width: int,
                height: int) -> str:
    mode = "fwd" if forward_only else "fwd+bwd"
    size = "1080p" if (width, height) == DEFAULT_SIZE else f"{width}x{height}"
    where = "" if scene == "earth" else f", {scene}"
    return f"Mrays/s/chip {mode} at {size} foveated{where}"


def log(msg: str) -> None:
    print(f"[bench] {msg}", file=sys.stderr, flush=True)


def run(argv=None, scene=None) -> dict:
    """Run the bench (a scene already built on the device may be passed);
    print the JSON line and return it with the run's diagnostics."""
    from fovtrace_torch.scripts import device_label, open_device, sync

    args = build_argparser().parse_args(argv)
    dev = open_device(args.device)
    pin_fp32(dev)
    card = device_label(dev)
    w, h = args.width, args.height
    mode = "fwd" if args.forward_only else "fwd+bwd"
    config = bench_config(w, h)
    if scene is None:
        scene = procedural.SCENES[args.scene](dev)
    cam = Camera.create(eye=EYE, target=TARGET, device=dev)
    gaze = (h // 2, w // 2)
    log(f"card: {card}")
    log(f"scene={args.scene} tris={scene.num_triangles} {w}x{h} "
        f"budget={config.ray_budget} device={dev}")

    agreement = selfcheck(scene, dev) if args.selfcheck else None

    need, frac, config = size_budget(scene, cam, gaze, config)
    log(f"mask covers {100 * need:.2f}% of pixels -> ray_budget_frac {frac} "
        f"(budget {config.ray_budget})")
    state = pipeline.FrameState.initial(cam, config)

    t0 = time.perf_counter()
    with torch.no_grad():
        out, state = pipeline.render_frame(scene, cam, gaze, state, config)
    rays_per_frame = int(out["rays_traced"])
    ray_count, dropped = int(out["ray_count"]), int(out["rays_dropped"])
    log(f"first frame {time.perf_counter() - t0:.2f} s")
    if dropped != 0:
        raise SystemExit(f"the budget truncated the sample mask ({dropped} "
                         "rays dropped): the Mrays/s numerator would "
                         "overcount")
    pad = padding_check(scene, cam, gaze,
                        pipeline.FrameState.initial(cam, config), config)
    log(f"rays_traced {rays_per_frame}, ray_count {ray_count} (masked "
        f"rays), {pad['padding']} padding slots in bounce 0, "
        f"{pad['continuing']} of them continue past it")
    if pad["rays_traced"] != rays_per_frame:
        raise SystemExit(f"padding check: its frame counts "
                         f"{pad['rays_traced']} rays, the bench's "
                         f"{rays_per_frame}")
    if pad["continuing"] == 0:
        if pad["reference_rays_traced"] != rays_per_frame:
            raise SystemExit(f"padding check: no padding ray continues, yet "
                             f"the reference's count "
                             f"{pad['reference_rays_traced']} differs from "
                             f"{rays_per_frame}")
        log("the padding stops at bounce 0: rays_traced is the reference's "
            "count")
    else:
        log(f"the padding continues: the reference would count "
            f"{pad['reference_rays_traced']} rays_traced (the headline keeps "
            f"the port's {rays_per_frame})")

    if args.forward_only:
        def step(st):
            with torch.no_grad():
                return pipeline.render_frame(scene, cam, gaze, st, config)[1]
    else:
        def step(st):
            return pipeline.grad_step(scene, cam, gaze, st, config)

    for _ in range(args.warmup):
        step(state)
        sync(dev)

    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
        events = [torch.cuda.Event(enable_timing=True)
                  for _ in range(args.iters + 1)]
    ci.reset_counters()
    t0 = time.perf_counter()
    if cuda:
        events[0].record()
    for i in range(args.iters):
        step(state)
        if cuda:
            events[i + 1].record()
    sync(dev)
    dt = (time.perf_counter() - t0) / args.iters
    per_step = {k: v / args.iters for k, v in ci.counters().items() if v}
    inv4 = kernels.CALLS["inv4_host"] / args.iters

    mrays = rays_per_frame / dt / 1e6
    log(f"{mode}: {dt * 1e3:.2f} ms/step, {rays_per_frame / 1e6:.2f} "
        f"Mrays/frame -> {mrays:.2f} Mrays/s  [{card}]")
    step_ms, peak = None, None
    if cuda:
        step_ms = [events[i].elapsed_time(events[i + 1])
                   for i in range(args.iters)]
        peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
        log(f"stream time per step: median {statistics.median(step_ms):.2f}, "
            f"min {min(step_ms):.2f}, max {max(step_ms):.2f} ms over "
            f"{args.iters} steps; peak device memory {peak:.2f} GiB  [{card}]")
    log(f"launches and plain calls per step: {json.dumps(per_step)}; camera "
        f"inverse host round trips per step {inv4:g}")

    # against the cell's first number, on a card of the same name only
    base = BASELINES.get((args.scene, mode, w, h))
    same_card = base is not None and card.split(",")[0] == \
        base[1].split(",")[0]
    line = {
        "metric": metric_name(args.scene, args.forward_only, w, h),
        "value": round(mrays, 2),
        "unit": "Mrays/s",
        "vs_baseline": round(mrays / base[0], 4) if same_card else None,
    }
    print(json.dumps(line), flush=True)
    return {"line": line, "mode": mode, "card": card, "need": need,
            "frac": frac, "rays_traced": rays_per_frame,
            "ray_count": ray_count, "rays_dropped": dropped,
            "selfcheck": agreement, "padding": pad, "ms": dt * 1e3,
            "step_ms": step_ms, "peak_gib": peak, "per_step": per_step,
            "inv4_per_step": inv4}


def main(argv=None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    sys.exit(main())
