"""Scaling of the row-sharded frame over N ranks (counterpart of the
measured half of `scripts/scaling_bench.py`).

    python -m fovtrace_torch.scripts.scaling_bench [--device cuda]
        [--ranks 1 2 4 8] [--backend nccl|gloo] [--width 1024 --height 1024]
        [--iters 8] [--out DIR]

For each rank count N this process starts N rank processes of itself
(`--worker`), joined into one process group through
`dist.launch.init_distributed` (a file rendezvous in a temporary
directory under --out). Each rank renders its block of the frame with
`dist.sharding.render_sharded` (atrous, max_depth 4, diffuse_max_depth
1, ray_budget_frac 0.30, the gaze at the centre): two warm frames, then
--iters frames timed on the host clock ending in a device synchronise.
Rank 0 hands its row back (ms/frame, the frame's rays_traced and
rays_dropped, its kernel launches in the timed frames), and this
process writes SCALING_torch.md under --out: ranks, ms/frame, Mrays/s
and efficiency = rate / (rate at the first N x N).

Under NCCL each rank takes its own card (N is capped at the visible
cards); `--backend gloo` lets the N ranks share one card (or the CPU),
and then the table shows the collectives' structure, not scaling. An N
whose rows do not split into blocks of a multiple of 8 rows is skipped.
The reference's analytic projection of its collectives at a TPU's
interconnect rate is not ported.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch

from fovtrace_torch import _build
from fovtrace_torch.scripts import (EYE, REPORTS_DIR, TARGET, device_label,
                                    open_device, sync)

RANK_TIMEOUT_S = 900


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default="cuda")
    p.add_argument("--backend", choices=("nccl", "gloo"), default=None,
                   help="default: nccl on cuda (one card per rank), gloo "
                        "on the cpu")
    p.add_argument("--ranks", type=int, nargs="*", default=[1, 2, 4, 8])
    p.add_argument("--width", type=int, default=1024)
    p.add_argument("--height", type=int, default=1024)
    p.add_argument("--scene", default="earth")
    p.add_argument("--iters", type=int, default=8)
    p.add_argument("--out", default=str(REPORTS_DIR),
                   help="directory of SCALING_torch.md")
    p.add_argument("--worker", nargs=4, metavar=("RANK", "WORLD", "URL",
                                                 "RESULT"),
                   help=argparse.SUPPRESS)
    return p


def backend_of(args) -> str:
    if args.backend is not None:
        return args.backend
    return "nccl" if torch.device(args.device).type == "cuda" else "gloo"


def rank_counts(args) -> list:
    """The rank counts to run: under NCCL at most the visible cards, and
    only those whose row blocks are a multiple of 8 rows."""
    ns = []
    for n in args.ranks:
        if backend_of(args) == "nccl" and n > torch.cuda.device_count():
            print(f"[scaling] skip n={n}: {torch.cuda.device_count()} "
                  f"card(s) visible", file=sys.stderr)
        elif args.height % n or (args.height // n) % 8:
            print(f"[scaling] skip n={n}: height alignment", file=sys.stderr)
        else:
            ns.append(n)
    return ns


def worker(args) -> int:
    """One rank: join the group, render, and (rank 0) write the row."""
    from fovtrace_torch.config import RenderConfig, pin_fp32
    from fovtrace_torch.core.camera import Camera
    from fovtrace_torch.dist import launch
    from fovtrace_torch.dist import sharding as shd
    from fovtrace_torch.kernels import cluster_isect as ci
    from fovtrace_torch.scene import procedural

    rank, world, url, result = (int(args.worker[0]), int(args.worker[1]),
                                args.worker[2], args.worker[3])
    open_device(args.device)
    launch.init_distributed(url, world, rank, device=args.device,
                            backend=backend_of(args))
    try:
        mesh = shd.make_mesh(world, args.device)
        dev = mesh.device
        pin_fp32(dev)
        scene = procedural.SCENES[args.scene](dev)
        cam = Camera.create(eye=EYE, target=TARGET, device=dev)
        config = RenderConfig(width=args.width, height=args.height,
                              reconstruction="atrous", max_depth=4,
                              diffuse_max_depth=1, ray_budget_frac=0.30)
        state = shd.initial_state_sharded(cam, config, mesh)
        gaze = (args.height // 2, args.width // 2)
        for _ in range(2):
            out, state = shd.render_sharded(scene, cam, gaze, state, config,
                                            mesh)
        sync(dev)
        ci.reset_counters()
        t0 = time.perf_counter()
        for _ in range(args.iters):
            out, state = shd.render_sharded(scene, cam, gaze, state, config,
                                            mesh)
        sync(dev)
        ms = (time.perf_counter() - t0) / args.iters * 1e3
        if rank == 0:
            row = {"ranks": world, "ms": ms,
                   "rays_traced": int(out["rays_traced"]),
                   "rays_dropped": int(out["rays_dropped"]),
                   "ray_count": int(out["ray_count"]),
                   "launches": {k: v for k, v in ci.counters().items() if v},
                   "device": device_label(dev)}
            Path(result).write_text(json.dumps(row))
    finally:
        launch.shutdown()
    return 0


def run_group(args, n: int, tmp: str) -> dict:
    """Start n rank processes, wait for them and return rank 0's row."""
    backend = backend_of(args)
    url = f"file://{tmp}/rdzv{n}"
    result = os.path.join(tmp, f"row{n}.json")
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        [str(_build.REPO_ROOT)] + [p for p in [os.environ.get("PYTHONPATH")]
                                   if p])}
    common = ["--device", args.device, "--backend", backend, "--width",
              str(args.width), "--height", str(args.height), "--scene",
              args.scene, "--iters", str(args.iters)]
    procs = [subprocess.Popen(
        [sys.executable, "-m", "fovtrace_torch.scripts.scaling_bench",
         *common, "--worker", str(r), str(n), url, result],
        cwd=str(_build.REPO_ROOT),
        # NCCL: one card per rank; gloo: every rank on the first card
        env={**env, "LOCAL_RANK": str(r if backend == "nccl" else 0)},
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(n)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=RANK_TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    codes = [p.returncode for p in procs]
    if codes != [0] * n:
        raise RuntimeError(f"n={n}: rank exit codes {codes}\n"
                           + "\n".join(logs)[-4000:])
    return json.loads(Path(result).read_text())


def scaling_rows(args) -> list:
    """One row per rank count (ranks, ms, mrays_s, efficiency, and rank
    0's rays_traced, rays_dropped, ray_count, launches, device)."""
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    rows, base_rate = [], None
    with tempfile.TemporaryDirectory(dir=out, prefix=".scaling_") as tmp:
        for n in rank_counts(args):
            t0 = time.perf_counter()
            row = run_group(args, n, tmp)
            rate = row["rays_traced"] / (row["ms"] / 1e3) / 1e6
            if base_rate is None:
                base_rate = rate
            row.update(mrays_s=rate, efficiency=rate / (base_rate * n) * 100)
            rows.append(row)
            print(json.dumps(row), flush=True)
            print(f"[scaling] n={n}: {row['ms']:.2f} ms/frame, {rate:.3f} "
                  f"Mrays/s, eff {row['efficiency']:.1f}%, rays_dropped "
                  f"{row['rays_dropped']} (group wall "
                  f"{time.perf_counter() - t0:.1f} s with the ranks' start)"
                  f"  [{row['device']}]", file=sys.stderr, flush=True)
    return rows


def report(args, rows) -> str:
    backend = backend_of(args)
    shared = backend == "gloo"
    device = rows[0]["device"] if rows else device_label(args.device)
    where = ("the ranks share one device, so the table shows the "
             "collectives' structure, not scaling" if shared else
             "one card per rank")
    lines = [f"# Scaling of the sharded frame (fovtrace_torch, {backend}: "
             f"{where})", "",
             f"scene={args.scene} {args.width}x{args.height}, device: "
             f"{device}, backend {backend}; dist.sharding.render_sharded "
             f"(atrous, max_depth 4, diffuse_max_depth 1, ray_budget_frac "
             f"0.30, centre gaze), 2 warm frames, then the mean of "
             f"{args.iters}. Written by "
             f"`python -m fovtrace_torch.scripts.scaling_bench`.", "",
             "| ranks | ms/frame | Mrays/s | efficiency |",
             "|---|---|---|---|"]
    for r in rows:
        lines.append(f"| {r['ranks']} | {r['ms']:.2f} | {r['mrays_s']:.3f} "
                     f"| {r['efficiency']:.1f}% |")
    dropped = [r["ranks"] for r in rows if r["rays_dropped"]]
    if dropped:
        lines += ["", f"Rays were dropped at N = {dropped}: their Mrays/s "
                      "count a truncated frame."]
    return "\n".join(lines) + "\n"


def main(argv=None) -> int:
    args = build_argparser().parse_args(argv)
    if args.worker:
        return worker(args)
    open_device(args.device)
    rows = scaling_rows(args)
    text = report(args, rows)
    print(text, file=sys.stderr)
    (Path(args.out) / "SCALING_torch.md").write_text(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
