"""fovtrace_torch's benchmark: one cell, one run.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

The cell (BENCHMARK.json `workloads`) names a configuration
(benchmark/configs/), a traffic mix (benchmark/traffic/) and its cards.
The run builds the program's inputs from the seed, warms up the cell's
shapes (set-up), measures for --seconds, checks what the timed path
produced against the plain reference (benchmark/reference/), and prints
as its last stdout line one JSON object: correct, attempted, failed,
metrics (the cell's end-to-end metrics with --trace 0, its per-layer
metrics with --trace 1), device, with --trace 1 a breakdown, and last the
numbers compared with their limits (also the last lines of stderr).

A cell on four cards starts three more processes of this script, one a
card, joined through a file under TMPDIR; rank 0 prints the line. With
no CUDA device, or fewer than the cell asks for, it exits 2 and prints
no result. It reads and writes only its checkout (the port's kernels
build into build/ there) and TMPDIR.

Testing hooks (benchmark/tests): --device cpu with --size WxH runs the
whole cell on the CPU at a small size (the port's plain route), and
--fault NAME breaks the timed path underneath (harness/faults.py).
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import signal  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
REPO = BENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "fovtrace")


def _caches() -> None:
    """Every build and kernel cache inside the checkout, at fixed paths;
    one host thread for the CPU's math libraries (the frame's host work
    is launching kernels; pools of spinning threads only add noise)."""
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS",
                "OPENBLAS_NUM_THREADS"):
        os.environ[var] = "1"
    b = REPO / "build"
    os.environ["TRITON_CACHE_DIR"] = str(b / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(b / "torch_extensions")
    os.environ["CUDA_CACHE_PATH"] = str(b / "cuda_cache")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def forbidden_modules() -> list:
    """Loaded modules whose top-level name (before the first dot) is, whole,
    one the benchmark must never load."""
    return sorted(m for m in list(sys.modules)
                  if m.split(".", 1)[0] in FORBIDDEN)


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--rank", type=int, default=0, help=argparse.SUPPRESS)
    p.add_argument("--rendezvous", default=None, help=argparse.SUPPRESS)
    p.add_argument("--device", default="cuda", help=argparse.SUPPRESS)
    p.add_argument("--size", default=None, help=argparse.SUPPRESS)
    p.add_argument("--fault", default=None, help=argparse.SUPPRESS)
    return p


def _fail(msg: str, code: int = 2):
    print(f"[bench] {msg}", file=sys.stderr)
    raise SystemExit(code)


def _spawn(argv: list, chips: int, rdv: str) -> list:
    """Ranks 1..chips-1 of this run, each a process of this script."""
    procs = []
    for r in range(1, chips):
        procs.append(subprocess.Popen(
            [sys.executable, str(Path(__file__).resolve()), *argv,
             "--rank", str(r), "--rendezvous", rdv],
            stdout=subprocess.DEVNULL, cwd=os.getcwd()))
    return procs


def _reap(procs: list, ok: bool) -> bool:
    for p in procs:
        if not ok:
            p.kill()
    codes = [p.wait(timeout=600) for p in procs]
    return all(c == 0 for c in codes)


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    args = build_argparser().parse_args(argv)
    _caches()
    sys.path.insert(0, str(BENCH))
    sys.path.insert(1, str(REPO))
    import torch

    from harness import spec as specm

    spec = specm.load()
    cell = specm.cell(spec, args.workload)
    chips = cell["workload"]["chips"]
    config = cell["config"]
    if args.size:
        w, h = (int(x) for x in args.size.split("x"))
        config = dict(config, width=w, height=h)
    if args.device == "cuda":
        if not torch.cuda.is_available():
            _fail("torch.cuda.is_available() is false: no result")
        if torch.cuda.device_count() < chips:
            _fail(f"the cell asks for {chips} CUDA devices, "
                  f"{torch.cuda.device_count()} present: no result")
        device = torch.device("cuda", args.rank)
        torch.cuda.set_device(device)
        torch.set_num_threads(1)
    else:
        device = torch.device(args.device)
        torch.set_num_threads(2)

    procs, tmp = [], None
    # a terminated run unwinds through `finally`, which ends the ranks
    signal.signal(signal.SIGTERM, lambda *_: sys.exit(143))
    if chips > 1 and args.rank == 0:
        tmp = tempfile.mkdtemp(prefix="fovbench-")
        args.rendezvous = "file://" + os.path.join(tmp, "rendezvous")
        procs = _spawn(argv, chips, args.rendezvous)
    ok = False
    try:
        code = _run(args, spec, cell, config, chips, device)
        ok = code == 0
    finally:
        reaped = _reap(procs, ok)
        if tmp:
            for f in Path(tmp).iterdir():
                f.unlink()
            os.rmdir(tmp)
    return code if reaped else 1


def _run(args, spec, cell, config, chips, device) -> int:
    import torch

    from harness import faults, report, trainer, viewer
    from harness.viewer import Run

    mesh = None
    if chips > 1:
        backend = "nccl" if device.type == "cuda" else "gloo"
        torch.distributed.init_process_group(
            backend, init_method=args.rendezvous, world_size=chips,
            rank=args.rank)
        from fovtrace_torch.dist.collectives import Mesh
        mesh = Mesh(rank=args.rank, size=chips, device=device,
                    group=torch.distributed.group.WORLD)
    run = Run(config=config, mix=cell["mix"], seed=args.seed,
              seconds=args.seconds, traced=bool(args.trace), device=device,
              dist=mesh, t0=T0)
    kind = cell["mix"]["kind"]
    with faults.applied(args.fault):
        got = (viewer if kind == "view" else trainer).run_program(run)
    if mesh is not None:
        peak = torch.tensor([got["peak"]], dtype=torch.float64, device=device)
        torch.distributed.all_reduce(peak, torch.distributed.ReduceOp.MAX)
        got["peak"] = int(peak.item())
        if got["records"] is not None:
            from harness import trace
            b = torch.tensor([trace.busy_s(got["records"])],
                             dtype=torch.float64, device=device)
            torch.distributed.all_reduce(b)
            got["busy_all_s"] = float(b.item()) / chips
            isect = torch.tensor([report.isect_device_s(got["records"])],
                                 dtype=torch.float64, device=device)
            torch.distributed.all_reduce(isect)
            got["isect_all_s"] = float(isect.item())
        torch.distributed.barrier()
    if not got["lead"]:
        torch.distributed.destroy_process_group()
        return 0
    print(f"[bench] set-up {got['setup_s']:.3f} s, window "
          f"{got['window_s']:.3f} s, {got['attempted']} attempted, "
          f"peak {got['peak']} B", file=sys.stderr)
    t_ref = time.perf_counter()
    if kind == "view":
        ref = viewer.reference_frames(run, got, count_work=run.traced)
        numbers, bound = ref["numbers"], {"isect_s": ref["isect_s"]}
    else:
        ref = trainer.reference_steps(run)
        numbers = trainer.compare(got, ref)
        bound = {"adjoint_s": trainer.train_bound_s(run)}
    print(f"[bench] reference and comparison "
          f"{time.perf_counter() - t_ref:.3f} s", file=sys.stderr)
    found = forbidden_modules()
    if mesh is not None:
        torch.distributed.destroy_process_group()
    if found:
        _fail("modules of JAX or of the JAX package are loaded: "
              + ", ".join(found))
    line, tail = report.result(args, cell, run, got, numbers, bound, chips,
                               device)
    for s in tail:
        print(s, file=sys.stderr)
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
