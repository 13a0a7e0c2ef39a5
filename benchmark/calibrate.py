"""The readings that a cell's limits are set from (benchmark/limits/).

    python3 benchmark/calibrate.py --workload <cell> --seeds 1,2,3 \
        --control-seeds 4,5,6 [--seconds 2]

Program readings: for each of --seeds, a run of the cell as
benchmark/run.py makes it (set-up, a window of --seconds, the kept
frames or the checked steps against the reference), the scene built
once for all seeds. Control readings: for each of --control-seeds, the
reference put in the program's place and computed with bfloat16 between
its stages (a viewer: every float the G-buffer, the shading, the history
and the image hand on; a train step: the rendered image before the
loss), against the float32 reference, compared as a run compares the
program. One JSON line per reading on stdout. On one card only.
"""

from __future__ import annotations

import argparse
import functools
import json
import sys
from pathlib import Path

import torch

BENCH = Path(__file__).resolve().parent
sys.path.insert(0, str(BENCH))
sys.path.insert(1, str(BENCH.parent))

from harness import program, refside, spec as specm  # noqa: E402
from harness import trainer, viewer  # noqa: E402
from harness.viewer import Run  # noqa: E402
import run as runmod  # noqa: E402


def bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).to(x.dtype)


def _memo(fn):
    cache = {}

    @functools.wraps(fn)
    def f(config, mesh, env, device):
        key = (config["name"], str(device))
        if key not in cache:
            cache[key] = fn(config, mesh, env, device)
        return cache[key]
    return f


def control_view(run: Run) -> dict:
    """The bfloat16 reference's frames 0 and 1 (its own chain) as the
    program, against the float32 reference."""
    from harness import traffic
    from reference import pipeline as rp

    cfg, dev = run.config, run.device
    seq = traffic.view_sequence(run.seed, run.mix, cfg)
    from harness import scenes
    scene = refside.build_scene(cfg, scenes.mesh_arrays(cfg),
                                scenes.envmap_array(cfg), dev)
    frac = cfg["render"]["ray_budget_frac"]
    rc = refside.render_config(cfg, run.mix.get("render"))
    cam = lambda f: refside.camera(*seq.frame(f)[:2], cfg, dev)
    frames, state = [], rp.FrameState.initial(cam(0), rc)
    for f in (0, 1):
        state_in = state
        with torch.no_grad():
            out, state = rp.render_frame(scene, cam(f), seq.frame(f)[2],
                                         state, rc, quantize=bf16)
        host = viewer._host_frame(out, state, {"GB": out["gbuf"],
                                               "Sampling": (out["mask"],)})
        frames.append((state_in, host))
    got = {"seq": seq, "frac": frac, "start": {"host": frames[0][1]},
           "sampled": {"frame": 1, "host": frames[1][1],
                       "history_in": frames[1][0].history.cpu(),
                       "depth_in": frames[1][0].depth_cache.cpu()}}
    return viewer.reference_frames(run, got)["numbers"]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--device", default="cuda", help=argparse.SUPPRESS)
    p.add_argument("--size", default=None, help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    runmod._caches()
    cell = specm.cell(specm.load(), args.workload)
    if cell["workload"]["chips"] != 1:
        raise SystemExit("calibrate runs one-card cells")
    config = cell["config"]
    if args.size:
        w, h = (int(x) for x in args.size.split("x"))
        config = dict(config, width=w, height=h)
    dev = torch.device(args.device)
    if dev.type == "cpu":
        torch.set_num_threads(2)
    program.build_scene = _memo(program.build_scene)
    refside.build_scene = _memo(refside.build_scene)
    kind = cell["mix"]["kind"]
    seeds = [int(s) for s in args.seeds.split(",") if s]
    for seed in seeds:
        run = Run(config=config, mix=cell["mix"], seed=seed,
                  seconds=args.seconds, traced=False, device=dev,
                  t0=runmod.T0)
        if kind == "view":
            got = viewer.run_program(run)
            numbers = viewer.reference_frames(run, got)["numbers"]
            extra = {}
        else:
            got = trainer.run_program(run)
            ref = trainer.reference_steps(run)
            numbers = trainer.compare(got, ref)
            extra = {"leaves": leaf_norms(got["checked"], ref)}
        print(json.dumps({"reading": "program", "seed": seed,
                          "failed": got["failed"], "numbers": numbers,
                          **extra}), flush=True)
    for seed in [int(s) for s in args.control_seeds.split(",") if s]:
        run = Run(config=config, mix=cell["mix"], seed=seed,
                  seconds=args.seconds, traced=False, device=dev)
        extra = {}
        if kind == "view":
            numbers = control_view(run)
        else:
            numbers, extra["leaves"] = check_train_control(run)
        print(json.dumps({"reading": "control", "seed": seed,
                          "numbers": numbers, **extra}), flush=True)
    return 0


def check_train_control(run: Run):
    """(the bfloat16 control's numbers, its leaf_norms)."""
    from harness import check
    ref = trainer.reference_steps(run)
    ctl = trainer.reference_steps(run, quantize=bf16)
    return check.train_numbers(ctl, ref), leaf_norms(ctl, ref)


def leaf_norms(p: dict, r: dict) -> dict:
    """Each checked step's loss and each leaf's norm of the first
    gradient and of the change, as [one side's, the reference's]."""
    def norms(a, b):
        return [[float(torch.linalg.vector_norm(x.double())),
                 float(torch.linalg.vector_norm(y.double()))]
                for x, y in zip(a, b)]
    return {"losses": [[a, b] for a, b in zip(p["losses"], r["losses"])],
            "grad1": norms(p["grad1"], r["grad1"]),
            "change": norms(p["change"], r["change"])}


if __name__ == "__main__":
    raise SystemExit(main())
