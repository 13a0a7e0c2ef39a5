"""A copy of the benchmark (BENCHMARK.json and benchmark/) in a fresh
directory, optionally with the dense train cell entered: the cell that
the harness carries (harness/trainer.py, traffic/train.json,
limits/earth-uhd.train.json) and that BENCHMARK.json leaves out while the
program's train step returns non-finite gradients (PERF.md, Open
questions). TRAIN holds the entries that admit it; an entry that
BENCHMARK.json already has is not added twice."""

import copy
import json
import shutil

from harness import spec

CELL = "earth-uhd.train"
ON_CELL = {"moves": "step_ms", "workloads": [CELL]}
TRAIN = {
    "workloads": [
        {"name": CELL, "config": "earth-uhd", "traffic": "train", "chips": 1,
         "why": "dense 3840x2176 inverse-rendering steps: the backward "
                "through shading, refinement, the material and envmap "
                "adjoints, and Adam; no other cell runs a backward"}],
    "end_to_end": [
        {"name": "step_ms", "unit": "ms", "better": "lower", "bound": 0.18,
         "source": "host_clock", "workloads": [CELL]}],
    "per_layer": [
        dict(name="enqueue_ms.train", unit="ms", better="lower",
             source="host_clock", layer="dist/train.py host path", **ON_CELL),
        dict(name="kernels_per_step.train", unit="kernels/step",
             better="lower", source="device_trace", layer="device",
             **ON_CELL),
        dict(name="device_idle_pct.train", unit="%", better="lower",
             source="device_trace", layer="device", **ON_CELL),
        dict(name="backward_device_ms.train", unit="ms", better="lower",
             source="device_trace",
             layer="autograd backward (render/shade.py, render/gbuffer.py, "
                   "kernels/intersect.py)", **ON_CELL),
        dict(name="adjoint_roofline_pct.train", unit="%", better="higher",
             source="device_trace",
             layer="csrc/material.cu and csrc/envmap.cu adjoints",
             **ON_CELL)],
}


def with_train(b: dict) -> dict:
    """BENCHMARK.json's object `b` with the train cell's entries added
    where it lacks them, and the cell in scene_build_s's list."""
    for key, entries in TRAIN.items():
        have = {e["name"] for e in b[key]}
        b[key] += [copy.deepcopy(e) for e in entries
                   if e["name"] not in have]
    for m in b["per_layer"]:
        if m["name"] == "scene_build_s" and CELL not in m["workloads"]:
            m["workloads"].append(CELL)
    return b


def copy_benchmark(dest, train: bool = False):
    shutil.copytree(spec.BENCH, dest / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    b = spec.load()
    if train:
        b = with_train(b)
    (dest / "BENCHMARK.json").write_text(json.dumps(b))
    return dest


def env(dest):
    return {"PYTHONPATH": str(spec.REPO), "PATH": "/usr/bin:/bin",
            "HOME": str(dest)}
