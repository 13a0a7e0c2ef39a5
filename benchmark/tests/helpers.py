"""A copy of the benchmark (BENCHMARK.json and benchmark/) in a fresh
directory, optionally with the dense train cell entered: the cell that
the harness carries (harness/trainer.py, traffic/train.json) and that
BENCHMARK.json leaves out while the program's train step fails (PERF.md,
Open questions)."""

import json
import shutil

from harness import spec

TRAIN_METRICS = ("enqueue_ms.train", "kernels_per_step.train",
                 "device_idle_pct.train", "backward_device_ms.train",
                 "adjoint_roofline_pct.train")


def copy_benchmark(dest, train: bool = False):
    shutil.copytree(spec.BENCH, dest / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    b = spec.load()
    if train:
        cell = "earth-uhd.train"
        b["workloads"].append({"name": cell, "config": "earth-uhd",
                               "traffic": "train", "chips": 1,
                               "why": "dense inverse-rendering steps"})
        b["end_to_end"].append({"name": "step_ms", "unit": "ms",
                                "better": "lower", "bound": 0.25,
                                "source": "host_clock", "workloads": [cell]})
        for m in b["end_to_end"]:
            if m["name"] == "setup_s" and "workloads" in m:
                m["workloads"].append(cell)
        for m in b["per_layer"]:
            if m["name"] == "scene_build_s":
                m["workloads"].append(cell)
        for name in TRAIN_METRICS:
            b["per_layer"].append({"name": name, "unit": "ms",
                                   "better": "lower",
                                   "source": "device_trace", "layer": "x",
                                   "moves": "step_ms", "workloads": [cell]})
    (dest / "BENCHMARK.json").write_text(json.dumps(b))
    return dest


def env(dest):
    return {"PYTHONPATH": str(spec.REPO), "PATH": "/usr/bin:/bin",
            "HOME": str(dest)}
