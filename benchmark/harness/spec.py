"""BENCHMARK.json and the files it names, found by name:

  configs/<config>.json   a configuration (its file is named in
                          BENCHMARK.json's `configs`)
  traffic/<traffic>.json  a traffic mix, read by harness/traffic.py
  limits/<cell>.json      the limits of the numbers that decide a cell's
                          `correct`, with the readings they were set from
  metrics/<metric>.py     one reader per per-layer metric: read(rec) ->
                          float, or None where it finds nothing to read

A later cell, mix or metric is a new file and a new entry; no file here
changes for it.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

BENCH = Path(__file__).resolve().parent.parent     # benchmark/
REPO = BENCH.parent


def load(repo: Path = REPO) -> dict:
    return json.loads((repo / "BENCHMARK.json").read_text())


def cell(spec: dict, name: str, repo: Path = REPO) -> dict:
    """{workload, config, mix, end_to_end, per_layer} of the cell `name`:
    its configuration and traffic read from their files, and the metrics
    it reports."""
    w = next((w for w in spec["workloads"] if w["name"] == name), None)
    if w is None:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    cfg_entry = next(c for c in spec["configs"] if c["name"] == w["config"])
    config = json.loads((repo / cfg_entry["file"]).read_text())
    mix = json.loads((repo / "benchmark" / "traffic"
                      / f"{w['traffic']}.json").read_text())
    e2e = [m for m in spec["end_to_end"]
           if name in m.get("workloads", [name])]
    moved = {m["name"] for m in e2e}
    per = [m for m in spec["per_layer"]
           if (name in m["workloads"] if "workloads" in m
               else m["moves"] in moved)]
    return {"workload": w, "config": config, "mix": mix, "end_to_end": e2e,
            "per_layer": per}


def reader(metric: str, bench: Path = BENCH):
    """The per-layer reader of `metric`: benchmark/metrics/<metric>.py's
    `read`."""
    path = bench / "metrics" / f"{metric}.py"
    sp = importlib.util.spec_from_file_location(
        "bench_metric_" + metric.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(sp)
    sp.loader.exec_module(mod)
    return mod.read
