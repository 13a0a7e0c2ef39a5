"""The run's result line and the last lines of its stderr."""

from __future__ import annotations

import re

import torch

from harness import check, spec as specm, trace, viewer

ISECT = re.compile(r"\b(closest|occlusion)(_stream)?_kernel")


def isect_device_s(rec: dict) -> float:
    """Device seconds of the cluster intersection kernels in a traced
    window."""
    return sum(k["dur"] for k in rec["kernels"]
               if ISECT.search(k["name"])) * 1e-6


def _device(run, got, chips, device, rec) -> dict:
    if device.type == "cuda":
        kind = torch.cuda.get_device_name(device)
        platform = "gpu"
    else:
        kind, platform = "cpu (test run, no device numbers)", "cpu"
    d = {"platform": platform, "kind": kind, "count": chips,
         "memory_peak_bytes": int(got["peak"])}
    if rec is not None:
        d["busy_s"] = got.get("busy_all_s", trace.busy_s(rec))
        d["window_s"] = rec["window_us"] * 1e-6
    return d


def result(args, cell, run, got, numbers, bound, chips, device):
    """(the result object, stderr's last lines)."""
    name = cell["workload"]["name"]
    limits = check.limits_of(specm.BENCH, name)
    correct, shown = check.judge(numbers, limits)
    correct = correct and got["failed"] == 0
    metrics = {}
    rec = got["records"]
    if args.trace:
        rec["clock"] = {"scene_build_s": got["scene_build_s"],
                        "enqueue_ms": [s * 1e3 for s in got["enqueue"]],
                        "latency_ms": [s * 1e3 for s in got["latencies"]]}
        rec["bounds"] = dict(bound, chips=chips)
        if "isect_all_s" in got:
            rec["isect_all_s"] = got["isect_all_s"]
        for m in cell["per_layer"]:
            v = specm.reader(m["name"])(rec)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        vals = {"setup_s": got["setup_s"],
                "memory_per_card_gb": got["peak"] * 1e-9}
        if run.mix["kind"] == "view":
            vals.update(viewer.frame_stats(got["latencies"],
                                           got["window_s"]))
        else:
            vals["step_ms"] = got["window_s"] / len(got["latencies"]) * 1e3
        for m in cell["end_to_end"]:
            metrics[m["name"]] = {"value": vals[m["name"]],
                                  "unit": m["unit"]}
    line = {"correct": bool(correct), "attempted": got["attempted"],
            "failed": got["failed"], "metrics": metrics,
            "device": _device(run, got, chips, device, rec)}
    if args.trace:
        line["breakdown"] = trace.breakdown(rec)
    line["checks"] = shown
    tail = [f"[check] {k} {v['value']!r} limit {v['limit']!r}"
            for k, v in shown.items()]
    tail.append(f"[check] failed {got['failed']} limit 0")
    return line, tail
