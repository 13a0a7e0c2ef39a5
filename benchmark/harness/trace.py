"""Spans the benchmark opens around the program's calls, and the reading
of one traced window of torch.profiler (CPU and CUDA activity) into the
records that the per-layer readers (benchmark/metrics/) take.

The profiler's Chrome trace of the window is written to a temporary file,
read and deleted at once: what is kept is the kernel and range lists in
memory and, in the result, the aggregates.
"""

from __future__ import annotations

import bisect
import contextlib
import json
import os
import tempfile
import time
from collections import defaultdict

import torch

WINDOW = "bench.window"
BACKWARD = "autograd::engine::evaluate_function"


class StageSpans:
    """The `timer` of fovtrace_torch's render_frame_staged: each stage in
    a torch.profiler range of its name (when `ranges`), never a sync; and,
    when `capture` is a dict, each stage's result kept under its name."""

    def __init__(self, ranges: bool = False):
        self.ranges = ranges
        self.capture = None

    @contextlib.contextmanager
    def stage(self, name: str):
        box = {}
        if self.ranges:
            with torch.profiler.record_function(name):
                yield box
        else:
            yield box
        if self.capture is not None:
            self.capture[name] = box.get("result")


def profile(body, n: int, device) -> dict:
    """Run body(i) for i < n under torch.profiler inside one WINDOW range
    that ends in a device sync; return the window's records."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        with torch.profiler.record_function(WINDOW):
            for i in range(n):
                body(i)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.unlink(path)
    return records_of(events, n)


def records_of(events: list, units: int) -> dict:
    """Kernels (with the host time and thread of their launch), other
    device operations, the benchmark's ranges, the autograd backward's
    ranges and the host's operations, from Chrome trace events, clipped
    to the WINDOW range."""
    launch = {}
    kernels, devops, ranges, backward, host = [], [], [], [], []
    win = None
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat", "")
        a = e.get("args", {})
        ts, dur = float(e["ts"]), float(e.get("dur", 0.0))
        if cat in ("cuda_runtime", "cuda_driver") and "correlation" in a:
            launch[a["correlation"]] = (ts, e.get("tid"))
        elif cat == "kernel":
            kernels.append({"name": e["name"], "ts": ts, "dur": dur,
                            "corr": a.get("correlation")})
        elif cat in ("gpu_memcpy", "gpu_memset"):
            devops.append({"name": e["name"], "ts": ts, "dur": dur})
        elif cat == "user_annotation":
            if e["name"] == WINDOW:
                win = (ts, ts + dur)
            else:
                ranges.append({"name": e["name"], "ts": ts, "dur": dur,
                               "tid": e.get("tid")})
        elif cat == "cpu_op":
            item = {"name": e["name"], "ts": ts, "dur": dur,
                    "tid": e.get("tid")}
            (backward if e["name"].startswith(BACKWARD) else host).append(
                item)
    if win is None:
        raise RuntimeError("the profiler's trace holds no window range")
    for k in kernels:
        k["launch_ts"], k["launch_tid"] = launch.get(k.pop("corr"),
                                                     (None, None))
    inside = lambda e: win[0] <= e["ts"] <= win[1]
    kernels = [k for k in kernels if inside(k)]
    devops = [d for d in devops if inside(d)]
    return {"units": units, "window_us": win[1] - win[0], "window": win,
            "kernels": kernels, "devops": devops, "ranges": ranges,
            "backward": backward, "host": host}


def busy_intervals(rec: dict) -> list:
    """Merged [start, end] of every device operation in the window."""
    iv = sorted((e["ts"], min(e["ts"] + e["dur"], rec["window"][1]))
                for e in rec["kernels"] + rec["devops"])
    out = []
    for s, e in iv:
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def busy_s(rec: dict) -> float:
    return sum(e - s for s, e in busy_intervals(rec)) * 1e-6


def launched_in(rec: dict, ranges: list) -> list:
    """The kernels whose launch lies inside one of `ranges` (host time,
    the same thread)."""
    by_tid = defaultdict(list)
    for r in ranges:
        by_tid[r["tid"]].append(r)
    index = {tid: _Innermost(rs) for tid, rs in by_tid.items()}
    out = []
    for k in rec["kernels"]:
        ix = index.get(k["launch_tid"])
        if k["launch_ts"] is not None and ix is not None \
                and ix.at(k["launch_ts"]) is not None:
            out.append(k)
    return out


class _Innermost:
    """The innermost of nested host intervals holding a time: a bisect
    over their starts and a short scan back."""

    def __init__(self, items):
        self.items = sorted(items, key=lambda r: r["ts"])
        self.starts = [r["ts"] for r in self.items]

    def at(self, t: float, scan: int = 64):
        i = bisect.bisect_right(self.starts, t) - 1
        for j in range(i, max(-1, i - scan), -1):
            r = self.items[j]
            if t <= r["ts"] + r["dur"]:
                return r["name"]
        return None


def breakdown(rec: dict) -> dict:
    """The ten device operations that took most time, and the ten host
    activities during which the device stood idle longest (seconds)."""
    per = defaultdict(float)
    for e in rec["kernels"] + rec["devops"]:
        per[e["name"]] += e["dur"] * 1e-6
    top = sorted(per.items(), key=lambda kv: -kv[1])[:10]
    stages, ops = _Innermost(rec["ranges"]), _Innermost(rec["host"])
    gaps = defaultdict(float)
    prev = rec["window"][0]
    for s, e in busy_intervals(rec) + [[rec["window"][1]] * 2]:
        if s > prev:
            mid = 0.5 * (prev + s)
            label = " / ".join(x for x in (stages.at(mid), ops.at(mid))
                               if x) or "host, outside any operation"
            gaps[label] += (s - prev) * 1e-6
        prev = max(prev, e)
    idle = sorted(gaps.items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[k, v] for k, v in top],
            "idle_gaps": [[k, v] for k, v in idle]}


def host_clock() -> float:
    return time.perf_counter()
