"""Per-stage timing and the CSV report (counterpart of
`fovtrace/app/profiler.py`).

`StageTimer.stage` times one stage on the host clock and waits for the
stage's result before it stops the clock: a CUDA tensor in the result
synchronises its device, CPU tensors need nothing. The frame's own
ms/frame is the CLI's host clock around a whole frame; the stage sum
is a diagnostic (each synchronise costs the overlap of host and device
that the unsynchronised frame keeps).
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import time
from typing import Dict, List, Optional

import torch


def _cuda_devices(obj, found: set) -> set:
    """The CUDA devices of the tensors in a nest of tensors, dicts,
    lists, tuples (Vec3 included) and dataclasses."""
    if isinstance(obj, torch.Tensor):
        if obj.is_cuda:
            found.add(obj.device)
    elif isinstance(obj, dict):
        for v in obj.values():
            _cuda_devices(v, found)
    elif isinstance(obj, (list, tuple)):
        for v in obj:
            _cuda_devices(v, found)
    elif dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        for f in dataclasses.fields(obj):
            _cuda_devices(getattr(obj, f.name), found)
    return found


class StageTimer:
    """Accumulates milliseconds per named stage across frames, and one
    row per frame for the CSV report."""

    def __init__(self) -> None:
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}
        self.frame_rows: List[Dict[str, float]] = []
        self._current: Dict[str, float] = {}

    @contextlib.contextmanager
    def stage(self, name: str):
        """Time the block as stage `name`. The block puts its result in
        the yielded dict under "result"; the clock stops once every CUDA
        device that holds a tensor of it has finished."""
        t0 = time.perf_counter()
        box: Dict[str, object] = {}
        yield box
        for dev in _cuda_devices(box.get("result"), set()):
            torch.cuda.synchronize(dev)
        self.add(name, (time.perf_counter() - t0) * 1e3)

    def add(self, name: str, ms: float) -> None:
        self.totals[name] = self.totals.get(name, 0.0) + ms
        self.counts[name] = self.counts.get(name, 0) + 1
        self._current[name] = ms

    def end_frame(self, extra: Optional[Dict[str, float]] = None) -> None:
        row = dict(self._current)
        if extra:
            row.update(extra)
        self.frame_rows.append(row)
        self._current = {}

    def means(self) -> Dict[str, float]:
        """Mean ms of each stage, in the order first seen."""
        return {k: self.totals[k] / self.counts[k] for k in self.totals}

    def summary(self) -> str:
        return "  ".join(f"{k}={v:.2f}ms" for k, v in self.means().items())

    def _csv_keys(self) -> List[str]:
        keys: List[str] = []
        for row in self.frame_rows:
            keys.extend(k for k in row if k not in keys)
        return keys

    def csv_header(self) -> str:
        return ",".join(self._csv_keys())

    def write_csv(self, path: str) -> None:
        keys = self._csv_keys()
        with open(path, "w") as f:
            f.write(",".join(keys) + "\n")
            for row in self.frame_rows:
                f.write(",".join(f"{row.get(k, 0.0):.4f}" for k in keys)
                        + "\n")


def trace_profile(path: str):
    """A torch.profiler context that writes a Chrome trace of what runs
    inside it (host ops, and device kernels when CUDA is available)
    into the directory `path`."""
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)

    os.makedirs(path, exist_ok=True)
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    return profile(activities=acts, on_trace_ready=tensorboard_trace_handler(
        path))
