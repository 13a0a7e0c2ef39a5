"""The control, the reference with bfloat16 between its stages put in the
program's place, comes out not correct under each cell's limits, at a
size a test run holds (benchmark/calibrate.py; on the card at the cells'
own sizes, PERF.md)."""

import json
import subprocess
import sys

import pytest

from harness import check, spec
from helpers import copy_benchmark, env


def _control(cell, cwd=spec.REPO, run_env=None):
    out = subprocess.run(
        [sys.executable, "benchmark/calibrate.py", "--workload", cell,
         "--control-seeds", "4,5,6", "--device", "cpu", "--size", "64x64"],
        cwd=cwd, capture_output=True, text=True, timeout=900, env=run_env)
    assert out.returncode == 0, out.stderr[-3000:]
    return [json.loads(s) for s in out.stdout.splitlines()]


@pytest.mark.parametrize("cell", ["earth-uhd.orbit", "city-uhd.orbit"])
def test_control_fails_the_limits(cell):
    limits = check.limits_of(spec.BENCH, cell)
    lines = _control(cell)
    assert len(lines) == 3
    for r in lines:
        ok, shown = check.judge(r["numbers"], limits)
        assert not ok, shown


def test_train_control_fails_the_limits(tmp_path):
    root = copy_benchmark(tmp_path, train=True)
    limits = check.limits_of(spec.BENCH, "earth-uhd.train")
    for r in _control("earth-uhd.train", root, env(root)):
        ok, shown = check.judge(r["numbers"], limits)
        assert not ok, shown
