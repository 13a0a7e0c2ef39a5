"""A run with the timed path broken underneath comes out not correct:
each fault a cell can have (harness/faults.py), on the CPU at a small
size, through benchmark/run.py with its look for a card skipped. The
dense train cell is entered in a copy of the benchmark (tests/helpers)."""

import json
import subprocess
import sys

import pytest

from harness import spec
from helpers import copy_benchmark, env

VIEW = [("earth-uhd.orbit", f) for f in ("state_unchanged", "half_batch",
                                        "altered_answer")] + \
       [("city-uhd-rows4.orbit", "no_exchange")]
TRAIN = ["state_unchanged", "half_batch", "altered_answer"]


def _run(cell, fault=None, cwd=spec.REPO, run_env=None, size="64x64"):
    argv = [sys.executable, "benchmark/run.py", "--workload", cell, "--seed",
            "2718281828459", "--seconds", "0.5", "--trace", "0", "--device",
            "cpu", "--size", size]
    if fault:
        argv += ["--fault", fault]
    out = subprocess.run(argv, cwd=cwd, capture_output=True, text=True,
                         timeout=900, env=run_env)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.splitlines()[-1])


@pytest.mark.parametrize("cell,fault", VIEW)
def test_fault_makes_the_run_not_correct(cell, fault):
    assert _run(cell, fault)["correct"] is False


@pytest.mark.parametrize("fault", [None] + TRAIN)
def test_train_cell_faults(tmp_path, fault):
    root = copy_benchmark(tmp_path, train=True)
    got = _run("earth-uhd.train", fault, cwd=root, run_env=env(root))
    assert got["correct"] is (fault is None)


def test_the_same_view_run_unbroken_is_correct():
    assert _run("earth-uhd.orbit")["correct"] is True


@pytest.mark.cuda
def test_card_run_is_correct(card):
    """On the card: one short run of the cheapest cell."""
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "earth-uhd.orbit",
         "--seed", "31", "--seconds", "2", "--trace", "0"], cwd=spec.REPO,
        capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    assert json.loads(out.stdout.splitlines()[-1])["correct"] is True
