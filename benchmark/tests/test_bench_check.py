"""A train run's numbers read inf, and fail every limit, where the
program's loss or a gradient is not finite, whichever step or leaf it is
in (harness/check.train_numbers)."""

import math

import pytest
import torch

from harness import check

LIMITS = {"loss_gap": 1e-3, "grad_gap": 1e-2, "change_gap": 1e-2}


def _side(scale=1.0):
    g = torch.Generator().manual_seed(3)
    leaves = [torch.randn(n, generator=g) for n in (3, 3, 2, 3, 12, 96)]
    return {"losses": [0.04, 0.039, 0.038],
            "grad1": [t * scale for t in leaves],
            "change": [t * 0.02 for t in leaves]}


def test_the_same_readings_pass():
    ok, _ = check.judge(check.train_numbers(_side(), _side()), LIMITS)
    assert ok


@pytest.mark.parametrize("where", ["loss", "grad", "change"])
@pytest.mark.parametrize("index", [0, 1, 2])
def test_a_nan_anywhere_reads_inf(where, index):
    p = _side()
    if where == "loss":
        p["losses"][index] = math.nan
    else:
        p["grad1" if where == "grad" else "change"][index + 2][0] = math.nan
    n = check.train_numbers(p, _side())
    assert n[f"{where}_gap"] == math.inf
    ok, _ = check.judge(n, LIMITS)
    assert not ok


def test_a_nan_in_the_reference_is_kept_and_fails():
    r = _side()
    r["grad1"][1][0] = math.nan
    assert check.kept_leaves(r["grad1"])[1]
    assert check.train_numbers(_side(), r)["grad_gap"] == math.inf
