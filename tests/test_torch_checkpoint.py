"""Checkpoint and resume of the port's optimisation loop
(fovtrace_torch.dist.checkpoint): the four cases of
tests/test_checkpoint.py, then app/optimize on the CPU at 32x32 with a
resume, and a run cut short and resumed against an uninterrupted one."""

import os

import numpy as np
import pytest
import torch

from fovtrace_torch.app import optimize
from fovtrace_torch.dist import checkpoint as ckpt
from fovtrace_torch.dist import train


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    # the suite runs in several worker processes at once; PyTorch's
    # default of one thread per core then oversubscribes the CPU
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _state(seed):
    r = np.random.default_rng(seed)
    return {
        "params": {"eye": torch.tensor(r.normal(size=3), dtype=torch.float32),
                   "kd": torch.tensor(r.normal(size=(4, 3)),
                                      dtype=torch.float32)},
        "count": torch.tensor(seed, dtype=torch.int32),
    }


def test_save_restore_roundtrip(tmp_path):
    d = str(tmp_path)
    s = _state(3)
    path = ckpt.save(d, 3, s)
    assert os.path.basename(path) == "ckpt_00000003.pt"
    step, back = ckpt.restore(d, _state(0))
    assert step == 3
    assert torch.equal(back["params"]["eye"], s["params"]["eye"])
    assert torch.equal(back["count"], s["count"])
    assert [n for n in os.listdir(d) if n.endswith(".tmp")] == []


def test_latest_and_keep(tmp_path):
    d = str(tmp_path)
    for i in [1, 5, 9, 13]:
        ckpt.save(d, i, _state(i), keep=2)
    assert ckpt.all_steps(d) == [9, 13]
    assert ckpt.latest_step(d) == 13
    step, back = ckpt.restore(d, _state(0))
    assert step == 13 and int(back["count"]) == 13


def test_restore_or_init_empty(tmp_path):
    init = _state(7)
    step, s = ckpt.restore_or_init(str(tmp_path / "nope"), init)
    assert step == 0
    assert s is init


def test_optimizer_state_roundtrip(tmp_path):
    """Resume reproduces the trajectory: 4 Adam steps with a checkpoint
    of parameters and optimizer state at 2; restored, 2 more steps end at
    the same parameters (rtol 1e-6, as the reference's test)."""
    d = str(tmp_path)

    def run(p, opt, n, hist):
        for _ in range(n):
            opt.zero_grad()
            torch.sum((p - 3.0) ** 2).backward()
            opt.step()
            hist.append(p.detach().clone())

    p = torch.zeros(4, requires_grad=True)
    opt = torch.optim.Adam([p], lr=0.1)
    hist = []
    run(p, opt, 2, hist)
    ckpt.save(d, 2, {"p": p, "opt": opt.state_dict()})
    run(p, opt, 2, hist)

    p2 = torch.zeros(4, requires_grad=True)
    opt2 = torch.optim.Adam([p2], lr=0.1)
    step, st = ckpt.restore(d, {"p": p2, "opt": opt2.state_dict()})
    assert step == 2
    with torch.no_grad():
        p2.copy_(st["p"])
    opt2.load_state_dict(st["opt"])
    run(p2, opt2, 2, [])
    torch.testing.assert_close(p2.detach(), hist[-1], rtol=1e-6, atol=0)


def test_restore_rebuilds_train_params(tmp_path):
    """A dataclass of tensors is saved as a dict (weights_only loading
    takes no classes) and comes back as the target's class."""
    p = train.TrainParams(*(torch.full(s, float(i)) for i, s in enumerate(
        [(3,), (3,), (2,), (3,), (4, 3), (2, 4, 3)])))
    ckpt.save(str(tmp_path), 1, {"params": p})
    _, back = ckpt.restore(str(tmp_path), {"params": p.map(torch.zeros_like)})
    assert isinstance(back["params"], train.TrainParams)
    for a, b in zip(back["params"].tensors(), p.tensors()):
        assert torch.equal(a, b)


ARGS = ["--device", "cpu", "--scene", "box", "--width", "32", "--height",
        "32", "--perturb", "0.25", "--lr", "3e-2"]


def test_optimize_cli_smoke(tmp_path, capsys):
    """tests/test_checkpoint.py::test_optimize_cli_smoke on the port:
    8 steps shrink the eye error (exit 0), the checkpoint is at step 8,
    and a resume runs the remaining 0 steps and exits cleanly."""
    d = str(tmp_path / "ck")
    rc = optimize.main(ARGS + ["--steps", "8", "--ckpt", d,
                               "--ckpt-every", "4"])
    assert rc == 0
    assert ckpt.latest_step(d) == 8
    rc = optimize.main(ARGS + ["--steps", "8", "--ckpt", d])
    assert rc == 0
    assert "resumed from step 8" in capsys.readouterr().err


def test_optimize_cut_and_resumed_equals_uninterrupted(tmp_path, capsys):
    """A run cut at step 4 and resumed to 8 ends with the parameters and
    optimizer state of an uninterrupted 8-step run (rtol 1e-6)."""
    whole, cut = str(tmp_path / "whole"), str(tmp_path / "cut")
    assert optimize.main(ARGS + ["--steps", "8", "--ckpt", whole]) == 0
    optimize.main(ARGS + ["--steps", "4", "--ckpt", cut])
    assert optimize.main(ARGS + ["--steps", "8", "--ckpt", cut]) == 0
    assert "resumed from step 4" in capsys.readouterr().err
    _, a = ckpt.restore(whole)
    _, b = ckpt.restore(cut)
    for k in a["params"]:
        torch.testing.assert_close(b["params"][k], a["params"][k],
                                   rtol=1e-6, atol=0, msg=k)
    for i, s in a["optimizer"]["state"].items():
        for k in ("exp_avg", "exp_avg_sq", "step"):
            torch.testing.assert_close(b["optimizer"]["state"][i][k], s[k],
                                       rtol=1e-6, atol=0)
