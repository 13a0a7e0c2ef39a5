"""fovtrace_torch.bench, the port's twin of bench.py, on the CPU at 64x64
(at 32x32 the 1,024-slot budget floor covers the whole frame and
compaction never runs): its frame's counts against the JAX package's
frame at bench.py's configuration, the budget sizing against bench.py's
arithmetic, the JSON line, the selfcheck, and no fallback to the CPU."""

import contextlib
import io
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from fovtrace_torch import bench
from fovtrace_torch.kernels import cluster_isect as ci
from fovtrace_torch.kernels import intersect as isect

SIZE = 64
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARGS = ["--device", "cpu", "--width", str(SIZE), "--height", str(SIZE),
        "--iters", "1", "--warmup", "0"]


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    # the suite runs in several worker processes at once; PyTorch's
    # default of one thread per core then oversubscribes the CPU, and its
    # spinning thread pool runs such a frame ~40x slower than at 2 threads
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _run(argv):
    """bench.run with its stdout kept: (result, stdout lines)."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        res = bench.run(argv)
    return res, out.getvalue().splitlines()


@pytest.fixture(scope="module")
def fwd_run(_two_torch_threads):
    return _run(ARGS + ["--forward-only", "--selfcheck"])


@pytest.fixture(scope="module")
def fwdbwd_run(_two_torch_threads):
    return _run(ARGS)


@pytest.fixture(scope="module")
def jax_frame():
    """bench.py's first frame at 64x64, jitted: its config, the centre
    gaze and the eye and target (the budget stays 0.50, which the bench's
    probe frame also finds)."""
    pytest.importorskip("jax")
    import jax.numpy as jnp

    from fovtrace import Camera as JCamera
    from fovtrace import RenderConfig as JRenderConfig
    from fovtrace.render import pipeline as jpipeline
    from fovtrace.scene import procedural as jprocedural

    config = JRenderConfig(width=SIZE, height=SIZE, reconstruction="atrous",
                           max_depth=4, diffuse_max_depth=1,
                           ray_budget_frac=0.50, full_outputs=False)
    cam = JCamera.create(eye=(3.0, 2.5, 4.0), target=(0.0, 0.8, 0.0))
    out, _ = jpipeline.render_frame_jit(
        jprocedural.earth_scene(), cam,
        (jnp.asarray(SIZE // 2), jnp.asarray(SIZE // 2)),
        jpipeline.FrameState.initial(cam, config), config)
    return {k: int(out[k]) for k in ("rays_traced", "ray_count",
                                     "rays_dropped")}


def test_forward_counts_match_reference(fwd_run, jax_frame):
    """The headline's numerator and its validity: rays_traced, ray_count
    and rays_dropped of the bench's frame are the JAX frame's; the bench
    view's padding stops at bounce 0, so the reference's count with the
    padding bouncing on is the same."""
    res, _ = fwd_run
    assert res["frac"] == 0.50
    for k in ("rays_traced", "ray_count", "rays_dropped"):
        assert res[k] == jax_frame[k], k
    pad = res["padding"]
    assert pad["padding"] > 0 and pad["continuing"] == 0
    assert pad["reference_rays_traced"] == jax_frame["rays_traced"]


def _bench_py_frac(ray_count, rays_dropped, n_pix, frac=0.50):
    """bench.py:96-102's arithmetic, with jnp.ceil."""
    import jax.numpy as jnp

    need = float(ray_count) / n_pix
    if int(rays_dropped) > 0 or need > frac:
        frac = min(1.0, float(jnp.ceil((need + 0.02) * 20)) / 20)
    return frac


@pytest.mark.parametrize("ray_count, dropped, want", [
    (1229, 0, 0.50),      # a mask under the budget: unchanged
    (2089, 0, 0.55),      # 51.0% of the pixels: covered plus 2%
    (4030, 1, 1.0),       # 98.4% and dropping rays: at most the frame
])
def test_budget_frac_is_bench_arithmetic(ray_count, dropped, want):
    pytest.importorskip("jax")
    n_pix = SIZE * SIZE
    got = bench.budget_frac(ray_count, dropped, n_pix)
    assert got == _bench_py_frac(ray_count, dropped, n_pix) == want


@pytest.mark.parametrize("mode", ["fwd", "fwd+bwd"])
def test_json_line(fwd_run, fwdbwd_run, mode):
    """The last stdout line is the one JSON object of bench.py's four
    keys; the metric names the mode and the size; no baseline at 64x64
    on a CPU."""
    res, lines = {"fwd": fwd_run, "fwd+bwd": fwdbwd_run}[mode]
    line = json.loads(lines[-1])
    assert len(lines) == 1 and line == res["line"]
    assert sorted(line) == ["metric", "unit", "value", "vs_baseline"]
    assert line["metric"] == f"Mrays/s/chip {mode} at 64x64 foveated"
    assert line["unit"] == "Mrays/s" and line["vs_baseline"] is None
    assert np.isfinite(line["value"]) and line["value"] >= 0
    assert res["rays_dropped"] == 0 and res["mode"] == mode
    # the timed step's launches: the plain versions on the CPU, one
    # closest-hit and one occlusion per G-buffer pass and shade bounce
    assert res["per_step"]["closest_hit_plain"] == 5
    assert res["per_step"]["occlusion_plain"] == 5
    assert res["inv4_per_step"] == (2 if mode == "fwd" else 4)


def test_metric_names_what_ran():
    assert bench.metric_name("earth", False, 1920, 1088) == \
        "Mrays/s/chip fwd+bwd at 1080p foveated"
    assert bench.metric_name("city", True, 1920, 1088) == \
        "Mrays/s/chip fwd at 1080p foveated, city"


def test_selfcheck_passes_on_earth(fwd_run):
    assert fwd_run[0]["selfcheck"] > 0.999


def test_selfcheck_fails_on_a_wrong_cluster_result(monkeypatch):
    """A cluster route that finds no hit: the selfcheck exits non-zero
    before anything is timed."""
    def no_hits(scene, ro, rd, t_min, t_max):
        n = ro.x.shape[0]
        return isect.Hit(t=torch.full((n,), isect.BIG_T),
                         tri=torch.full((n,), -1, dtype=torch.int32),
                         u=torch.zeros(n), v=torch.zeros(n))

    monkeypatch.setattr(ci, "intersect_cluster", no_hits)
    with pytest.raises(SystemExit, match="selfcheck") as exc:
        bench.main(ARGS + ["--selfcheck", "--forward-only"])
    assert exc.value.code not in (0, None)


def test_without_a_card_it_exits_nonzero():
    """No --device: the card, and without one the bench fails; it does not
    fall back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: this checks the machine without one")
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-m", "fovtrace_torch.bench",
                           "--iters", "1"], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert "torch.cuda.is_available() is false" in proc.stderr
    assert proc.stdout == ""
