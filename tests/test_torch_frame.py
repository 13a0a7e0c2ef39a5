"""The port's whole forward frame against the JAX reference and the
committed golden: 64x64 earth, the tests/test_golden.py configuration,
two frames so the temporal path runs."""

import os

import numpy as np
import pytest
import torch

from fovtrace_torch import Camera, RenderConfig
from fovtrace_torch.app import cli
from fovtrace_torch.kernels import cluster_isect as ci
from fovtrace_torch.render import pipeline
from fovtrace_torch.scene import procedural

SIZE = 64
KW = dict(width=SIZE, height=SIZE, reconstruction="atrous", max_depth=3,
          diffuse_max_depth=1, ray_budget_frac=0.6)
EYE, TARGET = (3.0, 2.5, 4.0), (0.0, 0.8, 0.0)
GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden",
                      "earth.npz")


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    # the suite runs in several worker processes at once; PyTorch's
    # default of one thread per core then oversubscribes the CPU, and its
    # spinning thread pool runs such a frame ~40x slower than at 2 threads
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_render():
    """The reference's two-frame render (intersect backend "auto", which
    is brute force on the CPU)."""
    pytest.importorskip("jax")
    import jax.numpy as jnp

    from fovtrace import Camera as JCamera
    from fovtrace import RenderConfig as JRenderConfig
    from fovtrace.render import pipeline as jpipeline
    from fovtrace.scene import procedural as jprocedural

    scene = jprocedural.earth_scene()
    cam = JCamera.create(eye=EYE, target=TARGET)
    config = JRenderConfig(**KW)
    state = jpipeline.FrameState.initial(cam, config)
    gaze = (jnp.asarray(SIZE // 2), jnp.asarray(SIZE // 2))
    outs = []
    for _ in range(2):
        out, state = jpipeline.render_frame_jit(scene, cam, gaze, state,
                                                config)
        outs.append({k: np.asarray(out[k]) for k in
                     ("image", "mask", "ray_count", "rays_dropped",
                      "rays_traced")})
    return outs


@pytest.fixture(scope="module")
def earth_cpu():
    return procedural.earth_scene("cpu")


def _port_render(scene, backend, device="cpu"):
    config = RenderConfig(**KW, intersect_backend=backend)
    cam = Camera.create(eye=EYE, target=TARGET, device=device)
    state = pipeline.FrameState.initial(cam, config)
    outs = []
    for _ in range(2):
        out, state = pipeline.render_frame(scene, cam, (SIZE // 2, SIZE // 2),
                                           state, config)
        outs.append({k: out[k].cpu().numpy() for k in
                     ("image", "mask", "ray_count", "rays_dropped",
                      "rays_traced")})
    return outs


def test_brute_frame_matches_reference_brute(jax_render, earth_cpu):
    ci.reset_counters()
    outs = _port_render(earth_cpu, "brute")
    counts = ci.counters()
    assert counts["intersect_brute"] > 0 and counts["closest_hit_plain"] == 0
    for got, want in zip(outs, jax_render):
        np.testing.assert_array_equal(got["mask"], want["mask"])
        for k in ("ray_count", "rays_dropped", "rays_traced"):
            assert int(got[k]) == int(want[k]), k
        err = np.abs(got["image"] - want["image"])
        assert err.mean() < 1e-3 and err.max() < 0.1, (err.mean(), err.max())


def test_cluster_frame_matches_reference(jax_render, earth_cpu):
    ci.reset_counters()
    outs = _port_render(earth_cpu, "cluster")
    counts = ci.counters()
    assert counts["closest_hit_plain"] > 0 and counts["occlusion_plain"] > 0
    assert counts["intersect_brute"] == 0 and counts["occlusion_brute"] == 0
    for got, want in zip(outs, jax_render):
        np.testing.assert_array_equal(got["mask"], want["mask"])
        assert int(got["ray_count"]) == int(want["ray_count"])
        # tests/test_golden.py's image tolerances
        err = np.abs(got["image"] - want["image"])
        assert err.mean() < 5e-3 and err.max() < 0.1, (err.mean(), err.max())


@pytest.mark.parametrize("device", ["cpu", pytest.param("cuda",
                                                        marks=pytest.mark.cuda)])
def test_frame_matches_golden(device, earth_cpu):
    if device == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    ref = np.load(GOLDEN)
    out = _port_render(earth_cpu.to(device), "auto", device)[-1]
    assert int(out["ray_count"]) == int(ref["ray_count"])
    err = np.abs(out["image"] - ref["image"].astype(np.float32))
    assert err.mean() < 5e-3 and err.max() < 0.1, (err.mean(), err.max())


def test_render_sequence_threads_state():
    scene = procedural.box_scene("cpu")
    config = RenderConfig(width=32, height=32, max_depth=2)
    cams = [Camera.create(eye=EYE, target=TARGET)] * 2
    gazes = [(16, 16), (10, 20)]
    frames, state = pipeline.render_sequence(scene, cams, gazes, config)
    st = pipeline.FrameState.initial(cams[0], config)
    for cam, gaze, img in zip(cams, gazes, frames):
        out, st = pipeline.render_frame(scene, cam, gaze, st, config)
        torch.testing.assert_close(img, out["image"], rtol=0, atol=0)
    assert int(state.frame) == 2
    torch.testing.assert_close(state.history, st.history, rtol=0, atol=0)


def test_cli_renders_and_reports(tmp_path):
    report = tmp_path / "report.csv"
    rc = cli.main(["--device", "cpu", "--scene", "box", "--width", "32",
                   "--height", "32", "--frames", "2", "--max-depth", "2",
                   "--out", str(tmp_path), "--format", "npy",
                   "--report", str(report)])
    assert rc == 0
    img = np.load(tmp_path / "frame_final.npy")
    assert img.shape == (32, 32, 3) and img.dtype == np.uint8
    assert 0 < img.mean() < 255
    lines = report.read_text().splitlines()
    assert len(lines) == 3 and "rays_traced" in lines[0]


@pytest.mark.parametrize("flag", [["--sampling", "weier"],
                                  ["--reconstruction", "jfa"]])
def test_cli_refuses_unported_options(flag):
    with pytest.raises(SystemExit, match="not ported"):
        cli.main(["--device", "cpu", "--frames", "1", *flag])
