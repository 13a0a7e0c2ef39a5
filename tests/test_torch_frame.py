"""The port's whole forward frame against the JAX reference and the
committed golden: 64x64 earth, the tests/test_golden.py configuration,
two frames so the temporal path runs."""

import os

import numpy as np
import pytest
import torch

from fovtrace_torch import Camera, RenderConfig
from fovtrace_torch.app import cli
from fovtrace_torch.core import color
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
        outs[-1]["keys"] = sorted(out)
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
    cams = [Camera.create(eye=EYE, target=TARGET, device="cpu")] * 2
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


@pytest.mark.parametrize("flag", [["--scene", "model.obj"],
                                  ["--scene", "scene_spec.json"]])
def test_cli_refuses_unported_options(flag):
    with pytest.raises(SystemExit, match="not ported"):
        cli.main(["--device", "cpu", "--frames", "1", *flag])


# ------------------------------------------- full outputs and the color maps
def test_full_outputs_keys_match_reference(jax_render, earth_cpu):
    config = RenderConfig(**KW)
    cam = Camera.create(eye=EYE, target=TARGET, device="cpu")
    out, _ = pipeline.render_frame(earth_cpu, cam, (SIZE // 2, SIZE // 2),
                                   pipeline.FrameState.initial(cam, config),
                                   config)
    assert sorted(out) == jax_render[0]["keys"]
    torch.testing.assert_close(out["saliency_view"],
                               color.heatmap(out["saliency"]), rtol=0, atol=0)


def test_color_helpers_match_jax():
    """heatmap, cool2warm, accumulate_to_color and linearize_depth on
    seeded inputs, at rtol 1e-6 (sin and cos round per library)."""
    pytest.importorskip("jax")
    import jax.numpy as jnp

    from fovtrace.core import color as jcolor

    r = np.random.default_rng(5)
    x = r.random((37, 29)).astype(np.float32) * 1.2 - 0.1
    acc = r.random((9, 11, 4)).astype(np.float32)
    acc[..., 3] = np.where(r.random((9, 11)) < 0.3, 0.0, acc[..., 3] * 4.0)
    for got, want in (
            (color.heatmap(torch.as_tensor(x)), jcolor.heatmap(jnp.asarray(x))),
            (color.cool2warm(torch.as_tensor(x)),
             jcolor.cool2warm(jnp.asarray(x))),
            (color.accumulate_to_color(torch.as_tensor(acc)),
             jcolor.accumulate_to_color(jnp.asarray(acc))),
            (color.linearize_depth(torch.as_tensor(x), 0.1, 1000.0),
             jcolor.linearize_depth(jnp.asarray(x), 0.1, 1000.0))):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                                   atol=1e-6)


def test_cli_view_saliency_writes_heatmap(tmp_path):
    """--view saliency writes heatmap(saliency), as the reference's CLI
    does (not the raw field in grey)."""
    args = cli.build_argparser().parse_args([
        "--device", "cpu", "--scene", "box", "--width", "32", "--height",
        "32", "--frames", "1", "--max-depth", "2", "--view", "saliency",
        "--out", str(tmp_path), "--format", "npy"])
    stats = cli.run(args)
    img = np.load(tmp_path / "frame_final.npy")
    want = color.heatmap(stats["out"]["saliency"]).numpy()
    want = (np.clip(want, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
    np.testing.assert_array_equal(img, want)
    assert not (img[..., 0] == img[..., 1]).all()


# ----------------------------------------- the reference's compiled rounding
# Pixels more than 0.1 from the reference, as measured: glass paths where
# the compiled reference's transcendentals and contractions round
# otherwise and a Fresnel choice or a hit flips, spread by the
# reconstruction (ROADMAP section 3, fault 2: the documented deviation).
# Every other case is held to the golden tolerance unchanged.
OUTLIERS = {"vokselia": 1, "full": 17}


@pytest.mark.parametrize("name", ["box", "bunny", "multi", "vokselia"])
def test_scene_golden(name):
    """The other procedural goldens at 64x64 (tests/test_golden.py's
    configuration and tolerance: MAE < 5e-3, max < 0.1, ray_count)."""
    ref = np.load(os.path.join(os.path.dirname(GOLDEN), f"{name}.npz"))
    scene = procedural.SCENES[name]("cpu")
    out = _port_render(scene, "auto")[-1]
    assert int(out["ray_count"]) == int(ref["ray_count"])
    err = np.abs(out["image"] - ref["image"].astype(np.float32))
    outliers = int((err.max(-1) >= 0.1).sum())
    assert err.mean() < 5e-3 and outliers <= OUTLIERS.get(name, 0), \
        (err.mean(), err.max(), outliers)


EARTH_CASES = {"pullpush": dict(reconstruction="pullpush"),
               "none": dict(reconstruction="none"),
               "full": dict(sampling_mode="full"), "dof": dict(dof=True),
               "notemporal": dict(temporal=False)}


@pytest.mark.parametrize("name", sorted(EARTH_CASES))
def test_earth_config_matches_jitted_reference(name, earth_cpu):
    """Two 64x64 earth frames against the jitted reference's, at the
    golden tolerance, in the configurations the masked atrous frame does
    not reach."""
    pytest.importorskip("jax")
    import jax.numpy as jnp

    from fovtrace import Camera as JCamera
    from fovtrace import RenderConfig as JRenderConfig
    from fovtrace.render import pipeline as jpipeline
    from fovtrace.scene import procedural as jprocedural

    kw = {**KW, **EARTH_CASES[name]}
    jcam = JCamera.create(eye=EYE, target=TARGET)
    jcfg = JRenderConfig(**kw)
    jst = jpipeline.FrameState.initial(jcam, jcfg)
    jscene = jprocedural.earth_scene()
    cfg = RenderConfig(**kw)
    cam = Camera.create(eye=EYE, target=TARGET, device="cpu")
    st = pipeline.FrameState.initial(cam, cfg)
    for _ in range(2):
        want, jst = jpipeline.render_frame_jit(
            jscene, jcam, (jnp.asarray(SIZE // 2), jnp.asarray(SIZE // 2)),
            jst, jcfg)
        got, st = pipeline.render_frame(earth_cpu, cam, (SIZE // 2, SIZE // 2),
                                        st, cfg)
        np.testing.assert_array_equal(got["mask"].numpy(),
                                      np.asarray(want["mask"]))
        assert int(got["ray_count"]) == int(want["ray_count"])
        err = np.abs(got["image"].numpy() - np.asarray(want["image"]))
        outliers = int((err.max(-1) >= 0.1).sum())
        assert err.mean() < 5e-3 and outliers <= OUTLIERS.get(name, 0), \
            (err.mean(), err.max(), outliers)
