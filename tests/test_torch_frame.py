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

import torch_asset_files as taf

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


def _rows(v):
    """A frame output as one numpy array (a Vec3 stacked on axis 0)."""
    if hasattr(v, "x"):
        return np.stack([np.asarray(c) for c in (v.x, v.y, v.z)])
    return np.asarray(v)


@pytest.fixture(scope="module")
def jax_frames():
    """The reference's two-frame render (intersect backend "auto", which
    is brute force on the CPU): every output of both frames, and what a
    further frame from the first frame's state needs."""
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
    outs, states = [], []
    for _ in range(2):
        out, state = jpipeline.render_frame_jit(scene, cam, gaze, state,
                                                config)
        outs.append({k: _rows(v) for k, v in out.items()})
        outs[-1]["keys"] = sorted(out)
        states.append(state)
    return dict(outs=outs, state1=states[0], scene=scene, cam=cam,
                config=config, gaze=gaze, render=jpipeline.render_frame_jit)


@pytest.fixture(scope="module")
def jax_render(jax_frames):
    return jax_frames["outs"]


@pytest.fixture(scope="module")
def earth_cpu():
    return procedural.earth_scene("cpu")


def _port_render(scene, backend, device="cpu", cams=None, **kw):
    """Two port frames (`cams`: each frame's camera; the bench pose by
    default), every output as a numpy array."""
    config = RenderConfig(**{**KW, **kw}, intersect_backend=backend)
    if cams is None:
        cams = [Camera.create(eye=EYE, target=TARGET, device=device)] * 2
    state = pipeline.FrameState.initial(cams[0], config)
    outs = []
    for cam in cams:
        out, state = pipeline.render_frame(scene, cam, (SIZE // 2, SIZE // 2),
                                           state, config)
        outs.append({k: (torch.stack([v.x, v.y, v.z]) if hasattr(v, "x")
                         else v).cpu().numpy() for k, v in out.items()})
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
    img = np.load(tmp_path / "frame_final_a0.070.npy")
    assert img.shape == (32, 32, 3) and img.dtype == np.uint8
    assert 0 < img.mean() < 255
    lines = report.read_text().splitlines()
    assert len(lines) == 3 and "rays_traced" in lines[0]


def _scene_file(kind, root):
    if kind == "obj":
        return os.path.join(os.path.dirname(GOLDEN), os.pardir, "data",
                            "checker_quad.obj")
    taf.write_resource_dir(root)
    if kind == "resources":
        return root
    m = procedural._mesh
    tex = taf.write_mesh_scene(root, [m(procedural.plane(3.0, 0.0), 0)],
                               "ground", textured=True)
    ball = taf.write_mesh_scene(
        root, [m(procedural.icosphere(0.4, (0.0, 0.0, 0.0), subdiv=1), 0)],
        "ball", textured=False)
    return taf.write_spec(root, tex, ball, os.path.join(root, "CedarCity.hdr"))


@pytest.mark.parametrize("kind", ["obj", "spec", "resources"])
def test_cli_renders_scene_files(tmp_path, kind):
    """--scene with an .obj, a scene-spec .json and a resource directory
    at 32x32: a BMP dump that load_bmp reads back as the frame's buffer,
    and --profile-stages' columns in the --report CSV."""
    from fovtrace_torch.scene import image_io

    report = tmp_path / "report.csv"
    args = cli.build_argparser().parse_args([
        "--device", "cpu", "--scene", _scene_file(kind, str(tmp_path)),
        "--width", "32", "--height", "32", "--frames", "2", "--max-depth",
        "2", "--out", str(tmp_path / "out"), "--profile-stages", "--report",
        str(report), "--save-every", "1"])
    assert args.format == "bmp"
    stats = cli.run(args)
    want = cli.to_u8_image("image", stats["out"])
    assert 0 < want.mean() < 255
    got = image_io.load_bmp(str(tmp_path / "out" / "frame_final_a0.070.bmp"))
    np.testing.assert_array_equal(got, want / np.float32(255.0))
    assert sorted(os.listdir(tmp_path / "out")) == [
        "frame_0000_a0.070.bmp", "frame_0001_a0.070.bmp",
        "frame_final_a0.070.bmp"]
    header, *rows = report.read_text().splitlines()
    cols = header.split(",")
    assert cols[:6] == ["GB", "Sampling", "Optimize", "Shading", "PPI", "AT"]
    assert "Total" in cols and len(rows) == 2
    assert max(stats["rays_dropped"]) == 0


def test_cli_trace_and_seed_frame(tmp_path):
    """--trace writes a torch.profiler Chrome trace of the run;
    --seed-frame is accepted (and, as in the reference, not read)."""
    rc = cli.main(["--device", "cpu", "--scene", "box", "--width", "16",
                   "--height", "16", "--frames", "1", "--max-depth", "1",
                   "--seed-frame", "3", "--trace", str(tmp_path / "tr"),
                   "--intersect-backend", "bvh"])
    assert rc == 0
    traces = os.listdir(tmp_path / "tr")
    assert len(traces) == 1 and traces[0].endswith(".pt.trace.json")
    assert (tmp_path / "tr" / traces[0]).stat().st_size > 1000


def test_cli_refuses_the_reference_shortcut():
    with pytest.raises(SystemExit, match="resource directory"):
        cli.main(["--device", "cpu", "--frames", "1", "--scene",
                  "reference"])


def test_cli_refuses_profile_stages_when_sharded():
    """The sharded frame has no stages of its own to time: the CLI says
    so rather than write a report without stage columns."""
    with pytest.raises(SystemExit, match="--profile-stages"):
        cli.main(["--device", "cpu", "--frames", "1", "--scene", "box",
                  "--sharded", "--profile-stages"])


def test_staged_frame_is_render_frame(earth_cpu):
    """render_frame_staged's outputs and new state equal render_frame's
    bit for bit; its timer holds every stage the configuration runs."""
    from fovtrace_torch.app.profiler import StageTimer
    from fovtrace_torch.render import staged

    cfg = RenderConfig(width=32, height=32, max_depth=2,
                       reconstruction="all")
    cam = Camera.create(eye=EYE, target=TARGET, device="cpu")
    st_a = st_b = pipeline.FrameState.initial(cam, cfg)
    timer = StageTimer()
    for gaze in ((16, 16), (10, 20)):
        a, st_a = pipeline.render_frame(earth_cpu, cam, gaze, st_a, cfg)
        b, st_b = staged.render_frame_staged(earth_cpu, cam, gaze, st_b, cfg,
                                             timer)
        assert a.keys() == b.keys()
        for k in a:
            x, y = a[k], b[k]
            for u, v in (zip(x, y) if isinstance(x, tuple) else [(x, y)]):
                torch.testing.assert_close(u, v, rtol=0, atol=0, msg=k)
        for k in ("history", "depth_cache", "frame"):
            torch.testing.assert_close(getattr(st_a, k), getattr(st_b, k),
                                       rtol=0, atol=0)
        timer.end_frame()
    means = timer.means()
    assert list(means) == ["GB", "Sampling", "Optimize", "Shading", "JFA",
                           "SI", "PPI", "AT"]
    assert timer.counts["GB"] == 2 and all(v >= 0 for v in means.values())
    assert timer.csv_header().split(",") == list(means)
    assert "GB=" in timer.summary()


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


# Reprojection validity (full_outputs weight[..., 2]) against the jitted
# reference, as measured (ROADMAP section 3, item 12): the pixels where it
# flips. Static camera, second frame: column 0, where the reprojected u
# is a few 1e-5 either side of 0 and the two packages round it to
# opposite signs; the port's flag equals the eager reference's there.
# Moving camera (one Camera.rotate_around step between the frames, about
# the target's vertical or the origin's x axis): the flips of the second
# frame; at +0.05 rad the jitted reference's
# path of pixel (32, 0) differs by one traced ray (the port counts the
# eager reference's 13,483), which pull-push spreads along column 0.
STATIC_FLIPS = {(4, 0), (10, 0), (17, 0), (23, 0), (35, 0)}
UP, X = (0.0, 1.0, 0.0), (1.0, 0.0, 0.0)
MOVING = {"orbit+0.05": dict(orbit=(TARGET, 0.05, UP), flips=set(),
                             outliers=33, rays_off=1),
          "orbit-0.07": dict(orbit=(TARGET, -0.07, UP), flips={(39, 32)},
                             outliers=42, rays_off=0),
          "orbit+0.1": dict(orbit=(TARGET, 0.1, UP), flips={(11, 31)},
                            outliers=0, rays_off=0),
          "tilt+0.05": dict(orbit=((0.0, 0.0, 0.0), 0.05, X),
                            flips={(13, 51)}, outliers=0, rays_off=0)}
EXACT = ("albedo", "normal", "mask", "traced", "image_alpha", "ray_count",
         "rays_dropped")
IMAGES = ("image", "image_rgb", "shading", "pullpush", "atrous")
# measured bounds: the float buffers of the static frames within 1.7e-4
# (saliency_view 1.67e-4); after the -0.07 orbit within 7.4e-4
# (saliency_view 7.32e-4, saliency 6.03e-4, depth 3.57e-4); the
# reprojected u, v (in pixels) within 3.3e-4 static (3.24e-4, at pixel
# (11, 1) only) and 8.8e-4 after an orbit (8.79e-4 at +0.1)
STATIC_TOL = dict(atol=1.7e-4, uv=3.3e-4)
MOVING_TOL = dict(atol=7.4e-4, uv=8.8e-4)


def _hold_full_outputs(got, want, flips, tol, images=True):
    """Every full_outputs buffer: EXACT ones equal, validity flips only at
    `flips`, the reprojected u, v within tol["uv"] and the rest within
    tol["atol"] (the IMAGES too when `images`)."""
    for k in want["keys"]:
        a, b = got[k], want[k]
        if k in EXACT:
            np.testing.assert_array_equal(a, b, err_msg=k)
        elif k == "weight":
            flipped = {tuple(map(int, p))
                       for p in np.argwhere(a[..., 2] != b[..., 2])}
            assert flipped <= flips, flipped
            np.testing.assert_allclose(a[..., :2], b[..., :2], rtol=0,
                                       atol=tol["uv"])
            np.testing.assert_array_equal(a[..., 3], b[..., 3])
        elif k != "rays_traced" and (images or k not in IMAGES):
            np.testing.assert_allclose(a, b, rtol=0, atol=tol["atol"],
                                       err_msg=k)


@pytest.mark.parametrize("frame", [0, 1])
def test_full_outputs_match_reference(jax_render, earth_cpu, frame):
    """Each full_outputs buffer of the two static frames against the
    jitted reference's, validity flips capped and named."""
    got = _port_render(earth_cpu, "auto")[frame]
    want = jax_render[frame]
    assert sorted(got) == want["keys"]
    assert int(got["rays_traced"]) == int(want["rays_traced"])
    _hold_full_outputs(got, want, STATIC_FLIPS if frame else set(),
                       STATIC_TOL)


@pytest.mark.parametrize("step", sorted(MOVING))
def test_full_outputs_under_a_moving_camera(jax_frames, earth_cpu, step):
    """The second frame after an orbit step about the target: the
    G-buffer and sampling buffers as for a static camera, validity flips
    capped and named, the images at the golden tolerance with the
    measured outliers (one shaded pixel's path, spread by the
    reconstruction)."""
    case = MOVING[step]
    orbit = case["orbit"]
    out, _ = jax_frames["render"](
        jax_frames["scene"], jax_frames["cam"].rotate_around(*orbit),
        jax_frames["gaze"], jax_frames["state1"], jax_frames["config"])
    want = {k: _rows(v) for k, v in out.items()}
    want["keys"] = sorted(out)
    cam = Camera.create(eye=EYE, target=TARGET, device="cpu")
    got = _port_render(earth_cpu, "auto",
                       cams=[cam, cam.rotate_around(*orbit)])[1]
    _hold_full_outputs(got, want, case["flips"], MOVING_TOL, images=False)
    assert abs(int(got["rays_traced"]) - int(want["rays_traced"])) \
        <= case["rays_off"]
    err = np.abs(got["image"] - want["image"])
    outliers = int((err.max(-1) >= 0.1).sum())
    assert err.mean() < 5e-3 and outliers <= case["outliers"], \
        (err.mean(), err.max(), outliers)


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
    img = np.load(tmp_path / "frame_final_a0.070.npy")
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


# ------------------------------------------------ an orthographic earth view
# ROADMAP section 3, item 11: on this view the compaction's padding slots
# carry pixel 0's ray, which continues past the first bounce. The
# reference lets the padding bounce on and counts it; the port stops it
# after bounce 0 (shade_v's `active`), so its rays_traced is smaller.
ORTHO = dict(mode="ortho_height", fov_y=4.0)
ORTHO_RAYS_TRACED = 16337       # the reference's, per frame
ORTHO_PORT_RAYS_TRACED = 15199  # the port's: the documented departure


@pytest.fixture(scope="module")
def jax_ortho():
    """The reference's two frames of the orthographic view (the mode is a
    static field of its camera: one more compile at 64x64)."""
    pytest.importorskip("jax")
    import jax.numpy as jnp

    from fovtrace import Camera as JCamera
    from fovtrace import RenderConfig as JRenderConfig
    from fovtrace.render import pipeline as jpipeline
    from fovtrace.scene import procedural as jprocedural

    scene = jprocedural.earth_scene()
    cam = JCamera.create(eye=EYE, target=TARGET, **ORTHO)
    config = JRenderConfig(**KW)
    state = jpipeline.FrameState.initial(cam, config)
    gaze = (jnp.asarray(SIZE // 2), jnp.asarray(SIZE // 2))
    outs = []
    for _ in range(2):
        out, state = jpipeline.render_frame_jit(scene, cam, gaze, state,
                                                config)
        outs.append({k: _rows(out[k]) for k in
                     ("image", "mask", "ray_count", "rays_traced")})
    return outs


@pytest.mark.parametrize("padding", ["stopped", "bouncing"])
def test_ortho_frame_matches_reference(jax_ortho, earth_cpu, monkeypatch,
                                       padding):
    """Two orthographic earth frames against the jitted reference: images
    within 5e-7 (4.2e-7 measured), masks and ray_count equal. rays_traced
    is the reference's with the padding bouncing on (shade_v called
    without `active`, as the reference shades), and the port's own,
    smaller count as documented otherwise."""
    from fovtrace_torch.render import shade as shade_mod

    if padding == "bouncing":
        shade_v = shade_mod.shade_v
        monkeypatch.setattr(shade_mod, "shade_v",
                            lambda *a, active=None, **k: shade_v(*a, **k))
    cams = [Camera.create(eye=EYE, target=TARGET, device="cpu", **ORTHO)] * 2
    outs = _port_render(earth_cpu, "auto", cams=cams)
    want_rays = {"stopped": ORTHO_PORT_RAYS_TRACED,
                 "bouncing": ORTHO_RAYS_TRACED}[padding]
    for got, want in zip(outs, jax_ortho):
        np.testing.assert_array_equal(got["mask"], want["mask"])
        assert int(got["ray_count"]) == int(want["ray_count"])
        np.testing.assert_allclose(got["image"], want["image"], rtol=0,
                                   atol=5e-7)
        assert int(want["rays_traced"]) == ORTHO_RAYS_TRACED
        assert int(got["rays_traced"]) == want_rays


def test_bench_padding_check_on_the_ortho_view(earth_cpu):
    """fovtrace_torch.bench's padding check finds the view's padding ray
    continuing, and gives the reference's count beside the port's."""
    from fovtrace_torch import bench

    cfg = RenderConfig(**KW)
    cam = Camera.create(eye=EYE, target=TARGET, device="cpu", **ORTHO)
    pad = bench.padding_check(earth_cpu, cam, (SIZE // 2, SIZE // 2),
                              pipeline.FrameState.initial(cam, cfg), cfg)
    assert pad["padding"] > 0 and pad["continuing"] == pad["padding"]
    assert pad["rays_traced"] == ORTHO_PORT_RAYS_TRACED
    assert pad["reference_rays_traced"] == ORTHO_RAYS_TRACED
