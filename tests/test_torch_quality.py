"""The port's measurement scripts (fovtrace_torch.scripts.quality_eval,
aperture_sweep, scaling_bench) against the JAX package's.

The metric functions are held to scripts/quality_eval.py's own, loaded
from its file (its `main`, which writes QUALITY.md, is never called), on
seeded images: SSIM within 1e-5, PSNR within 1e-6 relative, the annulus
masks equal. The quality rows at 64x64 (4 frames, 2 of warm-up, masked x
{pullpush, atrous}) are held to rows computed from the JAX package's
frames through those functions: ray_pct equal, full-frame PSNR within
0.2 dB, SSIM within 2e-3, the annuli's PSNR within 0.3 dB. Measured
(port - JAX; pullpush / atrous): full-frame PSNR +0.180 / +0.174 dB,
SSIM -3.0e-4 / -5.3e-4, fovea 0 (99.0 dB on both sides) / -0.0005 dB,
mid +0.026 / +0.016 dB, periphery +0.185 / +0.181 dB. They come from the
documented rounding deviation on glass paths (ROADMAP.md section 3,
item 2): the ground-truth frames differ from the JAX package's at 16-31
pixels by more than 0.1, the masked frames at none in frames 0-1 and at
69 and 48 (pull-push spreads a differing sample) in frames 2-3. The
sweep's ray % equals the JAX package's mask count for two apertures;
the scaling bench runs one gloo rank at 32x32. Every script's `main`
writes under --out only: the TPU records at the repository's root keep
their bytes.
"""

import importlib.util
import json
import math
import os

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from fovtrace import Camera as JCamera  # noqa: E402
from fovtrace import RenderConfig as JRenderConfig  # noqa: E402
from fovtrace.core import vec as jvec  # noqa: E402
from fovtrace.render import pipeline as jpipeline  # noqa: E402
from fovtrace.scene import procedural as jprocedural  # noqa: E402
from fovtrace_torch import Camera, RenderConfig  # noqa: E402
from fovtrace_torch.scene import procedural  # noqa: E402
from fovtrace_torch.scripts import (aperture_sweep, quality_eval,  # noqa: E402
                                    scaling_bench)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EYE, TARGET = (3.0, 2.5, 4.0), (0.0, 0.8, 0.0)
SIZE, FRAMES, WARMUP, APERTURE = 64, 4, 2, 0.07
BASE = dict(width=SIZE, height=SIZE, max_depth=4, diffuse_max_depth=1,
            aperture=APERTURE, ray_budget_frac=0.55, full_outputs=False)
RECONS = ("pullpush", "atrous")
ROOT_RECORDS = ("QUALITY.md", "quality.json", "SWEEP.csv", "SCALING.md")
# (height, width, kind): seeded uniform noise, a smooth ramp with noise,
# and a constant image (against itself and against noise)
IMAGES = [(16, 16, "noise"), (37, 53, "ramp"), (64, 48, "noise"),
          (24, 40, "constant")]


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    # the suite runs in several worker processes at once; PyTorch's
    # default of one thread per core then oversubscribes the CPU
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ref():
    """scripts/quality_eval.py as a module (its functions only)."""
    spec = importlib.util.spec_from_file_location(
        "ref_quality_eval", os.path.join(REPO, "scripts", "quality_eval.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _images(h, w, kind, seed):
    r = np.random.default_rng(seed)
    if kind == "constant":
        a = np.full((h, w, 3), 0.3, np.float32)
        return a, r.random((h, w, 3)).astype(np.float32)
    a = r.random((h, w, 3)).astype(np.float32)
    if kind == "ramp":
        a = (np.linspace(0, 1, w, dtype=np.float32)[None, :, None]
             * np.ones((h, 1, 3), np.float32) + 0.02 * a).astype(np.float32)
    b = np.clip(a + 0.1 * r.normal(size=a.shape), 0, 1).astype(np.float32)
    return a, b


@pytest.mark.parametrize("case", range(len(IMAGES)))
def test_psnr_and_ssim_match_the_reference_script(ref, case):
    h, w, kind = IMAGES[case]
    a, b = _images(h, w, kind, case)
    for x, y in ((a, b), (a, a), (b, a)):
        tx, ty = torch.as_tensor(x), torch.as_tensor(y)
        want = ref.psnr(x, y)
        assert math.isclose(quality_eval.psnr(tx, ty), want, rel_tol=1e-6)
        assert abs(quality_eval.ssim(tx, ty) - ref.ssim(x, y)) < 1e-5
    assert quality_eval.psnr(torch.as_tensor(a), torch.as_tensor(a)) == 99.0


@pytest.mark.parametrize("h, w, gaze, aperture", [
    (64, 64, (32, 32), 0.07), (544, 960, (272, 480), 0.07),
    (37, 53, (5, 40), 0.14), (1088, 1920, (100, 1700), 0.03)])
def test_annulus_masks_match_the_reference_script(ref, h, w, gaze, aperture):
    got = quality_eval.annulus_masks(h, w, gaze, aperture)
    want = ref.annulus_masks(h, w, gaze, aperture)
    for g, m in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), m)
    assert int(got[0].sum()) > 0


def test_region_psnr_matches_the_reference_script(ref):
    a, b = _images(40, 56, "noise", 9)
    for gaze, aperture in (((20, 28), 0.07), ((3, 50), 0.2),
                           ((20, 28), 1e-4)):
        for m_np, m_t in zip(ref.annulus_masks(40, 56, gaze, aperture),
                             quality_eval.annulus_masks(40, 56, gaze,
                                                        aperture)):
            want = ref.region_psnr(a, b, m_np)
            got = quality_eval.region_psnr(torch.as_tensor(a),
                                           torch.as_tensor(b), m_t)
            if math.isnan(want):     # the fovea of a tiny aperture is empty
                assert math.isnan(got)
            else:
                assert math.isclose(got, want, rel_tol=1e-6)


# ------------------------------------------------------------ the rows
@pytest.fixture(scope="module")
def jax_scene():
    return jprocedural.earth_scene(), JCamera.create(eye=EYE, target=TARGET)


def _jax_run(scene, cam, gazes, config, keys=("image_rgb",)):
    """scripts/quality_eval.py's `run` on the JAX package's frames:
    {key: [H, W, 3] rows of that output per frame} and each frame's ray
    fraction."""
    state = jpipeline.FrameState.initial(cam, config)
    frames, rayfracs = {k: [] for k in keys}, []
    for g in gazes:
        out, state = jpipeline.render_frame_jit(
            scene, cam, (jnp.asarray(g[0]), jnp.asarray(g[1])), state,
            config)
        assert int(out["rays_dropped"]) == 0
        for k in keys:
            img = jvec.to_rows(out[k]) if k == "image_rgb" else out[k]
            frames[k].append(np.asarray(img)[..., :3])
        rayfracs.append(float(out["ray_count"]) / (SIZE * SIZE))
    return frames, rayfracs


@pytest.fixture(scope="module")
def jax_rows(ref, jax_scene):
    """The reference script's rows (its main's loop) from the JAX
    package's 64x64 frames. One jitted run gives both rows: with
    full_outputs, the atrous frame also returns its pull-push buffer,
    which is bit for bit the pullpush configuration's image (the temporal
    state does not depend on the reconstruction; checked on these four
    frames), and it saves a second compile of the reference's frame."""
    scene, cam = jax_scene
    gazes = [(SIZE // 2, SIZE // 2)] * FRAMES
    gt = _jax_run(scene, cam, gazes, JRenderConfig(
        **{**BASE, "ray_budget_frac": 1.0}, sampling_mode="full",
        reconstruction="none"))[0]["image_rgb"]
    runs, rayfracs = _jax_run(
        scene, cam, gazes, JRenderConfig(
            **{**BASE, "full_outputs": True}, sampling_mode="masked",
            reconstruction="atrous"), keys=("image_rgb", "pullpush"))
    rows = {}
    for recon in RECONS:
        frames = runs["image_rgb" if recon == "atrous" else "pullpush"]
        row = {"ray_pct": 100.0 * float(np.mean(rayfracs))}
        cols = {k: [] for k in ("psnr_full", "ssim", "psnr_fovea",
                                "psnr_mid", "psnr_periphery")}
        for i in range(WARMUP, FRAMES):
            a = np.clip(frames[i], 0.0, 1.0)
            b = np.clip(gt[i], 0.0, 1.0)
            cols["psnr_full"].append(ref.psnr(a, b))
            cols["ssim"].append(ref.ssim(a, b))
            mf, mm, mp = ref.annulus_masks(SIZE, SIZE, gazes[i], APERTURE)
            cols["psnr_fovea"].append(ref.region_psnr(a, b, mf))
            cols["psnr_mid"].append(ref.region_psnr(a, b, mm))
            cols["psnr_periphery"].append(ref.region_psnr(a, b, mp))
        row.update({k: float(np.mean(v)) for k, v in cols.items()})
        rows[recon] = row
    return rows


@pytest.fixture(scope="module")
def port_rows():
    scene = procedural.earth_scene("cpu")
    cam = Camera.create(eye=EYE, target=TARGET, device="cpu")
    gazes = [(SIZE // 2, SIZE // 2)] * FRAMES
    rows = quality_eval.quality_rows(scene, cam, gazes, BASE, ["masked"],
                                     list(RECONS), WARMUP, "cpu")
    return {r["recon"]: r for r in rows}


@pytest.mark.parametrize("recon", RECONS)
def test_quality_rows_match_the_jax_package(jax_rows, port_rows, recon):
    got, want = port_rows[recon], jax_rows[recon]
    assert (got["mode"], got["recon"]) == ("masked", recon)
    assert got["ray_pct"] == want["ray_pct"]
    assert abs(got["psnr_full"] - want["psnr_full"]) < 0.2, (got, want)
    assert abs(got["ssim"] - want["ssim"]) < 2e-3, (got, want)
    for k in ("psnr_fovea", "psnr_mid", "psnr_periphery"):
        assert abs(got[k] - want[k]) < 0.3, (k, got, want)
    if recon == "pullpush":
        # every fovea pixel is sampled with the ground truth's samples
        assert got["psnr_fovea"] == want["psnr_fovea"] == 99.0


def test_sweep_ray_pct_matches_the_jax_package(jax_scene):
    """The sweep's ray % is its first frame's mask count, which the JAX
    package's render_frame takes from stage_sampling."""
    scene, cam = jax_scene
    apertures = (0.05, 0.14)
    kw = dict(width=SIZE, height=SIZE, reconstruction="atrous", max_depth=4,
              diffuse_max_depth=1, ray_budget_frac=0.75, full_outputs=False)
    for a in apertures:
        assert aperture_sweep.sweep_config(SIZE, SIZE, a) == RenderConfig(
            **kw, aperture=a)
    cfgs = [JRenderConfig(**kw, aperture=a) for a in apertures]
    st = jpipeline.FrameState.initial(cam, cfgs[0])
    gaze = (jnp.asarray(SIZE // 2), jnp.asarray(SIZE // 2))
    gbuf = jax.jit(lambda: jpipeline.stage_gbuffer(scene, cam, cam,
                                                   cfgs[0]))()
    want = [100.0 * int(jax.jit(
        lambda g, c=c: jpipeline.stage_sampling(scene, g, gaze, st, c)[-1])(
            gbuf)) / (SIZE * SIZE) for c in cfgs]
    rows = aperture_sweep.sweep_rows(
        procedural.earth_scene("cpu"),
        Camera.create(eye=EYE, target=TARGET, device="cpu"), SIZE, SIZE,
        apertures, iters=1)
    assert [r["ray_pct"] for r in rows] == want
    assert want[0] < want[1]
    for r in rows:
        assert r["rays_traced"] > 0 and r["frame_ms"] > 0


# ------------------------------------------------ the scripts' main runs
MAIN_ARGS = {
    "quality": (quality_eval, ["--width", "32", "--height", "32",
                               "--frames", "2", "--warmup", "1",
                               "--quick"]),
    "sweep": (aperture_sweep, ["--width", "32", "--height", "32",
                               "--iters", "1", "--apertures", "0.07"]),
    "scaling": (scaling_bench, ["--width", "32", "--height", "32",
                                "--iters", "1", "--ranks", "1",
                                "--backend", "gloo"]),
}
REPORTS = {"quality": ["QUALITY_torch.md", "quality_torch.json"],
           "sweep": ["SWEEP_torch.csv"], "scaling": ["SCALING_torch.md"]}


def _root_bytes():
    return {n: open(os.path.join(REPO, n), "rb").read()
            for n in ROOT_RECORDS}


@pytest.fixture(scope="module")
def main_runs(tmp_path_factory):
    """Each script's main on the CPU with --out a fresh directory:
    {name: (exit code, out dir, root records' bytes before, after)}."""
    old = os.environ.get("OMP_NUM_THREADS")
    os.environ["OMP_NUM_THREADS"] = "2"     # the scaling bench's rank
    try:
        runs = {}
        for name, (mod, argv) in MAIN_ARGS.items():
            out = tmp_path_factory.mktemp(name)
            before = _root_bytes()
            rc = mod.main(["--device", "cpu", "--out", str(out), *argv])
            runs[name] = (rc, out, before, _root_bytes())
        return runs
    finally:
        if old is None:
            os.environ.pop("OMP_NUM_THREADS")
        else:
            os.environ["OMP_NUM_THREADS"] = old


@pytest.mark.parametrize("name", sorted(MAIN_ARGS))
def test_main_writes_only_under_out(main_runs, name):
    rc, out, before, after = main_runs[name]
    assert rc == 0
    assert after == before, "a TPU record at the repository root changed"
    assert sorted(p.name for p in out.iterdir()) == sorted(REPORTS[name])


def test_scaling_bench_table_on_one_gloo_rank(main_runs):
    _, out, _, _ = main_runs["scaling"]
    text = (out / "SCALING_torch.md").read_text()
    assert "not scaling" in text and "device: cpu" in text
    row = [line for line in text.splitlines() if line.startswith("| 1 |")]
    assert len(row) == 1 and row[0].endswith("| 100.0% |"), text


def test_quality_main_writes_its_rows(main_runs):
    _, out, _, _ = main_runs["quality"]
    rows = json.loads((out / "quality_torch.json").read_text())
    assert [(r["mode"], r["recon"]) for r in rows] == [
        ("masked", "pullpush"), ("masked", "atrous")]
    assert rows[0]["psnr_fovea"] == 99.0
    assert all(0 < r["ray_pct"] < 100 for r in rows)


@pytest.mark.parametrize("name", sorted(MAIN_ARGS))
def test_main_refuses_cuda_without_a_card(name):
    if torch.cuda.is_available():
        pytest.skip("a card is present: --device cuda runs")
    mod, argv = MAIN_ARGS[name]
    with pytest.raises(SystemExit, match="cuda"):
        mod.main(["--device", "cuda", *argv])
