"""The port's other sampling modes and reconstructions against the JAX
reference: jump flooding, Sibson and the log-polar transforms on seeded
sparse fields; the weier / author / log-polar masks bit for bit; the
three mode goldens; and tests/test_sampling_modes.py's check."""

import json
import os

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from fovtrace import Camera as JCamera  # noqa: E402
from fovtrace import RenderConfig as JRenderConfig  # noqa: E402
from fovtrace.core import rng as jrng  # noqa: E402
from fovtrace.kernels import jfa as jjfa  # noqa: E402
from fovtrace.kernels import logpolar as jlogpolar  # noqa: E402
from fovtrace.kernels import sampling as jsampling  # noqa: E402
from fovtrace.kernels import sibson as jsibson  # noqa: E402
from fovtrace.render import pipeline as jpipeline  # noqa: E402
from fovtrace.scene import procedural as jprocedural  # noqa: E402
from fovtrace_torch import Camera, RenderConfig  # noqa: E402
from fovtrace_torch.core import rng  # noqa: E402
from fovtrace_torch.kernels import jfa, logpolar, sampling, sibson  # noqa: E402
from fovtrace_torch.render import pipeline  # noqa: E402
from fovtrace_torch.scene import procedural  # noqa: E402

GOLDEN_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "golden")
EYE, TARGET = (3.0, 2.5, 4.0), (0.0, 0.8, 0.0)
# pixels of a 64x64 earth log-polar frame more than 0.1 from the jitted
# reference's, measured in either frame: glass paths where the compiled
# reference's transcendentals and contractions round otherwise (ROADMAP
# section 3, fault 2: the documented deviation)
LOGPOLAR_OUTLIERS = 2
# (height, width, seed density, gaze (gy, gx)); the second is not square
FIELDS = [(64, 64, 0.11, (32, 32)), (48, 80, 0.03, (11, 57))]


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    # the suite runs in several worker processes at once; PyTorch's
    # default of one thread per core then oversubscribes the CPU, and its
    # spinning thread pool runs such a frame ~40x slower than at 2 threads
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _sparse(h, w, density, seed):
    """[H,W,4] float32: random rgb, alpha 1 on the seeds, 0 elsewhere."""
    r = np.random.default_rng(seed)
    a = (r.random((h, w)) < density).astype(np.float32)
    rgb = r.random((h, w, 3)).astype(np.float32) * a[..., None]
    return np.concatenate([rgb, a[..., None]], axis=-1)


# ------------------------------------------------------------------- JFA
@pytest.mark.parametrize("field", range(len(FIELDS)))
def test_jump_flood_matches_jax(field):
    h, w, density, _ = FIELDS[field]
    sp = _sparse(h, w, density, field)
    want_c, want_col = jjfa.jump_flood(jnp.asarray(sp))
    got_c, got_col = jfa.jump_flood(torch.as_tensor(sp))
    np.testing.assert_array_equal(
        jfa.jump_flood_packed(torch.as_tensor(sp[..., 3])).numpy(),
        np.asarray(jjfa.jump_flood_packed(jnp.asarray(sp[..., 3]))))
    np.testing.assert_array_equal(got_c.numpy(), np.asarray(want_c))
    np.testing.assert_array_equal(got_col.numpy(), np.asarray(want_col))


def test_jump_flood_with_one_seed_and_none():
    sp = np.zeros((16, 24, 4), np.float32)
    c, col = jfa.jump_flood(torch.as_tensor(sp))
    assert not bool(c[..., 3].any()) and not bool(col.any())
    sp[5, 17] = (0.25, 0.5, 0.75, 1.0)
    c, col = jfa.jump_flood(torch.as_tensor(sp))
    assert bool((col == torch.tensor([0.25, 0.5, 0.75, 1.0])).all())
    np.testing.assert_array_equal(c.numpy(),
                                  np.asarray(jjfa.jump_flood(
                                      jnp.asarray(sp))[0]))


# ---------------------------------------------------------------- Sibson
@pytest.mark.parametrize("field,radius", [(0, 8), (1, 4), (1, 16)])
def test_sibson_matches_jax(field, radius):
    """On the JFA outputs of a seeded sparse field. The sums run in the
    reference's order, so they round as its sums do."""
    h, w, density, _ = FIELDS[field]
    sp = _sparse(h, w, density, 7 + field)
    jc, jcol = jjfa.jump_flood(jnp.asarray(sp))
    want = np.asarray(jsibson.sibson_interpolate(jc, jcol, radius))
    got = sibson.sibson_interpolate(torch.as_tensor(np.array(jc)),
                                    torch.as_tensor(np.array(jcol)),
                                    radius).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


# -------------------------------------------------------------- log-polar
@pytest.mark.parametrize("field", range(len(FIELDS)))
def test_logpolar_transforms_match_jax(field):
    h, w, _, (gy, gx) = FIELDS[field]
    bh, bw = h // 4, w // 4
    px = np.tile(np.arange(w, dtype=np.float32)[None, :], (h, 1))
    py = np.tile(np.arange(h, dtype=np.float32)[:, None], (1, w))
    ju, jv = jlogpolar.forward_coords(jnp.asarray(px), jnp.asarray(py),
                                      jnp.float32(gx), jnp.float32(gy), bw,
                                      bh)
    tu, tv = logpolar.forward_coords(torch.as_tensor(px),
                                     torch.as_tensor(py), gx, gy, bw, bh)
    np.testing.assert_allclose(tu.numpy(), np.asarray(ju), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-5,
                               atol=1e-5)
    jx, jy = jlogpolar.inverse_coords(ju, jv, jnp.float32(gx),
                                      jnp.float32(gy), bw, bh)
    tx, ty = logpolar.inverse_coords(tu, tv, gx, gy, bw, bh)
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), rtol=1e-5,
                               atol=1e-3)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=1e-5,
                               atol=1e-3)
    # the resampling gathers nearest texels. Resample an image of texel
    # coordinates: where a coordinate rounds within an ulp of .5 the two
    # sides' transcendentals may pick the neighbouring texel, so at least
    # 99% of the picks are equal and every other is a neighbour
    yx = np.stack(np.meshgrid(np.arange(h), np.arange(w), indexing="ij"),
                  -1).astype(np.float32)
    for got, want in (
            (logpolar.forward_transform(torch.as_tensor(yx), (gy, gx)),
             jlogpolar.forward_transform(jnp.asarray(yx), (gy, gx))),
            (logpolar.inverse_transform(torch.as_tensor(yx[:bh, :bw]),
                                        (h, w), (gy, gx)),
             jlogpolar.inverse_transform(jnp.asarray(yx[:bh, :bw]), (h, w),
                                         (gy, gx)))):
        d = np.abs(got.numpy() - np.asarray(want)).max(-1)
        assert (d == 0).mean() >= 0.99 and d.max() <= 1, (d > 0).sum()


# ------------------------------------------------------------------ masks
@pytest.mark.parametrize("field", range(len(FIELDS)))
@pytest.mark.parametrize("mode", ["weier", "author", "logpolar"])
def test_sampling_masks_bit_for_bit(mode, field):
    """The masks stage_sampling builds, for two frames (the stochastic
    falloffs draw anew each frame)."""
    h, w, _, (gy, gx) = FIELDS[field]
    jg = (jnp.asarray(gy), jnp.asarray(gx))
    jd = jsampling.gaze_distance(h, w, jg)
    td = sampling.gaze_distance(h, w, (gy, gx), "cpu")
    for frame in (0, 1):
        if mode == "logpolar":
            want = jsampling.logpolar_sampling(h, w, jg)
            got = sampling.logpolar_sampling(h, w, (gy, gx), "cpu")
        else:
            if mode == "weier":
                jr = jsampling.weier_sample_rate(jd, 0.07, 0.05)
                tr = sampling.weier_sample_rate(td, 0.07, 0.05)
            else:
                jr = jsampling.author_sample_rate(jd, 0.07)
                tr = sampling.author_sample_rate(td, 0.07)
            np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
            pix = np.arange(h * w).reshape(h, w)
            want = jrng.rnd(jrng.pixel_seed(jnp.asarray(pix), frame))[0] < jr
            got = rng.rnd(rng.pixel_seed(torch.as_tensor(pix),
                                         torch.tensor(frame)))[0] < tr
        want = np.asarray(want)
        assert 0 < want.sum() < want.size
        np.testing.assert_array_equal(got.numpy(), want)


# ---------------------------------------------------------------- goldens
def _golden(name):
    ref = np.load(os.path.join(GOLDEN_DIR, f"{name}.npz"))
    kw = dict(width=64, height=64, reconstruction="atrous", max_depth=3,
              diffuse_max_depth=1, ray_budget_frac=0.6)
    kw.update({k: v for k, v in json.loads(str(ref["spec"])).items()
               if k != "scene"})
    return ref, kw


def _port_frames(kw):
    scene = procedural.earth_scene("cpu")
    cam = Camera.create(eye=EYE, target=TARGET, device="cpu")
    cfg = RenderConfig(**kw)
    st = pipeline.FrameState.initial(cam, cfg)
    outs = []
    for _ in range(2):
        out, st = pipeline.render_frame(scene, cam, (32, 32), st, cfg)
        outs.append({k: out[k].numpy() for k in ("image", "mask",
                                                 "ray_count")})
    return outs


def _jax_frames(kw):
    scene = jprocedural.earth_scene()
    cam = JCamera.create(eye=EYE, target=TARGET)
    cfg = JRenderConfig(**kw)
    st = jpipeline.FrameState.initial(cam, cfg)
    outs = []
    for _ in range(2):
        out, st = jpipeline.render_frame_jit(
            scene, cam, (jnp.asarray(32), jnp.asarray(32)), st, cfg)
        outs.append({k: np.asarray(out[k]) for k in ("image", "mask",
                                                     "ray_count")})
    return outs


def _err(got, want):
    e = np.abs(got - want.astype(np.float32))
    return e.mean(), e.max()


def test_golden_earth_jfa():
    ref, kw = _golden("earth_jfa")
    out = _port_frames(kw)[-1]
    assert int(out["ray_count"]) == int(ref["ray_count"])
    mae, mx = _err(out["image"], ref["image"])
    assert mae < 5e-3 and mx < 0.1, (mae, mx)


def test_golden_earth_sibson():
    """The committed golden is stale: the jitted reference's own frame
    misses it (max 0.118 at 64x64, tests/test_golden.py's slow case fails
    the same way). The port is held to the jitted reference at the
    golden's tolerance, and misses the golden as the reference does."""
    ref, kw = _golden("earth_sibson")
    got, want = _port_frames(kw)[-1], _jax_frames(kw)[-1]
    np.testing.assert_array_equal(got["mask"], want["mask"])
    assert int(got["ray_count"]) == int(want["ray_count"]) == \
        int(ref["ray_count"])
    mae, mx = _err(got["image"], want["image"])
    assert mae < 5e-3 and mx < 0.1, (mae, mx)
    mae_r, mx_r = _err(want["image"], ref["image"])
    mae_p, mx_p = _err(got["image"], ref["image"])
    assert mx_r > 0.1 and abs(mx_p - mx_r) < 1e-3 and \
        abs(mae_p - mae_r) < 1e-4, (mae_r, mx_r, mae_p, mx_p)


def test_golden_earth_logpolar():
    """The committed golden is stale: it records 4,095 sampled pixels,
    the reference's log-polar mask (the one that rounds (u, v) to the
    buffer's texels) samples 1,235. The port's masks are the jitted
    reference's bit for bit and its images are within the golden's MAE
    bound; the glass-path pixels that leave the max bound are the
    documented deviation of ROADMAP section 3 (compiled rounding), capped
    at the count measured."""
    ref, kw = _golden("earth_logpolar")
    assert int(ref["ray_count"]) == 4095
    for got, want in zip(_port_frames(kw), _jax_frames(kw)):
        np.testing.assert_array_equal(got["mask"], want["mask"])
        assert int(got["ray_count"]) == int(want["ray_count"]) == 1235
        mae, _ = _err(got["image"], want["image"])
        outliers = int((np.abs(got["image"] - want["image"]).max(-1)
                        >= 0.1).sum())
        assert mae < 5e-3 and outliers <= LOGPOLAR_OUTLIERS, (mae, outliers)


def test_author_mode_renders_and_focuses():
    """tests/test_sampling_modes.py: the author falloff renders end to end
    and samples densest at the gaze."""
    scene = procedural.box_scene("cpu")
    cam = Camera.create(eye=EYE, target=TARGET, device="cpu")
    config = RenderConfig(width=64, height=64, sampling_mode="author",
                          reconstruction="pullpush", max_depth=2,
                          full_outputs=True, intersect_backend="brute")
    out, _ = pipeline.render_frame(scene, cam, (32, 32),
                                   pipeline.FrameState.initial(cam, config),
                                   config)
    mask = out["mask"].numpy()
    assert 0 < mask.sum() < mask.size
    assert mask[24:40, 24:40].mean() > mask[0:16, 0:16].mean()
    assert np.isfinite(out["image"].numpy()).all()
