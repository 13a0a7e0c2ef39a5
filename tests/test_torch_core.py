"""Parity of fovtrace_torch.core with the JAX reference on seeded inputs:
the RNG bit-exact, camera rays / reprojection / tone map at rtol 1e-5,
the quaternions and the camera's pose helpers at atol 1e-6, the history
fetch bit for bit."""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from fovtrace import Camera as JCamera  # noqa: E402
from fovtrace.core import color as jcolor  # noqa: E402
from fovtrace.core import mathx as jmathx  # noqa: E402
from fovtrace.core import reproject as jreproject  # noqa: E402
from fovtrace.core import rng as jrng  # noqa: E402
from fovtrace.core import vec as jvec  # noqa: E402
from fovtrace_torch.core import color, mathx, reproject, rng, vec  # noqa: E402
from fovtrace_torch.core.camera import Camera  # noqa: E402

POSES = [((3.0, 2.5, 4.0), (0.0, 0.8, 0.0)), ((-1.5, 0.7, 2.2), (0.3, 0.4, -0.2))]


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    # the suite runs in several worker processes at once; PyTorch's
    # default of one thread per core then oversubscribes the CPU, and its
    # spinning thread pool runs such a frame ~40x slower than at 2 threads
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _u32(seed, n):
    return np.random.default_rng(seed).integers(0, 2 ** 32, size=n,
                                                dtype=np.uint64)


def test_tea_and_lcg_bit_exact():
    a, b = _u32(0, 4096), _u32(1, 4096)
    want = np.asarray(jrng.tea(jnp.asarray(a.astype(np.uint32)),
                               jnp.asarray(b.astype(np.uint32))))
    got = rng.tea(torch.as_tensor(a.astype(np.int64)),
                  torch.as_tensor(b.astype(np.int64)))
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))

    js, ts = jnp.asarray(want), got
    for _ in range(8):
        jv, js = jrng.rnd(js)
        tv, ts = rng.rnd(ts)
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js).astype(np.int64))


def test_pixel_seed_bit_exact():
    idx = np.arange(0, 1 << 21, 97, dtype=np.int64)
    for frame in (0, 1, 12345):
        want = np.asarray(jrng.pixel_seed(jnp.asarray(idx.astype(np.int32)),
                                          frame))
        got = rng.pixel_seed(torch.as_tensor(idx), frame)
        np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


@pytest.mark.parametrize("pose", POSES)
def test_camera_rays_and_reprojection(pose):
    w, h = 48, 32
    cj = JCamera.create(eye=pose[0], target=pose[1])
    ct = Camera.create(eye=pose[0], target=pose[1], device="cpu")
    np.testing.assert_allclose(ct.inv_mvp(w / h).numpy(),
                               np.asarray(cj.inv_mvp(w / h)), rtol=1e-5,
                               atol=1e-6)
    oj, dj = cj.primary_rays_v(w, h)
    ot, dt = ct.primary_rays_v(w, h)
    for a, b in zip(dt, dj):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-6)
    for a, b in zip(ot, oj):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5)

    p = np.random.default_rng(2).normal(size=(3, 500)).astype(np.float32)
    uj, vj = cj.world_to_screen_v(jvec.Vec3(*map(jnp.asarray, p)), w, h)
    ut, vt = ct.world_to_screen_v(vec.Vec3(*map(torch.as_tensor, p)), w, h)
    np.testing.assert_allclose(ut.numpy(), np.asarray(uj), rtol=1e-5,
                               atol=1e-4)
    np.testing.assert_allclose(vt.numpy(), np.asarray(vj), rtol=1e-5,
                               atol=1e-4)


@pytest.mark.parametrize("size", [(48, 32), (32, 48)])
@pytest.mark.parametrize("mode", ["ortho", "ortho_width", "ortho_height"])
def test_ortho_rays_and_reprojection(mode, size):
    """The three orthographic modes (a static field of the reference's
    camera) at test_camera_rays_and_reprojection's bounds; fov_y is then
    the view's world extent."""
    w, h = size
    eye, target = POSES[0]
    cj = JCamera.create(eye=eye, target=target, fov_y=4.0, mode=mode)
    ct = Camera.create(eye=eye, target=target, fov_y=4.0, mode=mode,
                       device="cpu")
    np.testing.assert_allclose(ct.inv_mvp(w / h).numpy(),
                               np.asarray(cj.inv_mvp(w / h)), rtol=1e-5,
                               atol=1e-6)
    oj, dj = cj.primary_rays_v(w, h)
    ot, dt = ct.primary_rays_v(w, h)
    for a, b in zip(dt, dj):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-6)
    for a, b in zip(ot, oj):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5)
    # orthographic rays share one direction (to rounding) and start
    # across the image plane
    assert float(dt.x.std()) < 1e-6 and float(ot.x.std()) > 0.1

    p = np.random.default_rng(6).normal(size=(3, 500)).astype(np.float32)
    uj, vj = cj.world_to_screen_v(jvec.Vec3(*map(jnp.asarray, p)), w, h)
    ut, vt = ct.world_to_screen_v(vec.Vec3(*map(torch.as_tensor, p)), w, h)
    np.testing.assert_allclose(ut.numpy(), np.asarray(uj), rtol=1e-5,
                               atol=1e-4)
    np.testing.assert_allclose(vt.numpy(), np.asarray(vj), rtol=1e-5,
                               atol=1e-4)


def test_thin_lens_perturb():
    r = np.random.default_rng(3)
    d = r.normal(size=(3, 256)).astype(np.float32)
    d[2] = -np.abs(d[2]) - 1.0
    u1, u2 = r.random((2, 256)).astype(np.float32)
    cj = JCamera.create(eye=POSES[0][0], target=POSES[0][1])
    ct = Camera.create(eye=POSES[0][0], target=POSES[0][1], device="cpu")
    lj, nj = cj.thin_lens_perturb_v(jvec.normalize(jvec.Vec3(*map(jnp.asarray, d))),
                                    4.5, 0.05, jnp.asarray(u1), jnp.asarray(u2))
    lt, nt = ct.thin_lens_perturb_v(vec.normalize(vec.Vec3(*map(torch.as_tensor, d))),
                                    4.5, 0.05, torch.as_tensor(u1),
                                    torch.as_tensor(u2))
    for a, b in list(zip(lt, lj)) + list(zip(nt, nj)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-6)


def test_uncharted2_tonemap():
    x = np.random.default_rng(4).exponential(0.5, size=10000).astype(np.float32)
    want = np.asarray(jcolor.uncharted2_tonemap(jnp.asarray(x), 2.0))
    got = color.uncharted2_tonemap(torch.as_tensor(x), 2.0).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)


def test_validate_cache_and_history():
    h, w = 24, 40
    r = np.random.default_rng(5)
    ru = (r.random((h, w)) * (w + 4) - 2).astype(np.float32)
    rv = (r.random((h, w)) * (h + 4) - 2).astype(np.float32)
    pos = r.normal(size=(3, h, w)).astype(np.float32)
    eye = np.asarray([0.5, 0.2, -0.1], np.float32)
    dist = np.sqrt(((pos - eye[:, None, None]) ** 2).sum(0))
    depth = (dist + r.normal(scale=2e-3, size=(h, w))).astype(np.float32)
    hist = r.random((4, h, w)).astype(np.float32)
    vj, _, _, fj = jreproject.validate_cache(
        jnp.asarray(ru), jnp.asarray(rv), jvec.Vec3(*map(jnp.asarray, pos)),
        jnp.asarray(depth), jnp.asarray(eye), w, h, 1e-3,
        history=jnp.asarray(hist))
    vt, _, _, ft = reproject.validate_cache(
        torch.as_tensor(ru), torch.as_tensor(rv),
        vec.Vec3(*map(torch.as_tensor, pos)), torch.as_tensor(depth),
        torch.as_tensor(eye), w, h, 1e-3, history=torch.as_tensor(hist))
    np.testing.assert_array_equal(ft.numpy(), np.asarray(fj))
    # validity thresholds a float32 depth difference: allow a few
    # borderline pixels where the two sqrt roundings straddle 1e-3
    assert (vt.numpy() != np.asarray(vj)).sum() <= 2
    np.testing.assert_array_equal(
        reproject.history_from_fetch(ft, vt).numpy(),
        np.asarray(jreproject.history_from_fetch(fj, jnp.asarray(vt.numpy()))))


def test_quaternions():
    r = np.random.default_rng(8)
    for _ in range(4):
        axis = r.normal(size=3).astype(np.float32)
        angle = float(r.uniform(-4.0, 4.0))
        v = r.normal(size=(5, 3)).astype(np.float32)
        jq = jmathx.quat_from_axis_angle(jnp.asarray(axis), angle)
        q = mathx.quat_from_axis_angle(torch.as_tensor(axis), angle)
        np.testing.assert_allclose(q.numpy(), np.asarray(jq), atol=1e-6)
        np.testing.assert_allclose(
            mathx.quat_rotate(q, torch.as_tensor(v)).numpy(),
            np.asarray(jmathx.quat_rotate(jq, jnp.asarray(v))), atol=1e-6)
        np.testing.assert_allclose(mathx.quat_mul(q, q.flip(0)).numpy(),
                                   np.asarray(jmathx.quat_mul(jq, jq[::-1])),
                                   atol=1e-6)


@pytest.mark.parametrize("pose", POSES)
def test_camera_pose_helpers(pose):
    """translate, rotate and rotate_around against the reference's; an
    orbit by 2 pi returns the camera (tests/test_core.py)."""
    eye, target = pose
    jc = JCamera.create(eye=eye, target=target)
    c = Camera.create(eye=eye, target=target, device="cpu")
    cases = [(lambda k: k.translate((0.5, -0.25, 1.0))),
             (lambda k: k.rotate(0.6, (0.0, 1.0, 0.0))),
             (lambda k: k.rotate(-1.1, (1.0, 0.5, -0.2))),
             (lambda k: k.rotate_around((0.0, 1.0, 0.0), 2.2, (0.0, 1.0, 0.3)))]
    for f in cases:
        got, want = f(c), f(jc)
        for k in ("eye", "target", "up"):
            np.testing.assert_allclose(getattr(got, k).numpy(),
                                       np.asarray(getattr(want, k)),
                                       atol=1e-6, err_msg=k)
    full = c.rotate_around((0.0, 2.0, 0.0), 2.0 * np.pi, (0.0, 1.0, 0.0))
    np.testing.assert_allclose(full.eye.numpy(), c.eye.numpy(), atol=1e-5)


def test_fetch_history():
    h, w = 12, 20
    r = np.random.default_rng(9)
    hist = r.random((4, h, w)).astype(np.float32)
    qy = r.integers(0, h, (h, w))
    qx = r.integers(0, w, (h, w))
    valid = (r.random((h, w)) > 0.3).astype(np.float32)
    want = jreproject.fetch_history(jnp.asarray(hist), jnp.asarray(qy),
                                    jnp.asarray(qx), jnp.asarray(valid))
    got = reproject.fetch_history(torch.as_tensor(hist), torch.as_tensor(qy),
                                  torch.as_tensor(qx), torch.as_tensor(valid))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
