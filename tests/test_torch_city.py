"""The 170k-triangle city scene against the JAX reference: the port's own
build equal bitwise, its supercluster schedule (M = 2) equal bitwise,
the plain versions of the cluster kernels against the reference's brute
force, the route each scene takes, and a two-frame 32x32 city frame
against the reference's frame."""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from fovtrace import Camera as JCamera  # noqa: E402
from fovtrace import RenderConfig as JRenderConfig  # noqa: E402
from fovtrace.kernels import intersect as jisect  # noqa: E402
from fovtrace.kernels import pallas_isect  # noqa: E402
from fovtrace.render import pipeline as jpipeline  # noqa: E402
from fovtrace.scene import procedural as jprocedural  # noqa: E402
from fovtrace_torch import Camera, RenderConfig, convert  # noqa: E402
from fovtrace_torch.core.vec import Vec3  # noqa: E402
from fovtrace_torch.kernels import cluster_isect as ci  # noqa: E402
from fovtrace_torch.kernels import intersect as isect  # noqa: E402
from fovtrace_torch.render import pipeline  # noqa: E402
from fovtrace_torch.scene import procedural  # noqa: E402

BIG_T = isect.BIG_T
EYE, TARGET = (3.0, 2.5, 4.0), (0.0, 0.8, 0.0)
SIZE = 32
# tests/test_torch_frame.py's configuration and image tolerances
KW = dict(width=SIZE, height=SIZE, reconstruction="atrous", max_depth=3,
          diffuse_max_depth=1, ray_budget_frac=0.6)


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
def city():
    return jprocedural.city_scene(), procedural.city_scene("cpu")


def _primary(res):
    cam = JCamera.create(eye=EYE, target=TARGET)
    ro, rd = cam.primary_rays(res, res)
    return (np.asarray(ro).reshape(-1, 3).astype(np.float32),
            np.asarray(rd).reshape(-1, 3).astype(np.float32))


def _tv(rows):
    return Vec3(*[torch.tensor(rows[:, k]) for k in range(3)])


def test_city_scene_equals_reference(city):
    sj, st = city
    ref, port = convert.to_numpy(sj), convert.to_numpy(st)
    # the port's Scene also holds the kernels' records and flags
    assert port.keys() == ref.keys() | {"isect_rec", "isect_tflags"}
    for k in ref:
        if isinstance(ref[k], np.ndarray):
            assert ref[k].dtype == port[k].dtype, k
            np.testing.assert_array_equal(port[k], ref[k], err_msg=k)
        else:
            assert ref[k] == port[k], k
    assert st.num_triangles == 170368
    nc, c = st.cluster_aabb.shape[0], st.isect_coef.shape[2] // 4
    assert (nc, c) == (1332, 128)
    assert ci.pick_members(nc) == 2


def test_city_schedule_exact(city):
    _, st = city
    ro, rd = _primary(SIZE)
    raysT, n = ci.pack_raysT(_tv(ro), _tv(rd), 1e-3, BIG_T)
    assert n == 1024
    sched_j = pallas_isect.cluster_schedule(
        jnp.asarray(raysT.numpy()), jnp.asarray(st.cluster_aabb.numpy()))
    sched_t = ci.cluster_schedule(raysT, st.cluster_aabb)
    assert sched_t[0].shape == (4, 2 * 768)        # NSC 666 -> SW 768
    for a, b in zip(sched_t, sched_j):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    bits = sched_t[0][:, 768:]
    assert int(bits.max()) == 3 and int((bits == 1).sum()) > 0


def _shadow_rays(sj, res):
    ro, rd = _primary(res)
    hit = jisect.intersect_brute(sj, jnp.asarray(ro), jnp.asarray(rd), 1e-3,
                                 BIG_T)
    surf = jisect.hit_surface(sj, jnp.asarray(ro), jnp.asarray(rd), hit)
    light = sj.light
    lp = light.corner + 0.3 * light.v1 + 0.6 * light.v2
    to_l = lp - surf["point"]
    ld = jnp.linalg.norm(to_l, axis=-1)
    o = surf["point"] + surf["gnormal"] * 1e-3
    return (np.asarray(o), np.asarray(to_l / ld[:, None]),
            np.asarray(ld - 1e-3))


def test_city_plain_closest_matches_brute(city):
    sj, st = city
    ro, rd = _primary(24)
    hb = jisect.intersect_brute(sj, jnp.asarray(ro), jnp.asarray(rd), 1e-3,
                                BIG_T)
    ci.reset_counters()
    ht = isect.intersect_v(st, _tv(ro), _tv(rd), 1e-3, BIG_T,
                           backend="cluster")
    assert ci.counters()["closest_hit_plain"] == 1
    tb, tt = np.asarray(hb.tri), ht.tri.numpy()
    hit = tb >= 0
    assert ((tt >= 0) == hit).all(), "hit/miss flips"
    assert (hit & (tb == tt)).sum() >= hit.sum() * 0.995
    np.testing.assert_allclose(ht.t.numpy()[hit], np.asarray(hb.t)[hit],
                               rtol=1e-3, atol=1e-4)


def test_city_plain_occlusion_matches_brute(city):
    sj, st = city
    o, l, tmax = _shadow_rays(sj, 24)
    ab = jisect.occlusion_brute(sj, jnp.asarray(o), jnp.asarray(l), 1e-3,
                                jnp.asarray(tmax))
    ci.reset_counters()
    at = isect.occlusion_v(st, _tv(o), _tv(l), 1e-3, torch.tensor(tmax),
                           backend="cluster")
    assert ci.counters()["occlusion_plain"] == 1
    np.testing.assert_allclose(torch.stack(list(at), -1).numpy(),
                               np.asarray(ab), rtol=1e-4, atol=1e-4)
    assert (np.asarray(ab).max(-1) == 0).any()   # some are occluded


@pytest.mark.parametrize("case", ["earth", "city", "forced"])
def test_route_predicate(city, case, monkeypatch):
    """The port takes the counterpart of the kernel the reference gives a
    pack: resident up to 4 MiB of bf16x3 pack, streaming above."""
    if case == "city":
        scene = city[1]
    else:
        scene = procedural.earth_scene("cpu")
    if case == "forced":
        monkeypatch.setattr(ci, "_COEF_RESIDENT_BYTES", 0)
    nc, c = scene.cluster_aabb.shape[0], scene.isect_coef.shape[2] // 4
    packed = pallas_isect._pack_coef(jnp.asarray(scene.isect_coef.numpy()))
    ref = packed.size * packed.dtype.itemsize > ci._COEF_RESIDENT_BYTES
    want = "resident" if case == "earth" else "stream"
    assert ref == (want == "stream")
    assert ci.route(nc, c) == want


def test_city_frame_matches_reference(city):
    sj, st = city
    jcfg = JRenderConfig(**KW)
    jcam = JCamera.create(eye=EYE, target=TARGET)
    jstate = jpipeline.FrameState.initial(jcam, jcfg)
    gaze = (jnp.asarray(SIZE // 2), jnp.asarray(SIZE // 2))
    cfg = RenderConfig(**KW)
    cam = Camera.create(eye=EYE, target=TARGET, device="cpu")
    state = pipeline.FrameState.initial(cam, cfg)
    ci.reset_counters()
    for _ in range(2):
        want, jstate = jpipeline.render_frame_jit(sj, jcam, gaze, jstate,
                                                  jcfg)
        got, state = pipeline.render_frame(st, cam, (SIZE // 2, SIZE // 2),
                                           state, cfg)
        np.testing.assert_array_equal(got["mask"].numpy(),
                                      np.asarray(want["mask"]))
        for k in ("ray_count", "rays_dropped", "rays_traced"):
            assert int(got[k]) == int(want[k]), k
        err = np.abs(got["image"].numpy() - np.asarray(want["image"]))
        assert err.mean() < 5e-3 and err.max() < 0.1, (err.mean(), err.max())
    counts = ci.counters()
    assert counts["closest_hit_plain"] > 0 and counts["occlusion_plain"] > 0
    assert counts["intersect_brute"] == 0


def test_city_stream_inputs_from_reference_pack(city):
    """City's pack-time records (27.3 MB, M = 2) and transparency flags
    against the reference's pack, member slab by member slab."""
    sj, st = city
    coef = np.asarray(sj.isect_coef)
    nc, c = coef.shape[0], coef.shape[2] // 4
    rec = st.isect_rec.numpy()
    assert rec.shape == (nc, c, 40) and rec.flags["C_CONTIGUOUS"]
    for q in range(4):
        # rec[:, j, q*10 + k] = coef[:, k, q*c + j]
        np.testing.assert_array_equal(
            rec[:, :, q * 10:(q + 1) * 10],
            coef[:, :10, q * c:(q + 1) * c].transpose(0, 2, 1))
    aux = np.asarray(sj.isect_aux)
    np.testing.assert_array_equal(
        st.isect_tflags.numpy(),
        (aux[:, 0, :].max(axis=1) > 0.0).astype(np.int32))
