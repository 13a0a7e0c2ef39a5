"""fovtrace_torch intersection against the JAX reference: the pack
inputs (pack_raysT, block_liveness, cluster_schedule) exactly equal, the
plain versions of the cluster kernels against the Pallas kernels run in
interpret mode (as tests/test_pallas_isect.py runs them on the CPU), and
the brute-force oracles against each other."""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from fovtrace import Camera as JCamera  # noqa: E402
from fovtrace.core import vec as jvec  # noqa: E402
from fovtrace.kernels import intersect as jisect  # noqa: E402
from fovtrace.kernels import pallas_isect  # noqa: E402
from fovtrace.scene import procedural as jprocedural  # noqa: E402
from fovtrace_torch.core.vec import Vec3  # noqa: E402
from fovtrace_torch.kernels import cluster_isect as ci  # noqa: E402
from fovtrace_torch.kernels import intersect as isect  # noqa: E402
from fovtrace_torch.scene import procedural  # noqa: E402

BIG_T = isect.BIG_T


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
def scenes():
    return {n: (jprocedural.SCENES[n](), procedural.SCENES[n]("cpu"))
            for n in ("earth", "box")}


def _primary(res):
    cam = JCamera.create(eye=(3.0, 2.5, 4.0), target=(0.0, 0.8, 0.0))
    ro, rd = cam.primary_rays(res, res)
    return (np.asarray(ro).reshape(-1, 3).astype(np.float32),
            np.asarray(rd).reshape(-1, 3).astype(np.float32))


def _jv(rows):
    return jvec.from_rows(jnp.asarray(rows))


def _tv(rows):
    return Vec3(*[torch.tensor(rows[:, k]) for k in range(3)])


@pytest.mark.parametrize("name", ["earth", "box"])
@pytest.mark.parametrize("n", [1024, 100])
def test_pack_and_schedule_exact(scenes, name, n):
    sj, st = scenes[name]
    ro, rd = _primary(32)
    ro, rd = ro[:n], rd[:n]
    tmax = np.where(np.arange(n) % 7 == 0, -1.0, 50.0).astype(np.float32)
    rj, nj = pallas_isect.pack_raysT(_jv(ro), _jv(rd), 1e-3, jnp.asarray(tmax))
    rt, nt = ci.pack_raysT(_tv(ro), _tv(rd), 1e-3, torch.tensor(tmax))
    assert nj == nt == n
    nb = rt.shape[0]
    assert nb == (n + 255) // 256
    # the reference pads to whole 8-block groups; the port to blocks
    np.testing.assert_array_equal(rt.numpy(), np.asarray(rj)[:nb])

    raysT = rt.numpy()
    clusters = st.cluster_aabb.numpy()
    lj, tj = pallas_isect.block_liveness(jnp.asarray(raysT),
                                         jnp.asarray(clusters))
    lt, tt = ci.block_liveness(rt, st.cluster_aabb)
    np.testing.assert_array_equal(lt.numpy(), np.asarray(lj))
    np.testing.assert_array_equal(tt.numpy(), np.asarray(tj))

    sched_j = pallas_isect.cluster_schedule(jnp.asarray(raysT),
                                            jnp.asarray(clusters))
    sched_t = ci.cluster_schedule(rt, st.cluster_aabb)
    for a, b in zip(sched_t, sched_j):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("name", ["earth", "box"])
def test_plain_closest_matches_pallas(scenes, name):
    sj, st = scenes[name]
    ro, rd = _primary(32)
    hp = pallas_isect.intersect_pallas(sj, _jv(ro), _jv(rd), 1e-3, BIG_T)
    hr = jisect.refine_hit(sj, jnp.asarray(ro), jnp.asarray(rd), hp)
    ci.reset_counters()
    ht = isect.intersect_v(st, _tv(ro), _tv(rd), 1e-3, BIG_T,
                           backend="cluster")
    assert ci.counters()["closest_hit_plain"] == 1
    tp, tt = np.asarray(hp.tri), ht.tri.numpy()
    hit = tp >= 0
    assert ((tt >= 0) == hit).all(), "hit/miss flips"
    same = hit & (tp == tt)
    assert same.sum() >= hit.sum() * 0.995
    np.testing.assert_allclose(ht.t.numpy()[hit], np.asarray(hr.t)[hit],
                               rtol=1e-3, atol=1e-4)


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


@pytest.mark.parametrize("name", ["earth", "box"])
def test_plain_occlusion_matches_pallas(scenes, name):
    sj, st = scenes[name]
    o, l, tmax = _shadow_rays(sj, 16)
    aj = pallas_isect.occlusion_pallas(sj, _jv(o), _jv(l), 1e-3,
                                       jnp.asarray(tmax))
    at = isect.occlusion_v(st, _tv(o), _tv(l), 1e-3, torch.tensor(tmax),
                           backend="cluster")
    for a, b in zip(at, aj):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4,
                                   atol=1e-4)


@pytest.mark.parametrize("name", ["earth", "box"])
def test_hit_surface_matches_reference(scenes, name):
    sj, st = scenes[name]
    ro, rd = _primary(24)
    hj = jisect.intersect_brute(sj, jnp.asarray(ro), jnp.asarray(rd), 1e-3,
                                BIG_T)
    sj_ = jisect.hit_surface_v(sj, _jv(ro), _jv(rd), hj)
    ht = isect.Hit(*(torch.tensor(np.asarray(a)) for a in
                     (hj.t, hj.tri, hj.u, hj.v)))
    s_t = isect.hit_surface_v(st, _tv(ro), _tv(rd), ht)
    for k in ("point", "normal", "gnormal", "kd"):
        for a, b in zip(s_t[k], sj_[k]):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                       atol=1e-6, err_msg=k)
    for k in ("u_tex", "v_tex", "t_safe"):
        np.testing.assert_allclose(s_t[k].numpy(), np.asarray(sj_[k]),
                                   rtol=1e-5, atol=1e-6, err_msg=k)
    np.testing.assert_array_equal(s_t["mat_id"].numpy(),
                                  np.asarray(sj_["mat_id"]))


def test_ragged_ray_count_exact_ids(scenes):
    sj, st = scenes["box"]
    ro, rd = _primary(16)
    ro, rd = ro[:100], rd[:100]
    hb = jisect.intersect_brute(sj, jnp.asarray(ro), jnp.asarray(rd), 1e-3,
                                BIG_T)
    hp = pallas_isect.intersect_pallas(sj, _jv(ro), _jv(rd), 1e-3, BIG_T)
    ht = ci.intersect_cluster(st, _tv(ro), _tv(rd), 1e-3, BIG_T)
    np.testing.assert_array_equal(ht.tri.numpy(), np.asarray(hb.tri))
    np.testing.assert_array_equal(ht.tri.numpy(), np.asarray(hp.tri))


@pytest.mark.parametrize("name", ["earth", "box"])
def test_brute_matches_brute(scenes, name):
    sj, st = scenes[name]
    ro, rd = _primary(32)
    hj = jisect.intersect_brute(sj, jnp.asarray(ro), jnp.asarray(rd), 1e-3,
                                BIG_T)
    ht = isect.intersect_brute(st, _tv(ro), _tv(rd), 1e-3, BIG_T)
    np.testing.assert_array_equal(ht.tri.numpy(), np.asarray(hj.tri))
    hit = np.asarray(hj.tri) >= 0
    np.testing.assert_allclose(ht.t.numpy()[hit], np.asarray(hj.t)[hit],
                               rtol=1e-5, atol=1e-6)
    o, l, tmax = _shadow_rays(sj, 16)
    oj = jisect.occlusion_brute(sj, jnp.asarray(o), jnp.asarray(l), 1e-3,
                                jnp.asarray(tmax))
    ot = isect.occlusion_brute(st, _tv(o), _tv(l), 1e-3, torch.tensor(tmax))
    np.testing.assert_allclose(torch.stack(list(ot), -1).numpy(),
                               np.asarray(oj), rtol=1e-5, atol=1e-6)


def test_wrappers_validate_inputs(scenes):
    _, st = scenes["box"]
    ro, rd = _primary(16)
    raysT, _ = ci.pack_raysT(_tv(ro), _tv(rd), 1e-3, BIG_T)
    sched, counts, params = ci.cluster_schedule(raysT, st.cluster_aabb)
    coef, aux = st.isect_coef, st.isect_aux
    with pytest.raises(TypeError, match="raysT"):
        ci.closest_hit(raysT.double(), coef, sched, counts, params)
    with pytest.raises(ValueError, match="contiguous"):
        ci.closest_hit(raysT.transpose(0, 2).contiguous().transpose(0, 2),
                       coef, sched, counts, params)
    with pytest.raises(ValueError, match="counts"):
        ci.occlusion(raysT, coef, aux, sched, counts[:-1], params)
    with pytest.raises(ValueError, match="aux"):
        ci.occlusion(raysT, coef, aux[:, :5], sched, counts, params)
    with pytest.raises(ValueError, match="raysT"):
        ci.closest_hit(raysT[:, :12].contiguous(), coef, sched, counts,
                       params)
