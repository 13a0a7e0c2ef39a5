"""fovtrace_torch intersection against the JAX reference: the pack
inputs (pack_raysT, block_liveness, cluster_schedule) exactly equal, the
plain versions of the cluster kernels against the Pallas kernels run in
interpret mode (as tests/test_pallas_isect.py runs them on the CPU), and
the brute-force oracles against each other."""

import contextlib
import ctypes

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


def test_plain_supercluster_matches_pallas_stream(monkeypatch):
    """M > 1: the plain versions walk the two-level schedule (member
    bitmask) as the reference's streaming kernels do. Forced on the multi
    scene as tests/test_pallas_isect.py forces it: MAX_SCHED = 4 and a
    zero residency threshold, on both sides, then a repack."""
    sj, st = jprocedural.multi_object_scene(), procedural.multi_object_scene(
        "cpu")
    ro, rd = _primary(24)
    for mod in (pallas_isect, ci):
        monkeypatch.setattr(mod, "MAX_SCHED", 4)
        monkeypatch.setattr(mod, "_COEF_RESIDENT_BYTES", 0)
    pallas_isect._closest_call_pre.clear_cache()
    pallas_isect._occlusion_call_pre.clear_cache()
    try:
        sj2, st2 = sj.with_pack(), st.with_pack()
        nc = st2.cluster_aabb.shape[0]
        assert ci.pick_members(nc) == pallas_isect.pick_members(nc) == 16
        np.testing.assert_array_equal(st2.isect_coef.numpy(),
                                      np.asarray(sj2.isect_coef))
        hp = pallas_isect.intersect_pallas(sj2, _jv(ro), _jv(rd), 1e-3, BIG_T)
        hr = jisect.refine_hit(sj2, jnp.asarray(ro), jnp.asarray(rd), hp)
        op = pallas_isect.occlusion_pallas(sj2, _jv(ro), _jv(rd), 1e-3, BIG_T)
    finally:
        pallas_isect._closest_call_pre.clear_cache()
        pallas_isect._occlusion_call_pre.clear_cache()
    ci.reset_counters()
    ht = isect.intersect_v(st2, _tv(ro), _tv(rd), 1e-3, BIG_T,
                           backend="cluster")
    ot = isect.occlusion_v(st2, _tv(ro), _tv(rd), 1e-3, BIG_T,
                           backend="cluster")
    assert ci.counters()["closest_hit_plain"] == 1
    assert ci.counters()["occlusion_plain"] == 1
    tp, tt = np.asarray(hp.tri), ht.tri.numpy()
    hit = tp >= 0
    assert ((tt >= 0) == hit).all(), "hit/miss flips"
    assert (hit & (tp == tt)).sum() >= hit.sum() * 0.995
    np.testing.assert_allclose(ht.t.numpy()[hit], np.asarray(hr.t)[hit],
                               rtol=1e-3, atol=1e-4)
    for a, b in zip(ot, op):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4,
                                   atol=1e-4)


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
    with pytest.raises(ValueError, match="schedmask"):
        ci.closest_hit(raysT, coef, sched[:, :2].contiguous(), counts,
                       params)
    with pytest.raises(ValueError, match="visited"):
        ci.closest_hit(raysT, coef, sched, counts, params,
                       visited=torch.zeros_like(counts))


def _records_from_reference(coef):
    """The streaming kernels' records from a reference pack, element by
    element: rec[jc, j, q*10 + k] = coef[jc, k, q*c + j]."""
    nc, c = coef.shape[0], coef.shape[2] // 4
    j, q, k = np.meshgrid(np.arange(c), np.arange(4), np.arange(10),
                          indexing="ij")
    rec = np.full((nc, c, 40), np.nan, np.float32)
    rec[:, j, q * 10 + k] = coef[:, k, q * c + j]
    return rec


@pytest.mark.parametrize("name", ["earth", "box"])
def test_stream_inputs_from_reference_pack(scenes, name):
    """The port's pack-time records, aux slabs and transparency flags
    against the reference's pack (pallas_isect.compute_pack)."""
    sj, st = scenes[name]
    coef_j, aux_j, _ = (np.asarray(a) for a in pallas_isect.compute_pack(sj))
    nc, c = coef_j.shape[0], coef_j.shape[2] // 4
    np.testing.assert_array_equal(st.isect_rec.numpy(),
                                  _records_from_reference(coef_j))
    # a transparent member's aux rows 0-4 are one contiguous 20c-byte slab
    np.testing.assert_array_equal(
        st.isect_aux.reshape(nc, 8 * c)[:, :5 * c].numpy(),
        aux_j[:, :5, :].reshape(nc, 5 * c))
    want = (aux_j[:, 0, :].max(axis=1) > 0.0).astype(np.int32)
    assert st.isect_tflags.dtype == torch.int32
    np.testing.assert_array_equal(st.isect_tflags.numpy(), want)
    np.testing.assert_array_equal(ci.cluster_tflags(st.isect_aux).numpy(),
                                  want)


@pytest.mark.parametrize("route", ["resident", "stream"])
def test_wrappers_take_stream_inputs_on_cpu(scenes, route, monkeypatch):
    """On the CPU the wrappers give the plain results with and without
    the pack-time records and flags, and with a forced split."""
    _, st = scenes["earth"]
    if route == "stream":
        monkeypatch.setattr(ci, "_COEF_RESIDENT_BYTES", 0)
    assert ci.route(st.cluster_aabb.shape[0], 128) == route
    o, l, tmax = _shadow_rays(scenes["earth"][0], 16)
    raysT, _ = ci.pack_raysT(_tv(o), _tv(l), 1e-3, torch.tensor(tmax))
    sched, counts, params = ci.cluster_schedule(raysT, st.cluster_aabb)
    a = (raysT, st.isect_coef, sched, counts, params)
    oa = (raysT, st.isect_coef, st.isect_aux, sched, counts, params)
    want_c = ci.closest_hit_plain(*a)
    want_o = ci.occlusion_plain(*oa)
    ci.reset_counters()
    for kw, split in (({}, None), (dict(rec=st.isect_rec), None),
                      (dict(rec=st.isect_rec), "all")):
        with ci.forced_split(split) if split else contextlib.nullcontext():
            for x, y in zip(ci.closest_hit(*a, **kw), want_c):
                assert torch.equal(x, y)
            kw = dict(kw, tflags=st.isect_tflags) if kw else kw
            for x, y in zip(ci.occlusion(*oa, **kw), want_o):
                assert torch.equal(x, y)
    got = ci.counters()
    assert got["closest_hit_plain"] == 3 and got["occlusion_plain"] == 3
    assert got["closest_hit_stream"] == got["closest_hit"] == 0


def test_wrappers_validate_stream_inputs(scenes, monkeypatch):
    _, st = scenes["box"]
    ro, rd = _primary(16)
    raysT, _ = ci.pack_raysT(_tv(ro), _tv(rd), 1e-3, BIG_T)
    sched, counts, params = ci.cluster_schedule(raysT, st.cluster_aabb)
    a = (raysT, st.isect_coef, sched, counts, params)
    oa = (raysT, st.isect_coef, st.isect_aux, sched, counts, params)
    with pytest.raises(ValueError, match="rec"):
        ci.closest_hit(*a, rec=st.isect_rec[:, :, :10].contiguous())
    with pytest.raises(TypeError, match="rec"):
        ci.closest_hit(*a, rec=st.isect_rec.double())
    with pytest.raises(TypeError, match="tflags"):
        ci.occlusion(*oa, tflags=st.isect_tflags.float())
    with pytest.raises(ValueError, match="tflags"):
        ci.occlusion(*oa, tflags=st.isect_tflags[:-1].contiguous())
    with pytest.raises(KeyError):
        with ci.forced_split("some"):
            pass
    assert ci._split is None
    with pytest.raises(ValueError, match="order"):
        with ci.forced_grid(3, "random"):
            pass
    with pytest.raises(ValueError, match="CTAs"):
        with ci.forced_grid(-1):
            pass
    assert ci._grid is None
    # a count of CUDA warps: both routes' kernels take it, the plain
    # version (every CPU call) has none
    for r in ("resident", "stream"):
        if r == "stream":
            monkeypatch.setattr(ci, "_COEF_RESIDENT_BYTES", 0)
        assert ci.route(st.cluster_aabb.shape[0], 128) == r
        with pytest.raises(ValueError, match="ray_visited counts a CUDA"):
            ci.occlusion(*oa, ray_visited=torch.zeros_like(counts))
        with pytest.raises(ValueError, match="ray_visited counts a CUDA"):
            ci.closest_hit(*a, ray_visited=torch.zeros_like(counts))


def test_ticket_order_is_stable_longest_first():
    """The resident kernels' ticket order: a permutation of the ray
    blocks, the most live entries first, ties in block order (numpy's
    stable sort of the negated counts)."""
    r = np.random.default_rng(5)
    for n in (1, 7, 300, 8160):
        counts = torch.tensor(r.integers(0, 12, size=n), dtype=torch.int32)
        order = ci.ticket_order(counts)
        assert order.dtype == torch.int64 and order.shape == (n,)
        np.testing.assert_array_equal(
            order.numpy(), np.argsort(-counts.numpy(), kind="stable"))
        assert torch.equal(torch.sort(order).values, torch.arange(n))
        c = counts[order]
        assert bool((c[:-1] >= c[1:]).all())
        tie = c[:-1] == c[1:]
        assert bool((order[:-1][tie] < order[1:][tie]).all())


class _Lib:
    """Stands in for the kernel library: records each entry point's
    arguments."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        return lambda *args: self.calls.append((name, args)) or 0


@pytest.mark.parametrize("force", [None, "grid", "split"])
@pytest.mark.parametrize("r", ["resident", "stream"])
@pytest.mark.parametrize("kind", ["closest_hit", "occlusion"])
def test_launch_arguments_fit_the_c_entry_points(scenes, kind, r, force,
                                                 monkeypatch):
    """`_launch` passes each C entry point as many arguments as its
    ctypes signature has, pointers where it takes pointers (NULL for an
    absent count) and ints where it takes ints: the resident kernels
    take rec, the ticket order and counter and ray_visited; a forced
    grid or split adds its ints. Run on CPU tensors against a stand-in
    library."""
    _, st = scenes["earth"]
    lib = _Lib()
    monkeypatch.setattr(ci, "load_cuda_library", lambda: lib)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: type("S", (), {"cuda_stream": 0}))
    ro, rd = _primary(16)
    raysT, _ = ci.pack_raysT(_tv(ro), _tv(rd), 1e-3, BIG_T)
    sched, counts, params = ci.cluster_schedule(raysT, st.cluster_aabb)
    nb, c = raysT.shape[0], 128
    out = torch.empty((3, nb, 256))
    head = (raysT, st.isect_rec) if kind == "closest_hit" else \
        (raysT, st.isect_rec, st.isect_aux, st.isect_tflags)
    tail = (out[0], out[1].view(torch.int32)) if kind == "closest_hit" \
        else (out[0], out[1], out[2])
    if r == "resident":
        ptrs = head + (sched, counts, *ci._tickets(counts), params) + tail
        shape = (nb, c, sched.shape[1] // 2)
    else:
        ptrs = head + (sched, counts, params) + tail
        shape = (nb, c, sched.shape[1] // 2, 1)
    visited = torch.ones_like(counts)
    ctx = {None: contextlib.nullcontext(), "grid": ci.forced_grid(2),
           "split": ci.forced_split("all")}[force]
    ci.reset_counters()
    with ctx:
        ci._launch(kind, r, raysT, ptrs, visited, None, shape)
    (name, args), = lib.calls
    suffix = {("resident", "grid"): "_grid",
              ("stream", None): "_stream", ("stream", "grid"): "_stream",
              ("stream", "split"): "_stream_split"}.get((r, force), "")
    assert name == f"fov_{kind}{suffix}"
    argtypes, _ = ci.c_signatures()[name]
    assert len(args) == len(argtypes)
    for v, t in zip(args, argtypes):
        assert (v is None or isinstance(v, int)), (name, v)
        if t is ctypes.c_int:
            assert isinstance(v, int) and -1 <= v < 1 << 31, (name, v)
    # visited is zeroed before the launch, ray_visited is NULL
    assert int(visited.sum()) == 0
    assert args[len(ptrs)] == visited.data_ptr()
    assert args[len(ptrs) + 1] is None
    assert ci.counters()[kind + ("_stream" if r == "stream" else "")] == 1
