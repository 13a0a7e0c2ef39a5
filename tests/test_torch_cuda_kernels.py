"""The CUDA cluster kernels against their plain PyTorch versions, on the
card: the resident kernels on earth (on every forced grid and ticket
order, on blocks that alternate near and far hits, on crafted exact
ties and on blocks whose warps exit at different points), the streaming
kernels on the city scene (M = 2), on earth forced to stream (bit for
bit equal to the resident kernels), on multi forced to M = 16, on the
same ties and warp exits, and with the ray blocks' split forced; then
the probe kernels (csrc/probes.cu) on their default and forced grids,
and the row-copy probe on each of its table paths; then the material
table's gather and adjoint (csrc/material.cu) at the CPU tests' shapes,
at the 1920x1088 front and at the largest table they take; then the
envmap's lookup, d(fx, fy) and adjoint (csrc/envmap.cu) at the CPU
tests' maps and directions, at seeded 1920x1088 worst cases, on an
800x1600 map and on the two maps either side of the adjoint's route
boundary (chip_smoke.py's [envmap] cases, inputs and checks), with
nonfinite cotangents, through EnvmapLookup, and on both of the
adjoint's routes (the same bits; the shared route refused where no block
holds the map). Seeded rays. Marked `cuda`; skipped without a GPU.

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_kernels.py
"""

import contextlib

import numpy as np
import pytest
import torch

import chip_smoke
from fovtrace_torch import Camera, kernels
from fovtrace_torch.core.vec import Vec3
from fovtrace_torch.kernels import cluster_isect as ci
from fovtrace_torch.kernels import intersect as isect
from fovtrace_torch.kernels import material
from fovtrace_torch.render import gbuffer
from fovtrace_torch.scene import procedural
from fovtrace_torch.scripts import MICRO_VARIANTS, forced_grid
from fovtrace_torch.scripts import microbench_inner as mb
from fovtrace_torch.scripts import probe_smem_dma as dma

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda", 0)


@pytest.fixture(scope="module")
def earth(dev):
    return procedural.earth_scene(dev)


@pytest.fixture(scope="module")
def city(dev):
    return procedural.city_scene(dev)


def _ray_sets(scene, dev):
    r = np.random.default_rng(7)
    n = 4096
    ctr = ((scene.bbox_min + scene.bbox_max) / 2).cpu().numpy()
    ext = float(torch.linalg.vector_norm(scene.bbox_max - scene.bbox_min))
    ro = ctr + r.normal(size=(n, 3)).astype(np.float32) * ext
    rd = r.normal(size=(n, 3)).astype(np.float32)
    rd /= np.linalg.norm(rd, axis=-1, keepdims=True)
    v = lambda a: Vec3(*[torch.tensor(a[:, k], device=dev) for k in range(3)])
    cam = Camera.create(eye=(3.0, 2.5, 4.0), target=(0.0, 0.8, 0.0),
                        device=dev)
    pro, prd = cam.primary_rays_v(128, 96)
    swz = lambda a: gbuffer.swizzle_to_tiles(a.reshape(-1), 96, 128)
    return {"random": (v(ro), v(rd), isect.BIG_T),
            "primary": (pro.map(swz), prd.map(swz), isect.BIG_T),
            "ragged": (v(ro[:300]), v(rd[:300]), 3.0)}


@pytest.mark.parametrize("rays", ["random", "primary", "ragged"])
def test_closest_hit_kernel_matches_plain(earth, dev, rays):
    ro, rd, tmax = _ray_sets(earth, dev)[rays]
    raysT, n = ci.pack_raysT(ro, rd, 1e-3, tmax)
    sched, counts, params = ci.cluster_schedule(raysT, earth.cluster_aabb)
    ci.reset_counters()
    tk, ik = ci.closest_hit(raysT, earth.isect_coef, sched, counts, params)
    torch.cuda.synchronize()
    assert ci.counters()["closest_hit"] == 1
    tp, ip = ci.closest_hit_plain(raysT, earth.isect_coef, sched, counts,
                                  params)
    hit = ip >= 0
    assert torch.equal(ik >= 0, hit), "hit/miss flips"
    assert int((ik == ip)[hit].sum()) >= 0.995 * int(hit.sum())
    torch.testing.assert_close(tk[hit], tp[hit], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("rays", ["random", "primary", "ragged"])
def test_occlusion_kernel_matches_plain(earth, dev, rays):
    ro, rd, tmax = _ray_sets(earth, dev)[rays]
    raysT, n = ci.pack_raysT(ro, rd, 1e-3, tmax)
    sched, counts, params = ci.cluster_schedule(raysT, earth.cluster_aabb)
    args = (raysT, earth.isect_coef, earth.isect_aux, sched, counts, params)
    ak = torch.stack(ci.occlusion(*args))
    torch.cuda.synchronize()
    ap = torch.stack(ci.occlusion_plain(*args))
    torch.testing.assert_close(ak, ap, rtol=1e-4, atol=1e-4)


def test_kernel_wrappers_refuse_mixed_devices(earth, dev):
    ro, rd, tmax = _ray_sets(earth, dev)["random"]
    raysT, _ = ci.pack_raysT(ro, rd, 1e-3, tmax)
    sched, counts, params = ci.cluster_schedule(raysT, earth.cluster_aabb)
    with pytest.raises(ValueError, match="coef"):
        ci.closest_hit(raysT, earth.isect_coef.cpu(), sched, counts, params)


def _both(scene, raysT, sched, counts, params):
    """(closest_hit, occlusion) of the scene's route on the card."""
    ch = ci.closest_hit(raysT, scene.isect_coef, sched, counts, params)
    oc = torch.stack(ci.occlusion(raysT, scene.isect_coef, scene.isect_aux,
                                  sched, counts, params))
    torch.cuda.synchronize()
    return ch, oc


def _assert_matches_plain(scene, raysT, sched, counts, params, ch, oc):
    tp, ip = ci.closest_hit_plain(raysT, scene.isect_coef, sched, counts,
                                  params)
    tk, ik = ch
    hit = ip >= 0
    assert torch.equal(ik >= 0, hit), "hit/miss flips"
    assert int((ik == ip)[hit].sum()) >= 0.995 * int(hit.sum())
    torch.testing.assert_close(tk[hit], tp[hit], rtol=1e-5, atol=1e-5)
    op = torch.stack(ci.occlusion_plain(raysT, scene.isect_coef,
                                        scene.isect_aux, sched, counts,
                                        params))
    torch.testing.assert_close(oc, op, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("rays", ["random", "primary", "ragged"])
def test_stream_kernels_match_plain_on_city(city, dev, rays):
    nc, c = city.cluster_aabb.shape[0], city.isect_coef.shape[2] // 4
    assert ci.route(nc, c) == "stream" and ci.pick_members(nc) == 2
    ro, rd, tmax = _ray_sets(city, dev)[rays]
    raysT, n = ci.pack_raysT(ro, rd, 1e-3, tmax)
    sched, counts, params = ci.cluster_schedule(raysT, city.cluster_aabb)
    ci.reset_counters()
    ch, oc = _both(city, raysT, sched, counts, params)
    got = ci.counters()
    assert got["closest_hit_stream"] == 1 and got["occlusion_stream"] == 1
    assert got["closest_hit"] == 0 and got["occlusion"] == 0
    _assert_matches_plain(city, raysT, sched, counts, params, ch, oc)


def test_forced_stream_equals_resident_on_earth(earth, dev, monkeypatch):
    ro, rd, tmax = _ray_sets(earth, dev)["primary"]
    raysT, _ = ci.pack_raysT(ro, rd, 1e-3, tmax)
    sched, counts, params = ci.cluster_schedule(raysT, earth.cluster_aabb)
    (tr, ir), orr = _both(earth, raysT, sched, counts, params)
    monkeypatch.setattr(ci, "_COEF_RESIDENT_BYTES", 0)
    ci.reset_counters()
    (ts, is_), os_ = _both(earth, raysT, sched, counts, params)
    assert ci.counters()["closest_hit_stream"] == 1
    assert torch.equal(ts, tr) and torch.equal(is_, ir)
    assert torch.equal(os_, orr)


def test_forced_supercluster_stream_matches_plain(dev, monkeypatch):
    multi = procedural.multi_object_scene("cpu")
    monkeypatch.setattr(ci, "MAX_SCHED", 4)
    monkeypatch.setattr(ci, "_COEF_RESIDENT_BYTES", 0)
    multi = multi.with_pack().to(dev)       # repack under the new grouping
    assert ci.pick_members(multi.cluster_aabb.shape[0]) == 16
    ro, rd, tmax = _ray_sets(multi, dev)["random"]
    raysT, _ = ci.pack_raysT(ro, rd, 1e-3, tmax)
    sched, counts, params = ci.cluster_schedule(raysT, multi.cluster_aabb)
    ch, oc = _both(multi, raysT, sched, counts, params)
    _assert_matches_plain(multi, raysT, sched, counts, params, ch, oc)


def _stream_earth(monkeypatch, members):
    """Earth's pack on the streaming route, scheduled with `members`
    clusters per entry (44 clusters: no repack needed for 1 or 2)."""
    monkeypatch.setattr(ci, "_COEF_RESIDENT_BYTES", 0)
    monkeypatch.setattr(ci, "MAX_SCHED", 44 // members)
    assert ci.pick_members(44) == members


def _tied_pack(earth):
    """Earth's pack with exact ties everywhere: triangle 2i+1 of each
    cluster is triangle 2i (lanes of different triangle groups), and
    cluster 2e+1 is cluster 2e (the two members of entry e at M = 2;
    at M = 1 two entries with one key, the lower id first). Returns
    (coef, aux, aabb, rec)."""
    coef, aux, aabb = (earth.isect_coef.clone(), earth.isect_aux.clone(),
                       earth.cluster_aabb.clone())
    nc, c = coef.shape[0], coef.shape[2] // 4
    lanes = coef.view(nc, 16, 4, c)
    lanes[..., 1::2] = lanes[..., 0::2]
    for a in (coef, aux, aabb):
        a[1::2] = a[0::2]
    return coef, aux, aabb, ci.triangle_records(coef)


def _assert_ties_give_plain_ids(earth, dev, counter):
    """On the tied pack the kernel `counter` keeps the plain version's
    ids: the earliest member or entry, then the lowest lane."""
    coef, aux, aabb, rec = _tied_pack(earth)
    c = coef.shape[2] // 4
    hits = 0
    for rays in ("random", "primary", "ragged"):
        ro, rd, tmax = _ray_sets(earth, dev)[rays]
        raysT, _ = ci.pack_raysT(ro, rd, 1e-3, tmax)
        sched, counts, params = ci.cluster_schedule(raysT, aabb)
        ci.reset_counters()
        tk, ik = ci.closest_hit(raysT, coef, sched, counts, params, rec=rec)
        torch.cuda.synchronize()
        assert ci.counters()[counter] == 1
        tp, ip = ci.closest_hit_plain(raysT, coef, sched, counts, params)
        hit = ip >= 0
        hits += int(hit.sum())
        assert torch.equal(ik, ip), rays
        assert torch.equal(tk[hit], tp[hit]), rays
        assert bool((ip[hit] % 2 == 0).all())
        assert bool(((ip[hit] // c) % 2 == 0).all())
    assert hits > 0


def test_stream_ties_give_plain_ids(earth, dev, monkeypatch):
    """Exact ties at M = 2 on the streaming route (`_tied_pack`)."""
    _stream_earth(monkeypatch, 2)
    _assert_ties_give_plain_ids(earth, dev, "closest_hit_stream")


def test_resident_ties_give_plain_ids(earth, dev):
    """Exact ties at M = 1 on the resident route (`_tied_pack`): the
    persistent kernel merges each entry's lanes exactly and keeps the
    earlier of two entries with one key."""
    assert ci.route(44, 128) == "resident"
    _assert_ties_give_plain_ids(earth, dev, "closest_hit")


@pytest.mark.parametrize("rays", ["random", "primary", "ragged"])
def test_resident_grid_and_order_do_not_change_results(earth, dev, rays):
    """The persistent resident kernels on as many CTAs as fit, on 1 and
    on 3, taking the ray blocks longest first and in ascending order: the
    same (t, idx), attenuation and work counts bit for bit (one CTA
    computes each block whole), equal to the plain version."""
    ro, rd, tmax = _ray_sets(earth, dev)[rays]
    raysT, _ = ci.pack_raysT(ro, rd, 1e-3, tmax)
    sched, counts, params = ci.cluster_schedule(raysT, earth.cluster_aabb)
    nb = raysT.shape[0]
    for kind in ("closest_hit", "occlusion"):
        assert 1 <= ci.resident_ctas(kind, nb, 128) <= nb
    out = []
    for ctas, order in [(n, o) for n in (0, 1, 3)
                        for o in ("longest", "ascending")]:
        work = [torch.zeros_like(counts) for _ in range(4)]
        with ci.forced_grid(ctas, order):
            ch = ci.closest_hit(raysT, earth.isect_coef, sched, counts,
                                params, work[0], rec=earth.isect_rec,
                                ray_visited=work[1])
            oc = torch.stack(ci.occlusion(
                raysT, earth.isect_coef, earth.isect_aux, sched, counts,
                params, work[2], rec=earth.isect_rec,
                tflags=earth.isect_tflags, ray_visited=work[3]))
        out.append((ch, oc, work))
    torch.cuda.synchronize()
    c0, o0, w0 = out[0]
    for c1, o1, w1 in out[1:]:
        assert torch.equal(c0[0], c1[0]) and torch.equal(c0[1], c1[1])
        assert torch.equal(o0, o1)
        assert all(torch.equal(a, b) for a, b in zip(w0, w1))
    _assert_matches_plain(earth, raysT, sched, counts, params, c0, o0)
    # each warp computes a prefix of its block's walk
    for visited, rv in ((w0[0], w0[1]), (w0[2], w0[3])):
        assert bool((visited <= counts).all())
        assert bool((rv <= 256 * visited).all())
        assert bool((rv >= 32 * visited).all())


def test_resident_bounds_of_an_earlier_block_end_nothing(earth, dev):
    """The producer of a persistent CTA stages the next ray block's
    entries while the warps still publish bounds for the current one; a
    bound published for an earlier block must not end the next block's
    walk. One CTA takes blocks that alternate near and far: rays straight down
    onto the sphere (radius 0.8 at (0, 1, 0)) from 0.2 above its top,
    every best hit within ~0.2, then from 8.2 above it, every hit beyond
    8, so a near block's bound lies below every far-block entry. Every
    ray hits, with the plain version's ids."""
    nb = 6
    r = np.random.default_rng(13)
    jit = r.uniform(-0.2, 0.2, size=(nb * 256, 3))
    y = np.where(np.arange(nb * 256) // 256 % 2 == 0, 2.0, 10.0)
    ro = np.stack([jit[:, 0], y, jit[:, 2]], 1)
    rd = np.tile([0.0, -1.0, 0.0], (nb * 256, 1))
    v = lambda a: Vec3(*[torch.tensor(a[:, k], dtype=torch.float32,
                                      device=dev) for k in range(3)])
    raysT, _ = ci.pack_raysT(v(ro), v(rd), 1e-3, isect.BIG_T)
    sched, counts, params = ci.cluster_schedule(raysT, earth.cluster_aabb)
    tp, ip = ci.closest_hit_plain(raysT, earth.isect_coef, sched, counts,
                                  params)
    assert bool((ip >= 0).all())
    for order in ("ascending", "longest"):
        visited = torch.zeros_like(counts)
        with ci.forced_grid(1, order):
            tk, ik = ci.closest_hit(raysT, earth.isect_coef, sched, counts,
                                    params, visited, rec=earth.isect_rec)
        torch.cuda.synchronize()
        assert torch.equal(ik, ip), order
        torch.testing.assert_close(tk, tp, rtol=1e-5, atol=1e-5)
        assert bool((visited[1::2] > 0).all())


def _warp_mix_rays(dev):
    """(raysT, warp) of 8 ray blocks whose warps differ, by warp w of
    each block: w % 4 == 0 rays fall on the opaque sphere (fully
    occluded), 1 the same with a t_max short of it, 2 end inside the
    refractive box, having crossed its top only (one Fresnel factor), 3
    seeded random directions."""
    n = 8 * 256
    r = np.random.default_rng(11)
    warp = (np.arange(n) % 256) // 32
    jit = r.uniform(-0.05, 0.05, size=(n, 3))
    jit[:, 1] = 0.0
    # down onto the sphere (radius 0.8 at (0, 1, 0)): its top 8.2 away
    down = np.array([0.0, -1.0, 0.0])
    ro = np.array([0.0, 10.0, 0.0]) + 4.0 * jit
    rd = np.tile(down, (n, 1))
    # slanted into the box (half-size 0.4 at (-2, 0.4, 1.2)): through its
    # top ~8.55 along, at its centre 9 along
    slant = np.array([0.5, -1.0, 0.0]) / np.sqrt(1.25)
    box = np.array([-2.0, 0.4, 1.2]) + jit - 9.0 * slant
    ro = np.where((warp % 4 == 2)[:, None], box, ro)
    rd = np.where((warp % 4 == 2)[:, None], slant, rd)
    rnd = r.normal(size=(n, 3))
    rnd /= np.linalg.norm(rnd, axis=-1, keepdims=True)
    rd = np.where((warp % 4 == 3)[:, None], rnd, rd)
    tmax = np.select([warp % 4 == 1, warp % 4 == 2], [1.0, 9.0], 1e30)
    v = lambda a: Vec3(*[torch.tensor(a[:, k], dtype=torch.float32,
                                      device=dev) for k in range(3)])
    raysT, _ = ci.pack_raysT(v(ro), v(rd), 1e-3,
                             torch.tensor(tmax, dtype=torch.float32,
                                          device=dev))
    return raysT, warp


def _assert_warp_mix(want, warp, visited, rv, dev):
    """The warp mix's attenuation by warp, and the work counts: every
    ray at most its block's tested members, the warp that tested them
    all at least 32 rays' worth, together fewer than all 256 rays'."""
    sel = lambda q: torch.tensor(warp % 4 == q, device=dev)
    flat = want.reshape(3, -1)
    assert bool((flat[:, sel(0)] == 0).all())
    assert bool((flat[:, sel(1)] == 1).all())
    part = flat[:, sel(2)]
    assert bool(((part > 0) & (part < 1)).all())
    assert bool((rv <= 256 * visited).all())
    assert bool((rv >= 32 * visited).all())
    assert int(rv.sum()) < 256 * int(visited.sum())


@pytest.mark.parametrize("members", [1, 2])
def test_stream_occlusion_warps_exit_alone(earth, dev, members, monkeypatch):
    """The warp mix (`_warp_mix_rays`) on the streaming route: equal to
    the plain version, and to the resident kernel within 1e-6."""
    raysT, warp = _warp_mix_rays(dev)
    sched, counts, params = ci.cluster_schedule(raysT, earth.cluster_aabb)
    args = (raysT, earth.isect_coef, earth.isect_aux, sched, counts, params)
    kw = dict(rec=earth.isect_rec, tflags=earth.isect_tflags)
    resident = torch.stack(ci.occlusion(*args, **kw))
    _stream_earth(monkeypatch, members)
    sched, counts, params = ci.cluster_schedule(raysT, earth.cluster_aabb)
    args = args[:3] + (sched, counts, params)
    visited = torch.zeros_like(counts)
    rv = torch.zeros_like(counts)
    got = torch.stack(ci.occlusion(*args, visited=visited, ray_visited=rv,
                                   **kw))
    torch.cuda.synchronize()
    want = torch.stack(ci.occlusion_plain(*args))
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    assert float((got - resident).abs().max()) <= 1e-6
    _assert_warp_mix(want, warp, visited, rv, dev)


def test_resident_occlusion_warps_exit_alone(earth, dev):
    """The warp mix on the resident route, transparent members included:
    equal to the plain version, each warp stopping on its own, on one
    CTA as on the full grid."""
    raysT, warp = _warp_mix_rays(dev)
    sched, counts, params = ci.cluster_schedule(raysT, earth.cluster_aabb)
    args = (raysT, earth.isect_coef, earth.isect_aux, sched, counts, params)
    kw = dict(rec=earth.isect_rec, tflags=earth.isect_tflags)
    assert int(earth.isect_tflags.sum()) > 0
    want = torch.stack(ci.occlusion_plain(*args))
    got = []
    for ctas in (0, 1):
        visited = torch.zeros_like(counts)
        rv = torch.zeros_like(counts)
        ci.reset_counters()
        with ci.forced_grid(ctas):
            got.append(torch.stack(ci.occlusion(
                *args, visited=visited, ray_visited=rv, **kw)))
        torch.cuda.synchronize()
        assert ci.counters()["occlusion"] == 1
        torch.testing.assert_close(got[-1], want, rtol=1e-4, atol=1e-4)
        _assert_warp_mix(want, warp, visited, rv, dev)
    assert torch.equal(got[0], got[1])


def test_stream_wrappers_refuse_mixed_devices(city, dev):
    ro, rd, tmax = _ray_sets(city, dev)["random"]
    raysT, _ = ci.pack_raysT(ro, rd, 1e-3, tmax)
    sched, counts, params = ci.cluster_schedule(raysT, city.cluster_aabb)
    with pytest.raises(ValueError, match="aux"):
        ci.occlusion(raysT, city.isect_coef, city.isect_aux.cpu(), sched,
                     counts, params)
    with pytest.raises(ValueError, match="visited"):
        ci.closest_hit(raysT, city.isect_coef, sched, counts, params,
                       visited=counts.cpu())
    with pytest.raises(ValueError, match="rec"):
        ci.closest_hit(raysT, city.isect_coef, sched, counts, params,
                       rec=city.isect_rec.cpu())


@pytest.mark.parametrize("rays", ["random", "primary", "ragged"])
def test_stream_split_blocks_agree_on_city(city, dev, rays):
    """The ray blocks split as routed (more than STREAM_HEAVY live
    entries), none split with or without the idle split CTAs in the
    grid, and every block split over eight CTAs of 32 rays: the same ids
    and t, occlusion within 1e-6, all equal to the plain version."""
    ro, rd, tmax = _ray_sets(city, dev)[rays]
    raysT, _ = ci.pack_raysT(ro, rd, 1e-3, tmax)
    sched, counts, params = ci.cluster_schedule(raysT, city.cluster_aabb)
    out = []
    for mode in (None, "none", "idle", "all"):
        with ci.forced_split(mode) if mode else contextlib.nullcontext():
            out.append((ci.closest_hit(raysT, city.isect_coef, sched, counts,
                                       params, rec=city.isect_rec),
                        torch.stack(ci.occlusion(
                            raysT, city.isect_coef, city.isect_aux, sched,
                            counts, params, rec=city.isect_rec,
                            tflags=city.isect_tflags))))
    torch.cuda.synchronize()
    c0, o0 = out[0]
    for c1, o1 in out[1:]:
        assert torch.equal(c0[0], c1[0]) and torch.equal(c0[1], c1[1])
        assert float((o0 - o1).abs().max()) <= 1e-6
        _assert_matches_plain(city, raysT, sched, counts, params, c1, o1)


@pytest.fixture(scope="module")
def micro(earth):
    return mb.build_inputs(earth, 128, 128)     # 64 ray blocks


def _micro_agrees(variant, got, want):
    if variant in ("loop", "slab"):
        assert torch.equal(got, want)
    elif variant == "full":
        # the closest-hit gate: t within rtol 1e-3 / atol 1e-4, at most
        # 0.5% hit/miss flips
        hk, hp = got < 1e30, want < 1e30
        assert int((hk != hp).sum()) <= 0.005 * got.numel()
        both = hk & hp
        torch.testing.assert_close(got[both], want[both], rtol=1e-3,
                                   atol=1e-4)
    else:
        # float32 sums of 10 (kernel) and 16 (plain) terms in another
        # order; mm_bf16 on the tensor cores
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("variant", MICRO_VARIANTS)
def test_micro_kernel_matches_plain(micro, variant):
    args = micro.args(variant)
    kernels.CALLS.clear()
    got = mb.run_variant(variant, *args)
    torch.cuda.synchronize()
    assert kernels.CALLS[f"micro_{variant}"] == 1
    _micro_agrees(variant, got, mb.plain(variant, *args))


@pytest.mark.parametrize("order", ["longest", "ascending"])
@pytest.mark.parametrize("ctas", [1, 2, "all"])
@pytest.mark.parametrize("variant", MICRO_VARIANTS)
def test_micro_kernel_on_forced_grids(micro, variant, ctas, order):
    """Each ray block is computed whole by one CTA, so no grid or order
    changes a bit of the result."""
    args = micro.args(variant)
    default = mb.run_variant(variant, *args)
    n = mb.grid(variant, micro.nb, micro.c) if ctas == "all" else ctas
    with forced_grid(n, order):
        got = mb.run_variant(variant, *args)
    torch.cuda.synchronize()
    assert torch.equal(got, default)
    _micro_agrees(variant, got, mb.plain(variant, *args))


def test_smem_dma_kernel_matches_plain(dev):
    for shape in (dict(), dict(nb=64, nsc=666, sw=768, seed=3)):
        arrays = dma.make_inputs(**shape)
        args = [torch.from_numpy(a).to(dev) for a in arrays]
        kernels.CALLS.clear()
        got = dma.smem_dma(*args)
        torch.cuda.synchronize()
        assert kernels.CALLS["smem_dma"] == 1
        assert torch.equal(got, dma.plain(*args))
        np.testing.assert_array_equal(got.cpu().numpy(),
                                      dma.numpy_reference(*arrays))


@pytest.mark.parametrize("order", ["longest", "ascending"])
@pytest.mark.parametrize("ctas", [0, 1, 2, 5])
# the 64-lane table slice in shared memory (the script's and the city's
# NSC, and the largest that fits), and tables too large for it (read from
# global memory)
@pytest.mark.parametrize("nsc", [64, 666, 700, 701, 2048])
def test_smem_dma_kernel_paths_and_grids(dev, nsc, ctas, order):
    sw = (nsc + 3) // 4 * 4 + 64
    counts, sched, rays, table = dma.make_inputs(nb=40, nsc=nsc, sw=sw,
                                                 seed=nsc)
    counts[0] = sw          # a row live to its end
    counts[1] = 0           # an empty row
    counts[2:6] = np.minimum((63, 64, 65, 129), sw)     # chunk edges
    args = [torch.from_numpy(a).to(dev) for a in (counts, sched, rays,
                                                  table)]
    from fovtrace_torch.scripts import load_probe_library
    assert load_probe_library().fov_smem_dma_lanes(nsc) == \
        dma.lane_slice(nsc)
    with forced_grid(ctas, order):
        got = dma.smem_dma(*args)
    torch.cuda.synchronize()
    assert torch.equal(got, dma.plain(*args))
    np.testing.assert_array_equal(
        got.cpu().numpy(), dma.numpy_reference(counts, sched, rays, table))


def test_smem_dma_tables_shrinking_then_growing(dev):
    """A kernel function has one shared-memory limit: a launch on a
    smaller table (NSC 100) between two on the city's (NSC 666, 219 KB)
    must not leave it too low for the second."""
    for nsc in (666, 100, 666):
        arrays = dma.make_inputs(nb=32, nsc=nsc, sw=(nsc + 3) // 4 * 4,
                                 seed=nsc)
        args = [torch.from_numpy(a).to(dev) for a in arrays]
        got = dma.smem_dma(*args)
        torch.cuda.synchronize()
        assert torch.equal(got, dma.plain(*args)), nsc


def test_micro_widths_shrinking_then_growing(dev):
    """The same for micro_kernel<V>, whose ring grows with c: c 128, then
    16, then 128 again."""
    for c in (128, 16, 128):
        nb, nc = 4, 3
        g = torch.Generator().manual_seed(c)
        rays = torch.randn(nb * 256, 16, generator=g).to(dev)
        counts = torch.tensor([3, 1, 0, 2], dtype=torch.int32, device=dev)
        sched = torch.arange(nb * nc, dtype=torch.int32).remainder(nc) \
            .to(dev)
        lo = torch.randn(nc, 3, generator=g)
        cb = torch.cat([lo, lo + 1, torch.zeros(nc, 2)], 1).reshape(-1) \
            .to(dev)
        coef = torch.randn(nc, 16, 4 * c, generator=g)
        coef[:, 10:] = 0.0      # as in the pack: the kernel reads rows 0-9
        coef = coef.to(dev)
        got = mb.run_variant("mm_lead", rays, sched, counts, cb, coef)
        torch.cuda.synchronize()
        _micro_agrees("mm_lead", got,
                      mb.plain("mm_lead", rays, sched, counts, cb, coef))


def test_smem_dma_layout_matches_the_mirror(dev):
    """The library's layout is what probe_smem_dma's copies of it (which
    `lane_slice` and its CPU test use) say."""
    assert dma.layout() == dict(warps=dma.WARPS, ch=dma.CH, ring=dma.RING,
                                lanes=dma.LANES, smem=dma.SMEM)
    for nsc in (1, 64, 666, 700, 701, 2048):
        assert dma.table_lanes(nsc) == dma.lane_slice(nsc)


# ----------------------------------------------------- the material table
MATERIAL_N = 4096
BENCH_FRONT = 1920 * 1088     # the G-buffer's rays at 1920x1088
# (rays, materials, how the ids are drawn): the CPU tests' shapes
# (tests/test_torch_material.py) and the bench frame's front
MATERIAL_CASES = {"select-chain": (MATERIAL_N, 4, "uniform"),
                  "row-gather": (MATERIAL_N, 24, "uniform"),
                  "one-material": (MATERIAL_N, 4, "one"),
                  "misses": (MATERIAL_N, 4, "misses"),
                  "bench-front": (BENCH_FRONT, 4, "misses")}


def _material_inputs(dev, n, m, how, k, seed=0):
    """(ids [n] int32, table [m, k], cotangent [k, n]) on the card from a
    numpy seed; misses are clamped to row 0, as the render path does."""
    r = np.random.default_rng(seed)
    mat_id = r.integers(0, m, size=n).astype(np.int32)
    if how == "one":
        mat_id[:] = m - 2
    elif how == "misses":
        mat_id[r.random(n) < 0.7] = -1
    ids = torch.tensor(np.maximum(mat_id, 0), dtype=torch.int32, device=dev)
    table = torch.tensor(r.normal(size=(m, k)).astype(np.float32), device=dev)
    g = torch.tensor(r.normal(size=(k, n)).astype(np.float32), device=dev)
    return ids, table, g


def _material_scale(ids, g, m):
    """[m, k]: sum |g| of each entry's lanes, the adjoint's tolerance."""
    return material.adjoint_plain(ids, g.abs(), m)


@pytest.mark.parametrize("k", [4, 21])
@pytest.mark.parametrize("case", list(MATERIAL_CASES))
def test_material_kernels_match_plain(dev, case, k):
    """The gather bit for bit the plain version's; the adjoint within
    1e-5 x sum |g| of each entry's lanes, and equal bits on a second
    run."""
    n, m, how = MATERIAL_CASES[case]
    ids, table, g = _material_inputs(dev, n, m, how, k)
    kernels.CALLS.clear()
    got = material.gather(ids, table)
    adj = [material.adjoint(ids, g, m) for _ in range(2)]
    torch.cuda.synchronize()
    assert material.counters() == {"material_gather": 1,
                                   "material_adjoint": 2,
                                   "material_gather_plain": 0,
                                   "material_adjoint_plain": 0}
    assert torch.equal(got, material.gather_plain(ids, table))
    want = material.adjoint_plain(ids, g, m)
    assert bool(((adj[0] - want).abs()
                 <= 1e-5 * _material_scale(ids, g, m)).all()), case
    assert torch.equal(adj[0], adj[1])


@pytest.mark.parametrize("k", [4, 21])
def test_material_largest_table(dev, k):
    """The largest table the kernels take, M x K = MAX_TABLE, against
    the plain versions; one row more is refused, naming the limit."""
    m = material.MAX_TABLE // k
    ids, table, g = _material_inputs(dev, 20000, m, "uniform", k, seed=1)
    assert torch.equal(material.gather(ids, table),
                       material.gather_plain(ids, table))
    want = material.adjoint_plain(ids, g, m)
    assert bool(((material.adjoint(ids, g, m) - want).abs()
                 <= 1e-5 * _material_scale(ids, g, m)).all())
    big = torch.zeros((m + 1, k), device=dev)
    with pytest.raises(ValueError, match="MAX_TABLE"):
        material.gather(ids, big)
    with pytest.raises(ValueError, match="MAX_TABLE"):
        material.adjoint(ids, g, m + 1)


def test_material_function_on_the_card(dev):
    """MaterialLookup's forward and backward launch the kernels and give
    the plain versions' values; a CPU table with CUDA ids is refused."""
    ids, table, g = _material_inputs(dev, 70001, 5, "misses", 4, seed=2)
    leaf = table.clone().requires_grad_(True)
    kernels.CALLS.clear()
    out = material.MaterialLookup.apply(ids, leaf)
    out.backward(g)
    torch.cuda.synchronize()
    assert material.counters()["material_gather"] == 1
    assert material.counters()["material_adjoint"] == 1
    assert torch.equal(out.detach(), material.gather_plain(ids, table))
    want = material.adjoint_plain(ids, g, 5)
    assert bool(((leaf.grad - want).abs()
                 <= 1e-5 * _material_scale(ids, g, 5)).all())
    with pytest.raises(ValueError):
        material.gather(ids, table.cpu())


# ------------------------------------------------------- the envmap lookup
# chip_smoke.py's [envmap] harness: its case table (the CPU tests' maps
# with their directions, seeded 1920x1088 worst cases, an 800x1600 map),
# its seeded inputs and its checks


@pytest.mark.parametrize("case", list(chip_smoke.ENVMAP_CASES))
def test_envmap_kernels_match_plain(dev, case):
    """The lookup and d(fx, fy) equal the plain versions bit for bit; the
    map's adjoint is within 1e-5 x sum |g w| of each entry's terms, with
    the same bits on a second run."""
    from fovtrace_torch.kernels import envmap

    kernels.CALLS.clear()
    chip_smoke.check_envmap(case, *chip_smoke.envmap_inputs(case), 2.0)
    counts = envmap.counters()
    assert (counts["envmap_lookup"], counts["envmap_dxy"],
            counts["envmap_adjoint"]) == (1, 1, 2), counts


def test_envmap_nonfinite_cotangent(dev):
    """inf and NaN cotangents give the plain version's inf, -inf and NaN
    entries."""
    from fovtrace_torch.kernels import envmap

    fx, fy, env, g = chip_smoke.envmap_inputs("uniform", seed=3)
    n = fx.shape[0]
    fx[: n // 2] = 10.5      # a shared texel, then each sign and both
    fy[: n // 2] = 5.5
    g[0, 0], g[1, 1], g[1, 2], g[2, 3] = np.inf, np.inf, -np.inf, np.nan
    g[0, n - 1] = -np.inf
    h, w = env.shape[:2]
    got = envmap.adjoint(fx, fy, g, h, w, 2.0)
    nonfinite_same, _, over, nonfinite = chip_smoke.envmap_adjoint_error(
        got, fx, fy, g, h, w, 2.0)
    assert nonfinite > 0
    assert nonfinite_same and over <= 1.0, over


def test_envmap_function_on_the_card(dev):
    """EnvmapLookup's forward and backward launch the kernels and give
    the plain versions' values; without the map's gradient no adjoint
    runs; a CPU map with CUDA coordinates is refused."""
    from fovtrace_torch.kernels import envmap

    same = chip_smoke.same_values
    fx, fy, env, g = chip_smoke.envmap_inputs("misses", seed=2)
    h, w = env.shape[:2]
    leaves = [t.clone().requires_grad_(True) for t in (fx, fy, env)]
    kernels.CALLS.clear()
    out = envmap.EnvmapLookup.apply(*leaves, 2.0)
    out.backward(g)
    torch.cuda.synchronize()
    assert {k: v for k, v in envmap.counters().items() if v} == {
        "envmap_lookup": 1, "envmap_dxy": 1, "envmap_adjoint": 1}
    assert same(out.detach(), envmap.lookup_plain(fx, fy, env, 2.0))
    want_x, want_y = envmap.dxy_plain(fx, fy, env, g, 2.0)
    assert same(leaves[0].grad, want_x) and same(leaves[1].grad, want_y)
    nonfinite_same, _, over, _ = chip_smoke.envmap_adjoint_error(
        leaves[2].grad, fx, fy, g, h, w, 2.0)
    assert nonfinite_same and over <= 1.0, over
    kernels.CALLS.clear()
    xy = [t.clone().requires_grad_(True) for t in (fx, fy)]
    envmap.EnvmapLookup.apply(*xy, env, 2.0).backward(g)
    assert envmap.counters()["envmap_adjoint"] == 0
    assert envmap.counters()["envmap_dxy"] == 1
    with pytest.raises(ValueError):
        envmap.lookup(fx, fy, env.cpu(), 2.0)


def test_envmap_adjoint_route_on_the_card(dev):
    """The adjoint's route on the card (the C entry point's choice) is the
    wrapper's `adjoint_route` at the card's opt-in shared memory, for
    each map checked; on the H100 the one ENVMAP_ROUTES names."""
    chip_smoke.check_routes()


@pytest.mark.parametrize("case", chip_smoke.ROUTE_CASES)
def test_envmap_adjoint_routes_agree(dev, case):
    """Where a block holds the map, the shared and the global route give
    the same bits, on two runs each."""
    chip_smoke.same_on_both_routes(case, 2.0)


def test_envmap_shared_route_refused(dev):
    """The shared route forced on a map no block holds raises, and falls
    back to nothing: no launch is counted and no plain version runs."""
    chip_smoke.shared_route_refused(2.0)
