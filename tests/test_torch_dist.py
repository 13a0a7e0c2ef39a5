"""The port's row-sharded frame (fovtrace_torch.dist) on gloo ranks on
the CPU, against its own single-process frame and against the JAX
package's `render_sharded` on the virtual CPU devices of conftest.py:
tests/test_dist.py's configuration (multi, 64x64, budget fraction 1.0,
budget factor 8), two frames with the camera moved; the sharded filters
on tests/test_dist.py's seeded fields; the row-block functions the
sharded frame is built from; and the launch's resolution of its
settings."""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import torch_dist_ranks as tdr  # noqa: E402
from fovtrace import Camera as JCamera  # noqa: E402
from fovtrace import RenderConfig as JRenderConfig  # noqa: E402
from fovtrace.dist import sharding as jshd  # noqa: E402
from fovtrace.scene import procedural as jprocedural  # noqa: E402
from fovtrace_torch import Camera, RenderConfig  # noqa: E402
from fovtrace_torch.core import vec  # noqa: E402
from fovtrace_torch.dist import launch  # noqa: E402
from fovtrace_torch.dist import sharding as shd  # noqa: E402
from fovtrace_torch.kernels import (atrous, jfa, pullpush, saliency,  # noqa: E402
                                    sampling, sibson)
from fovtrace_torch.render import gbuffer, pipeline  # noqa: E402
from fovtrace_torch.scene import procedural  # noqa: E402

GAZE = (30, 33)
RANKS = 4
# tests/test_dist.py's tolerance (sharded against single frame)
RTOL, ATOL = 2e-4, 2e-5


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    # the suite runs in several worker processes at once; PyTorch's
    # default of one thread per core then oversubscribes the CPU
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def multi_cpu():
    return procedural.multi_object_scene("cpu")


def _cams(device="cpu"):
    cam = Camera.create(eye=tdr.FRAME_EYE, target=tdr.FRAME_TARGET,
                        device=device)
    return [cam, cam.replace(eye=torch.tensor(tdr.FRAME_EYE2))]


# every multi-rank case of this module, in one launch of 4 rank processes
RANK_CASES = {
    "atrous": ["frame", dict(gaze=list(GAZE), recon="atrous")],
    "none": ["frame", dict(gaze=list(GAZE), recon="none")],
    "logpolar": ["frame", dict(gaze=list(GAZE), recon="none", frames=1,
                               sampling_mode="logpolar")],
    # full sampling on 4 tiles of 32 x 64 = 2,048 pixels, 1,024 slots each
    "starved": ["frame", dict(gaze=[32, 32], frames=1, recon="none",
                              size=128, width=64, frac=0.05,
                              sharded_budget_factor=1.0,
                              sampling_mode="full", max_depth=1)],
    "filters": ["filters", dict(pp_shape=[128, 64], at_shape=[32, 48],
                                iterations=[1, 2, 4])],
}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    res = tdr.run_ranks("several", RANKS, tmp_path_factory.mktemp("ranks"),
                        cases=RANK_CASES)

    def get(label):
        n = len(label) + 1
        return {k[n:]: v for k, v in res.items() if k.startswith(label + "/")}
    return get


def _single_frames(scene, config, frames=2):
    st = pipeline.FrameState.initial(_cams()[0], config)
    outs = []
    for c in _cams()[:frames]:
        out, st = pipeline.render_frame(scene, c, GAZE, st, config)
        outs.append((out, st))
    return outs


def _jax_sharded(recon, frames=2):
    """The reference's sharded frames on make_mesh(4)."""
    config = JRenderConfig(width=64, height=64, reconstruction=recon,
                           max_depth=3, diffuse_max_depth=1,
                           ray_budget_frac=1.0, sharded_budget_factor=8.0)
    scene = jprocedural.multi_object_scene()
    cam = JCamera.create(eye=tdr.FRAME_EYE, target=tdr.FRAME_TARGET)
    mesh = jshd.make_mesh(RANKS)
    state = jshd.initial_state_sharded(cam, config, mesh)
    render = jax.jit(lambda s, c, g, st: jshd.render_sharded(
        s, c, g, st, config, mesh))
    outs = []
    for c in (cam, cam.replace(eye=jnp.asarray(tdr.FRAME_EYE2)))[:frames]:
        out, state = render(scene, c, jnp.asarray(GAZE), state)
        outs.append({k: np.asarray(out[k]) for k in
                     ("image", "mask", "ray_count", "rays_dropped",
                      "rays_traced")})
    return outs


@pytest.mark.parametrize("recon", ["atrous", "none"])
def test_sharded_matches_single_frame(recon, ranks, multi_cpu):
    """4 ranks equal the port's single-process frame: the mask bit for
    bit, no ray dropped, the rest at tests/test_dist.py's tolerance,
    history included (frame 2 reprojects frame 1's)."""
    res = ranks(recon)
    for f, (out, st) in enumerate(_single_frames(multi_cpu,
                                                 tdr.frame_config(recon))):
        assert torch.equal(res[f"mask{f}"], out["mask"])
        assert int(res[f"rays_dropped{f}"]) == 0
        assert int(res[f"ray_count{f}"]) == int(out["ray_count"])
        for k in ("shading", "image", "gaze_target"):
            torch.testing.assert_close(res[f"{k}{f}"], out[k], rtol=RTOL,
                                       atol=ATOL)
        torch.testing.assert_close(res[f"history{f}"], st.history,
                                   rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("recon", ["atrous", "none"])
def test_sharded_matches_jax_render_sharded(recon, ranks):
    """4 ranks against the reference's render_sharded on 4 devices: the
    mask and the counters equal (rays_traced counts the per-tile budgets'
    slots, so it is held to the sharded reference, not to a single
    frame), the image within tests/test_torch_frame.py's tolerance."""
    res = ranks(recon)
    for f, want in enumerate(_jax_sharded(recon)):
        np.testing.assert_array_equal(res[f"mask{f}"].numpy(), want["mask"])
        for k in ("ray_count", "rays_dropped", "rays_traced"):
            assert int(res[f"{k}{f}"]) == int(want[k]), k
        err = np.abs(res[f"image{f}"].numpy() - want["image"])
        assert err.mean() < 5e-3 and int((err.max(-1) >= 0.1).sum()) == 0, \
            (err.mean(), err.max())


def test_sharded_logpolar_mask_matches(ranks, multi_cpu):
    """Each tile evaluates its rows of the one global log-polar pattern."""
    res = ranks("logpolar")
    config = tdr.frame_config("none", sampling_mode="logpolar")
    out, _ = _single_frames(multi_cpu, config, frames=1)[0]
    assert torch.equal(res["mask0"], out["mask"])
    assert int(res["rays_dropped0"]) == 0
    torch.testing.assert_close(res["shading0"], out["shading"], rtol=RTOL,
                               atol=ATOL)


def test_tile_budget_drops_accounting(ranks):
    """A starved per-tile budget reports the rays it drops: full sampling
    at 128x64 on 4 tiles of 2,048 pixels, 1,024 slots each."""
    res = ranks("starved")
    config = tdr.frame_config("none", size=128, width=64, frac=0.05,
                              sharded_budget_factor=1.0)
    budget = shd.tile_budget(config, RANKS, 128 // RANKS)
    assert budget == 1024
    assert int(res["ray_count0"]) == 128 * 64
    assert int(res["rays_dropped0"]) == 128 * 64 - RANKS * budget > 0


def test_one_rank_equals_render_frame(multi_cpu):
    """A single process (no process group) renders the sharded frame
    bit for bit as render_frame does."""
    config = tdr.frame_config("atrous")
    mesh = shd.make_mesh(device="cpu")
    assert (mesh.rank, mesh.size, mesh.group) == (0, 1, None)
    st = shd.initial_state_sharded(_cams()[0], config, mesh)
    for c, (want, want_st) in zip(_cams(), _single_frames(multi_cpu,
                                                          config)):
        out, st = shd.render_sharded(multi_cpu, c, GAZE, st, config, mesh)
        for k in ("mask", "image", "shading", "saliency", "traced"):
            assert torch.equal(out[k], want[k]), k
        assert torch.equal(st.history, want_st.history)
        for k in ("ray_count", "rays_dropped", "rays_traced"):
            assert int(out[k]) == int(want[k]), k


def test_tile_height_must_be_a_multiple_of_8():
    config = RenderConfig(width=64, height=36)
    with pytest.raises(AssertionError, match="multiple of 8"):
        shd.initial_state_sharded(_cams()[0], config,
                                  shd.make_mesh(device="cpu"))


# ------------------------------------------------------ the sharded filters
def test_sharded_pullpush_matches_jax(ranks):
    """Halo pull-push on 4 tiles against the reference's single-frame
    pull_push (rtol 1e-5, atol 1e-6, as tests/test_dist.py)."""
    from fovtrace.kernels import pullpush as jpullpush

    want = np.asarray(jpullpush.pull_push(jnp.asarray(
        tdr.sparse_field(3, 128, 64))))
    np.testing.assert_allclose(ranks("filters")["pullpush"].numpy(), want,
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("iters", [1, 2, 4])
def test_sharded_atrous_matches_jax(iters, ranks):
    """Halo A-Trous on 4 tiles of 8 rows (tests/test_dist.py's tile
    height) against the reference's single-frame filter; the fourth
    iteration's 16-row halo outgrows the tile, and the tiles gather."""
    from fovtrace.kernels import atrous as jatrous

    f = tdr.atrous_fields(5, 32, 48)
    want = np.asarray(jatrous.atrous_denoise(
        jnp.asarray(f["color"]), jnp.asarray(f["pos"]), jnp.asarray(f["nrm"]),
        iters, 1.0, 0.5, 0.5))
    np.testing.assert_allclose(ranks("filters")[f"atrous{iters}"].numpy(),
                               want, rtol=1e-5, atol=1e-6)


def test_sharded_jfa_and_sibson_equal_single_frame(ranks):
    """Gathered JFA and Sibson equal the single-frame kernels."""
    sp = torch.as_tensor(tdr.sparse_field(3, 128, 64))
    coord, color = jfa.jump_flood(sp)
    res = ranks("filters")
    assert torch.equal(res["jfa_coord"], coord)
    assert torch.equal(res["jfa_color"], color)
    assert torch.equal(res["sibson"],
                       sibson.sibson_interpolate(coord, color, 4))


def test_pullpush_and_atrous_single_process_identity():
    """With no process group the sharded filters are the single-frame
    ones (zero halos are the screen's edges)."""
    from fovtrace_torch.dist import recon

    mesh = shd.make_mesh(device="cpu")
    sp = torch.as_tensor(tdr.sparse_field(3, 64, 32))
    rgb, a = recon.pull_push_sharded(vec.from_rows(sp[..., :3]), sp[..., 3],
                                     mesh)
    w_rgb, w_a = pullpush.pull_push_v(vec.from_rows(sp[..., :3]), sp[..., 3])
    assert torch.equal(vec.to_rows(rgb), vec.to_rows(w_rgb))
    assert torch.equal(a, w_a)
    f = {k: vec.from_rows(torch.as_tensor(v))
         for k, v in tdr.atrous_fields(5, 32, 24).items()}
    got = recon.atrous_sharded(f["color"], f["pos"], f["nrm"], 2, 1.0, 0.5,
                               0.5, mesh, 0, 32)
    want = atrous.atrous_denoise_v(f["color"], f["pos"], f["nrm"], 2)
    assert torch.equal(vec.to_rows(got), vec.to_rows(want))


# -------------------------------------------------- the row-block functions
def _gbuf_fields(seed, h, w):
    r = np.random.default_rng(seed)
    f = lambda *s: r.uniform(size=s).astype(np.float32)
    return {"albedo": f(3, h, w), "normal": r.normal(size=(3, h, w)).astype(
        np.float32), "depth": f(h, w) * 5.0 + 1.0,
        "shadow": (r.uniform(size=(h, w)) < 0.8).astype(np.float32),
        "reproject_u": f(h, w) * w, "reproject_v": f(h, w) * (h + 16) - 8.0}


@pytest.mark.parametrize("row_offset", [0, 8, 20])
def test_compute_saliency_row_offset_and_focal_match_jax(row_offset):
    """compute_saliency on a row block with the global row of its first
    row and an explicit focal depth, against the reference's."""
    from fovtrace.core.vec import Vec3 as JVec3
    from fovtrace.kernels import saliency as jsaliency

    g = _gbuf_fields(row_offset, 32, 40)
    jg = {k: (JVec3(*map(jnp.asarray, v)) if v.ndim == 3 else jnp.asarray(v))
          for k, v in g.items()}
    pg = {k: (vec.Vec3(*map(torch.as_tensor, v)) if v.ndim == 3
              else torch.as_tensor(v)) for k, v in g.items()}
    want = np.asarray(jax.jit(lambda gb: jsaliency.compute_saliency(
        gb, (5, 7), 3.5, 4, row_offset=row_offset, focal=2.25))(jg))
    got = saliency.compute_saliency(pg, (5, 7), torch.tensor(3.5), 4,
                                    row_offset=row_offset, focal=2.25)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("gaze", [(20, 40), (3, 60)])
def test_logpolar_sampling_row_block_bit_for_bit(gaze):
    """Rows [16, 32) of the log-polar mask equal the reference's row
    block and the port's whole-frame mask's rows."""
    from fovtrace.kernels import sampling as jsampling

    want = np.asarray(jax.jit(lambda g: jsampling.logpolar_sampling(
        48, 64, g, row_offset=16, block_h=16))(jnp.asarray(gaze)))
    got = sampling.logpolar_sampling(48, 64, gaze, "cpu", row_offset=16,
                                     block_h=16)
    np.testing.assert_array_equal(got.numpy(), want)
    whole = sampling.logpolar_sampling(48, 64, gaze, "cpu")
    assert torch.equal(got, whole[16:32])


def test_trace_gbuffer_row_block(multi_cpu):
    """A row block of the G-buffer, traced in scanline order, equals the
    whole frame's rows (traced in 16x16 tiles) and the reference's row
    block."""
    from fovtrace.render import gbuffer as jgbuffer

    config = RenderConfig(width=64, height=64)
    cam, cam2 = _cams()
    whole = gbuffer.trace_gbuffer(multi_cpu, cam2, cam, 64, 64, config)
    block = gbuffer.trace_gbuffer(multi_cpu, cam2, cam, 64, 64, config, y0=16,
                                  block_h=24)
    for k in ("depth", "shadow", "reproject_u", "reproject_v", "hit_valid"):
        assert torch.equal(block[k], whole[k][16:40]), k
    for k in ("position", "normal", "albedo"):
        assert torch.equal(vec.to_rows(block[k]),
                           vec.to_rows(whole[k])[16:40]), k
    jcam = JCamera.create(eye=tdr.FRAME_EYE, target=tdr.FRAME_TARGET)
    jcam2 = jcam.replace(eye=jnp.asarray(tdr.FRAME_EYE2))
    jcfg = JRenderConfig(width=64, height=64)
    want = jax.jit(lambda s, c, p: jgbuffer.trace_gbuffer(
        s, c, p, 64, 64, jcfg, y0=16, block_h=24))(
            jprocedural.multi_object_scene(), jcam2, jcam)
    assert int(block["rays_traced"]) == int(want["rays_traced"])
    np.testing.assert_array_equal(block["shadow"].numpy(),
                                  np.asarray(want["shadow"]))
    # the reference's compiled projection rounds its [0, 0] entry as
    # f * (1 / aspect) (tests/test_torch_train.py): hit points move by
    # ~1e-5 relative
    np.testing.assert_allclose(block["depth"].numpy(),
                               np.asarray(want["depth"]), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(vec.to_rows(block["albedo"]).numpy(),
                               np.stack([np.asarray(c) for c in
                                         want["albedo"]], -1), rtol=0, atol=0)


def test_gaze_distance_row_block():
    whole = sampling.gaze_distance(48, 64, (20, 9), "cpu")
    assert torch.equal(sampling.gaze_distance(48, 64, (20, 9), "cpu",
                                              row_offset=24, block_h=8),
                       whole[24:32])


# ---------------------------------------------------------------- launch
def test_init_distributed_single_process(monkeypatch):
    """With no settings anywhere the launch is one process and no group."""
    for k in ("FOVTRACE_COORDINATOR", "FOVTRACE_NUM_PROCESSES",
              "FOVTRACE_PROCESS_ID", "MASTER_ADDR", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(k, raising=False)
    assert launch.init_distributed(device="cpu") is False
    assert not torch.distributed.is_initialized()
    mesh = launch.global_mesh("cpu")
    assert (mesh.rank, mesh.size, mesh.group) == (0, 1, None)
    assert launch.is_coordinator()


def test_init_distributed_refuses_a_partial_setting(monkeypatch):
    for k in ("FOVTRACE_COORDINATOR", "FOVTRACE_PROCESS_ID", "MASTER_ADDR"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("FOVTRACE_NUM_PROCESSES", "2")
    with pytest.raises(ValueError, match="coordinator address"):
        launch.init_distributed(device="cpu")
    assert not torch.distributed.is_initialized()


def test_make_mesh_checks_the_rank_count():
    with pytest.raises(ValueError, match="1 ranks"):
        shd.make_mesh(4, device="cpu")


# ------------------------------------- compaction padding in the wavefront
def test_padding_lanes_stop_after_the_first_bounce():
    """A fault of the reference that the port corrects (ROADMAP section
    3): a compacted front is padded to its budget with copies of one
    pixel's ray, and the reference lets those copies go on bouncing,
    where they crowd real survivors out of the next bounce's budget and
    the real rays' later bounces are lost without a count. Here 1,000
    real rays (64x64 earth, rows 24-39) are padded to 4,096 lanes with a
    ray that continues from the earth sphere (pixel (33, 31); its next
    direction is in the first octant of the compaction's order): the
    reference's radiance of the real lanes then differs from the
    1,000-ray front's, and so does the port's without `active`; with it,
    the port's equals the 1,000-ray front's bit for bit, and it traces
    and counts the padding in the first bounce only."""
    from fovtrace.core import rng as jrng
    from fovtrace.render import shade as jshade
    from fovtrace_torch.core import rng
    from fovtrace_torch.render import shade

    kw = dict(width=64, height=64, max_depth=3, diffuse_max_depth=1)
    cam = _cams()[0]
    _, rd = cam.primary_rays_v(64, 64)
    rd = vec.to_rows(rd.map(lambda a: a.reshape(-1)))
    real = torch.arange(24 * 64, 24 * 64 + 1000)
    lanes = torch.cat([real, torch.full((4096 - 1000,), 33 * 64 + 31)])
    seeds = rng.pixel_seed(lanes, 0)
    active = torch.arange(4096) < 1000
    ro = cam.eye.expand(4096, 3)
    ps = procedural.earth_scene("cpu")
    got, aux = shade.shade_v(ps, vec.from_rows(ro), vec.from_rows(rd[lanes]),
                             seeds, RenderConfig(**kw), active=active)
    alone, aux1 = shade.shade_v(ps, vec.from_rows(ro[:1000]),
                                vec.from_rows(rd[real]), seeds[:1000],
                                RenderConfig(**kw))
    torch.testing.assert_close(vec.to_rows(got)[:1000], vec.to_rows(alone),
                               rtol=0, atol=0)

    js, jcfg = jprocedural.earth_scene(), JRenderConfig(**kw)
    jshade_fn = jax.jit(lambda ro, rd, sd: jshade.shade(js, ro, rd, sd, jcfg))
    want, jaux = jshade_fn(jnp.asarray(ro.numpy()),
                           jnp.asarray(rd[lanes].numpy()),
                           jrng.pixel_seed(jnp.asarray(lanes.numpy()), 0))
    want1, _ = jshade_fn(jnp.asarray(ro[:1000].numpy()),
                         jnp.asarray(rd[real].numpy()),
                         jrng.pixel_seed(jnp.asarray(real.numpy()), 0))
    want, want1 = np.asarray(want)[:1000], np.asarray(want1)
    lost = (np.abs(want - want1).max(-1) > 1e-3).nonzero()[0]
    assert lost.size > 0        # the reference loses real rays' bounces
    # without `active` the port does as the reference does: the same
    # real lanes lose their later bounces
    as_ref, _ = shade.shade_v(ps, vec.from_rows(ro), vec.from_rows(rd[lanes]),
                              seeds, RenderConfig(**kw))
    lost_port = ((vec.to_rows(as_ref)[:1000] - vec.to_rows(alone)).abs()
                 .amax(-1) > 1e-3).nonzero().flatten().numpy()
    # (a few lanes apart: glass paths round otherwise, ROADMAP section 3)
    assert len(set(lost_port) ^ set(lost)) <= 0.05 * lost.size, \
        (lost_port.size, lost.size)
    # the first bounce traces every lane, as the reference counts them
    assert int(aux["rays_traced"]) < int(jaux["rays_traced"])
    assert int(aux["rays_traced"]) > int(aux1["rays_traced"]) + 3096
