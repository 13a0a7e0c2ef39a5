"""The program's spans (app.profiler.span) inside the forward frame: their
names and nesting on the one-card path and on two gloo ranks' row-sharded
frame, the frame's bits with a profiler on and off, no record_function
call with no profiler running, and, on a card, every host sync of a
frame inside a fov.sync span; and the launch counters' one registry."""

import collections
import contextlib
import traceback
import warnings

import pytest
import torch

import torch_dist_ranks as tdr
from fovtrace_torch import Camera, RenderConfig
from fovtrace_torch.render import pipeline
from fovtrace_torch.scene import procedural

SIZE = 64
EYE, TARGET = (3.0, 2.5, 4.0), (0.0, 0.8, 0.0)
GAZE = (30, 33)
STAGES = ("fov.gbuffer", "fov.sampling", "fov.compact", "fov.shade",
          "fov.reconstruct")
SAMPLING = ("fov.sampling.cache", "fov.sampling.saliency",
            "fov.sampling.mask")
# the filters stage_reconstruct runs for each reconstruction
FILTERS = {"atrous": ("pullpush", "atrous"), "none": (),
           "all": ("jfa", "sibson", "pullpush", "atrous")}
# the frame's blocking exchanges between host and device
SYNC_SITES = {"fov.sync.inv4_download", "fov.sync.inv4_upload",
              "fov.sync.view_matrix", "fov.sync.dither_table",
              "fov.sync.tonemap_white", "fov.sync.ray_bound"}


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    # the suite runs in several worker processes at once
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def earth_cpu():
    return procedural.earth_scene("cpu")


def _frame(scene, config, device="cpu", gaze=GAZE):
    """render_frame of one frame from the initial state, as a closure."""
    cam = Camera.create(eye=EYE, target=TARGET, device=device)
    state = pipeline.FrameState.initial(cam, config)
    return lambda: pipeline.render_frame(scene, cam, gaze, state, config)


def _names(tree) -> collections.Counter:
    names = collections.Counter()
    for (name, _), n in tree.items():
        names[name] += n
    return names


def _check_tree(tree, config, filters, sampling_spans=1):
    """One fov.frame holding every other span; each stage once in it
    (fov.sampling `sampling_spans` times), the sampling parts in
    fov.sampling, one bounce span per bounce in fov.shade, the filters
    that run in fov.reconstruct, and the sync sites inside the frame's
    spans."""
    names = _names(tree)
    assert tree[("fov.frame", "")] == 1 and names["fov.frame"] == 1
    assert [k for k in tree if k[1] == ""] == [("fov.frame", "")]
    for s in STAGES:
        want = sampling_spans if s == "fov.sampling" else 1
        assert tree.get((s, "fov.frame")) == want == names[s], s
    for s in SAMPLING:
        assert tree.get((s, "fov.sampling")) == names[s] >= 1, s
    bounces = [f"fov.shade.bounce{k}" for k in range(config.max_depth)]
    for b in bounces:
        assert tree.get((b, "fov.shade")) == names[b] == 1, b
    recon = {f"fov.reconstruct.{f}" for f in filters}
    assert {n for (n, p) in tree if p == "fov.reconstruct"} == recon
    syncs = {n for n in names if n.startswith("fov.sync.")}
    assert syncs and syncs <= SYNC_SITES, syncs
    assert set(names) - syncs - {n for n in names
                                 if n.startswith("fov.coll.")} == \
        {"fov.frame", *STAGES, *SAMPLING, *bounces, *recon}


def _assert_same(a, b):
    assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.parametrize("recon", sorted(FILTERS))
def test_frame_spans_and_bits_with_the_profiler_on(earth_cpu, recon):
    config = RenderConfig(width=SIZE, height=SIZE, reconstruction=recon,
                          max_depth=3, diffuse_max_depth=1,
                          ray_budget_frac=0.6)
    render = _frame(earth_cpu, config)
    out_off, new_off = render()
    (out_on, new_on), tree = tdr.profiled(render)
    _check_tree(tree, config, FILTERS[recon])
    assert sorted(out_on) == sorted(out_off)
    for k, v in out_off.items():
        for a, b in zip(v if hasattr(v, "x") else [v],
                        out_on[k] if hasattr(v, "x") else [out_on[k]]):
            _assert_same(a, b)
    for f in ("history", "depth_cache", "frame"):
        _assert_same(getattr(new_off, f), getattr(new_on, f))


def test_sharded_frame_spans_and_bits(tmp_path):
    """Rank 0 of two gloo ranks opens the one-card frame's spans (the
    same configuration), fov.sampling twice, and the collectives'
    fov.coll spans; the frame's bits are the same with the profiler
    on."""
    kw = dict(gaze=list(GAZE), recon="atrous")
    res = tdr.run_ranks("spans", 2, tmp_path, **kw)
    tree = {tuple(k.split("/")[1:]): int(v) for k, v in res.items()
            if k.startswith("tree/")}
    config = tdr.frame_config(recon="atrous")
    _check_tree(tree, config, FILTERS["atrous"], sampling_spans=2)
    assert tree[("fov.sampling.cache", "fov.sampling")] == 2
    colls = {n for (n, _) in tree if n.startswith("fov.coll.")}
    assert {"fov.coll.all_gather_rows", "fov.coll.all_reduce_sum",
            "fov.coll.neighbour_rows"} <= colls
    assert all(p.startswith("fov.") for (n, p) in tree if n in colls)
    one = procedural.multi_object_scene("cpu")
    _, single = tdr.profiled(_frame(one, config))
    assert set(_names(tree)) - colls == set(_names(single))
    for k in ("image", "mask", "ray_count", "rays_traced", "history",
              "depth"):
        _assert_same(res[f"off/{k}"], res[f"on/{k}"])


def test_no_record_function_without_a_profiler(monkeypatch):
    calls = []
    real = torch.profiler.record_function

    def counted(name):
        calls.append(name)
        return real(name)
    monkeypatch.setattr(torch.profiler, "record_function", counted)
    config = RenderConfig(width=16, height=16, max_depth=2,
                          reconstruction="atrous")
    render = _frame(procedural.box_scene("cpu"), config, gaze=(8, 8))
    render()
    assert calls == []
    tdr.profiled(render)
    assert calls[0] == "fov.frame" and len(calls) > 20


def test_counter_registry_holds_every_kernel_family():
    """cluster_isect.counters() (the bench's launches-per-step line,
    app/optimize's launch report) reports the material and envmap
    counters beside the intersection's, and a frame's calls of each."""
    from fovtrace_torch.kernels import cluster_isect as ci
    from fovtrace_torch.kernels import envmap, material

    assert set(material.COUNTED) | set(envmap.COUNTED) <= set(ci.COUNTED)
    config = RenderConfig(width=16, height=16, max_depth=2)
    render = _frame(procedural.box_scene("cpu"), config, gaze=(8, 8))
    ci.reset_counters()
    render()
    got = ci.counters()
    assert sorted(got) == sorted(ci.COUNTED)
    assert got["closest_hit_plain"] > 0
    assert got["material_gather_plain"] > 0
    assert got["envmap_lookup_plain"] > 0


class _OpenSpans:
    """torch.profiler.record_function that also keeps the names of the
    ranges open now and counts those opened."""

    def __init__(self, real):
        self.real, self.stack = real, []
        self.opened = collections.Counter()

    @contextlib.contextmanager
    def __call__(self, name):
        self.stack.append(name)
        self.opened[name] += 1
        try:
            with self.real(name):
                yield
        finally:
            self.stack.pop()


@pytest.mark.cuda
@pytest.mark.parametrize("scene", ["earth", "city"])
def test_every_host_sync_lies_in_a_sync_span(scene, monkeypatch):
    """Under torch.cuda's sync debug mode, each synchronising operation
    of a frame is warned of inside one fov.sync span, and the warnings
    equal the frame's fov.sync spans in number. Earth takes the resident
    intersection kernels, city the streaming ones."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    dev = torch.device("cuda")
    config = RenderConfig(width=128, height=128, reconstruction="atrous",
                          max_depth=4, diffuse_max_depth=1,
                          ray_budget_frac=0.6, full_outputs=False,
                          bounce_budget_fracs=(0.25, 0.06, 0.02))
    render = _frame(procedural.SCENES[scene](dev), config, dev)
    for _ in range(2):
        # the first frame builds the kernels and meets the process's
        # one-time work; the second is the one held to the spans
        spans = _OpenSpans(torch.profiler.record_function)
        seen = []
        with monkeypatch.context() as mp:
            mp.setattr(torch.profiler, "record_function", spans)
            _debug_frame(render, spans, seen, mp)
    outside = [where for sp, where in seen if len(sp) != 1]
    assert seen and not outside, outside
    n_spans = sum(n for k, n in spans.opened.items()
                  if k.startswith("fov.sync."))
    assert len(seen) == n_spans, (len(seen), dict(spans.opened))


def _debug_frame(render, spans, seen, mp):
    """render() under torch.profiler and the sync debug mode: for each
    sync warning, the fov.sync spans open and the program's frames."""
    def note(message, *args, **kw):
        if "synchroniz" in str(message):
            where = [f"{f.filename}:{f.lineno}"
                     for f in traceback.extract_stack()
                     if "fovtrace_torch" in f.filename][-3:]
            seen.append(([s for s in spans.stack
                          if s.startswith("fov.sync.")], where))
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        with warnings.catch_warnings():
            warnings.simplefilter("always")
            mp.setattr(warnings, "showwarning", note)
            torch.cuda.set_sync_debug_mode("warn")
            try:
                render()
            finally:
                torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
