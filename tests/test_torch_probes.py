"""The port's probe scripts (fovtrace_torch/scripts) against the JAX
package's TPU probes run by Pallas in interpret mode on the CPU.

The microbenchmark's six kernel bodies are closures inside
`scripts/microbench_inner.py:main`, whose first lines no longer run
against the JAX package (they read an older pack and schedule). So the
test parses the script and runs its own statements from `RB =
pi.RAY_BLOCK` on (`make_call`, the six bodies and their coefficient
specs, :68-227) on the port's inputs, with `pl.pallas_call` in interpret
mode and a `pi` that supplies the `_ray_slab` and `_MM` the script was
written against. `scripts/` is read, never changed.
"""

import ast
import contextlib
import ctypes
import importlib.util
import re
import types
from pathlib import Path

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from jax.experimental import pallas as pl  # noqa: E402
from jax.experimental.pallas import tpu as pltpu  # noqa: E402

from fovtrace.kernels import intersect as jisect  # noqa: E402
from fovtrace_torch import kernels, scripts  # noqa: E402
from fovtrace_torch.kernels import cluster_isect as ci  # noqa: E402
from fovtrace_torch.scene import procedural  # noqa: E402
from fovtrace_torch.scripts import MICRO_VARIANTS  # noqa: E402
from fovtrace_torch.scripts import microbench_inner as mb  # noqa: E402
from fovtrace_torch.scripts import probe_smem_dma as dma  # noqa: E402

SCRIPTS = Path(__file__).resolve().parent.parent / "scripts"


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    # the suite runs in several worker processes at once; PyTorch's
    # default of one thread per core then oversubscribes the CPU
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


# The script's `pi._MM` and `pi._ray_slab`, as committed in 308cae3,
# fovtrace/kernels/pallas_isect.py:60-65 and :279-305; both were removed
# from the JAX package in the commit that added the script.
_MM = dict(
    dimension_numbers=(((1,), (0,)), ((), ())),
    preferred_element_type=jnp.float32,
    precision=jax.lax.Precision.HIGHEST,   # true f32 on the MXU
)


def _ray_slab(rays_ref, cb_ref, jc, upper):
    ox = rays_ref[:, 0:1]
    oy = rays_ref[:, 1:2]
    oz = rays_ref[:, 2:3]
    ix = rays_ref[:, 12:13]
    iy = rays_ref[:, 13:14]
    iz = rays_ref[:, 14:15]
    tmin = rays_ref[:, 10:11]
    base = jc * 8
    lox = (cb_ref[base + 0] - ox) * ix
    hix = (cb_ref[base + 3] - ox) * ix
    loy = (cb_ref[base + 1] - oy) * iy
    hiy = (cb_ref[base + 4] - oy) * iy
    loz = (cb_ref[base + 2] - oz) * iz
    hiz = (cb_ref[base + 5] - oz) * iz
    tenter = jnp.maximum(
        jnp.maximum(jnp.minimum(lox, hix), jnp.minimum(loy, hiy)),
        jnp.maximum(jnp.minimum(loz, hiz), tmin),
    )
    texit = jnp.minimum(
        jnp.minimum(jnp.maximum(lox, hix), jnp.maximum(loy, hiy)),
        jnp.minimum(jnp.maximum(loz, hiz), upper),
    )
    return jnp.any(tenter <= texit)


class _Interpret:
    """`pl` with pallas_call in interpret mode; `outs` collects what each
    call returns."""

    def __init__(self):
        self.outs = []

    def __getattr__(self, name):
        return getattr(pl, name)

    def pallas_call(self, *a, **kw):
        f = pl.pallas_call(*a, interpret=True, **kw)

        def call(*args):
            out = f(*args)
            self.outs.append(out)
            return out
        return call


@pytest.fixture(scope="module")
def micro_inputs():
    # 4 ray blocks: a 32x32 camera in 16x16 tiles
    return mb.build_inputs(procedural.earth_scene("cpu"), 32, 32)


@pytest.fixture(scope="module")
def script_outputs(micro_inputs):
    """{variant: [N, 1]} from the script's own bodies in interpret mode."""
    tree = ast.parse((SCRIPTS / "microbench_inner.py").read_text())
    main = next(n for n in tree.body
                if isinstance(n, ast.FunctionDef) and n.name == "main")
    start = next(i for i, s in enumerate(main.body)
                 if isinstance(s, ast.Assign)
                 and getattr(s.targets[0], "id", None) == "RB")
    code = compile(ast.Module(body=main.body[start:], type_ignores=[]),
                   str(SCRIPTS / "microbench_inner.py"), "exec")
    inp = micro_inputs
    outs = {}
    order = iter(MICRO_VARIANTS)    # the script times them in this order

    def timeit(fn, *args, name=""):
        out = jax.block_until_ready(fn(*args))
        outs[next(order)] = np.asarray(out)
        return 0.0, out

    pi = types.SimpleNamespace(RAY_BLOCK=ci.RAY_BLOCK, DET_EPS=jisect.DET_EPS,
                               _MM=_MM, _ray_slab=_ray_slab)
    ns = dict(jax=jax, jnp=jnp, pl=_Interpret(), pltpu=pltpu, pi=pi,
              timeit=timeit, nb=inp.nb, nc=inp.nc, c=inp.c,
              counts=jnp.asarray(inp.counts.numpy()),
              sched=jnp.asarray(inp.sched.numpy()),
              cb_flat=jnp.asarray(inp.cb_flat.numpy()),
              rays=jnp.asarray(inp.rays.numpy()),
              coef=jnp.asarray(inp.coef_lane.numpy()))
    exec(code, ns)
    assert sorted(outs) == sorted(MICRO_VARIANTS)
    return outs


@pytest.mark.parametrize("variant", MICRO_VARIANTS)
def test_micro_plain_matches_script_body(micro_inputs, script_outputs,
                                         variant):
    inp = micro_inputs
    stats = {}
    got = mb.plain(variant, *inp.args(variant), stats=stats).numpy()
    want = script_outputs[variant]
    assert got.shape == want.shape == (inp.nb * ci.RAY_BLOCK, 1)
    assert np.isfinite(got).all()
    if variant in ("loop", "slab"):
        # sums of small integers and halvings: exact in any order
        np.testing.assert_array_equal(got, want)
        return
    if variant == "full":
        hit = want < 1e30
        assert (hit == (got < 1e30)).all(), "hit/miss flips"
        assert hit.sum() > 100
        assert 0 < stats["steps"] <= int(inp.counts.sum())
        # float32 dot products summed in another order, then a division
        np.testing.assert_allclose(got[hit], want[hit], rtol=1e-5, atol=1e-5)
        return
    # raw float32 dot products (bf16 operands: exact products), summed in
    # another order; the minimum is of values up to ~100
    assert stats["steps"] == int(inp.counts.sum())
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)


def test_micro_input_layouts(micro_inputs):
    inp = micro_inputs
    nc, c = inp.nc, inp.c
    earth = procedural.earth_scene("cpu")
    # the lane layout's cluster j columns are the leading layout's slab j
    lane = inp.coef_lane.view(16, nc, 4 * c).permute(1, 0, 2)
    assert torch.equal(lane, inp.coef_lead)
    assert torch.equal(inp.coef_lead, earth.isect_coef)
    assert torch.equal(inp.coef_bf16.float(),
                       earth.isect_coef.to(torch.bfloat16).float())
    assert torch.equal(inp.cb_flat.view(nc, 8), earth.cluster_aabb)
    # rays are pack_raysT's blocks transposed to rows
    raysT = inp.rays.view(inp.nb, ci.RAY_BLOCK, 16).permute(0, 2, 1)
    live, _ = ci.block_liveness(raysT.contiguous(), earth.cluster_aabb)
    row = inp.sched.view(inp.nb, nc).long()
    for i in range(inp.nb):
        ids = row[i]
        # each row holds every cluster once, its live ones first
        assert torch.equal(ids.sort().values, torch.arange(nc))
        n = int(inp.counts[i])
        assert n == int(live[i].sum()) > 0
        assert set(ids[:n].tolist()) == set(torch.nonzero(live[i])
                                            .squeeze(1).tolist())


def test_smem_dma_plain_matches_script_kernel(monkeypatch):
    spec = importlib.util.spec_from_file_location(
        "_probe_smem_dma_script", SCRIPTS / "probe_smem_dma.py")
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    interp = _Interpret()
    monkeypatch.setattr(script, "pl", interp)
    script.main()                   # its own numpy check, err < 1e-3
    (pallas_out,) = interp.outs
    arrays = dma.make_inputs()
    got = dma.smem_dma(*(torch.from_numpy(a) for a in arrays)).numpy()
    ref = dma.numpy_reference(*arrays)
    # the plain version rounds exactly as the numpy check (a multiply,
    # then an add, per entry in order)
    np.testing.assert_array_equal(got, ref)
    # XLA on the CPU may contract the multiply-add; values reach ~1e4
    np.testing.assert_allclose(got, np.asarray(pallas_out), rtol=1e-5,
                               atol=1e-3)
    assert np.abs(got - np.asarray(pallas_out)).max() < 1e-3


def test_smem_dma_plain_other_shape():
    # the city G-buffer's row plumbing at a small block count: NSC 666,
    # SW 768, 16 blocks
    arrays = dma.make_inputs(nb=16, nsc=666, sw=768, seed=3)
    got = dma.smem_dma(*(torch.from_numpy(a) for a in arrays)).numpy()
    np.testing.assert_array_equal(got, dma.numpy_reference(*arrays))


def test_probe_mains_run_on_cpu(capsys):
    assert dma.main(["--device", "cpu"]) == 0
    assert "OK" in capsys.readouterr().out
    assert mb.main(["--device", "cpu", "--width", "32", "--height", "32",
                    "--iters", "1"]) == 0
    err = capsys.readouterr().err
    assert "[micro] nb=4 nc=44 c=128" in err
    assert err.count("ns per live step") == len(MICRO_VARIANTS)


@pytest.mark.parametrize("probe", ["micro", "smem_dma"])
def test_probe_wrappers_raise_off_cpu_and_cuda(micro_inputs, probe):
    meta = lambda t: torch.empty_like(t, device="meta")
    if probe == "micro":
        args = [meta(t) for t in micro_inputs.args("full")]
        with pytest.raises(ValueError, match="cpu or cuda"):
            mb.run_variant("full", *args)
    else:
        args = [meta(torch.from_numpy(a)) for a in dma.make_inputs()]
        with pytest.raises(ValueError, match="cpu or cuda"):
            dma.smem_dma(*args)


def test_probe_wrappers_check_shapes(micro_inputs):
    inp = micro_inputs
    with pytest.raises(ValueError, match="variant"):
        mb.run_variant("mm", *inp.args("full"))
    with pytest.raises(ValueError, match="needs coefficients"):
        mb.run_variant("full", *inp.args("loop"))
    with pytest.raises(ValueError, match=r"\[16, NC \* 4c\]"):
        mb.run_variant("mm_lane", *inp.args("mm_lead"))
    with pytest.raises(TypeError, match="bfloat16"):
        mb.run_variant("mm_bf16", *inp.args("mm_lead"))
    arrays = dma.make_inputs()
    counts, sched, rays, table = (torch.from_numpy(a) for a in arrays)
    # the persistent kernel takes any NB; rays must match it
    got = dma.smem_dma(counts[:12], sched[:12], rays[:12], table)
    np.testing.assert_array_equal(
        got.numpy(), dma.numpy_reference(*(a[:12] for a in arrays[:3]),
                                         arrays[3]))
    with pytest.raises(ValueError, match="rays must be"):
        dma.smem_dma(counts[:12], sched[:12], rays, table)
    with pytest.raises(ValueError, match="multiple of 4"):
        dma.smem_dma(counts, sched[:, :126].contiguous(), rays, table)


# ------------------------------------------------ the persistent probes
@pytest.mark.parametrize("counts", [[3, 0, 7, 7, 1, 3], [5] * 9, [0, 0, 1],
                                    list(range(40)),
                                    [44, 2, 44, 0, 1, 2, 2, 9]])
def test_probe_ticket_order(counts):
    c = torch.tensor(counts, dtype=torch.int32)
    order = scripts.ticket_order(c)
    assert order.dtype == torch.int64
    assert sorted(order.tolist()) == list(range(len(counts)))
    oc = c[order]
    assert bool((oc[:-1] >= oc[1:]).all())      # most live entries first
    tie = oc[:-1] == oc[1:]
    assert bool((order[:-1][tie] < order[1:][tie]).all())   # ties in order
    # the probes' own copy orders as the cluster kernels do
    assert torch.equal(order, ci.ticket_order(c))


def test_probe_ticket_order_of_the_micro_inputs(micro_inputs):
    order = scripts.ticket_order(micro_inputs.counts)
    assert int(micro_inputs.counts[order[0]]) == \
        int(micro_inputs.counts.max())
    assert torch.equal(order.sort().values, torch.arange(micro_inputs.nb))


@pytest.mark.parametrize("ctas, order", [(-1, "longest"), (1.5, "longest"),
                                         (True, "longest"), ("2", "longest"),
                                         (2, "descending"), (0, "random")])
def test_forced_grid_refuses_bad_arguments(ctas, order):
    with pytest.raises(ValueError, match="forced_grid"):
        with scripts.forced_grid(ctas, order):
            pass
    assert scripts._grid is None


def test_forced_grid_sets_and_restores():
    c = torch.tensor([1, 5, 5, 0], dtype=torch.int32)
    order, ctas = scripts.block_order(c)
    assert ctas == 0 and order.tolist() == [1, 2, 0, 3]
    # the row-copy probe's default: ascending, no order passed
    assert scripts.block_order(c, default="ascending") == (None, 0)
    with scripts.forced_grid(2, "ascending"):
        assert scripts.block_order(c) == (None, 2)
        with scripts.forced_grid(1, "longest"):
            order, ctas = scripts.block_order(c, default="ascending")
            assert ctas == 1 and order.tolist() == [1, 2, 0, 3]
        assert scripts.block_order(c)[1] == 2
    with scripts.forced_grid(3):      # each probe's own order
        assert scripts.block_order(c)[0].tolist() == [1, 2, 0, 3]
        assert scripts.block_order(c, default="ascending") == (None, 3)
    assert scripts._grid is None
    with pytest.raises(RuntimeError):
        with scripts.forced_grid(3):
            raise RuntimeError
    assert scripts._grid is None


@pytest.mark.parametrize("counts", [[0, 1, 2, 3, 4, 5, 63, 64, 65, 768],
                                    list(range(0, 200, 7)), [0] * 5])
def test_smem_dma_prefix_bytes(counts):
    c = torch.tensor(counts, dtype=torch.int32)
    b = dma.prefix_bytes(c)
    assert b.dtype == torch.int64 and b.shape == c.shape
    assert bool((b % 16 == 0).all())                     # bulk-copy sizes
    assert bool((b >= 4 * c).all() and (b < 4 * c + 16).all())   # cover
    assert bool((b[c == 0] == 0).all())                  # an empty row
    # never past a padded row: SW is a multiple of 4 and >= every count
    sw = (max(counts) + 3) // 4 * 4
    assert int(b.max()) <= 4 * sw


def test_smem_dma_prefix_bytes_of_padded_rows():
    counts = torch.from_numpy(dma.make_inputs(nb=16, nsc=666, sw=768)[0])
    assert int(dma.prefix_bytes(counts).max()) <= 768 * 4
    assert dma.prefix_bytes(torch.tensor([768], dtype=torch.int32)).item() \
        == 768 * 4


# a 64-lane slice while [NSC, 64] f32 fits beside the rings (6 stages of
# 64 entries and a ray-row slice for each of 16 warps) in 227 KB - 4 KB,
# else 0 (global memory): up to 700 rows
@pytest.mark.parametrize("nsc, lanes", [(1, 64), (64, 64), (666, 64),
                                        (700, 64), (701, 0), (2048, 0)])
def test_smem_dma_lane_slice_by_table_size(nsc, lanes):
    assert dma.lane_slice(nsc) == lanes
    assert (nsc * 64 * 4 + dma.ring_bytes(64) <= dma.SMEM) == (lanes == 64)
    assert dma.ring_bytes(64) == 16 * 6 * 512


def test_smem_dma_traffic():
    counts = torch.tensor([0, 1, 14, 64, 65], dtype=torch.int32)
    t = dma.traffic(counts, 64, 666, ctas=132)
    assert t == dict(copy_bytes=0 + 16 + 64 + 256 + 272, ray_bytes=5 * 1024,
                     table_bytes=132 * 666 * 64 * 4)
    # fewer CTAs than slices: each slice loaded once
    assert dma.traffic(counts, 64, 666, ctas=2)["table_bytes"] == \
        666 * 256 * 4
    # the table in global memory: a 1 KB row per live entry
    assert dma.traffic(counts, 0, 4096, ctas=8) == dict(
        copy_bytes=608, ray_bytes=5 * 1024, table_bytes=144 * 1024)


@pytest.mark.parametrize("lanes, ctas, warps", [(64, 132, 528), (64, 2, 16),
                                                (64, 5, 32), (0, 3, 48)])
def test_smem_dma_warp_entries(lanes, ctas, warps):
    """The kernel's static round robin: slice 0's CTAs (all of them on the
    global-memory path) and their warps take blocks p, p + warps, ..."""
    counts = torch.arange(1, 1001, dtype=torch.int32) % 37
    w = dma.warp_entries(counts, lanes, ctas, 16)
    assert w.shape == (warps,) and int(w.sum()) == int(counts.sum())
    assert int(w[3]) == int(counts[3::warps].sum())


def test_smem_dma_layout_reads_the_library(monkeypatch):
    """`layout` passes fov_smem_dma_layout the address of five ints and
    reads back what the library wrote there."""
    seen = []

    class Lib:
        def fov_smem_dma_layout(self, addr):
            seen.append(addr)
            (ctypes.c_int * 5).from_address(addr)[:] = [16, 64, 6, 64, 9]
            return 0

    monkeypatch.setattr(dma, "load_probe_library", Lib)
    assert dma.layout() == dict(warps=16, ch=64, ring=6, lanes=64, smem=9)
    _fits("fov_smem_dma_layout", tuple(seen))


class _Lib:
    """Stands in for the probe library: records each entry point's
    arguments and returns `ret`."""

    def __init__(self, ret=0):
        self.calls, self.ret = [], ret

    def __getattr__(self, name):
        return lambda *args: self.calls.append((name, args)) or self.ret


def _fits(name, args):
    argtypes, _ = scripts.probe_signatures()[name]
    assert len(args) == len(argtypes), name
    for v, t in zip(args, argtypes):
        assert v is None or isinstance(v, int), (name, v)
        if t is ctypes.c_int:
            assert isinstance(v, int) and 0 <= v < 1 << 31, (name, v)


@pytest.fixture
def stand_in(monkeypatch):
    lib = _Lib()
    monkeypatch.setattr(mb, "load_probe_library", lambda: lib)
    monkeypatch.setattr(dma, "load_probe_library", lambda: lib)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: type("S", (), {"cuda_stream": 0}))
    kernels.CALLS.clear()
    return lib


_FORCE = {None: None, "two-ascending": (2, "ascending"),
          "one-longest": (1, "longest")}


@pytest.mark.parametrize("force", list(_FORCE))
@pytest.mark.parametrize("variant", MICRO_VARIANTS)
def test_micro_launch_fits_the_c_entry_point(micro_inputs, stand_in,
                                             variant, force):
    """The wrapper's launch passes fov_micro_<variant> as many arguments
    as its ctypes signature has: pointers (NULL coefficients for loop and
    slab), the ticket order and counter, then nb, nc, c and the grid (0:
    as many CTAs as fit). CPU tensors, a stand-in library."""
    inp = micro_inputs
    out = torch.empty((inp.nb * ci.RAY_BLOCK, 1))
    f = _FORCE[force]
    with scripts.forced_grid(*f) if f else contextlib.nullcontext():
        mb._launch(variant, *inp.args(variant), out, inp.nc, inp.c)
    (name, args), = stand_in.calls
    assert name == f"fov_micro_{variant}"
    _fits(name, args)
    assert (args[4] is None) == (variant in ("loop", "slab"))
    # the ticket order, NULL for ascending blocks
    assert (args[5] is None) == (f is not None and f[1] == "ascending")
    assert args[-5:-1] == (inp.nb, inp.nc, inp.c, f[0] if f else 0)
    assert kernels.CALLS[f"micro_{variant}"] == 1


@pytest.mark.parametrize("force", list(_FORCE))
def test_smem_dma_launch_fits_the_c_entry_point(stand_in, force):
    counts, sched, rays, table = (torch.from_numpy(a) for a in
                                  dma.make_inputs(nb=16, nsc=666, sw=768))
    out = torch.empty((16, dma.R))
    f = _FORCE[force]
    with scripts.forced_grid(*f) if f else contextlib.nullcontext():
        dma._launch(counts, sched, rays, table, out)
    (name, args), = stand_in.calls
    assert name == "fov_smem_dma"
    _fits(name, args)
    # ascending (NULL) unless the grid asks for the longest first
    assert (args[4] is None) == (f is None or f[1] == "ascending")
    assert args[-5:-1] == (16, 768, 666, f[0] if f else 0)
    assert kernels.CALLS["smem_dma"] == 1


def test_probe_grids_raise_on_a_cuda_error(stand_in):
    stand_in.ret = -2
    with pytest.raises(RuntimeError, match="CUDA error 2"):
        mb.grid("full", 8, 128)
    with pytest.raises(RuntimeError, match="CUDA error 2"):
        dma.grid(8, 666)
    stand_in.ret = 132
    assert mb.grid("mm_bf16", 8192, 128) == 132 and dma.grid(8, 666) == 132
    assert stand_in.calls[-2] == ("fov_micro_ctas", (4, 8192, 128))
    assert stand_in.calls[-1] == ("fov_smem_dma_ctas", (8, 666))


def test_probe_signatures_match_the_source():
    """Each C entry point of csrc/probes.cu takes what its ctypes
    signature says: a pointer (or the stream) where it says c_void_p, an
    int where it says c_int."""
    src = (Path(mb.__file__).resolve().parent.parent / "csrc"
           / "probes.cu").read_text()
    body = src[src.index('extern "C" {'):]
    found = {}
    for m in re.finditer(r"int (fov_\w+?)(?:##name)?\(([^)]*)\)", body):
        params = [q.strip() for q in m.group(2).replace("\\", "")
                  .split(",")]
        kinds = [ctypes.c_void_p if "*" in q or "cudaStream_t" in q
                 else ctypes.c_int for q in params]
        if m.group(1) == "fov_micro_":
            for v in MICRO_VARIANTS:
                found[f"fov_micro_{v}"] = kinds
        else:
            found[m.group(1)] = kinds
    sigs = scripts.probe_signatures()
    assert sorted(found) == sorted(sigs)
    for name, (argtypes, restype) in sigs.items():
        assert argtypes == found[name], name
        assert restype is ctypes.c_int


def test_check_aligned():
    t = torch.zeros(64)
    scripts.check_aligned([(t, "t")])
    with pytest.raises(ValueError, match="16-byte"):
        scripts.check_aligned([(t[1:], "t")])
