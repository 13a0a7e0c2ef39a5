"""The material table's lookup (`fovtrace_torch.kernels.material`, behind
`kernels.intersect.material_lookup_v`) against the JAX reference's
`fovtrace.kernels.intersect.material_lookup_v`: the forward bit for bit,
the table's gradient against jax.vjp within 1e-5 of the sum of |g| over
each entry's lanes (sums taken in another order may cancel), float64
gradcheck of the Function, equal bits from two backward runs, and the
wrappers' checks and launch arguments (a stand-in library: the kernels
themselves run on the card, tests/test_torch_cuda_kernels.py). Inputs
from a numpy seed: N = 4,096 rays, the shade's K = 21 columns and the
surface's K = 4, M = 4 (the reference's select chain) and M = 24 (its
row gather), every lane on one material, and most lanes misses clamped
to row 0."""

import ctypes
import re
import types
from pathlib import Path

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from fovtrace.core.vec import Vec3 as JVec3  # noqa: E402
from fovtrace.kernels import intersect as jisect  # noqa: E402
from fovtrace_torch import Camera, RenderConfig, kernels  # noqa: E402
from fovtrace_torch.core.vec import Vec3  # noqa: E402
from fovtrace_torch.kernels import cluster_isect as ci  # noqa: E402
from fovtrace_torch.kernels import intersect as isect  # noqa: E402
from fovtrace_torch.kernels import material  # noqa: E402
from fovtrace_torch.render import pipeline  # noqa: E402
from fovtrace_torch.scene import procedural  # noqa: E402

N = 4096
SHADE = [("kind", 1), ("ks", 3), ("phong_exp", 1), ("reflectivity_n", 3),
         ("ior", 1), ("extinction", 3), ("refraction_color", 3),
         ("reflection_color", 3), ("fresnel_exponent", 1),
         ("fresnel_minimum", 1), ("fresnel_maximum", 1)]     # K = 21
SURFACE = [("kd", 3), ("texture_id", 1)]                     # K = 4
COLUMNS = {"shade": SHADE, "surface": SURFACE}
INT_COLUMNS = ("kind", "texture_id")
# (materials, how the rays' ids are drawn)
CASES = {"select-chain": (4, "uniform"), "row-gather": (24, "uniform"),
         "one-material": (4, "one"), "misses": (4, "misses")}
CSRC = Path(material.__file__).resolve().parent.parent / "csrc" / "material.cu"


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    # several test workers share the CPU (see tests/test_torch_grad.py)
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _inputs(case, which, seed=0):
    """(columns {name: numpy [M] or [M, 3]}, safe ids [N] int32, the
    cotangent [K, N] float32) from a numpy seed."""
    m, how = CASES[case]
    r = np.random.default_rng(seed)
    cols = {}
    for name, width in COLUMNS[which]:
        shape = (m,) if width == 1 else (m, width)
        if name in INT_COLUMNS:
            cols[name] = r.integers(-1, 6, size=shape).astype(np.int32)
        else:
            cols[name] = r.normal(size=shape).astype(np.float32)
    mat_id = r.integers(0, m, size=N).astype(np.int32)
    if how == "one":
        mat_id[:] = m - 2
    elif how == "misses":
        mat_id[r.random(N) < 0.7] = -1
    safe = np.maximum(mat_id, 0).astype(np.int32)     # misses read row 0
    k = sum(w for _, w in COLUMNS[which])
    return cols, safe, r.normal(size=(k, N)).astype(np.float32)


def _flat(outs):
    """A lookup's outputs as a list of [N] rows, in column order."""
    rows = []
    for o in outs:
        rows.extend(list(o) if isinstance(o, (Vec3, JVec3)) else [o])
    return rows


def _port(cols, safe, which, requires_grad=True):
    leaves = {k: torch.tensor(v, requires_grad=requires_grad
                              and k not in INT_COLUMNS)
              for k, v in cols.items()}
    outs = isect.material_lookup_v(types.SimpleNamespace(**leaves),
                                   torch.tensor(safe), COLUMNS[which])
    return leaves, outs


def _jax_vjp(cols, safe, which, g):
    """The reference's outputs and the gradient of <outputs, g> with
    respect to each float column."""
    ints = {k: jnp.asarray(v) for k, v in cols.items() if k in INT_COLUMNS}

    def f(floats):
        mats = types.SimpleNamespace(**floats, **ints)
        return jisect.material_lookup_v(mats, jnp.asarray(safe),
                                        COLUMNS[which])

    floats = {k: jnp.asarray(v) for k, v in cols.items()
              if k not in INT_COLUMNS}
    outs, vjp = jax.vjp(f, floats)
    ct, off = [], 0
    for o in outs:
        if isinstance(o, JVec3):
            ct.append(JVec3(*[jnp.asarray(g[off + j]) for j in range(3)]))
            off += 3
        else:
            ct.append(jnp.asarray(g[off]))
            off += 1
    return outs, vjp(ct)[0]


@pytest.mark.parametrize("which", list(COLUMNS))
@pytest.mark.parametrize("case", list(CASES))
def test_lookup_matches_reference(case, which):
    """The forward equals the reference's bit for bit (its integer
    columns cast to float32 too), and the table's gradient matches
    jax.vjp's within 1e-5 x sum |g| of each entry's lanes."""
    cols, safe, g = _inputs(case, which)
    want, jgrad = _jax_vjp(cols, safe, which, g)
    leaves, outs = _port(cols, safe, which)
    got_rows, want_rows = _flat(outs), _flat(want)
    assert len(got_rows) == len(want_rows) == g.shape[0]
    for got, ref in zip(got_rows, want_rows):
        np.testing.assert_array_equal(got.detach().numpy(), np.asarray(ref))
    torch.autograd.backward(got_rows, [torch.tensor(x) for x in g])
    off = 0
    for name, width in COLUMNS[which]:
        if name not in INT_COLUMNS:
            got = leaves[name].grad.numpy().reshape(-1, width)
            ref = np.asarray(jgrad[name]).reshape(-1, width)
            # sum |g| per (material, column) over the lanes that read it
            scale = np.stack([np.abs(g[off:off + width, safe == j]).sum(1)
                              for j in range(got.shape[0])])
            assert np.all(np.abs(got - ref) <= 1e-5 * scale), (name, case)
        off += width


def test_misses_sum_into_row_zero():
    """A miss lane's cotangent reaches row 0, which it read."""
    ids = torch.tensor([0, 0, 2, 0], dtype=torch.int32)
    g = torch.tensor([[1.0, 2.0, 4.0, 8.0]])
    got = material.adjoint(ids, g, 3)
    assert got.tolist() == [[11.0], [0.0], [4.0]]


def test_function_passes_gradcheck():
    """float64 gradcheck of MaterialLookup on the plain path, misses
    included."""
    r = np.random.default_rng(3)
    ids = torch.tensor(np.maximum(r.integers(-1, 5, size=64), 0),
                       dtype=torch.int32)
    table = torch.tensor(r.normal(size=(5, 3)), dtype=torch.float64,
                         requires_grad=True)
    assert torch.autograd.gradcheck(
        lambda t: material.MaterialLookup.apply(ids, t), (table,))


@pytest.mark.parametrize("which", list(COLUMNS))
def test_backward_runs_give_equal_bits(which):
    cols, safe, g = _inputs("row-gather", which, seed=5)
    grads = []
    for _ in range(2):
        leaves, outs = _port(cols, safe, which)
        torch.autograd.backward(_flat(outs), [torch.tensor(x) for x in g])
        grads.append({k: v.grad for k, v in leaves.items()
                      if v.grad is not None})
    assert grads[0].keys() == grads[1].keys() and grads[0]
    for k in grads[0]:
        assert torch.equal(grads[0][k], grads[1][k]), k


def test_no_gradient_builds_no_backward():
    """With no column requiring a gradient (the shade's 21 columns) the
    lookup builds no autograd node, as before."""
    cols, safe, _ = _inputs("select-chain", "shade")
    _, outs = _port(cols, safe, "shade", requires_grad=False)
    assert all(r.grad_fn is None and not r.requires_grad
               for r in _flat(outs))


def test_adjoint_scatters_nothing():
    """The table's gradient is masked sums: no index_put, index_add or
    scatter runs in the backward."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Ops(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.names = []

        def __torch_dispatch__(self, func, types_, args=(), kwargs=None):
            self.names.append(func.__name__)
            return func(*args, **(kwargs or {}))

    ids = torch.tensor([0, 3, 1, 1, 0], dtype=torch.int32)
    table = torch.randn(4, 4, requires_grad=True)
    out = material.MaterialLookup.apply(ids, table)
    with Ops() as ops:
        out.backward(torch.ones_like(out))
    assert ops.names and not [n for n in ops.names
                              if "index" in n or "scatter" in n], ops.names


def test_plain_versions_on_the_cpu():
    """On CPU tensors the wrappers run the plain versions and count them;
    no kernel launch is counted."""
    cols, safe, g = _inputs("select-chain", "surface")
    kernels.CALLS.clear()
    _, outs = _port(cols, safe, "surface")
    torch.autograd.backward(_flat(outs), [torch.tensor(x) for x in g])
    assert material.counters() == {"material_gather": 0,
                                   "material_adjoint": 0,
                                   "material_gather_plain": 1,
                                   "material_adjoint_plain": 1}
    assert {k: ci.counters()[k] for k in material.COUNTED} == \
        material.counters()


def test_grad_step_goes_through_the_function():
    """The fwd+bwd step's lookups (the G-buffer's and each bounce's
    surface and shade columns) run the Function: its gather and, for
    the differentiated kd, its adjoint."""
    scene = procedural.box_scene("cpu")
    cam = Camera.create(eye=(3.0, 2.0, 4.0), target=(0.0, 0.5, 0.0),
                        device="cpu")
    cfg = RenderConfig(width=16, height=16, max_depth=2, diffuse_max_depth=1)
    kernels.CALLS.clear()
    _, grads, _ = pipeline.grad_step(scene, cam, (8, 8), None, cfg)
    got = material.counters()
    assert got["material_gather"] == got["material_adjoint"] == 0
    # the G-buffer's surface and, per bounce, the surface and the shade
    assert got["material_gather_plain"] == 1 + 2 * cfg.max_depth, got
    assert got["material_adjoint_plain"] >= cfg.max_depth, got
    assert float(grads["kd"].abs().sum()) > 0


@pytest.mark.parametrize("bad", ["int64 ids", "out of range", "negative",
                                 "float16 table", "2-d ids", "mixed",
                                 "meta", "too large"])
def test_wrappers_refuse_what_the_kernels_do_not_take(bad):
    ids = torch.tensor([0, 1, 2], dtype=torch.int32)
    table = torch.zeros(3, 4)
    err = {"int64 ids": TypeError}.get(bad, ValueError)
    if bad == "int64 ids":
        ids = ids.long()
    elif bad == "out of range":
        ids = torch.tensor([0, 3], dtype=torch.int32)
    elif bad == "negative":
        ids = torch.tensor([-1, 0], dtype=torch.int32)
    elif bad == "float16 table":
        table = torch.zeros(3, 4, dtype=torch.float16)
        err = TypeError
    elif bad == "2-d ids":
        ids = ids[None]
    elif bad == "mixed":
        table = torch.zeros(3, 4, device="meta")
    elif bad == "meta":
        ids, table = ids.to("meta"), table.to("meta")
    elif bad == "too large":
        table = torch.zeros(material.MAX_TABLE // 4 + 1, 4)
    with pytest.raises(err) as e:
        material.gather(ids, table)
    if bad == "too large":
        assert f"MAX_TABLE = {material.MAX_TABLE}" in str(e.value)
    if bad not in ("2-d ids", "float16 table", "mixed"):
        with pytest.raises(err):
            material.adjoint(ids.reshape(-1), torch.zeros(4, ids.numel(),
                                                          device=ids.device),
                             table.shape[0])


def test_constants_match_the_source():
    text = CSRC.read_text()
    consts = dict(re.findall(r"constexpr int (\w+) = ([^;]+);", text))
    assert int(consts["MAX_TABLE"]) == material.MAX_TABLE
    assert consts["WARP_RAYS"] == "32 * LANE_RAYS"
    assert 32 * int(consts["LANE_RAYS"]) == material.WARP_RAYS


def test_c_signatures_match_the_source():
    """Each C entry point's parameters in csrc/material.cu: a pointer for
    each void*, an int for each int, as the ctypes signature says."""
    text = CSRC.read_text().split('extern "C" {', 1)[1]
    found = {}
    for name, params in re.findall(r"int (fov_\w+)\(([^)]*)\)", text):
        found[name] = [ctypes.c_void_p if "*" in p else ctypes.c_int
                       for p in params.split(",")]
    assert found == {k: a for k, (a, _) in material.c_signatures().items()}


class _Lib:
    """Stands in for the material library: records each entry point's
    arguments."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        return lambda *args: self.calls.append((name, args)) or 0


@pytest.mark.parametrize("kind", ["gather", "adjoint"])
def test_launch_arguments_fit_the_c_entry_points(kind, monkeypatch):
    """`_launch` passes each C entry point its pointers, n, m, k and the
    stream, as many as its ctypes signature has, and counts the launch.
    CPU tensors, a stand-in library."""
    lib = _Lib()
    monkeypatch.setattr(material, "load_cuda_library", lambda: lib)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: type("S", (), {"cuda_stream": 0}))
    n, m, k = 1000, 5, 4
    ids = torch.zeros(n, dtype=torch.int32)
    tensors = (ids, torch.zeros(m, k), torch.zeros(k, n)) if kind == "gather" \
        else (ids, torch.zeros(k, n),
              torch.zeros(m * k * -(-n // material.WARP_RAYS)),
              torch.zeros(m, k))
    kernels.CALLS.clear()
    material._launch(f"material_{kind}", tensors, (n, m, k))
    (name, args), = lib.calls
    assert name == f"fov_material_{kind}"
    argtypes, _ = material.c_signatures()[name]
    assert len(args) == len(argtypes)
    assert list(args[:len(tensors)]) == [t.data_ptr() for t in tensors]
    assert args[len(tensors):] == (n, m, k, 0)
    assert material.counters()[f"material_{kind}"] == 1
