"""The environment map's bilinear lookup (`fovtrace_torch.kernels.envmap`,
behind `render.shade.envmap_lookup_v`) against the JAX reference's
`fovtrace.render.shade.envmap_lookup_v`: the lookup at the render rows'
tolerance on the default 8x16 map, earth's 64x128 `checker_envmap` and
a 5x7 map, with both poles, the seam, coordinates exactly on the last
column and row, and zero, NaN and infinite directions among them; the
gradients with respect to the map and the directions against jax.vjp at
the gradient tests' tolerance; float64 gradcheck of the Function; the
forward bit for bit the four-gather expression the render path ran
before the Function; equal bits from two backward runs; no adjoint
without the map's gradient; the remat_shade recompute; the train step
through the Function; and the wrappers' checks and launch arguments (a
stand-in library: the kernels run on the card,
tests/test_torch_cuda_kernels.py). Inputs from a numpy seed."""

import ctypes
import math
import re
from pathlib import Path

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from fovtrace.core.vec import Vec3 as JVec3  # noqa: E402
from fovtrace.render import shade as jshade  # noqa: E402
from fovtrace_torch import Camera, RenderConfig, kernels  # noqa: E402
from fovtrace_torch.core import mathx  # noqa: E402
from fovtrace_torch.core.vec import Vec3  # noqa: E402
from fovtrace_torch.dist import sharding as shd  # noqa: E402
from fovtrace_torch.dist import train  # noqa: E402
from fovtrace_torch.kernels import cluster_isect as ci  # noqa: E402
from fovtrace_torch.kernels import envmap  # noqa: E402
from fovtrace_torch.render import shade  # noqa: E402
from fovtrace_torch.scene import procedural  # noqa: E402

N = 4096
# the lookup against the jitted reference: the render rows' tolerance
# (tests/test_torch_train.py); the gradients: the gradient tests'
ROWS_RTOL, ROWS_ATOL = 1e-5, 2e-6
GRAD_RTOL, GRAD_ATOL = 2e-3, 1e-7
MAPS = {"8x16": (8, 16), "64x128": (64, 128), "5x7": (5, 7)}
CSRC = Path(envmap.__file__).resolve().parent.parent / "csrc" / "envmap.cu"
# the special directions' columns in _dirs: both poles, the seam (x = 0,
# z < 0, either sign of the zero), a zero direction, a NaN and infinite
# ones; then a direction whose fx is exactly w - 1 (the seam's +0) and,
# at the south pole, fy exactly h - 1
SPECIAL = np.array(
    [[0, 0, 0, -0.0, 0, np.nan, np.inf, -np.inf, np.inf, 0, 1, -1],
     [1, -1, 0.3, 0.3, 0, 0, 0, 0, np.inf, -np.inf, 0, 0],
     [0, 0, -1, -1, 0, 0, 0, 1, np.inf, 0, -0.0, -0.0]], np.float32)
SMOOTH = [2, 3, 10, 11]    # the special columns with a finite derivative


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    # several test workers share the CPU (see tests/test_torch_grad.py)
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _map(name, seed=0):
    """[h, w, 3] radiance: earth's sky at 64x128, else seeded HDR-like
    texels (exponential, mean 1, non-negative as radiance is)."""
    h, w = MAPS[name]
    if name == "64x128":
        return procedural.checker_envmap(h, w)
    return np.random.default_rng(seed).exponential(size=(h, w, 3)).astype(
        np.float32)


def _dirs(seed=0, special=True):
    """[3, N] float32 directions: the special ones first, then unit
    vectors, as the render path's are."""
    d = np.random.default_rng(seed).normal(size=(3, N))
    d = (d / np.linalg.norm(d, axis=0)).astype(np.float32)
    if special:
        d[:, :SPECIAL.shape[1]] = SPECIAL
    return d


def _cotangent(seed=1):
    """[3, N]: normal, zero on 70% of the lanes (a hit's cotangent)."""
    r = np.random.default_rng(seed)
    g = r.normal(size=(3, N)).astype(np.float32)
    g[:, r.random(N) < 0.7] = 0.0
    return g


def _port(env, d, requires_grad=False):
    leaves = [torch.tensor(a, requires_grad=requires_grad)
              for a in (env, *d)]
    out = shade.envmap_lookup_v(leaves[0], Vec3(*leaves[1:]))
    return leaves, torch.stack(list(out))


def _jax_vjp(env, d, g):
    """The reference's lookup and the gradients of <lookup, g> with
    respect to the map and the three direction components."""
    def f(e, x, y, z):
        out = jshade.envmap_lookup_v(e, JVec3(x, y, z))
        return jnp.stack([out.x, out.y, out.z])

    out, vjp = jax.vjp(f, jnp.asarray(env), *[jnp.asarray(a) for a in d])
    return np.asarray(out), [np.asarray(a) for a in vjp(jnp.asarray(g))]


def _reference_coords(d, h, w):
    """The reference's texel coordinates (fovtrace/render/shade.py:52-59),
    op by op as `_jax_vjp` runs them."""
    def f(x, y, z):
        theta = jnp.arctan2(x, z)
        phi = jnp.pi * 0.5 - jnp.arccos(jnp.clip(y, -1.0, 1.0))
        u = (theta + jnp.pi) * (0.5 / jnp.pi)
        v = 0.5 * (1.0 + jnp.sin(phi))
        return u * (w - 1), (1.0 - v) * (h - 1)

    return [np.asarray(a) for a in f(*[jnp.asarray(a) for a in d])]


@pytest.mark.parametrize("name", list(MAPS))
def test_lookup_matches_reference(name):
    """The lookup against the reference's quad-table gather, special
    directions included (NaN where it has NaN). PyTorch's atan2, acos and
    sin round differently from XLA's (ROADMAP section 3, item 2): the
    port's texel coordinates are within 2^-22 (w - 1) and 2^-22 (h - 1)
    of the reference's (2 ulp of u and v), the Function at the
    reference's coordinates is within the rows' tolerance on every lane,
    and the port's lookup on every lane whose coordinates are the
    reference's bits."""
    env, d = _map(name), _dirs()
    h, w = MAPS[name]
    want, _ = _jax_vjp(env, d, np.zeros((3, N), np.float32))
    assert np.isnan(want[:, 5]).all()            # the NaN direction
    jx, jy = _reference_coords(d, h, w)
    fx, fy = shade.envmap_texel_coords(Vec3(*torch.tensor(d)), h, w)
    for got, ref, size in ((fx.numpy(), jx, w), (fy.numpy(), jy, h)):
        np.testing.assert_allclose(got, ref, rtol=0,
                                   atol=2.0 ** -22 * (size - 1))
    at_ref = envmap.EnvmapLookup.apply(torch.tensor(jx), torch.tensor(jy),
                                       torch.tensor(env), 2.0)
    np.testing.assert_allclose(at_ref.numpy(), want, rtol=ROWS_RTOL,
                               atol=ROWS_ATOL)
    _, got = _port(env, d)
    same = (fx.numpy() == jx) & (fy.numpy() == jy) | np.isnan(jx)
    assert same.mean() > 0.3, same.mean()
    np.testing.assert_allclose(got.numpy()[:, same], want[:, same],
                               rtol=ROWS_RTOL, atol=ROWS_ATOL)


@pytest.mark.parametrize("name", list(MAPS))
def test_coordinates_reach_the_edges(name):
    """The special directions put fx exactly on 0 and w - 1 (the seam)
    and fy exactly on 0 and h - 1 (the poles), where the taps clamp."""
    h, w = MAPS[name]
    d = torch.tensor(SPECIAL)
    fx, fy = shade.envmap_texel_coords(Vec3(*d), h, w)
    assert float(fx[2]) == w - 1 and float(fx[3]) == 0.0, fx
    assert float(fy[0]) == 0.0 and float(fy[1]) == h - 1, fy
    assert bool(torch.isnan(fx[5]))


@pytest.mark.parametrize("name", list(MAPS))
def test_gradients_match_jax_vjp(name):
    """d map and d directions of <lookup, g> against jax.vjp, on unit
    directions and the special ones whose derivative is finite in both
    (the seam, the equator's axes); at the poles acos has an infinite
    slope and the reference's clip splits it at the bound, and atan2 has
    no derivative at a zero direction, nor has a nonfinite one. The map's
    gradient is taken at the reference's texel coordinates: a map entry
    sums its rays' terms, whose weights move with the coordinates'
    rounding (test_lookup_matches_reference) and may cancel. A lane's
    direction gradient adds terms of either sign through atan2 and acos,
    so its absolute floor is 1e-6 of the largest lane's, as for the
    camera inverse's adjoint (tests/test_torch_grad.py); the four-gather
    expression's autograd misses the bare 1e-7 on 2 lanes of the 64x128
    map too, and gives the Function's bits
    (test_direction_gradients_equal_the_four_gather_expressions)."""
    env, g = _map(name), _cotangent()
    h, w = MAPS[name]
    d = _dirs()
    keep = np.r_[SMOOTH, SPECIAL.shape[1]:N]
    d, g = d[:, keep], g[:, keep]
    _, (jenv, *jd) = _jax_vjp(env, d, g)
    leaves, out = _port(env, d, requires_grad=True)
    out.backward(torch.tensor(g))
    for t, want in zip(leaves[1:], jd):
        np.testing.assert_allclose(t.grad.numpy(), want, rtol=GRAD_RTOL,
                                   atol=1e-6 * np.abs(want).max())
    jx, jy = (torch.tensor(a) for a in _reference_coords(d, h, w))
    leaf = torch.tensor(env, requires_grad=True)
    envmap.EnvmapLookup.apply(jx, jy, leaf, 2.0).backward(torch.tensor(g))
    np.testing.assert_allclose(leaf.grad.numpy(), jenv, rtol=GRAD_RTOL,
                               atol=GRAD_ATOL)


def _four_gather_lookup(envmap_t, dirs, scale=2.0):
    """The render path's lookup before the Function: four row gathers
    and the bilerp with mathx.fma."""
    theta = torch.atan2(dirs.x, dirs.z)
    phi = math.pi * 0.5 - torch.acos(torch.clamp(dirs.y, -1.0, 1.0))
    u = (theta + math.pi) * (0.5 / math.pi)
    v = 0.5 * (1.0 + torch.sin(phi))
    h, w = envmap_t.shape[0], envmap_t.shape[1]
    fx = u * (w - 1)
    fy = (1.0 - v) * (h - 1)
    x0 = torch.clamp(torch.floor(fx).to(torch.int64), 0, w - 1)
    y0 = torch.clamp(torch.floor(fy).to(torch.int64), 0, h - 1)
    wx = fx - x0
    wy = fy - y0
    x1 = torch.clamp_max(x0 + 1, w - 1)
    y1 = torch.clamp_max(y0 + 1, h - 1)
    flat = envmap_t.reshape(-1, 3)
    c00, c01 = flat[y0 * w + x0], flat[y0 * w + x1]
    c10, c11 = flat[y1 * w + x0], flat[y1 * w + x1]

    def bilerp(k):
        top = mathx.fma(c00[:, k], 1 - wx, c01[:, k] * wx)
        bottom = mathx.fma(c10[:, k], 1 - wx, c11[:, k] * wx)
        return mathx.fma(top, 1 - wy, bottom * wy)

    return Vec3(bilerp(0), bilerp(1), bilerp(2)) * scale


@pytest.mark.parametrize("name", list(MAPS))
def test_forward_equals_the_four_gather_expression(name):
    """The Function's CPU forward gives the bits of the expression it
    replaced (NaN where it has NaN)."""
    env, d = _map(name), _dirs(seed=4)
    want = torch.stack(list(_four_gather_lookup(
        torch.tensor(env), Vec3(*torch.tensor(d)))))
    _, got = _port(env, d)
    nan = torch.isnan(want)
    assert torch.equal(nan, torch.isnan(got))
    assert torch.equal(got[~nan], want[~nan])


@pytest.mark.parametrize("name", list(MAPS))
def test_direction_gradients_equal_the_four_gather_expressions(name):
    """On the CPU, d directions through the Function are the bits that
    autograd gave through the four-gather expression (dxy_plain adds the
    same float32 products in autograd's order)."""
    env, d, g = _map(name), _dirs(seed=9, special=False), _cotangent(10)
    grads = []
    for fn in (shade.envmap_lookup_v, _four_gather_lookup):
        leaves = [torch.tensor(a, requires_grad=True) for a in d]
        out = fn(torch.tensor(env), Vec3(*leaves))
        torch.autograd.backward(list(out), list(torch.tensor(g)))
        grads.append([t.grad for t in leaves])
    for a, b in zip(*grads):
        assert torch.equal(a, b)


def test_function_passes_gradcheck():
    """float64 gradcheck of EnvmapLookup in fx, fy and the map (the
    coordinates away from integers, where floor jumps; some clamped at
    each edge)."""
    r = np.random.default_rng(3)
    h, w = 5, 7
    fx = r.uniform(-1.5, w + 0.5, size=48)
    fy = r.uniform(-1.5, h + 0.5, size=48)
    fx, fy = (np.floor(a) + np.clip(a - np.floor(a), 0.1, 0.9)
              for a in (fx, fy))
    args = [torch.tensor(a, dtype=torch.float64, requires_grad=True)
            for a in (fx, fy, r.normal(size=(h, w, 3)))]
    assert torch.autograd.gradcheck(
        lambda x, y, e: envmap.EnvmapLookup.apply(x, y, e, 2.0), args)


def test_backward_runs_give_equal_bits():
    env, d, g = _map("64x128"), _dirs(seed=5, special=False), _cotangent(6)
    grads = []
    for _ in range(2):
        leaves, out = _port(env, d, requires_grad=True)
        out.backward(torch.tensor(g))
        grads.append([t.grad for t in leaves])
    for a, b in zip(*grads):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))


def test_adjoint_sums_each_tap_into_its_texel():
    """Two rays on a 2x3 map: one inside, one on the last column, whose
    two x taps are one texel (it gets both weights)."""
    fx = torch.tensor([0.25, 2.0])
    fy = torch.tensor([0.5, 0.0])
    g = torch.tensor([[1.0, 4.0], [0.0, 0.0], [2.0, 0.0]])
    got = envmap.adjoint(fx, fy, g, 2, 3, 1.0)
    want = torch.zeros(2, 3, 3)
    want[0, 0] = torch.tensor([0.375, 0.0, 0.75])     # (1 - .25)(1 - .5)
    want[0, 1] = torch.tensor([0.125, 0.0, 0.25])     # .25 (1 - .5)
    want[1, 0] = torch.tensor([0.375, 0.0, 0.75])
    want[1, 1] = torch.tensor([0.125, 0.0, 0.25])
    want[0, 2] = torch.tensor([4.0, 0.0, 0.0])        # wx = 0: x1 = x0
    assert torch.equal(got, want), got


def test_no_map_gradient_runs_no_adjoint():
    """With only the directions requiring a gradient (the bench's
    fwd+bwd step), the backward gives d fx, d fy and runs no adjoint."""
    env, d, g = _map("8x16"), _dirs(seed=7, special=False), _cotangent(8)
    kernels.CALLS.clear()
    leaves = [torch.tensor(env)] + [torch.tensor(a, requires_grad=True)
                                    for a in d]
    out = shade.envmap_lookup_v(leaves[0], Vec3(*leaves[1:]))
    torch.autograd.backward(list(out), list(torch.tensor(g)))
    assert envmap.counters() == {
        "envmap_lookup": 0, "envmap_dxy": 0, "envmap_adjoint": 0,
        "envmap_lookup_plain": 1, "envmap_dxy_plain": 1,
        "envmap_adjoint_plain": 0}
    assert all(float(t.grad.abs().sum()) > 0 for t in leaves[1:])
    assert {k: ci.counters()[k] for k in envmap.COUNTED} == \
        envmap.counters()


def test_map_gradient_alone_runs_no_dxy():
    env, d, g = _map("8x16"), _dirs(seed=7, special=False), _cotangent(8)
    kernels.CALLS.clear()
    leaves, out = _port(env, d)
    leaves[0].requires_grad_(True)
    out = torch.stack(list(shade.envmap_lookup_v(leaves[0],
                                                 Vec3(*leaves[1:]))))
    out.backward(torch.tensor(g))
    got = envmap.counters()
    assert got["envmap_adjoint_plain"] == 1 and got["envmap_dxy_plain"] == 0
    assert float(leaves[0].grad.abs().sum()) > 0


def _train_setup(remat=False):
    scene = procedural.box_scene("cpu")
    cam = Camera.create(eye=(3.0, 2.0, 4.0), target=(0.0, 0.5, 0.0),
                        device="cpu")
    cfg = RenderConfig(width=16, height=16, max_depth=2, diffuse_max_depth=1,
                       remat_shade=remat)
    params = train.init_params(scene, cam)
    params = params.replace(envmap=torch.tensor(_map("8x16")))
    return scene, cam, cfg, train.leaves(params)


@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
def test_train_step_goes_through_the_function(remat):
    """A dense train step's bounces look the map up through the Function
    (its plain versions on the CPU) and train it through the adjoint; with
    remat_shade each bounce's lookup runs again in the backward, and the
    gradients are the same bits."""
    grads, calls = {}, {}
    for r in sorted({False, remat}):
        scene, cam, cfg, params = _train_setup(r)
        mesh = shd.make_mesh(1, "cpu")
        target = torch.zeros(cfg.height, cfg.width, 3)
        kernels.CALLS.clear()
        _, g = train.make_loss_and_grad(scene, cam, cfg, mesh)(params,
                                                               target, 0)
        grads[r], calls[r] = g, envmap.counters()
    got = calls[remat]
    assert got["envmap_lookup"] == got["envmap_adjoint"] == 0
    assert got["envmap_lookup_plain"] == \
        cfg.max_depth * (2 if remat else 1), got
    assert got["envmap_adjoint_plain"] == cfg.max_depth, got
    assert got["envmap_dxy_plain"] == cfg.max_depth, got   # eye, target
    assert float(grads[remat].envmap.abs().sum()) > 0
    for a, b in zip(grads[remat].tensors(), grads[False].tensors()):
        assert torch.equal(a, b)


@pytest.mark.parametrize("bad", ["float16", "int64 g", "meta", "mixed",
                                 "strided", "2-d fx", "fy length",
                                 "map shape", "g shape", "empty map"])
def test_wrappers_refuse_what_the_kernels_do_not_take(bad):
    fx, fy = torch.rand(6) * 3, torch.rand(6) * 2
    env, g = torch.zeros(3, 4, 3), torch.zeros(3, 6)
    err = ValueError
    if bad == "float16":
        fx, fy = fx.half(), fy.half()
        err = TypeError
    elif bad == "int64 g":
        g = g.long()
        err = TypeError
    elif bad == "meta":
        fx, fy, env, g = (t.to("meta") for t in (fx, fy, env, g))
    elif bad == "mixed":
        env, g = env.to("meta"), g.to("meta")
    elif bad == "strided":
        fx = torch.rand(12)[::2]
    elif bad == "2-d fx":
        fx, fy = fx[None], fy[None]
    elif bad == "fy length":
        fy = fy[:5]
    elif bad == "map shape":
        env = torch.zeros(3, 4, 4)
    elif bad == "g shape":
        g = torch.zeros(6, 3)
    elif bad == "empty map":
        env = torch.zeros(0, 4, 3)
    if bad not in ("int64 g", "g shape"):
        with pytest.raises(err):
            envmap.lookup(fx, fy, env, 2.0)
    if bad not in ("map shape",):
        with pytest.raises(err):
            envmap.dxy(fx, fy, env, g, 2.0)
        if bad != "empty map":
            with pytest.raises(err):
                envmap.adjoint(fx, fy, g, env.shape[0], env.shape[1], 2.0)


def test_plain_versions_on_the_cpu():
    """On CPU tensors the wrappers run the plain versions and count them;
    no kernel launch is counted; no rays give an empty block."""
    fx, fy, env = torch.rand(10) * 15, torch.rand(10) * 7, torch.rand(8, 16, 3)
    kernels.CALLS.clear()
    out = envmap.lookup(fx, fy, env, 2.0)
    envmap.dxy(fx, fy, env, torch.ones(3, 10), 2.0)
    envmap.adjoint(fx, fy, torch.ones(3, 10), 8, 16, 2.0)
    assert out.shape == (3, 10)
    assert envmap.counters() == {
        "envmap_lookup": 0, "envmap_dxy": 0, "envmap_adjoint": 0,
        "envmap_lookup_plain": 1, "envmap_dxy_plain": 1,
        "envmap_adjoint_plain": 1}
    empty = torch.zeros(0)
    assert envmap.lookup(empty, empty, env, 2.0).shape == (3, 0)
    assert not envmap.adjoint(empty, empty, torch.zeros(3, 0), 8, 16,
                              2.0).any()


def test_scratch_size_matches_the_source():
    """The wrapper's scratch per map entry: the source's 64-bit sum and
    32-bit max."""
    text = CSRC.read_text()
    assert "unsigned long long* sum = (unsigned long long*)scratch;" in text
    assert "unsigned* mx = (unsigned*)(sum + entries);" in text
    assert "12 * (size_t)entries" in text
    assert envmap.SCRATCH_BYTES == 8 + 4 == 12


def test_c_signatures_match_the_source():
    """Each C entry point's parameters in csrc/envmap.cu: a pointer for
    each void*, a float for each float, an int for each int."""
    text = CSRC.read_text().split('extern "C" {', 1)[1]
    kinds = {"void": ctypes.c_void_p, "float": ctypes.c_float,
             "int": ctypes.c_int}
    found = {}
    for name, params in re.findall(r"int (fov_\w+)\(([^)]*)\)", text):
        found[name] = [ctypes.c_void_p if "*" in p else
                       kinds[p.split()[0]] for p in params.split(",")]
    assert found == {k: a for k, (a, _) in envmap.c_signatures().items()}


class _Lib:
    """Stands in for the envmap library: records each entry point's
    arguments."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        return lambda *args: self.calls.append((name, args)) or 0


@pytest.mark.parametrize("kind", ["lookup", "dxy", "adjoint"])
def test_launch_arguments_fit_the_c_entry_points(kind, monkeypatch):
    """`_launch` passes each C entry point its pointers, n, h, w, the
    scale and the stream, as many as its ctypes signature has, and counts
    the launch. CPU tensors, a stand-in library."""
    lib = _Lib()
    monkeypatch.setattr(envmap, "load_cuda_library", lambda: lib)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: type("S", (), {"cuda_stream": 0}))
    n, h, w = 1000, 8, 16
    fx, fy = torch.zeros(n), torch.zeros(n)
    tensors = {"lookup": (fx, fy, torch.zeros(h, w, 3), torch.zeros(3, n)),
               "dxy": (fx, fy, torch.zeros(h, w, 3), torch.zeros(3, n),
                       torch.zeros(n), torch.zeros(n)),
               "adjoint": (fx, fy, torch.zeros(3, n),
                           torch.zeros(envmap.SCRATCH_BYTES * 3 * h * w,
                                       dtype=torch.uint8),
                           torch.zeros(h, w, 3))}[kind]
    kernels.CALLS.clear()
    envmap._launch(f"envmap_{kind}", tensors, (n, h, w), 2.0)
    (name, args), = lib.calls
    assert name == f"fov_envmap_{kind}"
    argtypes, _ = envmap.c_signatures()[name]
    assert len(args) == len(argtypes)
    assert list(args[:len(tensors)]) == [t.data_ptr() for t in tensors]
    assert args[len(tensors):] == (n, h, w, 2.0, 0)
    assert envmap.counters()[f"envmap_{kind}"] == 1
