"""The port's backward pass against the JAX reference: the goldens'
gradient fingerprints (rtol 2e-3, tests/test_golden.py), port gradients
against jax.grad elementwise (rtol 2e-3, the cases of tests/test_grad.py),
a finite-difference check of a vertex translation (rtol 1e-1, as the
reference's), remat_shade bit for bit, and the gather adjoints of the
compaction primitives against the reference's custom_vjp."""

import os

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from fovtrace import Camera as JCamera  # noqa: E402
from fovtrace import RenderConfig as JRenderConfig  # noqa: E402
from fovtrace.core import rng as jrng  # noqa: E402
from fovtrace.kernels import sampling as jsampling  # noqa: E402
from fovtrace.render import pipeline as jpipeline  # noqa: E402
from fovtrace.render import shade as jshade  # noqa: E402
from fovtrace.scene import procedural as jprocedural  # noqa: E402
from fovtrace_torch import Camera, RenderConfig, kernels  # noqa: E402
from fovtrace_torch.core import camera as camera_mod  # noqa: E402
from fovtrace_torch.core import rng, vec  # noqa: E402
from fovtrace_torch.kernels import cluster_isect as ci  # noqa: E402
from fovtrace_torch.kernels import sampling  # noqa: E402
from fovtrace_torch.render import pipeline, shade  # noqa: E402
from fovtrace_torch.scene import procedural  # noqa: E402

GOLDEN_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "golden")
GOLDEN_KW = dict(width=64, height=64, reconstruction="atrous", max_depth=3,
                 diffuse_max_depth=1, ray_budget_frac=0.6)
EYE, TARGET = (3.0, 2.5, 4.0), (0.0, 0.8, 0.0)
# tests/test_grad.py's scene, camera and shade configuration
SHADE_EYE, SHADE_TARGET = (3.0, 2.0, 4.0), (0.0, 0.5, 0.0)
SHADE_KW = dict(width=16, height=16, max_depth=2, diffuse_max_depth=1)


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    # the suite runs in several worker processes at once; PyTorch's
    # default of one thread per core then oversubscribes the CPU, and its
    # spinning thread pool runs such a frame ~40x slower than at 2 threads
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _fingerprint(g):
    return np.asarray([f(g[k]) for k in ("emission", "kd", "eye")
                       for f in (lambda t: float(t.norm()),
                                 lambda t: float(t.mean()))])


# ------------------------------------------------------- golden fingerprints
@pytest.mark.parametrize(
    "name", [n if n in ("box", "earth") else
             pytest.param(n, marks=pytest.mark.slow)
             for n in ("box", "earth", "bunny", "multi", "vokselia")])
def test_golden_grad_fingerprint(name):
    """The golden's loss: mean image of one 64x64 frame started from the
    differentiated camera, with respect to emission, kd and eye."""
    ref = np.load(os.path.join(GOLDEN_DIR, f"{name}.npz"))
    scene = procedural.SCENES[name]("cpu")
    cam = Camera.create(eye=EYE, target=TARGET, device="cpu")
    _, g, out = pipeline.grad_step(scene, cam, (32, 32), None,
                                   RenderConfig(**GOLDEN_KW))
    assert int(out["ray_count"]) == int(ref["ray_count"])
    np.testing.assert_allclose(_fingerprint(g), ref["grad_fp"], rtol=2e-3,
                               atol=1e-7)


# ------------------------------------------------- gradients vs jax.grad
@pytest.fixture(scope="module")
def box_pair():
    return jprocedural.box_scene(), procedural.box_scene("cpu")


def _port_shade_loss(scene, config, cam):
    _, rd = cam.primary_rays_v(16, 16)
    rd = rd.map(lambda a: a.reshape(-1))
    ro = vec.splat(cam.eye, rd.shape)
    seeds = rng.pixel_seed(torch.arange(256), 0)
    radiance, _ = shade.shade_v(scene, ro, rd, seeds, config)
    return vec.mean_reduce(radiance)


def _jax_shade_loss(scene, config, cam):
    ro, rd = cam.primary_rays(16, 16)
    seeds = jrng.pixel_seed(jnp.arange(256), 0)
    radiance, _ = jshade.shade(scene, ro.reshape(-1, 3), rd.reshape(-1, 3),
                               seeds, config)
    return jnp.mean(radiance)


def _shade_case(param, js, ps):
    """(jax loss of x, its x, port loss of x, its x) for one parameter."""
    jc = JCamera.create(eye=SHADE_EYE, target=SHADE_TARGET)
    pc = Camera.create(eye=SHADE_EYE, target=SHADE_TARGET, device="cpu")
    jcfg, pcfg = JRenderConfig(**SHADE_KW), RenderConfig(**SHADE_KW)
    if param == "emission":
        return (lambda x: _jax_shade_loss(js.replace(
                    light=js.light.replace(emission=x)), jcfg, jc),
                js.light.emission,
                lambda x: _port_shade_loss(ps.replace(
                    light=ps.light.replace(emission=x)), pcfg, pc),
                ps.light.emission)
    if param == "kd":
        return (lambda x: _jax_shade_loss(js.replace(
                    materials=js.materials.replace(kd=x)), jcfg, jc),
                js.materials.kd,
                lambda x: _port_shade_loss(ps.replace(
                    materials=ps.materials.replace(kd=x)), pcfg, pc),
                ps.materials.kd)
    if param == "envmap":
        return (lambda x: _jax_shade_loss(js.replace(envmap=js.envmap * x),
                                          jcfg, jc),
                jnp.asarray(1.0),
                lambda x: _port_shade_loss(ps.replace(envmap=ps.envmap * x),
                                           pcfg, pc),
                torch.tensor(1.0))
    return (lambda x: _jax_shade_loss(js, jcfg, jc.replace(eye=x)), jc.eye,
            lambda x: _port_shade_loss(ps, pcfg, pc.replace(eye=x)), pc.eye)


def _port_grad(f, x):
    x = x.detach().clone().requires_grad_(True)
    f(x).backward()
    return x.grad.numpy()


@pytest.mark.parametrize("param", ["emission", "kd", "envmap", "eye"])
def test_shade_grad_matches_jax(param, box_pair):
    """tests/test_grad.py's _loss_through_shade (16x16 box, max_depth 2):
    the port's gradient equals jax.grad's elementwise."""
    jf, jx, pf, px = _shade_case(param, *box_pair)
    want = np.asarray(jax.jit(jax.grad(jf))(jx))
    got = _port_grad(pf, px)
    assert np.abs(want).sum() > 0
    np.testing.assert_allclose(got, want, rtol=2e-3, atol=1e-7)


def test_full_pipeline_grad_matches_jax(box_pair):
    """tests/test_grad.py's full-pipeline case: a 32x32 pull-push frame,
    the emission gradient of its mean image, elementwise."""
    js, ps = box_pair
    kw = dict(width=32, height=32, max_depth=2, reconstruction="pullpush",
              ray_budget_frac=0.8)
    jc = JCamera.create(eye=SHADE_EYE, target=SHADE_TARGET)
    pc = Camera.create(eye=SHADE_EYE, target=SHADE_TARGET, device="cpu")
    jcfg, pcfg = JRenderConfig(**kw), RenderConfig(**kw)
    jst = jpipeline.FrameState.initial(jc, jcfg)
    pst = pipeline.FrameState.initial(pc, pcfg)

    def jf(emission):
        s = js.replace(light=js.light.replace(emission=emission))
        out, _ = jpipeline.render_frame(s, jc, (jnp.asarray(16),
                                                jnp.asarray(16)), jst, jcfg)
        return jnp.mean(out["image"])

    def pf(emission):
        s = ps.replace(light=ps.light.replace(emission=emission))
        out, _ = pipeline.render_frame(s, pc, (16, 16), pst, pcfg)
        return vec.mean_reduce(out["image_rgb"])

    want = np.asarray(jax.jit(jax.grad(jf))(js.light.emission))
    got = _port_grad(pf, ps.light.emission)
    assert np.isfinite(got).all() and np.abs(got).sum() > 0
    np.testing.assert_allclose(got, want, rtol=2e-3, atol=1e-7)


def test_vertex_translation_grad_fd():
    """The radiance gradient of a rigid translation of every triangle's
    first vertex (brute force re-intersects the moved geometry; hit ids
    carry no gradient) against central differences, at the reference's
    rtol 1e-1 (tests/test_grad.py)."""
    scene = procedural.box_scene("cpu")
    cam = Camera.create(eye=SHADE_EYE, target=SHADE_TARGET, device="cpu")
    cfg = RenderConfig(**SHADE_KW, intersect_backend="brute")

    def f(delta):
        return _port_shade_loss(scene.replace(v0=scene.v0 + delta), cfg, cam)

    g = _port_grad(f, torch.zeros(3))
    eps = 2e-3
    fd = np.zeros(3)
    with torch.no_grad():
        for i in range(3):
            d = torch.zeros(3)
            d[i] = eps
            fd[i] = (float(f(d)) - float(f(-d))) / (2 * eps)
    np.testing.assert_allclose(g, fd, rtol=1e-1, atol=1e-4)
    assert np.abs(g).sum() > 0


# -------------------------------------------------------------- remat_shade
def test_remat_shade_is_bit_for_bit():
    """Recomputing each bounce in the backward pass gives the same
    gradients bit for bit, and runs every bounce's cluster kernels (here
    their plain versions) once more."""
    scene = procedural.earth_scene("cpu")
    cam = Camera.create(eye=EYE, target=TARGET, device="cpu")
    cfg = RenderConfig(**GOLDEN_KW)
    grads, calls = {}, {}
    for remat in (False, True):
        ci.reset_counters()
        _, grads[remat], _ = pipeline.grad_step(
            scene, cam, (32, 32), None, cfg.replace(remat_shade=remat))
        calls[remat] = ci.counters()
    for k in pipeline.GRAD_PARAMS:
        assert torch.equal(grads[True][k], grads[False][k]), k
    for k in ("closest_hit_plain", "occlusion_plain"):
        assert calls[True][k] == calls[False][k] + cfg.max_depth, calls


def test_grad_step_holds_the_state_constant():
    """A state that carries an earlier step's graph is detached: the
    gradients equal those from the detached state, and nothing flows back
    into the earlier frame's leaves."""
    scene = procedural.box_scene("cpu")
    cam = Camera.create(eye=EYE, target=TARGET, device="cpu")
    cfg = RenderConfig(width=32, height=32, max_depth=2,
                       reconstruction="pullpush")
    eye = cam.eye.clone().requires_grad_(True)
    c_graph = cam.replace(eye=eye)
    _, st = pipeline.render_frame(scene, c_graph, (16, 16),
                                  pipeline.FrameState.initial(c_graph, cfg),
                                  cfg)
    assert st.history.grad_fn is not None
    _, g1, out = pipeline.grad_step(scene, cam, (16, 16), st, cfg)
    _, g2, _ = pipeline.grad_step(scene, cam, (16, 16), st.detach(), cfg)
    assert eye.grad is None
    for k in pipeline.GRAD_PARAMS:
        assert torch.equal(g1[k], g2[k]), k
    assert all(t.grad_fn is None for t in out.values()
               if isinstance(t, torch.Tensor))


def test_camera_inverse_adjoint_matches_jax():
    """inv4's adjoint is the reference's (a transposed solve on the LU
    factors), and each inverse with grad costs two host round trips."""
    jc = JCamera.create(eye=EYE, target=TARGET)
    m = np.asarray(jc.mvp(1.0), np.float32)
    gbar = np.random.default_rng(3).normal(size=(4, 4)).astype(np.float32)
    want = np.asarray(jax.grad(lambda a: jnp.sum(jnp.linalg.inv(a)
                                                 * gbar))(jnp.asarray(m)))
    a = torch.tensor(m, requires_grad=True)
    kernels.CALLS.clear()
    (camera_mod.inv4(a) * torch.tensor(gbar)).sum().backward()
    assert kernels.CALLS["inv4_host"] == 2
    np.testing.assert_allclose(a.grad.numpy(), want, rtol=1e-5,
                               atol=1e-6 * np.abs(want).max())


# ------------------------------------------------------ the gather adjoints
def _compaction(seed, n=97, budget=40, density=0.55):
    """A stable compaction of a seeded random mask into a budget that
    drops its tail: (mask, idx, active, rank, gate) as int64 / bool."""
    mask = torch.as_tensor(np.random.default_rng(seed).random(n) < density)
    idx, active, rank, gate = sampling.compact_mask_rank(mask, budget)
    return mask, idx, active, rank, gate


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_gather_adjoints_match_jax_custom_vjp(seed):
    """Both Functions' backward equal the reference's custom_vjp on the
    same random compaction (dropped lanes and unfilled slots included)."""
    mask, idx, active, rank, gate = _compaction(seed, density=0.3 + 0.2 * seed)
    r = np.random.default_rng(10 + seed)
    n, b, c = mask.shape[0], idx.shape[0], 5
    f32 = lambda t: jnp.asarray(t.numpy().astype(np.float32))
    rows_b = r.normal(size=(b, c)).astype(np.float32)
    ct_n = r.normal(size=(n, c)).astype(np.float32)
    rows_n = r.normal(size=(n, c)).astype(np.float32)
    ct_b = r.normal(size=(b, c)).astype(np.float32)

    out, vjp = jax.vjp(lambda x: jsampling.expand_by_rank(
        x, f32(rank), f32(gate), f32(idx), f32(active)), jnp.asarray(rows_b))
    x = torch.tensor(rows_b, requires_grad=True)
    got = sampling.expand_by_rank(x, rank, gate, idx, active)
    got.backward(torch.tensor(ct_n))
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(out))
    np.testing.assert_array_equal(x.grad.numpy(),
                                  np.asarray(vjp(jnp.asarray(ct_n))[0]))

    out, vjp = jax.vjp(lambda x: jsampling.compact_gather(
        x, f32(idx), f32(rank), f32(gate)), jnp.asarray(rows_n))
    x = torch.tensor(rows_n, requires_grad=True)
    got = sampling.compact_gather(x, idx, rank, gate)
    got.backward(torch.tensor(ct_b))
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(out))
    np.testing.assert_array_equal(x.grad.numpy(),
                                  np.asarray(vjp(jnp.asarray(ct_b))[0]))


def test_gather_adjoints_pass_gradcheck():
    """float64 gradcheck of both Functions. Slots past the compacted
    count read row 0 in compact_gather's forward but send nothing back,
    so its check runs on a budget the mask fills."""
    _, idx, active, rank, gate = _compaction(4, n=23, budget=8)
    rows = torch.randn(8, 3, dtype=torch.float64, requires_grad=True)
    assert torch.autograd.gradcheck(
        lambda x: sampling.expand_by_rank(x, rank, gate, idx, active),
        (rows,))
    _, idx, active, rank, gate = _compaction(5, n=23, budget=12,
                                             density=0.8)
    assert bool(active.all())
    rows = torch.randn(23, 3, dtype=torch.float64, requires_grad=True)
    assert torch.autograd.gradcheck(
        lambda x: sampling.compact_gather(x, idx, rank, gate), (rows,))


def test_gather_adjoints_scatter_nothing():
    """The backward of both Functions is a gather: no index_put, index_add
    or scatter runs in it."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Ops(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.names = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.names.append(func.__name__)
            return func(*args, **(kwargs or {}))

    _, idx, active, rank, gate = _compaction(6)
    for fn, rows in ((lambda x: sampling.expand_by_rank(x, rank, gate, idx,
                                                        active),
                      torch.randn(idx.shape[0], 4, requires_grad=True)),
                     (lambda x: sampling.compact_gather(x, idx, rank, gate),
                      torch.randn(rank.shape[0], 4, requires_grad=True))):
        out = fn(rows)
        with Ops() as ops:
            out.backward(torch.ones_like(out))
        assert ops.names and not [n for n in ops.names if any(
            s in n for s in ("index_put", "index_add", "scatter"))], ops.names
