"""The port's inverse-rendering train step (fovtrace_torch.dist.train)
against the JAX package's: the dense and foveated row renders on box at
32x32 (the whole frame and a row block), the gaze-gradient cases of
tests/test_grad.py, a 2-rank train step's loss and gradients against
`make_train_step`'s on a 2-device mesh, the Adam update against
optax.adam, the training rays (`Camera.primary_rays_block`), and the
parameters carried across from the JAX package's arrays."""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

import torch_dist_ranks as tdr  # noqa: E402
from fovtrace import Camera as JCamera  # noqa: E402
from fovtrace import RenderConfig as JRenderConfig  # noqa: E402
from fovtrace.dist import sharding as jshd  # noqa: E402
from fovtrace.dist import train as jtrain  # noqa: E402
from fovtrace.scene import procedural as jprocedural  # noqa: E402
from fovtrace_torch import Camera, RenderConfig, convert  # noqa: E402
from fovtrace_torch.dist import sharding as shd  # noqa: E402
from fovtrace_torch.dist import train  # noqa: E402
from fovtrace_torch.scene import procedural  # noqa: E402

# tests/test_grad.py's gaze environment
GAZE_KW = dict(width=32, height=32, max_depth=2, diffuse_max_depth=1,
               aperture=0.2, p_min=0.05)
GAZE_EYE, GAZE_TARGET = (3.0, 2.0, 4.0), (0.0, 0.5, 0.0)
TRUE_GAZE, START_GAZE = (0.62, 0.41), (0.45, 0.55)
# port against jitted reference, the rows of a render: measured max
# |err| 6.6e-7 (box, 32x32, every case below)
ROWS_RTOL, ROWS_ATOL = 1e-5, 2e-6
# tests/test_torch_grad.py's tolerance for tests/test_grad.py's cases
GRAD_RTOL, GRAD_ATOL = 2e-3, 1e-7
FIELDS = ("eye", "target", "gaze_uv", "light_emission", "kd", "envmap")


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    # the suite runs in several worker processes at once; PyTorch's
    # default of one thread per core then oversubscribes the CPU
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def env():
    js, ps = jprocedural.box_scene(), procedural.box_scene("cpu")
    jc = JCamera.create(eye=GAZE_EYE, target=GAZE_TARGET)
    pc = Camera.create(eye=GAZE_EYE, target=GAZE_TARGET, device="cpu")
    return js, ps, jc, pc, JRenderConfig(**GAZE_KW), RenderConfig(**GAZE_KW)


def _jparams(js, jc, gaze):
    return jtrain.init_params(js, jc)._replace(
        gaze_uv=jnp.asarray(gaze, jnp.float32))


def _pparams(ps, pc, gaze):
    return train.init_params(ps, pc).replace(gaze_uv=torch.tensor(gaze))


def _renders(mode):
    if mode == "dense":
        return (lambda *a, soft: jtrain.render_rows_dense(*a),
                lambda *a, soft: train.render_rows_dense(*a))
    return jtrain.render_rows_foveated, train.render_rows_foveated


@pytest.mark.parametrize("block", [(0, 32), (8, 8)], ids=["frame", "y0_8"])
@pytest.mark.parametrize("mode", ["dense", "soft", "hard"])
def test_rows_match_jax(mode, block, env):
    """render_rows_dense and render_rows_foveated (soft, hard) for the
    whole frame and for rows [8, 16), against the jitted reference."""
    js, ps, jc, pc, jcfg, pcfg = env
    y0, bh = block
    jf, pf = _renders(mode)
    soft = mode == "soft"
    want = np.asarray(jax.jit(lambda p: jf(
        js, jc, p, y0, bh, jcfg, jnp.asarray(0, jnp.int32), soft=soft))(
            _jparams(js, jc, START_GAZE)))
    got = pf(ps, pc, _pparams(ps, pc, START_GAZE), y0, bh, pcfg, 0,
             soft=soft)
    assert got.shape == (bh, 32, 3)
    np.testing.assert_allclose(got.numpy(), want, rtol=ROWS_RTOL,
                               atol=ROWS_ATOL)


# ------------------------------------------- tests/test_grad.py's gaze cases
@pytest.fixture(scope="module")
def gaze_env(env):
    """The target: the soft foveated frame at the true gaze (the
    reference's, carried across as numpy)."""
    js, ps, jc, pc, jcfg, pcfg = env
    target = np.array(jax.jit(lambda p: jtrain.render_rows_foveated(
        js, jc, p, 0, 32, jcfg, jnp.asarray(0, jnp.int32), soft=True))(
            _jparams(js, jc, TRUE_GAZE)))
    return env, target


def _port_gaze_loss(env, target, gaze, soft):
    _, ps, _, pc, _, pcfg = env
    img = train.render_rows_foveated(ps, pc, _pparams(ps, pc, TRUE_GAZE)
                                     .replace(gaze_uv=gaze), 0, 32, pcfg, 0,
                                     soft=soft)
    return torch.mean((img - torch.as_tensor(target)) ** 2)


def _port_gaze_grad(env, target, gaze, soft):
    g = torch.tensor(gaze, requires_grad=True)
    _port_gaze_loss(env, target, g, soft).backward()
    return g.grad.numpy()


def _jax_gaze_grad(env, target, gaze, soft):
    js, _, jc, _, jcfg, _ = env

    def loss(g):
        img = jtrain.render_rows_foveated(
            js, jc, _jparams(js, jc, TRUE_GAZE)._replace(gaze_uv=g), 0, 32,
            jcfg, jnp.asarray(0, jnp.int32), soft=soft)
        return jnp.mean((img - target) ** 2)

    return np.asarray(jax.jit(jax.grad(loss))(jnp.asarray(gaze,
                                                          jnp.float32)))


@pytest.mark.parametrize("soft", [True, False], ids=["soft", "hard"])
def test_gaze_grad_matches_jax(soft, gaze_env):
    """The gaze gradient, soft and straight-through hard, elementwise
    against jax.grad."""
    env, target = gaze_env
    want = _jax_gaze_grad(env, target, START_GAZE, soft)
    got = _port_gaze_grad(env, target, START_GAZE, soft)
    assert np.abs(want).sum() > 0
    np.testing.assert_allclose(got, want, rtol=GRAD_RTOL, atol=GRAD_ATOL)


def test_gaze_grad_fd(gaze_env):
    """test_grad.py::test_gaze_grad_fd: the soft loss is smooth in the
    gaze, so central differences match its gradient (eps 1e-3, rtol
    8e-2, atol 1e-7, as the reference's)."""
    env, target = gaze_env
    g = _port_gaze_grad(env, target, START_GAZE, True)
    eps = 1e-3
    fd = np.zeros(2)
    with torch.no_grad():
        for i in range(2):
            d = np.zeros(2, np.float32)
            d[i] = eps
            f = lambda s: float(_port_gaze_loss(
                env, target, torch.tensor(np.float32(START_GAZE) + s * d),
                True))
            fd[i] = (f(1.0) - f(-1.0)) / (2 * eps)
    np.testing.assert_allclose(g, fd, rtol=8e-2, atol=1e-7)


def test_gaze_hard_straight_through_grad(gaze_env):
    """test_grad.py::test_gaze_hard_straight_through_grad: the hard
    estimator's gradient is finite, nonzero and points the way the soft
    one does."""
    env, target = gaze_env
    g = _port_gaze_grad(env, target, START_GAZE, False)
    assert np.isfinite(g).all() and np.abs(g).sum() > 0
    gs = _port_gaze_grad(env, target, START_GAZE, True)
    assert float(np.dot(g, gs)) > 0.0


@pytest.mark.slow
def test_gaze_optimization_recovers_gaze(gaze_env):
    """test_grad.py::test_gaze_optimization_recovers_gaze: 30 Adam steps
    (lr 3e-2) on the soft loss halve the gaze error."""
    env, target = gaze_env
    gaze = torch.tensor(START_GAZE, requires_grad=True)
    err0 = float(np.linalg.norm(np.float32(START_GAZE) - TRUE_GAZE))
    opt = torch.optim.Adam([gaze], lr=3e-2)
    for _ in range(30):
        opt.zero_grad()
        _port_gaze_loss(env, target, gaze, True).backward()
        opt.step()
        with torch.no_grad():
            gaze.clamp_(0.0, 1.0)
    err1 = float(np.linalg.norm(gaze.detach().numpy() - TRUE_GAZE))
    assert err1 < err0 * 0.5, (err0, err1)


# ---------------------------------------------------------- the train step
class _Grab:
    """An optax transformation whose state is the last gradient (and
    whose update is zero): make_train_step's loss and gradients, read
    through its own jitted step."""

    @staticmethod
    def make():
        return optax.GradientTransformation(
            lambda p: p,
            lambda g, s, p=None: (jax.tree.map(jnp.zeros_like, g), g))


_JAX_STEPS = {}


def _jax_step(foveated):
    """The reference's loss and gradients of make_train_step on a
    2-device mesh, at tests/torch_dist_ranks.py's start."""
    if foveated not in _JAX_STEPS:
        scene = jprocedural.box_scene()
        cam = JCamera.create(eye=tdr.TRAIN_EYE, target=tdr.TRAIN_TARGET)
        cfg = JRenderConfig(width=32, height=32, max_depth=2,
                            diffuse_max_depth=1, reconstruction="none")
        mesh = jshd.make_mesh(2)
        grab = _Grab.make()
        step, _ = jtrain.make_train_step(scene, cam, cfg, mesh, grab,
                                         foveated=foveated)
        true = jtrain.init_params(scene, cam)
        pscene = procedural.box_scene("cpu")
        pcam = Camera.create(eye=tdr.TRAIN_EYE, target=tdr.TRAIN_TARGET,
                             device="cpu")
        _, start = tdr.train_start(pscene, pcam)
        params = jtrain.TrainParams(*(jnp.asarray(t.numpy())
                                      for t in start.tensors()))
        target = jax.jit(lambda p: jtrain.render_rows_dense(
            scene, cam, p, 0, 32, cfg, jnp.asarray(0, jnp.int32)))(true)
        _, grads, loss = step(params, grab.init(params), target,
                              jnp.asarray(0, jnp.int32))
        _JAX_STEPS[foveated] = (float(loss), {
            k: np.asarray(v) for k, v in zip(FIELDS, grads)})
    return _JAX_STEPS[foveated]


@pytest.fixture(scope="module")
def rank_steps(tmp_path_factory):
    """The dense and the foveated (hard) 2-rank steps, in one launch of
    the rank processes."""
    res = tdr.run_ranks(
        "several", 2, tmp_path_factory.mktemp("train"),
        cases={"dense": ["train", dict(foveated=False, steps=2)],
               "hard": ["train", dict(foveated=True, steps=2)]})

    def get(foveated):
        label = "hard/" if foveated else "dense/"
        return {k[len(label):]: v for k, v in res.items()
                if k.startswith(label)}
    return get


@pytest.mark.parametrize("foveated", [False, True], ids=["dense", "hard"])
def test_two_rank_step_matches_jax(foveated, rank_steps):
    """A 2-rank step's loss and every gradient (envmap and, foveated,
    gaze_uv included) against jax.value_and_grad of make_train_step's
    loss on a 2-device mesh."""
    res = rank_steps(foveated)
    loss, grads = _jax_step(foveated)
    np.testing.assert_allclose(float(res["loss"]), loss, rtol=GRAD_RTOL)
    for k in FIELDS:
        want = grads[k]
        if k == "gaze_uv" and not foveated:
            assert not want.any()
        else:
            assert np.abs(want).sum() > 0, k
        np.testing.assert_allclose(res[f"grad_{k}"].numpy(), want,
                                   rtol=GRAD_RTOL, atol=GRAD_ATOL, err_msg=k)


def test_two_ranks_equal_one(rank_steps):
    """The dense 2-rank step's loss and gradients equal one process's
    within rtol 1e-4 (the ranks' partial sums add in another order, and
    the eye gradient is a small sum of large terms: 5.5e-5 apart), and
    its two Adam steps end at the same parameters. The foveated step is
    not compared so: each tile reconstructs its own rows, as the
    reference's does."""
    res = rank_steps(False)
    one = tdr.case_train(shd.make_mesh(device="cpu"), foveated=False,
                         steps=2)
    for k in ["loss"] + [f"grad_{f}" for f in FIELDS] + \
            ["loss_step0", "loss_step1", "eye", "light_emission"]:
        torch.testing.assert_close(res[k], one[k], rtol=1e-4, atol=1e-12,
                                   msg=k)


def test_adam_matches_optax():
    """torch.optim.Adam as make_optimizer builds it against optax.adam
    on the same given gradients, 5 steps, every parameter."""
    r = np.random.default_rng(11)
    shapes = [(3,), (3,), (2,), (3,), (5, 3), (4, 8, 3)]
    p0 = [r.normal(size=s).astype(np.float32) for s in shapes]
    gs = [[(r.normal(size=s) * 10.0 ** r.integers(-4, 1)).astype(np.float32)
           for s in shapes] for _ in range(5)]
    opt = optax.adam(1e-2)
    jp = [jnp.asarray(p) for p in p0]
    st = opt.init(jp)
    params = train.leaves(train.TrainParams(*map(torch.as_tensor, p0)))
    topt = train.make_optimizer(params, 1e-2)
    for g in gs:
        up, st = opt.update([jnp.asarray(x) for x in g], st)
        jp = optax.apply_updates(jp, up)
        for p, x in zip(params.tensors(), g):
            p.grad = torch.as_tensor(x)
        topt.step()
    # the two round the bias corrections in another order: a few ulps
    for got, want in zip(params.tensors(), jp):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-7)


# ------------------------------------------------------- rays and carrying
def test_primary_rays_block_matches_jax():
    """The training rays: with the reference's compiled inverse, bit for
    bit (the NDC fold, the homogeneous sum and the contracted norm); with
    the port's own inverse within 1e-5."""
    jc = JCamera.create(eye=tdr.TRAIN_EYE, target=tdr.TRAIN_TARGET)
    pc = Camera.create(eye=tdr.TRAIN_EYE, target=tdr.TRAIN_TARGET,
                       device="cpu")
    w, h, y0, bh = 64, 48, 8, 16
    jo, jd = jax.jit(lambda c: c.primary_rays_block(w, h, y0, bh))(jc)
    po, pd = pc.primary_rays_block(w, h, y0, bh)
    assert pd.shape == (bh, w, 3) and po.shape == (bh, w, 3)
    np.testing.assert_array_equal(po.numpy(), np.asarray(jo))
    np.testing.assert_allclose(pd.numpy(), np.asarray(jd), rtol=0,
                               atol=1e-5)
    jinv = torch.as_tensor(np.array(jax.jit(
        lambda c: c.inv_mvp(w / h))(jc)))
    with pytest.MonkeyPatch.context() as m:
        m.setattr(Camera, "inv_mvp", lambda self, aspect: jinv)
        _, pd = pc.primary_rays_block(w, h, y0, bh)
    np.testing.assert_array_equal(pd.numpy(), np.asarray(jd))


def test_projection_rounds_as_the_eager_reference():
    """A parity residual: the port's projection equals the reference's
    eager one; the reference's compiled projection multiplies by the
    float32 reciprocal of the aspect instead of dividing, one ulp off in
    [0, 0] at 64x48."""
    jc = JCamera.create(eye=tdr.TRAIN_EYE, target=tdr.TRAIN_TARGET)
    pc = Camera.create(eye=tdr.TRAIN_EYE, target=tdr.TRAIN_TARGET,
                       device="cpu")
    aspect = 64 / 48
    got = pc.proj_matrix(aspect).numpy()
    np.testing.assert_array_equal(got, np.asarray(jc.proj_matrix(aspect)))
    jit = np.asarray(jax.jit(lambda c: c.proj_matrix(aspect))(jc))
    diff = np.argwhere(got != jit)
    assert diff.tolist() == [[0, 0]]
    f = np.float32(got[1, 1])
    assert jit[0, 0] == f * (np.float32(1.0) / np.float32(aspect))
    assert abs(int(got[0, 0].view(np.int32)) - int(jit[0, 0].view(
        np.int32))) == 1


def test_train_params_from_numpy_round_trip():
    """The JAX package's init_params, carried across as numpy arrays,
    equals the port's init_params of the same scene and camera."""
    js = jprocedural.box_scene()
    jc = JCamera.create(eye=tdr.TRAIN_EYE, target=tdr.TRAIN_TARGET)
    jp = jtrain.init_params(js, jc)
    got = convert.train_params_from_numpy(
        {k: np.asarray(v) for k, v in jp._asdict().items()}, "cpu")
    want = train.init_params(procedural.box_scene("cpu"),
                             Camera.create(eye=tdr.TRAIN_EYE,
                                           target=tdr.TRAIN_TARGET,
                                           device="cpu"))
    for k, a, b in zip(FIELDS, got.tensors(), want.tensors()):
        assert a.dtype == b.dtype and torch.equal(a, b), k
    back = convert.to_numpy(got)
    for k in FIELDS:
        np.testing.assert_array_equal(back[k], np.asarray(getattr(jp, k)))
