"""The `bvh` intersection backend (`fovtrace_torch.kernels.bvh_traverse`)
against the port's brute force and the JAX package's
`fovtrace.kernels.bvh_traverse`: tests/test_bvh.py's cases, 500 seeded
rays, the same ids and t within rtol 1e-4 / atol 1e-5."""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from fovtrace.kernels import bvh_traverse as jbvh  # noqa: E402
from fovtrace.scene import procedural as jprocedural  # noqa: E402
from fovtrace_torch import Camera, RenderConfig  # noqa: E402
from fovtrace_torch.core import vec  # noqa: E402
from fovtrace_torch.kernels import bvh_traverse  # noqa: E402
from fovtrace_torch.kernels import cluster_isect as ci  # noqa: E402
from fovtrace_torch.kernels import intersect as isect  # noqa: E402
from fovtrace_torch.render import pipeline  # noqa: E402
from fovtrace_torch.scene import procedural  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    # the suite runs in several worker processes at once (see
    # tests/test_torch_frame.py)
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _rays(n=500, seed=2, radius=6.0):
    """tests/test_bvh.py's rays."""
    rng = np.random.default_rng(seed)
    ro = rng.uniform(-radius, radius, (n, 3)).astype(np.float32)
    ro[:, 1] = np.abs(ro[:, 1])
    rd = rng.normal(size=(n, 3)).astype(np.float32)
    rd /= np.linalg.norm(rd, axis=1, keepdims=True)
    return ro, rd


v3 = lambda a: vec.from_rows(torch.as_tensor(a))


@pytest.mark.parametrize("name", ["box", "earth", "multi"])
def test_bvh_matches_brute_and_reference(name):
    scene = procedural.SCENES[name]("cpu")
    ro, rd = _rays()
    ci.reset_counters()
    got = bvh_traverse.intersect_bvh(scene, v3(ro), v3(rd), 1e-3, 1e30,
                                     packet=128)
    assert ci.counters()["intersect_bvh"] == 1
    brute = isect.intersect_brute(scene, v3(ro), v3(rd), 1e-3, 1e30)
    want = jbvh.intersect_bvh(jprocedural.SCENES[name]().with_bvh(),
                              jnp.asarray(ro), jnp.asarray(rd), 1e-3, 1e30,
                              packet=128)
    assert int((got.tri >= 0).sum()) > 50
    for ref_t, ref_tri in ((brute.t.numpy(), brute.tri.numpy()),
                           (np.asarray(want.t), np.asarray(want.tri))):
        np.testing.assert_array_equal(got.tri.numpy(), ref_tri)
        np.testing.assert_allclose(got.t.numpy(), ref_t, rtol=1e-4,
                                   atol=1e-5)


def _stacked_mesh():
    """40 copies of one triangle at x = -8 (coincident centroids: one leaf
    of 48, three blocks) and 100 small triangles spread over x in
    [-4, 8], whose leaves of one block come after it in leaf order."""
    rng = np.random.default_rng(3)
    big = np.array([[-9.0, 0.0, 0.0], [-7.0, 0.0, 0.0], [-8.0, 2.0, 0.0]])
    c = rng.uniform((-4.0, 0.0, -1.0), (8.0, 2.0, 1.0), (100, 1, 3))
    small = c + rng.normal(size=(100, 3, 3)) * 0.4
    verts = np.concatenate([np.tile(big, (40, 1)),
                            small.reshape(-1, 3)]).astype(np.float32)
    tris = np.arange(len(verts)).reshape(-1, 3)
    return verts, tris, np.zeros(len(tris), np.int32)


def test_bvh_leaf_over_one_block():
    """A leaf of more than LEAF_BLOCK triangles makes every packet step
    three blocks a leaf, past the end of the last, shorter leaf: the
    same hits as the reference's, which steps each leaf's own blocks."""
    from fovtrace.scene import scene as jscene
    from fovtrace_torch.scene import scene as tscene

    verts, tris, mats = _stacked_mesh()
    scene = tscene.Scene.build(verts, tris, mats, tscene.Materials.create(
        [tscene.MATL_DIFFUSE], [(0.7, 0.7, 0.7)])).with_bvh()
    jsc = jscene.Scene.build(verts, tris, mats, jscene.Materials.create(
        [jscene.MATL_DIFFUSE], [(0.7, 0.7, 0.7)])).with_bvh()
    leaf = scene.bvh_leaf.numpy() == 1
    count, start = scene.bvh_right.numpy()[leaf], scene.bvh_left.numpy()[leaf]
    assert count.max() > bvh_traverse.LEAF_BLOCK
    assert count[np.argmax(start)] == bvh_traverse.LEAF_BLOCK
    assert start.max() + count.max() > scene.num_triangles
    rng = np.random.default_rng(4)
    ro = np.stack([rng.uniform(-9.5, 8.5, 400), rng.uniform(0.0, 2.0, 400),
                   np.full(400, 5.0)], -1).astype(np.float32)
    rd = np.tile(np.float32([0.0, 0.0, -1.0]), (400, 1))
    got = bvh_traverse.intersect_bvh(scene, v3(ro), v3(rd), 1e-3, 1e30,
                                     packet=64)
    want = jbvh.intersect_bvh(jsc, jnp.asarray(ro), jnp.asarray(rd), 1e-3,
                              1e30, packet=64)
    assert int((got.tri >= 0).sum()) > 100
    assert (ro[:, 0] < -7.5)[got.tri.numpy() >= 0].sum() > 10
    np.testing.assert_array_equal(got.tri.numpy(), np.asarray(want.tri))
    np.testing.assert_allclose(got.t.numpy(), np.asarray(want.t), rtol=1e-4,
                               atol=1e-5)


def test_bvh_occlusion_blocks_opaque():
    """tests/test_bvh.py's case: down through the box 0, up to the sky 1."""
    att = bvh_traverse.occlusion_bvh(
        procedural.box_scene("cpu"), v3([[0.0, 3.0, 0.0], [0.0, 3.0, 0.0]]),
        v3([[0.0, -1.0, 0.0], [0.0, 1.0, 0.0]]), 1e-3, 10.0, packet=2)
    a = vec.to_rows(att).numpy()
    np.testing.assert_allclose(a[0], 0.0, atol=1e-6)
    np.testing.assert_allclose(a[1], 1.0, atol=1e-6)


@pytest.mark.parametrize("name", ["earth", "multi"])
def test_bvh_occlusion_matches_reference(name):
    """Shadow attenuation through glass: the first four interfaces, as
    the reference counts them, on the seeded rays."""
    ro, rd = _rays(seed=5)
    got = bvh_traverse.occlusion_bvh(procedural.SCENES[name]("cpu"), v3(ro),
                                     v3(rd), 1e-3, 8.0, packet=128)
    want = jbvh.occlusion_bvh(jprocedural.SCENES[name]().with_bvh(),
                              jnp.asarray(ro), jnp.asarray(rd), 1e-3, 8.0,
                              packet=128)
    got = vec.to_rows(got).numpy()
    want = np.asarray(want)
    assert 0 < (got == 0).all(-1).sum() < len(ro)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_bvh_build_layout():
    """tests/test_bvh.py's build cases on the port's scenes: the leaves
    cover every real triangle; inner boxes contain their children."""
    scene = procedural.earth_scene("cpu")
    left, right = scene.bvh_left.numpy(), scene.bvh_right.numpy()
    leaf = scene.bvh_leaf.numpy() == 1
    lo, hi = scene.bvh_nodes_min.numpy(), scene.bvh_nodes_max.numpy()
    covered = np.zeros(scene.num_triangles, bool)
    for i in np.flatnonzero(leaf):
        covered[left[i]:left[i] + right[i]] = True
    np.testing.assert_array_equal(covered[scene.mat_id.numpy() >= 0], True)
    for i in np.flatnonzero(~leaf):
        for c in (left[i], right[i]):
            assert (lo[i] <= lo[c] + 1e-5).all() and \
                (hi[i] >= hi[c] - 1e-5).all()


def test_bvh_backend_frame_matches_cluster():
    """RenderConfig(intersect_backend="bvh") renders the cluster route's
    frame: the same mask and counts, the image at the golden tolerance."""
    scene = procedural.box_scene("cpu")
    cam = Camera.create(eye=(3.0, 2.5, 4.0), target=(0.0, 0.8, 0.0),
                        device="cpu")
    outs = {}
    for backend in ("bvh", "cluster"):
        cfg = RenderConfig(width=32, height=32, max_depth=2,
                           intersect_backend=backend)
        ci.reset_counters()
        out, _ = pipeline.render_frame(scene, cam, (16, 16),
                                       pipeline.FrameState.initial(cam, cfg),
                                       cfg)
        outs[backend] = (out, ci.counters())
    (b, cb), (c, cc) = outs["bvh"], outs["cluster"]
    assert cb["intersect_bvh"] > 0 and cb["occlusion_bvh"] > 0
    assert cb["closest_hit_plain"] == 0 and cc["intersect_bvh"] == 0
    torch.testing.assert_close(b["mask"], c["mask"], rtol=0, atol=0)
    for k in ("ray_count", "rays_traced", "rays_dropped"):
        assert int(b[k]) == int(c[k]), k
    err = (b["image"] - c["image"]).abs()
    assert float(err.mean()) < 5e-3 and float(err.max()) < 0.1
