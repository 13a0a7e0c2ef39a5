"""Scenes from files, the port's against the JAX package's
(`fovtrace.scene.assets`): every array of the scene bit for bit
(positions, normals, uvs, mat_id, materials, atlas, envmap, BVH, pack),
the albedo through the texel gather, and the `textured_obj` golden's
image and gradient fingerprint (tests/test_golden.py)."""

import os

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from fovtrace import Camera as JCamera  # noqa: E402
from fovtrace import RenderConfig as JRenderConfig  # noqa: E402
from fovtrace.render import gbuffer as jgbuffer  # noqa: E402
from fovtrace.scene import assets as jassets  # noqa: E402
from fovtrace.scene import procedural as jprocedural  # noqa: E402
from fovtrace_torch import Camera, RenderConfig, convert  # noqa: E402
from fovtrace_torch.core import vec  # noqa: E402
from fovtrace_torch.render import gbuffer, pipeline  # noqa: E402
from fovtrace_torch.scene import assets, procedural  # noqa: E402

import torch_asset_files as taf  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
CHECKER = os.path.join(HERE, "data", "checker_quad.obj")
GOLDEN = os.path.join(HERE, "golden", "textured_obj.npz")
GOLDEN_KW = dict(width=64, height=64, reconstruction="atrous", max_depth=3,
                 diffuse_max_depth=1, ray_budget_frac=0.6)
EYE, TARGET = (3.0, 2.5, 4.0), (0.0, 0.8, 0.0)
# the port's own fields, derived from the pack (tests/test_torch_scene.py)
PORT_ONLY = ("isect_rec", "isect_tflags")


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    # the suite runs in several worker processes at once (see
    # tests/test_torch_frame.py)
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _assert_same_scene(port, ref):
    a = convert.to_numpy(ref)
    b = {k: v for k, v in convert.to_numpy(port).items()
         if k not in PORT_ONLY}
    assert a.keys() == b.keys()
    for k in a:
        x, y = a[k], b[k]
        if isinstance(x, np.ndarray):
            assert x.dtype == y.dtype and x.shape == y.shape, k
            np.testing.assert_array_equal(x, y, err_msg=k)
        else:
            assert x == y, k


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """A resource directory, a geometry-only OBJ, a textured OBJ with
    usemtl groups, and a spec composing them."""
    root = str(tmp_path_factory.mktemp("assets"))
    taf.write_resource_dir(root)
    m = procedural._mesh
    box = [m(procedural.plane(3.0, 0.0), 0),
           m(procedural.box((1.0, 1.0, 1.0), (0.0, 0.5, 0.0)), 1)]
    tex = taf.write_mesh_scene(root, box, "boxes", textured=True)
    ball = taf.write_mesh_scene(
        root, [m(procedural.icosphere(0.4, (0.0, 0.0, 0.0), subdiv=1), 0)],
        "ball", textured=False)
    spec = taf.write_spec(root, tex, ball,
                          os.path.join(root, "CedarCity.hdr"))
    return {"root": root, "tex": tex, "ball": ball, "spec": spec}


def test_png_library_failure_raises(files, monkeypatch):
    """A PNG texture needs the unfilter library: a build that fails (here
    g++ missing) raises, where an unreadable file only drops the
    texture, as in the reference."""
    from fovtrace_torch import _build, native

    png = os.path.join(files["root"], "vokselia_spawn", "vokselia_spawn.png")
    assert assets._load_texture(png) is not None
    assert assets._load_texture(png + ".missing.png") is None

    def no_compiler(*a, **k):
        raise FileNotFoundError("g++")

    monkeypatch.setattr(_build, "build_library", no_compiler)
    native.png_lib.cache_clear()
    try:
        with pytest.raises(FileNotFoundError):
            assets._load_texture(png)
        with pytest.raises(FileNotFoundError):
            assets.scene_from_spec(files["spec"], device="cpu")
    finally:
        native.png_lib.cache_clear()


def test_scene_from_obj_matches_reference():
    """checker_quad.obj: usemtl groups, a map_Kd PPM, no vn."""
    port = assets.scene_from_obj(CHECKER, device="cpu")
    _assert_same_scene(port, jassets.scene_from_obj(CHECKER))
    assert tuple(port.textures.shape) == (1, 16, 16, 3)
    assert port.materials.texture_id.tolist() == [0, -1]


def test_scene_from_spec_matches_reference(files):
    """A spec with a scaled, moved textured OBJ, a refractive OBJ (the
    native parser) and an RLE HDR envmap."""
    port = assets.scene_from_spec(files["spec"], device="cpu")
    ref = jassets.scene_from_spec(files["spec"])
    _assert_same_scene(port, ref)
    assert tuple(port.envmap.shape) == (16, 32, 3)
    assert float(port.light.emission[0]) == 600.0


def test_full_transform_moves_normals_as_the_reference(files):
    """A 4x4 transform that shears: vertices and the inverse-transpose
    normals; a model without vn beside one with them."""
    shear = np.eye(4, dtype=np.float32)
    shear[0, 1], shear[2, 2], shear[:3, 3] = 0.5, 2.0, (1.0, 0.0, -1.0)
    specs = lambda mod: [mod.ModelSpec(files["tex"], "diffuse",
                                       transform=shear),
                         mod.ModelSpec(files["ball"], "reflection",
                                       scale=0.5)]
    port = assets.scene_from_objs(specs(assets), device="cpu")
    _assert_same_scene(port, jassets.scene_from_objs(specs(jassets)))


def test_reference_assets_scene_matches_reference(files):
    """The resource-directory scene: every texture in the atlas, the
    HDR envmap, the procedural stand-ins."""
    port = assets.reference_assets_scene(files["root"], vokselia_extent=2,
                                         device="cpu")
    ref = jassets.reference_assets_scene(files["root"], vokselia_extent=2)
    _assert_same_scene(port, ref)
    assert tuple(port.textures.shape) == (3, 24, 24, 3)
    assert port.materials.texture_id.tolist() == [0, 1, 2, -1, -1]
    assert tuple(port.envmap.shape) == (16, 32, 3)
    assert float(port.envmap.max()) > 2.0


def test_textured_albedo_matches_reference(files):
    """The texel gather: the G-buffer albedo of a scene whose ground is
    textured (a PNG map_Kd) and whose box is flat equals the
    reference's."""
    jsc = jassets.scene_from_obj(files["tex"])
    sc = assets.scene_from_obj(files["tex"], device="cpu")
    eye, target = (2.0, 3.0, 2.5), (0.0, 0.3, 0.0)
    jcam = JCamera.create(eye=eye, target=target)
    jcfg = JRenderConfig(width=32, height=32)
    want = jgbuffer.gbuffer_rows(jgbuffer.trace_gbuffer(jsc, jcam, jcam, 32,
                                                        32, jcfg))
    cam = Camera.create(eye=eye, target=target, device="cpu")
    got = gbuffer.trace_gbuffer(sc, cam, cam, 32, 32, RenderConfig(
        width=32, height=32))
    albedo = vec.to_rows(got["albedo"]).numpy()
    wa = np.asarray(want["albedo"])
    # the textured ground covers part of the view, the flat box the rest
    assert len(np.unique(albedo.reshape(-1, 3), axis=0)) > 20
    np.testing.assert_allclose(albedo, wa, rtol=1e-6, atol=1e-6)


@pytest.fixture(scope="module")
def golden():
    return np.load(GOLDEN)


def test_textured_obj_golden_image(golden):
    """tests/test_golden.py's textured_obj case: two 64x64 frames."""
    scene = assets.scene_from_obj(CHECKER, device="cpu")
    cfg = RenderConfig(**GOLDEN_KW)
    cam = Camera.create(eye=EYE, target=TARGET, device="cpu")
    st = pipeline.FrameState.initial(cam, cfg)
    for _ in range(2):
        out, st = pipeline.render_frame(scene, cam, (32, 32), st, cfg)
    assert int(out["ray_count"]) == int(golden["ray_count"])
    err = np.abs(out["image"].numpy() - golden["image"].astype(np.float32))
    assert err.mean() < 5e-3 and err.max() < 0.1, (err.mean(), err.max())


def test_textured_obj_golden_gradients(golden):
    """The golden's gradient fingerprint (rtol 2e-3): the mean image of
    one frame from the differentiated camera, w.r.t. emission, kd, eye."""
    scene = assets.scene_from_obj(CHECKER, device="cpu")
    cam = Camera.create(eye=EYE, target=TARGET, device="cpu")
    _, g, out = pipeline.grad_step(scene, cam, (32, 32), None,
                                   RenderConfig(**GOLDEN_KW))
    fp = np.asarray([f(g[k]) for k in ("emission", "kd", "eye")
                     for f in (lambda t: float(t.norm()),
                               lambda t: float(t.mean()))])
    np.testing.assert_allclose(fp, golden["grad_fp"], rtol=2e-3, atol=1e-7)


def test_has_bvh():
    sc = procedural.box_scene("cpu")
    assert sc.has_bvh and jprocedural.box_scene().has_bvh
    assert not sc.replace(bvh_nodes_min=None).has_bvh
