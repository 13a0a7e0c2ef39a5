"""fovtrace_torch scenes against the JAX reference: the port's own earth
and box builds equal the converted reference scenes bitwise (leaf order,
pack, attribute rows), and the port's modules import no JAX."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from fovtrace import Camera as JCamera  # noqa: E402
from fovtrace.render import pipeline as jpipeline  # noqa: E402
from fovtrace.scene import procedural as jprocedural  # noqa: E402
from fovtrace_torch import RenderConfig, convert  # noqa: E402
from fovtrace_torch.scene import procedural  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    # the suite runs in several worker processes at once; PyTorch's
    # default of one thread per core then oversubscribes the CPU, and its
    # spinning thread pool runs such a frame ~40x slower than at 2 threads
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


# fields only the port's Scene has: the kernels' records and flags,
# derived from the pack (checked against the reference's pack in
# tests/test_torch_isect.py)
PORT_ONLY = ("isect_rec", "isect_tflags")


def _shared(d: dict) -> dict:
    assert all(d[k] is not None for k in PORT_ONLY)
    return {k: v for k, v in d.items() if k not in PORT_ONLY}


def _assert_same(a: dict, b: dict):
    assert a.keys() == b.keys()
    for k in a:
        x, y = a[k], b[k]
        if isinstance(x, np.ndarray):
            assert isinstance(y, np.ndarray), k
            assert x.dtype == y.dtype and x.shape == y.shape, k
            np.testing.assert_array_equal(x, y, err_msg=k)
        else:
            assert x == y, k


@pytest.mark.parametrize("name", ["earth", "box", "bunny", "multi", "vokselia"])
def test_port_scene_equals_converted_reference(name):
    ref = convert.to_numpy(jprocedural.SCENES[name]())
    port = procedural.SCENES[name]("cpu")
    _assert_same(ref, _shared(convert.to_numpy(port)))
    # and the conversion itself is lossless
    _assert_same(ref, _shared(convert.to_numpy(
        convert.scene_from_numpy(ref, "cpu"))))
    if name == "earth":
        assert port.num_triangles == 5616
        assert int((port.mat_id >= 0).sum()) == 3982
        assert tuple(port.isect_coef.shape) == (44, 16, 512)


def test_camera_and_frame_state_from_numpy():
    cam = JCamera.create(eye=(1.0, 2.0, 3.0), target=(0.0, 0.5, 0.0))
    state = jpipeline.FrameState.initial(
        cam, jpipeline.RenderConfig(width=32, height=16))
    state = state.replace(frame=jnp.asarray(7, jnp.int32))
    ct = convert.camera_from_numpy(convert.to_numpy(cam), "cpu")
    np.testing.assert_allclose(ct.mvp(2.0).numpy(), np.asarray(cam.mvp(2.0)),
                               rtol=1e-6, atol=1e-7)
    st = convert.frame_state_from_numpy(convert.to_numpy(state), "cpu")
    assert tuple(st.history.shape) == (4, 16, 32)
    assert st.frame.dtype == torch.int64 and int(st.frame) == 7
    np.testing.assert_array_equal(st.prev_camera.eye.numpy(),
                                  np.asarray(cam.eye))


def test_config_refuses_unported_modes():
    # every mode of the reference is ported; anything else is refused
    for mode in ("masked", "weier", "author", "logpolar", "full"):
        RenderConfig(sampling_mode=mode)
    for recon in ("jfa", "sibson", "pullpush", "atrous", "all", "none"):
        RenderConfig(reconstruction=recon)
    with pytest.raises(ValueError, match="not ported"):
        RenderConfig(sampling_mode="stratified")
    with pytest.raises(ValueError, match="not ported"):
        RenderConfig(reconstruction="bilateral")


def test_scene_names_match_reference():
    assert sorted(procedural.SCENES) == sorted(jprocedural.SCENES)
    from fovtrace_torch.app import cli
    args = cli.build_argparser().parse_args(["--scene", "city"])
    assert args.scene == "city"


def test_entry_points_default_to_the_card():
    """Scenes and cameras are made on the card unless the caller asks for
    the CPU; without a card they raise rather than fall back."""
    import inspect

    from fovtrace_torch.core.camera import Camera

    for fn in list(procedural.SCENES.values()) + [Camera.create]:
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    if torch.cuda.is_available():
        assert Camera.create(eye=(1, 2, 3), target=(0, 0, 0)).device.type \
            == "cuda"
    else:
        with pytest.raises((AssertionError, RuntimeError)):
            Camera.create(eye=(1, 2, 3), target=(0, 0, 0))


def test_port_imports_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import fovtrace_torch\n"
        "for m in pkgutil.walk_packages(fovtrace_torch.__path__, "
        "'fovtrace_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'fovtrace'))\n"
        "assert not bad, bad\n"
        "print(len([m for m in sys.modules if m.startswith('fovtrace_torch')]))\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.strip()) >= 20
