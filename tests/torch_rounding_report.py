"""How far the port's CPU rounding is from the jitted JAX reference's.

    PYTHONPATH=. python tests/torch_rounding_report.py           # both
    PYTHONPATH=. python tests/torch_rounding_report.py --shade   # 1 only

1. Identical primary rays of a 64x64 earth frame through one shade
   bounce (`shade_v`, max_depth 1), the port against the reference's
   jitted `shade_v`: lanes whose refined t, hit point, shading normal
   and radiance differ at all.
2. Two 64x64 frames in the configurations whose glass paths the
   rounding reaches, against the jitted reference: MAE, max and pixels
   at least 0.1 off (the golden tolerance's limits), and rays_traced.

Not a test: it prints what the tests' outlier caps
(`tests/test_torch_frame.py` OUTLIERS, `tests/test_torch_modes.py`
LOGPOLAR_OUTLIERS) were set from. Run it with another checkout's
package first on PYTHONPATH to measure that tree the same way.
"""

from __future__ import annotations

import argparse
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from fovtrace import Camera as JCamera  # noqa: E402
from fovtrace import RenderConfig as JRenderConfig  # noqa: E402
from fovtrace.core import vec as jvec  # noqa: E402
from fovtrace.render import pipeline as jpipeline  # noqa: E402
from fovtrace.render import shade as jshade  # noqa: E402
from fovtrace.scene import procedural as jprocedural  # noqa: E402
from fovtrace_torch import Camera, RenderConfig  # noqa: E402
from fovtrace_torch.core import rng, vec  # noqa: E402
from fovtrace_torch.render import pipeline, shade  # noqa: E402
from fovtrace_torch.scene import procedural  # noqa: E402

SIZE = 64
EYE, TARGET = (3.0, 2.5, 4.0), (0.0, 0.8, 0.0)
FRAME_KW = dict(width=SIZE, height=SIZE, reconstruction="atrous",
                max_depth=3, diffuse_max_depth=1, ray_budget_frac=0.6)
CASES = [("earth", "full", dict(sampling_mode="full")),
         ("earth", "dof", dict(dof=True)),
         ("earth", "logpolar", dict(sampling_mode="logpolar")),
         ("earth", "weier", dict(sampling_mode="weier")),
         ("vokselia", "masked", {})]


def shade_report():
    cam = Camera.create(eye=EYE, target=TARGET, device="cpu")
    _, rd = cam.primary_rays_v(SIZE, SIZE)
    rd = rd.map(lambda a: a.reshape(-1))
    ro = vec.splat(cam.eye, rd.shape)
    seeds = rng.pixel_seed(torch.arange(SIZE * SIZE), 0)
    kw = dict(width=SIZE, height=SIZE, max_depth=1, diffuse_max_depth=1)
    rad, aux = shade.shade_v(procedural.earth_scene("cpu"), ro, rd, seeds,
                             RenderConfig(**kw))
    js = jprocedural.earth_scene()
    as_j = lambda v: jvec.Vec3(*[jnp.asarray(c.numpy()) for c in v])
    jrad, jaux = jax.jit(lambda o, d, s: jshade.shade_v(
        js, o, d, s, JRenderConfig(**kw)))(
        as_j(ro), as_j(rd), jnp.asarray(seeds.numpy().astype(np.uint32)))
    rows = lambda v: np.stack([np.asarray(c) for c in v])
    for name, want, got in (
            ("t", np.asarray(jaux["t"])[None], aux["t"].numpy()[None]),
            ("point", rows(jaux["point"]), rows(aux["point"])),
            ("normal", rows(jaux["normal"]), rows(aux["normal"])),
            ("radiance", rows(jrad), rows(rad))):
        lanes = int((want != got).any(0).sum())
        print(f"[shade] {name}: {lanes} of {SIZE * SIZE} lanes differ, max "
              f"|diff| {np.abs(want - got).max():.3e}")


def frame_report():
    for scene_name, name, extra in CASES:
        kw = {**FRAME_KW, **extra}
        jcam = JCamera.create(eye=EYE, target=TARGET)
        jcfg = JRenderConfig(**kw)
        jst = jpipeline.FrameState.initial(jcam, jcfg)
        jscene = jprocedural.SCENES[scene_name]()
        cam = Camera.create(eye=EYE, target=TARGET, device="cpu")
        cfg = RenderConfig(**kw)
        st = pipeline.FrameState.initial(cam, cfg)
        scene = procedural.SCENES[scene_name]("cpu")
        for f in range(2):
            want, jst = jpipeline.render_frame_jit(
                jscene, jcam, (jnp.asarray(SIZE // 2), jnp.asarray(SIZE // 2)),
                jst, jcfg)
            got, st = pipeline.render_frame(scene, cam, (SIZE // 2, SIZE // 2),
                                            st, cfg)
            err = np.abs(got["image"].numpy() - np.asarray(want["image"]))
            print(f"[frame] {scene_name} {name} frame {f}: MAE "
                  f"{err.mean():.3e}, max {err.max():.3f}, pixels >= 0.1 "
                  f"{int((err.max(-1) >= 0.1).sum())}, rays_traced "
                  f"{int(got['rays_traced'])} / {int(want['rays_traced'])}")


def main():
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--shade", action="store_true",
                   help="only the one-bounce lane report")
    args = p.parse_args()
    torch.set_num_threads(4)
    shade_report()
    if not args.shade:
        frame_report()


if __name__ == "__main__":
    main()
