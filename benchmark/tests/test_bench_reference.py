"""The reference agrees with the port's plain route (CPU tensors) at
64x64, frame for frame and step for step."""

import json

import pytest
import torch

from harness import program, refside, scenes, spec


def _config(name, **over):
    c = json.loads((spec.BENCH / "configs" / f"{name}.json").read_text())
    return dict(c, width=64, height=64, **over)


@pytest.mark.parametrize("name", ["earth-uhd", "city-uhd"])
def test_frames_equal_the_plain_route(name):
    from fovtrace_torch.render import pipeline as P
    from reference import pipeline as R

    cfg = _config(name)
    mesh, env = scenes.mesh_arrays(cfg), scenes.envmap_array(cfg)
    ps = program.build_scene(cfg, mesh, env, "cpu")
    rs = refside.build_scene(cfg, mesh, env, "cpu")
    pc, rc = program.render_config(cfg), refside.render_config(cfg)
    eyes = [(3.0, 2.5, 4.0), (3.05, 2.5, 3.96)]
    gazes = [(30, 20), (33, 41)]
    pst = rst = None
    for eye, gaze in zip(eyes, gazes):
        pcam = program.camera(eye, (0.0, 0.8, 0.0), cfg, "cpu")
        rcam = refside.camera(eye, (0.0, 0.8, 0.0), cfg, "cpu")
        pst = pst or P.FrameState.initial(pcam, pc)
        rst = rst or R.FrameState.initial(rcam, rc)
        po, pst = P.render_frame(ps, pcam, gaze, pst, pc)
        ro, rst = R.render_frame(rs, rcam, gaze, rst, rc)
        assert torch.equal(torch.stack(list(po["image_rgb"])),
                           torch.stack(list(ro["image_rgb"])))
        assert torch.equal(pst.history, rst.history)
        assert torch.equal(pst.depth_cache, rst.depth_cache)
        for k in ("ray_count", "rays_traced", "rays_dropped"):
            assert int(po[k]) == int(ro[k])


def test_train_steps_follow_the_plain_route():
    from harness import check, trainer, viewer

    cfg = _config("earth-uhd")
    mix = json.loads((spec.BENCH / "traffic" / "train.json").read_text())
    run = viewer.Run(config=cfg, mix=mix,
                     seed=11, seconds=0.0, traced=False,
                     device=torch.device("cpu"))
    got = trainer.run_program(run)
    ref = trainer.reference_steps(run)
    n = check.train_numbers(got["checked"], ref)
    assert n["loss_gap"] < 1e-6 and n["grad_gap"] < 1e-5
    assert n["change_gap"] < 1e-5
