"""Multi-process cases for the port's torch.distributed tests.

`run_ranks(case, world, tmp_path, **kw)` starts `world` processes of this
file, one per rank, joined by a gloo group through a file in `tmp_path`
(no TCP port, so parallel test workers cannot collide; the settings
reach `launch.init_distributed` as its FOVTRACE_* variables), runs the case
function `case_<case>(mesh, **kw)` in each, and returns what rank 0's
returned (a dict of tensors, saved with torch.save). Each rank runs on
the CPU with one thread. Not a test module: the tests import it.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT_S = 400


def run_ranks(case: str, world: int, tmp_path, **kw) -> dict:
    out = os.path.join(str(tmp_path), f"{case}_rank0.pt")
    # the group's settings travel as launch.init_distributed's variables
    env = {**os.environ, "PYTHONPATH": REPO, "OMP_NUM_THREADS": "1",
           "FOVTRACE_COORDINATOR": f"file://{tmp_path}/rdzv_{case}",
           "FOVTRACE_NUM_PROCESSES": str(world)}
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--case", case,
         "--out", out, "--kw", json.dumps(kw)],
        env={**env, "FOVTRACE_PROCESS_ID": str(r)}, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
        for r in range(world)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    codes = [p.returncode for p in procs]
    assert codes == [0] * world, (codes, "\n".join(logs)[-4000:])
    return torch.load(out, weights_only=True)


# ------------------------------------------------------------- the cases
FRAME_EYE, FRAME_TARGET = (3.0, 2.5, 4.0), (0.0, 0.8, 0.0)
FRAME_EYE2 = (3.1, 2.4, 3.9)


def frame_config(recon="atrous", size=64, frac=1.0, **extra):
    """tests/test_dist.py's configuration: budget fraction 1.0 and a
    budget factor of 8, so no tile drops a ray."""
    from fovtrace_torch import RenderConfig

    kw = dict(width=size, height=size, reconstruction=recon, max_depth=3,
              diffuse_max_depth=1, ray_budget_frac=frac,
              sharded_budget_factor=8.0)
    kw.update(extra)
    return RenderConfig(**kw)


def case_frame(mesh, gaze, frames=2, scene="multi", **cfg_kw):
    """`frames` sharded frames of the multi scene (the camera moves in
    the second), each gathered: outputs and history per frame."""
    from fovtrace_torch import Camera
    from fovtrace_torch.dist import collectives as coll
    from fovtrace_torch.dist import sharding as shd
    from fovtrace_torch.scene import procedural

    config = frame_config(**cfg_kw)
    sc = procedural.SCENES[scene]("cpu")
    cam = Camera.create(eye=FRAME_EYE, target=FRAME_TARGET, device="cpu")
    cams = [cam, cam.replace(eye=torch.tensor(FRAME_EYE2))][:frames]
    state = shd.initial_state_sharded(cam, config, mesh)
    res = {}
    for f, c in enumerate(cams):
        out, state = shd.render_sharded(sc, c, gaze, state, config, mesh)
        full = shd.gather_frame(out, mesh)
        for k in ("image", "shading", "mask", "ray_count", "rays_dropped",
                  "rays_traced", "gaze_target"):
            res[f"{k}{f}"] = full[k]
        res[f"history{f}"] = coll.all_gather_rows(state.history, mesh,
                                                  dim=1)
    return res


def atrous_fields(seed, h, w):
    """tests/test_dist.py's A-Trous inputs."""
    r = np.random.default_rng(seed)
    return {"color": r.uniform(size=(h, w, 3)).astype(np.float32),
            "pos": r.uniform(size=(h, w, 3)).astype(np.float32),
            "nrm": r.normal(size=(h, w, 3)).astype(np.float32)}


def sparse_field(seed, h, w):
    """tests/test_dist.py's sparse pull-push input: ~20% samples."""
    r = np.random.default_rng(seed)
    sparse = r.uniform(size=(h, w, 4)).astype(np.float32)
    sparse[..., 3] = (r.uniform(size=(h, w)) < 0.2).astype(np.float32)
    sparse[..., :3] *= sparse[..., 3:4]
    return sparse


def case_filters(mesh, pp_shape, at_shape, iterations):
    """pull_push_sharded on tests/test_dist.py's sparse field, A-Trous
    (each iteration count) on its seeded fields, JFA and Sibson on the
    sparse field; each gathered."""
    from fovtrace_torch.core import vec
    from fovtrace_torch.dist import collectives as coll
    from fovtrace_torch.dist import recon

    res = {}
    h, w = pp_shape
    bh = h // mesh.size
    sp = torch.as_tensor(sparse_field(3, h, w))
    mine = coll.my_rows(sp, mesh, bh)
    rgb, a = recon.pull_push_sharded(vec.from_rows(mine[..., :3]),
                                     mine[..., 3], mesh)
    res["pullpush"] = coll.all_gather_rows(
        torch.cat([vec.to_rows(rgb), a[..., None]], dim=-1), mesh)
    coord, color = recon.jfa_sharded(mine, mesh)
    res["jfa_coord"] = coll.all_gather_rows(coord, mesh)
    res["jfa_color"] = coll.all_gather_rows(color, mesh)
    res["sibson"] = coll.all_gather_rows(recon.sibson_sharded(mine, mesh, 4),
                                         mesh)
    h, w = at_shape
    bh = h // mesh.size
    f = {k: vec.from_rows(coll.my_rows(torch.as_tensor(v), mesh, bh))
         for k, v in atrous_fields(5, h, w).items()}
    for it in iterations:
        out = recon.atrous_sharded(f["color"], f["pos"], f["nrm"], it, 1.0,
                                   0.5, 0.5, mesh, mesh.rank * bh, h)
        res[f"atrous{it}"] = coll.all_gather_rows(vec.to_rows(out), mesh)
    return res


TRAIN_EYE, TRAIN_TARGET = (3.0, 2.5, 4.0), (0.0, 0.6, 0.0)


def train_config(size=32):
    """app/optimize's configuration at a test size."""
    from fovtrace_torch import RenderConfig

    return RenderConfig(width=size, height=size, max_depth=2,
                        diffuse_max_depth=1, reconstruction="none")


def train_start(scene, cam, device="cpu"):
    """The perturbed start of app/optimize (eye + 0.25 along a seeded
    direction, emission x 1.5) and the gaze off centre."""
    from fovtrace_torch.dist import train

    true = train.init_params(scene, cam)
    delta = np.random.default_rng(0).normal(size=3).astype(np.float32)
    delta = delta / np.linalg.norm(delta) * np.float32(0.25)
    return true, true.replace(
        eye=true.eye + torch.as_tensor(delta, device=device),
        light_emission=true.light_emission * 1.5,
        gaze_uv=torch.tensor([0.45, 0.55], device=device))


def case_train(mesh, foveated=False, soft=False, size=32, steps=1):
    """The train step's loss and gradients at app/optimize's start on
    box, then `steps` Adam steps: loss, gradients and the parameters
    after them."""
    from fovtrace_torch import Camera
    from fovtrace_torch.dist import train
    from fovtrace_torch.scene import procedural

    config = train_config(size)
    scene = procedural.box_scene("cpu")
    cam = Camera.create(eye=TRAIN_EYE, target=TRAIN_TARGET, device="cpu")
    bh = config.height // mesh.size
    true, start = train_start(scene, cam)
    with torch.no_grad():
        sc, c = train._apply_params(scene, cam, true)
        target = train.render_rows_dense(sc, c, true, mesh.rank * bh, bh,
                                         config, 0)
    params = train.leaves(start)
    train.broadcast_params(params, mesh)
    loss, grads = train.make_loss_and_grad(scene, cam, config, mesh,
                                           foveated, soft)(params, target, 0)
    res = {"loss": loss}
    res.update({f"grad_{k}": v for k, v in
                zip(("eye", "target", "gaze_uv", "light_emission", "kd",
                     "envmap"), grads.tensors())})
    opt = train.make_optimizer(params, 1e-2)
    step = train.make_train_step(scene, cam, config, mesh, foveated, soft)
    for s in range(steps):
        res[f"loss_step{s}"] = step(params, opt, target, s)
    res["eye"] = params.eye.detach()
    res["light_emission"] = params.light_emission.detach()
    return res


def span_tree(prof) -> dict:
    """{(span, its innermost enclosing span or ""): count} of the
    program's spans (fov.*) in a finished torch.profiler run."""
    tree = {}
    for e in prof.events():
        if not e.name.startswith("fov."):
            continue
        p = e.cpu_parent
        while p is not None and not p.name.startswith("fov."):
            p = p.cpu_parent
        key = (e.name, "" if p is None else p.name)
        tree[key] = tree.get(key, 0) + 1
    return tree


def profiled(fn):
    """(fn(), the span tree of its run) under torch.profiler (CPU)."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        res = fn()
    return res, span_tree(prof)


def case_spans(mesh, gaze, **cfg_kw):
    """One sharded frame of the multi scene from the initial state, with
    no profiler and then under one: both frames' gathered image, mask
    and history, and the profiled frame's span tree as entries
    "tree/<span>/<parent>" (the span count)."""
    from fovtrace_torch import Camera
    from fovtrace_torch.dist import collectives as coll
    from fovtrace_torch.dist import sharding as shd
    from fovtrace_torch.scene import procedural

    config = frame_config(**cfg_kw)
    sc = procedural.multi_object_scene("cpu")
    cam = Camera.create(eye=FRAME_EYE, target=FRAME_TARGET, device="cpu")
    state = shd.initial_state_sharded(cam, config, mesh)
    render = lambda: shd.render_sharded(sc, cam, gaze, state, config, mesh)
    res = {}
    off = render()
    on, tree = profiled(render)
    for label, (out, new) in (("off", off), ("on", on)):
        full = shd.gather_frame(out, mesh)
        for k in ("image", "mask", "ray_count", "rays_traced"):
            res[f"{label}/{k}"] = full[k]
        res[f"{label}/history"] = coll.all_gather_rows(new.history, mesh,
                                                       dim=1)
        res[f"{label}/depth"] = coll.all_gather_rows(new.depth_cache, mesh)
    for (name, parent), n in tree.items():
        res[f"tree/{name}/{parent}"] = torch.tensor(n)
    return res


def case_several(mesh, cases):
    """Several cases in one launch of the ranks (each rank process costs
    seconds of start-up): {label: [case, kw]} -> rank 0's results of
    each, keyed "label/key"."""
    res = {}
    for label, (case, kw) in cases.items():
        for k, v in globals()[f"case_{case}"](mesh, **kw).items():
            res[f"{label}/{k}"] = v
    return res


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--case", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--kw", default="{}")
    args = p.parse_args(argv)
    torch.set_num_threads(1)
    from fovtrace_torch.dist import launch

    assert launch.init_distributed(device="cpu")
    mesh = launch.global_mesh("cpu")
    res = globals()[f"case_{args.case}"](mesh, **json.loads(args.kw))
    if mesh.rank == 0:
        torch.save({k: v.detach() for k, v in res.items()}, args.out)
    launch.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
