"""A train cell: fovtrace_torch's inverse-rendering step
(dist/train.make_train_step, as app/optimize.py builds it) under a
`train` traffic mix, one step after another.

Set-up builds the program's scene and camera, renders the target with
the true parameters, perturbs the start (the eye by `eye_perturb` in a
seeded direction, the light by `light_scale`), builds the step with its
parameters and Adam, and drives that same object through its first
`checked_steps` steps, through the window's own call, on frames 0, 1, 2
(each frame seeds other rays). It keeps each step's loss, the first
gradient as Adam holds it after one step (exp_avg / (1 - beta1)) and the
parameters after the last checked step. The window then runs steps until
`seconds` have passed, each ending when its loss and a finiteness flag
of every gradient are on the host. Once the program's state is freed,
the reference follows the first `checked_steps` steps from the same
start (benchmark/reference/train.py).
"""

from __future__ import annotations

import gc

import torch

from harness import arith, check, program, refside, scenes, trace, traffic
from harness.viewer import Run, peak_bytes, sync


def _params_of(config: dict, mix: dict, seed: int):
    """(eye, target, eye offset) of the cell's start."""
    cam = config["camera"]
    return cam["eye"], mix["target_point"], traffic.train_start(seed, mix)


def run_program(run: Run) -> dict:
    from fovtrace_torch.dist import train
    from fovtrace_torch.dist.collectives import Mesh

    cfg, mix, dev = run.config, run.mix, run.device
    eye, target, delta = _params_of(cfg, mix, run.seed)
    t = trace.host_clock()
    scene = program.build_scene(cfg, scenes.mesh_arrays(cfg),
                                scenes.envmap_array(cfg), dev)
    sync(dev)
    scene_build_s = trace.host_clock() - t
    rc = program.render_config(cfg, mix["render"])
    cam = program.camera(eye, target, cfg, dev)
    mesh = Mesh(rank=0, size=1, device=dev)

    true_params = train.init_params(scene, cam)
    with torch.no_grad():
        sc, c = train._apply_params(scene, cam, true_params)
        target_rows = train.render_rows_dense(sc, c, true_params, 0,
                                              cfg["height"], rc, 0)
    params = train.leaves(true_params.replace(
        eye=true_params.eye + torch.as_tensor(delta, device=dev),
        light_emission=true_params.light_emission * mix["light_scale"]))
    start = [p.detach().clone() for p in params.tensors()]
    opt = train.make_optimizer(params, mix["lr"])
    step_fn = train.make_train_step(scene, cam, rc, mesh)

    def step(i):
        loss = step_fn(params, opt, target_rows, i)
        finite = torch.stack([torch.isfinite(p.grad).all()
                              for p in params.tensors()]).all()
        return torch.stack([loss.detach().float(), finite.float()])

    losses, failed = [], 0
    grad1 = None
    checked = mix["checked_steps"]
    for i in range(checked):
        v = step(i).cpu()
        losses.append(float(v[0]))
        failed += int(not (torch.isfinite(v[0]) and v[1] > 0))
        if i == 0:
            # what Adam got (zero where it holds no state: it got nothing)
            b1 = opt.param_groups[0]["betas"][0]
            grad1 = [(opt.state[p]["exp_avg"] / (1.0 - b1)).cpu()
                     if "exp_avg" in opt.state.get(p, {})
                     else torch.zeros_like(p, device="cpu")
                     for p in params.tensors()]
    change = [(p.detach() - s).cpu() for p, s in zip(params.tensors(),
                                                      start)]
    setup_s = trace.host_clock() - run.t0

    lat, enq = [], []
    attempted = checked
    rec = None
    w0 = trace.host_clock()
    i = checked
    while True:
        if run.traced and i == checked:
            n = mix["traced_steps"]
            holder = {"failed": 0}

            def body(j):
                v = step(checked + j)
                holder["failed"] += (~torch.isfinite(v[0]) | (v[1] == 0)).int()
            rec = trace.profile(body, n, dev)
            failed += int(holder["failed"])
            attempted += n
            i += n
            continue
        t = trace.host_clock()
        d = step(i)
        e = trace.host_clock()
        v = d.cpu()
        done = trace.host_clock()
        lat.append(done - t)
        enq.append(e - t)
        attempted += 1
        failed += int(not (torch.isfinite(v[0]) and v[1] > 0))
        i += 1
        if done - w0 >= run.seconds:
            break
    window_s = trace.host_clock() - w0
    peak = peak_bytes(dev)
    del scene, params, opt, step_fn, target_rows, true_params, sc, c, start
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return {"lead": True, "setup_s": setup_s, "window_s": window_s,
            "latencies": lat, "enqueue": enq, "attempted": attempted,
            "failed": failed, "peak": peak, "records": rec,
            "scene_build_s": scene_build_s,
            "checked": {"losses": losses, "grad1": grad1, "change": change}}


def reference_steps(run: Run, quantize=None) -> dict:
    """The reference's first `checked_steps` steps from the same start:
    {losses, grad1, change} on the host."""
    from reference import train as rt

    cfg, mix, dev = run.config, run.mix, run.device
    eye, target, delta = _params_of(cfg, mix, run.seed)
    scene = refside.build_scene(cfg, scenes.mesh_arrays(cfg),
                                scenes.envmap_array(cfg), dev)
    rc = refside.render_config(cfg, mix["render"])
    cam = refside.camera(eye, target, cfg, dev)
    rows = mix["reference_block_rows"]
    true_params = rt.init_params(scene, cam)
    with torch.no_grad():
        sc, c = rt._apply_params(scene, cam, true_params)
        target_rows = torch.cat([
            rt.render_rows_dense(sc, c, true_params, y0,
                                 min(rows, cfg["height"] - y0), rc, 0)
            for y0 in range(0, cfg["height"], rows)])
    params = true_params.replace(
        eye=true_params.eye + torch.as_tensor(delta, device=dev),
        light_emission=true_params.light_emission * mix["light_scale"])
    start = params.tensors()
    adam = rt.Adam(lr=mix["lr"])
    losses, grad1 = [], None
    for i in range(mix["checked_steps"]):
        loss, grads = rt.loss_and_grad(scene, cam, params, target_rows, i,
                                       rc, rows, quantize)
        losses.append(float(loss))
        if i == 0:
            grad1 = [g.cpu() for g in grads.tensors()]
        params = adam.update(params, grads)
    change = [(p - s).cpu() for p, s in zip(params.tensors(), start)]
    return {"losses": losses, "grad1": grad1, "change": change}


def train_bound_s(run: Run) -> float:
    return arith.train_adjoints_s(run.config, dict(
        run.config["render"], **run.mix["render"]))


def compare(got: dict, ref: dict) -> dict:
    return check.train_numbers(got["checked"], ref)
