"""Inverse rendering from the command line (counterpart of
`fovtrace/app/optimize.py`).

Recovers the camera's eye and the light's power from a target image by
gradient descent through the renderer, the rows split over the ranks of
the process group (dist.train), with checkpoint and resume. Exits 0 iff
the final eye error is below --perturb.

Run:  python -m fovtrace_torch.app.optimize --scene box --steps 60 \\
          --ckpt /tmp/fovopt --perturb 0.3
      torchrun --standalone --nproc_per_node 4 \\
          -m fovtrace_torch.app.optimize --scene earth --steps 60
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="fovtrace_torch inverse rendering")
    p.add_argument("--device", default="cuda",
                   help="torch device (cuda: each rank's cuda:LOCAL_RANK)")
    p.add_argument("--scene", default="box")
    p.add_argument("--width", type=int, default=128)
    p.add_argument("--height", type=int, default=128)
    p.add_argument("--steps", type=int, default=60)
    p.add_argument("--lr", type=float, default=2e-2)
    p.add_argument("--perturb", type=float, default=0.3,
                   help="initial camera-eye offset magnitude")
    p.add_argument("--ckpt", default=None, help="checkpoint directory")
    p.add_argument("--ckpt-every", type=int, default=20)
    p.add_argument("--max-depth", type=int, default=2)
    p.add_argument("--devices", type=int, default=None,
                   help="number of row tiles; must be the process group's "
                        "size (default: that size)")
    return p


def main(argv=None) -> int:
    args = build_argparser().parse_args(argv)

    from fovtrace_torch import Camera, RenderConfig
    from fovtrace_torch.dist import checkpoint as ckpt
    from fovtrace_torch.dist import launch
    from fovtrace_torch.dist import sharding as shd
    from fovtrace_torch.dist import train
    from fovtrace_torch.kernels import cluster_isect as ci
    from fovtrace_torch.scene import procedural

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda, but torch.cuda.is_available() is "
                         "false")
    had_group = torch.distributed.is_initialized()
    launch.init_distributed(device=device)
    mesh = shd.make_mesh(args.devices, device)
    log = (lambda msg: print(msg, file=sys.stderr)) \
        if launch.is_coordinator() else (lambda msg: None)
    h = args.height - args.height % mesh.size   # rows divide the ranks
    config = RenderConfig(width=args.width, height=h,
                          max_depth=args.max_depth, diffuse_max_depth=1,
                          reconstruction="none")
    scene = procedural.SCENES[args.scene](mesh.device)
    cam = Camera.create(eye=(3.0, 2.5, 4.0), target=(0.0, 0.6, 0.0),
                        device=mesh.device)
    log(f"[optimize] scene={args.scene} {args.width}x{h} "
        f"devices={mesh.size} steps={args.steps} on {mesh.device}")

    # the target: a render with the TRUE parameters
    true_params = train.init_params(scene, cam)
    target = _render_target(scene, cam, true_params, config, mesh)

    # a perturbed start
    delta = np.random.default_rng(0).normal(size=3).astype(np.float32)
    delta = delta / np.linalg.norm(delta) * args.perturb
    params = train.leaves(true_params.replace(
        eye=true_params.eye + torch.as_tensor(delta, device=mesh.device),
        light_emission=true_params.light_emission * 1.5))
    optimizer = train.make_optimizer(params, args.lr)
    step_fn = train.make_train_step(scene, cam, config, mesh)

    start_step = 0
    if args.ckpt:
        start_step, state = ckpt.restore_or_init(
            args.ckpt, {"params": params, "optimizer": optimizer.state_dict()})
        if start_step:
            with torch.no_grad():
                for p, v in zip(params.tensors(),
                                state["params"].tensors()):
                    p.copy_(v)
            optimizer.load_state_dict(state["optimizer"])
            log(f"[optimize] resumed from step {start_step}")
    train.broadcast_params(params, mesh)

    def eye_error() -> float:
        return float(torch.linalg.vector_norm(params.eye.detach()
                                              - true_params.eye))

    t0 = time.perf_counter()
    loss = None
    for step in range(start_step, args.steps):
        loss = step_fn(params, optimizer, target, step)
        if step % max(1, args.steps // 10) == 0 or step == args.steps - 1:
            log(f"[optimize] step {step}: loss={float(loss):.6f} "
                f"eye_err={eye_error():.4f}")
        if args.ckpt and (step + 1) % args.ckpt_every == 0 \
                and launch.is_coordinator():
            ckpt.save(args.ckpt, step + 1, {
                "params": params, "optimizer": optimizer.state_dict()})
    if args.ckpt and launch.is_coordinator():
        ckpt.save(args.ckpt, args.steps, {
            "params": params, "optimizer": optimizer.state_dict()})

    err = eye_error()
    wall = time.perf_counter() - t0
    ran = max(0, args.steps - start_step)
    loss_s = f"{float(loss):.6f}" if loss is not None \
        else "n/a (resumed past end)"
    per_step = f"{wall / ran:.4f} s/step" if ran else "no steps"
    log(f"[optimize] done in {wall:.1f}s ({ran} steps, {per_step}) | final "
        f"loss {loss_s} | eye error {err:.4f} (start {args.perturb:.3f})")
    launched = {k: v for k, v in ci.counters().items() if v}
    log(f"[optimize] kernel launches and plain calls: {launched}")
    if not had_group:
        launch.shutdown()
    return 0 if err < args.perturb else 1


def _render_target(scene, cam, params, config, mesh):
    """This rank's rows of the dense render with `params`, frame 0."""
    from fovtrace_torch.dist import train

    block_h = config.height // mesh.size
    sc, c = train._apply_params(scene, cam, params)
    with torch.no_grad():
        return train.render_rows_dense(sc, c, params, mesh.rank * block_h,
                                       block_h, config, 0)


if __name__ == "__main__":
    raise SystemExit(main())
