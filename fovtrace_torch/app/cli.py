"""Headless renderer CLI (counterpart of `fovtrace/app/cli.py`).

Run:  python -m fovtrace_torch.app.cli --device cuda --scene earth \\
          --width 1920 --height 1088 --frames 3

`--scene` takes every scene of `scene.procedural.SCENES` (box, bunny,
city, earth, multi, vokselia); city, the 170k-triangle scene, takes the
streaming kernels.

Renders a gaze trajectory through `render.pipeline.render_frame` and
prints steady-state ms/frame and ray throughput. Every sampling mode
(`--sampling`, also spelt `--sampling-mode`) and reconstruction of the
reference runs, and `--view saliency` writes the saliency heat map.
What the port does not run yet (.obj / .json / asset-directory scenes)
is refused with a message, never substituted.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np
import torch

from fovtrace_torch.config import RECONSTRUCTIONS, SAMPLING_MODES
from fovtrace_torch.scene import procedural

# --view -> output key; a view whose buffer the frame did not produce
# (jfa under atrous, say) shows the image, as in the reference
_VIEWS = {"image": "image", "depth": "depth", "albedo": "albedo",
          "weight": "weight", "shading": "shading",
          "saliency": "saliency_view", "mask": "mask", "jfa": "jfa",
          "sibson": "sibson", "pullpush": "pullpush", "atrous": "atrous"}


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="fovtrace_torch: foveated path tracer (PyTorch/CUDA)")
    p.add_argument("--device", default="cuda",
                   help="torch device to render on (cuda, cuda:1, cpu)")
    p.add_argument("--scene", default="earth",
                   help=f"one of {sorted(procedural.SCENES)} (.obj, .json "
                        f"and asset-directory scenes are not ported)")
    p.add_argument("--width", type=int, default=1024)
    p.add_argument("--height", type=int, default=1024)
    p.add_argument("--frames", type=int, default=16)
    p.add_argument("--gaze", default="circle",
                   help="fixed | circle | lissajous | path/to/trajectory.csv")
    p.add_argument("--view", default="image", choices=sorted(_VIEWS))
    p.add_argument("--reconstruction", default="atrous",
                   choices=RECONSTRUCTIONS)
    p.add_argument("--sampling", "--sampling-mode", default="masked",
                   choices=SAMPLING_MODES)
    p.add_argument("--intersect-backend", default="auto",
                   choices=["auto", "cluster", "brute"])
    p.add_argument("--aperture", type=float, default=0.07)
    p.add_argument("--dof", action="store_true",
                   help="thin-lens depth of field with gaze autofocus")
    p.add_argument("--lens-radius", type=float, default=0.05)
    p.add_argument("--light-power", type=float, default=810.0)
    p.add_argument("--gi-depth", type=int, default=1)
    p.add_argument("--max-depth", type=int, default=4)
    p.add_argument("--ray-budget-frac", type=float, default=0.35)
    p.add_argument("--no-optimize", action="store_true",
                   help="disable foveation (trace every pixel)")
    p.add_argument("--no-temporal", action="store_true")
    p.add_argument("--eye", type=float, nargs=3, default=(3.0, 2.5, 4.0))
    p.add_argument("--target", type=float, nargs=3, default=(0.0, 0.8, 0.0))
    p.add_argument("--out", default=None, help="directory for frame dumps")
    p.add_argument("--save-every", type=int, default=0,
                   help="dump every Nth frame (0 = last frame only)")
    p.add_argument("--format", default="ppm", choices=["ppm", "npy"])
    p.add_argument("--report", default=None, help="per-frame CSV report path")
    p.add_argument("--sharded", action="store_true",
                   help="split the screen's rows over the ranks of the "
                        "process group (dist.launch: torchrun or the "
                        "FOVTRACE_* variables; one rank without them)")
    return p


def make_config(args):
    from fovtrace_torch.config import RenderConfig

    if args.scene not in procedural.SCENES:
        raise SystemExit(f"--scene {args.scene}: scene files and asset "
                         f"directories are not ported to fovtrace_torch yet; "
                         f"use one of {sorted(procedural.SCENES)}")
    sampling = "full" if args.no_optimize else args.sampling
    return RenderConfig(
        width=args.width, height=args.height, aperture=args.aperture,
        sampling_mode=sampling, diffuse_max_depth=args.gi_depth,
        max_depth=args.max_depth,
        ray_budget_frac=1.0 if args.no_optimize else args.ray_budget_frac,
        temporal=not args.no_temporal, reconstruction=args.reconstruction,
        dof=args.dof, lens_radius=args.lens_radius,
        intersect_backend=args.intersect_backend,
        full_outputs=args.out is not None)


def load_scene(name: str, device, light_power: float = 810.0):
    from fovtrace_torch.scene.scene import ParallelogramLight

    scene = procedural.SCENES[name]("cpu")
    if light_power != 810.0:
        scene = scene.replace(light=ParallelogramLight.default(light_power))
    return scene.to(device)


def to_u8_image(view: str, out: dict) -> np.ndarray:
    """A selected output buffer as an HxWx3 uint8 image."""
    key = _VIEWS[view]
    if key == "image" and "image" not in out:
        from fovtrace_torch.core import vec

        buf = vec.to_rows(out["image_rgb"])
    else:
        buf = out.get(key, out.get("image"))
    buf = buf.detach().float().cpu().numpy()
    if buf.ndim == 2:
        mx = buf.max()
        buf = np.stack([buf / mx if mx > 0 else buf] * 3, axis=-1)
    buf = buf[..., :3]
    return (np.clip(buf, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)


def save_frame(path_base: str, fmt: str, img_u8: np.ndarray) -> str:
    if fmt == "ppm":
        path = path_base + ".ppm"
        h, w = img_u8.shape[:2]
        with open(path, "wb") as f:
            f.write(f"P6\n{w} {h}\n255\n".encode())
            f.write(np.ascontiguousarray(img_u8).tobytes())
        return path
    np.save(path_base + ".npy", img_u8)
    return path_base + ".npy"


def run(args, scene=None) -> dict:
    """Render the trajectory. Returns the last frame's outputs and
    per-frame lists: frame_ms (host clock around a frame that ends in a
    device synchronise), ray_count, rays_traced, rays_dropped."""
    from fovtrace_torch.app import profiler, trajectory
    from fovtrace_torch.core.camera import Camera
    from fovtrace_torch.render import pipeline

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda, but torch.cuda.is_available() is "
                         "false")
    config = make_config(args)
    mesh = None
    if args.sharded:
        from fovtrace_torch.dist import launch
        from fovtrace_torch.dist import sharding as shd

        launch.init_distributed(device=device)
        mesh = shd.make_mesh(device=device)
        device = mesh.device
    if scene is None:
        scene = load_scene(args.scene, device, args.light_power)
    cam = Camera.create(eye=tuple(args.eye), target=tuple(args.target),
                        device=device)
    gazes, poses = trajectory.make(args.gaze, args.height, args.width,
                                   args.frames)
    if mesh is None:
        state = pipeline.FrameState.initial(cam, config)
        render = pipeline.render_frame
        whole = lambda out: out
    else:
        state = shd.initial_state_sharded(cam, config, mesh)
        render = lambda *a: shd.render_sharded(*a, mesh)
        whole = lambda out: shd.gather_frame(out, mesh)
    writes = mesh is None or launch.is_coordinator()
    timer = profiler.StageTimer()
    if args.out:
        os.makedirs(args.out, exist_ok=True)
    sync = (lambda: torch.cuda.synchronize(device)) \
        if device.type == "cuda" else (lambda: None)

    stats = {"frame_ms": [], "ray_count": [], "rays_traced": [],
             "rays_dropped": []}
    out = None
    for f, gaze in enumerate(gazes):
        if poses is not None:
            eye, tgt = poses[f]
            cam = Camera.create(eye=eye, target=tgt, device=device)
        t0 = time.perf_counter()
        out, state = render(scene, cam, gaze, state, config)
        sync()
        frame_ms = (time.perf_counter() - t0) * 1e3
        rays = int(out["ray_count"])
        stats["frame_ms"].append(frame_ms)
        stats["ray_count"].append(rays)
        stats["rays_traced"].append(int(out["rays_traced"]))
        stats["rays_dropped"].append(int(out["rays_dropped"]))
        timer.add("frame_ms", frame_ms)
        timer.end_frame(extra={
            "frame": float(f), "fps": 1000.0 / max(frame_ms, 1e-6),
            "aperture": args.aperture, "ray_count": float(rays),
            "rays_traced": float(stats["rays_traced"][-1]),
            "ray_pct": 100.0 * rays / (args.width * args.height)})
        if args.out and args.save_every and f % args.save_every == 0:
            img = to_u8_image(args.view, whole(out))
            if writes:
                save_frame(os.path.join(args.out, f"frame_{f:04d}"),
                           args.format, img)
    if args.out and out is not None:
        img = to_u8_image(args.view, whole(out))
        if writes:
            p = save_frame(os.path.join(args.out, "frame_final"),
                           args.format, img)
            print(f"[fovtrace_torch] wrote {p}", file=sys.stderr)
    if args.report and writes:
        timer.write_csv(args.report)
    stats.update(out=out, config=config, state=state, mesh=mesh)
    return stats


def main(argv=None) -> int:
    args = build_argparser().parse_args(argv)
    t_all = time.perf_counter()
    stats = run(args)
    wall = time.perf_counter() - t_all
    # steady state excludes the first frame (kernel build, warm-up)
    steady = stats["frame_ms"][1:] or stats["frame_ms"]
    mean_ms = float(np.mean(steady))
    rays = float(np.mean(stats["rays_traced"]))
    dev = torch.device(args.device)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"[fovtrace_torch] {args.scene} {args.width}x{args.height} "
          f"{args.frames} frames in {wall:.2f}s on {name} | steady "
          f"{mean_ms:.2f} ms/frame | {rays:.0f} rays traced/frame "
          f"({rays / mean_ms / 1e3:.2f} Mrays/s) | rays dropped "
          f"{max(stats['rays_dropped'])}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
