"""Aperture sweep: ray % and throughput against the foveal radius
(counterpart of `scripts/aperture_sweep.py`).

    python -m fovtrace_torch.scripts.aperture_sweep [--device cuda]
        [--width 1920 --height 1088] [--iters 5] [--out DIR]

Per aperture, forward frames of the bench configuration (masked
sampling, atrous, max_depth 4, diffuse_max_depth 1, ray_budget_frac
0.75, no view buffers, the gaze at the centre): a first frame (its mask
must fit the budget; its ray_count and rays_traced are the row's), one
warm frame, then --iters frames from the warm frame's state, timed on the
host clock ending in a device synchronise. Writes SWEEP_torch.csv under
--out (aperture, ray_pct, frame_ms, mrays_s = rays_traced / frame_ms /
1e3) and prints one JSON line per aperture.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

from fovtrace_torch.scripts import (EYE, REPORTS_DIR, TARGET, device_label,
                                    open_device, sync)

APERTURES = (0.03, 0.05, 0.07, 0.09, 0.11, 0.14)


def sweep_config(width: int, height: int, aperture: float):
    from fovtrace_torch.config import RenderConfig

    return RenderConfig(width=width, height=height, reconstruction="atrous",
                        max_depth=4, diffuse_max_depth=1, aperture=aperture,
                        ray_budget_frac=0.75, full_outputs=False)


def sweep_rows(scene, cam, width: int, height: int, apertures, iters: int,
               log=None) -> list:
    """One row per aperture: aperture, ray_pct, frame_ms, mrays_s,
    rays_traced. `log(row)` is called as each row is done."""
    from fovtrace_torch.render import pipeline

    dev = cam.eye.device
    gaze = (height // 2, width // 2)
    rows = []
    for a in apertures:
        config = sweep_config(width, height, a)
        state = pipeline.FrameState.initial(cam, config)
        out, state = pipeline.render_frame(scene, cam, gaze, state, config)
        if int(out["rays_dropped"]) != 0:
            raise RuntimeError(f"aperture {a}: the budget truncated the "
                               "mask: raise ray_budget_frac")
        rays = int(out["rays_traced"])
        ray_pct = 100.0 * float(out["ray_count"]) / (height * width)
        out, state = pipeline.render_frame(scene, cam, gaze, state, config)
        sync(dev)
        t0 = time.perf_counter()
        for _ in range(iters):
            out, _ = pipeline.render_frame(scene, cam, gaze, state, config)
        sync(dev)
        ms = (time.perf_counter() - t0) / iters * 1e3
        row = {"aperture": a, "ray_pct": ray_pct, "frame_ms": ms,
               "mrays_s": rays / ms / 1e3, "rays_traced": rays}
        rows.append(row)
        if log is not None:
            log(row)
    return rows


def build_argparser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--width", type=int, default=1920)
    ap.add_argument("--height", type=int, default=1088)
    ap.add_argument("--scene", default="earth")
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--apertures", type=float, nargs="*",
                    default=list(APERTURES))
    ap.add_argument("--out", default=str(REPORTS_DIR),
                    help="directory of SWEEP_torch.csv")
    return ap


def main(argv=None) -> int:
    from fovtrace_torch.config import pin_fp32
    from fovtrace_torch.core.camera import Camera
    from fovtrace_torch.scene import procedural

    args = build_argparser().parse_args(argv)
    dev = open_device(args.device)
    pin_fp32(dev)
    label = device_label(dev)
    scene = procedural.SCENES[args.scene](dev)
    cam = Camera.create(eye=EYE, target=TARGET, device=dev)

    def log(r):
        print(json.dumps(r), flush=True)
        print(f"[sweep] a={r['aperture']} rays {r['ray_pct']:.2f}% "
              f"{r['frame_ms']:.2f} ms {r['mrays_s']:.2f} Mrays/s  "
              f"[{label}]", file=sys.stderr, flush=True)

    rows = sweep_rows(scene, cam, args.width, args.height, args.apertures,
                      args.iters, log=log)
    lines = ["aperture,ray_pct,frame_ms,mrays_s"] + [
        f"{r['aperture']},{r['ray_pct']:.4f},{r['frame_ms']:.3f},"
        f"{r['mrays_s']:.3f}" for r in rows]
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    (out / "SWEEP_torch.csv").write_text("\n".join(lines) + "\n")
    print(f"[sweep] wrote {out / 'SWEEP_torch.csv'} ({args.scene} "
          f"{args.width}x{args.height}, {label})", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
