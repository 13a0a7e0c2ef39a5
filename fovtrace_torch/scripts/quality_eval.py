"""Foveated-vs-ground-truth quality harness (counterpart of
`scripts/quality_eval.py`).

    python -m fovtrace_torch.scripts.quality_eval [--device cuda] [--quick]
        [--width 960 --height 544 --frames 20 --warmup 8] [--out DIR]

Both renders run in-process over a gaze trajectory: the ground truth
samples every pixel (`sampling_mode="full"`, no reconstruction, the whole
frame in the ray budget), and each (sampling mode x reconstruction) is
held against it, frame by frame after the temporal warm-up:

  - full-frame PSNR and SSIM (7x7 uniform window, no padding, the mean
    over the three channels)
  - PSNR inside gaze-centred annuli: fovea (r < aperture), mid
    (aperture..2*aperture), periphery (> 2*aperture), r as a fraction of
    the screen diagonal
  - mean ray % (mask pixels / pixels, the `ray_count` of every frame)

With a fixed gaze every sampled pixel draws the ground truth's samples
(per-pixel RNG seeds), so the fovea is bit for bit the ground truth's:
99.0 dB. The metrics run on the frames' device in float64; SSIM's window
means are one `avg_pool2d` each. Writes QUALITY_torch.md and
quality_torch.json under --out, and prints one JSON line per row.
"""

from __future__ import annotations

import argparse
import json
import math
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from fovtrace_torch.scripts import (EYE, REPORTS_DIR, TARGET, device_label,
                                    open_device)

MODES, RECONS = ("masked", "weier", "logpolar"), ("jfa", "sibson",
                                                  "pullpush", "atrous")
QUICK_MODES, QUICK_RECONS = ("masked",), ("pullpush", "atrous")


def psnr(a: torch.Tensor, b: torch.Tensor) -> float:
    """PSNR in dB of two images in [0, 1]; 99.0 when they are equal (mean
    squared error <= 1e-12)."""
    mse = float(torch.mean((a.double() - b.double()) ** 2))
    if mse <= 1e-12:
        return 99.0
    return 10.0 * math.log10(1.0 / mse)


def ssim(a: torch.Tensor, b: torch.Tensor, win: int = 7,
         c1: float = 0.01 ** 2, c2: float = 0.03 ** 2) -> float:
    """Mean SSIM of two [H, W, 3] images with a uniform win x win window
    (valid positions only), averaged over the channels."""
    x = a.double().permute(2, 0, 1)[:, None]     # [3, 1, H, W]
    y = b.double().permute(2, 0, 1)[:, None]

    def mean(t):
        return F.avg_pool2d(t, win, stride=1)

    xs, ys = mean(x), mean(y)
    vx = mean(x * x) - xs * xs
    vy = mean(y * y) - ys * ys
    cxy = mean(x * y) - xs * ys
    num = (2 * xs * ys + c1) * (2 * cxy + c2)
    den = (xs * xs + ys * ys + c1) * (vx + vy + c2)
    return float((num / den).mean(dim=(1, 2, 3)).mean())


def annulus_masks(h: int, w: int, gaze, aperture: float, device="cpu"):
    """(fovea, mid, periphery) [H, W] bool masks around gaze (gy, gx).

    The distance rounds as the reference's does: the pixel distance to
    float32 (an exact sum of squares, a correctly rounded root), divided
    by the diagonal in float64."""
    gy, gx = gaze
    yy = torch.arange(h, dtype=torch.float64, device=device)[:, None]
    xx = torch.arange(w, dtype=torch.float64, device=device)[None, :]
    r = torch.sqrt((xx - gx) ** 2 + (yy - gy) ** 2).float()
    d = r.double() / float(np.hypot(w, h))
    return (d < aperture, (d >= aperture) & (d < 2 * aperture),
            d >= 2 * aperture)


def region_psnr(a: torch.Tensor, b: torch.Tensor, m: torch.Tensor) -> float:
    """PSNR over the pixels of mask m; nan when m is empty."""
    if not bool(m.any()):
        return float("nan")
    return psnr(a[m], b[m])


def render_run(scene, cam, gazes, config):
    """Render the gaze trajectory from the initial state. Returns the
    [H, W, 3] frames and each frame's ray fraction (ray_count / pixels);
    raises if the budget truncated a frame's mask."""
    from fovtrace_torch.core import vec
    from fovtrace_torch.render import pipeline

    h, w = config.height, config.width
    state = pipeline.FrameState.initial(cam, config)
    frames, rayfracs = [], []
    for g in gazes:
        out, state = pipeline.render_frame(scene, cam, g, state, config)
        if int(out["rays_dropped"]) != 0:
            raise RuntimeError("the budget truncated the mask: raise "
                               "ray_budget_frac")
        frames.append(vec.to_rows(out["image_rgb"]))
        rayfracs.append(float(out["ray_count"]) / (h * w))
    return frames, rayfracs


def frame_metrics(frames, gt_frames, gazes, aperture: float, warmup: int,
                  device) -> dict:
    """The row's metrics over frames [warmup:], each frame and the ground
    truth clipped to [0, 1]."""
    ps, ss, pf, pm, pp = [], [], [], [], []
    for i in range(warmup, len(frames)):
        a = frames[i].to(device).clamp(0.0, 1.0)
        b = gt_frames[i].to(device).clamp(0.0, 1.0)
        h, w = a.shape[:2]
        ps.append(psnr(a, b))
        ss.append(ssim(a, b))
        mf, mm, mp = annulus_masks(h, w, gazes[i], aperture, device)
        pf.append(region_psnr(a, b, mf))
        pm.append(region_psnr(a, b, mm))
        pp.append(region_psnr(a, b, mp))
    return dict(psnr_full=float(np.mean(ps)), ssim=float(np.mean(ss)),
                psnr_fovea=float(np.mean(pf)), psnr_mid=float(np.mean(pm)),
                psnr_periphery=float(np.mean(pp)))


def quality_rows(scene, cam, gazes, base: dict, modes, recons, warmup: int,
                 device, log=None) -> list:
    """One row per (mode, recon): mode, recon, ray_pct, psnr_full, ssim,
    psnr_fovea, psnr_mid, psnr_periphery. `base` holds the RenderConfig
    fields both renders share (width, height, aperture, budget, ...); the
    ground truth overrides its sampling, reconstruction and budget.
    `log(row)` is called as each row is done."""
    from fovtrace_torch.config import RenderConfig

    gt_frames, _ = render_run(scene, cam, gazes, RenderConfig(
        **{**base, "ray_budget_frac": 1.0}, sampling_mode="full",
        reconstruction="none"))
    rows = []
    for mode in modes:
        for recon in recons:
            cfg = RenderConfig(**base, sampling_mode=mode,
                               reconstruction=recon)
            frames, rayfracs = render_run(scene, cam, gazes, cfg)
            row = {"mode": mode, "recon": recon,
                   "ray_pct": 100.0 * float(np.mean(rayfracs))}
            row.update(frame_metrics(frames, gt_frames, gazes, cfg.aperture,
                                     warmup, device))
            rows.append(row)
            if log is not None:
                log(row)
    return rows


def report(rows, args, label: str) -> str:
    md = ["# Quality vs ground truth (fovtrace_torch)", "",
          f"device: {label}. scene={args.scene} {args.width}x{args.height}, "
          f"{args.frames} frames ({args.gaze} gaze, {args.warmup} temporal "
          f"warm-up frames excluded), aperture={args.aperture}. Ground "
          "truth: sampling_mode=full, no reconstruction, the same temporal "
          "accumulation. PSNR in dB on tonemapped [0,1] frames; annuli "
          "centred on the per-frame gaze (fovea r<aperture, mid to 2x, "
          "periphery beyond). Written by "
          "`python -m fovtrace_torch.scripts.quality_eval`.", "",
          "| mode | recon | ray% | PSNR | SSIM | fovea | mid | periphery |",
          "|---|---|---|---|---|---|---|---|"]
    for r in rows:
        md.append(f"| {r['mode']} | {r['recon']} | {r['ray_pct']:.2f} | "
                  f"{r['psnr_full']:.2f} | {r['ssim']:.4f} | "
                  f"{r['psnr_fovea']:.2f} | {r['psnr_mid']:.2f} | "
                  f"{r['psnr_periphery']:.2f} |")
    return "\n".join(md) + "\n"


def build_argparser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--width", type=int, default=960)
    ap.add_argument("--height", type=int, default=544)
    ap.add_argument("--frames", type=int, default=20)
    ap.add_argument("--warmup", type=int, default=8,
                    help="temporal warm-up frames excluded from metrics")
    ap.add_argument("--scene", default="earth")
    ap.add_argument("--aperture", type=float, default=0.07)
    ap.add_argument("--quick", action="store_true",
                    help="masked x {pullpush, atrous} only")
    ap.add_argument("--gaze", default="fixed",
                    help="fixed (default) isolates the spatial foveation "
                         "error: every sampled pixel draws the ground "
                         "truth's samples; a moving gaze (circle) adds "
                         "per-pixel sample-count differences")
    ap.add_argument("--out", default=str(REPORTS_DIR),
                    help="directory of QUALITY_torch.md and "
                         "quality_torch.json")
    return ap


def main(argv=None) -> int:
    from fovtrace_torch.app import trajectory
    from fovtrace_torch.config import pin_fp32
    from fovtrace_torch.core.camera import Camera
    from fovtrace_torch.scene import procedural

    args = build_argparser().parse_args(argv)
    dev = open_device(args.device)
    pin_fp32(dev)
    label = device_label(dev)
    h, w = args.height, args.width
    scene = procedural.SCENES[args.scene](dev)
    cam = Camera.create(eye=EYE, target=TARGET, device=dev)
    gazes, _poses = trajectory.make(args.gaze, h, w, args.frames)
    base = dict(width=w, height=h, max_depth=4, diffuse_max_depth=1,
                aperture=args.aperture, ray_budget_frac=0.55,
                full_outputs=False)
    modes, recons = ((QUICK_MODES, QUICK_RECONS) if args.quick
                     else (MODES, RECONS))

    def log(r):
        print(json.dumps(r), flush=True)
        print(f"[quality] {r['mode']:8s} x {r['recon']:9s} rays "
              f"{r['ray_pct']:.2f}% PSNR {r['psnr_full']:.2f} SSIM "
              f"{r['ssim']:.4f} fovea {r['psnr_fovea']:.2f} mid "
              f"{r['psnr_mid']:.2f} peri {r['psnr_periphery']:.2f}  "
              f"[{label}]", file=sys.stderr, flush=True)

    t0 = time.time()
    print(f"[quality] ground truth (full sampling) {w}x{h} x{args.frames} "
          f"frames, then {len(modes) * len(recons)} rows", file=sys.stderr,
          flush=True)
    rows = quality_rows(scene, cam, gazes, base, modes, recons, args.warmup,
                        dev, log=log)
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    (out / "QUALITY_torch.md").write_text(report(rows, args, label))
    with open(out / "quality_torch.json", "w") as f:
        json.dump(rows, f, indent=1)
    print(f"[quality] wrote {out / 'QUALITY_torch.md'} "
          f"({time.time() - t0:.1f} s)", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
