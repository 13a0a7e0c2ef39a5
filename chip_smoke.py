"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each prints its own lines; any failure exits non-zero):
  1. card      require CUDA; print the card's name and power limit
  2. build     compile the CUDA kernels from fovtrace_torch/csrc
  3. kernels   each kernel against its plain PyTorch version on the card
               (earth scene: 4,096 seeded random rays, the primary rays
               and the G-buffer shadow rays of a 256x256 frame)
  4. main      the CLI's render path on earth at 1920x1088 with the bench
               configuration, 3 frames of the circle gaze; counts kernel
               launches and plain/brute calls during exactly that run
  5. timing    kernel and plain version at the main path's shapes: the
               1920x1088 G-buffer and the bounce-0 front of the frame
  6. parity    a 256x256 frame with the kernels vs one with the plain
               versions; a 64x64 frame vs tests/golden/earth.npz
The line before last is the card's name and power limit, and the last
line is the JSON result.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

SEED = 7
GAZE_CFG = dict(reconstruction="atrous", max_depth=4, diffuse_max_depth=1)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True, text=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int, warmup: int = 1) -> float:
    """Mean ms per call from CUDA events around `iters` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(iters):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / iters


def compare(name, scene, ro, rd, tmin, tmax, dev, results):
    """Kernel vs plain version on one ray set; records the agreement."""
    from fovtrace_torch.kernels import cluster_isect as ci
    from fovtrace_torch.kernels import intersect as isect

    raysT, n = ci.pack_raysT(ro, rd, tmin, tmax)
    sched, counts, params = ci.cluster_schedule(raysT, scene.cluster_aabb)
    coef, aux = scene.isect_coef, scene.isect_aux
    tk, ik = ci.closest_hit(raysT, coef, sched, counts, params)
    tp, ip = ci.closest_hit_plain(raysT, coef, sched, counts, params)
    ok_k = (ik.reshape(-1)[:n] >= 0)
    ok_p = (ip.reshape(-1)[:n] >= 0)
    flips = int((ok_k != ok_p).sum())
    hits = int(ok_p.sum())
    same = int(((ik == ip).reshape(-1)[:n] & ok_p).sum())
    z = torch.zeros(n, device=dev)
    ref = lambda t, i: isect.refine_hit_v(scene, ro, rd, isect.Hit(
        t.reshape(-1)[:n], i.reshape(-1)[:n], z, z)).t
    rk, rp = ref(tk, ik), ref(tp, ip)
    both = ok_k & ok_p
    t_err = float((rk - rp)[both].abs().max()) if hits else 0.0
    t_ok = bool(torch.allclose(rk[both], rp[both], rtol=1e-3, atol=1e-4))
    frac = same / max(hits, 1)
    print(f"[kernels] {name}: closest_hit {n} rays, {hits} hits, "
          f"hit/miss flips {flips}, identical ids {frac:.5f}, refined t "
          f"max |err| {t_err:.3e}")
    assert flips == 0, f"{name}: {flips} hit/miss flips"
    assert frac >= 0.995, f"{name}: only {frac:.5f} identical ids"
    assert t_ok, f"{name}: refined t off by {t_err}"

    ak = torch.stack(ci.occlusion(raysT, coef, aux, sched, counts, params))
    ap = torch.stack(ci.occlusion_plain(raysT, coef, aux, sched, counts,
                                        params))
    a_err = float((ak - ap).abs().max())
    print(f"[kernels] {name}: occlusion max |err| {a_err:.3e}, "
          f"occluded {float((ap.amax(0) == 0).float().mean()):.4f}")
    assert torch.allclose(ak, ap, rtol=1e-4, atol=1e-4), \
        f"{name}: occlusion off by {a_err}"
    results["closest_hit"] = max(results.get("closest_hit", 0.0), t_err)
    results["occlusion"] = max(results.get("occlusion", 0.0), a_err)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this smoke "
              "test needs an NVIDIA GPU", file=sys.stderr)
        return 1
    from fovtrace_torch import _build
    from fovtrace_torch.app import cli
    from fovtrace_torch.config import RenderConfig, pin_fp32
    from fovtrace_torch.core.camera import Camera
    from fovtrace_torch.core.vec import Vec3
    from fovtrace_torch.kernels import cluster_isect as ci
    from fovtrace_torch.kernels import intersect as isect
    from fovtrace_torch.render import gbuffer, pipeline
    from fovtrace_torch.scene import procedural

    dev = torch.device("cuda", 0)
    pin_fp32(dev)
    # ---- 1. card ----------------------------------------------------------
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(f"[card] {card} | torch {torch.__version__} cuda "
          f"{torch.version.cuda} | devices {torch.cuda.device_count()}")

    # ---- 2. build ---------------------------------------------------------
    t0 = time.perf_counter()
    ci.load_cuda_library()
    print(f"[build] CUDA kernels built in {time.perf_counter() - t0:.2f} s")
    for line in _build.build_logs.get("fovtrace_cluster_isect",
                                      "").splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            print(f"[build] {line.strip()}")

    scene = procedural.earth_scene(dev)
    cam = Camera.create(eye=(3.0, 2.5, 4.0), target=(0.0, 0.8, 0.0),
                        device=dev)

    # ---- 3. kernels vs plain ---------------------------------------------
    errs: dict = {}
    rng = np.random.default_rng(SEED)
    nchk = 4096
    ctr = ((scene.bbox_min + scene.bbox_max) / 2.0).cpu().numpy()
    ext = float(torch.linalg.vector_norm(scene.bbox_max - scene.bbox_min))
    ro = ctr + rng.normal(size=(nchk, 3)).astype(np.float32) * ext
    rd = rng.normal(size=(nchk, 3)).astype(np.float32)
    rd /= np.linalg.norm(rd, axis=-1, keepdims=True)
    v = lambda a: Vec3(*[torch.as_tensor(a[:, k], dtype=torch.float32,
                                         device=dev) for k in range(3)])
    compare("random4096", scene, v(ro), v(rd), 1e-3, isect.BIG_T, dev, errs)

    cfg256 = RenderConfig(width=256, height=256, **GAZE_CFG)
    pro, prd = cam.primary_rays_v(256, 256)
    swz = lambda a: gbuffer.swizzle_to_tiles(a.reshape(-1), 256, 256)
    pro, prd = pro.map(swz), prd.map(swz)
    compare("primary256", scene, pro, prd, 1e-3, isect.BIG_T, dev, errs)
    hit, surf = isect.intersect_surface_v(scene, pro, prd, 1e-3, isect.BIG_T)
    so, sd, stmax, _ = gbuffer.shadow_rays(scene, prd, hit, surf, cfg256)
    compare("shadow256", scene, so, sd, 1e-3, stmax, dev, errs)

    # ---- 4. main path at full size ----------------------------------------
    w, h = 1920, 1088
    bench_cfg = RenderConfig(width=w, height=h, ray_budget_frac=0.50,
                             full_outputs=False, **GAZE_CFG)
    # bench.py's budget sizing: one probe frame; if the mask is denser
    # than the budget, raise the fraction to cover it plus 2%
    probe, _ = pipeline.render_frame(scene, cam, (h // 2, w // 2),
                                     pipeline.FrameState.initial(cam,
                                                                 bench_cfg),
                                     bench_cfg)
    need = int(probe["ray_count"]) / (w * h)
    frac = 0.50
    if int(probe["rays_dropped"]) > 0 or need > frac:
        frac = min(1.0, float(np.ceil((need + 0.02) * 20)) / 20)
    print(f"[main] mask covers {100 * need:.2f}% of pixels -> "
          f"ray_budget_frac {frac}")
    args = cli.build_argparser().parse_args([
        "--device", "cuda", "--scene", "earth", "--width", str(w),
        "--height", str(h), "--frames", "3", "--gaze", "circle",
        "--reconstruction", "atrous", "--max-depth", "4", "--gi-depth", "1",
        "--ray-budget-frac", str(frac)])
    torch.cuda.synchronize()
    ci.reset_counters()
    stats = cli.run(args, scene=scene)
    torch.cuda.synchronize()
    counts = ci.counters()
    out = stats["out"]
    img = torch.stack([out["image_rgb"].x, out["image_rgb"].y,
                       out["image_rgb"].z])
    mean = float(img.mean())
    print(f"[main] counts during the run: {json.dumps(counts)}")
    print(f"[main] rays_dropped per frame {stats['rays_dropped']}, "
          f"ray_count {stats['ray_count']}, image mean {mean:.4f}, "
          f"finite {bool(torch.isfinite(img).all())}")
    assert max(stats["rays_dropped"]) == 0, "the budget truncated the mask"
    assert bool(torch.isfinite(img).all()), "non-finite image"
    assert 0.05 < mean < 0.95, f"implausible frame mean {mean}"
    assert counts["closest_hit"] > 0 and counts["occlusion"] > 0, counts
    assert counts["closest_hit_plain"] == 0 and counts["occlusion_plain"] == 0
    assert counts["intersect_brute"] == 0 and counts["occlusion_brute"] == 0
    for f, (ms, rays) in enumerate(zip(stats["frame_ms"],
                                       stats["rays_traced"])):
        print(f"[main] frame {f}: {ms:.2f} ms, rays_traced {rays}, "
              f"{rays / ms / 1e3:.2f} Mrays/s  [{card}]")
    steady = float(np.mean(stats["frame_ms"][1:]))
    rays = float(np.mean(stats["rays_traced"][1:]))
    print(f"[main] earth {w}x{h} steady {steady:.2f} ms/frame, "
          f"{rays:.0f} rays_traced/frame, {rays / steady / 1e3:.2f} Mrays/s "
          f"[{card}]")

    # ---- 5. kernel times at the main path's shapes --------------------------
    captured = {"closest_hit": [], "occlusion": []}
    real = {"closest_hit": ci.closest_hit, "occlusion": ci.occlusion}

    def recorder(name):
        def call(*a):
            captured[name].append(a)
            return real[name](*a)
        return call

    ci.closest_hit, ci.occlusion = recorder("closest_hit"), \
        recorder("occlusion")
    try:
        pipeline.render_frame(scene, cam, (h // 2, w // 2),
                              pipeline.FrameState.initial(cam, bench_cfg),
                              bench_cfg.replace(ray_budget_frac=frac))
    finally:
        ci.closest_hit, ci.occlusion = real["closest_hit"], real["occlusion"]
    plain = {"closest_hit": ci.closest_hit_plain,
             "occlusion": ci.occlusion_plain}
    times = {}
    for name in ("closest_hit", "occlusion"):
        for label, call in (("gbuffer", 0), ("bounce0", 1)):
            a = captured[name][call]
            k_ms = cuda_ms(lambda: real[name](*a), iters=20)
            p_ms = cuda_ms(lambda: plain[name](*a), iters=3)
            ko, po = real[name](*a), plain[name](*a)
            if name == "closest_hit":
                flips = int(((ko[1] >= 0) != (po[1] >= 0)).sum())
                assert flips == 0, f"{name} {label}: {flips} hit/miss flips"
            else:
                err = float(max((x - y).abs().max() for x, y in zip(ko, po)))
                errs[name] = max(errs[name], err)
                assert all(torch.allclose(x, y, rtol=1e-4, atol=1e-4)
                           for x, y in zip(ko, po)), f"{name} {label}: {err}"
            nrays = a[0].shape[0] * ci.RAY_BLOCK
            print(f"[timing] {name} {label} ({nrays} ray slots): kernel "
                  f"{k_ms:.3f} ms, plain {p_ms:.3f} ms  [{card}]")
            times[(name, label)] = (k_ms, p_ms)

    # ---- 6. frame parity ----------------------------------------------------
    small = RenderConfig(width=256, height=256, ray_budget_frac=0.6,
                         **GAZE_CFG)
    st = pipeline.FrameState.initial(cam, small)
    ok, _ = pipeline.render_frame(scene, cam, (128, 128), st, small)
    ci.closest_hit, ci.occlusion = ci.closest_hit_plain, ci.occlusion_plain
    try:
        op, _ = pipeline.render_frame(scene, cam, (128, 128), st, small)
    finally:
        ci.closest_hit, ci.occlusion = real["closest_hit"], real["occlusion"]
    mae = float((ok["image"] - op["image"]).abs().mean())
    print(f"[parity] 256x256 kernels vs plain: ray_count "
          f"{int(ok['ray_count'])} / {int(op['ray_count'])}, image MAE "
          f"{mae:.3e}")
    assert int(ok["ray_count"]) == int(op["ray_count"])
    assert mae < 5e-3

    golden = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "tests", "golden", "earth.npz")
    ref = np.load(golden)
    gcfg = RenderConfig(width=64, height=64, reconstruction="atrous",
                        max_depth=3, diffuse_max_depth=1, ray_budget_frac=0.6)
    st = pipeline.FrameState.initial(cam, gcfg)
    for _ in range(2):
        go, st = pipeline.render_frame(scene, cam, (32, 32), st, gcfg)
    gimg = go["image"].cpu().numpy()
    want = ref["image"].astype(np.float32)
    gmae = float(np.abs(gimg - want).mean())
    gmax = float(np.abs(gimg - want).max())
    print(f"[parity] 64x64 vs tests/golden/earth.npz: ray_count "
          f"{int(go['ray_count'])} / {int(ref['ray_count'])}, MAE {gmae:.3e}, "
          f"max {gmax:.3e}")
    assert int(go["ray_count"]) == int(ref["ray_count"])
    assert gmae < 5e-3 and gmax < 0.1

    src = "fovtrace_torch/csrc/cluster_isect.cu"
    replaces = {"closest_hit": "fovtrace/kernels/pallas_isect.py:518",
                "occlusion": "fovtrace/kernels/pallas_isect.py:806"}
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src,
         "replaces": replaces[name], "launches": counts[name],
         "max_abs_err": errs[name],
         "ms": times[(name, "gbuffer")][0],
         "plain_ms": times[(name, "gbuffer")][1]}
        for name in ("closest_hit", "occlusion")]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
