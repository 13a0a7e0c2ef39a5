"""A viewer cell: the foveated frame of fovtrace_torch under a `view`
traffic mix, one frame in flight at a time.

Set-up builds the program's scene from the benchmark's arrays, sizes the
ray budget on frame 0 (bench.py's rule, `arith.budget_frac`) and renders
the mix's warm-up frames from the initial state. The window then renders
frame after frame until `seconds` have passed; each frame ends in a sync
that reads its dropped rays and non-finite pixels. One window frame,
drawn from the seed among those that complete, and frame 0 (the start)
are kept and, once the window has closed and the program's state is
freed, rendered again by the reference (benchmark/reference): frame 0
from the initial state, the drawn frame from the program's own state-in
(history, depth cache), so the comparison of its state-out checks the
carry from frame to frame.

On one card the entry is render_frame_staged, which is render_frame with
the benchmark's stage spans; on several (`Run.dist`) it is
dist.sharding.render_sharded and gather_frame, one row block a rank.
"""

from __future__ import annotations

import dataclasses
import gc
import sys

import numpy as np
import torch

from harness import arith, check, program, refside, scenes, trace, traffic


@dataclasses.dataclass
class Run:
    config: dict
    mix: dict
    seed: int
    seconds: float
    traced: bool
    device: torch.device
    dist: object = None        # the program's Mesh, several ranks
    t0: float = 0.0            # host clock at the process's start


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def peak_bytes(device) -> int:
    """The process's peak of allocated device memory (0 off a card)."""
    return torch.cuda.max_memory_allocated(device) \
        if device.type == "cuda" else 0


def _planes(v) -> torch.Tensor:
    """A Vec3 (program's or reference's) as a [3, ...] host tensor."""
    return torch.stack([c.detach().float().cpu() for c in v])


def _host_frame(out: dict, state, stages: dict | None) -> dict:
    """What the comparison reads of one frame, on the host."""
    f = {"image": _planes(out["image_rgb"]),
         "history": state.history.detach().cpu(),
         "depth": state.depth_cache.detach().cpu(),
         "ray_count": int(out["ray_count"])}
    gb = None if stages is None else stages.get("GB")
    if gb is not None:
        f["gbuf"] = {k: _planes(gb[k]) for k in ("position", "normal",
                                                 "albedo")}
        f["gbuf"]["shadow"] = gb["shadow"].detach().cpu()
    smp = None if stages is None else stages.get("Sampling")
    if smp is not None:
        f["mask"] = smp[0].detach().cpu()
    return f


class _Frames:
    """The program's frame loop on one card or a row block a rank."""

    def __init__(self, run: Run, seq):
        from fovtrace_torch.render import pipeline

        self.run, self.seq, self.pipeline = run, seq, pipeline
        cfg = run.config
        t = trace.host_clock()
        mesh = scenes.mesh_arrays(cfg)
        env = scenes.envmap_array(cfg)
        self.scene = program.build_scene(cfg, mesh, env, run.device)
        sync(run.device)
        self.scene_build_s = trace.host_clock() - t
        self.rc = program.render_config(cfg, run.mix.get("render"))
        self.spans = trace.StageSpans()

    def camera(self, f: int):
        eye, target, _ = self.seq.frame(f)
        return program.camera(eye, target, self.run.config, self.run.device)

    def initial(self, cam):
        if self.run.dist is None:
            return self.pipeline.FrameState.initial(cam, self.rc)
        from fovtrace_torch.dist import sharding
        return sharding.initial_state_sharded(cam, self.rc, self.run.dist)

    def render(self, f: int, state, capture: bool):
        """(outputs with the whole frame's image, new state, stages or
        None, host seconds inside the render call)."""
        cam = self.camera(f)
        gaze = self.seq.frame(f)[2]
        t = trace.host_clock()
        if self.run.dist is None:
            self.spans.capture = {} if capture else None
            out, new = self.pipeline.render_frame_staged(
                self.scene, cam, gaze, state, self.rc, self.spans)
            stages = self.spans.capture
        else:
            from fovtrace_torch.dist import sharding
            out, new = sharding.render_sharded(self.scene, cam, gaze, state,
                                               self.rc, self.run.dist)
            out = sharding.gather_frame(out, self.run.dist)
            stages = None
        return out, new, stages, trace.host_clock() - t

    @staticmethod
    def failed(out) -> torch.Tensor:
        """[3] on the device: rays dropped, non-finite image values, the
        mask's count."""
        img = torch.stack(list(out["image_rgb"]))
        return torch.stack([out["rays_dropped"].to(torch.float32),
                            (~torch.isfinite(img)).sum().to(torch.float32),
                            out["ray_count"].to(torch.float32)])


def _gather_rows(x: torch.Tensor, mesh, dim: int) -> torch.Tensor:
    """Every rank's block of x along dim, in rank order (after the
    window, outside the timed path)."""
    parts = [torch.empty_like(x) for _ in range(mesh.size)]
    torch.distributed.all_gather(parts, x.contiguous(), group=mesh.group)
    return torch.cat(parts, dim=dim)


def _whole_state(state, mesh):
    """A sharded state's history and depth cache, whole (or as they are
    on one card)."""
    if mesh is None:
        return state.history, state.depth_cache
    return _gather_rows(state.history, mesh, 1), \
        _gather_rows(state.depth_cache, mesh, 0)


def run_program(run: Run) -> dict:
    """Set-up, the window and the kept frames; the program's state freed
    before it returns."""
    seq = traffic.view_sequence(run.seed, run.mix, run.config)
    fr = _Frames(run, seq)
    lead = run.dist is None or run.dist.rank == 0
    n_pix = run.config["width"] * run.config["height"]

    # the warm-up frames from the initial state, which size the budget
    # (bench.py's rule over each frame's mask, moving frames included),
    # then again at that budget until no frame asks for more; frame 0 is
    # the start
    warm = run.mix["warmup_frames"]
    base = run.config["render"]["ray_budget_frac"]
    frac = base
    for _ in range(4):
        fr.rc = fr.rc.replace(ray_budget_frac=frac)
        state = fr.initial(fr.camera(0))
        asked = []
        for f in range(warm):
            out, state, stages, _ = fr.render(f, state, capture=f == 0)
            asked.append(arith.budget_frac(int(out["ray_count"]),
                                           int(out["rays_dropped"]), n_pix,
                                           base))
            if f == 0:
                start = {"frame": 0, "host": _host_frame(out, state, stages)}
                if run.dist is not None:
                    start["host"]["history"], start["host"]["depth"] = [
                        t.cpu() for t in _whole_state(state, run.dist)]
            del out, stages
        if max(asked) <= frac:
            break
        frac = max(asked)
    setup_s = trace.host_clock() - run.t0

    keep = traffic.reservoir(run.seed)
    kept = None
    lat, enq, shares = [], [], []
    attempted = failed = 0
    rec = None
    flag = torch.ones((), dtype=torch.int32, device=run.device)
    w0 = trace.host_clock()
    f = warm
    drawn = 0
    while True:
        if run.traced and f == warm:
            # the first frames of the window, traced (their times are not
            # the cell's end-to-end numbers, which come untraced)
            holder = {"state": state, "failed": 0}

            def body(j):
                o, s, _, _ = fr.render(warm + j, holder["state"], False)
                holder["state"] = s
                holder["failed"] += (fr.failed(o)[:2] > 0).any().int()
            fr.spans.ranges = True
            rec = trace.profile(body, run.mix["traced_frames"], run.device)
            fr.spans.ranges = False
            state = holder["state"]
            n = run.mix["traced_frames"]
            attempted += n
            failed += int(holder["failed"])
            f += n
            continue
        t = trace.host_clock()
        take = keep(drawn)
        drawn += 1
        state_in = state
        out, state, stages, host_s = fr.render(f, state, capture=take)
        bad = fr.failed(out).cpu()
        done = trace.host_clock()
        lat.append(done - t)
        enq.append(host_s)
        shares.append(float(bad[2]) / n_pix)
        attempted += 1
        failed += int(bad[0] > 0 or bad[1] > 0)
        if take:
            kept = {"frame": f, "state_in": state_in, "out": out,
                    "state": state, "stages": stages}
        del out, stages, state_in
        f += 1
        more = int(done - w0 < run.seconds)
        if run.dist is not None:
            flag.fill_(more)
            torch.distributed.broadcast(flag, 0, group=run.dist.group)
            more = int(flag.item())
        if not more:
            break
    window_s = trace.host_clock() - w0
    peak = peak_bytes(run.device)
    if lead and shares:
        print(f"[bench] budget {frac}; the mask's share of the pixels in "
              f"the window: min {min(shares):.4f}, max {max(shares):.4f}",
              file=sys.stderr)

    # the kept frame, whole, on the host; then the program's state goes
    hist_in, depth_in = _whole_state(kept["state_in"], run.dist)
    host = _host_frame(kept["out"], kept["state"], kept["stages"])
    if run.dist is not None:
        host["history"], host["depth"] = [
            t.cpu() for t in _whole_state(kept["state"], run.dist)]
    sampled = {"frame": kept["frame"], "host": host,
               "history_in": hist_in.cpu(), "depth_in": depth_in.cpu()}
    scene_build_s = fr.scene_build_s
    del fr, kept, state, hist_in, depth_in
    gc.collect()
    if run.device.type == "cuda":
        torch.cuda.empty_cache()
    return {"lead": lead, "seq": seq, "frac": frac, "setup_s": setup_s,
            "window_s": window_s, "latencies": lat, "enqueue": enq,
            "attempted": attempted, "failed": failed, "peak": peak,
            "start": start, "sampled": sampled, "records": rec,
            "scene_build_s": scene_build_s}


def reference_frames(run: Run, got: dict, quantize=None,
                     count_work: bool = False) -> dict:
    """The reference's frame 0 from its initial state and the kept frame
    from the program's state-in; the numbers of each against the
    program's, the worst of both, and the kept frame's intersection
    work when `count_work` (least seconds, arith.isect_call_s)."""
    from reference import pipeline as rp

    cfg, dev, seq = run.config, run.device, got["seq"]
    mesh = scenes.mesh_arrays(cfg)
    env = scenes.envmap_array(cfg)
    scene = refside.build_scene(cfg, mesh, env, dev)
    rc = refside.render_config(cfg, run.mix.get("render")).replace(
        ray_budget_frac=got["frac"])
    q = (lambda x: x) if quantize is None else quantize
    cam = lambda f: refside.camera(*seq.frame(f)[:2], cfg, dev)

    def frame(f, state, work=None):
        sc = scene if work is None else scene.replace(work=work)
        with torch.no_grad():
            out, new = rp.render_frame(sc, cam(f), seq.frame(f)[2], state,
                                       rc, quantize=q)
        gb = out["gbuf"]
        host = {"image": _planes(out["image_rgb"]),
                "history": new.history.cpu(), "depth": new.depth_cache.cpu(),
                "ray_count": int(out["ray_count"]),
                "gbuf": {k: _planes(gb[k]) for k in ("position", "normal",
                                                     "albedo")},
                "mask": out["mask"].cpu()}
        host["gbuf"]["shadow"] = gb["shadow"].cpu()
        return host

    t = trace.host_clock()
    c0 = cam(0)
    r0 = frame(0, rp.FrameState.initial(c0, rc))
    t0 = trace.host_clock()
    s = got["sampled"]
    k = s["frame"]
    st = rp.FrameState(history=s["history_in"].to(dev),
                       depth_cache=s["depth_in"].to(dev),
                       prev_camera=cam(k - 1),
                       frame=torch.tensor(k, dtype=torch.int64, device=dev))
    work = [] if count_work else None
    rk = frame(k, st, work)
    t1 = trace.host_clock()
    n0 = check.view_numbers(got["start"]["host"], r0)
    nk = check.view_numbers(s["host"], rk)
    print(f"[bench] reference: frame 0 {t0 - t:.3f} s, frame {k} "
          f"{t1 - t0:.3f} s, comparison {trace.host_clock() - t1:.3f} s",
          file=sys.stderr)
    return {"numbers": check.worst([n0, nk]),
            "isect_s": sum(arith.isect_call_s(w) for w in work or ()),
            "frames": [0, k]}


def frame_stats(latencies: list, window_s: float) -> dict:
    """frame_ms: the window's time over its frames; frame_p90_ms: the
    90th percentile of the frames' latencies (an untraced window)."""
    return {"frame_ms": window_s / len(latencies) * 1e3,
            "frame_p90_ms": float(np.percentile(latencies, 90)) * 1e3}
