"""Device-idle milliseconds a frame inside the program's fov.sampling
spans (rank 0's, on several cards): each span's length less the union of
the device's kernel and copy intervals within it. The sharded frame
opens fov.sampling twice (the caches' gather, then the stage)."""

from harness import trace


def read(rec):
    spans = [r for r in rec["ranges"] if r["name"] == "fov.sampling"]
    if not spans or not rec["kernels"]:
        return None
    busy = trace.busy_intervals(rec)
    lo, hi = rec["window"]
    idle = 0.0
    for r in spans:
        s, e = max(r["ts"], lo), min(r["ts"] + r["dur"], hi)
        if e <= s:
            continue
        within = sum(max(0.0, min(e, b1) - max(s, b0)) for b0, b1 in busy)
        idle += (e - s) - within
    return idle * 1e-3 / rec["units"]
