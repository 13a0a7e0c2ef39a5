"""Device milliseconds a frame of the kernels launched inside the
program's fov.gbuffer spans (the G-buffer stage; rank 0's, on several
cards)."""

from harness import trace


def read(rec):
    rs = [r for r in rec["ranges"] if r["name"] == "fov.gbuffer"]
    if not rs:
        return None
    ks = trace.launched_in(rec, rs)
    if not ks:
        return None
    return sum(k["dur"] for k in ks) * 1e-3 / rec["units"]
