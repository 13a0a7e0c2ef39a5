"""Device milliseconds a frame of the kernels launched inside the
Shading stage's range (render_frame_staged's stage spans, which the
benchmark opens)."""

from harness import trace


def read(rec):
    rs = [r for r in rec["ranges"] if r["name"] == "Shading"]
    if not rs:
        return None
    ks = trace.launched_in(rec, rs)
    if not ks:
        return None
    return sum(k["dur"] for k in ks) * 1e-3 / rec["units"]
