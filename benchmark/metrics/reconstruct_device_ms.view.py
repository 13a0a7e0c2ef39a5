"""Device milliseconds a frame of the kernels launched inside the
reconstruction stages' ranges (pull-push PPI, A-Trous AT; JFA and SI
where configured)."""

from harness import trace

STAGES = ("JFA", "SI", "PPI", "AT")


def read(rec):
    rs = [r for r in rec["ranges"] if r["name"] in STAGES]
    if not rs:
        return None
    ks = trace.launched_in(rec, rs)
    if not ks:
        return None
    return sum(k["dur"] for k in ks) * 1e-3 / rec["units"]
