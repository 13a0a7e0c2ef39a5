"""Device milliseconds a step of the kernels launched by the autograd
backward (inside its evaluate_function operations)."""

from harness import trace


def read(rec):
    if not rec["backward"]:
        return None
    ks = trace.launched_in(rec, rec["backward"])
    if not ks:
        return None
    return sum(k["dur"] for k in ks) * 1e-3 / rec["units"]
