"""Percent of the traced window in which no operation ran on the device
(rank 0's, on several cards): 100 x (1 - the union of its kernels' and
copies' intervals over the window's length)."""

from harness import trace


def read(rec):
    if not rec["kernels"]:
        return None
    return 100.0 * (1.0 - trace.busy_s(rec) / (rec["window_us"] * 1e-6))
