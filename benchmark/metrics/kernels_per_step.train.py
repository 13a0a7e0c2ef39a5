"""Device kernels a step, from the profiler's trace of the traced
steps."""


def read(rec):
    return len(rec["kernels"]) / rec["units"] if rec["kernels"] else None
