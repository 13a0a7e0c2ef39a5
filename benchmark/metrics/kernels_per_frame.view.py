"""Device kernels a frame, from the profiler's trace of the traced
frames."""


def read(rec):
    return len(rec["kernels"]) / rec["units"] if rec["kernels"] else None
