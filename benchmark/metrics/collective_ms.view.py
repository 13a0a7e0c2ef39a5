"""Device milliseconds a frame of the NCCL kernels on rank 0."""


def read(rec):
    ks = [k for k in rec["kernels"] if "nccl" in k["name"].lower()]
    if not ks:
        return None
    return sum(k["dur"] for k in ks) * 1e-3 / rec["units"]
