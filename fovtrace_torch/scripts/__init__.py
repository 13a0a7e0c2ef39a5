"""Probe scripts: the counterparts of the JAX package's two TPU probes
under `scripts/`. They measure and check kernel plumbing and run on no
render path.

    python -m fovtrace_torch.scripts.microbench_inner   # closest-hit cost parts
    python -m fovtrace_torch.scripts.probe_smem_dma     # schedule-row copy probe

Both run on the card unless given `--device cpu`, where each kernel
wrapper runs its plain PyTorch version. Their CUDA kernels are in
`csrc/probes.cu`, built at first use into the library `fovtrace_probes`
with the cluster kernels' compiler command.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from fovtrace_torch import _build, kernels
from fovtrace_torch.kernels import cluster_isect as ci

_CSRC = Path(__file__).resolve().parent.parent / "csrc" / "probes.cu"
MICRO_VARIANTS = ("loop", "slab", "mm_lane", "mm_lead", "mm_bf16", "full")
_lib = None


def load_probe_library() -> ctypes.CDLL:
    """The compiled probe library (built at first use)."""
    global _lib
    if _lib is None:
        path = _build.build_library("fovtrace_probes", [_CSRC],
                                    ci._nvcc_command)
        lib = ctypes.CDLL(str(path))
        p, i = ctypes.c_void_p, ctypes.c_int
        for v in MICRO_VARIANTS:
            fn = getattr(lib, f"fov_micro_{v}")
            # rays, sched, counts, cb, coef, out, nb, nc, c, stream
            fn.argtypes = [p] * 6 + [i, i, i, p]
            fn.restype = ctypes.c_int
        # counts, sched, rays, table, out, nb, sw, stream
        lib.fov_smem_dma.argtypes = [p] * 5 + [i, i, p]
        lib.fov_smem_dma.restype = ctypes.c_int
        _lib = lib
    return _lib


def check_tensors(want, dev) -> None:
    """Raise unless `dev` is cpu or cuda and each (tensor, dtype, name)
    of `want` lies on it, has that dtype and is contiguous."""
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"the probes run on cpu or cuda, not {dev}")
    for t, dt, name in want:
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, rays on {dev}")
        if t.dtype != dt:
            raise TypeError(f"{name} must be {dt}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def launched(fn, *args, name: str, dev) -> None:
    """Call the C entry point `fn` on the device's current stream, raise
    on a CUDA error, and count one launch of kernel `name`."""
    err = fn(*args, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
    kernels.CALLS[name] += 1

