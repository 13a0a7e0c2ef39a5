"""Scripts: the counterparts of the JAX package's measurement scripts
and of its two TPU probes under `scripts/`.

    python -m fovtrace_torch.scripts.quality_eval      # foveated vs full frames
    python -m fovtrace_torch.scripts.aperture_sweep    # ray % and ms per aperture
    python -m fovtrace_torch.scripts.scaling_bench     # the sharded frame, N ranks
    python -m fovtrace_torch.scripts.microbench_inner  # closest-hit cost parts
    python -m fovtrace_torch.scripts.probe_smem_dma    # schedule-row copy probe

Each runs on the card unless given `--device cpu`, where each kernel
wrapper runs its plain PyTorch version; asked for `cuda` with no card, it
fails. The first three write their reports under `--out` (default
`build/reports/` in the checkout), never at the checkout's root. The
probes run on no render path; their CUDA kernels are in
`csrc/probes.cu`, built at first use into the library `fovtrace_probes`
with the cluster kernels' compiler command.
"""

from __future__ import annotations

import ctypes
import subprocess
from pathlib import Path

import torch

from fovtrace_torch import _build, kernels
from fovtrace_torch.kernels import cluster_isect as ci

REPORTS_DIR = _build.REPO_ROOT / "build" / "reports"
# the measurement scripts' camera, the reference scripts' own
EYE, TARGET = (3.0, 2.5, 4.0), (0.0, 0.8, 0.0)
_CSRC = Path(__file__).resolve().parent.parent / "csrc" / "probes.cu"
MICRO_VARIANTS = ("loop", "slab", "mm_lane", "mm_lead", "mm_bf16", "full")
_lib = None


def load_probe_library() -> ctypes.CDLL:
    """The compiled probe library (built at first use)."""
    global _lib
    if _lib is None:
        path = _build.build_library("fovtrace_probes", [_CSRC],
                                    ci._nvcc_command, [ci.TMA_HEADER])
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



def open_device(name: str) -> torch.device:
    """The device a script runs on; `cuda` with no card raises SystemExit
    (a measurement never falls back to the CPU)."""
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"--device {name}, but torch.cuda.is_available() "
                         "is false")
    return dev


def device_label(dev) -> str:
    """What a report names its device by: the card's name and power limit
    as nvidia-smi gives them (torch's name where nvidia-smi is missing),
    or `cpu`."""
    dev = torch.device(dev)
    if dev.type != "cuda":
        return "cpu"
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader", "-i", str(index)],
            check=True, capture_output=True, text=True)
        return out.stdout.strip()
    except (OSError, subprocess.CalledProcessError):
        return torch.cuda.get_device_name(index)


def sync(dev) -> None:
    """Wait for the device's queued work (nothing to wait for on the CPU)."""
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize(dev)
