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
with the cluster kernels' compiler command. Both run persistent CTAs,
the microbenchmark's on the ray blocks in `ticket_order` (most live
entries first), the copy probe's in ascending order; `forced_grid` sets
their grid and order for tests and measurement.
"""

from __future__ import annotations

import contextlib
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
GRID_ORDERS = ("longest", "ascending")
_lib = None
_grid = None


def probe_signatures() -> dict:
    """{C entry point: (argtypes, restype)} of the probe library."""
    p, i = ctypes.c_void_p, ctypes.c_int
    # micro: rays, sched, counts, cb, coef, order, ticket, out, then nb,
    # nc, c, ctas, stream; smem_dma: counts, sched, rays, table, order,
    # out, then nb, sw, nsc, ctas, stream
    out = {f"fov_micro_{v}": ([p] * 8 + [i] * 4 + [p], i)
           for v in MICRO_VARIANTS}
    out.update(fov_micro_ctas=([i, i, i], i),
               fov_smem_dma=([p] * 6 + [i] * 4 + [p], i),
               fov_smem_dma_lanes=([i], i),
               fov_smem_dma_layout=([p], i),
               fov_smem_dma_ctas=([i, i], i))
    return out


def load_probe_library() -> ctypes.CDLL:
    """The compiled probe library (built at first use)."""
    global _lib
    if _lib is None:
        path = _build.build_library("fovtrace_probes", [_CSRC],
                                    ci._nvcc_command, [ci.TMA_HEADER])
        lib = ctypes.CDLL(str(path))
        for name, (argtypes, restype) in probe_signatures().items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = restype
        _lib = lib
    return _lib


def ticket_order(counts: torch.Tensor) -> torch.Tensor:
    """[NB] int64: the order in which the probes' persistent CTAs take
    the ray blocks, the most live entries first, ties in block order (a
    stable sort on the counts' device, no host sync). The probes keep
    their own copy of the cluster kernels' order."""
    return torch.argsort(counts, descending=True, stable=True)


@contextlib.contextmanager
def forced_grid(ctas: int = 0, order: str = None):
    """For tests and measurement: inside the block the probe kernels run
    `ctas` persistent CTAs (0: as many as fit) and take the ray blocks
    longest first (`ticket_order`) or in ascending block order (None:
    each probe's own default). Their results do not depend on either."""
    global _grid
    if isinstance(ctas, bool) or not isinstance(ctas, int) or ctas < 0 \
            or order not in (None, *GRID_ORDERS):
        raise ValueError(f"forced_grid({ctas!r}, {order!r}): an int of "
                         f"CTAs >= 0, order None or in {GRID_ORDERS}")
    saved, _grid = _grid, (ctas, order)
    try:
        yield
    finally:
        _grid = saved


def block_order(counts: torch.Tensor, default: str = "longest"):
    """(order, CTAs) a probe launch takes: its `default` order and 0 (as
    many CTAs as fit), or what `forced_grid` sets. The order is
    `ticket_order` for "longest" and None (ascending, nothing to pass)
    for "ascending"."""
    ctas, order = _grid if _grid is not None else (0, None)
    if (order or default) == "ascending":
        return None, ctas
    return ticket_order(counts), ctas


def check_aligned(want) -> None:
    """Raise unless each (tensor, name) of `want` starts on 16 bytes, as
    the kernels' bulk copies need."""
    for t, name in want:
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must start on a 16-byte boundary for "
                             "the bulk copies")


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
