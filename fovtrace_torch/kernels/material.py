"""The material table's lookup and its adjoint (counterpart of the
select chain / row gather in `fovtrace/kernels/intersect.py`
`material_lookup_v`, and of its gradient with respect to the table).

`MaterialLookup.apply(ids, table)` reads, for each of N rays, the K
columns of its material's row of the [M, K] float32 table and returns
them as a [K, N] SoA block; its backward sums the [K, N] cotangent into
the table's rows, deterministically. On CUDA tensors both directions
launch the hand-written kernels of `csrc/material.cu` (`gather`,
`adjoint`); on CPU tensors they run the plain PyTorch versions
(`gather_plain`, `adjoint_plain`); any other device raises. The
wrappers count their launches and the plain versions their calls
(`counters`), in `kernels.CALLS` beside the cluster kernels'.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch
from torch.autograd.function import once_differentiable

from fovtrace_torch import _build, kernels

_CSRC = Path(__file__).resolve().parent.parent / "csrc" / "material.cu"

# copies of csrc/material.cu's constants (tests/test_torch_material.py
# holds them to the source): the table's floats that fit the gather's
# shared memory, and the rays of one warp's slice in the adjoint
MAX_TABLE = 12288
WARP_RAYS = 512

COUNTED = ("material_gather", "material_adjoint", "material_gather_plain",
           "material_adjoint_plain")


def c_signatures() -> dict:
    """{C entry point: (argtypes, restype)} of the material library."""
    p, i = ctypes.c_void_p, ctypes.c_int
    # gather: ids, table, out, then n, m, k, stream; adjoint: ids, g,
    # partial, out, then n, m, k, stream
    return {"fov_material_gather": ([p] * 3 + [i] * 3 + [p], i),
            "fov_material_adjoint": ([p] * 4 + [i] * 3 + [p], i)}


@functools.cache
def load_cuda_library() -> ctypes.CDLL:
    """The compiled material library (built at first use)."""
    from fovtrace_torch.kernels import cluster_isect as ci

    return _build.load_library("fovtrace_material", [_CSRC],
                               ci._nvcc_command, c_signatures())


def _check(ids: torch.Tensor, table_or_g: torch.Tensor, m: int, k: int,
           name: str) -> None:
    """Validate what the kernels (and their plain versions) take: int32
    ids, a float32 table or cotangent (float64 too on the CPU, for
    gradcheck), both contiguous on one device, cpu or cuda, an [M, K]
    table within MAX_TABLE floats and, on the CPU, ids in [0, M) (the
    kernels trap on an id outside it: reading the ids back would stall
    the host)."""
    dev = ids.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"the material lookup runs on cpu or cuda, not {dev}")
    if table_or_g.device != dev:
        raise ValueError(f"{name} is on {table_or_g.device}, ids on {dev}")
    if ids.dtype != torch.int32:
        raise TypeError(f"ids must be torch.int32, got {ids.dtype}")
    floats = (torch.float32, torch.float64) if dev.type == "cpu" else \
        (torch.float32,)
    if table_or_g.dtype not in floats:
        raise TypeError(f"{name} must be torch.float32, got "
                        f"{table_or_g.dtype}")
    if not (ids.is_contiguous() and table_or_g.is_contiguous()):
        raise ValueError(f"ids and {name} must be contiguous")
    if ids.dim() != 1:
        raise ValueError(f"ids must be [N], got {tuple(ids.shape)}")
    if m < 1 or k < 1 or m * k > MAX_TABLE:
        raise ValueError(
            f"a material table of [{m}, {k}] exceeds the kernels' limit of "
            f"M x K <= MAX_TABLE = {MAX_TABLE} floats (the 48 KB the gather "
            "holds in shared memory)")
    if dev.type == "cpu" and ids.numel() and (
            int(ids.min()) < 0 or int(ids.max()) >= m):
        raise ValueError(f"material ids must lie in [0, {m})")


# ------------------------------------------------------- plain versions
def gather_plain(ids: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """[K, N]: row ids[i] of the [M, K] table in column i."""
    kernels.CALLS["material_gather_plain"] += 1
    return table.index_select(0, ids.long()).T.contiguous()


def adjoint_plain(ids: torch.Tensor, g: torch.Tensor, m: int) -> torch.Tensor:
    """[M, K]: the [K, N] cotangent summed per material, one masked sum
    per row (deterministic)."""
    kernels.CALLS["material_adjoint_plain"] += 1
    return torch.stack([torch.where(ids == j, g, 0.0).sum(dim=1)
                        for j in range(m)])


# ------------------------------------------------------------- wrappers
def _launch(name: str, tensors, ints) -> None:
    """`kernels.launch` of the library's fov_`name` with n, m, k."""
    kernels.launch(load_cuda_library(), name, tensors, *ints)


def gather(ids: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """[K, N] f32: the table's row of each id, SoA. Launches
    `material_gather_kernel` on a CUDA tensor, the plain version on a
    CPU tensor."""
    m, k = table.shape
    _check(ids, table, m, k, "table")
    if ids.device.type == "cpu":
        return gather_plain(ids, table)
    n = ids.shape[0]
    out = torch.empty((k, n), dtype=torch.float32, device=ids.device)
    if n:
        _launch("material_gather", (ids, table, out), (n, m, k))
    return out


def adjoint(ids: torch.Tensor, g: torch.Tensor, m: int) -> torch.Tensor:
    """[M, K] f32: the [K, N] cotangent `g` summed into the rows its ids
    name, in an order fixed by (N, M, K). Launches the two adjoint
    kernels on a CUDA tensor, the plain version on a CPU tensor."""
    if g.dim() != 2 or g.shape[1] != ids.shape[0]:
        raise ValueError(f"the cotangent must be [K, {ids.shape[0]}], got "
                         f"{tuple(g.shape)}")
    k = g.shape[0]
    _check(ids, g, m, k, "the cotangent")
    if ids.device.type == "cpu":
        return adjoint_plain(ids, g, m)
    n = ids.shape[0]
    if not n:
        return torch.zeros((m, k), dtype=torch.float32, device=ids.device)
    out = torch.empty((m, k), dtype=torch.float32, device=ids.device)
    partial = torch.empty((m * k * -(-n // WARP_RAYS),), dtype=torch.float32,
                          device=ids.device)
    _launch("material_adjoint", (ids, g, partial, out), (n, m, k))
    return out


class MaterialLookup(torch.autograd.Function):
    """(ids [N] int32 in [0, M), table [M, K]) -> [K, N], differentiable
    in the table. The forward saves only the ids, so a recompute under
    torch.utils.checkpoint runs it again from scratch."""

    @staticmethod
    def forward(ctx, ids, table):
        ctx.save_for_backward(ids)
        ctx.m = table.shape[0]
        return gather(ids, table)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        ids, = ctx.saved_tensors
        return None, adjoint(ids, g.contiguous(), ctx.m)


def counters() -> dict:
    """The material kernels' launches and the plain versions' calls so
    far."""
    return {k: kernels.CALLS[k] for k in COUNTED}
