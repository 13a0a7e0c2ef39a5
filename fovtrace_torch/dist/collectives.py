"""Row collectives over the screen tiles, on torch.distributed.

The screen's rows are split into equal blocks, one per rank (`Mesh`).
Every collective here is one SUM all-reduce: a gather writes this rank's
rows into a zeroed buffer of the whole frame, whose sum over the ranks is
the concatenation (x + 0 is exact), and a neighbour exchange is such a
gather of every rank's edge rows. That one design serves each backend
the port runs on: NCCL across cards, gloo on the CPU, and gloo with CUDA
tensors for several ranks on one card (NCCL refuses two ranks on one
device, and gloo's CUDA path offers only broadcast and all-reduce). A
gather so moves `size` times the bytes of an all-gather; what the frame
gathers is small beside the frame's work (the [5, H, W] history and
depth caches, the coarse pull-push levels and the halos).

With no process group (`Mesh.group is None`, a single process) every
collective is the identity and every halo past the screen's edge is zero.
Each torch.distributed call is in an `app.profiler.span` named
fov.coll.<op> (<op> the function's name, without a trailing underscore);
the identity opens none.
"""

from __future__ import annotations

import dataclasses
from typing import Any, List, Sequence

import torch
import torch.distributed as dist

from fovtrace_torch.app.profiler import span


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This process's place among the row tiles: rank `rank` of `size`
    holds rows [rank * bh, (rank + 1) * bh) of the screen on `device`."""

    rank: int
    size: int
    device: torch.device
    group: Any = None   # the process group; None: one process, no group


def all_reduce_sum(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The sum of `x` over the ranks (a new tensor)."""
    if mesh.group is None:
        return x
    y = x.detach().clone()
    with span("fov.coll.all_reduce_sum"):
        dist.all_reduce(y, op=dist.ReduceOp.SUM, group=mesh.group)
    return y


def all_gather_rows(x: torch.Tensor, mesh: Mesh, dim: int = 0
                    ) -> torch.Tensor:
    """Every rank's block of `x`, concatenated along `dim` in rank order
    (a tiled all-gather). Bool tensors travel as uint8."""
    if mesh.group is None:
        return x
    if x.dtype == torch.bool:
        return all_gather_rows(x.to(torch.uint8), mesh, dim).to(torch.bool)
    n = x.shape[dim]
    shape = list(x.shape)
    shape[dim] = n * mesh.size
    buf = x.new_zeros(shape)
    buf.narrow(dim, mesh.rank * n, n).copy_(x)
    with span("fov.coll.all_gather_rows"):
        dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=mesh.group)
    return buf


def gather_planes(planes: Sequence[torch.Tensor], mesh: Mesh
                  ) -> List[torch.Tensor]:
    """all_gather_rows of several [bh, W] float planes in one all-reduce."""
    full = all_gather_rows(torch.stack(list(planes)), mesh, dim=1)
    return list(full.unbind(0))


def my_rows(full: torch.Tensor, mesh: Mesh, n: int, dim: int = 0
            ) -> torch.Tensor:
    """This rank's block of n rows of a gathered tensor."""
    return full.narrow(dim, mesh.rank * n, n)


def neighbour_rows(top: torch.Tensor, bottom: torch.Tensor, mesh: Mesh):
    """(the previous rank's `bottom`, the next rank's `top`); zeros where
    there is no such rank (the screen's edges)."""
    if mesh.group is None:
        return torch.zeros_like(bottom), torch.zeros_like(top)
    buf = top.new_zeros((mesh.size, 2) + tuple(top.shape))
    buf[mesh.rank, 0] = top
    buf[mesh.rank, 1] = bottom
    with span("fov.coll.neighbour_rows"):
        dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=mesh.group)
    prev = buf[mesh.rank - 1, 1] if mesh.rank > 0 else torch.zeros_like(bottom)
    nxt = buf[mesh.rank + 1, 0] if mesh.rank < mesh.size - 1 \
        else torch.zeros_like(top)
    return prev, nxt


def broadcast_(tensors: Sequence[torch.Tensor], mesh: Mesh,
               src: int = 0) -> None:
    """Overwrite `tensors` (one dtype) in place with rank `src`'s values,
    in one broadcast."""
    if mesh.group is None:
        return
    flat = torch.cat([t.detach().reshape(-1) for t in tensors])
    with span("fov.coll.broadcast"):
        dist.broadcast(flat, src=src, group=mesh.group)
    with torch.no_grad():
        for t, v in zip(tensors, flat.split([t.numel() for t in tensors])):
            t.copy_(v.view_as(t))
