"""Multi-process launch on torch.distributed (counterpart of
`fovtrace/dist/launch.py`).

Every process runs the same program; `init_distributed` joins them into
one process group, and the render screen's rows are then split over the
ranks (`global_mesh`). With torchrun:

    torchrun --standalone --nproc_per_node 4 -m fovtrace_torch.app.cli \\
        --sharded --scene earth --width 1920 --height 1088

or by hand, one process per rank:

    FOVTRACE_COORDINATOR=localhost:29500 FOVTRACE_NUM_PROCESSES=2 \\
    FOVTRACE_PROCESS_ID=0 python -m fovtrace_torch.app.optimize ...

The backend follows the device: NCCL for CUDA tensors, gloo for CPU
tensors. Several ranks on one card must pass `backend="gloo"` (NCCL
refuses two ranks on one device; the collectives use only all-reduce and
broadcast, which gloo offers for CUDA tensors).
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist

from fovtrace_torch.dist.collectives import Mesh


def _url(address: str) -> str:
    return address if "://" in address else f"tcp://{address}"


def init_distributed(coordinator_address: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None,
                     device="cuda", backend: str | None = None) -> bool:
    """Join the process group (idempotent). Returns True when more than
    one process runs.

    Each of the address (host:port, or an init URL such as file://...),
    the process count and this process's id is taken from the argument,
    else from FOVTRACE_COORDINATOR / FOVTRACE_NUM_PROCESSES /
    FOVTRACE_PROCESS_ID, else from torchrun's MASTER_ADDR / MASTER_PORT /
    WORLD_SIZE / RANK. With none of them this is a single process and no
    group is made. `backend` defaults to NCCL for a CUDA device and gloo
    for the CPU."""
    if dist.is_initialized():
        return dist.get_world_size() > 1
    env = os.environ
    address = coordinator_address or env.get("FOVTRACE_COORDINATOR")
    if num_processes is None and "FOVTRACE_NUM_PROCESSES" in env:
        num_processes = int(env["FOVTRACE_NUM_PROCESSES"])
    if process_id is None and "FOVTRACE_PROCESS_ID" in env:
        process_id = int(env["FOVTRACE_PROCESS_ID"])
    if address is None and "MASTER_ADDR" in env:
        address = "env://"
        if num_processes is None:
            num_processes = int(env["WORLD_SIZE"])
        if process_id is None:
            process_id = int(env["RANK"])
    if address is None and num_processes is None:
        return False
    if address is None or num_processes is None or process_id is None:
        raise ValueError(
            "a process group needs its coordinator address, process count "
            f"and process id; got {address!r}, {num_processes!r}, "
            f"{process_id!r}")
    if torch.device(device).type == "cuda":
        torch.cuda.set_device(rank_device(device))
    if backend is None:
        backend = "nccl" if torch.device(device).type == "cuda" else "gloo"
    dist.init_process_group(backend, init_method=_url(address),
                            world_size=num_processes, rank=process_id)
    return num_processes > 1


def rank_device(device="cuda") -> torch.device:
    """This rank's device: a CUDA device without an index becomes
    cuda:LOCAL_RANK (torchrun's one card per process; 0 without it)."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
    return dev


def global_mesh(device="cuda") -> Mesh:
    """The row tiles over every rank of the process group (one tile and
    no group in a single process)."""
    dev = rank_device(device)
    if not dist.is_initialized():
        return Mesh(rank=0, size=1, device=dev)
    return Mesh(rank=dist.get_rank(), size=dist.get_world_size(),
                device=dev, group=dist.group.WORLD)


def is_coordinator() -> bool:
    return not dist.is_initialized() or dist.get_rank() == 0


def shutdown() -> None:
    """Leave the process group, if one was joined."""
    if dist.is_initialized():
        dist.destroy_process_group()
