"""The schedule-row copy probe (counterpart of `scripts/probe_smem_dma.py`).

    python -m fovtrace_torch.scripts.probe_smem_dma [--device cuda]

It checks the plumbing a streaming intersection kernel needs: per ray
block, copy the block's schedule row from device memory into shared
memory asynchronously and wait for it, walk the row in a loop whose
length is data (counts[b]), and store one output row at the block's
index:

    out[b, :] = sum over l < counts[b] of
                table[e % 65536, :] * float(e // 65536)  + rays[b, 0, :]

with e = sched[b, l], summed in order, a multiply and an add per entry.
The kernel (csrc/probes.cu, `smem_dma_kernel`) runs GROUP = 8 ray blocks
per CUDA block in a loop and copies each row with a bulk (TMA) copy that
completes on an mbarrier. `smem_dma` takes any (NB, NSC, SW) with NB a
multiple of 8 and SW a multiple of 4; `main` runs the script's size and
its numpy check.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from fovtrace_torch import kernels
from fovtrace_torch.scripts import (check_tensors, launched,
                                    load_probe_library)

NB, NSC, R = 16, 64, 256
NSC_PAD = 128   # rows padded so each copy is 16-byte aligned and sized
GROUP = 8       # ray blocks per CUDA block


def make_inputs(nb: int = NB, nsc: int = NSC, sw: int = NSC_PAD,
                seed: int = 0):
    """(counts [nb], sched [nb, sw], rays [nb, 16, R], table [nsc, R])
    numpy arrays drawn as the script draws them: at the default sizes
    and seed, bitwise the script's inputs."""
    rng = np.random.default_rng(seed)
    sched = rng.integers(0, nsc, size=(nb, nsc)).astype(np.int32)
    sched = sched + (rng.integers(0, 100, size=(nb, nsc)).astype(np.int32)
                     << 16)
    sched = np.pad(sched, ((0, 0), (0, sw - nsc)))
    counts = rng.integers(1, nsc, size=(nb,)).astype(np.int32)
    rays = rng.normal(size=(nb, 16, R)).astype(np.float32)
    table = rng.normal(size=(nsc, R)).astype(np.float32)
    return counts, sched, rays, table


def numpy_reference(counts, sched, rays, table):
    """The script's own check, on numpy arrays."""
    ref = np.zeros((counts.shape[0], R), np.float32)
    for b in range(counts.shape[0]):
        acc = np.zeros((R,), np.float32)
        for l in range(counts[b]):
            e = sched[b, l]
            acc += table[e % 65536] * np.float32(e >> 16)
        ref[b] = acc + rays[b, 0, :]
    return ref


def plain(counts, sched, rays, table):
    """Plain PyTorch version: [NB, R] f32, stepping over row slots; every
    output element sees the kernel's multiplies and adds in its order."""
    kernels.CALLS["smem_dma_plain"] += 1
    acc = torch.zeros((counts.shape[0], R), dtype=torch.float32,
                      device=rays.device)
    n_slots = int(counts.max()) if counts.numel() else 0
    for l in range(n_slots):
        b = torch.nonzero(counts > l).squeeze(1)
        e = sched[b, l]
        key = torch.div(e, 65536, rounding_mode="floor").to(torch.float32)
        acc[b] = acc[b] + table[(e % 65536).long()] * key[:, None]
    return acc + rays[:, 0, :]


def smem_dma(counts, sched, rays, table):
    """The probe: [NB, R] f32. On a CUDA tensor it launches
    smem_dma_kernel, on a CPU tensor it runs `plain`; any other device
    raises. Entries must be non-negative with ids below NSC, and every
    count at most SW."""
    check_tensors([(counts, torch.int32, "counts"),
                   (sched, torch.int32, "sched"),
                   (rays, torch.float32, "rays"),
                   (table, torch.float32, "table")], rays.device)
    nb = counts.shape[0]
    if counts.dim() != 1 or nb % GROUP:
        raise ValueError(f"counts must be [NB], NB a multiple of {GROUP}")
    if sched.dim() != 2 or sched.shape[0] != nb or sched.shape[1] % 4:
        raise ValueError(f"sched must be [{nb}, SW], SW a multiple of 4 "
                         f"(16-byte rows), got {tuple(sched.shape)}")
    if sched.shape[1] * 4 > 227 * 1024:
        raise ValueError("a schedule row must fit a block's shared memory")
    if tuple(rays.shape) != (nb, 16, R) or table.dim() != 2 or \
            table.shape[1] != R:
        raise ValueError(f"rays must be [{nb}, 16, {R}] and table [NSC, {R}]")
    if rays.device.type == "cpu":
        return plain(counts, sched, rays, table)
    out = torch.empty((nb, R), dtype=torch.float32, device=rays.device)
    if nb:
        launched(load_probe_library().fov_smem_dma, counts.data_ptr(),
                 sched.data_ptr(), rays.data_ptr(), table.data_ptr(),
                 out.data_ptr(), nb, sched.shape[1], name="smem_dma",
                 dev=rays.device)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default="cuda")
    dev = torch.device(p.parse_args(argv).device)
    arrays = make_inputs()
    out = smem_dma(*(torch.from_numpy(a).to(dev) for a in arrays))
    err = float(np.abs(out.cpu().numpy() - numpy_reference(*arrays)).max())
    print("max err:", err)
    assert err < 1e-3, "MISMATCH"
    print(f"grouped sub-blocks + row copy to shared memory + row store on "
          f"{dev.type}: OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
