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
The kernel (csrc/probes.cu, `smem_dma_kernel`) runs persistent CTAs of
16 warps; each warp walks (ray block, lane slice) items and copies only
a row's live prefix, `prefix_bytes`, in chunks of up to CH entries (the
first with the slice of the block's ray row 0) by bulk (TMA) copies that
complete on mbarriers, up to RING of them in flight. A CTA keeps a slice
of LANES of the table's 256 lanes in shared memory; where it does not
fit (`table_lanes(NSC)` 0), the kernel reads the table from global
memory. `layout` reads these sizes from the built library. The items go
round robin in ascending block order unless `forced_grid` says
"longest": the ticket sort would cost the call more than the kernel
takes. `smem_dma` takes any (NB, NSC, SW) with SW a
multiple of 4; `main` runs the script's size and its numpy check.
"""

from __future__ import annotations

import argparse
import ctypes
import sys

import numpy as np
import torch

from fovtrace_torch import kernels
from fovtrace_torch.scripts import (block_order, check_aligned,
                                    check_tensors, launched,
                                    load_probe_library)

NB, NSC, R = 16, 64, 256
NSC_PAD = 128   # rows padded so each copy is 16-byte aligned and sized
# smem_dma_kernel's layout: warps per CTA, entries per chunk stage, chunk
# stages per warp, lanes of a table slice, and the dynamic shared memory
# a CTA may take. The kernel's own values come from the library
# (`layout`, `table_lanes`); these copies serve only `lane_slice`, whose
# CPU test states the size rule, and must track DMA_WARPS, DMA_CH,
# DMA_RING, DMA_LANES and DMA_SMEM in csrc/probes.cu (the CUDA tests hold
# them to the library).
WARPS, CH, RING, LANES = 16, 64, 6, 64
SMEM = 227 * 1024 - 4096
LAYOUT_KEYS = ("warps", "ch", "ring", "lanes", "smem")


def ring_bytes(lanes: int) -> int:
    """The warps' rings for a slice of `lanes`: each stage holds a chunk
    of CH entries and the slice of its block's ray row 0."""
    return WARPS * RING * (CH + lanes) * 4


def lane_slice(nsc: int) -> int:
    """Lanes of the table slice a CTA keeps in shared memory for a table
    of nsc rows: LANES where the [nsc, LANES] f32 slice fits beside the
    warps' rings, else 0 (the kernel then reads the table from global
    memory)."""
    return LANES if nsc * LANES * 4 + ring_bytes(LANES) <= SMEM else 0


def layout() -> dict:
    """The built kernel's layout, {LAYOUT_KEYS: int}, from the library."""
    out = (ctypes.c_int * len(LAYOUT_KEYS))()
    load_probe_library().fov_smem_dma_layout(ctypes.addressof(out))
    return dict(zip(LAYOUT_KEYS, out))


def table_lanes(nsc: int) -> int:
    """Lanes of the table slice the built kernel keeps in shared memory
    for nsc rows (0: it reads the table from global memory)."""
    return load_probe_library().fov_smem_dma_lanes(nsc)


def prefix_bytes(counts: torch.Tensor) -> torch.Tensor:
    """[NB] int64: the bytes the kernel copies of each row, its live
    prefix of counts[b] int32 entries rounded up to 16 bytes (0 for an
    empty row)."""
    return (counts.to(torch.int64) * 4 + 15) // 16 * 16


def traffic(counts: torch.Tensor, lanes: int, nsc: int, ctas: int) -> dict:
    """What a launch on `ctas` CTAs with a table slice of `lanes` (0: the
    table in global memory) moves: `copy_bytes`, the rows' live
    prefixes, and `ray_bytes`, ray row 0 of each block, both by bulk copy;
    `table_bytes`, the table bytes read from L2 (each CTA's slice once per
    slice it takes, or a 1 KB row per live entry from global memory)."""
    live = int(counts.sum())
    if lanes:
        table = max(ctas, R // lanes) * nsc * lanes * 4
    else:
        table = live * R * 4
    return dict(copy_bytes=int(prefix_bytes(counts).sum()),
                ray_bytes=counts.shape[0] * R * 4, table_bytes=table)


def warp_entries(counts: torch.Tensor, lanes: int, ctas: int,
                 warps: int) -> torch.Tensor:
    """[warps of lane slice 0] int64: the live entries each of them walks
    when `ctas` CTAs of `warps` warps with slices of `lanes` (0: all 256)
    take the blocks in ascending order, as the kernel assigns them: block
    p to warp p mod (warps x the slice's CTAs). The kernel's time follows
    the largest."""
    slices = R // (lanes or R)
    n = warps * ((max(ctas, slices) + slices - 1) // slices)
    c = counts.to(torch.int64).cpu()
    c = torch.cat([c, c.new_zeros((-c.shape[0]) % n)])
    return c.view(-1, n).sum(dim=0)


def grid(nb: int, nsc: int) -> int:
    """The persistent grid smem_dma_kernel takes on the current card."""
    n = load_probe_library().fov_smem_dma_ctas(nb, nsc)
    if n < 0:
        raise RuntimeError(f"smem_dma: CUDA error {-n} sizing the grid")
    return n


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
    smem_dma_kernel on the persistent grid (or `forced_grid`'s), on a CPU
    tensor it runs `plain`; any other device raises. Entries must be
    non-negative with ids below NSC, and every count at most SW; on the
    card sched, rays and table start on 16 bytes."""
    check_tensors([(counts, torch.int32, "counts"),
                   (sched, torch.int32, "sched"),
                   (rays, torch.float32, "rays"),
                   (table, torch.float32, "table")], rays.device)
    nb = counts.shape[0]
    if counts.dim() != 1:
        raise ValueError(f"counts must be [NB], got {tuple(counts.shape)}")
    if sched.dim() != 2 or sched.shape[0] != nb or sched.shape[1] % 4:
        raise ValueError(f"sched must be [{nb}, SW], SW a multiple of 4 "
                         f"(16-byte rows), got {tuple(sched.shape)}")
    if tuple(rays.shape) != (nb, 16, R) or table.dim() != 2 or \
            table.shape[1] != R:
        raise ValueError(f"rays must be [{nb}, 16, {R}] and table [NSC, {R}]")
    if rays.device.type == "cpu":
        return plain(counts, sched, rays, table)
    check_aligned([(sched, "sched"), (rays, "rays"), (table, "table")])
    out = torch.empty((nb, R), dtype=torch.float32, device=rays.device)
    if nb:
        _launch(counts, sched, rays, table, out)
    return out


def _launch(counts, sched, rays, table, out):
    """Launch smem_dma_kernel on the current stream, the ray blocks in
    `block_order` (ascending by default: no order passed); count the
    launch."""
    order, ctas = block_order(counts, default="ascending")
    launched(load_probe_library().fov_smem_dma, counts.data_ptr(),
             sched.data_ptr(), rays.data_ptr(), table.data_ptr(),
             None if order is None else order.data_ptr(), out.data_ptr(),
             counts.shape[0],
             sched.shape[1], table.shape[0], ctas, name="smem_dma",
             dev=rays.device)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default="cuda")
    dev = torch.device(p.parse_args(argv).device)
    arrays = make_inputs()
    out = smem_dma(*(torch.from_numpy(a).to(dev) for a in arrays))
    err = float(np.abs(out.cpu().numpy() - numpy_reference(*arrays)).max())
    print("max err:", err)
    assert err < 1e-3, "MISMATCH"
    where = (f"table slice of {table_lanes(NSC)} lanes" if dev.type == "cuda"
             else "the plain version")
    print(f"live-prefix row copies to shared memory + {where} + row store "
          f"on {dev.type}: OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
