"""Counter-based per-pixel RNG (counterpart of `fovtrace/core/rng.py`).

TEA hash seeding a per-pixel LCG stream, bit-exact with the reference.
The generator state is a uint32 value carried in an int64 tensor: PyTorch
has no CPU kernels for uint32 `+`, `<<` and `>>`, so every operation runs
in int64 and is masked back to 32 bits.
"""

from __future__ import annotations

import torch

_M32 = 0xFFFFFFFF


def _u32(x) -> torch.Tensor:
    return torch.as_tensor(x).to(torch.int64) & _M32


def tea(val0, val1, rounds: int = 16) -> torch.Tensor:
    """TEA hash of two uint32 values (int64 tensors in, int64 out)."""
    v0 = _u32(val0)
    v1 = _u32(val1)
    v0, v1 = torch.broadcast_tensors(v0, v1)
    s = 0
    delta = 0x9E3779B9
    k0, k1, k2, k3 = 0xA341316C, 0xC8013EA4, 0xAD90777D, 0x7E95761E
    for _ in range(rounds):
        s = (s + delta) & _M32
        v0 = (v0 + ((((v1 << 4) + k0) & _M32) ^ ((v1 + s) & _M32)
                    ^ ((v1 >> 5) + k1))) & _M32
        v1 = (v1 + ((((v0 << 4) + k2) & _M32) ^ ((v0 + s) & _M32)
                    ^ ((v0 >> 5) + k3))) & _M32
    return v0


def lcg_next(state: torch.Tensor) -> torch.Tensor:
    """One LCG step: state' = 1664525 * state + 1013904223 (mod 2^32)."""
    return (state * 1664525 + 1013904223) & _M32


def rnd(state: torch.Tensor):
    """Draw a uniform float32 in [0, 1) and advance the stream.

    Returns (value, new_state)."""
    new_state = lcg_next(state)
    val = (new_state & 0x00FFFFFF).to(torch.float32) / float(0x01000000)
    return val, new_state


def pixel_seed(pixel_index, frame, rounds: int = 16) -> torch.Tensor:
    """Per-pixel seed tea<16>(pixel_index, frame)."""
    return tea(pixel_index, frame, rounds)
