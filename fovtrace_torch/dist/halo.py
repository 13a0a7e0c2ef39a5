"""Row halos across the screen tiles (counterpart of
`fovtrace/dist/halo.py`).

The reconstruction filters (Sobel saliency, pull-push blur, A-Trous)
read rows across a tile's edge. A tile's block [bh, ...] is padded with
its neighbours' edge rows; past the screen's true edges the halo rows
are ZERO, the single-frame filters' zero padding, so a sharded filter
equals its single-frame counterpart.
"""

from __future__ import annotations

from typing import List, Sequence

import torch

from fovtrace_torch.dist.collectives import Mesh, neighbour_rows


def halo_pad_rows(x: torch.Tensor, halo: int, mesh: Mesh) -> torch.Tensor:
    """[bh, ...] -> [bh + 2 halo, ...] with the neighbours' rows (zeros
    at the screen's edges)."""
    assert halo <= x.shape[0], (halo, x.shape)
    prev, nxt = neighbour_rows(x[:halo], x[-halo:], mesh)
    return torch.cat([prev, x, nxt], dim=0)


def halo_pad_planes(planes: Sequence[torch.Tensor], halo: int, mesh: Mesh
                    ) -> List[torch.Tensor]:
    """halo_pad_rows of several [bh, W] planes in one collective."""
    return list(halo_pad_rows(torch.stack(list(planes), dim=1), halo,
                              mesh).unbind(1))


def crop_rows(x: torch.Tensor, halo: int) -> torch.Tensor:
    """Inverse of halo_pad_rows: drop the halo rows."""
    return x[halo:x.shape[0] - halo]
