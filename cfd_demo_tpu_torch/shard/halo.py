"""Halo exchange over a row mesh (↔ cfd_demo_tpu/shard/halo.py:33-84).

Convention: fields are (local_rows, nx) blocks of a (ny, nx) global
array, contiguous rows per shard, shard 0 owning the bottom rows. Not
periodic: the edge shards receive zero halos, and the domain's boundary
conditions mask them. Rows move as device-to-device tensor copies (a
copy within one device, or between two cards); nothing is read back to
the host.

The column exchanges of the 2-D tier (``exchange_cols``,
``exchange_rows_cols``) are not ported yet (ROADMAP.md item 12b).
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch

from .mesh import RowMesh


def exchange_rows(blocks: Sequence[torch.Tensor], mesh: RowMesh,
                  width: int) -> Tuple[torch.Tensor, ...]:
    """Every shard's block extended to (width + local + width) rows with
    its neighbours' edge rows: the shard below's top ``width`` rows under
    it, the shard above's bottom ``width`` rows over it, zero rows at the
    domain's edges."""
    S = mesh.size
    if len(blocks) != S:
        raise ValueError(f"exchange_rows: {len(blocks)} blocks for {S} shards")
    if width < 1 or any(b.shape[0] < width for b in blocks):
        raise ValueError(f"exchange_rows: a halo of {width} rows needs blocks of "
                         f"at least that many rows")
    out = []
    for s, (b, dev) in enumerate(zip(blocks, mesh.devices)):
        zeros = b.new_zeros((width,) + b.shape[1:])
        below = blocks[s - 1][-width:].to(dev) if s > 0 else zeros
        above = blocks[s + 1][:width].to(dev) if s < S - 1 else zeros
        out.append(torch.cat([below, b, above], dim=0))
    return tuple(out)


def global_row_index(local_rows: int, shard: int, halo: int = 0, device=None):
    """Global row index of each row of shard ``shard``'s (halo + local +
    halo) block, as a (rows, 1) int64 tensor."""
    base = shard * local_rows - halo
    return torch.arange(base, base + local_rows + 2 * halo, device=device)[:, None]


def pmax(xs: Sequence[torch.Tensor], mesh: RowMesh) -> torch.Tensor:
    """The max over the shards' 0-d tensors, as a 0-d tensor on the first
    shard's device (no host read)."""
    dev = mesh.devices[0]
    return torch.amax(torch.stack([x.to(dev) for x in xs]))
