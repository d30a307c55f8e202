"""A single-process row mesh (↔ the row tier of cfd_demo_tpu/shard/mesh.py).

The JAX package's explicit sharded step runs under ``shard_map``: one
program drives every shard of a device mesh, and its tests run it on 8
virtual CPU devices. The port's counterpart is a :class:`RowMesh`, a
tuple of torch devices, one per row shard, which may repeat: the step is
one Python program over the shards' blocks, and halo rows move between
them as tensor copies (shard/halo.py). On one card every shard lies on
``cuda:0``; with n cards shard i lies on ``cuda:i``.

A sharded field is a tuple of contiguous row blocks of the global
(ny, *) array, shard 0 owning the bottom rows (halo.py:11-13), each on
its shard's device. A sharded :class:`~cfd_demo_tpu_torch.core.state.State`
holds such tuples in its field entries (u, v, p, p', and u_prev, v_prev
under JS semantics) and its scalars, replicated, as 0-d tensors on the
first shard's device.

The GSPMD helpers of the JAX module (mesh.py:87, :175, :213: a jitted
step that XLA's partitioner shards) have no torch counterpart; the
explicit tier stands in for them.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from ..core.state import State

FIELDS = ("u", "v", "p", "p_prime", "u_prev", "v_prev")


@dataclasses.dataclass(frozen=True)
class RowMesh:
    """One torch device per row shard, bottom rows first; devices may
    repeat."""

    devices: Tuple[torch.device, ...]

    def __post_init__(self):
        devs = tuple(torch.device(d) for d in self.devices)
        if not devs:
            raise ValueError("a RowMesh needs at least one device")
        object.__setattr__(self, "devices", devs)

    @property
    def size(self) -> int:
        return len(self.devices)


def make_mesh(n: int, device="cuda") -> RowMesh:
    """n row shards: on CUDA, shard i on ``cuda:i`` when there are n
    cards, else all n on ``cuda:0``; on another device type ("cpu"),
    all n on it."""
    if n < 1:
        raise ValueError(f"make_mesh: n must be >= 1, got {n}")
    device = torch.device(device)
    if device.type == "cuda":
        if torch.cuda.device_count() >= n:
            return RowMesh(tuple(torch.device("cuda", i) for i in range(n)))
        return RowMesh((torch.device("cuda", 0),) * n)
    return RowMesh((device,) * n)


def split_rows(x: torch.Tensor, mesh: RowMesh) -> Tuple[torch.Tensor, ...]:
    """A global (ny, *) tensor as the mesh's contiguous row blocks, each
    on its shard's device."""
    S = mesh.size
    if x.shape[0] % S:
        raise ValueError(f"{x.shape[0]} rows do not split into {S} shards")
    loc = x.shape[0] // S
    return tuple(x[s * loc:(s + 1) * loc].to(d).contiguous()
                 for s, d in enumerate(mesh.devices))


def join_rows(blocks, device) -> torch.Tensor:
    """The inverse of :func:`split_rows`, on ``device``."""
    return torch.cat([b.to(device) for b in blocks], dim=0)


def shard_state(state: State, mesh: RowMesh) -> State:
    """A State whose fields are split into the mesh's row blocks; the
    scalars, replicated, on the first shard's device."""
    out = {}
    for f in dataclasses.fields(State):
        x = getattr(state, f.name)
        if x is None:
            out[f.name] = None
        elif f.name in FIELDS:
            if x.dim() != 2:
                raise ValueError(f"shard_state: {f.name} has shape {tuple(x.shape)}; "
                                 f"a batch is not sharded")
            out[f.name] = split_rows(x, mesh)
        else:
            out[f.name] = x.to(mesh.devices[0])
    return State(**out)


def gather_state(sharded: State, device) -> State:
    """The inverse of :func:`shard_state`: one State on ``device``."""
    out = {}
    for f in dataclasses.fields(State):
        x = getattr(sharded, f.name)
        if x is None:
            out[f.name] = None
        elif f.name in FIELDS:
            out[f.name] = join_rows(x, device)
        else:
            out[f.name] = x.to(device)
    return State(**out)
