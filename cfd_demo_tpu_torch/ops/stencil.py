"""Shifted-array stencil helpers (↔ cfd_demo_tpu/ops/stencil.py).

Stencils are whole-array shifted views. Out-of-range reads return 0.0:
the consumers rely on that, including the divergence reading v's
implicit zero top row. The JAX package routes these through a
``StencilCtx`` so that its Pallas bodies can swap in VMEM rolls; the
port's kernels are CUDA and read their neighbours themselves, so the
plain ops here take their index tensors from the input's device.

Every helper works over leading dimensions: a batch of scenes is a
``(B, ny, nx)`` array, sliced with ``...`` and shaped by its last two
axes. A per-scene scalar, a ``(B,)`` tensor, meets such an array only
through :func:`per_scene`, which gives it the shape ``(B, 1, 1)``: left
as ``(B,)`` it would broadcast against the last axis instead.
"""
from __future__ import annotations

import torch


def shifted(src: torch.Tensor, out_shape, dj: int, di: int) -> torch.Tensor:
    """out[j, i] = src[j + dj, i + di], zero where out of bounds.

    ``src`` may be any of the staggered u/v/p arrays and ``out_shape``
    the shape of the field being updated; only its last two entries are
    read, and ``src``'s leading dimensions carry over."""
    H, W = out_shape[-2:]
    out = src.new_zeros(src.shape[:-2] + (H, W))
    j0, j1 = max(0, -dj), min(H, src.shape[-2] - dj)
    i0, i1 = max(0, -di), min(W, src.shape[-1] - di)
    if j1 > j0 and i1 > i0:
        out[..., j0:j1, i0:i1] = src[..., j0 + dj:j1 + dj, i0 + di:i1 + di]
    return out


def per_scene(x):
    """A per-scene scalar ready to broadcast against ``(..., H, W)``
    fields: a tensor of shape ``(B,)`` becomes ``(B, 1, 1)``; floats and
    0-d tensors pass through."""
    if isinstance(x, torch.Tensor) and x.dim() > 0:
        return x.reshape(x.shape + (1, 1))
    return x


def col_index(shape, device) -> torch.Tensor:
    """int64 x (i) indices broadcast to ``shape`` (a view, not a copy)."""
    return torch.arange(shape[-1], device=device)[None, :].expand(shape)


def row_index(shape, device, offset: int = 0) -> torch.Tensor:
    """int64 y (j) indices broadcast to ``shape``; ``offset`` is the
    global row of local row 0 (a row block of a sharded field)."""
    return torch.arange(offset, offset + shape[-2], device=device)[:, None].expand(shape)


def apply_solid_mask(x: torch.Tensor, mask) -> torch.Tensor:
    """Zero x where the bool solid mask is set; None means no obstacles."""
    return x if mask is None else x.masked_fill(mask, 0.0)


class Shifts:
    """Cached shifted views of one source array on a target shape."""

    def __init__(self, src: torch.Tensor, out_shape):
        self._src = src
        self._shape = tuple(out_shape)
        self._cache = {}

    def __call__(self, dj: int, di: int) -> torch.Tensor:
        key = (dj, di)
        if key not in self._cache:
            self._cache[key] = shifted(self._src, self._shape, dj, di)
        return self._cache[key]
