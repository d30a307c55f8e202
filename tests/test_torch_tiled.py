"""Kernel 2's tiled schedule and the rounds kernel's cluster rule, on the CPU.

csrc/jacobi.cu runs jacobi_fused_k as ceil(k / t) launches of at most t
sweeps, each block owning a tile and sweeping a window of the tile and a
t-cell halo, then takes the owned cells; the last launch applies the p'
BCs. No CUDA kernel runs here: ``tiled_sweeps`` emulates that schedule
with ``jacobi_fused_k_shard_plain`` on each window (a block at global
row and column offsets, owning the tile), and the result must be the
whole field's ``jacobi_fused_k_shard_plain`` to the bit, and the Pallas
kernel's within tests/test_torch_kernels.py's tolerance. The CUDA kernel
itself is held to the same bits by tests/test_torch_cuda.py on the card.
"""
import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cfd_demo_tpu.kernels.jacobi_pallas import jacobi_fused_k as j_fused_k

from cfd_demo_tpu_torch.kernels.jacobi import (block_pprime_bcs,
                                               jacobi_fused_k_shard_plain)
from cfd_demo_tpu_torch.kernels import cluster as kcl
from cfd_demo_tpu_torch.ops.poisson import _apply_pprime_bcs

torch.set_num_threads(1)

OMEGA = 0.75


def origins(n: int, tile: int):
    """The tiles' first owned cells along an axis (csrc/jacobi.cu
    tile_origin): every ``tile`` cells, the last clamped inside [0, n)."""
    return [min(b * tile, max(n - tile, 0)) for b in range(-(-n // tile))]


def tiled_sweeps(pp, rhs, dx, dy, k, t, tile):
    """kernel 2's schedule: ceil(k / t) launches, the remainder last; in
    each, every (ty, tx) tile sweeps its window (the tile and a t-cell
    halo, clipped to the grid) and keeps its owned cells; then the p'
    BCs once. Returns (p', the last launch's max owned |delta|)."""
    ny, nx = pp.shape
    ty, tx = tile
    n = -(-k // t)
    src = pp
    for launch in range(n):
        ts = t if launch < n - 1 else k - (n - 1) * t
        dst = torch.full_like(src, float("nan"))  # every cell must be written
        err = torch.zeros(())
        for oy in origins(ny, ty):
            for ox in origins(nx, tx):
                r0, r1 = max(oy - t, 0), min(oy + ty + t, ny)
                c0, c1 = max(ox - t, 0), min(ox + tx + t, nx)
                own_r = (oy - r0, min(oy + ty, ny) - r0)
                own_c = (ox - c0, min(ox + tx, nx) - c0)
                out, e = jacobi_fused_k_shard_plain(
                    src[r0:r1, c0:c1].contiguous(), rhs[r0:r1, c0:c1].contiguous(),
                    r0, ny, dx, dy, OMEGA, ts, *own_r, col_offset=c0, gnx=nx,
                    own_cols=own_c)
                dst[oy:oy + own_r[1] - own_r[0], ox:ox + own_c[1] - own_c[0]] = \
                    out[own_r[0]:own_r[1], own_c[0]:own_c[1]]
                err = torch.maximum(err, e)
        src = dst
    return block_pprime_bcs(src, (0, 0, ny, nx, 0, ny, 0, nx)), err


def inputs(seed, shape):
    """BC-consistent p' (what the folded kernels require) and a random
    rhs, made with numpy."""
    rng = np.random.default_rng(seed)
    pp = _apply_pprime_bcs(torch.from_numpy(
        (0.1 * rng.standard_normal(shape)).astype(np.float32)))
    return pp, torch.from_numpy(rng.standard_normal(shape).astype(np.float32))


def whole_field(pp, rhs, dx, dy, k):
    ny = pp.shape[0]
    return jacobi_fused_k_shard_plain(pp, rhs, 0, ny, dx, dy, OMEGA, k, 0, ny)


# (shape, tile): tiles that divide neither axis, a tile larger than the
# grid (3x3, and the narrow axes), and one ragged by a single cell.
SHAPES = [((3, 3), (8, 8)), ((5, 67), (4, 12)), ((67, 5), (12, 4)),
          ((130, 258), (43, 50)), ((257, 129), (32, 64)), ((64, 96), (24, 40)),
          ((40, 96), (13, 19))]
KS = [1, 3, 8, 9, 16, 17]


@pytest.mark.parametrize("t", [4, 8])
@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("shape,tile", SHAPES)
def test_tiled_schedule_is_the_whole_field_bit_for_bit(shape, tile, k, t):
    ny, nx = shape
    dx, dy = 1.0 / nx, 1.0 / ny
    pp, rhs = inputs(ny * 1000 + nx + k, shape)
    got, err = tiled_sweeps(pp, rhs, dx, dy, k, t, tile)
    ref, ref_err = whole_field(pp, rhs, dx, dy, k)
    assert torch.equal(got, ref), float((got - ref).abs().max())
    assert torch.equal(err, ref_err), (float(err), float(ref_err))


def test_tiled_schedule_clamps_a_one_cell_tile():
    """ny = 2 tiles + 1 row: without the clamp the last tile would own
    one row, and the top ring row's BC source would lie in another tile."""
    pp, rhs = inputs(7, (17, 33))
    assert origins(17, 8) == [0, 8, 9]
    got, err = tiled_sweeps(pp, rhs, 1 / 33, 1 / 17, 9, 4, (8, 16))
    ref, ref_err = whole_field(pp, rhs, 1 / 33, 1 / 17, 9)
    assert torch.equal(got, ref) and torch.equal(err, ref_err)


@functools.lru_cache(maxsize=None)
def pallas(shape, k, seed):
    ny, nx = shape
    pp, rhs = inputs(seed, shape)
    out, err = j_fused_k(jnp.asarray(pp.numpy()), jnp.asarray(rhs.numpy()), 1.0 / nx,
                         1.0 / ny, OMEGA, k, block_rows=8, interpret=True)
    return np.asarray(out), np.asarray(err)


@pytest.mark.parametrize("t", [4, 8])
@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("shape,tile", [((64, 96), (24, 40)), ((40, 96), (13, 19))])
def test_tiled_schedule_matches_pallas(shape, tile, k, t):
    """On the shapes the Pallas kernel takes (ny a multiple of 8), at
    tests/test_torch_kernels.py's tolerance (1e-6 of max(1, max|ref|))."""
    ny, nx = shape
    pp, rhs = inputs(ny * 1000 + nx + k, shape)
    got, err = tiled_sweeps(pp, rhs, 1.0 / nx, 1.0 / ny, k, t, tile)
    ref, ref_err = pallas(shape, k, ny * 1000 + nx + k)
    for a, b in ((got, ref), (err, ref_err)):
        atol = 1e-6 * max(1.0, float(np.max(np.abs(b))))
        np.testing.assert_allclose(a.numpy(), b, rtol=0, atol=atol)


@pytest.mark.parametrize("ny,nx,fits", [
    (132, 400, True),       # the JS twin's scene
    (264, 800, True),       # the default scene
    (231, 700, True),
    (320, 800, True),       # 20 rows a slab at 16 CTAs: the buffers' most at 800
    (321, 800, False),      # a row more needs strips of 6 rows: past the capacity
    (256, 1024, True),
    (257, 1024, False),
    (16, kcl.MAX_COLS + 1, False),
    (512, 1024, False),
    (3, 3, True),
])
def test_rounds_cluster_rule(ny, nx, fits):
    """The rounds kernel takes its cluster form where kernels.cluster's
    plan holds the grid (the batched kernels' plan)."""
    assert kcl.cluster_fits(ny, nx) is fits


@pytest.mark.parametrize("ny,nx,plan", [
    (264, 800, (4, 20)),    # five row groups of 4 rows: slabs of 20, 14 CTAs
    (132, 400, (1, 10)),    # ten row groups of one row
    (231, 700, (3, 15)),
    (320, 800, (4, 20)),
    (321, 800, None),
    (256, 1024, (4, 16)),   # the buffers just inside the shared memory
    (257, 1024, None),
])
def test_rounds_cluster_plan(ny, nx, plan):
    """(rows a thread, rows a slab) of the rounds kernel's cluster on a
    card that admits a cluster of every size: kernels.cluster's pick for
    one scene, with ar * rhs in shared memory."""
    c = kcl.cluster_ctas(1, ny, nx, {k: 1 for k in kcl.CTAS})
    got = None if c is None else kcl.slab_plan(ny, nx, c)
    assert got is None or got[2]
    assert (got and got[:2]) == plan
