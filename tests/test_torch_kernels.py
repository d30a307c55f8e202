"""Each kernel module of the port against the Pallas kernel it replaces.

On the CPU every wrapper runs its plain version, which is held here
against the Pallas kernel in interpret mode, as the JAX package's own
tests run it. The CUDA kernels themselves are held against the plain
versions by tests/test_torch_cuda.py (marked ``cuda``) and by
chip_smoke.py.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cfd_demo_tpu import make_scene as j_make_scene
from cfd_demo_tpu.core import config as jcfg
from cfd_demo_tpu.kernels.jacobi_pallas import jacobi_fused_k as j_fused_k
from cfd_demo_tpu.kernels.jacobi_pallas import jacobi_pallas as j_chain
from cfd_demo_tpu.kernels.rounds_pallas import solve_correct_rounds_pallas
from cfd_demo_tpu.kernels.substep_pallas import (correct_bc_pallas,
                                                 predict_div_pallas)
from cfd_demo_tpu.ops.poisson import _apply_pprime_bcs as j_pp_bcs

from cfd_demo_tpu_torch import make_scene
from cfd_demo_tpu_torch.core import config as tcfg
from cfd_demo_tpu_torch.kernels import jacobi as tjac
from cfd_demo_tpu_torch.kernels import rounds as trounds
from cfd_demo_tpu_torch.kernels import substep as tsub

torch.set_num_threads(1)

DT, NU, INLET = 0.003, 1e-4, 1.0
GRID_ARGS = dict(nx=96, ny=64, lx=3.0, ly=2.0)  # tests/test_substep_pallas.py:24
JG = jcfg.Grid(**GRID_ARGS, obstacles=(jcfg.Cylinder(0.8, 1.0, 0.3),))
TG = tcfg.Grid(**GRID_ARGS, obstacles=(tcfg.Cylinder(0.8, 1.0, 0.3),))
RUST_J, RUST_T = jcfg.Semantics.RUST, tcfg.Semantics.RUST
FIRST_J, FIRST_T = jcfg.VelocityScheme.FIRST, tcfg.VelocityScheme.FIRST


def fields(seed, grid, scale=1.0):
    rng = np.random.default_rng(seed)
    ny, nx = grid.ny, grid.nx
    mk = lambda shape: (scale * rng.standard_normal(shape)).astype(np.float32)
    return mk((ny, nx + 1)), mk((ny, nx)), mk((ny, nx)), mk((ny, nx))


def T(a, device="cpu"):
    return torch.from_numpy(np.array(a)).to(device)


def assert_close(ref, got, scale_rtol=1e-6):
    ref = np.asarray(ref)
    got = got.cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    atol = scale_rtol * max(1.0, float(np.max(np.abs(ref))))
    np.testing.assert_allclose(got, ref, rtol=0, atol=atol)


def pp_rhs(seed, shape):
    """BC-consistent p' (what the folded kernels require,
    tests/test_jacobi_kernel_interpret.py:17-26) and a random rhs."""
    rng = np.random.default_rng(seed)
    pp = np.asarray(j_pp_bcs(jnp.asarray(
        (0.1 * rng.standard_normal(shape)).astype(np.float32))))
    return pp, rng.standard_normal(shape).astype(np.float32)


# ---------------------------------------------------------------------------
# Plain versions against the Pallas kernels in interpret mode (CPU)
# ---------------------------------------------------------------------------

def test_predict_div_plain_matches_pallas():
    u, v, _, _ = fields(0, JG)
    ref = predict_div_pallas(jnp.asarray(u), jnp.asarray(v), DT, NU, JG,
                             FIRST_J, RUST_J, block_rows=16, interpret=True)
    got = tsub.predict_div(T(u), T(v), DT, NU, TG, FIRST_T, RUST_T)
    for r, g in zip(ref, got):
        assert_close(r, g)


@pytest.mark.parametrize("scalars_as_tensors", [False, True])
def test_correct_bc_plain_matches_pallas(scalars_as_tensors):
    u, v, p, pp = fields(1, JG)
    ue, ve, _, _ = fields(2, JG)
    ref = correct_bc_pallas(
        jnp.asarray(u), jnp.asarray(v), jnp.asarray(p), jnp.asarray(pp),
        jnp.asarray(ue), jnp.asarray(ve), DT, INLET, JG,
        jcfg.InletProfile.UNIFORM, jcfg.FlowCase.CHANNEL, RUST_J,
        block_rows=16, interpret=True)
    dt, inlet = ((torch.tensor(DT), torch.tensor(INLET)) if scalars_as_tensors
                 else (DT, INLET))
    got = tsub.correct_bc(T(u), T(v), T(p), T(pp), T(ue), T(ve), dt, inlet,
                          TG, tcfg.InletProfile.UNIFORM, tcfg.FlowCase.CHANNEL,
                          RUST_T)
    for r, g in zip(ref, got):
        assert_close(r, g)


@pytest.mark.parametrize("shape,k", [((64, 96), 5), ((40, 96), 3), ((24, 40), 1)])
def test_jacobi_fused_k_plain_matches_pallas(shape, k):
    ny, nx = shape
    dx, dy = 1.0 / nx, 1.0 / ny
    pp, rhs = pp_rhs(3, shape)
    ref, ref_err = j_fused_k(jnp.asarray(pp), jnp.asarray(rhs), dx, dy, 0.75,
                             k, block_rows=8, interpret=True)
    got, err = tjac.jacobi_fused_k(T(pp), T(rhs), dx, dy, 0.75, k)
    assert_close(ref, got)
    assert_close(ref_err, err)


@pytest.mark.parametrize("tol,iters,k", [
    (0.0, 10, 4),    # two launches of 4 and a remainder launch of 2
    (0.0, 8, 4),     # no remainder
    (2e-2, 40, 4),   # K-granularity early exit, then the remainder
    (0.0, 3, 4),     # remainder launch only
])
def test_jacobi_chain_matches_pallas(tol, iters, k):
    shape = (40, 56)
    ny, nx = shape
    dx, dy = 1.0 / nx, 1.0 / ny
    pp, rhs = pp_rhs(4, shape)
    ref = j_chain(jnp.asarray(pp), jnp.asarray(rhs), dx, dy, 0.75, tol, iters,
                  k=k, block_rows=8, interpret=True)
    got = tjac.jacobi_chain(T(pp), T(rhs), dx, dy, 0.75, tol, iters, k=k)
    assert_close(ref[0], got[0])
    assert_close(ref[1], got[1])
    assert int(ref[2]) == int(got[2])
    if tol > 0:
        assert int(got[2]) < iters - iters % k  # the early exit fired


def _rounds_case(seed):
    """tests/test_ensemble_pallas.py:99-146, Rust semantics."""
    args = dict(nx=40, ny=24, lx=3.0, ly=1.5)
    jg = jcfg.Grid(**args, obstacles=(jcfg.Cylinder(0.9, 0.75, 0.3),))
    tg = tcfg.Grid(**args, obstacles=(tcfg.Cylinder(0.9, 0.75, 0.3),))
    jscene = j_make_scene(jg, jcfg.SimulationParams(dt=0.002, viscosity=1e-4),
                          jcfg.solver_options_for(RUST_J))
    tscene = make_scene(tg, tcfg.SimulationParams(dt=0.002, viscosity=1e-4),
                        tcfg.solver_options_for(RUST_T))
    rng = np.random.default_rng(seed)
    mk = lambda shp, s: (s * rng.standard_normal(shp)).astype(np.float32)
    us, vs = mk((24, 41), 0.1), mk((24, 40), 0.1)
    p = mk((24, 40), 0.05)
    pp0 = np.zeros((24, 40), np.float32)
    rhs = mk((24, 40), 1.0)
    return jscene, tscene, (us, vs, p, pp0, rhs)


def test_rounds_plain_matches_pallas():
    jscene, tscene, arrays = _rounds_case(2)
    ref = solve_correct_rounds_pallas(*map(jnp.asarray, arrays), 0.002, 1.0,
                                      jscene, interpret=True)
    got = trounds.solve_correct_rounds(*map(T, arrays), 0.002, 1.0, tscene)
    for name, r, g in zip(("u", "v", "p", "pp", "err"), ref, got):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-4,
                                   atol=5e-5, err_msg=name)
    # The reported exits: each of the 1 + rounds solves runs 1..iters sweeps.
    rounds, sweeps = got[5].tolist()
    opts = tscene.opts
    assert got[5].dtype == torch.int32
    assert 0 < rounds <= opts.outer_corrector_rounds
    assert rounds + 1 <= sweeps <= (rounds + 1) * opts.jacobi_iters


def test_wrappers_validate_inputs():
    u, v, _, _ = fields(5, TG)
    with pytest.raises(ValueError, match="shape"):
        tsub.predict_div(T(u)[:, :-1], T(v), DT, NU, TG, FIRST_T, RUST_T)
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        tsub.predict_div(T(u).double(), T(v).double(), DT, NU, TG, FIRST_T,
                         RUST_T)
    with pytest.raises(ValueError, match="contiguous"):
        tsub.predict_div(T(u).t().contiguous().t(), T(v), DT, NU, TG, FIRST_T,
                         RUST_T)
    box = dataclasses.replace(TG, obstacles=(tcfg.Box(1.0, 0.75, 0.2, 0.2),))
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):  # Box masks
        tsub.predict_div(T(u), T(v), DT, NU, box,
                         tcfg.VelocityScheme.SECOND, RUST_T)
    before = tsub.predict_div.launches
    tsub.predict_div(T(u), T(v), DT, NU, TG, FIRST_T, RUST_T)
    assert tsub.predict_div.launches == before  # the plain path launches nothing
