"""Kernel 5, the fused corrector + next-round divergence (``correct_div``),
and the ``rounds_impl="pallas"`` route that runs it, against cfd_demo_tpu
on the CPU.

On CPU tensors ``correct_div`` runs its plain version (ops.corrector
``correct`` then ops.divergence ``divergence_rhs``), held here against
``correct_div_pallas`` in interpret mode at the shapes of
tests/test_substep_pallas.py:187-193, to 1e-6 x max(1, max|ref|), that
test's bound. The CUDA kernel is held against the plain version by
tests/test_torch_cuda.py (marked ``cuda``) and chip_smoke.py.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import cfd_demo_tpu as jc
from cfd_demo_tpu.core import config as jcfg
from cfd_demo_tpu.kernels.substep_pallas import correct_div_pallas

import cfd_demo_tpu_torch as tc
from cfd_demo_tpu_torch.core import config as tcfg
from cfd_demo_tpu_torch.kernels import substep as tsub
from cfd_demo_tpu_torch.solver import piso as tpiso

from conftest import l2

torch.set_num_threads(1)

DT = 0.003


def fields(seed, ny, nx):
    rng = np.random.default_rng(seed)
    mk = lambda shape: rng.standard_normal(shape).astype(np.float32)
    return mk((ny, nx + 1)), mk((ny, nx)), mk((ny, nx)), mk((ny, nx))


def assert_close(ref, got, scale_rtol=1e-6):
    ref = np.asarray(ref)
    atol = scale_rtol * max(1.0, float(np.max(np.abs(ref))))
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=atol)


@pytest.mark.parametrize("nx,ny,block_rows", [
    (96, 64, 16),    # unaligned width, multi-window
    (96, 64, 256),   # unaligned, single block
    (128, 64, 16),   # lane-aligned width
    (100, 88, 24),   # odd width, non-dyadic rows
])
def test_correct_div_plain_matches_pallas(nx, ny, block_rows):
    jg = jcfg.Grid(nx=nx, ny=ny, lx=3.0, ly=2.0, obstacles=(jcfg.Cylinder(0.8, 1.0, 0.3),))
    tg = tcfg.Grid(nx=nx, ny=ny, lx=3.0, ly=2.0, obstacles=(tcfg.Cylinder(0.8, 1.0, 0.3),))
    arrays = fields(nx + ny, ny, nx)
    ref = correct_div_pallas(*map(jnp.asarray, arrays), DT, jg,
                             block_rows=block_rows, interpret=True)
    before = tsub.correct_div.launches
    got = tsub.correct_div(*map(torch.from_numpy, arrays), DT, tg)
    assert tsub.correct_div.launches == before  # the plain path launches nothing
    for name, r, g in zip(("u", "v", "p", "rhs"), ref, got):
        assert g.shape == np.asarray(r).shape, name
        assert_close(r, g)


def test_correct_div_validates_inputs():
    tg = tcfg.Grid(nx=24, ny=16, lx=3.0, ly=2.0)
    u, v, p, pp = map(torch.from_numpy, fields(0, 16, 24))
    with pytest.raises(ValueError, match="shape"):
        tsub.correct_div(u[:, :-1], v, p, pp, DT, tg)
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        tsub.correct_div(u.double(), v.double(), p.double(), pp.double(), DT, tg)


def _reference_scenes(m, rounds_impl, n=48):
    """bench.py --mode reference (cells.reference_mode_scene) on a small
    grid, the fused route forced (it is chosen by size at 2048^2)."""
    grid = m.Grid(nx=n, ny=n, lx=30.0, ly=30.0, obstacles=(m.Cylinder(7.5, 15.0, 3.0),))
    opts = m.solver_options_for(m.Semantics.RUST, ramp_up_steps=10,
                                rounds_impl=rounds_impl, substep_impl="pallas")
    return m.make_scene(grid, m.SimulationParams(dt=0.002, viscosity=1e-4), opts)


def test_rounds_impl_pallas_equals_the_unfused_route(monkeypatch):
    """``rounds_impl="pallas"`` runs each outer round as the solve plus
    one correct_div, whose divergence feeds the next solve: the same
    arithmetic as the plain corrector and ``_outer_rounds`` (JAX
    piso.py:725-756), so the two routes agree bit for bit; and both at
    the golden bound of the JAX package's own route."""
    calls = []
    real = tpiso.correct_div
    monkeypatch.setattr(tpiso, "correct_div",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    runs = {}
    for impl in ("pallas", "jnp"):
        scene = _reference_scenes(tc, impl)
        runs[impl] = tc.make_run(scene, 4)(scene.init_state(device="cpu"))
        if impl == "pallas":
            # 1 + rounds run a substep, the rounds counted as _outer_rounds does.
            assert len(calls) >= 4 * 2
            n_pallas = len(calls)
    assert len(calls) == n_pallas  # the unfused route launches no correct_div
    (sp, dp), (sj, dj) = runs["pallas"], runs["jnp"]
    for f in ("u", "v", "p", "p_prime"):
        np.testing.assert_array_equal(getattr(sp, f).numpy(), getattr(sj, f).numpy(),
                                      err_msg=f)
    for f in ("dt", "res_u", "res_v", "res_p"):
        np.testing.assert_array_equal(getattr(dp, f).numpy(), getattr(dj, f).numpy(),
                                      err_msg=f)
    jscene = _reference_scenes(jc, "pallas")
    js, _ = jc.make_run(jscene, 4, donate=False)(jscene.init_state())
    for f in ("u", "v"):
        assert l2(getattr(sp, f).numpy(), np.asarray(getattr(js, f))) <= 1e-5, f
