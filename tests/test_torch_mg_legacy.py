"""The port's legacy MG_PRODUCTION solve (mgp_scheme "legacy": the JS
kit's vertex hierarchy with damped p'-BC sweeps) against cfd_demo_tpu on
the CPU, inputs made with numpy from a seed.

The solve runs to its tolerance or the f32 noise floor, where two
faithful f32 solves differ in their smoothest modes
(tests/test_torch_mgp.py explains): it is compared with JAX run op by
op, with the same cycle count, p' within the golden L2 and 2e-4 of its
rms, the exit residual to 1e-4; against the whole-cycle Pallas kernels
(interpret mode) at the bounds of tests/test_mg_pallas.py:142-167.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cfd_demo_tpu.core import config as jcfg
from cfd_demo_tpu.kernels import mg_pallas as JM
from cfd_demo_tpu.ops import poisson as JP

import cfd_demo_tpu_torch as tc
from cfd_demo_tpu_torch.ops import poisson as TP

from conftest import l2

torch.set_num_threads(1)


def T(a):
    return torch.from_numpy(np.array(a))


def _jopts(**kw):
    return jcfg.solver_options_for(jcfg.Semantics.RUST, **kw)


def _topts(**kw):
    return tc.solver_options_for(tc.Semantics.RUST, **kw)


@pytest.mark.parametrize("tol_r,kw", [
    (0.3, {}),                                       # the exact do-while
    (0.3, dict(early_exit=False, mgp_max_cycles=8)),  # the masked fixed-trip loop
    (0.0, dict(mgp_rtol=0.01)),                      # the relative exit
    (0.0, dict(mgp_floor=2e4)),                      # the noise floor decides
])
def test_legacy_multigrid_production_matches_jax(tol_r, kw):
    """17x25 coarsens through odd levels (9x13, 5x7, 3x4). Each exit
    fires within a few cycles, above the f32 noise floor (the floor case
    widens it 5000-fold); the JAX side runs op by op, as
    tests/test_torch_mgp.py explains."""
    ny, nx = 17, 25
    dx, dy = 1 / nx, 1 / ny
    rng = np.random.default_rng(8)
    rhs = np.zeros((ny, nx), np.float32)
    rhs[1:-1, 1:-1] = rng.standard_normal((ny - 2, nx - 2))
    pp0 = TP._apply_pprime_bcs(T(0.01 * rng.standard_normal((ny, nx)).astype(np.float32)))
    with jax.disable_jit():
        jp, je, jn = JP.multigrid_production(jnp.asarray(pp0.numpy()), jnp.asarray(rhs),
                                             dx, dy, _jopts(mgp_scheme="legacy", **kw),
                                             tol_r)
    tp, te, tn = TP.multigrid_production(pp0, T(rhs), dx, dy,
                                         _topts(mgp_scheme="legacy", **kw), tol_r)
    jp, tp = np.asarray(jp), tp.numpy()
    assert int(tn) == int(jn)
    assert 1 < int(tn) < _topts(**kw).mgp_max_cycles  # the exit fired
    rms = float(np.sqrt(np.mean(jp.astype(np.float64) ** 2)))
    assert l2(tp, jp) <= 1e-5 * max(1.0, rms)
    assert l2(tp, jp) <= 2e-4 * rms
    assert np.isclose(float(te), float(je), rtol=1e-4)


def test_legacy_fixed_cycles_run_the_aligned_cycle(monkeypatch):
    """mgp_fixed_cycles > 0 runs the aligned cycle whatever mgp_scheme
    says (JAX ops/poisson.py:1299-1305)."""
    rng = np.random.default_rng(11)
    rhs = T(rng.standard_normal((24, 40)).astype(np.float32))
    args = (torch.zeros(24, 40), rhs, 1 / 40, 1 / 24)
    called = []
    monkeypatch.setattr(TP, "_mgp_vcycle", lambda *a: called.append(a))
    legacy = TP.multigrid_production(*args, _topts(mgp_scheme="legacy",
                                                   mgp_fixed_cycles=2), 0.0)
    aligned = TP.multigrid_production(*args, _topts(mgp_scheme="aligned",
                                                    mgp_fixed_cycles=2), 0.0)
    assert not called and int(legacy[2]) == 2
    assert torch.equal(legacy[0], aligned[0]) and float(legacy[1]) == float(aligned[1])


def test_legacy_matches_multigrid_production_pallas():
    """tests/test_mg_pallas.py:142-167's case: the whole-cycle Pallas
    kernels in interpret mode, the same cycle count; the JAX side jitted
    (its masked loop), held to that test's bounds."""
    ny, nx = 32, 96
    dx, dy = 1 / nx, 1 / ny
    rng = np.random.default_rng(4)
    rhs = rng.standard_normal((ny, nx)).astype(np.float32)
    pp0 = (0.1 * rng.standard_normal((ny, nx))).astype(np.float32)
    ref, err_ref, n_ref = jax.jit(lambda p, r: JM.multigrid_production_pallas(
        p, r, dx, dy, _jopts(mgp_scheme="legacy"), 30.0, interpret=True))(pp0, rhs)
    got, err_got, n_got = TP.multigrid_production(T(pp0), T(rhs), dx, dy,
                                                  _topts(mgp_scheme="legacy"), 30.0)
    assert int(n_got) == int(n_ref) < 30
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=1e-5)
    assert np.isclose(float(err_got), float(err_ref), rtol=1e-3, atol=1e-6)


def test_mgp_scheme_values():
    """"auto" means aligned at every size; an unknown scheme raises."""
    rhs = T(np.random.default_rng(9).standard_normal((24, 32)).astype(np.float32))
    args = (torch.zeros(24, 32), rhs, 1 / 32, 1 / 24)
    auto = TP.multigrid_production(*args, _topts(mgp_coarse_stop=8), 1.0)
    aligned = TP.multigrid_production(*args, _topts(mgp_coarse_stop=8,
                                                    mgp_scheme="aligned"), 1.0)
    assert torch.equal(auto[0], aligned[0])
    with pytest.raises(ValueError, match="mgp_scheme"):
        TP.multigrid_production(*args, _topts(mgp_scheme="vertex"), 1.0)
