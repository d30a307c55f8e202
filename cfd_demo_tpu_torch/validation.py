"""The lid-driven cavity against Ghia, Ghia & Shin (1982) at Re = 100.

Their Table I/II (a 129x129 stream-function solve; tests/test_physics.py
holds the JAX package to it): u along the vertical centre line at
heights ``GHIA_RE100_Y`` and v along the horizontal one at ``GHIA_RE100_X``.
:func:`ghia_scene` is that test's scene (64², first-order upwind, fast
mode: a fixed 50-sweep Jacobi, no outer rounds), which reaches steady
state in 8000 steps; :func:`ghia_deviation` is the largest difference
from the table, interpolated at its points (0.06 is the test's bound).
"""
from __future__ import annotations

import numpy as np

from .core.config import FlowCase, Semantics, SimulationParams, cavity_grid, solver_options_for
from .solver.piso import make_scene

GHIA_RE100_Y = np.array([0.0547, 0.1016, 0.1719, 0.2813, 0.4531, 0.5, 0.6172, 0.7344,
                         0.8516, 0.9531, 0.9766])
GHIA_RE100_U = np.array([-0.03717, -0.06434, -0.10150, -0.15662, -0.21090, -0.20581,
                         -0.13641, 0.00332, 0.23151, 0.68717, 0.84123])
GHIA_RE100_X = np.array([0.0625, 0.0938, 0.1563, 0.2344, 0.5, 0.8047, 0.8594, 0.9063,
                         0.9531, 0.9688])
GHIA_RE100_V = np.array([0.09233, 0.12317, 0.16077, 0.17527, 0.05454, -0.24533,
                         -0.22445, -0.16914, -0.08864, -0.05906])
GHIA_STEPS = 8000


def ghia_scene(n: int = 64):
    """The Re = 100 cavity of tests/test_physics.py:134-170 (lid 1, nu 0.01
    on a unit box)."""
    return make_scene(cavity_grid(n), SimulationParams(
        dt=3e-3, viscosity=0.01, target_inlet_velocity=1.0, flow_case=FlowCase.CAVITY),
        solver_options_for(Semantics.RUST, ramp_up_steps=100, jacobi_tol=0.0,
                           jacobi_iters=50, outer_corrector_rounds=0, early_exit=False))


def ghia_deviation(state) -> tuple:
    """(max |u - Ghia| on the vertical centre line, max |v - Ghia| on the
    horizontal one) of an n x n cavity state."""
    u, v = state.u.cpu().numpy(), state.v.cpu().numpy()
    n = v.shape[0]
    c = (np.arange(n) + 0.5) / n
    du = np.abs(np.interp(GHIA_RE100_Y, c, u[:, n // 2]) - GHIA_RE100_U).max()
    dv = np.abs(np.interp(GHIA_RE100_X, c, v[n // 2, :]) - GHIA_RE100_V).max()
    return float(du), float(dv)
