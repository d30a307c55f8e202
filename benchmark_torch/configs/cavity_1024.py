"""The plain reference of cavity_1024.json: one PISO step of the
lid-driven cavity in plain PyTorch, the reference of the cells of that
configuration (manifest.py ``reference``).

It is the channel reference's step (reference.py: the upstream app's
``piso_step`` in Rust semantics, first-order upwind faces, the damped
Jacobi solve exiting at the exact sweep, up to ``outer_rounds`` outer
corrector rounds exiting at the exact round, the CFL control) with the
closed box's boundary conditions in place of the channel's:

- velocity: the lid on u's top row (j = ny - 1) at the ramped lid speed,
  u = 0 on the floor (row 0) and on the side walls (faces 0 and nx,
  winning at the lid's corners), v = 0 on row 0 and on the side columns
  (0 and nx - 1); the top face row j = ny is identically zero and not
  stored, as in the channel;
- p': Neumann on every side (rows first, then column 0 from column 1,
  then column nx - 1 from column nx - 2), then cell (0, 0) pinned to 0,
  after every sweep.

It takes the Jacobi solve and the outer rounds only: :func:`plain_setup`
refuses any other pressure solver (reference.py's exact solve has the
channel's Dirichlet outlet). It imports nothing of the program, and no
JAX.

Departures from the published case (Ghia, Ghia and Shin 1982, J.
Comput. Phys. 48:387-411, Re = 1000), all the program's own and so the
reference's: first-order upwinding of the convection, where Ghia
discretise to second order; an explicit step of dt from rest with the
lid ramped over ``ramp_up_steps`` steps, where Ghia solve the steady
equations (the cell's window is the start-up, far from their steady
profiles); the pressure correction's gauge fixed by pinning cell (0, 0)
to 0, where the pure-Neumann problem leaves a constant free; and an
inexact projection (the Jacobi sweeps and rounds capped, as the app
caps them).
"""
from __future__ import annotations

import torch

from benchmark_torch import reference as channel

FIELDS = channel.FIELDS
gaps = channel.gaps

# The flow this reference steps, as the configuration (with its
# traffic's parameter overrides) states it.
FLOW = {"semantics": "rust", "flow_case": "cavity", "velocity_scheme": "first",
        "inlet_profile": "uniform"}


def plain_setup(config: dict, traffic: dict) -> dict:
    """reference.py's set-up for the cavity's flow; raises for another
    flow or a pressure solver other than Jacobi."""
    setup = channel.plain_setup(config, traffic, FLOW)
    if setup["solver"]["pressure"] != "jacobi":
        raise ValueError(f"the cavity reference has a Jacobi solve only; the traffic "
                         f"states {traffic['solver']['pressure_solver']}")
    return setup


def pprime_bcs(pp):
    """Neumann on every side, rows first, then the bottom-left cell 0."""
    pp = pp.clone()
    pp[0, :] = pp[1, :]
    pp[-1, :] = pp[-2, :]
    pp[:, 0] = pp[:, 1]
    pp[:, -1] = pp[:, -2]
    pp[0, 0] = 0.0
    return pp


class Stepper(channel.Stepper):
    """reference.py's Stepper with the cavity's p' and velocity BCs."""

    pprime_bcs = staticmethod(pprime_bcs)

    def __init__(self, setup: dict, device, dtype=torch.float64):
        # No matrix product runs in this step; any that a later change
        # adds runs in full float32, not TF32, on the card.
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        super().__init__(setup, device, dtype)

    def velocity_bcs(self, u, v, lid):
        """The lid at the ramped speed ``lid`` on u's top row, then the
        floor and the side walls (module docstring)."""
        u, v = u.clone(), v.clone()
        u[-1, :] = lid
        u[0, :] = 0.0
        v[0, :] = 0.0
        u[:, 0] = 0.0
        u[:, -1] = 0.0
        v[:, 0] = 0.0
        v[:, -1] = 0.0
        return u, v
