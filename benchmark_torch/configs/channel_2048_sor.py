"""The plain reference of channel_2048_sor.json: one PISO step of the
channel flow with a red/black SOR pressure solve, in plain PyTorch, the
reference of the cells of that configuration (manifest.py
``reference``).

It is the channel reference's step (reference.py: the upstream app's
``piso_step`` in Rust semantics, first-order upwind faces, the channel's
p' and velocity BCs, up to ``outer_rounds`` outer corrector rounds, the
CFL control) with the solve of the upstream JS app's second pressure
solver (index.html:741-774), successive over-relaxation, in the
red/black ordering:

- an iteration updates the red half of the interior cells (row + column
  even), then the black half (row + column odd), which reads the red
  half's new values; each cell takes
  ``(1 - omega) c + omega ((E + W) / dx^2 + (N + S) / dy^2 - rhs) / (2 / dx^2 + 2 / dy^2)``
  from its four neighbours E, W, N, S as they stand at its half;
- the channel's p' BCs after every iteration (Neumann bottom, top and
  left, 0 at the outlet column; rows first);
- exactly ``jacobi_iters`` iterations when ``jacobi_tol`` is 0, else a
  do-while that stops after the first iteration whose largest change
  is below it; the last iteration's largest |change| over the interior
  cells is the solve's error (what the outer rounds test).

:func:`plain_setup` refuses any solver but red/black SOR and any flow
but the Rust, first-order, uniform-inlet channel. It imports nothing of
the program, and no JAX.

Departure from the upstream solve, the configuration's (``assumed``):
the JS app sweeps lexicographically, each cell reading its west and
south neighbours' new values; red/black is the ordering that runs in
parallel, and gives another p' after a fixed number of iterations.
"""
from __future__ import annotations

import torch

from benchmark_torch import reference as channel

FIELDS = channel.FIELDS
gaps = channel.gaps

# The flow this reference steps, as the configuration (with its
# traffic's parameter overrides) states it.
FLOW = {"semantics": "rust", "flow_case": "channel", "velocity_scheme": "first",
        "inlet_profile": "uniform"}

# The reference's names for the solver constants the traffic file states.
SOLVER = {"sor_omega": "sor_omega", "tol": "jacobi_tol", "iters": "jacobi_iters",
          "outer_rounds": "outer_corrector_rounds", "outer_tol": "outer_corrector_tol",
          "ramp_up_steps": "ramp_up_steps", "cfl": "cfl", "dt_growth_cap": "dt_growth_cap"}


def plain_setup(config: dict, traffic: dict) -> dict:
    """What :class:`Stepper` needs of a cell's files; raises for another
    flow, or a pressure solver other than red/black SOR."""
    stated = {**config["params"], **traffic.get("params", {}),
              "semantics": config["semantics"]}
    other = {k: stated.get(k) for k in FLOW if stated.get(k) != FLOW[k]}
    if other:
        raise ValueError(f"the red/black SOR reference steps {FLOW}; configuration "
                         f"{config.get('name')!r} states {other}")
    opts = traffic["solver"]["options"]
    if (traffic["solver"]["pressure_solver"] != "sor"
            or opts.get("sor_ordering") != "redblack"):
        raise ValueError(f"the reference has a red/black SOR solve only; the traffic "
                         f"states {traffic['solver']['pressure_solver']}, ordering "
                         f"{opts.get('sor_ordering')!r}")
    solver = {k: opts[v] for k, v in SOLVER.items()}
    solver["pressure"] = "sor"
    return {"grid": config["grid"], "solver": solver}


def red_black_sor(pp, rhs, dx, dy, omega, tol, iters, bcs=channel.pprime_bcs):
    """Red/black SOR from ``pp`` (module docstring). Returns (p', the
    last iteration's largest interior |change|, iterations run)."""
    ny, nx = pp.shape
    rows = torch.arange(1, ny - 1, device=pp.device)[:, None]
    cols = torch.arange(1, nx - 1, device=pp.device)[None, :]
    red = (rows + cols) % 2 == 0
    inv_dx2, inv_dy2 = 1.0 / (dx * dx), 1.0 / (dy * dy)
    diag = 2.0 * inv_dx2 + 2.0 * inv_dy2
    r = rhs[1:-1, 1:-1]
    n = 0
    while True:
        before = pp[1:-1, 1:-1]
        for colour in (red, ~red):
            c = pp[1:-1, 1:-1]
            gs = ((pp[1:-1, 2:] + pp[1:-1, :-2]) * inv_dx2
                  + (pp[2:, 1:-1] + pp[:-2, 1:-1]) * inv_dy2 - r) / diag
            pp = pp.clone()
            pp[1:-1, 1:-1] = torch.where(colour, (1.0 - omega) * c + omega * gs, c)
        err = torch.amax(torch.abs(pp[1:-1, 1:-1] - before))
        pp = bcs(pp)
        n += 1
        if n >= max(iters, 1) or (tol > 0 and not bool(err >= tol)):
            return pp, err, n


class Stepper(channel.Stepper):
    """reference.py's Stepper with the red/black SOR solve."""

    def __init__(self, setup: dict, device, dtype=torch.float64):
        # No matrix product runs in this step; any that a later change
        # adds runs in full float32, not TF32, on the card.
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        super().__init__(setup, device, dtype)

    def _solve(self, pp, rhs):
        s = self.solver
        pp, err, _ = red_black_sor(pp, rhs, self.dx, self.dy, s["sor_omega"], s["tol"],
                                   s["iters"], self.pprime_bcs)
        return pp, err
