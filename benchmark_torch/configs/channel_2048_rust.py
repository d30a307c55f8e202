"""The plain reference of channel_2048_rust.json: one PISO step of the
channel flow on the desktop app's full Rust schedule, with the solve's
exit tested once a chunk of sweeps, in plain PyTorch, the reference of
the cells of that configuration (manifest.py ``reference``).

It is the channel reference's step (reference.py: the upstream app's
``piso_step`` in Rust semantics, first-order upwind faces, the channel's
p' and velocity BCs, up to ``outer_rounds`` outer corrector rounds that
exit at the exact round, the CFL control) with the solve's exit rule
taken from the configuration (``assumed``):

- damped Jacobi sweeps, the channel's p' BCs after each, in chunks of
  ``chunk`` sweeps (the traffic's ``pallas_fuse_k``, 0 meaning 16);
- after each whole chunk the chunk's last sweep's largest interior
  |change| is tested, and the solve stops at the first test below
  ``jacobi_tol`` (no test when ``jacobi_tol`` is 0 or ``early_exit`` is
  false);
- then the ``jacobi_iters % chunk`` remainder always runs; the solve's
  error (what the outer rounds test) is its last sweep's largest
  interior |change|.

So with 50 sweeps at most and chunks of 16 a solve runs 18, 34 or 50
sweeps. model.rs tests after every sweep (reference.py ``jacobi``); the
two differ by up to 15 sweeps wherever a solve meets its tolerance
before the cap.

:func:`plain_setup` refuses any solver but Jacobi and any flow but the
Rust, first-order, uniform-inlet channel. It imports nothing of the
program, and no JAX.
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
SOLVER = {"jacobi_omega": "jacobi_omega", "jacobi_tol": "jacobi_tol",
          "jacobi_iters": "jacobi_iters", "outer_rounds": "outer_corrector_rounds",
          "outer_tol": "outer_corrector_tol", "ramp_up_steps": "ramp_up_steps",
          "cfl": "cfl", "dt_growth_cap": "dt_growth_cap", "early_exit": "early_exit"}

DEFAULT_CHUNK = 16  # pallas_fuse_k 0


def plain_setup(config: dict, traffic: dict) -> dict:
    """What :class:`Stepper` needs of a cell's files; raises for another
    flow, or a pressure solver other than Jacobi."""
    stated = {**config["params"], **traffic.get("params", {}),
              "semantics": config["semantics"]}
    other = {k: stated.get(k) for k in FLOW if stated.get(k) != FLOW[k]}
    if other:
        raise ValueError(f"the chunked-exit Jacobi reference steps {FLOW}; configuration "
                         f"{config.get('name')!r} states {other}")
    if traffic["solver"]["pressure_solver"] != "jacobi":
        raise ValueError(f"the chunked-exit Jacobi reference has a Jacobi solve only; the "
                         f"traffic states {traffic['solver']['pressure_solver']}")
    opts = traffic["solver"]["options"]
    solver = {k: opts[v] for k, v in SOLVER.items()}
    solver.update(pressure="jacobi", chunk=opts.get("pallas_fuse_k") or DEFAULT_CHUNK)
    return {"grid": config["grid"], "solver": solver}


def chunked_jacobi(pp, rhs, dx, dy, omega, tol, iters, chunk, early_exit=True,
                   bcs=channel.pprime_bcs):
    """Damped Jacobi with the chunked exit (module docstring). Returns
    (p', the last sweep's largest interior |change|, sweeps run)."""
    n_full, rem = divmod(iters, chunk)
    err, n = None, 0
    for _ in range(n_full):
        pp, err, _ = channel.jacobi(pp, rhs, dx, dy, omega, 0.0, chunk, bcs)
        n += chunk
        if early_exit and tol > 0 and not bool(err >= tol):
            break
    if rem:
        pp, err, _ = channel.jacobi(pp, rhs, dx, dy, omega, 0.0, rem, bcs)
        n += rem
    return pp, err, n


class Stepper(channel.Stepper):
    """reference.py's Stepper with the chunked-exit Jacobi solve."""

    def __init__(self, setup: dict, device, dtype=torch.float64):
        # No matrix product runs in this step; any that a later change
        # adds runs in full float32, not TF32, on the card.
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        super().__init__(setup, device, dtype)

    def _solve(self, pp, rhs):
        s = self.solver
        pp, err, _ = chunked_jacobi(pp, rhs, self.dx, self.dy, s["jacobi_omega"],
                                    s["jacobi_tol"], s["jacobi_iters"], s["chunk"],
                                    s["early_exit"], self.pprime_bcs)
        return pp, err
