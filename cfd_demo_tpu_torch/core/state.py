"""Simulation state as a dataclass of tensors (↔ cfd_demo_tpu/core/state.py).

Every field, scalars included, lives on the scene's device: the step
never reads a value back to the host. Field layout (rows=y, cols=x):

  u: (ny, nx+1)   horizontal velocity on vertical faces
  v: (ny, nx)     vertical velocity on horizontal faces j=0..ny-1; the
      reference's top face row j=ny is identically zero and stored
      implicitly (Grid.shape_v, State.v_full)
  p, p_prime: (ny, nx) pressure and its warm-started correction

A batch of B independent scenes (the ensemble) is one State whose fields
carry a leading batch dimension, (B, ny, nx+1) and (B, ny, nx), and
whose scalars are (B,) tensors: the JAX package's vmapped State, field
for field (:func:`batch_state`, :func:`state_from_numpy`).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from .config import Grid, Semantics, SimulationParams, SolverOptions
from .unported import BOX_FLOAT64, unported

_FIELDS = ("u", "v", "p", "p_prime", "u_prev", "v_prev", "dt", "dt_user",
           "nu", "target_inlet", "t", "step", "substeps", "res_u", "res_v",
           "res_p")


@dataclasses.dataclass
class State:
    u: torch.Tensor
    v: torch.Tensor
    p: torch.Tensor
    p_prime: torch.Tensor
    u_prev: Optional[torch.Tensor]  # JS only: the last step's entry u (extrapolation)
    v_prev: Optional[torch.Tensor]
    # runtime scalars (hot-swappable), 0-d tensors
    dt: torch.Tensor
    dt_user: torch.Tensor
    nu: torch.Tensor
    target_inlet: torch.Tensor
    # bookkeeping, 0-d tensors
    t: torch.Tensor
    step: torch.Tensor      # int32
    substeps: torch.Tensor  # int32
    res_u: torch.Tensor
    res_v: torch.Tensor
    res_p: torch.Tensor

    @property
    def fields(self):
        return self.u, self.v, self.p

    @property
    def v_full(self) -> torch.Tensor:
        """v in the reference's (ny+1, nx) shape (explicit zero top row)."""
        return torch.cat([self.v, self.v.new_zeros((1, self.v.shape[-1]))])


def init_state(grid: Grid, params: SimulationParams, opts: SolverOptions,
               device="cuda", dtype=torch.float32) -> State:
    """Zero-initialized state (model.rs:219-299, index.html:218-258), on
    the card unless ``device`` says otherwise (``device="cpu"`` for the
    CPU path). JS semantics carries u_prev and v_prev (zeros)."""
    if dtype != torch.float32:
        raise unported(f"dtype {dtype}", BOX_FLOAT64)
    js = opts.semantics == Semantics.JS
    f = lambda x: torch.tensor(x, dtype=dtype, device=device)
    zu = lambda: torch.zeros((grid.ny, grid.nx + 1), dtype=dtype, device=device)
    zp = lambda: torch.zeros((grid.ny, grid.nx), dtype=dtype, device=device)
    return State(
        u=zu(), v=zp(), p=zp(), p_prime=zp(),
        u_prev=zu() if js else None, v_prev=zp() if js else None,
        dt=f(params.dt), dt_user=f(params.dt), nu=f(params.viscosity),
        target_inlet=f(params.target_inlet_velocity),
        t=f(0.0),
        step=torch.tensor(0, dtype=torch.int32, device=device),
        substeps=torch.tensor(opts.substeps_init, dtype=torch.int32,
                              device=device),
        res_u=f(0.0), res_v=f(0.0), res_p=f(0.0),
    )


def set_params(state: State, params: SimulationParams) -> State:
    """Hot-swap runtime scalars (model.rs:1250-1257)."""
    f = lambda x, like: torch.tensor(x, dtype=like.dtype, device=like.device)
    return dataclasses.replace(
        state, dt=f(params.dt, state.dt), dt_user=f(params.dt, state.dt),
        nu=f(params.viscosity, state.nu),
        target_inlet=f(params.target_inlet_velocity, state.target_inlet))


def batch_state(state: State, batch: int, **per_scene) -> State:
    """B copies of a one-scene ``state`` as one batched State, as the JAX
    ensemble app broadcasts its state (apps/ensemble.py:44-48); keyword
    arguments replace whole fields, e.g. ``nu=`` a (B,) tensor of
    viscosities."""
    out = {}
    for k in _FIELDS:
        x = getattr(state, k)
        out[k] = None if x is None else x.expand((batch,) + x.shape).clone()
    for k, x in per_scene.items():
        if k not in out:
            raise TypeError(f"batch_state: State has no field {k!r}")
        if tuple(x.shape[:1]) != (batch,):
            raise ValueError(f"batch_state: {k} has shape {tuple(x.shape)}, "
                             f"expected a leading {batch}")
        out[k] = x.to(getattr(state, k).device).contiguous()
    return State(**out)


def state_from_numpy(d: Dict[str, Optional[np.ndarray]], device) -> State:
    """Build a State from numpy arrays keyed by field name, e.g.
    ``{f.name: np.asarray(getattr(jax_state, f.name))}`` of a
    ``cfd_demo_tpu`` State (None stays None)."""
    return State(**{k: None if d[k] is None
                    else torch.from_numpy(np.array(d[k])).to(device)
                    for k in _FIELDS})


def state_to_numpy(state: State) -> Dict[str, Optional[np.ndarray]]:
    """The inverse of :func:`state_from_numpy`."""
    return {k: None if getattr(state, k) is None
            else getattr(state, k).detach().cpu().numpy() for k in _FIELDS}
