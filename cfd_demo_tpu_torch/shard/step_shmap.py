"""The PISO step on a row mesh, with the shard kernels
(↔ cfd_demo_tpu/shard/step_shmap.py:97-392).

The JAX tier composes the whole step from explicitly sharded pieces
under ``shard_map``; here one Python program drives every shard of a
:class:`~.mesh.RowMesh` (shard/mesh.py), each shard's block on its own
device, and the halo rows move as tensor copies (shard/halo.py). Per
PISO substep (model.rs:529-730):

1. exchange 8-row (u, v) halos;
2. ``predict_div`` (kernel 1) on each shard's extended block, with the
   block's global row offset, so the masks, the BC rows and the schemes'
   near-wall forms land on the right global rows;
3. the solve: Jacobi or red/black SOR, one ``halo8(k)``-row (SOR:
   ``halo8(2k)``) exchange per launch of the shard kernel (kernel 11 or
   14; shard/jacobi_shmap.py, shard/sor_shmap.py), warm-started (Rust)
   or from zero (JS), early-exiting between launches on the max over the
   shards of the residual when early_exit and jacobi_tol > 0; or FDM: the
   rhs gathered on the first shard's device, the port's exact solve
   (ops/fdm.py), its rows sent back;
4a. no outer rounds (the fast tail): an 8-row p' exchange, then
    ``correct_bc`` (kernel 3) on each extended block, its reductions
    over the owned rows;
4b. outer rounds (the reference tail): the shard-local corrector and
    divergence with 1-row (p', v) halos, the Rust outer-round loop on the
    max over the shards of the residual, read on the host once a round,
    then ``apply_bcs`` with the block's global rows;
5. the max over the shards of the residuals and max|vel|;
6. the step's scalar logic (the inlet ramp, JS's extrapolation and
   adaptive substeps, the CFL dt control) of solver/piso.py, on the
   first shard's device.

MULTIGRID and MG_PRODUCTION (JAX shard/mg_shmap.py) are not ported to
this tier yet (ROADMAP.md item 12c), nor CAVITY (item 6b): both raise
before any launch. Every entry point takes a sharded State
(:func:`~.mesh.shard_state`) and returns one.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from ..core.config import PressureSolver, Semantics
from ..core.masks import masks_traced
from ..core.state import State
from ..core.unported import SHARDED, unported
from ..kernels.substep import correct_bc, predict_div
from ..ops.bc import apply_bcs, check_channel
from ..solver.piso import (Scene, StepDiagnostics, _solve_fdm, adapt_substeps,
                           dt_control, ramped_inlet, resolve_fuse_k)
from .. import trace
from .halo import exchange_rows, pmax
from .jacobi_shmap import halo8, jacobi_shard_body
from .mesh import RowMesh, join_rows, split_rows
from .sor_shmap import sor_shard_body

_HALO = 8  # the substep kernels' row halo (kernels 1 and 3 read <= 3 rows)


def sor_k(scene: Scene) -> int:
    """Iterations per SOR shard launch (JAX step_shmap.py:80-94): half
    the Jacobi k, whose halo spans 2k rows; halving a divisor of
    jacobi_iters need not keep it one, so the auto value steps down until
    it divides; an explicit pallas_fuse_k is kept as it is."""
    opts = scene.opts
    iters = opts.jacobi_iters
    k = max(resolve_fuse_k(opts, divide=iters) // 2, 1)
    if not opts.pallas_fuse_k:
        while k > 1 and iters % k != 0:
            k -= 1
    return k


def _check_supported(scene: Scene, mesh: RowMesh):
    """Raise for what the tier does not run, before any launch."""
    opts, g = scene.opts, scene.grid
    S = mesh.size
    solver = scene.params.pressure_solver
    check_channel(scene.params.flow_case, " on the sharded step")
    if solver in (PressureSolver.MULTIGRID, PressureSolver.MG_PRODUCTION):
        raise unported(f"the sharded {solver.value} solve (shard/mg_shmap.py)", SHARDED)
    if solver == PressureSolver.JACOBI:
        k = resolve_fuse_k(opts, divide=opts.jacobi_iters)
        if opts.jacobi_iters % k != 0:
            raise ValueError("step_shmap: jacobi_iters must be a multiple "
                             "of the (resolved) pallas_fuse_k")
        min_loc = max(_HALO, halo8(k))
    elif solver == PressureSolver.SOR:
        if opts.sor_ordering == "lexicographic":
            raise ValueError(
                "step_shmap: lexicographic SOR is sequential along the "
                "sharded axis (its wavefront spans every row); use the "
                "GSPMD tier or sor_ordering='redblack'")
        if opts.jacobi_iters % sor_k(scene) != 0:
            raise ValueError("step_shmap: jacobi_iters must be a multiple "
                             "of the resolved SOR fuse k")
        min_loc = max(_HALO, halo8(2 * sor_k(scene)))
    else:  # FDM: a gather-based direct solve, no halos
        min_loc = _HALO
    if g.ny % S != 0 or (g.ny // S) % 8 != 0 or g.ny // S < min_loc:
        raise ValueError(f"step_shmap: ny={g.ny} must split into "
                         f"{S} shards of >= {min_loc} rows (multiples "
                         f"of 8); the pressure solve's halo spans the "
                         f"fused iteration window")


def make_step_shmap(scene: Scene, mesh: RowMesh):
    """The sharded step: sharded State -> (sharded State,
    StepDiagnostics), the diagnostics' tensors on the first shard's
    device."""
    _check_supported(scene, mesh)
    g, opts, params = scene.grid, scene.opts, scene.params
    ny, nx = g.ny, g.nx
    S, devs = mesh.size, mesh.devices
    loc = ny // S
    offs = [s * loc for s in range(S)]
    js = opts.semantics == Semantics.JS
    rounds = opts.outer_corrector_rounds
    fast_tail = rounds == 0
    sem, scheme = opts.semantics, params.velocity_scheme
    profile, flow = params.inlet_profile, params.flow_case
    early = opts.early_exit and opts.jacobi_tol > 0.0

    solver = params.pressure_solver
    if solver == PressureSolver.JACOBI:
        k = resolve_fuse_k(opts, divide=opts.jacobi_iters)

        def solve(pp0, rhs):
            return jacobi_shard_body(pp0, rhs, mesh, ny, g.dx, g.dy, opts.jacobi_omega,
                                     opts.jacobi_iters, k, opts.jacobi_tol, early)
    elif solver == PressureSolver.SOR:
        k = sor_k(scene)

        def solve(pp0, rhs):
            return sor_shard_body(pp0, rhs, mesh, ny, g.dx, g.dy, opts.sor_omega,
                                  opts.jacobi_iters, k, opts.jacobi_tol, early)
    else:  # FDM (JAX step_shmap.py:181-199): gather the rhs, solve, slice
        def solve(pp0, rhs):
            pp, err, _ = _solve_fdm(scene, join_rows(rhs, devs[0]))
            return split_rows(pp, mesh), err

    def on(x, s):
        """A replicated 0-d tensor on shard s's device."""
        return x.to(devs[s])

    def correct_local(us, vs, p, pp, dt_sub):
        """The corrector (ops/corrector.py) on row blocks: u needs only
        columns; v reads p'[j-1], from a 1-row halo below each block."""
        ppx = exchange_rows(pp, mesh, 1)
        out = []
        for s in range(S):
            dt = on(dt_sub, s)
            u = us[s].clone()
            u[:, 1:-1] = us[s][:, 1:-1] - dt * (pp[s][:, 1:] - pp[s][:, :-1]) / g.dx
            v = vs[s] - dt * (ppx[s][1:loc + 1] - ppx[s][0:loc]) / g.dy
            if s == 0:
                v[0] = vs[s][0]  # global row 0 is not corrected
            out.append((u, v, p[s] + pp[s]))
        return tuple(zip(*out))

    def div_local(u, v, dt_sub):
        """The divergence RHS (ops/divergence.py) on row blocks: v[j+1]
        from a 1-row halo above (zero above the top shard: v's implicit
        top row)."""
        vx = exchange_rows(v, mesh, 1)
        return tuple(((u[s][:, 1:] - u[s][:, :-1]) / g.dx
                      + (vx[s][2:loc + 2] - vx[s][1:loc + 1]) / g.dy) / on(dt_sub, s)
                     for s in range(S))

    def substep(u, v, p, pp, entry, dt_sub, nu, inlet):
        h = _HALO
        ue, ve = exchange_rows(u, mesh, h), exchange_rows(v, mesh, h)
        pred = [predict_div(ue[s], ve[s], on(dt_sub, s), on(nu, s), g, scheme, sem,
                            row_offset=offs[s] - h) for s in range(S)]
        rhs = tuple(r[h:h + loc] for _, _, r in pred)
        pp0 = pp if opts.semantics == Semantics.RUST else tuple(map(torch.zeros_like, pp))
        pp, err = solve(pp0, rhs)
        if fast_tail:
            # p' needs its neighbours' rows (v reads p'[j-1]); u*, v* come
            # extended from the predictor; p and the entry fields matter
            # on the owned rows only, so zero rows keep the shapes.
            ppe = exchange_rows(pp, mesh, h)
            pad = lambda x: F.pad(x, (0, 0, h, h))
            outs = [correct_bc(pred[s][0], pred[s][1], pad(p[s]), ppe[s],
                               pad(entry[0][s]), pad(entry[1][s]), on(dt_sub, s),
                               on(inlet, s), g, profile, flow, sem,
                               row_offset=offs[s] - h, own_rows=(h, h + loc))
                    for s in range(S)]
            u, v, p = (tuple(o[i][h:h + loc] for o in outs) for i in range(3))
            red = tuple(pmax([o[i] for o in outs], mesh) for i in (3, 4, 5))
            return u, v, p, pp, err, red
        u, v, p = correct_local(tuple(x[0][h:h + loc] for x in pred),
                                tuple(x[1][h:h + loc] for x in pred), p, pp, dt_sub)
        it = 0
        # The Rust outer rounds (model.rs:696-724) on the shards' max
        # residual: one host read a round.
        while it < rounds and trace.read_host(err >= opts.outer_corrector_tol):
            pp, err = solve(pp, div_local(u, v, dt_sub))
            u, v, p = correct_local(u, v, p, pp, dt_sub)
            it += 1
        bcs = []
        for s in range(S):
            _, _, mask_u_bc, mask_v_bc = masks_traced(g, sem, devs[s], offs[s], loc)
            bcs.append(apply_bcs(u[s], v[s], g, profile, on(inlet, s), mask_u_bc,
                                 mask_v_bc, flow, offs[s]))
        u, v = tuple(zip(*bcs))
        return u, v, p, pp, err, None

    def step(state: State):
        if not isinstance(state.u, tuple) or len(state.u) != S:
            raise TypeError(f"make_step_shmap: expects a State sharded over the "
                            f"mesh's {S} shards (shard_state)")
        u_enter, v_enter = state.u, state.v
        u, v = u_enter, v_enter
        if js and opts.extrapolate:
            # The JS extrapolated initial guess (index.html:263-270).
            nonzero = state.step > 0
            u = tuple(torch.where(on(nonzero, s), 2.0 * u[s] - state.u_prev[s], u[s])
                      for s in range(S))
            v = tuple(torch.where(on(nonzero, s), 2.0 * v[s] - state.v_prev[s], v[s])
                      for s in range(S))
        entry = (u, v)
        inlet = ramped_inlet(opts, state)
        if not opts.substeps_adaptive and opts.substeps_init == 1:
            substeps, n_sub, dt_sub = torch.ones_like(state.substeps), 1, state.dt
        else:
            substeps = state.substeps
            n_sub = trace.read_host(substeps)  # the step's one host read of its count
            dt_sub = state.dt / substeps.to(state.dt.dtype)
        executed = substeps
        p, pp = state.p, state.p_prime
        res_p = red = None
        for _ in range(n_sub):
            u, v, p, pp, err, extras = substep(u, v, p, pp, entry, dt_sub, state.nu,
                                               inlet)
            # JS reports the max residual over the substeps, Rust the last.
            res_p = torch.maximum(res_p, err) if js and res_p is not None else err
            red = extras if extras is not None else red
        if red is not None:
            res_u, res_v, max_vel = red
        else:
            res_u = pmax([torch.amax(torch.abs(a - b)) for a, b in zip(u, entry[0])], mesh)
            res_v = pmax([torch.amax(torch.abs(a - b)) for a, b in zip(v, entry[1])], mesh)
            max_vel = pmax([torch.maximum(torch.amax(torch.abs(a)), torch.amax(torch.abs(b)))
                            for a, b in zip(u, v)], mesh)
        new_step = state.step + 1
        new_t = state.t + state.dt
        if js and opts.substeps_adaptive:
            substeps = adapt_substeps(opts, substeps, res_u, res_v, res_p)
        new_dt = dt_control(g, opts, state, max_vel, res_p)
        new_state = dataclasses.replace(
            state, u=u, v=v, p=p, p_prime=pp,
            u_prev=u_enter if js else None, v_prev=v_enter if js else None,
            dt=new_dt, t=new_t, step=new_step, substeps=substeps, res_u=res_u,
            res_v=res_v, res_p=res_p)
        diag = StepDiagnostics(step=new_step, t=new_t, dt=state.dt, res_u=res_u,
                               res_v=res_v, res_p=res_p, substeps=executed)
        return new_state, diag

    return step


def make_run_shmap(scene: Scene, mesh: RowMesh, n_steps: int):
    """n sharded steps (the JAX package's lax.scan): sharded State ->
    (sharded State, StepDiagnostics of (n_steps,) tensors)."""
    step = make_step_shmap(scene, mesh)

    def run(state: State):
        diags = []
        for _ in range(n_steps):
            state, d = step(state)
            diags.append(d)
        return state, StepDiagnostics(*(torch.stack(x) for x in zip(*diags)))

    return run
