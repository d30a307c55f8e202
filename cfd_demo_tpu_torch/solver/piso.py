"""The PISO time step in PyTorch (↔ cfd_demo_tpu/solver/piso.py).

Reference call stack (Rust semantics): Model::update (model.rs:304-379)
-> piso_step (model.rs:529-730): predictor -> divergence -> Jacobi ->
corrector -> up to 20 extra corrector rounds (model.rs:696-724) ->
boundary conditions (model.rs:826-875); then CFL dt control. JS
semantics (index.html:260-362): the extrapolated initial guess
2u - u_prev, 1..20 adaptive substeps each solving from a zero p', no
outer rounds, the max res_p over the substeps, dt capped by the user's
dt and optionally scaled by the pressure residual.

The step is plain Python over tensors on one device. Every scalar the
step carries (dt, t, step, the residuals, the inlet ramp) is a 0-d
tensor on that device, and the routes below read nothing back to the
host except where noted.

Route table (``piso_substep``), mirroring the JAX package's routing on
the TPU. Each kernel wrapper runs its plain version on CPU tensors.

==============================================  =========================================
condition                                       route
==============================================  =========================================
substep_impl "pallas", or "auto" at >= 2M       fused: ``predict_div`` kernel ->
cells (bench.py's 2048² shapes)                 ``_solve_pressure`` -> with no outer
                                                rounds, ``correct_bc`` kernel (res_u,
                                                res_v, max|vel| reduced in-pass); with
                                                rounds, plain correct -> ``_outer_rounds``
                                                -> plain apply_bcs
otherwise, JACOBI with substep_impl and         ``_substep_jnp``: ``predict_div``
pressure_impl in ("auto", "pallas") (the        kernel, then the ``rounds`` kernel
800x264 default scene)                          (solve + corrector + rounds + BCs)
otherwise (SOR, FDM, MULTIGRID or               plain predictor, divergence,
MG_PRODUCTION below 2M cells, or "jnp")         ``_solve_pressure``, corrector,
                                                ``_outer_rounds``, BCs
a batch (B, ny, *), substep_impl and            ``substep_batch`` kernel (the SOR form:
pressure_impl in ("auto", "pallas"), that       ``substep_batch_sor``): the whole
``substep_batch_takes`` (kernels.cluster        substep of every scene in one launch, a
``plan`` gives it a form): JACOBI or            thread-block cluster a scene where the
red/black SOR in one block's shared memory      card admits one
(the app's 256x96), or JACOBI that a cluster
holds on a card that admits it (up to 1024
columns, the 800x264 ensemble)
another batch, JACOBI or SOR (wider than 1024   ``_substep_jnp``: plain predictor and
columns, a card that admits no such cluster,    divergence, ``_solve_pressure`` (the
SOR beyond one block, or "jnp")                 ``jacobi_batch`` kernel, or with
                                                pressure_impl "jnp" the plain masked
                                                jacobi; SOR: the plain masked sor),
                                                corrector, masked outer rounds whose
                                                solves skip converged scenes, BCs
a batch with another solver                     NotImplementedError (MULTIGRID and legacy
                                                MG_PRODUCTION: queue 1 item 9; the
                                                aligned MG_PRODUCTION and FDM: item 7)
==============================================  =========================================

A batch is never handed to a single-scene route (the fused kernels, the
rounds kernel), as the JAX package's ``_pallas_ok`` refuses batched
tracers (piso.py:147-157). Each scene of a batch freezes at its own
Jacobi sweep and outer round, for either early_exit: the JAX package's
batched rules are masked (piso.py:323-332), and a scene's fields equal
an unbatched run of it.

``_solve_pressure``, JACOBI: pressure_impl "auto" resolves to "pallas"
at >= 2M cells or jacobi_tol == 0, else "jnp". "pallas" runs the Jacobi
chain kernel (K-granularity exit, k = ``resolve_fuse_k``); "jnp" runs
ops.poisson.jacobi (exact per-sweep exit, or the masked fixed-trip form
when early_exit is False).

``_solve_pressure``, SOR (red/black, ``sor_omega``; the JAX package's
routing, piso.py:423-472): pressure_impl "auto" resolves to "pallas" at
>= 2M cells or jacobi_tol == 0, else "jnp". "pallas" runs, with k =
max(resolve_fuse_k // 2, 1) (the TPU kernel's halo spans two rings an
iteration), the colour-split chain (``sor_chain_rb2``, kernel 15) at >=
2M cells with nx even, else the full-layout chain (``sor_chain``, kernel
13); "jnp" runs ops.poisson.sor. The TPU's tile gates (``_pallas_ok``'s
ny % 8, ``sor_pallas_ok``, ``sor_rb2_ok``) and its measured 25/12 "big
k" (piso.py:446-456) are not carried over. sor_ordering
"lexicographic" always runs ops.poisson.sor_lexicographic. A batch runs
the plain masked sor (the JAX package vmaps it).

``_solve_pressure``, FDM (piso.py:475-497): the exact interior solve
(ops.fdm, f64 products rounded to f32 at either fdm_precision), the p'
BCs, err the post-solve max|rhs - A p'|, and a count of 1; the warm
start is ignored.

``_solve_pressure``, MULTIGRID (piso.py:473-474): ops.poisson.multigrid,
mg_cycles vertex V-cycles from zero and the residual report, through
the vertex kernels (kernels.mg) at every level of any size, odd or
even, down to the first at or below mg_coarsest cells a side (the TPU's
``multigrid_pallas_ok`` and ``_level_ok`` gates, which hand odd and
small levels to XLA, are not carried over). It reads nothing back: with
outer_corrector_rounds 0 (the 2048² multigrid cell) the step never
synchronises; the 800x264 scene's outer rounds read their error once a
round.

==============================================  =========================================
level                                           kernel (one wrapper call each)
==============================================  =========================================
every level                                     ``mg_smooth``: mg_pre_smooth sweeps, then
                                                after the correction mg_post_smooth (one
                                                sweep a launch above 19,370 cells, all k
                                                in one block at or below)
every level above mg_coarsest                   ``mg_residual_restrict`` (the coarse rhs)
                                                and ``mg_prolong_add`` (p + prolong(e))
the coarsest level                              ``mg_smooth``, mg_coarse_smooth sweeps
==============================================  =========================================

``_solve_pressure``, MG_PRODUCTION: ops.poisson.multigrid_production
with tol_r = projection_div_tol / dt_sub (dt_sub a 0-d device tensor).
mgp_scheme "legacy" runs the vertex hierarchy (ops.poisson._mgp_vcycle)
through ``mgp_smooth`` (mgp_smooth damped sweeps with the p' BCs, kernel
19), ``mg_residual_restrict`` and ``mg_prolong_add`` with the p' BCs of
the sum, at every level, and reads max|r| (and max|p'| for the noise
floor) once a cycle for the exact exit; mgp_fixed_cycles > 0 runs the
aligned cycle whatever the scheme, as the JAX package does
(ops/poisson.py:1299-1305). The aligned scheme runs at every size
otherwise: "auto" resolves to it (the JAX package's legacy-below-2M
rule, ops/poisson.py:1139-1149, is a reading of the TPU's launch
latency). The aligned cycle's smoothers, at any size (the TPU's 2M-cell,
ny % 8, ny % 16 and k <= 14 gates are not carried over):

==============================================  =========================================
level                                           kernel
==============================================  =========================================
fine level, even ny and nx                      ``jacobi_fused_k_restrict`` (pre-smooth,
                                                residual, first restriction) and
                                                ``jacobi_fused_k_corr`` (y pass of the
                                                prolongation, add, post-smooth, max|r|,
                                                max|p'|)
fine level, odd ny or nx                        ``jacobi_fused_k_res``, before (with r)
                                                and after (without) the correction
coarse levels above mgp_coarse_stop             ``cc_sweeps`` (pre with r, post without)
levels at or below mgp_coarse_stop              FDM (ops.fdm, f64 products: never TF32)
an interior at most mgp_coarse_stop a side      FDM alone, no smoothing
==============================================  =========================================

pressure_impl "jnp" runs the plain versions of the four smoothers, and of
the vertex kernels.

The fused route with outer rounds and ``rounds_impl="pallas"`` runs
each round as the solve plus one ``correct_div`` launch (the corrector
and, in the same pass, the next round's divergence), then the plain BCs
(JAX piso.py:725-756); other rounds_impl values take the plain corrector
and ``_outer_rounds``. JS semantics starts every solve from a zero p'
on every route (JAX piso.py:565-566, :692).

Convergence semantics: the rounds kernel and the plain Jacobi solve exit
at the exact sweep and round (rounds_pallas.py:11-24); the chain checks
its tolerance every k sweeps (jacobi_pallas.py:28-30); MG_PRODUCTION
exits at the exact V-cycle (``_exact_while`` with the noise floor as a
dynamic tolerance), or with early_exit False runs the masked fixed-trip
loop.

==============================================  =========================================
host read                                       when
==============================================  =========================================
the Jacobi chain's error                        once per k-launch, tol > 0
MG_PRODUCTION's max|r| (and max|p'|)            once per V-cycle, early_exit
the outer rounds' error                         once per round, the fused route and the
                                                plain projection, early_exit
``state.substeps``                              once per step, unless the count is
                                                statically 1 (JS's adaptive substeps, or
                                                substeps_init > 1)
==============================================  =========================================

The fixed schedules, MULTIGRID, the rounds kernel and the batch routes
read nothing. Every read goes through ``trace.read_host``, which counts
it.

Spans (``trace.span``, profiler ranges while a profiler records):
``cfd.step`` over ``step_fn``; in each substep ``cfd.predict`` (the
predictor and the divergence), ``cfd.solve`` (``_solve_pressure``, or on
the rounds route the rounds kernel, which corrects too) and
``cfd.correct`` (the corrector, the outer rounds, whose solves nest a
``cfd.solve``, and the BCs); the batch kernel's substep is one
``cfd.kernel.substep_batch`` span. What runs inside ``cfd.step`` and in
no phase is the step's own control: the inlet ramp, the residual maxima,
the substep count and the dt control. While a profiler records,
``trace.rounds`` keeps the (outer rounds, sweeps) counts each
single-scene ``_substep_jnp`` returns: the rounds kernel's own, or the
plain projection's (the fused route's rounds are not kept).

CAVITY flow (the lid-driven cavity, BASELINE config 2) takes the same
routes with JACOBI, FDM, MULTIGRID and MG_PRODUCTION: the Jacobi chain,
the rounds kernel and the one-launch ``correct_bc`` in their CAVITY
instances, the cavity p' BCs in the plain Jacobi, the all-Neumann
operator in FDM, and apply_bcs's cavity branch; MULTIGRID's vertex
cycles take no flow case (JAX ops/poisson.py:1330); MG_PRODUCTION takes
the cavity p' BCs at every level (JAX piso.py:218-242): the CAVITY
instances of its smoothers (kernels 6-9 on the aligned cycle, 18's ring
and 19 on the legacy one) and the all-Neumann coarse operator with its
FDM bottom. CAVITY with SOR or differentiable, in a batch or on the
sharded step raises (queue 1 item 6b).

The TPU gates (``_pallas_ok``'s ny % 8 and backend test, ``_tile_rows``,
``rounds_pallas_ok``'s VMEM bound) are not carried over; each kernel
checks its own limits. Nor are the lane padding of u, buffer donation
and the VMEM budgets. What the slice does not cover raises
NotImplementedError naming the ROADMAP item that ports it.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..core.config import (Cylinder, FlowCase, Grid, PressureSolver,
                           Semantics, SimulationParams, SolverOptions)
from ..core.masks import masks_traced
from ..core.state import State, init_state
from ..core.unported import (BATCHES, BOX_FLOAT64, CAVITY, DIFFERENTIABLE,
                             OTHER_SOLVERS, unported)
from ..kernels.ensemble import check_batchable, substep_batch, substep_batch_takes
from ..kernels.jacobi import jacobi_chain
from ..kernels.jacobi_batch import jacobi_batch, jacobi_batch_plain
from ..kernels.rounds import solve_correct_rounds
from ..kernels.sor import sor_chain, sor_chain_rb2
from ..kernels.substep import correct_bc, correct_div, predict_div
from ..ops.bc import apply_bcs
from ..ops.corrector import correct
from ..ops.divergence import divergence_rhs
from ..ops.fdm import fdm_solve_interior
from ..ops.poisson import (_mg_residual, check_mgp_scheme, jacobi, multigrid,
                           multigrid_production, pprime_bc_fn, sor,
                           sor_lexicographic)
from ..ops.predictor import predict
from .. import trace
from ..trace import span, traced

FUSED_MIN_CELLS = 2_000_000


class StepDiagnostics(NamedTuple):
    """Per-step residual record (model.rs:23-32 Residuals)."""

    step: torch.Tensor
    t: torch.Tensor
    dt: torch.Tensor
    res_u: torch.Tensor
    res_v: torch.Tensor
    res_p: torch.Tensor
    substeps: torch.Tensor


@dataclasses.dataclass(frozen=True)
class Scene:
    """A simulation setup: grid + static numerics. Build with
    :func:`make_scene`; runtime scalars flow through ``State``."""

    grid: Grid
    params: SimulationParams
    opts: SolverOptions

    def init_state(self, device="cuda", dtype=torch.float32) -> State:
        return init_state(self.grid, self.params, self.opts, device, dtype)

    @functools.cached_property
    def _masks(self):
        """Host copies of the masks, for diagnostics (float32 0/1)."""
        g = self.grid
        shapes = ((g.ny, g.nx + 1), (g.ny, g.nx)) * 2
        masks = masks_traced(g, self.opts.semantics, torch.device("cpu"))
        return tuple(np.zeros(s, np.float32) if m is None
                     else m.to(torch.float32).numpy() for m, s in zip(masks, shapes))

    @property
    def mask_u(self) -> np.ndarray:
        return self._masks[0]

    @property
    def mask_v(self) -> np.ndarray:
        return self._masks[1]

    @property
    def mask_u_bc(self) -> np.ndarray:
        return self._masks[2]

    @property
    def mask_v_bc(self) -> np.ndarray:
        return self._masks[3]


def make_scene(grid: Grid, params: Optional[SimulationParams] = None,
               opts: Optional[SolverOptions] = None) -> Scene:
    """Validate that the configuration lies in the ported slice."""
    params = params or SimulationParams()
    opts = opts or SolverOptions()
    if grid.nx < 3 or grid.ny < 3:
        raise ValueError(f"the grid needs at least 3x3 cells, got "
                         f"{grid.nx}x{grid.ny}")
    if params.flow_case == FlowCase.CAVITY:
        # The lid-driven cavity takes JACOBI, FDM, MULTIGRID (the JS kit's
        # vertex V-cycles take no flow case, JAX ops/poisson.py:1330) and
        # MG_PRODUCTION.
        if params.pressure_solver == PressureSolver.SOR:
            raise unported(f"cavity flow with the {params.pressure_solver.value} "
                           f"pressure solver", CAVITY)
        if opts.differentiable:
            raise unported("cavity flow with SolverOptions.differentiable", CAVITY)
    for obs in grid.obstacles:
        if not isinstance(obs, Cylinder):
            raise unported(f"obstacle {type(obs).__name__}", BOX_FLOAT64)
    if params.pressure_solver not in (PressureSolver.JACOBI, PressureSolver.SOR,
                                      PressureSolver.FDM, PressureSolver.MULTIGRID,
                                      PressureSolver.MG_PRODUCTION):
        raise unported(f"the {params.pressure_solver.value} pressure solver",
                       OTHER_SOLVERS)
    if params.pressure_solver == PressureSolver.MG_PRODUCTION:
        check_mgp_scheme(opts)
    if opts.sor_ordering not in ("redblack", "lexicographic"):
        raise ValueError(f"sor_ordering must be redblack or lexicographic, got "
                         f"{opts.sor_ordering!r}")
    if opts.differentiable:
        raise unported("SolverOptions.differentiable", DIFFERENTIABLE)
    return Scene(grid=grid, params=params, opts=opts)


# ---------------------------------------------------------------------------
# PISO substep
# ---------------------------------------------------------------------------

def _use_fused_substep(scene: Scene) -> bool:
    impl = scene.opts.substep_impl
    if impl == "auto":
        return scene.grid.nx * scene.grid.ny >= FUSED_MIN_CELLS
    return impl == "pallas"


def _whole_kernels(opts: SolverOptions) -> bool:
    """Whether a substep may hand its projection to one kernel (the rounds
    kernel, or kernel 20 for a batch): pressure_impl and substep_impl
    "auto" or "pallas"."""
    return (opts.pressure_impl in ("auto", "pallas")
            and opts.substep_impl in ("auto", "pallas"))


def _pressure_impl(scene: Scene) -> str:
    """pressure_impl, with "auto" resolved: "pallas" at >= 2M cells or
    jacobi_tol == 0, else "jnp"."""
    g, opts = scene.grid, scene.opts
    if opts.pressure_impl != "auto":
        return opts.pressure_impl
    return "pallas" if g.nx * g.ny >= FUSED_MIN_CELLS or opts.jacobi_tol == 0.0 else "jnp"


def resolve_fuse_k(opts: SolverOptions, divide: int = 0) -> int:
    """Sweeps per Jacobi-chain launch: pallas_fuse_k, or 16 when 0 (the
    JAX package's auto value, piso.py:184-212). Not yet tuned for the
    H100. ``divide`` > 0 (the sharded step, whose per-shard chain has no
    remainder launch) makes the auto value the largest k <= 16 that
    divides it, e.g. 10 for 50 iterations; an explicit pallas_fuse_k is
    returned as it is."""
    if opts.pallas_fuse_k:
        return opts.pallas_fuse_k
    base = 16
    if divide:
        while base > 1 and divide % base != 0:
            base -= 1
    return base


def _solve_sor(scene: Scene, pp0, rhs, done=None):
    """The SOR branch of the JAX package's ``_solve_pressure`` (the
    module docstring's table)."""
    g, opts = scene.grid, scene.opts
    args = (g.dx, g.dy, opts.sor_omega, opts.jacobi_tol, opts.jacobi_iters)
    batch = pp0.dim() == 3  # masked, as the JAX package's vmapped solve
    if opts.sor_ordering == "lexicographic":
        return sor_lexicographic(pp0, rhs, *args,
                                 early_exit=opts.early_exit and not batch, done=done)
    if batch:
        return sor(pp0, rhs, *args, early_exit=False, done=done)
    if _pressure_impl(scene) == "pallas":
        k = max(resolve_fuse_k(opts) // 2, 1)  # the halo spans 2k rows
        chain = (sor_chain_rb2 if g.nx * g.ny >= FUSED_MIN_CELLS and g.nx % 2 == 0
                 else sor_chain)
        return chain(pp0, rhs, *args, k=k, early_exit=opts.early_exit)
    return sor(pp0, rhs, *args, early_exit=opts.early_exit)


def _cavity(scene: Scene) -> bool:
    return scene.params.flow_case == FlowCase.CAVITY


def _solve_fdm(scene: Scene, rhs):
    """The FDM branch of the JAX package's ``_solve_pressure``
    (piso.py:475-497), one scene: in CAVITY flow the all-Neumann
    operator's pseudo-inverse and the cavity p' BCs."""
    g = scene.grid
    e_int = fdm_solve_interior(rhs[1:-1, 1:-1], g.dx, g.dy, g.dx,
                               east_dirichlet=not _cavity(scene))
    bc = pprime_bc_fn(scene.params.flow_case)
    pp = bc(torch.nn.functional.pad(e_int, (1, 1, 1, 1)))
    err = torch.amax(torch.abs(_mg_residual(pp, rhs, g.dx, g.dy)))
    return pp, err, torch.ones((), dtype=torch.int32, device=rhs.device)


@traced("cfd.solve")
def _solve_pressure(scene: Scene, pp0, rhs, dt_sub, done=None):
    """The JACOBI, SOR, FDM, MULTIGRID and MG_PRODUCTION branches of the
    JAX package's ``_solve_pressure``, and for a JACOBI or SOR batch its
    batched rule (piso.py:335-360): the ``jacobi_batch`` kernel, or with
    pressure_impl "jnp" the plain masked jacobi; the plain masked sor;
    none sweeping the scenes a (B,) ``done`` marks. Returns (p', err,
    iterations or V-cycles run)."""
    g, opts = scene.grid, scene.opts
    solver = scene.params.pressure_solver
    if solver == PressureSolver.MG_PRODUCTION:
        # tol_r = div_tol / dt bounds the post-correction max|div u| by
        # div_tol (JAX piso.py:220-243).
        return multigrid_production(pp0, rhs, g.dx, g.dy, opts,
                                    opts.projection_div_tol / dt_sub,
                                    bc=pprime_bc_fn(scene.params.flow_case))
    if solver == PressureSolver.SOR:
        return _solve_sor(scene, pp0, rhs, done)
    if solver == PressureSolver.MULTIGRID:  # JAX piso.py:473-474
        return multigrid(pp0, rhs, g.dx, g.dy, opts)
    if solver == PressureSolver.FDM:
        return _solve_fdm(scene, rhs)
    if pp0.dim() == 3:
        solve = jacobi_batch if opts.pressure_impl in ("auto", "pallas") else jacobi_batch_plain
        return solve(pp0, rhs, g.dx, g.dy, opts.jacobi_omega, opts.jacobi_tol,
                     opts.jacobi_iters, done=done)
    if _pressure_impl(scene) == "pallas":
        return jacobi_chain(pp0, rhs, g.dx, g.dy, opts.jacobi_omega,
                            opts.jacobi_tol, opts.jacobi_iters,
                            k=resolve_fuse_k(opts),
                            early_exit=opts.early_exit, cavity=_cavity(scene))
    return jacobi(pp0, rhs, g.dx, g.dy, opts.jacobi_omega, opts.jacobi_tol,
                  opts.jacobi_iters, early_exit=opts.early_exit,
                  bc=pprime_bc_fn(scene.params.flow_case))


def _outer_rounds(scene: Scene, u, v, p, pp, err, dt_sub):
    """Rust outer corrector rounds (model.rs:696-724): repeat
    div -> solve -> correct until the pressure residual drops below
    outer_corrector_tol, at most outer_corrector_rounds times. Returns
    (u, v, p, pp, err, rounds run, solver iterations run); on a batch
    each scene stops at its own round, with the counts (B,) tensors."""
    g, opts = scene.grid, scene.opts
    rounds, tol = opts.outer_corrector_rounds, opts.outer_corrector_tol

    def round_body(u, v, p, pp, done=None):
        rhs = divergence_rhs(u, v, dt_sub, g.dx, g.dy)
        pp, err, n = _solve_pressure(scene, pp, rhs, dt_sub, done)
        u, v, p = correct(u, v, p, pp, dt_sub, g.dx, g.dy)
        return u, v, p, pp, err, n

    if opts.early_exit and err.dim() == 0:
        # One host read of err per round; a device-side loop is later work.
        it = iters = 0
        while it < rounds and trace.read_host(err >= tol):
            u, v, p, pp, err, n = round_body(u, v, p, pp)
            it, iters = it + 1, iters + n
        return u, v, p, pp, err, it, iters
    # Masked fixed trip count: the rounds after a scene converges are
    # discarded, the same fields as the exact exit with no host read. A
    # batch's solves skip its converged scenes; on the CPU the loop stops
    # once all are done, the JAX package's masked loop's own exit.
    done = err < tol
    it = torch.zeros(err.shape, dtype=torch.int32, device=err.device)
    iters = torch.zeros_like(it)
    for _ in range(rounds):
        if done.device.type == "cpu" and bool(done.all()):
            break
        u2, v2, p2, pp2, err2, n = round_body(u, v, p, pp,
                                              done if err.dim() else None)
        keep = done[..., None, None]  # (B, 1, 1): per scene, never per column
        u, v, p, pp = (torch.where(keep, a, b)
                       for a, b in ((u, u2), (v, v2), (p, p2), (pp, pp2)))
        err = torch.where(done, err, err2)
        active = (~done).to(torch.int32)
        it, iters = it + active, iters + active * n
        done = done | (err < tol)
    return u, v, p, pp, err, it, iters


def _warm_start(opts: SolverOptions, p_prime):
    """The solve's initial p': the carried p' (Rust), or zero (JS,
    index.html:777; JAX piso.py:565-566)."""
    return p_prime if opts.semantics == Semantics.RUST else torch.zeros_like(p_prime)


def _substep_jnp(scene: Scene, u, v, p, p_prime, dt_sub, nu, inlet):
    """For one JACOBI scene the ``predict_div`` kernel, then the rounds
    kernel; or else (another solver, substep_impl or pressure_impl
    "jnp", or a batch) the plain predictor and divergence, then the
    plain projection: ``_solve_pressure``, corrector, ``_outer_rounds``,
    BCs. Returns (u, v, p, pp, err, counts): int32 counts (..., 2) of the
    outer rounds and solver iterations run, (B, 2) on a batch; a single
    scene's are kept in ``trace.rounds`` while a profiler records."""
    g, opts = scene.grid, scene.opts
    if (u.dim() == 2 and scene.params.pressure_solver == PressureSolver.JACOBI
            and _whole_kernels(opts)):
        with span("cfd.predict"):
            u_star, v_star, rhs = predict_div(u, v, dt_sub, nu, g,
                                              scene.params.velocity_scheme,
                                              opts.semantics)
        pp0 = _warm_start(opts, p_prime)
        with span("cfd.solve"):
            out = solve_correct_rounds(u_star, v_star, p, pp0, rhs, dt_sub,
                                       inlet, scene)
        trace.keep_rounds(out[-1])
        return out
    mask_u, mask_v, mask_u_bc, mask_v_bc = masks_traced(g, opts.semantics,
                                                        u.device)
    with span("cfd.predict"):
        u_star, v_star = predict(u, v, dt_sub, nu, g.dx, g.dy, g.nx, g.ny,
                                 scene.params.velocity_scheme,
                                 opts.semantics == Semantics.JS, mask_u, mask_v)
        rhs = divergence_rhs(u_star, v_star, dt_sub, g.dx, g.dy)
    pp0 = _warm_start(opts, p_prime)
    pp, err, n = _solve_pressure(scene, pp0, rhs, dt_sub)
    with span("cfd.correct"):
        u, v, p = correct(u_star, v_star, p, pp, dt_sub, g.dx, g.dy)
        u, v, p, pp, err, it, iters = _outer_rounds(scene, u, v, p, pp, err, dt_sub)
        u, v = apply_bcs(u, v, g, scene.params.inlet_profile, inlet, mask_u_bc,
                         mask_v_bc, scene.params.flow_case)
    counts = torch.stack([torch.as_tensor(c, device=u.device).to(torch.int32)
                          for c in (it, n + iters)], dim=-1)
    if u.dim() == 2:
        trace.keep_rounds(counts)
    return u, v, p, pp, err, counts


def _substep_batched(scene: Scene, u, v, p, p_prime, dt_sub, nu, inlet):
    """A substep of a batch (B, ny, *) with (B,) dt_sub, nu and inlet: the
    JAX package's custom_vmap rules (piso.py:610-642, :335-360). JACOBI
    and SOR; the JAX package's B <= 16 gate for SOR (a TPU reading) is
    not carried over. (``step_fn`` has refused JS semantics, SECOND/QUICK
    faces and the parabolic inlets, ``check_batchable``.) Returns (u, v,
    p, pp, err, counts) with err (B,), counts (B, 2)."""
    opts, solver = scene.opts, scene.params.pressure_solver
    if solver == PressureSolver.MULTIGRID or (solver == PressureSolver.MG_PRODUCTION
                                              and opts.mgp_scheme == "legacy"):
        scheme = " (legacy)" if solver == PressureSolver.MG_PRODUCTION else ""
        raise unported(f"a batched {solver.value}{scheme} scene", BATCHES)
    if solver not in (PressureSolver.JACOBI, PressureSolver.SOR):
        raise unported(f"a batched {solver.value} scene", OTHER_SOLVERS)
    if _whole_kernels(opts) and substep_batch_takes(scene, u.shape[0], u.device):
        return substep_batch(u, v, p, p_prime, dt_sub, nu, inlet, scene)
    return _substep_jnp(scene, u, v, p, p_prime, dt_sub, nu, inlet)


def piso_substep(scene: Scene, u, v, p, p_prime, dt_sub, nu, inlet,
                 entry=None):
    """One PISO substep (model.rs:529-730).

    Returns (u, v, p, p_prime, p_residual, extras): extras is None, or on
    the fused route without outer rounds, when ``entry`` carries the
    step-entry (u, v), the in-kernel (res_u, res_v, max_vel)."""
    g, opts = scene.grid, scene.opts
    if u.dim() == 3:
        return (*_substep_batched(scene, u, v, p, p_prime, dt_sub, nu,
                                  inlet)[:5], None)
    if not _use_fused_substep(scene):
        return (*_substep_jnp(scene, u, v, p, p_prime, dt_sub, nu, inlet)[:5],
                None)
    sem, profile, flow = (opts.semantics, scene.params.inlet_profile,
                          scene.params.flow_case)
    with span("cfd.predict"):
        u_star, v_star, rhs = predict_div(u, v, dt_sub, nu, g,
                                          scene.params.velocity_scheme, sem)
    pp, err, _ = _solve_pressure(scene, _warm_start(opts, p_prime), rhs, dt_sub)
    rounds = opts.outer_corrector_rounds
    with span("cfd.correct"):
        if rounds == 0 and entry is not None:
            u, v, p, res_u, res_v, max_vel = correct_bc(
                u_star, v_star, p, pp, entry[0], entry[1], dt_sub, inlet, g,
                profile, flow, sem)
            return u, v, p, pp, err, (res_u, res_v, max_vel)
        _, _, mask_u_bc, mask_v_bc = masks_traced(g, sem, u.device)
        if rounds > 0 and opts.early_exit and opts.rounds_impl == "pallas":
            # JAX piso.py:725-756: each round is the solve plus one
            # correct_div launch, whose divergence feeds the next round's
            # solve; the exit reads err on the host once a round, as
            # _outer_rounds does.
            u, v, p, rhs = correct_div(u_star, v_star, p, pp, dt_sub, g)
            it = 0
            while it < rounds and trace.read_host(err >= opts.outer_corrector_tol):
                pp, err, _ = _solve_pressure(scene, pp, rhs, dt_sub)
                u, v, p, rhs = correct_div(u, v, p, pp, dt_sub, g)
                it += 1
        else:
            u, v, p = correct(u_star, v_star, p, pp, dt_sub, g.dx, g.dy)
            u, v, p, pp, err = _outer_rounds(scene, u, v, p, pp, err, dt_sub)[:5]
        u, v = apply_bcs(u, v, g, profile, inlet, mask_u_bc, mask_v_bc, flow)
    return u, v, p, pp, err, None


# ---------------------------------------------------------------------------
# Step-level scalar controls
# ---------------------------------------------------------------------------

def ramped_inlet(opts: SolverOptions, state: State):
    """Inlet ramp (model.rs:311-316)."""
    ramp = torch.clamp(state.step.to(state.dt.dtype) / float(opts.ramp_up_steps),
                       max=1.0)
    return ramp * state.target_inlet


def adapt_substeps(opts: SolverOptions, substeps, res_u, res_v, res_p):
    """JS substep adaptation (index.html:310-317): grow by the error
    ratio above tolerance, halve when well below."""
    error_norm = torch.maximum(torch.maximum(res_u, res_v), res_p)
    tol = opts.substep_tolerance
    factor = error_norm / torch.full_like(error_norm, tol)  # a true division on the card
    grown = torch.clamp(torch.ceil(substeps.to(error_norm.dtype) * factor),
                        max=float(opts.substeps_max)).to(torch.int32)
    shrunk = torch.clamp(substeps // 2, min=1)
    return torch.where(
        error_norm > tol, grown,
        torch.where((error_norm < tol / 10.0) & (substeps > 1), shrunk, substeps))


def dt_control(grid: Grid, opts: SolverOptions, state: State, max_vel, res_p):
    """CFL dt control with the 1.1x growth cap (model.rs:877-889 /
    index.html:1326-1341), capped by the user's dt in JS, plus the JS
    residual-based dt scaling (index.html:338-350)."""
    js = opts.semantics == Semantics.JS
    cap = state.dt_user if js else state.dt
    safe_vel = torch.where(max_vel == 0.0, 1.0, max_vel)
    # f32(cfl * h) / v, rounded as the JAX package divides (a Python
    # scalar on the left would become a reciprocal and a multiply).
    cfl_h = torch.full_like(safe_vel, opts.cfl * min(grid.dx, grid.dy))
    dt_cfl = torch.where(max_vel == 0.0, cap,
                         torch.minimum(cfl_h / safe_vel, cap))
    if js and opts.residual_dt_scaling:
        ptol = torch.full_like(res_p, opts.residual_dt_tol)
        dt_pressure = torch.where(res_p > opts.residual_dt_tol,
                                  dt_cfl * (ptol / (res_p + 1e-10)), dt_cfl)
        dt_cfl = torch.minimum(dt_cfl, dt_pressure)
    return torch.where(dt_cfl > state.dt,
                       torch.minimum(dt_cfl, state.dt * opts.dt_growth_cap),
                       dt_cfl)


# ---------------------------------------------------------------------------
# Full outer step
# ---------------------------------------------------------------------------

@traced("cfd.step")
def step_fn(scene: Scene, state: State) -> Tuple[State, StepDiagnostics]:
    """One Model::update / updateSimulation: the substeps plus the step
    controls. On a batched state (fields (B, ny, *), scalars (B,)) every
    scene steps on its own: the residuals and the CFL control per scene.

    The substep count is static (one substep, no host read) unless the
    scene adapts it or starts above one; then the loop reads
    ``state.substeps`` once (JAX piso.py:858-905)."""
    g, opts = scene.grid, scene.opts
    if state.u.dim() not in (2, 3):
        raise ValueError(f"step_fn: u of shape {tuple(state.u.shape)}; expected "
                         f"(ny, nx+1) or (B, ny, nx+1)")
    batched = state.u.dim() == 3
    if batched:  # before any route is chosen, on every device
        check_batchable(scene)
    js = opts.semantics == Semantics.JS
    u_enter, v_enter = state.u, state.v
    u, v = u_enter, v_enter
    if js and opts.extrapolate:
        # The JS extrapolated initial guess (index.html:263-270), with
        # u_prev the previous converged field (JAX piso.py:838-847).
        nonzero = state.step > 0
        u = torch.where(nonzero, 2.0 * u - state.u_prev, u)
        v = torch.where(nonzero, 2.0 * v - state.v_prev, v)
    u_old, v_old = u, v
    inlet = ramped_inlet(opts, state)
    if not opts.substeps_adaptive and opts.substeps_init == 1:
        # Statically one substep: the carried counter is pinned to the
        # count run, so the substeps sum to one dt (JAX piso.py:858-866).
        substeps, n_sub, dt_sub = torch.ones_like(state.substeps), 1, state.dt
    else:
        substeps = state.substeps
        n_sub = trace.read_host(substeps)  # the step's one host read of its count
        dt_sub = state.dt / substeps.to(state.dt.dtype)
    executed = substeps
    fused_red = (not batched and _use_fused_substep(scene)
                 and opts.outer_corrector_rounds == 0)
    entry = (u_old, v_old) if fused_red else None
    p, pp = state.p, state.p_prime
    res_p = red = None
    for _ in range(n_sub):
        u, v, p, pp, err, extras = piso_substep(scene, u, v, p, pp, dt_sub,
                                                state.nu, inlet, entry=entry)
        # JS reports the max residual over the substeps (index.html:288-293),
        # Rust the last substep's (model.rs:326).
        res_p = torch.maximum(res_p, err) if js and res_p is not None else err
        red = extras if extras is not None else red
    if red is not None:
        res_u, res_v, max_vel = red
    else:
        last2 = (-2, -1)  # per scene on a batch
        res_u = torch.amax(torch.abs(u - u_old), dim=last2)
        res_v = torch.amax(torch.abs(v - v_old), dim=last2)
        max_vel = torch.maximum(torch.amax(torch.abs(u), dim=last2),
                                torch.amax(torch.abs(v), dim=last2))
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


def make_step(scene: Scene):
    """state -> (state, diagnostics)."""
    return functools.partial(step_fn, scene)


def make_run(scene: Scene, n_steps: int):
    """n steps in a Python loop (the JAX package's lax.scan):
    state -> (state, StepDiagnostics of (n_steps,) tensors, or (n_steps,
    B) on a batched state)."""
    def run(state: State):
        diags = []
        for _ in range(n_steps):
            state, d = step_fn(scene, state)
            diags.append(d)
        return state, StepDiagnostics(*(torch.stack(x) for x in zip(*diags)))

    return run
