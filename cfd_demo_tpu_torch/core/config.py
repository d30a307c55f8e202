"""Scene / solver configuration (copy of ``cfd_demo_tpu/core/config.py``).

This module is a copy of the JAX package's jax-free config (the code
is identical; three comment lines name paths differently):
importing ``cfd_demo_tpu.core.config`` would run ``cfd_demo_tpu/__init__``,
which imports jax, and this package never imports jax. The two copies
are held equal field by field by ``tests/test_torch_config.py``. The
text below is the original docstring; "jit" and "static argument" read
as "the step closure" in this package.

The reference (TSultanov/cfd-demo) implements its 2D incompressible
Navier-Stokes "playground" twice with slightly different numerical
constants and feature sets:

* Rust desktop app  — the reference's src/model.rs (SimulationParams at
  model.rs:14-21 with defaults at :44-55, Grid at :122-131, enums at
  :143-159).
* JavaScript twin   — the reference's index.html (scene constants at
  index.html:107-117, schemes incl. QUICK :471, SOR :741, multigrid
  :775, tracers :1472).

This module is a brand-new design: a single frozen, hashable config
object that is passed as a *static* argument to jit-compiled step
functions, so that changing grid shape / scheme / solver recompiles,
while runtime scalars (dt, viscosity, inlet velocity) travel in the
device-resident state pytree and can change without recompilation.

``Semantics`` selects which of the two reference implementations the
step reproduces (they differ in ramp length, CFL number, Jacobi
relaxation/tolerance, convecting-velocity averaging, PISO outer loop,
extrapolation and substep adaptation). See docs/SPEC.md for the exact
per-mode behavior and documented deviations.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Optional, Tuple


class VelocityScheme(enum.Enum):
    """Convection face-reconstruction scheme.

    FIRST / SECOND mirror the Rust enum VelocityScheme
    (model.rs:143-146); QUICK exists only in the JS twin
    (index.html:471-549).
    """

    FIRST = "first"
    SECOND = "second"
    QUICK = "quick"


class PressureSolver(enum.Enum):
    """Pressure-correction solver.

    JACOBI mirrors model.rs:150-152 / index.html:796-839.
    SOR and MULTIGRID exist only in the JS twin (index.html:741-795).
    Our SOR is a red/black variant (the JS lexicographic in-place sweep
    is inherently sequential and does not map to the VPU); see
    docs/SPEC.md.
    """

    JACOBI = "jacobi"
    SOR = "sor"
    MULTIGRID = "multigrid"
    # Addition beyond the reference (docs/SPEC.md item 12): production
    # projection -- BC-aware damped-Jacobi-smoothed V-cycles with a
    # divergence-calibrated exit (max|residual| <= projection_div_tol /
    # dt bounds the post-correction max|div(u)|). The parity MULTIGRID
    # reproduces the JS kit faithfully, whose residual-units exit never
    # satisfies the Rust outer tolerance on large scenes (docs/PERF.md);
    # this mode is the deliberate deviation that fixes it.
    MG_PRODUCTION = "mg-production"
    # Addition beyond the reference (docs/SPEC.md item 13): EXACT
    # pressure projection by fast diagonalization (ops/fdm.py). The
    # correction operator is separable (obstacles enter through the
    # velocity masks only, exactly as in the reference's Jacobi,
    # model.rs:733-824), so the direct solve is two small dense
    # eigenbasis matmuls per side -- pure MXU work in ONE fused
    # dispatch, no iteration, no convergence knobs. The idiomatic TPU
    # direct solver for small/medium grids; O(N^1.5) flops passes
    # O(N * iters) stencil work beyond ~4096 per side.
    FDM = "fdm"


class InletProfile(enum.Enum):
    """Inlet velocity profile (model.rs:156-159, index.html:884-893).

    PARABOLIC_UPPER is an addition beyond the reference (docs/SPEC.md):
    a parabola over the upper half-height only, zero below -- the
    standard sudden-expansion inlet of the backward-facing step
    validation case (expansion ratio 2; apps/backstep.py)."""

    UNIFORM = "uniform"
    PARABOLIC = "parabolic"
    PARABOLIC_UPPER = "parabolic-upper"


class Semantics(enum.Enum):
    """Which reference implementation's numerical constants to follow."""

    RUST = "rust"  # model.rs semantics
    JS = "js"      # index.html semantics


class FlowCase(enum.Enum):
    """Boundary-condition family.

    CHANNEL is the reference's only case (inlet left, outlet right,
    no-slip walls). CAVITY (lid-driven: moving top lid at
    target_inlet_velocity, all walls closed, all-Neumann pressure with
    a pinned corner cell) is a new capability for BASELINE.json
    config 2.
    """

    CHANNEL = "channel"
    CAVITY = "cavity"


@dataclasses.dataclass(frozen=True)
class Cylinder:
    """Circular obstacle (model.rs:135-139)."""

    center_x: float
    center_y: float
    radius: float


@dataclasses.dataclass(frozen=True)
class Box:
    """Axis-aligned rectangular obstacle (new: BASELINE.json config 4,
    'flow past a square obstacle'). Defined by center and half-extents."""

    center_x: float
    center_y: float
    half_w: float
    half_h: float


@dataclasses.dataclass(frozen=True)
class Grid:
    """Uniform staggered MAC grid (model.rs:122-131).

    Pressure lives on nx*ny cell centers, u on (nx+1)*ny vertical
    faces, v on nx*(ny+1) horizontal faces (model.rs:161-165). Arrays
    in this framework are shaped (rows=y, cols=x) so that the x axis
    maps onto TPU vector lanes.
    """

    nx: int
    ny: int
    lx: float
    ly: float
    obstacles: Tuple[object, ...] = ()  # Cylinder | Box

    @property
    def dx(self) -> float:
        return self.lx / self.nx

    @property
    def dy(self) -> float:
        return self.ly / self.ny

    @property
    def shape_p(self) -> Tuple[int, int]:
        return (self.ny, self.nx)

    @property
    def shape_u(self) -> Tuple[int, int]:
        return (self.ny, self.nx + 1)

    @property
    def shape_v(self) -> Tuple[int, int]:
        """Stored v shape. The reference stores nx*(ny+1) v faces; the
        top face row j=ny is identically zero for all time (set by the
        BCs every substep, never updated elsewhere), so the TPU layout
        stores only rows 0..ny-1 -- every field then has exactly ny
        rows and shards evenly over the row mesh axis. Use
        ``State.v_full`` for the reference-shaped array."""
        return (self.ny, self.nx)

    @property
    def obstacle(self) -> Optional[object]:
        return self.obstacles[0] if self.obstacles else None


@dataclasses.dataclass(frozen=True)
class SimulationParams:
    """User-settable runtime parameters (model.rs:14-21, defaults :44-55).

    These are *hot-swappable* mid-run (model.rs:1250-1257): scalars are
    carried in the state pytree, enums are static jit arguments.
    """

    dt: float = 0.005
    viscosity: float = 1e-6
    target_inlet_velocity: float = 1.0  # lid speed in CAVITY flow
    velocity_scheme: VelocityScheme = VelocityScheme.FIRST
    inlet_profile: InletProfile = InletProfile.UNIFORM
    pressure_solver: PressureSolver = PressureSolver.JACOBI
    flow_case: FlowCase = FlowCase.CHANNEL


@dataclasses.dataclass(frozen=True)
class SolverOptions:
    """Numerical constants of the pressure/PISO iteration.

    Defaults depend on ``Semantics``; use :func:`solver_options_for`.
    Citations: Rust constants model.rs:735-737 (omega/tol/iters),
    :696 (20 outer corrector rounds), :721 (outer exit tol), :269
    (ramp 100), :885 (CFL 0.2), :372 (dt growth 1.1). JS constants
    index.html:799-800 (omega 0.7 / tol 1e-6), :184 (50 iters), :744
    (SOR omega 1.7), :789 (3 V-cycles), :162 (ramp 1000), :1337
    (CFL 0.5), :353 (growth 1.1), :310-317 (substeps 1..20 adaptive).
    """

    semantics: Semantics = Semantics.RUST
    jacobi_omega: float = 0.75
    jacobi_tol: float = 1e-4
    jacobi_iters: int = 50
    sor_omega: float = 1.7
    # "redblack" (the parallel redesign, every device path) or
    # "lexicographic" (the JS twin's exact in-place sweep order,
    # index.html:747-760 -- inherently sequential, honored by the
    # NumPy oracle only; docs/SPEC.md deviation 4 records the measured
    # gap between the two orderings).
    sor_ordering: str = "redblack"
    mg_cycles: int = 3
    mg_pre_smooth: int = 5
    mg_post_smooth: int = 5
    mg_coarse_smooth: int = 10
    mg_coarsest: int = 4
    # PressureSolver.MG_PRODUCTION knobs (addition, docs/SPEC.md item
    # 12): V-cycles run until max|residual| <= projection_div_tol /
    # dt_sub (bounding post-correction max|div(u)| by
    # projection_div_tol), at most mgp_max_cycles; mgp_smooth damped-
    # Jacobi sweeps (omega = jacobi_omega) pre/post at every level.
    projection_div_tol: float = 1e-3
    mgp_smooth: int = 3
    mgp_max_cycles: int = 30
    # > 0 adds a relative exit: cycles stop once max|residual| falls to
    # mgp_rtol x the warm-start residual (combined as
    # max(abs_tol, rtol * r0) -- whichever is reached first wins).
    # Multigrid contracts the residual by a ~constant factor per
    # V-cycle, so this makes the cycle count resolution-independent;
    # the pure-absolute exit (rtol = 0, default) needs ever more
    # cycles as dx shrinks because the residual scale grows ~1/dx^2
    # while projection_div_tol stays fixed (docs/PERF.md).
    mgp_rtol: float = 0.0
    # Noise-floor exit: the f32 evaluation of max|rhs - A p| cannot
    # resolve below ~eps * (denom * max|p| + max|rhs|) (measured 1.4-
    # 1.8x that formula across grids/scales), and at fine resolutions
    # that floor sits ABOVE the absolute divergence-calibrated
    # tolerance (8192^2: tol_r = 0.5 vs a floor of several), where the
    # mgp_max_cycles cap would otherwise bind every solve for zero
    # accuracy gain. mgp_floor > 0 widens the exit to
    # max(tol_r, mgp_floor * eps * (denom * max|p| + max|rhs|)),
    # recomputed each cycle -- i.e. stop once the residual is within a
    # small multiple of its own rounding noise. 0 disables.
    mgp_floor: float = 4.0
    # MG_PRODUCTION hierarchy. "aligned": cell-centered, BC-folded
    # coarse levels with a distance-aware outlet fold and an exact
    # fast-diagonalization (ops.fdm) coarse solve -- measured
    # ~0.10-0.27 residual contraction per V-cycle. "legacy": the
    # JS-kit vertex-style transfers ((n+1)//2 coarsening,
    # index.html:1372-1421); on EVEN grid sizes (every production
    # scene) the vertex coarse boundary lands one cell inside the
    # domain, so the coarse correction is pinned to zero at interior
    # points and contraction stalls at ~0.76/cycle -- but its
    # whole-V-cycle Pallas kernel runs the entire solve in ONE launch,
    # which wins while the scene is launch-latency-bound. "auto"
    # (default): legacy+Pallas below ~2M cells on TPU, aligned
    # otherwise (measured crossover, docs/PERF.md item 12). Both
    # schemes satisfy the same exit contract; only cycle counts and
    # rounding differ.
    mgp_scheme: str = "auto"
    # > 0: run EXACTLY this many V-cycles per solve instead of the
    # adaptive exit -- a deterministic, data-independent schedule. In
    # differentiable mode this enables the O(1)-memory fast adjoint
    # (ops.poisson.fixed_linear_adjoint): the fixed-cycle solve is
    # linear in (p'0, rhs), so the backward pass is the transposed
    # cycle recursion with NO stored iterates and a Pallas-eligible
    # forward. 0 (default): the adaptive divergence-calibrated exit.
    mgp_fixed_cycles: int = 0
    # aligned-hierarchy levels at or below this many cells per side
    # stop recursing and solve exactly on the MXU (ops.fdm). 96
    # measured 10% faster than 48 at 8192^2 (one less latency-bound
    # level), flat at 4096^2 (docs/PERF.md item 12).
    mgp_coarse_stop: int = 96
    # PressureSolver.FDM eigenbasis matmul precision: "highest"
    # (6-pass f32 emulation, residual ~1e-6 relative -- the exactness
    # contract) or "high" (3-pass, ~1.5e-5 relative, ~2x faster
    # apply -- still orders below any iterative exit).
    fdm_precision: str = "highest"
    outer_corrector_rounds: int = 20  # Rust only (model.rs:696); JS has 0
    outer_corrector_tol: float = 1e-4  # model.rs:721
    ramp_up_steps: int = 100
    cfl: float = 0.2
    dt_growth_cap: float = 1.1
    substeps_init: int = 1
    substeps_max: int = 1  # JS adapts 1..20 (index.html:310-317)
    substeps_adaptive: bool = False
    substep_tolerance: float = 1e-3  # index.html:308
    extrapolate: bool = False  # JS u <- 2u - u_prev (index.html:263-270)
    residual_dt_scaling: bool = False  # index.html:338-350
    residual_dt_tol: float = 1e-3
    # Exact early exit (lax.while_loop) vs fixed-trip masked updates
    # (lax.scan). Both produce identical fields; masked mode is
    # vmap-friendly and has deterministic cost.
    early_exit: bool = True
    # Pressure-solve implementation: "jnp" (exact reference semantics,
    # per-iteration convergence checks), "pallas" (fused K-iteration
    # VMEM kernel; convergence checked every K iterations), or "auto"
    # (default): pallas on TPU at >=2M cells (ties XLA at 2048^2 and
    # wins 4-10x above), jnp below (docs/PERF.md).
    pressure_impl: str = "auto"
    # Iterations fused per Pallas Jacobi launch; 0 = auto (10, or 25 on
    # >= 8192^2 grids where halving the launch count beats the wider
    # halo's redundant compute -- docs/PERF.md).
    pallas_fuse_k: int = 0
    pallas_block_rows: int = 256
    # Fused predictor+divergence / corrector+BC+reduction Pallas passes
    # (kernels.substep_pallas): "auto" enables them on TPU for f32
    # scenes at >= 2M cells (single-chip jit only -- GSPMD-sharded runs
    # must use "jnp"); "pallas"/"jnp" force. The fused passes share the
    # stencil expressions with the XLA path (ops.stencil.StencilCtx),
    # so the fields match to ~1 ulp.
    substep_impl: str = "auto"
    # Rust outer corrector rounds implementation (model.rs:696-724):
    # "jnp" runs each round's corrector + recompute_divergence as XLA
    # passes between the Jacobi launch chains; "pallas" fuses them into
    # ONE corrector+divergence launch per round
    # (kernels.substep_pallas.correct_div_pallas); "auto" picks by
    # measurement (docs/PERF.md: XLA's fused glue wins at 2048^2 where
    # the round kernel's window DMA exceeds the glue cost).
    rounds_impl: str = "auto"
    # Reverse-mode-differentiable step (capability beyond the
    # reference -- no CPU/CUDA analog exists in TSultanov/cfd-demo):
    # every convergence loop runs as a FIXED-trip lax.scan with the
    # same masked-update body (fields identical to the masked
    # while_loop; lax.while_loop has no reverse-mode rule), and all
    # Pallas kernels are bypassed (no VJPs) -- so jax.grad flows
    # through whole rollouts. Requires early_exit=False,
    # outer_corrector_rounds == 0 and a non-adaptive substep count
    # (static counts are unrolled; validated in make_scene).
    # make_run rematerializes each step
    # (jax.checkpoint), so backward memory is one step's activations
    # (~iters fields), not the rollout's. See the JAX package's
    # optimize app and tests/test_diff.py.
    differentiable: bool = False


def solver_options_for(semantics: Semantics, **overrides) -> SolverOptions:
    """Reference-faithful solver constants for a semantics mode."""
    if semantics == Semantics.RUST:
        base = dict(
            semantics=Semantics.RUST,
            jacobi_omega=0.75,
            jacobi_tol=1e-4,
            jacobi_iters=50,
            outer_corrector_rounds=20,
            ramp_up_steps=100,
            cfl=0.2,
            substeps_init=1,
            substeps_max=1,
            substeps_adaptive=False,
            extrapolate=False,
            residual_dt_scaling=False,
        )
    else:
        base = dict(
            semantics=Semantics.JS,
            jacobi_omega=0.7,
            jacobi_tol=1e-6,
            jacobi_iters=50,
            outer_corrector_rounds=0,
            ramp_up_steps=1000,
            cfl=0.5,
            substeps_init=5,
            substeps_max=20,
            substeps_adaptive=True,
            extrapolate=True,
            residual_dt_scaling=False,
        )
    base.update(overrides)
    return SolverOptions(**base)


def default_grid() -> Grid:
    """The Rust app's default scene: 800x264 channel with a cylinder
    (src/app.rs:33-53: nx=800, ny=264, Lx=30, Ly=10, r=0.75 at
    (Lx/4, Ly/2))."""
    return Grid(
        nx=800, ny=264, lx=30.0, ly=10.0,
        obstacles=(Cylinder(center_x=30.0 / 4.0, center_y=10.0 / 2.0, radius=0.75),),
    )


def default_js_grid() -> Grid:
    """The JS twin's default scene (index.html:107-117)."""
    return Grid(
        nx=400, ny=132, lx=30.0, ly=10.0,
        obstacles=(Cylinder(center_x=30.0 / 4.0, center_y=10.0 / 2.0, radius=0.75),),
    )


def cavity_grid(n: int) -> Grid:
    """Lid-driven cavity at n x n (BASELINE.json config 2)."""
    return Grid(nx=n, ny=n, lx=1.0, ly=1.0, obstacles=())
