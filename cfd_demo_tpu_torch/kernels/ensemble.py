"""The whole substep of every scene of a batch in one CUDA launch
(↔ cfd_demo_tpu/kernels/ensemble_pallas.py).

``substep_batch`` replaces ``substep_batch_pallas`` (ensemble_pallas.py:322,
body ``_kernel_sub`` :241, in-kernel solver ``make_jacobi_solve`` :69),
csrc/ensemble.cu, for Rust semantics, FIRST upwinding, the Jacobi solver
and CHANNEL flow; ``substep_batch_sor`` is the same kernel with the
red/black SOR solve ``make_sor_solve`` (ensemble_pallas.py:152-238,
omega = ``sor_omega``, the multipliers of :174-179). For each scene: the
predictor, the divergence, a do-while solve warm-started from the
scene's p' that exits at the exact iteration its own error drops below
``jacobi_tol``, the corrector, then up to ``outer_corrector_rounds``
rounds of divergence, warm-started solve and corrector while the error
stays at or above ``outer_corrector_tol``, then the BCs. Every scene
runs its own trip counts, so its fields equal an unbatched early-exit
run of that scene (tests/test_sharding.py:167-173).

An ensemble scene is small (24,576 cells at the app's 256x96) and a
substep is a thousand or so sweeps, each needing the whole field of the
last: what bounds it is the exchange a sweep (a barrier and a max), not
bytes. Two forms, the same bits and counts:

- **The cluster form** (``ensemble_cluster_kernel``): one thread-block
  cluster of C CTAs of 1024 threads per scene, on csrc/cluster.cuh's
  machinery (the rounds kernel's): each CTA runs the predictor on its
  slab of rows, the divergence, the solve with p' in the cluster's
  shared memory (ar * rhs beside it where it fits, a thread's 4-column
  strip of rows in registers, each sweep's max and edge rows pushed by
  ``st.async`` onto the receivers' mbarriers), the corrector, the outer
  rounds and the BCs; u, v, p and the divergence stay in L2. SOR runs a
  red and a black half in place, each ending in that exchange; its err
  is the max over both halves. C comes from kernels.cluster
  ``cluster_ctas`` on the card's own admission (the fewest waves of the
  shortest strips), so a batch fills the card's 132 SMs where one block
  a scene filled B of them: 2 CTAs a scene for 64 scenes of 256x96, 6
  for 16 (PERF.md).
- **The block form** (``ensemble_substep_kernel``), kept to compare with
  and for scenes inside its gate that the pick gives no cluster (wider
  than 1024 columns, or a card that admits no such cluster): one block
  of 1024 threads per scene, p' in its shared memory, a
  ``__syncthreads()`` barrier and a block max a sweep. Its gate is
  :func:`substep_batch_fits`, the two p' buffers in one block's shared
  memory (up to 29,039 cells).

The TPU gate, a VMEM bound, is not carried over. The port's route test
is :func:`substep_batch_takes`: a batch the block form holds, or a
Jacobi batch the cluster form holds (kernels.cluster ``cluster_fits``:
up to 1024 columns and a plan with ar * rhs on chip, such as the
reference's own 800x264 grid at 14 CTAs a scene) on a card that admits
such a cluster. Any other batch takes the solver's plain batched substep
with the batched solve kernel (kernels.jacobi_batch), as the JAX package
takes its vmapped substep with ``jacobi_pallas_batch`` beyond its gate;
a SOR batch there takes the plain masked ``sor``, as the JAX package
vmaps ``sor``. The SOR form keeps the two-buffer gate. The JAX package
sends a SOR batch to its kernel only at B <= 16 (piso.py:624-632), a TPU
reading that is not carried over: chip_smoke.py times the SOR form
against the plain batched SOR at B = 16 and 64 (PERF.md).

Both versions also return how many outer rounds and solver iterations
each scene ran, so a check can hold the kernel's exits against the plain
version's.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core.config import InletProfile, PressureSolver, Semantics, VelocityScheme
from ..core.unported import BATCHES, OTHER_SOLVERS, unported
from ..ops.bc import check_channel
from ..trace import traced
from ._build import check, load, mask_ptrs, on_cpu, scene_scalars, stream_of
from .cluster import check_route, cluster_fits, pick_ctas, route_ctas
from .jacobi import _multipliers
from .sor import _coefficients

# Shared memory one block may opt in to on the H100 (227 KB), less the
# kernel's 33-float reduction scratch.
SMEM_OPTIN_BYTES = 232_448
_SMEM_STATIC = 33 * 4


def substep_batch_fits(grid) -> bool:
    """Whether the whole-substep kernel takes ``grid``: both p' buffers
    of a scene in one block's shared memory (up to 29,039 cells)."""
    return (grid.nx >= 3 and grid.ny >= 3
            and 2 * 4 * grid.ny * grid.nx + _SMEM_STATIC <= SMEM_OPTIN_BYTES)


def substep_batch_takes(scene, batch: int, device) -> bool:
    """The route test: whether :func:`substep_batch` takes a batch of
    ``batch`` scenes of ``scene`` on ``device``. A Jacobi or red/black SOR
    batch the block form holds (:func:`substep_batch_fits`), or a Jacobi
    batch the cluster form holds (kernels.cluster ``cluster_fits``) on a
    card that admits such a cluster (:func:`substep_batch_ctas`). On the
    CPU the shape decides: the wrapper runs its plain version there."""
    g, solver = scene.grid, scene.params.pressure_solver
    if solver == PressureSolver.SOR:
        return scene.opts.sor_ordering == "redblack" and substep_batch_fits(g)
    if solver != PressureSolver.JACOBI:
        return False
    if substep_batch_fits(g):
        return True
    if not cluster_fits(g.ny, g.nx):
        return False
    return (torch.device(device).type != "cuda"
            or substep_batch_ctas(batch, g.ny, g.nx, device) is not None)


def check_batchable(scene):
    """Batches step Rust semantics with FIRST faces, a UNIFORM inlet and
    one substep, what the whole-substep kernel computes; JS semantics
    (its zero p' and adaptive substeps), SECOND/QUICK faces, the
    parabolic inlets and more substeps raise on every route, CPU and
    card alike (queue 1 item 9), and CAVITY flow before them (item 6b:
    kernels 12 and 20 are built for the channel alone)."""
    params, opts = scene.params, scene.opts
    check_channel(params.flow_case, " in a batch")
    if opts.semantics != Semantics.RUST:
        raise unported("a batched JS-semantics scene", BATCHES)
    if params.velocity_scheme != VelocityScheme.FIRST:
        raise unported(f"a batched scene with {params.velocity_scheme.value} faces",
                       BATCHES)
    if params.inlet_profile != InletProfile.UNIFORM:
        raise unported(f"a batched scene with the {params.inlet_profile.value} "
                       f"inlet", BATCHES)
    if opts.substeps_adaptive or opts.substeps_init != 1:
        raise unported("a batched scene with more than one substep", BATCHES)


def substep_batch_plain(u, v, p, pp0, dt_sub, nu, inlet, scene):
    """The solver's plain batched substep (solver.piso._substep_jnp) with
    the plain masked Jacobi or SOR: each scene freezes at its own
    iteration and outer round, with no host read on the card."""
    from ..solver.piso import _substep_jnp  # the solver imports this module
    plain = dataclasses.replace(
        scene, opts=dataclasses.replace(scene.opts, pressure_impl="jnp"))
    return _substep_jnp(plain, u, v, p, pp0, dt_sub, nu, inlet)


def substep_batch_ctas(batch: int, ny: int, nx: int, device, sor: bool = False):
    """The CTAs a scene of the cluster form (``sor``: its SOR solve) for
    a batch of ``batch`` (ny, nx) scenes on ``device`` (kernels.cluster
    pick_ctas on the card's admission), or None where it takes no
    cluster: the block form runs. Needs the card for a scene a cluster
    holds."""
    return pick_ctas("cfd_substep_batch_cluster_admit", batch, ny, nx, device, int(sor))


def _launch(u, v, p, pp0, dt_sub, nu, inlet, scene, sor: bool, form, ctas):
    """Check the inputs and launch the kernel on CUDA tensors, in
    ``form`` (None: the cluster form where :func:`substep_batch_ctas`
    picks a cluster, else the block form, which beyond
    :func:`substep_batch_fits` raises; "cluster" or "block"), ``ctas``
    CTAs a scene (None: that pick); None on CPU tensors. Returns the
    outputs and whether the cluster form ran."""
    g, opts = scene.grid, scene.opts
    check_batchable(scene)
    block = substep_batch_fits(g)
    if not block and (sor or form == "block" or not cluster_fits(g.ny, g.nx)):
        raise ValueError(f"substep_batch: a {g.nx}x{g.ny} scene does not fit one "
                         f"block's shared memory (substep_batch_fits); beyond it only "
                         f"the Jacobi cluster form runs, where kernels.cluster."
                         f"cluster_fits holds the scene")
    check_route("substep_batch", form, "cluster", "block", g.ny, g.nx, ctas)
    if u.dim() != 3:
        raise ValueError(f"substep_batch takes (B, ny, nx+1) u, got {tuple(u.shape)}")
    B, ny, nx = u.shape[0], g.ny, g.nx
    shapes = {"u": (u, (B, ny, nx + 1)), "v": (v, (B, ny, nx)),
              "p": (p, (B, ny, nx)), "pp0": (pp0, (B, ny, nx))}
    if on_cpu("substep_batch", shapes):
        return None
    lib = load()
    u_out, v_out = torch.empty_like(u), torch.empty_like(v)
    p_out, pp, rhs = (torch.empty_like(p) for _ in range(3))
    err = torch.empty(B, dtype=torch.float32, device=u.device)
    counts = torch.empty((B, 2), dtype=torch.int32, device=u.device)
    scal = scene_scalars(u.device, B, dt_sub, nu, inlet)
    masks = mask_ptrs(g, opts.semantics, u.device)
    f32 = lambda x: float(np.float32(x))
    if sor:  # (bx, by, br, 1 - omega), omega
        bx, by, br, om, omc = _coefficients(g.dx, g.dy, opts.sor_omega)
        coef = (bx, by, br, omc, om)
    else:
        coef = (*_multipliers(g.dx, g.dy, opts.jacobi_omega), 0.0)
    args = (u.data_ptr(), v.data_ptr(), p.data_ptr(), pp0.data_ptr(),
            scal.data_ptr(), u_out.data_ptr(), v_out.data_ptr(),
            p_out.data_ptr(), pp.data_ptr(), rhs.data_ptr(), err.data_ptr(),
            counts.data_ptr(), *masks, B, ny, nx, f32(g.dx), f32(g.dy),
            f32(g.dx * g.dx), f32(g.dy * g.dy), *coef, int(sor),
            opts.jacobi_iters, opts.jacobi_tol, opts.outer_corrector_rounds,
            opts.outer_corrector_tol)
    # beyond the block form's gate only the cluster form runs: a card that
    # admits no such cluster raises
    c = route_ctas("substep_batch", form if block else "cluster", "block", B, ny, nx,
                   ctas, "cfd_substep_batch_cluster_admit", u.device, int(sor))
    with torch.cuda.device(u.device):
        if c is not None:
            check(lib.cfd_substep_batch_cluster(*args, c, stream_of(u)),
                  f"substep_batch (cluster form, {c} CTAs a scene)")
        else:
            check(lib.cfd_substep_batch(*args, stream_of(u)), "substep_batch")
    return (u_out, v_out, p_out, pp, err, counts), c is not None


@traced("cfd.kernel.substep_batch")
def substep_batch(u, v, p, pp0, dt_sub, nu, inlet, scene, form: str | None = None,
                  ctas: int | None = None):
    """One substep of every scene: ``u`` (B, ny, nx+1); ``v``, ``p``,
    ``pp0`` (BC-consistent) (B, ny, nx); ``dt_sub``, ``nu``, ``inlet``
    (B,) tensors or scalars. Returns (u, v, p, p', err (B,), counts
    (B, 2) int32: outer rounds and solver iterations each scene ran). A
    SOR scene goes to :func:`substep_batch_sor`, which counts its own
    launches. ``form`` None takes the cluster form where
    :func:`substep_batch_ctas` picks a cluster and the block form elsewhere
    within :func:`substep_batch_fits` (beyond it a card that admits no
    such cluster raises); "cluster" and "block" take that form (to hold
    the two against each other). ``ctas`` forces the cluster form's CTAs
    a scene (one of kernels.cluster.CTAS that ``slab_plan`` splits the
    scene over).
    ``.launches`` counts launches of either form, ``.cluster_launches``
    those of the cluster form."""
    solver = scene.params.pressure_solver
    if solver == PressureSolver.SOR:
        return substep_batch_sor(u, v, p, pp0, dt_sub, nu, inlet, scene, form, ctas)
    if solver != PressureSolver.JACOBI:
        raise unported(f"the whole-substep kernel with the {solver.value} solver",
                       OTHER_SOLVERS)
    out = _launch(u, v, p, pp0, dt_sub, nu, inlet, scene, False, form, ctas)
    if out is None:
        return substep_batch_plain(u, v, p, pp0, dt_sub, nu, inlet, scene)
    substep_batch.launches += 1
    substep_batch.cluster_launches += out[1]
    return out[0]


substep_batch.launches = 0
substep_batch.cluster_launches = 0


@traced("cfd.kernel.substep_batch_sor")
def substep_batch_sor(u, v, p, pp0, dt_sub, nu, inlet, scene, form: str | None = None,
                      ctas: int | None = None):
    """:func:`substep_batch` with the red/black SOR solve
    (sor_ordering "redblack"); the counts are (outer rounds, SOR
    iterations) per scene."""
    if scene.params.pressure_solver != PressureSolver.SOR:
        raise ValueError("substep_batch_sor takes a SOR scene, got "
                         f"{scene.params.pressure_solver.value}")
    if scene.opts.sor_ordering != "redblack":
        raise ValueError(f'the whole-substep kernel sweeps red/black, not '
                         f'sor_ordering="{scene.opts.sor_ordering}"')
    out = _launch(u, v, p, pp0, dt_sub, nu, inlet, scene, True, form, ctas)
    if out is None:
        return substep_batch_plain(u, v, p, pp0, dt_sub, nu, inlet, scene)
    substep_batch_sor.launches += 1
    substep_batch_sor.cluster_launches += out[1]
    return out[0]


substep_batch_sor.launches = 0
substep_batch_sor.cluster_launches = 0
