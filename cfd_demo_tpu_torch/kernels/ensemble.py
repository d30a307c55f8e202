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
bytes. Two forms, the same bits and counts; kernels.cluster ``plan``
chooses one before each launch. The cluster form
(``ensemble_cluster_kernel``) runs one thread-block cluster of C CTAs a
scene on csrc/cluster.cuh's machinery (the rounds kernel's): each CTA
runs the predictor on its slab of rows, the solve with p' in the
cluster's shared memory (each sweep's max and edge rows pushed by
``st.async`` onto the receivers' mbarriers; SOR a red and a black half
in place, each ending in that exchange), the corrector, the outer rounds
and the BCs, with u, v, p and the divergence in L2; C is the fewest
waves of the shortest strips on the card's own admission (2 CTAs a scene
for 64 scenes of 256x96, 6 for 16, 14 for 8 of 800x264). The block form
(``ensemble_substep_kernel``) runs one block of 1024 threads a scene, p'
in its shared memory, a ``__syncthreads()`` barrier and a block max a
sweep, for the scenes within its gate (:func:`substep_batch_fits`, both
p' buffers in one block: up to 29,039 cells) that no cluster takes.

The TPU gate, a VMEM bound, is not carried over. The port's route test
is :func:`substep_batch_takes`: whether ``plan`` gives the batch a form.
Any other batch takes the solver's plain batched substep with the
batched solve kernel (kernels.jacobi_batch), as the JAX package takes
its vmapped substep with ``jacobi_pallas_batch`` beyond its gate; a SOR
batch there (beyond the block form's gate) takes the plain masked
``sor``, as the JAX package vmaps ``sor``. The JAX package sends a SOR
batch to its kernel only at B <= 16 (piso.py:624-632), a TPU reading
that is not carried over: chip_smoke.py times the SOR form against the
plain batched SOR at B = 16 and 64 (PERF.md).

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
from .cluster import block_fits, plan
from .jacobi import _multipliers
from .sor import _coefficients


def substep_batch_fits(grid) -> bool:
    """Whether the block form takes ``grid``: both p' buffers of a scene
    in one block's shared memory (kernels.cluster ``block_fits``)."""
    return block_fits(grid.ny, grid.nx)


def substep_batch_takes(scene, batch: int, device) -> bool:
    """The route test: whether :func:`substep_batch` takes a batch of
    ``batch`` scenes of ``scene`` on ``device``: a Jacobi or red/black SOR
    batch to which kernels.cluster ``plan`` gives a form. On the CPU the
    shape decides: the wrapper runs its plain version there."""
    g, solver = scene.grid, scene.params.pressure_solver
    if solver not in (PressureSolver.JACOBI, PressureSolver.SOR):
        return False
    sor = solver == PressureSolver.SOR
    if sor and scene.opts.sor_ordering != "redblack":
        return False
    return plan("substep_batch", batch, g.ny, g.nx, device, sor=sor) is not None


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


def _launch(u, v, p, pp0, dt_sub, nu, inlet, scene, sor: bool, form, ctas):
    """Check the inputs and launch the kernel on CUDA tensors in the form
    kernels.cluster ``plan`` gives (``form`` and ``ctas`` its override);
    None on CPU tensors. Returns the outputs and whether the cluster form
    ran."""
    g, opts = scene.grid, scene.opts
    check_batchable(scene)
    if u.dim() != 3:
        raise ValueError(f"substep_batch takes (B, ny, nx+1) u, got {tuple(u.shape)}")
    B, ny, nx = u.shape[0], g.ny, g.nx
    route = plan("substep_batch", B, ny, nx, u.device, sor=sor, form=form, ctas=ctas)
    if route is None:
        raise ValueError(f"substep_batch: a {nx}x{ny} scene does not fit one block's shared "
                         f"memory (substep_batch_fits); beyond it only the Jacobi cluster "
                         f"form runs, where a cluster holds the scene and the card admits it")
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
    cluster = route.form == "cluster"
    with torch.cuda.device(u.device):
        if cluster:
            check(lib.cfd_substep_batch_cluster(*args, route.ctas, stream_of(u)),
                  f"substep_batch (cluster form, {route.ctas} CTAs a scene)")
        else:
            check(lib.cfd_substep_batch(*args, stream_of(u)), "substep_batch")
    return (u_out, v_out, p_out, pp, err, counts), cluster


@traced("cfd.kernel.substep_batch")
def substep_batch(u, v, p, pp0, dt_sub, nu, inlet, scene, form: str | None = None,
                  ctas: int | None = None):
    """One substep of every scene: ``u`` (B, ny, nx+1); ``v``, ``p``,
    ``pp0`` (BC-consistent) (B, ny, nx); ``dt_sub``, ``nu``, ``inlet``
    (B,) tensors or scalars. Returns (u, v, p, p', err (B,), counts
    (B, 2) int32: outer rounds and solver iterations each scene ran). A
    SOR scene goes to :func:`substep_batch_sor`, which counts its own
    launches. ``form`` ("cluster" or "block") and ``ctas`` override
    kernels.cluster ``plan``'s choice of form, to hold the two against
    each other; where ``plan`` gives the batch no form, the call raises.
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
