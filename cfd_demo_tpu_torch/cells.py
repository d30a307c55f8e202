"""The port's measured shapes, and where their device time goes.

Fifteen cells, each at full size, from the JAX package's own defaults:

- :func:`reference_scene`: the README quick start, the Rust app's
  800x264 cylinder channel with default parameters and solver options
  (up to 20 outer corrector rounds; the rounds-kernel route);
- :func:`fast_scene`: ``bench.py --mode fast`` at 2048² (a fixed
  50-sweep Jacobi, no outer rounds; the fused route);
- :func:`reference_mode_scene`: ``bench.py --mode reference`` at 2048²
  (the fused route with outer rounds and tolerance exits);
- :func:`production_scene`: ``bench.py --mode production`` at 2048²
  (the fused route with the MG_PRODUCTION projection, aligned V-cycles
  to the divergence tolerance or the f32 noise floor);
- **ensemble 64x256x96**: ``python -m cfd_demo_tpu.apps.ensemble --batch
  64`` (BASELINE config 5), 64 scenes of the app's 256x96 channel, a
  viscosity sweep (the whole-substep kernel's route);
- **ensemble 8x800x264**: the same app with ``--nx 800 --ny 264 --batch
  8``, eight scenes of the reference's grid (beyond one block: the
  whole-substep kernel's cluster form, 14 CTAs a scene on an H100);
- :func:`sor_scene`: ``bench.py --mode sor`` at 2048² (a fixed
  50-iteration red/black SOR, no outer rounds; the fused route with the
  colour-split SOR chain);
- **ensemble 16x256x96 sor**: ``python -m cfd_demo_tpu.apps.ensemble
  --batch 16 --solver sor``, the largest batch the JAX package sends to
  its kernel's SOR form (piso.py:624-632);
- :func:`multigrid_scene`: the production mode's options with the JS
  kit's MULTIGRID solver at 2048² (three vertex V-cycles a step, no
  outer rounds: the fused route, no host read);
- :func:`legacy_production_scene`: ``bench.py --mode production
  --mgp-scheme legacy`` at 2048² (the vertex hierarchy with damped p'-BC
  sweeps, to the same exits as the aligned cycle);
- :func:`js_default_scene`: the JS twin's default scene, the web UI's
  JS mode (400x132, adaptive 5..20 substeps, extrapolation, a zero warm
  start; the rounds-kernel route once a substep);
- :func:`js_quick_scene`: ``bench.py --mode fast``'s grid and fixed
  schedule with JS semantics, QUICK faces and the PARABOLIC inlet, one
  substep (the fused route with those kernel variants);
- :func:`cavity_scene` at 1024²: ``python -m cfd_demo_tpu.apps.cavity
  --n 1024`` (BASELINE config 2, the lid-driven cavity with the app's
  dt 0.002, viscosity 1e-2 and lid 1.0, Rust defaults: up to 20 outer
  rounds; the rounds kernel's CAVITY instance in its slab form, since no
  cluster holds 1024 columns);
- :func:`ghia_cavity_scene` at 1024²: the benchmark's ``cavity_1024``
  configuration (Ghia's Re = 1000: viscosity 1e-3, dt 1e-4, Rust
  defaults), from rest, measured after 3000 steps as its traced run is;
- :func:`cavity_production_scene` at 2048²: ``python -m
  cfd_demo_tpu.apps.cavity --n 2048 --solver mg-production`` (the same
  scene with the production projection: the fused route, aligned
  V-cycles through kernels 7, 8 and 9's CAVITY instances and the
  all-Neumann FDM bottom).

:data:`SHARDED` names the row-sharded paths (shard/step_shmap.py) that
``chip_smoke.py`` runs, each a scene above on a row mesh of n shards
(``make_mesh(n)``: every shard on ``cuda:0`` on one card): 2048² fast
and sor on 4 shards (kernels 1, 11 or 14, and 3), the 800x264 default
scene on 3 (88 rows a shard: kernel 1, kernel 11 with early exits, the
outer rounds) and 2048² FDM on 4. ``--cell`` measures them as the other
cells. All shards on one card show what the tier costs
over the unsharded step, not how it scales.

:func:`fdm_scene` is ``bench.py --mode fdm`` (the exact FDM projection),
a shape without a kernel of its own. ``chip_smoke.py`` drives all but
the reference mode. On a CUDA card,

    python3 -m cfd_demo_tpu_torch.cells [--cell NAME ...] [--out FILE.json]

runs each cell (or the ones named) for a timed rollout after its
warm-up, then 10 more steps under ``torch.profiler``, and prints the
rate, the device time per step by kernel and the device's busy share of
the unprofiled wall time. For the 800x264 scene it also prints how many
outer rounds and Jacobi sweeps the rounds kernel ran in a step, for the
ensembles the mean and the most of those over their scenes in the first
profiled step, for the production scenes how many V-cycles a step
ran, and where the rounds kernel's slab form ran, the speculative sweeps
it dropped over the solves of the profiled steps (``trace.dropped`` and
``trace.rounds``). An ensemble's cell-updates count every scene's cells.
"""
from __future__ import annotations

import argparse
import collections
import json
import subprocess
import sys
import time

import torch

from .core.config import (Cylinder, FlowCase, Grid, InletProfile, PressureSolver,
                          Semantics, SimulationParams, VelocityScheme, cavity_grid,
                          default_grid, default_js_grid, solver_options_for)
from .apps.ensemble import ensemble_scene, ensemble_state
from .kernels import mg, mgp
from .kernels.ensemble import substep_batch, substep_batch_sor
from .kernels.jacobi_batch import jacobi_batch
from .kernels.rounds import solve_correct_rounds
from .kernels.substep import correct_bc, correct_div, predict_div
from .shard import make_mesh, make_run_shmap, make_step_shmap, shard_state
from .solver.piso import (_substep_batched, _use_fused_substep, _warm_start,
                          make_run, make_scene, make_step, ramped_inlet)
from . import trace


def reference_scene():
    """The README quick start: the Rust app's 800x264 cylinder channel
    with default parameters and solver options."""
    return make_scene(default_grid())


def _bench_grid(n):
    """bench.py's grid (bench.py:78-80)."""
    return Grid(nx=n, ny=n, lx=30.0, ly=30.0,
                obstacles=(Cylinder(7.5, 15.0, 0.75),))


# bench.py --mode fast's schedule (bench.py:78-86): a fixed 50-sweep
# Jacobi, no outer rounds, no host read.
FAST_SCHEDULE = dict(ramp_up_steps=10, jacobi_tol=0.0, jacobi_iters=50,
                     outer_corrector_rounds=0, early_exit=False)


def fast_scene(n: int = 2048):
    """bench.py --mode fast (bench.py:78-86)."""
    return make_scene(_bench_grid(n), SimulationParams(dt=0.002, viscosity=1e-4),
                      solver_options_for(Semantics.RUST, **FAST_SCHEDULE))


def reference_mode_scene(n: int = 2048, rounds_impl: str = "auto"):
    """bench.py --mode reference (bench.py:117-120); ``rounds_impl="pallas"``
    runs each outer round's corrector and divergence as one correct_div
    launch."""
    return make_scene(_bench_grid(n), SimulationParams(dt=0.002, viscosity=1e-4),
                      solver_options_for(Semantics.RUST, ramp_up_steps=10,
                                         rounds_impl=rounds_impl))


def js_default_scene():
    """The JS twin's default scene as the web UI's JS mode runs it
    (apps/web/server.py:52-76): default_js_grid(), dt 0.005, viscosity
    1e-6 and solver_options_for(Semantics.JS)."""
    return make_scene(default_js_grid(), SimulationParams(dt=0.005, viscosity=1e-6),
                      solver_options_for(Semantics.JS))


def js_quick_scene(n: int = 2048):
    """bench.py --mode fast's grid and fixed schedule (bench.py:78-86)
    with JS semantics (extrapolation, the zero warm start), QUICK faces
    and the PARABOLIC inlet, the substep count pinned to one."""
    opts = solver_options_for(
        Semantics.JS, ramp_up_steps=10, jacobi_tol=0.0, jacobi_iters=50,
        outer_corrector_rounds=0, early_exit=False, substeps_adaptive=False,
        substeps_init=1, extrapolate=True)
    return make_scene(_bench_grid(n), SimulationParams(
        dt=0.002, viscosity=1e-4, velocity_scheme=VelocityScheme.QUICK,
        inlet_profile=InletProfile.PARABOLIC), opts)


def cavity_scene(n: int = 1024, **opts):
    """The cavity app's scene (cfd_demo_tpu/apps/cavity.py): cavity_grid(n),
    dt 0.002, viscosity 1e-2, lid speed 1.0, Rust semantics with ``opts``
    over its defaults."""
    return make_scene(cavity_grid(n), SimulationParams(
        dt=0.002, viscosity=1e-2, target_inlet_velocity=1.0, flow_case=FlowCase.CAVITY),
        solver_options_for(Semantics.RUST, **opts))


def ghia_cavity_scene(n: int = 1024):
    """The benchmark's cavity_1024 configuration: cavity_grid(n), Ghia's
    Re = 1000 (lid 1.0, viscosity 1e-3) at dt 1e-4, Rust defaults."""
    return make_scene(cavity_grid(n), SimulationParams(
        dt=1e-4, viscosity=1e-3, target_inlet_velocity=1.0, flow_case=FlowCase.CAVITY),
        solver_options_for(Semantics.RUST))


def cavity_production_scene(n: int = 2048, **opts):
    """The cavity app's scene with ``--solver mg-production``
    (cfd_demo_tpu/apps/cavity.py:21-28, apps/common.py:28): MG_PRODUCTION
    with the Rust defaults and ``opts`` over them."""
    return make_scene(cavity_grid(n), SimulationParams(
        dt=0.002, viscosity=1e-2, target_inlet_velocity=1.0, flow_case=FlowCase.CAVITY,
        pressure_solver=PressureSolver.MG_PRODUCTION),
        solver_options_for(Semantics.RUST, **opts))


def cavity_fast_scene(n: int = 2048):
    """The cavity app's scene on bench.py --mode fast's schedule: at 2048²
    the fused route, kernels 1, 2 and 3 in their cavity forms."""
    return cavity_scene(n, **FAST_SCHEDULE)


def production_scene(n: int = 2048):
    """bench.py --mode production (bench.py:87-96)."""
    return make_scene(
        _bench_grid(n),
        SimulationParams(dt=0.002, viscosity=1e-4,
                         pressure_solver=PressureSolver.MG_PRODUCTION),
        solver_options_for(Semantics.RUST, ramp_up_steps=10,
                           outer_corrector_rounds=0))


def sor_scene(n: int = 2048):
    """bench.py --mode sor (bench.py:105-116)."""
    return make_scene(_bench_grid(n), SimulationParams(
        dt=0.002, viscosity=1e-4, pressure_solver=PressureSolver.SOR),
        solver_options_for(Semantics.RUST, **FAST_SCHEDULE))


def fdm_scene(n: int = 2048):
    """bench.py --mode fdm (bench.py:97-104)."""
    return make_scene(_bench_grid(n), SimulationParams(
        dt=0.002, viscosity=1e-4, pressure_solver=PressureSolver.FDM),
        solver_options_for(Semantics.RUST, ramp_up_steps=10,
                           outer_corrector_rounds=0))


def multigrid_scene(n: int = 2048):
    """bench.py --mode production's options (bench.py:87-96) with the JS
    kit's solver, PressureSolver.MULTIGRID, in its place."""
    return make_scene(_bench_grid(n), SimulationParams(
        dt=0.002, viscosity=1e-4, pressure_solver=PressureSolver.MULTIGRID),
        solver_options_for(Semantics.RUST, ramp_up_steps=10,
                           outer_corrector_rounds=0))


def legacy_production_scene(n: int = 2048):
    """bench.py --mode production --mgp-scheme legacy (bench.py:54-60,
    :87-96)."""
    return make_scene(
        _bench_grid(n),
        SimulationParams(dt=0.002, viscosity=1e-4,
                         pressure_solver=PressureSolver.MG_PRODUCTION),
        solver_options_for(Semantics.RUST, ramp_up_steps=10,
                           outer_corrector_rounds=0, mgp_scheme="legacy"))


def sor_ensemble_scene(nx: int = 256, ny: int = 96):
    """The ensemble app's scene with ``--solver sor``."""
    return ensemble_scene(nx, ny, SimulationParams(
        dt=0.004, viscosity=1e-4, pressure_solver=PressureSolver.SOR))


def rounds_args(scene, state):
    """What the rounds route feeds the rounds kernel in the next (first)
    substep from ``state``: ``predict_div``'s u*, v* and rhs of the
    state's fields (JS's extrapolation aside), with p, the warm start
    (zero in JS), dt over the substep count and the inlet."""
    g = scene.grid
    dt_sub = state.dt / state.substeps.to(state.dt.dtype)
    u_star, v_star, rhs = predict_div(
        state.u, state.v, dt_sub, state.nu, g,
        scene.params.velocity_scheme, scene.opts.semantics)
    return (u_star, v_star, state.p, _warm_start(scene.opts, state.p_prime),
            rhs, dt_sub, ramped_inlet(scene.opts, state), scene)


def ensemble_args(scene, state):
    """What the next step from a batched ``state`` feeds the substep:
    (u, v, p, p', dt_sub, nu, inlet, scene)."""
    return (state.u, state.v, state.p, state.p_prime, state.dt, state.nu,
            ramped_inlet(scene.opts, state), scene)


def ensemble_counts(scene, state):
    """(outer rounds, solver iterations) each scene runs in the next step,
    by the route the step takes: an int32 (B, 2) tensor."""
    return _substep_batched(scene, *ensemble_args(scene, state)[:7])[5]


def vertex_levels(ny: int, nx: int, coarsest: int) -> int:
    """Levels of the vertex hierarchy ((n + 1) // 2 a side) down to the
    first at or below ``coarsest`` cells on a side."""
    n = 1
    while ny > coarsest and nx > coarsest:
        ny, nx, n = (ny + 1) // 2, (nx + 1) // 2, n + 1
    return n


def vcycles_launched() -> int:
    """V-cycles the program has run (``trace.vcycles``): MG_PRODUCTION's,
    either scheme, and MULTIGRID's, on any device. The masked loop's
    cycles after its exit are counted: they run and are discarded. A
    cycle on an interior of at most mgp_coarse_stop cells a side runs
    FDM alone and launches no kernel; it counts as a cycle."""
    return trace.vcycles


PROFILED_STEPS = 10
# (scene, warm-up steps, timed steps, batch or None). 55 warm-up steps
# bring the 800x264 scene to where every step runs all its outer rounds.
CELLS = {
    "800x264 default": (reference_scene, 55, 50, None),
    "2048^2 fast": (fast_scene, 5, 100, None),
    "2048^2 reference": (reference_mode_scene, 5, 20, None),
    "2048^2 production": (production_scene, 5, 20, None),
    "ensemble 64x256x96": (ensemble_scene, 20, 50, 64),
    "ensemble 8x800x264": (lambda: ensemble_scene(800, 264), 5, 20, 8),
    "2048^2 sor": (sor_scene, 5, 100, None),
    "ensemble 16x256x96 sor": (sor_ensemble_scene, 20, 50, 16),
    "2048^2 multigrid": (multigrid_scene, 5, 100, None),
    "2048^2 production legacy": (legacy_production_scene, 5, 20, None),
    "400x132 js default": (js_default_scene, 100, 50, None),
    "2048^2 js quick": (js_quick_scene, 5, 100, None),
    "1024^2 cavity": (cavity_scene, 5, 20, None),
    "1024^2 cavity Re 1000": (ghia_cavity_scene, 3000, 200, None),
    # the app's dt grows the 2048^2 flow without bound within ~13 steps
    "2048^2 cavity production": (cavity_production_scene, 2, 5, None),
}
# The sharded paths: name -> (scene, shards, warm-up steps, timed steps).
SHARDED = {
    "2048^2 fast sharded x4": (fast_scene, 4, 5, 100),
    "2048^2 sor sharded x4": (sor_scene, 4, 5, 100),
    "800x264 sharded x3": (reference_scene, 3, 55, 10),
    "2048^2 fdm sharded x4": (fdm_scene, 4, 0, 3),
}


# Kernels each launch of these wrappers runs one of, with the launches
# the wrappers counted: the trace must hold as many. (jacobi_fused_k,
# jacobi_fused_k_res, cc_sweeps and the SOR chains launch kernels that
# others launch too, or several of them a call.)
def _counts(*wrappers):
    return lambda: sum(w.launches for w in wrappers)


TRACED = {"predict_div_tiled_kernel<": _counts(predict_div),
          "correct_bc_fused_kernel<": _counts(correct_bc),
          "correct_div_kernel(": _counts(correct_div),
          "rounds_kernel<": lambda: (solve_correct_rounds.launches
                                     - solve_correct_rounds.cluster_launches
                                     - solve_correct_rounds.slab_launches),
          "rounds_cluster_kernel<": lambda: solve_correct_rounds.cluster_launches,
          "rounds_slab_kernel<": lambda: solve_correct_rounds.slab_launches,
          "ensemble_substep_kernel(": lambda: (
              _counts(substep_batch, substep_batch_sor)()
              - substep_batch.cluster_launches - substep_batch_sor.cluster_launches),
          "ensemble_cluster_kernel<": lambda: (substep_batch.cluster_launches
                                               + substep_batch_sor.cluster_launches),
          "jacobi_batch_kernel(": lambda: (jacobi_batch.launches
                                           - jacobi_batch.cluster_launches),
          "jacobi_batch_cluster_kernel<": lambda: jacobi_batch.cluster_launches,
          "restrict_kernel<": _counts(mgp.jacobi_fused_k_restrict),
          "corr_add_kernel(": _counts(mgp.jacobi_fused_k_corr),
          "vertex_restriction_kernel(": _counts(mg.mg_residual_restrict),
          "vertex_prolong_add_kernel<": _counts(mg.mg_prolong_add)}


def _busy_us(spans):
    """Length of the union of (start, end) intervals."""
    busy, end = 0.0, float("-inf")
    for s, t in sorted(spans):
        if t > end:
            busy += t - max(s, end)
            end = t
    return busy


# Traces taken before device_breakdown gives up on one that lost launches.
TRACE_ATTEMPTS = 3


def device_breakdown(step, state, steps):
    """Device time by kernel over ``steps`` steps under torch.profiler:
    (busy µs per step, [(kernel, µs per step, launches per step)]). A
    first, unrecorded rollout warms the tracer up, and each step waits
    for the device: traces of rollouts that queued many steps ahead of
    the device lost some of their launches. A trace that still misses a
    launch the wrappers counted (why the profiler drops one is not
    known) is taken again, up to TRACE_ATTEMPTS times, and then raises."""
    from torch.profiler import ProfilerActivity, profile, schedule
    for attempt in range(TRACE_ATTEMPTS):
        events = []

        def keep(prof):  # device work: kernels and copies, not the step
            # marker nor the program's spans (trace.py), which the profiler
            # also lays on the device's timeline
            events.extend(e for e in prof.events()
                          if e.device_type == torch.autograd.DeviceType.CUDA
                          and not e.name.startswith(("ProfilerStep", "cfd.")))

        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1),
                     on_trace_ready=keep) as prof:
            for _ in range(2):
                before = {k: count() for k, count in TRACED.items()}
                s = state
                for _ in range(steps):
                    s, _ = step(s)
                    torch.cuda.synchronize()
                prof.step()
        if not events:
            raise RuntimeError("torch.profiler recorded no device activity")
        counted = {k: count() - before[k] for k, count in TRACED.items()}
        lost = [f"the trace holds {sum(kernel in e.name for e in events)} of "
                f"{n} {kernel.rstrip('(')} launches"
                for kernel, n in counted.items()
                if sum(kernel in e.name for e in events) != n]
        if not lost:
            break
        print(f"    trace {attempt + 1}: " + "; ".join(lost), flush=True)
    else:
        raise RuntimeError("; ".join(lost))
    total, calls = collections.Counter(), collections.Counter()
    for e in events:
        total[e.name] += e.time_range.elapsed_us()
        calls[e.name] += 1
    busy = _busy_us([(e.time_range.start, e.time_range.end) for e in events])
    rows = [(name, us / steps, calls[name] / steps) for name, us in total.most_common()]
    return busy / steps, rows


def measure(name, make, warmup, timed, batch, dev, shards=None):
    """One cell: ``shards`` runs the scene's sharded step on that many
    shards (from the unsharded warm-up's state)."""
    scene = make()
    g = scene.grid
    init = (scene.init_state(dev) if batch is None
            else ensemble_state(scene, batch, dev))
    state, _ = make_run(scene, warmup)(init)
    out = {}
    if shards:
        mesh = make_mesh(shards)
        state = shard_state(state, mesh)
        run, step = make_run_shmap(scene, mesh, timed), make_step_shmap(scene, mesh)
    else:
        run, step = make_run(scene, timed), make_step(scene)
    if batch is None and not shards and not _use_fused_substep(scene):
        counts = solve_correct_rounds(*rounds_args(scene, state))[5].tolist()  # the rounds route
        out["rounds_per_step"], out["sweeps_per_step"] = counts
    cycles0 = vcycles_launched()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, diags = run(state)
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    if scene.opts.substeps_adaptive:
        out["substeps_per_step"] = float(diags.substeps.double().mean())
    if scene.params.pressure_solver == PressureSolver.MG_PRODUCTION:
        out["vcycles_per_step"] = (vcycles_launched() - cycles0) / timed
    if not all(bool(torch.isfinite(u).all()) for u in (state.u if shards else [state.u])):
        raise RuntimeError(f"{name}: u is not finite")
    out["steps_per_s"] = timed / sec
    out["cell_updates_per_s"] = (batch or 1) * g.nx * g.ny * timed / sec
    if batch is not None:
        # In the first profiled step, per scene: the mean over the batch,
        # and the most any scene ran (a launch lasts as long as its
        # slowest scene).
        counts = ensemble_counts(scene, state).double()
        out["rounds_per_step"], out["sweeps_per_step"] = counts.mean(dim=0).tolist()
        out["max_rounds"], out["max_sweeps"] = counts.max(dim=0).values.tolist()
    kept = len(trace.rounds), len(trace.dropped)
    busy_us, rows = device_breakdown(step, state, PROFILED_STEPS)
    rounds_kept, dropped_kept = trace.rounds[kept[0]:], trace.dropped[kept[1]:]
    del trace.rounds[kept[0]:], trace.dropped[kept[1]:]
    if dropped_kept:  # the slab form ran: each launch runs 1 + its outer rounds solves
        out["solves"] = len(rounds_kept) + trace.rounds_total(rounds_kept)[0]
        out["dropped_sweeps"] = trace.dropped_total(dropped_kept)
        out["dropped_share_of_solves"] = out["dropped_sweeps"] / out["solves"]
    wall_us = 1e6 * sec / timed
    out["wall_us_per_step"] = wall_us
    out["device_busy_us_per_step"] = busy_us
    out["device_busy_share"] = busy_us / wall_us
    out["kernels"] = [{"name": n, "us_per_step": us, "launches_per_step": c}
                      for n, us, c in rows]
    print(f"{name}: {out['steps_per_s']:.2f} steps/s, "
          f"{out['cell_updates_per_s']:.4e} cell-updates/s; device busy "
          f"{busy_us:.1f} of {wall_us:.1f} us per step "
          f"({100 * busy_us / wall_us:.1f}%)"
          + (f"; {out['rounds_per_step']:g} rounds, {out['sweeps_per_step']:g} "
             f"sweeps per scene" if "sweeps_per_step" in out else "")
          + (f" (at most {out['max_rounds']:g} and {out['max_sweeps']:g})"
             if "max_sweeps" in out else "")
          + (f"; {out['vcycles_per_step']} V-cycles per step"
             if "vcycles_per_step" in out else "")
          + (f"; {out['substeps_per_step']:g} substeps per step (rounds and "
             f"sweeps: per substep)" if "substeps_per_step" in out else "")
          + (f"; {out['dropped_sweeps']} sweeps dropped in {out['solves']} solves"
             if "solves" in out else ""),
          flush=True)
    for n, us, c in rows[:8]:
        print(f"    {us:10.1f} us/step {100 * us / busy_us:5.1f}%  x{c:g}  {n[:90]}",
              flush=True)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", help="also write every number to this JSON file")
    ap.add_argument("--cell", action="append", choices=list(CELLS) + list(SHARDED),
                    help="measure only this cell (repeatable); all by default")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("cells: needs a CUDA device")
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    report = {"nvidia_smi": smi}
    for name in args.cell or CELLS:
        if name in SHARDED:
            make, shards, warmup, timed = SHARDED[name]
            report[name] = measure(name, make, warmup, timed, None, dev, shards)
        else:
            report[name] = measure(name, *CELLS[name], dev)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
