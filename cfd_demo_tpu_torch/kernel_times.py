"""CUDA-event times of the whole-field kernels on their 2048² states, for
comparing two checkouts of the port on one card.

    python3 -m cfd_demo_tpu_torch.kernel_times [--label NAME] [--out FILE.json]

times predict_div, jacobi_fused_k (k = 16), correct_bc, sor_fused_k and
sor_fused_k_rb2 (k = 8) as chip_smoke.py's phase 3 feeds them (the fast
and SOR shapes after 3 steps, the next rhs), each as the median of 5
means of 50 launches; the rounds kernel on the 800x264 default scene
after 55 steps (phase 3's state, every outer round run), the median of 5
means of 5 (and its cooperative form there, where the tree has two
forms); and the ensembles' kernels on chip_smoke's states: kernel 20 on
the 64x256x96 ensemble and its SOR form on the 16x256x96 one after 20
steps, the median of 5 means of 5, kernel 12 on the 8x800x264
ensemble's next rhs after 5 steps, every scene active and every scene
done, the median of 5 means of 20 (each also in its parent form, the
block or cooperative one, where the tree has two forms). The script
uses only entry points that every
version of the port since its SOR slice has, so it can time an older
checkout as well: run it from that checkout's root with

    PYTHONPATH=. python3 /path/to/this/cfd_demo_tpu_torch/kernel_times.py

(the older tree's package is imported and built), and alternate the two
trees in one call on the card: A, B, B, A.

    python3 -m cfd_demo_tpu_torch.kernel_times --rounds-forms [--out FILE.json]

times the rounds kernel's cluster, slab and cooperative forms on the
same inputs (the default scene's 30 x 10 channel at ROUNDS_SHAPES after
55 steps), the measurement behind the cluster rule, and the cluster form
at each C kernels/cluster.py may pick and at 16 CTAs; then the slab and
cooperative forms in turns, A, B, B, A, on the grids no cluster holds
(the 1024^2 cavity after 20 steps with the cavity app's
constants, and chip_smoke.py's 1024x512 channel, every solve at its 40
sweeps), each pair held to the same bits,

    python3 -m cfd_demo_tpu_torch.kernel_times --ensemble-forms [--out FILE.json]

times kernels 12 and 20 on those three states in their parent form and
in the cluster form at every C that splits the scene with rows in every
CTA (kernels/cluster.py ``tight``), each held to the parent form's bits,
with the C the plan picks,

    python3 -m cfd_demo_tpu_torch.kernel_times --distinct-scenes [--out FILE.json]

runs kernel 20 (Jacobi and SOR) on 150 distinct 40x24 scenes, the CUDA
tests' ``test_substep_batch_waves`` inputs, and lists each scene where
the block form's exits or fields differ from the plain version's
(beside the plain version in f64),

    python3 -m cfd_demo_tpu_torch.kernel_times --sass [--out FILE.json]

counts, in the built library's SASS (``cuobjdump -sass``), each cluster
kernel's instructions an exchange from its first shuffle to its warp
max (the strip's rows, unrolled) over its rows a thread, and the spill
loads and stores (LDL, STL) among them, kernels 1 and 3's instances'
static instructions a cell (``substep_sass_rows``) and every kernel
function's static instruction count (``sass_totals``: run from two
trees' roots, the channel instances' counts are compared across a
change that adds a template flag),

    python3 -m cfd_demo_tpu_torch.kernel_times --sweep-bits [--out FILE.json]

runs the channel instances of the kernels built on csrc/sweep.cuh's sweep
and ring (kernels 6-9, 11, 13-15 and 17-19: csrc/mgp.cu, mg.cu, sor.cu,
jacobi.cu's shard form) on seeded inputs at 2048², 2047² and 130x97 and
prints each one's outputs' sha256 and its median time, with the entry
points every version of the port since its sharded slice has, so that
two trees' bits and times compare (A, B, B, A as above); where the tree
has CAVITY instances of kernels 6-9, 18 and 19 they are timed too,

    python3 -m cfd_demo_tpu_torch.kernel_times --substep-forms [--out FILE.json]

times kernels 1 and 3 on chip_smoke.py's 2048² states, every instance
the main paths run, with repeats (kernel 3 varies between launch sets),
by CUDA events and by torch.profiler's device time, beside the plain
version, each held to the plain version's bits as the CPU computes
them; predict_div also on seeded random fields (no exact zeros, so
every division runs); and predict_div.cu and correct_bc.cu rebuilt for
each candidate tile and strip length (PREDICT_TILES, STRIP_ROWS), each
held to the built library's bits,

    python3 -m cfd_demo_tpu_torch.kernel_times --step-rates [--out FILE.json]

times the 2048² fast and JS QUICK rollouts (rates, and the host's cost
of a step while the device sleeps), with ``make_run`` only, so two
trees can be compared A, B, B, A, and

    python3 -m cfd_demo_tpu_torch.kernel_times --tiles [--out FILE.json]

instead rebuilds csrc/jacobi.cu once for each candidate of TILES (its
kJT_* macros: sweeps a launch, thread rows, rows a thread), all nvcc's
started together, and times jacobi_fused_k at k = 16 on the same 2048²
state with each, requiring each to give the built library's bits; the
fastest was fixed as jacobi.cu's constants.
"""
from __future__ import annotations

import argparse
import concurrent.futures
import ctypes
import json
import statistics
import subprocess
import sys
import time

import torch

import cfd_demo_tpu_torch as tc
from cfd_demo_tpu_torch.apps.ensemble import ensemble_scene, ensemble_state
from cfd_demo_tpu_torch.cells import (ensemble_args, fast_scene, reference_scene,
                                      rounds_args, sor_ensemble_scene, sor_scene)
from cfd_demo_tpu_torch.kernels import _build
from cfd_demo_tpu_torch.kernels import sor as ksor
from cfd_demo_tpu_torch.kernels.ensemble import substep_batch, substep_batch_plain
from cfd_demo_tpu_torch.kernels.jacobi import _multipliers, jacobi_fused_k
from cfd_demo_tpu_torch.kernels.jacobi_batch import jacobi_batch
from cfd_demo_tpu_torch.kernels.rounds import solve_correct_rounds
from cfd_demo_tpu_torch.kernels.substep import correct_bc, predict_div, predict_div_plain
from cfd_demo_tpu_torch.solver.piso import ramped_inlet

REPEATS, CALLS = 5, 50
# jacobi_fused_k's tile candidates: (sweeps a launch t, thread rows, rows
# a thread); the window is (rows x thread rows) by 128 cells, the owned
# tile that less 2t each way.
TILES = [(4, 8, 8), (4, 16, 4), (4, 16, 8), (4, 32, 4), (8, 16, 4), (8, 16, 8),
         (8, 32, 4), (8, 8, 16), (16, 16, 8), (16, 32, 4)]


def _mean_ms(fn, calls) -> float:
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / calls


def median_ms(fn, calls: int = CALLS) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    return statistics.median(_mean_ms(fn, calls) for _ in range(REPEATS))


def device_us(fn, calls: int, kernel: str) -> float:
    """Mean device time in µs of the kernels named ``kernel`` (a substring)
    that ``calls`` calls of fn launch, from torch.profiler's trace (over
    the launches it holds: it can drop one, cells.py says): where a launch
    is shorter than its host call, CUDA events time the host."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    spans = [e.time_range.elapsed_us() for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA and kernel in e.name]
    if not spans:
        raise RuntimeError(f"the trace holds none of {calls} {kernel} launches")
    return sum(spans) / len(spans)


def kernel_times(dev) -> dict:
    out = {}
    scene = fast_scene()
    g, opts = scene.grid, scene.opts
    state, _ = tc.make_run(scene, 3)(scene.init_state(dev))
    sch, sem = scene.params.velocity_scheme, opts.semantics
    u, v, dt, nu = state.u, state.v, state.dt, state.nu
    out["predict_div"] = median_ms(lambda: predict_div(u, v, dt, nu, g, sch, sem))
    us, vs, rhs = predict_div(u, v, dt, nu, g, sch, sem)
    pp = state.p_prime
    out["jacobi_fused_k"] = median_ms(
        lambda: jacobi_fused_k(pp, rhs, g.dx, g.dy, opts.jacobi_omega, 16))
    pp = jacobi_fused_k(pp, rhs, g.dx, g.dy, opts.jacobi_omega, 16)[0]
    args = (us, vs, state.p, pp, u, v, dt, ramped_inlet(opts, state), g,
            scene.params.inlet_profile, scene.params.flow_case, sem)
    out["correct_bc"] = median_ms(lambda: correct_bc(*args))

    scene = sor_scene()
    g, opts = scene.grid, scene.opts
    state, _ = tc.make_run(scene, 3)(scene.init_state(dev))
    rhs = predict_div(state.u, state.v, state.dt, state.nu, g,
                      scene.params.velocity_scheme, opts.semantics)[2]
    pp, om = state.p_prime, opts.sor_omega
    out["sor_fused_k"] = median_ms(lambda: ksor.sor_fused_k(pp, rhs, g.dx, g.dy, om, 8))
    split = ksor.sor_compress(pp) + ksor.sor_compress(rhs)
    out["sor_fused_k_rb2"] = median_ms(
        lambda: ksor.sor_fused_k_rb2(*split, g.dx, g.dy, om, 8))

    scene = reference_scene()
    state, _ = tc.make_run(scene, 55)(scene.init_state(dev))
    args = rounds_args(scene, state)
    out["rounds"] = median_ms(lambda: solve_correct_rounds(*args), 5)
    if hasattr(solve_correct_rounds, "cluster_launches"):  # it has two forms
        out["rounds_cooperative_form"] = median_ms(
            lambda: solve_correct_rounds(*args, form="cooperative"), 5)
    out["rounds_counts"] = solve_correct_rounds(*args)[5].tolist()

    # the ensembles' kernels, and their parent forms where the tree has two
    forms = hasattr(substep_batch, "cluster_launches")
    for name, (args, _) in ensemble_states(dev).items():
        out[name] = median_ms(lambda: substep_batch(*args), 5)
        if forms:
            out[name + "_block_form"] = median_ms(
                lambda: substep_batch(*args, form="block"), 5)
    jargs, done = batch_solve_state(dev)
    for label, flags in (("", None), ("_all_done", done)):
        out["jacobi_batch" + label] = median_ms(lambda: jacobi_batch(*jargs, done=flags), 20)
        if forms:
            out[f"jacobi_batch{label}_cooperative_form"] = median_ms(
                lambda: jacobi_batch(*jargs, done=flags, form="cooperative"), 20)
    # a launch with every scene done is shorter than its host call
    out["jacobi_batch_all_done_device_us"] = device_us(
        lambda: jacobi_batch(*jargs, done=done), 20, "jacobi_batch")
    if forms:
        out["jacobi_batch_all_done_cooperative_form_device_us"] = device_us(
            lambda: jacobi_batch(*jargs, done=done, form="cooperative"), 20, "jacobi_batch")
    return out


def sweep_bits(dev) -> dict:
    """{"<kernel> <ny>x<nx>": {"sha256": of its outputs' bytes, "ms": its
    median}} for the channel instances of kernels 6-9, 11, 13-15 and
    17-19 on seeded fields (p' with the channel's BCs, a random rhs, k = 3
    for the smoothers, 8 for SOR), and "<kernel> cavity <ny>x<nx>" times
    of the CAVITY instances where the tree has them."""
    import hashlib
    from cfd_demo_tpu_torch.kernels import mg as kmg
    from cfd_demo_tpu_torch.kernels import mgp as kmgp
    from cfd_demo_tpu_torch.kernels.jacobi import jacobi_fused_k_shard
    from cfd_demo_tpu_torch.ops.poisson import _apply_pprime_bcs, _cc_prolong_x
    cavity = hasattr(kmgp.jacobi_fused_k_res, "cavity_launches")
    gen = torch.Generator().manual_seed(12)

    def field(shape, scale=1.0):
        return (scale * torch.randn(shape, generator=gen)).to(dev)

    def digest(outs):
        h = hashlib.sha256()
        for o in (outs if isinstance(outs, tuple) else (outs,)):
            if o is not None:
                h.update(o.detach().cpu().numpy().tobytes())
        return h.hexdigest()[:16]

    out = {}
    for ny, nx in ((2048, 2048), (2047, 2047), (130, 97)):
        pp, rhs = _apply_pprime_bcs(field((ny, nx), 0.1)), field((ny, nx))
        dx, dy, om = 1 / nx, 1 / ny, 0.75
        nyc, nxc = (ny - 2) // 2, (nx - 2) // 2
        rc, e_v = field((nyc, nxc)), field(kmg.coarse_shape(ny, nx), 0.05)
        lo, rows = ny // 2 - 16, ny // 4 + 32  # a shard's block: 16 halo rows each side
        calls = {
            "jacobi_fused_k_res": lambda c=False: kmgp.jacobi_fused_k_res(
                pp, rhs, dx, dy, om, 3, **({"cavity": True} if c else {})),
            "cc_sweeps": lambda c=False: kmgp.cc_sweeps(
                torch.zeros_like(rc), rc, 2 * dx, 2 * dy, om, 3, 1.5 * dx, True,
                **({"east_dirichlet": False} if c else {})),
            "mgp_smooth": lambda c=False: kmg.mgp_smooth(
                pp, rhs, dx, dy, om, 3, **({"cavity": True} if c else {})),
            "mg_residual_restrict": lambda: kmg.mg_residual_restrict(pp, rhs, dx, dy),
            "mg_prolong_add": lambda c=False: kmg.mg_prolong_add(
                e_v, pp, True, **({"cavity": True} if c else {})),
            "sor_fused_k": lambda: ksor.sor_fused_k(pp, rhs, dx, dy, 1.7, 8),
            "jacobi_fused_k_shard": lambda: jacobi_fused_k_shard(
                pp[lo:lo + rows].contiguous(), rhs[lo:lo + rows].contiguous(), lo, ny, dx,
                dy, om, 8, 16, rows - 16),
            "sor_fused_k_shard": lambda: ksor.sor_fused_k_shard(
                pp[lo:lo + rows].contiguous(), rhs[lo:lo + rows].contiguous(), lo, ny, dx,
                dy, 1.7, 4, 16, rows - 16),
        }
        if ny % 2 == 0 and nx % 2 == 0:
            row = _cc_prolong_x(field((nyc, nxc), 0.05), nx - 2).contiguous()
            split = ksor.sor_compress(pp) + ksor.sor_compress(rhs)
            calls.update({
                "jacobi_fused_k_restrict": lambda c=False: kmgp.jacobi_fused_k_restrict(
                    pp, rhs, dx, dy, om, 3, **({"cavity": True} if c else {})),
                "jacobi_fused_k_corr": lambda c=False: kmgp.jacobi_fused_k_corr(
                    pp, rhs, row, dx, dy, om, 3, **({"cavity": True} if c else {})),
                "sor_fused_k_rb2": lambda: ksor.sor_fused_k_rb2(*split, dx, dy, 1.7, 8)})
        for name, call in calls.items():
            key = f"{name} {ny}x{nx}"
            out[key] = {"sha256": digest(call()), "ms": median_ms(call, 20)}
            if cavity and name in CAVITY_INSTANCES:
                out[f"{name} cavity {ny}x{nx}"] = {"ms": median_ms(lambda: call(True), 20)}
    return out


# The kernels of sweep_bits whose CAVITY instances it times.
CAVITY_INSTANCES = ("jacobi_fused_k_res", "jacobi_fused_k_restrict", "jacobi_fused_k_corr",
                    "cc_sweeps", "mgp_smooth", "mg_prolong_add")


def ensemble_states(dev) -> dict:
    """{name: (kernel 20's arguments, batch)}: the 64x256x96 ensemble and
    the 16x256x96 SOR ensemble after 20 steps, as chip_smoke.py's phase 3
    feeds them."""
    out = {}
    for name, scene, batch in (("substep_batch", ensemble_scene(), 64),
                               ("substep_batch_sor", sor_ensemble_scene(), 16)):
        state, _ = tc.make_run(scene, 20)(ensemble_state(scene, batch, dev))
        out[name] = (ensemble_args(scene, state), batch)
    return out


def batch_solve_state(dev):
    """Kernel 12's arguments on the 8x800x264 ensemble's next rhs after 5
    steps (chip_smoke.py's phase 3), and done flags marking every scene."""
    scene = ensemble_scene(800, 264)
    g, opts = scene.grid, scene.opts
    state, _ = tc.make_run(scene, 5)(ensemble_state(scene, 8, dev))
    rhs = predict_div_plain(state.u, state.v, state.dt, state.nu, g,
                            scene.params.velocity_scheme, opts.semantics)[2]
    jargs = (state.p_prime, rhs, g.dx, g.dy, opts.jacobi_omega, opts.jacobi_tol,
             opts.jacobi_iters)
    return jargs, torch.ones(8, dtype=torch.bool, device=dev)


def ensemble_form_times(dev) -> list:
    """Kernels 12 and 20 on chip_smoke's states in the parent form and in
    the cluster form at every C that splits the scene with rows in every
    CTA, each held to the parent form's bits: ms a launch (median of 5
    means of 5; kernel 12: of 20) and µs an exchange (a Jacobi sweep, or
    an SOR iteration's two halves) of the scene that runs the most."""
    from cfd_demo_tpu_torch.kernels import cluster as kcl

    def same(a, b):
        return all(bool(torch.equal(x, y)) for x, y in zip(a, b))

    rows = []
    for name, (args, batch) in ensemble_states(dev).items():
        scene = args[-1]
        g, sor = scene.grid, name.endswith("sor")
        parent = substep_batch(*args, form="block")
        iters = int(parent[5][:, 1].max())
        row = {"kernel": name, "shape": [batch, g.ny, g.nx],
               "pick": kcl.plan("substep_batch", batch, g.ny, g.nx, dev, sor=sor).ctas,
               "admitted": kcl.admitted_clusters("cfd_substep_batch_cluster_admit", dev,
                                                 g.ny, g.nx, int(sor)),
               "iterations": iters, "forms": {}}
        calls = {"block": lambda: substep_batch(*args, form="block")}
        for c in kcl.CTAS:
            if kcl.tight(g.ny, g.nx, c):
                calls[c] = lambda c=c: substep_batch(*args, ctas=c)
        for form, call in calls.items():
            if not same(call(), parent):
                raise RuntimeError(f"{name} at {form} CTAs changed the block form's bits")
            ms = median_ms(call, 5)
            row["forms"][str(form)] = {"ms": ms, "us_per_iteration": 1e3 * ms / iters}
        print(json.dumps(row), flush=True)
        rows.append(row)
    jargs, _ = batch_solve_state(dev)
    ny, nx = jargs[0].shape[1:]
    parent = jacobi_batch(*jargs, form="cooperative")
    sweeps = int(parent[2].max())
    row = {"kernel": "jacobi_batch", "shape": list(jargs[0].shape),
           "pick": kcl.plan("jacobi_batch", 8, ny, nx, dev).ctas,
           "admitted": kcl.admitted_clusters("cfd_jacobi_batch_cluster_admit", dev, ny, nx),
           "iterations": sweeps, "forms": {}}
    calls = {"cooperative": lambda: jacobi_batch(*jargs, form="cooperative")}
    for c in kcl.CTAS:
        if kcl.slab_plan(ny, nx, c) is not None:
            calls[c] = lambda c=c: jacobi_batch(*jargs, ctas=c)
    for form, call in calls.items():
        if not same(call(), parent):
            raise RuntimeError(f"jacobi_batch at {form} CTAs changed the cooperative "
                               f"form's bits")
        ms = median_ms(call, 20)
        row["forms"][str(form)] = {"ms": ms, "us_per_iteration": 1e3 * ms / sweeps}
    print(json.dumps(row), flush=True)
    rows.append(row)
    return rows


# (ny, nx) of the default scene's channel, from the JS twin's 400x132 up
# to the Rust app's 800x264
ROUNDS_SHAPES = [(132, 400), (165, 500), (198, 600), (231, 700), (264, 800)]


def rounds_form_times(dev) -> list:
    """The forms of the rounds kernel on the same inputs at each of
    ROUNDS_SHAPES (each form that takes the grid): ms a launch and the
    sweeps it ran, median of 5 means of 5 launches each; where the tree
    has kernels.cluster's plan, also the cluster form at each C it may
    pick and at 16 CTAs (two idle at 800x264), each held to the
    cooperative form's bits; then :func:`slab_form_times`."""
    out, g = [], tc.default_grid()
    for ny, nx in ROUNDS_SHAPES:
        scene = tc.make_scene(tc.Grid(nx=nx, ny=ny, lx=g.lx, ly=g.ly, obstacles=g.obstacles))
        state, _ = tc.make_run(scene, 55)(scene.init_state(dev))
        args = rounds_args(scene, state)
        row = {"shape": [ny, nx]}
        for form in ("cluster", "slab", "cooperative"):
            try:
                counts = solve_correct_rounds(*args, form=form)[5].tolist()
            except ValueError:  # the form does not take the grid, or the tree lacks it
                continue
            row[form] = {"ms": median_ms(lambda: solve_correct_rounds(*args, form=form), 5),
                         "counts": counts}
        try:
            from cfd_demo_tpu_torch.kernels import cluster as kcl
        except ImportError:  # a tree before the shared plan
            kcl = None
        if kcl is not None and "cluster" in row:
            row["pick"] = kcl.plan("rounds", 1, ny, nx, dev).ctas
            coop = solve_correct_rounds(*args, form="cooperative")
            row["by_ctas"] = {}
            for c in sorted({*kcl.candidates(ny, nx), 16}):
                if kcl.slab_plan(ny, nx, c) is None:
                    continue
                call = lambda c=c: solve_correct_rounds(*args, form="cluster", ctas=c)
                if not all(bool(torch.equal(x, y)) for x, y in zip(call(), coop)):
                    raise RuntimeError(f"rounds {ny}x{nx} at {c} CTAs changed the bits")
                row["by_ctas"][str(c)] = median_ms(call, 5)
        print(json.dumps(row), flush=True)
        out.append(row)
    return out + slab_form_times(dev)


def _slab_states(dev):
    """(label, rounds_args) of the grids no cluster holds: the 1024^2 cavity (the cavity
    app's constants) after 20 steps, as chip_smoke.py's phase 3 holds
    kernel 4 there; and chip_smoke.py's 1024x512 channel on seeded
    fields, jacobi_iters 40 and 3 outer rounds, an rhs that runs every
    sweep."""
    from cfd_demo_tpu_torch.cells import cavity_scene
    scene = cavity_scene(1024)
    state, _ = tc.make_run(scene, 20)(scene.init_state(dev))
    yield "1024^2 cavity", rounds_args(scene, state)
    grid = tc.Grid(nx=1024, ny=512, lx=8.0, ly=4.0, obstacles=(tc.Cylinder(2.0, 2.0, 0.3),))
    scene = tc.make_scene(grid, tc.SimulationParams(dt=0.002, viscosity=1e-4),
                          tc.solver_options_for(tc.Semantics.RUST, jacobi_iters=40,
                                                outer_corrector_rounds=3))
    gen = torch.Generator().manual_seed(21)
    mk = lambda *shape, scale=0.1: (scale * torch.randn(*shape, generator=gen)).to(dev)
    u, v, p = mk(grid.ny, grid.nx + 1), mk(grid.ny, grid.nx), mk(grid.ny, grid.nx)
    yield "1024x512", (u, v, p, torch.zeros_like(p), mk(grid.ny, grid.nx, scale=100.0),
                       0.002, 1.0, scene)


def slab_form_times(dev) -> list:
    """The slab and cooperative forms of the rounds kernel on each state
    of :func:`_slab_states`, the same bits and counts required, timed in
    turns (slab, cooperative, cooperative, slab), each a median of 5 means
    of 5 launches: ms a launch, µs a sweep, and the slab form's plan."""
    from cfd_demo_tpu_torch.kernels.cluster import plan
    out = []
    for label, args in _slab_states(dev):
        g = args[-1].grid
        calls = {form: (lambda form=form: solve_correct_rounds(*args, form=form))
                 for form in ("slab", "cooperative")}
        a, b = calls["slab"](), calls["cooperative"]()
        if a[5].tolist() != b[5].tolist() or not all(
                bool(torch.equal(x, y)) for x, y in zip(a, b)):
            raise RuntimeError(f"rounds {label}: the slab and cooperative forms differ")
        times = {"slab": [], "cooperative": []}
        for form in ("slab", "cooperative", "cooperative", "slab"):
            times[form].append(median_ms(calls[form], 5))
        sweeps = a[5].tolist()[1]
        row = {"state": label, "shape": [g.ny, g.nx], "counts": a[5].tolist(),
               "plan": plan("rounds", 1, g.ny, g.nx, dev).slab,
               **{form: {"ms": t, "us_a_sweep": [1e3 * x / sweeps for x in t]}
                  for form, t in times.items()}}
        print(json.dumps(row), flush=True)
        out.append(row)
    return out


def distinct_scenes(dev, batch: int = 150, seed: int = 9) -> list:
    """Kernel 20 on tests/test_torch_cuda.py's ``test_substep_batch_waves``
    inputs (``batch`` distinct noisy 40x24 scenes from ``seed``, the
    viscosity and inlet swept, scene 0 at rest; Jacobi and SOR; two
    substeps, the second warm-started from the plain version's fields):
    whether the route gives the block form's bits, and each scene where
    the block form's exits or fields (beyond 2e-5 + 2e-5 |plain|) differ
    from the plain version's, beside the plain version run in f64."""
    grid = tc.Grid(nx=40, ny=24, lx=3.0, ly=1.5, obstacles=(tc.Cylinder(0.9, 0.75, 0.3),))
    rows = []
    for solver in ("JACOBI", "SOR"):
        scene = tc.make_scene(grid, tc.SimulationParams(
            dt=0.002, viscosity=1e-4, pressure_solver=tc.PressureSolver[solver]),
            tc.solver_options_for(tc.Semantics.RUST, early_exit=False))
        g = torch.Generator().manual_seed(seed)
        mk = lambda sd, *shape: sd * torch.randn(batch, *shape, generator=g)
        u, v, p = mk(0.05, 24, 41), mk(0.05, 24, 40), mk(0.01, 24, 40)
        u[0], v[0], p[0] = 0.0, 0.0, 0.0
        inlet = torch.linspace(0.5, 1.5, batch)
        inlet[0] = 0.0
        args = (u, v, p, torch.zeros(batch, 24, 40), torch.full((batch,), 0.002),
                torch.logspace(-5, -3, batch), inlet)
        for sub in (1, 2):
            d = tuple(a.to(dev) for a in args)
            block = [x.cpu() for x in substep_batch(*d, scene, form="block")]
            route = [x.cpu() for x in substep_batch(*d, scene)]
            ref = substep_batch_plain(*args, scene)
            ref64 = substep_batch_plain(*(a.double() for a in args), scene)
            row = {"solver": solver, "substep": sub, "scenes": batch,
                   "route_bits_eq_block": all(bool(torch.equal(a, b))
                                              for a, b in zip(route, block)),
                   "exits": [], "fields": []}
            for s_ in (block[5] != ref[5]).any(1).nonzero().flatten().tolist():
                row["exits"].append({"scene": s_, "kernel": block[5][s_].tolist(),
                                     "plain": ref[5][s_].tolist(),
                                     "plain_f64": ref64[5][s_].tolist(),
                                     "kernel_err": float(block[4][s_]),
                                     "plain_err": float(ref[4][s_])})
            for name, k in (("u", 0), ("v", 1), ("p", 2), ("pp", 3)):
                a, b, b64 = block[k].double(), ref[k].double(), ref64[k]
                over = (a - b).abs() - 2e-5 - 2e-5 * b.abs()
                for s_ in (over > 0).reshape(batch, -1).any(1).nonzero().flatten().tolist():
                    row["fields"].append({
                        "field": name, "scene": s_,
                        "max_d": float((a[s_] - b[s_]).abs().max()),
                        "max_abs": float(b[s_].abs().max()),
                        "over_bound": float(over[s_].max()),
                        "kernel_vs_f64": float((a[s_] - b64[s_]).abs().max()),
                        "plain_vs_f64": float((b[s_] - b64[s_]).abs().max())})
            print(json.dumps(row), flush=True)
            rows.append(row)
            args = (*ref[:4], *args[4:])
    return rows


def tile_times(dev) -> list:
    """jacobi_fused_k (k = 16) on the 2048² fast state with jacobi.cu
    built for each of TILES; each must give the built library's bits."""
    scene = fast_scene()
    g, opts = scene.grid, scene.opts
    state, _ = tc.make_run(scene, 3)(scene.init_state(dev))
    rhs = predict_div(state.u, state.v, state.dt, state.nu, g,
                      scene.params.velocity_scheme, opts.semantics)[2]
    pp, k = state.p_prime, 16
    ny, nx = pp.shape
    ref = jacobi_fused_k(pp, rhs, g.dx, g.dy, opts.jacobi_omega, k)
    mult = _multipliers(g.dx, g.dy, opts.jacobi_omega)
    srcs = [_build.SRC_DIR / "jacobi.cu", _build.SRC_DIR / "errors.cu"]

    def build(tile):
        name = "tile_" + "_".join(map(str, tile))
        lib = _build.BUILD_DIR / "tiles" / f"{name}.so"
        defines = [f"-DkJT_{m}={v}" for m, v in zip(("T", "BY", "R"), tile)]
        _build.compile_library(lib, srcs, [*_build.FLAGS, *defines])
        return lib

    with concurrent.futures.ThreadPoolExecutor(len(TILES)) as pool:
        libs = list(pool.map(build, TILES))
    out = []
    for tile, path in zip(TILES, libs):
        lib = ctypes.CDLL(str(path))
        fn = lib.cfd_jacobi_fused_k
        fn.argtypes = _build._SIGNATURES["cfd_jacobi_fused_k"]
        o, t, e = torch.empty_like(pp), torch.empty_like(pp), torch.empty((), device=dev)

        def call():
            _build.check(fn(pp.data_ptr(), rhs.data_ptr(), o.data_ptr(), t.data_ptr(),
                            e.data_ptr(), ny, nx, k, *mult, 0, _build.stream_of(pp)),
                         f"jacobi_fused_k tile {tile}")

        call()
        torch.cuda.synchronize()
        same = bool(torch.equal(o, ref[0])) and bool(torch.equal(e, ref[1]))
        log = path.with_suffix(".log").read_text()
        regs = [ln.strip() for ln in log.splitlines() if "tiled_kernel" in ln
                or ("registers" in ln and "Used" in ln)]
        out.append({"tile": tile, "ms": median_ms(call), "same_bits": same,
                    "ptxas": regs[-2:]})
        print(json.dumps(out[-1]), flush=True)
        if not same:
            raise RuntimeError(f"jacobi_fused_k tile {tile} changed the bits")
    return out


def sass_rows() -> list:
    """Instructions a strip row of each cluster kernel of the built
    library: in ``cuobjdump -sass``, from an exchange's first SHFL.UP (row
    0's W) to its REDUX (the warp's max), over the kernel's rows a thread
    (its first template argument). Needs the CUDA toolkit's cuobjdump."""
    import os
    import re
    lib = _build.build()
    tool = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True, text=True,
                          check=True).stdout
    out = []
    for block in sass.split("Function : ")[1:]:
        name = block.split("\n", 1)[0].strip()
        kernel = re.search(r"([a-z_]+_cluster_kernel)I(Li\d+E(?:Lb[01]E)+)", name)
        if kernel is None:
            continue
        rt = int(re.match(r"Li(\d+)E", kernel.group(2)).group(1))
        instr = [ln for ln in block.splitlines() if re.search(r"/\*[0-9a-f]{4}\*/", ln)]
        first = next((k for k, ln in enumerate(instr) if "SHFL.UP" in ln), None)
        if first is None:
            continue
        last = next(k for k in range(first, len(instr)) if "REDUX" in instr[k])
        local = sum(("LDL" in ln or "STL" in ln) for ln in instr[first:last])
        out.append({"kernel": kernel.group(1), "template": kernel.group(2), "rows": rt,
                    "instructions": last - first, "per_row": (last - first) / rt,
                    "local_memory": local})
        print(json.dumps(out[-1]), flush=True)
    return out


def sass_totals() -> list:
    """Every kernel function of the built library with its static SASS
    instruction count and its spill loads and stores (LDL, STL), by its
    mangled name. Needs the CUDA toolkit's cuobjdump."""
    import os
    import re
    lib = _build.build()
    tool = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True, text=True,
                          check=True).stdout
    out = []
    for block in sass.split("Function : ")[1:]:
        instr = [ln for ln in block.splitlines() if re.search(r"/\*[0-9a-f]{4,}\*/\s+\S", ln)]
        out.append({"function": block.split("\n", 1)[0].strip(), "instructions": len(instr),
                    "local_memory": sum(("LDL" in ln or "STL" in ln) for ln in instr)})
    print(json.dumps({"sass_totals": out}), flush=True)
    return out


# Kernel 1's candidate tiles (rows, cols) and kernel 3's candidate strip
# rows, each rebuilt from csrc/ (kPD_TY, kPD_TX; kCB_R) and timed on the
# fast state; the built library's are PREDICT_TILE and CORRECT_STRIP.
PREDICT_TILES = [(31, 32), (15, 32), (7, 32), (63, 32), (31, 64)]
STRIP_ROWS = [4, 8, 16, 32]
SUBSTEP_REPEATS = 9


def _device_sum_us(fn, calls: int, names: tuple) -> float:
    """Device µs a call of fn spends in kernels whose names hold one of
    ``names``: the mean of each such kernel's launches in torch.profiler's
    trace of ``calls`` calls, summed over the kernels (a trace that drops
    a launch leaves the means right)."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    spans = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA and any(n in e.name for n in names):
            spans.setdefault(e.name, []).append(e.time_range.elapsed_us())
    return sum(sum(t) / len(t) for t in spans.values())


def _host_us(fn, calls: int = 20) -> float:
    """The host's µs a call of fn: the time to enqueue ``calls`` calls
    while the device sleeps, so no launch waits on it."""
    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(100_000_000)
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return 1e6 * t / calls


def _pair_times(calls: dict, n: int = SUBSTEP_REPEATS) -> dict:
    """Each of ``calls`` (name -> fn) timed in turns, n rounds of a mean of
    CALLS launches by CUDA events: {name: {"ms": median, "ms_range":
    [min, max], "device_us": the device time a call spends in kernels 1
    and 3, torch.profiler; "host_us": the host's time a call}}. Where a
    call's host time exceeds its device time, the events time the host."""
    for fn in calls.values():
        fn()
    torch.cuda.synchronize()
    rounds = {name: [] for name in calls}
    for _ in range(n):
        for name, fn in calls.items():
            rounds[name].append(_mean_ms(fn, CALLS))
    return {name: {"ms": statistics.median(t), "ms_range": [min(t), max(t)],
                   "device_us": _device_sum_us(calls[name], 20, ("predict_div", "correct_bc")),
                   "host_us": _host_us(calls[name])}
            for name, t in rounds.items()}


def substep_form_times(dev) -> dict:
    """Kernels 1 and 3 on chip_smoke.py's states, each held to its plain
    version's bits as the CPU computes them and timed beside the plain
    version on the card (SUBSTEP_REPEATS rounds; the plain version's
    median of 5 means of 5): predict_div with Rust FIRST on the 2048²
    fast state after 3 steps and SECOND/QUICK x Rust/JS on the 2048² JS
    QUICK state after 3 steps, and with Rust FIRST on seeded random
    fields (no zeros); correct_bc with UNIFORM on the fast state and
    PARABOLIC, PARABOLIC_UPPER on the JS QUICK state. Then every tile of
    PREDICT_TILES and strip length of STRIP_ROWS, rebuilt, on the fast
    state (Rust FIRST, UNIFORM), each held to the built library's bits."""
    import concurrent.futures as cf
    import ctypes
    from cfd_demo_tpu_torch.cells import js_quick_scene
    from cfd_demo_tpu_torch.kernels import substep as ksub
    from cfd_demo_tpu_torch.kernels._build import device_scalars, mask_ptrs, stream_of

    def same(a, b):
        return all(bool(torch.equal(x, y)) for x, y in zip(a, b))

    def held(name, call, plain, *args):
        """Time ``call`` beside ``plain`` once it gives the bits of
        ``plain`` on CPU copies of ``args``."""
        on_cpu = [x.cpu() if isinstance(x, torch.Tensor) else x for x in args]
        if not same([x.cpu() for x in call()], plain(*on_cpu)):
            raise RuntimeError(f"{name}: the kernel differs from the plain version")
        row = {**_pair_times({"kernel": call})["kernel"],
               "plain_ms": median_ms(lambda: plain(*args), 5)}
        print(json.dumps({name: row}), flush=True)
        return row

    out = {"predict_div": {}, "correct_bc": {}}
    states = {}
    for mk in (fast_scene, js_quick_scene):
        scene = mk()
        g, opts = scene.grid, scene.opts
        state, _ = tc.make_run(scene, 3)(scene.init_state(dev))
        states[mk] = (scene, state)
        u, v, dt, nu = state.u, state.v, state.dt, state.nu
        insts = ([(scene.params.velocity_scheme, opts.semantics, "")] if mk is fast_scene
                 else [(s, m, "") for m in (tc.Semantics.RUST, tc.Semantics.JS)
                       for s in (tc.VelocityScheme.SECOND, tc.VelocityScheme.QUICK)])
        if mk is fast_scene:
            gen = torch.Generator(device=dev).manual_seed(1)
            rnd = (0.1 * torch.randn(g.ny, g.nx + 1, device=dev, generator=gen),
                   0.1 * torch.randn(g.ny, g.nx, device=dev, generator=gen))
            insts.append((scene.params.velocity_scheme, opts.semantics, " random"))
        for sch, sem, tag in insts:
            a, b = (rnd if tag else (u, v))
            args = (a, b, dt, nu, g, sch, sem)
            out["predict_div"][f"{sem.value} {sch.value}{tag}"] = held(
                f"predict_div {sem.value} {sch.value}{tag}",
                lambda args=args: predict_div(*args), ksub.predict_div_plain, *args)
        us, vs, _ = predict_div(u, v, dt, nu, g, scene.params.velocity_scheme, opts.semantics)
        profiles = ((scene.params.inlet_profile,) if mk is fast_scene
                    else (tc.InletProfile.PARABOLIC, tc.InletProfile.PARABOLIC_UPPER))
        for prof in profiles:
            args = (us, vs, state.p, state.p_prime, u, v, dt, ramped_inlet(opts, state), g,
                    prof, scene.params.flow_case, opts.semantics)
            out["correct_bc"][prof.value] = held(
                f"correct_bc {prof.value}", lambda args=args: correct_bc(*args),
                ksub.correct_bc_plain, *args)

    # the candidate shapes, each rebuilt from csrc/
    def build(tag, src, defines):
        lib = _build.BUILD_DIR / "substep_forms" / f"{tag}.so"
        _build.compile_library(lib, [_build.SRC_DIR / src, _build.SRC_DIR / "errors.cu"],
                               [*_build.FLAGS, *defines])
        return lib

    with cf.ThreadPoolExecutor(len(PREDICT_TILES) + len(STRIP_ROWS)) as pool:
        tiles = {t: pool.submit(build, f"predict_{t[0]}x{t[1]}", "predict_div.cu",
                                [f"-DkPD_TY={t[0]}", f"-DkPD_TX={t[1]}"])
                 for t in PREDICT_TILES}
        strips = {r: pool.submit(build, f"correct_{r}", "correct_bc.cu", [f"-DkCB_R={r}"])
                  for r in STRIP_ROWS}
        tiles = {t: f.result() for t, f in tiles.items()}
        strips = {r: f.result() for r, f in strips.items()}
    scene, state = states[fast_scene]
    g, opts = scene.grid, scene.opts
    sch, sem = scene.params.velocity_scheme, opts.semantics
    u, v, dt, nu = state.u, state.v, state.dt, state.nu
    ny, nx = g.ny, g.nx
    ref = predict_div(u, v, dt, nu, g, sch, sem)
    scal = device_scalars(dev, dt, nu)
    mask_u, mask_v, mask_u_bc, mask_v_bc = mask_ptrs(g, sem, dev)
    f32 = ksub._f32
    rows = {}
    for t, path in tiles.items():
        fn = ctypes.CDLL(str(path)).cfd_predict_div_tiled
        fn.argtypes = _build._SIGNATURES["cfd_predict_div_tiled"]
        plan = ksub.predict_tile_plan(ny, nx, sch, 0, ny, tile=t)
        outs = tuple(torch.empty_like(x) for x in ref)

        def call(fn=fn, plan=plan, outs=outs, t=t):
            _build.check(fn(u.data_ptr(), v.data_ptr(), scal.data_ptr(),
                            *(x.data_ptr() for x in outs), mask_u, mask_v, ny, nx, 0, ny,
                            f32(g.dx), f32(g.dy), f32(g.dx * g.dx), f32(g.dy * g.dy),
                            ksub._SCHEME[sch], int(sem == tc.Semantics.JS), *plan["tile"],
                            *plan["fast"], stream_of(u)), f"predict_div tile {t}")

        call()
        torch.cuda.synchronize()
        if not same(outs, ref):
            raise RuntimeError(f"predict_div with {t} tiles changed the bits")
        rows[f"predict_div {t[0]}x{t[1]}"] = call
    us, vs, _ = ref
    args = (us, vs, state.p, state.p_prime, u, v, dt, ramped_inlet(opts, state), g,
            scene.params.inlet_profile, scene.params.flow_case, sem)
    cref = correct_bc(*args)
    scal3 = device_scalars(dev, dt, ramped_inlet(opts, state))
    for r, path in strips.items():
        lib = ctypes.CDLL(str(path))
        fn, parts_of = lib.cfd_correct_bc_fused, lib.cfd_correct_bc_fused_partials
        fn.argtypes = _build._SIGNATURES["cfd_correct_bc_fused"]
        parts_of.argtypes = _build._SIGNATURES["cfd_correct_bc_fused_partials"]
        parts = torch.empty(3 * parts_of(ny, nx), device=dev)
        ticket = torch.zeros(1, dtype=torch.int32, device=dev)
        outs = tuple(torch.empty_like(x) for x in cref[:3])
        red = torch.empty(3, device=dev)

        def call(fn=fn, parts=parts, ticket=ticket, outs=outs, red=red, r=r):
            _build.check(fn(*(x.data_ptr() for x in args[:6]), scal3.data_ptr(),
                            *(x.data_ptr() for x in outs), parts.data_ptr(),
                            ticket.data_ptr(), red.data_ptr(), mask_u_bc, mask_v_bc, ny, nx,
                            0, ny, 0, ny, f32(g.dx), f32(g.dy),
                            *ksub.inlet_args(g, scene.params.inlet_profile), 0,
                            stream_of(u)),
                         f"correct_bc {r} rows")

        call()
        torch.cuda.synchronize()
        if not same((*outs, *red), cref):
            raise RuntimeError(f"correct_bc with {r}-row strips changed the bits")
        rows[f"correct_bc {r} rows"] = call
    out["candidates"] = _pair_times(rows)
    for name, row in out["candidates"].items():
        print(json.dumps({"candidate": name, **row}), flush=True)
    return out


STEP_RATE_REPEATS, STEP_RATE_STEPS, HOST_STEPS = 5, 100, 10


def step_rates(dev) -> dict:
    """The 2048² fast and JS QUICK shapes (cells.py's and chip_smoke.py's
    phases 5-6): after 5 warm-up steps, STEP_RATE_REPEATS timed rollouts
    of STEP_RATE_STEPS steps each (host clock up to a synchronize:
    cell-updates/s, median, min, max), and the host's own cost of a step:
    the time to enqueue HOST_STEPS steps while the device sleeps
    (``torch.cuda._sleep``, so no launch waits on it; the rollout reads
    nothing back), per step. A step whose host cost exceeds its device
    time is host-bound. Uses only ``make_run``, so it times any tree."""
    from cfd_demo_tpu_torch.cells import js_quick_scene
    out = {}
    for name, mk in (("2048^2 fast", fast_scene), ("2048^2 js quick", js_quick_scene)):
        scene = mk()
        cells = scene.grid.nx * scene.grid.ny
        state, _ = tc.make_run(scene, 5)(scene.init_state(dev))
        run, host_run = tc.make_run(scene, STEP_RATE_STEPS), tc.make_run(scene, HOST_STEPS)
        rates, host = [], []
        for _ in range(STEP_RATE_REPEATS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, _ = run(state)
            torch.cuda.synchronize()
            rates.append(cells * STEP_RATE_STEPS / (time.perf_counter() - t0))
            torch.cuda._sleep(200_000_000)  # ~0.1 s of device time: more than the enqueue
            t0 = time.perf_counter()
            state, _ = host_run(state)
            host.append(1e6 * (time.perf_counter() - t0) / HOST_STEPS)
            torch.cuda.synchronize()
        out[name] = {"cell_updates_per_s": statistics.median(rates),
                     "range": [min(rates), max(rates)],
                     "host_us_per_step": statistics.median(host),
                     "host_range": [min(host), max(host)]}
        print(json.dumps({name: out[name]}), flush=True)
    return out


# Kernels 1 and 3 in the built library: (name in the SASS, cells or
# faces a thread covers, bodies: the tiled kernel holds an interior and
# a boundary copy of its tile's code).
SUBSTEP_KERNELS = {"predict_div_tiled_kernel": ("tiled", None, 2),
                   "correct_bc_fused_kernel": ("fused", None, 1)}


def substep_sass_rows() -> list:
    """Instructions a cell of kernels 1 and 3's instances in the built
    library's SASS, counted statically: the instructions up to the last
    EXIT (the divisions' out-of-line slow path after it left out), with
    a loop's body (a backward branch and its target) counted once a cell
    and the rest spread over the cells a thread covers, over the kernel's
    bodies; also the MUFU.RCP (one a division), LDG, LDS and STG counts.
    A static count: it takes every branch, so it bounds what a thread
    runs from above, the division slow path aside."""
    import os
    import re
    from cfd_demo_tpu_torch.kernels.substep import CORRECT_STRIP, PREDICT_TILE
    cells = {"tiled": PREDICT_TILE[0] * PREDICT_TILE[1] / 256, "fused": CORRECT_STRIP[2]}
    lib = _build.build()
    tool = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True, text=True,
                          check=True).stdout
    out = []
    for block in sass.split("Function : ")[1:]:
        name = block.split("\n", 1)[0].strip()
        kernel = re.search(r"(predict_div_tiled_kernel|correct_bc_fused_kernel)(I\w*?E)?"
                           r"(?:EvNS|ENS)", name)
        if kernel is None:
            continue
        form, per_thread, bodies = SUBSTEP_KERNELS[kernel.group(1)]
        per_thread = per_thread or cells[form]
        instr = []
        for ln in block.splitlines():
            m = re.search(r"/\*([0-9a-f]{4,})\*/\s+(.*?);", ln)
            if m:
                instr.append((int(m.group(1), 16), m.group(2).strip()))
        last_exit = max(k for k, (_, op) in enumerate(instr) if re.search(r"\bEXIT\b", op))
        main = instr[:last_exit + 1]
        addr = {a: k for k, (a, _) in enumerate(main)}
        loop = 0
        for k, (_, op) in enumerate(main):
            b = re.search(r"\bBRA\b.*?0x([0-9a-f]+)", op)
            if b and int(b.group(1), 16) in addr and addr[int(b.group(1), 16)] < k:
                loop += k - addr[int(b.group(1), 16)] + 1
        count = lambda pat: sum(bool(re.search(pat, op)) for _, op in main)
        per_cell = (loop + (len(main) - loop) / per_thread) / bodies
        out.append({"kernel": kernel.group(1), "template": kernel.group(2) or "",
                    "form": form, "instructions": len(main), "in_loops": loop,
                    "slow_path": len(instr) - len(main), "cells_a_thread": per_thread,
                    "per_cell": per_cell, "mufu_rcp": count(r"MUFU\.RCP"),
                    "ldg": count(r"^(@\S+ )?LDG"), "lds": count(r"^(@\S+ )?LDS"),
                    "stg": count(r"^(@\S+ )?STG")})
        print(json.dumps(out[-1]), flush=True)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--label", default="", help="a name for this tree in the output")
    ap.add_argument("--out", help="also write the times to this JSON file")
    ap.add_argument("--tiles", action="store_true",
                    help="time jacobi_fused_k built with each tile of TILES instead")
    ap.add_argument("--rounds-forms", action="store_true",
                    help="time the rounds kernel's forms at ROUNDS_SHAPES and on the grids "
                         "no cluster holds instead")
    ap.add_argument("--ensemble-forms", action="store_true",
                    help="time kernels 12 and 20 in each form and C instead")
    ap.add_argument("--distinct-scenes", action="store_true",
                    help="kernel 20 against its plain version on 150 distinct scenes instead")
    ap.add_argument("--sass", action="store_true",
                    help="count the cluster kernels' SASS instructions a strip row, and "
                         "kernels 1 and 3's a cell, instead")
    ap.add_argument("--sweep-bits", action="store_true",
                    help="the bits and times of the kernels on csrc/sweep.cuh instead")
    ap.add_argument("--step-rates", action="store_true",
                    help="the 2048^2 fast and JS quick rates and host cost a step instead")
    ap.add_argument("--substep-forms", action="store_true",
                    help="time kernels 1 and 3 beside their plain versions, and their "
                         "candidate tiles, instead")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("kernel_times: needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    dev = torch.device("cuda", 0)
    times = (tile_times(dev) if args.tiles else rounds_form_times(dev) if args.rounds_forms
             else ensemble_form_times(dev) if args.ensemble_forms
             else distinct_scenes(dev) if args.distinct_scenes
             else substep_form_times(dev) if args.substep_forms
             else step_rates(dev) if args.step_rates
             else sweep_bits(dev) if args.sweep_bits
             else sass_rows() + substep_sass_rows() + sass_totals() if args.sass
             else kernel_times(dev))
    report = {"label": args.label, "package": tc.__file__, "nvidia_smi": smi,
              "ms": times}
    print(json.dumps(report), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
