"""The port's spans and counters (cfd_demo_tpu_torch/trace.py) on the CPU.

One step of a small channel scene on each route the CPU reaches, under
torch.profiler: the step's span encloses its phases in order, every
kernel wrapper's span lies in a phase, and every host operation of the
step lies in the step's span. With the profiler off no span calls the
profiler; on or off, the step's bits are the same. ``host_reads``
counts the tolerance exits' reads of device values, ``vcycles`` every
V-cycle run, and the wrappers keep their launch counters.
"""
import dataclasses
import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import cfd_demo_tpu_torch as tc
from cfd_demo_tpu_torch import cells, trace
from cfd_demo_tpu_torch.kernels import (ensemble, jacobi, jacobi_batch, mg, mgp, rounds,
                                        sor, substep)
from cfd_demo_tpu_torch.ops import poisson as TP
from cfd_demo_tpu_torch.solver import piso

torch.set_num_threads(1)

PHASES = ("cfd.predict", "cfd.solve", "cfd.correct")

# route: (solver options, scenes in the batch or None, the top-level phases of
# a substep in order, the kernel wrappers it calls)
ROUTES = {
    "plain": (dict(substep_impl="jnp"), None, PHASES, set()),
    "fused": (dict(substep_impl="pallas", **cells.FAST_SCHEDULE), None, PHASES,
              {"predict_div", "jacobi_fused_k", "correct_bc"}),
    "fused-correct-div": (dict(substep_impl="pallas", pressure_impl="pallas",
                               rounds_impl="pallas", outer_corrector_rounds=2), None, PHASES,
                          {"predict_div", "jacobi_fused_k", "correct_div"}),
    # the rounds kernel corrects inside cfd.solve
    "rounds": ({}, None, PHASES[:2], {"predict_div", "solve_correct_rounds"}),
    "batch": (dict(substep_impl="jnp", early_exit=False), 2, PHASES, {"jacobi_batch"}),
}


def _scene(**opts):
    grid = tc.Grid(nx=24, ny=16, lx=4.0, ly=1.5,
                   obstacles=(tc.Cylinder(center_x=1.0, center_y=0.75, radius=0.3),))
    params = tc.SimulationParams(dt=0.004, viscosity=1e-4, target_inlet_velocity=1.0)
    return tc.make_scene(grid, params,
                         tc.solver_options_for(tc.Semantics.RUST, **{"ramp_up_steps": 4, **opts}))


def _stepped(route):
    """The route's scene and a state a few steps from rest (the inlet
    ramped up, every exit live)."""
    opts, batch, _, _ = ROUTES[route]
    scene = _scene(**opts)
    state = scene.init_state(device="cpu")
    if batch:
        state = tc.batch_state(state, batch, nu=torch.tensor([1e-4, 1e-2][:batch]))
    step = tc.make_step(scene)
    for _ in range(5):
        state, _ = step(state)
    return step, state


def _fields(state):
    return {f.name: getattr(state, f.name) for f in dataclasses.fields(state)
            if isinstance(getattr(state, f.name), torch.Tensor)}


def _traced_step(step, state, path):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out, _ = step(state)
    prof.export_chrome_trace(str(path))
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
    return out, [(e["name"], e.get("cat"), float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                 for e in events]


def _inside(inner, outer):
    return outer[2] <= inner[2] and inner[3] <= outer[3]


@pytest.mark.parametrize("route", ROUTES)
def test_spans_nest(route, tmp_path):
    step, state = _stepped(route)
    _, events = _traced_step(step, state, tmp_path / "trace.json")
    spans = [e for e in events if e[1] == "user_annotation" and e[0].startswith("cfd.")]
    steps = [e for e in spans if e[0] == "cfd.step"]
    assert len(steps) == 1
    whole = steps[0]
    phases = sorted((e for e in spans if e[0] in PHASES), key=lambda e: e[2])
    assert phases and all(_inside(p, whole) for p in phases)
    top = [p for p in phases if not any(q is not p and _inside(p, q) for q in phases)]
    assert [p[0] for p in top] == list(ROUTES[route][2])
    kernels = [e for e in spans if e[0].startswith("cfd.kernel.")]
    assert {k[0][len("cfd.kernel."):] for k in kernels} == ROUTES[route][3]
    assert all(any(_inside(k, p) for p in phases) for k in kernels)
    ops = [e for e in events if e[1] == "cpu_op"]
    assert ops and all(_inside(o, whole) for o in ops)


@pytest.mark.parametrize("route", ROUTES)
def test_profiler_off_calls_nothing(route, monkeypatch):
    step, state = _stepped(route)

    def refuse(name):
        raise AssertionError(f"record_function({name!r}) with the profiler off")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    step(state)
    with pytest.raises(AssertionError, match="cfd.step"):
        with profile(activities=[ProfilerActivity.CPU]):
            step(state)


@pytest.mark.parametrize("route", ROUTES)
def test_bits_with_the_profiler_on_and_off(route, tmp_path):
    step, state = _stepped(route)
    off, _ = step(state)
    on, _ = _traced_step(step, state, tmp_path / "trace.json")
    a, b = _fields(off), _fields(on)
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k


class _OnCard:
    """A 0-d value that says it lives on a CUDA card."""
    is_cuda = True

    def item(self):
        return True


def _count_reads(monkeypatch):
    calls = []
    real = trace.read_host

    def spy(t):
        calls.append(t)
        return real(t)

    monkeypatch.setattr(trace, "read_host", spy)
    return calls


@pytest.mark.parametrize("case", ["jacobi", "mg_production", "on_card"])
def test_host_reads(case, monkeypatch):
    """Every tolerance exit's read goes through read_host; a read of a
    CPU tensor waits for nothing and is not counted, a CUDA one is."""
    before = trace.host_reads
    if case == "on_card":
        assert trace.read_host(_OnCard()) is True
        assert trace.host_reads == before + 1
        return
    calls = _count_reads(monkeypatch)
    if case == "jacobi":
        # no solve reaches its sweep cap: every sweep reads its error once,
        # every outer round once, and the round that stops before the cap
        opts = dict(substep_impl="jnp", jacobi_iters=100_000, outer_corrector_rounds=3)
    else:
        opts = dict(substep_impl="jnp", outer_corrector_rounds=0, mgp_coarse_stop=4)
    scene = _scene(**opts)
    if case == "mg_production":
        scene = dataclasses.replace(scene, params=dataclasses.replace(
            scene.params, pressure_solver=tc.PressureSolver.MG_PRODUCTION))
    step, state = tc.make_step(scene), scene.init_state(device="cpu")
    for _ in range(3):
        state, _ = step(state)
    del calls[:]
    cycles = trace.vcycles
    out = piso._substep_jnp(scene, state.u, state.v, state.p, state.p_prime, state.dt,
                            state.nu, piso.ramped_inlet(scene.opts, state))
    rounds_run, solved = (int(c) for c in out[-1])
    if case == "jacobi":
        cap = scene.opts.outer_corrector_rounds
        assert len(calls) == solved + rounds_run + (rounds_run < cap) > rounds_run + 1
    else:
        assert len(calls) == trace.vcycles - cycles == solved >= 2
    assert all(isinstance(t, torch.Tensor) and t.dim() == 0 for t in calls)
    assert trace.host_reads == before  # CPU tensors


def _mg_opts(**kw):
    return tc.solver_options_for(tc.Semantics.RUST, mgp_coarse_stop=8, **kw)


@pytest.mark.parametrize("case", ["exact", "masked", "legacy", "fixed", "fdm_alone",
                                  "multigrid"])
def test_vcycles_counts_every_cycle_run(case):
    """One count a cycle: the exact exit's, every one of the masked loop's
    max(1, cycles) (those after the exit are run and discarded), the
    legacy scheme's, the fixed cycles, a cycle that is FDM alone (an
    interior at most mgp_coarse_stop a side), MULTIGRID's mg_cycles."""
    shape = (10, 10) if case == "fdm_alone" else (34, 66)
    ny, nx = shape
    rhs = torch.from_numpy(np.random.default_rng(3).standard_normal(shape)
                           .astype(np.float32))
    rhs[[0, -1]] = 0.0
    rhs[:, [0, -1]] = 0.0
    pp0 = torch.zeros(shape)
    before = cells.vcycles_launched()
    if case == "multigrid":
        TP.multigrid(pp0, rhs, 1 / nx, 1 / ny, _mg_opts(mg_cycles=3))
        assert cells.vcycles_launched() - before == 3
        return
    kw = {"exact": {}, "masked": dict(early_exit=False, mgp_max_cycles=6),
          "legacy": dict(mgp_scheme="legacy"), "fixed": dict(mgp_fixed_cycles=4),
          "fdm_alone": {}}[case]
    _, _, n = TP.multigrid_production(pp0, rhs, 1 / nx, 1 / ny, _mg_opts(**kw), 0.1)
    got = cells.vcycles_launched() - before
    want = {"masked": 6, "fixed": 4}.get(case, int(n))
    assert got == want >= 1
    if case in ("exact", "legacy"):
        assert got >= 2
    if case == "masked":
        assert int(n) < 6  # the loop ran cycles past its exit, and counted them


WRAPPERS = [(m, name) for m, names in [
    (substep, ("predict_div", "correct_bc", "correct_div")),
    (jacobi, ("jacobi_fused_k", "jacobi_fused_k_shard")),
    (jacobi_batch, ("jacobi_batch",)),
    (rounds, ("solve_correct_rounds",)),
    (ensemble, ("substep_batch", "substep_batch_sor")),
    (mgp, ("jacobi_fused_k_res", "jacobi_fused_k_restrict", "jacobi_fused_k_corr",
           "cc_sweeps")),
    (mg, ("mg_smooth", "mg_residual_restrict", "mg_prolong_add", "mgp_smooth")),
    (sor, ("sor_fused_k", "sor_fused_k_shard", "sor_fused_k_rb2")),
] for name in names]


@pytest.mark.parametrize("mod,name", WRAPPERS,
                         ids=[f"{m.__name__.rsplit('.', 1)[1]}.{n}" for m, n in WRAPPERS])
def test_launch_counters_survive(mod, name):
    """The name the module binds is the traced wrapper: it holds the launch
    counters, the body's ``<name>.launches += 1`` reaches them through
    the module's globals, and the benchmark's counters() still lists
    them."""
    from benchmark_torch.trace import counters

    fn = getattr(mod, name)
    body = fn.__wrapped__
    assert fn.__name__ == name and fn.__module__ == mod.__name__
    assert body.__globals__[name] is fn
    attrs = sorted(a for a, v in vars(fn).items() if a.endswith("launches")
                   and isinstance(v, int))
    assert "launches" in attrs
    assert {name, *attrs} <= set(body.__code__.co_names)
    listed = counters()
    short = mod.__name__.rsplit(".", 1)[1]
    assert all(f"{short}.{name}.{a}" in listed for a in attrs)
