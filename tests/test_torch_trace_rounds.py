"""The port's rounds counter (cfd_demo_tpu_torch/trace.py ``rounds``) on
the CPU.

While a profiler records, each single-scene ``piso._substep_jnp`` keeps
the (outer rounds, sweeps) count tensor it returns in ``trace.rounds``:
the very tensor, on the rounds route (the rounds kernel's wrapper, its
plain version here) and on the plain projection, and nothing of a
batch's substep. With the profiler off nothing is kept. Keeping a count
reads nothing and computes nothing; ``rounds_total`` sums the kept
counts when asked. The rounds kernel's slab form keeps its count of
dropped speculative sweeps in ``trace.dropped`` the same way: the very
tensor the kernel writes, only while a profiler records, with no read
and no operation added to the step (here against a stand-in for the
kernel library, which the CPU cannot run).
"""
import contextlib

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import cfd_demo_tpu_torch as tc
from cfd_demo_tpu_torch import trace
from cfd_demo_tpu_torch.kernels import cluster as kcl
from cfd_demo_tpu_torch.kernels import rounds as krounds
from cfd_demo_tpu_torch.solver import piso

torch.set_num_threads(1)

# route: solver options over the Rust defaults, scenes in a batch or None
ROUTES = {
    "rounds": ({}, None),
    "plain": (dict(substep_impl="jnp"), None),
    "masked": (dict(substep_impl="jnp", early_exit=False), None),
    "batch": (dict(substep_impl="jnp", early_exit=False), 2),
}
FLOWS = {"cavity": tc.FlowCase.CAVITY, "channel": tc.FlowCase.CHANNEL}


def _stepped(route, flow):
    """A step of the route's scene and a state a few steps from rest."""
    opts, batch = ROUTES[route]
    if flow == "cavity":
        grid = tc.Grid(nx=20, ny=20, lx=1.0, ly=1.0, obstacles=())
        params = tc.SimulationParams(dt=0.01, viscosity=1e-2, target_inlet_velocity=1.0,
                                     flow_case=FLOWS[flow])
    else:
        grid = tc.Grid(nx=24, ny=16, lx=4.0, ly=1.5,
                       obstacles=(tc.Cylinder(center_x=1.0, center_y=0.75, radius=0.3),))
        params = tc.SimulationParams(dt=0.004, viscosity=1e-4, target_inlet_velocity=1.0)
    scene = tc.make_scene(grid, params, tc.solver_options_for(
        tc.Semantics.RUST, **{"ramp_up_steps": 4, **opts}))
    state = scene.init_state(device="cpu")
    if batch:
        state = tc.batch_state(state, batch, nu=torch.tensor([1e-4, 1e-2]))
    step = tc.make_step(scene)
    for _ in range(5):
        state, _ = step(state)
    return step, state


def _spied(monkeypatch):
    """The count tensors ``_substep_jnp`` returns, outermost calls only."""
    returned, inner, depth = [], piso._substep_jnp, [0]

    def spy(*args, **kwargs):
        depth[0] += 1
        try:
            out = inner(*args, **kwargs)
        finally:
            depth[0] -= 1
        if depth[0] == 0:
            returned.append(out[-1])
        return out

    monkeypatch.setattr(piso, "_substep_jnp", spy)
    return returned


# CAVITY flow takes no batch (ROADMAP queue 1 item 6b)
CASES = [(r, f) for f in FLOWS for r in ROUTES if not (ROUTES[r][1] and f == "cavity")]


@pytest.mark.parametrize("route,flow", CASES, ids=[f"{r}-{f}" for r, f in CASES])
def test_rounds_keeps_what_the_substep_returns(route, flow, monkeypatch):
    step, state = _stepped(route, flow)
    returned = _spied(monkeypatch)
    monkeypatch.setattr(trace, "rounds", [])
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(3):
            state, _ = step(state)
    assert len(returned) == 3
    if ROUTES[route][1]:  # a batch's substep: not a single scene's solve
        assert trace.rounds == [] and all(c.shape == (2, 2) for c in returned)
        return
    assert len(trace.rounds) == 3
    assert all(k is c for k, c in zip(trace.rounds, returned))
    assert all(c.dtype == torch.int32 and c.shape == (2,) for c in trace.rounds)
    want = tuple(sum(int(c[i]) for c in returned) for i in (0, 1))
    assert trace.rounds_total(trace.rounds) == want
    assert want[1] > want[0] + 3 > 3  # every solve swept, some rounds ran


@pytest.mark.parametrize("flow", FLOWS)
def test_rounds_stays_empty_outside_a_capture(flow, monkeypatch):
    step, state = _stepped("rounds", flow)
    returned = _spied(monkeypatch)
    monkeypatch.setattr(trace, "rounds", [])
    for _ in range(3):
        state, _ = step(state)
    assert len(returned) == 3 and trace.rounds == []
    assert trace.rounds_total(trace.rounds) == (0, 0)


@pytest.mark.parametrize("flow", FLOWS)
def test_the_bits_with_the_counter_keeping_and_not(flow):
    step, state = _stepped("rounds", flow)
    off, _ = step(state)
    with profile(activities=[ProfilerActivity.CPU]):
        on, _ = step(state)
    for k in ("u", "v", "p", "p_prime", "dt"):
        assert torch.equal(getattr(off, k), getattr(on, k)), k


class _Untouchable:
    """A stand-in for a count tensor that fails on any use: keeping it
    must neither read it nor compute with it."""

    def __getattr__(self, name):
        raise AssertionError(f"keep_rounds used .{name}")


def test_keeping_reads_and_computes_nothing(monkeypatch):
    monkeypatch.setattr(trace, "rounds", [])
    reads = trace.host_reads
    counts = _Untouchable()
    trace.keep_rounds(counts)
    assert trace.rounds == []
    with profile(activities=[ProfilerActivity.CPU]):
        trace.keep_rounds(counts)
    assert len(trace.rounds) == 1 and trace.rounds[0] is counts
    assert trace.host_reads == reads


def test_rounds_total_sums_in_int64():
    kept = [torch.tensor([20, 2**30], dtype=torch.int32)] * 4
    assert trace.rounds_total(kept) == (80, 2**32)
    assert trace.rounds_total(kept[:1]) == (20, 2**30)


def test_keeping_dropped_reads_and_computes_nothing(monkeypatch):
    monkeypatch.setattr(trace, "dropped", [])
    reads = trace.host_reads
    count = _Untouchable()
    trace.keep_dropped(count)
    assert trace.dropped == []
    with profile(activities=[ProfilerActivity.CPU]):
        trace.keep_dropped(count)
    assert len(trace.dropped) == 1 and trace.dropped[0] is count
    assert trace.host_reads == reads


def test_dropped_total_sums_in_int64():
    kept = [torch.tensor([2**30], dtype=torch.int32)] * 4
    assert trace.dropped_total(kept) == 2**32
    assert trace.dropped_total(kept[:1]) == 2**30
    assert trace.dropped_total([]) == 0


class _SlabLibrary:
    """A stand-in for the kernel library: records each call of the slab
    form's entry point and launches nothing."""

    def __init__(self):
        self.calls = []

    def cfd_rounds_slab(self, *args):
        self.calls.append(args)
        return 0


def _slab_route_on_the_cpu(monkeypatch, ny=16, nx=24):
    """The rounds wrapper's slab branch on CPU tensors, against the
    stand-in library: (the library, the wrapper's arguments)."""
    lib = _SlabLibrary()
    route = kcl.Plan("slab", sms=132, slab=kcl.grid_slab_plan(ny, nx, 132))
    monkeypatch.setattr(krounds, "on_cpu", lambda *a: False)
    monkeypatch.setattr(krounds, "load", lambda: lib)
    monkeypatch.setattr(krounds, "plan", lambda *a, **k: route)
    monkeypatch.setattr(krounds, "stream_of", lambda t: 0)
    monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
    grid = tc.Grid(nx=nx, ny=ny, lx=4.0, ly=1.5,
                   obstacles=(tc.Cylinder(center_x=1.0, center_y=0.75, radius=0.3),))
    scene = tc.make_scene(grid, tc.SimulationParams(dt=0.004, viscosity=1e-4),
                          tc.solver_options_for(tc.Semantics.RUST))
    g = torch.Generator().manual_seed(11)
    mk = lambda *shape: 0.1 * torch.randn(*shape, generator=g)
    args = (mk(ny, nx + 1), mk(ny, nx), mk(ny, nx), torch.zeros(ny, nx), mk(ny, nx),
            0.004, 1.0, scene)
    return lib, args


def test_the_slab_launch_keeps_the_count_the_kernel_writes(monkeypatch):
    lib, args = _slab_route_on_the_cpu(monkeypatch)
    monkeypatch.setattr(trace, "dropped", [])
    reads = trace.host_reads
    krounds.solve_correct_rounds(*args)
    assert len(lib.calls) == 1 and trace.dropped == []
    with profile(activities=[ProfilerActivity.CPU]) as on:
        krounds.solve_correct_rounds(*args)
    assert len(lib.calls) == 2 and len(trace.dropped) == 1
    kept = trace.dropped[0]
    # ..., sms, halo, halo_n, sync, sync_n, dropped, stream
    assert kept.dtype == torch.int32 and kept.shape == (1,)
    assert kept.data_ptr() == lib.calls[-1][-2]
    assert trace.host_reads == reads
    # keeping it adds no operation: the same ops with the keep a no-op
    monkeypatch.setattr(trace, "keep_dropped", lambda count: None)
    with profile(activities=[ProfilerActivity.CPU]) as off:
        krounds.solve_correct_rounds(*args)
    ops = lambda prof: [e.name for e in prof.events() if e.name.startswith("aten::")]
    assert ops(on) == ops(off) and ops(on)
    assert len(trace.dropped) == 1
