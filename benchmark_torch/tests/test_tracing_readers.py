"""The readers of the program's spans and counter, by hand count on a
synthetic traced window, and on a real CPU trace of each tiny cell
whose host operations stand in for the device's."""
import sys

import pytest
import torch

from benchmark_torch import manifest, scene as gen, trace, window
from benchmark_torch.trace import Context, Event

from conftest import CELLS, SEED, cell_of, tiny

IDLE = ("idle_predict_share", "idle_solve_share", "idle_correct_share",
        "idle_step_rest_share", "idle_between_steps_share")


def _mark(name, start, end):
    return Event(name, "user_annotation", float(start), float(end), None)


def _ctx(marks, busy, span=(0.0, 100.0)):
    ctx = Context(cell_of("channel_2048.jacobi_fast"))
    ctx.span, ctx.steps = span, 2
    ctx.window_s = (span[1] - span[0]) * 1e-6
    ctx.host_events = marks
    ctx.device_events = [Event("k", "kernel", float(s), float(t), i)
                         for i, (s, t) in enumerate(busy)]
    ctx.busy_s = trace._union_us(busy) * 1e-6
    return ctx


# Two steps in a 100-us window, the first with an outer round's solve
# nested in its correct; two kernel wrapper calls (4 and 6 us).
MARKS = [_mark("bench.window", 0, 100), _mark("cfd.step", 10, 60),
         _mark("cfd.predict", 12, 20), _mark("cfd.kernel.predict_div", 13, 17),
         _mark("cfd.solve", 20, 40), _mark("bench.pressure_solve", 20, 40),
         _mark("cfd.kernel.jacobi_fused_k", 22, 28), _mark("cfd.correct", 40, 58),
         _mark("cfd.solve", 45, 50), _mark("cfd.step", 70, 95),
         _mark("cfd.predict", 72, 80), _mark("cfd.solve", 80, 90)]
# The device's operations, two overlapping at 70-73; the gaps (middle:
# where) 0-5 (between), 14-16 (predict), 30-34 (solve), 42-44 (correct),
# 47-49 (the nested solve), 58.5-59.5 (the step's rest), 62-68 (between),
# 74-76 (predict), 92-94 (the step's rest), 97-100 (between).
BUSY = [(5, 14), (16, 30), (34, 42), (44, 47), (49, 58.5), (59.5, 62), (68, 74),
        (70, 73), (76, 92), (94, 97)]
WANT = {"idle_between_steps_share": 14.0, "idle_predict_share": 4.0,
        "idle_solve_share": 6.0, "idle_correct_share": 2.0, "idle_step_rest_share": 3.0}


def _read(name, ctx):
    return manifest.reader(name).read(ctx)


def test_idle_split_hand_count():
    ctx = _ctx(MARKS, BUSY)
    got = {name: _read(name, ctx) for name in IDLE}
    assert got == pytest.approx(WANT, abs=1e-9)
    assert sum(got.values()) == pytest.approx(_read("device_idle_share", ctx), abs=1e-9)
    assert _read("device_idle_share", ctx) == pytest.approx(29.0)


def test_idle_outside_every_step_is_between_steps():
    # one step that the device never idles in; every gap lies outside it
    ctx = _ctx([_mark("cfd.step", 40, 60), _mark("cfd.solve", 45, 55)],
               [(30, 70)])
    got = {name: _read(name, ctx) for name in IDLE}
    assert got["idle_between_steps_share"] == pytest.approx(60.0)
    assert all(got[n] == 0.0 for n in IDLE if n != "idle_between_steps_share")


def test_a_phase_that_never_opens_reads_zero_and_no_step_reads_none():
    ctx = _ctx([_mark("cfd.step", 0, 100)], [(0, 40), (60, 100)])
    got = {name: _read(name, ctx) for name in IDLE}
    assert got["idle_step_rest_share"] == pytest.approx(20.0)
    assert got["idle_correct_share"] == 0.0 and got["idle_predict_share"] == 0.0
    bare = _ctx([_mark("bench.window", 0, 100)], [(0, 40)])
    for name in IDLE + ("step_host_ms", "wrapper_host_us"):
        assert _read(name, bare) is None
    assert _read("device_idle_share", bare) == pytest.approx(60.0)


def test_span_durations_hand_count():
    ctx = _ctx(MARKS, BUSY)
    assert _read("step_host_ms", ctx) == pytest.approx((50 + 25) / 2 * 1e-3)
    assert _read("wrapper_host_us", ctx) == pytest.approx((4 + 6) / 2)


@pytest.mark.parametrize("program", ["with_counter", "without"])
def test_host_reads_per_step(program, monkeypatch):
    from cfd_demo_tpu_torch import trace as program_trace

    ctx = _ctx(MARKS, BUSY)
    reader = manifest.reader("host_reads_per_step")
    if program == "without":  # a program that has no trace module
        monkeypatch.setitem(sys.modules, "cfd_demo_tpu_torch.trace", None)
    undo = reader.install(ctx)
    monkeypatch.setattr(program_trace, "host_reads", program_trace.host_reads + 6)
    undo()
    assert reader.read(ctx) == (3.0 if program == "with_counter" else None)


@pytest.mark.parametrize("cell,program", [("channel_2048.mg_production", "with_counter"),
                                          ("channel_2048.jacobi_fast", "with_counter"),
                                          ("channel_2048.mg_production", "without")])
def test_vcycles_per_step(cell, program, monkeypatch):
    """The program's V-cycle count over a window of the tiny cell: the
    production cell's cycles a step; None on a cell that runs no
    multigrid, and for a program without the counter."""
    from cfd_demo_tpu_torch import make_step, trace as program_trace

    c = tiny(cell)
    config, traffic = c["config"], c["traffic"]
    scene = gen.program_scene(config, traffic)
    state = gen.program_state(scene, config, traffic, SEED, torch.device("cpu"))
    step = make_step(scene)
    state = window.warm_up(step, state, traffic, lambda: None)
    reader = manifest.reader("vcycles_per_step")
    ctx = Context(c)
    ctx.steps = 3
    if program == "without":
        monkeypatch.setitem(sys.modules, "cfd_demo_tpu_torch.trace", None)
    start = program_trace.vcycles
    undo = reader.install(ctx)
    window.run(step, state, lambda: None, steps=3)
    undo()
    ran = program_trace.vcycles - start
    if program == "without" or cell.endswith("jacobi_fast"):
        assert reader.read(ctx) is None
        assert ran == 0 or program == "without"
    else:
        assert ran >= 3 and reader.read(ctx) == pytest.approx(ran / 3)


@pytest.mark.parametrize("name", CELLS)
def test_readers_on_a_cpu_trace_of_the_program(name, tmp_path):
    """The program's own spans under the CPU profiler, parsed as the
    traced run parses them; the host's operations stand in for the
    device's, so the idle gaps are the host's Python between them."""
    cell = tiny(name)
    config, traffic = cell["config"], cell["traffic"]
    from cfd_demo_tpu_torch import make_step

    scene = gen.program_scene(config, traffic)
    state = gen.program_state(scene, config, traffic, SEED, torch.device("cpu"))
    step = make_step(scene)
    state = window.warm_up(step, state, traffic, lambda: None)
    path = tmp_path / "trace.json"
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with torch.profiler.record_function(trace.WINDOW):
            window.run(step, state, lambda: None, steps=3)
    prof.export_chrome_trace(str(path))
    dev, host = trace._parse(path)
    (w0, w1), = [(e.start, e.end) for e in host if e.name == trace.WINDOW]
    ops = [(e.start, e.end) for e in host if e.cat == "cpu_op" and w0 <= e.start <= w1]
    ctx = _ctx([e for e in host if e.end > w0 and e.start < w1], ops, (w0, w1))
    ctx.steps = 3
    got = {n: _read(n, ctx) for n in IDLE}
    assert sum(got.values()) == pytest.approx(_read("device_idle_share", ctx), abs=1e-6)
    assert got["idle_predict_share"] > 0 and got["idle_solve_share"] > 0
    if name.endswith("rust_default"):  # the rounds kernel corrects inside cfd.solve
        assert got["idle_correct_share"] == 0.0
    else:
        assert got["idle_correct_share"] > 0
    assert _read("step_host_ms", ctx) > 0 and _read("wrapper_host_us", ctx) > 0
