"""channel_2048_sor and its cell at a tiny size on the CPU: the cell takes
the configuration's own plain reference (configs/channel_2048_sor.py),
which judges the program's red/black SOR step and refuses a broken one,
and the three readers of the SOR solve count what ran: the program's
iteration counter, the fixed solve's roofline and the colour-split
layout's share of the solve."""
import sys

import pytest
import torch

from benchmark_torch import manifest, reference, run, scene as gen, trace, window
from benchmark_torch.trace import Context, Event

from conftest import SEED, tiny
from test_control import altered

CELL = "channel_2048.sor_fast"
CONFIG_FILE = "benchmark_torch/configs/channel_2048_sor.json"
READERS = ("sor_iters_per_step", "sor_roofline", "sor_layout_share")


def test_the_cell_takes_its_own_reference():
    cell = manifest.cell(CELL)
    own = cell["reference"]
    assert own is not reference
    assert own.__file__ == str(manifest.root() / CONFIG_FILE.replace(".json", ".py"))
    assert cell["traffic"]["solver"]["pressure_solver"] == "sor"
    assert cell["workload"]["chips"] == 1
    assert {m["name"] for m in cell["end_to_end"]} == {"cell_updates_per_s", "setup_s"}
    assert {m["name"] for m in cell["per_layer"]} == set(READERS)
    bench = manifest.load()
    entry = [c for c in bench["configs"] if c["name"] == "channel_2048_sor"][0]
    assert entry["reduced"] == [] and entry["file"] == CONFIG_FILE


@pytest.mark.parametrize("mode", ["sound", "altered"])
def test_the_tiny_cell_through_a_run(mode, monkeypatch):
    """The tiny cell with the 2M-cell gate lowered, so that its solve
    takes the colour-split chain it takes at full size."""
    from cfd_demo_tpu_torch.solver import piso

    monkeypatch.setattr(piso, "FUSED_MIN_CELLS", 0)
    cell = tiny(CELL)
    assert (cell["config"]["grid"]["nx"], cell["config"]["grid"]["ny"]) == (40, 40)
    result = run.measure(cell, SEED, 0.3, False, device="cpu",
                         step_wrap=altered if mode == "altered" else None)
    assert result["correct"] is (mode == "sound"), result["checks"]
    if mode == "sound":
        assert result["attempted"] >= 1 and result["failed"] == 0
        assert set(result["metrics"]) == {"cell_updates_per_s", "setup_s"}


# -- the readers --------------------------------------------------------------


def _traced_window(steps, program="with_counter", monkeypatch=None, tmp_path=None):
    """``steps`` steps of the tiny cell on the colour-split chain under
    the CPU profiler, with the readers installed around them; the run's
    context, filled from the trace as the traced run fills it."""
    from cfd_demo_tpu_torch import make_step
    from cfd_demo_tpu_torch.solver import piso

    monkeypatch.setattr(piso, "FUSED_MIN_CELLS", 0)
    cell = tiny(CELL)
    config, traffic = cell["config"], cell["traffic"]
    scene = gen.program_scene(config, traffic)
    state = gen.program_state(scene, config, traffic, SEED, torch.device("cpu"))
    step = make_step(scene)
    state = window.warm_up(step, state, traffic, lambda: None)
    if program == "without":  # a program that has no trace module
        monkeypatch.setitem(sys.modules, "cfd_demo_tpu_torch.trace", None)
    ctx = Context(cell)
    readers = [manifest.reader(n) for n in READERS]
    path = tmp_path / "trace.json"
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        undo = [r.install(ctx) for r in readers if hasattr(r, "install")]
        with torch.profiler.record_function(trace.WINDOW):
            window.run(step, state, lambda: None, steps=steps)
        for u in reversed(undo):
            u()
    prof.export_chrome_trace(str(path))
    _, host = trace._parse(path)
    ctx.steps = steps
    ctx.host_events = host
    return ctx


@pytest.mark.parametrize("program", ["with_counter", "without"])
def test_sor_iters_per_step_reads_the_chains_count(program, monkeypatch, tmp_path):
    ctx = _traced_window(3, program, monkeypatch, tmp_path)
    reader = manifest.reader("sor_iters_per_step")
    if program == "without":
        assert reader.read(ctx) is None and "sor_iterations" not in ctx.store
        return
    assert ctx.store["sor_iterations"] == 3 * 50
    assert reader.read(ctx) == 50.0


def test_the_device_readers_read_none_without_device_operations(monkeypatch, tmp_path):
    """A CPU window opens the spans (two layout spans a solve) but
    launches nothing on a device: no device time to divide by."""
    ctx = _traced_window(2, monkeypatch=monkeypatch, tmp_path=tmp_path)
    names = [e.name for e in ctx.host_events if e.cat == "user_annotation"]
    assert names.count("cfd.sor.layout") == 2 * names.count("cfd.solve") == 4
    assert manifest.reader("sor_roofline").read(ctx) is None
    assert manifest.reader("sor_layout_share").read(ctx) is None


def test_sor_roofline_hand_count():
    # 2048^2, 50 iterations of 10 operations a cell and the last one's
    # change, 3 a cell: 503 * 2048^2 = 2.1098e9 operations a step, 31.49
    # us at 67 TFLOP/s; 12 bytes a cell, 50.3 MB, 15.02 us at 3.35 TB/s:
    # bound by the operations.
    mod = manifest.reader("sor_roofline")
    bytes_moved, flops = mod.work(1, 50, 2048, 2048)
    assert flops / 67e12 == pytest.approx(31.490e-6, rel=1e-4)
    assert bytes_moved / 3.35e12 == pytest.approx(15.024e-6, rel=1e-4)

    class Ctx(Context):
        def device_s_in(self, name):
            assert name == "cfd.solve"
            return 10 * 1.46e-3

    ctx = Ctx(manifest.cell(CELL))
    ctx.steps = 10
    assert mod.read(ctx) == pytest.approx(100 * 31.490e-6 / 1.46e-3, rel=1e-4)
    for change in ({"jacobi_tol": 1e-4}, {"outer_corrector_rounds": 2}):
        ctx.traffic = {**ctx.traffic, "solver": {**ctx.traffic["solver"], "options": {
            **ctx.traffic["solver"]["options"], **change}}}
        assert mod.read(ctx) is None
    assert mod.read(Ctx(manifest.cell("channel_2048.jacobi_fast"))) is None


def _mark(name, start, end):
    return Event(name, "user_annotation", float(start), float(end), None)


def test_sor_layout_share_hand_count():
    # a solve (10-60 us) holding two layout spans; four launches: one in
    # each layout span (4 and 5 us on the device), one in the solve
    # between them (30 us), one after the solve (10 us, not counted)
    ctx = Context(manifest.cell(CELL))
    launches = {1: 12.0, 2: 20.0, 3: 56.0, 4: 70.0}
    ctx.host_events = [_mark("cfd.solve", 10, 60), _mark("cfd.sor.layout", 11, 15),
                       _mark("cfd.sor.layout", 55, 59)] + [
        Event("cudaLaunchKernel", "cuda_runtime", t, t + 1, c) for c, t in launches.items()]
    ctx._launch_at = launches
    ctx.device_events = [Event("k", "kernel", 100.0, 100.0 + d, c)
                         for c, d in {1: 4, 2: 30, 3: 5, 4: 10}.items()]
    reader = manifest.reader("sor_layout_share")
    assert reader.read(ctx) == pytest.approx(100 * 9 / 39)
    ctx.host_events = ctx.host_events[:1] + ctx.host_events[3:]  # no layout span
    assert reader.read(ctx) is None
