"""channel_2048_rust and its cell at a tiny size on the CPU: the cell takes
the configuration's own plain reference (configs/channel_2048_rust.py),
whose solve exits at the chunk boundaries the configuration states, and
which judges the program's step and refuses a broken one; the four
readers of the cell count what ran: the chain's sweeps and the host-read
loops' rounds (the program's counters), the device's idle in the gaps
its reads open, and the solves' roofline."""
import sys

import pytest
import torch

from benchmark_torch import manifest, reference, run, scene as gen, trace, window
from benchmark_torch.trace import Context, Event

from conftest import SEED, tiny
from test_control import altered

CELL = "channel_2048.reference"
CONFIG_FILE = "benchmark_torch/configs/channel_2048_rust.json"
READERS = ("chain_sweeps_per_step", "fused_rounds_per_step", "read_idle_share",
           "chain_tol_roofline")


def test_the_cell_takes_its_own_reference():
    cell = manifest.cell(CELL)
    own = cell["reference"]
    assert own is not reference
    assert own.__file__ == str(manifest.root() / CONFIG_FILE.replace(".json", ".py"))
    assert cell["traffic"]["solver"]["pressure_solver"] == "jacobi"
    assert cell["workload"]["chips"] == 1
    assert {m["name"] for m in cell["end_to_end"]} == {"cell_updates_per_s", "setup_s"}
    assert {m["name"] for m in cell["per_layer"]} == set(READERS) | {
        "device_idle_share", "host_reads_per_step"}
    bench = manifest.load()
    entry = [c for c in bench["configs"] if c["name"] == "channel_2048_rust"][0]
    assert entry["reduced"] == [] and entry["file"] == CONFIG_FILE


@pytest.mark.parametrize("mode", ["sound", "altered"])
def test_the_tiny_cell_through_a_run(mode, monkeypatch):
    """The tiny cell with the 2M-cell gate lowered, so that its solves take
    the kernel chain they take at full size."""
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


REFUSED = {"sor": ("solver", {"pressure_solver": "sor"}),
           "cavity": ("params", {"flow_case": "cavity"}),
           "second": ("params", {"velocity_scheme": "second"}),
           "parabolic": ("params", {"inlet_profile": "parabolic"}),
           "js": ("config", {"semantics": "js"})}


@pytest.mark.parametrize("what", REFUSED)
def test_plain_setup_refuses_another_solver_and_another_flow(what):
    cell = tiny(CELL)
    plain, config, traffic = cell["reference"], cell["config"], cell["traffic"]
    where, change = REFUSED[what]
    {"solver": traffic["solver"], "params": config["params"],
     "config": config}[where].update(change)
    with pytest.raises(ValueError, match="chunked-exit Jacobi reference"):
        plain.plain_setup(config, traffic)


def test_plain_setup_reads_the_chunk():
    cell = tiny(CELL)
    plain = cell["reference"]
    assert plain.plain_setup(cell["config"], cell["traffic"])["solver"]["chunk"] == 16
    opts = cell["traffic"]["solver"]["options"]
    opts["pallas_fuse_k"] = 5
    assert plain.plain_setup(cell["config"], cell["traffic"])["solver"]["chunk"] == 5


def _problem(ny=10, nx=12, seed=7):
    g = torch.Generator().manual_seed(seed)
    rhs = torch.randn((ny, nx), generator=g, dtype=torch.float64)
    pp = reference.pprime_bcs(0.1 * torch.randn((ny, nx), generator=g, dtype=torch.float64))
    return pp, rhs, 30.0 / nx, 20.0 / ny


@pytest.mark.parametrize("chunks", [1, 2, 3])
def test_the_exit_rule_on_a_hand_built_pprime(chunks):
    """A tolerance between the largest change after ``chunks`` and after
    ``chunks - 1`` chunks of 16 sweeps: the solve stops after that chunk
    and runs the 2-sweep remainder, 16 chunks + 2 sweeps in all, and
    equals the channel reference's solve of exactly that many sweeps.
    The channel reference's exact exit stops on another sweep."""
    plain = tiny(CELL)["reference"]
    pp, rhs, dx, dy = _problem()
    errs = [float(reference.jacobi(pp, rhs, dx, dy, 0.75, 0.0, 16 * c)[1])
            for c in (chunks - 1, chunks) if c]
    tol = (errs[0] * errs[-1]) ** 0.5 if chunks > 1 else 2.0 * errs[-1]
    got, err, n = plain.chunked_jacobi(pp, rhs, dx, dy, 0.75, tol, 50, 16)
    assert n == 16 * chunks + 2
    want, werr, wn = reference.jacobi(pp, rhs, dx, dy, 0.75, 0.0, n)
    assert torch.equal(got, want) and float(err) == float(werr)
    exact = reference.jacobi(pp, rhs, dx, dy, 0.75, tol, 50)[2]
    assert exact != n


def test_the_exit_rule_without_a_tolerance_or_early_exit():
    plain = tiny(CELL)["reference"]
    pp, rhs, dx, dy = _problem()
    want = reference.jacobi(pp, rhs, dx, dy, 0.75, 0.0, 50)
    for tol, early in ((0.0, True), (1e9, False)):
        got = plain.chunked_jacobi(pp, rhs, dx, dy, 0.75, tol, 50, 16, early)
        assert got[2] == 50 and torch.equal(got[0], want[0])


# -- the readers --------------------------------------------------------------


def _traced_window(steps, program="with_counters", monkeypatch=None, tmp_path=None):
    """``steps`` steps of the tiny cell on the chain under the CPU
    profiler, with the readers installed around them; the run's
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


@pytest.mark.parametrize("program", ["with_counters", "without"])
def test_the_counter_readers_read_the_programs_counts(program, monkeypatch, tmp_path):
    """Past the warm-up the tiny cell's solves run to the cap: 50 sweeps
    and 20 rounds a step, so 21 solves of 50 sweeps."""
    ctx = _traced_window(2, program, monkeypatch, tmp_path)
    sweeps = manifest.reader("chain_sweeps_per_step")
    rounds = manifest.reader("fused_rounds_per_step")
    if program == "without":
        assert sweeps.read(ctx) is None and rounds.read(ctx) is None
        assert not {"chain_sweeps", "outer_rounds"} & set(ctx.store)
        assert manifest.reader("chain_tol_roofline").read(ctx) is None
        return
    assert ctx.store["chain_sweeps"] == 2 * 21 * 50 and ctx.store["outer_rounds"] == 2 * 20
    assert sweeps.read(ctx) == 1050.0 and rounds.read(ctx) == 20.0


def test_the_device_readers_read_none_without_device_operations(monkeypatch, tmp_path):
    """A CPU window opens the read spans (3 after each capped solve, 20
    for the rounds) but launches nothing on a device: no device time to
    divide by, and no window for the idle."""
    ctx = _traced_window(2, monkeypatch=monkeypatch, tmp_path=tmp_path)
    names = [e.name for e in ctx.host_events if e.cat == "user_annotation"]
    assert names.count("cfd.read") == 2 * (21 * 3 + 20)
    assert manifest.reader("chain_tol_roofline").read(ctx) is None
    assert manifest.reader("read_idle_share").read(ctx) is None


def test_fused_rounds_reads_zero_where_no_round_ran():
    ctx = Context(manifest.cell(CELL))
    ctx.steps, ctx.store = 4, {"outer_rounds": 0}
    assert manifest.reader("fused_rounds_per_step").read(ctx) == 0.0
    ctx.store = {"chain_sweeps": 0}
    assert manifest.reader("chain_sweeps_per_step").read(ctx) is None


def test_chain_tol_roofline_hand_count():
    # 2048^2, a step of 21 solves at the cap: 1050 sweeps of 9 operations
    # a cell, and 4 tested changes a solve (after each of the 3 chunks,
    # the remainder's), 84 of 3 a cell: (9450 + 252) * 2048^2 = 4.0693e10
    # operations, 607.4 us at 67 TFLOP/s; 12 bytes a cell a solve, 1.057
    # GB, 315.5 us at 3.35 TB/s: bound by the operations.
    mod = manifest.reader("chain_tol_roofline")
    assert mod.tests(1050, 21, 50, 16) == 84
    assert mod.tests(18 + 34 + 50, 3, 50, 16) == 1 + 2 + 3 + 3
    assert mod.tests(64, 2, 32, 16) == 4  # no remainder: one test a chunk
    bytes_moved, flops = mod.work(1050, 21, 50, 16, 2048, 2048)
    assert flops / 67e12 == pytest.approx(607.36e-6, rel=1e-4)
    assert bytes_moved / 3.35e12 == pytest.approx(315.53e-6, rel=1e-4)

    class Ctx(Context):
        def device_s_in(self, name):
            assert name == "cfd.solve"
            return 10 * 10.5e-3

    ctx = Ctx(manifest.cell(CELL))
    ctx.steps, ctx.store = 10, {"chain_sweeps": 10 * 1050, "outer_rounds": 10 * 20}
    assert mod.read(ctx) == pytest.approx(100 * 607.36e-6 / 10.5e-3, rel=1e-4)
    for store in ({"chain_sweeps": 10 * 1050}, {"outer_rounds": 200}, {}):
        ctx.store = store
        assert mod.read(ctx) is None
    ctx.store = {"chain_sweeps": 10 * 1050, "outer_rounds": 10 * 20}
    opts = ctx.traffic["solver"]["options"]
    ctx.traffic = {**ctx.traffic, "solver": {**ctx.traffic["solver"],
                                             "options": {**opts, "jacobi_tol": 0.0}}}
    assert mod.read(ctx) is None
    assert mod.read(Ctx(manifest.cell("channel_2048.sor_fast"))) is None


def _mark(name, start, end):
    return Event(name, "user_annotation", float(start), float(end), None)


def _kernel(start, end):
    return Event("k", "kernel", float(start), float(end), None)


def test_read_idle_share_hand_count():
    # a 100 us window; device busy 0-10, 30-40, 60-70, 90-100; reads open
    # at 8-25 (the gap 10-30 opens inside it: 20 us) and 45-50 (inside the
    # gap 40-60, which opened before it: not the read's); the gap 70-90
    # opens in no read
    ctx = Context(manifest.cell(CELL))
    ctx.span, ctx.window_s = (0.0, 100.0), 100e-6
    ctx.device_events = [_kernel(0, 10), _kernel(30, 40), _kernel(60, 70), _kernel(90, 100)]
    ctx.host_events = [_mark("cfd.read", 8, 25), _mark("cfd.read", 45, 50),
                       _mark("cfd.solve", 0, 100)]
    reader = manifest.reader("read_idle_share")
    assert reader.read(ctx) == pytest.approx(20.0)
    ctx.host_events = ctx.host_events[2:]  # no read span
    assert reader.read(ctx) is None
