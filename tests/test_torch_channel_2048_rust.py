"""The port's step on the desktop app's full Rust schedule against the
plain reference of the benchmark's channel_2048_rust configuration
(benchmark_torch/configs/channel_2048_rust.py), on the CPU.

The 2048^2 channel is cut as the benchmark's CPU tests cut a grid of 2M
cells or more (ny = 40, nx = ny lx / ly: 40x40, the same domain and
cylinder), with the fused route its cell takes at full size
(substep_impl "pallas") and the 2M-cell gate lowered to 0, so that the
Jacobi solve takes the kernel chain (``jacobi_chain``, kernel 2's plain
version: the error tested after each 16-sweep launch, the 2-sweep
remainder always run) as it does at 2048^2, and not the plain solve's
exact exit. The outer rounds take the plain glue (rounds_impl "auto")
or, where named, one ``correct_div`` a round (rounds_impl "pallas").

Each step is held to the reference computed in float64 and in float32
at the cell's limits; the reference in bfloat16 and an altered step are
not. The solves' sweeps and the rounds agree with the reference's, at
the chunk's exit (18 sweeps), at the cap (50) and where the rounds stop
before 20; the channel reference's exact exit does not judge them. The
chain counts its sweeps in ``trace.chain_sweeps`` and the host-read
round loops their rounds in ``trace.outer_rounds``; each read of a
device value is one ``cfd.read`` span, opened by ``trace.read_host``
alone, and the reads are those the exits made before the counters. Each
exit starts its read (``trace.read_soon``) before the chain's next
launch or the round's corrector is queued, and waits on it after.
"""
import copy
import dataclasses
import json
import subprocess
import sys

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from benchmark_torch import checks, manifest, reference, run, scene as gen, window
from cfd_demo_tpu_torch import make_step, trace
from cfd_demo_tpu_torch.kernels import jacobi as kjacobi
from cfd_demo_tpu_torch.solver import piso

torch.set_num_threads(1)

CELL = "channel_2048.reference"
CONFIG_FILE = "benchmark_torch/configs/channel_2048_rust.json"
SEED = 2 ** 31 + 12345
CHUNK, ITERS = 16, 50

# case: the solver options changed from the cell's, and what the steps
# show: every solve at the chunk's exit (16 + 2 sweeps), the first solve
# at the cap, or a step whose rounds stop before 20
EXITS = {"chunk": {"jacobi_tol": 0.1}, "cap": {}, "rounds": {}}


def _cell(monkeypatch, **options):
    """The cell cut to 40x40 on the chain, ``options`` over its solver
    options; the chain's sweeps, call by call, are recorded in the
    returned list."""
    cell = manifest.cell(CELL)
    cell = {**cell, "config": copy.deepcopy(cell["config"]),
            "traffic": copy.deepcopy(cell["traffic"])}
    g = cell["config"]["grid"]
    g["ny"] = 40
    g["nx"] = round(g["ny"] * g["lx"] / g["ly"])
    cell["traffic"]["solver"]["options"].update(substep_impl="pallas", **options)
    cell["traffic"]["check_steps"] = 2
    monkeypatch.setattr(piso, "FUSED_MIN_CELLS", 0)
    sweeps = []

    def chain(*a, **kw):
        out = kjacobi.jacobi_chain(*a, **kw)
        sweeps.append(out[2])
        return out

    monkeypatch.setattr(piso, "jacobi_chain", chain)
    return cell, sweeps


def _steps(cell, steps, sweeps):
    """(index, before, after) of the first ``steps`` program steps of
    ``cell`` from its seeded state, and each step's chain sweeps."""
    config, traffic = cell["config"], cell["traffic"]
    scene = gen.program_scene(config, traffic)
    state = gen.program_state(scene, config, traffic, SEED, torch.device("cpu"))
    step = make_step(scene)
    kept, per_step = [], []
    for i in range(steps):
        del sweeps[:]
        new, _ = step(state)
        kept.append((i, state, new))
        per_step.append(list(sweeps))
        state = new
    return kept, per_step


def _reference_sweeps(cell, kept, monkeypatch):
    """Each sampled step's solves' sweeps as the configuration's
    reference runs them in float64."""
    plain = cell["reference"]
    got, real = [], plain.chunked_jacobi

    def spy(*a, **kw):
        out = real(*a, **kw)
        got[-1].append(out[2])
        return out

    monkeypatch.setattr(plain, "chunked_jacobi", spy)
    stepper = plain.Stepper(plain.plain_setup(cell["config"], cell["traffic"]), "cpu")
    for _, before, _ in kept:
        got.append([])
        stepper.step(gen.scene_fields(before, plain.FIELDS))
    return got


def test_the_cell_takes_its_own_reference():
    cell = manifest.cell(CELL)
    own = cell["reference"]
    assert own is not reference
    assert own.__file__ == str(manifest.root() / CONFIG_FILE.replace(".json", ".py"))
    opts = cell["traffic"]["solver"]["options"]
    assert cell["traffic"]["solver"]["pressure_solver"] == "jacobi"
    assert {k: opts[k] for k in (
        "jacobi_omega", "jacobi_tol", "jacobi_iters", "outer_corrector_rounds",
        "outer_corrector_tol", "early_exit", "ramp_up_steps", "cfl", "dt_growth_cap",
        "pallas_fuse_k", "rounds_impl")} == {
        "jacobi_omega": 0.75, "jacobi_tol": 1e-4, "jacobi_iters": 50,
        "outer_corrector_rounds": 20, "outer_corrector_tol": 1e-4, "early_exit": True,
        "ramp_up_steps": 10, "cfl": 0.2, "dt_growth_cap": 1.1, "pallas_fuse_k": 0,
        "rounds_impl": "auto"}
    assert cell["traffic"]["warmup_steps"] > opts["ramp_up_steps"]
    assert cell["workload"]["chips"] == 1
    with open(manifest.root() / "benchmark_torch/configs/channel_2048.json") as f:
        channel = json.load(f)
    for key in ("grid", "params", "semantics", "precision", "seed_draws"):
        assert cell["config"][key] == channel[key], key
    entry = [c for c in manifest.load()["configs"] if c["name"] == "channel_2048_rust"][0]
    assert entry["reduced"] == [] and entry["file"] == CONFIG_FILE


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["float64", "float32"])
def test_the_ports_step_within_the_cells_limits(dtype, monkeypatch):
    """Four steps from the seeded state (the inlet ramping) against the
    reference in ``dtype``: within the cell's limits, and as close as
    the float32 step can be; every solve on the chain."""
    cell, sweeps = _cell(monkeypatch)
    kept, per_step = _steps(cell, 4, sweeps)
    assert all(s and set(s) <= {18, 34, 50} for s in per_step)
    samples = checks.readings(kept, cell, "cpu", dtype)
    correct, failed, compared = checks.decide(samples, checks.nonfinite(kept[-1][2]),
                                              cell["traffic"]["limits"])
    assert correct and failed == 0, compared
    for k in ("u", "v", "p", "dt"):
        assert checks.worst(samples)[k] < 1e-5, (k, compared)


@pytest.mark.parametrize("case", EXITS)
def test_the_solves_and_rounds_exit_where_the_reference_does(case, monkeypatch):
    """The program's solves run the sweeps the reference's do, solve by
    solve, and its rounds stop where the reference's stop: at the
    chunk's exit (16 + 2 sweeps, where the channel reference's exact
    exit runs other sweeps and misses the limits), at the cap, and in a
    step whose rounds stop before 20."""
    cell, sweeps = _cell(monkeypatch, **EXITS[case])
    kept, per_step = _steps(cell, 4, sweeps)
    assert _reference_sweeps(cell, kept, monkeypatch) == per_step
    rounds = [len(s) - 1 for s in per_step]
    if case == "chunk":
        assert all(n == CHUNK + ITERS % CHUNK for s in per_step for n in s)
    elif case == "cap":
        assert per_step[0][0] == ITERS
    else:
        assert 0 <= min(rounds) < 20 and max(rounds) == 20
    samples = checks.readings(kept, cell, "cpu")
    assert all(checks.worst(samples)[k] < 1e-5 for k in ("u", "v", "p", "dt"))
    if case == "chunk":
        exact = checks.readings(kept, {**cell, "reference": reference}, "cpu")
        assert not checks.decide(exact, 0, cell["traffic"]["limits"])[0]


def unchanged(step):
    """A step that returns its state as it came."""
    return lambda s: (dataclasses.replace(s), None)


def altered(step):
    """A step whose answer is altered where it is produced: one u face
    of the outflow moved by a tenth of the inlet speed."""
    def wrapped(s):
        new, d = step(s)
        u = new.u.clone()
        u[u.shape[0] // 2, -2] += 0.1
        return dataclasses.replace(new, u=u), d
    return wrapped


@pytest.mark.parametrize("mode", ["control", "altered", "unchanged"])
def test_the_bfloat16_control_and_a_broken_step_are_not_correct(mode, monkeypatch):
    cell, sweeps = _cell(monkeypatch)
    if mode == "control":
        kept, _ = _steps(cell, 3, sweeps)
        samples = checks.readings(kept, cell, "cpu", torch.bfloat16, against=True)
        correct, failed, _ = checks.decide(samples, 0, cell["traffic"]["limits"])
        assert not correct and failed >= 1
        return
    wrap = {"altered": altered, "unchanged": unchanged}[mode]
    result = run.measure(cell, SEED, 0.3, False, device="cpu", step_wrap=wrap)
    assert result["correct"] is False and result["failed"] >= 1


def test_the_reference_imports_no_program_and_no_jax():
    """As run.py checks a run: the top-level names of every module loaded
    by the reference and one of its steps, in a fresh interpreter."""
    code = f"""
import sys, torch
from benchmark_torch import manifest
plain = manifest.reference({CONFIG_FILE!r})
cfg = {{"grid": {{"nx": 12, "ny": 8, "lx": 3.0, "ly": 2.0,
                 "cylinders": [{{"center_x": 1.0, "center_y": 1.0, "radius": 0.3}}]}},
       "params": {{"flow_case": "channel", "velocity_scheme": "first",
                  "inlet_profile": "uniform"}}, "semantics": "rust"}}
opts = dict(jacobi_omega=0.75, jacobi_tol=1e-4, jacobi_iters=50, outer_corrector_rounds=20,
            outer_corrector_tol=1e-4, ramp_up_steps=10, cfl=0.2, dt_growth_cap=1.1,
            early_exit=True, pallas_fuse_k=0)
traffic = {{"solver": {{"pressure_solver": "jacobi", "options": opts}}}}
st = plain.Stepper(plain.plain_setup(cfg, traffic), "cpu")
z = torch.zeros
out = st.step({{"u": z(8, 13), "v": z(8, 12), "p": z(8, 12), "p_prime": z(8, 12),
               "dt": 0.002, "nu": 1e-4, "target_inlet": 1.0, "step": 5}})
assert float(out["u"][4, 0]) == 0.5
print(sorted({{m.split(".")[0] for m in sys.modules}}))
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=manifest.root(),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    loaded = set(eval(out.stdout.strip().splitlines()[-1]))
    assert "torch" in loaded
    assert not loaded & (set(run.FORBIDDEN) | {"cfd_demo_tpu_torch"})


REFUSED = {"sor": ("solver", {"pressure_solver": "sor"}),
           "mg-production": ("solver", {"pressure_solver": "mg-production"}),
           "cavity": ("params", {"flow_case": "cavity"}),
           "quick": ("params", {"velocity_scheme": "quick"}),
           "parabolic": ("params", {"inlet_profile": "parabolic"}),
           "js": ("config", {"semantics": "js"})}


@pytest.mark.parametrize("what", REFUSED)
def test_the_reference_refuses_another_solver_and_another_flow(what, monkeypatch):
    cell, _ = _cell(monkeypatch)
    plain, config, traffic = cell["reference"], cell["config"], cell["traffic"]
    where, change = REFUSED[what]
    {"solver": traffic["solver"], "params": config["params"],
     "config": config}[where].update(change)
    with pytest.raises(ValueError, match="chunked-exit Jacobi reference"):
        plain.plain_setup(config, traffic)


def _problem(ny=10, nx=12, seed=7):
    g = torch.Generator().manual_seed(seed)
    rhs = torch.randn((ny, nx), generator=g, dtype=torch.float64)
    pp = reference.pprime_bcs(0.1 * torch.randn((ny, nx), generator=g, dtype=torch.float64))
    return pp, rhs, 30.0 / nx, 20.0 / ny


@pytest.mark.parametrize("tol,iters,k", [(0.0, 50, 16), (1.0, 50, 16), (0.05, 50, 16),
                                         (1e-9, 50, 16), (0.05, 48, 16), (0.05, 50, 7),
                                         (0.05, 5, 16)])
def test_the_references_chunked_exit_is_the_ports_chain_in_float64(tol, iters, k, monkeypatch):
    """The reference's solve, written from the exit rule on the channel
    reference's sweep, and the port's ``jacobi_chain`` on kernel 2's
    plain version (``jacobi_fused_k_plain``, which the wrapper runs on
    CPU tensors of float32 only), both in float64 on a hand-built p':
    the same sweeps, p' and error, for a fixed count, exits at the
    first, a later and no chunk, no remainder, another chunk, and fewer
    sweeps than a chunk."""
    cell, _ = _cell(monkeypatch)
    monkeypatch.setattr(kjacobi, "jacobi_fused_k", lambda pp, rhs, dx, dy, omega, k, cavity:
                        kjacobi.jacobi_fused_k_plain(pp, rhs, dx, dy, omega, k))
    pp, rhs, dx, dy = _problem()
    got, err, n = cell["reference"].chunked_jacobi(pp, rhs, dx, dy, 0.75, tol, iters, k)
    want, werr, wn = kjacobi.jacobi_chain(pp, rhs, dx, dy, 0.75, tol, iters, k=k)
    assert n == wn and n % k == iters % k
    torch.testing.assert_close(got, want, rtol=0, atol=1e-12 * float(want.abs().max()))
    assert float(err) == pytest.approx(float(werr), rel=1e-9)


def _logged_reads(monkeypatch, log, keep=lambda: True):
    """Log each read ``read_soon`` starts and each ``read_host`` waits on,
    where ``keep()`` holds."""
    soon, read = trace.read_soon, trace.read_host

    def spy_soon(t, **kw):
        if keep():
            log.append("soon")
        return soon(t, **kw)

    def spy_read(t):
        if keep():
            log.append("read")
        return read(t)

    monkeypatch.setattr(trace, "read_soon", spy_soon)
    monkeypatch.setattr(trace, "read_host", spy_read)


@pytest.mark.parametrize("tol,iters,k", [(0.0, 50, 16), (1.0, 50, 16), (0.05, 50, 16),
                                         (1e-9, 50, 16), (0.05, 48, 16), (1.0, 48, 16),
                                         (0.05, 5, 16)])
def test_the_chain_queues_its_next_launch_before_it_waits(tol, iters, k, monkeypatch):
    """``jacobi_chain`` on kernel 2's plain version, in float64: each
    chunk's read is started, the next launch queued (after the last
    chunk, the remainder, which runs whatever the read says), and only
    then the read waited on; a chunk queued past the exit is dropped and
    the remainder runs on the last chunk kept. The p', error and sweeps
    are those of the loop that reads before it launches."""
    log = []

    def launch(pp, rhs, dx, dy, omega, n, cavity):
        log.append(n)
        return kjacobi.jacobi_fused_k_plain(pp, rhs, dx, dy, omega, n)

    monkeypatch.setattr(kjacobi, "jacobi_fused_k", launch)
    _logged_reads(monkeypatch, log)
    pp, rhs, dx, dy = _problem()
    got, err, n = kjacobi.jacobi_chain(pp, rhs, dx, dy, 0.75, tol, iters, k=k)
    n_full, rem = divmod(iters, k)
    want, chunks = pp, 0
    for _ in range(n_full):
        want, werr = kjacobi.jacobi_fused_k_plain(want, rhs, dx, dy, 0.75, k)
        chunks += 1
        if tol > 0.0 and not bool(werr >= tol):
            break
    if rem:
        want, werr = kjacobi.jacobi_fused_k_plain(want, rhs, dx, dy, 0.75, rem)
    assert n == chunks * k + rem
    assert torch.equal(got, want) and torch.equal(err, werr)
    tested = ["soon"] if tol > 0.0 else []
    order = [k] if n_full else []
    for i in range(1, chunks + 1):
        ahead = [k] if i < n_full else [rem] if rem else []
        order += tested + ahead + ["read" for _ in tested]
    if rem and (chunks < n_full or not n_full):
        order.append(rem)
    assert log == order
    assert (tol > 0.0 and 0 < chunks < n_full) is (log.count(k) == chunks + 1)


ROUNDS_IMPLS = ["auto", "pallas"]


@pytest.mark.parametrize("rounds_impl", ["auto", "pallas"])
def test_a_rounds_read_is_started_before_its_corrector(rounds_impl, monkeypatch):
    """Four steps on each round glue, the rounds at the cap in some and
    stopping before it in others: the read of a solve's error for the
    round test is started before the corrector is queued (on the plain
    glue, from the first round's solve on) and waited on after it; the
    last round's, which nothing tests, is not started."""
    cell, sweeps = _cell(monkeypatch, rounds_impl=rounds_impl)
    log, inside = [], []
    chain = piso.jacobi_chain

    def solve(*a, **kw):
        log.append("solve")
        inside.append(1)
        try:
            return chain(*a, **kw)
        finally:
            inside.pop()

    monkeypatch.setattr(piso, "jacobi_chain", solve)
    _logged_reads(monkeypatch, log, keep=lambda: not inside)
    for name in ("correct", "correct_div"):
        real = getattr(piso, name)
        monkeypatch.setattr(piso, name, lambda *a, _real=real, **kw: (
            log.append("correct"), _real(*a, **kw))[1])
    config, traffic = cell["config"], cell["traffic"]
    cap = traffic["solver"]["options"]["outer_corrector_rounds"]
    scene = gen.program_scene(config, traffic)
    state = gen.program_state(scene, config, traffic, SEED, torch.device("cpu"))
    step = make_step(scene)
    seen = set()
    for _ in range(4):
        del log[:], sweeps[:]
        state, _ = step(state)
        rounds = len(sweeps) - 1
        seen.add(rounds < cap)
        want = ["solve"] + (["correct", "soon"] if rounds_impl == "auto"
                            else ["soon", "correct"]) + ["read"]
        for i in range(1, rounds + 1):
            tested = ["soon"] if i < cap else []
            want += ["solve"] + tested + ["correct"] + ["read" for _ in tested]
        assert log == want, rounds
    assert seen == {True, False}


@pytest.mark.parametrize("rounds_impl", ROUNDS_IMPLS)
def test_the_counters_count_the_sweeps_and_rounds_run(rounds_impl, monkeypatch):
    """Three steps on each round glue: ``trace.chain_sweeps`` gains the
    chain's sweeps, ``trace.outer_rounds`` the rounds run (one solve a
    step and one a round), profiler or not."""
    cell, sweeps = _cell(monkeypatch, rounds_impl=rounds_impl)
    config, traffic = cell["config"], cell["traffic"]
    scene = gen.program_scene(config, traffic)
    state = gen.program_state(scene, config, traffic, SEED, torch.device("cpu"))
    step = make_step(scene)
    before = (trace.chain_sweeps, trace.outer_rounds)
    with profile(activities=[ProfilerActivity.CPU]):
        state, _ = step(state)
    for _ in range(2):
        state, _ = step(state)
    assert trace.chain_sweeps - before[0] == sum(sweeps) > 0
    assert trace.outer_rounds - before[1] == len(sweeps) - 3 > 0


def _reads(monkeypatch):
    calls = []
    real = trace.read_host

    def spy(t):
        calls.append(t)
        return real(t)

    monkeypatch.setattr(trace, "read_host", spy)
    return calls


class _OnCard:
    """A 0-d value that says it lives on a CUDA card."""
    is_cuda = True

    def item(self):
        return True


@pytest.mark.parametrize("rounds_impl", ROUNDS_IMPLS)
def test_host_reads_are_the_exits_reads(rounds_impl, monkeypatch):
    """A step reads once after each whole chunk a solve ran, once a round
    and once where the rounds stop before the cap: the reads the exits
    made before the counters and the span; ``host_reads`` counts a read
    of a CUDA value and not of a CPU one, inside its span or not."""
    cell, sweeps = _cell(monkeypatch, rounds_impl=rounds_impl)
    config, traffic = cell["config"], cell["traffic"]
    scene = gen.program_scene(config, traffic)
    state = gen.program_state(scene, config, traffic, SEED, torch.device("cpu"))
    step = make_step(scene)
    cap = traffic["solver"]["options"]["outer_corrector_rounds"]
    calls = _reads(monkeypatch)
    before = trace.host_reads
    for profiled in (False, True, False):
        del calls[:], sweeps[:]
        if profiled:
            with profile(activities=[ProfilerActivity.CPU]):
                state, _ = step(state)
        else:
            state, _ = step(state)
        rounds = len(sweeps) - 1
        assert len(calls) == sum(n // CHUNK for n in sweeps) + rounds + (rounds < cap)
    assert trace.host_reads == before  # CPU tensors
    with profile(activities=[ProfilerActivity.CPU]):
        assert trace.read_host(_OnCard()) is True
    assert trace.read_host(_OnCard()) is True
    assert trace.host_reads == before + 2


def _spans(step, state, tmp_path):
    path = tmp_path / "trace.json"
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        step(state)
    prof.export_chrome_trace(str(path))
    with open(path) as f:
        return [(e["name"], float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                for e in json.load(f)["traceEvents"]
                if e.get("ph") == "X" and e.get("cat") == "user_annotation"]


@pytest.mark.parametrize("cell_name", [CELL, "channel_2048.jacobi_fast"])
def test_cfd_read_opens_only_inside_read_host(cell_name, monkeypatch, tmp_path):
    """One step under the profiler: a ``cfd.read`` span for each call of
    ``read_host`` and none other, each inside the step's solve or
    correct phase; the fixed schedule reads nothing and opens none."""
    cell, _ = _cell(monkeypatch)
    if cell_name != CELL:
        fixed = manifest.cell(cell_name)
        cell = {**cell, "traffic": copy.deepcopy(fixed["traffic"])}
        cell["traffic"]["solver"]["options"]["substep_impl"] = "pallas"
    config, traffic = cell["config"], cell["traffic"]
    scene = gen.program_scene(config, traffic)
    state = gen.program_state(scene, config, traffic, SEED, torch.device("cpu"))
    step = make_step(scene)
    opened = []
    real_span = trace.span
    monkeypatch.setattr(trace, "span", lambda name: (opened.append(name), real_span(name))[1])
    calls = _reads(monkeypatch)
    spans = _spans(step, state, tmp_path)
    reads = [s for s in spans if s[0] == "cfd.read"]
    phases = [s for s in spans if s[0] in ("cfd.solve", "cfd.correct")]
    assert len(reads) == len(calls) == opened.count("cfd.read")
    assert (len(reads) > 0) is (cell_name == CELL)
    assert all(any(p[1] <= r[1] and r[2] <= p[2] for p in phases) for r in reads)


def test_the_spans_and_counters_leave_the_bits(monkeypatch):
    """The step with the profiler on and off: the same bits."""
    cell, _ = _cell(monkeypatch)
    config, traffic = cell["config"], cell["traffic"]
    scene = gen.program_scene(config, traffic)
    state = gen.program_state(scene, config, traffic, SEED, torch.device("cpu"))
    step = make_step(scene)
    off, _ = step(state)
    with profile(activities=[ProfilerActivity.CPU]):
        on, _ = step(state)
    for f in dataclasses.fields(off):
        a, b = getattr(off, f.name), getattr(on, f.name)
        if isinstance(a, torch.Tensor):
            assert torch.equal(a, b), f.name
