"""The port's red/black SOR step against the plain reference of the
benchmark's channel_2048_sor configuration
(benchmark_torch/configs/channel_2048_sor.py), on the CPU.

The 2048^2 channel is cut as the benchmark's CPU tests cut a grid of 2M
cells or more (ny = 40, nx = ny lx / ly: 40x40, the same domain and
cylinder), with the fused route its cell takes at full size
(substep_impl "pallas"). At that size the SOR solve takes the
full-layout chain (kernel 13's plain version); lowering
``piso.FUSED_MIN_CELLS`` takes the colour-split chain (kernel 15's plain
version between the split and the join), and pressure_impl "jnp" the
plain ``ops.poisson.sor``. Each is held to the reference in float64 at
the cell's limits; the reference in bfloat16 and an altered step are
not. The SOR chains count their iterations in ``trace.sor_iterations``,
and the colour-split chain's split and join open ``cfd.sor.layout``.
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
from cfd_demo_tpu_torch.ops import poisson as tpois
from cfd_demo_tpu_torch.solver import piso

torch.set_num_threads(1)

CELL = "channel_2048.sor_fast"
CONFIG_FILE = "benchmark_torch/configs/channel_2048_sor.json"
SEED = 2 ** 31 + 12345

# route: (solver options, whether the 2M-cell gate is lowered to 0, the
# solve piso calls)
ROUTES = {"rb2": ({}, True, "sor_chain_rb2"),
          "full": ({}, False, "sor_chain"),
          "plain": ({"pressure_impl": "jnp"}, False, "sor")}


def _cell(route, monkeypatch):
    """The cell cut to 40x40 on ``route``; the solves piso calls are
    recorded in the returned list."""
    cell = manifest.cell(CELL)
    cell = {**cell, "config": copy.deepcopy(cell["config"]),
            "traffic": copy.deepcopy(cell["traffic"])}
    g = cell["config"]["grid"]
    g["ny"] = 40
    g["nx"] = round(g["ny"] * g["lx"] / g["ly"])
    opts, lowered, _ = ROUTES[route]
    cell["traffic"]["solver"]["options"].update(substep_impl="pallas", **opts)
    cell["traffic"]["check_steps"] = 2
    if lowered:
        monkeypatch.setattr(piso, "FUSED_MIN_CELLS", 0)
    calls = []
    for name in ("sor_chain", "sor_chain_rb2", "sor"):
        fn = getattr(piso, name)
        monkeypatch.setattr(piso, name, lambda *a, _f=fn, _n=name, **kw:
                            (calls.append(_n), _f(*a, **kw))[1])
    return cell, calls


def _kept(cell, steps):
    """(index, before, after) of the first ``steps`` program steps of
    ``cell`` from its seeded state."""
    config, traffic = cell["config"], cell["traffic"]
    scene = gen.program_scene(config, traffic)
    state = gen.program_state(scene, config, traffic, SEED, torch.device("cpu"))
    sampler = window.Sampler(steps, SEED)
    window.run(make_step(scene), state, lambda: None, steps=steps, sampler=sampler)
    return sampler.kept


def test_the_cell_takes_its_own_reference():
    cell = manifest.cell(CELL)
    own = cell["reference"]
    assert own is not reference
    assert own.__file__ == str(manifest.root() / CONFIG_FILE.replace(".json", ".py"))
    opts = cell["traffic"]["solver"]["options"]
    assert cell["traffic"]["solver"]["pressure_solver"] == "sor"
    assert (opts["sor_omega"], opts["sor_ordering"], opts["jacobi_iters"],
            opts["jacobi_tol"], opts["early_exit"]) == (1.7, "redblack", 50, 0.0, False)
    assert cell["workload"]["chips"] == 1
    with open(manifest.root() / "benchmark_torch/configs/channel_2048.json") as f:
        channel = json.load(f)
    for key in ("grid", "params", "semantics", "precision", "seed_draws"):
        assert cell["config"][key] == channel[key], key


@pytest.mark.parametrize("route", ROUTES)
def test_the_ports_sor_step_within_the_cells_limits(route, monkeypatch):
    """Four steps from the seeded state (the inlet ramping) against the
    reference in float64: within the cell's limits, and as close as the
    float32 step can be."""
    cell, calls = _cell(route, monkeypatch)
    kept = _kept(cell, 4)
    assert set(calls) == {ROUTES[route][2]} and len(calls) == 4
    samples = checks.readings(kept, cell, "cpu")
    correct, failed, compared = checks.decide(samples, checks.nonfinite(kept[-1][2]),
                                              cell["traffic"]["limits"])
    assert correct and failed == 0, compared
    for k in ("u", "v", "p", "dt"):
        assert checks.worst(samples)[k] < 1e-5, (k, compared)
    assert float(kept[-1][2].p_prime.abs().max()) > 0


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
    cell, _ = _cell("rb2", monkeypatch)
    if mode == "control":
        samples = checks.readings(_kept(cell, 3), cell, "cpu", torch.bfloat16,
                                  against=True)
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
opts = dict(sor_omega=1.7, sor_ordering="redblack", jacobi_tol=0.0, jacobi_iters=5,
            outer_corrector_rounds=0, outer_corrector_tol=1e-4, ramp_up_steps=10,
            cfl=0.2, dt_growth_cap=1.1)
traffic = {{"solver": {{"pressure_solver": "sor", "options": opts}}}}
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


def test_tf32_is_off_once_the_reference_steps(monkeypatch):
    cell, _ = _cell("rb2", monkeypatch)
    plain = cell["reference"]
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    plain.Stepper(plain.plain_setup(cell["config"], cell["traffic"]), "cpu")
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False


REFUSED = {"jacobi": ("solver", {"pressure_solver": "jacobi"}),
           "lexicographic": ("options", {"sor_ordering": "lexicographic"}),
           "cavity": ("params", {"flow_case": "cavity"}),
           "quick": ("params", {"velocity_scheme": "quick"}),
           "js": ("config", {"semantics": "js"})}


@pytest.mark.parametrize("what", REFUSED)
def test_the_reference_refuses_another_solver_and_another_flow(what, monkeypatch):
    cell, _ = _cell("rb2", monkeypatch)
    plain, config, traffic = cell["reference"], cell["config"], cell["traffic"]
    where, change = REFUSED[what]
    {"solver": traffic["solver"], "options": traffic["solver"]["options"],
     "params": config["params"], "config": config}[where].update(change)
    with pytest.raises(ValueError, match="red/black SOR"):
        plain.plain_setup(config, traffic)


def _problem(ny=10, nx=12, seed=7):
    g = torch.Generator().manual_seed(seed)
    rhs = torch.randn((ny, nx), generator=g, dtype=torch.float64)
    pp = reference.pprime_bcs(0.1 * torch.randn((ny, nx), generator=g, dtype=torch.float64))
    return pp, rhs, 30.0 / nx, 20.0 / ny


def test_the_references_sor_converges_to_the_exact_solve(monkeypatch):
    """Many iterations of the reference's SOR reach the solution of the
    p' equation under the channel's BCs, as the channel reference's
    eigenbasis solve gives it: the iteration solves that equation."""
    cell, _ = _cell("rb2", monkeypatch)
    pp, rhs, dx, dy = _problem()
    got, err, n = cell["reference"].red_black_sor(pp, rhs, dx, dy, 1.7, 1e-13, 100_000)
    want = reference.ExactSolver(12, 10, dx, dy, "cpu").solve(rhs)
    assert 50 < n < 100_000 and float(err) < 1e-13
    torch.testing.assert_close(got, want, rtol=0, atol=1e-10 * float(want.abs().max()))


@pytest.mark.parametrize("tol", [0.0, 1e-3])
def test_the_references_sor_is_the_ports_plain_sor_in_float64(tol, monkeypatch):
    """The reference's iterations, written from the update, and the
    port's plain red/black ``ops.poisson.sor``, both in float64: the
    same p', error and iteration count, with a fixed count and with a
    live tolerance."""
    cell, _ = _cell("rb2", monkeypatch)
    pp, rhs, dx, dy = _problem()
    got, err, n = cell["reference"].red_black_sor(pp, rhs, dx, dy, 1.7, tol, 300)
    want, werr, wn = tpois.sor(pp, rhs, dx, dy, 1.7, tol, 300)
    assert n == int(wn) and (n == 300) is (tol == 0.0)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-12 * float(want.abs().max()))
    assert float(err) == pytest.approx(float(werr), rel=1e-9)


@pytest.mark.parametrize("route", ROUTES)
def test_sor_iterations_counts_each_chains_iterations(route, monkeypatch):
    """Two steps: 50 iterations a solve on each kernel chain; the plain
    sor counts on the device and is not counted."""
    cell, calls = _cell(route, monkeypatch)
    config, traffic = cell["config"], cell["traffic"]
    scene = gen.program_scene(config, traffic)
    state = gen.program_state(scene, config, traffic, SEED, torch.device("cpu"))
    step = make_step(scene)
    before = trace.sor_iterations
    for _ in range(2):
        state, _ = step(state)
    assert calls == [ROUTES[route][2]] * 2
    assert trace.sor_iterations - before == (0 if route == "plain" else 2 * 50)


@pytest.mark.parametrize("route", ROUTES)
def test_the_layout_span_opens_on_the_rb2_chain_only(route, monkeypatch, tmp_path):
    """One step under the profiler: the colour-split chain opens
    cfd.sor.layout twice (its split and its join), inside cfd.solve; the
    other routes never."""
    cell, _ = _cell(route, monkeypatch)
    config, traffic = cell["config"], cell["traffic"]
    scene = gen.program_scene(config, traffic)
    state = gen.program_state(scene, config, traffic, SEED, torch.device("cpu"))
    step = make_step(scene)
    path = tmp_path / "trace.json"
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        step(state)
    prof.export_chrome_trace(str(path))
    with open(path) as f:
        spans = [(e["name"], float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                 for e in json.load(f)["traceEvents"]
                 if e.get("ph") == "X" and e.get("cat") == "user_annotation"]
    layout = [s for s in spans if s[0] == "cfd.sor.layout"]
    solves = [s for s in spans if s[0] == "cfd.solve"]
    assert len(solves) == 1
    assert len(layout) == (2 if route == "rb2" else 0)
    assert all(solves[0][1] <= s[1] and s[2] <= solves[0][2] for s in layout)


def test_the_layout_span_leaves_the_bits(monkeypatch):
    """The rb2 route's step with the profiler on and off: the same bits."""
    cell, _ = _cell("rb2", monkeypatch)
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
