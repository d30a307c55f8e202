"""cavity_1024 and its cell at a tiny size on the CPU: the configuration's
own plain reference (configs/cavity_1024.py) judges the program's
cavity, its bfloat16 control and an altered step do not pass, the
reference imports nothing of the program or of JAX, and the two
readers of the program's rounds counter count what the solves ran."""
import json
import subprocess
import sys

import pytest
import torch

from benchmark_torch import checks, manifest, reference, run, scene as gen, window
from benchmark_torch.trace import Context

from conftest import SEED, tiny
from test_control import altered

CELL = "cavity_1024.rust_default"
CONFIG_FILE = "benchmark_torch/configs/cavity_1024.json"


def _kept(cell, steps, warm=True):
    """(index, before, after) of ``steps`` program steps of ``cell`` from
    its seeded state (after its warm-up with ``warm``), and the scene."""
    from cfd_demo_tpu_torch import make_step

    config, traffic = cell["config"], cell["traffic"]
    scene = gen.program_scene(config, traffic)
    state = gen.program_state(scene, config, traffic, SEED, torch.device("cpu"))
    step = make_step(scene)
    if warm:
        state = window.warm_up(step, state, traffic, lambda: None)
    sampler = window.Sampler(steps, SEED)
    window.run(step, state, lambda: None, steps=steps, sampler=sampler)
    return sampler.kept, scene


def test_the_cell_takes_the_cavitys_own_reference():
    cell = manifest.cell(CELL)
    own = cell["reference"]
    assert own is not reference
    assert own.__file__ == str(manifest.root() / CONFIG_FILE.replace(".json", ".py"))
    assert cell["config"]["params"]["flow_case"] == "cavity"
    assert cell["workload"]["chips"] == 1
    names = {m["name"] for m in cell["end_to_end"]}
    assert names == {"cell_updates_per_s", "setup_s"}
    assert {m["name"] for m in cell["per_layer"]} == {"outer_rounds_per_step",
                                                     "cavity_rounds_roofline"}


@pytest.mark.parametrize("mode", ["sound", "altered"])
def test_the_tiny_cell_through_a_run(mode):
    cell = tiny(CELL)
    assert (cell["config"]["grid"]["nx"], cell["config"]["grid"]["ny"]) == (20, 20)
    result = run.measure(cell, SEED, 0.3, False, device="cpu",
                         step_wrap=altered if mode == "altered" else None)
    assert result["correct"] is (mode == "sound"), result["checks"]
    if mode == "sound":
        assert result["attempted"] >= 1 and result["failed"] == 0
        assert set(result["metrics"]) == {"cell_updates_per_s", "setup_s"}


def test_the_bfloat16_control_misses_a_limit():
    cell = tiny(CELL)
    kept, _ = _kept(cell, 3)
    control = checks.readings(kept, cell, "cpu", torch.bfloat16, against=True)
    correct, failed, _ = checks.decide(control, 0, cell["traffic"]["limits"])
    assert not correct and failed >= 1


def _sized(n: int) -> dict:
    cell = tiny(CELL)
    cell["config"]["grid"].update(nx=n, ny=n)
    return cell


# nx of two residues mod 4 beside the two sizes named for the check
SIZES = [48, 64, 50, 51]
ROUTES = {"rounds": {}, "plain": {"pressure_impl": "jnp"}}


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("n", SIZES)
def test_the_plain_route_within_the_cells_limits(n, route):
    """Four steps of the program from the seeded state (each a solve
    with its rounds) against the reference in float64, at the cell's
    limits: the rounds route (on the CPU the rounds kernel's plain
    version) and the plain projection."""
    cell = _sized(n)
    cell["traffic"]["solver"]["options"].update(ROUTES[route])
    kept, scene = _kept(cell, 4, warm=False)
    assert scene.grid.nx == n and scene.params.flow_case.value == "cavity"
    assert [k[0] for k in kept] == [0, 1, 2, 3]
    samples = checks.readings(kept, cell, "cpu")
    correct, failed, compared = checks.decide(samples, checks.nonfinite(kept[-1][2]),
                                              cell["traffic"]["limits"])
    assert correct and failed == 0, compared
    # the lid moves from the first step on
    assert float(kept[-1][2].u[-1, n // 2]) > 0


def test_the_reference_imports_no_program_and_no_jax():
    """As run.py checks a run: the top-level names of every module loaded
    by the reference and one of its steps, in a fresh interpreter."""
    code = f"""
import sys, torch
from benchmark_torch import manifest
plain = manifest.reference({CONFIG_FILE!r})
cfg = {{"grid": {{"nx": 8, "ny": 8, "lx": 1.0, "ly": 1.0, "cylinders": []}},
       "params": {{"flow_case": "cavity", "velocity_scheme": "first",
                  "inlet_profile": "uniform"}}, "semantics": "rust"}}
opts = dict(jacobi_omega=0.75, jacobi_tol=1e-4, jacobi_iters=5, outer_corrector_rounds=2,
            outer_corrector_tol=1e-4, ramp_up_steps=10, cfl=0.2, dt_growth_cap=1.1)
traffic = {{"solver": {{"pressure_solver": "jacobi", "options": opts}}}}
st = plain.Stepper(plain.plain_setup(cfg, traffic), "cpu")
z = torch.zeros
out = st.step({{"u": z(8, 9), "v": z(8, 8), "p": z(8, 8), "p_prime": z(8, 8),
               "dt": 1e-4, "nu": 1e-3, "target_inlet": 1.0, "step": 5}})
assert float(out["u"][-1, 4]) == 0.5
print(sorted({{m.split(".")[0] for m in sys.modules}}))
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=manifest.root(),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    loaded = set(eval(out.stdout.strip().splitlines()[-1]))
    assert "torch" in loaded
    assert not loaded & (set(run.FORBIDDEN) | {"cfd_demo_tpu_torch"})


def test_tf32_is_off_once_the_reference_steps():
    cell = tiny(CELL)
    plain = cell["reference"]
    was = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
    try:
        plain.Stepper(plain.plain_setup(cell["config"], cell["traffic"]), "cpu")
        assert torch.backends.cuda.matmul.allow_tf32 is False
        assert torch.backends.cudnn.allow_tf32 is False
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = was


def test_the_reference_refuses_another_solver_and_another_flow():
    cell = tiny(CELL)
    plain = cell["reference"]
    traffic = json.loads(json.dumps(cell["traffic"]))
    traffic["solver"]["pressure_solver"] = "mg-production"
    traffic["solver"]["options"].update(projection_div_tol=1e-3, mgp_floor=4.0)
    with pytest.raises(ValueError, match="Jacobi solve only"):
        plain.plain_setup(cell["config"], traffic)
    channel = tiny("channel_800x264.rust_default")
    with pytest.raises(ValueError, match="a reference of its own"):
        plain.plain_setup(channel["config"], cell["traffic"])


def test_the_configuration_states_the_case():
    with open(manifest.root() / CONFIG_FILE) as f:
        config = json.load(f)
    g, p = config["grid"], config["params"]
    assert (g["nx"], g["ny"], g["lx"], g["ly"], g["cylinders"]) == (1024, 1024, 1.0, 1.0, [])
    assert p["target_inlet_velocity"] * g["lx"] / p["viscosity"] == pytest.approx(1000)
    h = g["lx"] / g["nx"]
    # the explicit step's numbers at the lid speed (the assumed dt)
    viscous = 4 * p["viscosity"] * p["dt"] / h ** 2
    assert viscous == pytest.approx(0.42, abs=0.01)
    assert viscous + p["target_inlet_velocity"] * p["dt"] / h < 1
    # the Rust CFL control's dt is above the stated one: it never binds
    traffic = manifest.cell(CELL)["traffic"]
    assert traffic["solver"]["options"]["cfl"] * h / p["target_inlet_velocity"] > p["dt"]
    assert set(config["assumed"]) >= {"params.dt", "params.viscosity"}


# -- the readers of the program's rounds counter -------------------------------


def _traced_window(cell, steps, program="with_counter", monkeypatch=None):
    """``steps`` steps of the tiny cell under the CPU profiler with the
    two readers installed; the run's context."""
    from cfd_demo_tpu_torch import make_step

    config, traffic = cell["config"], cell["traffic"]
    scene = gen.program_scene(config, traffic)
    state = gen.program_state(scene, config, traffic, SEED, torch.device("cpu"))
    step = make_step(scene)
    state = window.warm_up(step, state, traffic, lambda: None)
    if program == "without":  # a program that has no trace module
        monkeypatch.setitem(sys.modules, "cfd_demo_tpu_torch.trace", None)
    ctx = Context(cell)
    readers = [manifest.reader(n) for n in ("outer_rounds_per_step",
                                            "cavity_rounds_roofline")]
    returned = []
    from cfd_demo_tpu_torch.solver import piso

    inner = piso._substep_jnp

    def spy(*args, **kwargs):
        out = inner(*args, **kwargs)
        returned.append(out[-1])
        return out

    monkeypatch.setattr(piso, "_substep_jnp", spy)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        undo = [r.install(ctx) for r in readers]
        window.run(step, state, lambda: None, steps=steps)
        for u in reversed(undo):
            u()
    ctx.steps = steps
    return ctx, returned


@pytest.mark.parametrize("program", ["with_counter", "without"])
def test_outer_rounds_per_step_reads_the_solves_counts(program, monkeypatch):
    from cfd_demo_tpu_torch import trace as program_trace

    left = len(program_trace.rounds)
    ctx, returned = _traced_window(tiny(CELL), 3, program, monkeypatch)
    reader = manifest.reader("outer_rounds_per_step")
    assert len(returned) == 3
    if program == "without":
        assert reader.read(ctx) is None and "rounds" not in ctx.store
        return
    assert ctx.store["rounds"] == returned  # the same tensors, in order
    assert len(program_trace.rounds) == left  # taken out of the program's list
    rounds = sum(int(c[0]) for c in returned)
    assert reader.read(ctx) == pytest.approx(rounds / 3)
    assert 0 < reader.read(ctx) <= 20


def test_cavity_rounds_roofline_hand_count():
    # 1024^2, 20 rounds and 1050 sweeps a step: (1050 * 12 + 21 * 15) *
    # 1024^2 = 1.3542e10 operations, 202.1 us at 67 TFLOP/s; bytes 4 *
    # (2 * 1024 * 1025 + 7 * 1024^2) = 37.8 MB, 11.3 us at 3.35 TB/s:
    # bound by the operations.
    mod = manifest.reader("cavity_rounds_roofline")
    bytes_moved, flops = mod.work(20 * 4, 1050 * 4, 4, 1024, 1024)
    assert flops / 4 / 67e12 == pytest.approx(202.13e-6, rel=1e-4)
    assert bytes_moved / 4 / 3.35e12 == pytest.approx(11.27e-6, rel=1e-3)

    class Ctx(Context):
        def device_s_in(self, name):
            assert name == "cfd.kernel.solve_correct_rounds"
            return 4 * 8.2e-3

    ctx = Ctx(manifest.cell(CELL))
    ctx.steps = 4
    ctx.store["rounds"] = [torch.tensor([20, 1050], dtype=torch.int32)] * 4
    assert mod.read(ctx) == pytest.approx(100 * 202.13e-6 / 8.2e-3, rel=1e-4)
    assert manifest.reader("outer_rounds_per_step").read(ctx) == 20
    ctx.store = {}
    assert mod.read(ctx) is None


def test_cavity_rounds_roofline_on_a_cpu_window(monkeypatch):
    """The work of a real window of the tiny cell, and None for the
    device time there is none of on the CPU (no launch to match)."""
    ctx, returned = _traced_window(tiny(CELL), 2, monkeypatch=monkeypatch)
    mod = manifest.reader("cavity_rounds_roofline")
    assert mod.read(ctx) is None
    rounds = sum(int(c[0]) for c in returned)
    sweeps = sum(int(c[1]) for c in returned)
    assert sweeps >= rounds + 2 > 2
    got = mod.work(rounds, sweeps, 2, 20, 20)
    assert got[1] == (sweeps * 12 + (rounds + 2) * 15) * 400
