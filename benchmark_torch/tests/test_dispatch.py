"""A configuration brings its own plain reference beside its file and
states its own scene kind; the harness dispatches on them (manifest.py
``reference``, checks.py, scene.py ``program_scene``), at a tiny size on
the CPU."""
import json

import pytest
import torch

from benchmark_torch import checks, manifest, reference, run, scene as gen, window

from conftest import CELLS, SEED, cell_of, shrink, tiny
from test_control import altered

FIXTURES = manifest.HERE / "tests" / "fixtures"
# The fixture cells take rust_default's traffic file, which manifest.py
# finds by the cell's name.
FIXTURE_CELL = "channel_800x264.rust_default"


def _fixture(name: str) -> dict:
    with open(FIXTURES / f"{name}.json") as f:
        return json.load(f)


def _window(cell: dict, steps: int = 3):
    """The program's steps at the cell's tiny size: the sampled (index,
    state before, state after) of a short window after the warm-up."""
    from cfd_demo_tpu_torch import make_step

    config, traffic = cell["config"], cell["traffic"]
    scene = gen.program_scene(config, traffic)
    state = gen.program_state(scene, config, traffic, SEED, torch.device("cpu"))
    step = make_step(scene)
    state = window.warm_up(step, state, traffic, lambda: None)
    sampler = window.Sampler(traffic["check_steps"], SEED)
    window.run(step, state, lambda: None, steps=steps, sampler=sampler)
    return sampler.kept


def _direct(kept, config, traffic, dtype, against):
    """The channel reference called directly, as checks.readings called
    it before a configuration could name its reference."""
    setup = reference.plain_setup(config, traffic)
    ref = reference.Stepper(setup, "cpu", torch.float64 if against else dtype)
    alt = reference.Stepper(setup, "cpu", dtype) if against else None
    scenes = traffic["batch"]["scenes"] if traffic.get("batch") else None
    given = ref.exact is not None

    def fields(state, b):
        pick = (lambda x: x) if b is None else (lambda x: x[b])
        out = {k: pick(getattr(state, k)) for k in
               ("u", "v", "p", "p_prime", "dt", "nu", "target_inlet", "step")}
        out["step"] = int(out["step"])
        return out

    out = []
    for _, before, after in kept:
        for b in range(scenes or 1):
            b = b if scenes else None
            inputs = fields(before, b)
            got = alt.step(inputs) if alt else fields(after, b)
            want = ref.step(inputs, got["p_prime"] if given else None)
            out.append(reference.gaps(got, want))
    return out


@pytest.mark.parametrize("name", CELLS)
def test_readings_unchanged_through_the_dispatch(name):
    cell = tiny(name)
    config, traffic = cell["config"], cell["traffic"]
    assert cell["reference"] is reference
    kept = _window(cell)
    for dtype, against in ((torch.float64, None), (torch.bfloat16, True)):
        got = checks.readings(kept, cell, "cpu", dtype, against=against)
        assert got == _direct(kept, config, traffic, dtype, against)
        assert len(got) == len(kept) * (traffic["batch"]["scenes"] if traffic.get("batch")
                                        else 1)


def _fixture_cell(config: str) -> dict:
    """A cell of a fixture configuration, through manifest.cell with
    BENCHMARK.json's entries and the fixture's own: new files and
    entries only."""
    bench = manifest.load()
    entry = {"name": config, "source": "tests/fixtures", "reduced": [],
             "file": f"benchmark_torch/tests/fixtures/{config}.json",
             "why": "a configuration with its own plain reference"}
    wl = {"name": FIXTURE_CELL, "config": config, "traffic": "rust_default", "chips": 1,
          "why": "the fixture configuration under rust_default's traffic"}
    bench = {**bench, "configs": bench["configs"] + [entry], "workloads": [wl]}
    return shrink(manifest.cell(FIXTURE_CELL, bench))


OWN = [(config, mode) for config in ("channel_own_reference", "cavity_256")
       for mode in ("sound", "altered", "control")]


@pytest.mark.parametrize("config,mode", OWN, ids=[f"{c}-{m}" for c, m in OWN])
def test_a_configuration_brings_its_own_reference(config, mode):
    """The channel under a reference of its own, and the cavity, a scene
    kind no cell runs, under the cavity's reference: each through a run
    as the benchmark makes it."""
    cell = _fixture_cell(config)
    own = cell["reference"]
    assert own is not reference and own.__file__ == str(FIXTURES / f"{config}.py")
    assert cell["config"]["grid"]["nx"] == round(20 * cell["config"]["grid"]["lx"]
                                                 / cell["config"]["grid"]["ly"])
    made = own.made
    if mode == "control":
        samples = checks.readings(_window(cell), cell, "cpu", torch.bfloat16, against=True)
        correct, failed, _ = checks.decide(samples, 0, cell["traffic"]["limits"])
        assert not correct and failed >= 1
    else:
        result = run.measure(cell, SEED, 0.3, False, device="cpu",
                             step_wrap=altered if mode == "altered" else None)
        assert result["correct"] is (mode == "sound"), result["checks"]
    assert own.made > made  # the fixture's reference judged


def _kinds():
    """Configurations of scene kinds no cell runs, with rust_default's
    traffic, and the Scene each states, built here with make_scene."""
    import cfd_demo_tpu_torch as cfd

    traffic = cell_of("channel_800x264.rust_default")["traffic"]
    opts = traffic["solver"]["options"]
    channel = cell_of("channel_800x264.rust_default")["config"]
    base = dict(dt=0.005, viscosity=1e-6, target_inlet_velocity=1.0,
                pressure_solver=cfd.PressureSolver.JACOBI)
    app = cfd.Grid(nx=800, ny=264, lx=30.0, ly=10.0, obstacles=(cfd.Cylinder(7.5, 5.0, 0.75),))
    rust = cfd.solver_options_for(cfd.Semantics.RUST, **opts)

    def params(**kw):
        return cfd.SimulationParams(**{**base, **kw})

    def varied(top=None, **p):
        config = json.loads(json.dumps(channel))
        config.update(top or {})
        config["params"].update(p)
        return config

    return {
        "cavity": (_fixture("cavity_256"), cfd.make_scene(
            cfd.Grid(nx=256, ny=256, lx=1.0, ly=1.0, obstacles=()),
            cfd.SimulationParams(dt=0.0005, viscosity=0.001, target_inlet_velocity=1.0,
                                 pressure_solver=cfd.PressureSolver.JACOBI,
                                 flow_case=cfd.FlowCase.CAVITY), rust)),
        "js": (varied({"semantics": "js"}), cfd.make_scene(
            app, params(), cfd.solver_options_for(cfd.Semantics.JS, **opts))),
        "quick": (varied(velocity_scheme="quick"), cfd.make_scene(
            app, params(velocity_scheme=cfd.VelocityScheme.QUICK), rust)),
        "parabolic": (varied(inlet_profile="parabolic"), cfd.make_scene(
            app, params(inlet_profile=cfd.InletProfile.PARABOLIC), rust)),
    }, traffic


KINDS = ["cavity", "js", "quick", "parabolic"]


@pytest.mark.parametrize("kind", KINDS)
def test_program_scene_builds_what_the_configuration_states(kind):
    import cfd_demo_tpu_torch as cfd

    kinds, traffic = _kinds()
    config, want = kinds[kind]
    scene = gen.program_scene(config, traffic)
    assert scene == want
    if kind == "cavity":
        assert scene.params.flow_case == cfd.FlowCase.CAVITY and scene.grid.obstacles == ()
    if kind == "js":
        assert scene.opts.semantics == cfd.Semantics.JS


@pytest.mark.parametrize("kind", KINDS)
def test_the_channel_reference_refuses_another_flow(kind):
    kinds, traffic = _kinds()
    with pytest.raises(ValueError, match="a reference of its own beside its file"):
        reference.plain_setup(kinds[kind][0], traffic)


@pytest.mark.parametrize("kind", ["js", "quick", "parabolic"])
def test_a_refused_flow_fails_before_set_up(kind, tmp_path):
    """A configuration of a flow the channel reference does not step, with
    no reference beside its file, fails in manifest.cell: before any
    set-up on the card."""
    kinds, _ = _kinds()
    cfg = tmp_path / f"{kind}.json"
    cfg.write_text(json.dumps(kinds[kind][0]))
    entry = {"name": kind, "file": str(cfg)}
    wl = {"name": FIXTURE_CELL, "config": kind}
    with pytest.raises(ValueError, match="a reference of its own beside its file"):
        manifest.cell(FIXTURE_CELL, {**manifest.load(), "configs": [entry], "workloads": [wl]})


def test_a_float64_configuration_is_refused():
    config = {**cell_of("channel_800x264.rust_default")["config"], "precision": "float64"}
    with pytest.raises(ValueError, match="float32"):
        gen.program_scene(config, cell_of("channel_800x264.rust_default")["traffic"])


def test_tiny_keeps_the_cells_square():
    cell = cell_of("channel_800x264.rust_default")
    square = shrink({**cell, "config": _fixture("cavity_256")})
    assert (square["config"]["grid"]["nx"], square["config"]["grid"]["ny"]) == (20, 20)
    assert "substep_impl" not in square["traffic"]["solver"]["options"]
    plain = shrink(cell)
    assert (plain["config"]["grid"]["nx"], plain["config"]["grid"]["ny"]) == (60, 20)
    big = tiny("channel_2048.jacobi_fast")
    assert (big["config"]["grid"]["nx"], big["config"]["grid"]["ny"]) == (40, 40)
    assert big["traffic"]["solver"]["options"]["substep_impl"] == "pallas"
    assert cell["config"]["grid"]["nx"] == 800  # the cell itself is not cut
