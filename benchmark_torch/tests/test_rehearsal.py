"""The CPU rehearsal: the manifest's names and units, the roofline
arithmetic against hand counts, and the plain reference against the
program's plain path on each cell's route at a tiny size."""
import json
import re

import pytest
import torch

from benchmark_torch import manifest, peaks, run
from benchmark_torch.trace import Context

from conftest import CELLS, SEED, cell_of, tiny

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_manifest_names_units_and_files():
    bench = manifest.load()
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert len(json.dumps(bench)) < 64 * 1024
    metrics = bench["end_to_end"] + bench["per_layer"]
    names = ([m["name"] for m in metrics] + [c["name"] for c in bench["configs"]]
             + [w["name"] for w in bench["workloads"]])
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    assert all(UNIT.match(m["unit"]) for m in metrics)
    assert all(m["better"] in ("lower", "higher") for m in metrics)
    assert "setup_s" in [m["name"] for m in bench["end_to_end"]]
    assert all(0.01 <= m["bound"] <= 0.25 for m in bench["end_to_end"])
    e2e = {m["name"] for m in bench["end_to_end"]}
    for m in bench["per_layer"]:
        assert m["moves"] in e2e
        assert (manifest.HERE / "metrics" / f"{m['name']}.py").is_file()
    for w in bench["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert w["chips"] == 1 and 0 < len(w["why"]) <= 200
        cell = manifest.cell(w["name"])
        assert cell["config"]["name"] == w["config"]
        assert {"u", "v", "p", "dt"} <= set(cell["traffic"]["limits"]) <= {
            "u", "v", "p", "dt", "residual"}
        assert len([m for m in cell["end_to_end"] if m["name"] != "setup_s"]) >= 1
        assert cell["per_layer"]
    for c in bench["configs"]:
        assert c["file"].startswith("benchmark_torch/configs/") and len(c["source"]) <= 200
        plain = manifest.reference(c["file"])  # beside its file, or reference.py
        assert all(hasattr(plain, k) for k in ("plain_setup", "Stepper", "gaps", "FIELDS"))


class _Ctx(Context):
    def __init__(self, name, steps, device_s, store=None):
        cell = cell_of(name)
        super().__init__(cell)
        self.steps, self._device_s = steps, device_s
        self.store = store or {}

    def device_s_in(self, range_name):
        return self._device_s


def test_jacobi_roofline_hand_count():
    # 2048^2, 50 sweeps of 9 operations a cell and the last sweep's
    # change, 3 a cell: 453 * 2048^2 = 1.9e9 operations a step, 28.36
    # us at 67 TFLOP/s; 12 bytes a cell, 50.3 MB, 15.02 us at 3.35 TB/s.
    ops = 453 * 2048 * 2048
    assert ops / 67e12 == pytest.approx(28.356e-6, rel=1e-3)
    mod = manifest.reader("jacobi_roofline")
    got = mod.read(_Ctx("channel_2048.jacobi_fast", steps=10, device_s=10 * 475e-6))
    assert got == pytest.approx(100 * 28.356e-6 / 475e-6, rel=1e-3)
    assert mod.read(_Ctx("channel_800x264.rust_default", 10, 1.0)) is None


def test_rounds_roofline_hand_count():
    # 800x264, 20 rounds and 1050 sweeps: (1050 * 12 + 21 * 15) * 211,200
    # = 2.7276e9 operations, 40.71 us; bytes 4 * (2 * 264 * 801 + 7 *
    # 264 * 800) = 7.6 MB, 2.27 us: bound by the operations.
    counts = [torch.tensor([20, 1050], dtype=torch.int32)] * 4
    mod = manifest.reader("rounds_roofline")
    ctx = _Ctx("channel_800x264.rust_default", 4, 4 * 3.3e-3, {"rounds_counts": counts})
    assert mod.read(ctx) == pytest.approx(100 * 40.71e-6 / 3.3e-3, rel=1e-3)
    assert peaks.bound_s(4 * (2 * 264 * 801 + 7 * 264 * 800), 0) == pytest.approx(
        2.27e-6, rel=1e-2)


def test_counter_readers(monkeypatch):
    from cfd_demo_tpu_torch import trace as program_trace

    sweeps = manifest.reader("pressure_sweeps_per_step")
    batch = [torch.tensor([[3, 100], [5, 160]], dtype=torch.int32)] * 2
    assert sweeps.read(_Ctx("channel_800x264.batch8", 2, 0, {"substep_counts": batch})) == 160
    cycles = manifest.reader("vcycles_per_step")
    ctx = _Ctx("channel_2048.jacobi_fast", 10, 0)
    undo = cycles.install(ctx)
    monkeypatch.setattr(program_trace, "vcycles", program_trace.vcycles + 41)
    undo()
    assert cycles.read(ctx) == pytest.approx(4.1)
    ctx.store = {}
    assert cycles.read(ctx) is None


@pytest.mark.parametrize("route", ["plain", "kernel"])
def test_sweeps_on_the_kernel20_route(route, monkeypatch):
    """batch8's route at a tiny batch: ``piso.substep_batch``, kernel
    20's wrapper. On the CPU it runs its plain version, which calls
    ``piso._substep_jnp``: the reader counts that substep once
    ("plain"). On the card the kernel calls no ``_substep_jnp``
    ("kernel": the plain version stubbed by the unwrapped substep)."""
    import dataclasses

    from cfd_demo_tpu_torch import make_step
    from cfd_demo_tpu_torch.kernels import ensemble
    from cfd_demo_tpu_torch.solver import piso

    from benchmark_torch import scene as gen, window

    cell = tiny("channel_800x264.batch8")
    config, traffic = cell["config"], cell["traffic"]
    scene = gen.program_scene(config, traffic)
    state = gen.program_state(scene, config, traffic, SEED, torch.device("cpu"))
    step = make_step(scene)
    plain, unwrapped, returned = ensemble.substep_batch_plain, piso._substep_jnp, []

    def stand_in(u, v, p, pp0, dt_sub, nu, inlet, scene):
        if route == "plain":
            out = plain(u, v, p, pp0, dt_sub, nu, inlet, scene)
        else:
            jnp = dataclasses.replace(scene, opts=dataclasses.replace(
                scene.opts, pressure_impl="jnp"))
            out = unwrapped(jnp, u, v, p, pp0, dt_sub, nu, inlet)
        returned.append(out[-1])
        return out

    monkeypatch.setattr(ensemble, "substep_batch_plain", stand_in)
    reader = manifest.reader("pressure_sweeps_per_step")
    ctx = _Ctx("channel_800x264.batch8", 3, 0)
    undo = reader.install(ctx)
    try:
        window.run(step, state, lambda: None, steps=3)
    finally:
        undo()
    assert piso._substep_jnp is unwrapped and piso.substep_batch is ensemble.substep_batch
    assert len(returned) == len(ctx.store["substep_counts"]) == 3
    assert all(c.shape == (8, 2) for c in returned)
    want = sum(float(c[:, 1].max()) for c in returned) / 3
    assert want > 0 and reader.read(ctx) == pytest.approx(want)


@pytest.mark.parametrize("name", CELLS)
def test_reference_against_the_plain_path(name):
    result = run.measure(tiny(name), SEED, 0.3, False, device="cpu")
    assert result["correct"], result["checks"]
    assert result["attempted"] >= 1
    for k in ("u", "v", "p", "dt"):
        assert result["checks"][f"{k}_gap"]["value"] < 1e-5
    if "residual" in result["checks"]:
        assert result["checks"]["residual"]["value"] <= 1.0
    assert list(result)[-1] == "checks"
