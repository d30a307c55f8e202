"""The check's control and faults at a tiny size on the CPU: the
reference in bfloat16 put in the program's place, and a run whose
timed step is broken underneath, must each come out not correct."""
import dataclasses

import pytest
import torch

from benchmark_torch import checks, run, scene as gen, window

from conftest import CELLS, SEED, tiny


@pytest.mark.parametrize("name", CELLS)
def test_bfloat16_control_misses_a_limit(name):
    cell = tiny(name)
    config, traffic = cell["config"], cell["traffic"]
    from cfd_demo_tpu_torch import make_step

    scene = gen.program_scene(config, traffic)
    state = gen.program_state(scene, config, traffic, SEED, torch.device("cpu"))
    step = make_step(scene)
    for _ in range(traffic["warmup_steps"]):
        state, _ = step(state)
    sampler = window.Sampler(2, SEED)
    window.run(step, state, lambda: None, steps=3, sampler=sampler)
    control = checks.readings(sampler.kept, cell, "cpu", torch.bfloat16, against=True)
    correct, failed, _ = checks.decide(control, 0, traffic["limits"])
    assert not correct and failed >= 1


def unchanged(step):
    """A step that returns its state as it came."""
    return lambda s: (step(s)[0].__class__(**vars(s)), None)


def altered(step):
    """A step whose answer is altered where it is produced: one u face
    of the outflow moved by a tenth of the inlet speed."""
    def wrapped(s):
        new, d = step(s)
        u = new.u.clone()
        u[..., u.shape[-2] // 2, -2] += 0.1
        return dataclasses.replace(new, u=u), d
    return wrapped


def half_batch(step):
    """A batch step that steps half of its scenes and leaves the others."""
    def wrapped(s):
        new, d = step(s)
        b = s.u.shape[0] // 2
        keep = {k: torch.cat([getattr(new, k)[:b], getattr(s, k)[b:]])
                for k in ("u", "v", "p", "p_prime", "dt")}
        return dataclasses.replace(new, **keep), d
    return wrapped


FAULTS = [(name, f) for name in CELLS for f in (unchanged, altered)] + [
    (name, half_batch) for name in CELLS if "batch" in name]


@pytest.mark.parametrize("name,fault", FAULTS,
                         ids=[f"{n}-{f.__name__}" for n, f in FAULTS])
def test_a_broken_step_is_not_correct(name, fault):
    result = run.measure(tiny(name), SEED, 0.3, False, device="cpu", step_wrap=fault)
    assert result["correct"] is False and result["failed"] >= 1
