"""What decides ``correct``: the window's sampled steps against the plain
reference of the cell's configuration (manifest.py ``reference``).

Each sampled step's input state (the program's, as the window handed it
to the step) is stepped once by the reference in float64, on every
scene of a batch, and the step's outputs are held to it by the
reference's ``gaps``: for the channel reference (reference.py) u and v
as a share of the reference's largest speed, p as a share of its
largest |p|, the next dt as a share of dt; a solve to a tolerance is
held to its tolerance, the rest of the step to the reference. The worst
over the samples and scenes is compared with the cell's limits (the
traffic file's ``limits``), and the window's last state must be finite.
The control (calibrate.py) is the same reference computed in bfloat16.
"""
from __future__ import annotations

import math

import torch

from . import scene as gen

KEYS = ("u", "v", "p", "dt")


def readings(kept, cell: dict, device, dtype=torch.float64, against=None):
    """The gaps of each sampled step and scene of ``cell`` (manifest.py
    ``cell``): the program's outputs against the reference in ``dtype``,
    or with ``against`` true the reference in ``dtype`` (the control)
    against the float64 reference on the same inputs."""
    plain, config, traffic = cell["reference"], cell["config"], cell["traffic"]
    setup = plain.plain_setup(config, traffic)
    ref = plain.Stepper(setup, device, torch.float64 if against else dtype)
    alt = plain.Stepper(setup, device, dtype) if against else None
    scenes = traffic["batch"]["scenes"] if traffic.get("batch") else None
    out = []
    for _, before, after in kept:
        for b in range(scenes or 1):
            b = b if scenes else None
            inputs = gen.scene_fields(before, plain.FIELDS, b)
            got = alt.step(inputs) if alt else gen.scene_fields(after, plain.FIELDS, b)
            want = ref.step(inputs, got["p_prime"] if ref.takes_candidate_pp else None)
            out.append(plain.gaps(got, want))
    return out


def worst(samples) -> dict:
    """The largest of each number over the samples."""
    keys = [k for k in samples[0]] if samples else KEYS
    return {k: max(s[k] for s in samples) for k in keys} if samples else {}


def nonfinite(state) -> int:
    return int(sum(int((~torch.isfinite(x)).sum()) for x in (state.u, state.v, state.p)))


def _over(value, limit) -> bool:
    return math.isnan(value) or value > limit


def decide(samples, bad_cells: int, limits: dict):
    """(correct, failed, checks): ``failed`` counts the sampled steps
    (a batch: step and scene) that miss a limit, and the window's last
    state if it is not finite; ``checks`` gives each number with its
    limit, in the order the result line prints them."""
    top = worst(samples)
    name = lambda k: k if k == "residual" else f"{k}_gap"
    checks = {name(k): {"value": top.get(k, math.inf), "limit": lim}
              for k, lim in limits.items()}
    checks["nonfinite"] = {"value": bad_cells, "limit": 0}
    failed = sum(1 for s in samples if any(_over(s[k], limits[k]) for k in limits))
    failed += int(bad_cells > 0)
    correct = failed == 0 and len(samples) >= 1
    return correct, failed, checks
