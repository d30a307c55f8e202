"""The readings the limits of ``correct`` are set from, on the card.

    python3 -m benchmark_torch.calibrate --workload <cell> --seed <n> [--seed <n> ...]
        [--seconds <s>] [--control <k>] [--out FILE.json]

In one process (set-up once), for each seed: the cell's seeded state,
its warm-up and a window of ``--seconds`` at the cell's own load, as
the timed run makes them, then from the seed's state again the traced
run's warm cycle and traced steps; the steps both sample are held to the
float64 reference as run.py holds them (the program's readings: the
lower ends of the limits). For the first ``--control`` seeds also the
control on the same sampled inputs:
the reference computed in bfloat16, the next precision below the
float32 the configuration states, put in the program's place (the upper
ends). It prints one JSON line a seed and a summary: the largest
program reading and the smallest control reading of each number. The
benchmark's own runs never run this.
"""
from __future__ import annotations

import argparse
import json
import statistics
import sys
import time

import torch

from . import checks, manifest, scene as gen, window


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, action="append", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--control", type=int, default=3)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("calibrate: needs a CUDA card", file=sys.stderr)
        return 2
    from cfd_demo_tpu_torch import make_step

    cell = manifest.cell(args.workload)
    config, traffic = cell["config"], cell["traffic"]
    dev = torch.device("cuda", 0)
    scene = gen.program_scene(config, traffic)
    step = make_step(scene)
    g = config["grid"]
    scenes = traffic["batch"]["scenes"] if traffic.get("batch") else 1
    rows = []
    sync = torch.cuda.synchronize
    for i, seed in enumerate(args.seed):
        # the timed run's window, then (from the seed's state again) the
        # traced run's: its warm cycle and its traced steps
        state = window.warm_up(step, gen.program_state(scene, config, traffic, seed, dev),
                               traffic, sync)
        timed = window.Sampler(traffic["check_steps"], seed)
        events = window.Events(int(traffic["events_per_s"] * args.seconds) + 16)
        state, n, wall, gaps = window.run(step, state, sync, seconds=args.seconds,
                                          sampler=timed, events=events)
        bad = checks.nonfinite(state)
        state = window.warm_up(step, gen.program_state(scene, config, traffic, seed, dev),
                               traffic, sync)
        state, *_ = window.run(step, state, sync, steps=traffic["trace_warm_steps"])
        traced = window.Sampler(traffic["check_steps"], seed)
        state, *_ = window.run(step, state, sync, steps=traffic["trace_steps"], sampler=traced)
        bad += checks.nonfinite(state)
        del state
        kept = timed.kept + traced.kept
        t = time.perf_counter()
        program = checks.readings(kept, cell, dev)
        row = {"seed": seed, "steps": n, "sampled": [k[0] for k in timed.kept],
               "cell_updates_per_s": scenes * g["nx"] * g["ny"] * n / wall,
               "step_ms_p95": statistics.quantiles(gaps, n=20)[18], "nonfinite": bad,
               "program": checks.worst(program),
               "program_traced": checks.worst(program[len(program) * len(timed.kept)
                                                      // len(kept):]),
               "reference_s": (time.perf_counter() - t) / 2}
        if i < args.control:
            row["control"] = checks.worst(checks.readings(
                kept, cell, dev, dtype=torch.bfloat16, against=True))
        print(json.dumps(row), flush=True)
        rows.append(row)
        del timed, traced, kept
    keys = list(rows[0]["program"])
    summary = {"workload": args.workload,
               "lower": {k: max(r["program"][k] for r in rows) for k in keys},
               "upper": {k: min(r["control"][k] for r in rows if "control" in r)
                         for k in keys} if args.control else {},
               "limits": traffic["limits"]}
    print(json.dumps(summary), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"rows": rows, "summary": summary}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
