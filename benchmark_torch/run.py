"""Run one cell of the port's benchmark once.

    python3 -m benchmark_torch.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds BENCHMARK.json. Set-up (imports,
the CUDA context, loading or building the kernels, the scene, the
seeded state, the warm-up steps) counts as ``setup_s``. Then, with
``--trace 0``, the program's step runs in a closed loop for ``--seconds``
seconds and the cell's end-to-end metrics are taken by the host's clock
and CUDA events; with ``--trace 1`` a fixed number of steps runs under
torch.profiler and the cell's per-layer metrics are read from the trace
and the program's counters (metrics/<name>.py). Either way a seeded
sample of the window's steps is then held to the plain reference
(checks.py), the numbers compared are printed with their limits as the
last lines of standard error, and one JSON line is printed last on
standard output. Without a CUDA card, or with fewer cards than the cell
asks for, it prints no result and exits 2.
"""
import time

T0 = time.perf_counter()  # set-up is counted from here

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402

from . import manifest  # noqa: E402

# JAX and the JAX package the port was made from: the run may load none
# of them (compared by top-level name; the port's name begins with the
# JAX package's)
FORBIDDEN = ("jax", "jaxlib", "flax", "cfd_demo_tpu")


def _p95(values):
    return statistics.quantiles(values, n=20)[18] if len(values) > 1 else values[0]


def measure(cell: dict, seed: int, seconds: float, traced: bool, device="cuda",
            step_wrap=None, t0=None):
    """One run of ``cell`` on ``device``: the result line's dict (the
    checks last). ``step_wrap`` (tests only) wraps the program's step."""
    import torch

    from . import checks, scene as gen, trace, window
    from cfd_demo_tpu_torch import make_step

    t0 = T0 if t0 is None else t0
    config, traffic = cell["config"], cell["traffic"]
    dev = torch.device(device)
    on_cuda = dev.type == "cuda"
    sync = torch.cuda.synchronize if on_cuda else (lambda: None)
    scene = gen.program_scene(config, traffic)
    state = gen.program_state(scene, config, traffic, seed, dev)
    step = make_step(scene)
    if step_wrap is not None:
        step = step_wrap(step)
    state = window.warm_up(step, state, traffic, sync)
    events = window.Events(int(traffic["events_per_s"] * seconds) + 16) if on_cuda else None
    # the set-up's objects (the event pool among them) stay out of the
    # collector's passes: the window's collections cost what the
    # program's own garbage costs
    gc.collect()
    gc.freeze()
    setup_s = time.perf_counter() - t0
    sampler = window.Sampler(traffic["check_steps"], seed)
    units = {m["name"]: m["unit"] for m in cell["end_to_end"] + cell["per_layer"]}
    extra = {}
    if traced:
        ctx = trace.Context(cell)
        readers = {m["name"]: manifest.reader(m["name"]) for m in cell["per_layer"]}
        installs = [r.install for r in readers.values() if hasattr(r, "install")]
        state = trace.capture(step, state, sync, ctx, traffic["trace_steps"],
                              traffic["trace_warm_steps"], sampler, installs)
        values = {name: r.read(ctx) for name, r in readers.items()}
        steps = ctx.steps
        extra = {"busy_s": ctx.busy_s, "window_s": ctx.window_s}
        breakdown = trace.breakdown(ctx)
    else:
        state, steps, wall, gaps = window.run(step, state, sync, seconds=seconds,
                                              sampler=sampler, events=events)
        g = config["grid"]
        scenes = traffic["batch"]["scenes"] if traffic.get("batch") else 1
        values = {"cell_updates_per_s": scenes * g["nx"] * g["ny"] * steps / wall,
                  "step_ms_p95": _p95(gaps), "setup_s": setup_s}
    peak = torch.cuda.max_memory_allocated(dev) if on_cuda else 0
    bad = checks.nonfinite(state)
    del state, step
    gc.unfreeze()
    gc.collect()
    if on_cuda:
        torch.cuda.empty_cache()
    samples = checks.readings(sampler.kept, cell, dev)
    correct, failed, compared = checks.decide(samples, bad, traffic["limits"])
    metrics = {k: {"value": v, "unit": units[k]} for k, v in values.items()
               if k in units and v is not None}
    out = {"correct": correct, "attempted": steps, "failed": failed, "metrics": metrics,
           "device": _device(dev, cell, peak, extra)}
    if traced:
        out["breakdown"] = breakdown
    out["checks"] = compared
    return out


def _device(dev, cell, peak, extra):
    import torch

    from . import peaks

    if dev.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": peak,
                **extra}
    smi = peaks.card()
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
            "count": cell["workload"]["chips"], "memory_peak_bytes": peak,
            "power_limit": smi.get("power_limit", "not read"), **extra}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = manifest.cell(args.workload)
    import torch

    chips = cell["workload"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"benchmark: {args.workload} needs {chips} CUDA card(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result = measure(cell, args.seed, args.seconds, bool(args.trace))
    found = sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))
    if found:
        print(f"benchmark: the run imported {', '.join(found)}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"{name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
