"""Tiny CPU versions of the benchmark's cells, for the tests here.

The grid is cut to a few dozen cells a side (the same domain and
cylinder), and the 2048^2 cells ask for the fused route the program
takes at full size (substep_impl "pallas"); every kernel wrapper runs
its plain version on CPU tensors. Run from the checkout's root:

    python -m pytest benchmark_torch/tests -q
"""
import copy
import json

from benchmark_torch import manifest

# Every traffic file, those of cells BENCHMARK.json does not run yet too
# (channel_2048.mg_production, PERF.md section 7: their name's first part
# is the configuration).
CELLS = sorted(p.stem for p in (manifest.HERE / "workloads").glob("*.json"))
SEED = 2 ** 31 + 12345


def cell_of(name: str) -> dict:
    bench = manifest.load()
    if name in [w["name"] for w in bench["workloads"]]:
        return manifest.cell(name)
    config = name.split(".")[0]
    entry = {"name": name, "config": config, "traffic": name.split(".", 1)[1], "chips": 1}
    with open(manifest.HERE / "configs" / f"{config}.json") as f:
        cfg = json.load(f)
    with open(manifest.HERE / "workloads" / f"{name}.json") as f:
        traffic = json.load(f)
    e2e = [m for m in bench["end_to_end"] if "workloads" not in m]
    return {"workload": entry, "config": cfg, "traffic": traffic, "end_to_end": e2e,
            "per_layer": []}


def tiny(name: str) -> dict:
    cell = copy.deepcopy(cell_of(name))
    g = cell["config"]["grid"]
    if g["nx"] * g["ny"] >= 2_000_000:
        g["nx"] = g["ny"] = 40
        cell["traffic"]["solver"]["options"]["substep_impl"] = "pallas"
    else:
        g["nx"], g["ny"] = 60, 20
    cell["traffic"]["check_steps"] = 2
    return cell
