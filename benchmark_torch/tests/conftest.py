"""Tiny CPU versions of the benchmark's cells, for the tests here.

The grid is cut to a few dozen cells a side (the same domain and
cylinder): ny = 40 for a grid of 2M cells or more, else 20, and nx =
ny lx / ly, so that the cells stay square (60x20 at 800x264, 40x40 at
2048^2, 20x20 for a unit cavity). The cells of 2M cells or more ask for
the fused route the program takes at full size (substep_impl "pallas");
every kernel wrapper runs its plain version on CPU tensors. Run from the checkout's root:

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
    cfg_file = f"{manifest.HERE.name}/configs/{config}.json"
    with open(manifest.root() / cfg_file) as f:
        cfg = json.load(f)
    with open(manifest.HERE / "workloads" / f"{name}.json") as f:
        traffic = json.load(f)
    e2e = [m for m in bench["end_to_end"] if "workloads" not in m]
    return {"workload": entry, "config": cfg, "traffic": traffic,
            "reference": manifest.reference(cfg_file), "end_to_end": e2e, "per_layer": []}


def shrink(cell: dict) -> dict:
    """A copy of ``cell`` at its tiny size (module docstring)."""
    cell = {**cell, "config": copy.deepcopy(cell["config"]),
            "traffic": copy.deepcopy(cell["traffic"])}
    g = cell["config"]["grid"]
    big = g["nx"] * g["ny"] >= 2_000_000
    if big:
        cell["traffic"]["solver"]["options"]["substep_impl"] = "pallas"
    g["ny"] = 40 if big else 20
    g["nx"] = round(g["ny"] * g["lx"] / g["ly"])
    cell["traffic"]["check_steps"] = 2
    return cell


def tiny(name: str) -> dict:
    return shrink(cell_of(name))
