"""BENCHMARK.json and the files it names, found by name.

- a configuration: the ``file`` its entry names (``configs/<name>.json``);
- a cell's traffic: ``workloads/<cell name>.json``;
- a per-layer metric's reader: ``metrics/<metric name>.py``.

Adding a configuration, a cell or a metric is adding its entry and its
file; nothing here changes.
"""
from __future__ import annotations

import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent


def root() -> Path:
    """The checkout: the directory that holds BENCHMARK.json."""
    return HERE.parent


def load() -> dict:
    with open(root() / "BENCHMARK.json") as f:
        return json.load(f)


def _by_name(entries, name, what):
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"BENCHMARK.json has no {what} named {name!r}")


def cell(name: str, bench: dict | None = None) -> dict:
    """Everything one cell needs: its entry, configuration, traffic, and
    the end-to-end and per-layer metrics it reports."""
    bench = bench or load()
    wl = _by_name(bench["workloads"], name, "workload")
    cfg_entry = _by_name(bench["configs"], wl["config"], "configuration")
    with open(root() / cfg_entry["file"]) as f:
        config = json.load(f)
    with open(HERE / "workloads" / f"{name}.json") as f:
        traffic = json.load(f)
    reports = lambda m: "workloads" not in m or name in m["workloads"]
    return {"workload": wl, "config": config, "traffic": traffic,
            "end_to_end": [m for m in bench["end_to_end"] if reports(m)],
            "per_layer": [m for m in bench["per_layer"] if reports(m)]}


def reader(metric_name: str):
    """The module ``metrics/<metric_name>.py``: ``install(ctx)`` (optional,
    before the traced window; returns a callable that undoes it) and
    ``read(ctx)``, which returns the metric's value or None."""
    path = HERE / "metrics" / f"{metric_name}.py"
    spec = importlib.util.spec_from_file_location(
        f"benchmark_torch.metrics.{metric_name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
