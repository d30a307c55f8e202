"""BENCHMARK.json and the files it names, found by name.

- a configuration: the ``file`` its entry names (``configs/<name>.json``);
- its plain reference: the module beside that file with its name
  (``configs/<name>.py``) where there is one, else ``reference.py``;
- a cell's traffic: ``workloads/<cell name>.json``;
- a per-layer metric's reader: ``metrics/<metric name>.py``.

Adding a configuration, a cell or a metric is adding its entry and its
files; nothing here changes.

A reference module is plain PyTorch or NumPy that imports nothing of the
program, and provides:

- ``plain_setup(config, traffic)``: what its stepper needs of the cell's
  files; raises for a flow it does not step (:func:`cell` asks it first,
  so that such a cell fails before its set-up);
- ``Stepper(setup, device, dtype)``: one scene's step in ``dtype``
  (float64: the reference; the precision below the configuration's: the
  control), with ``.step(fields, pp_given=None)`` returning the step's
  outputs from the ``FIELDS`` of its input state, and
  ``.takes_candidate_pp``: whether its step takes the candidate's p'
  (``pp_given``, a solve judged by its tolerance);
- ``gaps(got, want)``: the numbers compared with the traffic file's
  ``limits``, a dict of floats;
- ``FIELDS``: the State fields ``step`` reads (checks.py reads them of
  the program's states).
"""
from __future__ import annotations

import importlib.util
import json
import sys
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
    """Everything one cell needs: its entry, configuration, traffic and
    plain reference, and the end-to-end and per-layer metrics it
    reports."""
    bench = bench or load()
    wl = _by_name(bench["workloads"], name, "workload")
    cfg_entry = _by_name(bench["configs"], wl["config"], "configuration")
    with open(root() / cfg_entry["file"]) as f:
        config = json.load(f)
    with open(HERE / "workloads" / f"{name}.json") as f:
        traffic = json.load(f)
    plain = reference(cfg_entry["file"])
    plain.plain_setup(config, traffic)  # a flow it does not step fails here
    reports = lambda m: "workloads" not in m or name in m["workloads"]
    return {"workload": wl, "config": config, "traffic": traffic, "reference": plain,
            "end_to_end": [m for m in bench["end_to_end"] if reports(m)],
            "per_layer": [m for m in bench["per_layer"] if reports(m)]}


def reference(config_file: str):
    """The plain reference of the configuration in ``config_file`` (a
    checkout-relative path): the module beside it with its name, loaded
    once a process, else ``reference.py`` (module docstring)."""
    path = (root() / config_file).with_suffix(".py")
    if not path.is_file():
        from . import reference as channel
        return channel
    name = f"{HERE.name}.reference_of_{path.stem}"
    if name not in sys.modules:
        spec = importlib.util.spec_from_file_location(name, path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        sys.modules[name] = mod
    return sys.modules[name]


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
