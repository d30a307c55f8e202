"""The traced run: torch.profiler over a window stepped as the untraced
run steps it, and the trace reduced to what the per-layer readers read.

The trace is taken in the profiler's second cycle (the first, a short
rollout of the same steps, warms the tracer up). Every launch the
runtime recorded (``cudaLaunchKernel``, ``cudaMemcpyAsync`` ...) must
have its device operation in the trace, matched by correlation id;
where the profiler lost one, the trace is taken again, at most
``ATTEMPTS`` times, and then the run fails rather than report shares of
a trace that misses work.
"""
from __future__ import annotations

import bisect
import collections
import dataclasses
import json
import os
import pkgutil
import sys
import tempfile

import torch

from . import window

ATTEMPTS = 3
WINDOW = "bench.window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation")
LAUNCH_CALLS = ("cudaLaunch", "cudaMemcpy", "cudaMemset", "cuLaunch", "cuMemcpy",
                "cuMemset")


@dataclasses.dataclass
class Event:
    name: str
    cat: str
    start: float  # µs, the trace's clock
    end: float
    corr: int | None

    @property
    def is_dtoh(self) -> bool:
        return self.cat == "gpu_memcpy" and "DtoH" in self.name


class Context:
    """What a reader reads: the traced steps, the window, its device
    operations, the device time launched inside a marked range, what the
    readers' installs kept (``store``), and the cell's files."""

    def __init__(self, cell):
        self.config, self.traffic = cell["config"], cell["traffic"]
        self.store = {}
        self.steps = 0
        self.window_s = self.busy_s = 0.0
        self.device_events, self.host_events = [], []
        self.span = (0.0, 0.0)
        self._launch_at = {}

    def device_s_in(self, range_name: str) -> float:
        """Seconds of device operations whose launch call ran inside a
        host range of that name."""
        spans = [(e.start, e.end) for e in self.host_events
                 if e.cat == "user_annotation" and e.name == range_name]
        if not spans:
            return 0.0
        spans.sort()
        starts = [s for s, _ in spans]
        total = 0.0
        for e in self.device_events:
            t = self._launch_at.get(e.corr)
            if t is None:
                continue
            k = bisect.bisect_right(starts, t) - 1
            if k >= 0 and spans[k][0] <= t <= spans[k][1]:
                total += e.end - e.start
        return total * 1e-6


def counters() -> dict:
    """Every launch counter of the program's kernel wrappers:
    ``<module>.<function>.<attribute>`` for each int attribute whose
    name ends in ``launches``. No reader reads them (the V-cycles are
    the program's ``trace.vcycles``); the port's tests list them here."""
    import cfd_demo_tpu_torch.kernels as pkg

    out = {}
    for info in pkgutil.iter_modules(pkg.__path__):
        mod = __import__(f"{pkg.__name__}.{info.name}", fromlist=["_"])
        for fname, fn in vars(mod).items():
            if not callable(fn) or getattr(fn, "__module__", None) != mod.__name__:
                continue
            for attr, val in (vars(fn).items() if hasattr(fn, "__dict__") else ()):
                if attr.endswith("launches") and isinstance(val, int):
                    out[f"{info.name}.{fname}.{attr}"] = val
    return out


def _union_us(spans):
    busy, end = 0.0, float("-inf")
    for s, t in sorted(spans):
        if t > end:
            busy += t - max(s, end)
            end = t
    return busy


def _parse(path):
    with open(path) as f:
        raw = json.load(f)["traceEvents"]
    dev, host = [], []
    for e in raw:
        cat = e.get("cat")
        if e.get("ph") != "X" or cat not in DEVICE_CATS + HOST_CATS:
            continue
        corr = (e.get("args") or {}).get("correlation")
        ev = Event(e.get("name", ""), cat, float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)),
                   corr)
        (dev if cat in DEVICE_CATS else host).append(ev)
    return dev, host


def _lost(dev, host):
    """Launch calls the runtime recorded whose device operation the trace
    lacks."""
    seen = {e.corr for e in dev}
    return [e for e in host if e.cat in ("cuda_runtime", "cuda_driver")
            and e.name.startswith(LAUNCH_CALLS) and e.corr not in seen]


def capture(step, state, sync, ctx: Context, steps: int, warm_steps: int, sampler, installs):
    """Trace ``steps`` steps (after ``warm_steps`` untraced ones in the
    profiler's warm-up cycle), retaking a trace that lost launches.
    ``installs`` are the readers' install functions, run around the
    traced window only. Returns the state after the last window."""
    from torch.profiler import ProfilerActivity, profile, schedule

    for attempt in range(ATTEMPTS):
        fd, path = tempfile.mkstemp(suffix=".json", prefix="bench_trace_")
        os.close(fd)
        try:
            ctx.store.clear()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                         schedule=schedule(wait=0, warmup=1, active=1),
                         on_trace_ready=lambda p: p.export_chrome_trace(path)) as prof:
                state, *_ = window.run(step, state, sync, steps=warm_steps)
                prof.step()
                undo = [install(ctx) for install in installs]
                try:
                    with torch.profiler.record_function(WINDOW):
                        state, n, wall, _ = window.run(step, state, sync, steps=steps,
                                                       sampler=sampler)
                finally:
                    for u in reversed(undo):
                        u()
                prof.step()
            dev, host = _parse(path)
        finally:
            os.unlink(path)
        spans = [(e.start, e.end) for e in host
                 if e.cat == "user_annotation" and e.name == WINDOW]
        if len(spans) != 1:
            raise RuntimeError(f"the trace holds {len(spans)} '{WINDOW}' ranges")
        w0, w1 = spans[0]
        lost = [e for e in _lost(dev, host) if w0 <= e.start <= w1]
        if not lost:
            break
        where = ", ".join(f"{e.name} at {(e.start - w0) / max(w1 - w0, 1e-9):.3f}"
                          for e in lost[:8])
        print(f"trace {attempt + 1}: the profiler lost {len(lost)} launches of the "
              f"window (at a share of it): {where}", file=sys.stderr, flush=True)
    else:
        raise RuntimeError(f"every one of {ATTEMPTS} traces lost launches")
    dev = [dataclasses.replace(e, start=max(e.start, w0), end=min(e.end, w1))
           for e in dev if e.end > w0 and e.start < w1]
    if not dev:
        raise RuntimeError("the traced window holds no device operation")
    ctx.steps, ctx.window_s, ctx.span = n, (w1 - w0) * 1e-6, (w0, w1)
    ctx.device_events = dev
    ctx.host_events = [e for e in host if e.end > w0 and e.start < w1]
    ctx.busy_s = _union_us([(e.start, e.end) for e in dev]) * 1e-6
    ctx._launch_at = {e.corr: e.start for e in ctx.host_events
                      if e.cat in ("cuda_runtime", "cuda_driver") and e.corr is not None}
    return state


def breakdown(ctx: Context, top: int = 10) -> dict:
    """The device operations that took most time (seconds over the traced
    window, by name), and the device's idle time in the window by what
    the host was doing: the innermost host operation open at each idle
    gap's middle, or "python" where none was."""
    by_name = collections.Counter()
    for e in ctx.device_events:
        by_name[e.name[:120]] += (e.end - e.start) * 1e-6
    gaps, end = [], ctx.span[0]
    for s, t in sorted((e.start, e.end) for e in ctx.device_events):
        if s > end:
            gaps.append((end, s))
        end = max(end, t)
    if ctx.span[1] > end:
        gaps.append((end, ctx.span[1]))
    ops = sorted(((e.start, e.end, e.name) for e in ctx.host_events
                  if e.cat in ("cpu_op", "cuda_runtime", "cuda_driver")), key=lambda x: x[0])
    starts = [o[0] for o in ops]
    idle = collections.Counter()
    for a, b in gaps:
        mid = 0.5 * (a + b)
        label = "python"
        # the latest-starting operation open at mid is the innermost
        for k in range(bisect.bisect_right(starts, mid) - 1, max(-1, bisect.bisect_right(starts, mid) - 400), -1):
            if ops[k][1] >= mid:
                label = ops[k][2][:120]
                break
        idle[label] += (b - a) * 1e-6
    return {"device_ops": [[k, v] for k, v in by_name.most_common(top)],
            "idle_gaps": [[k, v] for k, v in idle.most_common(top)]}
