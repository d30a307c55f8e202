"""idle_between_steps_share: the share of the traced window in which the
device sat idle while the host was in no ``cfd.step`` span: the
caller's loop between steps (here the benchmark's window).

This file also splits the whole idle time for the four other idle
readers. The gaps are those of ``trace.breakdown``: the union of the
window's device operations, and each gap between them credited to what
the host had open at the gap's middle. Here that is the innermost of the
program's phase spans (``cfd.predict``, ``cfd.solve``, ``cfd.correct``;
an outer round's solve nests in its correct), else the step's own code
where a ``cfd.step`` span is open, else the time between steps. The five
shares add up to ``device_idle_share``. Without a ``cfd.step`` span in
the window (a program without spans) every share is None; a phase that
never opens reads 0."""

import bisect

STEP = "cfd.step"
PHASES = ("cfd.predict", "cfd.solve", "cfd.correct")
REST, BETWEEN = "step_rest", "between_steps"


def _gaps(ctx):
    gaps, end = [], ctx.span[0]
    for s, t in sorted((e.start, e.end) for e in ctx.device_events):
        if s > end:
            gaps.append((end, s))
        end = max(end, t)
    if ctx.span[1] > end:
        gaps.append((end, ctx.span[1]))
    return gaps


def _split(ctx):
    marks = [(e.start, e.end, e.name) for e in ctx.host_events
             if e.cat == "user_annotation" and (e.name == STEP or e.name in PHASES)]
    steps = sorted((s, t) for s, t, n in marks if n == STEP)
    if not steps or ctx.window_s <= 0:
        return None
    phases = sorted(m for m in marks if m[2] in PHASES)
    step_starts, phase_starts = [s for s, _ in steps], [p[0] for p in phases]
    idle = dict.fromkeys(PHASES + (REST, BETWEEN), 0.0)
    for a, b in _gaps(ctx):
        mid = 0.5 * (a + b)
        k = bisect.bisect_right(step_starts, mid) - 1
        if k < 0 or steps[k][1] < mid:
            idle[BETWEEN] += b - a
            continue
        label = REST
        # the latest-starting phase of this step still open at mid is the
        # innermost: spans nest
        j = bisect.bisect_right(phase_starts, mid) - 1
        while j >= 0 and phases[j][0] >= steps[k][0]:
            if phases[j][1] >= mid:
                label = phases[j][2]
                break
            j -= 1
        idle[label] += b - a
    return {name: 1e-4 * us / ctx.window_s for name, us in idle.items()}


def share(ctx, name):
    """Percent of the window's wall time idle under ``name`` (a phase,
    REST or BETWEEN), or None without step spans."""
    if "idle_by_phase" not in ctx.store:
        ctx.store["idle_by_phase"] = _split(ctx)
    split = ctx.store["idle_by_phase"]
    return None if split is None else split[name]


def read(ctx):
    return share(ctx, BETWEEN)
