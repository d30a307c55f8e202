"""step_host_ms: the mean duration of the traced window's ``cfd.step``
spans, the host's time to enqueue one step (under the profiler, which
adds its own cost to every operation it records). None where the
program opens no such span."""


def read(ctx):
    spans = [e.end - e.start for e in ctx.host_events
             if e.cat == "user_annotation" and e.name == "cfd.step"]
    return 1e-3 * sum(spans) / len(spans) if spans else None
