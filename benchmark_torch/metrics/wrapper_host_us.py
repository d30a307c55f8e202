"""wrapper_host_us: the mean duration of the traced window's
``cfd.kernel.<function>`` spans, the host's cost of one call of a kernel
wrapper (its checks, its outputs' allocation, the launch through
ctypes), under the profiler. None where the program opens no such span."""

PREFIX = "cfd.kernel."


def read(ctx):
    spans = [e.end - e.start for e in ctx.host_events
             if e.cat == "user_annotation" and e.name.startswith(PREFIX)]
    return sum(spans) / len(spans) if spans else None
