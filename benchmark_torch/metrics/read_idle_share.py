"""read_idle_share: the share of the traced window in which the device
sat idle in gaps that open while the host is inside a ``cfd.read`` span
(``cfd_demo_tpu_torch.trace.read_host``: a tolerance exit's, or the
substep count's, read of a device value), in percent. Such a gap opens
when the device has done all the host had enqueued before the read, and
lasts until the host, its read returned, enqueues the next operation:
the whole gap is the read's, the idle time a device-side exit would take
back. The gaps are those of idle_between_steps_share. None where the
window opens no such span (a route with no read, or a program without
the span)."""

import bisect

from benchmark_torch import manifest

SPAN = "cfd.read"
_gaps = manifest.reader("idle_between_steps_share")._gaps


def read(ctx):
    reads = sorted((e.start, e.end) for e in ctx.host_events
                   if e.cat == "user_annotation" and e.name == SPAN)
    if not reads or ctx.window_s <= 0:
        return None
    starts = [s for s, _ in reads]
    idle = 0.0
    for a, b in _gaps(ctx):
        k = bisect.bisect_right(starts, a) - 1
        if k >= 0 and reads[k][1] >= a:
            idle += b - a
    return 1e-4 * idle / ctx.window_s
