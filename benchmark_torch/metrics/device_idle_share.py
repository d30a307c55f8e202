"""device_idle_share: the share of the traced window in which no
operation ran on the device, 100 * (1 - union of the device's operation
intervals / the window's wall time), from the profiler's trace."""


def read(ctx):
    if ctx.window_s <= 0:
        return None
    return 100.0 * (1.0 - ctx.busy_s / ctx.window_s)
