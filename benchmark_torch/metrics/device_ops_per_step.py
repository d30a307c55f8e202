"""device_ops_per_step: operations on the device (kernels, copies and
fills) a step, counted in the traced window's trace. Fewer or cheaper
host calls a step (ROADMAP H2, H6, H8, H10) show here first."""


def read(ctx):
    if not ctx.steps or not ctx.device_events:
        return None
    return len(ctx.device_events) / ctx.steps
