"""dtoh_copies_per_step: device-to-host copies a step in the traced
window's trace: the host reads of the tolerance exits (ROADMAP H5, H8),
which stall the host until the device catches up."""


def read(ctx):
    if not ctx.steps or not ctx.device_events:
        return None
    return sum(1 for e in ctx.device_events if e.is_dtoh) / ctx.steps
