"""idle_step_rest_share: the share of the traced window in which the
device sat idle while the host was inside a ``cfd.step`` span and in
none of its phases: the step's own controls and glue (the inlet ramp,
the residual maxima, the substep count, the dt control, the new
state). Split as idle_between_steps_share.py sets out."""

from benchmark_torch import manifest


def read(ctx):
    split = manifest.reader("idle_between_steps_share")
    return split.share(ctx, split.REST)
