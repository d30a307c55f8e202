"""pressure_sweeps_per_step: Jacobi sweeps a step, as the solve reports
them. The rounds route and the batch's plain route both go through the
step's ``_substep_jnp``, whose last output is the int32 count of outer
rounds and sweeps run ((2,) for a scene: the rounds kernel's own
[rounds, sweeps]; (B, 2) for a batch: each scene's, kernel 12's counts
summed over the step's solves). For a batch the most any scene ran: a
launch lasts as long as its slowest scene. The counts are kept on the
device during the window and read after it."""

_TARGET = "_substep_jnp"


def install(ctx):
    from cfd_demo_tpu_torch.solver import piso

    inner = getattr(piso, _TARGET, None)
    if inner is None:
        return lambda: None
    kept = ctx.store.setdefault("substep_counts", [])

    def observed(*args, **kwargs):
        out = inner(*args, **kwargs)
        kept.append(out[-1])
        return out

    setattr(piso, _TARGET, observed)
    return lambda: setattr(piso, _TARGET, inner)


def read(ctx):
    counts = ctx.store.get("substep_counts")
    if not counts or not ctx.steps:
        return None
    sweeps = [float(c[..., 1].max()) for c in counts]
    return sum(sweeps) / ctx.steps
