"""pressure_sweeps_per_step: Jacobi sweeps a step, as the solve reports
them. Each route's substep returns the int32 count of outer rounds and
sweeps it ran as its last output: ``piso._substep_jnp`` on the rounds
route ((2,): the rounds kernel's own [rounds, sweeps]) and on a batch's
plain route ((B, 2): kernel 12's counts summed over the step's solves),
``piso.substep_batch`` on a batch's kernel 20 route ((B, 2): the
kernel's own). Both are wrapped; a call made inside another wrapped
call (on the CPU, ``substep_batch`` runs ``_substep_jnp`` as its plain
version) is the same substep and is not counted again. For a batch the
most any scene ran: a launch lasts as long as its slowest scene. The
counts are kept on the device during the window and read after it."""

_TARGETS = ("_substep_jnp", "substep_batch")


def install(ctx):
    from cfd_demo_tpu_torch.solver import piso

    kept = ctx.store.setdefault("substep_counts", [])
    depth = 0  # wrapped calls under way
    wrapped = {name: getattr(piso, name) for name in _TARGETS if hasattr(piso, name)}

    def observe(inner):
        def observed(*args, **kwargs):
            nonlocal depth
            depth += 1
            try:
                out = inner(*args, **kwargs)
            finally:
                depth -= 1
            if depth == 0:
                kept.append(out[-1])
            return out
        return observed

    for name, inner in wrapped.items():
        setattr(piso, name, observe(inner))

    def undo():
        for name, inner in wrapped.items():
            setattr(piso, name, inner)

    return undo


def read(ctx):
    counts = ctx.store.get("substep_counts")
    if not counts or not ctx.steps:
        return None
    sweeps = [float(c[..., 1].max()) for c in counts]
    return sum(sweeps) / ctx.steps
