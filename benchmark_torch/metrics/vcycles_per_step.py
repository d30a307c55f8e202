"""vcycles_per_step: MG_PRODUCTION V-cycles a step, from the launch
counters of kernels/mgp.py over the traced window: the aligned cycle
launches one ``jacobi_fused_k_corr`` a cycle on an even grid and two
``jacobi_fused_k_res`` on an odd one (a cycle on an interior of at most
mgp_coarse_stop a side is FDM alone and launches neither)."""

CORR = "mgp.jacobi_fused_k_corr.launches"
RES = "mgp.jacobi_fused_k_res.launches"


def read(ctx):
    if not ctx.steps:
        return None
    cycles = ctx.counters.get(CORR, 0) + ctx.counters.get(RES, 0) / 2
    return cycles / ctx.steps if cycles else None
