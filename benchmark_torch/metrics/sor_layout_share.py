"""sor_layout_share: the share of the pressure solve's device time spent
on the colour-split layout: the device time of the operations launched
inside the program's ``cfd.sor.layout`` spans (the colour-split SOR
chain's split of p' and rhs, and its join) over that of the operations
launched inside its ``cfd.solve`` spans, in percent. What a chain that
kept the split layout, or worked on the full one, would save of the
solve. None where the program opens no such span (another route or
solver, or a program without it) or the window launched nothing
inside ``cfd.solve``."""

LAYOUT, SOLVE = "cfd.sor.layout", "cfd.solve"


def read(ctx):
    layout, solve = ctx.device_s_in(LAYOUT), ctx.device_s_in(SOLVE)
    if layout <= 0 or solve <= 0:
        return None
    return 100.0 * layout / solve
