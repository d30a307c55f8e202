"""The plain reference of the lid-driven cavity fixture (cavity_256.json),
for the dispatch tests: the channel reference's step (reference.py) with
the cavity's BCs, as a configuration of a new flow brings them beside its
file. The lid moves on u's row ny-1 at the ramped speed; the floor and
the side walls hold u = 0 and v = 0; p' is all-Neumann with the
bottom-left cell pinned to 0 (the pure-Neumann system's gauge). Only a
Jacobi solve: the exact solve of reference.py has the channel's outlet."""
from benchmark_torch import reference as channel

FIELDS = channel.FIELDS
gaps = channel.gaps
FLOW = {"semantics": "rust", "flow_case": "cavity", "velocity_scheme": "first",
        "inlet_profile": "uniform"}
made = 0


def plain_setup(config: dict, traffic: dict) -> dict:
    setup = channel.plain_setup(config, traffic, FLOW)
    if setup["solver"]["pressure"] != "jacobi":
        raise ValueError("the cavity reference has a Jacobi solve only")
    return setup


def pprime_bcs(pp):
    """Neumann on every side, rows first, then the bottom-left cell 0."""
    pp = pp.clone()
    pp[0, :] = pp[1, :]
    pp[-1, :] = pp[-2, :]
    pp[:, 0] = pp[:, 1]
    pp[:, -1] = pp[:, -2]
    pp[0, 0] = 0.0
    return pp


class Stepper(channel.Stepper):
    pprime_bcs = staticmethod(pprime_bcs)

    def __init__(self, *args, **kwargs):
        global made
        super().__init__(*args, **kwargs)
        made += 1

    def velocity_bcs(self, u, v, lid):
        """The lid on u's top row, u = 0 on the floor and the side walls
        (winning at the lid's corners), v = 0 on row 0 and on the side
        columns."""
        u, v = u.clone(), v.clone()
        u[-1, :] = lid
        u[0, :] = 0.0
        v[0, :] = 0.0
        u[:, 0] = 0.0
        u[:, -1] = 0.0
        v[:, 0] = 0.0
        v[:, -1] = 0.0
        return u.masked_fill(self.masks[2], 0.0), v.masked_fill(self.masks[3], 0.0)
