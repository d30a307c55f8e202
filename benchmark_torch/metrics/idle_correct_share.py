"""idle_correct_share: the share of the traced window in which the
device sat idle while the innermost phase span open at the idle gap's
middle was ``cfd.correct``: the corrector, the outer rounds' loop (a
batch's masked round loop) and the BCs, but not a round's solve, which
nests its own ``cfd.solve``. Split as idle_between_steps_share.py sets
out."""

from benchmark_torch import manifest


def read(ctx):
    return manifest.reader("idle_between_steps_share").share(ctx, "cfd.correct")
