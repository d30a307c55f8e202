"""idle_solve_share: the share of the traced window in which the device
sat idle while the innermost phase span open at the idle gap's middle
was ``cfd.solve``: the pressure solve (its kernel wrappers, a chain's
exits; on the rounds route the rounds kernel, which corrects too), an
outer round's solve included. Split as idle_between_steps_share.py sets
out."""

from benchmark_torch import manifest


def read(ctx):
    return manifest.reader("idle_between_steps_share").share(ctx, "cfd.solve")
