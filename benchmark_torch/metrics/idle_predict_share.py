"""idle_predict_share: the share of the traced window in which the
device sat idle while the innermost phase span open at the idle gap's
middle was ``cfd.predict``: the predictor and the divergence (the fused
route's kernel 1 wrapper, or the plain predictor's PyTorch operations).
Split as idle_between_steps_share.py sets out."""

from benchmark_torch import manifest


def read(ctx):
    return manifest.reader("idle_between_steps_share").share(ctx, "cfd.predict")
