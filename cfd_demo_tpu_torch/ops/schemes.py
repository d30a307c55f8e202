"""Upwind face reconstruction, FIRST order (↔ cfd_demo_tpu/ops/schemes.py).

first order: model.rs:893-1248 (Rust SIMD helpers). Each function
returns face values on the full staggered array shape; lanes outside the
update region carry junk that the predictor masks away.

Rust semantics: the u-momentum north/south convecting velocity, and the
sign that selects the upwind face, is the *unaveraged* east v neighbour
(get_v_north, model.rs:1056-1069).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..core.config import VelocityScheme
from ..core.unported import WIDEN_STEP, unported
from .stencil import Shifts


class UFaces(NamedTuple):
    e: torch.Tensor
    w: torch.Tensor
    n: torch.Tensor
    s: torch.Tensor
    v_n: torch.Tensor  # convecting velocity multiplier at the north face
    v_s: torch.Tensor


class VFaces(NamedTuple):
    e: torch.Tensor
    w: torch.Tensor
    n: torch.Tensor
    s: torch.Tensor
    u_e: torch.Tensor
    u_w: torch.Tensor


def _check(scheme: VelocityScheme, avg_conv_v: bool = False):
    if scheme != VelocityScheme.FIRST:
        raise unported(f"the {scheme.value} velocity scheme", WIDEN_STEP)
    if avg_conv_v:
        raise unported("JS semantics (averaged convecting v)", WIDEN_STEP)


def u_faces(u: torch.Tensor, v: torch.Tensor, nx: int, ny: int,
            scheme: VelocityScheme, avg_conv_v: bool) -> UFaces:
    """Face values for the u-momentum cell around u face (i, j); the
    adjacent v faces are v[j, i-1], v[j, i] (south) and v[j+1, i-1],
    v[j+1, i] (north)."""
    _check(scheme, avg_conv_v)
    su = Shifts(u, u.shape)
    sv = Shifts(v, u.shape)
    uC, uE, uW = su(0, 0), su(0, 1), su(0, -1)
    uN, uS = su(1, 0), su(-1, 0)
    vNE, vSE = sv(1, 0), sv(0, 0)
    # model.rs:893-908 (e), :929-941 (w), :966-981 (n), :1011-1026 (s)
    e = torch.where(0.5 * (uC + uE) >= 0, uC, uE)
    w = torch.where(0.5 * (uW + uC) >= 0, uW, uC)
    n = torch.where(vNE >= 0, uC, uN)
    s = torch.where(vSE >= 0, uS, uC)
    return UFaces(e, w, n, s, vNE, vSE)


def v_faces(u: torch.Tensor, v: torch.Tensor, nx: int, ny: int,
            scheme: VelocityScheme) -> VFaces:
    """Face values for the v-momentum cell around v face (i, j); the
    convecting u values are the unaveraged u[j, i] (west) and u[j, i+1]
    (east) (model.rs:600-601)."""
    _check(scheme)
    sv = Shifts(v, v.shape)
    su = Shifts(u, v.shape)
    vC, vE, vW = sv(0, 0), sv(0, 1), sv(0, -1)
    vN, vS = sv(1, 0), sv(-1, 0)
    u_e, u_w = su(0, 1), su(0, 0)
    # model.rs:1085-1095 (e), :1128-1142 (w), :1176-1185 (n), :1220-1229 (s)
    e = torch.where(u_e >= 0, vC, vE)
    w = torch.where(u_w >= 0, vW, vC)
    n = torch.where(0.5 * (vC + vN) >= 0, vC, vN)
    s = torch.where(0.5 * (vS + vC) >= 0, vS, vC)
    return VFaces(e, w, n, s, u_e, u_w)
