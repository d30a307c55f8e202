"""Upwind face reconstruction (↔ cfd_demo_tpu/ops/schemes.py).

* first order: model.rs:893-1248 (Rust SIMD helpers), index.html:382-417
  (u), :564-591 (v)
* second order: model.rs:911-1053 (u), :1098-1248 (v); index.html:418-470
  (u), :593-641 (v)
* QUICK (JS only): index.html:471-549 (u), :643-723 (v)

Each function returns face values on the full staggered array shape;
lanes outside the update region carry junk that the predictor masks
away. The expressions keep the JAX package's operation order term for
term (e.g. ``((-uW + 6 uC) + 3 uE) / 8``), so the two round alike.

``row_offset`` is the global row of the arrays' row 0 when they are a
row block of a sharded field (``ny`` stays the global height).

Semantics: the u-momentum north/south convecting velocity is the
*unaveraged* east v neighbour in Rust (get_v_north, model.rs:1056-1069)
and the average of the two adjacent v faces in JS (index.html:396-404);
``avg_conv_v`` selects which. The SECOND/QUICK upwind *selection*
always uses the averaged v (model.rs:996, :1041).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..core.config import VelocityScheme
from .stencil import Shifts, col_index, row_index


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


def _lin(a, b):
    """1.5 a - 0.5 b, the second-order upwind extrapolation."""
    return 1.5 * a - 0.5 * b


def u_faces(u: torch.Tensor, v: torch.Tensor, nx: int, ny: int,
            scheme: VelocityScheme, avg_conv_v: bool, row_offset: int = 0) -> UFaces:
    """Face values for the u-momentum cell around u face (i, j); the
    adjacent v faces are v[j, i-1], v[j, i] (south) and v[j+1, i-1],
    v[j+1, i] (north)."""
    shape = u.shape
    su = Shifts(u, shape)
    sv = Shifts(v, shape)
    uC, uE, uW = su(0, 0), su(0, 1), su(0, -1)
    uN, uS = su(1, 0), su(-1, 0)
    vNE, vSE = sv(1, 0), sv(0, 0)
    v_n_avg = 0.5 * (sv(1, -1) + vNE)
    v_s_avg = 0.5 * (sv(0, -1) + vSE)
    v_n, v_s = (v_n_avg, v_s_avg) if avg_conv_v else (vNE, vSE)
    where = torch.where
    if scheme == VelocityScheme.FIRST:
        # model.rs:893-908 (e), :929-941 (w), :966-981 (n), :1011-1026 (s)
        e = where(0.5 * (uC + uE) >= 0, uC, uE)
        w = where(0.5 * (uW + uC) >= 0, uW, uC)
        n = where(v_n >= 0, uC, uN)
        s = where(v_s >= 0, uS, uC)
        return UFaces(e, w, n, s, v_n, v_s)
    uEE, uWW, uNN, uSS = su(0, 2), su(0, -2), su(2, 0), su(-2, 0)
    i, j = col_index(shape, u.device), row_index(shape, u.device, row_offset)
    if scheme == VelocityScheme.SECOND:
        # model.rs:911-1053 / index.html:425-464
        e = where(uC >= 0, where(i > 1, _lin(uC, uW), uC),
                  where(i < nx - 1, _lin(uE, uEE), uE))
        w = where(uW >= 0, where(i > 2, _lin(uW, uWW), uW), _lin(uC, uE))
        n = where(v_n_avg >= 0, where(j > 1, _lin(uC, uS), uC),
                  where(j < ny - 2, _lin(uN, uNN), uN))
        s = where(v_s_avg >= 0, where(j > 1, _lin(uS, uSS), uS), _lin(uC, uN))
    elif scheme == VelocityScheme.QUICK:
        # index.html:471-488 (e), :490-501 (w), :503-521 (n), :523-541 (s)
        e = where(uC >= 0,
                  where(i >= 2, (-uW + 6 * uC + 3 * uE) / 8, _lin(uC, uW)),
                  where(i <= nx - 2, (3 * uC + 6 * uE - uEE) / 8, uE))
        w = where(uW >= 0,
                  where(i >= 3, (-uWW + 6 * uW + 3 * uC) / 8, _lin(uW, uC)),
                  (3 * uW + 6 * uC - uE) / 8)
        n = where(v_n_avg >= 0,
                  where(j >= 2, (-uS + 6 * uC + 3 * uN) / 8, _lin(uC, uS)),
                  where(j < ny - 2, (3 * uC + 6 * uN - uNN) / 8, uN))
        s = where(v_s_avg >= 0,
                  where(j >= 2, (-uSS + 6 * uS + 3 * uC) / 8, _lin(uS, uC)),
                  where(j < ny - 1, (3 * uS + 6 * uC - uN) / 8, uC))
    else:
        raise ValueError(scheme)
    return UFaces(e, w, n, s, v_n, v_s)


def v_faces(u: torch.Tensor, v: torch.Tensor, nx: int, ny: int,
            scheme: VelocityScheme, row_offset: int = 0) -> VFaces:
    """Face values for the v-momentum cell around v face (i, j); the
    convecting u values are the unaveraged u[j, i] (west) and u[j, i+1]
    (east) in both references (model.rs:600-601, index.html:568/573)."""
    shape = v.shape
    sv = Shifts(v, shape)
    su = Shifts(u, shape)
    vC, vE, vW = sv(0, 0), sv(0, 1), sv(0, -1)
    vN, vS = sv(1, 0), sv(-1, 0)
    u_e, u_w = su(0, 1), su(0, 0)
    v_n_avg = 0.5 * (vC + vN)
    v_s_avg = 0.5 * (vS + vC)
    where = torch.where
    if scheme == VelocityScheme.FIRST:
        # model.rs:1085-1095 (e), :1128-1142 (w), :1176-1185 (n), :1220-1229 (s)
        e = where(u_e >= 0, vC, vE)
        w = where(u_w >= 0, vW, vC)
        n = where(v_n_avg >= 0, vC, vN)
        s = where(v_s_avg >= 0, vS, vC)
        return VFaces(e, w, n, s, u_e, u_w)
    vEE, vWW, vNN, vSS = sv(0, 2), sv(0, -2), sv(2, 0), sv(-2, 0)
    i, j = col_index(shape, v.device), row_index(shape, v.device, row_offset)
    if scheme == VelocityScheme.SECOND:
        # model.rs:1098-1248 / index.html:596-633
        e = where(u_e >= 0, where(i > 0, _lin(vC, vW), vC),
                  where(i < nx - 2, _lin(vE, vEE), vE))
        w = where(u_w >= 0, where(i > 1, _lin(vW, vWW), vW),
                  where(i < nx - 1, _lin(vC, vE), vC))
        n = where(v_n_avg >= 0, where(j > 1, _lin(vC, vS), vC),
                  where(j < ny - 1, _lin(vN, vNN), vN))
        s = where(v_s_avg >= 0, where(j > 1, _lin(vS, vSS), vS), _lin(vC, vN))
    elif scheme == VelocityScheme.QUICK:
        # index.html:645-661 (e), :663-673 (w), :675-692 (n), :694-711 (s)
        e = where(u_e >= 0,
                  where(i >= 2, (-vW + 6 * vC + 3 * vE) / 8, _lin(vC, vW)),
                  where(i < nx - 2, (3 * vC + 6 * vE - vEE) / 8, vE))
        w = where(u_w >= 0,
                  where(i >= 3, (-vWW + 6 * vW + 3 * vC) / 8, _lin(vW, vC)),
                  (3 * vW + 6 * vC - vE) / 8)
        n = where(v_n_avg >= 0,
                  where(j >= 2, (-vS + 6 * vC + 3 * vN) / 8, _lin(vC, vS)),
                  where(j < ny - 1, (3 * vC + 6 * vN - vNN) / 8, vN))
        s = where(v_s_avg >= 0,
                  where(j >= 2, (-vSS + 6 * vS + 3 * vC) / 8, _lin(vS, vC)),
                  where(j < ny - 1, (3 * vS + 6 * vC - vN) / 8, vC))
    else:
        raise ValueError(scheme)
    return VFaces(e, w, n, s, u_e, u_w)
