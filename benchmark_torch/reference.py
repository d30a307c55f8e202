"""The plain reference: one PISO step of the channel flow in plain PyTorch.

It follows the upstream desktop app's step (TSultanov/cfd-demo,
src/model.rs: ``piso_step`` :529-730, the first-order upwind faces
:893-1248, the Jacobi solve :733-824 with the p' BCs :807-815, the
corrector :1334-1404, the divergence :1406-1440, the boundary conditions
:826-875 and the CFL control :877-889), in Rust semantics: the
unaveraged east v as the u-momentum's convecting velocity, the carried
p' as the warm start, up to ``outer_rounds`` extra corrector rounds,
each exiting at the exact sweep and round. It imports nothing of the
program and takes nothing the program made but the state it is handed.

Fields are laid out as the program lays them out (rows are y): u (ny,
nx+1), v (ny, nx) with the top face row j = ny identically zero and not
stored, p and p' (ny, nx). Every operation runs in ``dtype``: float64
is the reference, bfloat16 the control (the next precision below the
float32 the configuration states).

The solve is ``jacobi`` (damped sweeps with the p' BCs after each, a
do-while that stops after the first sweep whose largest interior change
is below ``tol``, or exactly ``iters`` sweeps when ``tol`` is 0) or
``tolerance``: a projection that iterates until its residual meets a
stated tolerance (MG_PRODUCTION: max|rhs - A p'| below
projection_div_tol / dt, or below the float32 noise floor mgp_floor *
eps * (denom max|p'| + max|rhs|)). Any p' that meets the tolerance is
a right answer, so that step is checked by its guarantee: the
candidate's own p' is taken, its residual against the reference's rhs
is reported as a share of the tolerance (``residual``), and the rest of
the step (predictor, divergence, corrector, BCs, dt) is the
reference's, from that p'. Where the reference itself has to solve (the
control), it solves the p' equation exactly, in the eigenbases of its
two one-dimensional operators (the operator is separable: obstacles
enter through the velocity masks only).

This is the reference of every configuration that has none of its own
beside its file (manifest.py ``reference``): it judges Rust-semantics
channel flow with FIRST faces and a uniform inlet, and
:func:`plain_setup` refuses any other flow. A reference of another flow
with the same step can take :func:`plain_setup` with its own ``flow``
and subclass :class:`Stepper` with its own BCs (``pprime_bcs``,
``velocity_bcs``).
"""
from __future__ import annotations

import math

import torch

F32_EPS = 2.0 ** -23  # float32's machine epsilon, as the noise floor counts it

# What the reference reads of a program State (scene.py ``scene_fields``).
FIELDS = ("u", "v", "p", "p_prime", "dt", "nu", "target_inlet", "step")

# The reference's names for the solver constants the traffic file states.
_SOLVER = {"jacobi_omega": "jacobi_omega", "jacobi_tol": "jacobi_tol",
           "jacobi_iters": "jacobi_iters", "outer_rounds": "outer_corrector_rounds",
           "outer_tol": "outer_corrector_tol", "ramp_up_steps": "ramp_up_steps",
           "cfl": "cfl", "dt_growth_cap": "dt_growth_cap"}

# The flow this reference steps, as a configuration (with its traffic's
# parameter overrides) states it.
_FLOW = {"semantics": "rust", "flow_case": "channel", "velocity_scheme": "first",
         "inlet_profile": "uniform"}


def plain_setup(config: dict, traffic: dict, flow: dict = _FLOW) -> dict:
    """What :class:`Stepper` needs of a cell's files: the grid and the
    solver, named in its own terms. Raises for a flow other than
    ``flow`` or a pressure solver this reference does not step."""
    stated = {**config["params"], **traffic.get("params", {}),
              "semantics": config["semantics"]}
    other = {k: stated.get(k) for k in flow if stated.get(k) != flow[k]}
    if other:
        raise ValueError(f"the reference steps {flow}; configuration "
                         f"{config.get('name')!r} states {other}: put a reference of "
                         f"its own beside its file (manifest.py reference)")
    opts = traffic["solver"]["options"]
    solver = {k: opts[v] for k, v in _SOLVER.items()}
    if traffic["solver"]["pressure_solver"] == "jacobi":
        solver["pressure"] = "jacobi"
    elif traffic["solver"]["pressure_solver"] == "mg-production":
        # a projection to a stated tolerance: the step checks its p' by
        # the tolerance, and the rest of the step exactly
        solver.update(pressure="tolerance", projection_div_tol=opts["projection_div_tol"],
                      mgp_floor=opts["mgp_floor"])
    else:
        raise ValueError(f"the reference has no plain "
                         f"{traffic['solver']['pressure_solver']} solve")
    return {"grid": config["grid"], "solver": solver}


def _shift(a, dj: int, di: int, shape=None):
    """out[j, i] = a[j + dj, i + di], zero outside ``a``; ``shape`` is
    the output's (ny, nx), ``a``'s own by default."""
    h, w = shape or a.shape
    out = a.new_zeros((h, w))
    j0, j1 = max(0, -dj), min(h, a.shape[0] - dj)
    i0, i1 = max(0, -di), min(w, a.shape[1] - di)
    if j1 > j0 and i1 > i0:
        out[j0:j1, i0:i1] = a[j0 + dj:j1 + dj, i0 + di:i1 + di]
    return out


def cylinder_masks(nx: int, ny: int, lx: float, ly: float, cylinders, device):
    """(mask_u, mask_v, mask_u_bc, mask_v_bc) of Rust semantics
    (model.rs:232-261, :869-874): a cell whose centre lies strictly
    inside a cylinder marks both its u faces and both its v faces for
    the predictor; the BCs zero its west u face and its south v face.
    Centres are placed in float32, as the upstream app computes them."""
    f32 = torch.float32
    dx = torch.tensor(lx / nx, dtype=f32)
    dy = torch.tensor(ly / ny, dtype=f32)
    xc = (torch.arange(nx, dtype=f32) + 0.5) * dx
    yc = (torch.arange(ny, dtype=f32) + 0.5) * dy
    inside = torch.zeros((ny, nx), dtype=torch.bool)
    for cx, cy, r in cylinders:
        ddx = xc[None, :] - torch.tensor(cx, dtype=f32)
        ddy = yc[:, None] - torch.tensor(cy, dtype=f32)
        inside |= ddx * ddx + ddy * ddy < torch.tensor(r * r, dtype=f32)
    mask_u = torch.zeros((ny, nx + 1), dtype=torch.bool)
    mask_u[:, 1:] |= inside          # the face east of an inside cell
    mask_u[:, 1:nx] |= inside[:, 1:]  # the face west of it, never face 0
    mask_u_bc = torch.zeros_like(mask_u)
    mask_u_bc[:, :nx] = inside
    mask_v = torch.zeros((ny, nx), dtype=torch.bool)
    mask_v[1:, :] |= inside[:-1, :]  # the face north of an inside cell
    mask_v[1:, :] |= inside[1:, :]   # the face south of it, never row 0
    mask_v_bc = inside.clone()
    return tuple(m.to(device) for m in (mask_u, mask_v, mask_u_bc, mask_v_bc))


def predict(u, v, dt, nu, dx, dy, mask_u, mask_v):
    """u*, v*: first-order upwind convection and diffusion, Rust's
    unaveraged convecting v in the u momentum; obstacle faces zero and
    faces outside the update ranges unchanged."""
    ny, nxp = u.shape
    nx = nxp - 1
    uC, uE, uW, uN, uS = u, _shift(u, 0, 1), _shift(u, 0, -1), _shift(u, 1, 0), _shift(u, -1, 0)
    v_n, v_s = _shift(v, 1, 0, u.shape), _shift(v, 0, 0, u.shape)
    e = torch.where(0.5 * (uC + uE) >= 0, uC, uE)
    w = torch.where(0.5 * (uW + uC) >= 0, uW, uC)
    n = torch.where(v_n >= 0, uC, uN)
    s = torch.where(v_s >= 0, uS, uC)
    conv = (e * e - w * w) / dx + (v_n * n - v_s * s) / dy
    lap = (uE - 2.0 * uC + uW) / (dx * dx) + (uN - 2.0 * uC + uS) / (dy * dy)
    cand = (u + dt * (-conv + nu * lap)).masked_fill(mask_u, 0.0)
    u_star = u.clone()
    u_star[1:ny - 1, 1:nx] = cand[1:ny - 1, 1:nx]

    vC, vE, vW, vN, vS = v, _shift(v, 0, 1), _shift(v, 0, -1), _shift(v, 1, 0), _shift(v, -1, 0)
    u_e, u_w = _shift(u, 0, 1, v.shape), _shift(u, 0, 0, v.shape)
    e = torch.where(u_e >= 0, vC, vE)
    w = torch.where(u_w >= 0, vW, vC)
    n = torch.where(0.5 * (vC + vN) >= 0, vC, vN)
    s = torch.where(0.5 * (vS + vC) >= 0, vS, vC)
    conv = (u_e * e - u_w * w) / dx + (n * n - s * s) / dy
    lap = (vE - 2.0 * vC + vW) / (dx * dx) + (vN - 2.0 * vC + vS) / (dy * dy)
    cand = (v + dt * (-conv + nu * lap)).masked_fill(mask_v, 0.0)
    v_star = v.clone()
    v_star[1:ny, 1:nx - 1] = cand[1:ny, 1:nx - 1]
    return u_star, v_star


def divergence(u, v, dt, dx, dy):
    """(div u) / dt over every pressure cell; v's top row reads 0."""
    return ((u[:, 1:] - u[:, :-1]) / dx + (_shift(v, 1, 0) - v) / dy) / dt


def pprime_bcs(pp):
    """Neumann bottom, top and left, 0 at the outlet column; rows first."""
    pp = pp.clone()
    pp[0, :] = pp[1, :]
    pp[-1, :] = pp[-2, :]
    pp[:, 0] = pp[:, 1]
    pp[:, -1] = 0.0
    return pp


def jacobi(pp, rhs, dx, dy, omega, tol, iters, bcs=pprime_bcs):
    """Damped Jacobi, the p' BCs ``bcs`` after every sweep. Returns (p',
    the last sweep's largest interior change, sweeps run)."""
    dx2, dy2 = dx * dx, dy * dy
    denom = 2.0 / dx2 + 2.0 / dy2
    n = 0
    while True:
        c = pp[1:-1, 1:-1]
        upd = ((pp[1:-1, 2:] + pp[1:-1, :-2]) / dx2 + (pp[2:, 1:-1] + pp[:-2, 1:-1]) / dy2
               - rhs[1:-1, 1:-1]) / denom
        new = omega * upd + (1.0 - omega) * c
        err = torch.amax(torch.abs(new - c))
        pp = pp.clone()
        pp[1:-1, 1:-1] = new
        pp = bcs(pp)
        n += 1
        if n >= max(iters, 1) or (tol > 0 and not bool(err >= tol)):
            return pp, err, n


class ExactSolver:
    """The p' equation ``(W + E - 2C) / dx^2 + (S + N - 2C) / dy^2 = rhs``
    on the interior cells, with the folds the p' BCs give (a Neumann
    neighbour reads the cell, the outlet reads 0), solved in the
    eigenbases of the x and y second-difference matrices. The bases are
    computed in float64 once a grid and cast to the solve's dtype."""

    def __init__(self, nx: int, ny: int, dx: float, dy: float, device):
        def second_difference(m, dirichlet_end):
            t = (torch.diag(torch.full((m,), -2.0, dtype=torch.float64))
                 + torch.diag(torch.ones(m - 1, dtype=torch.float64), 1)
                 + torch.diag(torch.ones(m - 1, dtype=torch.float64), -1))
            t[0, 0] = -1.0
            if not dirichlet_end:
                t[-1, -1] = -1.0
            return t.to(device)

        lx, self.qx = torch.linalg.eigh(second_difference(nx - 2, True))
        ly, self.qy = torch.linalg.eigh(second_difference(ny - 2, False))
        self.denom = ly[:, None] / (dy * dy) + lx[None, :] / (dx * dx)

    def solve(self, rhs):
        dt = rhs.dtype
        qx, qy, den = (x.to(dt) for x in (self.qx, self.qy, self.denom))
        inner = qy @ ((qy.T @ rhs[1:-1, 1:-1] @ qx) / den) @ qx.T
        pp = torch.nn.functional.pad(inner, (1, 1, 1, 1))
        return pprime_bcs(pp)


def correct(u_star, v_star, p, pp, dt, dx, dy):
    u = u_star.clone()
    u[:, 1:-1] = u_star[:, 1:-1] - dt * (pp[:, 1:] - pp[:, :-1]) / dx
    v = v_star.clone()
    v[1:, :] = v_star[1:, :] - dt * (pp[1:, :] - pp[:-1, :]) / dy
    return u, v, p + pp


def channel_bcs(u, v, inlet, mask_u_bc, mask_v_bc):
    """Uniform inlet, zero-gradient outlet, no-slip walls (overwriting
    the corners), v = 0 on row 0, then the obstacles' BC faces."""
    u = u.clone()
    u[:, 0] = inlet
    u[:, -1] = u[:, -2]
    u[0, :] = 0.0
    u[-1, :] = 0.0
    v = v.clone()
    v[0, :] = 0.0
    return u.masked_fill(mask_u_bc, 0.0), v.masked_fill(mask_v_bc, 0.0)


class Stepper:
    """One scene's PISO step in ``dtype`` (float64: the reference;
    bfloat16: the control). ``setup`` is :func:`plain_setup`'s.
    ``takes_candidate_pp``: a solve to a tolerance, whose step takes the
    candidate's p' (``step``'s ``pp_given``). The Jacobi solve's p' BCs
    are ``pprime_bcs``, the step's last BCs ``velocity_bcs``."""

    pprime_bcs = staticmethod(pprime_bcs)

    def __init__(self, setup: dict, device, dtype=torch.float64):
        g, s = setup["grid"], setup["solver"]
        self.nx, self.ny = g["nx"], g["ny"]
        self.dx, self.dy = g["lx"] / g["nx"], g["ly"] / g["ny"]
        self.solver, self.dtype = s, dtype
        self.masks = cylinder_masks(self.nx, self.ny, g["lx"], g["ly"],
                                    [(c["center_x"], c["center_y"], c["radius"])
                                     for c in g["cylinders"]], device)
        self.exact = (ExactSolver(self.nx, self.ny, self.dx, self.dy, device)
                      if s["pressure"] == "tolerance" else None)
        self.takes_candidate_pp = self.exact is not None

    def _solve(self, pp, rhs):
        s = self.solver
        if self.exact is not None:
            return self.exact.solve(rhs), None
        pp, err, _ = jacobi(pp, rhs, self.dx, self.dy, s["jacobi_omega"], s["jacobi_tol"],
                            s["jacobi_iters"], self.pprime_bcs)
        return pp, err

    def velocity_bcs(self, u, v, inlet):
        """The channel's BCs at the ramped inlet speed ``inlet``."""
        return channel_bcs(u, v, inlet, *self.masks[2:])

    def residual_share(self, pp, rhs, dt):
        """max|rhs - A p'| over the interior cells, as a share of the
        tolerance the solve states: max(projection_div_tol / dt, the
        float32 noise floor)."""
        s, dx2, dy2 = self.solver, self.dx * self.dx, self.dy * self.dy
        ap = ((pp[1:-1, 2:] + pp[1:-1, :-2] - 2.0 * pp[1:-1, 1:-1]) / dx2
              + (pp[2:, 1:-1] + pp[:-2, 1:-1] - 2.0 * pp[1:-1, 1:-1]) / dy2)
        r = (rhs[1:-1, 1:-1] - ap).abs().max()
        denom = 2.0 / dx2 + 2.0 / dy2
        floor = s["mgp_floor"] * F32_EPS * (denom * pp.abs().max() + rhs.abs().max())
        return float(r / torch.maximum(s["projection_div_tol"] / dt, floor))

    def step(self, fields: dict, pp_given=None) -> dict:
        """fields: u, v, p, p_prime, dt, nu, target_inlet (floats or 0-d
        tensors) and step (the steps taken). Returns u, v, p, p_prime and
        the next dt. ``pp_given``: a candidate's p' for a tolerance
        solve, taken in place of the reference's own (the result then
        also carries its ``residual`` share of the tolerance)."""
        s, t = self.solver, self.dtype
        u, v, p, pp = (fields[k].to(t) for k in ("u", "v", "p", "p_prime"))
        dev = u.device
        dt, nu, target = (torch.as_tensor(fields[k], device=dev).to(t)
                          for k in ("dt", "nu", "target_inlet"))
        ramp = min(float(fields["step"]) / s["ramp_up_steps"], 1.0)
        inlet = torch.as_tensor(ramp, device=dev).to(t) * target
        mask_u, mask_v = self.masks[:2]
        dx, dy = self.dx, self.dy
        u_star, v_star = predict(u, v, dt, nu, dx, dy, mask_u, mask_v)
        rhs = divergence(u_star, v_star, dt, dx, dy)
        residual = None
        if pp_given is not None:
            if self.exact is None or s["outer_rounds"]:
                raise ValueError("a given p' stands for one tolerance solve, no rounds")
            pp, err = pp_given.to(t), None
            residual = self.residual_share(pp, rhs, dt)
        else:
            pp, err = self._solve(pp, rhs)
        un, vn, pn = correct(u_star, v_star, p, pp, dt, dx, dy)
        rounds = 0
        while rounds < s["outer_rounds"] and bool(err >= s["outer_tol"]):
            rhs = divergence(un, vn, dt, dx, dy)
            pp, err = self._solve(pp, rhs)
            un, vn, pn = correct(un, vn, pn, pp, dt, dx, dy)
            rounds += 1
        un, vn = self.velocity_bcs(un, vn, inlet)
        max_vel = torch.maximum(un.abs().max(), vn.abs().max())
        cfl_h = torch.as_tensor(s["cfl"] * min(dx, dy), device=dev).to(t)
        dt_cfl = torch.where(max_vel == 0, dt, torch.minimum(cfl_h / torch.where(
            max_vel == 0, torch.ones_like(max_vel), max_vel), dt))
        new_dt = torch.where(dt_cfl > dt, torch.minimum(dt_cfl, dt * s["dt_growth_cap"]), dt_cfl)
        out = {"u": un, "v": vn, "p": pn, "p_prime": pp, "dt": new_dt}
        if residual is not None:
            out["residual"] = residual
        return out


def gaps(got: dict, ref: dict) -> dict:
    """How far a step's outputs lie from the reference's: u and v as a
    share of the reference's largest speed, p as a share of its largest
    |p|, dt as a share of dt, float64, plain floats; and where the
    reference took the candidate's p', that p's residual share of the
    solve's tolerance."""
    g = {k: got[k].double() for k in ("u", "v", "p", "dt")}
    r = {k: ref[k].double() for k in ("u", "v", "p", "dt")}
    speed = max(float(r["u"].abs().max()), float(r["v"].abs().max()), 1e-30)
    out = {k: float((g[k] - r[k]).abs().max()) / speed for k in ("u", "v")}
    out["p"] = float((g["p"] - r["p"]).abs().max()) / max(float(r["p"].abs().max()), 1e-30)
    out["dt"] = float((g["dt"] - r["dt"]).abs()) / max(float(r["dt"].abs()), 1e-30)
    if "residual" in ref:
        out["residual"] = ref["residual"]
    return {k: (math.inf if math.isnan(x) else x) for k, x in out.items()}
