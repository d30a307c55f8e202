"""The one generator: a cell's configuration and traffic files made into
the program's scene and its seeded initial state.

A configuration file (``configs/<name>.json``) states the deployment:
the grid and its cylinders, the physical parameters and flow case, the
semantics and the precision, and what the seed draws; the plain
reference that judges it is found beside it (manifest.py
``reference``). A traffic file (``workloads/<cell>.json``) states how
the cell drives it: the pressure solver and every solver constant,
parameter overrides, the batch, the warm-up, how many steps the traced
run traces and the window's check samples, and the limits of the
check. Nothing here is particular to a cell.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


def merged_params(config: dict, traffic: dict) -> dict:
    return {**config["params"], **traffic.get("params", {})}


def program_scene(config: dict, traffic: dict):
    """The program's Scene for the cell, built from the files; a batch
    cell's scene comes from the ensemble app, and must equal it."""
    import cfd_demo_tpu_torch as cfd

    if config["precision"] != "float32":
        raise ValueError(f"the program's kernels are float32; configuration "
                         f"{config.get('name')!r} states {config['precision']}")
    semantics = cfd.Semantics(config["semantics"])
    g = config["grid"]
    grid = cfd.Grid(nx=g["nx"], ny=g["ny"], lx=g["lx"], ly=g["ly"],
                    obstacles=tuple(cfd.Cylinder(c["center_x"], c["center_y"], c["radius"])
                                    for c in g["cylinders"]))
    p = merged_params(config, traffic)
    params = cfd.SimulationParams(
        dt=p["dt"], viscosity=p["viscosity"],
        target_inlet_velocity=p["target_inlet_velocity"],
        velocity_scheme=cfd.VelocityScheme(p["velocity_scheme"]),
        inlet_profile=cfd.InletProfile(p["inlet_profile"]),
        pressure_solver=cfd.PressureSolver(traffic["solver"]["pressure_solver"]),
        flow_case=cfd.FlowCase(p["flow_case"]))
    opts = cfd.solver_options_for(semantics, **traffic["solver"]["options"])
    scene = cfd.make_scene(grid, params, opts)
    if traffic.get("batch"):
        from cfd_demo_tpu_torch.apps.ensemble import ensemble_scene
        app = ensemble_scene(g["nx"], g["ny"], params)
        if app != scene:
            raise ValueError(f"the ensemble app's scene {app} is not the one the "
                             f"files state, {scene}")
        scene = app
    return scene


def scene_viscosities(config: dict, traffic: dict):
    """One viscosity a scene: the batch's sweep (geometric, as the
    ensemble app spaces it), or the configuration's viscosity."""
    batch = traffic.get("batch")
    if not batch:
        return [merged_params(config, traffic)["viscosity"]]
    lo, hi = batch["viscosity_geomspace"]
    return [float(x) for x in np.geomspace(lo, hi, batch["scenes"]).astype(np.float32)]


def perturbation(config: dict, traffic: dict, seed: int, device):
    """The seed's draw: amplitude * N(0, 1) on every interior u and v
    face (u: rows 1..ny-2, columns 1..nx-1; v: rows 1..ny-1, columns
    1..nx-2), drawn on the device, one (du, dv) a scene."""
    g, amp = config["grid"], config["seed_draws"]["amplitude"]
    ny, nx = g["ny"], g["nx"]
    b = traffic["batch"]["scenes"] if traffic.get("batch") else 1
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (2 ** 63))
    du = torch.zeros((b, ny, nx + 1), device=device)
    dv = torch.zeros((b, ny, nx), device=device)
    du[:, 1:ny - 1, 1:nx] = amp * torch.randn((b, ny - 2, nx - 1), generator=gen, device=device)
    dv[:, 1:ny, 1:nx - 1] = amp * torch.randn((b, ny - 1, nx - 2), generator=gen, device=device)
    return du, dv


def program_state(scene, config: dict, traffic: dict, seed: int, device):
    """The program's initial state (at rest) with the seed's perturbation
    added; a batch through the ensemble app's ``ensemble_state``."""
    du, dv = perturbation(config, traffic, seed, device)
    batch = traffic.get("batch")
    if batch:
        from cfd_demo_tpu_torch.apps.ensemble import ensemble_state
        state = ensemble_state(scene, batch["scenes"], device)
        nus = torch.tensor(scene_viscosities(config, traffic), device=device)
        if not torch.equal(state.nu, nus):
            raise ValueError("the ensemble app's viscosities are not the sweep the "
                             "traffic file states")
        return dataclasses.replace(state, u=state.u + du, v=state.v + dv)
    state = scene.init_state(device)
    return dataclasses.replace(state, u=state.u + du[0], v=state.v + dv[0])


def scene_fields(state, fields, b=None) -> dict:
    """The State ``fields`` a reference reads (its ``FIELDS``), of one
    scene of a program State (scene ``b`` of a batch)."""
    pick = (lambda x: x) if b is None else (lambda x: x[b])
    out = {k: pick(getattr(state, k)) for k in fields}
    if "step" in out:
        out["step"] = int(out["step"])
    return out
