"""Shared CLI plumbing for the apps (↔ cfd_demo_tpu/apps/common.py:17-50,
``base_parser`` and ``params_from_args`` only)."""
from __future__ import annotations

import argparse

from ..core.config import (FlowCase, InletProfile, PressureSolver,
                           SimulationParams, VelocityScheme)


def base_parser(desc: str) -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=desc)
    ap.add_argument("--steps", type=int, default=500)
    ap.add_argument("--chunk", type=int, default=50,
                    help="steps per make_run call (one timed chunk)")
    ap.add_argument("--out", default="out", help="output directory")
    ap.add_argument("--dt", type=float, default=0.005)
    ap.add_argument("--viscosity", type=float, default=1e-6)
    ap.add_argument("--inlet", type=float, default=1.0)
    ap.add_argument("--scheme", choices=[s.value for s in VelocityScheme],
                    default="first")
    ap.add_argument("--solver", choices=[s.value for s in PressureSolver],
                    default="jacobi")
    ap.add_argument("--profile", choices=[p.value for p in InletProfile],
                    default="uniform")
    ap.add_argument("--checkpoint", default=None,
                    help="write a resume checkpoint (.npz) at the end")
    ap.add_argument("--resume", default=None, help="checkpoint to resume from")
    ap.add_argument("--autosave-every", type=int, default=0, metavar="N",
                    help="also write --checkpoint atomically every ~N "
                         "steps DURING the rollout (rounded up to chunk "
                         "boundaries; skipped on non-finite residuals so "
                         "the last checkpoint is always good); 0 = off")
    return ap


def params_from_args(args, flow_case=FlowCase.CHANNEL) -> SimulationParams:
    return SimulationParams(
        dt=args.dt, viscosity=args.viscosity,
        target_inlet_velocity=args.inlet,
        velocity_scheme=VelocityScheme(args.scheme),
        inlet_profile=InletProfile(args.profile),
        pressure_solver=PressureSolver(args.solver),
        flow_case=flow_case)
