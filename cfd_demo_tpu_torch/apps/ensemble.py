"""Batched scene ensemble (BASELINE config 5), on the card.

Runs B independent scenes, a viscosity sweep from 1e-5 to 1e-2, as one
batched state: every field carries a leading batch dimension and each
scene converges on its own (↔ cfd_demo_tpu/apps/ensemble.py).

    python -m cfd_demo_tpu_torch.apps.ensemble --batch 64 --steps 200
    python -m cfd_demo_tpu_torch.apps.ensemble --nx 800 --ny 264 --batch 8
    python -m cfd_demo_tpu_torch.apps.ensemble --batch 16 --solver sor

The first two run the whole-substep kernel, a thread-block cluster a
scene (2 CTAs a scene at 256x96, 14 at 800x264 on an H100); a scene wider
than 1024 columns takes the batched Jacobi kernel. The third runs the
whole-substep kernel's red/black SOR form (a SOR scene beyond one
block's shared memory takes the plain masked SOR). ``--device cpu`` runs
the plain PyTorch versions instead.
"""
from __future__ import annotations

import sys
import time

import numpy as np
import torch

from ..core.config import (Cylinder, Grid, Semantics, SimulationParams,
                           solver_options_for)
from ..core.state import batch_state
from ..core.unported import SHARDED, unported
from ..solver.piso import make_run, make_scene
from .common import base_parser, params_from_args


def ensemble_scene(nx: int = 256, ny: int = 96, params=None):
    """The JAX app's scene (apps/ensemble.py:38-42): a 30x10 channel with
    one cylinder, Rust semantics with masked (per-scene) iteration."""
    grid = Grid(nx=nx, ny=ny, lx=30.0, ly=10.0,
                obstacles=(Cylinder(7.5, 5.0, 0.75),))
    return make_scene(grid, params or SimulationParams(dt=0.004, viscosity=1e-4),
                      solver_options_for(Semantics.RUST, early_exit=False))


def ensemble_state(scene, batch: int, device="cuda"):
    """B copies of the scene's initial state with viscosities
    geomspace(1e-5, 1e-2, B) (apps/ensemble.py:44-48)."""
    nus = torch.from_numpy(np.geomspace(1e-5, 1e-2, batch).astype(np.float32))
    return batch_state(scene.init_state(device), batch, nu=nus.to(device))


def main(argv=None):
    ap = base_parser(__doc__)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--shard-batch", action="store_true",
                    help="shard the batch axis over all devices")
    ap.add_argument("--nx", type=int, default=256)
    ap.add_argument("--ny", type=int, default=96)
    ap.add_argument("--device", default="cuda",
                    help="torch device; cpu runs the kernels' plain versions")
    ap.set_defaults(steps=200, dt=0.004, viscosity=1e-4)
    args = ap.parse_args(argv)
    if args.shard_batch:
        raise unported("--shard-batch", SHARDED)
    if (args.checkpoint or args.resume or args.autosave_every
            or args.out != ap.get_default("out")):
        # base_parser's options that this app, like the JAX one, never reads
        ap.error("the ensemble writes no output files and resumes no "
                 "checkpoint (--out, --checkpoint, --resume, --autosave-every)")
    dev = torch.device(args.device)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)

    scene = ensemble_scene(args.nx, args.ny, params_from_args(args))
    B, grid = args.batch, scene.grid
    state = ensemble_state(scene, B, dev)
    chunk = args.chunk
    run = make_run(scene, chunk)
    # The first chunk builds the kernels and warms the allocator:
    # excluded from throughput.
    t0 = time.perf_counter()
    state, _ = run(state)
    sync()
    print(f"build + first chunk: {time.perf_counter() - t0:.1f}s")
    done, t_total = chunk, 0.0
    while done < args.steps:
        t0 = time.perf_counter()
        state, _ = run(state)
        sync()
        t_total += time.perf_counter() - t0
        done += chunk
        print(f"step {done}: {B * (done - chunk) / t_total:.1f} scene-steps/s")

    u = state.u.cpu().numpy()
    assert np.isfinite(u).all()
    timed_steps = done - chunk
    if timed_steps > 0 and t_total > 0:
        cu = B * timed_steps * grid.nx * grid.ny / t_total
        print(f"ensemble of {B} scenes x {timed_steps} timed steps on {dev}: "
              f"{cu:.3e} cell-updates/s aggregate")
    # Spread across the sweep confirms per-element independence.
    print("max|u| per nu decile:",
          np.round([abs(u[k]).max() for k in range(0, B, max(B // 8, 1))], 3))
    return 0


if __name__ == "__main__":
    sys.exit(main())
