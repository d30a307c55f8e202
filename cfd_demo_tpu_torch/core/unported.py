"""The error raised for every feature outside the ported slice."""
from __future__ import annotations

# ROADMAP.md queue-1 items that port what the slice leaves out.
CAVITY = "queue 1 item 6b"         # CAVITY flow
BOX_FLOAT64 = "queue 1 item 6c"    # Box obstacles, float64 scenes
OTHER_SOLVERS = "queue 1 item 7"   # the aligned MG_PRODUCTION's and FDM's batches
BATCHES = "queue 1 item 9"         # MULTIGRID, legacy MG_PRODUCTION and JS/SECOND/QUICK/parabolic batches
DIFFERENTIABLE = "queue 1 item 11"  # SolverOptions.differentiable
SHARDED = "queue 1 item 12"         # the 2-D tier, mg_shmap, multi-process, --shard-batch


def unported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to cfd_demo_tpu_torch yet (ROADMAP.md {item})")
