"""The error raised for every feature outside the ported slice."""
from __future__ import annotations

# ROADMAP.md queue-1 items that port what the slice leaves out.
WIDEN_STEP = "queue 1 item 6"      # JS semantics, SECOND/QUICK, inlets, CAVITY, Box, float64
OTHER_SOLVERS = "queue 1 item 7"   # the aligned MG_PRODUCTION's and FDM's batches
BATCHES = "queue 1 item 9"         # MULTIGRID and legacy MG_PRODUCTION batches
DIFFERENTIABLE = "queue 1 item 11"  # SolverOptions.differentiable
SHARDED = "queue 1 item 12"         # sharded tiers, the ensemble's --shard-batch
ROUND_KERNEL = "queue 2 item 5"    # rounds_impl="pallas" (correct_div kernel)


def unported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to cfd_demo_tpu_torch yet (ROADMAP.md {item})")
