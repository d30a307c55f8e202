"""cfd-demo-tpu in PyTorch, with hand-written CUDA kernels for the H100.

The port of ``cfd_demo_tpu`` (JAX/Pallas), which stays beside it as the
reference. Ported so far: one scene's Rust-semantics PISO step with
FIRST upwinding, the Jacobi, red/black and lexicographic SOR, FDM and
MG_PRODUCTION (aligned) solvers and a channel with cylinders
(``make_scene`` -> ``make_step`` / ``make_run``), and with Jacobi or SOR
a batch of such scenes stepped as one state (``batch_state``; the
ensemble app, ``apps/ensemble.py``), and the row-sharded step with the
Jacobi, SOR and FDM solvers on a single-process row mesh
(``cfd_demo_tpu_torch.shard``: ``make_mesh``, ``shard_state``,
``make_step_shmap``/``make_run_shmap``).
State lives on the card unless ``init_state(device="cpu")`` asks for the
CPU. Kernels are built from ``csrc/`` with nvcc at first use on a CUDA
device; on CPU tensors each kernel wrapper runs its plain PyTorch
version. This package never imports jax.
"""
from .core.config import (Box, Cylinder, FlowCase, Grid, InletProfile,
                          PressureSolver, Semantics, SimulationParams,
                          SolverOptions, VelocityScheme, cavity_grid,
                          default_grid, default_js_grid, solver_options_for)
from .core.state import (State, batch_state, init_state, set_params,
                         state_from_numpy, state_to_numpy)
from .solver.piso import (Scene, StepDiagnostics, make_run, make_scene,
                          make_step, piso_substep, step_fn)
from . import shard

__version__ = "0.1.0"
