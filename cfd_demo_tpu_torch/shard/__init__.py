"""The explicit row-sharded tier on a single-process row mesh
(↔ cfd_demo_tpu/shard/): :func:`make_mesh`, :func:`shard_state` /
:func:`gather_state`, :func:`make_step_shmap` / :func:`make_run_shmap`."""
from .mesh import RowMesh, gather_state, make_mesh, shard_state
from .step_shmap import make_run_shmap, make_step_shmap
