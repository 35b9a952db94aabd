"""Device-level parallelism.

Replaces every concurrency mechanism of the reference (SURVEY §2.8):
- joblib process pools / LSF job arrays -> ``sweep.py``: vmapped device
  batches of whole solves, with per-lane convergence/divergence isolation,
  sharded over a ``jax.sharding.Mesh`` axis for multi-device scaling;
- Numba prange shared-memory loops -> XLA fusion inside one device (nothing to
  do here);
- no reference equivalent -> ``spatial.py``: tensor-parallel sharding of a
  single large solve via ``shard_map`` (columns of the field distributed over
  a mesh axis, x-derivative matmuls via psum_scatter collectives).
"""

from .sweep import SweepResult, run_batched_sweep, stack_ops  # noqa: F401
