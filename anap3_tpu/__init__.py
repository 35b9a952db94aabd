"""anap3_tpu — lid-driven-cavity solver framework on JAX/XLA.

A ground-up JAX/XLA rebuild of the capabilities of
PN-CourseWork/02689-AdvancedNumericalAlgorithmP3: FV-SIMPLE and Chebyshev/Legendre pseudospectral
artificial-compressibility solvers for the 2D lid-driven cavity, with FSG
spectral multigrid, Ghia/Botella/Saad validation, an experiment harness
(config composition, tracking, sweeps, hyper-parameter optimization), and
vmapped/sharded batch execution across accelerator devices.

Design stance (accelerator-first, not a port):
- operator *construction* happens once on the host in float64 numpy;
- operator *application* is pure jnp under jit: dense (N+1)x(N+1) matmuls for
  the spectral path, fused elementwise stencils for the FV path;
- iteration loops are chunked ``lax.scan`` with frozen-lane early exit so
  convergence semantics match a per-iteration Python loop bit-for-bit;
- sweeps are ``vmap`` batches (optionally ``shard_map`` over a device mesh),
  not subprocess pools.
"""

__version__ = "0.1.0"
