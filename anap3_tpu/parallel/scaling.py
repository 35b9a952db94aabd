"""Multi-chip scaling efficiency measurement (dp sweeps + tp x-sharding).

Two production parallel axes get a throughput ratio against single-device
execution of the same program:

- **sweep (dp, weak scaling)**: ``b_per_dev`` lanes per device, batch axis
  sharded over the mesh (``parallel/sweep.py``) — efficiency is the
  per-device rate at ``d`` devices over the 1-device rate. Job arrays are
  embarrassingly parallel, so real hardware should sit near 100%.
- **x-sharding (tp, strong scaling)**: ONE solve row-sharded over the mesh
  with psum-scatter x-derivative collectives (``parallel/spatial.py``) —
  speedup of the identical chunk program at ``d`` devices vs 1.

On a **virtual CPU mesh** (``--xla_force_host_platform_device_count``) all
"devices" share the host's cores, so efficiencies well below 100% are
EXPECTED and say nothing about accelerator behavior — callers label such
values ``dryrun``. The day real multi-chip hardware appears, the same entry points
produce honest numbers (bench.py gates on ``len(jax.devices()) > 1``).

Reference counterpart: the reference scales sweeps via joblib/LSF job
arrays (scripts/submit_sweep.sh; conf/machine) and has no tensor-parallel
axis at all; this module is the measurement harness for both of this
package's replacements.
"""

from __future__ import annotations

import json
import time
from typing import Sequence

import numpy as np

__all__ = ["measure_sweep_scaling", "measure_tp_scaling", "measure_scaling"]


def _make_params(n: int, Re: float):
    from ..models.params import SpectralParameters

    return SpectralParameters(
        name="spectral", Re=float(Re), nx=n, ny=n, basis_type="chebyshev",
        CFL=1.5, beta_squared=5.0, corner_treatment="smoothing",
        corner_smoothing=0.15, dtype="float32")


def measure_sweep_scaling(devices: Sequence, n: int = 15, b_per_dev: int = 2,
                          chunk: int = 50, calls: int = 4) -> dict:
    """Weak-scaling sweep rate: b_per_dev lanes/device, sharded batch axis."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    from ..models import spectral_sg as core
    from .sweep import make_batched_chunk_runner, stack_ops

    runner = make_batched_chunk_runner(core.sg_step, lambda s: (s.u, s.v),
                                       chunk, 0.0)

    def build(B):
        ops_list, states = [], []
        for i in range(B):
            o, _ = core.build_spectral_ops(_make_params(n, 100.0 + 25.0 * i))
            ops_list.append(o)
            states.append(core.initial_state(o))
        return stack_ops(ops_list), jax.tree.map(lambda *a: jnp.stack(a),
                                                 *states)

    def rate_on(devs, B):
        mesh = Mesh(np.asarray(devs), ("sweep",))
        put = lambda x: jax.device_put(
            x, NamedSharding(mesh, P("sweep", *([None] * (x.ndim - 1)))))
        ops, states, done, conv_iter = jax.tree.map(
            put, (*build(B), jnp.zeros(B, bool), jnp.full(B, -1, jnp.int32)))
        start = jnp.asarray(0, jnp.int32)
        s, *_ = runner(ops, states, start, done, conv_iter)
        jax.block_until_ready(s.u)  # compile + warm
        t0 = time.time()
        for _ in range(calls):
            s, *_ = runner(ops, states, start, done, conv_iter)
        jax.block_until_ready(s.u)
        return B * chunk * calls / (time.time() - t0)

    d = len(devices)
    r1 = rate_on(devices[:1], b_per_dev)
    rd = rate_on(devices, b_per_dev * d)
    return {
        "sweep_lanes_per_device": b_per_dev,
        "sweep_rate_1dev": round(r1, 1),
        f"sweep_rate_{d}dev": round(rd, 1),
        "sweep_aggregate_speedup": round(rd / r1, 2),
        "sweep_weak_efficiency_pct": round(100.0 * (rd / d) / r1, 1),
    }


def measure_tp_scaling(devices: Sequence, n: int = 15, chunk: int = 50,
                       calls: int = 4) -> dict:
    """Strong-scaling x-sharded solve rate: one solve over d devices vs 1."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding

    from ..models import spectral_sg as core
    from . import spatial

    params = _make_params(n, 100.0)
    base_ops, _ = core.build_spectral_ops(params, dtype=jnp.float32)
    s0 = core.initial_state(base_ops)
    nf = int(s0.u.shape[0])
    d = len(devices)
    if nf % d:
        raise ValueError(f"grid rows {nf} must divide device count {d}")

    def rate_on(devs):
        mesh = Mesh(np.asarray(devs), ("x",))
        ops, _ = spatial.build_sharded_ops(params, dtype=jnp.float32)
        spec = spatial.make_step_ops_spec()
        ops = jax.tree.map(
            lambda x, s: jax.device_put(x, NamedSharding(mesh, s)), ops, spec)
        state = spatial.shard_state(
            mesh, (s0.u, s0.v, spatial.pad_pressure(s0.p)))
        runner = spatial.make_sharded_chunk_runner(mesh, ops, chunk, 0.0, 10)
        ref = jnp.asarray(jnp.inf, jnp.float32)
        state, *_ = runner(state, 0, ref)
        jax.block_until_ready(state[0])  # compile + warm
        t0 = time.time()
        for _ in range(calls):
            state, *_ = runner(state, 0, ref)
        jax.block_until_ready(state[0])
        return chunk * calls / (time.time() - t0)

    r1 = rate_on(devices[:1])
    rd = rate_on(devices)
    return {
        "tp_rate_1dev": round(r1, 1),
        f"tp_rate_{d}dev": round(rd, 1),
        "tp_speedup": round(rd / r1, 2),
        "tp_strong_efficiency_pct": round(100.0 * (rd / d) / r1, 1),
    }


def measure_scaling(devices: Sequence | None = None, n: int = 15,
                    b_per_dev: int = 2, chunk: int = 50,
                    calls: int = 4) -> dict:
    """Both axes; ``devices=None`` uses every visible device."""
    import jax

    devices = list(jax.devices() if devices is None else devices)
    out = {"n_devices": len(devices), "grid_n": n,
           "device_kind": str(devices[0])}
    out.update(measure_sweep_scaling(devices, n=n, b_per_dev=b_per_dev,
                                     chunk=chunk, calls=calls))
    out.update(measure_tp_scaling(devices, n=n, chunk=chunk, calls=calls))
    return out


if __name__ == "__main__":
    print(json.dumps(measure_scaling()))
