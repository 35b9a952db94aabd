"""Multi-host initialization and mesh construction.

The reference's only cross-host mechanism is LSF job arrays coordinating
through a shared MLflow server (SURVEY §2.8). The equivalent here for
sweeps larger than one host is SPMD: ``jax.distributed.initialize`` across
hosts, one global mesh, and the batch axis of ``parallel.sweep`` sharded
over every device (the file tracker stays the cross-process results bus
exactly as MLflow did for LSF).
"""

from __future__ import annotations

import logging
import os
from typing import Optional, Sequence

import numpy as np

log = logging.getLogger(__name__)

__all__ = ["initialize_distributed", "global_mesh",
           "distributed_sweep_worker", "launch_local_distributed_dryrun"]


def initialize_distributed(coordinator: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None) -> bool:
    """Initialize jax.distributed when running multi-host; no-op otherwise.

    Arguments default to the standard env vars (JAX_COORDINATOR_ADDRESS,
    JAX_NUM_PROCESSES, JAX_PROCESS_ID). Returns True when a multi-process
    runtime was initialized.
    """
    import jax

    coordinator = coordinator or os.environ.get("JAX_COORDINATOR_ADDRESS")
    n_proc = num_processes if num_processes is not None else \
        int(os.environ.get("JAX_NUM_PROCESSES", "0") or 0)
    pid = process_id if process_id is not None else \
        int(os.environ.get("JAX_PROCESS_ID", "-1"))
    if not coordinator and n_proc <= 1:
        return False
    try:
        jax.distributed.initialize(
            coordinator_address=coordinator,
            num_processes=n_proc or None,
            process_id=pid if pid >= 0 else None,
        )
        log.info("jax.distributed initialized: process %d of %d",
                 jax.process_index(), jax.process_count())
        return True
    except Exception as exc:
        log.warning("jax.distributed.initialize failed: %s", exc)
        return False


def global_mesh(axis_names: Sequence[str] = ("sweep",),
                axis_sizes: Optional[Sequence[int]] = None):
    """Mesh over ALL global devices (across hosts after initialization)."""
    import jax
    from jax.sharding import Mesh

    devices = np.array(jax.devices())
    if axis_sizes is None:
        shape = (devices.size,) + (1,) * (len(axis_names) - 1)
    else:
        shape = tuple(axis_sizes)
    return Mesh(devices.reshape(shape), tuple(axis_names))


def distributed_sweep_worker(coordinator: str, num_processes: int,
                             process_id: int, n: int = 12,
                             lanes_per_device: int = 1,
                             tolerance: float = 1e-3,
                             max_iterations: int = 5000) -> dict:
    """One SPMD process of a cross-process sweep (the dryrun/test worker).

    Initializes the distributed runtime, builds the global mesh, and drives
    a batch of SG lanes sharded over EVERY device of EVERY process through
    parallel.sweep.run_batched_sweep. All processes execute the identical
    program (SPMD); per-chunk host decisions ride process_allgather.

    Returns a summary dict (printed as one JSON line by __main__ so the
    parent can assert on it).
    """
    ok = initialize_distributed(coordinator, num_processes, process_id)
    import jax

    if num_processes > 1 and not ok:
        raise RuntimeError("distributed initialization failed")
    import jax.numpy as jnp

    from ..models import spectral_sg as core
    from ..models.params import SpectralParameters
    from .sweep import run_batched_sweep, stack_ops

    mesh = global_mesh(("sweep",))
    B = len(jax.devices()) * int(lanes_per_device)
    Res = np.linspace(100.0, 400.0, B)
    ops_list = []
    for Re in Res:
        p = SpectralParameters(Re=float(Re), nx=n, ny=n, dtype="float32")
        ops_list.append(core.build_spectral_ops(p, dtype=jnp.float32)[0])
    states = [core.initial_state(o) for o in ops_list]
    batched = jax.tree.map(lambda *a: jnp.stack(a), *states)
    res = run_batched_sweep(
        core.sg_step, lambda s: (s.u, s.v), stack_ops(ops_list), batched,
        tolerance=tolerance, max_iterations=max_iterations, chunk=100,
        mesh=mesh)
    return {
        "process_id": jax.process_index(),
        "process_count": jax.process_count(),
        "global_devices": len(jax.devices()),
        "local_devices": len(jax.local_devices()),
        "lanes": B,
        "converged": int(np.sum(res.converged)),
        "iterations": [int(i) for i in res.iterations],
    }


def launch_local_distributed_dryrun(num_processes: int = 2,
                                    devices_per_process: int = 2,
                                    n: int = 12, timeout: int = 600):
    """Spawn ``num_processes`` LOCAL worker processes, each with a virtual
    CPU device mesh, coordinated over a loopback TCP port — the same
    jax.distributed code path a real multi-host run uses, runnable on one
    machine. Returns the per-process summary dicts.

    The workers get a minimal environment pinned to the CPU, so none of
    them opens an accelerator the parent process may hold.
    """
    import json
    import socket
    import subprocess
    import sys
    from pathlib import Path

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    coordinator = f"127.0.0.1:{port}"
    repo = Path(__file__).resolve().parents[2]
    env = {
        "PATH": os.environ.get("PATH", "/usr/bin:/bin"),
        "HOME": os.environ.get("HOME", "/root"),
        "PYTHONPATH": str(repo),
        "JAX_PLATFORMS": "cpu",
        "XLA_FLAGS":
            f"--xla_force_host_platform_device_count={devices_per_process}",
    }
    procs = [
        subprocess.Popen(
            [sys.executable, "-m", "anap3_tpu.parallel.distributed",
             "--coordinator", coordinator,
             "--num-processes", str(num_processes),
             "--process-id", str(k), "--n", str(n)],
            cwd=repo, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)
        for k in range(num_processes)
    ]
    summaries = []
    errors = []
    for k, proc in enumerate(procs):
        try:
            out, err = proc.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            proc.kill()
            out, err = proc.communicate()
            errors.append(f"process {k} timed out")
            continue
        if proc.returncode != 0:
            errors.append(f"process {k} rc={proc.returncode}: {err[-1500:]}")
            continue
        for line in out.splitlines():
            if line.startswith("DISTRIBUTED_SWEEP "):
                summaries.append(json.loads(line.split(" ", 1)[1]))
    if errors:
        raise RuntimeError("distributed dryrun failed:\n" + "\n".join(errors))
    return summaries


if __name__ == "__main__":
    import argparse
    import json

    ap = argparse.ArgumentParser()
    ap.add_argument("--coordinator", required=True)
    ap.add_argument("--num-processes", type=int, required=True)
    ap.add_argument("--process-id", type=int, required=True)
    ap.add_argument("--n", type=int, default=12)
    args = ap.parse_args()
    summary = distributed_sweep_worker(args.coordinator, args.num_processes,
                                       args.process_id, n=args.n)
    print("DISTRIBUTED_SWEEP " + json.dumps(summary))
