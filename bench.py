#!/usr/bin/env python
"""Throughput of the plain XLA path on one GPU.

    python bench.py [--out chiprun_out/bench.json]

Stages (all on the card; the script fails if JAX finds no GPU):

- SG chunk throughput at N=128 Re=1000 (Chebyshev, smoothed lid) through
  the production chunk runner (models/runner.make_chunk_runner, 5000 steps
  per chunk), in float64 and float32 (Precision.HIGHEST);
- one profiler trace of a short SG chunk per dtype, reduced to device time
  per step, kernels per step and the device idle share
  (utils/profiling.device_activity);
- the numpy float64 reference step (models/reference.py) on the host, for
  scale;
- FV-SIMPLE iterations/s at N=128 (the XLA ``fv_step`` under ``lax.scan``)
  and the end-to-end FVSolver walls at the truth-run settings;
- the multi-device scaling stage (real devices when more than one is
  visible, else a virtual 8-device CPU mesh in a CPU-pinned subprocess,
  labelled ``dryrun-cpu8``).

Prints the card's name and power limit, then ONE JSON line with every
number beside the device it ran on.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent
sys.path.insert(0, str(REPO))

N = 128
STEPS_PER_CALL = 5000  # production chunk_size (conf/solver/spectral/sg.yaml)
TRACE_STEPS = 50
TARGET_SECONDS = 6.0


def _sg_setup(dtype: str):
    from anap3_tpu.models.params import SpectralParameters
    from anap3_tpu.models import spectral_sg as core

    params = SpectralParameters(
        name="spectral", Re=1000.0, nx=N, ny=N, basis_type="chebyshev",
        CFL=1.5, beta_squared=5.0, corner_treatment="smoothing",
        corner_smoothing=0.15, dtype=dtype)
    ops, _ = core.build_spectral_ops(params)
    return ops, core.initial_state(ops)


def _sg_runner(ops, steps: int):
    import jax.numpy as jnp

    from anap3_tpu.models import spectral_sg as core
    from anap3_tpu.models.runner import WARMUP_ITERS, make_chunk_runner

    runner = make_chunk_runner(lambda s: core.sg_step(ops, s),
                               lambda s: (s.u, s.v), steps, 0.0,
                               WARMUP_ITERS)
    ref = jnp.asarray(jnp.inf, ops.Dx.dtype)
    return lambda state, it: runner(state, jnp.int32(it), ref)[0]


def bench_sg(dtype: str) -> dict:
    """Steady-state chunk throughput (tolerance 0: the chunk never stops)."""
    import jax

    ops, state = _sg_setup(dtype)
    run = _sg_runner(ops, STEPS_PER_CALL)
    t0 = time.time()
    state = jax.block_until_ready(run(state, 0))
    compile_s = time.time() - t0
    n_calls, it = 0, STEPS_PER_CALL
    t0 = time.time()
    while time.time() - t0 < TARGET_SECONDS:
        state = run(state, it)
        it += STEPS_PER_CALL
        n_calls += 1
    state = jax.block_until_ready(state)
    elapsed = time.time() - t0
    return {
        f"sg_N{N}_{dtype}_steps_per_sec": n_calls * STEPS_PER_CALL / elapsed,
        f"sg_N{N}_{dtype}_first_call_seconds": compile_s,
        f"sg_N{N}_{dtype}_window_seconds": elapsed,
        f"sg_N{N}_{dtype}_finite": bool(np.isfinite(np.asarray(state.u)).all()),
    }


def trace_sg(dtype: str, out_dir: Path) -> dict:
    """Trace one warm TRACE_STEPS-step chunk; device time and kernels/step."""
    import jax

    from anap3_tpu.utils.profiling import device_activity, device_trace

    ops, state = _sg_setup(dtype)
    run = _sg_runner(ops, TRACE_STEPS)
    state = jax.block_until_ready(run(state, 0))
    trace_dir = out_dir / f"trace_sg_{dtype}"
    with device_trace(str(trace_dir)):
        state = jax.block_until_ready(run(state, TRACE_STEPS))
    act = device_activity(trace_dir)
    pre = f"sg_N{N}_{dtype}_trace"
    return {
        f"{pre}_device_us_per_step": act["busy_seconds"] / TRACE_STEPS * 1e6,
        f"{pre}_kernels_per_step": act["kernels"] / TRACE_STEPS,
        f"{pre}_idle_share": act["idle_share"],
        f"{pre}_window_seconds": act["window_seconds"],
        f"{pre}_top_kernels": act["top_kernels"],
    }


def bench_numpy_reference(max_steps: int = 30) -> float:
    """Host float64 numpy reference step rate (models/reference.py)."""
    from anap3_tpu.models.reference import ReferenceSG

    ref = ReferenceSG(N, 1000.0, "chebyshev", "smoothing", 0.15)
    ref.step()
    t0 = time.time()
    steps = 0
    while steps < max_steps and time.time() - t0 < TARGET_SECONDS:
        ref.step()
        steps += 1
    return steps / (time.time() - t0)


def _fv_params(re_: float):
    from anap3_tpu.models.params import FVParameters

    return FVParameters(
        name="fv", Re=re_, nx=N, ny=N, convection_scheme="TVD",
        limiter="MUSCL", alpha_uv=0.4, alpha_p=0.2, linear_solver_tol=1e-9,
        corner_treatment="none", dtype="auto", tolerance=1e-6,
        max_iterations=60000)


def bench_fv(chunk: int = 50) -> dict:
    """FV-SIMPLE iterations/s at N=128 (float64, XLA fv_step scan)."""
    import jax

    from anap3_tpu.models.fv import FVSolver, fv_step

    solver = FVSolver(_fv_params(100.0))
    ops = solver.ops

    @jax.jit
    def run_chunk(state):
        def body(s, _):
            return fv_step(ops, s)[0], ()
        return jax.lax.scan(body, state, None, length=chunk)[0]

    t0 = time.time()
    state = jax.block_until_ready(run_chunk(solver.state))
    compile_s = time.time() - t0
    n_calls = 0
    t0 = time.time()
    while time.time() - t0 < TARGET_SECONDS:
        state = run_chunk(state)
        n_calls += 1
    state = jax.block_until_ready(state)
    rate = n_calls * chunk / (time.time() - t0)
    return {
        f"fv_N{N}_iters_per_sec": rate,
        f"fv_N{N}_first_call_seconds": compile_s,
        f"fv_N{N}_finite": bool(np.isfinite(np.asarray(state.u)).all()),
    }


def bench_fv_walls() -> dict:
    """End-to-end FVSolver.solve walls at the truth-run settings (tol 1e-6,
    data/validation/fv/*/config.yaml)."""
    from anap3_tpu.models.fv import FVSolver

    out = {}
    for re_ in (100.0, 1000.0):
        solver = FVSolver(_fv_params(re_))
        t0 = time.time()
        solver.solve()
        m = solver.metrics
        tag = f"fv_N{N}_Re{int(re_)}"
        out[f"{tag}_wall_seconds"] = time.time() - t0
        out[f"{tag}_first_chunk_seconds"] = solver.first_chunk_time
        out[f"{tag}_iters"] = int(m.iterations)
        out[f"{tag}_converged"] = bool(m.converged)
    return out


def bench_multichip() -> dict:
    """Multi-device scaling: in-process on real devices when several are
    visible; otherwise on a virtual 8-device CPU mesh in a CPU-pinned
    subprocess (``dryrun-cpu8``: virtual devices share host cores, so those
    efficiencies are not hardware claims)."""
    import jax

    if len(jax.devices()) > 1:
        from anap3_tpu.parallel.scaling import measure_scaling

        vals = measure_scaling(jax.devices(), n=63, b_per_dev=2,
                               chunk=200, calls=3)
        mode = "real"
    else:
        env = {
            "PATH": os.environ.get("PATH", "/usr/bin:/bin"),
            "HOME": os.environ.get("HOME", str(REPO)),
            "PYTHONPATH": str(REPO),
            "JAX_PLATFORMS": "cpu",
            "XLA_FLAGS": "--xla_force_host_platform_device_count=8",
        }
        proc = subprocess.run(
            [sys.executable, "-m", "anap3_tpu.parallel.scaling"],
            cwd=REPO, env=env, capture_output=True, text=True, timeout=600,
            check=True)
        vals = json.loads(proc.stdout.strip().splitlines()[-1])
        mode = "dryrun-cpu8"
    out = {"multichip_mode": mode}
    out.update({f"multichip_{k}": v for k, v in vals.items()})
    return out


def _stage(msg: str, t0: float) -> None:
    print(f"[bench +{time.time() - t0:.0f}s] {msg}", file=sys.stderr,
          flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description="XLA-path throughput on a GPU")
    ap.add_argument("--out", type=Path, default=None,
                    help="also write the JSON result (and the traces) here")
    args = ap.parse_args(argv)
    t0 = time.time()

    import jax

    from anap3_tpu.utils.compile_cache import enable_compile_cache

    if jax.default_backend() != "gpu":
        raise SystemExit(f"bench.py needs a GPU; JAX backend is "
                         f"{jax.default_backend()!r}")
    enable_compile_cache()
    jax.config.update("jax_enable_x64", True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()
    print(smi, flush=True)
    dev = jax.devices()
    result = {"device": {"platform": dev[0].platform,
                         "kind": dev[0].device_kind, "count": len(dev)},
              "card": smi.splitlines(),
              "xla_flags": os.environ.get("XLA_FLAGS", "")}
    out_dir = args.out.parent if args.out else Path(tempfile.mkdtemp())
    out_dir.mkdir(parents=True, exist_ok=True)
    for dtype in ("float64", "float32"):
        _stage(f"SG N={N} {dtype} chunk throughput", t0)
        result.update(bench_sg(dtype))
    _stage("numpy reference", t0)
    result["numpy_reference_steps_per_sec"] = bench_numpy_reference()
    _stage("FV iterations/s", t0)
    result.update(bench_fv())
    _stage("FV end-to-end walls", t0)
    result.update(bench_fv_walls())
    _stage("multichip", t0)
    result.update(bench_multichip())
    for dtype in ("float64", "float32"):
        _stage(f"SG N={N} {dtype} trace", t0)
        result.update(trace_sg(dtype, out_dir))
    _stage("done", t0)
    line = json.dumps(result)
    if args.out:
        args.out.write_text(line + "\n")
    print(line, flush=True)


if __name__ == "__main__":
    main()
