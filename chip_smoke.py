#!/usr/bin/env python
"""Prove on one GPU that the cavity solvers' main path runs and is right.

    python chip_smoke.py               # phases P0-P4 on one card
    python chip_smoke.py --four-cards  # only the 4-card sharded paths,
                                       # each against its one-card result

Everything runs in this one process, the only one that opens the card.
Phases, each printed with its result and wall time:

- P0 device: JAX must find a GPU (no CPU fallback); prints the card's name
  and power limit (nvidia-smi), the JAX version, XLA_FLAGS and the compile
  cache directory.
- P1 step parity: 10 ``sg_step``s at N=128 Re=1000 (Chebyshev, smoothed
  lid) in float64 and float32 (Precision.HIGHEST) against the plain float64
  numpy reference (models/reference.py).
- P2 ``main.py solver=spectral/fsg N=96 Re=1000 tolerance=1e-6``: converges
  and lands on the recorded smoothed-lid L2 floor vs data/validation/fv.
- P3 ``main.py solver=fv N=128 Re=100 tolerance=1e-6``: converges within
  0.25% L2 of the stored FV truth run.
- P4 ``main.py -m solver=spectral/sg N=32 Re=100,400,1000``: every lane of
  the vmapped batch converges, and the Re=100 lane matches a single run.

Runs go through ``main.main`` with ``dtype: auto`` (float64) and
``plots=false``; tracking goes to a temporary MLflow file store, from which
the checks read each run's logged metrics and solution.vts. Any failed
check raises, so the exit code is non-zero and the final JSON line
(``{"ok": true, "device": {...}}``) is printed only when every phase passed.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
sys.path.insert(0, str(REPO))

import numpy as np  # noqa: E402

import main as M  # noqa: E402
from anap3_tpu.utils import tracking as T  # noqa: E402
from anap3_tpu.utils.compile_cache import enable_compile_cache  # noqa: E402
from anap3_tpu.utils.vts import read_vts  # noqa: E402

# recorded smoothed-lid L2 floor vs the sharp-lid FV truth at Re=1000
# (every properly converged smoothed-lid solver lands there, STATUS.md)
FLOOR_U, FLOOR_V, FLOOR_TOL = 0.099, 0.075, 0.012
FV_L2_MAX = 0.0025         # float64 FV N=128 runs recorded 0.13-0.20%
FIELD_TOL = 1e-10          # float64 batched/sharded vs one-card fields


class SmokeFailure(AssertionError):
    pass


def check(name: str, ok: bool, detail: str = "") -> None:
    print(f"  [{'PASS' if ok else 'FAIL'}] {name} {detail}".rstrip(),
          flush=True)
    if not ok:
        raise SmokeFailure(f"{name}: {detail}")


def require_gpu(backend: str, count: int) -> None:
    """Refuse anything but a GPU backend with at least one device."""
    if backend != "gpu" or count < 1:
        raise SmokeFailure(
            f"needs a GPU: JAX backend is {backend!r} with {count} device(s)")


def parse_nvidia_smi(text: str) -> list:
    """``name, power.limit`` CSV rows (one per card) -> [(name, limit)]."""
    rows = []
    for line in text.strip().splitlines():
        name, sep, limit = line.rpartition(",")
        if not sep or not name.strip():
            raise SmokeFailure(f"unexpected nvidia-smi line {line!r}")
        rows.append((name.strip(), limit.strip()))
    if not rows:
        raise SmokeFailure("nvidia-smi reported no card")
    return rows


def result_line(platform: str, kind: str, count: int) -> str:
    """The contract's last stdout line."""
    return json.dumps({"ok": True, "device": {
        "platform": platform, "kind": kind, "count": int(count)}})


class Phase:
    """Prints a phase header and its wall time."""

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        print(f"{self.name}", flush=True)
        self.t0 = time.time()
        return self

    def __exit__(self, exc_type, exc, tb):
        status = "FAILED" if exc_type else "ok"
        print(f"  {self.name.split()[0]} {status}, wall "
              f"{time.time() - self.t0:.1f} s", flush=True)
        return False


# ---------------------------------------------------------------------------
# Phases
# ---------------------------------------------------------------------------


def phase_device(n_cards: int) -> None:
    import jax

    require_gpu(jax.default_backend(), len(jax.devices()))
    check("device count", len(jax.devices()) >= n_cards,
          f"{len(jax.devices())} visible, {n_cards} needed")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout
    parse_nvidia_smi(smi)
    for line in smi.strip().splitlines():
        print(line, flush=True)
    print(f"  jax {jax.__version__}; device_kind "
          f"{jax.devices()[0].device_kind}; XLA_FLAGS="
          f"{os.environ.get('XLA_FLAGS', '')!r}; compile cache "
          f"{enable_compile_cache()}", flush=True)


def _relerr(a, b) -> float:
    a = np.asarray(a, dtype=np.float64)
    return float(np.max(np.abs(a - b)) / max(float(np.max(np.abs(b))), 1e-300))


def phase_step_parity(n: int = 128, steps: int = 10) -> None:
    import jax

    from anap3_tpu.models import spectral_sg as core
    from anap3_tpu.models.reference import ReferenceSG, step_tolerance
    from anap3_tpu.models.spectral import SGSolver

    print(f"  x64 enabled before the first solver: "
          f"{bool(jax.config.jax_enable_x64)}", flush=True)
    ref = ReferenceSG(n, 1000.0, "chebyshev", "smoothing", 0.15)
    for _ in range(steps):
        ref.step()
    step = jax.jit(core.sg_step)
    for dtype, want in (("auto", "float64"), ("float32", "float32")):
        solver = SGSolver(Re=1000.0, nx=n, ny=n, basis_type="chebyshev",
                          corner_treatment="smoothing",
                          corner_smoothing=0.15, CFL=1.5, beta_squared=5.0,
                          dtype=dtype)
        check(f"dtype {dtype} resolves and computes as {want}",
              solver.params.dtype == want
              and str(solver.state.u.dtype) == want
              and str(solver.ops.Dx.dtype) == want,
              f"(params {solver.params.dtype}, state {solver.state.u.dtype})")
        state = solver.state
        for _ in range(steps):
            state, _ = step(solver.ops, state)
        jax.block_until_ready(state)
        err = max(_relerr(state.u, ref.u), _relerr(state.v, ref.v),
                  _relerr(state.p, ref.p))
        tol = step_tolerance(n, want)
        check(f"{want} {steps} steps vs numpy float64 reference",
              bool(np.isfinite(err)) and err <= tol,
              f"max rel err {err:.3e} <= {tol:.1e}")


def _runs(tracking: Path, experiment: str) -> list:
    T.set_tracking_uri(tracking)
    runs = [r for r in T.search_runs(experiment)
            if r["tags"].get("is_parent") != "true"]
    if not runs:
        raise SmokeFailure(f"no run logged under {experiment!r}")
    return runs


def _main_run(tracking: Path, experiment: str, args: list,
              multirun: bool = False) -> list:
    """Run main.main in-process; returns the runs it logged."""
    argv = (["-m"] if multirun else []) + list(args) + [
        "plots=false", f"mlflow.tracking_uri={tracking}",
        f"experiment_name={experiment}"]
    print(f"  main.py {' '.join(argv)}", flush=True)
    M.main(argv)
    return _runs(tracking, experiment)


def _fields(run) -> tuple:
    grid = read_vts(Path(run["path"]) / "artifacts" / "solution.vts")
    return grid.point_data["u"], grid.point_data["v"]


def phase_fsg(tracking: Path, n: int = 96) -> None:
    (run,) = _main_run(tracking, "smoke-fsg", [
        "solver=spectral/fsg", f"N={n}", "Re=1000", "tolerance=1e-6"])
    m = run["metrics"]
    print(f"  {int(m['iterations'])} iterations, solve wall "
          f"{m['wall_time_seconds']:.1f} s, of which first chunks "
          f"(compile) {m['first_chunk_seconds']:.1f} s", flush=True)
    check("FSG converged", m["converged"] == 1.0)
    u, v = m["u_L2_error"], m["v_L2_error"]
    check("smoothed-lid L2 floor vs data/validation/fv/Re1000",
          abs(u - FLOOR_U) <= FLOOR_TOL and abs(v - FLOOR_V) <= FLOOR_TOL,
          f"u={u:.4f} v={v:.4f} (floor {FLOOR_U}/{FLOOR_V} +- {FLOOR_TOL})")


def phase_fv(tracking: Path, n: int = 128) -> None:
    (run,) = _main_run(tracking, "smoke-fv", [
        "solver=fv", f"N={n}", "Re=100", "tolerance=1e-6"])
    m = run["metrics"]
    print(f"  {int(m['iterations'])} iterations, solve wall "
          f"{m['wall_time_seconds']:.1f} s, of which first chunk (compile) "
          f"{m['first_chunk_seconds']:.1f} s", flush=True)
    check("FV converged", m["converged"] == 1.0)
    u, v = m["u_L2_error"], m["v_L2_error"]
    check("L2 vs data/validation/fv/Re100",
          u <= FV_L2_MAX and v <= FV_L2_MAX,
          f"u={u:.5f} v={v:.5f} (<= {FV_L2_MAX})")


def phase_batched(tracking: Path, n: int = 32,
                  res=(100, 400, 1000)) -> None:
    lanes = _main_run(tracking, "smoke-batch", [
        "solver=spectral/sg", f"N={n}", "Re=" + ",".join(map(str, res))],
        multirun=True)
    check("one run per lane", len(lanes) == len(res), f"{len(lanes)} runs")
    by_re = {int(float(r["params"]["Re"])): r for r in lanes}
    for re_ in res:
        m = by_re[re_]["metrics"]
        check(f"lane Re={re_} converged", m["converged"] == 1.0,
              f"{int(m['iterations'])} iterations")
    (single,) = _main_run(tracking, "smoke-single", [
        "solver=spectral/sg", f"N={n}", f"Re={res[0]}"])
    lane = by_re[res[0]]
    it_b, it_s = int(lane["metrics"]["iterations"]), \
        int(single["metrics"]["iterations"])
    chunk = 200  # the batched runner's chunk (main.run_multirun_batched)
    check(f"Re={res[0]} lane iterations match the single run",
          abs(it_b - it_s) <= chunk, f"batched {it_b} vs single {it_s}")
    (ub, vb), (us, vs) = _fields(lane), _fields(single)
    diff = max(float(np.max(np.abs(ub - us))), float(np.max(np.abs(vb - vs))))
    check(f"Re={res[0]} lane fields match the single run", diff <= FIELD_TOL,
          f"max |diff| {diff:.3e} <= {FIELD_TOL:.0e}")


def phase_four_cards(tracking: Path, n_sweep: int = 48,
                     n_spatial: int = 63, cards: int = 4,
                     res=(100, 200, 400, 1000)) -> None:
    """8-lane sweep sharded over the cards and an x-sharded single solve,
    each against the same work on one card."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from anap3_tpu.models import spectral_sg as core
    from anap3_tpu.parallel import run_batched_sweep, stack_ops
    from anap3_tpu.utils import config as C

    jobs = C.expand_multirun(REPO / "conf", [
        "solver=spectral/sg", f"N={n_sweep}", "Re=" + ",".join(map(str, res)),
        "solver.corner_smoothing=0.1,0.15", "tolerance=1e-6"])
    check(f"{2 * len(res)} sweep lanes", len(jobs) == 2 * len(res),
          f"{len(jobs)}")
    solvers = [C.instantiate(cfg["solver"]) for cfg in jobs]
    ops = stack_ops([s.ops for s in solvers])
    states = jax.tree.map(lambda *a: jnp.stack(a), *[s.state for s in solvers])
    kw = dict(tolerance=1e-6, max_iterations=int(jobs[0]["max_iterations"]),
              chunk=200)
    out = {}
    for label, mesh in (("one card", None),
                        (f"{cards} cards", Mesh(np.array(
                            jax.devices()[:cards]), ("sweep",)))):
        t0 = time.time()
        out[label] = run_batched_sweep(core.sg_step, lambda s: (s.u, s.v),
                                       ops, states, mesh=mesh, **kw)
        r = out[label]
        print(f"  sweep on {label}: {time.time() - t0:.1f} s, iterations "
              f"{r.iterations.tolist()}", flush=True)
        check(f"every lane converged on {label}", bool(r.converged.all()))
    one, many = out["one card"], out[f"{cards} cards"]
    check("sharded sweep iterations equal one-card iterations",
          one.iterations.tolist() == many.iterations.tolist())
    diff = max(float(np.max(np.abs(np.asarray(a) - np.asarray(b))))
               for a, b in zip(jax.tree.leaves(one.states),
                               jax.tree.leaves(many.states)))
    check("sharded sweep fields equal one-card fields", diff <= FIELD_TOL,
          f"max |diff| {diff:.3e} <= {FIELD_TOL:.0e}")

    args = ["solver=spectral/sg", f"N={n_spatial}", "Re=400",
            "tolerance=1e-6"]
    (unsharded,) = _main_run(tracking, "smoke-unsharded", args)
    (sharded,) = _main_run(tracking, "smoke-xsharded",
                           args + ["machine=tensor"])
    it_u = int(unsharded["metrics"]["iterations"])
    it_s = int(sharded["metrics"]["iterations"])
    print(f"  x-sharded solve: {it_s} iterations, "
          f"{sharded['metrics']['wall_time_seconds']:.1f} s; unsharded "
          f"{it_u} iterations, "
          f"{unsharded['metrics']['wall_time_seconds']:.1f} s", flush=True)
    check("x-sharded solve converged",
          sharded["metrics"]["converged"] == 1.0
          and unsharded["metrics"]["converged"] == 1.0)
    check("x-sharded iterations equal unsharded", it_u == it_s,
          f"{it_s} vs {it_u}")
    (us, vs), (uu, vu) = _fields(sharded), _fields(unsharded)
    diff = max(float(np.max(np.abs(us - uu))), float(np.max(np.abs(vs - vu))))
    check("x-sharded fields equal unsharded", diff <= FIELD_TOL,
          f"max |diff| {diff:.3e} <= {FIELD_TOL:.0e}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the 4-card sharded sweep and x-sharded "
                         "solve, each against its one-card result")
    args = ap.parse_args(argv)
    import jax

    t_start = time.time()
    with Phase("P0 device"):
        phase_device(4 if args.four_cards else 1)
    tracking = Path(tempfile.mkdtemp(prefix="chip_smoke_mlruns_"))
    try:
        if args.four_cards:
            with Phase("P5 four cards: sharded sweep and x-sharded solve"):
                phase_four_cards(tracking)
        else:
            with Phase("P1 step parity vs numpy reference (N=128 Re=1000)"):
                phase_step_parity()
            with Phase("P2 main.py FSG N=96 Re=1000 tol 1e-6"):
                phase_fsg(tracking)
            with Phase("P3 main.py FV N=128 Re=100 tol 1e-6"):
                phase_fv(tracking)
            with Phase("P4 main.py -m SG N=32 Re=100,400,1000 batched"):
                phase_batched(tracking)
    finally:
        shutil.rmtree(tracking, ignore_errors=True)
    print(f"total wall {time.time() - t_start:.1f} s", flush=True)
    dev = jax.devices()
    print(result_line(dev[0].platform, dev[0].device_kind, len(dev)),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
