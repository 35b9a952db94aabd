#!/usr/bin/env python
"""Unified entry point: solve, sweep, optimize and plot LDC runs.

JAX counterpart of the reference driver (main.py + the Hydra multirun
machinery + utilities/mlflow/callback.py), with identical user-facing
semantics:

    python main.py solver=fv N=32 Re=100                    # single run
    python main.py -m +experiment/validation/ghia=spectral  # sweep
    python main.py -m +experiment/optimization=corner_smoothing \
        'solver.corner_smoothing=interval(0.02,0.35)'       # optimization
    python main.py -m +experiment/validation/ghia=fv plot_only=true

Differences by design:
- sweeps run through the in-process sweep driver (optionally vmapped device
  batches via anap3_tpu.parallel) instead of joblib subprocesses/LSF arrays;
- tracking goes to the MLflow-compatible file store (utils/tracking.py);
- the corner-smoothing optimization uses the built-in TPE sampler
  (utils/optimize.py) instead of hydra-optuna-sweeper.
"""

from __future__ import annotations

import logging
import math
import os
import sys
import tempfile
from pathlib import Path

REPO_ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(REPO_ROOT))


def _load_dotenv(path=None):
    """Minimal .env loader (reference uses python-dotenv, main.py:22)."""
    path = Path(path or REPO_ROOT / ".env")
    if not path.exists():
        return
    for line in path.read_text().splitlines():
        line = line.strip()
        if line and not line.startswith("#") and "=" in line:
            key, _, val = line.partition("=")
            os.environ.setdefault(key.strip(), val.strip())


_load_dotenv()

from anap3_tpu.utils import config as C  # noqa: E402
from anap3_tpu.utils import tracking as T  # noqa: E402
from anap3_tpu.utils.config import Interval  # noqa: E402
from anap3_tpu.analysis import validation as V  # noqa: E402

logging.basicConfig(
    level=os.environ.get("LOGLEVEL", "INFO"),
    format="[%(asctime)s][%(name)s][%(levelname)s] - %(message)s",
)
log = logging.getLogger("main")


def _pin_platform(cfg: dict) -> None:
    """Apply the root ``platform`` knob (conf/config.yaml) before any device
    work."""
    platform = cfg.get("platform")
    if platform:
        import jax

        jax.config.update("jax_platforms", str(platform))
        log.info("Pinned JAX platform: %s", platform)


def _init_distributed_if_configured() -> None:
    """Multi-host entry: initialize jax.distributed BEFORE any backend use
    when the standard coordinator env vars are set (machine=multihost
    documents the launch contract). Single-host runs are a no-op."""
    if not (os.environ.get("JAX_COORDINATOR_ADDRESS")
            or int(os.environ.get("JAX_NUM_PROCESSES", "0") or 0) > 1):
        return
    from anap3_tpu.parallel.distributed import initialize_distributed

    if initialize_distributed():
        import jax

        log.info("Multi-host runtime: process %d/%d, %d global devices",
                 jax.process_index(), jax.process_count(),
                 len(jax.devices()))

_LIVE_METRIC_NAMES = {
    "rel_iter": "rel_iter_residual",
    "u_eq": "u_residual",
    "v_eq": "v_residual",
    "continuity": "continuity_residual",
    "energy": "energy",
    "enstrophy": "enstrophy",
}


def get_experiment_name(cfg: dict) -> str:
    name = cfg.get("experiment_name", "LDC-Dev")
    prefix = cfg.get("mlflow", {}).get("project_prefix", "") or ""
    if prefix and not name.startswith("/"):
        return f"{prefix}/{name}"
    return name


def setup_tracking(cfg: dict) -> str:
    T.set_tracking_uri(cfg.get("mlflow", {}).get("tracking_uri", "./mlruns"))
    name = get_experiment_name(cfg)
    try:
        T.set_experiment(name)
    except Exception as exc:  # degraded-store fallback (reference main.py:48-51)
        name = f"{name}-restored"
        log.warning("set_experiment failed (%s); using %r", exc, name)
        T.set_experiment(name)
    return name


def find_existing_run(cfg: dict) -> str:
    runs = T.search_runs(
        get_experiment_name(cfg),
        params={"Re": cfg["Re"], "nx": cfg["N"]},
        status="FINISHED",
    )
    if not runs:
        raise ValueError(f"No matching run found for N={cfg['N']}, Re={cfg['Re']}")
    run_id = runs[0]["run_id"]
    log.info("Found existing run: %s", run_id[:8])
    return run_id


def _tag_cluster_job():
    """Tag LSF job info when running under a scheduler (base.py:856-866)."""
    job_id = os.environ.get("LSB_JOBID")
    if not job_id:
        return
    T.set_tag("lsf.job_id", job_id)
    desc = f"HPC Job: {os.environ.get('LSB_JOBNAME', '')} (ID: {job_id}"
    idx = os.environ.get("LSB_JOBINDEX", "")
    if idx:
        desc += f", Index: {idx}"
    T.set_tag("mlflow.note.content", desc + ")")


def _live_log(iteration, metrics):
    payload = {}
    for key, name in _LIVE_METRIC_NAMES.items():
        val = metrics.get(key)
        if val is not None and not (isinstance(val, float) and math.isnan(val)):
            if key in ("energy", "enstrophy") and iteration < 10:
                continue
            payload[name] = float(val)
    if payload:
        T.log_metrics(payload, step=iteration)


def log_solver_results(cfg: dict, solver, parent_run_id: str | None = None,
                       run=None, extra_tags: dict | None = None):
    """Log a SOLVED solver's results (params/metrics/artifacts/tables).

    Returns (run_id, validation_errors). ``run`` may be an already-open run
    (live-logged path); otherwise one is created and closed here.
    """
    solver_name = cfg["solver"].get("name", "solver")
    own_run = run is None
    if own_run:
        # spectral runs are named by node count N+1 (reference main.py:80-82)
        N_display = (cfg["N"] + 1 if solver_name.startswith("spectral")
                     else cfg["N"])
        tags = {"solver": solver_name}
        if extra_tags:
            tags.update(extra_tags)
        if parent_run_id:
            tags.update({"mlflow.parentRunId": parent_run_id,
                         "parent_run_id": parent_run_id, "sweep": "child"})
        run = T.start_run(run_name=f"{solver_name}_N{N_display}", tags=tags)
        T.log_params(solver.params.to_mlflow())
        T.log_dict(_plain(cfg), "config.yaml")
    try:
        reference_dir = cfg.get("validation", {}).get(
            "reference_dir", "data/validation/fv")
        validation_errors = solver.compute_validation_errors(
            reference_dir=reference_dir, base_dir=REPO_ROOT,
            save_plots=cfg.get("plots", True))
        if validation_errors:
            T.log_metrics(validation_errors)

        metrics = solver.metrics.to_mlflow()
        wall = max(solver.metrics.wall_time_seconds, 1e-9)
        metrics["timesteps_per_sec"] = solver.metrics.iterations / wall
        # first-chunk (compile-dominated) time, so throughput can be judged
        # net of XLA compilation
        metrics["first_chunk_seconds"] = getattr(solver, "first_chunk_time", 0.0)
        T.log_metrics(metrics)
        if solver.time_series:
            batch = solver.time_series.to_batch()
            if batch:
                T.log_batch(run.run_id, batch)

        table = solver.validation_table(base_dir=REPO_ROOT)
        if table:
            T.log_table(table, "validation_metrics.json")
        saad = solver.saad_table(base_dir=REPO_ROOT)
        if saad:
            T.log_table(saad, "saad_quantities.json")
        for plot in getattr(solver, "validation_error_plots", []) or []:
            T.log_artifact(plot)

        with tempfile.TemporaryDirectory() as tmpdir:
            vts_path = Path(tmpdir) / "solution.vts"
            solver.save_vtk(vts_path)
            T.log_artifact(vts_path)
        log.info("Done: %d iter, converged=%s, time=%.2fs",
                 solver.metrics.iterations, solver.metrics.converged,
                 solver.metrics.wall_time_seconds)
        return run.run_id, validation_errors
    finally:
        if own_run:
            T.end_run()


def run_solver(cfg: dict, parent_run_id: str | None = None):
    """Solve one configuration. Returns (run_id, validation_errors, solver).

    Phase wall times (setup/solve/analysis) are collected with PhaseTimer
    and logged as ``time_<phase>_seconds`` metrics — a breakdown the
    reference never had (it only subtracts logging time from one total,
    base.py:238-239). The plots phase is logged by generate_plots.
    """
    from anap3_tpu.utils.profiling import PhaseTimer, device_trace

    timer = PhaseTimer()
    with timer.phase("setup"):
        solver = C.instantiate(cfg["solver"])
    solver_name = cfg["solver"].get("name", "solver")
    N_display = cfg["N"] + 1 if solver_name.startswith("spectral") else cfg["N"]
    run_name = f"{solver_name}_N{N_display}"

    parent_run_id = parent_run_id or os.environ.get("MLFLOW_PARENT_RUN_ID")
    tags = {"solver": solver_name}
    if parent_run_id:
        tags.update({"mlflow.parentRunId": parent_run_id,
                     "parent_run_id": parent_run_id, "sweep": "child"})

    # tensor-parallel single-solve sharding (machine.mesh_axes: [x])
    if getattr(solver, "SUPPORTS_SPATIAL_MESH", False):
        from anap3_tpu.parallel.spatial import spatial_mesh_from_config

        with timer.phase("setup"):
            mesh = spatial_mesh_from_config(cfg.get("machine", {}),
                                            nf=int(cfg["N"]) + 1)
        if mesh is not None:
            solver.spatial_mesh = mesh
            log.info("Spatial sharding: %d devices on the x axis",
                     mesh.devices.size)
    elif "x" in (cfg.get("machine", {}).get("mesh_axes") or []):
        log.info("machine.mesh_axes=[x] requested but %s does not support "
                 "spatial sharding; running unsharded", solver_name)

    with T.start_run(run_name=run_name, tags=tags) as run:
        T.log_params(solver.params.to_mlflow())
        T.log_dict(_plain(cfg), "config.yaml")
        _tag_cluster_job()
        solver._log_callback = _live_log
        log.info("Solving: %s N=%s Re=%s", solver_name, cfg["N"], cfg["Re"])

        with timer.phase("solve"), \
                device_trace(os.environ.get("ANAP3_TRACE_DIR")):
            solver.solve()
        with timer.phase("analysis"):
            run_id, validation_errors = log_solver_results(
                cfg, solver, parent_run_id, run=run)
        T.log_metrics(timer.as_metrics())
        return run_id, validation_errors, solver


# matplotlib's pyplot state machine is not thread-safe; plot generation is
# serialized even when solves run on the machine.n_jobs thread pool
_PLOT_LOCK = __import__("threading").Lock()


def generate_plots(cfg: dict, run_id: str, output_dir=None):
    import time as _time

    if not cfg.get("plots", True):  # before the matplotlib import cost
        log.info("Plot generation disabled (plots=false)")
        return

    from anap3_tpu.plotting import generate_plots_for_run

    t0 = _time.time()
    try:
        with _PLOT_LOCK:
            generate_plots_for_run(
                run_id=run_id,
                tracking_uri=cfg.get("mlflow", {}).get("tracking_uri",
                                                       "./mlruns"),
                output_dir=output_dir or Path("outputs/plots") / run_id[:8],
                solver_name=cfg["solver"].get("name", "solver"),
                N=cfg["N"],
                Re=cfg["Re"],
                data_dir=REPO_ROOT / "data",
            )
    except Exception as exc:
        log.warning("Plotting failed (likely diverged run): %s", exc)
        return
    # plots run after the child run closed; re-attach to record the phase
    try:
        with T.attach_run(run_id):
            T.log_metrics({"time_plots_seconds": round(_time.time() - t0, 4)})
    except Exception as exc:
        log.warning("Could not log plot timing: %s", exc)


def compute_objective(cfg: dict, validation_errors: dict, solver) -> float:
    objective_type = cfg.get("optuna", {}).get("objective", "fv_l2_error")
    if objective_type == "multi":
        raise ValueError("Multi-objective optimization is not supported; use "
                         "objective=fv_l2_error or objective=botella_vortex")
    if objective_type == "botella_vortex":
        obj = V.botella_vortex_objective(solver.metrics, cfg["Re"],
                                         base_dir=REPO_ROOT)
    else:
        obj = V.fv_l2_objective(validation_errors)
    log.info("Objective (%s): %.6e", objective_type, obj)
    return obj


def _plain(node):
    """Recursively convert Interval and Path values for YAML dumping."""
    if isinstance(node, dict):
        return {k: _plain(v) for k, v in node.items()}
    if isinstance(node, list):
        return [_plain(v) for v in node]
    if isinstance(node, Interval):
        return f"interval({node.lo}, {node.hi})"
    if isinstance(node, Path):
        return str(node)
    return node


# ---------------------------------------------------------------------------
# Sweep / multirun driver (replaces Hydra multirun + MLflowSweepCallback)
# ---------------------------------------------------------------------------


def _get_or_create_parent(cfg: dict) -> str:
    """Create/reuse a parent run per resolved sweep_name (callback.py:65-134)."""
    sweep_name = str(cfg.get("sweep_name", "sweep"))
    setup_tracking(cfg)
    existing = T.search_runs(get_experiment_name(cfg),
                             tags={"is_parent": "true",
                                   "mlflow.runName": sweep_name})
    if existing:
        return existing[0]["run_id"]
    run = T.create_detached_run(run_name=sweep_name,
                                tags={"is_parent": "true"})
    return run.run_id


_BATCHABLE_SOLVERS = {
    "anap3_tpu.models.spectral.SGSolver",
    "anap3_tpu.models.spectral.FSGSolver",
    "anap3_tpu.models.fv.FVSolver",
}
# solver keys that may differ between lanes of one vmapped batch (they live
# as arrays in the ops pytree); everything else must be lane-identical.
_BATCHABLE_VARYING = {"Re", "corner_smoothing", "corner_treatment", "CFL",
                      "beta_squared", "lid_velocity"}


def _batchable(jobs) -> bool:
    if len(jobs) < 2:
        return False
    first = jobs[0]["solver"]
    if first.get("_target_") not in _BATCHABLE_SOLVERS:
        return False
    for cfg in jobs[1:]:
        s = cfg["solver"]
        if s.get("_target_") != first.get("_target_"):
            return False
        for key in set(first) | set(s):
            if key in _BATCHABLE_VARYING:
                continue
            if s.get(key) != first.get(key):
                return False
    return True


def run_multirun_batched(jobs):
    """All sweep members in ONE vmapped device batch (see parallel.sweep)."""
    from anap3_tpu.models.runner import IterationResult, WARMUP_ITERS
    from anap3_tpu.parallel import run_batched_sweep, stack_ops

    import jax

    def _scaled_plateau(n, chunk, spectral):
        # keep the energy-plateau window's PHYSICAL duration resolution-
        # independent (dt ~ 1/N^2), exactly like the single-run path
        if not spectral:
            return None
        from anap3_tpu.models.spectral import scaled_plateau_chunks

        return scaled_plateau_chunks(n, chunk)

    solvers = [C.instantiate(cfg["solver"]) for cfg in jobs]
    first = solvers[0]

    # shard the batch axis over the device mesh when lanes divide evenly
    mesh = None
    devices = jax.devices()
    if len(devices) > 1 and len(jobs) % len(devices) == 0:
        from jax.sharding import Mesh
        import numpy as np

        mesh = Mesh(np.array(devices), ("sweep",))
        log.info("Sharding %d lanes over %d devices", len(jobs), len(devices))

    log.info("Batched sweep: %d lanes of %s (N=%s)", len(jobs),
             type(first).__name__, jobs[0]["N"])

    batch_metric = "rel_iter"
    if type(first).__name__ in ("SGSolver", "FSGSolver"):
        from anap3_tpu.models.spectral import resolve_convergence_metric

        batch_metric = resolve_convergence_metric(first.params)
        if batch_metric == "residual":
            # the batched runner implements rel_iter and energy; the
            # residual criterion remains single-run only
            log.warning(
                "Batched sweep lanes do not implement "
                "convergence_metric=residual; using rel_iter (run those "
                "members serially for the residual criterion)")
            batch_metric = "rel_iter"
        elif batch_metric == "energy":
            log.info("Batched sweep lanes converge on the per-lane "
                     "kinetic-energy plateau")

    if type(first).__name__ == "FSGSolver":
        from anap3_tpu.parallel.fsg_sweep import run_batched_fsg

        lane_results = run_batched_fsg([s.params for s in solvers], mesh=mesh)
    else:
        if type(first).__name__ == "SGSolver":
            from anap3_tpu.models import spectral_sg as sgcore

            step_fn = sgcore.sg_step
        else:
            from anap3_tpu.models.fv import fv_step

            step_fn = fv_step

        import jax.numpy as jnp

        chunk = 200
        ops = stack_ops([s.ops for s in solvers])
        states = jax.tree.map(lambda *a: jnp.stack(a),
                              *[s.state for s in solvers])
        res = run_batched_sweep(
            step_fn, lambda s: (s.u, s.v), ops, states,
            tolerance=float(jobs[0]["tolerance"]),
            max_iterations=int(jobs[0]["max_iterations"]), mesh=mesh,
            chunk=chunk, convergence_metric=batch_metric if
            type(first).__name__ == "SGSolver" else "rel_iter",
            energy_plateau_chunks=_scaled_plateau(
                int(jobs[0]["N"]), chunk,
                type(first).__name__ == "SGSolver"))
        lane_results = []
        for k in range(len(jobs)):
            # recorded columns carry their global iteration index (long
            # sweeps are stride-decimated); keep those before this lane's end
            rec = res.history_iters < int(res.iterations[k])
            history = {key: res.history[key][k][rec].tolist()
                       for key in res.history}
            # wall_time is the SHARED batch wall: lanes run concurrently in
            # one device program, so an even split would fabricate per-lane
            # times. Children are tagged wall_time_scope=batch and the
            # aggregate throughput is logged on the parent run.
            lane_results.append(IterationResult(
                state=jax.tree.map(lambda x: x[k], res.states),
                iterations=int(res.iterations[k]),
                converged=bool(res.converged[k]),
                diverged=bool(res.diverged[k]),
                wall_time=res.wall_time, history=history))

    batch_tags = {"wall_time_scope": "batch",
                  "batch_lanes": str(len(jobs))}
    objectives = []
    parent_ids = {}
    for cfg, solver, result in zip(jobs, solvers, lane_results):
        parent_id = _get_or_create_parent(cfg)
        parent_ids[parent_id] = cfg
        solver.state = result.state
        solver._store_results(result)
        run_id, errors = log_solver_results(cfg, solver, parent_id,
                                            extra_tags=batch_tags)
        generate_plots(cfg, run_id)
        objectives.append(compute_objective(cfg, errors, solver))
    total_steps = sum(r.iterations for r in lane_results)
    shared_wall = max(lane_results[0].wall_time, 1e-9)
    for parent_id in parent_ids:
        with T.attach_run(parent_id):
            T.log_metrics({
                "batch_wall_time_seconds": shared_wall,
                "aggregate_lane_steps_per_sec": total_steps / shared_wall,
            })
    _sweep_comparison_plots(parent_ids)
    return objectives


def _sweep_comparison_plots(parent_ids):
    parent_ids = {k: cfg for k, cfg in parent_ids.items()
                  if cfg.get("plots", True)}
    if not parent_ids:
        return
    from anap3_tpu.plotting import generate_comparison_plots_for_sweep

    for parent_id, cfg in parent_ids.items():
        try:
            generate_comparison_plots_for_sweep(
                [parent_id],
                cfg.get("mlflow", {}).get("tracking_uri", "./mlruns"),
                Path("outputs/comparisons"), data_dir=REPO_ROOT / "data")
        except Exception as exc:
            log.warning("Comparison plotting failed: %s", exc)


def _batch_signature(cfg):
    """Jobs sharing this signature can ride one vmapped device batch."""
    s = cfg["solver"]
    if s.get("_target_") not in _BATCHABLE_SOLVERS:
        return None
    items = tuple(sorted((k, repr(v)) for k, v in s.items()
                         if k not in _BATCHABLE_VARYING))
    return items


def run_multirun(overrides):
    jobs = C.expand_multirun(REPO_ROOT / "conf", overrides)
    if jobs:
        # jax_platforms is process-global: one pin for the whole sweep.
        # Differing per-job values cannot be honored — surface that.
        platforms = {job.get("platform") for job in jobs}
        if len(platforms) > 1:
            raise C.ConfigError(
                f"platform differs across sweep jobs ({sorted(map(str, platforms))}): "
                "the JAX platform is process-global and cannot vary per job")
        _pin_platform(jobs[0])

    # optimization path: any Interval value anywhere in the sweeper params
    base = jobs[0]
    interval_params = _collect_intervals(base)
    if interval_params:
        return run_optimization(overrides, interval_params)

    vmap_ok = base.get("machine", {}).get("vmap_sweeps", True)
    if vmap_ok and not base.get("plot_only"):
        # group jobs by batchability signature: a mixed sweep like
        # solver=fv,spectral x N=16..128 x Re=... batches each homogeneous
        # (solver, N, ...) group over its Re/corner lanes, and runs the
        # singletons serially.
        groups = {}
        order = []
        for i, cfg in enumerate(jobs):
            sig = _batch_signature(cfg)
            key = sig if sig is not None else ("serial", i)
            groups.setdefault(key, []).append(cfg)
            if key not in order:
                order.append(key)
        objectives = []
        serial_pool = []

        def flush_serial():
            if serial_pool:
                objectives.extend(_run_serial_jobs(serial_pool))
                serial_pool.clear()

        for key in order:
            group = groups[key]
            if len(group) >= 2 and key[0] != "serial" and _batchable(group):
                flush_serial()
                log.info("=== batched group: %d lanes ===", len(group))
                objectives.extend(run_multirun_batched(group))
            else:
                # pool consecutive non-batchable members so machine.n_jobs
                # host threads can run them concurrently
                serial_pool.extend(group)
        flush_serial()
        return objectives

    return _run_serial_jobs(jobs)


def _run_serial_jobs(jobs):
    """Run non-batchable sweep members, honoring ``machine.n_jobs``.

    The reference parallelizes these with a joblib process launcher
    (conf/machine/local.yaml:8-10); here homogeneous members ride vmapped
    device batches instead, and the residual heterogeneous members use a
    host THREAD pool (device work serializes on the accelerator queue
    anyway; the tracking layer's run stack is thread-local). ``n_jobs<=1``
    or plot_only sweeps keep the strictly serial path.
    """
    n_jobs = 1
    if jobs:
        try:
            n_jobs = int(jobs[0].get("machine", {}).get("n_jobs", 1) or 1)
        except (TypeError, ValueError):
            n_jobs = 1
    if (n_jobs > 1 and len(jobs) > 1
            and not any(cfg.get("plot_only") for cfg in jobs)):
        return _run_threaded_jobs(jobs, n_jobs)

    parent_ids = {}
    objectives = []
    for i, cfg in enumerate(jobs):
        log.info("=== multirun job %d/%d ===", i + 1, len(jobs))
        parent_id = _get_or_create_parent(cfg)
        parent_ids[parent_id] = cfg
        if cfg.get("plot_only"):
            run_id = find_existing_run(cfg)
            generate_plots(cfg, run_id)
            continue
        try:
            run_id, errors, solver = run_solver(cfg, parent_run_id=parent_id)
            generate_plots(cfg, run_id)
            objectives.append(compute_objective(cfg, errors, solver))
        except FloatingPointError as exc:
            log.warning("Job diverged: %s", exc)
            objectives.append(float("inf"))

    # post-sweep comparison plots on each parent (callback.py:316-356)
    _sweep_comparison_plots(parent_ids)
    return objectives


def _run_threaded_jobs(jobs, n_jobs):
    from concurrent.futures import ThreadPoolExecutor

    # parent runs are created SERIALLY first: creation mutates the global
    # experiment state and must stay race-free (the reference pre-creates
    # parents for the same reason, scripts/hpc_submit.py:178-180)
    parent_ids = {}
    job_parents = []
    for cfg in jobs:
        parent_id = _get_or_create_parent(cfg)
        parent_ids[parent_id] = cfg
        job_parents.append(parent_id)

    def run_one(arg):
        i, (cfg, parent_id) = arg
        log.info("=== multirun job %d/%d (threaded) ===", i + 1, len(jobs))
        try:
            run_id, errors, solver = run_solver(cfg, parent_run_id=parent_id)
            generate_plots(cfg, run_id)
            return compute_objective(cfg, errors, solver)
        except FloatingPointError as exc:
            log.warning("Job diverged: %s", exc)
            return float("inf")

    log.info("Host-thread pool: %d jobs on %d threads (machine.n_jobs)",
             len(jobs), n_jobs)
    with ThreadPoolExecutor(max_workers=n_jobs) as pool:
        objectives = list(pool.map(run_one,
                                   enumerate(zip(jobs, job_parents))))
    _sweep_comparison_plots(parent_ids)
    return objectives


def _collect_intervals(cfg, prefix=""):
    out = {}
    if isinstance(cfg, dict):
        for k, v in cfg.items():
            path = f"{prefix}.{k}" if prefix else str(k)
            if isinstance(v, Interval):
                out[path] = v
            elif isinstance(v, dict):
                out.update(_collect_intervals(v, path))
    return out


def run_optimization(overrides, interval_params):
    """TPE optimization loop over interval + categorical sweep params."""
    from anap3_tpu.utils.optimize import TPESampler

    base_overrides = [ov for ov in overrides if "interval(" not in ov]
    base = C.compose(REPO_ROOT / "conf", base_overrides)
    optuna_cfg = base.get("optuna", {})

    space = dict(interval_params)
    sweeper = base.get("hydra", {}).get("sweeper", {}).get("params", {}) or {}
    for key, val in sweeper.items():
        if key in space:
            continue
        parsed = C._parse_value(str(val), allow_sweep=True)
        if isinstance(parsed, Interval):
            space[key] = parsed
        elif isinstance(parsed, list):
            space[key] = parsed

    sampler = TPESampler(
        space,
        n_startup_trials=int(optuna_cfg.get("n_startup_trials", 5)),
        seed=int(optuna_cfg.get("seed", 0)),
        direction=str(optuna_cfg.get("direction", "minimize")),
    )
    n_trials = int(optuna_cfg.get("n_trials", 15))
    parent_id = _get_or_create_parent(base)

    # Trials run in vmapped device batches of machine.batch_lanes (or
    # optuna.batch_size) candidates per round — the ask/tell form SURVEY §7
    # step 7 calls for (the reference only ran n_jobs process-parallel
    # trials, conf/hydra/sweeper/optuna_corner.yaml:20-22). Candidates whose
    # configs are not lane-batchable (e.g. a categorical N makes shapes
    # differ) fall back to serial execution within the round.
    batch_size = int(optuna_cfg.get("batch_size", 0)) \
        or int(base.get("machine", {}).get("batch_lanes", 1))
    batch_size = max(1, min(batch_size, n_trials))

    done = 0
    while done < n_trials:
        k = min(batch_size, n_trials - done)
        asks = sampler.ask_batch(k)
        trials = []
        for params in asks:
            trial_overrides = list(base_overrides) + [
                f"{key}={v}" for key, v in params.items()]
            trials.append((params, C.compose(REPO_ROOT / "conf",
                                             trial_overrides)))
        log.info("=== optimization round: trials %d-%d/%d (%d lanes) ===",
                 done + 1, done + k, n_trials, k)

        cfgs = [cfg for _, cfg in trials]
        values = None
        if k >= 2 and _batchable(cfgs):
            try:
                values = run_multirun_batched(cfgs)
            except Exception as exc:
                # Do NOT re-run serially: the batch may have already logged
                # some lanes' child runs, and a rerun would duplicate them
                # under the parent. Tell the sampler the round failed.
                log.warning("Batched trial round failed (%s); recording the "
                            "round's trials as failed (inf)", exc)
                values = [float("inf")] * k
        if values is None:
            values = []
            for params, cfg in trials:
                try:
                    run_id, errors, solver = run_solver(
                        cfg, parent_run_id=parent_id)
                    values.append(compute_objective(cfg, errors, solver))
                except Exception as exc:
                    log.warning("Trial failed: %s", exc)
                    values.append(float("inf"))
        for (params, _cfg), value in zip(trials, values):
            sampler.tell(params, value)
        done += k

    best_params, best_value = sampler.best
    log.info("Best trial: %s -> %.6e", best_params, best_value)
    # Optuna-style summary on the parent run (callback.py:219-313)
    with T.attach_run(parent_id):
        T.log_table(
            [{"trial": i, **p, "objective": v}
             for i, (p, v) in enumerate(sampler.trials)],
            "optuna_trials.json")
        T.log_metrics({"best_objective": best_value})
        for k, v in best_params.items():
            if isinstance(v, (int, float)):
                T.log_metrics({f"best_{k.replace('.', '_')}": float(v)})
    return best_value


# ---------------------------------------------------------------------------


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    multirun = False
    overrides = []
    for a in argv:
        if a in ("-m", "--multirun"):
            multirun = True
        else:
            overrides.append(a)

    _init_distributed_if_configured()
    if multirun:
        return run_multirun(overrides)

    cfg = C.compose(REPO_ROOT / "conf", overrides)
    _pin_platform(cfg)
    log.info("Solver: %s, N=%s, Re=%s", cfg["solver"].get("name"), cfg["N"],
             cfg["Re"])
    log.info("Tracking experiment: %s", setup_tracking(cfg))

    if cfg.get("plot_only"):
        run_id = find_existing_run(cfg)
        generate_plots(cfg, run_id)
        return None

    run_id, errors, solver = run_solver(cfg)
    generate_plots(cfg, run_id)
    return compute_objective(cfg, errors, solver)


if __name__ == "__main__":
    main()
