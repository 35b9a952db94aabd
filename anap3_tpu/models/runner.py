"""Generic convergence-checked iteration harness for jitted steppers.

The reference runs a Python ``for`` loop calling ``step()`` once per iteration
with per-iteration residual/energy tracking and an early break on convergence
(src/solvers/base.py:202-330). A literal port would round-trip host<->device
every step. Here the loop is restructured for an accelerator:

- ``chunk`` iterations run inside ONE jitted ``lax.scan``;
- each scan step computes the relative-iterate residual
  max(||u-u_prev||/||u_prev||, ||v-v_prev||/||v_prev||) exactly as
  base.py:249-258, plus the solver's algebraic residuals and conserved
  quantities;
- once converged (only checked after the 10-iteration warmup,
  base.py:263-285), the carried ``done`` flag freezes the state: remaining
  steps in the chunk are skipped via ``lax.cond``, so results are bit-identical
  to a per-iteration Python break;
- the host only syncs once per chunk to decide whether to launch another.

The same runner drives single solves, vmapped sweep batches (``done`` becomes
a per-lane vector; diverged lanes freeze with NaN guards instead of killing
the batch) and multigrid level solves.
"""

from __future__ import annotations

import logging
import time
from dataclasses import dataclass

from typing import Any, Callable, Dict, List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

log = logging.getLogger(__name__)

__all__ = ["IterationResult", "run_fixed_point", "make_chunk_runner"]

WARMUP_ITERS = 10  # convergence gate + history start (reference base.py:263-285)
# consecutive plateaued chunks required by convergence_metric="energy"
ENERGY_PLATEAU_CHUNKS = 3

METRIC_KEYS = (
    "rel_iter",
    "u_eq",
    "v_eq",
    "continuity",
    "energy",
    "enstrophy",
    "palinstrophy",
)


@dataclass
class IterationResult:
    """Host-side result of an iterative solve."""

    state: Any
    iterations: int
    converged: bool
    diverged: bool
    wall_time: float
    # Recorded metric histories starting at iteration index WARMUP_ITERS
    # (lists of floats). Long runs are stride-decimated on the fly
    # (run_fixed_point max_history_points), so entries are NOT necessarily
    # consecutive iterations; ``history_iters`` carries each entry's global
    # iteration index. The final (converging) iteration's row is always kept.
    history: Dict[str, List[float]]
    # Wall time of the FIRST chunk call (dominated by XLA compilation).
    # wall_time includes it, for
    # parity with the reference which also times its first-call numba JIT.
    first_chunk_time: float = 0.0
    # The convergence criterion plateaued above tolerance (float32 noise
    # floor) and the run was cut short by stall detection. converged stays
    # False; the state is the best the working precision can produce.
    stalled: bool = False
    # Global iteration index of each recorded history entry (see history).
    history_iters: Optional[np.ndarray] = None


def _rel_change(new: jnp.ndarray, old: jnp.ndarray) -> jnp.ndarray:
    return jnp.linalg.norm(new - old) / (jnp.linalg.norm(old) + 1e-12)


def make_chunk_runner(
    step_fn: Callable[[Any], Tuple[Any, Dict[str, jnp.ndarray]]],
    get_uv: Callable[[Any], Tuple[jnp.ndarray, jnp.ndarray]],
    chunk: int,
    tolerance: float,
    warmup: int = WARMUP_ITERS,
    convergence_metric: str = "rel_iter",
):
    """Build the jitted chunk function.

    ``step_fn(state) -> (state, metrics)`` performs one solver iteration and
    returns the METRIC_KEYS scalars except ``rel_iter`` (computed here).
    ``get_uv`` extracts the velocity arrays used for the iterate-change norm.

    ``convergence_metric``:
    - "rel_iter" (default, reference semantics base.py:249-285): relative
      iterate change < tolerance;
    - "residual": the CONTINUITY residual, normalized by its value at the
      warmup iteration, < tolerance. Stronger criterion: slow pseudo-time
      dynamics can satisfy the rel-change test while the solution is still
      evolving (observed with float32 single-grid runs at Re=1000), whereas
      the mass-conservation defect measures distance to the actual steady
      state. (The momentum residual norms are unusable for this: they
      include boundary rows where BC enforcement leaves O(1) garbage — true
      in the reference as well, sg.py:463-473.)
    - "energy" is NOT handled here: run_fixed_point maps it to a
      (tolerance=0, rel_iter) state machine and applies the kinetic-energy
      plateau test host-side at chunk boundaries.
    """
    use_residual = convergence_metric == "residual"

    def chunk_fn(state, start_iter, ref_norm):
        u0, v0 = get_uv(state)

        def body(carry, offset):
            state, u_prev, v_prev, done, conv_iter, ref_norm = carry
            # 0-based iteration index (int32 to keep the carry type stable)
            idx = (start_iter + offset).astype(jnp.int32)

            mdtype = u_prev.dtype

            def active(_):
                new_state, m = step_fn(state)
                u_new, v_new = get_uv(new_state)
                rel = jnp.maximum(
                    _rel_change(u_new, u_prev), _rel_change(v_new, v_prev)
                )
                metrics = {k: jnp.asarray(m[k], dtype=mdtype) for k in m}
                metrics["rel_iter"] = jnp.asarray(rel, dtype=mdtype)
                return new_state, metrics

            def frozen(_):
                nan = jnp.full((), jnp.nan, dtype=mdtype)
                metrics = {k: nan for k in METRIC_KEYS}
                return state, metrics

            new_state, metrics = jax.lax.cond(done, frozen, active, None)
            u_new, v_new = get_uv(new_state)
            rel = metrics["rel_iter"]
            if use_residual:
                resid = metrics["continuity"]
                # pin the normalization at the warmup iteration
                ref_norm = jnp.where(idx == warmup, resid, ref_norm)
                crit = resid / jnp.maximum(ref_norm, 1e-30)
            else:
                crit = rel
            finite = jnp.isfinite(rel)
            newly_converged = (idx >= warmup) & (crit < tolerance) & finite
            newly_diverged = ~finite & ~done
            now_done = done | newly_converged | newly_diverged
            conv_iter = jnp.where(~done & now_done, idx + 1, conv_iter)
            out = jnp.stack([metrics[k] for k in METRIC_KEYS])
            return (new_state, u_new, v_new, now_done, conv_iter, ref_norm), (
                out,
                newly_converged,
            )

        init = (
            state,
            u0,
            v0,
            jnp.asarray(False),
            jnp.asarray(-1, dtype=jnp.int32),
            ref_norm,
        )
        (state, _, _, done, conv_iter, ref_norm), (metric_rows, conv_flags) = \
            jax.lax.scan(body, init, jnp.arange(chunk))
        converged = jnp.any(conv_flags)
        return state, done, conv_iter, converged, metric_rows, ref_norm

    return jax.jit(chunk_fn, static_argnums=())


def run_fixed_point(
    step_fn,
    get_uv,
    state,
    tolerance: float,
    max_iterations: int,
    chunk: int = 100,
    warmup: int = WARMUP_ITERS,
    log_callback: Optional[Callable[[int, Dict[str, float]], None]] = None,
    log_every: int = 50,
    checkpoint_mgr=None,
    start_iteration: int = 0,
    convergence_metric: str = "rel_iter",
    chunk_runner=None,
    stall_chunks: int = 0,
    max_history_points: int = 4000,
    energy_plateau_chunks: int = None,
) -> IterationResult:
    """Run ``step_fn`` to convergence with reference-exact semantics.

    ``log_callback(iteration, metrics_dict)`` is invoked (outside the timed
    region, like the reference's excluded MLflow time, base.py:288-316) for
    every ``log_every``-th iteration using the recorded per-step metrics.

    ``checkpoint_mgr`` (utils.checkpoint.CheckpointManager) persists the
    state pytree every K chunks; ``start_iteration`` resumes the global
    iteration counter after a restore (pre-resume history is not replayed).

    ``stall_chunks`` > 0 enables plateau detection: if the convergence
    criterion fails to improve by >2% below its running best for that many
    consecutive chunks, the run stops with ``stalled=True`` instead of
    spinning to ``max_iterations``. This is the float32 escape hatch — near
    the working precision's noise floor the relative iterate change hovers
    (observed ~2.4e-6 for FV N=128 Re=1000 f32) and can never reach a
    tighter tolerance. Disabled (0) by default: float64 runs keep the
    reference's exact semantics.

    ``max_history_points`` bounds host-side history memory: when the
    recorded rows exceed 2x the cap the buffer is stride-decimated (keep
    every other row, double the stride) — the same scheme as
    parallel.sweep.run_batched_sweep. The reference's contract is a
    <=1000-point downsample at result-storage time (base.py:121,137-142);
    keeping 4x that preserves the final linspace downsample's fidelity
    while a 10^7-iteration run holds O(4000) rows instead of ~400 MB.
    The converging iteration's row is always retained so ``final_*``
    metrics stay exact.

    ``energy_plateau_chunks`` overrides the number of consecutive
    plateaued chunks the energy criterion requires (default
    ENERGY_PLATEAU_CHUNKS). The plateau window is measured in STEPS while
    dt ~ 1/N^2, so large-N solvers pass an N^2-scaled value
    (models/spectral.scaled_plateau_chunks) to keep the window's PHYSICAL
    duration — and hence the exit accuracy — resolution-independent
    (measured: a fixed 3x2000-step window lands exactly on the
    Newton-exact steady state at N=96 but exits 6% short in energy at
    N=320).
    """
    chunk = int(min(chunk, max(1, max_iterations)))
    # "energy" metric: the per-step state machine never self-converges
    # (tolerance 0 on rel_iter keeps divergence detection alive); the
    # plateau test runs HOST-SIDE at chunk boundaries on the energy
    # column — stop when |dE| over one chunk <= tolerance * |E|. This is
    # the criterion for physics that drift below any per-step test's
    # resolution (high-Re f32 runs: rel-iter and residual both
    # false-converge or never trigger; the kinetic-energy plateau is the
    # observable that actually settles last).
    if convergence_metric not in ("rel_iter", "residual", "energy"):
        raise ValueError(
            f"unknown convergence_metric {convergence_metric!r}: expected "
            "'rel_iter', 'residual' or 'energy'")
    use_energy = convergence_metric == "energy"
    plateau_target = int(energy_plateau_chunks or ENERGY_PLATEAU_CHUNKS)
    inner_metric = "rel_iter" if use_energy else convergence_metric
    inner_tol = 0.0 if use_energy else tolerance
    if chunk_runner is not None:
        # caller-supplied runner factory (e.g. the x-sharded runner of
        # parallel/spatial.py) with the same (state, start_iter, ref_norm)
        # -> 6-tuple contract. The factory receives the MAPPED criterion
        # (for "energy": rel_iter with tolerance 0) so its state machine
        # can never self-converge on a criterion the caller opted out of —
        # the mapping is owned here, not at each call site.
        runner = chunk_runner(chunk, inner_tol, inner_metric)
    else:
        runner = make_chunk_runner(step_fn, get_uv, chunk, inner_tol, warmup,
                                   inner_metric)

    rows_buf: List[np.ndarray] = []  # variable-length (n_i, K) pieces
    idx_buf: List[np.ndarray] = []   # matching global iteration indices
    n_kept = 0
    stride = 1
    last_row: Optional[np.ndarray] = None  # most recent recorded-range row
    last_idx = -1
    iterations = start_iteration
    converged = False
    diverged = False
    stalled = False
    crit_col = METRIC_KEYS.index(
        "continuity" if convergence_metric == "residual" else "rel_iter")
    energy_col = METRIC_KEYS.index("energy")
    e_prev: Optional[float] = None
    plateau_count = 0
    best_crit = np.inf
    stall_count = 0
    log_time = 0.0
    t0 = time.time()

    it = start_iteration
    first_chunk_time = 0.0
    ref_norm = jnp.asarray(jnp.inf, dtype=jnp.result_type(float))
    # Speculative chunk pipelining: chunk k+1 is DISPATCHED before chunk
    # k's flags are read back, so the device->host sync and the host's
    # history processing overlap device compute. This is exact, not
    # approximate: the chunk's convergence machine freezes a done state (no
    # further commits), so a speculated chunk past convergence is a no-op
    # whose outputs are simply dropped, and the functional state pytrees
    # keep chunk k's result intact.
    t_chunk = time.time()
    cur = None
    if it < max_iterations:
        cur = runner(state, jnp.asarray(it, dtype=jnp.int32), ref_norm)
    while cur is not None:
        state_k, done, conv_iter, chunk_converged, rows, ref_k = cur
        nxt = None
        if it + chunk < max_iterations:
            nxt = runner(state_k, jnp.asarray(it + chunk, dtype=jnp.int32),
                         ref_k)
        # one bundled device->host read for chunk k's control flow
        done_host, conv_iter_host, conv_flag, rows_host = jax.device_get(
            (done, conv_iter, chunk_converged, rows))
        done_host = bool(done_host)
        conv_iter_host = int(conv_iter_host)
        rows_host = np.asarray(rows_host)
        state = state_k
        if first_chunk_time == 0.0:
            first_chunk_time = time.time() - t_chunk

        if done_host:
            n_ran = conv_iter_host - it
            iterations = conv_iter_host
            converged = bool(conv_flag)
            diverged = not converged
        else:
            n_ran = min(chunk, max_iterations - it)
            iterations = it + n_ran
        gis = np.arange(it, it + n_ran)
        keep = (gis >= warmup) & ((gis - warmup) % stride == 0)
        if keep.any():
            rows_buf.append(rows_host[:n_ran][keep])
            idx_buf.append(gis[keep])
            n_kept += int(keep.sum())
        if n_ran > 0 and gis[-1] >= warmup:
            last_row = rows_host[n_ran - 1]
            last_idx = int(gis[-1])
        if n_kept > 2 * max_history_points:
            all_rows = np.concatenate(rows_buf, axis=0)[::2]
            all_idx = np.concatenate(idx_buf)[::2]
            rows_buf, idx_buf = [all_rows], [all_idx]
            n_kept = all_rows.shape[0]
            stride *= 2

        if log_callback is not None:
            t_log = time.time()
            for off in range(n_ran):
                gi = it + off
                if gi % log_every == 0 or (done_host and gi == iterations - 1):
                    metrics = dict(zip(METRIC_KEYS, rows_host[off].tolist()))
                    log_callback(gi, metrics)
            log_time += time.time() - t_log

        it += n_ran
        if checkpoint_mgr is not None and not done_host:
            t_ck = time.time()
            checkpoint_mgr.maybe_save(state, it)
            log_time += time.time() - t_ck
        if done_host:
            break  # speculative chunk (if any) is dropped; state is chunk k's
        if use_energy and it > warmup:
            vals = rows_host[:n_ran, energy_col]
            vals = vals[np.isfinite(vals)]
            if vals.size:
                e_last = float(vals[-1])
                # Plateau threshold floored at the ENERGY dtype's noise
                # walk: per-step rounding of E random-walks ~sqrt(n) ulps
                # over an n-step chunk, so a tolerance below
                # sqrt(chunk)*eps is structurally unreachable (measured:
                # f32 Re=100 N=48 singular at tol 1e-6, chunk 2000 ran a
                # 300k budget with |dE| pinned at the walk amplitude).
                # Below the floor no criterion can see the dynamics —
                # stopping there is the honest semantic, mirroring the
                # rel-iter f32-floor stall (see `stalled` below).
                eff_tol = max(tolerance,
                              float(np.sqrt(n_ran))
                              * float(np.finfo(rows_host.dtype).eps))
                if e_prev is not None and abs(e_last - e_prev) <= (
                        eff_tol * max(abs(e_last), 1e-30)):
                    # require consecutive plateaued chunks so a stationary
                    # point of a non-monotone E(t) (high-Re spin-up
                    # overshoot) cannot satisfy the test in passing
                    if plateau_count == 0:
                        e_window0 = e_prev
                    plateau_count += 1
                    if plateau_count >= plateau_target:
                        # NET-DRIFT gate: a slow monotone drift can pass
                        # every per-chunk test (each |dE| just under
                        # tol*E) while moving tol*E*window in total —
                        # measured at FSG N=320, which exits at E=0.0385
                        # vs the 0.0396 steady value this way. Random
                        # f32 noise random-walks ~sqrt(window) chunks, so
                        # bound the window's NET change by sqrt(window):
                        # drift (linear in window) fails, noise passes.
                        if abs(e_last - e_window0) <= (
                                eff_tol * max(abs(e_last), 1e-30)
                                * max(1.0, plateau_target ** 0.5)):
                            if eff_tol > tolerance:
                                log.info(
                                    "energy plateau converged at the %s "
                                    "noise floor (effective tol %.1e > "
                                    "requested %.1e)", rows_host.dtype,
                                    eff_tol, tolerance)
                            converged = True
                            iterations = it
                            break
                        plateau_count = 0  # drifting: keep integrating
                else:
                    plateau_count = 0
                e_prev = e_last
        # stall detection watches the rel_iter/residual criterion, whose
        # plateau is EXPECTED (not a failure) under the energy metric
        if stall_chunks > 0 and not use_energy and it > warmup:
            vals = rows_host[:n_ran, crit_col]
            vals = vals[np.isfinite(vals)]
            if vals.size:
                chunk_min = float(vals.min())
                if chunk_min < best_crit * 0.98:
                    best_crit = chunk_min
                    stall_count = 0
                else:
                    stall_count += 1
                if stall_count >= stall_chunks:
                    stalled = True
                    iterations = it
                    break
        cur = nxt

    wall = time.time() - t0 - log_time

    # Reference records history only from iteration index >= warmup
    # (enforced by the per-chunk keep mask above). Drop rows at/after the
    # converging iteration, and re-append the final recorded row if stride
    # decimation dropped it (final_* metrics read history[-1]).
    if rows_buf:
        all_rows = np.concatenate(rows_buf, axis=0)
        all_idx = np.concatenate(idx_buf)
    else:
        all_rows = np.zeros((0, len(METRIC_KEYS)))
        all_idx = np.zeros((0,), np.int64)
    mask = all_idx < iterations
    all_rows, all_idx = all_rows[mask], all_idx[mask]
    if last_row is not None and last_idx < iterations and (
            all_idx.size == 0 or int(all_idx[-1]) != last_idx):
        all_rows = np.concatenate([all_rows, last_row[None]], axis=0)
        all_idx = np.concatenate([all_idx, [last_idx]])
    history = {
        key: all_rows[:, i].tolist() for i, key in enumerate(METRIC_KEYS)
    }
    return IterationResult(
        state=state,
        iterations=iterations,
        converged=converged,
        diverged=diverged,
        wall_time=wall,
        history=history,
        first_chunk_time=first_chunk_time,
        stalled=stalled,
        history_iters=all_idx,
    )
