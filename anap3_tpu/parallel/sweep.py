"""Vmapped batch sweeps: many (Re, corner_smoothing, ...) solves in one jit.

The reference distributes sweep members over joblib processes (n_jobs=4,
conf/machine/local.yaml) or LSF job arrays (scripts/hpc_submit.py). On an
accelerator the natural unit is a BATCH AXIS: all lanes share the operator
matrices (same N), per-lane scalars/boundary profiles ride the vmapped ops
pytree, and one jitted chunk advances every lane simultaneously (the lane
dots become batched matrix products).

Failure isolation carried over from the reference's divergence handling
(multigrid/fsg.py:1184-1190): a lane that goes NaN/Inf is frozen (its state
stops updating) without touching the other lanes; it is reported as
diverged at the end.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from ..models.runner import (ENERGY_PLATEAU_CHUNKS, METRIC_KEYS, WARMUP_ITERS,
                             _rel_change)

__all__ = ["SweepResult", "stack_ops", "make_batched_chunk_runner",
           "run_batched_sweep"]


@dataclass
class SweepResult:
    """Per-lane outcome of a batched sweep."""

    states: Any                   # batched final state pytree
    iterations: np.ndarray        # (B,)
    converged: np.ndarray        # (B,) bool
    diverged: np.ndarray          # (B,) bool
    wall_time: float
    history: Dict[str, np.ndarray]  # key -> (B, n_recorded)
    # Global iteration index of each recorded history column. Long sweeps are
    # stride-decimated on the fly (run_batched_sweep max_history_points), so
    # columns are NOT necessarily consecutive iterations.
    history_iters: np.ndarray = None  # (n_recorded,)


def stack_ops(ops_list: Sequence[Any]) -> Any:
    """Stack per-lane ops pytrees along a new leading batch axis."""
    return jax.tree.map(lambda *leaves: jnp.stack(leaves), *ops_list)


def make_batched_chunk_runner(step_fn: Callable, get_uv: Callable, chunk: int,
                              tolerance: float, warmup: int = WARMUP_ITERS):
    """Jitted chunk over a batch: ``step_fn(ops_lane, state_lane)`` is vmapped.

    Per-lane ``done`` freezing uses a select (all lanes compute every step —
    the SPMD cost model — but frozen lanes keep their converged state).
    ``done`` and ``conv_iter`` are carried from chunk to chunk, so a lane
    that finished in an earlier chunk stays frozen and keeps the iteration
    it finished at.
    """
    vstep = jax.vmap(step_fn)
    vuv = jax.vmap(lambda s: get_uv(s))
    vrel = jax.vmap(_rel_change)

    def chunk_fn(ops, states, start_iter, done, conv_iter):
        u0, v0 = vuv(states)

        def body(carry, offset):
            states, u_prev, v_prev, done, conv_iter = carry
            idx = (start_iter + offset).astype(jnp.int32)
            new_states, m = vstep(ops, states)
            u_new, v_new = vuv(new_states)
            rel = jnp.maximum(vrel(u_new, u_prev), vrel(v_new, v_prev))
            mdtype = u_prev.dtype
            metrics = {k: jnp.asarray(m[k], mdtype) for k in m}
            metrics["rel_iter"] = rel.astype(mdtype)

            finite = jnp.isfinite(rel)
            newly_conv = (idx >= warmup) & (rel < tolerance) & finite
            newly_div = ~finite & ~done
            now_done = done | newly_conv | newly_div

            # freeze finished lanes
            keep = lambda new, old: jnp.where(
                done.reshape((-1,) + (1,) * (new.ndim - 1)), old, new)
            frozen_states = jax.tree.map(keep, new_states, states)
            u_keep = keep(u_new, u_prev)
            v_keep = keep(v_new, v_prev)
            nan = jnp.asarray(jnp.nan, mdtype)
            metrics = {k: jnp.where(done, nan, v) for k, v in metrics.items()}

            conv_iter = jnp.where(~done & now_done, idx + 1, conv_iter)
            out = jnp.stack([metrics[k] for k in METRIC_KEYS], axis=-1)  # (B, K)
            return (frozen_states, u_keep, v_keep, now_done, conv_iter), (
                out, newly_conv)

        init = (states, u0, v0, done, conv_iter)
        (states, _, _, done, conv_iter), (rows, conv_flags) = jax.lax.scan(
            body, init, jnp.arange(chunk))
        ever_conv = jnp.any(conv_flags, axis=0)
        return states, done, conv_iter, ever_conv, rows

    return jax.jit(chunk_fn)


def run_batched_sweep(step_fn, get_uv, ops, states, tolerance: float,
                      max_iterations: int, chunk: int = 200,
                      warmup: int = WARMUP_ITERS,
                      mesh: "jax.sharding.Mesh | None" = None,
                      axis_name: str = "sweep",
                      max_history_points: int = 4000,
                      convergence_metric: str = "rel_iter",
                      energy_plateau_chunks: int = None) -> SweepResult:
    """Drive a batch of solves to convergence.

    With ``mesh`` given, the batch axis is sharded over ``mesh[axis_name]``
    (lanes must divide the axis size); XLA then runs the identical program on
    every device with zero collectives — the counterpart of the reference's
    embarrassingly-parallel job arrays.

    Host-side history is bounded at O(lanes * max_history_points): when the
    recorded rows exceed 2x the cap, the buffer is stride-decimated (keep
    every other row, double the sampling stride). The reference's contract is
    a <=1000-point downsample at result-storage time (base.py:121,137-142);
    keeping 4x that preserves the final linspace downsample's fidelity while
    a 128-lane x 10^6-step sweep no longer accumulates ~GB of host rows.

    ``convergence_metric="energy"`` applies the same per-lane kinetic-energy
    plateau the single-run path uses (models/runner.py): lanes never
    self-converge on the device criterion (tolerance 0 — divergence freezing
    stays active) and the plateau test runs host-side per chunk on each
    lane's chunk-end energy. A plateaued lane is recorded converged at that
    chunk boundary but keeps integrating until the whole batch finishes —
    extra steps at steady state only polish, so no device-side freeze mask
    is needed. ``energy_plateau_chunks`` overrides the consecutive-chunk
    window (callers pass models/spectral.scaled_plateau_chunks so the
    window's physical duration stays resolution-independent, exactly as the
    single-run path does).
    """
    chunk = int(min(chunk, max(1, max_iterations)))
    plateau_target = int(energy_plateau_chunks or ENERGY_PLATEAU_CHUNKS)
    use_energy = convergence_metric == "energy"
    inner_tol = 0.0 if use_energy else tolerance
    runner = make_batched_chunk_runner(step_fn, get_uv, chunk, inner_tol,
                                       warmup)

    multiprocess = jax.process_count() > 1
    if mesh is not None:
        from jax.sharding import NamedSharding, PartitionSpec as P

        def shard_leading(tree):
            def put(x):
                spec = P(axis_name, *([None] * (x.ndim - 1)))
                sharding = NamedSharding(mesh, spec)
                if multiprocess:
                    # every process holds the same full value; build the
                    # global array by handing each process its addressable
                    # shards of it
                    arr = np.asarray(x)
                    return jax.make_array_from_callback(
                        arr.shape, sharding, lambda idx: arr[idx])
                return jax.device_put(x, sharding)
            return jax.tree.map(put, tree)

    B = int(jax.tree.leaves(states)[0].shape[0])
    done = jnp.zeros(B, bool)
    conv_iter = jnp.full(B, -1, jnp.int32)
    if mesh is not None:
        ops, states, done, conv_iter = shard_leading(
            (ops, states, done, conv_iter))

    def host(x):
        """Host-side view of a (possibly cross-process) device array."""
        if multiprocess:
            from jax.experimental import multihost_utils as mhu

            return np.asarray(mhu.process_allgather(x, tiled=True))
        return np.asarray(x)

    rows_buf: List[np.ndarray] = []  # variable-length (n_i, B, K) pieces
    idx_buf: List[np.ndarray] = []   # matching global iteration indices
    n_kept = 0
    stride = 1
    conv_accum = None
    energy_col = METRIC_KEYS.index("energy")
    e_prev = None               # (B,) previous chunk-end energies
    plateau = None              # (B,) consecutive plateaued chunks
    conv_it_energy = None       # (B,) iteration of energy convergence
    t0 = time.time()
    it = 0
    # Speculative chunk pipelining (cf. models/runner.py): chunk k+1 is
    # DISPATCHED before chunk k's flags/rows are read back, so the per-chunk
    # host sync and history processing overlap device compute. Exact: the
    # chunk machine freezes converged/diverged lanes (their speculated steps
    # are no-ops), and a chunk speculated past the batch's host-side exit is
    # simply dropped.
    cur = None
    if it < max_iterations:
        cur = runner(ops, states, jnp.asarray(it, jnp.int32), done, conv_iter)
    while cur is not None:
        states, done, conv_iter, ever_conv, rows = cur
        nxt = None
        if it + chunk < max_iterations:
            nxt = runner(ops, states, jnp.asarray(it + chunk, jnp.int32),
                         done, conv_iter)
        done_h = host(done)
        conv_accum = host(ever_conv) if conv_accum is None \
            else (conv_accum | host(ever_conv))
        n_ran = min(chunk, max_iterations - it)
        rows_h = host(rows)[:n_ran]  # (n, B, K)
        gis = np.arange(it, it + n_ran)
        keep = (gis >= warmup) & ((gis - warmup) % stride == 0)
        if keep.any():
            rows_buf.append(rows_h[keep])  # (n, B, K)
            idx_buf.append(gis[keep])
            n_kept += int(keep.sum())
        if n_kept > 2 * max_history_points:
            all_rows = np.concatenate(rows_buf, axis=0)[::2]
            all_idx = np.concatenate(idx_buf)[::2]
            rows_buf, idx_buf = [all_rows], [all_idx]
            n_kept = all_rows.shape[0]
            stride *= 2
        it += n_ran
        if use_energy and it > warmup:
            e_rows = rows_h[:, :, energy_col]  # (n, B)
            B = e_rows.shape[1]
            if plateau is None:
                plateau = np.zeros(B, np.int64)
                conv_it_energy = np.full(B, -1, np.int64)
                e_w0 = np.full(B, np.nan)
            # last finite energy per lane (frozen/diverged lanes emit NaN)
            e_last = np.full(B, np.nan)
            for b in range(B):
                finite = np.isfinite(e_rows[:, b])
                if finite.any():
                    e_last[b] = e_rows[np.flatnonzero(finite)[-1], b]
            if e_prev is not None:
                flat = (np.abs(e_last - e_prev)
                        <= tolerance * np.maximum(np.abs(e_last), 1e-30))
                flat &= np.isfinite(e_last)
                # window-start energy where a plateau run begins (0 -> 1)
                e_w0 = np.where(flat & (plateau == 0), e_prev, e_w0)
                plateau = np.where(flat, plateau + 1, 0)
                reached = plateau >= plateau_target
                # net-drift gate (cf. models/runner.py): the window's NET
                # change must stay within sqrt(window) per-chunk budgets —
                # slow monotone drift (linear in window) fails and keeps
                # integrating; f32 noise (a sqrt(window) random walk) passes
                net_ok = (np.abs(e_last - e_w0)
                          <= tolerance * np.maximum(np.abs(e_last), 1e-30)
                          * max(1.0, plateau_target ** 0.5))
                newly = reached & net_ok & (conv_it_energy < 0)
                conv_it_energy[newly] = it
                plateau = np.where(reached & ~net_ok, 0, plateau)
            e_prev = np.where(np.isfinite(e_last), e_last,
                              e_prev if e_prev is not None else e_last)
        lane_done = done_h if not use_energy else (
            done_h | (conv_it_energy >= 0 if conv_it_energy is not None
                      else np.zeros_like(done_h)))
        if lane_done.all():
            break  # speculated chunk (if any) is dropped
        cur = nxt
    wall = time.time() - t0

    conv_iter_h = host(conv_iter)
    if use_energy:
        if conv_it_energy is None:
            conv_it_energy = np.full(conv_iter_h.shape, -1, np.int64)
        converged = conv_it_energy >= 0
        iterations = np.where(converged, conv_it_energy, it)
        diverged = host(done) & ~converged
    else:
        iterations = np.where(conv_iter_h > 0, conv_iter_h, it)
        converged = conv_accum if conv_accum is not None else np.zeros(
            iterations.shape, bool)
        diverged = host(done) & ~converged

    if rows_buf:
        rows_all = np.concatenate(rows_buf, axis=0)  # (T', B, K)
        idx_all = np.concatenate(idx_buf)
    else:
        B = iterations.shape[0]
        rows_all = np.zeros((0, B, len(METRIC_KEYS)))
        idx_all = np.zeros((0,), np.int64)
    hist = {}
    for ki, key in enumerate(METRIC_KEYS):
        hist[key] = rows_all[:, :, ki].T  # (B, T')
    return SweepResult(states=states, iterations=iterations,
                       converged=converged, diverged=diverged,
                       wall_time=wall, history=hist, history_iters=idx_all)
