"""Vmapped FSG multigrid sweeps: many Re/corner lanes through one cascade.

The FSG nested iteration (models/spectral.FSGSolver) is a Python loop over
levels; for a batch of lanes sharing N/n_levels/basis, every level solve is
itself a vmapped batched run (parallel/sweep.py) and the coarse->fine
prolongations are shared-matrix einsums over the batch. This extends the
reference's embarrassingly-parallel sweep model (LSF arrays of FSG runs) to
ONE device program per level.
"""

from __future__ import annotations

import logging
import time

from typing import List, Sequence

import numpy as np
import jax
import jax.numpy as jnp

from ..models import spectral_sg as core
from ..models.params import SpectralParameters
from ..models.runner import IterationResult
from ..ops import basis as B
from ..ops.transfer import (make_level_transfer_matrices,
                            nodal_interpolation_matrix)
from .sweep import run_batched_sweep, stack_ops

log = logging.getLogger(__name__)

__all__ = ["run_batched_fsg"]


def _level_orders(params: SpectralParameters, coarsest_n: int = 12) -> List[int]:
    orders = []
    n = int(params.nx)
    for _ in range(int(params.n_levels)):
        orders.append(n)
        if n // 2 < coarsest_n:
            break
        n = n // 2
    return orders[::-1]


def run_batched_fsg(param_list: Sequence[SpectralParameters],
                    chunk: int | None = None, mesh=None) -> List[IterationResult]:
    """FSG-solve a batch of parameter lanes; returns one result per lane.

    Lanes must share nx/ny, n_levels, basis, dtype, tolerance and
    max_iterations (enforced by the caller's batchability check); Re, corner
    treatment/smoothing, CFL and beta_squared may vary per lane.
    """
    p0 = param_list[0]
    orders = _level_orders(p0)
    dtype = jnp.dtype(p0.dtype)
    chunk = int(chunk or p0.chunk_size)
    tol = float(p0.tolerance)
    max_iter = int(p0.max_iterations)
    B_lanes = len(param_list)
    log.info("Batched FSG: %d lanes, hierarchy N = %s", B_lanes, orders)

    t0 = time.time()
    iters = np.zeros(B_lanes, dtype=int)
    converged = np.zeros(B_lanes, dtype=bool)
    diverged = np.zeros(B_lanes, dtype=bool)
    compile_time = 0.0

    states = None
    fine_ops_list = None
    bx = B.make_basis(p0.basis_type, (0.0, p0.Lx))
    for level_idx, n in enumerate(orders):
        level_tol = tol * (p0.coarse_tolerance_factor
                           ** (len(orders) - 1 - level_idx))
        ops_list = [core.build_spectral_ops(p, n=n)[0] for p in param_list]
        batched_ops = stack_ops(ops_list)
        if states is None:
            init = [core.initial_state(o) for o in ops_list]
            states = jax.tree.map(lambda *a: jnp.stack(a), *init)
        else:
            n_c = orders[level_idx - 1]
            P_full, _ = make_level_transfer_matrices(
                bx.nodes(n_c + 1), bx.nodes(n + 1),
                p0.prolongation_method, p0.restriction_method,
                chebyshev=str(p0.basis_type).lower().startswith("cheb"))
            P_inner = nodal_interpolation_matrix(
                bx.nodes(n_c + 1)[1:-1], bx.nodes(n + 1)[1:-1])
            Pf = jnp.asarray(P_full, dtype)
            Pi = jnp.asarray(P_inner, dtype)

            def prolong(u):
                return jnp.einsum("ij,bjk,lk->bil", Pf, u, Pf,
                                  precision=jax.lax.Precision.HIGHEST)

            u = prolong(states.u)
            v = prolong(states.v)
            p = jnp.einsum("ij,bjk,lk->bil", Pi, states.p, Pi,
                           precision=jax.lax.Precision.HIGHEST)
            u, v = jax.vmap(core.enforce_bc)(batched_ops, u, v)
            states = core.SpectralState(u=u, v=v, p=p)

        # finest level: honor the lane config's criterion ("auto" resolves
        # to the energy plateau at N >= 128); coarser levels only provide
        # warm starts, where per-step rel_iter is adequate (FSG cascade
        # semantics, cf. models/spectral.FSGSolver)
        if level_idx == len(orders) - 1:
            from ..models.spectral import resolve_convergence_metric

            metric = resolve_convergence_metric(p0, n=n)
        else:
            metric = "rel_iter"
        from ..models.spectral import scaled_plateau_chunks

        res = run_batched_sweep(
            core.sg_step, lambda s: (s.u, s.v), batched_ops, states,
            tolerance=level_tol, max_iterations=max_iter, chunk=chunk,
            mesh=mesh, convergence_metric=metric,
            energy_plateau_chunks=scaled_plateau_chunks(n, chunk))
        states = res.states
        iters += np.asarray(res.iterations)
        converged = np.asarray(res.converged)
        diverged |= np.asarray(res.diverged)
        fine_ops_list = ops_list
        log.info("  level %d (N=%d): median %d iters, %d/%d converged",
                 level_idx, n, int(np.median(np.asarray(res.iterations))),
                 int(np.asarray(res.converged).sum()), B_lanes)

    wall = time.time() - t0
    # synthesize per-lane single-row histories (cf. FSGSolver.solve /
    # reference spectral/fsg.py:96-124)
    results: List[IterationResult] = []
    vres = jax.vmap(core.residuals)
    batched_fine = stack_ops(fine_ops_list)
    R_u, R_v, R_p = vres(batched_fine, states.u, states.v, states.p)
    omega = jax.vmap(core.vorticity)(batched_fine, states.u, states.v)
    W = batched_fine.W2d
    mmT = lambda a, b: jnp.matmul(a, b, precision=jax.lax.Precision.HIGHEST)
    dwx = jax.vmap(mmT)(batched_fine.Dx, omega)
    dwy = jax.vmap(mmT)(omega, batched_fine.DyT)
    energy = 0.5 * jnp.sum(W * (states.u**2 + states.v**2), axis=(1, 2))
    enstrophy = 0.5 * jnp.sum(W * omega**2, axis=(1, 2))
    palinstrophy = 0.5 * jnp.sum(W * (dwx**2 + dwy**2), axis=(1, 2))
    norms = lambda a: jnp.sqrt(jnp.sum(a**2, axis=(1, 2)))
    nu_u, nu_v, nu_p = norms(R_u), norms(R_v), norms(R_p)

    for k in range(B_lanes):
        lane_state = jax.tree.map(lambda x: x[k], states)
        ok = bool(converged[k] and not diverged[k])
        history = {
            "rel_iter": [tol if ok else tol * 10],
            "u_eq": [float(nu_u[k])],
            "v_eq": [float(nu_v[k])],
            "continuity": [float(nu_p[k])],
            "energy": [float(energy[k])],
            "enstrophy": [float(enstrophy[k])],
            "palinstrophy": [float(palinstrophy[k])],
        }
        # wall_time is the SHARED batch wall (all lanes ran concurrently in
        # one device program; an even split would fabricate per-lane times
        # the way the reference never does — it measures real per-run wall,
        # base.py:163-169). Callers tag batched runs wall_time_scope=batch.
        results.append(IterationResult(
            state=lane_state, iterations=int(iters[k]), converged=ok,
            diverged=bool(diverged[k]), wall_time=wall,
            history=history, first_chunk_time=compile_time))
    return results
