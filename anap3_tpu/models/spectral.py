"""Spectral solver classes: single-grid (SG) and FSG multigrid.

These classes are thin hosts around the jitted functional cores in
``spectral_sg.py``; see that module for the numerical contract. The FSG
driver reproduces the coarse-to-fine nested iteration of the reference
(src/solvers/spectral/multigrid/fsg.py:1053-1221 and spectral/fsg.py:39-129):

- hierarchy N, N/2, ... down to ``coarsest_n=12`` (fsg.py:489-543);
- per-level tolerance = tol * factor^(levels_from_finest) (fsg.py:1119-1125);
- spectrally-exact prolongation with hard BC re-enforcement afterwards
  (fsg.py:551-614), here two matmuls with a precomputed DCT-derived matrix;
- NaN/Inf divergence early-exit (fsg.py:1184-1190) via the runner's frozen
  lanes.
"""

from __future__ import annotations

import logging
import time
from typing import Optional

import numpy as np
import jax
import jax.numpy as jnp

from .base import CavitySolver
from .params import Fields, SpectralParameters
from .runner import IterationResult, run_fixed_point
from . import spectral_sg as core
from ..ops import basis as basis_ops
from ..ops.poisson import spectral_dirichlet_poisson


log = logging.getLogger(__name__)

__all__ = ["SGSolver", "FSGSolver", "resolve_convergence_metric"]

# "auto" resolves to the energy-plateau criterion from this order upward:
# the rel-iter false-convergence mode is measured at N >= 128 (solver-study
# r3, STATUS.md: FSG N=192 rel-iter exits after 11 fine-level iterations at
# 2.2x the converged L2; energy lands at the 0.099/0.075 floor).
AUTO_ENERGY_MIN_N = 128


def resolve_convergence_metric(params, n: Optional[int] = None,
                               auto_large: str = "energy") -> str:
    """Resolve the ``convergence_metric`` knob ("auto" is a policy, not a
    criterion the runner understands).

    Single-grid and FSG spectral solves resolve "auto" to ``auto_large``
    (energy) at N >= AUTO_ENERGY_MIN_N and to the reference's rel_iter
    below. VMG/FMG pass ``auto_large="rel_iter"`` — per-cycle rel-iter
    (4 fine steps + a coarse solve per test) matches the energy plateau up
    to N=192 (criterion cross-check, STATUS.md) — and separately force the
    energy plateau on finest levels at N >= VMG_AUTO_ENERGY_MIN_N (256),
    where the shrinking dt ~ 1/N^2 makes per-cycle rel-iter exit
    prematurely (measured at N=320: L2 0.30 vs the 0.099 floor).
    """
    m = str(getattr(params, "convergence_metric", "rel_iter") or "rel_iter")
    if m != "auto":
        return m
    n = int(getattr(params, "nx", 0) if n is None else n)
    return auto_large if n >= AUTO_ENERGY_MIN_N else "rel_iter"


def scaled_plateau_chunks(n: int, chunk: int, anchor_n: int = 96,
                          anchor_window: int = 6000) -> int:
    """N^2-scaled energy-plateau window, in chunks.

    The plateau test integrates |dE| over a window measured in outer
    ITERATIONS while dt ~ 1/N^2 shrinks each iteration's physical-time
    advance, so a fixed window exits earlier (in physical terms) the
    finer the grid. Anchor: the validated N=96 configuration
    (3 chunks x 2000 steps lands exactly on the f64 Newton-exact steady
    state — E_exact=0.041071, L2 0.0989/0.0749 — while the same fixed
    window at N=320 exits at E=0.0384, 6% short). The window therefore
    grows as (n/anchor_n)^2 iterations, floored at the anchor window so
    small-N runs keep at least the anchor's physical duration.
    """
    from .runner import ENERGY_PLATEAU_CHUNKS

    window = anchor_window * (max(int(n), anchor_n) / anchor_n) ** 2
    return max(ENERGY_PLATEAU_CHUNKS, int(np.ceil(window / max(int(chunk), 1))))


class SGSolver(CavitySolver):
    """Single-grid PN-PN-2 artificial-compressibility solver (reference sg.py)."""

    Parameters = SpectralParameters
    # Tensor-parallel (machine.mesh_axes=[x]) single-solve sharding is only
    # implemented for the single-grid solve loop; the multigrid subclasses
    # override solve() without the sharded dispatch and must opt out so the
    # driver does not claim sharding it will not get.
    SUPPORTS_SPATIAL_MESH = True

    def __init__(self, params=None, **kwargs):
        super().__init__(params=params, **kwargs)
        self.ops, self.grid = core.build_spectral_ops(self.params)
        self.state = core.initial_state(self.ops)
        self._check_state_dtype(self.state)
        self._psi_poisson = None
        # Tensor-parallel mesh for ONE large solve (machine.mesh_axes: [x]);
        # set by the driver (main.run_solver) before solve().
        self.spatial_mesh = None

    # -- solve ---------------------------------------------------------

    def _is_singular(self) -> bool:
        """True in the Botella & Peyret sharp-lid subtraction mode."""
        return self.grid.get("singular") is not None

    def solve(self, tolerance: float = None, max_iter: int = None) -> None:
        tol = self.params.tolerance if tolerance is None else tolerance
        max_iter = self.params.max_iterations if max_iter is None else max_iter
        if self.spatial_mesh is not None:
            if self._is_singular():
                raise ValueError(
                    "tensor-parallel sharding (machine mesh_axes=[x]) does "
                    "not support corner_treatment=singular yet; run "
                    "unsharded or use a regularized lid")
            return self._solve_sharded(tol, max_iter)
        ops = self.ops
        if self._is_singular():
            from ..ops.singular import singular_min_n

            floor = singular_min_n(self.params.Re)
            if int(self.params.nx) < floor:
                log.warning(
                    "corner_treatment=singular at N=%d is below the "
                    "measured cold-start stability floor N>=%d for Re=%g; "
                    "expect divergence unless warm-started",
                    self.params.nx, floor, self.params.Re)
        metric = resolve_convergence_metric(self.params)

        def step(state):
            return core.sg_step(ops, state)

        ckpt_mgr, start_iter = None, 0
        if self.params.checkpoint_dir:
            from ..utils.checkpoint import CheckpointManager

            ckpt_mgr = CheckpointManager(
                self.params.checkpoint_dir, self.params,
                every_chunks=self.params.checkpoint_every_chunks)
            self.state, start_iter = ckpt_mgr.restore_or(self.state)
            if start_iter:
                log.info("Resumed from checkpoint at iteration %d", start_iter)

        chunk = int(self.params.chunk_size)
        result = run_fixed_point(
            step,
            lambda s: (s.u, s.v),
            self.state,
            tolerance=tol,
            max_iterations=max_iter,
            chunk=chunk,
            log_callback=self._log_callback,
            checkpoint_mgr=ckpt_mgr,
            start_iteration=start_iter,
            convergence_metric=metric,
            stall_chunks=self._stall_chunks(),
            energy_plateau_chunks=scaled_plateau_chunks(
                int(self.params.nx), chunk),
        )
        if result.stalled:
            log.warning(
                "Convergence stalled above tolerance %.1e after %d "
                "iterations (float32 criterion floor); stopping with the "
                "best attainable state.", tol, result.iterations)
        self.state = result.state
        result = self._maybe_newton_polish(result)
        self._store_results(result)

    def _maybe_newton_polish(self, result: IterationResult) -> IterationResult:
        """Optional float64 Newton polish of the marched state.

        ``newton_polish=true``: after the (typically float32) march
        stops, a few PTC Newton steps (models/steady.py) drive the state to
        the EXACT discrete steady state (RMS steady residual <=
        newton_polish_tol) — eliminating every float32 criterion-floor /
        false-convergence concern at the cost of seconds. The polish rows
        are appended to the history (visible in convergence plots) and the
        Metrics carry polish_steps / steady_residual_rms.
        """
        flag = self.params.newton_polish
        on = flag if isinstance(flag, bool) else \
            str(flag).lower() in ("true", "1", "yes")
        if not on or result.diverged:
            return result
        import dataclasses
        from .steady import polish_state

        t0 = time.time()
        hist = {k: [] for k in ("rel_iter", "u_eq", "v_eq", "continuity",
                                "energy", "enstrophy", "palinstrophy")}
        state64, conv, div, steps, rms = polish_state(
            self.params, self.state,
            tol_rms=float(self.params.newton_polish_tol),
            max_steps=int(self.params.newton_polish_steps),
            gmres_vectors=int(self.params.gmres_vectors), history=hist)
        log.info("Newton polish: %d PTC steps, ||F||_rms=%.2e, "
                 "converged=%s (%.1fs)", steps, rms, conv, time.time() - t0)
        self.state = state64
        self._polish_info = {"steps": steps, "rms": rms}
        for key, rows in hist.items():
            if rows and key in result.history and \
                    result.history[key] is not None:
                result.history[key].extend(rows)
        history_iters = getattr(result, "history_iters", None)
        if history_iters is not None and steps > 0:
            # keep the row <-> global-iteration alignment (runner.py
            # IterationResult contract): polish rows follow the march
            result = dataclasses.replace(
                result, history_iters=np.concatenate([
                    np.asarray(history_iters),
                    result.iterations + 1 + np.arange(steps)]))
        return dataclasses.replace(
            result, state=state64,
            converged=bool(result.converged or conv),
            diverged=bool(div),
            # a float32 criterion stall is moot once the polish converged
            stalled=bool(getattr(result, "stalled", False) and not conv),
            wall_time=result.wall_time + (time.time() - t0))

    def _stall_chunks(self) -> int:
        """Plateau detection: explicit values honored; auto (-1) = off for
        spectral solves (multigrid / convergence_metric=residual are the
        recommended float32 remedies here, params.py stall_chunks docs)."""
        sc = int(self.params.stall_chunks)
        return sc if sc > 0 else 0

    def _solve_sharded(self, tol: float, max_iter: int) -> None:
        """Tensor-parallel solve: rows sharded over self.spatial_mesh["x"].

        The chunked convergence loop runs through
        parallel.spatial.make_sharded_chunk_runner (global psum reductions,
        reference-exact criterion semantics); only the host sync between
        chunks leaves the device mesh. Post-processing gathers the state
        (np.asarray on globally-addressable sharded arrays).
        """
        import jax
        from jax.sharding import NamedSharding
        from ..parallel import spatial
        from .runner import WARMUP_ITERS

        mesh = self.spatial_mesh
        n_x = mesh.devices.size
        nf = int(self.params.nx) + 1
        if nf % n_x != 0:
            raise ValueError(
                f"grid rows ({nf}) must divide the x mesh axis ({n_x})")
        log.info("Sharded solve: N=%d over %d devices (x axis)",
                 self.params.nx, n_x)
        dtype = jnp.dtype(self.params.dtype)
        ops_sh, _ = spatial.build_sharded_ops(self.params, dtype=dtype)
        spec_tree = spatial.make_step_ops_spec()
        ops_sh = jax.tree.map(
            lambda x, s: jax.device_put(x, NamedSharding(mesh, s)),
            ops_sh, spec_tree)
        u = self.state.u.astype(dtype)
        v = self.state.v.astype(dtype)
        p_pad = spatial.pad_pressure(self.state.p.astype(dtype))

        ckpt_mgr, start_iter = None, 0
        if self.params.checkpoint_dir:
            from ..utils.checkpoint import CheckpointManager

            ckpt_mgr = CheckpointManager(
                self.params.checkpoint_dir, self.params,
                every_chunks=self.params.checkpoint_every_chunks)
            (u, v, p_pad), start_iter = ckpt_mgr.restore_or((u, v, p_pad))
            if start_iter:
                log.info("Resumed sharded solve from checkpoint at "
                         "iteration %d", start_iter)

        u, v, p_pad = spatial.shard_state(mesh, (u, v, p_pad))

        def runner_factory(chunk, tol_, metric_):
            return spatial.make_sharded_chunk_runner(
                mesh, ops_sh, chunk, tol_, WARMUP_ITERS,
                convergence_metric=metric_)

        result = run_fixed_point(
            None, lambda s: (s[0], s[1]), (u, v, p_pad),
            tolerance=tol, max_iterations=max_iter,
            chunk=self.params.chunk_size,
            log_callback=self._log_callback,
            checkpoint_mgr=ckpt_mgr,
            start_iteration=start_iter,
            convergence_metric=resolve_convergence_metric(self.params),
            chunk_runner=runner_factory,
            stall_chunks=self._stall_chunks(),
            energy_plateau_chunks=scaled_plateau_chunks(
                int(self.params.nx), int(self.params.chunk_size)),
        )
        u, v, p_pad = result.state
        self.state = core.SpectralState(
            u=jnp.asarray(np.asarray(u)), v=jnp.asarray(np.asarray(v)),
            p=jnp.asarray(np.asarray(spatial.unpad_pressure(p_pad))))
        result = self._maybe_newton_polish(result)
        self._store_results(result)

    # -- field plumbing --------------------------------------------------

    def _final_fields(self) -> Fields:
        X, Y = np.meshgrid(self.grid["x_nodes"], self.grid["y_nodes"], indexing="ij")
        u = np.asarray(self.state.u, dtype=float)
        v = np.asarray(self.state.v, dtype=float)
        p_inner = np.asarray(self.state.p, dtype=float)
        S = self.grid.get("singular")
        if S is not None:
            # exported fields are the TOTAL solution (smooth remainder +
            # analytic corner flow; p_s = nu * p_over_nu, finite on the
            # strictly-interior pressure grid)
            u = u + S["u"]
            v = v + S["v"]
            p_inner = p_inner + float(1.0 / self.params.Re) * \
                S["p_over_nu"][1:-1, 1:-1]
        p_full = np.asarray(
            core.extrapolate_inner_to_full(jnp.asarray(p_inner)), dtype=float)
        return Fields(u=u.ravel(), v=v.ravel(), p=p_full.ravel(),
                      x=X.ravel(), y=Y.ravel())

    def _vorticity_full(self) -> np.ndarray:
        # total=True adds the sampled singular vorticity in singular mode
        return np.asarray(core.vorticity(self.ops, self.state.u, self.state.v))

    def _streamfunction(self):
        if self._psi_poisson is None:
            self._psi_poisson = spectral_dirichlet_poisson(
                self.grid["Dxx"], self.grid["Dyy"],
                dtype=jnp.dtype(self.params.dtype),
            )
        from ..analysis.vortex import solve_streamfunction

        X, Y = np.meshgrid(self.grid["x_nodes"], self.grid["y_nodes"], indexing="ij")
        S = self.grid.get("singular")
        if S is None:
            omega = self._vorticity_full()
            psi = solve_streamfunction(self._psi_poisson, omega)
            return psi, X, Y
        # Singular mode: psi_total = psi_tilde + psi_s with
        # lap(psi_tilde) = -omega_tilde and psi_tilde|boundary = -psi_s
        # (total psi = 0 on walls; psi_s vanishes only on the lid). The
        # interior collocation system absorbs the boundary data through
        # the Laplacian's boundary columns.
        omega_t = np.asarray(core.vorticity(
            self.ops, self.state.u, self.state.v, total=False), dtype=float)
        psi_b = np.zeros_like(omega_t)
        bdy = np.ones_like(omega_t, dtype=bool)
        bdy[1:-1, 1:-1] = False
        psi_b[bdy] = -S["psi"][bdy]
        Dxx, Dyy = self.grid["Dxx"], self.grid["Dyy"]
        lift = Dxx @ psi_b + psi_b @ Dyy.T
        rhs = -omega_t[1:-1, 1:-1] - lift[1:-1, 1:-1]
        psi_t = psi_b.copy()
        psi_t[1:-1, 1:-1] = np.asarray(
            self._psi_poisson.solve(jnp.asarray(rhs)))
        return psi_t + S["psi"], X, Y

    # -- spectral point evaluation ---------------------------------------

    def _evaluate_at_points(self, x: np.ndarray, y: np.ndarray):
        """Global 2D polynomial evaluation at scattered points.

        Replaces the reference's bilinear fallback (base.py:1122-1160) with a
        tensor-product modal evaluation (Legendre basis for conditioning):
        coefficients A = Vx^{-1} U Vy^{-T}, values = einsum of row Vandermondes.
        """
        xn, yn = self.grid["x_nodes"], self.grid["y_nodes"]

        def to_ref(vals, nodes):
            lo, hi = nodes[0], nodes[-1]
            return 2.0 * (np.asarray(vals, dtype=float) - lo) / (hi - lo) - 1.0

        Vx = basis_ops.jacobi_vandermonde(to_ref(xn, xn))
        Vy = basis_ops.jacobi_vandermonde(to_ref(yn, yn))
        Px = basis_ops.jacobi_vandermonde(to_ref(x, xn), degree=xn.size - 1)
        Py = basis_ops.jacobi_vandermonde(to_ref(y, yn), degree=yn.size - 1)

        def eval_field(F):
            coeff = np.linalg.solve(Vx, np.linalg.solve(Vy, np.asarray(F, float).T).T)
            return np.einsum("pm,mn,pn->p", Px, coeff, Py, optimize=True)

        u_pts = eval_field(self.state.u)
        v_pts = eval_field(self.state.v)
        if self._is_singular():
            # interpolate only the smooth remainder spectrally; the corner
            # flow is evaluated analytically at the target points
            from ..ops.singular import eval_singular_uv

            us, vs = eval_singular_uv(
                np.asarray(x, float), np.asarray(y, float),
                lid_velocity=self.params.lid_velocity,
                Lx=self.params.Lx, Ly=self.params.Ly)
            u_pts = u_pts + us
            v_pts = v_pts + vs
        return u_pts, v_pts

    def _vorticity_for_export(self, U, V, x, y):
        """Spectral derivatives for VTS export (instead of spline smoothing).

        U, V arrive in (ny, nx) row-major-by-y layout from the generic
        exporter; the solver's operators act on (x, y)-indexed arrays, so we
        transpose around the matmuls. In singular mode the exporter's U, V
        are TOTAL fields (not spectrally differentiable); use the smooth
        state + the sampled singular vorticity instead.
        """
        if self._is_singular():
            return np.asarray(core.vorticity(
                self.ops, self.state.u, self.state.v)).T
        omega_xy = np.asarray(
            core.vorticity(self.ops, jnp.asarray(U.T, self.ops.Dx.dtype),
                           jnp.asarray(V.T, self.ops.Dx.dtype))
        )
        return omega_xy.T


class FSGSolver(SGSolver):
    """Full-single-grid nested-iteration multigrid spectral solver."""

    COARSEST_N = 12
    SUPPORTS_SPATIAL_MESH = False  # level solves run unsharded

    def _coarsest_floor(self) -> int:
        """Coarsest order: the reference's fixed 12 (fsg.py:489-543),
        raised by the measured cell-Peclet bound at high Re — a
        convection-under-resolved coarsest level diverges the cascade
        (observed: N=24 at Re=3200, Pe=209, goes NaN; the reference never
        ran multigrid past Re=1000). In singular mode the coarsest level
        starts COLD from rest, so it must also satisfy the sharp-lid
        cold-start stability floor (ops/singular.singular_min_n)."""
        from .spectral_vmg import default_coarsest_n

        floor = max(self.COARSEST_N, default_coarsest_n(float(self.params.Re)))
        if self._is_singular():
            from ..ops.singular import singular_min_n

            floor = max(floor, singular_min_n(self.params.Re))
        return floor

    def _level_orders(self) -> list:
        orders = []
        n = int(self.params.nx)
        floor = self._coarsest_floor()
        for _ in range(int(self.params.n_levels)):
            orders.append(n)
            if n // 2 < floor:
                break
            n = n // 2
        return orders[::-1]  # coarsest first

    def solve(self, tolerance: float = None, max_iter: int = None) -> None:
        tol = self.params.tolerance if tolerance is None else tolerance
        max_iter = self.params.max_iterations if max_iter is None else max_iter
        orders = self._level_orders()
        log.info("FSG hierarchy: N = %s", orders)
        dtype = jnp.dtype(self.params.dtype)
        # resolved ONCE from the fine order and applied to every level —
        # the validated FSG-energy configuration converges each level to
        # its plateau (solver-study r3)
        metric = resolve_convergence_metric(self.params)

        t0 = time.time()
        total_iters = 0
        converged = False
        diverged = False
        compile_time = 0.0
        state: Optional[core.SpectralState] = None

        for level_idx, n in enumerate(orders):
            level_tol = tol * (
                self.params.coarse_tolerance_factor ** (len(orders) - 1 - level_idx)
            )
            if n == int(self.params.nx):
                ops, grid = self.ops, self.grid
            else:
                ops, grid = core.build_spectral_ops(self.params, n=n)

            if state is None:
                state = core.initial_state(ops)
            else:
                state = self._prolongate(state, prev_n, n, ops, dtype)

            def step(s, _ops=ops):
                return core.sg_step(_ops, s)

            chunk = int(self.params.chunk_size)
            result = run_fixed_point(
                step, lambda s: (s.u, s.v), state,
                tolerance=level_tol, max_iterations=max_iter,
                chunk=chunk,
                log_callback=self._log_callback
                if level_idx == len(orders) - 1 else None,
                convergence_metric=metric,
                energy_plateau_chunks=scaled_plateau_chunks(n, chunk),
            )
            state = result.state
            total_iters += result.iterations
            converged = result.converged
            diverged = result.diverged
            compile_time += result.first_chunk_time
            log.info("FSG level %d (N=%d): %d iters, converged=%s",
                     level_idx, n, result.iterations, converged)
            if diverged:
                log.warning("FSG level %d diverged (NaN/Inf); aborting", level_idx)
                if n != int(self.params.nx):
                    # finalize with a fine-grid-shaped NaN state so downstream
                    # analysis sees a well-formed (diverged) solution instead
                    # of a coarse-level shape mismatch
                    nf = int(self.params.nx) + 1
                    nan = float("nan")
                    state = core.SpectralState(
                        u=jnp.full((nf, nf), nan, dtype),
                        v=jnp.full((nf, nf), nan, dtype),
                        p=jnp.full((nf - 2, nf - 2), nan, dtype),
                    )
                break
            prev_n = n

        wall = time.time() - t0
        self.state = state
        # Synthesize the single-row history the reference stores
        # (spectral/fsg.py:96-124): final algebraic residuals + a placeholder
        # rel-iter entry at tol (or 10x tol if unconverged).
        R_u, R_v, R_p = core.residuals(self.ops, state.u, state.v, state.p)
        energy, enstrophy, palinstrophy = core.conserved_quantities(
            self.ops, state.u, state.v)
        history = {
            "rel_iter": [tol if converged else tol * 10],
            "u_eq": [float(jnp.linalg.norm(R_u))],
            "v_eq": [float(jnp.linalg.norm(R_v))],
            "continuity": [float(jnp.linalg.norm(R_p))],
            "energy": [float(energy)],
            "enstrophy": [float(enstrophy)],
            "palinstrophy": [float(palinstrophy)],
        }
        result = IterationResult(
            state=state, iterations=total_iters,
            converged=bool(converged and not diverged),
            diverged=bool(diverged), wall_time=wall, history=history,
            first_chunk_time=compile_time,
        )
        result = self._maybe_newton_polish(result)  # sets self.state if on
        self._store_results(result)
        log.info("FSG completed in %.2fs: %d iterations, converged=%s",
                 wall, total_iters, converged)

    def _prolongate(self, state, n_coarse, n_fine, ops_fine, dtype):
        """Coarse->fine transfer with BC re-enforcement (fsg.py:551-614).

        Velocities use the configured (DCT/polynomial) operator on the full
        CGL grids; the inner-grid pressure uses an exact nodal interpolation
        matrix, because the interior nodes are not a smaller CGL grid (see
        ops/transfer.nodal_interpolation_matrix).
        """
        from ..ops import basis as B
        from ..ops.transfer import (make_level_transfer_matrices,
                                    nodal_interpolation_matrix)

        bx = B.make_basis(self.params.basis_type, (0.0, self.params.Lx))
        P_full, _ = make_level_transfer_matrices(
            bx.nodes(n_coarse + 1), bx.nodes(n_fine + 1),
            self.params.prolongation_method, self.params.restriction_method,
            chebyshev=str(self.params.basis_type).lower().startswith("cheb"))
        P_inner = nodal_interpolation_matrix(
            bx.nodes(n_coarse + 1)[1:-1], bx.nodes(n_fine + 1)[1:-1])
        Pf = jnp.asarray(P_full, dtype=dtype)
        Pi = jnp.asarray(P_inner, dtype=dtype)
        mm = lambda a, b: jnp.matmul(a, b, precision=jax.lax.Precision.HIGHEST)
        u = mm(mm(Pf, state.u), Pf.T)
        v = mm(mm(Pf, state.v), Pf.T)
        p = mm(mm(Pi, state.p), Pi.T)
        u, v = core.enforce_bc(ops_fine, u, v)
        return core.SpectralState(u=u, v=v, p=p)
