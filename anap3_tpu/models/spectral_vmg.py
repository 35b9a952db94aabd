"""FAS V-cycle and full-multigrid (FMG) spectral solvers.

The reference documents VMG/FMG solvers (docs/source/api_reference.rst:20-21,
usage.rst:44-46) and carries FAS tau-correction hooks in its smoother
(multigrid/fsg.py:1019-1045) but implements neither — only FSG nested
iteration exists. This module supplies the real thing, following the FAS
scheme of Zhang & Xi (2010) for the artificial-compressibility equations:

Per V-cycle on level h (fine) with coarse level H:
1. nu1 pre-smoothing RK4 steps with the level's tau forcing;
2. defect d_h = R_h(u_h) + tau_h;
3. state restriction by INJECTION (nested Gauss-Lobatto grids,
   fsg.py:622-664): u_H0 = Inj u_h Inj^T;
4. tau_H = I_res(d_h) - R_H(u_H0), with velocity defects zeroed on the
   boundary ring before the restriction (fsg.py:693-726) — so that
   R_H(u_H) + tau_H = 0 reproduces the fine solution through the coarse
   operator (classical FAS). I_res is spectral truncation for smooth
   (regularized-lid) defects and nodal INJECTION in singular mode, where
   the defect carries sampled 1/r corner constants that truncation would
   Gibbs-ring across the level (see build_vmg_levels);
5. recurse (or nu_coarse smoothing steps on the coarsest level);
6. correction u_h += P(u_H - u_H0) with hard BC re-enforcement
   (fsg.py:586-599); corrections are zero at velocity boundaries by
   construction of step 4's zeroing + BC enforcement;
7. nu2 post-smoothing steps.

One OUTER ITERATION of the solver = one V-cycle; convergence uses the same
relative-iterate-change criterion as everything else. The whole V-cycle is a
single jitted function (the level loop is unrolled at trace time — shapes
are static per level).

FMG = FSG nested iteration where each level is solved by V-cycles over the
hierarchy built so far.

Every level of a FAS hierarchy must RESOLVE the lid boundary layer
(coarsest N >= ~2.4*sqrt(Re), the measured FAS resolution floor — see
FAS_RESOLUTION_COEFF); below it the tau-corrected coarse problem relaxes
toward the coarse grid's own flow and the cycle converges to a biased
state (round-2 study). build_vmg_levels enforces the floor; hierarchies
it cannot coarsen degenerate (with a warning) to single-grid SG.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass
from typing import List

import numpy as np
import jax
import jax.numpy as jnp

from .params import SpectralParameters
from .runner import run_fixed_point, IterationResult
from .spectral import SGSolver, resolve_convergence_metric, scaled_plateau_chunks
from . import spectral_sg as core
from ..ops.basis import make_basis
from ..ops.transfer import (fft_restriction_matrix, injection_restriction_matrix,
                            make_level_transfer_matrices,
                            modal_restriction_matrix, nodal_injection_matrix,
                            nodal_interpolation_matrix)

log = logging.getLogger(__name__)

__all__ = ["VMGSolver", "FMGSolver", "build_vmg_levels", "make_v_cycle",
           "fas_coarsest_n"]

_HIGHEST = jax.lax.Precision.HIGHEST


def _mm(a, b):
    return jnp.matmul(a, b, precision=_HIGHEST)


@dataclass
class VmgLevel:
    """Operators for one level plus transfers to the NEXT-COARSER level."""

    n: int
    ops: core.SpectralOps
    # fine->coarse (toward next-coarser level); None on the coarsest level
    inj_full: jnp.ndarray | None = None    # (nc+1, nf+1) injection
    inj_inner: jnp.ndarray | None = None   # (nc-1, nf-1)
    res_full: jnp.ndarray | None = None    # (nc+1, nf+1) spectral truncation
    res_inner: jnp.ndarray | None = None
    # coarse->fine prolongation (from next-coarser level up to this one)
    pro_full: jnp.ndarray | None = None    # (nf+1, nc+1)
    pro_inner: jnp.ndarray | None = None


# Calibration of the cell-Peclet safeguards (measured in float32):
# STABLE:    N=24 at Re=1000 (Pe=65, VMG damping 0.6); N=48 at Re=3200
#            (Pe=105, FSG cascade, converged to 1e-6);
# DIVERGENT: N=12 at Re=1000 (Pe=131, VMG even with damping 0.6); N=24 at
#            Re=3200 (Pe=209, FSG goes NaN);
# N=12 at Re=100 (Pe=13) takes full-strength corrections. The thresholds
# below bracket those observations while responding to the actual
# coarse-grid resolution instead of raw Re buckets. (These guard the FSG
# CASCADE; the FAS hierarchy below uses the stricter resolution floor.)
PE_COARSEST_MAX = 110.0     # coarsest level must have Pe <= this
PE_FULL_CORRECTION = 15.0   # undamped corrections below this

# FAS resolution floor (round-2 study, measured in float32, cold
# start, full-strength corrections, nu1=nu2=2, nu_coarse=30):
#   Re=100:  fine 48 / coarse 24 converges EXACTLY to the SG energy
#            (0.032880 vs truth 0.0328805); coarse 12 limit-cycles at a
#            biased state (0.0366) and line-searched corrections reject.
#   Re=1000: fine 192 / coarse 96 converges unbiased (energy 0.0405, max
#            Ghia centerline err 0.021/0.014) in ~160k fine-step
#            equivalents where single-grid SG is still at err 0.12 after
#            6M steps; coarse 48 drifts to the coarse grid's own
#            attractor (energy -> 0.0410 = N=48's solution); coarse 24
#            diverges.
# Mechanism: every FAS level must RESOLVE the lid boundary layer
# (delta ~ 1/sqrt(Re); near-wall CGL spacing ~ (pi/N)^2/2, so
# N >= c*sqrt(Re)). Below the floor the coarse operator's truncation
# error exceeds the restricted defect (measured |R_H(I u)| ~ 3.6x |I d|
# at the failing levels) and the tau-corrected coarse problem relaxes
# toward the coarse grid's own flow, which the prolongated correction
# imposes on the fine state. The observed brackets (floor in (12,24] at
# Re=100, (48,96] at Re=1000) pin the coefficient to ~2.4.
#
# ROUND-5 HIGH-Re RE-BRACKETING (measured in float32, energy criterion, fine N=192, truth = converged
# FSG/SG-energy state at the same N; scripts/dev/vmg_probe.py --orders):
# - Re=3200: cold [192, 96] converges UNBIASED (283k cycles, L2 vs
#   truth 5.8e-3/7.6e-3 = criterion slop) and so does cold [192, 64]
#   (96k cycles, 1.7e-4/2.2e-4): the true floor at Re=3200 is AT OR
#   BELOW 64 = 1.13*sqrt(Re) — the 2.4*sqrt(Re) = 136 extrapolation is
#   >2x conservative.
# - The round-2 Re=1000 bracket is STALE on current code: cold
#   [192, 48] — the historically-biased configuration — now lands
#   within 2.2e-4 of the fine truth after 100k cycles (no coarse-
#   attractor bias). The round-2 calibration predates the basis-aware
#   nodal transfers (round 3) and the tau/restriction fixes (round 4);
#   on today's kernels no smoothed-lid bias point has been reproduced,
#   so the measured floor is <=48 = 1.52*sqrt(Re) at Re=1000 and
#   <=64 = 1.13*sqrt(Re) at Re=3200.
# - Re=10000: cold [192, 96] DIVERGES to NaN in 2.6k cycles — N=96 at
#   Re=10000 has cell Peclet 164 > PE_COARSEST_MAX 110, so the Pe
#   divergence guard (not the resolution floor) is what a forced
#   hierarchy violates first there; the production coarsest
#   max(2.4*sqrt(Re), Pe bound) = 240 stands CONFIRMED on the failing
#   side at Re=10000.
# - WARM-started hierarchies are stable well below the floor: even the
#   historically-biased [192, 48] @ Re=1000 holds the fine truth to
#   2.5e-4 over 25k cycles (non-growing; [192,96]/[192,64] @ 3200 stay
#   at 1e-4 over 2500 cycles). The floor failure is a COLD-START BASIN
#   effect — the biased coarse-attractor state coexists with the
#   locally-stable true fixed point — which is why the cold-start
#   warm-start prelude (VMG_COLD_START_MAX_N) is the right mitigation
#   and why FMG/warm-started V-cycles never showed it.
# - Production rule: keep coarsest N >= 2.4*sqrt(Re) for cold starts.
#   Every hierarchy it admits converged unbiased in every round's
#   measurements, and relaxing a safety floor on one night's evidence
#   (three Re values, one fine N, smoothed lid only — singular mode,
#   other lids, and Re > 3200 below the Pe bound remain unmeasured on
#   the fixed transfers) is a bad trade for the <=3x extra coarse-level
#   work it costs. Experts can force deeper ladders via
#   build_vmg_levels(orders=...) / vmg_probe --orders after a truth
#   check. See STATUS.md "Round-5 additions" for the full protocol.
FAS_RESOLUTION_COEFF = 2.4


def cell_peclet(Re: float, n: int) -> float:
    """Cell Peclet of a CGL grid of order n: Pe = U h_max / nu = Re*pi/(2n).

    h_max is the largest Chebyshev-Gauss-Lobatto spacing (at the domain
    center), pi*Lx/(2n); nu = U*Lx/Re. Measures how well the grid resolves
    convection — FAS corrections from a convection-under-resolved coarse
    grid destabilize the fine level.
    """
    return float(Re) * np.pi / (2.0 * n)


def default_coarsest_n(Re: float) -> int:
    """Coarsest order whose cell Peclet stays within PE_COARSEST_MAX."""
    return max(12, int(np.ceil(float(Re) * np.pi / (2.0 * PE_COARSEST_MAX))))


def fas_coarsest_n(Re: float, singular: bool = False) -> int:
    """Coarsest order admissible in a FAS hierarchy at this Re.

    Every FAS level must resolve the lid boundary layer, or the coarse
    correction drags the fine solution toward the coarse grid's own
    attractor (see FAS_RESOLUTION_COEFF calibration above). Distinct from
    the weaker Pe-based ``default_coarsest_n`` that guards the FSG
    CASCADE, where coarse levels only provide initial guesses, never
    defect corrections.

    SINGULAR mode coarsens further (coefficient 2.0 vs 2.4): subtracting
    the corner flow removes the profile feature the smoothed lid forces
    every level to resolve. Measured (round 4, float32, nodal-injection
    defect restriction): Re=1000 [128, 64] — coarse 64 BELOW the
    smoothed-lid floor of 76 — converges unbiased to the exact sharp-lid
    truth (u L2 5.4e-3, psi_min 0.34% vs Botella); 2.0*sqrt(1000) = 63.2
    pins the coefficient at the measured bracket. Levels must also stay
    above the singular sampling floor (ops/singular.singular_min_n), which
    is far below this bound at every production Re.
    """
    coeff = 2.0 if singular else FAS_RESOLUTION_COEFF
    return max(12, int(np.ceil(coeff * np.sqrt(float(Re)))))


def _warn_if_degenerate(levels, params) -> None:
    if len(levels) == 1:
        log.warning(
            "VMG/FMG hierarchy at N=%d, Re=%g has a single level: the FAS "
            "resolution floor (coarsest N >= %d ~ 2.4*sqrt(Re)) admits no "
            "coarser grid, so the solver degenerates to single-grid SG. "
            "Use a finer grid, or solver=spectral/fsg whose cascade "
            "tolerates coarser levels.",
            int(params.nx), float(params.Re), fas_coarsest_n(float(params.Re)))


# "auto" convergence criterion switches from per-cycle rel_iter to the
# kinetic-energy plateau at this fine-grid size (see VMGSolver.solve).
VMG_AUTO_ENERGY_MIN_N = 256
# Largest fine grid where rest-started V-cycles are validated to converge
# to the physical steady state (N=256: 415 s to the smoothing-floor L2; at
# [320,160] three independent rest starts land on a spurious FAS fixed
# point with E stationary at 0.0300 vs 0.0397 — warm starts converge, so
# FMG is the production solver there; see VMGSolver.solve).
VMG_COLD_START_MAX_N = 256


def build_vmg_levels(params: SpectralParameters, n_fine: int | None = None,
                     coarsest_n: int | None = None,
                     orders: List[int] | None = None) -> List[VmgLevel]:
    """Hierarchy from FINE (index 0) to COARSE, with per-pair transfers.

    ``orders`` forces an explicit (possibly non-halving) ladder and
    bypasses the resolution floor — the FAS floor-bracketing experiment
    hook (scripts/dev/vmg_probe.py --orders); production callers leave it
    None and get the floor-guarded halving ladder.
    """
    dtype = jnp.dtype(params.dtype)
    if orders is not None:
        if sorted(orders, reverse=True) != list(orders):
            raise ValueError("orders must be fine-to-coarse")
    if coarsest_n is None:
        # resolution floor AND the Pe divergence guard: the FAS floor
        # (~2.4*sqrt(Re); 2.0 in singular mode) dominates up to Re ~ 28k;
        # beyond that the cell-Peclet bound (Pe <= 110) is the binding
        # constraint
        singular = str(params.corner_treatment).lower() == "singular"
        coarsest_n = max(fas_coarsest_n(float(params.Re), singular),
                         default_coarsest_n(float(params.Re)))
    if orders is None:
        orders = []
        n = int(params.nx if n_fine is None else n_fine)
        for _ in range(int(params.n_levels)):
            orders.append(n)
            if n // 2 < coarsest_n:
                break
            n = n // 2
    else:
        orders = [int(n) for n in orders]

    bx = make_basis(params.basis_type, (0.0, params.Lx))
    levels: List[VmgLevel] = []
    for idx, n in enumerate(orders):
        ops, _ = core.build_spectral_ops(params, n=n)
        level = VmgLevel(n=n, ops=ops)
        if idx + 1 < len(orders):
            nc = orders[idx + 1]
            cast = lambda a: jnp.asarray(a, dtype=dtype)
            x_f = bx.nodes(n + 1)
            x_c = bx.nodes(nc + 1)
            is_cheb = str(params.basis_type).lower().startswith("cheb")
            nested = is_cheb and n % nc == 0
            if is_cheb and not nested:
                # non-halving experimental ladders (--orders): CGL(nc)
                # does NOT nest in CGL(n) unless nc divides n — exact
                # polynomial resampling replaces injection, spectral
                # truncation still restricts the defect
                if str(params.corner_treatment).lower() == "singular":
                    raise ValueError(
                        "singular-mode FAS needs NESTED levels (nodal "
                        "injection cancellation); use a halving ladder")
                level.inj_full = cast(nodal_interpolation_matrix(x_f, x_c))
                level.res_full = cast(fft_restriction_matrix(n + 1, nc + 1))
            elif is_cheb:
                # Chebyshev-Lobatto full grids nest and carry the DCT
                # identities — use the reference's operators directly
                level.inj_full = cast(
                    injection_restriction_matrix(n + 1, nc + 1))
                if str(params.corner_treatment).lower() == "singular":
                    # SINGULAR-MODE FAS (round 4, VERDICT r3 #3): restrict
                    # the defect by INJECTION, not spectral truncation. The
                    # smooth-remainder residual carries sampled |grad u_s|
                    # ~ 1/r constants whose nearest-node values scale like
                    # N^2 — truncating that spike Gibbs-rings it across the
                    # whole coarse tau (the round-3 measured drift:
                    # Re=100 [48,24] relaxed to E=0.159 vs the 0.034
                    # physical value). At the NESTED coincident nodes the
                    # fine- and coarse-sampled singular constants are the
                    # SAME analytic functions at the SAME points, so with
                    # nodal injection of both state and defect they cancel
                    # exactly in tau_H = Inj(d_h) - R_H(Inj u_h): tau
                    # carries only the smooth spectral-derivative content,
                    # as in the regularized-lid mode.
                    level.res_full = level.inj_full
                else:
                    level.res_full = cast(
                        fft_restriction_matrix(n + 1, nc + 1))
            else:
                # LGL (etc.) grids do NOT nest and the DCT path is invalid:
                # exact polynomial resampling for the FAS solution
                # restriction, Legendre-modal truncation for the defect
                level.inj_full = cast(nodal_interpolation_matrix(x_f, x_c))
                level.res_full = cast(modal_restriction_matrix(x_f, x_c))
            P_full, _ = make_level_transfer_matrices(
                x_c, x_f, params.prolongation_method,
                params.restriction_method, chebyshev=is_cheb)
            level.pro_full = cast(P_full)
            # inner pressure grids are NOT — build from node positions
            x_fi = bx.nodes(n + 1)[1:-1]
            x_ci = bx.nodes(nc + 1)[1:-1]
            level.inj_inner = cast(nodal_injection_matrix(x_fi, x_ci))
            level.res_inner = cast(nodal_interpolation_matrix(x_fi, x_ci))
            level.pro_inner = cast(nodal_interpolation_matrix(x_ci, x_fi))
        levels.append(level)
    return levels


def _zero_boundary(a: jnp.ndarray) -> jnp.ndarray:
    mask = jnp.zeros_like(a).at[1:-1, 1:-1].set(1.0)
    return a * mask


def make_v_cycle(levels: List[VmgLevel], nu1: int = 2, nu2: int = 2,
                 nu_coarse: int = 30, damping: float = 1.0):
    """Build the jitted V-cycle step: state -> (state, metrics).

    ``damping`` under-relaxes the prolongated coarse-grid correction
    (experimentation hook; production cycles run full strength — the
    round-2 study showed damping only slows the drift toward the coarse
    attractor when a level violates the FAS resolution floor, it does not
    remove it, while levels satisfying the floor need no damping).
    """
    def smooth(idx: int, state, tau, n_steps: int):
        level = levels[idx]

        def body(s, _):
            return core.sg_step(level.ops, s, tau=tau)

        state, ms = jax.lax.scan(body, state, None, length=n_steps)
        last = jax.tree.map(lambda x: x[-1], ms)
        return state, last

    def defect(level: VmgLevel, state, tau):
        R_u, R_v, R_p = core.residuals(level.ops, state.u, state.v, state.p)
        if tau is not None:
            R_u = R_u + tau[0]
            R_v = R_v + tau[1]
            R_p = R_p + tau[2]
        return R_u, R_v, R_p

    def cycle(idx: int, state, tau):
        level = levels[idx]
        if idx == len(levels) - 1:  # coarsest: just smooth
            state, m = smooth(idx, state, tau, nu_coarse)
            return state, m

        state, _ = smooth(idx, state, tau, nu1)

        d_u, d_v, d_p = defect(level, state, tau)
        # zero velocity defects on the boundary ring BEFORE spectral
        # restriction (fsg.py:693-726)
        d_u = _zero_boundary(d_u)
        d_v = _zero_boundary(d_v)

        u_H0 = _mm(_mm(level.inj_full, state.u), level.inj_full.T)
        v_H0 = _mm(_mm(level.inj_full, state.v), level.inj_full.T)
        p_H0 = _mm(_mm(level.inj_inner, state.p), level.inj_inner.T)
        u_H0, v_H0 = core.enforce_bc(levels[idx + 1].ops, u_H0, v_H0)
        coarse0 = core.SpectralState(u=u_H0, v=v_H0, p=p_H0)

        rd_u = _mm(_mm(level.res_full, d_u), level.res_full.T)
        rd_v = _mm(_mm(level.res_full, d_v), level.res_full.T)
        rd_p = _mm(_mm(level.res_inner, d_p), level.res_inner.T)
        rd_u = _zero_boundary(rd_u)
        rd_v = _zero_boundary(rd_v)

        R_u0, R_v0, R_p0 = defect(levels[idx + 1], coarse0, None)
        tau_H = (rd_u - R_u0, rd_v - R_v0, rd_p - R_p0)

        coarse, _ = cycle(idx + 1, coarse0, tau_H)

        e_u = _mm(_mm(level.pro_full, coarse.u - coarse0.u), level.pro_full.T)
        e_v = _mm(_mm(level.pro_full, coarse.v - coarse0.v), level.pro_full.T)
        e_p = _mm(_mm(level.pro_inner, coarse.p - coarse0.p), level.pro_inner.T)
        u = state.u + damping * _zero_boundary(e_u)
        v = state.v + damping * _zero_boundary(e_v)
        p = state.p + damping * e_p
        u, v = core.enforce_bc(level.ops, u, v)
        # Divergence-tolerant cycles (reference NaN handling analog,
        # multigrid/fsg.py:1184-1190): a tau-forced coarse level can blow
        # up during the impulsive-start transient (measured: [160,80]
        # Re=1000 f32 goes NaN in ~280 cycles while [192,96] is stable —
        # the N=80 kernel itself is 1e-8-parity clean, the FORCED coarse
        # dynamics are what diverge). FAS re-injects a fresh coarse state
        # every cycle, so rejecting a non-finite correction self-heals:
        # the fine level keeps smoothing and corrections resume once the
        # transient passes. A non-finite FINE state is real divergence
        # and stays visible to the runner's NaN detection.
        ok = (jnp.all(jnp.isfinite(e_u)) & jnp.all(jnp.isfinite(e_v))
              & jnp.all(jnp.isfinite(e_p)))
        u = jnp.where(ok, u, state.u)
        v = jnp.where(ok, v, state.v)
        p = jnp.where(ok, p, state.p)
        state = core.SpectralState(u=u, v=v, p=p)

        state, m = smooth(idx, state, tau, nu2)
        return state, m

    def v_cycle_step(state):
        return cycle(0, state, None)

    return v_cycle_step


class VMGSolver(SGSolver):
    """FAS V-cycle multigrid solver; one outer iteration = one V-cycle."""

    NU1 = 2
    NU2 = 2
    NU_COARSE = 30
    SUPPORTS_SPATIAL_MESH = False

    def _reject_singular(self) -> bool:
        """Singular-mode FAS is supported on Chebyshev hierarchies (round 4,
        VERDICT r3 #3): nodal-injection defect restriction cancels the
        sampled 1/r singular constants exactly at the nested coincident
        nodes (see build_vmg_levels), fixing the round-3 measured drift
        (Re=100 [48,24] relaxed to E=0.159 vs 0.034; now converges to
        E=0.0344, max|u - u_SG| = 1.9e-3, in 22x less fine-grid work than
        single-grid). Non-nested bases (Legendre LGL) have no coincident
        nodes for the cancellation — those still fall back."""
        if not self._is_singular():
            return False
        if str(self.params.basis_type).lower().startswith("cheb"):
            return False
        log.warning(
            "FAS V-cycle multigrid supports corner_treatment=singular only "
            "on Chebyshev hierarchies (nested grids make the injected "
            "singular constants cancel in tau); falling back to the "
            "single-grid solve for basis_type=%s.", self.params.basis_type)
        return True

    def _cold_start_warm_state(self, levels, tol, max_iter):
        """Nested-iteration warm start for cold solves above the validated
        ceiling (VERDICT r3 #4): run the FMG cascade over every level BELOW
        the finest (each solved by V-cycles over its sub-hierarchy, exactly
        FMGSolver's per-level loop), then prolongate to the finest level.
        Coarse cold starts are within their validated range by construction
        (build_vmg_levels halves, so the second level sits at nx/2 <=
        VMG_COLD_START_MAX_N whenever nx <= 2*VMG_COLD_START_MAX_N; deeper
        fines recurse through the same cascade shape level by level).

        Returns ``(fine_state, total_sub_iterations)``.
        """
        dtype = jnp.dtype(self.params.dtype)
        coarse_to_fine = levels[::-1]
        state = None
        total = 0
        # singular cycles carry a per-cycle rel-iter noise floor from the
        # corner-sampled convection constants (see solve()'s criterion
        # resolution) — prelude levels would burn their whole budget on a
        # criterion that can never fire, so they use the energy plateau too
        metric = resolve_convergence_metric(self.params, auto_large="rel_iter")
        if (str(getattr(self.params, "convergence_metric", "auto")) == "auto"
                and self._is_singular()):
            metric = "energy"
        reached = 0
        for k, level in enumerate(coarse_to_fine[:-1]):
            reached = k
            sub_levels = levels[len(levels) - 1 - k:]
            level_tol = tol * (self.params.coarse_tolerance_factor
                               ** (len(coarse_to_fine) - 1 - k))
            if state is None:
                state = core.initial_state(level.ops)
            else:
                state = FMGSolver._prolongate_fmg(
                    self, coarse_to_fine[k - 1], level, state, dtype)
            warm = state  # finite by construction (prolongated/cold init)
            cyc_chunk = max(1, min(50, self.params.chunk_size // 4))
            if len(sub_levels) > 1:
                step = make_v_cycle(sub_levels, self.NU1, self.NU2,
                                    self.NU_COARSE)
                budget = max(1, max_iter // (self.NU1 + self.NU2))
                window = scaled_plateau_chunks(
                    level.n, cyc_chunk, anchor_n=192, anchor_window=150)
            else:
                def step(s, _ops=level.ops):
                    return core.sg_step(_ops, s)
                budget = max_iter
                window = scaled_plateau_chunks(level.n, cyc_chunk)
            result = run_fixed_point(
                step, lambda s: (s.u, s.v), state,
                tolerance=level_tol, max_iterations=budget, chunk=cyc_chunk,
                convergence_metric=metric,
                energy_plateau_chunks=window,
            )
            state = result.state
            total += int(result.iterations)
            log.info("warm-start level %d (N=%d): %d iterations, "
                     "converged=%s", k, level.n, result.iterations,
                     result.converged)
            if result.diverged:
                # the diverging step is committed before the lane freeze,
                # so the result state can be NaN-contaminated — fall back
                # to the finite warm start this level began from
                if not bool(jnp.all(jnp.isfinite(result.state.u))):
                    state = warm
                log.warning("warm-start level %d (N=%d) diverged; "
                            "continuing with its last finite state",
                            k, level.n)
                break
        # prolongate from the last level actually reached through every
        # remaining transfer pair (an early divergence break may leave the
        # state several levels below the finest)
        for j in range(reached + 1, len(coarse_to_fine)):
            state = FMGSolver._prolongate_fmg(
                self, coarse_to_fine[j - 1], coarse_to_fine[j], state, dtype)
        return state, total

    def solve(self, tolerance: float = None, max_iter: int = None) -> None:
        # NOTE: the warm-start prelude above mirrors FMGSolver.solve's
        # per-level cascade (level slicing, level_tol schedule, budgets)
        # with a different divergence policy (fall back + prolongate vs
        # abort with a fine-shaped NaN state) — change them together.
        tol = self.params.tolerance if tolerance is None else tolerance
        max_iter = self.params.max_iterations if max_iter is None else max_iter
        if self._reject_singular():
            super().solve(tolerance=tol, max_iter=max_iter)
            return
        levels = build_vmg_levels(self.params)
        log.info("VMG hierarchy: N = %s (FAS floor %d for Re=%g), "
                 "full-strength corrections",
                 [lv.n for lv in levels],
                 fas_coarsest_n(float(self.params.Re),
                                self._is_singular()),
                 float(self.params.Re))
        _warn_if_degenerate(levels, self.params)
        if len(levels) == 1:
            # genuinely degenerate to single-grid SG: run the SG solve path
            # (per-step criterion, the requested
            # max_iterations as FINE steps) instead of make_v_cycle's
            # coarsest branch, which would smooth NU_COARSE steps per
            # "cycle" against a NU1+NU2-scaled cycle budget.
            super().solve(tolerance=tol, max_iter=max_iter)
            return
        if (int(self.params.nx) > VMG_COLD_START_MAX_N
                and not bool(jnp.any(self.state.v != 0))):
            # measured (STATUS.md "N=320 ladder"): [320,160] V-cycles from
            # rest converge to a spurious FAS fixed point (E stationary to
            # <2e-10/cycle at 0.0300 vs the 0.0397 steady value; L2 0.25 vs
            # the ~0.10 floor) while warm-started cycles at the same size
            # converge fine. Above the validated cold-start ceiling the
            # solver warm-starts ITSELF with the nested-iteration cascade
            # (round 4; previously it only warned and pointed at FMG).
            log.info(
                "VMG cold start at N=%d is above the validated ceiling "
                "(N=%d): warm-starting from the nested-iteration cascade "
                "to avoid the measured spurious FAS fixed point.",
                int(self.params.nx), VMG_COLD_START_MAX_N)
            self.state, pre_iters = self._cold_start_warm_state(
                levels, tol, max_iter)
            log.info("VMG warm-start prelude done (%d sub-level "
                     "iterations)", pre_iters)
        v_cycle = make_v_cycle(levels, self.NU1, self.NU2, self.NU_COARSE)
        # per-cycle work = nu1+nu2 fine smoothing steps; scale the cycle
        # budget so max_iterations keeps its fine-step meaning
        max_cycles = max(1, max_iter // (self.NU1 + self.NU2))
        # "auto": per-cycle rel_iter up to N=192 (criterion cross-check,
        # STATUS.md: identical state to the energy plateau at N=192), the
        # energy plateau at N >= VMG_AUTO_ENERGY_MIN_N — at N=320 the
        # per-step dt ~ 1/N^2 is small enough that per-cycle rel-iter
        # exits far from steady state (measured: [320,160] rel-iter
        # "converged" at L2 0.30 vs the ~0.099/0.075 smoothed-lid floor).
        metric = resolve_convergence_metric(self.params, auto_large="rel_iter")
        if (str(getattr(self.params, "convergence_metric", "auto")) == "auto"
                and (int(self.params.nx) >= VMG_AUTO_ENERGY_MIN_N
                     or self._is_singular())):
            # singular cycles additionally carry a per-cycle rel-iter noise
            # floor from the corner-sampled convection constants (measured:
            # Re=1000 N=128 ran a 200k-cycle budget without reaching 1e-6
            # rel-iter while the energy criterion converges at the sharp-lid
            # truth in 172k cycles) — auto resolves singular VMG to energy
            # at every size
            metric = "energy"
        cyc_chunk = max(1, min(50, self.params.chunk_size // (self.NU1 + self.NU2)))
        result = run_fixed_point(
            v_cycle, lambda s: (s.u, s.v), self.state,
            tolerance=tol, max_iterations=max_cycles,
            chunk=cyc_chunk,
            log_callback=self._log_callback,
            convergence_metric=metric,
            # cycle-based plateau window, anchored at the validated N=192
            # V-cycle configuration (3 chunks x 50 cycles lands at the
            # smoothed-lid floor; see spectral.scaled_plateau_chunks)
            energy_plateau_chunks=scaled_plateau_chunks(
                int(self.params.nx), cyc_chunk,
                anchor_n=192, anchor_window=150),
        )
        self.state = result.state
        result = self._maybe_newton_polish(result)
        self._store_results(result)


class FMGSolver(SGSolver):
    """Full multigrid: FSG nested iteration with V-cycle solves per level."""

    NU1 = 2
    NU2 = 2
    NU_COARSE = 30
    SUPPORTS_SPATIAL_MESH = False

    _reject_singular = VMGSolver._reject_singular

    def solve(self, tolerance: float = None, max_iter: int = None) -> None:
        import time

        tol = self.params.tolerance if tolerance is None else tolerance
        max_iter = self.params.max_iterations if max_iter is None else max_iter
        if self._reject_singular():
            super().solve(tolerance=tol, max_iter=max_iter)
            return
        levels = build_vmg_levels(self.params)  # fine -> coarse
        coarse_to_fine = levels[::-1]
        log.info("FMG hierarchy: N = %s", [lv.n for lv in coarse_to_fine])
        _warn_if_degenerate(levels, self.params)

        t0 = time.time()
        total_iters = 0
        converged = False
        diverged = False
        state = None
        dtype = jnp.dtype(self.params.dtype)
        for k, level in enumerate(coarse_to_fine):
            sub_levels = levels[len(levels) - 1 - k:]  # this level down
            level_tol = tol * (self.params.coarse_tolerance_factor
                               ** (len(coarse_to_fine) - 1 - k))
            if state is None:
                state = core.initial_state(level.ops)
            else:
                prev = coarse_to_fine[k - 1]
                state = self._prolongate_fmg(prev, level, state, dtype)
            if len(sub_levels) > 1:
                step = make_v_cycle(
                    sub_levels, self.NU1, self.NU2, self.NU_COARSE)
                budget = max(1, max_iter // (self.NU1 + self.NU2))
            else:
                def step(s, _ops=level.ops):
                    return core.sg_step(_ops, s)
                budget = max_iter
            metric = resolve_convergence_metric(self.params,
                                                auto_large="rel_iter")
            if (str(getattr(self.params, "convergence_metric", "auto"))
                    == "auto"
                    and k == len(coarse_to_fine) - 1
                    and level.n >= VMG_AUTO_ENERGY_MIN_N):
                # finest level: per-cycle rel-iter exits prematurely at
                # N >= 256 (see VMGSolver.solve); coarser levels only feed
                # warm starts, where rel_iter is adequate (FSG cascade
                # semantics)
                metric = "energy"
            cyc_chunk = max(1, min(50, self.params.chunk_size // 4))
            result = run_fixed_point(
                step, lambda s: (s.u, s.v), state,
                tolerance=level_tol, max_iterations=budget,
                chunk=cyc_chunk,
                log_callback=self._log_callback
                if k == len(coarse_to_fine) - 1 else None,
                convergence_metric=metric,
                energy_plateau_chunks=scaled_plateau_chunks(
                    level.n, cyc_chunk, anchor_n=192, anchor_window=150)
                if len(sub_levels) > 1 else scaled_plateau_chunks(
                    level.n, cyc_chunk),
            )
            state = result.state
            total_iters += result.iterations
            converged = result.converged
            diverged = result.diverged
            log.info("FMG level %d (N=%d): %d outer iterations, converged=%s",
                     k, level.n, result.iterations, converged)
            if diverged:
                log.warning("FMG level %d (N=%d) diverged (NaN/Inf); aborting",
                            k, level.n)
                if level.n != int(self.params.nx):
                    # fine-grid-shaped NaN state (same finalization as
                    # FSGSolver.solve) so downstream analysis sees a
                    # well-formed diverged solution, not a shape mismatch
                    nf = int(self.params.nx) + 1
                    nan = float("nan")
                    state = core.SpectralState(
                        u=jnp.full((nf, nf), nan, dtype),
                        v=jnp.full((nf, nf), nan, dtype),
                        p=jnp.full((nf - 2, nf - 2), nan, dtype),
                    )
                break

        self.state = state
        wall = time.time() - t0
        # Real final algebraic residuals + quadrature integrals, matching
        # FSGSolver.solve's single-row history (reference spectral/fsg.py:96-124).
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
        result = IterationResult(state=state, iterations=total_iters,
                                 converged=bool(converged and not diverged),
                                 diverged=bool(diverged),
                                 wall_time=wall, history=history)
        result = self._maybe_newton_polish(result)  # sets self.state if on
        self._store_results(result)

    def _prolongate_fmg(self, coarse_level, fine_level, state, dtype):
        bx = make_basis(self.params.basis_type, (0.0, self.params.Lx))
        P_full, _ = make_level_transfer_matrices(
            bx.nodes(coarse_level.n + 1), bx.nodes(fine_level.n + 1),
            self.params.prolongation_method, self.params.restriction_method,
            chebyshev=str(self.params.basis_type).lower().startswith("cheb"))
        P_inner = nodal_interpolation_matrix(
            bx.nodes(coarse_level.n + 1)[1:-1], bx.nodes(fine_level.n + 1)[1:-1])
        Pf = jnp.asarray(P_full, dtype=dtype)
        Pi = jnp.asarray(P_inner, dtype=dtype)
        u = _mm(_mm(Pf, state.u), Pf.T)
        v = _mm(_mm(Pf, state.v), Pf.T)
        p = _mm(_mm(Pi, state.p), Pi.T)
        u, v = core.enforce_bc(fine_level.ops, u, v)
        return core.SpectralState(u=u, v=v, p=p)
