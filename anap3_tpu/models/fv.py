"""Collocated FV-SIMPLE solver on a structured Cartesian grid.

JAX redesign of the reference FV stack (src/solvers/fv/solver.py +
assembly/discretization/core kernels):

- the unstructured face-list mesh (``MeshData2D`` jitclass) is replaced by
  implicit structured indexing: every face loop is a fused shifted-array
  stencil (ops/fv_stencils.py);
- the momentum systems are solved MATRIX-FREE with Jacobi-preconditioned
  BiCGSTAB (jax.scipy.sparse.linalg) instead of assembling CSR matrices for
  scipy+PyAMG per iteration;
- the pressure-correction system — a constant conductance Laplacian
  (fv/solver.py:91-107) — is solved EXACTLY by the precomputed tensor-product
  eigendecomposition (ops/poisson.fv_neumann_pressure_poisson), replacing
  AMG-preconditioned BiCGSTAB with four matmuls; the gauge matches the
  reference's cell-0 pinning;
- one SIMPLE iteration is a single jitted function over the (u, v, p, mx, my)
  pytree, so N/Re sweeps vmap across lanes.

SIMPLE sequence per step (fv/solver.py:170-257): pressure gradient + face
interpolation; limited velocity gradients; u/v momentum predictors with
Patankar under-relaxation (helpers.py:5-23); bold_D from the unrelaxed
diagonal; Rhie-Chow face velocities; mdot*; pressure correction; velocity and
pressure corrections (alpha_p applied); mdot update. Residuals are
||u'||, ||v'||, ||div(mdot)|| (fv/solver.py:259-275).
"""

from __future__ import annotations

import logging

from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp

from .base import CavitySolver
from .params import Fields, FVParameters
from .runner import run_fixed_point
from ..ops import fv_stencils as st
from ..ops.corner import lid_profile
from ..ops.poisson import fd_dirichlet_poisson, fv_neumann_pressure_poisson

log = logging.getLogger(__name__)

__all__ = ["FVSolver", "FVState", "fv_step", "build_fv_ops"]


class FVState(NamedTuple):
    u: jnp.ndarray    # (ny, nx) cell-centered
    v: jnp.ndarray
    p: jnp.ndarray
    mx: jnp.ndarray   # (ny, nx-1) internal x-face mass flux
    my: jnp.ndarray   # (ny-1, nx) internal y-face mass flux


class FVOps(NamedTuple):
    """Static per-solve data (pytree of arrays/scalars; vmap-friendly)."""

    mu: jnp.ndarray
    rho: jnp.ndarray
    dx: float
    dy: float
    alpha_uv: float
    alpha_p: float
    lin_tol: float
    lid_velocity: jnp.ndarray
    bc_u_n: jnp.ndarray  # lid profile at top-face centers (nx,)
    zeros_x: jnp.ndarray  # (ny,) zero BC rows kept as arrays for vmap lanes
    zeros_y: jnp.ndarray  # (nx,)
    scheme: str
    limiter: str | None
    rhie_chow: str
    poisson: object      # SeparablePoisson for p'
    n_refine: int        # iterative-refinement steps on the pressure solve


jax.tree_util.register_pytree_node(
    FVOps,
    lambda o: ((o.mu, o.rho, o.lid_velocity, o.bc_u_n, o.zeros_x, o.zeros_y,
                o.poisson),
               (o.dx, o.dy, o.alpha_uv, o.alpha_p, o.lin_tol, o.scheme,
                o.limiter, o.rhie_chow, o.n_refine)),
    lambda aux, ch: FVOps(
        mu=ch[0], rho=ch[1], dx=aux[0], dy=aux[1], alpha_uv=aux[2],
        alpha_p=aux[3], lin_tol=aux[4], lid_velocity=ch[2], bc_u_n=ch[3],
        zeros_x=ch[4], zeros_y=ch[5], scheme=aux[5], limiter=aux[6],
        rhie_chow=aux[7], poisson=ch[6], n_refine=aux[8]),
)


def build_fv_ops(params: FVParameters, dtype=None) -> tuple[FVOps, dict]:
    dtype = jnp.dtype(params.dtype) if dtype is None else jnp.dtype(dtype)
    nx, ny = int(params.nx), int(params.ny)
    dx, dy = params.Lx / nx, params.Ly / ny
    rho = 1.0
    mu = rho * params.lid_velocity * params.Lx / params.Re

    x_centers = (np.arange(nx) + 0.5) * dx
    y_centers = (np.arange(ny) + 0.5) * dy
    # lid BC evaluated at TOP-FACE centers (same x as cell centers), with the
    # corner treatment baked in at mesh build (simple_structured.py:249-268)
    bc_u_n = lid_profile(x_centers, method=params.corner_treatment,
                         smoothing_width=params.corner_smoothing,
                         lid_velocity=params.lid_velocity, Lx=params.Lx)

    limiter = params.limiter if params.limiter not in ("none", "None", "") else None
    # float32 mode: the configured 1e-9 linear
    # tolerance is below f32 resolution — BiCGSTAB would spin to maxiter
    # every outer iteration. Clamp to ~10 ulp relative; SIMPLE's outer
    # iteration absorbs the slack (the divergence is recomputed from actual
    # fluxes each step, so an inexact inner solve only costs iterations,
    # never biases the converged solution). The pressure solve compensates
    # with one step of iterative refinement instead.
    eps = float(jnp.finfo(dtype).eps)
    lin_tol = max(float(params.linear_solver_tol), 10.0 * eps)
    n_refine = 1 if dtype == jnp.float32 else 0
    ops = FVOps(
        mu=jnp.asarray(mu, dtype), rho=jnp.asarray(rho, dtype),
        dx=float(dx), dy=float(dy),
        alpha_uv=float(params.alpha_uv), alpha_p=float(params.alpha_p),
        lin_tol=lin_tol,
        lid_velocity=jnp.asarray(params.lid_velocity, dtype),
        bc_u_n=jnp.asarray(bc_u_n, dtype),
        zeros_x=jnp.zeros(ny, dtype), zeros_y=jnp.zeros(nx, dtype),
        scheme=str(params.convection_scheme),
        limiter=limiter,
        rhie_chow=str(params.rhie_chow),
        poisson=fv_neumann_pressure_poisson(nx, ny, dx, dy, rho, dtype=dtype),
        n_refine=n_refine,
    )
    grid = {
        "nx": nx, "ny": ny, "dx": dx, "dy": dy,
        "x_centers": x_centers, "y_centers": y_centers, "mu": mu, "rho": rho,
    }
    return ops, grid


def _solve_momentum(ops: FVOps, coeffs: st.MomentumCoeffs, rhs, phi_prev):
    """Patankar-relaxed BiCGSTAB solve; returns (phi_star, unrelaxed_diag)."""
    alpha = ops.alpha_uv
    aP_rel = coeffs.aP / alpha
    rhs_rel = rhs + ((1.0 - alpha) / alpha) * coeffs.aP * phi_prev

    def A(phi):
        return st.apply_momentum_operator(coeffs, phi, aP_override=aP_rel)

    def M(phi):  # Jacobi preconditioner
        return phi / aP_rel

    phi_star, _ = jax.scipy.sparse.linalg.bicgstab(
        A, rhs_rel, x0=phi_prev, tol=ops.lin_tol, maxiter=1000, M=M
    )
    return phi_star, coeffs.aP


def _solve_momentum_uv(ops: FVOps, coeffs: st.MomentumCoeffs, rhs_u, rhs_v,
                       u_prev, v_prev):
    """Joint u/v momentum solve: ONE BiCGSTAB over the stacked (2, ny, nx)
    system.

    The u and v momentum matrices are IDENTICAL on the cavity (same face
    fluxes and conductances; only the boundary source b differs —
    convection_diffusion_matrix.py builds one stencil per component from the
    same mdot), so both predictors solve A x = b with a block-diagonal A of
    two equal blocks. One Krylov space over the stacked operator halves the
    number of inner while_loop solves per SIMPLE iteration.
    """
    alpha = ops.alpha_uv
    aP_rel = coeffs.aP / alpha
    scale = (1.0 - alpha) / alpha
    rhs = jnp.stack([rhs_u + scale * coeffs.aP * u_prev,
                     rhs_v + scale * coeffs.aP * v_prev])

    def A(phi):
        return jax.vmap(lambda f: st.apply_momentum_operator(
            coeffs, f, aP_override=aP_rel))(phi)

    def M(phi):
        return phi / aP_rel

    x, _ = jax.scipy.sparse.linalg.bicgstab(
        A, rhs, x0=jnp.stack([u_prev, v_prev]), tol=ops.lin_tol,
        maxiter=1000, M=M)
    return x[0], x[1], coeffs.aP


def fv_step(ops: FVOps, state: FVState):
    """One SIMPLE iteration. Returns (new_state, metrics)."""
    u, v, p, mx, my = state
    dx, dy = ops.dx, ops.dy
    vol = dx * dy

    # pressure gradient (unlimited) — fv/solver.py:184-188. The reference
    # also computes Barth-Jespersen-limited VELOCITY gradients here
    # (fv/solver.py:191-196), but they feed only its least-squares TVD
    # machinery; our deferred correction (ops/fv_stencils.py) reads the true
    # neighbor values directly, so those gradients would be dead code.
    gpx, gpy = st.cell_gradient(p, dx, dy, use_limiter=False)

    # momentum predictors: u and v share the SAME stencil (only the boundary
    # source b differs), so both ride one joint BiCGSTAB solve
    cu = st.momentum_coefficients(mx, my, ops.mu, dx, dy,
                                  ops.zeros_x, ops.zeros_x,
                                  ops.zeros_y, ops.bc_u_n)
    cv = st.momentum_coefficients(mx, my, ops.mu, dx, dy,
                                  ops.zeros_x, ops.zeros_x,
                                  ops.zeros_y, ops.zeros_y)
    b_u = cu.b + st.deferred_correction(u, mx, my, ops.scheme, ops.limiter)
    b_v = cv.b + st.deferred_correction(v, mx, my, ops.scheme, ops.limiter)
    rhs_u = b_u - gpx * vol
    rhs_v = b_v - gpy * vol
    u_star, v_star, aP_uv = _solve_momentum_uv(ops, cu, rhs_u, rhs_v, u, v)

    # bold_D from the UNRELAXED diagonal (fv/solver.py:150-168, helpers.py:139-152)
    Du = vol / (aP_uv + 1e-14)
    Dv = Du

    # Rhie-Chow face velocities -> mdot* (rhie_chow.py:5-159)
    ubar_x = st.face_average_x(u_star)
    vbar_y = st.face_average_y(v_star)
    if ops.rhie_chow == "compact":
        dpdx_face = (p[:, 1:] - p[:, :-1]) / dx
        dpdy_face = (p[1:, :] - p[:-1, :]) / dy
        corr_x = st.face_average_x(Du) * (dpdx_face - st.face_average_x(gpx))
        corr_y = st.face_average_y(Dv) * (dpdy_face - st.face_average_y(gpy))
        Uf_x = ubar_x - corr_x
        Uf_y = vbar_y - corr_y
    else:  # "averaged": reference formulation; the correction cancels exactly
        Uf_x = ubar_x
        Uf_y = vbar_y
    mx_star = ops.rho * Uf_x * dy
    my_star = ops.rho * Uf_y * dx

    # pressure correction: direct tensor solve of the conductance Laplacian
    rhs_p = -st.divergence_from_fluxes(mx_star, my_star)
    rhs_p = rhs_p - jnp.mean(rhs_p)      # project out roundoff inconsistency
    p_prime = ops.poisson.solve_refined(rhs_p, ops.n_refine)
    p_prime = p_prime - p_prime[0, 0]    # gauge = reference's cell-0 pinning

    # corrections (corrections.py:5-24)
    gppx, gppy = st.cell_gradient(p_prime, dx, dy, use_limiter=False)
    u_prime = -Du * gppx
    v_prime = -Dv * gppy
    u_new = u_star + u_prime
    v_new = v_star + v_prime
    p_new = p + ops.alpha_p * p_prime

    # mdot update with face-interpolated corrections (helpers.py:26-58)
    mx_new = mx_star + ops.rho * st.face_average_x(u_prime) * dy
    my_new = my_star + ops.rho * st.face_average_y(v_prime) * dx

    new_state = FVState(u=u_new, v=v_new, p=p_new, mx=mx_new, my=my_new)

    mass_imbalance = st.divergence_from_fluxes(mx_new, my_new)
    metrics = {
        "u_eq": jnp.linalg.norm(u_prime),
        "v_eq": jnp.linalg.norm(v_prime),
        "continuity": jnp.linalg.norm(mass_imbalance),
    }
    metrics.update(_conserved_quantities(ops, u_new, v_new, dx, dy))
    return new_state, metrics


# ---------------------------------------------------------------------------
# FD conserved quantities with Dirichlet ghost cells (base.py:359-448)
# ---------------------------------------------------------------------------


def _ghost_pad(f, bc_w, bc_e, bc_s, bc_n):
    """Pad with ghost = 2*bc - interior; corners average adjacent ghosts."""
    ny, nx = f.shape
    g = jnp.zeros((ny + 2, nx + 2), f.dtype)
    g = g.at[1:-1, 1:-1].set(f)
    g = g.at[0, 1:-1].set(2.0 * bc_s - f[0, :])
    g = g.at[-1, 1:-1].set(2.0 * bc_n - f[-1, :])
    g = g.at[1:-1, 0].set(2.0 * bc_w - f[:, 0])
    g = g.at[1:-1, -1].set(2.0 * bc_e - f[:, -1])
    g = g.at[0, 0].set(0.5 * (g[0, 1] + g[1, 0]))
    g = g.at[0, -1].set(0.5 * (g[0, -2] + g[1, -1]))
    g = g.at[-1, 0].set(0.5 * (g[-1, 1] + g[-2, 0]))
    g = g.at[-1, -1].set(0.5 * (g[-1, -2] + g[-2, -1]))
    return g


def _fd_gradient(f, dx, dy, bc=0.0, bc_lid=None):
    bc_lid = bc if bc_lid is None else bc_lid
    z = jnp.zeros(f.shape[1], f.dtype)
    zx = jnp.zeros(f.shape[0], f.dtype)
    g = _ghost_pad(f, zx + bc, zx + bc, z + bc, z + bc_lid)
    dfdx = (g[1:-1, 2:] - g[1:-1, :-2]) / (2.0 * dx)
    dfdy = (g[2:, 1:-1] - g[:-2, 1:-1]) / (2.0 * dy)
    return dfdx, dfdy


def fd_vorticity(u, v, dx, dy, lid_velocity):
    """omega = dv/dx - du/dy with cavity ghost BCs (base.py:432-448).

    Note the reference uses the CONSTANT lid velocity for the u-ghost at the
    lid regardless of corner treatment; reproduced here.
    """
    dvdx, _ = _fd_gradient(v, dx, dy, bc=0.0, bc_lid=0.0)
    _, dudy = _fd_gradient(u, dx, dy, bc=0.0, bc_lid=lid_velocity)
    return dvdx - dudy


def _conserved_quantities(ops, u, v, dx, dy):
    dA = dx * dy
    energy = 0.5 * jnp.sum(u * u + v * v) * dA
    omega = fd_vorticity(u, v, dx, dy, ops.lid_velocity)
    enstrophy = 0.5 * jnp.sum(omega * omega) * dA
    dwx, dwy = _fd_gradient(omega, dx, dy, bc=0.0)
    palinstrophy = 0.5 * jnp.sum(dwx * dwx + dwy * dwy) * dA
    return {"energy": energy, "enstrophy": enstrophy, "palinstrophy": palinstrophy}


# ---------------------------------------------------------------------------
# Solver class
# ---------------------------------------------------------------------------


class FVSolver(CavitySolver):
    """Finite-volume SIMPLE solver (reference fv/solver.py)."""

    Parameters = FVParameters
    rho = 1.0

    def __init__(self, params=None, **kwargs):
        super().__init__(params=params, **kwargs)
        self.ops, self.grid = build_fv_ops(self.params)
        ny, nx = self.params.ny, self.params.nx
        dt = jnp.dtype(self.params.dtype)
        self.state = FVState(
            u=jnp.zeros((ny, nx), dt), v=jnp.zeros((ny, nx), dt),
            p=jnp.zeros((ny, nx), dt),
            mx=jnp.zeros((ny, nx - 1), dt), my=jnp.zeros((ny - 1, nx), dt),
        )
        self._check_state_dtype(self.state)
        self._psi_poisson = None

    def solve(self, tolerance: float = None, max_iter: int = None) -> None:
        tol = self.params.tolerance if tolerance is None else tolerance
        max_iter = self.params.max_iterations if max_iter is None else max_iter
        ops = self.ops
        # "auto" resolves to rel_iter for FV at every size: SIMPLE's
        # under-relaxed fixed point has no measured false-convergence mode
        # (f64 N=128 runs land 0.13-0.20% L2 from the stored truths).
        from .spectral import resolve_convergence_metric

        metric = resolve_convergence_metric(self.params,
                                            auto_large="rel_iter")

        def step(state):
            return fv_step(ops, state)

        ckpt_mgr, start_iter = None, 0
        if self.params.checkpoint_dir:
            from ..utils.checkpoint import CheckpointManager

            ckpt_mgr = CheckpointManager(
                self.params.checkpoint_dir, self.params,
                every_chunks=self.params.checkpoint_every_chunks)
            self.state, start_iter = ckpt_mgr.restore_or(self.state)
            if start_iter:
                log.info("Resumed from checkpoint at iteration %d", start_iter)

        stall = int(self.params.stall_chunks)
        if stall < 0:  # auto: f32's criterion can floor above tolerance
            stall = 25 if self.params.dtype == "float32" else 0

        result = run_fixed_point(
            step, lambda s: (s.u, s.v), self.state,
            tolerance=tol, max_iterations=max_iter,
            chunk=self.params.chunk_size,
            log_callback=self._log_callback,
            checkpoint_mgr=ckpt_mgr,
            start_iteration=start_iter,
            convergence_metric=metric,
            stall_chunks=stall,
        )
        if result.stalled:
            log.warning(
                "Convergence stalled at %s=%.3e (> tol %.1e): float32 noise "
                "floor reached after %d iterations; stopping with the best "
                "attainable state.", metric,
                result.history["rel_iter"][-1] if result.history.get("rel_iter")
                else float("nan"), tol, result.iterations)
        self.state = result.state
        self._store_results(result)

    # -- field plumbing --------------------------------------------------

    def _final_fields(self) -> Fields:
        X, Y = np.meshgrid(self.grid["x_centers"], self.grid["y_centers"])
        return Fields(
            u=np.asarray(self.state.u, float).ravel(),
            v=np.asarray(self.state.v, float).ravel(),
            p=np.asarray(self.state.p, float).ravel(),
            x=X.ravel(), y=Y.ravel(),
        )

    def _vorticity_full(self) -> np.ndarray:
        return np.asarray(
            fd_vorticity(self.state.u, self.state.v, self.grid["dx"],
                         self.grid["dy"], self.ops.lid_velocity)
        )

    def _streamfunction(self):
        ny, nx = self.params.ny, self.params.nx
        if self._psi_poisson is None:
            self._psi_poisson = fd_dirichlet_poisson(
                ny - 2, nx - 2, self.grid["dy"], self.grid["dx"],
                dtype=jnp.dtype(self.params.dtype),
            )
        from ..analysis.vortex import solve_streamfunction

        omega = self._vorticity_full()
        psi = solve_streamfunction(self._psi_poisson, omega)
        X, Y = np.meshgrid(self.grid["x_centers"], self.grid["y_centers"])
        return psi, X, Y
