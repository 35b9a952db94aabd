"""Direct steady-state solver: Newton-Krylov with pseudo-transient continuation.

Solves the steady PN-PN-2 artificial-compressibility system F(x) = 0 directly
instead of marching pseudo-time to it. The reference has no steady solver --
its only route to steady state is the RK4/AC march (src/solvers/spectral/
sg.py:410-449), which rides the viscous timescale: O(Re) pseudo-time, measured
0.5-16M steps at Re >= 1000. PTC reaches the same (discrete) steady state in
tens of Newton steps, and -- because it never follows the unstable dynamics --
converges even past the cavity's Hopf bifurcation (Re ~ 8000), where marching
can only orbit the unstable steady solution Ghia et al. tabulate.

Formulation (backward Euler on dx/dtau = F, switched-evolution relaxation):

    (I/dt_k - J(x_k)) delta = F(x_k),    x_{k+1} = x_k + s * delta

with geometric dt ramping on full steps and a backtracking line search on
||F||. As dt -> inf this becomes exact Newton (quadratic tail). J*v is a
jax.jvp through the residual core (models/spectral_sg.residuals) -- exact,
FD-verified in tests, and automatically covers every corner treatment
including the sharp-lid singular subtraction.

The Jacobian's slow modes cluster near zero (they are the physical slow
dynamics), so unshifted Newton-GMRES stagnates; the 1/dt shift regularizes
exactly those modes. Right-preconditioned GMRES with a shifted-Stokes block
preconditioner then converges in tens of vectors per step:

    P = [ I/dt - nu*Lap     G    ]   velocity block: separable -> exact
        [ beta^2 * Div      I/dt ]   tensor-product eigendecomposition;
                                     pressure: Schur-complement BiCGSTAB.

Everything device-side is float64 (Newton to ||F||_rms <= 1e-6 needs it);
the Arnoldi basis lives on the host. At these sizes (N <= 256) the solve is
latency-dominated, not FLOP-dominated; the solver runs equally on CPU
(platform=cpu).
"""

from __future__ import annotations

import logging
import time
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp

from .params import SpectralParameters
from .runner import IterationResult
from .spectral import SGSolver
from . import spectral_sg as core

log = logging.getLogger(__name__)

__all__ = ["NewtonSolver", "ptc_solve", "polish_state"]

_HIGHEST = jax.lax.Precision.HIGHEST


def _mm(a, b):
    return jnp.matmul(a, b, precision=_HIGHEST)


class _SteadyProblem:
    """Flattened interior/inner unknown vector x and residual F for one grid.

    Unknowns are the interior velocity nodes plus the full inner pressure
    grid; the boundary data (ops.bc_u / ops.bc_v) is fixed and re-embedded
    on every residual evaluation, so F's Jacobian is exactly the interior
    linearization with Dirichlet rows eliminated.
    """

    def __init__(self, ops):
        self.ops = ops
        nf = int(ops.bc_u.shape[0])
        self.ni = nf - 2
        self.n_vel = self.ni * self.ni
        self.n_tot = 2 * self.n_vel + self.ni * self.ni
        self.F = jax.jit(self._residual_flat)
        self.jvp = jax.jit(
            lambda x, t: jax.jvp(self._residual_flat, (x,), (t,))[1])

    def unflatten(self, x):
        ni, nv = self.ni, self.n_vel
        return (x[:nv].reshape(ni, ni), x[nv:2 * nv].reshape(ni, ni),
                x[2 * nv:].reshape(ni, ni))

    def flatten(self, ui, vi, pp):
        return jnp.concatenate([ui.ravel(), vi.ravel(), pp.ravel()])

    def embed(self, ui, vi):
        u = self.ops.bc_u.at[1:-1, 1:-1].set(ui)
        v = self.ops.bc_v.at[1:-1, 1:-1].set(vi)
        return u, v

    def state_to_x(self, state: core.SpectralState):
        u, v = core.enforce_bc(self.ops, state.u, state.v)
        return self.flatten(u[1:-1, 1:-1], v[1:-1, 1:-1], state.p)

    def x_to_state(self, x) -> core.SpectralState:
        ui, vi, pp = self.unflatten(jnp.asarray(x))
        u, v = self.embed(ui, vi)
        return core.SpectralState(u=u, v=v, p=pp)

    def _residual_flat(self, x):
        ui, vi, pp = self.unflatten(x)
        u, v = self.embed(ui, vi)
        R_u, R_v, R_p = core.residuals(self.ops, u, v, pp)
        return self.flatten(R_u[1:-1, 1:-1], R_v[1:-1, 1:-1], R_p)


class _StokesPreconditioner:
    """Shifted-Stokes block preconditioner for the PTC systems.

    The velocity block H = I/dt - nu*Lap_interior is separable: one host
    eigendecomposition of the 1D interior Dirichlet second-derivative
    matrices turns every H-solve into four (ni x ni) matmuls. The pressure
    block is the AC Schur complement S = I/dt - beta^2 * Div H^{-1} Grad,
    solved iteratively (matrix-free BiCGSTAB) to a loose tolerance -- it
    only preconditions.
    """

    def __init__(self, problem: _SteadyProblem, grid: dict,
                 schur_iters: int = 40):
        ops = problem.ops
        self.problem = problem
        self.schur_iters = int(schur_iters)
        Dxx_i = np.asarray(grid["Dxx"], np.float64)[1:-1, 1:-1]
        Dyy_i = np.asarray(grid["Dyy"], np.float64)[1:-1, 1:-1]
        # Chebyshev interior Dirichlet operators have real negative spectra;
        # eig may return conjugate noise at the 1e-14 level -- take reals.
        lx, Vx = np.linalg.eig(Dxx_i)
        ly, Vy = np.linalg.eig(Dyy_i)
        self.LAM = jnp.asarray(np.real(lx)[:, None] + np.real(ly)[None, :])
        self.Vx = jnp.asarray(np.real(Vx))
        self.Vy = jnp.asarray(np.real(Vy))
        self.Vxi = jnp.asarray(np.linalg.inv(np.real(Vx)))
        self.Vyi = jnp.asarray(np.linalg.inv(np.real(Vy)))
        # interior-restricted gradient / divergence operators
        self.Gxr = ops.Gx[1:-1, :]
        self.IyTr = ops.IyT[:, 1:-1]
        self.Ixr = ops.Ix[1:-1, :]
        self.GyTr = ops.GyT[:, 1:-1]
        self.Dxi = ops.Dx[1:-1, 1:-1]
        self.DyTi = ops.DyT[1:-1, 1:-1]
        self.beta_sq = ops.beta_sq
        self.apply = jax.jit(self._apply)

    def inv_hlam(self, inv_dt):
        """Eigenvalues of H^{-1} for the current shift (recomputed per dt)."""
        return 1.0 / (inv_dt - self.problem.ops.nu * self.LAM)

    def _hsolve(self, f, inv_hlam):
        z = _mm(_mm(self.Vxi, f), self.Vyi.T) * inv_hlam
        return _mm(self.Vx, _mm(z, self.Vy.T))

    def _grad(self, pp):
        return _mm(_mm(self.Gxr, pp), self.IyTr), \
            _mm(_mm(self.Ixr, pp), self.GyTr)

    def _div(self, ui, vi):
        return _mm(self.Dxi, ui) + _mm(vi, self.DyTi)

    def _apply(self, r, inv_dt, inv_hlam):
        r_u, r_v, r_p = self.problem.unflatten(r)
        rhs = r_p - self.beta_sq * self._div(
            self._hsolve(r_u, inv_hlam), self._hsolve(r_v, inv_hlam))

        def s_apply(pp):
            gx, gy = self._grad(pp)
            return inv_dt * pp - self.beta_sq * self._div(
                self._hsolve(gx, inv_hlam), self._hsolve(gy, inv_hlam))

        dp, _ = jax.scipy.sparse.linalg.bicgstab(
            s_apply, rhs, tol=1e-8, maxiter=self.schur_iters)
        gx, gy = self._grad(dp)
        du = self._hsolve(r_u - gx, inv_hlam)
        dv = self._hsolve(r_v - gy, inv_hlam)
        return self.problem.flatten(du, dv, dp)


def _gmres(matvec, precond, rhs, k, tol):
    """Right-preconditioned GMRES(k), host-side Arnoldi.

    ``matvec(y) -> (I/dt - J) P^{-1} y`` runs fused on the device; the basis
    (n x k float64) lives on the host -- at N <= 256 it is < 100 MB and the
    dot products are trivial next to the device calls. Returns the
    UNpreconditioned update delta = P^{-1} (Q y*).
    """
    n = rhs.shape[0]
    Q = np.zeros((n, k + 1))
    H = np.zeros((k + 1, k))
    beta = float(np.linalg.norm(rhs))
    Q[:, 0] = rhs / beta
    used = k
    rel = 1.0
    for j in range(k):
        w = np.array(matvec(jnp.asarray(Q[:, j])))  # writable host copy
        if not np.all(np.isfinite(w)):
            # a diverged inner solve must not poison H (lstsq would raise)
            used = max(j, 1)
            break
        for i in range(j + 1):
            H[i, j] = w @ Q[:, i]
            w -= H[i, j] * Q[:, i]
        H[j + 1, j] = np.linalg.norm(w)
        if H[j + 1, j] < 1e-14:
            used = j + 1
            break
        Q[:, j + 1] = w / H[j + 1, j]
        if (j + 1) % 10 == 0 or j == k - 1:
            e1 = np.zeros(j + 2)
            e1[0] = beta
            yk, *_ = np.linalg.lstsq(H[:j + 2, :j + 1], e1, rcond=None)
            rel = np.linalg.norm(H[:j + 2, :j + 1] @ yk - e1) / beta
            if rel < tol:
                used = j + 1
                break
    e1 = np.zeros(used + 1)
    e1[0] = beta
    yk, *_ = np.linalg.lstsq(H[:used + 1, :used], e1, rcond=None)
    rel = float(np.linalg.norm(H[:used + 1, :used] @ yk - e1) / beta)
    delta = np.asarray(precond(jnp.asarray(Q[:, :used] @ yk)))
    return delta, rel, used


def ptc_solve(problem: _SteadyProblem, precond: _StokesPreconditioner,
              x0: np.ndarray, *, tol_rms: float, max_steps: int,
              gmres_vectors: int, dt0: float, dt_max: float,
              history: dict | None = None, conserved=None):
    """Run the PTC loop from x0. Returns (x, converged, diverged, steps).

    ``history``: optional dict of lists receiving one row per Newton step
    (rel_iter / u_eq / v_eq / continuity / energy / enstrophy /
    palinstrophy -- the runner's history contract). ``conserved(x)`` maps an
    unknown vector to the three conserved quantities.

    The line search is NONMONOTONE (Grippo-style: accept when ||F|| beats
    the worst of the last 5 accepted values): a pseudo-time trajectory is
    not a descent path for ||F||, and near unstable steady states (e.g. the
    cavity past its Hopf point) it must climb transiently -- a monotone
    search deadlocks there (measured: Re=10000 N=256 stalls with every dt
    down to 1e-12 rejected). If even that fails, the dt-floor escape takes
    one damped physical marching step and re-ramps.
    """
    from collections import deque

    x = np.asarray(x0, np.float64)
    rms = 1.0 / np.sqrt(problem.n_tot)
    nF_window = deque(maxlen=5)  # nonmonotone reference values

    @jax.jit
    def matvec_fused(x_dev, y, inv_dt, inv_hlam):
        z = precond._apply(y, inv_dt, inv_hlam)
        return z * inv_dt - problem.jvp(x_dev, z)

    Fk = np.asarray(problem.F(jnp.asarray(x)))
    nF = float(np.linalg.norm(Fk))
    nF_window.append(nF)
    dt = float(dt0)
    dt_floor = 1e-4 * float(dt0)
    converged = diverged = False
    steps = 0
    for k in range(max_steps):
        if not np.isfinite(nF):
            diverged = True
            break
        if nF * rms <= tol_rms:
            converged = True
            break
        inv_dt = jnp.float64(1.0 / dt)
        inv_hlam = precond.inv_hlam(inv_dt)
        x_dev = jnp.asarray(x)
        delta, rel, used = _gmres(
            lambda y: matvec_fused(x_dev, y, inv_dt, inv_hlam),
            lambda y: precond.apply(y, inv_dt, inv_hlam),
            Fk, gmres_vectors, tol=1e-4)
        nF_ref = max(nF_window)
        step_len = 1.0
        for _ in range(8):
            x_try = x + step_len * delta
            F_try = np.asarray(problem.F(jnp.asarray(x_try)))
            nF_try = float(np.linalg.norm(F_try))
            if np.isfinite(nF_try) and nF_try < nF_ref:
                break
            step_len *= 0.5
        else:
            if dt <= dt_floor and np.isfinite(nF_try):
                # dt-floor escape: one damped physical marching step
                # (backward Euler at tiny dt IS the flow), then re-ramp
                log.info("PTC step %d: nonmonotone escape at dt floor "
                         "(||F|| %.3e -> %.3e)", k, nF, nF_try)
                dt = float(dt0)
            else:
                dt = max(dt * 0.2, dt_floor)
                log.info("PTC step %d: line search failed; dt -> %.2e",
                         k, dt)
                continue
        # only ACCEPTED steps count (and emit a history row), so
        # len(history) == steps always holds
        steps += 1
        dx_rel = float(np.linalg.norm(step_len * delta) /
                       max(np.linalg.norm(x), 1e-300))
        x, Fk, nF = x_try, F_try, nF_try
        nF_window.append(nF)
        if history is not None:
            r_u, r_v, r_p = problem.unflatten(jnp.asarray(Fk))
            history["rel_iter"].append(dx_rel)
            history["u_eq"].append(float(jnp.linalg.norm(r_u)))
            history["v_eq"].append(float(jnp.linalg.norm(r_v)))
            history["continuity"].append(float(jnp.linalg.norm(r_p)))
            if conserved is not None:
                e, z, pal = conserved(x)
                history["energy"].append(e)
                history["enstrophy"].append(z)
                history["palinstrophy"].append(pal)
        log.info("PTC %d: ||F||_rms %.3e dt %.2e gmres(rel %.1e, %d vec) "
                 "step %g", k, nF * rms, dt, rel, used, step_len)
        # switched-evolution relaxation: geometric ramp on full steps
        dt = min(dt * 3.0, dt_max) if step_len == 1.0 else dt * 0.5
    if nF * rms <= tol_rms:
        converged = True
    return x, converged, diverged, steps


def polish_state(params, state: core.SpectralState, *, tol_rms: float,
                 max_steps: int, gmres_vectors: int, history: dict | None
                 = None):
    """Float64 Newton polish of a (possibly float32) marched state.

    Marched float32 solves stop at their float32 criterion floors; a few
    PTC steps from their final state land on the EXACT discrete steady
    state. Returns ``(state64, converged, diverged, steps, final_rms)``.
    The start is already near-steady, so dt0 = 1.0 (SER ramps from there).

    Enables ``jax_enable_x64`` process-wide and leaves it on (same policy
    as every float64 solver, models/base.py): restoring it would downcast the
    returned f64 state in later traced analysis ops, and every float32
    solver path is TESTED under x64=on (tests/conftest.py enables it
    globally), so late enabling is safe for mixed sweeps.
    """
    jax.config.update("jax_enable_x64", True)
    ops, grid = core.build_spectral_ops(params, dtype=jnp.float64)
    problem = _SteadyProblem(ops)
    precond = _StokesPreconditioner(
        problem, grid, schur_iters=int(params.newton_schur_iters))
    st = core.SpectralState(
        u=jnp.asarray(np.asarray(state.u), jnp.float64),
        v=jnp.asarray(np.asarray(state.v), jnp.float64),
        p=jnp.asarray(np.asarray(state.p), jnp.float64))
    x0 = np.asarray(problem.state_to_x(st), np.float64)

    def conserved(x):
        s = problem.x_to_state(x)
        e, z, pal = core.conserved_quantities(ops, s.u, s.v)
        return float(e), float(z), float(pal)

    x, converged, diverged, steps = ptc_solve(
        problem, precond, x0, tol_rms=tol_rms, max_steps=max_steps,
        gmres_vectors=gmres_vectors, dt0=1.0,
        dt_max=float(params.newton_dt_max), history=history,
        conserved=conserved if history is not None else None)
    final_rms = float(np.linalg.norm(np.asarray(problem.F(jnp.asarray(x))))
                      / np.sqrt(problem.n_tot))
    return problem.x_to_state(x), converged, diverged, steps, final_rms


class NewtonSolver(SGSolver):
    """Steady-state spectral solver (PTC Newton-GMRES).

    Drop-in for SGSolver/FSGSolver in the harness: same Metrics/TimeSeries/
    Fields contract, every corner treatment (including ``singular``), any
    Chebyshev grid size. ``tolerance`` is reinterpreted as the RMS norm of
    the STEADY residual F (momentum + beta^2-scaled continuity) -- an
    absolute statement about the discrete steady state, much stronger than
    the marched solvers' iterate-change criterion at the same value.

    Cold starts work at moderate Re (the early small-dt PTC steps follow
    pseudo-time physically); at high Re warm-start via ``newton_prelude``
    marched RK4 steps or ``initial_state_path`` (npz with u, v, p -- e.g. a
    previous run's state for Re-continuation).

    Measured (f64, sharp lid singular mode): Re=1000 N=128 COLD converges
    in 18 steps / 330 s on the 1-core CPU host (warm-started: 11 steps /
    115 s) -- the march needs ~0.9M RK4 steps for a weaker criterion. The
    exact state reproduces Botella & Peyret's N=160 benchmark to 0.003%
    (psi_min -0.118909 vs -0.1189366, omega 2.067697 vs 2.067753).
    Re-continuation ladder 1000 -> 3200 -> 5000 -> 7500 -> 10000 in 15-30
    steps per stage. Ghia centerline errors at the
    exact steady states are IDENTICAL at N=128 and N=256 (u 0.018-0.033, v
    0.049/0.109/0.139 at Re=3200/5000/7500), so the remaining v gap at the
    1-3 near-wall jet points is Ghia's own 257^2-grid error, not ours.
    Fixtures: data/steady/sharp_Re*_N128.npz.
    """

    Parameters = SpectralParameters
    SUPPORTS_SPATIAL_MESH = False

    def __init__(self, params=None, **kwargs):
        # Newton to ||F||_rms ~ 1e-6..1e-12 requires float64 end-to-end.
        jax.config.update("jax_enable_x64", True)
        if params is not None:
            params.dtype = "float64"
        else:
            if str(kwargs.get("dtype", "auto")).lower() != "float64":
                kwargs["dtype"] = "float64"
        super().__init__(params=params, **kwargs)

    def solve(self, tolerance: float = None, max_iter: int = None) -> None:
        p = self.params
        tol = p.tolerance if tolerance is None else tolerance
        t0 = time.time()
        problem = _SteadyProblem(self.ops)
        precond = _StokesPreconditioner(problem, self.grid,
                                        schur_iters=p.newton_schur_iters)

        state = self._initial_newton_state()
        if p.newton_prelude > 0:
            state = self._march_prelude(state, int(p.newton_prelude))
        x0 = np.asarray(problem.state_to_x(state), np.float64)

        # FD sanity of the linearization once per solve (catches a silently
        # wrong custom-op vjp/jvp before 40 GMRES cycles trust it)
        rng = np.random.default_rng(0)
        t = rng.standard_normal(problem.n_tot) * 1e-7
        fd = (np.asarray(problem.F(jnp.asarray(x0 + t))) -
              np.asarray(problem.F(jnp.asarray(x0 - t)))) / 2.0
        an = np.asarray(problem.jvp(jnp.asarray(x0), jnp.asarray(t)))
        jvp_rel = float(np.linalg.norm(fd - an) /
                        max(np.linalg.norm(an), 1e-300))
        if jvp_rel > 1e-5:
            log.warning("Jacobian-vector FD check poor: rel %.2e", jvp_rel)

        def conserved(x):
            st = problem.x_to_state(x)
            e, z, pal = core.conserved_quantities(self.ops, st.u, st.v)
            return float(e), float(z), float(pal)

        history = {k: [] for k in ("rel_iter", "u_eq", "v_eq", "continuity",
                                   "energy", "enstrophy", "palinstrophy")}
        x, converged, diverged, steps = ptc_solve(
            problem, precond, x0,
            tol_rms=tol, max_steps=int(p.newton_max_steps),
            gmres_vectors=int(p.gmres_vectors),
            dt0=float(p.newton_dt0), dt_max=float(p.newton_dt_max),
            history=history, conserved=conserved)

        self.state = problem.x_to_state(x)
        if not history["rel_iter"]:  # converged before the first step
            r_u, r_v, r_p = problem.unflatten(problem.F(jnp.asarray(x)))
            e, z, pal = conserved(x)
            history["rel_iter"].append(0.0)
            history["u_eq"].append(float(jnp.linalg.norm(r_u)))
            history["v_eq"].append(float(jnp.linalg.norm(r_v)))
            history["continuity"].append(float(jnp.linalg.norm(r_p)))
            history["energy"].append(e)
            history["enstrophy"].append(z)
            history["palinstrophy"].append(pal)
        result = IterationResult(
            state=self.state, iterations=steps, converged=bool(converged),
            diverged=bool(diverged), wall_time=time.time() - t0,
            history=history)
        self._store_results(result)
        log.info("Newton steady solve: %d PTC steps, converged=%s (%.2fs)",
                 steps, converged, result.wall_time)

    # -- warm starts -----------------------------------------------------

    def _initial_newton_state(self) -> core.SpectralState:
        path = str(getattr(self.params, "initial_state_path", "") or "")
        if not path:
            return self.state
        d = np.load(Path(path))
        nf = int(self.ops.bc_u.shape[0])
        shapes = {"u": (nf, nf), "v": (nf, nf), "p": (nf - 2, nf - 2)}
        for key, want in shapes.items():
            if d[key].shape != want:
                raise ValueError(
                    f"initial_state_path field '{key}' has shape "
                    f"{d[key].shape}, does not match {want} for N={nf - 1}; "
                    f"prolongate/restrict it first ({path})")
        log.info("Newton warm start from %s", path)
        return core.SpectralState(
            u=jnp.asarray(d["u"], jnp.float64),
            v=jnp.asarray(d["v"], jnp.float64),
            p=jnp.asarray(d["p"], jnp.float64))

    def _march_prelude(self, state, n_steps: int) -> core.SpectralState:
        """A short RK4/AC march to pass the impulsive-start transient."""
        log.info("Newton prelude: %d marched RK4 steps", n_steps)
        ops = self.ops

        @jax.jit
        def run(s):
            return jax.lax.fori_loop(
                0, jnp.int32(n_steps),
                lambda _, st: core.sg_step(ops, st)[0], s)

        return run(state)
