"""Single-grid PN-PN-2 pseudospectral artificial-compressibility solver.

Accelerator redesign of the reference SG solver (src/solvers/spectral/sg.py):

- all per-iteration work is a handful of dense (N+1)x(N+1) matmuls executed
  inside one jitted RK4 step (the reference runs numpy matmuls per
  stage from Python);
- the inner->full pressure interpolation and differentiation are FUSED into
  precomputed operators: dp/dx = (Dx@Ix) p Iy^T, dp/dy = Ix p (Dy@Iy)^T,
  halving the matmul count of sg.py:255-276;
- boundary conditions are a single masked select against precomputed boundary
  arrays (the reference re-evaluates corner-treatment handlers per stage,
  sg.py:348-385);
- the state is a pytree, so sweeps vmap over (Re, corner profile, ...) lanes
  for free.

Numerical semantics carried over exactly:
- grids: velocities on the full (N+1)^2 Gauss-Lobatto grid, pressure on the
  (N-1)^2 inner grid (sg.py:103-119);
- residuals R_u = -(u·∇)u - ∇p + ν∇²u, R_p = -β² div(u) on the inner grid
  (sg.py:278-346);
- adaptive CFL timestep λ = (|u|+sqrt(u²+β²))/dx + ν/dx² (sg.py:387-408);
- 4-stage low-storage RK with α = [1/4, 1/3, 1/2, 1], BCs re-enforced after
  every stage (sg.py:410-449);
- wall order west/east/south then lid last, so top corners take the
  (corner-treated, zero-at-corner) lid value (sg.py:348-385).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Tuple

import numpy as np
import jax
import jax.numpy as jnp

from ..ops import basis as basis_ops
from ..ops.corner import lid_profile
from .params import SpectralParameters

__all__ = ["SpectralOps", "SpectralState", "build_spectral_ops", "sg_step",
           "initial_state", "conserved_quantities"]

_HIGHEST = jax.lax.Precision.HIGHEST


def _mm(a, b):
    return jnp.matmul(a, b, precision=_HIGHEST)


class SpectralState(NamedTuple):
    """Device state: u, v on the full grid; p on the inner grid."""

    u: jnp.ndarray  # (N+1, N+1)
    v: jnp.ndarray  # (N+1, N+1)
    p: jnp.ndarray  # (N-1, N-1)


@jax.tree_util.register_pytree_node_class
@dataclass
class SpectralOps:
    """Precomputed device operators for one grid size.

    Built once on the host in float64, cast to the working dtype. Every leaf
    is a jnp array so the container vmaps/shards like any pytree (e.g. mapping
    over ``bc_u``/``nu`` lanes in a sweep while broadcasting the matrices).
    """

    Dx: jnp.ndarray        # (nf, nf) d/dx, applied on the left
    DyT: jnp.ndarray       # (nf, nf) d/dy transposed, applied on the right
    Dxx: jnp.ndarray       # (nf, nf)
    DyyT: jnp.ndarray      # (nf, nf)
    Ix: jnp.ndarray        # (nf, ni) inner->full interpolation in x
    IyT: jnp.ndarray       # (ni, nf) inner->full interpolation in y, transposed
    Gx: jnp.ndarray        # (nf, ni) = Dx @ Ix  (fused pressure-gradient x)
    GyT: jnp.ndarray       # (ni, nf) = (Dy @ Iy)^T (fused pressure-gradient y)
    bc_u: jnp.ndarray      # (nf, nf) boundary values for u (0 interior)
    bc_v: jnp.ndarray      # (nf, nf)
    interior: jnp.ndarray  # (nf, nf) boolean interior mask
    W2d: jnp.ndarray       # (nf, nf) tensor-product quadrature weights
    nu: jnp.ndarray        # scalars as 0-d arrays so they vmap
    beta_sq: jnp.ndarray
    CFL: jnp.ndarray
    lid_velocity: jnp.ndarray
    inv_dx_min: jnp.ndarray
    inv_dy_min: jnp.ndarray
    # corner_treatment="singular" (Botella & Peyret sharp-lid subtraction,
    # ops/singular.py): sampled analytic fields of the subtracted Stokes
    # corner flow. The state then holds the SMOOTH remainder u_tilde; the
    # convection/diagnostic paths add these per-run constants. None in the
    # regularized-lid modes.
    sing_u: jnp.ndarray | None = None      # (nf, nf) u_s
    sing_v: jnp.ndarray | None = None
    sing_dudx: jnp.ndarray | None = None   # analytic grad(u_s) samples
    sing_dudy: jnp.ndarray | None = None
    sing_dvdx: jnp.ndarray | None = None
    sing_dvdy: jnp.ndarray | None = None
    sing_w: jnp.ndarray | None = None      # omega_s (0 at the corner nodes)
    sing_dwx: jnp.ndarray | None = None    # analytic grad(omega_s)
    sing_dwy: jnp.ndarray | None = None

    _FIELDS = (
        "Dx", "DyT", "Dxx", "DyyT", "Ix", "IyT", "Gx", "GyT",
        "bc_u", "bc_v", "interior", "W2d",
        "nu", "beta_sq", "CFL", "lid_velocity", "inv_dx_min", "inv_dy_min",
        "sing_u", "sing_v", "sing_dudx", "sing_dudy", "sing_dvdx",
        "sing_dvdy", "sing_w", "sing_dwx", "sing_dwy",
    )

    def tree_flatten(self):
        return tuple(getattr(self, f) for f in self._FIELDS), None

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children)


def build_spectral_ops(params: SpectralParameters, n: int | None = None,
                       dtype=None) -> Tuple[SpectralOps, dict]:
    """Construct operators + grid info for polynomial order ``n`` (default params.nx)."""
    n = int(params.nx if n is None else n)
    if params.nx != params.ny:
        raise ValueError(
            "Spectral solvers use a square polynomial order (nx == ny); "
            f"got nx={params.nx}, ny={params.ny}. (The reference has the "
            "same practical restriction: every config sets both to N.)")
    dtype = jnp.dtype(params.dtype) if dtype is None else jnp.dtype(dtype)

    bx = basis_ops.make_basis(params.basis_type, (0.0, params.Lx))
    by = basis_ops.make_basis(params.basis_type, (0.0, params.Ly))

    x_nodes = bx.nodes(n + 1)
    y_nodes = by.nodes(n + 1)
    Dx = bx.diff_matrix(n + 1)
    Dy = by.diff_matrix(n + 1)
    Dxx = Dx @ Dx
    Dyy = Dy @ Dy
    Ix = basis_ops.inner_to_full_interp_matrix(x_nodes)
    Iy = basis_ops.inner_to_full_interp_matrix(y_nodes)
    Gx = Dx @ Ix
    Gy = Dy @ Iy

    w_x = bx.quadrature_weights(n + 1)
    w_y = by.quadrature_weights(n + 1)
    W2d = np.outer(w_x, w_y)

    nf = n + 1
    interior = np.zeros((nf, nf), dtype=bool)
    interior[1:-1, 1:-1] = True
    singular = None
    if str(params.corner_treatment).lower() == "singular":
        # Botella & Peyret sharp-lid subtraction: the state is the smooth
        # remainder u_tilde = u - u_s, whose boundary data (sharp BC minus
        # the sampled corner solutions) is continuous at the top corners.
        from ..ops.singular import singular_fields_on_grid

        singular = singular_fields_on_grid(
            x_nodes, y_nodes, lid_velocity=params.lid_velocity,
            Lx=params.Lx, Ly=params.Ly)
        u_tot_bc = np.zeros((nf, nf))
        u_tot_bc[:, -1] = params.lid_velocity  # SHARP lid, corners included
        bc_u = np.where(~interior, u_tot_bc - singular["u"], 0.0)
        bc_v = np.where(~interior, -singular["v"], 0.0)
    else:
        u_lid = lid_profile(
            x_nodes,
            method=params.corner_treatment,
            smoothing_width=params.corner_smoothing,
            lid_velocity=params.lid_velocity,
            Lx=params.Lx,
        )
        bc_u = np.zeros((nf, nf))
        bc_v = np.zeros((nf, nf))
        bc_u[:, -1] = u_lid  # lid applied last => owns the top corners

    dx_min = float(np.min(np.diff(x_nodes)))
    dy_min = float(np.min(np.diff(y_nodes)))

    cast = lambda a: jnp.asarray(a, dtype=dtype)
    scal = lambda s: jnp.asarray(s, dtype=dtype)
    sing_kwargs = {}
    if singular is not None:
        sing_kwargs = {
            "sing_u": cast(singular["u"]), "sing_v": cast(singular["v"]),
            "sing_dudx": cast(singular["dudx"]),
            "sing_dudy": cast(singular["dudy"]),
            "sing_dvdx": cast(singular["dvdx"]),
            "sing_dvdy": cast(singular["dvdy"]),
            "sing_w": cast(singular["omega"]),
            "sing_dwx": cast(singular["dwx"]),
            "sing_dwy": cast(singular["dwy"]),
        }
    ops = SpectralOps(
        Dx=cast(Dx), DyT=cast(Dy.T), Dxx=cast(Dxx), DyyT=cast(Dyy.T),
        Ix=cast(Ix), IyT=cast(Iy.T), Gx=cast(Gx), GyT=cast(Gy.T),
        bc_u=cast(bc_u), bc_v=cast(bc_v), interior=jnp.asarray(interior),
        W2d=cast(W2d),
        nu=scal(1.0 / params.Re), beta_sq=scal(params.beta_squared),
        CFL=scal(params.CFL), lid_velocity=scal(params.lid_velocity),
        inv_dx_min=scal(1.0 / dx_min), inv_dy_min=scal(1.0 / dy_min),
        **sing_kwargs,
    )
    grid = {
        "n": n,
        "x_nodes": x_nodes,
        "y_nodes": y_nodes,
        "shape_full": (nf, nf),
        "shape_inner": (n - 1, n - 1),
        "dx_min": dx_min,
        "dy_min": dy_min,
        "w_x": w_x,
        "w_y": w_y,
        "Dx": Dx,
        "Dy": Dy,
        "Dxx": Dxx,
        "Dyy": Dyy,
        "Ix": Ix,
        "Iy": Iy,
        "basis_x": bx,
        "basis_y": by,
        "singular": singular,  # float64 sampled fields dict or None
    }
    return ops, grid


def initial_state(ops: SpectralOps) -> SpectralState:
    """Start-of-solve fields (sg.py:250-253: impulsive start from rest).

    In singular mode "rest" means the TOTAL velocity is zero in the
    interior, i.e. u_tilde = -u_s there (u_tilde = 0 would start the total
    flow at the O(1) non-physical Stokes corner field everywhere, whose
    cancellation is a long oscillatory AC transient — measured 4-6x slower
    spin-up at N=128 Re=1000, and the source of harsher cold-start
    stability floors)."""
    nf = ops.bc_u.shape[0]
    ni = nf - 2
    dtype = ops.bc_u.dtype
    if ops.sing_u is not None:
        u, v = enforce_bc(ops, -ops.sing_u, -ops.sing_v)
    else:
        u, v = enforce_bc(ops, jnp.zeros((nf, nf), dtype),
                          jnp.zeros((nf, nf), dtype))
    return SpectralState(u=u, v=v, p=jnp.zeros((ni, ni), dtype))


def enforce_bc(ops: SpectralOps, u: jnp.ndarray, v: jnp.ndarray):
    """Masked-select BC enforcement (replaces per-wall writes of sg.py:348-385)."""
    u = jnp.where(ops.interior, u, ops.bc_u)
    v = jnp.where(ops.interior, v, ops.bc_v)
    return u, v


def residuals(ops: SpectralOps, u: jnp.ndarray, v: jnp.ndarray, p: jnp.ndarray):
    """RHS residuals (R_u, R_v full grid; R_p inner grid) — sg.py:278-346."""
    du_dx = _mm(ops.Dx, u)
    du_dy = _mm(u, ops.DyT)
    dv_dx = _mm(ops.Dx, v)
    dv_dy = _mm(v, ops.DyT)
    lap_u = _mm(ops.Dxx, u) + _mm(u, ops.DyyT)
    lap_v = _mm(ops.Dxx, v) + _mm(v, ops.DyyT)
    # fused inner->full interpolation + differentiation of pressure
    dp_dx = _mm(_mm(ops.Gx, p), ops.IyT)
    dp_dy = _mm(_mm(ops.Ix, p), ops.GyT)

    if ops.sing_u is not None:
        # singular subtraction: convect with the TOTAL velocity; the
        # singular part's derivatives are analytic samples, never spectral.
        # nu*lap(u_s) - grad(p_s) == 0 (Stokes) and div(u_s) == 0, so the
        # viscous/pressure/continuity terms keep their u_tilde form.
        U = u + ops.sing_u
        V = v + ops.sing_v
        conv_u = U * (du_dx + ops.sing_dudx) + V * (du_dy + ops.sing_dudy)
        conv_v = U * (dv_dx + ops.sing_dvdx) + V * (dv_dy + ops.sing_dvdy)
    else:
        conv_u = u * du_dx + v * du_dy
        conv_v = u * dv_dx + v * dv_dy
    R_u = -conv_u - dp_dx + ops.nu * lap_u
    R_v = -conv_v - dp_dy + ops.nu * lap_v
    div = du_dx + dv_dy
    R_p = -ops.beta_sq * div[1:-1, 1:-1]
    return R_u, R_v, R_p


def adaptive_dt(ops: SpectralOps, u: jnp.ndarray, v: jnp.ndarray) -> jnp.ndarray:
    """CFL-limited pseudo-timestep (sg.py:387-408).

    In singular mode the wave speeds belong to the TOTAL velocity."""
    if ops.sing_u is not None:
        u = u + ops.sing_u
        v = v + ops.sing_v
    u_max = jnp.maximum(jnp.max(jnp.abs(u)), ops.lid_velocity)
    v_max = jnp.maximum(jnp.max(jnp.abs(v)), jnp.asarray(1e-10, u.dtype))
    lam_x = (u_max + jnp.sqrt(u_max**2 + ops.beta_sq)) * ops.inv_dx_min \
        + ops.nu * ops.inv_dx_min**2
    lam_y = (v_max + jnp.sqrt(v_max**2 + ops.beta_sq)) * ops.inv_dy_min \
        + ops.nu * ops.inv_dy_min**2
    return ops.CFL / (lam_x + lam_y)


_RK4_ALPHAS = (0.25, 1.0 / 3.0, 0.5, 1.0)


def sg_step(ops: SpectralOps, state: SpectralState, tau=None):
    """One low-storage RK4 pseudo-timestep. Returns (state, metrics).

    The metrics dict carries the algebraic residual norms of the LAST stage
    evaluation (matching _compute_algebraic_residuals after step(),
    sg.py:463-473) and the quadrature-based conserved quantities
    (sg.py:495-550).

    ``tau`` (optional (tau_u, tau_v, tau_p)) is a FAS forcing added to every
    stage residual — the coarse-grid correction source of the V-cycle
    multigrid (the hook the reference's MultigridSmoother carries but never
    exercises, multigrid/fsg.py:1019-1045).
    """
    u0, v0, p0 = state.u, state.v, state.p
    dt = adaptive_dt(ops, u0, v0)

    u_in, v_in, p_in = u0, v0, p0
    R_u = R_v = R_p = None
    for alpha in _RK4_ALPHAS:
        R_u, R_v, R_p = residuals(ops, u_in, v_in, p_in)
        if tau is not None:
            R_u = R_u + tau[0]
            R_v = R_v + tau[1]
            R_p = R_p + tau[2]
        u_in = u0 + (alpha * dt) * R_u
        v_in = v0 + (alpha * dt) * R_v
        p_in = p0 + (alpha * dt) * R_p
        u_in, v_in = enforce_bc(ops, u_in, v_in)

    new_state = SpectralState(u=u_in, v=v_in, p=p_in)

    energy, enstrophy, palinstrophy = conserved_quantities(ops, u_in, v_in)

    metrics = {
        "u_eq": jnp.linalg.norm(R_u),
        "v_eq": jnp.linalg.norm(R_v),
        "continuity": jnp.linalg.norm(R_p),
        "energy": energy,
        "enstrophy": enstrophy,
        "palinstrophy": palinstrophy,
    }
    return new_state, metrics


def conserved_quantities(ops: SpectralOps, u: jnp.ndarray, v: jnp.ndarray):
    """(energy, enstrophy, palinstrophy) with Gauss-Lobatto quadrature
    (sg.py:495-550). In singular mode the quadratures run over the TOTAL
    fields: spectral derivatives act on the smooth remainder only, the
    singular contributions are analytic samples. Note the sharp-lid
    enstrophy/palinstrophy integrals diverge (omega ~ 1/r at the corners):
    the quadrature values are finite because the corner samples are zeroed,
    but they grow with N by construction — physical truth, not a bug."""
    omega = _mm(ops.Dx, v) - _mm(u, ops.DyT)
    dwx = _mm(ops.Dx, omega)
    dwy = _mm(omega, ops.DyT)
    if ops.sing_u is not None:
        u = u + ops.sing_u
        v = v + ops.sing_v
        omega = omega + ops.sing_w
        dwx = dwx + ops.sing_dwx
        dwy = dwy + ops.sing_dwy
    energy = 0.5 * jnp.sum(ops.W2d * (u * u + v * v))
    enstrophy = 0.5 * jnp.sum(ops.W2d * omega * omega)
    palinstrophy = 0.5 * jnp.sum(ops.W2d * (dwx * dwx + dwy * dwy))
    return energy, enstrophy, palinstrophy


def vorticity(ops: SpectralOps, u: jnp.ndarray, v: jnp.ndarray,
              total: bool = True) -> jnp.ndarray:
    """Spectral vorticity ω = dv/dx - du/dy on the full grid (sg.py:510-522).

    ``total=True`` adds the sampled singular vorticity in singular mode
    (zeroed at the two corner nodes where it diverges); pass ``total=False``
    for the smooth remainder only."""
    om = _mm(ops.Dx, v) - _mm(u, ops.DyT)
    if total and ops.sing_w is not None:
        om = om + ops.sing_w
    return om


def extrapolate_inner_to_full(p_inner: jnp.ndarray) -> jnp.ndarray:
    """Linear boundary extrapolation of an inner-grid field (sg.py:144-179).

    Used only for pressure OUTPUT (the solve path uses the spectral
    interpolation matrices).
    """
    ni = p_inner.shape[0]
    nf = ni + 2
    full = jnp.zeros((nf, nf), p_inner.dtype)
    full = full.at[1:-1, 1:-1].set(p_inner)
    full = full.at[0, 1:-1].set(2 * full[1, 1:-1] - full[2, 1:-1])
    full = full.at[-1, 1:-1].set(2 * full[-2, 1:-1] - full[-3, 1:-1])
    full = full.at[1:-1, 0].set(2 * full[1:-1, 1] - full[1:-1, 2])
    full = full.at[1:-1, -1].set(2 * full[1:-1, -2] - full[1:-1, -3])
    full = full.at[0, 0].set(0.5 * (full[0, 1] + full[1, 0]))
    full = full.at[0, -1].set(0.5 * (full[0, -2] + full[1, -1]))
    full = full.at[-1, 0].set(0.5 * (full[-1, 1] + full[-2, 0]))
    full = full.at[-1, -1].set(0.5 * (full[-1, -2] + full[-2, -1]))
    return full
