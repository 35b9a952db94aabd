"""Fast direct Poisson solvers via tensor-product diagonalization.

The reference solves its Poisson problems with host sparse factorizations:
- streamfunction (spectral): Kronecker Laplacian + Dirichlet row replacement
  + ``scipy.sparse.linalg.spsolve`` (sg.py:556-619),
- streamfunction (FV/FD): 5-point interior Laplacian + spsolve
  (base.py:569-637),
- FV pressure correction: PyAMG-preconditioned BiCGSTAB on a constant
  conductance matrix (fv/solver.py:91-107, 223-232).

None of those map to an accelerator. Because every operator here is a *separable*
constant operator L = Ax ⊗ I + I ⊗ Ay, we precompute the 1D eigendecomposition
Ax = Vx Λx Vx^{-1} once on the host (float64) and solve on device with four
dense matmuls and one elementwise divide:

    U = Vx [ (Vx^{-1} F Vy^{-T}) / (λx_i + λy_j) ] Vy^T

This is exact (direct), O(N^3), and jit/vmap-friendly.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial

import numpy as np
import jax
import jax.numpy as jnp

__all__ = [
    "SeparablePoisson",
    "spectral_dirichlet_poisson",
    "fd_dirichlet_poisson",
    "fv_neumann_pressure_poisson",
]

_HIGHEST = jax.lax.Precision.HIGHEST


def _mm(a, b):
    return jnp.matmul(a, b, precision=_HIGHEST)


@jax.tree_util.register_pytree_node_class
@dataclass
class SeparablePoisson:
    """Direct solver for (Ax ⊗ I + I ⊗ Ay) u = f via eigendecomposition.

    Fields are device arrays in the working dtype; construction happens on the
    host in float64. ``zero_mode_tol`` > 0 nulls near-zero eigenvalue pairs
    (for singular Neumann operators, selecting the mean-free solution).

    ``symmetric=True`` (for the symmetric FD/FV Laplacians) uses ``eigh`` so
    the eigenbases are exactly orthogonal and the "inverse" matmuls are plain
    transposes — markedly better conditioned in float32 than a general
    ``inv(V)``, which matters for the float32 FV pressure solve.

    ``Ax``/``Ay`` are kept so ``solve_refined`` can run classical iterative
    refinement: one extra residual apply + solve recovers most of the f32
    roundoff lost in the transform round-trip.
    """

    Vx: jnp.ndarray
    Vx_inv: jnp.ndarray
    Vy: jnp.ndarray
    Vy_inv: jnp.ndarray
    inv_lam: jnp.ndarray  # (nx, ny): 1/(λx_i + λy_j), 0 where |λ-sum| < tol
    Ax: jnp.ndarray       # original 1D operators, for residual computation
    Ay: jnp.ndarray
    singular: bool = False  # zero mode nulled (Neumann): project residuals

    def tree_flatten(self):
        return ((self.Vx, self.Vx_inv, self.Vy, self.Vy_inv, self.inv_lam,
                 self.Ax, self.Ay), (self.singular,))

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children, singular=aux[0])

    @classmethod
    def build(cls, Ax: np.ndarray, Ay: np.ndarray, dtype=jnp.float32,
              zero_mode_tol: float = 0.0,
              symmetric: bool = False) -> "SeparablePoisson":
        Ax64 = np.asarray(Ax, dtype=np.float64)
        Ay64 = np.asarray(Ay, dtype=np.float64)
        if symmetric:
            lx, Vx = np.linalg.eigh(Ax64)
            ly, Vy = np.linalg.eigh(Ay64)
            Vx_inv, Vy_inv = Vx.T, Vy.T
        else:
            lx, Vx = np.linalg.eig(Ax64)
            ly, Vy = np.linalg.eig(Ay64)
            # The operators used here (Dirichlet spectral/FD Laplacians,
            # Neumann cell Laplacians) have real spectra; drop the
            # numerically-zero imaginary parts.
            lx, Vx = np.real(lx), np.real(Vx)
            ly, Vy = np.real(ly), np.real(Vy)
            Vx_inv = np.linalg.inv(Vx)
            Vy_inv = np.linalg.inv(Vy)
        lam = lx[:, None] + ly[None, :]
        if zero_mode_tol > 0.0:
            scale = max(np.abs(lam).max(), 1.0)
            mask = np.abs(lam) > zero_mode_tol * scale
            inv = np.where(mask, 1.0 / np.where(mask, lam, 1.0), 0.0)
        else:
            inv = 1.0 / lam
        cast = lambda a: jnp.asarray(a, dtype=dtype)
        return cls(cast(Vx), cast(Vx_inv), cast(Vy), cast(Vy_inv), cast(inv),
                   cast(Ax64), cast(Ay64), singular=zero_mode_tol > 0.0)

    @partial(jax.jit, static_argnums=())
    def solve(self, f: jnp.ndarray) -> jnp.ndarray:
        """Solve L u = f for a 2D right-hand side of shape (nx, ny)."""
        fhat = _mm(_mm(self.Vx_inv, f), self.Vy_inv.T)
        return _mm(_mm(self.Vx, fhat * self.inv_lam), self.Vy.T)

    def apply(self, u: jnp.ndarray) -> jnp.ndarray:
        """L u = Ax u + u Ay^T."""
        return _mm(self.Ax, u) + _mm(u, self.Ay.T)

    def solve_refined(self, f: jnp.ndarray, n_refine: int = 1) -> jnp.ndarray:
        """Direct solve + ``n_refine`` steps of iterative refinement.

        In float32 the eigen-transform round-trip loses ~2-3 digits on large
        grids; each refinement step costs one operator apply (two matmuls)
        plus one solve (four matmuls) and recovers the residual projection.
        For singular (Neumann) operators the residual is projected mean-free
        so refinement stays in the solvable subspace.
        """
        u = self.solve(f)
        for _ in range(int(n_refine)):
            r = f - self.apply(u)
            if self.singular:
                r = r - jnp.mean(r)
            u = u + self.solve(r)
        return u


def spectral_dirichlet_poisson(Dxx_1d: np.ndarray, Dyy_1d: np.ndarray,
                               dtype=jnp.float32) -> SeparablePoisson:
    """Solver for the interior spectral Laplacian with homogeneous Dirichlet BCs.

    Eliminating the boundary unknowns (u = 0 there) reduces the collocation
    Laplacian to its interior block: Ax = Dxx[1:-1, 1:-1], Ay = Dyy[1:-1, 1:-1].
    """
    return SeparablePoisson.build(
        np.asarray(Dxx_1d)[1:-1, 1:-1], np.asarray(Dyy_1d)[1:-1, 1:-1], dtype=dtype
    )


def _fd_dirichlet_1d(n_interior: int, h: float) -> np.ndarray:
    """Standard second-difference operator with homogeneous Dirichlet ends."""
    main = np.full(n_interior, -2.0 / h**2)
    off = np.full(n_interior - 1, 1.0 / h**2)
    return np.diag(main) + np.diag(off, 1) + np.diag(off, -1)


def fd_dirichlet_poisson(nx_interior: int, ny_interior: int, dx: float, dy: float,
                         dtype=jnp.float32) -> SeparablePoisson:
    """5-point FD interior Laplacian with psi = 0 boundaries (streamfunction)."""
    return SeparablePoisson.build(
        _fd_dirichlet_1d(nx_interior, dx), _fd_dirichlet_1d(ny_interior, dy),
        dtype=dtype, symmetric=True,
    )


def _fv_neumann_1d(n_cells: int, d_conductance: float) -> np.ndarray:
    """Cell-centered conductance Laplacian with homogeneous Neumann ends.

    Row for interior cell i: d*(u_{i-1} - 2 u_i + u_{i+1}); end cells couple to
    the single interior neighbor only. This matches the assembled FV
    pressure-correction matrix of the reference (conductance D_f = rho |E|/|d|,
    pressure_correction_eq_assembly.py:5-75) up to the tensor split.
    """
    A = np.zeros((n_cells, n_cells))
    for i in range(n_cells):
        if i > 0:
            A[i, i - 1] = d_conductance
            A[i, i] -= d_conductance
        if i < n_cells - 1:
            A[i, i + 1] = d_conductance
            A[i, i] -= d_conductance
    return A


def fv_neumann_pressure_poisson(nx: int, ny: int, dx: float, dy: float,
                                rho: float = 1.0, dtype=jnp.float32) -> SeparablePoisson:
    """Direct solver for the FV pressure-correction equation.

    The assembled operator is -(Lx ⊗ I + I ⊗ Ly) with conductances
    rho*dy/dx (x-faces) and rho*dx/dy (y-faces); it is singular with a
    constant null space. We solve the mean-free problem (zero-mode nulled);
    the caller gauges the result (reference pins p'[cell 0] = 0, which for a
    consistent RHS is the same solution shifted by a constant).

    Note the sign: the reference assembles +D_f on the diagonal so its matrix
    is the NEGATIVE Laplacian; we build the negative Laplacian too so that
    ``solve(rhs)`` matches ``A_p x = rhs`` semantics directly.
    """
    Ax = -_fv_neumann_1d(nx, rho * dy / dx)   # acts along x (within a row)
    Ay = -_fv_neumann_1d(ny, rho * dx / dy)   # acts along y
    return SeparablePoisson.build(Ay, Ax, dtype=dtype, zero_mode_tol=1e-12,
                                  symmetric=True)
