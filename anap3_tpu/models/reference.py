"""Plain float64 numpy reference of the single-grid RK4/AC step.

An independent restatement of ``spectral_sg.sg_step`` (the reference's
sg.py:278-449 hot loop) with nothing fused: the pressure is interpolated to
the full grid, then differentiated; boundary values are written wall by
wall; the pseudo-timestep follows sg.py:387-408. Only the 1-D node,
differentiation and lid-profile builders are shared with the solver. The
device step is compared against it in the CPU tests and, at N=128, on the
card (chip_smoke.py).
"""

from __future__ import annotations

import numpy as np

from ..ops import basis as basis_ops
from ..ops.corner import lid_profile

__all__ = ["ReferenceSG", "step_tolerance"]

_RK4_ALPHAS = (0.25, 1.0 / 3.0, 0.5, 1.0)


def step_tolerance(n: int, dtype) -> float:
    """Max relative error allowed between the device step and this
    reference after 5-10 steps of order ``n`` (error max over u, v, p,
    relative to each field's max).

    Measured on the CPU backend: float64 agrees to 3e-16 at N=8 and 1e-14 at
    N=128 (summation order only); float32 with Precision.HIGHEST to 2e-7 at
    N=8 and 3-6e-6 at N=128, growing about linearly with N (rounding
    amplified through the differentiation matrices). The bounds, 1e-10 and
    1e-4 at N=128, scaled linearly in N, leave four orders of magnitude for
    float64 and a factor of about 20 for float32 at every N.
    """
    scale = max(int(n), 8) / 128.0
    base = 1e-10 if np.dtype(dtype) == np.float64 else 1e-4
    return base * scale


class ReferenceSG:
    """Host float64 single-grid solver state and step for one configuration
    (regularized lids only: ``smoothing`` or ``saad``)."""

    def __init__(self, n: int, Re: float, basis_type: str = "chebyshev",
                 corner_treatment: str = "smoothing",
                 corner_smoothing: float = 0.15, CFL: float = 1.5,
                 beta_squared: float = 5.0, lid_velocity: float = 1.0,
                 Lx: float = 1.0, Ly: float = 1.0):
        bx = basis_ops.make_basis(basis_type, (0.0, Lx))
        by = basis_ops.make_basis(basis_type, (0.0, Ly))
        x, y = bx.nodes(n + 1), by.nodes(n + 1)
        self.Dx, self.Dy = bx.diff_matrix(n + 1), by.diff_matrix(n + 1)
        self.Ix = basis_ops.inner_to_full_interp_matrix(x)
        self.Iy = basis_ops.inner_to_full_interp_matrix(y)
        self.u_lid = lid_profile(x, method=corner_treatment,
                                 smoothing_width=corner_smoothing,
                                 lid_velocity=lid_velocity, Lx=Lx)
        self.nu = 1.0 / Re
        self.beta_sq = beta_squared
        self.CFL = CFL
        self.lid_velocity = lid_velocity
        self.dx_min = float(np.min(np.diff(x)))
        self.dy_min = float(np.min(np.diff(y)))
        nf = n + 1
        self.u = np.zeros((nf, nf))
        self.v = np.zeros((nf, nf))
        self.p = np.zeros((nf - 2, nf - 2))
        self._enforce(self.u, self.v)

    def _enforce(self, u, v):
        """West, east, south walls, then the lid (it owns the top corners)."""
        for f in (u, v):
            f[0, :] = 0.0
            f[-1, :] = 0.0
            f[:, 0] = 0.0
        u[:, -1] = self.u_lid
        v[:, -1] = 0.0

    def residuals(self, u, v, p):
        Dx, Dy = self.Dx, self.Dy
        du_dx, du_dy = Dx @ u, u @ Dy.T
        dv_dx, dv_dy = Dx @ v, v @ Dy.T
        lap_u = Dx @ du_dx + du_dy @ Dy.T
        lap_v = Dx @ dv_dx + dv_dy @ Dy.T
        p_full = self.Ix @ p @ self.Iy.T
        dp_dx, dp_dy = Dx @ p_full, p_full @ Dy.T
        R_u = -(u * du_dx + v * du_dy) - dp_dx + self.nu * lap_u
        R_v = -(u * dv_dx + v * dv_dy) - dp_dy + self.nu * lap_v
        R_p = -self.beta_sq * (du_dx + dv_dy)[1:-1, 1:-1]
        return R_u, R_v, R_p

    def dt(self) -> float:
        u_max = max(float(np.max(np.abs(self.u))), self.lid_velocity)
        v_max = max(float(np.max(np.abs(self.v))), 1e-10)
        lam_x = ((u_max + np.sqrt(u_max ** 2 + self.beta_sq)) / self.dx_min
                 + self.nu / self.dx_min ** 2)
        lam_y = ((v_max + np.sqrt(v_max ** 2 + self.beta_sq)) / self.dy_min
                 + self.nu / self.dy_min ** 2)
        return self.CFL / (lam_x + lam_y)

    def step(self) -> None:
        """One low-storage RK4 pseudo-timestep, in place."""
        dt = self.dt()
        u0, v0, p0 = self.u, self.v, self.p
        u, v, p = u0, v0, p0
        for alpha in _RK4_ALPHAS:
            R_u, R_v, R_p = self.residuals(u, v, p)
            u = u0 + alpha * dt * R_u
            v = v0 + alpha * dt * R_v
            p = p0 + alpha * dt * R_p
            self._enforce(u, v)
        self.u, self.v, self.p = u, v, p
