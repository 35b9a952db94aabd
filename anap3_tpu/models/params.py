"""Configuration and result dataclasses.

Mirrors the params/metrics/time-series/fields contract of the reference
(src/solvers/datastructures.py) so that tracking keys, validation tables and
plots stay drop-in compatible. These are *static* host-side dataclasses; the
device-side state lives in the solver pytrees.
"""

from __future__ import annotations

from dataclasses import dataclass, field, asdict
from typing import List, Optional

import numpy as np

__all__ = [
    "Parameters",
    "FVParameters",
    "SpectralParameters",
    "Metrics",
    "TimeSeries",
    "Fields",
    "resolve_dtype",
]


def resolve_dtype(dtype: str) -> str:
    """Resolve the ``"auto"`` working-precision policy.

    ``auto`` keeps the reference's float64 semantics on every backend; an
    explicit ``float32``/``float64`` is returned unchanged. The solver
    constructor (models/base.py) enables JAX's 64-bit mode whenever the
    resolved dtype is float64, so the reported precision is the computed one.
    """
    s = str(dtype).lower()
    return "float64" if s == "auto" else str(dtype)


@dataclass
class Parameters:
    """Base solver parameters (input configuration), reference datastructures.py:29-51."""

    name: str = ""
    Re: float = 100.0
    lid_velocity: float = 1.0
    Lx: float = 1.0
    Ly: float = 1.0
    nx: int = 64
    ny: int = 64
    max_iterations: int = 500
    tolerance: float = 1e-4
    method: str = ""
    # Working precision of the device hot path ("auto" = float64).
    dtype: str = "float64"
    # Mid-solve checkpoint/resume (utils/checkpoint.py). Empty = disabled.
    checkpoint_dir: str = ""
    checkpoint_every_chunks: int = 10
    # Iterations per jitted chunk: larger values amortize the per-chunk
    # host<->device sync at the cost of up to chunk_size-1 extra frozen
    # iterations after convergence.
    chunk_size: int = 200
    # Convergence criterion: "auto" (default — spectral single/FSG solves
    # resolve to "energy" at N >= 128 where the measured rel-iter
    # false-convergence sets in [solver-study r3: FSG N=192 exits after 11
    # fine iterations at 2.2x the converged L2]; everything else resolves
    # to "rel_iter"), "rel_iter" (relative iterate change; the reference's
    # definition), "residual" (algebraic residual reduction relative to
    # the warmup iteration; robust against the slow-dynamics false
    # convergence that rel_iter exhibits in float32), or "energy"
    # (kinetic-energy plateau: stop when |dE| over one chunk falls below
    # tolerance * |E|, tested host-side at chunk boundaries — the
    # criterion for high-Re runs whose slowest physics drift below any
    # per-step test; pairs naturally with large chunk_size).
    convergence_metric: str = "auto"
    # Plateau detection (models/runner.py): stop with stalled=True after
    # this many chunks without >2% improvement of the criterion. -1 = auto
    # (enabled at 25 chunks for float32 FV, where the criterion can floor
    # above tolerance; off otherwise); 0 = off; >0 = explicit chunk count.
    stall_chunks: int = -1

    def to_mlflow(self) -> dict:
        return {
            k: (int(v) if isinstance(v, bool) else v) for k, v in asdict(self).items()
        }

    def to_dataframe(self):
        import pandas as pd

        return pd.DataFrame([self.to_mlflow()])


@dataclass
class FVParameters(Parameters):
    """FV-SIMPLE parameters (reference datastructures.py:173-185)."""

    convection_scheme: str = "Upwind"
    limiter: str = "MUSCL"
    alpha_uv: float = 0.6
    alpha_p: float = 0.4
    linear_solver_tol: float = 1e-6
    method: str = "FV-SIMPLE"
    corner_treatment: str = "none"
    corner_smoothing: float = 0.15
    # "compact" uses the proper Rhie-Chow face pressure gradient
    # (p_N - p_P)/d; "averaged" reproduces the reference formulation, whose
    # face-gradient correction cancels identically (rhie_chow.py:33-60 both
    # interpolate cell gradients, so grad_p_bar - avg(grad_p) == 0).
    rhie_chow: str = "compact"


@dataclass
class SpectralParameters(Parameters):
    """Spectral solver parameters (reference datastructures.py:257-279)."""

    basis_type: str = "legendre"
    CFL: float = 0.1
    beta_squared: float = 5.0
    method: str = "Spectral-AC"
    corner_treatment: str = "smoothing"
    corner_smoothing: float = 0.15
    multigrid: str = "none"  # "none" | "fsg"
    n_levels: int = 3
    coarse_tolerance_factor: float = 10.0
    prolongation_method: str = "fft"
    restriction_method: str = "fft"
    # Steady Newton-Krylov / PTC solver knobs (models/steady.py,
    # solver=spectral/newton). ``tolerance`` becomes the RMS steady-residual
    # target there; these bound the outer PTC loop and the Krylov spaces.
    newton_max_steps: int = 50
    gmres_vectors: int = 60
    newton_dt0: float = 0.05
    newton_dt_max: float = 3e3
    newton_schur_iters: int = 40
    newton_prelude: int = 0       # marched RK4 warm-up steps before PTC
    initial_state_path: str = ""  # npz {u, v, p} warm start (Re-continuation)
    # Float64 Newton polish of the marched solution (SG/FSG/VMG): after a
    # float32 march stops, a few PTC steps land on the EXACT discrete
    # steady state (removes every float32 criterion-floor concern).
    newton_polish: bool = False
    newton_polish_tol: float = 1e-9   # RMS steady-residual target
    newton_polish_steps: int = 12     # PTC step budget for the polish


@dataclass
class Metrics:
    """Scalar output metrics (reference datastructures.py:59-109)."""

    iterations: int = 0
    converged: bool = False
    # Convergence criterion plateaued above tolerance (float32 noise floor)
    # and the run was cut short by stall detection (runner stall_chunks).
    stalled: bool = False
    final_residual: float = float("inf")
    wall_time_seconds: float = 0.0
    u_momentum_residual: float = 0.0
    v_momentum_residual: float = 0.0
    continuity_residual: float = 0.0
    final_energy: float = 0.0
    final_enstrophy: float = 0.0
    final_palinstrophy: float = 0.0

    psi_min: float = 0.0
    psi_min_x: float = 0.0
    psi_min_y: float = 0.0
    omega_center: float = 0.0
    omega_max: float = 0.0
    omega_max_x: float = 0.0
    omega_max_y: float = 0.0
    psi_BR: float = 0.0
    omega_BR: float = 0.0
    psi_BR_x: float = 0.0
    psi_BR_y: float = 0.0
    psi_BL: float = 0.0
    omega_BL: float = 0.0
    psi_BL_x: float = 0.0
    psi_BL_y: float = 0.0
    psi_TL: float = 0.0
    omega_TL: float = 0.0
    psi_TL_x: float = 0.0
    psi_TL_y: float = 0.0

    # newton_polish=true extras (0 when polish is off): PTC steps taken and
    # the float64 RMS steady residual of the FINAL state.
    polish_steps: int = 0
    steady_residual_rms: float = 0.0

    def to_mlflow(self) -> dict:
        return {
            k: (int(v) if isinstance(v, bool) else v)
            for k, v in self.__dict__.items()
            if v != float("inf")
        }

    def to_dataframe(self):
        import pandas as pd

        return pd.DataFrame([self.to_mlflow()])


@dataclass
class TimeSeries:
    """Per-iteration convergence histories (reference datastructures.py:117-143)."""

    rel_iter_residual: Optional[List[float]] = field(default_factory=list)
    u_residual: Optional[List[float]] = field(default_factory=list)
    v_residual: Optional[List[float]] = field(default_factory=list)
    continuity_residual: Optional[List[float]] = field(default_factory=list)
    energy: Optional[List[float]] = field(default_factory=list)
    enstrophy: Optional[List[float]] = field(default_factory=list)
    palinstrophy: Optional[List[float]] = field(default_factory=list)

    def to_batch(self) -> list:
        """(key, value, step) triples for batched metric logging."""
        return [
            (name, float(value), step)
            for name, values in self.__dict__.items()
            if values
            for step, value in enumerate(values)
            if value is not None
        ]

    def to_dataframe(self):
        import pandas as pd

        return pd.DataFrame({k: v for k, v in self.__dict__.items() if v})


@dataclass
class Fields:
    """Flat spatial solution arrays on the solver's grid (datastructures.py:151-165)."""

    u: np.ndarray
    v: np.ndarray
    p: np.ndarray
    x: np.ndarray
    y: np.ndarray

    def to_dataframe(self):
        import pandas as pd

        return pd.DataFrame(
            {"x": self.x, "y": self.y, "u": self.u, "v": self.v, "p": self.p}
        )
