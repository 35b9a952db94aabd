"""User-facing solver shell shared by the spectral and FV solvers.

Mirrors the public API of the reference's ``LidDrivenCavitySolver``
(src/solvers/base.py): ``solve()``, ``params``/``metrics``/``fields``/
``time_series``, vortex metrics, VTK export, validation errors, HDF5 state
save. The numerical work happens in the jitted functional cores; this class
only orchestrates and post-processes on the host.
"""

from __future__ import annotations

import logging
from pathlib import Path
from typing import Dict, Optional

import numpy as np

from .params import Fields, Metrics, TimeSeries, resolve_dtype
from .runner import IterationResult
from ..analysis import validation as validation_mod
from ..analysis.vortex import vortex_metrics_from_fields
from ..utils import vts as vts_mod

log = logging.getLogger(__name__)

__all__ = ["CavitySolver"]


class CavitySolver:
    """Base class wiring a functional solver core into the experiment harness."""

    Parameters = None  # subclasses: FVParameters / SpectralParameters

    def __init__(self, params=None, **kwargs):
        if params is None:
            if self.Parameters is None:
                raise ValueError("Subclass must define a Parameters class attribute")
            kwargs.pop("_target_", None)
            params = self.Parameters(**kwargs)
        params.dtype = resolve_dtype(params.dtype)
        if params.dtype == "float64":
            # without 64-bit mode every jnp array silently truncates to
            # float32 while the run still reports float64
            import jax

            jax.config.update("jax_enable_x64", True)
        self.params = params
        from ..utils.compile_cache import enable_compile_cache

        enable_compile_cache()
        self.metrics = Metrics()
        self.fields: Optional[Fields] = None
        self.time_series: Optional[TimeSeries] = None
        self._log_callback = None  # optional live-metric hook (tracking)

    def _check_state_dtype(self, state) -> None:
        """Raise unless every state leaf holds the resolved working dtype."""
        import jax

        want = np.dtype(self.params.dtype)
        got = {np.dtype(x.dtype) for x in jax.tree.leaves(state)}
        if got != {want}:
            raise TypeError(f"solver state dtype {sorted(map(str, got))} "
                            f"does not match the resolved dtype {want}")

    # ------------------------------------------------------------------
    # Abstract-ish surface implemented by subclasses
    # ------------------------------------------------------------------

    def solve(self, tolerance: float = None, max_iter: int = None) -> None:
        raise NotImplementedError

    def _final_fields(self) -> Fields:
        """Flat output fields (u, v, p, x, y) from the converged state."""
        raise NotImplementedError

    def _vorticity_full(self) -> np.ndarray:
        """Vorticity on the solver's 2D grid for analysis."""
        raise NotImplementedError

    def _streamfunction(self):
        """(psi_2d, X, Y) on the solver's 2D grid."""
        raise NotImplementedError

    # ------------------------------------------------------------------
    # Result assembly (semantics of reference base.py:112-200)
    # ------------------------------------------------------------------

    def _store_results(self, result: IterationResult,
                       max_timeseries_points: int = 1000) -> None:
        self.fields = self._final_fields()
        self.first_chunk_time = getattr(result, "first_chunk_time", 0.0)
        hist = result.history

        def downsample(data):
            if data is None or len(data) <= max_timeseries_points:
                return data
            idx = np.linspace(0, len(data) - 1, max_timeseries_points, dtype=int)
            return [data[i] for i in idx]

        self.time_series = TimeSeries(
            rel_iter_residual=downsample(hist.get("rel_iter")),
            u_residual=downsample(hist.get("u_eq")),
            v_residual=downsample(hist.get("v_eq")),
            continuity_residual=downsample(hist.get("continuity")),
            energy=downsample(hist.get("energy")),
            enstrophy=downsample(hist.get("enstrophy")),
            palinstrophy=downsample(hist.get("palinstrophy")),
        )

        try:
            vortex = self.compute_vortex_metrics()
        except Exception as exc:  # analysis must not kill the run
            log.warning("Failed to compute vortex metrics: %s", exc)
            vortex = {}

        def last(key, default=0.0):
            vals = hist.get(key) or []
            return float(vals[-1]) if vals else default

        self.metrics = Metrics(
            iterations=result.iterations,
            converged=result.converged,
            stalled=getattr(result, "stalled", False),
            final_residual=last("rel_iter", float("inf")),
            wall_time_seconds=result.wall_time,
            u_momentum_residual=last("u_eq"),
            v_momentum_residual=last("v_eq"),
            continuity_residual=last("continuity"),
            final_energy=last("energy"),
            final_enstrophy=last("enstrophy"),
            final_palinstrophy=last("palinstrophy"),
            **{k: vortex.get(k, 0.0) for k in (
                "psi_min", "psi_min_x", "psi_min_y", "omega_center",
                "omega_max", "omega_max_x", "omega_max_y",
                "psi_BR", "omega_BR", "psi_BR_x", "psi_BR_y",
                "psi_BL", "omega_BL", "psi_BL_x", "psi_BL_y",
                "psi_TL", "omega_TL", "psi_TL_x", "psi_TL_y",
            )},
        )
        polish = getattr(self, "_polish_info", None)
        if polish:
            self.metrics.polish_steps = int(polish["steps"])
            self.metrics.steady_residual_rms = float(polish["rms"])

    # ------------------------------------------------------------------
    # Analysis
    # ------------------------------------------------------------------

    def compute_vortex_metrics(self) -> Dict[str, float]:
        psi, X, Y = self._streamfunction()
        omega = self._vorticity_full()
        return vortex_metrics_from_fields(psi, omega.reshape(psi.shape), X, Y)

    def compute_global_quantities(self) -> Dict[str, float]:
        return {
            "E": self.metrics.final_energy,
            "Z": self.metrics.final_enstrophy,
            "P": self.metrics.final_palinstrophy,
        }

    # ------------------------------------------------------------------
    # Evaluation / validation
    # ------------------------------------------------------------------

    def _evaluate_at_points(self, x: np.ndarray, y: np.ndarray):
        """Bilinear default (base.py:1122-1160); spectral solvers override."""
        from scipy.interpolate import RegularGridInterpolator

        x_unique = np.sort(np.unique(self.fields.x))
        y_unique = np.sort(np.unique(self.fields.y))
        nx, ny = len(x_unique), len(y_unique)
        order = np.lexsort((self.fields.x, self.fields.y))
        u2 = self.fields.u[order].reshape(ny, nx)
        v2 = self.fields.v[order].reshape(ny, nx)
        pts = np.column_stack([y, x])
        interp_u = RegularGridInterpolator((y_unique, x_unique), u2, method="linear",
                                           bounds_error=False, fill_value=np.nan)
        interp_v = RegularGridInterpolator((y_unique, x_unique), v2, method="linear",
                                           bounds_error=False, fill_value=np.nan)
        return interp_u(pts), interp_v(pts)

    def compute_validation_errors(self, reference_dir: str = "data/validation/fv",
                                  base_dir=None, save_plots: bool = True) -> Dict[str, float]:
        roots = [("data/validation/fv", ""), ("data/validation/fv-regu", "_regu")]
        if reference_dir not in [r for r, _ in roots]:
            roots.insert(0, (reference_dir, ""))
            roots = list(dict.fromkeys(roots))
        self.validation_error_plots: list = []
        return validation_mod.compute_l2_errors_vs_reference(
            self._evaluate_at_points, self.params.Re,
            Lx=self.params.Lx, Ly=self.params.Ly,
            reference_roots=tuple(roots), base_dir=base_dir,
            heatmap_method=(self.params.method or self.params.name)
            if save_plots else None,
            heatmap_paths=self.validation_error_plots,
        )

    def validation_table(self, base_dir=None):
        return validation_mod.botella_validation_rows(self.metrics, self.params.Re,
                                                      base_dir=base_dir)

    def saad_table(self, base_dir=None):
        grid = f"{self.params.nx}x{self.params.ny}"
        return validation_mod.saad_quantities_rows(self.metrics, self.params.Re,
                                                   grid, base_dir=base_dir)

    # ------------------------------------------------------------------
    # Export
    # ------------------------------------------------------------------

    def to_vtk_payload(self):
        """(points, point_data, field_data, dims) in the reference VTS layout."""
        f = self.fields
        x_unique = np.sort(np.unique(f.x))
        y_unique = np.sort(np.unique(f.y))
        nx, ny = len(x_unique), len(y_unique)
        order = np.lexsort((f.x, f.y))
        U = f.u[order].reshape(ny, nx)
        V = f.v[order].reshape(ny, nx)
        P = f.p[order].reshape(ny, nx)

        X, Y = np.meshgrid(x_unique, y_unique)
        # pyvista point order for meshgrid input: Fortran ravel of (ny, nx)
        def frav(a):
            return np.asarray(a).ravel("F")

        points = np.column_stack([frav(X), frav(Y), np.zeros(nx * ny)])
        vort = self._vorticity_for_export(U, V, x_unique, y_unique)
        vel = np.zeros((nx * ny, 3))
        vel[:, 0] = frav(U)
        vel[:, 1] = frav(V)
        point_data = {
            "u": frav(U),
            "v": frav(V),
            "pressure": frav(P),
            "velocity_magnitude": frav(np.sqrt(U**2 + V**2)),
            "vorticity": frav(vort),
            "velocity": vel,
        }
        field_data = {
            "Re": np.array([int(self.params.Re)], dtype=np.int64),
            "N": np.array([int(self.params.nx)], dtype=np.int64),
            "solver": str(self.params.name),
        }
        return points, point_data, field_data, (ny, nx, 1)

    def _vorticity_for_export(self, U, V, x, y):
        """Smooth spline derivatives for export (base.py:524-549 default)."""
        from scipy.interpolate import RectBivariateSpline

        U_s = RectBivariateSpline(y, x, U)
        V_s = RectBivariateSpline(y, x, V)
        return V_s(y, x, dx=1) - U_s(y, x, dy=1)

    def save_vtk(self, filepath) -> None:
        points, pdata, fdata, dims = self.to_vtk_payload()
        vts_mod.write_vts(filepath, points, pdata, fdata, dims)
        log.info("Saved VTS to %s", filepath)

    def save(self, filepath) -> None:
        """Persist params/metrics/time-series/fields to HDF5 (base.py:332-353).

        Uses h5py groups (pytables is not in this image); layout is one group
        per table with one dataset per column.
        """
        import h5py

        filepath = Path(filepath)
        filepath.parent.mkdir(parents=True, exist_ok=True)
        with h5py.File(filepath, "w") as h5:
            for group, df in (
                ("params", self.params.to_dataframe()),
                ("metrics", self.metrics.to_dataframe()),
                ("time_series", self.time_series.to_dataframe()
                 if self.time_series else None),
                ("fields", self.fields.to_dataframe() if self.fields else None),
            ):
                if df is None:
                    continue
                g = h5.create_group(group)
                for col in df.columns:
                    vals = df[col].to_numpy()
                    if vals.dtype == object:
                        vals = vals.astype("S")
                    g.create_dataset(col, data=vals)
