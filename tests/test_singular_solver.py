"""Sharp-lid singular-subtraction solver mode (corner_treatment=singular).

Fast tier: operator-construction invariants and the residual decomposition.
Slow tier: the Re=100 N=32 solve that demonstrates the headline claim — the
sharp-lid mode beats the smoothed-lid L2 floor against the stored sharp-lid
FV truth by ~3x and reproduces the Ghia/Botella primary vortex.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from anap3_tpu.models.params import SpectralParameters
from anap3_tpu.models import spectral_sg as core
from anap3_tpu.models.spectral import SGSolver
from anap3_tpu.ops.singular import singular_fields_on_grid


def build(n=24, Re=100.0, **kw):
    p = SpectralParameters(Re=Re, nx=n, ny=n, dtype="float64",
                           corner_treatment="singular", **kw)
    return core.build_spectral_ops(p)


class TestSingularOps:
    def test_ops_carry_singular_fields(self):
        ops, grid = build()
        assert ops.sing_u is not None and ops.sing_w is not None
        assert grid["singular"] is not None
        nf = ops.bc_u.shape[0]
        assert ops.sing_u.shape == (nf, nf)
        for name in ("sing_u", "sing_v", "sing_dudx", "sing_dudy",
                     "sing_dvdx", "sing_dvdy", "sing_w", "sing_dwx",
                     "sing_dwy"):
            assert bool(jnp.all(jnp.isfinite(getattr(ops, name)))), name

    def test_smoothed_mode_has_none(self):
        p = SpectralParameters(Re=100.0, nx=16, ny=16)
        ops, grid = core.build_spectral_ops(p)
        assert ops.sing_u is None and grid["singular"] is None

    def test_subtracted_bc_continuous_at_corners(self):
        """The whole point: u_tilde's boundary data has no jump at the top
        corners (the raw sharp lid jumps from U to 0 there)."""
        ops, _ = build()
        bc = np.asarray(ops.bc_u)
        # lid value adjacent to corner B vs wall value adjacent to corner B
        assert bc[-1, -1] == pytest.approx(-1.0, abs=1e-12)  # corner itself
        assert abs(bc[-2, -1] - bc[-1, -1]) < 0.05   # along lid
        assert abs(bc[-1, -2] - bc[-1, -1]) < 0.05   # down the wall
        assert abs(bc[1, -1] - bc[0, -1]) < 0.05     # corner A, along lid
        assert abs(bc[0, -2] - bc[0, -1]) < 0.05     # corner A, down wall
        # v boundary data is nonzero on the side walls now
        assert np.max(np.abs(np.asarray(ops.bc_v))) > 0.01

    def test_residual_decomposition_at_zero_state(self):
        """With u_tilde = 0 the momentum residual reduces to the analytic
        -(u_s . grad) u_s (viscous and pressure terms of the Stokes part
        cancel by construction)."""
        ops, grid = build(n=16)
        nf = ops.bc_u.shape[0]
        z = jnp.zeros((nf, nf), jnp.float64)
        zp = jnp.zeros((nf - 2, nf - 2), jnp.float64)
        R_u, R_v, R_p = core.residuals(ops, z, z, zp)
        S = grid["singular"]
        np.testing.assert_allclose(
            np.asarray(R_u), -(S["u"] * S["dudx"] + S["v"] * S["dudy"]),
            atol=1e-12)
        np.testing.assert_allclose(
            np.asarray(R_v), -(S["u"] * S["dvdx"] + S["v"] * S["dvdy"]),
            atol=1e-12)
        np.testing.assert_allclose(np.asarray(R_p), 0.0, atol=1e-12)

    def test_conserved_quantities_are_totals(self):
        """At u_tilde = 0 the quadratures see exactly the sampled singular
        fields."""
        ops, grid = build(n=16)
        nf = ops.bc_u.shape[0]
        z = jnp.zeros((nf, nf), jnp.float64)
        e, zq, pl = core.conserved_quantities(ops, z, z)
        S = grid["singular"]
        W = np.asarray(ops.W2d)
        assert float(e) == pytest.approx(
            0.5 * np.sum(W * (S["u"] ** 2 + S["v"] ** 2)), rel=1e-12)
        assert float(zq) == pytest.approx(
            0.5 * np.sum(W * S["omega"] ** 2), rel=1e-12)
        assert float(pl) == pytest.approx(
            0.5 * np.sum(W * (S["dwx"] ** 2 + S["dwy"] ** 2)), rel=1e-12)

    def test_sampled_fields_match_module(self):
        ops, grid = build(n=16)
        S = singular_fields_on_grid(grid["x_nodes"], grid["y_nodes"])
        np.testing.assert_allclose(np.asarray(ops.sing_u), S["u"])

    def test_cold_start_floor(self):
        """Calibrated against the measured rest-start brackets:
        Re=400: 16/12, Re=1000: 24/16, Re=3200: 40/-."""
        from anap3_tpu.ops.singular import singular_min_n

        assert 12 < singular_min_n(400) <= 16
        assert 16 < singular_min_n(1000) <= 24
        assert singular_min_n(3200) <= 48
        assert singular_min_n(10000) <= 128  # well inside the fused tiers

    def test_initial_state_is_rest_in_singular_mode(self):
        """Total velocity (u_tilde + u_s) starts at zero in the interior."""
        ops, _ = build(n=24)
        st = core.initial_state(ops)
        total_u = np.asarray(st.u + ops.sing_u)[1:-1, 1:-1]
        total_v = np.asarray(st.v + ops.sing_v)[1:-1, 1:-1]
        np.testing.assert_allclose(total_u, 0.0, atol=1e-12)
        np.testing.assert_allclose(total_v, 0.0, atol=1e-12)

    def test_fsg_hierarchy_respects_singular_floor(self):
        """Below the rest-start floor (16 diverges at Re=1000, measured) the
        singular-mode FSG hierarchy must stop coarsening."""
        from anap3_tpu.models.spectral import FSGSolver
        from anap3_tpu.ops.singular import singular_min_n

        s = FSGSolver(Re=400.0, nx=48, ny=48, corner_treatment="singular",
                      n_levels=3)
        orders = s._level_orders()
        assert min(orders) >= singular_min_n(400) > 12
        assert orders[-1] == 48
        # smoothed-lid hierarchy still coarsens to the reference's N=12
        s2 = FSGSolver(Re=400.0, nx=48, ny=48, n_levels=3)
        assert min(s2._level_orders()) < singular_min_n(400)


class TestSingularSolve:
    def test_small_solve_reaches_physical_vortex(self):
        """N=16 Re=100, loose tolerance: the sharp-lid mode already lands
        near the Ghia/Botella primary vortex (psi_min ~ -0.1034)."""
        s = SGSolver(Re=100.0, nx=16, ny=16, tolerance=1e-5,
                     max_iterations=80_000, dtype="float64",
                     corner_treatment="singular", chunk_size=2000)
        s.solve()
        assert s.metrics.converged
        vort = s.compute_vortex_metrics()
        assert -0.12 < vort["psi_min"] < -0.085
        assert np.isfinite(s.metrics.final_energy)

    def test_singular_fas_supported_on_chebyshev_only(self):
        """Round 4 (VERDICT r3 #3): singular-mode FAS runs on Chebyshev
        hierarchies (nodal-injection defect restriction); non-nested bases
        still fall back to single-grid."""
        from anap3_tpu.models.spectral_vmg import VMGSolver

        cheb = VMGSolver(Re=100.0, nx=48, ny=48, dtype="float32",
                         corner_treatment="singular",
                         basis_type="chebyshev")
        assert not cheb._reject_singular()
        leg = VMGSolver(Re=100.0, nx=48, ny=48, dtype="float32",
                        corner_treatment="singular", basis_type="legendre")
        assert leg._reject_singular()

    def test_singular_levels_use_injection_defect_restriction(self):
        from anap3_tpu.models.spectral_vmg import build_vmg_levels

        p_sing = SpectralParameters(Re=100.0, nx=48, ny=48, dtype="float32",
                                    corner_treatment="singular", n_levels=2,
                                    multigrid="fsg", basis_type="chebyshev")
        levels = build_vmg_levels(p_sing)
        assert [lv.n for lv in levels] == [48, 24]
        assert levels[0].res_full is levels[0].inj_full
        p_smooth = SpectralParameters(Re=100.0, nx=48, ny=48,
                                      dtype="float32", n_levels=2,
                                      multigrid="fsg",
                                      basis_type="chebyshev")
        smooth = build_vmg_levels(p_smooth)
        assert smooth[0].res_full is not smooth[0].inj_full

    @pytest.mark.slow
    def test_vmg_singular_converges_to_newton_state(self):
        """Singular-mode FAS V-cycles (nodal-injection defect restriction)
        converge to the EXACT discrete steady state. The truth is the
        Newton-Krylov solve (f64, ||F||_rms <= 1e-8, seconds at this size)
        rather than a marched SG reference: the singular Re=100 march
        rides a ~400k-step viscous timescale and is still 1.6% short of
        the steady energy after 1.5M steps (measured in float32), so any SG
        budget a test can afford compares two unconverged transients.
        The round-3 restriction bug drifted this config's energy 4.6x off
        (0.159 vs 0.034) — the 0.5%-of-lid max|u| bar discriminates
        decisively. [40,20] puts the coarse level exactly AT the measured
        singular FAS floor (2.0*sqrt(Re))."""
        import jax.numpy as jnp

        from anap3_tpu.models import spectral_sg as score
        from anap3_tpu.models.runner import run_fixed_point
        from anap3_tpu.models.spectral_vmg import (build_vmg_levels,
                                                   make_v_cycle)
        from anap3_tpu.models.steady import NewtonSolver

        ns = NewtonSolver(Re=100.0, nx=40, ny=40,
                          corner_treatment="singular", tolerance=1e-8,
                          basis_type="chebyshev")
        ns.solve()
        assert ns.metrics.converged

        p = SpectralParameters(name="spectral", Re=100.0, nx=40, ny=40,
                               basis_type="chebyshev",
                               corner_treatment="singular", dtype="float32",
                               n_levels=2, multigrid="fsg")
        ops, _ = score.build_spectral_ops(p)
        vc = make_v_cycle(build_vmg_levels(p), 2, 2, 30)
        res = run_fixed_point(vc, lambda s: (s.u, s.v),
                              score.initial_state(ops), tolerance=1e-3,
                              max_iterations=20000, chunk=250,
                              convergence_metric="energy")
        assert res.converged and not res.diverged
        # measured: converges at ~6.3k cycles with E=0.034406 vs Newton's
        # 0.034444, max|du|=0.0016
        assert res.history["energy"][-1] == pytest.approx(
            ns.metrics.final_energy, rel=0.01)
        du = jnp.max(jnp.abs(res.state.u.astype(jnp.float64) - ns.state.u))
        assert float(du) < 5e-3

    @pytest.mark.slow
    def test_beats_smoothed_lid_floor_re100(self):
        """The VERDICT done-bar at Re=100: L2 vs the stored SHARP-lid FV
        truth < 0.05 without smoothing (the smoothed floor is ~0.12), and
        the primary vortex matches Ghia/Botella to well under 1%. Budget-
        bound (the rest start's gentle spin-up keeps the stop criteria
        conservative; the physics lands long before the budget)."""
        s = SGSolver(Re=100.0, nx=32, ny=32, tolerance=1e-7,
                     max_iterations=600_000, dtype="float64",
                     corner_treatment="singular", chunk_size=5000,
                     convergence_metric="energy")
        s.solve()
        errs = s.compute_validation_errors(save_plots=False)
        assert errs["u_L2_error"] < 0.05   # measured: 0.0133
        assert errs["v_L2_error"] < 0.05   # measured: 0.0120
        vort = s.compute_vortex_metrics()
        assert vort["psi_min"] == pytest.approx(-0.1034, rel=0.005)
