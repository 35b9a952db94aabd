"""End-to-end tests of the single-grid spectral solver."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from anap3_tpu.models.params import SpectralParameters
from anap3_tpu.models.spectral import SGSolver
from anap3_tpu.models import spectral_sg as core


def make_params(**over):
    base = dict(
        name="spectral",
        Re=100.0,
        nx=16,
        ny=16,
        basis_type="chebyshev",
        CFL=1.5,
        beta_squared=5.0,
        corner_treatment="smoothing",
        corner_smoothing=0.15,
        tolerance=1e-6,
        max_iterations=18000,
        dtype="float64",
    )
    base.update(over)
    return SpectralParameters(**base)


class TestStep:
    def test_bc_enforcement(self):
        ops, grid = core.build_spectral_ops(make_params())
        state = core.initial_state(ops)
        u = np.asarray(state.u)
        # lid profile on top (y = Ly edge, second index), zero on other walls
        assert np.allclose(u[:, 0], 0.0)
        assert np.allclose(u[0, 1:-1], 0.0)
        assert np.allclose(u[-1, 1:-1], 0.0)
        x = grid["x_nodes"]
        mid = np.argmin(np.abs(x - 0.5))
        assert u[mid, -1] == pytest.approx(1.0)
        assert u[0, -1] == pytest.approx(0.0)  # smoothed corners

    def test_step_preserves_bc_and_is_finite(self):
        ops, _ = core.build_spectral_ops(make_params())
        state = core.initial_state(ops)
        for _ in range(5):
            state, m = jax.jit(core.sg_step)(ops, state)
        u = np.asarray(state.u)
        assert np.all(np.isfinite(u))
        assert np.allclose(u[:, 0], 0.0)
        assert np.isfinite(float(m["energy"]))

    def test_jit_matches_eager(self):
        ops, _ = core.build_spectral_ops(make_params())
        state = core.initial_state(ops)
        s_j, _ = jax.jit(core.sg_step)(ops, state)
        s_e, _ = core.sg_step(ops, state)
        np.testing.assert_allclose(np.asarray(s_j.u), np.asarray(s_e.u),
                                   rtol=1e-12, atol=1e-14)

    def test_residual_of_polynomial_field(self):
        """Residual operator sanity: for u=v=0, p polynomial, R_u = -dp/dx."""
        ops, grid = core.build_spectral_ops(make_params())
        x_in = grid["x_nodes"][1:-1]
        Xi, Yi = np.meshgrid(x_in, x_in, indexing="ij")
        p = jnp.asarray(Xi**2 * Yi)
        z = jnp.zeros(grid["shape_full"])
        R_u, R_v, R_p = core.residuals(ops, z, z, p)
        X, Y = np.meshgrid(grid["x_nodes"], grid["x_nodes"], indexing="ij")
        np.testing.assert_allclose(np.asarray(R_u), -2 * X * Y, atol=1e-8)
        np.testing.assert_allclose(np.asarray(R_v), -(X**2), atol=1e-8)
        np.testing.assert_allclose(np.asarray(R_p), 0.0, atol=1e-10)


class TestSolve:
    @pytest.fixture(scope="class")
    def solved(self):
        solver = SGSolver(params=make_params(tolerance=2e-6))
        solver.solve()
        return solver

    def test_converges(self, solved):
        assert solved.metrics.converged
        assert solved.metrics.iterations > 100
        assert solved.metrics.final_residual < 2e-6

    def test_primary_vortex_near_botella_re100(self, solved):
        # Botella/literature Re=100: psi_min ~ -0.1034 at (0.6188, 0.7344).
        # Smoothed lid + N=24 gives a few percent agreement.
        m = solved.metrics
        assert m.psi_min == pytest.approx(-0.1034, abs=1.2e-2)
        assert m.psi_min_x == pytest.approx(0.6188, abs=0.08)
        assert m.psi_min_y == pytest.approx(0.7344, abs=0.08)

    def test_energy_reasonable(self, solved):
        assert 0.01 < solved.metrics.final_energy < 0.1

    def test_ghia_centerline_re100(self, solved, repo_root):
        ghia = np.loadtxt(repo_root / "data/validation/ghia/"
                          "ghia_Re100_u_centerline.csv",
                          delimiter=",", skiprows=1)
        u_c, _ = solved._evaluate_at_points(
            np.full(len(ghia), 0.5), ghia[:, 0])
        err = np.max(np.abs(u_c - ghia[:, 1]))
        assert err < 0.06  # smoothed-lid vs sharp-lid difference bound

    def test_fields_and_vts_export(self, solved, tmp_path):
        solved.save_vtk(tmp_path / "sol.vts")
        from anap3_tpu.utils.vts import read_vts

        g = read_vts(tmp_path / "sol.vts")
        assert g.point_data["u"].shape == (17 * 17,)
        assert abs(g.point_data["u"]).max() <= 1.0 + 1e-6
        assert g.field_data["solver"] == "spectral"

    def test_hdf5_save(self, solved, tmp_path):
        solved.save(tmp_path / "state.h5")
        import h5py

        with h5py.File(tmp_path / "state.h5") as h5:
            assert "fields/u" in h5
            assert h5["metrics/converged"][0] == 1


class TestRunnerSemantics:
    def test_frozen_after_convergence_matches_python_loop(self):
        """Chunked scan with freezing must give the same iteration count as a
        per-step Python loop with immediate break."""
        params = make_params(nx=12, ny=12, tolerance=1e-3, max_iterations=3000)
        ops, _ = core.build_spectral_ops(params)

        # Python reference loop
        state = core.initial_state(ops)
        u_prev, v_prev = state.u, state.v
        it_py = None
        step = jax.jit(core.sg_step)
        for i in range(3000):
            state, _ = step(ops, state)
            rel = max(
                float(jnp.linalg.norm(state.u - u_prev)
                      / (jnp.linalg.norm(u_prev) + 1e-12)),
                float(jnp.linalg.norm(state.v - v_prev)
                      / (jnp.linalg.norm(v_prev) + 1e-12)),
            )
            u_prev, v_prev = state.u, state.v
            if i >= 10 and rel < 1e-3:
                it_py = i + 1
                break

        solver = SGSolver(params=params)
        solver.solve()
        assert solver.metrics.iterations == it_py


class TestLegendreBasis:
    def test_sg_converges_with_legendre(self):
        solver = SGSolver(params=make_params(basis_type="legendre",
                                             nx=12, ny=12, tolerance=1e-4,
                                             max_iterations=6000))
        solver.solve()
        assert solver.metrics.converged
        assert solver.metrics.psi_min == pytest.approx(-0.103, abs=0.02)


class TestResidualConvergence:
    def test_residual_criterion_reaches_reduction(self):
        """The residual criterion stops when max(||R_u||,||R_v||) drops by the
        requested factor relative to the warmup iteration."""
        solver = SGSolver(params=make_params(
            nx=12, ny=12, tolerance=1e-3, max_iterations=20000,
            convergence_metric="residual", chunk_size=500))
        solver.solve()
        assert solver.metrics.converged
        hist = solver.time_series.continuity_residual
        assert hist[-1] / hist[0] < 1e-3


class TestEnergyConvergence:
    def test_energy_plateau_stops_synthetic_drift(self):
        """A state that keeps moving (rel_iter never below tol) but whose
        energy plateaus must converge under the energy metric, at the first
        chunk boundary where |dE| <= tol * |E|."""
        from anap3_tpu.models.runner import run_fixed_point

        def step(s):
            k = s["k"]
            # constant-norm drift; energy approaches 1.0 geometrically
            energy = 1.0 - 0.5 ** (k.astype(jnp.float32) / 50.0)
            zero = jnp.asarray(0.0, jnp.float32)
            m = {"u_eq": zero, "v_eq": zero, "continuity": zero + 1.0,
                 "energy": energy, "enstrophy": zero, "palinstrophy": zero}
            return {"k": k + 1, "x": s["x"] + 1.0}, m

        init = {"k": jnp.asarray(0, jnp.int32),
                "x": jnp.asarray(1.0, jnp.float32)}
        res = run_fixed_point(
            step, lambda s: (s["x"][None], s["x"][None]), init,
            tolerance=1e-6, max_iterations=100000, chunk=100,
            convergence_metric="energy")
        assert res.converged and not res.diverged
        # dE per 100-step chunk falls below 1e-6 around k ~ 3.3k steps
        assert 500 < res.iterations < 20000
        e = res.history["energy"]
        assert abs(e[-1] - e[-101]) <= 2e-6

    def test_plateau_window_override_delays_exit(self):
        """energy_plateau_chunks stretches the consecutive-chunk window:
        the same synthetic drift converges strictly later (more plateaued
        chunks consumed) under a larger window, never earlier."""
        from anap3_tpu.models.runner import run_fixed_point

        def step(s):
            k = s["k"]
            energy = 1.0 - 0.5 ** (k.astype(jnp.float32) / 50.0)
            zero = jnp.asarray(0.0, jnp.float32)
            m = {"u_eq": zero, "v_eq": zero, "continuity": zero + 1.0,
                 "energy": energy, "enstrophy": zero, "palinstrophy": zero}
            return {"k": k + 1, "x": s["x"] + 1.0}, m

        def run(window):
            init = {"k": jnp.asarray(0, jnp.int32),
                    "x": jnp.asarray(1.0, jnp.float32)}
            return run_fixed_point(
                step, lambda s: (s["x"][None], s["x"][None]), init,
                tolerance=1e-6, max_iterations=100000, chunk=100,
                convergence_metric="energy", energy_plateau_chunks=window)

        base, wide = run(None), run(12)
        assert base.converged and wide.converged
        # default window is ENERGY_PLATEAU_CHUNKS=3; widening to 12 must
        # consume at least 9 more plateaued chunks of 100 steps
        assert wide.iterations >= base.iterations + 900

    def test_net_drift_gate_rejects_slow_monotone_drift(self):
        """A drift of 0.8x the per-chunk budget passes every per-chunk
        flatness test but accumulates linearly across the window — the
        net-drift gate must keep integrating until the drift actually
        ends (regression: FSG N=320 exited at E=0.0385 vs the 0.0396
        steady value through the per-chunk-only test)."""
        from anap3_tpu.models.runner import run_fixed_point

        tol, chunk, drift_until = 1e-4, 100, 40000

        def step(s):
            k = s["k"]
            # per-chunk dE = 0.8 * tol * E while drifting, then exactly 0
            rate = jnp.where(k < drift_until, 0.8 * tol / chunk, 0.0)
            energy = s["e"] * (1.0 + rate)
            zero = jnp.asarray(0.0, jnp.float32)
            m = {"u_eq": zero, "v_eq": zero, "continuity": zero + 1.0,
                 "energy": energy, "enstrophy": zero, "palinstrophy": zero}
            return {"k": k + 1, "e": energy, "x": s["x"] + 1.0}, m

        init = {"k": jnp.asarray(0, jnp.int32),
                "e": jnp.asarray(1.0, jnp.float32),
                "x": jnp.asarray(1.0, jnp.float32)}
        res = run_fixed_point(
            step, lambda s: (s["x"][None], s["x"][None]), init,
            tolerance=tol, max_iterations=100000, chunk=chunk,
            convergence_metric="energy", energy_plateau_chunks=8)
        assert res.converged
        # without the net gate the 8-chunk window closes at ~900 steps;
        # the gate must hold out until the drift stops
        assert res.iterations >= drift_until

    def test_scaled_plateau_chunks(self):
        """N^2 scaling anchored at (96, 6000 steps), floored at the anchor
        window and at ENERGY_PLATEAU_CHUNKS, rounded up to whole chunks."""
        from anap3_tpu.models.runner import ENERGY_PLATEAU_CHUNKS
        from anap3_tpu.models.spectral import scaled_plateau_chunks

        # at/below the anchor N the window is the anchor window
        assert scaled_plateau_chunks(96, 2000) == ENERGY_PLATEAU_CHUNKS
        assert scaled_plateau_chunks(12, 2000) == ENERGY_PLATEAU_CHUNKS
        # N=192 doubles dt resolution -> 4x the steps: 24000/2000 = 12
        assert scaled_plateau_chunks(192, 2000) == 12
        # N=320: 6000*(320/96)^2 = 66667 steps -> ceil(/2000) = 34
        assert scaled_plateau_chunks(320, 2000) == 34
        # chunk granularity: same window, smaller chunks -> more of them
        assert scaled_plateau_chunks(192, 500) == 48
        # cycle-anchored variant (VMG): 150*(320/192)^2 / 50 -> 9
        assert scaled_plateau_chunks(
            320, 50, anchor_n=192, anchor_window=150) == 9

    def test_energy_criterion_sg_matches_rel_iter_solution(self):
        sg_ref = SGSolver(params=make_params(nx=12, ny=12, tolerance=1e-6,
                                             max_iterations=30000,
                                             chunk_size=500))
        sg_ref.solve()
        sg_e = SGSolver(params=make_params(
            nx=12, ny=12, tolerance=1e-7, max_iterations=30000,
            convergence_metric="energy", chunk_size=500))
        sg_e.solve()
        assert sg_e.metrics.converged
        np.testing.assert_allclose(np.asarray(sg_e.state.u),
                                   np.asarray(sg_ref.state.u), atol=1e-3)

    def test_factory_receives_mapped_criterion(self):
        """Fused-runner factories must get the MAPPED criterion from
        run_fixed_point (energy -> rel_iter @ tolerance 0), so no custom
        runner can self-converge on the criterion the user opted out of
        (regression: the sharded path once bypassed the mapping)."""
        from anap3_tpu.models.runner import make_chunk_runner, run_fixed_point

        params = make_params(nx=12, ny=12)
        ops, _ = core.build_spectral_ops(params)
        seen = {}

        def factory(chunk, tol_, metric_):
            seen["tol"] = tol_
            seen["metric"] = metric_
            return make_chunk_runner(lambda s: core.sg_step(ops, s),
                                     lambda s: (s.u, s.v), chunk, tol_, 10,
                                     metric_)

        run_fixed_point(
            None, lambda s: (s.u, s.v), core.initial_state(ops),
            tolerance=1e-4, max_iterations=600, chunk=200,
            convergence_metric="energy", chunk_runner=factory)
        assert seen == {"tol": 0.0, "metric": "rel_iter"}

    def test_unknown_metric_rejected(self):
        from anap3_tpu.models.runner import run_fixed_point

        with pytest.raises(ValueError, match="convergence_metric"):
            run_fixed_point(lambda s: (s, {}), lambda s: (s, s),
                            jnp.zeros(3), tolerance=1e-6, max_iterations=10,
                            convergence_metric="bogus")

    def test_auto_metric_resolution(self):
        """'auto' -> energy at N>=128 (measured rel-iter false-convergence
        threshold), rel_iter below; explicit values pass through; VMG/FV
        opt out via auto_large."""
        from anap3_tpu.models.params import SpectralParameters
        from anap3_tpu.models.spectral import resolve_convergence_metric

        mk = lambda n, m="auto": SpectralParameters(
            Re=1000.0, nx=n, ny=n, convergence_metric=m)
        assert resolve_convergence_metric(mk(96)) == "rel_iter"
        assert resolve_convergence_metric(mk(127)) == "rel_iter"
        assert resolve_convergence_metric(mk(128)) == "energy"
        assert resolve_convergence_metric(mk(256)) == "energy"
        assert resolve_convergence_metric(mk(192, "rel_iter")) == "rel_iter"
        assert resolve_convergence_metric(mk(64, "energy")) == "energy"
        assert resolve_convergence_metric(
            mk(256), auto_large="rel_iter") == "rel_iter"
        # the runner never sees the unresolved policy value
        from anap3_tpu.models.runner import run_fixed_point

        with pytest.raises(ValueError, match="convergence_metric"):
            run_fixed_point(lambda s: (s, {}), lambda s: (s, s),
                            jnp.zeros(3), tolerance=1e-6, max_iterations=10,
                            convergence_metric="auto")
