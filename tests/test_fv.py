"""End-to-end and unit tests of the FV-SIMPLE solver."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from anap3_tpu.models.params import FVParameters
from anap3_tpu.models.fv import FVSolver, FVState, build_fv_ops, fv_step
from anap3_tpu.ops import fv_stencils as st


def make_params(**over):
    base = dict(
        name="fv",
        Re=100.0,
        nx=24,
        ny=24,
        convection_scheme="TVD",
        limiter="MUSCL",
        alpha_uv=0.4,
        alpha_p=0.2,
        linear_solver_tol=1e-9,
        tolerance=1e-6,
        max_iterations=5000,
        corner_treatment="none",
        dtype="float64",
    )
    base.update(over)
    return FVParameters(**base)


class TestStencils:
    def test_gradient_linear_field_interior(self):
        ny, nx = 8, 10
        dx, dy = 0.1, 0.2
        x = (np.arange(nx) + 0.5) * dx
        y = (np.arange(ny) + 0.5) * dy
        X, Y = np.meshgrid(x, y)
        phi = jnp.asarray(2.0 * X + 3.0 * Y)
        gx, gy = st.cell_gradient(phi, dx, dy, use_limiter=False, pin_cell0=False)
        np.testing.assert_allclose(np.asarray(gx), 2.0, atol=1e-12)
        np.testing.assert_allclose(np.asarray(gy), 3.0, atol=1e-12)

    def test_gradient_pin_cell0(self):
        phi = jnp.asarray(np.random.default_rng(0).normal(size=(6, 6)))
        gx, gy = st.cell_gradient(phi, 0.1, 0.1, use_limiter=False, pin_cell0=True)
        assert float(gx[0, 0]) == 0.0 and float(gy[0, 0]) == 0.0
        # neighbor (0,1) must use a one-sided east difference (cell 0 excluded)
        expect = (float(phi[0, 2]) - float(phi[0, 1])) / 0.1
        assert float(gx[0, 1]) == pytest.approx(expect)

    def test_limiter_caps_overshoot(self):
        # step field: unlimited central gradient overshoots neighbor extrema
        phi = jnp.asarray(np.array([[0.0, 0.0, 1.0, 1.0]] * 4))
        gx_l, _ = st.cell_gradient(phi, 1.0, 1.0, use_limiter=True, pin_cell0=False)
        gx_u, _ = st.cell_gradient(phi, 1.0, 1.0, use_limiter=False, pin_cell0=False)
        assert np.all(np.abs(np.asarray(gx_l)) <= np.abs(np.asarray(gx_u)) + 1e-14)

    def test_divergence_of_uniform_flux_is_zero_inside(self):
        ny, nx = 5, 7
        mx = jnp.ones((ny, nx - 1))
        my = jnp.zeros((ny - 1, nx))
        div = np.asarray(st.divergence_from_fluxes(mx, my))
        np.testing.assert_allclose(div[:, 1:-1], 0.0, atol=1e-14)
        np.testing.assert_allclose(div[:, 0], 1.0)    # inflow face missing
        np.testing.assert_allclose(div[:, -1], -1.0)

    def test_momentum_operator_matches_dense(self):
        """Matrix-free stencil apply == dense assembly of the same coefficients."""
        rng = np.random.default_rng(3)
        ny, nx = 5, 6
        mx = jnp.asarray(rng.normal(size=(ny, nx - 1)))
        my = jnp.asarray(rng.normal(size=(ny - 1, nx)))
        mu, dx, dy = 0.02, 1.0 / nx, 1.0 / ny
        bc0x, bc0y = jnp.zeros(ny), jnp.zeros(nx)
        c = st.momentum_coefficients(mx, my, mu, dx, dy, bc0x, bc0x, bc0y, bc0y)
        phi = jnp.asarray(rng.normal(size=(ny, nx)))
        out = np.asarray(st.apply_momentum_operator(c, phi))

        # dense reference
        n = ny * nx
        A = np.zeros((n, n))
        aP, aE, aW, aN, aS = map(np.asarray, (c.aP, c.aE, c.aW, c.aN, c.aS))
        for j in range(ny):
            for i in range(nx):
                r = j * nx + i
                A[r, r] = aP[j, i]
                if i + 1 < nx:
                    A[r, r + 1] = aE[j, i]
                if i > 0:
                    A[r, r - 1] = aW[j, i]
                if j + 1 < ny:
                    A[r, r + nx] = aN[j, i]
                if j > 0:
                    A[r, r - nx] = aS[j, i]
        ref = (A @ np.asarray(phi).ravel()).reshape(ny, nx)
        np.testing.assert_allclose(out, ref, atol=1e-12)

    def test_row_sum_property_no_flow(self):
        """With zero mdot, interior row sums vanish (pure diffusion stencil)."""
        ny = nx = 6
        mx = jnp.zeros((ny, nx - 1))
        my = jnp.zeros((ny - 1, nx))
        c = st.momentum_coefficients(mx, my, 0.01, 1.0 / nx, 1.0 / ny,
                                     jnp.zeros(ny), jnp.zeros(ny),
                                     jnp.zeros(nx), jnp.zeros(nx))
        rowsum = np.asarray(c.aP + c.aE + c.aW + c.aN + c.aS)
        np.testing.assert_allclose(rowsum[1:-1, 1:-1], 0.0, atol=1e-13)


class TestSolve:
    @pytest.fixture(scope="class")
    def solved(self):
        solver = FVSolver(params=make_params())
        solver.solve()
        return solver

    def test_converges(self, solved):
        assert solved.metrics.converged
        assert solved.metrics.final_residual < 1e-6

    def test_ghia_centerline_re100(self, solved, repo_root):
        ghia = np.loadtxt(repo_root / "data/validation/ghia/"
                          "ghia_Re100_u_centerline.csv",
                          delimiter=",", skiprows=1)
        u_c, _ = solved._evaluate_at_points(
            np.full(len(ghia), 0.5), ghia[:, 0])
        valid = ~np.isnan(u_c)
        err = np.max(np.abs(u_c[valid] - ghia[valid, 1]))
        assert err < 0.015

    def test_primary_vortex(self, solved):
        m = solved.metrics
        assert m.psi_min == pytest.approx(-0.1034, abs=0.02)
        assert m.psi_min_x == pytest.approx(0.6188, abs=0.08)
        assert m.psi_min_y == pytest.approx(0.7344, abs=0.08)

    def test_divergence_free(self, solved):
        # SIMPLE's mass imbalance at the relative-iterate tolerance scales with
        # alpha_p * ||p'||; ~5e-5 at tol=1e-6 on this grid.
        assert solved.metrics.continuity_residual < 2e-4

    def test_l2_vs_reference_fixture(self, solved, repo_root):
        errs = solved.compute_validation_errors(base_dir=repo_root)
        # N=24 vs the stored N=128 truth: pure truncation difference
        assert 0 < errs["u_L2_error"] < 0.12
        assert 0 < errs["v_L2_error"] < 0.12


class TestVariants:
    def test_upwind_converges(self):
        solver = FVSolver(params=make_params(
            nx=12, ny=12, convection_scheme="Upwind", tolerance=1e-5,
            max_iterations=2000))
        solver.solve()
        assert solver.metrics.converged

    def test_corner_smoothing_lid(self):
        ops, _ = build_fv_ops(make_params(nx=12, ny=12,
                                          corner_treatment="smoothing",
                                          corner_smoothing=0.2))
        bc = np.asarray(ops.bc_u_n)
        assert bc[0] < 0.5 and abs(bc[6] - 1.0) < 1e-12

    @pytest.mark.slow  # ~70 s on the 1-core host (two f64 bicgstab compiles)
    def test_vmap_over_reynolds(self):
        """A batch of Re lanes must match per-lane solves (sweep correctness)."""
        nx = ny = 10
        states = []
        opses = []
        for Re in (50.0, 150.0):
            ops, _ = build_fv_ops(make_params(nx=nx, ny=ny, Re=Re))
            opses.append(ops)
            states.append(FVState(
                u=jnp.zeros((ny, nx)), v=jnp.zeros((ny, nx)),
                p=jnp.zeros((ny, nx)), mx=jnp.zeros((ny, nx - 1)),
                my=jnp.zeros((ny - 1, nx))))
        batched_ops = jax.tree.map(lambda *a: jnp.stack(a), *opses)
        batched_state = jax.tree.map(lambda *a: jnp.stack(a), *states)

        def one(ops, state):
            for _ in range(3):
                state, m = fv_step(ops, state)
            return state

        out_b = jax.vmap(one)(batched_ops, batched_state)
        for k, (ops, state) in enumerate(zip(opses, states)):
            out = one(ops, state)
            np.testing.assert_allclose(np.asarray(out_b.u[k]), np.asarray(out.u),
                                       rtol=1e-9, atol=1e-12)


class TestFloat32Mode:
    """float32 FV: clamped linear tolerance + refined pressure solve."""

    def test_f32_matches_f64_solution(self):
        s64 = FVSolver(params=make_params(nx=24, ny=24, max_iterations=8000))
        s64.solve()
        s32 = FVSolver(params=make_params(nx=24, ny=24, max_iterations=8000,
                                          dtype="float32"))
        s32.solve()
        assert s64.metrics.converged and s32.metrics.converged
        u64, u32 = np.asarray(s64.state.u), np.asarray(s32.state.u)
        v64, v32 = np.asarray(s64.state.v), np.asarray(s32.state.v)
        assert np.linalg.norm(u32 - u64) / np.linalg.norm(u64) < 2e-4
        assert np.linalg.norm(v32 - v64) / np.linalg.norm(v64) < 2e-4

    def test_f32_lin_tol_clamped(self):
        ops, _ = build_fv_ops(make_params(dtype="float32"))
        assert ops.lin_tol >= 1e-6  # 10 ulp of f32
        assert ops.n_refine == 1
        ops64, _ = build_fv_ops(make_params(dtype="float64"))
        assert ops64.lin_tol == 1e-9
        assert ops64.n_refine == 0

    def test_auto_dtype_resolves_by_backend(self):
        """``auto`` is float64 on every backend, and the state computes in
        the dtype the parameters report."""
        from anap3_tpu.models.params import resolve_dtype

        assert resolve_dtype("auto") == "float64"
        assert resolve_dtype("float32") == "float32"
        s = FVSolver(params=make_params(dtype="auto", max_iterations=1))
        assert s.params.dtype == "float64"
        assert s.state.u.dtype == jnp.float64


class TestSolverFlags:
    def test_spatial_mesh_support_flags(self):
        from anap3_tpu.models.spectral import FSGSolver, SGSolver
        from anap3_tpu.models.spectral_vmg import FMGSolver, VMGSolver

        assert SGSolver.SUPPORTS_SPATIAL_MESH
        assert not FSGSolver.SUPPORTS_SPATIAL_MESH
        assert not VMGSolver.SUPPORTS_SPATIAL_MESH
        assert not FMGSolver.SUPPORTS_SPATIAL_MESH

    def test_stall_chunks_resume_allowed(self, tmp_path):
        """Changing stall_chunks is run-control: resume must be allowed."""
        from anap3_tpu.utils.checkpoint import CheckpointManager
        from anap3_tpu.models import spectral_sg as core
        from anap3_tpu.models.params import SpectralParameters

        p1 = SpectralParameters(nx=12, ny=12, stall_chunks=-1)
        p2 = SpectralParameters(nx=12, ny=12, stall_chunks=50)
        ops, _ = core.build_spectral_ops(p1)
        state = core.initial_state(ops)
        CheckpointManager(tmp_path, params=p1, every_chunks=1).maybe_save(
            state, 10)
        _, it = CheckpointManager(tmp_path, params=p2,
                                  every_chunks=1).restore_or(state)
        assert it == 10
