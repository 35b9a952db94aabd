"""Tests for vmapped sweep batches and mesh-sharded execution."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from anap3_tpu.models.params import SpectralParameters
from anap3_tpu.models import spectral_sg as core
from anap3_tpu.models.runner import run_fixed_point
from anap3_tpu.parallel import sweep as sweep_mod
from anap3_tpu.parallel import spatial


def make_params(Re, n=12, **over):
    base = dict(name="spectral", Re=Re, nx=n, ny=n, basis_type="chebyshev",
                CFL=1.5, beta_squared=5.0, corner_treatment="smoothing",
                corner_smoothing=0.15, tolerance=1e-4, max_iterations=4000,
                dtype="float64")
    base.update(over)
    return SpectralParameters(**base)


class TestBatchedSweep:
    def test_batch_matches_individual_solves(self):
        """Every lane of a vmapped sweep must land on the same steady state as
        its standalone solve.

        Iteration counts are NOT compared exactly: the relative-iterate
        residual oscillates around the tolerance, so the first crossing is
        sensitive to the last-ulp differences between batched and unbatched
        XLA matmul kernels. The converged physics must agree to tolerance.
        """
        n_fixed = 400  # fixed horizon: trajectory parity, no stopping noise
        res_single = {}
        opses, states = [], []
        for Re in (100.0, 400.0):
            p = make_params(Re)
            ops, _ = core.build_spectral_ops(p)
            state = core.initial_state(ops)
            opses.append(ops)
            states.append(state)
            r = run_fixed_point(lambda s, o=ops: core.sg_step(o, s),
                                lambda s: (s.u, s.v), state,
                                tolerance=1e-14, max_iterations=n_fixed)
            res_single[Re] = r

        batched_ops = sweep_mod.stack_ops(opses)
        batched_states = jax.tree.map(lambda *a: jnp.stack(a), *states)
        res = sweep_mod.run_batched_sweep(
            core.sg_step, lambda s: (s.u, s.v), batched_ops, batched_states,
            tolerance=1e-14, max_iterations=n_fixed, chunk=100)

        for k, Re in enumerate((100.0, 400.0)):
            single = res_single[Re]
            np.testing.assert_allclose(np.asarray(res.states.u[k]),
                                       np.asarray(single.state.u),
                                       rtol=1e-8, atol=1e-10)
            # recorded per-lane histories agree too
            np.testing.assert_allclose(
                res.history["energy"][k][:50],
                np.asarray(single.history["energy"][:50]), rtol=1e-8)

    def test_lane_keeps_its_iteration_across_chunks(self):
        """A lane that converges chunks before the slowest one stays frozen
        at its own convergence iteration (done/conv_iter carry over chunk
        boundaries) instead of stepping again and reporting the batch's
        total."""
        opses, states, singles = [], [], []
        for Re in (100.0, 400.0):
            p = make_params(Re, tolerance=1e-4)
            ops, _ = core.build_spectral_ops(p)
            state = core.initial_state(ops)
            opses.append(ops)
            states.append(state)
            singles.append(run_fixed_point(
                lambda s, o=ops: core.sg_step(o, s), lambda s: (s.u, s.v),
                state, tolerance=1e-4, max_iterations=4000, chunk=50))
        res = sweep_mod.run_batched_sweep(
            core.sg_step, lambda s: (s.u, s.v), sweep_mod.stack_ops(opses),
            jax.tree.map(lambda *a: jnp.stack(a), *states),
            tolerance=1e-4, max_iterations=4000, chunk=50)
        its = [int(r.iterations) for r in singles]
        assert all(r.converged for r in singles) and res.converged.all()
        assert abs(its[0] - its[1]) > 100  # the lanes finish chunks apart
        for k in range(2):
            assert abs(int(res.iterations[k]) - its[k]) <= 2
            np.testing.assert_allclose(np.asarray(res.states.u[k]),
                                       np.asarray(singles[k].state.u),
                                       rtol=1e-8, atol=1e-10)

    def test_energy_criterion_per_lane(self):
        """Batched sweeps support the kinetic-energy plateau: each lane's
        convergence matches its single-run energy-criterion solve."""
        opses, states, singles = [], [], {}
        for Re in (100.0, 400.0):
            p = make_params(Re, tolerance=1e-6, max_iterations=20000)
            ops, _ = core.build_spectral_ops(p)
            state = core.initial_state(ops)
            opses.append(ops)
            states.append(state)
            singles[Re] = run_fixed_point(
                lambda s, o=ops: core.sg_step(o, s), lambda s: (s.u, s.v),
                state, tolerance=1e-6, max_iterations=20000, chunk=200,
                convergence_metric="energy")

        res = sweep_mod.run_batched_sweep(
            core.sg_step, lambda s: (s.u, s.v), sweep_mod.stack_ops(opses),
            jax.tree.map(lambda *a: jnp.stack(a), *states),
            tolerance=1e-6, max_iterations=20000, chunk=200,
            convergence_metric="energy")
        assert res.converged.all()
        assert not res.diverged.any()
        for k, Re in enumerate((100.0, 400.0)):
            single = singles[Re]
            assert single.converged
            # same plateau test at the same chunk cadence -> identical
            # recorded convergence iteration, physics to tolerance
            assert int(res.iterations[k]) == int(single.iterations)
            np.testing.assert_allclose(np.asarray(res.states.u[k]),
                                       np.asarray(single.state.u), atol=1e-5)

    def test_singular_mode_lanes_batch(self):
        """Sweep lanes in corner_treatment=singular mode vmap correctly:
        the nine optional constant fields stack like any other ops leaf
        and each lane matches its standalone singular solve."""
        n_fixed = 200
        opses, states, singles = [], [], []
        for Re in (100.0, 200.0):
            p = make_params(Re, n=16, corner_treatment="singular")
            ops, _ = core.build_spectral_ops(p)
            state = core.initial_state(ops)
            opses.append(ops)
            states.append(state)
            r = run_fixed_point(lambda s, o=ops: core.sg_step(o, s),
                                lambda s: (s.u, s.v), state,
                                tolerance=1e-14, max_iterations=n_fixed)
            singles.append(r)

        batched_ops = sweep_mod.stack_ops(opses)
        assert batched_ops.sing_u.shape[0] == 2  # stacked, not None
        batched_states = jax.tree.map(lambda *a: jnp.stack(a), *states)
        res = sweep_mod.run_batched_sweep(
            core.sg_step, lambda s: (s.u, s.v), batched_ops, batched_states,
            tolerance=1e-14, max_iterations=n_fixed, chunk=50)
        for k in range(2):
            np.testing.assert_allclose(np.asarray(res.states.u[k]),
                                       np.asarray(singles[k].state.u),
                                       rtol=1e-8, atol=1e-10)

    def test_diverged_lane_isolation(self):
        """A NaN lane must freeze without corrupting healthy lanes."""
        good = make_params(100.0)
        bad = make_params(100.0, CFL=50.0)  # wildly unstable
        opses = []
        states = []
        for p in (good, bad):
            ops, _ = core.build_spectral_ops(p)
            opses.append(ops)
            states.append(core.initial_state(ops))
        batched_ops = sweep_mod.stack_ops(opses)
        batched_states = jax.tree.map(lambda *a: jnp.stack(a), *states)
        res = sweep_mod.run_batched_sweep(
            core.sg_step, lambda s: (s.u, s.v), batched_ops, batched_states,
            tolerance=1e-4, max_iterations=3000, chunk=100)
        assert res.converged[0] and not res.diverged[0]
        assert res.diverged[1]
        assert np.all(np.isfinite(np.asarray(res.states.u[0])))

    def test_sweep_sharded_over_mesh(self):
        """Batch axis sharded over an 8-device mesh still matches."""
        devs = jax.devices()
        if len(devs) < 8:
            pytest.skip("needs 8 virtual devices")
        mesh = Mesh(np.array(devs[:8]), ("sweep",))
        opses, states = [], []
        for k in range(8):
            p = make_params(100.0 + 50.0 * k)
            ops, _ = core.build_spectral_ops(p)
            opses.append(ops)
            states.append(core.initial_state(ops))
        batched_ops = sweep_mod.stack_ops(opses)
        batched_states = jax.tree.map(lambda *a: jnp.stack(a), *states)
        res = sweep_mod.run_batched_sweep(
            core.sg_step, lambda s: (s.u, s.v), batched_ops, batched_states,
            tolerance=1e-14, max_iterations=300, chunk=100, mesh=mesh)
        # lane 0 equals a non-sharded standalone run over the same horizon
        p0 = make_params(100.0)
        ops0, _ = core.build_spectral_ops(p0)
        r0 = run_fixed_point(lambda s: core.sg_step(ops0, s),
                             lambda s: (s.u, s.v), core.initial_state(ops0),
                             tolerance=1e-14, max_iterations=300)
        np.testing.assert_allclose(np.asarray(res.states.u[0]),
                                   np.asarray(r0.state.u), rtol=1e-8,
                                   atol=1e-10)


class TestSpatialSharding:
    def test_sharded_step_matches_reference(self):
        devs = jax.devices()
        if len(devs) < 4:
            pytest.skip("needs 4 virtual devices")
        mesh = Mesh(np.array(devs[:4]).reshape(1, 4), ("sweep", "x"))
        n = 15  # nf = 16 divisible by 4
        p = make_params(100.0, n=n, dtype="float64")
        sh_ops, grid = spatial.build_sharded_ops(p, dtype=jnp.float64)
        base_ops, _ = core.build_spectral_ops(p, dtype=jnp.float64)
        s0 = core.initial_state(base_ops)
        nf = n + 1
        u = jnp.broadcast_to(s0.u, (1, nf, nf))
        v = jnp.broadcast_to(s0.v, (1, nf, nf))
        pp = spatial.pad_pressure(jnp.broadcast_to(s0.p, (1, nf - 2, nf - 2)))

        from jax.sharding import NamedSharding

        spec_tree = spatial.make_step_ops_spec()
        sh_ops = jax.tree.map(
            lambda x, s: jax.device_put(x, NamedSharding(mesh, s)),
            sh_ops, spec_tree)
        u, v, pp = spatial.shard_state(mesh, (u, v, pp), batch_axis="sweep")
        step = spatial.make_sharded_step(mesh, batch_axis="sweep")

        ref_state, _ = core.sg_step(base_ops, s0)
        u2, v2, p2 = step(sh_ops, u, v, pp)
        np.testing.assert_allclose(np.asarray(u2[0]), np.asarray(ref_state.u),
                                   rtol=1e-10, atol=1e-12)
        np.testing.assert_allclose(
            np.asarray(spatial.unpad_pressure(p2[0])),
            np.asarray(ref_state.p), rtol=1e-10, atol=1e-12)

        # multiple sharded steps stay consistent
        s = ref_state
        for _ in range(4):
            u2, v2, p2 = step(sh_ops, u2, v2, p2)
            s, _ = core.sg_step(base_ops, s)
        np.testing.assert_allclose(np.asarray(u2[0]), np.asarray(s.u),
                                   rtol=1e-8, atol=1e-10)


class TestGraftEntry:
    def test_entry_compiles(self):
        import __graft_entry__ as G

        fn, (ops, state) = G.entry()
        out = jax.jit(fn)(ops, state)
        assert out.u.shape == (129, 129)
        assert np.isfinite(np.asarray(out.u)).all()

    @pytest.mark.slow  # ~65 s; the driver runs dryrun_multichip every round
    def test_dryrun_multichip(self):
        if len(jax.devices()) < 8:
            pytest.skip("needs 8 virtual devices")
        import __graft_entry__ as G

        G.dryrun_multichip(8)


class TestBatchedFSG:
    @pytest.mark.slow
    def test_batched_fsg_matches_per_lane(self):
        """Batched FSG lanes reproduce the standalone FSG solver physics."""
        from anap3_tpu.models.spectral import FSGSolver
        from anap3_tpu.parallel.fsg_sweep import run_batched_fsg

        def fsg_params(Re):
            return make_params(Re, n=24, multigrid="fsg", n_levels=2,
                               coarse_tolerance_factor=1.0,
                               prolongation_method="fft",
                               restriction_method="fft",
                               tolerance=1e-5, max_iterations=30000,
                               chunk_size=500, name="spectral_fsg")

        results = run_batched_fsg([fsg_params(100.0), fsg_params(400.0)])
        assert len(results) == 2
        assert all(r.converged for r in results)

        solo = FSGSolver(params=fsg_params(100.0))
        solo.solve()
        np.testing.assert_allclose(np.asarray(results[0].state.u),
                                   np.asarray(solo.state.u), atol=5e-3)

    @pytest.mark.slow
    def test_main_dispatches_fsg_batch(self, tmp_path, monkeypatch):
        monkeypatch.chdir(tmp_path)
        import main as M

        objectives = M.main([
            "-m", "solver=spectral/fsg", "N=24", "Re=100,400",
            "tolerance=1e-5", "max_iterations=30000",
            "solver.chunk_size=500", "solver.n_levels=2",
            "experiment_name=TestFSGBatch", "sweep_name=fsg-batch",
            "mlflow.tracking_uri=" + str(tmp_path / "mlruns"),
        ])
        assert len(objectives) == 2
        from anap3_tpu.utils import tracking as T

        children = [r for r in T.search_runs("TestFSGBatch")
                    if r["tags"].get("sweep") == "child"]
        assert len(children) == 2
        assert all(r["metrics"].get("converged") == 1.0 for r in children)


class TestHistoryCap:
    def test_streaming_decimation_bounds_memory(self):
        """History stays O(max_history_points) with strided global indices."""
        from anap3_tpu.parallel import sweep as sweep_mod
        from anap3_tpu.models import spectral_sg as core

        p = make_params(100.0, nx=8, ny=8)
        ops, _ = core.build_spectral_ops(p)
        batched_ops = sweep_mod.stack_ops([ops, ops])
        state = core.initial_state(ops)
        batched_states = jax.tree.map(lambda *a: jnp.stack(a), state, state)

        cap = 100
        n_iter = 1500
        res = sweep_mod.run_batched_sweep(
            core.sg_step, lambda s: (s.u, s.v), batched_ops, batched_states,
            tolerance=1e-30, max_iterations=n_iter, chunk=100,
            max_history_points=cap)
        n_rec = res.history["energy"].shape[1]
        assert n_rec <= 2 * cap
        assert res.history_iters.shape == (n_rec,)
        # indices are evenly strided from the warmup gate
        strides = np.diff(res.history_iters)
        assert (strides == strides[0]).all()
        assert res.history_iters[0] >= 10
        assert res.history_iters[-1] < n_iter
        # decimated history still matches an undecimated run at those indices
        res_full = sweep_mod.run_batched_sweep(
            core.sg_step, lambda s: (s.u, s.v), batched_ops, batched_states,
            tolerance=1e-30, max_iterations=n_iter, chunk=100,
            max_history_points=10**9)
        full_idx = {int(g): i for i, g in enumerate(res_full.history_iters)}
        sel = [full_idx[int(g)] for g in res.history_iters]
        np.testing.assert_allclose(res.history["energy"][:, :],
                                   res_full.history["energy"][:, sel],
                                   rtol=1e-12)


class TestShardedSolve:
    """Round-2: tensor-parallel CONVERGED solves (VERDICT item 5)."""

    def _mesh(self, n):
        return Mesh(np.array(jax.devices()[:n]), ("x",))

    def test_sharded_runner_converges_and_matches_single(self):
        from anap3_tpu.models.runner import run_fixed_point
        from anap3_tpu.models import spectral_sg as core

        p = make_params(100.0, nx=15, ny=15, tolerance=1e-5,
                        max_iterations=20000)
        # single-device reference
        ops, _ = core.build_spectral_ops(p, dtype=jnp.float32)
        state = core.initial_state(ops)
        ref = run_fixed_point(lambda s: core.sg_step(ops, s),
                              lambda s: (s.u, s.v), state,
                              tolerance=1e-5, max_iterations=20000, chunk=200)
        assert ref.converged

        mesh = self._mesh(4)
        from jax.sharding import NamedSharding
        ops_sh, _ = spatial.build_sharded_ops(p, dtype=jnp.float32)
        spec = spatial.make_step_ops_spec()
        ops_sh = jax.tree.map(
            lambda x, s: jax.device_put(x, NamedSharding(mesh, s)),
            ops_sh, spec)
        u = state.u
        v = state.v
        pp = spatial.pad_pressure(state.p)
        u, v, pp = spatial.shard_state(mesh, (u, v, pp))

        res = run_fixed_point(
            None, lambda s: (s[0], s[1]), (u, v, pp),
            tolerance=1e-5, max_iterations=20000, chunk=200,
            chunk_runner=lambda chunk, tol_, metric_:
                spatial.make_sharded_chunk_runner(
                    mesh, ops_sh, chunk, tol_, 10,
                    convergence_metric=metric_))
        assert res.converged
        assert res.iterations == ref.iterations  # bit-compatible criterion
        u_f, v_f, pp_f = res.state
        np.testing.assert_allclose(np.asarray(u_f), np.asarray(ref.state.u),
                                   rtol=1e-4, atol=1e-5)
        # recorded histories agree
        np.testing.assert_allclose(
            np.asarray(res.history["energy"][:50]),
            np.asarray(ref.history["energy"][:50]), rtol=1e-4)

    def test_sgsolver_spatial_mesh_end_to_end(self):
        from anap3_tpu.models.spectral import SGSolver

        p = make_params(100.0, nx=15, ny=15, tolerance=1e-4,
                        max_iterations=20000)
        ref = SGSolver(params=make_params(100.0, nx=15, ny=15,
                                          tolerance=1e-4,
                                          max_iterations=20000))
        ref.solve()
        sh = SGSolver(params=p)
        sh.spatial_mesh = self._mesh(4)
        sh.solve()
        assert sh.metrics.converged and ref.metrics.converged
        assert sh.metrics.iterations == ref.metrics.iterations
        np.testing.assert_allclose(np.asarray(sh.state.u),
                                   np.asarray(ref.state.u),
                                   rtol=1e-4, atol=1e-5)
        # full analysis pipeline works on the gathered state
        m = sh.compute_vortex_metrics()
        assert np.isfinite(m["psi_min"])

    def test_mesh_from_config(self):
        from anap3_tpu.parallel.spatial import spatial_mesh_from_config

        mesh = spatial_mesh_from_config({"mesh_axes": ["x"]}, nf=16)
        assert mesh is not None and mesh.devices.size == 8
        assert spatial_mesh_from_config({"mesh_axes": ["sweep"]}, nf=16) is None
        mesh13 = spatial_mesh_from_config({"mesh_axes": ["x"]}, nf=13)
        assert mesh13 is None  # 13 rows: no usable divisor > 1


class TestCrossProcessDistributed:
    @pytest.mark.slow
    def test_two_process_sweep_dryrun(self):
        """The jax.distributed multi-host code path, exercised with two
        LOCAL processes over a loopback coordinator: global mesh spans both
        processes' devices, lanes shard across it, and every process sees
        identical SPMD results (parallel/distributed.py; SURVEY §2.8(c))."""
        from anap3_tpu.parallel.distributed import (
            launch_local_distributed_dryrun)

        res = launch_local_distributed_dryrun(num_processes=2,
                                              devices_per_process=2, n=12)
        assert len(res) == 2
        for r in res:
            assert r["process_count"] == 2
            assert r["global_devices"] == 4
            assert r["converged"] == r["lanes"] == 4
        assert res[0]["iterations"] == res[1]["iterations"]


class TestScaling:
    """parallel/scaling.py: the multi-chip efficiency measurement harness."""

    def test_measure_scaling_keys_and_sanity(self):
        if len(jax.devices()) < 2:
            pytest.skip("needs >=2 (virtual) devices")
        from anap3_tpu.parallel.scaling import measure_scaling

        devs = jax.devices()[:2]
        out = measure_scaling(devs, n=15, b_per_dev=1, chunk=10, calls=2)
        assert out["n_devices"] == 2
        for key in ("sweep_rate_1dev", "sweep_rate_2dev",
                    "sweep_aggregate_speedup", "sweep_weak_efficiency_pct",
                    "tp_rate_1dev", "tp_rate_2dev", "tp_speedup",
                    "tp_strong_efficiency_pct"):
            assert key in out, key
            assert np.isfinite(out[key]), (key, out[key])
        assert out["sweep_rate_1dev"] > 0
        assert out["tp_rate_1dev"] > 0

    def test_tp_scaling_rejects_indivisible_grid(self):
        if len(jax.devices()) < 3:
            pytest.skip("needs >=3 (virtual) devices")
        from anap3_tpu.parallel.scaling import measure_tp_scaling

        with pytest.raises(ValueError, match="divide"):
            measure_tp_scaling(jax.devices()[:3], n=15)
