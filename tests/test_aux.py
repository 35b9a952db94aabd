"""Tests for auxiliary subsystems: checkpoint/resume, profiling, submission."""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import jax.numpy as jnp

from anap3_tpu.models.params import SpectralParameters
from anap3_tpu.models.spectral import SGSolver
from anap3_tpu.utils.checkpoint import (CheckpointManager, load_checkpoint,
                                        save_checkpoint)
from anap3_tpu.utils.profiling import PhaseTimer

REPO = Path(__file__).resolve().parent.parent


def make_params(**over):
    base = dict(name="spectral", Re=100.0, nx=12, ny=12,
                basis_type="chebyshev", CFL=1.5, corner_treatment="smoothing",
                tolerance=1e-4, max_iterations=4000, dtype="float64")
    base.update(over)
    return SpectralParameters(**base)


class TestCheckpoint:
    def test_roundtrip(self, tmp_path):
        from anap3_tpu.models import spectral_sg as core

        ops, _ = core.build_spectral_ops(make_params())
        state = core.initial_state(ops)
        save_checkpoint(tmp_path / "c.npz", state, 123, "fp")
        restored, it = load_checkpoint(tmp_path / "c.npz", state)
        assert it == 123
        np.testing.assert_array_equal(np.asarray(restored.u),
                                      np.asarray(state.u))

    def test_manager_gc_and_restore(self, tmp_path):
        from anap3_tpu.models import spectral_sg as core

        ops, _ = core.build_spectral_ops(make_params())
        state = core.initial_state(ops)
        mgr = CheckpointManager(tmp_path, every_chunks=1, keep=2)
        for it in (100, 200, 300):
            mgr.maybe_save(state, it)
        cpts = sorted(tmp_path.glob("ckpt_*.npz"))
        assert len(cpts) == 2  # oldest garbage-collected
        restored, it = mgr.restore_or(state)
        assert it == 300

    def test_solver_resume_continues_iterations(self, tmp_path):
        """Interrupt a solve, resume, final state ~ uninterrupted solve."""
        p_full = make_params(tolerance=1e-5, max_iterations=6000)
        ref = SGSolver(params=p_full)
        ref.solve()

        ckdir = str(tmp_path / "ck")
        p_a = make_params(tolerance=1e-5, max_iterations=500,
                          checkpoint_dir=ckdir, checkpoint_every_chunks=1)
        a = SGSolver(params=p_a)
        a.solve()  # stops at max_iterations=500 with checkpoints written
        assert Path(ckdir).exists() and list(Path(ckdir).glob("ckpt_*.npz"))

        p_b = make_params(tolerance=1e-5, max_iterations=6000,
                          checkpoint_dir=ckdir, checkpoint_every_chunks=1)
        b = SGSolver(params=p_b)
        b.solve()  # resumes from ~iteration 500
        assert b.metrics.converged
        assert b.metrics.iterations > 500
        np.testing.assert_allclose(np.asarray(b.state.u),
                                   np.asarray(ref.state.u), atol=2e-3)


class TestProfiling:
    def test_phase_timer(self):
        t = PhaseTimer()
        with t.phase("setup"):
            pass
        with t.phase("solve"):
            pass
        m = t.as_metrics()
        assert set(m) == {"time_setup_seconds", "time_solve_seconds"}
        assert all(v >= 0 for v in m.values())


class TestHpcSubmit:
    @pytest.mark.parametrize("backend", ["lsf", "shell"])
    def test_generates_script_and_parent(self, tmp_path, monkeypatch, backend):
        monkeypatch.chdir(tmp_path)
        out = tmp_path / "submit.sh"
        result = subprocess.run(
            [sys.executable, str(REPO / "scripts/hpc_submit.py"),
             "+experiment/validation/ghia=spectral",
             f"mlflow.tracking_uri={tmp_path / 'mlruns'}",
             "--backend", backend, "--out", str(out)],
            capture_output=True, text=True, cwd=tmp_path,
            env={"PATH": "/usr/bin:/bin", "JAX_PLATFORMS": "cpu",
                 "PYTHONPATH": str(REPO), "HOME": str(tmp_path)},
        )
        assert result.returncode == 0, result.stderr
        text = out.read_text()
        assert "MLFLOW_PARENT_RUN_ID=" in text
        assert "main.py" in text
        # 3 sweep members (N: 16, 20, 32)
        assert text.count('"N=') == 3 or text.count("N=16") >= 1
        if backend == "lsf":
            assert "#BSUB -J" in text and "[1-3]" in text


class TestCheckpointSafety:
    """Round-2 hardening: fingerprint gating + crash-safe temp files."""

    def test_fingerprint_mismatch_refuses_resume(self, tmp_path):
        from anap3_tpu.models import spectral_sg as core
        from anap3_tpu.utils.checkpoint import FingerprintMismatch

        ops, _ = core.build_spectral_ops(make_params())
        state = core.initial_state(ops)
        mgr_a = CheckpointManager(tmp_path, params=make_params(Re=100.0),
                                  every_chunks=1)
        mgr_a.maybe_save(state, 100)

        # same grid shape, different physics -> must refuse, not silently resume
        mgr_b = CheckpointManager(tmp_path, params=make_params(Re=400.0),
                                  every_chunks=1)
        with pytest.raises(FingerprintMismatch):
            mgr_b.restore_or(state)

    def test_run_control_changes_allow_resume(self, tmp_path):
        from anap3_tpu.models import spectral_sg as core

        ops, _ = core.build_spectral_ops(make_params())
        state = core.initial_state(ops)
        mgr_a = CheckpointManager(
            tmp_path, params=make_params(max_iterations=500), every_chunks=1)
        mgr_a.maybe_save(state, 100)
        mgr_b = CheckpointManager(
            tmp_path, params=make_params(max_iterations=9000, tolerance=1e-6),
            every_chunks=1)
        _, it = mgr_b.restore_or(state)
        assert it == 100

    def test_stray_partial_files_ignored(self, tmp_path):
        """Files not matching ckpt_<int>.npz must not crash latest/_gc."""
        from anap3_tpu.models import spectral_sg as core

        ops, _ = core.build_spectral_ops(make_params())
        state = core.initial_state(ops)
        mgr = CheckpointManager(tmp_path, every_chunks=1)
        mgr.maybe_save(state, 100)
        # simulate a crash artifact from the OLD naming scheme
        (tmp_path / "ckpt_000000200.tmp.npz").write_bytes(b"partial")
        restored, it = mgr.restore_or(state)
        assert it == 100
        mgr.maybe_save(state, 300)  # _gc must not crash either

    def test_temp_file_invisible_to_glob(self, tmp_path):
        """The atomic-write temp name must not match the ckpt_*.npz glob."""
        import anap3_tpu.utils.checkpoint as ck
        from anap3_tpu.models import spectral_sg as core

        ops, _ = core.build_spectral_ops(make_params())
        state = core.initial_state(ops)

        real_replace = ck.os.replace
        calls = {}

        def spy_replace(src, dst):
            calls["tmp"] = Path(src)
            # before the rename lands, the tmp file must be glob-invisible
            assert not list(Path(dst).parent.glob("ckpt_*.npz"))
            return real_replace(src, dst)

        ck.os.replace = spy_replace
        try:
            save_checkpoint(tmp_path / "ckpt_000000001.npz", state, 1, "fp")
        finally:
            ck.os.replace = real_replace
        assert calls["tmp"].name.startswith(".")


class TestRunnerResumeHistory:
    def test_resumed_history_not_warmup_sliced(self):
        """Post-resume rows past the warmup gate must all be recorded."""
        import jax.numpy as jnp
        from anap3_tpu.models.runner import run_fixed_point

        def step(x):
            m = {k: jnp.asarray(0.5) for k in
                 ("u_eq", "v_eq", "continuity", "energy", "enstrophy",
                  "palinstrophy")}
            return 0.9 * x, m

        x0 = jnp.ones((4, 4))
        res = run_fixed_point(step, lambda s: (s, s), x0, tolerance=1e-30,
                              max_iterations=140, chunk=20,
                              start_iteration=100)
        n_rows = len(res.history["rel_iter"])
        assert res.iterations == 140
        assert n_rows == 40  # all post-resume rows (100 -> 140), none dropped


class TestRunnerHistoryBound:
    def test_long_run_history_is_stride_decimated(self):
        """A long run holds O(max_history_points) rows, keeps the final row,
        and short runs record every iteration bit-identically."""
        import jax.numpy as jnp
        from anap3_tpu.models.runner import run_fixed_point

        def step(x):
            m = {k: jnp.sum(x) / x.size for k in
                 ("u_eq", "v_eq", "continuity", "energy", "enstrophy",
                  "palinstrophy")}
            return x + 1e-9, m

        res = run_fixed_point(step, lambda s: (s, s), jnp.ones((2, 2)),
                              tolerance=1e-30, max_iterations=50_000,
                              chunk=1000, max_history_points=2000)
        n = len(res.history["rel_iter"])
        assert n <= 2 * 2000 + 1          # bounded, not ~50k rows
        assert n >= 1000                   # but still dense enough
        iters = res.history_iters
        assert iters[0] == 10              # warmup gate preserved
        assert iters[-1] == 50_000 - 1     # final row always kept
        assert (np.diff(iters) > 0).all()
        # final_* metrics read history[-1]: must be the true last value
        expect = 1.0 + 1e-9 * (50_000 - 1)
        assert abs(res.history["energy"][-1] - expect) < 1e-10

    def test_short_run_records_every_iteration(self):
        import jax.numpy as jnp
        from anap3_tpu.models.runner import run_fixed_point

        def step(x):
            m = {k: jnp.asarray(0.5) for k in
                 ("u_eq", "v_eq", "continuity", "energy", "enstrophy",
                  "palinstrophy")}
            return 0.9 * x, m

        res = run_fixed_point(step, lambda s: (s, s), jnp.ones((2, 2)),
                              tolerance=1e-30, max_iterations=500, chunk=64)
        assert len(res.history["rel_iter"]) == 500 - 10
        assert list(res.history_iters) == list(range(10, 500))


class TestStallDetection:
    def test_plateau_stops_early(self):
        import jax.numpy as jnp
        from anap3_tpu.models.runner import run_fixed_point

        def step(x):
            # constant-magnitude random-walk-like update: rel change never
            # decreases below ~1e-3, so tol=1e-6 is unreachable
            m = {k: jnp.asarray(1.0) for k in
                 ("u_eq", "v_eq", "continuity", "energy", "enstrophy",
                  "palinstrophy")}
            return x + 1e-3 * jnp.sign(jnp.cos(jnp.sum(x))), m

        x0 = jnp.ones((4, 4))
        res = run_fixed_point(step, lambda s: (s, s), x0, tolerance=1e-6,
                              max_iterations=10**6, chunk=50, stall_chunks=5)
        assert res.stalled
        assert not res.converged
        assert res.iterations < 10000

    def test_disabled_by_default(self):
        import jax.numpy as jnp
        from anap3_tpu.models.runner import run_fixed_point

        def step(x):
            m = {k: jnp.asarray(1.0) for k in
                 ("u_eq", "v_eq", "continuity", "energy", "enstrophy",
                  "palinstrophy")}
            return x + 1e-3, m

        res = run_fixed_point(step, lambda s: (s, s), jnp.ones((2, 2)),
                              tolerance=1e-9, max_iterations=2000, chunk=100)
        assert not res.stalled
        assert res.iterations == 2000

    def test_converging_run_not_stalled(self):
        import jax.numpy as jnp
        from anap3_tpu.models.runner import run_fixed_point

        def step(x):
            m = {k: jnp.asarray(0.1) for k in
                 ("u_eq", "v_eq", "continuity", "energy", "enstrophy",
                  "palinstrophy")}
            # contraction toward 1: rel change decays geometrically
            return 1.0 + 0.9 * (x - 1.0), m

        res = run_fixed_point(step, lambda s: (s, s), 2.0 * jnp.ones((4, 4)),
                              tolerance=1e-6, max_iterations=10**6,
                              chunk=50, stall_chunks=5)
        assert res.converged and not res.stalled


class TestPrecisionPolicy:
    @pytest.mark.parametrize("solver", ["SGSolver", "FSGSolver"])
    def test_auto_dtype_computes_float64_without_x64(self, solver, tmp_path):
        """In a fresh process that never enabled x64 itself, dtype='auto'
        resolves to float64 AND the state and operators are float64 (the
        solver constructor turns x64 on; before, they silently stayed
        float32 while the run reported float64)."""
        code = (
            "import jax\n"
            "assert not jax.config.jax_enable_x64\n"
            "from anap3_tpu.models.spectral import " + solver + " as S\n"
            "s = S(Re=100.0, nx=12, ny=12, dtype='auto')\n"
            "print(s.params.dtype, s.state.u.dtype, s.state.p.dtype,"
            " s.ops.Dx.dtype, s.ops.nu.dtype)\n")
        out = subprocess.run(
            [sys.executable, "-c", code], capture_output=True, text=True,
            cwd=tmp_path, timeout=300,
            env={"PATH": "/usr/bin:/bin", "JAX_PLATFORMS": "cpu",
                 "PYTHONPATH": str(REPO), "HOME": str(tmp_path)})
        assert out.returncode == 0, out.stderr
        assert out.stdout.split() == ["float64"] * 5


class TestCompileCache:
    def test_honours_env_variable(self, monkeypatch, tmp_path):
        from anap3_tpu.utils import compile_cache as cc

        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "c"))
        assert cc.cache_dir() == tmp_path / "c"

    def test_fixed_repo_path_when_unset(self, monkeypatch):
        from anap3_tpu.utils import compile_cache as cc

        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        assert cc.cache_dir() == REPO / ".jax_cache"
        assert cc.DEFAULT_CACHE_DIR == REPO / ".jax_cache"


class TestTraceReduction:
    def test_busy_time_merges_overlaps(self):
        from anap3_tpu.utils.profiling import busy_time

        assert busy_time([]) == 0.0
        assert busy_time([(0, 10), (5, 12), (20, 25), (21, 22)]) == 17.0

    def test_device_activity_reads_a_recorded_trace(self, tmp_path):
        """The reduction runs on a real trace; here the CPU plane's XLA
        worker lines stand in for the GPU stream lines bench.py reads."""
        import jax

        from anap3_tpu.utils.profiling import device_activity, device_trace

        f = jax.jit(lambda x: jnp.sin(x) @ x)
        x = jnp.ones((64, 64))
        f(x).block_until_ready()
        with device_trace(str(tmp_path)):
            for _ in range(3):
                x = f(x)
            x.block_until_ready()
        act = device_activity(tmp_path, plane_prefix="/host:CPU",
                              line_prefix="tf_XLA")
        assert act["kernels"] > 0
        assert 0.0 < act["busy_seconds"] <= act["window_seconds"]
        assert 0.0 <= act["idle_share"] < 1.0
        with pytest.raises(ValueError, match="lines seen"):
            device_activity(tmp_path, plane_prefix="/host:CPU",
                            line_prefix="Stream")
