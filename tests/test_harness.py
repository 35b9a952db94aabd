"""Tests for config composition, tracking, optimization, and the CLI driver."""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from anap3_tpu.utils import config as C
from anap3_tpu.utils import tracking as T
from anap3_tpu.utils.config import Interval
from anap3_tpu.utils.optimize import TPESampler

CONF = Path(__file__).resolve().parent.parent / "conf"


class TestConfig:
    def test_defaults_composition(self):
        cfg = C.compose(CONF, [])
        assert cfg["solver"]["_target_"].endswith("FVSolver")
        assert cfg["solver"]["nx"] == cfg["N"] == 32
        assert cfg["Re"] == 100
        assert cfg["validation"]["reference_dir"] == "data/validation/fv"
        assert cfg["mlflow"]["tracking_uri"] == "./mlruns"

    def test_group_override_and_interpolation(self):
        cfg = C.compose(CONF, ["solver=spectral/sg", "N=48", "Re=400"])
        assert cfg["solver"]["_target_"].endswith("SGSolver")
        assert cfg["solver"]["nx"] == 48
        assert cfg["solver"]["Re"] == 400
        assert cfg["solver"]["basis_type"] == "chebyshev"

    def test_nested_solver_defaults(self):
        cfg = C.compose(CONF, ["solver=spectral/fsg"])
        # fsg extends sg: inherits CFL/basis, overrides target/name
        assert cfg["solver"]["_target_"].endswith("FSGSolver")
        assert cfg["solver"]["CFL"] == 1.5
        assert cfg["solver"]["multigrid"] == "fsg"

    def test_dotted_override(self):
        cfg = C.compose(CONF, ["solver=spectral/sg",
                               "solver.corner_smoothing=0.25"])
        assert cfg["solver"]["corner_smoothing"] == 0.25

    def test_unknown_override_rejected(self):
        # Hydra parity: a plain key=value override must hit an existing
        # key — silently creating one hides typos (a real near-miss:
        # `convergence_metric=energy` at the root instead of
        # `solver.convergence_metric` ran the default criterion while
        # looking accepted).
        with pytest.raises(C.ConfigError, match="no such key"):
            C.compose(CONF, ["solver=spectral/sg",
                             "convergence_metric=energy"])
        with pytest.raises(C.ConfigError, match="no such key"):
            C.compose(CONF, ["solver=spectral/sg", "solvr.CFL=1.0"])

    def test_plus_override_appends(self):
        cfg = C.compose(CONF, ["solver=spectral/sg", "+new_knob=3"])
        assert cfg["new_knob"] == 3
        cfg = C.compose(CONF, ["solver=spectral/sg", "+solver.extra=a"])
        assert cfg["solver"]["extra"] == "a"

    def test_experiment_overlay(self):
        cfg = C.compose(CONF, ["+experiment/validation/ghia=spectral"])
        assert cfg["experiment_name"] == "LDC-GHIA-PLOTS"
        assert cfg["solver"]["corner_treatment"] == "smoothing"
        assert cfg["hydra"]["sweeper"]["params"]["Re"] == 1000

    def test_multirun_expansion(self):
        jobs = C.expand_multirun(CONF, ["solver=spectral/sg", "N=16,32",
                                        "Re=100,400"])
        assert len(jobs) == 4
        combos = {(j["N"], j["Re"]) for j in jobs}
        assert combos == {(16, 100), (16, 400), (32, 100), (32, 400)}
        for j in jobs:
            assert j["solver"]["nx"] == j["N"]

    def test_multirun_from_experiment_sweeper(self):
        jobs = C.expand_multirun(CONF, ["+experiment/validation/ghia=spectral"])
        assert len(jobs) == 3  # N: 16, 20, 32
        assert all(j["solver"]["_target_"].endswith("FSGSolver") for j in jobs)

    def test_high_re_overlay(self):
        jobs = C.expand_multirun(CONF, ["+experiment/validation/high_re=spectral"])
        assert [j["Re"] for j in jobs] == [3200, 5000, 7500, 10000]
        assert all(j["solver"]["convergence_metric"] == "energy" for j in jobs)
        assert all(j["N"] == 256 for j in jobs)

    def test_multirun_rejects_platform_mismatch(self):
        import main as M

        with pytest.raises(C.ConfigError, match="platform"):
            M.run_multirun(["solver=spectral/sg", "N=12",
                            "platform=cpu,gpu"])

    def test_interval_parsing(self):
        cfg = C.compose(CONF, ["solver=spectral/sg",
                               "solver.corner_smoothing=interval(0.02,0.35)"])
        iv = cfg["solver"]["corner_smoothing"]
        assert isinstance(iv, Interval)
        assert iv.lo == 0.02 and iv.hi == 0.35

    def test_scientific_notation(self):
        cfg = C.compose(CONF, ["tolerance=1e-5"])
        assert cfg["tolerance"] == 1e-5
        assert isinstance(cfg["tolerance"], float)

    def test_instantiate(self):
        cfg = C.compose(CONF, ["solver=fv", "N=8", "max_iterations=10"])
        solver = C.instantiate(cfg["solver"])
        from anap3_tpu.models.fv import FVSolver

        assert isinstance(solver, FVSolver)
        assert solver.params.nx == 8

    def test_env_interpolation(self, monkeypatch):
        monkeypatch.setenv("MLFLOW_TRACKING_URI", "/tmp/test-mlruns")
        cfg = C.compose(CONF, ["mlflow=remote"])
        assert cfg["mlflow"]["tracking_uri"] == "/tmp/test-mlruns"


class TestTracking:
    def test_parent_child_and_queries(self, tmp_path):
        T.set_tracking_uri(tmp_path / "mlruns")
        T.set_experiment("Exp")
        with T.start_run(run_name="parent", tags={"is_parent": "true"}) as par:
            with T.start_run(run_name="child", nested=True) as child:
                T.log_params({"Re": 100, "nx": 32})
                T.log_metrics({"rel_iter_residual": 0.5}, step=0)
                T.log_batch(child.run_id, [("energy", 0.1, 0), ("energy", 0.2, 1)])
                T.log_dict({"a": 1}, "config.yaml")
                T.log_table([{"x": 1, "y": 2}], "validation_metrics.json")
        runs = T.search_runs("Exp", params={"Re": 100}, status="FINISHED")
        assert len(runs) == 1
        assert runs[0]["tags"]["mlflow.parentRunId"] == par.run_id
        assert T.get_metric_history(child.run_id, "energy") == [(0, 0.1), (1, 0.2)]
        kids = T.search_runs("Exp", parent_run_id=par.run_id)
        assert [k["run_id"] for k in kids] == [child.run_id]
        table = json.loads((Path(kids[0]["path"]) / "artifacts" /
                            "validation_metrics.json").read_text())
        assert table["columns"] == ["x", "y"]

    def test_experiment_reuse(self, tmp_path):
        T.set_tracking_uri(tmp_path / "mlruns")
        e1 = T.set_experiment("Same")
        e2 = T.set_experiment("Same")
        assert e1 == e2


class TestTPE:
    def test_converges_on_quadratic(self):
        sampler = TPESampler({"x": Interval(0.0, 1.0)}, n_startup_trials=4,
                             seed=1)
        for _ in range(30):
            p = sampler.ask()
            sampler.tell(p, (p["x"] - 0.3) ** 2)
        best, val = sampler.best
        assert abs(best["x"] - 0.3) < 0.08
        assert val < 0.01

    def test_categorical_and_inf_handling(self):
        sampler = TPESampler({"n": [10, 20, 30], "x": Interval(0, 1)},
                             n_startup_trials=3, seed=2)
        for _ in range(15):
            p = sampler.ask()
            val = float("inf") if p["n"] == 10 else (p["x"] - 0.5) ** 2
            sampler.tell(p, val)
        best, _ = sampler.best
        assert best["n"] != 10


class TestMainDriver:
    def test_single_run_fast_no_plots(self, tmp_path, monkeypatch):
        """Fast-tier e2e: solve -> track -> validate -> objective with plot
        generation stubbed out (plots dominate wall time ~20x and are
        covered by the slow-tier test below)."""
        monkeypatch.chdir(tmp_path)
        import main as M

        monkeypatch.setattr(M, "generate_plots", lambda *a, **k: None)
        obj = M.main(["solver=fv", "N=10", "Re=100", "tolerance=1e-4",
                      "max_iterations=800", "experiment_name=TestFastE2E",
                      "mlflow.tracking_uri=" + str(tmp_path / "mlruns")])
        assert np.isfinite(obj)
        runs = T.search_runs("TestFastE2E", status="FINISHED")
        assert len(runs) == 1
        run = runs[0]
        assert "u_L2_error" in run["metrics"]
        assert "psi_min" in run["metrics"]
        assert float(run["metrics"]["time_solve_seconds"]) > 0
        art = Path(run["path"]) / "artifacts"
        assert (art / "solution.vts").exists()
        assert (art / "validation_metrics.json").exists()

    @pytest.mark.slow
    def test_single_run_end_to_end(self, tmp_path, monkeypatch):
        monkeypatch.chdir(tmp_path)
        import main as M

        obj = M.main(["solver=fv", "N=10", "Re=100", "tolerance=1e-4",
                      "max_iterations=800", "experiment_name=TestE2E",
                      "mlflow.tracking_uri=" + str(tmp_path / "mlruns")])
        assert np.isfinite(obj)
        runs = T.search_runs("TestE2E", status="FINISHED")
        assert len(runs) == 1
        run = runs[0]
        assert run["params"]["Re"] == "100.0" or run["params"]["Re"] == "100"
        assert "u_L2_error" in run["metrics"]
        assert "psi_min" in run["metrics"]
        # PhaseTimer breakdown (setup/solve/analysis + plots post-close)
        assert float(run["metrics"]["time_solve_seconds"]) > 0
        assert "time_setup_seconds" in run["metrics"]
        assert "time_analysis_seconds" in run["metrics"]
        art = Path(run["path"]) / "artifacts"
        assert (art / "solution.vts").exists()
        assert (art / "config.yaml").exists()
        assert (art / "validation_metrics.json").exists()
        assert (art / "plots" / "convergence.pdf").exists()
        assert (art / "plots" / "ghia_comparison.pdf").exists()
        assert (art / "plots" / "streamlines.png").exists()
        assert (art / "plots" / "streamlines_3d.png").exists()

    @pytest.mark.slow
    def test_plot_only_finds_existing_run(self, tmp_path, monkeypatch):
        monkeypatch.chdir(tmp_path)
        import main as M

        over = ["solver=fv", "N=10", "Re=100", "tolerance=1e-4",
                "max_iterations=800", "experiment_name=TestPlotOnly",
                "mlflow.tracking_uri=" + str(tmp_path / "mlruns")]
        M.main(over)
        out = M.main(over + ["plot_only=true"])
        assert out is None


class TestMultirunBatched:
    @pytest.mark.slow
    def test_batched_sweep_end_to_end(self, tmp_path, monkeypatch):
        """A homogeneous Re sweep runs as ONE vmapped batch and logs every
        lane as its own tracked child run with artifacts."""
        monkeypatch.chdir(tmp_path)
        import main as M

        objectives = M.main([
            "-m", "solver=spectral/sg", "N=12", "Re=100,400",
            "tolerance=1e-4", "max_iterations=4000",
            "solver.chunk_size=200",
            "experiment_name=TestBatchSweep", "sweep_name=batch-sweep",
            "mlflow.tracking_uri=" + str(tmp_path / "mlruns"),
        ])
        assert len(objectives) == 2
        from anap3_tpu.utils import tracking as T

        runs = T.search_runs("TestBatchSweep", status="FINISHED")
        children = [r for r in runs if r["tags"].get("sweep") == "child"]
        assert len(children) == 2
        res = sorted(float(r["params"]["Re"]) for r in children)
        assert res == [100.0, 400.0]
        for r in children:
            art = Path(r["path"]) / "artifacts"
            assert (art / "solution.vts").exists()
            assert "psi_min" in r["metrics"]
            assert "timesteps_per_sec" in r["metrics"]
            # per-lane wall is the shared batch wall, tagged as such
            assert r["tags"].get("wall_time_scope") == "batch"
        parents = [r for r in T.search_runs("TestBatchSweep")
                   if r["tags"].get("is_parent") == "true"]
        assert len(parents) == 1
        assert float(parents[0]["metrics"]["aggregate_lane_steps_per_sec"]) > 0
        # comparison plots on the parent
        parent_art = Path(parents[0]["path"]) / "artifacts" / "plots"
        assert (parent_art / "ghia_comparison.pdf").exists()

    def test_heterogeneous_sweep_falls_back_to_serial(self, tmp_path,
                                                      monkeypatch):
        monkeypatch.chdir(tmp_path)
        import main as M

        jobs = M.C.expand_multirun(M.REPO_ROOT / "conf",
                                   ["solver=spectral/sg", "N=8,12"])
        assert not M._batchable(jobs)  # differing N -> no shared operators

    @pytest.mark.slow
    def test_threaded_heterogeneous_sweep(self, tmp_path, monkeypatch):
        """machine.n_jobs>1 runs non-batchable members on host threads;
        every child run still lands under the right parent with its own
        params (thread-local run stacks)."""
        monkeypatch.chdir(tmp_path)
        import main as M

        objectives = M.main([
            "-m", "solver=spectral/sg", "N=8,12", "Re=100",
            "tolerance=1e-3", "max_iterations=300", "machine.n_jobs=2",
            "experiment_name=TestThreaded", "sweep_name=threaded-sweep",
            "mlflow.tracking_uri=" + str(tmp_path / "mlruns"),
        ])
        assert len(objectives) == 2
        runs = T.search_runs("TestThreaded", status="FINISHED")
        children = [r for r in runs if r["tags"].get("sweep") == "child"]
        assert len(children) == 2
        Ns = sorted(int(float(r["params"]["nx"])) for r in children)
        assert Ns == [8, 12]
        parents = [r for r in T.search_runs("TestThreaded")
                   if r["tags"].get("is_parent") == "true"]
        assert len(parents) == 1
        for r in children:
            assert r["tags"]["mlflow.parentRunId"] == parents[0]["run_id"]
            assert "time_solve_seconds" in r["metrics"]


class TestOptimizationDriver:
    @pytest.mark.slow
    def test_corner_smoothing_optimization_e2e(self, tmp_path, monkeypatch):
        """Interval() overrides route to the TPE loop; trials + summary land
        on the parent run."""
        monkeypatch.chdir(tmp_path)
        import main as M

        best = M.main([
            "-m", "solver=spectral/sg", "N=10", "Re=100",
            "tolerance=1e-3", "max_iterations=2000",
            "solver.chunk_size=200",
            "solver.corner_smoothing=interval(0.05,0.3)",
            "+optuna.objective=fv_l2_error", "+optuna.n_trials=3",
            "+optuna.n_startup_trials=2", "+optuna.seed=0",
            "experiment_name=TestOpt", "sweep_name=opt-sweep",
            "mlflow.tracking_uri=" + str(tmp_path / "mlruns"),
        ])
        assert np.isfinite(best)
        from anap3_tpu.utils import tracking as T

        runs = T.search_runs("TestOpt")
        parents = [r for r in runs if r["tags"].get("is_parent") == "true"]
        assert len(parents) == 1
        trials_file = (Path(parents[0]["path"]) / "artifacts" /
                       "optuna_trials.json")
        assert trials_file.exists()
        trials = json.loads(trials_file.read_text())
        assert len(trials["data"]) == 3
        assert "best_objective" in parents[0]["metrics"]
        children = [r for r in runs if r["tags"].get("sweep") == "child"]
        assert len(children) == 3


class TestGroupReselection:
    def test_experiment_solver_override_replaces_not_merges(self):
        """Switching solver groups must DROP the previous group's keys
        (regression: fv-only keys leaked into SpectralParameters when an
        experiment overlay re-selected the solver)."""
        cfg = C.compose(CONF, ["+experiment/optimization=corner_smoothing"])
        assert cfg["solver"]["_target_"].endswith("FSGSolver")
        assert "convection_scheme" not in cfg["solver"]
        assert "alpha_uv" not in cfg["solver"]
        solver = C.instantiate(dict(cfg["solver"],
                                    max_iterations=5, tolerance=1e-1))
        assert solver.params.multigrid == "fsg"

    def test_cli_reselection_after_experiment(self):
        cfg = C.compose(CONF, ["+experiment/validation/ghia=spectral",
                               "solver=fv"])
        assert cfg["solver"]["_target_"].endswith("FVSolver")
        assert "basis_type" not in cfg["solver"]


class TestGroupedBatching:
    @pytest.mark.slow
    def test_mixed_sweep_batches_homogeneous_groups(self, tmp_path,
                                                    monkeypatch):
        """fv x spectral x Re sweep: each (solver) group rides one batch."""
        monkeypatch.chdir(tmp_path)
        import main as M

        objectives = M.main([
            "-m", "solver=fv,spectral/sg", "N=10", "Re=100,150",
            "tolerance=1e-3", "max_iterations=2500",
            "solver.chunk_size=250",
            "experiment_name=TestMixed", "sweep_name=mixed",
            "mlflow.tracking_uri=" + str(tmp_path / "mlruns"),
        ])
        assert len(objectives) == 4
        from anap3_tpu.utils import tracking as T

        children = [r for r in T.search_runs("TestMixed")
                    if r["tags"].get("sweep") == "child"]
        assert len(children) == 4
        solvers = sorted(r["tags"]["solver"] for r in children)
        assert solvers == ["fv", "fv", "spectral", "spectral"]


class TestSweeperCliPrecedence:
    def test_single_value_cli_override_pins_sweeper_param(self):
        """A CLI N=16 must pin N even when the experiment sweeps it."""
        jobs = C.expand_multirun(CONF, ["+experiment/validation/saad=spectral",
                                        "N=16"])
        assert len(jobs) == 1
        assert jobs[0]["N"] == 16

    def test_cli_comma_sweep_replaces_sweeper_param(self):
        jobs = C.expand_multirun(CONF, ["+experiment/validation/ghia=spectral",
                                        "N=16,20"])
        assert sorted(j["N"] for j in jobs) == [16, 20]


class TestCommaValues:
    def test_compose_rejects_unbracketed_comma(self):
        """Hydra rejects sweep syntax outside multirun; so do we."""
        with pytest.raises(C.ConfigError):
            C.compose(CONF, ["Re=100,400"])

    def test_compose_accepts_bracketed_list(self):
        cfg = C.compose(CONF, ["+machine.mesh_axes=[sweep,x]"])
        assert cfg["machine"]["mesh_axes"] == ["sweep", "x"]

    def test_multirun_still_sweeps_commas(self):
        jobs = C.expand_multirun(CONF, ["solver=spectral/sg", "N=12",
                                        "Re=100,400"])
        assert [j["Re"] for j in jobs] == [100, 400]


class TestRemoteTracking:
    """Remote MLflow delegation (reference utilities/mlflow/io.py:8-33)."""

    def _fake_mlflow(self):
        import types
        from unittest import mock

        fake = types.ModuleType("mlflow")
        client = mock.MagicMock()
        exp = mock.MagicMock()
        exp.experiment_id = "exp42"
        client.get_experiment_by_name.return_value = exp
        created = mock.MagicMock()
        created.info.run_id = "remote-run-1"
        client.create_run.return_value = created
        fake.set_tracking_uri = mock.MagicMock()
        fake.tracking = types.SimpleNamespace(
            MlflowClient=mock.MagicMock(return_value=client))
        fake.artifacts = types.SimpleNamespace(
            download_artifacts=mock.MagicMock())
        # mlflow.entities.Metric for log_batch
        entities = types.ModuleType("mlflow.entities")
        entities.Metric = lambda k, v, ts, s: (k, v, ts, s)
        return fake, entities, client

    def test_remote_uri_delegates_to_client(self, monkeypatch, tmp_path):
        import sys

        fake, entities, client = self._fake_mlflow()
        monkeypatch.setitem(sys.modules, "mlflow", fake)
        monkeypatch.setitem(sys.modules, "mlflow.entities", entities)
        try:
            T.set_tracking_uri("https://mlflow.example.com")
            fake.set_tracking_uri.assert_called_with(
                "https://mlflow.example.com")
            assert T.set_experiment("LDC") == "exp42"
            with T.start_run(run_name="r", tags={"solver": "fv"}) as run:
                assert run.run_id == "remote-run-1"
                T.log_params({"Re": 100})
                T.log_metric("rel_iter", 1e-3, step=7)
                T.set_tag("k", "v")
                T.log_dict({"a": 1}, "config.yaml")
                T.log_batch(run.run_id, [("e", 1.0, 0), ("e", 2.0, 1)])
            client.create_run.assert_called_once()
            _, kwargs = client.create_run.call_args
            assert kwargs["tags"]["mlflow.runName"] == "r"
            client.log_param.assert_called_with("remote-run-1", "Re", 100)
            client.log_metric.assert_called()
            client.set_tag.assert_any_call("remote-run-1", "k", "v")
            client.log_dict.assert_called_with("remote-run-1", {"a": 1},
                                               "config.yaml")
            client.log_batch.assert_called_once()
            client.set_terminated.assert_called_with("remote-run-1",
                                                     status="FINISHED")
        finally:
            T.set_tracking_uri(tmp_path)  # restore file mode for other tests

    def test_remote_uri_without_mlflow_raises(self, monkeypatch, tmp_path):
        import builtins
        import sys

        monkeypatch.setitem(sys.modules, "mlflow", None)  # forces ImportError
        with pytest.raises(RuntimeError, match="requires the mlflow"):
            T.set_tracking_uri("https://mlflow.example.com")
        T.set_tracking_uri(tmp_path)

    def test_local_mode_unaffected(self, tmp_path):
        T.set_tracking_uri(tmp_path)
        T.set_experiment("local-exp")
        with T.start_run(run_name="x") as run:
            T.log_metric("m", 1.0)
        runs = T.search_runs(experiment_name="local-exp")
        assert len(runs) == 1 and runs[0]["metrics"]["m"] == 1.0


_CONF_FILES = sorted(str(p.relative_to(CONF))
                     for p in CONF.glob("**/*.yaml"))


class TestYamlReader:
    @pytest.mark.parametrize("rel", _CONF_FILES)
    def test_matches_pyyaml_on_conf_tree(self, rel):
        """The in-package reader parses every config file exactly as
        PyYAML's safe_load does (PyYAML itself is off the main path)."""
        yaml = pytest.importorskip("yaml")
        from anap3_tpu.utils import yamlio

        text = (CONF / rel).read_text()
        assert yamlio.load(text) == yaml.safe_load(text)

    def test_dump_round_trips(self):
        """What the tracking store writes (meta.yaml, config.yaml) reads
        back identically with this reader and with PyYAML."""
        from anap3_tpu.utils import yamlio

        data = {"a": 1, "b": [1, "x", {"k": "v"}], "c": {
            "none": None, "f": 1e-6, "big": -3.5e20, "inf": float("inf"),
            "empty": "", "sci_str": "1e-9", "yes": "yes", "t": True,
            "colon": "a: b", "interp": "${x}", "path": "/p/x y",
            "quote": "it's", "comma": "a,b", "dash": "-x", "lst": [],
            "map": {}}}
        text = yamlio.dump(data)
        assert yamlio.load(text) == data
        yaml = pytest.importorskip("yaml")
        assert yaml.safe_load(text) == data


def test_plots_false_main_path_needs_only_jax_numpy_scipy(tmp_path):
    """solve -> validate -> log with plots=false imports none of PyYAML,
    pandas, matplotlib, seaborn, h5py or pyvista (the card's machine is
    only sure to have JAX, numpy and scipy)."""
    code = (
        "import sys\n"
        "BLOCKED = {'yaml', 'pandas', 'matplotlib', 'seaborn', 'h5py',"
        " 'pyvista'}\n"
        "class Block:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in BLOCKED:\n"
        "            raise ImportError('blocked: ' + name)\n"
        "sys.meta_path.insert(0, Block())\n"
        "import main\n"
        "common = ['plots=false', 'tolerance=1e-3', 'max_iterations=400',"
        " 'mlflow.tracking_uri=" + str(tmp_path / "mlruns") + "']\n"
        "main.main(['solver=spectral/sg', 'N=8'] + common)\n"
        "main.main(['solver=fv', 'N=8'] + common)\n"
        "main.main(['-m', 'solver=spectral/sg', 'N=8', 'Re=100,200']"
        " + common)\n"
        "print('OK')\n")
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        cwd=tmp_path, timeout=600,
        env={"PATH": "/usr/bin:/bin", "JAX_PLATFORMS": "cpu",
             "PYTHONPATH": str(CONF.parent), "HOME": str(tmp_path)})
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().endswith("OK")
