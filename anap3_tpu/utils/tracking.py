"""Experiment tracking: MLflow-compatible file store + remote delegation.

The reference logs params/metrics/artifacts/tags to MLflow with a
parent/child hierarchy for sweeps (main.py:75-120, base.py:796-964,
utilities/mlflow/callback.py). The mlflow client is optional, so this
module implements the same contract against the on-disk FileStore
layout mlflow uses (``mlruns/<experiment_id>/<run_id>/{meta.yaml, params/,
metrics/, tags/, artifacts/}``) — a later ``pip install mlflow`` can open the
directory directly (``mlflow ui --backend-store-uri ./mlruns``).

Remote mode (reference utilities/mlflow/io.py:8-33): when the tracking URI
is http(s)/databricks AND the real ``mlflow`` package is importable, every
call in this module delegates to the live client — the driver code is
identical in both modes. A remote URI without the package installed raises
immediately (silently writing to a local directory instead of the requested
server would lose data).

Key names, metric semantics (step-indexed histories) and the parent-run
tagging convention (``mlflow.parentRunId``) are kept identical so plotting
and sweep aggregation behave like the reference.
"""

from __future__ import annotations

import json
import logging
import threading
import shutil
import time
import uuid
from pathlib import Path
from typing import Dict, List, Optional

from . import yamlio

log = logging.getLogger(__name__)

__all__ = [
    "set_tracking_uri", "get_tracking_uri", "set_experiment", "start_run",
    "active_run", "end_run", "attach_run", "log_params", "log_metrics",
    "log_metric", "set_tag", "log_artifact", "log_dict", "log_table",
    "log_batch", "search_runs", "get_metric_history", "download_artifacts",
    "Run",
]

_state = {"uri": Path("./mlruns"), "experiment_id": None, "mlflow": None}

# The active-run stack is THREAD-LOCAL: main.py can run non-batchable sweep
# members on a host thread pool (machine.n_jobs, mirroring the reference's
# joblib launcher, conf/machine/local.yaml), and each worker thread must
# attach/detach its own runs without clobbering its neighbours'. Store-level
# state (uri, experiment, remote client) stays process-global.
_local = threading.local()


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack

_REMOTE_SCHEMES = ("http://", "https://", "databricks")


def _mlflow():
    """The real mlflow module when a remote URI is configured, else None."""
    return _state["mlflow"]


def _ms() -> int:
    return int(time.time() * 1000)


def set_tracking_uri(uri) -> None:
    uri = str(uri)
    if uri.startswith(_REMOTE_SCHEMES):
        try:
            import mlflow
        except ImportError as exc:
            raise RuntimeError(
                f"Remote tracking URI {uri!r} requires the mlflow package "
                "(pip install mlflow); refusing to silently log to a local "
                "directory instead.") from exc
        mlflow.set_tracking_uri(uri)
        _state["mlflow"] = mlflow
        _state["uri"] = uri
        log.info("Remote MLflow tracking: %s", uri)
        return
    _state["mlflow"] = None
    if uri.startswith("file:"):
        uri = uri[len("file:"):]
    _state["uri"] = Path(uri)


def get_tracking_uri():
    return _state["uri"]


def _root() -> Path:
    root = _state["uri"]
    root.mkdir(parents=True, exist_ok=True)
    return root


def _experiments() -> Dict[str, str]:
    """name -> experiment_id for all existing experiments."""
    out = {}
    for d in _root().iterdir():
        meta = d / "meta.yaml"
        if d.is_dir() and meta.exists():
            m = yamlio.load(meta.read_text()) or {}
            if "experiment_id" in m:
                out[m.get("name", d.name)] = str(m["experiment_id"])
    return out


def _client():
    m = _mlflow()
    if m is None:
        return None
    if _state.get("client") is None or _state.get("client_of") is not m:
        _state["client"] = m.tracking.MlflowClient()
        _state["client_of"] = m
    return _state["client"]


def set_experiment(name: str) -> str:
    c = _client()
    if c is not None:
        exp = c.get_experiment_by_name(name)
        exp_id = exp.experiment_id if exp else c.create_experiment(name)
        _state["experiment_id"] = exp_id
        return exp_id
    exps = _experiments()
    if name in exps:
        _state["experiment_id"] = exps[name]
        return exps[name]
    exp_id = str(len(exps) + 1)
    while (_root() / exp_id).exists():
        exp_id = str(int(exp_id) + 1)
    exp_dir = _root() / exp_id
    exp_dir.mkdir(parents=True)
    meta = {
        "artifact_location": str(exp_dir.resolve()),
        "creation_time": _ms(),
        "experiment_id": exp_id,
        "last_update_time": _ms(),
        "lifecycle_stage": "active",
        "name": name,
    }
    (exp_dir / "meta.yaml").write_text(yamlio.dump(meta))
    _state["experiment_id"] = exp_id
    return exp_id


class Run:
    """Handle to one tracked run; usable as a context manager.

    ``path`` is None in remote mode (artifacts live on the server).
    """

    def __init__(self, run_id: str, experiment_id: str,
                 path: Optional[Path]):
        self.run_id = run_id
        self.experiment_id = experiment_id
        self.path = path

    # mlflow-API-shaped accessors
    @property
    def info(self):
        return self

    @property
    def artifact_dir(self) -> Path:
        return self.path / "artifacts"

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        status = "FAILED" if exc_type else "FINISHED"
        end_run(status=status)
        return False


def _run_dir(run_id: str) -> Path:
    for exp_dir in _root().iterdir():
        cand = exp_dir / run_id
        if cand.is_dir() and (cand / "meta.yaml").exists():
            return cand
    raise KeyError(f"Run not found: {run_id}")


def start_run(run_name: Optional[str] = None, tags: Optional[dict] = None,
              nested: bool = False, run_id: Optional[str] = None,
              experiment_id: Optional[str] = None) -> Run:
    c = _client()
    if c is not None:
        if run_id is not None:
            info = c.get_run(run_id).info
            run = Run(run_id, info.experiment_id, None)
            _stack().append(run)
            return run
        exp_id = (experiment_id or _state["experiment_id"]
                  or set_experiment("Default"))
        all_tags = dict(tags or {})
        if run_name:
            all_tags.setdefault("mlflow.runName", run_name)
        parent = _stack()[-1] if nested and _stack() else None
        if parent is not None:
            all_tags.setdefault("mlflow.parentRunId", parent.run_id)
        r = c.create_run(exp_id,
                         tags={k: str(v) for k, v in all_tags.items()},
                         run_name=run_name)
        run = Run(r.info.run_id, exp_id, None)
        _stack().append(run)
        return run
    if run_id is not None:  # resume existing
        path = _run_dir(run_id)
        run = Run(run_id, path.parent.name, path)
        _stack().append(run)
        return run
    exp_id = experiment_id or _state["experiment_id"] or set_experiment("Default")
    rid = uuid.uuid4().hex
    path = _root() / exp_id / rid
    for sub in ("params", "metrics", "tags", "artifacts"):
        (path / sub).mkdir(parents=True)
    meta = {
        "artifact_uri": str((path / "artifacts").resolve()),
        "end_time": None,
        "entry_point_name": "",
        "experiment_id": exp_id,
        "lifecycle_stage": "active",
        "run_id": rid,
        "run_name": run_name or rid[:8],
        "run_uuid": rid,
        "source_name": "",
        "source_type": 4,
        "source_version": "",
        "start_time": _ms(),
        "status": 1,  # RUNNING
        "user_id": "anap3",
    }
    (path / "meta.yaml").write_text(yamlio.dump(meta))
    run = Run(rid, exp_id, path)
    _stack().append(run)
    if run_name:
        set_tag("mlflow.runName", run_name)
    parent = _stack()[-2] if nested and len(_stack()) > 1 else None
    if parent is not None:
        set_tag("mlflow.parentRunId", parent.run_id)
    for key, value in (tags or {}).items():
        set_tag(key, value)
    return run


def active_run() -> Optional[Run]:
    return _stack()[-1] if _stack() else None


def create_detached_run(run_name: Optional[str] = None,
                        tags: Optional[dict] = None) -> Run:
    """Create a run that stays RUNNING in the store but is NOT attached to
    the active-run stack — the sweep-parent pattern (reference
    callback.py:65-134 pre-creates parents that children reference by id
    while other runs open and close around them). Log to it later with
    ``attach_run(run.run_id)``."""
    run = start_run(run_name=run_name, tags=tags)
    _stack().pop()
    return run


class attach_run:
    """Context manager that temporarily re-attaches an EXISTING run for
    additional logging without touching its status on exit (unlike
    ``start_run(run_id=...)`` + ``end_run``, which would re-finalize it)."""

    def __init__(self, run_id: str):
        self.run_id = run_id

    def __enter__(self) -> Run:
        if _client() is not None:
            run = Run(self.run_id, "", None)
        else:
            path = _run_dir(self.run_id)
            run = Run(self.run_id, path.parent.name, path)
        _stack().append(run)
        return run

    def __exit__(self, exc_type, exc, tb):
        _stack().pop()
        return False


def end_run(status: str = "FINISHED") -> None:
    run = _stack().pop() if _stack() else None
    if run is None:
        return
    c = _client()
    if c is not None:
        c.set_terminated(run.run_id, status=status)
        return
    meta_path = run.path / "meta.yaml"
    meta = yamlio.load(meta_path.read_text())
    meta["end_time"] = _ms()
    meta["status"] = 3 if status == "FINISHED" else 4
    meta_path.write_text(yamlio.dump(meta))


def _require_run() -> Run:
    run = active_run()
    if run is None:
        raise RuntimeError("No active run — call start_run() first")
    return run


def log_params(params: dict) -> None:
    run = _require_run()
    c = _client()
    if c is not None:
        for k, v in params.items():
            c.log_param(run.run_id, str(k), v)
        return
    for k, v in params.items():
        (run.path / "params" / str(k)).write_text(str(v))


def log_metric(key: str, value, step: int = 0) -> None:
    run = _require_run()
    c = _client()
    if c is not None:
        c.log_metric(run.run_id, str(key), float(value), timestamp=_ms(),
                     step=int(step))
        return
    with open(run.path / "metrics" / str(key), "a") as fh:
        fh.write(f"{_ms()} {float(value)} {int(step)}\n")


def log_metrics(metrics: dict, step: int = 0) -> None:
    for k, v in metrics.items():
        log_metric(k, v, step)


def log_batch(run_id: str, metrics: List[tuple]) -> None:
    """Batched (key, value, step) logging — mirrors MlflowClient.log_batch."""
    c = _client()
    if c is not None:
        from mlflow.entities import Metric

        now = _ms()
        ents = [Metric(str(k), float(v), now, int(s)) for k, v, s in metrics]
        for i in range(0, len(ents), 1000):  # server batch-size limit
            c.log_batch(run_id, metrics=ents[i:i + 1000])
        return
    path = _run_dir(run_id)
    grouped: Dict[str, list] = {}
    for key, value, step in metrics:
        grouped.setdefault(key, []).append((value, step))
    now = _ms()
    for key, rows in grouped.items():
        with open(path / "metrics" / key, "a") as fh:
            for value, step in rows:
                fh.write(f"{now} {float(value)} {int(step)}\n")


def set_tag(key: str, value) -> None:
    run = _require_run()
    c = _client()
    if c is not None:
        c.set_tag(run.run_id, str(key), str(value))
        return
    (run.path / "tags" / str(key)).write_text(str(value))


def log_artifact(filepath, artifact_path: str = "") -> None:
    run = _require_run()
    c = _client()
    if c is not None:
        c.log_artifact(run.run_id, str(filepath), artifact_path or None)
        return
    dest = run.artifact_dir / artifact_path
    dest.mkdir(parents=True, exist_ok=True)
    shutil.copy2(str(filepath), dest / Path(filepath).name)


def log_dict(data: dict, artifact_file: str) -> None:
    run = _require_run()
    c = _client()
    if c is not None:
        c.log_dict(run.run_id, data, artifact_file)
        return
    dest = run.artifact_dir / artifact_file
    dest.parent.mkdir(parents=True, exist_ok=True)
    if artifact_file.endswith((".yaml", ".yml")):
        dest.write_text(yamlio.dump(data))
    else:
        dest.write_text(json.dumps(data, indent=2, default=str))


def log_table(rows, artifact_file: str) -> None:
    """Rows (list of dicts or DataFrame) -> mlflow-style table JSON artifact."""
    run = _require_run()
    if hasattr(rows, "columns"):  # a DataFrame
        columns, data = list(rows.columns), rows.values.tolist()
    else:
        columns = list(dict.fromkeys(k for row in rows for k in row))
        data = [[row.get(c) for c in columns] for row in rows]
    payload = {"columns": columns, "data": data}
    c = _client()
    if c is not None:
        c.log_dict(run.run_id, payload, artifact_file)
        return
    dest = run.artifact_dir / artifact_file
    dest.parent.mkdir(parents=True, exist_ok=True)
    dest.write_text(json.dumps(payload, indent=2, default=str))


# ---------------------------------------------------------------------------
# Queries
# ---------------------------------------------------------------------------


def _read_run(path: Path) -> dict:
    meta = yamlio.load((path / "meta.yaml").read_text()) or {}
    params = {p.name: p.read_text() for p in (path / "params").iterdir()} \
        if (path / "params").exists() else {}
    tags = {t.name: t.read_text() for t in (path / "tags").iterdir()} \
        if (path / "tags").exists() else {}
    status_map = {1: "RUNNING", 3: "FINISHED", 4: "FAILED"}
    metrics = {}
    mdir = path / "metrics"
    if mdir.exists():
        for mfile in mdir.iterdir():
            lines = mfile.read_text().strip().splitlines()
            if lines:
                metrics[mfile.name] = float(lines[-1].split()[1])
    return {
        "run_id": meta.get("run_id", path.name),
        "experiment_id": meta.get("experiment_id", path.parent.name),
        "run_name": meta.get("run_name", ""),
        "status": status_map.get(meta.get("status"), "RUNNING"),
        "start_time": meta.get("start_time"),
        "params": params,
        "tags": tags,
        "metrics": metrics,
        "path": path,
    }


def search_runs(experiment_name: Optional[str] = None,
                params: Optional[dict] = None,
                tags: Optional[dict] = None,
                status: Optional[str] = None,
                parent_run_id: Optional[str] = None) -> List[dict]:
    """Filter runs by experiment, exact param/tag values, status, parent."""
    c = _client()
    if c is not None:
        if experiment_name is not None:
            exp = c.get_experiment_by_name(experiment_name)
            exp_ids = [exp.experiment_id] if exp else []
        else:
            exp_ids = [e.experiment_id for e in c.search_experiments()]
        out = []
        runs = []
        token = None
        while True:  # page through: a >1000-run experiment must not hide
            page = c.search_runs(exp_ids, max_results=1000, page_token=token)
            runs.extend(page)
            token = getattr(page, "token", None)
            if not token:
                break
        for r in runs:
            run = {
                "run_id": r.info.run_id,
                "experiment_id": r.info.experiment_id,
                "run_name": r.info.run_name,
                "status": r.info.status,
                "start_time": r.info.start_time,
                "params": dict(r.data.params),
                "tags": dict(r.data.tags),
                "metrics": dict(r.data.metrics),
                "path": None,
            }
            if status and run["status"] != status:
                continue
            if params and any(run["params"].get(k) != str(v)
                              for k, v in params.items()):
                continue
            if tags and any(run["tags"].get(k) != str(v)
                            for k, v in tags.items()):
                continue
            if parent_run_id and run["tags"].get("mlflow.parentRunId") \
                    != parent_run_id:
                continue
            out.append(run)
        out.sort(key=lambda r: r.get("start_time") or 0, reverse=True)
        return out
    exps = _experiments()
    if experiment_name is not None:
        exp_ids = [exps[experiment_name]] if experiment_name in exps else []
    else:
        exp_ids = list(exps.values())
    out = []
    for exp_id in exp_ids:
        exp_dir = _root() / exp_id
        for run_dir in sorted(exp_dir.iterdir()):
            if not run_dir.is_dir() or not (run_dir / "meta.yaml").exists():
                continue
            run = _read_run(run_dir)
            if status and run["status"] != status:
                continue
            if params and any(run["params"].get(k) != str(v)
                              for k, v in params.items()):
                continue
            if tags and any(run["tags"].get(k) != str(v)
                            for k, v in tags.items()):
                continue
            if parent_run_id and run["tags"].get("mlflow.parentRunId") \
                    != parent_run_id:
                continue
            out.append(run)
    out.sort(key=lambda r: r.get("start_time") or 0, reverse=True)
    return out


def get_metric_history(run_id: str, key: str) -> List[tuple]:
    """[(step, value)] history for one metric."""
    c = _client()
    if c is not None:
        rows = [(m.step, m.value) for m in c.get_metric_history(run_id, key)]
        rows.sort(key=lambda r: r[0])
        return rows
    path = _run_dir(run_id) / "metrics" / key
    if not path.exists():
        return []
    rows = []
    for line in path.read_text().strip().splitlines():
        ts, value, step = line.split()
        rows.append((int(step), float(value)))
    rows.sort(key=lambda r: r[0])
    return rows


def download_artifacts(run_id: str, dst_dir) -> Path:
    """Copy a run's artifacts to dst_dir (API parity with mlflow download)."""
    dst = Path(dst_dir)
    dst.mkdir(parents=True, exist_ok=True)
    m = _mlflow()
    if m is not None:
        m.artifacts.download_artifacts(run_id=run_id, dst_path=str(dst))
        return dst
    src = _run_dir(run_id) / "artifacts"
    if src.exists():
        shutil.copytree(src, dst, dirs_exist_ok=True)
    return dst
