#!/usr/bin/env python
"""Cluster sweep submission: pre-create the parent run, emit a job script.

Counterpart of the reference's LSF job-array generator
(scripts/hpc_submit.py): it reads an experiment overlay's sweep parameters,
pre-creates the tracking parent run BEFORE submission — the same
race-avoidance the reference applies (hpc_submit.py:23-27,178-180: many
array members would otherwise race to create the parent) — and writes a
submission script with one sweep point per array index.

Two backends:
- ``--backend lsf``: a ``bsub -J name[1-N]`` array script (DTU-HPC parity);
- ``--backend shell``: a plain bash fan-out for one host (members run
  sequentially or under ``parallel -j``; for a single-accelerator host the
  in-process vmapped sweep in main.py is normally the better tool — this
  exists for heterogeneous sweeps that cannot share one device batch).

Usage:
    python scripts/hpc_submit.py +experiment/validation/ghia=spectral \
        --backend lsf --out submit_ghia.sh
"""

from __future__ import annotations

import argparse
import itertools
import sys
from pathlib import Path

REPO_ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO_ROOT))

from anap3_tpu.utils import config as C  # noqa: E402
from anap3_tpu.utils import tracking as T  # noqa: E402


def collect_sweep(cfg: dict) -> dict:
    params = cfg.get("hydra", {}).get("sweeper", {}).get("params", {}) or {}
    out = {}
    for key, val in params.items():
        parsed = C._parse_value(str(val), allow_sweep=True)
        if isinstance(parsed, C.Interval):
            raise SystemExit(
                f"{key} is an interval() — use the optimization driver "
                "(python main.py -m ...), not array submission")
        out[key] = parsed if isinstance(parsed, list) else [parsed]
    return out


def precreate_parent(cfg: dict) -> str:
    T.set_tracking_uri(cfg.get("mlflow", {}).get("tracking_uri", "./mlruns"))
    name = cfg.get("experiment_name", "LDC-Dev")
    prefix = cfg.get("mlflow", {}).get("project_prefix", "") or ""
    if prefix and not name.startswith("/"):
        name = f"{prefix}/{name}"
    T.set_experiment(name)
    sweep_name = str(cfg.get("sweep_name", "sweep"))
    existing = T.search_runs(name, tags={"is_parent": "true",
                                         "mlflow.runName": sweep_name})
    if existing:
        return existing[0]["run_id"]
    run = T.create_detached_run(run_name=sweep_name,
                                tags={"is_parent": "true"})
    return run.run_id


LSF_TEMPLATE = """#!/bin/bash
#BSUB -J {name}[1-{n_jobs}]
#BSUB -q {queue}
#BSUB -n {cores}
#BSUB -R "rusage[mem={mem_gb}GB]"
#BSUB -W {walltime}
#BSUB -o logs/{name}_%J_%I.out
#BSUB -e logs/{name}_%J_%I.err

mkdir -p logs
export MLFLOW_PARENT_RUN_ID={parent_id}

OVERRIDES=(
{override_lines}
)
IDX=$((LSB_JOBINDEX - 1))
cd {repo}
python main.py ${{OVERRIDES[$IDX]}} {base_overrides}
"""

SHELL_TEMPLATE = """#!/bin/bash
# Sweep fan-out generated by scripts/hpc_submit.py
set -e
export MLFLOW_PARENT_RUN_ID={parent_id}
cd {repo}

OVERRIDES=(
{override_lines}
)
for ov in "${{OVERRIDES[@]}}"; do
    echo "=== $ov ==="
    python main.py $ov {base_overrides}
done
"""


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("overrides", nargs="*", help="config overrides incl. "
                    "+experiment/...=name")
    ap.add_argument("--backend", choices=("lsf", "shell"), default="shell")
    ap.add_argument("--out", default="submit_sweep.sh")
    ap.add_argument("--queue", default="hpc")
    ap.add_argument("--cores", type=int, default=6)
    ap.add_argument("--mem-gb", type=int, default=6)
    ap.add_argument("--walltime", default="24:00")
    args = ap.parse_args()

    cfg = C.compose(REPO_ROOT / "conf", args.overrides)
    sweep = collect_sweep(cfg)
    if not sweep:
        raise SystemExit("No sweep parameters found in the composed config")

    keys = list(sweep)
    combos = list(itertools.product(*(sweep[k] for k in keys)))
    parent_id = precreate_parent(cfg)
    print(f"Parent run: {parent_id} ({len(combos)} sweep members)")

    override_lines = "\n".join(
        '    "' + " ".join(f"{k}={v}" for k, v in zip(keys, combo)) + '"'
        for combo in combos
    )
    base_overrides = " ".join(ov for ov in args.overrides)

    template = LSF_TEMPLATE if args.backend == "lsf" else SHELL_TEMPLATE
    script = template.format(
        name=str(cfg.get("sweep_name", "sweep")).replace("/", "-"),
        n_jobs=len(combos), queue=args.queue, cores=args.cores,
        mem_gb=args.mem_gb, walltime=args.walltime, parent_id=parent_id,
        override_lines=override_lines, base_overrides=base_overrides,
        repo=REPO_ROOT,
    )
    out = Path(args.out)
    out.write_text(script)
    out.chmod(0o755)
    print(f"Wrote {args.backend} submission script: {out}")


if __name__ == "__main__":
    main()
