"""Tracing / profiling hooks.

The reference has no tracer — wall time is a ``time.time()`` difference with
tracking time subtracted (base.py:238-239,315-316; SURVEY §5). Here:

- ``phase_timer``: nestable named phase timing collected into a dict that the
  driver logs as metrics (setup/solve/analysis/plots breakdown);
- ``device_trace``: context manager around ``jax.profiler.trace`` writing a
  TensorBoard-loadable trace directory (any backend);
- ``device_activity``: reduces a written trace to the device's busy time,
  idle share and kernel count (bench.py reads it);
- throughput accounting: ``timesteps_per_sec`` computed from the runner's
  iteration count and wall time and logged alongside wall_time_seconds.
"""

from __future__ import annotations

import collections
import contextlib
import logging
import time
from pathlib import Path
from typing import Dict, Iterator, List, Optional, Tuple

log = logging.getLogger(__name__)

__all__ = ["PhaseTimer", "device_trace", "device_activity", "busy_time"]


class PhaseTimer:
    """Collects named wall-time phases; ``as_metrics()`` for tracking."""

    def __init__(self):
        self.phases: Dict[str, float] = {}

    @contextlib.contextmanager
    def phase(self, name: str) -> Iterator[None]:
        t0 = time.time()
        try:
            yield
        finally:
            self.phases[name] = self.phases.get(name, 0.0) + time.time() - t0

    def as_metrics(self, prefix: str = "time_") -> Dict[str, float]:
        return {f"{prefix}{k}_seconds": round(v, 4)
                for k, v in self.phases.items()}


@contextlib.contextmanager
def device_trace(trace_dir: Optional[str]) -> Iterator[None]:
    """jax.profiler trace when a directory is given; no-op otherwise."""
    if not trace_dir:
        yield
        return
    import jax

    Path(trace_dir).mkdir(parents=True, exist_ok=True)
    try:
        jax.profiler.start_trace(str(trace_dir))
        started = True
    except Exception as exc:  # tracing must never kill a run
        log.warning("Device tracing failed to start: %s", exc)
        started = False
    try:
        yield
    finally:
        if started:
            try:
                jax.profiler.stop_trace()
                log.info("Wrote device trace to %s", trace_dir)
            except Exception as exc:
                log.warning("Device tracing failed to stop: %s", exc)


def busy_time(intervals: List[Tuple[float, float]]) -> float:
    """Length of the union of ``(start, end)`` intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def device_activity(trace_dir, plane_prefix: str = "/device:GPU",
                    line_prefix: str = "Stream") -> dict:
    """Busy/idle summary of the newest trace written under ``trace_dir``.

    Kernel events are those on the lines named ``line_prefix...`` (the
    per-stream activity lines) of the planes named ``plane_prefix...``.
    The window runs from the first kernel's start to the last kernel's end,
    so ``idle_share`` is the device's idle time between kernels inside it.
    """
    from jax.profiler import ProfileData

    files = sorted(Path(trace_dir).glob("**/*.xplane.pb"),
                   key=lambda f: f.stat().st_mtime)
    if not files:
        raise FileNotFoundError(f"no .xplane.pb under {trace_dir}")
    data = ProfileData.from_file(str(files[-1]))
    intervals, names, lines_seen = [], collections.Counter(), set()
    for plane in data.planes:
        if not plane.name.startswith(plane_prefix):
            continue
        for line in plane.lines:
            lines_seen.add(line.name)
            if not line.name.startswith(line_prefix):
                continue
            for ev in line.events:
                intervals.append((ev.start_ns, ev.start_ns + ev.duration_ns))
                names[ev.name] += 1
    if not intervals:
        raise ValueError(f"no {line_prefix!r} events on {plane_prefix!r} "
                         f"planes; lines seen: {sorted(lines_seen)}")
    window = max(e for _, e in intervals) - min(s for s, _ in intervals)
    busy = busy_time(intervals)
    return {
        "kernels": len(intervals),
        "busy_seconds": busy * 1e-9,
        "window_seconds": window * 1e-9,
        "idle_share": 1.0 - busy / window if window > 0 else 0.0,
        "top_kernels": names.most_common(8),
    }
