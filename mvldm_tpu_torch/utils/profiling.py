"""Profiling and throughput instrumentation (counterpart of
``mvldm_tpu/utils/profiling.py``).

* :func:`trace` — a context manager around a ``torch.profiler`` trace of
  the enclosed block, written as a Chrome trace when a directory is given
  or ``MVLDM_PROFILE_DIR`` is set (a no-op otherwise, so it can wrap hot
  loops unconditionally); :func:`start_trace` / :func:`stop_trace` are its
  two halves, for a window that spans loop iterations.
* :func:`annotate` — a named region inside a trace.
* :class:`ThroughputMeter` — rolling step time and items per second.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import deque
from pathlib import Path
from typing import Optional

import torch


def start_trace() -> torch.profiler.profile:
    """A started profiler of host and, with a card, device activity."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    return prof


def stop_trace(prof: torch.profiler.profile, path: Path) -> Path:
    """Stop ``prof`` and write its Chrome trace to ``<path>/trace.json``."""
    prof.stop()
    path = Path(path)
    path.mkdir(parents=True, exist_ok=True)
    out = path / "trace.json"
    prof.export_chrome_trace(str(out))
    return out


@contextlib.contextmanager
def trace(label: str, profile_dir: Optional[Path] = None):
    """Trace the enclosed block into ``<profile_dir>/<label>/`` when a
    directory is given or ``MVLDM_PROFILE_DIR`` is set."""
    target = profile_dir or os.environ.get("MVLDM_PROFILE_DIR")
    if not target:
        yield
        return
    prof = start_trace()
    try:
        yield
    finally:
        out = stop_trace(prof, Path(target) / label)
        print(f"[profile] wrote trace for {label!r} to {out}")


@contextlib.contextmanager
def annotate(label: str):
    """A named region inside a captured trace."""
    with torch.profiler.record_function(label):
        yield


class ThroughputMeter:
    """Rolling window throughput counter."""

    def __init__(self, window: int = 50):
        self._times: deque = deque(maxlen=window)
        self._counts: deque = deque(maxlen=window)
        self._last = time.perf_counter()

    def tick(self, items: int = 1) -> None:
        now = time.perf_counter()
        self._times.append(now - self._last)
        self._counts.append(items)
        self._last = now

    def reset_clock(self) -> None:
        self._last = time.perf_counter()

    @property
    def items_per_sec(self) -> float:
        total_t = sum(self._times)
        return sum(self._counts) / total_t if total_t > 0 else 0.0

    @property
    def mean_step_time(self) -> float:
        return sum(self._times) / len(self._times) if self._times else 0.0
