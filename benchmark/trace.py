"""Spans from the benchmark's side and the reduction of a profiled window.

:class:`Spans` wraps the program's entry points, on the instances and
module namespaces that call them, in ``torch.profiler.record_function``
ranges named ``bench/<span>``, and records each call's shapes while
``recording`` is set. :func:`reduce` turns the profiler's events into the
device's busy time (the union of its kernel, copy and set intervals), the
device time of the kernels launched inside each span (a kernel counts for
every span open on the launching thread when its launch call began), the
top device operations and the longest idle gaps by what the
host was doing.
"""

from __future__ import annotations

import functools
from collections import defaultdict
from typing import Callable, Dict, List, Optional, Tuple

import torch
from torch.profiler import ProfilerActivity, profile, record_function

PREFIX = "bench/"
LAUNCH_NAMES = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx",
                "cudaMemcpyAsync", "cudaMemsetAsync", "cudaMemcpy", "cudaMemset")


class Spans:
    """Record-function ranges around entry points, with their calls' shapes."""

    def __init__(self):
        self.calls: Dict[str, List[Tuple]] = defaultdict(list)
        self.recording = False
        self._undo: List[Tuple[object, str, object]] = []

    def wrap(self, owner, attr: str, span: str,
             shapes: Optional[Callable[..., Tuple]] = None) -> None:
        """Replace ``owner.attr`` by a ranged call; ``shapes(*args,
        **kwargs)`` says what to record of each call."""
        fn = getattr(owner, attr)
        name = PREFIX + span

        @functools.wraps(fn)
        def ranged(*args, **kwargs):
            if self.recording and shapes is not None:
                self.calls[span].append(shapes(*args, **kwargs))
            with record_function(name):
                return fn(*args, **kwargs)

        self._undo.append((owner, attr, fn))
        setattr(owner, attr, ranged)

    def restore(self) -> None:
        for owner, attr, fn in reversed(self._undo):
            setattr(owner, attr, fn)
        self._undo.clear()


def start_profile():
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    prof.__enter__()
    return prof


def stop_profile(prof) -> list:
    prof.__exit__(None, None, None)
    return list(prof.profiler.kineto_results.events())


def _union(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    """The union of [start, end) intervals, merged. Busy time is its length:
    ``chip_smoke.py``'s ``device_breakdown`` idle share (1 - busy / span),
    copied with busy taken as this union where it summed durations."""
    merged: List[Tuple[int, int]] = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            if e > merged[-1][1]:
                merged[-1] = (merged[-1][0], e)
        else:
            merged.append((s, e))
    return merged


def enclosing(intervals: List[Tuple[int, int, str]], points: List[int]) -> List[List[str]]:
    """For each time in ``points``, the names of the intervals of
    ``intervals`` (start, end, name; nested, as one thread's ranges are)
    that hold it, innermost last."""
    marks = [(s, 0, i) for i, (s, _, _) in enumerate(intervals)]
    marks += [(t, 1, i) for i, t in enumerate(points)]
    marks += [(e, 2, i) for i, (_, e, _) in enumerate(intervals)]
    out: List[List[str]] = [[] for _ in points]
    stack: List[int] = []
    for _, kind, i in sorted(marks):
        if kind == 0:
            stack.append(i)
        elif kind == 1:
            out[i] = [intervals[j][2] for j in stack]
        elif i in stack:
            stack.remove(i)
    return out


def _is_annotation(e) -> bool:
    kind = e.activity_type() if hasattr(e, "activity_type") else ""
    return (kind == "gpu_user_annotation" or e.name().startswith(PREFIX)
            or (hasattr(e, "is_user_annotation") and e.is_user_annotation()))


def _end_ns(e) -> int:
    return e.end_ns() if hasattr(e, "end_ns") else e.start_ns() + e.duration_ns()


def reduce(events: list) -> Dict:
    """Busy seconds, device seconds per span, the top device operations and
    the idle gaps by host activity, from a profiled window's events."""
    device, launches = [], {}
    spans, host_ops = defaultdict(list), defaultdict(list)
    for e in events:
        name = e.name()
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            # Kernels, copies and sets; not the device-side copies of the
            # host's ranges.
            if e.duration_ns() > 0 and not _is_annotation(e):
                device.append(e)
        elif name in LAUNCH_NAMES:
            launches[e.correlation_id()] = (e.start_thread_id(), e.start_ns())
        elif name.startswith(PREFIX):
            spans[e.start_thread_id()].append((e.start_ns(), _end_ns(e), name[len(PREFIX):]))
        elif not name.startswith(("cuda", "cu")):
            host_ops[e.start_thread_id()].append((e.start_ns(), _end_ns(e), name))
    if not device:
        return {}

    busy = _union([(e.start_ns(), _end_ns(e)) for e in device])
    by_op: Dict[str, float] = defaultdict(float)
    by_thread: Dict[int, List[Tuple[int, float]]] = defaultdict(list)
    for e in device:
        sec = e.duration_ns() / 1e9
        by_op[e.name()[:96]] += sec
        linked = e.linked_correlation_id() if hasattr(e, "linked_correlation_id") else 0
        launch = launches.get(linked) or launches.get(e.correlation_id())
        if launch is not None:
            by_thread[launch[0]].append((launch[1], sec))
    by_span: Dict[str, float] = defaultdict(float)
    for tid, items in by_thread.items():
        for names, (_, sec) in zip(enclosing(spans.get(tid, []), [t for t, _ in items]), items):
            for name in set(names):
                by_span[name] += sec

    gaps: Dict[str, float] = defaultdict(float)
    main = max(host_ops, key=lambda tid: len(host_ops[tid]), default=None)
    edges = [(e0, s1) for (_, e0), (s1, _) in zip(busy, busy[1:])]
    held = enclosing(host_ops[main], [e0 for e0, _ in edges]) if main is not None else []
    for (e0, s1), names in zip(edges, held):
        gaps[(names[-1] if names else "host: no op")[:96]] += (s1 - e0) / 1e9

    def top(d):
        return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:10]]

    return {"busy_s": sum(e - s for s, e in busy) / 1e9,
            "device_s_by_span": dict(by_span),
            "kernels": len(device), "attributed": sum(len(v) for v in by_thread.values()),
            "device_ops": top(by_op), "idle_gaps": top(gaps)}
