"""The program's own tracing: named spans and counts of host syncs,
recorded only while a ``torch.profiler`` session runs.

* :func:`span` — a region of the program, as a context manager or a
  decorator. While a profiler runs it opens
  ``torch.profiler.record_function("mvldm/" + name)``, so the region lies
  on the trace's timeline beside the kernels it launches and the device's
  idle gaps, and adds its count, host time and self time (its time less
  that of the spans opened inside it on the same thread) to an in-memory
  registry. Otherwise it costs one check of the profiler's flag.
* :func:`sync` — a span named ``sync.<site>`` around one call that holds
  the host until the device has drained (a pageable upload, a copy to the
  host, a value read on the host); while a profiler runs it also adds 1 to
  the counter ``sync.<site>``. A site counts where the program reaches it,
  on any device: on the card each such call is a sync, on the CPU none is.
* :func:`snapshot` / :func:`reset` — the registry.
* :func:`start_trace` / :func:`stop_trace` — a profiler of host and, with a
  card, device activity, and its Chrome trace.

Spans, from the entry points down (``args`` in parentheses, on the trace's
range only):

* ``sampler.dispatch`` (kind, scenes, frames): one ``VideoSampler``
  dispatch; its self time is planning, camera stacking and padding;
* ``sampler.launch`` (kind anchor / chain / fill / ar, rows, v_c, v_t):
  one launch of a dispatch, camera stacking included;
* ``sampler.gather``: launch outputs copied to the host;
* ``engine.encode``, ``engine.ray_encode``, ``engine.sample_latents``,
  ``engine.decode``, ``engine.denoise_step``, ``engine.training_loss``:
  the ``DiffusionEngine`` method of that name;
* ``engine.t2mv`` (prompts, views, steps): one ``text_to_multiview``
  call (MVDream), its decode included;
* ``engine.unet`` (branch cond / uncond / batched / train): one UNet call;
* ``train.forward_backward``, ``train.grad_norm``, ``train.optimizer``,
  ``train.load_params``, ``train.ema``: the parts of a training step;
* ``optim.accumulate``, ``optim.clip``, ``optim.update``: the parts of
  ``Optimizer.apply``;
* ``train.data_wait``, ``train.log``, ``train.checkpoint``, ``train.val``:
  the ``Trainer``'s loop around its steps;
* ``ops.attention``, ``ops.flash_attention_bwd_dq``,
  ``ops.flash_attention_bwd_dkv``, ``ops.fused_ln_self_attention``,
  ``ops.fused_ln_geglu_ff``, ``ops.text_cross_attention`` (MVDream's
  attn2 core): the ``ops`` entry points the models call;
* ``ops.group_norm`` (route kernel / stock): one ``models/layers.GroupNorm``
  call, on the channels-last kernel of ``ops/group_norm.py`` or on the stock
  ``F.group_norm`` chain.

Sync sites (``sync.<site>``): ``upload`` (a sampler's host arrays),
``batch_upload`` (a training batch's host tensors), ``schedule_upload``
(the noise schedule's table, noising a training batch), ``pose_index``
(the list index by which ``absolute_to_relative_camera`` picks its
reference view), ``relative_pose`` (that function's inverse),
``world_rays`` (``get_world_rays``' inverse), ``gather`` (a launch output
to the host), ``grad_norm`` (the gradient norm read on the host),
``t2mv_upload`` (a ``text_to_multiview`` call's inputs, one copy each),
``t2mv_gather`` (its uint8 frames to the host).
"""

from __future__ import annotations

import functools
import json
import threading
import time
from pathlib import Path
from typing import Any, Dict, List, Optional

import torch

PREFIX = "mvldm/"

_profiling = torch.autograd._profiler_enabled
_lock = threading.Lock()
_local = threading.local()
_spans: Dict[str, List[int]] = {}  # name -> [count, total ns, self ns]
_counters: Dict[str, int] = {}


class span:
    """``with span(name, args):`` or ``@span(name)``; see the module's
    docstring. ``args`` (a JSON-able dict) goes onto the trace's range."""

    __slots__ = ("name", "args", "_range", "_t0", "_children")

    def __init__(self, name: str, args: Optional[Dict[str, Any]] = None):
        self.name, self.args, self._range = name, args, None

    def __enter__(self) -> "span":
        if not _profiling():
            return self
        self._range = torch.autograd.profiler.record_function(
            PREFIX + self.name, json.dumps(self.args) if self.args else None)
        self._range.__enter__()
        self._children = 0
        _stack().append(self)
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> None:
        if self._range is None:
            return
        took = time.perf_counter_ns() - self._t0
        stack = _stack()
        stack.pop()
        if stack:
            stack[-1]._children += took
        with _lock:
            entry = _spans.setdefault(self.name, [0, 0, 0])
            entry[0] += 1
            entry[1] += took
            entry[2] += took - self._children
        self._range.__exit__(*exc)
        self._range = None

    def __call__(self, fn):
        name, args = self.name, self.args

        @functools.wraps(fn)
        def spanned(*a, **k):
            if not _profiling():
                return fn(*a, **k)
            with span(name, args):
                return fn(*a, **k)

        return spanned


class sync(span):
    """A span named ``sync.<site>`` that also counts one host sync."""

    __slots__ = ()

    def __init__(self, site: str):
        super().__init__("sync." + site)

    def __enter__(self) -> "sync":
        super().__enter__()
        if self._range is not None:
            with _lock:
                _counters[self.name] = _counters.get(self.name, 0) + 1
        return self


def _stack() -> List[span]:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


def snapshot() -> Dict[str, Dict]:
    """``{"spans": {name: {count, total_ms, self_ms}}, "counters": {name:
    value}}``: what the spans recorded since the last :func:`reset`."""
    with _lock:
        spans = {k: {"count": c, "total_ms": t / 1e6, "self_ms": s / 1e6}
                 for k, (c, t, s) in _spans.items()}
        return {"spans": spans, "counters": dict(_counters)}


def reset() -> None:
    with _lock:
        _spans.clear()
        _counters.clear()


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
