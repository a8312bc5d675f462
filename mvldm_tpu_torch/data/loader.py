"""Host-side batching and prefetch (counterpart of
``mvldm_tpu/data/loader.py``, batch for batch).

In place of the reference's ``DataModule``/``DataLoader`` stack
(``src/dataset/data_module.py:58-140``; 16 worker processes per rank), one
process: a background thread iterates the dataset, collates fixed-shape
numpy batches, and keeps a bounded queue ahead of the device. The process
index and count are the ``DataModule``'s (a training mesh passes its data
rank and data ranks), else those of ``torch.distributed`` when it is
initialised, else (0, 1).
"""

from __future__ import annotations

import queue
import threading
from dataclasses import dataclass, field
from typing import Any, Dict, Iterator, List, Optional

import numpy as np

from .dataset_re10k import DatasetRE10k, DatasetRE10kCfg
from .types import Example, Stage
from .view_samplers import StepTracker, get_view_sampler


def process_index_and_count() -> tuple[int, int]:
    """(rank, world size) of an initialised ``torch.distributed``, else (0, 1)."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


@dataclass
class DataLoaderStageCfg:
    """Reference ``data_module.py:33-40``. ``num_workers`` is honored as the
    width of the TRAIN decode thread pool (JPEG decode + LANCZOS crop run in
    PIL C code that releases the GIL, so threads scale without the
    reference's worker processes); ``persistent_workers`` is config-surface
    parity only."""

    num_workers: int = 16
    persistent_workers: bool = True
    batch_size: int = 6
    seed: Optional[int] = None


@dataclass
class DataLoaderCfg:
    """Reference ``data_module.py:43-47``."""

    train: DataLoaderStageCfg = field(default_factory=DataLoaderStageCfg)
    test: DataLoaderStageCfg = field(
        default_factory=lambda: DataLoaderStageCfg(
            persistent_workers=False, batch_size=1, seed=0
        )
    )
    val: DataLoaderStageCfg = field(
        default_factory=lambda: DataLoaderStageCfg(
            persistent_workers=False, batch_size=8, seed=0
        )
    )


def collate(examples: List[Example]) -> Dict[str, Any]:
    """Stack examples into the reference's batch dict layout
    (``BatchedExample``), NHWC."""

    def stack_views(views):
        out = {
            "extrinsics": np.stack([v.extrinsics for v in views]),
            "intrinsics": np.stack([v.intrinsics for v in views]),
            "near": np.stack([v.near for v in views]),
            "far": np.stack([v.far for v in views]),
            "index": np.stack([v.index for v in views]),
        }
        if views[0].image is not None:
            out["image"] = np.stack([v.image for v in views])
        if views[0].latent_moments is not None:
            out["latent_moments"] = np.stack(
                [v.latent_moments for v in views]
            )
        return out

    batch = {
        "context": stack_views([e.context for e in examples]),
        "scene": [e.scene for e in examples],
    }
    if examples[0].target is not None:
        batch["target"] = stack_views([e.target for e in examples])
    return batch


class PrefetchIterator:
    """Wraps an iterator with a bounded background-thread prefetch queue.

    ``close()`` tears the whole pipeline down deterministically: the worker
    thread stops, closes the source generator FROM ITS OWN THREAD (safe —
    the generator is suspended at a yield, and closing it propagates
    GeneratorExit down the generator stack, running e.g. the decode pool's
    drain-and-join teardown in ``_parallel_train_examples``), and exits.
    A worker exception takes the same cleanup path before being re-raised
    to the consumer."""

    _SENTINEL = object()

    def __init__(self, source: Iterator, depth: int = 2):
        self._queue: "queue.Queue" = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._worker, args=(source,), daemon=True
        )
        self._thread.start()

    def _put(self, item) -> bool:
        """Blocking put with stop checks; False once stopped."""
        while not self._stop.is_set():
            try:
                self._queue.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _worker(self, source):
        try:
            for item in source:
                if not self._put(item):
                    return
        except Exception as e:  # surface worker errors to the consumer
            self._put(e)
        finally:
            try:
                close = getattr(source, "close", None)
                if close is not None:
                    close()
            except Exception as e:  # teardown error: surface, don't hang
                self._put(e)
            finally:
                # Unconditional: a consumer blocked in __next__ must always
                # see either an item, an error, or the sentinel.
                self._put(self._SENTINEL)

    def __iter__(self):
        return self

    def __next__(self):
        while True:
            if self._stop.is_set():  # closed: never block on a dead queue
                raise StopIteration
            try:
                item = self._queue.get(timeout=0.1)
            except queue.Empty:
                continue
            if item is self._SENTINEL:
                raise StopIteration
            if isinstance(item, Exception):
                raise item
            return item

    def close(self, timeout: Optional[float] = None) -> None:
        """Stop the prefetch thread and close the source pipeline.
        Idempotent; a consumer blocked in ``__next__`` (even on another
        thread) unblocks with StopIteration. ``timeout`` bounds the wait for
        the worker to retire (None = wait indefinitely)."""
        import time as _time

        self._stop.set()
        deadline = None if timeout is None else _time.monotonic() + timeout
        while self._thread.is_alive():
            if deadline is not None and _time.monotonic() > deadline:
                return
            try:  # drain so a pending put() observes the stop quickly
                self._queue.get_nowait()
            except queue.Empty:
                pass
            self._thread.join(timeout=0.05)

    def __del__(self):  # GC backstop for consumers that break out of loops
        try:
            self.close(timeout=5.0)
        except Exception:
            pass


class DataModule:
    """Builds per-stage batched iterators (reference ``DataModule:58-140``).

    ``process``: (index, count) of this process's streams, by default
    :func:`process_index_and_count`; a training mesh passes (data rank, data
    ranks), so that the model ranks of one data rank read the same batches.
    ``seed``: the seed of a stage whose config has none (``seed: null``);
    ranks that must read the same stream pass one seed (drawn once and
    shared), where ``None`` leaves each process its own OS entropy."""

    def __init__(
        self,
        dataset_cfg: DatasetRE10kCfg,
        view_sampler_cfg,
        data_loader_cfg: DataLoaderCfg,
        step_tracker: Optional[StepTracker] = None,
        process: Optional[tuple[int, int]] = None,
        seed: Optional[int] = None,
    ):
        self.dataset_cfg = dataset_cfg
        self.view_sampler_cfg = view_sampler_cfg
        self.data_loader_cfg = data_loader_cfg
        self.step_tracker = step_tracker
        self.process, self.seed = process, seed

    def _seed(self, seed: Optional[int]) -> Optional[int]:
        return self.seed if seed is None else seed

    def _dataset(self, stage: Stage, seed: Optional[int]) -> DatasetRE10k:
        # Multi-host: each process draws an independent stream for train
        # (host-local data feeding, SURVEY.md §2.4) and stripes test chunks
        # across processes (the reference stripes across dataloader workers,
        # dataset_re10k.py:87-92).
        process, num_processes = self.process or process_index_and_count()
        seed = self._seed(seed)
        rng = np.random.default_rng(
            seed if seed is None else seed + process
        )
        sampler = get_view_sampler(
            self.view_sampler_cfg,
            stage,
            self.dataset_cfg.overfit_to_scene is not None,
            self.dataset_cfg.cameras_are_circular,
            self.step_tracker,
            rng=rng,
        )
        # Registry dispatch by cfg.name (reference src/dataset/__init__.py:19
        # maps both "re10k" and "re10k_non_iter").
        if self.dataset_cfg.name == "re10k_non_iter":
            from .dataset_re10kv2 import DatasetRE10kV2

            dataset_cls = DatasetRE10kV2
        else:
            dataset_cls = DatasetRE10k
        return dataset_cls(
            self.dataset_cfg,
            stage,
            sampler,
            rng=rng,
            worker_index=process,
            num_workers=num_processes,
        )

    def _batches(
        self, stage: Stage, cfg: DataLoaderStageCfg, repeat: bool
    ) -> Iterator[Dict[str, Any]]:
        while True:
            dataset = self._dataset(stage, cfg.seed)
            buf: List[Example] = []
            for example in dataset:
                buf.append(example)
                if len(buf) == cfg.batch_size:
                    yield collate(buf)
                    buf = []
            if buf and not repeat:
                yield collate(buf)
            if not repeat:
                return

    def _parallel_train_examples(
        self, cfg: DataLoaderStageCfg, num_workers: int
    ) -> Iterator[Example]:
        """Examples from ``num_workers`` independent dataset streams decoded
        in parallel threads — the analogue of the reference's 16 DataLoader
        worker processes (``config/main.yaml:44-57``), viable in-process
        because PIL's JPEG decode and LANCZOS resize release the GIL. Each
        worker draws an independent seeded stream, exactly like the
        reference's per-worker seeding (``data_module.py:53``).

        Workers decode ahead into per-worker bounded queues and the consumer
        merges them ROUND-ROBIN, so with ``cfg.seed`` set the example order
        (and therefore every collated batch) is a pure function of the seed
        — thread scheduling cannot reorder it. A free-running shared-queue
        merge would be marginally more elastic to decode-time variance, but
        it makes seeded runs non-reproducible; the torch reference's seeded
        DataLoader is likewise order-deterministic across workers."""
        qs = [queue.Queue(maxsize=2) for _ in range(num_workers)]
        stop = threading.Event()
        _SENTINEL = object()

        def put(q: "queue.Queue", item) -> bool:
            """Stop-aware bounded put; False once stopped."""
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def worker(widx: int):
            q = qs[widx]
            base = self._seed(cfg.seed)
            seed = None if base is None else base + 7919 * widx
            try:
                while not stop.is_set():
                    for example in self._dataset("train", seed):
                        if not put(q, example):
                            return
            except Exception as e:
                put(q, e)
            finally:
                put(q, _SENTINEL)

        threads = [
            threading.Thread(target=worker, args=(w,), daemon=True)
            for w in range(num_workers)
        ]
        for t in threads:
            t.start()
        alive = list(range(num_workers))
        try:
            i = 0
            while alive:
                idx = i % len(alive)
                item = qs[alive[idx]].get()
                if item is _SENTINEL:
                    # Train streams repeat forever; a sentinel means the
                    # worker errored (exception already consumed) or was
                    # stopped. Drop it from the rotation deterministically.
                    alive.pop(idx)
                    i = idx
                    continue
                if isinstance(item, Exception):
                    raise item
                yield item
                i = idx + 1
        finally:
            stop.set()
            # Unblock producers stuck on a full queue: keep draining every
            # queue until its worker has exited (a single drain pass could
            # re-strand a woken worker behind its own sentinel).
            for w, t in enumerate(threads):
                while t.is_alive():
                    try:
                        qs[w].get(timeout=0.1)
                    except queue.Empty:
                        pass
                    t.join(timeout=0.01)

    def train_dataloader(self) -> Iterator[Dict[str, Any]]:
        cfg = self.data_loader_cfg.train
        import os

        workers = max(1, min(cfg.num_workers, os.cpu_count() or 1))
        if workers == 1:
            return PrefetchIterator(self._batches("train", cfg, repeat=True))

        def batched() -> Iterator[Dict[str, Any]]:
            buf: List[Example] = []
            for example in self._parallel_train_examples(cfg, workers):
                buf.append(example)
                if len(buf) == cfg.batch_size:
                    yield collate(buf)
                    buf = []

        return PrefetchIterator(batched())

    def val_dataloader(self) -> Iterator[Dict[str, Any]]:
        cfg = self.data_loader_cfg.val
        return PrefetchIterator(self._batches("val", cfg, repeat=False))

    def test_dataloader(self) -> Iterator[Dict[str, Any]]:
        cfg = self.data_loader_cfg.test
        return PrefetchIterator(self._batches("test", cfg, repeat=False))
