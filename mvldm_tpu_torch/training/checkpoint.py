"""Checkpoint save / restore (counterpart of
``mvldm_tpu/training/checkpoint.py``).

``<directory>/step_<step:09d>/state.pt`` holds one ``torch.save`` of the
train state (state dicts of tensors and plain numbers). A save writes into a
temporary sibling directory (``step_<step>.tmp-<pid>``) and renames it into
place, so a crash mid-write leaves only a directory that :meth:`all_steps`
skips. A ``latest`` file names the newest saved step; the directory scan,
not the pointer, decides :meth:`latest_step`. Only the newest
``save_top_k`` steps are kept. Orbax's format (the JAX package's) is not
carried over: the two packages cannot read each other's checkpoints. Under
a multi-rank strategy the trainer gathers the whole state and rank 0 alone
calls :meth:`save`, so a checkpoint restores under any strategy and on one
card.
"""

from __future__ import annotations

import json
import os
import shutil
from pathlib import Path
from typing import Any, Dict, List, Optional

import torch


class CheckpointManager:
    def __init__(self, directory, save_top_k: int = 1):
        self.directory = Path(directory)
        self.directory.mkdir(parents=True, exist_ok=True)
        self.save_top_k = save_top_k

    def _step_dir(self, step: int) -> Path:
        return self.directory / f"step_{step:09d}"

    def save(self, step: int, state: Dict[str, Any]) -> Path:
        """Write ``state`` for ``step`` atomically, point ``latest`` at it,
        and prune to the newest ``save_top_k``."""
        path = self._step_dir(step)
        tmp = path.with_name(f"{path.name}.tmp-{os.getpid()}")
        shutil.rmtree(tmp, ignore_errors=True)
        tmp.mkdir(parents=True)
        torch.save(state, tmp / "state.pt")
        if path.exists():
            shutil.rmtree(path)
        os.replace(tmp, path)
        (self.directory / "latest").write_text(json.dumps({"step": step}))
        for old in sorted(self.all_steps())[: -self.save_top_k]:
            shutil.rmtree(self._step_dir(old), ignore_errors=True)
        return path

    def all_steps(self) -> List[int]:
        """Steps of the committed checkpoints (temporary directories of an
        interrupted save are skipped)."""
        steps = []
        for p in self.directory.glob("step_*"):
            suffix = p.name.split("_", 1)[1]
            if p.is_dir() and suffix.isdigit() and (p / "state.pt").exists():
                steps.append(int(suffix))
        return sorted(steps)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: int, map_location=None, mmap: bool = False) -> Dict[str, Any]:
        return torch.load(self._step_dir(step) / "state.pt",
                          map_location=map_location, mmap=mmap, weights_only=True)

    def restore_partial(self, step: int, keys) -> Dict[str, Any]:
        """Only ``keys`` of the saved state (e.g. ``params`` or
        ``ema_params`` for sampling), on the host. The file is memory-mapped,
        so the other entries, the optimizer moments among them, are never
        read into memory."""
        state = torch.load(self._step_dir(step) / "state.pt", map_location="cpu",
                           mmap=True, weights_only=True)
        return {k: state[k] for k in keys}
