"""Weights & Biases integration (gated: wandb is optional).

Re-creates the reference's wandb utilities
(``src/misc/wandb_tools.py:10-62``): resolving ``wandb://run_id[:version]``
checkpoint references by downloading the run's model artifact, plus a thin
logger wrapper that degrades to local JSONL/PNG logging (the reference's
``LocalLogger`` fallback, ``src/misc/LocalLogger.py:12-49``) when wandb is
unavailable or deactivated.

The port's copy of ``mvldm_tpu/utils/wandb_tools.py``: the offline parts
(the ``wandb://`` parse, the artifact choice, the ``Logger``'s JSONL / PNG
fallback) run without the package; an artifact fetch needs it and the
network.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Any, Dict, Optional

import numpy as np


def wandb_available() -> bool:
    try:
        import wandb  # noqa: F401

        return True
    except ImportError:
        return False


def version_to_int(artifact) -> int:
    """'v12' -> 12 (reference ``wandb_tools.py:5-8``)."""
    return int(artifact.version[1:])


def download_checkpoint(run_id: str, download_dir: Path, version: Optional[str]) -> Path:
    """Download a run's model artifact (reference ``wandb_tools.py:10-38``)."""
    import wandb

    api = wandb.Api()
    run = api.run(run_id)
    chosen = None
    for artifact in run.logged_artifacts():
        if artifact.type != "model":
            continue
        if version is None:
            if chosen is None or version_to_int(artifact) > version_to_int(chosen):
                chosen = artifact
        elif artifact.version == version:
            chosen = artifact
    if chosen is None:
        raise ValueError(f"No model artifact found for run {run_id}")
    root = download_dir / run_id.replace("/", "_")
    chosen.download(root=str(root))
    ckpts = list(root.glob("*.ckpt"))
    return ckpts[0] if ckpts else root


def update_checkpoint_path(path: Optional[str], wandb_cfg: Dict[str, Any]) -> Optional[Path]:
    """Resolve ``wandb://run_id[:version]`` to a local checkpoint path
    (reference ``wandb_tools.py:41-62``); plain paths pass through."""
    if path is None:
        return None
    if not str(path).startswith("wandb://"):
        return Path(path)
    if not wandb_available():
        raise RuntimeError(
            "wandb:// checkpoint reference requires the wandb package, which "
            "is not available in this environment."
        )
    run_id, _, version = str(path)[len("wandb://"):].partition(":")
    project = wandb_cfg.get("project", "mvdiff")
    entity = wandb_cfg.get("entity") or ""
    full_run = f"{entity}/{project}/{run_id}".lstrip("/")
    return download_checkpoint(full_run, Path("checkpoints"), version or None)


class Logger:
    """Scalar/image logger: wandb when active, local files otherwise."""

    def __init__(self, cfg: Dict[str, Any], output_dir: Path):
        self.output_dir = Path(output_dir)
        self.use_wandb = bool(cfg.get("activated")) and wandb_available()
        if self.use_wandb:
            import wandb

            wandb.init(
                project=cfg.get("project", "mvdiff"),
                entity=cfg.get("entity"),
                mode=cfg.get("mode", "online"),
                tags=cfg.get("tags"),
            )
            self._wandb = wandb
        else:
            self.output_dir.mkdir(parents=True, exist_ok=True)
            self._scalars = open(self.output_dir / "metrics.jsonl", "a")

    def log_scalars(self, step: int, values: Dict[str, float]) -> None:
        if self.use_wandb:
            self._wandb.log(values, step=step)
        else:
            self._scalars.write(
                json.dumps({"step": step, **values}) + "\n"
            )
            self._scalars.flush()

    def log_image(self, key: str, image: np.ndarray, step: int) -> None:
        if self.use_wandb:
            self._wandb.log({key: self._wandb.Image(np.asarray(image))}, step=step)
        else:
            from .image_io import save_image

            safe = key.replace("/", "_").replace(" ", "_")
            save_image(image, self.output_dir / f"{safe}_{step:0>7}.png")
