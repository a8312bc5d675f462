"""View samplers: choose context/target frame indices per scene
(counterpart of ``mvldm_tpu/data/view_samplers.py``, draw for draw).

Host-side numpy re-creations of the reference's five samplers
(``src/dataset/view_sampler/``): bounded (training), evaluation (video test
index), all, arbitrary, random. Warm-up schedules read the trainer's global
step through a ``StepTracker`` (reference ``view_sampler.py:60-66``).
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from pathlib import Path
from typing import List, Literal, Optional

import numpy as np

from .types import Stage, ViewIndex


class StepTracker:
    """Shares the trainer's global step with data workers (reference
    ``src/misc/step_tracker.py:9-24``). The loader runs in threads of the
    trainer's process, so a plain int read without a lock is enough."""

    def __init__(self, step: int = 0):
        self._step = int(step)

    def set_step(self, step: int) -> None:
        self._step = int(step)

    def get_step(self) -> int:
        return self._step


@dataclass
class ViewSamplerBoundedCfg:
    name: Literal["bounded"] = "bounded"
    num_context_views: int = 2
    num_target_views: int = 0
    min_distance_between_context_views: int = 0
    max_distance_between_context_views: Optional[int] = None
    max_distance_to_context_views: int = 0
    context_gap_warm_up_steps: int = 0
    target_gap_warm_up_steps: int = 0
    initial_min_distance_between_context_views: int = 0
    initial_max_distance_between_context_views: Optional[int] = None
    initial_max_distance_to_context_views: int = 0


@dataclass
class ViewSamplerArbitraryCfg:
    name: Literal["arbitrary"] = "arbitrary"
    num_context_views: int = 2
    num_target_views: int = 0
    context_views: Optional[List[int]] = None
    target_views: Optional[List[int]] = None


@dataclass
class ViewSamplerEvaluationCfg:
    name: Literal["evaluation"] = "evaluation"
    index_path: Path = Path("assets/evaluation_index/re10k_video.json")
    num_context_views: int = 2


@dataclass
class ViewSamplerAllCfg:
    name: Literal["all"] = "all"


@dataclass
class ViewSamplerRandomCfg:
    name: Literal["random"] = "random"
    num_context_views: int = 2
    num_target_views: int = 0


ViewSamplerCfg = (
    ViewSamplerBoundedCfg
    | ViewSamplerArbitraryCfg
    | ViewSamplerEvaluationCfg
    | ViewSamplerAllCfg
    | ViewSamplerRandomCfg
)


class ViewSampler:
    def __init__(
        self,
        cfg,
        stage: Stage,
        is_overfitting: bool,
        cameras_are_circular: bool,
        step_tracker: Optional[StepTracker],
        rng: Optional[np.random.Generator] = None,
    ):
        self.cfg = cfg
        self.stage = stage
        self.is_overfitting = is_overfitting
        self.cameras_are_circular = cameras_are_circular
        self.step_tracker = step_tracker
        self.rng = rng or np.random.default_rng()

    @property
    def global_step(self) -> int:
        return self.step_tracker.get_step() if self.step_tracker else 0

    def sample(self, scene: str, num_views: int) -> List[ViewIndex]:
        raise NotImplementedError

    @property
    def num_context_views(self) -> int:
        raise NotImplementedError

    @property
    def num_target_views(self) -> int:
        raise NotImplementedError


class ViewSamplerBounded(ViewSampler):
    """Training sampler (reference ``view_sampler_bounded.py:25-152``):
    a context pair with a (warm-up scheduled) gap, targets drawn without
    replacement from the window around the context pair."""

    def _schedule(self, initial: int, final: int, steps: int) -> int:
        fraction = self.global_step / steps
        return min(initial + int((final - initial) * fraction), final)

    def sample(self, scene: str, num_views: int) -> List[ViewIndex]:
        cfg = self.cfg
        max_gap = cfg.max_distance_between_context_views or num_views
        initial_max_gap = cfg.initial_max_distance_between_context_views or num_views

        if self.stage == "test":
            max_context_gap = min_context_gap = max_gap
        elif cfg.context_gap_warm_up_steps > 0:
            max_context_gap = self._schedule(
                initial_max_gap, max_gap, cfg.context_gap_warm_up_steps
            )
            min_context_gap = self._schedule(
                cfg.initial_min_distance_between_context_views,
                cfg.min_distance_between_context_views,
                cfg.context_gap_warm_up_steps,
            )
        else:
            max_context_gap = max_gap
            min_context_gap = cfg.min_distance_between_context_views

        if not self.cameras_are_circular:
            max_context_gap = min(num_views - 1, max_context_gap)

        if self.stage != "test" and cfg.target_gap_warm_up_steps > 0:
            max_target_gap = self._schedule(
                cfg.initial_max_distance_to_context_views,
                cfg.max_distance_to_context_views,
                cfg.target_gap_warm_up_steps,
            )
        else:
            max_target_gap = cfg.max_distance_to_context_views

        if max_context_gap < min_context_gap:
            raise ValueError("Example does not have enough frames!")
        context_gap = int(
            self.rng.integers(min_context_gap, max_context_gap + 1)
        )

        high = num_views if self.cameras_are_circular else num_views - context_gap
        index_context_left = int(self.rng.integers(0, high))
        if self.stage == "test":
            index_context_left = 0
        index_context_right = index_context_left + context_gap

        if self.is_overfitting:
            index_context_left = 0
            index_context_right = max_context_gap

        if cfg.num_target_views > 0:
            index_target_left = index_context_left - max_target_gap
            index_target_right = index_context_right + max_target_gap
            if not self.cameras_are_circular:
                index_target_left = max(0, index_target_left)
                index_target_right = min(num_views - 1, index_target_right)

            if self.stage == "test":
                index_target = np.arange(index_target_left, index_target_right + 1)
            else:
                candidates = np.arange(index_target_left, index_target_right + 1)
                index_target = self.rng.choice(
                    candidates, size=cfg.num_target_views, replace=False
                )
        else:
            index_target = None

        if self.cameras_are_circular:
            if index_target is not None:
                index_target = index_target % num_views
            index_context_right %= num_views

        return [
            ViewIndex(
                np.asarray([index_context_left, index_context_right]), index_target
            )
        ]

    @property
    def num_context_views(self) -> int:
        return self.cfg.num_context_views

    @property
    def num_target_views(self) -> int:
        return self.cfg.num_target_views


class ViewSamplerEvaluation(ViewSampler):
    """Test sampler over a precomputed index (reference
    ``view_sampler_evaluation.py:23-68``): JSON entries
    {scene: {"context": [...], "target": [...]}}; scenes absent or null are
    skipped."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        with open(self.cfg.index_path) as f:
            raw = json.load(f)
        self.index = {
            scene: entry for scene, entry in raw.items() if entry is not None
        }

    @property
    def total_samples(self) -> int:
        return len(self.index)

    def sample(self, scene: str, num_views: int) -> List[ViewIndex]:
        entry = self.index.get(scene)
        if entry is None:
            raise ValueError(f"No indices available for scene {scene}.")
        return [
            ViewIndex(
                np.asarray(entry["context"]),
                np.asarray(entry["target"]) if entry.get("target") else None,
            )
        ]

    @property
    def num_context_views(self) -> int:
        return self.cfg.num_context_views

    @property
    def num_target_views(self) -> int:
        return 0


class ViewSamplerAll(ViewSampler):
    """Every frame in both roles (reference ``view_sampler_all.py:14-23``)."""

    def sample(self, scene: str, num_views: int) -> List[ViewIndex]:
        allv = np.arange(num_views)
        return [ViewIndex(allv, allv)]

    @property
    def num_context_views(self) -> int:
        return 0

    @property
    def num_target_views(self) -> int:
        return 0


class ViewSamplerArbitrary(ViewSampler):
    """Fixed or random context/target lists (reference
    ``view_sampler_arbitrary.py:18-57``)."""

    def sample(self, scene: str, num_views: int) -> List[ViewIndex]:
        cfg = self.cfg
        if cfg.context_views is not None:
            context = np.asarray(cfg.context_views)
            assert len(context) == cfg.num_context_views
        else:
            context = self.rng.integers(0, num_views, size=cfg.num_context_views)
        if cfg.target_views is not None:
            target = np.asarray(cfg.target_views)
            assert len(target) == cfg.num_target_views
        else:
            target = self.rng.integers(0, num_views, size=cfg.num_target_views)
        return [ViewIndex(context, target)]

    @property
    def num_context_views(self) -> int:
        return self.cfg.num_context_views

    @property
    def num_target_views(self) -> int:
        return self.cfg.num_target_views


class ViewSamplerRandom(ViewSampler):
    """Uniform random context + target (reference
    ``view_sampler_random.py:16-26``)."""

    def sample(self, scene: str, num_views: int) -> List[ViewIndex]:
        cfg = self.cfg
        context = self.rng.integers(0, num_views, size=cfg.num_context_views)
        target = self.rng.integers(0, num_views, size=cfg.num_target_views)
        return [ViewIndex(context, target)]

    @property
    def num_context_views(self) -> int:
        return self.cfg.num_context_views

    @property
    def num_target_views(self) -> int:
        return self.cfg.num_target_views


_SAMPLERS = {
    "bounded": ViewSamplerBounded,
    "evaluation": ViewSamplerEvaluation,
    "all": ViewSamplerAll,
    "arbitrary": ViewSamplerArbitrary,
    "random": ViewSamplerRandom,
}


def get_view_sampler(
    cfg,
    stage: Stage,
    overfit: bool,
    cameras_are_circular: bool,
    step_tracker: Optional[StepTracker],
    rng: Optional[np.random.Generator] = None,
) -> ViewSampler:
    """Registry (reference ``view_sampler/__init__.py:31-46``)."""
    return _SAMPLERS[cfg.name](
        cfg, stage, overfit, cameras_are_circular, step_tracker, rng
    )
