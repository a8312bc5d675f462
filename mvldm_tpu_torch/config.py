"""Config system: Hydra-style YAML composition + typed dataclasses
(counterpart of ``mvldm_tpu/config.py``; it reads the same ``configs/``
tree and never writes it).

Re-creates the reference's config stack (Hydra defaults-list composition,
``config/main.yaml:1-6`` -> OmegaConf dict -> dacite-typed ``RootCfg``,
``src/config.py:57-73``) without Hydra, OmegaConf or dacite:

* :func:`compose` — loads ``configs/main.yaml``, resolves its ``defaults:``
  list (group files like ``dataset/re10k.yaml``, recursively), applies
  ``+experiment=<name>`` packages (``# @package _global_`` with
  ``override /group:`` entries), then CLI dot-overrides (``a.b.c=value``).
* :func:`from_dict` — recursive dict -> dataclass conversion with Literal
  checks, Path coercion, Optional/Union handling (unions of cfg dataclasses
  discriminate on their ``name`` field). Unknown keys fail fast.

The CLI surface matches the reference: ``python -m
mvldm_tpu_torch.scripts.generate_mvldm +experiment=baseline
dataset.root=... scene_id=...``. PyYAML is imported where files are read.
"""

from __future__ import annotations

import dataclasses
import types
import typing
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Dict, List, Literal, Optional, Sequence, Union

from .data.dataset_re10k import DatasetRE10kCfg
from .data.loader import DataLoaderCfg
from .data.view_samplers import (
    ViewSamplerAllCfg,
    ViewSamplerArbitraryCfg,
    ViewSamplerBoundedCfg,
    ViewSamplerEvaluationCfg,
    ViewSamplerRandomCfg,
)
from .diffusion.engine import ModelCfg

CONFIG_DIR = Path(__file__).parent.parent / "configs"


# --------------------------------------------------------------------- types


@dataclass
class LRSchedulerCfg:
    """Reference ``model/config.py:36-41``."""

    name: str
    frequency: int = 1
    interval: Literal["epoch", "step"] = "step"
    kwargs: Optional[Dict[str, Any]] = None


@dataclass
class OptimizerCfg:
    """Reference ``model/config.py:49-55``."""

    name: str
    lr: float
    scale_lr: bool = False
    kwargs: Optional[Dict[str, Any]] = None
    scheduler: Optional[LRSchedulerCfg] = None


@dataclass
class FreezeCfg:
    denoiser: bool = False
    autoencoder: bool = True


@dataclass
class TestCfg:
    """Reference ``model/config.py:58-63``."""

    output_dir: Path = Path("")
    limit_frames: Optional[int] = None
    sampling_mode: Optional[Literal["anchored", "autoregressive"]] = None
    num_anchors_views: int = 4
    # Scenes batched per video-sampling dispatch (beyond reference; both
    # anchored and autoregressive modes), stacked along the launch batch
    # axis.
    scene_batch: int = 1
    # Autoregressive windows condition on the previous window's generated
    # LATENT instead of VAE-encoding its decoded image (beyond reference;
    # see VideoSampler.ar_latent_feedthrough). Removes the per-window
    # context encode from the sequential chain; deviation: no VAE
    # decode->encode roundtrip error compounds across windows.
    ar_latent_feedthrough: bool = False


@dataclass
class TrainCfg:
    step_offset: int = 0
    cfg_train: bool = True


@dataclass
class CheckpointingCfg:
    """Reference ``src/config.py:12-18``."""

    load: Optional[str] = None
    every_n_train_steps: int = 1000
    save_top_k: int = 1
    resume: bool = False
    save: bool = True
    # val/test only: run with freshly-initialized weights when no checkpoint
    # can be restored, instead of failing. Without this, a silent fallback to
    # random init would emit noise images that look like a model bug.
    allow_init_weights: bool = False


@dataclass
class TrainerCfg:
    """Reference ``src/config.py:21-30``; ``strategy`` names the
    parallelism plan instead of a Lightning DDP string (the port runs one
    device), and ``precision`` accepts the same tokens."""

    max_steps: int = 1_000_001
    val_check_interval: Optional[int] = 5000
    gradient_clip_val: Optional[float] = 0.1
    task_steps: Optional[int] = None
    precision: Optional[str] = None
    validate: bool = True
    accumulate_grad_batches: int = 1
    limit_test_batches: int = 32
    strategy: str = "data_parallel"
    # Model-axis width for strategy="data_model" (tensor-parallel joint
    # cross-view attention; devices = num_data x num_model).
    num_model: int = 2
    # Recompute each UNet block in the backward pass (activation memory
    # for FLOPs).
    remat: bool = False
    # Remat policy: null = recompute everything per block; "dots" keeps the
    # 2-D products (no batch dimension) and recomputes the rest; any other
    # value is refused when the UNet is built.
    remat_policy: Optional[str] = None


ViewSamplerCfgUnion = Union[
    ViewSamplerBoundedCfg,
    ViewSamplerArbitraryCfg,
    ViewSamplerEvaluationCfg,
    ViewSamplerAllCfg,
    ViewSamplerRandomCfg,
]


@dataclass
class DatasetCfg(DatasetRE10kCfg):
    """Dataset cfg + the attached view-sampler group."""

    view_sampler: ViewSamplerCfgUnion = field(
        default_factory=ViewSamplerBoundedCfg
    )


@dataclass
class WandbCfg:
    project: str = "mvdiff"
    entity: Optional[str] = None
    mode: str = "online"
    activated: bool = False
    tags: Optional[List[str]] = None


@dataclass
class RootCfg:
    """Reference ``src/config.py:33-46``."""

    wandb: WandbCfg = field(default_factory=WandbCfg)
    mode: Literal["train", "val", "test"] = "train"
    dataset: DatasetCfg = field(default_factory=DatasetCfg)
    model: ModelCfg = field(default_factory=ModelCfg)
    data_loader: DataLoaderCfg = field(default_factory=DataLoaderCfg)
    optimizer: OptimizerCfg = field(
        default_factory=lambda: OptimizerCfg(name="AdamW", lr=2e-5, scale_lr=False)
    )
    checkpointing: CheckpointingCfg = field(default_factory=CheckpointingCfg)
    trainer: TrainerCfg = field(default_factory=TrainerCfg)
    test: TestCfg = field(default_factory=TestCfg)
    train: TrainCfg = field(default_factory=TrainCfg)
    freeze: FreezeCfg = field(default_factory=FreezeCfg)
    seed: Optional[int] = None
    scene_id: Optional[Union[int, str]] = None
    output_dir: Path = Path("outputs/local")


# ------------------------------------------------------------- dict -> typed


def _is_optional(tp) -> bool:
    return typing.get_origin(tp) in (Union, types.UnionType) and type(
        None
    ) in typing.get_args(tp)


def _strip_optional(tp):
    args = [a for a in typing.get_args(tp) if a is not type(None)]
    if len(args) == 1:
        return args[0]
    return Union[tuple(args)]


def from_dict(cls, data: Any, path: str = ""):
    """Recursive dict -> dataclass with strict unknown-key checking."""
    if data is None:
        return None

    origin = typing.get_origin(cls)

    if cls is Any:
        return data
    if cls is Path or cls == Optional[Path]:
        return Path(data) if data is not None else None
    if origin in (Union, types.UnionType):
        args = typing.get_args(cls)
        if type(None) in args and data is None:
            return None
        candidates = [a for a in args if a is not type(None)]
        # Discriminate unions of cfg dataclasses on their 'name' field.
        dc = [c for c in candidates if dataclasses.is_dataclass(c)]
        if len(dc) == 1 and isinstance(data, dict):
            return from_dict(dc[0], data, path)
        if dc and isinstance(data, dict) and "name" in data:
            for c in dc:
                hints = typing.get_type_hints(c)
                if "name" not in hints:
                    continue
                name_t = hints["name"]
                if typing.get_origin(name_t) is Literal:
                    literals = typing.get_args(name_t)
                else:
                    f = next(f for f in dataclasses.fields(c) if f.name == "name")
                    literals = (f.default,)
                if data["name"] in literals:
                    return from_dict(c, data, path)
            raise ValueError(
                f"{path}: no union member matches name={data['name']!r}"
            )
        # Otherwise try members in order.
        for c in candidates:
            try:
                return from_dict(c, data, path)
            except (ValueError, TypeError):
                continue
        raise ValueError(f"{path}: value {data!r} fits no member of {cls}")
    if origin is Literal:
        if data not in typing.get_args(cls):
            raise ValueError(
                f"{path}: {data!r} not in {typing.get_args(cls)}"
            )
        return data
    if origin in (list, List, Sequence):
        (item_t,) = typing.get_args(cls) or (Any,)
        return [from_dict(item_t, x, f"{path}[{i}]") for i, x in enumerate(data)]
    if origin is tuple:
        args = typing.get_args(cls)
        if len(args) == 2 and args[1] is Ellipsis:
            return tuple(from_dict(args[0], x, path) for x in data)
        return tuple(from_dict(t, x, path) for t, x in zip(args, data))
    if origin in (dict, Dict):
        return dict(data)
    if dataclasses.is_dataclass(cls):
        if not isinstance(data, dict):
            raise ValueError(f"{path}: expected mapping for {cls.__name__}")
        hints = typing.get_type_hints(cls)
        field_names = {f.name for f in dataclasses.fields(cls)}
        unknown = set(data) - field_names
        if unknown:
            raise ValueError(
                f"{path}: unknown keys {sorted(unknown)} for {cls.__name__}"
            )
        kwargs = {}
        for f in dataclasses.fields(cls):
            if f.name in data:
                kwargs[f.name] = from_dict(
                    hints[f.name], data[f.name], f"{path}.{f.name}"
                )
            elif (
                f.default is dataclasses.MISSING
                and f.default_factory is dataclasses.MISSING
            ):
                raise ValueError(f"{path}: missing required key {f.name!r}")
        return cls(**kwargs)
    # Primitives.
    if cls is float and isinstance(data, (int, float, str)):
        return float(data)
    if cls is int and isinstance(data, (int, str)) and not isinstance(data, bool):
        return int(data)
    if cls is bool:
        if isinstance(data, bool):
            return data
        raise ValueError(f"{path}: expected bool, got {data!r}")
    if cls is str:
        return str(data)
    return data


# --------------------------------------------------------------- composition


def _deep_merge(base: Dict, update: Dict) -> Dict:
    out = dict(base)
    for k, v in update.items():
        if k in out and isinstance(out[k], dict) and isinstance(v, dict):
            out[k] = _deep_merge(out[k], v)
        else:
            out[k] = v
    return out


def _set_path(cfg: Dict, dotted: str, value: Any) -> None:
    parts = dotted.split(".")
    node = cfg
    for p in parts[:-1]:
        node = node.setdefault(p, {})
    node[parts[-1]] = value


def _package_of(path: Path) -> Optional[str]:
    """Parse a Hydra ``# @package <pkg>`` directive from a file's header."""
    with open(path) as f:
        for line in f:
            stripped = line.strip()
            if not stripped:
                continue
            if stripped.startswith("#"):
                comment = stripped.lstrip("#").strip()
                if comment.startswith("@package"):
                    return comment.split()[-1]
                continue
            break
    return None


def _load_group(config_dir: Path, group: str, name: str) -> Dict:
    """Load a group file and resolve its own nested defaults."""
    data, is_global, _ = _load_group_packaged(config_dir, group, name)
    assert not is_global, (
        f"{group}/{name} is '@package _global_'; load it with "
        "_load_group_packaged"
    )
    return data


def _load_group_packaged(
    config_dir: Path, group: str, name: str
) -> tuple[Dict, bool, List[tuple[str, Dict]]]:
    """Load a group file. Returns (data, is_global, replacements): for
    ``# @package _global_`` files (e.g. the evaluation group, reference
    ``config/evaluation/re10k_video.yaml``) the data is rooted at the config
    top level and each ``override /other_group: choice`` default becomes an
    ordered (dotted_path, group_data) REPLACEMENT the caller applies before
    merging the data (Hydra group-choice semantics — a choice replaces the
    package, it never inherits keys from the previous choice). For ordinary
    files the data belongs under the group key and replacements is empty."""
    import yaml

    path = config_dir / group / f"{name}.yaml"
    with open(path) as f:
        data = yaml.safe_load(f) or {}
    is_global = _package_of(path) == "_global_"
    defaults = data.pop("defaults", [])
    resolved: Dict = {}
    replacements: List[tuple[str, Dict]] = []
    for entry in defaults:
        if not isinstance(entry, dict):
            continue
        for sub_group, sub_name in entry.items():
            if is_global:
                g = sub_group
                if g.startswith("override"):
                    g = g[len("override"):].strip()
                g = g.lstrip("/")
                sub = _load_group(config_dir, g, sub_name)
                replacements.append((g.replace("/", "."), sub))
            else:
                sub = _load_group(config_dir, f"{group}/{sub_group}", sub_name)
                resolved = _deep_merge(resolved, {sub_group: sub})
    return _deep_merge(resolved, data), is_global, replacements


def compose(
    overrides: Sequence[str] = (),
    config_dir: Path | None = None,
    main_name: str = "main",
) -> Dict:
    """Hydra-like composition returning a plain dict."""
    import yaml

    config_dir = Path(config_dir or CONFIG_DIR)
    with open(config_dir / f"{main_name}.yaml") as f:
        main = yaml.safe_load(f) or {}
    defaults = main.pop("defaults", [])
    main.pop("hydra", None)

    cfg: Dict = {}
    group_choices: Dict[str, str] = {}
    for entry in defaults:
        if isinstance(entry, dict):
            for group, name in entry.items():
                group_choices[group] = name
    # Experiment overrides may replace group choices before groups load.
    experiments = []
    cli_overrides = []
    for ov in overrides:
        if ov.startswith("+experiment="):
            experiments.append(ov.split("=", 1)[1])
        else:
            cli_overrides.append(ov)

    exp_datas = []
    for exp in experiments:
        with open(config_dir / "experiment" / f"{exp}.yaml") as f:
            exp_data = yaml.safe_load(f) or {}
        for entry in exp_data.pop("defaults", []):
            if isinstance(entry, dict):
                for group, name in entry.items():
                    g = group
                    if g.startswith("override"):
                        g = g[len("override"):].strip()
                    group_choices[g.lstrip("/")] = name
        exp_datas.append(exp_data)

    for group, name in group_choices.items():
        # A group choice REPLACES the group's package (Hydra semantics):
        # 'dataset/view_sampler: evaluation' must not inherit keys from the
        # bounded sampler that 'dataset: re10k' nested-defaulted earlier.
        sub = _load_group(config_dir, group, name)
        _set_path(cfg, group.replace("/", "."), sub)

    cfg = _deep_merge(cfg, main)
    for exp_data in exp_datas:
        cfg = _deep_merge(cfg, exp_data)

    for ov in cli_overrides:
        if "=" not in ov:
            raise ValueError(f"Malformed override: {ov!r}")
        key, _, raw = ov.partition("=")
        key = key.lstrip("+")
        value = yaml.safe_load(raw)
        if (
            "." not in key
            and isinstance(value, str)
            and (config_dir / key / f"{value}.yaml").exists()
        ):
            # Hydra group-override syntax (dataset=re10k_non_iter,
            # model/scheduler=ddpm) REPLACES the whole group with that
            # group file; '@package _global_' group files (+evaluation=...)
            # first apply their 'override /group' choices as replacements,
            # then merge their data at the top level.
            sub, is_global, replacements = _load_group_packaged(
                config_dir, key, value
            )
            if is_global:
                for dotted, group_data in replacements:
                    _set_path(cfg, dotted, group_data)
                cfg = _deep_merge(cfg, sub)
            else:
                _set_path(cfg, key.replace("/", "."), sub)
        else:
            _set_path(cfg, key, yaml.safe_load(raw))
    return cfg


def load_typed_root_config(cfg: Dict) -> RootCfg:
    """Reference ``src/config.py:68-73``."""
    return from_dict(RootCfg, cfg, "root")


_GLOBAL_CFG: Optional[Dict] = None


def set_cfg(cfg: Dict) -> None:
    """Raw-dict stash (reference ``src/global_cfg.py:8-16``)."""
    global _GLOBAL_CFG
    _GLOBAL_CFG = cfg


def get_cfg() -> Dict:
    assert _GLOBAL_CFG is not None
    return _GLOBAL_CFG
