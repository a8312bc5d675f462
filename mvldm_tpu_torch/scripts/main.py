"""Test-mode entry point (counterpart of ``mvldm_tpu/scripts/main.py``):

    python -m mvldm_tpu_torch.scripts.main +experiment=baseline mode=test \\
        dataset.root=<path> checkpointing.load=<ckpt> test.sampling_mode=anchored

``mode=test`` samples videos over the test set, anchored or
autoregressive, with skip-existing idempotency and GIF/MP4 export
(reference ``test_step:1057`` + ``on_test_end:1069``). It runs on the card;
:func:`main` exits non-zero without one. ``mode=train`` and ``mode=val``
are not ported yet.
"""

from __future__ import annotations

import pickle
import sys
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from ..builder import build_engine, load_pretrained
from ..config import RootCfg, compose, load_typed_root_config, set_cfg
from ..data.loader import DataModule
from ..data.view_samplers import StepTracker
from ..diffusion.engine import DiffusionEngine
from ..diffusion.video_sampling import SceneViews, VideoSampler
from ..training.checkpoint import CheckpointManager
from ..training.trainer import load_params
from ..utils.image_io import load_image, save_gif, save_image, save_video


def resolve_device(device=None) -> torch.device:
    """The device a run asks for; "cuda" when None. Without a card a CUDA
    run stops here: there is no CPU fallback."""
    device = torch.device(device or "cuda")
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("mvldm_tpu_torch: no CUDA device is visible; this entry point "
                         "runs on the card (from Python, pass device='cpu' to ask for "
                         "the CPU)")
    return device


def dispatch_generator(device: torch.device, seed: int, fold: int) -> torch.Generator:
    """The generator of one dispatch, derived from the run's seed and the
    dispatch's fold number (the JAX loop's ``fold_in(rng, fold)``)."""
    state = np.random.SeedSequence([seed, fold]).generate_state(1)[0]
    return torch.Generator(device).manual_seed(int(state))


def scene_views_from_batch(batch_np, role: str, i: int = 0) -> SceneViews:
    views = batch_np[role]
    return SceneViews(images=np.asarray(views["image"][i]),
                      extrinsics=np.asarray(views["extrinsics"][i]),
                      intrinsics=np.asarray(views["intrinsics"][i]),
                      index=np.asarray(views["index"][i]))


def _load_eval_params(cfg: RootCfg, engine: DiffusionEngine) -> None:
    """Weights for sampling: the seeded init, then ``checkpointing.load``'s
    ``.ckpt``, then the latest saved train state under
    ``<output_dir>/checkpoints`` (``params``, or ``ema_params`` with
    ``model.use_ema_sampling``). A state that cannot be restored is fatal
    unless ``checkpointing.allow_init_weights``."""
    load_pretrained(cfg, engine)
    ckpt_dir = Path(cfg.output_dir) / "checkpoints"
    mgr = CheckpointManager(ckpt_dir) if ckpt_dir.exists() else None
    latest = mgr.latest_step() if mgr is not None else None
    if latest is not None:
        key = "ema_params" if cfg.model.use_ema_sampling else "params"
        print(f"Loading checkpoint step {latest} ({key})")
        try:
            state = mgr.restore(latest, map_location="cpu")
            if state.get(key) is None:
                raise KeyError(f"the state has no {key}")
            load_params(engine.unet, state[key])
        except (OSError, RuntimeError, KeyError, ValueError, pickle.UnpicklingError) as e:
            if not cfg.checkpointing.allow_init_weights:
                raise RuntimeError(
                    f"Restoring checkpoint step {latest} from {ckpt_dir} failed: {e}. "
                    "Pass checkpointing.allow_init_weights=true to run with "
                    "freshly-initialized weights anyway.") from e
            print(f"Checkpoint restore failed ({e}); using init weights "
                  "(checkpointing.allow_init_weights=true)")
    if latest is None and cfg.checkpointing.load is None:
        print("WARNING: no checkpoint found (no checkpointing.load and no saved state "
              f"under {ckpt_dir}) — sampling with INIT weights; outputs will be noise.")


def _run_test_scene_batched(cfg: RootCfg, sampler: VideoSampler, dm: DataModule,
                            output_dir: Path, device: torch.device, seed: int,
                            scene_batch: int, limit: Optional[int], mode: str) -> None:
    """Video sampling with up to ``scene_batch`` scenes stacked per dispatch.
    Scenes bucket by target count so every dispatch is shape-uniform; a
    partial bucket pads to the next power of two (at most ``scene_batch``)
    by repeating its last scene, whose rows are dropped at export. The
    pipeline is one batch deep: batch N's PNGs are written while batch N+1
    runs on the device. Scenes with a ``color/`` directory are skipped."""

    def export_batch(entries, pending, size) -> None:
        results = VideoSampler.gather_many(pending, size)
        for (scene_dir, ctx), frames in zip(entries, results):
            for index, image in frames.items():
                save_image(image, scene_dir / "color" / f"{index:0>6}.png")
            for i, index in enumerate(ctx.index.tolist()):
                save_image(ctx.images[i], scene_dir / "context" / f"{index:0>6}.png")

    dispatch_many = (sampler.dispatch_anchored_many if mode == "anchored"
                     else sampler.dispatch_autoregressive_many)
    buckets: dict = {}  # target count -> [(scene_dir, ctx, tgt)]
    in_flight = None
    fold = 0

    def flush(bucket) -> None:
        nonlocal in_flight, fold
        size = 1
        while size < len(bucket):
            size *= 2
        size = min(size, scene_batch)
        padded = bucket + [bucket[-1]] * (size - len(bucket))
        pending = dispatch_many([(c, t) for _, c, t in padded],
                                dispatch_generator(device, seed, fold),
                                limit_frames=cfg.test.limit_frames)
        fold += 1
        if in_flight is not None:
            export_batch(*in_flight)
        in_flight = ([(sd, c) for sd, c, _ in bucket], pending, size)

    loader = dm.test_dataloader()
    try:
        for n, batch_np in enumerate(loader):
            if limit is not None and n >= limit:
                break
            scene = batch_np["scene"][0]
            scene_dir = output_dir / scene
            if (scene_dir / "color").exists():
                print(f"Skipping {scene} (already sampled)")
                continue
            ctx = scene_views_from_batch(batch_np, "context")
            tgt = scene_views_from_batch(batch_np, "target")
            n_t = len(tgt.index)
            if cfg.test.limit_frames is not None:
                n_t = min(n_t, cfg.test.limit_frames)
            print(f"scene = {scene}; context = {ctx.index.tolist()}; "
                  f"targets = {n_t} (scene batch)")
            buckets.setdefault(n_t, []).append((scene_dir, ctx, tgt))
            if len(buckets[n_t]) == scene_batch:
                flush(buckets.pop(n_t))
            # Distinct target counts can each open a bucket that never
            # fills: bound the scenes held on the host by flushing the
            # fullest once the backlog reaches four batches.
            elif sum(len(b) for b in buckets.values()) >= 4 * scene_batch:
                fullest = max(buckets, key=lambda k: len(buckets[k]))
                flush(buckets.pop(fullest))
    finally:
        loader.close()
    for bucket in buckets.values():
        if bucket:
            flush(bucket)
    if in_flight is not None:
        export_batch(*in_flight)


def run_test(cfg: RootCfg, device=None) -> None:
    """Video sampling over the test set (reference ``test_step`` +
    ``on_test_end``) on ``device`` ("cuda" when None)."""
    device = resolve_device(device)
    seed = cfg.seed if cfg.seed is not None else 0
    engine = build_engine(cfg, device)
    _load_eval_params(cfg, engine)

    dm = DataModule(cfg.dataset, cfg.dataset.view_sampler, cfg.data_loader, StepTracker())
    sampler = VideoSampler(engine, num_anchors_views=cfg.test.num_anchors_views,
                           ar_latent_feedthrough=cfg.test.ar_latent_feedthrough)
    test_dir = cfg.test.output_dir if str(cfg.test.output_dir) not in ("", ".") else None
    output_dir = Path(test_dir or cfg.output_dir) / "video"
    output_dir.mkdir(parents=True, exist_ok=True)
    mode = cfg.test.sampling_mode or "anchored"
    _run_test_scene_batched(cfg, sampler, dm, output_dir, device, seed,
                            max(1, cfg.test.scene_batch), cfg.trainer.limit_test_batches, mode)

    # GIF / MP4 export per scene (reference on_test_end:1069-1088).
    for scene_dir in sorted(output_dir.iterdir()):
        color = scene_dir / "color"
        if not color.is_dir():
            continue
        frames = [load_image(p) for p in sorted(color.glob("*.png"))]
        if not frames:
            continue
        save_gif(frames, scene_dir / "sampled.gif")
        save_video(frames, scene_dir / "sampled_fps_25.mp4", fps=25)
        save_video(frames, scene_dir / "sampled_fps_10.mp4", fps=10)


def main(argv=None, device=None) -> None:
    """``device`` is "cuda" when None; the tests pass "cpu"."""
    device = resolve_device(device)
    cfg_dict = compose(list(argv if argv is not None else sys.argv[1:]))
    set_cfg(cfg_dict)
    cfg = load_typed_root_config(cfg_dict)
    if cfg.seed is not None:
        np.random.seed(cfg.seed)
    print(f"mode={cfg.mode} output_dir={cfg.output_dir}")
    if cfg.mode == "train":
        raise NotImplementedError("mode=train is not ported to mvldm_tpu_torch yet "
                                  "(ROADMAP.md, Queue A item 7: the training CLI)")
    if cfg.mode == "val":
        raise NotImplementedError("mode=val is not ported to mvldm_tpu_torch yet "
                                  "(ROADMAP.md, Queue A item 10: visualization)")
    if cfg.mode != "test":
        raise ValueError(f"Unknown mode: {cfg.mode}")
    run_test(cfg, device)


if __name__ == "__main__":
    main()
