"""Train / validate / test entry point (counterpart of
``mvldm_tpu/scripts/main.py``):

    python -m mvldm_tpu_torch.scripts.main +experiment=baseline mode=train \\
        dataset.root=<path> output_dir=outputs/run1

Modes: ``train`` (the train loop with auto-resume, checkpoints and the
in-training validation hook), ``val`` (one validation sampling round from
the saved state, comparison grids written to ``<output_dir>/val``),
``test`` (video sampling over the test set, anchored or autoregressive,
with skip-existing idempotency and GIF/MP4 export; reference
``test_step:1057`` + ``on_test_end:1069``). :func:`main` exits non-zero
without a card.

Several cards: one process per card, started with the
``MVLDM_COORDINATOR`` / ``MVLDM_NUM_PROCESSES`` / ``MVLDM_PROCESS_ID``
triplet, or by ``torchrun`` with ``MVLDM_DISTRIBUTED=1``
(``parallel/distributed.py``). ``mode=train`` then runs
``trainer.strategy`` (``data_parallel``, ``data_parallel_zero1``,
``data_parallel_fsdp``, ``data_model`` with ``trainer.num_model``; see
``training/strategy.py``) whenever a process group was asked for, world 1
included: there every collective is an identity in value, so one card
drives the strategy's collectives. With no such variable it runs on one
card, as before. ``mode=test`` stripes the test scenes over the ranks (the
loader's process striping) and each rank samples and exports its own: the
port's counterpart of the JAX CLI's chip-per-scene split of a scene batch
over one process's local devices.
"""

from __future__ import annotations

import pickle
import sys
from pathlib import Path
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from ..builder import build_engine, load_pretrained
from ..config import RootCfg, compose, load_typed_root_config, set_cfg
from ..data.loader import DataModule
from ..data.view_samplers import StepTracker
from ..diffusion.engine import DiffusionEngine
from ..diffusion.video_sampling import SceneViews, VideoSampler
from ..parallel.distributed import (
    is_main_process,
    maybe_initialize_distributed,
    rank_and_world,
    shared_seed,
    shutdown_distributed,
    sync_processes,
)
from ..parallel.mesh import make_mesh
from ..training.checkpoint import CheckpointManager
from ..training.optim import SetToZero, build_lr_schedule, build_optimizer
from ..training.strategy import STRATEGIES, Strategy
from ..training.trainer import Trainer, TrainState, load_params
from ..utils.image_io import load_image, save_gif, save_image, save_video
from ..visualization import add_label, hcat, vcat
from ..visualization.color_map import get_hist_image
from ..visualization.validation_in_3d import render_cameras


def resolve_device(device=None) -> torch.device:
    """The device a run asks for; "cuda" when None. Without a card a CUDA
    run stops here: there is no CPU fallback."""
    device = torch.device(device or "cuda")
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("mvldm_tpu_torch: no CUDA device is visible; this entry point "
                         "runs on the card (from Python, pass device='cpu' to ask for "
                         "the CPU)")
    return device


def dispatch_generator(device: torch.device, seed: int, *folds: int) -> torch.Generator:
    """The generator of one dispatch, derived from the run's seed and the
    dispatch's fold numbers (the JAX loop's ``fold_in(rng, fold)``, once
    for each)."""
    state = np.random.SeedSequence([seed, *folds]).generate_state(1)[0]
    return torch.Generator(device).manual_seed(int(state))


def build_data_module(cfg: RootCfg, step_tracker: StepTracker,
                      process: Optional[tuple] = None, seed: Optional[int] = None) -> DataModule:
    """The run's ``DataModule``; ``process`` and ``seed`` as it takes them."""
    return DataModule(cfg.dataset, cfg.dataset.view_sampler, cfg.data_loader, step_tracker,
                      process=process, seed=seed)


def scene_views_from_batch(batch_np, role: str, i: int = 0) -> SceneViews:
    views = batch_np[role]
    return SceneViews(images=np.asarray(views["image"][i]),
                      extrinsics=np.asarray(views["extrinsics"][i]),
                      intrinsics=np.asarray(views["intrinsics"][i]),
                      index=np.asarray(views["index"][i]))


def base_lr(cfg: RootCfg) -> float:
    """``optimizer.lr``, times the effective batch (accumulation x devices x
    batch) under ``optimizer.scale_lr`` (reference
    ``diffusion_wrapper.py:156-167``); the devices are the process group's
    ranks, one card each (the JAX ``jax.device_count()``)."""
    lr = cfg.optimizer.lr
    if cfg.optimizer.scale_lr:
        devices = rank_and_world()[1]
        lr = lr * (cfg.trainer.accumulate_grad_batches * devices
                   * cfg.data_loader.train.batch_size)
    return lr


def build_strategy(cfg: RootCfg, engine: DiffusionEngine, tx) -> Optional[Strategy]:
    """``trainer.strategy``'s plan over the process group (the JAX
    ``run_train``'s choice, ``scripts/main.py:84-106``), or None without a
    process group. With one, any other strategy name is refused."""
    if not dist.is_initialized():
        return None
    name = cfg.trainer.strategy
    if name not in STRATEGIES:
        raise ValueError(f"trainer.strategy={name!r} cannot run on a process group; "
                         f"expected one of {STRATEGIES}")
    mesh = make_mesh(num_model=cfg.trainer.num_model if name == "data_model" else 1)
    if is_main_process():
        print(f"strategy {name}: {mesh.num_data} (data) x {mesh.num_model} (model) ranks")
    return Strategy(name, mesh, engine.unet, tx)


def run_train(cfg: RootCfg, device=None) -> TrainState:
    """Train on ``device`` ("cuda" when None), resuming from the newest
    checkpoint under ``<output_dir>/checkpoints``; under a process group,
    on each rank with ``trainer.strategy`` (:func:`build_strategy`).
    ``freeze.autoencoder`` is structural (the VAE is never optimized);
    ``freeze.denoiser`` zeroes every update."""
    device = resolve_device(device)
    seed = cfg.seed if cfg.seed is not None else 0
    engine = build_engine(cfg, device)
    engine.vae.requires_grad_(False)
    load_pretrained(cfg, engine)

    tx = build_optimizer(cfg.optimizer, build_lr_schedule(base_lr(cfg), cfg.optimizer.scheduler),
                         gradient_clip_val=cfg.trainer.gradient_clip_val,
                         accumulate_grad_batches=cfg.trainer.accumulate_grad_batches)
    if cfg.freeze.denoiser:
        print("freeze.denoiser=true: denoiser updates disabled")
        tx = SetToZero()
    strategy = build_strategy(cfg, engine, tx)
    step_tracker = StepTracker(cfg.train.step_offset)
    if strategy is None:
        dm = build_data_module(cfg, step_tracker)
    else:
        # One stream a data rank: its model ranks read the same batches,
        # from one shared seed where the config gives none.
        mesh = strategy.mesh
        dm = build_data_module(cfg, step_tracker, process=(mesh.data_rank, mesh.num_data),
                               seed=shared_seed(device))
    run_dir = Path(cfg.output_dir)
    run_dir.mkdir(parents=True, exist_ok=True)

    val_hook = None
    if cfg.trainer.validate and cfg.trainer.val_check_interval:
        val_hook = make_val_hook(cfg, engine, run_dir, seed)
    trainer = Trainer(engine, tx, dm, run_dir, max_steps=cfg.trainer.max_steps,
                      num_context_views=cfg.dataset.view_sampler.num_context_views,
                      checkpoint_every=cfg.checkpointing.every_n_train_steps,
                      save_top_k=cfg.checkpointing.save_top_k, use_ema=cfg.model.ema,
                      step_tracker=step_tracker, val_hook=val_hook,
                      val_check_interval=cfg.trainer.val_check_interval,
                      task_steps=cfg.trainer.task_steps, strategy=strategy)
    state = trainer.maybe_restore(trainer.init_state())
    return trainer.fit(state, seed)


def _render_val_batch(engine: DiffusionEngine, batch_np, out_dir: Path,
                      device: torch.device, seed: int, *folds: int) -> None:
    """Render one validation batch (reference ``validation_step:492-544``):
    camera frusta, context | GT | samples comparison grids, value
    histograms. Scene ``i`` samples its targets from its first context view
    with the generator of (seed, *folds, i), the JAX ``fold_in(rng, i)``."""
    out_dir.mkdir(parents=True, exist_ok=True)
    save_image(hcat(*render_cameras(batch_np, 256)), out_dir / "cameras.png")

    all_samples, all_targets = [], []
    for i in range(batch_np["context"]["image"].shape[0]):
        ctx = scene_views_from_batch(batch_np, "context", i)
        tgt = scene_views_from_batch(batch_np, "target", i)
        extr = np.concatenate([ctx.extrinsics[:1], tgt.extrinsics], axis=0)
        intr = np.concatenate([ctx.intrinsics[:1], tgt.intrinsics], axis=0)
        out = engine.sample(torch.from_numpy(ctx.images[:1])[None],
                            torch.from_numpy(extr)[None], torch.from_numpy(intr)[None],
                            num_target_views=len(tgt.index),
                            generator=dispatch_generator(device, seed, *folds, i))
        samples = out[0].float().cpu().numpy()
        grid = hcat(add_label(vcat(*list(ctx.images[:1])), "Context Views"),
                    add_label(vcat(*list(tgt.images)), "Original Targets"),
                    add_label(vcat(*list(samples)), "Sampled Targets"))
        scene = batch_np["scene"][i]
        save_image(grid, out_dir / f"{scene}.png")
        print(f"Wrote {out_dir / f'{scene}.png'}")
        all_samples.append(samples)
        all_targets.append(tgt.images)

    # Value-distribution histograms (reference validation_step:534-544).
    hist = hcat(get_hist_image(np.concatenate(all_targets), title="Target Distribution"),
                get_hist_image(np.concatenate(all_samples), title="Sampled Distribution"))
    save_image(hist, out_dir / "distributions.png")


def _render_first_val_batch(engine: DiffusionEngine, dm: DataModule, out_dir: Path,
                            device: torch.device, seed: int, *folds: int) -> None:
    """:func:`_render_val_batch` on the val loader's first batch (the
    reference's limited val); the loader is closed after it."""
    loader = dm.val_dataloader()
    try:
        for batch_np in loader:
            _render_val_batch(engine, batch_np, out_dir, device, seed, *folds)
            break
    finally:
        loader.close()


def make_val_hook(cfg: RootCfg, engine: DiffusionEngine, run_dir: Path, seed: int):
    """In-training validation (the reference runs ``validation_step`` every
    ``val_check_interval`` steps, ``diffusion_wrapper.py:492-544``): one val
    batch sampled with the current weights, or the EMA weights under
    ``model.use_ema_sampling``, written under ``<run_dir>/val/step_<n>/``.
    The module holds the weights training computes with, so EMA weights are
    loaded for the hook and the masters put back after it."""
    dm = build_data_module(cfg, StepTracker())  # independent of training's stream
    device = engine.device

    def val_hook(state: TrainState, step: int) -> None:
        ema = cfg.model.use_ema_sampling and state.ema_params is not None
        if ema:
            load_params(engine.unet, state.ema_params)
        try:
            _render_first_val_batch(engine, dm, run_dir / "val" / f"step_{step}", device,
                                    seed, 2, step)
        finally:
            if ema:
                load_params(engine.unet, state.params)

    return val_hook


def run_val(cfg: RootCfg, device=None) -> None:
    """One validation sampling round (reference ``validation_step:492-544``)
    from the saved state: targets sampled from one context view, grids
    written to ``<output_dir>/val``."""
    device = resolve_device(device)
    if not is_main_process():
        return  # one rank renders; the others have nothing to write
    seed = cfg.seed if cfg.seed is not None else 0
    engine = build_engine(cfg, device)
    _load_eval_params(cfg, engine)
    _render_first_val_batch(engine, build_data_module(cfg, StepTracker()),
                            Path(cfg.output_dir) / "val", device, seed)


def _load_eval_params(cfg: RootCfg, engine: DiffusionEngine) -> None:
    """Weights for sampling: the seeded init, then ``checkpointing.load``'s
    ``.ckpt``, then the latest saved train state under
    ``<output_dir>/checkpoints`` (``params``, or ``ema_params`` with
    ``model.use_ema_sampling``), read alone by ``restore_partial``. A state
    that cannot be restored is fatal unless
    ``checkpointing.allow_init_weights``."""
    load_pretrained(cfg, engine)
    ckpt_dir = Path(cfg.output_dir) / "checkpoints"
    mgr = CheckpointManager(ckpt_dir) if ckpt_dir.exists() else None
    latest = mgr.latest_step() if mgr is not None else None
    if latest is not None:
        key = "ema_params" if cfg.model.use_ema_sampling else "params"
        print(f"Loading checkpoint step {latest} ({key})")
        try:
            state = mgr.restore_partial(latest, [key])
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
    rank = rank_and_world()[0]
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
                                dispatch_generator(device, seed, fold,
                                                   *((rank,) if rank else ())),
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
    ``on_test_end``) on ``device`` ("cuda" when None). Under a process
    group each rank samples its stripe of the scenes (a dispatch's
    generator folds in a nonzero rank), the ranks meet at a barrier, and
    rank r exports every r-th scene directory."""
    device = resolve_device(device)
    seed = cfg.seed if cfg.seed is not None else 0
    engine = build_engine(cfg, device)
    _load_eval_params(cfg, engine)

    dm = build_data_module(cfg, StepTracker())
    sampler = VideoSampler(engine, num_anchors_views=cfg.test.num_anchors_views,
                           ar_latent_feedthrough=cfg.test.ar_latent_feedthrough)
    test_dir = cfg.test.output_dir if str(cfg.test.output_dir) not in ("", ".") else None
    output_dir = Path(test_dir or cfg.output_dir) / "video"
    output_dir.mkdir(parents=True, exist_ok=True)
    mode = cfg.test.sampling_mode or "anchored"
    _run_test_scene_batched(cfg, sampler, dm, output_dir, device, seed,
                            max(1, cfg.test.scene_batch), cfg.trainer.limit_test_batches, mode)

    # GIF / MP4 export per scene (reference on_test_end:1069-1088).
    sync_processes("test_export")
    rank, world = rank_and_world()
    for scene_dir in sorted(output_dir.iterdir())[rank::world]:
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
    """``device`` is "cuda" when None; the tests pass "cpu". The process
    group that the environment asks for (``parallel/distributed.py``) is
    started first and destroyed at the end."""
    device = resolve_device(device)
    started = not dist.is_initialized() and maybe_initialize_distributed(device=device)
    try:
        if started:
            rank, world = rank_and_world()
            print(f"distributed: process {rank}/{world} ({dist.get_backend()}), "
                  f"device {device if device.type != 'cuda' else torch.cuda.current_device()}")
        cfg_dict = compose(list(argv if argv is not None else sys.argv[1:]))
        set_cfg(cfg_dict)
        cfg = load_typed_root_config(cfg_dict)
        if cfg.seed is not None:
            np.random.seed(cfg.seed)
        print(f"mode={cfg.mode} output_dir={cfg.output_dir}")
        if cfg.mode == "train":
            run_train(cfg, device)
        elif cfg.mode == "val":
            run_val(cfg, device)
        elif cfg.mode == "test":
            run_test(cfg, device)
        else:
            raise ValueError(f"Unknown mode: {cfg.mode}")
    finally:
        if started:
            shutdown_distributed()


if __name__ == "__main__":
    main()
