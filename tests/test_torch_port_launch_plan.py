"""The kernel launch counts that ``chip_smoke.py`` requires of its
sampling and training-CLI runs, counted again on the CPU: the engine each
run's config builds, on the meta device in bf16 (shapes only, routed as on
the card), with the kernel wrappers stubbed by counters, runs the run's
work. A sampling count is affine in the step count, so it is counted at 1
and 2 steps and taken to the run's steps. A training run is its steps'
loss and backward at the config's batch plus its validation scenes, each a
1 + 3-view ``engine.sample`` at the config's 70 steps, plus its optimizer's
fused-kernel launches over its steps."""

import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

import chip_smoke
from mvldm_tpu_torch import builder, config
from mvldm_tpu_torch.diffusion.video_sampling import SceneViews, VideoSampler
from mvldm_tpu_torch.models import layers
from mvldm_tpu_torch.ops import attention as attn
from mvldm_tpu_torch.ops import fused_adamw, fused_attn, fused_ff
from mvldm_tpu_torch.scripts.main import base_lr
from mvldm_tpu_torch.training import build_lr_schedule, build_optimizer
from mvldm_tpu_torch.training.trainer import batch_from_arrays

NAMES = ("flash_attention", "fused_ln_self_attention", "fused_ln_geglu_ff")


@pytest.fixture
def counters(monkeypatch):
    counts = dict.fromkeys(NAMES, 0)

    def stub(name):
        def launch(x, *args, **kwargs):
            counts[name] += 1
            return torch.empty_like(x)
        return launch

    monkeypatch.setattr(attn, "flash_attention", stub("flash_attention"))
    monkeypatch.setattr(layers, "fused_ln_self_attention", stub("fused_ln_self_attention"))
    monkeypatch.setattr(layers, "fused_ln_geglu_ff", stub("fused_ln_geglu_ff"))
    return counts


def scene(n_target: int, first_id: int):
    n = n_target + 1
    images = np.random.default_rng(first_id).integers(0, 255, (n, 256, 256, 3), np.uint8)
    extr = np.repeat(np.eye(4, dtype=np.float32)[None], n, axis=0)
    extr[:, 0, 3] = np.linspace(0, 2, n)
    intr = np.repeat(np.eye(3, dtype=np.float32)[None], n, axis=0)
    intr[:, :2, 2] = 0.5
    ids = np.arange(first_id, first_id + n)
    return (SceneViews(images[:1], extr[:1], intr[:1], ids[:1]),
            SceneViews(images[1:], extr[1:], intr[1:], ids[1:]))


# run: (config overrides, steps, mode, scenes, frames of a scene, feedthrough)
RUNS = {
    "anchored": ([], 25, "anchored", 2, 8, False),
    "autoregressive": ([], 25, "autoregressive", 1, 7, False),
    "autoregressive_feedthrough": ([], 25, "autoregressive", 1, 7, True),
    "ddpm": (["model/scheduler=ddpm"], 10, "anchored", 1, 4, False),
    "standard": (["model/denoiser/multi_view_attention=standard"], 25, "anchored", 1, 4, False),
    "main_path": ([], 25, "anchored", 1, 16, False),
}


def count(counters, overrides, steps, mode, n_scenes, frames, feed) -> dict:
    cfg = config.load_typed_root_config(config.compose(
        ["+experiment=baseline", *overrides, f"model.scheduler.num_inference_steps={steps}"]))
    engine = builder.build_engine(cfg, "meta")
    assert engine.dtype == torch.bfloat16
    sampler = VideoSampler(engine, ar_latent_feedthrough=feed)
    for name in NAMES:
        counters[name] = 0
    getattr(sampler, f"dispatch_{mode}_many")(
        [scene(frames, 100 * i) for i in range(n_scenes)], None)
    return dict(counters)


@pytest.mark.parametrize("run", list(RUNS))
def test_chip_smoke_launch_counts_are_the_plans(counters, run):
    overrides, steps, mode, n_scenes, frames, feed = RUNS[run]
    one = count(counters, overrides, 1, mode, n_scenes, frames, feed)
    two = count(counters, overrides, 2, mode, n_scenes, frames, feed)
    plan = {k: one[k] + (steps - 1) * (two[k] - one[k]) for k in NAMES}
    want = chip_smoke.SCENE_LAUNCHES if run == "main_path" else chip_smoke.CLI_LAUNCHES[run]
    assert plan == want


def t2mv_count(counters, steps: int) -> dict:
    engine = chip_smoke.build_mvdream("meta", steps=steps)
    assert engine.dtype == torch.bfloat16
    for name in NAMES:
        counters[name] = 0
    engine.text_to_multiview(*chip_smoke.t2mv_inputs(chip_smoke.T2MV_PROMPTS, "meta"))
    return dict(counters)


def test_chip_smoke_t2mv_launch_counts_are_the_plan(counters):
    """MVDream's text-to-multiview dispatch in the t2mv phase (4 prompts x
    4 views, the configuration's 50 steps)."""
    steps = chip_smoke.build_mvdream("meta").scheduler.num_inference_steps
    one, two = t2mv_count(counters, 1), t2mv_count(counters, 2)
    plan = {k: one[k] + (steps - 1) * (two[k] - one[k]) for k in NAMES}
    assert steps == 50 and plan == chip_smoke.T2MV_LAUNCHES


TRAIN_NAMES = NAMES + ("flash_attention_bwd_dq", "flash_attention_bwd_dkv")


@pytest.fixture
def kernel_counters(monkeypatch):
    """Every bf16 kernel wrapper stubbed by a counter below the autograd
    functions, so that a backward reaches the backward kernels as on the
    card (the fused blocks' backward recomputes through the flash
    forward)."""
    counts = dict.fromkeys(TRAIN_NAMES, 0)

    def rows(q):
        return torch.empty(q.shape[:3], dtype=torch.float32, device=q.device)

    def fwd(q, k, v, bias=None, scale=None, return_lse=False):
        counts["flash_attention"] += 1
        return (torch.empty_like(q), rows(q)) if return_lse else torch.empty_like(q)

    def dq(q, k, v, bias, out, lse, g, scale=None):
        counts["flash_attention_bwd_dq"] += 1
        return torch.empty_like(q), rows(q)

    def dkv(q, k, v, bias, lse, delta, g, scale=None, need_dbias=True):
        counts["flash_attention_bwd_dkv"] += 1
        db = (torch.empty(k.shape[:3], dtype=torch.float32, device=k.device)
              if bias is not None and need_dbias else None)
        return torch.empty_like(k), torch.empty_like(v), db

    def block(name):
        def launch(x, *args, **kwargs):
            counts[name] += 1
            return torch.empty_like(x)
        return launch

    monkeypatch.setattr(attn, "flash_attention", fwd)
    monkeypatch.setattr(attn, "flash_attention_bwd_dq", dq)
    monkeypatch.setattr(attn, "flash_attention_bwd_dkv", dkv)
    monkeypatch.setattr(fused_attn, "_fused_attn_cuda", block("fused_ln_self_attention"))
    monkeypatch.setattr(fused_ff, "_fused_ff_cuda", block("fused_ln_geglu_ff"))
    return counts


def meta_engine(overrides, steps=None):
    cfg = config.load_typed_root_config(config.compose(
        ["+experiment=baseline", *overrides]
        + ([] if steps is None else [f"model.scheduler.num_inference_steps={steps}"])))
    engine = builder.build_engine(cfg, "meta")
    engine.vae.requires_grad_(False)
    assert engine.dtype == torch.bfloat16
    return cfg, engine


def train_step_launches(counts, overrides, latents: bool = False) -> dict:
    """One training step's loss and backward at the config's batch, from
    images or, with ``latents``, from cached posterior moments."""
    cfg, engine = meta_engine(overrides)
    b = cfg.data_loader.train.batch_size
    views = {"context": cfg.dataset.view_sampler.num_context_views,
             "target": cfg.dataset.view_sampler.num_target_views}
    raw = {role: {"image": torch.empty((b, n, 256, 256, 3)),
                  "extrinsics": torch.eye(4).repeat(b, n, 1, 1),
                  "intrinsics": torch.eye(3).repeat(b, n, 1, 1),
                  "latent_moments": torch.empty((b, n, 32, 32, 8))}
           for role, n in views.items()}
    keys = ("image", "extrinsics", "intrinsics")
    batch = batch_from_arrays(*(None if latents and k == "image" else raw[r][k]
                                for k in keys for r in ("context", "target")),
                              *((raw["context"]["latent_moments"],
                                 raw["target"]["latent_moments"]) if latents else ()))
    counts.update(dict.fromkeys(counts, 0))
    loss, _ = engine.training_loss(batch, views["context"])
    loss.backward()
    return dict(counts)


def val_scene_launches(counts, overrides) -> dict:
    """One validation scene: ``engine.sample`` of 3 targets from one context
    view, at the config's step count (affine in it: counted at 1 and 2)."""
    cfg = config.load_typed_root_config(config.compose(["+experiment=baseline", *overrides]))
    steps = cfg.model.scheduler.num_inference_steps
    by_steps = []
    for n in (1, 2):
        _, engine = meta_engine(overrides, n)
        counts.update(dict.fromkeys(counts, 0))
        n_tgt = cfg.dataset.view_sampler.num_target_views
        engine.sample(torch.empty((1, 1, 256, 256, 3)), torch.eye(4).repeat(1, 1 + n_tgt, 1, 1),
                      torch.eye(3).repeat(1, 1 + n_tgt, 1, 1), num_target_views=n_tgt)
        by_steps.append(dict(counts))
    one, two = by_steps
    return {k: one[k] + (steps - 1) * (two[k] - one[k]) for k in counts}


def optimizer_launches(monkeypatch, overrides, steps: int) -> dict:
    """The fused-kernel launches of the run's optimizer (built from its
    config as ``scripts.main`` builds it) over ``steps`` micro-steps, on a
    small state of CUDA tensors (``FakeTensorMode``) with the kernels
    stubbed by counters; where ``Optimizer.fused_step`` refuses the state,
    the foreach chain runs and launches none."""
    cfg = config.load_typed_root_config(config.compose(["+experiment=baseline", *overrides]))
    tx = build_optimizer(cfg.optimizer, build_lr_schedule(base_lr(cfg), cfg.optimizer.scheduler),
                         gradient_clip_val=cfg.trainer.gradient_clip_val,
                         accumulate_grad_batches=cfg.trainer.accumulate_grad_batches)
    counts = dict.fromkeys(chip_smoke.OPTIM_KERNELS, 0)

    def counted(name):
        def launch(*args):
            counts[name] += 1
        return launch

    monkeypatch.setattr(fused_adamw, "accumulate", counted("fused_adamw_accumulate"))
    monkeypatch.setattr(fused_adamw, "update", counted("fused_adamw_update"))
    with FakeTensorMode():
        params = {"w": torch.zeros(8, 6, device="cuda"), "b": torch.zeros(6, device="cuda")}
        state = tx.init(params)
        for _ in range(steps):
            grads = {k: torch.zeros_like(p, dtype=torch.bfloat16) for k, p in params.items()}
            if tx.fused_step(params, grads, state) is None:
                break
            tx.apply(params, grads, state)
    return counts


# run: (config overrides, training steps, validation scenes, from the latent cache)
TRAIN_RUNS = {
    "train": ([], 4, 2 * 2, False),                # (f): hooks at steps 2 and 4, 2 scenes each
    "train_resume": ([], 2, 1 * 2, False),         # (g): steps 5-6, a hook at step 6
    "val": ([], 0, 2, False),                      # (h): one val batch of 2 scenes
    "train_tpu_fast": (["+experiment=tpu_fast"], 4, 0, False),  # (i): remat, no hook by step 4
    "train_latent_cache": (["+experiment=tpu_fast"], 4, 0, True),  # (k): no VAE encode
    "train_adafactor": (["optimizer.name=Adafactor"], 2, 0, False),  # (l)
    "train_remat_dots": (["trainer.remat=true", "trainer.remat_policy=dots"], 2, 0, False),  # (m)
}


@pytest.mark.parametrize("run", list(TRAIN_RUNS))
def test_chip_smoke_training_cli_launch_counts_are_the_plans(kernel_counters, monkeypatch, run):
    overrides, steps, scenes, latents = TRAIN_RUNS[run]
    step = train_step_launches(kernel_counters, overrides, latents)
    scene = val_scene_launches(kernel_counters, overrides)
    plan = {k: steps * step[k] + scenes * scene[k] for k in TRAIN_NAMES}
    plan.update(optimizer_launches(monkeypatch, overrides, steps))
    assert plan == chip_smoke.TRAIN_CLI_LAUNCHES[run]
    assert all(plan[k] for k in TRAIN_NAMES if steps)
