"""The port's training CLI (``scripts/main.py mode=train`` with in-training
validation, ``mode=val``) and its ``Trainer`` on the CPU
(``device="cpu"``), with the tiny experiment on synthetic RE10K data.

* ``_render_val_batch`` against the JAX one, ``engine.sample`` stubbed in
  both to return the same seeded images: the same files, the same camera
  and grid PNGs bitwise, and a histogram figure of the same size (the port
  draws it without matplotlib, see ``visualization/color_map.py``);
* ``Trainer.fit``: the hook at multiples of ``val_check_interval``; a step
  after an EMA val hook equals the same step without the hook, bitwise;
  the loader closed when a step raises; the profile window;
* ``main mode=train`` then ``mode=test`` writes the JAX CLI's tree
  (``tests/test_e2e.py``), resumes, and ``mode=val`` writes ``val/``;
* ``restore_partial`` reads only the keys asked for.
"""

import json
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from mvldm_tpu.scripts import main as jax_main
from mvldm_tpu_torch import builder, config
from mvldm_tpu_torch.data.view_samplers import StepTracker
from mvldm_tpu_torch.scripts import main as main_script
from mvldm_tpu_torch.training import CheckpointManager, Trainer, build_lr_schedule
from mvldm_tpu_torch.training import build_optimizer
from mvldm_tpu_torch.training.optim import OptimizerCfg
from mvldm_tpu_torch.utils.image_io import load_image

from synthetic_data import write_synthetic_dataset

TINY = ["+experiment=tiny", "dataset.image_shape=[32,32]", "data_loader.train.num_workers=1",
        "data_loader.val.batch_size=2", "trainer.accumulate_grad_batches=1"]


@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    return write_synthetic_dataset(tmp_path_factory.mktemp("re10k"), frames_per_scene=24)


def tiny_cfg(data_root, out, *overrides):
    return config.load_typed_root_config(config.compose(
        TINY + [f"dataset.root={data_root}", f"output_dir={out}", *overrides]))


def tree(root: Path) -> set:
    return {str(p.relative_to(root)) for p in root.rglob("*") if p.is_file()}


# ----------------------------------------------------------- val rendering

class SeededSamples:
    """``engine.sample`` of either package: the n-th call returns (1, v_t,
    h, w, 3) images from numpy's generator seeded n."""

    def __init__(self, hw):
        self.calls, self.hw = 0, hw

    def __call__(self, *args, num_target_views, **kwargs):
        rng = np.random.default_rng(self.calls)
        self.calls += 1
        return rng.uniform(size=(1, num_target_views, *self.hw, 3)).astype(np.float32)


def test_render_val_batch_vs_jax(data_root, tmp_path):
    cfg = tiny_cfg(data_root, tmp_path)
    loader = main_script.build_data_module(cfg, StepTracker()).val_dataloader()
    try:
        batch = next(iter(loader))
    finally:
        loader.close()
    assert len(batch["scene"]) == 2

    class PortEngine:
        sample = SeededSamples((32, 32))

    class JaxEngine:
        sample = SeededSamples((32, 32))

    def port_sample(*args, **kwargs):
        return torch.from_numpy(PortEngine.sample(*args, **kwargs))

    port = PortEngine()
    port.sample = port_sample
    main_script._render_val_batch(port, batch, tmp_path / "port", torch.device("cpu"), 0, 2, 5)
    jax_main._render_val_batch(JaxEngine(), None, None, batch, tmp_path / "jax",
                               jax.random.PRNGKey(0))
    names = tree(tmp_path / "jax")
    assert tree(tmp_path / "port") == names == (
        {"cameras.png", "distributions.png"} | {f"{s}.png" for s in batch["scene"]})
    for name in names:
        got, want = load_image(tmp_path / "port" / name), load_image(tmp_path / "jax" / name)
        assert got.shape == want.shape, name
        if name != "distributions.png":
            np.testing.assert_array_equal(got, want, err_msg=name)


def test_val_generators_are_per_scene_and_step():
    gens = [main_script.dispatch_generator("cpu", 0, 2, step, i)
            for step in (2, 4) for i in (0, 1)]
    draws = [torch.randn(4, generator=g) for g in gens]
    assert all(not torch.equal(a, b) for i, a in enumerate(draws) for b in draws[i + 1:])
    again = torch.randn(4, generator=main_script.dispatch_generator("cpu", 0, 2, 2, 0))
    assert torch.equal(again, draws[0])


# ----------------------------------------------------------------- Trainer

class BatchesOf:
    """A data module over a real one's first train batch, repeated; it
    records each loader and whether it was closed."""

    def __init__(self, batch, fail_at=None):
        self.batch, self.fail_at, self.loaders = batch, fail_at, []

    def train_dataloader(self):
        module = self

        class Loader:
            closed = False

            def __iter__(self):
                for i in range(100):
                    if i == module.fail_at:
                        raise RuntimeError("decode failed")
                    yield module.batch

            def close(self, timeout=None):
                self.closed = True

        self.loaders.append(Loader())
        return self.loaders[-1]


@pytest.fixture(scope="module")
def train_batch(data_root, tmp_path_factory):
    cfg = tiny_cfg(data_root, tmp_path_factory.mktemp("b"))
    loader = main_script.build_data_module(cfg, StepTracker()).train_dataloader()
    try:
        return next(iter(loader))
    finally:
        loader.close()


def make_trainer(data_root, out, module, *, max_steps, ema=False, hook=None, interval=None):
    cfg = tiny_cfg(data_root, out)
    engine = builder.build_engine(cfg, "cpu")
    engine.vae.requires_grad_(False)
    tx = build_optimizer(OptimizerCfg("AdamW", 1e-3), build_lr_schedule(1e-3, None),
                         gradient_clip_val=0.1)
    return Trainer(engine, tx, module, out, max_steps=max_steps, num_context_views=2,
                   checkpoint_every=100, log_every=1, use_ema=ema, val_hook=hook,
                   val_check_interval=interval)


def test_fit_runs_the_hook_every_interval(data_root, tmp_path, train_batch):
    calls = []
    module = BatchesOf(train_batch)
    trainer = make_trainer(data_root, tmp_path, module, max_steps=5,
                           hook=lambda state, step: calls.append((step, state.step)), interval=2)
    state = trainer.fit(trainer.init_state())
    assert calls == [(2, 2), (4, 4)] and state.step == 5
    assert module.loaders[0].closed


def test_a_raising_step_still_closes_the_loader(data_root, tmp_path, train_batch):
    module = BatchesOf(train_batch, fail_at=1)
    trainer = make_trainer(data_root, tmp_path, module, max_steps=5)
    with pytest.raises(RuntimeError, match="decode failed"):
        trainer.fit(trainer.init_state())
    assert module.loaders[0].closed


def test_a_step_after_an_ema_val_hook_equals_one_without(data_root, tmp_path, train_batch,
                                                         monkeypatch):
    """The hook samples with the EMA weights (the module holds them while
    it renders) and puts the masters back: step 3 then computes what it
    computes with no hook at all."""
    seen = []

    def render(engine, dm, out_dir, device, seed, *folds):
        named = dict(engine.unet.named_parameters())
        seen.append({n: named[n].detach().clone() for n in named})

    monkeypatch.setattr(main_script, "_render_first_val_batch", render)
    runs = {}
    for name, with_hook in (("hook", True), ("plain", False)):
        out = tmp_path / name
        cfg = tiny_cfg(data_root, out, "model.use_ema_sampling=true", "model.ema=true")
        trainer = make_trainer(data_root, out, BatchesOf(train_batch), max_steps=3, ema=True,
                               interval=2)
        if with_hook:
            trainer.val_hook = main_script.make_val_hook(cfg, trainer.engine, out, 0)
        runs[name] = trainer.fit(trainer.init_state(), seed=3)
    assert len(seen) == 1
    hook, plain = runs["hook"], runs["plain"]
    for n in plain.params:
        assert torch.equal(hook.params[n], plain.params[n]), n
        assert torch.equal(hook.ema_params[n], plain.ema_params[n]), n
    # The hook saw EMA weights, which differ from the masters by step 2.
    assert any(not torch.equal(seen[0][n], plain.params[n]) for n in plain.params)


def test_profile_window_writes_a_trace(data_root, tmp_path, train_batch, monkeypatch):
    monkeypatch.setenv("MVLDM_PROFILE_DIR", str(tmp_path / "prof"))
    trainer = make_trainer(data_root, tmp_path, BatchesOf(train_batch), max_steps=14)
    trainer.fit(trainer.init_state())
    trace = tmp_path / "prof" / "trace.json"
    events = json.loads(trace.read_text())["traceEvents"]
    # The program's own ranges lie in the window: three steps' parts.
    for part in ("train.data_wait", "train.forward_backward", "train.optimizer",
                 "engine.training_loss", "train.log"):
        assert sum(e.get("name") == "mvldm/" + part for e in events) == 3, part
    # The gradient norm is read on the host twice a step: the metric and the clip.
    assert sum(e.get("name") == "mvldm/sync.grad_norm" for e in events) == 6


# --------------------------------------------------------------------- CLI

def test_train_then_test_then_val(data_root, tmp_path):
    """``tests/test_e2e.py``'s run through the port: 2 steps with a val hook
    at step 2 and a checkpoint, anchored sampling of one scene from it,
    a resumed run to step 3, then ``mode=val``."""
    common = TINY + [f"dataset.root={data_root}", f"output_dir={tmp_path}"]
    main_script.main(common + ["mode=train", "trainer.max_steps=2",
                               "checkpointing.every_n_train_steps=2",
                               "trainer.val_check_interval=2"], device="cpu")
    records = [json.loads(line) for line in (tmp_path / "metrics.jsonl").read_text().splitlines()]
    assert records[-1]["step"] == 2 and np.isfinite(records[-1]["loss/diffusion"])
    assert (tmp_path / "checkpoints" / "step_000000002").exists()
    assert tree(tmp_path / "val" / "step_2") == {
        "cameras.png", "distributions.png", "scenetest0000.png", "scenetest0001.png"}

    main_script.main(common + ["mode=test", "test.sampling_mode=anchored", "test.limit_frames=8",
                               "trainer.limit_test_batches=1",
                               "dataset.view_sampler.max_distance_between_context_views=10"],
                     device="cpu")
    scenes = [p for p in (tmp_path / "video").iterdir() if p.is_dir()]
    assert len(scenes) == 1
    assert len(list((scenes[0] / "color").glob("*.png"))) == 8
    assert (scenes[0] / "sampled.gif").exists()
    assert len(list((scenes[0] / "context").glob("*.png"))) >= 1

    state = main_script.run_train(tiny_cfg(data_root, tmp_path, "trainer.max_steps=3",
                                           "trainer.val_check_interval=null"), "cpu")
    assert state.step == 3 and state.opt_state["count"] == 3
    assert CheckpointManager(tmp_path / "checkpoints").latest_step() == 3

    main_script.main(common + ["mode=val"], device="cpu")
    assert tree(tmp_path / "val") >= {"cameras.png", "distributions.png", "scenetest0000.png",
                                      "scenetest0001.png"}


def test_freeze_denoiser_through_the_cli(data_root, tmp_path):
    state = main_script.run_train(tiny_cfg(data_root, tmp_path, "mode=train",
                                           "trainer.max_steps=2", "freeze.denoiser=true",
                                           "trainer.val_check_interval=null"), "cpu")
    engine = builder.build_engine(tiny_cfg(data_root, tmp_path), "cpu")
    named = dict(engine.unet.named_parameters())
    assert state.step == 2 and state.opt_state == {}
    assert all(torch.equal(p, named[n].detach()) for n, p in state.params.items())


def test_restore_partial_reads_only_the_keys(tmp_path):
    mgr = CheckpointManager(tmp_path / "ckpts")
    mgr.save(3, {"params": {"w": torch.arange(6.0)}, "ema_params": {"w": torch.ones(6)},
                 "opt_state": {"count": 3, "mu": {"w": torch.zeros(6)}}, "step": 3})
    got = mgr.restore_partial(3, ["ema_params"])
    assert list(got) == ["ema_params"]
    assert torch.equal(got["ema_params"]["w"], torch.ones(6))
    assert list(mgr.restore_partial(3, ["params"])) == ["params"]
    with pytest.raises(KeyError):
        mgr.restore_partial(3, ["missing"])


def test_eval_params_use_restore_partial(data_root, tmp_path, monkeypatch):
    calls = []
    original = CheckpointManager.restore_partial

    def counted(self, step, keys):
        calls.append((step, list(keys)))
        return original(self, step, keys)

    monkeypatch.setattr(CheckpointManager, "restore_partial", counted)
    monkeypatch.setattr(CheckpointManager, "restore",
                        lambda *a, **k: pytest.fail("the whole state was read"))
    cfg = tiny_cfg(data_root, tmp_path)
    engine = builder.build_engine(cfg, "cpu")
    params = {n: p.detach() + 1.0 for n, p in engine.unet.named_parameters()}
    CheckpointManager(tmp_path / "checkpoints").save(7, {"params": params, "step": 7})
    main_script._load_eval_params(cfg, engine)
    assert calls == [(7, ["params"])]
    named = dict(engine.unet.named_parameters())
    assert all(torch.equal(named[n].detach(), p) for n, p in params.items())
