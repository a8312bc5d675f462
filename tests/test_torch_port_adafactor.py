"""The port's Adafactor against the JAX package's (``optax.adafactor`` of
optax 0.2.6 under ``build_optimizer``'s global-norm clip and
``MultiSteps``), f32 on CPU.

Parameters within 1e-6 relative after each of three applied updates, with
and without momentum, weight decay, the parameter scale, the block clip and
accumulation. Tensors whose two largest dims are at least 128 are factored
(a row and a column vector of second moments), as in optax; the state holds
no full-shape second moment for them. Checkpoint save and restore carry the
state: a resumed run equals an unbroken one bitwise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax._src.factorized as optax_factorized
import pytest
import torch

from mvldm_tpu.config import OptimizerCfg as JaxOptCfg
from mvldm_tpu.training.optim import build_lr_schedule as jax_lr
from mvldm_tpu.training.optim import build_optimizer as jax_opt
from mvldm_tpu_torch.training import (
    CheckpointManager,
    OptimizerCfg,
    build_lr_schedule,
    build_optimizer,
)
from mvldm_tpu_torch.training.optim import factored_dims

# Factored: (256, 128), (130, 128, 3, 3) (its two largest dims), and the
# square (128, 128); full-shape: (16, 8), (8,), (3, 3, 4, 4), (200, 100).
SHAPES = {"a": (256, 128), "b": (8,), "c": (130, 128, 3, 3), "d": (16, 8),
          "e": (3, 3, 4, 4), "f": (128, 128), "g": (200, 100)}
FACTORED = {"a", "c", "f"}

CASES = {
    "plain_clip": ({}, 0.1, 1),
    "momentum_decay": ({"momentum": 0.9, "weight_decay": 0.01}, None, 1),
    "no_scale_no_block_clip": ({"multiply_by_parameter_scale": False,
                                "clipping_threshold": None, "decay_rate": 0.7}, 1.0, 1),
    "multisteps_momentum": ({"momentum": 0.5, "weight_decay": 0.1}, 0.5, 2),
}


def _grads(rng, step):
    scale = 0.02 if step % 2 else 0.3
    return {n: (rng.standard_normal(s) * scale).astype(np.float32) for n, s in SHAPES.items()}


@pytest.mark.parametrize("case", sorted(CASES))
def test_adafactor_vs_optax(case):
    kwargs, clip, k = CASES[case]
    lr = 1e-2
    tx = jax_opt(JaxOptCfg(name="Adafactor", lr=lr, kwargs=dict(kwargs)), jax_lr(lr, None),
                 gradient_clip_val=clip, accumulate_grad_batches=k)
    port = build_optimizer(OptimizerCfg("Adafactor", lr, dict(kwargs)), build_lr_schedule(lr, None),
                           gradient_clip_val=clip, accumulate_grad_batches=k)
    rng = np.random.default_rng(0)
    params = {n: rng.standard_normal(s).astype(np.float32) for n, s in SHAPES.items()}
    params["b"] *= 1e-4  # rms below 1e-3: the parameter scale's floor
    jparams = {n: jnp.asarray(p) for n, p in params.items()}
    tparams = {n: torch.from_numpy(p.copy()) for n, p in params.items()}
    jstate, tstate = tx.init(jparams), port.init(tparams)
    for step in range(3 * k):
        grads = _grads(rng, step)
        updates, jstate = tx.update({n: jnp.asarray(g) for n, g in grads.items()}, jstate, jparams)
        jparams = jax.tree_util.tree_map(lambda p, u: p + u, jparams, updates)
        applied = port.apply(tparams, {n: torch.from_numpy(g) for n, g in grads.items()}, tstate)
        assert applied == ((step + 1) % k == 0)
        for n in SHAPES:
            np.testing.assert_allclose(tparams[n].numpy(), np.asarray(jparams[n]), rtol=1e-6,
                                       atol=1e-7, err_msg=f"{case} step {step} {n}")
    moved = [n for n in SHAPES if not np.array_equal(tparams[n].numpy(), params[n])]
    assert moved == list(SHAPES)
    assert tstate["count"] == 3


def test_factored_state_has_no_full_shape_moment():
    tx = build_optimizer(OptimizerCfg("Adafactor", 1e-4, {"momentum": 0.9}),
                         build_lr_schedule(1e-4, None), gradient_clip_val=0.1)
    params = {n: torch.ones(s) for n, s in SHAPES.items()}
    state = tx.init(params)
    assert set(state["v_row"]) == set(state["v_col"]) == FACTORED
    assert set(state["v"]) == set(SHAPES) - FACTORED
    for n in FACTORED:
        assert all(t.shape != params[n].shape for t in (state["v_row"][n], state["v_col"][n]))
        assert state["v_row"][n].numel() + state["v_col"][n].numel() < params[n].numel() / 50
    assert state["v_row"]["c"].shape == (128, 3, 3) and state["v_col"]["c"].shape == (130, 3, 3)
    for shape in SHAPES.values():
        assert factored_dims(shape) == optax_factorized._factored_dims(shape, True, 128)
    g = {n: torch.full(s, 0.1) for n, s in SHAPES.items()}
    assert tx.apply(params, g, state)
    assert all(torch.isfinite(p).all() for p in params.values())


def test_adafactor_state_survives_a_checkpoint(tmp_path):
    """Three updates, or one, a save and restore, then two: bitwise equal."""
    def make():
        return build_optimizer(OptimizerCfg("Adafactor", 1e-2, {"momentum": 0.9,
                                                               "weight_decay": 0.01}),
                               build_lr_schedule(1e-2, None), gradient_clip_val=0.1,
                               accumulate_grad_batches=2)

    rng = np.random.default_rng(1)
    init = {n: torch.from_numpy(rng.standard_normal(s).astype(np.float32))
            for n, s in SHAPES.items()}
    grads = [{n: torch.from_numpy(g) for n, g in _grads(rng, i).items()} for i in range(6)]
    tx = make()
    straight = {n: p.clone() for n, p in init.items()}
    state = tx.init(straight)
    for g in grads:
        tx.apply(straight, g, state)

    params = {n: p.clone() for n, p in init.items()}
    state = tx.init(params)
    for g in grads[:3]:
        tx.apply(params, g, state)
    mgr = CheckpointManager(tmp_path)
    mgr.save(3, {"params": params, "opt_state": state})
    restored = mgr.restore(3)
    params, state = restored["params"], restored["opt_state"]
    assert state["mini_step"] == 1 and state["count"] == 1
    tx = make()
    for g in grads[3:]:
        tx.apply(params, g, state)
    for n in SHAPES:
        assert torch.equal(params[n], straight[n]), n


def test_adafactor_through_the_training_cli(tmp_path):
    """``optimizer.name=Adafactor`` trains 2 steps, saves, and resumes to 3
    from the saved factored state."""
    import json

    from mvldm_tpu_torch.scripts import main as main_script

    from synthetic_data import write_synthetic_dataset
    from tests.test_torch_port_train_cli import TINY

    root = write_synthetic_dataset(tmp_path / "re10k", frames_per_scene=24)
    common = TINY + [f"dataset.root={root}", f"output_dir={tmp_path / 'run'}", "mode=train",
                     "optimizer.name=Adafactor", "+optimizer.kwargs={momentum: 0.9}",
                     "checkpointing.every_n_train_steps=2"]
    main_script.main(common + ["trainer.max_steps=2"], device="cpu")
    main_script.main(common + ["trainer.max_steps=3"], device="cpu")
    mgr = CheckpointManager(tmp_path / "run" / "checkpoints")
    assert mgr.all_steps() == [3]
    state = mgr.restore(3)
    assert state["step"] == 3 and state["opt_state"]["count"] == 3
    assert state["opt_state"]["v_row"] and set(state["opt_state"]["ema"]) == set(state["params"])
    records = [json.loads(line) for line in
               (tmp_path / "run" / "metrics.jsonl").read_text().splitlines()]
    assert [r["step"] for r in records] == [2, 3]
    assert all(np.isfinite(r["loss/diffusion"]) for r in records)
