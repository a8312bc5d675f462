"""The port's training path against the JAX package, fp32 on CPU.

Tiny topology of ``tests/test_torch_goldens.py``: one synthetic reference
checkpoint loads into both packages. Every random draw of a JAX training
step is rebuilt from its key (``engine.py`` ``training_loss``) and handed
to the port as a ``TrainDraws``, so both compute the same function:

* the loss and every UNet gradient against ``jax.value_and_grad`` of
  ``DiffusionEngine.training_loss``, and block remat on / off;
* the optimizer against the optax chain (clip, AdamW with f32 and bf16
  first moments, MultiSteps k = 2, LinearLR, Adam, SGD) and the EMA gate;
* ``make_train_step`` against the JAX ``make_train_step`` for two steps;
* the checkpoint manager (round trip, top-k, resume, torn temporary
  directory) and ``Trainer.fit`` with resume.

Tolerances are stated at each comparison.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mvldm_tpu.config import LRSchedulerCfg as JaxLRCfg
from mvldm_tpu.config import OptimizerCfg as JaxOptCfg
from mvldm_tpu.diffusion.engine import Batch as JaxBatch
from mvldm_tpu.training.optim import build_lr_schedule as jax_lr
from mvldm_tpu.training.optim import build_optimizer as jax_opt
from mvldm_tpu.training.trainer import TrainState as JaxTrainState
from mvldm_tpu.training.trainer import make_train_step as jax_make_train_step
from mvldm_tpu_torch.diffusion.engine import Batch, TrainDraws
from mvldm_tpu_torch.training import optim as port_optim
from mvldm_tpu_torch.training import (
    CheckpointManager,
    LRSchedulerCfg,
    OptimizerCfg,
    Trainer,
    build_lr_schedule,
    build_optimizer,
    make_train_step,
)
from mvldm_tpu_torch.training.trainer import TrainState, master_params
from mvldm_tpu_torch.utils.weight_convert import jax_to_torch_state_dict

from tests.test_sampling_goldens import build_engine
from tests.test_torch_goldens import checkpoint  # noqa: F401  (module-scoped fixture)
from tests.test_torch_port_engine import port_engine
from tests.test_torch_port_models import IGNORED

B, V, V_C, HW = 2, 5, 2, 32
HL = HW // 8
LOSS_SEED = 33  # its draws keep one context view, flip one to target, drop CFG on one row


def make_arrays(b: int = B):
    rng = np.random.default_rng(0)
    images = rng.uniform(size=(b, V, HW, HW, 3)).astype(np.float32)
    extr = np.tile(np.eye(4, dtype=np.float32), (b, V, 1, 1))
    extr[:, :, 0, 3] = np.linspace(0.0, 1.0, V)
    extr[:, :, 2, 3] = rng.normal(size=(b, V)).astype(np.float32) * 0.2
    intr = np.tile(np.eye(3, dtype=np.float32), (b, V, 1, 1))
    intr[:, :, 0, 2] = intr[:, :, 1, 2] = 0.5
    is_target = np.array([[False] * V_C + [True] * (V - V_C)] * b)
    return images, extr, intr, is_target


def jax_batch(arrays):
    return JaxBatch(*(jnp.asarray(a) for a in arrays))


def port_batch(arrays):
    return Batch(*(torch.from_numpy(a) for a in arrays))


def draws_from_key(key, b: int = B) -> TrainDraws:
    """The draws of the JAX ``training_loss`` for ``key``, in its order."""
    keys = jax.random.split(key, 6)
    t_key, cfg_key = jax.random.split(keys[5])
    shape = (b, V, HL, HL, 4)

    def t(a, dtype=None):
        return torch.from_numpy(np.asarray(a)).to(dtype) if dtype else torch.from_numpy(np.asarray(a))

    return TrainDraws(
        n_ctx=t(jax.random.randint(keys[0], (b,), 1, V_C + 1), torch.int64),
        perm_scores=t(jax.random.uniform(keys[1], (b, V_C))),
        use_relative=t(jax.random.bernoulli(keys[2], 0.5, (b,))),
        posterior_eps=t(jax.random.normal(keys[3], (b * V, HL, HL, 4))).reshape(shape),
        noise=t(jax.random.normal(keys[4], shape)),
        t=t(jax.random.randint(t_key, (b,), 0, 1000), torch.int64),
        unconditional=t(jax.random.bernoulli(cfg_key, 0.1, (b,))),
    )


def port_train_engine(ckpt, remat=False):
    engine = port_engine(ckpt, "auto")
    engine.unet.remat = remat
    engine.vae.requires_grad_(False)
    return engine


def grads_as_port(jax_grads):
    """A JAX UNet gradient tree -> {port UNet parameter name: array}."""
    sd = jax_to_torch_state_dict({"unet": jax_grads})
    return {k[len("denoiser."):]: v.numpy() for k, v in sd.items() if not IGNORED.match(k)}


def port_grads(engine):
    return {n: (p.grad if p.grad is not None else torch.zeros_like(p)).numpy().copy()
            for n, p in engine.unet.named_parameters()}


def rel_l2(got: dict, want: dict) -> float:
    num = sum(float(np.sum((got[k] - want[k]) ** 2)) for k in want)
    den = sum(float(np.sum(want[k] ** 2)) for k in want)
    return (num / den) ** 0.5


@pytest.fixture(scope="module")
def jax_loss_and_grads(checkpoint):  # noqa: F811
    _, params = checkpoint
    engine = build_engine("auto")
    key = jax.random.PRNGKey(LOSS_SEED)
    batch = jax_batch(make_arrays())

    def loss_fn(p):
        return engine.training_loss(p, params["vae"], batch, key, V_C)[0]

    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(params["unet"])
    return float(loss), grads_as_port(grads), draws_from_key(key)


def test_draws_cover_the_loss_branches(jax_loss_and_grads):
    """The seed exercises context-count sampling, relative poses and CFG
    dropout (a masked context view in the joint attention)."""
    d = jax_loss_and_grads[2]
    assert d.n_ctx.min() == 1
    assert d.use_relative.any()
    assert d.unconditional.any() and not d.unconditional.all()


def test_training_loss_and_grads_vs_jax(checkpoint, jax_loss_and_grads):  # noqa: F811
    """Loss within 1e-5 relative and the flattened UNet gradient within 1e-4
    relative L2 of jax.value_and_grad (f32 on both sides; the sums differ
    in order only)."""
    want_loss, want_grads, draws = jax_loss_and_grads
    engine = port_train_engine(checkpoint[0])
    loss, metrics = engine.training_loss(port_batch(make_arrays()), V_C, draws)
    loss.backward()
    assert loss.dtype == torch.float32 and metrics["loss/diffusion"] is loss
    assert abs(loss.item() - want_loss) <= 1e-5 * abs(want_loss)
    got = port_grads(engine)
    assert set(got) == set(want_grads)
    assert rel_l2(got, want_grads) <= 1e-4
    # Every cross-view block, the joint attention's included, gets a gradient.
    joint = "cross_attn_blocks_encoder.0.transformer_blocks.0.attn1.to_q.weight"
    np.testing.assert_allclose(got[joint], want_grads[joint], atol=1e-5,
                               rtol=1e-3 * np.abs(want_grads[joint]).max())


def test_remat_matches_no_remat(checkpoint, jax_loss_and_grads):  # noqa: F811
    """Block remat recomputes the same function: equal loss and gradients
    (1e-6 relative L2: the recomputed forward runs the same ops)."""
    draws = jax_loss_and_grads[2]
    out = []
    for remat in (False, True):
        engine = port_train_engine(checkpoint[0], remat=remat)
        loss, _ = engine.training_loss(port_batch(make_arrays()), V_C, draws)
        loss.backward()
        out.append((loss.item(), port_grads(engine)))
    assert out[0][0] == pytest.approx(out[1][0], rel=1e-7)
    assert rel_l2(out[1][1], out[0][1]) <= 1e-6


def test_latent_moments_path(checkpoint):  # noqa: F811
    """Posterior moments in the batch replace the VAE encode: the same loss
    as the image path when the moments are the encoder's."""
    engine = port_train_engine(checkpoint[0])
    arrays = make_arrays()
    draws = draws_from_key(jax.random.PRNGKey(1))
    with torch.no_grad():
        flat = torch.from_numpy(arrays[0]).reshape(B * V, HW, HW, 3) * 2.0 - 1.0
        dist = engine.vae.encode(flat)
        moments = torch.cat([dist.mean, dist.logvar], dim=-1).reshape(B, V, HL, HL, 8)
        want, _ = engine.training_loss(port_batch(arrays), V_C, draws)
        got, _ = engine.training_loss(
            dataclasses.replace(port_batch(arrays), images=None, latent_moments=moments),
            V_C, draws)
    assert got.item() == pytest.approx(want.item(), rel=1e-6)


# ----------------------------------------------------------------- optimizer

OPT_CASES = {
    "adamw_f32_clip_linear": (dict(name="AdamW", kwargs={}), 0.1, 1,
                              ("LinearLR", {"start_factor": 5e-4, "total_iters": 2})),
    "adamw_bf16_mu": (dict(name="AdamW", kwargs={"mu_dtype": "bfloat16", "weight_decay": 0.05}),
                      0.1, 1, None),
    "adamw_multisteps_2": (dict(name="AdamW", kwargs={"mu_dtype": "bfloat16"}), 0.5, 2,
                           ("LinearLR", {"start_factor": 0.1, "total_iters": 3})),
    "adam_no_clip": (dict(name="Adam", kwargs={"betas": (0.8, 0.99)}), None, 1,
                     ("ConstantLR", {"factor": 0.5, "total_iters": 2})),
    "sgd_momentum_cosine": (dict(name="SGD", kwargs={"momentum": 0.9}), 1.0, 1,
                            ("CosineAnnealingLR", {"T_max": 4, "eta_min": 1e-5})),
}


@pytest.mark.parametrize("chunk_elements", [None, 100])
@pytest.mark.parametrize("case", sorted(OPT_CASES))
def test_optimizer_vs_optax(case, chunk_elements, monkeypatch):
    """Parameters after each of 3 (MultiSteps: 6) steps within 1e-6 (f32
    arithmetic in the same order). With a bf16 first moment, a one-ulp
    difference of the clip's global norm (summed in another order) can
    round an element of mu the other way, which moves that parameter by up
    to lr * 2^-7; that is the absolute tolerance there. ``chunk_elements``
    100 updates the three tensors in three foreach groups."""
    if chunk_elements is not None:
        monkeypatch.setattr(port_optim, "CHUNK_ELEMENTS", chunk_elements)
    opt, clip, k, sched = OPT_CASES[case]
    lr = 1e-3
    jcfg = JaxOptCfg(name=opt["name"], lr=lr, kwargs=dict(opt["kwargs"]))
    jsched = None if sched is None else JaxLRCfg(name=sched[0], kwargs=sched[1])
    tx = jax_opt(jcfg, jax_lr(lr, jsched), gradient_clip_val=clip, accumulate_grad_batches=k)
    port = build_optimizer(OptimizerCfg(opt["name"], lr, dict(opt["kwargs"])),
                           build_lr_schedule(lr, None if sched is None
                                             else LRSchedulerCfg(sched[0], sched[1])),
                           gradient_clip_val=clip, accumulate_grad_batches=k)
    atol = lr * 2 ** -7 if opt["kwargs"].get("mu_dtype") == "bfloat16" else 1e-6
    rng = np.random.default_rng(0)
    shapes = {"a": (16, 8), "b": (8,), "c": (3, 3, 4, 4)}
    params = {n: rng.standard_normal(s).astype(np.float32) for n, s in shapes.items()}
    jparams = {n: jnp.asarray(p) for n, p in params.items()}
    tparams = {n: torch.from_numpy(p.copy()) for n, p in params.items()}
    jstate, tstate = tx.init(jparams), port.init(tparams)
    for step in range(3 * k):
        # Gradient norms around the clip threshold: some steps clip, some not.
        grads = {n: rng.standard_normal(s).astype(np.float32) * (0.02 if step % 2 else 0.3)
                 for n, s in shapes.items()}
        updates, jstate = tx.update({n: jnp.asarray(g) for n, g in grads.items()},
                                    jstate, jparams)
        jparams = jax.tree_util.tree_map(lambda p, u: p + u, jparams, updates)
        applied = port.apply(tparams, {n: torch.from_numpy(g) for n, g in grads.items()},
                             tstate)
        assert applied == ((step + 1) % k == 0)
        for n in shapes:
            np.testing.assert_allclose(tparams[n].numpy(), np.asarray(jparams[n]),
                                       rtol=1e-6, atol=atol, err_msg=f"{case} step {step} {n}")
    if opt["kwargs"].get("mu_dtype") == "bfloat16":
        assert all(m.dtype == torch.bfloat16 for m in tstate["mu"].values())


def test_optimizer_takes_bf16_grads(monkeypatch):
    """bf16 gradients (the card's module gradients) update the masters
    exactly as their f32 casts do, clip and accumulation included."""
    monkeypatch.setattr(port_optim, "CHUNK_ELEMENTS", 100)
    shapes = {"a": (16, 8), "b": (8,), "c": (3, 3, 4, 4)}
    results = []
    for cast in (False, True):
        tx = build_optimizer(OptimizerCfg("AdamW", 1e-3, {"mu_dtype": "bfloat16"}),
                             build_lr_schedule(1e-3, None), gradient_clip_val=0.1,
                             accumulate_grad_batches=2)
        params = {n: torch.ones(s) for n, s in shapes.items()}
        state = tx.init(params)
        for step in range(4):
            g = {n: torch.from_numpy(np.random.default_rng(step).standard_normal(s)
                                     .astype(np.float32)).bfloat16() for n, s in shapes.items()}
            tx.apply(params, {n: t.float() for n, t in g.items()} if cast else g, state)
        results.append(params)
    for n in shapes:
        assert torch.equal(results[0][n], results[1][n])


def test_lr_schedules_vs_optax():
    for name, kw in (("LinearLR", {"start_factor": 5e-4, "total_iters": 200}),
                     ("ConstantLR", {"factor": 0.25, "total_iters": 10}),
                     ("CosineAnnealingLR", {"T_max": 50, "eta_min": 1e-6})):
        want = jax_lr(2e-5, JaxLRCfg(name=name, kwargs=kw))
        got = build_lr_schedule(2e-5, LRSchedulerCfg(name, kw))
        for step in (0, 1, 9, 10, 49, 100, 200, 10_000):
            assert got(step) == pytest.approx(float(want(step)), rel=1e-6), (name, step)


# ---------------------------------------------------------------- train step

def _port_state(engine, tx, ema: bool):
    params = master_params(engine.unet)
    return TrainState(params=params, opt_state=tx.init(params),
                      ema_params={n: p.clone() for n, p in params.items()} if ema else None,
                      step=0)


def test_make_train_step_vs_jax(checkpoint):  # noqa: F811
    """Two steps of AdamW (clip 0.1, LinearLR warm-up) with EMA: each step's
    loss within 1e-5 relative, its grad norm within 1e-4, and the summed
    parameter change within 1e-3 relative L2 of the JAX step (Adam divides
    by sqrt(nu): near-zero gradient elements amplify f32 sum-order
    differences)."""
    ckpt, params = checkpoint
    lr = 1e-4
    sched = ("LinearLR", {"start_factor": 0.5, "total_iters": 2})
    jtx = jax_opt(JaxOptCfg(name="AdamW", lr=lr, kwargs={}),
                  jax_lr(lr, JaxLRCfg(name=sched[0], kwargs=sched[1])),
                  gradient_clip_val=0.1)
    jstep = jax_make_train_step(build_engine("auto"), jtx, params["vae"], V_C, donate=False)
    jstate = JaxTrainState(params=params["unet"], opt_state=jtx.init(params["unet"]),
                           ema_params=jax.tree_util.tree_map(jnp.copy, params["unet"]),
                           step=jnp.asarray(0, jnp.int32))
    engine = port_train_engine(ckpt)
    tx = build_optimizer(OptimizerCfg("AdamW", lr), build_lr_schedule(lr, LRSchedulerCfg(*sched)),
                         gradient_clip_val=0.1)
    step = make_train_step(engine, tx, V_C)
    state = _port_state(engine, tx, ema=True)
    before = {n: p.clone().numpy() for n, p in state.params.items()}
    arrays = make_arrays()
    for i in range(2):
        key = jax.random.PRNGKey(10 + i)
        jstate, jm = jstep(jstate, jax_batch(arrays), key)
        state, m = step(state, port_batch(arrays), draws_from_key(key))
        assert m["loss/diffusion"].item() == pytest.approx(float(jm["loss/diffusion"]), rel=1e-5)
        assert m["grad_norm"] == pytest.approx(float(jm["grad_norm"]), rel=1e-4)
    assert state.step == 2 and int(jstate.step) == 2
    want = grads_as_port(jstate.params)
    want_ema = grads_as_port(jstate.ema_params)
    got = {n: p.numpy() for n, p in state.params.items()}
    delta = {n: got[n] - before[n] for n in want}
    want_delta = {n: want[n] - before[n] for n in want}
    assert rel_l2(delta, want_delta) <= 1e-3
    # The EMA moves by 0.005 of that change, near the f32 rounding of the
    # weights themselves: held within one ulp (rtol 1e-6) instead.
    for n in want:
        np.testing.assert_allclose(state.ema_params[n].numpy(), want_ema[n], rtol=1e-6,
                                   atol=1e-7, err_msg=n)
    # The module computes with the masters.
    for n, p in engine.unet.named_parameters():
        assert torch.equal(p.detach(), state.params[n])


def test_ema_frozen_between_accumulation_steps(checkpoint):  # noqa: F811
    """With accumulation over 2 micro-steps, params and EMA stay put on the
    first and move on the second (the JAX gate on ``mini_step``)."""
    engine = port_train_engine(checkpoint[0])
    tx = build_optimizer(OptimizerCfg("AdamW", 1e-4), build_lr_schedule(1e-4, None),
                         gradient_clip_val=0.1, accumulate_grad_batches=2)
    step = make_train_step(engine, tx, V_C)
    state = _port_state(engine, tx, ema=True)
    p0 = {n: p.clone() for n, p in state.params.items()}
    arrays = make_arrays(b=1)
    state, _ = step(state, port_batch(arrays), draws_from_key(jax.random.PRNGKey(0), b=1))
    assert all(torch.equal(state.params[n], p0[n]) for n in p0)
    assert all(torch.equal(state.ema_params[n], p0[n]) for n in p0)
    state, _ = step(state, port_batch(arrays), draws_from_key(jax.random.PRNGKey(1), b=1))
    assert any(not torch.equal(state.params[n], p0[n]) for n in p0)
    assert any(not torch.equal(state.ema_params[n], p0[n]) for n in p0)
    assert state.step == 2


# ---------------------------------------------------------------- checkpoint

def test_checkpoint_roundtrip(tmp_path):
    mgr = CheckpointManager(tmp_path / "ckpts", save_top_k=2)
    state = {"params": {"w": torch.arange(6.0).reshape(2, 3)}, "step": 7,
             "opt_state": {"count": 3, "mu": {"w": torch.ones(2, 3, dtype=torch.bfloat16)}}}
    mgr.save(7, state)
    assert mgr.latest_step() == 7
    assert json.loads((tmp_path / "ckpts" / "latest").read_text()) == {"step": 7}
    restored = mgr.restore(7)
    assert restored["step"] == 7 and restored["opt_state"]["count"] == 3
    assert torch.equal(restored["params"]["w"], state["params"]["w"])
    assert restored["opt_state"]["mu"]["w"].dtype == torch.bfloat16


def test_checkpoint_prune_keeps_top_k(tmp_path):
    mgr = CheckpointManager(tmp_path / "ckpts", save_top_k=1)
    for step in (1, 2, 3):
        mgr.save(step, {"x": torch.tensor(step)})
    assert mgr.all_steps() == [3]
    assert mgr.latest_step() == 3


def test_torn_tmp_dir_does_not_break_resume(tmp_path):
    """An interrupted save leaves a temporary directory matching step_*:
    all_steps / latest_step skip it."""
    mgr = CheckpointManager(tmp_path / "ckpts")
    mgr.save(5, {"x": torch.tensor(5)})
    torn = tmp_path / "ckpts" / "step_000000006.tmp-123"
    torn.mkdir()
    (torn / "state.pt").write_bytes(b"torn")
    (tmp_path / "ckpts" / "step_000000007").mkdir()  # committed name, no file
    assert mgr.all_steps() == [5]
    assert mgr.latest_step() == 5
    assert mgr.restore(5)["x"].item() == 5


class BatchList:
    """A data module whose train loader yields the given batches; it
    records whether each loader it made was closed."""

    def __init__(self, batches):
        self.batches, self.loaders = batches, []

    def train_dataloader(self):
        module = self

        class Loader:
            closed = False

            def __iter__(self):
                return iter(module.batches)

            def close(self, timeout=None):
                self.closed = True

        self.loaders.append(Loader())
        return self.loaders[-1]


def test_trainer_fit_and_resume(tmp_path, checkpoint):  # noqa: F811
    """fit() logs, checkpoints and stops at task_steps; a new Trainer resumes
    from ``latest`` (module included) and ends where an unbroken run ends."""
    images, extr, intr, _ = make_arrays(b=1)
    raw = {role: {"image": images[:, s], "extrinsics": extr[:, s], "intrinsics": intr[:, s]}
           for role, s in (("context", slice(0, V_C)), ("target", slice(V_C, V)))}

    def run(run_dir, task_steps, resume):
        engine = port_train_engine(checkpoint[0])
        tx = build_optimizer(OptimizerCfg("AdamW", 1e-4, {"mu_dtype": "bfloat16"}),
                             build_lr_schedule(1e-4, None), gradient_clip_val=0.1)
        trainer = Trainer(engine, tx, BatchList([raw] * 5), run_dir, max_steps=3,
                          num_context_views=V_C, checkpoint_every=2, log_every=1,
                          use_ema=True, task_steps=task_steps)
        state = trainer.init_state()
        if resume:
            state = trainer.maybe_restore(state)
        return trainer, trainer.fit(state, seed=4), engine

    trainer, state, _ = run(tmp_path / "a", 2, resume=False)
    assert state.step == 2 and trainer.ckpt.all_steps() == [2]
    lines = [json.loads(line) for line in trainer.metrics_log.read_text().splitlines()]
    assert [r["step"] for r in lines] == [1, 2]
    assert all(np.isfinite(r["loss/diffusion"]) and r["steps_per_sec"] > 0 for r in lines)
    trainer, resumed, engine = run(tmp_path / "a", None, resume=True)
    assert resumed.step == 3 and trainer.ckpt.all_steps() == [3]
    _, unbroken, _ = run(tmp_path / "b", None, resume=False)
    for n, p in unbroken.params.items():
        torch.testing.assert_close(resumed.params[n], p, rtol=0, atol=0)
        torch.testing.assert_close(resumed.ema_params[n], unbroken.ema_params[n], rtol=0, atol=0)
    named = dict(engine.unet.named_parameters())
    assert all(torch.equal(named[n].detach(), p) for n, p in resumed.params.items())
