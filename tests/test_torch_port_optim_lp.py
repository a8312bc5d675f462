"""The stochastic-rounding AdamW (``nu_dtype``), ``freeze.denoiser`` and
``optimizer.scale_lr`` of the port against the JAX package, on the CPU.

* ``adamw_lp``: three updates of the port's optimizer built from the same
  config as ``mvldm_tpu.training.optim.build_optimizer`` (AdamW with bf16
  ``mu_dtype`` and ``nu_dtype``), with the JAX package's own rounding bits
  (``jax.random.bits`` of its per-(step, leaf) keys) injected: mu and nu
  bitwise equal, parameters within 1e-6 (the bias corrections are powers
  computed by numpy here and XLA there);
* the port's own rounding draws are unbiased;
* a frozen denoiser keeps its masters bitwise;
* the effective learning rate of ``optimizer.scale_lr``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mvldm_tpu.config import OptimizerCfg as JaxOptCfg
from mvldm_tpu.training.optim import build_lr_schedule as jax_lr
from mvldm_tpu.training.optim import build_optimizer as jax_opt
from mvldm_tpu.training.optim import ScaleByAdamLPState
from mvldm_tpu.training.optim import stochastic_round as jax_stochastic_round
from mvldm_tpu_torch import config
from mvldm_tpu_torch.scripts import main as main_script
from mvldm_tpu_torch.training import build_lr_schedule, build_optimizer
from mvldm_tpu_torch.training.optim import (
    OptimizerCfg,
    SetToZero,
    rounding_noise,
    stochastic_round,
)

SHAPES = {"a": (16, 8), "b": (8,), "c": (3, 3, 4, 4)}


def jax_rounding_bits(count: int, leaf: int, shape):
    """The (mu, nu) bits ``scale_by_adam_lp`` draws for ``leaf`` at update
    ``count`` (``mvldm_tpu/training/optim.py:86-88, :103``), as int32."""
    base = jax.random.fold_in(jax.random.PRNGKey(0x5EED), count)
    keys = jax.random.split(jax.random.fold_in(base, leaf))
    return tuple(torch.from_numpy(np.asarray(
        jax.random.bits(k, shape, jnp.uint32) & jnp.uint32(0xFFFF)).astype(np.int32))
        for k in keys)


def lp_state(state):
    """The ``ScaleByAdamLPState`` inside the optax chain's nested tuples."""
    if isinstance(state, ScaleByAdamLPState):
        return state
    found = [s for s in map(lp_state, state if isinstance(state, tuple) else ()) if s]
    return found[0] if found else None


@pytest.mark.parametrize("mu_dtype", ["bfloat16", None])
def test_adamw_lp_vs_jax_bitwise_moments(mu_dtype):
    kwargs = {"nu_dtype": "bfloat16", "weight_decay": 0.05}
    if mu_dtype:
        kwargs["mu_dtype"] = mu_dtype
    lr = 1e-3
    tx = jax_opt(JaxOptCfg(name="AdamW", lr=lr, kwargs=dict(kwargs)), jax_lr(lr, None))
    port = build_optimizer(OptimizerCfg("AdamW", lr, dict(kwargs)), build_lr_schedule(lr, None))
    rng = np.random.default_rng(0)
    params = {n: rng.standard_normal(s).astype(np.float32) for n, s in SHAPES.items()}
    jparams = {n: jnp.asarray(p) for n, p in params.items()}
    tparams = {n: torch.from_numpy(p.copy()) for n, p in params.items()}
    jstate, tstate = tx.init(jparams), port.init(tparams)
    for step in range(3):
        grads = {n: rng.standard_normal(s).astype(np.float32) * 10.0 ** -step
                 for n, s in SHAPES.items()}
        updates, jstate = tx.update({n: jnp.asarray(g) for n, g in grads.items()}, jstate,
                                    jparams)
        jparams = jax.tree_util.tree_map(lambda p, u: p + u, jparams, updates)
        noise = {n: jax_rounding_bits(step + 1, i, SHAPES[n]) for i, n in enumerate(sorted(SHAPES))}
        assert port.apply(tparams, {n: torch.from_numpy(g) for n, g in grads.items()}, tstate,
                          noise=noise)
        lp = lp_state(jstate)
        for n in SHAPES:
            for moment in ("mu", "nu"):
                got = tstate[moment][n]
                want = np.asarray(getattr(lp, moment)[n])
                assert str(got.dtype).endswith(str(want.dtype)), (moment, got.dtype, want.dtype)
                np.testing.assert_array_equal(got.float().numpy(), want.astype(np.float32),
                                              err_msg=f"step {step} {moment} {n}")
            np.testing.assert_allclose(tparams[n].numpy(), np.asarray(jparams[n]), rtol=1e-6,
                                       atol=1e-7, err_msg=f"step {step} {n}")
    assert tstate["nu"]["a"].dtype == torch.bfloat16
    assert tstate["mu"]["a"].dtype == (torch.bfloat16 if mu_dtype else torch.float32)


def test_stochastic_round_matches_jax_bits():
    """The same f32 values and bits round to the same bf16 values,
    negative numbers, exact bf16 values and the carry into the exponent
    included."""
    x = np.concatenate([np.random.default_rng(1).standard_normal(500).astype(np.float32) * 3,
                        np.array([1.0, -1.0, 0.0, 1.9999999, -3.4e38], np.float32)])
    key = jax.random.PRNGKey(7)
    want = np.asarray(jax_stochastic_round(jnp.asarray(x), jnp.bfloat16, key)).astype(np.float32)
    bits = np.asarray(jax.random.bits(key, x.shape, jnp.uint32) & jnp.uint32(0xFFFF))
    got = stochastic_round(torch.from_numpy(x), torch.from_numpy(bits.astype(np.int32)))
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), want)


def test_port_rounding_is_unbiased():
    """Rounding one value 2^18 times with the port's own draws: the mean
    lies within 5 standard errors of the value, where round-to-nearest
    would miss it by the full offset (about 0.3 of a bf16 step)."""
    x = torch.full((1 << 18,), 1.0 + 0.3 * 2.0 ** -7)
    mu_bits, nu_bits = rounding_noise(x.shape, x.device, count=1, leaf=0)
    assert not torch.equal(mu_bits, nu_bits)
    assert int(mu_bits.min()) >= 0 and int(mu_bits.max()) < 1 << 16
    for bits in (mu_bits, nu_bits):
        r = stochastic_round(x, bits).double()
        assert set(r.unique().tolist()) == {1.0, 1.0 + 2.0 ** -7}
        se = r.std().item() / len(r) ** 0.5
        assert abs(r.mean().item() - x[0].item()) < 5 * se
    assert abs(x.bfloat16().double()[0].item() - x[0].item()) > 0.25 * 2.0 ** -7
    again = rounding_noise(x.shape, x.device, count=1, leaf=0)
    assert torch.equal(again[0], mu_bits)
    assert not torch.equal(rounding_noise(x.shape, x.device, count=2, leaf=0)[0], mu_bits)


def test_adamw_lp_draws_its_own_noise_reproducibly():
    """Without injected noise the rounding is the seeded per-(step, leaf)
    draw: two runs agree bitwise, and a chunked update draws the same."""
    from mvldm_tpu_torch.training import optim as port_optim

    def run(chunk):
        old = port_optim.CHUNK_ELEMENTS
        port_optim.CHUNK_ELEMENTS = chunk
        try:
            tx = build_optimizer(OptimizerCfg("AdamW", 1e-3, {"mu_dtype": "bfloat16",
                                                               "nu_dtype": "bfloat16"}),
                                 build_lr_schedule(1e-3, None), gradient_clip_val=0.1,
                                 accumulate_grad_batches=2)
            params = {n: torch.ones(s) for n, s in SHAPES.items()}
            state = tx.init(params)
            for step in range(4):
                g = {n: torch.from_numpy(np.random.default_rng(step).standard_normal(s)
                                         .astype(np.float32)) for n, s in SHAPES.items()}
                tx.apply(params, g, state)
            return params, state
        finally:
            port_optim.CHUNK_ELEMENTS = old

    (p1, s1), (p2, s2) = run(1 << 25), run(100)
    assert s1["count"] == 2
    for n in SHAPES:
        assert torch.equal(p1[n], p2[n])
        assert torch.equal(s1["nu"][n], s2["nu"][n]) and torch.equal(s1["mu"][n], s2["mu"][n])
        assert s1["nu"][n].dtype == torch.bfloat16


def test_freeze_denoiser_keeps_the_masters():
    """``optax.set_to_zero``: every step applies, no state, no change."""
    tx = SetToZero()
    params = {n: torch.randn(s) for n, s in SHAPES.items()}
    before = {n: p.clone() for n, p in params.items()}
    state = tx.init(params)
    assert state == {}
    for _ in range(3):
        assert tx.apply(params, {n: torch.randn(s) for n, s in SHAPES.items()}, state)
    assert all(torch.equal(params[n], before[n]) for n in SHAPES)


@pytest.mark.parametrize("overrides", [
    [], ["optimizer.scale_lr=true"],
    ["optimizer.scale_lr=true", "trainer.accumulate_grad_batches=3",
     "data_loader.train.batch_size=5"]])
def test_scale_lr_is_the_jax_formula(overrides):
    """``mvldm_tpu/scripts/main.py:60-68`` with one device."""
    cfg = config.load_typed_root_config(config.compose(["+experiment=baseline", *overrides]))
    want = cfg.optimizer.lr
    if cfg.optimizer.scale_lr:
        want = want * (cfg.trainer.accumulate_grad_batches * 1
                       * cfg.data_loader.train.batch_size)
    assert main_script.base_lr(cfg) == want
    assert cfg.optimizer.scale_lr == bool(overrides)
