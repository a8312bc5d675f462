"""The port's ``trainer.remat_policy`` against the JAX UNet's, fp32 on CPU.

The JAX ``MultiViewUNet`` refuses an unknown ``remat_policy``
(``tests/test_models.py``); the port refuses it when the UNet is built, from
the config through ``build_engine`` as from the constructor. Under
``"dots"`` (JAX's ``dots_with_no_batch_dims_saveable``) the port keeps only
the outputs of ``aten.mm`` / ``aten.addmm`` and recomputes the rest: the
loss and UNet gradients equal no remat's within 1e-6, and the saved
tensors lie between full remat's and no remat's.
"""

import pytest
import torch
from torch.utils.checkpoint import CheckpointPolicy

from mvldm_tpu_torch import builder, config
from mvldm_tpu_torch.models import unet as port_unet

from tests.test_torch_goldens import checkpoint  # noqa: F401  (module-scoped fixture)
from tests.test_torch_port_training import (
    V_C,
    draws_from_key,
    make_arrays,
    port_batch,
    port_grads,
    port_train_engine,
    rel_l2,
)


def test_unknown_remat_policy_raises_when_built():
    cfg = builder.flagship_model_cfg()
    with pytest.raises(ValueError, match="remat_policy"):
        with torch.device("meta"):
            port_unet.MultiViewUNet(cfg.denoiser, remat=True, remat_policy="nope")
    with torch.device("meta"):
        unet = port_unet.MultiViewUNet(cfg.denoiser, remat_policy="dots")
    with pytest.raises(ValueError, match="remat_policy"):
        unet.remat_policy = "nope"
    assert unet.remat_policy == "dots"


@pytest.mark.parametrize("policy", [None, "dots", "nope"])
def test_build_engine_threads_the_policy(policy):
    cfg = config.load_typed_root_config(config.compose(
        ["+experiment=baseline", "trainer.remat=true", f"trainer.remat_policy={policy or 'null'}"]))
    assert cfg.trainer.remat_policy == policy
    if policy == "nope":
        with pytest.raises(ValueError, match="remat_policy"):
            builder.build_engine(cfg, "meta")
        return
    engine = builder.build_engine(cfg, "meta")
    assert engine.unet.remat and engine.unet.remat_policy == policy


def _loss_and_grads(ckpt, remat, policy, saved=None):
    import jax

    engine = port_train_engine(ckpt, remat=remat)
    engine.unet.remat_policy = policy
    draws = draws_from_key(jax.random.PRNGKey(33))

    def pack(t):
        saved.append(t.numel())
        return t

    hooks = (torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t)
             if saved is not None else None)
    if hooks is not None:
        with hooks:
            loss, _ = engine.training_loss(port_batch(make_arrays()), V_C, draws)
    else:
        loss, _ = engine.training_loss(port_batch(make_arrays()), V_C, draws)
    loss.backward()
    return loss.item(), port_grads(engine)


def test_dots_matches_no_remat(checkpoint):  # noqa: F811
    """Loss within 1e-7 relative and UNet gradients within 1e-6 relative L2
    of no remat (the recompute runs the same ops on the same inputs)."""
    want_loss, want = _loss_and_grads(checkpoint[0], False, None)
    loss, got = _loss_and_grads(checkpoint[0], True, "dots")
    assert loss == pytest.approx(want_loss, rel=1e-7)
    assert rel_l2(got, want) <= 1e-6


def test_dots_saves_only_2d_products(checkpoint):  # noqa: F811
    """Under "dots" the policy keeps exactly the mm / addmm outputs of the
    blocks' forward (a convolution is recomputed): the elements held for
    the backward, full remat's plus those outputs, lie strictly between
    full remat's and no remat's. Tensors a checkpointed region keeps do not
    pass the outer saved-tensor hooks, so its products are counted from
    the policy's calls."""
    held = {}
    for name, remat in (("none", False), ("full", True)):
        saved = []
        _loss_and_grads(checkpoint[0], remat, None, saved)
        held[name] = sum(saved)

    seen, kept_elements = [], []
    real = port_unet._dots_policy

    def spy(ctx, op, *args, **kwargs):
        decision = real(ctx, op, *args, **kwargs)
        seen.append((str(op), decision))
        if decision == CheckpointPolicy.MUST_SAVE and not ctx.is_recompute:
            a, b = args[-2:]  # mm(a, b), addmm(bias, a, b)
            kept_elements.append(a.shape[0] * b.shape[1])
        return decision

    port_unet._dots_policy = spy
    try:
        loss, got = _loss_and_grads(checkpoint[0], True, "dots")
    finally:
        port_unet._dots_policy = real
    kept = {op for op, d in seen if d == CheckpointPolicy.MUST_SAVE}
    assert kept == {"aten.mm.default", "aten.addmm.default"}, kept
    assert any(op == "aten.convolution.default" and d == CheckpointPolicy.PREFER_RECOMPUTE
               for op, d in seen)
    dots = held["full"] + sum(kept_elements)
    assert held["full"] < dots < held["none"], (held, dots)
