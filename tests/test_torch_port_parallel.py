"""The port's multi-rank training (``mvldm_tpu_torch/parallel/``,
``training/strategy.py``) against the JAX package, f32 on the CPU.

* the bootstrap: nothing without variables, a partial triplet raises, the
  ``MVLDM_DISTRIBUTED`` parse (``tests/test_distributed.py``'s cases);
* the sharding rules: per leaf, the port's ZeRO-1 / FSDP axis and its
  tensor-parallel leaves equal the JAX ``zero1_shardings`` /
  ``tensor_parallel_shardings`` on the same tiny parameters, the names and
  layouts mapped through ``utils/weight_convert``;
* two gloo ranks (``tests/torch_port_ranks.py``, started under a time
  limit): ``head_sharded_attention``, the joint cross-view attention as
  ``data_model`` runs it, against the JAX unsharded ``SelfAttention``;
  one training step under each strategy (``data_model`` as 1 x 2, the
  others 2 x 1) against the JAX single-device ``make_train_step`` on the
  two ranks' batches concatenated, with the JAX draws injected; a
  checkpoint written by a sharded run restored on one rank.

Tiny topology of ``tests/test_torch_goldens.py`` (cross-view heads 4).
Tolerances are stated at each comparison.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mvldm_tpu.config import LRSchedulerCfg as JaxLRCfg
from mvldm_tpu.config import OptimizerCfg as JaxOptCfg
from mvldm_tpu.models.mv_attention import SelfAttention as JaxSelfAttention
from mvldm_tpu.parallel import mesh as jax_mesh
from mvldm_tpu.training.optim import build_lr_schedule as jax_lr
from mvldm_tpu.training.optim import build_optimizer as jax_opt
from mvldm_tpu.training.trainer import TrainState as JaxTrainState
from mvldm_tpu.training.trainer import make_train_step as jax_make_train_step
from mvldm_tpu_torch.parallel import mesh as port_mesh
from mvldm_tpu_torch.parallel.distributed import maybe_initialize_distributed
from mvldm_tpu_torch.training.checkpoint import CheckpointManager
from mvldm_tpu_torch.training.optim import LRSchedulerCfg, OptimizerCfg
from mvldm_tpu_torch.training import build_lr_schedule, build_optimizer
from mvldm_tpu_torch.training.strategy import step_seed
from mvldm_tpu_torch.training.trainer import TrainState, load_params, make_train_step
from mvldm_tpu_torch.utils.weight_convert import jax_to_torch_state_dict

from tests.test_sampling_goldens import build_engine
from tests.test_torch_goldens import checkpoint  # noqa: F401  (module-scoped fixture)
from tests.test_torch_port_models import IGNORED, port_model_cfg
from tests.test_torch_port_training import (
    LOSS_SEED,
    V_C,
    draws_from_key,
    grads_as_port,
    jax_batch,
    make_arrays,
    port_batch,
    port_train_engine,
    rel_l2,
)
from tests.torch_port_ranks import Ranks

LR, CLIP = 1e-4, 0.1
SCHED = ("LinearLR", {"start_factor": 0.5, "total_iters": 2})
STRATEGIES = {  # name -> (num_data, num_model)
    "data_parallel": (2, 1),
    "data_parallel_zero1": (2, 1),
    "data_parallel_fsdp": (2, 1),
    "data_model": (1, 2),
}
CKPT_STRATEGIES = ("data_parallel_fsdp", "data_model")
# Adafactor under the plans that store slices: whole leaves (strategy.py).
ADAFACTOR_STRATEGIES = ("data_parallel_fsdp", "data_model")


# ----------------------------------------------------------------- bootstrap

class TestMaybeInitializeDistributed:
    def test_noop_without_env(self):
        assert maybe_initialize_distributed(env={}, device="cpu") is False

    def test_partial_triplet_raises(self):
        with pytest.raises(ValueError, match="Partial multi-host"):
            maybe_initialize_distributed(env={"MVLDM_COORDINATOR": "host0:8476"},
                                         device="cpu")
        with pytest.raises(ValueError, match="Partial multi-host"):
            maybe_initialize_distributed(
                env={"MVLDM_NUM_PROCESSES": "4", "MVLDM_PROCESS_ID": "0"}, device="cpu")

    def test_env_flag_shapes(self):
        for value in ("0", "no", "", "false"):
            assert maybe_initialize_distributed(env={"MVLDM_DISTRIBUTED": value},
                                                device="cpu") is False
        assert not torch.distributed.is_initialized()


def test_make_mesh_needs_the_whole_world():
    """One process is a world of 1: a 1 x 1 grid, and any other refused, as
    the JAX ``make_mesh`` refuses a grid of more devices than it sees."""
    mesh = port_mesh.make_mesh()
    assert (mesh.num_data, mesh.num_model, mesh.data_rank, mesh.model_rank) == (1, 1, 0, 0)
    with pytest.raises(ValueError, match="2\\(data\\) x 1\\(model\\)"):
        port_mesh.make_mesh(2, 1)
    with pytest.raises(ValueError, match="0\\(data\\) x 2\\(model\\)"):
        port_mesh.make_mesh(num_model=2)


def test_step_seed():
    """Data rank 0 draws what one card draws; other data ranks differ."""
    assert step_seed(3, 7) == step_seed(3, 7, 0) == (3 << 32) + 7
    seeds = {step_seed(3, 7, r) for r in range(4)}
    assert len(seeds) == 4 and all(0 <= s < 2 ** 64 for s in seeds)


# ------------------------------------------------------------- shard rules

def _axes_as_port(tree, spec_tree, axis_name: str) -> dict:
    """{port UNet parameter name: torch axis split over ``axis_name``, or
    None}: each JAX leaf becomes an array that counts along its split axis
    (zeros when replicated) and goes through the port's weight converter,
    whose transposes carry the axis along."""
    def marker(leaf, sharding):
        spec = tuple(sharding.spec) + (None,) * (leaf.ndim - len(sharding.spec))
        if axis_name not in spec:
            return np.zeros(leaf.shape, np.float32)
        a = spec.index(axis_name)
        shape = [1] * leaf.ndim
        shape[a] = leaf.shape[a]
        return np.broadcast_to(np.arange(leaf.shape[a], dtype=np.float32).reshape(shape),
                               leaf.shape).copy()

    marked = jax.tree_util.tree_map(marker, tree, spec_tree)
    out = {}
    for k, v in jax_to_torch_state_dict({"unet": marked}).items():
        if IGNORED.match(k):
            continue
        varying = [t for t in range(v.ndim) if v.shape[t] > 1
                   and not torch.equal(v, v.narrow(t, 0, 1).expand_as(v))]
        assert len(varying) <= 1, k
        out[k[len("denoiser."):]] = varying[0] if varying else None
    return out


def _port_shapes(params) -> dict:
    sd = jax_to_torch_state_dict({"unet": params})
    return {k[len("denoiser."):]: tuple(v.shape) for k, v in sd.items() if not IGNORED.match(k)}


@pytest.mark.parametrize("n", [2, 4, 8])
def test_zero1_and_fsdp_axes_equal_jax(checkpoint, n):  # noqa: F811
    """Every leaf is split along the same logical dimension as the JAX rule
    picks (ties included), or replicated where it is."""
    params = checkpoint[1]["unet"]
    mesh = jax_mesh.make_mesh(num_data=n, devices=jax.devices()[:n])
    want = _axes_as_port(params, jax_mesh.zero1_shardings(mesh, params), "data")
    got = port_mesh.zero1_shardings(_port_shapes(params), n)
    assert got == want
    assert port_mesh.fsdp_shardings(_port_shapes(params), n) == want
    assert any(a is not None for a in got.values())


@pytest.mark.parametrize("num_model", [2, 4])
def test_tensor_parallel_leaves_equal_jax(checkpoint, num_model):  # noqa: F811
    params = checkpoint[1]["unet"]
    mesh = jax_mesh.make_mesh(num_data=1, num_model=num_model,
                              devices=jax.devices()[:num_model])
    want = _axes_as_port(params, jax_mesh.tensor_parallel_shardings(mesh, params), "model")
    got = port_mesh.tensor_parallel_shardings(_port_shapes(params), num_model)
    assert got == want
    split = {k: a for k, a in got.items() if a is not None}
    # to_q / to_k / to_v by heads (torch axis 0), to_out by its inputs (axis 1),
    # in the attn1 of each cross-view block; nothing else.
    assert split and all("cross_attn_blocks" in k and ".attn1." in k for k in split)
    assert {a for k, a in split.items() if "to_out" in k} == {1}
    assert {a for k, a in split.items() if "to_out" not in k} == {0}


# ------------------------------------------------------------- two ranks

ATTN = dict(c=32, heads=4, head_dim=8)


def _attention_inputs():
    """The JAX ``SelfAttention`` (the joint cross-view attention) of the
    tiny cross-view width, its parameters, and (b, l, c) tokens, a (b, l)
    key bias and an output cotangent."""
    rng = np.random.default_rng(5)
    b, l, c = 2, 24, ATTN["c"]
    x, g = (rng.normal(size=(b, l, c)).astype(np.float32) for _ in range(2))
    bias = np.where(rng.uniform(size=(b, l)) < 0.25, -1e30, 0.0).astype(np.float32)
    bias[:, 0] = 0.0
    module = JaxSelfAttention(num_heads=ATTN["heads"], head_dim=ATTN["head_dim"])
    params = module.init(jax.random.PRNGKey(3), jnp.asarray(x))
    return module, params, x, bias, g


def _port_attention_weights(params) -> dict:
    """The JAX parameters as ``CrossAttention``'s state dict: (in, out)
    kernels transposed to (out, in)."""
    p = params["params"]
    sd = {f"{k}.weight": np.asarray(p[k]["kernel"]).T for k in ("to_q", "to_k", "to_v")}
    sd["to_out.0.weight"] = np.asarray(p["to_out"]["kernel"]).T
    sd["to_out.0.bias"] = np.asarray(p["to_out"]["bias"])
    return sd


def _draws():
    return [draws_from_key(jax.random.PRNGKey(LOSS_SEED + i)) for i in range(2)]


@pytest.fixture(scope="module")
def ranks_dir(tmp_path_factory):
    return tmp_path_factory.mktemp("ranks")


@pytest.fixture(scope="module")
def started(checkpoint, ranks_dir):  # noqa: F811
    """The two ranks, started before the JAX reference is computed so the
    two overlap; every job in one launch."""
    ckpt, _ = checkpoint
    model = {"cfg": port_model_cfg(), "sd": {k: v for k, v in ckpt.items()
                                             if not IGNORED.match(k)}}
    _, params, x, bias, g = _attention_inputs()
    jobs = [dict(name="attention", kind="attention", world=2, x=x, bias=bias, g=g,
                 sd=_port_attention_weights(params), **ATTN)]
    draws = [{f.name: getattr(d, f.name) for f in dataclasses.fields(d)} for d in _draws()]
    for name, (nd, nm) in STRATEGIES.items():
        ck = name in CKPT_STRATEGIES
        jobs.append(dict(name=name, kind="step", model=model, strategy=name, num_data=nd,
                         num_model=nm, opt=("AdamW", LR), sched=SCHED, clip=CLIP, v_c=V_C,
                         arrays=make_arrays(), draws=draws if ck else draws[:1],
                         ckpt=str(ranks_dir / name) if ck else None))
    for name in ADAFACTOR_STRATEGIES:
        nd, nm = STRATEGIES[name]
        jobs.append(dict(name=f"adafactor_{name}", kind="step", model=model, strategy=name,
                         num_data=nd, num_model=nm, opt=("Adafactor", LR), sched=SCHED,
                         clip=CLIP, v_c=V_C, arrays=make_arrays(), draws=draws[:1]))
    proc = Ranks(jobs, ranks_dir / "out", timeout=420)
    yield proc
    proc.kill()


@pytest.fixture(scope="module")
def jax_step(checkpoint, started):  # noqa: F811
    """The JAX single-device step on the whole batch (2 examples): loss,
    gradient, grad norm, masters, EMA and first moment after it."""
    _, params = checkpoint
    arrays = make_arrays()
    engine = build_engine("auto")
    key = jax.random.PRNGKey(LOSS_SEED)
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p: engine.training_loss(p, params["vae"], jax_batch(arrays), key, V_C)[0]))(
        params["unet"])
    jtx = jax_opt(JaxOptCfg(name="AdamW", lr=LR, kwargs={}),
                  jax_lr(LR, JaxLRCfg(name=SCHED[0], kwargs=SCHED[1])), gradient_clip_val=CLIP)
    jstep = jax_make_train_step(engine, jtx, params["vae"], V_C, donate=False)
    jstate = JaxTrainState(params=params["unet"], opt_state=jtx.init(params["unet"]),
                           ema_params=jax.tree_util.tree_map(jnp.copy, params["unet"]),
                           step=jnp.asarray(0, jnp.int32))
    jstate, jm = jstep(jstate, jax_batch(arrays), key)
    mu = jstate.opt_state[1][0].mu  # chain(clip, adamw): adamw's ScaleByAdamState
    atx = jax_opt(JaxOptCfg(name="Adafactor", lr=LR, kwargs={}),
                  jax_lr(LR, JaxLRCfg(name=SCHED[0], kwargs=SCHED[1])), gradient_clip_val=CLIP)
    astate = JaxTrainState(params=params["unet"], opt_state=atx.init(params["unet"]),
                           ema_params=None, step=jnp.asarray(0, jnp.int32))
    astate, am = jax_make_train_step(engine, atx, params["vae"], V_C, donate=False)(
        astate, jax_batch(arrays), key)
    return {"adafactor_masters": grads_as_port(astate.params),
            "adafactor_grad_norm": float(am["grad_norm"]),
            "loss": float(loss), "grads": grads_as_port(grads),
            "grad_norm": float(jm["grad_norm"]), "step_loss": float(jm["loss/diffusion"]),
            "masters": grads_as_port(jstate.params), "ema": grads_as_port(jstate.ema_params),
            "mu": grads_as_port(mu), "before": grads_as_port(params["unet"])}


@pytest.fixture(scope="module")
def ranks(started, jax_step):
    """Both ranks' results of every job."""
    return started.results()


def test_head_sharded_attention_vs_jax(ranks):
    """``head_sharded_attention``, the joint cross-view attention as
    ``data_model`` runs it (2 heads a rank, the Megatron pair), within 2e-5
    of the JAX unsharded ``SelfAttention`` on both ranks; the gradients
    (through jax.vjp of it) within 1e-4: the input's on each rank, each
    weight's summed over the ranks (each rank's rows or columns), the
    output bias's on each rank."""
    module, params, x, bias, g = _attention_inputs()
    want, vjp = jax.vjp(lambda p, x_: module.apply(p, x_, key_bias=jnp.asarray(bias)),
                        params, jnp.asarray(x))
    dparams, dx = vjp(jnp.asarray(g))
    dw = _port_attention_weights(dparams)
    for r in ranks:
        got = r["attention"]
        np.testing.assert_allclose(got["out"].numpy(), np.asarray(want), rtol=2e-5, atol=2e-5)
        np.testing.assert_allclose(got["dx"].numpy(), np.asarray(dx), rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(got["d_to_out.0.bias"].numpy(), dw["to_out.0.bias"],
                                   rtol=1e-4, atol=1e-4)
    for k in ("to_q.weight", "to_k.weight", "to_v.weight", "to_out.0.weight"):
        parts = [r["attention"][f"d_{k}"].numpy() for r in ranks]
        np.testing.assert_allclose(sum(parts), dw[k], rtol=1e-4, atol=1e-4, err_msg=k)
        # each rank's gradient lies on its own heads' rows (columns of to_out)
        axis = 1 if k.startswith("to_out") else 0
        half = parts[0].shape[axis] // 2
        for r, part in enumerate(parts):
            other = np.take(part, range((1 - r) * half, (2 - r) * half), axis=axis)
            assert not other.any(), k


@pytest.mark.parametrize("strategy", list(STRATEGIES))
def test_step_vs_jax_on_the_concatenated_batch(ranks, jax_step, strategy):
    """One step on two ranks against the JAX step on the whole batch: the
    loss and the grad norm within 1e-4 relative, the summed gradient within
    1e-4 relative L2, the updated masters and EMA within 1e-4 relative L2
    of their change and the first moment within 1e-4 relative L2; both
    ranks hold the same whole state and compute with it."""
    for r in ranks:
        got = r[strategy]
        assert got["loss0"] == pytest.approx(jax_step["loss"], rel=1e-4)
        assert got["loss0"] == pytest.approx(jax_step["step_loss"], rel=1e-4)
        assert got["grad_norm0"] == pytest.approx(jax_step["grad_norm"], rel=1e-4)
        assert rel_l2({n: t.numpy() for n, t in got["grads"].items()}, jax_step["grads"]) <= 1e-4
        before = jax_step["before"]
        want = jax_step["masters"]
        delta = {n: got["masters"][n].numpy() - before[n] for n in want}
        assert rel_l2(delta, {n: want[n] - before[n] for n in want}) <= 1e-4
        # The EMA moves by 0.005 of that change, near the f32 rounding of the
        # weights: held within one ulp (rtol 1e-6), as the one-card test does.
        for n, w in jax_step["ema"].items():
            np.testing.assert_allclose(got["ema"][n].numpy(), w, rtol=1e-6, atol=1e-7,
                                       err_msg=n)
        assert rel_l2({n: t.numpy() for n, t in got["mu"].items()}, jax_step["mu"]) <= 1e-4
        assert got["module_is_masters"]
    a, b = (r[strategy]["final"] for r in ranks)
    assert all(torch.equal(a[n], b[n]) for n in a)
    # The plans split what they say: nothing for data_parallel.
    assert bool(ranks[0][strategy]["sliced"]) == (strategy != "data_parallel")


@pytest.mark.parametrize("strategy", CKPT_STRATEGIES)
def test_sharded_checkpoint_restores_on_one_rank(ranks, ranks_dir, checkpoint,  # noqa: F811
                                                 strategy):
    """The whole state saved after step 1 of a sharded run, restored by one
    process with no process group, takes step 2 to the masters the sharded
    run reached (within 1e-5 relative L2 of the step's change: only the
    summation order differs)."""
    saved = CheckpointManager(ranks_dir / strategy).restore(1)
    engine = port_train_engine(checkpoint[0])
    state = TrainState(**saved)
    load_params(engine.unet, state.params)
    tx = build_optimizer(OptimizerCfg("AdamW", LR), build_lr_schedule(LR, LRSchedulerCfg(*SCHED)),
                         gradient_clip_val=CLIP)
    before = {n: p.clone() for n, p in state.params.items()}
    state, _ = make_train_step(engine, tx, V_C)(state, port_batch(make_arrays()),
                                                _draws()[1])
    assert state.step == 2 and state.opt_state["count"] == 2
    want = ranks[0][strategy]["final"]
    delta = {n: (state.params[n] - before[n]).numpy() for n in want}
    assert rel_l2(delta, {n: (want[n] - before[n]).numpy() for n in want}) <= 1e-5


@pytest.fixture(scope="module")
def one_card_adafactor(checkpoint):  # noqa: F811
    """The port's one-card Adafactor step on the whole batch and draws: its
    gradient and grad norm."""
    engine = port_train_engine(checkpoint[0])
    tx = _adafactor()
    params = {n: p.detach().clone() for n, p in engine.unet.named_parameters()}
    seen = {}
    apply = tx.apply

    def recording_apply(params_, grads, opt_state, noise=None, **callbacks):
        seen.update({n: g.float().numpy().copy() for n, g in grads.items()})
        return apply(params_, grads, opt_state, noise, **callbacks)

    tx.apply = recording_apply
    state = TrainState(params=params, opt_state=tx.init(params), ema_params=None, step=0)
    _, m = make_train_step(engine, tx, V_C)(state, port_batch(make_arrays()), _draws()[0])
    return seen, float(m["grad_norm"])


def _adafactor():
    return build_optimizer(OptimizerCfg("Adafactor", LR),
                           build_lr_schedule(LR, LRSchedulerCfg(*SCHED)), gradient_clip_val=CLIP)


@pytest.mark.parametrize("strategy", ADAFACTOR_STRATEGIES)
def test_adafactor_on_whole_leaves(ranks, jax_step, one_card_adafactor, strategy):
    """Adafactor under a plan that stores slices updates whole leaves. The
    gradient it is given within 1e-4 relative L2 of the port's one-card
    step's on the whole batch, and the grad norm within 1e-4 of that
    step's and of JAX's. The masters' change within 1e-6 relative L2 of
    one card's Adafactor apply on that same gradient (the plan's own
    error): at step 1 Adafactor's update of an unfactored leaf is about
    sign(g) times a constant, so gradient elements near zero, whose sign
    the f32 summation order sets, make the change of two steps on
    different summation orders differ by 1e-3 relative L2 and more. Within
    5e-3 of the JAX Adafactor step's change."""
    before = jax_step["before"]
    one_grads, one_norm = one_card_adafactor
    for r in ranks:
        got = r[f"adafactor_{strategy}"]
        assert got["grad_norm0"] == pytest.approx(one_norm, rel=1e-4)
        assert got["grad_norm0"] == pytest.approx(jax_step["adafactor_grad_norm"], rel=1e-4)
        grads = {n: g.float() for n, g in got["grads"].items()}
        assert rel_l2({n: g.numpy() for n, g in grads.items()}, one_grads) <= 1e-4
        tx = _adafactor()
        params = {n: torch.from_numpy(before[n].copy()) for n in before}
        assert tx.apply(params, grads, tx.init(params))
        delta = {n: got["masters"][n].numpy() - before[n] for n in before}
        assert rel_l2(delta, {n: params[n].numpy() - before[n] for n in before}) <= 1e-6
        want = jax_step["adafactor_masters"]
        assert rel_l2(delta, {n: want[n] - before[n] for n in before}) <= 5e-3
        assert got["module_is_masters"]
