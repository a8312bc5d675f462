"""The port's config system and builder against the JAX package's: composed
dicts of the shared ``configs/`` tree, typed ``RootCfg`` trees field by
field, the engine ``+experiment=baseline`` builds (on the meta device)
against ``build_flagship``'s model, and a reference-keyed ``.ckpt`` loaded
by both packages' ``load_pretrained``."""

import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mvldm_tpu import builder as jax_builder
from mvldm_tpu import config as jax_config
from mvldm_tpu.models.unet import UNetBackboneCfg as JaxBackbone
from mvldm_tpu.models.vae import AutoencoderKLCfg as JaxVAECfg
from mvldm_tpu_torch import builder, config
from mvldm_tpu_torch.diffusion.schedulers import (
    DDIMScheduler,
    DDIMSchedulerKwargs,
    DDPMScheduler,
)
from mvldm_tpu_torch.models.standard_transformer import StandardTransformer

from tests.test_torch_goldens import IN_CH, OUT_CH, synth_cross_view_sd, synth_vae_sd
from tests.test_weight_convert import synth_unet_sd

REPO = Path(__file__).resolve().parent.parent
EXPERIMENTS = sorted(p.stem for p in (REPO / "configs" / "experiment").glob("*.yaml"))
EVALUATIONS = sorted(p.stem for p in (REPO / "configs" / "evaluation").glob("*.yaml"))

# The override sets of tests/test_e2e.py and tests/test_generate_script.py.
E2E_TRAIN = ["+experiment=tiny", "mode=train", "dataset.root=/data", "output_dir=/run",
             "trainer.max_steps=2", "data_loader.train.batch_size=2",
             "checkpointing.every_n_train_steps=2", "trainer.accumulate_grad_batches=1",
             "trainer.val_check_interval=2", "data_loader.val.batch_size=1",
             "trainer.strategy=single_device", "dataset.image_shape=[32,32]"]
E2E_TEST = ["+experiment=tiny", "mode=test", "dataset.root=/data", "output_dir=/run",
            "test.sampling_mode=anchored", "test.limit_frames=8",
            "trainer.limit_test_batches=1",
            "dataset.view_sampler.max_distance_between_context_views=10"]
GENERATE = ["+experiment=tiny", "dataset.root=/data", "output_dir=/gen",
            "scene_id=scenetest0001", "test.sampling_mode=autoregressive",
            "test.limit_frames=6", "trainer.limit_test_batches=1",
            "dataset.view_sampler.max_distance_between_context_views=8",
            "dataset.image_shape=[32,32]", "mode=test"]
OVERRIDE_SETS = (
    [[], E2E_TRAIN, E2E_TEST, GENERATE]
    + [[f"+experiment={e}"] for e in EXPERIMENTS]
    + [["+experiment=baseline", "+experiment=tpu_fast"],
       ["+experiment=baseline", "model/scheduler=ddpm",
        "model.scheduler.num_inference_steps=10"],
       ["+experiment=baseline", "model/denoiser/multi_view_attention=standard",
        "model.denoiser.multi_view_attention.downscale=2"],
       ["+experiment=tiny", "dataset=re10k_non_iter", "test.ar_latent_feedthrough=true",
        "seed=3", "test.scene_batch=2"]])


def _ids(sets):
    return [" ".join(s)[:60] or "defaults" for s in sets]


@pytest.mark.parametrize("overrides", OVERRIDE_SETS, ids=_ids(OVERRIDE_SETS))
def test_compose_and_typed_config_match_jax(overrides):
    ours, theirs = config.compose(overrides), jax_config.compose(overrides)
    assert ours == theirs
    typed, jax_typed = config.load_typed_root_config(ours), jax_config.load_typed_root_config(
        theirs)
    assert dataclasses.asdict(typed) == dataclasses.asdict(jax_typed)

    def classes(a, b, path):
        assert type(a).__name__ == type(b).__name__, path
        if dataclasses.is_dataclass(a):
            for f in dataclasses.fields(a):
                classes(getattr(a, f.name), getattr(b, f.name), f"{path}.{f.name}")

    classes(typed, jax_typed, "root")


@pytest.mark.parametrize("evaluation", EVALUATIONS)
def test_evaluation_groups_compose_like_jax(evaluation):
    """The metrics configs compose the same; neither RootCfg types them."""
    overrides = ["+experiment=baseline", f"+evaluation={evaluation}"]
    ours = config.compose(overrides)
    assert ours == jax_config.compose(overrides)
    with pytest.raises(ValueError, match="unknown keys"):
        config.load_typed_root_config(ours)


def test_unknown_and_bad_keys_refused():
    with pytest.raises(ValueError, match="unknown keys"):
        config.load_typed_root_config(config.compose(["+experiment=tiny", "test.nope=1"]))
    with pytest.raises(ValueError, match="not in"):
        config.load_typed_root_config(config.compose(["mode=serve"]))
    config.set_cfg({"a": 1})
    assert config.get_cfg() == {"a": 1}


@pytest.mark.parametrize("precision,dtype", [
    (None, torch.float32), ("32", torch.float32), ("bf16-mixed", torch.bfloat16),
    ("16-mixed", torch.bfloat16), ("64", torch.float64)])
def test_resolve_dtype(precision, dtype):
    assert builder.resolve_dtype(precision) == dtype
    assert jnp.dtype(jax_builder.resolve_dtype(precision)).name == \
        str(dtype).removeprefix("torch.")


def test_baseline_engine_is_the_flagship():
    """``+experiment=baseline`` builds the flagship's module tree and
    parameter shapes, in bf16, with its scheduler table and CFG."""
    cfg = config.load_typed_root_config(config.compose(["+experiment=baseline"]))
    engine = builder.build_engine(cfg, "meta")
    with torch.device("meta"):
        flagship = builder.MVLDM(builder.flagship_model_cfg())
    ours = {**{f"denoiser.{k}": v for k, v in engine.unet.named_parameters()},
            **{f"autoencoder.{k}": v for k, v in engine.vae.named_parameters()}}
    theirs = dict(flagship.named_parameters())
    assert sorted(ours) == sorted(theirs)
    assert all(ours[k].shape == theirs[k].shape for k in ours)
    assert [type(m).__name__ for m in engine.unet.modules()] == \
        [type(m).__name__ for m in flagship.denoiser.modules()]
    assert engine.dtype == torch.bfloat16 and engine.device.type == "meta"
    # The flagship's scheduler but for its step count (25; the config's 70).
    flagship_sched = DDIMScheduler.create(DDIMSchedulerKwargs(clip_sample=False),
                                          num_inference_steps=70)
    for field in dataclasses.fields(DDIMScheduler):
        a, b = getattr(engine.scheduler, field.name), getattr(flagship_sched, field.name)
        assert torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b, field.name
    for field in ("use_cfg", "cfg_scale", "use_ray_encoding", "srt_ray_encoding", "use_plucker"):
        assert getattr(engine.cfg, field) == getattr(builder.flagship_model_cfg(), field)


@pytest.mark.parametrize("overrides,kind", [
    (["model/scheduler=ddpm", "model.scheduler.num_inference_steps=10"], DDPMScheduler),
    (["model/denoiser/multi_view_attention=standard"], StandardTransformer)])
def test_group_overrides_reach_the_engine(overrides, kind):
    cfg = config.load_typed_root_config(config.compose(["+experiment=baseline", *overrides]))
    engine = builder.build_engine(cfg, "meta")
    if kind is DDPMScheduler:
        assert isinstance(engine.scheduler, DDPMScheduler)
        assert engine.scheduler.timesteps().tolist() == list(range(900, -1, -100))
    else:
        assert isinstance(engine.unet.cross_attn_blocks_encoder[0], StandardTransformer)


# The default (SD2.1) block layout at tiny widths: the JAX load_pretrained
# converts with the default topology, four stages of two layers.
CKPT_OVERRIDES = [
    "+experiment=tiny", "dataset.image_shape=[64,64]",
    "model.denoiser.autoencoder.down_block_types=[CrossAttnDownBlock2D,CrossAttnDownBlock2D,"
    "CrossAttnDownBlock2D,DownBlock2D]",
    "model.denoiser.autoencoder.up_block_types=[UpBlock2D,CrossAttnUpBlock2D,"
    "CrossAttnUpBlock2D,CrossAttnUpBlock2D]",
    "model.denoiser.autoencoder.block_out_channels=[32,32,32,32]",
    "model.denoiser.autoencoder.layers_per_block=2",
    "model.denoiser.autoencoder.num_attention_heads=[2,2,2,2]",
    "model.autoencoder.kwargs.layers_per_block=2",
]


def write_reference_ckpt(path: Path) -> None:
    backbone = JaxBackbone(block_out_channels=(32, 32, 32, 32), num_attention_heads=(2, 2, 2, 2),
                           cross_attention_dim=16, norm_num_groups=8)
    vae = JaxVAECfg(block_out_channels=(8, 8, 16, 16), layers_per_block=2, norm_num_groups=4)
    torch.manual_seed(11)
    sd = {f"denoiser.unet.{k}": v for k, v in synth_unet_sd(backbone, IN_CH, OUT_CH).items()}
    for group, count in (("encoder", 4), ("mid", 1), ("decoder", 4)):
        for i in range(count):
            sd.update(synth_cross_view_sd(f"denoiser.cross_attn_blocks_{group}.{i}", 32))
    sd.update({f"autoencoder.{k}": v for k, v in synth_vae_sd(vae).items()})
    torch.save({"state_dict": sd, "global_step": 7}, path)


def test_reference_ckpt_loads_like_jax(tmp_path):
    path = tmp_path / "reference.ckpt"
    write_reference_ckpt(path)
    overrides = CKPT_OVERRIDES + [f"checkpointing.load={path}"]
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 3, 8, 8, IN_CH)).astype(np.float32)
    t = np.array([[0, 500, 500], [0, 20, 900]])
    mask = np.array([[True, True, True], [False, True, True]])

    jax_cfg = jax_config.load_typed_root_config(jax_config.compose(overrides))
    jax_engine = jax_builder.build_engine(jax_cfg)
    unet_params, _ = jax_builder.load_pretrained(jax_cfg, jax_engine, jax.random.PRNGKey(0))
    apply = jax.jit(lambda p, x, t, m: jax_engine.unet.apply({"params": p}, x, t, view_mask=m))
    ref = np.asarray(apply(unet_params, jnp.asarray(x), jnp.asarray(t), jnp.asarray(mask)))

    cfg = config.load_typed_root_config(config.compose(overrides))
    engine = builder.build_engine(cfg, "cpu")
    builder.load_pretrained(cfg, engine)
    with torch.no_grad():
        got = engine.unet(torch.from_numpy(x), torch.from_numpy(t),
                          view_mask=torch.from_numpy(mask)).numpy()
    assert np.abs(ref).mean() > 1e-2
    np.testing.assert_allclose(got, ref, rtol=2e-5, atol=2e-5)
    # Every weight came from the file: the seed no longer matters.
    other = builder.build_engine(dataclasses.replace(cfg, seed=5), "cpu")
    builder.load_pretrained(cfg, other)
    for (name, a), (_, b) in zip(engine.unet.state_dict().items(),
                                 other.unet.state_dict().items()):
        assert torch.equal(a, b), name


def test_init_params_is_seeded():
    cfg = config.load_typed_root_config(config.compose(["+experiment=tiny"]))
    a, b = builder.build_engine(cfg, "cpu"), builder.build_engine(cfg, "cpu")
    c = builder.build_engine(dataclasses.replace(cfg, seed=1), "cpu")
    sa, sb, sc = (e.unet.state_dict() for e in (a, b, c))
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert not torch.equal(sa["unet.conv_in.weight"], sc["unet.conv_in.weight"])
