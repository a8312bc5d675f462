"""The port's checkpoint layout: the JAX tree round trip and the flagship
key set against the released checkpoint's manifest."""

import json
import re
from pathlib import Path

import numpy as np
import torch

from mvldm_tpu.utils.weight_convert import convert_mvldm_checkpoint
from mvldm_tpu_torch.builder import MVLDM, flagship_model_cfg
from mvldm_tpu_torch.utils.weight_convert import jax_to_torch_state_dict

from tests.test_torch_goldens import BACKBONE, VAE_CFG, checkpoint  # noqa: F401
from tests.test_torch_port_models import IGNORED, load_port_model, port_model_cfg

MANIFEST = Path(__file__).resolve().parent.parent / "assets" / "mvldm_1.0_manifest.json"


def test_jax_tree_round_trip(checkpoint):  # noqa: F811
    """jax_to_torch_state_dict inverts convert_mvldm_checkpoint on every key
    the live model uses (the up-block SD attentions are dropped by design)."""
    ckpt, _ = checkpoint
    params = convert_mvldm_checkpoint(
        ckpt,
        layers_per_block=BACKBONE.layers_per_block,
        down_block_types=BACKBONE.down_block_types,
        up_block_types=BACKBONE.up_block_types,
        vae_layers_per_block=VAE_CFG.layers_per_block,
    )
    back = jax_to_torch_state_dict(params)
    expected = {k: v for k, v in ckpt.items() if not IGNORED.match(k)}
    assert sorted(back) == sorted(expected)
    for k, v in expected.items():
        assert back[k].shape == v.shape, k
        np.testing.assert_array_equal(back[k].numpy(), v.numpy(), err_msg=k)


def test_round_trip_loads_into_port(checkpoint):  # noqa: F811
    """The converted-back dict loads strictly and reproduces the weights."""
    ckpt, params = checkpoint
    model = load_port_model(ckpt)
    fresh = MVLDM(port_model_cfg())
    fresh.load_state_dict(jax_to_torch_state_dict(params), strict=True)
    for (k, a), (_, b) in zip(sorted(model.state_dict().items()),
                              sorted(fresh.state_dict().items())):
        assert torch.equal(a, b), k


def test_flagship_keys_match_manifest():
    """Built on the meta device (no allocation): the flagship state dict has
    exactly the released checkpoint's required keys and shapes."""
    manifest = json.loads(MANIFEST.read_text())
    with torch.device("meta"):
        model = MVLDM(flagship_model_cfg())
    got = {k: list(v.shape) for k, v in model.state_dict().items()}
    assert got == manifest["required"]
    ignored = re.compile(r"^denoiser\.unet\.up_blocks\.\d+\.attentions\.")
    assert all(ignored.match(k) for k in manifest["ignored"])
    assert not any(ignored.match(k) for k in got)
