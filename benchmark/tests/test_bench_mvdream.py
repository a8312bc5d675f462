"""MVDream's configuration and its text-to-multiview cell: the published
parameter spec and the FLOP counts the cell's ``mfu.t2mv`` divides by are
pinned as first counted; a whole run on the CPU at a tiny width is correct,
and the fp8 control and the per-frame attn1 fault are not."""

import copy
import hashlib
import json

import pytest
import torch

from benchmark import control, harness, traffic, weights
from benchmark.flops import Counter
from benchmark.reference import reference_of
from conftest import ROOT, SEED

NAME, CELL = "mvdream-sd21-4view", "mvdream.t2mv_b4"
# (parameters, elements, sha256 of the sorted (name, shape) list)
SPEC = (938, 951_226_027, "87e44fbe551825d23cd9b20f2ba7983e4b9f270ca90a8e52cd0a6db1cfcc4f29")
UNET_8_4_32 = 6_435_502_817_280  # Counter.unet(8, 4, 32): one batched-CFG step of 4 prompts x 4 views
DECODE_16_256 = 9_954_996_518_912  # Counter.decode(16, 256): a dispatch's 16 frames
LIMITS = {"frame_rms": 1.0}  # float32 against float32 reads ~1e-2 levels here


def config():
    return json.loads((ROOT / "benchmark" / "configs" / f"{NAME}.json").read_text())


def tiny_config():
    """The configuration at a tiny width (32 / 64 channels, one res block,
    16-wide heads, 32-wide text tokens; the ``tiny`` experiment's VAE), 3
    steps, float32."""
    from mvldm_tpu_torch.config import compose

    cfg = config()
    d = cfg["model"]["denoiser"]
    d.update(model_channels=32, channel_mult=[1, 2], attention_resolutions=[1, 2],
             num_res_blocks=1, num_head_channels=16, context_dim=32)
    cfg["model"]["autoencoder"]["kwargs"].update(
        compose(["+experiment=tiny"])["model"]["autoencoder"]["kwargs"])
    cfg["model"]["scheduler"]["num_inference_steps"] = 3
    cfg["dtype"] = "float32"
    return cfg


def tiny_mix():
    mix = copy.deepcopy(traffic.load("t2mv_b4"))
    mix.update(prompts=2, hw=64)
    return mix


def test_the_parameter_spec_is_pinned():
    cfg = config()
    with torch.device("meta"):
        spec = weights.spec(reference_of(cfg).Model(cfg["model"]).named_parameters())
    digest = hashlib.sha256(json.dumps(sorted(spec.items())).encode()).hexdigest()
    assert (len(spec), sum(torch.Size(s).numel() for s in spec.values()), digest) == SPEC


def test_the_flop_counts_are_pinned():
    counter = Counter(config())
    assert (counter.unet(8, 4, 32), counter.decode(16, 256)) == (UNET_8_4_32, DECODE_16_256)


def run(**hooks):
    line, lines = harness.run_cell(CELL, SEED, 0.5, False, device="cpu", config=tiny_config(),
                                   mix=tiny_mix(), limits=LIMITS, **hooks)
    out = json.loads(line)
    assert list(out)[:5] == list(harness.KEYS) and lines[-1].startswith("check ")
    return out


def test_a_sound_run_is_correct():
    out = run()
    assert out["correct"], out["checks"]
    assert out["attempted"] >= 1 and out["failed"] == 0
    assert set(out["metrics"]) == {"frames_per_s", "peak_mem_gib", "setup_s"}


def test_a_frame_altered_where_it_is_made_is_caught():
    def alter(system):
        decode = system.engine.decode_latents

        def altered(latents):
            images = decode(latents).clone()
            images[0, 0] = 1.0 - images[0, 0]
            return images

        system.engine.decode_latents = altered

    assert not run(system_hook=alter)["correct"]


@pytest.mark.parametrize("fault", ["fp8", "per_frame_attn1"])
def test_the_control_and_the_per_frame_fault_fail_the_check(fault):
    readings = control.readings(tiny_config(), tiny_mix(), SEED, "cpu", fault)
    assert readings["frame_rms"] > LIMITS["frame_rms"], readings


def test_a_t2mv_cell_has_no_half_batch():
    with pytest.raises(ValueError, match="no planted fault"):
        control.readings(tiny_config(), tiny_mix(), SEED, "cpu", "half_batch")
