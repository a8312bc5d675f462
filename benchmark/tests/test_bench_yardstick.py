"""The yardstick does not move: the published parameter spec of each
configuration and the model FLOPs that ``mfu.video`` and ``mfu.train``
divide by, at every launch shape the cells use, read on the meta device
and pinned here as the benchmark first counted them."""

import hashlib
import json

import pytest
import torch

from benchmark import check, traffic, weights
from benchmark.flops import Counter
from benchmark.reference import reference_of
from conftest import ROOT

ST3D, STANDARD = "mvldm-sd21-st3d", "mvldm-sd21-standard"
# (parameters, elements, sha256 of the sorted (name, shape) list)
SPEC = {
    ST3D: (934, 1_009_583_787, "60cd9e52f1ef0efeef359bbd18ea00b895fc11d1068a6983eb6a15f04b64c075"),
    STANDARD: (799, 862_011_307, "ed99aee39cfbfb18eff26e29aff108bd2ae7d9ccd6712a96bd4c86bfe19595b5"),
}
# Counter.unet(b, v, 32): one forward over b rows of v views of 32 x 32 latents.
UNET = {
    ST3D: {
        (1, 5): 904_403_353_600,
        (1, 4): 711_259_586_560,
        (16, 5): 14_470_453_657_600,
        (16, 3): 8_387_957_882_880,
        (8, 5): 7_235_226_828_800,
        (8, 3): 4_193_978_941_440,
        (2, 5): 1_808_806_707_200,
        (2, 3): 1_048_494_735_360,
        (1, 3): 524_247_367_680,
    },
    STANDARD: {
        (1, 5): 775_828_275_200,
        (1, 4): 608_399_523_840,
        (16, 5): 12_413_252_403_200,
        (16, 3): 7_153_637_130_240,
        (8, 5): 6_206_626_201_600,
        (8, 3): 3_576_818_565_120,
        (2, 5): 1_551_656_550_400,
        (2, 3): 894_204_641_280,
        (1, 3): 447_102_320_640,
    },
}
# Counter.launch(b, v_c, v_t, 256, 25): a sampling launch of b rows.
LAUNCH = {
    ST3D: {
        (1, 1, 4): 43_153_044_799_488,
        (16, 2, 3): 610_052_387_373_056,
        (8, 2, 3): 305_026_193_686_528,
        (2, 2, 3): 76_256_548_421_632,
        (1, 2, 3): 38_128_274_210_816,
    },
    STANDARD: {
        (1, 1, 4): 37_367_166_271_488,
        (16, 2, 3): 527_764_337_197_056,
        (8, 2, 3): 263_882_168_598_528,
        (2, 2, 3): 65_970_542_149_632,
        (1, 2, 3): 32_985_271_074_816,
    },
}
TRAIN_STEP = 24_460_900_761_600  # Counter.train_step(6, 5, 256)
UNET_BACKWARD = 16_279_235_788_800  # Counter.unet(6, 5, 32, True)
# The configuration each launch's cell runs on.
CELLS = {"st3d.video80": ST3D, "standard.video80": STANDARD, "st3d.nvs4": ST3D}


def config_of(name):
    return json.loads((ROOT / "benchmark" / "configs" / f"{name}.json").read_text())


@pytest.fixture(scope="module")
def counters():
    return {name: Counter(config_of(name)) for name in (ST3D, STANDARD)}


@pytest.mark.parametrize("name", [ST3D, STANDARD])
def test_the_parameter_spec_is_pinned(name):
    config = config_of(name)
    with torch.device("meta"):
        spec = weights.spec(reference_of(config).Model(config["model"]).named_parameters())
    digest = hashlib.sha256(json.dumps(sorted(spec.items())).encode()).hexdigest()
    assert (len(spec), sum(torch.Size(s).numel() for s in spec.values()), digest) == SPEC[name]


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_the_pinned_launches_are_the_cells_launches(cell):
    mix = traffic.load(cell.split(".")[1])
    sizes = [mix["targets"]] if mix["kind"] == "scenes" else mix["targets"]
    shapes = {(len(launch.rows), len(launch.context[0]), len(launch.rows[0]))
              for n_t in sizes for launch in check.plan_of(mix, n_t)}
    assert shapes <= set(LAUNCH[CELLS[cell]])
    assert mix["hw"] == 256 and config_of(CELLS[cell])["model"]["scheduler"][
        "num_inference_steps"] == 25


@pytest.mark.parametrize("name,shape", [(n, s) for n in UNET for s in UNET[n]])
def test_the_unet_count_is_pinned(counters, name, shape):
    assert counters[name].unet(*shape, 32) == UNET[name][shape]


@pytest.mark.parametrize("name,shape", [(n, s) for n in LAUNCH for s in LAUNCH[n]])
def test_the_launch_count_is_pinned(counters, name, shape):
    assert counters[name].launch(*shape, 256, 25) == LAUNCH[name][shape]


def test_the_train_step_count_is_pinned(counters):
    assert counters[ST3D].unet(6, 5, 32, True) == UNET_BACKWARD
    assert counters[ST3D].train_step(6, 5, 256) == TRAIN_STEP
