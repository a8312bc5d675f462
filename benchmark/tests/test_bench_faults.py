"""A whole run on the CPU at the ``tiny`` experiment, past the look for a
card: a sound run comes out correct, and each fault a cell can have,
planted under the timed path, comes out not correct. So does the control
(the reference in fp8 in the program's place)."""

import json

import pytest
import torch

from benchmark import control, harness
from conftest import SEED, tiny_config, tiny_mix

# Limits at this size: float32 against float32 reads 1e-2 levels, 1e-7 and
# 1e-5 here; the faults and the control read 10 levels and 1e-2 or more.
LIMITS = {"frame_rms": 1.0, "loss_rel": 1e-3, "grad_leaf": 1e-2, "change_leaf": 1e-2}
CELLS = {"st3d.video80": "video80", "st3d.nvs4": "nvs4", "st3d.train_b6": "train_b6"}


def run(cell, **hooks):
    line, lines = harness.run_cell(cell, SEED, 0.5, False, device="cpu", config=tiny_config(),
                                   mix=tiny_mix(CELLS[cell]), limits=LIMITS, **hooks)
    out = json.loads(line)
    assert list(out)[:5] == list(harness.KEYS)
    assert list(out)[-1] == "checks" and lines[-1].startswith("check ")
    return out


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_a_sound_run_is_correct(cell):
    out = run(cell)
    assert out["correct"], out["checks"]
    assert out["attempted"] >= 1 and out["failed"] == 0
    assert "setup_s" in out["metrics"]


def alter_a_frame(system):
    engine = system.engine
    decode = engine.decode_latents

    def altered(latents):
        images = decode(latents).clone()
        images[0, 0] = 1.0 - images[0, 0]
        return images

    engine.decode_latents = altered


@pytest.mark.parametrize("cell", ["st3d.video80", "st3d.nvs4"])
def test_a_frame_altered_where_it_is_made_is_caught(cell):
    assert not run(cell, system_hook=alter_a_frame)["correct"]


def test_a_step_that_leaves_its_state_unchanged_is_caught(monkeypatch):
    from mvldm_tpu_torch.training.optim import Optimizer

    monkeypatch.setattr(Optimizer, "apply", lambda self, *args, **kwargs: False)
    out = run("st3d.train_b6")
    assert not out["correct"]
    assert out["checks"]["grad_leaf"]["value"] >= 0.99


def half_the_batch(system):
    from mvldm_tpu_torch.diffusion.engine import Batch, TrainDraws

    engine = system.engine
    loss = engine.training_loss

    def half(batch, num_context_views, draws=None, *args, **kwargs):
        n = batch.extrinsics.shape[0] // 2
        batch = Batch(batch.images[:n], batch.extrinsics[:n], batch.intrinsics[:n],
                      batch.is_target[:n])
        draws = TrainDraws(**{k: getattr(draws, k)[:n] for k in draws.__dataclass_fields__})
        return loss(batch, num_context_views, draws, *args, **kwargs)

    engine.training_loss = half


def test_half_the_batch_left_out_is_caught():
    assert not run("st3d.train_b6", system_hook=half_the_batch)["correct"]


@pytest.mark.parametrize("traffic_name", ["video80", "nvs4"])
def test_the_control_fails_the_sampling_check(traffic_name):
    readings = control.readings(tiny_config(), tiny_mix(traffic_name), SEED, "cpu")
    assert readings["frame_rms"] > LIMITS["frame_rms"]


@pytest.mark.parametrize("traffic_name", ["video80", "nvs4"])
def test_a_sampling_cell_has_no_half_batch(traffic_name):
    with pytest.raises(ValueError, match="no planted fault"):
        control.readings(tiny_config(), tiny_mix(traffic_name), SEED, "cpu", "half_batch")


@pytest.mark.parametrize("fault", ["fp8", "half_batch"])
def test_the_control_and_the_half_batch_fail_the_training_check(fault):
    readings = control.readings(tiny_config(), tiny_mix("train_b6"), SEED, "cpu", fault)
    assert any(readings[k] > LIMITS[k] for k in readings), readings


@pytest.mark.cuda
def test_the_cli_refuses_a_machine_without_the_card():
    """Without the CUDA devices a cell asks for: a non-zero exit and no
    result line."""
    import subprocess
    import sys

    from conftest import ROOT

    if torch.cuda.is_available():
        pytest.skip("a card is present: this checks the refusal without one")
    proc = subprocess.run([sys.executable, str(ROOT / "benchmark" / "run.py"), "--workload",
                           "st3d.video80", "--seed", "1", "--seconds", "1", "--trace", "0"],
                          capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert proc.returncode != 0 and proc.stdout.strip() == ""
