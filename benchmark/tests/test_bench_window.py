"""The measured window of a scenes cell holds exactly the scenes it
counts: none is dispatched after the window's time has passed, and the
scene in flight then is gathered and counted inside it."""

import time

import torch

from benchmark import check, program, weights
from benchmark.kinds import scenes
from benchmark.reference.model import Model
from conftest import SEED, tiny_config, tiny_mix


def test_the_scene_window_counts_every_scene_it_dispatches():
    config, mix = tiny_config(), tiny_mix("video80")
    with torch.device("meta"):
        shapes = weights.spec(Model(config["model"]).named_parameters())
    system = program.System(config, shapes, SEED, "cpu")
    launches = []
    sample = system.engine.sample_latents

    def counted(*args, **kwargs):
        launches.append(time.perf_counter())
        return sample(*args, **kwargs)

    system.engine.sample_latents = counted
    seconds = 0.2
    run = scenes.drive(system, mix, config, shapes, SEED, seconds, False, time.perf_counter())
    per_scene = len(check.plan_of(mix, mix["targets"]))
    assert run.attempted == len(run.items) >= 1
    # The warm-up scene, then every scene the window dispatched, and no more.
    assert len(launches) == (1 + run.attempted) * per_scene
    assert len(run.work) == run.attempted * per_scene
    assert run.done == run.attempted * mix["targets"]
    assert run.e2e["frames_per_s"] == run.done / run.window_s
