"""The readers of the program's own registry (``host_syncs.*``,
``sampler_host_ms.*``): nothing to read gives None; a profiled scene of the
program gives its syncs and its sampler's own host time a frame."""

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from benchmark import harness, program, traffic, weights
from benchmark.reference.model import Model
from conftest import SEED, tiny_config, tiny_mix

METRICS = ["host_syncs.video", "host_syncs.nvs", "host_syncs.train",
           "sampler_host_ms.video", "sampler_host_ms.nvs"]


@pytest.fixture
def registry():
    from mvldm_tpu_torch.utils import profiling

    profiling.reset()
    yield profiling
    profiling.reset()


@pytest.mark.parametrize("metric", METRICS)
def test_nothing_recorded_reads_none(metric, registry):
    read = harness.load_reader(metric)
    assert read({"kind": "none", "window_s": 0.0, "flops": 0.0, "profiled": {}}) is None
    # A profiled part, but the program recorded nothing.
    assert read({"profiled": {"done": 8, "busy_s": 1.0}}) is None


def test_a_profiled_scene_reads_its_syncs_and_host_time_a_frame(registry):
    config, mix = tiny_config(), tiny_mix("video80")
    with torch.device("meta"):
        shapes = weights.spec(Model(config["model"]).named_parameters())
    system = program.System(config, shapes, SEED, "cpu")
    _, dispatch, gen = program.sampler(system, mix, SEED)
    views = traffic.make_scene(mix["targets"], mix["hw"], mix["path"], traffic.rng(SEED, 0))
    from mvldm_tpu_torch.diffusion.video_sampling import VideoSampler

    with profile(activities=[ProfilerActivity.CPU]):
        VideoSampler.gather_many(dispatch([program.scene_views(views)], gen), 1)
    frames = mix["targets"]
    ctx = {"profiled": {"done": frames, "busy_s": 1.0}}
    recorded = registry.snapshot()
    # 8 frames: the anchor window and 2 fill launches. The context upload;
    # each launch's poses, intrinsics (a fill's context index too), the
    # reference pose's index, the poses' and the rays' inverse, and its
    # gather.
    syncs = 1 + (2 + 3) + 2 * (3 + 3) + 3
    assert sum(recorded["counters"].values()) == syncs
    for metric in ("host_syncs.video", "host_syncs.nvs"):
        assert harness.load_reader(metric)(ctx) == syncs / frames
    own = sum(s["self_ms"] for n, s in recorded["spans"].items() if n.startswith("sampler."))
    assert 0 < own < recorded["spans"]["sampler.dispatch"]["total_ms"]
    for metric in ("sampler_host_ms.video", "sampler_host_ms.nvs"):
        assert harness.load_reader(metric)(ctx) == pytest.approx(own / frames)
