"""The program's spans and host-sync counters (``utils/profiling.py``) on
the CPU at the ``tiny`` experiment.

* with no profiler running a span enters no ``record_function`` and the
  registry stays empty;
* under ``torch.profiler`` a dispatch's spans nest on the trace (each
  denoise step inside its launch) and the registry counts them;
* a span's self time is its duration less its children's;
* the ``sync.*`` counts of a scene, a request and a micro-step are those
  their launch plans call for;
* tracing changes no frame and no trained value;
* ``stop_trace`` writes a Chrome trace that holds the program's ranges.
"""

import json
import threading
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from mvldm_tpu_torch import builder, config
from mvldm_tpu_torch.diffusion.engine import Batch, TrainDraws
from mvldm_tpu_torch.diffusion.video_sampling import SceneViews, VideoSampler
from mvldm_tpu_torch.training import build_lr_schedule, build_optimizer, make_train_step
from mvldm_tpu_torch.training.optim import OptimizerCfg
from mvldm_tpu_torch.training.trainer import TrainState, master_params
from mvldm_tpu_torch.utils import profiling

HW = 32
STEPS = 4  # the tiny experiment's sampling steps


def tiny_engine():
    cfg = config.load_typed_root_config(config.compose(["+experiment=tiny"]))
    assert cfg.model.scheduler.num_inference_steps == STEPS
    return builder.build_engine(cfg, "cpu")


@pytest.fixture(scope="module")
def engine():
    return tiny_engine()


@pytest.fixture(autouse=True)
def _empty_registry():
    profiling.reset()
    yield
    profiling.reset()


def scene(n_target: int, seed: int = 0):
    rng = np.random.default_rng(seed)
    n = n_target + 1
    images = rng.uniform(size=(n, HW, HW, 3)).astype(np.float32)
    extr = np.repeat(np.eye(4, dtype=np.float32)[None], n, axis=0)
    extr[:, 0, 3] = np.linspace(0, 1, n)
    intr = np.repeat(np.eye(3, dtype=np.float32)[None], n, axis=0)
    intr[:, 0, 2] = intr[:, 1, 2] = 0.5
    ids = np.arange(n)
    return (SceneViews(images[:1], extr[:1], intr[:1], ids[:1]),
            SceneViews(images[1:], extr[1:], intr[1:], ids[1:]))


def anchored_scene(engine):
    """8 targets, 4 anchor columns, fills of at most 2 groups: the anchor
    window (anchors 2, 4, 6), then fill groups [0, 1, 3], [5], [7] in
    launches of 2 groups and 1."""
    sampler = VideoSampler(engine, num_anchors_views=4, max_parallel_groups=2)
    pending = sampler.dispatch_anchored_many([scene(8)], torch.Generator().manual_seed(0))
    assert len(pending) == 3
    return VideoSampler.gather_many(pending, 1)[0]


def request(engine):
    """1 context and 2 targets: one autoregressive window padded to 4."""
    sampler = VideoSampler(engine, num_anchors_views=4)
    pending = sampler.dispatch_autoregressive_many([scene(2, seed=1)],
                                                   torch.Generator().manual_seed(1))
    assert len(pending) == 1
    return VideoSampler.gather_many(pending, 1)[0]


def micro_step(engine):
    """One applying micro-step at batch 2 (2 context + 3 target views),
    clipped, as ``make_train_step`` runs it; returns the state."""
    engine.vae.requires_grad_(False)
    tx = build_optimizer(OptimizerCfg("AdamW", 1e-3), build_lr_schedule(1e-3, None),
                         gradient_clip_val=0.1)
    params = master_params(engine.unet)
    state = TrainState(params=params, opt_state=tx.init(params), ema_params=None, step=0)
    b, v = 2, 5
    rng = np.random.default_rng(2)
    extr = torch.eye(4).repeat(b, v, 1, 1)
    extr[:, :, 0, 3] = torch.linspace(0, 1, v)
    intr = torch.eye(3).repeat(b, v, 1, 1)
    intr[:, :, 0, 2] = intr[:, :, 1, 2] = 0.5
    batch = Batch(images=torch.from_numpy(rng.uniform(size=(b, v, HW, HW, 3)).astype(np.float32)),
                  extrinsics=extr, intrinsics=intr,
                  is_target=torch.tensor([[False, False, True, True, True]] * b))
    draws = TrainDraws.draw(b, v, 2, (HW // 8, HW // 8, 4),
                            engine.scheduler.num_train_timesteps, torch.Generator().manual_seed(2))
    state, _ = make_train_step(engine, tx, num_context_views=2)(state, batch, draws)
    return state


def traced(fn, *args):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn(*args)
    return out, prof


def test_spans_are_off_without_a_profiler(engine, monkeypatch):
    entered = []

    class Counted(torch.autograd.profiler.record_function):
        def __enter__(self):
            entered.append(self.name)
            return super().__enter__()

    monkeypatch.setattr(torch.autograd.profiler, "record_function", Counted)
    request(engine)
    assert entered == []
    assert profiling.snapshot() == {"spans": {}, "counters": {}}
    traced(request, engine)
    assert "sampler.dispatch" in entered[0] and len(entered) > 20
    assert profiling.snapshot()["counters"]


def test_a_dispatch_nests_its_spans_on_the_trace(engine):
    _, prof = traced(anchored_scene, engine)

    def ranges(name):
        return [(e.start_thread_id(), e.start_ns(), e.start_ns() + e.duration_ns())
                for e in prof.profiler.kineto_results.events() if e.name() == name]

    launches = ranges("mvldm/sampler.launch")
    steps = ranges("mvldm/engine.denoise_step")
    assert len(launches) == 3 and len(steps) == STEPS * 3
    for thread, start, end in steps:
        assert any(t == thread and s <= start and end <= e for t, s, e in launches)
    spans = profiling.snapshot()["spans"]
    assert spans["engine.denoise_step"]["count"] == STEPS * 3
    assert spans["sampler.launch"]["count"] == 3
    assert spans["sampler.dispatch"]["count"] == spans["sampler.gather"]["count"] == 1
    # Batched CFG at these row counts: one UNet call a step.
    assert spans["engine.unet"]["count"] == STEPS * 3


def test_self_time_is_duration_less_children():
    def leaf(name, seconds):
        with profiling.span(name):
            time.sleep(seconds)

    with profile(activities=[ProfilerActivity.CPU]):
        with profiling.span("outer"):
            time.sleep(0.01)
            leaf("first", 0.02)
            with profiling.span("middle"):
                leaf("second", 0.01)
            # A span on another thread is no child of this one.
            worker = threading.Thread(target=leaf, args=("elsewhere", 0.03))
            worker.start()
            worker.join()
    spans = profiling.snapshot()["spans"]
    outer, middle = spans["outer"], spans["middle"]
    for leaf_name in ("first", "second"):
        assert spans[leaf_name]["self_ms"] == spans[leaf_name]["total_ms"]
    assert middle["self_ms"] == pytest.approx(middle["total_ms"] - spans["second"]["total_ms"],
                                              rel=1e-9, abs=1e-9)
    assert outer["self_ms"] == pytest.approx(
        outer["total_ms"] - middle["total_ms"] - spans["first"]["total_ms"], rel=1e-9)
    # The other thread's 30 ms stays in the outer span's self time.
    assert outer["self_ms"] >= 40


def test_self_time_sums_exactly():
    """Self times of nested spans add up to the outermost span's total."""
    with profile(activities=[ProfilerActivity.CPU]):
        with profiling.span("a"):
            with profiling.span("b"):
                with profiling.span("c"):
                    torch.ones(8).sum()
            with profiling.sync("d"):
                torch.ones(8).sum()
    spans = profiling.snapshot()["spans"]
    assert sum(spans[k]["self_ms"] for k in "bc") + spans["sync.d"]["self_ms"] + \
        spans["a"]["self_ms"] == pytest.approx(spans["a"]["total_ms"], rel=1e-9)
    assert profiling.snapshot()["counters"] == {"sync.d": 1}


def test_the_registry_loses_no_update_across_threads(monkeypatch):
    """Spans closing on many threads at once (as the autograd thread's do
    beside the main one's) all count."""
    import sys
    from contextlib import nullcontext

    monkeypatch.setattr(profiling, "_profiling", lambda: True)
    monkeypatch.setattr(torch.autograd.profiler, "record_function",
                        lambda name, args=None: nullcontext())

    def work():
        for _ in range(500):
            with profiling.span("outer"):
                with profiling.sync("site"):
                    pass

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work) for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    snap = profiling.snapshot()
    assert snap["counters"] == {"sync.site": 4000}
    assert snap["spans"]["outer"]["count"] == snap["spans"]["sync.site"]["count"] == 4000


# The sync sites each unit's plan reaches (``profiling``'s docstring).
PLANS = {
    # The context upload; per launch its poses and intrinsics (and a fill's
    # context index), the reference pose's list index, the poses' inverse,
    # the rays' inverse; one gather a launch: 1 anchor window and 2 fill
    # launches.
    "scene": (anchored_scene, {"sync.upload": 1 + 2 * 1 + 3 * 2, "sync.pose_index": 3,
                               "sync.relative_pose": 3, "sync.world_rays": 3,
                               "sync.gather": 3}),
    "request": (request, {"sync.upload": 3, "sync.pose_index": 1, "sync.relative_pose": 1,
                          "sync.world_rays": 1, "sync.gather": 1}),
    # Images, extrinsics, intrinsics; the poses' inverse (a tensor index,
    # no upload), the rays' inverse; the noise schedule's table; the
    # gradient norm for the metric and for the clip.
    "micro_step": (micro_step, {"sync.batch_upload": 3, "sync.relative_pose": 1,
                                "sync.world_rays": 1, "sync.schedule_upload": 1,
                                "sync.grad_norm": 2}),
}


@pytest.mark.parametrize("unit", sorted(PLANS))
def test_sync_counts_follow_the_launch_plans(engine, unit):
    fn, want = PLANS[unit]
    traced(fn, tiny_engine() if unit == "micro_step" else engine)
    snap = profiling.snapshot()
    assert snap["counters"] == want
    for name, count in want.items():
        assert snap["spans"][name]["count"] == count


def test_tracing_changes_no_frame(engine):
    off = anchored_scene(engine)
    on, _ = traced(anchored_scene, engine)
    assert sorted(on) == sorted(off) == list(range(1, 9))
    for k in off:
        assert np.array_equal(on[k], off[k]), k


def test_tracing_changes_no_trained_value():
    off = micro_step(tiny_engine())
    on, _ = traced(micro_step, tiny_engine())
    assert profiling.snapshot()["spans"]["train.optimizer"]["count"] == 1
    for k in off.params:
        assert torch.equal(on.params[k], off.params[k]), k
        assert torch.equal(on.opt_state["mu"][k], off.opt_state["mu"][k]), k


def test_stop_trace_writes_program_ranges(tmp_path):
    prof = profiling.start_trace()
    with profiling.span("work", {"rows": 2}):
        with profiling.sync("site"):
            torch.ones(4).sum()
    out = profiling.stop_trace(prof, tmp_path / "step")
    assert out == tmp_path / "step" / "trace.json"
    names = [e.get("name") for e in json.loads(out.read_text())["traceEvents"]]
    assert names.count("mvldm/work") == names.count("mvldm/sync.site") == 1
