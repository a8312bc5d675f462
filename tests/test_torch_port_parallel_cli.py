"""The port's training CLI and ``Trainer`` on two gloo CPU ranks
(``tests/torch_port_ranks.py``, one launch under a time limit):

* ``python -m mvldm_tpu_torch.scripts.main mode=train`` under each
  ``trainer.strategy`` with the ``MVLDM_COORDINATOR`` triplet: rank 0
  writes ``metrics.jsonl`` and the checkpoints, and a checkpoint holds the
  whole state (every leaf at its one-card shape); the model ranks of
  ``data_model`` read the same batches from an unseeded stream;
* ``Trainer.fit``: only rank 0 saves, logs and runs the validation hook,
  which gets whole parameters;
* ``mode=test``: the ranks' scenes are disjoint and together are every
  scene of the stage, each sampled and exported once;
* ``base_lr`` scales with the world (``optimizer.scale_lr``).
"""

import json

import numpy as np
import pytest
import torch

from mvldm_tpu_torch.config import compose, load_typed_root_config
from mvldm_tpu_torch.data.chunk_reader import save_chunk
from mvldm_tpu_torch.scripts import main as main_script

from synthetic_data import make_cameras, make_frame, write_synthetic_dataset
from tests.test_torch_goldens import checkpoint  # noqa: F401  (module-scoped fixture)
from tests.test_torch_port_models import IGNORED, port_model_cfg
from tests.test_torch_port_train_cli import TINY
from tests.test_torch_port_training import V_C, make_arrays
from tests.torch_port_ranks import launch

STRATEGIES = {"data_parallel": 1, "data_parallel_zero1": 1, "data_parallel_fsdp": 1,
              "data_model": 2}
# The data_model run reads an unseeded train stream, decoded by two threads:
# its two model ranks must still read the same batches.
UNSEEDED = {"data_model": ["data_loader.train.seed=null", "data_loader.train.num_workers=2"]}
# Test scenes by chunk: the loader stripes the test stage by chunk.
TEST_CHUNKS = [["scenetest0000", "scenetest0001"], ["scenetest0002"], ["scenetest0003"]]


def write_data(root):
    """The tiny train stage, and a test stage of three chunks."""
    write_synthetic_dataset(root, stages=("train",), frames_per_scene=24)
    test = root / "test"
    test.mkdir(parents=True)
    index = {}
    for c, keys in enumerate(TEST_CHUNKS):
        name = f"{c:06d}.torch"
        save_chunk([{"key": k, "cameras": make_cameras(24),
                     "images": [make_frame(i + 7 * int(k[-1])) for i in range(24)]}
                    for k in keys], test / name)
        index.update({k: name for k in keys})
    (test / "index.json").write_text(json.dumps(index))
    return root


def argv_for_test(data_root, out):
    return TINY + [f"dataset.root={data_root}", f"output_dir={out}", "mode=test",
                   "test.sampling_mode=anchored", "test.limit_frames=4",
                   "trainer.limit_test_batches=null",
                   "dataset.view_sampler.max_distance_between_context_views=10"]


@pytest.fixture(scope="module")
def run(checkpoint, tmp_path_factory):  # noqa: F811
    tmp = tmp_path_factory.mktemp("parallel_cli")
    data = write_data(tmp / "data")
    images, extr, intr, _ = make_arrays(b=1)
    raw = {role: {"image": images[:, s], "extrinsics": extr[:, s], "intrinsics": intr[:, s]}
           for role, s in (("context", slice(0, V_C)), ("target", slice(V_C, None)))}
    model = {"cfg": port_model_cfg(), "sd": {k: v for k, v in checkpoint[0].items()
                                             if not IGNORED.match(k)}}
    jobs = [dict(name="fit", kind="fit", model=model, strategy="data_parallel_fsdp",
                 raw=raw, v_c=V_C, run_dir=str(tmp / "fit"))]
    for name, nm in STRATEGIES.items():
        jobs.append(dict(name=name, kind="cli", argv=TINY + [
            f"dataset.root={data}", f"output_dir={tmp / name}", "mode=train",
            "trainer.max_steps=2", "checkpointing.every_n_train_steps=2",
            "data_loader.train.batch_size=1", f"trainer.strategy={name}",
            f"trainer.num_model={nm}", "optimizer.scale_lr=true", "model.ema=true",
            *UNSEEDED.get(name, [])]))
    jobs.append(dict(name="test", kind="cli", argv=argv_for_test(data, tmp / "test")))
    return tmp, data, launch(jobs, tmp / "out", timeout=420)


@pytest.mark.parametrize("strategy", list(STRATEGIES))
def test_cli_train_under_each_strategy(run, strategy):
    """Two steps; rank 0 alone logs (the last step's line, a finite loss); the
    checkpoint of step 2 holds the whole state at one-card shapes."""
    tmp, _, ranks = run
    log = [json.loads(x) for x in (tmp / strategy / "metrics.jsonl").read_text().splitlines()]
    assert [r["step"] for r in log] == [2] and np.isfinite(log[0]["loss/diffusion"])
    assert f"strategy {strategy}: " in ranks[0][strategy]["stdout"]
    assert "strategy" not in ranks[1][strategy]["stdout"]
    assert "step 2:" not in ranks[1][strategy]["stdout"]
    state = torch.load(tmp / strategy / "checkpoints" / "step_000000002" / "state.pt",
                       weights_only=True)
    cfg = load_typed_root_config(compose(TINY + ["mode=train"]))
    from mvldm_tpu_torch.builder import build_engine

    shapes = {n: p.shape for n, p in build_engine(cfg, "meta").unet.named_parameters()}
    assert state["step"] == 2 and state["opt_state"]["count"] == 2
    for key in ("params", "ema_params"):
        assert {n: t.shape for n, t in state[key].items()} == shapes, key
    assert {n: t.shape for n, t in state["opt_state"]["mu"].items()} == shapes


def test_data_model_ranks_read_the_same_batches(run):
    """Under ``data_model`` (1 x 2) both model ranks train on the same
    batches though the config gives the train stream no seed: rank 0's
    seed is shared, and the stream is the data rank's."""
    _, _, ranks = run
    a, b = (r["data_model"]["batches"] for r in ranks)
    assert len(a) == 2 and a == b


def test_base_lr_scales_with_the_world(run):
    _, data, ranks = run
    argv = TINY + [f"dataset.root={data}", "optimizer.scale_lr=true",
                   "data_loader.train.batch_size=1"]
    one = main_script.base_lr(load_typed_root_config(compose(argv)))
    assert one == pytest.approx(1e-4)
    for r in ranks:
        assert r["data_parallel"]["base_lr"] == pytest.approx(2 * one)


def test_fit_writes_only_from_rank_0(run):
    """Checkpoints at steps 2 and 3, one log line a step and the hook at
    step 2 on rank 0 (with whole masters and EMA); nothing on rank 1."""
    tmp, _, ranks = run
    r0, r1 = ranks[0]["fit"], ranks[1]["fit"]
    assert r0["step"] == r1["step"] == 3
    assert r0["saves"] == [2, 3] and r1["saves"] == []
    assert r0["hooks"] == [(2, True, True)] and r1["hooks"] == []
    assert [x["step"] for x in r0["log"]] == [1, 2, 3]
    assert sorted(p.name for p in (tmp / "fit" / "checkpoints").glob("step_*")) == \
        ["step_000000003"]


def test_mode_test_stripes_are_disjoint_and_complete(run):
    """Rank 0 samples the scenes of chunks 0 and 2, rank 1 those of chunk
    1: disjoint, and together every scene of the stage, which is what one
    process samples (``trainer.limit_test_batches=null``); each scene
    directory holds its frames and exports, written once."""
    tmp, _, ranks = run

    def sampled(stdout):
        return [line.split()[2].rstrip(";") for line in stdout.splitlines()
                if line.startswith("scene = ")]

    s0, s1 = (sampled(r["test"]["stdout"]) for r in ranks)
    assert sorted(s0) == sorted(TEST_CHUNKS[0] + TEST_CHUNKS[2])
    assert s1 == TEST_CHUNKS[1]
    every = sorted(sum(TEST_CHUNKS, []))
    assert sorted(s0 + s1) == every
    assert sorted(p.name for p in (tmp / "test" / "video").iterdir()) == every
    for scene in every:
        d = tmp / "test" / "video" / scene
        assert len(list((d / "color").glob("*.png"))) == 4
        assert (d / "sampled.gif").exists() and (d / "sampled_fps_25.mp4").exists()
