"""The port's sampling CLI (``scripts/generate_mvldm.py``, ``scripts/main.py
mode=test``) on the synthetic RE10K data with the tiny experiment, on the
CPU (``device="cpu"``, the caller asking for it). Each run must write the
JAX CLI's output tree: ``video/<scene>/color/<frame>.png`` for each sampled
frame, ``context/<frame>.png`` for each context frame, ``sampled.gif`` and
the 25 and 10 fps MP4s."""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from mvldm_tpu_torch.scripts import generate_mvldm
from mvldm_tpu_torch.scripts import main as main_script
from mvldm_tpu_torch.utils.image_io import load_image
from mvldm_tpu_torch.utils.mp4 import parse_boxes

from synthetic_data import write_synthetic_dataset

REPO = Path(__file__).resolve().parent.parent
TINY = ["+experiment=tiny", "dataset.image_shape=[32,32]",
        "model.scheduler.num_inference_steps=2", "trainer.limit_test_batches=2"]


@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    root = write_synthetic_dataset(tmp_path_factory.mktemp("re10k"), stages=("test",),
                                   frames_per_scene=20)
    index = {"scenetest0000": {"context": [0, 10], "target": [1, 3, 5]},
             "dropped": None,
             "scenetest0001": {"context": [0, 12], "target": [2, 4, 6, 8]}}
    (root / "eval_index.json").write_text(json.dumps(index))
    return root


def tree(video_dir: Path) -> set:
    return {str(p.relative_to(video_dir)) for p in video_dir.rglob("*") if p.is_file()}


def expected_tree(scene: str, frames, context) -> set:
    return ({f"{scene}/color/{f:06d}.png" for f in frames}
            | {f"{scene}/context/{f:06d}.png" for f in context}
            | {f"{scene}/{name}" for name in
               ("sampled.gif", "sampled_fps_25.mp4", "sampled_fps_10.mp4")})


def check_outputs(scene_dir: Path, n_frames: int) -> None:
    colors = sorted((scene_dir / "color").glob("*.png"))
    assert len(colors) == n_frames
    for p in colors:
        img = load_image(p)
        assert img.shape == (32, 32, 3)
    for name in ("sampled_fps_25.mp4", "sampled_fps_10.mp4"):
        boxes = [k for k, _ in parse_boxes((scene_dir / name).read_bytes())]
        assert boxes == [b"ftyp", b"mdat", b"moov"]


@pytest.mark.parametrize("mode,feed", [("anchored", False), ("autoregressive", False),
                                       ("autoregressive", True)])
def test_generate_writes_the_output_tree_and_skips_on_rerun(data_root, tmp_path, capsys,
                                                            mode, feed):
    args = TINY + [f"dataset.root={data_root}", f"output_dir={tmp_path}",
                   "scene_id=scenetest0001", f"test.sampling_mode={mode}",
                   "test.limit_frames=7", f"test.ar_latent_feedthrough={str(feed).lower()}",
                   "dataset.view_sampler.max_distance_between_context_views=8"]
    generate_mvldm.main(args, device="cpu")
    video = tmp_path / "video"
    # Bounded sampler, test stage: context (0, 8), targets 0..8, cut to 7.
    assert tree(video) == expected_tree("scenetest0001", range(7), (0, 8))
    check_outputs(video / "scenetest0001", 7)

    before = {p: p.stat().st_mtime_ns for p in (video / "scenetest0001" / "color").iterdir()}
    capsys.readouterr()
    generate_mvldm.main(args, device="cpu")
    assert "Skipping scenetest0001 (already sampled)" in capsys.readouterr().out
    assert {p: p.stat().st_mtime_ns for p in before} == before


def test_main_mode_test_batches_scenes(data_root, tmp_path):
    """Both scenes in one dispatch (``test.scene_batch=2``) through
    ``scripts.main``."""
    main_script.main(TINY + [f"dataset.root={data_root}", f"output_dir={tmp_path}",
                             "mode=test", "test.scene_batch=2", "test.limit_frames=5",
                             "dataset.view_sampler.max_distance_between_context_views=8"],
                     device="cpu")
    video = tmp_path / "video"
    assert tree(video) == (expected_tree("scenetest0000", range(5), (0, 8))
                           | expected_tree("scenetest0001", range(5), (0, 8)))
    a = load_image(video / "scenetest0000" / "color" / "000004.png")
    b = load_image(video / "scenetest0001" / "color" / "000004.png")
    assert not np.array_equal(a, b)


@pytest.mark.parametrize("scene_id,scene,frames", [
    ("1", "scenetest0001", (2, 4, 6, 8)), ("scenetest0000", "scenetest0000", (1, 3, 5))])
def test_scene_id_by_index_and_by_hash(data_root, tmp_path, scene_id, scene, frames):
    """An integer indexes the evaluation index's scenes (null entries
    dropped); a string is the scene's hash."""
    generate_mvldm.main(TINY + [f"dataset.root={data_root}", f"output_dir={tmp_path}",
                                f"scene_id={scene_id}", "dataset/view_sampler=evaluation",
                                f"dataset.view_sampler.index_path={data_root / 'eval_index.json'}"],
                        device="cpu")
    context = (0, 10) if scene == "scenetest0000" else (0, 12)
    assert tree(tmp_path / "video") == expected_tree(scene, frames, context)


@pytest.mark.parametrize("entry", [generate_mvldm.main, main_script.main])
def test_without_a_card_the_clis_exit_nonzero(monkeypatch, tmp_path, entry):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as exc:
        entry(["+experiment=tiny", "mode=test", f"output_dir={tmp_path}"])
    assert exc.value.code not in (None, 0)
    assert "no CUDA device" in str(exc.value.code)
    assert not (tmp_path / "video").exists()


def test_the_module_exits_nonzero_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the CLI would run")
    out = subprocess.run([sys.executable, "-m", "mvldm_tpu_torch.scripts.generate_mvldm",
                          "+experiment=tiny", f"output_dir={tmp_path}"],
                         cwd=REPO, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert "no CUDA device" in out.stderr


def test_eval_params_come_from_the_latest_saved_state(tmp_path):
    """``params``, or ``ema_params`` under ``model.use_ema_sampling``, of the
    newest step under ``<output_dir>/checkpoints``; a state that cannot be
    restored is fatal unless ``checkpointing.allow_init_weights``."""
    from mvldm_tpu_torch import builder, config
    from mvldm_tpu_torch.training.checkpoint import CheckpointManager

    def engine_for(*overrides):
        cfg = config.load_typed_root_config(config.compose(
            ["+experiment=tiny", f"output_dir={tmp_path}", *overrides]))
        return cfg, builder.build_engine(cfg, "cpu")

    cfg, engine = engine_for()
    init = {n: p.detach().clone() for n, p in engine.unet.named_parameters()}
    params = {n: p + 1.0 for n, p in init.items()}
    ema = {n: p + 2.0 for n, p in init.items()}
    mgr = CheckpointManager(tmp_path / "checkpoints")
    mgr.save(3, {"params": {n: p - 5.0 for n, p in init.items()}, "ema_params": None})
    mgr.save(4, {"params": params, "ema_params": ema, "step": 4})
    for overrides, want in (((), params), (("model.use_ema_sampling=true",), ema)):
        cfg, engine = engine_for(*overrides)
        main_script._load_eval_params(cfg, engine)
        for n, p in engine.unet.named_parameters():
            assert torch.equal(p, want[n]), n

    mgr.save(5, {"params": params, "ema_params": None, "step": 5})
    cfg, engine = engine_for("model.use_ema_sampling=true")
    with pytest.raises(RuntimeError, match="allow_init_weights"):
        main_script._load_eval_params(cfg, engine)
    cfg, engine = engine_for("model.use_ema_sampling=true",
                             "checkpointing.allow_init_weights=true")
    main_script._load_eval_params(cfg, engine)
    for n, p in engine.unet.named_parameters():
        assert torch.equal(p, init[n]), n
