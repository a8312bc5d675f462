"""The port's remaining modules against the JAX package, on the CPU:

* the index generators and their CLIs: the same JSON, byte for byte
  (``tests/test_evaluation_surface.py``'s cases);
* ``utils/ckpt_manifest``: the census equals the committed manifest, a
  synthesized checkpoint passes, defects and the legacy VAE attention
  names are reported as the JAX check reports them
  (``tests/test_ckpt_manifest.py``), and ``--check`` reads a file;
* ``utils/wandb_tools``: ``tests/test_wandb_tools.py``'s cases, run on the
  port's module;
* the weight converters: the port's ``.npz`` dict equal to the JAX
  converter's on a synthesized state dict (Inception) and on a stubbed
  ``lpips`` package (LPIPS);
* DDIM with ``eta > 0``: a step against the JAX step with the same noise,
  1e-6; without noise it raises.
"""

import json
import sys
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tests.test_wandb_tools as jax_wandb_tests
from mvldm_tpu.diffusion.schedulers import DDIMScheduler as JaxDDIM
from mvldm_tpu.diffusion.schedulers import DDIMSchedulerKwargs as JaxKw
from mvldm_tpu.evaluation.evaluation_index_generator import (
    generate_video_index as jax_video_index,
)
from mvldm_tpu.scripts import generate_co3d_evaluation_index as jax_co3d_cli
from mvldm_tpu.scripts import generate_evaluation_index as jax_index_cli
from mvldm_tpu.utils import ckpt_manifest as jax_manifest
from mvldm_tpu.utils import inception_convert as jax_inception_convert
from mvldm_tpu.utils import lpips_convert as jax_lpips_convert
from mvldm_tpu_torch.diffusion.schedulers import DDIMScheduler, DDIMSchedulerKwargs
from mvldm_tpu_torch.evaluation.evaluation_index_generator import generate_video_index
from mvldm_tpu_torch.scripts import generate_co3d_evaluation_index as co3d_cli
from mvldm_tpu_torch.scripts import generate_evaluation_index as index_cli
from mvldm_tpu_torch.utils import ckpt_manifest, inception_convert, lpips_convert, wandb_tools

from synthetic_data import write_synthetic_dataset
from tests.test_ckpt_manifest import REPO, synth_checkpoint
from tests.test_inception import synth_state


@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    return write_synthetic_dataset(tmp_path_factory.mktemp("index"), stages=("test",),
                                   scenes_per_stage=3, frames_per_scene=30)


# ----------------------------------------------------------- index generators

@pytest.mark.parametrize("min_frames", [20, 29, 30])
def test_video_index_equals_jax(data_root, tmp_path, min_frames):
    got = generate_video_index(data_root, tmp_path / "port.json", min_frames)
    want = jax_video_index(data_root, tmp_path / "jax.json", min_frames)
    assert got == want
    assert (tmp_path / "port.json").read_bytes() == (tmp_path / "jax.json").read_bytes()
    for entry in got.values():  # the shipped index's protocol
        assert entry is None or (entry["context"] == [0]
                                 and entry["target"] == list(range(1, 30)))


def test_video_index_cli_equals_jax(data_root, tmp_path, capsys):
    for cli, name in ((index_cli, "port"), (jax_index_cli, "jax")):
        cli.main(["--dataset-root", str(data_root), "--output", str(tmp_path / f"{name}.json"),
                  "--min-frames", "20"])
    assert (tmp_path / "port.json").read_bytes() == (tmp_path / "jax.json").read_bytes()
    out = capsys.readouterr().out.splitlines()
    assert out[0].endswith("3/3 scenes indexed") and out[1].endswith("3/3 scenes indexed")


@pytest.mark.parametrize("extra", [False, True])
def test_co3d_index_cli_equals_jax(data_root, tmp_path, extra):
    args = ["--dataset-root", str(data_root), "--min-distance", "2", "--max-distance", "5",
            "--num-targets", "2", "--seed", "3"] + (["--extra"] if extra else [])
    co3d_cli.main(args + ["--output-path", str(tmp_path / "port")])
    jax_co3d_cli.main(args + ["--output-path", str(tmp_path / "jax")])
    got = (tmp_path / "port" / "evaluation_index.json").read_bytes()
    assert got == (tmp_path / "jax" / "evaluation_index.json").read_bytes()
    index = json.loads(got)
    assert index and all(len(e["context"]) == 2 and len(e["target"]) == 2
                         for entries in index.values() for e in entries)


# ------------------------------------------------------------ ckpt_manifest

@pytest.fixture(scope="module")
def manifest():
    return ckpt_manifest.generate_manifest()


def test_census_equals_the_committed_manifest(manifest):
    committed = json.loads((REPO / ckpt_manifest.DEFAULT_MANIFEST).read_text())
    assert committed == json.loads(json.dumps(manifest))


def test_synthesized_checkpoint_passes(manifest, tmp_path, capsys):
    """A zeros state dict of the census, as a Lightning ``.ckpt`` file with
    ``state_dict`` and a step, passes ``--check`` (each tensor a stride-0
    view of one element, so the file stays small)."""
    sd = {k: torch.zeros(1).expand(v.shape) for k, v in synth_checkpoint(manifest).items()}
    report = ckpt_manifest.check_shapes({k: tuple(v.shape) for k, v in sd.items()}, manifest)
    assert not report["missing"] and not report["mismatched"] and not report["extra"]
    path = tmp_path / "m.ckpt"
    torch.save({"state_dict": sd, "global_step": 7}, path)
    ckpt_manifest.main(["--check", str(path)])
    assert "STRUCTURE OK" in capsys.readouterr().out


def test_defects_reported_as_jax_reports_them(manifest, tmp_path):
    shapes = {k: tuple(v) for k, v in manifest["required"].items()}
    shapes.update({k: tuple(v) for k, v in manifest["ignored"].items()})
    shapes["denoiser.unet.conv_in.weight"] = (320, 9, 3, 3)
    del shapes["denoiser.unet.conv_out.weight"]
    del shapes[next(iter(manifest["ignored"]))]
    shapes["extra_ema_key"] = (1,)
    got = ckpt_manifest.check_shapes(shapes, manifest)
    assert got == jax_manifest.check_shapes(shapes, manifest)
    assert [m[0] for m in got["mismatched"]] == ["denoiser.unet.conv_in.weight"]
    assert got["missing"] == ["denoiser.unet.conv_out.weight"]
    assert got["extra"] == ["extra_ema_key"]
    path = tmp_path / "bad.ckpt"
    torch.save({k: torch.zeros(1).expand(s) for k, s in shapes.items()}, path)
    with pytest.raises(SystemExit):
        ckpt_manifest.main(["--check", str(path)])


def test_legacy_vae_attention_accepted(manifest):
    shapes = {k: tuple(v) for k, v in manifest["required"].items()}
    base = "autoencoder.decoder.mid_block.attentions.0"
    for mod, legacy in (("to_q", "q"), ("to_k", "k"), ("to_v", "v"), ("to_out.0", "proj_out")):
        shapes[f"{base}.{legacy}.weight"] = (512, 512, 1, 1)
        shapes[f"{base}.{legacy}.bias"] = (512,)
        del shapes[f"{base}.{mod}.weight"], shapes[f"{base}.{mod}.bias"]
    shapes[f"{base}.norm.weight"] = shapes[f"{base}.norm.bias"] = (512,)
    del shapes[f"{base}.group_norm.weight"], shapes[f"{base}.group_norm.bias"]
    got = ckpt_manifest.check_shapes(shapes, manifest)
    assert not got["missing"] and not got["mismatched"], got
    assert got == jax_manifest.check_shapes(shapes, manifest)


# --------------------------------------------------------------- wandb_tools

@pytest.fixture(autouse=False)
def port_wandb(monkeypatch):
    """Run the JAX module's test cases on the port's ``wandb_tools``."""
    monkeypatch.setattr(jax_wandb_tests, "wandb_tools", wandb_tools)


@pytest.mark.usefixtures("port_wandb")
class TestPortVersionToInt(jax_wandb_tests.TestVersionToInt):
    pass


@pytest.mark.usefixtures("port_wandb")
class TestPortUpdateCheckpointPath(jax_wandb_tests.TestUpdateCheckpointPath):
    pass


@pytest.mark.usefixtures("port_wandb")
class TestPortLogger(jax_wandb_tests.TestLogger):
    pass


def test_port_wandb_cases_run_on_the_port(port_wandb):
    assert jax_wandb_tests.wandb_tools is wandb_tools


# ---------------------------------------------------------------- converters

def test_inception_npz_dict_equals_jax():
    state = dict(synth_state(), extra_fc=np.zeros(3, np.float32))
    state["Mixed_5b.branch1x1.conv.weight"] = torch.from_numpy(
        state["Mixed_5b.branch1x1.conv.weight"])  # tensors and arrays both
    got = inception_convert.state_dict_to_npz_dict(state)
    want = jax_inception_convert.state_dict_to_npz_dict(state)
    assert set(got) == set(want) and "extra_fc" not in got
    for k in want:
        assert got[k].dtype == want[k].dtype == np.float32
        np.testing.assert_array_equal(got[k], want[k])
    bad = dict(state, **{"Conv2d_1a_3x3.conv.weight": np.zeros((32, 3, 5, 5), np.float32)})
    with pytest.raises(ValueError, match="shape"):
        inception_convert.state_dict_to_npz_dict(bad)
    with pytest.raises(KeyError, match="required tensors"):
        inception_convert.state_dict_to_npz_dict({})


def test_inception_convert_from_a_local_source(tmp_path):
    src = tmp_path / "pt_inception.pth"
    torch.save({k: torch.from_numpy(v) for k, v in synth_state().items()}, src)
    inception_convert.convert(tmp_path / "port.npz", source=src)
    jax_inception_convert.convert(tmp_path / "jax.npz", source=src)
    got, want = np.load(tmp_path / "port.npz"), np.load(tmp_path / "jax.npz")
    assert sorted(got.files) == sorted(want.files)
    assert all(np.array_equal(got[k], want[k]) for k in want.files)


def _fake_lpips(monkeypatch):
    """An ``lpips`` package whose VGG has the five slices of seeded convs
    (with ReLUs and pools between) and five linear heads."""
    gen = torch.Generator().manual_seed(0)
    slices, c_in = [], 3
    for c_out, n in [(64, 2), (128, 2), (256, 3), (512, 3), (512, 3)]:
        layers = []
        for _ in range(n):
            conv = torch.nn.Conv2d(c_in, c_out, 3, padding=1)
            with torch.no_grad():
                conv.weight.copy_(torch.randn(conv.weight.shape, generator=gen))
                conv.bias.copy_(torch.randn(conv.bias.shape, generator=gen))
            layers += [conv, torch.nn.ReLU()]
            c_in = c_out
        slices.append(torch.nn.Sequential(torch.nn.MaxPool2d(2), *layers))
    lins = []
    for c in (64, 128, 256, 512, 512):
        lin = types.SimpleNamespace(model=[torch.nn.Dropout(),
                                           torch.nn.Conv2d(c, 1, 1, bias=False)])
        lins.append(lin)

    class LPIPS:
        def __init__(self, net):
            assert net == "vgg"
            self.net = types.SimpleNamespace(**{f"slice{i + 1}": s for i, s in enumerate(slices)})
            self.lins = lins

    mod = types.ModuleType("lpips")
    mod.LPIPS = LPIPS
    monkeypatch.setitem(sys.modules, "lpips", mod)


def test_lpips_npz_equals_jax(monkeypatch, tmp_path):
    _fake_lpips(monkeypatch)
    lpips_convert.convert(tmp_path / "port.npz")
    jax_lpips_convert.convert(tmp_path / "jax.npz")
    got, want = np.load(tmp_path / "port.npz"), np.load(tmp_path / "jax.npz")
    assert sorted(got.files) == sorted(want.files)
    assert "conv5_3_kernel" in got.files and got["conv1_1_kernel"].shape == (3, 3, 3, 64)
    assert all(np.array_equal(got[k], want[k]) for k in want.files)


def test_lpips_convert_fails_without_its_package(monkeypatch, tmp_path):
    monkeypatch.setitem(sys.modules, "lpips", None)
    with pytest.raises(ImportError):
        lpips_convert.convert(tmp_path / "x.npz")


# ---------------------------------------------------------------------- DDIM

@pytest.mark.parametrize("eta", [0.3, 1.0])
@pytest.mark.parametrize("t", [960, 480, 40, 0])
def test_ddim_eta_step_vs_jax(eta, t):
    rng = np.random.default_rng(t)
    x, eps, noise = (rng.standard_normal((2, 3, 4, 4, 4)).astype(np.float32) for _ in range(3))
    jax_sched = JaxDDIM.create(JaxKw(clip_sample=False), num_inference_steps=25)
    want = np.asarray(jax_sched.step(jnp.asarray(eps), t, jnp.asarray(x), eta=eta,
                                     noise=jnp.asarray(noise)))
    sched = DDIMScheduler.create(DDIMSchedulerKwargs(clip_sample=False), num_inference_steps=25)
    got = sched.step(torch.from_numpy(eps), t, torch.from_numpy(x), eta=eta,
                     noise=torch.from_numpy(noise)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    deterministic = sched.step(torch.from_numpy(eps), t, torch.from_numpy(x)).numpy()
    assert t == 0 or not np.allclose(got, deterministic)


def test_ddim_eta_without_noise_raises():
    sched = DDIMScheduler.create(DDIMSchedulerKwargs(), num_inference_steps=25)
    with pytest.raises(ValueError, match="requires noise"):
        sched.step(torch.zeros(1, 4), 480, torch.zeros(1, 4), eta=0.5)
