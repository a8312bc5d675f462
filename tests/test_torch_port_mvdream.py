"""MVDream on the port (``models/mvdream.py``, ``DiffusionEngine.text_to_multiview``)
against the benchmark's plain reference (``benchmark/reference/mvdream.py``),
on the CPU in float32 at a tiny width, with the benchmark's seeded weights
shared by name.

* the denoiser agrees with the reference's;
* its attn1 is joint: changing one view's latents changes every other
  view's output, in the port as in the reference;
* the text tokens and the camera each reach the output;
* a 3-step text-to-multiview call with batched guidance gives the
  reference loop's frames within one 8-bit level, with one upload and one
  gather counted as host syncs;
* the benchmark's configuration types and builds on the meta device with
  exactly the reference's parameter names.
"""

import copy
import json
import sys
from pathlib import Path

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark import weights  # noqa: E402
from benchmark.reference import mvdream as ref_mvdream  # noqa: E402
from mvldm_tpu_torch.builder import MVLDM  # noqa: E402
from mvldm_tpu_torch.config import compose, from_dict  # noqa: E402
from mvldm_tpu_torch.diffusion.engine import DiffusionEngine, ModelCfg  # noqa: E402
from mvldm_tpu_torch.diffusion.schedulers import get_scheduler  # noqa: E402
from mvldm_tpu_torch.models.mvdream import MVDreamUNet  # noqa: E402
from mvldm_tpu_torch.utils import profiling  # noqa: E402

CONFIG = ROOT / "benchmark" / "configs" / "mvdream-sd21-4view.json"
SEED = 2 ** 31 + 19
B, V, HL, CTX = 2, 4, 8, 32
# The port and the reference compute the same float32 products, in other
# orders and groupings (one text attention a prompt over all its views'
# queries against one a view, einsum against matmul): gaps of a few ulps
# of the outputs (|y| <= ~3).
ATOL = 1e-5


def config():
    return json.loads(CONFIG.read_text())


@pytest.fixture(autouse=True)
def _one_thread():
    """Tiny products: one intra-op thread each, so that the suite's
    parallel workers do not oversubscribe the host's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def tiny_model_cfg(steps: int = 3) -> dict:
    """The configuration's ``model`` at 32 / 64 channels, one res block,
    16-wide heads, 32-wide text tokens and the ``tiny`` experiment's VAE."""
    m = copy.deepcopy(config()["model"])
    m["denoiser"].update(model_channels=32, channel_mult=[1, 2], attention_resolutions=[1, 2],
                         num_res_blocks=1, num_head_channels=16, context_dim=CTX)
    m["autoencoder"]["kwargs"].update(
        compose(["+experiment=tiny"])["model"]["autoencoder"]["kwargs"])
    m["scheduler"]["num_inference_steps"] = steps
    return m


@pytest.fixture(scope="module")
def models():
    """(port holder, reference) with the same seeded float32 weights."""
    m = tiny_model_cfg()
    ref = ref_mvdream.Model(m)
    made = weights.make(weights.spec(ref.named_parameters()), SEED, "cpu", torch.float32)
    ref.load_state_dict(made)
    port = MVLDM(from_dict(ModelCfg, m, "model"))
    port.load_state_dict(made)
    return port.eval(), ref.eval()


def inputs(seed: int = 0):
    gen = torch.Generator().manual_seed(seed)
    return (torch.randn(B, V, HL, HL, 4, generator=gen),
            torch.randint(0, 1000, (B, V), generator=gen),
            torch.randn(B, ref_mvdream.TEXT_TOKENS, CTX, generator=gen),
            torch.randn(B, V, 16, generator=gen))


def both(models, *args):
    port, ref = models
    with torch.no_grad():
        return port.denoiser(*args), ref.denoiser(*args)


@pytest.mark.parametrize("timesteps", ["per_view", "per_row"])
def test_denoiser_matches_the_reference(models, timesteps):
    """(b, v) timesteps, or (b,) ones that the port spreads over the views
    (the reference takes (b, v))."""
    port, ref = models
    x, t, ctx, cam = inputs()
    if timesteps == "per_row":
        t = t[:, :1].expand(B, V)
    with torch.no_grad():
        got = port.denoiser(x, t[:, 0] if timesteps == "per_row" else t, ctx, cam)
        want = ref.denoiser(x, t, ctx, cam)
    assert isinstance(port.denoiser, MVDreamUNet)
    assert got.shape == (B, V, HL, HL, 4)
    torch.testing.assert_close(got, want, rtol=0, atol=ATOL)


def test_attn1_is_joint_over_the_views(models):
    """A change to view 1's latents moves views 0, 2 and 3 too (a per-view
    attn1 would leave them as they were), by the same amount in both."""
    x, t, ctx, cam = inputs()
    got, want = both(models, x, t, ctx, cam)
    x2 = x.clone()
    x2[:, 1] += 1.0
    got2, want2 = both(models, x2, t, ctx, cam)
    moved = (got2 - got).abs().amax(dim=(2, 3, 4))
    assert (moved[:, [0, 2, 3]] > 1e-2).all(), moved
    torch.testing.assert_close(got2 - got, want2 - want, rtol=0, atol=2 * ATOL)


@pytest.mark.parametrize("which", ["text", "camera"])
def test_text_and_camera_reach_the_output(models, which):
    """A new prompt's tokens or new cameras move every view's output (no
    zero-context shortcut, no dropped camera MLP), as in the reference."""
    x, t, ctx, cam = inputs()
    got, want = both(models, x, t, ctx, cam)
    _, _, ctx2, cam2 = inputs(1)
    args = (x, t, ctx2, cam) if which == "text" else (x, t, ctx, cam2)
    got2, want2 = both(models, *args)
    assert ((got2 - got).abs().amax(dim=(2, 3, 4)) > 1e-2).all()
    torch.testing.assert_close(got2, want2, rtol=0, atol=ATOL)


def test_text_to_multiview_matches_the_reference_loop(models):
    """3 DDIM steps with batched guidance (CFG 10, one UNet call of 2B rows
    a step) and the decode: the frames of the reference's sequential loop
    within one 8-bit level (truncation may round an f32 gap of ~1e-6
    across a level). One upload and one gather are the host syncs."""
    port, ref = models
    m = tiny_model_cfg()
    engine = DiffusionEngine(from_dict(ModelCfg, m, "model"), port.denoiser, port.autoencoder,
                             get_scheduler(from_dict(ModelCfg, m, "model").scheduler))
    gen = torch.Generator().manual_seed(3)
    text = torch.randn(B, ref_mvdream.TEXT_TOKENS, CTX, generator=gen)
    empty = torch.randn(ref_mvdream.TEXT_TOKENS, CTX, generator=gen)
    cams = torch.randn(B, V, 16, generator=gen)
    noise = torch.randn(B, V, HL, HL, 4, generator=gen)
    profiling.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        frames = engine.gather_frames(engine.text_to_multiview(text, empty, cams, noise))
    recorded = profiling.snapshot()
    profiling.reset()
    with torch.no_grad():
        want = ref_mvdream.sample(ref, ref_mvdream.DDIM.from_cfg(m["scheduler"]), m["cfg_scale"],
                                  text, empty, cams, noise).numpy()
    assert frames.dtype == want.dtype and frames.shape == want.shape == (B, V, 64, 64, 3)
    assert abs(frames.astype(int) - want.astype(int)).max() <= 1
    assert recorded["counters"] == {"sync.t2mv_upload": 1, "sync.t2mv_gather": 1}
    spans = recorded["spans"]
    assert spans["engine.t2mv"]["count"] == 1 and spans["engine.unet"]["count"] == 3
    # One text cross-attention a spatial transformer a step.
    n_blocks = sum(1 for mod in port.denoiser.modules() if type(mod).__name__ == "Transformer2D")
    assert spans["ops.text_cross_attention"]["count"] == 3 * n_blocks


def test_the_configuration_builds_with_the_reference_names():
    cfg = config()
    model_cfg = from_dict(ModelCfg, cfg["model"], "model")
    assert model_cfg.denoiser.name == "mvdream" and model_cfg.cfg_scale == 10.0
    with torch.device("meta"):
        port = MVLDM(model_cfg)
        ref = ref_mvdream.Model(cfg["model"])
    assert weights.spec(port.named_parameters()) == weights.spec(ref.named_parameters())
    attentions = [mod for mod in port.denoiser.modules()
                  if type(mod).__name__ == "Transformer2D"]
    assert len(attentions) == 16  # 2 down and 3 up at 32, 16, 8; the mid block
    assert sum(p.numel() for p in port.denoiser.parameters()) == 867_572_164
