"""The port's evaluation metrics (``evaluation/metrics.py``,
``inception.py``, ``fid.py``) against the JAX package's, f32 on CPU.

* PSNR and SSIM within 1e-5 (relative; SSIM also absolute) of JAX.
* LPIPS within 1e-5 relative and DISTS within 1e-5 absolute on the seeded
  weights of ``tests/test_metrics.make_fake_vgg_npz`` and
  ``tests/test_metric_goldens.he_vgg_npz`` (the JAX layout, converted by the
  port at load); DISTS is one minus a weighted mean of per-channel
  similarities of order 1, so its f32 rounding (~1e-6 seen) does not scale
  with the distance. The refusals and ``get_*`` returning None as in JAX.
* ``VAEFeatureDistance`` and ``vae_feature_extractor`` within 1e-5 relative
  on the tiny VAE of ``tests/test_torch_goldens.py`` (one reference
  checkpoint in both packages); ``vgg_feature_extractor`` likewise.
* InceptionV3 pool3 features within relative L2 1e-5 of JAX on
  ``tests/test_inception.synth_state``, at 256 px, where the FID resize is
  a 256 -> 299 upsampling. The resize alone: ``jax.image.resize``
  (bilinear, no antialias) renormalises its triangle kernel over the taps
  inside the image; ``F.interpolate`` (align_corners=False) clamps the
  source index; upsampling, both give the edge pixel at the border, and
  the two agree to float32 rounding (asserted within 1e-6 absolute).
* FID and KID within 1e-6 relative on the same features, the regularised
  (singular) branch included, and the refusal of a complex square root.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mvldm_tpu.evaluation import fid as jax_fid
from mvldm_tpu.evaluation import inception as jax_inception
from mvldm_tpu.evaluation import metrics as jax_metrics
from mvldm_tpu_torch.evaluation import fid, inception, metrics
from mvldm_tpu_torch.models.vae import AutoencoderKL, AutoencoderKLCfg

from tests.test_inception import synth_state
from tests.test_metric_goldens import he_vgg_npz
from tests.test_metrics import make_fake_vgg_npz
from tests.test_torch_goldens import VAE_CFG
from tests.test_torch_goldens import checkpoint  # noqa: F401  (module-scoped fixture)


def _images(n=2, hw=64, seed=1, noise=0.25):
    rng = np.random.default_rng(seed)
    a = rng.uniform(size=(n, hw, hw, 3)).astype(np.float32)
    b = np.clip(a + noise * rng.normal(size=a.shape), 0, 1).astype(np.float32)
    return a, b


def _close(got, want, rtol, atol=0.0):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                               rtol=rtol, atol=atol)


def test_psnr_and_ssim_vs_jax():
    a, b = _images(n=3, hw=48)
    a5, b5 = a.reshape(1, 3, 48, 48, 3), b.reshape(1, 3, 48, 48, 3)
    for x, y in ((a, b), (a5, b5), (a, a)):
        tx, ty = torch.from_numpy(x), torch.from_numpy(y)
        psnr = metrics.compute_psnr(tx, ty).numpy()
        want = np.asarray(jax_metrics.compute_psnr(jnp.asarray(x), jnp.asarray(y)))
        assert psnr.shape == want.shape
        _close(psnr, want, 1e-5)
        ssim = metrics.compute_ssim(tx, ty).numpy()
        want = np.asarray(jax_metrics.compute_ssim(jnp.asarray(x), jnp.asarray(y)))
        assert ssim.shape == want.shape
        _close(ssim, want, 1e-5, 1e-5)
    # Out-of-range inputs are clipped, as in JAX.
    _close(metrics.compute_psnr(torch.from_numpy(a * 2), torch.from_numpy(b - 1)).numpy(),
           jax_metrics.compute_psnr(jnp.asarray(a * 2), jnp.asarray(b - 1)), 1e-5)


@pytest.fixture(scope="module", params=["fake", "he"])
def vgg_weights(request, tmp_path_factory):
    path = tmp_path_factory.mktemp("vgg") / "vgg.npz"
    return make_fake_vgg_npz(path) if request.param == "fake" else he_vgg_npz(path)


def test_lpips_vs_jax(vgg_weights):
    a, b = _images()
    got = metrics.LPIPS(vgg_weights)(a, b).numpy()
    want = np.asarray(jax_metrics.LPIPS(vgg_weights)(a, b))
    assert got.shape == (2,) and np.abs(want).min() > 0
    _close(got, want, 1e-5)
    assert np.allclose(metrics.LPIPS(vgg_weights)(a, a).numpy(), 0.0, atol=1e-7)


def test_dists_vs_jax(vgg_weights):
    a, b = _images(seed=2)
    if "dists_alpha" not in np.load(vgg_weights):
        assert metrics.get_dists(vgg_weights) is None
        return
    got = metrics.DISTS(vgg_weights)(a, b).numpy()
    want = np.asarray(jax_metrics.DISTS(vgg_weights)(a, b))
    assert got.shape == (2,) and np.abs(want).min() > 1e-4
    _close(got, want, 0, 1e-5)


def test_l2_pool_vs_jax():
    x = np.random.default_rng(0).normal(size=(2, 9, 9, 5)).astype(np.float32)
    got = metrics._l2_pool(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    _close(got.numpy(), jax_metrics._l2_pool(jnp.asarray(x)), 1e-6, 1e-7)


def test_weight_refusals_match_jax(tmp_path, capsys):
    missing = tmp_path / "nope.npz"
    assert metrics.get_lpips(missing) is None and jax_metrics.get_lpips(missing) is None
    assert metrics.get_dists(missing) is None
    assert "DISTS unavailable" in capsys.readouterr().out
    vgg_only = tmp_path / "vgg_only.npz"
    data = dict(np.load(he_vgg_npz(tmp_path / "full.npz")))
    del data["dists_alpha"], data["dists_beta"]
    np.savez(vgg_only, **data)
    with pytest.raises(FileNotFoundError, match="Refusing to substitute uniform"):
        metrics.DISTS(vgg_only)
    assert metrics.get_lpips(vgg_only) is not None


def _vaes(checkpoint):
    """The tiny VAE in both packages from one reference checkpoint."""
    ckpt, params = checkpoint
    vae = AutoencoderKL(AutoencoderKLCfg(**dataclasses.asdict(VAE_CFG)))
    vae.load_state_dict({k[len("autoencoder."):]: v for k, v in ckpt.items()
                         if k.startswith("autoencoder.")})
    return vae.eval().requires_grad_(False), params["vae"]


def test_vae_feature_distance_vs_jax(checkpoint):  # noqa: F811
    vae, jax_params = _vaes(checkpoint)
    a, b = _images(seed=3, noise=0.1)
    got = metrics.VAEFeatureDistance(vae)(a, b).numpy()
    want = np.asarray(jax_metrics.VAEFeatureDistance(jax_params, vae_kwargs=VAE_CFG)(a, b))
    assert got.shape == (2,) and want.min() > 0
    _close(got, want, 1e-5)


def test_feature_extractors_vs_jax(checkpoint, vgg_weights):  # noqa: F811
    vae, jax_params = _vaes(checkpoint)
    a, _ = _images(n=3, seed=4)
    got = fid.vae_feature_extractor(vae, pool_to=4, batch_size=2)(a)
    want = jax_fid.vae_feature_extractor(jax_params, vae_kwargs=VAE_CFG, pool_to=4,
                                         batch_size=2)(a)
    assert got.shape == want.shape == (3, 4 * 4 * 4)
    _close(got, want, 1e-5, 1e-6)
    got = fid.vgg_feature_extractor(vgg_weights)(a)
    want = jax_fid.vgg_feature_extractor(vgg_weights)(a)
    assert got.shape == want.shape == (3, 512)
    _close(got, want, 1e-5, 1e-6 * np.abs(want).max())
    assert fid.vgg_feature_extractor(vgg_weights.parent / "absent.npz") is None


def test_resize_256_to_299_vs_jax():
    x = np.random.default_rng(5).uniform(size=(2, 256, 256, 3)).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(x), (2, 299, 299, 3), method="bilinear",
                                       antialias=False))
    got = inception.InceptionV3Features.preprocess(torch.from_numpy(x))
    got = ((got + 1.0) / 2.0).permute(0, 2, 3, 1).numpy()
    assert np.abs(got - want).max() <= 1e-6
    # The border rows and columns are the edge pixels' in both.
    assert np.abs(got[:, 0] - want[:, 0]).max() <= 1e-6
    assert np.abs(got[:, :, -1] - want[:, :, -1]).max() <= 1e-6


def test_inception_features_vs_jax(tmp_path):
    state = synth_state()
    images = np.random.default_rng(1).uniform(size=(2, 256, 256, 3)).astype(np.float32)
    got = inception.InceptionV3Features(state)(images)
    want = jax_inception.InceptionV3Features(state)(images)
    assert got.shape == want.shape == (2, 2048)
    assert np.abs(want[0] - want[1]).mean() > 1e-3 * np.abs(want).mean()  # a live input path
    rel = np.linalg.norm(got - want) / np.linalg.norm(want)
    assert rel <= 1e-5, rel
    assert inception.inception_feature_extractor(tmp_path / "nope.npz") is None
    del state["Mixed_7b.branch1x1.conv.weight"]
    with pytest.raises(KeyError, match="missing"):
        inception.InceptionV3Features(state)
    assert inception.expected_state_keys() == jax_inception.expected_state_keys()
    assert inception.CONV_DEFS == jax_inception.CONV_DEFS


@pytest.mark.parametrize("n,d", [(40, 8), (6, 16)])  # full-rank, then singular
def test_fid_and_kid_vs_jax(n, d):
    rng = np.random.default_rng(n)
    fa = rng.normal(size=(n, d)).astype(np.float32)
    fb = (rng.normal(size=(n, d)) * 1.3 + 0.2).astype(np.float32)
    for ours, theirs in ((fid.frechet_distance, jax_fid.frechet_distance),
                         (fid.kernel_distance, jax_fid.kernel_distance)):
        got, want = ours(fa, fb), theirs(fa, fb)
        assert np.isfinite(got)
        assert got == pytest.approx(want, rel=1e-6)
    assert fid.frechet_distance(fa, fa.copy()) == pytest.approx(0.0, abs=1e-3)


def test_fid_refuses_a_complex_square_root(monkeypatch):
    import scipy.linalg

    def complex_sqrtm(m):
        return np.eye(len(m)) * (1 + 0.5j)

    monkeypatch.setattr(scipy.linalg, "sqrtm", complex_sqrtm)
    fa = np.random.default_rng(0).normal(size=(10, 3))
    with pytest.raises(ValueError, match="materially complex"):
        fid.frechet_distance(fa, fa + 1)


def test_resolve_vae_params(tmp_path, capsys):
    assert fid.resolve_vae_params() == (None, None)
    vae, key = fid.resolve_vae_params(allow_init_vae=True)
    assert key == "vaefeat_randominit" and "RANDOM-INIT" in capsys.readouterr().out
    sd = {f"autoencoder.{k}": v.clone() + 0.5 for k, v in vae.state_dict().items()}
    torch.save({"state_dict": sd}, tmp_path / "ref.ckpt")
    loaded, key = fid.resolve_vae_params(tmp_path / "ref.ckpt")
    assert key == "vaefeat"
    for k, v in loaded.state_dict().items():
        assert torch.equal(v, sd[f"autoencoder.{k}"])
