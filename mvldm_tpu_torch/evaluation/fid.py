"""FID / KID computation (counterpart of ``mvldm_tpu/evaluation/fid.py``).

The reference's FID surface (torchmetrics FID at ``metric_computer.py:22,
65-68`` and cleanfid directory-vs-directory at ``scripts/compute_fid.py:
43-50``) as feature-space statistics in numpy — :func:`gaussian_stats`,
:func:`frechet_distance` and :func:`kernel_distance` are the JAX package's,
copied — over features from one of the extractors:

* :func:`vgg_feature_extractor` — pooled VGG16 conv5 features (needs
  ``lpips_vgg.npz``), keyed ``fid_vgg``;
* :func:`vae_feature_extractor` — SD-VAE encoder latent means pooled to an
  8 x 8 grid, keyed ``fid_vaefeat*``; :func:`resolve_vae_params` builds the
  encoder from a reference ``.ckpt`` or, on request, the port's seeded init
  (``vaefeat_randominit``; its draws are not the JAX package's);
* ``inception.inception_feature_extractor`` — Inception-FID proper.

Extractors run on the device they are given (the CLIs put them on the
card), in f32 with TF32 off.
"""

from __future__ import annotations

from pathlib import Path
from typing import Callable, Optional

import numpy as np
import scipy.linalg
import torch

from ..ops.f32_route import no_tf32


def gaussian_stats(features: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    mu = features.mean(axis=0)
    sigma = np.cov(features, rowvar=False)
    return mu, sigma


def frechet_distance(
    feats_a: np.ndarray, feats_b: np.ndarray, eps: float = 1e-6
) -> float:
    """Frechet distance between Gaussian fits (cleanfid semantics).

    Small-sample / low-rank feature sets make ``sigma1 @ sigma2`` singular;
    following cleanfid (``cleanfid/fid.py``, referenced by the reference's
    ``src/scripts/compute_fid.py:43-50``), the product is regularized with
    ``eps * I`` before the matrix square root whenever the plain sqrtm is
    non-finite or warns about singularity. A materially complex result (an
    actually-invalid covariance pair, not round-off) raises instead of being
    silently truncated to its real part.

    The JAX package's copy calls ``sqrtm(..., disp=False)``; SciPy 1.18
    removed ``disp`` (deprecated since 1.16, where ``disp=False`` computes
    the same square root and only adds the error estimate the code drops),
    so the port calls ``sqrtm(m)``, which returns the root alone in every
    version."""
    import warnings

    mu1, sigma1 = gaussian_stats(feats_a)
    mu2, sigma2 = gaussian_stats(feats_b)
    diff = mu1 - mu2
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        covmean = scipy.linalg.sqrtm(sigma1 @ sigma2)
    singular = any(
        issubclass(w.category, scipy.linalg.LinAlgWarning) for w in caught
    )
    if singular or not np.isfinite(covmean).all():
        offset = np.eye(sigma1.shape[0]) * eps
        with warnings.catch_warnings():
            # The regularized product can still be near-singular; its
            # LinAlgWarning must not leak.
            warnings.simplefilter("ignore")
            covmean = scipy.linalg.sqrtm((sigma1 + offset) @ (sigma2 + offset))
    if np.iscomplexobj(covmean):
        if not np.allclose(np.diagonal(covmean).imag, 0, atol=1e-3):
            raise ValueError(
                "frechet_distance: sqrtm produced a materially complex "
                f"result (max |imag| = {np.abs(covmean.imag).max():.3e}); "
                "the feature covariances are invalid"
            )
        covmean = covmean.real
    return float(diff @ diff + np.trace(sigma1) + np.trace(sigma2) - 2 * np.trace(covmean))


def kernel_distance(
    feats_a: np.ndarray,
    feats_b: np.ndarray,
    degree: int = 3,
    gamma: Optional[float] = None,
    coef0: float = 1.0,
) -> float:
    """KID: polynomial-kernel MMD^2 (cleanfid semantics)."""
    d = feats_a.shape[1]
    gamma = gamma if gamma is not None else 1.0 / d

    def k(x, y):
        return (gamma * x @ y.T + coef0) ** degree

    m, n = len(feats_a), len(feats_b)
    kxx = k(feats_a, feats_a)
    kyy = k(feats_b, feats_b)
    kxy = k(feats_a, feats_b)
    mmd = (
        (kxx.sum() - np.trace(kxx)) / (m * (m - 1))
        + (kyy.sum() - np.trace(kyy)) / (n * (n - 1))
        - 2 * kxy.mean()
    )
    return float(mmd)


def vgg_feature_extractor(
    lpips_weights: Optional[Path] = None, device="cpu",
) -> Optional[Callable[[np.ndarray], np.ndarray]]:
    """Pooled VGG16 conv5 features (needs assets/lpips_vgg.npz), on ``device``."""
    from .metrics import _normalize_input, get_lpips

    lp = get_lpips(lpips_weights)
    if lp is None:
        return None
    lp = lp.to(device)

    @torch.no_grad()
    def extract(images: np.ndarray) -> np.ndarray:
        x = torch.as_tensor(np.asarray(images, np.float32), device=lp.mean.device)
        with no_tf32():
            feats = lp.vgg(_normalize_input(x, lp.mean, lp.std))
        return feats[-1].mean(dim=(2, 3)).cpu().numpy()

    return extract


def vae_feature_extractor(
    vae,
    pool_to: int = 8,
    batch_size: int = 16,
) -> Callable[[np.ndarray], np.ndarray]:
    """Feature extractor over the SD-VAE *encoder* (an ``AutoencoderKL``
    module, on its device): latent means pooled to a (pool_to x pool_to x
    4) grid and flattened (256-d by default).

    The fallback when no VGG / Inception weights exist (reference
    counterpart: cleanfid's Inception at ``scripts/compute_fid.py:43-50``):
    the SD2.1 VAE encoder ships with the model checkpoint, so the eval sweep
    can always emit a learned-feature Frechet / kernel distance. Scores are
    comparable within and across runs of this framework — loudly keyed
    ``fid_vaefeat_*`` — never against published Inception-FID numbers."""
    device = vae.encoder.conv_in.weight.device

    @torch.no_grad()
    def encode(images: np.ndarray) -> np.ndarray:
        x = torch.as_tensor(np.asarray(images, np.float32), device=device)
        with no_tf32():
            # [0, 1] -> the VAE's [-1, 1]; features = the posterior means.
            mean = vae.encode(x * 2.0 - 1.0).mean.float()
        b, h, w, c = mean.shape
        assert h % pool_to == 0 and w % pool_to == 0, (
            f"latent {h}x{w} not divisible by pool_to={pool_to}"
        )
        pooled = mean.reshape(b, pool_to, h // pool_to, pool_to, w // pool_to, c).mean(dim=(2, 4))
        return pooled.reshape(b, pool_to * pool_to * c).cpu().numpy()

    def extract(images: np.ndarray) -> np.ndarray:
        return np.concatenate([encode(images[i : i + batch_size])
                               for i in range(0, len(images), batch_size)])

    return extract


def resolve_vae_params(
    vae_checkpoint: Optional[Path] = None,
    allow_init_vae: bool = False,
    device="cpu",
):
    """The SD-VAE (default ``AutoencoderKLCfg``, f32, on ``device``) for the
    learned-feature fallbacks (``fid_vaefeat_*`` / ``lpips_vaefeat*``) ->
    ``(vae, key_suffix)`` or ``(None, None)``.

    Resolution order matches ``scripts/compute_fid.py``'s module docstring:
    a reference torch checkpoint (ships with the model -> ``"vaefeat"``),
    else — only on explicit opt-in — the port's seed-0 init (a fixed random
    projection, smoke tests / relative comparisons only ->
    ``"vaefeat_randominit"``)."""
    if vae_checkpoint is None and not allow_init_vae:
        return None, None
    from ..builder import init_params, load_reference_ckpt
    from ..models.vae import AutoencoderKL, AutoencoderKLCfg

    with torch.device("meta"):
        vae = AutoencoderKL(AutoencoderKLCfg())
    vae = vae.to_empty(device=device)
    init_params(vae, 0)
    vae.eval().requires_grad_(False)
    if vae_checkpoint is not None:
        load_reference_ckpt(vae_checkpoint, autoencoder=vae)
        print(f"VAE features: SD-VAE encoder from {vae_checkpoint} "
              "(…_vaefeat*; not comparable to published LPIPS/FID)")
        return vae, "vaefeat"
    print("VAE features: RANDOM-INIT VAE encoder (allow_init_vae) — "
          "a fixed random projection, relative comparisons only")
    return vae, "vaefeat_randominit"


def fid_between_dirs(
    dir_a: Path,
    dir_b: Path,
    extractor: Optional[Callable] = None,
    batch_size: int = 32,
) -> dict:
    """Directory-vs-directory FID/KID (reference ``compute_fid.py:43-50``)."""
    from ..utils.image_io import load_image

    extractor = extractor or vgg_feature_extractor()
    if extractor is None:
        raise RuntimeError(
            "No feature extractor available: convert LPIPS/VGG weights first "
            "(utils/lpips_convert.py)."
        )

    def features_of(directory: Path) -> np.ndarray:
        paths = sorted(Path(directory).rglob("*.png"))
        feats = []
        for i in range(0, len(paths), batch_size):
            batch = np.stack([load_image(p) for p in paths[i : i + batch_size]])
            feats.append(extractor(batch))
        return np.concatenate(feats)

    fa = features_of(dir_a)
    fb = features_of(dir_b)
    return {
        "fid": frechet_distance(fa, fb),
        "kid": kernel_distance(fa, fb),
        "num_a": len(fa),
        "num_b": len(fb),
    }
