"""Image quality metrics (counterpart of ``mvldm_tpu/evaluation/metrics.py``).

The reference's metric surface (``src/evaluation/metrics.py:17-73``: PSNR,
SSIM, LPIPS-VGG, DISTS) on torch tensors, on whatever device the inputs and
modules are (the CLIs put them on the card):

* :func:`compute_psnr` — the mean-MSE formulation.
* :func:`compute_ssim` — a Gaussian window (11, sigma 1.5, VALID borders,
  no sample covariance), skimage's settings as the reference uses them.
* :class:`LPIPS` — VGG16 features from a local ``lpips_vgg.npz`` (the JAX
  package's file: HWIO kernels, converted once at load); without it
  :func:`get_lpips` returns None.
* :class:`DISTS` — the VGG16 trunk with L2 pooling and the learned
  alpha / beta from the same file; refused loudly without them.
* :class:`VAEFeatureDistance` — the LPIPS formula over the SD-VAE
  encoder's posterior means, keyed ``lpips_vaefeat*``.

No hand kernel lives here: convolutions are cuDNN's. The f32 work runs
with TF32 off (``ops.f32_route.no_tf32``), so the card computes what the
CPU does.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.f32_route import no_tf32


def _as_tensor(x, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x) if not torch.is_tensor(x) else x,
                           dtype=torch.float32, device=device)


def compute_psnr(ground_truth: torch.Tensor, predicted: torch.Tensor) -> torch.Tensor:
    """PSNR over batched (…, h, w, c) images in [0, 1] (reference
    ``metrics.py:17-24``)."""
    ground_truth = ground_truth.clamp(0.0, 1.0)
    predicted = predicted.clamp(0.0, 1.0)
    mse = ((ground_truth - predicted) ** 2).mean(dim=(-3, -2, -1))
    return -10.0 * torch.log10(mse.clamp(min=1e-12))


def _gaussian_kernel(size: int = 11, sigma: float = 1.5) -> np.ndarray:
    x = np.arange(size) - (size - 1) / 2
    g = np.exp(-(x**2) / (2 * sigma**2))
    g /= g.sum()
    return np.outer(g, g)


def compute_ssim(ground_truth: torch.Tensor, predicted: torch.Tensor, win_size: int = 11,
                 sigma: float = 1.5, k1: float = 0.01, k2: float = 0.03,
                 data_range: float = 1.0) -> torch.Tensor:
    """Gaussian-weighted SSIM over (…, h, w, c) images in [0, 1], averaged
    over channels and VALID window positions (reference ``metrics.py:58-73``:
    gaussian_weights=True, channel_axis).

    The window sums and the map run in float64, the result is float32: the
    variance terms are differences of nearly equal window sums, and torch's
    f32 depthwise convolution rounds them ~1e-6 (relative), which that
    difference makes ~1e-5 of the SSIM, where XLA's f32 sum stays within
    1e-7 of float64."""
    x = ground_truth.double()
    y = predicted.double()
    *batch, h, w, c = x.shape
    kernel = torch.as_tensor(_gaussian_kernel(win_size, sigma), dtype=torch.float64,
                             device=x.device).expand(c, 1, win_size, win_size)

    def filt(img):
        out = F.conv2d(img.reshape(-1, h, w, c).permute(0, 3, 1, 2), kernel, groups=c)
        return out.permute(0, 2, 3, 1).reshape(*batch, *out.shape[2:], c)

    mu_x, mu_y = filt(x), filt(y)
    mu_xx = filt(x * x) - mu_x**2
    mu_yy = filt(y * y) - mu_y**2
    mu_xy = filt(x * y) - mu_x * mu_y
    c1 = (k1 * data_range) ** 2
    c2 = (k2 * data_range) ** 2
    ssim_map = ((2 * mu_x * mu_y + c1) * (2 * mu_xy + c2)) / (
        (mu_x**2 + mu_y**2 + c1) * (mu_xx + mu_yy + c2))
    return ssim_map.mean(dim=(-3, -2, -1)).float()


VGG_LAYERS = [(64, 2), (128, 2), (256, 3), (512, 3), (512, 3)]


def _vgg_weights(data) -> dict:
    """{convN_M: (OIHW weight, bias)} from the npz's HWIO kernels."""
    out = {}
    for block, (_, n_convs) in enumerate(VGG_LAYERS):
        for c in range(n_convs):
            name = f"conv{block + 1}_{c + 1}"
            kernel = np.asarray(data[f"{name}_kernel"], np.float32).transpose(3, 2, 0, 1)
            out[name] = (torch.from_numpy(np.ascontiguousarray(kernel)),
                         torch.from_numpy(np.asarray(data[f"{name}_bias"], np.float32)))
    return out


class _VGG16Features(nn.Module):
    """VGG16 conv stacks 1-5 (ReLU after each conv, 2x2 max pool between
    blocks) from converted weights; NCHW in, the five blocks' last ReLU
    out."""

    def __init__(self, weights: dict):
        super().__init__()
        for name, (w, b) in weights.items():
            self.register_buffer(f"{name}_weight", w)
            self.register_buffer(f"{name}_bias", b)

    def conv(self, name: str, h: torch.Tensor) -> torch.Tensor:
        return F.relu(F.conv2d(h, getattr(self, f"{name}_weight"), getattr(self, f"{name}_bias"),
                               padding=1))

    def forward(self, x: torch.Tensor):
        feats = []
        h = x
        for block, (_, n_convs) in enumerate(VGG_LAYERS):
            for c in range(n_convs):
                h = self.conv(f"conv{block + 1}_{c + 1}", h)
            feats.append(h)
            if block < 4:
                h = F.max_pool2d(h, 2, 2)
        return feats


def _normalize_input(x: torch.Tensor, mean: torch.Tensor, std: torch.Tensor) -> torch.Tensor:
    """(b, h, w, 3) in [0, 1] -> ImageNet-normalized NCHW."""
    return ((x - mean) / std).permute(0, 3, 1, 2)


class LPIPS(nn.Module):
    """LPIPS (VGG) distance. Requires converted weights on disk."""

    MEAN = np.asarray([0.485, 0.456, 0.406], dtype=np.float32)
    STD = np.asarray([0.229, 0.224, 0.225], dtype=np.float32)

    def __init__(self, weights_path: Optional[Path] = None):
        super().__init__()
        path = Path(weights_path or "assets/lpips_vgg.npz")
        if not path.exists():
            raise FileNotFoundError(
                f"LPIPS weights not found at {path}. This environment has no "
                "network access; convert them once with "
                "utils/lpips_convert.py on a connected machine."
            )
        data = np.load(path)
        self.vgg = _VGG16Features(_vgg_weights(data))
        for i in range(5):
            self.register_buffer(f"lin{i}", torch.from_numpy(np.asarray(data[f"lin{i}"],
                                                                        np.float32)))
        self.register_buffer("mean", torch.from_numpy(self.MEAN))
        self.register_buffer("std", torch.from_numpy(self.STD))

    @torch.no_grad()
    def forward(self, x, y) -> torch.Tensor:
        """x, y: (b, h, w, 3) in [0, 1] -> (b,) LPIPS distances."""
        x, y = _as_tensor(x, self.mean.device), _as_tensor(y, self.mean.device)
        with no_tf32():
            fx = self.vgg(_normalize_input(x, self.mean, self.std))
            fy = self.vgg(_normalize_input(y, self.mean, self.std))
        total = 0.0
        for i, (a, b) in enumerate(zip(fx, fy)):
            a = a / torch.sqrt(torch.sum(a**2, dim=1, keepdim=True) + 1e-10)
            b = b / torch.sqrt(torch.sum(b**2, dim=1, keepdim=True) + 1e-10)
            d = (a - b) ** 2
            w = getattr(self, f"lin{i}").reshape(1, -1, 1, 1)
            total = total + torch.sum(d * w, dim=1).mean(dim=(1, 2))
        return total


def get_lpips(weights_path: Optional[Path] = None) -> Optional[LPIPS]:
    """LPIPS if weights are available, else None (caller skips the metric)."""
    try:
        return LPIPS(weights_path)
    except FileNotFoundError:
        return None


def _l2_pool_kernel(filter_size: int = 3) -> np.ndarray:
    """DISTS' L2-pooling window: a Hann window (anti-aliased downsampling,
    Zhang 2019 'Making Convolutional Networks Shift-Invariant Again')."""
    a = np.hanning(filter_size + 2)[1:-1]
    g = np.outer(a, a)
    return (g / g.sum()).astype(np.float32)


def _l2_pool(x: torch.Tensor, filter_size: int = 3, stride: int = 2) -> torch.Tensor:
    """sqrt(hann_conv(x^2)) on NCHW: the pooling DISTS substitutes for max-pool."""
    c = x.shape[1]
    k = torch.from_numpy(_l2_pool_kernel(filter_size)).to(x.device).expand(
        c, 1, filter_size, filter_size)
    pooled = F.conv2d(x * x, k, stride=stride, padding=1, groups=c)
    return torch.sqrt(pooled.clamp(min=1e-12))


class DISTS(nn.Module):
    """Deep Image Structure and Texture Similarity (Ding et al. 2020), as
    the reference computes it via the DISTS_pytorch package (reference
    ``metrics.py:28-40``): a VGG16 trunk with L2 pooling in place of max
    pool, stages [input, conv1_2, conv2_2, conv3_3, conv4_3, conv5_3],
    per-channel texture (mean) and structure (covariance) terms combined
    with the learned alpha / beta weights.

    Requires ``dists_alpha`` / ``dists_beta`` in the converted weights file:
    without the learned weights the metric is not DISTS, so construction
    fails loudly instead of substituting uniform weights.
    """

    C1 = 1e-6
    C2 = 1e-6
    CHNS = [3, 64, 128, 256, 512, 512]

    def __init__(self, weights_path: Optional[Path] = None):
        super().__init__()
        path = Path(weights_path or "assets/lpips_vgg.npz")
        if not path.exists():
            raise FileNotFoundError(
                f"VGG weights not found at {path}; run utils/lpips_convert.py "
                "on a connected machine."
            )
        data = np.load(path)
        if "dists_alpha" not in data or "dists_beta" not in data:
            raise FileNotFoundError(
                f"{path} lacks the learned DISTS alpha/beta weights; "
                "re-run utils/lpips_convert.py with --dists (needs the "
                "DISTS_pytorch package). Refusing to substitute uniform "
                "weights — that would not be DISTS."
            )
        self.vgg = _VGG16Features(_vgg_weights(data))
        self.register_buffer("alpha", torch.from_numpy(
            np.asarray(data["dists_alpha"], np.float32).reshape(-1)))
        self.register_buffer("beta", torch.from_numpy(
            np.asarray(data["dists_beta"], np.float32).reshape(-1)))
        self.register_buffer("mean", torch.from_numpy(LPIPS.MEAN))
        self.register_buffer("std", torch.from_numpy(LPIPS.STD))

    def _features(self, x: torch.Tensor) -> list:
        """x: (b, h, w, 3) in [0, 1] -> NCHW [x, conv1_2, ..., conv5_3] with
        L2 pooling between blocks (DISTS forward_once)."""
        feats = [x.permute(0, 3, 1, 2)]
        h = _normalize_input(x, self.mean, self.std)
        for block, (_, n_convs) in enumerate(VGG_LAYERS):
            if block > 0:
                h = _l2_pool(h)
            for c in range(n_convs):
                h = self.vgg.conv(f"conv{block + 1}_{c + 1}", h)
            feats.append(h)
        return feats

    @torch.no_grad()
    def forward(self, x, y) -> torch.Tensor:
        """x, y: (b, h, w, 3) in [0, 1] -> (b,) DISTS distances (lower is
        more similar)."""
        x, y = _as_tensor(x, self.alpha.device), _as_tensor(y, self.alpha.device)
        with no_tf32():
            fx, fy = self._features(x), self._features(y)
        w_sum = self.alpha.sum() + self.beta.sum()
        alpha = torch.split(self.alpha / w_sum, self.CHNS)
        beta = torch.split(self.beta / w_sum, self.CHNS)
        dist1 = dist2 = 0.0
        for j, (a, b) in enumerate(zip(fx, fy)):
            mu_a, mu_b = a.mean(dim=(2, 3)), b.mean(dim=(2, 3))
            texture = (2 * mu_a * mu_b + self.C1) / (mu_a**2 + mu_b**2 + self.C1)
            var_a = a.var(dim=(2, 3), unbiased=False)
            var_b = b.var(dim=(2, 3), unbiased=False)
            cov = (a * b).mean(dim=(2, 3)) - mu_a * mu_b
            structure = (2 * cov + self.C2) / (var_a + var_b + self.C2)
            dist1 = dist1 + torch.sum(alpha[j][None, :] * texture, dim=-1)
            dist2 = dist2 + torch.sum(beta[j][None, :] * structure, dim=-1)
        return 1.0 - (dist1 + dist2)


def get_dists(weights_path: Optional[Path] = None) -> Optional[DISTS]:
    """Exact DISTS when converted weights (incl. learned alpha/beta) exist,
    else None with a loud one-time notice — never a silent skip."""
    try:
        return DISTS(weights_path)
    except FileNotFoundError as e:
        print(f"DISTS unavailable: {e}")
        return None


class VAEFeatureDistance:
    """Perceptual-distance fallback over the SD-VAE *encoder* features.

    The LPIPS formula (channel-unit-normalized feature difference, averaged
    over spatial positions) applied to the VAE encoder's posterior means
    instead of VGG activations — the fallback when no VGG / DISTS weights
    exist (the VAE ships with the model checkpoint). Scores are comparable
    within and between runs of this framework and are loudly keyed
    ``lpips_vaefeat*`` — never against published LPIPS numbers.

    ``vae`` is an ``AutoencoderKL`` module; it encodes in its own dtype on
    its own device (f32: the D = 512 attention through the f32 route's
    kernels on the card, TF32 off).
    """

    def __init__(self, vae):
        self.vae = vae

    @torch.no_grad()
    def __call__(self, x, y) -> torch.Tensor:
        """x, y: (b, h, w, 3) in [0, 1] -> (b,) feature distances."""
        device = self.vae.encoder.conv_in.weight.device

        def feats(img):
            with no_tf32():
                f = self.vae.encode(_as_tensor(img, device) * 2.0 - 1.0).mean.float()
            return f / torch.sqrt(torch.sum(f**2, dim=-1, keepdim=True) + 1e-10)

        fx, fy = feats(x), feats(y)
        return torch.sum((fx - fy) ** 2, dim=-1).mean(dim=(1, 2))
