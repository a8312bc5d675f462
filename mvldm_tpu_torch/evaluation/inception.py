"""InceptionV3 feature extractor in the FID convention (counterpart of
``mvldm_tpu/evaluation/inception.py``).

The reference computes FID with torchmetrics' FrechetInceptionDistance and
cleanfid; both run the TF-Inception-2015 port (pytorch-fid's
``pt_inception-2015-12-05`` weights) — the torchvision ``inception_v3``
topology with the FID modifications:

* every in-block 3x3/stride-1 average pool uses ``count_include_pad=False``
  (FIDInceptionA / FIDInceptionC / FIDInceptionE_1);
* the LAST Inception-E block (``Mixed_7c``) pools its branch with MAX
  instead of average (FIDInceptionE_2);
* features are the 2048-d global average pool ("pool3"), inputs resized to
  299x299 bilinear (no antialias, half-pixel centers) and scaled to [-1, 1].

The network is built from the same converted weights file as the JAX
package's (``assets/inception_fid.npz``: the torch state_dict tensors
verbatim), driven by the declarative :data:`CONV_DEFS` table, with cuDNN's
convolutions in f32 (TF32 off). The resize is ``F.interpolate(bilinear,
align_corners=False, antialias=False)``; ``jax.image.resize`` renormalises
its triangle kernel over the taps inside the image where torch clamps the
source index to the edge, which for an upsampling (256 -> 299) gives the
edge pixel in both (``tests/test_torch_port_metrics.py`` holds the two).
"""

from __future__ import annotations

from pathlib import Path
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.f32_route import no_tf32

BN_EPS = 1e-3
DEFAULT_WEIGHTS = Path("assets/inception_fid.npz")

# path -> (in_ch, out_ch, (kh, kw), (sh, sw), (ph, pw)); torchvision module
# paths so converted torch state_dict keys map 1:1.
ConvDef = Tuple[int, int, Tuple[int, int], Tuple[int, int], Tuple[int, int]]


def _conv_defs() -> Dict[str, ConvDef]:
    d: Dict[str, ConvDef] = {}

    def add(path, cin, cout, k, s=1, p=0):
        to2 = lambda v: (v, v) if isinstance(v, int) else tuple(v)
        d[path] = (cin, cout, to2(k), to2(s), to2(p))

    # Stem (torchvision inception_v3).
    add("Conv2d_1a_3x3", 3, 32, 3, 2)
    add("Conv2d_2a_3x3", 32, 32, 3)
    add("Conv2d_2b_3x3", 32, 64, 3, 1, 1)
    add("Conv2d_3b_1x1", 64, 80, 1)
    add("Conv2d_4a_3x3", 80, 192, 3)
    # Inception-A x3.
    for name, cin, pool in (
        ("Mixed_5b", 192, 32), ("Mixed_5c", 256, 64), ("Mixed_5d", 288, 64)
    ):
        add(f"{name}.branch1x1", cin, 64, 1)
        add(f"{name}.branch5x5_1", cin, 48, 1)
        add(f"{name}.branch5x5_2", 48, 64, 5, 1, 2)
        add(f"{name}.branch3x3dbl_1", cin, 64, 1)
        add(f"{name}.branch3x3dbl_2", 64, 96, 3, 1, 1)
        add(f"{name}.branch3x3dbl_3", 96, 96, 3, 1, 1)
        add(f"{name}.branch_pool", cin, pool, 1)
    # Inception-B (grid reduction 35 -> 17).
    add("Mixed_6a.branch3x3", 288, 384, 3, 2)
    add("Mixed_6a.branch3x3dbl_1", 288, 64, 1)
    add("Mixed_6a.branch3x3dbl_2", 64, 96, 3, 1, 1)
    add("Mixed_6a.branch3x3dbl_3", 96, 96, 3, 2)
    # Inception-C x4 (factorized 7x7).
    for name, c7 in (
        ("Mixed_6b", 128), ("Mixed_6c", 160), ("Mixed_6d", 160),
        ("Mixed_6e", 192),
    ):
        add(f"{name}.branch1x1", 768, 192, 1)
        add(f"{name}.branch7x7_1", 768, c7, 1)
        add(f"{name}.branch7x7_2", c7, c7, (1, 7), 1, (0, 3))
        add(f"{name}.branch7x7_3", c7, 192, (7, 1), 1, (3, 0))
        add(f"{name}.branch7x7dbl_1", 768, c7, 1)
        add(f"{name}.branch7x7dbl_2", c7, c7, (7, 1), 1, (3, 0))
        add(f"{name}.branch7x7dbl_3", c7, c7, (1, 7), 1, (0, 3))
        add(f"{name}.branch7x7dbl_4", c7, c7, (7, 1), 1, (3, 0))
        add(f"{name}.branch7x7dbl_5", c7, 192, (1, 7), 1, (0, 3))
        add(f"{name}.branch_pool", 768, 192, 1)
    # Inception-D (grid reduction 17 -> 8).
    add("Mixed_7a.branch3x3_1", 768, 192, 1)
    add("Mixed_7a.branch3x3_2", 192, 320, 3, 2)
    add("Mixed_7a.branch7x7x3_1", 768, 192, 1)
    add("Mixed_7a.branch7x7x3_2", 192, 192, (1, 7), 1, (0, 3))
    add("Mixed_7a.branch7x7x3_3", 192, 192, (7, 1), 1, (3, 0))
    add("Mixed_7a.branch7x7x3_4", 192, 192, 3, 2)
    # Inception-E x2 (Mixed_7c is FIDInceptionE_2: max branch pool).
    for name, cin in (("Mixed_7b", 1280), ("Mixed_7c", 2048)):
        add(f"{name}.branch1x1", cin, 320, 1)
        add(f"{name}.branch3x3_1", cin, 384, 1)
        add(f"{name}.branch3x3_2a", 384, 384, (1, 3), 1, (0, 1))
        add(f"{name}.branch3x3_2b", 384, 384, (3, 1), 1, (1, 0))
        add(f"{name}.branch3x3dbl_1", cin, 448, 1)
        add(f"{name}.branch3x3dbl_2", 448, 384, 3, 1, 1)
        add(f"{name}.branch3x3dbl_3a", 384, 384, (1, 3), 1, (0, 1))
        add(f"{name}.branch3x3dbl_3b", 384, 384, (3, 1), 1, (1, 0))
        add(f"{name}.branch_pool", cin, 192, 1)
    return d


CONV_DEFS: Dict[str, ConvDef] = _conv_defs()


def expected_state_keys() -> Dict[str, Tuple[int, ...]]:
    """Exact torch ``state_dict`` key -> shape census for every tensor the
    extractor consumes (conv OIHW weight + BN affine/running stats per
    BasicConv2d). The converter validates against this; the synthesized
    golden test generates from it."""
    census: Dict[str, Tuple[int, ...]] = {}
    for path, (cin, cout, (kh, kw), _, _) in CONV_DEFS.items():
        census[f"{path}.conv.weight"] = (cout, cin, kh, kw)
        for stat in ("weight", "bias", "running_mean", "running_var"):
            census[f"{path}.bn.{stat}"] = (cout,)
    return census


class InceptionV3Features:
    """The FID InceptionV3 pool3 extractor from a converted npz.

    The npz holds the torch state_dict tensors verbatim (OIHW convs, raw BN
    stats); at load the BN is folded into a per-channel (scale, shift) after
    the conv — inference-equivalent to torch's eval-mode batch_norm at
    eps=1e-3. The weights live on ``device``."""

    def __init__(self, state: Dict[str, np.ndarray], device="cpu"):
        missing = [k for k in expected_state_keys() if k not in state]
        if missing:
            raise KeyError(
                f"inception weights missing {len(missing)} tensors, e.g. "
                f"{missing[:3]} — re-run utils/inception_convert.py"
            )
        self.device = torch.device(device)
        self.folded = {}
        for path, (cin, cout, k, s, p) in CONV_DEFS.items():
            w = np.asarray(state[f"{path}.conv.weight"], np.float32)
            gamma = np.asarray(state[f"{path}.bn.weight"], np.float32)
            beta = np.asarray(state[f"{path}.bn.bias"], np.float32)
            mean = np.asarray(state[f"{path}.bn.running_mean"], np.float32)
            var = np.asarray(state[f"{path}.bn.running_var"], np.float32)
            if w.shape != (cout, cin) + k:
                raise ValueError(f"{path}: conv shape {w.shape}")
            scale = gamma / np.sqrt(var + BN_EPS)
            shift = beta - mean * scale
            self.folded[path] = tuple(
                torch.from_numpy(np.ascontiguousarray(a)).to(self.device)
                for a in (w, scale.reshape(-1, 1, 1), shift.reshape(-1, 1, 1)))

    # --- ops (NCHW) --------------------------------------------------------
    def _bc(self, path, x):
        """BasicConv2d: conv (no bias) + folded BN + relu."""
        weight, scale, shift = self.folded[path]
        _, _, _, stride, padding = CONV_DEFS[path]
        return F.relu(F.conv2d(x, weight, stride=stride, padding=padding) * scale + shift)

    @staticmethod
    def _max_pool(x, stride=2, padding=0):
        return F.max_pool2d(x, 3, stride, padding)

    @staticmethod
    def _avg_pool_ex(x):
        """3x3 / stride 1 / pad 1 average pool with count_include_pad=False
        (the FID block modification: edge windows divide by the number of
        VALID taps, not 9)."""
        return F.avg_pool2d(x, 3, 1, 1, count_include_pad=False)

    # --- blocks (torchvision forward order; concat on channels) -----------
    def _block_a(self, name, x):
        b1 = self._bc(f"{name}.branch1x1", x)
        b5 = self._bc(f"{name}.branch5x5_2", self._bc(f"{name}.branch5x5_1", x))
        b3 = self._bc(f"{name}.branch3x3dbl_1", x)
        b3 = self._bc(f"{name}.branch3x3dbl_2", b3)
        b3 = self._bc(f"{name}.branch3x3dbl_3", b3)
        bp = self._bc(f"{name}.branch_pool", self._avg_pool_ex(x))
        return torch.cat([b1, b5, b3, bp], dim=1)

    def _block_b(self, name, x):
        b3 = self._bc(f"{name}.branch3x3", x)
        bd = self._bc(f"{name}.branch3x3dbl_1", x)
        bd = self._bc(f"{name}.branch3x3dbl_2", bd)
        bd = self._bc(f"{name}.branch3x3dbl_3", bd)
        return torch.cat([b3, bd, self._max_pool(x)], dim=1)

    def _block_c(self, name, x):
        b1 = self._bc(f"{name}.branch1x1", x)
        b7 = self._bc(f"{name}.branch7x7_1", x)
        b7 = self._bc(f"{name}.branch7x7_2", b7)
        b7 = self._bc(f"{name}.branch7x7_3", b7)
        bd = self._bc(f"{name}.branch7x7dbl_1", x)
        for i in (2, 3, 4, 5):
            bd = self._bc(f"{name}.branch7x7dbl_{i}", bd)
        bp = self._bc(f"{name}.branch_pool", self._avg_pool_ex(x))
        return torch.cat([b1, b7, bd, bp], dim=1)

    def _block_d(self, name, x):
        b3 = self._bc(f"{name}.branch3x3_2", self._bc(f"{name}.branch3x3_1", x))
        b7 = self._bc(f"{name}.branch7x7x3_1", x)
        for i in (2, 3, 4):
            b7 = self._bc(f"{name}.branch7x7x3_{i}", b7)
        return torch.cat([b3, b7, self._max_pool(x)], dim=1)

    def _block_e(self, name, x, pool):
        b1 = self._bc(f"{name}.branch1x1", x)
        b3 = self._bc(f"{name}.branch3x3_1", x)
        b3 = torch.cat([self._bc(f"{name}.branch3x3_2a", b3),
                        self._bc(f"{name}.branch3x3_2b", b3)], dim=1)
        bd = self._bc(f"{name}.branch3x3dbl_2", self._bc(f"{name}.branch3x3dbl_1", x))
        bd = torch.cat([self._bc(f"{name}.branch3x3dbl_3a", bd),
                        self._bc(f"{name}.branch3x3dbl_3b", bd)], dim=1)
        pooled = (self._max_pool(x, stride=1, padding=1) if pool == "max"
                  else self._avg_pool_ex(x))
        bp = self._bc(f"{name}.branch_pool", pooled)
        return torch.cat([b1, b3, bd, bp], dim=1)

    # --- forward -----------------------------------------------------------
    def features(self, x: torch.Tensor) -> torch.Tensor:
        """x: (b, 3, 299, 299) already in [-1, 1] -> (b, 2048) pool3."""
        h = self._bc("Conv2d_1a_3x3", x)
        h = self._bc("Conv2d_2a_3x3", h)
        h = self._bc("Conv2d_2b_3x3", h)
        h = self._max_pool(h)
        h = self._bc("Conv2d_3b_1x1", h)
        h = self._bc("Conv2d_4a_3x3", h)
        h = self._max_pool(h)
        for name in ("Mixed_5b", "Mixed_5c", "Mixed_5d"):
            h = self._block_a(name, h)
        h = self._block_b("Mixed_6a", h)
        for name in ("Mixed_6b", "Mixed_6c", "Mixed_6d", "Mixed_6e"):
            h = self._block_c(name, h)
        h = self._block_d("Mixed_7a", h)
        h = self._block_e("Mixed_7b", h, pool="avg")
        h = self._block_e("Mixed_7c", h, pool="max")  # FIDInceptionE_2
        return h.mean(dim=(2, 3))

    @staticmethod
    def preprocess(x01: torch.Tensor) -> torch.Tensor:
        """(b, h, w, 3) in [0, 1] -> (b, 3, 299, 299) in [-1, 1]: bilinear,
        half-pixel centers, no antialias (pytorch-fid ``InceptionV3.forward``)."""
        x = F.interpolate(x01.permute(0, 3, 1, 2), size=(299, 299), mode="bilinear",
                          align_corners=False, antialias=False)
        return x * 2.0 - 1.0

    @torch.no_grad()
    def __call__(self, images: np.ndarray, batch_size: int = 32) -> np.ndarray:
        """images: (n, h, w, 3) in [0, 1] -> (n, 2048) float32 features."""
        feats = []
        with no_tf32():
            for i in range(0, len(images), batch_size):
                x = torch.as_tensor(np.asarray(images[i : i + batch_size], np.float32),
                                    device=self.device)
                feats.append(self.features(self.preprocess(x)).cpu().numpy())
        return np.concatenate(feats)


def inception_feature_extractor(
    weights_path: Optional[Path] = None, device="cpu",
) -> Optional[Callable[[np.ndarray], np.ndarray]]:
    """FID-convention InceptionV3 extractor on ``device``, or None when no
    converted weights file exists (convert once with
    ``utils/inception_convert.py`` where there is network). With it,
    ``compute_fid`` produces standard, Inception-comparable FID/KID."""
    path = Path(weights_path or DEFAULT_WEIGHTS)
    if not path.exists():
        return None
    state = dict(np.load(path))
    return InceptionV3Features(state, device)
