"""Model FLOPs, counted by ``torch.utils.flop_counter.FlopCounterMode`` on
the configuration's plain reference model (``reference.reference_of``)
built on the meta device: the same count whatever implements a layer in
the program (its hand kernels launch outside PyTorch's dispatcher, where
no counter sees them).
"""

from __future__ import annotations

from functools import lru_cache
from typing import Dict

import torch
from torch.utils.flop_counter import FlopCounterMode

from .reference import reference_of


class Counter:
    """FLOPs of the reference model of ``config`` (a configuration file's
    whole content) at given shapes."""

    def __init__(self, config: Dict):
        self.reference = reference_of(config)
        self.model_cfg = config["model"]
        with torch.device("meta"):
            self.model = self.reference.Model(self.model_cfg)
        self.unet = lru_cache(maxsize=None)(self._unet)
        self.encode = lru_cache(maxsize=None)(self._encode)
        self.decode = lru_cache(maxsize=None)(self._decode)

    @staticmethod
    def _count(fn) -> float:
        with FlopCounterMode(display=False) as counter:
            fn()
        return float(counter.get_total_flops())

    def _unet(self, b: int, v: int, hw: int, backward: bool = False) -> float:
        """One UNet forward over b rows of v views of hw x hw latents (and
        its backward to the weights and the input), on the inputs of the
        reference's ``unet_inputs``."""
        inputs = self.reference.unet_inputs(self.model_cfg, b, v, hw, backward)

        def run():
            self.model.requires_grad_(backward)
            with torch.set_grad_enabled(backward):
                out = self.model.denoiser(*inputs)
                if backward:
                    out.sum().backward()

        return self._count(run)

    def _encode(self, n: int, hw: int) -> float:
        self.model.requires_grad_(False)
        x = torch.empty(n, hw, hw, 3, device="meta")
        with torch.no_grad():
            return self._count(lambda: self.model.autoencoder.moments(x))

    def _decode(self, n: int, hw: int) -> float:
        self.model.requires_grad_(False)
        latent = self.model_cfg["autoencoder"]["kwargs"]["latent_channels"]
        z = torch.empty(n, hw // 8, hw // 8, latent, device="meta")
        with torch.no_grad():
            return self._count(lambda: self.model.autoencoder.decode(z))

    def launch(self, b: int, v_c: int, v_t: int, hw: int, steps: int) -> float:
        """A sampling launch of b rows: encode the v_c context images, then
        ``steps`` guided steps, each a forward over context and targets
        and one over the targets alone, then decode the targets."""
        lat = hw // 8
        return (self.encode(b * v_c, hw)
                + steps * (self.unet(b, v_c + v_t, lat) + self.unet(b, v_t, lat))
                + self.decode(b * v_t, hw))

    def train_step(self, b: int, v: int, hw: int) -> float:
        """A micro-step: the frozen VAE encode of every view, the UNet
        forward and backward; nothing recomputed."""
        return self.encode(b * v, hw) + self.unet(b, v, hw // 8, True)
