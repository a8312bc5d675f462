"""Ray / positional encodings (counterpart of
``mvldm_tpu/models/encodings.py``). Pure functions, no parameters."""

from __future__ import annotations

import math

import torch


def positional_encoding(samples: torch.Tensor, num_octaves: int) -> torch.Tensor:
    """Sine/cosine octave encoding ordered (dim, frequency, phase): per input
    dim, per octave, [sin, cos]; frequencies 2*pi*2^k."""
    octaves = torch.arange(num_octaves, dtype=samples.dtype, device=samples.device)
    frequencies = 2.0 * math.pi * 2.0 ** octaves
    phases = torch.tensor([0.0, 0.5 * math.pi], dtype=samples.dtype,
                          device=samples.device)
    scaled = samples[..., None, None] * frequencies[:, None] + phases
    return torch.sin(scaled).reshape(*samples.shape[:-1], -1)


def _srt_positional_encoding(coords: torch.Tensor, num_octaves: int,
                             start_octave: int = 0) -> torch.Tensor:
    """SRT ordering: all sines for every (dim, octave), then all cosines."""
    octaves = torch.arange(start_octave, start_octave + num_octaves,
                           dtype=coords.dtype, device=coords.device)
    scaled = coords[..., None] * (2.0 ** octaves * math.pi)
    sines = torch.sin(scaled).reshape(*coords.shape[:-1], -1)
    cosines = torch.cos(scaled).reshape(*coords.shape[:-1], -1)
    return torch.cat([sines, cosines], dim=-1)


def srt_ray_encode(pos: torch.Tensor, rays: torch.Tensor, pos_octaves: int = 8,
                   ray_octaves: int = 4) -> torch.Tensor:
    """SRT RayEncoder, point-list branch: origins and directions encoded
    separately and concatenated."""
    return torch.cat([_srt_positional_encoding(pos, pos_octaves),
                      _srt_positional_encoding(rays, ray_octaves)], dim=-1)
