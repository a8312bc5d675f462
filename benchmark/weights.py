"""Seeded weights, made on the device in a few large calls.

Both the program and the plain reference get their weights from here,
keyed by the published parameter names: linear and convolution weights
N(0, 1 / fan_in), biases zero, norm scales one (the initialisation the
program's own seeded builds use), rounded once to the type they are
served in. Every cross-view block's output projection is random too, so
the cross-view attention acts on the output. The same seed on the same
device gives the same values, so the reference makes its own copy again
from the seed and takes nothing the program made.
"""

from __future__ import annotations

from typing import Dict, Iterable, Tuple

import torch

# Elements one generator call makes (float32: 1 GiB).
CALL_ELEMENTS = 1 << 28


def spec(named: Iterable[Tuple[str, torch.Tensor]]) -> Dict[str, Tuple[int, ...]]:
    """{name: shape} of a module's parameters, in sorted name order."""
    return {name: tuple(p.shape) for name, p in sorted(named)}


def make(shapes: Dict[str, Tuple[int, ...]], seed: int, device, dtype) -> Dict[str, torch.Tensor]:
    """Seeded weights for ``shapes`` on ``device`` in ``dtype``."""
    gen = torch.Generator(device).manual_seed(seed)
    out: Dict[str, torch.Tensor] = {}
    random = []
    for name, shape in shapes.items():
        if name.endswith("bias"):
            out[name] = torch.zeros(shape, device=device, dtype=dtype)
        elif len(shape) == 1:
            out[name] = torch.ones(shape, device=device, dtype=dtype)
        else:
            random.append((name, shape))
    # Consecutive weights share one draw of up to CALL_ELEMENTS values.
    group, size = [], 0
    for item in random + [None]:
        n = 0 if item is None else torch.Size(item[1]).numel()
        if group and (item is None or size + n > CALL_ELEMENTS):
            flat = torch.randn(size, generator=gen, device=device, dtype=torch.float32)
            offset = 0
            for name, shape in group:
                k = torch.Size(shape).numel()
                fan_in = k // shape[0]
                out[name] = (flat[offset:offset + k].view(shape) / fan_in ** 0.5).to(dtype)
                offset += k
            del flat
            group, size = [], 0
        if item is not None:
            group.append(item)
            size += n
    return out
