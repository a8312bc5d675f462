"""One-time LPIPS/DISTS weight conversion (run on a machine with network
access).

Produces ``assets/lpips_vgg.npz`` consumed by ``evaluation/metrics``:
torchvision VGG16 conv weights (OIHW -> HWIO), the lpips package's linear
calibration heads, and — with ``--dists`` — the DISTS_pytorch package's
learned per-channel alpha/beta weights (evaluation/metrics.DISTS refuses
to run without them; uniform weights would not be DISTS).

    python -m mvldm_tpu_torch.utils.lpips_convert --dists --output assets/lpips_vgg.npz

The port's copy of ``mvldm_tpu/utils/lpips_convert.py``: the same
``.npz`` (HWIO kernels, the layout both packages' ``evaluation/metrics``
read). The ``lpips`` / ``DISTS_pytorch`` packages it reads from, and their
weights, are downloads: without them it fails on the import.
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np

VGG16_BLOCKS = [(64, 2), (128, 2), (256, 3), (512, 3), (512, 3)]


def convert_dists(data: dict) -> None:
    """Add DISTS' learned alpha/beta (DISTS_pytorch ships them as buffers
    of its model / in its weights.pt)."""
    import torch
    from DISTS_pytorch import DISTS as TorchDISTS

    model = TorchDISTS()
    # (1, sum(chns), 1, 1) -> flat (sum(chns),)
    data["dists_alpha"] = model.alpha.detach().numpy().reshape(-1)
    data["dists_beta"] = model.beta.detach().numpy().reshape(-1)


def convert(output: Path, dists: bool = False) -> None:
    import lpips  # requires the lpips pip package + torchvision weights
    import torch

    model = lpips.LPIPS(net="vgg")
    vgg_features = model.net.slice1  # torchvision VGG16 features module list
    # Collect conv layers in order from the full feature extractor.
    convs = [
        m
        for slice_ in (model.net.slice1, model.net.slice2, model.net.slice3,
                       model.net.slice4, model.net.slice5)
        for m in slice_.modules()
        if isinstance(m, torch.nn.Conv2d)
    ]
    data = {}
    idx = 0
    for block, (_, n_convs) in enumerate(VGG16_BLOCKS):
        for c in range(n_convs):
            conv = convs[idx]
            idx += 1
            name = f"conv{block + 1}_{c + 1}"
            data[f"{name}_kernel"] = (
                conv.weight.detach().numpy().transpose(2, 3, 1, 0)
            )
            data[f"{name}_bias"] = conv.bias.detach().numpy()
    for i, lin in enumerate(model.lins):
        data[f"lin{i}"] = lin.model[1].weight.detach().numpy().reshape(-1)
    if dists:
        convert_dists(data)
    output.parent.mkdir(parents=True, exist_ok=True)
    np.savez(output, **data)
    print(f"Wrote {output}")


if __name__ == "__main__":
    parser = argparse.ArgumentParser()
    parser.add_argument("--output", type=Path, default=Path("assets/lpips_vgg.npz"))
    parser.add_argument("--dists", action="store_true",
                        help="also convert DISTS alpha/beta (DISTS_pytorch)")
    args = parser.parse_args()
    convert(args.output, dists=args.dists)
