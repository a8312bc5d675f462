"""One-time FID-Inception weight conversion (run on a machine with network
access).

Produces ``assets/inception_fid.npz`` consumed by
``evaluation/inception.InceptionV3Features`` — the TF-Inception-2015 port
the reference's FID stack runs (torchmetrics FrechetInceptionDistance at
``src/evaluation/metric_computer.py:22``, cleanfid at
``src/scripts/compute_fid.py:43-50``).

Accepted sources (``--source``), in preference order:

* pytorch-fid's ``pt_inception-2015-12-05-6726825d.pth``
  (https://github.com/mseitzer/pytorch-fid/releases) — the canonical FID
  weights; torchmetrics/torch-fidelity ship the same tensors.
* torchvision's ``inception_v3_google-0cc3c7bd.pth`` — the ImageNet
  torchvision port; FID numbers from it differ slightly from the canonical
  convention (documented by pytorch-fid), so prefer the file above.

Without ``--source`` it tries ``torchvision.models.inception_v3`` from the
local torchvision cache. Only the tensors the pool3 extractor consumes are
kept (no fc / AuxLogits); the key census is validated against
``evaluation.inception.expected_state_keys`` so a wrong or truncated file
fails loudly here, not at metric time.

    python -m mvldm_tpu_torch.utils.inception_convert \
        --source pt_inception-2015-12-05-6726825d.pth \
        --output assets/inception_fid.npz

The port's copy of ``mvldm_tpu/utils/inception_convert.py``:
``state_dict_to_npz_dict`` and ``--source <local .pth>`` run offline; the
default source (torchvision's download) needs the network.
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np

from ..evaluation.inception import expected_state_keys


def state_dict_to_npz_dict(sd) -> dict:
    """Filter + validate a torch state_dict (tensors or ndarrays) down to the
    exact census the extractor consumes."""
    census = expected_state_keys()
    out = {}
    missing = []
    for key, shape in census.items():
        if key not in sd:
            missing.append(key)
            continue
        t = sd[key]
        arr = np.asarray(t.detach().cpu().numpy() if hasattr(t, "detach") else t)
        if tuple(arr.shape) != shape:
            raise ValueError(
                f"{key}: shape {tuple(arr.shape)} != expected {shape}"
            )
        out[key] = arr.astype(np.float32)
    if missing:
        raise KeyError(
            f"source lacks {len(missing)} required tensors, e.g. "
            f"{missing[:3]} — is this an InceptionV3 checkpoint?"
        )
    return out


def convert(output: Path, source: Path | None = None) -> None:
    import torch

    if source is not None:
        obj = torch.load(source, map_location="cpu", weights_only=True)
        sd = obj.get("state_dict", obj) if isinstance(obj, dict) else obj
    else:
        from torchvision.models import Inception_V3_Weights, inception_v3

        sd = inception_v3(
            weights=Inception_V3_Weights.IMAGENET1K_V1, aux_logits=True
        ).state_dict()
        print(
            "NOTE: converting torchvision ImageNet weights; for numbers "
            "comparable to published FID prefer pytorch-fid's "
            "pt_inception-2015-12-05 file (--source)."
        )
    data = state_dict_to_npz_dict(sd)
    output.parent.mkdir(parents=True, exist_ok=True)
    np.savez(output, **data)
    print(f"Wrote {output} ({len(data)} tensors)")


if __name__ == "__main__":
    parser = argparse.ArgumentParser()
    parser.add_argument(
        "--output", type=Path, default=Path("assets/inception_fid.npz")
    )
    parser.add_argument(
        "--source", type=Path, default=None,
        help="pt_inception-2015-12-05*.pth or torchvision inception_v3 .pth",
    )
    args = parser.parse_args()
    convert(args.output, source=args.source)
