"""JAX parameter tree -> the port's state dict.

:func:`jax_to_torch_state_dict` is the inverse of the JAX package's
``convert_mvldm_checkpoint`` (``mvldm_tpu/utils/weight_convert.py``): it
turns ``{"unet": ..., "vae": ...}`` Flax parameter trees (nested dicts of
arrays) into a flat state dict with the reference Lightning checkpoint's
key names and torch layouts (``denoiser.unet.*``,
``denoiser.cross_attn_blocks_{encoder,mid,decoder}.*``, ``autoencoder.*``),
which the port's modules load with ``load_state_dict`` as it is.

Layouts: Flax HWIO conv kernels -> torch OIHW; Flax (in, out) dense kernels
-> torch (out, in); norm ``scale`` -> ``weight``. The standard cross-view
block (``multi_view_attention: standard``) keeps the JAX module's names, as
the reference converter has no mapping for it; its ``upscaler`` is a Flax
``ConvTranspose``, whose kernel is a torch ``ConvTranspose2d`` weight
flipped in space, laid out (in, out, kh, kw).
"""

from __future__ import annotations

import re
from typing import Any, Dict, List, Mapping, Tuple

import numpy as np
import torch

# (pattern, replacement) per path segment, matched in full; None drops it.
_SEGMENT_RULES = (
    (r"time_emb_(\d+)", r"time_embedding.linear_\1"),
    (r"(down|up)_(\d+)_res_(\d+)", r"\1_blocks.\2.resnets.\3"),
    (r"(down|up)_(\d+)_attn_(\d+)", r"\1_blocks.\2.attentions.\3"),
    (r"down_(\d+)_downsample", r"down_blocks.\1.downsamplers.0"),
    (r"up_(\d+)_upsample", r"up_blocks.\1.upsamplers.0"),
    (r"mid_res_(\d+)", r"mid_block.resnets.\1"),
    (r"mid_attn", r"mid_block.attentions.0"),
    (r"blocks_(\d+)", r"transformer_blocks.\1"),
    (r"to_out", r"to_out.0"),
    (r"net_(\d+)", r"net.\1"),
    (r"GroupNorm_0", None),
)
_CROSS_VIEW = (
    (r"down_(\d+)_cross_view", r"denoiser.cross_attn_blocks_encoder.\1"),
    (r"mid_cross_view", r"denoiser.cross_attn_blocks_mid.0"),
    (r"up_(\d+)_cross_view", r"denoiser.cross_attn_blocks_decoder.\1"),
)


def _flatten(tree: Mapping[str, Any], prefix: Tuple[str, ...] = ()
             ) -> List[Tuple[Tuple[str, ...], Any]]:
    out = []
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out.extend(_flatten(v, prefix + (k,)))
        else:
            out.append((prefix + (k,), v))
    return out


def _segment(seg: str):
    for pat, rep in _SEGMENT_RULES:
        if re.fullmatch(pat, seg):
            return None if rep is None else re.sub(pat, rep, seg)
    return seg


def _leaf(name: str, value: np.ndarray, module: str) -> Tuple[str, np.ndarray]:
    if name == "kernel":
        if module == "upscaler":  # flipped HWIO -> (in, out, kh, kw)
            return "weight", np.transpose(value[::-1, ::-1], (2, 3, 0, 1))
        if value.ndim == 4:  # HWIO -> OIHW
            return "weight", np.transpose(value, (3, 2, 0, 1))
        return "weight", value.T
    if name == "scale":
        return "weight", value
    return name, value


def jax_to_torch_state_dict(params: Mapping[str, Mapping[str, Any]]
                            ) -> Dict[str, torch.Tensor]:
    """``{"unet": ..., "vae": ...}`` Flax trees -> reference-keyed torch
    state dict (f32 tensors)."""
    out: Dict[str, torch.Tensor] = {}
    for tree_name, root in (("unet", "denoiser.unet"), ("vae", "autoencoder")):
        for path, value in _flatten(params.get(tree_name, {})):
            head = root
            segs = list(path[:-1])
            if tree_name == "unet":
                for pat, rep in _CROSS_VIEW:
                    if re.fullmatch(pat, segs[0]):
                        head, segs = re.sub(pat, rep, segs[0]), segs[1:]
                        break
            names = [s for s in (_segment(s) for s in segs) if s is not None]
            leaf, arr = _leaf(path[-1], np.asarray(value, dtype=np.float32),
                              path[-2] if len(path) > 1 else "")
            key = ".".join([head, *names, leaf])
            out[key] = torch.tensor(np.ascontiguousarray(arr))
    return out
