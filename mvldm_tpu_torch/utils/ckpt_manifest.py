"""Released-checkpoint structural manifest (counterpart of
``mvldm_tpu/utils/ckpt_manifest.py``).

The released reference checkpoint (``asimbluemoon/mvldm-1.0``) is not in
the repository. ``assets/mvldm_1.0_manifest.json`` holds the torch
``state_dict`` key -> shape census of the baseline model, and this module
checks a checkpoint file against it:

    python -m mvldm_tpu_torch.utils.ckpt_manifest --check path/to/mvldm-1.0.ckpt
    python -m mvldm_tpu_torch.utils.ckpt_manifest --write <path>   # the census

The port's census needs no inversion: its modules carry the reference
checkpoint's key names and torch layouts, so the census is the
``state_dict()`` of the baseline model built on the ``meta`` device (no
memory, no weights). Keys the checkpoint holds but the model does not
read (the up-block SD attentions, reference ``mvunet.py:178``) are listed
apart as "ignored". ``--check`` reads the file with
``torch.load(weights_only=True)`` on the ``meta`` device: the shapes
only, and no code from the file is run.
"""

from __future__ import annotations

import json
import re
from pathlib import Path
from typing import Any, Dict, Tuple

DEFAULT_MANIFEST = Path("assets/mvldm_1.0_manifest.json")


def _transformer2d_keys(prefix: str, c: int, ctx: int = 1024) -> Dict[str, list]:
    """Torch key census of one SD Transformer2DModel (linear projections):
    the up-block attentions the checkpoint holds and the model ignores."""
    tb = f"{prefix}.transformer_blocks.0"
    keys: Dict[str, list] = {
        f"{prefix}.norm.weight": [c], f"{prefix}.norm.bias": [c],
        f"{prefix}.proj_in.weight": [c, c], f"{prefix}.proj_in.bias": [c],
        f"{prefix}.proj_out.weight": [c, c], f"{prefix}.proj_out.bias": [c],
    }
    for n in ("norm1", "norm2", "norm3"):
        keys[f"{tb}.{n}.weight"] = [c]
        keys[f"{tb}.{n}.bias"] = [c]
    for attn, kdim in (("attn1", c), ("attn2", ctx)):
        keys[f"{tb}.{attn}.to_q.weight"] = [c, c]
        keys[f"{tb}.{attn}.to_k.weight"] = [c, kdim]
        keys[f"{tb}.{attn}.to_v.weight"] = [c, kdim]
        keys[f"{tb}.{attn}.to_out.0.weight"] = [c, c]
        keys[f"{tb}.{attn}.to_out.0.bias"] = [c]
    keys[f"{tb}.ff.net.0.proj.weight"] = [8 * c, c]
    keys[f"{tb}.ff.net.0.proj.bias"] = [8 * c]
    keys[f"{tb}.ff.net.2.weight"] = [c, 4 * c]
    keys[f"{tb}.ff.net.2.bias"] = [c]
    return keys


def generate_manifest() -> Dict[str, Any]:
    """{"required": {torch_key: shape}, "ignored": {...}} of the baseline
    model, from its modules built on the meta device."""
    import torch

    from ..builder import MVLDM
    from ..config import compose, load_typed_root_config

    cfg = load_typed_root_config(compose(["+experiment=baseline"]))
    with torch.device("meta"):
        model = MVLDM(cfg.model)
    required = {k: list(v.shape) for k, v in model.state_dict().items()}
    ub = cfg.model.denoiser.autoencoder
    rev = list(reversed(ub.block_out_channels))
    ignored: Dict[str, list] = {}
    for i, btype in enumerate(ub.up_block_types):
        if btype != "CrossAttnUpBlock2D":
            continue
        for j in range(ub.layers_per_block + 1):
            ignored.update(_transformer2d_keys(
                f"denoiser.unet.up_blocks.{i}.attentions.{j}", rev[i], ub.cross_attention_dim))
    return {"required": required, "ignored": ignored}


# ------------------------------------------------------------------ checking

_LEGACY_VAE_ATTN = {"q": "to_q", "k": "to_k", "v": "to_v", "proj_out": "to_out.0",
                    "norm": "group_norm"}


def _normalize_key(key: str, shape: Tuple[int, ...]):
    """Map legacy diffusers VAE attention names (q/k/v 1x1 convs) onto the
    layout the manifest uses (to_q Linear), squeezing the conv dims."""
    m = re.match(r"^(autoencoder\.(?:en|de)coder\.mid_block\.attentions\.0)\."
                 r"(q|k|v|proj_out|norm)\.(weight|bias)$", key)
    if not m:
        return key, shape
    base, name, leaf = m.groups()
    if leaf == "weight" and len(shape) == 4 and name != "norm":
        shape = shape[:2]
    return f"{base}.{_LEGACY_VAE_ATTN[name]}.{leaf}", shape


def check_shapes(sd_shapes: Dict[str, Tuple[int, ...]], manifest: Dict[str, Any]
                 ) -> Dict[str, list]:
    """Compare a state dict's {key: shape} with the manifest: {"missing",
    "mismatched": [(key, got, want)], "missing_ignored", "extra"}; the check
    passes iff ``missing`` and ``mismatched`` are empty."""
    norm = dict(_normalize_key(k, tuple(s)) for k, s in sd_shapes.items())
    missing, mismatched = [], []
    for key, want in manifest["required"].items():
        if key not in norm:
            missing.append(key)
        elif list(norm[key]) != list(want):
            mismatched.append((key, list(norm[key]), list(want)))
    missing_ignored = [k for k in manifest.get("ignored", {}) if k not in norm]
    known = set(manifest["required"]) | set(manifest.get("ignored", {}))
    extra = sorted(k for k in norm if k not in known)
    return {"missing": missing, "mismatched": mismatched,
            "missing_ignored": missing_ignored, "extra": extra}


def checkpoint_shapes(ckpt_path: Path) -> Dict[str, Tuple[int, ...]]:
    """{key: shape} of a torch checkpoint's state dict (its ``state_dict``
    entry for a Lightning file), read on the meta device."""
    import torch

    obj = torch.load(ckpt_path, map_location="meta", weights_only=True)
    sd = obj.get("state_dict", obj) if isinstance(obj, dict) else obj
    return {k: tuple(v.shape) for k, v in sd.items() if hasattr(v, "shape")}


def check_checkpoint(ckpt_path: Path, manifest_path: Path) -> bool:
    """Check a checkpoint file against the manifest; prints a report and
    returns whether it passed."""
    manifest = json.loads(Path(manifest_path).read_text())
    shapes = checkpoint_shapes(ckpt_path)
    report = check_shapes(shapes, manifest)
    ok = not report["missing"] and not report["mismatched"]
    print(f"checkpoint: {ckpt_path} ({len(shapes)} tensors)")
    print(f"required:   {len(manifest['required'])} expected, "
          f"{len(report['missing'])} missing, {len(report['mismatched'])} shape-mismatched")
    for key in report["missing"][:20]:
        print(f"  MISSING    {key}")
    for key, got, want in report["mismatched"][:20]:
        print(f"  MISMATCH   {key}: checkpoint {got} vs expected {want}")
    if report["missing_ignored"]:
        print(f"note: {len(report['missing_ignored'])} ignored keys absent (up-block SD "
              "attentions); loading is unaffected")
    if report["extra"]:
        print(f"note: {len(report['extra'])} extra keys the model does not read "
              f"(first few: {report['extra'][:5]})")
    print("STRUCTURE " + ("OK: safe to load" if ok else "CHECK FAILED"))
    return ok


def main(argv=None) -> None:
    import argparse
    import sys

    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--write", type=Path, default=None,
                        help="write the census JSON of the baseline model")
    parser.add_argument("--check", type=Path, default=None,
                        help="torch .ckpt to check against the manifest")
    parser.add_argument("--manifest", type=Path, default=DEFAULT_MANIFEST)
    args = parser.parse_args(argv)
    if args.write is not None:
        manifest = generate_manifest()
        args.write.parent.mkdir(parents=True, exist_ok=True)
        args.write.write_text(json.dumps(manifest, indent=1, sort_keys=True))
        print(f"Wrote {args.write} ({len(manifest['required'])} required + "
              f"{len(manifest['ignored'])} ignored keys)")
    if args.check is not None:
        if not check_checkpoint(args.check, args.manifest):
            sys.exit(1)
    if args.write is None and args.check is None:
        parser.error("pass --write and/or --check")


if __name__ == "__main__":
    main()
