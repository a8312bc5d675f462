"""One-time VAE-latent precompute pass, the latent-cache writer
(counterpart of ``mvldm_tpu/scripts/precompute_latents.py``).

The training VAE is frozen, so its encode is a pure function of each
crop-shimmed frame. This script sweeps the dataset chunks once, encodes
every frame (and its x-flipped variant, for the 50% reflection
augmentation) on the card, and writes the posterior moments in
``data/latent_cache.py``'s layout, which both packages read. Training then
runs with ``dataset.latent_cache=<out>`` and never decodes a JPEG or runs
the VAE encoder again.

    python -m mvldm_tpu_torch.scripts.precompute_latents dataset.root=<path> \\
        checkpointing.load=<torch .ckpt> [out=<cache dir>] [stages=[train]]

``precision: null`` encodes in f32 with TF32 off for the whole pass (the
f32 route's rule: cuDNN's convolutions too, whatever the global flags say),
the encoder's D = 512 attention through the f32 route's kernels. Without a
card it exits non-zero; from Python, ``main(argv, device="cpu")`` asks for
the CPU.
"""

from __future__ import annotations

import sys
from dataclasses import dataclass, field
from pathlib import Path
from typing import List, Optional

import numpy as np
import torch

from ..builder import init_params, load_reference_ckpt, resolve_dtype
from ..config import CheckpointingCfg, DatasetCfg, compose, from_dict, set_cfg
from ..data.chunk_reader import convert_poses, decode_jpeg_bytes, load_chunk
from ..data.dataset_re10k import _fov_degrees
from ..data.latent_cache import cache_file, write_chunk_cache, write_meta
from ..data.loader import process_index_and_count
from ..data.shims import rescale_and_crop
from ..diffusion.engine import ModelCfg
from ..models.vae import AutoencoderKL
from ..ops.f32_route import no_tf32
from .main import resolve_device


@dataclass
class PrecomputeLatentsCfg:
    dataset: DatasetCfg = field(default_factory=DatasetCfg)
    model: ModelCfg = field(default_factory=ModelCfg)
    checkpointing: CheckpointingCfg = field(default_factory=CheckpointingCfg)
    seed: int = 0
    out: Optional[Path] = None
    stages: List[str] = field(default_factory=lambda: ["train"])
    encode_batch: int = 32
    no_flip: bool = False
    allow_init_vae: bool = False
    precision: Optional[str] = None


def load_precompute_cfg(overrides) -> PrecomputeLatentsCfg:
    cfg_dict = compose(overrides, main_name="precompute_latents")
    set_cfg(cfg_dict)
    return from_dict(PrecomputeLatentsCfg, cfg_dict, "root")


def build_vae(cfg: PrecomputeLatentsCfg, device, dtype: torch.dtype) -> AutoencoderKL:
    """The VAE of ``cfg.model.autoencoder`` on ``device`` in ``dtype``: the
    port's seeded init (seed ``cfg.seed``), then the ``autoencoder.*``
    tensors of ``checkpointing.load``'s reference ``.ckpt`` when set."""
    with torch.device("meta"):
        vae = AutoencoderKL(cfg.model.autoencoder.kwargs)
    vae = vae.to_empty(device=device)
    init_params(vae, cfg.seed)
    load = cfg.checkpointing.load
    if load and str(load).endswith(".ckpt"):
        load_reference_ckpt(load, autoencoder=vae)
    return vae.to(dtype).eval().requires_grad_(False)


def build_encoder(cfg: PrecomputeLatentsCfg, device):
    """(moments fn of a fixed-size batch, latent_channels, fingerprint)."""
    dtype = resolve_dtype(cfg.precision) if cfg.precision else torch.float32
    dtype_name = str(dtype).removeprefix("torch.")  # numpy's name, as in the JAX cache
    load = cfg.checkpointing.load
    if load and str(load).endswith(".ckpt"):
        fingerprint = f"ckpt:{load} dtype:{dtype_name}"
        print(f"VAE encoder weights from {load}")
    elif cfg.allow_init_vae:
        # The port's seeded init, not the JAX package's draws.
        fingerprint = f"random-init(seed={cfg.seed}, mvldm_tpu_torch) dtype:{dtype_name}"
        print("WARNING: encoding with a RANDOM-INIT VAE (allow_init_vae) — "
              "the cache is only useful for pipeline tests.")
    else:
        raise SystemExit(
            "No VAE weights: pass checkpointing.load=<torch .ckpt> "
            "(the released mvldm checkpoint) or allow_init_vae=true "
            "for pipeline tests.")
    vae = build_vae(cfg, device, dtype)

    @torch.no_grad()
    def moments_fn(images01: np.ndarray) -> np.ndarray:
        """(n, h, w, 3) float32 in [0, 1] -> (n, h/8, w/8, 2c) float16."""
        x = torch.from_numpy(images01).to(device=device, dtype=dtype) * 2.0 - 1.0
        with no_tf32():
            dist = vae.encode(x)
        return torch.cat([dist.mean, dist.logvar], dim=-1).to(torch.float16).cpu().numpy()

    return moments_fn, cfg.model.autoencoder.kwargs.latent_channels, fingerprint


def encode_frames(moments_fn, images: np.ndarray, batch: int) -> np.ndarray:
    """(n, h, w, 3) -> (n, h/8, w/8, 2c) f16 in launches of exactly
    ``batch`` frames (the tail pads up to it)."""
    n = images.shape[0]
    outs = []
    for i in range(0, n, batch):
        block = images[i : i + batch]
        pad = batch - block.shape[0]
        if pad:
            block = np.concatenate(
                [block, np.zeros((pad, *block.shape[1:]), block.dtype)]
            )
        m = moments_fn(block)
        outs.append(m[: batch - pad] if pad else m)
    return np.concatenate(outs, axis=0)


def run(cfg: PrecomputeLatentsCfg, device=None) -> None:
    device = resolve_device(device)
    if cfg.dataset.root is None:
        raise SystemExit("dataset.root is not defined.")
    out = Path(cfg.out) if cfg.out is not None else Path(
        str(cfg.dataset.root) + "_latents"
    )
    moments_fn, latent_channels, fingerprint = build_encoder(cfg, device)
    image_shape = tuple(cfg.dataset.image_shape)
    n_flips = 1 if cfg.no_flip else 2
    rank, world = process_index_and_count()

    for stage in cfg.stages:
        root = Path(cfg.dataset.root) / stage
        chunks = sorted(p for p in root.iterdir() if p.suffix == ".torch")
        # Several processes (torch.distributed): stripe the chunks, each
        # process writing disjoint files, as the loader stripes at train time.
        if world > 1:
            chunks = chunks[rank::world]
        n_scenes = n_frames = 0
        for chunk_path in chunks:
            target = cache_file(out, stage, chunk_path.stem)
            if target.exists():
                print(f"[{stage}] {chunk_path.stem}: cache exists, skipping")
                continue
            scenes = {}
            for example in load_chunk(chunk_path):
                scene = example["key"]
                _, intrinsics = convert_poses(example["cameras"])
                if (_fov_degrees(intrinsics) > cfg.dataset.max_fov).any():
                    continue  # the dataset skips these scenes too
                frames = [decode_jpeg_bytes(b) for b in example["images"]]
                if any(f.shape != (360, 640, 3) for f in frames):
                    print(f"Skipped bad scene {scene} (frame shape).")
                    continue
                images = np.stack(frames)
                # Pixels-only half of the crop shim; the dataset applies the
                # matching intrinsics fix-up at train time
                # (shims.crop_shim_intrinsics).
                images, _ = rescale_and_crop(
                    images, intrinsics[: len(frames)], image_shape
                )
                variants = [images]
                if not cfg.no_flip:
                    variants.append(images[:, :, ::-1, :].copy())
                moments = np.stack(
                    [encode_frames(moments_fn, v, cfg.encode_batch) for v in variants],
                    axis=1,
                )  # (n, flips, h/8, w/8, 2c)
                scenes[scene] = moments
                n_scenes += 1
                n_frames += images.shape[0]
            write_chunk_cache(target, scenes)
            print(f"[{stage}] {chunk_path.stem}: {len(scenes)} scenes -> {target}")
        if rank == 0:  # one writer; content is static
            write_meta(out, stage, image_shape, latent_channels, n_flips, fingerprint)
        print(
            f"[{stage}] done: {n_scenes} scenes / {n_frames} frames; "
            f"train with dataset.latent_cache={out}"
        )


def main(argv=None, device=None) -> None:
    """``device`` is "cuda" when None; the tests pass "cpu"."""
    device = resolve_device(device)
    overrides = list(argv if argv is not None else sys.argv[1:])
    run(load_precompute_cfg(overrides), device)


if __name__ == "__main__":
    main()
