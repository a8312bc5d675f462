"""Real-checkpoint parity harness (counterpart of
``mvldm_tpu/scripts/verify_parity.py``).

One command that loads a reference Lightning checkpoint, runs a fixed-seed
DDIM sample in f32 (TF32 off) and diffs latents and pixels against a
fixture dumped from the torch reference:

    python -m mvldm_tpu_torch.scripts.verify_parity ckpt=<path/to/1679000.ckpt> \\
        fixtures=<path/to/fixture.npz> [steps=25] [out=outputs/parity]

Fixture npz layout (the JAX harness's):

    context_latents  (1, v_c, hl, wl, 4)  scaled latents (x0.18215)
    initial_noise    (1, v_t, hl, wl, 4)  the N(0,1) draw torch used
    extrinsics       (1, v_c+v_t, 4, 4)   c2w, already relative
    intrinsics       (1, v_c+v_t, 3, 3)   normalized
    latents_final    (1, v_t, hl, wl, 4)  DDIM output (scaled)
    images_out       (1, v_t, H, W, 3)    decoded frames in [0, 1]

The context latents and the initial noise are injected, so any
disagreement is the weights' or the arithmetic's. Without ``fixtures=``
the command runs in smoke mode: it samples a synthetic scene from seeded
draws and writes ``<out>/torch_fixture.npz`` in that layout (with the
context images), which fixture mode, here or in the JAX harness, reads.
Runs on the card unless the caller asks for the CPU (``main(argv,
device="cpu")``).
"""

from __future__ import annotations

import sys
from pathlib import Path
from typing import Dict, List

import numpy as np
import torch

# The JAX harness's verdict: the worst relative max difference.
REL_MAX_THRESHOLD = 2e-2


def _parse_kv(argv):
    kv, passthrough = {}, []
    for a in argv:
        key, _, val = a.partition("=")
        if key in ("ckpt", "fixtures", "steps", "out", "scene"):
            kv[key] = val
        else:
            passthrough.append(a)
    return kv, passthrough


def _diff(name: str, ours: np.ndarray, theirs: np.ndarray) -> dict:
    ours = np.asarray(ours, np.float32)
    theirs = np.asarray(theirs, np.float32)
    if ours.shape != theirs.shape:
        print(f"  {name}: SHAPE MISMATCH ours={ours.shape} fixture={theirs.shape}")
        return {"name": name, "shape_mismatch": True}
    d = np.abs(ours - theirs)
    stats = {"name": name, "max_abs": float(d.max()), "rms": float(np.sqrt((d ** 2).mean())),
             "rel_max": float(d.max() / (np.abs(theirs).max() + 1e-12))}
    print(f"  {name}: max|d|={stats['max_abs']:.3e} rms={stats['rms']:.3e} "
          f"rel={stats['rel_max']:.3e}")
    return stats


def run_fixture(engine, fixture: Dict[str, np.ndarray], out_dir: Path) -> dict:
    """Sample with the fixture's context latents and initial noise, decode,
    and diff against its ``latents_final`` and ``images_out``. Writes
    ``<out_dir>/torch_outputs.npz``; returns the diffs, the worst relative
    max difference and whether it is under REL_MAX_THRESHOLD."""
    def t(name):
        return torch.from_numpy(np.asarray(fixture[name], np.float32))

    noise = t("initial_noise")
    latents = engine.sample_latents(t("context_latents"), t("extrinsics"), t("intrinsics"),
                                    noise.shape[1], initial_noise=noise)
    images = engine.decode_latents(latents)
    latents, images = latents.float().cpu().numpy(), images.float().cpu().numpy()
    results: List[dict] = [_diff("latents_final", latents, fixture["latents_final"]),
                           _diff("images_out", images, fixture["images_out"])]
    out_dir.mkdir(parents=True, exist_ok=True)
    np.savez(out_dir / "torch_outputs.npz", latents_final=latents, images_out=images)
    worst = max(r.get("rel_max", np.inf) for r in results)
    return {"diffs": results, "worst_rel_max": worst, "pass": bool(worst < REL_MAX_THRESHOLD)}


def smoke(engine, image_shape, out_dir: Path, steps: int, seed: int = 0) -> Path:
    """Sample a synthetic scene (2 context + 3 target views) from seeded
    draws; write ``<out_dir>/torch_fixture.npz`` in the fixture layout."""
    h, w = image_shape
    v_c, v_t = 2, 3
    gen = torch.Generator().manual_seed(seed)
    images = torch.rand((1, v_c, h, w, 3), generator=gen)
    extr = torch.eye(4).expand(1, v_c + v_t, 4, 4).clone()
    extr[:, :, 0, 3] = torch.linspace(0.0, 1.0, v_c + v_t)
    intr = torch.eye(3).expand(1, v_c + v_t, 3, 3).clone()
    intr[:, :, 0, 2] = intr[:, :, 1, 2] = 0.5
    posterior_eps = torch.randn((1, v_c, h // 8, w // 8, 4), generator=gen)
    noise = torch.randn((1, v_t, h // 8, w // 8, 4), generator=gen)
    ctx_latents = engine.encode_images(images, noise=posterior_eps)
    latents = engine.sample_latents(ctx_latents, extr, intr, v_t, initial_noise=noise)
    out_images = engine.decode_latents(latents)
    path = out_dir / "torch_fixture.npz"
    out_dir.mkdir(parents=True, exist_ok=True)
    np.savez(path, context_images=images.numpy(),
             context_latents=ctx_latents.float().cpu().numpy(), initial_noise=noise.numpy(),
             extrinsics=extr.numpy(), intrinsics=intr.numpy(),
             latents_final=latents.float().cpu().numpy(),
             images_out=out_images.float().cpu().numpy(), num_inference_steps=steps)
    if not np.isfinite(latents.float().cpu().numpy()).all():
        raise RuntimeError("smoke sample is not finite")
    print(f"Smoke OK: dumped {path} (latents {tuple(latents.shape)}, "
          f"images {tuple(out_images.shape)})")
    return path


def main(argv=None, device=None):
    """The CLI. Returns the fixture-mode report (None in smoke mode); run
    as a script, a failed parity exits 1."""
    from ..builder import build_engine, load_pretrained
    from ..config import compose, load_typed_root_config, set_cfg
    from ..ops.f32_route import no_tf32
    from .main import resolve_device

    device = resolve_device(device)
    kv, passthrough = _parse_kv(list(argv if argv is not None else sys.argv[1:]))
    steps = int(kv.get("steps", 25))
    out_dir = Path(kv.get("out", "outputs/parity"))
    overrides = ["+experiment=baseline", *passthrough,
                 f"model.scheduler.num_inference_steps={steps}"]
    if "ckpt" in kv:
        overrides.append(f"checkpointing.load={kv['ckpt']}")
    cfg_dict = compose(overrides)
    set_cfg(cfg_dict)
    cfg = load_typed_root_config(cfg_dict)
    # f32 end to end: the tolerance is about the weights, not bf16 rounding.
    engine = build_engine(cfg, device, torch.float32)
    load_pretrained(cfg, engine)
    with no_tf32():
        if "fixtures" in kv:
            print(f"Parity vs {kv['fixtures']} ({steps} DDIM steps):")
            report = run_fixture(engine, dict(np.load(kv["fixtures"])), out_dir)
            print(f"Parity {'PASS' if report['pass'] else 'FAIL'} (worst rel_max "
                  f"{report['worst_rel_max']:.3e}, threshold {REL_MAX_THRESHOLD:g})")
            return report
        print("No fixtures= given: smoke mode (seeded or loaded weights, synthetic scene, "
              "fixed seed).")
        smoke(engine, cfg.dataset.image_shape, out_dir, steps)
    return None


if __name__ == "__main__":
    report = main()
    sys.exit(0 if report is None or report["pass"] else 1)
