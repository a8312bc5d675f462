"""``mvldm_tpu_torch.scripts.verify_parity`` on the CPU: fixture mode
against a fixture made by the JAX tiny engine (``sample_latents`` with the
context latents and the initial noise injected, then ``decode_latents``),
and the smoke mode's fixture read back by fixture mode."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mvldm_tpu_torch.scripts import verify_parity

from tests.test_sampling_goldens import HL, STEPS, V_C, V_T, build_engine, scene_cameras
from tests.test_torch_goldens import checkpoint  # noqa: F401  (module-scoped fixture)
from tests.test_torch_port_engine import port_engine

# Port against JAX in f32 on the CPU: the sampling loop's own bound
# (tests/test_torch_port_engine.py holds the latents to 2e-3), ten times
# tighter than the harness's verdict (REL_MAX_THRESHOLD).
REL_MAX = 2e-3


def test_fixture_mode_vs_the_jax_engine(checkpoint, tmp_path):  # noqa: F811
    ckpt, params = checkpoint
    extr, intr = (a[:1] for a in scene_cameras())
    rng = np.random.default_rng(3)
    ctx = rng.normal(size=(1, V_C, HL, HL, 4)).astype(np.float32)
    noise = rng.normal(size=(1, V_T, HL, HL, 4)).astype(np.float32)
    engine = build_engine("auto")
    latents = jax.jit(engine.sample_latents, static_argnames=("num_target_views",))(
        params["unet"], jnp.asarray(ctx), jnp.asarray(extr), jnp.asarray(intr),
        num_target_views=V_T, rng=jax.random.PRNGKey(0), initial_noise=jnp.asarray(noise))
    images = engine.decode_latents(params["vae"], latents)
    fixture = dict(context_latents=ctx, initial_noise=noise, extrinsics=extr, intrinsics=intr,
                   latents_final=np.asarray(latents), images_out=np.asarray(images))
    report = verify_parity.run_fixture(port_engine(ckpt, "auto", steps=STEPS), fixture,
                                       tmp_path)
    assert report["pass"] and report["worst_rel_max"] <= REL_MAX, report
    assert np.abs(fixture["latents_final"]).mean() > 1e-2
    out = np.load(tmp_path / "torch_outputs.npz")
    assert out["images_out"].shape == fixture["images_out"].shape


def test_smoke_then_fixture_mode(tmp_path, capsys):
    """Smoke mode writes a finite fixture in the documented layout; fixture
    mode on it, from the same weights, reproduces it exactly."""
    common = ["+experiment=tiny", "dataset.image_shape=[32,32]", "steps=3",
              f"out={tmp_path}"]
    assert verify_parity.main(common, device="cpu") is None
    fx = np.load(tmp_path / "torch_fixture.npz")
    assert fx["context_latents"].shape == (1, 2, 4, 4, 4)
    assert fx["initial_noise"].shape == fx["latents_final"].shape == (1, 3, 4, 4, 4)
    assert fx["images_out"].shape == (1, 3, 32, 32, 3) and int(fx["num_inference_steps"]) == 3
    assert all(np.isfinite(fx[k]).all() for k in fx.files)
    report = verify_parity.main(common + [f"fixtures={tmp_path / 'torch_fixture.npz'}"],
                                device="cpu")
    assert report["pass"] and report["worst_rel_max"] == 0.0
    assert "Parity PASS" in capsys.readouterr().out


def test_fixture_shape_mismatch_fails(tmp_path):
    class Engine:
        def sample_latents(self, ctx, extr, intr, v_t, initial_noise):
            return initial_noise * 0

        def decode_latents(self, latents):
            return latents[..., :3]

    fx = {k: np.zeros((1, 3, 4, 4, 4), np.float32) for k in
          ("context_latents", "initial_noise", "latents_final")}
    fx.update(extrinsics=np.zeros((1, 5, 4, 4), np.float32),
              intrinsics=np.zeros((1, 5, 3, 3), np.float32),
              images_out=np.zeros((1, 3, 32, 32, 3), np.float32))
    report = verify_parity.run_fixture(Engine(), fx, tmp_path)
    assert not report["pass"]
    assert report["diffs"][1].get("shape_mismatch")


@pytest.mark.parametrize("argv,kv", [
    (["ckpt=a.ckpt", "steps=5", "seed=3"], {"ckpt": "a.ckpt", "steps": "5"}),
    (["fixtures=f.npz", "out=o"], {"fixtures": "f.npz", "out": "o"})])
def test_parse_kv(argv, kv):
    got, passthrough = verify_parity._parse_kv(argv)
    assert got == kv and all("=" in a for a in passthrough)
