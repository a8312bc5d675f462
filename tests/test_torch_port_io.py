"""The port's image and video writers against the JAX package's: PNG, GIF
and MP4 bytes equal for the same frames (float and uint8), and the MP4s
parse as the Motion-JPEG layout."""

import numpy as np
import pytest

from mvldm_tpu.utils import image_io as jax_io
from mvldm_tpu.utils import mp4 as jax_mp4
from mvldm_tpu_torch.utils import image_io, mp4


def frames(dtype):
    rng = np.random.default_rng(0)
    f = rng.uniform(size=(4, 24, 40, 3)).astype(np.float32)
    return list((f * 255).astype(np.uint8)) if dtype == "uint8" else list(f)


@pytest.mark.parametrize("dtype", ["float32", "uint8"])
def test_png_and_gif_bytes_match_jax(tmp_path, dtype):
    fs = frames(dtype)
    image_io.save_image(fs[0], tmp_path / "ours" / "a.png")
    jax_io.save_image(fs[0], tmp_path / "jax" / "a.png")
    assert (tmp_path / "ours" / "a.png").read_bytes() == (tmp_path / "jax" / "a.png").read_bytes()
    np.testing.assert_array_equal(image_io.load_image(tmp_path / "ours" / "a.png"),
                                  jax_io.load_image(tmp_path / "jax" / "a.png"))
    image_io.save_gif(fs, tmp_path / "ours" / "a.gif")
    jax_io.save_gif(fs, tmp_path / "jax" / "a.gif")
    assert (tmp_path / "ours" / "a.gif").read_bytes() == (tmp_path / "jax" / "a.gif").read_bytes()


@pytest.mark.parametrize("fps", [25, 10])
@pytest.mark.parametrize("dtype", ["float32", "uint8"])
def test_mp4_bytes_match_jax(tmp_path, fps, dtype):
    fs = frames(dtype)
    image_io.save_video(fs, tmp_path / "ours.mp4", fps=fps)
    assert jax_io.save_video(fs, tmp_path / "jax.mp4", fps=fps)
    data = (tmp_path / "ours.mp4").read_bytes()
    assert data == (tmp_path / "jax.mp4").read_bytes()
    boxes = dict(mp4.parse_boxes(data))
    assert list(boxes) == [b"ftyp", b"mdat", b"moov"]
    assert mp4.parse_boxes(data) == jax_mp4.parse_boxes(data)
    assert boxes[b"mdat"].count(b"\xff\xd8") >= len(fs)  # one JPEG per frame


def test_parse_boxes_refuses_truncation():
    data = mp4._box(b"ftyp", b"isom") + mp4._box(b"mdat", b"xy")
    assert [k for k, _ in mp4.parse_boxes(data)] == [b"ftyp", b"mdat"]
    with pytest.raises(ValueError):
        mp4.parse_boxes(data[:-1])
