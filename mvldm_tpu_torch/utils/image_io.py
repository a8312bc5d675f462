"""Image IO (counterpart of ``mvldm_tpu/utils/image_io.py``, after reference
``src/misc/image_io.py``): float or uint8 HWC frames to PNG, and the GIF and
MP4 export of sampled videos (reference ``on_test_end:1069-1088``). MP4s
are Motion-JPEG through the built-in muxer (``utils/mp4.py``). PIL is
imported where it runs.
"""

from __future__ import annotations

import io
from pathlib import Path
from typing import Sequence, Union

import numpy as np

from .mp4 import write_mjpeg_mp4


def prep_image(image: np.ndarray) -> np.ndarray:
    """(h, w, 3|4|1) float [0, 1] (or already-quantized uint8) -> uint8 HWC."""
    image = np.asarray(image)
    if image.ndim == 2:
        image = image[..., None]
    if image.shape[-1] == 1:
        image = np.repeat(image, 3, axis=-1)
    if image.dtype == np.uint8:
        return image
    return (np.clip(image, 0.0, 1.0) * 255.0).astype(np.uint8)


def save_image(image: np.ndarray, path: Union[Path, str]) -> None:
    from PIL import Image

    path = Path(path)
    path.parent.mkdir(exist_ok=True, parents=True)
    Image.fromarray(prep_image(image)).save(path)


def load_image(path: Union[Path, str]) -> np.ndarray:
    from PIL import Image

    return np.asarray(Image.open(path).convert("RGB"), dtype=np.float32) / 255.0


def save_gif(frames: Sequence[np.ndarray], path: Union[Path, str],
             duration: int = 5) -> None:
    """Frames -> looping GIF (reference ``on_test_end:1076-1083``)."""
    from PIL import Image

    path = Path(path)
    path.parent.mkdir(exist_ok=True, parents=True)
    pil = [Image.fromarray(prep_image(f)) for f in frames]
    pil[0].save(path, save_all=True, append_images=pil[1:], duration=duration, loop=0)


def save_video(frames: Sequence[np.ndarray], path: Union[Path, str], fps: int = 25) -> None:
    """Frames -> Motion-JPEG MP4 (JPEG quality 92) at ``fps``."""
    from PIL import Image

    jpegs = []
    for f in frames:
        buf = io.BytesIO()
        Image.fromarray(prep_image(f)).save(buf, format="JPEG", quality=92)
        jpegs.append(buf.getvalue())
    arr = prep_image(frames[0])
    write_mjpeg_mp4(jpegs, path, fps=fps, size=(arr.shape[1], arr.shape[0]))
