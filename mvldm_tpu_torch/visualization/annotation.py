"""Text annotation (counterpart of ``mvldm_tpu/visualization/annotation.py``;
reference ``src/visualization/annotation.py``): stack a PIL-rendered label
above an image. Pillow is imported where a label is drawn."""

from __future__ import annotations

import numpy as np

from .layout import vcat


def draw_text(text: str, width: int, height: int = 24) -> np.ndarray:
    from PIL import Image, ImageDraw

    img = Image.new("RGB", (width, height), (255, 255, 255))
    draw = ImageDraw.Draw(img)
    draw.text((4, 4), text, fill=(0, 0, 0))
    return np.asarray(img, dtype=np.float32) / 255.0


def add_label(image: np.ndarray, label: str) -> np.ndarray:
    image = np.asarray(image)
    text = draw_text(label, image.shape[1])
    return vcat(text, image, gap=2)
