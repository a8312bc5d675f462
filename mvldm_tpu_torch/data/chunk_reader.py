"""Reader for pixelSplat-format ``.torch`` chunk files (counterpart of
``mvldm_tpu/data/chunk_reader.py``).

The RE10K dataset ships as ``root/<stage>/*.torch`` chunks, each a
torch-saved list of scenes: ``{"key": str, "cameras": (n, 18) float
tensor, "images": [uint8 tensors of JPEG bytes, ...]}`` (reference
``dataset_re10k.py:96``). ``torch.load(weights_only=True)`` reads them: the
JAX package's own fallback, whose native C++ decoder exists only to keep
torch out of a JAX process. Frames leave this module as numpy; JPEG decode
goes through PIL, imported where it runs.
"""

from __future__ import annotations

import io
from pathlib import Path
from typing import Any, Dict, List

import numpy as np
import torch


def load_chunk(path: Path) -> List[Dict[str, Any]]:
    """Load one chunk; returns a list of scene dicts with numpy cameras and
    the frames still JPEG-encoded."""
    chunk = torch.load(path, weights_only=True, map_location="cpu")
    return [{"key": ex["key"],
             "cameras": np.asarray(ex["cameras"], dtype=np.float32),
             "images": ex["images"]}  # list of uint8 byte tensors
            for ex in chunk]


def decode_jpeg_bytes(data) -> np.ndarray:
    """One encoded frame -> (h, w, 3) float32 in [0, 1]."""
    from PIL import Image

    if hasattr(data, "numpy"):
        data = data.numpy()
    buf = io.BytesIO(np.asarray(data, dtype=np.uint8).tobytes())
    return np.asarray(Image.open(buf), dtype=np.float32) / 255.0


def convert_poses(poses: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(n, 18) rows -> (c2w extrinsics (n, 4, 4), normalized K (n, 3, 3))
    (reference ``convert_poses:173-194``): row = [fx fy cx cy _ _ w2c(3x4)]."""
    n = poses.shape[0]
    intrinsics = np.repeat(np.eye(3, dtype=np.float32)[None], n, axis=0)
    intrinsics[:, 0, 0] = poses[:, 0]
    intrinsics[:, 1, 1] = poses[:, 1]
    intrinsics[:, 0, 2] = poses[:, 2]
    intrinsics[:, 1, 2] = poses[:, 3]
    w2c = np.repeat(np.eye(4, dtype=np.float32)[None], n, axis=0)
    w2c[:, :3] = poses[:, 6:].reshape(n, 3, 4)
    return np.linalg.inv(w2c), intrinsics


def save_chunk(chunk: List[Dict[str, Any]], path: Path) -> None:
    """Write a chunk in the same format; frames may be JPEG ``bytes``."""
    torch.save([{
        "key": ex["key"],
        "cameras": torch.from_numpy(np.asarray(ex["cameras"], np.float32)),
        "images": [torch.from_numpy(np.frombuffer(img, dtype=np.uint8).copy())
                   if isinstance(img, (bytes, bytearray)) else img
                   for img in ex["images"]],
    } for ex in chunk], path)
