"""Image preprocessing: grayscale -> stretch-resize to 96x320 -> x/255*2-1.

The port of ``handwritten_math_ocr_api_tpu/data/preprocess.py``. The
normalize functions take numpy arrays or tensors and compute the same
float32 ``x / 255 * 2 - 1``. The file loaders need PIL or cv2, which are
imported inside them, so the package imports without either.
"""

from __future__ import annotations

import numpy as np
import torch


def normalize(img_u8):
    """uint8 [0, 255] -> float32 [-1, 1] (Normalize(mean=0.5, std=0.5))."""
    if isinstance(img_u8, torch.Tensor):
        return img_u8.to(torch.float32) / 255.0 * 2.0 - 1.0
    return img_u8.astype(np.float32) / 255.0 * 2.0 - 1.0


def preprocess_batch_numpy(images_u8):
    """Batch of uint8 (B, H, W) -> normalized float32 (B, H, W, 1), NHWC."""
    return normalize(images_u8)[..., None]


def resize_pil_u8(image, img_h: int = 96, img_w: int = 320) -> np.ndarray:
    """Serving-path resize: PIL image -> uint8 (H, W) grayscale."""
    from PIL import Image

    image = image.convert("L")
    image = image.resize((img_w, img_h), Image.BILINEAR)
    return np.asarray(image, dtype=np.uint8)


def load_image_cv2(path: str, img_h: int = 96, img_w: int = 320) -> np.ndarray:
    """Training-path loader: grayscale read + bilinear stretch-resize.
    Returns uint8 (H, W)."""
    import cv2

    img = cv2.imread(path, cv2.IMREAD_GRAYSCALE)
    if img is None:
        raise FileNotFoundError(f"cannot read image: {path}")
    return cv2.resize(img, (img_w, img_h))
