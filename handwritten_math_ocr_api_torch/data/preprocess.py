"""Image preprocessing: grayscale -> stretch-resize to 96x320 -> x/255*2-1.

The port of ``handwritten_math_ocr_api_tpu/data/preprocess.py``. The
normalize functions take numpy arrays or tensors and compute the same
float32 ``x / 255 * 2 - 1``. ``load_image_png`` and ``preprocess_file``
read a PNG with the port's own reader (``data/png.py``, numpy and ``zlib``)
and stretch-resize an image that is not ``img_h x img_w`` with cv2's
bilinear resize, as the JAX package's cv2 loader does (``stretch``; on the
corpora, whose images are at the model's size, it is the identity). The
serving path's ``resize_pil_u8`` and ``preprocess_pil`` (PIL grayscale,
bilinear stretch resize) and the cv2 functions import those inside them,
so the package imports without either.
"""

from __future__ import annotations

import numpy as np
import torch

from .png import read_png


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


def preprocess_pil(image, img_h: int = 96, img_w: int = 320) -> np.ndarray:
    """Serving-path preprocess: PIL image -> normalized float32 (H, W)."""
    return normalize(resize_pil_u8(image, img_h, img_w))


def load_image_cv2(path: str, img_h: int = 96, img_w: int = 320) -> np.ndarray:
    """Training-path loader: grayscale read + bilinear stretch-resize.
    Returns uint8 (H, W)."""
    import cv2

    img = cv2.imread(path, cv2.IMREAD_GRAYSCALE)
    if img is None:
        raise FileNotFoundError(f"cannot read image: {path}")
    return cv2.resize(img, (img_w, img_h))


def stretch(img: np.ndarray, img_h: int, img_w: int) -> np.ndarray:
    """uint8 (h, w) -> (img_h, img_w): cv2's bilinear stretch resize (the
    JAX loader's ``cv2.resize``), the image itself where it is at that
    size already."""
    if img.shape == (img_h, img_w):
        return img
    import cv2

    return cv2.resize(img, (img_w, img_h))


def load_image_png(path: str, img_h: int = 96, img_w: int = 320) -> np.ndarray:
    """The cv2 loader's counterpart on the port's PNG reader: uint8 (H, W),
    stretch-resized to the model's size."""
    return stretch(read_png(path), img_h, img_w)


def preprocess_file(path: str, cfg=None) -> np.ndarray:
    """One file -> normalized float32 (1, H, W, 1) NHWC batch."""
    h = cfg.img_h if cfg else 96
    w = cfg.img_w if cfg else 320
    return normalize(load_image_png(path, h, w))[None, ..., None]
