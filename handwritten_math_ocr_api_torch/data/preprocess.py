"""Image preprocessing: grayscale -> stretch-resize to 96x320 -> x/255*2-1.

The port of ``handwritten_math_ocr_api_tpu/data/preprocess.py``. The
normalize functions take numpy arrays or tensors and compute the same
float32 ``x / 255 * 2 - 1``. ``load_image_png`` and ``preprocess_file``
read a PNG with the port's own reader (``data/png.py``, numpy and ``zlib``);
they take images that are already ``img_h x img_w``, since the stretch
resize of the JAX package's cv2 loader is not ported (on the corpora it is
the identity). The PIL and cv2 loaders import those inside them, so the
package imports without either.
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


def load_image_cv2(path: str, img_h: int = 96, img_w: int = 320) -> np.ndarray:
    """Training-path loader: grayscale read + bilinear stretch-resize.
    Returns uint8 (H, W)."""
    import cv2

    img = cv2.imread(path, cv2.IMREAD_GRAYSCALE)
    if img is None:
        raise FileNotFoundError(f"cannot read image: {path}")
    return cv2.resize(img, (img_w, img_h))


def check_size(img: np.ndarray, img_h: int, img_w: int, path: str) -> None:
    if img.shape != (img_h, img_w):
        raise ValueError(
            f"{path}: image is {img.shape[0]}x{img.shape[1]}, the model "
            f"takes {img_h}x{img_w}; the stretch resize is not ported")


def load_image_png(path: str, img_h: int = 96, img_w: int = 320) -> np.ndarray:
    """The cv2 loader's counterpart on the port's PNG reader, for images
    already at the model's size: uint8 (H, W)."""
    img = read_png(path)
    check_size(img, img_h, img_w, path)
    return img


def preprocess_file(path: str, cfg=None) -> np.ndarray:
    """One file -> normalized float32 (1, H, W, 1) NHWC batch."""
    h = cfg.img_h if cfg else 96
    w = cfg.img_w if cfg else 320
    return normalize(load_image_png(path, h, w))[None, ..., None]
