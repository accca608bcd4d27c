"""Batched augmentation on the device: a random affine warp (rotation,
shear, scale) and the normalisation of uint8 images.

The port of ``handwritten_math_ocr_api_tpu/data/augment.py``: rotation
~U(-degrees, degrees), x-shear ~U(-shear, shear) (degrees), isotropic scale
~U(scale_range) about the image centre, the inverse map
``A^-1 = (R(theta) Shear(shear) scale)^-1`` applied to each output pixel's
centred coordinates, nearest-neighbour sampling (round half to even, as
``jnp.round``) and fill -1 (white paper is +1 after normalisation, so the
fill is torchvision's 0 of the reference's normalised images). ``warp``
takes the parameters explicitly; ``random_affine_batch`` draws them from a
``torch.Generator`` (the JAX function draws them from its key, so the draws
differ and the warp of given parameters is the same).
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

from ..core.config import DataConfig


def _inverse_affine(theta, shear, scale):
    """(B, 2, 2) inverse of A = R(theta) @ Shear(shear) @ (scale * I), in
    float32 as the JAX function computes it."""
    cos, sin = torch.cos(theta), torch.sin(theta)
    t = torch.tan(shear)
    a, b = cos * scale, (cos * t - sin) * scale
    c, d = sin * scale, (sin * t + cos) * scale
    det = a * d - b * c
    inv = torch.stack([torch.stack([d, -b], -1), torch.stack([-c, a], -1)],
                      -2)
    return inv / det[:, None, None]


def warp(images, theta, shear, scale, fill: float = -1.0):
    """images (B, H, W) or (B, H, W, 1), float; theta, shear (radians) and
    scale (B,) float32. Each image warped about its centre, nearest
    neighbour, ``fill`` where the source pixel lies outside."""
    squeeze = images.dim() == 4
    x = images[..., 0] if squeeze else images
    B, H, W = x.shape
    dev = x.device
    inv = _inverse_affine(theta.float(), shear.float(), scale.float())
    cy, cx = (H - 1) / 2.0, (W - 1) / 2.0
    ys = (torch.arange(H, dtype=torch.float32, device=dev) - cy)[None, :, None]
    xs = (torch.arange(W, dtype=torch.float32, device=dev) - cx)[None, None, :]
    i00, i01 = inv[:, 0, 0, None, None], inv[:, 0, 1, None, None]
    i10, i11 = inv[:, 1, 0, None, None], inv[:, 1, 1, None, None]
    sx = i00 * xs + i01 * ys + cx
    sy = i10 * xs + i11 * ys + cy
    ix = torch.round(sx).to(torch.int64)
    iy = torch.round(sy).to(torch.int64)
    valid = (ix >= 0) & (ix < W) & (iy >= 0) & (iy < H)
    flat = iy.clamp(0, H - 1) * W + ix.clamp(0, W - 1)
    gathered = torch.gather(x.reshape(B, H * W), 1,
                            flat.reshape(B, H * W)).reshape(B, H, W)
    out = torch.where(valid, gathered,
                      torch.full((), fill, dtype=x.dtype, device=dev))
    return out[..., None] if squeeze else out


def random_affine_batch(images, generator, degrees: float = 2.0,
                        shear: float = 2.0,
                        scale_range: Tuple[float, float] = (0.95, 1.05),
                        fill: float = -1.0):
    """images (B, H, W, 1) normalised floats; the parameters of each image
    drawn uniformly from ``generator`` (on the images' device)."""
    B = images.shape[0]
    u = torch.rand((3, B), generator=generator, device=images.device)
    deg2rad = math.pi / 180.0
    thetas = (u[0] * (2 * degrees) - degrees) * deg2rad
    shears = (u[1] * (2 * shear) - shear) * deg2rad
    lo, hi = scale_range
    scales = u[2] * (hi - lo) + lo
    return warp(images, thetas, shears, scales, fill)


def augment_and_normalize(images_u8, cfg: DataConfig, generator,
                          dtype=torch.float32):
    """uint8 (B, H, W, 1) -> affine-augmented normalised (B, H, W, 1)."""
    x = images_u8.to(dtype) / 255.0 * 2.0 - 1.0
    return random_affine_batch(x, generator, cfg.aug_degrees, cfg.aug_shear,
                               cfg.aug_scale, fill=-1.0)
