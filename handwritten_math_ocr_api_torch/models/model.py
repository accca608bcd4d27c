"""Image -> encoder memory, the port of ``models/model.py::encode``.

Only the Swin-T encoder is ported; the ResNet encoders wait for a later
slice and raise here.
"""

from __future__ import annotations

import torch

from ..core.config import ModelConfig
from . import layers, swin


def compute_dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def encode(params, cfg: ModelConfig, images: torch.Tensor, *,
           kernels: bool = True,
           use_pallas_block: bool = False) -> torch.Tensor:
    """images: (B, H, W, 1) normalized NHWC -> memory (B, L_enc, d_model)
    in the compute dtype. ``use_pallas_block`` runs the Swin blocks of the
    stages that fuse as whole-block kernels; ``kernels=False`` is the plain
    reference path."""
    if cfg.encoder != "swin_t":
        raise NotImplementedError(
            f"encoder {cfg.encoder!r} is not ported yet (swin_t only)")
    images = images.to(compute_dtype(cfg))
    feats = swin.swin_apply(params["encoder"], images, cfg.swin,
                            kernels=kernels,
                            use_pallas_block=use_pallas_block)
    memory = layers.linear(params["projection"], feats)
    if cfg.memory_norm:
        memory = layers.layer_norm(params["memory_norm"], memory)
    return memory
