"""Image -> encoder memory, the port of ``models/model.py::encode``.

Only the Swin-T encoder is ported; the ResNet encoders wait for a later
slice and raise here. ``count_params`` counts a parameter tree's elements,
as the JAX package's does.
"""

from __future__ import annotations

import numpy as np
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


def count_params(params) -> int:
    """Elements of every leaf (tensor or array) of nested dicts and lists."""
    if isinstance(params, dict):
        return sum(count_params(v) for v in params.values())
    if isinstance(params, (list, tuple)):
        return sum(count_params(v) for v in params)
    if params is None:
        return 0
    if isinstance(params, torch.Tensor):
        return params.numel()
    return int(np.size(params))
