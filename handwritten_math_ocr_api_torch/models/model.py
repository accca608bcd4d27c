"""The model: ``init_model``, ``encode`` and the teacher-forced
``forward``, the port of ``handwritten_math_ocr_api_tpu/models/model.py``.

Only the Swin-T encoder is ported; the ResNet encoders wait for a later
slice and raise here. ``count_params`` counts a parameter tree's elements,
as the JAX package's does.

The training forward (``forward`` with a generator) runs the plain versions
of the encoder's kernels (``kernels=False``: the kernels have no backward)
on float32 master weights, each cast to ``cfg.dtype`` where an op uses it,
so that the gradients are float32 as in JAX.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from ..core.config import ModelConfig
from ..core.device import resolve_device
from . import layers, swin


def compute_dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def init_model(cfg: ModelConfig, seed: int = 0, device=None
               ) -> Tuple[Dict, Dict]:
    """(params, model_state) of a fresh model: ``convert.init_params``'
    tree as float32 tensors on ``device`` (``cuda`` unless given), and the
    empty model state of a Swin encoder (no BatchNorm statistics)."""
    from ..convert import init_params

    dev = resolve_device(device)

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v) for v in node]
        return torch.from_numpy(node).to(dev)

    return walk(init_params(cfg, seed)), {}


def encode(params, cfg: ModelConfig, images: torch.Tensor, *,
           kernels: bool = True, use_pallas_block: bool = False,
           drops=None) -> torch.Tensor:
    """images: (B, H, W, 1) normalized NHWC -> memory (B, L_enc, d_model)
    in the compute dtype. ``use_pallas_block`` runs the Swin blocks of the
    stages that fuse as whole-block kernels; ``kernels=False`` is the plain
    reference path; ``drops`` the stochastic depth draws
    (``swin.stochastic_depth_masks``)."""
    if cfg.encoder != "swin_t":
        raise NotImplementedError(
            f"encoder {cfg.encoder!r} is not ported yet (swin_t only)")
    images = images.to(compute_dtype(cfg))
    feats = swin.swin_apply(params["encoder"], images, cfg.swin,
                            kernels=kernels,
                            use_pallas_block=use_pallas_block, drops=drops)
    memory = layers.linear(params["projection"], feats)
    if cfg.memory_norm:
        memory = layers.layer_norm(params["memory_norm"], memory)
    return memory


def forward(params, cfg: ModelConfig, images: torch.Tensor,
            captions: torch.Tensor, *, generator=None, remat: bool = False,
            kernels: bool = True) -> torch.Tensor:
    """Teacher-forced forward: float32 logits (B, L - 1, vocab) over
    ``captions[:, :-1]``. ``generator``: the training forward (JAX's
    ``deterministic=False``), whose stochastic depth and dropout draws come
    from it in that order; None is the deterministic forward. ``remat``
    recomputes the encoder in the backward pass
    (``torch.utils.checkpoint``) instead of keeping its activations."""
    from .decoder import decoder_forward  # decoder imports this module

    drops = None
    if generator is not None:
        drops = swin.stochastic_depth_masks(cfg.swin, images.shape[0],
                                            generator, images.device)

    def enc(imgs):
        return encode(params, cfg, imgs, kernels=kernels, drops=drops)

    if remat:
        memory = checkpoint(enc, images, use_reentrant=False)
    else:
        memory = enc(images)
    return decoder_forward(params["decoder"], cfg, memory, captions[:, :-1],
                           generator=generator)


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
