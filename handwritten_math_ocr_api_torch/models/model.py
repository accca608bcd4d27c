"""The model: ``init_model``, ``encode`` and the teacher-forced
``forward``, the port of ``handwritten_math_ocr_api_tpu/models/model.py``.

The encoder is chosen by ``cfg.encoder`` as in JAX: Swin-T
(``models/swin.py``), or the ResNet-18 trunk with its height pool and
projection (``resnet18``) and the transformer encoder after them
(``res18trans``, ``models/resnet.py``). The ResNet encoders read their
BatchNorm statistics from the model state (``{"resnet": ...}``; Swin has
none, ``{}``), and a training forward returns the new statistics
(``encode_with_state``, ``forward(return_state=True)``).
``use_pallas_block`` and the encoder kernels apply to Swin only, as in
JAX. ``count_params`` counts a parameter tree's elements, as the JAX
package's does.

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
from . import layers, resnet, swin


def compute_dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def init_model(cfg: ModelConfig, seed: int = 0, device=None
               ) -> Tuple[Dict, Dict]:
    """(params, model_state) of a fresh model: ``convert.init_params``'
    tree as float32 tensors on ``device`` (``cuda`` unless given), and its
    model state (``convert.init_state``: the BatchNorm statistics of a
    ResNet encoder, float32; ``{}`` for Swin)."""
    from ..convert import init_params, init_state, state_to_torch

    dev = resolve_device(device)

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v) for v in node]
        return torch.from_numpy(node).to(dev)

    return (walk(init_params(cfg, seed)),
            state_to_torch(init_state(cfg), dev))


def encode(params, cfg: ModelConfig, images: torch.Tensor, *,
           kernels: bool = True, use_pallas_block: bool = False,
           drops=None, model_state=None) -> torch.Tensor:
    """images: (B, H, W, 1) normalized NHWC -> memory (B, L_enc, d_model)
    in the compute dtype. ``use_pallas_block`` runs the Swin blocks of the
    stages that fuse as whole-block kernels; ``kernels=False`` is the plain
    reference path; ``drops`` the encoder's random draws
    (``encoder_draws``); ``model_state`` the BatchNorm statistics a ResNet
    encoder normalises with."""
    return encode_with_state(params, cfg, images, model_state,
                             kernels=kernels,
                             use_pallas_block=use_pallas_block,
                             drops=drops)[0]


def encode_with_state(params, cfg: ModelConfig, images: torch.Tensor,
                      model_state=None, *, training: bool = False,
                      kernels: bool = True, use_pallas_block: bool = False,
                      drops=None) -> Tuple[torch.Tensor, Dict]:
    """``encode`` -> (memory, new model state). ``training`` normalises a
    ResNet trunk with the batch's statistics and returns the running ones
    moved towards them (JAX's ``training=True``); otherwise the new state
    is the one given (``{}`` for Swin)."""
    images = images.to(compute_dtype(cfg))
    new_state: Dict = {}
    if cfg.encoder == "swin_t":
        feats = swin.swin_apply(params["encoder"], images, cfg.swin,
                                kernels=kernels,
                                use_pallas_block=use_pallas_block,
                                drops=drops)
        memory = layers.linear(params["projection"], feats)
    elif cfg.encoder in ("resnet18", "res18trans"):
        if not model_state or "resnet" not in model_state:
            raise ValueError(f"encoder {cfg.encoder!r} needs its model "
                             "state (the BatchNorm statistics)")
        feats, bn_state = resnet.resnet_apply(
            params["encoder"], model_state["resnet"], images, cfg.resnet,
            training=training)
        new_state["resnet"] = bn_state
        memory = resnet.height_pool_project(params["projection"], feats)
        if cfg.encoder == "res18trans":
            memory = resnet.trans_encoder_apply(
                params["trans_encoder"], memory, cfg, masks=drops)
    else:
        raise ValueError(f"unknown encoder: {cfg.encoder}")
    if cfg.memory_norm:
        memory = layers.layer_norm(params["memory_norm"], memory)
    return memory, new_state


def encoder_draws(cfg: ModelConfig, images: torch.Tensor, generator):
    """The encoder's random draws for a training forward on ``images``:
    Swin's stochastic depth masks, or res18trans's dropout masks; None for
    resnet18, which draws nothing."""
    B, device = images.shape[0], images.device
    if cfg.encoder == "swin_t":
        return swin.stochastic_depth_masks(cfg.swin, B, generator, device)
    if cfg.encoder == "res18trans":
        return resnet.trans_dropout_masks(cfg, B, images.shape[2] // 32,
                                          generator, device)
    return None


def forward(params, cfg: ModelConfig, images: torch.Tensor,
            captions: torch.Tensor, *, generator=None, remat: bool = False,
            kernels: bool = True, model_state=None,
            return_state: bool = False):
    """Teacher-forced forward: float32 logits (B, L - 1, vocab) over
    ``captions[:, :-1]``, and with ``return_state`` the new model state
    beside them. ``generator``: the training forward (JAX's
    ``deterministic=False``), whose encoder draws (``encoder_draws``) and
    decoder dropout come from it in that order; None is the deterministic
    forward. The training forward also normalises a ResNet trunk with the
    batch's statistics, the deterministic one with the running ones.
    ``remat`` recomputes the encoder in the backward pass
    (``torch.utils.checkpoint``) instead of keeping its activations; the draws are made before it, and the new
    state is the forward pass's (the recompute's is dropped)."""
    from .decoder import decoder_forward  # decoder imports this module

    training = generator is not None
    drops = encoder_draws(cfg, images, generator) if training else None

    def enc(imgs):
        return encode_with_state(params, cfg, imgs, model_state,
                                 training=training, kernels=kernels,
                                 drops=drops)

    if remat:
        memory, new_state = checkpoint(enc, images, use_reentrant=False)
    else:
        memory, new_state = enc(images)
    logits = decoder_forward(params["decoder"], cfg, memory,
                             captions[:, :-1], generator=generator)
    return (logits, new_state) if return_state else logits


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
