"""Train and eval steps over a ``TrainState``.

The port of ``handwritten_math_ocr_api_tpu/train/step.py``: a
teacher-forced forward on ``captions[:, :-1]``, label-smoothed
cross-entropy against ``captions[:, 1:]`` with PAD ignored, the gradients
by autograd, then the optimizer chain of ``optim.py`` (global-norm clip,
Adam, warmup) and the bias-corrected EMA.

The train step runs on plain PyTorch ops (``kernels=False``): the kernels
have no backward, and the JAX step trains on XLA ops too. The params are
float32 master tensors, each cast to ``cfg.dtype`` where the forward uses
it, so that the gradients, Adam's moments and the EMA stay float32. uint8
images are normalised and affine-augmented inside the step; the
augmentation, stochastic depth and dropout draw, in that order, from a
``torch.Generator`` seeded from (seed, step), as JAX folds the step into
its key, so that a resumed run repeats its draws (the draws are not JAX's).
The step updates the state's tensors in place and returns the state with
its step advanced (the JAX step donates its state), and its metrics as
device tensors: no value is read on the host. A ResNet encoder runs in
training mode: the returned state holds its new BatchNorm statistics (the
forward's, under ``remat`` too); the EMA covers the params only, as in
JAX.

The eval step is deterministic and runs the encoder through its kernels on
a CUDA device (window attention in every block, patch merging between the
stages), as JAX's ``make_eval_step(use_pallas=True)``; a ResNet encoder
normalises with the running statistics.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from ..core.config import PAD_ID, DataConfig, ModelConfig, TrainConfig
from ..core.device import resolve_device
from ..data.augment import augment_and_normalize
from ..data.preprocess import normalize
from ..models import model as model_mod
from ..utils import tree
from .losses import smoothed_cross_entropy, token_accuracy
from .optim import Optimizer, make_optimizer


@dataclasses.dataclass
class TrainState:
    params: Any                 # tree of float32 tensors (requires_grad)
    opt_state: Dict             # optim.Optimizer's state
    model_state: Any            # BatchNorm statistics ({} for Swin)
    step: int
    ema_params: Any = None      # the EMA shadow (None: ema_decay 0)

    @property
    def eval_params(self):
        """The params the val pass and an export use: the EMA when it is
        tracked, the iterate otherwise."""
        return self.params if self.ema_params is None else self.ema_params

    @property
    def device(self) -> torch.device:
        return tree.leaves(self.params)[0].device

    def replace(self, **kw) -> "TrainState":
        return dataclasses.replace(self, **kw)


def _copy(params):
    return tree.map_tree(lambda p: p.detach().clone(), params)


def state_from_params(params, optimizer: Optimizer, train_cfg: TrainConfig,
                      model_state=None, step: int = 0) -> TrainState:
    """A state over ``params`` (a tree of float32 tensors, taken as they
    are): a fresh optimizer state and, with ``ema_decay``, an EMA that
    starts as a copy of them."""
    params = tree.map_tree(lambda p: p.detach().requires_grad_(True), params)
    ema = _copy(params) if train_cfg.ema_decay > 0 else None
    return TrainState(params=params,
                      opt_state=optimizer.init(tree.leaves(params)),
                      model_state=model_state or {}, step=step,
                      ema_params=ema)


def create_train_state(model_cfg: ModelConfig, train_cfg: TrainConfig,
                       seed: int = 0, device=None
                       ) -> Tuple[TrainState, Optimizer]:
    """A fresh model (``models/model.init_model`` from ``seed``) on
    ``device`` (``cuda`` unless given) and its optimizer."""
    params, model_state = model_mod.init_model(model_cfg, seed,
                                               resolve_device(device))
    optimizer = make_optimizer(train_cfg)
    return state_from_params(params, optimizer, train_cfg,
                             model_state), optimizer


def step_generator(seed: int, step: int, device) -> torch.Generator:
    """The generator of step ``step`` of a run seeded ``seed``: a
    SplitMix64 mix of the two."""
    z = (int(seed) * 0x9E3779B97F4A7C15
         + (int(step) + 1) * 0xBF58476D1CE4E5B9) & (2 ** 64 - 1)
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & (2 ** 64 - 1)
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & (2 ** 64 - 1)
    g = torch.Generator(device=device)
    g.manual_seed((z ^ (z >> 31)) & (2 ** 63 - 1))
    return g


@torch.no_grad()
def apply_gradients(state: TrainState, grads, optimizer: Optimizer,
                    train_cfg: TrainConfig,
                    encoder_update_scale: float = 1.0) -> torch.Tensor:
    """One optimizer step of ``state`` (in place) on ``grads`` (a list in
    ``utils/tree.leaves``' order of the params, clipped in place): the
    chain's updates, the encoder's times ``encoder_update_scale``, added to
    the params; then the EMA with decay ``min(ema_decay, (1 + step) / (10 +
    step))`` at the state's step, in float32 as the JAX step computes it.
    Returns the gradients' global norm before the clip."""
    leaves = tree.leaves(state.params)
    scales = [encoder_update_scale if p[0] == "encoder" else 1.0
              for p in tree.paths(state.params)]
    updates, grad_norm = optimizer.update(list(grads), state.opt_state,
                                          scales)
    torch._foreach_add_(leaves, updates)
    if state.ema_params is not None:
        s = np.float32(state.step)
        d = np.minimum(np.float32(train_cfg.ema_decay),
                       (np.float32(1) + s) / (np.float32(10) + s))
        ema = tree.leaves(state.ema_params)
        torch._foreach_mul_(ema, float(d))
        torch._foreach_add_(ema, torch._foreach_mul(
            leaves, float(np.float32(1) - d)))
    return grad_norm


def _inputs(images, captions, dev):
    images = torch.as_tensor(images).to(dev, non_blocking=True)
    captions = torch.as_tensor(captions).to(dev, non_blocking=True).long()
    return images, captions


def make_train_step(model_cfg: ModelConfig, train_cfg: TrainConfig,
                    optimizer: Optimizer,
                    data_cfg: Optional[DataConfig] = None,
                    encoder_update_scale: float = 1.0,
                    device=None) -> Callable:
    """``train_step(state, images, captions, seed) -> (state, metrics)``.

    ``images``: uint8 (B, H, W, 1) from the loader, normalised and
    augmented (``data_cfg``'s ranges) in the step, or float images taken as
    normalised. ``encoder_update_scale`` multiplies the encoder's updates
    after the chain: a learning rate of its own under Adam (0 freezes the
    encoder, whose moments still advance, as in JAX). ``metrics``: the
    loss, the token accuracy and the gradients' global norm before the
    clip, float32 device tensors. ``device`` (``cuda`` unless given) is
    where the inputs go; the state must be there."""
    dev = resolve_device(device)
    aug_cfg = data_cfg or DataConfig()
    tc = train_cfg

    def train_step(state: TrainState, images, captions, seed: int
                   ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        images, captions = _inputs(images, captions, dev)
        g = step_generator(seed, state.step, dev)
        if images.dtype == torch.uint8:
            images = augment_and_normalize(images, aug_cfg, g)
        leaves = tree.leaves(state.params)
        logits, new_ms = model_mod.forward(
            state.params, model_cfg, images, captions, generator=g,
            remat=tc.remat, kernels=False, model_state=state.model_state,
            return_state=True)
        targets = captions[:, 1:]
        loss = smoothed_cross_entropy(logits, targets, PAD_ID,
                                      tc.label_smoothing)
        grads = torch.autograd.grad(loss, leaves)
        grad_norm = apply_gradients(state, grads, optimizer, tc,
                                    encoder_update_scale)
        with torch.no_grad():
            metrics = {"loss": loss.detach(),
                       "accuracy": token_accuracy(logits, targets, PAD_ID),
                       "grad_norm": grad_norm}
        return state.replace(step=state.step + 1,
                             model_state=new_ms or state.model_state), metrics

    return train_step


def make_eval_step(model_cfg: ModelConfig, train_cfg: TrainConfig,
                   device=None) -> Callable:
    """``eval_step(state, images, captions) -> (loss, preds)`` on the
    state's ``eval_params``: the deterministic teacher-forced forward
    (uint8 images normalised, not augmented), its label-smoothed loss and
    argmax predictions (B, L - 1); on a CUDA device the encoder runs its
    kernels."""
    dev = resolve_device(device)

    @torch.inference_mode()
    def eval_step(state: TrainState, images, captions):
        images, captions = _inputs(images, captions, dev)
        if images.dtype == torch.uint8:
            images = normalize(images)
        logits = model_mod.forward(state.eval_params, model_cfg, images,
                                   captions, model_state=state.model_state)
        loss = smoothed_cross_entropy(logits, captions[:, 1:], PAD_ID,
                                      train_cfg.label_smoothing)
        return loss, logits.argmax(dim=-1)

    return eval_step
