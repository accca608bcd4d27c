"""Vocabulary extension for fine-tuning: append tokens, resize the head.

The port of ``handwritten_math_ocr_api_tpu/train/vocab_extend.py``. New
tokens are appended after the existing ids (an extended vocab need not be
sorted) and exactly the three vocab-sized leaves grow:

- ``decoder/embedding/table`` (V, d): new rows at the mean of the old rows
  plus N(0, 0.02^2) noise;
- ``decoder/fc_out/w`` (d, V): new columns N(0, 0.02^2);
- ``decoder/fc_out/b`` (V,): new biases at the old minimum,

so the logits of the old tokens are unchanged. The EMA shadow grows with
the same noise. Numpy surgery on the checkpoint's tree, with the JAX
function's draws: the same source gives the same extended tree.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.config import ModelConfig, TrainConfig
from ..core.tokenizer import load_vocab, save_vocab
from ..utils import tree


def extend_vocab_map(vocab: Dict[str, int],
                     new_tokens: Sequence[str]) -> Dict[str, int]:
    """Append ``new_tokens`` (deduplicated, sorted) after the last id."""
    out = dict(vocab)
    nxt = max(out.values()) + 1
    for tok in sorted(set(new_tokens) - set(out)):
        out[tok] = nxt
        nxt += 1
    return out


def _numpy(node):
    return tree.map_tree(lambda t: t.detach().cpu().numpy(), node)


def _grow(params, old_v: int, new_v: int, rng: np.random.Generator):
    """A copy of the numpy tree ``params`` with the three vocab-sized
    decoder leaves grown from ``old_v`` to ``new_v`` rows."""
    dec = params["decoder"]
    emb = dec["embedding"]["table"]
    if emb.shape[0] != old_v:
        raise ValueError(f"embedding has {emb.shape[0]} rows, the vocab "
                         f"{old_v}")
    d_model = emb.shape[1]
    n_new = new_v - old_v
    mean_row = emb.mean(axis=0, keepdims=True)
    new_rows = (mean_row
                + rng.normal(0.0, 0.02, (n_new, d_model))).astype(emb.dtype)
    w, b = dec["fc_out"]["w"], dec["fc_out"]["b"]
    new_w = rng.normal(0.0, 0.02, (d_model, n_new)).astype(w.dtype)
    new_b = np.full((n_new,), float(b.min()), dtype=b.dtype)
    out = tree.map_tree(lambda x: x, params)  # fresh containers
    out["decoder"]["embedding"]["table"] = np.concatenate([emb, new_rows])
    out["decoder"]["fc_out"]["w"] = np.concatenate([w, new_w], axis=1)
    out["decoder"]["fc_out"]["b"] = np.concatenate([b, new_b])
    return out


def _tensors(node, device):
    return tree.map_tree(
        lambda a: torch.from_numpy(np.array(a)).to(device), node)


def extend_checkpoint(checkpoint_dir: str, checkpoint: str, out_dir: str,
                      model_cfg: ModelConfig,
                      new_tokens: Optional[Sequence[str]] = None,
                      seed: int = 0, device=None) -> Tuple[str, List[str]]:
    """Write ``out_dir/{vocab.json, <checkpoint>}``: the extended vocab
    and a resized checkpoint for ``train --resume-from`` (a fresh optimizer
    state of the default chain, epoch 0, no best metric). ``model_cfg``
    describes the SOURCE checkpoint (its vocab size is taken from the
    source vocab). The tensors go through ``device`` (``cuda`` unless
    given). Returns (checkpoint path, the added tokens)."""
    from .checkpoint import load_checkpoint, save_checkpoint
    from .step import create_train_state, state_from_params

    if new_tokens is None:
        from ..data.synthetic import ENV_TOKENS
        new_tokens = ENV_TOKENS

    vocab, _ = load_vocab(os.path.join(checkpoint_dir, "vocab.json"))
    old_v = max(vocab.values()) + 1
    new_vocab = extend_vocab_map(vocab, new_tokens)
    added = [t for t in new_vocab if t not in vocab]
    new_v = max(new_vocab.values()) + 1

    mc_old = dataclasses.replace(model_cfg, vocab_size=old_v)
    tc = TrainConfig(ema_decay=0.999)  # a slot for the EMA
    template, optimizer = create_train_state(mc_old, tc, device=device)
    state, _meta = load_checkpoint(checkpoint_dir, checkpoint, template,
                                   params_only=True)
    dev = state.device
    params = _grow(_numpy(state.params), old_v, new_v,
                   np.random.default_rng(seed))
    # the same noise for the shadow: its new rows equal the params'
    ema = _grow(_numpy(state.ema_params), old_v, new_v,
                np.random.default_rng(seed))
    out_state = state_from_params(_tensors(params, dev), optimizer, tc,
                                  state.model_state, state.step)
    out_state = out_state.replace(ema_params=_tensors(ema, dev))

    os.makedirs(out_dir, exist_ok=True)
    save_vocab(new_vocab, os.path.join(out_dir, "vocab.json"))
    path = save_checkpoint(out_dir, checkpoint, out_state, epoch=0,
                           metric=float("inf"),
                           extra={"extended_from": os.path.join(
                               checkpoint_dir, checkpoint),
                               "added_tokens": added})
    return path, added
