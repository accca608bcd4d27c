"""MHA -> GQA/MQA conversion for fine-tuning (``convert-gqa``).

The port of ``handwritten_math_ocr_api_tpu/train/gqa_convert.py``: the
decoder self-attention's K and V columns of a trained MHA checkpoint are
mean-pooled into ``nhead_kv`` head groups (the GQA paper's uptraining
init); queries, output projections and cross-attention keep every head, as
``ModelConfig.nhead_kv`` is read at run time. The EMA shadow is pooled the
same way. Numpy surgery on the checkpoint's tree.
"""

from __future__ import annotations

import dataclasses
import os
import shutil
from typing import Tuple

import numpy as np

from ..core.config import ModelConfig, TrainConfig
from ..utils import tree
from .vocab_extend import _numpy, _tensors


def _pool_self_attn(sa: dict, d_model: int, nhead: int, head_dim: int,
                    new_kv: int) -> dict:
    """Mean-pool an MHA self-attention's K/V columns into ``new_kv`` head
    groups."""
    w, b = sa["w_qkv"], sa["b_qkv"]
    D = d_model
    kvd = (w.shape[1] - D) // 2
    if kvd != nhead * head_dim:
        raise ValueError(f"source checkpoint is not MHA: kv_dim {kvd} != "
                         f"{nhead}*{head_dim}")
    group = nhead // new_kv

    def pool_cols(cols: np.ndarray) -> np.ndarray:
        h = cols.reshape(*cols.shape[:-1], new_kv, group, head_dim)
        return h.mean(axis=-2).reshape(*cols.shape[:-1],
                                       new_kv * head_dim)

    wq, wk, wv = w[:, :D], w[:, D:D + kvd], w[:, D + kvd:]
    bq, bk, bv = b[:D], b[D:D + kvd], b[D + kvd:]
    out = dict(sa)
    out["w_qkv"] = np.concatenate(
        [wq, pool_cols(wk), pool_cols(wv)], axis=1).astype(w.dtype)
    out["b_qkv"] = np.concatenate(
        [bq, pool_cols(bk), pool_cols(bv)], axis=0).astype(b.dtype)
    return out


def _pool_params(params, cfg: ModelConfig, new_kv: int):
    out = tree.map_tree(lambda x: x, params)  # fresh containers
    out["decoder"]["layers"] = [
        {**layer, "self_attn": _pool_self_attn(
            layer["self_attn"], cfg.d_model, cfg.nhead, cfg.head_dim,
            new_kv)}
        for layer in out["decoder"]["layers"]]
    return out


def convert_to_gqa(checkpoint_dir: str, checkpoint: str, out_dir: str,
                   model_cfg: ModelConfig, nhead_kv: int, device=None
                   ) -> Tuple[str, ModelConfig]:
    """Write ``out_dir/{vocab.json, <checkpoint>}`` with the
    self-attention K/V pooled to ``nhead_kv`` groups, for ``train
    --resume-from --model-overrides '{"nhead_kv": G, ...}'``.
    ``model_cfg`` describes the SOURCE (MHA) checkpoint; the tensors go
    through ``device`` (``cuda`` unless given). Returns (checkpoint path,
    the converted ModelConfig)."""
    from .checkpoint import load_checkpoint, save_checkpoint
    from .step import create_train_state, state_from_params

    if model_cfg.nhead % nhead_kv != 0:
        raise ValueError(f"nhead {model_cfg.nhead} not divisible by "
                         f"nhead_kv {nhead_kv}")
    tc = TrainConfig(ema_decay=0.999)  # a slot for the EMA
    template, optimizer = create_train_state(model_cfg, tc, device=device)
    state, _meta = load_checkpoint(checkpoint_dir, checkpoint, template,
                                   params_only=True)
    dev = state.device
    params = _pool_params(_numpy(state.params), model_cfg, nhead_kv)
    ema = _pool_params(_numpy(state.ema_params), model_cfg, nhead_kv)
    cfg_new = dataclasses.replace(model_cfg, nhead_kv=nhead_kv)
    out_state = state_from_params(_tensors(params, dev), optimizer, tc,
                                  state.model_state, state.step)
    out_state = out_state.replace(ema_params=_tensors(ema, dev))
    os.makedirs(out_dir, exist_ok=True)
    src_vocab = os.path.join(checkpoint_dir, "vocab.json")
    if os.path.exists(src_vocab):
        shutil.copy(src_vocab, os.path.join(out_dir, "vocab.json"))
    path = save_checkpoint(out_dir, checkpoint, out_state, epoch=0,
                           metric=float("inf"),
                           extra={"gqa_from": os.path.join(
                               checkpoint_dir, checkpoint),
                               "nhead_kv": nhead_kv})
    return path, cfg_new
