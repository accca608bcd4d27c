"""Transformer decoder with torch semantics and a KV-cached decode step.

Port of ``handwritten_math_ocr_api_tpu/models/decoder.py``: token embedding
plus learned positional embedding, N post-norm decoder layers
(self-attention -> add & LN, cross-attention -> add & LN, ReLU FFN -> add &
LN), then the vocab projection in float32. No embedding scaling and no
final decoder LayerNorm.

- ``decoder_forward``: the full teacher-forced pass.
- ``init_cache`` + ``decoder_step``: one token per step against a KV cache.
  Cross-attention K/V are computed once from the encoder memory; the self
  cache is ``(B, H, T, Dh)`` per layer. The step's self-attention is the
  cache-append attention kernel (the JAX ``use_pallas=True`` route), which
  writes the new K/V row into the cache in place.

Self-attention is MHA only here (``nhead_kv`` unset), as the kernel is.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from ..core.config import ModelConfig
from ..ops.cache_attention import (
    cache_append_attention,
    cache_append_attention_plain,
)
from . import layers
from .model import compute_dtype

Cache = Dict[str, torch.Tensor]


def _check_mha(cfg: ModelConfig) -> None:
    if cfg.kv_heads != cfg.nhead:
        raise NotImplementedError(
            "MQA/GQA self-attention (nhead_kv < nhead) is not ported yet")


def _embed(params, tgt_ids, positions, dtype):
    tok = params["embedding"]["table"][tgt_ids]
    pos = params["pos"]["table"][positions]
    return (tok + pos).to(dtype)


def _proj(p, x, part: str):
    d = x.shape[-1]
    lo = {"q": 0, "k": d, "v": 2 * d}[part]
    w = p["w_qkv"][:, lo:lo + d].to(x.dtype)
    b = p["b_qkv"][lo:lo + d].to(x.dtype)
    return x @ w + b


def _out_proj(p, x):
    return layers.linear({"w": p["w_out"], "b": p["b_out"]}, x)


def decoder_forward(params, cfg: ModelConfig, memory, tgt_ids):
    """Teacher-forced full pass. memory (B, L_enc, D); tgt_ids (B, L).
    Returns float32 logits (B, L, vocab)."""
    _check_mha(cfg)
    B, L = tgt_ids.shape
    dtype = compute_dtype(cfg)
    positions = torch.arange(L, device=tgt_ids.device)[None, :]
    x = _embed(params, tgt_ids, positions, dtype)
    memory = memory.to(dtype)
    mask = layers.causal_mask(L, device=x.device)
    for p in params["layers"]:
        sa = layers.mha(p["self_attn"], x, x, cfg.nhead, mask)
        x = layers.layer_norm(p["norm1"], x + sa)
        ca = layers.mha(p["cross_attn"], x, memory, cfg.nhead)
        x = layers.layer_norm(p["norm2"], x + ca)
        ff = layers.mlp(p["ffn"], x, activation=torch.relu)
        x = layers.layer_norm(p["norm3"], x + ff)
    return layers.linear(params["fc_out"], x.float())


def init_cache(params, cfg: ModelConfig, memory,
               max_len: Optional[int] = None) -> Cache:
    """Empty self-attention K/V caches (B, H, T, Dh) and the precomputed
    cross-attention K/V (B, H, L_enc, Dh) of every layer."""
    _check_mha(cfg)
    B = memory.shape[0]
    T = max_len or cfg.max_seq_len
    dtype = compute_dtype(cfg)
    memory = memory.to(dtype)
    nh, dh = cfg.nhead, cfg.head_dim
    cache: Cache = {}
    for i, p in enumerate(params["layers"]):
        cp = p["cross_attn"]
        cache[f"cross_k_{i}"] = layers.split_heads(_proj(cp, memory, "k"), nh)
        cache[f"cross_v_{i}"] = layers.split_heads(_proj(cp, memory, "v"), nh)
        cache[f"self_k_{i}"] = torch.zeros((B, nh, T, dh), dtype=dtype,
                                           device=memory.device)
        cache[f"self_v_{i}"] = torch.zeros((B, nh, T, dh), dtype=dtype,
                                           device=memory.device)
    return cache


def decoder_step(params, cfg: ModelConfig, tok_ids, pos: int, cache: Cache,
                 *, kernels: bool = True):
    """One decode step. tok_ids (B,) int64; pos the step index (int).

    Returns float32 logits (B, vocab). The self-attention caches in
    ``cache`` are updated in place at ``pos``. Equal to ``decoder_forward``
    on the full prefix at its last position (the tests check it).
    ``kernels=False`` takes the plain cache attention even on CUDA.
    """
    dtype = compute_dtype(cfg)
    nh = cfg.nhead
    positions = torch.full_like(tok_ids, pos)[:, None]
    x = _embed(params, tok_ids[:, None], positions, dtype)   # (B, 1, D)
    attend = (cache_append_attention if kernels
              else cache_append_attention_plain)
    for i, p in enumerate(params["layers"]):
        sp = p["self_attn"]
        qkv = x @ sp["w_qkv"].to(dtype) + sp["b_qkv"].to(dtype)
        q, k_new, v_new = (layers.split_heads(t, nh).contiguous()
                           for t in qkv.split(cfg.d_model, dim=-1))
        sa = attend(q, k_new, v_new, cache[f"self_k_{i}"],
                    cache[f"self_v_{i}"], pos)
        sa = _out_proj(sp, layers.merge_heads(sa))
        x = layers.layer_norm(p["norm1"], x + sa)

        cp = p["cross_attn"]
        qc = layers.split_heads(_proj(cp, x, "q"), nh)
        ca = layers.attention(qc, cache[f"cross_k_{i}"], cache[f"cross_v_{i}"])
        ca = _out_proj(cp, layers.merge_heads(ca))
        x = layers.layer_norm(p["norm2"], x + ca)

        ff = layers.mlp(p["ffn"], x, activation=torch.relu)
        x = layers.layer_norm(p["norm3"], x + ff)
    logits = layers.linear(params["fc_out"], x.float())
    return logits[:, 0, :]
