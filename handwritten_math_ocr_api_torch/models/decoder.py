"""Transformer decoder with torch semantics and a KV-cached decode step.

Port of ``handwritten_math_ocr_api_tpu/models/decoder.py``: token embedding
plus learned positional embedding, N post-norm decoder layers
(self-attention -> add & LN, cross-attention -> add & LN, ReLU FFN -> add &
LN), then the vocab projection in float32. No embedding scaling and no
final decoder LayerNorm.

- ``decoder_forward``: the full teacher-forced pass; with a generator
  (the training forward, JAX's ``deterministic=False``) dropout at
  ``cfg.dropout`` on each sublayer's output and the FFN's hidden layer.
- ``init_cache`` + ``decoder_step``: one token per step against a KV cache.
- ``decoder_step_ragged``: the step with a position per row (continuous
  batching), on plain ops as the JAX function; ``project_cross_kv`` the
  cross-attention K/V of new rows (an admission) without a self cache.
  Cross-attention K/V are computed once from the encoder memory; the self
  cache is ``(B, Hkv, T, Dh)`` per layer, Hkv = ``cfg.kv_heads``. Under MHA
  the step's self-attention is the cache-append attention kernel (the JAX
  ``use_pallas=True`` route), which writes the new K/V row into the cache
  in place; under MQA/GQA (``nhead_kv`` < ``nhead``) the step writes the
  row at ``pos`` and attends through ``layers.grouped_attention`` on plain
  ops, as the JAX function does (its kernel is MHA only).

A tree from ``ops/quant.py::quantize_decoder_params`` (``w_qkv_q``,
``w_out_q``, ``w_q`` with their ``*_scale``) runs every projection and
the head through the dequant matmul kernel, as the JAX functions run
``dequant_matmul``; the cross projection's q, k and v are column slices of
the packed int8 matrix, read in place, and the self projection is one
launch over all its D + 2 kvd columns.

Self-attention takes any ``nhead_kv`` dividing ``nhead`` (MHA, MQA, GQA);
cross-attention is MHA.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F

from ..core.config import ModelConfig
from ..ops.cache_attention import (
    cache_append_attention,
    cache_append_attention_plain,
)
from ..parallel.mesh import replicate_on_tensor
from . import layers
from .model import compute_dtype

Cache = Dict[str, torch.Tensor]


def _embed(params, tgt_ids, positions, dtype):
    # F.embedding, not indexing: on a training mesh its DTensor rules
    # hold a vocab-sharded table (torch 2.11's rule for the backward of an
    # index, index_put, fails on batch-sharded ids)
    tok = replicate_on_tensor(
        F.embedding(tgt_ids, params["embedding"]["table"]))
    pos = F.embedding(positions, params["pos"]["table"])
    return (tok + pos).to(dtype)


def _linear(p, w: str, b: str, x, kernels: bool, cols=slice(None)):
    """x @ p[w][:, cols] + p[b][cols]; from the int8 weight ``{w}_q`` and
    its scales when the tree is quantized (a column slice is a view: no
    weight is copied)."""
    if f"{w}_q" in p:
        lin = {"w_q": p[f"{w}_q"][:, cols], "w_scale": p[f"{w}_scale"][cols]}
    else:
        lin = {"w": p[w][:, cols]}
    lin["b"] = p[b][cols]
    return layers.linear(lin, x, kernels=kernels)


def _proj(p, x, part: str, kernels: bool = True):
    """The q, k or v columns of the packed projection (D, D + 2 kvd)."""
    d = x.shape[-1]
    kvd = ((p["w_qkv_q"] if "w_qkv_q" in p else p["w_qkv"]).shape[1] - d) // 2
    lo, n = {"q": (0, d), "k": (d, kvd), "v": (d + kvd, kvd)}[part]
    return _linear(p, "w_qkv", "b_qkv", x, kernels, slice(lo, lo + n))


def decoder_forward(params, cfg: ModelConfig, memory, tgt_ids, *,
                    generator=None):
    """Teacher-forced full pass. memory (B, L_enc, D); tgt_ids (B, L).
    Returns float32 logits (B, L, vocab). ``generator``: the training
    forward's dropout draws (none: deterministic)."""
    B, L = tgt_ids.shape
    dtype = compute_dtype(cfg)
    positions = torch.arange(L, device=tgt_ids.device)[None, :]
    x = _embed(params, tgt_ids, positions, dtype)
    memory = memory.to(dtype)
    mask = layers.causal_mask(L, device=x.device)
    rate, g = cfg.dropout, generator
    for p in params["layers"]:
        sa = layers.mha(p["self_attn"], x, x, cfg.nhead, mask)
        x = layers.layer_norm(p["norm1"], x + layers.dropout(sa, rate, g))
        ca = layers.mha(p["cross_attn"], x, memory, cfg.nhead)
        x = layers.layer_norm(p["norm2"], x + layers.dropout(ca, rate, g))
        ff = layers.mlp(p["ffn"], x, activation=torch.relu,
                        dropout_rate=rate, generator=g)
        x = layers.layer_norm(p["norm3"], x + layers.dropout(ff, rate, g))
    return layers.linear(params["fc_out"], x.float())


def init_cache(params, cfg: ModelConfig, memory,
               max_len: Optional[int] = None, *,
               kernels: bool = True) -> Cache:
    """Empty self-attention K/V caches (B, Hkv, T, Dh) and the precomputed
    cross-attention K/V (B, H, L_enc, Dh) of every layer. ``kernels=False``
    takes the plain dequant matmul even on CUDA."""
    B = memory.shape[0]
    T = max_len or cfg.max_seq_len
    dtype = compute_dtype(cfg)
    cache = project_cross_kv(params, cfg, memory, kernels=kernels)
    for i in range(len(params["layers"])):
        for kv in ("k", "v"):
            cache[f"self_{kv}_{i}"] = torch.zeros(
                (B, cfg.kv_heads, T, cfg.head_dim), dtype=dtype,
                device=memory.device)
    return cache


def project_cross_kv(params, cfg: ModelConfig, memory, *,
                     kernels: bool = True) -> Cache:
    """The cross-attention K/V (B, H, L_enc, Dh) of every layer for
    ``memory`` (B, L_enc, D), in the compute dtype, without a self cache:
    what the continuous decoder installs at an admission."""
    memory = memory.to(compute_dtype(cfg))
    out: Cache = {}
    for i, p in enumerate(params["layers"]):
        cp = p["cross_attn"]
        for kv in ("k", "v"):
            out[f"cross_{kv}_{i}"] = layers.split_heads(
                _proj(cp, memory, kv, kernels), cfg.nhead)
    return out


def decoder_step(params, cfg: ModelConfig, tok_ids, pos: int, cache: Cache,
                 *, kernels: bool = True):
    """One decode step. tok_ids (B,) int64; pos the step index (int).

    Returns float32 logits (B, vocab). The self-attention caches in
    ``cache`` are updated in place at ``pos``. Equal to ``decoder_forward``
    on the full prefix at its last position (the tests check it).
    ``kernels=False`` takes the plain cache attention (and, on an int8
    tree, the plain dequant matmul) even on CUDA. Under MQA/GQA the
    self-attention is plain grouped attention over the slots up to
    ``pos`` whatever ``kernels`` is (the cache attention kernel is MHA
    only, as the JAX route's). A ``pos`` past the positional table (a
    stream's last segment, whose cache holds whole segments) takes the
    table's last row, as JAX's gather clamps it.
    """
    dtype = compute_dtype(cfg)
    nh, nkv = cfg.nhead, cfg.kv_heads
    D, kvd = cfg.d_model, cfg.kv_dim
    n_pos = params["pos"]["table"].shape[0]
    positions = torch.full_like(tok_ids, min(pos, n_pos - 1))[:, None]
    x = _embed(params, tok_ids[:, None], positions, dtype)   # (B, 1, D)
    attend = (cache_append_attention if kernels
              else cache_append_attention_plain)
    if nkv != nh:  # the slots up to pos, (1, 1, 1, T)
        slot = torch.arange(cache["self_k_0"].shape[2], device=x.device)
        mask = torch.zeros(slot.shape, device=x.device).masked_fill(
            slot > pos, float("-inf"))[None, None, None, :]
    for i, p in enumerate(params["layers"]):
        sp = p["self_attn"]
        qkv = _linear(sp, "w_qkv", "b_qkv", x, kernels)
        q, k_new, v_new = qkv.split([D, kvd, kvd], dim=-1)
        q = layers.split_heads(q, nh).contiguous()
        k_new = layers.split_heads(k_new, nkv).contiguous()
        v_new = layers.split_heads(v_new, nkv).contiguous()
        sk, sv = cache[f"self_k_{i}"], cache[f"self_v_{i}"]
        if nkv == nh:
            sa = attend(q, k_new, v_new, sk, sv, pos)
        else:
            sk[:, :, pos] = k_new[:, :, 0]
            sv[:, :, pos] = v_new[:, :, 0]
            sa = layers.grouped_attention(q, sk, sv, mask, nh)
        sa = _linear(sp, "w_out", "b_out", layers.merge_heads(sa), kernels)
        x = layers.layer_norm(p["norm1"], x + sa)

        cp = p["cross_attn"]
        qc = layers.split_heads(_proj(cp, x, "q", kernels), nh)
        ca = layers.attention(qc, cache[f"cross_k_{i}"], cache[f"cross_v_{i}"])
        ca = _linear(cp, "w_out", "b_out", layers.merge_heads(ca), kernels)
        x = layers.layer_norm(p["norm2"], x + ca)

        ff = layers.mlp(p["ffn"], x, activation=torch.relu, kernels=kernels)
        x = layers.layer_norm(p["norm3"], x + ff)
    logits = layers.linear(params["fc_out"], x.float(), kernels=kernels)
    return logits[:, 0, :]


def decoder_step_ragged(params, cfg: ModelConfig, tok_ids, pos, cache: Cache,
                        *, kernels: bool = True):
    """One decode step with a position per row (continuous batching).
    tok_ids (B,) int; pos (B,) int tensor: row r writes its K/V at slot
    pos[r] of its self caches (in place) and attends slots [0, pos[r]]
    through ``layers.grouped_attention``, on plain ops as the JAX function
    (whose route takes no kernel here). Returns float32 logits (B, vocab).
    A position past the cache or the position table is clamped into it for
    the write and the embedding, as JAX's ``dynamic_update_slice`` and
    gather clamp it (the continuous decoder's finished rows sit there).
    ``kernels=False`` takes the plain dequant matmul on an int8 tree even
    on CUDA."""
    dtype = compute_dtype(cfg)
    nh, nkv = cfg.nhead, cfg.kv_heads
    D, kvd = cfg.d_model, cfg.kv_dim
    pos = pos.long()
    n_pos = params["pos"]["table"].shape[0]
    x = _embed(params, tok_ids[:, None].long(),
               pos.clamp(0, n_pos - 1)[:, None], dtype)      # (B, 1, D)
    T = cache["self_k_0"].shape[2]
    slot = torch.arange(T, device=x.device)
    mask = torch.zeros((pos.shape[0], T), device=x.device).masked_fill(
        slot[None, :] > pos[:, None], float("-inf"))[:, None, None, :]
    rows = torch.arange(pos.shape[0], device=x.device)
    at = pos.clamp(0, T - 1)
    for i, p in enumerate(params["layers"]):
        sp = p["self_attn"]
        qkv = _linear(sp, "w_qkv", "b_qkv", x, kernels)
        q, k_new, v_new = qkv.split([D, kvd, kvd], dim=-1)
        sk, sv = cache[f"self_k_{i}"], cache[f"self_v_{i}"]
        # (B, 1, Hkv dh) -> slot at[r] of row r: (B, Hkv, dh)
        sk[rows, :, at] = k_new[:, 0].reshape(-1, nkv, D // nh).to(sk.dtype)
        sv[rows, :, at] = v_new[:, 0].reshape(-1, nkv, D // nh).to(sv.dtype)
        sa = layers.grouped_attention(layers.split_heads(q, nh), sk, sv,
                                      mask, nh)
        sa = _linear(sp, "w_out", "b_out", layers.merge_heads(sa), kernels)
        x = layers.layer_norm(p["norm1"], x + sa)

        cp = p["cross_attn"]
        qc = layers.split_heads(_proj(cp, x, "q", kernels), nh)
        ca = layers.attention(qc, cache[f"cross_k_{i}"], cache[f"cross_v_{i}"])
        ca = _linear(cp, "w_out", "b_out", layers.merge_heads(ca), kernels)
        x = layers.layer_norm(p["norm2"], x + ca)

        ff = layers.mlp(p["ffn"], x, activation=torch.relu, kernels=kernels)
        x = layers.layer_norm(p["norm3"], x + ff)
    logits = layers.linear(params["fc_out"], x.float(), kernels=kernels)
    return logits[:, 0, :]
