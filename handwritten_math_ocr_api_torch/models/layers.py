"""Building blocks on tensors: linear, layer norm, attention, MLP, heads.

The port of ``handwritten_math_ocr_api_tpu/models/layers.py``. Parameters
are nested dicts of tensors with the JAX package's names and layouts:
linear weights are ``(in, out)`` and multiply as ``x @ w``; the attention
projection is packed ``(D, 3D)`` with q, k, v column blocks. The numerics
follow the JAX functions: matmuls in the activation dtype, layer norm
(eps 1e-5) and softmax in float32, attention logits in float32.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

Tensor = torch.Tensor


def linear(p, x: Tensor) -> Tensor:
    y = x @ p["w"].to(x.dtype)
    if "b" in p:
        y = y + p["b"].to(x.dtype)
    return y


def layer_norm(p, x: Tensor, eps: float = 1e-5) -> Tensor:
    """Normalize in float32 whatever the activation dtype."""
    y = F.layer_norm(x.float(), x.shape[-1:], p["scale"].float(),
                     p["bias"].float(), eps)
    return y.to(x.dtype)


def split_heads(x: Tensor, num_heads: int) -> Tensor:
    """(..., L, D) -> (..., H, L, Dh)."""
    *lead, L, D = x.shape
    return x.reshape(*lead, L, num_heads, D // num_heads).transpose(-3, -2)


def merge_heads(x: Tensor) -> Tensor:
    """(..., H, L, Dh) -> (..., L, D)."""
    x = x.transpose(-3, -2)
    *lead, L, H, Dh = x.shape
    return x.reshape(*lead, L, H * Dh)


def attention(q: Tensor, k: Tensor, v: Tensor,
              mask: Optional[Tensor] = None) -> Tensor:
    """Scaled dot-product attention over pre-split heads.

    q: (..., H, Lq, Dh); k, v: (..., H, Lk, Dh); mask additive, broadcast
    to (..., H, Lq, Lk). Logits and softmax in float32; the weights are
    cast to v's dtype for the weighted sum, as the JAX function does.
    """
    scale = 1.0 / math.sqrt(q.shape[-1])
    logits = (q * scale).float() @ k.float().transpose(-1, -2)
    if mask is not None:
        logits = logits + mask.float()
    weights = torch.softmax(logits, dim=-1)
    return weights.to(v.dtype) @ v


def mha(p, query: Tensor, kv: Tensor, num_heads: int,
        mask: Optional[Tensor] = None) -> Tensor:
    """torch-style multi-head attention with the packed (D, 3D) qkv
    projection; query (B, Lq, D), kv (B, Lk, D)."""
    d = query.shape[-1]
    w = p["w_qkv"].to(query.dtype)
    b = p["b_qkv"].to(query.dtype)
    if w.shape[1] != 3 * d:
        raise NotImplementedError(
            "MQA/GQA self-attention (nhead_kv < nhead) is not ported yet")
    q = query @ w[:, :d] + b[:d]
    k = kv @ w[:, d:2 * d] + b[d:2 * d]
    v = kv @ w[:, 2 * d:] + b[2 * d:]
    out = attention(split_heads(q, num_heads), split_heads(k, num_heads),
                    split_heads(v, num_heads), mask)
    return linear({"w": p["w_out"], "b": p["b_out"]}, merge_heads(out))


def gelu_tanh(x: Tensor) -> Tensor:
    """``jax.nn.gelu``'s default form, the tanh approximation."""
    return F.gelu(x, approximate="tanh")


def mlp(p, x: Tensor, activation=torch.relu) -> Tensor:
    return linear(p["fc2"], activation(linear(p["fc1"], x)))


def causal_mask(length: int, device=None) -> Tensor:
    """Additive causal mask: 0 on and below the diagonal, -inf above."""
    return torch.triu(torch.full((length, length), float("-inf"),
                                 device=device), diagonal=1)
