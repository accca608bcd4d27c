"""Building blocks on tensors: linear, layer norm, attention, MLP, heads.

The port of ``handwritten_math_ocr_api_tpu/models/layers.py``. Parameters
are nested dicts of tensors with the JAX package's names and layouts:
linear weights are ``(in, out)`` and multiply as ``x @ w``; the attention
projection is packed ``(D, D + 2 kvd)`` with q, k, v column blocks, kvd = D
for MHA and the KV heads' width under MQA/GQA (``nhead_kv``). The numerics
follow the JAX functions: matmuls in the activation dtype, layer norm
(eps 1e-5) and softmax in float32, attention logits in float32. Every
function casts a weight to the activation dtype where it uses it, so a tree
of float32 master weights trains under a bf16 forward with float32
gradients, as the JAX train step does. ``dropout`` draws its mask from an
explicit ``torch.Generator``.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from ..ops.quant import dequant_matmul, dequant_matmul_plain
from ..parallel.mesh import replicate_on_tensor

Tensor = torch.Tensor


def linear(p, x: Tensor, *, kernels: bool = True) -> Tensor:
    """x @ w + b. A weight-only int8 layer (``w_q``, ``w_scale``) goes
    through the dequant matmul (the kernel on CUDA; its plain version with
    ``kernels=False``), rounded to x's dtype before the bias is added, as
    the JAX function does."""
    if "w_q" in p:
        mm = dequant_matmul if kernels else dequant_matmul_plain
        y = mm(x, p["w_q"], p["w_scale"])
    else:
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


def grouped_attention(q: Tensor, k: Tensor, v: Tensor,
                      mask: Optional[Tensor], num_heads: int) -> Tensor:
    """Attention where k and v may carry fewer heads than q (MQA/GQA).

    q: (..., H, Lq, Dh); k, v: (..., Hkv, Lk, Dh), Hkv | H; query head h
    reads KV head h // (H / Hkv). The query is reshaped to (..., Hkv,
    H / Hkv, Lq, Dh) and k, v gain a group axis of one, so each KV head is
    read once, as the JAX function does. A mask of q's rank gains or
    absorbs the group axis (its head axis is 1, Hkv or H); a mask of rank
    q.ndim + 1 is taken as it is."""
    hkv = k.shape[-3]
    if hkv == num_heads:
        return attention(q, k, v, mask)
    g = num_heads // hkv
    *lead, H, Lq, Dh = q.shape
    qg = q.reshape(*lead, hkv, g, Lq, Dh)
    if mask is not None and mask.dim() == q.dim():
        if mask.shape[-3] == num_heads:  # a mask for each query head
            mask = mask.reshape(*mask.shape[:-3], hkv, g, *mask.shape[-2:])
        else:  # head axis 1 or Hkv: insert the group axis
            mask = mask[..., :, None, :, :]
    out = attention(qg, k[..., :, None, :, :], v[..., :, None, :, :], mask)
    return out.reshape(*lead, H, Lq, Dh)


def mha(p, query: Tensor, kv: Tensor, num_heads: int,
        mask: Optional[Tensor] = None) -> Tensor:
    """torch-style attention with the packed (D, D + 2 kvd) qkv
    projection; query (B, Lq, D), kv (B, Lk, D). The KV heads come from
    the weight's width: kvd = D is MHA, kvd < D grouped (MQA/GQA)."""
    d = query.shape[-1]
    w = p["w_qkv"].to(query.dtype)
    b = p["b_qkv"].to(query.dtype)
    kvd = (w.shape[1] - d) // 2
    kv_heads = num_heads * kvd // d
    q, k, v = (replicate_on_tensor(t) for t in (
        query @ w[:, :d] + b[:d], kv @ w[:, d:d + kvd] + b[d:d + kvd],
        kv @ w[:, d + kvd:] + b[d + kvd:]))
    out = replicate_on_tensor(grouped_attention(
        split_heads(q, num_heads), split_heads(k, kv_heads),
        split_heads(v, kv_heads), mask, num_heads))
    return linear({"w": p["w_out"], "b": p["b_out"]}, merge_heads(out))


def gelu_tanh(x: Tensor) -> Tensor:
    """``jax.nn.gelu``'s default form, the tanh approximation."""
    return F.gelu(x, approximate="tanh")


def dropout(x: Tensor, rate: float, generator=None) -> Tensor:
    """Inverted dropout: each element kept with probability 1 - rate and
    scaled by 1 / (1 - rate); the identity without a generator (the
    deterministic forward) or at rate 0."""
    if generator is None or rate == 0.0:
        return x
    keep = 1.0 - rate
    mask = torch.rand(x.shape, generator=generator, device=x.device) < keep
    return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype,
                                                   device=x.device))


def mlp(p, x: Tensor, activation=torch.relu, *, kernels: bool = True,
        dropout_rate: float = 0.0, generator=None) -> Tensor:
    """fc2(dropout(activation(fc1(x)))); the dropout as ``dropout``."""
    h = activation(linear(p["fc1"], x, kernels=kernels))
    h = dropout(h, dropout_rate, generator)
    return linear(p["fc2"], h, kernels=kernels)


def causal_mask(length: int, device=None) -> Tensor:
    """Additive causal mask: 0 on and below the diagonal, -inf above."""
    return torch.triu(torch.full((length, length), float("-inf"),
                                 device=device), diagonal=1)
