"""One greedy decode step through every decoder layer: CUDA kernel + plain.

Port of ``handwritten_math_ocr_api_tpu/ops/fused_step.py`` for the
compute-only "v2" step (``fused_decoder_layers_step_v2``, body
``_make_kernel_v2``) and its weight bundle (``build_stacked``). The kernel
(``csrc/fused_step.cu``) replaces the Pallas TPU kernel: one launch runs
all L post-norm decoder layers of one step (packed qkv projection,
self-attention over the read-only cache plus the fresh row, output
projection, residual and LayerNorm; cross-attention over the encoder K/V,
residual and LayerNorm; ReLU FFN, residual and LayerNorm) and returns the
last layer's activations and each layer's fresh K/V row. The caller
appends the rows to the caches.

Numerics of the TPU kernel: the activation row is carried in float32
across the sublayers; each matmul input is rounded to the weight dtype and
accumulated in float32; biases and LayerNorm parameters are float32;
attention logits and softmax are float32; the fresh K/V row is rounded to
the cache dtype before it joins attention at slot ``pos``, and slots after
``pos`` are not attended (the TPU kernel's -inf mask).

Caches are merged-head: self ``(L, B, T, D)``, cross ``(L, B, L_enc, D)``,
heads interleaved along D in torch's order. Only the bf16/float32 weight
bundle is ported; the int8 one (``quantize_stacked``) is not.
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

from ..core.config import ModelConfig
from . import _build

_ENTRY = {torch.bfloat16: "fused_decoder_step_bf16",
          torch.float32: "fused_decoder_step_f32"}
WEIGHT_KEYS = ("w_qkv", "w_out", "w_cq", "w_co", "w_ff1", "w_ff2")
BIAS_KEYS = ("b_qkv", "b_out", "b_cq", "b_co", "b_ff1", "b_ff2")


def _leaf(a, dtype, device) -> torch.Tensor:
    t = a if isinstance(a, torch.Tensor) else torch.from_numpy(np.array(a))
    return t.to(device=device, dtype=dtype)


def build_stacked(decoder_params, cfg: ModelConfig,
                  device=None) -> Dict[str, torch.Tensor]:
    """Per-layer decoder weights stacked to ``(L, ...)``, as the JAX
    ``build_stacked``: weights in the compute dtype, biases ``(L, 1, N)``
    and LayerNorm ``(L, 6, D)`` (scale, bias of norm1..norm3) in float32,
    ``w_cq``/``b_cq`` the query columns of the cross-attention projection.
    Leaves may be numpy arrays or tensors; numpy ones land on ``device``
    (the CPU if not given)."""
    layers = decoder_params["layers"]
    D = cfg.d_model
    wdt = getattr(torch, cfg.dtype)
    f32 = torch.float32

    def stack(path, dtype, cols=None):
        out = []
        for lp in layers:
            node = lp
            for key in path:
                node = node[key]
            t = _leaf(node, dtype, device)
            out.append(t[..., :cols] if cols else t)
        return torch.stack(out).contiguous()

    def bias(path, cols=None):
        return stack(path, f32, cols)[:, None, :].contiguous()

    ln = torch.stack([torch.stack([
        _leaf(lp[n][k], f32, device)
        for n in ("norm1", "norm2", "norm3") for k in ("scale", "bias")])
        for lp in layers]).contiguous()
    return {
        "w_qkv": stack(("self_attn", "w_qkv"), wdt),
        "b_qkv": bias(("self_attn", "b_qkv")),
        "w_out": stack(("self_attn", "w_out"), wdt),
        "b_out": bias(("self_attn", "b_out")),
        "w_cq": stack(("cross_attn", "w_qkv"), wdt, D),
        "b_cq": bias(("cross_attn", "b_qkv"), D),
        "w_co": stack(("cross_attn", "w_out"), wdt),
        "b_co": bias(("cross_attn", "b_out")),
        "w_ff1": stack(("ffn", "fc1", "w"), wdt),
        "b_ff1": bias(("ffn", "fc1", "b")),
        "w_ff2": stack(("ffn", "fc2", "w"), wdt),
        "b_ff2": bias(("ffn", "fc2", "b")),
        "ln": ln,
    }


def _heads_attention(q, k, v, nhead: int):
    """q (B, D) float32 pre-scaled; k, v (B, S, D) float32 -> (B, D)."""
    B, S, D = k.shape
    dh = D // nhead
    qh = q.reshape(B, nhead, 1, dh)
    kh = k.reshape(B, S, nhead, dh).transpose(1, 2)
    vh = v.reshape(B, S, nhead, dh).transpose(1, 2)
    probs = torch.softmax(qh @ kh.transpose(-1, -2), dim=-1)
    return (probs @ vh).reshape(B, D)


def fused_decoder_layers_step_v2_plain(stacked, cfg: ModelConfig, x_emb,
                                       self_k, self_v, cross_k, cross_v,
                                       pos: int):
    """x_emb (B, D); self caches (L, B, T, D), read only; cross K/V
    (L, B, L_enc, D), every slot attended (unpadded). Returns
    (x_out (B, D) float32, k_new, v_new (L, B, D) in the cache dtype)."""
    L, B, T, D = self_k.shape
    if not 0 <= pos < T:
        raise ValueError(f"pos {pos} outside the cache of {T} slots")
    H = cfg.nhead
    scale = 1.0 / math.sqrt(D // H)
    wdt = stacked["w_qkv"].dtype
    cdt = self_k.dtype
    ln = stacked["ln"]

    def mm(x, name, bias):
        w = stacked[name][layer].float()
        return x.to(wdt).float() @ w + stacked[bias][layer, 0]

    def norm(x, i):
        return F.layer_norm(x, (D,), ln[layer, 2 * i], ln[layer, 2 * i + 1],
                            1e-5)

    x = x_emb.float()
    k_out, v_out = [], []
    for layer in range(L):
        qkv = mm(x, "w_qkv", "b_qkv")
        q, k_new, v_new = qkv[:, :D], qkv[:, D:2 * D], qkv[:, 2 * D:]
        k_new, v_new = k_new.to(cdt), v_new.to(cdt)
        k_out.append(k_new)
        v_out.append(v_new)
        k = torch.cat([self_k[layer, :, :pos], k_new[:, None]], 1).float()
        v = torch.cat([self_v[layer, :, :pos], v_new[:, None]], 1).float()
        attn = _heads_attention(q * scale, k, v, H)
        x = norm(x + mm(attn, "w_out", "b_out"), 0)

        qc = mm(x, "w_cq", "b_cq")
        attn = _heads_attention(qc * scale, cross_k[layer].float(),
                                cross_v[layer].float(), H)
        x = norm(x + mm(attn, "w_co", "b_co"), 1)

        h = torch.relu(mm(x, "w_ff1", "b_ff1"))
        x = norm(x + mm(h, "w_ff2", "b_ff2"), 2)
    return x, torch.stack(k_out), torch.stack(v_out)


def fused_decoder_layers_step_v2(stacked, cfg: ModelConfig, x_emb, self_k,
                                 self_v, cross_k, cross_v, pos: int):
    """Same contract as ``fused_decoder_layers_step_v2_plain``; CUDA tensors
    go to the kernel (one launch for all layers, counted), CPU tensors to
    the plain version. ``pos`` is a Python int passed by value."""
    if not x_emb.is_cuda:
        return fused_decoder_layers_step_v2_plain(
            stacked, cfg, x_emb, self_k, self_v, cross_k, cross_v, pos)
    L, B, T, D = self_k.shape
    L_enc = cross_k.shape[2]
    H, ff = cfg.nhead, cfg.dim_feedforward
    dt = x_emb.dtype
    dev = x_emb.device
    if dt not in _ENTRY:
        raise ValueError(f"decoder step kernel takes bf16 or float32, "
                         f"not {dt}")
    if D != cfg.d_model or D % H or (D // H) % 8 or ff % 8:
        raise ValueError(f"decoder step kernel needs D = d_model, head dim "
                         f"and FFN width multiples of 8 (D {D}, {H} heads, "
                         f"FFN {ff})")
    if not 0 <= pos < T:
        raise ValueError(f"pos {pos} outside the cache of {T} slots")
    if L_enc < 1:
        raise ValueError("no encoder slots to attend")
    _build.require(x_emb, "x_emb", shape=(B, D), device=dev)
    for name, t in (("self_k", self_k), ("self_v", self_v)):
        _build.require(t, name, dtype=dt, shape=(L, B, T, D), device=dev,
                       aligned=True)
    for name, t in (("cross_k", cross_k), ("cross_v", cross_v)):
        _build.require(t, name, dtype=dt, shape=(L, B, L_enc, D),
                       device=dev, aligned=True)
    shapes = {"w_qkv": (L, D, 3 * D), "w_out": (L, D, D),
              "w_cq": (L, D, D), "w_co": (L, D, D), "w_ff1": (L, D, ff),
              "w_ff2": (L, ff, D)}
    for name, shape in shapes.items():
        _build.require(stacked[name], name, dtype=dt, shape=shape,
                       device=dev, aligned=True)
    for name, key in zip(BIAS_KEYS, WEIGHT_KEYS):
        _build.require(stacked[name], name, dtype=torch.float32,
                       shape=(L, 1, shapes[key][-1]), device=dev)
    _build.require(stacked["ln"], "ln", dtype=torch.float32,
                   shape=(L, 6, D), device=dev)

    x_out = torch.empty((B, D), dtype=torch.float32, device=dev)
    k_new = torch.empty((L, B, D), dtype=dt, device=dev)
    v_new = torch.empty((L, B, D), dtype=dt, device=dev)
    lib = _build.library()
    ptrs = [x_emb.data_ptr()]
    for w, b in zip(WEIGHT_KEYS, BIAS_KEYS):
        ptrs += [stacked[w].data_ptr(), stacked[b].data_ptr()]
    ptrs += [stacked["ln"].data_ptr()]
    ptrs += [t.data_ptr() for t in (self_k, self_v, cross_k, cross_v, x_out,
                                    k_new, v_new)]
    code = getattr(lib, _ENTRY[dt])(
        *ptrs, L, B, T, D, H, ff, L_enc, int(pos),
        _build.stream_handle(dev))
    _build.check(code, _ENTRY[dt])
    fused_decoder_layers_step_v2.launches += 1
    return x_out, k_new, v_new


fused_decoder_layers_step_v2.launches = 0
