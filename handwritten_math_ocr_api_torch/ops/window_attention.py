"""Shifted-window attention core of the Swin encoder: CUDA kernel + plain.

Port of ``handwritten_math_ocr_api_tpu/ops/window_attention.py``. The
kernel (``csrc/window_attention.cu``) replaces the Pallas TPU kernel
``window_attention_core``: one block per (batch, window, head) computes
``softmax(q k^T / sqrt(dh) + mask) v`` in float32 with the logits kept in
shared memory. At Swin-T widths it is memory-bound on the H100 (about 24
flops per byte moved); the source says more.

``window_attention_core`` launches the kernel for CUDA tensors and uses
``window_attention_core_plain`` for CPU tensors; ``fused_window_attention``
wraps it in the qkv and output projections as the JAX function does.
"""

from __future__ import annotations

import math

import torch

from ..models import layers
from . import _build

_ENTRY = {torch.bfloat16: "window_attention_bf16",
          torch.float32: "window_attention_f32"}


def window_attention_core_plain(q, k, v, mask):
    """q, k, v: (B, nW, nh, N, dh); mask: (nW, nh, N, N) float32 additive.
    Float32 logits, softmax and weighted sum, like the TPU kernel."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    logits = (q.float() * scale) @ k.float().transpose(-1, -2) + mask.float()
    probs = torch.softmax(logits, dim=-1)
    return (probs @ v.float()).to(q.dtype)


def window_attention_core(q, k, v, mask):
    """Same contract as ``window_attention_core_plain``; a CUDA tensor goes
    to the kernel (and counts one launch), a CPU tensor to the plain
    version."""
    if not q.is_cuda:
        return window_attention_core_plain(q, k, v, mask)
    B, nW, nh, N, dh = q.shape
    if q.dtype not in _ENTRY:
        raise ValueError(f"window attention kernel takes bf16 or float32, "
                         f"not {q.dtype}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        _build.require(t, name, dtype=q.dtype, shape=q.shape, device=q.device)
    _build.require(mask, "mask", dtype=torch.float32, shape=(nW, nh, N, N),
                   device=q.device)
    out = torch.empty_like(q)
    lib = _build.library()
    code = getattr(lib, _ENTRY[q.dtype])(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), mask.data_ptr(),
        out.data_ptr(), B * nW * nh, N, dh, nW * nh,
        _build.stream_handle(q.device))
    _build.check(code, _ENTRY[q.dtype])
    window_attention_core.launches += 1
    return out


window_attention_core.launches = 0


def fused_window_attention(p, windows, num_heads: int, mask, n_windows: int,
                           *, kernels: bool = True):
    """windows (B*nW, N, C), mask (nW, nh, N, N) or (1, nh, N, N); returns
    (B*nW, N, C) after the output projection. ``kernels=False`` takes the
    plain core even for CUDA tensors (the reference path)."""
    BW, N, C = windows.shape
    B = BW // n_windows
    dh = C // num_heads
    qkv = windows @ p["w_qkv"].to(windows.dtype) + p["b_qkv"].to(windows.dtype)
    q, k, v = qkv.split(C, dim=-1)

    def heads(x):
        return layers.split_heads(x, num_heads).reshape(
            B, n_windows, num_heads, N, dh).contiguous()

    mask_full = mask.float().expand(n_windows, num_heads, N, N).contiguous()
    core = window_attention_core if kernels else window_attention_core_plain
    out = core(heads(q), heads(k), heads(v), mask_full)
    out = layers.merge_heads(out.reshape(BW, num_heads, N, dh))
    return layers.linear({"w": p["w_out"], "b": p["b_out"]}, out)
