"""Shifted-window attention core of the Swin encoder: CUDA kernel + plain.

Port of ``handwritten_math_ocr_api_tpu/ops/window_attention.py``. The
kernels (``csrc/window_attention.cu``) replace the Pallas TPU kernel
``window_attention_core``: per (batch, window, head) group,
``softmax(q k^T / sqrt(dh) + mask) v`` with float32 logits and softmax.
At Swin-T widths it is bound by device memory on the H100 (about 24 flops
per byte moved). The bf16 kernel runs both products on the tensor cores
(the probabilities round to bf16 before the second) and takes windows of
up to 64 tokens and head dims that are multiples of 16 up to 128; the
float32 kernel runs on the CUDA cores. The source says more.

``window_attention_core`` launches a kernel for CUDA tensors and uses
``window_attention_core_plain`` for CPU tensors; ``fused_window_attention``
wraps it in the qkv and output projections as the JAX function does.
"""

from __future__ import annotations

import math

import torch

from ..models import layers
from ..parallel.mesh import replicate_on_tensor
from . import _build

_ENTRY = {torch.bfloat16: "window_attention_bf16",
          torch.float32: "window_attention_f32"}


def window_attention_core_plain(q, k, v, mask):
    """q, k, v: (B, nW, nh, N, dh); mask: (nW, nh, N, N) or (1, nh, N, N)
    float32 additive. Float32 logits, softmax and weighted sum, like the
    TPU kernel."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    logits = (q.float() * scale) @ k.float().transpose(-1, -2) + mask.float()
    probs = torch.softmax(logits, dim=-1)
    return (probs @ v.float()).to(q.dtype)


def check_kernel_shape(q, mask):
    """Raise ``ValueError`` on what the kernels do not take: a dtype other
    than bf16 or float32, a mask of neither (nW, nh, N, N) nor
    (1, nh, N, N), or in bf16 a window of more than 64 tokens or a head
    dim that is not a multiple of 16 up to 128 (the tensor-core tiles)."""
    B, nW, nh, N, dh = q.shape
    if q.dtype not in _ENTRY:
        raise ValueError(f"window attention kernel takes bf16 or float32, "
                         f"not {q.dtype}")
    if mask.dim() != 4 or mask.shape[0] not in (nW, 1) or \
            tuple(mask.shape[1:]) != (nh, N, N):
        raise ValueError(f"mask has shape {tuple(mask.shape)}, expected "
                         f"({nW} or 1, {nh}, {N}, {N})")
    if q.dtype == torch.bfloat16 and (N > 64 or dh % 16 or dh > 128):
        raise ValueError(f"bf16 window attention kernel takes N <= 64 and "
                         f"dh a multiple of 16 up to 128, not N {N}, dh {dh}")


def window_attention_core(q, k, v, mask):
    """Same contract as ``window_attention_core_plain``; a CUDA tensor goes
    to the kernel (and counts one launch), a CPU tensor to the plain
    version. A (1, nh, N, N) mask is read for every window, not copied."""
    if not q.is_cuda:
        return window_attention_core_plain(q, k, v, mask)
    B, nW, nh, N, dh = q.shape
    check_kernel_shape(q, mask)
    for name, t in (("q", q), ("k", k), ("v", v)):
        _build.require(t, name, dtype=q.dtype, shape=q.shape, device=q.device,
                       aligned=q.dtype == torch.bfloat16)
    _build.require(mask, "mask", dtype=torch.float32, device=q.device)
    out = torch.empty_like(q)
    lib = _build.library()
    code = getattr(lib, _ENTRY[q.dtype])(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), mask.data_ptr(),
        out.data_ptr(), B * nW * nh, N, dh, mask.shape[0] * nh,
        _build.stream_handle(q.device))
    _build.check(code, _ENTRY[q.dtype])
    _build.count(window_attention_core)
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
    q, k, v = replicate_on_tensor(qkv).split(C, dim=-1)

    def heads(x):
        return layers.split_heads(x, num_heads).reshape(
            B, n_windows, num_heads, N, dh).contiguous()

    core = window_attention_core if kernels else window_attention_core_plain
    out = replicate_on_tensor(
        core(heads(q), heads(k), heads(v), mask.float().contiguous()))
    out = layers.merge_heads(out.reshape(BW, num_heads, N, dh))
    return layers.linear({"w": p["w_out"], "b": p["b_out"]}, out)
