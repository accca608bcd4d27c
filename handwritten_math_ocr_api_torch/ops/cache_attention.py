"""KV-cache append + single-query decode attention: CUDA kernel + plain.

Port of ``handwritten_math_ocr_api_tpu/ops/cache_attention.py``. The kernel
(``csrc/cache_attention.cu``) replaces the Pallas TPU kernel
``cache_append_attention``: per (batch, head) it writes the new K/V row at
``pos`` and attends over slots ``0..pos`` in float32, in one pass. It is
bound by device memory (about one flop per byte of cache read).

Unlike the JAX function, which returns aliased caches, the port writes the
new row into ``k_cache`` and ``v_cache`` in place and returns only the
attention output. ``pos`` is a Python int passed by value, so a decode step
makes no host round trip for it.
"""

from __future__ import annotations

import math

import torch

from . import _build

_ENTRY = {torch.bfloat16: "cache_append_attention_bf16",
          torch.float32: "cache_append_attention_f32"}
_MAX_HEAD_DIM = 128  # the kernel's P.V split needs Dh <= its 128 threads


def cache_append_attention_plain(q, k_new, v_new, k_cache, v_cache, pos: int):
    """q, k_new, v_new: (B, H, 1, Dh); caches (B, H, T, Dh), updated in
    place at ``pos``. Returns (B, H, 1, Dh): float32 softmax attention over
    slots 0..pos."""
    k_cache[:, :, pos] = k_new[:, :, 0]
    v_cache[:, :, pos] = v_new[:, :, 0]
    k = k_cache[:, :, :pos + 1].float()
    v = v_cache[:, :, :pos + 1].float()
    scale = 1.0 / math.sqrt(q.shape[-1])
    logits = (q.float() * scale) @ k.transpose(-1, -2)     # (B, H, 1, pos+1)
    probs = torch.softmax(logits, dim=-1)
    return (probs @ v).to(q.dtype)


def cache_append_attention(q, k_new, v_new, k_cache, v_cache, pos: int):
    """Same contract as ``cache_append_attention_plain``; CUDA tensors go to
    the kernel (and count one launch), CPU tensors to the plain version."""
    if not q.is_cuda:
        return cache_append_attention_plain(q, k_new, v_new, k_cache,
                                            v_cache, pos)
    B, H, _, Dh = q.shape
    T = k_cache.shape[2]
    if q.dtype not in _ENTRY:
        raise ValueError(f"cache attention kernel takes bf16 or float32, "
                         f"not {q.dtype}")
    if Dh > _MAX_HEAD_DIM:
        raise ValueError(f"head dim {Dh} > {_MAX_HEAD_DIM}")
    if not 0 <= pos < T:
        raise ValueError(f"pos {pos} outside the cache of {T} slots")
    for name, t in (("q", q), ("k_new", k_new), ("v_new", v_new)):
        _build.require(t, name, dtype=q.dtype, shape=(B, H, 1, Dh),
                       device=q.device)
    for name, t in (("k_cache", k_cache), ("v_cache", v_cache)):
        _build.require(t, name, dtype=q.dtype, shape=(B, H, T, Dh),
                       device=q.device)
    out = torch.empty_like(q)
    lib = _build.library()
    code = getattr(lib, _ENTRY[q.dtype])(
        q.data_ptr(), k_new.data_ptr(), v_new.data_ptr(), k_cache.data_ptr(),
        v_cache.data_ptr(), out.data_ptr(), B * H, T, Dh, int(pos),
        _build.stream_handle(q.device))
    _build.check(code, _ENTRY[q.dtype])
    cache_append_attention.launches += 1
    return out


cache_append_attention.launches = 0
