"""Single-query decode attention over a KV cache, with and without the
append of the new row: CUDA kernels + plain.

Port of ``handwritten_math_ocr_api_tpu/ops/cache_attention.py`` and
``ops/decode_attention.py``. The kernels (``csrc/cache_attention.cu``)
replace the Pallas TPU kernels ``cache_append_attention``, which per
(batch, head) writes the new K/V row at ``pos`` and attends over slots
``0..pos`` in float32 in one pass, and ``decode_attention``, the same
attention over the cache as it is, nothing written. Both are bound by
device memory (about one flop per byte of cache read); the kernel stages
the prefix in shared memory with 16-byte copies, so a cache row must be a
power-of-two number of 16-byte vectors and every tensor must start on a
16-byte boundary (the wrappers raise ``ValueError`` otherwise).

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
_DECODE_ENTRY = {torch.bfloat16: "decode_attention_bf16",
                 torch.float32: "decode_attention_f32"}
_MAX_HEAD_DIM = 128  # float32 rows of 32 vectors: one warp's butterfly


def decode_attention_plain(q, k_cache, v_cache, pos: int):
    """q: (B, H, 1, Dh); caches (B, H, T, Dh), read only. Returns
    (B, H, 1, Dh): float32 softmax attention over slots 0..pos."""
    k = k_cache[:, :, :pos + 1].float()
    v = v_cache[:, :, :pos + 1].float()
    scale = 1.0 / math.sqrt(q.shape[-1])
    logits = (q.float() * scale) @ k.transpose(-1, -2)     # (B, H, 1, pos+1)
    probs = torch.softmax(logits, dim=-1)
    return (probs @ v).to(q.dtype)


def cache_append_attention_plain(q, k_new, v_new, k_cache, v_cache, pos: int):
    """q, k_new, v_new: (B, H, 1, Dh); caches (B, H, T, Dh), updated in
    place at ``pos``. Returns (B, H, 1, Dh): float32 softmax attention over
    slots 0..pos."""
    k_cache[:, :, pos] = k_new[:, :, 0]
    v_cache[:, :, pos] = v_new[:, :, 0]
    return decode_attention_plain(q, k_cache, v_cache, pos)


def check_kernel_shape(q, k_cache, pos: int):
    """Raise ``ValueError`` on what the kernel does not take: a dtype other
    than bf16 or float32, a head dim above 128, a cache row that is not 1,
    2, 4, ... or 32 16-byte vectors (the kernel's 16-byte copies, and the
    butterfly over the vectors of a row), or ``pos`` outside the cache."""
    if q.dtype not in _ENTRY:
        raise ValueError(f"cache attention kernel takes bf16 or float32, "
                         f"not {q.dtype}")
    Dh = q.shape[-1]
    if Dh > _MAX_HEAD_DIM:
        raise ValueError(f"head dim {Dh} > {_MAX_HEAD_DIM}")
    row_bytes = Dh * q.element_size()
    nvec = row_bytes // 16
    if row_bytes % 16 or nvec & (nvec - 1):
        raise ValueError(f"head dim {Dh} gives {row_bytes}-byte cache rows; "
                         f"the kernel copies rows of 16 x 2^k bytes")
    if not 0 <= pos < k_cache.shape[2]:
        raise ValueError(f"pos {pos} outside the cache of "
                         f"{k_cache.shape[2]} slots")


def cache_append_attention(q, k_new, v_new, k_cache, v_cache, pos: int):
    """Same contract as ``cache_append_attention_plain``; CUDA tensors go to
    the kernel (and count one launch), CPU tensors to the plain version."""
    if not q.is_cuda:
        return cache_append_attention_plain(q, k_new, v_new, k_cache,
                                            v_cache, pos)
    B, H, _, Dh = q.shape
    T = k_cache.shape[2]
    check_kernel_shape(q, k_cache, pos)
    for name, t in (("q", q), ("k_new", k_new), ("v_new", v_new)):
        _build.require(t, name, dtype=q.dtype, shape=(B, H, 1, Dh),
                       device=q.device, aligned=True)
    for name, t in (("k_cache", k_cache), ("v_cache", v_cache)):
        _build.require(t, name, dtype=q.dtype, shape=(B, H, T, Dh),
                       device=q.device, aligned=True)
    out = torch.empty_like(q)
    lib = _build.library()
    code = getattr(lib, _ENTRY[q.dtype])(
        q.data_ptr(), k_new.data_ptr(), v_new.data_ptr(), k_cache.data_ptr(),
        v_cache.data_ptr(), out.data_ptr(), B * H, T, Dh, int(pos),
        _build.stream_handle(q.device))
    _build.check(code, _ENTRY[q.dtype])
    _build.count(cache_append_attention)
    return out


cache_append_attention.launches = 0


def decode_attention(q, k_cache, v_cache, pos: int):
    """Same contract as ``decode_attention_plain``; CUDA tensors go to the
    kernel (and count one launch), CPU tensors to the plain version.
    ``pos`` is a Python int passed by value."""
    if not q.is_cuda:
        return decode_attention_plain(q, k_cache, v_cache, pos)
    B, H, _, Dh = q.shape
    T = k_cache.shape[2]
    check_kernel_shape(q, k_cache, pos)
    _build.require(q, "q", shape=(B, H, 1, Dh), device=q.device,
                   aligned=True)
    for name, t in (("k_cache", k_cache), ("v_cache", v_cache)):
        _build.require(t, name, dtype=q.dtype, shape=(B, H, T, Dh),
                       device=q.device, aligned=True)
    out = torch.empty_like(q)
    code = getattr(_build.library(), _DECODE_ENTRY[q.dtype])(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), out.data_ptr(),
        B * H, T, Dh, int(pos), _build.stream_handle(q.device))
    _build.check(code, _DECODE_ENTRY[q.dtype])
    _build.count(decode_attention)
    return out


decode_attention.launches = 0
