"""Beam search's cache reorder, a row gather of K and V: CUDA kernel + plain.

Port of ``handwritten_math_ocr_api_tpu/ops/beam_reorder.py``. The kernel
(``csrc/beam_reorder.cu``) replaces the Pallas TPU kernel
``beam_cache_gather``: output row ``r`` of both caches takes input row
``src[r]`` over positions ``[0, t_ext)``, a pure copy in one launch.

The output never aliases the input: a gather in place would overwrite a
parent row that another row still has to read. The wrapper returns fresh
``(L, R, t_ext, D)`` tensors, or writes into a preallocated pair given as
``out`` (positions ``[0, t_ext)`` of it), so that a caller alternating two
cache pairs allocates nothing per step.
"""

from __future__ import annotations

import torch

from . import _build

_ENTRY = "beam_cache_gather"


def _check(self_k, self_v, src, t_ext: int, out):
    L, R, T, D = self_k.shape
    if tuple(self_v.shape) != (L, R, T, D):
        raise ValueError(f"self_v has shape {tuple(self_v.shape)}, expected "
                         f"{(L, R, T, D)}")
    if not 0 < t_ext <= T:
        raise ValueError(f"t_ext {t_ext} not in (0, {T}]")
    if tuple(src.shape) != (R,):
        raise ValueError(f"src has shape {tuple(src.shape)}, expected {(R,)}")
    if R:
        lo, hi = torch.stack(torch.aminmax(src)).tolist()
        if lo < 0 or hi >= R:
            raise ValueError(f"src holds rows outside [0, {R}): "
                             f"{lo} .. {hi}")
    if out is not None:
        for t in out:
            if (t.dim() != 4 or tuple(t.shape[:2]) != (L, R)
                    or t.shape[2] < t_ext or t.shape[3] != D):
                raise ValueError(f"out tensor of shape {tuple(t.shape)} "
                                 f"cannot take (L, R, {t_ext}, D) = "
                                 f"{(L, R, t_ext, D)}")
            for cache in (self_k, self_v):
                if (t.untyped_storage().data_ptr()
                        == cache.untyped_storage().data_ptr()):
                    raise ValueError("out shares memory with the caches: "
                                     "the gather is never in place")


def beam_cache_gather_plain(self_k, self_v, src, t_ext: int, out=None):
    """self_k, self_v (L, R, T, D); src (R,) int rows in [0, R). Returns
    (k, v): row r of each is row src[r] of the input over [0, t_ext),
    fresh (L, R, t_ext, D) tensors, or ``out`` with [0, t_ext) written."""
    _check(self_k, self_v, src, t_ext, out)
    idx = src.long()
    k = self_k[:, idx, :t_ext]
    v = self_v[:, idx, :t_ext]
    if out is None:
        return k, v
    out[0][:, :, :t_ext] = k
    out[1][:, :, :t_ext] = v
    return out


def beam_cache_gather(self_k, self_v, src, t_ext: int, out=None):
    """Same contract as ``beam_cache_gather_plain``; CUDA tensors go to the
    kernel (one launch for both caches, counted), CPU tensors to the plain
    version. ``src`` (int32 on the device) is checked against [0, R) on
    the host before the launch."""
    if not self_k.is_cuda:
        return beam_cache_gather_plain(self_k, self_v, src, t_ext, out)
    L, R, T, D = self_k.shape
    dev, dt = self_k.device, self_k.dtype
    row_bytes = D * self_k.element_size()
    if row_bytes % 16:
        raise ValueError(f"beam reorder kernel copies 16-byte vectors: a "
                         f"row of {D} x {dt} is {row_bytes} bytes")
    _build.require(src, "src", dtype=torch.int32, shape=(R,), device=dev)
    for name, t in (("self_k", self_k), ("self_v", self_v)):
        _build.require(t, name, dtype=dt, shape=(L, R, T, D), device=dev,
                       aligned=True)
    _check(self_k, self_v, src, t_ext, out)
    if out is None:
        out = (torch.empty((L, R, t_ext, D), dtype=dt, device=dev),
               torch.empty((L, R, t_ext, D), dtype=dt, device=dev))
    T_out = out[0].shape[2]
    for name, t in zip(("out k", "out v"), out):
        _build.require(t, name, dtype=dt, shape=(L, R, T_out, D),
                       device=dev, aligned=True)
    code = _build.library().beam_cache_gather(
        self_k.data_ptr(), self_v.data_ptr(), src.data_ptr(),
        out[0].data_ptr(), out[1].data_ptr(), L, R, T, T_out, t_ext,
        row_bytes, _build.stream_handle(dev))
    _build.check(code, _ENTRY)
    _build.count(beam_cache_gather)
    return out


beam_cache_gather.launches = 0
