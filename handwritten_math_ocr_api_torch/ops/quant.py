"""Weight-only int8 for the decoder: quantization, and the dequant matmul
as a CUDA kernel + plain.

Port of ``handwritten_math_ocr_api_tpu/ops/quant.py`` (``DecodeEngine(
quantize=True)`` on the default route). Weights are quantized symmetric
per output column: ``scale = absmax / 127`` (1.0 for an all-zero
column), ``w_q = clip(round(w / scale), -127, 127)`` as int8 (round half
to even), all in float32. Because the scale is per output column, it
commutes with the matmul: ``(x @ w_q) * scale == x @ (w_q * scale)``, so
the int8 weight is converted after its (half-sized) load and the scale
applies to the float32 sum.

``dequant_matmul`` is the kernel ``csrc/dequant_matmul.cu`` (B9, which
replaces the Pallas TPU kernel ``_dequant_matmul_pallas``; a bf16 x on the
tensor cores, the int8 weight converted to bf16 in registers, a float32 x
on the CUDA cores) for CUDA tensors, counted in
``dequant_matmul.launches``, and
``dequant_matmul_plain`` for CPU tensors. Both give
``round_to_x_dtype((x @ w_q) * scale)`` accumulated in float32, with no
bias: the caller adds it after the rounding, as the JAX ``linear`` does.
The weight may be a column slice of a wider int8 matrix (the cross
projection's q, k or v columns of the packed ``w_qkv_q``): the kernel
takes its row stride, so no weight is copied.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from . import _build

QUANT_KEYS = ("w", "w_qkv", "w_out")  # linear-like weights to quantize
_ENTRY = {torch.bfloat16: "dequant_matmul_bf16",
          torch.float32: "dequant_matmul_f32"}
# What the C entries return for a K whose operands exceed a block's shared
# memory (``csrc/dequant_matmul.cu``: kRefused).
REFUSED = -1


def _tensor(a) -> torch.Tensor:
    return a if isinstance(a, torch.Tensor) else torch.from_numpy(
        np.array(a))


def quantize_weight(w) -> Tuple[torch.Tensor, torch.Tensor]:
    """(..., in, out) float -> (int8 of the same shape, float32 scale
    (..., out)): symmetric per output column, over the ``in`` axis."""
    w = _tensor(w).float()
    absmax = w.abs().amax(dim=-2)
    scale = torch.where(absmax > 0, absmax / 127.0,
                        torch.ones_like(absmax))
    w_q = torch.clamp(torch.round(w / scale.unsqueeze(-2)), -127, 127)
    return w_q.to(torch.int8), scale


def _quantize_tree(p):
    if isinstance(p, dict):
        out = {}
        for k, v in p.items():
            if k in QUANT_KEYS and getattr(v, "ndim", 0) == 2:
                out[f"{k}_q"], out[f"{k}_scale"] = quantize_weight(v)
            else:
                out[k] = _quantize_tree(v)
        return out
    if isinstance(p, (list, tuple)):
        return [_quantize_tree(x) for x in p]
    return p


def quantize_decoder_params(decoder_params: Dict) -> Dict:
    """Every 2-D linear weight of the decoder layers and of ``fc_out`` as
    ``{k}_q`` (int8) and ``{k}_scale`` (float32); embeddings, positional
    tables, LayerNorms and biases stay as they are. Leaves may be numpy
    arrays or tensors; the quantized ones come back as tensors."""
    out = dict(decoder_params)
    out["layers"] = _quantize_tree(decoder_params["layers"])
    out["fc_out"] = _quantize_tree(decoder_params["fc_out"])
    return out


def _leaves(node):
    if isinstance(node, dict):
        for v in node.values():
            yield from _leaves(v)
    elif isinstance(node, (list, tuple)):
        for v in node:
            yield from _leaves(v)
    else:
        yield node


def quantized_bytes(decoder_params: Dict) -> Tuple[int, int]:
    """(bf16 bytes, int8 + float32 scale bytes) of the 2-D weights a decode
    step streams: what quantization saves."""
    fsum = qsum = 0
    for leaf in _leaves(decoder_params):
        if getattr(leaf, "ndim", 0) == 2:
            n = int(np.prod(leaf.shape))
            fsum += n * 2
            qsum += n + leaf.shape[-1] * 4
    return fsum, qsum


def dequant_matmul_plain(x, w_q, scale):
    """x (..., K) @ int8 w_q (K, N), per-column float32 scale (N,) ->
    (..., N) in x's dtype."""
    return ((x.float() @ w_q.float()) * scale).to(x.dtype)


def dequant_matmul(x, w_q, scale):
    """Same contract as ``dequant_matmul_plain``; CUDA tensors go to the
    kernel (one launch, counted), CPU tensors to the plain version. x is
    bf16 (the layers) or float32 (the head); w_q needs unit column stride
    and may have any row stride."""
    if not x.is_cuda:
        return dequant_matmul_plain(x, w_q, scale)
    K, N = w_q.shape
    dt = x.dtype
    dev = x.device
    if dt not in _ENTRY:
        raise ValueError(f"dequant matmul kernel takes bf16 or float32 x, "
                         f"not {dt}")
    if x.shape[-1] != K:
        raise ValueError(f"x has {x.shape[-1]} features, the weight {K} rows")
    if w_q.dtype != torch.int8 or w_q.device != dev:
        raise ValueError(f"w_q must be int8 on {dev}, not {w_q.dtype} on "
                         f"{w_q.device}")
    if w_q.stride(1) != 1 or w_q.stride(0) < N:
        raise ValueError("w_q needs unit column stride and row stride >= "
                         "its columns")
    if (scale.dtype != torch.float32 or tuple(scale.shape) != (N,)
            or scale.stride(0) != 1 or scale.device != dev):
        raise ValueError(f"scale must be float32 ({N},) with unit stride on "
                         f"{dev}")
    x2 = x.reshape(-1, K).contiguous()
    M = x2.shape[0]
    y = torch.empty((M, N), dtype=dt, device=dev)
    if M == 0:
        return y.reshape(*x.shape[:-1], N)
    # the kernel picks its tiles by M and stages rows that are not 16-byte
    # aligned (the 138-column head's 138-byte rows) element by element
    code = getattr(_build.library(), _ENTRY[dt])(
        x2.data_ptr(), w_q.data_ptr(), scale.data_ptr(), y.data_ptr(), M, K,
        N, w_q.stride(0), _build.stream_handle(dev))
    if code == REFUSED:
        raise ValueError(f"the dequant matmul kernel does not stage K {K} "
                         f"in shared memory ({M} rows, {dt})")
    _build.check(code, _ENTRY[dt])
    _build.count(dequant_matmul)
    return y.reshape(*x.shape[:-1], N)


dequant_matmul.launches = 0
