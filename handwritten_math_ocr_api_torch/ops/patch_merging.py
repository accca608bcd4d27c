"""Swin patch merging (2x2 gather + LayerNorm + 4C->2C): CUDA kernel + plain.

Port of ``handwritten_math_ocr_api_tpu/ops/patch_merging.py``. The kernel
(``csrc/patch_merging.cu``) replaces the Pallas TPU kernel
``fused_patch_merging``: it gathers the 2x2 neighbourhood itself, takes
LayerNorm statistics in float32 and does the 4C->2C product with float32
accumulation, so only the (B, H/2, W/2, 2C) output reaches device memory.

``fused_patch_merging`` launches the kernel for CUDA tensors and uses
``patch_merging_plain`` for CPU tensors.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import _build

_ENTRY = {torch.bfloat16: "patch_merging_bf16",
          torch.float32: "patch_merging_f32"}


def patch_merging_plain(p, x):
    """x (B, H, W, C), H and W even -> (B, H/2, W/2, 2C). Quadrant order
    [even/even, odd/even, even/odd, odd/odd]; the normalised 4C vector is
    rounded to x's dtype before the product, like the TPU kernel."""
    cat = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2],
                     x[:, 0::2, 1::2], x[:, 1::2, 1::2]], dim=-1)
    normed = F.layer_norm(cat.float(), cat.shape[-1:],
                          p["norm"]["scale"].float(),
                          p["norm"]["bias"].float(), 1e-5)
    out = normed.to(x.dtype).float() @ p["reduction"]["w"].to(x.dtype).float()
    return out.to(x.dtype)


def fused_patch_merging(p, x):
    """Same contract as ``patch_merging_plain``; a CUDA tensor goes to the
    kernel (and counts one launch), a CPU tensor to the plain version."""
    B, H, W, C = x.shape
    if H % 2 or W % 2:
        raise ValueError("pad H and W to even sizes before patch merging")
    if not x.is_cuda:
        return patch_merging_plain(p, x)
    if x.dtype not in _ENTRY:
        raise ValueError(f"patch merging kernel takes bf16 or float32, "
                         f"not {x.dtype}")
    scale = p["norm"]["scale"].float().contiguous()
    bias = p["norm"]["bias"].float().contiguous()
    w = p["reduction"]["w"].to(x.dtype).contiguous()
    _build.require(x, "x", device=x.device)
    _build.require(scale, "norm scale", shape=(4 * C,), device=x.device)
    _build.require(bias, "norm bias", shape=(4 * C,), device=x.device)
    _build.require(w, "reduction w", shape=(4 * C, 2 * C), device=x.device)
    out = torch.empty((B, H // 2, W // 2, 2 * C), dtype=x.dtype,
                      device=x.device)
    lib = _build.library()
    code = getattr(lib, _ENTRY[x.dtype])(
        x.data_ptr(), scale.data_ptr(), bias.data_ptr(), w.data_ptr(),
        out.data_ptr(), B, H, W, C, _build.stream_handle(x.device))
    _build.check(code, _ENTRY[x.dtype])
    fused_patch_merging.launches += 1
    return out


fused_patch_merging.launches = 0
