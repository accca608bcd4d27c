"""Swin patch merging (2x2 gather + LayerNorm + 4C->2C): CUDA kernel + plain.

Port of ``handwritten_math_ocr_api_tpu/ops/patch_merging.py``. The kernel
(``csrc/patch_merging.cu``) replaces the Pallas TPU kernel
``fused_patch_merging``: it gathers the 2x2 neighbourhood itself, takes
LayerNorm statistics in float32 and does the 4C->2C product with float32
accumulation, so only the (B, H/2, W/2, 2C) output reaches device memory.
The bf16 entry runs the product on the tensor cores, a tile of 32 tokens
by 64 to 192 output columns a block (``tile_plan``); the float32 entry on
the CUDA cores (no TF32).

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


SMEM_LIMIT = 232448  # bytes of shared memory a block may use on sm_90
KT, STAGES = 32, 3   # csrc/mma_pass.cuh: rows a staged weight tile, ring tiles
ROWS = 32            # output tokens a block


def tile_plan(M: int, C: int, sms: int):
    """(columns, shared memory bytes) of a bf16 block of 32 output tokens,
    for M tokens of width 2C on a card of ``sms`` SMs: the widest of 192
    and 128 columns whose grid still fills 7/8 of the SMs (fewer blocks
    gather and normalise each token), else 64 (32 where 64 does not divide
    2C). On an H100 at 16 images that is 192, 192 and 64 columns at Swin-T's
    three merges, the fastest tile of each in a sweep of 32 or 64 rows by 32
    to 256 columns (``kernel_ab.py encoder``)."""
    if C % 16:
        raise ValueError(f"bf16 patch merging kernel needs C a multiple of "
                         f"16 (16-byte loads and 32-column tiles), not {C}")
    row_blocks = -(-M // ROWS)
    cols = next((c for c in (192, 128) if (2 * C) % c == 0
                 and row_blocks * (2 * C // c) * 8 >= 7 * sms),
                64 if (2 * C) % 64 == 0 else 32)
    smem = 2 * (ROWS * (4 * C + 8) + STAGES * KT * (cols + 8))
    if smem > SMEM_LIMIT:
        raise ValueError(f"bf16 patch merging kernel: C = {C} needs more "
                         f"than the {SMEM_LIMIT} bytes of shared memory a "
                         f"block may use")
    return cols, smem


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
    vectors = x.dtype == torch.bfloat16  # 16-byte loads and copies
    _build.require(x, "x", device=x.device, aligned=vectors)
    _build.require(scale, "norm scale", shape=(4 * C,), device=x.device,
                   aligned=vectors)
    _build.require(bias, "norm bias", shape=(4 * C,), device=x.device,
                   aligned=vectors)
    _build.require(w, "reduction w", shape=(4 * C, 2 * C), device=x.device,
                   aligned=vectors)
    out = torch.empty((B, H // 2, W // 2, 2 * C), dtype=x.dtype,
                      device=x.device)
    tiles = ()
    if x.dtype == torch.bfloat16:
        tiles = tile_plan(B * (H // 2) * (W // 2), C,
                          _build.sm_count(x.device))
    lib = _build.library()
    code = getattr(lib, _ENTRY[x.dtype])(
        x.data_ptr(), scale.data_ptr(), bias.data_ptr(), w.data_ptr(),
        out.data_ptr(), B, H, W, C, *tiles, _build.stream_handle(x.device))
    _build.check(code, _ENTRY[x.dtype])
    _build.count(fused_patch_merging)
    return out


fused_patch_merging.launches = 0
