"""Swin-Tiny encoder on NHWC tensors.

Port of ``handwritten_math_ocr_api_tpu/models/swin.py`` on its Pallas route
(``use_pallas=True``): a 4x4 stride-4 patch embed on 1-channel input, four
stages of pre-norm shifted-window blocks whose attention core is the window
attention kernel, and patch merging between stages through the patch
merging kernel. As in the JAX trunk no final LayerNorm is applied.

Numerics follow torchvision's ``shifted_window_attention`` as the JAX
module does: zero pad to window multiples (padded tokens are not masked,
only the shift mask applies), the shift is clamped to 0 along a padded
dimension that fits in one window, the region mask fills -100, and the
MLP uses the tanh-approximate GELU of ``jax.nn.gelu``.

``use_pallas_block=True`` (the JAX engine's ``pallas_encoder_block``)
runs each block of a stage that passes the reference's route rule
(``ops/swin_block.fits_vmem``: stages 1-3 of Swin-T) as one whole-block
kernel launch; the other stages keep the window attention kernel.

``kernels=False`` runs the plain versions of the kernels even on a CUDA
device; it is the reference path that the kernels are held against.
"""

from __future__ import annotations

import functools
from typing import List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..core.config import SwinConfig
from ..ops.patch_merging import fused_patch_merging, patch_merging_plain
from ..ops.swin_block import (
    fits_vmem,
    fused_swin_block,
    fused_swin_block_plain,
)
from ..ops.window_attention import fused_window_attention
from . import layers

Tensor = torch.Tensor


@functools.lru_cache(maxsize=None)
def relative_position_index(ws: int) -> np.ndarray:
    """(ws*ws, ws*ws) int index into the (2*ws-1)^2 relative bias table."""
    coords = np.stack(np.meshgrid(np.arange(ws), np.arange(ws), indexing="ij"))
    coords = coords.reshape(2, -1)
    rel = coords[:, :, None] - coords[:, None, :]
    rel = rel.transpose(1, 2, 0).astype(np.int64)
    rel[..., 0] += ws - 1
    rel[..., 1] += ws - 1
    rel[..., 0] *= 2 * ws - 1
    return rel.sum(-1)


@functools.lru_cache(maxsize=None)
def shift_attention_mask(pad_h: int, pad_w: int, ws: int,
                         shift_h: int, shift_w: int) -> Optional[np.ndarray]:
    """Additive (num_windows, N, N) mask for shifted windows (-100 between
    regions); None without a shift."""
    if shift_h == 0 and shift_w == 0:
        return None
    region = np.zeros((pad_h, pad_w), np.float32)
    h_slices = ((0, pad_h - ws), (pad_h - ws, pad_h - shift_h),
                (pad_h - shift_h, pad_h))
    w_slices = ((0, pad_w - ws), (pad_w - ws, pad_w - shift_w),
                (pad_w - shift_w, pad_w))
    count = 0
    for h0, h1 in h_slices:
        for w0, w1 in w_slices:
            region[h0:h1, w0:w1] = count
            count += 1
    nwh, nww = pad_h // ws, pad_w // ws
    region = region.reshape(nwh, ws, nww, ws).transpose(0, 2, 1, 3)
    region = region.reshape(nwh * nww, ws * ws)
    diff = region[:, None, :] - region[:, :, None]
    return np.where(diff != 0, -100.0, 0.0).astype(np.float32)


def window_partition(x: Tensor, ws: int) -> Tensor:
    """(B, H, W, C) -> (B * nW, ws*ws, C); H, W divisible by ws."""
    B, H, W, C = x.shape
    x = x.reshape(B, H // ws, ws, W // ws, ws, C).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(B * (H // ws) * (W // ws), ws * ws, C)


def window_unpartition(x: Tensor, ws: int, B: int, H: int, W: int) -> Tensor:
    C = x.shape[-1]
    x = x.reshape(B, H // ws, W // ws, ws, ws, C).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(B, H, W, C)


def attention_mask(p, ws: int, num_heads: int, pad_h: int, pad_w: int,
                   shift_h: int, shift_w: int) -> Tensor:
    """Relative-position bias plus shift mask: (nW or 1, nh, N, N) f32."""
    N = ws * ws
    table = p["rel_bias_table"]
    index = torch.as_tensor(relative_position_index(ws).reshape(-1),
                            device=table.device)
    bias = table.float()[index].reshape(N, N, num_heads).permute(2, 0, 1)
    smask = shift_attention_mask(pad_h, pad_w, ws, shift_h, shift_w)
    if smask is None:
        return bias[None]
    return bias[None] + torch.as_tensor(smask, device=table.device)[:, None]


def window_attention(p, x: Tensor, ws: int, shift: int, num_heads: int, *,
                     kernels: bool = True) -> Tensor:
    """Shifted-window MHA on an NHWC feature map x: (B, H, W, C)."""
    B, H, W, C = x.shape
    pad_b = (ws - H % ws) % ws
    pad_r = (ws - W % ws) % ws
    if pad_b or pad_r:
        x = F.pad(x, (0, 0, 0, pad_r, 0, pad_b))
    pad_h, pad_w = H + pad_b, W + pad_r
    shift_h = 0 if ws >= pad_h else shift
    shift_w = 0 if ws >= pad_w else shift
    if shift_h or shift_w:
        x = torch.roll(x, shifts=(-shift_h, -shift_w), dims=(1, 2))

    windows = window_partition(x, ws)
    n_windows = (pad_h // ws) * (pad_w // ws)
    mask = attention_mask(p, ws, num_heads, pad_h, pad_w, shift_h, shift_w)
    out = fused_window_attention(p, windows, num_heads, mask, n_windows,
                                 kernels=kernels)

    x = window_unpartition(out, ws, B, pad_h, pad_w)
    if shift_h or shift_w:
        x = torch.roll(x, shifts=(shift_h, shift_w), dims=(1, 2))
    if pad_b or pad_r:
        x = x[:, :H, :W, :]
    return x


def swin_block(p, x: Tensor, ws: int, shift: int, num_heads: int, *,
               kernels: bool = True, use_pallas_block: bool = False) -> Tensor:
    """Pre-norm Swin block: x + attn(LN(x)); x + mlp(LN(x)) (inference:
    no stochastic depth). ``use_pallas_block`` takes the whole-block kernel
    where the reference's route rule lets its stage fuse."""
    if use_pallas_block:
        W_pad = -(-x.shape[2] // ws) * ws
        if fits_vmem(x.shape[-1], ws, W_pad, p["mlp"]["fc1"]["w"].shape[1]):
            block = fused_swin_block if kernels else fused_swin_block_plain
            return block(p, x.contiguous(), ws, shift, num_heads)
    h = window_attention(p["attn"], layers.layer_norm(p["norm1"], x), ws,
                         shift, num_heads, kernels=kernels)
    x = x + h
    h = layers.mlp(p["mlp"], layers.layer_norm(p["norm2"], x),
                   activation=layers.gelu_tanh)
    return x + h


def patch_merging(p, x: Tensor, *, kernels: bool = True) -> Tensor:
    """(B, H, W, C) -> (B, H/2, W/2, 2C), zero-padding odd H or W first."""
    B, H, W, C = x.shape
    if H % 2 or W % 2:
        x = F.pad(x, (0, 0, 0, W % 2, 0, H % 2))
    x = x.contiguous()
    return fused_patch_merging(p, x) if kernels else patch_merging_plain(p, x)


def patch_embed(p, images: Tensor) -> Tensor:
    """(B, H, W, Cin) NHWC -> (B, H/4, W/4, C): the 4x4 stride-4 VALID
    convolution written as a patchify and one matmul, then LayerNorm."""
    w = p["conv"]["w"]                                   # (ps, ps, Cin, C)
    ps, _, cin, dim = w.shape
    B, H, W, _ = images.shape
    h, wd = H // ps, W // ps
    patches = images[:, :h * ps, :wd * ps].reshape(B, h, ps, wd, ps, cin)
    patches = patches.permute(0, 1, 3, 2, 4, 5).reshape(B, h, wd,
                                                        ps * ps * cin)
    x = patches @ w.reshape(ps * ps * cin, dim).to(images.dtype)
    x = x + p["conv"]["b"].to(x.dtype)
    return layers.layer_norm(p["norm"], x)


def swin_apply_stages(params, images: Tensor, cfg: SwinConfig, *,
                      kernels: bool = True,
                      use_pallas_block: bool = False) -> List[Tensor]:
    """The trunk with its taps: [patch-embed out, stage-1 out (after its
    blocks, before the merge), ..., last-stage out], each (B, h, w, C)."""
    x = patch_embed(params["patch_embed"], images)
    taps = [x]
    ws = cfg.window_size
    for i, depth in enumerate(cfg.depths):
        blocks = params["stages"][i]["blocks"]
        for d in range(depth):
            shift = 0 if d % 2 == 0 else ws // 2
            x = swin_block(blocks[d], x, ws, shift, cfg.num_heads[i],
                           kernels=kernels,
                           use_pallas_block=use_pallas_block)
        taps.append(x)
        if i < len(cfg.depths) - 1:
            x = patch_merging(params["merges"][i], x, kernels=kernels)
    return taps


def swin_apply(params, images: Tensor, cfg: SwinConfig, *,
               kernels: bool = True, use_pallas_block: bool = False) -> Tensor:
    """Full Swin trunk: (B, H, W, 1) -> (B, H/32 * W/32, 768)."""
    x = swin_apply_stages(params, images, cfg, kernels=kernels,
                          use_pallas_block=use_pallas_block)[-1]
    B, H, W, C = x.shape
    return x.reshape(B, H * W, C)
