"""ResNet-18 encoders on tensors: the trunk with functional BatchNorm, the
height pool and projection, and the res18trans transformer encoder.

Port of ``handwritten_math_ocr_api_tpu/models/resnet.py``. "Model C" of the
reference is a 1-channel ResNet-18 trunk (the stem's 7x7/2 convolution,
BatchNorm, ReLU and 3x3/2 max pool, then four stages of two basic blocks
whose first block in stages 2-4 has a strided 1x1 downsample), a mean over
the height and a linear projection to ``d_model``: ``W / 32`` memory
columns (10 at 96x320). "Model B" (``res18trans``) adds a post-norm
transformer encoder over those columns, with a learned positional table.

The parameter tree keeps the JAX package's layout and names: convolution
weights ``{"w"}`` in HWIO, BatchNorm ``{"scale", "bias"}`` in the params
and ``{"mean", "var"}`` in a separate state tree. The convolutions run as
``F.conv2d`` on NCHW views in the channels-last memory format, each weight
taken to OIHW where it is used (the 1x1 downsample as a matmul on the
strided pixels); none of them is a kernel of this package,
as JAX computes them with ``lax.conv_general_dilated`` outside any Pallas
kernel.

BatchNorm follows torch's semantics as the JAX function does, without
updating anything in place: eval mode normalises with the running
statistics; training mode with the float32 batch mean and biased variance
over N, H and W, and returns running statistics moved by momentum 0.1
towards the batch mean and the unbiased variance (eps 1e-5; the result is
cast back to the input's dtype). The new statistics carry no gradient.

The transformer encoder's dropout masks are drawn before the forward
(``trans_dropout_masks``, from the caller's ``torch.Generator``), so that
a recomputed forward (``remat``) applies the same ones.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from ..core.config import ModelConfig, ResNetConfig
from . import layers

Tensor = torch.Tensor


def _conv(p, x: Tensor, stride: int, padding: int) -> Tensor:
    """x: (B, C, H, W) channels-last; the HWIO weight as OIHW in x's
    dtype."""
    w = p["w"].to(x.dtype).permute(3, 2, 0, 1).contiguous(
        memory_format=torch.channels_last)
    return F.conv2d(x, w, stride=stride, padding=padding)


def _downsample(p, x: Tensor, stride: int) -> Tensor:
    """The 1x1 strided convolution as the product of the strided pixels
    with the (C_in, C_out) weight, the same function (oneDNN's backward of
    this convolution corrupts memory in torch 2.13's CPU build). That fault
    was seen on the host only; on the card ``F.conv2d`` may serve again if
    a profile favours it."""
    xs = x[:, :, ::stride, ::stride].permute(0, 2, 3, 1)
    return (xs @ p["w"][0, 0].to(x.dtype)).permute(0, 3, 1, 2)


def _bn(p, s, x: Tensor, *, training: bool, momentum: float = 0.1,
        eps: float = 1e-5) -> Tuple[Tensor, Dict]:
    """BatchNorm over the channel axis 1 of x -> (y, new statistics)."""
    x32 = x.float()
    if training:
        var, mean = torch.var_mean(x32, dim=(0, 2, 3), unbiased=False)
        n = x.numel() // x.shape[1]
        with torch.no_grad():
            unbiased = var.detach() * n / max(n - 1, 1)
            new_s = {"mean": (1 - momentum) * s["mean"]
                     + momentum * mean.detach(),
                     "var": (1 - momentum) * s["var"] + momentum * unbiased}
    else:
        mean, var = s["mean"], s["var"]
        new_s = s
    inv = torch.rsqrt(var + eps) * p["scale"].float()
    y = ((x32 - mean[:, None, None]) * inv[:, None, None]
         + p["bias"].float()[:, None, None])
    return y.to(x.dtype), new_s


def _basic_block(p, s, x: Tensor, stride: int, *, training: bool):
    new_s = {}
    h = _conv(p["conv1"], x, stride, 1)
    h, new_s["bn1"] = _bn(p["bn1"], s["bn1"], h, training=training)
    h = torch.relu(h)
    h = _conv(p["conv2"], h, 1, 1)
    h, new_s["bn2"] = _bn(p["bn2"], s["bn2"], h, training=training)
    identity = x
    if "downsample" in p:
        identity = _downsample(p["downsample"]["conv"], x, stride)
        identity, ds = _bn(p["downsample"]["bn"], s["downsample"]["bn"],
                           identity, training=training)
        new_s["downsample"] = {"bn": ds}
    return torch.relu(h + identity), new_s


def resnet_apply(params, state, images: Tensor, cfg: ResNetConfig, *,
                 training: bool = False) -> Tuple[Tensor, Dict]:
    """Trunk: (B, H, W, C_in) NHWC -> ((B, H/32, W/32, C_last) NHWC
    features in the images' dtype, new statistics: ``state`` itself in
    eval mode)."""
    x = images.permute(0, 3, 1, 2).contiguous(
        memory_format=torch.channels_last)
    x = _conv(params["conv1"], x, 2, 3)
    x, bn1_s = _bn(params["bn1"], state["bn1"], x, training=training)
    x = F.max_pool2d(torch.relu(x), 3, 2, 1)
    new_state = {"bn1": bn1_s, "layers": []}
    for i, blocks in enumerate(params["layers"]):
        stage_s = []
        for b, bp in enumerate(blocks):
            stride = 2 if (b == 0 and i > 0) else 1
            x, bs = _basic_block(bp, state["layers"][i][b], x, stride,
                                 training=training)
            stage_s.append(bs)
        new_state["layers"].append(stage_s)
    return x.permute(0, 2, 3, 1), new_state


def height_pool_project(proj_params, features: Tensor) -> Tensor:
    """(B, H', W', C) -> (B, W', d_model): the float32 mean over the
    height, cast to the features' dtype, then the projection."""
    pooled = features.float().mean(dim=1)
    return layers.linear(proj_params, pooled.to(features.dtype))


def trans_dropout_masks(cfg: ModelConfig, batch: int, length: int,
                        generator, device
                        ) -> Optional[List[Tuple[Tensor, Tensor]]]:
    """The keep masks of the transformer encoder's two dropouts in each
    layer, (batch, length, d_model) booleans drawn from ``generator`` as
    ``layers.dropout`` draws them; None at rate 0."""
    if cfg.dropout == 0.0:
        return None
    shape = (batch, length, cfg.d_model)
    keep = 1.0 - cfg.dropout

    def draw():
        return torch.rand(shape, generator=generator, device=device) < keep

    return [(draw(), draw()) for _ in range(cfg.num_encoder_layers)]


def _drop(x: Tensor, mask: Optional[Tensor], rate: float) -> Tensor:
    if mask is None:
        return x
    keep = 1.0 - rate
    return torch.where(mask, x / keep,
                       torch.zeros((), dtype=x.dtype, device=x.device))


def trans_encoder_apply(params, x: Tensor, cfg: ModelConfig, *,
                        masks=None) -> Tensor:
    """Post-norm transformer encoder (torch ``TransformerEncoderLayer``
    order: self-attention, add and norm, ReLU MLP, add and norm) over
    (B, L, D) after the learned positional table; ``masks`` from
    ``trans_dropout_masks`` (None: the deterministic forward)."""
    L = x.shape[1]
    x = x + params["pos"]["table"][:L].to(x.dtype)
    for i, p in enumerate(params["layers"]):
        m1, m2 = masks[i] if masks is not None else (None, None)
        sa = layers.mha(p["self_attn"], x, x, cfg.nhead)
        x = layers.layer_norm(p["norm1"], x + _drop(sa, m1, cfg.dropout))
        ff = layers.mlp(p["ffn"], x, activation=torch.relu)
        x = layers.layer_norm(p["norm2"], x + _drop(ff, m2, cfg.dropout))
    return x
