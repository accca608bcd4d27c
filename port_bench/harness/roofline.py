"""Peaks, bound times, kernel operation and byte counts, model FLOPs.

``bound_ms``, ``stage_shapes``, ``step_weight_bytes``, ``step_bound`` and the
Swin block's count are frozen copies of ``chip_smoke.py`` at commit
e13765f3a37352e31b622845f2ae26a6960b06e8 (``check_swin_block``'s per-stage
bytes and operations), on the configuration's dict. A roofline share is the
bound time of the launches' work (bytes and operations summed over the
launches, then the larger of bytes / bandwidth and operations / rate) over
their device time. The peaks are an H100 SXM's published dense rates at
its full power limit of 700 W; the card's own limit is printed beside
every share."""

from __future__ import annotations

from typing import List, Tuple

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory (data sheet)
BF16_FLOPS_PER_S = 989e12      # H100 SXM dense bf16 tensor rate
F32_FLOPS_PER_S = 67e12        # H100 SXM float32 outside the tensor cores


def ops_s(flops: float, f32_flops: float = 0.0) -> float:
    return flops / BF16_FLOPS_PER_S + f32_flops / F32_FLOPS_PER_S


def bound_ms(nbytes: float, flops: float, f32_flops: float = 0.0) -> float:
    return max(nbytes / HBM_BYTES_PER_S, ops_s(flops, f32_flops)) * 1e3


def kv_dim(model: dict) -> int:
    return model["d_model"] // model["nhead"] * (model.get("nhead_kv")
                                                 or model["nhead"])


def encoder_len(model: dict) -> int:
    if model["encoder"] == "swin_t":
        return (model["img_h"] // 32) * (model["img_w"] // 32)
    return model["img_w"] // 32


def stage_shapes(model: dict) -> List[tuple]:
    """Per Swin stage: (H, W, C, heads, depth, padded H, padded W)."""
    sc = model["swin"]
    ws = sc["window_size"]
    h, w = model["img_h"] // sc["patch_size"], model["img_w"] // sc["patch_size"]
    out = []
    for i, depth in enumerate(sc["depths"]):
        c = sc["embed_dim"] * 2 ** i
        out.append((h, w, c, sc["num_heads"][i], depth,
                    -(-h // ws) * ws, -(-w // ws) * ws))
        h, w = h // 2, w // 2
    return out


def swin_block_work(model: dict, batch: int, stage: int) -> Tuple[float, float]:
    """(bytes, flops) of one whole-block launch at ``stage`` on ``batch``
    images (chip_smoke.py's count)."""
    h, w, c, nh, _, _, _ = stage_shapes(model)[stage]
    ws = model["swin"]["window_size"]
    hid = int(c * model["swin"]["mlp_ratio"])
    N = ws * ws
    real = batch * h * w
    weights = c * 3 * c + c * c + 2 * c * hid
    nbytes = (2 * real * c * 2 + weights * 2 + (5 * c + hid) * 4
              + 4 * c * 4 + (2 * ws - 1) ** 2 * nh * 4)
    flops = (2 * real * c * 3 * c + 4 * real * N * c
             + 2 * real * (c * c + 2 * c * hid))
    return nbytes, flops


def step_weight_bytes(model: dict, quantize: bool = False):
    L, D, F = (model["num_decoder_layers"], model["d_model"],
               model["dim_feedforward"])
    qkv = D + 2 * kv_dim(model)
    weights = L * (D * qkv + 3 * D * D + 2 * D * F)
    cols = L * (qkv + 3 * D + F + D)
    small = (cols + 6 * L * D) * 4
    if quantize:
        return weights + cols * 4 + small, weights
    return weights * 2 + small, weights


def step_bound(model: dict, rows: int, pos: int, quantize: bool = False):
    """(bytes, flops) of one greedy decoder-step launch (B1) for ``rows``
    rows at slot ``pos``."""
    L, D = model["num_decoder_layers"], model["d_model"]
    L_enc, kvd = encoder_len(model), kv_dim(model)
    nbytes, weights = step_weight_bytes(model, quantize)
    nbytes += (2 * L * rows * L_enc * D * 2
               + 2 * L * rows * pos * kvd * 2 + rows * D * 2
               + rows * D * 4 + 2 * L * rows * kvd * 2)
    flops = 2 * rows * weights + 4 * L * rows * D * (pos + 1 + L_enc)
    return nbytes, flops


def decode_work(model: dict, batches) -> Tuple[float, float, int]:
    """(bytes, flops, launches) of B1 over decodes of (rows, steps)."""
    nb = fl = 0.0
    n = 0
    for rows, steps in batches:
        for pos in range(steps):
            b, f = step_bound(model, rows, pos)
            nb += b
            fl += f
        n += steps
    return nb, fl, n


def fused_stages(model: dict, n: int = 3) -> List[int]:
    """The stages whose blocks run as the whole-block kernel: stages 1-3 of
    Swin-T at 96 x 320 (the route rule of ``ops/swin_block.fits_vmem``;
    the launch counters check it every traced run)."""
    return list(range(min(n, len(model["swin"]["depths"]))))


def encode_work(model: dict, buckets) -> Tuple[float, float, int]:
    """(bytes, flops, launches) of B4 over encodes at each bucket."""
    nb = fl = 0.0
    n = 0
    shapes = stage_shapes(model)
    for rows in buckets:
        for s in fused_stages(model):
            depth = shapes[s][4]
            b, f = swin_block_work(model, rows, s)
            nb += depth * b
            fl += depth * f
            n += depth
    return nb, fl, n


# -- useful model FLOPs (mfu) -------------------------------------------------

def encoder_flops(model: dict) -> float:
    """Multiply-add FLOPs of one image's encode (matrix products and
    convolutions; norms and softmax left out)."""
    d = model["d_model"]
    if model["encoder"] == "swin_t":
        sc = model["swin"]
        ws = sc["window_size"]
        shapes = stage_shapes(model)
        h0, w0, c0 = shapes[0][0], shapes[0][1], shapes[0][2]
        fl = 2 * h0 * w0 * sc["patch_size"] ** 2 * sc["in_channels"] * c0
        for i, (h, w, c, _, depth, _, _) in enumerate(shapes):
            hid = int(c * sc["mlp_ratio"])
            real = h * w
            fl += depth * (2 * real * c * 3 * c + 4 * real * ws * ws * c
                           + 2 * real * (c * c + 2 * c * hid))
            if i < len(shapes) - 1:
                fl += 2 * ((h + 1) // 2) * ((w + 1) // 2) * 4 * c * 2 * c
        feats = shapes[-1][2]
        return fl + 2 * encoder_len(model) * feats * d
    rc = model["resnet"]
    h, w = model["img_h"] // 2, model["img_w"] // 2
    fl = 2 * h * w * 49 * rc["in_channels"] * rc["stage_channels"][0]
    h, w = h // 2, w // 2
    cin = rc["stage_channels"][0]
    for i, (cout, nb) in enumerate(zip(rc["stage_channels"],
                                       rc["stage_blocks"])):
        for b in range(nb):
            stride = 2 if (b == 0 and i > 0) else 1
            h, w = -(-h // stride), -(-w // stride)
            fl += 2 * h * w * 9 * cin * cout + 2 * h * w * 9 * cout * cout
            if stride != 1 or cin != cout:
                fl += 2 * h * w * cin * cout
            cin = cout
    return fl + 2 * encoder_len(model) * cin * d


def decoder_flops(model: dict, tokens: int) -> float:
    """FLOPs of one image's decode through ``tokens`` positions (its own
    tokens through EOS): the cross K/V once, then each position's layers,
    attention over its own prefix and the memory, and the head."""
    L, D, F = (model["num_decoder_layers"], model["d_model"],
               model["dim_feedforward"])
    kvd, L_enc, V = kv_dim(model), encoder_len(model), model["vocab_size"]
    fl = L * 2 * L_enc * D * 2 * D
    per_pos = L * (2 * D * (D + 2 * kvd) + 2 * D * D + 2 * D * D
                   + 2 * D * D + 4 * D * F) + 2 * D * V
    fl += tokens * per_pos
    fl += L * 4 * D * (tokens * (tokens + 1) / 2 + tokens * L_enc)
    return fl


def image_flops(model: dict, tokens: int) -> float:
    return encoder_flops(model) + decoder_flops(model, tokens)
