"""A whole Swin block in one launch: CUDA kernel + plain.

Port of ``handwritten_math_ocr_api_tpu/ops/swin_block.py``. The kernel
(``csrc/swin_block.cu``) replaces the Pallas TPU kernel
``fused_swin_block``: LN1 -> qkv -> windowed multi-head attention
(relative-position bias, shift mask filled with -100) -> proj -> residual
-> LN2 -> tanh-GELU MLP -> residual, one block per (image, window).

It computes ``models/swin.py::swin_block``'s function, which is what the
TPU kernel's docstring promises: the map is zero-padded to window
multiples *after* LN1, so padded tokens are zeros at the qkv input. The
TPU kernel pads before LN1, and its padded keys then carry
``LN1(0) W_qkv + b``; the two agree only when LN1's bias is zero (a test
pins the difference). Rounding points are the TPU kernel's: the LN
outputs, qkv, the attention output, proj, the residual sums, the GELU
output and fc2 are rounded to the activation dtype; products accumulate
in float32, and the four biases (``attn.b_qkv``, ``attn.b_out``,
``mlp.fc1.b``, ``mlp.fc2.b``) are float32 and added in float32, as the TPU
kernel adds them. ``convert.to_torch`` gives those biases the compute
dtype, as the jnp ``swin_block`` uses them; ``with_float32_biases`` makes
the kernel's bundle from the float32 parameter tree.

``fits_vmem`` is the JAX route rule, kept so that the same stages take
the kernel as in the reference (stages 1-3 of Swin-T). The CUDA wrapper
has its own limit: a block's shared memory (``SMEM_LIMIT``), which the
activations of one window must fit; it raises beyond it.
"""

from __future__ import annotations

import numpy as np
import torch

from ..models import layers
from . import _build

_ENTRY = {torch.bfloat16: "swin_block_bf16", torch.float32: "swin_block_f32"}
VMEM_BUDGET_BYTES = 12 * 1024 * 1024
_SUBLANE = 16
SMEM_LIMIT = 232448  # bytes of shared memory a block may use on sm_90


BIAS_PATHS = (("attn", "b_qkv"), ("attn", "b_out"), ("mlp", "fc1", "b"),
              ("mlp", "fc2", "b"))


def with_float32_biases(encoder_np, encoder):
    """The block kernel's bundle: a copy of the encoder tree ``encoder``
    (tensors) whose blocks take their four biases (``BIAS_PATHS``) in
    float32 from ``encoder_np``, the same tree with float32 leaves (numpy
    arrays or tensors). Every other leaf is shared. A block that does not
    take the kernel casts its biases to the compute dtype at use, so it
    computes what it did with ``encoder``'s biases."""
    out = dict(encoder)
    out["stages"] = []
    for stage_np, stage in zip(encoder_np["stages"], encoder["stages"]):
        blocks = []
        for blk_np, blk in zip(stage_np["blocks"], stage["blocks"]):
            blk = {**blk, "attn": dict(blk["attn"]),
                   "mlp": {k: dict(v) for k, v in blk["mlp"].items()}}
            for path in BIAS_PATHS:
                node, node_np = blk, blk_np
                for key in path[:-1]:
                    node, node_np = node[key], node_np[key]
                leaf = node_np[path[-1]]
                t = (leaf if isinstance(leaf, torch.Tensor)
                     else torch.from_numpy(np.array(leaf)))
                node[path[-1]] = t.to(device=node[path[-1]].device,
                                      dtype=torch.float32).contiguous()
            blocks.append(blk)
        out["stages"].append({**stage, "blocks": blocks})
    return out


def fits_vmem(C: int, ws: int, W_pad: int, hid: int) -> bool:
    """The JAX route rule (a TPU VMEM estimate for 2-byte weights, which
    the reference applies in every dtype) for a stage of width C, padded
    map width W_pad and MLP width hid: True where the reference routes the
    stage through its whole-block kernel."""
    n_pad = -(-(ws * ws) // _SUBLANE) * _SUBLANE
    weights = (C * 3 * C + C * C + 2 * C * hid) * 2
    tokens = (W_pad // ws) * n_pad
    acts = tokens * (3 * C * 4 + hid * 4 + 4 * C * 2)
    return weights + acts < VMEM_BUDGET_BYTES


def smem_plan(C: int, num_heads: int, hid: int, ws: int):
    """(G heads per qkv group, hc hidden columns per MLP chunk, shared
    memory bytes) of the kernel for one window. Everything is float32 in
    shared memory: two (N, C) buffers, and a scratch that holds either the
    qkv of G heads with the (N, N) logits or an (N, hc) MLP chunk."""
    N = ws * ws
    dh = C // num_heads
    fixed = (2 * N + 3) // 4 * 4 + 2 * N * C
    budget = SMEM_LIMIT // 4 - fixed

    def qkv(g):
        return N * (3 * g * dh + 1) + N * N

    G = next((g for g in range(num_heads, 0, -1)
              if num_heads % g == 0 and qkv(g) <= budget), None)
    hc = next((h for h in range(hid, 0, -8)
               if hid % h == 0 and N * h <= budget), None)
    if G is None or hc is None:
        raise ValueError(
            f"Swin block kernel: one {ws}x{ws} window at C = {C} needs more "
            f"than the {SMEM_LIMIT} bytes of shared memory a block may use")
    return G, hc, 4 * (fixed + max(qkv(G), N * hc))


def _round(x, dtype):
    return x.to(dtype).float()


def fused_swin_block_plain(p, x, ws: int, shift: int, num_heads: int):
    """x (B, H, W, C) -> (B, H, W, C): swin_block's function with the
    kernel's rounding points, in float32 arithmetic."""
    from ..models import swin

    B, H, W, C = x.shape
    dt = x.dtype
    attn_p, mlp_p = p["attn"], p["mlp"]

    def linear(a, w, b):
        return a @ w.float() + b.float()

    xn = layers.layer_norm(p["norm1"], x.float()).to(dt)
    pad_b, pad_r = (ws - H % ws) % ws, (ws - W % ws) % ws
    Hp, Wp = H + pad_b, W + pad_r
    shift_h = 0 if ws >= Hp else shift
    shift_w = 0 if ws >= Wp else shift
    xn = torch.nn.functional.pad(xn, (0, 0, 0, pad_r, 0, pad_b))
    if shift_h or shift_w:
        xn = torch.roll(xn, shifts=(-shift_h, -shift_w), dims=(1, 2))
    windows = swin.window_partition(xn, ws).float()      # (B*nW, N, C)
    nW = (Hp // ws) * (Wp // ws)
    N, dh = ws * ws, C // num_heads
    qkv = _round(linear(windows, attn_p["w_qkv"], attn_p["b_qkv"]), dt)
    q, k, v = (layers.split_heads(t, num_heads).reshape(
        B, nW, num_heads, N, dh) for t in qkv.split(C, dim=-1))
    mask = swin.attention_mask(attn_p, ws, num_heads, Hp, Wp, shift_h,
                               shift_w)
    probs = torch.softmax((q * dh ** -0.5) @ k.transpose(-1, -2) + mask,
                          dim=-1)
    attn = _round(probs @ v, dt).reshape(B * nW, num_heads, N, dh)
    proj = _round(linear(layers.merge_heads(attn), attn_p["w_out"],
                         attn_p["b_out"]), dt)
    proj = swin.window_unpartition(proj, ws, B, Hp, Wp)
    if shift_h or shift_w:
        proj = torch.roll(proj, shifts=(shift_h, shift_w), dims=(1, 2))
    x1 = _round(x.float() + proj[:, :H, :W], dt)
    xn2 = _round(layers.layer_norm(p["norm2"], x1), dt)
    h = _round(layers.gelu_tanh(linear(xn2, mlp_p["fc1"]["w"],
                                       mlp_p["fc1"]["b"])), dt)
    h2 = _round(linear(h, mlp_p["fc2"]["w"], mlp_p["fc2"]["b"]), dt)
    return (x1 + h2).to(dt)


def fused_swin_block(p, x, ws: int, shift: int, num_heads: int):
    """Same contract as ``fused_swin_block_plain``; a CUDA tensor goes to
    the kernel (one launch, counted), a CPU tensor to the plain version."""
    if not x.is_cuda:
        return fused_swin_block_plain(p, x, ws, shift, num_heads)
    B, H, W, C = x.shape
    dt, dev = x.dtype, x.device
    if dt not in _ENTRY:
        raise ValueError(f"Swin block kernel takes bf16 or float32, "
                         f"not {dt}")
    attn_p, mlp_p = p["attn"], p["mlp"]
    hid = mlp_p["fc1"]["w"].shape[1]
    if C % num_heads or (C // num_heads) % 8 or hid % 8:
        raise ValueError(f"Swin block kernel needs a head dim and an MLP "
                         f"width that are multiples of 8 (C {C}, "
                         f"{num_heads} heads, hidden {hid})")
    G, hc, smem = smem_plan(C, num_heads, hid, ws)
    Hp, Wp = -(-H // ws) * ws, -(-W // ws) * ws
    shift_h = 0 if ws >= Hp else shift
    shift_w = 0 if ws >= Wp else shift
    f32 = torch.float32
    operands = [
        ("x", x, dt, (B, H, W, C)),
        ("norm1 scale", p["norm1"]["scale"], f32, (C,)),
        ("norm1 bias", p["norm1"]["bias"], f32, (C,)),
        ("w_qkv", attn_p["w_qkv"], dt, (C, 3 * C)),
        ("b_qkv", attn_p["b_qkv"], f32, (3 * C,)),
        ("rel_bias_table", attn_p["rel_bias_table"], f32,
         ((2 * ws - 1) ** 2, num_heads)),
        ("w_out", attn_p["w_out"], dt, (C, C)),
        ("b_out", attn_p["b_out"], f32, (C,)),
        ("norm2 scale", p["norm2"]["scale"], f32, (C,)),
        ("norm2 bias", p["norm2"]["bias"], f32, (C,)),
        ("fc1 w", mlp_p["fc1"]["w"], dt, (C, hid)),
        ("fc1 b", mlp_p["fc1"]["b"], f32, (hid,)),
        ("fc2 w", mlp_p["fc2"]["w"], dt, (hid, C)),
        ("fc2 b", mlp_p["fc2"]["b"], f32, (C,)),
    ]
    for name, t, dtype, shape in operands:
        _build.require(t, name, dtype=dtype, shape=shape, device=dev,
                       aligned=True)
    out = torch.empty_like(x)
    lib = _build.library()
    code = getattr(lib, _ENTRY[dt])(
        *[t.data_ptr() for _, t, _, _ in operands], out.data_ptr(),
        B, H, W, C, num_heads, hid, ws, shift_h, shift_w, G, hc, smem,
        _build.stream_handle(dev))
    _build.check(code, _ENTRY[dt])
    fused_swin_block.launches += 1
    return out


fused_swin_block.launches = 0
