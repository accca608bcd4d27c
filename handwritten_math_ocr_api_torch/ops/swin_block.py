"""A whole Swin block in one launch: CUDA kernel + plain.

Port of ``handwritten_math_ocr_api_tpu/ops/swin_block.py``. The kernel
(``csrc/swin_block.cu``) replaces the Pallas TPU kernel
``fused_swin_block``: LN1 -> qkv -> windowed multi-head attention
(relative-position bias, shift mask filled with -100) -> proj -> residual
-> LN2 -> tanh-GELU MLP -> residual, in one launch.

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

The block is bound by the tensor cores' rate (about 24 C^2 flops a token
against 4 C bytes). The bf16 entry runs every product and the attention
on them (``mma.sync``), a window on a thread-block cluster of 1, 2 or 4
blocks that split its heads and output columns and exchange rows through
distributed shared memory; ``launch_plan`` picks the cluster so that the
grid covers half the card's SMs, and ``smem_plan`` the warps a block (8
or 16) and the tiles that fit a block's shared memory (``SMEM_LIMIT``);
``block_geometry`` reports a launch's shape. The float32 entry keeps the
CUDA-core kernel (no TF32; ``f32_plan``).

``fits_vmem`` is the JAX route rule, kept so that the same stages take
the kernel as in the reference (stages 1-3 of Swin-T). The wrapper raises
where a window does not fit the kernel.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from ..models import layers
from . import _build

_ENTRY = {torch.bfloat16: "swin_block_bf16", torch.float32: "swin_block_f32"}
VMEM_BUDGET_BYTES = 12 * 1024 * 1024
_SUBLANE = 16
SMEM_LIMIT = 232448  # bytes of shared memory a block may use on sm_90
# the most a block may use for two to fit an SM (228 KB, less 1 KB each)
SMEM_TWO_BLOCKS = 233472 // 2 - 1024


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


ROWS = 64           # a window's tokens, padded to m16 tiles
KT, STAGES = 32, 3  # csrc/mma_pass.cuh: rows a staged weight tile, ring tiles
HEAD_DIMS = (16, 32, 64)  # head dims of the bf16 kernel
CLUSTERS = (1, 2, 4, 8)


class Plan(NamedTuple):
    """The bf16 kernel's plan for one window."""

    cluster: int         # blocks of the window's thread-block cluster
    n_tiles: int         # n8 tiles a warp: a product's widest pass / 32
    warp_rows: int       # the block's warps: 4 columns by 2 or 4 rows
    heads_per_pass: int  # heads whose q, k, v one product computes
    hidden_chunk: int    # MLP hidden columns a chunk, over the cluster
    smem: int            # shared memory bytes a block


def cluster_sizes(C: int, num_heads: int):
    """Cluster sizes the bf16 kernel takes at width C: each block owns
    whole heads and a multiple of 32 of at most 256 output columns."""
    return tuple(cs for cs in CLUSTERS
                 if num_heads % cs == 0 and (C // cs) % 32 == 0
                 and C // cs <= 256)


def _smem_bytes(C, dh, hg, hcc, cluster, ws):
    """csrc/swin_block.cu's ``Layout``: LN1/x1 and attention/LN2 (64, C + 8)
    bf16 buffers, the larger of the block's heads' qkv and two hidden
    chunks, the weight ring (rows of the widest pass), the token tables and
    the heads' bias table columns."""
    hpb = C // dh // cluster
    c_buf = 2 * ROWS * (C + 8)
    qkv = 2 * ROWS * (3 * hpb * dh + 8)
    hidden = 2 * 2 * ROWS * (hcc + 8)
    widest = max(3 * hg * dh, C // cluster, hcc // cluster)
    ring = 2 * STAGES * KT * (widest + 8)
    return (2 * c_buf + max(qkv, hidden) + ring + 3 * 4 * ROWS
            + 4 * (2 * ws - 1) ** 2 * hpb)


def smem_plan(C: int, num_heads: int, hid: int, ws: int,
              cluster: int) -> Plan:
    """The bf16 kernel's plan for a window of ws x ws tokens at width C over
    a cluster of ``cluster`` blocks: the narrower warp tiles (4 n8 tiles)
    where every pass fits them, the most heads a qkv product that fit it,
    and the widest hidden chunk (at most 128 columns a block, whose fc1
    sums then take 4 n8 tiles a warp beside fc2's) that leaves room for two
    blocks of 8 warps an SM (``SMEM_TWO_BLOCKS``, with the narrower tiles'
    128 registers a thread), else the widest that fits a block's shared
    memory with 16 warps (more warps to hide a block's serial phases where
    no second block shares the SM; ``kernel_ab.py encoder`` times both).
    Raises ValueError where the kernel does not take the shape or no plan
    fits."""
    dh = C // num_heads if C % num_heads == 0 else 0
    if (dh not in HEAD_DIMS or ws * ws > ROWS
            or cluster not in cluster_sizes(C, num_heads)):
        raise ValueError(
            f"bf16 Swin block kernel: C = {C} with {num_heads} heads (head "
            f"dim one of {HEAD_DIMS}), a {ws}x{ws} window (at most {ROWS} "
            f"tokens), over a cluster of {cluster} blocks (one of "
            f"{cluster_sizes(C, num_heads)}) is not a shape it takes")
    hpb, cb = num_heads // cluster, C // cluster
    for nt in (4, 8):
        width = 32 * nt
        hg = next((g for g in range(hpb, 0, -1)
                   if hpb % g == 0 and 3 * g * dh <= width), None)
        if cb > width or hg is None:
            continue
        chunks = [cluster * hcb for hcb in range(128, 0, -32)
                  if hid % (cluster * hcb) == 0]
        limits = ((SMEM_TWO_BLOCKS, 2), (SMEM_LIMIT, 4)) if nt == 4 else (
            (SMEM_LIMIT, 4),)
        for limit, warp_rows in limits:
            for hcc in chunks:
                smem = _smem_bytes(C, dh, hg, hcc, cluster, ws)
                if smem <= limit:
                    return Plan(cluster, nt, warp_rows, hg, hcc, smem)
    raise ValueError(
        f"Swin block kernel: one {ws}x{ws} window at C = {C} over a cluster "
        f"of {cluster} needs more than the {SMEM_LIMIT} bytes of shared "
        f"memory a block may use")


def launch_plan(B: int, H: int, W: int, C: int, num_heads: int, hid: int,
                ws: int, sms: int) -> Plan:
    """The plan of a bf16 launch on (B, H, W, C): the smallest cluster whose
    blocks (windows x cluster) cover half the card's ``sms`` SMs, else the
    largest that fits. A larger cluster splits a window's products into
    narrower passes whose cost a weight tile is mostly fixed (waiting for
    the tile, the block's barrier), so it pays only where the grid would
    leave most SMs idle (``kernel_ab.py encoder`` times every cluster size
    at each stage)."""
    windows = B * -(-H // ws) * -(-W // ws)
    plans, err = [], None
    for cs in cluster_sizes(C, num_heads) or (1,):
        try:
            plans.append(smem_plan(C, num_heads, hid, ws, cs))
        except ValueError as e:
            err = e
    if not plans:
        raise err
    return next((p for p in plans if 2 * windows * p.cluster >= sms),
                plans[-1])


def block_geometry(B: int, H: int, W: int, C: int, num_heads: int, hid: int,
                   ws: int, device) -> dict:
    """The shape of a bf16 launch on the card ``device``: the plan's fields,
    the windows, the blocks of the grid and the clusters of the plan that
    fit on the card at once."""
    plan = launch_plan(B, H, W, C, num_heads, hid, ws,
                       _build.sm_count(device))
    out = ctypes.c_int(0)
    code = _build.library().swin_block_active_clusters(
        C, num_heads, hid, ws, plan.cluster, plan.n_tiles, plan.warp_rows,
        plan.heads_per_pass, plan.hidden_chunk, plan.smem,
        ctypes.byref(out))
    _build.check(code, "swin_block_active_clusters")
    windows = B * -(-H // ws) * -(-W // ws)
    return {**plan._asdict(), "windows": windows,
            "blocks": windows * plan.cluster, "active_clusters": out.value}


def f32_plan(C: int, num_heads: int, hid: int, ws: int):
    """(G heads per qkv group, hc hidden columns per MLP chunk, shared
    memory bytes) of the float32 kernel for one window. Everything is
    float32 in shared memory: two (N, C) buffers, and a scratch that holds
    either the qkv of G heads with the (N, N) logits or an (N, hc) MLP
    chunk."""
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
    if dt == torch.bfloat16:
        plan = launch_plan(B, H, W, C, num_heads, hid, ws,
                           _build.sm_count(dev))
        tiles = tuple(plan)
    else:
        tiles = f32_plan(C, num_heads, hid, ws)
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
        B, H, W, C, num_heads, hid, ws, shift_h, shift_w, *tiles,
        _build.stream_handle(dev))
    if code == -1:
        raise RuntimeError(
            f"Swin block kernel: no cluster of {tiles[0]} blocks with "
            f"{tiles[-1]} bytes of shared memory fits on the card")
    _build.check(code, _ENTRY[dt])
    _build.count(fused_swin_block)
    return out


fused_swin_block.launches = 0
