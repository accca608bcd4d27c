"""Whole decode steps through every decoder layer: CUDA kernels + plain.

Port of ``handwritten_math_ocr_api_tpu/ops/fused_step.py`` for its four
steps and their weight bundles:

- the compute-only "v2" greedy step (``fused_decoder_layers_step_v2``,
  body ``_make_kernel_v2``, B1; bundle ``build_stacked``), kernel
  ``csrc/fused_step.cu``: one launch runs all L post-norm decoder layers of
  one step at one position for the batch (packed qkv projection,
  self-attention over the read-only cache plus the fresh row, output
  projection, residual and LayerNorm; cross-attention over the encoder
  K/V, residual and LayerNorm; ReLU FFN, residual and LayerNorm) and
  returns the last layer's activations and each layer's fresh K/V row.
  It runs the rows in groups, one thread-block cluster a group, each
  block a slice of every product's columns (``csrc/decoder_cluster.cuh``);
- the "v1" step (``fused_decoder_layers_step``, body ``_make_kernel``,
  B11), kernel ``csrc/fused_step.cu``: the same layers, the fresh rows
  written into the caches at ``pos`` in place (the TPU kernel's aliased
  caches);
- the whole step of "v3"/"v4" (``fused_whole_step``, body
  ``_make_kernel_v4``, B10; bundle ``build_stacked_full``), kernel
  ``csrc/whole_step.cu``: the embedding, the same layers, the float32 head
  and its argmax, over batch-major caches whose fresh rows the caller
  appends ("v3") or time-major ``(L, T, B, D)`` caches written at ``pos``
  in place ("v4");
- the ragged step (``fused_ragged_step``, body ``_make_kernel_ragged``,
  B7; bundle ``build_stacked_full``), kernel ``csrc/ragged_step.cuh``
  (entries in ``ragged_step.cu``, and the segment-ring mode's in
  ``ragged_ring.cu``): the embedding, the same layers and the float32
  output head in one launch, each row at its own position, returning the
  head's logits (beam search) or each row's argmax and its
  log-probability; in ring mode (continuous batching's segments) each row
  also attends the fresh rows of the segment's earlier steps from a small
  ring, and ``n_chunks`` computes only the first rows of the pool.

All four, and B12 (``ops/whole_decode.py``), run the cluster layer code of
``csrc/decoder_cluster.cuh`` (B7 and B10 with its embedding prologue and
float32 head epilogue there), whose header states the numerics below.

B1 and B7 take MHA and MQA (``nhead_kv=1``, the TPU kernels' ``kv_dim``:
one KV head that every query head reads; a kernel instantiation of its own
on the card); grouped attention with more KV heads (GQA) is refused by the
kernels (ValueError), as the JAX decode loops never send it to the TPU
kernels. B10, B11 and B12 are MHA only, as their TPU kernels are, and raise
``NotImplementedError`` on any other config.

B1 and B7 take the bf16/float32 bundles and the int8 one
(``quantize_stacked``, the JAX "v2q" bundle of ``DecodeEngine(use_fused=
True, quantize=True)``): the six layer weights int8 with float32 scales
``{k}_s`` (L, 1, N) per output column, everything else as before. A
bundle with ``w_qkv_s`` is the int8 one, as JAX detects it; the wrappers
then launch the kernels' int8 entries (counted in ``int8_launches``, the
float bundles in ``launches``; an MQA config's launches of B1 and B7 in
``mqa_launches`` and ``mqa_int8_launches``; B7's ring entries in the same
four with ``ring_`` before them). B10 and B11 take the float
bundles only: their TPU kernels cast activations to the weights' dtype,
int8 on an int8 bundle, so the port raises ``ValueError`` there.

Numerics of the TPU kernels: the activation row is carried in float32
across the sublayers; each matmul input is rounded to the weight dtype
(to bf16 for int8 weights, whatever the compute dtype) and accumulated in
float32, an int8 product times its column's scale; biases and LayerNorm
parameters are float32;
attention logits and softmax are float32; the fresh K/V row is rounded to
the cache dtype before it joins attention at slot ``pos``, and slots after
``pos`` are not attended (the TPU kernels' -inf mask). The whole and
ragged steps' embedding, positional and head tables are float32 too, and
their embedding sum is rounded to the compute dtype.

Caches are merged-head: self ``(L, B, T, kvd)`` (v4: ``(L, T, B, D)``),
kvd = ``cfg.kv_dim`` (D under MHA), cross ``(L, B, L_enc, D)``, heads
interleaved along the lanes in torch's order; the packed self-attention
weight ``w_qkv`` is ``(L, D, D + 2 kvd)``.
"""

from __future__ import annotations

import ctypes
import math
from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

from ..core.config import ModelConfig
from . import _build
from .quant import quantize_weight

# C entries by (int8 bundle, cache dtype)
_ENTRY = {(False, torch.bfloat16): "fused_decoder_step_bf16",
          (False, torch.float32): "fused_decoder_step_f32",
          (True, torch.bfloat16): "fused_decoder_step_i8_bf16",
          (True, torch.float32): "fused_decoder_step_i8_f32"}
_IN_PLACE_ENTRY = {torch.bfloat16: "layers_step_in_place_bf16",
                   torch.float32: "layers_step_in_place_f32"}
_WHOLE_ENTRY = {(True, torch.bfloat16): "whole_step_time_major_bf16",
                (True, torch.float32): "whole_step_time_major_f32",
                (False, torch.bfloat16): "whole_step_rows_bf16",
                (False, torch.float32): "whole_step_rows_f32"}
_RAGGED_ENTRY = {(False, torch.bfloat16): "ragged_step_bf16",
                 (False, torch.float32): "ragged_step_f32",
                 (True, torch.bfloat16): "ragged_step_i8_bf16",
                 (True, torch.float32): "ragged_step_i8_f32"}
_RING_ENTRY = {(False, torch.bfloat16): "ragged_ring_bf16",
               (False, torch.float32): "ragged_ring_f32",
               (True, torch.bfloat16): "ragged_ring_i8_bf16",
               (True, torch.float32): "ragged_ring_i8_f32"}
WEIGHT_KEYS = ("w_qkv", "w_out", "w_cq", "w_co", "w_ff1", "w_ff2")
BIAS_KEYS = ("b_qkv", "b_out", "b_cq", "b_co", "b_ff1", "b_ff2")


def _leaf(a, dtype, device) -> torch.Tensor:
    t = a if isinstance(a, torch.Tensor) else torch.from_numpy(np.array(a))
    return t.to(device=device, dtype=dtype)


def build_stacked(decoder_params, cfg: ModelConfig,
                  device=None) -> Dict[str, torch.Tensor]:
    """Per-layer decoder weights stacked to ``(L, ...)``, as the JAX
    ``build_stacked``: weights in the compute dtype, biases ``(L, 1, N)``
    and LayerNorm ``(L, 6, D)`` (scale, bias of norm1..norm3) in float32,
    ``w_cq``/``b_cq`` the query columns of the cross-attention projection.
    Leaves may be numpy arrays or tensors; numpy ones land on ``device``
    (the CPU if not given)."""
    layers = decoder_params["layers"]
    D = cfg.d_model
    wdt = getattr(torch, cfg.dtype)
    f32 = torch.float32

    def stack(path, dtype, cols=None):
        out = []
        for lp in layers:
            node = lp
            for key in path:
                node = node[key]
            t = _leaf(node, dtype, device)
            out.append(t[..., :cols] if cols else t)
        return torch.stack(out).contiguous()

    def bias(path, cols=None):
        return stack(path, f32, cols)[:, None, :].contiguous()

    ln = torch.stack([torch.stack([
        _leaf(lp[n][k], f32, device)
        for n in ("norm1", "norm2", "norm3") for k in ("scale", "bias")])
        for lp in layers]).contiguous()
    return {
        "w_qkv": stack(("self_attn", "w_qkv"), wdt),
        "b_qkv": bias(("self_attn", "b_qkv")),
        "w_out": stack(("self_attn", "w_out"), wdt),
        "b_out": bias(("self_attn", "b_out")),
        "w_cq": stack(("cross_attn", "w_qkv"), wdt, D),
        "b_cq": bias(("cross_attn", "b_qkv"), D),
        "w_co": stack(("cross_attn", "w_out"), wdt),
        "b_co": bias(("cross_attn", "b_out")),
        "w_ff1": stack(("ffn", "fc1", "w"), wdt),
        "b_ff1": bias(("ffn", "fc1", "b")),
        "w_ff2": stack(("ffn", "fc2", "w"), wdt),
        "b_ff2": bias(("ffn", "fc2", "b")),
        "ln": ln,
    }


def build_stacked_full(decoder_params, cfg: ModelConfig,
                       device=None) -> Dict[str, torch.Tensor]:
    """``build_stacked`` plus the tables the ragged step reads, all float32
    whatever the compute dtype, as the JAX ``build_stacked_full``: ``emb``
    (V, D), ``pos_emb`` (T, D), ``w_head`` (D, V) and ``b_head`` (1, V),
    the last two from ``fc_out``. The JAX bundle pads the vocabulary to
    the TPU's 128-lane tile (a -1e9 head bias on the padded columns) and
    the positions to its 8-row tile; the port keeps V and T, and nothing
    reads past them."""
    st = build_stacked(decoder_params, cfg, device)
    f32 = torch.float32
    st["emb"] = _leaf(decoder_params["embedding"]["table"], f32,
                      device).contiguous()
    st["pos_emb"] = _leaf(decoder_params["pos"]["table"], f32,
                          device).contiguous()
    st["w_head"] = _leaf(decoder_params["fc_out"]["w"], f32,
                         device).contiguous()
    st["b_head"] = _leaf(decoder_params["fc_out"]["b"], f32,
                         device)[None, :].contiguous()
    return st


def quantize_stacked(stacked) -> Dict[str, torch.Tensor]:
    """The int8 bundle of the JAX ``quantize_stacked``: each of the six
    stacked layer weights quantized per layer and output column
    (``ops/quant.py`` semantics, from the bundle's values: bf16-rounded in
    a bf16 config) into int8 ``{k}`` and float32 scales ``{k}_s``
    (L, 1, N); every other entry shared with ``stacked``."""
    out = dict(stacked)
    for k in WEIGHT_KEYS:
        w_q, scale = quantize_weight(stacked[k])
        out[k] = w_q.contiguous()
        out[f"{k}_s"] = scale[:, None, :].contiguous()
    return out


def _is_int8(stacked) -> bool:
    """The bundle is the int8 one; its weights and scales must agree."""
    quantized = "w_qkv_s" in stacked
    for k in WEIGHT_KEYS:
        if (stacked[k].dtype == torch.int8) != quantized or (
                f"{k}_s" in stacked) != quantized:
            raise ValueError(f"bundle mixes int8 and float weights or lacks "
                             f"scales at {k}")
    return quantized


def _require_float(stacked, what: str) -> None:
    """B10 and B11 take float bundles: their TPU kernels cast each matmul
    input to the weights' dtype, which for int8 weights would be int8."""
    if _is_int8(stacked):
        raise ValueError(f"{what} takes a bf16 or float32 bundle, not the "
                         f"int8 one (its TPU kernel would cast activations "
                         f"to int8)")


def _require_mha(cfg: ModelConfig, what: str) -> None:
    """B10, B11 and B12 take MHA configs only, as their TPU kernels."""
    if cfg.kv_heads != cfg.nhead:
        raise NotImplementedError(
            f"{what} supports MHA only (nhead_kv={cfg.kv_heads} of "
            f"{cfg.nhead} heads); MQA (nhead_kv=1) decodes with variant "
            f"'v2', GQA (1 < nhead_kv < nhead) on the default route")


def _check_layer_shapes(cfg: ModelConfig, what: str, dt, D: int,
                        L_enc: int) -> None:
    if dt not in (torch.bfloat16, torch.float32):
        raise ValueError(f"{what} kernel takes bf16 or float32, not {dt}")
    H, ff = cfg.nhead, cfg.dim_feedforward
    if D != cfg.d_model or D % H or (D // H) % 8 or ff % 8:
        raise ValueError(f"{what} kernel needs D = d_model, head dim and FFN "
                         f"width multiples of 8 (D {D}, {H} heads, FFN {ff})")
    if L_enc < 1:
        raise ValueError("no encoder slots to attend")


def _table_ptrs(stacked, D: int, dev):
    """Check build_stacked_full's float32 tables for a kernel; return
    (V, T_pos) and their pointers (emb, pos_emb, w_head, b_head)."""
    V = stacked["emb"].shape[0]
    Tpos = stacked["pos_emb"].shape[0]
    tables = {"emb": (V, D), "pos_emb": (Tpos, D), "w_head": (D, V),
              "b_head": (1, V)}
    for name, shape in tables.items():
        _build.require(stacked[name], name, dtype=torch.float32,
                       shape=shape, device=dev)
    return V, Tpos, [stacked[k].data_ptr() for k in tables]


def _weight_ptrs(stacked, cfg: ModelConfig, L: int, dt, dev):
    """Check the six stacked weights (in ``dt``, or int8 with their
    scales), their biases and the LayerNorm table for a kernel; return
    (int8 bundle, the entry's pointers: per weight (w, b), or (w, s, b)
    for int8, then ln)."""
    D, ff = cfg.d_model, cfg.dim_feedforward
    quantized = _is_int8(stacked)
    shapes = {"w_qkv": (L, D, D + 2 * cfg.kv_dim), "w_out": (L, D, D),
              "w_cq": (L, D, D), "w_co": (L, D, D), "w_ff1": (L, D, ff),
              "w_ff2": (L, ff, D)}
    f32 = torch.float32
    ptrs = []
    for (name, shape), bias in zip(shapes.items(), BIAS_KEYS):
        _build.require(stacked[name], name,
                       dtype=torch.int8 if quantized else dt, shape=shape,
                       device=dev, aligned=True)
        ptrs.append(stacked[name].data_ptr())
        if quantized:
            _build.require(stacked[f"{name}_s"], f"{name}_s", dtype=f32,
                           shape=(L, 1, shape[-1]), device=dev, aligned=True)
            ptrs.append(stacked[f"{name}_s"].data_ptr())
        _build.require(stacked[bias], bias, dtype=f32,
                       shape=(L, 1, shape[-1]), device=dev, aligned=True)
        ptrs.append(stacked[bias].data_ptr())
    _build.require(stacked["ln"], "ln", dtype=f32, shape=(L, 6, D),
                   device=dev, aligned=True)
    return quantized, ptrs + [stacked["ln"].data_ptr()]


def _heads_attention(q, k, v, nhead: int, keep=None):
    """q (B, D) float32 pre-scaled; k, v (B, S, kvd) float32 of Hkv =
    kvd / dh KV heads -> (B, D): query head h reads KV head
    h // (nhead / Hkv). ``keep`` (B, S) bool: the slots each row attends
    (all if None)."""
    B, D = q.shape
    S, kvd = k.shape[1:]
    dh = D // nhead
    hkv = kvd // dh
    qh = q.reshape(B, hkv, nhead // hkv, dh)
    kh = k.reshape(B, S, hkv, dh).transpose(1, 2)
    vh = v.reshape(B, S, hkv, dh).transpose(1, 2)
    logits = qh @ kh.transpose(-1, -2)                     # (B, Hkv, g, S)
    if keep is not None:
        logits = logits.masked_fill(~keep[:, None, None, :], float("-inf"))
    probs = torch.softmax(logits, dim=-1)
    return (probs @ vh).reshape(B, D)


def fused_decoder_layers_step_v2_plain(stacked, cfg: ModelConfig, x_emb,
                                       self_k, self_v, cross_k, cross_v,
                                       pos: int):
    """x_emb (B, D); self caches (L, B, T, kvd), read only; cross K/V
    (L, B, L_enc, D), every slot attended (unpadded). Returns
    (x_out (B, D) float32, k_new, v_new (L, B, kvd) in the cache dtype)."""
    B, T = self_k.shape[1:3]
    if not 0 <= pos < T:
        raise ValueError(f"pos {pos} outside the cache of {T} slots")
    rows = torch.full((B,), pos, dtype=torch.long, device=x_emb.device)
    return _layers_plain(stacked, cfg, x_emb.float(), self_k, self_v,
                         cross_k, cross_v, rows)


# What the C entries of the cluster kernels (B1, B11, B7, B10, B12) return
# for a model or batch they do not take (``csrc/decoder_cluster.cuh``:
# kRefused; its make_shape is the one statement of the shapes they take,
# and head_fits the head's of B7, B10 and B12).
REFUSED = -1
_GEOMETRY_KEYS = ("blocks", "clusters", "rows", "smem_bytes", "stages",
                  "active_clusters", "staged_self_slots",
                  "staged_cross_slots")


def _check_code(code: int, entry: str, cfg: ModelConfig, B: int) -> None:
    """Raise ``ValueError`` where the kernel refused the shape, else what
    ``_build.check`` raises on a failed launch."""
    if code == REFUSED:
        raise ValueError(
            f"the decoder step kernel ({entry}) does not take d_model "
            f"{cfg.d_model}, {cfg.nhead} heads ({cfg.kv_heads} KV heads), "
            f"FFN {cfg.dim_feedforward} at {B} rows "
            f"(csrc/decoder_cluster.cuh make_shape)")
    _build.check(code, entry)


# The cluster kernels, by their id in the C entry ``cluster_geometry``
# (``csrc/decoder_cluster.cuh``, ``cluster_step::Kernel``)
CLUSTER_KERNELS = {"fused_step": 0, "ragged_step": 1, "whole_step": 2,
                   "whole_decode": 3}


def cluster_geometry(kernel: str, cfg: ModelConfig, B: int, T: int,
                     L_enc: int, dtype, quantized: bool = False,
                     V: int = 0) -> Dict[str, int]:
    """The launch geometry of a cluster kernel on the card
    (``CLUSTER_KERNELS``: B1/B11, B7, B10 or B12) for B rows, planned for
    the last of T slots, with the float32 head of V columns (B7, B10, B12;
    resident in shared memory for B12): blocks a cluster, clusters, rows a
    group, shared memory bytes a block, stages of its copy ring, clusters
    the card holds at once, and the self-cache and cross K/V slots an item
    stages in shared memory. B10's two cache layouts take the same shape;
    it has no int8 entries (ValueError). The self caches hold
    ``cfg.kv_heads`` KV heads: B1 and B7 take MQA (ValueError for GQA),
    B10 and B12 MHA only (ValueError)."""
    out = (ctypes.c_int * 8)()
    code = _build.library().cluster_geometry(
        CLUSTER_KERNELS[kernel], int(quantized), int(dtype == torch.float32),
        B, T, cfg.d_model, cfg.nhead, cfg.kv_heads, cfg.dim_feedforward,
        L_enc, V, ctypes.addressof(out))
    _check_code(code, f"cluster_geometry {kernel}", cfg, B)
    return dict(zip(_GEOMETRY_KEYS, out))


def _check_step(cfg: ModelConfig, what: str, x_emb, self_k, self_v,
                cross_k, cross_v, pos: int):
    """Check the operands of B1 or B11; return (L, B, T, D, L_enc)."""
    L, B, T = self_k.shape[:3]
    L_enc = cross_k.shape[2]
    D, kvd = x_emb.shape[-1], cfg.kv_dim
    dt, dev = x_emb.dtype, x_emb.device
    _check_layer_shapes(cfg, what, dt, D, L_enc)
    if not 0 <= pos < T:
        raise ValueError(f"pos {pos} outside the cache of {T} slots")
    _build.require(x_emb, "x_emb", shape=(B, D), device=dev)
    for name, t in (("self_k", self_k), ("self_v", self_v)):
        _build.require(t, name, dtype=dt, shape=(L, B, T, kvd), device=dev,
                       aligned=True)
    for name, t in (("cross_k", cross_k), ("cross_v", cross_v)):
        _build.require(t, name, dtype=dt, shape=(L, B, L_enc, D),
                       device=dev, aligned=True)
    return L, B, T, D, L_enc


def fused_decoder_layers_step_v2(stacked, cfg: ModelConfig, x_emb, self_k,
                                 self_v, cross_k, cross_v, pos: int):
    """Same contract as ``fused_decoder_layers_step_v2_plain``; CUDA tensors
    go to the kernel (one launch for all layers, counted), CPU tensors to
    the plain version. ``pos`` is a Python int passed by value. MHA and MQA
    (its own kernel instantiation); GQA raises ValueError."""
    if not x_emb.is_cuda:
        return fused_decoder_layers_step_v2_plain(
            stacked, cfg, x_emb, self_k, self_v, cross_k, cross_v, pos)
    L, B, T, D, L_enc = _check_step(cfg, "decoder step", x_emb, self_k,
                                    self_v, cross_k, cross_v, pos)
    dt, dev = x_emb.dtype, x_emb.device
    quantized, weights = _weight_ptrs(stacked, cfg, L, dt, dev)

    x_out = torch.empty((B, D), dtype=torch.float32, device=dev)
    k_new = torch.empty((L, B, cfg.kv_dim), dtype=dt, device=dev)
    v_new = torch.empty((L, B, cfg.kv_dim), dtype=dt, device=dev)
    entry = _ENTRY[quantized, dt]
    ptrs = [x_emb.data_ptr(), *weights]
    ptrs += [t.data_ptr() for t in (self_k, self_v, cross_k, cross_v, x_out,
                                    k_new, v_new)]
    code = getattr(_build.library(), entry)(
        *ptrs, L, B, T, D, cfg.nhead, cfg.kv_heads, cfg.dim_feedforward,
        L_enc, int(pos), _build.stream_handle(dev))
    _check_code(code, entry, cfg, B)
    _count(fused_decoder_layers_step_v2, cfg, quantized)
    return x_out, k_new, v_new


def _count(wrapper, cfg: ModelConfig, quantized: bool,
           ring: bool = False) -> None:
    """One launch of B1 or B7: of the int8 or the float entry, of the MQA
    kernel (``mqa_`` counts) or the MHA one, of B7's ring entries
    (``ring_`` counts) or the others."""
    attr = (("ring_" if ring else "")
            + ("mqa_" if cfg.kv_heads != cfg.nhead else "")
            + ("int8_launches" if quantized else "launches"))
    _build.count(wrapper, attr)


fused_decoder_layers_step_v2.launches = 0
fused_decoder_layers_step_v2.int8_launches = 0
fused_decoder_layers_step_v2.mqa_launches = 0
fused_decoder_layers_step_v2.mqa_int8_launches = 0


def fused_decoder_layers_step_plain(stacked, cfg: ModelConfig, x_emb, self_k,
                                    self_v, cross_k, cross_v, pos: int):
    """The "v1" step: x_emb (B, D); self caches (L, B, T, D), their slot
    ``pos`` overwritten in place with each layer's fresh K/V row (rounded
    to the cache dtype); cross K/V (L, B, L_enc, D), every slot attended.
    Returns (x_out (B, D) float32, self_k, self_v), the caches the ones
    given (the JAX function returns its aliased, updated caches). A float
    bundle and an MHA config only."""
    _require_mha(cfg, "the v1 step")
    _require_float(stacked, "the v1 step")
    x, k_new, v_new = fused_decoder_layers_step_v2_plain(
        stacked, cfg, x_emb, self_k, self_v, cross_k, cross_v, pos)
    self_k[:, :, pos] = k_new
    self_v[:, :, pos] = v_new
    return x, self_k, self_v


def fused_decoder_layers_step(stacked, cfg: ModelConfig, x_emb, self_k,
                              self_v, cross_k, cross_v, pos: int):
    """Same contract as ``fused_decoder_layers_step_plain``; CUDA tensors
    go to the kernel (one launch for all layers, writing slot ``pos`` of
    the caches in place, counted), CPU tensors to the plain version."""
    if not x_emb.is_cuda:
        return fused_decoder_layers_step_plain(
            stacked, cfg, x_emb, self_k, self_v, cross_k, cross_v, pos)
    _require_mha(cfg, "the v1 step")
    _require_float(stacked, "the v1 step")
    L, B, T, D, L_enc = _check_step(cfg, "v1 step", x_emb, self_k, self_v,
                                    cross_k, cross_v, pos)
    dt, dev = x_emb.dtype, x_emb.device
    _, weights = _weight_ptrs(stacked, cfg, L, dt, dev)
    x_out = torch.empty((B, D), dtype=torch.float32, device=dev)
    entry = _IN_PLACE_ENTRY[dt]
    ptrs = [x_emb.data_ptr(), *weights]
    ptrs += [t.data_ptr() for t in (self_k, self_v, cross_k, cross_v, x_out)]
    code = getattr(_build.library(), entry)(
        *ptrs, L, B, T, D, cfg.nhead, cfg.dim_feedforward, L_enc, int(pos),
        _build.stream_handle(dev))
    _check_code(code, entry, cfg, B)
    _build.count(fused_decoder_layers_step)
    return x_out, self_k, self_v


fused_decoder_layers_step.launches = 0


def _layers_plain(stacked, cfg: ModelConfig, x, self_k, self_v, cross_k,
                  cross_v, pos, round_fresh: bool = True):
    """Every layer on float32 rows x (R, D), row r at slot pos[r] (R,):
    it attends its cache slots before pos[r] and its fresh row, rounded to
    the cache dtype first if ``round_fresh`` (else in float32, as the
    whole-decode kernel B12 does), each query head the KV head of its
    group (self caches (L, R, T, kvd)). Returns (x, k_new, v_new
    (L, R, kvd) in the cache dtype)."""
    L, R, T, kvd = self_k.shape
    D, H = x.shape[-1], cfg.nhead
    scale = 1.0 / math.sqrt(D // H)
    quantized = _is_int8(stacked)
    xdt = torch.bfloat16 if quantized else stacked["w_qkv"].dtype
    cdt = self_k.dtype
    ln = stacked["ln"]
    slot = torch.arange(T, device=x.device)[None, :]
    before = (slot < pos[:, None])[..., None]              # (R, T, 1)
    at = (slot == pos[:, None])[..., None]
    keep = (slot <= pos[:, None])

    def mm(x, name, bias):
        y = x.to(xdt).float() @ stacked[name][layer].float()
        if quantized:
            y = y * stacked[f"{name}_s"][layer, 0]
        return y + stacked[bias][layer, 0]

    def norm(x, i):
        return F.layer_norm(x, (D,), ln[layer, 2 * i], ln[layer, 2 * i + 1],
                            1e-5)

    def with_fresh(cache, fresh):
        # slots after pos[r] are never read: zero, so that nothing stale
        # (0 * NaN) reaches the weighted sum
        zero = torch.zeros((), dtype=torch.float32, device=x.device)
        return torch.where(at, fresh[:, None].float(),
                           torch.where(before, cache.float(), zero))

    k_out, v_out = [], []
    for layer in range(L):
        qkv = mm(x, "w_qkv", "b_qkv")
        q, k_new, v_new = qkv[:, :D], qkv[:, D:D + kvd], qkv[:, D + kvd:]
        k_out.append(k_new.to(cdt))
        v_out.append(v_new.to(cdt))
        if round_fresh:
            k_new, v_new = k_out[-1], v_out[-1]
        attn = _heads_attention(q * scale, with_fresh(self_k[layer], k_new),
                                with_fresh(self_v[layer], v_new), H, keep)
        x = norm(x + mm(attn, "w_out", "b_out"), 0)

        qc = mm(x, "w_cq", "b_cq")
        attn = _heads_attention(qc * scale, cross_k[layer].float(),
                                cross_v[layer].float(), H)
        x = norm(x + mm(attn, "w_co", "b_co"), 1)

        h = torch.relu(mm(x, "w_ff1", "b_ff1"))
        x = norm(x + mm(h, "w_ff2", "b_ff2"), 2)
    return x, torch.stack(k_out), torch.stack(v_out)


def _argmax_head(logits):
    """(R, V) float32 logits -> (nxt (R,) int32, the first index of the
    max; logp (R,) float32, log(p_max + 1e-10)), the TPU kernel's
    expressions."""
    mv = logits.max(dim=-1).values
    se = torch.exp(logits - mv[:, None]).sum(dim=-1)
    p_max = torch.exp(mv - (mv + torch.log(se)))
    return logits.argmax(dim=-1).to(torch.int32), torch.log(p_max + 1e-10)


def _ragged_run_rows(R: int, T: int, block_b: int, n_chunks, t_active,
                     seg_start, ring_k, ring_v) -> int:
    """Check the ragged step's options as the JAX wrapper checks them (the
    same ValueErrors) and return the rows a step computes: the first
    ``n_chunks * block_b``, or all R. The pool need be a multiple of
    ``block_b`` only with ``n_chunks`` (JAX requires it always: its pools
    are padded, the port's beam rows are not). Ring mode takes all three of
    ``seg_start``, ``ring_k`` and ``ring_v`` or none (JAX ignores
    ``seg_start`` and ``ring_v`` without ``ring_k``)."""
    if t_active is not None and not 0 < t_active <= T:
        raise ValueError(f"t_active {t_active} not in (0, {T}]")
    if block_b < 8 or block_b % 8:
        raise ValueError(f"block_b {block_b} must be a multiple of 8")
    run = R
    if n_chunks is not None:
        if R % block_b:
            raise ValueError(f"pool size {R} not a multiple of {block_b}")
        if not 1 <= n_chunks <= R // block_b:
            raise ValueError(f"n_chunks {n_chunks} not in "
                             f"[1, {R // block_b}]")
        run = n_chunks * block_b
    ring = (seg_start, ring_k, ring_v)
    if any(a is None for a in ring) and any(a is not None for a in ring):
        raise ValueError("ring mode needs seg_start, ring_k AND ring_v")
    return run


def _with_ring(cache, ring, seg, pos):
    """Row r's slots before pos[r] as ring mode attends them: cache slots
    before seg[r], then ring rows 0 .. pos[r] - seg[r] - 1 (cache
    (L, R, T, kvd), ring (L, R, S, kvd) -> (L, R, T, kvd); later slots are
    not read)."""
    L, R, T, kvd = cache.shape
    S = ring.shape[2]
    slot = torch.arange(T, device=cache.device)[None, :]
    j = (slot - seg[:, None]).clamp(0, S - 1)              # (R, T)
    from_ring = ring.gather(2, j[None, :, :, None].expand(L, R, T, kvd))
    return torch.where((slot < seg[:, None])[None, :, :, None], cache,
                       from_ring)


def fused_ragged_step_plain(stacked, cfg: ModelConfig, prev, pos, self_k,
                            self_v, cross_k, cross_v, *, block_b: int = 16,
                            n_chunks=None, return_logits: bool = False,
                            seg_start=None, ring_k=None, ring_v=None,
                            t_active=None):
    """One decode step for R rows at their own positions. prev, pos: (R,)
    int32 (the previous token and the slot of each row); self caches
    (L, R, T, kvd), read only; cross K/V (L, R, L_enc, D), every slot
    attended. ``stacked`` from ``build_stacked_full``.

    Ring mode (``seg_start`` (R,) int32 with ``ring_k``/``ring_v``
    (L, R, S, kvd), the JAX kernel's segment ring): row r attends its
    cache slots before seg_start[r], ring rows j = t - seg_start[r] for the
    slots t in [seg_start[r], pos[r]), and its fresh row at pos[r], under
    one softmax. ``n_chunks`` computes only the first ``n_chunks *
    block_b`` rows (R a multiple of ``block_b``); the other rows' outputs
    are unspecified (here NaN, nxt -1). ``t_active`` is checked as JAX
    checks it and has no other effect. A position outside the cache, or a
    segment start outside [pos - (S - 1), pos], raises ValueError.

    Returns (logits (R, V) float32, k_new, v_new) with ``return_logits``,
    else (nxt (R,) int32, logp (R,) float32, k_new, v_new); k_new and
    v_new are (L, R, kvd) in the cache dtype."""
    L, R, T = self_k.shape[:3]
    run = _ragged_run_rows(R, T, block_b, n_chunks, t_active, seg_start,
                           ring_k, ring_v)
    pos = pos[:run].long()
    if pos.numel() and (int(pos.min()) < 0 or int(pos.max()) >= T):
        raise ValueError(f"a position lies outside the cache of {T} slots")
    caches = [c[:, :run] for c in (self_k, self_v, cross_k, cross_v)]
    if ring_k is not None:
        seg = seg_start[:run].long()
        S = ring_k.shape[2]
        if seg.numel() and (bool((seg > pos).any())
                            or bool((pos - seg >= S).any())
                            or int(seg.min()) < 0):
            raise ValueError(f"a segment start lies outside [pos - {S - 1}, "
                             f"pos]")
        caches[0] = _with_ring(caches[0], ring_k[:, :run], seg, pos)
        caches[1] = _with_ring(caches[1], ring_v[:, :run], seg, pos)
    # rounded to cfg.dtype under int8 weights, as the JAX kernel, else to
    # the weights' dtype (the same in a build_stacked_full bundle)
    wdt = (getattr(torch, cfg.dtype) if _is_int8(stacked)
           else stacked["w_qkv"].dtype)
    x, k_new, v_new = _layers_plain(stacked, cfg,
                                    _embed_full(stacked, prev[:run], pos,
                                                wdt), *caches, pos)
    logits = x @ stacked["w_head"] + stacked["b_head"][0]
    outs = ((logits,) if return_logits else _argmax_head(logits)) + (
        k_new, v_new)
    if run == R:
        return outs
    # the rows past the run: NaN (nxt -1)
    full = []
    for t in outs:
        axis = 1 if t.dim() == 3 else 0
        shape = list(t.shape)
        shape[axis] = R
        pad = torch.full(shape, -1 if t.dtype == torch.int32 else
                         float("nan"), dtype=t.dtype, device=t.device)
        pad.narrow(axis, 0, run).copy_(t)
        full.append(pad)
    return tuple(full)


def fused_ragged_step(stacked, cfg: ModelConfig, prev, pos, self_k, self_v,
                      cross_k, cross_v, *, block_b: int = 16, n_chunks=None,
                      return_logits: bool = False, seg_start=None,
                      ring_k=None, ring_v=None, t_active=None):
    """Same contract as ``fused_ragged_step_plain``; CUDA tensors go to the
    kernel (one launch for the embedding, every layer and the head,
    counted), CPU tensors to the plain version.

    The kernel runs the rows in groups, one thread-block cluster a group
    (``csrc/decoder_cluster.cuh``, B1's layer code;
    ``cluster_geometry("ragged_step", ...)`` gives the shape), each row at
    its own position, over the first ``n_chunks * block_b`` rows (the
    groups planned for them; the caches' strides stay the pool's) and in
    ring mode through its ring entries (a kernel of its own). ``prev``,
    ``pos`` and ``seg_start`` stay in device memory: the wrapper reads no
    value of them, so a step makes no host round trip. A row whose ``prev``
    or ``pos`` is out of range, or whose ``seg_start`` lies outside
    [pos - (S - 1), pos], gets NaN outputs (nxt -1), reads nothing and
    leaves the other rows of its group as they are; the rows past the run
    are not written (``torch.empty``). A model the kernel does not split
    raises ``ValueError``. Of the TPU kernel's options, ``block_b`` keeps
    only its meaning for ``n_chunks`` (the kernel picks its own row
    groups), ``t_active`` is checked and has no effect (the kernel reads
    no slot at or past a row's position anyway), and the zeroing of V past
    the horizon becomes not reading those slots. MHA and MQA (its own
    kernel instantiation); GQA raises ValueError."""
    if not self_k.is_cuda:
        return fused_ragged_step_plain(
            stacked, cfg, prev, pos, self_k, self_v, cross_k, cross_v,
            block_b=block_b, n_chunks=n_chunks, return_logits=return_logits,
            seg_start=seg_start, ring_k=ring_k, ring_v=ring_v,
            t_active=t_active)
    L, R, T, kvd = self_k.shape
    run = _ragged_run_rows(R, T, block_b, n_chunks, t_active, seg_start,
                           ring_k, ring_v)
    L_enc, D = cross_k.shape[2:]
    dt = self_k.dtype
    dev = self_k.device
    _check_layer_shapes(cfg, "ragged step", dt, D, L_enc)
    for name, t in (("prev", prev), ("pos", pos)):
        _build.require(t, name, dtype=torch.int32, shape=(R,), device=dev)
    for name, t in (("self_k", self_k), ("self_v", self_v)):
        _build.require(t, name, dtype=dt, shape=(L, R, T, cfg.kv_dim),
                       device=dev, aligned=True)
    for name, t in (("cross_k", cross_k), ("cross_v", cross_v)):
        _build.require(t, name, dtype=dt, shape=(L, R, L_enc, D),
                       device=dev, aligned=True)
    ring = ring_k is not None
    if ring:
        S = ring_k.shape[2]
        _build.require(seg_start, "seg_start", dtype=torch.int32, shape=(R,),
                       device=dev)
        for name, t in (("ring_k", ring_k), ("ring_v", ring_v)):
            _build.require(t, name, dtype=dt, shape=(L, R, S, kvd),
                           device=dev, aligned=True)
    quantized, weights = _weight_ptrs(stacked, cfg, L, dt, dev)
    if quantized and dt != getattr(torch, cfg.dtype):
        raise ValueError(f"int8 ragged step: caches are {dt}, the compute "
                         f"dtype {cfg.dtype}")
    V, Tpos, (emb, pos_emb, w_head, b_head) = _table_ptrs(stacked, D, dev)
    f32 = torch.float32

    k_new = torch.empty((L, R, kvd), dtype=dt, device=dev)
    v_new = torch.empty((L, R, kvd), dtype=dt, device=dev)
    if return_logits:
        outs = (torch.empty((R, V), dtype=f32, device=dev),)
        heads = [outs[0].data_ptr(), None, None]
    else:
        outs = (torch.empty((R,), dtype=torch.int32, device=dev),
                torch.empty((R,), dtype=f32, device=dev))
        heads = [None, outs[0].data_ptr(), outs[1].data_ptr()]
    ptrs = [prev.data_ptr(), pos.data_ptr(), emb, pos_emb, *weights]
    ptrs += [t.data_ptr() for t in (self_k, self_v, cross_k, cross_v)]
    if ring:
        ptrs += [t.data_ptr() for t in (seg_start, ring_k, ring_v)]
    ptrs += [w_head, b_head, *heads, k_new.data_ptr(), v_new.data_ptr()]
    sizes = [L, R, run, T, D, cfg.nhead, cfg.kv_heads, cfg.dim_feedforward,
             L_enc, V, Tpos] + ([S] if ring else [])
    entry = (_RING_ENTRY if ring else _RAGGED_ENTRY)[quantized, dt]
    code = getattr(_build.library(), entry)(*ptrs, *sizes,
                                            _build.stream_handle(dev))
    _check_code(code, entry, cfg, run)
    _count(fused_ragged_step, cfg, quantized, ring)
    return (*outs, k_new, v_new)


for _attr in ("launches", "int8_launches", "mqa_launches",
              "mqa_int8_launches"):
    setattr(fused_ragged_step, _attr, 0)
    setattr(fused_ragged_step, "ring_" + _attr, 0)


def _embed_full(stacked, prev, pos, dtype):
    """float32 rows (R, D) of the embedding sum emb[prev] + pos_emb[pos]
    rounded to ``dtype``, as the whole and ragged steps begin. A position
    past the table takes its last row, as JAX's gather clamps the index
    (a model whose ``max_seq_len`` is under the decode's)."""
    last = stacked["pos_emb"].shape[0] - 1
    at = pos.clamp(max=last) if torch.is_tensor(pos) else min(pos, last)
    return (stacked["emb"][prev.long()] + stacked["pos_emb"][at]).to(
        dtype).float()


def fused_whole_step_plain(stacked, cfg: ModelConfig, prev, self_k, self_v,
                           cross_k, cross_v, pos: int, *,
                           time_major: bool = True):
    """One whole greedy step for the batch at position ``pos``: the
    embedding, every layer and the float32 head's argmax. prev (B,) int32;
    cross K/V (L, B, L_enc, D), every slot attended; ``stacked`` from
    ``build_stacked_full``, a float bundle.

    ``time_major`` ("v4"): self caches (L, T, B, D), slot ``pos``
    overwritten in place with the fresh rows; returns (nxt (B,) int32,
    logp (B,) float32, self_k, self_v). Else ("v3"): self caches
    (L, B, T, D), read only; returns (nxt, logp, k_new, v_new (L, B, D)),
    which the caller appends. logp is log(p_max + 1e-10), nxt the first
    index of the max. An MHA config only."""
    _require_mha(cfg, "the whole step")
    _require_float(stacked, "the whole step")
    # a batch-major view of time-major caches: (L, B, T, D)
    view_k, view_v = ((self_k.transpose(1, 2), self_v.transpose(1, 2))
                      if time_major else (self_k, self_v))
    L, B, T, D = view_k.shape
    if not 0 <= pos < T:
        raise ValueError(f"pos {pos} outside the cache of {T} slots")
    x = _embed_full(stacked, prev, pos, stacked["w_qkv"].dtype)
    rows = torch.full((B,), pos, dtype=torch.long, device=x.device)
    x, k_new, v_new = _layers_plain(stacked, cfg, x, view_k, view_v, cross_k,
                                    cross_v, rows)
    nxt, logp = _argmax_head(x @ stacked["w_head"] + stacked["b_head"][0])
    if time_major:
        self_k[:, pos] = k_new
        self_v[:, pos] = v_new
        return nxt, logp, self_k, self_v
    return nxt, logp, k_new, v_new


def fused_whole_step(stacked, cfg: ModelConfig, prev, self_k, self_v,
                     cross_k, cross_v, pos: int, *, time_major: bool = True):
    """Same contract as ``fused_whole_step_plain``; CUDA tensors go to the
    kernel (one launch for the embedding, every layer, the head and its
    argmax, counted), CPU tensors to the plain version. ``prev`` stays in
    device memory; ``pos`` is a Python int passed by value. A row whose
    ``prev`` lies outside the vocabulary gets nxt -1, logp NaN and NaN
    fresh rows (time-major: at slot ``pos``, no other slot touched). The
    kernel runs the rows in groups, one thread-block cluster a group, as B7
    does (``cluster_geometry("whole_step", ...)`` gives the shape); a model it
    does not split raises ``ValueError``. The TPU kernel's padding of the
    vocabulary to 128 columns (a -1e9 head bias) and of the position table are
    dropped."""
    if not self_k.is_cuda:
        return fused_whole_step_plain(stacked, cfg, prev, self_k, self_v,
                                      cross_k, cross_v, pos,
                                      time_major=time_major)
    _require_mha(cfg, "the whole step")
    _require_float(stacked, "the whole step")
    if time_major:
        L, T, B, D = self_k.shape
        shape = (L, T, B, D)
    else:
        L, B, T, D = self_k.shape
        shape = (L, B, T, D)
    L_enc = cross_k.shape[2]
    dt, dev = self_k.dtype, self_k.device
    _check_layer_shapes(cfg, "whole step", dt, D, L_enc)
    _build.require(prev, "prev", dtype=torch.int32, shape=(B,), device=dev)
    for name, t in (("self_k", self_k), ("self_v", self_v)):
        _build.require(t, name, dtype=dt, shape=shape, device=dev,
                       aligned=True)
    for name, t in (("cross_k", cross_k), ("cross_v", cross_v)):
        _build.require(t, name, dtype=dt, shape=(L, B, L_enc, D),
                       device=dev, aligned=True)
    _, weights = _weight_ptrs(stacked, cfg, L, dt, dev)
    V, Tpos, (emb, pos_emb, w_head, b_head) = _table_ptrs(stacked, D, dev)
    if not 0 <= pos < T:
        raise ValueError(f"pos {pos} outside the cache of {T} slots")

    nxt = torch.empty((B,), dtype=torch.int32, device=dev)
    logp = torch.empty((B,), dtype=torch.float32, device=dev)
    rows = () if time_major else tuple(
        torch.empty((L, B, D), dtype=dt, device=dev) for _ in range(2))
    ptrs = [prev.data_ptr(), emb, pos_emb, *weights]
    ptrs += [t.data_ptr() for t in (self_k, self_v, cross_k, cross_v)]
    ptrs += [w_head, b_head, nxt.data_ptr(), logp.data_ptr()]
    ptrs += [t.data_ptr() for t in rows]
    entry = _WHOLE_ENTRY[time_major, dt]
    code = getattr(_build.library(), entry)(
        *ptrs, L, B, T, D, cfg.nhead, cfg.dim_feedforward, L_enc, V, Tpos,
        int(pos), _build.stream_handle(dev))
    _check_code(code, entry, cfg, B)
    _build.count(fused_whole_step)
    return (nxt, logp, *(rows or (self_k, self_v)))


fused_whole_step.launches = 0
