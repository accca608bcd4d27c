"""Whole decode steps through every decoder layer: CUDA kernels + plain.

Port of ``handwritten_math_ocr_api_tpu/ops/fused_step.py`` for two of its
steps and their weight bundles:

- the compute-only "v2" greedy step (``fused_decoder_layers_step_v2``,
  body ``_make_kernel_v2``; bundle ``build_stacked``), kernel
  ``csrc/fused_step.cu``: one launch runs all L post-norm decoder layers of
  one step at one position for the batch (packed qkv projection,
  self-attention over the read-only cache plus the fresh row, output
  projection, residual and LayerNorm; cross-attention over the encoder
  K/V, residual and LayerNorm; ReLU FFN, residual and LayerNorm) and
  returns the last layer's activations and each layer's fresh K/V row;
- the ragged step (``fused_ragged_step``, body ``_make_kernel_ragged``;
  bundle ``build_stacked_full``), kernel ``csrc/ragged_step.cu``: the
  embedding, the same layers and the float32 output head in one launch,
  each row at its own position, returning the head's logits (beam search)
  or each row's argmax and its log-probability.

The caller appends the fresh rows to the caches. Both kernels share their
layer code (``csrc/decoder_layers.cuh``).

Numerics of the TPU kernels: the activation row is carried in float32
across the sublayers; each matmul input is rounded to the weight dtype and
accumulated in float32; biases and LayerNorm parameters are float32;
attention logits and softmax are float32; the fresh K/V row is rounded to
the cache dtype before it joins attention at slot ``pos``, and slots after
``pos`` are not attended (the TPU kernels' -inf mask). The ragged step's
embedding, positional and head tables are float32 too.

Caches are merged-head: self ``(L, B, T, D)``, cross ``(L, B, L_enc, D)``,
heads interleaved along D in torch's order. Only the bf16/float32 weight
bundles are ported; the int8 one (``quantize_stacked``) is not.
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

from ..core.config import ModelConfig
from . import _build

_ENTRY = {torch.bfloat16: "fused_decoder_step_bf16",
          torch.float32: "fused_decoder_step_f32"}
_RAGGED_ENTRY = {torch.bfloat16: "ragged_step_bf16",
                 torch.float32: "ragged_step_f32"}
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


def _heads_attention(q, k, v, nhead: int, keep=None):
    """q (B, D) float32 pre-scaled; k, v (B, S, D) float32 -> (B, D).
    ``keep`` (B, S) bool: the slots each row attends (all if None)."""
    B, S, D = k.shape
    dh = D // nhead
    qh = q.reshape(B, nhead, 1, dh)
    kh = k.reshape(B, S, nhead, dh).transpose(1, 2)
    vh = v.reshape(B, S, nhead, dh).transpose(1, 2)
    logits = qh @ kh.transpose(-1, -2)
    if keep is not None:
        logits = logits.masked_fill(~keep[:, None, None, :], float("-inf"))
    probs = torch.softmax(logits, dim=-1)
    return (probs @ vh).reshape(B, D)


def fused_decoder_layers_step_v2_plain(stacked, cfg: ModelConfig, x_emb,
                                       self_k, self_v, cross_k, cross_v,
                                       pos: int):
    """x_emb (B, D); self caches (L, B, T, D), read only; cross K/V
    (L, B, L_enc, D), every slot attended (unpadded). Returns
    (x_out (B, D) float32, k_new, v_new (L, B, D) in the cache dtype)."""
    L, B, T, D = self_k.shape
    if not 0 <= pos < T:
        raise ValueError(f"pos {pos} outside the cache of {T} slots")
    rows = torch.full((B,), pos, dtype=torch.long, device=x_emb.device)
    return _layers_plain(stacked, cfg, x_emb.float(), self_k, self_v,
                         cross_k, cross_v, rows)


def fused_decoder_layers_step_v2(stacked, cfg: ModelConfig, x_emb, self_k,
                                 self_v, cross_k, cross_v, pos: int):
    """Same contract as ``fused_decoder_layers_step_v2_plain``; CUDA tensors
    go to the kernel (one launch for all layers, counted), CPU tensors to
    the plain version. ``pos`` is a Python int passed by value."""
    if not x_emb.is_cuda:
        return fused_decoder_layers_step_v2_plain(
            stacked, cfg, x_emb, self_k, self_v, cross_k, cross_v, pos)
    L, B, T, D = self_k.shape
    L_enc = cross_k.shape[2]
    H, ff = cfg.nhead, cfg.dim_feedforward
    dt = x_emb.dtype
    dev = x_emb.device
    if dt not in _ENTRY:
        raise ValueError(f"decoder step kernel takes bf16 or float32, "
                         f"not {dt}")
    if D != cfg.d_model or D % H or (D // H) % 8 or ff % 8:
        raise ValueError(f"decoder step kernel needs D = d_model, head dim "
                         f"and FFN width multiples of 8 (D {D}, {H} heads, "
                         f"FFN {ff})")
    if not 0 <= pos < T:
        raise ValueError(f"pos {pos} outside the cache of {T} slots")
    if L_enc < 1:
        raise ValueError("no encoder slots to attend")
    _build.require(x_emb, "x_emb", shape=(B, D), device=dev)
    for name, t in (("self_k", self_k), ("self_v", self_v)):
        _build.require(t, name, dtype=dt, shape=(L, B, T, D), device=dev,
                       aligned=True)
    for name, t in (("cross_k", cross_k), ("cross_v", cross_v)):
        _build.require(t, name, dtype=dt, shape=(L, B, L_enc, D),
                       device=dev, aligned=True)
    shapes = {"w_qkv": (L, D, 3 * D), "w_out": (L, D, D),
              "w_cq": (L, D, D), "w_co": (L, D, D), "w_ff1": (L, D, ff),
              "w_ff2": (L, ff, D)}
    for name, shape in shapes.items():
        _build.require(stacked[name], name, dtype=dt, shape=shape,
                       device=dev, aligned=True)
    for name, key in zip(BIAS_KEYS, WEIGHT_KEYS):
        _build.require(stacked[name], name, dtype=torch.float32,
                       shape=(L, 1, shapes[key][-1]), device=dev)
    _build.require(stacked["ln"], "ln", dtype=torch.float32,
                   shape=(L, 6, D), device=dev)

    x_out = torch.empty((B, D), dtype=torch.float32, device=dev)
    k_new = torch.empty((L, B, D), dtype=dt, device=dev)
    v_new = torch.empty((L, B, D), dtype=dt, device=dev)
    lib = _build.library()
    ptrs = [x_emb.data_ptr()]
    for w, b in zip(WEIGHT_KEYS, BIAS_KEYS):
        ptrs += [stacked[w].data_ptr(), stacked[b].data_ptr()]
    ptrs += [stacked["ln"].data_ptr()]
    ptrs += [t.data_ptr() for t in (self_k, self_v, cross_k, cross_v, x_out,
                                    k_new, v_new)]
    code = getattr(lib, _ENTRY[dt])(
        *ptrs, L, B, T, D, H, ff, L_enc, int(pos),
        _build.stream_handle(dev))
    _build.check(code, _ENTRY[dt])
    fused_decoder_layers_step_v2.launches += 1
    return x_out, k_new, v_new


fused_decoder_layers_step_v2.launches = 0


def _layers_plain(stacked, cfg: ModelConfig, x, self_k, self_v, cross_k,
                  cross_v, pos):
    """Every layer on float32 rows x (R, D), row r at slot pos[r] (R,):
    it attends its cache slots before pos[r] and its fresh row. Returns
    (x, k_new, v_new (L, R, D) in the cache dtype)."""
    L, R, T, D = self_k.shape
    H = cfg.nhead
    scale = 1.0 / math.sqrt(D // H)
    wdt = stacked["w_qkv"].dtype
    cdt = self_k.dtype
    ln = stacked["ln"]
    slot = torch.arange(T, device=x.device)[None, :]
    before = (slot < pos[:, None])[..., None]              # (R, T, 1)
    at = (slot == pos[:, None])[..., None]
    keep = (slot <= pos[:, None])

    def mm(x, name, bias):
        w = stacked[name][layer].float()
        return x.to(wdt).float() @ w + stacked[bias][layer, 0]

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
        q, k_new, v_new = qkv[:, :D], qkv[:, D:2 * D], qkv[:, 2 * D:]
        k_new, v_new = k_new.to(cdt), v_new.to(cdt)
        k_out.append(k_new)
        v_out.append(v_new)
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


def fused_ragged_step_plain(stacked, cfg: ModelConfig, prev, pos, self_k,
                            self_v, cross_k, cross_v, *,
                            return_logits: bool = False):
    """One decode step for R rows at their own positions. prev, pos: (R,)
    int32 (the previous token and the slot of each row); self caches
    (L, R, T, D), read only; cross K/V (L, R, L_enc, D), every slot
    attended. ``stacked`` from ``build_stacked_full``.

    Returns (logits (R, V) float32, k_new, v_new) with ``return_logits``,
    else (nxt (R,) int32, logp (R,) float32, k_new, v_new); k_new and
    v_new are (L, R, D) in the cache dtype."""
    T = self_k.shape[2]
    pos = pos.long()
    if pos.numel() and (int(pos.min()) < 0 or int(pos.max()) >= T):
        raise ValueError(f"a position lies outside the cache of {T} slots")
    wdt = stacked["w_qkv"].dtype
    x = (stacked["emb"][prev.long()] + stacked["pos_emb"][pos]).to(wdt)
    x, k_new, v_new = _layers_plain(stacked, cfg, x.float(), self_k, self_v,
                                    cross_k, cross_v, pos)
    logits = x @ stacked["w_head"] + stacked["b_head"][0]
    if return_logits:
        return logits, k_new, v_new
    return (*_argmax_head(logits), k_new, v_new)


def fused_ragged_step(stacked, cfg: ModelConfig, prev, pos, self_k, self_v,
                      cross_k, cross_v, *, return_logits: bool = False):
    """Same contract as ``fused_ragged_step_plain``; CUDA tensors go to the
    kernel (one launch for the embedding, every layer and the head,
    counted), CPU tensors to the plain version.

    ``prev`` and ``pos`` stay in device memory: the wrapper reads no value
    of them, so a step makes no host round trip. A row whose ``prev`` or
    ``pos`` is out of range gets NaN outputs (nxt -1) and reads nothing.
    Three options of the TPU kernel are TPU tiling and are dropped: the
    ``block_b`` row chunk and its multiple-of-8 rule (CUDA has no sublane
    tile: one block per row), the ``t_active`` prefix bucket (the kernel
    reads no slot after a row's position anyway) and the zeroing of V past
    the horizon (NaN protection that becomes not reading those slots).
    Ring mode, ``n_chunks``, the int8 bundle and MQA are not ported."""
    if not self_k.is_cuda:
        return fused_ragged_step_plain(stacked, cfg, prev, pos, self_k,
                                       self_v, cross_k, cross_v,
                                       return_logits=return_logits)
    L, R, T, D = self_k.shape
    L_enc = cross_k.shape[2]
    H, ff = cfg.nhead, cfg.dim_feedforward
    dt = self_k.dtype
    dev = self_k.device
    V, Tpos = stacked["emb"].shape[0], stacked["pos_emb"].shape[0]
    if dt not in _RAGGED_ENTRY:
        raise ValueError(f"ragged step kernel takes bf16 or float32, "
                         f"not {dt}")
    if D != cfg.d_model or D % H or (D // H) % 8 or ff % 8:
        raise ValueError(f"ragged step kernel needs D = d_model, head dim "
                         f"and FFN width multiples of 8 (D {D}, {H} heads, "
                         f"FFN {ff})")
    if L_enc < 1:
        raise ValueError("no encoder slots to attend")
    for name, t in (("prev", prev), ("pos", pos)):
        _build.require(t, name, dtype=torch.int32, shape=(R,), device=dev)
    for name, t in (("self_k", self_k), ("self_v", self_v)):
        _build.require(t, name, dtype=dt, shape=(L, R, T, D), device=dev,
                       aligned=True)
    for name, t in (("cross_k", cross_k), ("cross_v", cross_v)):
        _build.require(t, name, dtype=dt, shape=(L, R, L_enc, D),
                       device=dev, aligned=True)
    shapes = {"w_qkv": (L, D, 3 * D), "w_out": (L, D, D),
              "w_cq": (L, D, D), "w_co": (L, D, D), "w_ff1": (L, D, ff),
              "w_ff2": (L, ff, D)}
    for name, shape in shapes.items():
        _build.require(stacked[name], name, dtype=dt, shape=shape,
                       device=dev, aligned=True)
    f32 = torch.float32
    for name, key in zip(BIAS_KEYS, WEIGHT_KEYS):
        _build.require(stacked[name], name, dtype=f32,
                       shape=(L, 1, shapes[key][-1]), device=dev)
    tables = {"ln": (L, 6, D), "emb": (V, D), "pos_emb": (Tpos, D),
              "w_head": (D, V), "b_head": (1, V)}
    for name, shape in tables.items():
        _build.require(stacked[name], name, dtype=f32, shape=shape,
                       device=dev)

    k_new = torch.empty((L, R, D), dtype=dt, device=dev)
    v_new = torch.empty((L, R, D), dtype=dt, device=dev)
    if return_logits:
        outs = (torch.empty((R, V), dtype=f32, device=dev),)
        heads = [outs[0].data_ptr(), None, None]
    else:
        outs = (torch.empty((R,), dtype=torch.int32, device=dev),
                torch.empty((R,), dtype=f32, device=dev))
        heads = [None, outs[0].data_ptr(), outs[1].data_ptr()]
    ptrs = [prev.data_ptr(), pos.data_ptr(), stacked["emb"].data_ptr(),
            stacked["pos_emb"].data_ptr()]
    for w, b in zip(WEIGHT_KEYS, BIAS_KEYS):
        ptrs += [stacked[w].data_ptr(), stacked[b].data_ptr()]
    ptrs += [t.data_ptr() for t in (stacked["ln"], self_k, self_v, cross_k,
                                    cross_v, stacked["w_head"],
                                    stacked["b_head"])]
    ptrs += heads + [k_new.data_ptr(), v_new.data_ptr()]
    lib = _build.library()
    code = getattr(lib, _RAGGED_ENTRY[dt])(
        *ptrs, L, R, T, D, H, ff, L_enc, V, Tpos, _build.stream_handle(dev))
    _build.check(code, _RAGGED_ENTRY[dt])
    fused_ragged_step.launches += 1
    return (*outs, k_new, v_new)


fused_ragged_step.launches = 0
