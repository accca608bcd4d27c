"""A whole greedy decode in one launch: CUDA kernel + plain version.

Port of ``handwritten_math_ocr_api_tpu/ops/whole_decode.py`` (the "v5"
decode, B12): ``fused_whole_decode`` runs every step of a greedy decode
(the embedding, all decoder layers, the float32 head, the argmax and the
finished/EOS bookkeeping) in one launch of ``csrc/whole_decode.cu``: each
thread-block cluster owns a group of rows and loops over the steps on the
cluster layer code of ``csrc/decoder_cluster.cuh``
(``ops/fused_step.cluster_geometry("whole_decode", ...)`` gives the
shape). ``build_resident`` makes its bundle:
``build_stacked_full``'s, int8 with ``quantize``, plus the decoder tree
under ``"_params"`` for the cross K/V projection at the decode's start.

Semantics of ``decode/fused.py::greedy_decode_fused``: a row emits its
argmax until it emits ``eos_id`` (that step counted in the log-prob sum),
then ``pad_id``; ``logprob_sum`` adds log(p_max + 1e-10) over its live
steps and ``token_count`` counts its non-EOS tokens. The TPU kernel runs
all ``T_out`` steps for every row; a finished row's later steps change no
output, so the kernel drops a row at its EOS, each cluster stops where
its group's rows have all finished, and the plain version at the step
where every row has finished.

Numerics: those of the other fused steps (``ops/fused_step.py``), except
that attention takes each step's fresh K/V row in float32, unrounded, as
the TPU kernel does (``lnew = q * k_new``, ``p_new * v_new``); only the
stored row is rounded to the compute dtype. In float32 the two are the
same. The int8 bundle rounds matmul inputs to bf16 and scales the float32
sums before the bias, as B1's int8 entry.

TPU tiling that the port drops: the batch, ``L_enc`` and T padded to 16
rows (a -1e30 mask on the padded encoder slots), the merged K|V self
cache in time-major lanes and its prefix-bucket DMAs. The self cache is
the kernel's own scratch, batch-major ``(L, B, T_out, D)`` K and V.
"""

from __future__ import annotations

from typing import Dict, NamedTuple

import torch

from ..core.config import EOS_ID, ModelConfig, PAD_ID, SOS_ID
from . import _build
from .fused_step import (
    _argmax_head,
    _check_code,
    _check_layer_shapes,
    _embed_full,
    _layers_plain,
    _require_mha,
    _table_ptrs,
    _weight_ptrs,
    build_stacked_full,
    quantize_stacked,
)

_ENTRY = {(False, torch.bfloat16): "whole_decode_bf16",
          (False, torch.float32): "whole_decode_f32",
          (True, torch.bfloat16): "whole_decode_i8_bf16",
          (True, torch.float32): "whole_decode_i8_f32"}


class WholeDecodeOut(NamedTuple):
    tokens: torch.Tensor       # (B, T_out) int32, PAD after eos
    lengths: torch.Tensor      # (B,) non-pad count (incl. eos)
    logprob_sum: torch.Tensor  # (B,) float32 sum of chosen log-probs
    token_count: torch.Tensor  # (B,) int32 non-eos emitted tokens


def build_resident(decoder_params, cfg: ModelConfig, quantize: bool = True,
                   device=None) -> Dict[str, object]:
    """The bundle of ``fused_whole_decode``: ``build_stacked_full`` of the
    port's decoder tree (``convert.to_torch``), int8 with ``quantize``
    (``quantize_stacked``), and the tree itself under ``"_params"``, from
    which the decode projects the encoder memory's cross K/V."""
    st = build_stacked_full(decoder_params, cfg, device)
    if quantize:
        st = quantize_stacked(st)
    st["_params"] = decoder_params
    return st


def _cross_kv(stacked, cfg: ModelConfig, memory):
    from ..decode.fused import project_cross_kv_merged

    if "_params" not in stacked:
        raise ValueError("stacked must carry '_params' (see build_resident)")
    return project_cross_kv_merged(stacked["_params"], cfg, memory)


def _horizon(stacked, cfg: ModelConfig, max_len) -> int:
    T_out = max_len or cfg.max_seq_len
    if T_out <= 0:
        raise ValueError(f"{T_out} decode steps")
    return T_out


def _out(tokens, lp, cnt, pad_id) -> WholeDecodeOut:
    return WholeDecodeOut(tokens, (tokens != pad_id).sum(dim=-1), lp, cnt)


def fused_whole_decode_plain(stacked, cfg: ModelConfig, memory, max_len=None,
                             *, sos_id: int = SOS_ID, eos_id: int = EOS_ID,
                             pad_id: int = PAD_ID,
                             return_logits: bool = False):
    """memory (B, L_enc, D) -> ``WholeDecodeOut`` of a greedy decode of
    ``max_len`` (default ``cfg.max_seq_len``) steps. ``stacked`` from
    ``build_resident``. With ``return_logits`` also returns the float32
    head logits of every step run, (B, steps, V)."""
    from ..decode.greedy import greedy_loop

    _require_mha(cfg, "the whole decode")
    T_out = _horizon(stacked, cfg, max_len)
    ck, cv = _cross_kv(stacked, cfg, memory)
    L, B, _, D = ck.shape
    cdt = ck.dtype
    sk = torch.zeros((L, B, T_out, D), dtype=cdt, device=memory.device)
    sv = torch.zeros_like(sk)
    logits_seen = []

    def step(prev, t):
        rows = torch.full((B,), t, dtype=torch.long, device=memory.device)
        x, k_new, v_new = _layers_plain(
            stacked, cfg, _embed_full(stacked, prev, t, cdt), sk, sv, ck, cv,
            rows, round_fresh=False)
        sk[:, :, t] = k_new
        sv[:, :, t] = v_new
        logits = x @ stacked["w_head"] + stacked["b_head"][0]
        logits_seen.append(logits)
        return _argmax_head(logits)

    res = greedy_loop(step, B, T_out, memory.device, sos_id=sos_id,
                      eos_id=eos_id, pad_id=pad_id, argmax_in_step=True)
    out = _out(res.tokens.to(torch.int32), res.logprob_sum,
               res.token_count.to(torch.int32), pad_id)
    if return_logits:
        return out, torch.stack(logits_seen, dim=1)
    return out


def fused_whole_decode(stacked, cfg: ModelConfig, memory, max_len=None, *,
                       sos_id: int = SOS_ID, eos_id: int = EOS_ID,
                       pad_id: int = PAD_ID) -> WholeDecodeOut:
    """Same contract as ``fused_whole_decode_plain`` (without its logits);
    CUDA tensors go to the kernel (one launch for the whole decode,
    counted in ``launches`` or, on the int8 bundle, ``int8_launches``),
    CPU tensors to the plain version. The cross K/V projection before it
    runs on PyTorch's matmuls, as ``init_fused_cache`` does. A model the
    kernel does not split raises ``ValueError``; an MQA/GQA config
    ``NotImplementedError`` (MHA only, as the TPU kernel)."""
    if not memory.is_cuda:
        return fused_whole_decode_plain(stacked, cfg, memory, max_len,
                                        sos_id=sos_id, eos_id=eos_id,
                                        pad_id=pad_id)
    _require_mha(cfg, "the whole decode")
    T_out = _horizon(stacked, cfg, max_len)
    ck, cv = _cross_kv(stacked, cfg, memory)
    L, B, L_enc, D = ck.shape
    dt, dev = ck.dtype, ck.device
    _check_layer_shapes(cfg, "whole decode", dt, D, L_enc)
    quantized, weights = _weight_ptrs(stacked, cfg, L, dt, dev)
    V, Tpos, (emb, pos_emb, w_head, b_head) = _table_ptrs(stacked, D, dev)
    if not 0 <= sos_id < V:
        raise ValueError(f"sos_id {sos_id} outside the vocabulary of {V}")
    for name, t in (("cross_k", ck), ("cross_v", cv)):
        _build.require(t, name, dtype=dt, shape=(L, B, L_enc, D),
                       device=dev, aligned=True)

    sk = torch.empty((L, B, T_out, D), dtype=dt, device=dev)
    sv = torch.empty_like(sk)
    tokens = torch.empty((B, T_out), dtype=torch.int32, device=dev)
    lp = torch.empty((B,), dtype=torch.float32, device=dev)
    cnt = torch.empty((B,), dtype=torch.int32, device=dev)
    ptrs = [emb, pos_emb, *weights]
    ptrs += [t.data_ptr() for t in (sk, sv, ck, cv)]
    ptrs += [w_head, b_head, tokens.data_ptr(), lp.data_ptr(),
             cnt.data_ptr()]
    entry = _ENTRY[quantized, dt]
    code = getattr(_build.library(), entry)(
        *ptrs, L, B, T_out, D, cfg.nhead, cfg.dim_feedforward, L_enc, V,
        Tpos, sos_id, eos_id, pad_id, _build.stream_handle(dev))
    _check_code(code, entry, cfg, B)
    if quantized:
        _build.count(fused_whole_decode, "int8_launches")
    else:
        _build.count(fused_whole_decode)
    return _out(tokens, lp, cnt, pad_id)


fused_whole_decode.launches = 0
fused_whole_decode.int8_launches = 0

