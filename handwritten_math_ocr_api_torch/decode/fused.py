"""Greedy and beam decode over the fused decoder-step kernels.

Port of ``handwritten_math_ocr_api_tpu/decode/fused.py`` for greedy decode
in its default variant "v2" and for ``beam_decode_fused``, on merged-head
caches: self ``(L, B, T, D)``, cross ``(L, B, L_enc, D)``.

- ``greedy_decode_fused``: the same tokens, early exit and confidence
  bookkeeping as ``decode/greedy.py`` (the loop is shared), but each step
  is one launch of ``ops/fused_step.fused_decoder_layers_step_v2``
  through all decoder layers. The step returns the fresh K/V rows, which
  the loop appends at ``step``.
- ``beam_decode_fused``: the bookkeeping of ``decode/beam.py`` over B*K
  rows, each step one launch of ``ops/fused_step.fused_ragged_step``
  (embedding, every layer and the float32 head; its logits) and one of
  ``ops/beam_reorder.beam_cache_gather`` (the parent gather of both self
  caches).

The JAX loop chains one while-loop per T-prefix bucket (``t_buckets``), so
that the TPU kernel's block DMA fetches only a prefix of the cache. The
port's kernel reads only the slots before ``pos`` in the first place, so
one loop does the same work. The cross K/V are not padded (the TPU kernel
padded L_enc to its 16-row tile and masked the padding), so the step
attends to all their slots.
"""

from __future__ import annotations

import torch

from ..core.config import ModelConfig
from ..models import layers
from ..models.decoder import _check_mha, _proj
from ..models.model import compute_dtype
from ..ops.beam_reorder import beam_cache_gather, beam_cache_gather_plain
from ..ops.fused_step import (
    fused_decoder_layers_step_v2,
    fused_decoder_layers_step_v2_plain,
    fused_ragged_step,
    fused_ragged_step_plain,
)
from .beam import BeamResult, BeamSearch
from .greedy import GreedyResult, greedy_loop


def project_cross_kv_merged(decoder_params, cfg: ModelConfig, memory):
    """memory (B, L_enc, D) -> (cross_k, cross_v), each (L, B, L_enc, D) in
    the compute dtype."""
    mem = memory.to(compute_dtype(cfg))
    cross = [lp["cross_attn"] for lp in decoder_params["layers"]]
    return (torch.stack([_proj(p, mem, "k") for p in cross]),
            torch.stack([_proj(p, mem, "v") for p in cross]))


def init_fused_cache(decoder_params, cfg: ModelConfig, memory,
                     max_len=None):
    """(self_k, self_v, cross_k, cross_v): zero self caches
    (L, B, T, D) and the projected cross K/V."""
    _check_mha(cfg)
    B = memory.shape[0]
    T = max_len or cfg.max_seq_len
    shape = (cfg.num_decoder_layers, B, T, cfg.d_model)
    dtype = compute_dtype(cfg)
    self_k = torch.zeros(shape, dtype=dtype, device=memory.device)
    self_v = torch.zeros(shape, dtype=dtype, device=memory.device)
    return (self_k, self_v,
            *project_cross_kv_merged(decoder_params, cfg, memory))


@torch.inference_mode()
def greedy_decode_fused(decoder_params, stacked, cfg: ModelConfig, memory,
                        max_len=None, *, kernels: bool = True
                        ) -> GreedyResult:
    """``stacked`` from ``ops/fused_step.build_stacked``. ``kernels=False``
    takes the step's plain version even on CUDA (the reference path)."""
    T = max_len or cfg.max_seq_len
    dtype = compute_dtype(cfg)
    sk, sv, ck, cv = init_fused_cache(decoder_params, cfg, memory, T)
    emb = decoder_params["embedding"]["table"]
    pos_table = decoder_params["pos"]["table"]
    step_fn = (fused_decoder_layers_step_v2 if kernels
               else fused_decoder_layers_step_v2_plain)

    def step_logits(prev, step):
        x_emb = (emb[prev] + pos_table[step]).to(dtype)
        x, k_new, v_new = step_fn(stacked, cfg, x_emb, sk, sv, ck, cv, step)
        sk[:, :, step] = k_new
        sv[:, :, step] = v_new
        return layers.linear(decoder_params["fc_out"], x.float())

    return greedy_loop(step_logits, memory.shape[0], T, memory.device)


@torch.inference_mode()
def beam_decode_fused(decoder_params, stacked, cfg: ModelConfig, memory,
                      beam_size: int = 5, max_len=None, *,
                      alpha: float = 0.0, kernels: bool = True
                      ) -> BeamResult:
    """Beam search over the ragged step, the same tokens as
    ``decode/beam.py::beam_decode``. ``stacked`` from
    ``ops/fused_step.build_stacked_full``. ``kernels=False`` takes the
    plain step and gather even on CUDA (the reference path).

    The JAX function pads the B*K rows to the TPU's row tile and runs its
    loop in T-prefix buckets (40/80/120) for static TPU shapes; the port
    runs exactly B*K rows, and gathers exactly the written prefix
    [0, step + 1) each step. Two cache pairs alternate: the step reads one
    (its slots before ``step``), its fresh rows are appended to it at
    ``step``, and the gather writes the reordered prefix into the other.
    Slots after ``step`` are zero in every row of both pairs (no step has
    written them), so the prefix gather is the whole gather."""
    if "emb" not in stacked:
        raise ValueError("beam_decode_fused needs build_stacked_full's "
                         "bundle (the embedding and head tables)")
    B = memory.shape[0]
    K = beam_size
    R = B * K
    T = max_len or cfg.max_seq_len
    dev = memory.device
    sk, sv, ck, cv = init_fused_cache(decoder_params, cfg,
                                      memory.repeat_interleave(K, dim=0), T)
    spare = (torch.zeros_like(sk), torch.zeros_like(sv))
    step_fn = fused_ragged_step if kernels else fused_ragged_step_plain
    gather = beam_cache_gather if kernels else beam_cache_gather_plain
    positions = torch.arange(T, dtype=torch.int32, device=dev)[:, None]
    positions = positions.expand(T, R).contiguous()    # row t: (R,) of t
    beams = BeamSearch(B, K, T, dev)
    step = 0
    while step < T:
        logits, k_new, v_new = step_fn(
            stacked, cfg, beams.prev.to(torch.int32), positions[step], sk,
            sv, ck, cv, return_logits=True)
        sk[:, :, step] = k_new
        sv[:, :, step] = v_new
        src = beams.step(torch.log_softmax(logits, dim=-1), step)
        gk, gv = gather(sk, sv, src.to(torch.int32), step + 1, out=spare)
        spare = (sk, sv)
        sk, sv = gk, gv
        step += 1
        if beams.all_finished():
            break
    return beams.result(alpha, step)
