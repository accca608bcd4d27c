"""Greedy and beam decode over the fused decoder-step kernels.

Port of ``handwritten_math_ocr_api_tpu/decode/fused.py``: greedy decode in
each of its variants and ``beam_decode_fused``, on merged-head caches:
self ``(L, B, T, kvd)`` (v4: time-major ``(L, T, B, D)``), kvd =
``cfg.kv_dim``, cross ``(L, B, L_enc, D)``.

Grouped self-attention, as the JAX functions take it: MQA (``nhead_kv=1``)
decodes greedy with variant "v2" (B1's MQA kernel) and beam search (B7's);
every other variant raises ``NotImplementedError`` under MQA ("v2m" too,
as in JAX), and GQA (1 < ``nhead_kv`` < ``nhead``) raises in both, as its
configs decode on the default route (``DecodeEngine`` moves a GQA
``use_fused`` engine there).

- ``greedy_decode_fused``: the same tokens, early exit and confidence
  bookkeeping as ``decode/greedy.py`` (the loop is shared), each step
  through all decoder layers in one launch. Its ``variant`` picks the
  kernel, as the JAX function's A/B arms do:

  - "v2" (the default, the engine's) and "v2m": one launch of
    ``ops/fused_step.fused_decoder_layers_step_v2`` (B1) a step, whose
    fresh K/V rows the loop appends at ``step``, then the float32 head.
    "v2m" is the TPU kernel's MXU formulation of the same attention; the
    JAX tests hold both to one reference step, so the port runs B1 for
    both;
  - "v1": one launch of ``fused_decoder_layers_step`` (B11) a step, which
    writes the fresh rows into the caches itself, then the float32 head;
  - "v3" and "v4": one launch of ``fused_whole_step`` (B10) a step: the
    embedding, the layers, the float32 head and its argmax; "v3" over the
    batch-major caches (the loop appends the fresh rows), "v4" over
    time-major ones that the kernel writes in place;
  - "v5": one launch of ``ops/whole_decode.fused_whole_decode`` (B12) for
    the whole decode, with its bundle of ``build_resident``.

  v1, v3 and v4 take a float bundle (their TPU kernels would cast
  activations to int8 on an int8 one); v2, v2m and v5 also the int8 one.
  v1, v2 and v2m also sample (``rng``, a ``torch.Generator``, with
  ``temperature``, ``top_k`` and ``top_p``) and decode under a
  ``constraint`` (``decode/constrain.py``): the pick of
  ``decode/sampling.TokenPick`` runs on the float32 logits of the head
  after the step kernel, as JAX's runs in XLA on its kernel's logits. v3,
  v4 and v5 pick the token in the kernel and refuse both, as in JAX.
- ``beam_decode_fused``: the bookkeeping of ``decode/beam.py`` over B*K
  rows, each step one launch of ``ops/fused_step.fused_ragged_step``
  (embedding, every layer and the float32 head; its logits) and one of
  ``ops/beam_reorder.beam_cache_gather`` (the parent gather of both self
  caches).

B7's segment-ring mode and its ``n_chunks`` serve continuous batching's
segments (``decode/continuous.py``), not these loops.

The JAX loop of "v2" chains one while-loop per T-prefix bucket
(``t_buckets``), so that the TPU kernel's block DMA fetches only a prefix
of the cache. The port's kernels read only the slots before ``pos`` in the
first place, so one loop does the same work and ``t_buckets`` has no
effect. The cross K/V are not padded (the TPU kernels padded L_enc to
their 16-row tile and masked the padding), so a step attends to all their
slots.
"""

from __future__ import annotations

import torch

from ..core.config import EOS_ID, ModelConfig, PAD_ID, SOS_ID
from ..models import layers
from ..models.decoder import _proj
from ..models.model import compute_dtype
from ..ops.beam_reorder import beam_cache_gather, beam_cache_gather_plain
from ..ops.fused_step import (
    _is_int8,
    build_stacked_full,
    fused_decoder_layers_step,
    fused_decoder_layers_step_plain,
    fused_decoder_layers_step_v2,
    fused_decoder_layers_step_v2_plain,
    fused_ragged_step,
    fused_ragged_step_plain,
    fused_whole_step,
    fused_whole_step_plain,
)
from ..ops.whole_decode import (
    build_resident,
    fused_whole_decode,
    fused_whole_decode_plain,
)
from .beam import BeamResult, BeamSearch
from .greedy import GreedyResult, greedy_loop
from .sampling import TokenPick


def project_cross_kv_merged(decoder_params, cfg: ModelConfig, memory):
    """memory (B, L_enc, D) -> (cross_k, cross_v), each (L, B, L_enc, D) in
    the compute dtype."""
    mem = memory.to(compute_dtype(cfg))
    cross = [lp["cross_attn"] for lp in decoder_params["layers"]]
    return (torch.stack([_proj(p, mem, "k") for p in cross]),
            torch.stack([_proj(p, mem, "v") for p in cross]))


def init_fused_cache(decoder_params, cfg: ModelConfig, memory,
                     max_len=None, *, time_major: bool = False):
    """(self_k, self_v, cross_k, cross_v): zero self caches
    (L, B, T, kvd), kvd = ``cfg.kv_dim`` (the self-attention weights'
    K/V width: D under MHA), or with ``time_major`` (the "v4" step's, MHA)
    (L, T, B, D), and the projected cross K/V."""
    B = memory.shape[0]
    T = max_len or cfg.max_seq_len
    L, kvd = cfg.num_decoder_layers, cfg.kv_dim
    shape = (L, T, B, kvd) if time_major else (L, B, T, kvd)
    dtype = compute_dtype(cfg)
    self_k = torch.zeros(shape, dtype=dtype, device=memory.device)
    self_v = torch.zeros(shape, dtype=dtype, device=memory.device)
    return (self_k, self_v,
            *project_cross_kv_merged(decoder_params, cfg, memory))


VARIANTS = ("v1", "v2", "v2m", "v3", "v4", "v5")


def _steps_run(tokens, eos_id: int, T: int) -> int:
    """The steps of the shared loop for these tokens: up to the step at
    which the last row emitted eos_id, or all T."""
    is_eos = tokens == eos_id
    if tokens.shape[0] == 0 or not bool(is_eos.any(dim=1).all()):
        return T
    return int(is_eos.int().argmax(dim=1).max()) + 1


@torch.inference_mode()
def greedy_decode_fused(decoder_params, stacked, cfg: ModelConfig, memory,
                        max_len=None, *, sos_id: int = SOS_ID,
                        eos_id: int = EOS_ID, pad_id: int = PAD_ID,
                        variant: str = "v2",
                        t_buckets: tuple = (40, 80, 120),
                        kernels: bool = True, rng=None,
                        temperature: float = 1.0, top_k: int = 0,
                        top_p: float = 1.0,
                        constraint=None) -> GreedyResult:
    """Greedy decode of ``memory`` (B, L_enc, D) through the kernel of
    ``variant`` (module docstring). ``stacked`` from
    ``ops/fused_step.build_stacked`` (v1, v2, v2m; or its int8 form for
    v2, v2m), ``build_stacked_full`` (v3, v4; built here from
    ``decoder_params`` when its tables are missing) or
    ``ops/whole_decode.build_resident`` (v5; built here, int8 when
    ``stacked`` holds scales, when its tables or ``_params`` are
    missing). ``t_buckets`` is accepted and has no effect. ``kernels=False``
    takes the plain versions even on CUDA (the reference path). ``rng``
    (a generator on ``memory``'s device) samples; ``constraint`` masks the
    logits (module docstring)."""
    if variant not in VARIANTS:
        raise ValueError(f"variant {variant!r} is none of {VARIANTS}")
    for what, arg in (("sampled", rng), ("constrained", constraint)):
        if arg is not None and variant not in ("v1", "v2", "v2m"):
            raise NotImplementedError(
                f"{what} fused decode needs the logits outside the kernel; "
                f"variant {variant!r} computes the argmax in the kernel: "
                f"use 'v2'")
    if cfg.kv_heads != cfg.nhead and (variant != "v2"
                                      or cfg.kv_heads != 1):
        raise NotImplementedError(
            f"fused variant {variant!r} supports MHA, and MQA (nhead_kv=1) "
            "via variant='v2': the TPU kernel's lane replication of the "
            "shared K/V head is only head-order-correct at one kv head. GQA "
            "(1 < nhead_kv < nhead) decodes on the default route")
    T = max_len or cfg.max_seq_len
    ids = {"sos_id": sos_id, "eos_id": eos_id, "pad_id": pad_id}
    if variant == "v5":
        if "emb" not in stacked or "_params" not in stacked:
            # int8 only when the caller's bundle was quantized, as JAX
            quantized = any(k.endswith("_s") for k in stacked)
            stacked = build_resident(decoder_params, cfg, quantized,
                                     memory.device)
        decode = fused_whole_decode if kernels else fused_whole_decode_plain
        res = decode(stacked, cfg, memory, T, **ids)
        tokens = res.tokens.long()
        return GreedyResult(tokens, res.lengths, res.logprob_sum,
                            res.token_count.long(),
                            _steps_run(tokens, eos_id, T))
    if variant in ("v1", "v3", "v4") and _is_int8(stacked):
        raise ValueError(f"variant {variant!r} takes a bf16 or float32 "
                         f"bundle: its TPU kernel would cast activations to "
                         f"int8 on the int8 one")
    if variant in ("v3", "v4") and "emb" not in stacked:
        stacked = build_stacked_full(decoder_params, cfg, memory.device)
    sk, sv, ck, cv = init_fused_cache(decoder_params, cfg, memory, T,
                                      time_major=variant == "v4")

    if variant in ("v3", "v4"):
        whole = fused_whole_step if kernels else fused_whole_step_plain

        def pick(prev, step):
            nxt, logp, k, v = whole(stacked, cfg, prev.to(torch.int32), sk,
                                    sv, ck, cv, step,
                                    time_major=variant == "v4")
            if variant == "v3":
                sk[:, :, step] = k
                sv[:, :, step] = v
            return nxt, logp

        return greedy_loop(pick, memory.shape[0], T, memory.device, **ids,
                           argmax_in_step=True)

    dtype = compute_dtype(cfg)
    emb = decoder_params["embedding"]["table"]
    pos_table = decoder_params["pos"]["table"]
    if variant == "v1":
        step_fn = (fused_decoder_layers_step if kernels
                   else fused_decoder_layers_step_plain)
    else:
        step_fn = (fused_decoder_layers_step_v2 if kernels
                   else fused_decoder_layers_step_v2_plain)

    def step_logits(prev, step):
        # a step past the positional table takes its last row, as JAX's
        # gather clamps (a model whose max_seq_len is under the decode's)
        at = min(step, pos_table.shape[0] - 1)
        x_emb = (emb[prev] + pos_table[at]).to(dtype)
        x, k, v = step_fn(stacked, cfg, x_emb, sk, sv, ck, cv, step)
        if variant != "v1":  # v1 wrote the rows into the caches itself
            sk[:, :, step] = k
            sv[:, :, step] = v
        return layers.linear(decoder_params["fc_out"], x.float())

    pick = None
    if rng is not None or constraint is not None:
        pick = TokenPick(memory.shape[0], T, memory.device,
                         constraint=constraint, generator=rng,
                         temperature=temperature, top_k=top_k, top_p=top_p)
    return greedy_loop(step_logits, memory.shape[0], T, memory.device, **ids,
                       pick=pick)


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
    written them), so the prefix gather is the whole gather. MHA and MQA
    (``nhead_kv=1``); GQA raises ``NotImplementedError``, as in JAX."""
    if cfg.kv_heads not in (cfg.nhead, 1):
        raise NotImplementedError(
            "fused beam decode supports MHA and MQA (nhead_kv=1); GQA "
            "decodes on the default beam path")
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
