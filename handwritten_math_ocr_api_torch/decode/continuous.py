"""Continuous batching: a pool of decode slots with mid-flight admission and
a pipelined host scheduler.

Port of ``handwritten_math_ocr_api_tpu/decode/continuous.py``. The decoder
state is a fixed pool of SLOTS, each an independent sequence at its own
position in a shared KV cache. Decode runs in short SEGMENTS of steps, and
between segments the host harvests finished slots and admits queued
requests into the freed rows (encode, cross K/V projection and scatter in
one insert a bucket of admissions). A request that arrives mid-decode joins
the running pool at the next segment instead of waiting for a batch to end.

The pieces, as in JAX:

- the state is a big KV ``cache`` that stays on the device and a small
  per-slot report (``SmallState``), made anew by each step, so that a
  segment's report (``pack_report``: one int32 array) is copied to pinned
  host memory while later segments run;
- the host keeps up to ``pipeline_depth`` segments in flight; a harvester
  thread waits on each report's copy (a CUDA event recorded after it) and
  hands it back; the scheduler blocks only when the pipeline is full;
- a finished slot needs no release: it is skipped by the segments (a row
  is live while active and not finished) and reset by its next insert;
- segments lengthen to ``max_segment_steps`` when the pool is full and
  nothing waits, and stay at ``segment_steps`` otherwise;
- per-slot admission generations keep a stale report from harvesting a
  re-admitted slot.

Two routes, as in JAX. The default one steps every row through
``models/decoder.decoder_step_ragged`` (plain ops: JAX's route calls no
kernel there); ``use_fused`` runs each step as one launch of the ragged
step kernel (B7, ``ops/fused_step.fused_ragged_step``) on merged-head
caches, with the segment ring (``segment_ring``, the default: the fresh K/V
rows of a segment stay in a small ring that B7 attends, and the big cache
takes one masked write-back a segment) and the chunk buckets (a segment
computes only the 16-row chunks covering the highest live slot,
``n_chunks``). Every admission's encode runs the encoder kernels.

How the port differs:

- JAX's segment is one device loop that ends early when no row is live.
  Here a segment is a host loop of launches that reads no device value (an
  early exit would cost a host round trip every step): it runs its ``n``
  steps, and a row that is not live changes nothing, so the results are
  the same. Rows that are not live enter a step at position 0 (and segment
  start 0), in range, and their outputs are never read.
- The fused self caches are ``cfg.max_seq_len`` slots (JAX pads T to 16)
  and the cross K/V are not padded (``decode/fused.py``); ``t_buckets``
  still picks each segment's T bucket, whose ``t_active`` B7 checks and
  otherwise ignores (it reads no slot at or past a row's position).
- Caches are updated in place; the small state is made anew each step.
- Refused with ``NotImplementedError``: ``mesh`` (a sharded pool, ROADMAP
  A8) and ``admission="device"`` (JAX's in-loop ``io_callback``
  admission, A3). JAX's ``MATHOCR_HARVEST_BATCH`` switch (a batched fetch
  of every queued report, an A/B for a tunnelled transport) is dropped:
  the harvester lands one report at a time, JAX's default.

``constrained=True`` decodes every slot under the pushdown mask of
``decode/constrain.py``, on both routes, as JAX's: each slot's grammar
state is a ``con_*`` entry of the cache, reset at its admission; a step's
logits (the default route's ``decoder_step_ragged``, or B7's with
``return_logits=True``, ring on or off) are cut to the tables' vocab,
masked with each row's own position as its step, and their argmax is the
token; rows that are not live advance with EOS, which changes nothing.
The log-probs stay on the raw logits.
"""

from __future__ import annotations

import heapq
import logging
import queue
import threading
import time
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..convert import state_to_torch, to_torch
from ..core.config import EOS_ID, ModelConfig, PAD_ID, SOS_ID
from ..core.device import resolve_device
from ..core.tokenizer import Tokenizer, clean_latex_output
from ..data.preprocess import normalize
from ..models import decoder as decoder_mod
from ..models import model as model_mod
from ..ops.fused_step import (
    build_stacked_full,
    fused_ragged_step,
    fused_ragged_step_plain,
    quantize_stacked,
)
from ..ops.swin_block import with_float32_biases
from . import constrain as constrain_mod
from .api import EMPTY_RESULT_FALLBACK, pick_bucket
from .fused import project_cross_kv_merged

logger = logging.getLogger(__name__)


class ContinuousSegmentError(RuntimeError):
    """A segment report carried a device error, but other reports of the
    same scheduler tick completed requests first: ``partial_results`` holds
    those {request_id: (latex, confidence)}, whose slots were already
    released, so that a serving worker resolves them before it fails the
    rest."""

    def __init__(self, cause: Exception,
                 partial_results: Dict[int, Tuple[str, float]]):
        super().__init__(str(cause))
        self.__cause__ = cause
        self.partial_results = partial_results


class SmallState(NamedTuple):
    """Per-slot bookkeeping, the segment's report: (S,) tensors and the
    (S, T) tokens."""

    prev: torch.Tensor      # int32: the next input token
    pos: torch.Tensor       # int32: the decode step
    active: torch.Tensor    # bool: the slot holds a request
    finished: torch.Tensor  # bool: done, awaiting harvest
    tokens: torch.Tensor    # int32 (S, T)
    lp_sum: torch.Tensor    # float32
    count: torch.Tensor     # int32


class SlotState(NamedTuple):
    """The composite view (for tests and introspection)."""

    prev: torch.Tensor
    pos: torch.Tensor
    active: torch.Tensor
    finished: torch.Tensor
    tokens: torch.Tensor
    lp_sum: torch.Tensor
    count: torch.Tensor
    cache: Dict[str, torch.Tensor]


def _init_small(S: int, T: int, device) -> SmallState:
    i32 = torch.int32
    return SmallState(
        prev=torch.full((S,), SOS_ID, dtype=i32, device=device),
        pos=torch.zeros((S,), dtype=i32, device=device),
        active=torch.zeros((S,), dtype=torch.bool, device=device),
        finished=torch.zeros((S,), dtype=torch.bool, device=device),
        tokens=torch.full((S, T), PAD_ID, dtype=i32, device=device),
        lp_sum=torch.zeros((S,), dtype=torch.float32, device=device),
        count=torch.zeros((S,), dtype=i32, device=device))


_CON = ("con_stack", "con_ptr", "con_mode", "con_needs", "con_sup")


def _constraint_cache_entries(batch: int, device) -> Dict[str, torch.Tensor]:
    """Each slot's pushdown state (``constrain.ConstraintState``) as cache
    entries: reset by an admission, advanced by every step."""
    return dict(zip(_CON, constrain_mod.init_state(batch, device)))


def _reset_constraint_rows(cache: Dict[str, torch.Tensor], slots) -> None:
    """The admitted ``slots``' pushdown state back to its start."""
    if "con_stack" in cache:
        for k in _CON:
            cache[k] = cache[k].index_fill(0, slots, 0)


def _pick(tables, cache, small: "SmallState", logits, max_len: int):
    """A step's token (int32) and log-prob from its float32 logits: the
    argmax and its log(softmax + 1e-10). With ``tables`` the logits are cut
    to the tables' vocab, the argmax is taken under each row's mask (its
    position as the step), and the cache's ``con_*`` state advances, with
    EOS for the rows that are not live; the log-prob stays on the raw
    (cut) logits."""
    sel = logits
    if tables is not None:
        logits = logits[:, :tables.vocab_size]
        cst = constrain_mod.ConstraintState(*(cache[k] for k in _CON))
        sel = logits + constrain_mod.step_mask(tables, cst,
                                               small.pos[:, None], max_len)
    nxt = sel.argmax(dim=-1)
    logp = torch.log(torch.softmax(logits, dim=-1) + 1e-10).gather(
        1, nxt[:, None])[:, 0]
    if tables is not None:
        fed = torch.where(_live(small), nxt, EOS_ID)
        cache.update(zip(_CON, constrain_mod.advance(tables, cst, fed)))
    return nxt.to(torch.int32), logp


def init_slot_state(cfg: ModelConfig, num_slots: int, scratch_slots: int = 1,
                    encoder_len: Optional[int] = None, *, device=None,
                    constrained: bool = False
                    ) -> Tuple[SmallState, Dict[str, torch.Tensor]]:
    """The default route's pool: ``num_slots`` slots and ``scratch_slots``
    scratch slots (the target of an admission's padding rows, never
    active), with per-layer caches ``cross_k_{i}``/``cross_v_{i}``
    (S, H, L_enc, Dh) and ``self_k_{i}``/``self_v_{i}`` (S, Hkv, T, Dh),
    and with ``constrained`` the ``con_*`` pushdown state. ``encoder_len``
    overrides ``cfg.encoder_len``. Returns (small, cache)."""
    S = num_slots + scratch_slots
    T = cfg.max_seq_len
    dtype = model_mod.compute_dtype(cfg)
    L_enc = encoder_len or cfg.encoder_len
    cache = {}
    for i in range(cfg.num_decoder_layers):
        for kv in ("k", "v"):
            cache[f"cross_{kv}_{i}"] = torch.zeros(
                (S, cfg.nhead, L_enc, cfg.head_dim), dtype=dtype,
                device=device)
            cache[f"self_{kv}_{i}"] = torch.zeros(
                (S, cfg.kv_heads, T, cfg.head_dim), dtype=dtype,
                device=device)
    if constrained:
        cache.update(_constraint_cache_entries(S, device))
    return _init_small(S, T, device), cache


def _encode(params, cfg: ModelConfig, images, use_pallas_block: bool,
            model_state=None):
    """(K, H, W, 1) images, or a sequence of K (H, W, 1) ones (uint8 are
    normalized here) -> memory (K, L_enc, D); ``model_state``: a ResNet
    encoder's BatchNorm statistics."""
    if not isinstance(images, torch.Tensor):
        images = torch.stack(list(images))
    if images.dtype == torch.uint8:
        images = normalize(images)
    return model_mod.encode(params, cfg, images.float(),
                            use_pallas_block=use_pallas_block,
                            model_state=model_state)


def _reset_rows(small: SmallState, slots, valid) -> SmallState:
    """Rows ``slots`` (a device tensor) reset for new requests, active where
    ``valid``."""
    return SmallState(
        prev=small.prev.index_fill(0, slots, SOS_ID),
        pos=small.pos.index_fill(0, slots, 0),
        active=small.active.index_put((slots,), valid),
        finished=small.finished.index_fill(0, slots, False),
        tokens=small.tokens.index_fill(0, slots, PAD_ID),
        lp_sum=small.lp_sum.index_fill(0, slots, 0.0),
        count=small.count.index_fill(0, slots, 0))


def insert_requests(params, cfg: ModelConfig, small: SmallState,
                    cache: Dict[str, torch.Tensor], slots, images,
                    num_slots: Optional[int] = None,
                    use_pallas_block: bool = False, model_state=None
                    ) -> Tuple[SmallState, Dict[str, torch.Tensor]]:
    """Encode ``images`` and install them at ``slots`` ((K,) int64 on the
    device): the cross K/V written into the cache in place, the slots'
    small state reset. Rows whose slot is ``num_slots`` or more (a scratch
    slot: an admission's padding) stay inactive. The self caches are not
    cleared: a row attends only slots it has written. ``model_state``: a
    ResNet encoder's BatchNorm statistics."""
    memory = _encode(params, cfg, images, use_pallas_block, model_state)
    cross = decoder_mod.project_cross_kv(params["decoder"], cfg, memory)
    S = small.prev.shape[0]
    for name, val in cross.items():
        cache[name].index_copy_(0, slots, val.to(cache[name].dtype))
    _reset_constraint_rows(cache, slots)
    valid = slots < (num_slots if num_slots is not None else S - 1)
    return _reset_rows(small, slots, valid), cache


def _live(s: SmallState):
    return s.active & ~s.finished


def _write_tokens(s: SmallState, nxt, logp, live, max_len: int
                  ) -> SmallState:
    """One step's bookkeeping for the live rows (nxt (S,) int32, logp
    (S,) float32; other rows' values are ignored, NaN included)."""
    is_eos = nxt == EOS_ID
    lp_sum = s.lp_sum + torch.where(live, logp, 0.0)
    count = s.count + (live & ~is_eos).to(torch.int32)
    at = s.pos.long().clamp(0, s.tokens.shape[1] - 1)[:, None]
    written = s.tokens.scatter(1, at, nxt[:, None])
    tokens = torch.where(live[:, None], written, s.tokens)
    done = live & (is_eos | (s.pos + 1 >= max_len))
    pos = torch.where(live, s.pos + 1, s.pos)
    prev = torch.where(live, torch.where(is_eos, EOS_ID, nxt), s.prev)
    return SmallState(prev=prev, pos=pos, active=s.active,
                      finished=s.finished | done, tokens=tokens,
                      lp_sum=lp_sum, count=count)


def decode_segment(params, cfg: ModelConfig, small: SmallState,
                   cache: Dict[str, torch.Tensor], n_steps: int, *,
                   kernels: bool = True, tables=None
                   ) -> Tuple[SmallState, Dict[str, torch.Tensor]]:
    """Advance every live slot by ``n_steps`` greedy tokens (a slot that
    finishes stops there) on the default route: one
    ``decoder_step_ragged`` a step over the whole pool, its self caches
    updated in place. ``tables`` (``constrain.ConstraintTables``)
    constrains the picks (module docstring). Reads no device value."""
    dec = params["decoder"]
    for _ in range(n_steps):
        live = _live(small)
        logits = decoder_mod.decoder_step_ragged(dec, cfg, small.prev,
                                                 small.pos, cache,
                                                 kernels=kernels)
        nxt, logp = _pick(tables, cache, small, logits, cfg.max_seq_len)
        small = _write_tokens(small, nxt, logp, live, cfg.max_seq_len)
    return small, cache


def init_slot_state_fused(cfg: ModelConfig, pool_size: int,
                          encoder_len: Optional[int] = None, *, device=None,
                          constrained: bool = False
                          ) -> Tuple[SmallState, Dict[str, torch.Tensor]]:
    """The fused route's pool of ``pool_size`` rows (scratch rows included,
    a multiple of the ragged step's ``block_b``) in the merged-head layout:
    self caches ``self_k``/``self_v`` (L, S, T, kvd), cross K/V
    ``cross_k``/``cross_v`` (L, S, L_enc, D), and with ``constrained`` the
    ``con_*`` pushdown state."""
    S, T = pool_size, cfg.max_seq_len
    L = cfg.num_decoder_layers
    dtype = model_mod.compute_dtype(cfg)
    L_enc = encoder_len or cfg.encoder_len
    cache = {
        "self_k": torch.zeros((L, S, T, cfg.kv_dim), dtype=dtype,
                              device=device),
        "self_v": torch.zeros((L, S, T, cfg.kv_dim), dtype=dtype,
                              device=device),
        "cross_k": torch.zeros((L, S, L_enc, cfg.d_model), dtype=dtype,
                               device=device),
        "cross_v": torch.zeros((L, S, L_enc, cfg.d_model), dtype=dtype,
                               device=device),
    }
    if constrained:
        cache.update(_constraint_cache_entries(S, device))
    return _init_small(S, T, device), cache


def insert_requests_fused(params, cfg: ModelConfig, small: SmallState,
                          cache: Dict[str, torch.Tensor], slots, images,
                          num_slots: int, use_pallas_block: bool = False,
                          model_state=None
                          ) -> Tuple[SmallState, Dict[str, torch.Tensor]]:
    """``insert_requests`` for the fused layout: the merged-head cross K/V
    written at ``slots`` (their self-cache rows need no clearing: a
    re-admitted slot attends only slots its own decode rewrites)."""
    memory = _encode(params, cfg, images, use_pallas_block, model_state)
    ck, cv = project_cross_kv_merged(params["decoder"], cfg, memory)
    cache["cross_k"].index_copy_(1, slots, ck.to(cache["cross_k"].dtype))
    cache["cross_v"].index_copy_(1, slots, cv.to(cache["cross_v"].dtype))
    _reset_constraint_rows(cache, slots)
    return _reset_rows(small, slots, slots < num_slots), cache


def decode_segment_fused(stacked, cfg: ModelConfig, small: SmallState,
                         cache: Dict[str, torch.Tensor], n_steps: int, *,
                         block_b: int = 16, n_chunks: Optional[int] = None,
                         ring_s: int = 0, t_active: Optional[int] = None,
                         kernels: bool = True, tables=None
                         ) -> Tuple[SmallState, Dict[str, torch.Tensor]]:
    """``decode_segment`` on the ragged step kernel (B7): the embedding,
    every layer and the head in one launch a step; only the per-slot
    bookkeeping and the fresh rows' cache writes stay outside. ``n_chunks``
    and ``t_active`` go to the kernel (``ops/fused_step``);
    ``kernels=False`` takes its plain version even on CUDA.

    ``ring_s > 0``: the segment ring. The fresh K/V rows of step i go to
    ring row i of a (L, S, ring_s, kvd) ring (zero for a row that is not
    live: the rows past the chunks B7 computed are garbage, NaN included),
    B7 attends them as a second extent, and the cache takes one masked
    write-back at the end (slots [start, end) of each row from its ring
    rows). ``n_steps`` is clamped to ``ring_s``. Without the ring each
    step writes each live row's fresh rows at its position, and a row that
    is not live writes back what its slot 0 holds.

    ``tables`` (``constrain.ConstraintTables``): B7 returns its logits
    (``return_logits=True``), and the token is ``_pick``'s."""
    kernel = fused_ragged_step if kernels else fused_ragged_step_plain

    def step_fn(*args, **kw):
        if tables is None:
            return kernel(*args, **kw)
        logits, k_rows, v_rows = kernel(*args, **kw, return_logits=True)
        return (*_pick(tables, cache, small, logits, cfg.max_seq_len),
                k_rows, v_rows)

    sk, sv = cache["self_k"], cache["self_v"]
    ck, cv = cache["cross_k"], cache["cross_v"]
    L, S, T, kvd = sk.shape
    opts = {"block_b": block_b, "n_chunks": n_chunks, "t_active": t_active}
    zero = torch.zeros((), dtype=sk.dtype, device=sk.device)
    if ring_s:
        seg0 = small.pos
        rk = torch.zeros((L, S, ring_s, kvd), dtype=sk.dtype, device=sk.device)
        rv = torch.zeros_like(rk)
        for i in range(min(n_steps, ring_s)):
            live = _live(small)
            nxt, logp, k_rows, v_rows = step_fn(
                stacked, cfg, small.prev, torch.where(live, small.pos, 0),
                sk, sv, ck, cv, seg_start=torch.where(live, seg0, 0),
                ring_k=rk, ring_v=rv, **opts)
            live3 = live[None, :, None]
            rk[:, :, i] = torch.where(live3, k_rows, zero)
            rv[:, :, i] = torch.where(live3, v_rows, zero)
            small = _write_tokens(small, nxt, logp, live, cfg.max_seq_len)
        # one masked write-back: slot t of row r in [seg0[r], pos[r]) takes
        # ring row t - seg0[r] (a live row advanced one slot a step)
        slot = torch.arange(T, device=sk.device)[None, :]
        j = (slot - seg0[:, None]).clamp(0, ring_s - 1)
        in_seg = ((slot >= seg0[:, None])
                  & (slot < small.pos[:, None]))[None, :, :, None]
        idx = j[None, :, :, None].expand(L, S, T, kvd)
        sk.copy_(torch.where(in_seg, rk.gather(2, idx), sk))
        sv.copy_(torch.where(in_seg, rv.gather(2, idx), sv))
        return small, cache
    for _ in range(n_steps):
        live = _live(small)
        at = torch.where(live, small.pos, 0)
        nxt, logp, k_rows, v_rows = step_fn(stacked, cfg, small.prev, at, sk,
                                            sv, ck, cv, **opts)
        idx = at.long()[None, :, None, None].expand(L, S, 1, kvd)
        live3 = live[None, :, None, None]
        for c, rows in ((sk, k_rows), (sv, v_rows)):
            c.scatter_(2, idx, torch.where(live3, rows[:, :, None],
                                           c.gather(2, idx)))
        small = _write_tokens(small, nxt, logp, live, cfg.max_seq_len)
    return small, cache


def pack_report(s: SmallState) -> torch.Tensor:
    """The segment's harvest report as ONE (S, T + 3) int32 tensor
    (columns: finished, count, lp_sum's bits, tokens), so that the host
    copies one array a segment."""
    return torch.cat([s.finished.to(torch.int32)[:, None], s.count[:, None],
                      s.lp_sum.view(torch.int32)[:, None], s.tokens], dim=1)


def unpack_report(rep: np.ndarray) -> Dict[str, np.ndarray]:
    """The host's inverse of ``pack_report``."""
    return {
        "finished": rep[:, 0].astype(bool),
        "count": rep[:, 1],
        "lp_sum": rep[:, 2].view(np.float32),
        "tokens": rep[:, 3:],
    }


class _InFlight(NamedTuple):
    seg_idx: int                      # the segment this report reflects
    report: torch.Tensor              # packed (S, T + 3) int32, host memory
    ready: Optional[torch.cuda.Event]  # recorded after the copy (CUDA)


class ContinuousDecoder:
    """The pipelined host scheduler around the slot pool. Synchronous: one
    thread owns it (``submit``, ``cancel``, ``step_once``); a serving
    wrapper drives it from an executor."""

    def __init__(self, params, cfg: ModelConfig,
                 tokenizer: Optional[Tokenizer] = None, *,
                 num_slots: int = 32, segment_steps: int = 16,
                 encode_buckets: Tuple[int, ...] = (1, 2, 4, 8, 16, 32),
                 mesh=None, pipeline_depth: int = 4,
                 max_segment_steps: Optional[int] = None,
                 encoder_len: Optional[int] = None, use_fused: bool = False,
                 fused_block_b: int = 16, quantize: bool = False,
                 pallas_encoder_block: bool = False,
                 segment_ring: bool = True,
                 t_buckets: Optional[Tuple[int, ...]] = None,
                 constrained: bool = False, harvest_threads: int = 0,
                 admission: str = "host", model_state=None, device=None):
        """``params``: the model's parameter tree (numpy or tensor leaves,
        as ``DecodeEngine`` takes it), moved to ``device`` (``cuda`` unless
        given; raises without a card). ``pipeline_depth``: segments in
        flight before the host waits for the oldest report.
        ``max_segment_steps``: the segment length when the pool is full and
        nothing waits (4 ``segment_steps`` if not given, at most
        ``cfg.max_seq_len``). ``use_fused``: the fused route (B7), its pool
        padded to a multiple of ``fused_block_b``; MHA and MQA, a GQA config
        warns and takes the default route. ``quantize``: the int8 bundle,
        with ``use_fused`` only (else a warning and float weights, as JAX).
        ``segment_ring``: the fused route's segment ring.
        ``pallas_encoder_block``: the whole Swin block kernel in every
        admission's encode. ``t_buckets``: the fused route's T buckets.
        ``constrained``: every slot under the pushdown mask (module
        docstring); it needs ``tokenizer`` (its vocab derives the tables)
        and raises ``ValueError`` without one. ``harvest_threads``: report
        harvesters (at least one). ``model_state``: a ResNet encoder's
        BatchNorm statistics, moved to ``device`` in float32 (a ResNet
        encoder ignores ``pallas_encoder_block``, as in JAX)."""
        if admission not in ("host", "device"):
            raise ValueError(f"admission must be host|device: {admission}")
        if admission == "device":
            raise NotImplementedError(
                "admission='device' (an in-loop io_callback in JAX) is not "
                "ported: ROADMAP A3")
        if mesh is not None:
            raise NotImplementedError(
                "a sharded slot pool (mesh) is not ported: ROADMAP A8")
        if constrained and tokenizer is None:
            raise ValueError("constrained continuous decoding needs a "
                             "tokenizer (its vocab derives the constraint "
                             "tables)")
        self.device = resolve_device(device)
        self.cfg = cfg
        self.tokenizer = tokenizer
        self.num_slots = num_slots
        self.segment_steps = segment_steps
        self.max_segment_steps = min(
            max_segment_steps or 4 * segment_steps, cfg.max_seq_len)
        self.pipeline_depth = max(1, pipeline_depth)
        self.encode_buckets = tuple(
            b for b in encode_buckets if b <= num_slots) or (num_slots,)
        if use_fused and cfg.kv_heads not in (cfg.nhead, 1):
            logger.warning("fused continuous decode supports MHA and MQA "
                           "(nhead_kv=1); GQA falls back to the default path")
            use_fused = False
        if quantize and not use_fused:
            logger.warning("quantize needs the fused segment kernel "
                           "(in-kernel dequant); serving float weights")
        self.use_fused = use_fused
        self.segment_ring = bool(segment_ring) and use_fused
        self.pallas_encoder_block = pallas_encoder_block
        self.params = to_torch(params, cfg, self.device)
        self.model_state = state_to_torch(model_state, self.device)
        if pallas_encoder_block and cfg.encoder == "swin_t":
            self.params["encoder"] = with_float32_biases(
                params["encoder"], self.params["encoder"])
        self._constraint = (constrain_mod.build_tables(tokenizer.vocab,
                                                       self.device)
                            if constrained else None)
        self._l_enc = encoder_len or cfg.encoder_len
        self._block_b = fused_block_b
        Tmax = cfg.max_seq_len
        self._seg_buckets: Optional[List[int]] = None
        if use_fused:
            # the pool padded to the kernel's chunk multiple
            total = -(-(num_slots + 1) // fused_block_b) * fused_block_b
            self._small, self._cache = init_slot_state_fused(
                cfg, total, encoder_len, device=self.device,
                constrained=constrained)
            self._seg_params = build_stacked_full(params["decoder"], cfg,
                                                  self.device)
            if quantize:  # int8 weights, dequantized in the kernel
                self._seg_params = quantize_stacked(self._seg_params)
            # chunk buckets: powers of two and the whole pool; a segment
            # runs the smallest covering the highest live slot (low slots
            # are taken first)
            nb_full = total // fused_block_b
            buckets, b = [], 1
            while b < nb_full:
                buckets.append(b)
                b *= 2
            self._seg_buckets = sorted(set(buckets + [nb_full]))
            self._t_buckets = sorted(
                {min(b, Tmax) for b in (t_buckets if t_buckets is not None
                                        else (40, 80, 120))} | {Tmax})
        else:
            self._small, self._cache = init_slot_state(
                cfg, num_slots, 1, encoder_len, device=self.device,
                constrained=constrained)
            self._seg_params = self.params
        self._free: List[int] = list(range(num_slots))
        self._slot_req: Dict[int, int] = {}
        self._pos_ub: Dict[int, int] = {}     # slot -> position upper bound
        self._admit_seg: Dict[int, int] = {}  # slot -> first segment index
        self._pending: List[Tuple[int, torch.Tensor]] = []
        self._next_id = 0
        self._pad_img: Dict[tuple, torch.Tensor] = {}
        self._inflight = 0                 # dispatched, not yet processed
        self._fetch_q: "queue.Queue" = queue.Queue()
        self._ready_q: "queue.Queue" = queue.Queue()
        # one thread landing one report at a time (JAX's default); a
        # report that lands out of order is safe: _process_report's
        # admission-generation guard and _stale_before compare segments
        self.harvest_threads = max(1, harvest_threads)
        self._harvesters: List[threading.Thread] = []
        self._seg_counter = 0
        self._stale_before = 0  # reports of segments before this dropped
        self.reset_stats()
        self.cancelled = 0

    # -- public API ---------------------------------------------------------

    def fail_reset(self) -> None:
        """Clear the host's scheduling state after a failed segment, so that
        the decoder returns to idle (the serving worker fails the affected
        requests; later ones start clean). The device state stays usable:
        the next insert resets any slot it takes. Reports of segments
        dispatched before the reset are dropped, results and errors alike,
        when they land (``_inflight`` keeps counting them, so ``idle``
        stays False until they have)."""
        self._pending.clear()
        self._slot_req.clear()
        self._admit_seg.clear()
        self._pos_ub.clear()
        self._free = list(range(self.num_slots))
        self._stale_before = self._seg_counter + 1
        while True:  # already-landed reports: account and drop
            try:
                self._ready_q.get_nowait()
            except queue.Empty:
                break
            self._inflight -= 1

    def reset_stats(self) -> None:
        """Zero the throughput counters and phase timers."""
        self.segments_run = 0
        self.steps_scheduled = 0
        self.tokens_emitted = 0
        self.occupancy_sum = 0.0       # step-weighted slot occupancy
        self.harvest_blocks = 0        # harvests that had to wait
        self.rows_scheduled = 0        # kernel rows computed (bucketed)
        self.t_admit = 0.0
        self.t_admit_upload = 0.0
        self.t_admit_insert = 0.0
        self.t_dispatch = 0.0
        self.t_harvest_wait = 0.0

    @property
    def state(self) -> SlotState:
        """The device state at the dispatch frontier."""
        return SlotState(*self._small, cache=self._cache)

    def submit(self, image: np.ndarray) -> int:
        """Queue one (H, W, 1) image (normalized float, or uint8, which the
        insert normalizes on the device); return its request id. The upload
        starts here, from pinned memory and asynchronously, so that it has
        landed by the time the request is admitted."""
        rid = self._next_id
        self._next_id += 1
        dt = np.uint8 if np.asarray(image).dtype == np.uint8 else np.float32
        img = torch.from_numpy(np.ascontiguousarray(image, dt))
        self._pending.append((rid, self._upload(img)))
        return rid

    def cancel(self, rid: int) -> bool:
        """Abort a request: drop it from the queue or, if it holds a slot,
        clear the slot's ``active`` flag on the device (a device write; no
        host read) so that the next segments stop computing it, and free
        the slot. True if the request was found, False if it had finished
        (its result delivered or in flight). Call it from the scheduler's
        thread."""
        for i, (r, _img) in enumerate(self._pending):
            if r == rid:
                del self._pending[i]
                self.cancelled += 1
                return True
        slot = next((s for s, r in self._slot_req.items() if r == rid), None)
        if slot is None:
            return False
        del self._slot_req[slot]
        self._admit_seg.pop(slot, None)
        self._pos_ub.pop(slot, None)
        heapq.heappush(self._free, slot)
        # a new tensor: reports of dispatched segments keep theirs
        active = self._small.active.clone()
        active[slot] = False
        self._small = self._small._replace(active=active)
        self.cancelled += 1
        return True

    @property
    def idle(self) -> bool:
        return (not self._pending and not self._slot_req
                and self._inflight == 0)

    @torch.no_grad()
    def step_once(self) -> Dict[int, Tuple[str, float]]:
        """One scheduler tick: admit, dispatch one segment (if a slot is
        taken), then take every report the harvester has landed, waiting
        only when the pipeline is full or nothing is left to dispatch.
        Returns the finished {request_id: (latex, confidence)}. Raises
        ``ContinuousSegmentError`` (with the tick's completed results) if a
        report carried a device error."""
        t0 = time.perf_counter()
        self._admit()
        t1 = time.perf_counter()
        self.t_admit += t1 - t0
        if self._slot_req:
            n = self._pick_segment_len()
            nchunks, t_active = None, None
            if self._seg_buckets is not None:
                # the smallest chunk bucket covering the highest live slot
                need = -(-(max(self._slot_req) + 1) // self._block_b)
                nchunks = next(b for b in self._seg_buckets if b >= need)
                # the smallest T bucket covering every slot's position
                # bound (ring mode reads cache slots before its start; the
                # plain path slots up to pos, up to ub + n this segment)
                Tmax = self._t_buckets[-1]
                need_t = max((self._pos_ub.get(s, Tmax)
                              for s in self._slot_req), default=1)
                if not self.segment_ring:
                    need_t += n
                tb = next(b for b in self._t_buckets
                          if b >= min(max(need_t, 1), Tmax))
                t_active = None if tb >= Tmax else tb
                for s in self._slot_req:
                    self._pos_ub[s] = min(self._pos_ub.get(s, 0) + n, Tmax)
                self.rows_scheduled += n * nchunks * self._block_b
            rep = self._segment(n, nchunks, t_active)
            self._seg_counter += 1
            self._ensure_harvester()
            self._inflight += 1
            self._fetch_q.put(self._start_report_copy(self._seg_counter,
                                                      rep))
            self.segments_run += 1
            self.steps_scheduled += n
            self.occupancy_sum += n * len(self._slot_req) / self.num_slots
            self.t_dispatch += time.perf_counter() - t1
        results: Dict[int, Tuple[str, float]] = {}
        err_pending: Optional[Exception] = None

        def take(item) -> None:
            nonlocal err_pending
            seg_idx, rep, err = item
            self._inflight -= 1
            if seg_idx < self._stale_before:
                return  # a segment before fail_reset: drop results and errors
            if err is not None:
                err_pending = err_pending or err
                return  # keep integrating: completed results survive
            results.update(self._process_report(seg_idx, rep))

        while True:  # reports the harvester already landed
            try:
                item = self._ready_q.get_nowait()
            except queue.Empty:
                break
            take(item)
        # forced: the pipeline is full, or nothing is left to dispatch
        while self._inflight > 0 and (self._inflight > self.pipeline_depth
                                      or not self._slot_req):
            self.harvest_blocks += 1
            tw = time.perf_counter()
            item = self._ready_q.get()
            self.t_harvest_wait += time.perf_counter() - tw
            take(item)
        if err_pending is not None:
            raise ContinuousSegmentError(err_pending, results)
        return results

    def run_all(self, images) -> List[Tuple[str, float]]:
        """Submit every image, run to completion, return in order."""
        ids = [self.submit(img) for img in images]
        results: Dict[int, Tuple[str, float]] = {}
        while not self.idle:
            results.update(self.step_once())
        return [results[i] for i in ids]

    @property
    def stats(self) -> dict:
        total_steps = self.steps_scheduled or 1
        return {
            "mesh": None,
            "segments_run": self.segments_run,
            "avg_occupancy": (self.occupancy_sum / total_steps
                              if self.segments_run else 0.0),
            "work_occupancy": (self.tokens_emitted
                               / (self.num_slots * total_steps)
                               if self.segments_run else 0.0),
            "pipeline_depth": self.pipeline_depth,
            "harvest_threads": self.harvest_threads,
            "in_flight": self._inflight,
            "harvest_blocks": self.harvest_blocks,
            "rows_scheduled": self.rows_scheduled,
            "active_slots": len(self._slot_req),
            "pending": len(self._pending),
            "cancelled": self.cancelled,
            "t_admit_s": round(self.t_admit, 3),
            "t_admit_upload_s": round(self.t_admit_upload, 3),
            "t_admit_insert_s": round(self.t_admit_insert, 3),
            "t_dispatch_s": round(self.t_dispatch, 3),
            "t_harvest_wait_s": round(self.t_harvest_wait, 3),
        }

    @torch.no_grad()
    def warmup(self, image_shape: Optional[Tuple[int, int]] = None,
               image_dtype=np.float32) -> None:
        """Run every insert bucket and the segments once (the kernel build,
        the allocator's growth), safe on live state: the inserts target the
        scratch slot only. The port's chunk buckets are its only segment
        variants (JAX also compiles each T bucket, which the port's kernel
        ignores): each one covering every live slot runs one segment of
        ``segment_steps``, which really advances the live slots, so their
        position bounds move with it."""
        h, w = image_shape or (self.cfg.img_h, self.cfg.img_w)
        pad = self._pad_image(h, w, torch.from_numpy(
            np.zeros((), image_dtype)).dtype)
        scratch = self.num_slots
        for b in self.encode_buckets:
            slots = self._upload(torch.full((b,), scratch, dtype=torch.long))
            self._small, self._cache = self._insert(slots, [pad] * b)
        need = -(-(max(self._slot_req, default=-1) + 1) // self._block_b)
        executed = 0
        for nc in self._seg_buckets or [None]:
            if nc is not None and nc < need:
                continue  # would leave live rows uncomputed
            self._segment(self.segment_steps, nc, None)
            executed += 1
        if self._seg_buckets is not None:
            Tmax = self.cfg.max_seq_len
            for s in self._slot_req:
                self._pos_ub[s] = min(self._pos_ub.get(s, Tmax)
                                      + executed * self.segment_steps, Tmax)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def close(self) -> None:
        """Stop the harvester threads (idempotent; they are daemons)."""
        live = [t for t in self._harvesters if t.is_alive()]
        for _ in live:
            self._fetch_q.put(None)
        for t in live:
            t.join(timeout=5)
        self._harvesters = []

    # -- internals ----------------------------------------------------------

    def _pick_segment_len(self) -> int:
        """Short segments while an admission can come soon (queued work, or
        a free slot an arrival could take); long ones when the pool is full
        and nothing waits."""
        if self._pending or self._free:
            return self.segment_steps
        return self.max_segment_steps

    def _upload(self, t: torch.Tensor) -> torch.Tensor:
        """A host tensor on the device: from pinned memory, asynchronously,
        on CUDA."""
        if self.device.type != "cuda":
            return t.to(self.device)
        return t.pin_memory().to(self.device, non_blocking=True)

    def _segment(self, n: int, nchunks: Optional[int],
                 t_active: Optional[int]) -> torch.Tensor:
        """Dispatch one segment of ``n`` steps; return its packed report
        (on the device)."""
        if self.use_fused:
            self._small, self._cache = decode_segment_fused(
                self._seg_params, self.cfg, self._small, self._cache, n,
                block_b=self._block_b, n_chunks=nchunks,
                ring_s=self.max_segment_steps if self.segment_ring else 0,
                t_active=t_active, tables=self._constraint)
        else:
            self._small, self._cache = decode_segment(
                self._seg_params, self.cfg, self._small, self._cache, n,
                tables=self._constraint)
        return pack_report(self._small)

    @staticmethod
    def _start_report_copy(seg_idx: int, rep: torch.Tensor) -> _InFlight:
        """The report's copy to pinned host memory, queued on the stream
        behind the segment, and an event recorded after it."""
        if rep.device.type != "cuda":
            return _InFlight(seg_idx, rep, None)
        host = torch.empty(rep.shape, dtype=rep.dtype, pin_memory=True)
        host.copy_(rep, non_blocking=True)
        ready = torch.cuda.Event()
        ready.record(torch.cuda.current_stream(rep.device))
        return _InFlight(seg_idx, host, ready)

    @staticmethod
    def _land(item: _InFlight) -> Dict[str, np.ndarray]:
        """Wait for a report's copy; return it unpacked."""
        if item.ready is not None:
            item.ready.synchronize()
        return unpack_report(item.report.numpy())

    def _insert(self, slots, imgs):
        if self.use_fused:
            return insert_requests_fused(
                self.params, self.cfg, self._small, self._cache, slots, imgs,
                self.num_slots, self.pallas_encoder_block, self.model_state)
        return insert_requests(self.params, self.cfg, self._small,
                               self._cache, slots, imgs, self.num_slots,
                               self.pallas_encoder_block, self.model_state)

    def _pad_image(self, h: int, w: int, dtype: torch.dtype) -> torch.Tensor:
        """A zero image on the device, the padding of an admission."""
        pad = self._pad_img.get((h, w, dtype))
        if pad is None:
            pad = torch.zeros((h, w, 1), dtype=dtype, device=self.device)
            self._pad_img[(h, w, dtype)] = pad
        return pad

    def _admit(self) -> None:
        n = min(len(self._pending), len(self._free))
        if n == 0:
            return
        bucket = pick_bucket(n, self.encode_buckets)
        n = min(n, bucket)
        batch = self._pending[:n]
        self._pending = self._pending[n:]
        # lowest slots first: the chunk buckets compute only the chunks up
        # to the highest live slot, so packing requests low keeps a
        # partly full pool cheap
        slots = [heapq.heappop(self._free) for _ in range(n)]
        slot_arr = torch.full((bucket,), self.num_slots, dtype=torch.long)
        slot_arr[:n] = torch.tensor(slots, dtype=torch.long)
        h, w = batch[0][1].shape[:2]
        imgs = ([img for _, img in batch]
                + [self._pad_image(int(h), int(w), batch[0][1].dtype)]
                * (bucket - n))
        tu = time.perf_counter()
        slot_dev = self._upload(slot_arr)
        self.t_admit_upload += time.perf_counter() - tu
        ti = time.perf_counter()
        self._small, self._cache = self._insert(slot_dev, imgs)
        self.t_admit_insert += time.perf_counter() - ti
        for slot, (rid, _) in zip(slots, batch):
            self._slot_req[slot] = rid
            self._pos_ub[slot] = 0
            # from the NEXT segment on: earlier reports must not harvest it
            self._admit_seg[slot] = self._seg_counter + 1

    def _ensure_harvester(self) -> None:
        self._harvesters = [t for t in self._harvesters if t.is_alive()]
        while len(self._harvesters) < self.harvest_threads:
            t = threading.Thread(
                target=self._harvest_loop, daemon=True,
                name=f"continuous-harvester-{len(self._harvesters)}")
            t.start()
            self._harvesters.append(t)

    def _harvest_loop(self) -> None:
        """The harvester: lands one report at a time, in dispatch order."""
        while True:
            item = self._fetch_q.get()
            if item is None:
                return
            try:
                self._ready_q.put((item.seg_idx, self._land(item), None))
            except Exception as e:  # a device fault surfaces here
                self._ready_q.put((item.seg_idx, None, e))

    def _process_report(self, seg_idx: int, rep: Dict[str, np.ndarray]
                        ) -> Dict[int, Tuple[str, float]]:
        finished = rep["finished"]
        done_slots = [s for s in list(self._slot_req)
                      if finished[s] and self._admit_seg.get(s, 0) <= seg_idx]
        if not done_slots:
            return {}
        tokens, lp, counts = rep["tokens"], rep["lp_sum"], rep["count"]
        results: Dict[int, Tuple[str, float]] = {}
        for s in done_slots:
            rid = self._slot_req.pop(s)
            self._admit_seg.pop(s, None)
            self._pos_ub.pop(s, None)
            self.tokens_emitted += int(counts[s])
            if counts[s] == 0:
                results[rid] = (EMPTY_RESULT_FALLBACK, 0.0)
            else:
                conf = float(np.exp(lp[s] / counts[s]))
                latex = clean_latex_output(self.tokenizer.decode(tokens[s]))
                results[rid] = (latex, conf)
            # no release on the device: the slot stays (active, finished),
            # skipped by the segments, until its next insert resets it
            heapq.heappush(self._free, s)
        return results
