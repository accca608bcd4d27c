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
- JAX's ``MATHOCR_HARVEST_BATCH`` switch (a batched fetch of every queued
  report, an A/B for a tunnelled transport) is dropped: the harvester
  lands one report at a time, JAX's default.

``mesh`` (``parallel/mesh.make_mesh``) shards the pool's rows over the
mesh's data axis, as JAX's does, under the one host scheduler. The pool
has ``ceil((num_slots + 1) / n) * n`` rows on ``n`` shards, and on the
fused route ``ceil((num_slots + 1) / (n * block_b)) * n * block_b``, so
that each shard's rows are a multiple of ``block_b``. Slot ``s`` lives on
shard ``s // rows`` (``rows`` a shard) at local row ``s % rows``; slots
are still chosen lowest first. Each shard holds its rows of the state and
the caches and its replica of the trees on its device; an admission
encodes each shard's requests on that shard's device (padded to the
shard's own encode bucket; the padding rows are encoded and dropped), so
cross K/V never cross devices. A segment launches the default route's
steps, or B7 with its ring, once a shard on the shard's rows, from one
host thread (a segment reads no device value) and with no collective, as
JAX's ``shard_map``; the chunk and T buckets are off, as in JAX (live
slots spread over the shards). The shards' reports land in one pinned
record. ``admission="device"`` with a mesh raises ``ValueError``, as
JAX's does.

``admission="device"`` (JAX's in-loop ``io_callback`` pull) on the default
route, as in JAX (``use_fused`` warns and takes it): the host stages each
request (a batch-1 encode on the encoder kernels and its cross K/V
projection, on a side stream on the card) into a row of a staging pool,
and once that copy has finished publishes an entry (pool row, slot,
sequence number) to a mailbox in mapped pinned host memory
(``ops/admission.Mailbox``; a publisher thread waits on the copy's event).
At the head of every step of a segment the pull kernel
(``ops/admission.admission_pull``) takes at most one published entry and
installs it into its slot, in place in the step's state. So a request
staged while segments are already queued joins the first of them that runs
after its publication, where host admission waits for the next dispatch.
The slot is the request's from its staging on (``_admit_seg`` holds the
``_NOT_PULLED`` sentinel until a report shows the pull's record: the
segment that took the entry); a cancel marks the entry skipped and
deactivates the slot on the device only while that entry occupies it (a
per-slot occupant written by the pull), so that a slot re-staged while
segments run keeps its new request. On the CPU the pull is the plain
install, synchronously, and staging publishes at once.

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

import dataclasses
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
from ..ops.admission import Mailbox, PullState, admission_pull
from ..ops.fused_step import (
    build_stacked_full,
    fused_ragged_step,
    fused_ragged_step_plain,
    quantize_stacked,
)
from ..ops.swin_block import with_float32_biases
from ..parallel import mesh as mesh_lib
from . import constrain as constrain_mod
from .api import EMPTY_RESULT_FALLBACK, pick_bucket
from .fused import project_cross_kv_merged

logger = logging.getLogger(__name__)

# device admission: a slot staged but not yet pulled by a running segment
_NOT_PULLED = 10 ** 18


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
    """Encode ``images`` and install the first K at ``slots`` ((K,) int64
    on the device; the images past them are padding, encoded and dropped):
    the cross K/V written into the cache in place, the slots' small state
    reset. Rows whose slot is ``num_slots`` or more (a scratch slot) stay
    inactive. The self caches are not cleared: a row attends only slots it
    has written. ``model_state``: a ResNet encoder's BatchNorm
    statistics."""
    memory = _encode(params, cfg, images, use_pallas_block,
                     model_state)[:slots.shape[0]]
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
                   kernels: bool = True, tables=None, pull=None
                   ) -> Tuple[SmallState, Dict[str, torch.Tensor]]:
    """Advance every live slot by ``n_steps`` greedy tokens (a slot that
    finishes stops there) on the default route: one
    ``decoder_step_ragged`` a step over the whole pool, its self caches
    updated in place. ``tables`` (``constrain.ConstraintTables``)
    constrains the picks (module docstring). ``pull(i, small, cache)``
    runs at the head of step ``i`` (device admission: it may install a
    staged request in place). Reads no device value."""
    dec = params["decoder"]
    for i in range(n_steps):
        if pull is not None:
            pull(i, small, cache)
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
    memory = _encode(params, cfg, images, use_pallas_block,
                     model_state)[:slots.shape[0]]
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
    ready: tuple                      # events after each shard's copy (CUDA)


@dataclasses.dataclass
class _Shard:
    """One data shard of the pool: slots ``lo`` to ``lo + rows - 1`` (the
    first ``real`` of them slots, the rest scratch rows), on ``device``
    with its replicas of the trees and its rows of the state."""

    device: torch.device
    lo: int
    rows: int
    real: int
    params: dict
    model_state: dict
    seg_params: dict
    tables: object
    small: SmallState
    cache: Dict[str, torch.Tensor]


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
        harvesters (at least one). ``admission``: ``"host"`` (inserts at
        segment boundaries) or ``"device"`` (the mailbox pull, module
        docstring; the default route). ``model_state``: a ResNet encoder's
        BatchNorm statistics, moved to ``device`` in float32 (a ResNet
        encoder ignores ``pallas_encoder_block``, as in JAX). ``mesh``: a
        ``parallel/mesh.Mesh`` whose data axis shards the pool (module
        docstring); its first data device takes the place of ``device``;
        host admission only."""
        if admission not in ("host", "device"):
            raise ValueError(f"admission must be host|device: {admission}")
        if mesh is not None:
            if admission == "device":
                raise ValueError("admission='device' does not compose with "
                                 "a sharded slot pool; use the host "
                                 "admission path on meshes")
            if not isinstance(mesh, mesh_lib.Mesh):
                raise TypeError(f"mesh must be a parallel.mesh.Mesh, not "
                                f"{type(mesh).__name__}")
            for dev in mesh.data_devices:
                resolve_device(dev)
            device = mesh.data_devices[0]
        if admission == "device" and use_fused:
            logger.warning("device admission pulls into the default "
                           "segment route, as JAX's (its io_callback runs "
                           "outside the fused kernel); disabling fused "
                           "decode")
            use_fused = False
        if constrained and tokenizer is None:
            raise ValueError("constrained continuous decoding needs a "
                             "tokenizer (its vocab derives the constraint "
                             "tables)")
        self.device = resolve_device(device)
        self.mesh = mesh
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
        self.admission = admission
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
        # the pool: one scratch row at least, padded to the shards (and on
        # the fused route to the kernel's chunk multiple on every shard)
        n = mesh.shape["data"] if mesh is not None else 1
        m = n * (fused_block_b if use_fused else 1)
        total = -(-(num_slots + 1) // m) * m
        self._rows = total // n
        stacked = None
        if use_fused:
            stacked = build_stacked_full(params["decoder"], cfg, self.device)
            if quantize:  # int8 weights, dequantized in the kernel
                stacked = quantize_stacked(stacked)
        trees = (self.params, self.model_state, stacked, self._constraint)
        replicas = (mesh_lib.replicate(trees, mesh) if mesh is not None
                    else [trees])
        devices = mesh.data_devices if mesh is not None else [self.device]
        self._shards: List[_Shard] = []
        for i, (dev, (p, ms, st, tables)) in enumerate(zip(devices,
                                                            replicas)):
            lo = i * self._rows
            small, cache = (
                init_slot_state_fused(cfg, self._rows, encoder_len,
                                      device=dev, constrained=constrained)
                if use_fused else
                init_slot_state(cfg, self._rows, 0, encoder_len, device=dev,
                                constrained=constrained))
            self._shards.append(_Shard(
                dev, lo, self._rows, min(max(num_slots - lo, 0), self._rows),
                p, ms, st if use_fused else p, tables, small, cache))
        if use_fused and mesh is None:
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
        if admission == "device":
            self._init_device_admission()
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
        self.pulled_early = 0  # pulled by a segment dispatched before staging

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
        if self.admission == "device":
            # staged entries are skipped by the pulls that have not taken
            # them; one a running segment took decodes into a free slot
            # until it finishes or the slot's next entry resets it
            for seq in self._slot_entry.values():
                self._mailbox.cancel(seq)
                if seq in self._pool_busy:
                    self._cancelled_entries.add(seq)
            self._slot_entry.clear()
            self._staged.clear()
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
        """The device state at the dispatch frontier (on a mesh, the
        shards' rows concatenated on the first device)."""
        if self.mesh is None:
            sh = self._shards[0]
            return SlotState(*sh.small, cache=sh.cache)

        def cat(tensors, dim=0):
            return torch.cat([t.to(self.device) for t in tensors], dim=dim)

        sh = self._shards
        cache = {k: cat([x.cache[k] for x in sh],
                        1 if self.use_fused and not k.startswith("con_")
                        else 0)
                 for k in sh[0].cache}
        return SlotState(*(cat(f) for f in zip(*(x.small for x in sh))),
                         cache=cache)

    def _shard_of(self, slot: int) -> _Shard:
        return self._shards[slot // self._rows]

    def submit(self, image: np.ndarray) -> int:
        """Queue one (H, W, 1) image (normalized float, or uint8, which the
        insert normalizes on the device); return its request id. The upload
        starts here, from pinned memory and asynchronously, so that it has
        landed by the time the request is admitted (on a mesh, where the
        slot's device is not known yet, at the admission)."""
        rid = self._next_id
        self._next_id += 1
        dt = np.uint8 if np.asarray(image).dtype == np.uint8 else np.float32
        img = torch.from_numpy(np.ascontiguousarray(image, dt))
        if self.admission == "device" or self.mesh is not None:
            # uploaded by its staging, on the staging stream, or by its
            # admission, to the device of its slot's shard
            if self.device.type == "cuda":
                img = img.pin_memory()
            self._pending.append((rid, img))
        else:
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
        if self.admission == "device":
            # the entry is skipped if no pull has taken it yet; the slot
            # is deactivated only while this entry occupies it (a pull of
            # the slot's next entry may come first on the stream)
            seq = self._slot_entry.pop(slot)
            self._staged.pop(seq, None)
            self._mailbox.cancel(seq)
            if seq in self._pool_busy:
                self._cancelled_entries.add(seq)
            sh = self._shards[0]   # device admission: one shard
            kill = torch.zeros(sh.small.active.shape, dtype=torch.bool)
            kill[slot] = True
            kill = self._upload(kill) & (self._occupant == seq)
            sh.small = sh.small._replace(active=sh.small.active & ~kill)
        else:
            # a new tensor: reports of dispatched segments keep theirs
            sh = self._shard_of(slot)
            active = sh.small.active.clone()
            active[slot - sh.lo] = False
            sh.small = sh.small._replace(active=active)
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
            elif self.use_fused:  # a mesh: every shard's rows
                self.rows_scheduled += n * self._rows * len(self._shards)
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
            "mesh": dict(self.mesh.shape) if self.mesh is not None else None,
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
            "staged": (len(self._staged) if self.admission == "device"
                       else 0),
            "pulled_early": self.pulled_early,
        }

    @torch.no_grad()
    def warmup(self, image_shape: Optional[Tuple[int, int]] = None,
               image_dtype=np.float32) -> None:
        """Run every insert bucket and the segments once (the kernel build,
        the allocator's growth), safe on live state: each shard's insert
        encodes a bucket of zero images and installs none of them. The
        port's chunk buckets are its only segment
        variants (JAX also compiles each T bucket, which the port's kernel
        ignores): each one covering every live slot runs one segment of
        ``segment_steps``, which really advances the live slots, so their
        position bounds move with it."""
        h, w = image_shape or (self.cfg.img_h, self.cfg.img_w)
        if self.admission == "device":
            self._warmup_device(h, w, image_dtype)
            return
        dtype = torch.from_numpy(np.zeros((), image_dtype)).dtype
        for sh in self._shards:  # encodes whose rows are all dropped
            pad = self._pad_image(sh.device, h, w, dtype)
            none = self._upload(torch.zeros((0,), dtype=torch.long),
                                sh.device)
            for b in self.encode_buckets:
                self._insert(sh, none, [pad] * b)
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
        for sh in self._shards:
            if sh.device.type == "cuda":
                torch.cuda.synchronize(sh.device)

    def close(self) -> None:
        """Stop the harvester threads and the publisher (idempotent; they
        are daemons)."""
        live = [t for t in self._harvesters if t.is_alive()]
        for _ in live:
            self._fetch_q.put(None)
        for t in live:
            t.join(timeout=5)
        self._harvesters = []
        publisher = getattr(self, "_publisher", None)
        if publisher is not None and publisher.is_alive():
            self._publish_q.put(None)
            publisher.join(timeout=5)
        self._publisher = None

    # -- internals ----------------------------------------------------------

    def _pick_segment_len(self) -> int:
        """Short segments while an admission can come soon (queued work, or
        a free slot an arrival could take); long ones when the pool is full
        and nothing waits."""
        if self._pending or self._free:
            return self.segment_steps
        return self.max_segment_steps

    def _upload(self, t: torch.Tensor, device=None) -> torch.Tensor:
        """A host tensor on ``device`` (the first device if not given):
        from pinned memory, asynchronously, on CUDA."""
        device = device or self.device
        if device.type != "cuda":
            return t.to(device)
        return t.pin_memory().to(device, non_blocking=True)

    def _segment(self, n: int, nchunks: Optional[int],
                 t_active: Optional[int]) -> List[torch.Tensor]:
        """Dispatch one segment of ``n`` steps on every shard; return the
        shards' packed reports (on their devices)."""
        reports = []
        for sh in self._shards:
            with mesh_lib.device_scope(sh.device):
                if self.use_fused:
                    sh.small, sh.cache = decode_segment_fused(
                        sh.seg_params, self.cfg, sh.small, sh.cache, n,
                        block_b=self._block_b, n_chunks=nchunks,
                        ring_s=(self.max_segment_steps if self.segment_ring
                                else 0),
                        t_active=t_active, tables=sh.tables)
                else:
                    self._dispatch_seg = self._seg_counter + 1
                    sh.small, sh.cache = decode_segment(
                        sh.seg_params, self.cfg, sh.small, sh.cache, n,
                        tables=sh.tables,
                        pull=self._pull if self.admission == "device"
                        else None)
                reports.append(pack_report(sh.small))
        return reports

    @staticmethod
    def _start_report_copy(seg_idx: int,
                           reports: List[torch.Tensor]) -> _InFlight:
        """The shards' reports copied, in slot order, into one pinned host
        record, each copy queued on its device's stream behind the segment
        with an event recorded after it."""
        if reports[0].device.type != "cuda":
            return _InFlight(seg_idx, torch.cat(reports), ())
        rows = sum(r.shape[0] for r in reports)
        host = torch.empty((rows,) + tuple(reports[0].shape[1:]),
                           dtype=reports[0].dtype, pin_memory=True)
        ready, lo = [], 0
        for rep in reports:
            host[lo:lo + rep.shape[0]].copy_(rep, non_blocking=True)
            lo += rep.shape[0]
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(rep.device))
            ready.append(event)
        return _InFlight(seg_idx, host, tuple(ready))

    @staticmethod
    def _land(item: _InFlight) -> Dict[str, np.ndarray]:
        """Wait for a report's copies; return it unpacked."""
        for event in item.ready:
            event.synchronize()
        return unpack_report(item.report.numpy())

    def _insert(self, sh: _Shard, slots, imgs) -> None:
        """Install ``imgs`` at ``sh``'s local rows ``slots`` (the images
        past them are padding), on ``sh``'s device."""
        fn = insert_requests_fused if self.use_fused else insert_requests
        with mesh_lib.device_scope(sh.device):
            sh.small, sh.cache = fn(sh.params, self.cfg, sh.small, sh.cache,
                                    slots, imgs, sh.real,
                                    self.pallas_encoder_block,
                                    sh.model_state)

    def _pad_image(self, device, h: int, w: int,
                   dtype: torch.dtype) -> torch.Tensor:
        """A zero image on ``device``, the padding of an admission."""
        key = (str(device), h, w, dtype)
        pad = self._pad_img.get(key)
        if pad is None:
            pad = torch.zeros((h, w, 1), dtype=dtype, device=device)
            self._pad_img[key] = pad
        return pad

    def _admit(self) -> None:
        if self.admission == "device":
            self._stage_pending()
            return
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
        h, w = (int(d) for d in batch[0][1].shape[:2])
        by_shard: Dict[int, List[int]] = {}
        for i, slot in enumerate(slots):
            by_shard.setdefault(slot // self._rows, []).append(i)
        for k, items in by_shard.items():
            sh = self._shards[k]
            # each shard's requests at its own encode bucket
            pad = pick_bucket(len(items), self.encode_buckets) - len(items)
            imgs = ([batch[i][1].to(sh.device, non_blocking=True)
                     for i in items]
                    + [self._pad_image(sh.device, h, w, batch[0][1].dtype)]
                    * pad)
            tu = time.perf_counter()
            slot_dev = self._upload(torch.tensor(
                [slots[i] - sh.lo for i in items], dtype=torch.long),
                sh.device)
            self.t_admit_upload += time.perf_counter() - tu
            ti = time.perf_counter()
            self._insert(sh, slot_dev, imgs)
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
        if self.admission == "device":
            self._resolve_pulls()
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
            if self.admission == "device":
                self._slot_entry.pop(s, None)
            # no release on the device: the slot stays (active, finished),
            # skipped by the segments, until its next insert resets it
            heapq.heappush(self._free, s)
        return results

    # -- device admission -----------------------------------------------------

    def _init_device_admission(self) -> None:
        """The default route's cross K/V as views of one (L, S, H, L_enc,
        Dh) tensor a side, the staging pool (two rows a slot), the mailbox,
        the slots' occupants and the staging stream."""
        cfg, dev = self.cfg, self.device
        cache = self._shards[0].cache   # device admission: one shard
        L = cfg.num_decoder_layers
        row = tuple(cache["cross_k_0"].shape)   # (S, H, L_enc, Dh)
        dtype = cache["cross_k_0"].dtype
        self._cross_all = tuple(torch.zeros((L,) + row, dtype=dtype,
                                            device=dev) for _ in range(2))
        for i in range(L):
            cache[f"cross_k_{i}"] = self._cross_all[0][i]
            cache[f"cross_v_{i}"] = self._cross_all[1][i]
        pool_rows = 2 * self.num_slots
        self._pool = tuple(torch.zeros((pool_rows, L) + row[1:],
                                       dtype=dtype, device=dev)
                           for _ in range(2))
        self._pool_free: List[int] = list(range(pool_rows))
        self._pool_busy: Dict[int, int] = {}   # seq -> pool row
        self._cancelled_entries: set = set()   # of _pool_busy's seqs
        self._mailbox = Mailbox(max(64, 4 * pool_rows), dev)
        self._occupant = torch.zeros((row[0],), dtype=torch.int64,
                                     device=dev)
        self._staged: Dict[int, Tuple[int, int, int]] = {}
        self._slot_entry: Dict[int, int] = {}  # slot -> its entry's seq
        self._stage_stream = (torch.cuda.Stream(dev)
                              if dev.type == "cuda" else None)
        self._publish_q: "queue.Queue" = queue.Queue()
        self._publisher: Optional[threading.Thread] = None
        self._dispatch_seg = 0

    def _stage(self, img: torch.Tensor, row: int):
        """Encode one (H, W, 1) host image (batch 1) and write its cross K/V
        into pool row ``row``; on the card on the staging stream, returning
        an event recorded after the copy (None on the host)."""
        cfg = self.cfg

        def run():
            x = img.to(self.device, non_blocking=True)
            memory = _encode(self.params, cfg, x[None],
                             self.pallas_encoder_block, self.model_state)
            cross = decoder_mod.project_cross_kv(self.params["decoder"], cfg,
                                                 memory)
            for i in range(cfg.num_decoder_layers):
                self._pool[0][row, i].copy_(cross[f"cross_k_{i}"][0])
                self._pool[1][row, i].copy_(cross[f"cross_v_{i}"][0])

        if self._stage_stream is None:
            run()
            return None
        with torch.cuda.stream(self._stage_stream):
            run()
            done = torch.cuda.Event()
            done.record(self._stage_stream)
        return done

    def _reclaim_pool(self) -> None:
        """Pool rows whose entry a pull has taken or skipped are free, and
        so are those of cancelled entries once no dispatched segment is
        outstanding: every later pull reads the cancel mark before the row.
        (Otherwise cancelled entries that no pull reached would hold their
        rows while no slot is live, and no segment runs to skip them.)"""
        quiet = self._inflight == 0
        for seq, row in list(self._pool_busy.items()):
            if self._mailbox.consumed(seq) or (
                    quiet and seq in self._cancelled_entries):
                del self._pool_busy[seq]
                self._cancelled_entries.discard(seq)
                self._pool_free.append(row)

    def _stage_pending(self) -> None:
        """Stage every pending request that has a free slot and pool row:
        the slot is the request's now (so that no report misattributes
        it), its device row changes when a pull takes the entry. The
        entry's sequence number is reserved after its staging: a staging
        that raises leaves the request queued and no unpublished number
        for the pulls, which read the numbers in order, to wait on."""
        self._reclaim_pool()
        while (self._pending and self._free and self._pool_free
               and not self._mailbox.full()):
            row = self._pool_free[-1]
            ti = time.perf_counter()
            done = self._stage(self._pending[0][1], row)
            self.t_admit_insert += time.perf_counter() - ti
            seq = self._mailbox.reserve()
            rid, _img = self._pending.pop(0)
            slot = heapq.heappop(self._free)
            self._pool_free.pop()
            self._slot_req[slot] = rid
            self._pos_ub[slot] = 0
            self._admit_seg[slot] = _NOT_PULLED
            self._slot_entry[slot] = seq
            self._pool_busy[seq] = row
            self._staged[seq] = (rid, slot, self._seg_counter)
            if done is None:
                self._mailbox.publish(seq, row, slot)
            else:
                self._ensure_publisher()
                self._publish_q.put((seq, row, slot, done))

    def _ensure_publisher(self) -> None:
        if self._publisher is None or not self._publisher.is_alive():
            self._publisher = threading.Thread(
                target=self._publish_loop, daemon=True,
                name="continuous-publisher")
            self._publisher.start()

    def _publish_loop(self) -> None:
        """Publish staged entries in sequence order, each once its staging
        copy has finished."""
        while True:
            item = self._publish_q.get()
            if item is None:
                return
            seq, row, slot, done = item
            done.synchronize()
            self._mailbox.publish(seq, row, slot)

    def _pull(self, step: int, small: SmallState,
              cache: Dict[str, torch.Tensor], max_scan=None) -> None:
        """One pull at the head of ``step`` of the segment being
        dispatched, into the step's own state tensors."""
        con = (tuple(cache[k] for k in _CON)
               if self._constraint is not None else None)
        admission_pull(self._mailbox, *self._pool, *self._cross_all,
                       PullState(*small, con, self._occupant),
                       seg=self._dispatch_seg, step=step, max_scan=max_scan)

    def _resolve_pulls(self) -> None:
        """Read the pulls' records of the staged slots: a slot whose entry a
        segment took is harvested from that segment's report on."""
        for slot, seq in list(self._slot_entry.items()):
            if self._admit_seg.get(slot) != _NOT_PULLED:
                continue
            taken = self._mailbox.taken(seq)
            if taken is None:
                continue
            self._admit_seg[slot] = taken[0]
            _rid, _slot, staged_at = self._staged.pop(seq)
            if taken[0] <= staged_at:
                self.pulled_early += 1

    def _warmup_device(self, h: int, w: int, image_dtype) -> None:
        """Device admission's warmup: one staging of a zero image into a
        free pool row (the encoder kernels' build, the allocator), left
        unpublished, and one pull launch that reads no entry."""
        pad = torch.zeros((h, w, 1), dtype=torch.from_numpy(
            np.zeros((), image_dtype)).dtype)
        self._reclaim_pool()
        if self._pool_free:
            done = self._stage(pad, self._pool_free[-1])
            if done is not None:
                done.synchronize()
        self._pull(0, self._shards[0].small, self._shards[0].cache,
                   max_scan=0)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
