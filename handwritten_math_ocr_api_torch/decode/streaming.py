"""Segmented greedy decode for token streaming.

Port of ``handwritten_math_ocr_api_tpu/decode/streaming.py``. The decode
advances in SEGMENTS of exactly ``segment_steps`` KV-cached decoder steps
(``models/decoder.decoder_step``: the cache-append attention kernel in
every layer), and the host takes each segment's fresh tokens when it
ends. The cache and the loop state stay on the device between segments,
and a segment reads no device value: the host reads once a segment
(``stream_report``: the tokens, the finished flags, the counts and the
log-prob sums in one int32 tensor), not once a token.

The tokens and confidences are greedy's (``decode/greedy.py``), with
JAX's accounting. The cache holds whole segments (its capacity is
``max_len`` rounded up to a multiple of ``segment_steps``), so the last
segment can step past ``max_len`` (to 150 and 151 at a ``max_len`` of 150
and segments of 8); ``decoder_step`` clamps those positions into the
positional table, as JAX's gather clamps them, and a row still live there
keeps counting, as in JAX: a row that never emits EOS streams a
confidence averaged over the capacity's steps.
"""

from __future__ import annotations

from typing import Dict, NamedTuple

import torch

from ..core.config import EOS_ID, ModelConfig, PAD_ID, SOS_ID
from ..models import decoder as decoder_mod


class StreamCarry(NamedTuple):
    step: int                       # the absolute decode position
    prev: torch.Tensor              # (B,) int64: the next step's input
    finished: torch.Tensor          # (B,) bool
    lp_sum: torch.Tensor            # (B,) float32, eos step included
    count: torch.Tensor             # (B,) int32: non-eos emitted tokens
    cache: Dict[str, torch.Tensor]  # decoder KV caches, updated in place


def stream_start(params, cfg: ModelConfig, memory, max_len: int,
                 segment_steps: int, *, sos_id: int = SOS_ID,
                 kernels: bool = True) -> StreamCarry:
    """The initial carry for ``memory`` (B, L_enc, D): a cache of
    ``max_len`` rounded up to whole segments."""
    B, dev = memory.shape[0], memory.device
    cap = -(-max_len // segment_steps) * segment_steps
    cache = decoder_mod.init_cache(params, cfg, memory, max_len=cap,
                                   kernels=kernels)
    return StreamCarry(
        step=0,
        prev=torch.full((B,), sos_id, dtype=torch.int64, device=dev),
        finished=torch.zeros((B,), dtype=torch.bool, device=dev),
        lp_sum=torch.zeros((B,), dtype=torch.float32, device=dev),
        count=torch.zeros((B,), dtype=torch.int32, device=dev),
        cache=cache)


@torch.inference_mode()
def stream_segment(params, cfg: ModelConfig, carry: StreamCarry,
                   segment_steps: int, *, eos_id: int = EOS_ID,
                   pad_id: int = PAD_ID, kernels: bool = True):
    """Exactly ``segment_steps`` decoder steps; a row that finishes emits
    PAD after its EOS and stops its accounting. Returns (carry, tokens
    (B, segment_steps) int32). Reads no device value."""
    B = carry.prev.shape[0]
    toks = torch.full((B, segment_steps), pad_id, dtype=torch.int32,
                      device=carry.prev.device)
    step, prev, finished = carry.step, carry.prev, carry.finished
    lp_sum, count = carry.lp_sum, carry.count
    for i in range(segment_steps):
        logits = decoder_mod.decoder_step(params, cfg, prev, step,
                                          carry.cache, kernels=kernels)
        nxt = logits.argmax(dim=-1)
        logp = torch.log(torch.softmax(logits, dim=-1) + 1e-10).gather(
            1, nxt[:, None])[:, 0]
        is_eos = nxt == eos_id
        lp_sum = lp_sum + torch.where(finished, 0.0, logp)
        count = count + (~(finished | is_eos)).to(torch.int32)
        toks[:, i] = torch.where(finished, pad_id, nxt).to(torch.int32)
        finished = finished | is_eos
        prev = torch.where(finished, eos_id, nxt)
        step += 1
    return StreamCarry(step, prev, finished, lp_sum, count,
                       carry.cache), toks


def stream_report(carry: StreamCarry, toks) -> torch.Tensor:
    """A segment's report as ONE (B, segment_steps + 3) int32 tensor
    (columns: the tokens, finished, count, lp_sum's bits), so that the host
    copies one array a segment."""
    return torch.cat([toks, carry.finished.to(torch.int32)[:, None],
                      carry.count[:, None],
                      carry.lp_sum.view(torch.int32)[:, None]], dim=1)
