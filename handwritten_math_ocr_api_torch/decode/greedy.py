"""Batched greedy decode with a KV cache.

Port of ``handwritten_math_ocr_api_tpu/decode/greedy.py``. The encoder runs
once; each step is one cached decoder pass. Every row keeps a finished
flag; a finished row emits PAD and is fed EOS, and the loop ends when every
row has finished or after ``max_len`` steps. The confidence numerics are the
reference's: the log of ``softmax + 1e-10`` of the chosen token is summed
over the steps a row was live (its EOS step included), and ``token_count``
counts its non-EOS tokens.

The JAX loop is one device program; here it is a Python loop. It reads one
flag back from the device per step, to end early.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from ..core.config import EOS_ID, ModelConfig, PAD_ID, SOS_ID
from ..models import decoder as decoder_mod


class GreedyResult(NamedTuple):
    tokens: torch.Tensor       # (B, max_len) generated ids, PAD after finish
    lengths: torch.Tensor      # (B,) emitted tokens incl. the eos step
    logprob_sum: torch.Tensor  # (B,) accumulated log-probs (incl. eos step)
    token_count: torch.Tensor  # (B,) non-eos emitted tokens
    steps: int                 # decode steps run (each one decoder pass)


def greedy_loop(step_logits: Callable[[torch.Tensor, int], torch.Tensor],
                B: int, T: int, dev) -> GreedyResult:
    """The loop and bookkeeping shared by the decode routes:
    ``step_logits(prev, step)`` returns the float32 (B, vocab) logits of
    one decoder step fed the previous tokens ``prev`` (B,) at ``step``."""
    tokens = torch.full((B, T), PAD_ID, dtype=torch.int64, device=dev)
    prev = torch.full((B,), SOS_ID, dtype=torch.int64, device=dev)
    finished = torch.zeros((B,), dtype=torch.bool, device=dev)
    lp_sum = torch.zeros((B,), dtype=torch.float32, device=dev)
    count = torch.zeros((B,), dtype=torch.int64, device=dev)
    step = 0
    while step < T:
        logits = step_logits(prev, step)
        nxt = logits.argmax(dim=-1)
        logp_all = torch.log(torch.softmax(logits, dim=-1) + 1e-10)
        logp = logp_all.gather(1, nxt[:, None])[:, 0]
        is_eos = nxt == EOS_ID
        lp_sum += torch.where(finished, 0.0, logp)
        count += (~(finished | is_eos)).to(count.dtype)
        tokens[:, step] = torch.where(finished, PAD_ID, nxt)
        finished |= is_eos
        # feed the true argmax (incl. eos), eos once a row has finished
        prev = torch.where(finished, EOS_ID, nxt)
        step += 1
        if bool(finished.all()):
            break
    lengths = (tokens != PAD_ID).sum(dim=-1)
    return GreedyResult(tokens, lengths, lp_sum, count, step)


@torch.inference_mode()
def greedy_decode(params, cfg: ModelConfig, memory, max_len=None, *,
                  kernels: bool = True) -> GreedyResult:
    """memory: (B, L_enc, d_model) from the encoder. ``kernels=False``
    takes the plain cache attention even on CUDA (the reference path)."""
    T = max_len or cfg.max_seq_len
    cache = decoder_mod.init_cache(params, cfg, memory, max_len=T)
    return greedy_loop(
        lambda prev, step: decoder_mod.decoder_step(
            params, cfg, prev, step, cache, kernels=kernels),
        memory.shape[0], T, memory.device)
