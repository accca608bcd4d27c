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

``constraint`` (``decode/constrain.py``'s tables) masks each step's logits
before the argmax, so that the output is structurally valid LaTeX; the
log-probs stay on the raw logits, and the constraint's state advances on
the token fed to the next step (EOS for a finished row).
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


def greedy_loop(step_fn: Callable, B: int, T: int, dev, *,
                sos_id: int = SOS_ID, eos_id: int = EOS_ID,
                pad_id: int = PAD_ID, argmax_in_step: bool = False,
                pick=None) -> GreedyResult:
    """The loop and bookkeeping shared by the decode routes:
    ``step_fn(prev, step)`` runs one decoder step fed the previous tokens
    ``prev`` (B,) at ``step`` and returns its float32 (B, vocab) logits,
    or with ``argmax_in_step`` (the whole-step kernels, which pick the
    token themselves) each row's argmax and its log(p + 1e-10), (nxt,
    logp). ``pick`` (``decode/sampling.TokenPick``) chooses the token from
    the logits in place of their argmax (a constraint mask, a draw), and
    its ``fed`` sees the tokens fed to the next step."""
    tokens = torch.full((B, T), pad_id, dtype=torch.int64, device=dev)
    prev = torch.full((B,), sos_id, dtype=torch.int64, device=dev)
    finished = torch.zeros((B,), dtype=torch.bool, device=dev)
    lp_sum = torch.zeros((B,), dtype=torch.float32, device=dev)
    count = torch.zeros((B,), dtype=torch.int64, device=dev)
    step = 0
    while step < T:
        if argmax_in_step:
            nxt, logp = step_fn(prev, step)
            nxt = nxt.long()
        else:
            logits = step_fn(prev, step)
            nxt = (logits.argmax(dim=-1) if pick is None
                   else pick(logits, step))
            logp_all = torch.log(torch.softmax(logits, dim=-1) + 1e-10)
            logp = logp_all.gather(1, nxt[:, None])[:, 0]
        is_eos = nxt == eos_id
        lp_sum += torch.where(finished, 0.0, logp)
        count += (~(finished | is_eos)).to(count.dtype)
        tokens[:, step] = torch.where(finished, pad_id, nxt)
        finished |= is_eos
        # feed the true argmax (incl. eos), eos once a row has finished
        prev = torch.where(finished, eos_id, nxt)
        if pick is not None:
            pick.fed(prev)
        step += 1
        if bool(finished.all()):
            break
    lengths = (tokens != pad_id).sum(dim=-1)
    return GreedyResult(tokens, lengths, lp_sum, count, step)


@torch.inference_mode()
def greedy_decode(params, cfg: ModelConfig, memory, max_len=None, *,
                  kernels: bool = True, constraint=None) -> GreedyResult:
    """memory: (B, L_enc, d_model) from the encoder. ``kernels=False``
    takes the plain cache attention and dequant matmul even on CUDA (the
    reference path). ``constraint``: ``constrain.ConstraintTables`` (module
    docstring)."""
    from .sampling import TokenPick

    B = memory.shape[0]
    T = max_len or cfg.max_seq_len
    cache = decoder_mod.init_cache(params, cfg, memory, max_len=T,
                                   kernels=kernels)
    pick = (None if constraint is None
            else TokenPick(B, T, memory.device, constraint=constraint))
    return greedy_loop(
        lambda prev, step: decoder_mod.decoder_step(
            params, cfg, prev, step, cache, kernels=kernels),
        B, T, memory.device, pick=pick)
