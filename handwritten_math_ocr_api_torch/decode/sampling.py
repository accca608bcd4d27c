"""Stochastic decode: temperature, top-k and top-p (nucleus) sampling.

Port of ``handwritten_math_ocr_api_tpu/decode/sampling.py``. The loop,
early exit and bookkeeping are greedy's (``decode/greedy.py::greedy_loop``);
only the choice of each step's token differs. That choice, for every
decode route, is ``TokenPick``: the argmax, under the constraint mask of
``decode/constrain.py`` when one is given, or with a generator a draw from
the filtered distribution.

The draw is Gumbel-max, ``argmax(filtered + g)`` with ``g = -log(-log(u))``
for uniforms ``u`` of the generator, which is the form
``jax.random.categorical`` computes. A masked entry (-1e30) can never be
drawn: g is finite. The uniforms come from an explicit ``torch.Generator``
on the logits' device, one (B, V) draw a step, so a seed gives the same
tokens on the same device; it does not reproduce JAX's threefry stream
(``fold_in(rng, step)``), so sampled strings differ from JAX's for the
same seed.

The confidence stays on the reference's formula: log(softmax + 1e-10) of
the chosen token in the RAW (untempered, unfiltered) distribution, so that
confidences compare across greedy and sampled decodes.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..core.config import ModelConfig
from ..models import decoder as decoder_mod
from . import constrain as constrain_mod
from .greedy import GreedyResult, greedy_loop

_NEG_INF = -1e30


def filter_logits(logits, temperature: float = 1.0, top_k: int = 0,
                  top_p: float = 1.0):
    """Temperature-scale, then mask (to -1e30) what lies outside the top-k
    set and the top-p mass: (B, V) -> (B, V). ``top_k=0`` and ``top_p>=1``
    turn the filters off. Ties with the k-th value survive top-k, and ties
    with the smallest kept logit survive top-p; the most probable token
    always survives both."""
    scaled = logits / max(temperature, 1e-6)
    if top_k and top_k > 0:
        k = min(int(top_k), logits.shape[-1])
        kth = torch.topk(scaled, k, dim=-1).values[..., -1:]
        scaled = torch.where(scaled < kth, _NEG_INF, scaled)
    if top_p < 1.0:
        # the smallest prefix of the descending sort whose mass reaches
        # top_p (cum - p < top_p keeps the crossing token, and the argmax)
        sorted_logits = torch.sort(scaled, dim=-1, descending=True).values
        sp = torch.softmax(sorted_logits, dim=-1)
        cum = torch.cumsum(sp, dim=-1)
        keep = (cum - sp) < top_p
        cutoff = torch.where(keep, sorted_logits, float("inf")).min(
            dim=-1, keepdim=True).values
        scaled = torch.where(scaled < cutoff, _NEG_INF, scaled)
    return scaled


class ShardDraws(NamedTuple):
    """A generator for one shard of a batch: each draw is made for the
    whole batch of ``total`` rows, and the shard keeps rows ``first`` on,
    so that a sharded decode draws what the one-device decode draws."""

    generator: torch.Generator
    first: int
    total: int


def gumbel_argmax(logits, generator):
    """One draw a row of categorical(logits): argmax(logits + Gumbel noise),
    the noise from ``generator`` (on the logits' device; or a
    ``ShardDraws``)."""
    if isinstance(generator, ShardDraws):
        B, V = logits.shape
        u = torch.rand((generator.total, V), generator=generator.generator,
                       device=logits.device)[generator.first:
                                             generator.first + B]
    else:
        u = torch.rand(logits.shape, generator=generator,
                       device=logits.device)
    u = u.clamp_min(torch.finfo(torch.float32).tiny)
    return (logits - torch.log(-torch.log(u))).argmax(dim=-1)


class TokenPick:
    """Chooses each step's token from its float32 logits (B, V): the
    argmax, with ``constraint`` (``constrain.ConstraintTables``) under its
    mask, and with ``generator`` (a ``torch.Generator`` or a
    ``ShardDraws``) a Gumbel-max draw from the logits (masked
    first, if constrained) filtered by ``filter_logits``. ``fed`` takes the
    tokens fed to the next step (EOS for finished rows) and advances the
    constraint's state. Reads no device value."""

    def __init__(self, B: int, T: int, device, *, constraint=None,
                 generator=None,
                 temperature: float = 1.0, top_k: int = 0,
                 top_p: float = 1.0):
        self.T = T
        self.constraint = constraint
        self.state = (constrain_mod.init_state(B, device)
                      if constraint is not None else None)
        self.generator = generator
        self.filters = (temperature, top_k, top_p)

    def __call__(self, logits, step):
        sel = logits
        if self.constraint is not None:
            sel = sel + constrain_mod.step_mask(self.constraint, self.state,
                                                step, self.T)
        if self.generator is None:
            return sel.argmax(dim=-1)
        return gumbel_argmax(filter_logits(sel, *self.filters),
                             self.generator)

    def fed(self, prev) -> None:
        if self.constraint is not None:
            self.state = constrain_mod.advance(self.constraint, self.state,
                                               prev)


@torch.inference_mode()
def sample_decode(params, cfg: ModelConfig, memory,
                  generator: torch.Generator, max_len=None, *,
                  temperature: float = 1.0, top_k: int = 0,
                  top_p: float = 1.0, kernels: bool = True) -> GreedyResult:
    """Sampled decode of ``memory`` (B, L_enc, D) on the default route
    (``decoder_step``: the cache-append attention kernel in every layer,
    the dequant matmul on an int8 tree). Returns greedy's result structure.
    ``kernels=False`` takes the plain versions even on CUDA."""
    B = memory.shape[0]
    T = max_len or cfg.max_seq_len
    cache = decoder_mod.init_cache(params, cfg, memory, max_len=T,
                                   kernels=kernels)
    pick = TokenPick(B, T, memory.device, generator=generator,
                     temperature=temperature, top_k=top_k, top_p=top_p)
    return greedy_loop(
        lambda prev, step: decoder_mod.decoder_step(
            params, cfg, prev, step, cache, kernels=kernels),
        B, T, memory.device, pick=pick)
