"""Batched beam-search decode with a KV cache.

Port of ``handwritten_math_ocr_api_tpu/decode/beam.py``. Each of the B images
keeps K beams as B*K cache rows. A step scores every beam's continuations
(sum of per-token log-probs), keeps the K best of the K*V candidates per
image, reorders the beam state and the self-attention caches by the chosen
parents (cross-attention K/V are beam-invariant and stay), and feeds the
chosen tokens. A finished beam extends only with <pad> at zero added
score; the loop ends when every beam has finished or after ``max_len``
steps. ``alpha`` (GNMT length normalization, score / length**alpha) acts
only at the final choice of the best beam, as in the reference; alpha 0 is
pure log-prob.

The reference's ``lax.top_k`` puts the lower index first among equal
scores; ``torch.topk`` promises no order, so the candidates are ranked by
a stable descending sort. Beam 0 starts live and the others at
``NEG_INF`` (-1e9, not -inf), so that step 0 picks K distinct first tokens.

The default route's step is ``decoder_step`` (the cache-append attention
kernel in every layer); its caches are reordered with ``index_select``,
the reference's ``take_along_axis``. ``decode/fused.py::beam_decode_fused``
runs the same bookkeeping (``BeamSearch``) over the fused ragged step.

``beam_decode_indirect`` is JAX's A/B variant that the engine never calls:
the caches are never reordered; a (B, K, T) ancestry table says which
beam row's entry at each position belongs to each beam's history, and the
attention reads through it. Plain ops, MHA only, as in JAX.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..core.config import EOS_ID, ModelConfig, PAD_ID, SOS_ID
from ..models import decoder as decoder_mod
from ..models import layers
from ..models.model import compute_dtype

NEG_INF = -1.0e9


class BeamResult(NamedTuple):
    tokens: torch.Tensor   # (B, max_len) best-beam ids, PAD after eos
    scores: torch.Tensor   # (B,) best-beam total log-prob
    lengths: torch.Tensor  # (B,) emitted tokens incl. the eos step
    steps: int             # decode steps run


def top_k_lower_index_first(x, k: int):
    """(values, indices) of the k largest entries of each row of x, equal
    values in the order of their index, as ``jax.lax.top_k``."""
    values, indices = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[:, :k], indices[:, :k]


class BeamSearch:
    """The beam state of B images x K beams and its per-step update,
    shared by the default and the fused route."""

    def __init__(self, B: int, K: int, T: int, dev):
        self.B, self.K = B, K
        self.scores = torch.full((B, K), NEG_INF, dtype=torch.float32,
                                 device=dev)
        self.scores[:, 0] = 0.0
        self.finished = torch.zeros((B, K), dtype=torch.bool, device=dev)
        self.tokens = torch.full((B, K, T), PAD_ID, dtype=torch.int64,
                                 device=dev)
        self.prev = torch.full((B * K,), SOS_ID, dtype=torch.int64,
                               device=dev)

    def step(self, logp, step: int):
        """logp (B*K, V) float32 log-probabilities of this step. Keeps the
        K best candidates per image and returns the parent of each new
        beam as a row of the B*K (``src``, (B*K,) int64)."""
        B, K = self.B, self.K
        V = logp.shape[-1]
        logp = logp.reshape(B, K, V)
        pad_only = torch.full((V,), NEG_INF, dtype=torch.float32,
                              device=logp.device)
        pad_only[PAD_ID] = 0.0
        cand = torch.where(self.finished[:, :, None], pad_only, logp)
        cand = self.scores[:, :, None] + cand                  # (B, K, V)
        top_scores, top_idx = top_k_lower_index_first(
            cand.reshape(B, K * V), K)
        beam_idx = top_idx // V
        token = top_idx % V
        tokens = self.tokens.gather(
            1, beam_idx[:, :, None].expand(-1, -1, self.tokens.shape[2]))
        was_finished = self.finished.gather(1, beam_idx)
        tokens[:, :, step] = torch.where(was_finished, PAD_ID, token)
        self.tokens = tokens
        self.finished = was_finished | (token == EOS_ID)
        self.scores = top_scores
        self.prev = torch.where(
            self.finished, EOS_ID,
            torch.where(was_finished, PAD_ID, token)).reshape(B * K)
        return (torch.arange(B, device=logp.device)[:, None] * K
                + beam_idx).reshape(B * K)

    def all_finished(self) -> bool:
        return bool(self.finished.all())

    def result(self, alpha: float, steps: int) -> BeamResult:
        """The best beam of each image: by score, or by score /
        length**alpha when alpha > 0."""
        lengths = (self.tokens != PAD_ID).sum(dim=-1)          # (B, K)
        final = self.scores
        if alpha > 0.0:
            final = self.scores / lengths.clamp(min=1).float().pow(alpha)
        best = final.argmax(dim=-1)
        rows = torch.arange(self.B, device=best.device)
        return BeamResult(self.tokens[rows, best], self.scores[rows, best],
                          lengths[rows, best], steps)


@torch.inference_mode()
def beam_decode(params, cfg: ModelConfig, memory, beam_size: int = 5,
                max_len=None, *, alpha: float = 0.0,
                kernels: bool = True) -> BeamResult:
    """memory: (B, L_enc, d_model) from the encoder. ``kernels=False``
    takes the plain cache attention and dequant matmul even on CUDA (the
    reference path)."""
    B = memory.shape[0]
    K = beam_size
    T = max_len or cfg.max_seq_len
    cache = decoder_mod.init_cache(params, cfg,
                                   memory.repeat_interleave(K, dim=0),
                                   max_len=T, kernels=kernels)
    beams = BeamSearch(B, K, T, memory.device)
    step = 0
    while step < T:
        logits = decoder_mod.decoder_step(params, cfg, beams.prev, step,
                                          cache, kernels=kernels)
        src = beams.step(torch.log_softmax(logits.float(), dim=-1), step)
        for name in cache:
            if name.startswith("self_"):
                cache[name] = cache[name].index_select(0, src)
        step += 1
        if beams.all_finished():
            break
    return beams.result(alpha, step)


def _step_indirect(params, cfg: ModelConfig, tok_ids, pos: int, cache,
                   ancestry, B: int, K: int):
    """One decode step of B*K beam rows whose self-attention history is
    read through ``ancestry`` (B, K, T) int64: entry [b, k, t] is the beam
    row (0..K-1) whose cache slot t belongs to beam k's history (column
    ``pos`` is each row's own). Each row writes its fresh K/V at ``pos`` of
    its own row; the reads are steered. Returns float32 logits (B*K, V),
    the caches updated in place."""
    dtype = compute_dtype(cfg)
    nh, D = cfg.nhead, cfg.d_model
    pos_ids = torch.full_like(tok_ids, pos)[:, None]
    x = decoder_mod._embed(params, tok_ids[:, None], pos_ids, dtype)
    T = cache["self_k_0"].shape[2]
    slot = torch.arange(T, device=x.device)
    mask = torch.zeros((T,), device=x.device).masked_fill(
        slot > pos, float("-inf"))
    for i, p in enumerate(params["layers"]):
        sp = p["self_attn"]
        qkv = decoder_mod._linear(sp, "w_qkv", "b_qkv", x, True)
        q, k_new, v_new = (layers.split_heads(t, nh)
                           for t in qkv.split([D, D, D], dim=-1))
        sk, sv = cache[f"self_k_{i}"], cache[f"self_v_{i}"]
        sk[:, :, pos] = k_new[:, :, 0]
        sv[:, :, pos] = v_new[:, :, 0]
        H, Dh = sk.shape[1], sk.shape[3]
        idx = ancestry[:, :, None, :, None].expand(B, K, H, T, Dh)
        k_eff = sk.reshape(B, K, H, T, Dh).gather(1, idx)
        v_eff = sv.reshape(B, K, H, T, Dh).gather(1, idx)
        sa = layers.attention(q, k_eff.reshape(B * K, H, T, Dh),
                              v_eff.reshape(B * K, H, T, Dh), mask)
        sa = decoder_mod._linear(sp, "w_out", "b_out",
                                 layers.merge_heads(sa), True)
        x = layers.layer_norm(p["norm1"], x + sa)

        cp = p["cross_attn"]
        qc = layers.split_heads(decoder_mod._proj(cp, x, "q"), nh)
        ca = layers.attention(qc, cache[f"cross_k_{i}"],
                              cache[f"cross_v_{i}"])
        ca = decoder_mod._linear(cp, "w_out", "b_out",
                                 layers.merge_heads(ca), True)
        x = layers.layer_norm(p["norm2"], x + ca)

        ff = layers.mlp(p["ffn"], x, activation=torch.relu)
        x = layers.layer_norm(p["norm3"], x + ff)
    return layers.linear(params["fc_out"], x.float())[:, 0, :]


@torch.inference_mode()
def beam_decode_indirect(params, cfg: ModelConfig, memory,
                         beam_size: int = 5, max_len=None, *,
                         alpha: float = 0.0) -> BeamResult:
    """``beam_decode`` with ancestry indirection (module docstring): the
    same tokens and scores, no per-step cache reorder; only the (B, K, T)
    ancestry table and the beam state reorder. MHA only: a config with
    ``nhead_kv`` < ``nhead`` raises ``NotImplementedError``."""
    if cfg.kv_heads != cfg.nhead:
        raise NotImplementedError(
            "ancestry-indirection beam supports MHA only")
    B = memory.shape[0]
    K = beam_size
    T = max_len or cfg.max_seq_len
    dev = memory.device
    cache = decoder_mod.init_cache(params, cfg,
                                   memory.repeat_interleave(K, dim=0),
                                   max_len=T)
    beams = BeamSearch(B, K, T, dev)
    anc = torch.zeros((B, K, T), dtype=torch.int64, device=dev)
    own = torch.arange(K, device=dev)[None, :].expand(B, K)
    first = (torch.arange(B, device=dev) * K)[:, None]
    step = 0
    while step < T:
        anc[:, :, step] = own  # rows attend their own fresh entry
        logits = _step_indirect(params, cfg, beams.prev, step, cache, anc,
                                B, K)
        src = beams.step(torch.log_softmax(logits, dim=-1), step)
        beam_idx = src.reshape(B, K) - first
        # beam k's history is its parent's, and the column just written is
        # the parent's own row
        anc = anc.gather(1, beam_idx[:, :, None].expand(B, K, T))
        step += 1
        if beams.all_finished():
            break
    return beams.result(alpha, step)
