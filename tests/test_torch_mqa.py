"""Multi-query and grouped-query self-attention (``nhead_kv``) of the port
against the JAX package's.

Self-attention with fewer KV heads than query heads: MQA (``nhead_kv=1``)
and GQA-2 (``nhead_kv=2`` of 4 heads). The port's ``grouped_attention``,
the decoder's full pass, cache and step (float and int8 trees), the plain
versions of the greedy step B1 and the ragged step B7 against the JAX
Pallas kernels in interpret mode at MQA (float and int8 bundles), the
fused greedy ("v2") and beam decodes at MQA, and every refusal of a fused
path where JAX's refuses. The engine on both routes against the JAX
engine is ``tests/test_torch_mqa_engine.py``.
On the CPU the port's wrappers run their plain versions. The decoder is
``tests/test_fused.py``'s (d_model 32, 4 heads, 2 layers, FFN 64, T 12,
vocab 20, float32) with every bias and LayerNorm parameter nonzero;
inputs are made with numpy from a seed.

Tolerances: attention outputs and the fused steps' float32 outputs at
1e-5 (float32 sums over at most 12 terms in other orders, then
LayerNorm); the decoder's logits at 1e-4, the bound of
``tests/test_torch_models.py`` (the float32 head sums 32 LayerNorm
outputs in another order); the int8 fused steps' at 5e-3 absolute, as
``tests/test_torch_quant.py`` states it (a bf16-rounded matmul input may
land one bf16 step apart); log-prob sums at 1e-4; beam scores at
``tests/test_torch_beam.py``'s 5e-3 / 2e-3; tokens and strings exactly.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from handwritten_math_ocr_api_tpu.decode.fused import (
    beam_decode_fused as j_beam_fused,
    greedy_decode_fused as j_greedy_fused,
    init_fused_cache as j_init_fused_cache,
)
from handwritten_math_ocr_api_tpu.models import decoder as jdec
from handwritten_math_ocr_api_tpu.models import layers as jlayers
from handwritten_math_ocr_api_tpu.ops import quant as jquant
from handwritten_math_ocr_api_tpu.ops.fused_step import (
    build_stacked as j_build_stacked,
    build_stacked_full as j_build_stacked_full,
    fused_decoder_layers_step_v2 as j_step_v2,
    fused_ragged_step as j_ragged_step,
    quantize_stacked as j_quantize_stacked,
)

from handwritten_math_ocr_api_torch import convert
from handwritten_math_ocr_api_torch.decode import beam as tbeam
from handwritten_math_ocr_api_torch.decode import fused as tfused
from handwritten_math_ocr_api_torch.decode.greedy import greedy_decode
from handwritten_math_ocr_api_torch.models import decoder as tdec
from handwritten_math_ocr_api_torch.models import layers as tlayers
from handwritten_math_ocr_api_torch.ops import fused_step as tstep
from handwritten_math_ocr_api_torch.ops import quant as tquant
from handwritten_math_ocr_api_torch.ops import whole_decode as twd

from test_torch_beam import SCORE_ATOL, SCORE_RTOL
from test_torch_fused import DEC_CFG, _j, _t, jitter
from test_torch_models import jax_config

ATTN_TOL = 1e-5
LOGIT_TOL = 1e-4
STEP_TOL = 1e-5
INT8_STEP_ATOL = 5e-3
L, T, D, H, L_ENC = 2, 12, 32, 4, 6
DH = D // H
KV_HEADS = [1, 2]
JAX_BLOCK_B = 16   # the JAX ragged step's row chunk (its pool a multiple)


def _cfgs(nhead_kv, base=DEC_CFG):
    cfg = base.replace(nhead_kv=nhead_kv)
    return cfg, jax_config(cfg)


@pytest.fixture(scope="module")
def decoders():
    """Per KV-head count, decoder weights (nonzero biases and norms) as a
    numpy tree; the self-attention projection is (D, D + 2 kvd)."""
    out = {}
    for kv in KV_HEADS:
        _, jcfg = _cfgs(kv)
        params = jdec.init_decoder_params(jax.random.PRNGKey(kv), jcfg)
        out[kv] = jitter(params, seed=10 + kv)
        w = out[kv]["layers"][0]["self_attn"]["w_qkv"]
        assert w.shape == (D, D + 2 * kv * DH)
    return out


def _memory(B, seed):
    return np.random.default_rng(seed).standard_normal(
        (B, L_ENC, D)).astype(np.float32)


# mask kinds: none, a head axis of 1, of Hkv, of H (one a query head),
# and pre-expanded to (B, Hkv, g, Lq, Lk)
MASKS = ["none", "one", "kv", "query", "expanded"]


@pytest.mark.parametrize("mask_kind", MASKS)
@pytest.mark.parametrize("nhead_kv", KV_HEADS)
def test_grouped_attention_matches_jax(nhead_kv, mask_kind):
    rng = np.random.default_rng(nhead_kv * 10 + MASKS.index(mask_kind))
    B, Lq, Lk, g = 2, 5, 7, H // nhead_kv
    q = rng.standard_normal((B, H, Lq, DH)).astype(np.float32)
    k, v = (rng.standard_normal((B, nhead_kv, Lk, DH)).astype(np.float32)
            for _ in range(2))
    heads = {"none": None, "one": 1, "kv": nhead_kv, "query": H,
             "expanded": None}[mask_kind]
    mask = None
    if mask_kind != "none":
        shape = ((B, nhead_kv, g, Lq, Lk) if mask_kind == "expanded"
                 else (B, heads, Lq, Lk))
        mask = rng.standard_normal(shape).astype(np.float32)
        mask[..., Lq:] = -np.inf     # some slots masked in every row
    want = jlayers.grouped_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        None if mask is None else jnp.asarray(mask), H)
    got = tlayers.grouped_attention(_t(q), _t(k), _t(v),
                                    None if mask is None else _t(mask), H)
    assert tuple(got.shape) == (B, H, Lq, DH)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATTN_TOL,
                               rtol=ATTN_TOL)


@pytest.mark.parametrize("nhead_kv", KV_HEADS)
def test_decoder_forward_matches_jax(decoders, nhead_kv):
    """The teacher-forced pass (causal grouped self-attention through
    ``mha`` on the narrow packed weight)."""
    cfg, jcfg = _cfgs(nhead_kv)
    rng = np.random.default_rng(20 + nhead_kv)
    memory = _memory(2, 21 + nhead_kv)
    ids = rng.integers(0, cfg.vocab_size, (2, 7)).astype(np.int32)
    want = jdec.decoder_forward(_j(decoders[nhead_kv]), jcfg,
                                jnp.asarray(memory), jnp.asarray(ids))
    tparams = convert.to_torch(decoders[nhead_kv], cfg, "cpu")
    got = tdec.decoder_forward(tparams, cfg, _t(memory), _t(ids).long())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=LOGIT_TOL,
                               rtol=LOGIT_TOL)


@pytest.mark.parametrize("quantize", [False, True])
@pytest.mark.parametrize("nhead_kv", KV_HEADS)
def test_cache_and_step_match_jax(decoders, nhead_kv, quantize):
    """``init_cache``'s (B, Hkv, T, Dh) self caches and cross K/V, then six
    ``decoder_step``s: the logits and the written self-cache slots against
    JAX's step on the same tree (int8 with ``quantize``: the qkv
    projection one dequant matmul of D + 2 kvd columns); in float32 each
    step's logits also equal the full pass at its last position."""
    cfg, jcfg = _cfgs(nhead_kv)
    tree = decoders[nhead_kv]
    jtree = _j(tree)
    if quantize:
        jtree = jquant.quantize_decoder_params(jtree)
        tree = tquant.quantize_decoder_params(tree)
    tparams = convert.to_torch(tree, cfg, "cpu")
    memory = _memory(3, 30 + nhead_kv)
    ids = np.random.default_rng(31).integers(
        0, cfg.vocab_size, (3, 6)).astype(np.int32)
    jcache = jdec.init_cache(jtree, jcfg, jnp.asarray(memory), max_len=T)
    cache = tdec.init_cache(tparams, cfg, _t(memory), max_len=T)
    assert sorted(cache) == sorted(jcache)
    for name, w in jcache.items():
        assert tuple(cache[name].shape) == w.shape, name
        np.testing.assert_allclose(cache[name].numpy(), np.asarray(w),
                                   atol=ATTN_TOL, rtol=ATTN_TOL,
                                   err_msg=name)
    assert cache["self_k_0"].shape == (3, nhead_kv, T, DH)
    if not quantize:
        full = tdec.decoder_forward(tparams, cfg, _t(memory),
                                    _t(ids).long())
    for t in range(ids.shape[1]):
        want, jcache = jdec.decoder_step(jtree, jcfg, jnp.asarray(ids[:, t]),
                                         jnp.int32(t), jcache)
        got = tdec.decoder_step(tparams, cfg, _t(ids[:, t]).long(), t, cache)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=LOGIT_TOL, rtol=LOGIT_TOL)
        if not quantize:
            np.testing.assert_allclose(got.numpy(), full[:, t].numpy(),
                                       atol=LOGIT_TOL, rtol=LOGIT_TOL)
        for name in ("self_k_1", "self_v_1"):
            np.testing.assert_allclose(cache[name].numpy(),
                                       np.asarray(jcache[name]),
                                       atol=LOGIT_TOL, rtol=LOGIT_TOL,
                                       err_msg=name)


def _step_inputs(tree, jcfg, rows, seed):
    """x_emb, MQA self caches of random rows (kvd = Dh lanes) and JAX's
    padded cross K/V for ``rows`` rows."""
    rng = np.random.default_rng(seed)
    memory = _memory(rows, seed)
    _, _, ck, cv = j_init_fused_cache(_j(tree), jcfg, jnp.asarray(memory))
    sk, sv = (rng.standard_normal((L, rows, T, DH)).astype(np.float32)
              for _ in range(2))
    return rng.standard_normal((rows, D)).astype(np.float32), sk, sv, ck, cv


@pytest.mark.parametrize("pos", [0, 5, 11])
@pytest.mark.parametrize("quantize", [False, True])
def test_step_v2_plain_matches_pallas_mqa(decoders, quantize, pos):
    """B1 at MQA ("v2", and "v2q" with ``quantize``): x_out and each
    layer's fresh K/V rows of Dh lanes against the TPU kernel (its
    per-head MQA attention, ``_mqa_attn_perhead``) in interpret mode."""
    cfg, jcfg = _cfgs(1)
    tree = decoders[1]
    x_emb, sk, sv, ck, cv = _step_inputs(tree, jcfg, 5, 40 + pos)
    jst = j_build_stacked(_j(tree), jcfg)
    tst = tstep.build_stacked(tree, cfg)
    assert tuple(tst["w_qkv"].shape) == (L, D, D + 2 * DH)
    if quantize:
        jst, tst = j_quantize_stacked(jst), tstep.quantize_stacked(tst)
    want = j_step_v2(jst, jcfg, jnp.asarray(x_emb), jnp.asarray(sk),
                     jnp.asarray(sv), ck, cv, jnp.int32(pos),
                     l_enc_actual=L_ENC, interpret=True)
    got = tstep.fused_decoder_layers_step_v2(
        tst, cfg, _t(x_emb), _t(sk), _t(sv), _t(ck[:, :, :L_ENC]),
        _t(cv[:, :, :L_ENC]), pos)
    atol = INT8_STEP_ATOL if quantize else STEP_TOL
    for name, g, w in zip(("x_out", "k_new", "v_new"), got, want):
        assert tuple(g.shape) == w.shape, name
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=atol,
                                   rtol=STEP_TOL, err_msg=name)


def _pad_rows(a, axis, rows):
    width = [(0, 0)] * a.ndim
    width[axis] = (0, rows - a.shape[axis])
    return np.pad(np.asarray(a), width)


@pytest.mark.parametrize("return_logits", [True, False])
@pytest.mark.parametrize("quantize", [False, True])
def test_ragged_step_plain_matches_pallas_mqa(decoders, quantize,
                                              return_logits):
    """B7 at MQA over 7 rows at positions mixing the first slot, a middle
    one and the last (JAX's pool padded to its 16-row ``block_b``):
    logits (or argmax and log-probability) and fresh K/V rows."""
    cfg, jcfg = _cfgs(1)
    tree = decoders[1]
    R = 7
    rng = np.random.default_rng(50)
    _, sk, sv, ck, cv = _step_inputs(tree, jcfg, R, 51)
    prev = rng.integers(0, cfg.vocab_size, R).astype(np.int32)
    pos = np.array([0, T // 2 - 1, T - 1, 0, 3, T - 1, T // 2 - 1],
                   np.int32)
    jst = j_build_stacked_full(_j(tree), jcfg)
    tst = tstep.build_stacked_full(tree, cfg)
    if quantize:
        jst, tst = j_quantize_stacked(jst), tstep.quantize_stacked(tst)
    pool = JAX_BLOCK_B
    want = j_ragged_step(
        jst, jcfg, jnp.asarray(_pad_rows(prev, 0, pool)),
        jnp.asarray(_pad_rows(pos, 0, pool)),
        *(jnp.asarray(_pad_rows(a, 1, pool)) for a in (sk, sv, ck, cv)),
        l_enc_actual=L_ENC, block_b=JAX_BLOCK_B,
        return_logits=return_logits, interpret=True)
    args = (tst, cfg, _t(prev), _t(pos), _t(sk), _t(sv),
            _t(ck[:, :, :L_ENC]), _t(cv[:, :, :L_ENC]))
    got = tstep.fused_ragged_step(*args, return_logits=return_logits)
    atol = INT8_STEP_ATOL if quantize else STEP_TOL
    if return_logits:
        np.testing.assert_allclose(
            got[0].numpy(), np.asarray(want[0])[:R, :cfg.vocab_size],
            atol=atol, rtol=STEP_TOL)
    else:
        held = np.ones(R, dtype=bool)
        if quantize:   # the argmax where the logits are no near-tie
            top2 = tstep.fused_ragged_step(
                *args, return_logits=True)[0].topk(2, dim=-1).values
            held = (top2[:, 0] - top2[:, 1]).numpy() > 2 * INT8_STEP_ATOL
        np.testing.assert_array_equal(got[0].numpy()[held],
                                      np.asarray(want[0])[:R][held])
        np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1])[:R],
                                   atol=atol, rtol=STEP_TOL)
    for name, g, w in zip(("k_new", "v_new"), got[-2:], want[-2:]):
        assert tuple(g.shape) == (L, R, DH), name
        np.testing.assert_allclose(g.numpy(), np.asarray(w)[:, :R],
                                   atol=atol, rtol=STEP_TOL, err_msg=name)


def test_greedy_decode_fused_v2_matches_jax_mqa(decoders):
    """The "v2" greedy decode at MQA: tokens and counts equal to JAX's
    (interpret mode) and to the port's default route."""
    cfg, jcfg = _cfgs(1)
    tree = decoders[1]
    memory = _memory(3, 60)
    want = j_greedy_fused(_j(tree), j_build_stacked(_j(tree), jcfg), jcfg,
                          jnp.asarray(memory), T, interpret=True)
    tparams = convert.to_torch(tree, cfg, "cpu")
    got = tfused.greedy_decode_fused(tparams, tstep.build_stacked(tree, cfg),
                                     cfg, _t(memory), T)
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(want.tokens))
    np.testing.assert_array_equal(got.token_count.numpy(),
                                  np.asarray(want.token_count))
    np.testing.assert_allclose(got.logprob_sum.numpy(),
                               np.asarray(want.logprob_sum), atol=1e-4,
                               rtol=1e-4)
    plain = greedy_decode(tparams, cfg, _t(memory), T)
    np.testing.assert_array_equal(got.tokens.numpy(), plain.tokens.numpy())


def test_beam_decode_fused_matches_jax_mqa(decoders):
    """The fused beam at MQA (beam 5 over 2 images, the ragged step and
    the cache reorder at Dh lanes): tokens, lengths and scores equal to
    JAX's and the tokens to the port's default beam."""
    cfg, jcfg = _cfgs(1)
    tree = decoders[1]
    memory = _memory(2, 61)
    want = j_beam_fused(_j(tree), j_build_stacked_full(_j(tree), jcfg), jcfg,
                        jnp.asarray(memory), beam_size=5, interpret=True)
    tparams = convert.to_torch(tree, cfg, "cpu")
    got = tfused.beam_decode_fused(tparams,
                                   tstep.build_stacked_full(tree, cfg), cfg,
                                   _t(memory), 5)
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(want.tokens))
    np.testing.assert_array_equal(got.lengths.numpy(),
                                  np.asarray(want.lengths))
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores),
                               atol=SCORE_ATOL, rtol=SCORE_RTOL)
    plain = tbeam.beam_decode(tparams, cfg, _t(memory), 5)
    np.testing.assert_array_equal(got.tokens.numpy(), plain.tokens.numpy())


REFUSED_VARIANTS = [(v, kv) for kv in KV_HEADS
                    for v in tfused.VARIANTS if (v, kv) != ("v2", 1)]


@pytest.mark.parametrize("variant,nhead_kv", REFUSED_VARIANTS)
def test_fused_greedy_refuses_where_jax_does(decoders, variant, nhead_kv):
    """Every greedy variant but "v2" under MQA ("v2m" too, as in JAX), and
    every variant under GQA: NotImplementedError in both packages."""
    cfg, jcfg = _cfgs(nhead_kv)
    tree = decoders[nhead_kv]
    memory = _memory(2, 70)
    with pytest.raises(NotImplementedError):
        j_greedy_fused(_j(tree), j_build_stacked(_j(tree), jcfg), jcfg,
                       jnp.asarray(memory), 8, interpret=True,
                       variant=variant)
    with pytest.raises(NotImplementedError, match="supports MHA"):
        tfused.greedy_decode_fused(convert.to_torch(tree, cfg, "cpu"),
                                   tstep.build_stacked(tree, cfg), cfg,
                                   _t(memory), 8, variant=variant)


def test_fused_beam_refuses_gqa_as_jax(decoders):
    cfg, jcfg = _cfgs(2)
    tree = decoders[2]
    memory = _memory(2, 71)
    with pytest.raises(NotImplementedError):
        j_beam_fused(_j(tree), j_build_stacked_full(_j(tree), jcfg), jcfg,
                     jnp.asarray(memory), beam_size=2, interpret=True)
    with pytest.raises(NotImplementedError, match="MHA and MQA"):
        tfused.beam_decode_fused(convert.to_torch(tree, cfg, "cpu"),
                                 tstep.build_stacked_full(tree, cfg), cfg,
                                 _t(memory), 2)


@pytest.mark.parametrize("nhead_kv", KV_HEADS)
def test_mha_only_steps_refuse_grouped_attention(decoders, nhead_kv):
    """B10, B11 and B12, MHA only as their TPU kernels, raise
    NotImplementedError on an MQA or GQA config (plain versions here)."""
    cfg, _ = _cfgs(nhead_kv)
    st = tstep.build_stacked_full(decoders[nhead_kv], cfg)
    kvd = nhead_kv * DH
    sk = torch.zeros(L, 2, T, kvd)
    ck = torch.zeros(L, 2, L_ENC, D)
    x = torch.zeros(2, D)
    prev = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(NotImplementedError, match="MHA only"):
        tstep.fused_decoder_layers_step(st, cfg, x, sk, sk.clone(), ck, ck, 1)
    with pytest.raises(NotImplementedError, match="MHA only"):
        tstep.fused_whole_step(st, cfg, prev, sk, sk.clone(), ck, ck, 1,
                               time_major=False)
    res = twd.build_resident(convert.to_torch(decoders[nhead_kv], cfg, "cpu"),
                             cfg, quantize=False)
    with pytest.raises(NotImplementedError, match="MHA only"):
        twd.fused_whole_decode(res, cfg, _t(_memory(2, 72)), T)
