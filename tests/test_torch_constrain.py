"""Pushdown-constrained decoding (``decode/constrain.py``) of the port
against the JAX package's.

The decoder config is ``tests/test_constrain.py``'s (d_model 32, 4 heads, 2
layers, FFN 64, float32) over its vocab of structural and plain LaTeX
tokens; the engines' config adds its two-stage Swin on 96x320 images.
Weights are JAX's initialisers, as numpy trees; inputs are made with numpy
from a seed. On the CPU the port's wrappers run their plain versions (the
fused route's B1 and B7 too); JAX's kernels run in Pallas interpret mode,
as its own tests run them.

What is held: ``build_tables`` on ``serving_model_r4/vocab.json`` and the
test vocab; ``step_mask`` and ``advance`` along random legal token
sequences, with a scalar step and a position per row, and the allowed set
after each prefix of JAX's rule tests; JAX's property (every constrained
decode of a random decoder passes the port's ``check_latex``, while the
unconstrained ones do not) with tokens equal to JAX's constrained greedy;
the fused greedy "v2" equal to the default route (JAX
``test_constrain.py:245``); the engines' ``constrained=True`` on both
routes against JAX's engine, and ``ContinuousDecoder(constrained=True)``
on both routes (ring on and off) against JAX's and the port's engine.

Tolerances: masks, states, tokens, counts and strings exactly; log-prob
sums at 1e-4 and confidences at 1e-4 (float32 sums of up to 48 steps in
other orders).
"""

import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from handwritten_math_ocr_api_tpu.core.config import (
    DecodeConfig as JDecodeConfig,
)
from handwritten_math_ocr_api_tpu.core.tokenizer import Tokenizer as JTokenizer
from handwritten_math_ocr_api_tpu.decode import constrain as jcon
from handwritten_math_ocr_api_tpu.decode import continuous as jcont
from handwritten_math_ocr_api_tpu.decode.api import DecodeEngine as JEngine
from handwritten_math_ocr_api_tpu.decode.greedy import (
    greedy_decode as j_greedy_decode,
)
from handwritten_math_ocr_api_tpu.models import decoder as jdec
from handwritten_math_ocr_api_tpu.models.model import init_model

from handwritten_math_ocr_api_torch import convert
from handwritten_math_ocr_api_torch.core import config as tcfg
from handwritten_math_ocr_api_torch.core.config import (
    DecodeConfig,
    EOS_ID,
    PAD_ID,
    SOS_ID,
)
from handwritten_math_ocr_api_torch.core.tokenizer import Tokenizer
from handwritten_math_ocr_api_torch.decode import api as tapi
from handwritten_math_ocr_api_torch.decode import constrain as tcon
from handwritten_math_ocr_api_torch.decode import continuous as tcont
from handwritten_math_ocr_api_torch.decode.fused import greedy_decode_fused
from handwritten_math_ocr_api_torch.decode.greedy import greedy_decode
from handwritten_math_ocr_api_torch.eval.latex_check import check_latex
from handwritten_math_ocr_api_torch.ops.fused_step import build_stacked

from test_torch_fused import _j, jitter
from test_torch_models import jax_config
import torch_threads  # noqa: F401  (one CPU thread: see the module)

STRUCT_TOKENS = ["{", "}", "\\left", "\\right", "\\begin", "\\end", "^", "_",
                 "\\frac", "\\sqrt", "\\hat", "\\binom"]
PLAIN_TOKENS = ["(", ")", "+", "=", "a", "b", "x", "y", "1", "2",
                "matrix", "cases", "\\alpha", "\\sum"]


def make_vocab(tokens):
    vocab = {"<pad>": PAD_ID, "<sos>": SOS_ID, "<eos>": EOS_ID, "<unk>": 3}
    for t in tokens:
        vocab[t] = len(vocab)
    return vocab


VOCAB = make_vocab(STRUCT_TOKENS + PLAIN_TOKENS)
IDX2TOK = {i: t for t, i in VOCAB.items()}
J_TABLES = jcon.build_tables(VOCAB)
T_TABLES = tcon.build_tables(VOCAB)
R4_VOCAB = os.path.join(os.path.dirname(__file__), os.pardir,
                        "serving_model_r4", "vocab.json")
LP_TOL = 1e-4
CONF_TOL = 1e-4


def cfg_for(max_len, **kw):
    cfg = tcfg.ModelConfig(d_model=32, nhead=4, dim_feedforward=64,
                           dropout=0.0, num_decoder_layers=2,
                           max_seq_len=max_len, vocab_size=len(VOCAB),
                           dtype="float32", **kw)
    return cfg, jax_config(cfg)


ENGINE_CFG, ENGINE_JCFG = cfg_for(
    20, swin=tcfg.SwinConfig(embed_dim=8, depths=(1, 1), num_heads=(2, 2),
                             window_size=4, stochastic_depth=0.0))


def detok(row):
    out = []
    for t in np.asarray(row):
        if t == EOS_ID:
            break
        if t in (PAD_ID, SOS_ID):
            continue
        out.append(IDX2TOK[int(t)])
    return " ".join(out)


def _decoder(seed, max_len):
    """(port cfg, JAX cfg, numpy decoder tree, memory (6, 5, 32))."""
    cfg, jcfg = cfg_for(max_len)
    tree = jax.tree_util.tree_map(
        np.array, jdec.init_decoder_params(jax.random.PRNGKey(seed), jcfg))
    rng = np.random.default_rng(seed)
    memory = rng.standard_normal((6, 5, cfg.d_model)).astype(np.float32) * 3
    return cfg, jcfg, tree, memory


def _state_np(state):
    return [np.asarray(x) for x in state]


# ---------------------------------------------------------------------------
# the tables and the state machine
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("which", ["serving_model_r4", "test"])
def test_build_tables_equal_jax(which):
    if which == "test":
        vocab = VOCAB
    else:
        with open(R4_VOCAB) as f:
            vocab = json.load(f)
        vocab = vocab.get("vocab", vocab)
    want = jcon.build_tables(vocab)
    got = tcon.build_tables(vocab)
    np.testing.assert_array_equal(got.cls.numpy(), np.asarray(want.cls))
    np.testing.assert_array_equal(got.nameable.numpy(),
                                  np.asarray(want.nameable))
    assert (got.vocab_size, got.has_env) == (want.vocab_size, want.has_env)
    np.testing.assert_array_equal(got.mode_cost.numpy(), jcon._MODE_COST)


@pytest.mark.parametrize("per_row", [False, True])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_mask_and_advance_equal_jax_along_random_sequences(seed, per_row):
    """Random legal token sequences (each token drawn among those JAX's
    mask allows; eos once a row ends): the port's mask at every step and
    its state after every token equal JAX's."""
    rng = np.random.default_rng(seed)
    B, max_len = 8, 40
    jmask = jax.jit(lambda st, step: jcon.step_mask(J_TABLES, st, step,
                                                    max_len))
    jadvance = jax.jit(lambda st, tok: jcon.advance(J_TABLES, st, tok))
    jst, tst = jcon.init_state(B), tcon.init_state(B)
    # rows start at different depths when the step is per row
    start = rng.integers(0, 12, B) if per_row else np.zeros(B, np.int64)
    done = np.zeros(B, bool)
    for i in range(max_len - 12):
        pos = start + i
        if per_row:
            jm = jmask(jst, jnp.asarray(pos[:, None], jnp.int32))
            tm = tcon.step_mask(T_TABLES, tst, torch.from_numpy(
                pos[:, None].astype(np.int32)), max_len)
        else:
            jm = jmask(jst, jnp.int32(i))
            tm = tcon.step_mask(T_TABLES, tst, i, max_len)
        jm = np.asarray(jm)
        np.testing.assert_array_equal(tm.numpy(), jm)
        tok = np.array([rng.choice(np.flatnonzero(row == 0.0))
                        for row in jm])
        tok = np.where(done, EOS_ID, tok)
        done |= tok == EOS_ID
        jst = jadvance(jst, jnp.asarray(tok, jnp.int32))
        tst = tcon.advance(T_TABLES, tst, torch.from_numpy(tok))
        for got, want in zip(_state_np(tst), _state_np(jst)):
            np.testing.assert_array_equal(got, want)


# the prefixes of JAX's rule tests (tests/test_constrain.py:140-243), each
# with the steps and decode lengths at which its allowed set is read
PREFIXES = [
    ([], [(0, 50), (8, 10), (9, 10)]),
    (["{"], [(1, 50)]),
    (["{", "a", "}"], [(3, 50)]),
    (["\\left", "("], [(2, 50)]),
    (["\\left", "(", "x", "\\right"], [(4, 50)]),
    (["\\left", "(", "x", "\\right", ")"], [(5, 50)]),
    (["\\frac"], [(1, 50)]),
    (["\\frac", "a"], [(2, 50)]),
    (["\\frac", "{", "a", "}", "{", "b", "}"], [(7, 50)]),
    (["x", "^"], [(2, 50)]),
    (["\\begin"], [(1, 50)]),
    (["\\begin", "{"], [(2, 50)]),
    (["\\begin", "{", "matrix"], [(3, 50)]),
    (["\\begin", "{", "matrix", "}", "x", "\\end", "{"], [(7, 50)]),
    (["a", "{"], [(9, 10)]),
    (["x", "^", "{", "\\frac", "a"], [(5, 50)]),
    (["x", "^", "{", "\\frac", "a", "b", "}"], [(7, 50)]),
]


@pytest.mark.parametrize("prefix,reads", PREFIXES,
                         ids=[" ".join(p) or "empty" for p, _ in PREFIXES])
def test_allowed_sets_equal_jax(prefix, reads):
    jst, tst = jcon.init_state(1), tcon.init_state(1)
    for t in prefix:
        jst = jcon.advance(J_TABLES, jst, jnp.asarray([VOCAB[t]], jnp.int32))
        tst = tcon.advance(T_TABLES, tst, torch.tensor([VOCAB[t]]))
    for step, max_len in reads:
        want = np.asarray(jcon.step_mask(J_TABLES, jst, jnp.int32(step),
                                         max_len))[0]
        got = tcon.step_mask(T_TABLES, tst, step, max_len)[0].numpy()
        np.testing.assert_array_equal(got, want)
        assert {IDX2TOK[i] for i in np.flatnonzero(got == 0.0)}


# ---------------------------------------------------------------------------
# constrained decodes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("max_len", [8, 24, 48])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_constrained_random_decode_valid_and_equal_jax(seed, max_len):
    """JAX's property on the port: every constrained decode of a random
    decoder is valid LaTeX by the port's checker; and the tokens are JAX's
    constrained greedy's."""
    cfg, jcfg, tree, memory = _decoder(seed, max_len)
    want = j_greedy_decode(_j(tree), jcfg, jnp.asarray(memory), max_len,
                           constraint=J_TABLES)
    params = convert.to_torch(tree, cfg, "cpu")
    got = greedy_decode(params, cfg, torch.from_numpy(memory), max_len,
                        constraint=T_TABLES)
    n = got.tokens.shape[1]
    np.testing.assert_array_equal(got.tokens.numpy(),
                                  np.asarray(want.tokens)[:, :n])
    assert (np.asarray(want.tokens)[:, n:] == PAD_ID).all()
    np.testing.assert_array_equal(got.token_count.numpy(),
                                  np.asarray(want.token_count))
    np.testing.assert_allclose(got.logprob_sum.numpy(),
                               np.asarray(want.logprob_sum), atol=LP_TOL)
    for row in got.tokens:
        ok, errs = check_latex(detok(row))
        assert ok, (seed, max_len, detok(row), errs)


def test_unconstrained_random_decodes_are_often_invalid():
    """The property has teeth: the same decoders without the mask emit
    invalid LaTeX."""
    invalid = 0
    for seed in range(3):
        cfg, _, tree, memory = _decoder(seed, 24)
        res = greedy_decode(convert.to_torch(tree, cfg, "cpu"), cfg,
                            torch.from_numpy(memory), 24)
        invalid += sum(not check_latex(detok(r))[0] for r in res.tokens)
    assert invalid > 0


def test_constraint_noop_on_plain_vocab():
    """Without structural tokens (and with the banned specials never
    preferred) the mask never acts: constrained equals unconstrained."""
    vocab = make_vocab(PLAIN_TOKENS)
    cfg = tcfg.ModelConfig(d_model=32, nhead=4, dim_feedforward=64,
                           dropout=0.0, num_decoder_layers=2, max_seq_len=16,
                           vocab_size=len(vocab), dtype="float32")
    tree = jax.tree_util.tree_map(np.array, jdec.init_decoder_params(
        jax.random.PRNGKey(7), jax_config(cfg)))
    tree["fc_out"]["b"][[PAD_ID, SOS_ID, 3]] = -1e4
    params = convert.to_torch(tree, cfg, "cpu")
    memory = torch.from_numpy(np.random.default_rng(7).standard_normal(
        (4, 5, cfg.d_model)).astype(np.float32))
    plain = greedy_decode(params, cfg, memory, 16)
    cons = greedy_decode(params, cfg, memory, 16,
                         constraint=tcon.build_tables(vocab))
    assert torch.equal(plain.tokens, cons.tokens)
    torch.testing.assert_close(plain.logprob_sum, cons.logprob_sum)


@pytest.mark.parametrize("variant", ["v1", "v2", "v2m"])
def test_fused_constrained_equals_default(variant):
    """JAX ``test_constrain.py:245`` on the port: the fused greedy's
    constrained tokens equal the default route's (and are valid)."""
    cfg, _, tree, memory = _decoder(3, 24)
    params = convert.to_torch(tree, cfg, "cpu")
    mem = torch.from_numpy(memory[:4])
    want = greedy_decode(params, cfg, mem, 24, constraint=T_TABLES)
    got = greedy_decode_fused(params, build_stacked(tree, cfg, "cpu"), cfg,
                              mem, 24, variant=variant, constraint=T_TABLES)
    assert torch.equal(got.tokens, want.tokens)
    torch.testing.assert_close(got.logprob_sum, want.logprob_sum,
                               atol=LP_TOL, rtol=0)
    for row in got.tokens:
        assert check_latex(detok(row))[0], detok(row)


@pytest.mark.parametrize("variant", ["v3", "v4", "v5"])
def test_fused_constrained_refused_where_jax_refuses(variant):
    from handwritten_math_ocr_api_tpu.decode.fused import (
        greedy_decode_fused as j_greedy_decode_fused,
    )

    cfg, jcfg, tree, memory = _decoder(3, 8)
    with pytest.raises(NotImplementedError, match="argmax in"):
        j_greedy_decode_fused(_j(tree), {}, jcfg, jnp.asarray(memory), 8,
                              variant=variant, constraint=J_TABLES)
    with pytest.raises(NotImplementedError, match="argmax in the kernel"):
        greedy_decode_fused(convert.to_torch(tree, cfg, "cpu"), {}, cfg,
                            torch.from_numpy(memory), 8, variant=variant,
                            constraint=T_TABLES)


# ---------------------------------------------------------------------------
# engines and continuous batching
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def model():
    """The engines' weights (nonzero biases and norms, the eos logit
    raised so that rows end at different steps), images and JAX's
    constrained engine results."""
    params, _ = init_model(jax.random.PRNGKey(2), ENGINE_JCFG)
    tree = jitter(params, seed=5)
    tree["decoder"]["fc_out"]["b"][EOS_ID] += 1.0
    rng = np.random.default_rng(1)
    images = rng.standard_normal((6, 96, 320, 1)).astype(np.float32)
    jeng = JEngine(_j(tree), {}, ENGINE_JCFG,
                   JDecodeConfig(max_seq_len=20, batch_buckets=(8,)),
                   JTokenizer(VOCAB), constrained=True)
    want = jeng.predict_with_confidence(images)
    return tree, images, want


def _engine(tree, **kw):
    return tapi.DecodeEngine(tree, ENGINE_CFG,
                             DecodeConfig(max_seq_len=20, batch_buckets=(8,)),
                             Tokenizer(VOCAB), constrained=True,
                             device="cpu", **kw)


def _same_results(got, want):
    assert [g[0] for g in got] == [w[0] for w in want]
    conf = max(abs(g[1] - w[1]) for g, w in zip(got, want))
    assert conf < CONF_TOL, conf


FUSED = {"use_fused": True, "pallas_encoder_block": True}


@pytest.mark.parametrize("route", ["default", "fused"])
def test_engine_constrained_equals_jax(model, route):
    tree, images, want = model
    got = _engine(tree, **(FUSED if route == "fused" else {}))
    results = got.predict_with_confidence(images)
    _same_results(results, want)
    for formula, _ in results:
        if formula != tapi.EMPTY_RESULT_FALLBACK:
            assert check_latex(formula)[0], formula
    # beam search ignores the constraint, as in JAX
    plain = _engine(tree).decode_tokens(images, beam_size=2)
    unconstrained = tapi.DecodeEngine(
        tree, ENGINE_CFG, DecodeConfig(max_seq_len=20, batch_buckets=(8,)),
        Tokenizer(VOCAB), device="cpu").decode_tokens(images, beam_size=2)
    assert torch.equal(plain.tokens, unconstrained.tokens)


def test_engine_constrained_requires_tokenizer():
    with pytest.raises(ValueError, match="tokenizer"):
        tapi.DecodeEngine({}, cfg_for(8)[0], constrained=True, device="cpu")
    with pytest.raises(ValueError, match="tokenizer"):
        tcont.ContinuousDecoder({}, cfg_for(8)[0], None, constrained=True,
                                device="cpu")


@pytest.mark.parametrize("route,ring", [("default", False), ("fused", True),
                                        ("fused", False)])
def test_continuous_constrained_equals_jax(model, route, ring):
    """``ContinuousDecoder(constrained=True)`` against JAX's on the same
    route (ring on and off on the fused one): every result equal, and each
    equal to the constrained engine's. 3 slots and segments of 4 steps:
    admissions land mid-flight and slots are reused."""
    tree, images, want = model
    kw = dict(num_slots=3, segment_steps=4, encode_buckets=(1, 2),
              constrained=True)
    fused = route == "fused"
    if fused:
        kw.update(use_fused=True, segment_ring=ring)
    jdec_ = jcont.ContinuousDecoder(_j(tree), {}, ENGINE_JCFG,
                                    JTokenizer(VOCAB), **kw)
    jres = jdec_.run_all(images)
    jdec_.close()
    dec = tcont.ContinuousDecoder(tree, ENGINE_CFG, Tokenizer(VOCAB),
                                  device="cpu", **kw)
    got = dec.run_all(images)
    dec.close()
    _same_results(got, jres)
    _same_results(got, want)
