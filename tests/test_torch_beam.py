"""Beam search of the port against the JAX package's, on both routes.

The default route's ``beam_decode`` (the cache-append attention step) and
the fused route's ``beam_decode_fused`` (the ragged step with its logits,
then the beam cache reorder), each module of the slice and the engine's
``beam_size`` surfaces. On the CPU the port's wrappers run their plain
versions; the JAX kernels run in Pallas interpret mode. The decoder is
``tests/test_fused.py``'s (d_model 32, 4 heads, 2 layers, T 12, vocab 20,
float32) with every bias and LayerNorm parameter nonzero; inputs are made
with numpy from a seed.

Tolerances: tokens and lengths exactly; beam scores (sums of up to 12
float32 log-probs, taken in other orders) at atol 5e-3 and rtol 2e-3, the
bound of the JAX package's own fused-beam test; the ragged step's logits,
log-probs and fresh rows at 1e-5 (float32 sums over at most 64 terms in
different orders, then LayerNorm); the cache reorder exactly (a copy).
"""

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
from handwritten_math_ocr_api_tpu.decode.api import DecodeEngine as JEngine
from handwritten_math_ocr_api_tpu.decode.beam import beam_decode as j_beam
from handwritten_math_ocr_api_tpu.decode.fused import (
    beam_decode_fused as j_beam_fused,
    init_fused_cache as j_init_fused_cache,
)
from handwritten_math_ocr_api_tpu.ops.beam_reorder import (
    beam_cache_gather as j_beam_cache_gather,
)
from handwritten_math_ocr_api_tpu.ops.fused_step import (
    build_stacked_full as j_build_stacked_full,
    fused_ragged_step as j_ragged_step,
)

from handwritten_math_ocr_api_torch import convert
from handwritten_math_ocr_api_torch.core.config import DecodeConfig
from handwritten_math_ocr_api_torch.core.tokenizer import Tokenizer
from handwritten_math_ocr_api_torch.decode import api as tapi
from handwritten_math_ocr_api_torch.decode import beam as tbeam
from handwritten_math_ocr_api_torch.decode import fused as tfused
from handwritten_math_ocr_api_torch.ops import beam_reorder as tre
from handwritten_math_ocr_api_torch.ops import fused_step as tstep

from test_torch_decode import BUCKETS, VOCAB
from test_torch_fused import (
    DEC_CFG,
    DEC_JCFG,
    _engine_tree,
    _j,
    _t,
    decoder,  # noqa: F401  (a fixture)
    jax_config,
)
from test_torch_models import CFG, JCFG

SCORE_ATOL, SCORE_RTOL = 5e-3, 2e-3
STEP_TOL = 1e-5


def _memory(B, seed=0):
    return np.random.default_rng(seed).standard_normal(
        (B, 6, DEC_CFG.d_model)).astype(np.float32)


def _check_beams(got, want):
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(want.tokens))
    np.testing.assert_array_equal(got.lengths.numpy(),
                                  np.asarray(want.lengths))
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores),
                               atol=SCORE_ATOL, rtol=SCORE_RTOL)


def test_top_k_puts_the_lower_index_first_among_ties():
    """Forced ties, as at step 0 where every dead beam's candidates round
    to NEG_INF: the ranking equals ``jax.lax.top_k``'s."""
    x = np.array([[0.5, 1.0, 1.0, -1e9, 1.0, 0.5, -1e9, 2.0],
                  [-1e9, -1e9, -1e9, 3.0, -1e9, 3.0, 3.0, -1e9]],
                 np.float32)
    want_v, want_i = jax.lax.top_k(jnp.asarray(x), 6)
    got_v, got_i = tbeam.top_k_lower_index_first(_t(x), 6)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))


@pytest.mark.parametrize("beam", [2, 3, 5])
@pytest.mark.parametrize("B", [1, 2, 7])
def test_beam_decode_matches_jax(decoder, beam, B):
    """The default route's beam (B*K = 5 and 35 among the cases)."""
    memory = _memory(B, seed=B)
    want = j_beam(_j(decoder), DEC_JCFG, jnp.asarray(memory),
                  beam_size=beam)
    tparams = convert.to_torch(decoder, DEC_CFG, "cpu")
    got = tbeam.beam_decode(tparams, DEC_CFG, _t(memory), beam)
    _check_beams(got, want)
    assert 1 <= got.steps <= DEC_CFG.max_seq_len


def test_beam_decode_length_normalization_matches_jax(decoder):
    """alpha > 0 acts at the final choice of the best beam only."""
    memory = _memory(3, seed=4)
    tparams = convert.to_torch(decoder, DEC_CFG, "cpu")
    for alpha in (0.0, 0.7):
        want = j_beam(_j(decoder), DEC_JCFG, jnp.asarray(memory),
                      beam_size=4, alpha=alpha)
        got = tbeam.beam_decode(tparams, DEC_CFG, _t(memory), 4,
                                alpha=alpha)
        _check_beams(got, want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_build_stacked_full_matches_jax(decoder, dtype):
    """The JAX bundle pads the vocabulary to 128 lanes (head bias -1e9
    there) and the positions to 8 rows; the port's keeps V and T, equal
    to the JAX tables' unpadded part."""
    cfg = DEC_CFG.replace(dtype=dtype)
    want = j_build_stacked_full(_j(decoder), jax_config(cfg))
    got = tstep.build_stacked_full(decoder, cfg)
    assert sorted(got) == sorted(want)
    V, T = cfg.vocab_size, cfg.max_seq_len
    cut = {"emb": np.s_[:V], "pos_emb": np.s_[:T], "w_head": np.s_[:, :V],
           "b_head": np.s_[:, :V]}
    for key, w in want.items():
        g = got[key]
        w = np.asarray(w.astype(jnp.float32))[cut.get(key, np.s_[:])]
        if key in cut:
            assert g.dtype == torch.float32, key
        assert tuple(g.shape) == w.shape, key
        np.testing.assert_array_equal(g.float().numpy(), w, key)
    assert np.all(np.asarray(want["b_head"])[0, V:] == -1e9)


@pytest.mark.parametrize("return_logits", [True, False])
def test_ragged_step_plain_matches_pallas(decoder, return_logits):
    """R = 16 rows at ragged positions (first slot, last slot, and between)
    over caches of random rows; the kernel reads the slots before each
    row's position and nothing after. JAX's cross K/V are padded from 6 to
    16 slots that its kernel masks; the port's are not padded."""
    rng = np.random.default_rng(5)
    L, R, T, D = 2, 16, 12, 32
    memory = rng.standard_normal((R, 6, D)).astype(np.float32)
    _, _, ck, cv = j_init_fused_cache(_j(decoder), DEC_JCFG,
                                      jnp.asarray(memory))
    sk, sv = (rng.standard_normal((L, R, T, D)).astype(np.float32)
              for _ in range(2))
    prev = rng.integers(0, DEC_CFG.vocab_size, R).astype(np.int32)
    pos = np.array([0, 11, 5, 3, 0, 7, 11, 1, 2, 9, 4, 6, 8, 10, 3, 5],
                   np.int32)
    want = j_ragged_step(j_build_stacked_full(_j(decoder), DEC_JCFG),
                         DEC_JCFG, jnp.asarray(prev), jnp.asarray(pos),
                         jnp.asarray(sk), jnp.asarray(sv), ck, cv,
                         l_enc_actual=6, return_logits=return_logits,
                         interpret=True)
    stacked = tstep.build_stacked_full(decoder, DEC_CFG)
    before = tstep.fused_ragged_step.launches
    got = tstep.fused_ragged_step(
        stacked, DEC_CFG, _t(prev), _t(pos), _t(sk), _t(sv),
        _t(ck[:, :, :6]), _t(cv[:, :, :6]), return_logits=return_logits)
    assert tstep.fused_ragged_step.launches == before  # CPU: no kernel
    if return_logits:
        np.testing.assert_allclose(
            got[0].numpy(), np.asarray(want[0])[:, :DEC_CFG.vocab_size],
            atol=STEP_TOL, rtol=STEP_TOL)
    else:
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
        assert got[0].dtype == torch.int32
        np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]),
                                   atol=STEP_TOL, rtol=STEP_TOL)
    for g, w in zip(got[-2:], want[-2:]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=STEP_TOL,
                                   rtol=STEP_TOL)


def test_ragged_step_plain_refuses_positions_outside_the_cache(decoder):
    stacked = tstep.build_stacked_full(decoder, DEC_CFG)
    sk = torch.zeros(2, 2, 12, 32)
    ck = torch.zeros(2, 2, 6, 32)
    with pytest.raises(ValueError, match="outside the cache"):
        tstep.fused_ragged_step(stacked, DEC_CFG,
                                torch.zeros(2, dtype=torch.int32),
                                torch.tensor([3, 12], dtype=torch.int32),
                                sk, sk, ck, ck)


@pytest.mark.parametrize("t_ext", [5, 12])
def test_beam_cache_gather_plain_matches_pallas(t_ext):
    rng = np.random.default_rng(t_ext)
    L, R, T, D = 2, 6, 12, 32
    sk, sv = (rng.standard_normal((L, R, T, D)).astype(np.float32)
              for _ in range(2))
    src = np.array([2, 2, 0, 5, 1, 2], np.int32)
    want = j_beam_cache_gather(jnp.asarray(sk), jnp.asarray(sv),
                               jnp.asarray(src), t_ext, interpret=True)
    before = tre.beam_cache_gather.launches
    got = tre.beam_cache_gather(_t(sk), _t(sv), _t(src), t_ext)
    assert tre.beam_cache_gather.launches == before
    for g, w in zip(got, want):
        assert tuple(g.shape) == (L, R, t_ext, D)
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    # into a preallocated pair: the prefix written, the rest untouched
    out = (torch.full((L, R, T, D), 7.0), torch.full((L, R, T, D), 7.0))
    res = tre.beam_cache_gather(_t(sk), _t(sv), _t(src), t_ext, out=out)
    assert res[0] is out[0] and res[1] is out[1]
    for g, w in zip(out, want):
        np.testing.assert_array_equal(g[:, :, :t_ext].numpy(), np.asarray(w))
        assert bool((g[:, :, t_ext:] == 7.0).all())


def test_beam_cache_gather_refuses_bad_rows_and_aliasing():
    sk = torch.zeros(2, 3, 4, 8)
    with pytest.raises(ValueError, match="outside"):
        tre.beam_cache_gather(sk, sk.clone(),
                              torch.tensor([0, 3, 1], dtype=torch.int32), 4)
    with pytest.raises(ValueError, match="outside"):
        tre.beam_cache_gather(sk, sk.clone(),
                              torch.tensor([0, -1, 1], dtype=torch.int32), 4)
    with pytest.raises(ValueError, match="never in place"):
        tre.beam_cache_gather(sk, sk.clone(),
                              torch.tensor([0, 1, 1], dtype=torch.int32), 4,
                              out=(sk, torch.zeros_like(sk)))


def test_beam_decode_fused_matches_jax_fused_and_unfused(decoder):
    memory = _memory(2, seed=6)
    jparams = _j(decoder)
    want = j_beam_fused(jparams, j_build_stacked_full(jparams, DEC_JCFG),
                        DEC_JCFG, jnp.asarray(memory), beam_size=3,
                        interpret=True)
    tparams = convert.to_torch(decoder, DEC_CFG, "cpu")
    stacked = tstep.build_stacked_full(decoder, DEC_CFG)
    got = tfused.beam_decode_fused(tparams, stacked, DEC_CFG, _t(memory), 3)
    _check_beams(got, want)
    unfused = tbeam.beam_decode(tparams, DEC_CFG, _t(memory), 3)
    np.testing.assert_array_equal(got.tokens.numpy(), unfused.tokens.numpy())
    assert got.steps == unfused.steps
    with pytest.raises(ValueError, match="build_stacked_full"):
        tfused.beam_decode_fused(tparams, tstep.build_stacked(decoder,
                                                              DEC_CFG),
                                 DEC_CFG, _t(memory), 3)


@pytest.mark.parametrize("route", ["pallas", "fused"])
def test_engine_beam_matches_jax_engine(route):
    """The whole slice: the JAX engine (``use_pallas=True``, and on the
    fused route ``use_fused`` + ``pallas_encoder_block``, encoder LN1
    biases zero where the reference's block kernel computes swin_block's
    function) against the port's engine with ``beam_size=3``, a batch of
    3 images padded to the bucket of 4."""
    fused = route == "fused"
    tree = _engine_tree(zero_ln1_bias=fused)
    images = np.random.default_rng(12).integers(
        0, 256, (3, CFG.img_h, CFG.img_w, 1), dtype=np.uint8)
    jax_engine = JEngine(_j(tree), {}, JCFG,
                         JDecodeConfig(max_seq_len=CFG.max_seq_len,
                                       batch_buckets=BUCKETS),
                         JTokenizer(VOCAB), use_pallas=True,
                         use_fused=fused, pallas_encoder_block=fused)
    engine = tapi.DecodeEngine(
        tree, CFG, DecodeConfig(max_seq_len=CFG.max_seq_len,
                                batch_buckets=BUCKETS),
        Tokenizer(VOCAB), use_fused=fused, pallas_encoder_block=fused,
        device="cpu")
    want = jax_engine.decode_tokens(images, beam_size=3)
    got = engine.decode_tokens(images, beam_size=3)
    assert got.tokens.shape[0] == 3
    _check_beams(got, want)
    assert engine.last_steps == got.steps
    assert (engine.predict_batch(images, beam_size=3)
            == jax_engine.predict_batch(images, beam_size=3))
    # predict_single stays greedy, as the JAX engine's does
    assert (engine.predict_single(images[0], beam_size=3)[0]
            == jax_engine.predict_single(images[0], beam_size=3)[0])
    engine.warmup((1,), beam_sizes=(2,), dtype=np.uint8)


@pytest.mark.slow
def test_serving_model_r4_beam_matches_jax():
    """The shipped weights on the first ``data_eval_hard`` test images,
    float32: the port engine's beam tokens (beam 3) on both routes against
    JAX ``beam_decode`` on JAX's encoder memory. Skips where the checkpoint
    or the images are absent."""
    import glob

    from handwritten_math_ocr_api_tpu.models import model as jmodel
    from handwritten_math_ocr_api_tpu.train.checkpoint import (
        load_params_for_serving,
    )

    from handwritten_math_ocr_api_torch.core.config import load_model_config
    from handwritten_math_ocr_api_torch.data.preprocess import (
        load_image_cv2,
        normalize,
    )
    from test_torch_serving_model import MODEL_DIR, REPO

    paths = sorted(glob.glob(os.path.join(
        REPO, "data_eval_hard", "test_formulas", "*.png")))[:3]
    if not os.path.isdir(os.path.join(MODEL_DIR, "params")) or not paths:
        pytest.skip("serving_model_r4 checkpoint or test images absent")
    params, state, vocab, idx2char, jcfg = load_params_for_serving(MODEL_DIR)
    jcfg = jcfg.replace(dtype="float32")
    cfg = load_model_config(MODEL_DIR).replace(dtype="float32")
    images = np.stack([load_image_cv2(p, cfg.img_h, cfg.img_w)
                       for p in paths])[..., None]
    memory, _ = jmodel.encode(params, state, jcfg,
                              jnp.asarray(normalize(images)))
    want = j_beam(params["decoder"], jcfg, memory, beam_size=3)
    np_params = jax.tree_util.tree_map(np.array, params)
    for route in ({}, {"use_fused": True, "pallas_encoder_block": True}):
        engine = tapi.DecodeEngine(np_params, cfg, device="cpu", **route)
        got = engine.decode_tokens(images, beam_size=3)
        np.testing.assert_array_equal(got.tokens.numpy(),
                                      np.asarray(want.tokens))
