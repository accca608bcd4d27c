"""Grouped self-attention (``nhead_kv``) through the port's decode engine,
against the JAX package's engine.

The engine on both routes, greedy and beam 5, float and int8, against the
JAX engine on the same tree: MQA (``nhead_kv=1``) on the default and the
fused route, GQA-2 (``nhead_kv=2`` of 4 heads) on the default route, and a
GQA ``use_fused`` engine, which warns and decodes on the default route as
JAX's does. The model is ``tests/test_torch_models.py``'s (Swin encoder,
d_model 32, 4 heads, 2 decoder layers) with every bias and LayerNorm
parameter nonzero, at ``tests/test_torch_mqa.py``'s KV-head counts; the
rest of the grouped-attention tests are in that file.

Tolerances: log-prob sums at 1e-4; beam scores at
``tests/test_torch_beam.py``'s 5e-3 / 2e-3; tokens and strings exactly.
"""

import logging

import numpy as np
import pytest
import torch

import jax

from handwritten_math_ocr_api_tpu.core.config import (
    DecodeConfig as JDecodeConfig,
)
from handwritten_math_ocr_api_tpu.core.tokenizer import Tokenizer as JTokenizer
from handwritten_math_ocr_api_tpu.decode.api import DecodeEngine as JEngine
from handwritten_math_ocr_api_tpu.models import model as jmodel

from handwritten_math_ocr_api_torch.core.config import DecodeConfig
from handwritten_math_ocr_api_torch.core.tokenizer import Tokenizer
from handwritten_math_ocr_api_torch.decode import api as tapi

from test_torch_beam import SCORE_ATOL, SCORE_RTOL
from test_torch_decode import BUCKETS, VOCAB
from test_torch_fused import _j, jitter
from test_torch_models import CFG
from test_torch_mqa import _cfgs


def _engine_tree(nhead_kv, zero_ln1_bias):
    jcfg = _cfgs(nhead_kv, CFG)[1]
    jparams, _ = jax.jit(lambda k: jmodel.init_model(k, jcfg))(
        jax.random.PRNGKey(80 + nhead_kv))
    tree = jitter(jparams, seed=80 + nhead_kv)
    if zero_ln1_bias:
        for stage in tree["encoder"]["stages"]:
            for blk in stage["blocks"]:
                blk["norm1"]["bias"][:] = 0.0
    return tree


def _engines(nhead_kv, fused, quantize):
    cfg, jcfg = _cfgs(nhead_kv, CFG)
    tree = _engine_tree(nhead_kv, zero_ln1_bias=fused)
    jax_engine = JEngine(_j(tree), {}, jcfg,
                         JDecodeConfig(max_seq_len=CFG.max_seq_len,
                                       batch_buckets=BUCKETS),
                         JTokenizer(VOCAB), use_pallas=True,
                         quantize=quantize, use_fused=fused,
                         pallas_encoder_block=fused)
    engine = tapi.DecodeEngine(
        tree, cfg, DecodeConfig(max_seq_len=CFG.max_seq_len,
                                batch_buckets=BUCKETS),
        Tokenizer(VOCAB), use_fused=fused, pallas_encoder_block=fused,
        quantize=quantize, device="cpu")
    return jax_engine, engine


def _check_engines(jax_engine, engine, seed):
    """Greedy (decode_tokens, predict_batch, predict_single) and beam-5
    tokens of 3 images padded to the bucket of 4."""
    images = np.random.default_rng(seed).integers(
        0, 256, (3, CFG.img_h, CFG.img_w, 1), dtype=np.uint8)
    want = jax_engine.decode_tokens(images)
    got = engine.decode_tokens(images)
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(want.tokens))
    np.testing.assert_allclose(got.logprob_sum.numpy(),
                               np.asarray(want.logprob_sum), atol=1e-4,
                               rtol=1e-4)
    assert engine.predict_batch(images) == jax_engine.predict_batch(images)
    assert (engine.predict_single(images[0])[0]
            == jax_engine.predict_single(images[0])[0])
    want = jax_engine.decode_tokens(images, beam_size=5)
    got = engine.decode_tokens(images, beam_size=5)
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(want.tokens))
    np.testing.assert_array_equal(got.lengths.numpy(),
                                  np.asarray(want.lengths))
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores),
                               atol=SCORE_ATOL, rtol=SCORE_RTOL)


@pytest.mark.parametrize("quantize", [False, True])
@pytest.mark.parametrize("nhead_kv,route", [(1, "default"), (1, "fused"),
                                            (2, "default")])
def test_engine_matches_jax_engine(nhead_kv, route, quantize):
    """The whole slice in float32: the JAX engine (``use_pallas=True``,
    and on the fused route ``use_fused`` + ``pallas_encoder_block``,
    encoder LN1 biases zero where the reference's block kernel computes
    swin_block's function) against the port's with the same options. MQA
    on the fused route takes the stacked bundle (int8 with ``quantize``);
    the default route the decoder tree (int8 with ``quantize``)."""
    fused = route == "fused"
    jax_engine, engine = _engines(nhead_kv, fused, quantize)
    assert engine.use_fused == fused
    if fused:
        kvd = nhead_kv * CFG.head_dim
        assert tuple(engine.stacked["w_qkv"].shape[1:]) == (
            CFG.d_model, CFG.d_model + 2 * kvd)
        assert (engine.stacked["w_qkv"].dtype == torch.int8) == quantize
    _check_engines(jax_engine, engine, 90 + nhead_kv)


@pytest.mark.parametrize("quantize", [False, True])
def test_engine_gqa_use_fused_falls_back_as_jax(caplog, quantize):
    """GQA-2 with ``use_fused``: both engines warn and decode on the
    default route (with ``quantize``, its int8 decoder tree, the rule
    applied before the bundle is chosen), and their tokens agree."""
    with caplog.at_level(logging.WARNING):
        jax_engine, engine = _engines(2, True, quantize)
    warned = [r for r in caplog.records if "GQA" in r.getMessage()]
    assert {r.name for r in warned} == {
        "handwritten_math_ocr_api_tpu.decode.api",
        "handwritten_math_ocr_api_torch.decode.api"}
    assert not engine.use_fused and engine.stacked is None
    assert not jax_engine.use_fused
    sa = engine.params["decoder"]["layers"][0]["self_attn"]
    assert ("w_qkv_q" in sa) == quantize
    _check_engines(jax_engine, engine, 95)
