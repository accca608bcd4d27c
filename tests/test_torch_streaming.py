"""Streamed decoding (``decode/streaming.py``) of the port against the JAX
package's, and the decoder step past the positional table.

The decoder config is ``tests/test_decode.py``'s with T = 10 (d_model 32,
4 heads, 2 layers, FFN 64, vocab 20, float32), so that segments of 3 and 4
(a cache of 12) step past the positional table, where JAX's gather clamps
the position; the engines' config adds the two-stage Swin of
``tests/test_continuous.py``. Weights are JAX's initialisers as numpy trees
with the end-of-sequence logit moved (rows that never end, rows that end
at different steps); inputs are made with numpy from a seed. On the CPU
the port's wrappers run their plain versions.

What is held: ``decoder_step`` at positions 10 and 11 of a 12-slot cache
equal to JAX's (the clamp); ``stream_start``/``stream_segment`` with
segments of 3, 4 and 12 equal to JAX's segment for segment (tokens,
finished flags, counts and log-prob sums, past T included); the engines'
``predict_stream`` on both routes equal to JAX's events, one host read a
segment, and equal to ``predict_single`` on rows that end; and, where
JAX's stream would never end (a model that emits PAD, which is no token of
the stream), the port's ending when its cache is full.

Tolerances: logits at 1e-5 (float32 sums over at most 64 terms, then
LayerNorm); log-prob sums at 1e-5 and confidences at 1e-5 (JAX's
bound); tokens, counts, flags and strings exactly.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from handwritten_math_ocr_api_tpu.core.config import (
    DecodeConfig as JDecodeConfig,
)
from handwritten_math_ocr_api_tpu.core.tokenizer import Tokenizer as JTokenizer
from handwritten_math_ocr_api_tpu.decode import streaming as jstream
from handwritten_math_ocr_api_tpu.decode.api import DecodeEngine as JEngine
from handwritten_math_ocr_api_tpu.models import decoder as jdec
from handwritten_math_ocr_api_tpu.models.model import init_model

from handwritten_math_ocr_api_torch import convert
from handwritten_math_ocr_api_torch.core import config as tcfg
from handwritten_math_ocr_api_torch.core.config import (
    DecodeConfig,
    EOS_ID,
    PAD_ID,
)
from handwritten_math_ocr_api_torch.core.tokenizer import Tokenizer
from handwritten_math_ocr_api_torch.decode import api as tapi
from handwritten_math_ocr_api_torch.decode import streaming as tstream
from handwritten_math_ocr_api_torch.models import decoder as tdec

from test_torch_fused import _j, jitter
from test_torch_models import jax_config
import torch_threads  # noqa: F401  (one CPU thread: see the module)

T = 10
CFG = tcfg.ModelConfig(d_model=32, nhead=4, dim_feedforward=64, dropout=0.0,
                       num_decoder_layers=2, max_seq_len=T, vocab_size=20,
                       dtype="float32")
JCFG = jax_config(CFG)
ENGINE_CFG = CFG.replace(swin=tcfg.SwinConfig(
    embed_dim=8, depths=(1, 1), num_heads=(2, 2), window_size=4,
    stochastic_depth=0.0))
VOCAB = {"<pad>": 0, "<sos>": 1, "<eos>": 2, "<unk>": 3,
         **{f"t{i}": i for i in range(4, 20)}}
TOL = 1e-5


def _decoder(eos_shift):
    tree = jax.tree_util.tree_map(
        np.array, jdec.init_decoder_params(jax.random.PRNGKey(0), JCFG))
    tree["fc_out"]["b"][EOS_ID] += eos_shift
    memory = np.random.default_rng(0).standard_normal(
        (4, 6, CFG.d_model)).astype(np.float32)
    return tree, memory


@pytest.mark.parametrize("pos", [T - 1, T, T + 1])
def test_decoder_step_past_the_positional_table_equals_jax(pos):
    """The repair: ``decoder_step`` at and past ``max_seq_len`` (a stream's
    last segment) takes the table's last row, as JAX's gather clamps."""
    tree, memory = _decoder(0.0)
    rng = np.random.default_rng(pos)
    cache = jdec.init_cache(_j(tree), JCFG, jnp.asarray(memory), max_len=12)
    # fill the slots before pos with random rows, the same in both
    tcache = {}
    for name, v in cache.items():
        a = np.array(v)
        if name.startswith("self_"):
            a[:, :, :pos] = rng.standard_normal(
                a[:, :, :pos].shape).astype(np.float32)
            cache[name] = jnp.asarray(a)
        tcache[name] = torch.from_numpy(a.copy())
    tok = rng.integers(4, 20, 4)
    want, _ = jdec.decoder_step(_j(tree), JCFG, jnp.asarray(tok, jnp.int32),
                                jnp.int32(pos), cache)
    got = tdec.decoder_step(convert.to_torch(tree, CFG, "cpu"), CFG,
                            torch.from_numpy(tok), pos, tcache)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                               rtol=0)


@pytest.mark.parametrize("eos_shift", [-6.0, 0.0, 1.5])
@pytest.mark.parametrize("seg", [3, 4, 12])
def test_stream_segments_equal_jax(seg, eos_shift):
    """JAX ``test_decode.py:296``'s segment lengths against JAX's
    streaming, segment for segment, to the cache's end (past T = 10 with
    segments of 3 and 4): the tokens, the finished flags, the counts and
    the log-prob sums, which keep counting a row still live past T."""
    tree, memory = _decoder(eos_shift)
    jcarry = jstream.stream_start(_j(tree), JCFG, jnp.asarray(memory), T, seg)
    params = convert.to_torch(tree, CFG, "cpu")
    carry = tstream.stream_start(params, CFG, torch.from_numpy(memory), T,
                                 seg)
    cap = -(-T // seg) * seg
    assert carry.cache["self_k_0"].shape[2] == cap
    for _ in range(cap // seg):
        jcarry, jtoks = jstream.stream_segment(_j(tree), JCFG, jcarry, seg)
        carry, toks = tstream.stream_segment(params, CFG, carry, seg)
        np.testing.assert_array_equal(toks.numpy(), np.asarray(jtoks))
        np.testing.assert_array_equal(carry.finished.numpy(),
                                      np.asarray(jcarry.finished))
        np.testing.assert_array_equal(carry.count.numpy(),
                                      np.asarray(jcarry.count))
        np.testing.assert_allclose(carry.lp_sum.numpy(),
                                   np.asarray(jcarry.lp_sum), atol=TOL)
        assert carry.step == int(jcarry.step)
        rep = tstream.stream_report(carry, toks).numpy()
        np.testing.assert_array_equal(rep[:, :seg], toks.numpy())
        np.testing.assert_array_equal(rep[:, seg + 1], carry.count.numpy())
        np.testing.assert_array_equal(rep[:, seg + 2:].view(np.float32)[:, 0],
                                      carry.lp_sum.numpy())


@pytest.fixture(scope="module")
def engines():
    """JAX's engine and the port's two routes on one set of weights (the
    eos logit raised so that most rows end before T), and images."""
    params, _ = init_model(jax.random.PRNGKey(1), jax_config(ENGINE_CFG))
    tree = jitter(params, seed=2)
    tree["decoder"]["fc_out"]["b"][EOS_ID] += 1.0
    # a model that emits PAD never ends JAX's stream (the port's ends when
    # its cache is full: test_stream_of_pad_tokens_ends_at_the_cache)
    tree["decoder"]["fc_out"]["b"][PAD_ID] = -1e4
    images = np.random.default_rng(3).standard_normal(
        (4, 96, 320, 1)).astype(np.float32)
    dcfg = {"max_seq_len": T, "batch_buckets": (1, 4)}
    jeng = JEngine(_j(tree), {}, jax_config(ENGINE_CFG),
                   JDecodeConfig(**dcfg), JTokenizer(VOCAB))
    made = {route: tapi.DecodeEngine(tree, ENGINE_CFG, DecodeConfig(**dcfg),
                                     Tokenizer(VOCAB), device="cpu", **kw)
            for route, kw in (("default", {}),
                              ("fused", {"use_fused": True,
                                         "pallas_encoder_block": True}))}
    return jeng, made, images


@pytest.mark.parametrize("seg", [3, 4, 8])
@pytest.mark.parametrize("route", ["default", "fused"])
def test_engine_predict_stream_equals_jax(engines, route, seg, monkeypatch):
    jeng, made, images = engines
    engine = made[route]
    segments = []

    def counted(*args, **kw):
        segments.append(1)
        return tstream.stream_segment(*args, **kw)

    monkeypatch.setattr(tapi, "stream_segment", counted)
    for img in images:
        want = list(jeng.predict_stream(img, segment_steps=seg))
        reads = engine.stream_reads
        segments.clear()
        got = list(engine.predict_stream(img, segment_steps=seg))
        assert [e for e in got if "tokens" in e] == [
            e for e in want if "tokens" in e]
        assert got[-1]["done"] and got[-1]["formula"] == want[-1]["formula"]
        assert abs(got[-1]["confidence"] - want[-1]["confidence"]) < TOL
        # one host read a segment
        assert engine.stream_reads - reads == len(segments) > 0
        streamed = sum(len(e["tokens"]) for e in got[:-1])
        # on a row that ends, the stream is predict_single's decode
        latex, conf = engine.predict_single(img)
        if streamed < T:
            assert got[-1]["formula"] == latex
            assert abs(got[-1]["confidence"] - conf) < TOL


@pytest.mark.parametrize("seg", [3, 4])
def test_stream_of_pad_tokens_ends_at_the_cache(engines, seg):
    """A model that always emits PAD: JAX's stream loops for ever, the
    port's ends after the cache's ``cap // seg`` segments. The PAD steps
    count as tokens, as in JAX: an empty formula at a confidence of 1."""
    _, made, images = engines
    engine = made["default"]
    dec = engine.params["decoder"]["fc_out"]["b"]
    saved = dec.clone()
    dec[PAD_ID] = 1e4
    try:
        reads = engine.stream_reads
        events = list(engine.predict_stream(images[0], segment_steps=seg))
    finally:
        dec.copy_(saved)
    assert engine.stream_reads - reads == -(-T // seg)
    assert events == [{"formula": "", "done": True,
                       "confidence": pytest.approx(1.0, abs=TOL)}]
