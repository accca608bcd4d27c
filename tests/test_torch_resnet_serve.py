"""The ResNet encoders (``resnet18``, ``res18trans``) served by the port,
against the JAX package's engines on the CPU in float32.

The decode engine's greedy and beam-3 tokens against JAX's
``DecodeEngine`` on ``use_pallas=True``, on ``use_fused=True`` and with
the int8 decoder (JAX's Pallas kernels in interpret mode), each with the
model state; ``ContinuousDecoder`` on both routes against JAX's and the
engine; and an artifact that JAX wrote with the model state, through the
app's loader, its engines in both batching modes, ``predict_stream`` and
``BatchingEngine``. The model and its seeded weights are
``tests/test_torch_resnet.py``'s (2 memory columns: the fused route's
cross K/V are 2 columns wide; at 32x320 the served 10), with the
end-of-sequence bias raised so that rows end after different numbers of
steps.

Tolerances: log-prob sums and confidences within 1e-4 (float32 sums in
another order); tokens and strings exactly.
"""

import numpy as np
import pytest
import torch

from handwritten_math_ocr_api_tpu.core import config as jcfg
from handwritten_math_ocr_api_tpu.core.tokenizer import Tokenizer as JTokenizer
from handwritten_math_ocr_api_tpu.decode import continuous as jcont
from handwritten_math_ocr_api_tpu.decode.api import DecodeEngine as JEngine
from handwritten_math_ocr_api_tpu.train import checkpoint as jckpt

from handwritten_math_ocr_api_torch.core import config as tcfg
from handwritten_math_ocr_api_torch.core.tokenizer import Tokenizer
from handwritten_math_ocr_api_torch.decode import api as tapi
from handwritten_math_ocr_api_torch.decode import continuous as tcont
from handwritten_math_ocr_api_torch.serve.app import ServerState
from handwritten_math_ocr_api_torch.serve.batcher import BatchingEngine
from handwritten_math_ocr_api_torch.train import checkpoint as tckpt

from test_torch_resnet import (
    ENCODERS,
    T,
    VOCAB,
    _images,
    _j,
    _model,
    assert_stats,
    jax_config,
)
import torch_threads  # noqa: F401  (one CPU thread: see the module)

CONF_TOL = 1e-4


BUCKETS = (1, 2, 4)


def _engines(encoder, fused, quantize=False):
    cfg, params, state = _model(encoder, seed=5, boost=True)
    jax_engine = JEngine(_j(params), _j(state), jax_config(cfg),
                         jcfg.DecodeConfig(max_seq_len=T,
                                           batch_buckets=BUCKETS),
                         JTokenizer(VOCAB), use_pallas=True,
                         use_fused=fused, pallas_encoder_block=fused,
                         quantize=quantize)
    engine = tapi.DecodeEngine(
        params, cfg, tcfg.DecodeConfig(max_seq_len=T, batch_buckets=BUCKETS),
        Tokenizer(VOCAB), use_fused=fused, pallas_encoder_block=fused,
        quantize=quantize, model_state=state, device="cpu")
    return jax_engine, engine


@pytest.mark.parametrize("route", ["default", "fused", "fused_int8"])
@pytest.mark.parametrize("encoder", ENCODERS)
def test_engine_matches_jax_engine(encoder, route):
    """Greedy (``decode_tokens``, ``predict_batch``, ``predict_single``,
    log-prob sums within CONF_TOL) and beam-3 tokens of 3 images padded to
    the bucket of 4, against JAX's engine with the same options and model
    state; the cross K/V of the fused route are 2 columns."""
    fused = route != "default"
    jax_engine, engine = _engines(encoder, fused, route == "fused_int8")
    assert engine.model_state["resnet"]["bn1"]["var"].dtype == torch.float32
    images = _images(3, 6)
    want = jax_engine.decode_tokens(images)
    got = engine.decode_tokens(images)
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(want.tokens))
    np.testing.assert_allclose(got.logprob_sum.numpy(),
                               np.asarray(want.logprob_sum), atol=CONF_TOL,
                               rtol=CONF_TOL)
    lengths = got.lengths.numpy()
    assert lengths.min() < T and len(set(lengths.tolist())) > 1
    assert engine.predict_batch(images) == jax_engine.predict_batch(images)
    assert (engine.predict_single(images[0])[0]
            == jax_engine.predict_single(images[0])[0])
    want = jax_engine.decode_tokens(images, beam_size=3)
    got = engine.decode_tokens(images, beam_size=3)
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(want.tokens))
    np.testing.assert_array_equal(got.lengths.numpy(),
                                  np.asarray(want.lengths))


def _same(got, want):
    assert len(got) == len(want)
    for i, ((gl, gc), (wl, wc)) in enumerate(zip(got, want)):
        assert gl == wl, i
        assert abs(gc - wc) < CONF_TOL, i


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("encoder", ENCODERS)
def test_continuous_matches_jax(encoder, fused):
    """Six images through 4 slots: the port's ``ContinuousDecoder`` with
    the model state equals JAX's with the same options, and the port's
    engine on the same route; its slot pool holds 2 cross columns."""
    cfg, params, state = _model(encoder, seed=5, boost=True)
    images = _images(6, 7)
    kw = dict(num_slots=4, segment_steps=3, encode_buckets=(1, 2, 4),
              use_fused=fused)
    want = jcont.ContinuousDecoder(_j(params), _j(state), jax_config(cfg),
                                   JTokenizer(VOCAB), **kw).run_all(
        list(images))
    dec = tcont.ContinuousDecoder(params, cfg, Tokenizer(VOCAB),
                                  model_state=state, device="cpu", **kw)
    cross = dec._shards[0].cache["cross_k" if fused else "cross_k_0"]
    assert cross.shape[-2 if fused else 2] == cfg.encoder_len == 2
    got = dec.run_all(list(images))
    _same(got, want)
    engine = tapi.DecodeEngine(params, cfg, tcfg.DecodeConfig(max_seq_len=T),
                               Tokenizer(VOCAB), use_fused=fused,
                               model_state=state, device="cpu")
    _same(got, engine.predict_with_confidence(images))


def test_stream_and_batcher_and_app_serve_the_state(tmp_path):
    """An artifact that JAX's ``save_params_for_serving`` wrote with the
    model state: the port's loader returns JAX's statistics; the app's
    engine (both batching modes) gives JAX's engine's formulas and
    ``predict_stream`` JAX's stream, the app's continuous decoder JAX's
    continuous decoder's results, and ``BatchingEngine`` the formulas."""
    cfg, params, state = _model("res18trans", seed=5, boost=True)
    out = str(tmp_path / "artifact")
    jckpt.save_params_for_serving(out, _j(params), VOCAB, jax_config(cfg),
                                  model_state=_j(state))
    _, ms, _, _, _ = tckpt.load_params_for_serving(out)
    assert_stats(ms, state, rtol=0)
    images = _images(3, 8)
    # JAX's app serves its XLA path at the default decode length
    jax_engine = JEngine(_j(params), _j(state), jax_config(cfg),
                         jcfg.DecodeConfig(), JTokenizer(VOCAB))
    want = [jax_engine.predict_single(im)[0] for im in images]
    for mode in ("dynamic", "continuous"):
        srv = ServerState(tcfg.ServeConfig(model_dir=out,
                                           batching_mode=mode),
                          device="cpu")
        srv.initialize_model()
        assert_stats(srv.engine.model_state, state, rtol=0)
        assert [srv.engine.predict_single(im)[0] for im in images] == want
        if mode == "continuous":  # decodes at most cfg.max_seq_len
            cont = jcont.ContinuousDecoder(
                _j(params), _j(state), jax_config(cfg), JTokenizer(VOCAB),
                num_slots=4, segment_steps=3, encode_buckets=(1, 2, 4))
            _same(srv.batcher.decoder.run_all(list(images)),
                  cont.run_all(list(images)))
            srv.batcher.decoder.close()
    events = list(srv.engine.predict_stream(images[0], segment_steps=4))
    jax_events = list(jax_engine.predict_stream(images[0], segment_steps=4))
    assert [e.get("tokens") for e in events[:-1]] == [
        e.get("tokens") for e in jax_events[:-1]]
    assert events[-1]["formula"] == jax_events[-1]["formula"]
    import asyncio

    async def run():
        eng = BatchingEngine(srv.engine, max_batch_size=4,
                             batch_timeout_ms=5.0)
        await eng.start()
        try:
            return await asyncio.gather(*(eng.predict(im) for im in images))
        finally:
            await eng.stop()

    assert [r[0] for r in asyncio.run(run())] == want


@pytest.mark.parametrize("route", ["default", "fused"])
def test_engine_at_ten_memory_columns_matches_jax(route):
    """At 32x320 the ResNet memory has the served 10 columns: the
    decoder's cross K/V (and, on the fused route, the plain versions of
    B1 and B7 against JAX's Pallas kernels in interpret mode) at L_enc
    10, greedy and beam-3 tokens equal to JAX's engine."""
    fused = route == "fused"
    cfg, params, state = _model("resnet18", seed=5, boost=True,
                                img_w=320)
    assert cfg.encoder_len == 10
    jax_engine = JEngine(_j(params), _j(state), jax_config(cfg),
                         jcfg.DecodeConfig(max_seq_len=T,
                                           batch_buckets=BUCKETS),
                         JTokenizer(VOCAB), use_pallas=True,
                         use_fused=fused, pallas_encoder_block=fused)
    engine = tapi.DecodeEngine(
        params, cfg, tcfg.DecodeConfig(max_seq_len=T, batch_buckets=BUCKETS),
        Tokenizer(VOCAB), use_fused=fused, pallas_encoder_block=fused,
        model_state=state, device="cpu")
    images = _images(3, 9, cfg)
    for beam in (None, 3):
        want = jax_engine.decode_tokens(images, beam_size=beam)
        got = engine.decode_tokens(images, beam_size=beam)
        np.testing.assert_array_equal(got.tokens.numpy(),
                                      np.asarray(want.tokens))
