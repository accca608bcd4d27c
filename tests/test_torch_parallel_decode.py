"""The port's ``DecodeEngine`` sharded over a mesh's data axis, against the
port's one-device engine and once against the JAX package's engine.

The counterpart of ``tests/test_parallel_decode.py`` (JAX's three ``slow``
cases on its virtual CPU devices), at its tiny config: meshes of 2 and 4
shards on ``["cpu"] * n`` (``parallel/mesh.make_mesh``; the shards share
the host, as JAX's virtual devices do). Greedy on both routes, float and
int8, beam 3 on both routes, sampled and constrained greedy, a stream, and
the bucket rounding. Inputs are made with numpy from a seed.

Tolerances: tokens and strings exactly; confidences, log-prob sums and
beam scores within 1e-4 (JAX's test's: float32 sums over the batch's
other shapes).
"""

import numpy as np
import pytest
import torch

import jax

from handwritten_math_ocr_api_tpu.core.config import (
    DecodeConfig as JDecodeConfig,
    ModelConfig as JModelConfig,
    SwinConfig as JSwinConfig,
)
from handwritten_math_ocr_api_tpu.core.tokenizer import Tokenizer as JTokenizer
from handwritten_math_ocr_api_tpu.decode.api import DecodeEngine as JEngine
from handwritten_math_ocr_api_tpu.models.model import init_model

from handwritten_math_ocr_api_torch.core.config import (
    DecodeConfig,
    ModelConfig,
    SwinConfig,
)
from handwritten_math_ocr_api_torch.core.tokenizer import Tokenizer
from handwritten_math_ocr_api_torch.decode.api import DecodeEngine
from handwritten_math_ocr_api_torch.parallel import mesh as mesh_lib
import torch_threads  # noqa: F401  (one CPU thread: see the module)

_FIELDS = dict(d_model=32, nhead=4, dim_feedforward=64, dropout=0.0,
               num_decoder_layers=2, max_seq_len=10, vocab_size=20,
               dtype="float32")
_SWIN = dict(embed_dim=8, depths=(1, 1), num_heads=(2, 2), window_size=4,
             stochastic_depth=0.0)
CFG = ModelConfig(**_FIELDS, swin=SwinConfig(**_SWIN))
JCFG = JModelConfig(**_FIELDS, swin=JSwinConfig(**_SWIN))
VOCAB = {"<pad>": 0, "<sos>": 1, "<eos>": 2, "<unk>": 3,
         **{f"t{i}": i for i in range(4, CFG.vocab_size)}}
TOL = 1e-4
ROUTES = {"default": {},
          "fused": {"use_fused": True, "pallas_encoder_block": True}}


@pytest.fixture(scope="module")
def params():
    p, _ = init_model(jax.random.PRNGKey(0), JCFG)
    return jax.tree_util.tree_map(np.asarray, p)


def _images(n, seed):
    return np.random.default_rng(seed).standard_normal(
        (n, CFG.img_h, CFG.img_w, 1)).astype(np.float32)


def _engine(params, buckets, data=None, **kw):
    mesh = (None if data is None
            else mesh_lib.make_mesh(data=data, devices=["cpu"] * data))
    return DecodeEngine(params, CFG, DecodeConfig(max_seq_len=10,
                                                  batch_buckets=buckets),
                        Tokenizer(VOCAB), device="cpu", mesh=mesh, **kw)


def _same_pairs(got, want):
    assert [g[0] for g in got] == [w[0] for w in want]
    for (_, gc), (_, wc) in zip(got, want):
        assert abs(gc - wc) < TOL


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("quantize", [False, True])
@pytest.mark.parametrize("data", [2, 4])
def test_sharded_greedy_matches_one_device(params, route, quantize, data):
    images = _images(10, 0)
    kw = {**ROUTES[route], "quantize": quantize}
    single = _engine(params, (16,), **kw)
    sharded = _engine(params, (16,), data, **kw)
    want, got = single.decode_tokens(images), sharded.decode_tokens(images)
    assert torch.equal(got.tokens, want.tokens)
    assert torch.equal(got.token_count, want.token_count)
    torch.testing.assert_close(got.logprob_sum, want.logprob_sum, atol=TOL,
                               rtol=0)
    assert len(sharded.last_shard_steps) == data
    assert sharded.last_steps == max(sharded.last_shard_steps)
    _same_pairs(sharded.predict_with_confidence(images),
                single.predict_with_confidence(images))


@pytest.mark.parametrize("route", ROUTES)
def test_sharded_beam_matches_one_device(params, route):
    images = _images(4, 1)
    single = _engine(params, (4,), **ROUTES[route])
    sharded = _engine(params, (4,), 4, **ROUTES[route])
    want = single.decode_tokens(images, beam_size=3)
    got = sharded.decode_tokens(images, beam_size=3)
    assert torch.equal(got.tokens, want.tokens)
    torch.testing.assert_close(got.scores, want.scores, atol=TOL, rtol=0)
    assert (sharded.predict_batch(images, beam_size=3)
            == single.predict_batch(images, beam_size=3))


def test_sharded_beam_decodes_only_request_rows(params):
    """3 images on 4 shards of 2 rows: the last shard holds padding only
    and decodes nothing."""
    images = _images(3, 2)
    sharded = _engine(params, (8,), 4)
    got = sharded.decode_tokens(images, beam_size=3)
    assert got.tokens.shape[0] == 3 and len(sharded.last_shard_steps) == 2
    want = _engine(params, (8,)).decode_tokens(images, beam_size=3)
    assert torch.equal(got.tokens, want.tokens)


def test_sharded_matches_jax_engine(params):
    images = _images(10, 0)
    jax_engine = JEngine(jax.tree_util.tree_map(jax.numpy.asarray, params),
                         {}, JCFG, JDecodeConfig(max_seq_len=10,
                                                 batch_buckets=(16,)),
                         JTokenizer(VOCAB))
    want = jax_engine.predict_with_confidence(images)
    _same_pairs(_engine(params, (16,), 4).predict_with_confidence(images),
                want)


@pytest.mark.parametrize("route", ROUTES)
def test_sharded_sampling_draws_the_one_device_tokens(params, route):
    images = _images(6, 3)
    kw = {"temperature": 1.5, "top_k": 8, "seed": 5}
    want = _engine(params, (8,), **ROUTES[route]).sample_tokens(images, **kw)
    got = _engine(params, (8,), 2, **ROUTES[route]).sample_tokens(images,
                                                                  **kw)
    assert torch.equal(got.tokens, want.tokens)
    torch.testing.assert_close(got.logprob_sum, want.logprob_sum, atol=TOL,
                               rtol=0)


def test_sharded_constrained_and_stream(params):
    images = _images(5, 4)
    single = _engine(params, (8,), constrained=True)
    sharded = _engine(params, (8,), 2, constrained=True)
    assert torch.equal(sharded.decode_tokens(images).tokens,
                       single.decode_tokens(images).tokens)
    want = list(single.predict_stream(images[0], segment_steps=3))
    got = list(sharded.predict_stream(images[0], segment_steps=3))
    assert [e.get("tokens") for e in got] == [e.get("tokens") for e in want]
    assert got[-1]["formula"] == want[-1]["formula"]
    assert abs(got[-1]["confidence"] - want[-1]["confidence"]) < TOL


def test_bucket_rounding_to_mesh_multiple(params):
    eng = _engine(params, (1, 2, 6), 4)
    assert eng.decode_cfg.batch_buckets == (4, 8)
    out = eng.predict_batch(np.zeros((3, CFG.img_h, CFG.img_w, 1),
                                     np.float32))
    assert len(out) == 3
    assert _engine(params, (1, 2, 6), 2).decode_cfg.batch_buckets == (2, 6)


def test_engine_refuses_what_is_not_a_mesh(params):
    with pytest.raises(TypeError):
        DecodeEngine(params, CFG, tokenizer=Tokenizer(VOCAB), device="cpu",
                     mesh=object())
