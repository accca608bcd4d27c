"""The whole slice: the JAX ``DecodeEngine(use_pallas=True)`` against the
port's ``DecodeEngine(device="cpu")`` on the same weights and images.

Small model (as in test_torch_models), float32, uint8 images (both engines
normalize them on the device) in a batch of 3 that both pad to the bucket
of 4. Three versions of the weights move the end-of-sequence logit, so that
the runs cover rows that never finish, rows that finish at different steps,
and rows that finish at the first step (the fallback string). Tokens,
lengths and counts must be equal; log-prob sums and confidences agree to
1e-4 (float32 sums over at most 12 steps, taken in different orders); the
strings must be equal.
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
from handwritten_math_ocr_api_tpu.decode.api import DecodeEngine as JEngine
from handwritten_math_ocr_api_tpu.models import model as jmodel

from handwritten_math_ocr_api_torch.core.config import EOS_ID, DecodeConfig
from handwritten_math_ocr_api_torch.core.tokenizer import Tokenizer
from handwritten_math_ocr_api_torch.decode import api as tapi
from handwritten_math_ocr_api_torch.models import decoder as tdec
from handwritten_math_ocr_api_torch.models import model as tmodel

from test_torch_models import CFG, JCFG
import torch_threads  # noqa: F401  (one CPU thread: see the module)

BUCKETS = (1, 2, 4)
VOCAB = {t: i for i, t in enumerate(
    ["<pad>", "<sos>", "<eos>", "<unk>", "x", "y", "2", "+", "=", "{", "}",
     "^", "_", r"\frac", r"\begin", r"\end", "a", "b", "matrix", r"\\"])}


@pytest.fixture(scope="module")
def base():
    jparams, _ = jax.jit(lambda k: jmodel.init_model(k, JCFG))(
        jax.random.PRNGKey(3))
    np_tree = jax.tree_util.tree_map(np.array, jparams)
    rng = np.random.default_rng(11)
    images = rng.integers(0, 256, (3, CFG.img_h, CFG.img_w, 1),
                          dtype=np.uint8)
    jax_engine = JEngine(jparams, {}, JCFG,
                         JDecodeConfig(max_seq_len=CFG.max_seq_len,
                                       batch_buckets=BUCKETS),
                         JTokenizer(VOCAB), use_pallas=True)
    return np_tree, images, jax_engine


def _eos_gaps(np_tree, images):
    """Per row and step of the unchanged greedy run: how far the eos logit
    lies below the winning one."""
    engine = tapi.DecodeEngine(np_tree, CFG, device="cpu")
    x, B = engine._pad_batch(images)
    with torch.inference_mode():
        memory = tmodel.encode(engine.params, CFG, x)
        cache = tdec.init_cache(engine.params["decoder"], CFG, memory)
        prev = torch.full((x.shape[0],), 1)
        gaps = []
        for t in range(CFG.max_seq_len):
            logits = tdec.decoder_step(engine.params["decoder"], CFG, prev,
                                       t, cache)
            gaps.append((logits.max(-1).values - logits[:, EOS_ID])[:B])
            prev = logits.argmax(-1)
    return torch.stack(gaps, 1).numpy()      # (B, steps)


def _with_eos_boost(np_tree, boost):
    tree = jax.tree_util.tree_map(np.copy, np_tree)
    tree["decoder"]["fc_out"]["b"][EOS_ID] += boost
    return tree


@pytest.mark.parametrize("variant", ["never", "mixed", "at_once"])
def test_engine_matches_jax_pallas_engine(base, variant):
    np_tree, images, jax_engine = base
    if variant == "mixed":
        # between two rows' eos gaps at step 3: the rows end at different
        # steps, some before the last
        gaps = np.sort(_eos_gaps(np_tree, images)[:, 3])
        np_tree = _with_eos_boost(np_tree, float(gaps[0] + gaps[1]) / 2)
    elif variant == "at_once":
        np_tree = _with_eos_boost(np_tree, 1e4)
    jparams = jax.tree_util.tree_map(jnp.asarray, np_tree)
    jax_engine.params = jparams
    engine = tapi.DecodeEngine(
        np_tree, CFG, DecodeConfig(max_seq_len=CFG.max_seq_len,
                                   batch_buckets=BUCKETS),
        Tokenizer(VOCAB), device="cpu")

    want = jax_engine.decode_tokens(images)
    got = engine.decode_tokens(images)
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(want.tokens))
    np.testing.assert_array_equal(got.lengths.numpy(),
                                  np.asarray(want.lengths))
    np.testing.assert_array_equal(got.token_count.numpy(),
                                  np.asarray(want.token_count))
    np.testing.assert_allclose(got.logprob_sum.numpy(),
                               np.asarray(want.logprob_sum),
                               atol=1e-4, rtol=1e-4)
    lengths = got.lengths.numpy()
    if variant == "never":
        assert (lengths == CFG.max_seq_len).all()
        assert got.steps == CFG.max_seq_len
    elif variant == "mixed":
        assert lengths.min() < CFG.max_seq_len and len(set(lengths)) > 1
    else:
        assert (got.token_count.numpy() == 0).all() and got.steps == 1

    assert engine.predict_batch(images) == jax_engine.predict_batch(images)
    for (t_text, t_conf), (j_text, j_conf) in zip(
            engine.predict_with_confidence(images),
            jax_engine.predict_with_confidence(images)):
        assert t_text == j_text
        assert t_conf == pytest.approx(j_conf, rel=1e-4, abs=1e-6)
    t_text, t_conf = engine.predict_single(images[1])
    j_text, j_conf = jax_engine.predict_single(images[1])
    assert t_text == j_text
    assert t_conf == pytest.approx(j_conf, rel=1e-4, abs=1e-6)
    if variant == "at_once":
        assert t_text == tapi.EMPTY_RESULT_FALLBACK and t_conf == 0.0


def test_float_images_and_warmup(base):
    """float32 images in [-1, 1] take the same path as uint8 ones."""
    np_tree, images, _ = base
    engine = tapi.DecodeEngine(np_tree, CFG,
                               DecodeConfig(max_seq_len=CFG.max_seq_len),
                               Tokenizer(VOCAB), device="cpu")
    engine.warmup((1, 3))
    assert engine.last_steps == CFG.max_seq_len
    floats = images.astype(np.float32) / 255.0 * 2.0 - 1.0
    a = engine.decode_tokens(images)
    b = engine.decode_tokens(floats)
    np.testing.assert_array_equal(a.tokens.numpy(), b.tokens.numpy())
