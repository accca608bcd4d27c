"""Sampled decoding (``decode/sampling.py``) of the port against the JAX
package's.

The decoder config is ``tests/test_decode.py``'s (d_model 32, 4 heads, 2
layers, FFN 64, T 12, vocab 20, float32); the engines' config adds the
two-stage Swin of ``tests/test_continuous.py`` on 96x320 images. Weights
are JAX's initialisers as numpy trees (the engines' with nonzero biases
and norms); inputs are made with numpy from a seed. On the CPU the port's
wrappers run their plain versions.

What is held: ``filter_logits`` exactly equal to JAX's (top-k and top-p
with ties at the cut, temperatures, masks); the Gumbel-max draw against
``softmax(filtered)`` by a chi-square test of 20,000 seeded draws; a
sampled decode with ``top_k=1`` or a temperature near 0 equal to JAX's
greedy (tokens and counts exactly, log-prob sums at 1e-5, JAX's bound);
seeds that vary the output, and a seed that repeats it; the fused "v1",
"v2" and "v2m" sampled decodes equal to the default route's for one seed
(each step draws the same uniforms), and v3-v5 refused where JAX refuses;
``sample_tokens`` and ``predict_single_sampled`` on both routes.

The port draws from a ``torch.Generator``, not JAX's threefry stream, so
sampled tokens are compared with JAX's only where the draw cannot matter.
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
from handwritten_math_ocr_api_tpu.decode import sampling as jsamp
from handwritten_math_ocr_api_tpu.decode.api import DecodeEngine as JEngine
from handwritten_math_ocr_api_tpu.decode.fused import (
    greedy_decode_fused as j_greedy_decode_fused,
)
from handwritten_math_ocr_api_tpu.decode.greedy import (
    greedy_decode as j_greedy_decode,
)
from handwritten_math_ocr_api_tpu.models import decoder as jdec
from handwritten_math_ocr_api_tpu.models.model import init_model

from handwritten_math_ocr_api_torch import convert
from handwritten_math_ocr_api_torch.core import config as tcfg
from handwritten_math_ocr_api_torch.core.config import DecodeConfig
from handwritten_math_ocr_api_torch.core.tokenizer import Tokenizer
from handwritten_math_ocr_api_torch.decode import api as tapi
from handwritten_math_ocr_api_torch.decode import sampling as tsamp
from handwritten_math_ocr_api_torch.decode.fused import greedy_decode_fused
from handwritten_math_ocr_api_torch.ops.fused_step import build_stacked

from test_torch_fused import _j, jitter
from test_torch_models import jax_config
import torch_threads  # noqa: F401  (one CPU thread: see the module)

CFG = tcfg.ModelConfig(d_model=32, nhead=4, dim_feedforward=64, dropout=0.0,
                       num_decoder_layers=2, max_seq_len=12, vocab_size=20,
                       dtype="float32")
JCFG = jax_config(CFG)
ENGINE_CFG = CFG.replace(swin=tcfg.SwinConfig(
    embed_dim=8, depths=(1, 1), num_heads=(2, 2), window_size=4,
    stochastic_depth=0.0))
VOCAB = {"<pad>": 0, "<sos>": 1, "<eos>": 2, "<unk>": 3,
         **{f"t{i}": i for i in range(4, 20)}}
LP_TOL = 1e-5
CONF_TOL = 1e-5
# chi-square critical value at p = 0.001 for 4 degrees of freedom
CHI2_CRIT_DF4 = 18.467


@pytest.fixture(scope="module")
def setup():
    """JAX's decoder of test_decode.py as a numpy tree, the port's tensors
    of it, and the memory (3, 6, 32)."""
    tree = jax.tree_util.tree_map(
        np.array, jdec.init_decoder_params(jax.random.PRNGKey(0), JCFG))
    rng = np.random.default_rng(0)
    memory = rng.standard_normal((3, 6, CFG.d_model)).astype(np.float32)
    return tree, convert.to_torch(tree, CFG, "cpu"), memory


def _ties(seed):
    """(4, 12) logits on a coarse grid, so that values repeat (ties at the
    top-k and top-p cuts)."""
    rng = np.random.default_rng(seed)
    return (rng.integers(-6, 7, (4, 12)) * 0.5).astype(np.float32)


@pytest.mark.parametrize("kw", [
    {"top_k": 1}, {"top_k": 3}, {"top_k": 5, "temperature": 0.7},
    {"top_k": 40}, {"top_p": 0.5}, {"top_p": 0.9, "temperature": 1.7},
    {"top_p": 1e-6}, {"top_k": 4, "top_p": 0.6}, {"temperature": 2.0},
    {"temperature": 0.0, "top_k": 2}])
@pytest.mark.parametrize("seed", [0, 1])
def test_filter_logits_equal_jax(kw, seed):
    x = _ties(seed)
    want = np.asarray(jsamp.filter_logits(jnp.asarray(x), **kw))
    got = tsamp.filter_logits(torch.from_numpy(x), **kw).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got == -1e30).sum() == (want == -1e30).sum()
    assert (got > -1e29).any(axis=-1).all()  # the argmax survives


def test_gumbel_draw_follows_softmax_of_filtered():
    """20,000 seeded draws of a filtered 8-way distribution: the masked
    entries are never drawn, and the counts of the kept five fit
    softmax(filtered) by a chi-square test at p = 0.001."""
    logits = torch.tensor([[1.2, -0.3, 0.4, 2.0, -1.0, 0.9, 0.1, -2.0]])
    filtered = tsamp.filter_logits(logits, temperature=1.3, top_k=5)
    n = 20000
    gen = torch.Generator().manual_seed(1234)
    draws = tsamp.gumbel_argmax(filtered.expand(n, -1), gen)
    counts = torch.bincount(draws, minlength=8).double()
    kept = filtered[0] > -1e29
    assert counts[~kept].sum() == 0
    p = torch.softmax(filtered[0].double(), dim=-1)
    expected = n * p[kept]
    chi2 = float(((counts[kept] - expected) ** 2 / expected).sum())
    assert chi2 < CHI2_CRIT_DF4, chi2


def _greedy_jax(tree, memory):
    return j_greedy_decode(_j(tree), JCFG, jnp.asarray(memory),
                           CFG.max_seq_len)


def _same(got, want):
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(want.tokens))
    np.testing.assert_array_equal(got.token_count.numpy(),
                                  np.asarray(want.token_count))
    np.testing.assert_allclose(got.logprob_sum.numpy(),
                               np.asarray(want.logprob_sum), atol=LP_TOL)


@pytest.mark.parametrize("kw", [{"top_k": 1, "temperature": 1.7},
                                {"temperature": 1e-5}])
def test_sampled_greedy_limits_equal_jax_greedy(setup, kw):
    """``top_k=1`` keeps only the argmax (and its ties); a temperature of
    1e-5 scales every gap beyond any Gumbel value: the tokens are greedy's,
    the confidence the raw distribution's."""
    tree, params, memory = setup
    gen = torch.Generator().manual_seed(3)
    got = tsamp.sample_decode(params, CFG, torch.from_numpy(memory), gen,
                              CFG.max_seq_len, **kw)
    _same(got, _greedy_jax(tree, memory))


def test_seeds_vary_and_repeat(setup):
    _, params, memory = setup
    mem = torch.from_numpy(memory)

    def run(seed):
        gen = torch.Generator().manual_seed(seed)
        return tsamp.sample_decode(params, CFG, mem, gen, CFG.max_seq_len,
                                   temperature=3.0).tokens

    outs = [run(seed) for seed in range(4)]
    assert any(not torch.equal(outs[0], o) for o in outs[1:])
    assert torch.equal(run(2), outs[2])


@pytest.mark.parametrize("variant", ["v1", "v2", "v2m"])
def test_fused_sampled_equals_default(setup, variant):
    """The fused greedy with ``rng``: one (B, V) draw a step from the same
    generator, so one seed gives the default route's tokens (the logits
    agree to float32 rounding); and with ``top_k=1`` JAX's greedy."""
    tree, params, memory = setup
    mem = torch.from_numpy(memory)
    stacked = build_stacked(tree, CFG, "cpu")
    kw = {"temperature": 1.3, "top_k": 6, "top_p": 0.95}
    want = tsamp.sample_decode(params, CFG, mem,
                               torch.Generator().manual_seed(5),
                               CFG.max_seq_len, **kw)
    got = greedy_decode_fused(params, stacked, CFG, mem, variant=variant,
                              rng=torch.Generator().manual_seed(5), **kw)
    assert torch.equal(got.tokens, want.tokens)
    torch.testing.assert_close(got.logprob_sum, want.logprob_sum,
                               atol=LP_TOL, rtol=0)
    got = greedy_decode_fused(params, stacked, CFG, mem, variant=variant,
                              rng=torch.Generator().manual_seed(9), top_k=1)
    _same(got, _greedy_jax(tree, memory))


@pytest.mark.parametrize("variant", ["v3", "v4", "v5"])
def test_fused_sampled_refused_where_jax_refuses(setup, variant):
    tree, params, memory = setup
    with pytest.raises(NotImplementedError, match="argmax in"):
        j_greedy_decode_fused(_j(tree), {}, JCFG, jnp.asarray(memory),
                              variant=variant, rng=jax.random.PRNGKey(0))
    with pytest.raises(NotImplementedError, match="argmax in the kernel"):
        greedy_decode_fused(params, {}, CFG, torch.from_numpy(memory),
                            variant=variant, rng=torch.Generator())


@pytest.fixture(scope="module")
def engines():
    params, _ = init_model(jax.random.PRNGKey(1), jax_config(ENGINE_CFG))
    tree = jitter(params, seed=3)
    rng = np.random.default_rng(4)
    images = rng.standard_normal((3, 96, 320, 1)).astype(np.float32)
    jeng = JEngine(_j(tree), {}, jax_config(ENGINE_CFG),
                   JDecodeConfig(max_seq_len=12, batch_buckets=(1, 4)),
                   JTokenizer(VOCAB))
    made = {route: tapi.DecodeEngine(
        tree, ENGINE_CFG, DecodeConfig(max_seq_len=12, batch_buckets=(1, 4)),
        Tokenizer(VOCAB), device="cpu", **kw)
        for route, kw in (("default", {}),
                          ("fused", {"use_fused": True,
                                     "pallas_encoder_block": True}))}
    return jeng, made, images


@pytest.mark.parametrize("route", ["default", "fused"])
def test_engine_sampling_surfaces(engines, route):
    """JAX's ``test_engine_sampling_surfaces`` on the port: the result
    trimmed to the batch; ``top_k=1`` equal to JAX's ``predict_single``;
    one seed repeats; a sampled result is a string with a confidence in
    [0, 1]."""
    jeng, made, images = engines
    engine = made[route]
    res = engine.sample_tokens(images, temperature=1.5, top_k=4, seed=7)
    assert res.tokens.shape[0] == 3
    again = engine.sample_tokens(images, temperature=1.5, top_k=4, seed=7)
    assert torch.equal(res.tokens, again.tokens)
    latex, conf = engine.predict_single_sampled(images[0], temperature=1.5,
                                                top_k=4, seed=7)
    assert isinstance(latex, str) and 0.0 <= conf <= 1.0
    for img in images:
        want = jeng.predict_single(img)
        got = engine.predict_single_sampled(img, top_k=1, seed=11)
        assert got[0] == want[0] and abs(got[1] - want[1]) < CONF_TOL
