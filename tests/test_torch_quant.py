"""Weight-only int8 decoding of the port against the JAX package's.

The port's ``ops/quant.py`` (quantization and the dequant matmul, B9), the
int8 branches of its decoder (the default route of ``DecodeEngine(
quantize=True)``), the int8 bundle of the fused steps (``quantize_stacked``
through B1 and B7) and the engine on both routes. On the CPU the port's
wrappers run their plain versions; the JAX kernels run in Pallas interpret
mode. The decoder is ``tests/test_fused.py``'s (d_model 32, 4 heads, 2
layers, T 12, vocab 20, float32) with every bias and LayerNorm parameter
nonzero; inputs are made with numpy from a seed.

Tolerances: int8 weights and scales exactly; the dequant matmul at 1e-5
relative in float32 (the same products summed in another order) and 2e-2
in bf16 (the outputs may round one bf16 step apart); decoder-step logits
at 1e-4, the bound of ``tests/test_torch_models.py`` (float32 sums in
other orders); the int8 fused steps' outputs at 5e-3 absolute: their
matmul inputs round to bf16 at the same points on both sides, but where
the float32 sums before a rounding differ in order by an ulp across a
rounding boundary, that input lands one bf16 step (2^-8 relative) apart
and moves the row's later outputs (measured: 1.4e-3 on one row of 16 in
the ragged step's logits, every other row within 1e-5); beam scores at
``tests/test_torch_beam.py``'s 5e-3 / 2e-3; tokens and strings exactly.
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
from handwritten_math_ocr_api_tpu.decode.fused import (
    init_fused_cache as j_init_fused_cache,
)
from handwritten_math_ocr_api_tpu.models import decoder as jdec
from handwritten_math_ocr_api_tpu.ops import quant as jquant
from handwritten_math_ocr_api_tpu.ops.fused_step import (
    build_stacked_full as j_build_stacked_full,
    fused_decoder_layers_step_v2 as j_step_v2,
    fused_ragged_step as j_ragged_step,
    quantize_stacked as j_quantize_stacked,
)

from handwritten_math_ocr_api_torch import convert
from handwritten_math_ocr_api_torch.core.config import DecodeConfig
from handwritten_math_ocr_api_torch.core.tokenizer import Tokenizer
from handwritten_math_ocr_api_torch.decode import api as tapi
from handwritten_math_ocr_api_torch.models import decoder as tdec
from handwritten_math_ocr_api_torch.models import layers as tlayers
from handwritten_math_ocr_api_torch.ops import fused_step as tstep
from handwritten_math_ocr_api_torch.ops import quant as tquant

from test_torch_beam import SCORE_ATOL, SCORE_RTOL, STEP_TOL
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
import torch_threads  # noqa: F401  (one CPU thread: see the module)

MM_TOL = {"float32": (1e-5, 1e-5), "bfloat16": (2e-2, 2e-2)}
INT8_STEP_ATOL = 5e-3


def _np(a):
    return np.asarray(a.astype(jnp.float32)) if a.dtype == jnp.bfloat16 \
        else np.asarray(a)


def _weight(seed, shape=(64, 128), zero_col=None):
    w = np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)
    if zero_col is not None:
        w[:, zero_col] = 0.0
    return w


@pytest.mark.parametrize("zero_col", [None, 5])
def test_quantize_weight_matches_jax(zero_col):
    w = _weight(0, zero_col=zero_col)
    want_q, want_s = jquant.quantize_weight(jnp.asarray(w))
    got_q, got_s = tquant.quantize_weight(w)
    assert got_q.dtype == torch.int8 and got_s.dtype == torch.float32
    np.testing.assert_array_equal(got_q.numpy(), np.asarray(want_q))
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))
    if zero_col is not None:
        assert got_s[zero_col] == 1.0 and not got_q[:, zero_col].any()


def _tree_items(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _tree_items(v, f"{prefix}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _tree_items(v, f"{prefix}/{i}")
    else:
        yield prefix, tree


def test_quantize_decoder_params_matches_jax(decoder):
    want = dict(_tree_items(jquant.quantize_decoder_params(_j(decoder))))
    got = dict(_tree_items(tquant.quantize_decoder_params(decoder)))
    assert sorted(got) == sorted(want)
    quantized = [k for k in got if k.endswith("_q")]
    assert len(quantized) == 2 * 6 + 1     # per layer 2 x (qkv, out), 2 FFN
    for key, w in want.items():
        g = got[key]
        g = g.numpy() if isinstance(g, torch.Tensor) else np.asarray(g)
        assert g.dtype == np.asarray(w).dtype, key
        np.testing.assert_array_equal(g, np.asarray(w), key)
    assert (tquant.quantized_bytes(decoder)
            == jquant.quantized_bytes(_j(decoder)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_stacked_matches_jax(decoder, dtype):
    """From the bundle's weights: bf16-rounded first in a bf16 config, as
    the JAX engine's fused route quantizes them."""
    cfg = DEC_CFG.replace(dtype=dtype)
    want = j_quantize_stacked(j_build_stacked_full(_j(decoder),
                                                   jax_config(cfg)))
    got = tstep.quantize_stacked(tstep.build_stacked_full(decoder, cfg))
    assert sorted(got) == sorted(want)
    for key in tstep.WEIGHT_KEYS:
        assert got[key].dtype == torch.int8, key
        assert got[f"{key}_s"].dtype == torch.float32, key
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]))
        np.testing.assert_array_equal(got[f"{key}_s"].numpy(),
                                      np.asarray(want[f"{key}_s"]))


def test_to_torch_keeps_int8_weights_and_float32_scales(decoder):
    """In bf16 the int8 leaves stay int8 and every ``*_scale`` float32 (a
    bf16 scale would move every product); the rest keeps its rule."""
    tree = {"decoder": tquant.quantize_decoder_params(decoder)}
    got = convert.to_torch(tree, DEC_CFG.replace(dtype="bfloat16"),
                           "cpu")["decoder"]
    sa = got["layers"][0]["self_attn"]
    assert sa["w_qkv_q"].dtype == torch.int8
    assert sa["w_qkv_scale"].dtype == torch.float32
    assert sa["b_qkv"].dtype == torch.bfloat16
    assert got["layers"][1]["ffn"]["fc2"]["w_scale"].dtype == torch.float32
    assert got["fc_out"]["w_q"].dtype == torch.int8
    assert got["fc_out"]["w_scale"].dtype == torch.float32
    assert got["fc_out"]["b"].dtype == torch.float32
    np.testing.assert_array_equal(
        sa["w_qkv_scale"].numpy(),
        tree["decoder"]["layers"][0]["self_attn"]["w_qkv_scale"].numpy())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("M", [1, 16, 50, 300])
@pytest.mark.parametrize("N", [20, 48, 138])
def test_dequant_matmul_plain_matches_pallas(dtype, M, N):
    """Against the TPU kernel B9 itself, in interpret mode, at the shapes
    the CUDA kernel tiles differently: one row, one m16 tile, a partial
    fourth (50) and several 128-row blocks (300); N 20 (a partial 16-column
    tile), 48 and 138 (the head's odd width); K 36 (not a multiple of 8: x
    staged by element), 64 and 72 (not a multiple of the 16-row k-step)."""
    rng = np.random.default_rng(M * N)
    K = {20: 36, 48: 64, 138: 72}[N]
    w_q, scale = jquant.quantize_weight(jnp.asarray(_weight(N, (K, N))))
    x = jnp.asarray(rng.standard_normal((M, K)).astype(np.float32)).astype(
        dtype)
    want = jquant.dequant_matmul(x, w_q, scale, use_pallas=True)
    xt = _t(_np(x)).to(getattr(torch, dtype))
    before = tquant.dequant_matmul.launches
    got = tquant.dequant_matmul(xt, _t(w_q), _t(scale))
    assert tquant.dequant_matmul.launches == before     # CPU: no kernel
    assert got.dtype == xt.dtype and tuple(got.shape) == (M, N)
    atol, rtol = MM_TOL[dtype]
    np.testing.assert_allclose(got.float().numpy(), _np(want), atol=atol,
                               rtol=rtol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dequant_matmul_plain_matches_pallas_on_a_column_slice(dtype):
    """The cross projection's k columns of a packed (32, 96) int8 matrix: a
    strided view, as the decoder passes it, against JAX's B9 on the same
    slice; for a decode step's rows (2 x 6) and the encoder memory's
    (25 x 12: the CUDA kernel's tall tiles)."""
    w_q, scale = jquant.quantize_weight(jnp.asarray(_weight(3, (32, 96))))
    tw = _t(w_q)[:, 32:64]
    assert not tw.is_contiguous()
    atol, rtol = MM_TOL[dtype]
    for seed, shape in ((4, (2, 6, 32)), (5, (25, 12, 32))):
        x = jnp.asarray(np.random.default_rng(seed).standard_normal(
            shape).astype(np.float32)).astype(dtype)
        want = jquant.dequant_matmul(x, w_q[:, 32:64], scale[32:64],
                                     use_pallas=True)
        got = tquant.dequant_matmul(_t(_np(x)).to(getattr(torch, dtype)), tw,
                                    _t(scale)[32:64])
        np.testing.assert_allclose(got.float().numpy(), _np(want),
                                   atol=atol, rtol=rtol)


def test_int8_linear_rounds_before_the_bias():
    """bf16: (x @ w_q) * scale rounds to bf16, then the bias adds in bf16,
    as the JAX linear does."""
    rng = np.random.default_rng(8)
    w_q, scale = jquant.quantize_weight(jnp.asarray(_weight(8, (32, 20))))
    b = (3.0 * rng.standard_normal(20)).astype(np.float32)
    x = jnp.asarray(rng.standard_normal((4, 32)).astype(np.float32)).astype(
        jnp.bfloat16)
    want = (jquant.dequant_matmul(x, w_q, scale) + jnp.asarray(b).astype(
        jnp.bfloat16))
    got = tlayers.linear({"w_q": _t(w_q), "w_scale": _t(scale),
                          "b": _t(b).to(torch.bfloat16)},
                         _t(_np(x)).to(torch.bfloat16))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), _np(want), atol=2e-2,
                               rtol=2e-2)


@pytest.fixture(scope="module")
def qdecoder(decoder):
    """The decoder tree quantized, as JAX and as the port hold it."""
    return (jquant.quantize_decoder_params(_j(decoder)),
            convert.to_torch(tquant.quantize_decoder_params(decoder),
                             DEC_CFG, "cpu"))


def test_int8_decoder_step_matches_jax(qdecoder):
    """The default route's int8 step (cache-append attention, every
    projection and the head through the dequant matmul) against JAX
    ``decoder_step(use_pallas=True)`` on the quantized tree, 6 steps."""
    jparams, tparams = qdecoder
    rng = np.random.default_rng(4)
    memory = rng.standard_normal((2, 6, DEC_CFG.d_model)).astype(np.float32)
    ids = rng.integers(0, DEC_CFG.vocab_size, (2, 6))
    jcache = jdec.init_cache(jparams, DEC_JCFG, jnp.asarray(memory),
                             max_len=8)
    tcache = tdec.init_cache(tparams, DEC_CFG, _t(memory), max_len=8)
    for name in ("cross_k_0", "cross_v_1"):
        np.testing.assert_allclose(tcache[name].numpy(),
                                   np.asarray(jcache[name]), atol=1e-4,
                                   rtol=1e-4)
    step = jax.jit(lambda p, i, t, c: jdec.decoder_step(
        p, DEC_JCFG, i, t, c, use_pallas=True))
    for t in range(6):
        want, jcache = step(jparams, jnp.asarray(ids[:, t]), jnp.int32(t),
                            jcache)
        got = tdec.decoder_step(tparams, DEC_CFG, _t(ids[:, t]), t, tcache)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                                   rtol=1e-4)


def _int8_bundles(decoder):
    return (j_quantize_stacked(j_build_stacked_full(_j(decoder), DEC_JCFG)),
            tstep.quantize_stacked(tstep.build_stacked_full(decoder,
                                                            DEC_CFG)))


@pytest.mark.parametrize("pos", [0, 5, 11])
def test_int8_fused_step_plain_matches_pallas(decoder, pos):
    """B1's int8 bundle ("v2q"): matmul inputs rounded to bf16 in a
    float32 config, the scale on the float32 sum. Caches of random rows;
    JAX's cross K/V padded from 6 to 16 slots that its kernel masks."""
    rng = np.random.default_rng(20 + pos)
    L, B, T, D = 2, 3, 12, 32
    memory = rng.standard_normal((B, 6, D)).astype(np.float32)
    _, _, ck, cv = j_init_fused_cache(_j(decoder), DEC_JCFG,
                                      jnp.asarray(memory))
    sk, sv = (rng.standard_normal((L, B, T, D)).astype(np.float32)
              for _ in range(2))
    x_emb = rng.standard_normal((B, D)).astype(np.float32)
    jst, tst = _int8_bundles(decoder)
    want = j_step_v2(jst, DEC_JCFG, jnp.asarray(x_emb), jnp.asarray(sk),
                     jnp.asarray(sv), ck, cv, jnp.int32(pos),
                     l_enc_actual=6, interpret=True)
    before = tstep.fused_decoder_layers_step_v2.int8_launches
    got = tstep.fused_decoder_layers_step_v2(
        tst, DEC_CFG, _t(x_emb), _t(sk), _t(sv), _t(ck[:, :, :6]),
        _t(cv[:, :, :6]), pos)
    assert tstep.fused_decoder_layers_step_v2.int8_launches == before
    for name, g, w in zip(("x_out", "k_new", "v_new"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=INT8_STEP_ATOL,
                                   rtol=STEP_TOL, err_msg=name)


@pytest.mark.parametrize("return_logits", [True, False])
def test_int8_ragged_step_plain_matches_pallas(decoder, return_logits):
    """B7's int8 bundle: 16 rows at ragged positions, both head modes."""
    rng = np.random.default_rng(25)
    L, R, T, D = 2, 16, 12, 32
    memory = rng.standard_normal((R, 6, D)).astype(np.float32)
    _, _, ck, cv = j_init_fused_cache(_j(decoder), DEC_JCFG,
                                      jnp.asarray(memory))
    sk, sv = (rng.standard_normal((L, R, T, D)).astype(np.float32)
              for _ in range(2))
    prev = rng.integers(0, DEC_CFG.vocab_size, R).astype(np.int32)
    pos = rng.integers(0, T, R).astype(np.int32)
    jst, tst = _int8_bundles(decoder)
    want = j_ragged_step(jst, DEC_JCFG, jnp.asarray(prev), jnp.asarray(pos),
                         jnp.asarray(sk), jnp.asarray(sv), ck, cv,
                         l_enc_actual=6, return_logits=return_logits,
                         interpret=True)
    before = tstep.fused_ragged_step.int8_launches
    got = tstep.fused_ragged_step(
        tst, DEC_CFG, _t(prev), _t(pos), _t(sk), _t(sv), _t(ck[:, :, :6]),
        _t(cv[:, :, :6]), return_logits=return_logits)
    assert tstep.fused_ragged_step.int8_launches == before
    if return_logits:
        np.testing.assert_allclose(
            got[0].numpy(), np.asarray(want[0])[:, :DEC_CFG.vocab_size],
            atol=INT8_STEP_ATOL, rtol=STEP_TOL)
    else:
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
        np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]),
                                   atol=INT8_STEP_ATOL, rtol=STEP_TOL)
    for g, w in zip(got[-2:], want[-2:]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=INT8_STEP_ATOL,
                                   rtol=STEP_TOL)


def test_int8_bundle_without_its_scales_is_refused(decoder):
    tst = tstep.quantize_stacked(tstep.build_stacked_full(decoder, DEC_CFG))
    del tst["w_ff1_s"]
    with pytest.raises(ValueError, match="scales at w_ff1"):
        tstep.fused_ragged_step(
            tst, DEC_CFG, torch.zeros(2, dtype=torch.int32),
            torch.zeros(2, dtype=torch.int32), torch.zeros(2, 2, 12, 32),
            torch.zeros(2, 2, 12, 32), torch.zeros(2, 2, 6, 32),
            torch.zeros(2, 2, 6, 32))


@pytest.mark.parametrize("route", ["pallas", "fused"])
def test_engine_quantize_matches_jax_engine(route):
    """The whole slice in float32: JAX ``DecodeEngine(use_pallas=True,
    quantize=True)``, and on the fused route with ``use_fused`` +
    ``pallas_encoder_block`` (encoder LN1 biases zero, where the
    reference's block kernel computes swin_block's function), against the
    port's engine with the same options: greedy and beam-3 tokens, a batch
    of 3 images padded to the bucket of 4."""
    fused = route == "fused"
    tree = _engine_tree(zero_ln1_bias=fused)
    images = np.random.default_rng(13).integers(
        0, 256, (3, CFG.img_h, CFG.img_w, 1), dtype=np.uint8)
    jax_engine = JEngine(_j(tree), {}, JCFG,
                         JDecodeConfig(max_seq_len=CFG.max_seq_len,
                                       batch_buckets=BUCKETS),
                         JTokenizer(VOCAB), use_pallas=True, quantize=True,
                         use_fused=fused, pallas_encoder_block=fused)
    engine = tapi.DecodeEngine(
        tree, CFG, DecodeConfig(max_seq_len=CFG.max_seq_len,
                                batch_buckets=BUCKETS),
        Tokenizer(VOCAB), use_fused=fused, pallas_encoder_block=fused,
        quantize=True, device="cpu")
    if fused:
        assert engine.stacked["w_qkv"].dtype == torch.int8
        assert "w_qkv" in engine.params["decoder"]["layers"][0]["self_attn"]
    else:
        sa = engine.params["decoder"]["layers"][0]["self_attn"]
        assert sa["w_qkv_q"].dtype == torch.int8 and "w_qkv" not in sa
    want = jax_engine.decode_tokens(images)
    got = engine.decode_tokens(images)
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(want.tokens))
    np.testing.assert_allclose(got.logprob_sum.numpy(),
                               np.asarray(want.logprob_sum), atol=1e-4,
                               rtol=1e-4)
    assert engine.predict_batch(images) == jax_engine.predict_batch(images)
    assert (engine.predict_single(images[0])[0]
            == jax_engine.predict_single(images[0])[0])
    want = jax_engine.decode_tokens(images, beam_size=3)
    got = engine.decode_tokens(images, beam_size=3)
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(want.tokens))
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores),
                               atol=SCORE_ATOL, rtol=SCORE_RTOL)
    engine.warmup((1,), beam_sizes=(2,), dtype=np.uint8)
