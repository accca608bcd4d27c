"""The fused serving route of the port against the JAX package's.

The route is the JAX engine's ``use_fused=True, pallas_encoder_block=True``:
the decoder step through all layers in one kernel
(``ops/fused_step.fused_decoder_layers_step_v2``) and a whole Swin block in
one kernel (``ops/swin_block.fused_swin_block``). On the CPU the port's
wrappers run their plain versions; the JAX kernels run in Pallas interpret
mode. Inputs and weights are made with numpy from a seed, every bias and
LayerNorm parameter nonzero, and compared in float32.

Tolerances: 1e-5 absolute for the decoder step (float32 sums over at most
64 terms in different orders, then LayerNorm); 2e-4 for a Swin block, the
bound ``tests/test_swin_block_kernel.py`` uses (its MLP sums 4C products
after two LayerNorms); 1e-4 relative for log-prob sums over 12 steps;
tokens and strings exactly. The trunk's golden taps are held at 1e-3 of
each tap's largest value, the bound of ``tests/test_swin_parity.py``.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from handwritten_math_ocr_api_tpu.compat.torch_convert import (
    convert_swin_encoder,
)
from handwritten_math_ocr_api_tpu.core.config import (
    DecodeConfig as JDecodeConfig,
)
from handwritten_math_ocr_api_tpu.core.tokenizer import Tokenizer as JTokenizer
from handwritten_math_ocr_api_tpu.decode.api import DecodeEngine as JEngine
from handwritten_math_ocr_api_tpu.decode.fused import (
    greedy_decode_fused as j_greedy_decode_fused,
    init_fused_cache as j_init_fused_cache,
)
from handwritten_math_ocr_api_tpu.models import decoder as jdec
from handwritten_math_ocr_api_tpu.models import model as jmodel
from handwritten_math_ocr_api_tpu.models.swin import (
    _block_init,
    swin_block as j_swin_block,
)
from handwritten_math_ocr_api_tpu.ops.fused_step import (
    build_stacked as j_build_stacked,
    fused_decoder_layers_step_v2 as j_step_v2,
)
from handwritten_math_ocr_api_tpu.ops.swin_block import (
    fits_vmem as j_fits_vmem,
    fused_swin_block as j_fused_swin_block,
)

from handwritten_math_ocr_api_torch import convert
from handwritten_math_ocr_api_torch.core import config as tcfg
from handwritten_math_ocr_api_torch.core.config import DecodeConfig
from handwritten_math_ocr_api_torch.core.tokenizer import Tokenizer
from handwritten_math_ocr_api_torch.decode import api as tapi
from handwritten_math_ocr_api_torch.decode import fused as tfused
from handwritten_math_ocr_api_torch.decode.greedy import greedy_decode
from handwritten_math_ocr_api_torch.models import swin as tswin
from handwritten_math_ocr_api_torch.ops import fused_step as tstep
from handwritten_math_ocr_api_torch.ops import swin_block as tblock

from test_torch_decode import BUCKETS, VOCAB
from test_torch_models import CFG, JCFG, jax_config

# the decoder of tests/test_fused.py: 2 layers, d 32, 4 heads, FFN 64
DEC_CFG = tcfg.ModelConfig(
    d_model=32, nhead=4, dim_feedforward=64, dropout=0.0,
    num_decoder_layers=2, max_seq_len=12, vocab_size=20, dtype="float32")
DEC_JCFG = jax_config(DEC_CFG)
GOLDEN = os.path.join(os.path.dirname(__file__), "fixtures",
                      "swin_golden_stages_full.npz")


def jitter(tree, seed):
    """A numpy copy of a JAX tree with every bias drawn from N(0, 0.05^2)
    and every LayerNorm scale from 1 + N(0, 0.05^2)."""
    rng = np.random.default_rng(seed)

    def leaf(path, a):
        a = np.array(a, np.float32)
        name = jax.tree_util.keystr(path)
        if name.endswith("['scale']"):
            return 1.0 + 0.05 * rng.standard_normal(a.shape).astype(
                np.float32)
        if name.endswith("['b']") or "b_" in name or "bias" in name:
            return 0.05 * rng.standard_normal(a.shape).astype(np.float32)
        return a

    return jax.tree_util.tree_map_with_path(leaf, tree)


def _j(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def decoder():
    """Decoder weights with nonzero biases and norms, as a numpy tree."""
    params = jdec.init_decoder_params(jax.random.PRNGKey(0), DEC_JCFG)
    return jitter(params, seed=1)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_build_stacked_matches_jax(decoder, dtype):
    cfg = DEC_CFG.replace(dtype=dtype)
    want = j_build_stacked(_j(decoder), jax_config(cfg))
    got = tstep.build_stacked(decoder, cfg)
    assert sorted(got) == sorted(want)
    for key, w in want.items():
        g = got[key]
        assert g.dtype == getattr(torch, str(w.dtype)), key
        assert tuple(g.shape) == w.shape, key
        np.testing.assert_array_equal(
            g.float().numpy(), np.asarray(w.astype(jnp.float32)), key)


@pytest.mark.parametrize("pos", [0, 5, 11])
def test_fused_step_plain_matches_pallas(decoder, pos):
    """Caches hold random rows (the step reads the slots before pos and
    nothing after). The cross K/V are JAX's, padded from 6 to 16 slots
    that its kernel masks; the port's are not padded and get the 6."""
    rng = np.random.default_rng(pos)
    L, B, T, D = 2, 3, 12, 32
    memory = rng.standard_normal((B, 6, D)).astype(np.float32)
    _, _, ck, cv = j_init_fused_cache(_j(decoder), DEC_JCFG,
                                      jnp.asarray(memory))
    assert ck.shape == (L, B, 16, D)
    sk, sv = (rng.standard_normal((L, B, T, D)).astype(np.float32)
              for _ in range(2))
    x_emb = rng.standard_normal((B, D)).astype(np.float32)
    stacked_j = j_build_stacked(_j(decoder), DEC_JCFG)
    want = j_step_v2(stacked_j, DEC_JCFG, jnp.asarray(x_emb),
                     jnp.asarray(sk), jnp.asarray(sv), ck, cv,
                     jnp.int32(pos), l_enc_actual=6, interpret=True)
    stacked = tstep.build_stacked(decoder, DEC_CFG)
    before = tstep.fused_decoder_layers_step_v2.launches
    got = tstep.fused_decoder_layers_step_v2(
        stacked, DEC_CFG, _t(x_emb), _t(sk), _t(sv), _t(ck[:, :, :6]),
        _t(cv[:, :, :6]), pos)
    assert tstep.fused_decoder_layers_step_v2.launches == before
    for name, g, w in zip(("x_out", "k_new", "v_new"), got, want):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5,
                                   rtol=1e-5, err_msg=name)


def _block(dim, heads, key, norm1_bias):
    p = jitter(_block_init(jax.random.PRNGKey(key), dim, heads, 7, 4.0),
               seed=key)
    if norm1_bias is not None:
        p["norm1"]["bias"] = np.full(dim, norm1_bias, np.float32)
    return p, convert.to_torch(p, CFG, "cpu")


# (B, H, W, C, heads): a padded stage-1-like map (10x16 -> 14x21) and the
# clamp case (3x10: the shift is 0 along H, 3 along W)
BLOCK_CASES = [((2, 10, 16, 32, 2), 0), ((2, 10, 16, 32, 2), 3),
               ((1, 3, 10, 32, 4), 3)]


@pytest.mark.parametrize("case,shift", BLOCK_CASES)
def test_swin_block_plain_matches_pallas_block(case, shift):
    """Against the TPU kernel where both compute the same function: LN1's
    bias zero, every other bias and norm parameter random."""
    B, H, W, C, heads = case
    jp, tp = _block(C, heads, key=H + shift, norm1_bias=0.0)
    x = np.random.default_rng(shift).standard_normal(
        (B, H, W, C)).astype(np.float32)
    want = j_fused_swin_block(_j(jp), jnp.asarray(x), 7, shift, heads,
                              interpret=True)
    before = tblock.fused_swin_block.launches
    got = tblock.fused_swin_block(tp, _t(x), 7, shift, heads)
    assert tblock.fused_swin_block.launches == before
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4,
                               rtol=2e-4)


@pytest.mark.parametrize("case,shift", BLOCK_CASES)
def test_swin_block_plain_matches_swin_block(case, shift):
    """Against the reference's block function with every parameter random,
    LN1's bias included: the port pads after LN1, as swin_block does."""
    B, H, W, C, heads = case
    jp, tp = _block(C, heads, key=H + shift, norm1_bias=None)
    assert np.abs(jp["norm1"]["bias"]).max() > 0.05
    x = np.random.default_rng(shift).standard_normal(
        (B, H, W, C)).astype(np.float32)
    want = j_swin_block(_j(jp), jnp.asarray(x), 7, shift, heads, 4.0)
    got = tblock.fused_swin_block(tp, _t(x), 7, shift, heads)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4,
                               rtol=2e-4)
    # the port's own block route takes it for this small stage
    routed = tswin.swin_block(tp, _t(x), 7, shift, heads,
                              use_pallas_block=True)
    np.testing.assert_array_equal(routed.numpy(), got.numpy())


@pytest.mark.parametrize("shift", [0, 3])
def test_swin_block_bf16_biases_match_pallas_block(shift):
    """In bf16 the block kernel takes its four biases in float32 and adds
    them in float32, as the TPU kernel does. Biases drawn from N(0, 6^2),
    far off the bf16 grid, LN1's bias zero (where the reference computes
    swin_block's function), on a padded map: rounding the biases to bf16
    moves the output from the TPU kernel's by more than 0.02 on average;
    the port with the engine's float32 bundle (``with_float32_biases``)
    stays within a quarter of that gap. The remaining difference is bf16
    rounding of intermediates whose float32 sums differ in order (about
    a tenth of the outputs move by one bf16 step)."""
    C, heads = 32, 2
    jp, _ = _block(C, heads, key=7, norm1_bias=0.0)
    rng = np.random.default_rng(shift)
    for path in tblock.BIAS_PATHS:
        node = jp
        for key in path[:-1]:
            node = node[key]
        node[path[-1]] = 6.0 * rng.standard_normal(
            node[path[-1]].shape).astype(np.float32)
    x = jnp.asarray(rng.standard_normal((2, 10, 16, C)).astype(np.float32)
                    ).astype(jnp.bfloat16)
    want = np.asarray(j_fused_swin_block(_j(jp), x, 7, shift, heads,
                                         interpret=True).astype(jnp.float32))
    encoder = {"stages": [{"blocks": [jp]}]}
    bf16 = convert.to_torch(encoder, CFG.replace(dtype="bfloat16"), "cpu")
    bundle = tblock.with_float32_biases(encoder, bf16)
    p32 = bundle["stages"][0]["blocks"][0]
    p16 = bf16["stages"][0]["blocks"][0]
    assert p32["mlp"]["fc2"]["b"].dtype == torch.float32
    assert p16["mlp"]["fc2"]["b"].dtype == torch.bfloat16  # not shared
    xt = _t(np.asarray(x.astype(jnp.float32))).to(torch.bfloat16)
    got = tblock.fused_swin_block(p32, xt, 7, shift, heads).float().numpy()
    old = tblock.fused_swin_block(p16, xt, 7, shift, heads).float().numpy()
    gap = np.abs(old - want).mean()
    assert gap > 0.02
    assert np.abs(got - want).mean() < gap / 4


def test_reference_block_kernel_pads_before_ln1():
    """The reference's deviation, pinned: the TPU whole-block kernel pads
    the map before LN1, so on a padded map with LN1 bias 0.5 its padded
    keys carry LN1(0) W_qkv + b and its output leaves swin_block's by more
    than 0.1. This is why the port's block kernel follows swin_block."""
    jp, _ = _block(32, 2, key=3, norm1_bias=0.5)
    x = jnp.asarray(np.random.default_rng(0).standard_normal(
        (1, 6, 20, 32)).astype(np.float32))
    kernel = j_fused_swin_block(_j(jp), x, 7, 0, 2, interpret=True)
    block = j_swin_block(_j(jp), x, 7, 0, 2, 4.0)
    assert float(jnp.abs(kernel - block).max()) > 0.1


def test_route_rule_and_shared_memory_limit():
    """The port routes the same Swin-T stages to the block kernel as the
    reference (stages 1-3 at 96x320), and the CUDA wrapper's own limit
    holds stages 1-3 and refuses stage 4."""
    for C, w_pad in ((96, 84), (192, 42), (384, 21), (768, 14)):
        assert tblock.fits_vmem(C, 7, w_pad, 4 * C) == j_fits_vmem(C, 7,
                                                                   w_pad)
    assert not tblock.fits_vmem(768, 7, 14, 4 * 768)
    for C, heads in ((96, 3), (192, 6), (384, 12)):
        G, hc, smem = tblock.smem_plan(C, heads, 4 * C, 7)
        assert heads % G == 0 and (4 * C) % hc == 0 and hc % 8 == 0
        assert smem <= tblock.SMEM_LIMIT
    with pytest.raises(ValueError, match="shared memory"):
        tblock.smem_plan(768, 24, 3072, 7)


def test_greedy_decode_fused_matches_jax_and_unfused(decoder):
    rng = np.random.default_rng(2)
    memory = rng.standard_normal((3, 6, 32)).astype(np.float32)
    jparams = _j(decoder)
    want = j_greedy_decode_fused(jparams, j_build_stacked(jparams, DEC_JCFG),
                                 DEC_JCFG, jnp.asarray(memory), 12,
                                 interpret=True)
    tparams = convert.to_torch(decoder, DEC_CFG, "cpu")
    stacked = tstep.build_stacked(decoder, DEC_CFG)
    got = tfused.greedy_decode_fused(tparams, stacked, DEC_CFG,
                                     _t(memory), 12)
    np.testing.assert_array_equal(got.tokens.numpy(),
                                  np.asarray(want.tokens))
    np.testing.assert_array_equal(got.token_count.numpy(),
                                  np.asarray(want.token_count))
    np.testing.assert_allclose(got.logprob_sum.numpy(),
                               np.asarray(want.logprob_sum), atol=1e-4,
                               rtol=1e-4)
    unfused = greedy_decode(tparams, DEC_CFG, _t(memory), 12)
    np.testing.assert_array_equal(got.tokens.numpy(), unfused.tokens.numpy())
    assert got.steps == unfused.steps


def _engine_tree(zero_ln1_bias):
    jparams, _ = jax.jit(lambda k: jmodel.init_model(k, JCFG))(
        jax.random.PRNGKey(5))
    tree = jitter(jparams, seed=5)
    if zero_ln1_bias:
        for stage in tree["encoder"]["stages"]:
            for blk in stage["blocks"]:
                blk["norm1"]["bias"][:] = 0.0
    return tree


def _check_engines(tree, use_fused, pallas_encoder_block):
    """The port's engine against the JAX engine (``use_pallas=True``) on the
    same pair of options; returns the port's tokens."""
    images = np.random.default_rng(9).integers(
        0, 256, (3, CFG.img_h, CFG.img_w, 1), dtype=np.uint8)
    jax_engine = JEngine(_j(tree), {}, JCFG,
                         JDecodeConfig(max_seq_len=CFG.max_seq_len,
                                       batch_buckets=BUCKETS),
                         JTokenizer(VOCAB), use_pallas=True,
                         use_fused=use_fused,
                         pallas_encoder_block=pallas_encoder_block)
    engine = tapi.DecodeEngine(
        tree, CFG, DecodeConfig(max_seq_len=CFG.max_seq_len,
                                batch_buckets=BUCKETS),
        Tokenizer(VOCAB), use_fused=use_fused,
        pallas_encoder_block=pallas_encoder_block, device="cpu")
    want = jax_engine.decode_tokens(images)
    got = engine.decode_tokens(images)
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(want.tokens))
    np.testing.assert_allclose(got.logprob_sum.numpy(),
                               np.asarray(want.logprob_sum), atol=1e-4,
                               rtol=1e-4)
    assert engine.predict_batch(images) == jax_engine.predict_batch(images)
    # and the port's routes agree with each other
    plain = tapi.DecodeEngine(tree, CFG, DecodeConfig(
        max_seq_len=CFG.max_seq_len, batch_buckets=BUCKETS),
        Tokenizer(VOCAB), device="cpu")
    np.testing.assert_array_equal(plain.decode_tokens(images).tokens.numpy(),
                                  got.tokens.numpy())


def test_engine_fused_route_matches_jax_engine():
    """The whole slice: JAX ``DecodeEngine(use_pallas=True, use_fused=True,
    pallas_encoder_block=True)`` against the port's engine on the same
    route, encoder LN1 biases zero (where the reference's block kernel
    computes swin_block's function)."""
    _check_engines(_engine_tree(zero_ln1_bias=True), True, True)


@pytest.mark.parametrize("use_fused,pallas_encoder_block",
                         [(True, False), (False, True)])
def test_engine_one_option_matches_jax_engine(use_fused,
                                              pallas_encoder_block):
    """Each option on its own, against the JAX engine with the same pair.
    The LN1 biases stay random where the encoder does not take the block
    kernel (the reference's window-attention route computes swin_block's
    function with any bias)."""
    _check_engines(_engine_tree(zero_ln1_bias=pallas_encoder_block),
                   use_fused, pallas_encoder_block)


def test_engine_fused_refuses_grouped_attention():
    cfg = DEC_CFG.replace(nhead_kv=2)
    with pytest.raises(NotImplementedError, match="MQA/GQA"):
        tapi.DecodeEngine({"decoder": {}}, cfg, use_fused=True, device="cpu")


@pytest.fixture(scope="module")
def golden():
    from torch_swin_oracle import make_random_swin_state_dict

    data = np.load(GOLDEN)
    sd = {k: v.numpy() for k, v in
          make_random_swin_state_dict(seed=0).items()}
    jcfg = jax_config(tcfg.ModelConfig())
    params = convert_swin_encoder(sd, jcfg)
    cfg = tcfg.ModelConfig(dtype="float32")
    tparams = convert.to_torch(jax.tree_util.tree_map(np.asarray, params),
                               cfg, "cpu")
    images = _t(data["__input__"].transpose(0, 2, 3, 1).copy())
    return data, tparams, images, cfg


@pytest.mark.parametrize("use_pallas_block", [False, True])
def test_swin_trunk_matches_golden_taps(golden, use_pallas_block):
    """The full Swin-T trunk (torchvision weights from the committed torch
    seed, batch 1) against the committed torch-oracle activations at every
    stage tap, on both encoder routes. The reference's block route misses
    this bound (rel 1.8e-2: its kernel pads before LN1)."""
    data, tparams, images, cfg = golden
    with torch.inference_mode():
        taps = tswin.swin_apply_stages(tparams, images, cfg.swin,
                                       use_pallas_block=use_pallas_block)
    assert len(taps) == 5
    for i, tap in enumerate(taps):
        want = data[f"stage_{i}"]
        got = tap.numpy()
        assert got.shape == want.shape
        err = np.abs(got - want).max() / np.abs(want).max()
        assert err < 1e-3, f"stage_{i}: rel err {err:.3g}"
