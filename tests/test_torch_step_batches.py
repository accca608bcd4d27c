"""The decoder step (B1, its int8 bundle, and B11) and the ragged step
(B7, float and int8 bundles) of the port against the JAX package's at the
batch sizes their CUDA kernels group differently.

``csrc/fused_step.cu`` and ``csrc/ragged_step.cu`` run the rows in groups
of up to 16, one thread-block cluster a group (``csrc/decoder_cluster.cuh``):
one row, a partial group, one group, more than one with the last partial,
the beam's 50 rows and the largest served bucket (64) take different
launch shapes on the card (``tests/test_torch_kernels_cuda.py`` holds the
kernels against their plain versions there). On the CPU the wrappers run
their plain versions, held here against the JAX Pallas kernels in
interpret mode at each of those sizes: B1 and B11 at the first, a middle
and the last slot; B7 at a position vector that mixes the last slot, the
first, a middle one and random ones, in both head modes (JAX's pool
padded with zero rows to its ``block_b`` multiple; the port's real rows
compared). The decoder is ``tests/test_fused.py``'s (d_model 32, 4
heads, 2 layers, FFN 64, T 12, float32) with every bias and LayerNorm
parameter nonzero; inputs are made with numpy from a seed, the encoder
memory 6 slots long (JAX's cross K/V padded to 16 slots that its kernels
mask; the port gets the 6).

Tolerances, as ``tests/test_torch_variants.py`` and
``tests/test_torch_quant.py`` state them: float32 outputs at 1e-5; the int8
bundle's at 5e-3 absolute (a bf16-rounded matmul input may land one bf16
step apart when the float32 sums before it differ in order).
"""

import numpy as np
import pytest

import jax.numpy as jnp

from handwritten_math_ocr_api_tpu.decode.fused import (
    init_fused_cache as j_init_fused_cache,
)
from handwritten_math_ocr_api_tpu.ops.fused_step import (
    build_stacked as j_build_stacked,
    build_stacked_full as j_build_stacked_full,
    fused_decoder_layers_step as j_layers_step,
    fused_decoder_layers_step_v2 as j_step_v2,
    fused_ragged_step as j_ragged_step,
    quantize_stacked as j_quantize_stacked,
)

from handwritten_math_ocr_api_torch.ops import fused_step as tstep

from test_torch_fused import (
    DEC_CFG,
    DEC_JCFG,
    _j,
    _t,
    decoder,  # noqa: F401  (a fixture)
)
import torch_threads  # noqa: F401  (one CPU thread: see the module)

STEP_TOL = 1e-5
INT8_STEP_ATOL = 5e-3
L, T, D, L_ENC = 2, 12, 32, 6
BATCHES = [1, 5, 16, 40, 64]
POSITIONS = [0, 5, 11]


def _inputs(decoder, rows, seed):
    """x_emb, caches of random rows (a step reads the slots before pos and
    nothing after) and JAX's padded cross K/V for ``rows`` rows."""
    rng = np.random.default_rng(seed)
    memory = rng.standard_normal((rows, L_ENC, D)).astype(np.float32)
    _, _, ck, cv = j_init_fused_cache(_j(decoder), DEC_JCFG,
                                      jnp.asarray(memory))
    assert ck.shape == (L, rows, 16, D)
    sk, sv = (rng.standard_normal((L, rows, T, D)).astype(np.float32)
              for _ in range(2))
    x_emb = rng.standard_normal((rows, D)).astype(np.float32)
    return x_emb, sk, sv, ck, cv


@pytest.mark.parametrize("quantize", [False, True])
@pytest.mark.parametrize("pos", POSITIONS)
@pytest.mark.parametrize("B", BATCHES)
def test_step_matches_pallas(decoder, B, pos, quantize):
    """B1 ("v2", and "v2q" with ``quantize``): x_out and each layer's
    fresh K/V rows; no launch counted on the CPU."""
    x_emb, sk, sv, ck, cv = _inputs(decoder, B, 100 * B + pos)
    jst = j_build_stacked(_j(decoder), DEC_JCFG)
    tst = tstep.build_stacked(decoder, DEC_CFG)
    if quantize:
        jst, tst = j_quantize_stacked(jst), tstep.quantize_stacked(tst)
    want = j_step_v2(jst, DEC_JCFG, jnp.asarray(x_emb), jnp.asarray(sk),
                     jnp.asarray(sv), ck, cv, jnp.int32(pos),
                     l_enc_actual=L_ENC, interpret=True)
    counter = "int8_launches" if quantize else "launches"
    before = getattr(tstep.fused_decoder_layers_step_v2, counter)
    got = tstep.fused_decoder_layers_step_v2(
        tst, DEC_CFG, _t(x_emb), _t(sk), _t(sv), _t(ck[:, :, :L_ENC]),
        _t(cv[:, :, :L_ENC]), pos)
    assert getattr(tstep.fused_decoder_layers_step_v2, counter) == before
    atol = INT8_STEP_ATOL if quantize else STEP_TOL
    for name, g, w in zip(("x_out", "k_new", "v_new"), got, want):
        assert tuple(g.shape) == w.shape, name
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=atol,
                                   rtol=STEP_TOL, err_msg=name)


@pytest.mark.parametrize("pos", POSITIONS)
@pytest.mark.parametrize("B", BATCHES)
def test_layers_step_matches_pallas(decoder, B, pos):
    """B11: x_out and the written slot of each cache within 1e-5, every
    other slot unchanged, the caches updated in place."""
    x_emb, sk, sv, ck, cv = _inputs(decoder, B, 200 * B + pos)
    want = j_layers_step(j_build_stacked(_j(decoder), DEC_JCFG), DEC_JCFG,
                         jnp.asarray(x_emb), jnp.asarray(sk),
                         jnp.asarray(sv), ck, cv, jnp.int32(pos),
                         l_enc_actual=L_ENC, interpret=True)
    tk, tv = _t(sk), _t(sv)
    before = tstep.fused_decoder_layers_step.launches
    got = tstep.fused_decoder_layers_step(
        tstep.build_stacked(decoder, DEC_CFG), DEC_CFG, _t(x_emb), tk, tv,
        _t(ck[:, :, :L_ENC]), _t(cv[:, :, :L_ENC]), pos)
    assert tstep.fused_decoder_layers_step.launches == before
    assert got[1] is tk and got[2] is tv
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               atol=STEP_TOL, rtol=STEP_TOL)
    other = np.arange(T) != pos
    for g, w, old in zip(got[1:], want[1:], (sk, sv)):
        w = np.asarray(w)
        np.testing.assert_array_equal(g.numpy()[:, :, other],
                                      old[:, :, other])
        np.testing.assert_allclose(g.numpy()[:, :, pos], w[:, :, pos],
                                   atol=STEP_TOL, rtol=STEP_TOL)


RAGGED_ROWS = [1, 5, 16, 50, 64]
JAX_BLOCK_B = 16   # the JAX ragged step's row chunk (its pool a multiple)


def _ragged_positions(rows, rng):
    """The last slot, the first, a middle one, then a random one, in turn."""
    pos = rng.integers(0, T, rows).astype(np.int32)
    pos[0::4], pos[1::4], pos[2::4] = T - 1, 0, T // 2 - 1
    return pos


def _pad_rows(a, axis, rows):
    """``a`` with zero rows appended along ``axis`` up to ``rows``."""
    width = [(0, 0)] * a.ndim
    width[axis] = (0, rows - a.shape[axis])
    return np.pad(np.asarray(a), width)


@pytest.mark.parametrize("return_logits", [True, False])
@pytest.mark.parametrize("quantize", [False, True])
@pytest.mark.parametrize("R", RAGGED_ROWS)
def test_ragged_step_matches_pallas(decoder, R, quantize, return_logits):
    """B7: the logits (or the argmax and its log-probability) and each
    layer's fresh K/V rows of every real row; no launch counted on the
    CPU. The int8 bundle's argmax is held where the port's own logits'
    top two lie further apart than twice the int8 tolerance (a near-tie
    may turn on a bf16 rounding)."""
    rng = np.random.default_rng(300 + R)
    _, sk, sv, ck, cv = _inputs(decoder, R, 400 + R)
    prev = rng.integers(0, DEC_CFG.vocab_size, R).astype(np.int32)
    pos = _ragged_positions(R, rng)
    jst = j_build_stacked_full(_j(decoder), DEC_JCFG)
    tst = tstep.build_stacked_full(decoder, DEC_CFG)
    if quantize:
        jst, tst = j_quantize_stacked(jst), tstep.quantize_stacked(tst)
    pool = -(-R // JAX_BLOCK_B) * JAX_BLOCK_B
    want = j_ragged_step(
        jst, DEC_JCFG, jnp.asarray(_pad_rows(prev, 0, pool)),
        jnp.asarray(_pad_rows(pos, 0, pool)),
        *(jnp.asarray(_pad_rows(a, 1, pool)) for a in (sk, sv, ck, cv)),
        l_enc_actual=L_ENC, block_b=JAX_BLOCK_B,
        return_logits=return_logits, interpret=True)
    counter = "int8_launches" if quantize else "launches"
    before = getattr(tstep.fused_ragged_step, counter)
    args = (tst, DEC_CFG, _t(prev), _t(pos), _t(sk), _t(sv),
            _t(ck[:, :, :L_ENC]), _t(cv[:, :, :L_ENC]))
    got = tstep.fused_ragged_step(*args, return_logits=return_logits)
    assert getattr(tstep.fused_ragged_step, counter) == before
    atol = INT8_STEP_ATOL if quantize else STEP_TOL
    if return_logits:
        np.testing.assert_allclose(
            got[0].numpy(), np.asarray(want[0])[:R, :DEC_CFG.vocab_size],
            atol=atol, rtol=STEP_TOL)
    else:
        nxt = np.asarray(want[0])[:R]
        held = np.ones(R, dtype=bool)
        if quantize:
            top2 = tstep.fused_ragged_step(
                *args, return_logits=True)[0].topk(2, dim=-1).values
            held = (top2[:, 0] - top2[:, 1]).numpy() > 2 * INT8_STEP_ATOL
        np.testing.assert_array_equal(got[0].numpy()[held], nxt[held])
        np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1])[:R],
                                   atol=atol, rtol=STEP_TOL)
    for name, g, w in zip(("k_new", "v_new"), got[-2:], want[-2:]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w)[:, :R],
                                   atol=atol, rtol=STEP_TOL, err_msg=name)
