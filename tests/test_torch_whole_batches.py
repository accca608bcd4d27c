"""The whole step (B10) and the whole decode (B12) of the port against the
JAX package's at the batch sizes their CUDA kernels group differently.

``csrc/whole_step.cu`` and ``csrc/whole_decode.cu`` run the rows in groups of
up to 16, one thread-block cluster a group, on the layer code of
``csrc/decoder_cluster.cuh``: 1, 5, 16 and 40 rows take groups of 1, 1, 2 and 4
rows on an H100 (``tests/test_torch_kernels_cuda.py`` holds the kernels against
their plain versions there). On the CPU the wrappers run their plain versions,
held here against the JAX Pallas kernels in interpret mode: B10 in both cache
layouts at 1, 5, 16 and 40 rows and at the first and the last slot; B12 with
the float and the int8 resident bundle at 1, 5 and 16 rows, and on a bundle
whose head bias of EOS is raised so that rows end at different steps and one
never does. The decoder is ``tests/test_fused.py``'s (d_model 32, 4 heads, 2
layers, FFN 64, T 12, vocab 20, float32) with every bias and LayerNorm
parameter nonzero; inputs are made with numpy from a seed, the encoder memory 6
slots long (JAX's cross K/V padded to 16 slots that its kernels mask; the port
gets the 6).

Tolerances, as ``tests/test_torch_variants.py`` states them: tokens,
lengths, counts and nxt exactly; step outputs (log-probs, fresh rows) at
1e-5 (float32 sums over at most 64 terms in other orders, then
LayerNorm); log-prob sums over 12 steps at 1e-4 relative. The int8
bundles round matmul inputs to bf16 on both sides at the same points.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from handwritten_math_ocr_api_tpu.core.config import EOS_ID, PAD_ID
from handwritten_math_ocr_api_tpu.decode.fused import (
    init_fused_cache as j_init_fused_cache,
)
from handwritten_math_ocr_api_tpu.ops.fused_step import (
    build_stacked_full as j_build_stacked_full,
    fused_whole_step as j_whole_step,
)
from handwritten_math_ocr_api_tpu.ops.whole_decode import (
    build_resident as j_build_resident,
    fused_whole_decode as j_whole_decode,
)

from handwritten_math_ocr_api_torch import convert
from handwritten_math_ocr_api_torch.ops import fused_step as tstep
from handwritten_math_ocr_api_torch.ops import whole_decode as twhole

from test_torch_fused import (
    DEC_CFG,
    DEC_JCFG,
    _j,
    _t,
    decoder,  # noqa: F401  (a fixture)
)
from test_torch_variants import _check_decode, _eos_decoder
import torch_threads  # noqa: F401  (one CPU thread: see the module)

STEP_TOL = 1e-5
L, T, D, L_ENC = 2, 12, 32, 6
STEP_ROWS = [1, 5, 16, 40]
DECODE_ROWS = [1, 5, 16]


def _memory(rows, seed):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((rows, L_ENC, D)).astype(np.float32)


def _step_inputs(decoder, rows, seed):
    """Caches of random rows in the batch-major layout (a step reads the
    slots before pos and nothing after), previous tokens, and JAX's cross
    K/V padded to 16 slots."""
    rng = np.random.default_rng(seed)
    _, _, ck, cv = j_init_fused_cache(_j(decoder), DEC_JCFG,
                                      jnp.asarray(_memory(rows, seed)))
    assert ck.shape == (L, rows, 16, D)
    sk, sv = (rng.standard_normal((L, rows, T, D)).astype(np.float32)
              for _ in range(2))
    prev = rng.integers(0, DEC_CFG.vocab_size, rows).astype(np.int32)
    return sk, sv, ck, cv, prev


@pytest.mark.parametrize("pos", [0, T - 1])
@pytest.mark.parametrize("time_major", [True, False])
@pytest.mark.parametrize("B", STEP_ROWS)
def test_whole_step_matches_pallas(decoder, B, time_major, pos):
    """B10: nxt equal, logp and the fresh rows within 1e-5; time-major
    caches written at pos in place (every other slot unchanged),
    batch-major ones read only and the rows returned; no launch counted
    on the CPU."""
    sk, sv, ck, cv, prev = _step_inputs(decoder, B, 1000 * B + pos)
    if time_major:
        sk, sv = (np.ascontiguousarray(a.transpose(0, 2, 1, 3))
                  for a in (sk, sv))
    want = j_whole_step(j_build_stacked_full(_j(decoder), DEC_JCFG),
                        DEC_JCFG, jnp.asarray(prev), jnp.asarray(sk),
                        jnp.asarray(sv), ck, cv, jnp.int32(pos),
                        l_enc_actual=L_ENC, interpret=True,
                        time_major=time_major)
    tk, tv = _t(sk), _t(sv)
    before = tstep.fused_whole_step.launches
    got = tstep.fused_whole_step(tstep.build_stacked_full(decoder, DEC_CFG),
                                 DEC_CFG, _t(prev), tk, tv,
                                 _t(ck[:, :, :L_ENC]), _t(cv[:, :, :L_ENC]),
                                 pos, time_major=time_major)
    assert tstep.fused_whole_step.launches == before
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]),
                               atol=STEP_TOL, rtol=STEP_TOL)
    if time_major:
        assert got[2] is tk and got[3] is tv
        other = np.arange(T) != pos
        for g, w, old in zip(got[2:], want[2:], (sk, sv)):
            np.testing.assert_array_equal(g.numpy()[:, other],
                                          old[:, other])
            np.testing.assert_allclose(g.numpy()[:, pos],
                                       np.asarray(w)[:, pos],
                                       atol=STEP_TOL, rtol=STEP_TOL)
    else:
        assert torch.equal(tk, _t(sk)) and torch.equal(tv, _t(sv))
        for g, w in zip(got[2:], want[2:]):
            assert tuple(g.shape) == (L, B, D)
            np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                       atol=STEP_TOL, rtol=STEP_TOL)


def _decode_both(decoder, memory, quantize):
    """JAX's v5 and the port's whole decode (no launch counted on the CPU)
    of ``memory``."""
    want = j_whole_decode(j_build_resident(_j(decoder), DEC_JCFG, quantize),
                          DEC_JCFG, jnp.asarray(memory), T, interpret=True)
    resident = twhole.build_resident(convert.to_torch(decoder, DEC_CFG,
                                                      "cpu"),
                                     DEC_CFG, quantize)
    before = (twhole.fused_whole_decode.launches,
              twhole.fused_whole_decode.int8_launches)
    got = twhole.fused_whole_decode(resident, DEC_CFG, _t(memory), T)
    assert (twhole.fused_whole_decode.launches,
            twhole.fused_whole_decode.int8_launches) == before
    assert got.tokens.shape == (memory.shape[0], T)
    return got, want


@pytest.mark.parametrize("quantize", [False, True])
@pytest.mark.parametrize("B", DECODE_ROWS)
def test_whole_decode_matches_pallas(decoder, B, quantize):
    """B12 with the float and the int8 resident bundle: tokens, lengths
    and counts equal, log-prob sums within 1e-4 relative."""
    got, want = _decode_both(decoder, _memory(B, 20 + B), quantize)
    _check_decode(got, want)


@pytest.mark.parametrize("quantize", [False, True])
def test_whole_decode_eos_matches_pallas(decoder, quantize):
    """B12 on a bundle whose head bias of EOS is raised by 2.5 (4 rows):
    rows end at different steps and one never; after its EOS a row emits
    PAD, its count is its EOS step and its log-prob sum stops, all as
    JAX's v5, which runs every step for every row."""
    got, want = _decode_both(_eos_decoder(decoder, 2.5), _memory(4, 5),
                             quantize)
    _check_decode(got, want)
    ends = []
    for row, count in zip(got.tokens.tolist(), got.token_count.tolist()):
        e = row.index(EOS_ID) if EOS_ID in row else None
        if e is not None:
            assert row[e + 1:] == [PAD_ID] * (T - e - 1)
        assert count == (T if e is None else e)
        ends.append(e)
    assert None in ends and len({e for e in ends if e is not None}) > 1
