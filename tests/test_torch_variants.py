"""The fused greedy decode's A/B arms of the port against the JAX package's.

``greedy_decode_fused(variant=...)`` in its arms "v1" (the layer step that
writes its cache rows, B11), "v3"/"v4" (the whole step with the argmax in
the kernel, B10, over batch-major or time-major caches) and "v5" (the
whole decode in one launch, B12), each module beside the decode, and the
special-token ids. On the CPU the port's wrappers run their plain
versions; the JAX kernels run in Pallas interpret mode. The decoder is
``tests/test_fused.py``'s (d_model 32, 4 heads, 2 layers, FFN 64, T 12,
vocab 20, float32) with every bias and LayerNorm parameter nonzero;
inputs are made with numpy from a seed, the encoder memory 6 slots long.

Tolerances: tokens, lengths and counts exactly; step outputs (activations,
log-probs, fresh rows) at 1e-5 (float32 sums over at most 64 terms in
other orders, then LayerNorm); log-prob sums over 12 steps at 1e-4
relative. The int8 bundles round matmul inputs to bf16 on both sides at
the same points.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from handwritten_math_ocr_api_tpu.core.config import EOS_ID, PAD_ID
from handwritten_math_ocr_api_tpu.decode.fused import (
    greedy_decode_fused as j_greedy_decode_fused,
    init_fused_cache as j_init_fused_cache,
)
from handwritten_math_ocr_api_tpu.ops.fused_step import (
    build_stacked as j_build_stacked,
    build_stacked_full as j_build_stacked_full,
    fused_decoder_layers_step as j_layers_step,
    fused_whole_step as j_whole_step,
    quantize_stacked as j_quantize_stacked,
)
from handwritten_math_ocr_api_tpu.ops.whole_decode import (
    build_resident as j_build_resident,
    fused_whole_decode as j_whole_decode,
)

from handwritten_math_ocr_api_torch import convert
from handwritten_math_ocr_api_torch.decode import fused as tfused
from handwritten_math_ocr_api_torch.ops import fused_step as tstep
from handwritten_math_ocr_api_torch.ops import whole_decode as twhole

from test_torch_fused import (
    DEC_CFG,
    DEC_JCFG,
    _j,
    _t,
    decoder,  # noqa: F401  (a fixture)
)
import torch_threads  # noqa: F401  (one CPU thread: see the module)

STEP_TOL = 1e-5
LP_RTOL = 1e-4
L, B, T, D, L_ENC = 2, 3, 12, 32, 6


def _memory(seed=2, rows=B):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((rows, L_ENC, D)).astype(np.float32)


def _step_inputs(decoder, seed):
    """Caches of random rows (a step reads the slots before pos and
    nothing after) and JAX's cross K/V, padded from 6 to 16 slots that its
    kernels mask; the port gets the 6."""
    rng = np.random.default_rng(seed)
    _, _, ck, cv = j_init_fused_cache(_j(decoder), DEC_JCFG,
                                      jnp.asarray(_memory(seed)))
    assert ck.shape == (L, B, 16, D)
    sk, sv = (rng.standard_normal((L, B, T, D)).astype(np.float32)
              for _ in range(2))
    prev = rng.integers(0, DEC_CFG.vocab_size, B).astype(np.int32)
    return sk, sv, ck, cv, prev, rng


def _check_decode(got, want):
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(want.tokens))
    np.testing.assert_array_equal(got.token_count.numpy(),
                                  np.asarray(want.token_count))
    np.testing.assert_array_equal(got.lengths.numpy(),
                                  np.asarray(want.lengths))
    np.testing.assert_allclose(got.logprob_sum.numpy(),
                               np.asarray(want.logprob_sum), rtol=LP_RTOL,
                               atol=0)


@pytest.mark.parametrize("pos", [0, 5])
def test_layers_step_plain_matches_pallas(decoder, pos):
    """B11: x_out within 1e-5; the written slot of each cache within 1e-5
    and every other slot unchanged; the caches updated in place."""
    sk, sv, ck, cv, _, rng = _step_inputs(decoder, pos)
    x_emb = rng.standard_normal((B, D)).astype(np.float32)
    want = j_layers_step(j_build_stacked(_j(decoder), DEC_JCFG), DEC_JCFG,
                         jnp.asarray(x_emb), jnp.asarray(sk),
                         jnp.asarray(sv), ck, cv, jnp.int32(pos),
                         l_enc_actual=L_ENC, interpret=True)
    stacked = tstep.build_stacked(decoder, DEC_CFG)
    tk, tv = _t(sk), _t(sv)
    before = tstep.fused_decoder_layers_step.launches
    got = tstep.fused_decoder_layers_step(
        stacked, DEC_CFG, _t(x_emb), tk, tv, _t(ck[:, :, :L_ENC]),
        _t(cv[:, :, :L_ENC]), pos)
    assert tstep.fused_decoder_layers_step.launches == before
    assert got[1] is tk and got[2] is tv
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               atol=STEP_TOL, rtol=STEP_TOL)
    other = np.arange(T) != pos
    for g, w, old in zip(got[1:], want[1:], (sk, sv)):
        w = np.asarray(w)
        np.testing.assert_array_equal(w[:, :, other], old[:, :, other])
        np.testing.assert_array_equal(g.numpy()[:, :, other],
                                      old[:, :, other])
        np.testing.assert_allclose(g.numpy()[:, :, pos], w[:, :, pos],
                                   atol=STEP_TOL, rtol=STEP_TOL)


@pytest.mark.parametrize("time_major", [True, False])
@pytest.mark.parametrize("pos", [0, 7])
def test_whole_step_plain_matches_pallas(decoder, time_major, pos):
    """B10 in both layouts: nxt equal, logp and the fresh rows within
    1e-5; time-major caches written at pos in place, batch-major ones read
    only and the rows returned. The JAX bundle pads the vocabulary to 128
    columns (a -1e9 head bias); the port's has the 20."""
    sk, sv, ck, cv, prev, _ = _step_inputs(decoder, 10 + pos)
    if time_major:
        sk, sv = (np.ascontiguousarray(a.transpose(0, 2, 1, 3))
                  for a in (sk, sv))
    want = j_whole_step(j_build_stacked_full(_j(decoder), DEC_JCFG),
                        DEC_JCFG, jnp.asarray(prev), jnp.asarray(sk),
                        jnp.asarray(sv), ck, cv, jnp.int32(pos),
                        l_enc_actual=L_ENC, interpret=True,
                        time_major=time_major)
    stacked = tstep.build_stacked_full(decoder, DEC_CFG)
    tk, tv = _t(sk), _t(sv)
    before = tstep.fused_whole_step.launches
    got = tstep.fused_whole_step(stacked, DEC_CFG, _t(prev), tk, tv,
                                 _t(ck[:, :, :L_ENC]), _t(cv[:, :, :L_ENC]),
                                 pos, time_major=time_major)
    assert tstep.fused_whole_step.launches == before
    assert got[0].dtype == torch.int32
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
            np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                       atol=STEP_TOL, rtol=STEP_TOL)


@pytest.mark.parametrize("quantize", [False, True])
def test_whole_decode_plain_matches_pallas(decoder, quantize):
    """B12 with the float and the int8 resident bundle: tokens, lengths and
    counts equal, log-prob sums within 1e-4 relative."""
    memory = _memory()
    want = j_whole_decode(j_build_resident(_j(decoder), DEC_JCFG, quantize),
                          DEC_JCFG, jnp.asarray(memory), T, interpret=True)
    tparams = convert.to_torch(decoder, DEC_CFG, "cpu")
    resident = twhole.build_resident(tparams, DEC_CFG, quantize)
    assert (resident["w_qkv"].dtype == torch.int8) == quantize
    before = (twhole.fused_whole_decode.launches,
              twhole.fused_whole_decode.int8_launches)
    got = twhole.fused_whole_decode(resident, DEC_CFG, _t(memory), T)
    assert (twhole.fused_whole_decode.launches,
            twhole.fused_whole_decode.int8_launches) == before
    assert got.tokens.dtype == torch.int32
    _check_decode(got, want)


@pytest.mark.parametrize("variant", ["v1", "v2m", "v3", "v4", "v5"])
def test_greedy_decode_fused_variant_matches_jax(decoder, variant):
    """Each arm from ``build_stacked``'s bundle, as the JAX A/B scripts
    call it (v3, v4 and v5 build their own), against JAX's arm and the
    port's default v2."""
    memory = _memory()
    jparams = _j(decoder)
    want = j_greedy_decode_fused(jparams, j_build_stacked(jparams, DEC_JCFG),
                                 DEC_JCFG, jnp.asarray(memory), T,
                                 interpret=True, variant=variant)
    tparams = convert.to_torch(decoder, DEC_CFG, "cpu")
    stacked = tstep.build_stacked(decoder, DEC_CFG)
    got = tfused.greedy_decode_fused(tparams, stacked, DEC_CFG, _t(memory),
                                     T, variant=variant)
    _check_decode(got, want)
    v2 = tfused.greedy_decode_fused(tparams, stacked, DEC_CFG, _t(memory), T)
    assert torch.equal(got.tokens, v2.tokens)
    assert got.steps == v2.steps


def _eos_decoder(decoder, boost):
    tree = {k: v for k, v in decoder.items()}
    tree["fc_out"] = {"w": decoder["fc_out"]["w"],
                      "b": np.array(decoder["fc_out"]["b"], np.float32)}
    tree["fc_out"]["b"][EOS_ID] += boost
    return tree


def _check_finishing(got, eos_id, pad_id):
    """After its EOS a row emits PAD; its count is its EOS step; the loop
    ran to the step where the last row finished, or to T."""
    ends = []
    for row, count in zip(got.tokens.numpy(), got.token_count.numpy()):
        hits = np.flatnonzero(row == eos_id)
        if hits.size:
            assert (row[hits[0] + 1:] == pad_id).all()
            assert count == hits[0]
            ends.append(int(hits[0]))
        else:
            ends.append(None)
    np.testing.assert_array_equal(got.lengths.numpy(),
                                  (got.tokens != pad_id).sum(-1).numpy())
    done = [e for e in ends if e is not None]
    assert got.steps == (max(done) + 1 if len(done) == len(ends) else T)
    return ends


@pytest.mark.parametrize("variant", ["v4", "v5"])
def test_eos_semantics_match_jax(decoder, variant):
    """An EOS that rows reach at different steps and one row never (its
    head bias raised by 2.5): after its EOS a row emits PAD, its log-prob
    sum and count freeze; all as JAX's arm (whose v5 runs every step)."""
    boosted = _eos_decoder(decoder, 2.5)
    memory = _memory(seed=5, rows=4)
    jparams = _j(boosted)
    want = j_greedy_decode_fused(jparams, j_build_stacked(jparams, DEC_JCFG),
                                 DEC_JCFG, jnp.asarray(memory), T,
                                 interpret=True, variant=variant)
    tparams = convert.to_torch(boosted, DEC_CFG, "cpu")
    got = tfused.greedy_decode_fused(
        tparams, tstep.build_stacked(boosted, DEC_CFG), DEC_CFG,
        _t(memory), T, variant=variant)
    _check_decode(got, want)
    ends = _check_finishing(got, EOS_ID, PAD_ID)
    assert None in ends and len({e for e in ends if e is not None}) > 1


@pytest.mark.parametrize("variant", ["v1", "v3", "v4"])
def test_variants_refuse_an_int8_bundle(decoder, variant):
    tparams = convert.to_torch(decoder, DEC_CFG, "cpu")
    stacked = tstep.quantize_stacked(tstep.build_stacked_full(decoder,
                                                              DEC_CFG))
    with pytest.raises(ValueError, match="int8"):
        tfused.greedy_decode_fused(tparams, stacked, DEC_CFG,
                                   _t(_memory()), T, variant=variant)


def test_unknown_variant_is_refused(decoder):
    tparams = convert.to_torch(decoder, DEC_CFG, "cpu")
    with pytest.raises(ValueError, match="variant"):
        tfused.greedy_decode_fused(tparams, {}, DEC_CFG, _t(_memory()), T,
                                   variant="v6")


@pytest.mark.parametrize("quantize", [False, True])
def test_v5_auto_build_follows_the_bundle(decoder, quantize):
    """v5 given a bundle without the tables builds ``build_resident``'s,
    int8 exactly when the given one was quantized, as JAX: the tokens of
    JAX's v5 from the same bundle, and of the port's v5 from the resident
    bundle built outright."""
    memory = _memory(seed=6)
    jparams = _j(decoder)
    jstacked = j_build_stacked(jparams, DEC_JCFG)
    stacked = tstep.build_stacked(decoder, DEC_CFG)
    if quantize:
        jstacked = j_quantize_stacked(jstacked)
        stacked = tstep.quantize_stacked(stacked)
    want = j_greedy_decode_fused(jparams, jstacked, DEC_JCFG,
                                 jnp.asarray(memory), T, interpret=True,
                                 variant="v5")
    tparams = convert.to_torch(decoder, DEC_CFG, "cpu")
    got = tfused.greedy_decode_fused(tparams, stacked, DEC_CFG, _t(memory),
                                     T, variant="v5")
    _check_decode(got, want)
    outright = twhole.fused_whole_decode(
        twhole.build_resident(tparams, DEC_CFG, quantize), DEC_CFG,
        _t(memory), T)
    assert torch.equal(got.tokens, outright.tokens.long())


@pytest.mark.parametrize("variant", ["v2", "v1", "v4", "v5"])
def test_special_token_ids_match_jax(decoder, variant):
    """Non-default sos/eos/pad ids (4, 5, 6), with the head bias of id 5
    raised by 1.25 so that every row finishes, two at step 9: the tokens,
    lengths, counts and sums of JAX's arm with the same ids, and the
    decode ends at step 10 of 12."""
    ids = {"sos_id": 4, "eos_id": 5, "pad_id": 6}
    boosted = _eos_decoder(decoder, 0.0)
    boosted["fc_out"]["b"][5] += 1.25
    memory = _memory(seed=5, rows=4)
    jparams = _j(boosted)
    want = j_greedy_decode_fused(jparams, j_build_stacked(jparams, DEC_JCFG),
                                 DEC_JCFG, jnp.asarray(memory), T,
                                 interpret=True, variant=variant, **ids)
    tparams = convert.to_torch(boosted, DEC_CFG, "cpu")
    got = tfused.greedy_decode_fused(
        tparams, tstep.build_stacked(boosted, DEC_CFG), DEC_CFG,
        _t(memory), T, variant=variant, **ids)
    _check_decode(got, want)
    assert _check_finishing(got, 5, 6) == [0, 0, 9, 9]
    assert got.steps == 10
