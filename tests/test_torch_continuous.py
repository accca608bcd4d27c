"""Continuous batching (``decode/continuous.py``) of the port against the
JAX package's, on both routes.

The config is ``tests/test_continuous.py``'s (d_model 32, 4 heads, 2
decoder layers, FFN 64, T 12, vocab 20, a two-stage Swin on 96x320
images, float32), its weights JAX's ``init_model`` with every bias and
LayerNorm parameter made nonzero and the end-of-sequence logit raised, so
that rows finish at different steps and slots are recycled. Inputs are
made with numpy from a seed. On the CPU the port's wrappers run their
plain versions; JAX's ragged step kernel runs in Pallas interpret mode,
as its own tests run it.

What is held here: the ragged decoder step and the cross K/V projection
of the default route; the ragged step B7's plain version in ring mode and
with ``n_chunks`` against the JAX kernel, and every ValueError of its
options; a fused segment with and without the ring against JAX's on one
ragged state. ``tests/test_torch_continuous_decoder.py`` holds
``ContinuousDecoder`` itself (the two files split the module's cases so
that the test run's workers share them), on this file's config and
helpers.

Tolerances: logits and float32 step outputs at 1e-5 (float32 sums over
at most 32 terms in other orders, then LayerNorm; the int8 bundle's at
5e-3, as ``tests/test_torch_quant.py`` states it); log-prob sums at 1e-5
in a segment, confidences at 1e-4 (JAX's tests' bound); tokens, positions
and strings exactly.
"""

import hashlib

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from handwritten_math_ocr_api_tpu.core.tokenizer import Tokenizer as JTokenizer
from handwritten_math_ocr_api_tpu.decode import continuous as jcont
from handwritten_math_ocr_api_tpu.models import decoder as jdec
from handwritten_math_ocr_api_tpu.models.model import init_model
from handwritten_math_ocr_api_tpu.ops.fused_step import (
    build_stacked_full as j_build_stacked_full,
    fused_ragged_step as j_ragged_step,
    quantize_stacked as j_quantize_stacked,
)

from handwritten_math_ocr_api_torch import convert
from handwritten_math_ocr_api_torch.core import config as tcfg
from handwritten_math_ocr_api_torch.core.config import DecodeConfig, EOS_ID
from handwritten_math_ocr_api_torch.core.tokenizer import Tokenizer
from handwritten_math_ocr_api_torch.decode import api as tapi
from handwritten_math_ocr_api_torch.decode import continuous as tcont
from handwritten_math_ocr_api_torch.models import decoder as tdec
from handwritten_math_ocr_api_torch.ops import fused_step as tstep

from test_torch_fused import _j, _t, jitter
from test_torch_models import jax_config
import torch_threads  # noqa: F401  (one CPU thread: see the module)

CFG = tcfg.ModelConfig(
    d_model=32, nhead=4, dim_feedforward=64, dropout=0.0,
    num_decoder_layers=2, max_seq_len=12, vocab_size=20, dtype="float32",
    swin=tcfg.SwinConfig(embed_dim=8, depths=(1, 1), num_heads=(2, 2),
                         window_size=4, stochastic_depth=0.0))
L, T, D = 2, 12, 32
STEP_TOL = 1e-5
INT8_STEP_ATOL = 5e-3
CONF_TOL = 1e-4
VOCAB = {"<pad>": 0, "<sos>": 1, "<eos>": 2, "<unk>": 3,
         **{f"t{i}": i for i in range(4, 20)}}
# added to the end-of-sequence logit's bias, per KV-head count: some rows
# of _images finish in 1-4 steps (the first ones with the fallback
# string), the others run all 12
EOS_BOOST = {4: 3.0, 2: 2.0, 1: 1.5}


def _cfgs(nhead_kv=4):
    cfg = CFG.replace(nhead_kv=nhead_kv)
    return cfg, jax_config(cfg)


@pytest.fixture(scope="module")
def trees():
    """Per KV-head count, the model's weights as a numpy tree (nonzero
    biases and norms, the eos logit raised)."""
    out = {}
    for kv in (4, 2, 1):
        _, jcfg = _cfgs(kv)
        params, _ = init_model(jax.random.PRNGKey(kv), jcfg)
        tree = jitter(params, seed=20 + kv)
        tree["decoder"]["fc_out"]["b"][EOS_ID] += EOS_BOOST[kv]
        out[kv] = tree
    return out


def _images(n, seed):
    """Normal noise at a brightness and contrast of its own per image."""
    rng = np.random.default_rng(seed)
    offset = rng.uniform(-1, 1, (n, 1, 1, 1))
    scale = rng.uniform(0.2, 2.0, (n, 1, 1, 1))
    noise = rng.standard_normal((n, CFG.img_h, CFG.img_w, 1))
    return (offset + scale * noise).astype(np.float32)


def _jax_decoder(tree, nhead_kv=4, **kw):
    return jcont.ContinuousDecoder(_j(tree), {}, _cfgs(nhead_kv)[1],
                                   JTokenizer(VOCAB), **kw)


def _decoder(tree, nhead_kv=4, **kw):
    return tcont.ContinuousDecoder(tree, _cfgs(nhead_kv)[0], Tokenizer(VOCAB),
                                   device="cpu", **kw)


_ENGINE_RESULTS = {}


def _engine_results(tree, images, nhead_kv=4, **kw):
    """The port's engine's results on ``images``, computed once for each
    (KV-head count, images, options) of a module's cases."""
    key = (nhead_kv, images.shape, hashlib.sha256(images.tobytes()).digest(),
           tuple(sorted(kw.items())))
    if key not in _ENGINE_RESULTS:
        engine = tapi.DecodeEngine(tree, _cfgs(nhead_kv)[0],
                                   DecodeConfig(max_seq_len=T),
                                   Tokenizer(VOCAB), device="cpu", **kw)
        _ENGINE_RESULTS[key] = engine.predict_with_confidence(images)
    return list(_ENGINE_RESULTS[key])


def _same(got, want):
    assert len(got) == len(want)
    for i, ((gl, gc), (wl, wc)) in enumerate(zip(got, want)):
        assert gl == wl, i
        assert abs(gc - wc) < CONF_TOL, i


# -- the default route's decoder functions ---------------------------------


@pytest.mark.parametrize("positions", ["uniform", "mixed"])
@pytest.mark.parametrize("nhead_kv", [4, 2, 1])
def test_decoder_step_ragged_matches_jax(trees, nhead_kv, positions):
    """Three steps of ``decoder_step_ragged`` on 4 rows, at one position
    for all rows or a position per row (a row past the cache included,
    which JAX clamps): the logits and the self caches after each step."""
    cfg, jcfg = _cfgs(nhead_kv)
    dec = trees[nhead_kv]["decoder"]
    rng = np.random.default_rng(nhead_kv)
    memory = rng.standard_normal((4, 6, D)).astype(np.float32)
    jc = jdec.init_cache(_j(dec), jcfg, jnp.asarray(memory), max_len=8)
    tdec_tree = convert.to_torch(dec, cfg, "cpu")
    tc = tdec.init_cache(tdec_tree, cfg, _t(memory), max_len=8)
    ids = rng.integers(0, cfg.vocab_size, (3, 4)).astype(np.int32)
    pos = (np.zeros(4, np.int32) if positions == "uniform"
           else np.array([0, 3, 7, 9], np.int32))
    for t in range(3):
        want, jc = jdec.decoder_step_ragged(_j(dec), jcfg,
                                            jnp.asarray(ids[t]),
                                            jnp.asarray(pos), jc)
        got = tdec.decoder_step_ragged(tdec_tree, cfg, _t(ids[t]), _t(pos),
                                       tc)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=STEP_TOL, rtol=1e-4)
        for name, w in jc.items():
            np.testing.assert_allclose(tc[name].numpy(), np.asarray(w),
                                       atol=STEP_TOL, rtol=1e-4,
                                       err_msg=name)
        pos = pos + 1


def test_project_cross_kv_matches_jax(trees):
    dec = trees[4]["decoder"]
    cfg, jcfg = _cfgs()
    memory = np.random.default_rng(5).standard_normal(
        (3, 7, D)).astype(np.float32)
    want = jdec.project_cross_kv(_j(dec), jcfg, jnp.asarray(memory))
    got = tdec.project_cross_kv(convert.to_torch(dec, cfg, "cpu"), cfg,
                                _t(memory))
    assert sorted(got) == sorted(want)
    for name, w in want.items():
        np.testing.assert_allclose(got[name].numpy(), np.asarray(w),
                                   atol=STEP_TOL, rtol=1e-4, err_msg=name)


# -- the ragged step B7: ring mode and n_chunks ----------------------------


RING_S = 8


def _ring_inputs(tree, cfg, jcfg, rows, seed):
    """A ragged step's inputs for a pool of ``rows``: caches and a ring of
    random values, positions over the whole cache, segment starts mixing
    0, pos and pos - (S - 1) (clamped to 0)."""
    rng = np.random.default_rng(seed)
    kvd = cfg.kv_dim
    sk, sv = (rng.standard_normal((L, rows, T, kvd)).astype(np.float32)
              for _ in range(2))
    ck, cv = (rng.standard_normal((L, rows, 6, D)).astype(np.float32)
              for _ in range(2))
    rk, rv = (rng.standard_normal((L, rows, RING_S, kvd)).astype(np.float32)
              for _ in range(2))
    pos = rng.integers(0, T, rows).astype(np.int32)
    pos[:3] = [0, T - 1, 5]
    kind = np.arange(rows) % 3
    seg = np.where(kind == 0, 0, np.where(kind == 1, pos, pos - (RING_S - 1)))
    seg = np.clip(np.maximum(seg, pos - (RING_S - 1)), 0, None)
    prev = rng.integers(0, cfg.vocab_size, rows).astype(np.int32)
    return prev, pos, seg.astype(np.int32), (sk, sv, ck, cv), (rk, rv)


@pytest.mark.parametrize("quantize", [False, True])
@pytest.mark.parametrize("nhead_kv", [4, 1])
@pytest.mark.parametrize("rows,n_chunks", [(16, None), (32, None), (32, 1)])
def test_ragged_ring_plain_matches_pallas(trees, rows, n_chunks, nhead_kv,
                                          quantize):
    """B7's plain version in ring mode against the TPU kernel in interpret
    mode (float and int8 bundles, MHA and MQA), on the rows it computes
    (with ``n_chunks`` the first 16 of 32): argmax, log-probability and
    the fresh K/V rows."""
    cfg, jcfg = _cfgs(nhead_kv)
    dec = trees[nhead_kv]["decoder"]
    prev, pos, seg, caches, ring = _ring_inputs(dec, cfg, jcfg, rows,
                                                60 + rows)
    jst = j_build_stacked_full(_j(dec), jcfg)
    tst = tstep.build_stacked_full(dec, cfg)
    if quantize:
        jst, tst = j_quantize_stacked(jst), tstep.quantize_stacked(tst)
    want = j_ragged_step(jst, jcfg, jnp.asarray(prev), jnp.asarray(pos),
                         *(jnp.asarray(a) for a in caches), 6, block_b=16,
                         n_chunks=n_chunks, seg_start=jnp.asarray(seg),
                         ring_k=jnp.asarray(ring[0]),
                         ring_v=jnp.asarray(ring[1]), interpret=True)
    args = (tst, cfg, _t(prev), _t(pos), *(_t(a) for a in caches))
    ring_kw = {"seg_start": _t(seg), "ring_k": _t(ring[0]),
               "ring_v": _t(ring[1]), "n_chunks": n_chunks}
    got = tstep.fused_ragged_step(*args, **ring_kw)
    run = rows if n_chunks is None else 16
    atol = INT8_STEP_ATOL if quantize else STEP_TOL
    held = np.ones(run, dtype=bool)
    if quantize:  # the argmax where the logits are no near-tie
        top2 = tstep.fused_ragged_step(*args, return_logits=True,
                                       **ring_kw)[0][:run].topk(2).values
        held = (top2[:, 0] - top2[:, 1]).numpy() > 2 * INT8_STEP_ATOL
    np.testing.assert_array_equal(got[0].numpy()[:run][held],
                                  np.asarray(want[0])[:run][held])
    np.testing.assert_allclose(got[1].numpy()[:run],
                               np.asarray(want[1])[:run], atol=atol,
                               rtol=STEP_TOL)
    for name, g, w in zip(("k_new", "v_new"), got[2:], want[2:]):
        np.testing.assert_allclose(g.numpy()[:, :run], np.asarray(w)[:, :run],
                                   atol=atol, rtol=STEP_TOL, err_msg=name)
    if run < rows:  # the plain version marks the rows it did not compute
        assert (got[0].numpy()[run:] == -1).all()
        assert np.isnan(got[2].numpy()[:, run:]).all()


def test_ragged_ring_matches_cache_without_ring(trees):
    """A ring holding a row's slots [seg, pos) gives what the cache
    holding them gives without the ring."""
    cfg, jcfg = _cfgs()
    dec = trees[4]["decoder"]
    prev, pos, seg, (sk, sv, ck, cv), (rk, rv) = _ring_inputs(
        dec, cfg, jcfg, 16, 70)
    for r in range(16):
        for t in range(seg[r], pos[r]):
            sk[:, r, t], sv[:, r, t] = rk[:, r, t - seg[r]], rv[:, r, t - seg[r]]
    tst = tstep.build_stacked_full(dec, cfg)
    args = (tst, cfg, _t(prev), _t(pos), *(_t(a) for a in (sk, sv, ck, cv)))
    want = tstep.fused_ragged_step(*args, return_logits=True)
    got = tstep.fused_ragged_step(*args, return_logits=True,
                                  seg_start=_t(seg), ring_k=_t(rk),
                                  ring_v=_t(rv))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=STEP_TOL,
                                   rtol=STEP_TOL)


# (keyword arguments, rows): each must raise ValueError in both
BAD_OPTIONS = [
    ({"n_chunks": 0}, 32),
    ({"n_chunks": 3}, 32),
    ({"n_chunks": 1}, 24),
    ({"n_chunks": 1, "block_b": 12}, 24),
    ({"block_b": 12}, 24),
    ({"t_active": 0}, 16),
    ({"t_active": T + 1}, 16),
    ({"ring": ("seg_start", "ring_k")}, 16),
    ({"ring": ("ring_k", "ring_v")}, 16),
]


@pytest.mark.parametrize("kw,rows", BAD_OPTIONS)
def test_ragged_step_value_errors_match_jax(trees, kw, rows):
    cfg, jcfg = _cfgs()
    dec = trees[4]["decoder"]
    prev, pos, seg, caches, (rk, rv) = _ring_inputs(dec, cfg, jcfg, rows, 80)
    kw = dict(kw)
    given = {"seg_start": seg, "ring_k": rk, "ring_v": rv}
    for name in kw.pop("ring", ()):
        kw[name] = given[name]
    jkw = {k: jnp.asarray(v) if isinstance(v, np.ndarray) else v
           for k, v in kw.items()}
    tkw = {k: _t(v) if isinstance(v, np.ndarray) else v
           for k, v in kw.items()}
    with pytest.raises(ValueError):
        j_ragged_step(j_build_stacked_full(_j(dec), jcfg), jcfg,
                      jnp.asarray(prev), jnp.asarray(pos),
                      *(jnp.asarray(a) for a in caches), 6, interpret=True,
                      **jkw)
    with pytest.raises(ValueError):
        tstep.fused_ragged_step(tstep.build_stacked_full(dec, cfg), cfg,
                                _t(prev), _t(pos), *(_t(a) for a in caches),
                                **tkw)


def test_ragged_step_port_only_refusals(trees):
    """Documented where the port is stricter than JAX: a ring argument
    without ``ring_k`` (JAX ignores it), a segment start outside
    [pos - (S - 1), pos] (the kernel makes the row dead; the plain version
    raises); and where it is laxer: a pool that is no multiple of
    ``block_b`` without ``n_chunks`` (the beam's rows)."""
    cfg, jcfg = _cfgs()
    dec = trees[4]["decoder"]
    tst = tstep.build_stacked_full(dec, cfg)
    prev, pos, seg, caches, (rk, rv) = _ring_inputs(dec, cfg, jcfg, 16, 81)
    args = (tst, cfg, _t(prev), _t(pos), *(_t(a) for a in caches))
    with pytest.raises(ValueError, match="ring mode"):
        tstep.fused_ragged_step(*args, seg_start=_t(seg))
    bad = seg.copy()
    bad[1] = pos[1] + 1
    with pytest.raises(ValueError, match="segment start"):
        tstep.fused_ragged_step(*args, seg_start=_t(bad), ring_k=_t(rk),
                                ring_v=_t(rv))
    prev, pos, _, caches, _ = _ring_inputs(dec, cfg, jcfg, 5, 82)
    out = tstep.fused_ragged_step(tst, cfg, _t(prev), _t(pos),
                                  *(_t(a) for a in caches))
    assert out[0].shape == (5,)


# -- segments ----------------------------------------------------------------


@pytest.mark.parametrize("nhead_kv", [4, 1])
def test_fused_segment_ring_matches_plain_and_jax(trees, nhead_kv):
    """JAX's ``test_fused_ring_segment_matches_plain_exact`` state (16 rows
    at mixed positions, some finished, some inactive): one segment of 4
    steps with ``ring_s=8`` equals ``ring_s=0`` and JAX's, on tokens,
    positions and finished flags exactly, log-prob sums at 1e-5 and the
    self caches on each row's written slots."""
    cfg, jcfg = _cfgs(nhead_kv)
    dec = trees[nhead_kv]["decoder"]
    B, kvd = 16, cfg.kv_dim
    rng = np.random.default_rng(11)
    sk, sv = ((rng.standard_normal((L, B, T, kvd)) * 0.2).astype(np.float32)
              for _ in range(2))
    ck, cv = ((rng.standard_normal((L, B, CFG.encoder_len, D)) * 0.2
               ).astype(np.float32) for _ in range(2))
    pos = rng.integers(0, 7, B).astype(np.int32)
    active = rng.random(B) < 0.8
    finished = (rng.random(B) < 0.25) & active
    prev = rng.integers(4, cfg.vocab_size, B).astype(np.int32)
    state = dict(prev=prev, pos=pos, active=active, finished=finished,
                 tokens=np.zeros((B, T), np.int32),
                 lp_sum=np.zeros(B, np.float32), count=np.zeros(B, np.int32))
    jsmall = jcont.SmallState(**{k: jnp.asarray(v) for k, v in state.items()})
    jcache = {"self_k": jnp.asarray(sk), "self_v": jnp.asarray(sv),
              "cross_k": jnp.asarray(ck), "cross_v": jnp.asarray(cv)}
    j_s, j_c = jcont.decode_segment_fused(
        j_build_stacked_full(_j(dec), jcfg), jcfg, jsmall, dict(jcache),
        jnp.int32(4), CFG.encoder_len, ring_s=8)
    tst = tstep.build_stacked_full(dec, cfg)
    outs = {}
    for ring_s in (0, 8):
        small = tcont.SmallState(**{k: _t(v) for k, v in state.items()})
        cache = {k: _t(v) for k, v in
                 (("self_k", sk), ("self_v", sv), ("cross_k", ck),
                  ("cross_v", cv))}
        outs[ring_s] = tcont.decode_segment_fused(tst, cfg, small, cache, 4,
                                                  ring_s=ring_s)
    for s, c in outs.values():
        for name in ("prev", "pos", "finished", "tokens", "count"):
            np.testing.assert_array_equal(getattr(s, name).numpy(),
                                          np.asarray(getattr(j_s, name)),
                                          err_msg=name)
        np.testing.assert_allclose(s.lp_sum.numpy(), np.asarray(j_s.lp_sum),
                                   atol=STEP_TOL, rtol=STEP_TOL)
        valid = (np.arange(T)[None, :]
                 < np.asarray(j_s.pos)[:, None])[None, :, :, None]
        for name in ("self_k", "self_v"):
            np.testing.assert_allclose(
                np.where(valid, c[name].numpy(), 0.0),
                np.where(valid, np.asarray(j_c[name])[:, :, :T], 0.0),
                atol=STEP_TOL, rtol=STEP_TOL, err_msg=name)


def test_pack_report_roundtrip():
    """pack_report / unpack_report are exact inverses (the lp_sum bitcast
    of negative values, the flags), and equal JAX's packing."""
    rng = np.random.default_rng(0)
    S = 5
    state = dict(
        prev=rng.integers(0, 20, S).astype(np.int32),
        pos=rng.integers(0, 7, S).astype(np.int32),
        active=np.array([1, 0, 1, 1, 0], bool),
        finished=np.array([0, 1, 0, 1, 0], bool),
        tokens=rng.integers(0, 20, (S, 7)).astype(np.int32),
        lp_sum=np.array([-3.25, 0.0, -17.5, -0.001, 2.5], np.float32),
        count=rng.integers(0, 7, S).astype(np.int32))
    packed = tcont.pack_report(
        tcont.SmallState(**{k: _t(v) for k, v in state.items()})).numpy()
    np.testing.assert_array_equal(packed, np.asarray(jcont.pack_report(
        jcont.SmallState(**{k: jnp.asarray(v) for k, v in state.items()}))))
    rep = tcont.unpack_report(packed)
    for name in ("finished", "count", "tokens", "lp_sum"):
        np.testing.assert_array_equal(rep[name], state[name], err_msg=name)
