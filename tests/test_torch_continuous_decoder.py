"""``ContinuousDecoder`` (``decode/continuous.py``) of the port against the
JAX package's and the port's engine.

``run_all`` on both routes (ring on and off, MQA, GQA-2 falling back,
int8, the whole-block kernel in the admissions' encode) against JAX's
``ContinuousDecoder`` and the port's ``DecodeEngine``; the scheduler cases
of JAX's ``tests/test_continuous.py`` and ``tests/test_cancel.py``; the
refusals. The config, weights, images and tolerances are
``tests/test_torch_continuous.py``'s (split from it so that the test run's
workers share the two halves); the engine's results are computed once a
case's key (``_engine_results``).
"""

import logging

import numpy as np
import pytest
import torch

from handwritten_math_ocr_api_torch.core.tokenizer import Tokenizer
from handwritten_math_ocr_api_torch.decode import continuous as tcont

from test_torch_continuous import (  # noqa: F401  (trees: a fixture)
    CFG,
    T,
    VOCAB,
    _decoder,
    _engine_results,
    _images,
    _jax_decoder,
    _same,
    trees,
)
import torch_threads  # noqa: F401  (one CPU thread: see the module)


# -- the decoder against JAX's and the engine ---------------------------------


# (route options, nhead_kv): the default route, the fused one with and
# without the ring, MQA fused, GQA-2 asking for fused (default route)
ROUTES = [
    ({}, 4),
    ({"use_fused": True}, 4),
    ({"use_fused": True, "segment_ring": False}, 4),
    ({"use_fused": True}, 1),
    ({"use_fused": True}, 2),
]


@pytest.mark.parametrize("opts,nhead_kv", ROUTES)
def test_run_all_matches_jax_and_engine(trees, caplog, opts, nhead_kv):
    """Six images through 4 slots (slots recycled): the port's run_all
    equals JAX's ContinuousDecoder with the same options and the port's
    DecodeEngine on the same route."""
    tree = trees[nhead_kv]
    images = _images(6, 30 + nhead_kv)
    kw = dict(num_slots=4, segment_steps=3, encode_buckets=(1, 2, 4), **opts)
    want = _jax_decoder(tree, nhead_kv, **kw).run_all(list(images))
    with caplog.at_level(logging.WARNING):
        dec = _decoder(tree, nhead_kv, **kw)
    assert dec.use_fused == (opts.get("use_fused", False) and nhead_kv != 2)
    if nhead_kv == 2:
        assert any("GQA" in r.getMessage() for r in caplog.records)
    got = dec.run_all(list(images))
    _same(got, want)
    _same(got, _engine_results(tree, images, nhead_kv,
                               use_fused=dec.use_fused))
    assert dec.idle and dec.stats["segments_run"] >= 3


def test_run_all_int8_matches_jax(trees):
    """``quantize=True`` on the fused route: the int8 bundle through B7's
    int8 entries, against JAX's int8 continuous decoder and the port's
    fused int8 engine."""
    tree = trees[4]
    images = _images(3, 40)
    kw = dict(num_slots=3, segment_steps=4, encode_buckets=(1, 2),
              pipeline_depth=2, use_fused=True, quantize=True)
    jax_dec = _jax_decoder(tree, **kw)
    dec = _decoder(tree, **kw)
    assert dec._shards[0].seg_params["w_qkv"].dtype == torch.int8
    got = dec.run_all(list(images))
    assert [g[0] for g in got] == [w[0] for w in
                                   jax_dec.run_all(list(images))]
    assert [g[0] for g in got] == [w[0] for w in _engine_results(
        tree, images, use_fused=True, quantize=True)]


def test_pallas_encoder_block_matches_engine(trees):
    """The fused route with the whole Swin block kernel in each admission's
    encode equals the port's engine with the same switches."""
    tree = trees[4]
    images = _images(3, 41)
    dec = _decoder(tree, num_slots=2, segment_steps=4,
                   encode_buckets=(1, 2), use_fused=True,
                   pallas_encoder_block=True)
    _same(dec.run_all(list(images)),
          _engine_results(tree, images, use_fused=True,
                          pallas_encoder_block=True))


# -- the scheduler -----------------------------------------------------------


def _trickle(dec, images, first):
    """Submit ``first`` images, then one a tick; return results by
    submission order."""
    ids = [dec.submit(img) for img in images[:first]]
    results = {}
    submitted = first
    while not dec.idle:
        results.update(dec.step_once())
        if submitted < len(images):
            ids.append(dec.submit(images[submitted]))
            submitted += 1
    assert len(results) == len(images)
    return [results[i] for i in ids]


@pytest.mark.parametrize("use_fused", [False, True])
def test_midflight_admission(trees, use_fused):
    """Requests submitted while decoding runs (2 slots, 6 requests) equal
    the engine's results, and slots are recycled."""
    tree = trees[4]
    images = _images(6, 2)
    dec = _decoder(tree, num_slots=2, segment_steps=3,
                   encode_buckets=(1, 2), use_fused=use_fused)
    _same(_trickle(dec, images, 2), _engine_results(tree, images))
    assert dec.stats["avg_occupancy"] > 0.4


def test_deep_pipeline_trickle(trees):
    """pipeline_depth 6, one admission a tick into 3 slots: the admission
    generations keep stale reports from harvesting re-admitted slots."""
    tree = trees[4]
    images = _images(10, 5)
    dec = _decoder(tree, num_slots=3, segment_steps=2,
                   encode_buckets=(1, 2), pipeline_depth=6, use_fused=True)
    _same(_trickle(dec, images, 1), _engine_results(tree, images))
    st = dec.stats
    assert st["segments_run"] > 0 and st["in_flight"] == 0
    assert 0.0 < st["work_occupancy"] <= 1.0
    assert st["avg_occupancy"] > 0.3


def test_bucketed_pool_rows_scheduled(trees):
    """33 slots pad to 48 rows (chunk buckets 1, 2, 3); 5 live low slots
    never need more than one chunk, as in JAX."""
    tree = trees[4]
    images = _images(5, 9)
    kw = dict(num_slots=33, segment_steps=3, encode_buckets=(1, 2, 4),
              pipeline_depth=2, use_fused=True)
    jax_dec = _jax_decoder(tree, **kw)
    want = jax_dec.run_all(list(images))
    dec = _decoder(tree, **kw)
    assert dec._seg_buckets == jax_dec._seg_buckets == [1, 2, 3]
    assert dec._shards[0].small.prev.shape[0] == 48
    _same(dec.run_all(list(images)), want)
    # the same rule as JAX's (the segment counts depend on when reports
    # land, which differs between the two)
    assert dec.rows_scheduled == dec.steps_scheduled * 16
    assert jax_dec.rows_scheduled == jax_dec.steps_scheduled * 16


def test_adaptive_segment_length(trees):
    dec = _decoder(trees[4], num_slots=2, segment_steps=2,
                   max_segment_steps=8, encode_buckets=(1, 2))
    for img in _images(3, 6):
        dec.submit(img)
    dec._admit()
    assert dec._pick_segment_len() == 2   # pool full, one pending
    dec._pending.clear()
    assert dec._pick_segment_len() == 8   # full, nothing waiting
    dec._free.append(99)
    assert dec._pick_segment_len() == 2   # a free slot: an arrival soon


@pytest.mark.parametrize("use_fused", [False, True])
def test_cancel_pending_and_slotted(trees, use_fused):
    """JAX's ``tests/test_cancel.py``: cancel a slotted and a pending
    request after the first tick; the others equal the engine's, every
    slot returns to the free list, and the decoder serves again."""
    tree = trees[4]
    images = _images(5, 3)
    want = _engine_results(tree, images)
    kw = {"use_fused": True, "fused_block_b": 8} if use_fused else {}
    dec = _decoder(tree, num_slots=2, segment_steps=3,
                   encode_buckets=(1, 2), **kw)
    slotted, pending = (1, 3) if use_fused else (0, 4)
    ids = [dec.submit(img) for img in images]
    results = dec.step_once()
    assert ids[slotted] in dec._slot_req.values()
    assert any(r == ids[pending] for r, _ in dec._pending)
    assert dec.cancel(ids[slotted]) and dec.cancel(ids[pending])
    assert not dec.cancel(10_000)
    while not dec.idle:
        results.update(dec.step_once())
    dropped = {ids[slotted], ids[pending]}
    assert dropped.isdisjoint(results)
    _same([results[r] for i, r in enumerate(ids) if r not in dropped],
          [w for i, w in enumerate(want) if ids[i] not in dropped])
    assert dec.stats["cancelled"] == 2
    assert sorted(dec._free) == list(range(dec.num_slots))
    _same(dec.run_all(list(images[:2])), want[:2])


def test_fail_reset_drops_stale_reports(trees):
    """fail_reset with reports in flight: the stale ones (and a stale
    error) are dropped when they land, ``_inflight`` never goes negative,
    and a fresh request decodes as the engine does."""
    tree = trees[4]
    images = _images(3, 21)
    want = _engine_results(tree, images)
    dec = _decoder(tree, num_slots=2, segment_steps=2, encode_buckets=(1, 2),
                   pipeline_depth=3, use_fused=True)
    dec.submit(images[0])
    dec.submit(images[1])
    dec.step_once()
    dec.step_once()
    assert dec._inflight >= 1
    dec.fail_reset()
    assert dec._stale_before == dec._seg_counter + 1
    dec._ready_q.put((0, None, RuntimeError("stale device error")))
    dec._inflight += 1
    rid = dec.submit(images[2])
    results = {}
    while not dec.idle:
        results.update(dec.step_once())
    assert dec._inflight == 0
    _same([results[rid]], [want[2]])


def test_segment_error_carries_partial_results(trees):
    """A tick that takes a finished report and then an error report raises
    ContinuousSegmentError carrying the finished request's result."""
    dec = _decoder(trees[4], num_slots=2, segment_steps=T,
                   encode_buckets=(1,), use_fused=True)
    dec.harvest_threads = 0   # no harvester: land the reports by hand
    rid = dec.submit(_images(1, 23)[0])
    assert dec.step_once() == {}
    item = dec._fetch_q.get_nowait()
    dec._ready_q.put((item.seg_idx, dec._land(item), None))
    dec._ready_q.put((item.seg_idx + 97, None, RuntimeError("boom")))
    dec._inflight += 1
    dec.harvest_threads = 1
    with pytest.raises(tcont.ContinuousSegmentError) as ei:
        dec.step_once()
    assert rid in ei.value.partial_results
    assert ei.value.partial_results[rid][0] is not None
    assert isinstance(ei.value.__cause__, RuntimeError)
    assert dec._inflight == 0
    dec.close()


@pytest.mark.parametrize("ring", [True, False])
def test_warmup_on_live_state(trees, ring):
    """warmup() mid-decode advances the live slots by one segment a chunk
    bucket, their position bounds with them, and the results stay the
    engine's."""
    tree = trees[4]
    images = _images(2, 22)
    dec = _decoder(tree, num_slots=2, segment_steps=2, encode_buckets=(1, 2),
                   use_fused=True, segment_ring=ring, t_buckets=(4, 8))
    ids = [dec.submit(img) for img in images]
    results = dec.step_once()
    before = dict(dec._pos_ub)
    dec.warmup()
    for s, ub in dec._pos_ub.items():
        assert ub >= before.get(s, 0) + 2
    while not dec.idle:
        results.update(dec.step_once())
    _same([results[i] for i in ids], _engine_results(tree, images))


def test_recycled_slot_survives_nan_cache(trees):
    """Every self-cache slot NaN after a first generation (as garbage of
    rows past the computed chunks would leave it): the second generation
    on the same slots decodes as the engine does."""
    tree = trees[4]
    images = _images(4, 17)
    want = _engine_results(tree, images)
    for ring in (True, False):
        dec = _decoder(tree, num_slots=2, segment_steps=3,
                       encode_buckets=(1, 2), pipeline_depth=1,
                       use_fused=True, segment_ring=ring)
        got = dec.run_all(list(images[:2]))
        dec._shards[0].cache["self_k"].fill_(float("nan"))
        dec._shards[0].cache["self_v"].fill_(float("nan"))
        got += dec.run_all(list(images[2:]))
        assert all(np.isfinite(c) for _, c in got)
        _same(got, want)


# -- refusals ----------------------------------------------------------------


@pytest.mark.parametrize("kw,error", [
    ({"mesh": object()}, TypeError),
    ({"admission": "device", "mesh": object()}, ValueError),
    ({"constrained": True, "tokenizer": None}, ValueError),
    ({"admission": "nowhere"}, ValueError),
])
def test_refusals(trees, kw, error):
    kw = {"tokenizer": Tokenizer(VOCAB), **kw}
    with pytest.raises(error):
        tcont.ContinuousDecoder(trees[4], CFG, num_slots=2, device="cpu",
                                **kw)


def test_quantize_without_fused_warns(trees, caplog):
    """As JAX: a warning, and float weights on the default route."""
    with caplog.at_level(logging.WARNING):
        dec = _decoder(trees[4], num_slots=2, quantize=True)
    assert any("quantize" in r.getMessage() for r in caplog.records)
    assert not dec.use_fused
    assert dec.params["decoder"]["layers"][0]["self_attn"]["w_qkv"].dtype \
        == torch.float32


def test_decoder_without_device_needs_cuda(trees, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcont.ContinuousDecoder(trees[4], CFG, Tokenizer(VOCAB), num_slots=2)
