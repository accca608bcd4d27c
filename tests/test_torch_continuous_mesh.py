"""``ContinuousDecoder`` (``decode/continuous.py``) with its slot pool
sharded over a mesh's data axis, against the JAX package's single-device
decoder and the port's one-device decoder and engine.

The counterparts of ``tests/test_continuous.py``'s two mesh cases and
``tests/test_cancel.py``'s, on meshes of 2 and 4 shards on
``["cpu"] * n`` (``parallel/mesh.make_mesh``): both routes (the fused one
with and without the ring, int8, constrained), the pool's sizes and the
slots' shards, mid-flight admissions, cancel and ``fail_reset``,
``warmup`` on live state, ``stats`` and ``state``. The config, weights,
images and tolerances are ``tests/test_torch_continuous.py``'s.
"""

import numpy as np
import pytest
import torch

from handwritten_math_ocr_api_torch.parallel import mesh as mesh_lib

from test_torch_continuous import (  # noqa: F401  (trees: a fixture)
    _decoder,
    _engine_results,
    _images,
    _jax_decoder,
    _same,
    trees,
)
import torch_threads  # noqa: F401  (one CPU thread: see the module)


def _mesh(data):
    return mesh_lib.make_mesh(data=data, tensor=1, devices=["cpu"] * data)


def _trickle(dec, images, first):
    """Submit ``first`` images, then one a tick; results in order."""
    ids = [dec.submit(img) for img in images[:first]]
    results, n = {}, first
    while not dec.idle:
        results.update(dec.step_once())
        if n < len(images):
            ids.append(dec.submit(images[n]))
            n += 1
    return [results[i] for i in ids]


@pytest.mark.parametrize("data", [2, 4])
def test_continuous_sharded_over_mesh(trees, data):
    """The default route: the pool padded to a mesh multiple, and
    ``run_all`` equal to JAX's single-device decoder."""
    tree = trees[4]
    images = _images(6, 7)
    kw = dict(num_slots=4, segment_steps=4, encode_buckets=(1, 2, 4))
    want = _jax_decoder(tree, **kw).run_all(list(images))
    dec = _decoder(tree, mesh=_mesh(data), **kw)
    assert dec.state.prev.shape[0] == -(-5 // data) * data
    assert [sh.device.type for sh in dec._shards] == ["cpu"] * data
    _same(dec.run_all(list(images)), want)
    assert dec.stats["mesh"] == {"data": data, "tensor": 1}


@pytest.mark.parametrize("ring", [True, False])
def test_fused_continuous_sharded_over_mesh(trees, ring):
    """The fused route at data 4 and ``block_b`` 8: a 32-row pool of four
    8-row shards, no chunk buckets, and ``run_all`` equal to JAX's
    single-device fused decoder and to the port's engine."""
    tree = trees[4]
    images = _images(6, 13)
    kw = dict(num_slots=5, segment_steps=4, encode_buckets=(1, 2, 4),
              pipeline_depth=2, use_fused=True, fused_block_b=8,
              segment_ring=ring)
    want = _jax_decoder(tree, **kw).run_all(list(images))
    dec = _decoder(tree, mesh=_mesh(4), **kw)
    assert dec.use_fused and dec._seg_buckets is None
    assert dec.state.prev.shape[0] == 32
    assert [(sh.lo, sh.rows, sh.real) for sh in dec._shards] == [
        (0, 8, 5), (8, 8, 0), (16, 8, 0), (24, 8, 0)]
    got = dec.run_all(list(images))
    _same(got, want)
    _same(got, _engine_results(tree, images, use_fused=True))
    assert dec.stats["rows_scheduled"] == 32 * dec.steps_scheduled


@pytest.mark.parametrize("use_fused,data,slots,used", [(False, 4, 8, 3),
                                                        (True, 2, 12, 2)])
def test_slots_spread_over_shards(trees, use_fused, data, slots, used):
    """Requests on every shard's slots (default route: 8 slots on 4 shards
    of 3 rows; fused: 12 slots on 2 shards of 8), admitted mid-flight,
    equal to the port's one-device decoder."""
    tree = trees[4]
    images = _images(16, 17)
    kw = dict(num_slots=slots, segment_steps=3, encode_buckets=(1, 2, 4),
              use_fused=use_fused, fused_block_b=8)
    want = _trickle(_decoder(tree, **kw), images, slots - 2)
    dec = _decoder(tree, mesh=_mesh(data), **kw)
    assert {s // dec._rows for s in range(slots)} == set(range(used))
    _same(_trickle(dec, images, slots - 2), want)


def test_int8_and_constrained_on_mesh(trees):
    """The fused int8 bundle, and the pushdown constraint on both routes,
    sharded over 2 shards, equal to the one-device decoder."""
    tree = trees[4]
    images = _images(10, 19)
    for kw in ({"use_fused": True, "quantize": True},
               {"constrained": True},
               {"use_fused": True, "constrained": True}):
        kw = dict(num_slots=10, segment_steps=3, encode_buckets=(1, 2, 4),
                  **kw)
        _same(_decoder(tree, mesh=_mesh(2), **kw).run_all(list(images)),
              _decoder(tree, **kw).run_all(list(images)))


@pytest.mark.parametrize("use_fused", [False, True])
def test_cancel_sharded_over_mesh(trees, use_fused):
    """``tests/test_cancel.py``'s mesh case: cancel a slotted and a pending
    request after the first tick on a 4-shard pool; the others equal the
    engine's, every slot is free again, and the decoder serves again."""
    tree = trees[4]
    images = _images(6, 5)
    want = _engine_results(tree, images)
    dec = _decoder(tree, num_slots=4, segment_steps=3,
                   encode_buckets=(1, 2, 4), mesh=_mesh(4),
                   use_fused=use_fused, fused_block_b=8)
    ids = [dec.submit(img) for img in images]
    results = dec.step_once()
    slotted, pending = 2, 5
    assert ids[slotted] in dec._slot_req.values()
    assert dec.cancel(ids[slotted]) and dec.cancel(ids[pending])
    while not dec.idle:
        results.update(dec.step_once())
    dropped = {ids[slotted], ids[pending]}
    assert dropped.isdisjoint(results)
    _same([results[r] for r in ids if r not in dropped],
          [w for i, w in enumerate(want) if ids[i] not in dropped])
    assert sorted(dec._free) == list(range(dec.num_slots))
    _same(dec.run_all(list(images[:2])), want[:2])


def test_fail_reset_and_warmup_on_mesh(trees):
    """``fail_reset`` with reports in flight, then ``warmup`` on live state:
    later requests decode as the engine does."""
    tree = trees[4]
    images = _images(4, 21)
    want = _engine_results(tree, images, use_fused=True)
    dec = _decoder(tree, num_slots=3, segment_steps=2,
                   encode_buckets=(1, 2), pipeline_depth=3, use_fused=True,
                   fused_block_b=8, mesh=_mesh(2))
    dec.submit(images[0])
    dec.submit(images[1])
    dec.step_once()
    dec.fail_reset()
    ids = [dec.submit(img) for img in images[2:]]
    dec.step_once()
    dec.warmup()
    results = {}
    while not dec.idle:
        results.update(dec.step_once())
    _same([results[i] for i in ids], want[2:])


def test_state_concatenates_the_shards(trees):
    dec = _decoder(trees[4], num_slots=3, use_fused=True, fused_block_b=8,
                   mesh=_mesh(2))
    st = dec.state
    assert st.prev.shape == (16,) and st.tokens.shape == (16, 12)
    assert st.cache["self_k"].shape[1] == 16
    assert torch.equal(st.cache["cross_k"][:, :8],
                       dec._shards[0].cache["cross_k"])
    assert np.isfinite(st.lp_sum.numpy()).all()
