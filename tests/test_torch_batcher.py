"""The serving engines (``serve/batcher.py``) and the stage timers and trace
(``utils/profiling.py``) of the port, against the JAX package's.

The model is ``tests/test_cancel.py``'s (d_model 32, 4 heads, 2 decoder
layers, FFN 64, T 12, vocab 20, a two-stage Swin on 96x320 images,
float32), JAX's ``init_model`` weights with nonzero biases and norms as a
numpy tree; images are made with numpy from a seed. On the CPU the port's
wrappers run their plain versions.

What is held: results through ``BatchingEngine`` (drain-and-go, and the
timed linger) and ``ContinuousServingEngine`` equal to JAX's engine for
each image, whichever requests share a batch; JAX's cases of
``tests/test_cancel.py:177,211`` (a cancelled waiter is dropped before the
dispatch, or frees its slot; the survivors still decode right), its
deadline case (``PredictionTimeout``, the request cancelled in the
decoder), ``tests/test_serve.py``'s fault, stop and linger cases, and
``queue_limit`` backpressure on both engines, each run on the port's and
on JAX's engine with the same fakes; ``StageTimer`` against JAX's on one
schedule of stages; ``trace`` writing a Chrome trace. Confidences at 1e-4
(JAX's tests' bound); strings exactly.
"""

import asyncio
import json
import os
import time

import numpy as np
import pytest

import jax

from handwritten_math_ocr_api_tpu.core.config import (
    DecodeConfig as JDecodeConfig,
)
from handwritten_math_ocr_api_tpu.core.tokenizer import Tokenizer as JTokenizer
from handwritten_math_ocr_api_tpu.decode.api import DecodeEngine as JEngine
from handwritten_math_ocr_api_tpu.models.model import init_model
from handwritten_math_ocr_api_tpu.serve import batcher as jbatcher
from handwritten_math_ocr_api_tpu.utils import profiling as jprofiling

from handwritten_math_ocr_api_torch.core import config as tcfg
from handwritten_math_ocr_api_torch.core.config import DecodeConfig
from handwritten_math_ocr_api_torch.core.tokenizer import Tokenizer
from handwritten_math_ocr_api_torch.decode.api import DecodeEngine
from handwritten_math_ocr_api_torch.decode.continuous import ContinuousDecoder
from handwritten_math_ocr_api_torch.serve import batcher as tbatcher
from handwritten_math_ocr_api_torch.utils import profiling as tprofiling

from test_torch_fused import _j, jitter
from test_torch_models import jax_config
import torch_threads  # noqa: F401  (one CPU thread: see the module)

CFG = tcfg.ModelConfig(
    d_model=32, nhead=4, dim_feedforward=64, dropout=0.0,
    num_decoder_layers=2, max_seq_len=12, vocab_size=20, dtype="float32",
    swin=tcfg.SwinConfig(embed_dim=8, depths=(1, 1), num_heads=(2, 2),
                         window_size=4, stochastic_depth=0.0))
VOCAB = {"<pad>": 0, "<sos>": 1, "<eos>": 2, "<unk>": 3,
         **{f"t{i}": i for i in range(4, 20)}}
BUCKETS = (1, 2, 4, 8)
CONF_TOL = 1e-4
BOTH = [tbatcher, jbatcher]


@pytest.fixture(scope="module")
def model():
    """(numpy tree, 6 images, JAX's result for each image alone)."""
    params, _ = init_model(jax.random.PRNGKey(0), jax_config(CFG))
    tree = jitter(params, seed=9)
    tree["decoder"]["fc_out"]["b"][2] += 1.5  # rows end at 1-12 steps
    images = np.random.default_rng(6).standard_normal(
        (6, 96, 320, 1)).astype(np.float32)
    jeng = JEngine(_j(tree), {}, jax_config(CFG),
                   JDecodeConfig(max_seq_len=12, batch_buckets=BUCKETS),
                   JTokenizer(VOCAB))
    alone = [jeng.predict_with_confidence(img[None])[0] for img in images]
    return tree, images, alone


def _engine(tree):
    return DecodeEngine(tree, CFG,
                        DecodeConfig(max_seq_len=12, batch_buckets=BUCKETS),
                        Tokenizer(VOCAB), device="cpu")


def _continuous(tree, **kw):
    return ContinuousDecoder(tree, CFG, Tokenizer(VOCAB), num_slots=4,
                             segment_steps=3, encode_buckets=(1, 2, 4),
                             device="cpu", **kw)


def _same(got, want):
    assert got[0] == want[0], (got, want)
    assert abs(got[1] - want[1]) < CONF_TOL, (got, want)


class FakeEngine:
    """A decode engine that records its batch sizes."""

    def __init__(self, delay=0.0, fail_first=False):
        self.batch_sizes = []
        self.delay = delay
        self.fail_first = fail_first

    def predict_with_confidence(self, images):
        self.batch_sizes.append(len(images))
        if self.fail_first and len(self.batch_sizes) == 1:
            raise RuntimeError("injected device failure")
        time.sleep(self.delay)
        return [("x", 0.5)] * len(images)


class StuckDecoder:
    """Accepts submissions and never finishes them
    (``tests/test_cancel.py:130``)."""

    def __init__(self):
        self.ids, self.cancels, self.closed = [], [], False

    def submit(self, img):
        self.ids.append(len(self.ids) + len(self.cancels))
        return self.ids[-1]

    @property
    def idle(self):
        return not self.ids

    def step_once(self):
        time.sleep(0.005)
        return {}

    def cancel(self, rid):
        self.cancels.append(rid)
        self.ids.remove(rid)
        return True

    def close(self):
        self.closed = True

    @property
    def stats(self):
        return {}


IMG = np.zeros((8, 8, 1), np.float32)


# ---------------------------------------------------------------------------
# results against JAX's engine
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("linger_ms", [0.0, 50.0])
def test_batching_engine_equals_each_image_alone(model, linger_ms):
    """Six concurrent requests, four singles and a pair through
    ``predict_many``: each result is JAX's for its image decoded alone,
    whatever batches the collector made."""
    tree, images, alone = model
    eng = tbatcher.BatchingEngine(_engine(tree), max_batch_size=4,
                                  batch_timeout_ms=linger_ms)

    async def run():
        await eng.start()
        singles = [eng.predict(img) for img in images[:4]]
        got = await asyncio.gather(*singles, eng.predict_many(
            list(images[4:])))
        await eng.stop()
        return list(got[:4]) + list(got[4])

    got = asyncio.run(run())
    for g, w in zip(got, alone):
        _same(g, w)
    st = eng.stats
    assert st["images_decoded"] == 6 and st["mode"] == "dynamic"
    assert st["batches_run"] >= 2  # at most 4 a batch
    assert st["stages"]["decode"]["count"] == st["batches_run"]
    assert st["stages"]["queue_wait"]["count"] == 6


@pytest.mark.parametrize("fused", [False, True])
def test_continuous_serving_engine_equals_each_image_alone(model, fused):
    tree, images, alone = model
    dec = _continuous(tree, **({"use_fused": True} if fused else {}))
    eng = tbatcher.ContinuousServingEngine(dec)

    async def run():
        await eng.start()
        got = await asyncio.gather(*[eng.predict(img) for img in images])
        await eng.stop()
        return got

    for g, w in zip(asyncio.run(run()), alone):
        _same(g, w)
    st = eng.stats
    assert st["mode"] == "continuous" and st["cancelled_waiters"] == 0
    assert st["worker_iters"] > 0 and st["segments_run"] > 0
    assert not any(t.is_alive() for t in dec._harvesters)  # stop closed it


# ---------------------------------------------------------------------------
# cancellation, deadlines, backpressure, faults (JAX's cases)
# ---------------------------------------------------------------------------

def test_dynamic_batcher_drops_cancelled_waiters(model):
    """JAX ``test_cancel.py:177``: a waiter cancelled in the linger window
    takes no row of the dispatched batch; the others decode right."""
    tree, images, alone = model
    eng = tbatcher.BatchingEngine(_engine(tree), batch_timeout_ms=300.0)

    async def run():
        await eng.start()
        tasks = [asyncio.ensure_future(eng.predict(img))
                 for img in images[:3]]
        await asyncio.sleep(0.05)  # inside the linger window
        tasks[1].cancel()
        done = await asyncio.gather(*tasks, return_exceptions=True)
        await eng.stop()
        return done

    done = asyncio.run(run())
    assert isinstance(done[1], asyncio.CancelledError)
    _same(done[0], alone[0])
    _same(done[2], alone[2])
    assert eng.cancelled == 1 and eng.stats["cancelled_waiters"] == 1
    assert eng.total_batch_occupancy == 2


def test_serving_engine_cancel_on_disconnect(model):
    """JAX ``test_cancel.py:211``: a cancelled waiter's request is
    cancelled in the decoder, which frees its slot; the others decode
    right."""
    tree, images, alone = model
    dec = _continuous(tree)
    eng = tbatcher.ContinuousServingEngine(dec)

    async def run():
        await eng.start()
        tasks = [asyncio.ensure_future(eng.predict(img))
                 for img in images[:3]]
        await asyncio.sleep(0)  # let the submissions enqueue
        tasks[1].cancel()
        done = await asyncio.gather(*tasks, return_exceptions=True)
        for _ in range(200):  # the cancel lands on the scheduler thread
            if eng.cancelled:
                break
            await asyncio.sleep(0.01)
        await eng.stop()
        return done

    done = asyncio.run(run())
    assert isinstance(done[1], asyncio.CancelledError)
    _same(done[0], alone[0])
    _same(done[2], alone[2])
    assert eng.cancelled == 1 and eng.stats["cancelled_waiters"] == 1
    assert dec.idle and sorted(dec._free) == list(range(4))


@pytest.mark.parametrize("mod", BOTH, ids=["port", "jax"])
def test_request_timeout_cancels_in_the_decoder(mod):
    """JAX ``test_cancel.py:123``: a stuck decode raises
    ``PredictionTimeout`` at the deadline and cancels the request in the
    decoder; ``stop`` closes the decoder."""
    dec = StuckDecoder()
    eng = mod.ContinuousServingEngine(dec, request_timeout_s=0.2)

    async def run():
        await eng.start()
        with pytest.raises(mod.PredictionTimeout, match="deadline"):
            await eng.predict(IMG)
        for _ in range(200):
            if dec.cancels:
                break
            await asyncio.sleep(0.01)
        await eng.stop()

    asyncio.run(run())
    assert dec.cancels == [0] and eng.cancelled == 1 and dec.closed


@pytest.mark.parametrize("mod", BOTH, ids=["port", "jax"])
def test_batching_engine_deadline(mod):
    eng = mod.BatchingEngine(FakeEngine(delay=0.5), request_timeout_s=0.1)

    async def run():
        await eng.start()
        with pytest.raises(mod.PredictionTimeout, match="deadline"):
            await eng.predict(IMG)
        await eng.stop()

    asyncio.run(run())


@pytest.mark.parametrize("mod", BOTH, ids=["port", "jax"])
@pytest.mark.parametrize("engine", ["batching", "continuous"])
def test_queue_limit_overload(mod, engine):
    """Beyond ``queue_limit`` waiting images, ``predict`` and
    ``predict_many`` raise ``BatcherOverloaded``; the queued ones still
    finish."""
    if engine == "batching":
        eng = mod.BatchingEngine(FakeEngine(delay=0.2), queue_limit=2)
    else:
        dec = StuckDecoder()
        eng = mod.ContinuousServingEngine(dec, queue_limit=2)

    async def run():
        if engine == "batching":
            # not started: the queue only fills
            tasks = [asyncio.ensure_future(eng.predict(IMG))
                     for _ in range(2)]
            await asyncio.sleep(0)
            with pytest.raises(mod.BatcherOverloaded):
                await eng.predict(IMG)
            with pytest.raises(mod.BatcherOverloaded):
                await eng.predict_many([IMG])
            await eng.start()
            assert await asyncio.gather(*tasks) == [("x", 0.5)] * 2
            await eng.stop()
        else:
            # not started: submissions wait in the thread-safe queue
            tasks = [asyncio.ensure_future(eng.predict(IMG))
                     for _ in range(2)]
            await asyncio.sleep(0)
            with pytest.raises(mod.BatcherOverloaded):
                await eng.predict(IMG)
            with pytest.raises(mod.BatcherOverloaded):
                await eng.predict_many([IMG])
            for t in tasks:
                t.cancel()
            await eng.start()
            await asyncio.gather(*tasks, return_exceptions=True)
            await eng.stop()
            assert eng.cancelled == 2 and not dec.ids

    asyncio.run(run())


@pytest.mark.parametrize("mod", BOTH, ids=["port", "jax"])
def test_batcher_fault_propagation(mod):
    """JAX ``test_serve.py:435``: a failed decode fails every waiter of its
    batch with the error, and the next batch is served."""
    eng = mod.BatchingEngine(FakeEngine(fail_first=True), max_batch_size=4,
                             batch_timeout_ms=5.0)

    async def run():
        await eng.start()
        results = await asyncio.gather(*[eng.predict(IMG) for _ in range(3)],
                                       return_exceptions=True)
        assert all(isinstance(r, RuntimeError) for r in results)
        assert await eng.predict(IMG) == ("x", 0.5)
        await eng.stop()

    asyncio.run(run())


class FailingDecoder(StuckDecoder):
    """Fails its first segment, with one request finished in that tick."""

    def step_once(self):
        from handwritten_math_ocr_api_torch.decode.continuous import (
            ContinuousSegmentError,
        )

        if len(self.ids) < 3:
            time.sleep(0.005)
            return {}
        self.failed_ids = list(self.ids)
        done = {self.ids[0]: ("x", 0.5)}
        raise ContinuousSegmentError(RuntimeError("device fault"), done)

    def fail_reset(self):
        self.ids = []


def test_continuous_fault_fails_every_waiter_but_the_finished():
    """A failed segment: the requests it completed resolve, every other
    waiter gets the error, the decoder is reset, and the engine serves on
    (no fallback hides the fault)."""
    dec = FailingDecoder()
    eng = tbatcher.ContinuousServingEngine(dec)

    async def run():
        await eng.start()
        got = await asyncio.gather(*[eng.predict(IMG) for _ in range(3)],
                                   return_exceptions=True)
        await eng.stop()
        return got

    got = asyncio.run(run())
    assert got[0] == ("x", 0.5)
    assert all(isinstance(g, RuntimeError) and "device fault" in str(g)
               for g in got[1:])
    assert dec.idle


@pytest.mark.parametrize("mod", BOTH, ids=["port", "jax"])
def test_batcher_stop_with_sentinel_behind_request(mod):
    """JAX ``test_serve.py:542``: ``stop``'s sentinel queued behind a
    request is not swallowed by the mid-batch drain."""
    async def run():
        fake = FakeEngine(delay=0.2)
        eng = mod.BatchingEngine(fake)
        await eng.start()
        t1 = asyncio.ensure_future(eng.predict(IMG))
        await asyncio.sleep(0.05)
        t2 = asyncio.ensure_future(eng.predict(IMG))
        stop_t = asyncio.ensure_future(eng.stop())
        await asyncio.wait_for(asyncio.gather(t1, t2, stop_t), timeout=5)
        assert (await t1) == ("x", 0.5) and (await t2) == ("x", 0.5)
        return fake.batch_sizes

    assert asyncio.run(run()) == [1, 1]


@pytest.mark.parametrize("mod", BOTH, ids=["port", "jax"])
def test_batcher_timeout_linger_coalesces(mod):
    """JAX ``test_serve.py:570``: a linger joins a request that arrives in
    its window; drain-and-go dispatches the first at once."""
    async def run(linger):
        fake = FakeEngine()
        eng = mod.BatchingEngine(fake, batch_timeout_ms=linger)
        await eng.start()
        t1 = asyncio.ensure_future(eng.predict(IMG))
        await asyncio.sleep(0.05)
        t2 = asyncio.ensure_future(eng.predict(IMG))
        await asyncio.gather(t1, t2)
        await eng.stop()
        return fake.batch_sizes

    assert asyncio.run(run(500.0)) == [2]
    assert asyncio.run(run(0.0)) == [1, 1]


# ---------------------------------------------------------------------------
# profiling
# ---------------------------------------------------------------------------

def test_stage_timer_equals_jax():
    """One schedule of stages (durations from a fake clock) through both
    timers: equal summaries; ``reset`` empties them."""
    ticks = np.cumsum(np.random.default_rng(0).uniform(
        0.001, 0.01, 40)).tolist()
    summaries = []
    for mod in (tprofiling, jprofiling):
        it = iter(ticks)
        timer = mod.StageTimer(ewma_alpha=0.3)
        real = mod.time.perf_counter
        mod.time.perf_counter = lambda: next(it)
        try:
            for name in ["decode", "queue", "decode", "decode", "queue"] * 4:
                with timer.stage(name):
                    pass
        finally:
            mod.time.perf_counter = real
        summaries.append(timer.summary())
        timer.reset()
        assert timer.summary() == {}
    assert summaries[0] == summaries[1]


def test_trace_writes_a_chrome_trace(tmp_path):
    import torch

    with tprofiling.trace(str(tmp_path)):
        torch.ones(64, 64) @ torch.ones(64, 64)
    path = os.path.join(tmp_path, "trace.json")
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    assert any("mm" in e.get("name", "") for e in events)


def test_continuous_scheduler_thread_lives_from_start_to_stop():
    eng = tbatcher.ContinuousServingEngine(StuckDecoder())
    assert eng._thread is None  # made, not started

    async def run():
        await eng.start()
        thread = eng._thread
        assert thread.is_alive() and thread.daemon
        await eng.stop()
        return thread

    thread = asyncio.run(run())
    assert not thread.is_alive() and eng._thread is None
