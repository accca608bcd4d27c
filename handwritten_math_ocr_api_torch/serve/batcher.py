"""The serving engines between request handlers and the device.

Port of ``handwritten_math_ocr_api_tpu/serve/batcher.py``, on asyncio,
threading and numpy only. Two engines with one surface (``start``,
``stop``, ``predict``, ``predict_many``, ``stats``):

- ``BatchingEngine`` over a ``decode/api.DecodeEngine``: every image in
  flight, from single and batch requests alike, lands in one queue; a
  collector coalesces up to ``max_batch_size`` of them (drain-and-go by
  default; ``batch_timeout_ms > 0`` lingers that long for company) and
  runs ONE bucketed decode (``predict_with_confidence``) in the executor,
  so that the event loop stays free. A failed decode fails every waiter of
  its batch; waiters cancelled before the dispatch (client disconnects,
  deadlines) are dropped without a row.
- ``ContinuousServingEngine`` over a ``decode/continuous.ContinuousDecoder``:
  a dedicated scheduler thread owns the decoder; submissions cross a
  thread-safe queue, finished requests resolve their futures with
  ``call_soon_threadsafe``, and a cancelled waiter's request is cancelled
  in the decoder, which frees its slot.

Backpressure: ``queue_limit`` bounds the waiting images, beyond which
``predict`` raises ``BatcherOverloaded``. ``request_timeout_s`` bounds a
request's wait (``PredictionTimeout``), its cancellation reclaiming the
device work as a disconnect does.
"""

from __future__ import annotations

import asyncio
import logging
import queue as tqueue
import threading
import time
from typing import List, Optional, Tuple

import numpy as np

from ..decode.api import DecodeEngine
from ..utils.profiling import StageTimer

logger = logging.getLogger(__name__)


class PredictionTimeout(Exception):
    """A request exceeded the configured serving deadline. Raising it
    cancels the waiter's future, which the engines treat exactly like a
    client disconnect: the continuous scheduler reclaims the KV slot, the
    dynamic batcher drops the row before dispatch."""


class BatcherOverloaded(Exception):
    pass


async def _await_with_deadline(fut, timeout_s: float):
    """await fut, bounded by the serving deadline when one is set.
    asyncio.wait_for cancels the future on timeout, so the engines'
    cancelled-waiter paths reclaim the device resources exactly as for a
    client disconnect."""
    if not timeout_s or timeout_s <= 0:
        return await fut
    try:
        return await asyncio.wait_for(fut, timeout=timeout_s)
    except asyncio.TimeoutError:
        raise PredictionTimeout(
            f"prediction exceeded the {timeout_s:g}s serving deadline")


class _Pending:
    __slots__ = ("image", "future", "enqueued_at")

    def __init__(self, image: np.ndarray, future: asyncio.Future):
        self.image = image
        self.future = future
        self.enqueued_at = time.perf_counter()


class BatchingEngine:
    def __init__(self, engine: DecodeEngine, max_batch_size: int = 64,
                 batch_timeout_ms: float = 0.0, queue_limit: int = 512,
                 request_timeout_s: float = 0.0):
        self.engine = engine
        self.max_batch_size = max_batch_size
        self.batch_timeout = batch_timeout_ms / 1000.0
        self.queue_limit = queue_limit
        self.request_timeout = request_timeout_s
        self._queue: asyncio.Queue = asyncio.Queue()
        self._task: Optional[asyncio.Task] = None
        self._stopping = False
        # stats
        self.batches_run = 0
        self.images_decoded = 0
        self.total_batch_occupancy = 0
        self.cancelled = 0  # waiters dropped before dispatch (disconnects)
        self.timer = StageTimer()

    async def start(self) -> None:
        if self._task is None:
            self._stopping = False
            self._task = asyncio.get_running_loop().create_task(
                self._collector())

    async def stop(self) -> None:
        self._stopping = True
        if self._task is not None:
            self._queue.put_nowait(None)  # wake collector
            await self._task
            self._task = None

    async def predict(self, image: np.ndarray) -> Tuple[str, float]:
        """Submit one normalized (H, W, 1) image; awaits (latex, conf)."""
        if self._queue.qsize() >= self.queue_limit:
            raise BatcherOverloaded("prediction queue full")
        fut = asyncio.get_running_loop().create_future()
        await self._queue.put(_Pending(image, fut))
        return await _await_with_deadline(fut, self.request_timeout)

    async def predict_many(self, images: List[np.ndarray]
                           ) -> List[Tuple[str, float]]:
        """Submit several images as one logical request; they may share a
        device batch with other requests (this is the point)."""
        if self._queue.qsize() + len(images) > self.queue_limit:
            raise BatcherOverloaded("prediction queue full")
        loop = asyncio.get_running_loop()
        futs = []
        for img in images:
            fut = loop.create_future()
            await self._queue.put(_Pending(img, fut))
            futs.append(fut)
        return list(await asyncio.gather(
            *[_await_with_deadline(f, self.request_timeout) for f in futs]))

    # -- internals ----------------------------------------------------------

    async def _collector(self) -> None:
        """Drain-and-go: dispatch the moment the queue is empty
        instead of lingering hoping for company. A lone warm request pays
        zero batching latency; concurrent load still coalesces naturally
        because requests that arrive while a decode is in flight queue up
        and are drained together for the next batch. One zero-delay yield
        lets same-instant arrivals (e.g. a client burst scheduled on this
        loop tick) join the batch.

        ``batch_timeout_ms > 0`` opts back into the classic linger: after
        the first request, wait up to that long for more to arrive before
        dispatching (maximizes coalescing at the cost of adding that
        latency to lone requests). The default is 0 — drain-and-go.
        """
        loop = asyncio.get_running_loop()
        while True:
            first = await self._queue.get()
            if first is None:
                if self._stopping:
                    return
                continue
            batch = [first]
            await asyncio.sleep(0)  # let already-scheduled puts land
            deadline = (loop.time() + self.batch_timeout
                        if self.batch_timeout > 0 else None)
            while len(batch) < self.max_batch_size:
                if not self._queue.empty():
                    item = self._queue.get_nowait()
                elif deadline is not None and not self._stopping:
                    remaining = deadline - loop.time()
                    if remaining <= 0:
                        break
                    try:
                        item = await asyncio.wait_for(
                            self._queue.get(), timeout=remaining)
                    except asyncio.TimeoutError:
                        break
                else:
                    break
                if item is None:
                    # shutdown sentinel mid-drain: re-queue it so the
                    # outer loop sees it after this batch dispatches —
                    # consuming it here would leave stop() awaiting a
                    # collector that blocks forever on the next get()
                    self._queue.put_nowait(None)
                    break
                batch.append(item)
            # client disconnects (handler_cancellation) cancel the waiter
            # future — don't burn a device batch row on them
            live = [p for p in batch if not p.future.cancelled()]
            self.cancelled += len(batch) - len(live)
            if not live:
                continue
            await self._run_batch(loop, live)
            if self._stopping and self._queue.empty():
                return

    async def _run_batch(self, loop, batch: List[_Pending]) -> None:
        now = time.perf_counter()
        for p in batch:
            self.timer.totals["queue_wait"] += now - p.enqueued_at
            self.timer.counts["queue_wait"] += 1
        images = np.stack([p.image for p in batch], axis=0)
        try:
            with self.timer.stage("decode"):
                results = await loop.run_in_executor(
                    None, self.engine.predict_with_confidence, images)
        except Exception as e:  # propagate to every waiter
            logger.exception("batched decode failed")
            for p in batch:
                if not p.future.done():
                    p.future.set_exception(e)
            return
        self.batches_run += 1
        self.images_decoded += len(batch)
        self.total_batch_occupancy += len(batch)
        for p, res in zip(batch, results):
            if not p.future.done():
                p.future.set_result(res)

    @property
    def stats(self) -> dict:
        avg = (self.total_batch_occupancy / self.batches_run
               if self.batches_run else 0.0)
        return {
            "mode": "dynamic",
            "batches_run": self.batches_run,
            "images_decoded": self.images_decoded,
            "avg_batch_size": avg,
            "queue_depth": self._queue.qsize(),
            "cancelled_waiters": self.cancelled,
            "stages": self.timer.summary(),
        }


class ContinuousServingEngine:
    """Dedicated-thread adapter over decode.continuous.ContinuousDecoder.

    Same surface as BatchingEngine (predict / predict_many / start / stop /
    stats), so that an app can select either. The scheduler THREAD
    exclusively owns the (non-thread-safe) ContinuousDecoder: submissions
    cross through a thread-safe queue, finished requests resolve their
    asyncio futures via ``call_soon_threadsafe``, and new requests are
    admitted into freed KV-cache slots while others are still decoding.

    Why a thread and not a ``run_in_executor`` task: a task hops through
    the executor once a scheduler tick, scheduled by the same event loop
    that parses every concurrent request, and under load that contention
    stretches every segment (JAX's ``benchmarks/loadtest.py`` measured a
    36 ms segment at ~56 ms). A dedicated thread never waits for the
    loop."""

    def __init__(self, decoder, queue_limit: int = 512,
                 request_timeout_s: float = 0.0):
        self.decoder = decoder
        self.queue_limit = queue_limit
        self.request_timeout = request_timeout_s
        self._subq: "tqueue.Queue" = tqueue.Queue()
        self._futures: dict = {}          # rid -> (future, owning loop)
        self._thread: Optional[threading.Thread] = None
        self._stopping = False
        self._wake = threading.Event()
        # scheduler phase timers: time inside step_once vs everything else
        # (drain, resolve, idle-wait)
        self.t_step = 0.0
        self.t_other = 0.0
        self.worker_iters = 0
        self.cancelled = 0  # waiters dropped after client disconnect

    async def start(self) -> None:
        if self._thread is None:
            self._stopping = False
            self._thread = threading.Thread(
                target=self._run, daemon=True, name="continuous-scheduler")
            self._thread.start()

    async def stop(self) -> None:
        self._stopping = True
        self._wake.set()
        if self._thread is not None:
            await asyncio.get_running_loop().run_in_executor(
                None, self._thread.join)
            self._thread = None
        # stop the decoder's harvester thread too — engines discarded on
        # model re-init would otherwise each leak a daemon thread blocked
        # forever on its fetch queue
        close = getattr(self.decoder, "close", None)
        if close is not None:
            close()

    async def predict(self, image: np.ndarray) -> Tuple[str, float]:
        if self._subq.qsize() >= self.queue_limit:
            raise BatcherOverloaded("prediction queue full")
        loop = asyncio.get_running_loop()
        fut = loop.create_future()
        self._subq.put((image, fut, loop))
        self._wake.set()
        return await _await_with_deadline(fut, self.request_timeout)

    async def predict_many(self, images: List[np.ndarray]
                           ) -> List[Tuple[str, float]]:
        if self._subq.qsize() + len(images) > self.queue_limit:
            raise BatcherOverloaded("prediction queue full")
        return list(await asyncio.gather(
            *[self.predict(img) for img in images]))

    def _run(self) -> None:
        mark = time.perf_counter()
        while True:
            while True:  # drain submissions into the decoder
                try:
                    image, fut, loop = self._subq.get_nowait()
                except tqueue.Empty:
                    break
                if fut.cancelled():  # client gone before we even admitted
                    self.cancelled += 1
                    continue
                rid = self.decoder.submit(image)
                self._futures[rid] = (fut, loop)
            # client disconnects: the server cancels the handler task,
            # which cancels the awaited future — reclaim the request's KV
            # slot instead of decoding for nobody
            if self._futures:
                gone = [rid for rid, (fut, _) in self._futures.items()
                        if fut.cancelled()]
                for rid in gone:
                    del self._futures[rid]
                    self.cancelled += 1
                    try:
                        cancel = getattr(self.decoder, "cancel", None)
                        if cancel is not None:
                            cancel(rid)
                    except Exception:
                        logger.exception("request cancel failed")
            if self.decoder.idle:
                if self._stopping:
                    return
                self._wake.clear()
                # timeout guards the submit()-set-before-clear race
                self._wake.wait(timeout=0.05)
                mark = time.perf_counter()
                continue
            t0 = time.perf_counter()
            self.t_other += t0 - mark
            try:
                done = self.decoder.step_once()
            except Exception as e:  # fail every waiter, keep serving
                logger.exception("continuous decode segment failed")
                # decodes that COMPLETED in the failing tick still resolve
                # (their slot state was consumed; the result exists)
                partial = getattr(e, "partial_results", None) or {}
                for rid, result in partial.items():
                    entry = self._futures.pop(rid, None)
                    if entry is not None:
                        fut, loop = entry
                        loop.call_soon_threadsafe(self._resolve, fut, result)
                for fut, loop in self._futures.values():
                    loop.call_soon_threadsafe(self._fail, fut, e)
                self._futures.clear()
                # return the decoder to idle — without this a persistent
                # fault makes this loop spin at 100% CPU re-raising on the
                # same stuck state forever
                try:
                    self.decoder.fail_reset()
                except Exception:
                    logger.exception("decoder fail_reset failed")
                mark = time.perf_counter()
                continue
            mark = time.perf_counter()
            self.t_step += mark - t0
            self.worker_iters += 1
            for rid, result in done.items():
                entry = self._futures.pop(rid, None)
                if entry is not None:
                    fut, loop = entry
                    loop.call_soon_threadsafe(self._resolve, fut, result)

    @staticmethod
    def _resolve(fut, result) -> None:
        if not fut.done():
            fut.set_result(result)

    @staticmethod
    def _fail(fut, exc) -> None:
        if not fut.done():
            fut.set_exception(exc)

    @property
    def stats(self) -> dict:
        s = dict(self.decoder.stats)
        s["mode"] = "continuous"
        s["queue_depth"] = self._subq.qsize()
        s["worker_step_s"] = round(self.t_step, 3)
        s["worker_other_s"] = round(self.t_other, 3)
        s["worker_iters"] = self.worker_iters
        s["cancelled_waiters"] = self.cancelled
        return s
