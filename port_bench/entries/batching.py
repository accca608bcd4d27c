"""Dynamic batching: ``serve/batcher.BatchingEngine.predict_many`` over a
``decode/api.DecodeEngine``, in this process, as the app builds them.

Traffic keys: ``route`` (``use_fused``, ``pallas_encoder_block``,
``quantize``), ``engine`` (``BatchingEngine``'s ``max_batch_size``,
``batch_timeout_ms``, ``queue_limit``), ``warm_buckets`` (the decode
buckets this traffic reaches, each run once in set-up).

The benchmark wraps the engine's public ``decode_tokens`` (the call
``predict_with_confidence`` makes once a batch): the wrapper opens and
closes the traced window between decodes and records each decode's bucket,
rows, steps and emitted tokens."""

from __future__ import annotations

import time

import numpy as np
import torch

from harness.run_state import Decode


class System:
    def __init__(self, run, ctx):
        from handwritten_math_ocr_api_torch.core.config import DecodeConfig
        from handwritten_math_ocr_api_torch.decode.api import (DecodeEngine,
                                                                pick_bucket)
        from handwritten_math_ocr_api_torch.serve.batcher import \
            BatchingEngine

        t = run.traffic
        route = t.get("route", {})
        self.run, self.ctx = run, ctx
        self.images = ctx["images_u8"][..., None]     # (N, H, W, 1) uint8
        self.engine = DecodeEngine(
            ctx["params"], ctx["cfg"], DecodeConfig(), ctx["tokenizer"],
            use_fused=route.get("use_fused", False),
            pallas_encoder_block=route.get("pallas_encoder_block", False),
            quantize=route.get("quantize", False),
            model_state=ctx["state"], device=ctx["device"])
        engine, tracer = self.engine, ctx["tracer"]
        orig = engine.decode_tokens
        max_len = ctx["cfg"].max_seq_len
        buckets = engine.decode_cfg.batch_buckets

        def decode(images, beam_size):
            with torch.profiler.record_function("port_bench.decode"):
                return orig(images, beam_size)

        def decode_tokens(images, beam_size=None):
            res = tracer.call(decode, images, beam_size)
            counts = res.token_count.cpu()
            tokens = int(torch.clamp(counts + 1, max=max_len).sum())
            run.decodes.append(Decode(pick_bucket(len(images), buckets),
                                      len(images), engine.last_steps,
                                      tokens, tracer.active,
                                      time.perf_counter()))
            return res

        engine.decode_tokens = decode_tokens
        engine.warmup(tuple(t.get("warm_buckets", ())), dtype=np.uint8)
        self.batcher = BatchingEngine(engine, **t.get("engine", {}))

    async def start(self):
        await self.batcher.start()
        self.run.decodes.clear()

    async def send(self, images):
        return await self.batcher.predict_many(
            [self.images[i] for i in images])

    def snapshot(self) -> dict:
        b = self.batcher
        return {"decode_s": b.timer.totals.get("decode", 0.0),
                "decodes": len(self.run.decodes),
                "batches_run": b.batches_run,
                "images_decoded": b.images_decoded}

    async def stop(self):
        await self.batcher.stop()
        del self.engine, self.batcher
