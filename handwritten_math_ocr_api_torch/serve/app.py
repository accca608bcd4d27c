"""The HTTP serving app: the JAX package's API surface over the port's engines.

The port of ``handwritten_math_ocr_api_tpu/serve/app.py``: the same twelve
routes (``/`` (HTML), ``/openapi.json``, ``/docs``, ``/redoc``,
``/predict`` (multipart upload or base64 JSON; ``?beam_size=``, or sampled
decode with ``?temperature=&top_k=&top_p=&seed=``), ``/predict/stream``
(server-sent events), ``/predict/batch`` (1-10 base64 images),
``/status``, ``/health``, ``/model/info``, ``/metrics``,
``/rate-limit/status``), the same JSON shapes (``serve/schemas.py``),
auth (``X-API-Key`` / ``Bearer``, open when no key is configured),
middlewares in the same order (errors, recycling, trusted hosts, CORS,
rate limit, request id), error envelope and worker recycling. It runs on
``serve/http.py``, a standard-library server with aiohttp's surface,
instead of aiohttp.

What differs from JAX's app:

- the engine: ``decode/api.DecodeEngine`` on the port's default route
  (window attention, patch merging and cache-append attention kernels,
  and the dequant matmul with ``SERVING_QUANTIZE``), or with
  ``SERVING_USE_FUSED`` the fused decoder steps, with
  ``SERVING_PALLAS_ENCODER`` the whole-block Swin kernel. JAX's app builds
  its engine without ``use_pallas`` and so serves JAX's XLA path; the
  results are the same function of the weights (the tests hold them equal
  in float32). The engines take the artifact's ``model_state`` (a ResNet
  encoder's BatchNorm statistics), as JAX's do;
- the device: ``cuda`` unless the state is made with ``device="cpu"``
  (the tests); nothing falls back to the CPU. ``SERVING_MESH_DATA > 1``
  and ``SERVING_ADMISSION=device`` are not ported: each logs a warning and
  serves on one device with host admission (the same results);
  ``ENABLE_PROFILER_SERVER`` has no counterpart and is logged;
- image intake: every upload decodes and resizes through PIL, as in JAX
  (PIL is imported inside ``_decode_image_bytes``).
"""

from __future__ import annotations

import asyncio
import base64
import binascii
import io
import json
import logging
import os
import time
import uuid
from typing import Any, Dict, Optional

import numpy as np

from ..core.config import DecodeConfig, ServeConfig
from ..core.tokenizer import Tokenizer
from ..data.preprocess import preprocess_pil, resize_pil_u8
from ..decode.api import DecodeEngine
from . import http as web
from .batcher import BatcherOverloaded, BatchingEngine, PredictionTimeout
from .rate_limiter import (
    ConcurrencyLimitExceeded, ConcurrentRequestTracker, RateLimitConfig,
    RateLimiter, init_rate_limiter,
)
from .schemas import (
    BatchPredictionRequest, BatchPredictionResponse, ErrorResponse,
    HealthResponse, PredictionResponse, StatusResponse,
)

logger = logging.getLogger(__name__)

RATE_LIMIT_SKIP_PATHS = {"/health", "/status", "/", "/docs", "/redoc",
                         "/openapi.json"}


def _ts() -> str:
    return time.strftime("%Y-%m-%d %H:%M:%S")


def _error_json(status: int, error: str, detail: str) -> web.Response:
    body = ErrorResponse(error=error, detail=detail,
                         timestamp=_ts()).to_dict()
    return web.json_response(body, status=status)


class ApiError(Exception):
    def __init__(self, status: int, detail: str):
        self.status = status
        self.detail = detail
        super().__init__(detail)


class ServerState:
    """All mutable serving state, owned by the event loop. ``device``:
    where the engine runs, ``cuda`` unless ``"cpu"`` is asked for."""

    def __init__(self, cfg: ServeConfig, device: Optional[str] = None):
        self.cfg = cfg
        self.requested_device = device
        self.engine: Optional[DecodeEngine] = None
        self.batcher = None
        self.tokenizer: Optional[Tokenizer] = None
        self.vocab: Optional[Dict[str, int]] = None
        self.model_cfg = None
        self.limiter: Optional[RateLimiter] = None
        self.device: Optional[str] = None
        self.model_load_time: Optional[float] = None
        self.calibration: Optional[dict] = None
        self.prediction_count = 0
        self.start_time = time.time()
        # worker self-recycling (SERVING_MAX_REQUESTS): see
        # recycle_middleware. exit_callback is a test seam; the default
        # stops the server, whose cleanup then stops the batcher.
        self.draining = False
        self.recycle_requests = 0   # prediction REQUESTS (batch counts 1)
        self.inflight_predictions = 0
        self.exit_callback = None
        self.drain_task: Optional[asyncio.Task] = None
        # per-stage request latency (input read+preprocess vs decode),
        # surfaced at /metrics as "request_stages"
        from ..utils.profiling import StageTimer

        self.request_timer = StageTimer()

    # -- model lifecycle ----------------------------------------------------

    def initialize_model(self) -> None:
        """Load vocab + params + config from model_dir; build the decode
        engine and the batcher."""
        from ..core.device import resolve_device
        from ..train.checkpoint import load_params_for_serving

        t0 = time.time()
        if self.batcher is not None:
            # re-init replaces the batcher: stop the old decoder's
            # harvester thread
            close = getattr(getattr(self.batcher, "decoder", None),
                            "close", None)
            if close is not None:
                close()
        device = resolve_device(self.requested_device)
        self.device = device.type
        logger.info("using device: %s", self.device)
        params, model_state, vocab, idx2char, model_cfg = \
            load_params_for_serving(self.cfg.model_dir)
        self.vocab = vocab
        self.tokenizer = Tokenizer(vocab, idx2char)
        self.model_cfg = model_cfg
        self.engine = DecodeEngine(
            params, model_cfg, DecodeConfig(), self.tokenizer,
            use_fused=self.cfg.use_fused_decode,
            quantize=self.cfg.quantize_decode,
            pallas_encoder_block=self.cfg.pallas_encoder_block,
            constrained=self.cfg.constrained_decode,
            model_state=model_state, device=device)
        if self.cfg.batching_mode == "continuous":
            from ..decode.continuous import ContinuousDecoder
            from .batcher import ContinuousServingEngine

            if self.cfg.mesh_data_axis > 1:
                logger.warning(
                    "SERVING_MESH_DATA=%d: a sharded slot pool is not "
                    "ported; running unsharded on one device",
                    self.cfg.mesh_data_axis)
            if self.cfg.quantize_decode and not self.cfg.use_fused_decode:
                logger.warning(
                    "SERVING_QUANTIZE requires SERVING_USE_FUSED in "
                    "continuous batching mode (in-kernel dequant); "
                    "serving float weights")
            admission = self.cfg.admission
            if admission == "device":
                logger.warning("SERVING_ADMISSION=device is not ported; "
                               "using host admission")
                admission = "host"
            decoder = ContinuousDecoder(
                params, model_cfg, self.tokenizer,
                num_slots=self.cfg.num_slots,
                segment_steps=self.cfg.segment_steps,
                pipeline_depth=self.cfg.pipeline_depth,
                use_fused=self.cfg.use_fused_decode,
                quantize=self.cfg.quantize_decode,
                pallas_encoder_block=self.cfg.pallas_encoder_block,
                segment_ring=self.cfg.segment_ring,
                constrained=self.cfg.constrained_decode,
                harvest_threads=self.cfg.harvest_threads,
                admission=admission, model_state=model_state,
                device=device)
            try:  # the kernel build and allocator growth before traffic
                decoder.warmup(image_dtype=(
                    np.uint8 if self.cfg.uint8_transfer else np.float32))
            except Exception:
                logger.warning("continuous warmup failed", exc_info=True)
            self.batcher = ContinuousServingEngine(
                decoder, request_timeout_s=self.cfg.request_timeout_s)
        else:
            self.batcher = BatchingEngine(
                self.engine, max_batch_size=self.cfg.max_batch_size,
                batch_timeout_ms=self.cfg.batch_timeout_ms,
                request_timeout_s=self.cfg.request_timeout_s)
        self.calibration = None
        if self.cfg.calibration != "off":
            from ..eval import calibration as calib_lib

            path = (os.path.join(self.cfg.model_dir, "calibration.json")
                    if self.cfg.calibration == "auto"
                    else self.cfg.calibration)
            self.calibration = calib_lib.load(path)
            if self.calibration is not None:
                logger.info(
                    "confidence calibration on (%s, fit ECE %.4f -> %.4f)",
                    self.calibration["method"],
                    self.calibration.get("ece_raw", float("nan")),
                    self.calibration.get("ece_calibrated", float("nan")))
            elif self.cfg.calibration != "auto":
                logger.warning("SERVING_CALIBRATION=%s not loadable; "
                               "serving raw confidence",
                               self.cfg.calibration)
        self.model_load_time = time.time() - t0
        logger.info("model initialized in %.2fs (vocab %d tokens)",
                    self.model_load_time, len(vocab))

    @property
    def model_loaded(self) -> bool:
        return self.engine is not None

    def ensure_model(self) -> None:
        if not self.model_loaded:
            logger.warning("model not loaded; attempting lazy init")
            try:
                self.initialize_model()
            except Exception as e:
                raise ApiError(500, f"Model initialization failed: {e}")

    def calibrate_confidence(self, conf):
        """Map a raw confidence through the loaded calibration artifact
        (eval/calibration.py), if any. None (beam) passes through."""
        if conf is None or self.calibration is None:
            return conf
        from ..eval import calibration as calib_lib

        return float(calib_lib.apply(self.calibration, conf))

    # -- auth / identity ----------------------------------------------------

    def verify_api_key(self, request) -> bool:
        """True if authorized; 401 without a key, 403 with a wrong one."""
        if not self.cfg.api_key:
            return True
        header = request.headers.get("X-API-Key") \
            or request.headers.get("Authorization")
        if not header:
            raise ApiError(401, "Missing API Key")
        provided = header.split(" ", 1)[1] if header.startswith("Bearer ") \
            else header
        if provided != self.cfg.api_key:
            raise ApiError(403, "Invalid API Key")
        return True

    def user_data(self, request) -> Dict[str, Any]:
        data: Dict[str, Any] = {"is_authenticated": False}
        if self.cfg.api_key:
            header = request.headers.get("X-API-Key") \
                or request.headers.get("Authorization")
            if header:
                provided = header.split(" ", 1)[1] \
                    if header.startswith("Bearer ") else header
                if provided == self.cfg.api_key:
                    data["is_authenticated"] = True
                    data["uid"] = "authenticated_user"
        return data

    def client_identity(self, request):
        remote = request.remote or "unknown"
        ua = request.headers.get("user-agent", "unknown")
        return self.limiter.get_client_id(remote, ua,
                                          self.user_data(request))


# ---------------------------------------------------------------------------
# Image intake
# ---------------------------------------------------------------------------

def _validate_filename(state: ServerState, filename: Optional[str]) -> None:
    if filename:
        ext = os.path.splitext(filename)[1].lower()
        if ext not in state.cfg.allowed_extensions:
            raise ApiError(
                400, "Invalid file format. Allowed: "
                + ", ".join(sorted(state.cfg.allowed_extensions)))


def _decode_image_bytes(data: bytes):
    from PIL import Image

    try:
        return Image.open(io.BytesIO(data))
    except Exception:
        raise ApiError(400, "Invalid image data")


def _decode_base64_image(b64: str):
    try:
        raw = base64.b64decode(b64, validate=True)
    except (binascii.Error, ValueError):
        raise ApiError(400, "Invalid base64 image data")
    return _decode_image_bytes(raw)


def _preprocess(state: ServerState, pil_image) -> np.ndarray:
    """A PIL image -> (H, W, 1) at the model's size: uint8 with
    ``uint8_transfer`` (the engine normalizes on the device), else float32
    x/255*2-1."""
    h, w = state.model_cfg.img_h, state.model_cfg.img_w
    if state.cfg.uint8_transfer:
        return resize_pil_u8(pil_image, h, w)[..., None]  # (H, W, 1) uint8
    return preprocess_pil(pil_image, h, w)[..., None].astype(np.float32)


# ---------------------------------------------------------------------------
# Handlers
# ---------------------------------------------------------------------------

async def handle_root(request) -> web.Response:
    state: ServerState = request.app["state"]
    model_status = "✅ Loaded" if state.model_loaded else "❌ Not Loaded"
    html = f"""<html>
  <head><title>{state.cfg.api_title}</title></head>
  <body>
    <h1>{state.cfg.api_title}</h1>
    <p>✅ API is running</p>
    <p><strong>Version:</strong> {state.cfg.api_version}</p>
    <p><strong>Model Status:</strong> {model_status}</p>
    <p><a href="/status">📊 System Status</a></p>
  </body>
</html>"""
    return web.Response(text=html, content_type="text/html")


async def handle_openapi(request) -> web.Response:
    state: ServerState = request.app["state"]
    from .openapi import build_spec

    return web.json_response(build_spec(
        state.cfg.api_title, state.cfg.api_version,
        state.cfg.api_description))


async def handle_docs(request) -> web.Response:
    state: ServerState = request.app["state"]
    from .openapi import DOCS_HTML

    return web.Response(text=DOCS_HTML.format(title=state.cfg.api_title),
                        content_type="text/html")


async def handle_redoc(request) -> web.Response:
    state: ServerState = request.app["state"]
    from .openapi import REDOC_HTML

    return web.Response(text=REDOC_HTML.format(title=state.cfg.api_title),
                        content_type="text/html")


async def _read_prediction_input(state: ServerState, request) -> np.ndarray:
    """Accept multipart 'file' uploads or a JSON body {"image_data":
    base64}."""
    ctype = request.content_type or ""
    if ctype.startswith("multipart/"):
        post = await request.post()
        field = post.get("file")
        if field is None:
            raise ApiError(400, "Missing 'file' field")
        _validate_filename(state, getattr(field, "filename", None))
        data = field.file.read() if hasattr(field, "file") else bytes(field)
        if not data:
            raise ApiError(400, "Empty file uploaded")
        if len(data) > state.cfg.max_file_size:
            raise ApiError(413, "File too large. Maximum size: "
                           f"{state.cfg.max_file_size} bytes")
        # decode and resize in the executor: inline they would serialize
        # concurrent clients on the event loop
        return await asyncio.get_running_loop().run_in_executor(
            None, lambda: _preprocess(state, _decode_image_bytes(data)))
    # JSON base64 path
    try:
        body = await request.json()
    except Exception:
        raise ApiError(400, "Expected multipart upload or JSON body")
    b64 = (body or {}).get("image_data")
    if not b64:
        raise ApiError(400, "Missing image data")
    return await asyncio.get_running_loop().run_in_executor(
        None, lambda: _preprocess(state, _decode_base64_image(b64)))


def _parse_sampling_query(request) -> dict:
    """Optional sampled-decode query params on /predict (temperature /
    top_k / top_p / seed; decode/sampling.py). Returns {} when none are
    present (the default greedy path)."""
    q = request.query
    if not any(k in q for k in ("temperature", "top_k", "top_p", "seed")):
        return {}
    out = {}
    try:
        out["temperature"] = float(q.get("temperature", 1.0))
        out["top_k"] = int(q.get("top_k", 0))
        out["top_p"] = float(q.get("top_p", 1.0))
        out["seed"] = int(q.get("seed", 0))
    except ValueError:
        raise ApiError(400, "invalid sampling parameter")
    if not 0.0 < out["temperature"] <= 10.0:
        raise ApiError(400, "temperature must be in (0, 10]")
    if not 0 <= out["top_k"] <= 1024:
        raise ApiError(400, "top_k must be in [0, 1024]")
    if not 0.0 < out["top_p"] <= 1.0:
        raise ApiError(400, "top_p must be in (0, 1]")
    return out


async def handle_predict(request) -> web.Response:
    state: ServerState = request.app["state"]
    state.verify_api_key(request)
    start = time.time()
    client_id, _auth = state.client_identity(request)
    beam_size = 0
    if "beam_size" in request.query:
        try:
            beam_size = int(request.query["beam_size"])
        except ValueError:
            raise ApiError(400, "beam_size must be an integer")
        if not 1 <= beam_size <= 16:
            raise ApiError(400, "beam_size must be in [1, 16]")
    sampling = _parse_sampling_query(request)
    if sampling and beam_size > 1:
        raise ApiError(400, "beam_size and sampling params are exclusive")
    async with ConcurrentRequestTracker(state.limiter, client_id):
        state.ensure_model()
        with state.request_timer.stage("input"):
            image = await _read_prediction_input(state, request)
        if beam_size > 1:
            # beam decode bypasses the greedy batcher (no confidence score:
            # beam scores are not the reference's confidence metric)
            loop = asyncio.get_running_loop()
            formula = (await loop.run_in_executor(
                None, lambda: state.engine.predict_batch(
                    image[None], beam_size=beam_size)))[0]
            from ..core.tokenizer import clean_latex_output

            formula = clean_latex_output(formula)
            confidence = None
        elif sampling:
            # sampled decode bypasses the greedy batcher (per-request
            # temperature/top_k/top_p)
            loop = asyncio.get_running_loop()
            formula, confidence = await loop.run_in_executor(
                None, lambda: state.engine.predict_single_sampled(
                    image, **sampling))
        else:
            with state.request_timer.stage("decode"):
                formula, confidence = await state.batcher.predict(image)
        processing_time = time.time() - start
        state.prediction_count += 1
        resp = PredictionResponse(
            formula=formula,
            confidence=state.calibrate_confidence(confidence),
            processing_time=processing_time, timestamp=_ts())
        return web.json_response(resp.to_dict())


async def handle_predict_stream(request) -> web.StreamResponse:
    """Server-sent-events streaming decode: the tokens of each decode
    segment as it lands (decode/streaming.py), then a final event with the
    cleaned formula and the confidence. Input as /predict."""
    state: ServerState = request.app["state"]
    state.verify_api_key(request)
    start = time.time()
    client_id, _auth = state.client_identity(request)
    try:
        segment_steps = int(request.query.get("segment_steps", 8))
    except ValueError:
        raise ApiError(400, "segment_steps must be an integer")
    if not 1 <= segment_steps <= 64:
        raise ApiError(400, "segment_steps must be in [1, 64]")
    async with ConcurrentRequestTracker(state.limiter, client_id):
        state.ensure_model()
        image = await _read_prediction_input(state, request)
        resp = web.StreamResponse(headers={
            "Content-Type": "text/event-stream",
            "Cache-Control": "no-cache",
            "X-Accel-Buffering": "no",
        })
        await resp.prepare(request)
        loop = asyncio.get_running_loop()
        gen = state.engine.predict_stream(image, segment_steps=segment_steps)
        _END = object()
        try:
            while True:  # one segment a next(), in the executor
                event = await loop.run_in_executor(
                    None, lambda: next(gen, _END))
                if event is _END:
                    break
                if event.get("done"):
                    if event.get("confidence") is not None:
                        event["confidence"] = state.calibrate_confidence(
                            event["confidence"])
                    event["processing_time"] = time.time() - start
                    event["timestamp"] = _ts()
                    state.prediction_count += 1
                await resp.write(f"data: {json.dumps(event)}\n\n".encode())
        except Exception as exc:  # response already prepared: report in-band
            logger.exception("streaming decode failed mid-stream")
            err = {"error": "Prediction failed", "detail": str(exc),
                   "done": True}
            try:
                await resp.write(f"data: {json.dumps(err)}\n\n".encode())
            except Exception:
                pass
        await resp.write_eof()
        return resp


async def handle_predict_batch(request) -> web.Response:
    state: ServerState = request.app["state"]
    state.verify_api_key(request)
    start = time.time()
    try:
        body = await request.json()
        batch_req = BatchPredictionRequest.from_dict(body or {})
    except ApiError:
        raise
    except Exception as e:
        raise ApiError(422, f"Invalid batch request: {e}")

    client_id, _auth = state.client_identity(request)
    async with ConcurrentRequestTracker(state.limiter, client_id):
        state.ensure_model()
        results = []
        images, slots = [], []
        for i, b64 in enumerate(batch_req.images):
            try:
                images.append(_preprocess(state,
                                          _decode_base64_image(b64)))
                slots.append(i)
                results.append(None)  # placeholder
            except ApiError as e:
                results.append({"index": i, "formula": "",
                                "confidence": None, "success": False,
                                "error": e.detail})
        if images:
            try:
                outs = await state.batcher.predict_many(images)
                for slot, (formula, conf) in zip(slots, outs):
                    results[slot] = {
                        "index": slot, "formula": formula,
                        "confidence": state.calibrate_confidence(conf),
                        "success": True}
            except Exception as e:
                logger.exception("batch decode failed")
                for slot in slots:
                    results[slot] = {"index": slot, "formula": "",
                                     "confidence": None, "success": False,
                                     "error": str(e)}
        successful = sum(1 for r in results if r and r["success"])
        state.prediction_count += len(batch_req.images)
        resp = BatchPredictionResponse(
            results=results, total_images=len(batch_req.images),
            successful_predictions=successful,
            processing_time=time.time() - start, timestamp=_ts())
        return web.json_response(resp.to_dict())


async def handle_status(request) -> web.Response:
    state: ServerState = request.app["state"]
    resp = StatusResponse(
        status="healthy" if state.model_loaded else "unhealthy",
        api_version=state.cfg.api_version,
        model_loaded=state.model_loaded,
        vocab_loaded=state.tokenizer is not None,
        device=str(state.device),
        model_load_time=state.model_load_time,
        total_predictions=state.prediction_count,
        uptime=time.time() - state.start_time)
    return web.json_response(resp.to_dict())


async def handle_health(request) -> web.Response:
    state: ServerState = request.app["state"]
    model_dir = state.cfg.model_dir
    model_files_exist = {
        "params": os.path.exists(os.path.join(model_dir, "params")),
        "vocab.json": os.path.exists(os.path.join(model_dir, "vocab.json")),
    }
    checks = {
        "model_loaded": state.model_loaded,
        "vocab_loaded": state.tokenizer is not None,
        "device_available": state.device is not None,
        "rate_limiter_initialized": state.limiter is not None,
        "model_files_exist": model_files_exist,
        "batcher_running": state.batcher is not None,
        # a draining worker (SERVING_MAX_REQUESTS recycle) fails
        # readiness so that load balancers stop routing to it
        "not_draining": not state.draining,
    }
    healthy = all([checks["model_loaded"], checks["vocab_loaded"],
                   checks["device_available"],
                   checks["rate_limiter_initialized"],
                   checks["not_draining"],
                   all(model_files_exist.values())])
    resp = HealthResponse(healthy=healthy, checks=checks, timestamp=_ts())
    return web.json_response(resp.to_dict())


async def handle_model_info(request) -> web.Response:
    state: ServerState = request.app["state"]
    if not state.model_loaded:
        raise ApiError(503, "Model not loaded")
    mc = state.model_cfg
    from ..core.config import SPECIAL_TOKENS
    from ..models.model import count_params

    return web.json_response({
        "model_config": {
            "encoder": mc.encoder,
            "img_height": mc.img_h, "img_width": mc.img_w,
            "d_model": mc.d_model, "num_heads": mc.nhead,
            "num_decoder_layers": mc.num_decoder_layers,
            "dim_feedforward": mc.dim_feedforward,
            "dropout": mc.dropout, "max_seq_len": mc.max_seq_len,
        },
        "vocab_info": {
            "vocab_size": len(state.vocab) if state.vocab else 0,
            "special_tokens": list(SPECIAL_TOKENS),
        },
        "device": str(state.device),
        "model_parameters": count_params(state.engine.params),
    })


async def handle_metrics(request) -> web.Response:
    state: ServerState = request.app["state"]
    uptime = time.time() - state.start_time
    try:
        import psutil

        system = {
            "cpu_percent": psutil.cpu_percent(),
            "memory_percent": psutil.virtual_memory().percent,
            "disk_percent": psutil.disk_usage("/").percent,
        }
    except Exception:
        system = {"error": "psutil not available"}
    limiter_metrics: Dict[str, Any]
    if state.limiter is not None:
        limiter_metrics = {
            "active_concurrent_requests": len(state.limiter.active_requests),
            "total_concurrent_requests":
                sum(state.limiter.active_requests.values()),
            "max_concurrent_per_client":
                state.limiter.config.concurrent_requests,
        }
    else:
        limiter_metrics = {"error": "Rate limiter not available"}
    payload = {
        "predictions": {
            "total": state.prediction_count,
            "rate_per_second":
                state.prediction_count / uptime if uptime > 0 else 0,
        },
        "system": system,
        "rate_limiter": limiter_metrics,
        "uptime_seconds": uptime,
    }
    if state.cfg.max_requests:
        payload["recycle"] = {
            "max_requests": state.cfg.max_requests,
            "requests_served": state.recycle_requests,
            "draining": state.draining,
        }
    if state.batcher is not None:
        payload["batching"] = state.batcher.stats
    payload["request_stages"] = state.request_timer.summary()
    return web.json_response(payload)


async def handle_rate_limit_status(request) -> web.Response:
    state: ServerState = request.app["state"]
    limiter = state.limiter
    client_id, is_auth = state.client_identity(request)
    limits = limiter.get_rate_limits(is_auth)
    usage = await limiter.usage(client_id)
    return web.json_response({
        "client_id": client_id,
        "is_authenticated": is_auth,
        "limits": limits,
        "current_usage": usage,
        "remaining": {
            "minute": max(0, limits["requests_per_minute"] - usage["minute"]),
            "hour": max(0, limits["requests_per_hour"] - usage["hour"]),
            "day": max(0, limits["requests_per_day"] - usage["day"]),
        },
        "concurrent_requests":
            limiter.active_requests.get(client_id, 0),
        "max_concurrent": limiter.config.concurrent_requests,
    })


# ---------------------------------------------------------------------------
# Middlewares
# ---------------------------------------------------------------------------

_PREDICT_PATHS = ("/predict", "/predict/stream", "/predict/batch")


def _default_exit(app) -> None:
    # stops the server: run_app's cleanup stops the batcher (the
    # continuous scheduler thread drains to idle) and returns, and the
    # process exits 0 for its supervisor to start a fresh worker
    app.stop()


async def _drain_and_exit(app) -> None:
    """SERVING_MAX_REQUESTS reached: wait for in-flight predictions, log
    final counters, then trigger the graceful exit."""
    st: ServerState = app["state"]
    t0 = time.time()
    grace = max(st.cfg.drain_timeout_s, 2.0 * st.cfg.request_timeout_s)
    while st.inflight_predictions > 0 and time.time() - t0 < grace:
        await asyncio.sleep(0.05)
    logger.info(
        "recycling worker: %d prediction requests served (limit %d), "
        "%d images, uptime %.1fs, in-flight now %d",
        st.recycle_requests, st.cfg.max_requests, st.prediction_count,
        time.time() - st.start_time, st.inflight_predictions)
    cb = st.exit_callback or (lambda: _default_exit(app))
    # a small delay so that the last in-flight response's write is
    # flushed before the server stops
    asyncio.get_running_loop().call_later(0.5, cb)


async def recycle_middleware(request, handler):
    """Worker self-recycling guard (SERVING_MAX_REQUESTS, 0 = off): after
    N prediction requests the worker drains and exits 0 for its supervisor
    to restart it. During the drain new predictions get 503 + Retry-After
    (other routes keep serving); requests already in flight complete."""
    st: ServerState = request.app["state"]
    if not st.cfg.max_requests or not (
            request.method == "POST" and request.path in _PREDICT_PATHS):
        return await handler(request)
    if st.draining:
        resp = _error_json(
            503, "Service Unavailable",
            "worker is recycling (SERVING_MAX_REQUESTS reached); retry")
        resp.headers["Retry-After"] = "1"
        return resp
    st.inflight_predictions += 1
    try:
        return await handler(request)
    finally:
        st.inflight_predictions -= 1
        st.recycle_requests += 1
        if st.recycle_requests >= st.cfg.max_requests and not st.draining:
            st.draining = True
            logger.info("SERVING_MAX_REQUESTS=%d reached; draining for "
                        "recycle", st.cfg.max_requests)
            st.drain_task = asyncio.get_running_loop().create_task(
                _drain_and_exit(request.app))


async def error_middleware(request, handler):
    try:
        return await handler(request)
    except ApiError as e:
        return _error_json(e.status, "HTTP Exception", e.detail)
    except ConcurrencyLimitExceeded as e:
        return _error_json(429, "Rate limit exceeded", str(e))
    except BatcherOverloaded as e:
        return _error_json(503, "Server overloaded", str(e))
    except PredictionTimeout as e:
        return _error_json(504, "Prediction timeout", str(e))
    except web.HTTPException:
        raise
    except Exception:
        logger.exception("unhandled error")
        return _error_json(500, "Internal Server Error",
                           "An unexpected error occurred")


async def trusted_host_middleware(request, handler):
    state: ServerState = request.app["state"]
    hosts = state.cfg.trusted_hosts
    if hosts and "*" not in hosts:
        host = request.headers.get("Host", "").split(":")[0]
        if host not in hosts:
            return _error_json(400, "Bad Request", "Invalid host header")
    return await handler(request)


async def cors_middleware(request, handler):
    state: ServerState = request.app["state"]
    origins = state.cfg.cors_origins
    origin = request.headers.get("Origin")
    if request.method == "OPTIONS":
        resp = web.Response(status=204)
    else:
        resp = await handler(request)
    allow = "*" if "*" in origins else (origin if origin in origins else None)
    if allow:
        resp.headers["Access-Control-Allow-Origin"] = allow
        resp.headers["Access-Control-Allow-Methods"] = "GET, POST, OPTIONS"
        resp.headers["Access-Control-Allow-Headers"] = \
            "Content-Type, X-API-Key, Authorization"
    return resp


async def rate_limit_middleware(request, handler):
    """Fixed-window limits on inference paths; fails open on limiter
    errors."""
    state: ServerState = request.app["state"]
    if request.path in RATE_LIMIT_SKIP_PATHS or state.limiter is None:
        return await handler(request)
    try:
        client_id, is_auth = state.client_identity(request)
        verdict = await state.limiter.check_rate_limit(client_id, is_auth)
    except Exception:
        logger.exception("rate limiter error; failing open")
        return await handler(request)
    if verdict is not None:
        status = verdict.pop("status", 429)
        return web.json_response(verdict, status=status)
    return await handler(request)


async def request_id_middleware(request, handler):
    request["request_id"] = str(uuid.uuid4())
    t0 = time.perf_counter()
    resp = await handler(request)
    resp.headers["X-Request-ID"] = request["request_id"]
    logger.info("%s %s -> %d (%.1f ms) rid=%s", request.method,
                request.path, resp.status,
                (time.perf_counter() - t0) * 1e3, request["request_id"])
    return resp


# ---------------------------------------------------------------------------
# App factory
# ---------------------------------------------------------------------------

def create_app(cfg: Optional[ServeConfig] = None,
               state: Optional[ServerState] = None,
               device: Optional[str] = None) -> web.Application:
    """The app over ``state`` (made from ``cfg`` or the environment, on
    ``device``: ``cuda`` unless ``"cpu"``)."""
    cfg = cfg or ServeConfig.from_env()
    state = state or ServerState(cfg, device=device)
    app = web.Application(
        middlewares=[error_middleware, recycle_middleware,
                     trusted_host_middleware,
                     cors_middleware, rate_limit_middleware,
                     request_id_middleware],
        client_max_size=cfg.max_file_size + 1024 * 1024)
    app["state"] = state

    app.router.add_get("/", handle_root)
    app.router.add_get("/openapi.json", handle_openapi)
    app.router.add_get("/docs", handle_docs)
    app.router.add_get("/redoc", handle_redoc)
    app.router.add_post("/predict", handle_predict)
    app.router.add_post("/predict/stream", handle_predict_stream)
    app.router.add_post("/predict/batch", handle_predict_batch)
    app.router.add_get("/status", handle_status)
    app.router.add_get("/health", handle_health)
    app.router.add_get("/model/info", handle_model_info)
    app.router.add_get("/metrics", handle_metrics)
    app.router.add_get("/rate-limit/status", handle_rate_limit_status)

    async def on_startup(app):
        # rate limiter, then model; failures degrade, not crash
        st: ServerState = app["state"]
        if os.environ.get("ENABLE_PROFILER_SERVER", "").lower() in (
                "1", "true", "yes"):
            logger.warning("ENABLE_PROFILER_SERVER: the port has no live "
                           "profiler server (torch.profiler traces in "
                           "process: utils/profiling.trace); ignored")
        try:
            st.limiter = init_rate_limiter(
                st.cfg.redis_url,
                RateLimitConfig(
                    requests_per_minute=st.cfg.rate_limit_per_minute,
                    requests_per_hour=st.cfg.rate_limit_per_hour,
                    requests_per_day=st.cfg.rate_limit_per_day,
                    anonymous_daily_limit=st.cfg.rate_limit_anonymous_daily,
                    concurrent_requests=st.cfg.max_concurrent_requests))
            logger.info("rate limiter initialized")
        except Exception:
            logger.exception("rate limiter init failed")
        loop = asyncio.get_running_loop()
        if st.engine is None:
            try:  # loading and the engine's setup off the event loop
                await loop.run_in_executor(None, st.initialize_model)
            except Exception:
                logger.exception("model init failed; serving degraded")
        if st.engine is not None and st.cfg.warmup_batch_sizes:
            # run the decode buckets once so that the first request pays
            # no kernel build or allocator growth (SERVING_WARMUP)
            try:
                t0 = time.time()
                wdtype = np.uint8 if st.cfg.uint8_transfer else np.float32
                await loop.run_in_executor(
                    None, lambda: st.engine.warmup(st.cfg.warmup_batch_sizes,
                                                   dtype=wdtype))
                if (st.cfg.batching_mode == "continuous"
                        and st.batcher is not None):
                    dec = st.batcher.decoder
                    dummy = np.zeros(
                        (st.model_cfg.img_h, st.model_cfg.img_w, 1),
                        wdtype)
                    await loop.run_in_executor(
                        None, lambda: dec.run_all([dummy]))
                    dec.reset_stats()
                logger.info("decode warmup (buckets %s) in %.1fs",
                            st.cfg.warmup_batch_sizes, time.time() - t0)
            except Exception:
                logger.exception("decode warmup failed (continuing)")
        if st.batcher is not None:
            await st.batcher.start()

    async def on_cleanup(app):
        st: ServerState = app["state"]
        if st.batcher is not None:
            await st.batcher.stop()

    app.on_startup.append(on_startup)
    app.on_cleanup.append(on_cleanup)
    return app


def run_server(model_dir: str = "trained-model", host: str = "0.0.0.0",
               port: int = 8080, device: Optional[str] = None) -> None:
    """Serve until SIGINT, SIGTERM or a recycle; a client disconnect
    cancels its handler, and so frees a continuous request's KV slot."""
    import dataclasses

    cfg = dataclasses.replace(ServeConfig.from_env(), model_dir=model_dir,
                              host=host, port=port)
    web.run_app(create_app(cfg, device=device), host=cfg.host,
                port=cfg.port)
