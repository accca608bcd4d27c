"""The serving units around the port's app, against the JAX package's
where it has them.

A client that disconnects mid-request, whose handler is cancelled and
whose continuous request's slot is freed (``tests/test_cancel.py:211``
over HTTP, on the port's app and on JAX's, both on aiohttp with
``handler_cancellation=True``, with the same blocking fake decoder).

Units: the image intake (every upload through PIL, as JAX's: corpus images
and synthesized PNGs of every filter type give the port's PNG reader's
pixels, and every size and kind of upload gives JAX's intake's pixels, in
both transfer modes); each pydantic schema's ``model_json_schema``,
``model_dump`` and validation errors against the JAX model's; the rate
limiter's units on both packages; ``ServeConfig.from_env`` under a patched
environment; the CLI's ``serve --help`` and ``calibrate`` against JAX's;
and, in a subprocess, that no module of the port imports jax or the JAX
package. The transport itself is held against JAX's app in
``test_torch_app_transport.py``.
"""

import asyncio
import glob
import io
import json
import os
import socket
import struct
import subprocess
import sys
import time
import types
import zlib

import numpy as np
import pytest

import torch_app_harness as h

from handwritten_math_ocr_api_tpu.serve import app as japp
from handwritten_math_ocr_api_tpu.serve import rate_limiter as jrl

from handwritten_math_ocr_api_torch.data import png
from handwritten_math_ocr_api_torch.serve import app as tapp
from handwritten_math_ocr_api_torch.serve import rate_limiter as trl

import torch_threads  # noqa: F401  (one CPU thread: see the module)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CORPUS = os.path.join(REPO, "data_eval_hard", "test_formulas")
SIZE = (96, 320)


# ---------------------------------------------------------------------------
# Client disconnect
# ---------------------------------------------------------------------------

class BlockingDecoder:
    """Accepts submissions and never finishes them; each step blocks a
    moment (``tests/test_cancel.py``'s ``StuckDecoder``)."""

    def __init__(self):
        self.ids, self.cancels = [], []

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

    def fail_reset(self):
        pass

    def close(self):
        pass

    @property
    def stats(self):
        return {"active": len(self.ids)}


def _gray_png(img: np.ndarray, filters=None) -> bytes:
    """An 8-bit grayscale PNG of ``img`` written here, each row with the
    filter type ``filters[row % len(filters)]``."""
    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))

    hgt, wid = img.shape
    filters = filters or [0]
    rows, prev = [], np.zeros(wid, np.int32)
    for r in range(hgt):
        x = img[r].astype(np.int32)
        left = np.concatenate([[0], x[:-1]])
        ul = np.concatenate([[0], prev[:-1]])
        kind = filters[r % len(filters)]
        if kind == 0:
            f = x
        elif kind == 1:
            f = x - left
        elif kind == 2:
            f = x - prev
        elif kind == 3:
            f = x - (left + prev) // 2
        else:
            p = left + prev - ul
            pa, pb, pc = abs(p - left), abs(p - prev), abs(p - ul)
            f = x - np.where((pa <= pb) & (pa <= pc), left,
                             np.where(pb <= pc, prev, ul))
        rows.append(bytes([kind]) + (f % 256).astype(np.uint8).tobytes())
        prev = x
    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", wid, hgt, 8, 0, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(b"".join(rows)))
            + chunk(b"IEND", b""))


def _app_state(cfg_cls, state_cls, batcher, uint8=True, **kw):
    """A ServerState around ``batcher`` without a model load."""
    cfg = cfg_cls(model_dir="/nonexistent", uint8_transfer=uint8,
                  rate_limit_per_minute=10 ** 6, **kw)
    st = state_cls(cfg)
    st.engine = object()
    st.model_cfg = types.SimpleNamespace(img_h=SIZE[0], img_w=SIZE[1])
    st.batcher = batcher
    return st


@pytest.mark.parametrize("which", ["port", "jax"])
def test_disconnect_frees_continuous_slot(which):
    """A client that disconnects while its request holds a slot: the
    server cancels the handler, the engine sees the cancelled future and
    cancels the request in the decoder (its slot freed), and the server
    goes on serving. The port's app and JAX's aiohttp app
    (``handler_cancellation=True``), with the same blocking decoder."""
    dec = BlockingDecoder()
    png = _gray_png(np.random.default_rng(0).integers(
        0, 256, SIZE).astype(np.uint8))
    if which == "port":
        from handwritten_math_ocr_api_torch.core.config import ServeConfig
        from handwritten_math_ocr_api_torch.serve.batcher import (
            ContinuousServingEngine,
        )

        eng = ContinuousServingEngine(dec)
        st = _app_state(ServeConfig, tapp.ServerState, eng)
        server = h.PortServer(st.cfg, state=st)
    else:
        from handwritten_math_ocr_api_tpu.core.config import ServeConfig
        from handwritten_math_ocr_api_tpu.serve.batcher import (
            ContinuousServingEngine,
        )

        eng = ContinuousServingEngine(dec)
        st = _app_state(ServeConfig, japp.ServerState, eng)
        server = h.JaxServer(st.cfg, state=st)
    port = server.port
    try:
        body = json.dumps({"image_data": h.b64(png)}).encode()
        s = socket.create_connection(("127.0.0.1", port), timeout=10)
        s.sendall(b"POST /predict HTTP/1.1\r\nHost: x\r\n"
                  b"Content-Type: application/json\r\nContent-Length: "
                  + str(len(body)).encode() + b"\r\n\r\n" + body)
        for _ in range(500):
            if dec.ids:
                break
            time.sleep(0.01)
        assert dec.ids == [0], "the request never reached the decoder"
        s.close()
        for _ in range(500):
            if dec.cancels:
                break
            time.sleep(0.01)
        assert dec.cancels == [0] and dec.ids == []
        assert eng.stats["cancelled_waiters"] == 1
        assert h.call(port, "GET", "/health").status == 200
    finally:
        server.stop()


# ---------------------------------------------------------------------------
# Image intake
# ---------------------------------------------------------------------------

def _pil_u8(data, size=SIZE):
    from PIL import Image

    from handwritten_math_ocr_api_tpu.data.preprocess import resize_pil_u8

    return resize_pil_u8(Image.open(io.BytesIO(data)), *size)


def _intake_states(uint8):
    cfg = types.SimpleNamespace(uint8_transfer=uint8)
    mc = types.SimpleNamespace(img_h=SIZE[0], img_w=SIZE[1])
    return (types.SimpleNamespace(cfg=cfg, model_cfg=mc),
            types.SimpleNamespace(cfg=cfg, model_cfg=mc))


def _same_intake(data):
    """The port's intake of ``data`` against JAX's, for both transfer
    modes; returns the port's uint8 pixels (H, W)."""
    from PIL import Image

    assert isinstance(tapp._decode_image_bytes(data), Image.Image)
    for uint8 in (True, False):
        js, ts = _intake_states(uint8)
        want = japp._preprocess(js, japp._decode_image_bytes(data))
        got = tapp._preprocess(ts, tapp._decode_image_bytes(data))
        assert got.dtype == want.dtype and got.shape == want.shape
        assert np.array_equal(got, want)
        if uint8:
            pixels = got[..., 0]
    return pixels


def test_png_intake_corpus():
    """The first 40 test PNGs of the corpus (8-bit grayscale at 96x320):
    the intake's pixels equal the port's PNG reader's and JAX's intake."""
    paths = sorted(glob.glob(os.path.join(CORPUS, "*.png")))[:40]
    assert len(paths) == 40
    for p in paths:
        with open(p, "rb") as f:
            data = f.read()
        assert np.array_equal(_same_intake(data), png.decode_png(data))


@pytest.mark.parametrize("filters", [[0], [1], [2], [3], [4],
                                     [0, 1, 2, 3, 4]])
def test_png_intake_filters(filters):
    img = np.random.default_rng(len(filters) + filters[0]).integers(
        0, 256, SIZE).astype(np.uint8)
    img[10:20] = 255  # flat rows beside noisy ones
    data = _gray_png(img, filters)
    assert np.array_equal(png.decode_png(data), img)
    assert np.array_equal(_pil_u8(data), img)
    assert np.array_equal(_same_intake(data), img)


def _pil_bytes(mode, size_wh, fmt="PNG", seed=0, **save):
    from PIL import Image

    rng = np.random.default_rng(seed)
    w, hgt = size_wh
    if mode in ("RGB", "RGBA", "LA"):
        arr = rng.integers(0, 256, (hgt, w, len(mode)), np.uint8)
        img = Image.fromarray(arr, mode)
    elif mode == "I;16":
        img = Image.fromarray(rng.integers(0, 65535, (hgt, w)).astype(
            np.uint16))
    else:
        img = Image.fromarray(rng.integers(0, 256, (hgt, w), np.uint8), "L")
        if mode == "P":
            img = img.convert("P")
    buf = io.BytesIO()
    img.save(buf, fmt, **save)
    return buf.getvalue()


@pytest.mark.parametrize("case", [
    "gray other size", "gray wider", "rgb", "rgba", "gray alpha",
    "palette", "16-bit", "jpeg", "bmp", "damaged"])
def test_other_uploads_go_through_pil(case):
    """Uploads of other sizes, colour types and formats, and a damaged PNG:
    the same pixels as JAX's intake."""
    w, hgt = SIZE[1], SIZE[0]
    data = {
        "gray other size": lambda: _pil_bytes("L", (120, 50)),
        "gray wider": lambda: _pil_bytes("L", (w + 1, hgt)),
        "rgb": lambda: _pil_bytes("RGB", (w, hgt)),
        "rgba": lambda: _pil_bytes("RGBA", (w, hgt)),
        "gray alpha": lambda: _pil_bytes("LA", (w, hgt)),
        "palette": lambda: _pil_bytes("P", (w, hgt)),
        "16-bit": lambda: _pil_bytes("I;16", (w, hgt)),
        "jpeg": lambda: _pil_bytes("L", (w, hgt), "JPEG"),
        "bmp": lambda: _pil_bytes("L", (w, hgt), "BMP"),
        # a PNG at the model's size whose IDAT fails its CRC: the port's
        # PNG reader refuses it, PIL (which does not check the CRC of
        # IDAT) decodes it as JAX's intake does
        "damaged": lambda: _damage(_pil_bytes("L", (w, hgt))),
    }[case]()
    if case == "damaged":
        with pytest.raises(ValueError, match="CRC"):
            png.decode_png(data)
    _same_intake(data)


def _damage(data: bytes) -> bytes:
    i = data.index(b"IDAT")
    n = struct.unpack(">I", data[i - 4:i])[0]
    crc = i + 4 + n
    return data[:crc] + bytes([data[crc] ^ 0xFF]) + data[crc + 1:]


def test_not_an_image_is_400():
    with pytest.raises(tapp.ApiError) as e:
        tapp._decode_image_bytes(b"nope")
    assert e.value.status == 400 and e.value.detail == "Invalid image data"


# ---------------------------------------------------------------------------
# Schemas
# ---------------------------------------------------------------------------

SCHEMA_SAMPLES = {
    "PredictionRequest": [{}, {"image_data": "abc"}],
    "PredictionResponse": [
        {"formula": "x", "processing_time": 0.5, "timestamp": "t"},
        {"formula": "x", "confidence": 0.25, "processing_time": 0.0,
         "timestamp": "t"}],
    "BatchPredictionRequest": [{"images": ["a"]}, {"images": ["a"] * 10}],
    "BatchPredictionResponse": [
        {"results": [{"index": 0}], "total_images": 1,
         "successful_predictions": 1, "processing_time": 0.1,
         "timestamp": "t"}],
    "StatusResponse": [
        {"status": "healthy", "api_version": "1", "model_loaded": True,
         "vocab_loaded": True, "device": "cuda", "total_predictions": 3,
         "uptime": 1.5},
        {"status": "healthy", "api_version": "1", "model_loaded": True,
         "vocab_loaded": True, "device": "cuda", "model_load_time": 2.0,
         "total_predictions": 3, "uptime": 1.5}],
    "HealthResponse": [{"healthy": True, "checks": {"a": {"b": 1}},
                        "timestamp": "t"}],
    "ErrorResponse": [{"error": "e", "detail": "d", "timestamp": "t"}],
}
SCHEMA_INVALID = {
    "PredictionResponse": [
        {"formula": "x", "confidence": 1.5, "processing_time": 0.5,
         "timestamp": "t"},
        {"formula": "x", "processing_time": -1.0, "timestamp": "t"},
        {"formula": "x", "timestamp": "t"}],
    "BatchPredictionRequest": [{"images": []}, {"images": ["a"] * 11},
                               {"images": [1]}, {"images": "a"}, {}],
    "StatusResponse": [{"status": "healthy"}],
}


@pytest.mark.parametrize("name", sorted(SCHEMA_SAMPLES))
def test_schema_matches_pydantic(name):
    """The port's model against the JAX package's: the JSON schema,
    ``model_dump`` (keys in order) and, for each invalid body, the same
    ``ValidationError``."""
    import pydantic

    from handwritten_math_ocr_api_tpu.serve import schemas as jschemas

    from handwritten_math_ocr_api_torch.serve import schemas as tschemas

    jcls, tcls = getattr(jschemas, name), getattr(tschemas, name)
    assert tcls.model_json_schema() == jcls.model_json_schema()
    ref = "#/components/schemas/{model}"
    assert tcls.model_json_schema(ref_template=ref) == \
        jcls.model_json_schema(ref_template=ref)
    for kw in SCHEMA_SAMPLES[name]:
        assert tcls(**kw).model_dump() == jcls(**kw).model_dump()
        assert list(tcls(**kw).model_dump()) == list(jcls(**kw).model_dump())
    for kw in SCHEMA_INVALID.get(name, []):
        with pytest.raises(pydantic.ValidationError) as je:
            jcls(**kw)
        with pytest.raises(pydantic.ValidationError) as te:
            tcls(**kw)
        assert str(te.value) == str(je.value)
        assert te.value.errors() == je.value.errors()


# ---------------------------------------------------------------------------
# Rate limiter units, on both packages
# ---------------------------------------------------------------------------

BOTH_RL = pytest.mark.parametrize("rl", [jrl, trl], ids=["jax", "port"])


def _run(coro):
    return asyncio.new_event_loop().run_until_complete(coro)


@BOTH_RL
def test_rate_limit_minute_window(rl):
    async def go():
        limiter = rl.RateLimiter(rl.RateLimitConfig(requests_per_minute=3))
        for _ in range(3):
            assert await limiter.check_rate_limit("ip:test", False) is None
        verdict = await limiter.check_rate_limit("ip:test", False)
        assert verdict["status"] == 429 and verdict["remaining"] == 0
        assert verdict["retry_after"] <= 60
        return sorted(verdict)

    assert _run(go()) == ["detail", "error", "limit", "remaining", "reset",
                          "retry_after", "status"]


@BOTH_RL
def test_rate_limit_authenticated_multiplier(rl):
    limiter = rl.RateLimiter(rl.RateLimitConfig(
        requests_per_minute=10, requests_per_hour=100,
        requests_per_day=1000, anonymous_daily_limit=50))
    assert limiter.get_rate_limits(False)["requests_per_day"] == 50
    assert limiter.get_rate_limits(True) == {
        "requests_per_minute": 30, "requests_per_hour": 300,
        "requests_per_day": 3000}


@BOTH_RL
def test_rate_limit_abuse_block(rl):
    async def go():
        limiter = rl.RateLimiter(rl.RateLimitConfig(
            requests_per_minute=2, burst_threshold=4, block_duration=3600))
        for _ in range(10):
            await limiter.check_rate_limit("ip:abuser", False)
        assert await limiter.storage.is_blocked("ip:abuser")
        blocked = await limiter.check_rate_limit("ip:abuser", False)
        assert "blocked" in blocked["detail"]
        assert blocked["retry_after"] == 3600

    _run(go())


@BOTH_RL
def test_storage_ttl_expiry(rl):
    async def go():
        s = rl.InMemoryStorage()
        assert await s.increment("k", ttl=1) == 1
        assert await s.increment("k", ttl=1) == 2
        s._counts["k"] = (2, time.time() - 1)  # force expiry
        assert await s.increment("k", ttl=1) == 1
        await s.set_block("c", 60)
        assert await s.is_blocked("c")
        s._blocks["c"] = time.time() - 1
        assert not await s.is_blocked("c")

    _run(go())


@BOTH_RL
def test_concurrent_tracker(rl):
    async def go():
        limiter = rl.RateLimiter(rl.RateLimitConfig(concurrent_requests=2))
        async with rl.ConcurrentRequestTracker(limiter, "c"):
            async with rl.ConcurrentRequestTracker(limiter, "c"):
                with pytest.raises(rl.ConcurrencyLimitExceeded):
                    async with rl.ConcurrentRequestTracker(limiter, "c"):
                        pass
            assert limiter.active_requests["c"] == 1
        assert "c" not in limiter.active_requests

    _run(go())


@BOTH_RL
def test_make_storage_without_redis(rl):
    assert isinstance(rl.make_storage(""), rl.InMemoryStorage)
    limiter = rl.init_rate_limiter("", rl.RateLimitConfig())
    assert rl.get_rate_limiter() is limiter


@pytest.mark.parametrize("who", [
    ("1.2.3.4", "curl/8", None),
    ("1.2.3.4", "firefox", {"is_authenticated": False}),
    ("::1", "unknown", None),
    ("1.2.3.4", "x", {"uid": "internal_service", "isAnonymous": False}),
    ("1.2.3.4", "x", {"is_authenticated": True,
                      "uid": "authenticated_user"})])
def test_client_id_same_as_jax(who):
    assert trl.RateLimiter().get_client_id(*who) == \
        jrl.RateLimiter().get_client_id(*who)


# ---------------------------------------------------------------------------
# Configuration and CLI
# ---------------------------------------------------------------------------

ENV = {
    "HOST": "127.0.0.9", "PORT": "9123", "MODEL_DIR": "/m",
    "MODEL_API_KEY": "k", "CORS_ORIGINS": "http://a, http://b",
    "TRUSTED_HOSTS": "a.example,b.example", "RATE_LIMIT_PER_MINUTE": "7",
    "RATE_LIMIT_PER_HOUR": "70", "RATE_LIMIT_PER_DAY": "700",
    "RATE_LIMIT_ANON_DAILY": "17", "MAX_CONCURRENT_REQUESTS": "3",
    "REDIS_URL": "redis://x", "MAX_BATCH_SIZE": "32",
    "BATCH_TIMEOUT_MS": "2.5", "SERVING_BATCH_MODE": "continuous",
    "SERVING_NUM_SLOTS": "31", "SERVING_SEGMENT_STEPS": "8",
    "SERVING_PIPELINE_DEPTH": "2", "SERVING_HARVEST_THREADS": "2",
    "SERVING_SEGMENT_RING": "0", "SERVING_WARMUP": "1,8,0",
    "SERVING_MESH_DATA": "4", "SERVING_CALIBRATION": "off",
    "SERVING_ADMISSION": "device", "SERVING_REQUEST_TIMEOUT": "9",
    "SERVING_DRAIN_TIMEOUT": "11", "SERVING_MAX_REQUESTS": "5",
    "SERVING_USE_FUSED": "true", "SERVING_QUANTIZE": "1",
    "SERVING_PALLAS_ENCODER": "True", "SERVING_UINT8_TRANSFER": "0",
    "SERVING_CONSTRAINED": "1",
}


@pytest.mark.parametrize("env", ["defaults", "all set"])
def test_serve_config_from_env(monkeypatch, env):
    import dataclasses

    from handwritten_math_ocr_api_tpu.core.config import ServeConfig as J

    from handwritten_math_ocr_api_torch.core.config import ServeConfig as T

    for k in ENV:
        monkeypatch.delenv(k, raising=False)
    if env == "all set":
        for k, v in ENV.items():
            monkeypatch.setenv(k, v)
    t, j = T.from_env(), J.from_env()
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert [f.name for f in dataclasses.fields(T)] == \
        [f.name for f in dataclasses.fields(J)]
    if env == "all set":
        assert t.constrained_decode and t.warmup_batch_sizes == (1, 8)


def test_cli_serve_help(capsys):
    from handwritten_math_ocr_api_tpu import cli as jcli

    from handwritten_math_ocr_api_torch import cli as tcli

    out = []
    for cli in (jcli, tcli):
        with pytest.raises(SystemExit):
            cli.main(["serve", "--help"])
        out.append(capsys.readouterr().out)
    # the program's name differs, and with its length the usage line's
    # wrapping
    norm = [" ".join(o.replace("handwritten_math_ocr_api_tpu", "PROG")
                     .replace("handwritten_math_ocr_api_torch", "PROG")
                     .split()) for o in out]
    assert norm[0] == norm[1] and "--model-dir" in norm[1]


@pytest.mark.parametrize("method", ["platt", "isotonic"])
def test_cli_calibrate(tmp_path, capsys, method):
    from handwritten_math_ocr_api_tpu import cli as jcli

    from handwritten_math_ocr_api_torch import cli as tcli

    rng = np.random.default_rng(3)
    csv_path = tmp_path / "test_results.csv"
    with open(csv_path, "w") as f:
        f.write("image,prediction,confidence,exact_match\n")
        for i in range(60):
            c = rng.uniform(0.05, 1.0)
            f.write(f"{i}.png,x,{c if i % 7 else ''},"
                    f"{rng.random() < c}\n")
    outs = []
    for name, cli in (("jax", jcli), ("port", tcli)):
        out = tmp_path / f"{name}.json"
        assert cli.main(["calibrate", "--results", str(csv_path), "--out",
                         str(out), "--method", method]) == 0
        text = capsys.readouterr().out
        outs.append((text.replace(str(out), "OUT"), json.loads(
            out.read_text())))
    assert outs[0] == outs[1]
    few = tmp_path / "few.csv"
    few.write_text("confidence,exact_match\n0.5,True\n")
    assert jcli.main(["calibrate", "--results", str(few)]) == \
        tcli.main(["calibrate", "--results", str(few)]) == 1


def test_port_imports_no_jax():
    """Every module of the port imported in a fresh interpreter: neither
    jax nor the JAX package is loaded because of them (nor PIL, which the
    upload intake imports inside the function)."""
    script = r"""
import importlib, pkgutil, sys
before = set(sys.modules)
import handwritten_math_ocr_api_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in set(sys.modules) - before
             if m.split(".")[0] in ("jax", "jaxlib",
                                    "handwritten_math_ocr_api_tpu", "PIL"))
print(len(names), bad)
"""
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", script], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    n, bad = out.stdout.strip().split(" ", 1)
    assert int(n) > 40 and bad == "[]", out.stdout
