"""Shared pieces of the serving-app tests (``test_torch_app.py``,
``test_torch_app_transport.py``, ``test_torch_http.py`` and others): a
tiny serving artifact saved by the JAX package, the JAX app and the
port's app (both on aiohttp) each served on 127.0.0.1 from a thread of its
own, and one standard-library HTTP client for both.

The artifact is ``tests/test_serve.py``'s ``TINY`` configuration (a
two-stage Swin on 96x320 images, d_model 32, 2 decoder layers, vocab 20,
float32) with JAX's ``init_model`` weights, the EOS bias raised so that
rows end within a few steps (a decode of JAX's default 150 steps on the
CPU would set the files' pace) and the PAD bias lowered (a model that
emits PAD never ends JAX's ``predict_stream``).
"""

import asyncio
import base64
import http.client
import io
import json
import threading

import numpy as np

import jax

from handwritten_math_ocr_api_tpu.core.config import ModelConfig, SwinConfig

TINY = ModelConfig(
    d_model=32, nhead=4, dim_feedforward=64, dropout=0.0,
    num_decoder_layers=2, max_seq_len=8, vocab_size=20, dtype="float32",
    swin=SwinConfig(embed_dim=8, depths=(1, 1), num_heads=(2, 2),
                    window_size=4, stochastic_depth=0.0),
)
VOCAB = {"<pad>": 0, "<sos>": 1, "<eos>": 2, "<unk>": 3,
         **{f"t{i}": i for i in range(4, TINY.vocab_size)}}
EOS_BOOST = 0.9
CONF_TOL = 1e-5


def save_artifact(directory: str) -> str:
    """The tiny serving artifact (JAX's ``save_params_for_serving``)."""
    from handwritten_math_ocr_api_tpu.models.model import init_model
    from handwritten_math_ocr_api_tpu.train.checkpoint import (
        save_params_for_serving,
    )

    params, _ = init_model(jax.random.PRNGKey(0), TINY)
    params = jax.tree_util.tree_map(np.array, params)
    params["decoder"]["fc_out"]["b"][2] += EOS_BOOST
    params["decoder"]["fc_out"]["b"][0] = -1e4
    return save_params_for_serving(directory, params, VOCAB, TINY)


def png_bytes(shape=(50, 120), seed=0) -> bytes:
    """A grayscale PNG of random pixels (PIL-written), as JAX's tests
    upload."""
    from PIL import Image

    rng = np.random.default_rng(seed)
    buf = io.BytesIO()
    Image.fromarray(rng.integers(0, 255, shape, np.uint8), "L").save(
        buf, "PNG")
    return buf.getvalue()


def b64(data: bytes) -> str:
    return base64.b64encode(data).decode()


# ---------------------------------------------------------------------------
# Servers
# ---------------------------------------------------------------------------

class _AppThread:
    """An aiohttp app on 127.0.0.1 (an ephemeral port), served as
    ``run_server`` serves it (``handler_cancellation=True``) from a thread
    with its own event loop: ``web.AppRunner`` and a ``TCPSite``. The
    constructor raises what the app's startup raised. A ``GracefulExit``
    from the app (a recycle's default exit) ends the loop as it ends
    ``web.run_app``'s, and the cleanup runs after it, as there."""

    def __init__(self, app, exit_callback=None):
        from aiohttp import web

        self.app = app
        self.state = app["state"]
        self.state.exit_callback = exit_callback
        self._loop = asyncio.new_event_loop()
        self._error = None
        ready = threading.Event()

        async def start():
            self._runner = web.AppRunner(app, handler_cancellation=True)
            await self._runner.setup()
            site = web.TCPSite(self._runner, "127.0.0.1", 0)
            await site.start()
            self.port = site._server.sockets[0].getsockname()[1]

        def run():
            asyncio.set_event_loop(self._loop)
            try:
                self._loop.run_until_complete(start())
            except BaseException as e:  # handed to the constructor
                self._error = e
                ready.set()
                self._loop.close()
                return
            ready.set()
            try:
                self._loop.run_until_complete(self._stop.wait())
            except web.GracefulExit:
                pass
            finally:
                self._loop.run_until_complete(self._runner.cleanup())
                rest = asyncio.all_tasks(self._loop)
                for task in rest:
                    task.cancel()
                self._loop.run_until_complete(
                    asyncio.gather(*rest, return_exceptions=True))
                self._loop.close()

        self._stop = asyncio.Event()
        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()
        if not ready.wait(300):
            raise TimeoutError("the app did not start")
        if self._error is not None:
            self._thread.join(60)
            raise self._error

    def stop(self):
        try:
            self._loop.call_soon_threadsafe(self._stop.set)
        except RuntimeError:  # the loop has closed: the app stopped itself
            pass
        if not self.join(120):
            raise TimeoutError("the app did not stop")

    def join(self, timeout_s):
        """Wait for the serving thread; True if it has ended."""
        self._thread.join(timeout_s)
        return not self._thread.is_alive()


class JaxServer(_AppThread):
    """The JAX package's aiohttp app."""

    def __init__(self, cfg, exit_callback=None, state=None):
        from handwritten_math_ocr_api_tpu.serve.app import create_app

        super().__init__(create_app(cfg, state), exit_callback)


class PortServer(_AppThread):
    """The port's aiohttp app, on the CPU."""

    def __init__(self, cfg, exit_callback=None, state=None):
        from handwritten_math_ocr_api_torch.serve.app import create_app

        super().__init__(create_app(cfg, state, device="cpu"),
                         exit_callback)


# rate limits above any test's requests
UNLIMITED = dict(rate_limit_per_minute=10 ** 6, rate_limit_per_hour=10 ** 6,
                 rate_limit_per_day=10 ** 6,
                 rate_limit_anonymous_daily=10 ** 6)


def port_config(**kw):
    from handwritten_math_ocr_api_torch.core.config import ServeConfig

    return ServeConfig(**{"batch_timeout_ms": 1.0, **kw})


def jax_config(**kw):
    from handwritten_math_ocr_api_tpu.core.config import ServeConfig

    return ServeConfig(**{"batch_timeout_ms": 1.0, **kw})


# ---------------------------------------------------------------------------
# Client
# ---------------------------------------------------------------------------

class Reply:
    def __init__(self, status, headers, body):
        self.status = status
        self.headers = headers
        self.body = body

    def json(self):
        return json.loads(self.body)

    def events(self):
        """The JSON events of a server-sent-event body."""
        return [json.loads(line[len("data: "):])
                for line in self.body.decode().splitlines()
                if line.startswith("data: ")]


def call(port, method, path, body=None, headers=None, timeout=120):
    """One request on a fresh connection."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        conn.request(method, path, body=body, headers=headers or {})
        r = conn.getresponse()
        return Reply(r.status, {k.lower(): v for k, v in r.getheaders()},
                     r.read())
    finally:
        conn.close()


def post_json(port, path, obj, headers=None):
    return call(port, "POST", path, json.dumps(obj),
                {"Content-Type": "application/json", **(headers or {})})


def multipart(fields):
    """(body, content type) of a multipart/form-data body of (name,
    filename or None, bytes) fields."""
    boundary = "----mathocr-test-boundary-7f3a9c"
    out = bytearray()
    for name, filename, data in fields:
        out += f"--{boundary}\r\n".encode()
        disp = f'form-data; name="{name}"'
        if filename is not None:
            disp += f'; filename="{filename}"'
        out += f"Content-Disposition: {disp}\r\n".encode()
        if filename is not None:
            out += b"Content-Type: application/octet-stream\r\n"
        out += b"\r\n" + data + b"\r\n"
    out += f"--{boundary}--\r\n".encode()
    return bytes(out), f"multipart/form-data; boundary={boundary}"


def post_file(port, path, data, filename="f.png", name="file"):
    body, ctype = multipart([(name, filename, data)])
    return call(port, "POST", path, body, {"Content-Type": ctype})


def both(servers, fn):
    """fn(port) on the JAX app and on the port's: (JAX's, the port's)."""
    return fn(servers[0].port), fn(servers[1].port)


def same_prediction(j, t, tol=CONF_TOL):
    assert j["formula"] == t["formula"], (j, t)
    if j["confidence"] is None:
        assert t["confidence"] is None
    else:
        assert abs(j["confidence"] - t["confidence"]) < tol, (j, t)


TIMING = {"processing_time", "timestamp", "uptime", "model_load_time",
          "device"}


def _strip(obj):
    if isinstance(obj, dict):
        return {k: _strip(v) for k, v in obj.items() if k not in TIMING}
    if isinstance(obj, list):
        return [_strip(v) for v in obj]
    return obj


def same_json(j, t):
    """Equal but for the timing fields (and the device), confidences
    within ``CONF_TOL``."""
    j, t = _strip(j), _strip(t)
    if isinstance(j, dict):
        assert j.keys() == t.keys(), (j, t)
        for k in j:
            if k == "confidence" and isinstance(j[k], float):
                assert abs(j[k] - t[k]) < CONF_TOL, (j, t)
            else:
                same_json(j[k], t[k])
    elif isinstance(j, list):
        assert len(j) == len(t), (j, t)
        for a, b in zip(j, t):
            same_json(a, b)
    else:
        assert j == t, (j, t)


def stop_all(*servers):
    for s in servers:
        s.stop()

