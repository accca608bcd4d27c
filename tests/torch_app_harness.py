"""Shared pieces of the serving-app tests (``test_torch_app.py``,
``test_torch_http.py``): a tiny serving artifact saved by the JAX package,
the JAX app and the port's app each served on 127.0.0.1 from a thread of
its own, and one standard-library HTTP client for both.

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

class JaxServer:
    """The JAX package's aiohttp app on 127.0.0.1, served as its
    ``run_server`` serves it (``handler_cancellation=True``) from a thread
    with its own event loop."""

    def __init__(self, cfg, exit_callback=None, state=None):
        from aiohttp import web

        from handwritten_math_ocr_api_tpu.serve.app import create_app

        self.app = create_app(cfg, state)
        self.state = self.app["state"]
        self.state.exit_callback = exit_callback
        self._loop = asyncio.new_event_loop()
        ready = threading.Event()

        async def start():
            self._runner = web.AppRunner(self.app,
                                         handler_cancellation=True)
            await self._runner.setup()
            site = web.TCPSite(self._runner, "127.0.0.1", 0)
            await site.start()
            self.port = site._server.sockets[0].getsockname()[1]

        def run():
            asyncio.set_event_loop(self._loop)
            self._loop.run_until_complete(start())
            ready.set()
            self._loop.run_forever()

        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()
        if not ready.wait(300):
            raise TimeoutError("the JAX app did not start")

    def stop(self):
        fut = asyncio.run_coroutine_threadsafe(self._runner.cleanup(),
                                               self._loop)
        fut.result(120)
        self._loop.call_soon_threadsafe(self._loop.stop)
        self._thread.join(60)


class PortServer:
    """The port's app on 127.0.0.1 (its own server, ``ServerThread``), on
    the CPU."""

    def __init__(self, cfg, exit_callback=None, state=None):
        from handwritten_math_ocr_api_torch.serve.app import create_app
        from handwritten_math_ocr_api_torch.serve.http import ServerThread

        self.app = create_app(cfg, state, device="cpu")
        self.state = self.app["state"]
        self.state.exit_callback = exit_callback
        self._server = ServerThread(self.app)
        self.port = self._server.port

    def stop(self):
        self._server.stop()

    def join(self, timeout_s):
        return self._server.join(timeout_s)


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


def stop_all(*servers):
    for s in servers:
        s.stop()

