"""The port's app and JAX's, both on aiohttp, answer every request alike,
transport behaviour included.

Each case sends the same request, or the same exchange on one connection,
to both apps (``torch_app_harness.both``) and holds each answer's status,
its JSON body (timestamps masked, confidences within 1e-5; a body that is
not JSON byte for byte) and a named set of headers: the values of
``HEADERS``, and whether ``X-Request-ID`` is there. The apps serve the
tiny artifact of ``test_torch_app.py``; one pair is open, one has an API
key and a small ``max_file_size`` (``client_max_size`` is
``max_file_size`` + 1 MiB in both), so that a body over it is cheap to
send. The cases: uploads, a chunked body, keep-alive, HEAD, HTTP/1.0,
``Expect: 100-continue``, 404 and 405, oversized bodies in the order
JAX's middlewares see them (auth before the body is read), malformed
JSON, ``X-Request-ID`` (on ``/predict``, not on a stream, whose headers
went out at ``prepare``), CORS and ``/openapi.json``.
"""

import http.client
import json
import re
import socket

import pytest

import torch_app_harness as h
import torch_threads  # noqa: F401  (one CPU thread: see the module)

KEY = "sekrit"
SMALL_FILE = 4096                       # the keyed pair's max_file_size
OVER = SMALL_FILE + 1024 * 1024 + 1     # one byte over its client_max_size
HEADERS = ("content-type", "allow", "connection", "transfer-encoding",
           "cache-control", "retry-after", "access-control-allow-origin",
           "access-control-allow-methods", "access-control-allow-headers")


@pytest.fixture(scope="module")
def artifact(tmp_path_factory):
    return h.save_artifact(str(tmp_path_factory.mktemp("transport") /
                               "model"))


@pytest.fixture(scope="module")
def pairs(artifact):
    """{"open": (JAX's app, the port's), "keyed": the same with an API key
    and ``max_file_size`` SMALL_FILE}; rate limits raised."""
    out = {}
    try:
        for name, kw in (("open", {}),
                         ("keyed", dict(api_key=KEY,
                                        max_file_size=SMALL_FILE))):
            kw = dict(model_dir=artifact, **h.UNLIMITED, **kw)
            out[name] = (h.JaxServer(h.jax_config(**kw)),
                         h.PortServer(h.port_config(**kw)))
        yield out
    finally:
        for pair in out.values():
            h.stop_all(*pair)


def _reply(r):
    return h.Reply(r.status, {k.lower(): v for k, v in r.getheaders()},
                   r.read())


def _raw(port, head, body=b"", expect_continue=False):
    """Send ``head`` (and ``body``) on a socket, waiting for the interim
    ``100 Continue`` first when asked; read the one response."""
    s = socket.create_connection(("127.0.0.1", port), timeout=120)
    try:
        s.sendall(head)
        if expect_continue:
            interim = b""
            while not interim.endswith(b"\r\n\r\n"):
                chunk = s.recv(1)
                assert chunk, interim
                interim += chunk
            assert interim == b"HTTP/1.1 100 Continue\r\n\r\n", interim
        s.sendall(body)
        r = http.client.HTTPResponse(s)
        r.begin()
        return [_reply(r)]
    finally:
        s.close()


def _json_head(method, path, n, extra=b""):
    return (f"{method} {path} HTTP/1.1\r\nHost: 127.0.0.1\r\n"
            f"Content-Type: application/json\r\nContent-Length: {n}\r\n"
            "Connection: close\r\n").encode() + extra + b"\r\n"


def _image_json():
    return json.dumps({"image_data": h.b64(h.png_bytes())}).encode()


def multipart_upload(port):
    return [h.post_file(port, "/predict", h.png_bytes())]


def multipart_without_file(port):
    return [h.post_file(port, "/predict", h.png_bytes(), name="image")]


def chunked_json(port):
    body = _image_json()
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    try:
        conn.request("POST", "/predict",
                     body=iter([body[:7], body[7:300], body[300:]]),
                     headers={"Content-Type": "application/json",
                              "Transfer-Encoding": "chunked"},
                     encode_chunked=True)
        return [_reply(conn.getresponse())]
    finally:
        conn.close()


def kept_alive(port):
    """Two requests on one connection: the second is answered on it."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    try:
        conn.request("GET", "/status")
        first = _reply(conn.getresponse())
        sock = conn.sock
        conn.request("POST", "/predict", _image_json(),
                     {"Content-Type": "application/json"})
        second = _reply(conn.getresponse())
        assert conn.sock is sock and sock is not None
        return [first, second]
    finally:
        conn.close()


def head_health(port):
    return [h.call(port, "HEAD", "/health")]


def http10(port):
    return _raw(port, b"GET /status HTTP/1.0\r\n\r\n")


def expect_continue(port):
    body = _image_json()
    return _raw(port, _json_head("POST", "/predict", len(body),
                                 b"Expect: 100-continue\r\n"),
                body, expect_continue=True)


def unknown_path(port):
    return [h.call(port, "GET", "/nope")]


def wrong_method(port):
    return [h.call(port, "PUT", "/predict")]


def oversized_predict(headers):
    def send(port):
        body = b'{"image_data": "' + b"A" * OVER + b'"}'
        return [h.call(port, "POST", "/predict", body,
                       {"Content-Type": "application/json", **headers})]
    return send


def oversized_upload(port):
    body, ctype = h.multipart([("file", "f.png", b"\x89PNG" * (OVER // 4))])
    return [h.call(port, "POST", "/predict", body,
                   {"Content-Type": ctype, "X-API-Key": KEY})]


def file_over_max_size(port):
    body, ctype = h.multipart([("file", "f.png", b"\x89PNG" * SMALL_FILE)])
    return [h.call(port, "POST", "/predict", body,
                   {"Content-Type": ctype, "X-API-Key": KEY})]


def oversized_batch(port):
    body = json.dumps({"images": ["A" * OVER]}).encode()
    return [h.call(port, "POST", "/predict/batch", body,
                   {"Content-Type": "application/json", "X-API-Key": KEY})]


def malformed_json(port):
    return [h.call(port, "POST", "/predict/batch", b'{"images": [',
                   {"Content-Type": "application/json"})]


def request_id_predict(port):
    return [h.post_json(port, "/predict",
                        {"image_data": h.b64(h.png_bytes())})]


def request_id_stream(port):
    return [h.post_json(port, "/predict/stream?segment_steps=4",
                        {"image_data": h.b64(h.png_bytes())})]


def cors_preflight(port):
    return [h.call(port, "OPTIONS", "/predict/batch",
                   headers={"Origin": "http://client.example",
                            "Access-Control-Request-Method": "POST"})]


def openapi(port):
    return [h.call(port, "GET", "/openapi.json")]


# name: (pair, exchange, the statuses, X-Request-ID on each answer). An
# error answer has none: the error middleware, outside the request-id one,
# makes it from the exception.
CASES = {
    "multipart upload": ("open", multipart_upload, [200], [True]),
    "multipart without file": ("open", multipart_without_file, [400],
                               [False]),
    "chunked JSON": ("open", chunked_json, [200], [True]),
    "keep-alive": ("open", kept_alive, [200, 200], [True, True]),
    "HEAD /health": ("open", head_health, [200], [True]),
    "HTTP/1.0": ("open", http10, [200], [True]),
    "Expect 100-continue": ("open", expect_continue, [200], [True]),
    "404": ("open", unknown_path, [404], [False]),
    "405": ("open", wrong_method, [405], [False]),
    # JAX's order: the limiter and auth before the handler reads the body
    "oversized, no API key": ("keyed", oversized_predict({}), [401],
                              [False]),
    "oversized, API key": ("keyed", oversized_predict({"X-API-Key": KEY}),
                           [400], [False]),
    "oversized upload, API key": ("keyed", oversized_upload, [413],
                                  [False]),
    "file over max_file_size": ("keyed", file_over_max_size, [413],
                                [False]),
    "oversized batch": ("keyed", oversized_batch, [422], [False]),
    "malformed JSON": ("open", malformed_json, [422], [False]),
    "X-Request-ID /predict": ("open", request_id_predict, [200], [True]),
    # a stream's headers go out at prepare, before the middleware sets it
    "X-Request-ID /predict/stream": ("open", request_id_stream, [200],
                                     [False]),
    # the CORS middleware answers a preflight itself
    "CORS preflight": ("open", cors_preflight, [204], [False]),
    "openapi.json": ("open", openapi, [200], [True]),
}


def _body(reply):
    ctype = reply.headers.get("content-type", "")
    if ctype.startswith("application/json") and reply.body:
        return reply.json()
    if ctype == "text/event-stream":
        return reply.events()
    # aiohttp's 413 of a multipart body counts the bytes read when the
    # limit tripped: its 64 KiB reads take what the socket holds
    return re.sub(rb"actual body size \d+", b"actual body size N",
                  reply.body)


@pytest.mark.parametrize("case", sorted(CASES))
def test_transport_same_as_jax(pairs, case):
    pair, exchange, statuses, request_ids = CASES[case]
    jax_replies, port_replies = h.both(pairs[pair], exchange)
    assert len(jax_replies) == len(port_replies) == len(statuses)
    for j, t, status, rid in zip(jax_replies, port_replies, statuses,
                                 request_ids):
        assert j.status == t.status == status, (j.body[:300], t.body[:300])
        for k in HEADERS:
            assert j.headers.get(k) == t.headers.get(k), k
        assert ("x-request-id" in j.headers) == \
            ("x-request-id" in t.headers) == rid
        h.same_json(_body(j), _body(t))
