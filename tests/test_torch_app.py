"""The port's serving app (``serve/app.py``) against the JAX package's,
both on aiohttp, on the same artifact and the same requests.

Both apps load one tiny serving artifact that JAX's
``save_params_for_serving`` wrote (``torch_app_harness.save_artifact``:
``tests/test_serve.py``'s ``TINY`` configuration, float32) and are served
on 127.0.0.1 from threads of their own; one standard-library client sends
each request to both. The port's app runs on the CPU (``device="cpu"``),
where its engine runs every kernel's plain version; JAX's app serves its
XLA path.

What is held: the status, the JSON keys and the values of every route's
answer, with formulas equal and confidences within 1e-5 (float32), and
only ``processing_time``, ``timestamp``, ``uptime``, ``model_load_time``
and ``device`` left out; ``/openapi.json`` deep; the 400s of bad input
and of the sampling parameters, the 422s of bad batch bodies (status, error
and pydantic's detail text); auth (401, 403, 200 with
``X-API-Key`` and with ``Bearer``); the rate limit's 429 at the same
request with the same body keys and the same ``client_id``; calibration;
``uint8_transfer`` off; continuous batching on the default and the fused
route (against JAX's default continuous app); recycling after
``max_requests``, and the port's server stopping itself after it.
"""

import json
import os
import shutil
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import pytest

import torch_app_harness as h
import torch_threads  # noqa: F401  (one CPU thread: see the module)


@pytest.fixture(scope="module")
def artifact(tmp_path_factory):
    return h.save_artifact(str(tmp_path_factory.mktemp("app") / "model"))


@pytest.fixture(scope="module")
def servers(artifact):
    """(JAX's app, the port's app) with the default configuration, but
    for rate limits raised above this file's requests (the default limits
    are held in ``test_auth_and_rate_limit``)."""
    kw = dict(model_dir=artifact, **h.UNLIMITED)
    pair = (h.JaxServer(h.jax_config(**kw)), h.PortServer(h.port_config(**kw)))
    yield pair
    h.stop_all(*pair)


def _both_json(servers, fn, status=200):
    j, t = h.both(servers, fn)
    assert j.status == t.status == status, (j.body, t.body)
    return j.json(), t.json()


def test_predict_multipart_and_base64(servers):
    png = h.png_bytes()
    j, t = _both_json(servers, lambda p: h.post_file(p, "/predict", png))
    assert set(j) == set(t) == {"formula", "confidence", "processing_time",
                                "timestamp"}
    h.same_prediction(j, t)
    j2, t2 = _both_json(servers, lambda p: h.post_json(
        p, "/predict", {"image_data": h.b64(png)}))
    h.same_prediction(j2, t2)
    assert t2["formula"] == t["formula"]


def test_predict_images(servers):
    """Several uploads, at other sizes and at the model's size, each equal
    to JAX's."""
    for seed, shape in ((1, (50, 120)), (2, (96, 320)), (3, (200, 40))):
        png = h.png_bytes(shape, seed)
        j, t = _both_json(servers, lambda p: h.post_json(
            p, "/predict", {"image_data": h.b64(png)}))
        h.same_prediction(j, t)


def test_fused_route(artifact, servers):
    """The port's app on the fused route (``SERVING_USE_FUSED``,
    ``SERVING_PALLAS_ENCODER``) against JAX's app (its XLA path): the same
    formulas in float32, greedy (rows that end and rows that run all 150
    steps, past the model's 8-row positional table), sampled with
    ``top_k=1`` and streamed."""
    port = h.PortServer(h.port_config(model_dir=artifact,
                                      use_fused_decode=True,
                                      pallas_encoder_block=True,
                                      **h.UNLIMITED))
    try:
        # the shared apps answer too, so that their counters stay equal
        for seed, shape in ((0, (50, 120)), (6, (96, 320)), (7, (96, 320))):
            body = {"image_data": h.b64(h.png_bytes(shape, seed))}
            for path in ("/predict", "/predict?top_k=1"):
                j, t = _both_json(servers, lambda p: h.post_json(p, path,
                                                                 body))
                fused = h.post_json(port.port, path, body)
                assert fused.status == 200
                h.same_prediction(j, fused.json())
                h.same_prediction(t, fused.json())
        j, _ = h.both(servers, lambda p: h.post_json(
            p, "/predict/stream?segment_steps=4", body))
        fused = h.post_json(port.port, "/predict/stream?segment_steps=4",
                            body)
        h.same_json(j.events(), fused.events())
        assert port.state.engine.use_fused
    finally:
        port.stop()


def test_predict_top_k_1_is_greedy(servers):
    body = {"image_data": h.b64(h.png_bytes())}
    greedy = _both_json(servers, lambda p: h.post_json(p, "/predict", body))
    top1 = _both_json(servers, lambda p: h.post_json(
        p, "/predict?top_k=1&seed=3", body))
    h.same_prediction(*top1)
    h.same_prediction(greedy[1], top1[1])


def test_predict_beam(servers):
    body = {"image_data": h.b64(h.png_bytes())}
    j, t = _both_json(servers, lambda p: h.post_json(
        p, "/predict?beam_size=3", body))
    assert j["confidence"] is None and t["confidence"] is None
    h.same_prediction(j, t)


def test_predict_batch_mixed(servers):
    good = h.b64(h.png_bytes())
    other = h.b64(h.png_bytes((96, 320), 4))
    j, t = _both_json(servers, lambda p: h.post_json(
        p, "/predict/batch", {"images": [good, "%%%bad", other]}))
    assert t["total_images"] == 3 and t["successful_predictions"] == 2
    assert [r["success"] for r in t["results"]] == [True, False, True]
    h.same_json(j, t)


@pytest.mark.parametrize("body", [
    {"images": []}, {"images": ["x"] * 11}, {"images": "abc"},
    {"images": [1, 2]}, {}, [1, 2]])
def test_predict_batch_422(servers, body):
    j, t = h.both(servers, lambda p: h.post_json(p, "/predict/batch", body))
    assert j.status == t.status == 422
    assert set(j.json()) == set(t.json()) == {"error", "detail",
                                              "timestamp"}
    assert j.json()["error"] == t.json()["error"]
    # a body that is not a mapping: Python's TypeError names the schema
    # class by its module, whose package is each app's own
    assert j.json()["detail"] == t.json()["detail"].replace(
        "handwritten_math_ocr_api_torch.", "handwritten_math_ocr_api_tpu.")


def test_predict_stream(servers):
    body = {"image_data": h.b64(h.png_bytes())}
    j, t = h.both(servers, lambda p: h.post_json(
        p, "/predict/stream?segment_steps=4", body))
    assert j.status == t.status == 200
    assert j.headers["content-type"] == t.headers["content-type"] \
        == "text/event-stream"
    assert set(j.headers) - {"date"} == set(t.headers) - {"date"}
    for k in set(j.headers) - {"date"}:
        assert j.headers[k] == t.headers[k], k
    ej, et = j.events(), t.events()
    assert et and et[-1]["done"] is True
    h.same_json(ej, et)
    plain = _both_json(servers, lambda p: h.post_json(p, "/predict", body))
    assert et[-1]["formula"] == plain[1]["formula"]


BAD_INPUTS = {
    "bad base64": lambda p: h.post_json(p, "/predict",
                                        {"image_data": "!!!notb64"}),
    "not an image": lambda p: h.post_json(
        p, "/predict", {"image_data": h.b64(b"not an image")}),
    "no image data": lambda p: h.post_json(p, "/predict", {}),
    "no JSON": lambda p: h.call(p, "POST", "/predict", b"{{",
                                {"Content-Type": "application/json"}),
    "empty file": lambda p: h.post_file(p, "/predict", b""),
    "bad extension": lambda p: h.post_file(p, "/predict", h.png_bytes(),
                                           filename="f.exe"),
    "no file field": lambda p: h.post_file(p, "/predict", h.png_bytes(),
                                           name="image"),
    "beam 99": lambda p: h.post_json(p, "/predict?beam_size=99",
                                     {"image_data": "x"}),
    "beam not int": lambda p: h.post_json(p, "/predict?beam_size=a",
                                          {"image_data": "x"}),
    "temperature 0": lambda p: h.post_json(p, "/predict?temperature=0",
                                           {"image_data": "x"}),
    "top_p 1.5": lambda p: h.post_json(p, "/predict?top_p=1.5",
                                       {"image_data": "x"}),
    "top_k 2000": lambda p: h.post_json(p, "/predict?top_k=2000",
                                        {"image_data": "x"}),
    "seed not int": lambda p: h.post_json(p, "/predict?seed=x",
                                          {"image_data": "x"}),
    "sampling and beam": lambda p: h.post_json(
        p, "/predict?temperature=1.5&beam_size=3", {"image_data": "x"}),
    "segment_steps 0": lambda p: h.post_json(
        p, "/predict/stream?segment_steps=0", {"image_data": "x"}),
    "segment_steps 65": lambda p: h.post_json(
        p, "/predict/stream?segment_steps=65", {"image_data": "x"}),
}


@pytest.mark.parametrize("case", sorted(BAD_INPUTS))
def test_predict_invalid_inputs(servers, case):
    j, t = h.both(servers, BAD_INPUTS[case])
    assert j.status == t.status == 400, (j.body, t.body)
    h.same_json(j.json(), t.json())


def test_status_health_model_info(servers):
    for path in ("/status", "/health", "/model/info"):
        j, t = _both_json(servers, lambda p: h.call(p, "GET", path))
        h.same_json(j, t)
    assert h.call(servers[1].port, "GET", "/status").json()["device"] \
        == "cpu"


def test_openapi_docs_and_root(servers):
    j, t = _both_json(servers, lambda p: h.call(p, "GET", "/openapi.json"))
    assert j == t
    for path in ("/docs", "/redoc", "/"):
        j, t = h.both(servers, lambda p: h.call(p, "GET", path))
        assert j.status == t.status == 200
        assert j.body == t.body
        assert j.headers["content-type"] == t.headers["content-type"]


def _keys(obj, depth=2):
    if not isinstance(obj, dict) or depth == 0:
        return None
    return {k: _keys(v, depth - 1) for k, v in obj.items()}


def test_metrics_and_rate_limit_status(servers):
    h.both(servers, lambda p: h.post_json(
        p, "/predict", {"image_data": h.b64(h.png_bytes())}))
    j, t = _both_json(servers, lambda p: h.call(p, "GET", "/metrics"))
    assert _keys(j) == _keys(t)
    assert t["batching"]["images_decoded"] >= 1
    j, t = _both_json(servers, lambda p: h.call(p, "GET",
                                                "/rate-limit/status"))
    assert j["client_id"] == t["client_id"]
    assert _keys(j) == _keys(t)
    assert j["limits"] == t["limits"]


def test_cors_request_id_and_unknown_routes(servers):
    j, t = h.both(servers, lambda p: h.call(
        p, "OPTIONS", "/predict", headers={"Origin": "http://x"}))
    assert j.status == t.status == 204
    for k in ("access-control-allow-origin", "access-control-allow-methods",
              "access-control-allow-headers"):
        assert j.headers[k] == t.headers[k]
    j, t = h.both(servers, lambda p: h.call(p, "GET", "/status"))
    assert "x-request-id" in j.headers and "x-request-id" in t.headers
    assert j.headers["content-type"] == t.headers["content-type"] \
        == "application/json; charset=utf-8"
    for method, path, status in (("GET", "/nope", 404),
                                 ("GET", "/predict", 405),
                                 ("POST", "/status", 405)):
        j, t = h.both(servers, lambda p: h.call(p, method, path))
        assert j.status == t.status == status
        assert j.body == t.body


class _FrozenClock:
    """The ``time`` module with ``time()`` held at one instant."""

    def __init__(self, now: float):
        self.now = now

    def time(self) -> float:
        return self.now

    def __getattr__(self, name):
        return getattr(time, name)


def test_auth_and_rate_limit(artifact, monkeypatch):
    """An API key and the default limits (20 requests a minute): 401
    without the key, 403 with a wrong one, 200 with ``X-API-Key`` and with
    ``Bearer``; then anonymous requests (each a 401, each counted) until
    the anonymous client's 21st gets 429: the same status and body at each
    request of the sequence on both apps, and the same ``client_id``. Both
    limiters count in windows keyed on ``time.time()``: the clock both
    limiter modules read is held one second into a minute, so that the
    sequence never crosses a window boundary on one app and not the
    other."""
    from handwritten_math_ocr_api_torch.serve import rate_limiter as t_rl
    from handwritten_math_ocr_api_tpu.serve import rate_limiter as j_rl

    clock = _FrozenClock(int(time.time()) // 60 * 60 + 1.0)
    monkeypatch.setattr(t_rl, "time", clock)
    monkeypatch.setattr(j_rl, "time", clock)
    kw = dict(model_dir=artifact, api_key="sekrit")
    pair = (h.JaxServer(h.jax_config(**kw)), h.PortServer(h.port_config(**kw)))
    try:
        body = {"image_data": h.b64(h.png_bytes())}
        key = {"X-API-Key": "sekrit"}
        sequence = ([{}, {"X-API-Key": "wrong"}, key,
                     {"Authorization": "Bearer sekrit"}] + [{}] * 19)
        got = {}
        for name, s in zip(("jax", "port"), pair):
            got[name] = [h.post_json(s.port, "/predict", body, hdr)
                         for hdr in sequence]
        statuses = [r.status for r in got["port"]]
        assert statuses == [r.status for r in got["jax"]]
        assert statuses[:4] == [401, 403, 200, 200]
        assert statuses[4:] == [401] * 18 + [429]
        for j, t in zip(got["jax"], got["port"]):
            assert set(j.json()) == set(t.json())
            if j.status == 200:
                h.same_prediction(j.json(), t.json())
            else:
                assert j.json()["detail"] == t.json()["detail"]
                assert j.json().get("limit") == t.json().get("limit")
        # probe paths are not limited; the limiter sees the same clients
        for s in pair:
            assert h.call(s.port, "GET", "/health").status == 200
        j, t = _both_json(pair, lambda p: h.call(
            p, "GET", "/rate-limit/status", headers=key))
        assert j["client_id"] == t["client_id"] \
            == "service:authenticated_user"
        assert j["current_usage"] == t["current_usage"]
        # the anonymous client stays limited on every limited path
        j, t = h.both(pair, lambda p: h.call(p, "GET", "/rate-limit/status"))
        assert j.status == t.status == 429
        assert set(j.json()) == set(t.json())
    finally:
        h.stop_all(*pair)


def test_uint8_transfer_off(artifact, servers):
    kw = dict(model_dir=artifact, uint8_transfer=False, **h.UNLIMITED)
    pair = (h.JaxServer(h.jax_config(**kw)), h.PortServer(h.port_config(**kw)))
    try:
        for shape in ((50, 120), (96, 320)):
            body = {"image_data": h.b64(h.png_bytes(shape, 5))}
            j, t = _both_json(pair, lambda p: h.post_json(p, "/predict",
                                                          body))
            h.same_prediction(j, t)
            u8 = h.post_json(servers[1].port, "/predict", body).json()
            h.same_prediction(u8, t)
    finally:
        h.stop_all(*pair)


def test_calibration(artifact, tmp_path):
    """A Platt artifact in the model dir (``SERVING_CALIBRATION=auto``):
    the calibrated confidence equal to JAX's, and not the raw one."""
    d = str(tmp_path / "model")
    shutil.copytree(artifact, d)
    with open(os.path.join(d, "calibration.json"), "w") as f:
        json.dump({"method": "platt", "a": 1.5, "b": -0.3}, f)
    pair = (h.JaxServer(h.jax_config(model_dir=d)),
            h.PortServer(h.port_config(model_dir=d)))
    try:
        png = h.png_bytes()
        j, t = _both_json(pair, lambda p: h.post_file(p, "/predict", png))
        h.same_prediction(j, t)
        raw = _both_json(pair, lambda p: h.post_json(
            p, "/predict?beam_size=1&top_k=1", {"image_data": h.b64(png)}))
        h.same_prediction(*raw)
        j, t = _both_json(pair, lambda p: h.post_json(
            p, "/predict/batch", {"images": [h.b64(png)]}))
        h.same_json(j, t)
    finally:
        h.stop_all(*pair)
    plain = h.PortServer(h.port_config(model_dir=artifact))
    try:
        uncal = h.post_file(plain.port, "/predict", png).json()
    finally:
        plain.stop()
    assert abs(uncal["confidence"] - t["results"][0]["confidence"]) > 1e-3


CONT = dict(batching_mode="continuous", num_slots=4, segment_steps=4)


@pytest.fixture(scope="module")
def jax_continuous(artifact):
    s = h.JaxServer(h.jax_config(model_dir=artifact, **CONT, **h.UNLIMITED))
    yield s
    s.stop()


def _burst(port, images):
    with ThreadPoolExecutor(len(images)) as ex:
        return list(ex.map(lambda im: h.post_json(
            port, "/predict", {"image_data": h.b64(im)}), images))


@pytest.mark.parametrize("fused", [False, True])
def test_continuous_mode(artifact, jax_continuous, fused):
    """6 concurrent requests and a batch of 2 through the continuous
    engine (4 slots: admissions mid-flight), on the port's default and
    fused routes, each equal to JAX's default continuous app."""
    images = [h.png_bytes((96, 320) if i % 2 else (50, 120), 10 + i)
              for i in range(6)]
    port = h.PortServer(h.port_config(model_dir=artifact,
                                      use_fused_decode=fused,
                                      pallas_encoder_block=fused, **CONT,
                                      **h.UNLIMITED))
    try:
        want = _burst(jax_continuous.port, images)
        got = _burst(port.port, images)
        for j, t in zip(want, got):
            assert j.status == t.status == 200
            h.same_prediction(j.json(), t.json())
        body = {"images": [h.b64(images[0]), h.b64(images[1])]}
        j, t = h.post_json(jax_continuous.port, "/predict/batch", body), \
            h.post_json(port.port, "/predict/batch", body)
        h.same_json(j.json(), t.json())
        m = h.call(port.port, "GET", "/metrics").json()["batching"]
        assert m["mode"] == "continuous" and m["segments_run"] >= 1
        assert port.state.batcher.decoder.use_fused == fused
    finally:
        port.stop()


def test_recycle_after_max_requests(artifact):
    """``max_requests=3``: three predictions, then 503 with Retry-After,
    readiness false, the recycle counters at /metrics and the exit hook
    called once, on both apps; then the port's server with its default
    exit stops itself and runs its cleanup (the batcher stopped)."""
    exits = {"jax": [], "port": []}
    kw = dict(model_dir=artifact, max_requests=3, **h.UNLIMITED)
    pair = (h.JaxServer(h.jax_config(**kw),
                        exit_callback=lambda: exits["jax"].append(1)),
            h.PortServer(h.port_config(**kw),
                         exit_callback=lambda: exits["port"].append(1)))
    try:
        body = {"image_data": h.b64(h.png_bytes())}
        for _ in range(3):
            j, t = _both_json(pair, lambda p: h.post_json(p, "/predict",
                                                          body))
            h.same_prediction(j, t)
        j, t = h.both(pair, lambda p: h.post_json(p, "/predict", body))
        assert j.status == t.status == 503
        assert j.headers["retry-after"] == t.headers["retry-after"] == "1"
        h.same_json(j.json(), t.json())
        hj, ht = _both_json(pair, lambda p: h.call(p, "GET", "/health"))
        assert ht["checks"]["not_draining"] is False and not ht["healthy"]
        h.same_json(hj, ht)
        mj, mt = _both_json(pair, lambda p: h.call(p, "GET", "/metrics"))
        assert mj["recycle"] == mt["recycle"] == {
            "max_requests": 3, "requests_served": 3, "draining": True}
        done = threading.Event()
        for _ in range(200):
            if exits["jax"] and exits["port"]:
                break
            done.wait(0.02)
        assert exits == {"jax": [1], "port": [1]}
    finally:
        h.stop_all(*pair)

    server = h.PortServer(h.port_config(**kw))
    for _ in range(3):
        assert h.post_json(server.port, "/predict", body).status == 200
    assert server.join(60), "the recycled server did not stop"
    assert server.state.batcher._task is None  # on_cleanup ran stop()
