"""The port's app with ``SERVING_MESH_DATA`` (``serve/app.py``): the
continuous pool sharded over a data-axis mesh, as JAX's app shards it
(``tests/test_serve.py``'s meshed continuous case).

On the host the mesh is ``[cpu] * n``. Results are held equal to the
unsharded port app's (strings exactly, confidences within
``torch_app_harness.CONF_TOL``); ``/metrics`` reports the mesh's shape.
The CUDA device count is stubbed to check the mesh the app builds on a
machine with cards, and its fallback where there are too few.
"""

import logging
from concurrent.futures import ThreadPoolExecutor

import pytest
import torch

import torch_app_harness as h
import torch_threads  # noqa: F401  (one CPU thread: see the module)

UNLIMITED = dict(rate_limit_per_minute=10 ** 6, rate_limit_per_hour=10 ** 6,
                 rate_limit_per_day=10 ** 6,
                 rate_limit_anonymous_daily=10 ** 6,
                 max_concurrent_requests=64)
CONT = dict(batching_mode="continuous", num_slots=8, segment_steps=4)


@pytest.fixture(scope="module")
def artifact(tmp_path_factory):
    return h.save_artifact(str(tmp_path_factory.mktemp("app") / "model"))


def _burst(port, images):
    with ThreadPoolExecutor(len(images)) as ex:
        return list(ex.map(lambda im: h.post_json(
            port, "/predict", {"image_data": h.b64(im)}), images))


@pytest.mark.parametrize("fused", [False, True])
def test_continuous_mode_on_a_mesh(artifact, fused):
    """12 concurrent requests through an 8-slot pool sharded over 4
    shards, equal to the unsharded app; ``/metrics`` shows the mesh."""
    images = [h.png_bytes((96, 320) if i % 2 else (50, 120), 30 + i)
              for i in range(12)]
    kw = dict(model_dir=artifact, use_fused_decode=fused,
              pallas_encoder_block=fused, **CONT, **UNLIMITED)
    servers = [h.PortServer(h.port_config(**kw)),
               h.PortServer(h.port_config(mesh_data_axis=4, **kw))]
    try:
        want, got = (_burst(s.port, images) for s in servers)
        for w, g in zip(want, got):
            assert w.status == g.status == 200
            h.same_prediction(w.json(), g.json())
        plain, meshed = (h.call(s.port, "GET", "/metrics").json()["batching"]
                         for s in servers)
        assert plain["mesh"] is None
        assert meshed["mesh"] == {"data": 4, "tensor": 1}
        assert meshed["segments_run"] >= 1
        assert len(servers[1].state.batcher.decoder._shards) == 4
    finally:
        h.stop_all(*servers)


def test_device_admission_on_a_mesh_falls_back_to_host(artifact, caplog):
    with caplog.at_level(logging.WARNING):
        s = h.PortServer(h.port_config(model_dir=artifact, mesh_data_axis=2,
                                       admission="device", **CONT,
                                       **UNLIMITED))
    try:
        dec = s.state.batcher.decoder
        assert dec.admission == "host" and dec.stats["mesh"] == {
            "data": 2, "tensor": 1}
        assert any("host admission" in r.getMessage()
                   for r in caplog.records)
        r = h.post_json(s.port, "/predict", {"image_data": h.b64(
            h.png_bytes())})
        assert r.status == 200
    finally:
        s.stop()


@pytest.mark.parametrize("cards", [1, 4])
def test_mesh_on_cards(artifact, monkeypatch, caplog, cards):
    """On a machine with cards, ``SERVING_MESH_DATA=2`` builds a mesh of
    the first two CUDA devices, or warns and serves unsharded with one
    card, as JAX's app does with too few devices."""
    from handwritten_math_ocr_api_torch.serve.app import ServerState

    state = ServerState(h.port_config(model_dir=artifact, mesh_data_axis=2,
                                      **CONT), device="cpu")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    with caplog.at_level(logging.WARNING):
        mesh = state._serving_mesh(torch.device("cuda"))
    if cards == 1:
        assert mesh is None
        assert any("running unsharded" in r.getMessage()
                   for r in caplog.records)
    else:
        assert mesh.shape == {"data": 2, "tensor": 1}
        assert mesh.data_devices == [torch.device("cuda", 0),
                                     torch.device("cuda", 1)]
