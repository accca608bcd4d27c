"""Device admission (``ContinuousDecoder(admission="device")``) of the port
against the JAX package's, and the mailbox pull (``ops/admission.py``).

JAX's five cases of ``tests/test_device_admission.py`` run on the port, on
``tests/test_torch_resnet.py``'s resnet18 model (float32, 32x64 images,
T 12, the end-of-sequence bias raised so that rows end at different steps):
device admission equals host admission, requests staged while segments run
are pulled, constrained decoding composes with the pull, a cancelled staged
entry does not corrupt the slot's next occupant, and bad options are
refused. Beside them: the port's device-admission strings equal JAX's
device-admission decoder's and the port's host admission (float32,
exactly), with confidences within JAX's 5e-3 of JAX's (the staging encodes
one image at a time, the host insert a bucket); constrained decoding
against JAX's; a staging that raises, then ``fail_reset`` and requests
served; cancelled entries freeing their pool rows while no slot is live;
the app building a device decoder; ``use_fused``'s warning; and the pull's
protocol on the plain install (sequence order, one entry a
step, cancelled entries skipped, the record, the ring's reuse, the
occupant's guard). On the CPU the pull is the plain install; the kernel's
cases are in ``tests/test_torch_kernels_cuda.py``.
"""

import logging

import numpy as np
import pytest
import torch

from handwritten_math_ocr_api_tpu.core.tokenizer import Tokenizer as JTokenizer
from handwritten_math_ocr_api_tpu.decode import continuous as jcont

from handwritten_math_ocr_api_torch.core.config import SOS_ID
from handwritten_math_ocr_api_torch.core.tokenizer import Tokenizer
from handwritten_math_ocr_api_torch.decode import continuous as tcont
from handwritten_math_ocr_api_torch.ops import admission as adm

from test_torch_constrain import VOCAB as CVOCAB
from test_torch_resnet import VOCAB, _images, _j, _model, jax_config
import torch_threads  # noqa: F401  (one CPU thread: see the module)

JAX_CONF_TOL = 5e-3  # JAX's own bound between its two admissions
CONF_TOL = 1e-4      # the port's two admissions: float32 sums in one order
KW = dict(num_slots=2, segment_steps=6, encode_buckets=(1, 2))


@pytest.fixture(scope="module")
def setup():
    cfg, params, state = _model("resnet18", seed=5, boost=True)
    return params, state, cfg, _images(5, 7)


def _dev(setup, vocab=VOCAB, **kw):
    params, state, cfg, _ = setup
    return tcont.ContinuousDecoder(params, cfg, Tokenizer(vocab),
                                   model_state=state, device="cpu",
                                   **{**KW, **kw})


def _run(engine, imgs, max_ticks=300):
    rids = [engine.submit(im) for im in imgs]
    results = {}
    for _ in range(max_ticks):
        results.update(engine.step_once())
        if len(results) == len(rids):
            break
    assert len(results) == len(rids), (len(results), len(rids))
    return [results[r] for r in rids]


@pytest.fixture(scope="module")
def host_results(setup):
    """The port's host admission of the five images."""
    dec = _dev(setup)
    out = _run(dec, setup[3])
    dec.close()
    return out


# -- JAX's five cases ------------------------------------------------------------


def test_device_equals_host(setup, host_results):
    dev = _dev(setup, admission="device")
    got = _run(dev, setup[3])
    for (la, ca), (lb, cb) in zip(host_results, got):
        assert la == lb
        assert abs(ca - cb) < CONF_TOL
    assert dev.idle and dev.stats["staged"] == 0
    dev.close()


def test_device_admission_mid_segment(setup):
    """Requests submitted while a segment is in flight are staged and
    pulled: the staged entries drain, and every pull's record names a real
    segment, in staging order."""
    dev = _dev(setup, admission="device")
    imgs = setup[3]
    r0 = dev.submit(imgs[0])
    out = dict(dev.step_once())
    r1 = dev.submit(imgs[1])
    r2 = dev.submit(imgs[2])
    for _ in range(300):
        out.update(dev.step_once())
        if len(out) == 3:
            break
    assert set(out) == {r0, r1, r2}
    assert not dev._staged
    assert all(v != tcont._NOT_PULLED for v in dev._admit_seg.values())
    assert all(isinstance(latex, str) for latex, _ in out.values())
    records = [dev._mailbox.taken(seq) for seq in (1, 2, 3)]
    assert all(r is not None for r in records)
    assert [r[0] for r in records] == sorted(r[0] for r in records)
    dev.close()


def test_device_constrained(setup):
    """Constrained decoding composes with the pull (the con_* rows reset
    by it): device equals host, and JAX's device admission."""
    params, state, cfg, imgs = setup
    cfg = cfg.replace(vocab_size=len(CVOCAB))
    params = _model("resnet18", seed=6, boost=True,
                    vocab_size=len(CVOCAB))[1]
    kw = dict(KW, constrained=True)
    host = tcont.ContinuousDecoder(params, cfg, Tokenizer(CVOCAB),
                                   model_state=state, device="cpu", **kw)
    dev = tcont.ContinuousDecoder(params, cfg, Tokenizer(CVOCAB),
                                  model_state=state, device="cpu",
                                  admission="device", **kw)
    a = _run(host, imgs[:3])
    b = _run(dev, imgs[:3])
    assert [x[0] for x in a] == [x[0] for x in b]
    jdev = jcont.ContinuousDecoder(_j(params), _j(state), jax_config(cfg),
                                   JTokenizer(CVOCAB), admission="device",
                                   **kw)
    assert [x[0] for x in _run(jdev, imgs[:3])] == [x[0] for x in b]
    jdev.close()


def test_device_cancel_staged(setup, host_results):
    """Cancelling a staged, unpulled request does not corrupt a later
    occupant of the same slot: its entry is skipped at pull time."""
    dev = _dev(setup, admission="device", num_slots=1, encode_buckets=(1,))
    imgs = setup[3]
    r0 = dev.submit(imgs[0])
    dev._admit()  # stage r0 (slot 0) without dispatching
    assert dev.cancel(r0)
    r1 = dev.submit(imgs[1])
    results = {}
    for _ in range(200):
        results.update(dev.step_once())
        if r1 in results:
            break
    assert r1 in results and r0 not in results
    assert results[r1][0] == host_results[1][0]
    assert dev._mailbox.consumed(1) and dev._mailbox.taken(1) is None
    assert dev._mailbox.taken(2) is not None
    dev.close()


def test_device_rejects_bad_combos(setup):
    params, state, cfg, _ = setup
    with pytest.raises(ValueError):
        tcont.ContinuousDecoder(params, cfg, Tokenizer(VOCAB),
                                model_state=state, device="cpu",
                                num_slots=2, admission="bogus")
    with pytest.raises(ValueError, match="sharded slot pool"):
        tcont.ContinuousDecoder(params, cfg, Tokenizer(VOCAB),
                                model_state=state, device="cpu",
                                num_slots=2, admission="device",
                                mesh=object())


# -- against JAX's device admission ------------------------------------------------


def test_device_matches_jax_device_and_host(setup, host_results):
    """Five images through 2 slots with requests trickling in: the port's
    device admission equals JAX's device admission (strings exactly,
    confidences within JAX's 5e-3) and the port's host admission."""
    params, state, cfg, imgs = setup
    jdev = jcont.ContinuousDecoder(_j(params), _j(state), jax_config(cfg),
                                   JTokenizer(VOCAB), admission="device",
                                   **KW)
    want = _run(jdev, imgs)
    jdev.close()
    dev = _dev(setup, admission="device")
    ids = [dev.submit(imgs[0])]
    results = dict(dev.step_once())
    for img in imgs[1:]:
        ids.append(dev.submit(img))
        results.update(dev.step_once())
    while not dev.idle:
        results.update(dev.step_once())
    got = [results[i] for i in ids]
    for (gl, gc), (wl, wc), (hl, hc) in zip(got, want, host_results):
        assert gl == wl == hl
        assert abs(gc - wc) < JAX_CONF_TOL
        assert abs(gc - hc) < CONF_TOL
    st = dev.stats
    assert st["staged"] == 0 and st["cancelled"] == 0
    assert sorted(dev._free) == [0, 1]
    dev.close()


def test_cancel_pulled_and_fail_reset(setup, host_results):
    """Two requests staged in one tick are pulled at steps 0 and 1 of the
    next segment; a pulled request's cancel deactivates its slot (its
    occupant is the cancelled entry); ``fail_reset`` marks the staged
    entries skipped; the decoder then serves as before."""
    dev = _dev(setup, admission="device")
    imgs = setup[3]
    r0 = dev.submit(imgs[0])
    dev.submit(imgs[1])
    dev.step_once()   # both staged, then pulled by segment 1
    assert dev._mailbox.taken(1) == (1, 0)
    assert dev._mailbox.taken(2) == (1, 1)
    assert dev._occupant[0] == 1 and bool(dev._shards[0].small.active[0])
    assert dev.cancel(r0) and not bool(dev._shards[0].small.active[0])
    assert bool(dev._shards[0].small.active[1])
    dev.submit(imgs[2])
    dev._admit()      # staged into slot 0, not pulled
    dev.fail_reset()
    while not dev.idle:
        dev.step_once()
    assert not dev._mailbox.consumed(3)   # no segment ran since
    assert dev.run_all(list(imgs[3:])) == [
        (la, pytest.approx(ca, abs=CONF_TOL)) for la, ca in host_results[3:]]
    assert dev._mailbox.taken(3) is None and dev._mailbox.consumed(3)
    dev.close()


def test_staging_failure_then_fail_reset_serves(setup, host_results):
    """A staging that raises (an out-of-memory encode, say) reserves no
    sequence number: after the serving worker's ``fail_reset`` the next
    requests are staged, pulled and decoded as by host admission."""
    dev = _dev(setup, admission="device")
    imgs = setup[3]
    stage = dev._stage

    def fail_once(img, row):
        dev._stage = stage
        raise RuntimeError("staging failed")

    dev._stage = fail_once
    dev.submit(imgs[0])
    with pytest.raises(RuntimeError, match="staging failed"):
        dev.step_once()
    assert dev._mailbox.next_seq == 1 and not dev._pool_busy
    dev.fail_reset()
    assert dev.run_all(list(imgs[:2])) == [
        (la, pytest.approx(ca, abs=CONF_TOL)) for la, ca in host_results[:2]]
    assert [dev._mailbox.taken(s) is not None for s in (1, 2)] == [True] * 2
    assert sorted(dev._pool_free) == list(range(2 * dev.num_slots))
    dev.close()


def test_cancelled_entries_free_their_rows(setup, host_results):
    """Staged entries cancelled before any pull reached them hold no pool
    row once no segment is in flight: with every row of a one-slot pool
    held so and no slot live, a new request is still staged and decoded,
    and the next pull skips the cancelled entries in order."""
    dev = _dev(setup, admission="device", num_slots=1, encode_buckets=(1,))
    imgs = setup[3]
    for img in imgs[:2]:
        rid = dev.submit(img)
        dev._admit()   # staged, not dispatched
        assert dev.cancel(rid)
    assert dev._mailbox.next_seq == 3 and not dev._slot_req
    assert _run(dev, imgs[2:3])[0][0] == host_results[2][0]
    assert [dev._mailbox.consumed(s) for s in (1, 2, 3)] == [True] * 3
    assert dev._mailbox.taken(1) is None and dev._mailbox.taken(2) is None
    assert dev._mailbox.taken(3) is not None
    dev.close()


def test_use_fused_with_device_admission_warns(setup, caplog):
    """As JAX: a warning, and the default segment route."""
    with caplog.at_level(logging.WARNING):
        dev = _dev(setup, admission="device", use_fused=True)
    assert any("device admission" in r.getMessage() for r in caplog.records)
    assert not dev.use_fused and dev.admission == "device"
    dev.warmup()   # stages into a free pool row, pulls nothing
    assert dev._mailbox.next_seq == 1 and int(dev._mailbox.cursor) == 0
    assert len(dev._pool_free) == 2 * dev.num_slots
    dev.close()


def test_app_builds_a_device_decoder(tmp_path):
    """``SERVING_ADMISSION=device``: the app's continuous engine is a
    device-admission decoder, and it serves."""
    import torch_app_harness as h

    artifact = h.save_artifact(str(tmp_path / "model"))
    port = h.PortServer(h.port_config(
        model_dir=artifact, batching_mode="continuous", num_slots=2,
        segment_steps=3, admission="device", rate_limit_per_minute=10 ** 6,
        rate_limit_per_hour=10 ** 6, rate_limit_per_day=10 ** 6,
        rate_limit_anonymous_daily=10 ** 6))
    try:
        decoder = port.state.batcher.decoder
        assert decoder.admission == "device" and not decoder.use_fused
        r = h.post_json(port.port, "/predict",
                        {"image_data": h.b64(h.png_bytes())})
        assert r.status == 200 and "formula" in r.json()
        assert decoder.stats["pulled_early"] >= 0
        assert decoder._mailbox.next_seq == 2
    finally:
        port.stop()


# -- the pull's protocol on the plain install -------------------------------------


def _pull_fixture(S=4, T=5, P=3, con=False, capacity=4):
    L, row = 2, (2, 3, 4)
    mb = adm.Mailbox(capacity, "cpu")
    pool = tuple(torch.arange(P * L * 24, dtype=torch.float32).reshape(
        (P, L) + row) + 1000 * k for k in range(2))
    cross = tuple(torch.full((L, S) + row, -1.0) for _ in range(2))
    i32 = torch.int32
    state = adm.PullState(
        prev=torch.full((S,), 9, dtype=i32), pos=torch.full((S,), 3,
                                                            dtype=i32),
        active=torch.zeros(S, dtype=torch.bool),
        finished=torch.ones(S, dtype=torch.bool),
        tokens=torch.full((S, T), 7, dtype=i32),
        lp_sum=torch.full((S,), -2.0), count=torch.full((S,), 3, dtype=i32),
        con=((torch.ones((S, 6), dtype=i32), torch.ones(S, dtype=i32),
              torch.ones(S, dtype=i32), torch.ones(S, dtype=torch.bool),
              torch.ones(S, dtype=torch.bool)) if con else None),
        occupant=torch.zeros(S, dtype=torch.int64))
    return mb, pool, cross, state


@pytest.mark.parametrize("con", [False, True])
def test_pull_plain_protocol(con):
    mb, pool, cross, state = _pull_fixture(con=con)
    pull = lambda step, **kw: adm.admission_pull(  # noqa: E731
        mb, *pool, *cross, state, seg=7, step=step, **kw)
    assert pull(0) is None and int(mb.cursor) == 0     # nothing published
    s1, s2, s3 = mb.reserve(), mb.reserve(), mb.reserve()
    assert (s1, s2, s3) == (1, 2, 3)
    mb.publish(s2, 2, 3)     # out of order: the pull waits for seq 1
    assert adm.admission_pull_plain(mb, *pool, *cross, state, 7, 0) is None
    mb.publish(s1, 0, 1)
    mb.cancel(s1)            # cancelled after its publication
    mb.publish(s3, 1, 1)
    assert adm.admission_pull_plain(mb, *pool, *cross, state, 7, 1) == 2
    assert mb.consumed(1) and mb.taken(1) is None      # skipped
    assert mb.taken(2) == (7, 1) and not mb.consumed(3)  # one a step
    for k in range(2):
        assert torch.equal(cross[k][:, 3], pool[k][2])
        assert (cross[k][:, :3] == -1).all()
    assert int(state.prev[3]) == SOS_ID and int(state.pos[3]) == 0
    assert bool(state.active[3]) and not bool(state.finished[3])
    assert (state.tokens[3] == 0).all() and (state.tokens[:3] == 7).all()
    assert float(state.lp_sum[3]) == 0 and int(state.count[3]) == 0
    assert int(state.occupant[3]) == 2
    if con:
        for t in state.con:
            assert not t[3].any() and t[0].all()
    assert adm.admission_pull_plain(mb, *pool, *cross, state, 8, 0) == 3
    assert mb.taken(3) == (8, 0) and int(state.occupant[1]) == 3
    assert int(mb.cursor) == 3


def test_mailbox_ring_reuse_and_scan():
    """A ring entry is reused only once consumed; ``max_scan`` bounds the
    entries a pull looks at (0: none)."""
    mb, pool, cross, state = _pull_fixture(capacity=2)
    s1, s2 = mb.reserve(), mb.reserve()
    assert mb.reserve() is None            # entry of seq 1 not consumed
    mb.publish(s1, 0, 0)
    mb.publish(s2, 1, 1)
    assert adm.admission_pull_plain(mb, *pool, *cross, state, 1, 0,
                                    max_scan=0) is None
    assert adm.admission_pull_plain(mb, *pool, *cross, state, 1, 0) == 1
    assert mb.reserve() == 3 and mb.reserve() is None
    mb.cancel(s2)
    mb.publish(3, 2, 2)
    assert adm.admission_pull_plain(mb, *pool, *cross, state, 1, 1) == 3
    assert mb.taken(2) is None and mb.consumed(2)
