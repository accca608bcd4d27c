"""The traffic generator and the load driver: schedules repeat for a seed,
and the closed loop records failures and stops at the window's end."""

import asyncio

import pb_tiny  # noqa: F401  (puts the benchmark on sys.path)

from harness import manifest
from harness.load import drive
from harness.run_state import Run

BIG_SEED = 2 ** 31 + 987654321


def test_closed_repeats_for_a_seed():
    gen = manifest.load_module("generators", "closed")
    t = {"clients": 3, "images_per_request": 10}
    a = gen.plan(t, BIG_SEED, 2000, 5.0)
    assert a == gen.plan(t, BIG_SEED, 2000, 5.0)
    assert len(a["clients"]) == 3
    assert all(len(g) == 10 for g in a["clients"][0][:5])
    assert a["clients"][0] != a["clients"][1]


def _run(seconds):
    return Run("t", {"model": {}}, {}, 1, seconds, False)


def test_failed_requests_are_recorded():
    async def send(images):
        raise RuntimeError("refused")

    plan = {"clients": [[[0]] * 3, [[1]] * 3]}
    run = _run(0.05)
    asyncio.run(drive(run, plan, send))
    assert len(run.requests) == 6
    assert not any(r.ok for r in run.requests)
    assert all("refused" in r.error for r in run.requests)


def test_closed_loop_stops_at_the_window():
    calls = []

    async def send(images):
        calls.append(images)
        await asyncio.sleep(0.01)
        return [("x", 1.0)] * len(images)

    plan = {"clients": [[[0, 1]] * 1000, [[2, 3]] * 1000]}
    run = _run(0.1)
    asyncio.run(drive(run, plan, send))
    assert 6 <= len(calls) <= 40
    assert all(r.sent < run.t1 for r in run.requests)
