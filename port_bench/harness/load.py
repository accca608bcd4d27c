"""Drives a closed plan of requests against an entry's ``send`` over the
window.

``send(images) -> [(latex, confidence)]`` is the entry's call into the
system (one awaited request). Each client of the plan sends its next request
when its last one is answered, from the window's start to its end. After
the window, every request due in it is awaited, a minute at most."""

from __future__ import annotations

import asyncio
import time
from typing import Awaitable, Callable, List

from .run_state import Request, Run

GRACE_S = 60.0


async def _one(req: Request, send) -> None:
    req.sent = time.perf_counter()
    try:
        answers = list(await send(req.images))
        req.texts = [latex for latex, _ in answers]
        req.confs = [conf for _, conf in answers]
    except Exception as e:  # the system refused or failed it: a miss
        req.error = f"{type(e).__name__}: {e}"
    req.done = time.perf_counter()


async def drive(run: Run, plan: dict,
                send: Callable[[List[int]], Awaitable[list]],
                on_window_end: Callable[[], None] = lambda: None) -> None:
    loop = asyncio.get_running_loop()
    run.t0 = time.perf_counter()

    async def client(groups):
        for images in groups:
            if time.perf_counter() >= run.t1:
                return
            req = Request(list(images), due=time.perf_counter())
            run.requests.append(req)
            await _one(req, send)

    tasks = [loop.create_task(client(g)) for g in plan["clients"]]
    await asyncio.sleep(max(0.0, run.t1 - time.perf_counter()))
    on_window_end()
    await asyncio.wait(tasks, timeout=GRACE_S)
