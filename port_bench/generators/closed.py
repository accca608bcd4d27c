"""Closed-loop clients: each sends its next request when the previous one
has been answered. Traffic parameters: ``clients``, ``images_per_request``.
Each client's images are drawn from the seed, uniformly over the split."""

from __future__ import annotations

import numpy as np

# requests drawn ahead a client; a window of 51 s at 2,000 images/s needs
# under 700 a client at 16 clients of 10 images
PLAN_REQUESTS = 4096


def plan(traffic: dict, seed: int, n_images: int, seconds: float) -> dict:
    clients = int(traffic["clients"])
    per = int(traffic["images_per_request"])
    return {"clients": [np.random.default_rng([int(seed), c]).integers(
        0, n_images, size=(PLAN_REQUESTS, per)).tolist()
        for c in range(clients)]}
