"""Async rate limiting: fixed windows, burst auto-block, concurrency caps.

The port of ``handwritten_math_ocr_api_tpu/serve/rate_limiter.py``, on
asyncio and hashlib only (``redis`` is imported inside ``make_storage``
when a URL is configured): per-minute/hour/day fixed windows keyed
``{client}:{window}:{t//window}``, 3x limits for authenticated clients, an
anonymous daily cap, abuse auto-block, Redis storage with an in-memory
fallback, per-client concurrent request caps, and the same ``client_id``
for the same IP, User-Agent and key. Decisions are plain dicts that the
HTTP layer renders. The in-memory storage and the concurrency map mutate
on the event loop only.
"""

from __future__ import annotations

import dataclasses
import hashlib
import logging
import time
from typing import Dict, Optional, Tuple

logger = logging.getLogger(__name__)


@dataclasses.dataclass
class RateLimitConfig:
    """Defaults match the reference deployment (app/src/main.py:120-126,
    app/src/rate_limiter.py:24-36)."""

    requests_per_minute: int = 20
    requests_per_hour: int = 200
    requests_per_day: int = 1000
    concurrent_requests: int = 10
    burst_threshold: int = 50
    block_duration: int = 3600
    authenticated_multiplier: float = 3.0
    anonymous_daily_limit: int = 100


class InMemoryStorage:
    """Dict-backed counters with TTL emulation (the reference's Redis
    fallback: app/src/rate_limiter.py:86-132)."""

    def __init__(self):
        self._counts: Dict[str, Tuple[int, float]] = {}  # key -> (count, expiry)
        self._blocks: Dict[str, float] = {}

    async def increment(self, key: str, ttl: int) -> int:
        now = time.time()
        count, expiry = self._counts.get(key, (0, now + ttl))
        if expiry <= now:
            count, expiry = 0, now + ttl
        count += 1
        self._counts[key] = (count, expiry)
        return count

    async def get_count(self, key: str) -> int:
        count, expiry = self._counts.get(key, (0, 0.0))
        return count if expiry > time.time() else 0

    async def set_block(self, client_id: str, duration: int) -> None:
        self._blocks[client_id] = time.time() + duration

    async def is_blocked(self, client_id: str) -> bool:
        until = self._blocks.get(client_id)
        if until is None:
            return False
        if until <= time.time():
            del self._blocks[client_id]
            return False
        return True

    def cleanup(self) -> None:
        now = time.time()
        self._counts = {k: v for k, v in self._counts.items() if v[1] > now}
        self._blocks = {k: v for k, v in self._blocks.items() if v > now}


class RedisStorage:
    """Redis INCR+EXPIRE counters (reference: app/src/rate_limiter.py:56-84).
    Fails open to defaults on errors."""

    def __init__(self, redis_client):
        self.redis = redis_client

    async def increment(self, key: str, ttl: int) -> int:
        try:
            pipe = self.redis.pipeline()
            pipe.incr(key)
            pipe.expire(key, ttl)
            count, _ = await pipe.execute()
            return int(count)
        except Exception as e:  # fail open
            logger.error("redis increment failed: %s", e)
            return 0

    async def get_count(self, key: str) -> int:
        try:
            v = await self.redis.get(key)
            return int(v) if v else 0
        except Exception as e:
            logger.error("redis get failed: %s", e)
            return 0

    async def set_block(self, client_id: str, duration: int) -> None:
        try:
            await self.redis.setex(f"blocked:{client_id}", duration, "1")
        except Exception as e:
            logger.error("redis set_block failed: %s", e)

    async def is_blocked(self, client_id: str) -> bool:
        try:
            return bool(await self.redis.get(f"blocked:{client_id}"))
        except Exception as e:
            logger.error("redis is_blocked failed: %s", e)
            return False


def make_storage(redis_url: str = ""):
    """Redis if configured AND importable, else in-memory
    (reference fallback behavior: app/src/rate_limiter.py:44-55)."""
    if redis_url:
        try:
            import redis.asyncio as aioredis

            client = aioredis.from_url(redis_url)
            logger.info("rate limiter using redis at %s", redis_url)
            return RedisStorage(client)
        except ImportError:
            logger.warning("redis package unavailable; using in-memory "
                           "rate-limit storage")
        except Exception as e:
            logger.warning("redis connection failed (%s); using in-memory "
                           "storage", e)
    return InMemoryStorage()


WINDOWS = (("minute", 60), ("hour", 3600), ("day", 86400))


class RateLimiter:
    def __init__(self, config: Optional[RateLimitConfig] = None,
                 redis_url: str = ""):
        self.config = config or RateLimitConfig()
        self.storage = make_storage(redis_url)
        self.active_requests: Dict[str, int] = {}
        self._checks_since_cleanup = 0

    # -- identity -----------------------------------------------------------

    def get_client_id(self, remote_ip: str, user_agent: str,
                      user_data: Optional[dict] = None) -> Tuple[str, bool]:
        """service:<uid> for authenticated internal calls, else
        ip:<md5(ip:user-agent)> (reference: app/src/rate_limiter.py:153-166)."""
        if user_data and user_data.get("uid") == "internal_service" \
                and user_data.get("isAnonymous") is False:
            return f"service:{user_data['uid']}", True
        if user_data and user_data.get("is_authenticated"):
            return f"service:{user_data.get('uid', 'authenticated_user')}", True
        client_hash = hashlib.md5(
            f"{remote_ip}:{user_agent}".encode()).hexdigest()
        return f"ip:{client_hash}", False

    def get_rate_limits(self, is_authenticated: bool) -> Dict[str, int]:
        base = {
            "requests_per_minute": self.config.requests_per_minute,
            "requests_per_hour": self.config.requests_per_hour,
            "requests_per_day": self.config.requests_per_day,
        }
        if is_authenticated:
            return {k: int(v * self.config.authenticated_multiplier)
                    for k, v in base.items()}
        base["requests_per_day"] = min(base["requests_per_day"],
                                       self.config.anonymous_daily_limit)
        return base

    # -- decision ----------------------------------------------------------

    async def check_rate_limit(self, client_id: str, is_authenticated: bool
                               ) -> Optional[Dict]:
        """None if allowed; a 429-payload dict otherwise
        (shape: app/src/rate_limiter.py:196-242)."""
        # periodic expired-entry sweep for the in-memory store (the
        # reference ran a background cleanup task: app/src/rate_limiter.py:141)
        self._checks_since_cleanup += 1
        if self._checks_since_cleanup >= 1000 and \
                isinstance(self.storage, InMemoryStorage):
            self.storage.cleanup()
            self._checks_since_cleanup = 0
        if await self.storage.is_blocked(client_id):
            return {
                "status": 429,
                "error": "Rate limit exceeded",
                "detail": "Client is temporarily blocked due to excessive "
                          "requests",
                "retry_after": self.config.block_duration,
            }
        limits = self.get_rate_limits(is_authenticated)
        now = int(time.time())
        checks = [
            (f"{client_id}:minute:{now // 60}",
             limits["requests_per_minute"], 60),
            (f"{client_id}:hour:{now // 3600}",
             limits["requests_per_hour"], 3600),
            (f"{client_id}:day:{now // 86400}",
             limits["requests_per_day"], 86400),
        ]
        for key, limit, ttl in checks:
            count = await self.storage.increment(key, ttl)
            if count > limit:
                burst_cut = (limit * self.config.burst_threshold
                             / max(self.config.requests_per_minute, 1))
                if count > burst_cut:
                    await self.storage.set_block(
                        client_id, self.config.block_duration)
                    logger.warning("client blocked for abuse: %s (%d/%d)",
                                   client_id, count, limit)
                retry_after = ttl - (now % ttl)
                return {
                    "status": 429,
                    "error": "Rate limit exceeded",
                    "detail": f"Too many requests. Limit: {limit} per "
                              f"{ttl // 60} minutes",
                    "retry_after": retry_after,
                    "limit": limit,
                    "remaining": max(0, limit - count),
                    "reset": now + retry_after,
                }
        return None

    async def usage(self, client_id: str) -> Dict[str, int]:
        now = int(time.time())
        return {
            name: await self.storage.get_count(
                f"{client_id}:{name}:{now // secs}")
            for name, secs in WINDOWS
        }

    # -- concurrency -------------------------------------------------------

    def try_acquire(self, client_id: str) -> bool:
        n = self.active_requests.get(client_id, 0)
        if n >= self.config.concurrent_requests:
            return False
        self.active_requests[client_id] = n + 1
        return True

    def release(self, client_id: str) -> None:
        n = self.active_requests.get(client_id, 0) - 1
        if n <= 0:
            self.active_requests.pop(client_id, None)
        else:
            self.active_requests[client_id] = n


class ConcurrentRequestTracker:
    """Async context manager enforcing the per-client concurrency cap
    (reference: app/src/rate_limiter.py:331-347). Raises
    ``ConcurrencyLimitExceeded`` instead of an HTTP exception — the HTTP
    layer maps it to 429."""

    def __init__(self, limiter: RateLimiter, client_id: str):
        self.limiter = limiter
        self.client_id = client_id
        self._acquired = False

    async def __aenter__(self):
        if not self.limiter.try_acquire(self.client_id):
            raise ConcurrencyLimitExceeded(
                f"Too many concurrent requests. Maximum "
                f"{self.limiter.config.concurrent_requests} allowed.")
        self._acquired = True
        return self

    async def __aexit__(self, *exc):
        if self._acquired:
            self.limiter.release(self.client_id)
        return False


class ConcurrencyLimitExceeded(Exception):
    pass


# module singleton (reference: app/src/rate_limiter.py:264-291)
_rate_limiter: Optional[RateLimiter] = None


def init_rate_limiter(redis_url: str = "",
                      config: Optional[RateLimitConfig] = None) -> RateLimiter:
    global _rate_limiter
    _rate_limiter = RateLimiter(config, redis_url)
    return _rate_limiter


def get_rate_limiter() -> RateLimiter:
    if _rate_limiter is None:
        raise RuntimeError("rate limiter not initialized")
    return _rate_limiter
