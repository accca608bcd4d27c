"""A small HTTP/1.1 server on asyncio streams, with the part of aiohttp's
surface that the serving app uses.

The JAX package's app runs on aiohttp; the port's runs on the standard
library alone, so that it serves wherever PyTorch does. The names follow
aiohttp's (``Application``, ``Request``, ``Response``, ``json_response``,
``StreamResponse``, ``HTTPException``), so that each handler of
``serve/app.py`` reads as JAX's does:

- ``Application(middlewares=[...], client_max_size=N)``: a router
  (``router.add_get`` / ``add_post``; a GET route also answers HEAD),
  ``on_startup`` and ``on_cleanup`` hooks, item storage (``app["state"]``)
  and ``stop()``, which ends ``run_app`` / ``ServerThread`` gracefully.
  Middlewares are ``async def mw(request, handler)``, the first one
  outermost, around every request: an unknown path reaches them as a
  handler that raises ``HTTPNotFound``, a known path with another method
  as one that raises ``HTTPMethodNotAllowed``, as aiohttp's router does.
- ``Request``: ``method``, ``path``, ``query`` (a dict, the first value of
  each name), case-insensitive ``headers``, ``remote`` (the peer's IP),
  ``content_type``, ``app``, ``await read()`` / ``text()`` / ``json()``,
  ``await post()`` (``multipart/form-data``, parsed with the ``email``
  package, each file a ``FileField`` with ``filename`` and ``file``), and
  item storage (``request["request_id"]``).
- ``Response(text= | body=, status=, content_type=)``, ``json_response``
  (``application/json; charset=utf-8``), and ``StreamResponse``:
  ``prepare``, ``write`` (one chunk, flushed) and ``write_eof``, with
  ``Transfer-Encoding: chunked``.

The transport: request bodies by ``Content-Length`` or chunked (an
``Expect: 100-continue`` is answered), read whole before the middlewares
run; a body over ``client_max_size`` gets 413 as aiohttp's does;
connections are kept alive (HTTP/1.1, or 1.0 with ``keep-alive``) and
closed after 75 s idle. While a handler runs, the connection is watched:
when the client disconnects, the handler's task is cancelled (aiohttp's
``handler_cancellation=True``), which cancels what it awaits, such as a
continuous engine's future, whose slot is then freed.

``serve(app, host, port)`` runs the startup hooks, listens, and returns the
bound port (port 0 picks a free one); ``shutdown(app)`` closes the
listener, lets the handlers in flight finish, closes the connections and
runs the cleanup hooks. ``run_app`` serves until ``app.stop()`` or SIGINT /
SIGTERM; ``ServerThread`` serves from a thread of its own.
"""

from __future__ import annotations

import asyncio
import email.parser
import functools
import io
import json
import logging
import signal
import sys
import threading
import urllib.parse
from collections.abc import MutableMapping
from email.utils import formatdate
from http import HTTPStatus
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

logger = logging.getLogger(__name__)

KEEPALIVE_S = 75.0        # an idle connection's life, as aiohttp's default
MAX_HEAD_BYTES = 64 * 1024
SHUTDOWN_GRACE_S = 60.0   # handlers in flight at shutdown, as aiohttp's
DRAIN_413_BYTES = 64 * 1024 * 1024  # an oversized body read past, not kept
SERVER_NAME = (f"Python/{sys.version_info[0]}.{sys.version_info[1]} "
               "handwritten_math_ocr_api_torch")


class CIMultiDict(MutableMapping):
    """A case-insensitive dict of header names (one value each), keeping
    the case a name was set with."""

    def __init__(self, items=()):
        self._d: Dict[str, Tuple[str, str]] = {}
        for k, v in (items.items() if hasattr(items, "items") else items):
            self[k] = v

    def __getitem__(self, key: str) -> str:
        return self._d[key.lower()][1]

    def __setitem__(self, key: str, value: str) -> None:
        self._d[key.lower()] = (key, value)

    def __delitem__(self, key: str) -> None:
        del self._d[key.lower()]

    def __iter__(self) -> Iterator[str]:
        return (k for k, _ in self._d.values())

    def __len__(self) -> int:
        return len(self._d)

    def __contains__(self, key) -> bool:
        return isinstance(key, str) and key.lower() in self._d


# ---------------------------------------------------------------------------
# Exceptions and responses
# ---------------------------------------------------------------------------

class HTTPException(Exception):
    """An HTTP error response raised from a handler or the router,
    rendered as aiohttp renders it: text ``"<status>: <reason>"`` unless
    another text is given."""

    status = 500

    def __init__(self, text: Optional[str] = None,
                 headers: Optional[Dict[str, str]] = None):
        reason = HTTPStatus(self.status).phrase
        self.text = text if text is not None else f"{self.status}: {reason}"
        self.headers = dict(headers or {})
        super().__init__(self.text)

    def response(self) -> "Response":
        return Response(text=self.text, status=self.status,
                        headers=self.headers)


class HTTPBadRequest(HTTPException):
    status = 400


class HTTPNotFound(HTTPException):
    status = 404


class HTTPMethodNotAllowed(HTTPException):
    status = 405

    def __init__(self, method: str, allowed):
        super().__init__(headers={"Allow": ",".join(sorted(allowed))})
        self.method = method


class HTTPRequestEntityTooLarge(HTTPException):
    status = 413

    def __init__(self, max_size: int, actual_size: int):
        super().__init__(f"Maximum request body size {max_size} exceeded, "
                         f"actual body size {actual_size}")


class Response:
    """A whole response: ``text`` (encoded in ``charset``, utf-8 by
    default; content type text/plain unless given) or ``body`` bytes."""

    def __init__(self, *, body: Optional[bytes] = None, status: int = 200,
                 text: Optional[str] = None,
                 headers: Optional[Dict[str, str]] = None,
                 content_type: Optional[str] = None,
                 charset: Optional[str] = None):
        self.status = status
        self.headers = CIMultiDict(headers or {})
        if text is not None:
            charset = charset or "utf-8"
            self.body = text.encode(charset)
            self.headers.setdefault(
                "Content-Type",
                f"{content_type or 'text/plain'}; charset={charset}")
        else:
            self.body = body or b""
            if content_type:
                self.headers["Content-Type"] = (
                    f"{content_type}; charset={charset}" if charset
                    else content_type)


def json_response(data: Any, *, status: int = 200,
                  headers: Optional[Dict[str, str]] = None,
                  dumps: Callable[[Any], str] = json.dumps) -> Response:
    return Response(text=dumps(data), status=status, headers=headers,
                    content_type="application/json")


class StreamResponse:
    """A response written while the handler runs: ``await
    prepare(request)`` sends the head, each ``await write(data)`` one
    chunk (flushed), ``await write_eof()`` the end. Headers set after
    ``prepare`` are not sent, as in aiohttp."""

    def __init__(self, *, status: int = 200,
                 headers: Optional[Dict[str, str]] = None):
        self.status = status
        self.headers = CIMultiDict(headers or {})
        self._conn: Optional["_Connection"] = None
        self._chunked = True
        self._eof = False

    @property
    def prepared(self) -> bool:
        return self._conn is not None

    async def prepare(self, request: "Request") -> None:
        if self._conn is not None:
            return
        self._conn = request._conn
        self._chunked = request.version == "HTTP/1.1"
        if not self._chunked:  # an HTTP/1.0 client reads to the close
            request._keep_alive = False
        rid = request.get("request_id")
        if rid is not None:
            self.headers.setdefault("X-Request-ID", rid)
        headers = CIMultiDict(self.headers)
        if self._chunked:
            headers["Transfer-Encoding"] = "chunked"
        self._conn.write(_head(self.status, headers, request._keep_alive))
        await self._conn.drain()

    async def write(self, data: bytes) -> None:
        if self._conn is None:
            raise RuntimeError("StreamResponse.write before prepare")
        if not data:  # an empty chunk would end the body
            return
        if self._chunked:
            data = b"%x\r\n%s\r\n" % (len(data), data)
        self._conn.write(data)
        await self._conn.drain()

    async def write_eof(self) -> None:
        if self._conn is None or self._eof:
            return
        self._eof = True
        if self._chunked:
            self._conn.write(b"0\r\n\r\n")
        await self._conn.drain()


def _head(status: int, headers: CIMultiDict, keep_alive: bool,
          length: Optional[int] = None) -> bytes:
    try:
        reason = HTTPStatus(status).phrase
    except ValueError:
        reason = "Unknown"
    headers = CIMultiDict(headers)
    headers.setdefault("Date", formatdate(usegmt=True))
    headers.setdefault("Server", SERVER_NAME)
    if length is not None:
        headers["Content-Length"] = str(length)
    headers["Connection"] = "keep-alive" if keep_alive else "close"
    lines = [f"HTTP/1.1 {status} {reason}"]
    lines += [f"{k}: {v}" for k, v in headers.items()]
    return ("\r\n".join(lines) + "\r\n\r\n").encode("latin-1")


# ---------------------------------------------------------------------------
# Requests
# ---------------------------------------------------------------------------

class FileField:
    """One uploaded file of a multipart form."""

    def __init__(self, name: str, filename: str, data: bytes,
                 content_type: str):
        self.name = name
        self.filename = filename
        self.file = io.BytesIO(data)
        self.content_type = content_type


def parse_multipart(body: bytes, content_type: str) -> Dict[str, Any]:
    """A ``multipart/form-data`` body -> {field name: FileField (a part
    with a filename) or str}, the first part of each name. The body is
    parsed by the ``email`` package, which keeps a part's bytes as they
    are (CR, LF and lines that begin like the boundary included) and
    takes the line break before each boundary as the boundary's."""
    head = f"Content-Type: {content_type}\r\n\r\n".encode("latin-1")
    msg = email.parser.BytesParser().parsebytes(head + body)
    if not msg.is_multipart():
        raise HTTPBadRequest("multipart body without parts")
    out: Dict[str, Any] = {}
    for part in msg.get_payload():
        name = part.get_param("name", header="content-disposition")
        if name is None or name in out:
            continue
        data = part.get_payload(decode=True) or b""
        filename = part.get_filename()
        if filename is not None:
            out[name] = FileField(
                name, filename, data,
                part.get_content_type() if "content-type" in part
                else "application/octet-stream")
        else:
            charset = part.get_content_charset() or "utf-8"
            out[name] = data.decode(charset)
    return out


class Request:
    """One request, its body read whole."""

    def __init__(self, app: "Application", method: str, target: str,
                 version: str, headers: CIMultiDict, body: bytes,
                 remote: Optional[str], conn: "_Connection"):
        self.app = app
        self.method = method
        self.version = version
        parts = urllib.parse.urlsplit(target)
        self.path = urllib.parse.unquote(parts.path) or "/"
        self.query: Dict[str, str] = {}
        for k, v in urllib.parse.parse_qsl(parts.query,
                                           keep_blank_values=True):
            self.query.setdefault(k, v)
        self.headers = headers
        self.remote = remote
        self._body = body
        self._conn = conn
        self._items: Dict[str, Any] = {}
        connection = headers.get("Connection", "").lower()
        self._keep_alive = (connection != "close" if version == "HTTP/1.1"
                            else connection == "keep-alive")

    @property
    def content_type(self) -> str:
        raw = self.headers.get("Content-Type", "application/octet-stream")
        return raw.split(";", 1)[0].strip().lower()

    def _charset(self) -> str:
        for param in self.headers.get("Content-Type", "").split(";")[1:]:
            k, _, v = param.strip().partition("=")
            if k.lower() == "charset" and v:
                return v.strip('"')
        return "utf-8"

    async def read(self) -> bytes:
        return self._body

    async def text(self) -> str:
        return self._body.decode(self._charset())

    async def json(self) -> Any:
        return json.loads(await self.text())

    async def post(self) -> Dict[str, Any]:
        """The fields of a ``multipart/form-data`` body ({} for any other
        body)."""
        if self.content_type == "multipart/form-data":
            return parse_multipart(self._body,
                                   self.headers.get("Content-Type", ""))
        return {}

    def __getitem__(self, key: str) -> Any:
        return self._items[key]

    def __setitem__(self, key: str, value: Any) -> None:
        self._items[key] = value

    def get(self, key: str, default: Any = None) -> Any:
        return self._items.get(key, default)


# ---------------------------------------------------------------------------
# Application
# ---------------------------------------------------------------------------

Handler = Callable[[Request], Any]


class Router:
    def __init__(self):
        self._routes: Dict[str, Dict[str, Handler]] = {}

    def add_route(self, method: str, path: str, handler: Handler) -> None:
        self._routes.setdefault(path, {})[method.upper()] = handler

    def add_get(self, path: str, handler: Handler) -> None:
        self.add_route("GET", path, handler)
        self.add_route("HEAD", path, handler)

    def add_post(self, path: str, handler: Handler) -> None:
        self.add_route("POST", path, handler)

    def resolve(self, method: str, path: str) -> Handler:
        """The path's handler for ``method``, or a handler that raises
        404 or 405 (so that the middlewares still run, as in aiohttp)."""
        methods = self._routes.get(path)
        if methods is None:
            async def not_found(request):
                raise HTTPNotFound()
            return not_found
        if method not in methods:
            async def not_allowed(request):
                raise HTTPMethodNotAllowed(method, methods)
            return not_allowed
        return methods[method]


class Application:
    """Routes, middlewares, hooks and the app's items."""

    def __init__(self, *, middlewares=(), client_max_size: int = 1024 ** 2):
        self.middlewares = list(middlewares)
        self.client_max_size = client_max_size
        self.router = Router()
        self.on_startup: List[Callable] = []
        self.on_cleanup: List[Callable] = []
        self._items: Dict[str, Any] = {}
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._stop: Optional[asyncio.Event] = None
        self._server: Optional[asyncio.AbstractServer] = None
        self._connections: set = set()
        self._closing = False

    def __getitem__(self, key: str) -> Any:
        return self._items[key]

    def __setitem__(self, key: str, value: Any) -> None:
        self._items[key] = value

    async def handle(self, request: Request):
        handler = self.router.resolve(request.method, request.path)
        for mw in reversed(self.middlewares):
            handler = functools.partial(mw, handler=handler)
        return await handler(request)

    def stop(self) -> None:
        """End the serving loop gracefully (from any thread)."""
        if self._loop is None or self._stop is None:
            return
        try:
            self._loop.call_soon_threadsafe(self._stop.set)
        except RuntimeError:  # the loop has closed
            pass

    async def wait_stopped(self) -> None:
        await self._stop.wait()


# ---------------------------------------------------------------------------
# Connections
# ---------------------------------------------------------------------------

class _BadRequest(Exception):
    pass


class _Connection:
    """One client connection: a buffer over its reader, so that bytes
    read while a handler runs (the disconnect watch) stay for the next
    request."""

    def __init__(self, reader: asyncio.StreamReader,
                 writer: asyncio.StreamWriter):
        self.reader = reader
        self.writer = writer
        self.buf = bytearray()
        self.eof = False
        self.handler: Optional[asyncio.Task] = None
        peer = writer.get_extra_info("peername")
        self.remote = peer[0] if isinstance(peer, tuple) else None

    async def _fill(self) -> bool:
        if self.eof:
            return False
        try:
            data = await self.reader.read(65536)
        except ConnectionError:
            data = b""
        if not data:
            self.eof = True
            return False
        self.buf += data
        return True

    async def read_until(self, sep: bytes, limit: int) -> Optional[bytes]:
        """Bytes up to and including ``sep``; None at EOF first."""
        start = 0
        while True:
            i = self.buf.find(sep, start)
            if i >= 0:
                out = bytes(self.buf[:i + len(sep)])
                del self.buf[:i + len(sep)]
                return out
            if len(self.buf) > limit:
                raise _BadRequest("request head too long")
            start = max(0, len(self.buf) - len(sep) + 1)
            if not await self._fill():
                return None

    async def read_exactly(self, n: int) -> bytes:
        while len(self.buf) < n:
            if not await self._fill():
                raise _BadRequest("body shorter than its length")
        out = bytes(self.buf[:n])
        del self.buf[:n]
        return out

    async def discard(self, n: int) -> None:
        while n > 0:
            if not self.buf and not await self._fill():
                raise _BadRequest("body shorter than its length")
            k = min(n, len(self.buf))
            del self.buf[:k]
            n -= k

    async def wait_eof(self, cap: int) -> None:
        """Return when the client has gone; bytes that come meanwhile (a
        pipelined request) are kept, up to ``cap``."""
        while len(self.buf) <= cap:
            if not await self._fill():
                return
        await asyncio.Event().wait()  # a full buffer: watch no further

    def write(self, data: bytes) -> None:
        self.writer.write(data)

    async def drain(self) -> None:
        await self.writer.drain()


async def _read_body(conn: _Connection, headers: CIMultiDict,
                     limit: int) -> bytes:
    """The body by Transfer-Encoding chunked or Content-Length; raises
    HTTPRequestEntityTooLarge past ``limit`` (after reading the rest of a
    body of known length up to ``DRAIN_413_BYTES``, so that the client
    reads the answer), ``_BadRequest`` on a malformed one."""
    if "chunked" in headers.get("Transfer-Encoding", "").lower():
        body = bytearray()
        while True:
            line = await conn.read_until(b"\r\n", MAX_HEAD_BYTES)
            if line is None:
                raise _BadRequest("chunked body truncated")
            try:
                size = int(line.split(b";", 1)[0].strip(), 16)
            except ValueError:
                raise _BadRequest("bad chunk size")
            if size == 0:
                while True:  # trailers, up to the empty line
                    line = await conn.read_until(b"\r\n", MAX_HEAD_BYTES)
                    if line is None or line == b"\r\n":
                        break
                return bytes(body)
            if len(body) + size > limit:
                raise HTTPRequestEntityTooLarge(limit, len(body) + size)
            body += await conn.read_exactly(size)
            if await conn.read_exactly(2) != b"\r\n":
                raise _BadRequest("chunk without its CRLF")
    raw = headers.get("Content-Length")
    if raw is None:
        return b""
    try:
        n = int(raw)
    except ValueError:
        raise _BadRequest("bad Content-Length")
    if n < 0:
        raise _BadRequest("bad Content-Length")
    if n > limit:
        if n <= DRAIN_413_BYTES:
            await conn.discard(n)
        else:
            conn.eof = True  # close after the answer
        raise HTTPRequestEntityTooLarge(limit, n)
    return await conn.read_exactly(n)


async def _run_handler(app: Application, conn: _Connection,
                       request: Request):
    """The middlewares and handler of one request, cancelled if the client
    disconnects first (then None). Exceptions that no middleware turned
    into a response become aiohttp's: an HTTPException's own, else 500."""
    loop = asyncio.get_running_loop()
    task = loop.create_task(app.handle(request))
    conn.handler = task
    watch = loop.create_task(conn.wait_eof(app.client_max_size))
    try:
        await asyncio.wait({task, watch},
                           return_when=asyncio.FIRST_COMPLETED)
    finally:
        conn.handler = None
        if not task.done():  # the client went (or the server is closing)
            task.cancel()
        watch.cancel()
        await asyncio.gather(task, watch, return_exceptions=True)
    if task.cancelled():
        logger.info("%s %s: client disconnected; handler cancelled",
                    request.method, request.path)
        return None
    exc = task.exception()
    if exc is None:
        return task.result()
    if isinstance(exc, HTTPException):
        return exc.response()
    logger.error("unhandled error in %s %s", request.method, request.path,
                 exc_info=exc)
    return Response(text="500 Internal Server Error\n\nServer got itself "
                    "in trouble", status=500)


async def _serve_connection(app: Application, reader, writer) -> None:
    conn = _Connection(reader, writer)
    app._connections.add(conn)
    try:
        while not app._closing:
            try:
                head = await asyncio.wait_for(
                    _read_head(conn), timeout=KEEPALIVE_S)
            except asyncio.TimeoutError:
                break
            except _BadRequest as e:
                await _send(conn, HTTPBadRequest(str(e)).response(), False,
                            False)
                break
            if head is None:
                break
            method, target, version, headers = head
            try:
                if headers.get("Expect", "").lower() == "100-continue":
                    n = int(headers.get("Content-Length", "0") or 0)
                    if n > app.client_max_size:
                        conn.eof = True  # the body is never read
                        raise HTTPRequestEntityTooLarge(app.client_max_size,
                                                        n)
                    conn.write(b"HTTP/1.1 100 Continue\r\n\r\n")
                body = await _read_body(conn, headers, app.client_max_size)
            except HTTPRequestEntityTooLarge as e:
                await _send(conn, e.response(), not conn.eof, False)
                if conn.eof:
                    break
                continue
            except (_BadRequest, ValueError) as e:
                await _send(conn, HTTPBadRequest(str(e)).response(), False,
                            False)
                break
            request = Request(app, method, target, version, headers, body,
                              conn.remote, conn)
            resp = await _run_handler(app, conn, request)
            if resp is None:
                break  # the client is gone
            keep_alive = (request._keep_alive and not app._closing
                          and not conn.eof)
            if isinstance(resp, StreamResponse):
                if not resp.prepared:
                    await resp.prepare(request)
                await resp.write_eof()
            else:
                await _send(conn, resp, keep_alive, method == "HEAD")
            if not keep_alive:
                break
    except (ConnectionError, asyncio.IncompleteReadError):
        pass
    finally:
        app._connections.discard(conn)
        writer.close()
        try:
            await writer.wait_closed()
        except (ConnectionError, OSError):
            pass


async def _read_head(conn: _Connection):
    """(method, target, version, headers) of the next request; None when
    the client closed the connection between requests."""
    while True:  # blank lines before a request are allowed
        while conn.buf[:2] == b"\r\n":
            del conn.buf[:2]
        if conn.buf[:1] not in (b"", b"\r"):
            break
        if not await conn._fill():
            return None
    raw = await conn.read_until(b"\r\n\r\n", MAX_HEAD_BYTES)
    if raw is None:
        return None
    lines = raw[:-4].decode("latin-1").split("\r\n")
    parts = lines[0].split(" ")
    if len(parts) != 3 or not parts[2].startswith("HTTP/1."):
        raise _BadRequest(f"bad request line {lines[0]!r}")
    headers = CIMultiDict()
    for h in lines[1:]:
        name, sep, value = h.partition(":")
        if not sep or not name.strip():
            raise _BadRequest(f"bad header line {h!r}")
        headers[name.strip()] = value.strip()
    return parts[0].upper(), parts[1], parts[2], headers


async def _send(conn: _Connection, resp: Response, keep_alive: bool,
                head_only: bool) -> None:
    conn.write(_head(resp.status, resp.headers, keep_alive, len(resp.body)))
    if not head_only:
        conn.write(resp.body)
    await conn.drain()


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------

async def serve(app: Application, host: str = "0.0.0.0",
                port: int = 8080) -> int:
    """Run the startup hooks, then listen on (host, port) on this event
    loop; return the bound port. The app serves until ``shutdown``."""
    app._loop = asyncio.get_running_loop()
    app._stop = asyncio.Event()
    app._closing = False
    for hook in app.on_startup:
        await hook(app)
    app._server = await asyncio.start_server(
        functools.partial(_serve_connection, app), host, port)
    bound = app._server.sockets[0].getsockname()[1]
    logger.info("serving on http://%s:%d", host, bound)
    return bound


async def shutdown(app: Application,
                   grace_s: float = SHUTDOWN_GRACE_S) -> None:
    """Stop listening, let the handlers in flight finish (up to
    ``grace_s``), close every connection, then run the cleanup hooks."""
    app._closing = True
    if app._server is not None:
        app._server.close()
    loop = asyncio.get_running_loop()
    deadline = loop.time() + grace_s
    while any(c.handler is not None for c in app._connections) \
            and loop.time() < deadline:
        await asyncio.sleep(0.05)
    for conn in list(app._connections):
        if conn.handler is not None:
            conn.handler.cancel()
        conn.writer.close()
    if app._server is not None:
        try:
            await asyncio.wait_for(app._server.wait_closed(), timeout=5)
        except asyncio.TimeoutError:
            logger.warning("connections still open at shutdown")
        app._server = None
    for hook in app.on_cleanup:
        await hook(app)


async def _serve_until_stopped(app: Application, host: str,
                               port: int) -> None:
    await serve(app, host, port)
    try:
        await app.wait_stopped()
    finally:
        await shutdown(app)


def run_app(app: Application, host: str = "0.0.0.0",
            port: int = 8080) -> None:
    """Serve until ``app.stop()``, SIGINT or SIGTERM; return after the
    cleanup hooks have run."""
    async def main():
        loop = asyncio.get_running_loop()
        for sig in (signal.SIGINT, signal.SIGTERM):
            try:
                loop.add_signal_handler(sig, app.stop)
            except (NotImplementedError, RuntimeError, ValueError):
                pass  # not the main thread, or no signals here
        await _serve_until_stopped(app, host, port)

    asyncio.run(main())


class ServerThread:
    """The app served from a thread with its own event loop: ``port`` is
    the bound port once the constructor returns (it raises what startup
    raised); ``stop()`` ends serving gracefully and joins the thread;
    ``join()`` waits for an app that stops itself."""

    def __init__(self, app: Application, host: str = "127.0.0.1",
                 port: int = 0, start_timeout_s: float = 600.0):
        self.app = app
        self.port: Optional[int] = None
        self._error: Optional[BaseException] = None
        self._ready = threading.Event()
        self._thread = threading.Thread(
            target=lambda: asyncio.run(self._main(host, port)),
            name="http-server", daemon=True)
        self._thread.start()
        if not self._ready.wait(start_timeout_s):
            raise TimeoutError("the server did not start")
        if self._error is not None:
            raise self._error

    async def _main(self, host: str, port: int) -> None:
        try:
            self.port = await serve(self.app, host, port)
        except BaseException as e:  # handed to the constructor's caller
            self._error = e
            self._ready.set()
            return
        self._ready.set()
        try:
            await self.app.wait_stopped()
        finally:
            await shutdown(self.app)

    def stop(self, timeout_s: float = 120.0) -> None:
        self.app.stop()
        self.join(timeout_s)

    def join(self, timeout_s: Optional[float] = None) -> bool:
        """Wait for the serving thread; True if it has ended."""
        self._thread.join(timeout_s)
        return not self._thread.is_alive()
