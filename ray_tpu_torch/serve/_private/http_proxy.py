"""HTTP ingress: a single-threaded asyncio event-loop HTTP/1.1 server.

Reference: `serve/_private/http_proxy.py:425` (uvicorn + ASGI). The
previous ingress here was a stdlib ``ThreadingHTTPServer`` — a thread
per *connection*, blocking ``ray_tpu_torch.get`` per request, and streamed
responses forced ``Connection: close`` (SSE has no Content-Length), so
every streaming reply tore down its keep-alive connection. This module
replaces it with an event-loop data plane, uvicorn-style but with no
external deps:

- one ``asyncio.Protocol`` per connection on a single loop thread:
  persistent keep-alive connections, no thread per connection, idle
  connections reaped after ``idle_timeout_s``;
- streaming/SSE responses use **chunked transfer-encoding**, so the
  connection survives the stream and the next request rides the same
  socket;
- **bounded-concurrency backpressure**: at most ``max_in_flight``
  requests are in the router at once; beyond that the proxy sheds load
  with ``503 + Retry-After`` instead of growing threads/queues without
  bound. A router-queue timeout (no replica slot within
  ``queue_timeout_s``) also maps to 503;
- the bridge to the handle/router path is fully async:
  ``ServeHandle.remote_async`` awaits a replica slot and
  ``ObjectRef.as_future`` completes on this loop via one
  ``call_soon_threadsafe`` hop — the loop never blocks in
  ``ray_tpu_torch.get``.

Each response is written as a single ``transport.write`` (plus
TCP_NODELAY) — the buffered-write/Nagle lesson from the threaded
proxy's 40 ms delayed-ACK stall carries over.
"""

from __future__ import annotations

import asyncio
import json
import logging
import math
import re
import socket
import threading
import time
import uuid
import weakref
from collections import deque
from typing import Any, Dict, Optional, Tuple

from ray_tpu_torch._private import critical_path
from ray_tpu_torch._private import perf_stats
from ray_tpu_torch._private import tenancy
from ray_tpu_torch.exceptions import ActorDiedError
from ray_tpu_torch.serve._private import membership
from ray_tpu_torch.serve._private.router import QueueSaturatedError
from ray_tpu_torch.serve.streaming import aiter_stream, is_stream

_MAX_HEADER_BYTES = 64 * 1024
_MAX_BODY_BYTES = 32 * 1024 * 1024
_MAX_PIPELINED = 16
# Distinct X-Job-Id values one proxy will account before new tags
# degrade to untagged (metric/event cardinality bound).
_MAX_JOB_TAGS = 512

# Structured access log (one line per request, JSON payload), enabled
# by ray_config.serve_access_log — off by default so the ingress hot
# path stays log-free.
_access_log = logging.getLogger("ray_tpu_torch.serve.access")

# Trace ids (client-supplied or minted) and job/tenant tags: token
# chars only — both are echoed into response headers and logs, so the
# same header-injection sanitizing applies.
_TRACE_ID_OK = re.compile(r"^[0-9A-Za-z_.-]+$").match

# Live proxies in this process, for the runtime-metrics gauges
# (ray_tpu_serve_http_in_flight etc.); weak so shutdown proxies drop.
_PROXIES: "weakref.WeakSet[HTTPProxy]" = weakref.WeakSet()


def aggregate_stats() -> Optional[Dict[str, int]]:
    """Summed ingress counters across every live proxy in this process
    (None when no proxy exists) — consumed by runtime_metrics."""
    proxies = list(_PROXIES)
    if not proxies:
        return None
    out: Dict[str, int] = {}
    for p in proxies:
        for k, v in p.stats().items():
            out[k] = out.get(k, 0) + v
    return out


# The core exporter must not import serve (raylint R3): the ingress
# registers its stats source with runtime_metrics instead, keeping the
# dependency pointing downward. Gauge names are unchanged.
from ray_tpu_torch._private import runtime_metrics as _runtime_metrics  # noqa: E402

_runtime_metrics.register_stats_provider(
    "serve_http_ingress", aggregate_stats, {
        "in_flight": ("ray_tpu_serve_http_in_flight",
                      "Serve ingress: HTTP requests in flight"),
        "open_connections": ("ray_tpu_serve_http_open_connections",
                             "Serve ingress: open ingress connections"),
        "served": ("ray_tpu_serve_http_served",
                   "Serve ingress: requests served (terminal non-shed)"),
        "shed_503": ("ray_tpu_serve_http_shed_503",
                     "Serve ingress: requests shed with 503"),
        "limited_429": ("ray_tpu_serve_http_limited_429",
                        "Serve ingress: requests shed by per-tenant "
                        "rate limits (429)"),
        "denied_401": ("ray_tpu_serve_http_denied_401",
                       "Serve ingress: requests refused by ingress "
                       "auth (401)"),
        "direct_served": ("ray_tpu_serve_http_direct_served",
                          "Serve ingress: requests served via the "
                          "replica-direct fast path"),
        "direct_fallbacks": ("ray_tpu_serve_http_direct_fallbacks",
                             "Serve ingress: direct dispatches that "
                             "fell back to the routed path after a "
                             "replica death"),
    })

_REASONS = {
    200: "OK", 400: "Bad Request", 401: "Unauthorized",
    404: "Not Found", 413: "Payload Too Large",
    429: "Too Many Requests",
    431: "Request Header Fields Too Large", 500: "Internal Server Error",
    501: "Not Implemented", 503: "Service Unavailable",
}


class _RouteTable:
    def __init__(self):
        self._routes: Dict[str, Any] = {}
        self._lock = threading.Lock()

    def set(self, prefix: str, handle):
        with self._lock:
            self._routes[prefix.rstrip("/") or "/"] = handle

    def remove(self, prefix: str):
        with self._lock:
            self._routes.pop(prefix.rstrip("/") or "/", None)

    def match(self, path: str) -> Tuple[Optional[Any], str, str]:
        """(handle, rest_of_path, matched_prefix). The prefix — a
        registered route, bounded cardinality — is what metrics and the
        access log tag requests with, never the raw client path."""
        with self._lock:
            routes = dict(self._routes)
        best = None
        best_len = -1
        for prefix, handle in routes.items():
            p = prefix.rstrip("/")
            if (path == p or path.startswith(p + "/") or p == "") and \
                    len(p) > best_len:
                best, best_len = (handle, p), len(p)
        if best is None:
            return None, path, ""
        handle, p = best
        return handle, path[len(p):] or "/", p or "/"


class _Request:
    __slots__ = ("method", "path", "version", "headers", "body",
                 "keep_alive", "chunked_body", "error")

    def __init__(self):
        self.body = b""
        self.chunked_body = False
        self.error: Optional[Tuple[int, bytes]] = None


class _Conn(asyncio.Protocol):
    """One keep-alive client connection on the proxy's event loop.

    Headers parse with one ``split`` over the header block (no readline
    loop); pipelined requests queue in ``backlog`` and are handled
    strictly in order by a single task, so responses never interleave.
    """

    def __init__(self, proxy: "HTTPProxy"):
        self.proxy = proxy
        self.transport = None
        self.buf = b""
        self.backlog: deque = deque()
        self.task: Optional[asyncio.Task] = None
        self.closing = False
        self.last_activity = time.monotonic()
        self._write_paused = False
        self._read_paused = False
        self._drain_waiter: Optional[asyncio.Future] = None
        self._need: Optional[Tuple[_Request, int]] = None
        self._halt_parse = False  # unparseable framing (chunked body)
        self.http10 = False  # version of the request being handled
        self.last_status = 0  # status of the most recent response
        self.trace_id = ""    # trace id of the request being handled
        self.job_id = ""      # job/tenant tag of the request in flight
        self.serve_path = ""  # dispatch path taken (direct/routed/...)
        self.model = ""       # X-Model tag of the request in flight
        self.ttft_s = None    # first-token latency, once observed
        self.t_start = 0.0    # arrival stamp of the request in flight

    # -- lifecycle -------------------------------------------------------

    def connection_made(self, transport):
        self.transport = transport
        sock = transport.get_extra_info("socket")
        if sock is not None:
            try:
                sock.setsockopt(socket.IPPROTO_TCP,
                                socket.TCP_NODELAY, 1)
            except OSError:
                pass
        self.proxy._conns.add(self)

    def connection_lost(self, exc):
        self.closing = True
        self.proxy._conns.discard(self)
        w = self._drain_waiter
        if w is not None and not w.done():
            w.set_result(None)

    # -- outgoing flow control (slow client) -----------------------------

    def pause_writing(self):
        self._write_paused = True

    def resume_writing(self):
        self._write_paused = False
        w = self._drain_waiter
        if w is not None and not w.done():
            w.set_result(None)

    async def drain(self):
        """Park the writer until the transport buffer drains — a slow
        streaming client backpressures its own stream pump instead of
        buffering the whole response in proxy memory."""
        if self._write_paused and not self.closing:
            self._drain_waiter = self.proxy._loop.create_future()
            try:
                await self._drain_waiter
            finally:
                self._drain_waiter = None

    # -- incoming --------------------------------------------------------

    def data_received(self, data: bytes):
        self.last_activity = time.monotonic()
        self.buf += data
        self._parse()
        if self.backlog and self.task is None and not self.closing:
            self.task = self.proxy._loop.create_task(self._run())
        # Inbound flood guard: a client pipelining faster than the
        # handlers drain must not buffer unboundedly.
        if (len(self.backlog) > _MAX_PIPELINED
                and not self._read_paused):
            self._read_paused = True
            self.transport.pause_reading()

    def _fail_parse(self, status: int, body: bytes):
        """Queue a framing-error pseudo-request (responses must stay in
        order behind any pipelined predecessors) and stop parsing — the
        byte stream is no longer trustworthy, so the handler closes."""
        req = _Request()
        req.method, req.path, req.version = "GET", "/", "HTTP/1.1"
        req.headers = {}
        req.keep_alive = False
        req.error = (status, body)
        self.backlog.append(req)
        self._halt_parse = True

    def _parse(self):
        while not self._halt_parse:
            if self._need is not None:
                req, length = self._need
                if len(self.buf) < length:
                    return
                req.body = self.buf[:length]
                self.buf = self.buf[length:]
                self._need = None
                self.backlog.append(req)
                continue
            end = self.buf.find(b"\r\n\r\n")
            if end < 0:
                if len(self.buf) > _MAX_HEADER_BYTES:
                    self._fail_parse(431, b'{"error": "headers too '
                                     b'large"}')
                return
            head, self.buf = self.buf[:end], self.buf[end + 4:]
            lines = head.split(b"\r\n")
            req = _Request()
            try:
                req.method, req.path, version = \
                    lines[0].decode("latin-1").split(" ", 2)
                req.version = version.strip()
            except ValueError:
                self._fail_parse(400, b'{"error": "bad request"}')
                return
            headers: Dict[str, str] = {}
            cl_values = set()
            for ln in lines[1:]:
                k, _, v = ln.partition(b":")
                key = k.strip().lower().decode("latin-1")
                headers[key] = v.strip().decode("latin-1")
                if key == "content-length":
                    cl_values.add(headers[key])
            req.headers = headers
            if len(cl_values) > 1:
                # Conflicting duplicate content-lengths: last-wins here
                # vs first-wins at a front proxy is exactly the framing
                # disagreement smuggling exploits (RFC 9110 §8.6 allows
                # duplicates only when identical): hard 400.
                self._fail_parse(400, b'{"error": "conflicting '
                                 b'content-length"}')
                return
            conn_hdr = headers.get("connection", "").lower()
            if req.version == "HTTP/1.0":
                req.keep_alive = "keep-alive" in conn_hdr
            else:
                req.keep_alive = "close" not in conn_hdr
            if "chunked" in headers.get("transfer-encoding", "").lower():
                # Not decoded: bytes after the header block can't be
                # framed, so stop parsing — the handler replies 501 and
                # closes.
                req.chunked_body = True
                self.backlog.append(req)
                self._halt_parse = True
                return
            cl = headers.get("content-length", "")
            if cl:
                # RFC 9110: the value is DIGITs only. Bare int() is
                # laxer ("+5", " 5 ", "1_0", non-ASCII decimal digits)
                # and any laxity mismatch with a stricter front proxy
                # is a smuggling vector, so validate before parsing.
                length = int(cl) if cl.isascii() and cl.isdigit() \
                    else -1
            else:
                length = 0
            if length < 0:
                # A negative length would make the body slice swallow
                # pipelined successors (request smuggling): hard 400.
                self._fail_parse(400, b'{"error": "bad content-'
                                 b'length"}')
                return
            if length > _MAX_BODY_BYTES:
                # Bound what one request can make the loop buffer —
                # max_in_flight can't engage before parsing completes.
                self._fail_parse(413, b'{"error": "body too large"}')
                return
            if length:
                self._need = (req, length)
            else:
                self.backlog.append(req)

    async def _run(self):
        try:
            while self.backlog and not self.closing:
                req = self.backlog.popleft()
                if (self._read_paused
                        and len(self.backlog) <= _MAX_PIPELINED // 2):
                    self._read_paused = False
                    self.transport.resume_reading()
                self.http10 = req.version == "HTTP/1.0"
                await self.proxy._handle(self, req)
                self.last_activity = time.monotonic()
        finally:
            # No await between the loop's empty-backlog check and this
            # reset (single loop thread), so no request can slip in
            # unhandled.
            self.task = None

    # -- outgoing --------------------------------------------------------

    def send_response(self, status: int, body: bytes, *,
                      keep: bool = True, retry_after=False,
                      content_type: str = "application/json"):
        # ``retry_after``: falsy = no header; True = 1s; a number =
        # that many seconds (rounded up — the rate limiter's computed
        # token-accrual time must reach the wire, or compliant clients
        # retry far too fast).
        self.last_status = status
        if self.closing:
            return
        if status == 200 and keep and not self.http10 \
                and content_type == "application/json":
            # The hot path (every successful unary JSON reply): one
            # bytes concatenation, no per-header string formatting.
            trace_hdr = (b"X-Trace-Id: " + self.trace_id.encode()
                         + b"\r\n") if self.trace_id else b""
            if self.job_id:
                trace_hdr += (b"X-Job-Id: " + self.job_id.encode()
                              + b"\r\n")
            if self.serve_path:
                # Per-request dispatch-path proof (direct|routed|
                # fallback): the replica-direct benches and the chaos
                # test read it instead of trusting aggregate counters.
                trace_hdr += (b"X-Serve-Path: "
                              + self.serve_path.encode() + b"\r\n")
            self.transport.write(
                b"HTTP/1.1 200 OK\r\nContent-Type: application/json"
                b"\r\n" + trace_hdr
                + b"Content-Length: " + str(len(body)).encode()
                + b"\r\n\r\n" + body)
            return
        parts = [
            f"HTTP/1.1 {status} {_REASONS.get(status, 'Unknown')}",
            f"Content-Type: {content_type}",
            f"Content-Length: {len(body)}",
        ]
        if self.trace_id:
            parts.append(f"X-Trace-Id: {self.trace_id}")
        if self.job_id:
            parts.append(f"X-Job-Id: {self.job_id}")
        if self.serve_path:
            parts.append(f"X-Serve-Path: {self.serve_path}")
        if retry_after:
            seconds = 1 if retry_after is True else \
                max(1, math.ceil(float(retry_after)))
            parts.append(f"Retry-After: {seconds}")
        if not keep:
            parts.append("Connection: close")
        elif self.http10:
            # HTTP/1.0 defaults to close: persistence must be granted
            # explicitly or the client drops the socket while the
            # server-side connection lingers until the idle reaper.
            parts.append("Connection: keep-alive")
        self.transport.write(
            ("\r\n".join(parts) + "\r\n\r\n").encode("latin-1") + body)
        if not keep:
            self.closing = True
            self.transport.close()

    def send_header_block(self, status: int, headers):
        self.last_status = status
        if self.closing:
            return
        parts = [f"HTTP/1.1 {status} {_REASONS.get(status, 'Unknown')}"]
        parts += [f"{k}: {v}" for k, v in headers]
        if self.trace_id:
            parts.append(f"X-Trace-Id: {self.trace_id}")
        if self.job_id:
            parts.append(f"X-Job-Id: {self.job_id}")
        self.transport.write(
            ("\r\n".join(parts) + "\r\n\r\n").encode("latin-1"))

    def write_body(self, data: bytes, chunked: bool):
        if self.closing:
            return
        if chunked:
            self.transport.write(b"%x\r\n" % len(data) + data + b"\r\n")
        else:
            self.transport.write(data)


class HTTPProxy:
    """The per-process ingress: an event-loop HTTP/1.1 server routing to
    deployment handles. API-compatible with the threaded predecessor
    (``routes`` / ``host`` / ``port`` / ``shutdown``)."""

    def __init__(self, host: str = "127.0.0.1", port: int = 8000, *,
                 max_in_flight: int = 256, queue_timeout_s: float = 15.0,
                 idle_timeout_s: float = 30.0,
                 result_timeout_s: float = 60.0):
        self.routes = _RouteTable()
        self.max_in_flight = max_in_flight
        self.queue_timeout_s = queue_timeout_s
        self.idle_timeout_s = idle_timeout_s
        self.result_timeout_s = result_timeout_s
        self._in_flight = 0
        self._served = 0
        self._shed = 0
        self._limited = 0
        self._denied = 0
        self._direct_served = 0
        self._fallbacks = 0
        # Per-tenant ingress token buckets (tenancy enforcement): work
        # a job pushes past its rate is shed with 429 + Retry-After
        # HERE, before any router/replica resource is touched.
        self._limiter = tenancy.IngressLimiter()
        # Priority-class shedding (X-Priority): lowest class sheds
        # first as in-flight load rises, plus optional per-class rate
        # buckets — all decided by the pure gate in tenancy.py.
        self._priority = tenancy.PriorityGate()
        self._conns: set = set()
        # Distinct job tags this proxy has accounted. X-Job-Id is
        # client-controlled: without a cap, a client cycling random
        # tokens mints one permanent (route, job) counter series — and
        # one job-tagged task-event key head-side — per value. Real
        # tenant counts are far below this; overflow tags degrade to
        # untagged rather than growing the registry.
        self._job_tags_seen: set = set()
        self._loop = asyncio.new_event_loop()
        self._started = threading.Event()
        self._thread = threading.Thread(target=self._loop_main,
                                        daemon=True,
                                        name="serve-http-proxy")
        self._thread.start()
        self._started.wait(10)
        fut = asyncio.run_coroutine_threadsafe(
            self._start_server(host, port), self._loop)
        try:
            self.host, self.port = fut.result(timeout=30)
        except BaseException:
            # Bind failure (port in use, bad host): don't leak the loop
            # thread behind the raised error.
            self._loop.call_soon_threadsafe(self._loop.stop)
            self._thread.join(timeout=5)
            raise
        _PROXIES.add(self)  # runtime-metrics gauges read live proxies

    def _loop_main(self):
        asyncio.set_event_loop(self._loop)
        self._loop.call_soon(self._started.set)
        self._loop.run_forever()
        pending = asyncio.all_tasks(self._loop)
        for t in pending:
            t.cancel()
        if pending:
            self._loop.run_until_complete(
                asyncio.gather(*pending, return_exceptions=True))
        self._loop.close()

    async def _start_server(self, host: str, port: int):
        self._server = await self._loop.create_server(
            lambda: _Conn(self), host, port)
        self._reaper = self._loop.create_task(self._reap_idle())
        # Overload signal for /api/healthz: how late timed callbacks
        # fire on THIS loop — the single-threaded ingress's canonical
        # saturation measure (the sampler task dies with the loop).
        from ray_tpu_torch._private.health import install_loop_lag_sampler

        install_loop_lag_sampler(self._loop, "http_proxy")
        return self._server.sockets[0].getsockname()[:2]

    async def _reap_idle(self):
        """Keep-alive connections must not pin resources forever: close
        any connection idle (no request in progress) past the timeout."""
        while True:
            await asyncio.sleep(min(5.0, self.idle_timeout_s / 2))
            now = time.monotonic()
            for conn in list(self._conns):
                if (conn.task is None and not conn.backlog
                        and not conn.closing
                        and now - conn.last_activity
                        > self.idle_timeout_s):
                    conn.closing = True
                    conn.transport.close()

    # -- request handling ------------------------------------------------

    async def _handle(self, conn: _Conn, req: _Request):
        """Per-request envelope: assign/propagate the trace id, time
        the request, record per-route/status latency, and emit the
        access-log line (when enabled). The response logic itself lives
        in :meth:`_respond`."""
        from ray_tpu_torch._private.config import ray_config

        t0 = time.monotonic()
        # Honor a caller-supplied trace id so an upstream LB or client
        # can stitch the request into ITS trace; mint one otherwise.
        # STRICTLY sanitized before use: the value is echoed into
        # response headers and logs, and the request parser only splits
        # on \r\n — a bare LF smuggled inside the value would otherwise
        # become response-header injection.
        supplied = (req.headers.get("x-trace-id", "")
                    if getattr(req, "headers", None) else "")
        # Reject (don't mutate): an over-length or non-token value gets
        # a fresh id — echoing a truncated id would silently break the
        # caller's correlation.
        trace_id = supplied if supplied and len(supplied) <= 64 \
            and _TRACE_ID_OK(supplied) else uuid.uuid4().hex
        # Job/tenant tag (X-Job-Id): same sanitizing as the trace id
        # (echoed into headers/logs), but never minted — an untagged
        # request falls through to the proxy process's ambient/default
        # tag, and a malformed value is dropped rather than replaced.
        raw_job = (req.headers.get("x-job-id", "")
                   if getattr(req, "headers", None) else "")
        job_id = raw_job if raw_job and len(raw_job) <= 64 \
            and _TRACE_ID_OK(raw_job) else ""
        if job_id and job_id not in self._job_tags_seen:
            if len(self._job_tags_seen) >= _MAX_JOB_TAGS:
                job_id = ""  # cardinality guard: overflow -> untagged
            else:
                self._job_tags_seen.add(job_id)
        # Model tag (X-Model): selects the weight variant on a
        # multi-model LLM deployment. Same sanitizer as the trace id
        # (echoed into logs and used as a metric tag); malformed values
        # drop to the deployment's default model.
        raw_model = (req.headers.get("x-model", "")
                     if getattr(req, "headers", None) else "")
        model = raw_model if raw_model and len(raw_model) <= 64 \
            and _TRACE_ID_OK(raw_model) else ""
        conn.trace_id = trace_id
        conn.job_id = job_id
        conn.last_status = 0
        conn.serve_path = ""
        conn.model = model
        conn.ttft_s = None
        conn.t_start = t0
        route = ""
        try:
            route = await self._respond(conn, req, trace_id, job_id,
                                        model=model)
        finally:
            latency = time.monotonic() - t0
            ttft_s = conn.ttft_s
            conn.trace_id = ""
            conn.job_id = ""
            conn.serve_path = ""
            conn.model = ""
            conn.ttft_s = None
            status = str(conn.last_status or 0)
            perf_stats.dist(
                "serve_request_seconds",
                tags={"route": route or "(unmatched)",
                      "status": status},
                bounds=perf_stats.SERVE_LATENCY_BOUNDS).record(latency)
            # Close the critical-path accumulator: attribute this
            # request's wall time to its recorded stage spans (the
            # remainder folds as "unattributed") and retain the
            # waterfall for /api/slow_requests.
            critical_path.finish_request(
                trace_id, route or "(unmatched)", status, latency)
            # Per-(job, route) request accounting — the serve half of
            # state.job_summary() and the ray_tpu_serve_requests_total
            # job-tagged series. Route prefixes bound the cardinality;
            # jobs are real tenants, also bounded.
            perf_stats.counter(
                "serve_requests",
                tags={"route": route or "(unmatched)",
                      "job": job_id}).inc()
            if ray_config.serve_access_log:
                try:
                    line = {
                        "method": getattr(req, "method", ""),
                        "route": route or "(unmatched)",
                        "path": getattr(req, "path", ""),
                        "status": conn.last_status or 0,
                        "latency_ms": round(latency * 1e3, 3),
                        "trace_id": trace_id,
                        "job_id": job_id,
                    }
                    if model:
                        line["model"] = model
                    if ttft_s is not None:
                        line["ttft_ms"] = round(ttft_s * 1e3, 3)
                    _access_log.info(json.dumps(line))
                except Exception:
                    pass  # the access log must never break serving

    async def _respond(self, conn: _Conn, req: _Request,
                       trace_id: str, job_id: str = "",
                       model: str = "") -> str:
        """Handle one parsed request; returns the matched route prefix
        (for metrics/logging)."""
        if req.error is not None:
            status, body = req.error
            conn.send_response(status, body, keep=False)
            return ""
        if req.chunked_body:
            conn.send_response(
                501, b'{"error": "chunked bodies not supported"}',
                keep=False)
            return ""
        # Ingress auth (optional shared secret), BEFORE route matching:
        # refused requests never touch the route table (no 404-based
        # route enumeration), the router, a replica slot, or the rate
        # limiter's token accounting.
        from ray_tpu_torch._private.config import ray_config

        token = ray_config.ingress_auth_token
        if token:
            import hmac

            # Constant-time comparisons over BYTES: a shared-secret
            # check must not leak matching-prefix length through
            # response timing, and compare_digest refuses non-ASCII
            # str (latin-1-decoded headers can carry any byte).
            expect = f"Bearer {token}".encode("latin-1", "replace")
            supplied = req.headers.get(
                "authorization", "").encode("latin-1", "replace")
            alt = req.headers.get(
                "x-auth-token", "").encode("latin-1", "replace")
            token_b = token.encode("latin-1", "replace")
            if not hmac.compare_digest(supplied, expect) \
                    and not hmac.compare_digest(alt, token_b):
                self._denied += 1
                conn.send_response(
                    401, b'{"error": "missing or invalid ingress '
                    b'credentials"}', keep=req.keep_alive)
                return ""
        handle, _rest, route = self.routes.match(
            req.path.split("?", 1)[0])
        if handle is None:
            conn.send_response(404, b'{"error": "no route"}',
                               keep=req.keep_alive)
            return ""
        # Per-tenant token bucket: shed a job over its ingress rate
        # with 429 + Retry-After BEFORE work enters the router (rides
        # the same early-exit path as the 503 backpressure shed).
        retry_in = self._limiter.try_admit(job_id)
        if retry_in is not None:
            self._limited += 1
            conn.send_response(
                429, json.dumps({
                    "error": f"job {job_id or '(untagged)'} is over "
                             f"its ingress rate limit"}).encode(),
                keep=req.keep_alive, retry_after=retry_in)
            return route
        # Priority-class admission (X-Priority: high|normal|low):
        # below the hard cap, the lowest class sheds first as load
        # rises (layered fractions) and per-class rate buckets apply.
        cls = tenancy.parse_priority(req.headers.get("x-priority", ""))
        retry_in = self._priority.try_admit(cls, self._in_flight,
                                            self.max_in_flight)
        if retry_in is not None:
            self._record_shed(conn, req, route, job_id, cls,
                              retry_after=retry_in)
            return route
        if self._in_flight >= self.max_in_flight:
            # Load shed: a bounded in-flight cap with an explicit 503
            # instead of the threaded server's unbounded thread growth.
            self._record_shed(conn, req, route, job_id, cls,
                              retry_after=True)
            return route
        payload: Any = None
        if req.body:
            try:
                payload = json.loads(req.body)
            except ValueError:
                payload = req.body.decode("utf-8", "replace")
        if isinstance(payload, dict):
            # Header tags ride INSIDE the payload for deployments that
            # understand them (multi-model routing, tenant charging,
            # priority at the engine's slot shed point). Body values
            # win — headers only fill gaps.
            if model and not payload.get("model"):
                payload["model"] = model
            if job_id and not payload.get("job"):
                payload["job"] = job_id
            if req.headers.get("x-priority") and "priority" not in payload:
                payload["priority"] = cls
        self._in_flight += 1
        token = None
        try:
            args = () if payload is None else (payload,)
            # The request is the trace ROOT: the replica call's parent
            # span is the request itself, so proxy→router→replica→tasks
            # all share one trace id. The job tag rides the same
            # dispatch (None = untagged: the replica call inherits the
            # proxy's ambient/default tag instead).
            trace = (trace_id, trace_id)
            job = job_id or None
            result = None
            direct_failed = False
            for attempt in (0, 1, 2):
                # Stage boundary: accept→dispatch covers slot claim /
                # router queueing, dispatch→result the replica's work.
                t_dispatch = time.monotonic()
                # Replica-direct fast path: claim a slot in the
                # long-poll-fed table and dispatch proxy→replica —
                # no router lock, no per-request ref pruning, no
                # report RPC. Falls back to the routed path on cold
                # table / saturation / the knob being off.
                ref = None
                if attempt == 0:
                    ref, token = handle.try_direct(
                        *args, _trace=trace, _job=job)
                if ref is not None:
                    conn.serve_path = "direct"
                else:
                    # "fallback" means a DIRECT dispatch died and the
                    # request rerouted — a routed retry after a routed
                    # death stays "routed" (mislabeling it would skew
                    # the exact A/B ratio the hop counters prove).
                    conn.serve_path = "fallback" if direct_failed \
                        else "routed"
                    # Routed: a free replica slot dispatches
                    # synchronously (no coroutine machinery); only
                    # saturation parks on the async queue-wait.
                    ref = handle.try_remote(*args, _trace=trace,
                                            _job=job)
                    if ref is None:
                        ref = await handle.remote_async(
                            *args,
                            _queue_timeout_s=self.queue_timeout_s,
                            _trace=trace, _job=job)
                t_wait = time.monotonic()
                critical_path.record_stage(
                    trace_id, "proxy.dispatch", t_wait - t_dispatch,
                    route=route)
                fut = ref.as_future(self._loop)
                try:
                    # Bounded replica execution (the threaded proxy's
                    # get(timeout=60) contract): a hung deployment
                    # becomes a 500, not a request pinning its
                    # in-flight slot — and the proxy — forever.
                    result = await asyncio.wait_for(
                        fut, self.result_timeout_s)
                except asyncio.TimeoutError:
                    if not fut.cancelled():
                        # The DEPLOYMENT raised a TimeoutError (3.11+:
                        # asyncio.TimeoutError is builtin
                        # TimeoutError); wait_for only cancels the
                        # future when IT timed out. Application
                        # failure -> generic 500 below.
                        raise
                    conn.send_response(
                        500, json.dumps({
                            "error": f"no result within "
                                     f"{self.result_timeout_s}s"
                        }).encode(), keep=req.keep_alive)
                    self._served += 1
                    return route
                except ActorDiedError:
                    if attempt < 2:
                        # The dispatched replica died with the call
                        # never executed (an ActorDiedError is only
                        # ever stored for calls drained UNEXECUTED
                        # from the mailbox — an executing call runs to
                        # completion — so a re-dispatch cannot
                        # double-execute): drop the replica from the
                        # direct table AND the router's list ahead of
                        # long-poll, then retry through the routed
                        # path. One extra bounded retry covers the
                        # window where the router's own snapshot still
                        # carried a second dying replica.
                        if token is not None:
                            handle.direct_invalidate(token)
                            token = None
                            direct_failed = True
                            # The fallback event IS the direct
                            # dispatch dying — counted here, once.
                            membership.hop_counter("fallback").inc()
                            self._fallbacks += 1
                        continue
                    raise
                # The dispatch→result window is deliberately NOT
                # recorded as a stage: downstream spans (replica
                # execute, LLM prefill/decode) explain it, and a
                # wrapper stage would out-rank every stage nested
                # inside it in the dominant-stage ranking. Whatever
                # downstream doesn't explain folds as "unattributed".
                break
            if token is not None:
                self._direct_served += 1
            if is_stream(result):
                await self._stream_response(conn, req, result,
                                            route=route, model=model)
            else:
                # Non-stream LLM responses carry their engine-measured
                # TTFT; fold it into the same series the SSE path feeds.
                if isinstance(result, dict) and \
                        isinstance(result.get("ttft_s"), float):
                    conn.ttft_s = result["ttft_s"]
                    self._record_ttft(conn.ttft_s, route, model)
                conn.send_response(200, json.dumps(result).encode(),
                                   keep=req.keep_alive)
            self._served += 1
        except QueueSaturatedError as e:
            # Router queue saturated: no replica slot within the queue
            # timeout. Shed with Retry-After, same as the in-flight
            # cap. A TimeoutError raised BY the deployment does NOT
            # land here — that's an application failure (500 below).
            self._shed += 1
            conn.send_response(503,
                               json.dumps({"error": str(e)}).encode(),
                               keep=req.keep_alive, retry_after=True)
        except Exception as e:  # noqa: BLE001
            conn.send_response(500,
                               json.dumps({"error": str(e)}).encode(),
                               keep=req.keep_alive)
            self._served += 1
        finally:
            self._in_flight -= 1
            if token is not None:
                # Slot release is the completion edge of the direct
                # path (streams included: the stream handle resolved).
                handle.direct_release(token)
        return route

    def _record_shed(self, conn: _Conn, req: _Request, route: str,
                     job_id: str, cls: int, retry_after) -> None:
        """One load-shed 503: send the response AND account the shed at
        the shed point — ``serve_requests_shed{route,job,class}`` plus
        the ``serve_request_seconds{route,status="503"}`` /
        job-tagged request records the enclosing ``_handle`` writes —
        so per-job accounting and the (status-aware) SLO burn see
        shedding the moment it happens, not only when saturation
        reaches the router."""
        self._shed += 1
        perf_stats.counter(
            "serve_requests_shed",
            tags={"route": route or "(unmatched)", "job": job_id,
                  "class": tenancy.PRIORITY_CLASSES[
                      min(cls, len(tenancy.PRIORITY_CLASSES) - 1)]}).inc()
        conn.send_response(503, b'{"error": "server overloaded"}',
                           keep=req.keep_alive, retry_after=retry_after)

    @staticmethod
    def _record_ttft(ttft_s: float, route: str, model: str) -> None:
        """ray_tpu_serve_ttft_seconds{route,model} — the LLM serving
        SLO number: request arrival at the proxy to the first token on
        the wire (SSE) or the engine's first-token stamp (unary)."""
        perf_stats.dist(
            "serve_ttft_seconds",
            tags={"route": route or "(unmatched)",
                  "model": model or "(default)"},
            bounds=perf_stats.SERVE_LATENCY_BOUNDS).record(ttft_s)

    async def _stream_response(self, conn: _Conn, req: _Request, result,
                               route: str = "", model: str = ""):
        """Server-sent events with chunked transfer-encoding: the client
        sees each chunk as produced AND the connection stays usable for
        the next request (the threaded proxy had to Connection: close
        here, killing keep-alive for every streamed reply). HTTP/1.0
        clients can't parse chunked framing, so they fall back to a
        close-delimited body."""
        chunked = req.version != "HTTP/1.0"
        keep = req.keep_alive and chunked
        headers = [("Content-Type", "text/event-stream"),
                   ("Cache-Control", "no-cache")]
        if chunked:
            headers.append(("Transfer-Encoding", "chunked"))
        if not keep:
            headers.append(("Connection", "close"))
        conn.send_header_block(200, headers)
        try:
            async for chunk in aiter_stream(result):
                if conn.ttft_s is None:
                    # First token on the wire: the streaming TTFT stamp.
                    conn.ttft_s = time.monotonic() - conn.t_start
                    self._record_ttft(conn.ttft_s, route, model)
                conn.write_body(
                    b"data: " + json.dumps(chunk).encode() + b"\n\n",
                    chunked)
                await conn.drain()
                if conn.closing:  # client went away mid-stream
                    return
            conn.write_body(b"data: [DONE]\n\n", chunked)
        except Exception as stream_err:  # noqa: BLE001
            # Headers already sent: a mid-stream failure must become an
            # error *event*, never a 500 status line spliced into the
            # SSE body.
            conn.write_body(
                b"data: " + json.dumps(
                    {"error": str(stream_err)}).encode()
                + b"\n\ndata: [DONE]\n\n", chunked)
        if conn.closing:
            return
        if chunked:
            conn.transport.write(b"0\r\n\r\n")
        if not keep:
            conn.closing = True
            conn.transport.close()

    # -- observability / lifecycle --------------------------------------

    def stats(self) -> Dict[str, int]:
        """Ingress counters. ``served`` counts requests that reached a
        handler and got a terminal non-shed response (2xx/5xx);
        ``shed_503`` counts load-shed requests (in-flight cap or router
        queue timeout) — the two are disjoint."""
        return {"in_flight": self._in_flight, "served": self._served,
                "shed_503": self._shed, "limited_429": self._limited,
                "denied_401": self._denied,
                "direct_served": self._direct_served,
                "direct_fallbacks": self._fallbacks,
                "open_connections": len(self._conns)}

    def shutdown(self):
        _PROXIES.discard(self)
        if self._loop.is_closed():
            return

        def _stop():
            for conn in list(self._conns):
                try:
                    conn.closing = True
                    conn.transport.close()
                except Exception:
                    pass
            self._reaper.cancel()
            self._server.close()
            self._loop.stop()

        try:
            self._loop.call_soon_threadsafe(_stop)
        except RuntimeError:
            return
        self._thread.join(timeout=10)
