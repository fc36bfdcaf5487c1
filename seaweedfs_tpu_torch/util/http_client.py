"""Pooled keep-alive HTTP/1.1 client for the data plane.

The port of ``seaweedfs_tpu.util.http_client`` (the reference's data path
rides Go's pooled http.Client, weed/util/http_util.go:17-29):

  - a process-wide pool of persistent connections keyed by netloc
  - TCP_NODELAY (small requests must not wait on delayed ACKs)
  - one sendall per request (headers and body in one buffer)
  - a hand-rolled response parse into a lowercase-keyed dict
  - Content-Length, chunked and read-to-close bodies
  - one retry when a pooled connection turns out stale

Its outcomes are the circuit breaker's only source
(``resilience/breaker.py``). The pool makes no thread at all: idle
connections are reaped on get and put. Only plain http is spoken. With
QoS on, the ambient tenant rides X-Seaweed-Tenant; with cluster tracing
on, the trace context rides X-Seaweed-Trace.
"""

from __future__ import annotations

import socket
import threading
import time
from typing import Dict, List, Optional, Tuple

from seaweedfs_tpu_torch.resilience import breaker, deadline, failpoint
from seaweedfs_tpu_torch.stats import cluster_trace as _ctrace
from seaweedfs_tpu_torch.util.http_server import HeaderDict, parse_header_block

_pool_lock = threading.Lock()
_pool: Dict[str, List["_Conn"]] = {}  # guarded_by(_pool_lock)
_MAX_IDLE_PER_HOST = 32
# Idle-age cap: a pooled socket untouched this long is closed instead
# of reused. Long-idle sockets are the ones the server side reaps
# first, so under bursty load they surface as stale-retry churn (a
# replayed request per reused-dead socket); reaping happens
# opportunistically on pool get/put — no reaper thread, per the
# zero-threads-until-used house rule.
_IDLE_MAX_S = 60.0
_MAX_LINE = 65536


def _idle_count() -> int:
    with _pool_lock:
        return sum(len(c) for c in _pool.values())


def _export_pool_gauge() -> None:
    # collection-time callable: the gauge keeps moving without a write
    # per pool mutation
    from seaweedfs_tpu_torch.stats.metrics import HttpPoolIdleGauge
    HttpPoolIdleGauge.set_function(_idle_count)


_export_pool_gauge()

# QoS seam: qos.configure() installs the ambient-tenant contextvar here
# (reset() clears it). When armed, every outbound request forwards the
# caller's tenant in X-Seaweed-Tenant, so a replica fan-out or a shard
# fetch is charged to the ORIGINAL tenant at the next hop. None (the
# default) keeps the request path one identity check away from unchanged.
_qos_tenant = None
_TENANT_HEADER = "X-Seaweed-Tenant"


class ConnectError(OSError):
    """Could not establish (or reuse) a connection — the request never
    reached the peer, so replaying it is always safe. The class the
    retry default classifier treats as retryable."""


class ServerBusy(OSError):
    """Explicit backpressure from the peer (HTTP 429/503 with the QoS
    plane's Retry-After): the request was REFUSED, not executed, so
    replaying it is always safe — and the peer demonstrably answered,
    so this never burns breaker evidence (request() records the
    response as peer-alive before raising). Raised only when the
    caller opted in via request(busy_raises=True); `retry_after`
    carries the server's refill estimate in seconds (0.0 when the
    header was absent or unparseable), which util/retry honors as the
    backoff pause, capped by the ambient deadline budget."""

    def __init__(self, msg: str, status: int = 503,
                 retry_after: float = 0.0):
        super().__init__(msg)
        self.status = status
        self.retry_after = retry_after


class ResponseError(OSError):
    """Wire failure AFTER the request was sent: the peer may have
    executed it, so blind replay is not safe."""


class RequestTimeout(ResponseError):
    """Timed out awaiting the peer (connect timeouts surface as
    ConnectError via create_connection instead)."""


class _Conn:
    __slots__ = ("netloc", "sock", "rfile", "last_used")

    def __init__(self, netloc: str, timeout: float):
        self.netloc = netloc
        if failpoint._armed:
            failpoint.hit("http.connect", peer=netloc)
        if netloc.startswith("["):  # [v6-literal]:port or bare [v6-literal]
            bracket = netloc.find("]")
            host = netloc[1:bracket]
            rest = netloc[bracket + 1:]
            port = int(rest[1:]) if rest.startswith(":") else 80
        elif ":" in netloc:
            host, _, port_s = netloc.rpartition(":")
            port = int(port_s)
        else:
            host, port = netloc, 80
        try:
            self.sock = socket.create_connection((host, port),
                                                 timeout=timeout)
        except OSError as e:
            raise ConnectError(f"connect {netloc}: {e}") from e
        self.sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self.rfile = self.sock.makefile("rb", buffering=65536)
        self.last_used = time.monotonic()

    def close(self) -> None:
        try:
            self.rfile.close()
        except OSError:
            pass
        try:
            self.sock.close()
        except OSError:
            pass


def _get_conn(netloc: str, timeout: float) -> Tuple["_Conn", bool]:
    """Returns (conn, reused). Conns past the idle-age cap are closed,
    never handed out — they are the stale-retry churn under bursty
    load."""
    expired = []
    conn = None
    cutoff = time.monotonic() - _IDLE_MAX_S
    with _pool_lock:
        conns = _pool.get(netloc)
        while conns:
            cand = conns.pop()
            if cand.last_used >= cutoff:
                conn = cand
                break
            expired.append(cand)
    _reap(expired)
    if conn is not None:
        conn.sock.settimeout(timeout)
        return conn, True
    return _Conn(netloc, timeout), False


def _put_conn(conn: "_Conn") -> None:
    conn.last_used = time.monotonic()
    cutoff = conn.last_used - _IDLE_MAX_S
    expired = []
    with _pool_lock:
        conns = _pool.setdefault(conn.netloc, [])
        # oldest sit at the front (append order); shed them first
        while conns and conns[0].last_used < cutoff:
            expired.append(conns.pop(0))
        if len(conns) < _MAX_IDLE_PER_HOST:
            conns.append(conn)
            conn = None
    _reap(expired)
    if conn is not None:
        conn.close()


def _reap(expired) -> None:
    if not expired:
        return
    from seaweedfs_tpu_torch.stats.metrics import HttpPoolReapedCounter
    HttpPoolReapedCounter.inc(len(expired))
    for c in expired:
        c.close()


def close_all() -> None:
    """Drop every pooled connection (tests / topology changes).
    Sockets are closed OUTSIDE the pool lock — close() can block on a
    lingering send, and the pool lock sits on the request hot path."""
    with _pool_lock:
        doomed = [c for conns in _pool.values() for c in conns]
        _pool.clear()
    for c in doomed:
        c.close()


class Response:
    __slots__ = ("status", "headers", "body")

    def __init__(self, status: int, headers: "HeaderDict", body: bytes):
        self.status = status
        self.headers = headers
        self.body = body

    def header(self, name: str, default: str = "") -> str:
        return self.headers.get(name, default)


def request(method: str, url: str, body: Optional[bytes] = None,
            headers: Optional[dict] = None, timeout: float = 60.0,
            pooled: bool = True, busy_raises: bool = False) -> Response:
    """One HTTP request over a pooled persistent connection.

    ``url`` is "http://host:port/path?q" or bare "host:port/path?q".
    Returns the full body.

    Each branch below is one flag check when its feature is off:
      - an ambient deadline refuses a spent budget up front, sizes the
        socket timeout to min(timeout, remaining) and forwards the budget
        left in X-Seaweed-Deadline;
      - an enabled circuit breaker fails fast on an open peer and is fed
        by this call's outcome (any HTTP response is proof of life; only
        a connection-level OSError is a failure);
      - an ambient QoS tenant is forwarded in X-Seaweed-Tenant, and an
        ambient cluster trace in X-Seaweed-Trace under a client-side
        ``http.client`` span;
      - ``busy_raises=True`` turns a 429/503 into ServerBusy carrying the
        server's Retry-After, AFTER the breaker recorded the answer as
        alive, so backpressure never opens a breaker;
      - the http.connect and http.response failpoints inject here.
    """
    netloc, path = _split(url)
    budget_shrunk = False
    if deadline.get() is not None:
        rem = deadline.remaining()
        if rem <= 0:
            from seaweedfs_tpu_torch.stats.metrics import \
                DeadlineRefusedCounter
            DeadlineRefusedCounter.labels("http_client").inc()
            raise deadline.DeadlineExceeded(f"{method} {netloc}{path}")
        if rem < timeout:
            timeout = rem
            budget_shrunk = True
        merged = dict(headers) if headers else {}
        merged[deadline.HEADER] = f"{rem:.4f}"
        headers = merged
    if _qos_tenant is not None:
        tenant = _qos_tenant.get()
        if tenant is not None and not (headers and
                                       _TENANT_HEADER in headers):
            merged = dict(headers) if headers else {}
            merged[_TENANT_HEADER] = tenant
            headers = merged
    tsp = None
    if _ctrace._enabled:
        from seaweedfs_tpu_torch.stats import trace as _trace
        if _trace.request_ctx() is not None:
            # client-side hop span opened FIRST so the remote request
            # span (minted by the peer's ingress wrapper from this
            # header) nests under it in the stitched view
            tsp = _trace.Span("http.client", None,
                              {"peer": netloc, "method": method})
            tsp.__enter__()
            merged = dict(headers) if headers else {}
            merged[_ctrace.HEADER] = _ctrace.outbound_header()
            headers = merged
    try:
        if breaker.enabled:
            breaker.check(netloc)   # raises BreakerOpen while open
        try:
            resp = _request_once_retried(netloc, path, method, body,
                                         headers, timeout, pooled)
        except deadline.DeadlineExceeded:
            # a spent budget says nothing about the PEER's health
            raise
        except OSError as e:
            # ...and neither does a timeout the budget cut below the
            # caller's own: impatient clients must not open a slow
            # peer's breaker
            if breaker.enabled and not (budget_shrunk and
                                        isinstance(e, RequestTimeout)):
                breaker.record(netloc, False)
            raise
        if breaker.enabled:
            breaker.record(netloc, True)
        if busy_raises and resp.status in (429, 503):
            raise ServerBusy(
                f"{method} {netloc}{path}: {resp.status} busy",
                status=resp.status,
                retry_after=retry_after_seconds(resp))
        if failpoint._armed:
            resp.body = failpoint.mangle("http.response", resp.body,
                                         peer=netloc,
                                         status=str(resp.status))
        return resp
    finally:
        if tsp is not None:
            tsp.__exit__(None, None, None)


def _request_once_retried(netloc: str, path: str, method: str,
                          body: Optional[bytes], headers: Optional[dict],
                          timeout: float, pooled: bool) -> Response:
    reuse_ok = pooled
    for attempt in (0, 1):
        if reuse_ok:
            conn, reused = _get_conn(netloc, timeout)
        else:
            conn, reused = _Conn(netloc, timeout), False
        try:
            resp, keep = _roundtrip(conn, netloc, method, path, body,
                                    headers)
        except _StaleConnection as e:
            # retry ONLY when the pooled connection died before the
            # server can have processed the request (clean close before
            # the first response byte, or the send itself failing) —
            # never on timeouts or mid-response failures, which would
            # re-execute a request the server already ran (Go's
            # net/http draws the same line)
            conn.close()
            if not (reused and e.retryable) or attempt == 1:
                raise
            from seaweedfs_tpu_torch.stats.metrics import \
                HttpPoolStaleRetryCounter
            HttpPoolStaleRetryCounter.inc()
            reuse_ok = False
            continue
        except TimeoutError as e:
            # typed for retry classification: the peer may have run the
            # request, so this is never blind-replayed
            conn.close()
            raise RequestTimeout(
                f"{method} {netloc}{path}: {e or 'timed out'}") from e
        except OSError:
            conn.close()
            raise
        if keep and pooled:
            _put_conn(conn)
        else:
            conn.close()
        return resp
    raise RuntimeError("unreachable")


def retry_after_seconds(resp: "Response") -> float:
    """The Retry-After header as seconds (delta-seconds grammar; the
    HTTP-date form is not spoken on the cluster-internal plane). 0.0
    when absent or unparseable."""
    v = resp.header("retry-after")
    if not v:
        return 0.0
    try:
        return max(0.0, float(v))
    except ValueError:
        return 0.0


def classify(exc: BaseException) -> str:
    """Bucket a data-plane client error for retry decisions and
    metrics: 'deadline' | 'breaker' | 'busy' | 'timeout' | 'connect'
    | 'response' | 'other'."""
    if isinstance(exc, deadline.DeadlineExceeded):
        return "deadline"
    if isinstance(exc, breaker.BreakerOpen):
        return "breaker"
    if isinstance(exc, ServerBusy):
        # the peer answered (alive) and refused (not executed): safe
        # to replay once its Retry-After elapses
        return "busy"
    if isinstance(exc, (RequestTimeout, TimeoutError)):
        return "timeout"
    if isinstance(exc, ConnectError):
        return "connect"
    if isinstance(exc, _StaleConnection) and exc.retryable:
        # retryable=True is the class's own contract that no byte
        # reached the peer — connect-class, safe to replay
        return "connect"
    if isinstance(exc, ResponseError):
        return "response"
    if isinstance(exc, OSError):
        # raw socket errors surface at connect/reuse time; post-send
        # failures are wrapped in _StaleConnection/RequestTimeout above
        return "connect"
    return "other"


class _StaleConnection(ResponseError):
    """Connection-level failure. retryable=True means no response byte
    arrived AND the request cannot have been durably received (safe to
    replay on a fresh connection). Subclasses OSError so callers'
    pre-pooled-client `except OSError` error handling keeps catching
    connection-level failures."""

    def __init__(self, msg, retryable: bool = False):
        super().__init__(msg)
        self.retryable = retryable


def _roundtrip(conn: "_Conn", netloc: str, method: str, path: str,
               body: Optional[bytes],
               headers: Optional[dict]) -> Tuple[Response, bool]:
    buf = [f"{method} {path} HTTP/1.1\r\nHost: {netloc}\r\n"]
    has_len = False
    has_enc = False
    if headers:
        for k, v in headers.items():
            buf.append(f"{k}: {v}\r\n")
            kl = k.lower()
            if kl == "content-length":
                has_len = True
            elif kl == "accept-encoding":
                has_enc = True
    if not has_enc:
        # default to identity (this client never decompresses), but a
        # caller-supplied Accept-Encoding must win — the server parses
        # first-value-wins
        buf.append("Accept-Encoding: identity\r\n")
    if body is not None and not has_len:
        buf.append(f"Content-Length: {len(body)}\r\n")
    elif body is None and method in ("POST", "PUT"):
        buf.append("Content-Length: 0\r\n")
    buf.append("\r\n")
    msg = "".join(buf).encode("latin-1")
    if body:
        msg += body
    try:
        conn.sock.sendall(msg)
    except (BrokenPipeError, ConnectionResetError) as e:
        # the peer closed the idle pooled connection; nothing reached it
        raise _StaleConnection(str(e), retryable=True)

    rfile = conn.rfile
    try:
        line = rfile.readline(_MAX_LINE)
    except ConnectionResetError as e:
        # RST before any response byte on a reused connection is the
        # idle-close race (server dropped the conn as our bytes were in
        # flight); data-plane requests are idempotent by fid, so replay
        raise _StaleConnection(str(e), retryable=True)
    if not line:
        # clean close before any response byte: the server dropped the
        # idle keep-alive connection before our request landed
        raise _StaleConnection(netloc, retryable=True)
    try:
        proto, rest = line.split(None, 1)
        status = int(rest.split(None, 1)[0])
    except (ValueError, IndexError):
        raise _StaleConnection(f"bad status line {line!r}")
    if not proto.startswith(b"HTTP/"):
        raise _StaleConnection(f"bad proto {line!r}")

    hdrs = HeaderDict()
    # same parser as FastHandler.parse_request (first value wins);
    # shared so client and server header handling stay in lockstep
    err = parse_header_block(rfile, hdrs)
    if err is not None:
        raise _StaleConnection(f"bad header block ({err})")

    keep = proto != b"HTTP/1.0"
    conn_hdr = hdrs.get("connection", "").lower()
    if "close" in conn_hdr:
        keep = False
    elif proto == b"HTTP/1.0" and "keep-alive" in conn_hdr:
        keep = True

    # body framing: HEAD and 1xx/204/304 have none regardless of headers
    if method == "HEAD" or status < 200 or status in (204, 304):
        return Response(status, hdrs, b""), keep
    if hdrs.get("transfer-encoding", "").lower().endswith("chunked"):
        data = _read_chunked(rfile)
        return Response(status, hdrs, data), keep
    length = hdrs.get("content-length")
    if length is not None:
        try:
            n = int(length)
        except ValueError:
            raise _StaleConnection(f"bad Content-Length {length!r}")
        data = rfile.read(n) if n else b""
        if len(data) != n:
            raise _StaleConnection("short body")
        return Response(status, hdrs, data), keep
    # no framing: read to close (HTTP/1.0 style)
    data = rfile.read()
    return Response(status, hdrs, data), False


def _read_chunked(rfile) -> bytes:
    parts = []
    while True:
        line = rfile.readline(_MAX_LINE)
        if not line:
            raise _StaleConnection("truncated chunked body")
        try:
            size = int(line.split(b";", 1)[0].strip(), 16)
        except ValueError:
            raise _StaleConnection(f"bad chunk size {line!r}")
        if size == 0:
            # trailers until blank line
            while True:
                t = rfile.readline(_MAX_LINE)
                if t in (b"\r\n", b"\n", b""):
                    break
            return b"".join(parts)
        chunk = rfile.read(size)
        if len(chunk) != size:
            raise _StaleConnection("truncated chunk")
        parts.append(chunk)
        rfile.readline(_MAX_LINE)  # trailing CRLF


def _split(url: str) -> Tuple[str, str]:
    if url.startswith("http://"):
        url = url[7:]
    elif url.startswith("https://"):
        raise ValueError("https data path not supported by the pool")
    slash = url.find("/")
    if slash < 0:
        return url, "/"
    return url[:slash], url[slash:]
