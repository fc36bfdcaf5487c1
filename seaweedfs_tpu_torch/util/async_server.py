"""Selector-based async serving core (-serve.async), the counterpart of
``seaweedfs_tpu.util.async_server``.

Thread-per-connection (``util/http_server.TrackingHTTPServer``) parks one
thread on every keep-alive socket: 10k idle connections cost 10k
threads. The reference gets an event-driven data plane from Go's
netpoller; this module is the Python-side equivalent:

- ONE event loop (the role's listener thread calling serve_forever) owns
  every socket through a ``selectors`` poll: it accepts, reads, frames
  requests with a state-machine HTTP/1.1 parser (partial heads across
  recvs, keep-alive, pipelining, chunked bodies) and writes responses.
  A connection costs a few KB of buffer, not a thread.
- Framed requests dispatch to a bounded FanOutPool of workers (no
  thread until the first request) that run the same instrumented
  handler classes the threaded model runs: the do_* methods, the
  instrument_http_handler spans and metrics, X-Seaweed-Deadline and
  X-Seaweed-Trace adoption and the failpoints, so both models answer
  byte-identically and feed the same counters.
- GET bodies that resolve to a FileSpan (the volume read path's
  zero-copy seam) leave the process through os.sendfile: volume fd
  straight to socket, the payload never enters Python.
- Accept backpressure: past -serve.maxConns the listener leaves the
  poll (the accept queue, then the SYN backlog, absorbs the burst) and
  rejoins it as connections close.
- Keep-alive budget: past -serve.keepAliveBudget idle keep-alive
  connections, the least recently active idle one is closed. A response
  already promised keep-alive is never cut: the close lands between
  requests, where HTTP allows it.
- QoS at frame time: with ``-qos`` on, a tenant past its weighted share
  of -serve.maxConns is refused with the admission seam's 429 before a
  worker runs, and its idle keep-alives are reclaimed first.

Parse-level behaviour is byte-identical to the threaded model by
construction: once a head block is framed, the handler class's own
parse_request parses it over the buffered bytes, so the 400/414/431/505
error bytes, the close_connection rules and Expect: 100-continue come
from the one shared code path.

Concurrency contract: the loop thread owns all connection state except
the completion hand-off. Workers publish finished responses through
_complete(), which appends under _lock and wakes the loop through a
self-pipe; the loop is the only closer of connections, and a completion
racing a close is dropped with its file spans released.
"""

from __future__ import annotations

import errno
import io
import os
import selectors
import socket
import threading
from collections import OrderedDict, deque
from typing import Deque, Dict, List, Optional, Tuple

from seaweedfs_tpu_torch.util import wlog
from seaweedfs_tpu_torch.util.fanout import FanOutPool
from seaweedfs_tpu_torch.util.http_server import (
    _MAX_CHUNK_LINE, _MAX_LINE, BodyReader, FileSpan, is_chunked,
    parse_content_length)

log = wlog.logger("async_server")

DEFAULT_MAX_CONNS = 4096
DEFAULT_KEEPALIVE_BUDGET = 1024
DEFAULT_WORKERS = 16
# QoS seam: seaweedfs_tpu_torch.qos.configure() installs its manager here
# (reset() clears it). With it armed, -serve.maxConns / keep-alive
# budgets become WEIGHTED per-tenant budgets: an over-share tenant is
# refused at frame time — before a worker thread is burned — and its
# idle keep-alives are the first reclaimed. None (default) keeps every
# loop path one identity check away from unchanged.
_qos = None
# fraction of max_conns past which frame-time conn policing kicks in
# (below it there is no contention worth refusing anyone over)
_QOS_CONN_HIGH_WATER = 0.875
# most bytes buffered ahead of the current request before the loop
# stops reading a connection (aggressive pipeliners can't balloon RAM)
_PIPELINE_CAP = 262144
_RECV_SIZE = 65536
# Linux sendfile caps count near 2^31; stay page-aligned under it
_SENDFILE_MAX = 0x7FFFF000
_ACCEPT_BATCH = 64


class _ResponseWriter:
    """wfile stand-in for async-driven handlers: collects response
    bytes (and FileSpans) in order; the loop thread drains them to the
    socket. flush() is a no-op — everything is already 'sent' as far
    as the handler can observe, matching the threaded model's
    end-of-request flush."""

    __slots__ = ("chunks",)

    def __init__(self):
        self.chunks: List = []

    def write(self, data) -> int:
        if data:
            self.chunks.append(bytes(data))
        return len(data)

    def add_span(self, span: FileSpan) -> None:
        self.chunks.append(span)

    def take(self) -> List:
        out, self.chunks = self.chunks, []
        return out

    def flush(self) -> None:
        pass

    def close(self) -> None:
        pass


class _ChunkedScanner:
    """Framing-only scanner: finds where a chunked message body ENDS
    in the inbound stream. The raw (still-encoded) bytes are buffered
    and later decoded by BodyReader in the worker — the same decoder
    the threaded model runs, so the two models cannot disagree about
    a body's content."""

    __slots__ = ("_phase", "_remaining", "error")

    def __init__(self):
        self._phase = "size"   # size | data | trailer
        self._remaining = 0
        self.error = False

    def feed(self, buf: bytearray, start: int) -> Tuple[int, bool]:
        """Consume from buf[start:]; returns (new_start, done)."""
        i, n = start, len(buf)
        while i < n:
            if self._phase == "data":
                take = min(self._remaining, n - i)
                i += take
                self._remaining -= take
                if self._remaining:
                    break
                self._phase = "size"
                continue
            j = buf.find(b"\n", i)
            if j < 0:
                if n - i > _MAX_CHUNK_LINE:
                    self.error = True
                    return i, True
                break
            line = bytes(buf[i:j]).strip()
            i = j + 1
            if self._phase == "trailer":
                if not line:
                    return i, True
                continue
            if not line:      # CRLF between chunks
                continue
            try:
                size = int(line.split(b";", 1)[0].strip(), 16)
            except ValueError:
                self.error = True
                return i, True
            if size == 0:
                self._phase = "trailer"
            else:
                self._phase = "data"
                self._remaining = size + 2  # payload + trailing CRLF
        return i, False


# connection states (loop-thread-owned)
_ST_HEAD = 0    # accumulating/expecting a request head
_ST_BODY = 1    # head parsed, accumulating the body
_ST_BUSY = 2    # request dispatched to a worker
_ST_WRITE = 3   # response draining to the socket


class _Connection:
    """One accepted socket. All fields are owned by the loop thread
    except `pending`/`dead`, the worker->loop completion handoff,
    which the server's _lock guards."""

    __slots__ = ("sock", "fd", "addr", "inbuf", "body", "body_scan",
                 "body_remaining", "chunker", "shim", "out", "state",
                 "close_after", "eof", "read_on", "write_on",
                 "pending", "dead", "last_active", "expect_sent",
                 "tenant")

    def __init__(self, sock, addr):
        self.sock = sock
        self.fd = sock.fileno()
        self.addr = addr
        self.inbuf = bytearray()
        self.body = b""
        self.body_scan = 0            # scanner cursor into inbuf
        self.body_remaining = 0       # content-length mode
        self.chunker: Optional[_ChunkedScanner] = None
        self.shim = None
        self.out: Deque = deque()
        self.state = _ST_HEAD
        self.close_after = False
        self.eof = False
        self.read_on = False
        self.write_on = False
        self.pending: Optional[Tuple[List, bool]] = None  # guarded_by(server._lock)
        self.dead = False                                 # guarded_by(server._lock)
        self.last_active = 0.0
        self.expect_sent = False
        self.tenant = None   # QoS identity (set at first framed request)

    def drop_buffers(self) -> None:
        """Release FileSpans queued on a connection that will never
        drain (loop-side close)."""
        for item in self.out:
            if isinstance(item, FileSpan):
                item.close()
        self.out.clear()


class AsyncHTTPServer:
    """Drop-in for TrackingHTTPServer behind -serve.async: same
    construction shape, serve_forever()/shutdown()/server_close()
    contract, and handler classes — different machine underneath."""

    def __init__(self, server_address, RequestHandlerClass, role: str = "",
                 max_conns: int = 0, keepalive_budget: int = 0,
                 workers: int = 0):
        import time as _time
        self._time = _time
        self.handler_cls = RequestHandlerClass
        self.role = role or "server"
        self.max_conns = max_conns or DEFAULT_MAX_CONNS
        self.keepalive_budget = keepalive_budget or \
            DEFAULT_KEEPALIVE_BUDGET
        self._listener = socket.socket(socket.AF_INET,
                                       socket.SOCK_STREAM)
        self._listener.setsockopt(socket.SOL_SOCKET,
                                  socket.SO_REUSEADDR, 1)
        self._listener.bind(server_address)
        self._listener.listen(1024)
        self._listener.setblocking(False)
        self.server_address = self._listener.getsockname()
        self._selector = selectors.DefaultSelector()
        self._selector.register(self._listener, selectors.EVENT_READ,
                                ("accept", None))
        self._wake_r, self._wake_w = os.pipe()
        os.set_blocking(self._wake_r, False)
        os.set_blocking(self._wake_w, False)
        self._selector.register(self._wake_r, selectors.EVENT_READ,
                                ("wake", None))
        # zero threads until the first request (FanOutPool contract)
        self._pool = FanOutPool(workers or DEFAULT_WORKERS,
                                f"serve-{self.server_address[1]}")
        self._conns: Dict[int, _Connection] = {}
        self._idle: "OrderedDict[int, _Connection]" = OrderedDict()
        self._accepting = True
        self._lock = threading.Lock()
        self._completed: Deque[_Connection] = deque()  # guarded_by(self._lock)
        self._shutdown = False   # latch; loop polls it each pass
        self._done = threading.Event()
        self._done.set()   # not running yet
        self._closed = False
        from seaweedfs_tpu_torch.stats.metrics import (
            ServeConnectionsGauge, ServeSendfileBytesCounter,
            ServeShedCounter)
        self._conns_gauge = ServeConnectionsGauge.labels(self.role)
        self._sendfile_counter = ServeSendfileBytesCounter.labels(
            self.role)
        self._shed_accept = ServeShedCounter.labels(self.role, "accept")
        self._shed_idle = ServeShedCounter.labels(self.role,
                                                  "keepalive")
        self._shed_qos = ServeShedCounter.labels(self.role, "qos")

    # -- lifecycle -----------------------------------------------------------

    def serve_forever(self, poll_interval: float = 0.5) -> None:
        self._done.clear()
        try:
            while not self._shutdown:
                self._service_once(poll_interval)
        except OSError:
            # selector/listener torn down under us mid-shutdown
            if not self._shutdown and not self._closed:
                raise
        finally:
            self._done.set()

    def _service_once(self, timeout: Optional[float]) -> None:
        events = self._selector.select(timeout)
        for key, mask in events:
            kind, conn = key.data
            if kind == "accept":
                self._on_accept()
            elif kind == "wake":
                try:
                    os.read(self._wake_r, 4096)
                except OSError:
                    pass
            elif self._conns.get(conn.fd) is conn:
                # IDENTITY check, not membership: an fd freed by a
                # close earlier in this batch can be reused by an
                # accept in the same batch — a stale event must not
                # touch the new tenant
                if mask & selectors.EVENT_WRITE:
                    self._on_writable(conn)
                if mask & selectors.EVENT_READ and \
                        self._conns.get(conn.fd) is conn:
                    self._on_readable(conn)
        self._handle_completions()

    def shutdown(self) -> None:
        self._shutdown = True
        self._wake()
        self._done.wait(timeout=5.0)

    def server_close(self) -> None:
        self._shutdown = True
        self._closed = True
        self._wake()
        self._done.wait(timeout=5.0)
        for conn in list(self._conns.values()):
            self._close_conn(conn)
        try:
            self._selector.close()
        except OSError:
            pass
        try:
            self._listener.close()
        except OSError:
            pass
        for fd in (self._wake_r, self._wake_w):
            try:
                os.close(fd)
            except OSError:
                pass
        self._pool.stop()

    def _wake(self) -> None:
        try:
            os.write(self._wake_w, b"\x00")
        except OSError:
            pass  # pipe full (wake already pending) or closed

    # -- accept / close ------------------------------------------------------

    def _on_accept(self) -> None:
        for _ in range(_ACCEPT_BATCH):
            try:
                sock, addr = self._listener.accept()
            except (BlockingIOError, InterruptedError):
                return
            except OSError:
                return
            sock.setblocking(False)
            try:
                sock.setsockopt(socket.IPPROTO_TCP,
                                socket.TCP_NODELAY, 1)
            except OSError:
                pass
            conn = _Connection(sock, addr)
            conn.last_active = self._time.monotonic()
            self._conns[conn.fd] = conn
            self._conns_gauge.inc()
            self._selector.register(sock, selectors.EVENT_READ,
                                    ("conn", conn))
            conn.read_on = True
            self._mark_idle(conn)
            if len(self._conns) >= self.max_conns and self._accepting:
                # backpressure: stop accepting; the kernel backlog
                # holds the burst until connections drain
                self._selector.unregister(self._listener)
                self._accepting = False
                self._shed_accept.inc()
                return

    def _close_conn(self, conn: _Connection) -> None:
        if self._conns.get(conn.fd) is not conn:
            return   # already closed (fd possibly reused — leave it)
        del self._conns[conn.fd]
        if conn.tenant is not None:
            mgr = _qos
            if mgr is not None:
                mgr.conn_closed(conn.tenant)
            conn.tenant = None
        with self._lock:
            conn.dead = True
            pending = conn.pending
            conn.pending = None
        if pending is not None:
            for item in pending[0]:
                if isinstance(item, FileSpan):
                    item.close()
        if self._idle.get(conn.fd) is conn:
            del self._idle[conn.fd]
        conn.drop_buffers()
        try:
            self._selector.unregister(conn.sock)
        except (KeyError, ValueError, OSError):
            pass
        try:
            conn.sock.close()
        except OSError:
            pass
        self._conns_gauge.dec()
        if not self._accepting and not self._closed and \
                len(self._conns) < self.max_conns:
            self._selector.register(self._listener,
                                    selectors.EVENT_READ,
                                    ("accept", None))
            self._accepting = True

    # -- idle / keep-alive budget --------------------------------------------

    def _mark_idle(self, conn: _Connection) -> None:
        self._idle[conn.fd] = conn
        self._idle.move_to_end(conn.fd)
        while len(self._idle) > self.keepalive_budget:
            victim = None
            if _qos is not None:
                # weighted keep-alive budget: reclaim from the tenant
                # furthest past its share first, LRU within the tenant
                victim = self._pick_idle_victim(_qos)
            if victim is None:
                _fd, victim = self._idle.popitem(last=False)
            else:
                del self._idle[victim.fd]
            self._shed_idle.inc()
            self._close_conn(victim)

    def _pick_idle_victim(self, mgr) -> Optional[_Connection]:
        """The LRU idle connection of the tenant most over its weighted
        share of the keep-alive budget; None = nobody is over (plain
        LRU applies). Only runs while the budget is exceeded, so the
        scan is bounded by the budget itself."""
        counts: Dict[str, int] = {}
        for c in self._idle.values():
            if c.tenant is not None:
                counts[c.tenant] = counts.get(c.tenant, 0) + 1
        worst = mgr.most_over_share(counts, self.keepalive_budget)
        if worst is None:
            return None
        for c in self._idle.values():   # insertion order = LRU first
            if c.tenant == worst:
                return c
        return None

    def _mark_active(self, conn: _Connection) -> None:
        self._idle.pop(conn.fd, None)
        conn.last_active = self._time.monotonic()

    # -- read side -----------------------------------------------------------

    def _set_read(self, conn: _Connection, on: bool) -> None:
        if conn.read_on == on or conn.eof and on:
            return
        conn.read_on = on
        self._update_interest(conn)

    def _set_write(self, conn: _Connection, on: bool) -> None:
        if conn.write_on == on:
            return
        conn.write_on = on
        self._update_interest(conn)

    def _update_interest(self, conn: _Connection) -> None:
        mask = (selectors.EVENT_READ if conn.read_on else 0) | \
               (selectors.EVENT_WRITE if conn.write_on else 0)
        try:
            if mask:
                self._selector.modify(conn.sock, mask, ("conn", conn))
            else:
                self._selector.unregister(conn.sock)
                # re-register on next interest change
                conn.read_on = conn.write_on = False
        except (KeyError, ValueError):
            if mask:
                self._selector.register(conn.sock, mask,
                                        ("conn", conn))
        except OSError:
            self._close_conn(conn)

    def _on_readable(self, conn: _Connection) -> None:
        try:
            data = conn.sock.recv(_RECV_SIZE)
        except (BlockingIOError, InterruptedError):
            return
        except OSError:
            self._close_conn(conn)
            return
        if not data:
            # peer finished sending; it may still be reading our
            # response (half-close), so a BUSY/WRITE connection lives
            # until its response drains. A head or body that hasn't
            # completed never will (no more bytes can arrive) — close
            # NOW, or a connect/partial-send/FIN loop would leak
            # connections that no budget can reclaim (they left the
            # idle LRU on their first byte) and eventually wedge
            # accept at max_conns.
            conn.eof = True
            self._set_read(conn, False)
            if conn.state in (_ST_HEAD, _ST_BODY):
                self._close_conn(conn)
            return
        conn.inbuf += data
        self._mark_active(conn)
        self._advance(conn)

    def _advance(self, conn: _Connection) -> None:
        """Run the per-connection state machine as far as the buffered
        bytes allow (requests execute strictly one at a time per
        connection; pipelined followers wait in inbuf)."""
        while True:
            if conn.state == _ST_HEAD:
                if not self._try_head(conn):
                    break
            elif conn.state == _ST_BODY:
                if not self._try_body(conn):
                    break
            else:
                # busy/writing: just watch the pipeline cap
                if len(conn.inbuf) > _PIPELINE_CAP:
                    self._set_read(conn, False)
                break

    # -- head parse ----------------------------------------------------------

    def _make_shim(self, conn: _Connection):
        shim = self.handler_cls.__new__(self.handler_cls)
        shim.server = self
        shim.client_address = conn.addr
        shim.connection = conn.sock
        shim.close_connection = True
        shim.requestline = ""
        shim.request_version = ""
        shim.command = ""
        shim.wfile = _ResponseWriter()
        shim.async_conn = conn
        return shim

    def _try_head(self, conn: _Connection) -> bool:
        """Parse one request head out of inbuf; False = need bytes."""
        buf = conn.inbuf
        nl = buf.find(b"\n")
        if nl < 0:
            if len(buf) > _MAX_LINE:
                self._head_error(conn, 414)
            return False
        if nl + 1 > _MAX_LINE:
            self._head_error(conn, 414)
            return False
        # a bare (CR)LF where a request line should be: the threaded
        # model's parse_request returns False silently and closes
        if not bytes(buf[:nl]).strip():
            self._close_conn(conn)
            return False
        # find end of head: a line boundary followed by a blank line
        end = -1
        for pat in (b"\n\r\n", b"\n\n"):
            idx = buf.find(pat, nl)
            if idx >= 0 and (end < 0 or idx + len(pat) < end):
                end = idx + len(pat)
        if end < 0:
            # incomplete: bound the damage a never-ending header block
            # can do (any complete line is already ≤ _MAX_LINE or the
            # parse below would reject it; this caps the total block)
            if len(buf) > _MAX_LINE * 4:
                self._head_error(conn, 431)
            return False
        head = bytes(buf[:end])
        del buf[:end]
        self._mark_active(conn)
        line_end = head.find(b"\n") + 1
        shim = self._make_shim(conn)
        shim.raw_requestline = head[:line_end]
        shim.rfile = io.BufferedReader(io.BytesIO(head[line_end:]))
        ok = False
        try:
            # the handler class's OWN parser: status codes, error
            # bodies and close_connection rules come from the single
            # shared implementation
            ok = shim.parse_request()
        except Exception:
            log.exception("request parse failed (%s)", self.role)
            ok = False
        early = shim.wfile.take()   # parse errors, 100-continue
        if early:
            conn.out.extend(self._as_wire(early))
        if not ok:
            conn.close_after = True
            conn.state = _ST_WRITE
            self._start_write(conn)
            return False
        if _qos is not None and self._frame_shed(conn, shim):
            return False
        conn.shim = shim
        conn.expect_sent = bool(early)
        shim._expect_sent = conn.expect_sent
        if early:
            # the interim 100 Continue must reach a waiting client
            # BEFORE we sit in _ST_BODY expecting its payload — a
            # compliant Expect client would otherwise deadlock with us
            if self._send_items(conn.sock, conn.out):
                self._close_conn(conn)
                return False
            if conn.out:
                self._set_write(conn, True)
        if is_chunked(shim.headers):
            conn.chunker = _ChunkedScanner()
            conn.body_scan = 0
            conn.state = _ST_BODY
        else:
            conn.body_remaining = parse_content_length(shim.headers)
            conn.state = _ST_BODY
        return True

    def _frame_shed(self, conn: _Connection, shim) -> bool:
        """LOOP-thread QoS connection policing, run per framed request
        before worker handoff: account the connection to its tenant,
        and — once the process is near the conn cap — refuse a tenant
        past its weighted share of -serve.maxConns with the same
        429/503 + Retry-After reply the admission seam writes. True =
        shed (reply queued, connection closing)."""
        mgr = _qos
        name = mgr.state_of(mgr.resolve(shim.headers, shim.path)).name
        if name != conn.tenant:
            if conn.tenant is not None:
                mgr.conn_closed(conn.tenant)
            conn.tenant = name
            mgr.conn_opened(name)
        if len(self._conns) < self.max_conns * _QOS_CONN_HIGH_WATER:
            return False
        if not mgr.conn_over_share(name, self.max_conns):
            return False
        mgr.shed_reply(shim, self.role, name, 1.0, "conns")
        self._shed_qos.inc()
        conn.inbuf.clear()
        conn.out.extend(self._as_wire(shim.wfile.take()))
        conn.close_after = True
        conn.state = _ST_WRITE
        self._start_write(conn)
        return True

    def _head_error(self, conn: _Connection, code: int) -> None:
        """Pre-parse protocol error: same bytes the threaded model's
        handle_one_request would produce (requestline cleared)."""
        shim = self._make_shim(conn)
        try:
            if code == 414:
                shim.send_error(414)
            else:
                shim.send_error(code, "Header line too long")
        except Exception:
            log.exception("error reply failed (%s)", self.role)
        conn.inbuf.clear()
        conn.out.extend(self._as_wire(shim.wfile.take()))
        conn.close_after = True
        conn.state = _ST_WRITE
        self._start_write(conn)

    # -- body ----------------------------------------------------------------

    def _try_body(self, conn: _Connection) -> bool:
        buf = conn.inbuf
        if conn.chunker is not None:
            new_scan, done = conn.chunker.feed(buf, conn.body_scan)
            conn.body_scan = new_scan
            if conn.chunker.error:
                # malformed chunking: the threaded model's BodyReader
                # raises mid-handler and the connection dies without a
                # response; die the same way
                self._close_conn(conn)
                return False
            if not done:
                if len(buf) > _PIPELINE_CAP and conn.body_scan == 0:
                    pass  # still consuming; cap applies to follower bytes
                return False
            raw = bytes(buf[:conn.body_scan])
            del buf[:conn.body_scan]
            conn.body_scan = 0
            conn.chunker = None
            self._dispatch(conn, raw)
            return False
        need = conn.body_remaining
        if len(buf) < need:
            return False
        raw = bytes(buf[:need])
        del buf[:need]
        conn.body_remaining = 0
        self._dispatch(conn, raw)
        return False

    # -- worker dispatch -----------------------------------------------------

    def _dispatch(self, conn: _Connection, body: bytes) -> None:
        shim, conn.shim = conn.shim, None
        conn.state = _ST_BUSY
        if len(conn.inbuf) > _PIPELINE_CAP:
            self._set_read(conn, False)
        self._pool.submit(self._run_request, conn, shim, body)

    def _run_request(self, conn: _Connection, shim, body: bytes) -> None:
        """WORKER thread: run the instrumented handler exactly as the
        threaded model's handle_one_request would."""
        raw = io.BufferedReader(io.BytesIO(body))
        if body:
            shim.rfile = BodyReader(raw, shim.headers)
        else:
            shim.rfile = raw
        ok = True
        try:
            mname = "do_" + shim.command
            if not hasattr(shim, mname):
                shim.send_error(
                    501, "Unsupported method (%r)" % shim.command)
            else:
                getattr(shim, mname)()
        except Exception:
            # mirror of socketserver handle_error + finish(): the
            # partially-buffered response still flushes, then the
            # connection closes
            ok = False
            log.exception("handler failed: %s %s (%s)", shim.command,
                          getattr(shim, "path", "?"), self.role)
        self._complete(conn, shim.wfile.take(),
                       close=shim.close_connection or not ok)

    def _complete(self, conn: _Connection, chunks: List,
                  close: bool) -> None:
        """WORKER -> loop handoff; the only cross-thread entry.

        Hand-off only, as in the JAX package, whose worker-side direct
        send measured slower on a 2-core CPU VM: sending from the loop
        lets it batch completions per poll pass and frees the worker for
        the next request instead of serializing both threads through the
        socket."""
        dropped = None
        with self._lock:
            if conn.dead:
                dropped = chunks
            else:
                conn.pending = (self._as_wire(chunks), close)
                self._completed.append(conn)
        if dropped is not None:
            for item in dropped:
                if isinstance(item, FileSpan):
                    item.close()
            return
        self._wake()

    def _handle_completions(self) -> None:
        while True:
            with self._lock:
                if not self._completed:
                    return
                conn = self._completed.popleft()
                pending, conn.pending = conn.pending, None
            if pending is None or self._conns.get(conn.fd) is not conn:
                continue
            chunks, close = pending
            conn.out.extend(chunks)   # _complete stored wire form
            conn.close_after = conn.close_after or close
            conn.state = _ST_WRITE
            self._start_write(conn)

    @staticmethod
    def _as_wire(chunks: List) -> List:
        """memoryview discipline: byte chunks become sliceable views
        so partial sends never re-copy the tail."""
        return [c if isinstance(c, FileSpan) else memoryview(c)
                for c in chunks]

    # -- write side ----------------------------------------------------------

    def _start_write(self, conn: _Connection) -> None:
        if self._write_some(conn):
            self._set_write(conn, True)

    def _on_writable(self, conn: _Connection) -> None:
        # a drained reply may have closed the connection (close_after, or
        # the peer's FIN): its socket is gone, and re-registering it would
        # raise out of the loop (the JAX core's loop dies there)
        if not self._write_some(conn) and self._conns.get(conn.fd) is conn:
            self._set_write(conn, False)

    def _send_items(self, sock, items: Deque) -> bool:
        """Push items (memoryviews / FileSpans) non-blocking, popping
        the deque in place as they complete; returns True on a socket
        error."""
        error = False
        try:
            while items:
                item = items[0]
                if isinstance(item, FileSpan):
                    sent = os.sendfile(sock.fileno(), item.fd,
                                       item.offset,
                                       min(item.length, _SENDFILE_MAX))
                    if sent == 0:
                        raise OSError(errno.EIO,
                                      "file span truncated mid-send")
                    self._sendfile_counter.inc(sent)
                    item.offset += sent
                    item.length -= sent
                    if item.length == 0:
                        item.close()
                        items.popleft()
                    continue
                # MSG_NOSIGNAL: a peer's hang-up must not kill the
                # process where SIGPIPE has its default action
                sent = sock.send(item, socket.MSG_NOSIGNAL)
                if sent < len(item):
                    items[0] = item[sent:]
                else:
                    items.popleft()
        except (BlockingIOError, InterruptedError):
            pass
        except OSError:
            error = True
        return error

    def _write_some(self, conn: _Connection) -> bool:
        """Drain conn.out; True = more to write (want EVENT_WRITE)."""
        if self._send_items(conn.sock, conn.out):
            self._close_conn(conn)
            return False
        if conn.out:
            return True
        if conn.state == _ST_WRITE:
            self._finish_response(conn)
        return False

    def _finish_response(self, conn: _Connection) -> None:
        if conn.close_after or (conn.eof and not conn.inbuf):
            self._close_conn(conn)
            return
        conn.state = _ST_HEAD
        if not conn.read_on and not conn.eof and \
                len(conn.inbuf) <= _PIPELINE_CAP:
            self._set_read(conn, True)
        if conn.inbuf:
            self._advance(conn)        # pipelined follower
        if self._conns.get(conn.fd) is not conn:
            return
        if conn.eof and conn.state in (_ST_HEAD, _ST_BODY):
            # the peer already FIN'd: an unfinished follower can
            # never complete, an idle conn is simply done
            self._close_conn(conn)
        elif conn.state == _ST_HEAD and not conn.inbuf:
            self._mark_idle(conn)
