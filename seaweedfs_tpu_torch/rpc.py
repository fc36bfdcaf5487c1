"""The cluster's RPC transport on the standard library.

The JAX package carries its control plane on grpcio; the port keeps that
contract (services, methods, message names and fields, status codes, the
port at HTTP port + 10000, "stream break == node death") on plain TCP
sockets, so it runs where neither grpcio nor protobuf is installed.

Wire format: every frame is ``kind (u8) | length (u32, big-endian) |
payload``. A call is one connection's exclusive use:

    client -> server   HEAD (timeout f64, method path[, metadata]), MSG*, END
    server -> client   MSG*, STATUS (code u8, details)

Call metadata (gRPC's invocation metadata: the QoS tenant and the cluster
trace context) rides the HEAD after the path, one ``\nkey:value`` entry
each; a call without metadata sends the bare path.

STATUS is always last. A client that gives up (cancel, deadline) closes
its socket; the server then sees end-of-file, its request iterator ends
and ``context.is_active()`` turns false. A stopped server closes every
connection, and the client's call fails with UNAVAILABLE. Unary and
server-streaming calls return their connection to a per-target pool when
they end cleanly; calls with a request stream never reuse one.

Conventions kept from the JAX package's ``rpc.py``: ``GRPC_PORT_OFFSET``,
``grpc_address``, ``make_server``, ``generic_handler``, ``make_stub``
(one cached stub and connection pool per target), ``close_channels``,
``set_server_credentials`` and ``set_channel_credentials``, the
``rpc.call`` failpoint and ambient-deadline seams on every outbound call,
the x-seaweed-trace and x-seaweed-tenant metadata forwarded when cluster
tracing or QoS is on, and ``stats.metrics.instrument_grpc_method`` around
every servicer method.

Mutual TLS (``security/tls.py``): with server credentials set, a new
connection's handshake runs on that connection's own thread, never on the
accept loop, so a slow or plaintext client stalls nothing but itself;
with channel credentials set, every new client connection is wrapped
after its connect. Plaintext is the default, as in the JAX package.
"""

from __future__ import annotations

import enum
import logging
import select
import socket
import ssl
import struct
import threading
import time
from typing import Dict, List, Optional

from seaweedfs_tpu_torch.resilience import deadline as _deadline
from seaweedfs_tpu_torch.resilience import failpoint as _failpoint
from seaweedfs_tpu_torch.stats import cluster_trace as _ctrace

log = logging.getLogger(__name__)

GRPC_PORT_OFFSET = 10000
# the JAX package's channels allow 64 MiB messages; a frame adds a little
MAX_FRAME = (64 << 20) + 4096
CONNECT_TIMEOUT_S = 5.0
HANDSHAKE_TIMEOUT_S = 5.0

HEAD, MSG, END, STATUS = 1, 2, 3, 4

# a peer's hang-up must fail the call, never end the process: with
# MSG_NOSIGNAL a send to a closed socket is an OSError (EPIPE) even where
# SIGPIPE is not ignored (libfuse's signal teardown restores its default
# action, which kills). grpcio's transport sends the same way.
_SEND_FLAGS = getattr(socket, "MSG_NOSIGNAL", 0)

# QoS tenant propagation seam: qos.configure() installs the tenant
# ContextVar here (reset() clears it) so outbound stubs forward the
# ambient tenant as x-seaweed-tenant metadata. None, the default, keeps
# invoke() one identity check away from the plain path.
_qos_tenant = None
_QOS_TENANT_KEY = "x-seaweed-tenant"
_HDR = struct.Struct(">BI")


class StatusCode(enum.Enum):
    """gRPC's status codes, by the same names and numbers."""
    OK = 0
    CANCELLED = 1
    UNKNOWN = 2
    INVALID_ARGUMENT = 3
    DEADLINE_EXCEEDED = 4
    NOT_FOUND = 5
    ALREADY_EXISTS = 6
    PERMISSION_DENIED = 7
    RESOURCE_EXHAUSTED = 8
    FAILED_PRECONDITION = 9
    ABORTED = 10
    OUT_OF_RANGE = 11
    UNIMPLEMENTED = 12
    INTERNAL = 13
    UNAVAILABLE = 14
    DATA_LOSS = 15
    UNAUTHENTICATED = 16


class RpcError(Exception):
    """A call that ended with a status other than OK."""

    def __init__(self, code: StatusCode, details: str = ""):
        super().__init__(f"{code.name}: {details}")
        self._code = code
        self._details = details

    def code(self) -> StatusCode:
        return self._code

    def details(self) -> str:
        return self._details


class _Abort(Exception):
    def __init__(self, code: StatusCode, details: str):
        super().__init__(details)
        self.code = code
        self.details = details


def grpc_address(url: str) -> str:
    """Map an HTTP "host:port" to its RPC sibling "host:port+10000"."""
    if "//" in url:
        url = url.split("//", 1)[1]
    host, sep, port = url.rpartition(":")
    if not sep or not port.isdigit():
        raise ValueError(f"expected host:port, got {url!r}")
    return f"{host}:{int(port) + GRPC_PORT_OFFSET}"


def peer_ip(context, default: str = "127.0.0.1") -> str:
    """The client's IP from a servicer context (``_Context.peer()``'s
    "host:port"; gRPC's "ipv4:host:port" form is read too)."""
    peer = context.peer() or ""
    if peer.startswith(("ipv4:", "ipv6:")):
        peer = peer.split(":", 1)[1]
    host = peer.rsplit(":", 1)[0] if ":" in peer else ""
    return host.strip("[]") or default


def _split(target: str):
    host, _, port = target.rpartition(":")
    return host or "127.0.0.1", int(port)


# process-wide TLS (security/tls.py configure_process_tls); None is
# plaintext, as the reference runs without security.toml's [grpc.*]
_server_context: Optional[ssl.SSLContext] = None
_client_context: Optional[ssl.SSLContext] = None


def set_server_credentials(ctx: Optional[ssl.SSLContext]) -> None:
    """Connections accepted from now on handshake with ``ctx`` (None:
    plaintext)."""
    global _server_context
    _server_context = ctx


def set_channel_credentials(ctx: Optional[ssl.SSLContext]) -> None:
    """Connections dialled from now on handshake with ``ctx`` (None:
    plaintext); every pooled connection is dropped, so none is reused
    under the old credentials."""
    global _client_context
    _client_context = ctx
    close_channels()


# -- framing -------------------------------------------------------------------


class _Conn:
    """One socket and its receive buffer; frames in and out.

    Under TLS the socket runs non-blocking: one SSL object must never be
    read and written by two threads at once (a request stream's pump
    thread sends while the caller receives), so every SSL call holds
    ``_io`` and never waits inside it; the waits are ``select`` calls
    outside the lock, bounded by the timeout ``settimeout`` set."""

    def __init__(self, sock: socket.socket):
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self.sock = sock
        self._buf = bytearray()
        self.eof = False
        self.closed = False
        self._io: Optional[threading.Lock] = None   # set by start_tls
        self._timeout: Optional[float] = None      # TLS waits only

    def start_tls(self, ctx: ssl.SSLContext, server_side: bool,
                  server_hostname: Optional[str] = None,
                  timeout: float = HANDSHAKE_TIMEOUT_S) -> None:
        """Run the TLS handshake (bounded by ``timeout``) and carry the
        connection's frames over it. Raises OSError (ssl.SSLError,
        socket.timeout) or ValueError (a certificate error) on failure;
        the socket is closed then."""
        self.sock.settimeout(timeout)
        tls = ctx.wrap_socket(self.sock, server_side=server_side,
                              server_hostname=server_hostname)
        tls.settimeout(0.0)
        self.sock = tls
        self._io = threading.Lock()

    def settimeout(self, timeout: Optional[float]) -> None:
        if self._io is None:
            self.sock.settimeout(timeout)
        else:
            self._timeout = timeout

    def _tls(self, op, *args):
        """One non-blocking SSL call, retried after a wait outside the
        lock until it completes or the timeout passes."""
        deadline = None if self._timeout is None \
            else time.monotonic() + self._timeout
        while True:
            with self._io:
                try:
                    return op(*args)
                except ssl.SSLWantReadError:
                    write = False
                except ssl.SSLWantWriteError:
                    write = True
            left = None if deadline is None \
                else deadline - time.monotonic()
            if left is not None and left <= 0:
                raise socket.timeout("timed out")
            try:
                ready = select.select([] if write else [self.sock],
                                      [self.sock] if write else [], [], left)
            except ValueError:          # closed under us
                raise OSError("connection closed") from None
            if not (ready[0] or ready[1]):
                raise socket.timeout("timed out")

    def _sendall(self, data) -> None:
        if self._io is None:
            self.sock.sendall(data, _SEND_FLAGS)
            return
        view = memoryview(data)
        while view:
            view = view[self._tls(self.sock.send, view):]

    def _recv_into(self, view) -> int:
        if self._io is None:
            return self.sock.recv_into(view)
        return self._tls(self.sock.recv_into, view)

    def send(self, *frames) -> None:
        """(kind, payload) frames in one write when they are small. A call
        has one sender at a time (the caller, or a streaming call's pump
        thread after HEAD), so no lock."""
        parts = []
        for kind, payload in frames:
            parts.append(_HDR.pack(kind, len(payload)))
            parts.append(payload)
        if sum(len(p) for p in parts) < 65536:
            self._sendall(b"".join(parts))
        else:
            for p in parts:
                if p:
                    self._sendall(p)

    def _read_some(self) -> None:
        data = self.sock.recv(1 << 16) if self._io is None \
            else self._tls(self.sock.recv, 1 << 16)
        if not data:
            self.eof = True
        self._buf += data

    def recv(self):
        """(kind, payload), or None at end-of-file."""
        buf = self._buf
        while len(buf) < _HDR.size:
            if self.eof:
                return None
            self._read_some()
        kind, n = _HDR.unpack_from(buf)
        if not HEAD <= kind <= STATUS:
            # not this protocol (a TLS ClientHello starts 0x16): end the
            # connection now, not after waiting for a bogus length
            raise OSError(f"rpc frame of unknown kind {kind}")
        if n > MAX_FRAME:
            raise OSError(f"rpc frame of {n} bytes exceeds the limit")
        want = _HDR.size + n
        if len(buf) < want and n >= 1 << 16:
            # a large payload lands straight in its own buffer
            payload = bytearray(n)
            have = len(buf) - _HDR.size
            payload[:have] = buf[_HDR.size:]
            del buf[:]
            view = memoryview(payload)
            while have < n:
                got = self._recv_into(view[have:])
                if not got:
                    self.eof = True
                    return None
                have += got
            return kind, bytes(payload)
        while len(buf) < want:
            if self.eof:
                return None
            self._read_some()
        payload = bytes(buf[_HDR.size:want])
        del buf[:want]
        return kind, payload

    def fill_nowait(self) -> None:
        """Take in whatever the socket holds without blocking; notes a
        hang-up in ``eof``. Under TLS the SSL object may hold decrypted
        bytes that ``select`` cannot see, so it is read directly."""
        if self._io is not None:
            while not self.eof and not self.closed:
                with self._io:
                    try:
                        data = self.sock.recv(1 << 16)
                    except (ssl.SSLWantReadError, ssl.SSLWantWriteError):
                        return
                    except (OSError, ValueError):
                        data = b""
                if not data:
                    self.eof = True
                self._buf += data
            return
        while not self.eof and not self.closed:
            try:
                r, _, _ = select.select([self.sock], [], [], 0)
                if not r:
                    return
                self._read_some()
            except (OSError, ValueError):
                self.eof = True

    def idle_unusable(self) -> bool:
        """For a pooled connection between calls: anything readable means
        the server hung up (or broke framing), so it is not reused."""
        self.fill_nowait()
        return self.closed or self.eof or bool(self._buf)

    def close(self) -> None:
        self.closed = True
        # close() runs whatever shutdown() raised (an SSLSocket's too)
        for fn in (lambda: self.sock.shutdown(socket.SHUT_RDWR),
                   self.sock.close):
            try:
                fn()
            except (OSError, ValueError):
                pass


def _status_payload(code: StatusCode, details: str) -> bytes:
    return bytes([code.value]) + details.encode("utf-8", "replace")


def _parse_status(payload: bytes) -> RpcError:
    return RpcError(StatusCode(payload[0]),
                    payload[1:].decode("utf-8", "replace"))


# -- client --------------------------------------------------------------------

_pool_lock = threading.Lock()
_pools: Dict[str, List[_Conn]] = {}  # guarded_by(_pool_lock)
_stub_cache: Dict[tuple, object] = {}  # guarded_by(_pool_lock, writes)
_generation = 0  # guarded_by(_pool_lock, writes)


def _checkout(target: str, timeout: Optional[float]) -> _Conn:
    while True:
        with _pool_lock:
            idle = _pools.get(target)
            conn = idle.pop() if idle else None
        if conn is None:
            break
        if not conn.idle_unusable():
            return conn
        conn.close()            # the server hung up while it sat idle
    connect = CONNECT_TIMEOUT_S if timeout is None \
        else max(0.001, min(timeout, CONNECT_TIMEOUT_S))
    try:
        sock = socket.create_connection(_split(target), timeout=connect)
    except socket.timeout:
        raise RpcError(StatusCode.UNAVAILABLE,
                       f"connect to {target} timed out") from None
    except OSError as e:
        raise RpcError(StatusCode.UNAVAILABLE,
                       f"cannot connect to {target}: {e}") from None
    conn = _Conn(sock)
    ctx = _client_context
    if ctx is not None:
        try:
            conn.start_tls(ctx, server_side=False,
                           server_hostname=_split(target)[0],
                           timeout=connect)
        except (OSError, ValueError) as e:
            conn.close()
            raise RpcError(StatusCode.UNAVAILABLE,
                           f"TLS handshake with {target} failed: {e}") \
                from None
    return conn


def _checkin(target: str, conn: _Conn) -> None:
    if conn.closed:
        return
    with _pool_lock:
        _pools.setdefault(target, []).append(conn)


def close_channels() -> None:
    """Close every pooled connection and forget the stubs."""
    global _generation
    with _pool_lock:
        conns = [c for idle in _pools.values() for c in idle]
        _pools.clear()
        _stub_cache.clear()
        _generation += 1
    for c in conns:
        c.close()


class _Call:
    """One call in flight on a client connection."""

    def __init__(self, target: str, path: str, resp_cls,
                 timeout: Optional[float], reuse: bool,
                 metadata: str = ""):
        self.target = target
        self.path = path
        self.metadata = metadata
        self.resp_cls = resp_cls
        self.deadline = None if timeout is None \
            else time.monotonic() + timeout
        self.reuse = reuse
        self.cancelled = False
        self.done = False
        self.conn = _checkout(target, timeout)
        self._sender: Optional[threading.Thread] = None

    def _remaining(self) -> Optional[float]:
        if self.deadline is None:
            return None
        left = self.deadline - time.monotonic()
        if left <= 0:
            raise socket.timeout()
        return left

    def start(self, requests, streaming: bool) -> None:
        t = -1.0 if self.deadline is None else \
            max(0.0, self.deadline - time.monotonic())
        try:
            self.conn.settimeout(self._remaining())
            head = (HEAD, struct.pack(">d", t) +
                    (self.path + self.metadata).encode())
            if not streaming:
                self.conn.send(head, (MSG, requests.SerializeToString()),
                               (END, b""))
                return
            self.conn.send(head)
        except (OSError, socket.timeout) as e:
            self._fail(e)
        # the request stream is drained on a thread of its own, as gRPC
        # does: the caller may block on responses while the iterator
        # blocks between requests (a heartbeat's pulse)
        # lint: thread-ok(request-stream pump of one call; a fresh context would drop nothing the peer reads)
        self._sender = threading.Thread(
            target=self._pump, args=(requests,),
            name=f"rpc-send-{self.path.rsplit('/', 1)[-1]}", daemon=True)
        self._sender.start()

    def _pump(self, requests) -> None:
        try:
            for req in requests:
                if self.cancelled or self.done:
                    return
                self.conn.send((MSG, req.SerializeToString()))
            if not (self.cancelled or self.done):
                self.conn.send((END, b""))
        except OSError:
            pass                 # the receive side reports the broken call
        except Exception:  # noqa: BLE001 - the request iterator failed
            # gRPC cancels a call whose request iterator raises: close the
            # connection, so the receive side and the server see it end
            log.exception("rpc %s: request iterator failed", self.path)
            self.cancelled = True
            self.conn.close()

    def _fail(self, e: BaseException):
        self.done = True
        self.conn.close()
        if self.cancelled:
            raise RpcError(StatusCode.CANCELLED, "call cancelled") from None
        if isinstance(e, socket.timeout):
            raise RpcError(StatusCode.DEADLINE_EXCEEDED,
                           f"{self.path} to {self.target}: deadline "
                           "exceeded") from None
        raise RpcError(StatusCode.UNAVAILABLE,
                       f"{self.path} to {self.target}: "
                       f"{e or 'connection closed'}") from None

    def next_message(self):
        """The next response message, or None after an OK status."""
        if self.done:
            return None
        try:
            self.conn.settimeout(self._remaining())
            frame = self.conn.recv()
        except (OSError, socket.timeout, ValueError) as e:
            self._fail(e)
        if frame is None:
            self._fail(OSError("connection closed by the server"))
        kind, payload = frame
        if kind == MSG:
            return self.resp_cls.FromString(payload)
        if kind != STATUS:
            self._fail(OSError(f"unexpected frame kind {kind}"))
        self.done = True
        err = _parse_status(payload)
        if self.reuse:
            self.conn.settimeout(None)
            _checkin(self.target, self.conn)
        else:
            self.conn.close()
        if err.code() != StatusCode.OK:
            raise err
        return None

    def cancel(self) -> None:
        if not self.done:
            self.cancelled = True
            self.conn.close()


class _ResponseStream:
    """The iterator a streaming call returns (gRPC's call object)."""

    def __init__(self, call: _Call):
        self._call = call

    def __iter__(self):
        return self

    def __next__(self):
        msg = self._call.next_message()
        if msg is None:
            raise StopIteration
        return msg

    def cancel(self) -> None:
        self._call.cancel()

    def __del__(self):
        # a stream dropped before its status would pin its connection
        self._call.cancel()


def _invoke(target, path, resp_cls, client_streaming, server_streaming):
    def invoke(request_or_iterator, timeout=None, **_kwargs):
        if _failpoint._armed:
            _failpoint.hit("rpc.call", method=path)
        if _deadline.get() is not None:
            rem = _deadline.remaining()
            if rem <= 0:
                raise _deadline.DeadlineExceeded(f"rpc {path}")
            timeout = rem if timeout is None else min(timeout, rem)
        md = ""
        if _ctrace._enabled:
            hdr = _ctrace.outbound_header()
            if hdr is not None:
                md += f"\n{_ctrace.GRPC_KEY}:{hdr}"
        if _qos_tenant is not None:
            tenant = _qos_tenant.get()
            if tenant is not None:
                md += f"\n{_QOS_TENANT_KEY}:{tenant}"
        call = _Call(target, path, resp_cls, timeout,
                     reuse=not client_streaming, metadata=md)
        call.start(request_or_iterator, client_streaming)
        if server_streaming:
            return _ResponseStream(call)
        resp = call.next_message()
        if resp is None:
            raise RpcError(StatusCode.INTERNAL,
                           f"{path}: no response message")
        call.next_message()      # the trailing status
        return resp
    invoke.__name__ = path.rsplit("/", 1)[-1]
    return invoke


def make_stub(pb_module, service_name: str, target: str):
    """A stub object with one callable per method, cached per target.

    Each callable takes the request (an iterator of requests for
    client-streaming methods) and an optional ``timeout=`` in seconds;
    unary methods return the response, streaming ones an iterator of
    responses with ``cancel()``. Failures raise ``RpcError``."""
    key = (pb_module.PACKAGE, service_name, target, _generation)
    stub = _stub_cache.get(key)
    if stub is not None:
        return stub
    stub = type(f"{service_name}Stub", (), {})()
    for name, _req, resp, cs, ss in pb_module.SERVICES[service_name]:
        path = f"/{pb_module.PACKAGE}.{service_name}/{name}"
        setattr(stub, name, _invoke(target, path, resp, cs, ss))
    with _pool_lock:
        return _stub_cache.setdefault(key, stub)


# -- server --------------------------------------------------------------------


class _Context:
    """The servicer's view of one call (gRPC's ServicerContext)."""

    def __init__(self, conn: _Conn, deadline: Optional[float],
                 metadata: tuple = ()):
        self._conn = conn
        self._deadline = deadline
        self._metadata = metadata
        self.cancelled = False

    def abort(self, code: StatusCode, details: str = ""):
        raise _Abort(code, details)

    def time_remaining(self) -> Optional[float]:
        """Seconds left of the caller's deadline; None without one."""
        if self._deadline is None:
            return None
        return max(0.0, self._deadline - time.monotonic())

    def invocation_metadata(self) -> tuple:
        """The caller's (key, value) metadata pairs."""
        return self._metadata

    def peer(self) -> str:
        try:
            host, port = self._conn.sock.getpeername()[:2]
        except OSError:
            return ""
        return f"{host}:{port}"

    def is_active(self) -> bool:
        if self.cancelled:
            return False
        if self._deadline is not None and \
                time.monotonic() >= self._deadline:
            return False
        self._conn.fill_nowait()
        if self._conn.eof or self._conn.closed:
            self.cancelled = True
            return False
        return True



class _Requests:
    """Iterator over a call's request messages; ends at END, at a hang-up
    or a cancel (then ``context.cancelled`` is set)."""

    def __init__(self, conn: _Conn, req_cls, ctx: _Context):
        self._conn = conn
        self._cls = req_cls
        self._ctx = ctx
        self.finished = False

    def __iter__(self):
        return self

    def __next__(self):
        if self.finished:
            raise StopIteration
        try:
            frame = self._conn.recv()
        except (OSError, ValueError):
            frame = None
        if frame is None or frame[0] != MSG:
            self.finished = True
            if frame is None or frame[0] != END:
                self._ctx.cancelled = True
            raise StopIteration
        return self._cls.FromString(frame[1])


class _Method:
    __slots__ = ("name", "req_cls", "resp_cls", "client_streaming",
                 "server_streaming", "fn")

    def __init__(self, name, req_cls, resp_cls, cs, ss, fn):
        self.name = name
        self.req_cls = req_cls
        self.resp_cls = resp_cls
        self.client_streaming = cs
        self.server_streaming = ss
        self.fn = fn


def generic_handler(pb_module, service_name: str, servicer,
                    stats_role: Optional[str] = None) -> dict:
    """{method path: handler} routing each method of one service to the
    same-named method of ``servicer``; a method the servicer lacks
    answers UNIMPLEMENTED.

    Every implemented method is wrapped with the shared request
    counter/latency instrumentation (stats.metrics.instrument_grpc_method)
    under the ``stats_role`` type label, lowerCamel of the service name
    when the caller passes none."""
    from seaweedfs_tpu_torch.stats.metrics import instrument_grpc_method
    if stats_role is None:
        stats_role = service_name[:1].lower() + service_name[1:]
    # the cluster tracer labels request spans with the serving node's
    # address, so the stitcher groups RPC and HTTP ingress of one server
    # into the same process lane
    server_url = getattr(servicer, "url", "")
    handlers = {}
    for name, req, resp, cs, ss in pb_module.SERVICES[service_name]:
        fn = getattr(servicer, name, None)
        if fn is None:
            def fn(request, context, _name=name):  # noqa: ARG001
                context.abort(StatusCode.UNIMPLEMENTED,
                              f"method {_name} not implemented")
        else:
            fn = instrument_grpc_method(fn, stats_role, name,
                                        server_streaming=ss,
                                        server=server_url,
                                        client_streaming=cs)
        path = f"/{pb_module.PACKAGE}.{service_name}/{name}"
        handlers[path] = _Method(name, req, resp, cs, ss, fn)
    return handlers


class RpcServer:
    """Accepts connections on one address; a thread per connection runs
    its calls one after another."""

    def __init__(self, address: str, handlers: List[dict]):
        self._routes: Dict[str, _Method] = {}
        for h in handlers:
            self._routes.update(h)
        host, port = _split(address)
        self._listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        try:
            self._listener.bind((host, port))
        except OSError as e:
            self._listener.close()
            raise OSError(f"cannot bind rpc server to {address}: {e}") \
                from e
        self._listener.listen(128)
        self.bound_port = self._listener.getsockname()[1]
        self._lock = threading.Lock()
        self._conns: set = set()  # guarded_by(self._lock)
        self._stopping = False
        self._thread: Optional[threading.Thread] = None

    def start(self) -> None:
        # lint: thread-ok(listener thread; each call mints its own context)
        self._thread = threading.Thread(
            target=self._accept_loop, name=f"rpc-{self.bound_port}",
            daemon=True)
        self._thread.start()

    def _accept_loop(self) -> None:
        while not self._stopping:
            try:
                sock, _ = self._listener.accept()
            except OSError:
                return
            conn = _Conn(sock)
            with self._lock:
                if self._stopping:
                    conn.close()
                    return
                self._conns.add(conn)
            # lint: thread-ok(connection thread; each call mints its own context)
            threading.Thread(target=self._serve, args=(conn,),
                             name=f"rpc-conn-{self.bound_port}",
                             daemon=True).start()

    def _serve(self, conn: _Conn) -> None:
        try:
            ctx = _server_context
            if ctx is not None:
                try:
                    conn.start_tls(ctx, server_side=True)
                except (OSError, ValueError) as e:
                    # a plaintext client, a certificate the CA did not
                    # sign: this connection ends, the server goes on
                    log.info("rpc %d: TLS handshake failed: %s",
                             self.bound_port, e)
                    return
            while not self._stopping:
                try:
                    frame = conn.recv()
                except (OSError, ValueError):
                    return
                if frame is None:
                    return
                if frame[0] != HEAD or not self._call(conn, frame[1]):
                    return
        finally:
            with self._lock:
                self._conns.discard(conn)
            conn.close()

    def _call(self, conn: _Conn, head: bytes) -> bool:
        """Run one call; False when the connection cannot carry another."""
        timeout = struct.unpack(">d", head[:8])[0]
        path, *md = head[8:].decode("utf-8", "replace").split("\n")
        deadline = None if timeout < 0 else time.monotonic() + timeout
        ctx = _Context(conn, deadline,
                       tuple(tuple(e.split(":", 1)) for e in md
                             if ":" in e))
        method = self._routes.get(path)
        reqs = _Requests(conn, method.req_cls if method else None, ctx)
        try:
            if method is None:
                for _ in reqs:
                    pass
                raise _Abort(StatusCode.UNIMPLEMENTED,
                             f"unknown method {path}")
            if method.client_streaming:
                arg = reqs
            else:
                arg = next(reqs, None)
                if arg is None or next(reqs, None) is not None:
                    if ctx.cancelled:
                        return False
                    raise _Abort(StatusCode.INTERNAL,
                                 f"{path}: expected one request message")
            result = method.fn(arg, ctx)
            ok = (STATUS, _status_payload(StatusCode.OK, ""))
            if method.server_streaming:
                try:
                    for msg in result:
                        conn.send((MSG, msg.SerializeToString()))
                finally:
                    close = getattr(result, "close", None)
                    if close is not None:
                        close()
                conn.send(ok)
            else:
                conn.send((MSG, result.SerializeToString()), ok)
        except _Abort as e:
            return self._send_status(conn, e.code, e.details) and \
                not (method and method.client_streaming)
        except OSError:
            return False         # the peer went away mid-call
        except Exception as e:  # noqa: BLE001 - becomes the call's status
            log.exception("rpc %s failed", path)
            return self._send_status(
                conn, StatusCode.UNKNOWN,
                f"Exception calling application: {e}") and \
                not (method and method.client_streaming)
        # a request stream may still hold frames: never reuse its socket
        return not method.client_streaming

    @staticmethod
    def _send_status(conn: _Conn, code: StatusCode, details: str) -> bool:
        try:
            conn.send((STATUS, _status_payload(code, details)))
            return True
        except OSError:
            return False

    def stop(self) -> None:
        """Close the listener and every connection: in-flight calls end,
        and peers see their streams break."""
        self._stopping = True
        # shutdown wakes the accept() blocked on the listener; a bare
        # close() would leave the port bound until that call returned
        for fn in (lambda: self._listener.shutdown(socket.SHUT_RDWR),
                   self._listener.close):
            try:
                fn()
            except OSError:
                pass
        with self._lock:
            conns = list(self._conns)
            self._conns.clear()
        for c in conns:
            c.close()


def make_server(address: str, handlers) -> RpcServer:
    """Bind ``address`` ("host:port"; port 0 picks one, see
    ``.bound_port``), route the given ``generic_handler`` tables, start."""
    server = RpcServer(address, handlers)
    server.start()
    return server
