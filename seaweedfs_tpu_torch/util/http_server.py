"""Fast HTTP handler base for the data plane.

BaseHTTPRequestHandler parses request headers with the email package,
which (a) walks a feed parser state machine per request and (b) for
multipart uploads compiles a regex from the request's unique boundary
string — a guaranteed re-cache miss costing ~0.5 ms per POST. The
reference's data plane is Go's net/http, whose header parse is a tight
loop over bytes (net/textproto Reader.ReadMIMEHeader); FastHandler is
that idea on top of the stdlib server plumbing: same request-line
semantics and error replies as BaseHTTPRequestHandler.parse_request,
but headers land in a plain lowercase-keyed dict.

Handlers keep the whole BaseHTTPRequestHandler API (send_response /
send_header / end_headers / wfile / rfile); only parsing and the
per-response Date header (cached per second) are replaced.
"""

from __future__ import annotations

import os
import socket
import threading
import time
from dataclasses import dataclass
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

_MAX_LINE = 65536
_MAX_HEADERS = 100
# one chunk-size line of a chunked body (hex digits + extensions)
_MAX_CHUNK_LINE = 1024
# copy window for threaded file-span bodies (an async connection hands
# the span to os.sendfile instead), and the drain window for request
# bodies a handler left unread
_SPAN_COPY = 65536

# status -> reason phrase for fast_reply (same table BaseHTTPRequestHandler
# uses, flattened once at import)
_REASONS = {code: msg for code, (msg, _longmsg)
            in BaseHTTPRequestHandler.responses.items()}


class HeaderDict(dict):
    """Case-insensitive read access; keys are stored lowercase.

    Every header consumer in this codebase either calls .get()/[] (both
    case-insensitive here) or lowercases keys itself when iterating
    (s3api SigV4, aws_auth, filer proxy), so lowercase storage is safe.
    """

    __slots__ = ()

    def get(self, key, default=None):
        # first probe as-given: hot callers pass lowercase literals and
        # skip the per-call key.lower() (values are never None)
        v = dict.get(self, key)
        if v is not None:
            return v
        return dict.get(self, key.lower(), default)

    def __getitem__(self, key):
        v = dict.get(self, key)
        if v is not None:
            return v
        return dict.__getitem__(self, key.lower())

    def __contains__(self, key):
        return dict.__contains__(self, key) or \
            dict.__contains__(self, key.lower())


def parse_header_block(rfile, headers: dict,
                       max_headers: int = 0) -> Optional[str]:
    """Read a CRLF-terminated header block from a BufferedReader into
    `headers` (lowercase keys, first value wins). Shared by the server
    (FastHandler.parse_request).

    Fast path: the whole block usually sits in the reader's buffer
    already (the request/status line was just read from it), so peek +
    one decode + one split replaces a readline/decode/strip per line.
    Returns None on success, "toolong" / "toomany" on limit breach.
    """
    setdefault = dict.setdefault
    buf = rfile.peek(_MAX_LINE)
    if buf.startswith(b"\r\n"):  # zero headers: bare blank line
        rfile.read(2)
        return None
    end = buf.find(b"\r\n\r\n")
    if 0 <= end < _MAX_LINE:
        block = rfile.read(end + 4)[:end]
        lines = block.decode("iso-8859-1").split("\r\n") if block else []
        if max_headers and len(lines) > max_headers:
            return "toomany"
        for line in lines:
            key, sep, value = line.partition(":")
            if not sep or not key:
                # bare continuation lines / malformed headers: the email
                # parser tolerated them silently; skip likewise
                continue
            setdefault(headers, key.strip().lower(), value.strip())
        return None
    count = 0
    while True:
        line = rfile.readline(_MAX_LINE + 1)
        if len(line) > _MAX_LINE:
            return "toolong"
        if line in (b"\r\n", b"\n", b""):
            return None
        count += 1
        if max_headers and count > max_headers:
            return "toomany"
        colon = line.find(b":")
        if colon <= 0:
            continue
        key = line[:colon].decode("iso-8859-1").strip().lower()
        value = line[colon + 1:].decode("iso-8859-1").strip()
        setdefault(headers, key, value)


_date_cache = (0, "")


def http_date() -> str:
    """RFC 7231 date, cached per second (one response header per
    request; strftime per call is measurable at data-plane rates)."""
    global _date_cache
    now = int(time.time())
    if _date_cache[0] != now:
        t = time.gmtime(now)
        _date_cache = (now, (
            f"{('Mon','Tue','Wed','Thu','Fri','Sat','Sun')[t.tm_wday]}, "
            f"{t.tm_mday:02d} "
            f"{('Jan','Feb','Mar','Apr','May','Jun','Jul','Aug','Sep','Oct','Nov','Dec')[t.tm_mon-1]} "
            f"{t.tm_year} {t.tm_hour:02d}:{t.tm_min:02d}:{t.tm_sec:02d} GMT"))
    return _date_cache[1]


def parse_content_length(headers) -> int:
    """Declared body length, 0 when absent/unparseable. Shared by both
    server models so their framing decisions cannot diverge."""
    try:
        return int(headers.get("content-length") or 0)
    except (TypeError, ValueError):
        return 0


def is_chunked(headers) -> bool:
    return "chunked" in (headers.get("transfer-encoding") or "").lower()


class BodyReader:
    """Framing-aware request-body reader shared by both server models.

    Wraps the raw connection reader (threaded model) or a buffer of the
    already-received body bytes (async model, ``util/async_server.py``)
    and exposes exactly the request body: reads are capped at the
    Content-Length, and a ``Transfer-Encoding: chunked`` body is decoded
    transparently, by the same code on both models, so a chunked PUT
    answers byte-identically whichever core serves it. ``drain()``
    consumes whatever the handler left unread, keeping
    keep-alive/pipelined framing intact."""

    __slots__ = ("_raw", "_chunked", "_remaining", "_done")

    def __init__(self, raw, headers):
        self._raw = raw
        self._chunked = is_chunked(headers)
        self._remaining = 0 if self._chunked \
            else parse_content_length(headers)
        self._done = not self._chunked and self._remaining == 0

    def readable(self) -> bool:
        return True

    def _next_chunk(self) -> bool:
        """Advance to the next chunk; False at the terminal chunk."""
        line = self._raw.readline(_MAX_CHUNK_LINE + 2)
        if line in (b"\r\n", b"\n"):  # CRLF after the previous chunk
            line = self._raw.readline(_MAX_CHUNK_LINE + 2)
        if not line or len(line) > _MAX_CHUNK_LINE:
            raise ValueError("bad chunk-size line")
        size_s = line.split(b";", 1)[0].strip()
        try:
            size = int(size_s, 16)
        except ValueError:
            raise ValueError(f"bad chunk size {size_s[:32]!r}")
        if size == 0:
            # trailers run until a blank line (or EOF)
            while True:
                t = self._raw.readline(_MAX_LINE + 1)
                if t in (b"\r\n", b"\n", b""):
                    break
            self._done = True
            return False
        self._remaining = size
        return True

    def read(self, n: int = -1) -> bytes:
        if self._done:
            return b""
        if not self._chunked:
            want = self._remaining if n is None or n < 0 \
                else min(n, self._remaining)
            data = self._raw.read(want) if want else b""
            self._remaining -= len(data)
            if self._remaining <= 0 or len(data) < want:
                self._done = True  # satisfied (or peer hung up early)
            return data
        out = []
        budget = None if n is None or n < 0 else n
        while not self._done and (budget is None or budget > 0):
            if self._remaining == 0 and not self._next_chunk():
                break
            want = self._remaining if budget is None \
                else min(budget, self._remaining)
            data = self._raw.read(want)
            if len(data) < want:  # peer hung up mid-chunk
                self._done = True
            self._remaining -= len(data)
            out.append(data)
            if budget is not None:
                budget -= len(data)
        return b"".join(out)

    def read_all(self) -> bytes:
        return self.read(-1)

    def drain(self) -> None:
        """Discard whatever the handler left unread."""
        while not self._done:
            if not self.read(_SPAN_COPY):
                break

    def close(self) -> None:
        pass


class FileSpan:
    """A file-backed response body: (fd, offset, length).

    Made by the volume read path's zero-copy seam
    (``Store.read_needle_span``) and consumed by ``send_span``: an async
    connection hands it to os.sendfile (the payload never enters
    Python), a threaded connection streams it in ``_SPAN_COPY`` pread
    windows. Owns its (dup'd) fd; close() releases it once."""

    __slots__ = ("fd", "offset", "length")

    def __init__(self, fd: int, offset: int, length: int):
        self.fd = fd
        self.offset = offset
        self.length = length

    def close(self) -> None:
        if self.fd >= 0:
            try:
                os.close(self.fd)
            except OSError:
                pass
            self.fd = -1

    def __del__(self):  # leak-proofing; normal paths close explicitly
        self.close()


@dataclass
class ServeConfig:
    """The -serve.* flags, one object per server role (0 = the async
    core's built-in default, ``util/async_server.py``)."""
    async_mode: bool = False
    max_conns: int = 0
    keepalive_budget: int = 0
    workers: int = 0
    sendfile: bool = True


def make_http_server(addr, handler_cls, role: str = "",
                     serve: Optional[ServeConfig] = None):
    """The one seam every role builds its HTTP server through: the
    selector-based async core under -serve.async, the
    thread-per-connection TrackingHTTPServer otherwise. The async module
    is imported only under the flag, so a default server makes no
    selector, no connection state and no pool."""
    if serve is not None and serve.async_mode:
        from seaweedfs_tpu_torch.util.async_server import AsyncHTTPServer
        return AsyncHTTPServer(addr, handler_cls, role=role,
                               max_conns=serve.max_conns,
                               keepalive_budget=serve.keepalive_budget,
                               workers=serve.workers)
    return TrackingHTTPServer(addr, handler_cls)


class TrackingHTTPServer(ThreadingHTTPServer):
    """ThreadingHTTPServer that force-closes established connections on
    server_close.

    With keep-alive clients, handler threads park in readline() waiting
    for the next request; stock server_close only closes the LISTENER,
    so a stopped server keeps answering on old connections — and once
    the OS reuses its port for a new server, pooled clients talk to a
    ghost. Tracking and shutting the accepted sockets makes stop mean
    stop (Go's http.Server.Close closes active conns the same way)."""

    daemon_threads = True

    def __init__(self, *args, **kwargs):
        self._conns: set = set()
        self._conns_lock = threading.Lock()
        super().__init__(*args, **kwargs)

    def process_request(self, request, client_address):
        with self._conns_lock:
            self._conns.add(request)
        super().process_request(request, client_address)

    def shutdown_request(self, request):
        with self._conns_lock:
            self._conns.discard(request)
        super().shutdown_request(request)

    def server_close(self):
        super().server_close()
        with self._conns_lock:
            conns = list(self._conns)
            self._conns.clear()
        for s in conns:
            try:
                s.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                s.close()
            except OSError:
                pass


class FastHandler(BaseHTTPRequestHandler):
    """BaseHTTPRequestHandler with a fast header parser."""

    protocol_version = "HTTP/1.1"
    disable_nagle_algorithm = True
    # Buffered wfile: stock socketserver uses an unbuffered writer, so
    # every response costs two sendall syscalls (joined header block,
    # then body) and wakes the peer twice — measurable at data-plane
    # rates on loopback. handle_one_request() flushes after each
    # handler, so buffering coalesces each response into ONE send
    # (Go's net/http response writer buffers the same way).
    wbufsize = 65536
    # set per request by the async core: the connection driving this
    # request, None when the threaded model serves. Handlers use it to
    # choose zero-copy paths (the volume GET's sendfile); everything else
    # is model-agnostic.
    async_conn = None

    def handle_expect_100(self):
        """The interim 100 Continue must reach the client BEFORE we
        block reading the body — flush past the buffered wfile. The async
        core sends the interim reply itself when it parses the head (the
        body has not arrived yet when the handler re-parses), so a
        handler marked _expect_sent skips the write."""
        if getattr(self, "_expect_sent", False):
            return True
        ok = super().handle_expect_100()
        if ok:
            self.wfile.flush()
        return ok

    def _head_bytes(self, code: int, length: Optional[int], headers=None,
                    ctype: str = "") -> bytes:
        """One response head as a single bytes blob, shared by fast_reply
        (a body in memory) and send_span (a body in a file), so the two
        reply styles cannot differ on the wire; a length of None frames
        the body with chunked transfer encoding."""
        reason = _REASONS.get(code, "")
        # mirrored by the instrumented send_response hook: the cluster
        # tracer's tail sampler keeps 5xx requests by final status
        self.last_status = code
        parts = [f"HTTP/1.1 {code} {reason}\r\nDate: {http_date()}\r\n"]
        if ctype:
            parts.append(f"Content-Type: {ctype}\r\n")
        if headers:
            for k, v in headers.items():
                parts.append(f"{k}: {v}\r\n")
        if self.close_connection:
            parts.append("Connection: close\r\n")
        parts.append("Transfer-Encoding: chunked\r\n\r\n" if length is None
                     else f"Content-Length: {length}\r\n\r\n")
        return "".join(parts).encode("latin-1")

    def fast_reply(self, code: int, body: bytes = b"",
                   headers=None, ctype: str = "") -> None:
        """Whole response head as one f-string + one buffered write.

        send_response/send_header/end_headers cost ~5 Python calls and
        a list-append/join per response; at small-file data-plane rates
        that machinery is a measurable share of the server's cycles.
        Semantics kept: Date header, Connection: close when the request
        asked for it, no body on HEAD. (Go's net/http writes its
        response head the same single-buffer way.)"""
        self.wfile.write(self._head_bytes(code, len(body), headers,
                                          ctype))
        if body and self.command != "HEAD":
            self.wfile.write(body)

    def send_span(self, code: int, span: "FileSpan", headers=None,
                  ctype: str = "") -> None:
        """A reply whose body is a FileSpan: the head bytes of
        fast_reply, the body from the file. On an async connection the
        span rides os.sendfile; on a threaded one it streams in bounded
        pread windows. The bytes on the wire are the same either way."""
        self.wfile.write(self._head_bytes(code, span.length, headers,
                                          ctype))
        if span.length == 0 or self.command == "HEAD":
            span.close()
            return
        add_span = getattr(self.wfile, "add_span", None)
        if add_span is not None:  # the async core's response writer
            add_span(span)
            return
        off, remaining = span.offset, span.length
        try:
            while remaining > 0:
                chunk = os.pread(span.fd, min(_SPAN_COPY, remaining), off)
                if not chunk:
                    raise OSError(f"file span truncated at {off} "
                                  f"({remaining} bytes short)")
                self.wfile.write(chunk)
                off += len(chunk)
                remaining -= len(chunk)
        finally:
            span.close()

    def read_body(self) -> bytes:
        """The full request body, whatever the framing: the installed
        BodyReader decodes Content-Length or chunked identically on
        both server models; bodiless requests read b"" for free."""
        r = self.rfile
        if isinstance(r, BodyReader):
            return r.read_all()
        n = parse_content_length(self.headers)
        return r.read(n) if n else b""

    def handle_one_request(self):
        """Stock dispatch + body framing: a request that declares a
        body gets a BodyReader installed as self.rfile for the
        handler's duration, and whatever the handler leaves unread is
        drained afterwards — so keep-alive and pipelined framing
        survive handlers that ignore (or partially read) bodies, and
        chunked uploads work on every role. Bodiless requests (the
        dominant GET path) take the stock path with zero new
        objects."""
        try:
            self.raw_requestline = self.rfile.readline(_MAX_LINE + 1)
            if len(self.raw_requestline) > _MAX_LINE:
                self.requestline = ""
                self.request_version = ""
                self.command = ""
                self.send_error(414)
                return
            if not self.raw_requestline:
                self.close_connection = True
                return
            if not self.parse_request():
                return
            body = None
            if is_chunked(self.headers) or \
                    parse_content_length(self.headers) > 0:
                body = BodyReader(self.rfile, self.headers)
            mname = "do_" + self.command
            if not hasattr(self, mname):
                self.send_error(
                    501, "Unsupported method (%r)" % self.command)
                return
            if body is None:
                getattr(self, mname)()
            else:
                raw = self.rfile
                self.rfile = body
                try:
                    getattr(self, mname)()
                finally:
                    self.rfile = raw
                    if not self.close_connection:
                        try:
                            body.drain()
                        except (OSError, ValueError):
                            self.close_connection = True
            self.wfile.flush()
        except TimeoutError as e:
            self.log_error("Request timed out: %r", e)
            self.close_connection = True

    def date_time_string(self, timestamp=None):
        if timestamp is not None:
            return super().date_time_string(timestamp)
        return http_date()

    def parse_request(self) -> bool:
        """Semantics of BaseHTTPRequestHandler.parse_request (status
        codes and close_connection behavior) with dict headers."""
        self.command = None
        self.request_version = version = self.default_request_version
        self.close_connection = True
        requestline = str(self.raw_requestline, "iso-8859-1").rstrip("\r\n")
        self.requestline = requestline
        words = requestline.split()
        if len(words) == 3:
            command, path, version = words
            if not version.startswith("HTTP/"):
                self.send_error(400, f"Bad request version ({version!r})")
                return False
            try:
                major, _, minor = version[5:].partition(".")
                version_number = (int(major), int(minor))
            except ValueError:
                self.send_error(400, f"Bad request version ({version!r})")
                return False
            if version_number >= (1, 1) and \
                    self.protocol_version >= "HTTP/1.1":
                self.close_connection = False
            if version_number >= (2, 0):
                self.send_error(505,
                                f"Invalid HTTP version ({version!r})")
                return False
        elif len(words) == 2:
            command, path = words
            self.close_connection = True
            if command != "GET":
                self.send_error(400,
                                f"Bad HTTP/0.9 request type ({command!r})")
                return False
        elif not words:
            return False
        else:
            self.send_error(400, f"Bad request syntax ({requestline!r})")
            return False
        self.command, self.path, self.request_version = \
            command, path, version

        headers = HeaderDict()
        err = parse_header_block(self.rfile, headers,
                                 max_headers=_MAX_HEADERS)
        if err == "toolong":
            self.send_error(431, "Header line too long")
            return False
        if err == "toomany":
            self.send_error(431, "Too many headers")
            return False
        self.headers = headers
        return self._finish_parse(headers)

    def _finish_parse(self, headers: "HeaderDict") -> bool:
        conntype = headers.get("connection", "").lower()
        if conntype == "close":
            self.close_connection = True
        elif conntype == "keep-alive" and \
                self.protocol_version >= "HTTP/1.1":
            self.close_connection = False
        if headers.get("expect", "").lower() == "100-continue" and \
                self.protocol_version >= "HTTP/1.1" and \
                self.request_version != "HTTP/0.9":
            if not self.handle_expect_100():
                return False
        return True
