"""The port's async serving core against the JAX package's.

The port's ``util/async_server.py`` is the selector event loop of
``seaweedfs_tpu.util.async_server``: one poll loop frames HTTP/1.1
requests with the handler class's own parser, runs them on a lazy worker
pool and sends GET payloads of local volumes through ``os.sendfile``.
Its contract is byte identity, so the 17-request parser corpus of
``tests/test_serve_async.py`` goes to the port's async server, the port's
threaded server and the JAX async server with the date frozen, and every
reply must be the same bytes. Then twins of the JAX core tests (split
heads, a crashing handler, a waiting Expect: 100-continue client, a
partial head closed by the peer, an early close, the keep-alive LRU
budget, accept backpressure, the body reader and the chunked scanner,
and the completion hand-off under the port's schedule explorer), each
waiting on the server's state instead of sleeping. A port volume server
under ``-serve.async`` answers every GET variant (plain, range, 416,
HEAD, If-None-Match, compressed with and without gzip accepted, a chunk
manifest, a missing needle, a cookie mismatch, an image resize) with the
JAX async server's bytes, with sendfile on and off, and counts heat as
the threaded model does. Also: the off contract (no async module, no
selector, no pool), ``-serve.*`` argv against the JAX ``_serve_config``,
the frame-time QoS shed against the JAX core on seeded tenant sequences,
and the ``/status`` and ``/ui`` pages of both roles against the JAX
servers'.
"""

import dataclasses
import gzip
import io
import json
import os
import re
import socket
import subprocess
import sys
import threading
import urllib.request

import numpy as np
import pytest

import seaweedfs_tpu.util.http_server as jax_hs
import seaweedfs_tpu_torch.util.http_server as hs
from seaweedfs_tpu.util import async_server as jax_async
from seaweedfs_tpu_torch.operation import operations as port_ops
from seaweedfs_tpu_torch.stats.metrics import (ServeSendfileBytesCounter,
                                               ServeShedCounter)
from seaweedfs_tpu_torch.util import async_server
from seaweedfs_tpu_torch.util.async_server import (AsyncHTTPServer,
                                                   _ChunkedScanner,
                                                   _Connection)
from seaweedfs_tpu_torch.util.http_server import (BodyReader, FastHandler,
                                                  FileSpan, ServeConfig,
                                                  TrackingHTTPServer)
from tests.test_torch_cluster import REPO, Cluster, wait_for

FROZEN_DATE = "Thu, 01 Jan 1970 00:00:00 GMT"


@pytest.fixture
def frozen_date(monkeypatch):
    """Both packages' servers stamp the same Date, so replies compare
    byte for byte."""
    monkeypatch.setattr(hs, "http_date", lambda: FROZEN_DATE)
    monkeypatch.setattr(jax_hs, "http_date", lambda: FROZEN_DATE)


def _echo_handler(base):
    """The JAX core tests' handler, on either package's FastHandler."""

    class EchoHandler(base):
        def log_message(self, fmt, *args):
            pass

        def do_GET(self):
            if self.path == "/boom":
                raise RuntimeError("handler crash")
            self.fast_reply(200, b"hello:" + self.path.encode(),
                            ctype="text/plain")

        do_HEAD = do_GET

        def do_POST(self):
            body = self.read_body()
            self.fast_reply(200, b"echo:" + body)

        def do_PUT(self):
            # the stock reply style (send_response/send_header/end_headers)
            body = self.read_body()
            self.send_response(201)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

    return EchoHandler


PortEcho = _echo_handler(FastHandler)
JaxEcho = _echo_handler(jax_hs.FastHandler)


def _start(model: str, **kw):
    """model: port-threaded, port-async or jax-async."""
    if model == "port-threaded":
        srv = TrackingHTTPServer(("127.0.0.1", 0), PortEcho)
    elif model == "port-async":
        srv = AsyncHTTPServer(("127.0.0.1", 0), PortEcho, role="test", **kw)
    else:
        srv = jax_async.AsyncHTTPServer(("127.0.0.1", 0), JaxEcho,
                                        role="test", **kw)
    threading.Thread(target=srv.serve_forever, daemon=True,
                     name=f"test-{model}").start()
    return srv


def _stop(srv):
    srv.shutdown()
    srv.server_close()


def _exchange(port, payload, timeout=8.0, chunk=0, gap=0.0):
    """Send payload (dribbled in `chunk`-byte pieces when asked) and read
    until the server closes; returns every byte received."""
    s = socket.create_connection(("127.0.0.1", port), timeout=timeout)
    try:
        if chunk:
            for i in range(0, len(payload), chunk):
                s.sendall(payload[i:i + chunk])
                if gap:
                    threading.Event().wait(gap)
        else:
            s.sendall(payload)
        out = b""
        while True:
            try:
                d = s.recv(65536)
            except socket.timeout:
                break
            if not d:
                break
            out += d
        return out
    finally:
        s.close()


def _recv_until(s, marker: bytes, timeout=10.0) -> bytes:
    """Read s until marker has arrived (a reply's head and body may come
    in separate segments)."""
    s.settimeout(timeout)
    out = b""
    while marker not in out:
        d = s.recv(65536)
        if not d:
            break
        out += d
    return out


def _closed_by_server(s, timeout=10.0) -> bool:
    """Read s until the server closes it (True) or timeout (False)."""
    s.settimeout(timeout)
    try:
        while s.recv(65536):
            pass
    except socket.timeout:
        return False
    except OSError:
        pass
    return True


# every request asks for close at the end, so _exchange ends on EOF and
# the byte streams compare exactly (tests/test_serve_async.py:119-163)
CORPUS = {
    "simple": b"GET /a HTTP/1.1\r\nHost: x\r\nConnection: close\r\n\r\n",
    "keepalive_pipelined": (
        b"GET /1 HTTP/1.1\r\nHost: x\r\n\r\n"
        b"GET /2 HTTP/1.1\r\nHost: x\r\n\r\n"
        b"GET /3 HTTP/1.1\r\nHost: x\r\nConnection: close\r\n\r\n"),
    "post_content_length": (
        b"POST /p HTTP/1.1\r\nContent-Length: 5\r\n"
        b"Connection: close\r\n\r\nhello"),
    "post_chunked": (
        b"POST /p HTTP/1.1\r\nTransfer-Encoding: chunked\r\n"
        b"Connection: close\r\n\r\n"
        b"3\r\nabc\r\n8\r\ndefghijk\r\n0\r\n\r\n"),
    "chunked_then_keepalive": (
        b"POST /p HTTP/1.1\r\nTransfer-Encoding: chunked\r\n\r\n"
        b"4\r\nwxyz\r\n0\r\n\r\n"
        b"GET /after HTTP/1.1\r\nConnection: close\r\n\r\n"),
    "unread_body_then_next": (
        b"GET /ig HTTP/1.1\r\nContent-Length: 6\r\n\r\nBODYBY"
        b"GET /next HTTP/1.1\r\nConnection: close\r\n\r\n"),
    "put_stock_reply": (
        b"PUT /s HTTP/1.1\r\nContent-Length: 3\r\n"
        b"Connection: close\r\n\r\nabc"),
    "head": b"HEAD /h HTTP/1.1\r\nConnection: close\r\n\r\n",
    "expect_100": (
        b"POST /p HTTP/1.1\r\nContent-Length: 3\r\n"
        b"Expect: 100-continue\r\nConnection: close\r\n\r\nabc"),
    "http10": b"GET /old HTTP/1.0\r\n\r\n",
    "bad_version": b"GET / HTTP/9.9\r\n\r\n",
    "bad_syntax": b"GET\r\n\r\n",
    "unknown_method": (
        b"BREW /pot HTTP/1.1\r\nConnection: close\r\n\r\n"),
    "oversized_header_431": (
        b"GET / HTTP/1.1\r\nX-Big: " + b"a" * 70000 + b"\r\n\r\n"),
    "too_many_headers_431": (
        b"GET / HTTP/1.1\r\n" +
        b"".join(b"X-%d: v\r\n" % i for i in range(150)) + b"\r\n"),
    "request_line_414": b"GET /" + b"a" * 70000 + b" HTTP/1.1\r\n\r\n",
    "zero_length_post": (
        b"POST /p HTTP/1.1\r\nContent-Length: 0\r\n"
        b"Connection: close\r\n\r\n"),
}


@pytest.mark.parametrize("name", sorted(CORPUS))
def test_corpus_bytes_equal_threaded_and_jax_async(frozen_date, name):
    outs = {}
    for model in ("port-threaded", "port-async", "jax-async"):
        srv = _start(model)
        try:
            outs[model] = _exchange(srv.server_address[1], CORPUS[name])
        finally:
            _stop(srv)
    assert outs["port-async"] == outs["port-threaded"], name
    assert outs["port-async"] == outs["jax-async"], name
    if name == "bad_version":
        # the stock parser rejects before adopting the request version,
        # so the reply is HTTP/0.9-style: body only
        assert b"Error response" in outs["port-async"]
    elif name != "bad_syntax":
        assert outs["port-async"].startswith(b"HTTP/1.1 "), name


def test_split_across_recv_headers(frozen_date):
    """Bytes dribbled 7 at a time parse as one send does."""
    outs = {}
    for model in ("port-threaded", "port-async"):
        srv = _start(model)
        try:
            outs[model] = _exchange(srv.server_address[1],
                                    CORPUS["keepalive_pipelined"],
                                    chunk=7, gap=0.002)
        finally:
            _stop(srv)
    assert outs["port-threaded"] == outs["port-async"]
    assert outs["port-async"].count(b"HTTP/1.1 200") == 3


def test_handler_crash_closes_after_flush(frozen_date):
    """A crashing handler closes its connection with nothing sent, as in
    the threaded model, and the server serves on."""
    for model in ("port-threaded", "port-async"):
        srv = _start(model)
        try:
            port = srv.server_address[1]
            assert _exchange(port, b"GET /boom HTTP/1.1\r\n\r\n") == b""
            ok = _exchange(port, b"GET /ok HTTP/1.1\r\nConnection: close"
                           b"\r\n\r\n")
            assert b"hello:/ok" in ok
        finally:
            _stop(srv)


def test_expect_100_waiting_client(frozen_date):
    """A compliant Expect: 100-continue client sends its body only after
    the interim reply: the core must flush the 100 before it waits in its
    body state."""
    for model in ("port-threaded", "port-async"):
        srv = _start(model)
        try:
            s = socket.create_connection(
                ("127.0.0.1", srv.server_address[1]), timeout=5)
            s.sendall(b"POST /p HTTP/1.1\r\nContent-Length: 3\r\n"
                      b"Expect: 100-continue\r\nConnection: close\r\n\r\n")
            assert s.recv(65536) == b"HTTP/1.1 100 Continue\r\n\r\n", model
            s.sendall(b"abc")
            out = b""
            while True:
                d = s.recv(65536)
                if not d:
                    break
                out += d
            s.close()
            assert out.endswith(b"echo:abc"), (model, out)
        finally:
            _stop(srv)


def test_partial_head_fin_is_reclaimed():
    """connect, a partial request line, FIN: the connection must not leak
    past max_conns."""
    srv = _start("port-async", max_conns=3)
    try:
        port = srv.server_address[1]
        for _ in range(8):   # well past max_conns if leaked
            s = socket.create_connection(("127.0.0.1", port), timeout=5)
            s.sendall(b"GET /partial")   # no newline, ever
            s.close()
            wait_for(lambda: not srv._conns, timeout=10,
                     what="the partial-head connection reclaimed")
        out = _exchange(port, b"GET /ok HTTP/1.1\r\nConnection: close"
                        b"\r\n\r\n")
        assert b"hello:/ok" in out, "server stopped accepting"
    finally:
        _stop(srv)


def test_early_client_close_mid_body():
    srv = _start("port-async")
    try:
        s = socket.create_connection(
            ("127.0.0.1", srv.server_address[1]), timeout=5)
        s.sendall(b"POST /p HTTP/1.1\r\nContent-Length: 100000\r\n\r\n"
                  b"only-a-little")
        s.close()
        wait_for(lambda: not srv._conns, timeout=10,
                 what="the half-sent body's connection closed")
        out = _exchange(srv.server_address[1],
                        b"GET /alive HTTP/1.1\r\nConnection: close\r\n\r\n")
        assert b"hello:/alive" in out
    finally:
        _stop(srv)


def test_keepalive_budget_closes_lru_idle():
    """Past the budget the least recently active idle connection closes;
    waits on the server's idle set, not on a sleep."""
    srv = _start("port-async", keepalive_budget=2)
    shed = ServeShedCounter.labels("test", "keepalive")
    before = shed.value
    conns = []

    def idle_order():
        try:
            return [c.addr for c in list(srv._idle.values())]
        except RuntimeError:   # the loop changed the set mid-copy
            return None

    try:
        port = srv.server_address[1]
        for i in range(2):
            s = socket.create_connection(("127.0.0.1", port), timeout=5)
            s.sendall(b"GET /%d HTTP/1.1\r\n\r\n" % i)
            conns.append(s)
            assert b"hello:/%d" % i in _recv_until(s, b"hello:/%d" % i)
            # answered and back in the idle set, oldest first: the LRU
            # order the third connection is judged by
            want = [c.getsockname() for c in conns]
            wait_for(lambda: idle_order() == want, timeout=10,
                     what=f"connections {want} idle in that order")
        s3 = socket.create_connection(("127.0.0.1", port), timeout=5)
        s3.sendall(b"GET /2 HTTP/1.1\r\n\r\n")
        conns.append(s3)
        assert _closed_by_server(conns[0])
        assert shed.value == before + 1
        assert b"hello:/2" in _recv_until(s3, b"hello:/2")
        conns[1].sendall(b"GET /again HTTP/1.1\r\n\r\n")
        assert b"hello:/again" in _recv_until(conns[1], b"hello:/again")
    finally:
        for s in conns:
            s.close()
        _stop(srv)


def test_accept_backpressure_recovers():
    """At max_conns the listener leaves the poll; a close brings it back
    and the queued client is served."""
    srv = _start("port-async", max_conns=2)
    shed = ServeShedCounter.labels("test", "accept")
    before = shed.value
    try:
        port = srv.server_address[1]
        s1 = socket.create_connection(("127.0.0.1", port), timeout=5)
        s2 = socket.create_connection(("127.0.0.1", port), timeout=5)
        s1.sendall(b"GET /1 HTTP/1.1\r\n\r\n")
        s2.sendall(b"GET /2 HTTP/1.1\r\n\r\n")
        wait_for(lambda: not srv._accepting, timeout=10,
                 what="the listener paused at max_conns")
        assert shed.value == before + 1
        # the third connection waits in the backlog until one closes
        result = {}
        t = threading.Thread(target=lambda: result.setdefault(
            "out", _exchange(port, b"GET /3 HTTP/1.1\r\n"
                             b"Connection: close\r\n\r\n")))
        t.start()
        s1.close()
        t.join(timeout=30)
        assert not t.is_alive()
        assert b"hello:/3" in result["out"]
        s2.close()
    finally:
        _stop(srv)


def test_close_after_a_reply_that_waited_for_the_socket(frozen_date):
    """A Connection: close reply too large for the socket's buffers
    drains on write events, then closes the connection; the loop must
    serve on. (The JAX core re-registers the closed socket there and its
    loop thread dies: ROADMAP Queue 3.)"""
    srv = _start("port-async")
    try:
        port = srv.server_address[1]
        body = os.urandom(8 << 20)
        s = socket.socket()
        s.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, 4096)
        s.settimeout(30)
        s.connect(("127.0.0.1", port))
        s.sendall(b"POST /p HTTP/1.1\r\nContent-Length: %d\r\n"
                  b"Connection: close\r\n\r\n" % len(body) + body)
        # the reply filled the socket: the loop waits for write events
        wait_for(lambda: any(c.write_on for c in list(srv._conns.values())),
                 timeout=30, what="the reply waiting for the socket")
        out = b""
        while True:
            d = s.recv(1 << 20)
            if not d:
                break
            out += d
        s.close()
        assert out.endswith(b"echo:" + body)
        wait_for(lambda: not srv._conns, timeout=10,
                 what="the connection closed after its reply")
        again = _exchange(port, b"GET /after HTTP/1.1\r\n"
                          b"Connection: close\r\n\r\n")
        assert b"hello:/after" in again
    finally:
        _stop(srv)


# -- the body reader and the chunked scanner, against the JAX package ---------


def _both_readers(raw: bytes, headers: dict):
    return [(cls(io.BufferedReader(io.BytesIO(raw)), headers), raw)
            for cls in (BodyReader, jax_hs.BodyReader)]


def test_body_reader_chunked_decode_and_drain():
    raw = b"3\r\nabc\r\n2\r\nde\r\n0\r\nX-Trailer: v\r\n\r\nLEFTOVER"
    for cls in (BodyReader, jax_hs.BodyReader):
        buf = io.BufferedReader(io.BytesIO(raw))
        r = cls(buf, {"transfer-encoding": "chunked"})
        assert r.read(4) == b"abcd"
        r.drain()
        assert r.read() == b""
        assert buf.read() == b"LEFTOVER"   # the trailers consumed exactly


def test_body_reader_content_length_cap():
    for cls in (BodyReader, jax_hs.BodyReader):
        buf = io.BufferedReader(io.BytesIO(b"12345NEXTREQ"))
        r = cls(buf, {"content-length": "5"})
        assert r.read(99) == b"12345"
        assert r.read(1) == b""
        assert buf.read() == b"NEXTREQ"


def test_body_reader_bad_chunk_raises():
    for cls in (BodyReader, jax_hs.BodyReader):
        r = cls(io.BufferedReader(io.BytesIO(b"zz\r\nabc\r\n0\r\n\r\n")),
                {"transfer-encoding": "chunked"})
        with pytest.raises(ValueError):
            r.read()


def _chunked_message(rng) -> bytes:
    parts = []
    for _ in range(int(rng.integers(0, 6))):
        n = int(rng.integers(1, 40))
        ext = b";ext=1" if rng.integers(0, 3) == 0 else b""
        parts.append(b"%x%s\r\n%s\r\n" % (n, ext, rng.bytes(n)))
    trailer = b"T: v\r\n" if rng.integers(0, 2) else b""
    return b"".join(parts) + b"0\r\n" + trailer + b"\r\n"


@pytest.mark.parametrize("seed", range(4))
def test_chunked_scanner_and_reader_equal_jax(seed):
    """On seeded chunked bodies fed in seeded steps, the port's scanner
    ends each body where the JAX scanner does, just past the trailer's
    blank line, and both readers decode the same payload."""
    rng = np.random.default_rng(seed)
    for _ in range(20):
        msg = _chunked_message(rng) + b"TAIL"
        step = int(rng.integers(1, 12))
        ends = []
        for cls in (_ChunkedScanner, jax_async._ChunkedScanner):
            sc, buf, pos, done, i = cls(), bytearray(), 0, False, 0
            while i < len(msg) and not done:
                buf += msg[i:i + step]
                i += step
                pos, done = sc.feed(buf, pos)
            assert done and not sc.error
            ends.append(pos)
        assert ends[0] == ends[1] and msg[ends[0]:] == b"TAIL"
        decoded = [cls(io.BufferedReader(io.BytesIO(msg)),
                       {"transfer-encoding": "chunked"}).read()
                   for cls in (BodyReader, jax_hs.BodyReader)]
        assert decoded[0] == decoded[1]


# -- the completion hand-off under the port's schedule explorer ---------------


class _NullHandler(FastHandler):
    def log_message(self, fmt, *args):
        pass


def _fresh_server():
    return AsyncHTTPServer(("127.0.0.1", 0), _NullHandler, role="explorer")


def test_explorer_completion_vs_close():
    """A worker publishing a finished response races the loop closing the
    connection. Under seeded interleavings the span's fd is released
    exactly once and nothing raises."""
    from seaweedfs_tpu_torch.util import scheduler

    def body():
        srv = _fresh_server()
        a, b = socket.socketpair()
        try:
            a.setblocking(False)
            conn = _Connection(a, ("127.0.0.1", 9))
            srv._conns[conn.fd] = conn
            r, w = os.pipe()
            os.close(w)
            span = FileSpan(r, 0, 4)
            errors = []

            def worker():
                try:
                    srv._complete(conn, [b"HTTP/1.1 200 OK\r\n\r\n", span],
                                  close=False)
                except Exception as e:  # pragma: no cover
                    errors.append(e)

            def loop():
                try:
                    srv._close_conn(conn)
                    srv._handle_completions()
                except Exception as e:  # pragma: no cover
                    errors.append(e)

            t1 = threading.Thread(target=worker)
            t2 = threading.Thread(target=loop)
            t1.start()
            t2.start()
            t1.join()
            t2.join()
            srv._handle_completions()
            conn.drop_buffers()
            assert not errors, errors
            assert span.fd == -1, "span fd leaked through the race"
            assert conn.pending is None
        finally:
            b.close()
            srv.server_close()

    scheduler.explore(body, schedules=20, seed=0)


def test_explorer_pipelined_completion_order():
    """Two connections completing on worker threads each reach their own
    out queue: nothing is lost, nothing crosses connections."""
    from seaweedfs_tpu_torch.util import scheduler

    def body():
        srv = _fresh_server()
        socks = []
        try:
            conns, peers = [], []
            for i in range(2):
                a, b = socket.socketpair()
                socks += [a, b]
                a.setblocking(False)
                b.setblocking(False)
                conn = _Connection(a, ("127.0.0.1", i))
                srv._conns[conn.fd] = conn
                conns.append(conn)
                peers.append(b)

            def worker(i):
                srv._complete(conns[i], [b"RESP%d" % i], close=False)

            ts = [threading.Thread(target=worker, args=(i,))
                  for i in range(2)]
            for t in ts:
                t.start()
            srv._handle_completions()
            for t in ts:
                t.join()
            srv._handle_completions()
            for i, (conn, peer) in enumerate(zip(conns, peers)):
                queued = b"".join(bytes(c) for c in conn.out)
                try:
                    arrived = peer.recv(64)
                except BlockingIOError:
                    arrived = b""
                assert arrived + queued == b"RESP%d" % i, \
                    (i, arrived, queued)
        finally:
            for s in socks:
                s.close()
            srv.server_close()

    scheduler.explore(body, schedules=20, seed=0)


# -- the volume server under -serve.async, against the JAX one ----------------


def _jpeg(w=64, h=32, orientation=None) -> bytes:
    from PIL import Image
    img = Image.new("RGB", (w, h), (200, 10, 10))
    buf = io.BytesIO()
    if orientation:
        exif = Image.Exif()
        exif[274] = orientation
        img.save(buf, format="JPEG", exif=exif.tobytes())
    else:
        img.save(buf, format="JPEG")
    return buf.getvalue()


@pytest.fixture(scope="module")
def serving(tmp_path_factory):
    """Four one-server clusters: the port threaded, the port async, the
    port async with sendfile off (all three tracking heat) and the JAX
    async; each holds the same needles, written in the same order."""
    from seaweedfs_tpu.operation import operations as jax_ops
    from tests.cluster_util import Cluster as JaxCluster

    kinds = {
        "port-threaded": {"heat_track": True},
        "port-async": {"heat_track": True,
                       "serve": ServeConfig(async_mode=True)},
        "port-async-copy": {"heat_track": True,
                            "serve": ServeConfig(async_mode=True,
                                                 sendfile=False)},
        "jax-async": {"heat_track": True,
                      "serve": jax_hs.ServeConfig(async_mode=True)},
    }
    rng = np.random.default_rng(11)
    plain = rng.bytes(200000) + b"MARKER" + b"z" * 500
    text = rng.bytes(3000).hex().encode()
    big = rng.bytes((5 << 20) // 2)
    clusters, fids = {}, {}
    try:
        for kind, kw in kinds.items():
            d = tmp_path_factory.mktemp(f"serve-{kind}")
            if kind.startswith("jax"):
                c = JaxCluster(d, n_volume_servers=1, volume_kwargs=kw)
                ops = jax_ops
            else:
                c = Cluster(d, n_volume_servers=1, volume_kwargs=[kw])
                ops = port_ops
            clusters[kind] = c
            f = {"plain": _upload(c, plain, "t.bin"),
                 "gzip": _post(c, gzip.compress(text, mtime=0),
                               {"Content-Type": "text/plain",
                                "Content-Encoding": "gzip"}),
                 "image": _post(c, _jpeg(64, 32),
                                {"Content-Type": "image/jpeg"}),
                 "manifest": ops.submit(c.master.url, big,
                                        filename="big.bin",
                                        mime="application/x-big",
                                        max_mb=1)}
            fids[kind] = f
        yield {"clusters": clusters, "fids": fids, "plain": plain,
               "text": text, "big": big}
    finally:
        for c in clusters.values():
            c.stop()


def _upload(c, data: bytes, name: str) -> str:
    """A multipart POST, as a browser form sends one."""
    a = c.assign()
    boundary = "b0undary"
    body = ((f"--{boundary}\r\nContent-Disposition: form-data; "
             f'name="file"; filename="{name}"\r\n'
             "Content-Type: application/octet-stream\r\n\r\n").encode() +
            data + f"\r\n--{boundary}--\r\n".encode())
    with c.http(f"{a['url']}/{a['fid']}", data=body, method="POST",
                headers={"Content-Type":
                         f"multipart/form-data; boundary={boundary}"}):
        pass
    return a["fid"]


def _post(c, data: bytes, headers: dict) -> str:
    a = c.assign()
    with c.http(f"{a['url']}/{a['fid']}", data=data, method="POST",
                headers=headers):
        pass
    return a["fid"]


def _raw(c, fid: str, extra: str = "", verb: str = "GET") -> bytes:
    host, port = c.volume_servers[0].url.split(":")
    return _exchange(int(port), (f"{verb} /{fid} HTTP/1.1\r\nHost: {host}"
                                 f"\r\n{extra}Connection: close\r\n\r\n"
                                 ).encode())


def _variants(c, f: dict, etag: str) -> dict:
    """Every GET variant of one cluster's needles: name -> a call that
    returns the raw reply bytes."""
    plain = f["plain"]
    vid, rest = plain.split(",")
    missing = f"{vid},{int(rest[:-8], 16) + 999:x}{rest[-8:]}"
    return {
        "get": lambda: _raw(c, plain),
        "head": lambda: _raw(c, plain, verb="HEAD"),
        "range": lambda: _raw(c, plain, "Range: bytes=200000-200005\r\n"),
        "range_tail": lambda: _raw(c, plain, "Range: bytes=-6\r\n"),
        "range_416": lambda: _raw(c, plain, "Range: bytes=999999999-\r\n"),
        "if_none_match": lambda: _raw(c, plain,
                                      f'If-None-Match: "{etag}"\r\n'),
        "gzip_accepted": lambda: _raw(c, f["gzip"],
                                      "Accept-Encoding: gzip\r\n"),
        "gzip_not_accepted": lambda: _raw(c, f["gzip"]),
        "image_resize": lambda: _raw(c, f["image"] + "?width=16"),
        "manifest": lambda: _raw(c, f["manifest"]),
        "manifest_range": lambda: _raw(
            c, f["manifest"], "Range: bytes=1047576-1049576\r\n"),
        "missing": lambda: _raw(c, missing),
        "cookie_mismatch": lambda: _raw(c, plain[:-8] + "deadbeef"),
    }


def _head_form(reply: bytes):
    """A reply as (status line, header set, body) without the Server and
    Connection lines. The JAX server writes a chunk manifest's head with
    send_response, which adds a Server line and no Connection: close,
    where the port's fast_reply writes Connection: close and no Server
    (both since PR 9; ROADMAP Queue 3)."""
    head, _, body = reply.partition(b"\r\n\r\n")
    status, *lines = head.split(b"\r\n")
    return status, sorted(line for line in lines
                          if not line.startswith((b"Server:",
                                                  b"Connection:"))), body


def test_volume_get_variants_equal_jax_async(frozen_date, serving):
    """Every GET variant answers with the same bytes on the port's async
    server (sendfile on and off), its threaded server and the JAX async
    server; the async plain GETs went through sendfile."""
    sent0 = ServeSendfileBytesCounter.labels("volume").value
    etag = None
    sweeps = {}
    for kind, c in serving["clusters"].items():
        if etag is None:
            with c.http(f"{c.volume_servers[0].url}/"
                        f"{serving['fids'][kind]['plain']}") as r:
                etag = r.headers["ETag"].strip('"')
        sweeps[kind] = {k: call() for k, call in
                        _variants(c, serving["fids"][kind], etag).items()}
    for key, want in sweeps["port-threaded"].items():
        assert sweeps["port-async"][key] == want, key
        assert sweeps["port-async-copy"][key] == want, key
        got = sweeps["jax-async"][key]
        if key.startswith("manifest"):
            assert _head_form(got) == _head_form(want), key
        else:
            assert got == want, key
    out = sweeps["port-async"]
    assert out["get"].endswith(serving["plain"])
    assert out["range"].startswith(b"HTTP/1.1 206 Partial Content")
    assert out["range"].endswith(b"MARKER")
    assert out["range_416"].startswith(b"HTTP/1.1 416")
    assert out["if_none_match"].startswith(b"HTTP/1.1 304")
    assert out["head"].endswith(b"\r\n\r\n")
    assert b"Content-Encoding: gzip" in out["gzip_accepted"]
    assert out["gzip_not_accepted"].endswith(serving["text"])
    assert out["manifest"].endswith(serving["big"])
    assert out["missing"].startswith(b"HTTP/1.1 404")
    assert out["cookie_mismatch"].startswith(b"HTTP/1.1 404")
    from PIL import Image
    small = Image.open(io.BytesIO(
        out["image_resize"].partition(b"\r\n\r\n")[2]))
    assert small.size == (16, 8)
    # the plain GET, its range and its tail through sendfile (the copy
    # server never sends a span)
    assert ServeSendfileBytesCounter.labels("volume").value - sent0 >= \
        len(serving["plain"]) + 6 + 6


def test_async_heat_counts_equal_threaded(serving):
    """Each read counts in its server's heat as on the threaded model,
    whether it went out through sendfile, fell back to the byte path (a
    compressed needle, a manifest, an image resize) or was answered from
    the span (304, 416, a cookie mismatch)."""
    counts = {}
    for kind in ("port-threaded", "port-async", "port-async-copy"):
        c, f = serving["clusters"][kind], serving["fids"][kind]
        vs = c.volume_servers[0]

        def total() -> int:
            return sum(vs.heat.window_reads(v) for loc in vs.store.locations
                       for v in list(loc.volumes))

        counts[kind] = {}
        for name, call in _variants(c, f, "0").items():
            before = total()
            call()
            counts[kind][name] = total() - before
    assert counts["port-async"] == counts["port-threaded"]
    assert counts["port-async-copy"] == counts["port-threaded"]
    assert counts["port-threaded"]["get"] == 1
    assert counts["port-threaded"]["manifest"] > 1   # its chunks too


def test_status_and_ui_pages_equal_jax(serving):
    """/status carries the JAX servers' keys (volume: Heat; master:
    Lifecycle, Heat); /ui and the master's / and /ui are the JAX pages
    with the urls and numbers taken out."""
    pages = {}
    for kind in ("port-async", "jax-async"):
        c = serving["clusters"][kind]
        vs = c.volume_servers[0]
        with c.http(f"{vs.url}/status") as r:
            vstatus = json.load(r)
        with c.http(f"{c.master.url}/status") as r:
            mstatus = json.load(r)

        def page(url):
            with c.http(url) as r:
                assert r.headers["Content-Type"] == \
                    "text/html; charset=utf-8"
                html = r.read().decode()
            for u, name in ((vs.url, "<vs>"), (c.master.url, "<m>")):
                html = html.replace(u, name)
            return re.sub(r"\d+", "N", html)

        pages[kind] = {
            "volume_status": sorted(vstatus),
            "volume_heat": sorted(vstatus["Heat"]),
            "volume_keys": sorted(vstatus["Volumes"][0]),
            "master_status": sorted(mstatus),
            "master_lifecycle": mstatus["Lifecycle"],
            "master_heat": sorted({k for rec in mstatus["Heat"].values()
                                   for k in rec}),
            "volume_ui": page(f"{vs.url}/ui"),
            "master_root": page(f"{c.master.url}/"),
            "master_ui": page(f"{c.master.url}/ui"),
        }
    assert pages["port-async"] == pages["jax-async"]
    assert "Heat" in pages["port-async"]["volume_status"]
    assert {"Lifecycle", "Heat", "IsLeader"} <= \
        set(pages["port-async"]["master_status"])


def test_sendfile_off_sends_no_span(frozen_date, serving):
    """-serve.sendfile false: the async server copies every payload
    through the byte path, and the bytes are unchanged."""
    c = serving["clusters"]["port-async-copy"]
    f = serving["fids"]["port-async-copy"]
    before = ServeSendfileBytesCounter.labels("volume").value
    out = _raw(c, f["plain"])
    assert out.endswith(serving["plain"])
    assert ServeSendfileBytesCounter.labels("volume").value == before


# -- the off contract ---------------------------------------------------------


def test_serve_async_off_builds_nothing_async():
    """Without -serve.async the seam builds the stock threaded server and
    a handler reads async_conn as None; in a fresh process a master and a
    volume server serving requests never import the async module."""
    seen = []

    class H(FastHandler):
        def log_message(self, fmt, *args):
            pass

        def do_GET(self):
            seen.append(self.async_conn)
            assert not isinstance(self.rfile, BodyReader)
            self.fast_reply(200, b"ok")

    orig = AsyncHTTPServer.__init__

    def boom(*a, **kw):
        raise AssertionError("AsyncHTTPServer made with -serve.async off")

    AsyncHTTPServer.__init__ = boom
    try:
        for serve in (None, ServeConfig()):
            srv = hs.make_http_server(("127.0.0.1", 0), H, role="gate",
                                      serve=serve)
            assert type(srv) is TrackingHTTPServer
            threading.Thread(target=srv.serve_forever, daemon=True).start()
            try:
                with urllib.request.urlopen(
                        f"http://127.0.0.1:{srv.server_address[1]}/x",
                        timeout=10) as r:
                    assert r.read() == b"ok"
            finally:
                _stop(srv)
    finally:
        AsyncHTTPServer.__init__ = orig
    assert seen == [None, None]
    script = r"""
import sys, tempfile, threading, urllib.request
from seaweedfs_tpu_torch.server.master import MasterServer
from seaweedfs_tpu_torch.server.volume import VolumeServer
from tests.test_torch_cluster import free_port_pair, wait_for
d = tempfile.mkdtemp()
m = MasterServer(port=free_port_pair(), meta_dir=d + "/m", pulse_seconds=0.2)
m.start()
vs = VolumeServer(m.url, [d], port=free_port_pair(), pulse_seconds=0.2,
                  ec_encoder="cpu")
vs.start()
try:
    wait_for(lambda: m.topo.nodes(), what="the server registered")
    for url in (m.url + "/dir/status", vs.url + "/status"):
        urllib.request.urlopen("http://" + url, timeout=10).read()
    assert "seaweedfs_tpu_torch.util.async_server" not in sys.modules
    assert not [t.name for t in threading.enumerate()
                if t.name.startswith("serve-")]
finally:
    vs.stop()
    m.stop()
print("clean")
"""
    out = subprocess.run([sys.executable, "-c", script], cwd=REPO,
                         env=dict(os.environ, PYTHONPATH=REPO),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip().endswith("clean"), \
        out.stderr[-2000:]


# -- -serve.* flags -----------------------------------------------------------


@pytest.mark.parametrize("argv", [
    [],
    ["-serve.async"],
    ["-serve.async", "-serve.maxConns", "64", "-serve.keepAliveBudget",
     "32", "-serve.workers", "4", "-serve.sendfile", "false"],
    ["-serve.sendfile", "0"],
    ["-serve.sendfile", "yes", "-serve.workers", "2"],
], ids=["default", "async", "all", "sendfile-0", "sendfile-yes"])
def test_serve_flags_equal_jax(argv):
    from seaweedfs_tpu.command import servers as jax_servers
    from seaweedfs_tpu_torch.command import servers
    for role in ("_master_parser", "_volume_parser"):
        port = servers._serve_config(getattr(servers, role)().parse_args(
            argv))
        jax = jax_servers._serve_config(getattr(jax_servers, role)()
                                        .parse_args(argv))
        assert dataclasses.asdict(port) == dataclasses.asdict(jax), role
        assert isinstance(port, ServeConfig)


# -- QoS at frame time, against the JAX core ----------------------------------


@pytest.mark.parametrize("seed", range(3))
def test_frame_shed_equals_jax(frozen_date, seed):
    """Seeded tenants framing requests on seeded connections, near the
    connection cap: the port's _frame_shed sheds the requests the JAX
    core sheds, with the same 429 bytes, the same tenant on each
    connection and the same per-tenant connection counts."""
    from seaweedfs_tpu import qos as jax_qos
    from seaweedfs_tpu.stats.metrics import \
        ServeShedCounter as JaxServeShedCounter
    from seaweedfs_tpu_torch import qos
    cap = 8
    tenants = ["vip", "bulk", "default", "_internal"]
    rng = np.random.default_rng(seed)
    steps = [(int(rng.integers(0, cap)), tenants[int(rng.integers(0, 4))])
             for _ in range(60)]
    runs = {}
    try:
        for name, mod, pkg, handler, headers, shed_c in (
                ("port", async_server, qos, PortEcho, hs.HeaderDict,
                 ServeShedCounter.labels("framing", "qos")),
                ("jax", jax_async, jax_qos, JaxEcho, jax_hs.HeaderDict,
                 JaxServeShedCounter.labels("framing", "qos"))):
            mgr = pkg.configure(pkg.QosConfig(weights={"vip": 4.0}))
            assert mod._qos is mgr
            srv = mod.AsyncHTTPServer(("127.0.0.1", 0), handler,
                                      role="framing", max_conns=cap)
            before = shed_c.value
            pairs = []

            def fresh(i):
                a, b = socket.socketpair()
                a.setblocking(False)
                b.settimeout(5)
                conn = mod._Connection(a, ("127.0.0.1", i))
                srv._conns[conn.fd] = conn
                return conn, b

            slots = [fresh(i) for i in range(cap)]
            trail = []
            try:
                for i, tenant in steps:
                    conn, peer = slots[i]
                    shim = srv._make_shim(conn)
                    shim.command, shim.path = "GET", f"/1,{i:x}01020304"
                    shim.request_version = "HTTP/1.1"
                    shim.close_connection = False
                    shim.headers = headers({"x-seaweed-tenant": tenant})
                    shed = srv._frame_shed(conn, shim)
                    reply = b""
                    if shed:
                        while True:
                            d = peer.recv(65536)
                            if not d:
                                break
                            reply += d
                        # the loop closed it after the reply drained
                        assert srv._conns.get(conn.fd) is not conn
                        pairs.append((conn.sock, peer))
                        slots[i] = fresh(i)
                    trail.append((shed, reply, conn.tenant,
                                  sorted(mgr._conns.items())))
                runs[name] = (trail, shed_c.value - before)
            finally:
                for conn, peer in slots:
                    srv._close_conn(conn)
                    peer.close()
                for a, b in pairs:
                    b.close()
                srv.server_close()
                pkg.reset()
    finally:
        qos.reset()
        jax_qos.reset()
    assert runs["port"] == runs["jax"]
    trail, sheds = runs["port"]
    assert sheds == sum(1 for t in trail if t[0]) > 0
    assert all(t[1].startswith(b"HTTP/1.1 429 Too Many Requests\r\n")
               and b"Retry-After: 1\r\n" in t[1] for t in trail if t[0])
    assert not any(t[0] for t, (_, tenant) in zip(trail, steps)
                   if tenant == "_internal")
