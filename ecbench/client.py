"""A closed loop of HTTP/1.1 keep-alive clients on one selector thread.

Each client sends one GET at a time and sends its next only when the
last reply has been read whole (``weed benchmark``'s readers, ``-c``
of them). A client keeps one connection to each server it has sent to.
Every request is timed from its send to the last byte of its reply; the
body is kept for the check that follows the window.
"""

from __future__ import annotations

import selectors
import socket
import time
from typing import List, Optional, Sequence, Tuple

Job = Tuple[int, bytes, int]   # (server index, request bytes, tag)


class Record:
    __slots__ = ("client", "tag", "sent", "done", "status", "body")

    def __init__(self, client: int, tag: int, sent: float):
        self.client, self.tag, self.sent = client, tag, sent
        self.done, self.status, self.body = 0.0, 0, b""


def get_request(path: str) -> bytes:
    return f"GET /{path} HTTP/1.1\r\nHost: bench\r\n\r\n".encode()


class _Conn:
    __slots__ = ("client", "server", "sock", "buf", "need", "head_end")

    def __init__(self, client: int, server: int, sock):
        self.client, self.server, self.sock = client, server, sock
        self.buf = bytearray()
        self.need = -1
        self.head_end = 0


def run(ports: Sequence[int], jobs: Sequence[Sequence[Job]],
        seconds: Optional[float] = None, grace: float = 60.0
        ) -> Tuple[List[Record], float, float]:
    """Drive ``len(jobs)`` clients. With ``seconds`` each client cycles
    its list until the time is up (the last reply is awaited, at most
    ``grace`` seconds); without, it sends its list once. Returns the
    records, the start and the end (``time.perf_counter``) of sending."""
    sel = selectors.DefaultSelector()
    conns = {}
    records: List[Record] = []
    nxt = [0] * len(jobs)
    inflight = {}          # client -> (conn, record)
    start = time.perf_counter()
    deadline = start + seconds if seconds is not None else None

    def connect(c: int, s: int) -> _Conn:
        sock = socket.create_connection(("127.0.0.1", ports[s]), timeout=30)
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        sock.setblocking(False)
        conn = _Conn(c, s, sock)
        sel.register(sock, selectors.EVENT_READ, conn)
        conns[c, s] = conn
        return conn

    def drop(conn: _Conn) -> None:
        sel.unregister(conn.sock)
        conn.sock.close()
        conns.pop((conn.client, conn.server), None)

    def send_next(c: int) -> None:
        i = nxt[c]
        if deadline is None and i >= len(jobs[c]):
            return
        if deadline is not None and time.perf_counter() >= deadline:
            return
        s, req, tag = jobs[c][i % len(jobs[c])]
        nxt[c] = i + 1
        conn = conns.get((c, s)) or connect(c, s)
        rec = Record(c, tag, time.perf_counter())
        records.append(rec)
        try:
            conn.sock.sendall(req)
        except OSError:
            rec.done, rec.status = time.perf_counter(), -1
            drop(conn)
            send_next(c)
            return
        inflight[c] = (conn, rec)

    def finish(c: int, status: int, body: bytes) -> None:
        _, rec = inflight.pop(c)
        rec.done, rec.status, rec.body = time.perf_counter(), status, body
        send_next(c)

    for c in range(len(jobs)):
        send_next(c)
    while inflight:
        now = time.perf_counter()
        if deadline is not None and now > deadline + grace:
            break
        for key, _ in sel.select(0.05):
            conn = key.data
            try:
                data = conn.sock.recv(1 << 20)
            except BlockingIOError:
                continue
            except OSError:
                data = b""
            if not data:
                drop(conn)
                if conn.client in inflight and \
                        inflight[conn.client][0] is conn:
                    finish(conn.client, -1, b"")
                continue
            conn.buf += data
            while True:
                if conn.need < 0:
                    end = conn.buf.find(b"\r\n\r\n")
                    if end < 0:
                        break
                    head = bytes(conn.buf[:end]).lower()
                    i = head.find(b"\r\ncontent-length:")
                    j = head.find(b"\r\n", i + 2)
                    clen = int(head[i + 17:j if j > 0 else len(head)]) \
                        if i >= 0 else 0
                    conn.head_end = end + 4
                    conn.need = end + 4 + clen
                if len(conn.buf) < conn.need:
                    break
                status = int(conn.buf[9:12])
                body = bytes(conn.buf[conn.head_end:conn.need])
                del conn.buf[:conn.need]
                conn.need = -1
                if conn.client in inflight:
                    finish(conn.client, status, body)
    end = time.perf_counter()
    for c, (conn, rec) in list(inflight.items()):
        rec.done, rec.status = end, -1
    for conn in list(conns.values()):
        conn.sock.close()
    sel.close()
    return records, start, deadline if deadline is not None else end
