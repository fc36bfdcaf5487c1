"""The port's WebDAV and FTP gateways against the JAX package's.

Each package runs its cluster and filer (``make_sides``) with a WebDAV
gateway and two FTP gateways (one rooted at ``/``, one at ``/jail``) on
top. The same requests go to both and must get the same answers:

- WebDAV: the status, the headers (bar ``Date`` and ``Server``) and the
  body of OPTIONS, PROPFIND at depth 0 and 1, MKCOL, PUT, GET with Range,
  HEAD, DELETE, MOVE and COPY with and without ``Overwrite: F``, and the
  fake LOCK/UNLOCK. Normalised: ``getlastmodified`` (stamped from the
  wall clock by a COPY) and the LOCK token (from the clock in
  nanoseconds); bodies over 4 KiB are compared by sha256.
- FTP: every reply line of a session of USER, PASS, SYST, TYPE, NOOP,
  FEAT, PWD, CWD, PASV, LIST, NLST, RETR, STOR, DELE, MKD, RMD, an
  unknown command and QUIT, with the PASV port masked, and the bytes of
  each data connection; ``..`` stays inside ``-ftpRoot``.
"""

import hashlib
import http.client
import re
import socket

import numpy as np
import pytest

from seaweedfs_tpu.filer import http_client as jax_http
from seaweedfs_tpu.ftpd import FtpServer as JaxFtp
from seaweedfs_tpu.server.webdav import WebDavServer as JaxDav
from seaweedfs_tpu_torch.filer import http_client as port_http
from seaweedfs_tpu_torch.ftpd import FtpServer as PortFtp
from seaweedfs_tpu_torch.server.webdav import WebDavServer as PortDav
from tests.test_torch_cluster import free_port_pair
from tests.test_torch_filer_server import make_sides


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    sides, undo = make_sides(tmp_path_factory)
    servers = {}
    try:
        for name, dav, ftp in (("jax", JaxDav, JaxFtp),
                               ("port", PortDav, PortFtp)):
            url = sides[name].filer.url
            servers[name] = {}
            # each binds before the next port is picked
            for key, make in (
                    ("dav", lambda p: dav(filer_url=url, port=p)),
                    ("ftp", lambda p: ftp(url, port=p)),
                    ("jail", lambda p: ftp(url, port=p, ftp_root="/jail"))):
                servers[name][key] = make(free_port_pair())
                servers[name][key].start()
        yield sides, servers
    finally:
        for group in servers.values():
            for s in group.values():
                s.stop()
        for s in sides.values():
            s.stop()
        undo()


# -- WebDAV ---------------------------------------------------------------------


def dav_request(url, method, path, body=b"", headers=None):
    host, port = url.split(":")
    conn = http.client.HTTPConnection(host, int(port), timeout=60)
    try:
        conn.request(method, path, body=body or None, headers=headers or {})
        r = conn.getresponse()
        data = r.read()
    finally:
        conn.close()
    hs = []
    for k, v in r.getheaders():
        if k.lower() in ("date", "server"):
            continue
        if k.lower() == "lock-token":
            v = re.sub(r"opaquelocktoken:[0-9a-f]+", "TOKEN", v)
        hs.append((k, v.replace(url, "DAV")))
    data = re.sub(rb"<ns0:getlastmodified>[^<]*<", b"<LM><", data)
    data = re.sub(rb"<D:getlastmodified>[^<]*<", b"<LM><", data)
    data = re.sub(rb"opaquelocktoken:[0-9a-f]+", b"TOKEN", data)
    if len(data) > 4096:
        data = hashlib.sha256(data).hexdigest().encode()
    return r.status, hs, data


def dav_both(servers, method, path, body=b"", headers=None):
    out = {}
    for name, group in servers.items():
        url = group["dav"].url
        hs = {k: v.replace("DAV", url) for k, v in (headers or {}).items()}
        out[name] = dav_request(url, method, path, body, hs)
    assert out["port"] == out["jax"], (method, path, headers)
    return out["port"]


def test_dav_verbs_answer_alike(env):
    _, servers = env
    status, hs, _ = dav_both(servers, "OPTIONS", "/")
    assert status == 200 and dict(hs)["DAV"] == "1,2"
    assert dav_both(servers, "MKCOL", "/docs")[0] == 201
    assert dav_both(servers, "MKCOL", "/docs")[0] == 405
    assert dav_both(servers, "PUT", "/docs/report.txt", b"dav content",
                    {"Content-Type": "text/plain"})[0] == 201
    assert dav_both(servers, "GET", "/docs/report.txt")[2] == b"dav content"
    assert dav_both(servers, "HEAD", "/docs/report.txt")[0] == 200
    assert dav_both(servers, "GET", "/docs")[0] == 405
    assert dav_both(servers, "HEAD", "/docs")[0] == 405
    assert dav_both(servers, "GET", "/ghost.txt")[0] == 404
    assert dav_both(servers, "HEAD", "/ghost.txt")[0] == 404
    data = np.random.default_rng(5).bytes((1 << 20) + 77)
    assert dav_both(servers, "PUT", "/big/blob.bin", data)[0] == 201
    status, _, body = dav_both(servers, "GET", "/big/blob.bin")
    assert body == hashlib.sha256(data).hexdigest().encode()
    for rng in ("bytes=10-19", "bytes=262100-262200", "bytes=-5",
                f"bytes={len(data)}-"):
        dav_both(servers, "GET", "/big/blob.bin", headers={"Range": rng})


@pytest.mark.parametrize("depth", ["0", "1", None])
def test_propfind_answers_alike(env, depth):
    _, servers = env
    dav_both(servers, "MKCOL", f"/pf{depth}")
    dav_both(servers, "PUT", f"/pf{depth}/a.txt", b"aaaa",
             {"Content-Type": "text/a"})
    dav_both(servers, "MKCOL", f"/pf{depth}/sub")
    hs = {"Depth": depth} if depth else {}
    status, _, body = dav_both(servers, "PROPFIND", f"/pf{depth}",
                               b"<propfind/>", hs)
    assert status == 207 and body.count(b"response>") == \
        (2 if depth == "0" else 6)
    assert dav_both(servers, "PROPFIND", f"/pf{depth}/a.txt",
                    headers=hs)[0] == 207
    assert dav_both(servers, "PROPFIND", "/", headers={"Depth": "0"})[0] \
        == 207
    assert dav_both(servers, "PROPFIND", "/ghost", headers=hs)[0] == 404


def test_move_copy_delete_answer_alike(env):
    _, servers = env
    for p, b in (("/mv-src.txt", b"move me"), ("/now-a.txt", b"a"),
                 ("/now-b.txt", b"b"), ("/cp-src.txt", b"copy me")):
        dav_both(servers, "PUT", p, b)
    dst = {"Destination": "http://DAV/mv-dst.txt"}
    assert dav_both(servers, "MOVE", "/mv-src.txt", headers=dst)[0] == 201
    assert dav_both(servers, "GET", "/mv-dst.txt")[2] == b"move me"
    assert dav_both(servers, "GET", "/mv-src.txt")[0] == 404
    assert dav_both(servers, "MOVE", "/mv-src.txt", headers=dst)[0] == 404
    assert dav_both(servers, "MOVE", "/now-a.txt")[0] == 400
    no = {"Destination": "http://DAV/now-b.txt", "Overwrite": "F"}
    assert dav_both(servers, "MOVE", "/now-a.txt", headers=no)[0] == 412
    assert dav_both(servers, "COPY", "/now-a.txt", headers=no)[0] == 412
    yes = {"Destination": "http://DAV/now-b.txt"}
    assert dav_both(servers, "MOVE", "/now-a.txt", headers=yes)[0] == 204
    assert dav_both(servers, "GET", "/now-b.txt")[2] == b"a"
    cp = {"Destination": "http://DAV/cp-dst.txt"}
    assert dav_both(servers, "COPY", "/cp-src.txt", headers=cp)[0] == 201
    assert dav_both(servers, "COPY", "/cp-src.txt", headers=cp)[0] == 204
    assert dav_both(servers, "GET", "/cp-dst.txt")[2] == b"copy me"
    assert dav_both(servers, "GET", "/cp-src.txt")[2] == b"copy me"
    dav_both(servers, "MKCOL", "/rmdir")
    dav_both(servers, "PUT", "/rmdir/f.txt", b"x")
    assert dav_both(servers, "COPY", "/rmdir",
                    headers={"Destination": "http://DAV/r2"})[0] == 501
    assert dav_both(servers, "DELETE", "/rmdir")[0] == 204
    assert dav_both(servers, "GET", "/rmdir/f.txt")[0] == 404
    assert dav_both(servers, "DELETE", "/rmdir")[0] == 404


def test_lock_unlock_answer_alike(env):
    _, servers = env
    status, hs, body = dav_both(servers, "LOCK", "/locked.txt", b"<lock/>")
    assert status == 200 and b"lockdiscovery" in body
    assert dict(hs)["Lock-Token"] == "<TOKEN>"
    assert dav_both(servers, "UNLOCK", "/locked.txt")[0] == 204


# -- FTP -----------------------------------------------------------------------------


class Session:
    """A raw FTP control connection that records every reply line."""

    def __init__(self, srv):
        self.srv = srv
        self.sock = socket.create_connection((srv.ip, srv.port), timeout=30)
        self.f = self.sock.makefile("rb")
        self.log = [self._reply()]

    def _reply(self) -> str:
        line = self.f.readline().decode()
        out = line
        if line[3:4] == "-":
            while True:
                more = self.f.readline().decode()
                out += more
                if more[:3] == line[:3] and more[3:4] == " ":
                    break
        return out

    def cmd(self, line: str) -> str:
        self.sock.sendall(line.encode() + b"\r\n")
        r = self._reply()
        self.log.append(re.sub(r"\(127,0,0,1,\d+,\d+\)", "(PASV)", r))
        return r

    def data(self, line: str, upload: bytes = None) -> bytes:
        """PASV, then a transfer command; the bytes that came back."""
        r = self.cmd("PASV")
        nums = [int(x) for x in re.search(r"\(([\d,]+)\)", r).group(1)
                .split(",")]
        conn = socket.create_connection(
            (".".join(map(str, nums[:4])), nums[4] * 256 + nums[5]),
            timeout=30)
        self.sock.sendall(line.encode() + b"\r\n")
        got = b""
        with conn:
            if upload is not None:
                first = self._reply()
                if first.startswith("1"):
                    conn.sendall(upload)
                    conn.shutdown(socket.SHUT_WR)
            else:
                while True:
                    chunk = conn.recv(1 << 16)
                    if not chunk:
                        break
                    got += chunk
                first = self._reply()
        self.log.append(first)
        if first.startswith("1"):       # a preliminary reply: one more
            self.log.append(self._reply())
        return got

    def close(self):
        self.f.close()
        self.sock.close()


def ftp_script(s: Session, blobs) -> list:
    """The same session against either gateway: every data transfer."""
    out = []
    for c in ("USER anyone", "PASS anything", "SYST", "TYPE I", "NOOP",
              "FEAT", "PWD", "SITE CHMOD 777 x", "RETR"):
        s.cmd(c)
    for path, data in blobs:
        s.data(f"STOR {path}", data)
    s.cmd("CWD /docs")
    s.cmd("PWD")
    out.append(sorted(s.data("NLST").split(b"\r\n")))
    out.append(sorted(s.data("LIST").split(b"\r\n")))
    out.append(sorted(s.data("LIST -la /docs").split(b"\r\n")))
    for path, data in blobs:
        got = s.data(f"RETR /{path.lstrip('/')}")
        out.append(hashlib.sha256(got).hexdigest() ==
                   hashlib.sha256(data).hexdigest())
    out.append(s.data("RETR /nope.bin"))
    s.cmd("DELE hello.txt")
    out.append(sorted(s.data("NLST /docs").split(b"\r\n")))
    s.cmd("MKD /made")
    out.append(s.data("NLST /made"))
    s.cmd("RMD /made")
    s.cmd("CWD ../../..")
    s.cmd("PWD")
    s.cmd("QUIT")
    return out


def test_ftp_sessions_answer_alike(env):
    _, servers = env
    rng = np.random.default_rng(8)
    blobs = [("/docs/hello.txt", b"over ftp"),
             ("/docs/big.bin", rng.bytes((1 << 20) + 3)),
             ("notes.txt", rng.bytes(4096))]
    logs, outs = {}, {}
    for name, group in servers.items():
        s = Session(group["ftp"])
        try:
            outs[name] = ftp_script(s, blobs)
        finally:
            s.close()
        logs[name] = s.log
    assert logs["port"] == logs["jax"]
    assert outs["port"] == outs["jax"]
    assert all(x is True for x in outs["port"] if isinstance(x, bool))
    assert logs["port"][0].startswith("220 ")


def test_ftp_root_confinement_answers_alike(env):
    sides, servers = env
    for name, mod in (("jax", jax_http), ("port", port_http)):
        mod.put(sides[name].filer.url, "/outside.txt", b"secret")
        mod.put(sides[name].filer.url, "/jail/inside.txt", b"public")
    logs, outs = {}, {}
    for name, group in servers.items():
        s = Session(group["jail"])
        try:
            s.cmd("USER a")
            s.cmd("PASS b")
            got = [s.data("RETR inside.txt")]
            got.append(s.data("RETR ../outside.txt"))
            s.cmd("CWD ../..")
            s.cmd("PWD")
            got.append(s.data("RETR outside.txt"))
            got.append(s.data("RETR /inside.txt"))
            s.cmd("QUIT")
        finally:
            s.close()
        logs[name], outs[name] = s.log, got
    assert logs["port"] == logs["jax"]
    assert outs["port"] == outs["jax"] == [b"public", b"", b"", b"public"]
    assert any(line.startswith("550") for line in logs["port"])
