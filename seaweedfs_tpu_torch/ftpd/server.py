"""Minimal FTP server bridging to the filer namespace.

Reference scope: weed/ftpd/ftp_server.go is an 81-LoC skeleton that
wires a third-party FTP library onto the filer. This is the same idea
without the dependency: a small RFC-959 subset — USER/PASS (accept
all, like the skeleton), SYST, PWD, CWD, TYPE, PASV, LIST, RETR, STOR,
DELE, MKD, RMD, QUIT — speaking passive mode only, with file bytes
moving through the filer's HTTP API. Enough for stdlib ftplib and
simple clients; not a hardened public-facing daemon. The port of
``seaweedfs_tpu.ftpd.server``: the same replies.
"""

from __future__ import annotations

import io
import posixpath
import socket
import socketserver
import threading
import urllib.error
import urllib.request
from typing import Optional

from seaweedfs_tpu_torch.util import wlog

log = wlog.logger("ftpd")


class FtpServer:
    def __init__(self, filer_url: str, ip: str = "127.0.0.1",
                 port: int = 2121, ftp_root: str = "/"):
        self.filer_url = filer_url
        self.ip = ip
        self.port = port
        self.root = ftp_root.rstrip("/") or ""
        self._server: Optional[socketserver.ThreadingTCPServer] = None
        self._thread: Optional[threading.Thread] = None

    @property
    def url(self) -> str:
        return f"{self.ip}:{self.port}"

    def start(self) -> None:
        gateway = self

        class Handler(_FtpHandler):
            ftp = gateway

        self._server = socketserver.ThreadingTCPServer(
            (self.ip, self.port), Handler, bind_and_activate=True)
        self._server.daemon_threads = True
        # lint: thread-ok(listener thread; per-session state is minted at accept)
        self._thread = threading.Thread(
            target=self._server.serve_forever, name=f"ftpd-{self.port}",
            daemon=True)
        self._thread.start()
        log.info("ftp gateway %s started (filer %s, root %r)",
                 self.url, self.filer_url, self.root or "/")

    def stop(self) -> None:
        if self._server is not None:
            self._server.shutdown()
            self._server.server_close()

    # -- filer bridge ---------------------------------------------------------

    def _url(self, path: str) -> str:
        return f"http://{self.filer_url}{self.root}{path}"

    def read_file(self, path: str) -> bytes:
        with urllib.request.urlopen(self._url(path), timeout=30) as r:
            return r.read()

    def write_file(self, path: str, data: bytes) -> None:
        req = urllib.request.Request(self._url(path), data=data,
                                     method="POST")
        with urllib.request.urlopen(req, timeout=30):
            pass

    def delete_path(self, path: str, recursive: bool = False) -> None:
        url = self._url(path)
        if recursive:
            url += "?recursive=true"
        req = urllib.request.Request(url, method="DELETE")
        with urllib.request.urlopen(req, timeout=30):
            pass

    def list_dir(self, path: str):
        """[(name, is_dir, size)] via the filer's JSON listing."""
        import json
        req = urllib.request.Request(
            self._url(path if path.endswith("/") else path + "/"),
            headers={"Accept": "application/json"})
        with urllib.request.urlopen(req, timeout=30) as r:
            doc = json.load(r)
        out = []
        for e in doc.get("Entries") or []:
            name = e.get("FullPath", "").rsplit("/", 1)[-1]
            out.append((name, bool(e.get("IsDirectory")),
                        int(e.get("FileSize", 0) or 0)))
        return out

    def mkdir(self, path: str) -> None:
        # the filer auto-creates parents; write+delete a marker
        marker = path.rstrip("/") + "/.keep"
        self.write_file(marker, b"")


class _FtpHandler(socketserver.StreamRequestHandler):
    ftp: FtpServer  # set by FtpServer.start

    def setup(self):
        super().setup()
        self.cwd = "/"
        self.pasv: Optional[socket.socket] = None

    def _reply(self, code: int, text: str) -> None:
        self.wfile.write(f"{code} {text}\r\n".encode())

    def _path(self, arg: str) -> str:
        """Resolve a client path, normalized so '..' can never climb
        out of the configured ftp_root (round-2 advisory: RETR/STOR/
        DELE/RMD with ../ reached the whole filer namespace)."""
        if not arg or arg == ".":
            p = self.cwd
        elif arg.startswith("/"):
            p = arg
        else:
            p = f"{self.cwd.rstrip('/')}/{arg}"
        norm = posixpath.normpath(p)
        # normpath on an ABSOLUTE path clamps '..' at '/', so the
        # result cannot traverse above the root the server prepends
        return norm if norm.startswith("/") else "/"

    def _open_data(self) -> Optional[socket.socket]:
        if self.pasv is None:
            self._reply(425, "Use PASV first")
            return None
        listener, self.pasv = self.pasv, None
        listener.settimeout(10)
        try:
            conn, _ = listener.accept()
            return conn
        except socket.timeout:
            self._reply(425, "Data connection timed out")
            return None
        finally:
            listener.close()

    def handle(self):
        self._reply(220, "seaweedfs-tpu FTP ready")
        while True:
            try:
                line = self.rfile.readline()
            except (ConnectionError, socket.timeout):
                return
            if not line:
                return
            parts = line.decode("utf-8", "replace").strip().split(" ", 1)
            cmd = parts[0].upper()
            arg = parts[1] if len(parts) > 1 else ""
            try:
                if not self._dispatch(cmd, arg):
                    return
            except urllib.error.HTTPError as e:
                self._reply(550, f"filer error {e.code}")
            except Exception as e:  # keep the session alive
                self._reply(451, f"error: {e}")

    def _dispatch(self, cmd: str, arg: str) -> bool:
        if cmd == "USER":
            self._reply(331, "any password")
        elif cmd == "PASS":
            self._reply(230, "logged in")
        elif cmd == "SYST":
            self._reply(215, "UNIX Type: L8")
        elif cmd in ("TYPE", "NOOP"):
            self._reply(200, "ok")
        elif cmd == "FEAT":
            self.wfile.write(b"211-Features:\r\n PASV\r\n211 End\r\n")
        elif cmd == "PWD":
            self._reply(257, f'"{self.cwd}"')
        elif cmd == "CWD":
            self.cwd = self._path(arg)
            self._reply(250, "ok")
        elif cmd == "PASV":
            listener = socket.socket()
            listener.bind((self.ftp.ip, 0))
            listener.listen(1)
            self.pasv = listener
            host = self.ftp.ip.replace(".", ",")
            p = listener.getsockname()[1]
            self._reply(227, f"Entering Passive Mode "
                             f"({host},{p >> 8},{p & 0xFF})")
        elif cmd == "LIST" or cmd == "NLST":
            conn = self._open_data()
            if conn is None:
                return True
            self._reply(150, "listing")
            with conn:
                for name, is_dir, size in self.ftp.list_dir(
                        self._path(arg if not arg.startswith("-") else "")):
                    if cmd == "NLST":
                        conn.sendall(f"{name}\r\n".encode())
                    else:
                        kind = "d" if is_dir else "-"
                        conn.sendall(
                            f"{kind}rw-r--r-- 1 weed weed {size:>12} "
                            f"Jan  1 00:00 {name}\r\n".encode())
            self._reply(226, "done")
        elif cmd == "RETR":
            conn = self._open_data()
            if conn is None:
                return True
            data = self.ftp.read_file(self._path(arg))
            self._reply(150, f"opening ({len(data)} bytes)")
            with conn:
                conn.sendall(data)
            self._reply(226, "done")
        elif cmd == "STOR":
            conn = self._open_data()
            if conn is None:
                return True
            self._reply(150, "ready")
            buf = io.BytesIO()
            with conn:
                while True:
                    chunk = conn.recv(1 << 16)
                    if not chunk:
                        break
                    buf.write(chunk)
            self.ftp.write_file(self._path(arg), buf.getvalue())
            self._reply(226, "stored")
        elif cmd == "DELE":
            self.ftp.delete_path(self._path(arg))
            self._reply(250, "deleted")
        elif cmd == "MKD":
            self.ftp.mkdir(self._path(arg))
            self._reply(257, "created")
        elif cmd == "RMD":
            self.ftp.delete_path(self._path(arg), recursive=True)
            self._reply(250, "removed")
        elif cmd == "QUIT":
            self._reply(221, "bye")
            return False
        else:
            self._reply(502, f"{cmd} not implemented")
        return True
