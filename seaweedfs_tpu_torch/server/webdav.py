"""WebDAV server over the filer (reference: weed/server/webdav_server.go,
which wraps golang.org/x/net/webdav; here the DAV verbs are implemented
directly on the filer's RPC and HTTP surface). The port of
``seaweedfs_tpu.server.webdav``: the same replies and XML.

Supports the class-2 verb set clients actually use: OPTIONS, PROPFIND
(Depth 0/1), MKCOL, GET/HEAD, PUT, DELETE, MOVE, COPY, and fake
LOCK/UNLOCK (like most non-locking servers, enough for macOS/Windows
clients to mount read-write).
"""

from __future__ import annotations

import threading
import time
import urllib.error
import urllib.parse
import urllib.request
import xml.etree.ElementTree as ET
from seaweedfs_tpu_torch.util.http_server import (FastHandler, ServeConfig,
                                            make_http_server)
from typing import List, Optional

from seaweedfs_tpu_torch import rpc
from seaweedfs_tpu_torch.filer import filechunks
from seaweedfs_tpu_torch.filer import http_client as filer_http
from seaweedfs_tpu_torch.filer.filerstore import join_path, normalize_path, split_path
from seaweedfs_tpu_torch.pb import filer_pb2, filer_stub

DAV_NS = "DAV:"


class WebDavServer:
    def __init__(self, filer_url: str, ip: str = "127.0.0.1",
                 port: int = 7333, root: str = "/",
                 serve: Optional[ServeConfig] = None):
        self.filer_url = filer_url
        self.ip = ip
        self.port = port
        self.root = normalize_path(root)
        self.serve = serve or ServeConfig()
        self._http_server = None
        self._http_thread = None

    @property
    def url(self) -> str:
        return f"{self.ip}:{self.port}"

    def start(self) -> None:
        self._http_server = make_http_server(
            (self.ip, self.port), _make_handler(self),
            role="webdav", serve=self.serve)
        # lint: thread-ok(listener thread; ingress wrappers mint request context)
        self._http_thread = threading.Thread(
            target=self._http_server.serve_forever,
            name=f"webdav-{self.port}", daemon=True)
        self._http_thread.start()

    def stop(self) -> None:
        if self._http_server:
            self._http_server.shutdown()
            self._http_server.server_close()

    # -- filer plumbing -------------------------------------------------------

    @property
    def stub(self):
        return filer_stub(self.filer_url)

    def full_path(self, dav_path: str) -> str:
        return normalize_path(join_path(self.root, dav_path.lstrip("/")))

    def find(self, dav_path: str) -> Optional[filer_pb2.Entry]:
        p = self.full_path(dav_path)
        if p == "/":
            return filer_pb2.Entry(name="/", is_directory=True)
        d, n = split_path(p)
        try:
            return self.stub.LookupDirectoryEntry(
                filer_pb2.LookupDirectoryEntryRequest(
                    directory=d, name=n)).entry
        except rpc.RpcError:
            return None

    def children(self, dav_path: str) -> List[filer_pb2.Entry]:
        try:
            return [r.entry for r in self.stub.ListEntries(
                filer_pb2.ListEntriesRequest(
                    directory=self.full_path(dav_path), limit=10000))]
        except rpc.RpcError:
            return []


def _prop_response(href: str, entry: filer_pb2.Entry) -> ET.Element:
    resp = ET.Element(f"{{{DAV_NS}}}response")
    ET.SubElement(resp, f"{{{DAV_NS}}}href").text = urllib.parse.quote(href)
    propstat = ET.SubElement(resp, f"{{{DAV_NS}}}propstat")
    prop = ET.SubElement(propstat, f"{{{DAV_NS}}}prop")
    ET.SubElement(prop, f"{{{DAV_NS}}}displayname").text = entry.name
    rt = ET.SubElement(prop, f"{{{DAV_NS}}}resourcetype")
    if entry.is_directory:
        ET.SubElement(rt, f"{{{DAV_NS}}}collection")
    else:
        size = filechunks.total_size(entry.chunks)
        ET.SubElement(prop,
                      f"{{{DAV_NS}}}getcontentlength").text = str(size)
        if entry.attributes.mime:
            ET.SubElement(prop, f"{{{DAV_NS}}}getcontenttype").text = \
                entry.attributes.mime
    ET.SubElement(prop, f"{{{DAV_NS}}}getlastmodified").text = \
        time.strftime("%a, %d %b %Y %H:%M:%S GMT",
                      time.gmtime(entry.attributes.mtime or 0))
    ET.SubElement(propstat, f"{{{DAV_NS}}}status").text = \
        "HTTP/1.1 200 OK"
    return resp


def _make_handler(dav: WebDavServer):
    class Handler(FastHandler):
        protocol_version = "HTTP/1.1"
        disable_nagle_algorithm = True  # small replies must not wait on delayed ACKs

        def log_message(self, fmt, *args):
            pass

        def _reply(self, code: int, body: bytes = b"",
                   headers: Optional[dict] = None) -> None:
            self.send_response(code)
            for k, v in (headers or {}).items():
                self.send_header(k, v)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            if self.command != "HEAD" and body:
                self.wfile.write(body)

        def _body(self) -> bytes:
            # framing-aware (Content-Length or chunked), identical on
            # both server models
            return self.read_body()

        def _path(self) -> str:
            return urllib.parse.unquote(
                urllib.parse.urlparse(self.path).path) or "/"

        # -- verbs ------------------------------------------------------------

        def do_OPTIONS(self):
            self._reply(200, headers={
                "DAV": "1,2",
                "Allow": "OPTIONS, PROPFIND, MKCOL, GET, HEAD, PUT, "
                         "DELETE, MOVE, COPY, LOCK, UNLOCK",
                "MS-Author-Via": "DAV"})

        def do_PROPFIND(self):
            self._body()
            path = self._path()
            entry = dav.find(path)
            if entry is None:
                self._reply(404)
                return
            depth = self.headers.get("Depth", "1")
            ms = ET.Element(f"{{{DAV_NS}}}multistatus")
            ms.append(_prop_response(path, entry))
            if entry.is_directory and depth != "0":
                base = path if path.endswith("/") else path + "/"
                for c in dav.children(path):
                    href = base + c.name + ("/" if c.is_directory else "")
                    ms.append(_prop_response(href, c))
            ET.register_namespace("D", DAV_NS)
            body = b'<?xml version="1.0" encoding="utf-8"?>' + \
                ET.tostring(ms)
            self._reply(207, body,
                        headers={"Content-Type":
                                 'application/xml; charset="utf-8"'})

        def do_MKCOL(self):
            path = self._path()
            d, n = split_path(dav.full_path(path))
            if dav.find(path) is not None:
                self._reply(405)
                return
            dav.stub.CreateEntry(filer_pb2.CreateEntryRequest(
                directory=d,
                entry=filer_pb2.Entry(name=n, is_directory=True)))
            self._reply(201)

        def do_GET(self):
            path = self._path()
            entry = dav.find(path)
            if entry is None:
                self._reply(404)
                return
            if entry.is_directory:
                self._reply(405)
                return
            try:
                code, data, headers = filer_http.get(
                    dav.filer_url, dav.full_path(path),
                    self.headers.get("Range"))
            except urllib.error.HTTPError as e:
                self._reply(e.code)
                return
            extra = {h: headers[h] for h in
                     ("Content-Range", "Content-Type", "ETag")
                     if h in headers}
            self._reply(code, data, headers=extra)

        def do_HEAD(self):
            # metadata only — never pull the body for a HEAD
            path = self._path()
            entry = dav.find(path)
            if entry is None:
                self._reply(404)
                return
            if entry.is_directory:
                self._reply(405)
                return
            self.send_response(200)
            self.send_header("Content-Length",
                             str(filechunks.total_size(entry.chunks)))
            self.send_header("Content-Type", entry.attributes.mime
                             or "application/octet-stream")
            self.end_headers()

        def do_PUT(self):
            path = self._path()
            data = self._body()
            try:
                filer_http.put(dav.filer_url, dav.full_path(path), data,
                               mime=self.headers.get("Content-Type") or "")
            except urllib.error.HTTPError as e:
                self._reply(e.code)
                return
            self._reply(201)

        def do_DELETE(self):
            path = self._path()
            if dav.find(path) is None:
                self._reply(404)
                return
            d, n = split_path(dav.full_path(path))
            dav.stub.DeleteEntry(filer_pb2.DeleteEntryRequest(
                directory=d, name=n, is_delete_data=True,
                is_recursive=True, ignore_recursive_error=True))
            self._reply(204)

        def _destination(self) -> Optional[str]:
            dst = self.headers.get("Destination", "")
            if not dst:
                return None
            u = urllib.parse.urlparse(dst)
            return urllib.parse.unquote(u.path) or "/"

        def do_MOVE(self):
            src, dst = self._path(), self._destination()
            if dst is None:
                self._reply(400)
                return
            if dav.find(src) is None:
                self._reply(404)
                return
            overwrote = dav.find(dst) is not None
            if overwrote and self.headers.get("Overwrite", "T") == "F":
                self._reply(412)
                return
            sd, sn = split_path(dav.full_path(src))
            dd, dn = split_path(dav.full_path(dst))
            dav.stub.AtomicRenameEntry(filer_pb2.AtomicRenameEntryRequest(
                old_directory=sd, old_name=sn,
                new_directory=dd, new_name=dn))
            self._reply(204 if overwrote else 201)

        def do_COPY(self):
            src, dst = self._path(), self._destination()
            if dst is None:
                self._reply(400)
                return
            entry = dav.find(src)
            if entry is None:
                self._reply(404)
                return
            if entry.is_directory:
                self._reply(501)  # collection COPY not supported
                return
            overwrote = dav.find(dst) is not None
            if overwrote and self.headers.get("Overwrite", "T") == "F":
                self._reply(412)
                return
            _, data, _ = filer_http.get(dav.filer_url,
                                        dav.full_path(src))
            filer_http.put(dav.filer_url, dav.full_path(dst), data,
                           mime=entry.attributes.mime or "")
            self._reply(204 if overwrote else 201)

        def do_LOCK(self):
            # fake lock token, like read-write servers without real
            # locking; body echoes an activelock so clients proceed
            self._body()
            token = f"opaquelocktoken:{time.time_ns():x}"
            body = (
                '<?xml version="1.0" encoding="utf-8"?>'
                '<D:prop xmlns:D="DAV:"><D:lockdiscovery><D:activelock>'
                '<D:locktype><D:write/></D:locktype>'
                '<D:lockscope><D:exclusive/></D:lockscope>'
                f'<D:locktoken><D:href>{token}</D:href></D:locktoken>'
                '</D:activelock></D:lockdiscovery></D:prop>').encode()
            self._reply(200, body, headers={
                "Lock-Token": f"<{token}>",
                "Content-Type": 'application/xml; charset="utf-8"'})

        def do_UNLOCK(self):
            self._reply(204)

    from seaweedfs_tpu_torch.stats.metrics import instrument_http_handler
    return instrument_http_handler(Handler, "webdav")
