"""S3 REST gateway: buckets are directories under /buckets on the
filer; object data rides the filer's auto-chunking HTTP path, metadata
rides the filer's RPC plane (reference: weed/s3api/s3api_server.go,
s3api_object_handlers.go, filer_multipart.go). The port of
``seaweedfs_tpu.s3api.server``: the same replies, headers and XML. A GET
of an object whose chunks sit on an EC volume with a lost shard goes
filer -> volume server -> the decode fleet, which decodes on the card.
"""

from __future__ import annotations

import hashlib
import secrets
import threading
import time
import urllib.error
import urllib.parse
import urllib.request
import xml.etree.ElementTree as ET
from seaweedfs_tpu_torch.util.http_server import (FastHandler, ServeConfig,
                                            make_http_server)
from typing import List, Optional, Tuple

from seaweedfs_tpu_torch import rpc
from seaweedfs_tpu_torch.filer import filechunks
from seaweedfs_tpu_torch.util import wlog
from seaweedfs_tpu_torch.filer import http_client as filer_http
from seaweedfs_tpu_torch.pb import filer_pb2, filer_stub
from seaweedfs_tpu_torch.s3api.auth import (ACTION_ADMIN, ACTION_LIST,
                                      ACTION_READ, ACTION_TAGGING,
                                      ACTION_WRITE, Iam, S3AuthError)

BUCKETS_DIR = "/buckets"
IAM_CONF_DIR = "/etc/iam"           # reference filer.IamConfigDirecotry
IAM_IDENTITY_FILE = "identity.json"  # reference filer.IamIdentityFile
MULTIPART_DIR = ".uploads"          # hidden dir inside the bucket
S3_NS = "http://s3.amazonaws.com/doc/2006-03-01/"
TAG_PREFIX = "x-amz-tag-"


log = wlog.logger("s3")


class S3ApiServer:
    def __init__(self, filer_url: str, ip: str = "127.0.0.1",
                 port: int = 8333, iam: Optional[Iam] = None,
                 serve: Optional[ServeConfig] = None):
        self.filer_url = filer_url
        self.serve = serve or ServeConfig()
        self.ip = ip
        self.port = port
        self.iam = iam or Iam()
        self._http_server = None
        self._http_thread = None
        self._iam_watcher = None
        self._iam_call = None
        self._iam_lock = threading.Lock()
        self._stopping = False

    @property
    def url(self) -> str:
        return f"{self.ip}:{self.port}"

    def start(self) -> None:
        self._http_server = make_http_server(
            (self.ip, self.port), _make_handler(self),
            role="s3", serve=self.serve)
        # lint: thread-ok(listener thread; ingress wrappers mint request context)
        self._http_thread = threading.Thread(
            target=self._http_server.serve_forever,
            name=f"s3-http-{self.port}", daemon=True)
        self._http_thread.start()
        self._reload_dynamic_iam()
        # lint: thread-ok(iam-watch daemon; no request context)
        self._iam_watcher = threading.Thread(
            target=self._watch_iam, name=f"s3-iam-{self.port}",
            daemon=True)
        self._iam_watcher.start()
        log.info("s3 gateway %s:%d started (filer=%s)",
                 self.ip, self.port, self.filer_url)

    def stop(self) -> None:
        self._stopping = True
        with self._iam_lock:
            if self._iam_call is not None:
                self._iam_call.cancel()
        if self._http_server:
            self._http_server.shutdown()
            self._http_server.server_close()

    # -- dynamic identities (s3.configure) ------------------------------------

    def _reload_dynamic_iam(self) -> None:
        """Load identities written by the shell's s3.configure to
        /etc/iam/identity.json in the filer; a static -config file is
        the fallback when no dynamic config exists (reference
        auth_credentials.go loads the same path)."""
        import json
        from seaweedfs_tpu_torch.s3api.auth import iam_from_dict
        path = f"{IAM_CONF_DIR}/{IAM_IDENTITY_FILE}"
        try:
            status, body, _ = self.filer_get(path)
        except Exception:
            from seaweedfs_tpu_torch.stats import metrics
            metrics.swallowed("s3.iam_load")
            return
        if status != 200 or not body:
            return
        try:
            self.iam = iam_from_dict(json.loads(body))
            log.info("s3 iam reloaded: %d identities",
                     len(self.iam.identities))
        except (ValueError, KeyError) as e:
            log.warning("s3 iam config unparseable, keeping old: %s", e)

    def _watch_iam(self) -> None:
        """Tail the filer metadata log for /etc/iam/ changes so
        s3.configure -apply takes effect live."""
        first = True
        while not self._stopping:
            try:
                if not first:
                    # catch up on anything written while the stream was
                    # down: the new subscription starts at `now`, so a
                    # change made during the gap would otherwise be
                    # missed forever
                    self._reload_dynamic_iam()
                first = False
                call = self.stub.SubscribeMetadata(
                    filer_pb2.SubscribeMetadataRequest(
                        client_name=f"s3-iam-{self.port}",
                        path_prefix=IAM_CONF_DIR + "/",
                        since_ns=time.time_ns()))
                with self._iam_lock:
                    if self._stopping:
                        call.cancel()
                        return
                    self._iam_call = call
                for _rec in call:
                    if self._stopping:
                        return
                    self._reload_dynamic_iam()
            except Exception:
                if self._stopping:
                    return
                from seaweedfs_tpu_torch.stats import metrics
                metrics.swallowed("s3.iam_watch")
                time.sleep(0.5)

    # -- filer plumbing -------------------------------------------------------

    @property
    def stub(self):
        return filer_stub(self.filer_url)

    def filer_put(self, path: str, data: bytes,
                  mime: str = "") -> Tuple[dict, dict]:
        return filer_http.put(self.filer_url, path, data, mime)

    def filer_get(self, path: str, range_header: Optional[str] = None,
                  extra_headers: Optional[dict] = None
                  ) -> Tuple[int, bytes, dict]:
        return filer_http.get(self.filer_url, path, range_header,
                              extra_headers=extra_headers)

    def find_entry(self, directory: str, name: str) -> Optional[filer_pb2.Entry]:
        try:
            return self.stub.LookupDirectoryEntry(
                filer_pb2.LookupDirectoryEntryRequest(
                    directory=directory, name=name)).entry
        except rpc.RpcError:
            return None

    def list_entries(self, directory: str, prefix: str = "",
                     start: str = "", inclusive: bool = False,
                     limit: int = 10000) -> List[filer_pb2.Entry]:
        try:
            return [r.entry for r in self.stub.ListEntries(
                filer_pb2.ListEntriesRequest(
                    directory=directory, prefix=prefix,
                    start_from_file_name=start,
                    inclusive_start_from=inclusive, limit=limit))]
        except rpc.RpcError:
            return []


# -- XML helpers --------------------------------------------------------------


def _xml(tag: str, *children, text: Optional[str] = None, **attrs):
    e = ET.Element(tag, attrs)
    if text is not None:
        e.text = text
    for c in children:
        e.append(c)
    return e


def _render(root: ET.Element) -> bytes:
    root.set("xmlns", S3_NS)
    return b'<?xml version="1.0" encoding="UTF-8"?>' + \
        ET.tostring(root)


def _error_xml(code: str, message: str, resource: str) -> bytes:
    return _render(_xml(
        "Error",
        _xml("Code", text=code),
        _xml("Message", text=message),
        _xml("Resource", text=resource)))


def slow_down_xml(resource: str) -> bytes:
    """The S3 throttle error body (HTTP 503 + Code=SlowDown): what AWS
    returns when a prefix is over its request-rate budget, and what
    every S3 SDK's retry layer already understands. The QoS admission
    layer (qos/admission.py shed_reply) sends this on the s3 role so
    shed tenants back off via their SDK instead of seeing opaque 429s."""
    return _error_xml("SlowDown", "Please reduce your request rate.",
                      resource)


# -- handler ------------------------------------------------------------------


def _make_handler(s3: S3ApiServer):
    class Handler(FastHandler):
        protocol_version = "HTTP/1.1"
        disable_nagle_algorithm = True  # small replies must not wait on delayed ACKs

        def log_message(self, fmt, *args):
            pass

        # -- plumbing ---------------------------------------------------------

        def _reply(self, code: int, body: bytes = b"",
                   headers: Optional[dict] = None,
                   content_type: str = "application/xml") -> None:
            # HEAD replies pass the object's Content-Length explicitly
            # (a second zero-length one would violate RFC 7230), and 204
            # replies MUST NOT carry Content-Length at all (RFC 9110
            # §8.6) — those two shapes keep the header-by-header path;
            # everything else rides the single-buffer fast_reply.
            explicit_len = any(k.lower() == "content-length"
                               for k in (headers or {}))
            if code != 204 and not explicit_len:
                self.fast_reply(code, body, headers,
                                ctype=content_type if body else "")
                return
            self.send_response(code)
            if body:
                self.send_header("Content-Type", content_type)
            for k, v in (headers or {}).items():
                self.send_header(k, v)
            self.end_headers()
            if self.command != "HEAD" and body:
                self.wfile.write(body)

        def _error(self, code: str, message: str, status: int) -> None:
            self._reply(status, _error_xml(code, message, self.path))

        def _body(self) -> bytes:
            # framing-aware (Content-Length or chunked),
            # identical on both server models
            return self.read_body()

        def _parse(self):
            u = urllib.parse.urlparse(self.path)
            path = urllib.parse.unquote(u.path)
            parts = path.lstrip("/").split("/", 1)
            bucket = parts[0] if parts[0] else ""
            key = parts[1] if len(parts) > 1 else ""
            return bucket, key, urllib.parse.parse_qs(
                u.query, keep_blank_values=True), u.query

        def _auth(self, action: str, bucket: str,
                  payload: bytes = b"") -> None:
            """Authorize the already-authenticated identity."""
            if not self._ident.can_do(action, bucket):
                raise S3AuthError("AccessDenied",
                                  f"{self._ident.name} cannot {action} "
                                  f"on {bucket}")

        # -- dispatch ---------------------------------------------------------

        def _route(self):
            bucket, key, qs, raw_q = self._parse()
            raw = self._body() if self.command in ("PUT", "POST") else b""
            try:
                if (self.command == "POST" and bucket and not key
                        and "multipart/form-data" in
                        self.headers.get("Content-Type", "")):
                    # browser form upload: the signed policy inside the
                    # form IS the authentication (reference routes
                    # bucket POST to PostPolicyBucketHandler before the
                    # auth middleware)
                    return self._post_policy_upload(bucket, raw)
                headers = {k.lower(): v for k, v in self.headers.items()}
                u = urllib.parse.urlparse(self.path)
                self._ident, payload = s3.iam.authenticate_and_decode(
                    self.command, u.path, u.query, headers, raw)
                if not bucket:
                    self._auth(ACTION_LIST, "")
                    return self._list_buckets()
                if not key:
                    return self._bucket_op(bucket, qs, payload)
                return self._object_op(bucket, key, qs, payload)
            except S3AuthError as e:
                self._error(e.code, str(e), e.status)

        do_GET = do_PUT = do_POST = do_DELETE = do_HEAD = \
            lambda self: self._route()

        # -- service/bucket ---------------------------------------------------

        def _list_buckets(self):
            entries = s3.list_entries(BUCKETS_DIR)
            buckets = _xml("Buckets")
            for e in entries:
                if e.is_directory:
                    buckets.append(_xml(
                        "Bucket",
                        _xml("Name", text=e.name),
                        _xml("CreationDate", text=_iso(e.attributes.crtime))))
            root = _xml("ListAllMyBucketsResult",
                        _xml("Owner", _xml("ID", text="seaweedfs")),
                        buckets)
            self._reply(200, _render(root))

        def _bucket_op(self, bucket: str, qs, payload: bytes):
            if self.command == "PUT":
                # bucket creation is an admin action in the reference
                # (s3api_server.go:93); Write identities must not be
                # able to create buckets
                self._auth(ACTION_ADMIN, bucket, payload)
                s3.stub.CreateEntry(filer_pb2.CreateEntryRequest(
                    directory=BUCKETS_DIR,
                    entry=filer_pb2.Entry(name=bucket, is_directory=True)))
                self._reply(200)
            elif self.command == "DELETE":
                self._auth(ACTION_WRITE, bucket, payload)
                s3.stub.DeleteEntry(filer_pb2.DeleteEntryRequest(
                    directory=BUCKETS_DIR, name=bucket,
                    is_delete_data=True, is_recursive=True,
                    ignore_recursive_error=True))
                self._reply(204)
            elif self.command == "HEAD":
                self._auth(ACTION_READ, bucket, payload)
                if s3.find_entry(BUCKETS_DIR, bucket) is None:
                    return self._error("NoSuchBucket", bucket, 404)
                self._reply(200)
            elif self.command == "POST" and "delete" in qs:
                self._auth(ACTION_WRITE, bucket, payload)
                self._batch_delete(bucket, payload)
            elif self.command == "GET":
                self._auth(ACTION_LIST, bucket, payload)
                if s3.find_entry(BUCKETS_DIR, bucket) is None:
                    return self._error("NoSuchBucket", bucket, 404)
                if "uploads" in qs:
                    return self._list_multipart_uploads(bucket)
                self._list_objects(bucket, qs)
            else:
                self._error("MethodNotAllowed", self.command, 405)

        def _post_policy_upload(self, bucket: str, payload: bytes):
            """Browser form upload (reference
            s3api_object_handlers_postpolicy.go PostPolicyBucketHandler):
            verify the signed policy, enforce its conditions, store the
            file at the form's key."""
            from seaweedfs_tpu_torch.s3api.post_policy import (PolicyError,
                                                         check_policy,
                                                         parse_form)
            try:
                fields, data, filename = parse_form(
                    self.headers.get("Content-Type", ""), payload)
            except PolicyError as e:
                return self._error(e.code, str(e), e.status)
            if data is None:
                return self._error("MalformedPOSTRequest",
                                   "form has no file part", 400)
            key = fields.get("key", "")
            if not key:
                return self._error("MalformedPOSTRequest",
                                   "form has no key", 400)
            key = key.replace("${filename}", filename)
            values = dict(fields)
            values["bucket"] = bucket
            values["key"] = key
            try:
                if s3.iam.is_enabled:
                    ident = s3.iam.verify_post_policy(fields)
                    if not ident.can_do(ACTION_WRITE, bucket):
                        raise S3AuthError("AccessDenied",
                                          "not allowed to write")
                if fields.get("policy"):
                    check_policy(fields["policy"], values, len(data))
            except PolicyError as e:
                return self._error(e.code, str(e), e.status)
            except S3AuthError as e:
                return self._error(e.code, str(e), e.status)
            if s3.find_entry(BUCKETS_DIR, bucket) is None:
                return self._error("NoSuchBucket", bucket, 404)
            mime = fields.get("content-type", "")
            _, resp_headers = s3.filer_put(
                f"{BUCKETS_DIR}/{bucket}/{key}", data, mime=mime)
            etag = resp_headers.get("ETag", "").strip('"') or \
                hashlib.md5(data).hexdigest()
            redirect = fields.get("success_action_redirect")
            if redirect:
                sep = "&" if "?" in redirect else "?"
                return self._reply(303, headers={
                    "Location": f"{redirect}{sep}bucket={bucket}"
                                f"&key={urllib.parse.quote(key)}"
                                f"&etag=%22{etag}%22"})
            status = fields.get("success_action_status", "204")
            if status == "201":
                loc = f"http://{s3.url}/{bucket}/{urllib.parse.quote(key)}"
                root = _xml("PostResponse",
                            _xml("Location", text=loc),
                            _xml("Bucket", text=bucket),
                            _xml("Key", text=key),
                            _xml("ETag", text=f'"{etag}"'))
                return self._reply(201, _render(root))
            self._reply(200 if status == "200" else 204,
                        headers={"ETag": f'"{etag}"'})

        # -- object -----------------------------------------------------------

        def _object_op(self, bucket: str, key: str, qs, payload: bytes):
            if "tagging" in qs:
                return self._tagging_op(bucket, key, payload)
            if self.command == "POST" and "uploads" in qs:
                self._auth(ACTION_WRITE, bucket, payload)
                return self._initiate_multipart(bucket, key)
            if self.command == "PUT" and "uploadId" in qs:
                self._auth(ACTION_WRITE, bucket, payload)
                if self.headers.get("x-amz-copy-source"):
                    return self._copy_object_part(bucket, key, qs)
                return self._upload_part(bucket, key, qs, payload)
            if self.command == "POST" and "uploadId" in qs:
                self._auth(ACTION_WRITE, bucket, payload)
                return self._complete_multipart(bucket, key, qs, payload)
            if self.command == "DELETE" and "uploadId" in qs:
                self._auth(ACTION_WRITE, bucket, payload)
                return self._abort_multipart(bucket, key, qs)
            if self.command == "GET" and "uploadId" in qs:
                self._auth(ACTION_READ, bucket, payload)
                return self._list_parts(bucket, key, qs)

            if self.command == "PUT":
                self._auth(ACTION_WRITE, bucket, payload)
                copy_src = self.headers.get("x-amz-copy-source")
                if copy_src:
                    return self._copy_object(bucket, key, copy_src)
                return self._put_object(bucket, key, payload)
            if self.command in ("GET", "HEAD"):
                self._auth(ACTION_READ, bucket, payload)
                return self._get_object(bucket, key)
            if self.command == "DELETE":
                self._auth(ACTION_WRITE, bucket, payload)
                s3.stub.DeleteEntry(filer_pb2.DeleteEntryRequest(
                    directory=_dir_of(bucket, key),
                    name=_name_of(key), is_delete_data=True,
                    is_recursive=True, ignore_recursive_error=True))
                return self._reply(204)
            self._error("MethodNotAllowed", self.command, 405)

        def _put_object(self, bucket: str, key: str, payload: bytes):
            mime = self.headers.get("Content-Type") or ""
            _, resp_headers = s3.filer_put(
                f"{BUCKETS_DIR}/{bucket}/{key}", payload, mime=mime)
            # the filer's ETag header is the chunk-aware etag that
            # HEAD/GET/list will also report; fall back to plain md5
            etag = resp_headers.get("ETag") or \
                hashlib.md5(payload).hexdigest()
            self._reply(200, headers={"ETag": f'"{etag.strip(chr(34))}"'})

        def _get_object(self, bucket: str, key: str):
            rng = self.headers.get("Range")
            if self.command == "HEAD":
                entry = s3.find_entry(_dir_of(bucket, key),
                                      _name_of(key))
                if entry is None or entry.is_directory:
                    return self._error("NoSuchKey", key, 404)
                size = filechunks.total_size(entry.chunks)
                return self._reply(200, headers={
                    "Content-Length": str(size),
                    "Content-Type": entry.attributes.mime or
                    "application/octet-stream",
                    "ETag": f'"{filechunks.etag_of_chunks(list(entry.chunks))}"'
                    if entry.chunks else '""',
                    "Last-Modified": _http_date(entry.attributes.mtime),
                })
            # GET proxies the filer in ONE hop (reference
            # s3api_object_handlers.go proxyToFiler): the filer reply
            # already carries ETag/Content-Type/Content-Range, and
            # x-sw-object-only makes directory keys 404 instead of a
            # listing, so no pre-lookup RPC round trip is needed
            try:
                status, data, headers = s3.filer_get(
                    f"{BUCKETS_DIR}/{bucket}/{key}", rng,
                    extra_headers={"x-sw-object-only": "true"})
            except urllib.error.HTTPError as e:  # noqa: F821
                if e.code == 404:
                    return self._error("NoSuchKey", key, 404)
                if e.code == 416:
                    # S3's answer to an unsatisfiable Range, as
                    # UploadPartCopy gives it (the JAX gateway answers
                    # InternalError)
                    return self._error("InvalidRange", rng or "", 416)
                # a transient backend failure must NOT masquerade as a
                # missing object (sync clients treat NoSuchKey as
                # deletion)
                return self._error("InternalError", key, e.code)
            ctype = headers.get("Content-Type") or \
                "application/octet-stream"
            out = {h: headers[h] for h in ("Content-Range", "ETag")
                   if h in headers}
            if not data:
                # _reply writes content_type only with a body; with one,
                # the type goes out once (the JAX gateway sends it twice)
                out = {"Content-Type": ctype, **out}
            self._reply(status, data, headers=out, content_type=ctype)

        def _copy_object(self, bucket: str, key: str, copy_src: str):
            src = urllib.parse.unquote(copy_src).lstrip("/")
            sbucket, _, skey = src.partition("/")
            # same source-bucket read check as UploadPartCopy
            self._auth(ACTION_READ, sbucket)
            entry = s3.find_entry(_dir_of(sbucket, skey), _name_of(skey))
            if entry is None:
                return self._error("NoSuchKey", src, 404)
            _, data, _ = s3.filer_get(f"{BUCKETS_DIR}/{sbucket}/{skey}")
            s3.filer_put(f"{BUCKETS_DIR}/{bucket}/{key}", data,
                         mime=entry.attributes.mime)
            etag = hashlib.md5(data).hexdigest()
            self._reply(200, _render(_xml(
                "CopyObjectResult",
                _xml("ETag", text=f'"{etag}"'),
                _xml("LastModified", text=_iso(int(time.time()))))))

        def _batch_delete(self, bucket: str, payload: bytes):
            try:
                root = ET.fromstring(payload)
            except ET.ParseError:
                return self._error("MalformedXML", "bad delete body", 400)
            deleted, quiet = [], False
            q = root.find("{*}Quiet")
            quiet = q is not None and (q.text or "").lower() == "true"
            for obj in root.iter():
                if not obj.tag.endswith("Object"):
                    continue
                k = obj.find("{*}Key")
                if k is None or not k.text:
                    continue
                s3.stub.DeleteEntry(filer_pb2.DeleteEntryRequest(
                    directory=_dir_of(bucket, k.text),
                    name=_name_of(k.text), is_delete_data=True,
                    is_recursive=True, ignore_recursive_error=True))
                deleted.append(k.text)
            result = _xml("DeleteResult")
            if not quiet:
                for k in deleted:
                    result.append(_xml("Deleted", _xml("Key", text=k)))
            self._reply(200, _render(result))

        # -- listing ----------------------------------------------------------

        def _list_objects(self, bucket: str, qs):
            v2 = qs.get("list-type", [""])[0] == "2"
            prefix = qs.get("prefix", [""])[0]
            delimiter = qs.get("delimiter", [""])[0]
            max_keys = min(int(qs.get("max-keys", ["1000"])[0] or 1000),
                           1000)
            if v2:
                marker = urllib.parse.unquote(
                    qs.get("continuation-token", [""])[0]) or \
                    qs.get("start-after", [""])[0]
            else:
                marker = qs.get("marker", [""])[0]

            contents, prefixes, truncated, next_marker = _walk_bucket(
                s3, bucket, prefix, delimiter, marker, max_keys)

            tag = "ListBucketResult"
            root = _xml(tag,
                        _xml("Name", text=bucket),
                        _xml("Prefix", text=prefix),
                        _xml("MaxKeys", text=str(max_keys)),
                        _xml("IsTruncated",
                             text="true" if truncated else "false"))
            if delimiter:
                root.append(_xml("Delimiter", text=delimiter))
            for key, e in contents:
                root.append(_xml(
                    "Contents",
                    _xml("Key", text=key),
                    _xml("LastModified", text=_iso(e.attributes.mtime)),
                    _xml("ETag",
                         text=f'"{filechunks.etag_of_chunks(list(e.chunks))}"'
                         if e.chunks else '""'),
                    _xml("Size", text=str(
                        filechunks.total_size(e.chunks))),
                    _xml("StorageClass", text="STANDARD")))
            for p in sorted(prefixes):
                root.append(_xml("CommonPrefixes", _xml("Prefix", text=p)))
            if truncated:
                if v2:
                    root.append(_xml("NextContinuationToken",
                                     text=urllib.parse.quote(next_marker)))
                else:
                    root.append(_xml("NextMarker", text=next_marker))
            if v2:
                root.append(_xml("KeyCount", text=str(len(contents))))
            self._reply(200, _render(root))

        # -- multipart --------------------------------------------------------

        def _initiate_multipart(self, bucket: str, key: str):
            upload_id = secrets.token_hex(16)
            entry = filer_pb2.Entry(name=upload_id, is_directory=True)
            entry.extended["key"] = key.encode()
            mime = self.headers.get("Content-Type") or ""
            if mime:
                entry.extended["mime"] = mime.encode()
            s3.stub.CreateEntry(filer_pb2.CreateEntryRequest(
                directory=f"{BUCKETS_DIR}/{bucket}/{MULTIPART_DIR}",
                entry=entry))
            self._reply(200, _render(_xml(
                "InitiateMultipartUploadResult",
                _xml("Bucket", text=bucket),
                _xml("Key", text=key),
                _xml("UploadId", text=upload_id))))

        def _multipart_target(self, bucket: str, qs):
            """(part number, upload dir) for a part request, or None
            after an error reply — the shared validation preamble of
            _upload_part and _copy_object_part."""
            upload_id = qs.get("uploadId", [""])[0]
            try:
                part = int(qs.get("partNumber", [""])[0])
            except (ValueError, IndexError):
                part = None
            if part is None or not 1 <= part <= 10000:
                self._error("InvalidArgument", "bad partNumber", 400)
                return None
            if s3.find_entry(
                    f"{BUCKETS_DIR}/{bucket}/{MULTIPART_DIR}",
                    upload_id) is None:
                self._error("NoSuchUpload", upload_id, 404)
                return None
            return (part,
                    f"{BUCKETS_DIR}/{bucket}/{MULTIPART_DIR}/{upload_id}")

        def _upload_part(self, bucket: str, key: str, qs, payload: bytes):
            target = self._multipart_target(bucket, qs)
            if target is None:
                return
            part, updir = target
            s3.filer_put(f"{updir}/{part:04d}.part", payload)
            self._reply(200, headers={
                "ETag": f'"{hashlib.md5(payload).hexdigest()}"'})

        def _copy_object_part(self, bucket: str, key: str, qs):
            """UploadPartCopy (reference
            s3api_object_copy_handlers.go CopyObjectPartHandler): a
            part sourced from an existing object, optionally a byte
            range via x-amz-copy-source-range."""
            target = self._multipart_target(bucket, qs)
            if target is None:
                return
            part, updir = target
            src = urllib.parse.unquote(
                self.headers["x-amz-copy-source"]).lstrip("/")
            sbucket, _, skey = src.partition("/")
            # reading the SOURCE needs read rights on ITS bucket — the
            # destination write auth alone must not exfiltrate another
            # bucket's data
            self._auth(ACTION_READ, sbucket)
            if s3.find_entry(_dir_of(sbucket, skey),
                             _name_of(skey)) is None:
                return self._error("NoSuchKey", src, 404)
            rng = self.headers.get("x-amz-copy-source-range")
            if rng and not rng.startswith("bytes="):
                return self._error("InvalidArgument",
                                   f"bad range {rng!r}", 400)
            try:
                _, data, _ = s3.filer_get(
                    f"{BUCKETS_DIR}/{sbucket}/{skey}", rng)
            except urllib.error.HTTPError as e:
                if e.code == 416:
                    return self._error("InvalidRange", rng or "", 416)
                return self._error("InternalError",
                                   f"source read failed: {e.code}",
                                   e.code)
            s3.filer_put(f"{updir}/{part:04d}.part", data)
            self._reply(200, _render(_xml(
                "CopyPartResult",
                _xml("ETag",
                     text=f'"{hashlib.md5(data).hexdigest()}"'),
                _xml("LastModified", text=_iso(int(time.time()))))))

        @staticmethod
        def _manifest_part_numbers(payload: bytes) -> Optional[set]:
            """Part numbers listed in the CompleteMultipartUpload body;
            None when the body is absent/unparsable (assemble all, for
            minimal clients)."""
            if not payload:
                return None
            try:
                root = ET.fromstring(payload)
            except ET.ParseError:
                return None
            nums = {int(e.text) for e in root.iter()
                    if e.tag.endswith("PartNumber") and e.text}
            return nums or None

        def _complete_multipart(self, bucket: str, key: str, qs, payload):
            upload_id = qs.get("uploadId", [""])[0]
            mp_dir = f"{BUCKETS_DIR}/{bucket}/{MULTIPART_DIR}"
            updir = f"{mp_dir}/{upload_id}"
            meta = s3.find_entry(mp_dir, upload_id)
            if meta is None:
                return self._error("NoSuchUpload", upload_id, 404)
            parts = [e for e in s3.list_entries(updir)
                     if e.name.endswith(".part")]
            # S3 assembles exactly the parts the client's manifest lists
            wanted = self._manifest_part_numbers(payload)
            if wanted is not None:
                parts = [e for e in parts if int(e.name[:-5]) in wanted]
            # numeric sort: part 10000 (5 digits) would lexicographically
            # sort between 0999 and 2000 and corrupt the assembled object
            parts.sort(key=lambda e: int(e.name[:-5]))
            final = filer_pb2.Entry(name=_name_of(key))
            mime = meta.extended.get("mime", b"").decode()
            if mime:
                final.attributes.mime = mime
            offset = 0
            for p in parts:
                for c in p.chunks:
                    nc = final.chunks.add()
                    nc.CopyFrom(c)
                    nc.offset = offset + c.offset
                offset += filechunks.total_size(p.chunks)
            now = int(time.time())
            final.attributes.crtime = now
            final.attributes.mtime = now
            s3.stub.CreateEntry(filer_pb2.CreateEntryRequest(
                directory=_dir_of(bucket, key), entry=final))
            # drop multipart scaffolding but keep the chunks (now owned
            # by the final entry)
            s3.stub.DeleteEntry(filer_pb2.DeleteEntryRequest(
                directory=mp_dir, name=upload_id,
                is_delete_data=False, is_recursive=True,
                ignore_recursive_error=True))
            etag = filechunks.etag_of_chunks(list(final.chunks))
            self._reply(200, _render(_xml(
                "CompleteMultipartUploadResult",
                _xml("Location",
                     text=f"http://{s3.url}/{bucket}/{key}"),
                _xml("Bucket", text=bucket),
                _xml("Key", text=key),
                _xml("ETag", text=f'"{etag}"'))))

        def _abort_multipart(self, bucket: str, key: str, qs):
            upload_id = qs.get("uploadId", [""])[0]
            s3.stub.DeleteEntry(filer_pb2.DeleteEntryRequest(
                directory=f"{BUCKETS_DIR}/{bucket}/{MULTIPART_DIR}",
                name=upload_id, is_delete_data=True, is_recursive=True,
                ignore_recursive_error=True))
            self._reply(204)

        def _list_parts(self, bucket: str, key: str, qs):
            upload_id = qs.get("uploadId", [""])[0]
            updir = f"{BUCKETS_DIR}/{bucket}/{MULTIPART_DIR}/{upload_id}"
            root = _xml("ListPartsResult",
                        _xml("Bucket", text=bucket),
                        _xml("Key", text=key),
                        _xml("UploadId", text=upload_id))
            for e in s3.list_entries(updir):
                if not e.name.endswith(".part"):
                    continue
                root.append(_xml(
                    "Part",
                    _xml("PartNumber", text=str(int(e.name[:-5]))),
                    _xml("LastModified", text=_iso(e.attributes.mtime)),
                    _xml("Size",
                         text=str(filechunks.total_size(e.chunks)))))
            self._reply(200, _render(root))

        def _list_multipart_uploads(self, bucket: str):
            root = _xml("ListMultipartUploadsResult",
                        _xml("Bucket", text=bucket))
            for e in s3.list_entries(
                    f"{BUCKETS_DIR}/{bucket}/{MULTIPART_DIR}"):
                if e.is_directory:
                    root.append(_xml(
                        "Upload",
                        _xml("Key",
                             text=e.extended.get("key", b"").decode()),
                        _xml("UploadId", text=e.name)))
            self._reply(200, _render(root))

        # -- tagging ----------------------------------------------------------

        def _tagging_op(self, bucket: str, key: str, payload: bytes):
            directory, name = _dir_of(bucket, key), _name_of(key)
            entry = s3.find_entry(directory, name)
            if entry is None:
                self._auth(ACTION_TAGGING, bucket, payload)
                return self._error("NoSuchKey", key, 404)
            self._auth(ACTION_TAGGING, bucket, payload)
            if self.command == "GET":
                tagset = _xml("TagSet")
                for k, v in entry.extended.items():
                    if k.startswith(TAG_PREFIX):
                        tagset.append(_xml(
                            "Tag",
                            _xml("Key", text=k[len(TAG_PREFIX):]),
                            _xml("Value", text=v.decode())))
                return self._reply(200, _render(_xml("Tagging", tagset)))
            if self.command == "PUT":
                try:
                    root = ET.fromstring(payload)
                except ET.ParseError:
                    return self._error("MalformedXML", "bad tagging", 400)
                for k in [k for k in entry.extended
                          if k.startswith(TAG_PREFIX)]:
                    del entry.extended[k]
                for tag in root.iter():
                    if tag.tag.endswith("Tag"):
                        k = tag.find("{*}Key")
                        v = tag.find("{*}Value")
                        if k is not None and v is not None:
                            entry.extended[TAG_PREFIX + (k.text or "")] = \
                                (v.text or "").encode()
                s3.stub.UpdateEntry(filer_pb2.UpdateEntryRequest(
                    directory=directory, entry=entry))
                return self._reply(200)
            if self.command == "DELETE":
                for k in [k for k in entry.extended
                          if k.startswith(TAG_PREFIX)]:
                    del entry.extended[k]
                s3.stub.UpdateEntry(filer_pb2.UpdateEntryRequest(
                    directory=directory, entry=entry))
                return self._reply(204)
            self._error("MethodNotAllowed", self.command, 405)

    from seaweedfs_tpu_torch.stats.metrics import instrument_http_handler
    return instrument_http_handler(Handler, "s3")



# -- helpers ------------------------------------------------------------------


def _dir_of(bucket: str, key: str) -> str:
    d = f"{BUCKETS_DIR}/{bucket}/{key}".rstrip("/")
    return d.rsplit("/", 1)[0]


def _name_of(key: str) -> str:
    return key.rstrip("/").rsplit("/", 1)[-1]


def _iso(ts: int) -> str:
    return time.strftime("%Y-%m-%dT%H:%M:%S.000Z", time.gmtime(ts or 0))


def _http_date(ts: int) -> str:
    return time.strftime("%a, %d %b %Y %H:%M:%S GMT", time.gmtime(ts or 0))


def _walk_bucket(s3: S3ApiServer, bucket: str, prefix: str,
                 delimiter: str, marker: str, max_keys: int):
    """Flatten the bucket directory tree into S3 keys in global
    lexicographic order (the S3 contract — pagination markers compare
    against ALL keys, not per-directory traversal order), then apply
    delimiter grouping and marker/max-keys pagination."""
    all_keys: List[tuple] = []
    base = f"{BUCKETS_DIR}/{bucket}"

    def recurse(directory: str, key_prefix: str):
        for e in s3.list_entries(directory, limit=100000):
            if key_prefix == "" and e.name == MULTIPART_DIR:
                continue
            key = key_prefix + e.name
            if e.is_directory:
                sub_prefix = key + "/"
                # prune subtrees that cannot contain the prefix
                if prefix and not sub_prefix.startswith(prefix) \
                        and not prefix.startswith(sub_prefix):
                    continue
                recurse(f"{directory}/{e.name}", sub_prefix)
            elif not prefix or key.startswith(prefix):
                all_keys.append((key, e))

    recurse(base, "")
    all_keys.sort(key=lambda kv: kv[0])

    contents: List[tuple] = []
    prefixes: List[str] = []
    seen_prefixes: set = set()
    truncated = False
    next_marker = ""
    for key, e in all_keys:
        if delimiter:
            rest = key[len(prefix):]
            if delimiter in rest:
                cp = prefix + rest.split(delimiter)[0] + delimiter
                if marker and cp <= marker:
                    continue
                if cp in seen_prefixes:
                    continue
                if len(contents) + len(prefixes) >= max_keys:
                    truncated = True
                    next_marker = cp
                    break
                seen_prefixes.add(cp)
                prefixes.append(cp)
                continue
        if marker and key <= marker:
            continue
        if len(contents) + len(prefixes) >= max_keys:
            truncated = True
            next_marker = key
            break
        contents.append((key, e))
    if truncated and not next_marker:
        next_marker = contents[-1][0] if contents else ""
    elif truncated:
        # marker for the NEXT page is the last item actually returned
        last_items = [c[0] for c in contents] + prefixes
        next_marker = max(last_items) if last_items else next_marker
    return contents, prefixes, truncated, next_marker
