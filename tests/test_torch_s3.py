"""The port's S3 gateway against the JAX package's.

Each package runs its own cluster in the process (a master, two volume
servers on the CPU codec, a filer with 256 KiB chunks on sqlite) with its
own gateway on top, both holding the same identities. The same seeded
requests, each signed for its gateway with SigV4 (or SigV2, presigned,
aws-chunked, a POST policy), go to both gateways and must get the same
status, the same headers (bar ``Date`` and ``Server``) and the same body,
with only these normalised: the gateway's own address, upload ids (each
side's id is mapped to ``UPLOAD``), times stamped from the wall clock
(``LastModified``, ``CreationDate`` and ``Last-Modified``) and the order
of a TagSet's tags (they list a protobuf map, whose iteration order is
undefined); object bytes are compared by sha256. That covers list buckets, bucket create,
head and delete, put, get (with Range), head, copy and delete of objects,
batch delete, ListObjects v1 and v2 with prefix, delimiter, max-keys and
continuation, multipart (initiate, upload part, UploadPartCopy with a
range, complete, abort, list parts, list uploads), tagging, presigned
GET, the POST-policy upload and the 403s of a wrong key, a wrong secret
and a missing action; the chunk-aware ETag of a >4 MiB object equals the
JAX gateway's. Each package's client signs for the other's gateway.

Pure logic, seeded, both packages side by side: ``iam_pb2`` JSON parse
and print against ``google.protobuf.json_format``, ``sigv4_headers`` at a
fixed time, ``Iam`` accept or deny over 200 signed requests (SigV4,
SigV2, presigned, expired, wrong key, wrong secret, wrong action,
aws-chunked) and post-policy decisions over seeded policies. Also the
s3 tier round trip against the port's own gateway and the s3 role's 503
SlowDown shed.
"""

import base64
import datetime
import hashlib
import hmac
import http.client
import json
import os
import re
import time
import urllib.parse

import numpy as np
import pytest

from seaweedfs_tpu.pb import iam_pb2 as jax_iam_pb2
from seaweedfs_tpu.s3api import S3ApiServer as JaxS3
from seaweedfs_tpu.s3api import auth as jax_auth
from seaweedfs_tpu.s3api import post_policy as jax_pp
from seaweedfs_tpu.util import aws_auth as jax_aws
from seaweedfs_tpu.util import s3_client as jax_s3c
from seaweedfs_tpu_torch.pb import iam_pb2 as port_iam_pb2
from seaweedfs_tpu_torch.pb import json_format as port_json
from seaweedfs_tpu_torch.s3api import S3ApiServer as PortS3
from seaweedfs_tpu_torch.s3api import auth as port_auth
from seaweedfs_tpu_torch.s3api import post_policy as port_pp
from seaweedfs_tpu_torch.util import aws_auth as port_aws
from seaweedfs_tpu_torch.util import s3_client as port_s3c
from tests.test_torch_cluster import free_port_pair
from tests.test_torch_filer_server import make_sides

REGION = "us-east-1"
# name -> (access key, secret key, actions)
IDENTITIES = {
    "admin": ("AKIDADMIN", "admin/secret+KEY", ["Admin"]),
    "writer": ("AKIDWRITER", "writer-secret", ["Write", "List"]),
    "reader": ("AKIDREADER", "reader-secret", ["Read"]),
    "scoped": ("AKIDSCOPED", "scoped-secret",
               ["Read:tbkt", "Write:tbkt", "List:tbkt", "Tagging:tbkt"]),
}


def make_iam(auth_mod, names=tuple(IDENTITIES)):
    return auth_mod.Iam([
        auth_mod.Identity(n, [auth_mod.Credential(*IDENTITIES[n][:2])],
                          list(IDENTITIES[n][2])) for n in names])


# -- signing (the wire rules, written out once for both gateways) ---------------


def _hm(key: bytes, msg: str) -> bytes:
    return hmac.new(key, msg.encode(), hashlib.sha256).digest()


def signing_key(secret: str, date: str) -> bytes:
    k = _hm(("AWS4" + secret).encode(), date)
    return _hm(_hm(_hm(k, REGION), "s3"), "aws4_request")


def canonical_query(query: str) -> str:
    pairs = sorted(urllib.parse.parse_qsl(query, keep_blank_values=True))
    return "&".join(f"{urllib.parse.quote(k, safe='-_.~')}="
                    f"{urllib.parse.quote(v, safe='-_.~')}"
                    for k, v in pairs)


def sign_v4(host, method, path, query, headers, payload, access, secret,
            t=None, payload_hash=None):
    """Headers with a SigV4 Authorization over the raw path and query."""
    t = time.gmtime() if t is None else t
    amz_date = time.strftime("%Y%m%dT%H%M%SZ", t)
    date = amz_date[:8]
    payload_hash = payload_hash or hashlib.sha256(payload).hexdigest()
    h = {k.lower(): v for k, v in (headers or {}).items()}
    h.update({"host": host, "x-amz-date": amz_date,
              "x-amz-content-sha256": payload_hash})
    signed = sorted(h)
    creq = "\n".join([method, urllib.parse.quote(path, safe="/-_.~"),
                      canonical_query(query),
                      "".join(f"{k}:{' '.join(str(h[k]).split())}\n"
                              for k in signed),
                      ";".join(signed), payload_hash])
    scope = f"{date}/{REGION}/s3/aws4_request"
    sts = "\n".join(["AWS4-HMAC-SHA256", amz_date, scope,
                     hashlib.sha256(creq.encode()).hexdigest()])
    sig = hmac.new(signing_key(secret, date), sts.encode(),
                   hashlib.sha256).hexdigest()
    h["authorization"] = (f"AWS4-HMAC-SHA256 Credential={access}/{scope}, "
                          f"SignedHeaders={';'.join(signed)}, "
                          f"Signature={sig}")
    return h, sig, amz_date, scope


def presign(host, method, path, access, secret, expires=300, t=None):
    """The query string of a presigned URL (X-Amz-Signature last)."""
    t = time.gmtime() if t is None else t
    amz_date = time.strftime("%Y%m%dT%H%M%SZ", t)
    scope = f"{amz_date[:8]}/{REGION}/s3/aws4_request"
    params = [("X-Amz-Algorithm", "AWS4-HMAC-SHA256"),
              ("X-Amz-Credential", f"{access}/{scope}"),
              ("X-Amz-Date", amz_date), ("X-Amz-Expires", str(expires)),
              ("X-Amz-SignedHeaders", "host")]
    cq = canonical_query(urllib.parse.urlencode(params))
    creq = "\n".join([method, path, cq, f"host:{host}\n", "host",
                      "UNSIGNED-PAYLOAD"])
    sts = "\n".join(["AWS4-HMAC-SHA256", amz_date, scope,
                     hashlib.sha256(creq.encode()).hexdigest()])
    sig = hmac.new(signing_key(secret, amz_date[:8]), sts.encode(),
                   hashlib.sha256).hexdigest()
    return f"{cq}&X-Amz-Signature={sig}"


def sign_v2(method, path, query, headers, secret, access):
    sub = sorted((k, v) for k, v in urllib.parse.parse_qsl(
        query, keep_blank_values=True) if k in jax_auth.Iam._SUBRESOURCES)
    resource = path + ("?" + "&".join(k if not v else f"{k}={v}"
                                      for k, v in sub) if sub else "")
    h = {k.lower(): v for k, v in headers.items()}
    amz = sorted((k, v) for k, v in h.items() if k.startswith("x-amz-"))
    date_line = "" if "x-amz-date" in dict(amz) else h.get("date", "")
    sts = "\n".join([method, h.get("content-md5", ""),
                     h.get("content-type", ""), date_line]) + "\n" + \
        "".join(f"{k}:{v}\n" for k, v in amz) + resource
    sig = base64.b64encode(hmac.new(secret.encode(), sts.encode(),
                                    hashlib.sha1).digest()).decode()
    h["authorization"] = f"AWS {access}:{sig}"
    return h


def chunked_body(chunk: bytes, seed_sig: str, amz_date: str, scope: str,
                 secret: str) -> bytes:
    key = signing_key(secret, amz_date[:8])

    def sig(prev, data):
        sts = "\n".join(["AWS4-HMAC-SHA256-PAYLOAD", amz_date, scope, prev,
                         hashlib.sha256(b"").hexdigest(),
                         hashlib.sha256(data).hexdigest()])
        return hmac.new(key, sts.encode(), hashlib.sha256).hexdigest()

    s1 = sig(seed_sig, chunk)
    s0 = sig(s1, b"")
    return (f"{len(chunk):x};chunk-signature={s1}\r\n".encode() + chunk +
            b"\r\n" + f"0;chunk-signature={s0}\r\n\r\n".encode())


# -- the two gateways ------------------------------------------------------------


class Gateway:
    """One package's gateway (and the cluster and filer under it)."""

    def __init__(self, name, side, server):
        self.name = name
        self.side = side
        self.server = server
        self.uploads = {}        # upload id -> "UPLOAD<n>"

    @property
    def url(self) -> str:
        return self.server.url


def raw_request(url, method, path_qs, body=b"", headers=None):
    host, port = url.split(":")
    conn = http.client.HTTPConnection(host, int(port), timeout=60)
    try:
        conn.request(method, path_qs, body=body or None,
                     headers=headers or {})
        r = conn.getresponse()
        return r.status, r.getheaders(), r.read()
    finally:
        conn.close()


_TIMES = [(re.compile(rb"<(LastModified|CreationDate)>[^<]*</"),
           rb"<\1>TIME</")]


def normalize(gw: Gateway, status, headers, body):
    """What may differ between the gateways, masked (module docstring)."""
    for m in re.finditer(rb"<UploadId>([0-9a-f]{32})</UploadId>", body):
        uid = m.group(1).decode()
        gw.uploads.setdefault(uid, f"UPLOAD{len(gw.uploads)}")
    for uid, alias in gw.uploads.items():
        body = body.replace(uid.encode(), alias.encode())
    body = body.replace(gw.url.encode(), b"GATEWAY")
    for pat, rep in _TIMES:
        body = pat.sub(rep, body)
    # a TagSet lists the entry's extended map, whose iteration order
    # protobuf leaves undefined: its tags are compared in key order
    m = re.search(rb"<TagSet>(.*)</TagSet>", body)
    if m:
        tags = sorted(re.findall(rb"<Tag>.*?</Tag>", m.group(1)))
        body = body[:m.start(1)] + b"".join(tags) + body[m.end(1):]
    hs = []
    for k, v in headers:
        kl = k.lower()
        if kl in ("date", "server"):
            continue
        if kl == "last-modified":
            v = "TIME"
        if kl == "location":
            v = v.replace(gw.url, "GATEWAY")
        hs.append((k, v))
    if len(body) > 4096:
        body = hashlib.sha256(body).hexdigest().encode()
    return status, hs, body


def send(gw, method, path, query="", body=b"", headers=None, who="admin",
         auth="v4"):
    """One request to one gateway, signed for it as ``who``."""
    headers = dict(headers or {})
    for uid, alias in gw.uploads.items():
        query = query.replace(alias, uid)
    path_qs = urllib.parse.quote(path) + (f"?{query}" if query else "")
    if auth == "v4":
        access, secret, _ = IDENTITIES[who]
        headers, _, _, _ = sign_v4(gw.url, method, path, query, headers,
                                   body, access, secret)
    elif auth == "presigned":
        access, secret, _ = IDENTITIES[who]
        path_qs = urllib.parse.quote(path) + "?" + presign(
            gw.url, method, path, access, secret)
    return raw_request(gw.url, method, path_qs, body, headers)


def as_the_port_answers(method, path, headers, status, hs, body):
    """The JAX gateway's answer with its two object-GET faults made as
    the port answers them (differences kept on purpose): a proxied GET
    with a body sends ``Content-Type`` twice in JAX and once in the port,
    and a Range the filer refuses with 416 is S3's ``InvalidRange`` in
    the port and ``InternalError`` in JAX. Anything else is unchanged."""
    if method != "GET":
        return status, hs, body
    types = [i for i, (k, _) in enumerate(hs) if k.lower() == "content-type"]
    if len(types) == 2:
        assert hs[types[0]] == hs[types[1]]
        hs = hs[:types[1]] + hs[types[1] + 1:]
    rng = (headers or {}).get("Range")
    fault = (f"<Code>InternalError</Code><Message>"
             f"{path.lstrip('/').partition('/')[2]}</Message>").encode()
    if status == 416 and rng and fault in body:
        body = body.replace(fault, f"<Code>InvalidRange</Code><Message>"
                            f"{rng}</Message>".encode())
        hs = [(k, str(len(body)) if k.lower() == "content-length" else v)
              for k, v in hs]
    return status, hs, body


def both(gws, method, path, query="", body=b"", headers=None, who="admin",
         auth="v4"):
    """The same request to both gateways: equal answers (normalised, and
    the JAX one as the port answers it: ``as_the_port_answers``)."""
    out = {}
    for name, gw in gws.items():
        out[name] = normalize(gw, *send(gw, method, path, query, body,
                                        headers, who, auth))
    want = as_the_port_answers(method, path, headers, *out["jax"])
    assert out["port"] == want, (method, path, query)
    return out["port"]


def start_gateways(sides, iam_names=tuple(IDENTITIES)):
    jgw = JaxS3(filer_url=sides["jax"].filer.url, port=free_port_pair(),
                iam=make_iam(jax_auth, iam_names))
    jgw.start()
    try:
        pgw = PortS3(filer_url=sides["port"].filer.url,
                     port=free_port_pair(),
                     iam=make_iam(port_auth, iam_names))
        pgw.start()
    except BaseException:
        jgw.stop()
        raise
    return {"jax": Gateway("jax", sides["jax"], jgw),
            "port": Gateway("port", sides["port"], pgw)}


@pytest.fixture(scope="module")
def gws(tmp_path_factory):
    sides, undo = make_sides(tmp_path_factory)
    try:
        out = start_gateways(sides)
    except BaseException:
        for s in sides.values():
            s.stop()
        undo()
        raise
    both(out, "PUT", "/tbkt")
    yield out
    for g in out.values():
        g.server.stop()
    for s in sides.values():
        s.stop()
    undo()


def _payload(n, seed):
    return np.random.default_rng(seed).bytes(n)


# -- buckets and objects ----------------------------------------------------------


def test_buckets_answer_alike(gws):
    assert both(gws, "PUT", "/mybucket")[0] == 200
    assert b"<Name>mybucket</Name>" in both(gws, "GET", "/")[2]
    assert both(gws, "HEAD", "/mybucket")[0] == 200
    assert both(gws, "DELETE", "/mybucket")[0] == 204
    assert both(gws, "HEAD", "/ghost-bucket")[0] == 404
    assert both(gws, "GET", "/ghost-bucket")[0] == 404
    assert both(gws, "PATCH", "/tbkt")[0] == 501


@pytest.mark.parametrize("size,ctype", [
    (1, ""), (1400, "text/plain"), (300 << 10, "application/x-bin"),
    ((4 << 20) + 513 * 1024, "")], ids=["1B", "1400B", "300KiB", "4.5MiB"])
def test_put_get_head_answer_alike(gws, size, ctype):
    data = _payload(size, size)
    hs = {"Content-Type": ctype} if ctype else {}
    key = f"/tbkt/objs/o{size}.bin"
    status, put_hs, _ = both(gws, "PUT", key, body=data, headers=hs)
    assert status == 200
    status, head_hs, _ = both(gws, "HEAD", key)
    # the chunk-aware etag of a multi-chunk object: PUT's is HEAD's
    assert dict(put_hs)["ETag"] == dict(head_hs)["ETag"]
    status, _, body = both(gws, "GET", key)
    assert status == 200
    want = data if len(data) <= 4096 else \
        hashlib.sha256(data).hexdigest().encode()
    assert body == want
    for rng in ("bytes=0-0", f"bytes={size // 3}-{size // 2}",
                "bytes=-7", f"bytes={size}-"):
        both(gws, "GET", key, headers={"Range": rng})


def test_object_get_sends_one_content_type_and_invalid_range(gws):
    """The two object-GET faults of the JAX gateway, repaired in the port
    only: a GET with a body carries ``Content-Type`` once (JAX: twice),
    and a Range past the end answers 416 ``InvalidRange`` naming the
    range (JAX: 416 ``InternalError`` naming the key)."""
    data = _payload(1000, 7)
    key = "/tbkt/objs/ctype.bin"
    assert both(gws, "PUT", key, body=data,
                headers={"Content-Type": "text/x-one"})[0] == 200
    got = {n: send(gw, "GET", key) for n, gw in gws.items()}
    for n, want in (("jax", 2), ("port", 1)):
        status, hs, body = got[n]
        assert status == 200 and body == data
        assert [v for k, v in hs if k.lower() == "content-type"] == \
            ["text/x-one"] * want, n
    got = {n: send(gw, "GET", key, headers={"Range": "bytes=1000-"})
           for n, gw in gws.items()}
    assert got["jax"][0] == got["port"][0] == 416
    assert b"<Code>InternalError</Code><Message>objs/ctype.bin</Message>" \
        in got["jax"][2]
    assert b"<Code>InvalidRange</Code><Message>bytes=1000-</Message>" \
        in got["port"][2]
    both(gws, "GET", key, headers={"Range": "bytes=1000-"})


def test_missing_and_deleted_objects_answer_alike(gws):
    both(gws, "PUT", "/tbkt/doomed.txt", body=b"x")
    assert both(gws, "DELETE", "/tbkt/doomed.txt")[0] == 204
    assert both(gws, "GET", "/tbkt/doomed.txt")[0] == 404
    assert both(gws, "HEAD", "/tbkt/doomed.txt")[0] == 404
    assert both(gws, "GET", "/tbkt/objs")[0] == 404   # a directory key


def test_copy_and_batch_delete_answer_alike(gws):
    both(gws, "PUT", "/tbkt/src.txt", body=b"copy me",
         headers={"Content-Type": "text/x-copy"})
    status, _, body = both(gws, "PUT", "/tbkt/dst.txt",
                           headers={"x-amz-copy-source": "/tbkt/src.txt"})
    assert status == 200 and b"CopyObjectResult" in body
    assert both(gws, "GET", "/tbkt/dst.txt")[2] == b"copy me"
    assert both(gws, "PUT", "/tbkt/dst2.txt",
                headers={"x-amz-copy-source": "/tbkt/ghost"})[0] == 404
    for n in ("b1.txt", "b2.txt"):
        both(gws, "PUT", f"/tbkt/batch/{n}", body=b"x")
    for quiet in ("", "<Quiet>true</Quiet>"):
        body = (f"<Delete>{quiet}<Object><Key>batch/b1.txt</Key></Object>"
                "<Object><Key>batch/b2.txt</Key></Object></Delete>").encode()
        assert both(gws, "POST", "/tbkt", "delete", body=body)[0] == 200
    assert both(gws, "POST", "/tbkt", "delete", body=b"<bad")[0] == 400


# -- listing ------------------------------------------------------------------------


@pytest.fixture(scope="module")
def listed(gws):
    both(gws, "PUT", "/lbkt")
    rng = np.random.default_rng(3)
    keys = ["a.txt", "a/x", "d1/b.txt", "d1/c.txt", "d2/deep/e.txt"] + [
        f"p{int(rng.integers(0, 4))}/k{i:03d}.bin" for i in range(40)]
    for k in keys:
        both(gws, "PUT", f"/lbkt/{k}", body=_payload(int(rng.integers(
            1, 2000)), 7))
    return keys


@pytest.mark.parametrize("query", [
    "", "list-type=2", "list-type=2&prefix=d1/", "delimiter=/",
    "list-type=2&delimiter=/&prefix=p1/", "list-type=2&max-keys=7",
    "max-keys=3&marker=d1/b.txt", "list-type=2&start-after=p2",
    "list-type=2&delimiter=/&max-keys=2", "prefix=zzz", "max-keys=0",
    "uploads"])
def test_listings_answer_alike(gws, listed, query):
    assert both(gws, "GET", "/lbkt", query)[0] == 200


def test_v2_pages_answer_alike(gws, listed):
    """Every page of a max-keys 7 walk (v2 continuation and v1 marker)."""
    for v2 in (True, False):
        token, seen = "", []
        for _ in range(20):
            q = "list-type=2&max-keys=7" if v2 else "max-keys=7"
            if token:
                q += (f"&continuation-token={urllib.parse.quote(token)}"
                      if v2 else f"&marker={urllib.parse.quote(token)}")
            _, _, body = both(gws, "GET", "/lbkt", q)
            seen += re.findall(rb"<Key>([^<]*)</Key>", body)
            m = re.search(rb"<(NextContinuationToken|NextMarker)>([^<]*)<",
                          body)
            if m is None:
                break
            token = urllib.parse.unquote(m.group(2).decode()) if v2 \
                else m.group(2).decode()
        assert sorted(k.decode() for k in seen) == sorted(listed)


# -- multipart -------------------------------------------------------------------------


def test_multipart_answers_alike(gws):
    key = "/tbkt/mp/big.bin"
    src = _payload(3000, 11)
    both(gws, "PUT", "/tbkt/mp/partsrc.bin", body=src)
    _, _, body = both(gws, "POST", key, "uploads",
                      headers={"Content-Type": "video/x-test"})
    alias = re.search(rb"<UploadId>([^<]*)<", body).group(1).decode()
    parts = {1: _payload(300 << 10, 1), 3: _payload(100 << 10, 3)}
    for n, data in parts.items():
        assert both(gws, "PUT", key, f"partNumber={n}&uploadId={alias}",
                    body=data)[0] == 200
    status, _, body = both(
        gws, "PUT", key, f"partNumber=2&uploadId={alias}",
        headers={"x-amz-copy-source": "/tbkt/mp/partsrc.bin",
                 "x-amz-copy-source-range": "bytes=1000-1999"})
    assert status == 200 and b"CopyPartResult" in body
    for bad in ("bytes=5000-9999", "0-99"):
        both(gws, "PUT", key, f"partNumber=4&uploadId={alias}",
             headers={"x-amz-copy-source": "/tbkt/mp/partsrc.bin",
                      "x-amz-copy-source-range": bad})
    assert both(gws, "PUT", key, f"partNumber=abc&uploadId={alias}",
                body=b"x")[0] == 400
    assert both(gws, "PUT", key, "partNumber=1&uploadId=deadbeef",
                body=b"x")[0] == 404
    assert b"<PartNumber>2</PartNumber>" in both(
        gws, "GET", key, f"uploadId={alias}")[2]
    assert alias.encode() in both(gws, "GET", "/tbkt", "uploads")[2]
    manifest = (b"<CompleteMultipartUpload>" + b"".join(
        b"<Part><PartNumber>%d</PartNumber></Part>" % n for n in (1, 2, 3))
        + b"</CompleteMultipartUpload>")
    status, _, body = both(gws, "POST", key, f"uploadId={alias}",
                           body=manifest)
    assert status == 200 and b"CompleteMultipartUploadResult" in body
    want = parts[1] + src[1000:2000] + parts[3]
    status, hs, body = both(gws, "GET", key)
    assert body == hashlib.sha256(want).hexdigest().encode()
    assert dict(hs)["Content-Type"] == "video/x-test"
    both(gws, "HEAD", key)
    both(gws, "GET", key, headers={"Range": f"bytes={(300 << 10) - 5}-"
                                            f"{(300 << 10) + 1004}"})
    # abort
    _, _, body = both(gws, "POST", "/tbkt/mp/gone.bin", "uploads")
    gone = re.search(rb"<UploadId>([^<]*)<", body).group(1).decode()
    both(gws, "PUT", "/tbkt/mp/gone.bin", f"partNumber=1&uploadId={gone}",
         body=b"zzz")
    assert both(gws, "DELETE", "/tbkt/mp/gone.bin",
                f"uploadId={gone}")[0] == 204
    assert both(gws, "PUT", "/tbkt/mp/gone.bin",
                f"partNumber=2&uploadId={gone}", body=b"late")[0] == 404
    assert both(gws, "POST", "/tbkt/mp/gone.bin",
                f"uploadId={gone}")[0] == 404


# -- tagging, presigned, streaming, POST policy -------------------------------------


def test_tagging_answers_alike(gws):
    both(gws, "PUT", "/tbkt/tagged.txt", body=b"x")
    tags = (b"<Tagging><TagSet><Tag><Key>env</Key><Value>prod</Value></Tag>"
            b"<Tag><Key>team</Key><Value>infra</Value></Tag></TagSet>"
            b"</Tagging>")
    assert both(gws, "PUT", "/tbkt/tagged.txt", "tagging",
                body=tags)[0] == 200
    assert b"<Key>team</Key>" in both(gws, "GET", "/tbkt/tagged.txt",
                                      "tagging")[2]
    assert both(gws, "PUT", "/tbkt/tagged.txt", "tagging",
                body=b"<oops")[0] == 400
    assert both(gws, "DELETE", "/tbkt/tagged.txt", "tagging")[0] == 204
    both(gws, "GET", "/tbkt/tagged.txt", "tagging")
    assert both(gws, "GET", "/tbkt/nope.txt", "tagging")[0] == 404


def test_presigned_get_answers_alike(gws):
    both(gws, "PUT", "/tbkt/presigned.txt", body=b"presigned ok")
    status, _, body = both(gws, "GET", "/tbkt/presigned.txt",
                           auth="presigned")
    assert (status, body) == (200, b"presigned ok")
    for name, gw in gws.items():
        access, secret, _ = IDENTITIES["admin"]
        q = presign(gw.url, "GET", "/tbkt/presigned.txt", access, secret,
                    expires=60, t=time.gmtime(time.time() - 3600))
        assert raw_request(gw.url, "GET", f"/tbkt/presigned.txt?{q}")[0] \
            == 403, name
        good = presign(gw.url, "GET", "/tbkt/presigned.txt", access, secret)
        assert raw_request(gw.url, "GET",
                           f"/tbkt/presigned.txt?{good[:-4]}0000")[0] \
            == 403, name


@pytest.mark.parametrize("key", ["plain.txt", "a b+c=d.txt",
                                 "dir/\u00e9%20x~y.txt"])
def test_port_presigned_target_is_accepted_by_both_gateways(gws, key):
    """``aws_auth.presigned_target`` encodes the path once, as it signs
    it: equal to the signer above at a fixed time, and each gateway
    serves it (and refuses it expired) for keys with reserved bytes."""
    path = f"/tbkt/{key}"
    both(gws, "PUT", path, body=key.encode())
    access, secret, _ = IDENTITIES["reader"]
    fixed = time.gmtime(1_760_000_000)
    encoded = urllib.parse.quote(path, safe="/-_.~")
    assert port_aws.presigned_target(
        "GET", "h:1", path, access, secret, REGION, "s3", t=fixed) == \
        f"{encoded}?{presign('h:1', 'GET', encoded, access, secret, t=fixed)}"
    for name, gw in gws.items():
        target = port_aws.presigned_target("GET", gw.url, path, access,
                                           secret, REGION, "s3")
        status, _, body = raw_request(gw.url, "GET", target)
        assert (status, body) == (200, key.encode()), name
        stale = port_aws.presigned_target(
            "GET", gw.url, path, access, secret, REGION, "s3", expires=60,
            t=time.gmtime(time.time() - 3600))
        assert raw_request(gw.url, "GET", stale)[0] == 403, name


def test_streaming_upload_answers_alike(gws):
    chunk = b"signed streaming chunk data"
    out = {}
    for name, gw in gws.items():
        access, secret, _ = IDENTITIES["admin"]
        sha = "STREAMING-AWS4-HMAC-SHA256-PAYLOAD"
        hs, seed, amz_date, scope = sign_v4(
            gw.url, "PUT", "/tbkt/streamed.bin", "", {}, b"", access,
            secret, payload_hash=sha)
        body = chunked_body(chunk, seed, amz_date, scope, secret)
        good = raw_request(gw.url, "PUT", "/tbkt/streamed.bin", body, hs)
        bad = raw_request(gw.url, "PUT", "/tbkt/streamed.bin",
                          body.replace(chunk, chunk[::-1]), hs)
        out[name] = (normalize(gw, *good), normalize(gw, *bad))
    assert out["port"] == out["jax"]
    assert out["port"][0][0] == 200 and out["port"][1][0] == 403
    assert both(gws, "GET", "/tbkt/streamed.bin")[2] == chunk


def _form(fields, data, filename="up.bin"):
    boundary = "form-boundary-123"
    out = b""
    for k, v in fields.items():
        out += (f"--{boundary}\r\nContent-Disposition: form-data; "
                f'name="{k}"\r\n\r\n{v}\r\n').encode()
    out += (f"--{boundary}\r\nContent-Disposition: form-data; name=\"file\";"
            f' filename="{filename}"\r\nContent-Type: '
            "application/octet-stream\r\n\r\n").encode()
    out += data + f"\r\n--{boundary}--\r\n".encode()
    return out, f"multipart/form-data; boundary={boundary}"


def _policy_fields(key, conditions=None, expires_in=600, extra=(),
                   who="admin"):
    access, secret, _ = IDENTITIES[who]
    exp = datetime.datetime.now(datetime.timezone.utc) + \
        datetime.timedelta(seconds=expires_in)
    date = time.strftime("%Y%m%d", time.gmtime())
    cred = f"{access}/{date}/{REGION}/s3/aws4_request"
    doc = {"expiration": exp.strftime("%Y-%m-%dT%H:%M:%S.000Z"),
           "conditions": (conditions if conditions is not None else [
               {"bucket": "tbkt"}, ["starts-with", "$key", ""],
               {"x-amz-algorithm": "AWS4-HMAC-SHA256"},
               {"x-amz-credential": cred}] + list(extra))}
    policy = base64.b64encode(json.dumps(doc).encode()).decode()
    sig = hmac.new(signing_key(secret, date), policy.encode(),
                   hashlib.sha256).hexdigest()
    return {"key": key, "policy": policy,
            "x-amz-algorithm": "AWS4-HMAC-SHA256",
            "x-amz-credential": cred, "x-amz-signature": sig}


def _post_both(gws, fields, data, filename="up.bin"):
    body, ctype = _form(fields, data, filename)
    return both(gws, "POST", "/tbkt", body=body,
                headers={"Content-Type": ctype}, auth="none")


def test_post_policy_answers_alike(gws):
    f = _policy_fields("docs/${filename}")
    assert _post_both(gws, f, b"browser bytes", "report.pdf")[0] == 204
    assert both(gws, "GET", "/tbkt/docs/report.pdf")[2] == b"browser bytes"
    f = _policy_fields("x201.bin", extra=[{"success_action_status": "201"}])
    f["success_action_status"] = "201"
    assert _post_both(gws, f, b"x" * 64)[0] == 201
    f = _policy_fields("redir.bin", extra=[
        ["starts-with", "$success_action_redirect", "http://127.0.0.1:1/"]])
    f["success_action_redirect"] = "http://127.0.0.1:1/done"
    assert _post_both(gws, f, b"y" * 16)[0] == 303
    bad = _policy_fields("evil.bin")
    bad["x-amz-signature"] = "0" * 64
    assert _post_both(gws, bad, b"z")[0] == 403
    assert _post_both(gws, _policy_fields("late.bin", expires_in=-60),
                      b"z")[0] == 403
    big = _policy_fields("big.bin", extra=[["content-length-range", 1, 10]])
    assert _post_both(gws, big, b"q" * 100)[0] == 400
    sneaky = _policy_fields("sneaky.bin")
    sneaky["success_action_redirect"] = "http://evil.example/"
    assert _post_both(gws, sneaky, b"z")[0] == 403
    reader = _policy_fields("r.bin", who="reader")
    assert _post_both(gws, reader, b"z")[0] == 403
    nokey = _policy_fields("")
    assert _post_both(gws, nokey, b"z")[0] == 400


# -- identities and grants ---------------------------------------------------------


def test_grants_and_bad_credentials_answer_alike(gws):
    both(gws, "PUT", "/other")
    both(gws, "PUT", "/other/hidden.txt", body=b"classified")
    assert both(gws, "PUT", "/newbkt", who="writer")[0] == 403
    assert both(gws, "PUT", "/tbkt/w.txt", body=b"data",
                who="writer")[0] == 200
    assert both(gws, "GET", "/tbkt/w.txt", who="writer")[0] == 403
    assert both(gws, "GET", "/tbkt/w.txt", who="reader")[2] == b"data"
    assert both(gws, "PUT", "/tbkt/r.txt", body=b"x", who="reader")[0] == 403
    assert both(gws, "GET", "/", who="reader")[0] == 403
    # the bucket-scoped identity: its bucket only, and no copy out of
    # another bucket
    assert both(gws, "GET", "/tbkt", "list-type=2", who="scoped")[0] == 200
    assert both(gws, "GET", "/other", who="scoped")[0] == 403
    assert both(gws, "PUT", "/tbkt/steal.bin", who="scoped",
                headers={"x-amz-copy-source": "/other/hidden.txt"})[0] == 403
    assert both(gws, "GET", "/tbkt", auth="none")[0] == 403
    out = {}
    for name, gw in gws.items():
        replies = []
        for access, secret in (("AKIDNOBODY", "x"),
                               (IDENTITIES["admin"][0], "wrong")):
            hs, _, _, _ = sign_v4(gw.url, "GET", "/tbkt", "", {}, b"",
                                  access, secret)
            replies.append(normalize(gw, *raw_request(gw.url, "GET",
                                                      "/tbkt", b"", hs)))
        hs = sign_v2("GET", "/tbkt/w.txt", "", {
            "Date": "Tue, 27 Mar 2007 19:36:42 +0000",
            "x-amz-meta-foo": "bar"}, IDENTITIES["reader"][1],
            IDENTITIES["reader"][0])
        replies.append(normalize(gw, *raw_request(gw.url, "GET",
                                                  "/tbkt/w.txt", b"", hs)))
        out[name] = replies
    assert out["port"] == [as_the_port_answers("GET", "/tbkt/w.txt", None, *r)
                           for r in out["jax"]]
    assert [r[0] for r in out["port"]] == [403, 403, 200]
    assert b"InvalidAccessKeyId" in out["port"][0][2]
    assert b"SignatureDoesNotMatch" in out["port"][1][2]


# -- each package's client against the other's gateway ---------------------------------


@pytest.mark.parametrize("client_mod,gateway", [(jax_s3c, "port"),
                                                 (port_s3c, "jax")])
def test_clients_cross_sign(gws, client_mod, gateway, tmp_path):
    gw = gws[gateway]
    access, secret, _ = IDENTITIES["admin"]
    c = client_mod.S3Client(gw.url, access, secret)
    c.create_bucket("xsign")
    data = _payload(700 << 10, 21)
    etag = c.put_object("xsign", "dir/a b+c.bin", data)
    assert c.get_object("xsign", "dir/a b+c.bin") == data
    assert c.get_object("xsign", "dir/a b+c.bin", (5, 70004)) == \
        data[5:70005]
    assert c.head_object("xsign", "dir/a b+c.bin")["ETag"].strip('"') == \
        etag
    for i in range(5):
        c.put_object("xsign", f"many/{i}", b"%d" % i)
    listed = list(c.list_objects("xsign", prefix="many/", max_keys=2))
    assert [o["key"] for o in listed] == [f"many/{i}" for i in range(5)]
    src = tmp_path / "up.bin"
    src.write_bytes(data[:300000])
    assert c.upload_file(str(src), "xsign", "file.bin") == 300000
    assert c.download_file("xsign", "file.bin", str(tmp_path / "d")) == \
        300000
    assert (tmp_path / "d").read_bytes() == data[:300000]
    c.delete_object("xsign", "dir/a b+c.bin")
    assert c.head_object("xsign", "dir/a b+c.bin") is None
    bad = client_mod.S3Client(gw.url, access, "wrong")
    with pytest.raises(client_mod.S3Error) as ei:
        bad.get_object("xsign", "many/0")
    assert ei.value.status == 403


# -- pure logic: iam_pb2 JSON, sigv4_headers, Iam, post policies -------------------


def _iam_docs(rng):
    """Seeded s3.configure-style documents, valid and not."""
    keys = ["name", "credentials", "actions", "accessKey", "access_key",
            "secretKey", "secret_key", "identities", "bogus", "Name"]
    values = [lambda: "s" + str(int(rng.integers(100))), lambda: 5,
              lambda: None, lambda: True, lambda: [], lambda: ["Read"],
              lambda: [None], lambda: [{"accessKey": "k"}], lambda: "abc",
              lambda: {"name": "x"}, lambda: 1.5, lambda: [1]]

    def obj(depth):
        out = {}
        for _ in range(int(rng.integers(0, 4))):
            k = keys[int(rng.integers(len(keys)))]
            if depth < 2 and rng.integers(3) == 0:
                out[k] = [obj(depth + 1)
                          for _ in range(int(rng.integers(0, 3)))]
            else:
                out[k] = values[int(rng.integers(len(values)))]()
        return out

    docs = [{"identities": [{"name": "a", "credentials": [
        {"accessKey": "k", "secretKey": "s"}], "actions": ["Admin"]}]},
        {"identities": [{"name": "b", "credentials": [
            {"access_key": "k", "secret_key": "s"}]}]},
        {"identities": [{"name": "x", "name2": "y"}]}, {}, {"extra": 1}]
    docs += [{"identities": [obj(1) for _ in range(int(rng.integers(
        0, 3)))]} for _ in range(150)]
    docs += [obj(0) for _ in range(50)]
    return docs


def test_iam_json_parse_and_print_equal_protobuf():
    from google.protobuf import json_format
    rng = np.random.default_rng(13)
    outcomes = set()
    for doc in _iam_docs(rng):
        for ignore in (False, True):
            try:
                m = json_format.ParseDict(
                    doc, jax_iam_pb2.S3ApiConfiguration(),
                    ignore_unknown_fields=ignore)
                want = ("ok", m.SerializeToString(),
                        json_format.MessageToJson(m),
                        json_format.MessageToDict(
                            m, preserving_proto_field_name=True))
            except json_format.ParseError as e:
                want = ("error", str(e))
            try:
                m = port_json.ParseDict(
                    doc, port_iam_pb2.S3ApiConfiguration(),
                    ignore_unknown_fields=ignore)
                got = ("ok", m.SerializeToString(), port_json.MessageToJson(m),
                       port_json.MessageToDict(
                           m, preserving_proto_field_name=True))
            except port_json.ParseError as e:
                got = ("error", str(e))
            assert got == want, (doc, ignore)
            outcomes.add((want[0], ignore))
        # the gateway's loader: the same identities, or both refuse
        results = []
        for mod in (jax_auth, port_auth):
            try:
                iam = mod.iam_from_dict(doc)
                results.append([(i.name, [(c.access_key, c.secret_key)
                                          for c in i.credentials],
                                 i.actions) for i in iam.identities])
            except ValueError:
                results.append("refused")
        assert results[0] == results[1], doc
    assert outcomes == {("ok", False), ("ok", True), ("error", False),
                        ("error", True)}
    assert port_json.Parse('{"identities": [{"name": "n"}]}',
                           port_iam_pb2.S3ApiConfiguration()) \
        .identities[0].name == "n"


def test_iam_message_table_equals_jax_descriptor():
    for name in ("S3ApiConfiguration", "Identity", "Credential"):
        d = getattr(jax_iam_pb2, name).DESCRIPTOR
        want = sorted((f.name, f.number, f.is_repeated) for f in d.fields)
        got = sorted((f.name, f.number, f.repeated)
                     for f in getattr(port_iam_pb2, name)._FIELDS)
        assert got == want, name


def test_sigv4_headers_equal_at_a_fixed_time(monkeypatch):
    fixed = time.gmtime(1_760_000_000)
    monkeypatch.setattr(time, "gmtime", lambda *a: fixed)
    rng = np.random.default_rng(17)
    for _ in range(50):
        query = [(f"k{int(rng.integers(5))}", v) for v in
                 rng.choice(["a b", "x/y", "", "~t+", "é"],
                            int(rng.integers(0, 4)))]
        headers = {"Content-Type": "text/plain",
                   "X-Amz-Meta-A": "  two  spaces "}
        payload = rng.bytes(int(rng.integers(0, 100)))
        args = ("PUT", "h:1", "/b/k ey/é+", query, headers, payload,
                "AK", "SK/+", "eu-west-1", "s3")
        assert port_aws.sigv4_headers(*args) == \
            jax_aws.sigv4_headers(*args)
        assert port_aws.canonical_query(query) == \
            jax_aws.canonical_query(query)


def _auth_cases(rng, host):
    """200 seeded (method, path, query, headers, payload, action, bucket)
    requests: valid and broken signatures of every kind."""
    now = time.time()
    cases = []
    kinds = ["v4", "v4", "v4-wrong-secret", "v4-unknown-key",
             "v4-bad-hash", "v4-unsigned", "v2", "v2-amz-date",
             "v2-wrong", "presigned", "presigned-expired", "anonymous",
             "v4-malformed", "streaming", "streaming-tampered",
             "v2-streaming"]
    for i in range(200):
        kind = kinds[i % len(kinds)] if i < len(kinds) else \
            kinds[int(rng.integers(len(kinds)))]
        who = list(IDENTITIES)[int(rng.integers(len(IDENTITIES)))]
        access, secret, _ = IDENTITIES[who]
        method = str(rng.choice(["GET", "PUT", "DELETE", "HEAD", "POST"]))
        bucket = str(rng.choice(["tbkt", "other", "b3"]))
        raw_path = f"/{bucket}/k{int(rng.integers(100))}/x y.bin"
        # the gateway authenticates the path as it came on the wire
        path = urllib.parse.quote(raw_path)
        query = str(rng.choice(["", "tagging", "uploadId=abc&partNumber=2",
                                "list-type=2&prefix=a%20b", "acl"]))
        payload = rng.bytes(int(rng.integers(0, 64)))
        action = str(rng.choice(["Read", "Write", "List", "Tagging",
                                 "Admin"]))
        t = time.gmtime(now - float(rng.integers(0, 30)))
        headers = {"Content-Type": "application/octet-stream",
                   "x-amz-meta-color": "blue"}
        if kind.startswith("v4") or kind.startswith("streaming"):
            if kind == "v4-unknown-key":
                access = "AKIDNOBODY"
            ph = None
            if kind == "v4-unsigned":
                ph = "UNSIGNED-PAYLOAD"
            if kind.startswith("streaming"):
                ph = "STREAMING-AWS4-HMAC-SHA256-PAYLOAD"
            h, seed, amz_date, scope = sign_v4(
                host, method, raw_path, query, headers,
                payload, access,
                "wrong" if kind == "v4-wrong-secret" else secret,
                t=t, payload_hash=ph)
            if kind == "v4-bad-hash":
                payload = payload + b"!"
            if kind == "v4-malformed":
                h["authorization"] = "AWS4-HMAC-SHA256 Credential=x"
            if kind.startswith("streaming"):
                payload = chunked_body(payload or b"p", seed, amz_date,
                                       scope, secret)
                if kind == "streaming-tampered":
                    payload = payload.replace(b"\r\n", b"\r\n!", 1)
        elif kind.startswith("v2"):
            headers["Date"] = time.strftime("%a, %d %b %Y %H:%M:%S GMT", t)
            if kind == "v2-amz-date":
                headers["x-amz-date"] = headers["Date"]
            h = sign_v2(method, path, query, headers,
                        "wrong" if kind == "v2-wrong" else secret, access)
            if kind == "v2-streaming":
                h["x-amz-content-sha256"] = \
                    "STREAMING-AWS4-HMAC-SHA256-PAYLOAD"
        elif kind.startswith("presigned"):
            expired = kind == "presigned-expired"
            q = presign(host, method, path, access, secret,
                        expires=60 if expired else 600,
                        t=time.gmtime(now - 3600) if expired else t)
            query = q + ("&" + query if query else "")
            h = {"host": host}
        else:
            h = {k.lower(): v for k, v in headers.items()}
        cases.append((kind, method, path, query, h, payload, action,
                      bucket))
    return cases


def test_iam_decisions_equal_over_200_signed_requests():
    rng = np.random.default_rng(23)
    iams = {"jax": make_iam(jax_auth), "port": make_iam(port_auth)}
    decided = set()
    for kind, method, path, query, h, payload, action, bucket in \
            _auth_cases(rng, "gw:8333"):
        got = {}
        for name, mod in (("jax", jax_auth), ("port", port_auth)):
            try:
                ident, body = iams[name].authenticate_and_decode(
                    method, path, query, dict(h), payload)
                got[name] = ("accept", ident.name, body,
                             ident.can_do(action, bucket))
            except mod.S3AuthError as e:
                got[name] = ("deny", e.code, e.status)
        assert got["port"] == got["jax"], (kind, method, path, query)
        decided.add((kind, got["port"][0]))
    # every kind was decided, and both ways overall
    assert {k for k, _ in decided} >= {"v4", "v2", "presigned",
                                       "presigned-expired", "streaming"}
    assert ("v4", "accept") in decided and ("v4-wrong-secret",
                                            "deny") in decided
    # an Iam with no identities lets everyone in, as Admin
    for mod in (jax_auth, port_auth):
        ident, body = mod.Iam().authenticate_and_decode(
            "PUT", "/b/k", "", {"x-amz-content-sha256":
                                "STREAMING-AWS4-HMAC-SHA256-PAYLOAD"},
            b"3;chunk-signature=x\r\nabc\r\n0;chunk-signature=y\r\n\r\n")
        assert (ident.name, body, ident.can_do("Admin", "b")) == \
            ("anonymous", b"abc", True)


def _policies(rng):
    now = datetime.datetime(2026, 10, 17, 12, 0, tzinfo=datetime.timezone.utc)
    fields = ["key", "bucket", "acl", "content-type", "x-amz-meta-tag",
              "success_action_status", "x-ignore-me"]
    for _ in range(300):
        exp = now + datetime.timedelta(seconds=int(rng.integers(-600, 600)))
        exp_s = str(rng.choice([exp.strftime("%Y-%m-%dT%H:%M:%S.000Z"),
                                exp.strftime("%Y-%m-%dT%H:%M:%S"),
                                "not-a-date"]))
        values = {f: str(rng.choice(["a", "ab", "b/c", ""]))
                  for f in rng.choice(fields, int(rng.integers(1, 5)),
                                      replace=False)}
        conds = []
        for _ in range(int(rng.integers(0, 6))):
            f = str(rng.choice(fields))
            op = int(rng.integers(7))
            v = str(rng.choice(["a", "ab", "b", ""]))
            conds.append([
                {f: v}, ["eq", f"${f}", v], ["starts-with", f"${f}", v],
                ["content-length-range", int(rng.integers(0, 50)),
                 int(rng.integers(0, 100))],
                ["content-length-range", "x", 1], ["bogus", 1, 2],
                "bad"][op])
        doc = {"expiration": exp_s, "conditions": conds}
        raw = json.dumps(doc).encode()
        b64 = base64.b64encode(raw).decode() if rng.integers(20) else "%%%"
        yield b64, values, int(rng.integers(0, 120)), now


def test_post_policy_decisions_equal():
    rng = np.random.default_rng(29)
    seen = set()
    for b64, values, size, now in _policies(rng):
        got = []
        for mod in (jax_pp, port_pp):
            try:
                mod.check_policy(b64, dict(values), size, now=now)
                got.append(("ok",))
            except mod.PolicyError as e:
                got.append((e.code, e.status, str(e)))
        assert got[0] == got[1], (base64.b64decode(b64 + "==="), values)
        seen.add(got[0][0])
    assert {"ok", "AccessDenied", "MalformedPOSTRequest"} <= seen
    body, ctype = _form({"key": "k", "Policy": "p"}, b"data", "f.txt")
    assert port_pp.parse_form(ctype, body) == jax_pp.parse_form(ctype, body)
    for mod in (jax_pp, port_pp):
        with pytest.raises(mod.PolicyError):
            mod.parse_form("multipart/form-data", b"junk")


# -- the s3 tier against the port's own gateway ------------------------------------


def test_s3_backend_tier_roundtrip(tmp_path):
    """The port's s3.* tier backend speaks SigV4 to the port's gateway:
    the .dat goes up, needle reads ride ranged GETs, it comes back with
    the same sha256 (the twin of the JAX package's test)."""
    from seaweedfs_tpu_torch.server.filer import FilerServer
    from seaweedfs_tpu_torch.storage import backend as bk
    from seaweedfs_tpu_torch.storage import volume_tier
    from seaweedfs_tpu_torch.storage.needle import Needle
    from seaweedfs_tpu_torch.storage.volume import Volume
    from tests.test_torch_cluster import Cluster

    access, secret = "TIERKEY", "TIERSECRET"
    c = Cluster(tmp_path / "cluster", n_volume_servers=1)
    f = FilerServer(c.master.url, port=free_port_pair(),
                    meta_dir=str(tmp_path / "filer"))
    f.start()
    gw = PortS3(filer_url=f.url, port=free_port_pair(),
                iam=port_auth.Iam([port_auth.Identity(
                    "admin", [port_auth.Credential(access, secret)],
                    ["Admin"])]))
    gw.start()
    try:
        port_s3c.S3Client(gw.url, access, secret).create_bucket("tierbkt")
        bk.load_configuration({"s3.gw": {
            "endpoint": gw.url, "bucket": "tierbkt",
            "access_key": access, "secret_key": secret}})
        d = tmp_path / "vols"
        d.mkdir()
        v = Volume(str(d), "", 9, create_if_missing=True, async_write=False)
        for i in range(1, 11):
            v.write_needle(Needle(id=i, cookie=0x10 + i,
                                  data=b"payload-%d" % i))
        v.sync()
        with open(v.dat_path, "rb") as fh:
            want = hashlib.sha256(fh.read()).hexdigest()
        v.read_only = True
        assert volume_tier.move_dat_to_remote(v, "s3.gw") == v.content_size
        assert not os.path.exists(v.dat_path)
        assert v.read_needle(Needle(id=4, cookie=0x14)).data == b"payload-4"
        volume_tier.move_dat_from_remote(v)
        with open(v.dat_path, "rb") as fh:
            assert hashlib.sha256(fh.read()).hexdigest() == want
        assert v.read_needle(Needle(id=9, cookie=0x19)).data == b"payload-9"
        v.close()
        with pytest.raises(bk.BackendError, match="missing config"):
            bk.load_configuration({"s3.bad": {"bucket": "b"}})
    finally:
        bk.clear_backends()
        gw.stop()
        f.stop()
        c.stop()


# -- QoS: the s3 role sheds with 503 SlowDown ----------------------------------------


def test_s3_role_sheds_slow_down_like_jax():
    """An instrumented s3-role handler over its budget answers 503 with
    the SlowDown XML and Retry-After, as the JAX package's does."""
    import socketserver
    import threading

    from seaweedfs_tpu import qos as jax_qos
    from seaweedfs_tpu.qos.admission import QosConfig as JaxCfg
    from seaweedfs_tpu.qos import tenant as jax_tenant
    from seaweedfs_tpu.stats import metrics as jax_metrics
    from seaweedfs_tpu.util.http_server import FastHandler as JaxFast
    from seaweedfs_tpu_torch import qos as port_qos
    from seaweedfs_tpu_torch.qos.admission import QosConfig as PortCfg
    from seaweedfs_tpu_torch.qos import tenant as port_tenant
    from seaweedfs_tpu_torch.stats import metrics as port_metrics
    from seaweedfs_tpu_torch.util.http_server import FastHandler as PortFast

    replies = {}
    for name, fast, metrics, qmod, cfg, tmod in (
            ("jax", JaxFast, jax_metrics, jax_qos, JaxCfg, jax_tenant),
            ("port", PortFast, port_metrics, port_qos, PortCfg,
             port_tenant)):
        class H(fast):
            protocol_version = "HTTP/1.1"

            def log_message(self, *a):
                pass

            def do_GET(self):
                self.fast_reply(200, b"ok", None, ctype="text/plain")

        handler = metrics.instrument_http_handler(H, "s3")
        srv = socketserver.ThreadingTCPServer(("127.0.0.1", 0), handler)
        srv.daemon_threads = True
        threading.Thread(target=srv.serve_forever, daemon=True).start()
        try:
            qmod.configure(cfg(request_rate=1.0, request_burst=1.0))
            url = f"127.0.0.1:{srv.server_address[1]}"
            hs = {"X-Seaweed-Tenant": f"slow-{name}"}
            got = [raw_request(url, "GET", "/bucket/key", headers=hs)
                   for _ in range(2)]
            replies[name] = [(s, [(k, v) for k, v in h if k.lower() not in
                                  ("date", "server")], b) for s, h, b in got]
        finally:
            qmod.reset()
            tmod.current.set(None)
            srv.shutdown()
            srv.server_close()
    assert replies["port"] == replies["jax"]
    status, headers, body = replies["port"][1]
    assert status == 503 and dict(headers)["Retry-After"] == "1"
    assert b"<Code>SlowDown</Code>" in body
