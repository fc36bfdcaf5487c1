"""The port's client libraries against the JAX package's.

The port's counterparts of ``tests/test_chunked_file.py`` (16 tests),
``tests/test_wdclient.py`` (3), ``tests/test_lookup_cache.py`` (19, the
explorer interleavings included) and the lease-cache and delete fan-out
cases of ``tests/test_ingest_pipeline.py``. Each runs the same seeded
inputs through both packages and compares what comes out: manifest bytes
and ``load_chunk_manifest`` results (gzip included), the answers of a port
cluster and a JAX cluster to the same chunked upload (status, headers and
body of whole, ranged, suffix, unsatisfiable, ``cm=false`` and HEAD
reads, BatchDelete's refusal, the DELETE cascade), the ``.dat`` records of
one ``?cm=true`` upload to a port and a JAX volume server, a JAX-written
volume directory with a manifest served by a port server as a JAX server
serves it, the chunk reader's failover over fakes, the lookup cache's
and the lease cache's ledgers over the same fake masters. Also: the
MasterClient follows a new leader after a failover, a lease whose volume
turned read-only is dropped and its upload assigned again, the CLI's
``upload``/``download``/``delete`` and a small ``benchmark`` run as
subprocesses, and the lookup cache disabled makes no cache object and no
thread.
"""

import gzip
import http.client
import json
import os
import shutil
import subprocess
import sys
import threading
import time
import types
import urllib.error
import urllib.request
from dataclasses import asdict

import numpy as np
import pytest

from seaweedfs_tpu.command import benchmark as jax_bench
from seaweedfs_tpu.operation import assign_lease as jax_lease
from seaweedfs_tpu.operation import chunked_file as jax_cf
from seaweedfs_tpu.operation import operations as jax_ops
from seaweedfs_tpu.wdclient import lookup_cache as jax_lc
from seaweedfs_tpu.wdclient import vid_map as jax_vid_map
from seaweedfs_tpu_torch.command import benchmark as port_bench
from seaweedfs_tpu_torch.operation import assign_lease as port_lease
from seaweedfs_tpu_torch.operation import chunked_file as port_cf
from seaweedfs_tpu_torch.operation import operations as port_ops
from seaweedfs_tpu_torch.operation.file_id import format_fid, parse_fid
from seaweedfs_tpu_torch.pb import volume_server_pb2, volume_stub
from seaweedfs_tpu_torch.wdclient import lookup_cache as port_lc
from seaweedfs_tpu_torch.wdclient import vid_map as port_vid_map
from tests.test_torch_cluster import REPO, Cluster, free_port_pair, wait_for

PKGS = {
    "jax": types.SimpleNamespace(cf=jax_cf, ops=jax_ops, lc=jax_lc,
                                 lease=jax_lease, vid_map=jax_vid_map,
                                 bench=jax_bench),
    "port": types.SimpleNamespace(cf=port_cf, ops=port_ops, lc=port_lc,
                                  lease=port_lease, vid_map=port_vid_map,
                                  bench=port_bench),
}


def both(fn):
    """fn(pkg) for the JAX package and the port; the two results must be
    equal. Returns the port's."""
    want = fn(PKGS["jax"])
    got = fn(PKGS["port"])
    assert got == want
    return got


@pytest.fixture(autouse=True)
def _reset_lookup_caches():
    yield
    jax_lc.reset()
    port_lc.reset()


def _payload(n: int) -> bytes:
    return bytes(i * 31 % 256 for i in range(1024)) * (n // 1024 + 1)


# -- the manifest codec (tests/test_chunked_file.py:37-61) ----------------------


def _random_chunks(rng, n):
    offs = np.cumsum([0] + rng.integers(1, 1 << 22, n).tolist())
    return [(format_fid(int(rng.integers(1, 1000)),
                        int(rng.integers(1, 1 << 40)),
                        int(rng.integers(0, 1 << 32))),
             int(offs[i]), int(offs[i + 1] - offs[i])) for i in range(n)]


@pytest.mark.parametrize("seed", range(4))
def test_manifest_bytes_and_load_equal_jax(seed):
    """Random chunk lists (shuffled, names and mimes with non-ASCII):
    marshal gives the JAX package's bytes, and load_chunk_manifest of
    them, plain and gzipped, gives the same manifest in both."""
    rng = np.random.default_rng(seed)
    chunks = _random_chunks(rng, int(rng.integers(0, 40)))
    order = rng.permutation(len(chunks)).tolist()
    name = ["big.bin", "", "naïve \"q\".bin", "x/y"][seed]
    mime = ["application/x-thing", "", "text/plain; charset=utf-8",
            "image/png"][seed]

    def run(pkg):
        cm = pkg.cf.ChunkManifest(
            name=name, mime=mime, size=sum(c[2] for c in chunks),
            chunks=[pkg.cf.ChunkInfo(*chunks[i]) for i in order])
        raw = cm.marshal()
        loads = [asdict(pkg.cf.load_chunk_manifest(raw)),
                 asdict(pkg.cf.load_chunk_manifest(gzip.compress(raw),
                                                   is_compressed=True)),
                 # flagged compressed but stored raw: the raw bytes parse
                 asdict(pkg.cf.load_chunk_manifest(raw,
                                                   is_compressed=True))]
        return raw, loads

    raw, loads = both(run)
    assert loads[0] == loads[1] == loads[2]
    assert [c["offset"] for c in loads[0]["chunks"]] == \
        sorted(c[1] for c in chunks)


def test_manifest_roundtrip():
    def run(pkg):
        cm = pkg.cf.ChunkManifest(
            name="big.bin", mime="application/x-thing", size=300,
            chunks=[pkg.cf.ChunkInfo("3,0b1f2", 200, 100),
                    pkg.cf.ChunkInfo("1,0a2e1", 0, 200)])
        out = pkg.cf.load_chunk_manifest(cm.marshal())
        return out.name, out.size, [(c.fid, c.offset) for c in out.chunks]

    assert both(run) == ("big.bin", 300, [("1,0a2e1", 0), ("3,0b1f2", 200)])


def test_manifest_compressed():
    def run(pkg):
        cm = pkg.cf.ChunkManifest(size=5, chunks=[pkg.cf.ChunkInfo("1,ab",
                                                                   0, 5)])
        out = pkg.cf.load_chunk_manifest(gzip.compress(cm.marshal()),
                                         is_compressed=True)
        return out.size, out.chunks[0].fid

    assert both(run) == (5, "1,ab")


@pytest.mark.parametrize("raw", [b"this is not json", b"", b"[1, 2",
                                 b'{"chunks": [{"offset": 3}]}'])
def test_manifest_bad_input_raises_as_jax(raw):
    def run(pkg):
        try:
            pkg.cf.load_chunk_manifest(raw)
        except (ValueError, KeyError, TypeError) as e:
            return type(e).__name__
        return "parsed"

    assert both(run) != "parsed"


# -- chunked files over a port cluster and a JAX cluster -----------------------


@pytest.fixture(scope="module")
def clusters(tmp_path_factory):
    from tests.cluster_util import Cluster as JaxCluster
    jax = JaxCluster(tmp_path_factory.mktemp("jax_chunked"),
                     n_volume_servers=2)
    try:
        port = Cluster(tmp_path_factory.mktemp("port_chunked"),
                       n_volume_servers=2)
    except BaseException:
        jax.stop()
        raise
    out = {"jax": (jax, jax_ops), "port": (port, port_ops)}
    yield out
    port.stop()
    jax.stop()


def _request(method, url, data=None, headers=None):
    """(status, headers, body) of one HTTP request, errors included."""
    try:
        with urllib.request.urlopen(urllib.request.Request(
                f"http://{url}", data=data, method=method,
                headers=headers or {}), timeout=30) as r:
            return r.status, r.headers, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers, e.read()


COMPARED = ("Content-Type", "Content-Length", "Content-Range",
            "Content-Disposition", "Accept-Ranges", "X-File-Store")


def _answer(url, method="GET", headers=None):
    status, hdrs, body = _request(method, url, headers=headers)
    return status, {k: hdrs.get(k) for k in COMPARED}, body


def _holder(c, ops, fid):
    return wait_for(lambda: ops.lookup(c.master.url,
                                       parse_fid(fid).volume_id),
                    what=f"a location of {fid}")[0]


@pytest.fixture(scope="module")
def chunked(clusters):
    """The same 2.5 MiB file (3 chunks at max_mb=1) submitted to both
    clusters: {pkg: (cluster, ops, fid)} and the data."""
    data = _payload((5 << 20) // 2)
    out = {}
    for name, (c, ops) in clusters.items():
        fid = ops.submit(c.master.url, data, filename="big.bin",
                         mime="application/x-big", max_mb=1)
        out[name] = (c, ops, fid)
    return out, data


def _both_answers(chunked_fids, suffix="", method="GET", headers=None):
    answers = {}
    for name, (c, ops, fid) in chunked_fids.items():
        answers[name] = _answer(f"{_holder(c, ops, fid)}/{fid}{suffix}",
                                method, headers)
    assert answers["port"] == answers["jax"]
    return answers["port"]


def test_small_submit_stays_unchunked(clusters):
    for c, ops in clusters.values():
        fid = ops.submit(c.master.url, b"small", max_mb=1)
        status, hdrs, body = _answer(f"{_holder(c, ops, fid)}/{fid}")
        assert (status, body, hdrs["X-File-Store"]) == (200, b"small", None)


def test_chunked_get_streams_whole_file(chunked):
    fids, data = chunked
    status, hdrs, body = _both_answers(fids)
    assert (status, body) == (200, data)
    assert hdrs["X-File-Store"] == "chunked"
    assert hdrs["Content-Type"] == "application/x-big"
    assert hdrs["Content-Disposition"] == 'inline; filename="big.bin"'
    assert int(hdrs["Content-Length"]) == len(data)


@pytest.mark.parametrize("rng_header,lo,hi", [
    ("bytes=1047576-1049576", 1047576, 1049576),     # across chunks 1-2
    ("bytes=0-0", 0, 0),
    ("bytes=1048576-2097151", 1048576, 2097151),     # exactly chunk 2
    ("bytes=2097000-", 2097000, None),               # open-ended
    ("bytes=-1234", -1234, None),                    # suffix
    ("bytes=100-99999999", 100, None),               # end past the file
])
def test_chunked_get_ranges(chunked, rng_header, lo, hi):
    fids, data = chunked
    status, hdrs, body = _both_answers(fids, headers={"Range": rng_header})
    want = data[lo:] if hi is None else data[lo:hi + 1]
    assert (status, body) == (206, want)
    start = lo % len(data)
    assert hdrs["Content-Range"] == \
        f"bytes {start}-{start + len(want) - 1}/{len(data)}"


def test_range_416_carries_content_range(chunked):
    fids, data = chunked
    status, hdrs, body = _both_answers(
        fids, headers={"Range": f"bytes={len(data)}-"})
    assert status == 416
    assert hdrs["Content-Range"] == f"bytes */{len(data)}"


def test_cm_false_returns_raw_manifest(chunked):
    fids, data = chunked
    cms = {}
    for name, (c, ops, fid) in fids.items():
        status, hdrs, body = _answer(f"{_holder(c, ops, fid)}/{fid}"
                                     "?cm=false")
        assert status == 200 and hdrs["X-File-Store"] is None
        cm = PKGS[name].cf.load_chunk_manifest(body)
        cms[name] = (cm.name, cm.mime, cm.size,
                     [(ch.offset, ch.size) for ch in cm.chunks])
    assert cms["port"] == cms["jax"]
    assert cms["port"][2] == len(data) and len(cms["port"][3]) == 3
    assert sum(s for _, s in cms["port"][3]) == len(data)


def test_head_gives_the_size(chunked):
    fids, data = chunked
    status, hdrs, body = _both_answers(fids, method="HEAD")
    assert (status, body, int(hdrs["Content-Length"])) == \
        (200, b"", len(data))


def test_batch_delete_refuses_manifest(chunked):
    fids, data = chunked
    from seaweedfs_tpu.pb import volume_server_pb2 as jax_vs_pb2
    from seaweedfs_tpu.pb import volume_stub as jax_volume_stub
    got = {}
    for name, (c, ops, fid) in fids.items():
        stub, pb2 = (volume_stub, volume_server_pb2) if name == "port" \
            else (jax_volume_stub, jax_vs_pb2)
        resp = stub(_holder(c, ops, fid)).BatchDelete(
            pb2.BatchDeleteRequest(file_ids=[fid]))
        got[name] = (resp.results[0].status, resp.results[0].error)
        # nothing was deleted
        assert _answer(f"{_holder(c, ops, fid)}/{fid}")[2] == data
    assert got["port"] == got["jax"] == \
        (406, "ChunkManifest: not allowed in batch delete mode.")


def test_chunked_delete_cascades(clusters):
    data = _payload(3 << 20)[:3 << 20]
    outcomes = {}
    for name, (c, ops) in clusters.items():
        fid = ops.submit(c.master.url, data, max_mb=1)
        url = _holder(c, ops, fid)
        cm = PKGS[name].cf.load_chunk_manifest(
            _answer(f"{url}/{fid}?cm=false")[2])
        status, _, body = _answer(f"{url}/{fid}", method="DELETE")
        outcomes[name] = (status, json.loads(body),
                          [_answer(f"{_holder(c, ops, ch.fid)}/{ch.fid}")[0]
                           for ch in cm.chunks],
                          _answer(f"{url}/{fid}")[0])
    assert outcomes["port"] == outcomes["jax"]
    assert outcomes["port"] == (202, {"size": len(data)}, [404] * 3, 404)


def test_delete_with_a_failing_chunk_keeps_the_manifest(clusters):
    """A chunk that cannot be deleted (its volume is unknown) fails the
    DELETE with 500 and the manifest stays, so the delete can run again."""
    outcomes = {}
    for name, (c, ops) in clusters.items():
        good = ops.upload(c.master.url, b"chunk one")
        cm = PKGS[name].cf.ChunkManifest(size=19, chunks=[
            PKGS[name].cf.ChunkInfo(good, 0, 9),
            PKGS[name].cf.ChunkInfo("9999,0100000001", 9, 10)])
        a = ops.assign(c.master.url)
        ops.upload_data(f"{a.url}/{a.fid}", cm.marshal(),
                        is_chunk_manifest=True)
        status, _, body = _answer(f"{a.url}/{a.fid}", method="DELETE")
        outcomes[name] = (status, json.loads(body)["error"].split(":")[0],
                          _answer(f"{a.url}/{a.fid}?cm=false")[0])
    assert outcomes["port"] == outcomes["jax"] == (500, "delete chunks", 200)


def test_failed_submit_cleans_up_chunks(clusters, monkeypatch):
    """A chunk failing mid-submit deletes the chunks already written
    (reference submit.go's DeleteChunks on error)."""
    data = _payload(3 << 20)
    for name, (c, ops) in clusters.items():
        uploaded = []
        real_upload_data = ops.upload_data

        def flaky(url_fid, blob, **kw):
            if len(uploaded) == 2:
                raise RuntimeError("injected chunk failure")
            out = real_upload_data(url_fid, blob, **kw)
            uploaded.append(url_fid.split("/", 1)[1])
            return out

        monkeypatch.setattr(ops, "upload_data", flaky)
        with pytest.raises(RuntimeError, match="injected"):
            ops.submit(c.master.url, data, max_mb=1)
        monkeypatch.undo()
        assert len(uploaded) == 2
        for cfid in uploaded:
            assert _answer(f"{_holder(c, ops, cfid)}/{cfid}")[0] == 404


def test_missing_chunk_is_an_error_status(clusters):
    """A chunk that is gone: the port answers 500 with the reason before
    any byte of the body (the JAX server sends 200 and cuts the body
    short; ROADMAP Queue 3 keeps the difference)."""
    c, ops = clusters["port"]
    first = ops.upload(c.master.url, b"x" * 100)
    second = ops.upload(c.master.url, b"y" * 100)
    cm = port_cf.ChunkManifest(size=200, chunks=[
        port_cf.ChunkInfo(first, 0, 100), port_cf.ChunkInfo(second, 100, 100)])
    a = ops.assign(c.master.url)
    ops.upload_data(f"{a.url}/{a.fid}", cm.marshal(), is_chunk_manifest=True)
    assert _answer(f"{a.url}/{a.fid}")[2] == b"x" * 100 + b"y" * 100
    ops.delete_file(c.master.url, second)
    status, _, body = _answer(f"{a.url}/{a.fid}")
    assert status == 500 and b"404" in body, body
    jc, jops = clusters["jax"]
    jfirst = jops.upload(jc.master.url, b"x" * 100)
    jcm = jax_cf.ChunkManifest(size=200, chunks=[
        jax_cf.ChunkInfo(jfirst, 0, 100),
        jax_cf.ChunkInfo("9999,0100000001", 100, 100)])
    ja = jops.assign(jc.master.url)
    jops.upload_data(f"{ja.url}/{ja.fid}", jcm.marshal(),
                     is_chunk_manifest=True)
    with pytest.raises(http.client.IncompleteRead):
        _request("GET", f"{ja.url}/{ja.fid}")


def test_long_chunked_response_uses_chunked_framing(clusters, monkeypatch):
    """Past CHUNKED_BUFFER_BYTES the body streams with chunked framing: a
    whole read arrives intact, and a chunk that fails cuts the body off
    without its last chunk, so the client sees an error, never a short
    body under a Content-Length."""
    from seaweedfs_tpu_torch.server import volume as volume_mod
    monkeypatch.setattr(volume_mod, "CHUNKED_BUFFER_BYTES", 1000)
    c, ops = clusters["port"]
    data = _payload(3 << 20)
    fid = ops.submit(c.master.url, data, max_mb=1)
    url = _holder(c, ops, fid)
    r = port_ops.http_request("GET", f"{url}/{fid}")
    assert r.status == 200 and r.body == data
    assert r.headers.get("transfer-encoding") == "chunked"
    assert "content-length" not in r.headers
    status, hdrs, body = _answer(f"{url}/{fid}", method="HEAD")
    assert int(hdrs["Content-Length"]) == len(data) and body == b""
    cm = port_cf.load_chunk_manifest(_answer(f"{url}/{fid}?cm=false")[2])
    ops.delete_file(c.master.url, cm.chunks[-1].fid)
    with pytest.raises(http.client.IncompleteRead):
        _request("GET", f"{url}/{fid}")


# -- the chunk reader's locations (tests/test_chunked_file.py:170-251) ---------


def _reader_with_fakes(pkg, monkeypatch, locations, bodies, fail_urls=()):
    """Fake master lookups and GETs for pkg's ChunkedFileReader;
    ``locations`` and ``fail_urls`` are mutable, so a test moves volumes
    mid-stream."""
    lookups = []

    def fake_lookup(master_url, vid, collection=""):
        lookups.append(vid)
        return list(locations.get(vid, []))

    def fake_request(method, url, headers=None, timeout=None, **kw):
        netloc, _, fid = url.partition("/")
        if netloc in fail_urls:
            raise ConnectionRefusedError(f"dead {netloc}")
        data = bodies[fid]
        status = 200
        if headers and "Range" in headers:
            lo, hi = headers["Range"][len("bytes="):].split("-")
            data = data[int(lo):int(hi) + 1]
            status = 206
        return pkg.cf.http_client.Response(status, {}, data)

    monkeypatch.setattr(pkg.ops, "lookup", fake_lookup)
    monkeypatch.setattr(pkg.cf.http_client, "request", fake_request)
    return lookups


def test_reader_survives_volume_moving_servers_midstream(monkeypatch):
    """Server A dies and the volume moves to B between two chunks: the
    reader forgets the location, asks the master again, and finishes."""
    def run(pkg):
        locations = {7: ["a:8080"]}
        fail_urls = set()
        bodies = {"7,0100000001": b"x" * 100, "7,0200000002": b"y" * 100}
        lookups = _reader_with_fakes(pkg, monkeypatch, locations, bodies,
                                     fail_urls)
        r = pkg.cf.ChunkedFileReader(
            [pkg.cf.ChunkInfo("7,0100000001", 0, 100),
             pkg.cf.ChunkInfo("7,0200000002", 100, 100)], "m:9333")
        it = r.stream()
        first = next(it)
        fail_urls.add("a:8080")
        locations[7] = ["b:8080"]
        return first, next(it), list(lookups)

    assert both(run) == (b"x" * 100, b"y" * 100, [7, 7])


def test_reader_fails_over_across_replicas_without_master(monkeypatch):
    def run(pkg):
        lookups = _reader_with_fakes(
            pkg, monkeypatch, {7: ["a:8080", "b:8080"]},
            {"7,0100000001": b"z" * 50}, fail_urls={"a:8080"})
        r = pkg.cf.ChunkedFileReader(
            [pkg.cf.ChunkInfo("7,0100000001", 0, 50)], "m:9333")
        return r.read_all(), list(lookups)

    assert both(run) == (b"z" * 50, [7])


def test_reader_raises_when_all_locations_stay_dead(monkeypatch):
    def run(pkg):
        lookups = _reader_with_fakes(pkg, monkeypatch, {7: ["a:8080"]},
                                     {"7,0100000001": b""},
                                     fail_urls={"a:8080"})
        r = pkg.cf.ChunkedFileReader(
            [pkg.cf.ChunkInfo("7,0100000001", 0, 10)], "m:9333")
        with pytest.raises(ConnectionRefusedError) as ei:
            r.read_all()
        return str(ei.value), list(lookups)

    assert both(run) == ("dead a:8080", [7, 7])


@pytest.mark.parametrize("status", [404, 416])
def test_reader_never_retries_a_definitive_answer(monkeypatch, status):
    def run(pkg):
        lookups = []
        monkeypatch.setattr(pkg.ops, "lookup",
                            lambda m, vid, collection="":
                            lookups.append(vid) or ["a:1", "b:1"])
        calls = []
        monkeypatch.setattr(
            pkg.cf.http_client, "request",
            lambda method, url, **kw: calls.append(url) or
            pkg.cf.http_client.Response(status, {}, b""))
        r = pkg.cf.ChunkedFileReader(
            [pkg.cf.ChunkInfo("7,0100000001", 0, 10)], "m:9333")
        with pytest.raises(RuntimeError) as ei:
            r.read_all()
        return str(ei.value), lookups, calls

    assert both(run) == (f"chunk 7,0100000001: http {status}", [7],
                         ["a:1/7,0100000001"])


def test_reader_re_asks_past_a_redirect(monkeypatch):
    """A chunk whose volume left its server (ec.encode moved it): the old
    holder answers 302. The JAX reader takes that as the needle's answer
    and fails; the port's drops the location, and the lookup cache's
    answer, asks the master again and reads from the new holder (ROADMAP
    Queue 3)."""
    def run(pkg):
        pkg.lc.configure(enable=True, ttl_s=30.0, coalesce_ms=0.0)
        answers = [["a:1"], ["b:1"]]
        fetches = []

        def fetch_many(master_url, vids, collection=""):
            fetches.append(list(vids))
            urls = answers[min(len(fetches), 2) - 1]
            return {v: pkg.lc.LookupResult(tuple(
                pkg.vid_map.Location(u, u) for u in urls), "")
                for v in vids}

        monkeypatch.setattr(pkg.lc, "http_fetch_many", fetch_many)
        monkeypatch.setattr(
            pkg.cf.http_client, "request",
            lambda method, url, **kw: pkg.cf.http_client.Response(
                *((302, {"location": "http://b:1/7,0100000001"}, b"")
                  if url.startswith("a:1/") else (200, {}, b"k" * 10))))
        r = pkg.cf.ChunkedFileReader(
            [pkg.cf.ChunkInfo("7,0100000001", 0, 10)], "m:1")
        try:
            out = r.read_all()
        except RuntimeError as e:
            out = str(e)
        pkg.lc.reset()
        return out, fetches

    jax_out = run(PKGS["jax"])
    port_out = run(PKGS["port"])
    assert jax_out == ("chunk 7,0100000001: http 302", [[7]])
    assert port_out == (b"k" * 10, [[7], [7]])


def test_reader_short_read_raises(monkeypatch):
    def run(pkg):
        _reader_with_fakes(pkg, monkeypatch, {7: ["a:8080"]},
                           {"7,0100000001": b"q" * 60})
        r = pkg.cf.ChunkedFileReader(
            [pkg.cf.ChunkInfo("7,0100000001", 0, 100)], "m:9333")
        with pytest.raises(RuntimeError) as ei:
            r.read_all()
        return str(ei.value)

    assert both(run) == "chunk 7,0100000001: short read 60 != 100"


def test_reader_ranges_over_random_chunkings(monkeypatch):
    """Seeded chunk sizes and (offset, length) windows: every window
    streams the same bytes from both packages, and they are the slice."""
    rng = np.random.default_rng(5)
    sizes = rng.integers(1, 5000, 12).tolist()
    data = rng.bytes(sum(sizes))
    offs = np.cumsum([0] + sizes).tolist()
    chunks = [(format_fid(3, i + 1, 0xaa), offs[i], s)
              for i, s in enumerate(sizes)]
    bodies = {fid: data[o:o + s] for fid, o, s in chunks}
    windows = [(int(a), int(b)) for a, b in
               zip(rng.integers(0, len(data), 40),
                   rng.integers(0, 9000, 40))]

    def run(pkg):
        _reader_with_fakes(pkg, monkeypatch, {3: ["a:1"]}, bodies)
        r = pkg.cf.ChunkedFileReader(
            [pkg.cf.ChunkInfo(*c) for c in reversed(chunks)], "m:1")
        return [b"".join(r.stream(o, min(n, len(data) - o)))
                for o, n in windows]

    got = both(run)
    assert got == [data[o:o + n] for o, n in windows]


# -- one ?cm=true upload, byte for byte ----------------------------------------


def test_manifest_upload_dat_equals_jax(tmp_path, monkeypatch):
    """The same chunk needle and ?cm=true manifest POSTed to a port and a
    JAX volume server (append times from one counter): the .dat files are
    equal byte for byte, and the manifest's flags byte is 0x84."""
    from tests.test_torch_cluster import _jax_volume_server
    from seaweedfs_tpu_torch.server.volume import VolumeServer
    state = {"ns": 0}

    def fake_ns():
        state["ns"] += 1000
        return 1_700_000_000_000_000_000 + state["ns"]

    monkeypatch.setattr(time, "time_ns", fake_ns)
    manifest = port_cf.ChunkManifest(
        name="m.bin", mime="application/x-m", size=5,
        chunks=[port_cf.ChunkInfo("1,01000000aa", 0, 5)]).marshal()
    dats = {}
    for name in ("jax", "port"):
        d = tmp_path / name
        d.mkdir()
        if name == "jax":
            vs = _jax_volume_server(d, free_port_pair())
        else:
            vs = VolumeServer("127.0.0.1:1", [str(d)], port=free_port_pair(),
                              pulse_seconds=60.0, ec_encoder="cpu")
            vs.start()
            vs.store.add_volume(1)
        try:
            state["ns"] = 0
            assert _request("POST", f"{vs.url}/1,01000000aa", b"hello")[0] \
                == 201
            assert _request("POST", f"{vs.url}/1,02000000bb?cm=true",
                            manifest,
                            {"Content-Type": "application/json"})[0] == 201
            vs.store.find_volume(1).sync()
        finally:
            vs.stop()
        dats[name] = (d / "1.dat").read_bytes()
    assert dats["port"] == dats["jax"]
    # a record is header (16), data size (4), data, then the flags byte:
    # a mime (0x04) and a chunk manifest (0x80)
    assert dats["port"][dats["port"].index(manifest) + len(manifest)] \
        == 0x84


# -- a JAX-written directory served by the port --------------------------------


def _jax_written_dir(tmp_path) -> tuple:
    """A volume directory the JAX volume server wrote: volume 1 with three
    chunks and a manifest listing them. Returns (dir, manifest fid,
    data)."""
    from tests.test_torch_cluster import _jax_volume_server
    d = tmp_path / "jaxdir"
    d.mkdir()
    data = np.random.default_rng(11).bytes(250_000)
    vs = _jax_volume_server(d, free_port_pair())
    try:
        chunks = []
        for i, off in enumerate(range(0, len(data), 100_000)):
            fid = format_fid(1, i + 1, 0x1000 + i)
            piece = data[off:off + 100_000]
            assert _request("POST", f"{vs.url}/{fid}", piece)[0] == 201
            chunks.append(jax_cf.ChunkInfo(fid, off, len(piece)))
        cm = jax_cf.ChunkManifest(name="jax.bin", mime="application/x-j",
                                  size=len(data), chunks=chunks)
        mfid = format_fid(1, 9, 0x9999)
        jax_ops.upload_data(f"{vs.url}/{mfid}", cm.marshal(),
                            filename="jax.bin", mime="application/json",
                            is_chunk_manifest=True)
        vs.store.find_volume(1).sync()
    finally:
        vs.stop()
    return d, mfid, data, [c.fid for c in chunks]


def test_port_serves_a_jax_written_manifest_as_jax(tmp_path):
    """A JAX master and volume server over one copy of the directory, a
    port master and volume server over another: every read of the
    manifest (whole, ranged, HEAD, cm=false, 416) and its DELETE cascade
    answer alike, and the chunks are gone on both after it."""
    from seaweedfs_tpu.server.master import MasterServer as JaxMaster
    from seaweedfs_tpu.server.volume import VolumeServer as JaxVolume
    from seaweedfs_tpu_torch.server.master import MasterServer
    from seaweedfs_tpu_torch.server.volume import VolumeServer
    d, mfid, data, chunk_fids = _jax_written_dir(tmp_path)
    servers = {}
    try:
        for name, mcls, vcls, enc in (("jax", JaxMaster, JaxVolume, "numpy"),
                                      ("port", MasterServer, VolumeServer,
                                       "cpu")):
            vd = tmp_path / f"{name}_vol"
            shutil.copytree(d, vd)
            m = mcls(port=free_port_pair(), meta_dir=str(tmp_path / name),
                     pulse_seconds=0.2)
            m.start()
            vs = vcls(m.url, [str(vd)], port=free_port_pair(),
                      pulse_seconds=0.2, ec_encoder=enc)
            vs.start()
            servers[name] = (m, vs)
            wait_for(lambda: m.lookup_locations(1) if name == "port"
                     else m.topo.lookup(1), what=f"{name} volume 1")
        reads = [("GET", None, ""), ("GET", {"Range": "bytes=99990-100010"},
                                     ""),
                 ("GET", {"Range": "bytes=-7"}, ""),
                 ("GET", {"Range": f"bytes={len(data)}-"}, ""),
                 ("HEAD", None, ""), ("GET", None, "?cm=false")]
        for method, headers, suffix in reads:
            got = {name: _answer(f"{vs.url}/{mfid}{suffix}", method, headers)
                   for name, (_, vs) in servers.items()}
            assert got["port"] == got["jax"], (method, headers, suffix)
        assert got["port"][0] == 200
        whole = _answer(f"{servers['port'][1].url}/{mfid}")
        assert whole[2] == data and whole[1]["X-File-Store"] == "chunked"
        deleted = {}
        for name, (_, vs) in servers.items():
            status, _, body = _answer(f"{vs.url}/{mfid}", method="DELETE")
            deleted[name] = (status, json.loads(body),
                             [_answer(f"{vs.url}/{f}")[0]
                              for f in chunk_fids + [mfid]])
        assert deleted["port"] == deleted["jax"] == \
            (202, {"size": len(data)}, [404] * 4)
    finally:
        for m, vs in servers.values():
            vs.stop()
            m.stop()


# -- wdclient (tests/test_wdclient.py) -----------------------------------------


def test_vid_map_basics():
    def run(pkg):
        Location = pkg.vid_map.Location
        m = pkg.vid_map.VidMap()
        m.add_location(3, Location("a:1", "a:1"))
        m.add_location(3, Location("b:1", "b:1"))
        m.add_location(3, Location("a:1", "a:1"))  # dedupe
        out = [len(m.lookup(3)), len(m),
               m.lookup_file_id("3,017b2c8f12").startswith(("a:1/", "b:1/"))]
        m.delete_location(3, "a:1")
        out.append([l.url for l in m.lookup(3)])
        m.drop_node("b:1")
        out.append(m.lookup(3))
        with pytest.raises(KeyError):
            m.lookup_file_id("3,017b2c8f12")
        return out

    assert both(run) == [2, 1, True, ["b:1"], []]


@pytest.fixture(scope="module")
def port_cluster(tmp_path_factory):
    c = Cluster(tmp_path_factory.mktemp("wdclient"), n_volume_servers=2)
    vs = c.volume_servers[0]
    for vid in (71, 72):
        vs.store.add_volume(vid)
    wait_for(lambda: all(c.master.lookup_locations(v) for v in (71, 72)),
             what="volumes 71 and 72 registered")
    yield c
    c.stop()


def test_master_client_tracks_new_volumes(port_cluster):
    from seaweedfs_tpu_torch.wdclient import MasterClient
    c = port_cluster
    mc = MasterClient([c.master.url], "test-wd").start()
    try:
        mc.wait_until_connected()
        fid = port_ops.upload(c.master.url, b"wd-payload", collection="wd")
        vid = parse_fid(fid).volume_id
        wait_for(lambda: mc.vid_map.lookup(vid),
                 what="the delta reaching the client's map")
        assert _request("GET", mc.lookup_file_id(fid))[2] == b"wd-payload"
    finally:
        mc.stop()


def test_operations_roundtrip(port_cluster):
    c = port_cluster
    fid = port_ops.upload(c.master.url, b"op-data", filename="op.bin",
                          mime="application/x-op")
    assert port_ops.download(c.master.url, fid) == b"op-data"
    results = port_ops.delete_files(c.master.url, [fid])
    assert [(r["fid"], r["status"]) for r in results] == [(fid, 202)]
    with pytest.raises(RuntimeError, match="404"):
        port_ops.download(c.master.url, fid)


def test_assign_over_rpc_and_http_agree_as_jax(clusters):
    """assign_grpc (the master's RPC Assign) and assign (/dir/assign)
    hand out the same kind of Assignment in both packages: count
    granted, the fid on a server the master knows, keys growing."""
    shapes = {}
    for name, (c, ops) in clusters.items():
        a = ops.assign_grpc(c.master.url, count=3, collection="g")
        b = ops.assign(c.master.url, count=2, collection="g")
        urls = {vs.url for vs in c.volume_servers}
        fa, fb = parse_fid(a.fid), parse_fid(b.fid)
        shapes[name] = (a.count, b.count, a.url in urls, b.url in urls,
                        fb.key > fa.key)
    assert shapes["port"] == shapes["jax"] == (3, 2, True, True, True)


def test_master_client_follows_a_new_leader(tmp_path):
    """Three masters: the client names the leader, answers lookups, and
    after the leader stops names the new one and answers again."""
    from tests.test_torch_raft import _leader_of, _start_masters, \
        _volume_server
    from seaweedfs_tpu_torch.wdclient import MasterClient
    masters, urls = _start_masters(tmp_path)
    vs = None
    mc = None
    try:
        leader = wait_for(lambda: _leader_of(masters), 20, "a leader")
        vs = _volume_server(tmp_path, urls)
        vs.store.add_volume(5)
        wait_for(lambda: leader.lookup_locations(5), 20, "volume 5")
        follower = next(u for u in urls if u != leader.url)
        mc = MasterClient([follower] + [u for u in urls if u != follower],
                          "failover").start()
        mc.wait_until_connected()
        wait_for(lambda: mc.current_master == leader.url, 20,
                 "the client at the leader")
        assert [l.url for l in mc.lookup(5)] == [vs.url]
        leader.stop()
        survivors = [m for m in masters if m is not leader]
        new = wait_for(lambda: _leader_of(survivors), 20, "a new leader")
        wait_for(lambda: mc.current_master == new.url, 20,
                 "the client at the new leader")
        wait_for(lambda: new.lookup_locations(5), 20,
                 "volume 5 at the new leader")
        mc.vid_map.drop_node(vs.url)
        assert wait_for(lambda: [l.url for l in mc.lookup(5)], 20,
                        "a lookup through the new leader") == [vs.url]
        assert mc.reconnects >= 1
    finally:
        if mc is not None:
            mc.stop()
        if vs is not None:
            vs.stop()
        for m in masters:
            m.stop()


# -- the lookup cache (tests/test_lookup_cache.py) -----------------------------


def _fetcher(pkg, log, missing=(), fail=False, gate=None):
    def fetch(vids):
        log.append(list(vids))
        if gate is not None:
            gate.wait(2.0)
        if fail:
            raise OSError("master unreachable")
        out = {}
        for v in vids:
            if v in missing:
                out[v] = pkg.lc.LookupResult((), f"volume {v} not found")
            else:
                out[v] = pkg.lc.LookupResult(
                    (pkg.vid_map.Location(f"u{v}", f"p{v}"),), "")
        return out
    return fetch


def test_batch_hit_negative_and_invalidate():
    def run(pkg):
        calls = []
        c = pkg.lc.CoalescingLookupCache(
            _fetcher(pkg, calls, missing={9}), coalesce_s=0)
        res = c.lookup_many([1, 2, 9, 2, 1])
        out = [list(map(list, calls)), res[1].locations[0].url,
               res[9].error, c.lookup(1).locations[0].url,
               c.lookup(9).error, c.stats()]
        out += [c.invalidate(1), c.invalidate(1)]
        c.lookup(1)
        out += [list(map(list, calls)), bool(c.lookup(2).locations),
                len(calls), c.stats()]
        return out

    got = both(run)
    assert got[0] == [[1, 2, 9]] and got[5]["hits"] == 1
    assert got[5]["negative_hits"] == 1 and got[6:8] == [True, False]
    assert got[8] == [[1, 2, 9], [1]] and got[10] == 2


def test_ttl_expiry_positive_and_negative():
    def run(pkg):
        calls = []
        c = pkg.lc.CoalescingLookupCache(
            _fetcher(pkg, calls, missing={9}), ttl_s=30.0,
            negative_ttl_s=0.05, coalesce_s=0)
        c.lookup_many([1, 9])
        time.sleep(0.08)
        out = [bool(c.lookup(9).error), list(map(list, calls))]
        out += [bool(c.lookup(1).locations), len(calls)]
        return out

    assert both(run) == [True, [[1, 9], [9]], True, 2]


def test_batch_max_splits_round_trips():
    def run(pkg):
        calls = []
        c = pkg.lc.CoalescingLookupCache(_fetcher(pkg, calls), coalesce_s=0,
                                         batch_max=4)
        res = c.lookup_many(range(10))
        return len(res), all(r.locations for r in res.values()), \
            [len(b) for b in calls]

    assert both(run) == (10, True, [4, 4, 2])


def test_transport_failure_answers_waiters_and_caches_nothing():
    def run(pkg):
        calls = []
        fail = {"on": True}

        def fetch(vids):
            calls.append(list(vids))
            if fail["on"]:
                raise OSError("blip")
            return {v: pkg.lc.LookupResult(
                (pkg.vid_map.Location("u", "u"),), "") for v in vids}

        c = pkg.lc.CoalescingLookupCache(fetch, coalesce_s=0)
        res = c.lookup(5)
        fail["on"] = False
        return res.error, bool(c.lookup(5).locations), len(calls), \
            c.stats()["entries"]

    assert both(run) == ("lookup failed: OSError('blip')", True, 2, 1)


def test_fetch_missing_vid_is_not_found_not_keyerror():
    assert both(lambda pkg: pkg.lc.CoalescingLookupCache(
        lambda vids: {}, coalesce_s=0).lookup(3).error) == \
        "volume 3 not found"


def test_http_fetch_many_never_negative_caches_master_errors(monkeypatch):
    """A 503 (an election), a top-level {"error": ...} body, or a legacy
    single-vid answer to a multi-vid batch carry no per-vid answers: they
    raise and nothing is cached."""
    class _R:
        def __init__(self, status, body):
            self.status = status
            self.body = json.dumps(body).encode()

    def run(pkg):
        http_client = sys.modules[pkg.lc.__name__.replace(
            "wdclient.lookup_cache", "util.http_client")]
        replies = []
        monkeypatch.setattr(http_client, "request",
                            lambda *a, **k: replies.pop(0))
        out = []
        for body, status in (({"error": "no raft leader elected yet"}, 503),
                             ({"error": "something else broke"}, 200),
                             ({"volumeId": "1", "locations":
                               [{"url": "u", "publicUrl": "p"}]}, 200)):
            replies.append(_R(status, body))
            with pytest.raises(IOError) as ei:
                pkg.lc.http_fetch_many("m:1", [1, 2])
            out.append(str(ei.value))
        replies.append(_R(200, {"volumeId": "1", "locations":
                                [{"url": "u", "publicUrl": "p"}]}))
        out.append(pkg.lc.http_fetch_many("m:1", [1])[1].locations[0].url)
        replies.append(_R(503, {"error": "no raft leader elected yet"}))
        replies.append(_R(200, {"volumeIdLocations": [
            {"volumeId": "5", "locations": [{"url": "u5"}]}]}))
        c = pkg.lc.CoalescingLookupCache(
            lambda vids: pkg.lc.http_fetch_many("m:1", vids), coalesce_s=0)
        out.append("503" in c.lookup(5).error)
        out.append(c.lookup(5).locations[0].url)
        return out

    got = both(run)
    assert got[3:] == ["u", True, "u5"]


def test_single_flight_one_rpc_many_waiters():
    def run(pkg):
        calls = []
        gate = threading.Event()
        c = pkg.lc.CoalescingLookupCache(_fetcher(pkg, calls, gate=gate),
                                         coalesce_s=0.05)
        out = []
        ts = [threading.Thread(target=lambda: out.append(c.lookup(7)))
              for _ in range(6)]
        for t in ts:
            t.start()
        wait_for(lambda: calls, what="the leader's fetch")
        gate.set()
        for t in ts:
            t.join(5)
        return len(calls), len(out), all(r.locations for r in out)

    assert both(run) == (1, 6, True)


def test_coalescing_window_fuses_distinct_vids():
    def run(pkg):
        calls = []
        gate = threading.Event()
        parked = threading.Event()

        def fetch(vids):
            calls.append(list(vids))
            if 99 in vids:
                parked.set()
                gate.wait(2.0)
            return {v: pkg.lc.LookupResult(
                (pkg.vid_map.Location(f"u{v}", f"p{v}"),), "") for v in vids}

        c = pkg.lc.CoalescingLookupCache(fetch, coalesce_s=0.2)
        t99 = threading.Thread(target=lambda: c.lookup(99))
        t99.start()
        assert parked.wait(2.0)
        done = threading.Barrier(3)

        def one(vid):
            done.wait(2.0)
            c.lookup(vid)

        ts = [threading.Thread(target=one, args=(v,)) for v in (1, 2)]
        for t in ts:
            t.start()
        done.wait(2.0)
        for t in ts:
            t.join(5)
        gate.set()
        t99.join(5)
        return sorted(v for b in calls if 99 not in b for v in b), len(calls)

    assert both(run) == ([1, 2], 2)


def test_lone_caller_skips_coalesce_window():
    def run(pkg):
        calls = []
        c = pkg.lc.CoalescingLookupCache(_fetcher(pkg, calls),
                                         coalesce_s=5.0)
        t0 = time.monotonic()
        for vid in (1, 2, 3):
            assert c.lookup(vid).locations
        assert c.lookup_many([4, 5, 6])[5].locations
        return time.monotonic() - t0 < 2.0, [sorted(b) for b in calls]

    assert both(run) == (True, [[1], [2], [3], [4, 5, 6]])


def test_env_sibling_tunables_tolerate_garbage(monkeypatch):
    monkeypatch.setenv("SEAWEED_META_LOOKUP_TTL_S", "30")
    monkeypatch.setenv("SEAWEED_META_NEGATIVE_TTL_S", "oops")
    monkeypatch.setenv("SEAWEED_META_COALESCE_MS", "2ms")
    monkeypatch.setenv("SEAWEED_META_BATCH_MAX", "64.5")

    def run(pkg):
        pkg.lc._env_configure()
        return (pkg.lc.enabled, pkg.lc._ttl_s, pkg.lc._negative_ttl_s,
                pkg.lc._coalesce_s, pkg.lc._batch_max)

    assert both(run) == (True, 30.0, port_lc.DEFAULT_NEGATIVE_TTL_S,
                         port_lc.DEFAULT_COALESCE_MS / 1000.0,
                         port_lc.DEFAULT_BATCH_MAX)


def test_module_seam_configure_reset_and_for_master():
    def run(pkg):
        lc = pkg.lc
        out = [lc.enabled]
        lc.configure(enable=True, ttl_s=10.0)
        a = lc.for_master("127.0.0.1:1")
        out += [lc.enabled, lc.for_master("127.0.0.1:1") is a,
                lc.for_master("127.0.0.1:1", "col") is a]
        lc.configure(enable=True, ttl_s=0)
        out.append(lc.enabled)
        lc.reset()
        out.append(lc.enabled)
        lc.configure(ttl_s=lc.DEFAULT_TTL_S)
        lc.reset()
        return out

    assert both(run) == [False, True, True, False, False, False]


def test_module_invalidate_spans_collections():
    def run(pkg):
        pkg.lc.configure(enable=True, ttl_s=10.0)
        calls = []
        for coll in ("", "col"):
            c = pkg.lc.for_master("m:1", coll)
            c._fetch_many = _fetcher(pkg, calls)
            c.lookup(4)
        n = len(calls)
        pkg.lc.invalidate("m:1", 4)
        for coll in ("", "col"):
            pkg.lc.for_master("m:1", coll).lookup(4)
        pkg.lc.reset()
        return n, len(calls)

    assert both(run) == (2, 4)


def test_explorer_single_flight_and_coalesce_interleavings():
    """The single-flight and coalesce handoff of the port's cache under
    the JAX package's seeded interleavings: whatever the schedule, every
    caller gets a correct answer, no vid is fetched after it is cached,
    and flights never leak."""
    from seaweedfs_tpu.util.scheduler import explore

    def scenario():
        calls = []
        c = port_lc.CoalescingLookupCache(
            _fetcher(PKGS["port"], calls, missing={3}), coalesce_s=0.01)
        results = {}
        res_lock = threading.Lock()

        def reader(name, vids):
            got = c.lookup_many(vids)
            with res_lock:
                results[name] = got

        ts = [threading.Thread(target=reader, args=("a", [1, 2])),
              threading.Thread(target=reader, args=("b", [2, 3])),
              threading.Thread(target=reader, args=("c", [1, 3]))]
        for t in ts:
            t.start()
        for t in ts:
            t.join()
        assert results["a"][1].locations[0].url == "u1"
        assert results["a"][2].locations and results["b"][2].locations
        assert results["b"][3].error and results["c"][3].error
        fetched = [v for b in calls for v in b]
        assert sorted(set(fetched)) == sorted(fetched), \
            f"vid fetched twice: {calls}"
        assert not c._flights, "flights must drain"

    res = explore(scenario, schedules=20, seed=0)
    assert res.ok and res.schedules == 20


def test_http_batched_lookup_and_legacy_parity(port_cluster, clusters):
    """The port master's batched and legacy /dir/lookup answer in the JAX
    master's shapes (volume ids, error entries, key sets)."""
    c = port_cluster
    with c.http(f"{c.master.url}/dir/lookup"
                "?volumeIds=71,72,9999,junk") as r:
        out = json.load(r)
    by_vid = {e["volumeId"]: e for e in out["volumeIdLocations"]}
    assert by_vid["71"]["locations"] and by_vid["72"]["locations"]
    assert "error" in by_vid["9999"] and "error" in by_vid["junk"]
    with c.http(f"{c.master.url}/dir/lookup?volumeId=71") as r:
        legacy = json.load(r)
    assert legacy["volumeId"] == "71" and legacy["locations"]
    assert "volumeIdLocations" not in legacy
    assert by_vid["71"]["locations"] == legacy["locations"]
    jc = clusters["jax"][0]
    with jc.http(f"{jc.master.url}/dir/lookup?volumeIds=9999,junk") as r:
        jax_out = json.load(r)
    with c.http(f"{c.master.url}/dir/lookup?volumeIds=9999,junk") as r:
        port_out = json.load(r)
    assert port_out == jax_out


def test_grpc_lookup_many_vids_per_entry_errors(port_cluster):
    from seaweedfs_tpu_torch.pb import master_pb2, master_stub
    resp = master_stub(port_cluster.master.url).LookupVolume(
        master_pb2.LookupVolumeRequest(volume_ids=["71", "9999", "72"]))
    got = {vl.volume_id: vl for vl in resp.volume_id_locations}
    assert got["71"].locations and got["72"].locations
    assert got["9999"].error and not got["9999"].locations


def test_operations_lookup_many_one_round_trip(port_cluster):
    murl = port_cluster.master.url
    plain = port_ops.lookup_many(murl, [71, 72, 9999])
    assert plain[71] and plain[72] and plain[9999] == []
    assert not port_lc._caches
    port_lc.configure(enable=True, ttl_s=10.0, coalesce_ms=0.0)
    batched = port_ops.lookup_many(murl, [71, 72, 9999])
    assert batched == plain
    cache = port_lc.for_master(murl)
    st = cache.stats()
    assert st["misses"] == 3 and st["entries"] == 3
    assert port_ops.lookup_many(murl, [71, 72, 9999]) == plain
    st = cache.stats()
    assert st["hits"] == 2 and st["negative_hits"] == 1
    with pytest.raises(RuntimeError):
        port_ops.lookup(murl, 9999)
    assert cache.stats()["negative_hits"] == 2
    port_lc.invalidate(murl, 71)
    assert cache.stats()["entries"] == 2


def test_shell_env_lookup_through_cache(port_cluster):
    from seaweedfs_tpu_torch.shell.command_env import CommandEnv
    murl = port_cluster.master.url
    env = CommandEnv(murl)
    plain = env.lookup(71)
    assert plain and env.lookup(9999) == []
    port_lc.configure(enable=True, ttl_s=10.0, coalesce_ms=0.0)
    assert env.lookup(71) == plain
    assert env.lookup(9999) == []
    assert port_lc.for_master(murl).stats()["misses"] == 2
    env.lookup(71)
    assert port_lc.for_master(murl).stats()["hits"] == 1


def test_masterclient_lookup_many_batches_misses(port_cluster):
    from seaweedfs_tpu_torch.wdclient.masterclient import MasterClient
    port_lc.configure(enable=True, ttl_s=10.0, coalesce_ms=0.0)
    mc = MasterClient([port_cluster.master.url], client_name="test")
    assert mc.lookup_cache_enabled
    got = mc.lookup_many([71, 72, 9999])
    assert got[71] and got[72] and got[9999] == []
    assert mc._lookup_cache.stats()["misses"] == 3
    assert mc.lookup(71) == got[71]
    mc.invalidate_lookup(71)
    assert mc._lookup_cache.stats()["entries"] == 2


def test_masterclient_disabled_is_cacheless(port_cluster):
    from seaweedfs_tpu_torch.wdclient.masterclient import MasterClient
    mc = MasterClient([port_cluster.master.url], client_name="test2")
    assert not mc.lookup_cache_enabled and mc._lookup_cache is None
    got = mc.lookup_many([71, 9999])
    assert got[71] and got[9999] == []
    assert not port_lc._caches


def test_lookup_cache_disabled_costs_nothing():
    """The port's counterpart of test_perf_gates.py::
    test_meta_disabled_overhead: disabled, no cache exists, a MasterClient
    carries none, the disabled lookup_many is a loop over lookup(), and
    nothing of it (nor a LeaseCache, nor a cache built by hand) starts a
    thread."""
    from seaweedfs_tpu_torch.wdclient.masterclient import MasterClient
    if os.environ.get("SEAWEED_META_LOOKUP_TTL_S"):
        pytest.skip("the suite runs with the lookup cache armed on request")
    assert not port_lc.enabled and not port_lc._caches
    before = {t.ident for t in threading.enumerate()}
    mc = MasterClient(["127.0.0.1:1"], client_name="gate")
    assert mc._lookup_cache is None and not mc.lookup_cache_enabled
    port_lc.CoalescingLookupCache(lambda vids: {}, coalesce_s=0)
    port_lease.LeaseCache(count=8)
    calls = []
    orig = port_ops.lookup
    try:
        port_ops.lookup = lambda m, vid, collection="": \
            calls.append(vid) or [f"u{vid}"]
        assert port_ops.lookup_many("m:1", [3, 1, 3]) == \
            {3: ["u3"], 1: ["u1"]}
    finally:
        port_ops.lookup = orig
    assert calls == [3, 1] and not port_lc._caches
    assert {t.ident for t in threading.enumerate()} <= before


# -- the lease cache (tests/test_ingest_pipeline.py:54-168) --------------------


class FakeMaster:
    """An assign_fn that hands out sequential keys and counts calls."""

    def __init__(self, ops, vid=7, delay_s=0.0, url="127.0.0.1:7070"):
        self.ops = ops
        self.vid = vid
        self.delay_s = delay_s
        self.url = url
        self.calls = []
        self._next_key = 1
        self._lock = threading.Lock()

    def __call__(self, master_url, count=1, replication="",
                 collection="", ttl="", data_center=""):
        if self.delay_s:
            time.sleep(self.delay_s)
        with self._lock:
            key = self._next_key
            self._next_key += count
            self.calls.append((count, collection, replication))
        return self.ops.Assignment(
            f"{self.vid},{key:x}000000aa", self.url, self.url, count)


def test_lease_one_assign_covers_count_fids():
    def run(pkg):
        m = FakeMaster(pkg.ops)
        lc = pkg.lease.LeaseCache(count=8, low_water=0, assign_fn=m)
        fids = [lc.acquire("m").fid for _ in range(8)]
        return m.calls, fids

    calls, fids = both(run)
    assert calls == [(8, "", "")] and len(set(fids)) == 8
    keys = sorted(parse_fid(f).key for f in fids)
    assert keys == list(range(keys[0], keys[0] + 8))


def test_lease_low_water_triggers_async_refill():
    from seaweedfs_tpu.util.scheduler import explore

    for pkg in PKGS.values():
        def scenario(pkg=pkg):
            m = FakeMaster(pkg.ops)
            lc = pkg.lease.LeaseCache(count=8, low_water=2, assign_fn=m)
            for _ in range(6):
                lc.acquire("m")
            while lc.depth() < 10:
                time.sleep(0)
            assert len(m.calls) == 2
            assert lc.depth() == 10

        res = explore(scenario, schedules=20, seed=0, check=False)
        assert not res.failures, res.failures[0]


def test_lease_expired_never_handed_out():
    def run(pkg):
        m = FakeMaster(pkg.ops)
        lc = pkg.lease.LeaseCache(count=4, low_water=0, lease_ttl_s=0.03,
                                  assign_fn=m)
        first = lc.acquire("m").fid
        time.sleep(0.08)
        second = lc.acquire("m").fid
        return len(m.calls), parse_fid(second).key > parse_fid(first).key

    assert both(run) == (2, True)


def test_lease_invalidate_drops_whole_volume():
    def run(pkg):
        m = FakeMaster(pkg.ops)
        lc = pkg.lease.LeaseCache(count=8, low_water=0, assign_fn=m)
        a = lc.acquire("m")
        out = [lc.depth(), lc.invalidate(a.fid), lc.depth(),
               lc.invalidate("junk")]
        lc.acquire("m")
        return out + [len(m.calls)]

    assert both(run) == [7, 7, 0, 0, 2]


def test_lease_cold_pool_single_flight():
    def run(pkg):
        m = FakeMaster(pkg.ops, delay_s=0.05)
        lc = pkg.lease.LeaseCache(count=32, low_water=0, assign_fn=m)
        fids, errs = [], []

        def grab():
            try:
                fids.append(lc.acquire("m").fid)
            except Exception as e:  # noqa: BLE001
                errs.append(e)

        ts = [threading.Thread(target=grab) for _ in range(8)]
        for t in ts:
            t.start()
        for t in ts:
            t.join()
        return errs, len(m.calls), len(set(fids))

    assert both(run) == ([], 1, 8)


def test_lease_pools_keyed_by_placement():
    def run(pkg):
        m = FakeMaster(pkg.ops)
        lc = pkg.lease.LeaseCache(count=4, low_water=0, assign_fn=m)
        lc.acquire("m", replication="000")
        lc.acquire("m", replication="010")
        lc.acquire("m", collection="c")
        return sorted(m.calls)

    assert both(run) == [(4, "", "000"), (4, "", "010"), (4, "c", "")]


def test_lease_concurrent_acquire_with_expiry_race():
    def run(pkg):
        m = FakeMaster(pkg.ops)
        lc = pkg.lease.LeaseCache(count=16, low_water=2, lease_ttl_s=0.01,
                                  assign_fn=m)
        fids = []
        lock = threading.Lock()

        def worker():
            for _ in range(20):
                fid = lc.acquire("m").fid
                with lock:
                    fids.append(fid)
                time.sleep(0.001)

        ts = [threading.Thread(target=worker) for _ in range(4)]
        for t in ts:
            t.start()
        for t in ts:
            t.join()
        return len(fids), len(set(fids))

    assert both(run) == (80, 80)


def test_lease_close_drains_to_the_master():
    def run(pkg):
        m = FakeMaster(pkg.ops)
        lc = pkg.lease.LeaseCache(count=8, low_water=0, assign_fn=m)
        lc.acquire("m")
        lc.close()
        out = [lc.depth()]
        lc.acquire("m")
        return out + [m.calls, lc.depth()]

    assert both(run) == [0, [(8, "", ""), (1, "", "")], 0]


def test_leased_upload_to_a_read_only_volume_is_assigned_again(clusters):
    """A banked lease whose volume turned read-only (and the master knows
    it): the upload fails there, the volume's leases are dropped and the
    bytes go to a fresh assign on another volume; the leased fid is never
    written."""
    outcomes = {}
    for name, (c, ops) in clusters.items():
        pkg = PKGS[name]
        leases = pkg.lease.LeaseCache(count=8, low_water=0)
        first = ops.upload(c.master.url, b"one", collection="ro",
                           leases=leases)
        vid = parse_fid(first).volume_id
        holders = [vs for vs in c.volume_servers
                   if vs.store.find_volume(vid) is not None]
        for vs in holders:
            vs.store.mark_volume_readonly(vid)
            vs.trigger_heartbeat()
        wait_for(lambda: all(vid not in vl.writable for vl in
                             c.master.topo.layouts.values()),
                 what=f"the master seeing volume {vid} read-only")
        banked = leases.depth()
        second = ops.upload(c.master.url, b"two", collection="ro",
                            leases=leases)
        outcomes[name] = (banked, parse_fid(second).volume_id != vid,
                          leases.depth(), leases.assign_round_trips,
                          ops.download(c.master.url, second))
        for vs in holders:
            vs.store.mark_volume_writable(vid)
            vs.trigger_heartbeat()
    assert outcomes["port"] == outcomes["jax"] == (7, True, 0, 1, b"two")


def test_delete_files_fans_out_per_server(monkeypatch):
    """Two servers' BatchDeletes run at once: each waits until the other
    has started (a serial walk would time out on the first)."""
    def run(pkg):
        monkeypatch.setattr(pkg.ops, "lookup",
                            lambda master, vid, collection="":
                            [f"srv{vid % 2}:80"])
        started = {"srv0:80": threading.Event(),
                   "srv1:80": threading.Event()}

        class SlowStub:
            def __init__(self, url):
                self.url = url

            def BatchDelete(self, req):
                started[self.url].set()
                other = next(e for u, e in started.items() if u != self.url)
                overlapped = other.wait(10)
                return types.SimpleNamespace(results=[
                    types.SimpleNamespace(file_id=f, status=202,
                                          error="" if overlapped else "x",
                                          size=3)
                    for f in req.file_ids])

        monkeypatch.setattr(pkg.ops, "volume_stub", SlowStub)
        fids = ["2,10000000aa", "3,20000000bb", "4,30000000cc",
                "5,40000000dd", "bad"]
        results = pkg.ops.delete_files("m", fids)
        return sorted((r["fid"], r.get("status"), r["error"][:20])
                      for r in results)

    got = both(run)
    assert len(got) == 5
    assert [r[1:] for r in got if r[0] != "bad"] == [(202, "")] * 4


def test_delete_files_surfaces_error_after_drain(monkeypatch):
    def run(pkg):
        monkeypatch.setattr(pkg.ops, "lookup",
                            lambda master, vid, collection="":
                            [f"srv{vid % 2}:80"])
        drained = []

        class Stub:
            def __init__(self, url):
                self.url = url

            def BatchDelete(self, req):
                if self.url == "srv0:80":
                    raise RuntimeError("server gone")
                time.sleep(0.05)
                drained.append(self.url)
                return types.SimpleNamespace(results=[])

        monkeypatch.setattr(pkg.ops, "volume_stub", Stub)
        with pytest.raises(RuntimeError, match="server gone"):
            pkg.ops.delete_files("m", ["2,10000000aa", "3,20000000bb"])
        return drained

    assert both(run) == ["srv1:80"]


# -- the CLI (tests/test_cli.py:115, :136) -------------------------------------


def _cli(*args, timeout=120):
    return subprocess.run(
        [sys.executable, "-m", "seaweedfs_tpu_torch", *args], cwd=REPO,
        env=dict(os.environ, PYTHONPATH=REPO), capture_output=True,
        text=True, timeout=timeout)


def test_cli_upload_download_delete_roundtrip(port_cluster, tmp_path):
    """upload -maxMB 1 of a 2.5 MiB file makes a chunked file; download
    -dir writes its bytes; delete removes it and its chunks."""
    murl = port_cluster.master.url
    src = tmp_path / "big.bin"
    data = np.random.default_rng(3).bytes((5 << 20) // 2)
    src.write_bytes(data)
    r = _cli("upload", "-master", murl, "-maxMB", "1", str(src))
    assert r.returncode == 0 and "Traceback" not in r.stderr, r.stderr
    out = json.loads(r.stdout)
    assert [(o["fileName"], o["size"]) for o in out] == \
        [("big.bin", len(data))]
    fid = out[0]["fid"]
    holder = port_ops.lookup(murl, parse_fid(fid).volume_id)[0]
    cm = port_cf.load_chunk_manifest(
        port_ops.http_request("GET", f"{holder}/{fid}?cm=false").body)
    assert len(cm.chunks) == 3
    r = _cli("download", "-master", murl, "-dir", str(tmp_path), fid)
    assert r.returncode == 0 and "Traceback" not in r.stderr, r.stderr
    assert (tmp_path / fid.replace(",", "_")).read_bytes() == data
    r = _cli("delete", "-master", murl, fid)
    assert r.returncode == 0 and r.stdout.strip() == f"deleted {fid}"
    for f in [fid] + [c.fid for c in cm.chunks]:
        url = port_ops.lookup(murl, parse_fid(f).volume_id)[0]
        assert port_ops.http_request("GET", f"{url}/{f}").status == 404


def test_cli_benchmark_small(port_cluster):
    r = _cli("benchmark", "-master", port_cluster.master.url, "-n", "40",
             "-c", "4", "-size", "512", "-assign.leaseCount", "8",
             "-collection", "bench")
    assert r.returncode == 0 and "Traceback" not in r.stderr, r.stderr
    assert "requests per second" in r.stdout
    assert r.stdout.count("failed requests:        0") == 2
    assert "99%" in r.stdout


def test_benchmark_report_and_payload_equal_jax():
    """The report's text and the fixed-seed payload are the JAX
    package's for the same samples."""
    import io

    def run(pkg):
        st = pkg.bench.Stats()
        for i in range(1, 200):
            st.add(i / 1000.0, 100 + i)
        st.fail()
        buf = io.StringIO()
        st.report("benchmark: write", 2.0, buf)
        return buf.getvalue(), pkg.bench._payload(3000, seed=1)

    report, payload = both(run)
    assert "completed requests:     199" in report and len(payload) >= 3000
