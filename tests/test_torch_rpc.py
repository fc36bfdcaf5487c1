"""The port's RPC layer against the JAX package's grpcio/protobuf one.

Messages: every message class the port defines has the field table of the
JAX package's generated descriptor (names, numbers, kinds, repeated),
every service method the port serves has the JAX method's types and
streaming shape, and seeded random values serialize to the bytes
protobuf's ``SerializeToString`` gives (defaults, empty repeated fields,
nested trees, unicode, multi-MiB bytes), and protobuf's bytes decode to
equal fields. The transport: unary, server-streaming and bidirectional
calls, status codes through ``context.abort``, a ``timeout=`` that fires,
a refused connection, and a stopped peer ending the other side's stream.
Under mutual TLS (``security/tls.py``, certificates from the system
``openssl``): the same unary, server-streaming (frames over 64 KiB, read
with ``recv_into`` on the SSL socket) and bidirectional calls, a hang-up
seen through ``is_active()``, pooled connections reused, a deadline, and
a plaintext client or server refused at once instead of hanging.
"""

import socket
import struct
import threading
import time
import zlib

import numpy as np
import pytest
from google.protobuf.descriptor import FieldDescriptor

from seaweedfs_tpu.pb import master_pb2 as jax_master_pb2
from seaweedfs_tpu.pb import raft_pb2 as jax_raft_pb2
from seaweedfs_tpu.pb import volume_server_pb2 as jax_volume_pb2
from seaweedfs_tpu_torch import rpc
from seaweedfs_tpu_torch.pb import master_pb2, raft_pb2, volume_server_pb2
from seaweedfs_tpu_torch.pb.wire import Message

MODULES = [(master_pb2, jax_master_pb2), (volume_server_pb2, jax_volume_pb2),
           (raft_pb2, jax_raft_pb2)]

_KIND = {FieldDescriptor.TYPE_STRING: "string",
         FieldDescriptor.TYPE_BYTES: "bytes",
         FieldDescriptor.TYPE_BOOL: "bool",
         FieldDescriptor.TYPE_UINT32: "uint32",
         FieldDescriptor.TYPE_UINT64: "uint64",
         FieldDescriptor.TYPE_INT32: "int32",
         FieldDescriptor.TYPE_INT64: "int64",
         FieldDescriptor.TYPE_FLOAT: "float",
         FieldDescriptor.TYPE_DOUBLE: "double",
         FieldDescriptor.TYPE_MESSAGE: "message"}


def _port_classes(module):
    out = []

    def walk(cls):
        out.append(cls)
        for sub in vars(cls).values():
            if isinstance(sub, type) and issubclass(sub, Message):
                walk(sub)

    for v in vars(module).values():
        if isinstance(v, type) and issubclass(v, Message) and \
                v.__module__ == module.__name__:
            walk(v)
    return out


def _jax_class(jax_module, full_name: str):
    cls = jax_module
    for part in full_name.split(".")[1:]:
        cls = getattr(cls, part)
    return cls


ALL = [(cls, jm) for pm, jm in MODULES for cls in _port_classes(pm)]


def test_every_ported_message_is_listed():
    names = {cls.FULL_NAME for cls, _ in ALL}
    assert len(names) == len(ALL) > 70
    for want in ("master_pb.Heartbeat", "master_pb.TopologyInfo",
                 "master_pb.LookupVolumeResponse.VolumeIdLocation",
                 "volume_server_pb.VolumeEcShardsGenerateRequest",
                 "volume_server_pb.VolumeScrubStatusResponse",
                 "raft_pb.LogEntry", "raft_pb.AppendEntriesRequest"):
        assert want in names


MAINTENANCE_METHODS = {
    "VolumeServer": ["VacuumVolumeCheck", "VacuumVolumeCompact",
                     "VacuumVolumeCommit", "VacuumVolumeCleanup",
                     "DeleteCollection", "BatchDelete", "VolumeServerLeave",
                     "VolumeNeedleStatus", "VolumeConfigure", "Query",
                     "VolumeCopy", "VolumeSyncStatus",
                     "VolumeIncrementalCopy", "VolumeTailSender",
                     "VolumeTailReceiver", "VolumeTierMoveDatToRemote",
                     "VolumeTierMoveDatFromRemote"],
    "Seaweed": ["Statistics", "CollectionList", "CollectionDelete",
                "VacuumVolume"],
    "Raft": ["RequestVote", "AppendEntries"],
}


@pytest.mark.parametrize("service", sorted(MAINTENANCE_METHODS))
def test_maintenance_methods_are_served(service):
    """Every RPC of the maintenance surface is in the port's service
    table, with its messages (nested ones included) ported."""
    module = {"VolumeServer": volume_server_pb2,
              "Raft": raft_pb2}.get(service, master_pb2)
    served = {m[0]: m for m in module.SERVICES[service]}
    names = {cls.FULL_NAME for cls, _ in ALL}
    for method in MAINTENANCE_METHODS[service]:
        _, req, resp, _, _ = served[method]
        assert req.FULL_NAME in names and resp.FULL_NAME in names
    assert "volume_server_pb.QueryRequest.Filter" in names
    assert "volume_server_pb.DeleteResult" in names


@pytest.mark.parametrize("cls,jax_module", ALL,
                         ids=[c.FULL_NAME for c, _ in ALL])
def test_field_table_equals_jax_descriptor(cls, jax_module):
    desc = _jax_class(jax_module, cls.FULL_NAME).DESCRIPTOR
    assert desc.full_name == cls.FULL_NAME
    want = sorted(
        (f.name, f.number, _KIND[f.type],
         f.label == FieldDescriptor.LABEL_REPEATED,
         f.message_type.full_name if f.message_type else None)
        for f in desc.fields)
    got = sorted((f.name, f.number, f.kind, f.repeated,
                  f.cls.FULL_NAME if f.cls else None)
                 for f in cls._FIELDS)
    assert got == want


@pytest.mark.parametrize("pb_module,jax_module", MODULES,
                         ids=["master", "volume_server", "raft"])
def test_service_methods_equal_jax_descriptor(pb_module, jax_module):
    for service, methods in pb_module.SERVICES.items():
        svc = jax_module.DESCRIPTOR.services_by_name[service]
        assert svc.full_name == f"{pb_module.PACKAGE}.{service}"
        for name, req, resp, cs, ss in methods:
            m = svc.methods_by_name[name]
            assert (m.input_type.full_name, m.output_type.full_name,
                    m.client_streaming, m.server_streaming) == \
                (req.FULL_NAME, resp.FULL_NAME, cs, ss)


# -- wire bytes ----------------------------------------------------------------

_TEXT = ["", "a", "volume", "ünïcødé", "日本語", "emoji \U0001F600",
         "x" * 300]


def _pick(rng, options):
    return options[int(rng.integers(len(options)))]


def _value(kind, rng):
    if kind == "string":
        return _TEXT[rng.integers(len(_TEXT))]
    if kind == "bytes":
        return rng.integers(0, 256, int(rng.integers(0, 200)),
                            dtype=np.uint8).tobytes()
    if kind == "bool":
        return bool(rng.integers(2))
    if kind == "uint32":
        return _pick(rng, [0, 1, 127, 128, 2**31, 2**32 - 1,
                           int(rng.integers(0, 2**32))])
    if kind == "uint64":
        return _pick(rng, [0, 1, 2**32, 2**63, 2**64 - 1,
                           int(rng.integers(0, 2**63))])
    if kind == "int32":
        return _pick(rng, [0, -1, 1, -2**31, 2**31 - 1,
                           int(rng.integers(-2**31, 2**31))])
    if kind == "int64":
        return _pick(rng, [0, -1, -2**63, 2**63 - 1,
                           int(rng.integers(-2**62, 2**62))])
    if kind == "float":
        return float(np.float32(_pick(rng, [0.0, -0.0, 1.5, -3.25e7,
                                            rng.normal() * 1e3])))
    return float(_pick(rng, [0.0, 1e-300, -2.5, rng.normal() * 1e9]))


def _random_pair(cls, jax_module, rng, depth=0):
    """The same random field values as a port message and a protobuf
    message; each field is left unset about a third of the time."""
    jcls = _jax_class(jax_module, cls.FULL_NAME)
    kw_p, kw_j = {}, {}
    for f in cls._FIELDS:
        if rng.random() < 0.3:
            continue
        if f.kind == "message":
            if depth >= 3:
                continue
            n = int(rng.integers(0, 4)) if f.repeated else 1
            pairs = [_random_pair(f.cls, jax_module, rng, depth + 1)
                     for _ in range(n)]
            kw_p[f.name] = [p for p, _ in pairs] if f.repeated \
                else pairs[0][0]
            kw_j[f.name] = [j for _, j in pairs] if f.repeated \
                else pairs[0][1]
        elif f.repeated:
            vals = [_value(f.kind, rng)
                    for _ in range(int(rng.integers(0, 5)))]
            kw_p[f.name] = list(vals)
            kw_j[f.name] = list(vals)
        else:
            v = _value(f.kind, rng)
            kw_p[f.name] = v
            kw_j[f.name] = v
    return cls(**kw_p), jcls(**kw_j)


@pytest.mark.parametrize("cls,jax_module", ALL,
                         ids=[c.FULL_NAME for c, _ in ALL])
def test_encoding_is_byte_equal_to_protobuf(cls, jax_module):
    rng = np.random.default_rng(zlib.crc32(cls.FULL_NAME.encode()))
    for _ in range(12):
        port_msg, jax_msg = _random_pair(cls, jax_module, rng)
        want = jax_msg.SerializeToString()
        assert port_msg.SerializeToString() == want
        assert cls.FromString(want) == port_msg
    empty = cls().SerializeToString()
    assert empty == _jax_class(jax_module, cls.FULL_NAME)() \
        .SerializeToString() == b""


def test_multi_mib_bytes_and_nested_presence():
    blob = np.random.default_rng(5).integers(
        0, 256, 3 << 20, dtype=np.uint8).tobytes()
    for cls, jcls, field in (
            (volume_server_pb2.CopyFileResponse,
             jax_volume_pb2.CopyFileResponse, "file_content"),
            (volume_server_pb2.VolumeEcShardReadResponse,
             jax_volume_pb2.VolumeEcShardReadResponse, "data")):
        want = jcls(**{field: blob}).SerializeToString()
        assert cls(**{field: blob}).SerializeToString() == want
        assert getattr(cls.FromString(want), field) == blob
    # a sub-message is written once anything below it was set, even an
    # empty one, and not when it was only read
    p, j = master_pb2.VolumeListResponse(), jax_master_pb2.VolumeListResponse()
    assert p.topology_info.id == j.topology_info.id == ""
    assert p.SerializeToString() == j.SerializeToString() == b""
    p.topology_info.data_center_infos.add(id="dc")
    j.topology_info.data_center_infos.add(id="dc")
    assert p.SerializeToString() == j.SerializeToString()
    p = volume_server_pb2.VolumeServerStatusResponse(
        memory_status=volume_server_pb2.MemStatus())
    j = jax_volume_pb2.VolumeServerStatusResponse(
        memory_status=jax_volume_pb2.MemStatus())
    assert p.SerializeToString() == j.SerializeToString() == b"\x12\x00"
    assert p.HasField("memory_status")


def test_decoding_accepts_unpacked_repeated_and_skips_unknown():
    # field 3 of VolumeLocation unpacked (one varint per key), then an
    # unknown field 99 protobuf would carry as unknown
    raw = b"\x18\x05\x18\x07" + b"\x98\x06\x01"
    m = master_pb2.VolumeLocation.FromString(raw)
    assert list(m.new_vids) == [5, 7]
    assert list(jax_master_pb2.VolumeLocation.FromString(raw).new_vids) \
        == [5, 7]


# -- the transport -------------------------------------------------------------


class _Servicer:
    def __init__(self):
        self.heartbeat_ended = threading.Event()
        self.keep_connected_ended = threading.Event()

    def Assign(self, request, context):
        if request.collection == "missing":
            context.abort(rpc.StatusCode.NOT_FOUND, "no such collection")
        if request.collection == "refused":
            context.abort(rpc.StatusCode.FAILED_PRECONDITION, "refused")
        if request.collection == "bad":
            context.abort(rpc.StatusCode.INVALID_ARGUMENT, "bad argument")
        if request.collection == "slow":
            time.sleep(1.0)
        if request.collection == "crash":
            raise ValueError("handler crashed")
        return master_pb2.AssignResponse(
            fid=f"{request.count},{request.collection}",
            count=request.count)

    def SendHeartbeat(self, request_iterator, context):
        try:
            for hb in request_iterator:
                yield master_pb2.HeartbeatResponse(
                    leader=hb.ip, volume_size_limit=hb.port)
        finally:
            self.heartbeat_ended.set()

    def KeepConnected(self, request_iterator, context):
        intro = next(request_iterator)
        yield master_pb2.VolumeLocation(leader=intro.name)
        while context.is_active():
            time.sleep(0.02)
        self.keep_connected_ended.set()


class _VolumeServicer:
    def CopyFile(self, request, context):
        if request.ext == ".missing":
            context.abort(rpc.StatusCode.NOT_FOUND, "no file")
        for i in range(request.stop_offset):
            yield volume_server_pb2.CopyFileResponse(
                file_content=bytes([i % 256]) * (i * 1000))


@pytest.fixture
def server():
    svc = _Servicer()
    srv = rpc.make_server("127.0.0.1:0", [
        rpc.generic_handler(master_pb2, "Seaweed", svc),
        rpc.generic_handler(volume_server_pb2, "VolumeServer",
                            _VolumeServicer())])
    target = f"127.0.0.1:{srv.bound_port}"
    yield srv, svc, target
    srv.stop()


def _stubs(target):
    return (rpc.make_stub(master_pb2, "Seaweed", target),
            rpc.make_stub(volume_server_pb2, "VolumeServer", target))


def test_unary_calls_reuse_one_pooled_connection(server):
    _, _, target = server
    stub, _ = _stubs(target)
    for i in range(1, 30):
        resp = stub.Assign(master_pb2.AssignRequest(count=i,
                                                    collection="c"))
        assert (resp.fid, resp.count) == (f"{i},c", i)
    assert len(rpc._pools[target]) == 1
    assert rpc.make_stub(master_pb2, "Seaweed", target) is stub


@pytest.mark.parametrize("collection,code", [
    ("missing", rpc.StatusCode.NOT_FOUND),
    ("refused", rpc.StatusCode.FAILED_PRECONDITION),
    ("bad", rpc.StatusCode.INVALID_ARGUMENT),
    ("crash", rpc.StatusCode.UNKNOWN)])
def test_status_codes_through_abort(server, collection, code):
    _, _, target = server
    stub, _ = _stubs(target)
    with pytest.raises(rpc.RpcError) as ei:
        stub.Assign(master_pb2.AssignRequest(collection=collection))
    assert ei.value.code() == code
    # the connection carries the next call
    assert stub.Assign(master_pb2.AssignRequest(count=2)).count == 2


def test_unimplemented_method(server):
    _, _, target = server
    _, vstub = _stubs(target)
    with pytest.raises(rpc.RpcError) as ei:
        vstub.VolumeStatus(volume_server_pb2.VolumeStatusRequest())
    assert ei.value.code() == rpc.StatusCode.UNIMPLEMENTED


def test_timeout_fires(server):
    _, _, target = server
    stub, _ = _stubs(target)
    t0 = time.monotonic()
    with pytest.raises(rpc.RpcError) as ei:
        stub.Assign(master_pb2.AssignRequest(collection="slow"),
                    timeout=0.2)
    assert ei.value.code() == rpc.StatusCode.DEADLINE_EXCEEDED
    assert time.monotonic() - t0 < 0.8


def test_server_streaming(server):
    _, _, target = server
    _, vstub = _stubs(target)
    chunks = list(vstub.CopyFile(volume_server_pb2.CopyFileRequest(
        stop_offset=40)))
    assert [c.file_content for c in chunks] == \
        [bytes([i]) * (i * 1000) for i in range(40)]
    with pytest.raises(rpc.RpcError) as ei:
        list(vstub.CopyFile(volume_server_pb2.CopyFileRequest(
            ext=".missing")))
    assert ei.value.code() == rpc.StatusCode.NOT_FOUND


def test_bidi_stream_and_cancel_ends_the_server_side(server):
    _, svc, target = server
    stub, _ = _stubs(target)
    more = threading.Event()

    def beats():
        for i in range(3):
            yield master_pb2.Heartbeat(ip=f"10.0.0.{i}", port=i)
        more.wait(5)

    call = stub.SendHeartbeat(beats())
    got = [next(call) for _ in range(3)]
    assert [(r.leader, r.volume_size_limit) for r in got] == \
        [(f"10.0.0.{i}", i) for i in range(3)]
    assert not svc.heartbeat_ended.is_set()
    call.cancel()
    assert svc.heartbeat_ended.wait(2)
    with pytest.raises(rpc.RpcError) as ei:
        next(call)
    assert ei.value.code() == rpc.StatusCode.CANCELLED
    more.set()


def test_failing_request_iterator_cancels_the_call(server):
    _, svc, target = server
    stub, _ = _stubs(target)

    go = threading.Event()

    def beats():
        yield master_pb2.Heartbeat(ip="ok")
        go.wait(5)
        raise RuntimeError("the request stream broke")

    call = stub.SendHeartbeat(beats())
    assert next(call).leader == "ok"
    go.set()
    with pytest.raises(rpc.RpcError) as ei:
        next(call)
    assert ei.value.code() == rpc.StatusCode.CANCELLED
    assert svc.heartbeat_ended.wait(2)


def test_client_hangup_turns_is_active_false(server):
    _, svc, target = server
    stub, _ = _stubs(target)
    stream = stub.KeepConnected(
        iter([master_pb2.KeepConnectedRequest(name="client")]))
    assert next(stream).leader == "client"
    time.sleep(0.1)
    assert not svc.keep_connected_ended.is_set()
    stream.cancel()
    assert svc.keep_connected_ended.wait(2)


def test_stopped_server_ends_client_stream_promptly(server):
    srv, _, target = server
    stub, _ = _stubs(target)
    done = threading.Event()

    def beats():
        yield master_pb2.Heartbeat(ip="a")
        done.wait(5)

    call = stub.SendHeartbeat(beats())
    assert next(call).leader == "a"
    t0 = time.monotonic()
    threading.Timer(0.1, srv.stop).start()
    with pytest.raises(rpc.RpcError) as ei:
        next(call)
    assert ei.value.code() == rpc.StatusCode.UNAVAILABLE
    assert time.monotonic() - t0 < 1.0
    done.set()


def test_connection_refused_is_unavailable_within_a_second():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    stub = rpc.make_stub(master_pb2, "Seaweed", f"127.0.0.1:{port}")
    t0 = time.monotonic()
    with pytest.raises(rpc.RpcError) as ei:
        stub.Assign(master_pb2.AssignRequest())
    assert ei.value.code() == rpc.StatusCode.UNAVAILABLE
    assert time.monotonic() - t0 < 1.0


def test_pooled_connection_to_a_restarted_server_is_redialled(server):
    srv, svc, target = server
    stub, _ = _stubs(target)
    assert stub.Assign(master_pb2.AssignRequest(count=1)).count == 1
    srv.stop()
    port = int(target.rsplit(":", 1)[1])
    srv2 = rpc.make_server(f"127.0.0.1:{port}", [
        rpc.generic_handler(master_pb2, "Seaweed", svc)])
    try:
        time.sleep(0.05)
        assert stub.Assign(master_pb2.AssignRequest(count=3)).count == 3
    finally:
        srv2.stop()


def test_frame_layout():
    """kind (u8) | length (u32 big-endian) | payload, status code first."""
    with socket.create_server(("127.0.0.1", 0)) as lst:
        a = socket.create_connection(lst.getsockname())
        b, _ = lst.accept()
    try:
        conn = rpc._Conn(a)
        conn.send((rpc.STATUS, rpc._status_payload(
            rpc.StatusCode.NOT_FOUND, "gone")))
        raw = b.recv(64)
        assert raw == struct.pack(">BI", rpc.STATUS, 5) + b"\x05gone"
        b.sendall(struct.pack(">BI", rpc.MSG, 3) + b"abc")
        assert conn.recv() == (rpc.MSG, b"abc")
        b.close()
        assert conn.recv() is None
    finally:
        a.close()
        b.close()


def test_grpc_address():
    assert rpc.grpc_address("127.0.0.1:8080") == "127.0.0.1:18080"
    assert rpc.grpc_address("http://h:9333") == "h:19333"
    with pytest.raises(ValueError):
        rpc.grpc_address("nohost")


# -- the transport under mutual TLS --------------------------------------------


@pytest.fixture(scope="module")
def tls_contexts(tmp_path_factory):
    from tests.test_tls import _gen_certs
    from seaweedfs_tpu_torch.security.tls import TlsConfig
    d = tmp_path_factory.mktemp("rpc_certs")
    _gen_certs(d)
    server = TlsConfig(str(d / "ca.crt"), str(d / "server.crt"),
                       str(d / "server.key")).server_context()
    client = TlsConfig(str(d / "ca.crt"), str(d / "client.crt"),
                       str(d / "client.key")).client_context()
    return server, client


@pytest.fixture
def tls_server(tls_contexts):
    rpc.set_server_credentials(tls_contexts[0])
    rpc.set_channel_credentials(tls_contexts[1])
    svc = _Servicer()
    srv = rpc.make_server("127.0.0.1:0", [
        rpc.generic_handler(master_pb2, "Seaweed", svc),
        rpc.generic_handler(volume_server_pb2, "VolumeServer",
                            _VolumeServicer())])
    try:
        yield srv, svc, f"127.0.0.1:{srv.bound_port}"
    finally:
        srv.stop()
        rpc.set_server_credentials(None)
        rpc.set_channel_credentials(None)


def test_tls_unary_calls_reuse_one_pooled_connection(tls_server):
    _, _, target = tls_server
    stub, _ = _stubs(target)
    for i in range(1, 30):
        resp = stub.Assign(master_pb2.AssignRequest(count=i,
                                                    collection="c"))
        assert (resp.fid, resp.count) == (f"{i},c", i)
    idle = rpc._pools[target]
    assert len(idle) == 1 and isinstance(idle[0].sock, rpc.ssl.SSLSocket)
    with pytest.raises(rpc.RpcError) as ei:
        stub.Assign(master_pb2.AssignRequest(collection="missing"))
    assert ei.value.code() == rpc.StatusCode.NOT_FOUND
    t0 = time.monotonic()
    with pytest.raises(rpc.RpcError) as ei:
        stub.Assign(master_pb2.AssignRequest(collection="slow"),
                    timeout=0.2)
    assert ei.value.code() == rpc.StatusCode.DEADLINE_EXCEEDED
    assert time.monotonic() - t0 < 0.8


def test_tls_server_streaming_large_frames(tls_server):
    """Frames of up to 99,000 bytes: past 64 KiB the payload is read with
    recv_into on the SSL socket."""
    _, _, target = tls_server
    _, vstub = _stubs(target)
    for _ in range(2):
        chunks = list(vstub.CopyFile(volume_server_pb2.CopyFileRequest(
            stop_offset=100)))
        assert [c.file_content for c in chunks] == \
            [bytes([i]) * (i * 1000) for i in range(100)]


def test_tls_bidi_stream_and_hangup(tls_server):
    """A request stream pumped from its own thread while the caller reads
    (one SSL socket, two threads), then a cancel the server sees."""
    _, svc, target = tls_server
    stub, _ = _stubs(target)
    more = threading.Event()

    def beats():
        for i in range(200):
            yield master_pb2.Heartbeat(ip=f"10.0.{i // 256}.{i % 256}",
                                       port=i)
        more.wait(5)

    call = stub.SendHeartbeat(beats())
    got = [next(call) for _ in range(200)]
    assert [r.volume_size_limit for r in got] == list(range(200))
    call.cancel()
    assert svc.heartbeat_ended.wait(2)
    more.set()
    stream = stub.KeepConnected(
        iter([master_pb2.KeepConnectedRequest(name="client")]))
    assert next(stream).leader == "client"
    time.sleep(0.1)
    assert not svc.keep_connected_ended.is_set()
    stream.cancel()
    assert svc.keep_connected_ended.wait(2)


def test_tls_pooled_connection_holding_a_byte_is_not_reused(tls_server):
    """A pooled SSL connection whose peer sent anything while it sat idle
    is dropped, whatever select sees of the raw socket."""
    srv, _, target = tls_server
    stub, _ = _stubs(target)
    assert stub.Assign(master_pb2.AssignRequest(count=1)).count == 1
    conn = rpc._pools[target][0]
    assert not conn.idle_unusable()
    with srv._lock:
        server_side = next(iter(srv._conns))
    server_side.send((rpc.MSG, b"stray"))
    wait = time.monotonic() + 2
    while not conn.idle_unusable() and time.monotonic() < wait:
        time.sleep(0.01)
    assert conn.idle_unusable()
    assert stub.Assign(master_pb2.AssignRequest(count=2)).count == 2


def test_plaintext_client_against_tls_server_fails_fast(tls_server):
    _, _, target = tls_server
    rpc.set_channel_credentials(None)
    stub, _ = _stubs(target)
    t0 = time.monotonic()
    with pytest.raises(rpc.RpcError) as ei:
        stub.Assign(master_pb2.AssignRequest(count=1), timeout=10)
    assert ei.value.code() == rpc.StatusCode.UNAVAILABLE
    assert time.monotonic() - t0 < 2.0


def test_tls_client_against_plaintext_server_fails(server, tls_contexts):
    _, _, target = server
    rpc.set_channel_credentials(tls_contexts[1])
    try:
        stub, _ = _stubs(target)
        t0 = time.monotonic()
        with pytest.raises(rpc.RpcError) as ei:
            stub.Assign(master_pb2.AssignRequest(count=1), timeout=10)
        assert ei.value.code() == rpc.StatusCode.UNAVAILABLE
        # the server ends a connection whose first frame is no frame
        assert time.monotonic() - t0 < 2.0
    finally:
        rpc.set_channel_credentials(None)


_HANGUP_SCRIPT = r"""
import signal, sys, time
signal.signal(signal.SIGPIPE, signal.SIG_DFL)
from seaweedfs_tpu_torch import rpc
from seaweedfs_tpu_torch.pb import volume_server_pb2

class Svc:
    def VolumeEcShardRead(self, request, context):
        while True:
            yield volume_server_pb2.VolumeEcShardReadResponse(
                data=b"x" * (1 << 20))

srv = rpc.make_server("127.0.0.1:0", [
    rpc.generic_handler(volume_server_pb2, "VolumeServer", Svc())])
stream = rpc.make_stub(volume_server_pb2, "VolumeServer",
                       f"127.0.0.1:{srv.bound_port}").VolumeEcShardRead(
    volume_server_pb2.VolumeEcShardReadRequest(volume_id=1))
next(stream)
stream.cancel()
time.sleep(1.0)     # the server goes on sending into the closed socket
srv.stop()
print("alive")
"""


def test_peer_hangup_never_kills_the_process_without_sigpipe_ignored():
    """A server stream whose client hung up gets EPIPE, and the process
    lives on even where SIGPIPE has its default action (a libfuse mount's
    teardown restores it): the JAX package's grpc transport never raises
    SIGPIPE either."""
    import os
    import subprocess
    import sys
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    r = subprocess.run([sys.executable, "-c", _HANGUP_SCRIPT], cwd=repo,
                       env=dict(os.environ, PYTHONPATH=repo),
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0 and r.stdout.strip() == "alive", \
        (r.returncode, r.stderr[-2000:])

