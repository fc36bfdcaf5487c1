"""The port's messaging against the JAX package's.

``pb/messaging_pb2``: every message's field table equals the JAX
descriptor, and seeded random messages (the ``headers`` map and both
enums included) serialize to protobuf's bytes and parse back in both
directions. ``messaging.consistent.pick_member`` places seeded keys on
seeded member sets as the JAX ring does. On each package's cluster with
a filer (``tests/test_torch_filer_server.py``'s ``make_sides``), one
script of broker calls gives the same results: keyed and fixed-partition
publishes land in the same partitions with the same timestamps (the
publishers' clock frozen, so the broker's bump of equal stamps shows),
a new broker replays the same logs from EARLIEST, the topic
configuration survives the restart, a transient topic leaves nothing in
the filer, and a deleted topic leaves no log. Two brokers named by
``-peers`` on the same ports in each package agree on every topic's
owner, and channels carry the same bytes with the same md5. The
``msgBroker`` command starts, answers ``FindBroker`` and stops on SIGINT
with exit 0.
"""

import hashlib
import os
import signal
import subprocess
import sys
import threading
import types
import urllib.error

import numpy as np
import pytest
from google.protobuf.descriptor import FieldDescriptor

from seaweedfs_tpu.filer import http_client as jax_http
from seaweedfs_tpu.messaging import broker as jax_broker
from seaweedfs_tpu.messaging import client as jax_client
from seaweedfs_tpu.messaging import consistent as jax_consistent
from seaweedfs_tpu.pb import messaging_pb2 as jax_mpb
from seaweedfs_tpu.pb import messaging_stub as jax_stub
from seaweedfs_tpu_torch import rpc
from seaweedfs_tpu_torch.filer import http_client as port_http
from seaweedfs_tpu_torch.messaging import broker as port_broker
from seaweedfs_tpu_torch.messaging import client as port_client
from seaweedfs_tpu_torch.messaging import consistent as port_consistent
from seaweedfs_tpu_torch.pb import messaging_pb2 as port_mpb
from seaweedfs_tpu_torch.pb import messaging_stub as port_stub
from seaweedfs_tpu_torch.pb.wire import Message
from tests.test_torch_cluster import REPO, free_port_pair, wait_for
from tests.test_torch_filer_server import make_sides

PKGS = {
    "jax": types.SimpleNamespace(
        name="jax", broker=jax_broker, client=jax_client, mpb=jax_mpb,
        stub=jax_stub, http=jax_http),
    "port": types.SimpleNamespace(
        name="port", broker=port_broker, client=port_client, mpb=port_mpb,
        stub=port_stub, http=port_http),
}

_KIND = {FieldDescriptor.TYPE_STRING: "string",
         FieldDescriptor.TYPE_BYTES: "bytes",
         FieldDescriptor.TYPE_BOOL: "bool",
         FieldDescriptor.TYPE_INT32: "int32",
         FieldDescriptor.TYPE_INT64: "int64",
         FieldDescriptor.TYPE_ENUM: "enum",
         FieldDescriptor.TYPE_MESSAGE: "message"}


def _port_classes():
    out = []

    def walk(cls):
        out.append(cls)
        for v in vars(cls).values():
            if isinstance(v, type) and issubclass(v, Message):
                walk(v)
    for v in vars(port_mpb).values():
        if isinstance(v, type) and issubclass(v, Message) and \
                "." not in v.__qualname__:
            walk(v)
    return out


CLASSES = _port_classes()
IDS = [c.FULL_NAME for c in CLASSES]


def _jax_class(full_name: str):
    cls = jax_mpb
    for part in full_name.split(".")[1:]:
        cls = getattr(cls, part)
    return cls


# -- messaging_pb2 ------------------------------------------------------------


def test_every_messaging_message_is_ported():
    want = set()

    def walk(desc):
        if desc.GetOptions().map_entry:
            return
        want.add(desc.full_name)
        for n in desc.nested_types:
            walk(n)
    for d in jax_mpb.DESCRIPTOR.message_types_by_name.values():
        walk(d)
    assert {c.FULL_NAME for c in CLASSES} == want
    assert len(want) == 19


@pytest.mark.parametrize("cls", CLASSES, ids=IDS)
def test_field_table_equals_jax_descriptor(cls):
    desc = _jax_class(cls.FULL_NAME).DESCRIPTOR
    want = []
    for f in desc.fields:
        if f.message_type is not None and \
                f.message_type.GetOptions().map_entry:
            kf = f.message_type.fields_by_name["key"]
            vf = f.message_type.fields_by_name["value"]
            want.append((f.name, f.number, "map", _KIND[kf.type],
                         _KIND[vf.type], None))
        else:
            t = f.message_type or f.enum_type
            want.append((f.name, f.number, _KIND[f.type],
                         f.label == FieldDescriptor.LABEL_REPEATED,
                         t.full_name if t else None,
                         {k: v.number for k, v in
                          f.enum_type.values_by_name.items()}
                         if f.enum_type else None))
    got = []
    for f in cls._FIELDS:
        if f.kind == "map":
            got.append((f.name, f.number, "map", f.map_key, f.map_value,
                        None))
        else:
            got.append((f.name, f.number, f.kind, f.repeated,
                        f.cls.FULL_NAME if f.cls else None,
                        dict(f.cls._VALUES) if f.kind == "enum" else None))
    assert sorted(got, key=str) == sorted(want, key=str)


def test_service_methods_equal_jax_descriptor():
    svc = jax_mpb.DESCRIPTOR.services_by_name["SeaweedMessaging"]
    assert svc.full_name == f"{port_mpb.PACKAGE}.SeaweedMessaging"
    got = {(name, req.FULL_NAME, resp.FULL_NAME, cs, ss) for
           name, req, resp, cs, ss in port_mpb.SERVICES["SeaweedMessaging"]}
    want = {(m.name, m.input_type.full_name, m.output_type.full_name,
             m.client_streaming, m.server_streaming) for m in svc.methods}
    assert got == want
    # the enums' values sit where protobuf's generated code has them
    assert port_mpb.SubscriberMessage.InitMessage.EARLIEST == \
        jax_mpb.SubscriberMessage.InitMessage.EARLIEST == 1
    assert port_mpb.TopicConfiguration.RoundRobin == \
        jax_mpb.TopicConfiguration.RoundRobin == 2


_TEXT = ["", "a", "ns/topic", "ünïcødé", "日本語", "x" * 300]


def _value(kind, rng, f=None):
    if kind == "string":
        return _TEXT[int(rng.integers(len(_TEXT)))]
    if kind == "bytes":
        return rng.integers(0, 256, int(rng.integers(0, 80)),
                            dtype=np.uint8).tobytes()
    if kind == "bool":
        return bool(rng.integers(2))
    if kind == "enum":
        return int(rng.choice(sorted(f.cls._VALUES.values())))
    if kind == "int32":
        return [0, -1, 1, -2**31, 2**31 - 1,
                int(rng.integers(-2**31, 2**31))][int(rng.integers(6))]
    return [0, -1, -2**63, 2**63 - 1,
            int(rng.integers(-2**62, 2**62))][int(rng.integers(5))]


def _random_pair(cls, rng, depth=0):
    """The same random field values as a port message and a protobuf
    message; each field is left unset about a third of the time."""
    p, j = cls(), _jax_class(cls.FULL_NAME)()
    for f in cls._FIELDS:
        if rng.random() < 0.3:
            continue
        if f.kind == "map":
            for _ in range(int(rng.integers(0, 6))):
                key, v = _value(f.map_key, rng), _value(f.map_value, rng)
                getattr(p, f.name)[key] = v
                getattr(j, f.name)[key] = v
        elif f.kind == "message":
            if depth < 3:
                sp, sj = _random_pair(f.cls, rng, depth + 1)
                getattr(p, f.name).CopyFrom(sp)
                getattr(j, f.name).CopyFrom(sj)
        else:
            v = _value(f.kind, rng, f)
            setattr(p, f.name, v)
            setattr(j, f.name, v)
    return p, j


@pytest.mark.parametrize("cls", CLASSES, ids=IDS)
def test_wire_bytes_equal_protobuf(cls):
    rng = np.random.default_rng(sum(cls.FULL_NAME.encode()))
    for _ in range(40):
        p, j = _random_pair(cls, rng)
        want = j.SerializeToString(deterministic=True)
        assert p.SerializeToString() == want
        back = cls()
        back.ParseFromString(j.SerializeToString())
        assert back.SerializeToString() == want
        j2 = type(j)()
        j2.ParseFromString(p.SerializeToString())
        assert j2 == j


# -- consistent placement -----------------------------------------------------


def test_pick_member_equals_jax_on_seeded_sets():
    rng = np.random.default_rng(8)
    for case in range(60):
        members = [f"10.0.{int(rng.integers(256))}.{i}:"
                   f"{int(rng.integers(1024, 65536))}"
                   for i in range(int(rng.integers(1, 9)))]
        for _ in range(40):
            key = rng.integers(0, 256, int(rng.integers(0, 40)),
                               dtype=np.uint8).tobytes()
            got = port_consistent.pick_member(members, key)
            assert got == jax_consistent.pick_member(members, key), case
            assert got in members
    for mod in (port_consistent, jax_consistent):
        with pytest.raises(ValueError, match="no members"):
            mod.pick_member([], b"k")


# -- one script on each package's cluster -------------------------------------


@pytest.fixture(scope="module")
def sides(tmp_path_factory):
    out, undo = make_sides(tmp_path_factory)
    yield out
    for s in out.values():
        s.stop()
    undo()


class _FrozenClock:
    """A stand-in for the client module's ``time``: every publisher stamp
    is the same nanosecond, so the broker must bump each by one."""

    NS = 1_760_000_000_000_000_000

    def time_ns(self):
        return self.NS

    def __getattr__(self, name):
        import time
        return getattr(time, name)


def _values(rng, n):
    return [rng.integers(0, 256, int(rng.integers(1, 3000)),
                         dtype=np.uint8).tobytes() for _ in range(n)]


def _drain(sub, n, timeout=30):
    """The first n messages of a subscription: (event time, key, value)."""
    got = []
    done = threading.Event()

    def pump():
        for m in sub:
            got.append((m.event_time_ns, bytes(m.key), bytes(m.value)))
            if len(got) >= n:
                break
        done.set()
    t = threading.Thread(target=pump, daemon=True)
    t.start()
    done.wait(timeout)
    sub.cancel()
    return got


def _exists(pkg, url, path) -> bool:
    try:
        pkg.http.get(url, path)
        return True
    except urllib.error.HTTPError as e:
        if e.code == 404:
            return False
        raise


def test_broker_script_equals_jax(sides, monkeypatch):
    def run(pkg):
        side = sides[pkg.name]
        monkeypatch.setattr(pkg.client, "time", _FrozenClock())
        b = pkg.broker.MessageBroker(filer_url=side.filer.url,
                                     port=free_port_pair())
        b.start()
        rng = np.random.default_rng(9)
        client = pkg.client.MessagingClient(b.url)
        try:
            client.configure_topic("ns", "log", partition_count=6)
            pub = client.new_publisher("ns", "log")
            keyed = []
            for i, v in enumerate(_values(rng, 30)):
                key = f"key-{i % 7}".encode()
                pub.publish(v, key=key, headers={"n": str(i).encode()})
                keyed.append((key, v))
            pub.close()
            fixed = client.new_publisher("ns", "log", partition=2)
            for v in _values(rng, 5):
                fixed.publish(v)
            fixed.close()
            t = b._get_topic("ns", "log")
            live = [[(ts - _FrozenClock.NS, blob) for ts, blob in p.entries]
                    for p in t.partitions]
            # a transient topic: served live, never written to the filer
            stub = pkg.stub(b.url)
            stub.ConfigureTopic(pkg.mpb.ConfigureTopicRequest(
                namespace="ns", topic="tmp",
                configuration=pkg.mpb.TopicConfiguration(
                    partition_count=2, is_transient=True,
                    partitoning=pkg.mpb.TopicConfiguration.KeyHash)))
            tp = client.new_publisher("ns", "tmp", partition=0)
            tp.publish(b"not persisted")
            tp.close()
        finally:
            b.stop()
        # a new broker on the same filer replays every partition
        b2 = pkg.broker.MessageBroker(filer_url=side.filer.url,
                                      port=free_port_pair())
        b2.start()
        try:
            c2 = pkg.client.MessagingClient(b2.url)
            cfg = pkg.stub(b2.url).GetTopicConfiguration(
                pkg.mpb.GetTopicConfigurationRequest(
                    namespace="ns", topic="log")).configuration
            tmp_cfg = pkg.stub(b2.url).GetTopicConfiguration(
                pkg.mpb.GetTopicConfigurationRequest(
                    namespace="ns", topic="tmp")).configuration
            replay = []
            for p, want in enumerate(live):
                got = _drain(c2.new_subscriber("ns", "log", partition=p,
                                               start="earliest"),
                             len(want))
                replay.append([(ts - _FrozenClock.NS, k, v)
                               for ts, k, v in got])
            tmp_in_filer = _exists(pkg, side.filer.url, "/topics/ns/tmp")
            log_in_filer = _exists(pkg, side.filer.url,
                                   "/topics/ns/log/00.log")
            c2.delete_topic("ns", "log")
            gone = not _exists(pkg, side.filer.url, "/topics/ns/log")
            after = pkg.stub(b2.url).GetTopicConfiguration(
                pkg.mpb.GetTopicConfigurationRequest(
                    namespace="ns", topic="log")).configuration
        finally:
            b2.stop()
        decoded = []
        for part in live:
            row = []
            for off, blob in part:
                m = pkg.mpb.Message()
                m.ParseFromString(blob)
                # the close marker carries no stamp: the broker's clock
                row.append((None if m.is_close else off, bytes(m.key),
                            bytes(m.value), dict(m.headers), m.is_close))
            decoded.append(row)
        return (decoded, replay, cfg.SerializeToString(),
                tmp_cfg.SerializeToString(), tmp_in_filer, log_in_filer,
                gone, after.partition_count)
    jax_out = run(PKGS["jax"])
    port_out = run(PKGS["port"])
    for p, (a, b) in enumerate(zip(port_out[0], jax_out[0])):
        brief = [[(off, k, len(v), sorted(h), c) for off, k, v, h, c in x]
                 for x in (a, b)]
        assert brief[0] == brief[1], f"partition {p}"
    for i, (a, b) in enumerate(zip(port_out, jax_out)):
        assert a == b, i
    decoded, replay, _, _, tmp_in_filer, log_in_filer, gone, after = \
        port_out
    # keyed publishes spread by md5, stamps bumped by one per partition
    assert sum(len(p) for p in decoded) == 30 + 5 + 1  # + fixed close
    for part in decoded:
        offs = [off for off, *_, close in part if not close]
        assert offs == list(range(len(offs)))
    # a subscriber stops at the fixed publisher's close marker
    assert [[(off, k, v) for off, k, v, _, close in p if not close]
            for p in decoded] == replay
    assert not tmp_in_filer and log_in_filer and gone and after == 4


def test_two_brokers_agree_and_channels_carry_bytes_like_jax():
    ports = [free_port_pair(), free_port_pair()]
    urls = [f"127.0.0.1:{p}" for p in ports]
    rng = np.random.default_rng(10)
    chunks = _values(rng, 25)

    def run(pkg):
        brokers = [pkg.broker.MessageBroker(port=p, peers=urls)
                   for p in ports]
        for b in brokers:
            b.start()
        try:
            owners = []
            for i in range(24):
                answers = {pkg.stub(b.url).FindBroker(
                    pkg.mpb.FindBrokerRequest(namespace="ns",
                                              topic=f"t{i}",
                                              parition=i % 3)).broker
                    for b in brokers}
                assert len(answers) == 1
                owners.append(answers.pop())
            client = pkg.client.MessagingClient(*urls)
            pub = client.new_pub_channel("chat")
            for c in chunks:
                pub.publish(c)
            pub.close()
            sub = client.new_sub_channel("reader-1", "chat")
            got = list(sub)
            return owners, got, pub.md5(), sub.md5(), \
                client.find_broker("chan", "chat")
        finally:
            for b in brokers:
                b.stop()
            rpc.close_channels()
    # the port first: its listeners close at once, so the JAX servers
    # can bind the same ports after it
    port_out = run(PKGS["port"])
    jax_out = run(PKGS["jax"])
    assert port_out == jax_out
    owners, got, md5_pub, md5_sub, owner = port_out
    assert set(owners) == set(urls)
    assert got == chunks and md5_pub == md5_sub == \
        hashlib.md5(b"".join(chunks)).digest()
    assert owner in urls


# -- the msgBroker command ----------------------------------------------------


def test_msg_broker_command_serves_and_stops(sides, tmp_path):
    port = free_port_pair()
    url = f"127.0.0.1:{port}"
    proc = subprocess.Popen(
        [sys.executable, "-m", "seaweedfs_tpu_torch", "msgBroker",
         "-port", str(port), "-filer", sides["port"].filer.url,
         "-peers", url], cwd=str(tmp_path), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, env={**os.environ, "PYTHONPATH": REPO})
    try:
        def answers():
            try:
                return port_stub(url).FindBroker(
                    port_mpb.FindBrokerRequest(namespace="ns",
                                               topic="t")).broker
            except rpc.RpcError:
                return None
        assert wait_for(answers, 60, "msgBroker to answer") == url
        pub = port_client.MessagingClient(url).new_publisher(
            "ns", "cli", partition=0)
        pub.publish(b"through the command")
        pub.close()
        # the broker registers over KeepConnected: the filer locates it
        from seaweedfs_tpu_torch.pb import filer_pb2, filer_stub
        wait_for(lambda: filer_stub(sides["port"].filer.url).LocateBroker(
            filer_pb2.LocateBrokerRequest(resource="ns/cli")).found, 30,
            "the filer to locate the broker")
    finally:
        proc.send_signal(signal.SIGINT)
        try:
            _, err = proc.communicate(timeout=30)
        except subprocess.TimeoutExpired:
            proc.kill()
            _, err = proc.communicate()
    assert proc.returncode == 0, err.decode()[-2000:]
    assert b"Traceback" not in err


# -- the filer's appends, which the broker's persistence rides ----------------


def test_concurrent_appends_keep_every_chunk(sides, monkeypatch):
    """A difference kept on purpose: the port's filer appends under a
    lock, as upstream locks AppendToEntry, so appends from many threads
    to one file (a broker persists from a thread per publisher) each keep
    their chunk. The JAX filer's append is a read-modify-write without
    one: with the store's reads slowed, which makes the race certain, it
    keeps fewer chunks than were appended."""
    import time
    out = {}
    for name, side in sides.items():
        store = side.filer.filer.store.store
        real = store.find_entry

        def slow_find(directory, entry_name, real=real):
            time.sleep(0.002)
            return real(directory, entry_name)
        monkeypatch.setattr(store, "find_entry", slow_find)
        stub, pb = side.stub, side.pb

        def append(t):
            for i in range(8):
                stub.AppendToEntry(pb.AppendToEntryRequest(
                    directory="/appends", entry_name="log",
                    chunks=[pb.FileChunk(file_id=f"9,{t:x}{i:x}0000000",
                                         size=10)]))
        threads = [threading.Thread(target=append, args=(t,))
                   for t in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        monkeypatch.undo()
        e = stub.LookupDirectoryEntry(pb.LookupDirectoryEntryRequest(
            directory="/appends", name="log")).entry
        offsets = sorted(c.offset for c in e.chunks)
        out[name] = (len(e.chunks), offsets == list(range(
            0, 10 * len(e.chunks), 10)))
    assert out["port"] == (64, True)
    assert out["jax"][0] < 64 and out["jax"][1]
