"""The port's security plane against the JAX package's.

JWT and the guard (``tests/test_security_stats.py``): tokens equal to the
JAX package's for the same key and claims, and expired, wrongly signed and
malformed tokens refused with the same errors; the guard's whitelist and
JWT gate decide alike. Mutual TLS (``tests/test_tls.py``): the gating of
``load_tls_config`` in both packages; a port master and volume server
under mTLS carry heartbeats, an assign, an upload, a lookup and a shell
``ec.encode`` on the CPU codec, while a plaintext client and a client
whose certificate the CA did not sign are refused at once; and the CLI's
``master`` and ``volume``, started in a directory whose ``security.toml``
has ``[grpc.*]`` sections, listen with TLS (the port once ignored the
file) and refuse to start when a named certificate does not load. The
certificates come from the system ``openssl``, as in the JAX test; every
test restores plaintext.
"""

import json
import os
import signal
import subprocess
import sys
import time
import urllib.request

import pytest

from seaweedfs_tpu.security import guard as jax_guard
from seaweedfs_tpu.security import jwt as jax_jwt
from seaweedfs_tpu.security import tls as jax_tls
from seaweedfs_tpu.util.config import Configuration as JaxConfiguration
from seaweedfs_tpu_torch import rpc
from seaweedfs_tpu_torch.operation import operations
from seaweedfs_tpu_torch.operation.file_id import parse_fid
from seaweedfs_tpu_torch.pb import (master_pb2, master_stub,
                                    volume_server_pb2, volume_stub)
from seaweedfs_tpu_torch.security import guard as port_guard
from seaweedfs_tpu_torch.security import jwt as port_jwt
from seaweedfs_tpu_torch.security import tls as port_tls
from seaweedfs_tpu_torch.util.config import Configuration
from tests.test_tls import _gen_certs
from tests.test_torch_cluster import REPO, Cluster, free_port_pair, wait_for

JWTS = {"jax": jax_jwt, "port": port_jwt}


def both(fn, mods):
    want = fn(mods["jax"])
    got = fn(mods["port"])
    assert got == want
    return got


# -- JWT and the guard ---------------------------------------------------------


@pytest.mark.parametrize("key,claims", [
    (b"key", {"fid": "3,01637037d6"}),
    (b"k", {"fid": "1,2", "exp": 1_900_000_000}),
    (b"\x00\xff" * 17, {"sub": "admin", "n": [1, 2.5, None, True],
                        "s": "naïve"}),
    (b"", {}),
])
def test_tokens_equal_jax(key, claims):
    def run(jwt):
        tok = jwt.encode_jwt(key, claims)
        return tok, jwt.decode_jwt(key, tok)

    tok, decoded = both(run, JWTS)
    assert decoded == claims and tok.count(".") == 2


def test_file_id_tokens_equal_jax(monkeypatch):
    monkeypatch.setattr(time, "time", lambda: 1_700_000_000.25)

    def run(jwt):
        tok = jwt.gen_jwt_for_file_id(b"key", 10, "3,01637037d6")
        jwt.verify_file_id_jwt(b"key", tok, "3,01637037d6")
        return (tok, jwt.gen_jwt_for_file_id(b"", 10, "3,1"),
                jwt.gen_jwt_for_file_id(b"k", 0, "3,1"))

    tok, empty, no_exp = both(run, JWTS)
    assert empty == "" and port_jwt.decode_jwt(b"key", tok)["exp"] == \
        1_700_000_010
    assert "exp" not in port_jwt.decode_jwt(b"k", no_exp)
    port_jwt.verify_file_id_jwt(None, "", "3,1")   # no key: no check


def _refusal(jwt, fn):
    try:
        fn()
    except jwt.JwtError as e:
        return str(e)
    return "accepted"


@pytest.mark.parametrize("case", [
    "wrong_key", "expired", "wrong_fid", "no_token", "two_parts",
    "bad_base64", "bad_json", "not_object", "tampered_payload"])
def test_bad_tokens_refused_as_jax(case, monkeypatch):
    monkeypatch.setattr(time, "time", lambda: 1_700_000_000.0)

    def run(jwt):
        good = jwt.encode_jwt(b"k", {"fid": "3,aaa"})
        h, p, s = good.split(".")
        tokens = {
            "wrong_key": lambda: jwt.decode_jwt(b"other", good),
            "expired": lambda: jwt.decode_jwt(b"k", jwt.encode_jwt(
                b"k", {"fid": "1,2", "exp": 1_699_999_999})),
            "wrong_fid": lambda: jwt.verify_file_id_jwt(b"k", good, "3,bbb"),
            "no_token": lambda: jwt.verify_file_id_jwt(b"k", "", "3,aaa"),
            "two_parts": lambda: jwt.decode_jwt(b"k", f"{h}.{p}"),
            "bad_base64": lambda: jwt.decode_jwt(b"k", f"{h}.{p}.!!!"),
            "bad_json": lambda: jwt.decode_jwt(b"k", _signed(
                jwt, b"k", h, "bm90IGpzb24")),
            "not_object": lambda: jwt.decode_jwt(b"k", _signed(
                jwt, b"k", h, "WzEsMl0")),
            "tampered_payload": lambda: jwt.decode_jwt(
                b"k", f"{h}.{p[:-2]}AA.{s}"),
        }
        return _refusal(jwt, tokens[case])

    assert both(run, JWTS) != "accepted"


def _signed(jwt, key, header, payload):
    import base64
    import hashlib
    import hmac
    sig = hmac.new(key, f"{header}.{payload}".encode(),
                   hashlib.sha256).digest()
    return f"{header}.{payload}." + \
        base64.urlsafe_b64encode(sig).rstrip(b"=").decode()


@pytest.mark.parametrize("ip", ["10.1.2.3", "192.168.1.5", "8.8.8.8",
                                "not-an-ip", "host.a", "::1"])
def test_guard_whitelist_decides_as_jax(ip):
    def run(mod):
        g = mod.Guard(whitelist=["10.0.0.0/8", "192.168.1.5", "host.a"])
        open_guard = mod.Guard()
        open_guard.check_whitelist(ip)
        try:
            g.check_whitelist(ip)
            return "allowed", g.is_active, open_guard.is_active
        except mod.AccessDenied as e:
            return str(e), g.is_active, open_guard.is_active

    both(run, {"jax": jax_guard, "port": port_guard})


def test_guard_jwt_gate_as_jax():
    def run(mod):
        g = mod.Guard(signing_key=b"k")
        tok = JWTS["jax" if mod is jax_guard else "port"].encode_jwt(
            b"k", {"sub": "admin"})
        out = [g.check_jwt(f"Bearer {tok}"), mod.Guard().check_jwt("")]
        for header in ("", "Bearer ", "Bearer x.y.z", tok[:-3]):
            try:
                g.check_jwt(header)
                out.append("allowed")
            except mod.AccessDenied as e:
                out.append(str(e))
        return out

    got = both(run, {"jax": jax_guard, "port": port_guard})
    assert got[:2] == [{"sub": "admin"}, {}]
    assert "allowed" not in got[2:]


# -- TLS -----------------------------------------------------------------------


@pytest.fixture(scope="module")
def certs(tmp_path_factory):
    d = tmp_path_factory.mktemp("certs")
    _gen_certs(d)
    return d


def _conf_dict(d, client=True):
    conf = {"ca": str(d / "ca.crt"),
            "master": {"cert": str(d / "server.crt"),
                       "key": str(d / "server.key")},
            "volume": {"cert": str(d / "server.crt"),
                       "key": str(d / "server.key")}}
    if client:
        conf["client"] = {"cert": str(d / "client.crt"),
                          "key": str(d / "client.key")}
    return {"grpc": conf}


@pytest.fixture
def plaintext_after():
    yield
    rpc.set_server_credentials(None)
    rpc.set_channel_credentials(None)


def test_load_tls_config_gating_as_jax(certs):
    """Full sections enable; none, or a partial one (no key, no CA),
    stays plaintext; the same in both packages."""
    full = _conf_dict(certs)
    no_key = {"grpc": {"ca": str(certs / "ca.crt"),
                       "master": {"cert": str(certs / "server.crt")}}}
    no_ca = {"grpc": {"master": full["grpc"]["master"]}}
    cases = [(full, "master"), (full, "volume"), (full, "client"),
             (full, "filer"), ({}, "master"), (no_key, "master"),
             (no_ca, "master")]
    got = [port_tls.load_tls_config(Configuration(c), role).enabled
           for c, role in cases]
    want = [jax_tls.load_tls_config(JaxConfiguration(c), role).enabled
            for c, role in cases]
    assert got == want == [True, True, True, False, False, False, False]
    assert port_tls.load_tls_config(None, "master").enabled is False
    assert port_tls.TlsConfig().server_context() is None


def test_process_tls_without_a_client_section_dials_with_the_role_pair(
        certs, plaintext_after):
    port_tls.configure_process_tls(
        Configuration(_conf_dict(certs, client=False)), "master")
    assert rpc._server_context is not None and \
        rpc._client_context is not None
    port_tls.configure_process_tls(Configuration({}), "master")
    assert rpc._server_context is not None      # nothing was changed
    with pytest.raises(OSError):
        port_tls.configure_process_tls(Configuration({"grpc": {
            "ca": str(certs / "ca.crt"),
            "master": {"cert": str(certs / "missing.crt"),
                       "key": str(certs / "server.key")}}}), "master")


def _foreign_client_context(tmp_path):
    """A client pair from a CA the servers do not trust."""
    tmp_path.mkdir()
    _gen_certs(tmp_path)
    return port_tls.TlsConfig(str(tmp_path / "ca.crt"),
                              str(tmp_path / "client.crt"),
                              str(tmp_path / "client.key")).client_context()


def test_mutual_tls_cluster_roundtrip(certs, tmp_path, plaintext_after):
    """A port cluster under mTLS: heartbeats, assigns, an upload, a
    lookup and shell ec.encode run; a plaintext client and a client with a
    foreign certificate are refused with UNAVAILABLE at once."""
    from seaweedfs_tpu_torch.shell import Shell
    port_tls.configure_process_tls(Configuration(_conf_dict(certs)),
                                   "master")
    c = Cluster(tmp_path / "cluster", n_volume_servers=1)
    try:
        payloads = {operations.upload(c.master.url, os.urandom(900 + i)):
                    None for i in range(6)}
        vid = parse_fid(next(iter(payloads))).volume_id
        for fid in payloads:
            payloads[fid] = operations.download(c.master.url, fid)
        assert operations.lookup(c.master.url, vid) == \
            [c.volume_servers[0].url]
        out = Shell(c.master.url).run_command(f"ec.encode -volumeId={vid}")
        assert f"volume {vid}: ec.encode done" in out
        wait_for(lambda: c.master.topo.lookup_ec(vid), what="ec shards")
        for fid, data in payloads.items():
            if parse_fid(fid).volume_id == vid:
                assert operations.download(c.master.url, fid) == data
        secured = rpc._client_context
        for ctx in (None, _foreign_client_context(tmp_path / "foreign")):
            rpc.set_channel_credentials(ctx)
            t0 = time.monotonic()
            with pytest.raises(rpc.RpcError) as ei:
                master_stub(c.master.url).LookupVolume(
                    master_pb2.LookupVolumeRequest(volume_ids=[str(vid)]),
                    timeout=10)
            assert ei.value.code() == rpc.StatusCode.UNAVAILABLE
            assert time.monotonic() - t0 < 3.0
        rpc.set_channel_credentials(secured)
        assert master_stub(c.master.url).LookupVolume(
            master_pb2.LookupVolumeRequest(volume_ids=[str(vid)])) \
            .volume_id_locations[0].locations
    finally:
        c.stop()


def _spawn(args, cwd, log_path):
    return subprocess.Popen(
        [sys.executable, "-m", "seaweedfs_tpu_torch", *args], cwd=cwd,
        env=dict(os.environ, PYTHONPATH=REPO), stdout=subprocess.DEVNULL,
        stderr=open(log_path, "wb"))


def _write_security_toml(d, conf: dict) -> None:
    lines = [f'[grpc]\nca = "{conf["grpc"]["ca"]}"\n']
    for role in ("master", "volume", "client"):
        if role in conf["grpc"]:
            lines.append(f'[grpc.{role}]\ncert = "{conf["grpc"][role]["cert"]}"'
                         f'\nkey = "{conf["grpc"][role]["key"]}"\n')
    (d / "security.toml").write_text("\n".join(lines))


def test_cli_servers_read_security_toml(certs, tmp_path, plaintext_after):
    """``master`` and ``volume`` started where security.toml has [grpc.*]
    sections: the volume server registers over mTLS, a plaintext client
    is refused, and a client with the CA's pair is answered; both stop
    cleanly on SIGTERM."""
    run = tmp_path / "run"
    run.mkdir()
    _write_security_toml(run, _conf_dict(certs))
    mport, vport = free_port_pair(), free_port_pair()
    murl, vurl = f"127.0.0.1:{mport}", f"127.0.0.1:{vport}"
    procs = [
        _spawn(["master", "-port", str(mport), "-mdir", str(tmp_path / "m"),
                "-pulseSeconds", "0.2"], run, tmp_path / "master.log"),
        _spawn(["volume", "-port", str(vport), "-dir", str(tmp_path / "v"),
                "-mserver", murl, "-pulseSeconds", "0.2",
                "-ec.encoder", "cpu"], run, tmp_path / "volume.log")]
    try:
        def registered():
            try:
                with urllib.request.urlopen(f"http://{murl}/dir/status",
                                            timeout=2) as r:
                    topo = json.load(r)["Topology"]
            except OSError:
                return False
            return any(n["url"] == vurl for dc in topo["data_centers"]
                       for rack in dc["racks"] for n in rack["nodes"])

        wait_for(registered, timeout=60,
                 what="the volume server registered over mTLS")
        for target in (master_stub(murl).LookupVolume,
                       volume_stub(vurl).BatchDelete):
            req = master_pb2.LookupVolumeRequest(volume_ids=["1"]) \
                if target.__name__ == "LookupVolume" else \
                volume_server_pb2.BatchDeleteRequest()
            with pytest.raises(rpc.RpcError) as ei:
                target(req, timeout=10)
            assert ei.value.code() == rpc.StatusCode.UNAVAILABLE
        port_tls.configure_process_tls(Configuration(_conf_dict(certs)),
                                       "client")
        assert master_stub(murl).LookupVolume(
            master_pb2.LookupVolumeRequest(volume_ids=["1"]), timeout=10)
        assert not volume_stub(vurl).BatchDelete(
            volume_server_pb2.BatchDeleteRequest(), timeout=10).results
    finally:
        for p in procs:
            p.send_signal(signal.SIGTERM)
        codes = [p.wait(timeout=30) for p in procs]
    assert codes == [0, 0]
    for name in ("master.log", "volume.log"):
        assert "Traceback" not in (tmp_path / name).read_text()


def test_cli_master_refuses_to_start_without_its_certificate(
        certs, tmp_path):
    """A security.toml naming a certificate that does not exist ends the
    master's start with an error; it never serves in plaintext."""
    run = tmp_path / "run"
    run.mkdir()
    conf = _conf_dict(certs)
    conf["grpc"]["master"]["cert"] = str(tmp_path / "missing.crt")
    _write_security_toml(run, conf)
    port = free_port_pair()
    p = _spawn(["master", "-port", str(port), "-mdir", str(tmp_path / "m")],
               run, tmp_path / "master.log")
    assert p.wait(timeout=60) != 0
    assert "missing.crt" in (tmp_path / "master.log").read_text() or \
        "No such file" in (tmp_path / "master.log").read_text()
