"""The port's filer-free CLI and the filer client tools.

``version`` and ``scaffold -config <each>`` print what the JAX package's
print. ``compact`` (with and without ``-commit``) of the same seeded
volume gives byte-equal ``.cpd``/``.cpx`` and ``.dat``/``.idx`` files in
both packages. ``backup`` of a port volume server's volume gives a
``.dat`` and ``.idx`` byte-equal to the source's, first in full and
then incrementally, and the JAX ``Volume`` reads every needle of it.
Run as subprocesses of the port's CLI: ``filer.copy`` of a local tree,
``filer.cat`` of a chunked file and ``filer.meta.tail`` against a port
filer; ``server -filer`` starts, serves one file and stops on SIGINT
with its ``-cpuprofile`` written; ``master -cpuprofile`` likewise. The
gateways start as subprocesses (``s3 -config``, ``webdav``, ``ftp`` on a
port filer, ``server -s3``), each answers a request and each stops on
SIGINT with exit 0. The parts the port once refused answer as the JAX
package's do: ``mount`` without libfuse exits 1 with the JAX message, a
``notification.toml`` that enables a queue gives the filer the JAX
queue, ``fs.meta.notify`` without one raises the JAX error, and
``msgBroker`` from each package's CLI answers ``FindBroker`` alike (on
SIGINT the port's exits 0, the JAX command 130).
"""

import contextlib
import hashlib
import io
import json
import os
import pstats
import shutil
import signal
import subprocess
import sys
import threading
import time
import urllib.request

import pytest

from seaweedfs_tpu.command import tools as jax_tools
from seaweedfs_tpu.storage.needle import Needle as JaxNeedle
from seaweedfs_tpu.storage.volume import Volume as JaxVolume
from seaweedfs_tpu_torch.command import main as port_main
from seaweedfs_tpu_torch.command import tools as port_tools
from seaweedfs_tpu_torch.operation.file_id import parse_fid
from seaweedfs_tpu_torch.server.filer import FilerServer
from seaweedfs_tpu_torch.storage.needle import Needle
from seaweedfs_tpu_torch.storage.volume import Volume
from tests.test_torch_cluster import REPO, Cluster, free_port_pair, wait_for


def _stdout(fn, args):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = fn(args)
    return rc, buf.getvalue()


def _cli(*args, timeout=60, **kw):
    return subprocess.run([sys.executable, "-m", "seaweedfs_tpu_torch",
                           *args], cwd=kw.pop("cwd", REPO),
                          capture_output=True, timeout=timeout, **kw)


def _sha(path):
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


# -- version, scaffold, compact -----------------------------------------------


def test_version_prints_what_jax_prints():
    assert _stdout(port_tools.run_version, []) == \
        _stdout(jax_tools.run_version, [])


@pytest.mark.parametrize("config", sorted(jax_tools.SCAFFOLDS))
def test_scaffold_prints_what_jax_prints(config, tmp_path):
    assert _stdout(port_tools.run_scaffold, ["-config", config]) == \
        _stdout(jax_tools.run_scaffold, ["-config", config])
    for pkg, tools in (("jax", jax_tools), ("port", port_tools)):
        (tmp_path / pkg).mkdir()
        with contextlib.redirect_stdout(io.StringIO()):
            tools.run_scaffold(["-config", config, "-output",
                                str(tmp_path / pkg)])
    assert _sha(tmp_path / "jax" / f"{config}.toml") == \
        _sha(tmp_path / "port" / f"{config}.toml")


def _seeded_volume(directory, vid=7, collection="c", n=40, step=3):
    v = Volume(directory, collection, vid, async_write=False)
    for i in range(1, n):
        v.write_needle(Needle(id=i, cookie=i * 7, data=bytes([i]) * (i * 97),
                              name=b"n%d" % i, mime=b"a/b"))
    for i in range(1, n, step):
        v.delete_needle(Needle(id=i, cookie=i * 7))
    v.close()


@pytest.mark.parametrize("step", [3, 2, 1000])
def test_compact_gives_the_jax_bytes(tmp_path, step):
    src = tmp_path / "src"
    src.mkdir()
    _seeded_volume(str(src), step=step)
    for pkg in ("jax", "port"):
        shutil.copytree(src, tmp_path / pkg)
    args = ["-volumeId", "7", "-collection", "c"]
    outs = {}
    for pkg, tools in (("jax", jax_tools), ("port", port_tools)):
        rc, text = _stdout(tools.run_compact,
                           ["-dir", str(tmp_path / pkg)] + args)
        outs[pkg] = (rc, text.replace(str(tmp_path / pkg), "DIR"))
    assert outs["port"] == outs["jax"]
    for ext in (".cpd", ".cpx"):
        assert _sha(tmp_path / "jax" / f"c_7{ext}") == \
            _sha(tmp_path / "port" / f"c_7{ext}")
    for pkg, tools in (("jax", jax_tools), ("port", port_tools)):
        rc, text = _stdout(tools.run_compact,
                           ["-dir", str(tmp_path / pkg), "-commit"] + args)
        outs[pkg] = (rc, text)
    assert outs["port"] == outs["jax"] and "committed" in outs["port"][1]
    assert sorted(os.listdir(tmp_path / "port")) == \
        sorted(os.listdir(tmp_path / "jax")) == ["c_7.dat", "c_7.idx"]
    for ext in (".dat", ".idx"):
        assert _sha(tmp_path / "jax" / f"c_7{ext}") == \
            _sha(tmp_path / "port" / f"c_7{ext}")


# -- a port cluster with a filer ----------------------------------------------


@pytest.fixture(scope="module")
def cluster(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("cli")
    c = Cluster(tmp, n_volume_servers=2)
    fs = FilerServer(c.master.url, port=free_port_pair(), store="sqlite",
                     meta_dir=str(tmp / "filer"), chunk_size=1 << 20)
    fs.start()
    c.filer = fs
    yield c
    fs.stop()
    c.stop()


def test_backup_is_byte_equal_to_its_source(cluster, tmp_path):
    fids = [cluster.upload(bytes([i]) * (1000 + i), collection="bk")
            for i in range(20)]
    vid = int(fids[0].split(",")[0])
    src = cluster.server(wait_for(
        lambda: cluster.master.lookup_locations(vid, "bk"))[0][0])
    v = src.store.find_volume(vid)
    for round_ in range(2):
        r = _cli("backup", "-server", cluster.master.url, "-volumeId",
                 str(vid), "-dir", str(tmp_path))
        assert r.returncode == 0, r.stderr.decode()
        base = os.path.join(tmp_path, f"bk_{vid}")
        assert _sha(base + ".dat") == _sha(v.dat_path)
        assert _sha(base + ".idx") == _sha(v.dat_path[:-4] + ".idx")
        # more writes: the second run ships only the delta
        for i in range(5):
            cluster.upload(b"more" * 300, collection="bk")
    jv = JaxVolume(str(tmp_path), "bk", vid, create_if_missing=False)
    try:
        got = 0
        for i, fid in enumerate(fids):
            f = parse_fid(fid)
            if f.volume_id == vid:
                n = jv.read_needle(JaxNeedle(id=f.key, cookie=f.cookie))
                assert n.data == bytes([i]) * (1000 + i)
                got += 1
        assert got
    finally:
        jv.close()


def test_filer_copy_cat_and_meta_tail(cluster, tmp_path):
    src = tmp_path / "tree"
    (src / "sub").mkdir(parents=True)
    files = {"a.txt": b"alpha" * 100, "sub/b.bin": os.urandom(2_500_000),
             "sub/c.pdf": b"pdf"}
    for rel, data in files.items():
        (src / rel).write_bytes(data)
    single = tmp_path / "single.bin"
    single.write_bytes(os.urandom(1_200_000))
    url = f"http://{cluster.filer.url}/dest/"

    tail = subprocess.Popen(
        [sys.executable, "-m", "seaweedfs_tpu_torch", "filer.meta.tail",
         "-filer", cluster.filer.url, "-pathPrefix", "/dest",
         "-timeAgo", "600"],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    lines = []

    def pump():
        for line in tail.stdout:
            lines.append(json.loads(line))

    t = threading.Thread(target=pump, daemon=True)
    t.start()
    try:
        r = _cli("filer.copy", "-maxMB", "1", str(src), str(single), url)
        assert r.returncode == 0, r.stderr.decode()
        r = _cli("filer.copy", "-include", "*.pdf", str(src),
                 f"http://{cluster.filer.url}/pdfs/")
        assert r.returncode == 0, r.stderr.decode()
        for rel, data in list(files.items()) + [("../single.bin", None)]:
            path = f"/dest/tree/{rel}" if data is not None \
                else "/dest/single.bin"
            want = data if data is not None else single.read_bytes()
            with urllib.request.urlopen(
                    f"http://{cluster.filer.url}{path}", timeout=30) as resp:
                assert resp.read() == want
            out = tmp_path / "cat.out"
            r = _cli("filer.cat", "-o", str(out),
                     f"http://{cluster.filer.url}{path}")
            assert r.returncode == 0, r.stderr.decode()
            assert out.read_bytes() == want
        e = cluster.filer.filer.find_entry("/dest/tree/sub/b.bin")
        assert len(e.chunks) == 3
        pdfs = cluster.filer.filer.list_entries("/pdfs/tree/sub")
        assert [x.name for x in pdfs] == ["c.pdf"]
        wait_for(lambda: {"a.txt", "b.bin", "c.pdf", "single.bin"} <=
                 {d.get("new") for d in lines}, timeout=20,
                 what="filer.meta.tail lines")
        assert all(d["op"] == "create" for d in lines
                   if d.get("new") == "a.txt")
    finally:
        tail.send_signal(signal.SIGINT)
        try:
            tail.wait(timeout=15)
        except subprocess.TimeoutExpired:
            tail.kill()
            tail.wait()
    r = _cli("filer.cat", f"http://{cluster.filer.url}/dest/nope")
    assert r.returncode == 1


def _wait_http(url, timeout=60.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        try:
            with urllib.request.urlopen(url, timeout=2):
                return
        except urllib.error.HTTPError:
            return
        except OSError:
            time.sleep(0.2)
    raise TimeoutError(url)


def _stop(proc, timeout=30):
    proc.send_signal(signal.SIGINT)
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        out, err = proc.communicate()
        raise AssertionError(f"did not stop on SIGINT: {err.decode()}")
    return proc.returncode, out, err


def test_server_with_filer_serves_a_file_and_stops_on_sigint(tmp_path):
    ports = [free_port_pair() for _ in range(3)]
    prof = tmp_path / "server.prof"
    proc = subprocess.Popen(
        [sys.executable, "-m", "seaweedfs_tpu_torch", "server", "-filer",
         "-dir", str(tmp_path / "data"), "-master.port", str(ports[0]),
         "-volume.port", str(ports[1]), "-filer.port", str(ports[2]),
         "-ec.encoder", "cpu", "-volume.max", "4",
         "-cpuprofile", str(prof)],
        cwd=str(tmp_path), stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        env={**os.environ, "PYTHONPATH": REPO})
    try:
        filer = f"127.0.0.1:{ports[2]}"
        _wait_http(f"http://{filer}/")
        data = os.urandom(300_000)

        def post():
            req = urllib.request.Request(f"http://{filer}/one/f.bin",
                                         data=data, method="POST")
            with urllib.request.urlopen(req, timeout=30) as r:
                return r.status == 201
        wait_for(lambda: _quiet(post), timeout=60, what="a volume to grow")
        with urllib.request.urlopen(f"http://{filer}/one/f.bin",
                                    timeout=30) as r:
            assert r.read() == data
    finally:
        rc, _, err = _stop(proc)
    assert rc == 0, err.decode()[-2000:]
    assert pstats.Stats(str(prof)).total_calls > 0
    assert os.path.exists(tmp_path / "data" / "filer" / "filer.db")


def _quiet(fn):
    try:
        return fn()
    except OSError:
        return False


def test_master_cpuprofile_is_written_on_sigint(tmp_path):
    port = free_port_pair()
    prof = tmp_path / "master.prof"
    proc = subprocess.Popen(
        [sys.executable, "-m", "seaweedfs_tpu_torch", "master", "-port",
         str(port), "-mdir", str(tmp_path / "m"), "-cpuprofile", str(prof)],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    try:
        _wait_http(f"http://127.0.0.1:{port}/cluster/status")
    finally:
        rc, _, err = _stop(proc)
    assert rc == 0, err.decode()[-2000:]
    assert pstats.Stats(str(prof)).total_calls > 0


# -- the gateways -------------------------------------------------------------


def _ftp_ready(port):
    import socket
    with socket.create_connection(("127.0.0.1", port), timeout=2) as s:
        return s.recv(64).startswith(b"220 ")


def test_gateways_start_answer_and_stop_on_sigint(tmp_path):
    """``s3 -config``, ``webdav`` and ``ftp`` on a port filer, and
    ``server -s3`` on its own: each answers, each exits 0 on SIGINT."""
    c = Cluster(tmp_path / "c", n_volume_servers=1)
    f = FilerServer(c.master.url, port=free_port_pair(),
                    meta_dir=str(tmp_path / "filer"))
    f.start()
    cfg = tmp_path / "iam.json"
    cfg.write_text(json.dumps({"identities": [{
        "name": "admin", "actions": ["Admin"],
        "credentials": [{"accessKey": "AK", "secretKey": "SK"}]}]}))
    ports = [free_port_pair() for _ in range(6)]
    argvs = [["s3", "-filer", f.url, "-port", str(ports[0]),
              "-config", str(cfg)],
             ["webdav", "-filer", f.url, "-port", str(ports[1])],
             ["ftp", "-filer", f.url, "-port", str(ports[2])],
             ["server", "-s3", "-dir", str(tmp_path / "srv"),
              "-master.port", str(ports[3]), "-volume.port", str(ports[4]),
              "-filer.port", str(ports[5]), "-s3.port", str(free_port_pair()),
              "-ec.encoder", "cpu", "-volume.max", "2"]]
    procs = [subprocess.Popen([sys.executable, "-m", "seaweedfs_tpu_torch",
                               *a], cwd=REPO, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE) for a in argvs]
    try:
        from seaweedfs_tpu_torch.util.s3_client import S3Client
        s3 = S3Client(f"127.0.0.1:{ports[0]}", "AK", "SK")
        wait_for(lambda: _answers(lambda: s3.create_bucket("cli")), 60,
                 "s3 to answer")
        s3.put_object("cli", "k", b"through the s3 command")
        assert s3.get_object("cli", "k") == b"through the s3 command"
        with pytest.raises(Exception):
            S3Client(f"127.0.0.1:{ports[0]}", "AK", "bad").get_object(
                "cli", "k")
        _wait_http(f"http://127.0.0.1:{ports[1]}/")
        req = urllib.request.Request(f"http://127.0.0.1:{ports[1]}/",
                                     method="OPTIONS")
        with urllib.request.urlopen(req, timeout=10) as r:
            assert r.headers["DAV"] == "1,2"
        wait_for(lambda: _answers(lambda: _ftp_ready(ports[2])), 60,
                 "ftp to answer")
        s3_port = int(argvs[3][argvs[3].index("-s3.port") + 1])
        srv = S3Client(f"127.0.0.1:{s3_port}", "", "")
        wait_for(lambda: _answers(lambda: srv.create_bucket("one")), 120,
                 "server -s3 to answer")
        srv.put_object("one", "f.bin", b"x" * 1000)
        assert srv.get_object("one", "f.bin") == b"x" * 1000
    finally:
        results = [_stop(p) for p in procs]
        f.stop()
        c.stop()
    for argv, (rc, _, err) in zip(argvs, results):
        assert rc == 0 and b"Traceback" not in err, (argv[0],
                                                     err.decode()[-2000:])


def _answers(fn) -> bool:
    try:
        fn()
        return True
    except OSError:
        return False


# -- the parts once refused ---------------------------------------------------


def test_mount_without_libfuse_exits_1_like_jax(tmp_path, monkeypatch,
                                                capsys):
    from seaweedfs_tpu.command import main as jax_main
    from seaweedfs_tpu.filesys import fuse_shim as jax_fuse
    from seaweedfs_tpu_torch.filesys import fuse_shim as port_fuse
    out = {}
    for name, main, fuse in (("jax", jax_main, jax_fuse),
                             ("port", port_main, port_fuse)):
        monkeypatch.setattr(fuse, "available", lambda: False)
        rc = main(["mount", "-dir", str(tmp_path / "mnt"),
                   "-filer", "127.0.0.1:1"])
        out[name] = (rc, capsys.readouterr().err)
    assert out["port"] == out["jax"]
    assert out["port"][0] == 1 and "libfuse" in out["port"][1]


@pytest.mark.parametrize("section,queue", [
    ("[notification.memory]\nenabled = true\n", "MemoryQueue"),
    ("[notification.log]\nenabled = true\npath = \"LOG\"\n", "LogQueue"),
    ("[notification.memory]\nenabled = false\n", "NoneType"),
], ids=["memory", "log", "disabled"])
def test_filer_takes_the_notification_toml_queue_like_jax(
        section, queue, tmp_path, monkeypatch):
    from seaweedfs_tpu.command import servers as jax_servers
    from seaweedfs_tpu_torch.command import servers as port_servers
    out = {}
    for name, servers in (("jax", jax_servers), ("port", port_servers)):
        cwd = tmp_path / name
        cwd.mkdir()
        (cwd / "notification.toml").write_text(
            section.replace("LOG", str(cwd / "events.log")))
        monkeypatch.chdir(cwd)
        opts = servers._filer_parser().parse_args(
            ["-master", "127.0.0.1:1", "-dir", str(cwd / "f")])
        fs = servers._build_filer(opts)
        q = fs.filer.notification_queue
        out[name] = (type(q).__name__,
                     getattr(q, "path", str(cwd)).replace(str(cwd), "CWD"))
    assert out["port"] == out["jax"]
    assert out["port"][0] == queue


def test_fs_meta_notify_without_a_queue_raises_like_jax(tmp_path,
                                                        monkeypatch):
    from seaweedfs_tpu.shell import CommandError as JaxCommandError
    from seaweedfs_tpu.shell import Shell as JaxShell
    from seaweedfs_tpu_torch.shell import CommandError, Shell
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("HOME", str(tmp_path))
    out = {}
    for name, shell, error in (("jax", JaxShell, JaxCommandError),
                               ("port", Shell, CommandError)):
        sh = shell("127.0.0.1:1", filer_url="127.0.0.1:2")
        with pytest.raises(error) as ei:
            sh.run_command("fs.meta.notify /")
        out[name] = str(ei.value)
    assert out["port"] == out["jax"]
    assert "notification.toml" in out["port"]


def test_msg_broker_cli_answers_like_jax(tmp_path):
    """Each package's msgBroker, started from its CLI with -peers naming
    itself, owns every topic. On SIGINT the port's stops with exit 0, as
    its filer.replicate and filer.sync do; the JAX command exits 130."""
    from seaweedfs_tpu.pb import messaging_pb2 as jax_mpb
    from seaweedfs_tpu.pb import messaging_stub as jax_stub
    from seaweedfs_tpu_torch import rpc
    from seaweedfs_tpu_torch.pb import messaging_pb2 as port_mpb
    from seaweedfs_tpu_torch.pb import messaging_stub as port_stub
    out = {}
    for name, pkg, stub, mpb in (
            ("jax", "seaweedfs_tpu", jax_stub, jax_mpb),
            ("port", "seaweedfs_tpu_torch", port_stub, port_mpb)):
        port = free_port_pair()
        url = f"127.0.0.1:{port}"
        proc = subprocess.Popen(
            [sys.executable, "-m", pkg, "msgBroker", "-port", str(port),
             "-filer", "127.0.0.1:1", "-peers", url], cwd=str(tmp_path),
            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            env={**os.environ, "PYTHONPATH": REPO, "JAX_PLATFORMS": "cpu"})
        try:
            def owners():
                try:
                    return [stub(url).FindBroker(mpb.FindBrokerRequest(
                        namespace="ns", topic=f"t{i}")).broker == url
                            for i in range(4)]
                except Exception:  # noqa: BLE001 — not up yet
                    return None
            answers = wait_for(owners, 90, f"{name} msgBroker to answer")
        finally:
            proc.send_signal(signal.SIGINT)
            try:
                _, err = proc.communicate(timeout=30)
            except subprocess.TimeoutExpired:
                proc.kill()
                _, err = proc.communicate()
        out[name] = (answers, proc.returncode)
        assert b"Traceback" not in err, err.decode()[-2000:]
    rpc.close_channels()
    assert out == {"port": ([True] * 4, 0), "jax": ([True] * 4, 130)}
