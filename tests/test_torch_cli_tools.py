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
with its ``-cpuprofile`` written; ``master -cpuprofile`` likewise. Each
part the port does not carry yet (the networked stores, ``s3``,
``webdav``, ``ftp``, ``server -s3``, an enabled ``notification.toml``,
``fs.meta.notify``) answers with an error naming its ROADMAP item.
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


# -- a port cluster with a filer -----------------------------------------------


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


# -- refusals ------------------------------------------------------------------

REFUSALS = [(["filer", "-store", s], "item 13") for s in (
    "redis", "redis_cluster", "redis_cluster2", "etcd", "mongodb",
    "elastic7", "cassandra", "hbase")] + [
    (["s3"], "item 13"), (["webdav"], "item 13"), (["ftp"], "item 13"),
    (["server", "-s3"], "item 13"), (["filer"], "item 14"),
    (["fs.meta.notify", "/"], "item 14"),
]
IDS = [" ".join(a) for a, _ in REFUSALS]
IDS[IDS.index("filer")] = "notification.toml"


@pytest.mark.parametrize("argv,item", REFUSALS, ids=IDS)
def test_unported_parts_name_their_roadmap_item(argv, item, tmp_path,
                                                monkeypatch, capsys):
    """Each part the port does not carry yet: the CLI answers exit 2
    with an error naming its ROADMAP item; the shell command raises one
    (it refuses before it dials anything)."""
    monkeypatch.chdir(tmp_path)
    if argv[0] == "fs.meta.notify":
        from seaweedfs_tpu_torch.shell import CommandError, Shell
        sh = Shell("127.0.0.1:1", filer_url="127.0.0.1:2")
        with pytest.raises(CommandError) as ei:
            sh.run_command(" ".join(argv))
        err = str(ei.value)
    else:
        if argv == ["filer"]:
            (tmp_path / "notification.toml").write_text(
                "[notification.log]\nenabled = true\n")
        rc = port_main(argv + (["-dir", str(tmp_path / "f")]
                               if argv[0] == "filer" else []))
        err = capsys.readouterr().err
        assert rc == 2
    assert f"ROADMAP Queue 1 {item}" in err and "not carried" in err
