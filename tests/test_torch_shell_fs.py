"""The port's fs.* shell and volume.fsck against the JAX package's.

Each package runs its own cluster with a filer (``tests/
test_torch_filer_server.py``'s ``make_sides``) and gets the same
namespace through HTTP PUTs with the entry clock frozen. Every fs.*
command then prints the same text in both shells (chunk file ids and
write times masked where ``fs.meta.cat`` prints them): ``fs.ls`` plain,
``-a``, ``-l`` and by prefix, ``fs.cd``/``fs.pwd``, ``fs.cat``,
``fs.du``, ``fs.tree``, ``fs.mv``, ``fs.configure``, and the errors. A
``fs.meta.save`` file from either package loads in the other.
``volume.fsck`` reports the same orphans (counts and bytes) over normal
volumes, manifests and EC volumes, and ``-reallyDeleteFromVolume``
purges them alike. ``fs.meta.notify`` answers with an error naming its
ROADMAP item; the ``s3.*`` family prints what the JAX shell prints.
"""

import os
import re

import pytest

from seaweedfs_tpu.filer import http_client as jax_http
from seaweedfs_tpu.shell import CommandError as JaxCommandError
from seaweedfs_tpu.shell import Shell as JaxShell
from seaweedfs_tpu_torch.filer import http_client as port_http
from seaweedfs_tpu_torch.shell import CommandError as PortCommandError
from seaweedfs_tpu_torch.shell import Shell as PortShell
from tests.test_torch_cluster import wait_for
from tests.test_torch_filer_server import make_sides

FILES = {
    "/docs/readme.txt": b"hello fs shell",
    "/docs/guide.md": b"# guide\n" * 40,
    "/docs/.hidden": b"secret",
    "/docs/api/spec.json": b'{"v": 1}',
    "/media/logo.png": bytes(range(256)) * 8,
    "/deep/a/b/c/leaf.bin": b"L" * 3000,
}


@pytest.fixture(scope="module")
def shells(tmp_path_factory):
    sides, undo = make_sides(tmp_path_factory)
    http = {"jax": jax_http, "port": port_http}
    out = {}
    for name, s in sides.items():
        for path, data in FILES.items():
            http[name].put(s.filer.url, path, data)
        shell_cls = JaxShell if name == "jax" else PortShell
        out[name] = shell_cls(s.cluster.master.url, filer_url=s.filer.url)
        out[name].side = s
        out[name].http = http[name]
    yield out
    for s in sides.values():
        s.stop()
    undo()


_FID = re.compile(r"\b\d+,[0-9a-f]{8,}\b")


_JAX_RPC_ERROR = re.compile(
    r"_InactiveRpcError: <_InactiveRpcError of RPC that terminated "
    r"with:\n\tstatus = StatusCode\.(\w+)\n\tdetails = \"(.*?)\"",
    re.S)
_PORT_RPC_ERROR = re.compile(r"^RpcError: (\w+): (.*)$", re.S)


def _run(sh, line):
    """("ok", output) or ("error", message); an RPC failure reads as
    "RPC <code>: <details>" in both (the transports' exceptions print
    differently)."""
    try:
        return "ok", sh.run_command(line)
    except (JaxCommandError, PortCommandError) as e:
        text = str(e)
        m = _JAX_RPC_ERROR.search(text) or _PORT_RPC_ERROR.search(text)
        return "error", f"RPC {m.group(1)}: {m.group(2)}" if m else text


def _both(shells, line, mask=False):
    out = {}
    for name, sh in shells.items():
        status, text = _run(sh, line)
        if mask:
            text = _FID.sub("FID", text)
            text = re.sub(r"mtime: \d{15,}", "mtime: NS", text)
            text = re.sub(r"\"mtime\": \d{15,}", "\"mtime\": NS", text)
        out[name] = (status, text)
    assert out["port"] == out["jax"], line
    return out["port"]


@pytest.mark.parametrize("line", [
    "fs.ls /", "fs.ls /docs", "fs.ls -a /docs", "fs.ls -l /docs",
    "fs.ls -la /docs", "fs.ls /docs/read", "fs.ls /docs/readme.txt",
    "fs.ls -z /docs", "fs.ls /nope",
    "fs.cat /docs/readme.txt", "fs.cat /docs", "fs.cat /docs/nope.txt",
    "fs.cat /deep/a/b/c/leaf.bin",
    "fs.du /docs", "fs.du /", "fs.du /deep",
    "fs.tree /", "fs.tree /docs", "fs.tree /deep/a",
    "fs.pwd", "fs.configure",
])
def test_fs_output_equals_jax(shells, line):
    status, text = _both(shells, line)
    if line == "fs.cat /docs/readme.txt":
        assert (status, text) == ("ok", "hello fs shell")


def test_fs_meta_cat_equals_jax_bar_file_ids(shells):
    status, text = _both(shells, "fs.meta.cat /docs/guide.md", mask=True)
    assert status == "ok" and "guide.md" in text


def test_fs_cd_resolves_like_jax(shells):
    for line in ("fs.cd /docs", "fs.pwd", "fs.ls api", "fs.cat readme.txt",
                 "fs.cd api", "fs.pwd", "fs.cd ..", "fs.cd /docs/readme.txt",
                 "fs.cd /", "fs.pwd"):
        _both(shells, line)


def test_fs_mv_equals_jax(shells):
    for name, sh in shells.items():
        sh.http.put(sh.side.filer.url, "/mv/old.txt", b"move me")
    for line in ("fs.mv /mv/old.txt /mv/new.txt", "fs.cat /mv/new.txt",
                 "fs.mv /mv/new.txt /media", "fs.ls /media", "fs.ls /mv",
                 "fs.mv /mv/gone.txt /mv/x.txt", "fs.mv /mv"):
        _both(shells, line)


def test_fs_configure_equals_jax(shells):
    for line in ("fs.configure -locationPrefix=/buckets/b1/ "
                 "-collection=c1 -replication=000",
                 "fs.configure -locationPrefix=/buckets/b1/ "
                 "-collection=c1 -apply",
                 "fs.configure",
                 "fs.configure -locationPrefix=/buckets/b1/ -delete -apply",
                 "fs.configure"):
        _both(shells, line)


@pytest.mark.parametrize("saver,loader", [("jax", "port"),
                                          ("port", "jax")])
def test_meta_save_file_loads_in_the_other_package(shells, tmp_path, saver,
                                                   loader):
    """A snapshot one package saves, the other loads: the subtree comes
    back with every entry (chunks included) equal to the saver's."""
    top = f"/snap-{saver}"
    src = shells[saver]
    dst = shells[loader]
    for i in range(3):
        src.http.put(src.side.filer.url, f"{top}/d{i}/f{i}.bin",
                     bytes([i]) * (1000 + i))
        # the same files on the loader's side too: volume.fsck, later in
        # this module, compares the two clusters' in-use needle counts,
        # and a worker may run only one of the two cases
        dst.http.put(dst.side.filer.url, f"/mirror-{saver}/d{i}/f{i}.bin",
                     bytes([i]) * (1000 + i))
    meta = str(tmp_path / f"{saver}.meta")
    status, text = _run(src, f"fs.meta.save -o {meta} {top}")
    assert status == "ok" and "saved" in text and os.path.exists(meta)
    assert _run(dst, f"fs.ls {top}")[0] == "error"
    status, text = _run(dst, f"fs.meta.load {meta}")
    assert status == "ok" and "loaded" in text, text
    for line in (f"fs.tree {top}", f"fs.ls -l {top}/d1",
                 f"fs.meta.cat {top}/d2/f2.bin", f"fs.du {top}"):
        assert _run(dst, line) == _run(src, line), line


def _orphan_summary(text):
    """(orphan count, orphan bytes, in use) from volume.fsck's total line
    and the sum of its per-volume orphan lines (each cluster assigns the
    needles to volumes of its own choice)."""
    m = re.search(r"total (\d+) in-use, (\d+) orphans \([\d.]+%, (\d+) "
                  r"bytes\)", text)
    assert m, text
    per = sum(int(n) for n in re.findall(r"volume \d+: (\d+) orphan blobs",
                                         text))
    return int(m.group(2)), int(m.group(3)), int(m.group(1)), per


def test_volume_fsck_reports_and_purges_the_same_orphans(shells):
    orphans = [b"O" * 2048, b"P" * 100, b"Q" * 5000]
    for name, sh in shells.items():
        sh.http.put(sh.side.filer.url, "/fsck/good.bin", b"G" * 4096)
        # all three in the volume of one assign: the purge lines name
        # volumes, and each assign picks a writable volume at random
        a = sh.side.cluster.assign()
        vid = a["fid"].split(",")[0]
        for i, data in enumerate(orphans):
            fid = f"{vid},{0x0F5C0000 + i:x}{0x1234ABCD:08x}"
            with sh.side.cluster.http(f"{a['url']}/{fid}", data=data,
                                      method="POST") as r:
                r.read()
    reports = {name: _orphan_summary(sh.run_command("volume.fsck -v"))
               for name, sh in shells.items()}
    assert reports["port"] == reports["jax"]
    assert reports["port"][0] == 3
    for line in ("volume.fsck -reallyDeleteFromVolume",
                 "volume.fsck -reallyDeleteFromVolume -cutoffTimeAgo 0",
                 "volume.fsck"):
        outs = {name: _run(sh, line) for name, sh in shells.items()}
        assert outs["port"][0] == outs["jax"][0] == "ok"
        if "cutoffTimeAgo 0" in line:
            purged = {name: sorted(re.findall(r"purged (\d+/\d+) blobs",
                                              t[1]))
                      for name, t in outs.items()}
            assert purged["port"] == purged["jax"]
            assert sum(int(p.split("/")[0]) for p in purged["port"]) == 3
        elif line == "volume.fsck":
            assert _orphan_summary(outs["port"][1])[:2] == \
                _orphan_summary(outs["jax"][1])[:2] == (0, 0)
        else:
            assert "skip purging" in outs["port"][1]
    for sh in shells.values():
        assert sh.http.get(sh.side.filer.url, "/fsck/good.bin")[1] == \
            b"G" * 4096


def test_volume_fsck_expands_manifests_like_jax(shells):
    out = {}
    for name, sh in shells.items():
        pb = sh.side.pb
        inner, pos = [], 0
        for piece in (b"A" * 1024, b"B" * 2048):
            fid = sh.side.cluster.upload(piece)
            inner.append(pb.FileChunk(file_id=fid, offset=pos,
                                      size=len(piece)))
            pos += len(piece)
        mfid = sh.side.cluster.upload(
            pb.FileChunkManifest(chunks=inner).SerializeToString())
        entry = pb.Entry(
            name="manifested.bin",
            chunks=[pb.FileChunk(file_id=mfid, offset=0, size=pos,
                                 is_chunk_manifest=True)],
            attributes=pb.FuseAttributes(file_size=pos))
        resp = sh.env.filer.CreateEntry(pb.CreateEntryRequest(
            directory="/mfsck", entry=entry))
        assert not resp.error
        out[name] = _orphan_summary(sh.run_command("volume.fsck"))[:2]
    assert out["port"] == out["jax"] == (0, 0)


def test_volume_fsck_covers_ec_volumes_like_jax(shells):
    out = {}
    for name, sh in shells.items():
        sh.http.put(sh.side.filer.url, "/ecfsck/data.bin", b"E" * 40000)
        orphan = sh.side.cluster.upload(b"X" * 3000)
        fid = sh.side.filer.filer.find_entry(
            "/ecfsck/data.bin").chunks[0].file_id
        vids = sorted({int(fid.split(",")[0]), int(orphan.split(",")[0])})
        encoder = "numpy" if name == "jax" else "cpu"
        for vid in vids:
            text = sh.run_command(
                f"ec.encode -volumeId={vid} -encoder={encoder}")
            assert "done" in text or "encoded" in text, text
        master = sh.side.cluster.master
        for vid in vids:
            wait_for(lambda: master.topo.lookup_ec(vid),
                     what="ec registration")
        text = sh.run_command("volume.fsck -v")
        for vid in vids:
            assert f"volume {vid} " in text
        summary = _orphan_summary(text)
        purge = sh.run_command(
            "volume.fsck -reallyDeleteFromVolume -cutoffTimeAgo 0")
        out[name] = (summary[:2], purge.count("skip purging EC volume") > 0,
                     sh.http.get(sh.side.filer.url, "/ecfsck/data.bin")[1])
    assert out["port"] == out["jax"]
    assert out["port"][0][0] == 1 and out["port"][1]
    assert out["port"][2] == b"E" * 40000


@pytest.mark.parametrize("line", ["fs.meta.notify /", "s3.bucket.list",
                                  "s3.bucket.create -name b",
                                  "s3.configure"])
def test_unported_commands_name_their_roadmap_item(shells, line):
    """fs.meta.notify still answers with its ROADMAP item; the s3.*
    family, carried since the gateways, prints what the JAX shell
    prints."""
    if line.startswith("s3."):
        assert shells["port"].run_command(line) == \
            shells["jax"].run_command(line)
        return
    with pytest.raises(PortCommandError,
                       match=r"ROADMAP Queue 1 item 1[34]"):
        shells["port"].run_command(line)


def test_fs_needs_a_filer_in_both(shells):
    for cls, err in ((JaxShell, JaxCommandError),
                     (PortShell, PortCommandError)):
        sh = cls(shells["port"].side.cluster.master.url)
        with pytest.raises(err, match="no filer configured"):
            sh.run_command("fs.ls /")
