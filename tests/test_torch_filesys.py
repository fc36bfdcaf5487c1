"""The port's mount filesystem layer against the JAX package's.

``ContinuousIntervals`` gives the JAX intervals and merged views on
seeded write sequences. On each package's cluster with a filer
(``tests/test_torch_filer_server.py``'s ``make_sides``), one seeded
``Wfs`` script (writes out of order across flushes, reads at ranges,
mkdir, rename, hard links, symlinks, xattrs, truncate, chmod, chown,
utimens, unlink, rmdir and the errors of each) returns the same results
and leaves the same entries in the filer (write times, chunk file ids
and hard-link ids aside) with the same bytes. The meta cache follows
another client's writes and skips the mount's own echo in both. Through
the kernel (skipped where libfuse, /dev/fuse or mount privilege is
missing): a port mount serves plain file calls, and, a difference kept
on purpose, leaves SIGPIPE ignored after it unmounts, where the JAX
mount leaves it at its default action and a later write to a closed
pipe ends the process.
"""

import ctypes
import os
import signal
import subprocess
import sys
import threading
import time
import types

import numpy as np
import pytest

from seaweedfs_tpu.filesys import dirty_pages as jax_dirty
from seaweedfs_tpu.filesys import wfs as jax_wfs
from seaweedfs_tpu.pb import filer_pb2 as jax_pb
from seaweedfs_tpu.pb import filer_stub as jax_filer_stub
from seaweedfs_tpu_torch.filer import http_client as port_http
from seaweedfs_tpu_torch.filesys import dirty_pages as port_dirty
from seaweedfs_tpu_torch.filesys import fuse_shim as port_fuse
from seaweedfs_tpu_torch.filesys import wfs as port_wfs
from seaweedfs_tpu_torch.pb import filer_pb2 as port_pb
from seaweedfs_tpu_torch.pb import filer_stub as port_filer_stub
from tests.test_torch_cluster import REPO, wait_for
from tests.test_torch_filer_server import make_sides

PKGS = {
    "jax": types.SimpleNamespace(name="jax", wfs=jax_wfs, pb=jax_pb,
                                 stub=jax_filer_stub),
    "port": types.SimpleNamespace(name="port", wfs=port_wfs, pb=port_pb,
                                  stub=port_filer_stub),
}
NOW = 1_760_000_000


# -- dirty pages --------------------------------------------------------------


@pytest.mark.parametrize("seed", range(6))
def test_continuous_intervals_equal_jax(seed):
    rng = np.random.default_rng(seed)
    ci = {"jax": jax_dirty.ContinuousIntervals(),
          "port": port_dirty.ContinuousIntervals()}
    span = int(rng.choice([64, 4096, 1 << 20]))
    base = rng.integers(0, 256, int(rng.integers(0, span)),
                        dtype=np.uint8).tobytes()
    for step in range(int(rng.integers(5, 60))):
        off = int(rng.integers(0, span))
        data = rng.integers(0, 256, int(rng.integers(0, span // 4 + 1)),
                            dtype=np.uint8).tobytes()
        for c in ci.values():
            c.add_interval(data, off)
        want = [(iv.offset, iv.data) for iv in ci["jax"].intervals]
        assert [(iv.offset, iv.data) for iv in ci["port"].intervals] == \
            want, step
        assert ci["port"].total_size == ci["jax"].total_size
        for _ in range(3):
            lo = int(rng.integers(0, span))
            n = int(rng.integers(0, span))
            assert ci["port"].read_data(lo, n, base) == \
                ci["jax"].read_data(lo, n, base)
    assert bool(ci["port"]) == bool(ci["jax"])
    popped = [[(iv.offset, iv.data) for iv in c.pop_all()]
              for c in (ci["port"], ci["jax"])]
    assert popped[0] == popped[1]
    assert not ci["port"] and ci["port"].total_size == 0


# -- one Wfs script on each package's cluster ---------------------------------


@pytest.fixture(scope="module")
def sides(tmp_path_factory):
    out, undo = make_sides(tmp_path_factory)
    yield out
    for s in out.values():
        s.stop()
    undo()


class _FrozenWallClock:
    """A stand-in for the wfs module's ``time``: ``time()`` (entry
    times) is frozen; the nanosecond clock (chunk stamps, the meta
    cache's subscription start) runs."""

    def time(self):
        return NOW

    def __getattr__(self, name):
        return getattr(time, name)


def _errno(fn):
    try:
        return ("ok", fn())
    except OSError as e:
        return ("errno", e.errno)


def _script(w, seed):
    """A seeded script of Wfs calls; returns what each call gave."""
    rng = np.random.default_rng(seed)
    out = []
    w.mkdir("/wfs")
    w.mkdir("/wfs/d")
    for i, size in enumerate([1, 3000, 70_000, 300_000]):
        path = f"/wfs/d/f{i}.bin"
        data = rng.integers(0, 256, size, dtype=np.uint8).tobytes()
        fh = w.create(path)
        step = max(1, size // 5)
        pieces = list(range(0, size, step))
        rng.shuffle(pieces)
        for j, off in enumerate(pieces):
            w.write(fh, data[off:off + step], off)
            if j == len(pieces) // 2:
                w.flush(fh)         # half the pieces land in a chunk
        for _ in range(3):
            lo = int(rng.integers(0, size))
            out.append(("read-dirty", w.read(fh, lo, int(
                rng.integers(0, size)))))
        w.release(fh)
    # rewrite inside a flushed file, read across the seam
    fh = w.open("/wfs/d/f2.bin")
    w.write(fh, b"PATCH" * 100, 40_000)
    out.append(("read-patched", w.read(fh, 39_000, 3000)))
    w.release(fh)
    out.append(("getattr-missing", _errno(lambda: w.getattr("/wfs/nope"))))
    out.append(("open-dir", _errno(lambda: w.open("/wfs/d"))))
    w.rename("/wfs/d/f1.bin", "/wfs/d/renamed.bin")
    out.append(("open-old", _errno(lambda: w.open("/wfs/d/f1.bin"))))
    w.link("/wfs/d/f0.bin", "/wfs/d/hard.bin")
    out.append(("link-dir", _errno(lambda: w.link("/wfs/d", "/wfs/d2"))))
    w.symlink("/wfs/d/f3.bin", "/wfs/sym")
    out.append(("readlink", w.readlink("/wfs/sym")))
    out.append(("readlink-file",
                _errno(lambda: w.readlink("/wfs/d/f3.bin"))))
    w.setxattr("/wfs/d/f3.bin", "user.color", b"teal")
    w.setxattr("/wfs/d/f3.bin", "user.shape", b"round")
    out.append(("xattr-create", _errno(lambda: w.setxattr(
        "/wfs/d/f3.bin", "user.color", b"x", w.XATTR_CREATE))))
    out.append(("xattr-replace", _errno(lambda: w.setxattr(
        "/wfs/d/f3.bin", "user.none", b"x", w.XATTR_REPLACE))))
    w.removexattr("/wfs/d/f3.bin", "user.shape")
    out.append(("xattrs", w.listxattr("/wfs/d/f3.bin"),
                w.getxattr("/wfs/d/f3.bin", "user.color")))
    w.truncate("/wfs/d/f3.bin", 150_000)
    out.append(("truncate-dir", _errno(lambda: w.truncate("/wfs/d", 1))))
    w.chmod("/wfs/d/f2.bin", 0o600)
    w.chown("/wfs/d/f2.bin", 1234, 0xFFFFFFFF)
    w.utimens("/wfs/d/f2.bin", 1_234_567_890)
    w.mkdir("/wfs/empty")
    w.mkdir("/wfs/full")
    fh = w.create("/wfs/full/keep.txt")
    w.write(fh, b"precious", 0)
    w.release(fh)
    out.append(("rmdir-full", _errno(lambda: w.rmdir("/wfs/full"))))
    w.rmdir("/wfs/empty")
    w.unlink("/wfs/full/keep.txt")
    out.append(("readdir", sorted(e.name for e in w.readdir("/wfs")),
                sorted(e.name for e in w.readdir("/wfs/d"))))
    return out


def _tree(pkg, filer_url, root="/wfs"):
    """{path: normalized entry bytes} of every entry under root, as the
    filer lists them."""
    stub = pkg.stub(filer_url)
    out = {}

    def walk(d):
        for r in stub.ListEntries(pkg.pb.ListEntriesRequest(
                directory=d, limit=10000)):
            e = r.entry
            kept = [dict(offset=c.offset, size=c.size, e_tag=c.e_tag)
                    for c in e.chunks]
            del e.chunks[:]
            for c in kept:
                e.chunks.add(**c)
            if e.hard_link_id:
                e.hard_link_id = b"H"
            try:
                blob = e.SerializeToString(deterministic=True)
            except TypeError:
                blob = e.SerializeToString()
            out[f"{d}/{e.name}"] = blob
            if e.is_directory:
                walk(f"{d}/{e.name}")
    walk(root)
    return out


def test_wfs_script_equals_jax(sides, monkeypatch):
    out = {}
    for name, side in sides.items():
        pkg = PKGS[name]
        monkeypatch.setattr(pkg.wfs, "time", _FrozenWallClock())
        w = pkg.wfs.Wfs(side.filer.url)
        try:
            results = _script(w, seed=11)
        finally:
            w.stop()
        # a fresh mount with empty caches reads every file back
        w2 = pkg.wfs.Wfs(side.filer.url)
        try:
            reads = {}
            for path in ("/wfs/d/f0.bin", "/wfs/d/hard.bin",
                         "/wfs/d/renamed.bin", "/wfs/d/f2.bin",
                         "/wfs/d/f3.bin"):
                fh = w2.open(path)
                size = w2.handle(fh).size
                reads[path] = (size, w2.read(fh, 0, size + 10),
                               w2.read(fh, size // 3, 5000))
                w2.release(fh)
        finally:
            w2.stop()
        out[name] = (results, _tree(pkg, side.filer.url), reads)
    for i, (a, b) in enumerate(zip(out["port"][0], out["jax"][0])):
        assert a == b, i
    assert out["port"][1] == out["jax"][1]
    assert out["port"][2] == out["jax"][2]
    reads = out["port"][2]
    assert reads["/wfs/d/f3.bin"][0] == 150_000
    assert reads["/wfs/d/f0.bin"][1] == reads["/wfs/d/hard.bin"][1]


def test_meta_cache_follows_others_and_skips_its_own_echo(sides):
    from seaweedfs_tpu.filer import http_client as jax_http
    http = {"jax": jax_http, "port": port_http}
    out = {}
    for name, side in sides.items():
        pkg = PKGS[name]
        w = pkg.wfs.Wfs(side.filer.url)
        try:
            w.mkdir("/mc")
            assert w.readdir("/mc") == []
            # another client writes: the subscription brings it in
            http[name].put(side.filer.url, "/mc/ext.txt", b"external")
            wait_for(lambda: any(e.name == "ext.txt"
                                 for e in w.readdir("/mc")),
                     30, "the meta cache to follow the filer")
            fh = w.create("/mc/own.txt")
            w.write(fh, b"new content", 0)
            w.release(fh)
            fresh = w.getattr("/mc/own.txt")
            stale = pkg.pb.Entry(name="own.txt")
            rec = pkg.pb.SubscribeMetadataResponse(directory="/mc")
            rec.event_notification.new_entry.CopyFrom(stale)
            rec.event_notification.signatures.append(w.signature)
            w.meta_cache._apply(rec)           # its own echo: skipped
            kept = len(w.getattr("/mc/own.txt").chunks) == \
                len(fresh.chunks) == 1
            rec2 = pkg.pb.SubscribeMetadataResponse(directory="/mc")
            rec2.event_notification.new_entry.CopyFrom(stale)
            w.meta_cache._apply(rec2)          # a foreign event applies
            replaced = not w.getattr("/mc/own.txt").chunks
            # a delete by another client leaves the listing
            pkg.stub(side.filer.url).DeleteEntry(pkg.pb.DeleteEntryRequest(
                directory="/mc", name="ext.txt", is_delete_data=True))
            wait_for(lambda: all(e.name != "ext.txt"
                                 for e in w.readdir("/mc")),
                     30, "the delete to reach the meta cache")
            out[name] = (kept, replaced,
                         sorted(e.name for e in w.readdir("/mc")))
        finally:
            w.stop()
    assert out["port"] == out["jax"] == (True, True, ["own.txt"])


# -- through the kernel -------------------------------------------------------


def _sigpipe_handler() -> int:
    """SIGPIPE's current handler (0 SIG_DFL, 1 SIG_IGN), read with libc
    sigaction: the first word of struct sigaction."""
    buf = ctypes.create_string_buffer(256)
    libc = ctypes.CDLL(None, use_errno=True)
    assert libc.sigaction(int(signal.SIGPIPE), None, buf) == 0
    return int.from_bytes(buf.raw[:ctypes.sizeof(ctypes.c_void_p)],
                          sys.byteorder)


def test_kernel_mount_serves_file_calls(sides, tmp_path):
    if not port_fuse.available():
        pytest.skip("libfuse / /dev/fuse not available")
    before = _sigpipe_handler()
    w = port_wfs.Wfs(sides["port"].filer.url)
    mp = str(tmp_path / "mnt")
    os.makedirs(mp)
    m = port_fuse.FuseMount(w, mp, filer_path="/kmount")
    w.mkdir("/kmount")
    t = threading.Thread(target=m.mount, daemon=True)
    t.start()
    deadline = time.monotonic() + 10
    while time.monotonic() < deadline and not os.path.ismount(mp):
        time.sleep(0.1)
    if not os.path.ismount(mp):
        m.unmount()
        t.join(timeout=5)
        w.stop()
        pytest.skip("FUSE mount did not come up (no mount privilege?)")
    try:
        data = os.urandom(300_000)
        with open(f"{mp}/a.bin", "wb") as f:
            f.write(data)
        assert os.listdir(mp) == ["a.bin"]
        with open(f"{mp}/a.bin", "rb") as f:
            assert f.read() == data
        assert os.stat(f"{mp}/a.bin").st_size == len(data)
        os.mkdir(f"{mp}/sub")
        os.rename(f"{mp}/a.bin", f"{mp}/sub/b.bin")
        os.symlink(f"{mp}/sub/b.bin", f"{mp}/s")
        assert os.readlink(f"{mp}/s") == f"{mp}/sub/b.bin"
        os.link(f"{mp}/sub/b.bin", f"{mp}/hard")
        assert os.stat(f"{mp}/hard").st_nlink == 2
        with open(f"{mp}/sub/b.bin", "r+b") as f:
            f.truncate(1000)
        with open(f"{mp}/sub/b.bin", "rb") as f:
            assert f.read() == data[:1000]
        with pytest.raises(FileNotFoundError):
            open(f"{mp}/nope")
        with pytest.raises(OSError):
            os.rmdir(f"{mp}/sub")
        # the filer holds what the kernel wrote
        assert port_http.get(sides["port"].filer.url,
                             "/kmount/sub/b.bin")[1] == data[:1000]
    finally:
        m.unmount()
        t.join(timeout=10)
        w.stop()
    assert not t.is_alive()
    # the mount put the process's SIGPIPE disposition back
    assert _sigpipe_handler() == before == 1


_MOUNT_THEN_WRITE = r"""
import os, sys, threading, time
pkg = sys.argv[1]
mod = __import__(pkg + ".filesys.fuse_shim", fromlist=["x"])
wfs = __import__(pkg + ".filesys.wfs", fromlist=["x"])
w = wfs.Wfs("127.0.0.1:1")
m = mod.FuseMount(w, sys.argv[2])
t = threading.Thread(target=m.mount, daemon=True)
t.start()
deadline = time.monotonic() + 10
while time.monotonic() < deadline and not os.path.ismount(sys.argv[2]):
    time.sleep(0.05)
if not os.path.ismount(sys.argv[2]):
    sys.exit(77)
m.unmount()
t.join(10)
w.meta_cache.stop()
r, wr = os.pipe()
os.close(r)
try:
    os.write(wr, b"x")
except BrokenPipeError:
    sys.exit(0)
sys.exit(3)
"""


def test_sigpipe_stays_ignored_after_a_mount(tmp_path):
    """A difference kept on purpose: after the port's mount returns, a
    write to a closed pipe raises BrokenPipeError (exit 0 here); after
    the JAX mount, SIGPIPE is back at its default action and ends the
    process."""
    if not port_fuse.available():
        pytest.skip("libfuse / /dev/fuse not available")
    rcs = {}
    for pkg in ("seaweedfs_tpu_torch", "seaweedfs_tpu"):
        mp = tmp_path / f"mnt-{pkg}"
        mp.mkdir()
        r = subprocess.run([sys.executable, "-c", _MOUNT_THEN_WRITE, pkg,
                            str(mp)], capture_output=True, timeout=60,
                           env={**os.environ, "PYTHONPATH": REPO,
                                "JAX_PLATFORMS": "cpu"})
        if r.returncode == 77:
            pytest.skip("FUSE mount did not come up (no mount privilege?)")
        rcs[pkg] = r.returncode
    assert rcs == {"seaweedfs_tpu_torch": 0,
                   "seaweedfs_tpu": -signal.SIGPIPE}
