"""ctypes binding to libfuse 2.x driving the Wfs filesystem library.

The reference mounts through bazil.org/fuse
(weed/filesys/wfs.go:55-240); here the kernel boundary
is the high-level libfuse C API (fuse_main_real with a
fuse_operations table), bound with ctypes — no extension module to
build, and the binding degrades to unavailable() where libfuse or
/dev/fuse is missing (the library layer keeps working regardless).

ABI notes: struct layouts are the FUSE_USE_VERSION 26 (libfuse 2.9)
ones on Linux x86_64. fuse_main_real copies only op_size bytes of the
operations table, so the struct here is truncated after the fields we
fill — the tail behaves as NULL (libfuse memsets its copy).

The port of ``seaweedfs_tpu_torch.filesys.fuse_shim``, with one difference
kept on purpose: libfuse's signal handling leaves SIGPIPE at its default
action when ``fuse_main_real`` returns, after which a send to a peer
that hung up ends the whole process. ``FuseMount.mount`` saves the
process's SIGPIPE disposition before the main loop and puts it back
after, through libc ``sigaction`` (the mount runs off the main thread,
where Python's ``signal`` module cannot act).
"""

from __future__ import annotations

import ctypes
import ctypes.util
import errno
import os
import signal
import stat as stat_mod
import subprocess
from typing import Optional

from seaweedfs_tpu_torch.filesys.wfs import FuseError, Wfs
from seaweedfs_tpu_torch.util import wlog

log = wlog.logger("fuse")


def _find_libfuse() -> Optional[str]:
    name = ctypes.util.find_library("fuse")
    if name:
        return name
    for cand in ("libfuse.so.2", "libfuse.so"):
        try:
            ctypes.CDLL(cand)
            return cand
        except OSError:
            continue
    return None


def available() -> bool:
    return _find_libfuse() is not None and os.path.exists("/dev/fuse")


c_time_t = ctypes.c_long
c_off_t = ctypes.c_long


class Timespec(ctypes.Structure):
    _fields_ = [("tv_sec", c_time_t), ("tv_nsec", ctypes.c_long)]


class Stat(ctypes.Structure):
    """struct stat, Linux x86_64 layout."""

    _fields_ = [
        ("st_dev", ctypes.c_ulong),
        ("st_ino", ctypes.c_ulong),
        ("st_nlink", ctypes.c_ulong),
        ("st_mode", ctypes.c_uint),
        ("st_uid", ctypes.c_uint),
        ("st_gid", ctypes.c_uint),
        ("__pad0", ctypes.c_int),
        ("st_rdev", ctypes.c_ulong),
        ("st_size", c_off_t),
        ("st_blksize", ctypes.c_long),
        ("st_blocks", ctypes.c_long),
        ("st_atim", Timespec),
        ("st_mtim", Timespec),
        ("st_ctim", Timespec),
        ("__unused", ctypes.c_long * 3),
    ]


class FuseFileInfo(ctypes.Structure):
    """struct fuse_file_info, libfuse 2.9."""

    _fields_ = [
        ("flags", ctypes.c_int),
        ("fh_old", ctypes.c_ulong),
        ("writepage", ctypes.c_int),
        ("bits", ctypes.c_uint),      # direct_io:1 keep_cache:1 ... :27
        ("fh", ctypes.c_uint64),
        ("lock_owner", ctypes.c_uint64),
    ]


_FILL_DIR_T = ctypes.CFUNCTYPE(
    ctypes.c_int, ctypes.c_void_p, ctypes.c_char_p,
    ctypes.POINTER(Stat), c_off_t)

_GETATTR_T = ctypes.CFUNCTYPE(
    ctypes.c_int, ctypes.c_char_p, ctypes.POINTER(Stat))
_READLINK_T = ctypes.CFUNCTYPE(
    ctypes.c_int, ctypes.c_char_p, ctypes.POINTER(ctypes.c_char),
    ctypes.c_size_t)
_GETDIR_T = ctypes.CFUNCTYPE(ctypes.c_int)          # deprecated, unused
_MKNOD_T = ctypes.CFUNCTYPE(
    ctypes.c_int, ctypes.c_char_p, ctypes.c_uint, ctypes.c_ulong)
_MKDIR_T = ctypes.CFUNCTYPE(ctypes.c_int, ctypes.c_char_p, ctypes.c_uint)
_UNLINK_T = ctypes.CFUNCTYPE(ctypes.c_int, ctypes.c_char_p)
_RMDIR_T = ctypes.CFUNCTYPE(ctypes.c_int, ctypes.c_char_p)
_SYMLINK_T = ctypes.CFUNCTYPE(
    ctypes.c_int, ctypes.c_char_p, ctypes.c_char_p)
_RENAME_T = ctypes.CFUNCTYPE(
    ctypes.c_int, ctypes.c_char_p, ctypes.c_char_p)
_LINK_T = ctypes.CFUNCTYPE(ctypes.c_int, ctypes.c_char_p, ctypes.c_char_p)
_CHMOD_T = ctypes.CFUNCTYPE(ctypes.c_int, ctypes.c_char_p, ctypes.c_uint)
_CHOWN_T = ctypes.CFUNCTYPE(
    ctypes.c_int, ctypes.c_char_p, ctypes.c_uint, ctypes.c_uint)
_TRUNCATE_T = ctypes.CFUNCTYPE(ctypes.c_int, ctypes.c_char_p, c_off_t)
_UTIME_T = ctypes.CFUNCTYPE(
    ctypes.c_int, ctypes.c_char_p, ctypes.c_void_p)
_OPEN_T = ctypes.CFUNCTYPE(
    ctypes.c_int, ctypes.c_char_p, ctypes.POINTER(FuseFileInfo))
_READ_T = ctypes.CFUNCTYPE(
    ctypes.c_int, ctypes.c_char_p, ctypes.POINTER(ctypes.c_char),
    ctypes.c_size_t, c_off_t, ctypes.POINTER(FuseFileInfo))
_WRITE_T = ctypes.CFUNCTYPE(
    ctypes.c_int, ctypes.c_char_p, ctypes.POINTER(ctypes.c_char),
    ctypes.c_size_t, c_off_t, ctypes.POINTER(FuseFileInfo))
_STATFS_T = ctypes.CFUNCTYPE(
    ctypes.c_int, ctypes.c_char_p, ctypes.c_void_p)
_FLUSH_T = ctypes.CFUNCTYPE(
    ctypes.c_int, ctypes.c_char_p, ctypes.POINTER(FuseFileInfo))
_RELEASE_T = ctypes.CFUNCTYPE(
    ctypes.c_int, ctypes.c_char_p, ctypes.POINTER(FuseFileInfo))
_FSYNC_T = ctypes.CFUNCTYPE(
    ctypes.c_int, ctypes.c_char_p, ctypes.c_int,
    ctypes.POINTER(FuseFileInfo))
_SETXATTR_T = ctypes.CFUNCTYPE(
    ctypes.c_int, ctypes.c_char_p, ctypes.c_char_p,
    ctypes.POINTER(ctypes.c_char), ctypes.c_size_t, ctypes.c_int)
_GETXATTR_T = ctypes.CFUNCTYPE(
    ctypes.c_int, ctypes.c_char_p, ctypes.c_char_p,
    ctypes.POINTER(ctypes.c_char), ctypes.c_size_t)
_LISTXATTR_T = ctypes.CFUNCTYPE(
    ctypes.c_int, ctypes.c_char_p,
    ctypes.POINTER(ctypes.c_char), ctypes.c_size_t)
_REMOVEXATTR_T = ctypes.CFUNCTYPE(
    ctypes.c_int, ctypes.c_char_p, ctypes.c_char_p)
_OPENDIR_T = ctypes.CFUNCTYPE(
    ctypes.c_int, ctypes.c_char_p, ctypes.POINTER(FuseFileInfo))
_READDIR_T = ctypes.CFUNCTYPE(
    ctypes.c_int, ctypes.c_char_p, ctypes.c_void_p, _FILL_DIR_T,
    c_off_t, ctypes.POINTER(FuseFileInfo))
_RELEASEDIR_T = ctypes.CFUNCTYPE(
    ctypes.c_int, ctypes.c_char_p, ctypes.POINTER(FuseFileInfo))
_FSYNCDIR_T = ctypes.CFUNCTYPE(ctypes.c_int)
_INIT_T = ctypes.CFUNCTYPE(ctypes.c_void_p, ctypes.c_void_p)
_DESTROY_T = ctypes.CFUNCTYPE(None, ctypes.c_void_p)
_ACCESS_T = ctypes.CFUNCTYPE(ctypes.c_int, ctypes.c_char_p, ctypes.c_int)
_CREATE_T = ctypes.CFUNCTYPE(
    ctypes.c_int, ctypes.c_char_p, ctypes.c_uint,
    ctypes.POINTER(FuseFileInfo))
_FTRUNCATE_T = ctypes.CFUNCTYPE(
    ctypes.c_int, ctypes.c_char_p, c_off_t,
    ctypes.POINTER(FuseFileInfo))
_FGETATTR_T = ctypes.CFUNCTYPE(
    ctypes.c_int, ctypes.c_char_p, ctypes.POINTER(Stat),
    ctypes.POINTER(FuseFileInfo))
_LOCK_T = ctypes.CFUNCTYPE(ctypes.c_int)
_UTIMENS_T = ctypes.CFUNCTYPE(
    ctypes.c_int, ctypes.c_char_p, ctypes.POINTER(Timespec))


class FuseOperations(ctypes.Structure):
    """fuse_operations (FUSE 2.9 field order), truncated after utimens
    — fuse_main_real(op_size) treats the missing tail as NULL."""

    _fields_ = [
        ("getattr", _GETATTR_T),
        ("readlink", _READLINK_T),
        ("getdir", _GETDIR_T),
        ("mknod", _MKNOD_T),
        ("mkdir", _MKDIR_T),
        ("unlink", _UNLINK_T),
        ("rmdir", _RMDIR_T),
        ("symlink", _SYMLINK_T),
        ("rename", _RENAME_T),
        ("link", _LINK_T),
        ("chmod", _CHMOD_T),
        ("chown", _CHOWN_T),
        ("truncate", _TRUNCATE_T),
        ("utime", _UTIME_T),
        ("open", _OPEN_T),
        ("read", _READ_T),
        ("write", _WRITE_T),
        ("statfs", _STATFS_T),
        ("flush", _FLUSH_T),
        ("release", _RELEASE_T),
        ("fsync", _FSYNC_T),
        ("setxattr", _SETXATTR_T),
        ("getxattr", _GETXATTR_T),
        ("listxattr", _LISTXATTR_T),
        ("removexattr", _REMOVEXATTR_T),
        ("opendir", _OPENDIR_T),
        ("readdir", _READDIR_T),
        ("releasedir", _RELEASEDIR_T),
        ("fsyncdir", _FSYNCDIR_T),
        ("init", _INIT_T),
        ("destroy", _DESTROY_T),
        ("access", _ACCESS_T),
        ("create", _CREATE_T),
        ("ftruncate", _FTRUNCATE_T),
        ("fgetattr", _FGETATTR_T),
        ("lock", _LOCK_T),
        ("utimens", _UTIMENS_T),
    ]


# struct sigaction is 152 bytes on Linux x86_64 (140 on aarch64); the
# disposition is only read and written back, so an opaque buffer serves
_SIGACTION_BYTES = 256


class _SigpipeDisposition:
    """SIGPIPE's disposition, saved by ``save()`` and put back by
    ``restore()`` with libc ``sigaction``, from any thread."""

    def __init__(self):
        self._libc = ctypes.CDLL(None, use_errno=True)
        self._saved = ctypes.create_string_buffer(_SIGACTION_BYTES)

    def _sigaction(self, new, old) -> None:
        if self._libc.sigaction(int(signal.SIGPIPE), new, old) != 0:
            err = ctypes.get_errno()
            raise OSError(err, os.strerror(err))

    def save(self) -> None:
        self._sigaction(None, self._saved)

    def restore(self) -> None:
        self._sigaction(self._saved, None)


def _errno_of(e: BaseException) -> int:
    if isinstance(e, FuseError):
        return -(e.errno or errno.EIO)
    if isinstance(e, OSError) and e.errno:
        return -e.errno
    return -errno.EIO


class FuseMount:
    """One mounted Wfs. mount() blocks until unmounted (run it on a
    thread for programmatic use); unmount() detaches via fusermount."""

    def __init__(self, wfs: Wfs, mountpoint: str,
                 filer_path: str = "/", fsname: str = "seaweedfs"):
        libname = _find_libfuse()
        if libname is None:
            raise RuntimeError("libfuse not found")
        self.lib = ctypes.CDLL(libname)
        self.wfs = wfs
        self.mountpoint = os.path.abspath(mountpoint)
        self.root = "" if filer_path == "/" else filer_path.rstrip("/")
        self.fsname = fsname
        self.ops = self._build_ops()
        self._exit_code: Optional[int] = None

    # -- path + attr mapping -------------------------------------------------

    def _p(self, raw: bytes) -> str:
        p = raw.decode("utf-8", "replace")
        full = self.root + ("" if p == "/" and self.root else p)
        return full or "/"

    def _fill_stat(self, entry, st: "ctypes.POINTER(Stat)") -> None:
        ctypes.memset(st, 0, ctypes.sizeof(Stat))
        a = entry.attributes
        mode = a.file_mode & 0o7777 or (0o755 if entry.is_directory
                                        else 0o644)
        if entry.is_directory:
            st.contents.st_mode = stat_mod.S_IFDIR | mode
            st.contents.st_nlink = 2
        elif stat_mod.S_ISLNK(a.file_mode):
            st.contents.st_mode = stat_mod.S_IFLNK | mode
            st.contents.st_nlink = 1
            st.contents.st_size = len(a.symlink_target.encode())
        else:
            from seaweedfs_tpu_torch.filer import filechunks
            st.contents.st_mode = stat_mod.S_IFREG | mode
            st.contents.st_nlink = max(1, entry.hard_link_counter)
            # max EXTENT, not sum: overlapping rewrite chunks cover the
            # same byte range and must not inflate the size
            st.contents.st_size = max(
                a.file_size, filechunks.total_size(entry.chunks))
        st.contents.st_uid = a.uid or os.getuid()
        st.contents.st_gid = a.gid or os.getgid()
        st.contents.st_mtim.tv_sec = a.mtime
        st.contents.st_ctim.tv_sec = a.crtime or a.mtime
        st.contents.st_atim.tv_sec = a.mtime
        st.contents.st_blksize = 512
        st.contents.st_blocks = (st.contents.st_size + 511) // 512

    # -- callbacks -----------------------------------------------------------

    def _build_ops(self) -> FuseOperations:
        shim = self

        def op_getattr(path, st):
            try:
                shim._fill_stat(shim.wfs.getattr(shim._p(path)), st)
                return 0
            except BaseException as e:
                return _errno_of(e)

        def op_readdir(path, buf, fill, offset, fi):
            try:
                for name in (".", ".."):
                    fill(buf, name.encode(), None, 0)
                for entry in shim.wfs.readdir(shim._p(path)):
                    fill(buf, entry.name.encode(), None, 0)
                return 0
            except BaseException as e:
                return _errno_of(e)

        def op_open(path, fi):
            try:
                fi.contents.fh = shim.wfs.open(shim._p(path))
                return 0
            except BaseException as e:
                return _errno_of(e)

        def op_create(path, mode, fi):
            try:
                fi.contents.fh = shim.wfs.create(shim._p(path),
                                                 mode & 0o7777)
                return 0
            except BaseException as e:
                return _errno_of(e)

        def op_read(path, buf, size, offset, fi):
            try:
                data = shim.wfs.read(fi.contents.fh, offset, size)
                ctypes.memmove(buf, data, len(data))
                return len(data)
            except BaseException as e:
                return _errno_of(e)

        def op_write(path, buf, size, offset, fi):
            try:
                data = ctypes.string_at(buf, size)
                return shim.wfs.write(fi.contents.fh, data, offset)
            except BaseException as e:
                return _errno_of(e)

        def op_flush(path, fi):
            try:
                shim.wfs.flush(fi.contents.fh)
                return 0
            except BaseException as e:
                return _errno_of(e)

        def op_release(path, fi):
            try:
                shim.wfs.release(fi.contents.fh)
                return 0
            except BaseException as e:
                return _errno_of(e)

        def op_fsync(path, datasync, fi):
            return op_flush(path, fi)

        def op_mkdir(path, mode):
            try:
                shim.wfs.mkdir(shim._p(path), mode & 0o7777)
                return 0
            except BaseException as e:
                return _errno_of(e)

        def op_unlink(path):
            try:
                shim.wfs.unlink(shim._p(path))
                return 0
            except BaseException as e:
                return _errno_of(e)

        def op_rmdir(path):
            try:
                shim.wfs.rmdir(shim._p(path))
                return 0
            except BaseException as e:
                return _errno_of(e)

        def op_rename(old, new):
            try:
                shim.wfs.rename(shim._p(old), shim._p(new))
                return 0
            except BaseException as e:
                return _errno_of(e)

        def op_truncate(path, length):
            try:
                shim.wfs.truncate(shim._p(path), length)
                return 0
            except BaseException as e:
                return _errno_of(e)

        def op_chmod(path, mode):
            try:
                shim.wfs.chmod(shim._p(path), mode & 0o7777)
                return 0
            except BaseException as e:
                return _errno_of(e)

        UTIME_NOW = (1 << 30) - 1
        UTIME_OMIT = (1 << 30) - 2

        def op_utimens(path, times):
            try:
                if times:
                    # times points at [atime, mtime]; libfuse2 passes
                    # the sentinels in tv_nsec (utimensat(2)): OMIT
                    # leaves mtime alone, NOW means "current time" with
                    # tv_sec left 0 — reading tv_sec verbatim would
                    # stamp files back to 1970 on every `touch`
                    nsec = times[1].tv_nsec
                    if nsec == UTIME_OMIT:
                        return 0
                    import time as _time
                    mtime = int(_time.time()) if nsec == UTIME_NOW \
                        else times[1].tv_sec
                    shim.wfs.utimens(shim._p(path), mtime)
                return 0
            except BaseException as e:
                return _errno_of(e)

        def op_chown(path, uid, gid):
            try:
                shim.wfs.chown(shim._p(path), uid, gid)
                return 0
            except BaseException as e:
                return _errno_of(e)

        def op_symlink(target, path):
            # note the argument order: (target, linkpath)
            try:
                shim.wfs.symlink(target.decode("utf-8", "replace"),
                                 shim._p(path))
                return 0
            except BaseException as e:
                return _errno_of(e)

        def op_readlink(path, buf, size):
            try:
                target = shim.wfs.readlink(shim._p(path)).encode()
                n = min(len(target), size - 1)
                ctypes.memmove(buf, target, n)
                buf[n] = b"\x00"
                return 0
            except BaseException as e:
                return _errno_of(e)

        def op_link(old, new):
            try:
                shim.wfs.link(shim._p(old), shim._p(new))
                return 0
            except BaseException as e:
                return _errno_of(e)

        def op_setxattr(path, name, value, size, flags):
            try:
                shim.wfs.setxattr(
                    shim._p(path), name.decode("utf-8", "replace"),
                    ctypes.string_at(value, size), flags)
                return 0
            except BaseException as e:
                return _errno_of(e)

        def op_getxattr(path, name, buf, size):
            try:
                data = shim.wfs.getxattr(
                    shim._p(path), name.decode("utf-8", "replace"))
                if size == 0:
                    return len(data)  # probe call: report needed size
                if len(data) > size:
                    return -errno.ERANGE
                ctypes.memmove(buf, data, len(data))
                return len(data)
            except BaseException as e:
                return _errno_of(e)

        def op_listxattr(path, buf, size):
            try:
                names = shim.wfs.listxattr(shim._p(path))
                blob = b"".join(n.encode() + b"\x00" for n in names)
                if size == 0:
                    return len(blob)
                if len(blob) > size:
                    return -errno.ERANGE
                if blob:
                    ctypes.memmove(buf, blob, len(blob))
                return len(blob)
            except BaseException as e:
                return _errno_of(e)

        def op_removexattr(path, name):
            try:
                shim.wfs.removexattr(
                    shim._p(path), name.decode("utf-8", "replace"))
                return 0
            except BaseException as e:
                return _errno_of(e)

        def op_access(path, mask):
            try:
                shim.wfs.getattr(shim._p(path))
                return 0
            except BaseException as e:
                return _errno_of(e)

        ops = FuseOperations()
        ops.getattr = _GETATTR_T(op_getattr)
        ops.readdir = _READDIR_T(op_readdir)
        ops.open = _OPEN_T(op_open)
        ops.create = _CREATE_T(op_create)
        ops.read = _READ_T(op_read)
        ops.write = _WRITE_T(op_write)
        ops.flush = _FLUSH_T(op_flush)
        ops.release = _RELEASE_T(op_release)
        ops.fsync = _FSYNC_T(op_fsync)
        ops.mkdir = _MKDIR_T(op_mkdir)
        ops.unlink = _UNLINK_T(op_unlink)
        ops.rmdir = _RMDIR_T(op_rmdir)
        ops.rename = _RENAME_T(op_rename)
        ops.truncate = _TRUNCATE_T(op_truncate)
        ops.chmod = _CHMOD_T(op_chmod)
        ops.chown = _CHOWN_T(op_chown)
        ops.utimens = _UTIMENS_T(op_utimens)
        ops.access = _ACCESS_T(op_access)
        ops.symlink = _SYMLINK_T(op_symlink)
        ops.readlink = _READLINK_T(op_readlink)
        ops.link = _LINK_T(op_link)
        ops.setxattr = _SETXATTR_T(op_setxattr)
        ops.getxattr = _GETXATTR_T(op_getxattr)
        ops.listxattr = _LISTXATTR_T(op_listxattr)
        ops.removexattr = _REMOVEXATTR_T(op_removexattr)
        return ops

    # -- mount lifecycle -----------------------------------------------------

    def mount(self, foreground: bool = True,
              allow_other: bool = False) -> int:
        """Run the FUSE main loop; blocks until unmount. Returns the
        libfuse exit code (0 = clean)."""
        args = [b"seaweedfs-mount", self.mountpoint.encode(), b"-f",
                b"-s",  # single-threaded loop: Wfs handles its own locks
                # no kernel attr/entry caching: metadata changes made
                # through ANOTHER name (hard-link bumping the original's
                # nlink, write-through-one-name) must be visible on the
                # next stat, not after the default 1s attr timeout
                b"-o", b"attr_timeout=0,entry_timeout=0",
                b"-o", f"fsname={self.fsname}".encode()]
        if allow_other:
            args += [b"-o", b"allow_other"]
        argv = (ctypes.c_char_p * len(args))(*args)
        log.info("mounting %s at %s", self.fsname, self.mountpoint)
        sigpipe = _SigpipeDisposition()
        sigpipe.save()
        try:
            self._exit_code = self.lib.fuse_main_real(
                len(args), argv, ctypes.byref(self.ops),
                ctypes.sizeof(self.ops), None)
        finally:
            # libfuse leaves SIGPIPE at SIG_DFL on its way out
            sigpipe.restore()
        log.info("unmounted %s (exit %s)", self.mountpoint,
                 self._exit_code)
        return self._exit_code

    def unmount(self) -> None:
        subprocess.run(["fusermount", "-u", "-z", self.mountpoint],
                       capture_output=True)
