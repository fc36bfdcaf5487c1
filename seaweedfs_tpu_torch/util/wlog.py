"""Leveled logging for every server and tool.

The reference vendors a glog clone (weed/glog: leveled V(n) verbosity,
severity prefixes, log-dir flags).  Here the same surface is built on the
standard-library ``logging`` package: one package-root logger, a glog-style
line format, a process-wide verbosity (DEBUG above 0), and an optional log
file.

Usage::

    from seaweedfs_tpu_torch.util import wlog
    log = wlog.logger("volume")
    log.info("volume server started on %s:%d", ip, port)

Configuration comes from ``wlog.configure()`` (the CLI wires ``-v`` and
``-logFile`` to it) or the ``WEED_V`` environment variable.
"""

from __future__ import annotations

import logging
import os
import sys
import threading
from typing import Optional

_ROOT_NAME = "seaweedfs_tpu_torch"
_FORMAT = "%(levelname).1s%(asctime)s.%(msecs)03d %(name)s] %(message)s"
_DATEFMT = "%m%d %H:%M:%S"

_lock = threading.Lock()
_configured = False
try:
    _verbosity = int(os.environ.get("WEED_V", "0") or 0)
except ValueError:
    _verbosity = 0


def configure(verbosity: Optional[int] = None,
              log_file: Optional[str] = None,
              stderr: bool = True) -> None:
    """Install handlers on the package root logger.  Idempotent; later
    calls replace the handler set (so tests can reconfigure)."""
    global _configured, _verbosity
    with _lock:
        root = logging.getLogger(_ROOT_NAME)
        for h in list(root.handlers):
            root.removeHandler(h)
            h.close()
        fmt = logging.Formatter(_FORMAT, datefmt=_DATEFMT)
        if stderr:
            h = logging.StreamHandler(sys.stderr)
            h.setFormatter(fmt)
            root.addHandler(h)
        if log_file:
            fh = logging.FileHandler(log_file)
            fh.setFormatter(fmt)
            root.addHandler(fh)
        if verbosity is not None:
            _verbosity = verbosity
        root.setLevel(logging.DEBUG if _verbosity > 0 else logging.INFO)
        root.propagate = False
        _configured = True


def _ensure_configured() -> None:
    # Auto-configure only when nobody else set up logging: a host app
    # that installed its own handlers (on our logger or the root) keeps
    # control — we never clobber it from an import side effect.
    # lint: guard-ok(double-checked fast path; a stale False only repeats the idempotent configure)
    if _configured:
        return
    if logging.getLogger(_ROOT_NAME).handlers or logging.getLogger().handlers:
        return
    configure()


def logger(name: str) -> logging.Logger:
    """A child logger, e.g. ``wlog.logger("master")`` →
    ``seaweedfs_tpu_torch.master``."""
    _ensure_configured()
    return logging.getLogger(f"{_ROOT_NAME}.{name}")
