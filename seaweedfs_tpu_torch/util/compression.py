"""Compression-aware data path (reference: weed/util/compression.go).

Stored blobs may be gzipped (or zstd'd) at upload time; the read path
serves compressed bytes directly when the client accepts the encoding,
else decompresses on the fly.
"""

from __future__ import annotations

import gzip
from typing import Tuple

try:
    import zstandard as _zstd
except ImportError:  # pragma: no cover - zstandard is in the image
    _zstd = None

GZIP_MAGIC = b"\x1f\x8b"
ZSTD_MAGIC = b"\x28\xb5\x2f\xfd"

_UNCOMPRESSABLE_EXT = {
    ".zip", ".rar", ".gz", ".bz2", ".xz", ".zst", ".br",
    ".jpg", ".jpeg", ".png", ".gif", ".webp", ".heic",
    ".mp3", ".mp4", ".m4a", ".mkv", ".avi", ".mov", ".ogg",
    ".7z", ".woff", ".woff2",
}

_COMPRESSABLE_EXT = {
    ".txt", ".htm", ".html", ".css", ".js", ".json", ".xml", ".csv",
    ".svg", ".md", ".log", ".conf", ".toml", ".yaml", ".yml", ".pdf",
    ".go", ".py", ".java", ".c", ".cc", ".cpp", ".h", ".ts",
}


def is_gzipped(data: bytes) -> bool:
    return data[:2] == GZIP_MAGIC


def is_zstd(data: bytes) -> bool:
    return data[:4] == ZSTD_MAGIC


def is_compressed(data: bytes) -> bool:
    return is_gzipped(data) or is_zstd(data)


def can_be_compressed(ext: str, mime: str) -> bool:
    """Should this payload be gzip'd before storing?
    Mirrors util.IsCompressableFileType (compression.go)."""
    ext = ext.lower()
    if ext in _UNCOMPRESSABLE_EXT:
        return False
    if ext in _COMPRESSABLE_EXT:
        return True
    if mime.startswith("text/") or mime in (
            "application/json", "application/xml", "application/javascript",
            "application/x-javascript", "image/svg+xml"):
        return True
    if mime.startswith(("image/", "video/", "audio/")):
        return False
    return False


def compress(data: bytes, method: str = "gzip", level: int = 3) -> bytes:
    if method == "zstd" and _zstd is not None:
        return _zstd.ZstdCompressor(level=level).compress(data)
    return gzip.compress(data, compresslevel=level)


def maybe_compress(data: bytes, ext: str = "", mime: str = "") -> Tuple[bytes, bool]:
    """Compress if worthwhile; returns (stored_bytes, is_compressed)."""
    if len(data) < 128 or is_compressed(data):
        return data, False
    if not can_be_compressed(ext, mime):
        return data, False
    out = compress(data)
    if len(out) >= len(data):
        return data, False
    return out, True


def decompress(data: bytes) -> bytes:
    if is_gzipped(data):
        return gzip.decompress(data)
    if is_zstd(data):
        if _zstd is None:  # pragma: no cover
            raise ValueError("zstd data but zstandard module unavailable")
        return _zstd.ZstdDecompressor().decompress(data)
    return data
