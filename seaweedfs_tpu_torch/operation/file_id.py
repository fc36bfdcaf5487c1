"""File id codec: "<vid>,<key_hex><cookie_hex8>".

Reference: weed/storage/needle/file_id.go — key is variable-length hex
with leading zeros stripped, cookie is always the trailing 8 hex chars.
"""

from __future__ import annotations

from typing import NamedTuple


class FileId(NamedTuple):
    volume_id: int
    key: int
    cookie: int

    def __str__(self) -> str:
        return format_fid(self.volume_id, self.key, self.cookie)


def format_fid(volume_id: int, key: int, cookie: int) -> str:
    return f"{volume_id},{key:x}{cookie:08x}"


def parse_fid(fid: str) -> FileId:
    """Accepts "3,01637037d6" and the url form "3/01637037d6"."""
    fid = fid.replace("/", ",", 1)
    vid_str, sep, rest = fid.partition(",")
    if not sep:
        raise ValueError(f"bad file id {fid!r}: missing ','")
    rest = rest.split(".")[0].split("_")[0]  # strip .ext and _appends
    if len(rest) <= 8:
        raise ValueError(f"bad file id {fid!r}: key+cookie too short")
    try:
        return FileId(int(vid_str), int(rest[:-8], 16), int(rest[-8:], 16))
    except ValueError as e:
        raise ValueError(f"bad file id {fid!r}: {e}") from None
