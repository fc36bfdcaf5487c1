"""The multipart/form-data parser of the volume server's upload path
(reference needle_parse_upload.go)."""

from __future__ import annotations

from typing import Dict, Iterator, Tuple


def iter_parts(content_type: str, body: bytes
               ) -> Iterator[Tuple[str, str, Dict[str, str], bytes]]:
    """Yield (field name, filename, part headers lower-cased, data) for
    each part. Quoted boundaries (RFC 2046) are handled; framing CRLFs
    are stripped but content bytes survive untouched. Raises ValueError
    when the content type carries no boundary."""
    boundary = None
    for piece in (content_type or "").split(";"):
        piece = piece.strip()
        if piece.startswith("boundary="):
            boundary = piece[len("boundary="):].strip('"')
    if not boundary:
        raise ValueError("multipart without boundary")
    # RFC 2046: the delimiter is CRLF + "--" + boundary; binary content
    # containing "--boundary" mid-line must NOT split. The first
    # delimiter has no preceding CRLF in the wire form, so prepend one.
    delim = b"\r\n--" + boundary.encode()
    for part in (b"\r\n" + body).split(delim)[1:]:
        if part.startswith(b"--"):
            break  # closing delimiter
        # consume the CRLF that terminates the delimiter line; content
        # bytes survive untouched (the CRLF before the next delimiter
        # was part of the delimiter itself)
        if part.startswith(b"\r\n"):
            part = part[2:]
        header_blob, sep, data = part.partition(b"\r\n\r\n")
        if not sep:
            continue
        headers: Dict[str, str] = {}
        for line in header_blob.split(b"\r\n"):
            k, _, v = line.decode("utf-8", "replace").partition(":")
            headers[k.strip().lower()] = v.strip()
        name = filename = ""
        for item in headers.get("content-disposition", "").split(";")[1:]:
            item = item.strip()
            if item.startswith("name="):
                name = item[len("name="):].strip('"')
            elif item.startswith("filename="):
                filename = item[len("filename="):].strip('"')
        yield name, filename, headers, data
