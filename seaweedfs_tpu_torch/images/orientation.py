"""EXIF orientation normalization (reference weed/images/orientation.go).

JPEGs carrying an EXIF Orientation tag are rewritten upright before
serving/resizing, so downstream consumers never see rotated pixels.
Anything undecodable passes through untouched.
"""

from __future__ import annotations

import io


def fix_orientation(data: bytes, mime: str = "image/jpeg") -> bytes:
    if mime != "image/jpeg":
        return data
    try:
        from PIL import Image, ImageOps
    except ImportError:
        return data
    try:
        img = Image.open(io.BytesIO(data))
        orientation = img.getexif().get(274, 1)  # 274 = Orientation
        if orientation not in range(2, 9):
            return data  # upright or corrupt tag: never re-encode
        # exif_transpose implements the full 8-state orientation table
        # (incl. the transpose/transverse cases 5 and 7) and clears the
        # tag on the result
        out = ImageOps.exif_transpose(img)
        buf = io.BytesIO()
        out.save(buf, format="JPEG", exif=out.getexif().tobytes())
        return buf.getvalue()
    # lint: swallow-ok(unparseable/untransposable image served as stored)
    except Exception:
        return data
