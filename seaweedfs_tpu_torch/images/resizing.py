"""On-the-fly image resize (reference weed/images/resizing.go:17-52).

Same contract as the reference handler: ``width``/``height`` query
params with ``mode`` in {"" (fit within, preserving aspect), "fit"
(letterbox to exact WxH), "fill" (cover + center-crop to exact WxH)}.
Unsupported/undecodable content falls through untouched, exactly like
the reference returns the original bytes on decode failure.
"""

from __future__ import annotations

import io
from typing import Tuple

_FORMATS = {"image/jpeg": "JPEG", "image/png": "PNG", "image/gif": "GIF",
            "image/webp": "WEBP"}


def resized(data: bytes, mime: str, width: int = 0, height: int = 0,
            mode: str = "") -> Tuple[bytes, int, int]:
    """Return (bytes, w, h); original data when no resize applies."""
    if (width <= 0 and height <= 0) or mime not in _FORMATS:
        return data, 0, 0
    try:
        from PIL import Image
    except ImportError:  # image support not in this deployment
        return data, 0, 0
    try:
        img = Image.open(io.BytesIO(data))
        img.load()
    # lint: swallow-ok(unparseable image served as stored, undimensioned)
    except Exception:
        return data, 0, 0
    ow, oh = img.size
    w, h = width or ow, height or oh

    def transform(frame):
        if mode == "fit":
            # letterbox: scale to fit inside, pad to exact WxH
            scaled = frame.copy()
            scaled.thumbnail((w, h))
            canvas = Image.new(frame.mode, (w, h))
            canvas.paste(scaled, ((w - scaled.width) // 2,
                                  (h - scaled.height) // 2))
            return canvas
        if mode == "fill":
            # cover: scale so both dims reach the target, center-crop
            fw, fh = frame.size
            scale = max(w / fw, h / fh)
            scaled = frame.resize((max(1, round(fw * scale)),
                                   max(1, round(fh * scale))))
            left = (scaled.width - w) // 2
            top = (scaled.height - h) // 2
            return scaled.crop((left, top, left + w, top + h))
        # default: fit within the box preserving aspect ratio
        out = frame.copy()
        out.thumbnail((w, h))
        return out

    out = transform(img)
    buf = io.BytesIO()
    fmt = _FORMATS[mime]
    if fmt == "JPEG" and out.mode not in ("RGB", "L"):
        out = out.convert("RGB")
    if fmt == "GIF" and getattr(img, "n_frames", 1) > 1:
        # animated GIF: apply the SAME transform to every frame, keep
        # the animation (the reference resizes frame-by-frame too)
        from PIL import ImageSequence
        frames = [transform(frame.copy())
                  for frame in ImageSequence.Iterator(img)]
        frames[0].save(buf, format="GIF", save_all=True,
                       append_images=frames[1:],
                       duration=img.info.get("duration", 100),
                       loop=img.info.get("loop", 0))
        return buf.getvalue(), frames[0].width, frames[0].height
    out.save(buf, format=fmt)
    return buf.getvalue(), out.width, out.height
