"""Image resizing on the port's read path, against the JAX package's.

``seaweedfs_tpu_torch/images`` is a copy of ``seaweedfs_tpu/images``:
``resized`` and ``fix_orientation`` give the JAX functions' bytes on the
same seeded images. A port volume server answers an image GET with
``width``/``height`` (``mode`` fit or fill; a gzip-stored image is
inflated first; a JPEG with an EXIF orientation tag is turned upright
first) with the JAX volume server's bytes, the Date line aside. Without
PIL both packages serve the stored bytes.
"""

import gzip
import io
import sys
import urllib.request

import numpy as np
import pytest

from seaweedfs_tpu import images as jax_images
from seaweedfs_tpu_torch import images
from tests.test_torch_cluster import Cluster


def _jpeg(w=64, h=32, orientation=None, seed=None) -> bytes:
    from PIL import Image
    if seed is None:
        img = Image.new("RGB", (w, h), (200, 10, 10))
    else:
        px = np.random.default_rng(seed).integers(0, 256, (h, w, 3),
                                                  dtype=np.uint8)
        img = Image.fromarray(px, "RGB")
    buf = io.BytesIO()
    if orientation:
        exif = Image.Exif()
        exif[274] = orientation
        img.save(buf, format="JPEG", exif=exif.tobytes())
    else:
        img.save(buf, format="JPEG")
    return buf.getvalue()


def _png(w=40, h=30, seed=3) -> bytes:
    from PIL import Image
    px = np.random.default_rng(seed).integers(0, 256, (h, w, 4),
                                              dtype=np.uint8)
    buf = io.BytesIO()
    Image.fromarray(px, "RGBA").save(buf, format="PNG")
    return buf.getvalue()


def _dims(data: bytes):
    from PIL import Image
    return Image.open(io.BytesIO(data)).size


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("mode", ["", "fit", "fill"])
def test_resized_equals_jax(seed, mode):
    rng = np.random.default_rng(seed)
    w, h = int(rng.integers(8, 90)), int(rng.integers(8, 90))
    for data, mime in ((_jpeg(w, h, seed=seed), "image/jpeg"),
                       (_png(w, h, seed=seed), "image/png")):
        for tw, th in ((16, 0), (0, 12), (int(rng.integers(1, 40)),
                                          int(rng.integers(1, 40)))):
            got = images.resized(data, mime, width=tw, height=th, mode=mode)
            want = jax_images.resized(data, mime, width=tw, height=th,
                                      mode=mode)
            assert got == want, (mime, tw, th, mode)


def test_fix_orientation_equals_jax():
    for orientation in range(1, 9):
        data = _jpeg(48, 20, orientation=orientation, seed=orientation)
        assert images.fix_orientation(data, "image/jpeg") == \
            jax_images.fix_orientation(data, "image/jpeg")
    for data, mime in ((b"x", "image/png"), (b"x", "image/jpeg"),
                       (_png(), "image/png")):
        assert images.fix_orientation(data, mime) == data


def test_passthrough_equals_jax():
    for data, mime in ((b"not an image", "text/plain"),
                       (b"\xff\xd8broken", "image/jpeg"),
                       (_jpeg(), "image/tiff")):
        assert images.resized(data, mime, width=10) == \
            jax_images.resized(data, mime, width=10) == (data, 0, 0)


def test_without_pil_both_serve_the_stored_bytes(monkeypatch):
    """PIL missing: the stored bytes, unresized (a known limit of both
    packages)."""
    data = _jpeg(orientation=6)
    monkeypatch.setitem(sys.modules, "PIL", None)
    for pkg in (images, jax_images):
        assert pkg.resized(data, "image/jpeg", width=16) == (data, 0, 0)
        assert pkg.fix_orientation(data, "image/jpeg") == data


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    """A port and a JAX cluster of one volume server each."""
    from tests.cluster_util import Cluster as JaxCluster
    jax = JaxCluster(tmp_path_factory.mktemp("jax_images"),
                     n_volume_servers=1)
    try:
        port = Cluster(tmp_path_factory.mktemp("port_images"),
                       n_volume_servers=1)
    except BaseException:
        jax.stop()
        raise
    yield {"port": port, "jax": jax}
    port.stop()
    jax.stop()


def _get_raw(c, fid: str, query: str, headers: dict) -> bytes:
    """One GET's status line, headers and body, the Date line dropped."""
    url = c.volume_servers[0].url
    req = urllib.request.Request(f"http://{url}/{fid}{query}",
                                 headers=headers)
    with urllib.request.urlopen(req, timeout=30) as r:
        lines = [f"{r.status}"] + [f"{k}: {v}" for k, v in r.headers.items()
                                   if k.lower() != "date"]
        return "\r\n".join(lines).encode() + b"\r\n\r\n" + r.read()


CASES = {
    "width": (_jpeg(64, 32), "image/jpeg", False, "?width=16", {}),
    "fit": (_jpeg(64, 32), "image/jpeg", False,
            "?width=20&height=20&mode=fit", {}),
    "fill": (_jpeg(64, 32), "image/jpeg", False,
             "?width=20&height=20&mode=fill", {}),
    "gzip_stored": (_jpeg(64, 32, seed=5), "image/jpeg", True,
                    "?height=10", {"Accept-Encoding": "gzip"}),
    "exif_orientation": (_jpeg(64, 32, orientation=6, seed=7),
                         "image/jpeg", False, "?width=16", {}),
    "png": (_png(), "image/png", False, "?width=10&height=10&mode=fill",
            {}),
    "no_resize_asked": (_jpeg(64, 32), "image/jpeg", False, "", {}),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_image_get_equals_jax_server(pair, name):
    data, mime, gz, query, headers = CASES[name]
    replies = {}
    for kind, c in pair.items():
        a = c.assign()
        up = {"Content-Type": mime}
        body = data
        if gz:
            up["Content-Encoding"] = "gzip"
            body = gzip.compress(data, mtime=0)
        with c.http(f"{a['url']}/{a['fid']}", data=body, method="POST",
                    headers=up):
            pass
        replies[kind] = _get_raw(c, a["fid"], query, headers)
    assert replies["port"] == replies["jax"]
    body = replies["port"].partition(b"\r\n\r\n")[2]
    if name == "width":
        assert _dims(body) == (16, 8)
    elif name in ("fit", "fill"):
        assert _dims(body) == (20, 20)
    elif name == "exif_orientation":
        assert _dims(body) == (16, 32)   # upright first: 32x64 -> 16x32
    elif name == "no_resize_asked":
        assert body == data
