"""Volume server GET (``server/volume.py`` on ``util/http_server.py``):
mean milliseconds of the window's GETs by the servers' own request
histogram, ``SeaweedFS_request_seconds{type="volumeServer",name="get"}``
(growth of its sum over growth of its count)."""


def read(layer: dict):
    d = layer.get("prom_delta", {})
    key = '{type="volumeServer",name="get"}'
    n = d.get("SeaweedFS_request_seconds_count" + key, 0.0)
    s = d.get("SeaweedFS_request_seconds_sum" + key, 0.0)
    if n <= 0:
        return None
    return 1e3 * s / n
