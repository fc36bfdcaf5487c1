"""Helpers the per-layer readers share."""

import json
import os

GIB = float(1 << 30)


def hbm_bytes_per_s(device_kind: str):
    """The card's memory bandwidth from ``peaks.json``, or None for a card
    the table does not list."""
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "peaks.json")
    with open(path) as f:
        peaks = json.load(f)
    entry = peaks.get(device_kind)
    return entry["hbm_bytes_per_s"] if entry else None


def k1_roofline(layer: dict):
    """K1's share of its memory bound: the least time its launches could
    take, ``(S + O) x lanes`` bytes at the card's bandwidth, over the time
    the trace gives its kernels, in percent."""
    dev = layer.get("device") or {}
    bw = hbm_bytes_per_s(layer.get("device_kind", ""))
    if not bw or not dev.get("k1_launches") or not dev.get("k1_kernel_s"):
        return None
    return 100.0 * dev["k1_bytes"] / bw / dev["k1_kernel_s"]


def device_idle(layer: dict):
    """Percent of the traced window in which the card ran nothing."""
    dev = layer.get("device") or {}
    if not dev.get("window_s") or not dev.get("events_in_window"):
        return None
    return 100.0 * (1.0 - dev["busy_s"] / dev["window_s"])


def span_s_per_gib(layer: dict, name: str):
    """Seconds in the program's ``name`` spans per GiB scrubbed."""
    total = sum(d for n, d in layer.get("spans", ()) if n == name)
    scrubbed = layer.get("bytes_scrubbed", 0)
    if not total or not scrubbed:
        return None
    return total / (scrubbed / GIB)
