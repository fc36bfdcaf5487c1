"""Scrub repairs (``scrub/planner.py``): seconds of the program's
``scrub.localize``, ``scrub.repair`` and ``scrub.reverify`` spans over
the window's growth of ``SeaweedFS_scrub_pass_seconds_count``. None
without both ``scrub.repair`` and ``scrub.reverify`` spans, or when the
trace ring dropped spans in the window."""

DROPPED = "SeaweedFS_trace_spans_dropped_total"
PASSES = "SeaweedFS_scrub_pass_seconds_count"
NAMES = ("scrub.localize", "scrub.repair", "scrub.reverify")


def read(layer: dict):
    prom = layer.get("prom_delta", {})
    passes = prom.get(PASSES, 0.0)
    if prom.get(DROPPED, 0.0) > 0 or passes <= 0:
        return None
    by_name = {}
    for n, d in layer.get("spans", ()):
        if n in NAMES:
            by_name[n] = by_name.get(n, 0.0) + d
    if "scrub.repair" not in by_name or "scrub.reverify" not in by_name:
        return None
    return sum(by_name.values()) / passes
