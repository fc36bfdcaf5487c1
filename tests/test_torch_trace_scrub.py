"""Spans and counters inside the port's scrub pass, and the per-layer
readers of the benchmark that read them.

A traced pass over a small EC fleet with one data flip and one parity
flip: each needle's ``scrub.sweep.read`` and ``scrub.sweep.crc`` under its
volume's ``scrub.scan_ec``, ``scrub.localize`` only in the flipped volume,
a ``scrub.reverify`` after each ``scrub.repair``. With tracing off a whole
pass makes no ``Span``. The codec's ``codec.*`` spans and its H2D, D2H
and host-copy counters move on the "cuda" path only (the card test checks
them there: a fleet pass, which stages its batches in place, makes no
``codec.pack`` and no host copy).
Spans carry the OS thread id; ``enable()`` takes the epoch offset
again; a full ring counts what it drops. The readers under ``ecbench/layers/``
each against a synthetic layer dict, and a traced ``warm_fleet.scrub``
run on the CPU path reporting the span metrics, no codec time or H2D
and D2H metric, and a host copy of 0.

This file imports neither JAX nor the JAX package.
"""

import os
import threading

import numpy as np
import pytest
import torch

from ecbench import run
from seaweedfs_tpu_torch.ec import fleet, store_ec
from seaweedfs_tpu_torch.ops.rs_code import ReedSolomon
from seaweedfs_tpu_torch.scrub import ScrubDaemon
from seaweedfs_tpu_torch.stats import trace
from seaweedfs_tpu_torch.stats.metrics import (CodecD2HBytesCounter,
                                               CodecH2DBytesCounter,
                                               CodecHostCopyBytesCounter,
                                               TraceSpansDroppedCounter)
from seaweedfs_tpu_torch.storage.needle import Needle
from seaweedfs_tpu_torch.storage.store import Store

SCRUB = dict(volumes=3, volume_bytes=1 << 20, chunk_bytes=256 << 10,
             file_bytes_min=16 << 10, file_bytes_max=1 << 20)
DROPPED = "SeaweedFS_trace_spans_dropped_total"
H2D = "SeaweedFS_codec_h2d_bytes_total"
D2H = "SeaweedFS_codec_d2h_bytes_total"
HOST_COPY = "SeaweedFS_codec_host_copy_bytes_total"
NEEDLES = 20
DATA_VID, PARITY_VID = 1, 2


@pytest.fixture
def tracer(monkeypatch):
    """The tracer as the test found it, restored after: off, its ring,
    its offset."""
    for name in ("_enabled", "_ring", "EPOCH_OFFSET"):
        monkeypatch.setattr(trace, name, getattr(trace, name))
    trace.disable()
    trace.clear()
    yield trace
    trace.disable()
    trace.clear()


def _flip(path, offset, mask=0x5A):
    with open(path, "r+b") as f:
        f.seek(offset)
        b = f.read(1)
        f.seek(offset)
        f.write(bytes([b[0] ^ mask]))


@pytest.fixture
def ec_fleet(tmp_path):
    """Three mounted EC volumes of 20 needles, under 1 MiB each, so all
    of a volume's data lies in shard 0 at its .dat offsets. A byte of
    needle 5's data is flipped in volume 1 and a parity byte in
    volume 2."""
    root = str(tmp_path)
    store = Store([root])
    rng = np.random.default_rng(19)
    for vid in (1, 2, 3):
        store.add_volume(vid)
        v = store.find_volume(vid)
        for i in range(1, NEEDLES + 1):
            v.write_needle(Needle(id=i, cookie=7, data=rng.integers(
                0, 256, 4096, dtype=np.uint8).tobytes()))
        at = v.nm.get(5).offset
        store_ec.generate_ec_shards(store, vid, backend="cpu")
        store_ec.mount_ec_shards(store, vid, "", range(14))
        assert store.delete_volume(vid)
        if vid == DATA_VID:
            _flip(os.path.join(root, f"{vid}.ec00"), at + 16 + 4 + 3)
    _flip(os.path.join(root, f"{PARITY_VID}.ec11"), 100)
    yield store
    store.close()


def _counter(metric) -> float:
    return metric.labels().value


def test_traced_pass_splits_sweep_localize_and_repairs(tracer, ec_fleet):
    tracer.enable()
    res = ScrubDaemon(ec_fleet, backend="cpu", export_lag=False).run_pass()
    spans = tracer.spans()
    assert (res.corruptions_found, res.corruptions_repaired,
            res.unrecoverable) == (2, 2, 0)
    scans = {s.id: s for s in spans if s.name == "scrub.scan_ec"}
    assert sorted(s.tags["vid"] for s in scans.values()) == [1, 2, 3]
    for phase in ("scrub.sweep.read", "scrub.sweep.crc"):
        sweep = [s for s in spans if s.name == phase]
        assert len(sweep) == res.needles_verified == 3 * NEEDLES
        assert all(s.parent_id in scans for s in sweep)
        for scan_id, scan in scans.items():
            mine = [s for s in sweep if s.parent_id == scan_id]
            assert len(mine) == NEEDLES
            assert all(scan.t0 <= s.t0 and s.t0 + s.dur <= scan.t0 +
                       scan.dur for s in mine)
    reads = [s for s in spans if s.name == "scrub.sweep.read"]
    assert all(s.tags["bytes"] > 4096 for s in reads)
    localize = [s for s in spans if s.name == "scrub.localize"]
    assert len(localize) == 1
    assert scans[localize[0].parent_id].tags["vid"] == DATA_VID
    steps = sorted((s for s in spans
                    if s.name in ("scrub.repair", "scrub.reverify")),
                   key=lambda s: s.t0)
    assert [s.name for s in steps] == ["scrub.repair", "scrub.reverify"] * 2
    for repair, reverify in zip(steps[::2], steps[1::2]):
        assert reverify.t0 >= repair.t0 + repair.dur
        assert reverify.tags["base"] == repair.tags["base"]


def test_untraced_pass_makes_no_span(tracer, ec_fleet, monkeypatch):
    class NoSpan:
        def __init__(self, *a, **k):
            raise AssertionError("a Span was made with tracing off")

    monkeypatch.setattr(trace, "Span", NoSpan)
    assert not trace.active()
    res = ScrubDaemon(ec_fleet, backend="cpu", export_lag=False).run_pass()
    assert (res.corruptions_found, res.corruptions_repaired) == (2, 2)
    assert res.needles_verified == 3 * NEEDLES
    assert trace.spans() == []


def test_cpu_codec_copies_nothing_and_stages_no_span(tracer):
    tracer.enable()
    h2d, d2h = _counter(CodecH2DBytesCounter), _counter(CodecD2HBytesCounter)
    copied = _counter(CodecHostCopyBytesCounter)
    rs = ReedSolomon(backend="cpu")
    data = np.random.default_rng(3).integers(0, 256, (2, 10, 4096),
                                              dtype=np.uint8)
    staged = rs.host_buffer(data.shape)
    staged.numpy()[...] = data
    parity = rs.encode_async(staged).result()
    shards = np.concatenate([data, parity], axis=1)
    got = rs.reconstruct_some(list(range(1, 11)), [0], shards[:, 1:11])
    assert np.array_equal(got[:, 0], data[:, 0])
    assert (_counter(CodecH2DBytesCounter), _counter(CodecD2HBytesCounter),
            _counter(CodecHostCopyBytesCounter)) == (h2d, d2h, copied)
    assert not [s for s in trace.spans() if s.name.startswith("codec.")]


def test_span_thread_ids_and_offset_taken_at_enable(tracer, monkeypatch):
    got = {}

    def worker():
        with trace.span("t.worker") as s:
            got["span"], got["native"] = s.tid, threading.get_native_id()

    trace.enable()
    with trace.span("t.main") as main:
        pass
    t = threading.Thread(target=worker)
    t.start()
    t.join(timeout=10)
    assert not t.is_alive()
    assert main.tid == threading.get_native_id()
    assert got["span"] == got["native"] != main.tid

    class Clock:
        """perf_counter advances 1 us a reading; time() is 1e9 s ahead
        of it, so each bracketed pair reads an offset of 1e9 exactly."""
        t = 100.0

        def perf_counter(self):
            self.t += 1e-6
            return self.t

        def time(self):
            return self.perf_counter() + 1e9

    trace.disable()
    monkeypatch.setattr(trace, "time", Clock())
    trace.enable()
    assert trace.EPOCH_OFFSET == pytest.approx(1e9, abs=1e-5)
    with trace.span("t.after") as s:
        pass
    assert abs(trace.span_dict(s)["ts_us"] - (s.t0 + 1e9) * 1e6) < 1.0


def test_full_ring_counts_dropped_spans(tracer):
    before = _counter(TraceSpansDroppedCounter)
    trace.enable(capacity=4)
    for i in range(7):
        with trace.span("t.ring", i=i):
            pass
    assert [s.tags["i"] for s in trace.spans()] == [3, 4, 5, 6]
    assert _counter(TraceSpansDroppedCounter) - before == 3


# -- the readers -----------------------------------------------------------------

GIB = float(1 << 30)
LAYER = {
    "bytes_scrubbed": 4 * (1 << 30),
    "spans": [("scrub.scan_ec", 9.0), ("scrub.sweep.read", 1.0),
              ("scrub.sweep.read", 3.0), ("scrub.sweep.crc", 2.0),
              ("scrub.localize", 0.5), ("scrub.repair", 4.0),
              ("scrub.reverify", 1.5), ("scrub.repair", 2.0),
              ("scrub.reverify", 1.0), ("codec.alloc", 0.25),
              ("codec.pack", 1.5), ("codec.submit", 0.25),
              ("fleet.retire", 7.0), ("fleet.dispatch", 3.0)],
    "prom_delta": {H2D: 6.0 * (1 << 30), D2H: 2.0 * (1 << 30),
                   HOST_COPY: 0.125 * (1 << 30),
                   "SeaweedFS_scrub_pass_seconds_count": 5.0,
                   DROPPED: 0.0},
}
# (reader, its value on LAYER, what taking it away makes it None)
READERS = [
    ("sweep_read_s_per_gib", 1.0, ("spans", "scrub.sweep.read")),
    ("sweep_crc_s_per_gib", 0.5, ("spans", "scrub.sweep.crc")),
    ("scrub_repair_s_per_pass", 9.0 / 5, ("spans", "scrub.reverify")),
    ("codec_host_s_per_gib", 0.5, ("spans", "codec.")),
    ("codec_copy_bytes_per_byte", 2.0, ("prom_delta", "SeaweedFS_codec_")),
    ("codec_host_copy_bytes_per_byte", 0.125 / 4,
     ("prom_delta", HOST_COPY)),
]


def _without(layer, key, prefix):
    out = dict(layer)
    if key == "spans":
        out["spans"] = [(n, d) for n, d in layer["spans"]
                        if not n.startswith(prefix)]
    else:
        out[key] = {k: v for k, v in layer[key].items()
                    if not k.startswith(prefix)}
    return out


@pytest.mark.parametrize("name,want,missing", READERS,
                         ids=[r[0] for r in READERS])
def test_reader_values_and_none(name, want, missing):
    reader = run.load_reader(name)
    assert reader.read(LAYER) == pytest.approx(want, rel=1e-12)
    assert reader.read(_without(LAYER, *missing)) is None
    assert reader.read({}) is None
    dropped = dict(LAYER, prom_delta=dict(LAYER["prom_delta"],
                                          **{DROPPED: 1.0}))
    assert reader.read(dropped) is None


def test_repair_reader_needs_passes():
    reader = run.load_reader("scrub_repair_s_per_pass")
    no_pass = _without(LAYER, "prom_delta", "SeaweedFS_scrub_pass")
    assert reader.read(no_pass) is None
    # a window whose repairs needed no localization still reads
    assert reader.read(_without(LAYER, "spans", "scrub.localize")) == \
        pytest.approx(8.5 / 5, rel=1e-12)


def test_host_copy_reader_reads_zero_when_nothing_was_copied():
    """The counter is there and did not grow: 0, not nothing."""
    reader = run.load_reader("codec_host_copy_bytes_per_byte")
    layer = dict(LAYER, prom_delta=dict(LAYER["prom_delta"],
                                        **{HOST_COPY: 0.0}))
    assert reader.read(layer) == 0.0
    assert reader.read(dict(layer, bytes_scrubbed=0)) is None


def test_traced_scrub_cell_reads_span_metrics_on_the_cpu(tracer):
    env = dict(os.environ)
    try:
        res = run.run_cell("warm_fleet.scrub", 2 ** 31 + 19, 0.5, True,
                           need_card=False, config_overrides=SCRUB)
    finally:
        os.environ.clear()
        os.environ.update(env)
    assert res["correct"], res["checks"]
    got = set(res["metrics"])
    assert {"sweep_read_s_per_gib", "sweep_crc_s_per_gib",
            "scrub_repair_s_per_pass"} <= got
    assert not {"codec_host_s_per_gib", "codec_copy_bytes_per_byte"} & got
    # the "cpu" codec stages nothing: its host-copy counter never grows
    assert res["metrics"]["codec_host_copy_bytes_per_byte"]["value"] == 0.0
    assert all(res["metrics"][m]["value"] > 0 for m in
               ("sweep_read_s_per_gib", "sweep_crc_s_per_gib",
                "scrub_repair_s_per_pass"))


# -- on the card ---------------------------------------------------------------

@pytest.mark.cuda
def test_card_codec_spans_nest_under_the_fleet_and_count_copies(tracer,
                                                                 ec_fleet):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    bases = [ec_fleet.find_ec_volume(vid).base_name for vid in (1, 2, 3)]
    h2d, d2h = _counter(CodecH2DBytesCounter), _counter(CodecD2HBytesCounter)
    copied = _counter(CodecHostCopyBytesCounter)
    tracer.enable()
    fleet.fleet_verify_ec_files(bases, backend="cuda")
    torch.cuda.synchronize()
    spans = trace.spans()
    by_id = {s.id: s for s in spans}
    dispatches = [s for s in spans if s.name == "fleet.dispatch"]
    staged = sum(s.tags["batch"] for s in dispatches)
    assert staged >= len(bases)
    # the readers fill the pinned batch in place: nothing is packed, and
    # nothing is copied on the host before the H2D
    assert not [s for s in spans if s.name == "codec.pack"]
    assert _counter(CodecHostCopyBytesCounter) == copied
    # the batch's buffer is taken on the pass thread, under a fleet.*
    # span (the pass's root), the output's under fleet.dispatch
    for name, parents in (("codec.alloc", ("fleet.",)),
                          ("codec.submit", ("fleet.dispatch",))):
        mine = [s for s in spans if s.name == name]
        assert mine and all(by_id[s.parent_id].name.startswith(parents)
                            for s in mine), name
        assert all(s.tid == by_id[s.parent_id].tid for s in mine)
    in_bytes = _counter(CodecH2DBytesCounter) - h2d
    out_bytes = _counter(CodecD2HBytesCounter) - d2h
    assert in_bytes > 0 and out_bytes * 10 == in_bytes * 4
