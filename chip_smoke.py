#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's erasure-coding path on one NVIDIA GPU.

    python3 chip_smoke.py [--needles N] [--seed S]

Phases (any failure ends the run with a traceback and a non-zero exit):

1. Device: print the card's name and power limit, build the CUDA kernels
   (``seaweedfs_tpu_torch/csrc/gf_linear.cu`` and ``gf_compare.cu``, nvcc)
   and the needle CRC library (``native/crc32c.cpp``, g++) from the
   checkout, one compiler per source, all in parallel.
2. Kernel vs plain: ``gf_kernel.gf_linear`` on the card, byte-compared with
   its plain PyTorch version (``gf_linear_plain``, also on the card) for
   the encode matrix and the decode matrices of four loss sets, at lane
   counts 0, 1, 127, 128, 32768+257 and 64 Mi, and at the main path's
   encode slab [6, 10, 1 MiB]; and for a map with O = 14 at 32768+257
   lanes. Then every kind of launch on the main path, each checked the
   same way and timed with CUDA events: the encode at the slab and at a
   64 Mi-lane large row, the rebuild's O=4 decode at the slab (``ms``:
   median of 20 single launches), and the degraded read's O=1 decode at
   [10, 1 KiB] and at one needle's interval (median of 200 single
   launches). A single launch's time includes the host's cost of the
   call; ``ms_pipelined``, the median of 20 samples of 10 back-to-back
   launches, hides most of it, and ``ms_device``, the median of the
   kernel's own durations in a torch.profiler trace, all of it. Each time
   is printed beside its memory bound, its share of it, and the plain
   version's time. The JSON line carries the slab's.
3. Main path, through the store-level entry points the volume server
   calls, on a volume of ``--needles`` x 1,024 B needles (default
   1,048,576: upstream ``weed benchmark -n 1048576 -size 1024``):
   generate_ec_shards -> parity sample check -> lose shards {0,5,11,13} ->
   rebuild_ec_shards (hashes must match) -> mount with those four shards
   missing and read_ec_needle 4,096 sampled needles (degraded intervals
   are rebuilt by the kernel) -> ec_shards_to_volume (after losing the
   four shards again), whose .dat must hash like the original. Then
   write_ec_files with 64 MiB large blocks (large-row path and the
   large->small rollover), checked against a host plain-version encode.
   ``gf_kernel.LAUNCHES`` is set to 0 before each phase and must rise in
   each.
4. Chunk sweep: write_ec_files at 16, 64 and 256 MiB codec slabs.
5. Trace: one write_ec_files under torch.profiler; the card's busy time
   (kernel, H2D, D2H) against the wall time.
6. Fleet: 12 volumes of 1,024 B needles, about 1.8 GB of .dat in all
   (``FLEET_NEEDLES``), written through the port's Store.
   generate_ec_shards_batch, then fleet_write_ec_files + .ecx, twice
   per-volume write_ec_files + .ecx over hard-linked twins, and the bare
   fleet pass again (fleet, per-volume, per-volume, fleet; shard and .ecx
   hashes must match, sampled parity spans == gf_linear_plain);
   gf_linear == plain at the fleet's own launch shapes; shards {3, 12}
   of every volume lost and fleet_rebuild_ec_files (hashes identical);
   fleet_verify_ec_files clean, then with one .ec11 and one .ec04 byte
   flipped in two volumes (only those reported, exact counts and
   offsets); every volume mounted with {0,5,11,13} missing and 4,096
   sampled needles read from 16 threads through a DegradedReadFleet and
   again in place (bytes checked, p50/p99, dispatches, mean batch); one
   fleet encode under torch.profiler. The port's per-stage
   FleetStageSecondsHistogram sums and the data bytes per fused dispatch
   are printed for each pass. Each pass's launch count must be > 0.
7. Scrub and mesh, on phase 6's volumes, with an explicit one-card mesh
   (``parallel.make_mesh(devices=[cuda:0])``). (a) ``gf_compare`` on the
   card against ``gf_compare_plain``: counts and first indices exact at
   N = 0, 1, 127, 128, 33,025, 64 Mi, the mesh verify bucket [1, 4,
   lanes] (its span padded to 16 lanes) and the unpadded span, for
   matching rows and first-lane, last-lane, at-the-limit and random
   mismatches under limits 0, partial and full, at lane offsets 0 and
   2^20; timed at the bucket like phase 2, beside ``(a != b).sum(-1)``,
   and on the card at the unpadded span.
   (b) ``mesh_verify_ec_files`` against ``fleet_verify_ec_files`` in the
   order fleet, mesh, mesh, fleet, then both with phase 6's two flipped
   bytes (VerifyResult fields equal but spans), and one mesh verify under
   torch.profiler. (c) ``mesh_rebuild_ec_files(check=True)`` of {3, 12}
   (hashes identical), then a flipped survivor byte: MeshVerifyMismatch
   and no rebuilt file left. (d) ``sharded_write_ec_files`` (shards equal
   phase 6's), ``ec_pipeline_step`` (0 mismatches) and ``rotate_shards``.
   (e) one ``ScrubDaemon(..., mesh_cfg={"mesh": mesh}).run_pass()`` over a
   store of the last five volumes with planted damage: a live needle byte
   in a data shard, a parity byte, a dead-space data byte, and a CRC-bad
   needle of a normal volume with a copied replica; every fault repaired
   byte-identical and the pass counts exact. Both kernels' launch counts
   must rise where they run, and the mesh must never fall back.
8. The service path, in this process (so the kernels' launch counts see
   the servers' launches): a port MasterServer (volumes of 1,024 MiB) and
   four VolumeServers (``ec_encoder`` cuda, the decode fleet on, a
   1,024 MiB read cache and hedged shard reads; the last one on the kv
   needle map), each with its own directory. (a) 512 MiB of needles of
   1 B-256 KiB (uniform, seeded) into collection "smoke" through
   operations.assign + upload_data over HTTP from 16 threads; the master
   grows 7 volumes; MB/s, group-commit batches and every .dat hashed. (b) ``Shell.run_command("ec.encode
   -collection=smoke -volumeId=<every vid>")``, one fused generate RPC per
   source server: wall seconds and .dat GB/s, with the fused generates,
   the spread and its shard copies over the RPC transport timed apart;
   data shards == the .dat stripes, sampled parity == gf_linear_plain,
   each volume's shards on at least three of the four servers (the shell
   spreads by free slots). (c) half the needles (at most 4,096) read
   over HTTP from random servers (16 threads): bytes equal, p50/p99. (d)
   a server
   holding at most four shards of every volume stopped; once the master
   drops it, the other half (the caches hold (c)'s), p50/p99 of the
   reads across its shards, decode fleet dispatches > 0; then the same
   reads again, each to the same server: bytes equal, no decode dispatch,
   no kernel launch, cache hits = reads. (e) ``ec.rebuild``: 14 shards
   per volume on the live servers, cache entries invalidated, both
   samples again. (f) ``ec.decode``: every .dat hashes as in (a), the
   sample read from the normal volumes. (g) ``python -m
   seaweedfs_tpu_torch master`` and ``volume`` as subprocesses, 64 blobs,
   ``shell ec.encode -volumeId=N`` as a third, the blobs read back, both
   servers stopped by SIGTERM (exit 0, no Traceback). (h) ``fix`` of
   phase 3's volume: the .idx it writes equals the original. gf_linear's
   launch count must rise in (b), (d)'s first pass, (e) and (f).
9. The maintenance cycle, on phase 8's cluster after (f) (its master runs
   the maintenance cron, MAINTENANCE_SCRIPTS, an hour apart). (i)
   BatchDelete of the largest third of the needles of two volumes, one on
   the kv needle map, then ``volume.vacuum -garbageThreshold=0.3``: only
   those two compacted (revision + 1 by ReadVolumeFileStatus, .dat
   shrank), sampled survivors byte-identical over HTTP, deleted needles
   404. (j) ``volume.move`` of a vacuumed volume (.dat hash unchanged);
   64 new needles, then VolumeIncrementalCopy into a backup copy (its
   .dat and .idx hash as the source's); ``volume.tier.upload`` of one
   volume to a memory backend, its sample read through the tier,
   ``volume.tier.download`` (.dat hash unchanged). (k)
   ``master.run_maintenance_now()``: the cron EC-encodes every volume on
   the card; 0 scripts failed, data shards == the vacuumed .dat's
   stripes, sampled parity == gf_linear_plain, the sample reads back
   through the EC path. (l) every shard of one volume gathered on one
   server, ``master.scrub_all_now()`` (every pass finishes, nothing
   found), then a flipped parity byte and ``volume.scrub -node
   -volumeId``: found 1, repaired 1, the shard's hash as in (k). (m)
   ``volume.tier.upload`` of one EC volume's shards on their holders, its
   sample read through the tier, ``volume.tier.download`` (shard hashes
   as in (k)). (n) ``collection.list``, ``cluster.status`` against
   Statistics, ``collection.delete``: no smoke file and no smoke volume
   left. gf_linear's launch count must rise in (k) and both scrubs, and
   stay 0 in (i), (j), (m) and (n).
10. The replicated, highly available cluster, in this process: three
   MasterServers with ``peers`` set to all three (volumes of 256 MiB) and
   four VolumeServers naming all three masters, in data center dc1, racks
   r1, r1, r2, r2 (``ec_encoder`` cuda, the read cache and hedging as in
   phase 8), the breaker on. (a) one leader elected, four servers
   registered with their racks. (b) 128 MiB of needles of 1 B-256 KiB in
   collection "repl" with replication 010 from 16 threads, every assign
   sent to a follower (the HTTP proxy); the leader stopped, the failover
   timed until a new leader has all four servers; two volumes grown
   through a follower must be numbered above every earlier one; 128 MiB
   more (256 each until phase 16 needed the time); every file id distinct, every volume on two racks; MB/s of both
   halves. (c) 4,096 sampled needles read from each of their replicas
   (bytes equal, p50/p99), and every volume's two replicas hold the same
   live needles with the same data. (d) 64 needles deleted through one
   replica, gone from both; one r1 server stopped: writes to a volume it
   held a replica of are not acknowledged, before and after the master
   drops it; the sample of its volumes read from the other replicas; the
   breaker's state for it. (e) ``volume.fix.replication``: every volume
   back on two racks, seconds and bytes copied, the sample read from the
   new copies. (f) a byte flipped in a live needle's data on one replica,
   ``volume.scrub -node -volumeId``: found 1, repaired 1, bytes equal to
   the other replica's. (g) ``ec.encode -collection=repl -volumeId=<every
   vid>``: one generate per volume, data shards == the generating
   replica's .dat stripes, sampled parity == gf_linear_plain, no .dat of
   those volumes on any live server, the sample read back through the EC
   path; wall seconds and GB/s. gf_linear's launch count must rise in (g)
   and stay 0 in (a)-(f).
11. Chunked files through the client libraries, in this process, on a
   cluster of their own: three MasterServers (a raft set as in phase 10,
   volumes of 64 MiB) and four VolumeServers naming all three (placement
   000, one rack, the read cache and hedging as in phase 8), the lookup
   cache on. (a) ``MasterClient`` over the three names the leader. (b)
   twelve seeded files (1 KiB, 4 MiB - 1, 4 MiB, 4 MiB + 1, 8 MiB + 7 and
   seven of 1-40 MiB) through ``operations.submit(max_mb=4)`` from 4
   threads and 1,024 needles of 1 B-64 KiB through
   ``operations.upload`` from 16, all on one ``LeaseCache(count=32)``
   whose assigns go to a follower: a file of at most 4 MiB is one
   needle, a larger one a manifest of ceil(size / 4 MiB) chunks, and the
   cache makes fewer assigns than it hands out file ids. (c) every file
   whole through a random server (sha256, ``X-File-Store: chunked``),
   256 ranged GETs starting within 1 KiB of a chunk boundary (1 B-9 MiB)
   and one suffix range, a range past the end (416 with ``bytes
   */size``), ``cm=false`` and HEAD, the needles through
   ``MasterClient.lookup_file_id``; the lookup cache makes fewer master
   round trips than lookups. (d) ``ec.encode -collection=chunked`` of
   every volume: data shards == the .dat stripes, sampled parity ==
   gf_linear_plain. (e) the leader stopped: the client names the new one
   and looks up every EC volume. (f) a server holding at most four shards
   of every volume stopped; once the master drops it, every file and the
   ranged GETs again through the other three, bytes equal, decode fleet
   dispatches > 0. (g) half of the manifests deleted
   (``operations.delete_file``): their chunks answer 404, the rest still
   read whole, BatchDelete of a manifest answers 406. (h) ``upload
   -maxMB 4`` of a 10 MiB file, ``download``, ``delete`` and
   ``benchmark -n 4096 -c 16 -assign.leaseCount 32`` as subprocesses.
   gf_linear's launch count must rise in (d) and (f) and stay 0 in
   (a)-(c), (e) and (h).
12. The lifecycle cluster, in this process, on a cluster of its own:
   three MasterServers (phase 10's raft settings, volumes of 64 MiB) with
   the lifecycle engine (pass 0.5 s, cool 0.5, warm 3, hot and warm dwell
   2 s, at most 4 transitions a pass, COLD off, dry run at the start) and
   four VolumeServers in one rack (placement 000, no read cache, heat
   tracked over a 2 s window), each with a ``-metricsPort`` listener;
   QoS on for this phase (200 requests/s and a burst of 200 per tenant,
   weights good:4, noisy:1) and cluster tracing at sample 1.0, both reset
   at the end. (a) 192 MiB of needles of 1 B-256 KiB (seeded) from 16
   threads as tenant ``good``, half in collection ``hot`` and half in
   ``cold``; a reader keeps every hot volume above the warm threshold.
   (b) within 10 s a dry-run encode decision for every cold volume and
   none for a hot one, 0 transitions (the cap covers every volume while
   dry: at 4 a dry run decides the same four each pass). (c) dry run off
   and the cap at 4: every cold volume EC in fused ``ec.encode`` groups of
   at most 4, its ``.dat`` retired, every cold needle read back
   byte-identical (the engine paused until that heat cools), and
   ``SeaweedFS_lifecycle_transitions_total{kind="encode",outcome="ok"}``
   at the leader's /metrics equal to the number of cold volumes; seconds
   to the last EC volume and the engine's encode GB/s. (d) for 3 s a
   ``noisy`` tenant reads from 8 threads at 4x the rate: its 429s carry
   Retry-After, ``good`` and ``_internal`` are never shed, ``cluster.qos``
   equals the clients' counts; good's p50/p99 before and during. (e) a
   server stopped that holds at most four shards of each of two cold EC
   volumes, both read above the warm threshold (the engine paused meanwhile):
   decode fleet dispatches and K1; one degraded read stitched by
   ``cluster.trace`` from the sampled list at once (the process-wide
   rings keep 256 requests); the engine decodes both, K1 rebuilding the
   lost data shards, every needle byte-identical, transitions_total
   decode ok = 2. (f) the leader stopped: the new leader's engine
   reconciles (WARM stays WARM, nothing moves twice), the hot reader
   stops and the new leader encodes the hot volumes; seconds from the
   stop to its first transition. (g) every live /metrics parses as
   Prometheus text with the heat of every live volume, the cluster heat,
   lifecycle, QoS, trace and request families; ``cluster.heat`` lists
   every volume with its tier; ``volume.lifecycle`` status, pause and
   resume; ``cluster.requests``; the stitched trace of (e) spans at least
   two servers. gf_linear's launch count must rise in (c), (e)'s reads,
   (e)'s decodes and (f), and stay 0 in (a), (b), (d) and (g).
13. The async serving core (``-serve.async``). (a) Each serving model in
   processes of its own: ``python -m seaweedfs_tpu_torch master`` and
   ``volume`` (``-metricsPort``), threaded and with ``-serve.async``;
   from this process one selector thread over keep-alive connections
   GETs 4 KiB at 8 connections, 1 MiB at 4 (the sendfile path) and 4 KiB
   at 256, in rounds of 2 s in the order threaded, async, async,
   threaded: req/s, MB/s, p50/p99, errors (must be 0, every body
   checked), the server's threads from /proc at the round's middle, and
   ``SeaweedFS_serve_sendfile_bytes_total`` from its /metrics (> 0 in
   the async 1 MiB rounds). (b) One master and four volume servers in
   this process, all on the async core (``-serve.keepAliveBudget 64``),
   volumes of 64 MiB, 000: 32 MiB of 1 KiB needles in two volumes and 16
   needles of 1-4 MiB; (1) ``ec.encode`` of both; (2) a server holding
   at most 4 shards of each stopped; (3) 1,024 GETs of needles on its
   shards from 16 keep-alive connections, bodies equal, p50/p99, decode
   fleet dispatches; (4) 256 idle keep-alive connections to one server:
   at least 192 LRU closes while reads answer; (5) the stopped server
   back with ``-serve.maxConns 64`` and QoS at good:4, hog:1: the hog's
   second GETs on 56 held connections shed at frame time (429, the
   admission seam's bytes, ``ServeShedCounter{kind="qos"}``), good's
   GETs 200; (6) plain, range, If-None-Match, gzip with and without
   ``Accept-Encoding``, chunk manifest, missing and cookie-mismatch GETs
   equal byte for byte (Date aside) to a threaded server's over a copy
   of the same volume files, the plain ones through sendfile.
   gf_linear's launch count must rise in (1) and (3) and stay 0 in (6).
14. The filer over EC on the card, in this process: one MasterServer
   (placement 000, volumes of 64 MiB), four VolumeServers and a
   FilerServer (``-store sqlite``, ``-maxMB 4``, collection ``filer``).
   (a) phase 11's twelve files of 1 KiB-40 MiB through ``filer.copy`` of a
   local directory (a subprocess of the CLI) and 2,048 files of 1-64 KiB
   in 64 directories by HTTP POST from 16 threads: MB/s, files/s, chunk
   count; ``fs.ls``, ``fs.du`` and ``fs.tree`` agree with the tree. With
   ``cryptography``, a second filer with ``-encryptVolumeData`` writes
   four files (the first filer references the same chunks); without it,
   its POST answers 500 and stores no chunk. (b) ``ec.encode
   -collection=filer`` of every volume: GB/s, K1 launches. (c) through
   the filer: every large file whole, 1,024 sampled small files, 64
   Range reads at chunk boundaries; p50/p99. (d) a server holding at most
   four shards of every volume stopped, the filers' chunk caches emptied,
   (c) again and the encrypted files: decode fleet dispatches and K1
   launches (at least one per dispatch). (e) ``volume.fsck``: 0 orphans
   over the EC volumes; 16 needles uploaded with the ``upload`` CLI
   outside the filer found exactly by ``volume.fsck -v`` and purged by
   ``-reallyDeleteFromVolume -cutoffTimeAgo 1``. (f) ``fs.meta.save /``,
   ``fs.meta.load`` into a fresh filer on ``-store weedkv``, the large
   files read through it with the server still stopped. (g) ``python -m
   seaweedfs_tpu_torch server -filer -s3 -cpuprofile`` as a subprocess:
   one file POSTed and read back, one object PUT and read back through
   its S3 port, SIGINT, exit 0 and the profile written;
   ``version``, ``scaffold -config filer``; ``backup`` of one volume
   (``.dat`` byte-equal to the source) and ``compact -commit`` of a copy
   (the same live needles, a smaller ``.dat``). Every read is checked
   byte for byte. gf_linear's launch count must rise in (b), (d) and
   (f) and stay 0 in (a), (c) and (g).
15. The filer's gateways on phase 14's cluster, in this process: an S3
   gateway (identities: one Admin, one that may only Read the bucket), a
   WebDAV gateway and an FTP gateway on phase 14's filer. (a) between
   14 (a) and 14 (b): the bucket by ``s3.bucket.create``; 512 objects of
   1-64 KiB PUT from 16 threads through ``util/s3_client`` (SigV4); one
   40 MiB object in eight 5 MiB parts, one of them an UploadPartCopy of a
   range of another object, completed and its HEAD checked; every
   ListObjectsV2 page at max-keys 100; the Read identity's PUT answers
   403; WebDAV PUTs of 8 files of 1-64 KiB and one of 16 MiB and a
   PROPFIND; FTP STOR of 4 files; ``volume.tier.upload -dest s3.default``
   of a volume of collection ``tier`` to a bucket of this gateway and
   ``.download`` back, ``.dat`` sha256 equal (the collection is deleted
   after). MB/s and objects/s per gateway, the tier's MB/s each way. The
   gateways write into collection ``filer``, so 14 (b) encodes their
   data. (b) after 14 (d), with its server still stopped and the chunk
   caches emptied: S3 GETs of every part's span, 64 Ranges across part
   boundaries, all 512 small objects and one presigned GET; WebDAV GETs
   of its 9 files; FTP RETRs of its 4 files; every byte checked;
   p50/p99, decode dispatches and K1 launches per gateway. No kernel may
   launch in (a); the S3 reads of (b) must launch K1.
16. The networked stores and replication on phase 14's cluster, between
   14 (f) and 14 (g), with 14 (d)'s server still stopped. The machine has
   no redis: a RESP2 stand-in of this script's own (``RespStandIn``, a
   socket server on a thread answering what the port's RedisStore sends)
   plays it, and no figure counts it as the port's. (a) an in-process
   filer on ``-store redis`` (collection ``filer``, phase 14's chunk
   size): ``fs.meta.load`` of 14 (f)'s snapshot, timed; the chunk caches
   emptied; phase 14's large files read through it; decode dispatches and
   K1 launches, at least one each. (b) ``filer.replicate``: a
   replication.toml with ``[source.filer]`` phase 14's filer under phase
   15's WebDAV directory and ``[sink.filer]`` the redis filer under
   ``/replica``, the tail built by the command's own functions
   (``command/async_services.py``) in this process; the source's chunk
   caches emptied; the tail stopped once every file is on the sink; each
   file read back through the redis filer byte for byte; MB/s, dispatches
   and K1, at least one launch from the 16 MiB file's reads. (c)
   ``FilerSync`` between phase 14's filer and the redis filer under
   ``/sync``: 64 files of 1-64 KiB POSTed into each from 16 threads; the
   seconds until both list all 128 with equal bytes; each side's log
   holds exactly 64 creates under ``/sync`` marked
   ``is_from_other_cluster`` (none written back to its origin). K1 may
   not launch in (a)'s load; (c)'s new files are expected to launch none.
17. One JSON line with the kernels' numbers, the card's nvidia-smi line,
   and last ``{"ok": true, "device": {...}}``.

The exact byte comparisons are the tolerance: GF(2^8) arithmetic has no
rounding.
"""

from __future__ import annotations

import argparse
import atexit
import concurrent.futures
import hashlib
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

HBM_BYTES_PER_S = 3.35e12   # H100 SXM data sheet
NEEDLE_SIZE = 1024
LOSS_SETS = ((0,), (13,), (2, 5, 9, 12), (10, 11, 12, 13))
LOST = (0, 5, 11, 13)
BIG_LANES = 64 << 20


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def sha256_file(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        while True:
            b = f.read(16 << 20)
            if not b:
                return h.hexdigest()
            h.update(b)


# --- phase 1 ------------------------------------------------------------------

def build_all() -> float:
    """Every kernel of the path and the CRC library, one compiler process
    per source, all started together."""
    from seaweedfs_tpu_torch.native import crc
    from seaweedfs_tpu_torch.ops import gf_compare, gf_kernel
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(3) as pool:
        for fut in [pool.submit(gf_kernel.load), pool.submit(gf_compare.load),
                    pool.submit(crc.load)]:
            fut.result()
    secs = time.perf_counter() - t0
    for line in (gf_kernel.BUILD_LOG + gf_compare.BUILD_LOG).splitlines():
        if "entry function" in line or "registers" in line or \
                "spill" in line:
            log(f"  ptxas: {line.strip()}")
    return secs


# --- phase 2 ------------------------------------------------------------------

def kernel_matrices() -> dict:
    """The encode matrix and the decode maps of LOSS_SETS (checked at every
    shape), then the main path's other maps: the rebuild of LOST, a
    degraded read of shard 5 with LOST missing, and one map with O > 4
    (every shard from the data shards)."""
    from seaweedfs_tpu_torch.ops.rs_code import ReedSolomon, coding_matrix
    rs = ReedSolomon(backend="cpu")

    def decode(lost, wanted):
        return rs.decode_matrix([i for i in range(14) if i not in lost],
                                list(wanted))

    mats = {"encode": coding_matrix()[10:]}
    for lost in LOSS_SETS:
        mats[f"decode{lost}"] = decode(lost, lost)
    mats["rebuild"] = decode(LOST, LOST)
    mats["read"] = decode(LOST, [5])
    mats["all_shards"] = coding_matrix()
    return mats


def time_ms(fn, samples: int, launches: int = 1) -> float:
    """Median over ``samples`` of the time per call of ``launches``
    back-to-back calls, from CUDA events around each sample. With one
    launch a sample includes the host's cost of the call, since the card
    waits for it."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(samples):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(launches):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / launches)
    return float(np.median(times))


def device_ms(fn, launches: int, names=("gf_linear",)):
    """Duration on the card of one call of ``fn`` over ``launches`` calls,
    from torch.profiler's device events of the kernels ``names``: no host
    cost. With one kernel per call the median of its durations, else the
    mean of their sum per call. None when the profiler saw no device
    time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(launches):
            fn()
        torch.cuda.synchronize()
    times = [e.time_range.elapsed_us() / 1e3 for e in prof.events()
             if str(e.device_type).endswith("CUDA")
             and any(n in e.name for n in names)]
    if not times:
        return None
    return float(np.median(times)) if len(names) == 1 else \
        float(np.sum(times)) / launches


def main_path_encode_shape() -> tuple:
    """The slab ``generate_ec_shards`` hands the kernel on a volume under
    10 GiB: as many 10 x 1 MiB small rows as fit in the card's chunk."""
    from seaweedfs_tpu_torch.ec.encoder import (
        DEFAULT_CHUNK_CUDA, SMALL_BLOCK_SIZE)
    rows = max(1, DEFAULT_CHUNK_CUDA // (10 * SMALL_BLOCK_SIZE))
    return (rows, 10, SMALL_BLOCK_SIZE)


def needle_interval() -> int:
    """Bytes a degraded read of one NEEDLE_SIZE needle reconstructs: the
    needle as stored (header, body, checksum, timestamp, padding)."""
    from seaweedfs_tpu_torch.storage.needle import Needle
    return len(Needle(id=1, cookie=0, data=bytes(NEEDLE_SIZE)).to_bytes())


def time_kernel(gm, data, label: str, reps: int) -> dict:
    """Kernel (median of ``reps`` single launches, of 20 samples of 10
    back-to-back launches, and of its device durations over ``reps``
    launches) and plain version (3 calls) on one input; the bound is the
    bytes moved, each input read and each output written once, over the
    card's memory rate."""
    from seaweedfs_tpu_torch.ops import gf_kernel

    def kernel():
        gf_kernel.gf_linear(gm, data)

    ms = time_ms(kernel, reps)
    ms_pipelined = time_ms(kernel, 20, 10)
    ms_device = device_ms(kernel, reps)
    plain_ms = time_ms(lambda: gf_kernel.gf_linear_plain(gm.m2, data), 3)
    nbytes = data.numel() // gm.cols * (gm.rows + gm.cols)
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    log(f"  gf_linear {label} {tuple(data.shape)} O={gm.rows}: "
        f"{ms:.4f} ms single (median of {reps}, {bound_ms / ms:.2%} of "
        f"bound), {ms_pipelined:.4f} ms pipelined (median of 20 x 10, "
        f"{bound_ms / ms_pipelined:.2%}), " + (
            f"{ms_device:.4f} ms on the card (median of {reps}, "
            f"{bound_ms / ms_device:.2%})" if ms_device else
            "time on the card not measured") +
        f", bound {bound_ms:.4g} ms, plain {plain_ms:.3f} ms")
    return dict(ms=ms, ms_pipelined=ms_pipelined, ms_device=ms_device,
                plain_ms=plain_ms, bound_ms=bound_ms)


def phase_kernel(seed: int) -> dict:
    """Byte equality with the plain version over every matrix and shape;
    times of every kind of launch on the main path."""
    import torch
    from seaweedfs_tpu_torch.ops import gf_kernel
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(seed)
    mats = kernel_matrices()
    max_err = 0

    def check(name: str, shape: tuple):
        nonlocal max_err
        data = torch.randint(0, 256, shape, generator=gen,
                             device=dev, dtype=torch.uint8)
        gm = gf_kernel.prepare_matrix(mats[name], dev)
        got = gf_kernel.gf_linear(gm, data)
        want = gf_kernel.gf_linear_plain(gm.m2, data)
        torch.cuda.synchronize()
        if got.shape != want.shape:
            raise AssertionError(f"{name} {shape}: shape {got.shape}")
        err = int((got.int() - want.int()).abs().max()) if got.numel() else 0
        max_err = max(max_err, err)
        if err:
            raise AssertionError(f"gf_linear {name} {shape}: kernel "
                                 f"differs from plain (max err {err})")
        return gm, data

    slab = main_path_encode_shape()
    shapes = [(10, n) for n in (0, 1, 127, 128, 32768 + 257, BIG_LANES)]
    for shape in shapes + [slab]:
        names = ["encode"] + [f"decode{lost}" for lost in LOSS_SETS]
        for name in names:
            check(name, shape)
        log(f"  {shape}: kernel == plain for {len(names)} matrices")
    check("all_shards", (10, 32768 + 257))
    log(f"  (10, {32768 + 257}): kernel == plain for O=14")

    timing = {}
    for key, label, name, shape, reps in (
            ("main", "encode, main path", "encode", slab, 20),
            ("large_row", "encode, 64 MiB large row", "encode",
             (10, BIG_LANES), 20),
            ("rebuild", f"rebuild decode of {LOST}", "rebuild", slab, 20),
            ("read", "degraded read, 1 KiB", "read", (10, 1024), 200),
            ("read_needle", "degraded read, one needle's interval", "read",
             (10, needle_interval()), 200)):
        gm, data = check(name, shape)
        timing[key] = time_kernel(gm, data, label, reps)
    return dict(max_abs_err=max_err, **timing)


# --- phase 3 ------------------------------------------------------------------

class Launches:
    """Counts the kernels' launches over one phase: both counts are set to
    0 just before it and read just after. gf_linear must launch in every
    phase but those run with ``maybe=True`` (which may or may not launch),
    gf_compare in those run with ``compare=True``; a phase run with
    ``none=True`` must launch no kernel at all."""

    def __init__(self, backend: str):
        self.backend = backend
        self.per_phase = {}          # gf_linear launches
        self.compare_per_phase = {}  # gf_compare launches

    def run(self, phase: str, fn, *args, compare: bool = False,
            none: bool = False, maybe: bool = False, **kwargs):
        from seaweedfs_tpu_torch.ops import gf_compare, gf_kernel
        gf_kernel.LAUNCHES = gf_compare.LAUNCHES = 0
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        secs = time.perf_counter() - t0
        n, c = gf_kernel.LAUNCHES, gf_compare.LAUNCHES
        self.per_phase[phase] = n
        self.compare_per_phase[phase] = c
        if none:
            if n or c:
                raise AssertionError(f"{phase}: {n} gf_linear and {c} "
                                     "gf_compare launches, want none")
            return out, secs
        if self.backend == "cuda" and n == 0 and not maybe:
            raise AssertionError(f"{phase}: gf_linear was never launched")
        if self.backend == "cuda" and compare and c == 0:
            raise AssertionError(f"{phase}: gf_compare was never launched")
        return out, secs


def check_parity_spans(base: str, shard_size: int, rng, spans: int,
                       span_len: int, device) -> None:
    """Parity at a shard offset is the encode map of the ten data shards
    at the same offset: hold sampled spans against gf_linear_plain."""
    import torch
    from seaweedfs_tpu_torch.ec.encoder import shard_file_name
    from seaweedfs_tpu_torch.ops import gf_kernel
    from seaweedfs_tpu_torch.ops.rs_code import coding_matrix
    gm = gf_kernel.prepare_matrix(coding_matrix()[10:], device)
    files = [open(shard_file_name(base, i), "rb") for i in range(14)]
    try:
        for _ in range(spans):
            length = min(span_len, shard_size)
            off = int(rng.integers(0, shard_size - length + 1))
            rows = []
            for f in files:
                f.seek(off)
                rows.append(np.frombuffer(f.read(length), dtype=np.uint8))
            stripe = torch.from_numpy(np.stack(rows)).to(device)
            want = gf_kernel.gf_linear_plain(gm.m2, stripe[:10])
            if not torch.equal(want, stripe[10:]):
                raise AssertionError(f"{base}: parity wrong at {off}")
    finally:
        for f in files:
            f.close()


def shard_hashes(base: str) -> list:
    from seaweedfs_tpu_torch.ec.encoder import shard_file_name
    with concurrent.futures.ThreadPoolExecutor(4) as pool:
        return list(pool.map(sha256_file,
                             [shard_file_name(base, i) for i in range(14)]))


# needles per Volume.write_needles batch when phases 3 and 6 write their
# volumes: a write and a flush per needle are most of a needle's cost on a
# file system whose system calls are dear
WRITE_BATCH = 4096


def write_needles(v, payload, cookies) -> None:
    """Needle i + 1 of ``payload[i]`` and ``cookies[i]`` appended to volume
    ``v``, in batches of WRITE_BATCH."""
    from seaweedfs_tpu_torch.storage.needle import Needle
    for s in range(0, len(payload), WRITE_BATCH):
        v.write_needles([Needle(id=i + 1, cookie=int(cookies[i]),
                                data=payload[i].tobytes())
                         for i in range(s, min(len(payload),
                                               s + WRITE_BATCH))])


def write_volume(store, payload, cookies) -> float:
    v = store.add_volume(1)
    t0 = time.perf_counter()
    write_needles(v, payload, cookies)
    return time.perf_counter() - t0


def phase_main_path(workdir: str, n_needles: int, seed: int,
                    backend: str, large: int = 64 << 20) -> dict:
    from seaweedfs_tpu_torch.ec import encoder, store_ec
    from seaweedfs_tpu_torch.ec.encoder import shard_file_name
    from seaweedfs_tpu_torch.ops.rs_code import ReedSolomon
    from seaweedfs_tpu_torch.storage.needle import Needle
    from seaweedfs_tpu_torch.storage.store import Store

    device = "cuda" if backend == "cuda" else "cpu"
    codec = None if backend == "cuda" else ReedSolomon(backend="cpu")
    rng = np.random.default_rng(seed)
    payload = rng.integers(0, 256, (n_needles, NEEDLE_SIZE), dtype=np.uint8)
    cookies = rng.integers(0, 1 << 32, n_needles, dtype=np.uint64)
    vol_dir = os.path.join(workdir, "vol")
    orig_dir = os.path.join(workdir, "orig")
    os.makedirs(orig_dir)
    store = Store([vol_dir])
    launches = Launches(backend)
    metrics = {}
    try:
        secs = write_volume(store, payload, cookies)
        base = store.find_volume(1).file_name()
        dat_size = os.path.getsize(base + ".dat")
        dat_hash = sha256_file(base + ".dat")
        log(f"  wrote {n_needles} needles of {NEEDLE_SIZE} B (seed {seed}):"
            f" .dat {dat_size} B in {secs:.1f} s, sha256 {dat_hash[:16]}")

        _, secs = launches.run("generate", store_ec.generate_ec_shards,
                               store, 1, backend=backend)
        metrics["encode_GBps"] = dat_size / secs / 1e9
        shard_size = os.path.getsize(shard_file_name(base, 0))
        log(f"  generate_ec_shards: {secs:.3f} s, "
            f"{metrics['encode_GBps']:.3f} GB/s of .dat, "
            f"{launches.per_phase['generate']} launches, shard {shard_size} B")
        t0 = time.perf_counter()
        encoder.write_sorted_file_from_idx(base)
        log(f"  of which the .idx -> .ecx replay, timed again alone: "
            f"{time.perf_counter() - t0:.3f} s")
        check_parity_spans(base, shard_size, rng, 64, 64 << 10, device)
        log("  parity of 64 sampled 64 KiB spans == gf_linear_plain")

        # keep the original volume files aside; decode must recreate them
        store.location_of(1).unload_volume(1)
        for ext in (".dat", ".idx"):
            os.replace(base + ext, os.path.join(orig_dir, "1" + ext))
        hashes = shard_hashes(base)
        for sid in LOST:
            os.remove(shard_file_name(base, sid))
        rebuilt, secs = launches.run("rebuild", store_ec.rebuild_ec_shards,
                                     store, 1, backend=backend)
        if sorted(rebuilt) != list(LOST) or shard_hashes(base) != hashes:
            raise AssertionError(f"rebuild of {LOST} gave {rebuilt} with "
                                 "different shard hashes")
        metrics["rebuild_GBps"] = 10 * shard_size / secs / 1e9
        log(f"  rebuild_ec_shards {LOST}: {secs:.3f} s, "
            f"{metrics['rebuild_GBps']:.3f} GB/s of shards read, "
            f"{launches.per_phase['rebuild']} launches, 14 hashes identical")

        ecv = store_ec.mount_ec_shards(
            store, 1, "", [i for i in range(14) if i not in LOST])
        sample = rng.choice(n_needles, size=min(4096, n_needles),
                            replace=False)
        lat = {True: [], False: []}

        def read_sample():
            for i in sample.tolist():
                _, _, ivs = ecv.locate_needle(i + 1)
                degraded = any(
                    iv.to_shard_and_offset(ecv.large_block,
                                           ecv.small_block)[0] in LOST
                    for iv in ivs)
                t0 = time.perf_counter()
                got = store_ec.read_ec_needle(
                    store, 1, Needle(id=i + 1, cookie=int(cookies[i])),
                    rs=codec)
                lat[degraded].append(time.perf_counter() - t0)
                if got.data != payload[i].tobytes():
                    raise AssertionError(f"needle {i + 1}: wrong bytes")

        _, secs = launches.run("degraded_read", read_sample)
        for degraded, name in ((True, "degraded"), (False, "healthy")):
            ms = np.array(lat[degraded]) * 1e3
            if len(ms):
                metrics[f"{name}_read_p50_ms"] = float(np.percentile(ms, 50))
                metrics[f"{name}_read_p99_ms"] = float(np.percentile(ms, 99))
            log(f"  {name} reads: {len(ms)}" + (
                f", p50 {np.percentile(ms, 50):.3f} ms, "
                f"p99 {np.percentile(ms, 99):.3f} ms" if len(ms) else ""))
        log(f"  read_ec_needle x{len(sample)} with shards {LOST} missing: "
            f"{secs:.2f} s, all bytes match, "
            f"{launches.per_phase['degraded_read']} launches")

        store_ec.unmount_ec_shards(store, 1, range(14))
        for sid in LOST:
            os.remove(shard_file_name(base, sid))
        _, secs = launches.run("decode", store_ec.ec_shards_to_volume,
                               store, 1, backend=backend)
        if sha256_file(base + ".dat") != dat_hash:
            raise AssertionError("decoded .dat differs from the original")
        metrics["decode_GBps"] = dat_size / secs / 1e9
        log(f"  ec_shards_to_volume with {LOST} lost: {secs:.3f} s, "
            f"{metrics['decode_GBps']:.3f} GB/s, "
            f"{launches.per_phase['decode']} launches, .dat sha256 identical")
        t0 = time.perf_counter()
        encoder.find_dat_file_size(base)
        log(f"  of which the .ecx scan for the .dat size, timed again alone:"
            f" {time.perf_counter() - t0:.3f} s")
        store.location_of(1).delete_volume(1)
        for path in [shard_file_name(base, i) for i in range(14)] + \
                [base + ".ecx", base + ".ecj"]:
            if os.path.exists(path):  # lost parity is not decoded back
                os.remove(path)

        large_base = os.path.join(orig_dir, "1")
        _, secs = launches.run("large_rows", encoder.write_ec_files,
                               large_base, backend=backend, large_block=large)
        check_large_rows(large_base, large, dat_size, rng)
        log(f"  write_ec_files large_block={large} B: {secs:.3f} s, "
            f"{dat_size / secs / 1e9:.3f} GB/s, "
            f"{launches.per_phase['large_rows']} launches, "
            "large row + rollover row == host plain version")
        metrics["shard_hashes"] = hashes
        metrics["large_base"] = large_base
        metrics["dat_size"] = dat_size
    finally:
        store.close()
    metrics["launches"] = launches.per_phase
    return metrics


def check_large_rows(base: str, large: int, dat_size: int, rng) -> None:
    """Against the plain version on the host: sampled spans of the first
    large row, and the whole first small row after the rollover."""
    import torch
    from seaweedfs_tpu_torch.ec.encoder import SMALL_BLOCK_SIZE
    if dat_size <= 10 * large:
        raise AssertionError(f"volume too small for a {large} B large row")
    check_parity_spans(base, large, rng, 16, 64 << 10, "cpu")
    from seaweedfs_tpu_torch.ec.encoder import shard_file_name
    from seaweedfs_tpu_torch.ops import gf_kernel
    from seaweedfs_tpu_torch.ops.rs_code import coding_matrix
    rows = []
    for i in range(14):
        with open(shard_file_name(base, i), "rb") as f:
            f.seek(large)
            rows.append(np.frombuffer(f.read(SMALL_BLOCK_SIZE),
                                      dtype=np.uint8))
    with open(base + ".dat", "rb") as f:
        f.seek(10 * large)
        want_data = np.frombuffer(f.read(10 * SMALL_BLOCK_SIZE),
                                  dtype=np.uint8)
    stripe = np.stack(rows)
    pad = np.zeros(10 * SMALL_BLOCK_SIZE, dtype=np.uint8)
    pad[:len(want_data)] = want_data
    if not np.array_equal(stripe[:10].reshape(-1), pad):
        raise AssertionError("first small row's data shards != .dat slice")
    gm = gf_kernel.prepare_matrix(coding_matrix()[10:], "cpu")
    parity = gf_kernel.gf_linear_plain(gm.m2, torch.from_numpy(stripe[:10]))
    if not np.array_equal(parity.numpy(), stripe[10:]):
        raise AssertionError("first small row's parity != plain version")


# --- phase 4 ------------------------------------------------------------------

def phase_chunk_sweep(base: str, dat_size: int, want_hashes: list,
                      backend: str) -> dict:
    from seaweedfs_tpu_torch.ec import encoder
    out = {}
    for mib in (16, 64, 256):
        t0 = time.perf_counter()
        encoder.write_ec_files(base, backend=backend, chunk=mib << 20)
        secs = time.perf_counter() - t0
        if shard_hashes(base) != want_hashes:
            raise AssertionError(f"chunk {mib} MiB: shards differ")
        out[mib] = dat_size / secs / 1e9
        log(f"  chunk {mib} MiB: {secs:.3f} s, {out[mib]:.3f} GB/s, "
            "shards identical")
    return out


KERNEL_NAMES = ("gf_linear", "compare_rows", "init_rows", "finish_rows")


def device_busy(fn) -> tuple:
    """Wall ms of ``fn()`` under torch.profiler and the card's busy ms by
    kind (kernel, HtoD, DtoH, other): sums of event durations."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    busy = {"kernel": 0.0, "HtoD": 0.0, "DtoH": 0.0, "other": 0.0}
    for e in prof.events():
        if not str(e.device_type).endswith("CUDA"):
            continue
        ms = e.time_range.elapsed_us() / 1e3
        kind = "kernel" if any(n in e.name for n in KERNEL_NAMES) else \
            "HtoD" if "HtoD" in e.name else \
            "DtoH" if "DtoH" in e.name else "other"
        busy[kind] += ms
    return wall_ms, busy


def log_busy(label: str, wall_ms: float, busy: dict) -> None:
    total = sum(busy.values())
    log(f"  {label} traced: wall {wall_ms:.1f} ms; card busy "
        f"{total:.1f} ms ({total / wall_ms:.1%}), idle {1 - total / wall_ms:.1%}"
        f"; " + ", ".join(f"{k} {v:.1f} ms" for k, v in busy.items()))
    if total == 0:
        log("  the profiler saw no device time: idle share not measured")


def phase_trace(base: str, backend: str) -> dict:
    """One write_ec_files under torch.profiler: the card's time in the
    kernel and in each copy direction, against the wall time. Sums of
    event durations (the side stream runs one thing at a time)."""
    from seaweedfs_tpu_torch.ec import encoder
    wall_ms, busy = device_busy(
        lambda: encoder.write_ec_files(base, backend=backend))
    log_busy("write_ec_files", wall_ms, busy)
    return dict(wall_ms=wall_ms, **{f"{k}_ms": v for k, v in busy.items()})


# --- phase 6 ------------------------------------------------------------------

# Needles per volume of the fleet: 12 volumes of 1,024 B needles (upstream
# `weed benchmark -size 1024`) of mixed sizes, about 1.8 GB of .dat.
FLEET_NEEDLES = (524288, 262144, 262144) + (131072,) * 4 + (32768,) * 4 + \
    (1000,)
FLEET_REBUILD_LOST = (3, 12)
FLEET_SAMPLE = 4096
FLEET_THREADS = 16
STAGES = ("read", "upload", "dispatch", "rs", "retire", "write", "verify")


def write_fleet(store, counts, seed: int, sample_size: int) -> dict:
    """Volumes 1..len(counts) of NEEDLE_SIZE needles, random bytes and
    cookies from ``seed``; returns {(vid, needle id): (cookie, bytes)} of
    ``sample_size`` needles drawn uniformly over all of them."""
    rng = np.random.default_rng(seed)
    total = sum(counts)
    picks = set(rng.choice(total, size=min(sample_size, total),
                           replace=False).tolist())
    sample, first = {}, 0
    for vid, n in enumerate(counts, start=1):
        payload = rng.integers(0, 256, (n, NEEDLE_SIZE), dtype=np.uint8)
        cookies = rng.integers(0, 1 << 32, n, dtype=np.uint64)
        write_needles(store.add_volume(vid), payload, cookies)
        for i in range(n):
            if first + i in picks:
                sample[(vid, i + 1)] = (int(cookies[i]), payload[i].tobytes())
        first += n
    return sample


def fleet_counters() -> dict:
    """The port's fleet metrics, read before and after a pass: seconds
    per stage, fused dispatches and the data bytes they carried."""
    from seaweedfs_tpu_torch.stats import metrics
    out = {s: metrics.FleetStageSecondsHistogram.labels(s).total
           for s in STAGES}
    out["dispatches"] = metrics.FleetDispatchBatchHistogram.labels().count
    out["bytes"] = metrics.FleetDispatchedBytesCounter.labels().value
    return out


def log_counters(label: str, before: dict) -> dict:
    after = fleet_counters()
    d = {k: after[k] - before[k] for k in after}
    per = d["bytes"] / d["dispatches"] if d["dispatches"] else 0.0
    log(f"  {label} stage sums: " + ", ".join(
        f"{s} {d[s]:.3f} s" for s in STAGES if d[s]) + (
        f"; {d['dispatches']} fused dispatches, {per:.0f} B of data per "
        "dispatch (the pinned input buffer)" if d["dispatches"] else ""))
    d["bytes_per_dispatch"] = per
    return d


def flip_byte(path: str, offset: int) -> None:
    with open(path, "r+b") as f:
        f.seek(offset)
        b = f.read(1)
        f.seek(offset)
        f.write(bytes([b[0] ^ 0xFF]))


def read_fleet_sample(store, sample: dict, lost, decoder, rs) -> tuple:
    """read_ec_needle of every sampled needle from FLEET_THREADS threads;
    returns the latencies (s) of the reads that crossed a lost shard and
    of all reads. Any wrong byte fails the run."""
    from seaweedfs_tpu_torch.ec import store_ec
    from seaweedfs_tpu_torch.storage.needle import Needle
    items = sorted(sample.items())

    def worker(part):
        degraded, every = [], []
        for (vid, nid), (cookie, data) in part:
            ecv = store.find_ec_volume(vid)
            crosses = any(
                iv.to_shard_and_offset(ecv.large_block,
                                       ecv.small_block)[0] in lost
                for iv in ecv.locate_needle(nid)[2])
            t0 = time.perf_counter()
            got = store_ec.read_ec_needle(
                store, vid, Needle(id=nid, cookie=cookie), rs=rs,
                decoder=decoder)
            dt = time.perf_counter() - t0
            if got.data != data:
                raise AssertionError(f"volume {vid} needle {nid}: wrong bytes")
            every.append(dt)
            if crosses:
                degraded.append(dt)
        return degraded, every

    with concurrent.futures.ThreadPoolExecutor(FLEET_THREADS) as pool:
        parts = list(pool.map(worker, [items[i::FLEET_THREADS]
                                       for i in range(FLEET_THREADS)]))
    return ([t for d, _ in parts for t in d], [t for _, e in parts for t in e])


def check_fleet_shapes(n_vols: int, span: int, seed: int) -> int:
    """gf_linear on the card against its plain version at the fleet's own
    launch shapes: the rebuild's O=2 map at [B, 10, span], the verify's
    encode at [B, 10, span] and the decode fleet's O=1 map at one
    needle's interval for batches of 1, 7 and 16."""
    import torch
    from seaweedfs_tpu_torch.ops import gf_kernel
    from seaweedfs_tpu_torch.ops.rs_code import ReedSolomon, coding_matrix
    rs = ReedSolomon(backend="cpu")
    rebuild = rs.decode_matrix([i for i in range(14)
                                if i not in FLEET_REBUILD_LOST],
                               list(FLEET_REBUILD_LOST))
    read = rs.decode_matrix([i for i in range(14) if i not in LOST], [5])
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(seed)
    cases = [(rebuild, (n_vols, 10, span)), (coding_matrix()[10:],
                                             (n_vols, 10, span))]
    cases += [(read, (b, 10, needle_interval())) for b in (1, 7, 16)]
    for matrix, shape in cases:
        data = torch.randint(0, 256, shape, generator=gen, device=dev,
                             dtype=torch.uint8)
        gm = gf_kernel.prepare_matrix(matrix, dev)
        got = gf_kernel.gf_linear(gm, data)
        want = gf_kernel.gf_linear_plain(gm.m2, data)
        torch.cuda.synchronize()
        err = int((got.int() - want.int()).abs().max())
        if err:
            raise AssertionError(f"gf_linear {shape} O={gm.rows}: kernel "
                                 f"differs from plain (max err {err})")
        log(f"  {shape} O={gm.rows}: kernel == plain")
        del data, got, want
    return 0


def phase_fleet(workdir: str, seed: int, backend: str,
                counts=FLEET_NEEDLES, sample_size: int = FLEET_SAMPLE) -> tuple:
    """The fused-batch paths across many volumes: generate_ec_shards_batch,
    then bare fleet passes against per-volume encodes over hard-linked
    twins (fleet, per-volume, per-volume, fleet),
    fleet rebuild, fleet verify (clean, then two flipped bytes), and
    degraded reads through the decode fleet and the in-place path.
    Returns (metrics, the volumes for phase 7: their base names, shard
    hashes and sizes, and the two flipped bytes)."""
    from seaweedfs_tpu_torch.ec import encoder, fleet, store_ec
    from seaweedfs_tpu_torch.ec.encoder import (
        default_chunk_for, shard_file_name)
    from seaweedfs_tpu_torch.ops.rs_code import ReedSolomon
    from seaweedfs_tpu_torch.reads import DegradedReadFleet
    from seaweedfs_tpu_torch.storage.store import Store

    device = "cuda" if backend == "cuda" else "cpu"
    codec = None if backend == "cuda" else ReedSolomon(backend="cpu")
    rng = np.random.default_rng(seed + 1)
    vol_dir = os.path.join(workdir, "vol")
    twin_dir = os.path.join(workdir, "twin")
    os.makedirs(twin_dir)
    store = Store([vol_dir], [len(counts) + 4])
    launches = Launches(backend)
    out = {}
    try:
        t0 = time.perf_counter()
        sample = write_fleet(store, counts, seed, sample_size)
        vids = list(range(1, len(counts) + 1))
        bases = [store.find_volume(vid).file_name() for vid in vids]
        twins = []
        for vid, base in zip(vids, bases):
            store.find_volume(vid).sync()
            twin = os.path.join(twin_dir, str(vid))
            for ext in (".dat", ".idx"):
                os.link(base + ext, twin + ext)
            twins.append(twin)
        dat_bytes = sum(os.path.getsize(b + ".dat") for b in bases)
        log(f"  wrote {len(counts)} volumes, {sum(counts)} needles of "
            f"{NEEDLE_SIZE} B (seed {seed}): {dat_bytes} B of .dat in "
            f"{time.perf_counter() - t0:.1f} s")

        def per_volume():
            for twin in twins:
                encoder.write_ec_files(twin, backend=backend)
                encoder.write_sorted_file_from_idx(twin)

        def fleet_pass():
            fleet.fleet_write_ec_files(bases, backend=backend)
            for base in bases:
                encoder.write_sorted_file_from_idx(base)

        before = fleet_counters()
        _, secs = launches.run("fleet_generate",
                               store_ec.generate_ec_shards_batch, store,
                               vids, backend=backend)
        out["generate_stages"] = log_counters("generate_ec_shards_batch",
                                              before)
        out["generate_GBps"] = dat_bytes / secs / 1e9
        log(f"  generate_ec_shards_batch of {len(bases)} volumes: "
            f"{secs:.3f} s, {out['generate_GBps']:.3f} GB/s of .dat, "
            f"{launches.per_phase['fleet_generate']} launches")
        # the same work both ways, in a balanced order: a bare fleet pass
        # (no freeze or sync, unlike generate_ec_shards_batch) on either
        # side of the two per-volume passes
        runs = []
        for i, (name, fn) in enumerate((("fleet", fleet_pass),
                                        ("per_volume", per_volume),
                                        ("per_volume", per_volume),
                                        ("fleet", fleet_pass))):
            _, secs = launches.run(f"encode_{i}_{name}", fn)
            runs.append((name, secs, launches.per_phase[f"encode_{i}_{name}"]))
            log(f"  {name} encode of {len(bases)} volumes: {secs:.3f} s, "
                f"{dat_bytes / secs / 1e9:.3f} GB/s of .dat, "
                f"{runs[-1][2]} launches")
        out["encode_GBps"] = {
            name: [dat_bytes / secs / 1e9 for n_, secs, _ in runs
                   if n_ == name] for name in ("fleet", "per_volume")}
        hashes = [shard_hashes(b) for b in bases]
        for base, twin, want in zip(bases, twins, hashes):
            if shard_hashes(twin) != want or \
                    sha256_file(base + ".ecx") != sha256_file(twin + ".ecx"):
                raise AssertionError(f"{base}: fleet shards differ from the "
                                     "per-volume encode")
        shard_sizes = [os.path.getsize(shard_file_name(b, 0)) for b in bases]
        for base, size in zip(bases, shard_sizes):
            check_parity_spans(base, size, rng, 4, 64 << 10, device)
        log(f"  {len(bases)} x 14 shard hashes and .ecx identical to the "
            "per-volume encode; parity of 4 sampled 64 KiB spans per "
            "volume == gf_linear_plain")
        for twin in twins:
            for path in [shard_file_name(twin, i) for i in range(14)] + \
                    [twin + ".ecx"]:
                os.remove(path)

        chunk = default_chunk_for(backend)
        if backend == "cuda":
            check_fleet_shapes(len(bases), chunk // len(bases), seed)

        for base in bases:
            for sid in FLEET_REBUILD_LOST:
                os.remove(shard_file_name(base, sid))
        before = fleet_counters()
        rebuilt, secs = launches.run("fleet_rebuild",
                                     fleet.fleet_rebuild_ec_files, bases,
                                     backend=backend)
        out["rebuild_stages"] = log_counters("fleet_rebuild_ec_files", before)
        if any(rebuilt[b] != list(FLEET_REBUILD_LOST) for b in bases) or \
                [shard_hashes(b) for b in bases] != hashes:
            raise AssertionError("fleet rebuild: shard hashes differ")
        out["rebuild_GBps"] = 10 * sum(shard_sizes) / secs / 1e9
        log(f"  fleet_rebuild_ec_files {FLEET_REBUILD_LOST} of every volume: "
            f"{secs:.3f} s, {out['rebuild_GBps']:.3f} GB/s of shards read, "
            f"{launches.per_phase['fleet_rebuild']} launches, hashes "
            f"identical; pinned per fused batch: {10 * chunk} B in (chunk "
            f"{chunk} B per shard row x 10), "
            f"{len(FLEET_REBUILD_LOST) * chunk} B out")

        before = fleet_counters()
        res, secs = launches.run("fleet_verify", fleet.fleet_verify_ec_files,
                                 bases, backend=backend)
        out["verify_stages"] = log_counters("fleet_verify_ec_files", before)
        if not all(r.clean for r in res.values()):
            raise AssertionError("fleet verify: clean volumes reported")
        verified = sum(r.bytes_verified for r in res.values())
        out["verify_GBps"] = verified / secs / 1e9
        log(f"  fleet_verify_ec_files: {secs:.3f} s, "
            f"{out['verify_GBps']:.3f} GB/s of data shards, "
            f"{launches.per_phase['fleet_verify']} launches, all clean")
        bad_parity, bad_data = bases[0], bases[len(bases) // 2]
        off_p = int(rng.integers(0, shard_sizes[0]))
        off_d = int(rng.integers(0, shard_sizes[len(bases) // 2]))
        flip_byte(bad_parity + ".ec11", off_p)
        flip_byte(bad_data + ".ec04", off_d)
        res, secs = launches.run("fleet_verify_damaged",
                                 fleet.fleet_verify_ec_files, bases,
                                 backend=backend)
        for base, r in res.items():
            want = ({11: 1}, {11: off_p}) if base == bad_parity else \
                (dict.fromkeys((10, 11, 12, 13), 1),
                 dict.fromkeys((10, 11, 12, 13), off_d)) \
                if base == bad_data else ({}, {})
            if (r.parity_mismatch, r.first_mismatch) != want or \
                    not r.verified or r.missing:
                raise AssertionError(f"fleet verify {base}: {r}")
        log(f"  flipped .ec11 byte {off_p} of volume 1 and .ec04 byte "
            f"{off_d} of volume {len(bases) // 2 + 1}: only those two "
            f"reported, counts and offsets exact ({secs:.3f} s)")
        flip_byte(bad_parity + ".ec11", off_p)
        flip_byte(bad_data + ".ec04", off_d)

        for vid in vids:
            store.location_of(vid).unload_volume(vid)
            store_ec.mount_ec_shards(store, vid, "", [
                i for i in range(14) if i not in LOST])
        decoder = DegradedReadFleet(backend=backend)
        try:
            (lat, every), secs = launches.run(
                "fleet_reads", read_fleet_sample, store, sample, LOST,
                decoder, codec)
        finally:
            decoder.stop()
        (lat_ip, every_ip), secs_ip = launches.run(
            "in_place_reads", read_fleet_sample, store, sample, LOST, None,
            codec)
        for key, phase, d, e, t in (
                ("decode_fleet", "fleet_reads", lat, every, secs),
                ("in_place", "in_place_reads", lat_ip, every_ip, secs_ip)):
            ms = np.array(d) * 1e3
            out[f"{key}_p50_ms"] = float(np.percentile(ms, 50))
            out[f"{key}_p99_ms"] = float(np.percentile(ms, 99))
            log(f"  {phase}: {len(e)} reads from {FLEET_THREADS} threads "
                f"with shards {LOST} missing, {len(d)} degraded, in "
                f"{t:.2f} s; degraded p50 {out[f'{key}_p50_ms']:.3f} ms, "
                f"p99 {out[f'{key}_p99_ms']:.3f} ms; "
                f"{launches.per_phase[phase]} launches; all bytes match")
        mean_batch = decoder.spans_decoded / max(decoder.dispatches, 1)
        out["decode_fleet_dispatches"] = decoder.dispatches
        out["decode_fleet_spans"] = decoder.spans_decoded
        out["decode_fleet_mean_batch"] = mean_batch
        log(f"  decode fleet: {decoder.dispatches} dispatches for "
            f"{decoder.spans_decoded} spans, mean batch {mean_batch:.2f}")
        for vid in vids:
            store_ec.unmount_ec_shards(store, vid, range(14))

        before = fleet_counters()
        if backend == "cuda":
            wall_ms, busy = device_busy(fleet_pass)
            log_busy("fleet_write_ec_files", wall_ms, busy)
            out["trace"] = dict(wall_ms=wall_ms,
                                **{f"{k}_ms": v for k, v in busy.items()})
        else:
            fleet_pass()
        out["trace_stages"] = log_counters("traced fleet encode", before)
        if [shard_hashes(b) for b in bases] != hashes:
            raise AssertionError("traced fleet encode: shards differ")
        out["dat_bytes"] = dat_bytes
    finally:
        store.close()
    out["launches"] = launches.per_phase
    ctx = dict(vol_dir=vol_dir, bases=bases, hashes=hashes, counts=counts,
               shard_sizes=shard_sizes,
               flips=((bad_parity + ".ec11", off_p),
                      (bad_data + ".ec04", off_d)))
    return out, ctx


# --- phase 7 ------------------------------------------------------------------

COMPARE_LANES = (0, 1, 127, 128, 32768 + 257, BIG_LANES)
COMPARE_OFFSETS = (0, 1 << 20)
COMPARE_KERNELS = ("compare_rows", "init_rows", "finish_rows")
# VerifyResult fields that the mesh verify must share with the fleet
# verify (spans differ: the two cut their spans from different budgets)
VERIFY_FIELDS = ("parity_mismatch", "first_mismatch", "missing",
                 "parity_checked", "bytes_verified", "verified")


def compare_cases(n: int, gen, device):
    """(label, a, b, limits) at [2, 4, n]: rows that match, a first-lane,
    a last-lane and an at-the-limit mismatch, and sparse random ones,
    under limits of 0, partial and full. Yields one case at a time."""
    import torch
    a = torch.randint(0, 256, (2, 4, n), generator=gen, device=device,
                      dtype=torch.uint8)
    lim = torch.tensor([[n, n // 2, 0, max(n - 1, 0)], [n, n, n // 3, 1]],
                       dtype=torch.int32, device=device)
    for label in ("match", "first", "last", "at_limit", "random"):
        b = a.clone()
        if n and label == "first":
            b[..., 0] ^= 1
        elif n and label == "last":
            b[..., n - 1] ^= 0x80
        elif n and label == "at_limit":
            for r, p in np.ndindex(2, 4):
                k = int(lim[r, p])
                if k < n:
                    b[r, p, k] ^= 7        # at the limit: not counted
                if k > 0:
                    b[r, p, k - 1] ^= 7    # just below: counted
        elif n and label == "random":
            b[torch.rand(b.shape, generator=gen, device=device) < 1e-3] ^= 0x5A
        yield label, a, b, lim


def phase_compare_kernel(seed: int, span: int) -> dict:
    """gf_compare on the card against gf_compare_plain (also on the card),
    byte-exact counts and first indices, at every N of COMPARE_LANES, the
    mesh verify bucket's [1, 4, lanes] (the span padded to a multiple of
    16 lanes) and the unpadded span, at lane offsets 0 and 2^20; then its
    times at the bucket against its bound, and on the card at the
    unpadded span too (where the kernel takes its byte path)."""
    import torch
    from seaweedfs_tpu_torch.ops import gf_compare
    from seaweedfs_tpu_torch.parallel import mesh_fleet
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(seed)
    lanes = mesh_fleet._lanes_for(span, 1)
    max_err = 0
    for n in COMPARE_LANES + (span, lanes):
        for label, a, b, lim in compare_cases(n, gen, dev):
            for off in COMPARE_OFFSETS:
                got = gf_compare.gf_compare(a, b, lim + off, off)
                want = gf_compare.gf_compare_plain(a, b, lim + off, off)
                torch.cuda.synchronize()
                err = max(int((g.long() - w.long()).abs().max())
                          for g, w in zip(got, want))
                max_err = max(max_err, err)
                if err:
                    raise AssertionError(
                        f"gf_compare {label} N={n} offset {off}: kernel "
                        f"{[t.tolist() for t in got]} != plain "
                        f"{[t.tolist() for t in want]}")
            del a, b
        log(f"  N={n}: gf_compare == plain (match, first, last, at the "
            f"limit, random; limits 0/partial/full; offsets "
            f"{COMPARE_OFFSETS})")
    a = torch.randint(0, 256, (1, 4, lanes), generator=gen, device=dev,
                      dtype=torch.uint8)
    b = a.clone()
    b[..., ::4099] ^= 1
    lim = torch.full((1, 4), span, dtype=torch.int32, device=dev)

    def kernel():
        gf_compare.gf_compare(a, b, lim)

    ms = time_ms(kernel, 50)
    ms_pipelined = time_ms(kernel, 20, 10)
    ms_device = device_ms(kernel, 50, COMPARE_KERNELS)
    plain_ms = time_ms(lambda: gf_compare.gf_compare_plain(a, b, lim), 5)
    count_floor_ms = time_ms(lambda: (a != b).sum(-1), 20)
    bound_ms = 2 * a.numel() / HBM_BYTES_PER_S * 1e3
    a_span, b_span = a[..., :span].contiguous(), b[..., :span].contiguous()
    ms_device_span = device_ms(
        lambda: gf_compare.gf_compare(a_span, b_span, lim), 50,
        COMPARE_KERNELS)
    del a_span, b_span
    log(f"  gf_compare mesh verify bucket {tuple(a.shape)}: {ms:.4f} ms "
        f"single (median of 50, {bound_ms / ms:.2%} of bound), "
        f"{ms_pipelined:.4f} ms pipelined (median of 20 x 10, "
        f"{bound_ms / ms_pipelined:.2%}), " + (
            f"{ms_device:.4f} ms on the card (3 kernels, mean of 50, "
            f"{bound_ms / ms_device:.2%})" if ms_device else
            "time on the card not measured") +
        f", bound {bound_ms:.4g} ms (2 x {a.numel()} B), plain "
        f"{plain_ms:.3f} ms; (a != b).sum(-1) alone {count_floor_ms:.4f} ms")
    log(f"  gf_compare at the unpadded span [1, 4, {span}] (byte path): "
        + (f"{ms_device_span:.4f} ms on the card (mean of 50) against "
           f"{ms_device:.4f} at [1, 4, {lanes}]" if ms_device_span else
           "time on the card not measured"))
    return dict(max_abs_err=max_err, shape=list(a.shape), ms=ms,
                ms_pipelined=ms_pipelined, ms_device=ms_device,
                plain_ms=plain_ms, bound_ms=bound_ms,
                count_floor_ms=count_floor_ms,
                ms_device_unpadded_span=ms_device_span)


def mesh_fallbacks() -> float:
    from seaweedfs_tpu_torch.stats import metrics
    return sum(metrics.FleetMeshFallbacksCounter.labels(r).value
               for r in ("unavailable", "timeout", "error"))


def scrub_counters() -> dict:
    from seaweedfs_tpu_torch.stats import metrics as m
    out = {"scanned_bytes": m.ScrubScannedBytesCounter.labels().value,
           "needles_verified": m.ScrubNeedlesVerifiedCounter.labels().value,
           "stripes_verified": m.ScrubStripesVerifiedCounter.labels().value,
           "unrecoverable": m.ScrubUnrecoverableCounter.labels().value,
           "pass_seconds_sum": m.ScrubPassSecondsHistogram.labels().total}
    for kind in ("needle", "ec_data", "ec_parity"):
        out[f"found_{kind}"] = \
            m.ScrubCorruptionsFoundCounter.labels(kind).value
        out[f"repaired_{kind}"] = \
            m.ScrubCorruptionsRepairedCounter.labels(kind).value
    return out


def check_same_verify(got: dict, want: dict, label: str) -> None:
    if set(got) != set(want) or any(
            getattr(got[b], f) != getattr(want[b], f)
            for b in want for f in VERIFY_FIELDS):
        raise AssertionError(f"{label}: mesh verify != fleet verify")


def dead_data_byte(base: str, shard_size: int, dat_size: int) -> tuple:
    """(data shard, offset) of a shard byte past the end of the .dat:
    padding that no needle CRC covers (small rows of 1 MiB blocks)."""
    from seaweedfs_tpu_torch.ec.encoder import SMALL_BLOCK_SIZE
    off = shard_size - 100
    row, within = divmod(off, SMALL_BLOCK_SIZE)
    for sid in range(9, 4, -1):
        if (row * 10 + sid) * SMALL_BLOCK_SIZE + within >= dat_size:
            return sid, off
    raise AssertionError(f"{base}: no dead data-shard byte")


def phase_scrub_mesh(workdir: str, ctx: dict, seed: int, backend: str,
                     mesh_devices=None) -> dict:
    """Phase 6's volumes through the mesh scheduler on an explicit mesh
    (one card, or ``mesh_devices``) and through the scrub daemon: mesh
    verify against fleet verify, checked rebuild, sharded encode and the
    pipeline step, then one scrub pass over planted damage."""
    import torch
    from seaweedfs_tpu_torch import parallel
    from seaweedfs_tpu_torch.ec import fleet
    from seaweedfs_tpu_torch.ec.encoder import shard_file_name
    from seaweedfs_tpu_torch.ops import gf_kernel
    from seaweedfs_tpu_torch.ops.rs_code import coding_matrix
    from seaweedfs_tpu_torch.parallel import mesh_fleet

    bases, hashes = ctx["bases"], ctx["hashes"]
    mesh = parallel.make_mesh(
        devices=mesh_devices or [torch.device("cuda", 0)])
    dp, sp = mesh.shape["dp"], mesh.shape["sp"]
    launches = Launches(backend)
    fallbacks = mesh_fallbacks()
    rng = np.random.default_rng(seed + 7)
    out = {"mesh": mesh.shape}
    log(f"  mesh {mesh}")

    # (b) mesh verify against fleet verify, fleet, mesh, mesh, fleet
    runs = []
    for i, name in enumerate(("fleet", "mesh", "mesh", "fleet")):
        before = fleet_counters()
        if name == "fleet":
            res, secs = launches.run(f"verify_{i}_fleet",
                                     fleet.fleet_verify_ec_files, bases,
                                     backend=backend)
        else:
            res, secs = launches.run(f"verify_{i}_mesh",
                                     mesh_fleet.mesh_verify_ec_files,
                                     bases, mesh=mesh, compare=True)
        stages = log_counters(f"{name} verify", before)
        if not all(r.clean for r in res.values()):
            raise AssertionError(f"{name} verify: clean volumes reported")
        gbps = sum(r.bytes_verified for r in res.values()) / secs / 1e9
        runs.append((name, gbps, stages))
        log(f"  {name} verify of {len(bases)} volumes: {secs:.3f} s, "
            f"{gbps:.3f} GB/s of data shards, "
            f"{launches.per_phase[f'verify_{i}_{name}']} gf_linear and "
            f"{launches.compare_per_phase[f'verify_{i}_{name}']} gf_compare "
            "launches, all clean")
    out["verify_GBps"] = {n: [g for n_, g, _ in runs if n_ == n]
                          for n in ("fleet", "mesh")}
    out["verify_stages"] = [dict(name=n, **st) for n, _, st in runs]
    for path, off in ctx["flips"]:
        flip_byte(path, off)
    got, _ = launches.run("mesh_verify_damaged",
                          mesh_fleet.mesh_verify_ec_files, bases, mesh=mesh,
                          compare=True)
    want, _ = launches.run("fleet_verify_damaged",
                           fleet.fleet_verify_ec_files, bases,
                           backend=backend)
    check_same_verify(got, want, "two flipped bytes")
    dirty = sorted(b for b, r in got.items() if not r.clean)
    if dirty != sorted({os.path.splitext(p)[0] for p, _ in ctx["flips"]}):
        raise AssertionError(f"mesh verify flagged {dirty}")
    log(f"  two flipped bytes: mesh verify == fleet verify field for field "
        f"({', '.join(VERIFY_FIELDS)}): "
        + "; ".join(f"{os.path.basename(b)} {got[b].parity_mismatch} at "
                    f"{got[b].first_mismatch}" for b in dirty))
    for path, off in ctx["flips"]:
        flip_byte(path, off)
    if backend == "cuda":
        wall_ms, busy = device_busy(
            lambda: mesh_fleet.mesh_verify_ec_files(bases, mesh=mesh))
        log_busy("mesh_verify_ec_files", wall_ms, busy)
        out["verify_trace"] = dict(wall_ms=wall_ms, **{
            f"{k}_ms": v for k, v in busy.items()})

    # (c) checked rebuild: byte-identical, and it trips on a bad survivor
    for base in bases:
        for sid in FLEET_REBUILD_LOST:
            os.remove(shard_file_name(base, sid))
    rebuilt, secs = launches.run("mesh_rebuild_check",
                                 mesh_fleet.mesh_rebuild_ec_files, bases,
                                 mesh=mesh, check=True, compare=True)
    if any(rebuilt[b] != list(FLEET_REBUILD_LOST) for b in bases) or \
            [shard_hashes(b) for b in bases] != hashes:
        raise AssertionError("checked mesh rebuild: shard hashes differ")
    out["rebuild_check_GBps"] = \
        12 * sum(ctx["shard_sizes"]) / secs / 1e9
    log(f"  mesh_rebuild_ec_files {FLEET_REBUILD_LOST} check=True: "
        f"{secs:.3f} s, {out['rebuild_check_GBps']:.3f} GB/s of the 12 "
        f"surviving shards read, "
        f"{launches.per_phase['mesh_rebuild_check']} gf_linear and "
        f"{launches.compare_per_phase['mesh_rebuild_check']} gf_compare "
        "launches, hashes identical")
    victim = bases[-1]
    survivor = shard_file_name(victim, 5)

    def trip() -> None:
        try:
            mesh_fleet.mesh_rebuild_ec_files([victim], mesh=mesh,
                                             check=True)
        except mesh_fleet.MeshVerifyMismatch:
            return
        raise AssertionError("checked rebuild passed a corrupt survivor")

    for sid in FLEET_REBUILD_LOST:
        os.remove(shard_file_name(victim, sid))
    flip_byte(survivor, 100)
    launches.run("mesh_rebuild_trip", trip, compare=True)
    if any(os.path.exists(shard_file_name(victim, sid))
           for sid in FLEET_REBUILD_LOST):
        raise AssertionError("a tripped rebuild left its files behind")
    flip_byte(survivor, 100)
    mesh_fleet.mesh_rebuild_ec_files([victim], mesh=mesh, check=True)
    if shard_hashes(victim) != hashes[-1]:
        raise AssertionError("rebuild after the trip: hashes differ")
    log(f"  a flipped byte in {os.path.basename(survivor)}: "
        "MeshVerifyMismatch, no rebuilt file left; rebuilt again after "
        "the flip was undone, hashes identical")

    # (d) sharded encode of every volume, the pipeline step, a rotation
    _, secs = launches.run("sharded_write", parallel.sharded_write_ec_files,
                           mesh, bases)
    if [shard_hashes(b) for b in bases] != hashes:
        raise AssertionError("sharded_write_ec_files: shards differ")
    dat_bytes = sum(os.path.getsize(b + ".dat") for b in bases)
    out["sharded_write_GBps"] = dat_bytes / secs / 1e9
    log(f"  sharded_write_ec_files of {len(bases)} volumes: {secs:.3f} s, "
        f"{out['sharded_write_GBps']:.3f} GB/s of .dat, "
        f"{launches.per_phase['sharded_write']} launches, shards identical "
        "to phase 6's")
    lanes = (4 << 20) if backend == "cuda" else (64 << 10)
    data = rng.integers(0, 256, (2 * dp, 10, sp * lanes), dtype=np.uint8)
    (parity, step_rebuilt, mism), secs = launches.run(
        "pipeline_step", parallel.ec_pipeline_step, mesh, data,
        compare=True)
    dev = mesh.flat[0]
    gm = gf_kernel.prepare_matrix(coding_matrix()[10:], dev)
    want_parity = gf_kernel.gf_linear_plain(
        gm.m2, torch.from_numpy(data).to(dev)).cpu().numpy()
    parity = np.asarray(parity)
    if mism != 0 or not np.array_equal(parity, want_parity) or \
            not np.array_equal(np.asarray(step_rebuilt)[:, 0], data[:, 3]):
        raise AssertionError(f"ec_pipeline_step: {mism} mismatches")
    rotated = np.asarray(parallel.rotate_shards(mesh, parity, shift=1))
    if not np.array_equal(rotated, np.roll(parity, data.shape[0] // dp, 0)):
        raise AssertionError("rotate_shards moved the wrong blocks")
    log(f"  ec_pipeline_step {data.shape}: 0 mismatches, parity == "
        f"gf_linear_plain, {launches.per_phase['pipeline_step']} gf_linear "
        f"and {launches.compare_per_phase['pipeline_step']} gf_compare "
        f"launches ({secs:.3f} s); rotate_shards with dp={dp} == its roll")

    # (e) one scrub pass over planted damage
    out["scrub"] = phase_scrub(workdir, ctx, mesh, backend, launches, rng)
    if mesh_fallbacks() != fallbacks:
        raise AssertionError("the mesh scheduler fell back")
    out["launches"] = launches.per_phase
    out["compare_launches"] = launches.compare_per_phase
    return out


def phase_scrub(workdir: str, ctx: dict, mesh, backend: str, launches,
                rng) -> dict:
    """One ScrubDaemon pass, its verify on the mesh, over a store of the
    last volumes of phase 6: up to four EC volumes (a live needle byte
    flipped in a data shard, a parity byte, a dead-space byte in a data
    shard, one clean) and the last volume as a normal volume with one
    CRC-bad needle and a replica copied aside. The rest stay out of the
    store: the needle sweep is Python, about 20 us a needle."""
    from seaweedfs_tpu_torch.ec.encoder import (
        default_chunk_for, shard_file_name)
    from seaweedfs_tpu_torch.parallel import mesh_fleet
    from seaweedfs_tpu_torch.scrub import ScrubDaemon
    from seaweedfs_tpu_torch.storage.needle import Needle
    from seaweedfs_tpu_torch.storage.store import Store
    from seaweedfs_tpu_torch.storage.volume import Volume

    vol_dir, counts, hashes = ctx["vol_dir"], ctx["counts"], ctx["hashes"]
    normal = len(counts)
    ec_vids = list(range(max(1, normal - 4), normal))
    scrub_dir = os.path.join(workdir, "scrub")
    replica_dir = os.path.join(workdir, "replica")
    os.makedirs(scrub_dir)
    os.makedirs(replica_dir)
    for vid in ec_vids:
        for ext in [f".ec{i:02d}" for i in range(14)] + [".ecx", ".ecj"]:
            src = os.path.join(vol_dir, f"{vid}{ext}")
            if os.path.exists(src):
                os.replace(src, os.path.join(scrub_dir, f"{vid}{ext}"))
    for ext in (".dat", ".idx"):
        os.replace(os.path.join(vol_dir, f"{normal}{ext}"),
                   os.path.join(scrub_dir, f"{normal}{ext}"))
        shutil.copyfile(os.path.join(scrub_dir, f"{normal}{ext}"),
                        os.path.join(replica_dir, f"{normal}{ext}"))
    store = Store([scrub_dir], [8])
    replica = Volume(replica_dir, "", normal, create_if_missing=False)
    try:
        planted = {}   # (vid, shard) -> what was flipped
        ecv = store.find_ec_volume(ec_vids[0])
        nid = next(i for i in range(100, counts[ec_vids[0] - 1])
                   if ecv.locate_needle(i)[2][0].size >= 64)
        sid, soff = ecv.locate_needle(nid)[2][0].to_shard_and_offset(
            ecv.large_block, ecv.small_block)
        flip_byte(shard_file_name(ecv.base_name, sid), soff + 30)
        planted[(ec_vids[0], sid)] = f"needle {nid} data byte"
        if len(ec_vids) > 1:
            ecv = store.find_ec_volume(ec_vids[1])
            flip_byte(shard_file_name(ecv.base_name, 11),
                      int(rng.integers(0, ecv.shard_size)))
            planted[(ec_vids[1], 11)] = "parity byte"
        if len(ec_vids) > 2:
            ecv = store.find_ec_volume(ec_vids[2])
            sid, off = dead_data_byte(
                ecv.base_name, ecv.shard_size,
                os.path.getsize(os.path.join(vol_dir,
                                             f"{ec_vids[2]}.dat")))
            flip_byte(shard_file_name(ecv.base_name, sid), off)
            planted[(ec_vids[2], sid)] = f"dead-space byte at {off}"
        v = store.find_volume(normal)
        bad_nid = 1 + counts[normal - 1] // 2
        nv = v.nm.get(bad_nid)
        flip_byte(v.dat_path, nv.offset + 16 + 4 + 3)

        def replica_fetch(vid: int, n) -> bytes:
            if vid != normal:
                return None
            return replica.read_needle(Needle(id=n.id, cookie=n.cookie)).data

        d = ScrubDaemon(store, backend=backend, replica_fetch=replica_fetch,
                        mesh_cfg={"mesh": mesh})
        before = scrub_counters()
        res, secs = launches.run("scrub_pass", d.run_pass, compare=True)
        after = scrub_counters()
        dp = mesh.shape["dp"]
        sizes = {vid: store.find_ec_volume(vid).shard_size
                 for vid in ec_vids}
        span = max(1, min((mesh_fleet.DEFAULT_BUCKET_MB << 20) // (dp * 10),
                          max(sizes.values())))
        chunk = default_chunk_for(backend)
        repaired = sorted({vid for vid, _ in planted})
        want = dict(
            needles_verified=sum(counts[vid - 1] for vid in ec_vids) +
            counts[normal - 1],
            stripes_verified=sum(-(-s // span) for s in sizes.values()) +
            sum(-(-sizes[vid] // min(chunk, sizes[vid]))
                for vid in repaired),
            corruptions_found=len(planted) + 1,
            corruptions_repaired=len(planted) + 1, unrecoverable=0,
            volumes=1, ec_volumes=len(ec_vids))
        got = {k: getattr(res, k) for k in want}
        if got != want:
            raise AssertionError(f"scrub pass: {got} != {want}\n"
                                 + "\n".join(res.details))
        for (vid, sid), what in planted.items():
            path = shard_file_name(os.path.join(scrub_dir, str(vid)), sid)
            if sha256_file(path) != hashes[vid - 1][sid] or \
                    not os.path.exists(path + ".corrupt"):
                raise AssertionError(f"{path} ({what}) not repaired")
        if v.read_needle(Needle(id=bad_nid)).data != \
                replica.read_needle(Needle(id=bad_nid)).data:
            raise AssertionError("the CRC-bad needle was not rewritten")
        delta = {k: after[k] - before[k] for k in after}
        log(f"  scrub pass over {len(ec_vids)} EC volumes and 1 volume "
            f"with {len(planted) + 1} planted faults ("
            + ", ".join(f"volume {vid} .ec{sid:02d}: {what}"
                        for (vid, sid), what in planted.items())
            + f", volume {normal} needle {bad_nid}): {secs:.3f} s; "
            f"{got}; every damaged shard byte-identical with its .corrupt "
            "copy kept, the needle rewritten from the replica; "
            f"{launches.per_phase['scrub_pass']} gf_linear and "
            f"{launches.compare_per_phase['scrub_pass']} gf_compare "
            "launches")
        log("  Scrub* counters over the pass: " + json.dumps(delta))
        return dict(seconds=secs, result=got, counters=delta,
                    bytes_scanned=res.bytes_scanned)
    finally:
        store.close()
        replica.close()


# --- phase 8 ------------------------------------------------------------------

# The cluster configuration: four volume servers, volumes of at most
# 1,024 MiB, 512 MiB of needles of 1-256 KiB (uniform), written from 16
# client threads into collection "smoke"; the master grows 7 volumes. (At
# 2 GiB the whole run took past eight minutes; at 1 GiB, with phase 10,
# 458 s of the 480 on an NVIDIA H100 80GB HBM3 at 700 W; with the
# gateways of phase 15, 512 MiB took the run to 497 s, so it is cut to
# 384 MiB, PERF.md §4.) Every server runs the read cache and hedged shard
# reads; the last one the kv needle map. The cache's RAM tier holds every
# needle a server serves in (c) and both passes of (d): (c) and (d) read
# half the needles each (about 2,050 of 128 KiB mean), about 64 MiB on
# each of 4 servers in (c) and 86 MiB on each of 3 in (d), plus at most as
# much again of reconstructed spans; 1,024 MiB a server leaves room.
SERVICE_SERVERS = 4
SERVICE_BYTES = 384 << 20
SERVICE_NEEDLE_MAX = 256 << 10
SERVICE_THREADS = 16
SERVICE_SAMPLE = 4096
SERVICE_VOLUMES = 7
SERVICE_CACHE_MB = 1024
CLI_BLOBS = 64


def free_port_pair() -> int:
    """A port p where both p and p + 10000 (its RPC sibling) are free."""
    import socket
    for _ in range(200):
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            p = s.getsockname()[1]
        if p + 10000 > 65535:
            continue
        try:
            with socket.socket() as s2:
                s2.bind(("127.0.0.1", p + 10000))
            return p
        except OSError:
            continue
    raise RuntimeError("no free port pair")


def wait_until(predicate, timeout: float, what: str):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        v = predicate()
        if v:
            return v
        time.sleep(0.02)
    raise AssertionError(f"timed out waiting for {what}")


def http_get(url: str) -> bytes:
    """GET "host:port/path", following one redirect (a volume server
    sends a reader to the holder of a normal volume)."""
    from seaweedfs_tpu_torch.operation import operations
    r = operations.http_request("GET", url)
    if r.status in (301, 302) and "location" in r.headers:
        r = operations.http_request(
            "GET", r.headers["location"].split("//", 1)[1])
    if r.status != 200:
        raise AssertionError(f"GET {url}: http {r.status} {r.body[:200]!r}")
    return r.body


def upload_needles(master_url: str, total: int, seed: int,
                   collection: str = "smoke", replication: str = "",
                   buf: bytes = b"") -> tuple:
    """About ``total`` bytes of needles, sizes uniform in 1 B-256 KiB, from
    SERVICE_THREADS threads through operations.assign + upload_data. The
    bytes are slices of one seeded random buffer (``buf`` when given).
    Returns ({fid: (offset, size)}, the buffer, wall seconds)."""
    from seaweedfs_tpu_torch.operation import operations
    rng = np.random.default_rng(seed)
    buf = buf or rng.bytes(64 << 20)
    sizes = []
    while sum(sizes) < total:
        sizes.append(int(rng.integers(1, SERVICE_NEEDLE_MAX + 1)))
    offsets = rng.integers(0, len(buf) - SERVICE_NEEDLE_MAX, len(sizes))
    jobs = list(zip(offsets.tolist(), sizes))

    def worker(part):
        out = {}
        for off, size in part:
            a = operations.assign(master_url, collection=collection,
                                  replication=replication)
            operations.upload_data(f"{a.url}/{a.fid}", buf[off:off + size])
            out[a.fid] = (off, size)
        return out

    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(SERVICE_THREADS) as pool:
        parts = list(pool.map(worker, [jobs[i::SERVICE_THREADS]
                                       for i in range(SERVICE_THREADS)]))
    secs = time.perf_counter() - t0
    return {k: v for p in parts for k, v in p.items()}, buf, secs


def read_sample(servers, sample, buf, lost=None) -> tuple:
    """GET every sampled fid from a random server (seeded per fid), from
    SERVICE_THREADS threads; returns (latencies of all reads, latencies
    of the reads whose needle lies on a shard in ``lost`` {vid: set of
    shard ids}). Any wrong byte fails the run."""
    from seaweedfs_tpu_torch.operation.file_id import parse_fid
    items = sorted(sample.items())

    def crosses(fid: str) -> bool:
        if not lost:
            return False
        f = parse_fid(fid)
        ecv = next(vs.store.find_ec_volume(f.volume_id) for vs in servers
                   if vs.store.find_ec_volume(f.volume_id) is not None)
        return any(iv.to_shard_and_offset(ecv.large_block,
                                          ecv.small_block)[0]
                   in lost.get(f.volume_id, ())
                   for iv in ecv.locate_needle(f.key)[2])

    def worker(part):
        every, degraded = [], []
        for i, (fid, (off, size)) in part:
            vs = servers[(i * 2654435761) % len(servers)]
            t0 = time.perf_counter()
            got = http_get(f"{vs.url}/{fid}")
            dt = time.perf_counter() - t0
            if got != buf[off:off + size]:
                raise AssertionError(f"{fid} from {vs.url}: wrong bytes")
            every.append(dt)
            if crosses(fid):
                degraded.append(dt)
        return every, degraded

    indexed = list(enumerate(items))
    with concurrent.futures.ThreadPoolExecutor(SERVICE_THREADS) as pool:
        parts = list(pool.map(worker, [indexed[i::SERVICE_THREADS]
                                       for i in range(SERVICE_THREADS)]))
    return ([t for e, _ in parts for t in e],
            [t for _, d in parts for t in d])


def pcts(lat) -> str:
    if not lat:
        return "no reads"
    a = np.asarray(lat) * 1e3
    return (f"p50 {np.percentile(a, 50):.3f} ms, "
            f"p99 {np.percentile(a, 99):.3f} ms over {len(a)} reads")


def check_stripes(dat_path: str, shard_paths: list) -> None:
    """Data shard i holds the .dat's small blocks i, i + 10, ... (1 MiB
    rows of ten; the volumes are far below the 1 GiB large block)."""
    from seaweedfs_tpu_torch.ec.encoder import (LARGE_BLOCK_SIZE,
                                                SMALL_BLOCK_SIZE)
    size = os.path.getsize(dat_path)
    if size >= 10 * LARGE_BLOCK_SIZE:
        raise AssertionError(f"{dat_path}: {size} B needs large rows")
    files = [open(p, "rb") for p in shard_paths[:10]]
    try:
        with open(dat_path, "rb") as dat:
            row = 0
            while row * 10 * SMALL_BLOCK_SIZE < size:
                stripe = dat.read(10 * SMALL_BLOCK_SIZE)
                for i, f in enumerate(files):
                    part = stripe[i * SMALL_BLOCK_SIZE:
                                  (i + 1) * SMALL_BLOCK_SIZE]
                    f.seek(row * SMALL_BLOCK_SIZE)
                    got = f.read(SMALL_BLOCK_SIZE)
                    if got[:len(part)] != part or any(got[len(part):]):
                        raise AssertionError(
                            f"{shard_paths[i]} row {row} differs from "
                            f"{dat_path}")
                row += 1
    finally:
        for f in files:
            f.close()


def held(vs, vid: int) -> set:
    """The shard ids of vid a volume server has mounted."""
    ecv = vs.store.find_ec_volume(vid)
    return set(ecv.shard_bits.shard_ids) if ecv is not None else set()


def shard_paths_of(servers, collection: str, vid: int) -> list:
    """The one file of each of the 14 shards of ``vid``, wherever it is."""
    from seaweedfs_tpu_torch.ec.encoder import shard_file_name
    out = [None] * 14
    for vs in servers:
        base = os.path.join(vs.store.locations[0].directory,
                            f"{collection}_{vid}")
        for sid in range(14):
            if os.path.exists(shard_file_name(base, sid)):
                if out[sid] is not None:
                    raise AssertionError(f"volume {vid} shard {sid} twice")
                out[sid] = shard_file_name(base, sid)
    if None in out:
        raise AssertionError(f"volume {vid}: shards missing: {out}")
    return out


def span_seconds(names) -> dict:
    from seaweedfs_tpu_torch.stats import trace
    out = {n: 0.0 for n in names}
    for sp in trace.spans():
        if sp.name in out:
            out[sp.name] += sp.dur
    return out


def trace_span_cost(n: int = 20000) -> float:
    """Seconds one recorded span costs (enter, exit, store), measured by
    recording n empty spans; phase 8 (b) multiplies it by the spans its
    traced encode recorded, so the encode time's tracing share is known."""
    from seaweedfs_tpu_torch.stats import trace
    trace.enable(capacity=n)
    trace.clear()
    try:
        t0 = time.perf_counter()
        for _ in range(n):
            with trace.span("cost"):
                pass
        return (time.perf_counter() - t0) / n
    finally:
        trace.disable()
        trace.clear()


def cache_totals(servers) -> dict:
    """The read caches' hits, misses and invalidations, summed."""
    return {k: sum(getattr(vs.read_cache, k) for vs in servers)
            for k in ("hits", "misses", "invalidations")}


def commit_totals(servers) -> tuple:
    """(batches, requests, batches by the writer threads) of every
    volume's group commit."""
    stats = [v.commit_stats() for vs in servers
             for loc in vs.store.locations for v in loc.volumes.values()]
    return tuple(sum(x[i] for x in stats) for i in range(3))


def phase_fix(fix_dir: str, card: str) -> dict:
    """(h) ``fix`` of phase 3's volume (1,048,576 needles written once each,
    in id order): the .idx it writes from the .dat equals the original."""
    import contextlib
    import io
    from seaweedfs_tpu_torch.command import main as cli
    idx = os.path.join(fix_dir, "1.idx")
    with open(idx, "rb") as f:
        original = f.read()
    os.remove(idx)
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        code = cli(["fix", "-dir", fix_dir, "-volumeId", "1"])
    secs = time.perf_counter() - t0
    with open(idx, "rb") as f:
        rebuilt = f.read()
    if code != 0 or rebuilt != original:
        raise AssertionError(f"fix exited {code} ({out.getvalue()!r}); "
                             f".idx {len(rebuilt)} B against the original "
                             f"{len(original)} B")
    entries = len(original) // 16
    log(f"  (h) fix of phase 3's volume: {entries} entries from "
        f"{os.path.getsize(os.path.join(fix_dir, '1.dat'))} B of .dat in "
        f"{secs:.3f} s; the .idx equals the original byte for byte "
        f"[{card}]")
    return dict(seconds=secs, entries=entries)


def phase_service(workdir: str, seed: int, backend: str,
                  total_bytes: int = SERVICE_BYTES,
                  sample_size: int = SERVICE_SAMPLE, cli: bool = True,
                  card: str = "", fix_dir: str = "") -> dict:
    """The service path: a MasterServer and SERVICE_SERVERS VolumeServers
    in this process, (a) uploads over HTTP, (b) shell ec.encode of every
    volume, (c) healthy reads, (d) reads with one server stopped, twice,
    (e) ec.rebuild, (f) ec.decode, (g) the CLI as subprocesses, and, with
    ``fix_dir``, (h) the ``fix`` tool on phase 3's volume."""
    from seaweedfs_tpu_torch.operation.file_id import parse_fid
    from seaweedfs_tpu_torch.server.master import MasterServer
    from seaweedfs_tpu_torch.server.volume import VolumeServer
    from seaweedfs_tpu_torch.shell import Shell
    from seaweedfs_tpu_torch.stats import trace

    card = card or backend
    launches = Launches(backend)
    out = {}
    # the maintenance cron of phase 9 (k): an hour apart, so it runs
    # only when run_maintenance_now() asks
    master = MasterServer(port=free_port_pair(),
                          meta_dir=os.path.join(workdir, "master"),
                          volume_size_limit_mb=1024, pulse_seconds=1.0,
                          maintenance_scripts=MAINTENANCE_SCRIPTS,
                          maintenance_interval_s=3600.0)
    master.start()
    servers = []
    try:
        for i in range(SERVICE_SERVERS):
            d = os.path.join(workdir, f"vol{i}")
            os.makedirs(d)
            vs = VolumeServer(
                master.url, [d], port=free_port_pair(),
                max_volume_counts=[16], pulse_seconds=1.0,
                ec_encoder=backend, cache_size_mb=SERVICE_CACHE_MB,
                hedge_reads=True, needle_map_kind="kv"
                if i == SERVICE_SERVERS - 1 else "memory")
            vs.start()
            servers.append(vs)
        wait_until(lambda: len(master.topo.nodes()) == SERVICE_SERVERS, 30,
                   "the volume servers' heartbeats")

        # (a) upload
        blobs, buf, secs = upload_needles(master.url, total_bytes, seed)
        nbytes = sum(s for _, s in blobs.values())
        batches, batched, by_writer = commit_totals(servers)
        vids = sorted({parse_fid(f).volume_id for f in blobs})
        if len(vids) != SERVICE_VOLUMES:
            raise AssertionError(f"the master grew volumes {vids}, "
                                 f"not {SERVICE_VOLUMES}")
        snap = os.path.join(workdir, "snap")
        os.makedirs(snap)
        dats = {}
        for vid in vids:
            owner = next(vs for vs in servers if vs.store.has_volume(vid))
            v = owner.store.find_volume(vid)
            v.sync()
            # a hard link keeps the .dat after ec.encode retires it
            dats[vid] = os.path.join(snap, f"{vid}.dat")
            os.link(v.file_name() + ".dat", dats[vid])
        with concurrent.futures.ThreadPoolExecutor(4) as pool:
            hashes = dict(zip(vids, pool.map(sha256_file,
                                             [dats[v] for v in vids])))
        dat_bytes = sum(os.path.getsize(p) for p in dats.values())
        out["upload"] = dict(needles=len(blobs), bytes=nbytes,
                             seconds=secs, MBps=nbytes / secs / 1e6,
                             volumes=len(vids), dat_bytes=dat_bytes,
                             batches=batches, batched_requests=batched,
                             writer_batches=by_writer,
                             mean_batch=batched / batches)
        log(f"  (a) upload: {len(blobs)} needles, {nbytes} B in "
            f"{secs:.3f} s from {SERVICE_THREADS} threads = "
            f"{nbytes / secs / 1e6:.1f} MB/s; group commit: {batched} "
            f"requests in {batches} batches, "
            f"{out['upload']['mean_batch']:.3f} a batch; {by_writer} "
            f"batches by the writer threads (contended writes), the rest "
            f"inline; {len(vids)} volumes, {dat_bytes} B of .dat [{card}]")

        # (b) encode through the shell
        sh = Shell(master.url)
        trace.enable(capacity=1 << 16)
        trace.clear()
        try:
            text, secs = launches.run(
                "service_encode", sh.run_command,
                "ec.encode -collection=smoke "
                f"-volumeId={','.join(map(str, vids))}")
            spans = span_seconds(("shell.ec_encode.generate",
                                  "shell.ec_encode.spread",
                                  "shell.ec_encode.copy",
                                  "store_ec.generate_batch"))
            n_spans = len(trace.spans())
        finally:
            trace.disable()
            trace.clear()
        # the encode ran traced (its stage spans): what the spans cost
        trace_cost = n_spans * trace_span_cost()
        for vid in vids:
            if f"volume {vid}: ec.encode done" not in text:
                raise AssertionError(f"ec.encode:\n{text}")
        wait_until(lambda: all(master.topo.lookup_ec(v) and
                               not master.topo.lookup(v) for v in vids),
                   30, "the EC shards in the topology")
        rng = np.random.default_rng(seed + 8)
        device = "cuda" if backend == "cuda" else "cpu"
        moved = 0
        spread = {}
        for vid in vids:
            paths = shard_paths_of(servers, "smoke", vid)
            holders = {os.path.dirname(p) for p in paths}
            # the shell spreads by free slots (upstream
            # balancedEcDistribution): a source that held several of the
            # volumes has fewer free slots and can get none of a volume's
            # shards, so three servers at least, four most often
            spread[vid] = len(holders)
            if len(holders) < SERVICE_SERVERS - 1:
                raise AssertionError(f"volume {vid}: shards on "
                                     f"{len(holders)} servers")
            check_stripes(dats[vid], paths)
            link = os.path.join(snap, f"linked_{vid}")
            for sid, p in enumerate(paths):
                os.symlink(p, f"{link}.ec{sid:02d}")
            shard_size = os.path.getsize(paths[0])
            check_parity_spans(link, shard_size, rng, 16, 1 << 20, device)
            source = max(holders, key=lambda h: sum(
                os.path.dirname(p) == h for p in paths))
            moved += sum(os.path.getsize(p) for p in paths
                         if os.path.dirname(p) != source)
        gen = spans["shell.ec_encode.generate"]
        copy = spans["shell.ec_encode.copy"]
        out["encode"] = dict(
            seconds=secs, GBps=dat_bytes / secs / 1e9,
            launches=launches.per_phase["service_encode"],
            generate_seconds=gen, spread_seconds=spans[
                "shell.ec_encode.spread"], copy_seconds=copy,
            copied_bytes=moved,
            copy_GBps=moved / copy / 1e9 if copy else 0.0,
            trace_spans=n_spans, trace_cost_seconds=trace_cost,
            untraced_GBps=dat_bytes / (secs - trace_cost) / 1e9)
        log(f"  (b) ec.encode of {len(vids)} volumes through the shell: "
            f"{secs:.3f} s = {dat_bytes / secs / 1e9:.3f} GB/s of .dat "
            f"traced ({n_spans} spans, {trace_cost * 1e3:.3f} ms of it; "
            f"{out['encode']['untraced_GBps']:.3f} GB/s without); "
            f"fused generate RPCs {gen:.3f} s, spread "
            f"{out['encode']['spread_seconds']:.3f} s, of which shard "
            f"copies {copy:.3f} s for {moved} B "
            f"({out['encode']['copy_GBps']:.3f} GB/s over the RPC "
            f"transport); {launches.per_phase['service_encode']} "
            f"gf_linear launches; data shards == .dat stripes, sampled "
            f"parity == gf_linear_plain, servers holding each volume's "
            f"shards {spread} [{card}]")

        # (c) healthy reads. They fill the servers' needle caches, so (d)
        # reads a sample disjoint from this one
        picks = rng.choice(len(blobs),
                           size=min(2 * sample_size, len(blobs)),
                           replace=False).tolist()
        fids = sorted(blobs)
        half = len(picks) // 2
        sample = {fids[i]: blobs[fids[i]] for i in sorted(picks[:half])}
        sample_d = {fids[i]: blobs[fids[i]] for i in sorted(picks[half:])}
        t0 = time.perf_counter()
        every, _ = read_sample(servers, sample, buf)
        secs = time.perf_counter() - t0
        out["healthy_reads"] = dict(
            reads=len(every), seconds=secs,
            p50_ms=float(np.percentile(every, 50) * 1e3),
            p99_ms=float(np.percentile(every, 99) * 1e3),
            cache=cache_totals(servers))
        log(f"  (c) healthy reads over HTTP from {SERVICE_THREADS} threads "
            f"at random servers: {pcts(every)}, {secs:.3f} s; caches "
            f"{out['healthy_reads']['cache']} [{card}]")

        # (d) a server stopped: degraded reads through the decode fleet.
        # The victim holds at most four shards of every volume (so every
        # read can be served), the most shards in all among those
        victim = max((vs for vs in servers
                      if all(len(held(vs, v)) <= 4 for v in vids)),
                     key=lambda vs: sum(len(held(vs, v)) for v in vids))
        lost = {v: held(victim, v) for v in vids}
        victim.stop()
        servers.remove(victim)
        t0 = time.perf_counter()
        wait_until(lambda: victim.url not in
                   {n.url for n in master.topo.nodes()}, 30,
                   "the master dropping the stopped server")
        drop = time.perf_counter() - t0
        passes = {}
        for name, phase in (("first", "service_degraded_read"),
                            ("repeat", "service_degraded_repeat")):
            # the repeat pass sends every needle to the same server as the
            # first (read_sample's choice is a function of the sample)
            d0 = sum(vs.degraded.dispatches for vs in servers)
            c0 = cache_totals(servers)
            t0 = time.perf_counter()
            (every, degraded), _ = launches.run(
                phase, read_sample, servers, sample_d, buf, lost,
                none=name == "repeat")
            secs = time.perf_counter() - t0
            c1 = cache_totals(servers)
            passes[name] = dict(
                reads=len(every), degraded=len(degraded), seconds=secs,
                p50_ms=float(np.percentile(degraded, 50) * 1e3),
                p99_ms=float(np.percentile(degraded, 99) * 1e3),
                all_p50_ms=float(np.percentile(every, 50) * 1e3),
                all_p99_ms=float(np.percentile(every, 99) * 1e3),
                dispatches=sum(vs.degraded.dispatches for vs in servers) - d0,
                cache_hits=c1["hits"] - c0["hits"],
                cache_misses=c1["misses"] - c0["misses"],
                launches=launches.per_phase[phase])
        first, repeat = passes["first"], passes["repeat"]
        if not first["dispatches"] or not first["degraded"]:
            raise AssertionError(f"degraded reads: {first['dispatches']} "
                                 f"decode fleet dispatches, "
                                 f"{first['degraded']} degraded reads")
        if repeat["dispatches"] or repeat["cache_hits"] != repeat["reads"]:
            raise AssertionError(
                f"repeat pass: {repeat['dispatches']} decode fleet "
                f"dispatches, {repeat['cache_hits']} cache hits for "
                f"{repeat['reads']} reads")
        out["degraded_reads"] = dict(first, drop_seconds=drop,
                                     repeat=repeat)
        log(f"  (d) stopped {victim.url} (shards "
            f"{sorted(lost[vids[0]])} of volume {vids[0]}, <= 4 of each); "
            f"the master dropped it after {drop:.3f} s; {len(sample_d)} "
            f"needles apart from (c)'s")
        for name, ps in passes.items():
            log(f"      {name} pass: reads across its shards: "
                f"p50 {ps['p50_ms']:.3f} ms, p99 {ps['p99_ms']:.3f} ms over "
                f"{ps['degraded']} reads; all reads: p50 "
                f"{ps['all_p50_ms']:.3f} ms, p99 {ps['all_p99_ms']:.3f} ms "
                f"over {ps['reads']}; {ps['seconds']:.3f} s; "
                f"{ps['dispatches']} decode fleet dispatches, "
                f"{ps['launches']} gf_linear launches, cache hits "
                f"{ps['cache_hits']}, misses {ps['cache_misses']} [{card}]")

        # (e) rebuild
        inv0 = cache_totals(servers)["invalidations"]
        text, secs = launches.run("service_rebuild", sh.run_command,
                                  "ec.rebuild -collection=smoke")
        # a volume the victim held no shard of has nothing to rebuild
        # (the shell spreads by free slots, so that can happen)
        if not all(f"volume {v}: rebuilt shards" in text
                   for v in vids if lost[v]):
            raise AssertionError(f"ec.rebuild:\n{text}")
        invalidated = cache_totals(servers)["invalidations"] - inv0
        if not invalidated:
            raise AssertionError("ec.rebuild invalidated no cache entry")
        wait_until(lambda: all(
            sum(b.count for b in master.topo.lookup_ec(v).values()) == 14
            for v in vids), 30, "14 shards per volume on the live servers")
        every, _ = read_sample(servers, sample, buf)
        every_d, _ = read_sample(servers, sample_d, buf)
        out["rebuild"] = dict(seconds=secs,
                              launches=launches.per_phase["service_rebuild"],
                              invalidated=invalidated)
        log(f"  (e) ec.rebuild: {secs:.3f} s, "
            f"{launches.per_phase['service_rebuild']} gf_linear launches; "
            f"{invalidated} cache entries invalidated; 14 shards of every "
            f"volume on {len(servers)} servers; both samples read back "
            f"byte for byte ({pcts(every + every_d)}) [{card}]")

        # (f) decode
        text, secs = launches.run("service_decode", sh.run_command,
                                  "ec.decode -collection=smoke")
        if not all(f"volume {v}: decoded back" in text for v in vids):
            raise AssertionError(f"ec.decode:\n{text}")
        wait_until(lambda: all(master.topo.lookup(v) and
                               not master.topo.lookup_ec(v) for v in vids),
                   30, "the decoded volumes in the topology")
        for vid in vids:
            owner = next(vs for vs in servers if vs.store.has_volume(vid))
            got = sha256_file(owner.store.find_volume(vid).file_name()
                              + ".dat")
            if got != hashes[vid]:
                raise AssertionError(f"volume {vid}: decoded .dat differs")
        every, _ = read_sample(servers, sample, buf)
        out["decode"] = dict(seconds=secs, GBps=dat_bytes / secs / 1e9,
                             launches=launches.per_phase["service_decode"])
        log(f"  (f) ec.decode: {secs:.3f} s = "
            f"{dat_bytes / secs / 1e9:.3f} GB/s of .dat, "
            f"{launches.per_phase['service_decode']} gf_linear launches; "
            f"every .dat hashes as in (a); the sample reads back from the "
            f"normal volumes ({pcts(every)}) [{card}]")

        log("phase 9: the maintenance cycle (vacuum, move, backup, tiers, "
            "the cron's ec.encode, scrub, collections)")
        t9 = time.perf_counter()
        out["maintenance"] = phase_maintenance(
            master, servers, sh, blobs, buf, vids, workdir, seed, backend,
            launches, card)
        out["maintenance"]["seconds"] = time.perf_counter() - t9
        log(f"  phase 9 took {out['maintenance']['seconds']:.3f} s [{card}]")
    finally:
        for vs in servers:
            vs.stop()
        master.stop()
    if cli:
        out["cli"] = phase_cli(workdir, backend, card)
    if fix_dir:
        out["fix"] = phase_fix(fix_dir, card)
    out["launches"] = dict(launches.per_phase)
    return out


# --- phase 9 ------------------------------------------------------------------

# The master's maintenance cron, as upstream's master.toml ships it
# (lock, ec.encode, ec.rebuild, unlock; balance and fix.replication left
# out). fullPercent is low enough for the vacuumed volumes: 0.1% of the
# 1,024 MiB volume limit.
MAINTENANCE_SCRIPTS = ["lock",
                       "ec.encode -collection=smoke -fullPercent=0.1 "
                       "-quietFor=0",
                       "ec.rebuild -collection=smoke",
                       "unlock"]
MAINTENANCE_SAMPLE = 1024
TAIL_NEEDLES = 64
TIER_BACKEND = "memory.smoke"


def batch_delete(holder_url: str, fids) -> list:
    from seaweedfs_tpu_torch.pb import volume_server_pb2, volume_stub
    resp = volume_stub(holder_url).BatchDelete(
        volume_server_pb2.BatchDeleteRequest(file_ids=list(fids)))
    return [r.status for r in resp.results]


def file_status(url: str, vid: int):
    from seaweedfs_tpu_torch.pb import volume_server_pb2, volume_stub
    return volume_stub(url).ReadVolumeFileStatus(
        volume_server_pb2.ReadVolumeFileStatusRequest(volume_id=vid))


def http_status(url: str) -> int:
    from seaweedfs_tpu_torch.operation import operations
    return operations.http_request("GET", url).status


def holder_of(servers, vid: int):
    return next(vs for vs in servers if vs.store.has_volume(vid))


def read_back(servers, sample, buf) -> float:
    """Every needle of ``sample`` over HTTP, byte-compared; seconds."""
    t0 = time.perf_counter()
    read_sample(servers, sample, buf)
    return time.perf_counter() - t0


def phase_maintenance(master, servers, sh, blobs, buf, vids, workdir: str,
                      seed: int, backend: str, launches, card: str) -> dict:
    """Phase 9 on phase 8's cluster, whose ``smoke`` volumes are normal
    volumes again: (i) BatchDelete and volume.vacuum, (j) volume.move,
    an incremental backup and the memory tier, (k) the master's cron
    encodes every volume on the card, (l) scrub passes on every server
    and a targeted EC scrub, (m) tiered EC shards, (n) collections."""
    from seaweedfs_tpu_torch.operation import operations
    from seaweedfs_tpu_torch.operation.file_id import parse_fid
    from seaweedfs_tpu_torch.pb import volume_server_pb2, volume_stub
    from seaweedfs_tpu_torch.server.volume import VolumeServer
    from seaweedfs_tpu_torch.storage import backend as bk
    from seaweedfs_tpu_torch.storage import volume_backup
    from seaweedfs_tpu_torch.storage.volume import Volume
    out = {}
    rng = np.random.default_rng(seed + 9)
    bk.register_backend(bk.MemoryBackendStorage(TIER_BACKEND))
    by_vid = {}
    for fid, rec in blobs.items():
        by_vid.setdefault(parse_fid(fid).volume_id, {})[fid] = rec
    # a server on the kv needle map must hold one of the two vacuumed
    # volumes: (d) may have stopped the kv one, and the decode may have
    # put no volume there
    kv = next((vs for vs in servers
               if vs.store.locations[0].needle_map_kind == "kv"), None)
    if kv is None:
        d = os.path.join(workdir, "vol_kv")
        os.makedirs(d)
        kv = VolumeServer(master.url, [d], port=free_port_pair(),
                          max_volume_counts=[16], pulse_seconds=1.0,
                          ec_encoder=backend, cache_size_mb=SERVICE_CACHE_MB,
                          hedge_reads=True, needle_map_kind="kv")
        kv.start()
        servers.append(kv)
        wait_until(lambda: kv.url in {n.url for n in master.topo.nodes()},
                   30, "the kv volume server's heartbeat")
    on_kv = [v for v in vids if kv.store.has_volume(v)]
    if not on_kv:
        v = vids[0]
        src = holder_of(servers, v)
        sh.run_command(f"volume.move -volumeId={v} -source={src.url} "
                       f"-target={kv.url}")
        on_kv = [v]
    victims = [on_kv[0], next(v for v in vids
                              if not kv.store.has_volume(v))]

    # (i) delete a third of two volumes' needles (their largest third, so
    # the garbage is above 0.3), then volume.vacuum -garbageThreshold=0.3
    deleted = set()
    before = {}
    for v in vids:
        url = holder_of(servers, v).url
        before[v] = (url, file_status(url, v))
    t0 = time.perf_counter()
    for v in victims:
        fids = sorted(by_vid[v], key=lambda f: -by_vid[v][f][1])
        doomed = fids[:len(fids) // 3]
        statuses = batch_delete(before[v][0], doomed)
        if statuses != [202] * len(doomed):
            raise AssertionError(f"BatchDelete of volume {v}: {statuses}")
        deleted.update(doomed)
    delete_secs = time.perf_counter() - t0
    ratios = {v: holder_of(servers, v).store.find_volume(v).garbage_ratio()
              for v in vids}
    if any((ratios[v] > 0.3) != (v in victims) for v in vids):
        raise AssertionError(f"garbage ratios {ratios}, victims {victims}")
    # the heartbeat carries no garbage; the check RPC reads it live
    text, vac_secs = launches.run("maintenance_vacuum", sh.run_command,
                                  "volume.vacuum -garbageThreshold=0.3",
                                  none=True)
    reclaimed = 0
    for v in vids:
        url, st0 = before[v]
        st1 = file_status(url, v)
        compacted = v in victims
        if st1.compaction_revision != st0.compaction_revision + compacted \
                or (st1.dat_file_size < st0.dat_file_size) != compacted:
            raise AssertionError(
                f"volume {v}: revision {st0.compaction_revision} -> "
                f"{st1.compaction_revision}, .dat {st0.dat_file_size} -> "
                f"{st1.dat_file_size}; compacted should be {compacted}")
        reclaimed += st0.dat_file_size - st1.dat_file_size
    alive = {f: r for f, r in blobs.items() if f not in deleted}
    picks = rng.choice(len(alive), size=min(MAINTENANCE_SAMPLE, len(alive)),
                       replace=False)
    names = sorted(alive)
    sample = {names[i]: alive[names[i]] for i in sorted(picks.tolist())}
    read_back(servers, sample, buf)
    gone = [f for f in deleted
            if http_status(f"{holder_of(servers, parse_fid(f).volume_id).url}"
                           f"/{f}") != 404]
    if gone:
        raise AssertionError(f"{len(gone)} deleted needles still answer")
    out["vacuum"] = dict(deleted=len(deleted), delete_seconds=delete_secs,
                         seconds=vac_secs, reclaimed_bytes=reclaimed,
                         volumes=victims, ratios=ratios)
    log(f"  (i) BatchDelete of {len(deleted)} needles of volumes {victims} "
        f"(the last on -index kv) in {delete_secs:.3f} s; garbage "
        f"{[round(ratios[v], 4) for v in victims]}; volume.vacuum "
        f"-garbageThreshold=0.3: {vac_secs:.3f} s, {reclaimed} B "
        f"reclaimed; only those two compacted (revision + 1, .dat shrank); "
        f"{len(sample)} sampled survivors byte-identical over HTTP, every "
        f"deleted needle 404 [{card}]")

    # (j) move, incremental backup, memory tier
    mv = victims[1]
    src = holder_of(servers, mv)
    dst = min((vs for vs in servers if vs is not src),
              key=lambda vs: len(vs.store.locations[0].volumes))
    src.store.find_volume(mv).sync()
    want = sha256_file(src.store.find_volume(mv).dat_path)
    _, move_secs = launches.run(
        "maintenance_move", sh.run_command,
        f"volume.move -volumeId={mv} -source={src.url} -target={dst.url}",
        none=True)
    if sha256_file(dst.store.find_volume(mv).dat_path) != want:
        raise AssertionError(f"volume {mv}: .dat changed in the move")
    wait_until(lambda: [n.url for n in master.topo.lookup(mv, "smoke")]
               == [dst.url], 30, "the master seeing the move")
    # the backup: a full copy now, the new needles by VolumeIncrementalCopy
    bv_id = victims[0]
    owner = holder_of(servers, bv_id)
    v = owner.store.find_volume(bv_id)
    v.sync()
    bdir = os.path.join(workdir, "backup")
    os.makedirs(bdir)
    for ext in (".dat", ".idx"):
        shutil.copy(v.file_name() + ext,
                    os.path.join(bdir, f"smoke_{bv_id}{ext}"))
    new = {}
    for i in range(TAIL_NEEDLES):
        fid = f"{bv_id},{0x7E000000 + i:x}{int(rng.integers(1, 1 << 32)):08x}"
        off = int(rng.integers(0, len(buf) - 65536))
        size = int(rng.integers(1, 65536))
        operations.upload_data(f"{owner.url}/{fid}", buf[off:off + size])
        new[fid] = (off, size)
    v.sync()
    bvol = Volume(bdir, "smoke", bv_id, create_if_missing=False)
    try:
        t0 = time.perf_counter()
        shipped = volume_backup.incremental_backup(bvol,
                                                   volume_stub(owner.url))
        backup_secs = time.perf_counter() - t0
    finally:
        bvol.close()
    for ext in (".dat", ".idx"):
        if sha256_file(os.path.join(bdir, f"smoke_{bv_id}{ext}")) != \
                sha256_file(v.file_name() + ext):
            raise AssertionError(f"backup of volume {bv_id}: {ext} differs")
    alive.update(new)
    by_vid[bv_id].update(new)
    # the memory tier: out, read, back
    tv = next(x for x in vids if x not in victims)
    tholder = holder_of(servers, tv)
    tvol = tholder.store.find_volume(tv)
    tvol.sync()
    want = sha256_file(tvol.dat_path)
    t0 = time.perf_counter()
    text = sh.run_command(f"volume.tier.upload -volumeId={tv} "
                          f"-dest={TIER_BACKEND}")
    up_secs = time.perf_counter() - t0
    if not tvol.is_remote or os.path.exists(tvol.dat_path):
        raise AssertionError(f"volume.tier.upload:\n{text}")
    tsample = {f: r for f, r in sample.items()
               if parse_fid(f).volume_id == tv}
    tier_read = read_back(servers, tsample, buf)
    t0 = time.perf_counter()
    text = sh.run_command(f"volume.tier.download -volumeId={tv}")
    down_secs = time.perf_counter() - t0
    if tvol.is_remote or sha256_file(tvol.dat_path) != want:
        raise AssertionError(f"volume.tier.download:\n{text}")
    out["move"] = dict(seconds=move_secs,
                       bytes=os.path.getsize(dst.store.find_volume(mv)
                                             .dat_path))
    out["backup"] = dict(seconds=backup_secs, bytes=shipped,
                         needles=TAIL_NEEDLES)
    out["tier"] = dict(upload_seconds=up_secs, download_seconds=down_secs,
                       bytes=os.path.getsize(tvol.dat_path),
                       read_seconds=tier_read, reads=len(tsample))
    log(f"  (j) volume.move of volume {mv} ({out['move']['bytes']} B): "
        f"{move_secs:.3f} s, .dat hash unchanged; {TAIL_NEEDLES} new "
        f"needles into volume {bv_id}, VolumeIncrementalCopy of {shipped} "
        f"B in {backup_secs:.3f} s, the backup's .dat and .idx hash as the "
        f"source's; volume.tier.upload of volume {tv} "
        f"({out['tier']['bytes']} B) to {TIER_BACKEND} {up_secs:.3f} s, "
        f"{len(tsample)} reads through the tier {tier_read:.3f} s, "
        f"volume.tier.download {down_secs:.3f} s, .dat hash unchanged "
        f"[{card}]")

    # (k) the unattended encode: the cron's ec.encode and ec.rebuild
    snap = os.path.join(workdir, "snap9")
    os.makedirs(snap)
    dats = {}
    for x in vids:
        vol = holder_of(servers, x).store.find_volume(x)
        vol.sync()
        dats[x] = os.path.join(snap, f"{x}.dat")
        os.link(vol.dat_path, dats[x])
    dat_bytes = sum(os.path.getsize(p) for p in dats.values())
    passes, failures = master.maintenance_passes, master.maintenance_failures

    def cron():
        master.run_maintenance_now()
        wait_until(lambda: master.maintenance_passes > passes, 600,
                   "the maintenance pass")
        wait_until(lambda: all(master.topo.lookup_ec(x) and
                               not master.topo.lookup(x) for x in vids),
                   60, "every smoke volume as EC in the topology")

    _, cron_secs = launches.run("maintenance_cron_encode", cron)
    if master.maintenance_failures != failures:
        raise AssertionError(f"{master.maintenance_failures - failures} "
                             "maintenance scripts failed")
    device = "cuda" if backend == "cuda" else "cpu"
    hashes = {}
    for x in vids:
        paths = shard_paths_of(servers, "smoke", x)
        check_stripes(dats[x], paths)
        link = os.path.join(snap, f"linked_{x}")
        for sid, p in enumerate(paths):
            os.symlink(p, f"{link}.ec{sid:02d}")
        check_parity_spans(link, os.path.getsize(paths[0]), rng, 8,
                           1 << 20, device)
        if x in (vids[0], vids[-1]):   # (l)'s and (m)'s volumes
            hashes[x] = [sha256_file(p) for p in paths]
    read_back(servers, sample, buf)
    out["cron_encode"] = dict(
        seconds=cron_secs, dat_bytes=dat_bytes,
        GBps=dat_bytes / cron_secs / 1e9,
        launches=launches.per_phase["maintenance_cron_encode"])
    log(f"  (k) master.run_maintenance_now(): the cron's lock, ec.encode, "
        f"ec.rebuild, unlock took {cron_secs:.3f} s = "
        f"{dat_bytes / cron_secs / 1e9:.3f} GB/s of vacuumed .dat, "
        f"{launches.per_phase['maintenance_cron_encode']} gf_linear "
        f"launches, 0 scripts failed; data shards == .dat stripes, sampled "
        f"parity == gf_linear_plain; {len(sample)} sampled needles "
        f"byte-identical through the EC path [{card}]")

    # (l) scrub. A pass verifies the stripes of the EC volumes whose ten
    # data shards a server holds: gather every shard of one volume on one
    # server first (copies, removed after)
    sv = vids[0]
    gather = max(servers, key=lambda vs: vs.store.find_ec_volume(sv)
                 .shard_bits.count if vs.store.find_ec_volume(sv) else -1)
    have = set(gather.store.find_ec_volume(sv).shard_bits.shard_ids)
    copied = []
    for vs in servers:
        ecv = vs.store.find_ec_volume(sv)
        if vs is gather or ecv is None:
            continue
        sids = [i for i in ecv.shard_bits.shard_ids if i not in have]
        if not sids:
            continue
        stub = volume_stub(gather.url)
        stub.VolumeEcShardsCopy(volume_server_pb2.VolumeEcShardsCopyRequest(
            volume_id=sv, collection="smoke", shard_ids=sids,
            source_data_node=vs.url))
        stub.VolumeEcShardsMount(volume_server_pb2.VolumeEcShardsMountRequest(
            volume_id=sv, collection="smoke", shard_ids=sids))
        have.update(sids)
        copied += sids
    if len(have) != 14:
        raise AssertionError(f"volume {sv}: gathered shards {sorted(have)}")
    before_scrub = {vs.url: vs.scrub.status() for vs in servers}

    def idle(vs, passes_before):
        st = vs.scrub.status()
        return st["passes_completed"] > passes_before and \
            st["state"] != "running"

    def scrub_all():
        accepted = master.scrub_all_now()
        if sorted(accepted) != sorted(vs.url for vs in servers):
            raise AssertionError(f"scrub_all_now: {accepted}")
        wait_until(lambda: all(idle(vs, before_scrub[vs.url][
            "passes_completed"]) for vs in servers), 600,
            "every server's scrub pass")

    _, scrub_secs = launches.run("maintenance_scrub_all", scrub_all)
    for vs in servers:
        st = vs.scrub.status()
        if st["corruptions_found"] != \
                before_scrub[vs.url]["corruptions_found"]:
            raise AssertionError(f"{vs.url}: scrub found {st}")
    stripes = sum(vs.scrub.status()["stripes_verified"] -
                  before_scrub[vs.url]["stripes_verified"] for vs in servers)
    base = gather.store.find_ec_volume(sv).base_name
    psid = next((i for i in (10, 11, 12, 13) if i not in copied), 13)
    shard = f"{base}.ec{psid:02d}"
    if sha256_file(shard) != hashes[sv][psid]:
        raise AssertionError(f"{shard} differs from (k)'s")
    flip_byte(shard, os.path.getsize(shard) // 3)
    st0 = gather.scrub.status()

    def targeted():
        text = sh.run_command(f"volume.scrub -node={gather.url} "
                              f"-volumeId={sv}")
        if "scrub started" not in text:
            raise AssertionError(f"volume.scrub:\n{text}")
        wait_until(lambda: idle(gather, st0["passes_completed"]), 600,
                   "the targeted scrub pass")

    _, target_secs = launches.run("maintenance_scrub_targeted", targeted)
    st1 = gather.scrub.status()
    found = st1["corruptions_found"] - st0["corruptions_found"]
    repaired = st1["corruptions_repaired"] - st0["corruptions_repaired"]
    restored = sha256_file(shard) == hashes[sv][psid]
    if (found, repaired) != (1, 1) or not restored:
        raise AssertionError(f"targeted scrub: found {found}, repaired "
                             f"{repaired}, shard restored {restored}")
    stub = volume_stub(gather.url)
    stub.VolumeEcShardsUnmount(volume_server_pb2.VolumeEcShardsUnmountRequest(
        volume_id=sv, shard_ids=copied))
    stub.VolumeEcShardsDelete(volume_server_pb2.VolumeEcShardsDeleteRequest(
        volume_id=sv, collection="smoke", shard_ids=copied))
    out["scrub"] = dict(
        all_seconds=scrub_secs, stripes=stripes,
        all_launches=launches.per_phase["maintenance_scrub_all"],
        targeted_seconds=target_secs, found=found, repaired=repaired,
        targeted_launches=launches.per_phase["maintenance_scrub_targeted"])
    log(f"  (l) scrub_all_now(): {len(servers)} passes in "
        f"{scrub_secs:.3f} s, {stripes} stripes verified, nothing found, "
        f"{launches.per_phase['maintenance_scrub_all']} gf_linear launches "
        f"(every shard of volume {sv} gathered on {gather.url} first); one "
        f"byte of .ec{psid:02d} flipped, volume.scrub -volumeId={sv}: found "
        f"1, repaired 1 in {target_secs:.3f} s, "
        f"{launches.per_phase['maintenance_scrub_targeted']} gf_linear "
        f"launches, the shard hashes as in (k) [{card}]")

    # (m) the EC shards of one volume tiered on every holder, read, back
    ev = vids[-1]
    esample = {f: r for f, r in sample.items()
               if parse_fid(f).volume_id == ev}
    t0 = time.perf_counter()
    text = sh.run_command(f"volume.tier.upload -volumeId={ev} "
                          f"-dest={TIER_BACKEND}")
    eup = time.perf_counter() - t0
    remote = [s for vs in servers if vs.store.find_ec_volume(ev)
              for s in vs.store.find_ec_volume(ev).shards.values()]
    if len(remote) != 14 or not all(s.is_remote for s in remote):
        raise AssertionError(f"EC tier upload:\n{text}")
    _, eread = launches.run("maintenance_ec_tier_read", read_back, servers,
                            esample, buf, none=True)
    t0 = time.perf_counter()
    text = sh.run_command(f"volume.tier.download -volumeId={ev}")
    edown = time.perf_counter() - t0
    if [sha256_file(p) for p in shard_paths_of(servers, "smoke", ev)] != \
            hashes[ev]:
        raise AssertionError(f"EC tier download:\n{text}")
    out["ec_tier"] = dict(upload_seconds=eup, download_seconds=edown,
                          read_seconds=eread, reads=len(esample))
    log(f"  (m) volume.tier.upload of volume {ev}'s 14 shards on their "
        f"holders {eup:.3f} s; {len(esample)} reads through the tier "
        f"{eread:.3f} s, byte-identical; volume.tier.download "
        f"{edown:.3f} s, shard hashes as in (k) [{card}]")

    # (n) collections
    from seaweedfs_tpu_torch.pb import master_pb2, master_stub
    if "collection: smoke" not in sh.run_command("collection.list"):
        raise AssertionError("collection.list shows no smoke")
    stats = master_stub(master.url).Statistics(master_pb2.StatisticsRequest())
    text = sh.run_command("cluster.status")
    if f"used bytes: {stats.used_size}\n" not in text or \
            f"files: {stats.file_count}\n" not in text:
        raise AssertionError(f"cluster.status:\n{text}\nagainst {stats}")
    _, col_secs = launches.run("maintenance_collection_delete",
                               sh.run_command,
                               "collection.delete -collection=smoke",
                               none=True)
    left = [n for vs in servers
            for n in os.listdir(vs.store.locations[0].directory)
            if n.startswith("smoke_")]
    if left:
        raise AssertionError(f"collection.delete left {left[:10]}")
    wait_until(lambda: not any(master.topo.lookup(x, "smoke") or
                               master.topo.lookup_ec(x) for x in vids),
               30, "no smoke volume in the topology")
    out["collections"] = dict(delete_seconds=col_secs)
    log(f"  (n) collection.list shows smoke; cluster.status matches "
        f"Statistics; collection.delete: {col_secs:.3f} s, no smoke file "
        f"on any server and no smoke volume in the topology [{card}]")
    return out


def phase_cli(workdir: str, backend: str, card: str) -> dict:
    """(g) ``python -m seaweedfs_tpu_torch master`` and one ``volume`` as
    subprocesses, CLI_BLOBS uploads, ``shell ec.encode -volumeId=N`` as a
    third process, the blobs read back; both servers stopped with SIGTERM
    must exit 0 with no Traceback in their stderr."""
    import signal
    from seaweedfs_tpu_torch.operation import operations
    from seaweedfs_tpu_torch.operation.file_id import parse_fid
    from seaweedfs_tpu_torch.util import http_client
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=root)
    mport, vport = free_port_pair(), free_port_pair()
    murl, vurl = f"127.0.0.1:{mport}", f"127.0.0.1:{vport}"
    logs = {n: os.path.join(workdir, f"cli_{n}.log")
            for n in ("master", "volume")}
    cmds = {"master": ["master", "-port", str(mport), "-mdir",
                       os.path.join(workdir, "cli_m"), "-pulseSeconds", "1"],
            "volume": ["volume", "-port", str(vport), "-dir",
                       os.path.join(workdir, "cli_v"), "-mserver", murl,
                       "-max", "8", "-pulseSeconds", "1", "-ec.encoder",
                       backend]}
    t0 = time.perf_counter()
    procs = {}
    for name, args in cmds.items():
        with open(logs[name], "wb") as err:
            procs[name] = subprocess.Popen(
                [sys.executable, "-m", "seaweedfs_tpu_torch", *args],
                cwd=root, env=env, stdout=subprocess.DEVNULL, stderr=err)
    try:
        def registered():
            try:
                topo = json.loads(operations.http_request(
                    "GET", f"{murl}/dir/status").body)["Topology"]
            except (OSError, ValueError, KeyError):
                return False
            return any(n["url"] == vurl for dc in topo["data_centers"]
                       for r in dc["racks"] for n in r["nodes"])
        wait_until(registered, 120, "the CLI volume server")
        rng = np.random.default_rng(64)
        blobs = {}
        for i in range(CLI_BLOBS):
            data = rng.bytes(int(rng.integers(1, 64 << 10)))
            blobs[operations.upload(murl, data, collection="cli")] = data
        vid = parse_fid(next(iter(blobs))).volume_id
        shell = subprocess.run(
            [sys.executable, "-m", "seaweedfs_tpu_torch", "shell",
             "-master", murl, f"ec.encode -volumeId={vid}"],
            cwd=root, env=env, capture_output=True, text=True, timeout=300)
        if shell.returncode != 0 or \
                f"volume {vid}: ec.encode done" not in shell.stdout:
            raise AssertionError(f"CLI shell exited {shell.returncode}:\n"
                                 f"{shell.stdout}\n{shell.stderr}")
        for fid, data in blobs.items():
            if http_get(f"{vurl}/{fid}") != data:
                raise AssertionError(f"CLI leg: {fid} reads back wrong")
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.send_signal(signal.SIGTERM)
        codes = {n: p.wait(timeout=60) for n, p in procs.items()}
        http_client.close_all()
    secs = time.perf_counter() - t0
    for name, code in codes.items():
        text = open(logs[name], errors="replace").read()
        if code != 0 or "Traceback" in text:
            raise AssertionError(f"CLI {name} exited {code}:\n{text[-4000:]}")
    in_vol = sum(parse_fid(f).volume_id == vid for f in blobs)
    log(f"  (g) CLI: master, volume (-ec.encoder {backend}) and shell as "
        f"processes; {CLI_BLOBS} blobs, ec.encode -volumeId={vid} "
        f"({in_vol} of them), all read back; both servers exited 0 "
        f"on SIGTERM, no Traceback; {secs:.1f} s [{card}]")
    return dict(seconds=secs, blobs=CLI_BLOBS, encoded_volume=vid)


# --- phase 10 -----------------------------------------------------------------

# The replicated, highly available cluster: three masters (a raft set),
# four volume servers over two racks of one data center, volumes of 256
# MiB, placement 010 (one copy in each rack), the breaker on. 128 MiB of
# needles of 1 B-256 KiB before a leader failover and 128 MiB after it
# (256 MiB each until phase 16 needed the time).
REPL_MASTERS = 3
REPL_RACKS = ("r1", "r1", "r2", "r2")
REPL_BYTES = 128 << 20
REPL_VOLUME_MB = 256
REPL_DELETES = 64
REPL_GROW_AFTER_FAILOVER = 2


def read_pairs(pairs, buf) -> list:
    """GET each (fid, url, (offset, size)) from that url, from
    SERVICE_THREADS threads; any wrong byte fails the run. Returns the
    latencies."""
    from seaweedfs_tpu_torch.operation import operations

    def worker(part):
        lat = []
        for fid, url, (off, size) in part:
            t0 = time.perf_counter()
            r = operations.http_request("GET", f"{url}/{fid}")
            lat.append(time.perf_counter() - t0)
            if r.status != 200 or r.body != buf[off:off + size]:
                raise AssertionError(f"{fid} from {url}: http "
                                     f"{r.status}, wrong bytes")
        return lat

    with concurrent.futures.ThreadPoolExecutor(SERVICE_THREADS) as pool:
        parts = list(pool.map(worker, [pairs[i::SERVICE_THREADS]
                                       for i in range(SERVICE_THREADS)]))
    return [t for p in parts for t in p]


def replica_urls(master, vid: int, copies: int = 2) -> list:
    return wait_until(
        lambda: (lambda locs: sorted(u for u, _ in locs)
                 if len(locs) == copies else None)(
            master.lookup_locations(vid, "repl")),
        30, f"{copies} replicas of volume {vid}")


def live_needles(v) -> dict:
    """{needle id: sha256 of its data} of one replica's live needles."""
    from seaweedfs_tpu_torch.storage.needle import Needle
    out = {}
    for key, _ in list(v.nm.items()):
        got = v.read_needle(Needle(id=key, cookie=0))
        out[key] = hashlib.sha256(got.data).hexdigest()
    return out


def phase_replication(workdir: str, seed: int, backend: str,
                      total_bytes: int = REPL_BYTES,
                      sample_size: int = SERVICE_SAMPLE,
                      card: str = "") -> dict:
    """Phase 10: (a) election and registration, (b) uploads of 010 needles
    through a follower with a leader failover between two halves, (c)
    every replica holds every write, (d) deletes and a lost replica, (e)
    volume.fix.replication, (f) scrub repair from a replica, (g) ec.encode
    of every replicated volume on the card."""
    from seaweedfs_tpu_torch.operation import operations
    from seaweedfs_tpu_torch.operation.file_id import parse_fid
    from seaweedfs_tpu_torch.resilience import breaker
    from seaweedfs_tpu_torch.server.master import MasterServer
    from seaweedfs_tpu_torch.util import http_client
    from seaweedfs_tpu_torch.server.volume import VolumeServer
    from seaweedfs_tpu_torch.shell import Shell
    from seaweedfs_tpu_torch.storage.needle import Needle

    card = card or backend
    launches = Launches(backend)
    out = {}
    breaker.configure(enable=True)
    ports = [free_port_pair() for _ in range(REPL_MASTERS)]
    murls = [f"127.0.0.1:{p}" for p in ports]
    masters = [MasterServer(port=p, meta_dir=os.path.join(workdir, f"m{i}"),
                            peers=murls, volume_size_limit_mb=REPL_VOLUME_MB,
                            pulse_seconds=1.0)
               for i, p in enumerate(ports)]
    servers = []
    stopped = []
    t_phase = time.perf_counter()
    try:
        for m in masters:
            m.start()
        for i, rack in enumerate(REPL_RACKS):
            d = os.path.join(workdir, f"vol{i}")
            os.makedirs(d)
            vs = VolumeServer(
                ",".join(murls), [d], port=free_port_pair(),
                data_center="dc1", rack=rack, max_volume_counts=[16],
                pulse_seconds=1.0, ec_encoder=backend,
                cache_size_mb=SERVICE_CACHE_MB, hedge_reads=True)
            vs.start()
            servers.append(vs)

        def leader_of(ms):
            leaders = [m for m in ms if m.is_leader]
            return leaders[0] if len(leaders) == 1 else None

        def registered(m):
            nodes = m.topo.nodes()
            return len(nodes) == len(servers) and sorted(
                n.rack.id for n in nodes) == sorted(REPL_RACKS)

        # (a) election and registration
        def elect():
            leader = wait_until(lambda: leader_of(masters), 30,
                                "one raft leader")
            wait_until(lambda: registered(leader), 30,
                       "four servers with their racks at the leader")
            return leader

        leader, secs = launches.run("repl_election", elect, none=True)
        log(f"  (a) {REPL_MASTERS} masters elected {leader.url} (term "
            f"{leader.raft.current_term}); {len(servers)} servers "
            f"registered with racks {sorted(REPL_RACKS)} in {secs:.3f} s "
            f"[{card}]")
        out["election_seconds"] = secs

        # (b) uploads through a follower, a failover between the halves
        follower = next(m for m in masters if m is not leader)
        (first, buf, up1), _ = launches.run(
            "repl_upload_1", upload_needles, follower.url, total_bytes,
            seed + 10, collection="repl", replication="010", none=True)
        vids_before = sorted({parse_fid(f).volume_id for f in first})
        t0 = time.perf_counter()
        leader.stop()
        masters.remove(leader)
        survivors = list(masters)

        def failover():
            new = wait_until(lambda: leader_of(survivors), 60,
                             "a new leader")
            wait_until(lambda: registered(new), 60,
                       "the servers re-registered at the new leader")
            return new

        new_leader, _ = launches.run("repl_failover", failover, none=True)
        failover_s = time.perf_counter() - t0
        follower = next(m for m in survivors if m is not new_leader)
        grown = json.loads(operations.http_request(
            "GET", f"{follower.url}/vol/grow?collection=repl&replication="
            f"010&count={REPL_GROW_AFTER_FAILOVER}").body)
        if grown.get("count") != REPL_GROW_AFTER_FAILOVER or \
                min(grown["volumeIds"]) <= max(vids_before):
            raise AssertionError(f"grow after the failover: {grown}, "
                                 f"volumes before {vids_before}")
        (second, _, up2), _ = launches.run(
            "repl_upload_2", upload_needles, follower.url, total_bytes,
            seed + 11, collection="repl", replication="010", buf=buf,
            none=True)
        if set(first) & set(second):
            raise AssertionError("a file id was issued twice")
        blobs = dict(first, **second)
        vids = sorted({parse_fid(f).volume_id for f in blobs})
        after = sorted(set(vids) - set(vids_before))
        if after and min(after) <= max(vids_before):
            raise AssertionError(f"volumes {after} written after the "
                                 f"failover, {vids_before} before it")
        rack_of = {vs.url: vs.rack for vs in servers}
        holders = {vid: replica_urls(new_leader, vid) for vid in vids}
        for vid, urls in holders.items():
            if rack_of[urls[0]] == rack_of[urls[1]]:
                raise AssertionError(f"volume {vid}: both replicas in "
                                     f"{rack_of[urls[0]]}")
        nb = [sum(s for _, s in part.values()) for part in (first, second)]
        out["upload"] = dict(
            needles=len(blobs), bytes=sum(nb), volumes=len(vids),
            MBps_before=nb[0] / up1 / 1e6, MBps_after=nb[1] / up2 / 1e6,
            failover_seconds=failover_s, grown_after=grown["volumeIds"])
        log(f"  (b) 010 uploads through follower masters: {len(first)} "
            f"needles, {nb[0]} B in {up1:.3f} s = {nb[0] / up1 / 1e6:.1f} "
            f"MB/s; leader {leader.url} stopped, {new_leader.url} leads "
            f"(term {new_leader.raft.current_term}) with all four servers "
            f"back after {failover_s:.3f} s; grown after it "
            f"{grown['volumeIds']} > {max(vids_before)}; {len(second)} "
            f"needles, {nb[1]} B in {up2:.3f} s = "
            f"{nb[1] / up2 / 1e6:.1f} MB/s; {len(blobs)} distinct file "
            f"ids in {len(vids)} volumes, each on two racks [{card}]")

        # (c) every replica holds every write
        rng = np.random.default_rng(seed + 12)
        fids = sorted(blobs)
        picks = rng.choice(len(fids), size=min(sample_size, len(fids)),
                           replace=False)
        sample = {fids[i]: blobs[fids[i]] for i in sorted(picks.tolist())}
        pairs = [(fid, url, where) for fid, where in sample.items()
                 for url in holders[parse_fid(fid).volume_id]]

        def every_replica():
            lat = read_pairs(pairs, buf)
            for vs in servers:
                for vid in vids:
                    v = vs.store.find_volume(vid)
                    if v is not None:
                        v.sync()
            for vid, urls in holders.items():
                a, b = (live_needles(next(
                    vs for vs in servers if vs.url == u).store.find_volume(
                        vid)) for u in urls)
                if a != b:
                    raise AssertionError(
                        f"volume {vid}: replicas differ ({len(a)} and "
                        f"{len(b)} live needles)")
            return lat

        lat, secs = launches.run("repl_reads", every_replica, none=True)
        out["replica_reads"] = dict(
            reads=len(lat), seconds=secs,
            p50_ms=float(np.percentile(lat, 50) * 1e3),
            p99_ms=float(np.percentile(lat, 99) * 1e3))
        log(f"  (c) {len(sample)} sampled needles read from each of their "
            f"two replicas: {pcts(lat)}; every volume's replicas hold the "
            f"same live needles with the same data; {secs:.3f} s [{card}]")

        # (d) deletes (sampled needles, which later steps read no more),
        # then a lost replica
        doomed = sorted(rng.choice(sorted(sample), REPL_DELETES,
                                   replace=False).tolist())

        def deletes():
            for i, fid in enumerate(doomed):
                urls = holders[parse_fid(fid).volume_id]
                r = operations.http_request("DELETE",
                                            f"{urls[i % 2]}/{fid}")
                if r.status != 202:
                    raise AssertionError(f"DELETE {fid}: http {r.status}")
                for url in urls:
                    if operations.http_request(
                            "GET", f"{url}/{fid}").status != 404:
                        raise AssertionError(f"{fid} survives on {url}")

        _, del_secs = launches.run("repl_deletes", deletes, none=True)
        for fid in doomed:
            del sample[fid]
        victim = next(vs for vs in servers if vs.rack == "r1" and any(
            vs.url in urls for urls in holders.values()))
        lost_vids = [vid for vid, urls in holders.items()
                     if victim.url in urls]
        vid = lost_vids[0]
        partner = next(u for u in holders[vid] if u != victim.url)
        cookie = 0x5eed5eed

        def lose_a_replica():
            warm = f"{vid},{(1 << 40):x}{cookie:08x}"
            r = operations.http_request("POST", f"{partner}/{warm}",
                                        body=b"acknowledged by both")
            if r.status != 201:
                raise AssertionError(f"write before the loss: {r.status}")
            victim.stop()
            servers.remove(victim)
            stopped.append(victim)
            statuses = []
            for key in ((1 << 40) + 1, (1 << 40) + 2):
                statuses.append(operations.http_request(
                    "POST", f"{partner}/{vid},{key:x}{cookie:08x}",
                    body=b"one copy only").status)
                wait_until(lambda: victim.url not in {
                    n.url for n in new_leader.topo.nodes()}, 30,
                    "the master dropping the stopped server")
            if any(st < 300 for st in statuses):
                raise AssertionError(f"a write with a replica down was "
                                     f"acknowledged: {statuses}")
            lost_sample = [(fid, partner if vid_of == vid else next(
                u for u in holders[vid_of] if u != victim.url), where)
                for fid, where in sample.items()
                for vid_of in [parse_fid(fid).volume_id]
                if vid_of in lost_vids]
            return statuses, read_pairs(lost_sample, buf)

        (statuses, lat), secs = launches.run("repl_lost_replica",
                                             lose_a_replica, none=True)
        state = {breaker.CLOSED: "closed", breaker.HALF_OPEN: "half-open",
                 breaker.OPEN: "open"}[breaker.for_peer(victim.url).state]
        out["lost_replica"] = dict(
            deletes=len(doomed), delete_seconds=del_secs,
            refused_statuses=statuses, reads=len(lat),
            p50_ms=float(np.percentile(lat, 50) * 1e3),
            p99_ms=float(np.percentile(lat, 99) * 1e3), breaker=state)
        log(f"  (d) {len(doomed)} needles deleted through one replica, gone "
            f"from both, in {del_secs:.3f} s; {victim.url} ({victim.rack}, "
            f"replicas of volumes {lost_vids}) stopped; writes to volume "
            f"{vid} through {partner} answered {statuses} (not "
            f"acknowledged) before and after the master dropped it; the "
            f"sample of its volumes from the other replicas: {pcts(lat)}; "
            f"breaker for {victim.url}: {state} [{card}]")

        # (e) volume.fix.replication
        sh = Shell(new_leader.url)
        text, fix_secs = launches.run("repl_fix", sh.run_command,
                                      "volume.fix.replication", none=True)
        copied = 0
        for lv in lost_vids:
            if f"volume {lv}: replicated" not in text:
                raise AssertionError(f"volume.fix.replication:\n{text}")
        for vid_, urls in list(holders.items()):
            urls = replica_urls(new_leader, vid_)
            if rack_of[urls[0]] == rack_of[urls[1]] or victim.url in urls:
                raise AssertionError(f"volume {vid_} after the fix: {urls}")
            if vid_ in lost_vids:
                new = next(u for u in urls if u not in holders[vid_])
                v = next(vs for vs in servers if vs.url == new) \
                    .store.find_volume(vid_)
                copied += os.path.getsize(v.file_name() + ".dat") + \
                    os.path.getsize(v.file_name() + ".idx")
            holders[vid_] = urls
        new_copy_reads = read_pairs(
            [(fid, next(u for u in holders[parse_fid(fid).volume_id]
                        if rack_of[u] == "r1"), where)
             for fid, where in sample.items()
             if parse_fid(fid).volume_id in lost_vids], buf)
        out["fix"] = dict(seconds=fix_secs, copied_bytes=copied,
                          volumes=len(lost_vids),
                          reads=len(new_copy_reads))
        log(f"  (e) volume.fix.replication: {len(lost_vids)} volumes "
            f"copied back to two racks, {copied} B in {fix_secs:.3f} s; "
            f"the sample reads back from the new copies "
            f"({pcts(new_copy_reads)}) [{card}]")

        # (f) scrub repair from a replica
        fid = next(iter(sample))
        f = parse_fid(fid)
        target = next(vs for vs in servers
                      if vs.url in holders[f.volume_id])
        other = next(u for u in holders[f.volume_id] if u != target.url)
        v = target.store.find_volume(f.volume_id)
        v.sync()
        off, size = sample[fid]
        nv = v.nm.get(f.key)
        flip_byte(v.file_name() + ".dat", nv.offset + 20 + size // 2)
        st0 = target.scrub.status()

        def scrub():
            text = sh.run_command(f"volume.scrub -node={target.url} "
                                  f"-volumeId={f.volume_id}")
            if "scrub started" not in text:
                raise AssertionError(f"volume.scrub:\n{text}")
            wait_until(lambda: target.scrub.status()["passes_completed"]
                       > st0["passes_completed"] and
                       target.scrub.status()["state"] != "running", 300,
                       "the targeted scrub pass")

        _, scrub_secs = launches.run("repl_scrub", scrub, none=True)
        st1 = target.scrub.status()
        found = st1["corruptions_found"] - st0["corruptions_found"]
        repaired = st1["corruptions_repaired"] - st0["corruptions_repaired"]
        got = operations.http_request("GET", f"{target.url}/{fid}").body
        want = operations.http_request("GET", f"{other}/{fid}").body
        if (found, repaired) != (1, 1) or got != want or \
                got != buf[off:off + size]:
            raise AssertionError(f"scrub from a replica: found {found}, "
                                 f"repaired {repaired}, bytes equal "
                                 f"{got == want}")
        out["scrub"] = dict(seconds=scrub_secs, found=found,
                            repaired=repaired)
        log(f"  (f) a byte flipped in needle {fid}'s data on {target.url}: "
            f"volume.scrub found {found}, repaired {repaired} from "
            f"{other} in {scrub_secs:.3f} s; its bytes equal the other "
            f"replica's [{card}]")

        # (g) ec.encode of every replicated volume on the card
        snap = os.path.join(workdir, "snap")
        os.makedirs(snap)
        dats = {}
        for vid_ in vids:
            # the replica ec.encode generates from: the master's first
            # location (replicas differ in their needles' append times)
            source = new_leader.lookup_locations(vid_, "repl")[0][0]
            owner = next(vs for vs in servers if vs.url == source)
            v = owner.store.find_volume(vid_)
            v.sync()
            dats[vid_] = os.path.join(snap, f"{vid_}.dat")
            os.link(v.file_name() + ".dat", dats[vid_])
        dat_bytes = sum(os.path.getsize(p) for p in dats.values())
        text, enc_secs = launches.run(
            "repl_encode", sh.run_command,
            f"ec.encode -collection=repl -volumeId={','.join(map(str, vids))}")
        for vid_ in vids:
            if text.count(f"volume {vid_}: generated 14 shards") != 1 or \
                    f"volume {vid_}: ec.encode done" not in text:
                raise AssertionError(f"ec.encode:\n{text}")
        wait_until(lambda: all(new_leader.topo.lookup_ec(v_) and not
                               new_leader.topo.lookup(v_, "repl")
                               for v_ in vids), 30,
                   "the EC volumes in the topology")
        device = "cuda" if backend == "cuda" else "cpu"
        for vid_ in vids:
            if any(vs.store.has_volume(vid_) or os.path.exists(os.path.join(
                    vs.store.locations[0].directory, f"repl_{vid_}.dat"))
                   for vs in servers):
                raise AssertionError(f"volume {vid_}: a .dat is left")
            paths = shard_paths_of(servers, "repl", vid_)
            check_stripes(dats[vid_], paths)
            link = os.path.join(snap, f"linked_{vid_}")
            for sid, p in enumerate(paths):
                os.symlink(p, f"{link}.ec{sid:02d}")
            check_parity_spans(link, os.path.getsize(paths[0]), rng, 8,
                               1 << 20, device)
        ec_reads, _ = read_sample(servers, sample, buf)
        out["encode"] = dict(
            seconds=enc_secs, GBps=dat_bytes / enc_secs / 1e9,
            dat_bytes=dat_bytes, volumes=len(vids),
            launches=launches.per_phase["repl_encode"],
            reads=len(ec_reads),
            p50_ms=float(np.percentile(ec_reads, 50) * 1e3))
        log(f"  (g) ec.encode -collection=repl of {len(vids)} replicated "
            f"volumes ({dat_bytes} B of .dat): {enc_secs:.3f} s = "
            f"{dat_bytes / enc_secs / 1e9:.3f} GB/s, one generate per "
            f"volume, {launches.per_phase['repl_encode']} gf_linear "
            f"launches; data shards == the .dat stripes, sampled parity == "
            f"gf_linear_plain, no .dat left on any live server; the sample "
            f"reads back through the EC path ({pcts(ec_reads)}) [{card}]")
    finally:
        for vs in servers:
            vs.stop()
        for m in masters:
            m.stop()
        breaker.reset()
        http_client.close_all()
    out["seconds"] = time.perf_counter() - t_phase
    out["launches"] = dict(launches.per_phase)
    return out


# --- phase 11 -----------------------------------------------------------------

CHUNKED_VOLUME_MB = 64
CHUNKED_MAX_MB = 4
CHUNKED_LEASES = 32
CHUNKED_SUBMITTERS = 4
CHUNKED_NEEDLES = 1024
CHUNKED_NEEDLE_MAX = 64 << 10
CHUNKED_RANGES = 256
CHUNKED_RANGE_MAX = 9 << 20
CHUNKED_CLI_BYTES = 10 << 20
CHUNKED_BENCH_N = 4096


def chunked_file_sizes(rng) -> list:
    """Phase 11's twelve files: 1 KiB, both sides of one and of two 4 MiB
    chunks, and seven drawn uniform from 1-40 MiB."""
    mib = 1 << 20
    return [1024, 4 * mib - 1, 4 * mib, 4 * mib + 1, 8 * mib + 7] + \
        rng.integers(mib, 40 * mib + 1, 7).tolist()


def get_following(url: str, headers=None):
    """One GET of "host:port/path" that follows one redirect, as a reader
    sent to a server without the volume is."""
    from seaweedfs_tpu_torch.operation import operations
    r = operations.http_request("GET", url, headers=headers)
    if r.status in (301, 302) and "location" in r.headers:
        r = operations.http_request(
            "GET", r.headers["location"].split("//", 1)[1], headers=headers)
    return r


def chunked_ranges(rng, files, count: int) -> list:
    """(fid, start, length) GETs starting within 1 KiB of a chunk
    boundary of a chunked file, lengths 1 B-9 MiB."""
    chunked = [(fid, size) for fid, size in files if
               size > CHUNKED_MAX_MB << 20]
    out = []
    for _ in range(count):
        fid, size = chunked[int(rng.integers(len(chunked)))]
        bounds = (size - 1) // (CHUNKED_MAX_MB << 20)
        edge = int(rng.integers(1, bounds + 1)) * (CHUNKED_MAX_MB << 20)
        start = min(size - 1, max(0, edge + int(rng.integers(-1024, 1025))))
        out.append((fid, start, int(rng.integers(1, CHUNKED_RANGE_MAX + 1))))
    return out


def read_chunked(servers, jobs, datas, threads: int = SERVICE_THREADS
                 ) -> list:
    """GET every (fid, start, length) job (length None: the whole file)
    from a server chosen by the job's index, from ``threads`` threads;
    the bytes must equal the file's slice, a whole chunked file must say
    X-File-Store: chunked. Returns the latencies."""
    def worker(part):
        lat = []
        for i, (fid, start, length) in part:
            vs = servers[(i * 2654435761) % len(servers)]
            data = datas[fid]
            headers = None if length is None else \
                {"Range": f"bytes={start}-{start + length - 1}"}
            t0 = time.perf_counter()
            r = get_following(f"{vs.url}/{fid}", headers)
            lat.append(time.perf_counter() - t0)
            want = data if length is None else data[start:start + length]
            if r.status != (200 if length is None else 206) or \
                    hashlib.sha256(r.body).digest() != \
                    hashlib.sha256(want).digest():
                raise AssertionError(
                    f"{fid} [{start}, +{length}] from {vs.url}: http "
                    f"{r.status}, {len(r.body)} B, want {len(want)} B")
            chunked = len(data) > CHUNKED_MAX_MB << 20
            if length is None and chunked != \
                    (r.headers.get("x-file-store") == "chunked"):
                raise AssertionError(f"{fid}: X-File-Store "
                                     f"{r.headers.get('x-file-store')!r}")
        return lat

    indexed = list(enumerate(jobs))
    with concurrent.futures.ThreadPoolExecutor(threads) as pool:
        parts = list(pool.map(worker, [indexed[i::threads]
                                       for i in range(threads)]))
    return [t for p in parts for t in p]


def run_cli(args, root: str, timeout: float = 300):
    """One ``python -m seaweedfs_tpu_torch`` client command; it must exit
    0 with no traceback."""
    r = subprocess.run([sys.executable, "-m", "seaweedfs_tpu_torch", *args],
                       cwd=root, env=dict(os.environ, PYTHONPATH=root),
                       capture_output=True, text=True, timeout=timeout)
    if r.returncode != 0 or "Traceback" in r.stderr:
        raise AssertionError(f"CLI {args[0]} exited {r.returncode}:\n"
                             f"{r.stdout[-2000:]}\n{r.stderr[-4000:]}")
    return r.stdout


def phase_chunked(workdir: str, seed: int, backend: str, card: str = "",
                  sizes=None, needles: int = CHUNKED_NEEDLES,
                  ranges: int = CHUNKED_RANGES,
                  cli_bytes: int = CHUNKED_CLI_BYTES,
                  bench_n: int = CHUNKED_BENCH_N) -> dict:
    """Phase 11: a client that knows only the master set. (a)
    MasterClient names the leader; (b) chunked files and small needles
    written through leased file ids, every assign through a follower; (c)
    whole, ranged, 416, cm=false and HEAD reads, the needles through
    MasterClient.lookup_file_id; (d) ec.encode of every volume on the
    card; (e) the leader stopped, the client at the new one; (f) the
    files read through a stopped server, K1 rebuilding the lost
    intervals; (g) half the manifests deleted, their chunks with them;
    (h) upload, download, delete and benchmark as subprocesses."""
    from seaweedfs_tpu_torch import rpc
    from seaweedfs_tpu_torch.operation import operations
    from seaweedfs_tpu_torch.operation.assign_lease import LeaseCache
    from seaweedfs_tpu_torch.operation.chunked_file import \
        load_chunk_manifest
    from seaweedfs_tpu_torch.operation.file_id import parse_fid
    from seaweedfs_tpu_torch.pb import volume_server_pb2, volume_stub
    from seaweedfs_tpu_torch.server.master import MasterServer
    from seaweedfs_tpu_torch.server.volume import VolumeServer
    from seaweedfs_tpu_torch.shell import Shell
    from seaweedfs_tpu_torch.stats.metrics import MetaLookupBatchHistogram
    from seaweedfs_tpu_torch.util import http_client
    from seaweedfs_tpu_torch.wdclient import MasterClient, lookup_cache

    card = card or backend
    launches = Launches(backend)
    out = {}
    root = os.path.dirname(os.path.abspath(__file__))
    chunk = CHUNKED_MAX_MB << 20
    rng = np.random.default_rng(seed + 20)
    sizes = chunked_file_sizes(rng) if sizes is None else list(sizes)
    datas = [rng.bytes(int(s)) for s in sizes]
    pool_bytes = rng.bytes(4 << 20)
    if backend == "cuda":
        import torch
        # making the CUDA context holds this interpreter long enough for
        # the raft masters in it to elect anew: make it before they start
        # (in the full run an earlier phase has)
        torch.zeros(1, device="cuda")
    lookup_cache.configure(enable=True)
    ports = [free_port_pair() for _ in range(REPL_MASTERS)]
    murls = [f"127.0.0.1:{p}" for p in ports]
    masters = [MasterServer(port=p, meta_dir=os.path.join(workdir, f"m{i}"),
                            peers=murls,
                            volume_size_limit_mb=CHUNKED_VOLUME_MB,
                            pulse_seconds=1.0)
               for i, p in enumerate(ports)]
    servers = []
    mc = None
    t_phase = time.perf_counter()
    try:
        for m in masters:
            m.start()
        for i in range(SERVICE_SERVERS):
            d = os.path.join(workdir, f"vol{i}")
            os.makedirs(d)
            vs = VolumeServer(
                ",".join(murls), [d], port=free_port_pair(),
                max_volume_counts=[40], pulse_seconds=1.0,
                ec_encoder=backend, cache_size_mb=SERVICE_CACHE_MB,
                hedge_reads=True)
            vs.start()
            servers.append(vs)

        def leader_of(ms):
            leaders = [m for m in ms if m.is_leader]
            return leaders[0] if len(leaders) == 1 else None

        def registered(m, n):
            return len(m.topo.nodes()) == n

        # (a) the client connects
        def connect():
            client = MasterClient(murls, "chip-smoke").start()
            client.wait_until_connected(timeout=30)
            leader = wait_until(lambda: leader_of(masters), 30,
                                "one raft leader")
            wait_until(lambda: client.current_master == leader.url, 30,
                       "the client at the leader")
            return client, leader

        (mc, leader), secs = launches.run("chunked_connect", connect,
                                          none=True)
        wait_until(lambda: registered(leader, len(servers)), 30,
                   "four servers at the leader")
        out["connect_seconds"] = secs
        log(f"  (a) MasterClient over {len(murls)} masters named the "
            f"leader {leader.url} in {secs:.3f} s [{card}]")

        # (b) chunked ingest through leased file ids, via a follower
        follower = next(m for m in masters if m is not leader)
        leases = LeaseCache(count=CHUNKED_LEASES)

        def ingest():
            def submit(i):
                return operations.submit(
                    follower.url, datas[i], filename=f"file{i}.bin",
                    max_mb=CHUNKED_MAX_MB, collection="chunked",
                    leases=leases)

            t0 = time.perf_counter()
            with concurrent.futures.ThreadPoolExecutor(
                    CHUNKED_SUBMITTERS) as pool:
                fids = list(pool.map(submit, range(len(datas))))
            file_secs = time.perf_counter() - t0
            jobs = [(int(o), int(s)) for o, s in zip(
                rng.integers(0, len(pool_bytes) - CHUNKED_NEEDLE_MAX,
                             needles),
                rng.integers(1, CHUNKED_NEEDLE_MAX + 1, needles))]

            def put(part):
                return [(operations.upload(
                    follower.url, pool_bytes[o:o + s], collection="chunked",
                    leases=leases), o, s) for o, s in part]

            t0 = time.perf_counter()
            with concurrent.futures.ThreadPoolExecutor(
                    SERVICE_THREADS) as pool:
                parts = list(pool.map(put, [jobs[i::SERVICE_THREADS]
                                            for i in range(SERVICE_THREADS)]))
            return fids, [x for p in parts for x in p], file_secs, \
                time.perf_counter() - t0

        (fids, small, file_secs, needle_secs), _ = launches.run(
            "chunked_ingest", ingest, none=True)
        files = list(zip(fids, sizes))
        by_fid = dict(zip(fids, datas))
        manifests = {}
        for fid, size in files:
            # to the holder: a redirect would drop the query
            holder = operations.lookup(leader.url,
                                       parse_fid(fid).volume_id)[0]
            r = operations.http_request("GET", f"{holder}/{fid}?cm=false")
            if size <= chunk:
                # a manifest would answer cm=false with its JSON
                if r.status != 200 or r.body != by_fid[fid]:
                    raise AssertionError(f"{fid} ({size} B) is not one "
                                         "plain needle")
                continue
            cm = load_chunk_manifest(r.body)
            if len(cm.chunks) != -(-size // chunk) or cm.size != size or \
                    sum(c.size for c in cm.chunks) != size:
                raise AssertionError(f"{fid} ({size} B): manifest of "
                                     f"{len(cm.chunks)} chunks")
            manifests[fid] = cm
        n_chunks = sum(len(cm.chunks) for cm in manifests.values())
        handed = n_chunks + len(fids) + len(small)
        if leases.assign_round_trips >= handed:
            raise AssertionError(f"{leases.assign_round_trips} assigns for "
                                 f"{handed} file ids")
        total = sum(sizes)
        vids = sorted({parse_fid(f).volume_id for f in
                       fids + [f for f, _, _ in small] +
                       [c.fid for cm in manifests.values()
                        for c in cm.chunks]})
        out["ingest"] = dict(
            files=len(fids), bytes=total, seconds=file_secs,
            MBps=total / file_secs / 1e6, chunks=n_chunks,
            manifests=len(manifests), needles=len(small),
            needle_seconds=needle_secs, fids=handed,
            assigns=leases.assign_round_trips, volumes=vids)
        log(f"  (b) {len(fids)} files, {total} B, through leased fids "
            f"(assigns via follower {follower.url}) from "
            f"{CHUNKED_SUBMITTERS} threads in {file_secs:.3f} s = "
            f"{total / file_secs / 1e6:.1f} MB/s: {len(manifests)} "
            f"manifests of {n_chunks} chunks, {len(fids) - len(manifests)} "
            f"plain needles; {len(small)} needles of 1 B-64 KiB from "
            f"{SERVICE_THREADS} threads in {needle_secs:.3f} s; "
            f"{leases.assign_round_trips} master assigns for {handed} file "
            f"ids, in volumes {vids} [{card}]")

        # (c) healthy reads
        def healthy():
            whole = read_chunked(servers, [(fid, 0, None) for fid, _ in
                                           files], by_fid,
                                 threads=CHUNKED_SUBMITTERS)
            ranged = read_chunked(servers, jobs, by_fid)
            fid, size = next((f, s) for f, s in files if f in manifests)
            r = get_following(f"{servers[0].url}/{fid}",
                              {"Range": f"bytes={size}-"})
            if r.status != 416 or \
                    r.headers.get("content-range") != f"bytes */{size}":
                raise AssertionError(f"past the end: http {r.status} "
                                     f"{r.headers.get('content-range')}")
            suffix = get_following(f"{servers[1].url}/{fid}",
                                   {"Range": "bytes=-1234"})
            if suffix.status != 206 or suffix.body != by_fid[fid][-1234:]:
                raise AssertionError("suffix range")
            holder = operations.lookup(leader.url,
                                       parse_fid(fid).volume_id)[0]
            head = http_client.request("HEAD", f"{holder}/{fid}")
            if head.status != 200 or \
                    int(head.header("content-length")) != size:
                raise AssertionError(f"HEAD: {head.status}")
            t0 = time.perf_counter()

            def by_client(part):
                for f, o, s in part:
                    if operations.download_url(mc.lookup_file_id(f)) != \
                            pool_bytes[o:o + s]:
                        raise AssertionError(f"needle {f}: wrong bytes")

            with concurrent.futures.ThreadPoolExecutor(
                    SERVICE_THREADS) as pool:
                list(pool.map(by_client, [small[i::SERVICE_THREADS]
                                          for i in range(SERVICE_THREADS)]))
            return whole, ranged, time.perf_counter() - t0

        jobs = chunked_ranges(rng, files, ranges) + \
            [(fid, max(0, size - 1234), 1234) for fid, size in files
             if fid in manifests][:1]
        def cache_stats():
            caches = [lookup_cache.for_master(m.url) for m in masters]
            return {k: sum(c.stats()[k] for c in caches)
                    for k in ("hits", "negative_hits", "misses")}

        stats0 = cache_stats()
        batches0 = MetaLookupBatchHistogram.labels().count
        (whole, ranged, needle_read_secs), secs = launches.run(
            "chunked_healthy_reads", healthy, none=True)
        stats = {k: v - stats0[k] for k, v in cache_stats().items()}
        lookups = sum(stats.values())
        trips = MetaLookupBatchHistogram.labels().count - batches0
        if trips >= lookups:
            raise AssertionError(f"lookup cache: {trips} master round "
                                 f"trips for {lookups} lookups")
        out["healthy_reads"] = dict(
            seconds=secs, whole=len(whole),
            whole_p50_ms=float(np.percentile(whole, 50) * 1e3),
            ranged=len(ranged),
            ranged_p50_ms=float(np.percentile(ranged, 50) * 1e3),
            ranged_p99_ms=float(np.percentile(ranged, 99) * 1e3),
            needle_reads=len(small), needle_read_seconds=needle_read_secs,
            lookup_cache=dict(stats, lookups=lookups, round_trips=trips))
        log(f"  (c) every file whole through a random server ("
            f"{pcts(whole)}); {len(ranged)} ranged GETs at chunk "
            f"boundaries ({pcts(ranged)}); 416, suffix, cm=false and HEAD "
            f"answered; {len(small)} needles through "
            f"MasterClient.lookup_file_id in {needle_read_secs:.3f} s; "
            f"lookup cache {stats}, {trips} master round trips for "
            f"{lookups} lookups [{card}]")

        # (d) ec.encode of every volume on the card, through the leader
        # of now (under load an election may have moved it)
        was = leader
        leader = wait_until(lambda: leader_of(masters), 30, "one leader")
        if leader is not was:
            log(f"      the leader moved from {was.url} to {leader.url} "
                f"(term {leader.raft.current_term})")
        snap = os.path.join(workdir, "snap")
        os.makedirs(snap)
        dats = {}
        for vid in vids:
            owner = next(vs for vs in servers if vs.store.has_volume(vid))
            v = owner.store.find_volume(vid)
            v.sync()
            dats[vid] = os.path.join(snap, f"{vid}.dat")
            os.link(v.file_name() + ".dat", dats[vid])
        dat_bytes = sum(os.path.getsize(p) for p in dats.values())
        sh = Shell(leader.url)
        text, enc_secs = launches.run(
            "chunked_encode", sh.run_command,
            f"ec.encode -collection=chunked "
            f"-volumeId={','.join(map(str, vids))}")
        for vid in vids:
            if f"volume {vid}: ec.encode done" not in text:
                raise AssertionError(f"ec.encode:\n{text}")

        def encoded():
            now = leader_of(masters)
            return now is not None and all(
                now.topo.lookup_ec(v) and not now.topo.lookup(v, "chunked")
                for v in vids)

        try:
            wait_until(encoded, 30, "the EC volumes in the topology")
        except AssertionError:
            for m in masters:
                log(f"      master {m.url}: leader {m.is_leader}, term "
                    f"{m.raft.current_term}, "
                    f"{[(v, sorted(m.topo.lookup_ec(v)), [n.url for n in m.topo.lookup(v, 'chunked')]) for v in vids]}")
            log(text)
            raise
        device = "cuda" if backend == "cuda" else "cpu"
        for vid in vids:
            paths = shard_paths_of(servers, "chunked", vid)
            check_stripes(dats[vid], paths)
            link = os.path.join(snap, f"linked_{vid}")
            for sid, p in enumerate(paths):
                os.symlink(p, f"{link}.ec{sid:02d}")
            check_parity_spans(link, os.path.getsize(paths[0]), rng, 4,
                               1 << 20, device)
        out["encode"] = dict(seconds=enc_secs, dat_bytes=dat_bytes,
                             GBps=dat_bytes / enc_secs / 1e9,
                             volumes=len(vids),
                             launches=launches.per_phase["chunked_encode"])
        log(f"  (d) ec.encode -collection=chunked of {len(vids)} volumes "
            f"({dat_bytes} B of .dat): {enc_secs:.3f} s = "
            f"{dat_bytes / enc_secs / 1e9:.3f} GB/s, "
            f"{launches.per_phase['chunked_encode']} gf_linear launches; "
            f"data shards == the .dat stripes, sampled parity == "
            f"gf_linear_plain [{card}]")

        # (e) leader loss
        t0 = time.perf_counter()
        leader.stop()
        masters.remove(leader)

        def failover():
            new = wait_until(lambda: leader_of(masters), 60, "a new leader")
            elected = time.perf_counter() - t0
            wait_until(lambda: mc.current_master == new.url and
                       new.is_leader, 60, "the client at the new leader")
            named = time.perf_counter() - t0
            mapped = sum(bool(mc.vid_map.lookup(v)) for v in vids)
            wait_until(lambda: all(mc.lookup(v) for v in vids), 60,
                       "every EC volume through the client")
            return new, elected, named, mapped

        (leader, elected, named, mapped), _ = launches.run(
            "chunked_failover", failover, none=True)
        failover_s = time.perf_counter() - t0
        wait_until(lambda: registered(leader, len(servers)), 60,
                   "the servers at the new leader")
        out["failover"] = dict(seconds=failover_s, elected_seconds=elected,
                               named_seconds=named, reconnects=mc.reconnects,
                               vids_in_map=mapped, vids=len(vids))
        log(f"  (e) leader stopped; {leader.url} elected after "
            f"{elected:.3f} s, MasterClient at it after {named:.3f} s "
            f"({mc.reconnects} redials; {mapped} of {len(vids)} EC volumes "
            f"in its map then), every EC volume looked up after "
            f"{failover_s:.3f} s [{card}]")

        # (f) degraded chunked reads through a stopped server
        victim = max((vs for vs in servers
                      if all(len(held(vs, v)) <= 4 for v in vids)),
                     key=lambda vs: sum(len(held(vs, v)) for v in vids))
        victim.stop()
        servers.remove(victim)
        wait_until(lambda: victim.url not in
                   {n.url for n in leader.topo.nodes()}, 30,
                   "the master dropping the stopped server")
        d0 = sum(vs.degraded.dispatches for vs in servers)

        def degraded():
            return (read_chunked(servers, [(fid, 0, None) for fid, _ in
                                           files], by_fid,
                                 threads=CHUNKED_SUBMITTERS),
                    read_chunked(servers, jobs, by_fid))

        (whole, ranged), secs = launches.run("chunked_degraded_reads",
                                             degraded)
        dispatches = sum(vs.degraded.dispatches for vs in servers) - d0
        if not dispatches:
            raise AssertionError("degraded chunked reads: no decode fleet "
                                 "dispatch")
        out["degraded_reads"] = dict(
            seconds=secs, whole=len(whole),
            whole_p50_ms=float(np.percentile(whole, 50) * 1e3),
            whole_p99_ms=float(np.percentile(whole, 99) * 1e3),
            ranged=len(ranged),
            ranged_p50_ms=float(np.percentile(ranged, 50) * 1e3),
            ranged_p99_ms=float(np.percentile(ranged, 99) * 1e3),
            dispatches=dispatches,
            launches=launches.per_phase["chunked_degraded_reads"])
        log(f"  (f) {victim.url} stopped (at most 4 shards of every "
            f"volume); every file whole through the three others: "
            f"{pcts(whole)}; the ranged GETs again: {pcts(ranged)}; bytes "
            f"equal; {dispatches} decode fleet dispatches, "
            f"{launches.per_phase['chunked_degraded_reads']} gf_linear "
            f"launches; {secs:.3f} s [{card}]")

        # (g) delete cascade
        doomed = sorted(manifests)[:len(manifests) // 2]
        kept = [f for f in sorted(manifests) if f not in doomed]

        def cascade():
            for fid in doomed:
                operations.delete_file(leader.url, fid)
            gone = [c.fid for f in doomed for c in manifests[f].chunks] + \
                doomed
            for i, fid in enumerate(gone):
                r = get_following(f"{servers[i % len(servers)].url}/{fid}")
                if r.status != 404:
                    raise AssertionError(f"{fid} after the delete: http "
                                         f"{r.status}")
            read_chunked(servers, [(f, 0, None) for f in kept], by_fid,
                         threads=CHUNKED_SUBMITTERS)
            fid = kept[0]
            holder = operations.lookup(leader.url,
                                       parse_fid(fid).volume_id)[0]
            res = volume_stub(holder).BatchDelete(
                volume_server_pb2.BatchDeleteRequest(file_ids=[fid]))
            if res.results[0].status != 406:
                raise AssertionError(f"BatchDelete of a manifest: "
                                     f"{res.results[0]}")
            return len(gone)

        n_gone, secs = launches.run("chunked_delete", cascade, maybe=True)
        out["delete"] = dict(manifests=len(doomed), needles=n_gone,
                             seconds=secs,
                             launches=launches.per_phase["chunked_delete"])
        log(f"  (g) {len(doomed)} manifests deleted with their chunks "
            f"({n_gone} needles, all 404), {len(kept)} still whole, BatchDelete of a manifest "
            f"406; {launches.per_phase['chunked_delete']} gf_linear "
            f"launches (the cookie checks read through the EC path); "
            f"{secs:.3f} s [{card}]")

        # (h) the CLI against the leader
        def cli():
            src = os.path.join(workdir, "cli.bin")
            data = np.random.default_rng(seed + 21).bytes(cli_bytes)
            with open(src, "wb") as f:
                f.write(data)
            t0 = time.perf_counter()
            up = json.loads(run_cli(["upload", "-master", leader.url,
                                     "-maxMB", str(CHUNKED_MAX_MB), src],
                                    root))
            fid = up[0]["fid"]
            holder = operations.lookup(leader.url,
                                       parse_fid(fid).volume_id)[0]
            cm = load_chunk_manifest(operations.http_request(
                "GET", f"{holder}/{fid}?cm=false").body)
            if len(cm.chunks) != -(-cli_bytes // chunk):
                raise AssertionError(f"CLI upload: {len(cm.chunks)} chunks")
            dl = os.path.join(workdir, "dl")
            os.makedirs(dl)
            run_cli(["download", "-master", leader.url, "-dir", dl, fid],
                    root)
            with open(os.path.join(dl, fid.replace(",", "_")), "rb") as f:
                if f.read() != data:
                    raise AssertionError("CLI download: wrong bytes")
            run_cli(["delete", "-master", leader.url, fid], root)
            for f in [fid] + [c.fid for c in cm.chunks]:
                r = get_following(f"{servers[0].url}/{f}")
                if r.status != 404:
                    raise AssertionError(f"{f} after CLI delete: {r.status}")
            tools_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            report = run_cli(["benchmark", "-master", leader.url, "-n",
                              str(bench_n), "-size", "1024", "-c", "16",
                              "-assign.leaseCount", "32", "-collection",
                              "bench"], root, timeout=600)
            rates = [line.strip() for line in report.splitlines()
                     if line.startswith(("requests per second",
                                         "transfer rate",
                                         "failed requests"))]
            if len(rates) != 6 or any(line.startswith("failed") and
                                      not line.endswith(" 0")
                                      for line in rates):
                raise AssertionError(f"CLI benchmark:\n{report}")
            return tools_s, time.perf_counter() - t0, rates

        (tools_s, bench_s, rates), _ = launches.run("chunked_cli", cli,
                                                    none=True)
        out["cli"] = dict(tools_seconds=tools_s, benchmark_seconds=bench_s,
                          benchmark=rates)
        log(f"  (h) CLI upload -maxMB {CHUNKED_MAX_MB} of {cli_bytes} B, "
            f"download and delete in {tools_s:.3f} s; benchmark -n "
            f"{bench_n} -c 16 -assign.leaseCount 32 in {bench_s:.3f} s: "
            f"{'; '.join(rates)} [{card}]")
    finally:
        if mc is not None:
            mc.stop()
        for vs in servers:
            vs.stop()
        for m in masters:
            m.stop()
        lookup_cache.reset()
        http_client.close_all()
        rpc.close_channels()
    out["seconds"] = time.perf_counter() - t_phase
    out["launches"] = dict(launches.per_phase)
    return out


# the phase's writes and read-backs are paced by its QoS budget, so its
# length follows its data: 128 MiB keeps the whole command under eight
# minutes (384 MiB took it to 488.5 s on an H100 80GB HBM3 at 700 W, and
# 192 MiB to 497 s once phase 15 came)
LIFECYCLE_BYTES = 128 << 20
LIFECYCLE_VOLUME_MB = 64
LIFECYCLE_QOS_RATE = 200.0
LIFECYCLE_GOOD_RATE = 190.0      # the good clients' own pace, all threads
LIFECYCLE_NOISY_THREADS = 8
LIFECYCLE_NOISY_SECONDS = 3.0
LIFECYCLE_HOT_READS_PER_S = 30.0
LIFECYCLE_REHEAT_READS_PER_S = 10.0
LIFECYCLE_ENGINE = dict(dry_run=True, interval_s=0.5, cool_threshold=0.5,
                        warm_threshold=3.0, hot_dwell_s=2.0,
                        warm_dwell_s=2.0, max_inflight=4, freeze_s=0.0)
LIFECYCLE_HEAT_WINDOW_S = 2.0


class Pacer:
    """Spaces calls at most ``rate`` a second over every thread that
    shares it: a client keeping its tenant inside its request budget."""

    def __init__(self, rate: float):
        import threading
        self.gap = 1.0 / rate
        self.next = time.monotonic()
        self.lock = threading.Lock()

    def wait(self) -> None:
        with self.lock:
            now = time.monotonic()
            at = max(self.next, now)
            self.next = at + self.gap
        if at > now:
            time.sleep(at - now)


class TenantClient:
    """A tenant's requests to the volume servers, each carrying
    ``X-Seaweed-Tenant`` and counted by answer: what the client saw, to
    hold against the servers' QoS ledger."""

    def __init__(self, name: str, rate: float = 0.0):
        import collections
        import threading
        self.name = name
        self.pacer = Pacer(rate) if rate else None
        self.lock = threading.Lock()
        self.codes = collections.Counter()
        self.without_retry_after = 0

    def _count(self, status: int, retry_after: str = "") -> None:
        with self.lock:
            self.codes[status] += 1
            if status == 429 and not retry_after:
                self.without_retry_after += 1

    def get(self, url: str):
        return self.get_timed(url)[0]

    def get_timed(self, url: str):
        """(response, seconds of the request alone, the pace aside)."""
        from seaweedfs_tpu_torch.util import http_client
        if self.pacer is not None:
            self.pacer.wait()
        t0 = time.perf_counter()
        r = http_client.request("GET", url, timeout=60,
                                headers={"X-Seaweed-Tenant": self.name})
        dt = time.perf_counter() - t0
        self._count(r.status, r.header("retry-after"))
        return r, dt

    def upload(self, master_url: str, collection: str, data: bytes) -> str:
        """assign at the master, then the POST, both as this tenant (the
        ambient tenant rides every outbound request while QoS is on)."""
        from seaweedfs_tpu_torch.operation import operations
        from seaweedfs_tpu_torch.qos import tenant
        if self.pacer is not None:
            self.pacer.wait()
        with tenant.as_tenant(self.name):
            a = operations.assign(master_url, collection=collection)
            operations.upload_data(f"{a.url}/{a.fid}", data)
        self._count(201)
        return a.fid

    def sent(self) -> int:
        with self.lock:
            return sum(self.codes.values())


class Reader:
    """A background thread reading as one tenant, at about ``rate`` reads
    a second, every body checked: each tick the next volume in turn and
    the next of its fids, so every volume of the set is read every
    len(volumes) / rate seconds however its fids came in."""

    def __init__(self, client, rate: float, locate, want):
        import threading
        self.client = client
        self.gap = 1.0 / rate
        self.locate = locate          # fid -> url of a live holder
        self.want = want              # fid -> bytes
        self.by_vid = {}              # vid -> its fids; replaced, not mutated
        self.busy = threading.Lock()  # held around each read
        self.stop_event = threading.Event()
        self.error = None
        self.thread = threading.Thread(target=self._run, daemon=True,
                                       name="smoke-reader")

    def set(self, fids) -> None:
        from seaweedfs_tpu_torch.operation.file_id import parse_fid
        by_vid = {}
        for fid in fids:
            by_vid.setdefault(parse_fid(fid).volume_id, []).append(fid)
        self.by_vid = by_vid

    def start(self, fids):
        self.set(fids)
        self.thread.start()
        return self

    def _run(self):
        i = 0
        try:
            while not self.stop_event.wait(self.gap):
                with self.busy:
                    by_vid = self.by_vid
                    if not by_vid:
                        continue
                    vids = sorted(by_vid)
                    fids = by_vid[vids[i % len(vids)]]
                    fid = fids[(i // len(vids)) % len(fids)]
                    i += 1
                    r = self.client.get(f"{self.locate(fid)}/{fid}")
                    if r.status != 200 or r.body != self.want(fid):
                        raise AssertionError(f"{self.client.name} read "
                                             f"{fid}: http {r.status}")
        except BaseException as e:  # noqa: BLE001 - reported by stop()
            self.error = e

    def stop(self) -> None:
        self.stop_event.set()
        self.thread.join(timeout=30)
        if self.error is not None:
            import traceback
            raise AssertionError(
                "background reader: " + "".join(traceback.format_exception(
                    self.error)))


def parse_prometheus(text: str) -> dict:
    """{"name{labels}": value} of a 0.0.4 text exposition; any line that
    is neither a HELP/TYPE comment nor a sample fails the run."""
    import re
    sample = re.compile(
        r'^[a-zA-Z_:][a-zA-Z0-9_:]*(\{[a-zA-Z_][a-zA-Z0-9_]*="([^"\\]|\\.)*"'
        r'(,[a-zA-Z_][a-zA-Z0-9_]*="([^"\\]|\\.)*")*\})? '
        r'[-+]?([0-9.]+([eE][-+]?[0-9]+)?|inf|Inf|nan|NaN)$')
    out = {}
    for line in text.splitlines():
        if not line or line.startswith(("# HELP ", "# TYPE ")):
            continue
        if not sample.match(line):
            raise AssertionError(f"/metrics: not Prometheus text: {line!r}")
        key, _, value = line.rpartition(" ")
        out[key] = float(value)
    return out


def phase_lifecycle(workdir: str, seed: int, backend: str, card: str = "",
                    total_bytes: int = LIFECYCLE_BYTES,
                    volume_mb: int = LIFECYCLE_VOLUME_MB) -> dict:
    """Phase 12: a cluster that manages its own storage tiers. (a) data
    written as tenant good; (b) the lifecycle engine's dry run; (c) live:
    the idle volumes ec.encoded on the card in fused groups; (d) a noisy
    tenant shed, good untouched; (e) two EC volumes re-heated through a
    lost server and decoded back; (f) a leader failover; (g) /metrics,
    cluster.heat, volume.lifecycle, cluster.requests and cluster.trace."""
    import threading
    from seaweedfs_tpu_torch import qos, rpc
    from seaweedfs_tpu_torch.lifecycle import LifecycleConfig
    from seaweedfs_tpu_torch.operation.file_id import parse_fid
    from seaweedfs_tpu_torch.server.master import MasterServer
    from seaweedfs_tpu_torch.server.volume import VolumeServer
    from seaweedfs_tpu_torch.shell import Shell
    from seaweedfs_tpu_torch.stats import cluster_trace
    from seaweedfs_tpu_torch.stats.metrics import start_metrics_server
    from seaweedfs_tpu_torch.util import http_client

    card = card or backend
    launches = Launches(backend)
    out = {}
    rng = np.random.default_rng(seed + 30)
    buf = rng.bytes(64 << 20)
    if backend == "cuda":
        import torch
        # the CUDA context is made before the raft masters start (in the
        # full run an earlier phase has made it)
        torch.zeros(1, device="cuda")
    qos.configure(qos.QosConfig(
        request_rate=LIFECYCLE_QOS_RATE, request_burst=LIFECYCLE_QOS_RATE,
        weights={"good": 4.0, "noisy": 1.0}))
    cluster_trace.reset()
    cluster_trace.enable(sample_fraction=1.0)
    good = TenantClient("good", LIFECYCLE_GOOD_RATE)
    ports = [free_port_pair() for _ in range(REPL_MASTERS)]
    murls = [f"127.0.0.1:{p}" for p in ports]
    cfg = LifecycleConfig(**LIFECYCLE_ENGINE)
    masters = [MasterServer(port=p, meta_dir=os.path.join(workdir, f"m{i}"),
                            peers=murls, volume_size_limit_mb=volume_mb,
                            pulse_seconds=1.0, lifecycle=cfg)
               for i, p in enumerate(ports)]
    # every ec.encode / ec.decode group the engines run: (master, kind,
    # vids, start, seconds)
    groups = []
    groups_lock = threading.Lock()

    def watch(m):
        run = m.lifecycle._run_group

        def run_group(sh, group, cmd):
            t0 = time.perf_counter()
            try:
                return run(sh, group, cmd)
            finally:
                with groups_lock:
                    groups.append((m.url, group[0].kind,
                                   [t.vid for t in group], t0,
                                   time.perf_counter() - t0))
        m.lifecycle._run_group = run_group

    for m in masters:
        watch(m)
    metrics_srv = {}
    servers = []
    stopped = []
    readers = []
    t_phase = time.perf_counter()
    try:
        for m in masters:
            m.start()
            metrics_srv[m.url] = start_metrics_server(
                0, ip="127.0.0.1", role="master")
        for i in range(SERVICE_SERVERS):
            d = os.path.join(workdir, f"vol{i}")
            os.makedirs(d)
            vs = VolumeServer(
                ",".join(murls), [d], port=free_port_pair(),
                max_volume_counts=[40], pulse_seconds=1.0,
                ec_encoder=backend, cache_size_mb=0, heat_track=True,
                heat_window_s=LIFECYCLE_HEAT_WINDOW_S)
            vs.start()
            servers.append(vs)
            metrics_srv[vs.url] = start_metrics_server(
                0, ip="127.0.0.1", role="volume")
            qos.manager().heat = vs.heat

        def leader_of(ms):
            live = [m for m in ms if m not in stopped]
            leaders = [m for m in live if m.is_leader]
            return leaders[0] if len(leaders) == 1 else None

        live_servers = lambda: [vs for vs in servers  # noqa: E731
                                if vs not in stopped]

        def holders(m, vid):
            """Live urls serving vid: its normal replicas, else its EC
            shard holders."""
            up = {vs.url for vs in live_servers()}
            urls = [n.url for n in m.topo.lookup(vid)] or \
                sorted(m.topo.lookup_ec(vid))
            return [u for u in urls if u in up]

        # (a) the client finds the leader; the data, as tenant good
        leader = wait_until(lambda: leader_of(masters), 30, "one leader")
        wait_until(lambda: len(leader.topo.nodes()) == len(servers), 30,
                   "four servers at the leader")
        sizes = []
        while sum(sizes) < total_bytes:
            sizes.append(int(rng.integers(1, SERVICE_NEEDLE_MAX + 1)))
        offsets = rng.integers(0, len(buf) - SERVICE_NEEDLE_MAX,
                               len(sizes)).tolist()
        jobs = [("hot" if i % 2 == 0 else "cold", o, s)
                for i, (o, s) in enumerate(zip(offsets, sizes))]
        data = {}                  # fid -> (collection, offset, size)
        data_lock = threading.Lock()
        hot_written = []

        def want(fid):
            _, o, s = data[fid]
            return buf[o:o + s]

        known = {}    # vid -> the live holders last seen

        def locate(fid):
            """A live holder of fid's volume; while a new leader's
            topology fills from the heartbeats, the holders seen last."""
            vid = parse_fid(fid).volume_id
            urls = holders(leader_now(), vid)
            if urls:
                known[vid] = urls
            else:
                up = {vs.url for vs in live_servers()}
                urls = [u for u in known.get(vid, ()) if u in up]
            return urls[0]

        last_leader = [leader]

        def leader_now():
            """The leader, or while an election runs the last one (its
            topology still places every normal volume)."""
            m = leader_of(masters)
            if m is not None:
                last_leader[0] = m
            return last_leader[0]

        hot_reader = Reader(good, LIFECYCLE_HOT_READS_PER_S, locate, want)
        readers.append(hot_reader)

        def write():
            def worker(part):
                for col, o, s in part:
                    fid = good.upload(leader.url, col, buf[o:o + s])
                    with data_lock:
                        data[fid] = (col, o, s)
                        if col == "hot":
                            hot_written.append(fid)
                            # the hot volumes are read from their first
                            # needle on, so none of them ever looks idle
                            if len(hot_written) % 16 == 1:
                                hot_reader.set(hot_written)
            t0 = time.perf_counter()
            hot_reader.start([])
            with concurrent.futures.ThreadPoolExecutor(
                    SERVICE_THREADS) as pool:
                list(pool.map(worker, [jobs[i::SERVICE_THREADS]
                                       for i in range(SERVICE_THREADS)]))
            hot_reader.set(hot_written)
            return time.perf_counter() - t0

        write_s, _ = launches.run("lifecycle_write", write, none=True)
        vids = {c: sorted({parse_fid(f).volume_id for f, (col, _, _)
                           in data.items() if col == c})
                for c in ("hot", "cold")}
        fids_of = {}
        for f, (col, _, _) in data.items():
            fids_of.setdefault(parse_fid(f).volume_id, []).append(f)
        dat_bytes = {}
        for vs in servers:
            for vid, v in list(vs.store.locations[0].volumes.items()):
                v.sync()
                dat_bytes[vid] = os.path.getsize(v.file_name() + ".dat")
        out["write"] = dict(needles=len(data), bytes=sum(sizes),
                            seconds=write_s,
                            MBps=sum(sizes) / write_s / 1e6,
                            hot_volumes=vids["hot"],
                            cold_volumes=vids["cold"])
        log(f"  (a) leader {leader.url}; {len(data)} needles, {sum(sizes)} "
            f"B as tenant good from {SERVICE_THREADS} threads in "
            f"{write_s:.3f} s = {sum(sizes) / write_s / 1e6:.1f} MB/s "
            f"(paced at {LIFECYCLE_GOOD_RATE:.0f}/s under the "
            f"{LIFECYCLE_QOS_RATE:.0f}/s budget); hot volumes "
            f"{vids['hot']}, cold {vids['cold']} [{card}]")
        if not vids["cold"] or not vids["hot"]:
            raise AssertionError("both collections need volumes")
        if set(vids["hot"]) & set(vids["cold"]):
            raise AssertionError("a volume in both collections")

        # (b) dry run: the engine decides, and acts zero times. With the
        # cap at 4 a dry run would decide the same four volumes every
        # pass, so the cap covers every volume until the run goes live
        engine = leader.lifecycle
        for m in masters:
            m.lifecycle.cfg = m.lifecycle.cfg._replace(
                max_inflight=len(vids["hot"]) + len(vids["cold"]))

        def dry_run():
            def decided():
                st = json.loads(http_client.request(
                    "GET", f"{leader.url}/cluster/lifecycle").body)
                return st, {d["vid"] for d in st["decisions"]
                            if d["kind"] == "encode" and
                            d["outcome"] == "dry_run"}
            t0 = time.perf_counter()
            wait_until(lambda: set(vids["cold"]) <= decided()[1], 10,
                       "a dry-run encode decision for every cold volume")
            return decided(), time.perf_counter() - t0

        ((st, dry), dry_s), _ = launches.run("lifecycle_dry_run", dry_run,
                                             none=True)
        if dry & set(vids["hot"]) or st["transitions_ok"] or \
                engine.transitions_ok or groups:
            raise AssertionError(f"dry run: decided {sorted(dry)}, "
                                 f"acted {st['transitions_ok']}")
        out["dry_run"] = dict(seconds=dry_s, decided=sorted(dry),
                              passes=st["passes"])
        log(f"  (b) dry run: encode decisions for every cold volume "
            f"{sorted(dry)} within {dry_s:.3f} s, none for a hot one; "
            f"the engine acted 0 times, 0 gf_linear launches [{card}]")

        # (c) live: the idle volumes encoded on the card, fused in groups
        def encoded(m, vs_):
            """Every vid EC with its layout settled in m's topology: the
            original retired and each of the 14 shards on one server (a
            reader that caches shard locations mid-spread keeps stale
            ones for minutes)."""
            return all(not m.topo.lookup(v) and
                       sum(b.count for b in m.topo.lookup_ec(v).values())
                       == 14 for v in vs_)

        def read_all(fids, what):
            for fid in fids:
                r = good.get(f"{locate(fid)}/{fid}")
                if r.status != 200 or r.body != want(fid):
                    raise AssertionError(f"{what} {fid}: http {r.status} "
                                         f"{r.body[:300]!r}")

        def read_back_paused(fids, vids_, what):
            """Read fids back with the engine paused: the reads heat the
            just-moved volumes, so it resumes only once the leader's
            heat map has cooled again (else it would move them back)."""
            engine = leader_now().lifecycle
            engine.pause()
            t0 = time.perf_counter()
            read_all(fids, what)
            secs = time.perf_counter() - t0

            def local_heat(v):
                return sum(vs.heat.window_reads(v) for vs in live_servers())

            wait_until(lambda: not any(local_heat(v) for v in vids_), 30,
                       f"the {what} volumes' heat windows emptied")
            # then every server's next heartbeat carries the cooled heat
            t_cool = time.time()
            for vs in live_servers():
                vs.trigger_heartbeat()
            wait_until(lambda: all(n.last_seen > t_cool
                                   for n in leader_now().topo.nodes()), 30,
                       "a heartbeat from every server after the cooling")
            engine.resume()
            return secs

        t_live = time.perf_counter()
        for m in masters:
            m.lifecycle.cfg = m.lifecycle.cfg._replace(dry_run=False,
                                                       max_inflight=4)

        def go_live():
            wait_until(lambda: encoded(leader_now(), vids["cold"]), 120,
                       "every cold volume EC")
            wait_until(lambda: sum(len(g[2]) for g in groups
                                   if g[1] == "encode") ==
                       len(vids["cold"]), 30, "the engine's encode groups")
            return time.perf_counter() - t_live

        live_s, _ = launches.run("lifecycle_encode", go_live)
        enc_groups = [g for g in groups if g[1] == "encode"]
        if any(len(g[2]) > 4 for g in enc_groups) or \
                sorted(v for g in enc_groups for v in g[2]) != \
                vids["cold"]:
            raise AssertionError(f"encode groups {enc_groups}")
        if backend == "cuda" and \
                launches.per_phase["lifecycle_encode"] < len(enc_groups):
            raise AssertionError("fewer K1 launches than encode groups")
        for vs in servers:
            left = [n for n in os.listdir(vs.store.locations[0].directory)
                    if n.endswith(".dat") and n.startswith("cold_")]
            if left:
                raise AssertionError(f"{vs.url}: .dat left: {left}")
        cold_fids = [f for f, (c, _, _) in data.items() if c == "cold"]
        cold_read_s = read_back_paused(cold_fids, vids["cold"], "cold")
        enc_wall = sum(g[4] for g in enc_groups)
        enc_bytes = sum(dat_bytes[v] for v in vids["cold"])
        metrics = parse_prometheus(http_client.request(
            "GET", "127.0.0.1:%d/metrics" %
            metrics_srv[leader_now().url].server_address[1]).body.decode())
        ok = metrics.get('SeaweedFS_lifecycle_transitions_total'
                         '{kind="encode",outcome="ok"}')
        if ok != len(vids["cold"]):
            raise AssertionError(f"transitions_total encode ok = {ok}")
        out["encode"] = dict(
            seconds_to_last=live_s, groups=[len(g[2]) for g in enc_groups],
            group_seconds=[g[4] for g in enc_groups], dat_bytes=enc_bytes,
            GBps=enc_bytes / enc_wall / 1e9, cold_reads=len(cold_fids),
            cold_read_seconds=cold_read_s,
            launches=launches.per_phase["lifecycle_encode"])
        log(f"  (c) live: every cold volume EC {live_s:.3f} s after the dry "
            f"run went off, in {len(enc_groups)} fused ec.encode groups "
            f"{[len(g[2]) for g in enc_groups]} ({enc_bytes} B of .dat in "
            f"{enc_wall:.3f} s of ec.encode = "
            f"{enc_bytes / enc_wall / 1e9:.3f} GB/s), "
            f"{launches.per_phase['lifecycle_encode']} gf_linear launches; "
            f"every .dat retired; {len(cold_fids)} cold needles read back "
            f"byte-identical in {cold_read_s:.3f} s; transitions_total "
            f"encode ok = {ok:.0f} at the leader's /metrics [{card}]")

        # (d) QoS: a noisy tenant at about 4x the request rate
        noisy = TenantClient("noisy")
        hot_fids = list(hot_written)

        def latencies(seconds, stop=None):
            lat = []
            t_end = time.monotonic() + seconds
            i = 0
            while time.monotonic() < t_end and not (stop and stop()):
                fid = hot_fids[(i * 7919) % len(hot_fids)]
                i += 1
                r, dt = good.get_timed(f"{locate(fid)}/{fid}")
                lat.append(dt)
                if r.status != 200 or r.body != want(fid):
                    raise AssertionError(f"good {fid}: http {r.status}")
                time.sleep(0.02)
            return lat

        def qos_step():
            before = latencies(LIFECYCLE_NOISY_SECONDS)
            gap = LIFECYCLE_NOISY_THREADS / (4 * LIFECYCLE_QOS_RATE)
            t_end = time.monotonic() + LIFECYCLE_NOISY_SECONDS

            def flood(k):
                i = k
                nxt = time.monotonic()
                while time.monotonic() < t_end:
                    fid = hot_fids[(i * 104729) % len(hot_fids)]
                    i += LIFECYCLE_NOISY_THREADS
                    r = noisy.get(f"{locate(fid)}/{fid}")
                    if r.status == 200 and r.body != want(fid):
                        raise AssertionError(f"noisy {fid}: wrong bytes")
                    nxt += gap
                    time.sleep(max(0.0, nxt - time.monotonic()))

            with concurrent.futures.ThreadPoolExecutor(
                    LIFECYCLE_NOISY_THREADS + 1) as pool:
                futs = [pool.submit(flood, k)
                        for k in range(LIFECYCLE_NOISY_THREADS)]
                during = latencies(LIFECYCLE_NOISY_SECONDS)
                for f in futs:
                    f.result()
            return before, during

        (before, during), qos_s = launches.run("lifecycle_qos", qos_step,
                                               none=True)
        n_noisy = noisy.sent()
        if not noisy.codes[429] or noisy.without_retry_after or \
                set(noisy.codes) - {200, 429}:
            raise AssertionError(f"noisy: {dict(noisy.codes)}, "
                                 f"{noisy.without_retry_after} 429s "
                                 "without Retry-After")
        if set(good.codes) - {200, 201}:
            raise AssertionError(f"good: {dict(good.codes)}")
        status = qos.manager().status()["tenants"]
        internal = status.get("_internal", {}).get("shed", {})
        if any(internal.values()):
            raise AssertionError(f"_internal shed: {internal}")
        # the hot reader is held between two reads while the ledger is
        # read, so both sides count the same requests
        with hot_reader.busy:
            text = Shell(leader_now().url).run_command("cluster.qos")
            good_sent = good.sent()

        def ledger(name):
            line = next(ln for ln in text.splitlines()
                        if ln.strip().startswith(name + " "))
            admitted = int(line.split("admitted:")[1].split()[0])
            shed = line.split("shed:")[1].split(" conns:")[0]
            shed = 0 if shed == "0" else sum(
                int(x.split(":")[1]) for x in shed.split())
            return admitted, shed

        got = {"good": ledger("good"), "noisy": ledger("noisy")}
        want_ledger = {"good": (good_sent, 0),
                       "noisy": (noisy.codes[200], noisy.codes[429])}
        if got != want_ledger:
            raise AssertionError(f"cluster.qos {got} != the clients' "
                                 f"{want_ledger}:\n{text}")
        out["qos"] = dict(
            noisy_sent=n_noisy, noisy_rate=n_noisy / LIFECYCLE_NOISY_SECONDS,
            noisy_admitted=noisy.codes[200], noisy_shed=noisy.codes[429],
            good_sent=good_sent, good_shed=0,
            good_p50_ms_before=float(np.percentile(before, 50) * 1e3),
            good_p99_ms_before=float(np.percentile(before, 99) * 1e3),
            good_p50_ms_during=float(np.percentile(during, 50) * 1e3),
            good_p99_ms_during=float(np.percentile(during, 99) * 1e3),
            seconds=qos_s)
        log(f"  (d) noisy: {n_noisy} reads in {LIFECYCLE_NOISY_SECONDS:.0f} "
            f"s from {LIFECYCLE_NOISY_THREADS} threads "
            f"({n_noisy / LIFECYCLE_NOISY_SECONDS:.0f}/s against "
            f"{LIFECYCLE_QOS_RATE:.0f}/s): {noisy.codes[200]} admitted, "
            f"{noisy.codes[429]} shed with 429 + Retry-After; good: "
            f"{good_sent} requests, 0 shed, p50/p99 "
            f"{np.percentile(before, 50) * 1e3:.2f}/"
            f"{np.percentile(before, 99) * 1e3:.2f} ms before, "
            f"{np.percentile(during, 50) * 1e3:.2f}/"
            f"{np.percentile(during, 99) * 1e3:.2f} ms during; _internal 0 "
            f"shed; cluster.qos equals the clients' counts [{card}]")

        # (e) re-heat two EC volumes through a lost server
        def data_shards(vid):
            """{shard id: [fids whose needle lies on it]} of an EC vid."""
            ecv = next(vs.store.find_ec_volume(vid) for vs in servers
                       if vs.store.find_ec_volume(vid) is not None)
            on = {}
            for fid in fids_of[vid]:
                for iv in ecv.locate_needle(parse_fid(fid).key)[2]:
                    sid = iv.to_shard_and_offset(ecv.large_block,
                                                 ecv.small_block)[0]
                    on.setdefault(sid, []).append(fid)
            return on

        layout = {v: data_shards(v) for v in vids["cold"]}
        best = None
        # the victim may hold at most four shards of each volume it
        # re-heats, so both stay readable. No cold volume other than those
        # two is read while it is down; and "at most four of every cold
        # volume" may fit no server, since the spread by free slots can put
        # 5, 5 and 4 shards of each volume on the same three servers.
        for vs in servers:
            hit = sorted(((sum(len(layout[v].get(s, ()))
                               for s in held(vs, v)), v)
                          for v in vids["cold"] if len(held(vs, v)) <= 4),
                         reverse=True)[:2]
            if len(hit) == 2 and hit[1][0] > 0 and \
                    (best is None or hit[1][0] > best[0][1][0]):
                best = (hit, vs)
        if best is None:
            raise AssertionError("no server holds needles of two volumes "
                                 "of which it has at most four shards")
        (h1, h2), victim = best
        reheat = sorted([h1[1], h2[1]])
        lost = {v: held(victim, v) for v in reheat}
        crossing = [f for v in reheat for s in lost[v]
                    for f in layout[v].get(s, ())]
        only_victim = {v for v in vids["hot"]
                       if holders(leader, v) == [victim.url]}
        engine = leader_now().lifecycle
        engine.pause()
        with hot_reader.busy:
            hot_reader.set([f for f in hot_written
                            if parse_fid(f).volume_id not in only_victim])
            victim.stop()
            stopped.append(victim)
        srv = metrics_srv.pop(victim.url)
        srv.shutdown()
        srv.server_close()
        wait_until(lambda: victim.url not in
                   {n.url for n in leader_now().topo.nodes()}, 30,
                   "the master dropping the stopped server")
        reheat_fids = [f for v in reheat for f in fids_of[v]]
        d0 = sum(vs.degraded.dispatches for vs in live_servers())

        trace_file = os.path.join(workdir, "degraded_read_trace.json")

        def reheat_reads():
            read_all(reheat_fids, "re-heat")
            # one degraded read more, named by the sampled list and
            # stitched by cluster.trace now, while the process-wide rings
            # (256 kept requests) still hold it; checked in (g)
            fid = crossing[0]
            via = locate(fid)
            read_all([fid], "traced")
            sampled = json.loads(http_client.request(
                "GET", f"{via}/debug/trace?sampled=1").body)["sampled"]
            tid = next(s["trace_id"] for s in sampled
                       if s["path"] == f"/{fid}")
            text = Shell(leader_now().url).run_command(
                f"cluster.trace -traceId={tid} -out={trace_file}")
            # the stitching took a moment: heat both volumes until the
            # leader's heat map holds them above the warm threshold
            def seen():
                read_all([f for v in reheat for f in fids_of[v][:4]],
                         "re-heat")
                heat = leader_now().topo.cluster_heat()
                return all(heat.get(v, {}).get("reads_window", 0.0) >=
                           cfg.warm_threshold for v in reheat)

            wait_until(seen, 30, "the re-heat in the leader's heat map")
            return tid, text

        (trace_id, trace_text), reads_s = launches.run(
            "lifecycle_reheat_reads", reheat_reads)
        dispatches = sum(vs.degraded.dispatches
                         for vs in live_servers()) - d0
        if not dispatches:
            raise AssertionError("re-heat reads: no decode fleet dispatch")
        with open(trace_file) as f:
            stitched = json.load(f)
        lanes = sorted(e["args"]["name"] for e in stitched["traceEvents"]
                       if e["ph"] == "M")
        n_spans = sum(1 for e in stitched["traceEvents"] if e["ph"] == "X")
        engine.resume()
        engine.run_pass_now()
        t_dec = time.perf_counter()

        def decodes():
            m = leader_now()
            wait_until(lambda: all(m.topo.lookup(v) and not
                                   m.topo.lookup_ec(v) for v in reheat),
                       120, "both re-heated volumes decoded")
            wait_until(lambda: sum(len(g[2]) for g in groups
                                   if g[1] == "decode") == 2, 30,
                       "the engine's decode groups")
            return time.perf_counter() - t_dec

        dec_s, _ = launches.run("lifecycle_reheat_decode", decodes)
        read_all(reheat_fids, "decoded")
        metrics = parse_prometheus(http_client.request(
            "GET", "127.0.0.1:%d/metrics" %
            metrics_srv[leader_now().url].server_address[1]).body.decode())
        dec_ok = metrics.get('SeaweedFS_lifecycle_transitions_total'
                             '{kind="decode",outcome="ok"}')
        if dec_ok != 2:
            raise AssertionError(f"transitions_total decode ok = {dec_ok}")
        # the re-heated volumes stay read to the end of the phase (else
        # an idle one would be encoded a second time)
        reheat_reader = Reader(good, LIFECYCLE_REHEAT_READS_PER_S, locate,
                               want).start(reheat_fids)
        readers.append(reheat_reader)
        out["reheat"] = dict(
            victim=victim.url, volumes=reheat,
            lost_shards={str(v): sorted(s) for v, s in lost.items()},
            reads=len(reheat_fids), read_seconds=reads_s,
            dispatches=dispatches,
            read_launches=launches.per_phase["lifecycle_reheat_reads"],
            decode_seconds=dec_s,
            decode_launches=launches.per_phase["lifecycle_reheat_decode"],
            hot_only_on_victim=sorted(only_victim))
        log(f"  (e) {victim.url} stopped (shards {out['reheat']['lost_shards']} "
            f"of volumes {reheat}); {len(reheat_fids)} reads as good "
            f"in {reads_s:.3f} s: {dispatches} decode fleet dispatches, "
            f"{launches.per_phase['lifecycle_reheat_reads']} gf_linear "
            f"launches; both decoded back {dec_s:.3f} s after the engine "
            f"resumed, {launches.per_phase['lifecycle_reheat_decode']} "
            f"gf_linear launches rebuilding the lost data shards; every "
            f"needle byte-identical; transitions_total decode ok = "
            f"{dec_ok:.0f}; hot volumes only on it: {sorted(only_victim)} "
            f"[{card}]")

        # (f) failover: the new leader reconciles, then encodes hot
        old = leader_now()
        t_stop = time.perf_counter()
        old.stop()
        stopped.append(old)
        metrics_srv.pop(old.url).shutdown()
        live_hot = [v for v in vids["hot"] if v not in only_victim]
        warm = [v for v in vids["cold"] if v not in reheat]

        def failover():
            new = wait_until(lambda: leader_of(masters), 60, "a new leader")
            elected = time.perf_counter() - t_stop
            wait_until(lambda: len(new.topo.nodes()) == len(live_servers()),
                       60, "the servers at the new leader")
            want_states = {**{v: "warm" for v in warm},
                           **{v: "hot" for v in live_hot + reheat}}
            wait_until(lambda: all(
                (new.lifecycle.states.get(v) or (None,))[0] == s
                for v, s in want_states.items()), 60,
                "the new leader's engine reconciled")
            reconciled = time.perf_counter() - t_stop
            n_groups = len(groups)
            hot_reader.stop()
            wait_until(lambda: encoded(new, live_hot), 120,
                       "the new leader encoding the hot volumes")
            wait_until(lambda: sum(len(g[2]) for g in groups[n_groups:]
                                   if g[1] == "encode") == len(live_hot),
                       30, "the new leader's encode groups")
            first = min(g[3] for g in groups[n_groups:]) - t_stop
            return new, elected, reconciled, first, n_groups

        (new, elected, reconciled, first, n_groups), fo_s = launches.run(
            "lifecycle_failover", failover)
        again = [g for g in groups[n_groups:] if g[1] != "encode" or
                 set(g[2]) - set(live_hot)]
        if again:
            raise AssertionError(f"the new leader moved {again}")
        done = [(g[1], v) for g in groups for v in g[2]]
        if len(done) != len(set(done)):
            raise AssertionError(f"a volume moved twice: {done}")
        read_back_paused([f for v in live_hot for f in fids_of[v]],
                         live_hot, "hot")
        out["failover"] = dict(
            new_leader=new.url, elected_seconds=elected,
            reconciled_seconds=reconciled,
            first_transition_seconds=first, seconds=fo_s,
            encoded=live_hot,
            launches=launches.per_phase["lifecycle_failover"])
        log(f"  (f) leader {old.url} stopped; {new.url} elected after "
            f"{elected:.3f} s, its engine reconciled after {reconciled:.3f} "
            f"s (warm {warm} stay warm, nothing moved twice); hot reader "
            f"stopped; first transition {first:.3f} s after the stop; hot "
            f"volumes {live_hot} EC and read back, "
            f"{launches.per_phase['lifecycle_failover']} gf_linear "
            f"launches [{card}]")

        # (g) what an operator sees
        def observe():
            sh = Shell(new.url)
            live_vids = sorted({v for n in new.topo.nodes()
                                for v in list(n.volumes) +
                                list(n.ec_shards)})
            scraped = {}
            for url, srv in metrics_srv.items():
                text = http_client.request(
                    "GET", "127.0.0.1:%d/metrics" %
                    srv.server_address[1]).body.decode()
                scraped[url] = parse_prometheus(text)
            for url, samples in scraped.items():
                keys = list(samples)
                for v in live_vids:
                    if f'SeaweedFS_volume_heat{{vid="{v}"}}' not in samples:
                        raise AssertionError(f"{url}: no heat for {v}")
                for prefix in (
                        "SeaweedFS_cluster_volume_heat{",
                        'SeaweedFS_lifecycle_transitions_total{kind="encode"',
                        "SeaweedFS_lifecycle_pass_seconds_count",
                        "SeaweedFS_lifecycle_volume_states{",
                        'SeaweedFS_qos_admitted_total{tenant="good"}',
                        'SeaweedFS_qos_shed_total{tenant="noisy",'
                        'reason="requests"}',
                        'SeaweedFS_request_total{type="volumeServer",'
                        'name="get"}',
                        'SeaweedFS_request_total{type="master"',
                        "SeaweedFS_trace_requests_total{"):
                    if not any(k.startswith(prefix) for k in keys):
                        raise AssertionError(f"{url}: no {prefix}")
            heat = sh.run_command("cluster.heat")
            tiers = {}
            for line in heat.splitlines():
                if line.startswith("volume "):
                    vid = int(line.split()[1].rstrip(":"))
                    tiers[vid] = line.split("state:")[1].split()[0]
            want_tiers = {**{v: "warm" for v in warm + live_hot},
                          **{v: "hot" for v in reheat}}
            if any(tiers.get(v) != s for v, s in want_tiers.items()):
                raise AssertionError(f"cluster.heat {tiers}:\n{heat}")
            lc = sh.run_command("volume.lifecycle -status")
            sh.run_command("volume.lifecycle -pause")
            paused = "PAUSED" in sh.run_command("volume.lifecycle")
            sh.run_command("volume.lifecycle -resume")
            if not paused or new.lifecycle.paused or "lifecycle:" not in lc:
                raise AssertionError(f"volume.lifecycle:\n{lc}")
            requests = sh.run_command("cluster.requests")
            return len(scraped), len(live_vids), tiers, requests

        (n_scraped, n_vids, tiers, requests), obs_s = launches.run(
            "lifecycle_observe", observe, none=True)
        servers_in_trace = {n.split(" ", 1)[1] for n in lanes}
        if len(servers_in_trace) < 2:
            raise AssertionError(f"cluster.trace {trace_id}: lanes {lanes}"
                                 f"\n{trace_text}")
        out["observe"] = dict(scraped=n_scraped, vids=n_vids,
                              trace_id=trace_id, trace_lanes=lanes,
                              trace_spans=n_spans, seconds=obs_s)
        log(f"  (g) {n_scraped} /metrics scrapes parse as Prometheus text "
            f"with the heat of all {n_vids} live volumes and the cluster "
            f"heat, lifecycle, QoS, trace and request families; "
            f"cluster.heat tiers {tiers}; volume.lifecycle status, pause "
            f"and resume; cluster.requests answered "
            f"({len(requests.splitlines())} lines); cluster.trace "
            f"-traceId={trace_id} of one degraded read of (e): {n_spans} "
            f"spans over {lanes}, Chrome JSON at {trace_file} [{card}]")
    finally:
        for r in readers:
            r.stop_event.set()
        for r in readers:
            r.thread.join(timeout=30)
        for vs in servers:
            if vs not in stopped:
                vs.stop()
        for m in masters:
            if m not in stopped:
                m.stop()
        for srv in metrics_srv.values():
            srv.shutdown()
            srv.server_close()
        qos.reset()
        cluster_trace.disable()
        cluster_trace.reset()
        http_client.close_all()
        rpc.close_channels()
    out["seconds"] = time.perf_counter() - t_phase
    out["launches"] = dict(launches.per_phase)
    return out


# --- phase 13 -----------------------------------------------------------------

# (a) the two serving models, each a master and a volume server as
# subprocesses, driven from this process by one selector thread over
# keep-alive connections (the JAX package's bench.py:1182 workloads): 4 KiB
# GETs at 8 connections, 1 MiB GETs at 4 (the sendfile path), 4 KiB GETs
# at 256, each in rounds of SERVE_ROUND_S in the order threaded, async,
# async, threaded.
SERVE_ROUND_S = 2.0
SERVE_ORDER = ("threaded", "async", "async", "threaded")
SERVE_WORKLOADS = (("small_c8", 4096, 8), ("large_c4", 1 << 20, 4),
                   ("small_c256", 4096, 256))
# (b) degraded reads through the async core on the card: one master and
# four volume servers in this process, volumes of 64 MiB, placement 000,
# about 32 MiB of 1 KiB needles (upstream `weed benchmark -size 1024 -c 16`)
# in two volumes plus 16 needles of 1-4 MiB.
SERVE_VOLUME_MB = 64
SERVE_SMALL_BYTES = 32 << 20
SERVE_LARGE = 16
SERVE_DEGRADED_READS = 1024
SERVE_DEGRADED_CONNS = 16
SERVE_IDLE_CONNS = 256
SERVE_KEEPALIVE_BUDGET = 64
SERVE_QOS_MAX_CONNS = 64
SERVE_HOG_CONNS = 56          # past 7/8 of -serve.maxConns with good's
SERVE_GOOD_CONNS = 4
# needle keys written straight into the stores, far above the master's
# sequencer, so no assigned key meets one
SERVE_KEY0 = 1 << 40


class _PumpConn:
    __slots__ = ("sock", "jobs", "i", "buf", "need", "head_end", "t0")

    def __init__(self, sock, jobs):
        self.sock = sock
        self.jobs = jobs
        self.i = 0
        self.buf = bytearray()
        self.need = -1
        self.head_end = 0
        self.t0 = 0.0


def get_request(path: str, extra: str = "") -> bytes:
    return f"GET /{path} HTTP/1.1\r\nHost: s\r\n{extra}\r\n".encode()


def keepalive_pump(conn_jobs, seconds: float = 0.0, midway=None) -> dict:
    """One selector thread drives one keep-alive socket per entry of
    ``conn_jobs``, a list of (port, request bytes, wanted status, wanted
    body or None) that the connection sends one at a time, reading each
    reply whole. With ``seconds`` every connection is opened and answers
    one request before the next is opened (a burst of connects overflows
    a listen backlog, and the kernel's SYN retries would then be what is
    timed), then cycles its list until the time is up, and its last
    request is answered before it closes (a close with a reply in flight
    resets the server's socket); without, it sends its list once.
    ``midway`` is called once halfway through a timed run. Returns the
    counts within the time, the latencies' p50/p99 and the replies that
    were not what was wanted."""
    import selectors
    import socket
    sel = selectors.DefaultSelector()
    conns, lat, errors = [], [], []
    nbytes = 0
    for jobs in conn_jobs:
        s = socket.create_connection(("127.0.0.1", jobs[0][0]), timeout=30)
        if seconds:
            s.sendall(jobs[0][1])
            if not read_reply(s).startswith(b"HTTP/1.1 %d " % jobs[0][2]):
                errors.append("the opening request failed")
        s.setblocking(False)
        c = _PumpConn(s, jobs)
        conns.append(c)
        sel.register(s, selectors.EVENT_READ, c)
    t_start = time.perf_counter()
    deadline = t_start + seconds if seconds else None
    for c in conns:
        c.t0 = time.perf_counter()
        c.sock.sendall(c.jobs[0][1])
    live = len(conns)
    timed_out = False

    def drop(c, why):
        nonlocal live
        errors.append(why)
        sel.unregister(c.sock)
        live -= 1

    while live:
        now = time.perf_counter()
        if deadline is not None and now >= deadline + 30:
            timed_out = True
            break
        if midway is not None and now >= t_start + seconds / 2:
            midway()
            midway = None
        for key, _ in sel.select(0.05):
            c = key.data
            try:
                data = c.sock.recv(1 << 20)
            except BlockingIOError:
                continue
            except OSError as e:
                drop(c, f"recv: {e}")
                continue
            if not data:
                drop(c, "closed by the server")
                continue
            c.buf += data
            while True:
                if c.need < 0:
                    end = c.buf.find(b"\r\n\r\n")
                    if end < 0:
                        break
                    head = bytes(c.buf[:end]).lower()
                    i = head.find(b"\r\ncontent-length:")
                    j = head.find(b"\r\n", i + 2)
                    clen = int(head[i + 17:j if j > 0 else len(head)]) \
                        if i >= 0 else 0
                    c.head_end = end + 4
                    c.need = end + 4 + clen
                if len(c.buf) < c.need:
                    break
                _port, _req, status, want = c.jobs[c.i]
                if not c.buf.startswith(b"HTTP/1.1 %d " % status) or \
                        (want is not None and
                         c.buf[c.head_end:c.need] != want):
                    errors.append(bytes(c.buf[:min(c.need, 300)]))
                done = time.perf_counter()
                if deadline is None or done <= deadline:
                    lat.append(done - c.t0)
                    nbytes += c.need - c.head_end
                del c.buf[:c.need]
                c.need = -1
                c.i += 1
                if c.i == len(c.jobs):
                    c.i = 0
                    if deadline is None:
                        sel.unregister(c.sock)
                        live -= 1
                        break
                if deadline is not None and done >= deadline:
                    sel.unregister(c.sock)   # answered; nothing in flight
                    live -= 1
                    break
                c.t0 = time.perf_counter()
                try:
                    c.sock.sendall(c.jobs[c.i][1])
                except OSError as e:
                    drop(c, f"send: {e}")
                    break
    wall = min(time.perf_counter(), deadline or float("inf")) - t_start
    for c in conns:
        c.sock.close()
    sel.close()
    if timed_out:
        errors.append(f"{live} connections unanswered 30 s past the end")
    a = np.asarray(lat or [0.0]) * 1e3
    return dict(reqs=len(lat), seconds=wall, rps=len(lat) / wall,
                MBps=nbytes / wall / 1e6, p50_ms=float(np.percentile(a, 50)),
                p99_ms=float(np.percentile(a, 99)), errors=len(errors),
                first_errors=[repr(e)[:300] for e in errors[:3]])


def proc_threads(pid: int) -> int:
    with open(f"/proc/{pid}/status") as f:
        for line in f:
            if line.startswith("Threads:"):
                return int(line.split()[1])
    raise AssertionError(f"/proc/{pid}/status has no Threads line")


def raise_nofile(want: int) -> tuple:
    """Lift the soft open-file limit to the hard one when it is below
    ``want``; fails when the hard limit cannot hold ``want``."""
    import resource
    soft, hard = resource.getrlimit(resource.RLIMIT_NOFILE)
    if soft < want and soft < hard:
        resource.setrlimit(resource.RLIMIT_NOFILE, (hard, hard))
    now = resource.getrlimit(resource.RLIMIT_NOFILE)[0]
    if now != resource.RLIM_INFINITY and now < want:
        raise AssertionError(f"RLIMIT_NOFILE {now} (hard {hard}) cannot "
                             f"hold {want} descriptors")
    return soft, now


def serve_models(workdir: str, backend: str, card: str, seed: int,
                 round_s: float) -> dict:
    """Phase 13 (a): each serving model in its own master and volume
    server processes; SERVE_WORKLOADS in SERVE_ORDER."""
    import signal
    from seaweedfs_tpu_torch.operation import operations
    from seaweedfs_tpu_torch.util import http_client
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=root)
    rng = np.random.default_rng(seed + 41)
    bodies = {size: rng.bytes(size) for _, size, _ in SERVE_WORKLOADS}
    procs, logs, srv = {}, {}, {}
    for model in ("threaded", "async"):
        mport, vport = free_port_pair(), free_port_pair()
        mp = free_port_pair()
        srv[model] = dict(murl=f"127.0.0.1:{mport}", vport=vport,
                          metrics=f"127.0.0.1:{mp}")
        extra = ["-serve.async"] if model == "async" else []
        for role, args in (
                ("master", ["master", "-port", str(mport), "-mdir",
                            os.path.join(workdir, f"{model}_m"),
                            "-volumeSizeLimitMB", str(SERVE_VOLUME_MB),
                            "-pulseSeconds", "1", *extra]),
                ("volume", ["volume", "-port", str(vport), "-dir",
                            os.path.join(workdir, f"{model}_v"),
                            "-mserver", f"127.0.0.1:{mport}", "-max", "8",
                            "-pulseSeconds", "1", "-ec.encoder", backend,
                            "-metricsPort", str(mp), *extra])):
            logs[model, role] = os.path.join(workdir, f"{model}_{role}.log")
            with open(logs[model, role], "wb") as err:
                procs[model, role] = subprocess.Popen(
                    [sys.executable, "-m", "seaweedfs_tpu_torch", *args],
                    cwd=root, env=env, stdout=subprocess.DEVNULL,
                    stderr=err)
    rounds = {w: {m: [] for m in ("threaded", "async")}
              for w, _, _ in SERVE_WORKLOADS}

    def sendfile_bytes(model) -> float:
        text = operations.http_request(
            "GET", f"{srv[model]['metrics']}/metrics").body.decode()
        return parse_prometheus(text).get(
            'SeaweedFS_serve_sendfile_bytes_total{role="volume"}', 0.0)

    t0 = time.perf_counter()
    try:
        for model, info in srv.items():
            vurl = f"127.0.0.1:{info['vport']}"

            def registered(murl=info["murl"], vurl=vurl):
                try:
                    topo = json.loads(operations.http_request(
                        "GET", f"{murl}/dir/status").body)["Topology"]
                except (OSError, ValueError, KeyError):
                    return False
                return any(n["url"] == vurl for dc in topo["data_centers"]
                           for r in dc["racks"] for n in r["nodes"])

            wait_until(registered, 120, f"the {model} volume server")
            info["fids"] = {size: operations.upload(info["murl"], body,
                                                    collection="serve")
                            for size, body in bodies.items()}
        start_s = time.perf_counter() - t0
        for wname, size, n_conns in SERVE_WORKLOADS:
            for model in SERVE_ORDER:
                info = srv[model]
                req = get_request(info["fids"][size])
                jobs = [[(info["vport"], req, 200, bodies[size])]
                        for _ in range(n_conns)]
                threads = []
                pid = procs[model, "volume"].pid
                before = sendfile_bytes(model)
                r = keepalive_pump(jobs, seconds=round_s, midway=lambda:
                                   threads.append(proc_threads(pid)))
                r["threads"] = threads[0] if threads else None
                r["sendfile_bytes"] = sendfile_bytes(model) - before
                if r["errors"]:
                    raise AssertionError(f"{wname} {model}: {r['errors']} "
                                         f"bad replies: {r['first_errors']}")
                if wname.startswith("large") and model == "async" and \
                        r["sendfile_bytes"] <= 0:
                    raise AssertionError(f"{wname} async: no byte went "
                                         "out through sendfile")
                rounds[wname][model].append(r)
                log(f"  (a) {wname} {model}: {r['rps']:.1f} req/s, "
                    f"{r['MBps']:.1f} MB/s, p50 {r['p50_ms']:.3f} ms, "
                    f"p99 {r['p99_ms']:.3f} ms, {r['errors']} errors, "
                    f"{r['threads']} server threads, sendfile "
                    f"{r['sendfile_bytes']:.0f} B [{card}]")
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.send_signal(signal.SIGTERM)
        codes = {k: p.wait(timeout=60) for k, p in procs.items()}
        http_client.close_all()
    for key, code in codes.items():
        text = open(logs[key], errors="replace").read()
        if code != 0 or "Traceback" in text:
            raise AssertionError(f"{key} exited {code}:\n{text[-4000:]}")
    summary = {}
    for wname, by_model in rounds.items():
        summary[wname] = {}
        for model, rs in by_model.items():
            summary[wname][model] = {
                k: float(np.median([r[k] for r in rs]))
                for k in ("rps", "MBps", "p50_ms", "p99_ms")}
            summary[wname][model]["errors"] = sum(r["errors"] for r in rs)
            summary[wname][model]["threads"] = [r["threads"] for r in rs]
            summary[wname][model]["sendfile_bytes"] = sum(
                r["sendfile_bytes"] for r in rs)
        summary[wname]["async_over_threaded_rps"] = \
            summary[wname]["async"]["rps"] / \
            summary[wname]["threaded"]["rps"]
    return dict(seconds=time.perf_counter() - t0, start_seconds=start_s,
                round_seconds=round_s, rounds=rounds, summary=summary)


def read_reply(sock) -> bytes:
    """One whole reply from a blocking keep-alive socket (its head, then
    Content-Length bytes)."""
    buf = b""
    while b"\r\n\r\n" not in buf:
        d = sock.recv(1 << 20)
        if not d:
            raise AssertionError(f"connection closed mid-reply: {buf!r}")
        buf += d
    head, _, body = buf.partition(b"\r\n\r\n")
    n = next(int(line.split(b":", 1)[1]) for line in head.split(b"\r\n")
             if line.lower().startswith(b"content-length:"))
    while len(body) < n:
        d = sock.recv(1 << 20)
        if not d:
            raise AssertionError("connection closed mid-body")
        body += d
    return head + b"\r\n\r\n" + body


def raw_get(url: str, path: str, extra: str = "") -> bytes:
    """One GET on a fresh connection, read to the server's close: the
    reply's bytes with the Date line taken out."""
    import re
    import socket
    host, port = url.split(":")
    with socket.create_connection((host, int(port)), timeout=60) as s:
        s.sendall(f"GET /{path} HTTP/1.1\r\nHost: {host}\r\n{extra}"
                  "Connection: close\r\n\r\n".encode())
        out = bytearray()
        while True:
            d = s.recv(1 << 20)
            if not d:
                break
            out += d
    return re.sub(rb"\r\nDate: [^\r]*", b"", bytes(out), count=1)


def phase_serve(workdir: str, seed: int, backend: str, card: str = "",
                small_bytes: int = SERVE_SMALL_BYTES,
                round_s: float = SERVE_ROUND_S) -> dict:
    """Phase 13: the async serving core. (a) threaded against async in
    server processes of their own; (b) degraded reads through the async
    core of an in-process cluster, K1 rebuilding the lost intervals on
    the card; the keep-alive budget, QoS at frame time, and the async
    GET bytes against a threaded server's."""
    import gzip
    import io
    from seaweedfs_tpu_torch import qos, rpc
    from seaweedfs_tpu_torch.operation import operations
    from seaweedfs_tpu_torch.operation.file_id import format_fid, parse_fid
    from seaweedfs_tpu_torch.server.master import MasterServer
    from seaweedfs_tpu_torch.server.volume import VolumeServer
    from seaweedfs_tpu_torch.shell import Shell
    from seaweedfs_tpu_torch.stats.metrics import (ServeSendfileBytesCounter,
                                                   ServeShedCounter)
    from seaweedfs_tpu_torch.storage.needle import Needle
    from seaweedfs_tpu_torch.util import http_client
    from seaweedfs_tpu_torch.util.http_server import FastHandler, ServeConfig

    card = card or backend
    t_phase = time.perf_counter()
    soft, now = raise_nofile(4 * SERVE_IDLE_CONNS + 1024)
    log(f"  RLIMIT_NOFILE soft {soft} -> {now}")
    out = {"nofile": [soft, now]}
    out["models"] = serve_models(workdir, backend, card, seed, round_s)
    for wname, by in out["models"]["summary"].items():
        log(f"  (a) {wname}: async/threaded req/s "
            f"{by['async_over_threaded_rps']:.3f}; threads at the round's "
            f"middle threaded {by['threaded']['threads']}, async "
            f"{by['async']['threads']} [{card}]")

    launches = Launches(backend)
    rng = np.random.default_rng(seed + 42)
    if backend == "cuda":
        import torch
        torch.zeros(1, device="cuda")
    async_cfg = ServeConfig(async_mode=True,
                            keepalive_budget=SERVE_KEEPALIVE_BUDGET)
    master = MasterServer(port=free_port_pair(),
                          meta_dir=os.path.join(workdir, "m"),
                          volume_size_limit_mb=SERVE_VOLUME_MB,
                          pulse_seconds=1.0,
                          serve=ServeConfig(async_mode=True))
    servers, stopped = [], []
    copy_vs = None

    def volume_server(d, port, serve):
        return VolumeServer(master.url, [d], port=port,
                            max_volume_counts=[16], pulse_seconds=1.0,
                            ec_encoder=backend, serve=serve)

    def topo_has(urls):
        return {n.url for n in master.topo.nodes()} == set(urls)

    try:
        master.start()
        for i in range(SERVICE_SERVERS):
            d = os.path.join(workdir, f"vol{i}")
            os.makedirs(d)
            vs = volume_server(d, free_port_pair(), async_cfg)
            vs.start()
            servers.append(vs)
        wait_until(lambda: topo_has(vs.url for vs in servers), 60,
                   "four servers at the master")

        # the data: two volumes, 1 KiB needles straight into the stores,
        # the 1-4 MiB ones through the HTTP upload path
        grown = json.loads(operations.http_request(
            "GET", f"{master.url}/vol/grow?collection=serve&count=2"
        ).body)["volumeIds"]
        holders = {vid: next(vs for vs in servers if vs.store.has_volume(vid))
                   for vid in grown}
        n_small = small_bytes // 1024
        small = rng.bytes(n_small * 1024)
        cookies = rng.integers(1, 1 << 32, n_small)
        want = {}
        t0 = time.perf_counter()
        for i in range(n_small):
            vid = grown[i % len(grown)]
            data = small[i * 1024:(i + 1) * 1024]
            holders[vid].store.write_needle(vid, Needle(
                id=SERVE_KEY0 + i, cookie=int(cookies[i]), data=data))
            want[format_fid(vid, SERVE_KEY0 + i, int(cookies[i]))] = data
        write_s = time.perf_counter() - t0
        # the master's sequencer passes the written keys when a heartbeat
        # collected after the last write reports its max key: an assign
        # before that could hand out a written key
        wait_until(lambda: master.topo.sequence.peek >=
                   SERVE_KEY0 + n_small, 30,
                   "the sequencer past the written keys")
        large = {}
        for i in range(SERVE_LARGE):
            data = rng.bytes(int(rng.integers(1 << 20, (4 << 20) + 1)))
            large[operations.upload(master.url, data,
                                    collection="serve")] = data
        want.update(large)
        vids = sorted({parse_fid(f).volume_id for f in want})
        if vids != sorted(grown):
            raise AssertionError(f"needles in {vids}, grown {grown}")
        out["data"] = dict(small=n_small, large=len(large),
                           bytes=sum(len(d) for d in want.values()),
                           write_seconds=write_s, volumes=vids)
        log(f"  (b) {n_small} needles of 1 KiB into volumes {vids} in "
            f"{write_s:.3f} s, {len(large)} of 1-4 MiB over HTTP [{card}]")

        # 1. ec.encode every volume on the card
        for vid in vids:
            holders[vid].store.find_volume(vid).sync()
        sh = Shell(master.url)
        text, enc_s = launches.run(
            "serve_encode", sh.run_command,
            f"ec.encode -collection=serve "
            f"-volumeId={','.join(map(str, vids))}")
        for vid in vids:
            if f"volume {vid}: ec.encode done" not in text:
                raise AssertionError(f"ec.encode:\n{text}")
        wait_until(lambda: all(
            not master.topo.lookup(v) and
            sum(b.count for b in master.topo.lookup_ec(v).values()) == 14
            for v in vids), 60, "the EC layout settled")
        out["encode"] = dict(seconds=enc_s,
                             launches=launches.per_phase["serve_encode"])
        log(f"  (b1) ec.encode of {vids}: {enc_s:.3f} s, "
            f"{launches.per_phase['serve_encode']} gf_linear launches "
            f"[{card}]")

        # 2. a server holding at most 4 shards of each volume stopped
        ecvs = {v: next(x.store.find_ec_volume(v) for x in servers
                        if x.store.find_ec_volume(v) is not None)
                for v in vids}
        shards_of = {}   # fid -> the shard ids its intervals lie on
        pool = list(large) + [f for f in want if f not in large][:8192]
        for fid in pool:
            f = parse_fid(fid)
            ecv = ecvs[f.volume_id]
            shards_of[fid] = {iv.to_shard_and_offset(
                ecv.large_block, ecv.small_block)[0]
                for iv in ecv.locate_needle(f.key)[2]}

        def on_shards(vs, fids):
            return [f for f in fids
                    if shards_of[f] & held(vs, parse_fid(f).volume_id)]

        candidates = [vs for vs in servers
                      if all(len(held(vs, v)) <= 4 for v in vids)]
        if not candidates:
            raise AssertionError("no server holds at most 4 shards of "
                                 "every volume")
        lost_fids = {vs.url: on_shards(vs, pool) for vs in candidates}
        victim = max(candidates, key=lambda vs: len(lost_fids[vs.url]))
        degraded = lost_fids[victim.url]
        if not degraded:
            raise AssertionError("no needle lies on the victim's shards")
        victim_shards = {v: sorted(held(victim, v)) for v in vids}
        victim_dir = victim.store.locations[0].directory
        victim.stop()
        servers.remove(victim)
        stopped.append(victim)
        wait_until(lambda: topo_has(vs.url for vs in servers), 60,
                   "the master dropping the stopped server")
        live = [vs.url for vs in servers]

        # 3. 1,024 GETs of needles on its shards, 16 keep-alive conns
        big = [f for f in degraded if f in large]
        picks = (big + [f for f in degraded if f not in large])
        picks = [picks[i % len(picks)] for i in range(SERVE_DEGRADED_READS)]
        jobs = [[] for _ in range(SERVE_DEGRADED_CONNS)]
        for i, fid in enumerate(picks):
            jobs[i % SERVE_DEGRADED_CONNS].append(fid)
        conn_jobs = []
        for k, fids in enumerate(jobs):
            port = int(live[k % len(live)].split(":")[1])
            conn_jobs.append([(port, get_request(f), 200, want[f])
                              for f in fids])
        d0 = sum(vs.degraded.dispatches for vs in servers)
        r, secs = launches.run("serve_degraded_reads", keepalive_pump,
                               conn_jobs)
        dispatches = sum(vs.degraded.dispatches for vs in servers) - d0
        if r["errors"] or r["reqs"] != SERVE_DEGRADED_READS:
            raise AssertionError(f"degraded reads: {r['reqs']} answered, "
                                 f"{r['errors']} bad: {r['first_errors']}")
        if not dispatches:
            raise AssertionError("degraded reads: no decode dispatch")
        out["degraded_reads"] = dict(
            r, dispatches=dispatches, distinct=len(set(picks)),
            large=len(big), victim_shards=victim_shards,
            launches=launches.per_phase["serve_degraded_reads"])
        log(f"  (b3) {victim.url} stopped (shards "
            f"{out['degraded_reads']['victim_shards']}); "
            f"{r['reqs']} GETs of {len(set(picks))} needles on its shards "
            f"({len(big)} of 1-4 MiB) from {SERVE_DEGRADED_CONNS} "
            f"keep-alive connections through the async core: "
            f"p50 {r['p50_ms']:.3f} ms, p99 {r['p99_ms']:.3f} ms, "
            f"{r['rps']:.1f} req/s, bytes equal; {dispatches} decode fleet "
            f"dispatches, {launches.per_phase['serve_degraded_reads']} "
            f"gf_linear launches [{card}]")

        # 4. 256 idle keep-alive connections against a budget of 64
        import socket
        target = servers[0]
        tport = int(target.url.split(":")[1])
        shed_idle = ServeShedCounter.labels("volume", "keepalive")
        sample = degraded[:64]

        def idle_flood():
            before = shed_idle.value
            idle, answered = [], 0
            for i in range(SERVE_IDLE_CONNS):
                s = socket.create_connection(("127.0.0.1", tport),
                                             timeout=30)
                idle.append(s)
                if i % 32 == 31:
                    # reads keep answering meanwhile, on connections of
                    # their own
                    fid = sample[(i // 32) % len(sample)]
                    body = raw_get(target.url, fid).partition(
                        b"\r\n\r\n")[2]
                    if body != want[fid]:
                        raise AssertionError(f"{fid} during the flood")
                    answered += 1
            wait_until(lambda: shed_idle.value - before >=
                       SERVE_IDLE_CONNS - SERVE_KEEPALIVE_BUDGET, 30,
                       "the keep-alive budget's closes")
            closed = shed_idle.value - before
            for s in idle:
                s.close()
            return closed, answered

        (closed, answered), idle_s = launches.run("serve_keepalive",
                                                  idle_flood, maybe=True)
        out["keepalive"] = dict(connections=SERVE_IDLE_CONNS,
                                budget=SERVE_KEEPALIVE_BUDGET,
                                lru_closes=closed, reads=answered,
                                seconds=idle_s)
        log(f"  (b4) {SERVE_IDLE_CONNS} idle keep-alive connections to "
            f"{target.url} (budget {SERVE_KEEPALIVE_BUDGET}): {closed:.0f} "
            f"closed LRU, {answered} reads answered meanwhile [{card}]")

        # 5. the victim back with -serve.maxConns 64 and QoS at two
        # tenants: a hog past its share is shed at frame time
        qos.configure(qos.QosConfig(weights={"good": 4.0, "hog": 1.0}))
        back = volume_server(victim_dir, int(victim.url.split(":")[1]),
                             ServeConfig(async_mode=True,
                                         max_conns=SERVE_QOS_MAX_CONNS,
                                         keepalive_budget=
                                         SERVE_KEEPALIVE_BUDGET))
        back.start()
        servers.append(back)
        stopped.remove(victim)
        wait_until(lambda: topo_has(vs.url for vs in servers) and all(
            sum(b.count for b in master.topo.lookup_ec(v).values()) == 14
            for v in vids), 60, "the server back with its shards")
        bport = int(back.url.split(":")[1])
        shed_qos = ServeShedCounter.labels("volume", "qos")
        # 1 KiB needles whose intervals lie on the returned server's shards
        mine = [f for f in on_shards(back, pool)
                if f not in large][:SERVE_HOG_CONNS]

        def tenant_jobs(name, fids):
            hdr = f"X-Seaweed-Tenant: {name}\r\n"
            return [(bport, get_request(f, hdr), 200, want[f])
                    for f in fids]

        def frame_shed():
            before = shed_qos.value

            def ask(socks, name):
                for i, sk in enumerate(socks):
                    sk.sendall(tenant_jobs(name, [mine[i % len(mine)]])[0][1])
                return [read_reply(sk) for sk in socks]

            def dial(n):
                return [socket.create_connection(("127.0.0.1", bport),
                                                 timeout=30)
                        for _ in range(n)]

            hog = dial(SERVE_HOG_CONNS)
            good = dial(SERVE_GOOD_CONNS)
            try:
                first = ask(hog, "hog")       # under the high water: 200
                good1 = ask(good, "good")     # good holds its connections
                replies = ask(hog, "hog")     # the hog asks again
                good2 = ask(good, "good")
            finally:
                for sk in hog + good:
                    sk.close()
            return first, replies, good1 + good2, shed_qos.value - before

        (first, replies, goods, shed_n), qos_s = launches.run(
            "serve_qos", frame_shed, maybe=True)
        mgr = qos.manager()
        stub = FastHandler.__new__(FastHandler)
        stub.wfile = io.BytesIO()
        stub.command, stub.close_connection = "GET", False
        mgr.shed_reply(stub, "volume", "hog", 1.0, "conns")
        import re
        expect = re.sub(rb"\r\nDate: [^\r]*", b"", stub.wfile.getvalue(),
                        count=1)
        shed = [b for b in replies if b.startswith(b"HTTP/1.1 429")]

        def ok(b, i):
            return b.startswith(b"HTTP/1.1 200 ") and \
                b.endswith(want[mine[i % len(mine)]])

        bad = [b[:200] for i, b in enumerate(replies)
               if not b.startswith(b"HTTP/1.1 429") and not ok(b, i)]
        bad += [b[:200] for i, b in enumerate(first) if not ok(b, i)]
        bad += [b[:200] for i, b in enumerate(goods)
                if not ok(b, i % SERVE_GOOD_CONNS)]
        if bad or not shed or shed_n != len(shed) or any(
                re.sub(rb"\r\nDate: [^\r]*", b"", b, count=1) != expect
                for b in shed):
            raise AssertionError(f"frame-time shed: {len(shed)} 429s, "
                                 f"counter {shed_n}, wrong replies {bad}, "
                                 f"first {shed[:1]!r}, want {expect!r}")
        out["qos"] = dict(hog_conns=SERVE_HOG_CONNS, hog_shed=len(shed),
                          hog_admitted=len(replies) - len(shed),
                          shed_counter=shed_n, good_gets=len(goods),
                          seconds=qos_s)
        log(f"  (b5) {back.url} back with -serve.maxConns "
            f"{SERVE_QOS_MAX_CONNS}, QoS good:4 hog:1: the hog's second "
            f"GETs on {SERVE_HOG_CONNS} connections: {len(shed)} shed at "
            f"frame time (429, the admission seam's bytes; "
            f"ServeShedCounter qos +{shed_n:.0f}), "
            f"{len(replies) - len(shed)} admitted; good's {len(goods)} "
            f"GETs on {SERVE_GOOD_CONNS} held connections all 200 [{card}]")
        qos.reset()

        # 6. every kind of GET: the async bytes against a threaded
        # server's over a copy of the same volume files
        plain = rng.bytes(300000)
        text = rng.bytes(4000).hex().encode()
        chunked = rng.bytes((5 << 20) // 2)
        kinds = {"plain": operations.upload(master.url, plain,
                                            filename="p.bin",
                                            collection="kinds")}
        a = operations.assign(master.url, collection="kinds")
        r = operations.http_request(
            "POST", f"{a.url}/{a.fid}", gzip.compress(text, mtime=0),
            headers={"Content-Type": "text/plain",
                     "Content-Encoding": "gzip"})
        if r.status != 201:
            raise AssertionError(f"gzip upload: http {r.status}")
        kinds["gzip"] = a.fid
        kinds["manifest"] = operations.submit(
            master.url, chunked, filename="big.bin", mime="application/x-big",
            max_mb=1, collection="kinds")

        def kinds_compare():
            from seaweedfs_tpu_torch.operation.chunked_file import \
                load_chunk_manifest
            nonlocal copy_vs
            holder = {k: next(vs for vs in servers if vs.store.has_volume(
                parse_fid(f).volume_id)) for k, f in kinds.items()}
            cm = load_chunk_manifest(raw_get(
                holder["manifest"].url, kinds["manifest"] + "?cm=false"
            ).partition(b"\r\n\r\n")[2])
            vids_k = {parse_fid(f).volume_id for f in kinds.values()} | \
                {parse_fid(c.fid).volume_id for c in cm.chunks}
            copy_dir = os.path.join(workdir, "threaded_copy")
            os.makedirs(copy_dir)
            for vs in servers:
                d = vs.store.locations[0].directory
                for name in os.listdir(d):
                    base, ext = os.path.splitext(name)
                    if ext in (".dat", ".idx", ".vif") and \
                            int(base.rsplit("_", 1)[-1]) in vids_k:
                        vs.store.find_volume(
                            int(base.rsplit("_", 1)[-1])).sync()
                        shutil.copy(os.path.join(d, name), copy_dir)
            copy_vs = volume_server(copy_dir, free_port_pair(),
                                    ServeConfig())
            copy_vs.start()
            wait_until(lambda: copy_vs.url in
                       {n.url for n in master.topo.nodes()}, 60,
                       "the threaded copy registered")
            pfid = kinds["plain"]
            etag = http_client.request(
                "GET", f"{holder['plain'].url}/{pfid}").header("etag")
            missing = format_fid(parse_fid(pfid).volume_id,
                                 parse_fid(pfid).key + 999,
                                 parse_fid(pfid).cookie)
            variants = {
                "plain": (pfid, ""),
                "range": (pfid, "Range: bytes=1000-200999\r\n"),
                "if_none_match": (pfid, f"If-None-Match: {etag}\r\n"),
                "gzip_accepted": (kinds["gzip"],
                                  "Accept-Encoding: gzip\r\n"),
                "gzip_not_accepted": (kinds["gzip"], ""),
                "chunk_manifest": (kinds["manifest"], ""),
                "missing": (missing, ""),
                "cookie_mismatch": (pfid[:-8] + "deadbeef", ""),
            }
            sent0 = ServeSendfileBytesCounter.labels("volume").value
            got = {}
            for name, (fid, extra) in variants.items():
                kind = "manifest" if name == "chunk_manifest" else \
                    "gzip" if name.startswith("gzip") else "plain"
                a_bytes = raw_get(holder[kind].url, fid, extra)
                t_bytes = raw_get(copy_vs.url, fid, extra)
                if a_bytes != t_bytes:
                    raise AssertionError(f"{name}: async {a_bytes[:300]!r}"
                                         f" != threaded {t_bytes[:300]!r}")
                got[name] = a_bytes
            sent = ServeSendfileBytesCounter.labels("volume").value - sent0
            checks = {
                "plain": got["plain"].endswith(plain),
                "range": got["range"].startswith(b"HTTP/1.1 206") and
                got["range"].endswith(plain[1000:201000]),
                "if_none_match": got["if_none_match"].startswith(
                    b"HTTP/1.1 304"),
                "gzip_accepted": b"Content-Encoding: gzip" in
                got["gzip_accepted"],
                "gzip_not_accepted": got["gzip_not_accepted"].endswith(text),
                "chunk_manifest": got["chunk_manifest"].endswith(chunked),
                "missing": got["missing"].startswith(b"HTTP/1.1 404"),
                "cookie_mismatch": got["cookie_mismatch"].startswith(
                    b"HTTP/1.1 404"),
                "sendfile": sent >= len(plain) + 200000,
            }
            if not all(checks.values()):
                raise AssertionError(f"GET kinds: {checks}")
            return sorted(variants), sent

        (names, sent), kinds_s = launches.run("serve_kinds", kinds_compare,
                                              none=True)
        out["kinds"] = dict(variants=names, sendfile_bytes=sent,
                            seconds=kinds_s)
        log(f"  (b6) async GET bytes == a threaded server's over a copy of "
            f"the same volume files, Date aside, for {', '.join(names)}; "
            f"{sent:.0f} B through sendfile [{card}]")
    finally:
        qos.reset()
        if copy_vs is not None:
            copy_vs.stop()
        for vs in servers:
            vs.stop()
        master.stop()
        http_client.close_all()
        rpc.close_channels()
    out["seconds"] = time.perf_counter() - t_phase
    out["launches"] = dict(launches.per_phase)
    return out


# --- phase 14 -----------------------------------------------------------------

# The filer over EC on the card: one master and four volume servers
# (placement 000, volumes of 64 MiB) and a filer on the JAX default store
# (sqlite) with -maxMB 4 and collection "filer", all in this process. The
# namespace is a tree of FILER_SMALL_FILES files of 1-64 KiB in
# FILER_DIRS directories (the small-file mix of upstream `weed benchmark
# -size 1024`-style ingest through `weed filer`) plus phase 11's twelve
# files of 1 KiB-40 MiB, written with `filer.copy`.
FILER_VOLUME_MB = 64
FILER_MAX_MB = 4
FILER_SMALL_FILES = 2048
FILER_DIRS = 64
FILER_SMALL_MAX = 64 << 10
FILER_SAMPLE = 1024
FILER_RANGES = 64
FILER_FSCK_NEEDLES = 16
FILER_FSCK_CUTOFF_S = 1
FILER_ENCRYPTED_FILES = 4
FILER_KEEPERS = 32


def filer_get(url: str, path: str, headers=None):
    from seaweedfs_tpu_torch.operation import operations
    return operations.http_request("GET", f"{url}{path}", headers=headers)


def read_filer(url: str, jobs, datas, threads: int = SERVICE_THREADS
               ) -> list:
    """GET every (path, start, length) job (length None: the whole file)
    through the filer at ``url`` from ``threads`` threads; every byte
    must equal the file's. Returns the latencies."""
    def worker(part):
        lat = []
        for path, start, length in part:
            headers = None if length is None else \
                {"Range": f"bytes={start}-{start + length - 1}"}
            t0 = time.perf_counter()
            r = filer_get(url, path, headers)
            lat.append(time.perf_counter() - t0)
            data = datas[path]
            want = data if length is None else data[start:start + length]
            if r.status != (200 if length is None else 206) or \
                    hashlib.sha256(r.body).digest() != \
                    hashlib.sha256(want).digest():
                raise AssertionError(
                    f"{path} [{start}, +{length}] through the filer: http "
                    f"{r.status}, {len(r.body)} B, want {len(want)} B "
                    f"{r.body[:200]!r}")
        return lat

    with concurrent.futures.ThreadPoolExecutor(threads) as pool:
        parts = list(pool.map(worker, [jobs[i::threads]
                                       for i in range(threads)]))
    return [t for p in parts for t in p]


def needle_count(servers) -> int:
    return sum(v.file_count for vs in servers
               for loc in vs.store.locations
               for v in list(loc.volumes.values()))


def live_needles_of(directory: str, collection: str, vid: int) -> dict:
    """{key: data} of every live needle of a volume's files."""
    from seaweedfs_tpu_torch.storage.needle import Needle
    from seaweedfs_tpu_torch.storage.volume import Volume
    v = Volume(directory, collection, vid, create_if_missing=False,
               async_write=False)
    try:
        return {k: v.read_needle(Needle(id=k)).data
                for k in sorted(v.nm.keys())}
    finally:
        v.close()


# --- phase 15 -----------------------------------------------------------------

# The filer's gateways on phase 14's cluster: an S3 gateway with an Admin
# identity and one that may only Read the bucket, a WebDAV gateway and an
# FTP gateway, all in this process on phase 14's filer (collection
# "filer", so that 14 (b) encodes what they write). The S3 mix is this
# script's own: small objects of 1-64 KiB (uniform, as phase 14's POSTs),
# plus one 40 MiB multipart upload in 5 MiB parts (the S3 minimum part
# size and the aws CLI's default chunk).
GW_BUCKET = "gwbkt"
GW_OBJECTS = 512
GW_OBJECT_MAX = 64 << 10
GW_PART = 5 << 20
GW_PARTS = 8
GW_COPY_PART = 3                 # the part that is an UploadPartCopy
GW_RANGES = 64
GW_LIST_PAGE = 100
GW_DAV_FILES = 8
GW_DAV_BIG = 16 << 20
GW_FTP_FILES = 4
GW_FTP_MAX = 4 << 20
GW_TIER_NEEDLES = 256
GW_ADMIN = ("GWADMIN", "gw-admin-secret")
GW_READER = ("GWREADER", "gw-reader-secret")


def s3_multipart(client, bucket: str, key: str, parts) -> str:
    """Initiate, upload each part (bytes, or ("copy", src key, first,
    last) for an UploadPartCopy with a range), complete; the ETag."""
    import re
    _, _, body = client._request("POST", f"/{bucket}/{key}",
                                 query=[("uploads", "")])
    uid = re.search(rb"<UploadId>([^<]+)<", body).group(1).decode()
    for n, part in enumerate(parts, 1):
        q = [("partNumber", str(n)), ("uploadId", uid)]
        if isinstance(part, tuple):
            _, src, first, last = part
            _, _, body = client._request(
                "PUT", f"/{bucket}/{key}", query=q, headers={
                    "x-amz-copy-source": f"/{bucket}/{src}",
                    "x-amz-copy-source-range": f"bytes={first}-{last}"})
            if b"CopyPartResult" not in body:
                raise AssertionError(f"UploadPartCopy: {body[:300]!r}")
        else:
            client._request("PUT", f"/{bucket}/{key}", query=q,
                            payload=part)
    manifest = ("<CompleteMultipartUpload>" + "".join(
        f"<Part><PartNumber>{n}</PartNumber></Part>"
        for n in range(1, len(parts) + 1)) +
        "</CompleteMultipartUpload>").encode()
    _, _, body = client._request("POST", f"/{bucket}/{key}",
                                 query=[("uploadId", uid)], payload=manifest)
    m = re.search(rb"<ETag>([^<]+)<", body)
    if m is None:
        raise AssertionError(f"CompleteMultipartUpload: {body[:300]!r}")
    return m.group(1).decode().strip('"')


def pct_ms(lat) -> dict:
    return dict(n=len(lat), p50_ms=float(np.percentile(lat, 50) * 1e3),
                p99_ms=float(np.percentile(lat, 99) * 1e3))


def timed_pool(fn, jobs, threads: int) -> tuple:
    """fn(job) over jobs from ``threads`` threads: (results, latencies,
    seconds)."""
    def one(job):
        t0 = time.perf_counter()
        r = fn(job)
        return r, time.perf_counter() - t0

    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(threads) as pool:
        got = list(pool.map(one, jobs))
    return [r for r, _ in got], [t for _, t in got], \
        time.perf_counter() - t0


class Gateways:
    """Phase 15's gateways on phase 14's filer, and what they wrote."""

    def __init__(self, master, filer, rng, objects: int = GW_OBJECTS,
                 part: int = GW_PART, dav_big: int = GW_DAV_BIG,
                 ftp_max: int = GW_FTP_MAX):
        from seaweedfs_tpu_torch.ftpd import FtpServer
        from seaweedfs_tpu_torch.s3api import S3ApiServer
        from seaweedfs_tpu_torch.s3api.auth import (Credential, Iam,
                                                    Identity)
        from seaweedfs_tpu_torch.server.webdav import WebDavServer
        self.master, self.filer, self.rng = master, filer, rng
        self.objects, self.part = objects, part
        self.dav_big, self.ftp_max = dav_big, ftp_max
        iam = Iam([Identity("admin", [Credential(*GW_ADMIN)], ["Admin"]),
                   Identity("reader", [Credential(*GW_READER)],
                            [f"Read:{GW_BUCKET}"])])
        self.started = []
        # each binds before the next port is picked
        for attr, make in (
                ("s3", lambda p: S3ApiServer(filer.url, port=p, iam=iam)),
                ("dav", lambda p: WebDavServer(filer.url, port=p)),
                ("ftp", lambda p: FtpServer(filer.url, port=p))):
            server = make(free_port_pair())
            server.start()
            setattr(self, attr, server)
            self.started.append(server)
        self.s3_objects = {}     # key -> bytes
        self.mp_key = "big/multipart.bin"
        self.mp_data = b""
        self.dav_files = {}      # path -> bytes
        self.ftp_files = {}      # path -> bytes

    def stop(self):
        for s in reversed(self.started):
            s.stop()

    def client(self, who=GW_ADMIN):
        from seaweedfs_tpu_torch.util.s3_client import S3Client
        return S3Client(self.s3.url, *who)


def gateways_write(gw: Gateways, sh, servers, launches, card: str,
                   out: dict) -> None:
    """Phase 15 (a): the bucket by shell, 512 SigV4 PUTs from 16 threads,
    the multipart object, ListObjectsV2 pages, the Read identity's 403;
    WebDAV PUTs and a PROPFIND; FTP STORs; the s3 tier of a volume of
    collection ``tier`` to this gateway and back."""
    import ftplib
    import io
    import re
    import urllib.request

    from seaweedfs_tpu_torch.operation import operations
    from seaweedfs_tpu_torch.storage import backend as bk
    from seaweedfs_tpu_torch.util.s3_client import S3Error

    rng = gw.rng
    res = {}

    def s3_ingest():
        text = sh.run_command(f"s3.bucket.create -name {GW_BUCKET}")
        if f"created bucket {GW_BUCKET}" not in text:
            raise AssertionError(f"s3.bucket.create: {text}")
        pool_bytes = rng.bytes(4 << 20)
        for i in range(gw.objects):
            size = int(rng.integers(1024, GW_OBJECT_MAX + 1))
            off = int(rng.integers(0, len(pool_bytes) - size))
            gw.s3_objects[f"small/d{i % 16:02d}/o{i:04d}.bin"] = \
                pool_bytes[off:off + size]
        c = gw.client()
        etags = {}

        def put(item):
            key, data = item
            etags[key] = c.put_object(GW_BUCKET, key, data)

        items = sorted(gw.s3_objects.items())
        _, lat, secs = timed_pool(put, items, SERVICE_THREADS)
        small_bytes = sum(len(d) for d in gw.s3_objects.values())
        # the multipart object: GW_PARTS parts, one an UploadPartCopy of a
        # range of a source object
        src = rng.bytes(gw.part + 4096)
        c.put_object(GW_BUCKET, "big/partsrc.bin", src)
        parts, want = [], []
        for n in range(GW_PARTS):
            if n == GW_COPY_PART:
                parts.append(("copy", "big/partsrc.bin", 1000,
                              1000 + gw.part - 1))
                want.append(src[1000:1000 + gw.part])
            else:
                data = rng.bytes(gw.part)
                parts.append(data)
                want.append(data)
        gw.mp_data = b"".join(want)
        t0 = time.perf_counter()
        etag = s3_multipart(c, GW_BUCKET, gw.mp_key, parts)
        mp_secs = time.perf_counter() - t0
        head = c.head_object(GW_BUCKET, gw.mp_key)
        if head["ETag"].strip('"') != etag or \
                int(head["Content-Length"]) != len(gw.mp_data):
            raise AssertionError(f"multipart HEAD: {head}")
        t0 = time.perf_counter()
        listed = list(c.list_objects(GW_BUCKET, max_keys=GW_LIST_PAGE))
        list_secs = time.perf_counter() - t0
        want_keys = sorted(list(gw.s3_objects) +
                           [gw.mp_key, "big/partsrc.bin"])
        if [o["key"] for o in listed] != want_keys or \
                any(o["etag"] != etags[o["key"]] for o in listed
                    if o["key"] in etags):
            raise AssertionError(f"ListObjectsV2: {len(listed)} keys")
        try:
            gw.client(GW_READER).put_object(GW_BUCKET, "denied.bin", b"x")
            raise AssertionError("the Read identity's PUT was accepted")
        except S3Error as e:
            if e.status != 403 or "AccessDenied" not in e.body:
                raise
        return dict(objects=len(items), bytes=small_bytes, seconds=secs,
                    MBps=small_bytes / secs / 1e6,
                    objects_per_s=len(items) / secs, **pct_ms(lat),
                    multipart_bytes=len(gw.mp_data),
                    multipart_seconds=mp_secs,
                    multipart_MBps=len(gw.mp_data) / mp_secs / 1e6,
                    multipart_etag=etag, list_pages=-(-len(listed) //
                                                      GW_LIST_PAGE),
                    list_seconds=list_secs, read_only_put=403)

    res["s3"], _ = launches.run("gateway_s3_ingest", s3_ingest, none=True)

    def dav_ingest():
        base = f"http://{gw.dav.url}"
        req = urllib.request.Request(f"{base}/dav", method="MKCOL")
        urllib.request.urlopen(req, timeout=60).close()
        for i in range(GW_DAV_FILES):
            gw.dav_files[f"/dav/f{i}.bin"] = rng.bytes(
                int(rng.integers(1024, GW_OBJECT_MAX + 1)))
        gw.dav_files["/dav/big.bin"] = rng.bytes(gw.dav_big)

        def put(item):
            path, data = item
            req = urllib.request.Request(base + path, data=data,
                                         method="PUT")
            with urllib.request.urlopen(req, timeout=120) as r:
                if r.status != 201:
                    raise AssertionError(f"WebDAV PUT {path}: {r.status}")

        _, lat, secs = timed_pool(put, sorted(gw.dav_files.items()), 4)
        req = urllib.request.Request(f"{base}/dav", method="PROPFIND",
                                     headers={"Depth": "1"})
        with urllib.request.urlopen(req, timeout=60) as r:
            body = r.read()
            if r.status != 207:
                raise AssertionError(f"PROPFIND: {r.status}")
        sizes = sorted(int(x) for x in re.findall(
            rb"getcontentlength>(\d+)<", body))
        if sizes != sorted(len(d) for d in gw.dav_files.values()):
            raise AssertionError(f"PROPFIND sizes {sizes}")
        total = sum(len(d) for d in gw.dav_files.values())
        return dict(files=len(gw.dav_files), bytes=total, seconds=secs,
                    MBps=total / secs / 1e6,
                    files_per_s=len(gw.dav_files) / secs, **pct_ms(lat),
                    propfind_entries=len(sizes))

    res["webdav"], _ = launches.run("gateway_webdav_ingest", dav_ingest,
                                    none=True)

    def ftp_ingest():
        ftp = ftplib.FTP()
        ftp.connect(gw.ftp.ip, gw.ftp.port, timeout=60)
        ftp.login("smoke", "smoke")
        lat = []
        t0 = time.perf_counter()
        for i in range(GW_FTP_FILES):
            path = f"/ftp/f{i}.bin"
            gw.ftp_files[path] = rng.bytes(int(rng.integers(
                gw.ftp_max // 4, gw.ftp_max + 1)))
            t1 = time.perf_counter()
            ftp.storbinary(f"STOR {path}", io.BytesIO(gw.ftp_files[path]))
            lat.append(time.perf_counter() - t1)
        secs = time.perf_counter() - t0
        names = sorted(ftp.nlst("/ftp"))
        ftp.quit()
        if names != sorted(p.rsplit("/", 1)[1] for p in gw.ftp_files):
            raise AssertionError(f"FTP NLST: {names}")
        total = sum(len(d) for d in gw.ftp_files.values())
        return dict(files=len(gw.ftp_files), bytes=total, seconds=secs,
                    MBps=total / secs / 1e6,
                    files_per_s=len(gw.ftp_files) / secs, **pct_ms(lat))

    res["ftp"], _ = launches.run("gateway_ftp_ingest", ftp_ingest,
                                 none=True)

    def tier():
        c = gw.client()
        c.create_bucket("tier")
        bk.load_configuration({"s3.default": {
            "endpoint": gw.s3.url, "bucket": "tier",
            "access_key": GW_ADMIN[0], "secret_key": GW_ADMIN[1]}})
        a = operations.assign(gw.master.url, collection="tier")
        vid = int(a.fid.split(",")[0])
        holder = next(vs for vs in servers
                      if vs.store.find_volume(vid) is not None)
        blobs = {}
        for i in range(GW_TIER_NEEDLES):
            fid = f"{vid},{SERVE_KEY0 + i:x}{0x7135:08x}"
            blobs[fid] = rng.bytes(int(rng.integers(1024,
                                                    GW_OBJECT_MAX + 1)))
            operations.upload_data(f"{holder.url}/{fid}", blobs[fid])
        v = holder.store.find_volume(vid)
        v.sync()
        want = sha256_file(v.dat_path)
        size = os.path.getsize(v.dat_path)
        t0 = time.perf_counter()
        text = sh.run_command(f"volume.tier.upload -volumeId={vid} "
                              "-dest=s3.default")
        up = time.perf_counter() - t0
        if not v.is_remote or os.path.exists(v.dat_path):
            raise AssertionError(f"volume.tier.upload:\n{text}")
        listed = [o["key"] for o in c.list_objects("tier")]
        if len(listed) != 1:
            raise AssertionError(f"the tier bucket holds {listed}")
        for fid in list(blobs)[:16]:
            r = filer_get(holder.url, f"/{fid}")
            if r.status != 200 or r.body != blobs[fid]:
                raise AssertionError(f"{fid} through the s3 tier: "
                                     f"{r.status}")
        t0 = time.perf_counter()
        text = sh.run_command(f"volume.tier.download -volumeId={vid}")
        down = time.perf_counter() - t0
        if v.is_remote or sha256_file(v.dat_path) != want:
            raise AssertionError(f"volume.tier.download:\n{text}")
        # the tier's needles are no file of the filer: volume.fsck in
        # 14 (e) would count them as orphans
        sh.run_command("collection.delete -collection tier")
        return dict(volume=vid, dat_bytes=size, upload_seconds=up,
                    upload_MBps=size / up / 1e6, download_seconds=down,
                    download_MBps=size / down / 1e6, sha256_equal=True,
                    object=listed[0])

    res["tier"], _ = launches.run("gateway_tier", tier, none=True)
    out["gateways_write"] = res
    s, d, f, t = res["s3"], res["webdav"], res["ftp"], res["tier"]
    log(f"  15 (a) S3 (SigV4, {SERVICE_THREADS} threads): {s['objects']} "
        f"objects of 1-64 KiB ({s['bytes']} B) in {s['seconds']:.3f} s = "
        f"{s['objects_per_s']:.1f} objects/s, {s['MBps']:.1f} MB/s "
        f"(p50 {s['p50_ms']:.2f} ms, p99 {s['p99_ms']:.2f} ms); "
        f"multipart {s['multipart_bytes']} B in {GW_PARTS} parts (one an "
        f"UploadPartCopy of a range) {s['multipart_seconds']:.3f} s = "
        f"{s['multipart_MBps']:.1f} MB/s; ListObjectsV2 in "
        f"{s['list_pages']} pages of {GW_LIST_PAGE} {s['list_seconds']:.3f}"
        f" s; the Read identity's PUT 403 [{card}]")
    log(f"  15 (a) WebDAV: {d['files']} files ({d['bytes']} B) in "
        f"{d['seconds']:.3f} s = {d['files_per_s']:.1f} files/s, "
        f"{d['MBps']:.1f} MB/s, PROPFIND of {d['propfind_entries']} files;"
        f" FTP: {f['files']} STORs ({f['bytes']} B) in {f['seconds']:.3f} "
        f"s = {f['MBps']:.1f} MB/s [{card}]")
    log(f"  15 (a) s3 tier: volume {t['volume']} ({t['dat_bytes']} B of "
        f".dat) volume.tier.upload -dest s3.default "
        f"{t['upload_seconds']:.3f} s = {t['upload_MBps']:.1f} MB/s, "
        f".download {t['download_seconds']:.3f} s = "
        f"{t['download_MBps']:.1f} MB/s, .dat sha256 equal [{card}]")


def gateways_read(gw: Gateways, filers, servers, launches, card: str,
                  out: dict) -> None:
    """Phase 15 (b), with phase 14 (d)'s server still stopped and the
    filers' chunk caches emptied: every byte through each gateway."""
    import ftplib
    import urllib.request

    from seaweedfs_tpu_torch.util import http_client
    from seaweedfs_tpu_torch.util.aws_auth import presigned_target
    from seaweedfs_tpu_torch.util.chunk_cache import TieredChunkCache

    rng = gw.rng
    for f in filers:
        f.chunk_cache = TieredChunkCache()
    res = {}
    size = len(gw.mp_data)
    jobs = [(gw.mp_key, n * gw.part, (n + 1) * gw.part - 1)
            for n in range(GW_PARTS)]
    for _ in range(GW_RANGES):
        edge = int(rng.integers(1, GW_PARTS)) * gw.part
        first = max(0, edge - int(rng.integers(1, 1 << 20)))
        last = min(size - 1, edge + int(rng.integers(0, 1 << 20)))
        jobs.append((gw.mp_key, first, last))
    jobs += [(k, None, None) for k in sorted(gw.s3_objects)]

    def s3_reads():
        c = gw.client()

        def get(job):
            key, first, last = job
            data = gw.mp_data if key == gw.mp_key else gw.s3_objects[key]
            if first is None:
                got, want = c.get_object(GW_BUCKET, key), data
            else:
                got = c.get_object(GW_BUCKET, key, (first, last))
                want = data[first:last + 1]
            if hashlib.sha256(got).digest() != hashlib.sha256(want).digest():
                raise AssertionError(f"S3 GET {key} [{first}, {last}]: "
                                     f"{len(got)} B, want {len(want)} B")

        _, lat, secs = timed_pool(get, jobs, SERVICE_THREADS)
        key = sorted(gw.s3_objects)[0]
        r = http_client.request("GET", gw.s3.url + presigned_target(
            "GET", gw.s3.url, f"/{GW_BUCKET}/{key}", *GW_READER,
            "us-east-1", "s3"), timeout=60)
        if r.status != 200 or r.body != gw.s3_objects[key]:
            raise AssertionError(f"presigned GET: {r.status}")
        return lat, secs

    def dav_reads():
        base = f"http://{gw.dav.url}"

        def get(path):
            with urllib.request.urlopen(base + path, timeout=120) as r:
                if r.read() != gw.dav_files[path]:
                    raise AssertionError(f"WebDAV GET {path}")

        _, lat, secs = timed_pool(get, sorted(gw.dav_files), 4)
        return lat, secs

    def ftp_reads():
        ftp = ftplib.FTP()
        ftp.connect(gw.ftp.ip, gw.ftp.port, timeout=60)
        ftp.login("smoke", "smoke")
        lat = []
        t0 = time.perf_counter()
        for path, data in sorted(gw.ftp_files.items()):
            buf = []
            t1 = time.perf_counter()
            ftp.retrbinary(f"RETR {path}", buf.append)
            lat.append(time.perf_counter() - t1)
            if b"".join(buf) != data:
                raise AssertionError(f"FTP RETR {path}")
        secs = time.perf_counter() - t0
        ftp.quit()
        return lat, secs

    for name, fn, must in (("s3", s3_reads, True),
                           ("webdav", dav_reads, False),
                           ("ftp", ftp_reads, False)):
        d0 = sum(vs.degraded.dispatches for vs in servers)
        (lat, secs), _ = launches.run(f"gateway_{name}_degraded_reads", fn,
                                      maybe=not must)
        dispatches = sum(vs.degraded.dispatches for vs in servers) - d0
        k1 = launches.per_phase[f"gateway_{name}_degraded_reads"]
        res[name] = dict(seconds=secs, dispatches=dispatches, launches=k1,
                         **pct_ms(lat))
    if not res["s3"]["dispatches"] or (launches.backend == "cuda" and
                                       not res["s3"]["launches"]):
        raise AssertionError(f"the S3 reads: {res['s3']}")
    out["gateways_read"] = res
    s, d, f = res["s3"], res["webdav"], res["ftp"]
    log(f"  15 (b) through the gateways with the server stopped, caches "
        f"emptied: S3 {GW_PARTS} part spans, {GW_RANGES} Ranges across "
        f"part boundaries and {len(gw.s3_objects)} objects from "
        f"{SERVICE_THREADS} threads (p50 {s['p50_ms']:.2f} ms, p99 "
        f"{s['p99_ms']:.2f} ms) and a presigned GET: {s['dispatches']} "
        f"decode dispatches, {s['launches']} K1 launches; WebDAV "
        f"{len(gw.dav_files)} GETs (p50 {d['p50_ms']:.2f} ms, p99 "
        f"{d['p99_ms']:.2f} ms): {d['dispatches']} dispatches, "
        f"{d['launches']} K1; FTP {len(gw.ftp_files)} RETRs (p50 "
        f"{f['p50_ms']:.2f} ms, p99 {f['p99_ms']:.2f} ms): "
        f"{f['dispatches']} dispatches, {f['launches']} K1; every byte "
        f"equal [{card}]")


# --- phase 16 -----------------------------------------------------------------

# The networked stores and replication on phase 14's cluster, with 14 (d)'s
# server still stopped. The card's machine runs no redis, so the redis
# filer talks to RESP_STAND_IN: a socket server of this script's own (not
# of the port), counted in no figure as the port's.
SYNC_FILES = 64                  # POSTed into each side of 16 (c)


class RespStandIn:
    """A RESP2 server on a thread that answers what the port's RedisStore
    sends (SET, GET, DEL, SADD, SREM, SMEMBERS, SCAN, AUTH, SELECT, PING)
    from a dict and a dict of sets, with RESP2's reply forms: +OK, :n,
    $n/$-1 bulk strings, *n arrays."""

    def __init__(self):
        import socketserver
        import threading
        self.data, self.sets = {}, {}
        self.commands = 0
        lock = threading.Lock()
        outer = self

        class Handler(socketserver.StreamRequestHandler):
            def handle(self):
                while True:
                    line = self.rfile.readline()
                    if not line:
                        return
                    parts = []
                    for _ in range(int(line[1:])):
                        n = int(self.rfile.readline()[1:])
                        parts.append(self.rfile.read(n + 2)[:-2])
                    with lock:
                        reply = outer.answer(parts)
                    self.wfile.write(reply)

        self._server = socketserver.ThreadingTCPServer(("127.0.0.1", 0),
                                                       Handler)
        self._server.daemon_threads = True
        self.port = self._server.server_address[1]
        self._thread = threading.Thread(target=self._server.serve_forever,
                                        daemon=True)
        self._thread.start()

    @staticmethod
    def _array(items) -> bytes:
        return b"*%d\r\n" % len(items) + b"".join(
            b"$%d\r\n%s\r\n" % (len(x), x) for x in items)

    def answer(self, parts) -> bytes:
        import fnmatch
        self.commands += 1
        cmd = parts[0].upper()
        data, sets = self.data, self.sets
        if cmd in (b"AUTH", b"SELECT", b"PING"):
            return b"+OK\r\n"
        if cmd == b"SET":
            data[parts[1]] = parts[2]
            return b"+OK\r\n"
        if cmd == b"GET":
            v = data.get(parts[1])
            return b"$-1\r\n" if v is None else b"$%d\r\n%s\r\n" % (len(v), v)
        if cmd == b"DEL":
            n = 0
            for k in parts[1:]:
                n += (data.pop(k, None) is not None) + \
                    (sets.pop(k, None) is not None)
            return b":%d\r\n" % n
        if cmd == b"SADD":
            s = sets.setdefault(parts[1], set())
            n = len(s)
            s.update(parts[2:])
            return b":%d\r\n" % (len(s) - n)
        if cmd == b"SREM":
            s = sets.get(parts[1], set())
            n = len(s)
            s.difference_update(parts[2:])
            return b":%d\r\n" % (n - len(s))
        if cmd == b"SMEMBERS":
            return self._array(sorted(sets.get(parts[1], ())))
        if cmd == b"SCAN":       # one pass: cursor 0 ends the scan
            pat = parts[parts.index(b"MATCH") + 1].decode("latin-1") \
                if b"MATCH" in parts else "*"
            keys = [k for k in list(data) + list(sets)
                    if fnmatch.fnmatchcase(k.decode("latin-1"), pat)]
            return b"*2\r\n$1\r\n0\r\n" + self._array(keys)
        return b"-ERR unknown command '%s'\r\n" % cmd

    def stop(self):
        self._server.shutdown()
        self._server.server_close()


def stores_and_replication(master, filer, filers, servers, gw, datas,
                           large_paths, snap: str, workdir: str, chunk: int,
                           launches, card: str, rng, out: dict) -> None:
    """Phase 16, after 14 (f) with 14 (d)'s server still stopped. (a) a
    filer on ``-store redis`` (the RESP stand-in): ``fs.meta.load`` of 14
    (f)'s snapshot, then phase 14's large files read through it with the
    chunk caches emptied (decode dispatches, K1). (b) ``filer.replicate``
    built from a replication.toml by the command's own functions
    (``[source.filer]`` phase 14's filer under phase 15's WebDAV directory,
    ``[sink.filer]`` the redis filer under /replica): every file on the
    sink, checked byte for byte, K1 launched by the 16 MiB file's chunks.
    (c) ``FilerSync`` between phase 14's filer and the redis filer under
    /sync: 64 files POSTed into each side from 16 threads, both sides
    agree on all 128, and each side's log holds exactly 64 creates under
    /sync marked ``is_from_other_cluster`` (nothing echoed back)."""
    from seaweedfs_tpu_torch.command.async_services import (
        load_replication_config, replicator_from_config)
    from seaweedfs_tpu_torch.ops import gf_kernel
    from seaweedfs_tpu_torch.replication.filer_sync import FilerSync
    from seaweedfs_tpu_torch.server.filer import FilerServer
    from seaweedfs_tpu_torch.shell import Shell
    from seaweedfs_tpu_torch.util import http_client
    from seaweedfs_tpu_torch.util.chunk_cache import TieredChunkCache

    res = {}
    t_phase = time.perf_counter()
    resp = RespStandIn()
    try:
        redis_filer = FilerServer(
            master.url, port=free_port_pair(), store="redis",
            store_options={"host": "127.0.0.1", "port": resp.port},
            meta_dir=os.path.join(workdir, "filer_redis"),
            collection="filer", chunk_size=chunk)
        redis_filer.start()
        filers.append(redis_filer)

        # (a) fs.meta.load into the redis filer, the large files through it
        def meta_load():
            t0 = time.perf_counter()
            loaded = Shell(master.url, filer_url=redis_filer.url) \
                .run_command(f"fs.meta.load {snap}")
            return loaded.strip(), time.perf_counter() - t0

        (loaded, load_s), _ = launches.run("stores_redis_meta_load",
                                           meta_load, none=True)
        entries = int(loaded.split()[1]) if loaded.startswith("loaded ") \
            else -1
        for f in filers:
            f.chunk_cache = TieredChunkCache()
        d0 = sum(vs.degraded.dispatches for vs in servers)
        lat, secs = launches.run(
            "stores_redis_degraded_reads", read_filer, redis_filer.url,
            [(p, 0, None) for p in large_paths], datas, threads=4)
        dispatches = sum(vs.degraded.dispatches for vs in servers) - d0
        k1 = launches.per_phase["stores_redis_degraded_reads"]
        if not dispatches or (launches.backend == "cuda" and k1 < 1):
            raise AssertionError(f"16 (a): {dispatches} decode dispatches, "
                                 f"{k1} K1 launches")
        big = sum(len(datas[p]) for p in large_paths)
        res["redis_filer"] = dict(
            entries=entries, load_seconds=load_s,
            entries_per_s=entries / load_s, resp_commands=resp.commands,
            reads=len(lat), bytes=big, read_seconds=secs,
            MBps=big / secs / 1e6, dispatches=dispatches, launches=k1,
            **pct_ms(lat))
        log(f"  16 (a) a filer on redis (this script's RESP stand-in): "
            f"fs.meta.load of {entries} entries in {load_s:.3f} s "
            f"({entries / load_s:.1f} entries/s, {resp.commands} RESP "
            f"commands); the {len(lat)} large files ({big} B) through it "
            f"with the server stopped ({pcts(lat)}), bytes equal; "
            f"{dispatches} decode dispatches, {k1} K1 launches [{card}]")

        # (b) filer.replicate: phase 15's WebDAV directory -> /replica
        conf_dir = os.path.join(workdir, "replicate")
        os.makedirs(conf_dir)
        conf_path = os.path.join(conf_dir, "replication.toml")
        with open(conf_path, "w") as f:
            f.write(f'[source.filer]\nenabled = true\n'
                    f'grpcAddress = "{filer.url}"\ndirectory = "/dav"\n\n'
                    f'[sink.filer]\nenabled = true\n'
                    f'grpcAddress = "{redis_filer.url}"\n'
                    f'directory = "/replica"\n')
        tail, _, directory, kind = replicator_from_config(
            load_replication_config(conf_path))
        source = tail.replicator.source
        per_file = {}
        read = source.read_entry_data

        def counted_read(d, name):
            # the tail replays one event at a time: the launches between
            # these two reads are this file's
            n0 = gf_kernel.LAUNCHES
            data = read(d, name)
            key = f"{d}/{name}"
            per_file[key] = per_file.get(key, 0) + gf_kernel.LAUNCHES - n0
            return data

        source.read_entry_data = counted_read
        want = gw.dav_files
        total = sum(len(d) for d in want.values())

        def replicate():
            for f in filers:
                f.chunk_cache = TieredChunkCache()
            t0 = time.perf_counter()
            tail.start(since_ns=0)
            try:
                def landed():
                    for path, data in want.items():
                        try:
                            e = redis_filer.filer.find_entry(
                                "/replica" + path)
                        except Exception:  # not there yet
                            return False
                        if sum(c.size for c in e.chunks) != len(data):
                            return False
                    return True
                wait_until(landed, 120, "filer.replicate to land every file")
                secs = time.perf_counter() - t0
            finally:
                tail.stop()
            lat = read_filer(redis_filer.url,
                             [("/replica" + p, 0, None) for p in want],
                             {"/replica" + p: d for p, d in want.items()},
                             threads=4)
            return secs, lat

        d0 = sum(vs.degraded.dispatches for vs in servers)
        (rep_s, lat), _ = launches.run("replication_replicate", replicate)
        dispatches = sum(vs.degraded.dispatches for vs in servers) - d0
        k1 = launches.per_phase["replication_replicate"]
        big_k1 = per_file.get("/dav/big.bin", 0)
        if launches.backend == "cuda" and big_k1 < 1:
            raise AssertionError(f"16 (b): the 16 MiB file's reads launched "
                                 f"{big_k1} K1 ({per_file})")
        res["replicate"] = dict(
            files=len(want), bytes=total, seconds=rep_s,
            MBps=total / rep_s / 1e6, dispatches=dispatches, launches=k1,
            big_file_launches=big_k1, sink=kind, directory=directory,
            check_reads=pct_ms(lat))
        log(f"  16 (b) filer.replicate ({directory} -> {kind} sink /replica "
            f"on the redis filer, from replication.toml): {len(want)} files "
            f"({total} B) in {rep_s:.3f} s = {total / rep_s / 1e6:.1f} MB/s "
            f"with the server stopped, bytes equal on the sink; "
            f"{dispatches} decode dispatches, {k1} K1 launches ({big_k1} "
            f"from the 16 MiB file) [{card}]")

        # (c) filer.sync between phase 14's filer and the redis filer
        sides = {"a": filer, "b": redis_filer}
        posts = {}
        pool_bytes = rng.bytes(4 << 20)
        for side in sides:
            for i in range(SYNC_FILES):
                size = int(rng.integers(1024, FILER_SMALL_MAX + 1))
                off = int(rng.integers(0, len(pool_bytes) - size))
                posts[(side, f"/sync/{side}{i:03d}.bin")] = \
                    pool_bytes[off:off + size]
        every = {path: data for (_, path), data in posts.items()}
        sync = FilerSync(filer.url, redis_filer.url, path_prefix="/sync")

        def sync_run():
            sync.start()
            try:
                t0 = time.perf_counter()

                def post(part):
                    for (side, path), data in part:
                        r = http_client.request(
                            "POST", f"{sides[side].url}{path}", body=data)
                        if r.status != 201:
                            raise AssertionError(f"POST {path}: "
                                                 f"{r.status}")

                items = sorted(posts.items())
                with concurrent.futures.ThreadPoolExecutor(
                        SERVICE_THREADS) as pool:
                    list(pool.map(post, [items[i::SERVICE_THREADS]
                                         for i in range(SERVICE_THREADS)]))
                post_s = time.perf_counter() - t0

                want_sizes = {p: len(d) for p, d in every.items()}

                def held():
                    return {side: {f"/sync/{e.name}":
                                   sum(c.size for c in e.chunks)
                                   for e in f.filer.list_entries(
                                       "/sync", limit=1000)}
                            for side, f in sides.items()}

                try:
                    wait_until(lambda: all(h == want_sizes for h in
                                           held().values()), 60,
                               "both filers to hold all 128 files")
                except AssertionError:
                    raise AssertionError(f"16 (c): {held()}") from None
                agree_s = time.perf_counter() - t0
            finally:
                sync.stop()
            for f in sides.values():
                read_filer(f.url, [(p, 0, None) for p in every], every)
            return post_s, agree_s

        (post_s, agree_s), _ = launches.run("replication_sync", sync_run,
                                            maybe=True)
        marked = {}
        for side, f in sides.items():
            recs = [r for r in f.filer.meta_log.read_events_since(0)
                    if r.directory == "/sync" and
                    r.event_notification.new_entry.name and
                    not r.event_notification.old_entry.name]
            other = [r for r in recs
                     if r.event_notification.is_from_other_cluster]
            names = sorted(r.event_notification.new_entry.name
                           for r in other)
            want_names = sorted(p.rsplit("/", 1)[1] for (s, p) in posts
                                if s != side)
            if names != want_names:
                raise AssertionError(
                    f"16 (c) side {side}: {len(names)} creates from the "
                    f"other cluster under /sync, want {SYNC_FILES}")
            marked[side] = len(names)
        res["sync"] = dict(files=len(every), post_seconds=post_s,
                           seconds_to_agree=agree_s, marked=marked,
                           launches=launches.per_phase["replication_sync"])
        log(f"  16 (c) filer.sync /sync between phase 14's filer (sqlite) "
            f"and the redis filer: {SYNC_FILES} files of 1-64 KiB POSTed "
            f"into each from {SERVICE_THREADS} threads in {post_s:.3f} s; "
            f"both hold all {len(every)}, bytes equal, {agree_s:.3f} s "
            f"after the first POST; each log holds exactly {SYNC_FILES} "
            f"creates marked from the other cluster, none echoed; "
            f"{launches.per_phase['replication_sync']} K1 launches [{card}]")
    finally:
        resp.stop()
    res["seconds"] = time.perf_counter() - t_phase
    out["stores_replication"] = res
    log(f"  phase 16 took {res['seconds']:.3f} s [{card}]")


def phase_filer(workdir: str, seed: int, backend: str, card: str = "",
                small_files: int = FILER_SMALL_FILES,
                sizes=None, sample: int = FILER_SAMPLE,
                ranges: int = FILER_RANGES, gateway_sizes=None) -> dict:
    """Phase 14: the filer over EC volumes. (a) ingest: the large files
    with `filer.copy` (a subprocess of the CLI), the small ones by HTTP
    POST from 16 threads, fs.ls/fs.du/fs.tree against the tree; (b)
    ec.encode of the collection on the card; (c) healthy reads through
    the filer; (d) a server holding at most four shards of every volume
    stopped, the reads again, K1 decoding the lost intervals; (e)
    volume.fsck: 0 orphans, then N needles uploaded outside the filer
    found and purged; (f) fs.meta.save, fs.meta.load into a fresh filer
    on weedkv, the large files read through it; (g) `server -filer
    -cpuprofile` as a subprocess, `version`, `scaffold -config filer`,
    `backup` and `compact -commit` of one volume. With `cryptography`, a
    second filer with -encryptVolumeData writes four files in (a) and
    reads them back in (d); without it, its POST must answer 500 and
    store no chunk. Phase 15 rides this cluster: its gateways write
    between (a) and (b) (``gateways_write``), so (b) encodes their data,
    and read it all back after (d) (``gateways_read``), with (d)'s
    server still stopped; (g) runs ``server -filer -s3``. Phase 16
    (``stores_and_replication``) runs between (f) and (g), with (d)'s
    server still stopped. ``gateway_sizes`` (``Gateways``' keyword
    arguments) shrinks phase 15 for a rehearsal on the CPU."""
    import signal as signal_mod

    import re

    from seaweedfs_tpu_torch import rpc
    from seaweedfs_tpu_torch.operation import operations
    from seaweedfs_tpu_torch.operation.file_id import parse_fid
    from seaweedfs_tpu_torch.server.filer import FilerServer
    from seaweedfs_tpu_torch.server.master import MasterServer
    from seaweedfs_tpu_torch.server.volume import VolumeServer
    from seaweedfs_tpu_torch.shell import Shell
    from seaweedfs_tpu_torch.util import http_client
    from seaweedfs_tpu_torch.util.chunk_cache import TieredChunkCache

    card = card or backend
    launches = Launches(backend)
    out = {}
    root = os.path.dirname(os.path.abspath(__file__))
    chunk = FILER_MAX_MB << 20
    rng = np.random.default_rng(seed + 40)
    sizes = chunked_file_sizes(rng) if sizes is None else list(sizes)
    datas = {}
    large_dir = os.path.join(workdir, "large")
    os.makedirs(large_dir)
    for i, size in enumerate(sizes):
        data = rng.bytes(int(size))
        with open(os.path.join(large_dir, f"file{i:02d}.bin"), "wb") as f:
            f.write(data)
        datas[f"/large/large/file{i:02d}.bin"] = data
    large_paths = sorted(datas)
    pool_bytes = rng.bytes(8 << 20)
    small = {}
    for i in range(small_files):
        size = int(rng.integers(1024, FILER_SMALL_MAX + 1))
        off = int(rng.integers(0, len(pool_bytes) - size))
        small[f"/small/d{i % FILER_DIRS:02d}/f{i:04d}.bin"] = \
            pool_bytes[off:off + size]
    datas.update(small)
    try:
        import cryptography  # noqa: F401
        have_crypto = True
    except ImportError:
        have_crypto = False

    master = MasterServer(port=free_port_pair(),
                          meta_dir=os.path.join(workdir, "m"),
                          volume_size_limit_mb=FILER_VOLUME_MB,
                          pulse_seconds=1.0)
    servers, filers, procs = [], [], []
    gw = None
    t_phase = time.perf_counter()
    try:
        master.start()
        for i in range(SERVICE_SERVERS):
            d = os.path.join(workdir, f"vol{i}")
            os.makedirs(d)
            vs = VolumeServer(master.url, [d], port=free_port_pair(),
                              max_volume_counts=[40], pulse_seconds=1.0,
                              ec_encoder=backend)
            vs.start()
            servers.append(vs)
        wait_until(lambda: len(master.topo.nodes()) == len(servers), 30,
                   "four servers registered")
        filer = FilerServer(master.url, port=free_port_pair(),
                            store="sqlite",
                            meta_dir=os.path.join(workdir, "filer"),
                            collection="filer", replication="000",
                            chunk_size=chunk)
        filer.start()
        filers.append(filer)
        secret = FilerServer(master.url, port=free_port_pair(),
                             store="memory", collection="filer",
                             replication="000", chunk_size=chunk,
                             cipher=True)
        secret.start()
        filers.append(secret)
        sh = Shell(master.url, filer_url=filer.url)

        # (a) ingest
        def ingest():
            t0 = time.perf_counter()
            run_cli(["filer.copy", "-maxMB", str(FILER_MAX_MB),
                     "-collection", "filer", "-c", "4", large_dir,
                     f"http://{filer.url}/large/"], root)
            large_s = time.perf_counter() - t0
            items = sorted(small.items())

            def post(part):
                for path, data in part:
                    r = http_client.request("POST", f"{filer.url}{path}",
                                            body=data)
                    if r.status != 201:
                        raise AssertionError(f"POST {path}: http "
                                             f"{r.status} {r.body[:200]!r}")

            t0 = time.perf_counter()
            with concurrent.futures.ThreadPoolExecutor(
                    SERVICE_THREADS) as pool:
                list(pool.map(post, [items[i::SERVICE_THREADS]
                                     for i in range(SERVICE_THREADS)]))
            return large_s, time.perf_counter() - t0

        (large_s, small_s), ingest_s = launches.run("filer_ingest", ingest,
                                                    none=True)
        large_bytes = sum(len(datas[p]) for p in large_paths)
        small_bytes = sum(len(d) for d in small.values())
        n_chunks = sum(len(filer.filer.find_entry(p).chunks)
                       for p in large_paths)
        if n_chunks != sum(max(1, -(-len(datas[p]) // chunk))
                           for p in large_paths):
            raise AssertionError(f"filer.copy: {n_chunks} chunks")
        ls = sh.run_command("fs.ls /small").split()
        if sorted(ls) != [f"d{j:02d}/" for j in range(FILER_DIRS)]:
            raise AssertionError(f"fs.ls /small: {ls[:8]}...")
        du = {line.rsplit("\t", 1)[1]: line
              for line in sh.run_command("fs.du /").splitlines()}
        for top, want in (("/small", small_bytes), ("/large", large_bytes)):
            got = int(du[top].split("byte:")[1].split()[0])
            if got != want:
                raise AssertionError(f"fs.du {top}: {got} B, want {want}")
        tree = sh.run_command("fs.tree /small")
        if tree.count(".bin") != len(small) or \
                tree.count("/\n") != FILER_DIRS:
            raise AssertionError("fs.tree /small")
        enc_paths = []
        enc_before = needle_count(servers)
        if have_crypto:
            for i in range(FILER_ENCRYPTED_FILES):
                path = f"/secret/e{i}.bin"
                datas[path] = rng.bytes(int(rng.integers(1, 3 * chunk)))
                r = http_client.request("POST", f"{secret.url}{path}",
                                        body=datas[path])
                if r.status != 201:
                    raise AssertionError(f"encrypted POST: {r.status}")
                enc_paths.append(path)
                # the main filer references the same chunks, so that
                # volume.fsck (which walks one filer) counts them in use
                filer.filer.create_entry("/secret",
                                         secret.filer.find_entry(path))
            crypto_case = (f"cryptography present: {len(enc_paths)} "
                           "encrypted files written")
        else:
            r = http_client.request("POST", f"{secret.url}/secret/e.bin",
                                    body=rng.bytes(chunk + 5))
            if r.status != 500 or needle_count(servers) != enc_before:
                raise AssertionError(f"encrypted POST without cryptography:"
                                     f" http {r.status}, "
                                     f"{needle_count(servers) - enc_before}"
                                     " chunks stored")
            crypto_case = ("cryptography absent: the encrypted POST "
                           "answered 500 and stored no chunk")
        total = large_bytes + small_bytes
        out["ingest"] = dict(
            seconds=ingest_s, large_files=len(large_paths),
            large_bytes=large_bytes, large_seconds=large_s,
            large_MBps=large_bytes / large_s / 1e6, chunks=n_chunks,
            small_files=len(small), small_bytes=small_bytes,
            small_seconds=small_s, small_MBps=small_bytes / small_s / 1e6,
            small_files_per_s=len(small) / small_s,
            MBps=total / (large_s + small_s) / 1e6, encryption=crypto_case)
        log(f"  (a) filer.copy -maxMB {FILER_MAX_MB} of {len(large_paths)} "
            f"files ({large_bytes} B, {n_chunks} chunks) in "
            f"{large_s:.3f} s = {large_bytes / large_s / 1e6:.1f} MB/s; "
            f"{len(small)} files of 1-64 KiB ({small_bytes} B) in "
            f"{FILER_DIRS} directories by POST from {SERVICE_THREADS} "
            f"threads in {small_s:.3f} s = {len(small) / small_s:.1f} "
            f"files/s, {small_bytes / small_s / 1e6:.1f} MB/s; fs.ls, "
            f"fs.du and fs.tree agree with the tree; {crypto_case} "
            f"[{card}]")

        # phase 15 (a): the gateways write onto this filer
        log("phase 15: the filer's gateways on phase 14's cluster (S3 with "
            "IAM, multipart and the s3 tier, WebDAV, FTP)")
        t15 = time.perf_counter()
        gw = Gateways(master, filer, rng, **(gateway_sizes or {}))
        gateways_write(gw, sh, servers, launches, card, out)
        gw_seconds = time.perf_counter() - t15

        # (b) ec.encode of the collection on the card
        vids = sorted({vid for vs in servers for loc in vs.store.locations
                       for vid, v in list(loc.volumes.items())
                       if v.collection == "filer"})
        dat_bytes = 0
        for vid in vids:
            for vs in servers:
                v = vs.store.find_volume(vid)
                if v is not None:
                    v.sync()
                    dat_bytes += v.content_size
        text, enc_s = launches.run(
            "filer_encode", sh.run_command,
            f"ec.encode -collection=filer "
            f"-volumeId={','.join(map(str, vids))}")
        for vid in vids:
            if f"volume {vid}: ec.encode done" not in text:
                raise AssertionError(f"ec.encode:\n{text}")
        wait_until(lambda: all(
            not master.topo.lookup(v) and
            sum(b.count for b in master.topo.lookup_ec(v).values()) == 14
            for v in vids), 60, "the EC layout settled")
        out["encode"] = dict(seconds=enc_s, volumes=vids,
                             dat_bytes=dat_bytes,
                             GBps=dat_bytes / enc_s / 1e9,
                             launches=launches.per_phase["filer_encode"])
        log(f"  (b) ec.encode -collection=filer of {len(vids)} volumes "
            f"({dat_bytes} B of .dat): {enc_s:.3f} s = "
            f"{dat_bytes / enc_s / 1e9:.3f} GB/s, "
            f"{launches.per_phase['filer_encode']} gf_linear launches "
            f"[{card}]")

        # (c) healthy reads through the filer
        picked = sorted(small)
        picked = [picked[int(i)] for i in
                  rng.choice(len(picked), min(sample, len(picked)),
                             replace=False)]
        jobs = []
        for _ in range(ranges):
            path = large_paths[int(rng.integers(len(large_paths)))]
            size = len(datas[path])
            edge = int(rng.integers(0, max(1, size // chunk) + 1)) * chunk
            start = min(size - 1, max(0, edge + int(rng.integers(-4096,
                                                                 4097))))
            jobs.append((path, start, int(rng.integers(
                1, min(size - start, 2 * chunk) + 1))))

        def reads(url):
            whole = read_filer(url, [(p, 0, None) for p in large_paths],
                               datas, threads=4)
            smalls = read_filer(url, [(p, 0, None) for p in picked], datas)
            ranged = read_filer(url, jobs, datas)
            return whole, smalls, ranged

        def stats(whole, smalls, ranged, secs):
            return dict(
                seconds=secs, whole=len(whole),
                whole_p50_ms=float(np.percentile(whole, 50) * 1e3),
                whole_p99_ms=float(np.percentile(whole, 99) * 1e3),
                small=len(smalls),
                small_p50_ms=float(np.percentile(smalls, 50) * 1e3),
                small_p99_ms=float(np.percentile(smalls, 99) * 1e3),
                ranged=len(ranged),
                ranged_p50_ms=float(np.percentile(ranged, 50) * 1e3),
                ranged_p99_ms=float(np.percentile(ranged, 99) * 1e3))

        (whole, smalls, ranged), secs = launches.run(
            "filer_healthy_reads", reads, filer.url, none=True)
        out["healthy_reads"] = stats(whole, smalls, ranged, secs)
        log(f"  (c) through the filer: every large file whole "
            f"({pcts(whole)}), {len(smalls)} sampled small files "
            f"({pcts(smalls)}), {len(ranged)} Range reads at chunk "
            f"boundaries ({pcts(ranged)}); bytes equal; {secs:.3f} s "
            f"[{card}]")

        # (d) a server with at most four shards of every volume stopped
        victim = max((vs for vs in servers
                      if all(len(held(vs, v)) <= 4 for v in vids)),
                     key=lambda vs: sum(len(held(vs, v)) for v in vids))
        victim.stop()
        servers.remove(victim)
        wait_until(lambda: victim.url not in
                   {n.url for n in master.topo.nodes()}, 30,
                   "the master dropping the stopped server")
        # the filers' chunk caches hold (c)'s chunks: empty them, so every
        # read below goes to the volume servers
        for f in filers:
            f.chunk_cache = TieredChunkCache()
        d0 = sum(vs.degraded.dispatches for vs in servers)

        def degraded():
            got = reads(filer.url)
            if enc_paths:
                read_filer(secret.url, [(p, 0, None) for p in enc_paths],
                           datas, threads=4)
            return got

        (whole, smalls, ranged), secs = launches.run(
            "filer_degraded_reads", degraded)
        dispatches = sum(vs.degraded.dispatches for vs in servers) - d0
        k1 = launches.per_phase["filer_degraded_reads"]
        if not dispatches or (backend == "cuda" and k1 < dispatches):
            raise AssertionError(f"degraded filer reads: {dispatches} "
                                 f"decode dispatches, {k1} K1 launches")
        out["degraded_reads"] = dict(stats(whole, smalls, ranged, secs),
                                     dispatches=dispatches, launches=k1,
                                     lost_server=victim.url,
                                     encrypted_files=len(enc_paths))
        log(f"  (d) {victim.url} stopped (at most 4 shards of every "
            f"volume); through the filer: every large file whole "
            f"({pcts(whole)}), {len(smalls)} small files ({pcts(smalls)}), "
            f"{len(ranged)} Range reads ({pcts(ranged)}), "
            f"{len(enc_paths)} encrypted files; bytes equal; {dispatches} "
            f"decode fleet dispatches, {k1} K1 launches "
            f"({k1 / dispatches:.2f} per dispatch); {secs:.3f} s [{card}]")

        # phase 15 (b): every gateway byte back with the server stopped
        t15 = time.perf_counter()
        gateways_read(gw, filers, servers, launches, card, out)
        gw_seconds += time.perf_counter() - t15

        # (e) volume.fsck
        def fsck():
            t0 = time.perf_counter()
            first = sh.run_command("volume.fsck")
            first_s = time.perf_counter() - t0
            if " 0 orphans" not in first:
                raise AssertionError(f"volume.fsck on the EC volumes:\n"
                                     f"{first}")
            blobs = []
            for i in range(FILER_FSCK_NEEDLES):
                p = os.path.join(workdir, f"orphan{i}.bin")
                with open(p, "wb") as f:
                    f.write(rng.bytes(int(rng.integers(100, 5000))))
                blobs.append(p)
            up = json.loads(run_cli(["upload", "-master", master.url,
                                     "-collection", "filer"] + blobs, root))
            uploaded = time.time()
            fids = sorted(u["fid"] for u in up)
            t0 = time.perf_counter()
            found = sh.run_command("volume.fsck -v")
            found_s = time.perf_counter() - t0
            want = sorted(f"{parse_fid(f).volume_id},{parse_fid(f).key:x}"
                          "xxxxxxxx" for f in fids)
            got = sorted(line.strip() for line in found.splitlines()
                         if line.startswith("  ") and "xxxxxxxx" in line)
            if got != want or \
                    f" {FILER_FSCK_NEEDLES} orphans" not in found:
                raise AssertionError(f"volume.fsck -v: {got} != {want}\n"
                                     f"{found}")
            # the volume's .dat time is whole seconds: wait out the
            # cutoff and the second it may round down by
            time.sleep(max(0.0, uploaded + FILER_FSCK_CUTOFF_S + 1.2 -
                           time.time()))
            purge = sh.run_command(
                "volume.fsck -reallyDeleteFromVolume -cutoffTimeAgo "
                f"{FILER_FSCK_CUTOFF_S}")
            purged = sum(int(n) for n in re.findall(
                r"purged (\d+)/\d+ blobs", purge))
            if purged != FILER_FSCK_NEEDLES:
                raise AssertionError(f"purge:\n{purge}")
            after = sh.run_command("volume.fsck")
            if " 0 orphans" not in after:
                raise AssertionError(f"after the purge:\n{after}")
            for f in fids:
                holder = operations.lookup(master.url,
                                           parse_fid(f).volume_id)[0]
                r = filer_get(holder, f"/{f}")
                if r.status != 404:
                    raise AssertionError(f"{f} after the purge: {r.status}")
            return first_s, found_s, fids

        (first_s, found_s, orphan_fids), fsck_s = launches.run(
            "filer_fsck", fsck, maybe=True)
        out["fsck"] = dict(seconds=fsck_s, ec_seconds=first_s,
                           found_seconds=found_s,
                           orphans=len(orphan_fids),
                           launches=launches.per_phase["filer_fsck"])
        log(f"  (e) volume.fsck over the EC volumes: 0 orphans in "
            f"{first_s:.3f} s; {len(orphan_fids)} needles uploaded outside "
            f"the filer found exactly by volume.fsck -v ({found_s:.3f} s) "
            f"and purged by -reallyDeleteFromVolume -cutoffTimeAgo "
            f"{FILER_FSCK_CUTOFF_S}; 0 orphans after; {fsck_s:.3f} s "
            f"[{card}]")

        # (f) the metadata round trip into a filer on weedkv
        def meta_round_trip():
            snap = os.path.join(workdir, "namespace.meta")
            t0 = time.perf_counter()
            saved = sh.run_command(f"fs.meta.save -o {snap} /")
            save_s = time.perf_counter() - t0
            fresh = FilerServer(master.url, port=free_port_pair(),
                                store="weedkv",
                                meta_dir=os.path.join(workdir, "filer2"),
                                collection="filer", chunk_size=chunk)
            fresh.start()
            filers.append(fresh)
            t0 = time.perf_counter()
            loaded = Shell(master.url, filer_url=fresh.url).run_command(
                f"fs.meta.load {snap}")
            load_s = time.perf_counter() - t0
            lat = read_filer(fresh.url, [(p, 0, None) for p in large_paths],
                             datas, threads=4)
            return saved.strip(), loaded.strip(), save_s, load_s, lat

        (saved, loaded, save_s, load_s, lat), secs = launches.run(
            "filer_meta_round_trip", meta_round_trip)
        out["meta"] = dict(save_seconds=save_s, load_seconds=load_s,
                           reads=len(lat),
                           read_p50_ms=float(np.percentile(lat, 50) * 1e3),
                           launches=launches.per_phase[
                               "filer_meta_round_trip"])
        log(f"  (f) fs.meta.save / in {save_s:.3f} s ({saved}); "
            f"fs.meta.load into a fresh filer on weedkv in {load_s:.3f} s "
            f"({loaded}); the large files through it with the server "
            f"still stopped ({pcts(lat)}), "
            f"{launches.per_phase['filer_meta_round_trip']} K1 launches "
            f"[{card}]")

        # phase 16: the networked stores and replication on this cluster
        log("phase 16: a filer on redis (fs.meta.load, degraded reads), "
            "filer.replicate into it and filer.sync with it, on phase 14's "
            "cluster with its server still stopped")
        stores_and_replication(
            master, filer, filers, servers, gw, datas, large_paths,
            os.path.join(workdir, "namespace.meta"), workdir, chunk,
            launches, card, rng, out)

        # (g) the one-process server, version, scaffold, backup, compact
        def cli():
            t0 = time.perf_counter()
            d = os.path.join(workdir, "server")
            prof = os.path.join(workdir, "server.prof")
            ports = [free_port_pair() for _ in range(4)]
            argv = [sys.executable, "-m", "seaweedfs_tpu_torch", "server",
                    "-filer", "-s3", "-dir", d, "-master.port",
                    str(ports[0]), "-volume.port", str(ports[1]),
                    "-filer.port", str(ports[2]), "-s3.port", str(ports[3]),
                    "-volume.max", "4", "-cpuprofile", prof]
            if backend != "cuda":
                argv += ["-ec.encoder", backend]
            proc = subprocess.Popen(
                argv, cwd=root, env=dict(os.environ, PYTHONPATH=root),
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            procs.append(proc)
            url = f"127.0.0.1:{ports[2]}"
            body = rng.bytes(300_000)

            def posted():
                try:
                    return http_client.request(
                        "POST", f"{url}/one/f.bin", body=body,
                        timeout=10).status == 201
                except OSError:
                    return False

            wait_until(posted, 120, "server -filer to take a POST")
            r = filer_get(url, "/one/f.bin")
            if r.status != 200 or r.body != body:
                raise AssertionError(f"server -filer GET: {r.status}")
            # its S3 gateway (no identities: anonymous), one PUT and GET
            from seaweedfs_tpu_torch.util.s3_client import S3Client
            s3 = S3Client(f"127.0.0.1:{ports[3]}", "", "")
            s3.create_bucket("one")
            s3.put_object("one", "s3.bin", body[:100_000])
            if s3.get_object("one", "s3.bin") != body[:100_000]:
                raise AssertionError("server -s3: the GET differs")
            proc.send_signal(signal_mod.SIGINT)
            _, err = proc.communicate(timeout=60)
            procs.remove(proc)
            if proc.returncode != 0 or "Traceback" in err or \
                    not os.path.getsize(prof):
                raise AssertionError(f"server -filer -s3 exit "
                                     f"{proc.returncode}:\n{err[-3000:]}")
            server_s = time.perf_counter() - t0
            version = run_cli(["version"], root).strip()
            scaffold = run_cli(["scaffold", "-config", "filer"], root)
            if "[sqlite]" not in scaffold:
                raise AssertionError("scaffold -config filer")
            # backup and compact: the normal volume the fsck needles
            # went to (purged: it has deletions to compact), with
            # FILER_KEEPERS needles written into it now to keep
            vid = parse_fid(orphan_fids[0]).volume_id
            holder = next(vs for vs in servers
                          if vs.store.find_volume(vid) is not None)
            for i in range(FILER_KEEPERS):
                fid = f"{vid},{SERVE_KEY0 + i:x}{0x5eed:08x}"
                r = http_client.request(
                    "POST", f"{holder.url}/{fid}",
                    body=rng.bytes(int(rng.integers(100, 20000))))
                if r.status != 201:
                    raise AssertionError(f"POST {fid}: {r.status}")
            v = holder.store.find_volume(vid)
            v.sync()
            bk = os.path.join(workdir, "backup")
            os.makedirs(bk)
            run_cli(["backup", "-server", master.url, "-volumeId", str(vid),
                     "-collection", "filer", "-dir", bk], root)
            src_base = v.file_name()
            if sha256_file(os.path.join(bk, f"filer_{vid}.dat")) != \
                    sha256_file(src_base + ".dat"):
                raise AssertionError("backup: .dat differs from the source")
            cp = os.path.join(workdir, "compact")
            os.makedirs(cp)
            for ext in (".dat", ".idx"):
                shutil.copy(src_base + ext, cp)
            before = live_needles_of(cp, "filer", vid)
            size0 = os.path.getsize(os.path.join(cp, f"filer_{vid}.dat"))
            run_cli(["compact", "-dir", cp, "-volumeId", str(vid),
                     "-collection", "filer", "-commit"], root)
            after = live_needles_of(cp, "filer", vid)
            size1 = os.path.getsize(os.path.join(cp, f"filer_{vid}.dat"))
            if after != before or len(after) < FILER_KEEPERS or \
                    size1 >= size0:
                raise AssertionError(f"compact: {len(after)} needles of "
                                     f"{len(before)}, {size0} -> {size1} B")
            return server_s, version, vid, len(after), size0, size1

        (server_s, version, vid, live, size0, size1), cli_s = \
            launches.run("filer_cli", cli, none=True)
        out["cli"] = dict(seconds=cli_s, server_seconds=server_s,
                          version=version, volume=vid, live_needles=live,
                          dat_before=size0, dat_after=size1)
        log(f"  (g) server -filer -s3 -cpuprofile: one file POSTed and read "
            f"back, one object PUT and read back through its S3 port, "
            f"stopped by SIGINT (exit 0, profile written) in "
            f"{server_s:.3f} s; {version!r}; scaffold -config filer; "
            f"backup of volume {vid}: .dat byte-equal to the source; "
            f"compact -commit: the same {live} live needles, .dat {size0} "
            f"-> {size1} B; {cli_s:.3f} s [{card}]")
    finally:
        for proc in procs:
            proc.kill()
            proc.communicate()
        if gw is not None:
            gw.stop()
        for f in filers:
            f.stop()
        for vs in servers:
            vs.stop()
        master.stop()
        http_client.close_all()
        rpc.close_channels()
    out["seconds"] = time.perf_counter() - t_phase
    out["gateway_seconds"] = gw_seconds
    out["launches"] = dict(launches.per_phase)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--needles", type=int, default=1 << 20)
    ap.add_argument("--seed", type=int, default=1)
    args = ap.parse_args()
    t_start = time.perf_counter()

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 1
    import seaweedfs_tpu_torch  # noqa: F401  (fails outside the repo)
    card = nvidia_smi_line()
    log(f"card: {card}")
    kind = torch.cuda.get_device_name(0)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, {kind}")

    log("phase 1: build")
    log(f"  built gf_linear.cu and gf_compare.cu (nvcc) and crc32c.cpp "
        f"(g++) in {build_all():.1f} s")
    log("phase 2: kernel vs plain on the card")
    kstats = phase_kernel(args.seed)
    log(f"  phases 1-2 took {time.perf_counter() - t_start:.3f} s [{card}]")
    t0 = time.perf_counter()
    log("phase 3: main path")
    workdir = tempfile.mkdtemp(prefix="chip_smoke_")
    # phase 3's original volume files, kept for phase 8 (h)
    fix_dir = tempfile.mkdtemp(prefix="chip_smoke_fix_")
    atexit.register(shutil.rmtree, fix_dir, True)
    try:
        log(f"  workdir {workdir}, "
            f"{shutil.disk_usage(workdir).free / 2**30:.1f} GiB free")
        m = phase_main_path(workdir, args.needles, args.seed, "cuda")
        log("phase 4: chunk sweep")
        sweep = phase_chunk_sweep(m["large_base"], m["dat_size"],
                                  m["shard_hashes"], "cuda")
        log("phase 5: trace of one encode")
        trace = phase_trace(m["large_base"], "cuda")
        for ext in (".dat", ".idx"):
            os.replace(m["large_base"] + ext,
                       os.path.join(fix_dir, "1" + ext))
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    log(f"  phases 3-5 took {time.perf_counter() - t0:.3f} s [{card}]")
    t0 = time.perf_counter()
    log("phase 6: fleet")
    workdir = tempfile.mkdtemp(prefix="chip_smoke_fleet_")
    try:
        log(f"  workdir {workdir}, "
            f"{shutil.disk_usage(workdir).free / 2**30:.1f} GiB free")
        fleet, ctx = phase_fleet(workdir, args.seed, "cuda")
        log("phase 7: scrub and mesh")
        from seaweedfs_tpu_torch.parallel import mesh_fleet
        span = min((mesh_fleet.DEFAULT_BUCKET_MB << 20) // 10,
                   max(ctx["shard_sizes"]))
        cstats = phase_compare_kernel(args.seed, span)
        scrub_mesh = phase_scrub_mesh(workdir, ctx, args.seed, "cuda")
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    log(f"  phases 6-7 took {time.perf_counter() - t0:.3f} s [{card}]")
    t0 = time.perf_counter()
    log("phase 8: the service path (master, volume servers, shell, CLI), "
        "and phase 9 on its cluster")
    workdir = tempfile.mkdtemp(prefix="chip_smoke_service_")
    try:
        service = phase_service(workdir, args.seed, "cuda", card=card,
                                fix_dir=fix_dir)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    log(f"  phases 8-9 took {time.perf_counter() - t0:.3f} s at "
        f"{SERVICE_BYTES >> 20} MiB [{card}]")
    log("phase 10: the replicated HA cluster (three masters, four servers "
        "over two racks, placement 010)")
    workdir = tempfile.mkdtemp(prefix="chip_smoke_repl_")
    try:
        repl = phase_replication(workdir, args.seed, "cuda", card=card)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    log(f"  phase 10 took {repl['seconds']:.3f} s at {REPL_BYTES >> 20} "
        f"MiB a half [{card}]")
    log("phase 11: chunked files through the client libraries (three "
        "masters, four servers, MasterClient, leases, ec.encode, a "
        "failover, a lost server, the CLI)")
    workdir = tempfile.mkdtemp(prefix="chip_smoke_chunked_")
    try:
        chunked = phase_chunked(workdir, args.seed, "cuda", card=card)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    log(f"  phase 11 took {chunked['seconds']:.3f} s [{card}]")
    log("phase 12: the lifecycle cluster (three masters with the "
        "lifecycle engine, four servers tracking heat, QoS and cluster "
        "tracing on)")
    workdir = tempfile.mkdtemp(prefix="chip_smoke_lifecycle_")
    try:
        lifecycle = phase_lifecycle(workdir, args.seed, "cuda", card=card)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    log(f"  phase 12 took {lifecycle['seconds']:.3f} s at "
        f"{LIFECYCLE_BYTES >> 20} MiB [{card}]")
    log("phase 13: the async serving core (threaded against async server "
        "processes; degraded reads, the keep-alive budget and QoS at "
        "frame time through the async core of four servers)")
    workdir = tempfile.mkdtemp(prefix="chip_smoke_serve_")
    try:
        serve = phase_serve(workdir, args.seed, "cuda", card=card)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    log(f"  phase 13 took {serve['seconds']:.3f} s in rounds of "
        f"{SERVE_ROUND_S} s [{card}]")
    log("phase 14: the filer over EC on the card (a master, four servers "
        "and a filer on sqlite; filer.copy, POSTs, ec.encode, degraded "
        "reads through the filer, volume.fsck, fs.meta.save/load, "
        "server -filer -s3, backup, compact), with phase 15's gateways on "
        "its filer and phase 16's redis filer and replication")
    workdir = tempfile.mkdtemp(prefix="chip_smoke_filer_")
    try:
        filer = phase_filer(workdir, args.seed, "cuda", card=card)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    log(f"  phase 14 took {filer['seconds']:.3f} s with phase 15's "
        f"{filer['gateway_seconds']:.3f} s and phase 16's "
        f"{filer['stores_replication']['seconds']:.3f} s [{card}]")
    log(f"  phases 1-16 took {time.perf_counter() - t_start:.3f} s [{card}]")
    service["replication"] = {k: v for k, v in repl.items()
                              if k != "launches"}
    service["chunked"] = {k: v for k, v in chunked.items()
                          if k != "launches"}
    service["launches"].update(repl["launches"])
    service["launches"].update(chunked["launches"])
    service["lifecycle"] = {k: v for k, v in lifecycle.items()
                            if k != "launches"}
    service["launches"].update(lifecycle["launches"])
    service["serve"] = {k: v for k, v in serve.items() if k != "launches"}
    service["launches"].update(serve["launches"])
    service["filer"] = {k: v for k, v in filer.items() if k != "launches"}
    service["launches"].update(filer["launches"])
    main_launches = sum(m["launches"][p] for p in
                        ("generate", "rebuild", "degraded_read", "decode"))
    service_launches = sum(service["launches"].values())
    compare_launches = sum(scrub_mesh["compare_launches"].values())
    summary = {k: v for k, v in m.items()
               if k not in ("shard_hashes", "large_base")}
    summary["chunk_sweep_GBps"] = sweep
    summary["kernel"] = kstats
    summary["trace"] = trace
    summary["fleet"] = fleet
    summary["compare_kernel"] = cstats
    summary["scrub_mesh"] = scrub_mesh
    summary["service"] = service
    log("metrics: " + json.dumps(summary))
    log('kernels: ["gf_linear", "gf_compare"]')
    print(json.dumps({"kernels": [{
        "name": "gf_linear", "route": "cuda",
        "source": "seaweedfs_tpu_torch/csrc/gf_linear.cu",
        "replaces": "seaweedfs_tpu/ops/rs_pallas.py:45",
        "launches": main_launches + service_launches,
        "launches_by_path": {"main": main_launches,
                             "service": service_launches,
                             "service_by_phase": service["launches"]},
        "max_abs_err": kstats["max_abs_err"],
        **kstats["main"], "bound_by": "bytes",
        "library_ms": None}, {
        "name": "gf_compare", "route": "cuda",
        "source": "seaweedfs_tpu_torch/csrc/gf_compare.cu",
        "replaces": "seaweedfs_tpu/parallel/mesh_fleet.py:234",
        "launches": compare_launches,
        "max_abs_err": cstats["max_abs_err"],
        **{k: cstats[k] for k in ("ms", "ms_pipelined", "ms_device",
                                  "plain_ms", "bound_ms")},
        "bound_by": "bytes", "library_ms": None}]}))
    print(nvidia_smi_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
