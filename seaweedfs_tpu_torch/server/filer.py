"""Filer server: the namespace server.

HTTP serves the public file path (GET streams chunked content, POST
auto-chunks uploads across volume servers, DELETE removes entries); the
RPC plane (``rpc.py``) serves the SeaweedFiler service incl. metadata
subscriptions. The counterpart of ``seaweedfs_tpu.server.filer``: the
same replies, headers and bodies. A chunk on an EC volume with a lost
shard is read through the volume server's degraded read, which decodes
on the card.

Reference: weed/server/filer_server.go, filer_server_handlers_write_
autochunk.go:28-300, filer_server_handlers_read.go, filer_grpc_server*.go.
"""

from __future__ import annotations

import json
import threading
import time
import urllib.parse
from typing import List, Optional

from seaweedfs_tpu_torch import rpc, unported
from seaweedfs_tpu_torch.util.http_server import (FastHandler, ServeConfig,
                                                  make_http_server)
from seaweedfs_tpu_torch.resilience import deadline as _deadline
from seaweedfs_tpu_torch.util import wlog
from seaweedfs_tpu_torch.filer import (Filer, FilerError, MemoryStore,
                                       NotFound, SqliteStore, filechunks,
                                       stream)
from seaweedfs_tpu_torch.filer import filer_conf as filer_conf_mod
from seaweedfs_tpu_torch.filer.filechunk_manifest import maybe_manifestize
from seaweedfs_tpu_torch.filer.filer import new_entry
from seaweedfs_tpu_torch.filer.filerstore import join_path, split_path
from seaweedfs_tpu_torch.operation import operations
from seaweedfs_tpu_torch.pb import filer_pb2, master_pb2, master_stub
from seaweedfs_tpu_torch.util import compression
from seaweedfs_tpu_torch.util.chunk_cache import TieredChunkCache
from seaweedfs_tpu_torch.util.cipher import encrypt
from seaweedfs_tpu_torch.wdclient.masterclient import MasterClient

DEFAULT_CHUNK_SIZE = 8 << 20   # -maxMB analog


log = wlog.logger("filer")


# the JAX package's store names that need an outside server: refused,
# never replaced by another store
NETWORKED_STORES = ("redis", "redis_cluster", "redis_cluster2", "etcd",
                    "mongodb", "elastic", "elastic7", "cassandra", "hbase")


def make_filer_store(store: str, meta_dir: Optional[str],
                     options: Optional[dict] = None):
    """FilerStore factory (reference filer.toml store sections +
    filerstore.go registry). `options` carries the store's filer.toml
    section (hostnames, credentials, endpoints)."""
    opts = dict(options or {})
    if store == "memory":
        return MemoryStore()
    if store == "sqlite":
        path = f"{meta_dir}/filer.db" if meta_dir else ":memory:"
        return SqliteStore(path)
    if store in ("weedkv", "kv", "leveldb"):
        from seaweedfs_tpu_torch.filer.stores.kv_store import KvFilerStore
        if not meta_dir:
            raise ValueError("weedkv store needs a -dir/meta_dir")
        return KvFilerStore(f"{meta_dir}/weedkv")
    if store in NETWORKED_STORES:
        raise unported.refusal(f"filer store {store!r}",
                               unported.NETWORKED_STORES)
    if store == "mysql":
        from seaweedfs_tpu_torch.filer.stores.abstract_sql import MysqlStore
        return MysqlStore(
            host=opts.get("hostname", "localhost"),
            port=int(opts.get("port", 3306)),
            username=opts.get("username", ""),
            password=opts.get("password", ""),
            database=opts.get("database", "seaweedfs"))
    if store == "postgres":
        from seaweedfs_tpu_torch.filer.stores.abstract_sql import PostgresStore
        return PostgresStore(
            host=opts.get("hostname", "localhost"),
            port=int(opts.get("port", 5432)),
            username=opts.get("username", ""),
            password=opts.get("password", ""),
            database=opts.get("database", "seaweedfs"))
    raise ValueError(
        f"unknown filer store {store!r} (memory | sqlite | weedkv | "
        "mysql | postgres)")


def _advance_and_filter(events, prefix: str, since: int):
    """(new_since, matching events) for a subscription poll.

    `since` advances past EVERY scanned record, matching or not.
    Streaming loops must use THIS — not the readers' own path_prefix
    parameters — because reader-side filtering hides the timestamps
    needed to advance `since`, and a subscriber whose prefix matches
    nothing then spins at 100% CPU re-scanning the log forever.
    """
    from seaweedfs_tpu_torch.filer.filer_notify import matches_prefix
    matching = []
    for ev in events:
        since = max(since, ev.ts_ns)
        if prefix and not matches_prefix(ev, prefix):
            continue
        matching.append(ev)
    return since, matching


class FilerServer:
    def __init__(self, master_url: str, ip: str = "127.0.0.1",
                 port: int = 8888, store: str = "memory",
                 meta_dir: Optional[str] = None,
                 collection: str = "", replication: str = "",
                 chunk_size: int = DEFAULT_CHUNK_SIZE,
                 cipher: bool = False,
                 cache_dir: Optional[str] = None,
                 peers: Optional[List[str]] = None,
                 store_options: Optional[dict] = None,
                 ingest_parallelism: int = 8,
                 assign_lease_count: int = 0,
                 hedge_reads: bool = False,
                 hedge_delay_ms: float = 10.0,
                 listing_cache_mb: int = 0,
                 serve: Optional[ServeConfig] = None):
        self.master_url = master_url
        self.ip = ip
        self.serve = serve or ServeConfig()
        self.port = port
        self.collection = collection
        self.replication = replication
        self.chunk_size = chunk_size
        self.cipher = cipher
        # ingest pipeline (-ingest.parallelism): chunk k+1 is sliced /
        # read off the socket while chunks k-w..k upload on this shared
        # pool. Constructing the pool spawns NOTHING; threads appear on
        # the first multi-chunk body.
        self.ingest_parallelism = max(1, ingest_parallelism)
        from seaweedfs_tpu_torch.stats.metrics import \
            IngestPipelineOccupancyGauge
        from seaweedfs_tpu_torch.util.fanout import FanOutPool
        self._ingest_pool = FanOutPool(
            self.ingest_parallelism, f"ingest-{port}",
            inflight_gauge=IngestPipelineOccupancyGauge)
        # fid lease cache (-assign.leaseCount): absent — not merely
        # empty — unless sized, so the disabled assign path is one
        # None check
        self.leases = None
        if assign_lease_count > 1:
            from seaweedfs_tpu_torch.operation.assign_lease import LeaseCache
            self.leases = LeaseCache(count=assign_lease_count)
        # hedged chunk reads (-resilience.hedge): absent unless enabled
        # — the disabled read path is one None check; a constructed
        # Hedger spawns nothing until its first multi-replica fetch
        self.hedger = None
        if hedge_reads:
            from seaweedfs_tpu_torch.resilience.hedge import Hedger
            self.hedger = Hedger(
                delay_floor_s=max(hedge_delay_ms, 0.1) / 1000.0,
                name=f"hedge-filer-{port}")
        backend = make_filer_store(store, meta_dir, store_options)
        self.filer = Filer(backend,
                           log_dir=f"{meta_dir}/logs" if meta_dir else None)
        # listing cache (-meta.listingCacheMB): absent — not merely
        # empty — unless sized; when armed, list_entries pages skip
        # the store and the metadata event log drops them on mutation
        self.listing_cache = None
        if listing_cache_mb > 0:
            from seaweedfs_tpu_torch.filer.listing_cache import ListingCache
            self.listing_cache = ListingCache(listing_cache_mb << 20)
            self.filer.attach_listing_cache(self.listing_cache)
        self.filer.on_delete_chunks = self._delete_chunks_async
        self.filer.fetch_chunk_fn = lambda c: stream.fetch_chunk_bytes(
            self.lookup_fid_urls, c.file_id, bytes(c.cipher_key),
            c.is_compressed, hedger=self.hedger)
        self.chunk_cache = TieredChunkCache(
            disk_dir=f"{cache_dir}/chunks" if cache_dir else None)
        from seaweedfs_tpu_torch.rpc import GRPC_PORT_OFFSET
        self.master_client = MasterClient(
            [master_url], client_name="filer",
            grpc_port=port + GRPC_PORT_OFFSET)
        # path-specific rules (/etc/seaweedfs/filer.conf inside the
        # namespace; reference filer_conf.go) — loaded lazily, reloaded
        # whenever that path is written through this filer
        self.filer_conf = filer_conf_mod.FilerConf()
        # multi-filer: merge peer filers' local logs into one view
        # (reference filer/meta_aggregator.go)
        # the signature must SURVIVE restarts (reference persists it in
        # the store): events written before a restart must still be
        # recognizable as our own
        import random
        import struct as _struct
        sig_blob = backend.kv_get(b"filer.store.signature")
        if sig_blob and len(sig_blob) == 4:
            self.filer.signature = _struct.unpack(">i", sig_blob)[0]
        else:
            self.filer.signature = random.randint(1, 0x7FFFFFFF)
            backend.kv_put(b"filer.store.signature",
                           _struct.pack(">i", self.filer.signature))
        self.meta_aggregator = None
        if peers:
            from seaweedfs_tpu_torch.filer.meta_aggregator import MetaAggregator
            self.meta_aggregator = MetaAggregator(
                self.filer, f"{ip}:{port}", peers,
                signature=self.filer.signature,
                log_dir=f"{meta_dir}/aggr-logs" if meta_dir else None)
            self.filer.on_meta_event = self.meta_aggregator.wake
            if self.listing_cache is not None:
                # PEER mutations arrive through the aggregator's
                # subscription into its own MetaLog — the same
                # on_append seam invalidates here with reason="peer",
                # the contract that lets replica filers serve listings
                # without serving peers' stale pages
                lc = self.listing_cache
                self.meta_aggregator.aggr_log.on_append = \
                    lambda directory, ev: lc.apply_event(
                        directory, ev, reason="peer")
        self._grpc_server = None
        self._http_server = None
        self._http_thread = None
        self._stopping = False
        # live KeepConnected peers: (name, grpc_addr) -> [resources]
        self._brokers: dict = {}
        self._broker_lock = threading.Lock()

    def _maybe_reload_conf(self, *paths: str) -> None:
        if filer_conf_mod.FILER_CONF_PATH in paths:
            self.reload_filer_conf()

    def reload_filer_conf(self) -> None:
        """(Re)read /etc/seaweedfs/filer.conf from the namespace
        (reference filer_conf.go loadConfiguration)."""
        try:
            entry = self.filer.find_entry(filer_conf_mod.FILER_CONF_PATH)
        except NotFound:
            self.filer_conf = filer_conf_mod.FilerConf()
            return
        try:
            blob = b"".join(stream.stream_content(
                self.lookup_fid_urls, list(entry.chunks)))
            self.filer_conf = filer_conf_mod.FilerConf.from_bytes(blob)
            log.info("filer conf loaded: %d path rules",
                     len(self.filer_conf.rules))
        except Exception as e:
            log.warning("filer conf unreadable, keeping previous: %s", e)

    # -- lifecycle ------------------------------------------------------------

    @property
    def url(self) -> str:
        return f"{self.ip}:{self.port}"

    def start(self) -> None:
        handler = rpc.generic_handler(filer_pb2, "SeaweedFiler", self,
                                      stats_role="filer")
        self._grpc_server = rpc.make_server(
            f"{self.ip}:{self.port + rpc.GRPC_PORT_OFFSET}", [handler])
        self._http_server = make_http_server(
            (self.ip, self.port), _make_http_handler(self),
            role="filer", serve=self.serve)
        # lint: thread-ok(listener thread; ingress wrappers mint request context)
        self._http_thread = threading.Thread(
            target=self._http_server.serve_forever,
            name=f"filer-http-{self.port}", daemon=True)
        self._http_thread.start()
        self.master_client.start()
        if self.meta_aggregator is not None:
            self.meta_aggregator.start()
        self.reload_filer_conf()
        log.info("filer %s:%d started (store=%s, master=%s)",
                 self.ip, self.port, type(self.filer.store).__name__,
                 self.master_url)

    def stop(self) -> None:
        self._stopping = True
        if self.meta_aggregator is not None:
            self.meta_aggregator.stop()
        self.master_client.stop()
        if self._http_server:
            self._http_server.shutdown()
            self._http_server.server_close()
        if self._grpc_server:
            self._grpc_server.stop()
        # drain the ingest pool and stop banking leases BEFORE closing
        # the filer store: queued chunk uploads still run, late ones
        # fall back inline (util/grace shutdown contract)
        self._ingest_pool.stop()
        if self.leases is not None:
            self.leases.close()
        self.filer.close()

    # -- helpers --------------------------------------------------------------

    def _delete_chunks_async(self, chunks: List[filer_pb2.FileChunk]) -> None:
        fids = [c.file_id for c in chunks if c.file_id]
        if not fids:
            return

        def run():
            try:
                operations.delete_files(self.master_url, fids)
            except Exception:
                # volumes may already be gone; vacuum will reclaim
                from seaweedfs_tpu_torch.stats import metrics
                metrics.swallowed("filer.delete_chunks")

        # lint: thread-ok(deliberately detached: chunk deletion outlives the client reply)
        threading.Thread(target=run, daemon=True,
                         name="filer-delete-chunks").start()

    def lookup_fid_urls(self, file_id: str) -> List[str]:
        vid = int(file_id.split(",")[0])
        locs = self.master_client.lookup(vid)
        if locs:
            return [l.url for l in locs]
        if self.master_client.lookup_cache_enabled:
            # the client's coalescing cache already asked the master
            # (and holds the negative answer under its TTL); falling
            # through to operations.lookup would consult a SECOND
            # process-wide cache for the same master — doubled miss
            # RPCs, and its entries dodge invalidate_lookup
            return []
        return operations.lookup(self.master_url, vid)

    def _assign(self, collection: str = "", replication: str = "",
                ttl_sec: int = 0, data_center: str = ""):
        if self.leases is not None:
            return self.leases.acquire(
                self.master_url,
                collection=collection or self.collection,
                replication=replication or self.replication,
                ttl=ttl_string(ttl_sec),
                data_center=data_center)
        return operations.assign(
            self.master_url,
            collection=collection or self.collection,
            replication=replication or self.replication,
            ttl=ttl_string(ttl_sec),
            data_center=data_center)

    def _upload_one(self, off: int, piece: bytes, collection: str,
                    replication: str, ttl_sec: int, mime: str,
                    fsync: bool) -> filer_pb2.FileChunk:
        """Assign + upload ONE chunk; the unit both the serial and the
        pipelined paths run. A leased fid that fails at the volume
        server invalidates its whole volume's leases and retries once
        on a fresh direct assign (the lease went stale, not the data)."""
        from seaweedfs_tpu_torch.stats import trace
        cipher_key = b""
        stored = piece
        if self.cipher:
            stored, cipher_key = encrypt(piece)
        sp = trace.span("ingest.chunk_upload", off=off, size=len(piece)) \
            if trace.is_enabled() else trace.NOOP
        with sp:
            a = self._assign(collection, replication, ttl_sec)
            try:
                resp = operations.upload_data(
                    f"{a.url}/{a.fid}", stored, mime=mime, fsync=fsync)
            except (RuntimeError, OSError):
                if self.leases is None:
                    raise
                self.leases.invalidate(a.fid)
                a = operations.assign(
                    self.master_url,
                    collection=collection or self.collection,
                    replication=replication or self.replication,
                    ttl=ttl_string(ttl_sec))
                resp = operations.upload_data(
                    f"{a.url}/{a.fid}", stored, mime=mime, fsync=fsync)
        return filer_pb2.FileChunk(
            file_id=a.fid, offset=off, size=len(piece),
            mtime=time.time_ns(), e_tag=resp.get("eTag", ""),
            cipher_key=cipher_key)

    def _upload_pieces(self, pieces, n_pieces: int, collection: str,
                       replication: str, ttl_sec: int, mime: str,
                       fsync: bool) -> List[filer_pb2.FileChunk]:
        """Run (offset, bytes) pieces through assign+upload.

        Single piece (or -ingest.parallelism 1): fully serial, zero
        threads — the disabled-overhead invariant. Multi-chunk: a
        bounded producer/consumer pipeline. The producer (this thread)
        slices piece k+1 — or reads it off the socket in the streaming
        path — while up to `window` older pieces upload on the shared
        pool. Results assemble in offset order; the first failure
        latches, stops the producer (cancel-on-first-failure: the tail
        is never submitted) and surfaces after every in-flight upload
        drains (reference uploadReaderToChunks' errgroup shape).
        """
        if n_pieces <= 1 or self.ingest_parallelism <= 1:
            return [self._upload_one(off, piece, collection, replication,
                                     ttl_sec, mime, fsync)
                    for off, piece in pieces]
        from collections import deque

        from seaweedfs_tpu_torch.stats import trace
        from seaweedfs_tpu_torch.stats.metrics import \
            IngestPipelineChunksHistogram
        IngestPipelineChunksHistogram.observe(n_pieces)
        window = self.ingest_parallelism
        pending: deque = deque()    # futures in submission order
        chunks: List[filer_pb2.FileChunk] = []
        first_err: Optional[BaseException] = None

        def drain_one():
            nonlocal first_err
            result, exc = pending.popleft().wait()
            if exc is not None:
                if first_err is None:
                    first_err = exc
            else:
                chunks.append(result)

        sp = trace.span("ingest.pipeline", chunks=n_pieces) \
            if trace.is_enabled() else trace.NOOP
        with sp:
            try:
                for off, piece in pieces:
                    if first_err is not None:
                        break
                    pending.append(self._ingest_pool.submit(
                        self._upload_one, off, piece, collection,
                        replication, ttl_sec, mime, fsync))
                    while len(pending) >= window:
                        drain_one()
            except Exception as e:
                # producer failure (e.g. the streaming reader's short
                # read): latch it like a consumer failure so the drain
                # below still runs — in-flight uploads must never be
                # orphaned on the shared pool
                if first_err is None:
                    first_err = e
            while pending:
                drain_one()
        if first_err is not None:
            raise first_err
        chunks.sort(key=lambda c: c.offset)
        return chunks

    def upload_to_chunks(self, data: bytes, collection: str = "",
                         replication: str = "", ttl_sec: int = 0,
                         mime: str = "",
                         fsync: bool = False) -> List[filer_pb2.FileChunk]:
        """Split `data` into chunkSize pieces, assign+upload each
        (reference uploadReaderToChunks)."""
        size = len(data)
        n_pieces = max(1, -(-size // self.chunk_size))
        pieces = ((off, data[off:off + self.chunk_size])
                  for off in range(0, max(size, 1), self.chunk_size))
        return self._upload_pieces(pieces, n_pieces, collection,
                                   replication, ttl_sec, mime, fsync)

    def upload_stream_to_chunks(self, reader, size: int,
                                collection: str = "",
                                replication: str = "", ttl_sec: int = 0,
                                mime: str = "", fsync: bool = False
                                ) -> List[filer_pb2.FileChunk]:
        """Like upload_to_chunks but the body arrives through `reader`
        (the request socket): chunk k+1 is read off the wire while
        earlier chunks upload — the whole body is never resident."""
        n_pieces = max(1, -(-size // self.chunk_size))

        def pieces():
            off = 0
            while off < size or off == 0:
                want = min(self.chunk_size, size - off)
                piece = reader.read(want) if want else b""
                if want and len(piece) != want:
                    raise OSError(
                        f"short read: body ended {off + len(piece)}"
                        f"/{size}")
                yield off, piece
                off += max(len(piece), 1)

        return self._upload_pieces(pieces(), n_pieces, collection,
                                   replication, ttl_sec, mime, fsync)

    def save_manifest_blob(self, data: bytes) -> filer_pb2.FileChunk:
        a = self._assign()
        resp = operations.upload_data(f"{a.url}/{a.fid}", data)
        return filer_pb2.FileChunk(
            file_id=a.fid, size=len(data), mtime=time.time_ns(),
            e_tag=resp.get("eTag", ""))

    # -- gRPC: entry CRUD -----------------------------------------------------

    def LookupDirectoryEntry(self, request, context):
        try:
            # Filer.find_entry applies lazy TTL expiry (purge + chunk GC)
            e = self.filer.find_entry(
                join_path(request.directory, request.name))
        except NotFound:
            context.abort(rpc.StatusCode.NOT_FOUND,
                          f"{request.directory}/{request.name}")
        return filer_pb2.LookupDirectoryEntryResponse(entry=e)

    def ListEntries(self, request, context):
        limit = request.limit or 1024
        entries = self.filer.list_entries(
            request.directory,
            start_name=request.start_from_file_name,
            inclusive=request.inclusive_start_from,
            limit=limit, prefix=request.prefix)
        for e in entries:
            yield filer_pb2.ListEntriesResponse(entry=e)

    def CreateEntry(self, request, context):
        try:
            self.filer.create_entry(
                request.directory, request.entry, o_excl=request.o_excl,
                from_other_cluster=request.is_from_other_cluster,
                signatures=list(request.signatures))
            self._maybe_reload_conf(
                join_path(request.directory, request.entry.name))
            return filer_pb2.CreateEntryResponse()
        except FilerError as e:
            return filer_pb2.CreateEntryResponse(error=str(e))

    def UpdateEntry(self, request, context):
        self.filer.update_entry(
            request.directory, request.entry,
            from_other_cluster=request.is_from_other_cluster,
            signatures=list(request.signatures))
        self._maybe_reload_conf(
            join_path(request.directory, request.entry.name))
        return filer_pb2.UpdateEntryResponse()

    def AppendToEntry(self, request, context):
        self.filer.append_chunks(
            join_path(request.directory, request.entry_name),
            list(request.chunks))
        return filer_pb2.AppendToEntryResponse()

    def DeleteEntry(self, request, context):
        try:
            self.filer.delete_entry(
                join_path(request.directory, request.name),
                recursive=request.is_recursive,
                ignore_recursive_error=request.ignore_recursive_error,
                delete_data=request.is_delete_data,
                from_other_cluster=request.is_from_other_cluster,
                signatures=list(request.signatures))
            self._maybe_reload_conf(
                join_path(request.directory, request.name))
            return filer_pb2.DeleteEntryResponse()
        except FilerError as e:
            return filer_pb2.DeleteEntryResponse(error=str(e))

    def AtomicRenameEntry(self, request, context):
        try:
            self.filer.atomic_rename(
                request.old_directory, request.old_name,
                request.new_directory, request.new_name)
        except NotFound:
            context.abort(rpc.StatusCode.NOT_FOUND,
                          f"{request.old_directory}/{request.old_name}")
        self._maybe_reload_conf(
            join_path(request.old_directory, request.old_name),
            join_path(request.new_directory, request.new_name))
        return filer_pb2.AtomicRenameEntryResponse()

    # -- gRPC: volume plumbing ------------------------------------------------

    def AssignVolume(self, request, context):
        try:
            a = self._assign(request.collection, request.replication,
                             request.ttl_sec, request.data_center)
        except RuntimeError as e:
            return filer_pb2.AssignVolumeResponse(error=str(e))
        return filer_pb2.AssignVolumeResponse(
            file_id=a.fid, url=a.url, public_url=a.public_url,
            count=a.count,
            collection=request.collection or self.collection,
            replication=request.replication or self.replication)

    def LookupVolume(self, request, context):
        """All requested vids resolve in ONE batched master round trip
        (operations.lookup_many: misses fuse through the coalescing
        cache when -meta.lookupTTL arms it; disabled it loops the
        same per-vid RPCs the old code made). Per-vid failures — and
        unparseable vids — answer as empty location lists, exactly
        like the old per-vid error handling (ROADMAP item 4
        residual)."""
        resp = filer_pb2.LookupVolumeResponse()
        vids = {}
        for vid_s in request.volume_ids:
            try:
                vids[int(vid_s)] = None
            except ValueError:
                pass
        got = operations.lookup_many(self.master_url, list(vids)) \
            if vids else {}
        for vid_s in dict.fromkeys(request.volume_ids):
            locs = resp.locations_map[vid_s]
            try:
                urls = got.get(int(vid_s), [])
            except ValueError:
                urls = []
            for u in urls:
                locs.locations.add(url=u, public_url=u)
        return resp

    def CollectionList(self, request, context):
        resp = master_stub(self.master_url).CollectionList(
            master_pb2.CollectionListRequest(
                include_normal_volumes=request.include_normal_volumes,
                include_ec_volumes=request.include_ec_volumes))
        return filer_pb2.CollectionListResponse(
            collections=[filer_pb2.Collection(name=c.name)
                         for c in resp.collections])

    def DeleteCollection(self, request, context):
        master_stub(self.master_url).CollectionDelete(
            master_pb2.CollectionDeleteRequest(name=request.collection))
        return filer_pb2.DeleteCollectionResponse()

    def Statistics(self, request, context):
        resp = master_stub(self.master_url).Statistics(
            master_pb2.StatisticsRequest(
                replication=request.replication,
                collection=request.collection, ttl=request.ttl))
        return filer_pb2.StatisticsResponse(
            total_size=resp.total_size, used_size=resp.used_size,
            file_count=resp.file_count)

    def GetFilerConfiguration(self, request, context):
        return filer_pb2.GetFilerConfigurationResponse(
            masters=[self.master_url], replication=self.replication,
            collection=self.collection,
            max_mb=self.chunk_size >> 20,
            dir_buckets="/buckets", cipher=self.cipher)

    # -- gRPC: subscriptions --------------------------------------------------

    def SubscribeMetadata(self, request, context):
        """Cluster-wide merged stream when peers are configured (the
        MetaAggregator view); the local log otherwise.

        `since` advances past EVERY scanned record, matching or not —
        advancing only on yielded records made a prefix subscriber spin
        at 100% CPU once any unrelated event existed (the wait call saw
        newer data and returned immediately, forever)."""
        if self.meta_aggregator is not None:
            agg = self.meta_aggregator
            since = request.since_ns
            while context.is_active() and not self._stopping:
                ver = agg.version  # read BEFORE scanning: no lost wakeups
                events = agg.events_since(since)
                since, matching = _advance_and_filter(
                    events, request.path_prefix, since)
                yield from matching
                if not events:
                    agg.wait_for_version(ver, timeout=0.5)
            return
        yield from self.SubscribeLocalMetadata(request, context)

    def SubscribeLocalMetadata(self, request, context):
        since = request.since_ns
        while context.is_active() and not self._stopping:
            events = self.filer.meta_log.read_events_since(since)
            since, matching = _advance_and_filter(
                events, request.path_prefix, since)
            yield from matching
            if not events:
                self.filer.meta_log.wait_for_data(since, timeout=0.5)

    # -- gRPC: broker registration / discovery --------------------------------

    def KeepConnected(self, request_iterator, context):
        """Peers (message brokers) hold this stream open, advertising
        their gRPC address and owned resources; LocateBroker answers
        from the live set (reference filer_grpc_server.go
        KeepConnected/LocateBroker)."""
        from seaweedfs_tpu_torch.rpc import peer_ip
        key = None
        token = object()   # this stream's ownership marker: a quickly
        # reconnecting broker reuses the same (name, addr) key, and the
        # OLD stream's teardown must not deregister the NEW stream
        try:
            for req in request_iterator:
                new_key = (req.name,
                           f"{peer_ip(context)}:{req.grpc_port}")
                with self._broker_lock:
                    if key is not None and key != new_key:
                        cur = self._brokers.get(key)
                        if cur and cur[0] is token:
                            # re-advertised identity: drop our old entry
                            self._brokers.pop(key, None)
                    key = new_key
                    self._brokers[key] = (token, list(req.resources))
                yield filer_pb2.KeepConnectedResponse()
                if not context.is_active() or self._stopping:
                    break
        finally:
            if key is not None:
                with self._broker_lock:
                    cur = self._brokers.get(key)
                    if cur and cur[0] is token:
                        self._brokers.pop(key, None)

    def LocateBroker(self, request, context):
        with self._broker_lock:
            brokers = {addr: res for (_n, addr), (_tok, res)
                       in self._brokers.items()}
        for addr, resources in brokers.items():
            if request.resource in resources:
                return filer_pb2.LocateBrokerResponse(
                    found=True,
                    resources=[filer_pb2.LocateBrokerResponse.Resource(
                        grpc_addresses=addr,
                        resource_count=len(resources))])
        return filer_pb2.LocateBrokerResponse(
            found=False,
            resources=[filer_pb2.LocateBrokerResponse.Resource(
                grpc_addresses=addr, resource_count=len(res))
                for addr, res in sorted(brokers.items())])

    # -- gRPC: KV -------------------------------------------------------------

    def KvGet(self, request, context):
        v = self.filer.store.kv_get(request.key)
        if v is None:
            return filer_pb2.KvGetResponse(error="not found")
        return filer_pb2.KvGetResponse(value=v)

    def KvPut(self, request, context):
        self.filer.store.kv_put(request.key, request.value)
        return filer_pb2.KvPutResponse()


# -- HTTP layer ---------------------------------------------------------------


def _entry_json(e: filer_pb2.Entry, directory: str) -> dict:
    return {
        "FullPath": join_path(directory, e.name),
        "Mtime": e.attributes.mtime,
        "Crtime": e.attributes.crtime,
        "Mode": e.attributes.file_mode,
        "Uid": e.attributes.uid,
        "Gid": e.attributes.gid,
        "Mime": e.attributes.mime,
        "Replication": e.attributes.replication,
        "Collection": e.attributes.collection,
        "TtlSec": e.attributes.ttl_sec,
        "FileSize": filechunks.total_size(e.chunks),
        "IsDirectory": e.is_directory,
        "chunks": len(e.chunks),
    }


def _make_http_handler(fs: FilerServer):
    class Handler(FastHandler):
        protocol_version = "HTTP/1.1"
        disable_nagle_algorithm = True  # small replies must not wait on delayed ACKs

        def log_message(self, fmt, *args):
            pass

        def _reply(self, code: int, body: bytes = b"",
                   headers: Optional[dict] = None) -> None:
            self.send_response(code)
            for k, v in (headers or {}).items():
                self.send_header(k, v)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            if self.command != "HEAD" and body:
                self.wfile.write(body)

        def _json(self, obj, code: int = 200,
                  headers: Optional[dict] = None) -> None:
            hs = {"Content-Type": "application/json"}
            hs.update(headers or {})
            self._reply(code, json.dumps(obj).encode(), hs)

        def _path_and_params(self):
            u = urllib.parse.urlparse(self.path)
            return (urllib.parse.unquote(u.path) or "/",
                    urllib.parse.parse_qs(u.query))

        def _body(self) -> bytes:
            # framing-aware (Content-Length or chunked), identical on
            # both server models
            return self.read_body()

        # -- read -------------------------------------------------------------

        def do_GET(self):
            path, params = self._path_and_params()
            if path in ("/debug/trace", "/debug/requests"):
                # reserved collector/flight-recorder paths (never
                # namespace lookups): cluster.trace fans out over the
                # filer's data port like every other role
                from seaweedfs_tpu_torch.stats import cluster_trace
                self._json(cluster_trace.debug_payload(
                    self.path, "filer", fs.url))
                return
            try:
                entry = fs.filer.find_entry(path)
            except NotFound:
                self._json({"error": f"{path} not found"}, code=404)
                return
            if entry.is_directory:
                if self.headers.get("x-sw-object-only"):
                    # gateway proxy mode (S3): a directory is not an
                    # object — 404 instead of a listing, so the gateway
                    # can proxy GETs in one hop without a pre-lookup
                    self._json({"error": f"{path} is a directory"},
                               code=404)
                    return
                self._list_dir(path, params)
                return
            self._serve_file(path, entry)

        do_HEAD = do_GET

        def _list_dir(self, path: str, params: dict) -> None:
            try:
                limit = int(params.get("limit", ["100"])[0])
            except ValueError:
                self._json({"error": "bad limit"}, code=400)
                return
            last = params.get("lastFileName", [""])[0]
            entries = fs.filer.list_entries(path, start_name=last,
                                            inclusive=False, limit=limit)
            # browsers get the directory-browser UI (reference
            # weed/server/filer_ui/ renders HTML when the client
            # accepts it; API clients keep the JSON listing)
            if "text/html" in (self.headers.get("Accept") or ""):
                self._list_dir_html(path, entries)
                return
            self._json({
                "Path": path,
                "Entries": [_entry_json(e, path) for e in entries],
                "Limit": limit,
                "LastFileName": entries[-1].name if entries else "",
                "ShouldDisplayLoadMore": len(entries) == limit,
            })

        def _list_dir_html(self, path: str, entries) -> None:
            import html as _html

            def link(p: str) -> str:
                # percent-encode THEN html-escape: names may contain
                # URL-reserved chars (#, ?, %) the browser would
                # otherwise misparse out of the href
                return _html.escape(urllib.parse.quote(p), quote=True)

            crumbs, acc = ['<a href="/">/</a>'], ""
            for part in [p for p in path.split("/") if p]:
                acc += "/" + part
                crumbs.append(
                    f'<a href="{link(acc)}/">{_html.escape(part)}</a>')
            rows = []
            for e in entries:
                href = link(join_path(path, e.name))
                name = _html.escape(e.name)
                if e.is_directory:
                    rows.append(
                        f'<tr><td><a href="{href}/">{name}/</a></td>'
                        "<td>-</td></tr>")
                else:
                    # same size formula as the JSON listing and the
                    # file-serving path (filechunks.total_size)
                    size = filechunks.total_size(e.chunks)
                    rows.append(
                        f'<tr><td><a href="{href}">{name}</a></td>'
                        f"<td>{size}</td></tr>")
            body = ("<html><head><title>seaweedfs-tpu filer</title>"
                    "</head><body>"
                    f"<h1>Filer {fs.ip}:{fs.port}</h1>"
                    f"<p>{' / '.join(crumbs)}</p>"
                    "<table border=1 cellpadding=4>"
                    "<tr><th>name</th><th>size</th></tr>"
                    + "".join(rows) + "</table></body></html>").encode()
            self.send_response(200)
            self.send_header("Content-Type", "text/html; charset=utf-8")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            if self.command != "HEAD":
                self.wfile.write(body)

        def _serve_file(self, path: str, entry: filer_pb2.Entry) -> None:
            size = filechunks.total_size(entry.chunks)
            etag = f'"{filechunks.etag_of_chunks(list(entry.chunks))}"' \
                if entry.chunks else '""'
            if self.headers.get("If-None-Match") == etag:
                self._reply(304)
                return
            headers = {"ETag": etag, "Accept-Ranges": "bytes"}
            if entry.attributes.mime:
                headers["Content-Type"] = entry.attributes.mime
            rng = self.headers.get("Range")
            offset, length, code = 0, size, 200
            if rng and rng.startswith("bytes="):
                try:
                    start_s, _, end_s = rng[len("bytes="):].partition("-")
                    if not start_s:
                        offset = max(0, size - int(end_s))
                        end = size - 1
                    else:
                        offset = int(start_s)
                        end = min(int(end_s) if end_s else size - 1,
                                  size - 1)
                    if offset > end or offset < 0:
                        raise ValueError
                    length = end - offset + 1
                    headers["Content-Range"] = \
                        f"bytes {offset}-{end}/{size}"
                    code = 206
                except ValueError:
                    # RFC 7233 §4.4: 416 carries the representation size
                    self._reply(416, headers={
                        "Content-Range": f"bytes */{size}"})
                    return
            if self.command == "HEAD":
                headers["Content-Length"] = str(length)
                self.send_response(code)
                for k, v in headers.items():
                    self.send_header(k, v)
                self.end_headers()
                return
            if fs.master_client.lookup_cache_enabled:
                # only chunks the requested window actually touches: a
                # 1KB Range read of a 10,000-chunk file must not
                # resolve 10,000 vids the stream will never fetch
                chunk_vids = {int(c.file_id.split(",")[0])
                              for c in entry.chunks
                              if c.file_id and c.offset < offset + length
                              and c.offset + c.size > offset}
                if len(chunk_vids) > 1:
                    # resolve every chunk's volume in ONE batched
                    # master round trip; the per-chunk lookups inside
                    # stream_content then answer from the cache (a
                    # 64-chunk file used to cost up to 64 round trips)
                    fs.master_client.lookup_many(chunk_vids)
            try:
                data = b"".join(stream.stream_content(
                    fs.lookup_fid_urls, list(entry.chunks), offset,
                    length, cache=fs.chunk_cache, hedger=fs.hedger))
            except _deadline.DeadlineExceeded as e:
                self._json({"error": str(e)}, code=504)
                return
            except IOError as e:
                # the FAILED chunk's fetch exhausted every replica the
                # lookup returned: drop that vid's cached belief so
                # the retry re-asks the master. The error text is
                # authoritative for WHICH vid (manifest-inner chunks
                # never appear in entry.chunks, so no membership
                # check); unrecognized text invalidates NOTHING —
                # blanket-dropping all 64 would turn one bad volume
                # into a 64-vid re-resolve storm on every retry.
                import re as _re
                m = _re.search(r"fetch (\d+),", str(e))
                if m:
                    fs.master_client.invalidate_lookup(int(m.group(1)))
                self._json({"error": str(e)}, code=500)
                return
            self._reply(code, data, headers)

        # -- write ------------------------------------------------------------

        def do_POST(self):
            path, params = self._path_and_params()
            ctype = self.headers.get("Content-Type") or ""
            clen = int(self.headers.get("Content-Length") or 0)
            # multi-chunk non-multipart bodies stream off the socket
            # chunk by chunk (read overlaps upload; the body is never
            # resident). Any reply sent before the body is drained must
            # drop the connection — leftover body bytes would desync
            # the next keep-alive request.
            streaming = (clen > fs.chunk_size
                         and not ctype.startswith("multipart/form-data"))
            body = b"" if streaming else self._body()
            filename, mime, data = "", ctype, body
            if ctype.startswith("multipart/form-data"):
                from seaweedfs_tpu_torch.server.volume import parse_multipart
                try:
                    filename, mime, data, enc = parse_multipart(ctype, body)
                    if enc == "gzip":
                        data = compression.decompress(data)
                except ValueError as e:
                    self._json({"error": str(e)}, code=400)
                    return
            if path.endswith("/"):
                path = path + filename if filename else path[:-1]
            directory, name = split_path(path)
            if not name:
                self.close_connection = streaming or self.close_connection
                self._json({"error": "cannot write to /"}, code=400)
                return
            collection = params.get("collection", [""])[0]
            replication = params.get("replication", [""])[0]
            ttl_param = params.get("ttl", [""])[0]
            rule = fs.filer_conf.match(join_path(directory, name))
            fsync = "fsync" in params
            if rule is not None:
                collection = collection or rule.collection
                replication = replication or rule.replication
                ttl_param = ttl_param or rule.ttl
                fsync = fsync or rule.fsync
            try:
                ttl_sec = _parse_ttl_seconds(ttl_param)
            except ValueError:
                self.close_connection = streaming or self.close_connection
                self._json({"error": "bad ttl"}, code=400)
                return
            try:
                if streaming:
                    chunks = fs.upload_stream_to_chunks(
                        self.rfile, clen, collection=collection,
                        replication=replication, ttl_sec=ttl_sec,
                        mime=mime, fsync=fsync)
                    data_size = clen
                else:
                    chunks = fs.upload_to_chunks(
                        data, collection=collection,
                        replication=replication, ttl_sec=ttl_sec,
                        mime=mime, fsync=fsync)
                    data_size = len(data)
                chunks = maybe_manifestize(fs.save_manifest_blob, chunks)
            except _deadline.DeadlineExceeded as e:
                # the client's budget ran out mid-ingest: the remaining
                # chunks were never uploaded, and the 504 says so
                # before the filer wastes more work on an abandoned body
                self.close_connection = streaming or self.close_connection
                self._json({"error": str(e)}, code=504)
                return
            except (RuntimeError, OSError) as e:
                # mid-stream failure: part of the body may still sit
                # unread on the socket
                self.close_connection = streaming or self.close_connection
                self._json({"error": str(e)}, code=500)
                return
            entry = new_entry(
                name, mime=mime if mime and
                mime != "application/octet-stream" else "",
                ttl_sec=ttl_sec, collection=collection,
                replication=replication)
            entry.chunks.extend(chunks)
            try:
                fs.filer.create_entry(directory, entry)
            except FilerError as e:
                self._json({"error": str(e)}, code=500)
                return
            fs._maybe_reload_conf(join_path(directory, name))
            self._json({"name": name, "size": data_size}, code=201,
                       headers={"ETag": filechunks.etag_of_chunks(chunks)})

        do_PUT = do_POST

        # -- delete -----------------------------------------------------------

        def do_DELETE(self):
            path, params = self._path_and_params()
            recursive = params.get("recursive", [""])[0] == "true"
            ignore = params.get("ignoreRecursiveError", [""])[0] == "true"
            try:
                fs.filer.delete_entry(path, recursive=recursive,
                                      ignore_recursive_error=ignore)
            except FilerError as e:
                self._json({"error": str(e)}, code=409)
                return
            self._reply(204)

    from seaweedfs_tpu_torch.stats.metrics import instrument_http_handler
    return instrument_http_handler(Handler, "filer")


def _parse_ttl_seconds(s: str) -> int:
    if not s:
        return 0
    units = {"s": 1, "m": 60, "h": 3600, "d": 86400, "w": 604800,
             "M": 2592000, "y": 31536000}
    if s[-1] in units:
        return int(s[:-1]) * units[s[-1]]
    return int(s)


def ttl_string(ttl_sec: int) -> str:
    """Seconds → the volume TTL grammar (count ≤ 255 + unit), rounding
    up to the smallest unit that fits (a volume TTL is one byte count +
    one byte unit, storage/superblock.py TTL.parse)."""
    if ttl_sec <= 0:
        return ""
    for suffix, secs in (("s", 1), ("m", 60), ("h", 3600), ("d", 86400),
                         ("w", 604800), ("M", 2592000), ("y", 31536000)):
        count = -(-ttl_sec // secs)  # ceil: never expire early
        if count <= 255:
            return f"{count}{suffix}"
    return "255y"
