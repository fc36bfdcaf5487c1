"""CommandEnv: what every shell command gets to work with.

Wraps the master connection, the exclusive admin lock, and typed
accessors over the TopologyInfo snapshot.

Reference: weed/shell/commands.go:35-79, command_ec_common.go.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional

import posixpath

from seaweedfs_tpu_torch.ec.shard_bits import ShardBits
from seaweedfs_tpu_torch import rpc
from seaweedfs_tpu_torch.pb import (filer_pb2, filer_stub, master_pb2,
                                    master_stub, volume_stub)


class EcNode(NamedTuple):
    """One data node as the EC commands see it."""
    url: str
    free_slots: int
    shards: Dict[int, ShardBits]  # vid -> bits held on this node
    rack: str = ""                # "dc/rack" (ec.balance rack pass)

    def shard_count(self) -> int:
        return sum(b.count for b in self.shards.values())


class VolumeReplica(NamedTuple):
    url: str
    info: "master_pb2.VolumeInformationMessage"


class CommandEnv:
    def __init__(self, master_url: str, filer_url: str = ""):
        self.master_url = master_url
        self.filer_url = filer_url  # host:port of the filer HTTP port
        self.cwd = "/"              # fs.* current directory (fs.cd)
        self._lock_token = 0
        self._lock_depth = 0

    @property
    def master(self):
        return master_stub(self.master_url)

    def volume_server(self, url: str):
        return volume_stub(url)

    # -- filer access (fs.* family) ------------------------------------------

    @property
    def filer(self):
        if not self.filer_url:
            raise ValueError(
                "no filer configured: start the shell with -filer "
                "<host:port> to use fs.* commands")
        return filer_stub(self.filer_url)

    def resolve_path(self, arg: str) -> str:
        """Resolve a command path argument against the fs.cd cwd
        (reference shell/commands.go parseUrl/Directory)."""
        if not arg or arg == ".":
            arg = self.cwd
        if not arg.startswith("/"):
            arg = posixpath.join(self.cwd, arg)
        norm = posixpath.normpath(arg)
        return norm if norm.startswith("/") else "/"

    def filer_entry(self, path: str):
        """Entry proto at `path`, or None."""
        directory, name = posixpath.split(path.rstrip("/") or "/")
        if not name:  # the root
            return filer_pb2.Entry(name="/", is_directory=True)
        try:
            return self.filer.LookupDirectoryEntry(
                filer_pb2.LookupDirectoryEntryRequest(
                    directory=directory or "/", name=name)).entry
        except rpc.RpcError as e:
            if e.code() == rpc.StatusCode.NOT_FOUND:
                return None
            raise

    def list_filer_entries(self, directory: str, prefix: str = "",
                           batch: int = 1024):
        """All entries under a directory, paginated like the reference
        (filer_pb.List: re-issue from the last seen name). Only an
        EMPTY page terminates: the server filters TTL-expired entries
        after applying the store limit, so a short page can still have
        entries beyond it."""
        start, inclusive = "", True
        while True:
            got = 0
            for r in self.filer.ListEntries(filer_pb2.ListEntriesRequest(
                    directory=directory, prefix=prefix,
                    start_from_file_name=start,
                    inclusive_start_from=inclusive, limit=batch)):
                got += 1
                start, inclusive = r.entry.name, False
                yield r.entry
            if got == 0:
                return

    # -- admin lock ----------------------------------------------------------

    def acquire_lock(self) -> None:
        """Lease (or renew) the cluster admin lock. Nestable: an
        explicit `lock` shell command brackets a script list, and each
        command's own acquire/release pair must renew rather than drop
        the outer bracket (reference exclusive_locker renews one
        long-lived lease the same way)."""
        resp = self.master.LeaseAdminToken(
            master_pb2.LeaseAdminTokenRequest(
                previous_token=self._lock_token, lock_name="admin"))
        self._lock_token = resp.token
        self._lock_depth += 1

    def release_lock(self) -> None:
        if not self._lock_token:
            return
        self._lock_depth -= 1
        if self._lock_depth > 0:
            return  # still bracketed by an outer `lock`
        self.master.ReleaseAdminToken(
            master_pb2.ReleaseAdminTokenRequest(
                previous_token=self._lock_token))
        self._lock_token = 0

    # -- topology snapshot ----------------------------------------------------

    def topology(self) -> master_pb2.TopologyInfo:
        return self.master.VolumeList(
            master_pb2.VolumeListRequest()).topology_info

    def volume_size_limit(self) -> int:
        return self.master.VolumeList(
            master_pb2.VolumeListRequest()).volume_size_limit_mb << 20

    @staticmethod
    def data_nodes(topo: master_pb2.TopologyInfo):
        for dc in topo.data_center_infos:
            for rack in dc.rack_infos:
                for dn in rack.data_node_infos:
                    yield dc.id, rack.id, dn

    def collect_volume_replicas(
            self, topo: Optional[master_pb2.TopologyInfo] = None
    ) -> Dict[int, List[VolumeReplica]]:
        topo = topo or self.topology()
        out: Dict[int, List[VolumeReplica]] = {}
        for _, _, dn in self.data_nodes(topo):
            for vi in dn.volume_infos:
                out.setdefault(vi.id, []).append(VolumeReplica(dn.id, vi))
        return out

    def collect_ec_nodes(
            self, topo: Optional[master_pb2.TopologyInfo] = None
    ) -> List[EcNode]:
        topo = topo or self.topology()
        nodes = []
        for dc, rack, dn in self.data_nodes(topo):
            shards = {e.id: ShardBits(e.ec_index_bits)
                      for e in dn.ec_shard_infos}
            nodes.append(EcNode(dn.id, int(dn.free_volume_count), shards,
                                rack=f"{dc}/{rack}"))
        return nodes

    def lookup(self, vid: int, collection: str = "") -> List[str]:
        from seaweedfs_tpu_torch.wdclient import lookup_cache
        if lookup_cache.enabled:
            # looped lookups over a topology coalesce into batched round
            # trips and repeats answer locally; an error is [] as below
            return [l.url for l in lookup_cache.for_master(
                self.master_url, collection).lookup(vid).locations]
        resp = self.master.LookupVolume(master_pb2.LookupVolumeRequest(
            volume_ids=[str(vid)], collection=collection))
        for vl in resp.volume_id_locations:
            return [l.url for l in vl.locations]
        return []
