"""Collection, cluster and lock commands (reference weed/shell:
command_collection_list.go, command_collection_delete.go,
command_fs_lock_unlock.go, cluster status); the part of
``seaweedfs_tpu.shell.command_misc`` the port carries.

``cluster.trace``, ``cluster.requests``, ``cluster.heat`` and
``cluster.qos`` arrive with observability and QoS (ROADMAP Queue 1 item
11): until then each answers with an error that says so.
"""

from __future__ import annotations

import argparse
from typing import List

from seaweedfs_tpu_torch.pb import master_pb2
from seaweedfs_tpu_torch.shell import command, refuse
from seaweedfs_tpu_torch.shell.command_env import CommandEnv


@command("collection.list", "list collections")
def collection_list(env: CommandEnv, argv: List[str], out) -> None:
    resp = env.master.CollectionList(master_pb2.CollectionListRequest(
        include_normal_volumes=True, include_ec_volumes=True))
    for c in resp.collections:
        out.write(f"collection: {c.name}\n")
    if not resp.collections:
        out.write("no named collections\n")


@command("collection.delete", "delete a collection cluster-wide")
def collection_delete(env: CommandEnv, argv: List[str], out) -> None:
    p = argparse.ArgumentParser(prog="collection.delete")
    p.add_argument("-collection", required=True)
    args = p.parse_args(argv)
    env.acquire_lock()
    try:
        env.master.CollectionDelete(master_pb2.CollectionDeleteRequest(
            name=args.collection))
        out.write(f"collection {args.collection} deleted\n")
    finally:
        env.release_lock()


@command("cluster.status", "master + topology summary")
def cluster_status(env: CommandEnv, argv: List[str], out) -> None:
    topo = env.topology()
    stats = env.master.Statistics(master_pb2.StatisticsRequest())
    out.write(f"master: {env.master_url}\n"
              f"volumes: {topo.volume_count}/{topo.max_volume_count}\n"
              f"used bytes: {stats.used_size}\n"
              f"files: {stats.file_count}\n")


@command("lock", "acquire the cluster admin lock")
def lock(env: CommandEnv, argv: List[str], out) -> None:
    env.acquire_lock()
    out.write("locked\n")


@command("unlock", "release the cluster admin lock")
def unlock(env: CommandEnv, argv: List[str], out) -> None:
    env.release_lock()
    out.write("unlocked\n")


for _name in ("cluster.trace", "cluster.requests", "cluster.heat",
              "cluster.qos"):
    refuse(_name, "observability and QoS (ROADMAP Queue 1 item 11)")
