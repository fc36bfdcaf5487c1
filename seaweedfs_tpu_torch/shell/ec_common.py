"""Pure EC placement planning over topology snapshots.

Separated from the RPC-applying commands so the plans are unit-testable
against fabricated cluster views, like the reference's
shell/command_ec_test.go pattern.

Reference: weed/shell/command_ec_common.go, command_ec_encode.go:248-264.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Tuple

from seaweedfs_tpu_torch.ec.shard_bits import ShardBits, TOTAL_SHARDS
from seaweedfs_tpu_torch.shell.command_env import EcNode


class ShardMove(NamedTuple):
    vid: int
    shard_ids: Tuple[int, ...]
    src: str  # node url holding the shard(s)
    dst: str


def balanced_distribution(nodes: List[EcNode], total: int = TOTAL_SHARDS
                          ) -> Dict[str, List[int]]:
    """Assign `total` shard ids over nodes, each next shard to the node
    with the most remaining free slots (reference
    balancedEcDistribution, command_ec_encode.go:248-264)."""
    if not nodes:
        return {}
    remaining = {n.url: max(n.free_slots, 0) for n in nodes}
    out: Dict[str, List[int]] = {n.url: [] for n in nodes}
    for sid in range(total):
        url = max(remaining, key=lambda u: (remaining[u], -len(out[u])))
        out[url].append(sid)
        remaining[url] -= 1
    return {u: sids for u, sids in out.items() if sids}


def plan_dedupe(nodes: List[EcNode]) -> List[Tuple[int, int, str]]:
    """(vid, shard_id, url_to_delete_from) for every duplicated shard;
    the copy on the node with the fewest total shards survives."""
    holders: Dict[Tuple[int, int], List[EcNode]] = {}
    for n in nodes:
        for vid, bits in n.shards.items():
            for sid in bits.shard_ids:
                holders.setdefault((vid, sid), []).append(n)
    deletes = []
    for (vid, sid), ns in holders.items():
        if len(ns) <= 1:
            continue
        ns_sorted = sorted(ns, key=lambda n: n.shard_count())
        for n in ns_sorted[1:]:
            deletes.append((vid, sid, n.url))
    return deletes


def plan_balance_across_racks(nodes: List[EcNode]) -> List[ShardMove]:
    """Per EC volume, cap each rack at ceil(shards/racks) shards and
    move the excess to the least-loaded node of an under-cap rack
    (reference command_ec_balance.go doBalanceEcShardsAcrossRacks):
    losing a whole rack must never cost more than a proportional share
    of one volume's shards."""
    import math
    racks = sorted({n.rack for n in nodes})
    if len(racks) < 2:
        return []
    by_url = {n.url: dict(n.shards) for n in nodes}
    loads = {n.url: n.shard_count() for n in nodes}
    slots = {n.url: max(n.free_slots, 0) for n in nodes}
    moves: List[ShardMove] = []
    vids = sorted({vid for n in nodes for vid in n.shards})
    for vid in vids:
        holders = {n.url: by_url[n.url].get(vid, ShardBits(0))
                   for n in nodes}
        total = sum(b.count for b in holders.values())
        if not total:
            continue
        cap = math.ceil(total / len(racks))
        per_rack = {r: sum(holders[n.url].count for n in nodes
                           if n.rack == r) for r in racks}
        for rack in racks:
            while per_rack[rack] > cap:
                # busiest holders first, and EVERY shard they hold is a
                # candidate — a single duplicated sid must not strand
                # the whole rack over cap
                placed = False
                for src in sorted(
                        (n for n in nodes if n.rack == rack
                         and holders[n.url].count),
                        key=lambda n: -holders[n.url].count):
                    for sid in holders[src.url].shard_ids:
                        under = [n for n in nodes
                                 if per_rack[n.rack] < cap
                                 and slots[n.url] > 0
                                 and not holders[n.url].has(sid)]
                        if not under:
                            continue
                        dst = min(under, key=lambda n: loads[n.url])
                        slots[dst.url] -= 1
                        slots[src.url] += 1
                        moves.append(ShardMove(vid, (sid,), src.url,
                                               dst.url))
                        holders[src.url] = holders[src.url].remove(sid)
                        holders[dst.url] = holders[dst.url].add(sid)
                        by_url[src.url][vid] = holders[src.url]
                        by_url[dst.url][vid] = holders[dst.url]
                        loads[src.url] -= 1
                        loads[dst.url] += 1
                        per_rack[rack] -= 1
                        per_rack[dst.rack] += 1
                        placed = True
                        break
                    if placed:
                        break
                if not placed:
                    break
    return moves


def apply_moves_to_nodes(nodes: List[EcNode],
                         moves: List[ShardMove]) -> List[EcNode]:
    """The node view after a plan executes (shards AND free slots) —
    lets the within-rack pass plan on top of the across-racks pass
    without a topology refetch."""
    by_url = {n.url: dict(n.shards) for n in nodes}
    slots = {n.url: n.free_slots for n in nodes}
    for mv in moves:
        for sid in mv.shard_ids:
            src = by_url[mv.src].get(mv.vid, ShardBits(0)).remove(sid)
            if src.count:
                by_url[mv.src][mv.vid] = src
            else:
                by_url[mv.src].pop(mv.vid, None)
            by_url[mv.dst][mv.vid] = \
                by_url[mv.dst].get(mv.vid, ShardBits(0)).add(sid)
            slots[mv.src] += 1
            slots[mv.dst] -= 1
    return [n._replace(shards=by_url[n.url],
                       free_slots=slots[n.url]) for n in nodes]


def plan_balance(nodes: List[EcNode]) -> List[ShardMove]:
    """Even out total shard counts across nodes (reference
    ec.balance's doBalanceEcShardsAcrossRacks simplified to node
    granularity; rack awareness comes from the move target choice)."""
    if len(nodes) < 2:
        return []
    counts = {n.url: n.shard_count() for n in nodes}
    by_url = {n.url: dict(n.shards) for n in nodes}
    slots = {n.url: max(n.free_slots, 0) for n in nodes}
    total = sum(counts.values())
    moves: List[ShardMove] = []
    # move shards one at a time from the fullest node to the emptiest
    # node with free capacity; a spread of <= 1 is balanced (moving
    # would just ping-pong a shard back and forth — regression: odd
    # totals over two nodes oscillated until the loop bound)
    for _ in range(total):
        src = max(counts, key=lambda u: counts[u])
        with_room = [u for u in counts if slots[u] > 0 and u != src]
        if not with_room:
            break
        dst = min(with_room, key=lambda u: counts[u])
        if counts[src] - counts[dst] <= 1:
            break
        moved = False
        for vid, bits in sorted(by_url[src].items()):
            dst_bits = by_url[dst].get(vid, ShardBits(0))
            for sid in bits.shard_ids:
                if dst_bits.has(sid):
                    continue
                moves.append(ShardMove(vid, (sid,), src, dst))
                by_url[src][vid] = bits.remove(sid)
                if not by_url[src][vid].count:
                    del by_url[src][vid]
                by_url[dst][vid] = dst_bits.add(sid)
                counts[src] -= 1
                counts[dst] += 1
                slots[src] += 1
                slots[dst] -= 1
                moved = True
                break
            if moved:
                break
        if not moved:
            break
    return moves


def missing_shards(nodes: List[EcNode], vid: int) -> List[int]:
    have = ShardBits(0)
    for n in nodes:
        have = have.plus(n.shards.get(vid, ShardBits(0)))
    return [sid for sid in range(TOTAL_SHARDS) if not have.has(sid)]


def pick_rebuilder(nodes: List[EcNode]) -> EcNode:
    """The roomiest node does the rebuild (reference
    command_ec_rebuild.go:97-150)."""
    return max(nodes, key=lambda n: n.free_slots)
