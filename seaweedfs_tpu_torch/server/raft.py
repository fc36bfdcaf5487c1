"""Raft consensus for a set of masters.

The port of ``seaweedfs_tpu.server.raft``. The reference embeds the
chrislusf/raft library (weed/server/raft_server.go:21-160): one leader
among an odd number of masters, elected by vote, replicating a small
control-plane log (max volume id, file-id sequence watermarks) and
redirecting writes to the leader. This module is a compact Raft with the
same role, over the port's RPC transport (``rpc.py``, ``pb/raft_pb2``):

- roles follower/candidate/leader, randomized election timeouts,
  leader heartbeats (AppendEntries) over the master's own RPC server,
  replicated to all peers in parallel so one hung peer cannot starve
  the live ones of heartbeats;
- persistent state under the master's -mdir (reference: raft log dir =
  -mdir, command/master.go:118), split per Raft's durability rules:
  `raft.meta.json` (term + vote, fsync'd BEFORE any vote/term reply
  leaves the node — the double-vote window a crash must never reopen),
  `raft.wal` (append-only entry log: JSON records, fsync per append
  batch, replayed on load; torn tails are cut), and `raft.snap.json`
  (state-machine snapshot + log base, written at compaction once the
  log exceeds LOG_CAP, after which the WAL is rewritten to the tail).
  Followers that fall behind the compacted base receive the snapshot
  piggybacked on AppendEntries;
- ``propose()`` replicates a command to a quorum before applying it to
  the state machine on every node (commands: max volume id bumps and
  sequence watermarks — the same state the reference snapshots).

A single-node configuration (no peers) short-circuits to permanent
leadership so the single-master deployment keeps zero overhead.

The files under -mdir are the JAX package's, byte for byte in format, so a
master's meta directory moves between the two packages either way.
"""

from __future__ import annotations

import concurrent.futures
import json
import os
import random
import threading
import time
from typing import Callable, Dict, List, Optional

from seaweedfs_tpu_torch import rpc
from seaweedfs_tpu_torch.pb import raft_pb2, raft_stub
from seaweedfs_tpu_torch.util import wlog

log = wlog.logger("raft")

FOLLOWER, CANDIDATE, LEADER = "follower", "candidate", "leader"


class NotLeader(Exception):
    def __init__(self, leader: Optional[str]):
        super().__init__(f"not the raft leader; leader is {leader or '?'}")
        self.leader = leader


class RaftNode:
    """One master's raft participant.

    apply(command: dict, term: int) is invoked, in log order, exactly
    once per committed entry on every live node (and again on restart
    replay — commands must be idempotent, which max/watermark bumps
    are); the entry's term lets the state machine tell the sitting
    leader's own proposals from replayed prior-term entries.
    snapshot_fn() returns the full state-machine state as a JSON-able
    dict; restore_fn(state) reinstalls it (used for log compaction and
    for catching up far-behind followers).
    """

    LOG_CAP = 1024  # compact the log into a snapshot beyond this

    def __init__(self, my_url: str, peer_urls: List[str],
                 meta_dir: Optional[str],
                 apply: Callable[[dict, int], None],
                 snapshot_fn: Optional[Callable[[], dict]] = None,
                 restore_fn: Optional[Callable[[dict], None]] = None,
                 election_timeout: float = 0.5,
                 heartbeat_interval: float = 0.1):
        self.my_url = my_url
        self.peers = [p for p in peer_urls if p and p != my_url]
        self.meta_dir = meta_dir
        self.apply = apply
        self.snapshot_fn = snapshot_fn or (lambda: {})
        self.restore_fn = restore_fn or (lambda state: None)
        self.election_timeout = election_timeout
        self.heartbeat_interval = heartbeat_interval

        self._lock = threading.RLock()
        self.state = FOLLOWER if self.peers else LEADER
        self.current_term = 0
        self.voted_for: Optional[str] = None
        # log[0] is the compaction sentinel: (base index, base term);
        # real entries follow. Initially (0, 0) = empty log.
        self.log: List[dict] = [{"index": 0, "term": 0, "command": None}]
        self.snapshot_state: dict = {}
        self.commit_index = 0
        self.last_applied = 0
        self.leader_url: Optional[str] = self.my_url if not self.peers \
            else None
        self._next_index: Dict[str, int] = {}
        self._match_index: Dict[str, int] = {}
        self._last_heard = time.monotonic()
        self._commit_cv = threading.Condition(self._lock)
        # the ticker polls lock-free; stop() writes under the lock
        self._stopped = False  # guarded_by(self._lock, writes)
        self._threads: List[threading.Thread] = []
        self._inflight: set = set()  # peers with a replicate RPC in flight
        # lint: thread-ok(consensus RPC fan-out pool; raft owns its own timeouts)
        self._pool = concurrent.futures.ThreadPoolExecutor(
            max_workers=max(1, len(self.peers)),
            thread_name_prefix="raft-repl") if self.peers else None
        self._wal_file = None  # guarded_by(self._lock)
        self._wal_epoch = 0
        self._load_state()

    # -- log index helpers (base-relative) ------------------------------------

    def _base(self) -> int:
        return self.log[0]["index"]

    def _last_index(self) -> int:
        return self.log[-1]["index"]

    def _get(self, index: int) -> dict:
        return self.log[index - self._base()]

    # -- persistence ---------------------------------------------------------
    #
    # Three files under -mdir (see module docstring): meta (term+vote,
    # fsync'd before any reply that depends on it), an append-only WAL
    # of entry/truncate records, and the compaction snapshot.

    def _path(self, name: str) -> Optional[str]:
        return os.path.join(self.meta_dir, name) if self.meta_dir else None

    @staticmethod
    def _fsync_replace(path: str, payload: str) -> None:
        """Write-fsync-rename-fsyncdir: the file is durably either the
        old or the new content, never torn."""
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            f.write(payload)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
        dirfd = os.open(os.path.dirname(path) or ".", os.O_RDONLY)
        try:
            os.fsync(dirfd)
        finally:
            os.close(dirfd)

    def _save_meta(self) -> None:
        """Persist term + vote. MUST complete before the vote/term is
        acted on: a crash after granting a vote but before persisting
        it lets the node vote twice in the term (Raft §5.2 persistence
        rules) — exactly what the fsync closes."""
        p = self._path("raft.meta.json")
        if not p:
            return
        os.makedirs(self.meta_dir, exist_ok=True)
        self._fsync_replace(p, json.dumps(
            {"term": self.current_term, "voted_for": self.voted_for}))

    def _wal_path(self, epoch: Optional[int] = None) -> Optional[str]:  # requires(self._lock)
        """The WAL is generation-stamped: the snapshot records which
        epoch it pairs with, so a crash between writing the snapshot
        and cleaning the previous WAL can never replay STALE entries
        against the new base (pre-truncate suffixes would resurrect
        and evict their committed replacements)."""
        e = self._wal_epoch if epoch is None else epoch
        return self._path(f"raft.wal.{e}")

    def _wal_handle(self):  # requires(self._lock)
        if self._wal_file is None and self.meta_dir:
            os.makedirs(self.meta_dir, exist_ok=True)
            self._wal_file = open(self._wal_path(), "ab")
        return self._wal_file

    def _wal_record(self, rec: dict) -> None:
        f = self._wal_handle()
        if f is None:
            return
        f.write(json.dumps(rec).encode() + b"\n")
        f.flush()
        os.fsync(f.fileno())

    def _wal_append(self, entries: List[dict]) -> None:
        f = self._wal_handle()
        if f is None:
            return
        for e in entries:
            f.write(json.dumps({"op": "append", "entry": e}).encode()
                    + b"\n")
        f.flush()
        os.fsync(f.fileno())

    def _wal_truncate_mark(self, from_index: int) -> None:
        self._wal_record({"op": "truncate", "from": from_index})

    def _save_snapshot(self) -> None:  # requires(self._lock)
        """Write (new-epoch WAL tail, then snapshot naming it, then
        remove the old WAL). The snapshot write is the commit point:
        crash before it keeps the old (snap, WAL) pair intact; crash
        after it loads the new pair — never a mix."""
        p = self._path("raft.snap.json")
        if not p:
            return
        os.makedirs(self.meta_dir, exist_ok=True)
        old_epoch = self._wal_epoch
        new_epoch = old_epoch + 1
        if self._wal_file is not None:
            self._wal_file.close()
            self._wal_file = None  # guarded_by(self._lock)
        payload = "".join(
            json.dumps({"op": "append", "entry": e}) + "\n"
            for e in self.log[1:])
        self._fsync_replace(self._wal_path(new_epoch), payload)
        self._fsync_replace(p, json.dumps(
            {"base_index": self._base(), "base_term": self.log[0]["term"],
             "snapshot": self.snapshot_state,
             "commit_index": self.commit_index,
             "wal_epoch": new_epoch}))
        self._wal_epoch = new_epoch
        old = self._wal_path(old_epoch)
        if os.path.exists(old):
            os.remove(old)

    def _load_state(self) -> None:  # requires(self._lock)
        if not self.meta_dir:
            return
        legacy = self._path("raft.json")
        if os.path.exists(legacy):
            # the legacy file alone gates migration: its removal is the
            # commit point, so a crash mid-migration just re-runs it
            # (idempotent — it overwrites all three new files)
            self._load_legacy(legacy)
            return
        snap_p = self._path("raft.snap.json")
        if os.path.exists(snap_p):
            with open(snap_p) as f:
                st = json.load(f)
            self.log = [{"index": st["base_index"],
                         "term": st["base_term"], "command": None}]
            self.snapshot_state = st.get("snapshot") or {}
            self.commit_index = st.get("commit_index", 0)
            self._wal_epoch = st.get("wal_epoch", 0)
        # drop WAL generations other than the snapshot's (a crash can
        # strand the next epoch's pre-commit file)
        if self.meta_dir and os.path.isdir(self.meta_dir):
            for name in os.listdir(self.meta_dir):
                if name.startswith("raft.wal.") and \
                        name != f"raft.wal.{self._wal_epoch}":
                    os.remove(os.path.join(self.meta_dir, name))
        wal_p = self._wal_path()
        if os.path.exists(wal_p):
            good = 0   # byte offset of the last intact record
            with open(wal_p, "rb") as f:
                for line in f:
                    if not line.endswith(b"\n"):
                        # record+newline go down in one fsynced write,
                        # so a newline-less tail was never acked — and
                        # keeping it would glue the next append onto
                        # its line, losing BOTH on the following replay
                        break
                    try:
                        rec = json.loads(line)
                    except ValueError:
                        break  # torn tail from a crash mid-append
                    good += len(line)
                    if rec["op"] == "append":
                        e = rec["entry"]
                        if e["index"] <= self._last_index():
                            continue  # idempotent replay
                        self.log.append(e)
                    elif rec["op"] == "truncate":
                        cut = rec["from"] - self._base()
                        if 1 <= cut <= len(self.log):
                            del self.log[cut:]
            if good != os.path.getsize(wal_p):
                # cut the torn bytes NOW, before reopening for append —
                # otherwise later appends land beyond garbage that every
                # future replay stops at
                with open(wal_p, "r+b") as f:
                    f.truncate(good)
        meta_p = self._path("raft.meta.json")
        if os.path.exists(meta_p):
            with open(meta_p) as f:
                st = json.load(f)
            self.current_term = st.get("term", 0)
            self.voted_for = st.get("voted_for")
        self._finish_load()

    def _load_legacy(self, path: str) -> None:
        """Upgrade path from the older single-file raft.json."""
        with open(path) as f:
            st = json.load(f)
        self.current_term = st.get("term", 0)
        self.voted_for = st.get("voted_for")
        self.log = st.get("log") or self.log
        self.snapshot_state = st.get("snapshot") or {}
        self.commit_index = st.get("commit_index", 0)
        self._save_meta()
        self._save_snapshot()  # also rewrites the WAL with the tail
        os.remove(path)
        self._finish_load()

    def _finish_load(self) -> None:
        base = self._base()
        if self.snapshot_state or base:
            self.restore_fn(self.snapshot_state)
        self.last_applied = base
        self.commit_index = max(self.commit_index, base)
        self.commit_index = min(self.commit_index, self._last_index())
        if not self.peers:
            # single-node: everything durably logged WAS committed (no
            # quorum to re-learn it from after a restart)
            self.commit_index = self._last_index()
        # replay committed entries beyond the snapshot base
        self._apply_committed()

    def _maybe_compact(self) -> None:
        """Fold applied entries into the snapshot once the log is long
        (caller holds the lock). Keeps the WAL and replay cost bounded."""
        if len(self.log) <= self.LOG_CAP or \
                self.last_applied <= self._base():
            return
        cut = self.last_applied
        sentinel = dict(self._get(cut))
        sentinel["command"] = None
        self.snapshot_state = self.snapshot_fn()
        self.log = [sentinel] + self.log[cut - self._base() + 1:]
        self._save_snapshot()
        log.info("%s: compacted raft log to base %d (%d entries kept)",
                 self.my_url, cut, len(self.log) - 1)

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> None:
        if not self.peers:
            return  # single master: no timers needed
        # lint: thread-ok(election/heartbeat daemon; no request context)
        t = threading.Thread(target=self._ticker, name="raft-ticker",
                             daemon=True)
        t.start()
        self._threads.append(t)

    def stop(self) -> None:
        with self._lock:
            self._stopped = True
            self._commit_cv.notify_all()
        for t in self._threads:
            t.join(timeout=2)
        if self._pool is not None:
            self._pool.shutdown(wait=False)
        with self._lock:
            if self._wal_file is not None:
                self._wal_file.close()
                self._wal_file = None  # guarded_by(self._lock)

    # -- role accessors ------------------------------------------------------

    @property
    def is_leader(self) -> bool:
        return self.state == LEADER

    def leader(self) -> Optional[str]:
        return self.leader_url

    # -- timers --------------------------------------------------------------

    def _ticker(self) -> None:
        while not self._stopped:
            with self._lock:
                state = self.state
            if state == LEADER:
                self._broadcast_heartbeat()
                time.sleep(self.heartbeat_interval)
            else:
                timeout = self.election_timeout * (1 + random.random())
                time.sleep(0.02)
                with self._lock:
                    heard = self._last_heard
                if time.monotonic() - heard > timeout:
                    self._run_election()

    # -- election ------------------------------------------------------------

    def _run_election(self) -> None:
        with self._lock:
            self.state = CANDIDATE
            self.current_term += 1
            term = self.current_term
            self.voted_for = self.my_url
            self.leader_url = None
            self._last_heard = time.monotonic()
            last = self.log[-1]
            self._save_meta()
        log.info("%s: starting election for term %d", self.my_url, term)

        def ask(peer):
            try:
                return raft_stub(peer).RequestVote(
                    raft_pb2.VoteRequest(
                        term=term, candidate_id=self.my_url,
                        last_log_index=last["index"],
                        last_log_term=last["term"]),
                    timeout=self.election_timeout)
            except rpc.RpcError:
                return None

        votes = 1
        for resp in self._pool.map(ask, self.peers):
            if resp is None:
                continue
            with self._lock:
                if resp.term > self.current_term:
                    self._become_follower(resp.term, None)
                    return
            if resp.vote_granted:
                votes += 1
        quorum = (len(self.peers) + 1) // 2 + 1
        with self._lock:
            if self.state != CANDIDATE or self.current_term != term:
                return
            if votes >= quorum:
                self.state = LEADER
                self.leader_url = self.my_url
                nxt = self._last_index() + 1
                self._next_index = {p: nxt for p in self.peers}
                self._match_index = {p: 0 for p in self.peers}
                # no-op entry in the new term: Raft only commits
                # prior-term entries indirectly, via a committed entry
                # of the current term (Raft §5.4.2) — without this, a
                # fresh leader would sit on uncommitted predecessors
                entry = {"index": nxt, "term": term, "command": None}
                self.log.append(entry)
                self._wal_append([entry])
                log.info("%s: won election for term %d (%d/%d votes)",
                         self.my_url, term, votes, len(self.peers) + 1)
        if self.is_leader:
            self._broadcast_heartbeat()

    def _become_follower(self, term: int, leader: Optional[str]) -> None:  # requires(self._lock)
        # caller holds self._lock
        if term > self.current_term:
            self.current_term = term
            self.voted_for = None
            self._save_meta()
        if self.state != FOLLOWER:
            log.info("%s: stepping down to follower (term %d, leader %s)",
                     self.my_url, term, leader)
        self.state = FOLLOWER
        if leader:
            self.leader_url = leader
        self._last_heard = time.monotonic()

    # -- replication (leader side) -------------------------------------------

    def _broadcast_heartbeat(self) -> None:
        """Fire-and-track replication to every peer.

        Never blocks on peer RPCs: a black-holed peer used to stretch
        the heartbeat cycle past the followers' election timeouts and
        flap the leadership. Instead each peer has
        at most one RPC in flight — a slow peer is simply skipped this
        tick while healthy peers keep their cadence — and commit
        advancement runs from each RPC's completion callback."""
        for p in self.peers:
            with self._lock:
                if p in self._inflight:
                    continue
                self._inflight.add(p)
            fut = self._pool.submit(self._replicate_to, p)
            fut.add_done_callback(
                lambda _f, peer=p: self._replication_done(peer))

    def _replication_done(self, peer: str) -> None:
        with self._lock:
            self._inflight.discard(peer)
        try:
            self._advance_commit()
        except Exception:
            log.exception("advance_commit failed after replicating to %s",
                          peer)

    def _replicate_to(self, peer: str) -> None:
        with self._lock:
            if self.state != LEADER:
                return
            term = self.current_term
            base = self._base()
            nxt = self._next_index.get(peer, self._last_index() + 1)
            snapshot = None
            if nxt <= base:
                # follower is behind the compacted log: piggyback the
                # snapshot (fused InstallSnapshot) and resend everything
                snapshot = (base, self.log[0]["term"],
                            json.dumps(self.snapshot_state))
                nxt = base + 1
            prev = self._get(nxt - 1)
            entries = self.log[nxt - base:]
            commit = self.commit_index
        pb_entries = [raft_pb2.LogEntry(
            index=e["index"], term=e["term"],
            command=json.dumps(e["command"]).encode())
            for e in entries]
        req = raft_pb2.AppendEntriesRequest(
            term=term, leader_id=self.my_url,
            prev_log_index=prev["index"], prev_log_term=prev["term"],
            entries=pb_entries, leader_commit=commit)
        if snapshot is not None:
            req.has_snapshot = True
            req.snapshot_index = snapshot[0]
            req.snapshot_term = snapshot[1]
            req.snapshot_state = snapshot[2].encode()
        try:
            resp = raft_stub(peer).AppendEntries(
                req, timeout=self.election_timeout)
        except rpc.RpcError:
            return
        with self._lock:
            if resp.term > self.current_term:
                self._become_follower(resp.term, None)
                return
            if self.state != LEADER:
                return
            if resp.success:
                self._match_index[peer] = resp.match_index
                self._next_index[peer] = resp.match_index + 1
            else:
                self._next_index[peer] = max(1, nxt - 1)

    def _advance_commit(self) -> None:
        with self._lock:
            if self.state != LEADER:
                return
            quorum = (len(self.peers) + 1) // 2 + 1
            for idx in range(self._last_index(), self.commit_index, -1):
                if idx <= self._base():
                    break
                votes = 1 + sum(1 for p in self.peers
                                if self._match_index.get(p, 0) >= idx)
                if votes >= quorum and \
                        self._get(idx)["term"] == self.current_term:
                    self.commit_index = idx
                    self._apply_committed()
                    self._maybe_compact()
                    self._commit_cv.notify_all()
                    break

    def _apply_committed(self) -> None:
        # caller holds self._lock (or init)
        while self.last_applied < self.commit_index:
            self.last_applied += 1
            entry = self._get(self.last_applied)
            if entry["command"] is not None:
                try:
                    self.apply(entry["command"], entry["term"])
                except Exception:
                    log.exception("raft apply failed for %r",
                                  entry["command"])

    # -- public: propose a command -------------------------------------------

    def propose(self, command: dict, timeout: float = 5.0) -> None:
        """Append to the log and block until the entry commits (quorum
        replicated + applied). Raises NotLeader from followers."""
        if not self.peers:
            # single-node: commit immediately
            with self._lock:
                idx = self._last_index() + 1
                entry = {"index": idx, "term": self.current_term,
                         "command": command}
                self.log.append(entry)
                self._wal_append([entry])  # durable before acking commit
                self.commit_index = idx
                self._apply_committed()
                self._maybe_compact()
            return
        with self._lock:
            if self.state != LEADER:
                raise NotLeader(self.leader_url)
            idx = self._last_index() + 1
            entry = {"index": idx, "term": self.current_term,
                     "command": command}
            self.log.append(entry)
            self._wal_append([entry])
        # push to followers now rather than waiting for the next tick
        self._broadcast_heartbeat()
        deadline = time.monotonic() + timeout
        with self._lock:
            while self.commit_index < idx:
                if self._stopped:
                    raise RuntimeError(
                        "raft node stopped before the command committed")
                if self.state != LEADER:
                    raise NotLeader(self.leader_url)
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    raise TimeoutError(
                        f"raft commit of index {idx} timed out")
                self._commit_cv.wait(timeout=min(remaining, 0.05))

    # -- RPC service (Raft) ----------------------------------------------------

    def RequestVote(self, request, context):
        with self._lock:
            if request.term < self.current_term:
                return raft_pb2.VoteResponse(term=self.current_term,
                                             vote_granted=False)
            if request.term > self.current_term:
                self._become_follower(request.term, None)
            last = self.log[-1]
            up_to_date = (request.last_log_term, request.last_log_index) >= \
                (last["term"], last["index"])
            grant = up_to_date and self.voted_for in (None,
                                                      request.candidate_id)
            if grant:
                self.voted_for = request.candidate_id
                self._last_heard = time.monotonic()
                # fsync'd BEFORE the reply leaves: a crash may not
                # forget a granted vote (double-vote window)
                self._save_meta()
            return raft_pb2.VoteResponse(term=self.current_term,
                                         vote_granted=grant)

    def AppendEntries(self, request, context):
        with self._lock:
            if request.term < self.current_term:
                return raft_pb2.AppendEntriesResponse(
                    term=self.current_term, success=False, match_index=0)
            self._become_follower(request.term, request.leader_id)
            if request.has_snapshot and \
                    request.snapshot_index > self.commit_index:
                # install the piggybacked snapshot: we're behind the
                # leader's compacted base
                self.snapshot_state = json.loads(
                    request.snapshot_state.decode() or "{}")
                self.restore_fn(self.snapshot_state)
                self.log = [{"index": request.snapshot_index,
                             "term": request.snapshot_term,
                             "command": None}]
                self.commit_index = request.snapshot_index
                self.last_applied = request.snapshot_index
                self._save_snapshot()  # also resets the WAL to the base
            base = self._base()
            # log consistency check
            if request.prev_log_index > self._last_index():
                return raft_pb2.AppendEntriesResponse(
                    term=self.current_term, success=False, match_index=0)
            if request.prev_log_index >= base and \
                    self._get(request.prev_log_index)["term"] != \
                    request.prev_log_term:
                return raft_pb2.AppendEntriesResponse(
                    term=self.current_term, success=False, match_index=0)
            # append / overwrite conflicting suffix (skip entries the
            # snapshot already covers)
            appended: List[dict] = []
            for e in request.entries:
                if e.index <= base:
                    continue
                entry = {"index": e.index, "term": e.term,
                         "command": json.loads(e.command.decode())
                         if e.command else None}
                if e.index <= self._last_index():
                    if self._get(e.index)["term"] != e.term:
                        del self.log[e.index - base:]
                        self._wal_truncate_mark(e.index)
                        self.log.append(entry)
                        appended.append(entry)
                else:
                    self.log.append(entry)
                    appended.append(entry)
            if appended:
                # durable before the success reply: the leader counts
                # this node toward quorum as soon as it answers
                self._wal_append(appended)
            # match what the LEADER sent, not whatever tail this node
            # happens to hold: a stale suffix beyond the leader's last
            # entry must not count toward the leader's quorum math
            match = request.prev_log_index + len(request.entries)
            if request.leader_commit > self.commit_index:
                self.commit_index = min(request.leader_commit,
                                        self._last_index())
                self._apply_committed()
                self._maybe_compact()
            return raft_pb2.AppendEntriesResponse(
                term=self.current_term, success=True, match_index=match)
