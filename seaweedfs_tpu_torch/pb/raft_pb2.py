"""``raft_pb`` messages and the ``Raft`` service.

Field names, numbers and kinds are those of the JAX package's
``seaweedfs_tpu/pb/raft_pb2.py`` descriptor (a test holds this table
against it); the wire runtime is ``pb/wire.py``. The masters' raft
(``server/raft.py``) rides these on the master's RPC port.
"""

from seaweedfs_tpu_torch.pb.wire import REPEATED, message, resolve

PACKAGE = "raft_pb"

LogEntry = message("LogEntry", [
    ("index", 1, "uint64"),
    ("term", 2, "uint64"),
    ("command", 3, "bytes"),
])

VoteRequest = message("VoteRequest", [
    ("term", 1, "uint64"),
    ("candidate_id", 2, "string"),
    ("last_log_index", 3, "uint64"),
    ("last_log_term", 4, "uint64"),
])

VoteResponse = message("VoteResponse", [
    ("term", 1, "uint64"),
    ("vote_granted", 2, "bool"),
])

AppendEntriesRequest = message("AppendEntriesRequest", [
    ("term", 1, "uint64"),
    ("leader_id", 2, "string"),
    ("prev_log_index", 3, "uint64"),
    ("prev_log_term", 4, "uint64"),
    ("entries", 5, "message", REPEATED, "LogEntry"),
    ("leader_commit", 6, "uint64"),
    ("has_snapshot", 7, "bool"),
    ("snapshot_index", 8, "uint64"),
    ("snapshot_term", 9, "uint64"),
    ("snapshot_state", 10, "bytes"),
])

AppendEntriesResponse = message("AppendEntriesResponse", [
    ("term", 1, "uint64"),
    ("success", 2, "bool"),
    ("match_index", 3, "uint64"),
])

resolve(globals(), PACKAGE)

# service -> [(method, request, response, client streaming, server
# streaming)]
SERVICES = {
    "Raft": [
        ("RequestVote", VoteRequest, VoteResponse, False, False),
        ("AppendEntries", AppendEntriesRequest, AppendEntriesResponse,
         False, False),
    ],
}
