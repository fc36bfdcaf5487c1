"""The cluster's messages and stub helpers.

``master_pb2``, ``volume_server_pb2``, ``raft_pb2`` and ``filer_pb2``
carry the JAX package's ``master_pb``, ``volume_server_pb``, ``raft_pb``
and ``filer_pb`` messages
(names, field numbers, proto3 wire bytes) on the port's own runtime
(``wire.py``), for the methods the port serves; ``rpc.py`` carries the
calls.
"""

from seaweedfs_tpu_torch import rpc
from seaweedfs_tpu_torch.pb import (filer_pb2, master_pb2, raft_pb2,
                                    volume_server_pb2)

__all__ = ["filer_pb2", "master_pb2", "raft_pb2", "volume_server_pb2",
           "filer_stub", "master_stub", "raft_stub", "volume_stub"]


def master_stub(url_or_target: str, is_http_url: bool = True):
    target = rpc.grpc_address(url_or_target) if is_http_url else url_or_target
    return rpc.make_stub(master_pb2, "Seaweed", target)


def volume_stub(url_or_target: str, is_http_url: bool = True):
    target = rpc.grpc_address(url_or_target) if is_http_url else url_or_target
    return rpc.make_stub(volume_server_pb2, "VolumeServer", target)


def raft_stub(url_or_target: str, is_http_url: bool = True):
    """The Raft service of a master (on the master's RPC port)."""
    target = rpc.grpc_address(url_or_target) if is_http_url else url_or_target
    return rpc.make_stub(raft_pb2, "Raft", target)


def filer_stub(url_or_target: str, is_http_url: bool = True):
    target = rpc.grpc_address(url_or_target) if is_http_url else url_or_target
    return rpc.make_stub(filer_pb2, "SeaweedFiler", target)
