"""Mutual TLS for the RPC plane (reference weed/security/tls.go:15-80).

The port of ``seaweedfs_tpu.security.tls``, with the same gating: a
``security.toml`` with ``[grpc.ca]`` and ``[grpc.<role>]`` cert/key
sections puts every RPC server and client connection of the process
under mutual TLS; without them, or with a partial section, everything
stays plaintext. The JAX package builds gRPC credentials; the port's
transport (``rpc.py``) is plain sockets, so it builds ``ssl.SSLContext``s
instead. The server context requires a client certificate signed by the
CA, and the client context checks the server's certificate and its
address. The HTTP plane stays plaintext in both packages.
"""

from __future__ import annotations

import ssl
from typing import Optional

from seaweedfs_tpu_torch.util import wlog

log = wlog.logger("security.tls")


class TlsConfig:
    """Cert material for one process role."""

    def __init__(self, ca_path: str = "", cert_path: str = "",
                 key_path: str = ""):
        self.ca_path = ca_path
        self.cert_path = cert_path
        self.key_path = key_path

    @property
    def enabled(self) -> bool:
        return bool(self.ca_path and self.cert_path and self.key_path)

    def server_context(self) -> Optional[ssl.SSLContext]:
        """A listener's context: the role's pair, client certs required
        (mutual, like the reference). Raises when a file is missing or
        does not parse."""
        if not self.enabled:
            return None
        ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
        ctx.load_cert_chain(self.cert_path, self.key_path)
        ctx.load_verify_locations(cafile=self.ca_path)
        ctx.verify_mode = ssl.CERT_REQUIRED
        return ctx

    def client_context(self) -> Optional[ssl.SSLContext]:
        """A dialer's context: the CA checks the server (and its address,
        as a gRPC channel does), the pair proves this client."""
        if not self.enabled:
            return None
        ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_CLIENT)
        ctx.load_verify_locations(cafile=self.ca_path)
        ctx.load_cert_chain(self.cert_path, self.key_path)
        return ctx


def load_tls_config(security_conf, component: str) -> TlsConfig:
    """[grpc.ca] + [grpc.<component>] cert/key (reference tls.go
    LoadClientTLS / LoadServerTLS)."""
    if security_conf is None or not security_conf:
        return TlsConfig()
    ca = security_conf.get_string("grpc.ca")
    cert = security_conf.get_string(f"grpc.{component}.cert")
    key = security_conf.get_string(f"grpc.{component}.key")
    return TlsConfig(ca_path=ca, cert_path=cert, key_path=key)


def configure_process_tls(security_conf, server_role: str) -> None:
    """Put the process's RPC transport under TLS: its server listens with
    the role's pair, every outgoing connection dials with [grpc.client].
    Does nothing when the sections are absent or partial; raises when a
    configured file cannot be loaded, so a server never starts in
    plaintext by mistake."""
    from seaweedfs_tpu_torch import rpc
    server_tls = load_tls_config(security_conf, server_role)
    client_tls = load_tls_config(security_conf, "client")
    if not client_tls.enabled and server_tls.enabled:
        # no [grpc.client] section: dial with the role's own pair
        # (reference tls.go: each component reuses its pair), or a
        # server-sections-only config would listen secured but dial
        # plaintext and the cluster would never form
        client_tls = server_tls
    if server_tls.enabled:
        rpc.set_server_credentials(server_tls.server_context())
        log.info("rpc server TLS enabled (%s)", server_role)
    if client_tls.enabled:
        rpc.set_channel_credentials(client_tls.client_context())
        log.info("rpc client mTLS enabled")
