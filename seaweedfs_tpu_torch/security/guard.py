"""IP whitelist + JWT gate for HTTP handlers: the port of
``seaweedfs_tpu.security.guard`` (reference weed/security/guard.go:43-100).
A library: no server of either package runs one."""

from __future__ import annotations

import ipaddress
from typing import List, Optional

from seaweedfs_tpu_torch.security.jwt import JwtError, decode_jwt


class AccessDenied(Exception):
    pass


class Guard:
    def __init__(self, whitelist: Optional[List[str]] = None,
                 signing_key: bytes = b"", expires_seconds: int = 10):
        self.whitelist = whitelist or []
        self.signing_key = signing_key
        self.expires_seconds = expires_seconds
        self._nets = []
        for item in self.whitelist:
            try:
                self._nets.append(ipaddress.ip_network(item, strict=False))
            except ValueError:
                self._nets.append(item)  # bare hostname, exact match

    @property
    def is_active(self) -> bool:
        return bool(self.whitelist) or bool(self.signing_key)

    def check_whitelist(self, remote_ip: str) -> None:
        if not self.whitelist:
            return
        try:
            addr = ipaddress.ip_address(remote_ip)
        except ValueError:
            addr = None
        for net in self._nets:
            if isinstance(net, str):
                if net == remote_ip:
                    return
            elif addr is not None and addr in net:
                return
        raise AccessDenied(f"ip {remote_ip} not in whitelist")

    def check_jwt(self, auth_header: str) -> dict:
        if not self.signing_key:
            return {}
        token = auth_header.removeprefix("Bearer ").strip()
        if not token:
            raise AccessDenied("jwt required")
        try:
            return decode_jwt(self.signing_key, token)
        except JwtError as e:
            raise AccessDenied(str(e)) from e
