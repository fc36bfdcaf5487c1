"""JWT, the access guard and mutual TLS for the RPC plane (reference
weed/security). JWT and the guard are a library: no server of the port
checks a token, as no server of the JAX package does."""

from seaweedfs_tpu_torch.security.guard import AccessDenied, Guard  # noqa: F401
from seaweedfs_tpu_torch.security.jwt import (  # noqa: F401
    JwtError, SigningKey, decode_jwt, encode_jwt, gen_jwt_for_file_id,
    verify_file_id_jwt,
)
