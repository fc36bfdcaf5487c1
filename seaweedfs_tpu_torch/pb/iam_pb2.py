"""``iam_pb`` messages: the identities an S3 gateway enforces.

Field names, numbers and kinds are those of the JAX package's
``seaweedfs_tpu/pb/iam_pb2.py`` descriptor (a test holds this table
against it); the wire runtime is ``pb/wire.py`` and the JSON mapping,
which ``s3.configure`` and ``s3 -config`` documents go through,
``pb/json_format.py``.
"""

from seaweedfs_tpu_torch.pb.wire import REPEATED, message, resolve

PACKAGE = "iam_pb"

S3ApiConfiguration = message("S3ApiConfiguration", [
    ("identities", 1, "message", REPEATED, "Identity"),
])

Identity = message("Identity", [
    ("name", 1, "string"),
    ("credentials", 2, "message", REPEATED, "Credential"),
    ("actions", 3, "string", REPEATED),
])

Credential = message("Credential", [
    ("access_key", 1, "string"),
    ("secret_key", 2, "string"),
])

resolve(globals(), PACKAGE)

# the service has no methods (reference weed/pb/iam.proto)
SERVICES = {"SeaweedIdentityAccessManagement": []}
