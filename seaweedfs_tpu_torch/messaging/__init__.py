"""Pub/sub message broker (reference: weed/messaging): the port of
``seaweedfs_tpu.messaging``. Topic logs persist through the filer, so a
replay from EARLIEST after a volume server is lost reads its chunks
through the decode fleet."""

from seaweedfs_tpu_torch.messaging.broker import MessageBroker  # noqa: F401
from seaweedfs_tpu_torch.messaging.client import MessagingClient  # noqa: F401
