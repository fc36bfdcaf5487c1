"""Read serving: the degraded-read decode fleet, which fuses concurrent
on-the-fly RS reconstructions into batched `[B, 10, span]` decode
dispatches (the read-side twin of the `ec/fleet.py` schedulers)."""

from seaweedfs_tpu_torch.reads.decode_fleet import DegradedReadFleet  # noqa: F401
