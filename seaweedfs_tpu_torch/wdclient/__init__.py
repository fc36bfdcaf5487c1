"""Cluster client library (reference weed/wdclient): the master client,
its vid map and the coalescing lookup cache."""

from seaweedfs_tpu_torch.wdclient.masterclient import (MasterClient,
                                                       MasterUnreachable)
from seaweedfs_tpu_torch.wdclient.vid_map import Location, VidMap

__all__ = ["MasterClient", "MasterUnreachable", "Location", "VidMap"]
