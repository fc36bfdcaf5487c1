"""The cluster's servers: the master and the volume server."""
