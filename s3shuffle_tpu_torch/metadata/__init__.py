"""Shuffle metadata of the port: index and checksum sidecar objects."""
