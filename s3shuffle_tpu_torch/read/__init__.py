"""Reduce side of the port: ranged block reads, checksum validation and
batched device decode."""
