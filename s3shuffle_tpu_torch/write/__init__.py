"""Map side of the port: one data object + index + checksum sidecar per map."""
