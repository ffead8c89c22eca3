"""Object storage of the port: the backend seam, the ``file://`` backend
and the dispatcher's prefix-sharded object layout."""
