"""Object storage of the port: the backend seam (``file://``, ``memory://``
and fsspec for every other scheme), the retry layer stacked over it, the
fault injector of tests and soaks, and the dispatcher's prefix-sharded
object layout with its FileStatus cache."""
