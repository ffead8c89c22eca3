"""Build info, logged at manager start-up (the JAX package's ``version.py``).

Parity: the reference generates ``SparkS3ShuffleBuild`` with sbt-buildinfo
(build.sbt:18-27) and logs its name, version and build time when the
manager starts (sort/S3ShuffleManager.scala:39-41).
"""

__version__ = "0.1.0"

#: The shuffle wire contract's version: partition functions, codec framing,
#: the index and checksum sidecars, serializer frames, the composite and
#: coded layouts, the skew trailer, fat index v3 and snapshot wire v3. The
#: port writes the JAX package's format 6 byte for byte, so both packages
#: carry the same number; a metadata server refuses a client of any other
#: (``check_format``). One job runs one value in its driver and every
#: worker.
SHUFFLE_FORMAT_VERSION = 6

BUILD_INFO = {
    "name": "s3shuffle_tpu_torch",
    "version": __version__,
    "shuffle_format": SHUFFLE_FORMAT_VERSION,
    "target": "cuda sm_90a (hand-written kernels, nvcc) + plain torch on the cpu",
}
