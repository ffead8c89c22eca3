"""The small sizes the CPU tests run the cells at."""

#: the small sizes the CPU tests run the cells at: the kernels' plain
#: versions are slow at 256 KiB blocks
SMALL_KNOBS = {"codec": "tpu", "checksum_algorithm": "CRC32C", "autotune": False,
               "codec_block_size": 2048, "codec_batch_blocks": 4}
SMALL = {
    "terasort-256m": {"job_bytes": 200_000, "knobs": SMALL_KNOBS},
}
CELLS = tuple(SMALL)
