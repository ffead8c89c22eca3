"""GenSort-layout records for the port's codec tests, cut into codec
blocks. The records are the TeraSort benchmark's own
(``portbench/generators/terasort.py::gensort_records``, Hadoop's
``GenSort.generateRecord`` layout), so the tests and the benchmark share
one copy of the layout."""

import numpy as np

from portbench.generators.terasort import gensort_records


def gensort_blocks(n_blocks: int, block_size: int, seed: int) -> np.ndarray:
    """``n_blocks`` consecutive ``block_size``-byte blocks of GenSort
    records, as an (n_blocks, block_size) uint8 array."""
    total = n_blocks * block_size
    recs = gensort_records(seed * 1000, -(-total // 100), np.random.default_rng(seed))
    return recs.reshape(-1)[:total].reshape(n_blocks, block_size).copy()
