"""The JAX package's native library, loaded before a port test file's JAX
side needs it as an oracle.

The JAX loader (``s3shuffle_tpu/codec/native.py::_load``) builds
``libs3shuffle_native.so`` with ``make`` when the file is missing or older
than its source, ``make`` links straight onto that path, and a failed load
is cached for the life of the process (``_lib_error``). Under parallel
pytest workers on a tree with no library yet, a worker that loads while
another worker's ``make`` is still writing the file gets ``file too
short``, and every later native case in that process fails or takes
another route. The module fixture below retries the JAX ``_load()`` until
the library loads: it waits while the file's size or mtime still moves,
clears the cached error between tries, and fails with the last error after
:data:`DEADLINE_S`. It builds nothing itself and skips nothing.

A test file takes it by importing it::

    from torch_jax_native import jax_native_library  # noqa: F401
"""

import os
import time

import pytest

DEADLINE_S = 120.0
#: a file whose size and mtime held for this long is no longer being written
_SETTLE_S = 0.3


def _signature(path):
    try:
        st = os.stat(path)
    except FileNotFoundError:
        return None
    return st.st_size, st.st_mtime_ns


def _wait_until_settled(path, deadline):
    """Return once ``path`` is missing or unchanged over ``_SETTLE_S``."""
    before = _signature(path)
    while time.monotonic() < deadline:
        time.sleep(_SETTLE_S)
        now = _signature(path)
        if now == before:
            return
        before = now


def load_jax_native(deadline_s=DEADLINE_S):
    """Load the JAX package's native library, retrying through a build
    another process has in flight."""
    from s3shuffle_tpu.codec import native as jax_native

    deadline = time.monotonic() + deadline_s
    last = None
    while True:
        _wait_until_settled(jax_native._SO_PATH, deadline)
        try:
            return jax_native._load()
        except Exception as e:  # noqa: BLE001 - any load failure is retried
            last = e
            with jax_native._lib_lock:
                jax_native._lib_error = None
        if time.monotonic() >= deadline:
            pytest.fail(
                f"the JAX native library did not load within {deadline_s:.0f} s: "
                f"{type(last).__name__}: {last}"
            )
        time.sleep(_SETTLE_S)


@pytest.fixture(scope="module", autouse=True)
def jax_native_library():
    """Module fixture: the JAX oracle's native library is loaded before
    the file's first test."""
    return load_jax_native()
