"""The port's process dispatcher, reset around every test of a file that
imports this module.

``ShuffleManager`` takes ``Dispatcher.get(config)`` as the JAX manager does:
one dispatcher per process for the first config, and one per other config
in a small table. A dispatcher keeps state between managers (its FileStatus
cache, a backend a test wrapped, the tuners, the instrumented store chosen
when it was built), so a test must not inherit one from an earlier test.
``tests/conftest.py`` resets only the JAX package's. A test file that
reaches the port's manager takes the fixture by importing it::

    from torch_port_dispatcher import port_dispatcher_reset  # noqa: F401
"""

import pytest

from s3shuffle_tpu_torch.storage.dispatcher import Dispatcher


@pytest.fixture(autouse=True)
def port_dispatcher_reset():
    Dispatcher.reset()
    yield
    Dispatcher.reset()
