"""A module-scoped autouse fixture for the port's tests on tiny models:
their ops are too small to split, and on all cores (the more so with
several test workers) the intra-op threads mostly wait for each other, so
one intra-op thread runs the decode steps several times faster.  A test
module turns it on with ``from _one_thread import one_thread  # noqa: F401``."""

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
