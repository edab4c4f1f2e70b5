"""An autouse fixture for the port's CPU tests: torch on one intra-op thread.

The suite runs in several pytest-xdist workers at once. Left alone, each
worker's torch starts an intra-op pool as wide as the machine, and the
pools then fight over its cores: one trainer test took 40x its time alone
inside the suite. A test file that runs torch at length imports the
fixture, which caps the pool for the file's tests and restores it after:

    from torch_threads import one_torch_thread  # noqa: F401
"""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)
