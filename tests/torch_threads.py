"""One PyTorch intra-op thread for the port's CPU tests.

The suite runs in several pytest-xdist workers at once. By default each
PyTorch CPU op above a small size opens a parallel region over every core;
with several workers doing so at the same time the threads oversubscribe
the cores, and loops of many small ops (the GMM's EM steps, the NMS rounds)
slow down by orders of magnitude. A test module that imports this fixture
runs with one thread; the earlier count comes back after the module."""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
