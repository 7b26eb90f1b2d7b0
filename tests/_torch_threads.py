"""Shared fixture of the ``test_torch_*`` files.

The suite runs test files in several processes at once. PyTorch's CPU
thread pool, sized to every core in each process, then oversubscribes the
machine and its workers spin-wait: a construction that takes 3 s alone took
minutes. One intra-op thread per process keeps each file near its
stand-alone time.
"""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
