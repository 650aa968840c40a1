"""One torch thread for a test module, imported by the port's heavier test
files as an autouse fixture.

The repository's test command runs six pytest workers (``-n 6``) on the
host's cores, and torch's default of one OpenMP thread a core in each makes
their small CPU ops oversubscribe the host: six concurrent runs of a test that takes 1.4 s alone took more
than 300 s each at eight threads, 7.5 s at one. One thread keeps a module
near its single-process time; the count is put back after the module.
"""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
