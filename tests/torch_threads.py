"""One torch intra-op thread while a port test module runs.

The suite runs in several worker processes on one machine (pytest-xdist),
and torch gives each of them a thread per core by default: the workers'
OpenMP threads then outnumber the cores several times over and wait on
each other at every parallel op. A port test module imports
`one_torch_thread`, an autouse fixture of module scope, and runs with one
intra-op thread; the count is restored when the module is done, so other
modules in the same worker run as before.
"""
import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)
