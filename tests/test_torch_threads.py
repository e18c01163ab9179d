"""One PyTorch intra-op thread for the port's test modules.

The suite runs one worker process per core (``-n 6``), and every process's
PyTorch would otherwise start a thread per core for its CPU ops: dozens of
threads on eight cores, each parallel region waiting for threads the
scheduler has not run yet.  The port's test modules import
``one_torch_thread`` (an autouse fixture, module-scoped), so each runs with
one thread and puts the count back after it.
"""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def test_modules_run_on_one_thread():
    assert torch.get_num_threads() == 1
