"""One intra-op thread for the port's CPU tests.

The tier-1 command runs the tests in six worker processes on the CPU.  With
PyTorch's default (a thread per core in every worker) the workers'
thread pools oversubscribe the cores, and the port's many small operations
spend their time waiting on one another: a fleet test that takes 21 s in
each of six concurrent processes at one thread each takes 613 s at the
default.  A test module imports :func:`one_intra_op_thread` to run each of
its tests at one thread; the previous count is restored after the test.
What a test computes and checks is unchanged.
"""
import pytest
import torch


@pytest.fixture(autouse=True)
def one_intra_op_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)
