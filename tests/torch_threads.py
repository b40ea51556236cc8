"""One torch intra-op thread for the port's CPU tests.

The tier-1 command runs the suite in six xdist workers, beside JAX's
thread pools and the gloo worlds' child processes. torch's default of
one OpenMP thread a core in every worker oversubscribes the host several
times over, and its threads' spinning then costs more than their
parallelism gains. Each ``tests/test_torch_*.py`` module imports the
fixture below (autouse, module scope): its tests run torch on one
thread, and the worker's thread count is restored after the module.
"""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)
