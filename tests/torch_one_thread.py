"""An autouse fixture the port's test modules import: their torch tensors
are small, and when several test workers share the host's cores, intra-op
threads only spin against each other.  One thread for the module, the
previous count restored after it.  The port's results do not depend on
the thread count (integer arithmetic; the float64 node fit sums exact
integers)."""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
