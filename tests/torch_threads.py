"""The port's tests' shared fixture: `from torch_threads import one_thread`
in a test module runs each of its tests on one torch thread."""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One torch thread for the module's tests: the suite runs six test
    processes at once, and beside them intra-op threads only contend (the
    SLAM loop's thousands of tiny ops per frame took 13 s alone and 640 s
    in a 6-worker run)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
