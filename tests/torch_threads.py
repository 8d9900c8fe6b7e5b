"""One torch thread for each of the port's test modules.

The tests run in several worker processes at once; torch's default of one
thread per core in every worker oversubscribes the CPU and makes the
small tensors of these tests several times slower. A port test module
imports `one_torch_thread`, an autouse fixture that sets one thread for the
module and restores the previous count after it.
"""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
  threads = torch.get_num_threads()
  torch.set_num_threads(1)
  yield
  torch.set_num_threads(threads)
