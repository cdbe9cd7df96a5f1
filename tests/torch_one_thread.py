"""Run torch on one intra-op thread in each port test module.

The port's CPU tests run under pytest-xdist, several workers at once. At
torch's default pool (every CPU in each worker) the workers' OpenMP
threads spin at their barriers while the other workers hold the cores:
the plain paths' small elementwise ops (the Philox keep mask most) then
take 20-50x as long as on one thread. Each ``tests/test_torch_*.py``
imports this module-scoped autouse fixture, so torch runs on one thread
for the module's tests and the previous count comes back when the module
ends. JAX's threads are not touched.
"""

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)
