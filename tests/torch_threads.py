"""One compute thread per pytest worker for the tests that hold
fluca_tpu_torch against fluca_tpu.

Tier-1 runs several pytest workers on the machine's cores. Both
packages build their multigrid's coarse pseudo-inverse with
``np.linalg.pinv`` on OpenBLAS, whose threads spin while they wait, and
torch's CPU ops use a thread pool of their own. With a pool of each per
worker the workers starve one another: six workers at once took about
ten times as long per test as one. A test module that imports
``one_thread_per_worker`` runs its tests with one torch thread and one
BLAS thread, and restores both afterwards.
"""

import pytest
import torch
from threadpoolctl import threadpool_limits


@pytest.fixture(autouse=True, scope="module")
def one_thread_per_worker():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with threadpool_limits(limits=1, user_api="blas"):
            yield
    finally:
        torch.set_num_threads(n)
