"""Root pytest settings for the port's tests.

Under pytest-xdist every worker process would start one torch intra-op
thread per core, so ``-n 6`` on 8 cores ran ~48 threads that spin on the
port's many small plain-PyTorch ops; tests then took minutes where they
take seconds alone. Each worker gets its share of the cores this
process may run on instead. A serial run keeps torch's default.
"""

import os


def pytest_configure(config):
    workers = os.environ.get("PYTEST_XDIST_WORKER_COUNT")
    if workers:
        import torch

        torch.set_num_threads(max(1, len(os.sched_getaffinity(0)) // int(workers)))
