"""torch's intra-op threads in the port's tests: the CPU's cores shared
among the pytest-xdist workers.

By default every worker's torch runs as many threads as the machine has
cores, so six workers on eight cores run ~48 threads that spin and wait on
each other (and on the JAX workers beside them); a port test then takes
about 1.5x as long as with its share. One worker alone keeps every core.
A single thread also never meets the CPU build's thread-dependent first
`torch.log` (tests/test_torch_prng.py's fixture)."""
import os

import torch


def share_cores():
    """Give this process's torch its share of the cores: all of them
    outside xdist, cores // workers (at least 1) inside it."""
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // workers))


share_cores()
