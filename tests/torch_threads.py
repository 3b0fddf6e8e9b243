"""One share of the CPU's cores for torch in each pytest-xdist worker.

torch's intra-op thread pool takes every core by default, so six xdist
workers on eight cores ran some 48 torch threads at once, and the port's
tests mostly waited for a core: six of the heaviest `test_torch_*.py`
files took 1820 worker-seconds (374 s of wall time) with the default
pool and 823 (230 s) with one thread a worker, on the same eight cores.
Every `tests/test_torch_*.py` imports this module, which sizes the pool
of the worker it runs in to cores // workers (at least one); a run
without xdist keeps torch's default.
"""

import os

import torch

WORKERS = int(os.environ.get('PYTEST_XDIST_WORKER_COUNT') or 0)
if WORKERS > 1:
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // WORKERS))
