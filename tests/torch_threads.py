"""Thread budget of the PyTorch port's CPU tests.

Each `tests/test_torch_*.py` imports this module, which caps PyTorch's
intra-op threads at the cores a test process has to itself: under
pytest-xdist (`PYTEST_XDIST_WORKER_COUNT` workers) cores // workers, at
least 1; a lone process keeps every core.  Without the cap every worker's
OpenMP pool takes all cores, and six workers on eight cores spend most of
their time waiting on each other: on an 8-core x86 CPU a colonnade-83k
port frame at 32 x 32 took ~167 s beside five such processes, against
4.7 s alone, and a JAX frame compile 145 s against 37 s (beside
one-thread processes: ~30 s and 37 s).  Every test
process that collects the port's tests imports it, the JAX package's tests
included, which do not use PyTorch."""

import os

import torch


def cap_threads() -> int:
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    n = max(1, len(os.sched_getaffinity(0)) // max(1, workers))
    torch.set_num_threads(n)
    return n


THREADS = cap_threads()
