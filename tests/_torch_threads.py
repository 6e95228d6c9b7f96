"""Caps torch's intra-op threads in the port's tests at this process's share
of the CPU.

Under pytest-xdist each of the N workers imports every test module, and
torch would start one thread per core in each of them, beside XLA's: N
workers on C cores would run N x C threads. Every `tests/test_torch_*.py`
imports this module first, so each worker keeps C // N threads (at least
one); a single process keeps all C.
"""

import os

import torch

torch.set_num_threads(max(1, os.cpu_count() // int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))))
