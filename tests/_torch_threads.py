"""Torch's intra-op threads in a pytest-xdist worker: the machine's cores
shared among the workers, at least one each.

Torch defaults to one intra-op thread a core in every process. Under
``-n 6`` that puts several threads on each core, and an OpenMP region
then waits on threads the scheduler has parked: with five busy
neighbours, the port's half of
``test_torch_byzantine.py::test_every_attack_matches_reference
[pairwise-dense-random_noise]`` took 85 s instead of 0.4 s, and 2 s with
one thread. Every port test file imports this module, so a worker caps
its threads before its first torch test runs; a run without xdist keeps
torch's default.
"""
import os

import torch

_WORKERS = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
if _WORKERS > 1:
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // _WORKERS))
