"""A share of the cores for torch in each pytest-xdist worker.

torch sizes its intra-op pool to every core of the machine in every
process. Under `-n 6` on 8 cores that gives six pools of eight OpenMP
threads, which spin against each other: a tiny `main` of `mnist_vic`
took 15 s in each of 6 concurrent processes with one thread each, and
790 s with eight. The port's test files import this module, which gives
each worker its share of the cores (at least one) and hands the same
share to the processes the worker spawns through `OMP_NUM_THREADS`. Out
of xdist it changes nothing.
"""

import os

import torch

if "PYTEST_XDIST_WORKER" in os.environ:
    _workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    THREADS = max(1, len(os.sched_getaffinity(0)) // max(1, _workers))
    torch.set_num_threads(THREADS)
    os.environ.setdefault("OMP_NUM_THREADS", str(THREADS))
