"""Imported at the head of every port test file: under pytest-xdist, each
worker's torch gets its share of the machine's cores.

By default torch runs its CPU ops on as many OpenMP threads as the
machine has cores, in every process.  Six xdist workers on eight cores
then run up to 48 such threads, beside the gloo ranks the mesh tests
spawn and JAX's own pool, and each small parallel op waits at its
barrier for threads that the kernel has descheduled.  A worker's share
is the cores over the workers (at least one); outside xdist nothing
changes.
"""

import os

import torch


def share_cores() -> None:
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    if workers > 1:
        cores = len(os.sched_getaffinity(0))
        torch.set_num_threads(max(1, cores // workers))


share_cores()
