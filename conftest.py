"""Thread budget of each pytest-xdist worker.

Six workers on eight cores, each with torch's and OpenMP's default of a
thread a core, oversubscribe the host, and those threads spin-wait.  xdist
sets PYTEST_XDIST_WORKER_COUNT in each worker before this file loads, and
pytest loads it before tests/conftest.py imports JAX, so every worker gets
its share of the cores before a thread pool starts; a caller's own
OMP_NUM_THREADS / MKL_NUM_THREADS wins.  A single process, and xdist's
controller (whose environment the workers inherit), are left as they are.
"""

import os

if "PYTEST_XDIST_WORKER_COUNT" in os.environ:
    threads = max(1, len(os.sched_getaffinity(0))
                  // int(os.environ["PYTEST_XDIST_WORKER_COUNT"]))
    os.environ.setdefault("OMP_NUM_THREADS", str(threads))
    os.environ.setdefault("MKL_NUM_THREADS", str(threads))
    try:
        import torch
    except ImportError:
        pass
    else:
        torch.set_num_threads(threads)
