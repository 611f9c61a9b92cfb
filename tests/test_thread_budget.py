"""The thread budget the repository's root conftest.py gives each test process.

Under pytest-xdist, torch and OpenMP run on the worker's share of the host's
cores (one each under `-n 6` on eight cores); a single process keeps torch's
own default.  The JAX reference keeps its 8 virtual CPU devices and XLA's
default Eigen pool, on whose rounding its bitwise tests depend.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import pytest
import torch

ROOT_CONFTEST = Path(__file__).resolve().parents[1] / "conftest.py"
THREAD_VARS = ("PYTEST_XDIST_WORKER_COUNT", "OMP_NUM_THREADS", "MKL_NUM_THREADS")


def _share(workers):
    return max(1, len(os.sched_getaffinity(0)) // workers)


def _budget_in_a_fresh_process(torch_first=False, **env):
    """Runs the root conftest in a new interpreter under `env`, then reads torch's count."""
    base = {k: v for k, v in os.environ.items() if k not in THREAD_VARS}
    code = ("import json, os, runpy, sys; " + "import torch; " * torch_first +
            "runpy.run_path(sys.argv[1]); import torch; "
            "print(json.dumps([torch.get_num_threads(), os.environ.get('OMP_NUM_THREADS'), "
            "os.environ.get('MKL_NUM_THREADS')]))")
    out = subprocess.run([sys.executable, "-c", code, str(ROOT_CONFTEST)], env={**base, **env},
                         capture_output=True, text=True, check=True, timeout=120)
    return json.loads(out.stdout.splitlines()[-1])


@pytest.mark.parametrize("torch_first", [False, True])  # True: a pool started before the conftest
@pytest.mark.parametrize("workers", [1, 6, 64])
def test_a_worker_runs_on_its_share_of_the_cores(workers, torch_first):
    share = str(_share(workers))
    assert _budget_in_a_fresh_process(torch_first, PYTEST_XDIST_WORKER_COUNT=str(workers)) == [
        int(share), share, share]


def test_the_callers_openmp_threads_win():
    threads, omp, mkl = _budget_in_a_fresh_process(PYTEST_XDIST_WORKER_COUNT="6",
                                                   OMP_NUM_THREADS="3")
    assert (threads, omp, mkl) == (_share(6), "3", str(_share(6)))


def test_a_single_process_is_left_alone():
    assert _budget_in_a_fresh_process()[1:] == [None, None]


def test_this_process_has_its_budget():
    workers = os.environ.get("PYTEST_XDIST_WORKER_COUNT")
    if workers is None:  # a single process: torch's own default, as a bare interpreter has it
        assert torch.get_num_threads() == _budget_in_a_fresh_process(
            **{k: os.environ[k] for k in THREAD_VARS if k in os.environ})[0]
    else:
        assert torch.get_num_threads() == _share(int(workers))
        assert {"OMP_NUM_THREADS", "MKL_NUM_THREADS"} <= os.environ.keys()


def test_the_virtual_mesh_keeps_eight_cpu_devices():
    assert len(jax.devices("cpu")) == 8


def test_xla_eigen_pool_is_left_at_its_default():
    assert "xla_cpu_multi_thread_eigen" not in os.environ.get("XLA_FLAGS", "")
