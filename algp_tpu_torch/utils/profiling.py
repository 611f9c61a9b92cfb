"""Tracing and timing hooks (the counterpart of algp_tpu.utils.profiling).

Any phase can be wrapped in a named region of the profiler's trace and
timed with a stopwatch that waits for the card, so

    python -m algp_tpu_torch.cli --preset c5_10k --profile-dir /tmp/trace

writes a TensorBoard-loadable `torch.profiler` trace (`*.pt.trace.json`)
of the first run: the host's ops and, on a card, its kernels (CUPTI).
"""

from __future__ import annotations

import contextlib
import time
from typing import Optional

import torch

from algp_tpu_torch.utils.debug import tree_flatten_with_path


def annotate(name: str):
    """Named region in the trace (`torch.profiler.record_function`)."""
    return torch.profiler.record_function(name)


@contextlib.contextmanager
def trace(log_dir: Optional[str]):
    """Capture a profiler trace into `log_dir` (None: no-op): CPU activity,
    and CUDA activity when a card is present.  Late in a long-lived
    process the profiler has been seen to drop device records of a short
    region as outside its window (PERF.md §7): trace early, or a region
    of seconds."""
    if log_dir is None:
        yield
        return
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
        activities=acts,
        on_trace_ready=torch.profiler.tensorboard_trace_handler(log_dir),
    ):
        yield


def _wait(tree) -> None:
    """Synchronize the device of every CUDA tensor in `tree`."""
    devs = {leaf.device for _, leaf in tree_flatten_with_path(tree)
            if isinstance(leaf, torch.Tensor) and leaf.device.type == "cuda"}
    for dev in devs:
        torch.cuda.synchronize(dev)


class Stopwatch:
    """Wall-clock timing that respects asynchronous launches: `stop(x)`
    waits for the devices of x's tensors before reading the clock, so the
    time covers the device work."""

    def __init__(self):
        self._t0 = None

    def start(self) -> "Stopwatch":
        self._t0 = time.perf_counter()
        return self

    def stop(self, wait_on=None) -> float:
        if wait_on is not None:
            _wait(wait_on)
        return time.perf_counter() - self._t0


def timed(fn, *args, warmup: int = 1, iters: int = 5, **kw):
    """(median_seconds, result) of `fn(*args, **kw)`, after warm-up, each
    call ended by waiting for its result's devices."""
    result = None
    for _ in range(warmup):
        result = fn(*args, **kw)
        _wait(result)
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        result = fn(*args, **kw)
        _wait(result)
        times.append(time.perf_counter() - t0)
    times.sort()
    return times[len(times) // 2], result
