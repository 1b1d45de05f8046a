"""Profiling hooks: ``torch.profiler`` traces and simple block timers.

The port's counterpart of ``ddqst_tpu/utils/profiling.py``. Wrap a region
in :func:`trace` to record a Chrome-trace file of its host and device
activity, or in :func:`timed` for a wall-clock number that waits for the
device first.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch
from torch.profiler import ProfilerActivity, profile


@contextlib.contextmanager
def trace(logdir: str):
    """Record the enclosed region with ``torch.profiler`` (CPU activity, and
    CUDA activity when CUDA is available) and write it to
    ``logdir/trace_<pid>_<ns>.json`` (Chrome trace format, readable in
    Perfetto or ``chrome://tracing``). Yields the profiler, whose
    ``events()`` and ``key_averages()`` the caller can read after the
    block."""
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(
        logdir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


def _devices(tree) -> set[torch.device]:
    if isinstance(tree, torch.Tensor):
        return {tree.device}
    if isinstance(tree, dict):
        tree = tree.values()
    if isinstance(tree, (list, tuple, type({}.values()))):
        return set().union(*map(_devices, tree))
    return set()


@contextlib.contextmanager
def timed(name: str, sync_on=None, log_fn=print):
    """Wall-clock a block and log ``[timed] name: <s>s``. ``sync_on`` (a
    tensor, or a dict / list / tuple of them) names the devices to wait for
    before the clock is read: each CUDA device it touches is
    synchronised."""
    t0 = time.perf_counter()
    yield
    for dev in _devices(sync_on):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    log_fn(f"[timed] {name}: {time.perf_counter() - t0:.4f}s")
