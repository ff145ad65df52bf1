"""Tracing and timing helpers.

Port of the JAX package's ``utils/profiling.py``: ``trace(log_dir)``
records a region with ``torch.profiler`` (CPU activity, and CUDA activity
when a card is present) into a trace that Perfetto or TensorBoard opens;
``StepTimer`` gives wall times bracketed by the device's synchronization,
in a named ``record_function`` range; ``timed`` the mean seconds a call.
``device_ms`` times a call on the card by CUDA events.
"""

from __future__ import annotations

import contextlib
import statistics
import time

import torch
from torch.profiler import ProfilerActivity, profile, record_function
from torch.profiler import tensorboard_trace_handler
from torch.utils._pytree import tree_leaves


@contextlib.contextmanager
def trace(log_dir: str):
    """Record the enclosed region into a trace file under `log_dir`
    (``<worker>.<time>.pt.trace.json``); yields the profiler, whose
    ``key_averages()`` sums the region by op and kernel."""
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(log_dir),
                 acc_events=True) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()


def block_on(value):
    """Wait for the device work behind every tensor in `value` (any nest of
    lists, tuples and dicts): synchronize each CUDA device it lies on;
    CPU tensors need nothing."""
    devices = {t.device for t in tree_leaves(value)
               if isinstance(t, torch.Tensor) and t.device.type == "cuda"}
    for dev in devices:
        torch.cuda.synchronize(dev)


class StepTimer:
    """Wall-clock step timing with correct device synchronization.

    with StepTimer() as t:
        out = step(...)
        t.block_on(out)
    t.elapsed  # seconds
    """

    def __init__(self, name: str = "step"):
        self.name = name
        self.elapsed = None

    def __enter__(self):
        self._range = record_function(self.name)
        self._range.__enter__()
        self._t0 = time.perf_counter()
        return self

    def block_on(self, value):
        block_on(value)

    def __exit__(self, *exc):
        self.elapsed = time.perf_counter() - self._t0
        self._range.__exit__(*exc)
        return False


def timed(fn, *args, iters=10, warmup=1):
    """Mean seconds a call of ``fn(*args)`` over `iters` calls after
    `warmup`, the device synchronized (block_on) before and after."""
    out = None
    for _ in range(warmup):
        out = fn(*args)
    block_on((args, out))
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(*args)
    block_on(out)
    return (time.perf_counter() - t0) / iters


def device_ms(fn, reps=30, batches=2):
    """Median device time of one fn() call on the card, by CUDA events
    around each call.  A long sleep kernel goes first so the host enqueues
    every call while the card is busy: the calls then run back to back and
    the events time the card, not the host's launch overhead."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(batches):
        torch.cuda._sleep(100_000_000)
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(reps + 1)]
        ev[0].record()
        for i in range(reps):
            fn()
            ev[i + 1].record()
        torch.cuda.synchronize()
        times += [ev[i].elapsed_time(ev[i + 1]) for i in range(reps)]
    return statistics.median(times)
