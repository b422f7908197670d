"""Profiling helpers: a ``torch.profiler`` trace and a scope timer.

PyTorch counterpart of ``lowbit_quant_fa2_paddle_tpu/utils/profiling.py``
(there ``jax.profiler`` traces for TensorBoard/XProf)."""

from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator

import torch


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[torch.profiler.profile]:
    """A ``torch.profiler`` session with CPU activities, plus CUDA
    activities when a card is in use (CUDA initialised), that writes a
    Chrome trace into ``log_dir`` (``chrome://tracing`` or Perfetto read
    it) when the block ends; the path is the profiler's ``trace_path``.
    Yields the profiler, whose ``key_averages()`` sum the events by name."""
    cuda = torch.cuda.is_available() and torch.cuda.is_initialized()
    acts = [torch.profiler.ProfilerActivity.CPU]
    if cuda:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
        torch.cuda.synchronize()
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
        if cuda:
            torch.cuda.synchronize()
    prof.trace_path = os.path.join(log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json")
    prof.export_chrome_trace(prof.trace_path)


class ScopeTimer:
    """Wall-clock scope timer that waits for the card's queued work when
    CUDA is initialised (the role of the reference's paddle_package.py
    timer, 7-62)."""

    def __init__(self, name: str = ""):
        self.name = name
        self.elapsed = 0.0

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            torch.cuda.synchronize()
        self.elapsed = time.perf_counter() - self._t0
        return False
