"""Benchmark helpers: the reference's FLOP convention and CUDA-event timing.

* ``flops = 4*B*H*D*Sq*Sk``, halved when causal;
* TFLOP/s = flops / seconds;
* a kernel's time is the median of ``reps`` CUDA-event intervals after
  ``warmup`` calls. Timing needs a CUDA card and raises without one.
"""

from __future__ import annotations

import statistics
from typing import Callable

import torch


def attention_flops(b: int, h: int, d: int, s_q: int, s_k: int, causal: bool) -> int:
    f = 4 * b * h * d * s_q * s_k
    return f // 2 if causal else f


def tflops(flops: int, seconds: float) -> float:
    return flops / seconds / 1e12


def cuda_time_ms(fn: Callable[[], object], *, warmup: int = 3, reps: int = 10) -> float:
    """Median milliseconds of one ``fn()`` call on the current CUDA stream."""
    if not torch.cuda.is_available():
        raise RuntimeError("cuda_time_ms measures on a CUDA card; none is available")
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)
