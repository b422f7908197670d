"""Benchmark helpers: the reference's FLOP convention and CUDA-event timing.

* ``flops = 4*B*H*D*Sq*Sk``, halved when causal; the backward counts 2.5x
  that (the JAX package's training bench convention), and each of its
  products (G1 runs three, G2 four) ``2*B*H*D*Sq*Sk``, halved when causal;
* TFLOP/s = flops / seconds;
* a call's time is the median of ``reps`` CUDA-event intervals after
  ``warmup`` calls. Each interval starts behind a device-side sleep that
  outlasts the host's enqueue of the call, so it holds the device's work
  only: without it, a call of a few tens of µs reads as the host's Python
  and launch cost (on the H100 every packed-weight matmul call read 80-110
  µs that way, whatever its size). Timing needs a CUDA card and raises
  without one.
"""

from __future__ import annotations

import statistics
from typing import Callable

import torch

#: Clock cycles the device sleeps before each timed call (~10 ms at the
#: H100's 1.98 GHz): longer than any host enqueue of one call timed here.
SLEEP_CYCLES = 20_000_000


def attention_flops(b: int, h: int, d: int, s_q: int, s_k: int, causal: bool) -> int:
    f = 4 * b * h * d * s_q * s_k
    return f // 2 if causal else f


def attention_bwd_flops(b: int, h: int, d: int, s_q: int, s_k: int, causal: bool) -> int:
    return attention_flops(b, h, d, s_q, s_k, causal) * 5 // 2


def attention_product_flops(b: int, h: int, d: int, s_q: int, s_k: int, causal: bool) -> int:
    """Operations of one ``[Sq, Sk] x D`` product of the backward (QK^T, dO V^T,
    dS K, P^T dO or dS^T Q)."""
    return attention_flops(b, h, d, s_q, s_k, causal) // 2


def tflops(flops: int, seconds: float) -> float:
    return flops / seconds / 1e12


def cuda_time_ms(fn: Callable[[], object], *, warmup: int = 3, reps: int = 10) -> float:
    """Median device milliseconds of one ``fn()`` call on the current CUDA
    stream (``fn`` must not synchronise)."""
    if not torch.cuda.is_available():
        raise RuntimeError("cuda_time_ms measures on a CUDA card; none is available")
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SLEEP_CYCLES)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)
