#!/usr/bin/env python3
"""The toy LLM's training step on the card: eager against one CUDA graph.

    python3 script/torch_toy_train_ab.py [--steps 200] [--pairs 2]

``models/train.py`` runs each step of ``train_toy_llm`` (forward through the
exact attention, backward, the AdamW update) as one captured CUDA graph,
replayed. This times, in turns in one process, the same steps run eagerly
(``_Step``'s body called directly) and replayed (``_Step`` itself), each
from the same initial parameters and token batches at JAX's recipe (arith
config, batch 64 x 64 tokens, lr 1e-3, the schedule of a ``--steps`` run),
prints ms a step on the host clock (after a synchronize), the largest
relative difference of the runs' per-step losses (eager against graph, and
each against its own repeat), and the device time of a few eager steps by
``torch.profiler``. Builds no kernel of the port: the
training runs none.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from lowbit_quant_fa2_paddle_tpu_torch.models import llm, train  # noqa: E402

BATCH, SEQ, LR = 64, 64, 1e-3


def run(steps: int, graphed: bool):
    """``steps`` training steps from seed 0's parameters; (ms a step, the
    per-step losses)."""
    cfg = train.arith_llm_config()
    params = llm.init_llm_params(cfg, torch.Generator(device="cuda").manual_seed(0))
    ps = list(params.parameters())
    for p in ps:
        p.requires_grad_(True)
    opt = train.AdamW(ps, lambda c: train.warmup_cosine_lr(c, LR, min(100, steps // 10), steps))
    step = train._Step(params, cfg, opt, BATCH, SEQ, steps)
    rng = np.random.RandomState(1)
    toks = torch.from_numpy(np.stack([train.arith_stream_batch(rng, BATCH, SEQ) for _ in range(steps)]))
    toks = toks.cuda().long()
    losses = torch.empty(steps, device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(steps):
        if graphed:
            losses[i] = step(toks[i])
        else:
            step.tok.copy_(toks[i])
            opt.scalars.copy_(step.table[i])
            step._body()
            losses[i] = step.loss
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / steps * 1e3, losses.cpu().numpy()


def eager_device_ms(n: int = 10) -> float:
    """Device ms a step of ``n`` eager steps, from torch.profiler's kernels."""
    from torch.profiler import ProfilerActivity, profile

    run(5, False)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run(n, False)
    return sum(e.self_device_time_total for e in prof.key_averages()) / 1e3 / n


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--steps", type=int, default=200)
    p.add_argument("--pairs", type=int, default=2)
    args = p.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("this script times the card: torch.cuda.is_available() is False")
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(card, flush=True)
    rows = {"eager": [], "graph": []}
    losses = {"eager": [], "graph": []}
    for i in range(args.pairs):  # eager, graph, graph, eager, ...
        for mode in (("eager", "graph") if i % 2 == 0 else ("graph", "eager")):
            ms, ls = run(args.steps, mode == "graph")
            rows[mode].append(ms)
            losses[mode].append(ls)
            print(f"{mode}: {ms:.3f} ms a step over {args.steps} steps", flush=True)

    def rel(a, b):  # the largest relative difference of two runs' per-step losses, and its first step
        d = np.abs(a / b - 1.0)
        return f"{float(d.max()):.3g} (first step past 1e-6: {int(np.argmax(d > 1e-6)) if (d > 1e-6).any() else None})"

    e, g = losses["eager"], losses["graph"]
    print(f"eager ms a step {rows['eager']}, graph {rows['graph']}; per-step losses, eager vs graph "
          f"{rel(e[0], g[0])}" + (f", eager vs eager {rel(e[0], e[1])}, graph vs graph {rel(g[0], g[1])}"
                                  if len(e) > 1 else "")
          + f"; eager device ms a step (profiler) {eager_device_ms():.3f} ({card})", flush=True)


if __name__ == "__main__":
    main()
