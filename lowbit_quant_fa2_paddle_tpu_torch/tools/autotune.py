"""Launch-plan autotuner for the port's kernels, on the CUDA card.

Counterpart of ``bench/autotune.py``. On the TPU each space swept block
shapes; on the GPU the tunable plans are the split plans of kernels D, F1
and F2, and the cache records their winners (``utils/tuning.py``):

* ``--space decode`` sweeps ``--waves`` (how many waves of resident CTAs
  kernel D's split-KV plan fills, ``ops/decode.py`` ``num_splits``) for the
  ``--kv-bits`` cache at ``--batch``/``--heads``/``--kv-heads``/
  ``--head_dim`` and ``--seq`` rows (every length ``--seq``);
* ``--space gemv`` sweeps ``--max-splits`` (the cap on the K splits of F1's
  ring plan or F2's tensor-core plan, ``ops/gemv.py``) for per-channel
  ``--gemv-bits`` weights at ``--gemv-m``/``--gemv-n``/``--gemv-k``, bf16 x,
  each call reading the weights from HBM (copies cycled past the 50 MB L2);
* ``--space k|q|bwd`` times the one design of kernel A (on C1's Q and K
  codes; the K-major and Q-major schedules are one kernel on the GPU) or
  of G1 + G2 at the shape: one row, ``"tunable": false``. A and G1/G2 run
  one tile plan each, so ``--save`` records nothing for them.

Candidates are timed in turns: ``--rounds`` rounds in one process, each
round timing every candidate once (in reverse order every other round) as
``--calls`` calls back to back between two CUDA events behind a device
sleep; a row reports the median ms a call and the spread (largest less
smallest round). ``--save`` records the median winner with its ``us`` and
``spread_us``; ``decode_attention`` and ``wq_matmul_per_channel`` then plan
with it whenever their ``waves``/``max_splits`` are left unset. One JSON line
a row, then ``{"best": ...}`` and ``{"saved": path}`` or ``{"not_saved":
...}``.

Usage (on the card):
  python -m lowbit_quant_fa2_paddle_tpu_torch.tools.autotune --space decode \\
      --kv-bits 8 --head_dim 128 --seq 32768 --save
  python -m lowbit_quant_fa2_paddle_tpu_torch.tools.autotune --space gemv \\
      --gemv-bits 4 --gemv-m 4 --gemv-n 4096 --gemv-k 4096 --save
  python -m lowbit_quant_fa2_paddle_tpu_torch.tools.autotune --space k --seq 4096
"""

from __future__ import annotations

import argparse
import functools
import itertools
import json
import math
import statistics
from typing import Callable, Dict, List, Optional, Sequence

import torch

from lowbit_quant_fa2_paddle_tpu_torch.utils.benchmark import SLEEP_CYCLES, attention_bwd_flops, attention_flops

KV_BITS = {"16": (16, 16), "8": (8, 8), "4": (4, 4), "k4v8": (4, 8)}


def _emit(row: dict) -> dict:
    print(json.dumps(row), flush=True)
    return row


def time_in_turns(fns: Dict[object, Callable[[], object]], *, rounds: int, calls: int) -> Dict[object, dict]:
    """Median and spread of each candidate's device ms a call, timed in
    turns: every round times each candidate once (the order reversed every
    other round), as ``calls`` calls back to back between two CUDA events
    behind a device-side sleep that outlasts their enqueue."""
    for fn in fns.values():  # warm-up: builds, lazily made buffers, clocks
        fn()
        fn()
    torch.cuda.synchronize()
    samples: Dict[object, List[float]] = {key: [] for key in fns}
    keys = list(fns)
    for r in range(rounds):
        for key in keys if r % 2 == 0 else reversed(keys):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(SLEEP_CYCLES)
            start.record()
            for _ in range(calls):
                fns[key]()
            end.record()
            end.synchronize()
            samples[key].append(start.elapsed_time(end) / calls)
    return {key: {"ms": statistics.median(s), "spread_ms": max(s) - min(s), "rounds": len(s)}
            for key, s in samples.items()}


def _winner(rows: Sequence[dict]) -> dict:
    return min(rows, key=lambda r: r["ms"])


def tune_decode(args) -> dict:
    """Sweep kernel D's ``waves`` at one (cache bits, geometry, S_max)
    point; with ``--save`` record the winner under ``decode_k{kb}v{vb}``,
    the head dim and ``pow2_bucket(S_max)``."""
    from lowbit_quant_fa2_paddle_tpu_torch.ops import decode as D
    from lowbit_quant_fa2_paddle_tpu_torch.utils import tuning

    kb, vb = KV_BITS[args.kv_bits]
    b, h, hk, d, s = args.batch, args.heads, args.kv_heads, args.head_dim, args.seq
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    q = torch.randn(b, h, d, generator=gen, device="cuda").bfloat16()
    kq, ks = D.quantize_token(torch.randn(b, hk, s, d, generator=gen, device="cuda").bfloat16(), bits=kb)
    vq, vs = D.quantize_token(torch.randn(b, hk, s, d, generator=gen, device="cuda").bfloat16(), bits=vb)
    lens = torch.full((b,), s, dtype=torch.int32, device="cuda")
    waves = sorted(set(args.waves))
    plans = {w: D.kernel_partition(q, kq, vq, int_qk=kb == 8, waves=w) for w in waves}
    fns = {w: functools.partial(D.decode_attention, q, kq, vq, ks, lens, v_scale=vs, k_bits=kb, v_bits=vb, waves=w)
           for w in waves}
    times = time_in_turns(fns, rounds=args.rounds, calls=args.calls)
    rows = [_emit({"space": "decode", "kv_bits": args.kv_bits, "waves": w, "n_splits": plans[w]["n_splits"],
                   "split_keys": plans[w]["split_keys"], **times[w], "heuristic": w == D.WAVES})
            for w in waves]
    best = _winner(rows)
    out = {"rows": rows, "best": best,
           "key": dict(kernel=f"decode_k{kb}v{vb}", d=d, s=tuning.pow2_bucket(s), causal=False)}
    _emit({"best": best, "space": "decode", "kv_bits": args.kv_bits, "seq": s})
    if args.save:
        out["saved"] = tuning.record(f"decode_k{kb}v{vb}", d, tuning.pow2_bucket(s), False, 0, 0,
                                     extra={"waves": best["waves"], "us": best["ms"] * 1e3,
                                            "spread_us": best["spread_ms"] * 1e3})
        _emit({"saved": out["saved"]})
    return out


def tune_gemv(args) -> dict:
    """Sweep the K-split cap of F1's ring plan (w8) or F2's tensor-core plan
    (w4) under ``wq_matmul_per_channel`` at one (bits, M, N, K) point; with
    ``--save`` record the winner under ``gemv_w{bits}``, K and
    ``pow2_bucket(N)``."""
    from lowbit_quant_fa2_paddle_tpu_torch.ops import gemv as G
    from lowbit_quant_fa2_paddle_tpu_torch.utils import tuning

    bits, m, n, k = args.gemv_bits, args.gemv_m, args.gemv_n, args.gemv_k
    cap = G.W8_MAX_SPLITS if bits == 8 else G.TC_MAX_SPLITS
    asked = args.max_splits or ([1, 2, 4, 8] + ([16] if bits == 8 else []))
    over = sorted(c for c in set(asked) if c > cap)
    if over:
        _emit({"skipped": over, "reason": f"above the plan's cap of {cap} K splits"})
    caps = sorted(c for c in set(asked) if 1 <= c <= cap)
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    x = torch.randn(m, k, generator=gen, device="cuda").bfloat16()
    packed, scale = G.pack_weights_per_channel(torch.randn(n, k, generator=gen, device="cuda") / math.sqrt(k),
                                               bits=bits)
    wbytes = packed.numel() + 4 * scale.numel()
    copies = min(64, max(2, math.ceil(128e6 / wbytes)))
    weights = [(packed.clone(), scale.clone()) for _ in range(copies)]
    n_sms = torch.cuda.get_device_properties(x.device).multi_processor_count

    def plan(c):
        if bits == 8:
            structure, _, ksplit, _, _ = G.w8_plan(m, n, k, n_sms, max_splits=c)
            return {"structure": structure, "ksplit": ksplit}
        return {"structure": "tensor_core", "ksplit": G.tc_plan(m, n, k, bits, n_sms, max_splits=c)[1]}

    def cycled(c):
        it = itertools.cycle(weights)

        def call():
            p, sc = next(it)
            return G.wq_matmul_per_channel(x, p, sc, bits=bits, max_splits=c)
        return call

    times = time_in_turns({c: cycled(c) for c in caps}, rounds=args.rounds, calls=args.calls)
    rows = [_emit({"space": "gemv", "bits": bits, "m": m, "n": n, "k": k, "max_splits": c, **plan(c), **times[c],
                   "heuristic": c == cap}) for c in caps]
    best = _winner(rows)
    out = {"rows": rows, "best": best, "key": dict(kernel=f"gemv_w{bits}", d=k, s=tuning.pow2_bucket(n),
                                                   causal=False)}
    _emit({"best": best, "space": "gemv", "bits": bits, "n": n, "k": k})
    if args.save:
        out["saved"] = tuning.record(f"gemv_w{bits}", k, tuning.pow2_bucket(n), False, 0, 0,
                                     extra={"max_splits": best["max_splits"], "us": best["ms"] * 1e3,
                                            "spread_us": best["spread_ms"] * 1e3})
        _emit({"saved": out["saved"]})
    return out


def time_attention(args) -> dict:
    """Time the one design of kernel A (``k``/``q``: C1's per-token Q and K
    codes, bf16 V) or of G1 + G2 (``bwd``: ``flash_bwd`` over the fp
    forward's outputs) at the shape: one row, nothing to tune."""
    from lowbit_quant_fa2_paddle_tpu_torch.ops import attention as A
    from lowbit_quant_fa2_paddle_tpu_torch.ops import attention_bwd as AB
    from lowbit_quant_fa2_paddle_tpu_torch.ops.quant import quant_int8

    b, h, s, d, causal = args.batch, args.heads, args.seq, args.head_dim, args.causal
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    q, k, v = (torch.randn(b, h, s, d, generator=gen, device="cuda").bfloat16() for _ in range(3))
    if args.space == "bwd":
        o, lse2 = A.flash_attention_fp(q, k, v, is_causal=causal, return_lse=True)
        do = torch.randn(b, h, s, d, generator=gen, device="cuda").bfloat16()
        fn = functools.partial(AB.flash_bwd, q, k, v, o, lse2, do, is_causal=causal, sm_scale=1.0 / math.sqrt(d))
        flops, design = attention_bwd_flops(b, h, d, s, s, causal), AB.kernel_design()
    else:
        (qc, qs), (kc, ksc) = quant_int8(q, gran="per_token"), quant_int8(k, gran="per_token")
        fn = functools.partial(A.lowbit_attention, qc, kc, v, qs, ksc, is_causal=causal)
        flops, design = attention_flops(b, h, d, s, s, causal), A.kernel_design()
    t = time_in_turns({args.space: fn}, rounds=args.rounds, calls=args.calls)[args.space]
    row = _emit({"space": args.space, "b": b, "h": h, "s": s, "d": d, "causal": causal, "design": design, **t,
                 "tflops": flops / (t["ms"] * 1e-3) / 1e12, "tunable": False})
    out = {"rows": [row], "best": row}
    _emit({"best": row, "space": args.space, "seq": s, "causal": causal})
    if args.save:
        out["not_saved"] = (f"kernel {'G1/G2' if args.space == 'bwd' else 'A'} runs one tile plan on the GPU: "
                            "nothing to record")
        _emit({"not_saved": out["not_saved"]})
    return out


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--heads", type=int, default=32)
    p.add_argument("--head_dim", type=int, default=64)
    p.add_argument("--seq", type=int, default=4096, help="sequence length; [decode] the cache's rows S_max")
    p.add_argument("--space", default="k", choices=["k", "q", "bwd", "decode", "gemv"])
    p.add_argument("--causal", action="store_true", help="[k, q, bwd] causal attention")
    p.add_argument("--kv-bits", default="8", choices=list(KV_BITS), help="[decode] cache precision")
    p.add_argument("--kv-heads", type=int, default=8, help="[decode] Hk")
    p.add_argument("--waves", type=float, nargs="+", default=[0.5, 1.0, 2.0, 4.0],
                   help="[decode] waves of resident CTAs the split-KV plan fills")
    p.add_argument("--gemv-n", type=int, default=11008)
    p.add_argument("--gemv-k", type=int, default=4096)
    p.add_argument("--gemv-m", type=int, default=8)
    p.add_argument("--gemv-bits", type=int, default=8, choices=[8, 4])
    p.add_argument("--max-splits", type=int, nargs="+", default=None,
                   help="[gemv] caps on the plan's K splits (default 1 2 4 8, and 16 for w8)")
    p.add_argument("--rounds", type=int, default=5, help="rounds of turns over the candidates")
    p.add_argument("--calls", type=int, default=20, help="calls back to back a timed sample")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--save", action="store_true",
                   help="record the winner in the tuning cache (utils/tuning.py); the launchers then use it "
                        "whenever waves / max_splits are left unset for this key")
    return p


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Parse ``argv`` (default ``sys.argv[1:]``), run the space on the card,
    print its JSON lines and return its rows, winner and what was saved."""
    args = parser().parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("the autotuner times kernels on a CUDA card; none is available")
    if args.rounds < 1 or args.calls < 1:
        raise ValueError("--rounds and --calls must be at least 1")
    if any(not 0 < w < math.inf for w in args.waves):
        raise ValueError(f"--waves must be positive numbers: {args.waves}")
    if args.space == "decode":
        return tune_decode(args)
    if args.space == "gemv":
        return tune_gemv(args)
    return time_attention(args)


if __name__ == "__main__":
    main()
