"""What a head dim taken at run time costs kernels D and E, on one CUDA card.

    python3 script/torch_head_dims_ab.py

Kernel D: at head dims 96 (its off-ladder instance, decode_attention_d80_96.cu)
and 128 (decode_attention.cu), b8 h32 hk32 S_max 4096, in four cache modes
(int8, bf16, int4 on the float chain, k4v8 on the integer chain), the fixed
instance against the run-time one (decode_attention_dyn.cu, laid out for 128)
on the same inputs, in turns (fixed, run time, fixed, run time: the C entry
is swapped through ops.decode._entry); prints both times and whether the
outputs are the same bits (the integer chain's are; the float chain may sum
otherwise). Then D at MPT-30B's decode shape (b8 h64 hk64 S_max 4096 d112),
run time only. Kernel E: int4 at b4 h32 s8192 (group 256) at head dim 128 on
its own kernel against 112 and 96 on the d128 kernel with the head dim at run
time, and 256 against 192, in turns. Times by utils/benchmark.cuda_time_ms.
"""

from __future__ import annotations

import os
import sys

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from lowbit_quant_fa2_paddle_tpu_torch.ops import _build  # noqa: E402
from lowbit_quant_fa2_paddle_tpu_torch.ops import decode as DD  # noqa: E402
from lowbit_quant_fa2_paddle_tpu_torch.ops import fused_kv as FK  # noqa: E402
from lowbit_quant_fa2_paddle_tpu_torch.utils.benchmark import cuda_time_ms  # noqa: E402

MODES = ((8, 8, "auto"), (16, 16, "auto"), (4, 4, "auto"), (4, 8, "int_qk"))


def run_time_entry(lib, name, d):
    """The run-time instances' C entry, whatever the head dim."""
    return getattr(lib, name + "_dyn")


def decode_rows(gen):
    fixed_entry = DD._entry
    for d, (b, h, hk, s) in ((96, (8, 32, 32, 4096)), (128, (8, 32, 32, 4096)), (112, (8, 64, 64, 4096))):
        for k_bits, v_bits, mode in MODES:
            k = torch.randn(b, hk, s, d, generator=gen, device="cuda").bfloat16()
            v = torch.randn(b, hk, s, d, generator=gen, device="cuda").bfloat16()
            (kq, ks), (vq, vs) = DD.quantize_token(k, bits=k_bits), DD.quantize_token(v, bits=v_bits)
            del k, v
            q = torch.randn(b, h, d, generator=gen, device="cuda").bfloat16()
            lens = torch.full((b,), s, dtype=torch.int32, device="cuda")
            kw = dict(v_scale=vs if v_bits != 16 else None, k_bits=k_bits, v_bits=v_bits, compute_mode=mode,
                      return_lse=True)
            sides = (("run time", run_time_entry),) if d not in DD.HEAD_DIMS else (
                ("fixed", fixed_entry), ("run time", run_time_entry))
            times, outs = {}, {}
            try:
                for _ in range(2):
                    for name, entry in sides:
                        DD._entry = entry
                        DD._resident_ctas.cache_clear()  # the occupancy query goes through the entry too
                        call = lambda: DD.decode_attention(q, kq, vq, ks, lens, **kw)  # noqa: E731
                        outs.setdefault(name, call())
                        times.setdefault(name, []).append(cuda_time_ms(call, warmup=5, reps=50))
            finally:
                DD._entry = fixed_entry
                DD._resident_ctas.cache_clear()
            line = f"[D] d{d} k{k_bits}v{v_bits} {mode} b{b} h{h} hk{hk} S_max {s}: " + ", ".join(
                f"{name} {[round(t, 4) for t in ts]} ms" for name, ts in times.items())
            if len(outs) == 2:
                (o1, l1), (o2, l2) = outs["fixed"], outs["run time"]
                line += (f"; same bits {torch.equal(o1, o2) and torch.equal(l1, l2)} (max|do| "
                         f"{float((o1.float() - o2.float()).abs().max()):.3g})")
            print(line, flush=True)
            del kq, vq, ks, vs, q, outs
            torch.cuda.empty_cache()


def fused_kv_rows(gen):
    for dims in ((128, 112, 96), (256, 192)):
        args = {}
        for d in dims:
            q = torch.randn(4, 32, 8192, d, generator=gen, device="cuda").bfloat16()
            k = (torch.randn(4, 32, 8192, d, generator=gen, device="cuda") + 0.5).bfloat16()
            v = (torch.randn(4, 32, 8192, d, generator=gen, device="cuda") - 0.3).bfloat16()
            (kp, ks, km), (vp, vs, vm) = FK.quant_kv_grouped(k, bits=4), FK.quant_kv_grouped(v, bits=4)
            args[d] = (q, kp, vp, ks, km, vs, vm)
        times = {d: [] for d in dims}
        for _ in range(2):
            for d in dims:
                times[d].append(cuda_time_ms(lambda: FK.fused_packed_kv_attention(*args[d], bits=4), warmup=2,
                                             reps=10))
        print("[E] int4 b4 h32 s8192 ms by head dim: " + ", ".join(f"d{d} {[round(t, 3) for t in ts]}"
                                                                  for d, ts in times.items()), flush=True)
        del args
        torch.cuda.empty_cache()


def main():
    if not torch.cuda.is_available():
        raise SystemExit("a CUDA card is required")
    _build.library()
    gen = torch.Generator(device="cuda").manual_seed(0)
    decode_rows(gen)
    fused_kv_rows(gen)


if __name__ == "__main__":
    main()
