"""Compare two ways of timing a kernel on one CUDA card, in one process:
CUDA events with the start event recorded on an idle card (old; each
interval then holds the host's enqueue of the call) and the port's
``utils.benchmark.cuda_time_ms``, which sleeps on the device first (new).
Runs C1, A (int8), D (int8 cache) and F1 (w8) in turns old, new, new, old
and prints the card's name and power limit and each reading.

    python3 script/torch_timer_ab.py
"""
import os
import statistics
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
import torch
from lowbit_quant_fa2_paddle_tpu_torch.ops import _build, gemv
from lowbit_quant_fa2_paddle_tpu_torch.ops.attention import lowbit_attention
from lowbit_quant_fa2_paddle_tpu_torch.ops.decode import decode_attention, quantize_token
from lowbit_quant_fa2_paddle_tpu_torch.ops.quant import k_mean, quant_int8
from lowbit_quant_fa2_paddle_tpu_torch.utils.benchmark import cuda_time_ms as new_timer

print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                     capture_output=True, text=True).stdout.strip())

def old_timer(fn, *, warmup=3, reps=10):
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record(); fn(); e.record(); e.synchronize()
        times.append(s.elapsed_time(e))
    return statistics.median(times)

_build.library()
g = torch.Generator(device="cuda").manual_seed(0)
k = torch.randn(1, 30, 17776, 64, generator=g, device="cuda").bfloat16()
km = k_mean(k)
kc, ks = quant_int8(k, km, gran="per_token")
q = torch.randn(1, 30, 17776, 64, generator=g, device="cuda").bfloat16()
kd = torch.randn(4, 8, 32768, 128, generator=g, device="cuda").bfloat16()
(kq, kqs), (vq, vqs) = quantize_token(kd, bits=8), quantize_token(kd, bits=8)
qd = torch.randn(4, 32, 128, generator=g, device="cuda").bfloat16()
lens = torch.full((4,), 32768, dtype=torch.int32, device="cuda")
x = torch.randn(4, 4096, generator=g, device="cuda").bfloat16()
cases = {"C1 b1 h30 s17776 d64": lambda: quant_int8(k, km, gran="per_token"),
         "A int8 b1 h30 s17776 d64": lambda: lowbit_attention(q, kc, q, None, ks),
         "D int8 b4 h32 hk8 s32768 d128": lambda: decode_attention(qd, kq, vq, kqs, lens, v_scale=vqs)}
for n in (16384, 1024):
    p, s = gemv.pack_weights_per_channel(torch.randn(n, 4096, generator=g, device="cuda") / 64, bits=8)
    cases[f"F1 w8 M4 N{n} K4096 (L2-warm)"] = (lambda p=p, s=s: gemv.wq_matmul_per_channel(x, p, s))
for name, fn in cases.items():
    reps = 10 if name.startswith("A") else 50
    r = [old_timer(fn, reps=reps), new_timer(fn, reps=reps), new_timer(fn, reps=reps), old_timer(fn, reps=reps)]
    print(f"{name}: old {r[0]:.4f} / {r[3]:.4f} ms, new {r[1]:.4f} / {r[2]:.4f} ms, "
          f"old - new {(r[0] + r[3] - r[1] - r[2]) / 2 * 1e3:.1f} us")
