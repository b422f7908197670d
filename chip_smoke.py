#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (H100, sm_90a).

    python3 chip_smoke.py

Phases, each of which raises on failure (exit code 1, no result line):

1. device: a CUDA card is required; prints nvidia-smi's name and power limit;
2. build: compiles the port's kernels (csrc/*.cu) with nvcc, prints seconds
   and each kernel's registers and spills;
3. kernel C1 (quant_int8) against its plain PyTorch version on the card at
   the CogVideoX-2b K shape b1 h30 s17776 d64 with the K mean, per token and
   per block, and at a ragged s1000: codes and scales must be equal;
4. kernel A (lowbit_attention) against its plain version: int8 with Q
   quantized in the kernel, int8 with external Q codes, fp, causal, GQA
   8q/2kv, d128, ragged s1000, smooth-V, with and without the LSE, and at
   b1 h30 s17776 d64 (int8 and fp), timed beside PyTorch's SDPA as a
   baseline. The plain version rounds P where the
   kernel does and differs only in summation order, so the bounds are
   cos >= 0.99999, max|do| <= 2e-2 (a bf16 ulp of outputs up to 4 is 1.6e-2)
   and max|dlse| <= 1e-3;
5. main path: the full-width, full-depth CogVideoX-2b DiT (dim 1920, 30
   heads x 64, depth 30, random weights from a seeded generator) takes 3
   denoise steps x <- x - 0.1 * eps on b1 s17776 latents with
   attn_impl="int8", then 3 with "fp". The frames must be finite and agree
   (cos >= 0.999), and the launch counters must show every attention call
   went through kernel A (90 per impl) and every K quantization through C1
   (90).

Then one JSON line of kernel records, and last
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import math
import os
import re
import subprocess
import sys
import time
import traceback

import torch

REPO = os.path.dirname(os.path.abspath(__file__))
PKG = "lowbit_quant_fa2_paddle_tpu_torch"
B, H, S, D = 1, 30, 17776, 64
COS_MIN, MAX_DO, MAX_DLSE = 0.99999, 2e-2, 1e-3
STEPS = 3


def log(*a):
    print(*a, flush=True)


def device_phase():
    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is False: this smoke run needs a CUDA card")
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()
    log(out[0])
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"torch {torch.__version__} cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}"
        f" count {torch.cuda.device_count()}")
    return out[0]


def build_phase():
    from lowbit_quant_fa2_paddle_tpu_torch.ops import _build

    t0 = time.perf_counter()
    _build.library()
    secs = time.perf_counter() - t0
    log(f"[build] {secs:.1f} s")
    with open(_build.library_path() + ".log") as f:
        text = f.read()
    for name, spill, regs in re.findall(
        r"Function properties for (\S+)\n\s+(.*spill loads)\n.*?Used (\d+) registers", text
    ):
        log(f"[build] regs={regs:>3} {spill.strip()} {name[:90]}")
    return secs


def stats(o, o_ref, lse=None, lse_ref=None):
    from lowbit_quant_fa2_paddle_tpu_torch.ops.metrics import cosine_similarity

    r = {
        "cos": float(cosine_similarity(o, o_ref)),
        "max_do": float((o.float() - o_ref.float()).abs().max()),
        "finite": bool(torch.isfinite(o.float()).all()),
    }
    if lse is not None:
        r["max_dlse"] = float((lse - lse_ref).abs().max())
    return r


def check_close(name, r):
    ok = r["finite"] and r["cos"] >= COS_MIN and r["max_do"] <= MAX_DO and r.get("max_dlse", 0.0) <= MAX_DLSE
    log(f"[A] {name}: " + " ".join(f"{k}={v:.6g}" if isinstance(v, float) else f"{k}={v}" for k, v in r.items()))
    if not ok:
        raise AssertionError(f"kernel A disagrees with its plain version in case {name}: {r}")


def quant_phase(gen):
    from lowbit_quant_fa2_paddle_tpu_torch.ops.quant import k_mean, quant_int8, quant_int8_plain
    from lowbit_quant_fa2_paddle_tpu_torch.utils.benchmark import cuda_time_ms

    worst = 0.0
    for s, gran, block in [(S, "per_token", 128), (S, "per_block", 64), (1000, "per_token", 128),
                           (1000, "per_block", 64)]:
        k = (torch.randn(B, H, s, D, generator=gen, device="cuda") + 0.5).bfloat16()
        km = k_mean(k)
        codes, scale = quant_int8(k, km, gran=gran, block=block)
        want_c, want_s = quant_int8_plain(k, km, per_token=gran == "per_token", block=block)
        torch.cuda.synchronize()
        dc = int((codes.int() - want_c.int()).abs().max())
        ds = float((scale - want_s).abs().max())
        worst = max(worst, dc, ds)
        log(f"[C1] s{s} {gran}: codes_equal={torch.equal(codes, want_c)} scales_equal={torch.equal(scale, want_s)}")
        if not (torch.equal(codes, want_c) and torch.equal(scale, want_s)):
            raise AssertionError(f"kernel C1 differs from its plain version at s{s} {gran}: {dc} {ds}")
    k = torch.randn(B, H, S, D, generator=gen, device="cuda").bfloat16()
    km = k_mean(k)
    ms = cuda_time_ms(lambda: quant_int8(k, km, gran="per_token"), warmup=3, reps=20)
    plain_ms = cuda_time_ms(lambda: quant_int8_plain(k, km, per_token=True, block=128), warmup=1, reps=5)
    log(f"[C1] b{B} h{H} s{S} d{D} per_token bf16: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
    return {"max_abs_err": worst, "ms": ms, "plain_ms": plain_ms}


def attn_inputs(gen, h, hk, s, d, mode, causal=False, smooth_v=False):
    from lowbit_quant_fa2_paddle_tpu_torch.ops.attention import LOG2E
    from lowbit_quant_fa2_paddle_tpu_torch.ops.quant import k_mean, quant_int8

    q = torch.randn(1, h, s, d, generator=gen, device="cuda").bfloat16()
    k = (torch.randn(1, hk, s, d, generator=gen, device="cuda") + 0.3).bfloat16()
    v = torch.randn(1, hk, s, d, generator=gen, device="cuda").bfloat16()
    vm = torch.randn(1, hk, d, generator=gen, device="cuda") if smooth_v else None
    c = 1.0 / math.sqrt(d) * LOG2E
    q_scale = k_scale = qs = None
    if mode != "fp":
        k, k_scale = quant_int8(k, k_mean(k), gran="per_token")
    if mode == "int8":
        q, q_scale = quant_int8(q, gran="per_token")
        qs = q_scale * torch.tensor(c, dtype=torch.float32, device="cuda")
    kernel_args = (q, k, v, q_scale, k_scale)
    plain_args = (q, k, v, qs, k_scale, vm)
    return kernel_args, plain_args, dict(v_mean=vm, is_causal=causal), c


def attention_phase(gen):
    from lowbit_quant_fa2_paddle_tpu_torch.ops.attention import attention_fwd_plain, lowbit_attention
    from lowbit_quant_fa2_paddle_tpu_torch.utils.benchmark import attention_flops, cuda_time_ms, tflops

    cases = [
        ("int8 fused-Q", dict(h=8, hk=8, s=2048, d=64, mode="fused")),
        ("int8 external-Q", dict(h=8, hk=8, s=2048, d=64, mode="int8")),
        ("fp", dict(h=8, hk=8, s=2048, d=64, mode="fp")),
        ("int8 causal", dict(h=8, hk=8, s=2048, d=64, mode="fused", causal=True)),
        ("fp causal", dict(h=8, hk=8, s=2048, d=64, mode="fp", causal=True)),
        ("int8 GQA 8q/2kv", dict(h=8, hk=2, s=2048, d=64, mode="fused")),
        ("int8 d128", dict(h=8, hk=8, s=2048, d=128, mode="fused")),
        ("fp d128 causal", dict(h=8, hk=4, s=1500, d=128, mode="fp", causal=True)),
        ("int8 ragged s1000", dict(h=8, hk=8, s=1000, d=64, mode="int8")),
        ("int8 smooth-V", dict(h=8, hk=8, s=1000, d=64, mode="fused", smooth_v=True)),
    ]
    for name, kw in cases:
        kargs, pargs, opts, c = attn_inputs(gen, **kw)
        o, lse = lowbit_attention(*kargs, **opts, return_lse=True)
        o_ref, lse_ref = attention_fwd_plain(*pargs, causal=opts["is_causal"], sm_scale_log2e=c,
                                             out_dtype=torch.bfloat16)
        torch.cuda.synchronize()
        check_close(name, stats(o, o_ref, lse, lse_ref))
        if name == "int8 fused-Q":  # the no-LSE launch writes the same output
            o2 = lowbit_attention(*kargs, **opts)
            if not torch.equal(o2, o):
                raise AssertionError("kernel A output differs with return_lse=False")
            log("[A] return_lse=False: output identical")
    records = {}
    for mode in ("fused", "fp"):
        kargs, pargs, opts, c = attn_inputs(gen, H, H, S, D, mode)
        o, lse = lowbit_attention(*kargs, **opts, return_lse=True)

        def plain():
            return attention_fwd_plain(*pargs, causal=False, sm_scale_log2e=c, out_dtype=torch.bfloat16)

        o_ref, lse_ref = plain()
        torch.cuda.synchronize()
        r = stats(o, o_ref, lse, lse_ref)
        check_close(f"{mode} b{B} h{H} s{S} d{D}", r)
        del o_ref, lse_ref
        ms = cuda_time_ms(lambda: lowbit_attention(*kargs, **opts), warmup=2, reps=10)
        plain_ms = cuda_time_ms(plain, warmup=1, reps=3)
        tf = tflops(attention_flops(B, H, D, S, S, False), ms / 1e3)
        log(f"[A] {mode} b{B} h{H} s{S} d{D}: kernel {ms:.3f} ms ({tf:.1f} TFLOP/s), plain {plain_ms:.3f} ms")
        records[mode] = {"max_abs_err": r["max_do"], "ms": ms, "plain_ms": plain_ms, "tflops": tf}
    # Baseline only (a library kernel, not the port): PyTorch's SDPA in bf16.
    q, k, v = (torch.randn(B, H, S, D, generator=gen, device="cuda").bfloat16() for _ in range(3))
    sdpa_ms = cuda_time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(q, k, v), warmup=2, reps=10)
    tf = tflops(attention_flops(B, H, D, S, S, False), sdpa_ms / 1e3)
    log(f"[A] baseline torch SDPA bf16 b{B} h{H} s{S} d{D}: {sdpa_ms:.3f} ms ({tf:.1f} TFLOP/s)")
    records["sdpa_baseline_ms"] = sdpa_ms
    return records


def main_path_phase():
    from lowbit_quant_fa2_paddle_tpu_torch.models import dit
    from lowbit_quant_fa2_paddle_tpu_torch.ops.attention import lowbit_attention
    from lowbit_quant_fa2_paddle_tpu_torch.ops.metrics import cosine_similarity, mse
    from lowbit_quant_fa2_paddle_tpu_torch.ops.quant import quant_int8

    cfg = dit.cogvideox_2b_config()
    gen = torch.Generator(device="cuda").manual_seed(0)
    t0 = time.perf_counter()
    model = dit.init_dit_params(cfg, gen, device="cuda")
    n_params = sum(p.numel() for p in model.parameters())
    x0 = torch.randn(1, S, cfg.dim, generator=gen, device="cuda").to(cfg.dtype)
    torch.cuda.synchronize()
    log(f"[dit] cogvideox_2b dim {cfg.dim} depth {cfg.depth} heads {cfg.num_heads}x{cfg.head_dim}: "
        f"{n_params / 1e9:.3f} B params, init {time.perf_counter() - t0:.1f} s")
    ts = [torch.tensor([1000.0 * (1.0 - i / STEPS)], device="cuda") for i in range(STEPS)]

    with torch.inference_mode():
        for impl in ("int8", "fp"):  # warm-up, outside the counted run
            dit.dit_forward(model, x0, ts[0], attn_impl=impl)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        quant_int8.launches = lowbit_attention.launches = 0
        frames, step_ms, counts, eps0 = {}, {}, {}, {}
        for impl in ("int8", "fp"):
            x = x0
            times = []
            for i, t in enumerate(ts):
                t1 = time.perf_counter()
                eps = dit.dit_forward(model, x, t, attn_impl=impl)
                x = x - 0.1 * eps
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t1) * 1e3)
                if i == 0:
                    eps0[impl] = eps.float()
            frames[impl], step_ms[impl] = x.float(), times
            counts[impl] = (lowbit_attention.launches, quant_int8.launches)
        peak = torch.cuda.max_memory_allocated()
    launches_a_int8, launches_c1 = counts["int8"]
    launches_a_fp = counts["fp"][0] - counts["int8"][0]
    c1_in_fp = counts["fp"][1] - counts["int8"][1]
    cos = float(cosine_similarity(frames["int8"], frames["fp"]))
    err = float(mse(frames["int8"], frames["fp"]))
    eps_cos = float(cosine_similarity(eps0["int8"], eps0["fp"]))
    for impl in ("int8", "fp"):
        log(f"[dit] {impl}: ms/step " + ", ".join(f"{t:.1f}" for t in step_ms[impl]))
    log(f"[dit] peak memory {peak / 2**30:.2f} GiB; int8 vs fp frame cos {cos:.6f} mse {err:.3e}; "
        f"first-step eps cos {eps_cos:.6f}")
    log(f"[dit] launches: A int8 {launches_a_int8}, A fp {launches_a_fp}, C1 {launches_c1} (+{c1_in_fp} in fp)")
    want = cfg.depth * STEPS
    if not all(bool(torch.isfinite(f).all()) for f in frames.values()):
        raise AssertionError("non-finite DiT frames")
    if cos < 0.999:
        raise AssertionError(f"int8 vs fp frame cos {cos} < 0.999")
    if (launches_a_int8, launches_a_fp, launches_c1, c1_in_fp) != (want, want, want, 0):
        raise AssertionError(f"launch counts {counts} != {want} per impl")
    return {
        "launches": {"quant_int8": launches_c1, "attention_int8": launches_a_int8, "attention_fp": launches_a_fp},
        "ms_per_step": step_ms, "peak_gib": peak / 2**30, "frame_cos": cos, "frame_mse": err, "eps_cos": eps_cos,
    }


def main():
    smi = device_phase()
    sys.path.insert(0, REPO)
    if not os.path.isdir(os.path.join(REPO, PKG)):
        raise RuntimeError(f"the port package {PKG}/ is not next to chip_smoke.py")
    build_s = build_phase()
    gen = torch.Generator(device="cuda").manual_seed(1234)
    c1 = quant_phase(gen)
    attn = attention_phase(gen)
    torch.cuda.empty_cache()
    dit_r = main_path_phase()
    src = f"{PKG}/csrc"
    kernels = [
        dict(name="quant_int8", route="cuda", source=f"{src}/quant_int8.cu",
             replaces="lowbit_quant_fa2_paddle_tpu/ops/quant.py:215",
             launches=dit_r["launches"]["quant_int8"], **c1),
        dict(name="attention_fwd (int8, Q quantized in-kernel)", route="cuda", source=f"{src}/attention_fwd.cu",
             replaces="lowbit_quant_fa2_paddle_tpu/ops/attention.py:1502",
             launches=dit_r["launches"]["attention_int8"],
             **{k: attn["fused"][k] for k in ("max_abs_err", "ms", "plain_ms")}),
        dict(name="attention_fwd (fp)", route="cuda", source=f"{src}/attention_fwd.cu",
             replaces="lowbit_quant_fa2_paddle_tpu/ops/attention.py:1502",
             launches=dit_r["launches"]["attention_fp"],
             **{k: attn["fp"][k] for k in ("max_abs_err", "ms", "plain_ms")}),
    ]
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": device}))


if __name__ == "__main__":
    try:
        main()
    except Exception:
        traceback.print_exc()
        print("chip_smoke: FAILED", file=sys.stderr)
        sys.exit(1)
