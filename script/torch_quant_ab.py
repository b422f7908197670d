"""Kernels C1/C2/C3 (quant_int8, quant_int4, quant_int2) against variants of
their own source and against another tree's build, on one CUDA card.

    python3 script/torch_quant_ab.py [--base DIR] [--profile] [all | VARIANT ...]

Each variant is a patch of ``csrc/quant.cu`` (see VARIANTS), built in its own
copy of the package under ``build/quant_ab/<name>/``; ``--base DIR`` adds the
package of another tree as "base" (for example the parent commit unpacked by
``git archive`` into a directory that ``.gitignore`` lists). Every build (the
checkout's as "main", then base and each variant) times, in its own process
with ``utils.benchmark.cuda_time_ms``, the cases of CASES with the K mean
(as the attention entry points call them): C1, C2 and C3 per token at the
DiT's K (b1 h30 s17776 d64 bf16), contiguous and as the strided view of the
qkv projection that the DiT hands over; C1 per token at the LLM prefill's K
(b4 h8 s32704 d128); C1 and C3 per block 64 at the DiT shape; and
``k_mean`` on the strided DiT K. Calls alternate between two copies of the input, so every call
reads it from HBM (each is larger than the 50 MB L2). It prints ms, GB/s of
the bytes the function must move (x read once, codes and scales written once)
and the share of the bound at 3.35 TB/s. The processes run in turns main,
base, v1, v2, ..., then the same in reverse. With ``--profile``, main and
base each then run one int8 denoise step of the full-width CogVideoX-2b DiT
under ``torch.profiler`` (chip_smoke.py's ``dit_step_profile``: device ms and
kernel counts of A, C1/C2, copies, means, GEMMs and the rest). Prints the
card's name and power limit first. Named variants run; ``all`` runs every
variant; with none named, main runs against base alone. The
probes give wrong results on purpose: they time a part of the kernel.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = "lowbit_quant_fa2_paddle_tpu_torch"
SRC = "csrc/quant.cu"
HBM_BYTES_PER_S = 3.35e12

_GROUP_MATH = '''    float v[E];
    typename Stat<BITS>::T m = 0;
    centre<BITS, T>(raw[g], kmv, v, m);
#pragma unroll
    for (int o = LANES / 2; o > 0; o >>= 1) m = Stat<BITS>::merge(m, __shfl_xor_sync(kFull, m, o));
    const float s = Stat<BITS>::scale(m, D);
    sc[g] = s;
    uint32_t w[E / 4];
    lane_codes<BITS>(v, s, __frcp_rn(s), w);
'''
_INT2_MATH = '''    float v[kGroups][E];
    double sum[kGroups];
#pragma unroll
    for (int g = 0; g < kGroups; ++g) {
      sum[g] = 0.0;
      centre<BITS, T>(raw[g], kmv, v[g], sum[g]);
#pragma unroll
      for (int o = LANES / 2; o > 0; o >>= 1) sum[g] = Stat<BITS>::merge(sum[g], __shfl_xor_sync(kFull, sum[g], o));
    }
    double mine = 0.0;
#pragma unroll
    for (int g = 0; g < kGroups; ++g) {
      const double r = __shfl_sync(kFull, sum[g], (lane % RPW) * LANES);
      if (lane / RPW == g) mine = r;
    }
    const float sj = Stat<BITS>::scale(mine, D), rj = __frcp_rn(sj);
#pragma unroll
    for (int g = 0; g < kGroups; ++g) {
      const int r = row0 + g * RPW + sub;
      uint32_t w[E / 4];
      lane_codes<BITS>(v[g], __shfl_sync(kFull, sj, g * RPW + sub), __shfl_sync(kFull, rj, g * RPW + sub), w);
'''
_TOKEN_BOUNDS = "__global__ void __launch_bounds__(kThreads) quant_per_token_vec("
_ROUND = '''  float n = __fsub_rn(__fadd_rn(q0, kMagic), kMagic);
  if (fabsf(__fsub_rn(q0, n)) > 0.5f - 0x1p-15f) n = roundf(__fdiv_rn(v, s));
'''
_TOKEN_ROWS = '''  const int bh = blockIdx.x % BH;
  const int warp = threadIdx.x / 32, lane = threadIdx.x & 31;
  const int sub = lane / LANES, t = lane % LANES;
  const int row0 = (blockIdx.x / BH) * ROWS_CTA + warp * ROWS_WARP;
'''

# name: (what it changes, [(old, new), ...] on csrc/quant.cu)
VARIANTS = {
    "copy-only": ("probe, wrong results: per token, the vector design's loads and stores (codes, the INT4 and "
                  "INT2 shuffles, the gathered scales) with no statistic, no reduction and no division",
                  [(_GROUP_MATH, '''    const float s = __uint_as_float(raw[g].x);
    sc[g] = s;
    uint32_t w[E / 4];
#pragma unroll
    for (int k = 0; k < E / 4; ++k) w[k] = (k ? raw[g].z : raw[g].x) ^ raw[g].y ^ raw[g].w;
'''), (_INT2_MATH, '''    const float sj = __uint_as_float(raw[0].x ^ raw[kGroups - 1].y);
#pragma unroll
    for (int g = 0; g < kGroups; ++g) {
      const int r = row0 + g * RPW + sub;
      uint32_t w[E / 4];
#pragma unroll
      for (int k = 0; k < E / 4; ++k) w[k] = ((k ? raw[g].z : raw[g].x) ^ raw[g].y ^ raw[g].w) & 0x03030303u;
''')]),
    "exact-div": ("every code by the IEEE division (no reciprocal fast path); same results",
                  [(_ROUND, "  float n = roundf(__fdiv_rn(v, s));\n  (void)q0;\n")]),
    "groups2": ("per token, two row groups a warp loaded before any math, not four",
                [("constexpr int kGroups = 4;", "constexpr int kGroups = 2;")]),
    "groups8": ("per token, eight row groups a warp loaded before any math, not four",
                [("constexpr int kGroups = 4;", "constexpr int kGroups = 8;")]),
    "minblocks8": ("per token, __launch_bounds__(256, 8): at most 32 registers, 64 warps an SM",
                   [(_TOKEN_BOUNDS, "__global__ void __launch_bounds__(kThreads, 8) quant_per_token_vec(")]),
    "block-regs8": ("per block, blocks of two loads on the kernel with registers for eight (4 CTAs an SM), "
                    "not on the two-load kernel (8 CTAs an SM)",
                    [("    if (block * LANES / kThreads <= kFewLoads) {", "    if (false) {")]),
    "head-major": ("per token, CTAs walk the rows of one (b, h) before the next, not (b, h) fastest",
                   [(_TOKEN_ROWS, _TOKEN_ROWS.replace("blockIdx.x % BH", "blockIdx.x / (gridDim.x / BH)")
                     .replace("(blockIdx.x / BH)", "(blockIdx.x % (gridDim.x / BH))"))]),
}

DIT = (1, 30, 17776, 64)
# name: (function, bits, gran, block, (B, H, S, D), layout)
CASES = {
    "C1 per token DiT K contiguous": ("quant", 8, "per_token", 128, DIT, "contiguous"),
    "C1 per token DiT K view": ("quant", 8, "per_token", 128, DIT, "view"),
    "C1 per token LLM prefill K": ("quant", 8, "per_token", 128, (4, 8, 32704, 128), "contiguous"),
    "C1 per block 64 DiT K contiguous": ("quant", 8, "per_block", 64, DIT, "contiguous"),
    "C2 per token DiT K contiguous": ("quant", 4, "per_token", 128, DIT, "contiguous"),
    "C2 per token DiT K view": ("quant", 4, "per_token", 128, DIT, "view"),
    "C3 per token DiT K contiguous": ("quant", 2, "per_token", 128, DIT, "contiguous"),
    "C3 per token DiT K view": ("quant", 2, "per_token", 128, DIT, "view"),
    "C3 per block 64 DiT K contiguous": ("quant", 2, "per_block", 64, DIT, "contiguous"),
    "k_mean DiT K view": ("k_mean", 16, None, None, DIT, "view"),
}


def _k(shape, layout, gen):
    import torch

    b, h, s, d = shape
    if layout == "contiguous":
        return torch.randn(b, h, s, d, generator=gen, device="cuda").bfloat16()
    qkv = torch.randn(b, s, 3 * h * d, generator=gen, device="cuda").bfloat16().reshape(b, s, 3, h, d)
    return qkv[:, :, 1].transpose(1, 2)


def worker(tag: str, profile: bool) -> None:
    """Time the cases with the package in the current directory."""
    sys.path.insert(0, os.getcwd())
    import torch
    from lowbit_quant_fa2_paddle_tpu_torch.ops import quant as Q
    from lowbit_quant_fa2_paddle_tpu_torch.utils.benchmark import cuda_time_ms

    gen = torch.Generator(device="cuda").manual_seed(0)
    out, rec = [], {}
    for name, (fn, bits, gran, block, shape, layout) in CASES.items():
        ks = [_k(shape, layout, gen) for _ in range(2)]
        kms = [Q.k_mean(k) for k in ks]
        b, h, s, d = shape
        if fn == "k_mean":
            calls = [lambda k=k: Q.k_mean(k) for k in ks]
            moved = b * h * s * d * 2 + b * h * d * 4
        else:
            quant = {8: Q.quant_int8, 4: Q.quant_int4, 2: Q.quant_int2}[bits]
            calls = [lambda k=k, km=km: quant(k, km, gran=gran, block=block) for k, km in zip(ks, kms)]
            moved = b * h * s * d * 2 + b * h * d * 4 + b * h * s * d * bits // 8 + b * h * s * 4
        turn = [0]

        def call():
            turn[0] ^= 1
            return calls[turn[0]]()

        ms = cuda_time_ms(call, warmup=4, reps=30)
        bound_ms = moved / HBM_BYTES_PER_S * 1e3
        out.append(f"{name} {ms * 1e3:.1f} us ({moved / ms / 1e6:.0f} GB/s, {bound_ms / ms:.0%} of bound)")
        rec[name] = {"ms": ms, "gb_per_s": moved / ms / 1e6, "bound_ms": bound_ms}
        del ks, kms, calls
        torch.cuda.empty_cache()
    print(f"[{tag}] " + " | ".join(out), flush=True)
    if profile:
        rec["dit int8 step profile"] = dit_profile(tag)
    print(json.dumps({"build": tag, "times": rec}), flush=True)


def dit_profile(tag: str) -> dict:
    """One int8 denoise step of the full-width CogVideoX-2b DiT under
    torch.profiler, split as chip_smoke.py's phase 5 splits it."""
    import torch

    sys.path.insert(1, REPO)
    from chip_smoke import dit_step_profile
    from lowbit_quant_fa2_paddle_tpu_torch.models import dit

    cfg = dit.cogvideox_2b_config()
    gen = torch.Generator(device="cuda").manual_seed(0)
    model = dit.init_dit_params(cfg, gen)
    x0 = torch.randn(1, DIT[2], cfg.dim, generator=gen, device="cuda").to(cfg.dtype)
    t = torch.tensor([1000.0], device="cuda")
    with torch.inference_mode():
        dit.dit_forward(model, x0, t, attn_impl="int8")  # warm-up
        cats, counts, top = dit_step_profile(model, x0, t, "int8")
    print(f"[{tag}] int8 DiT step device ms (profiler): " + ", ".join(f"{k} {v:.3f}" for k, v in cats.items())
          + f"; total {sum(cats.values()):.3f}; kernels {counts}; largest other: {top}", flush=True)
    return {"ms": cats, "kernels": counts}


def prepare(name: str) -> str:
    """A copy of the package with the variant's patches; its directory."""
    root = os.path.join(REPO, "build", "quant_ab", name)
    shutil.rmtree(root, ignore_errors=True)
    shutil.copytree(os.path.join(REPO, PKG), os.path.join(root, PKG), ignore=shutil.ignore_patterns("build"))
    path = os.path.join(root, PKG, SRC)
    with open(path) as f:
        text = f.read()
    for old, new in VARIANTS[name][1]:
        if old not in text:
            raise RuntimeError(f"variant {name}: patch does not apply to {SRC}: {old[:60]!r}")
        text = text.replace(old, new)
    with open(path, "w") as f:
        f.write(text)
    return root


BUILD = "from lowbit_quant_fa2_paddle_tpu_torch.ops import _build; _build.library()"


def main(names, base=None, profile=False) -> None:
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    dirs = {"main": REPO}
    if base:
        dirs["base"] = os.path.abspath(base)
    dirs.update({name: prepare(name) for name in names})
    for i in range(0, len(dirs), 4):  # four builds at a time on the machine's cores
        procs = [subprocess.Popen([sys.executable, "-c", BUILD], cwd=d) for d in list(dirs.values())[i:i + 4]]
        if any(p.wait() != 0 for p in procs):
            raise RuntimeError("a build failed")
    if base:
        print(f"base: the package of {base}", flush=True)
    for name in names:
        print(f"{name}: {VARIANTS[name][0]}", flush=True)
    order = list(dirs)
    for i, tag in enumerate(order + order[::-1]):
        flags = ["--profile"] if profile and i < len(order) and tag in ("main", "base") else []
        subprocess.run([sys.executable, os.path.abspath(__file__), "--worker", tag, *flags], cwd=dirs[tag],
                       check=True)


if __name__ == "__main__":
    if sys.argv[1:2] == ["--worker"]:
        worker(sys.argv[2], profile="--profile" in sys.argv[3:])
    else:
        args = sys.argv[1:]
        base, profile = None, "--profile" in args
        args = [a for a in args if a != "--profile"]
        if args[:1] == ["--base"]:
            base, args = args[1], args[2:]
        names = list(VARIANTS) if args == ["all"] else args
        unknown = [n for n in names if n not in VARIANTS]
        if unknown:
            sys.exit(f"unknown variants {unknown}; known: {list(VARIANTS)}")
        main(names, base, profile)
