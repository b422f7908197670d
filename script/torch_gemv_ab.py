"""Kernels F1 and F2 (packed-weight GEMV) against variants of their own
source and against another tree's build, on one CUDA card.

    python3 script/torch_gemv_ab.py [--base DIR] [--modes MODE,...] [all | VARIANT ...]
    python3 script/torch_gemv_ab.py --build VARIANT     (build one variant's copy, print its directory)

Each variant is a patch of ``csrc/gemv.cu`` (see VARIANTS), built in its own
copy of the package under ``build/gemv_ab/<name>/``; ``--base DIR`` adds the
package of another tree as "base" (for example the parent commit unpacked
by ``git archive`` into a directory that ``.gitignore`` lists). Every build
(the checkout's as "main", then base and each variant) times, in its own
process with ``utils.benchmark.cuda_time_ms``, the cases of SHAPES at the
full-width LLM's decode shapes (M 4; (N, K) = (16384, 4096), (4096, 4096),
(1024, 4096) and (4096, 16384)) and at M 1000, N = K = 4096 (a short
prefill): F1 w8 with bf16 x; F1 w8a8's kernel alone ("w8a8k", on INT8 codes
quantized once outside the clock) and its whole call ("w8a8", the plain-op
activation quantizer included); F2 per-channel w4 and grouped 2/4/8-bit
(group 128). Each call reads a distinct copy of the weights (over 128 MB in
all) so that every call streams them from HBM; it prints the TB/s of packed
bytes (weights and scales). Main also times ``torch.matmul`` on the dense
bf16 weight at the decode shapes. The processes run in turns main, base,
v1, v2, ..., then the same in reverse, so each build is compared with main
within one call. Prints the card's name and power limit first. Named
variants run; ``all`` runs every variant (none named: main against base
alone); ``--modes`` times only the cases of those modes
(e.g. ``w8,w8a8k``). The probes give wrong results on purpose: they
time a part of the kernel. The two copy-only probes time the two load
structures alone: "copy-only" F2's (a per-warp ring of TMA tiles; its g8
cases move the bytes of F1's w8), "w8-copy-only" F1's (a producer warp's
ring for the CTA).
"""

from __future__ import annotations

import functools
import itertools
import json
import math
import os
import shutil
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = "lowbit_quant_fa2_paddle_tpu_torch"
SRC = "gemv.cu"

_AF = '''              const uint32_t af[4] = {
                  sm90::pack_bf16x2(dq<BITS>(w0, BITS * i, sa[rt][0], oa[rt][0]),
                                    dq<BITS>(w0, 8 + BITS * i, sb[rt][0], ob[rt][0])),
                  sm90::pack_bf16x2(dq<BITS>(w1, BITS * i, sa[rt][1], oa[rt][1]),
                                    dq<BITS>(w1, 8 + BITS * i, sb[rt][1], ob[rt][1])),
                  sm90::pack_bf16x2(dq<BITS>(u0, BITS * i, sa[rt][0], oa[rt][0]),
                                    dq<BITS>(u0, 8 + BITS * i, sb[rt][0], ob[rt][0])),
                  sm90::pack_bf16x2(dq<BITS>(u1, BITS * i, sa[rt][1], oa[rt][1]),
                                    dq<BITS>(u1, 8 + BITS * i, sb[rt][1], ob[rt][1]))};
'''
_CHUNK = '''          for (int h = 0; h < 2; ++h) wc[rt][h] = *reinterpret_cast<const uint4*>(tile + (16 * rt + g + 8 * h) * 128);
'''

_W8_B = """          if constexpr (XS8) {
            // Two k32 steps of 8 bytes"""

# name: (what it changes, [(old, new), ...] on csrc/gemv.cu, or (file under the package, old, new))
VARIANTS = {
    "w8-copy-only": ("probe, wrong results: F1's tensor-core design loads its W chunks and x fragments (from "
                     "the stage on the deep ring, else through L1) and does no math", [(_W8_B, """          {
            uint32_t z = 0u;
#pragma unroll
            for (int rt = 0; rt < 2; ++rt)
#pragma unroll
              for (int h = 0; h < 2; ++h) z ^= wv[rt][h].x ^ wv[rt][h].y ^ wv[rt][h].z ^ wv[rt][h].w;
#pragma unroll
            for (int mt = 0; mt < MT; ++mt)
#pragma unroll
              for (int j = 0; j < (XS8 ? 1 : 2); ++j)
                z ^= xv[cc][mt][j].x ^ xv[cc][mt][j].y ^ xv[cc][mt][j].z ^ xv[cc][mt][j].w;
            acc[0][0][0] += (Acc)(z & 0x7Fu);
            continue;
          }
""" + _W8_B)]),
    "w8-tma": ("F1's 4-CTA ring filled, as the deep ring is, by four TMA boxes of 32 rows x 128 bytes "
               "(128-byte swizzle), not one bulk copy a row", [("{ return deep; }", "{ return true; }")]),
    "w8-deep-bulk": ("F1's deep ring filled by one bulk copy a row, as the 4-CTA ring is, not by TMA boxes",
                     [("{ return deep; }", "{ return false; }")]),
    "w8-no-deep": ("F1's plan never takes the deep ring (int8 x at N 4096 x K 16384 on the 4-CTA ring, K split 4 "
                   "ways)", [("ops/gemv.py", "if x_int8 and mt == 1 and 3 * n_sms <= 4 * units <= 4 * n_sms:",
                              "if False:")]),
    "w8-deep-bf16": ("F1's plan takes the deep ring for bf16 x too (N 4096 at K 16384), not the split ring",
                     [("ops/gemv.py", "if x_int8 and mt == 1 and 3 * n_sms", "if mt == 1 and 3 * n_sms")]),
    "w8-x-staged-ring": ("F1's 4-CTA ring at one x m-tile stages x beside W, as the deep ring does, not through L1",
                         [("  const int xrows = DEEP ? a.M : 0", "  const int xrows = MT == 1 ? a.M : 0"),
                          ("constexpr bool XST = DEEP, kPrefetch = !DEEP && MT == 1;",
                           "constexpr bool XST = MT == 1, kPrefetch = false;"),
                          ("total(DEEP ? a.M : 0, XS8)", "total(MT == 1 ? a.M : 0, XS8)")]),
    "w8-ring5x2": ("F1's ring of five stages at two CTAs an SM at one x m-tile, not two at four",
                   [("{ return deep ? W8_DEEP_STAGES : mt == 1 ? 2 : 5; }", "{ return deep ? W8_DEEP_STAGES : 5; }"),
                    ("{ return deep ? 1 : mt == 1 ? 4 : 2; }", "{ return deep ? 1 : 2; }"),
                    ("ops/gemv.py", "W8_CTAS_PER_SM = {1: 4, 4: 2}", "W8_CTAS_PER_SM = {1: 2, 4: 2}")]),
    "w8-no-merge": ("probe, wrong results: each K split of F1's ring writes y itself (no partials, no ticket)",
                    [("    if (a.ksplit == 1) {\n        if (n < a.N)\n          for (int m = 0; m < mrows; ++m) store(m0 + m, dot(m));",
                      "    if (true) {\n        if (n < a.N)\n          for (int m = 0; m < mrows; ++m) store(m0 + m, dot(m));")]),
    "w8-empty": ("probe, wrong results: F1's kernel returns after its prologue (the launch and set-up alone)",
                 [("  if (TMA && tid == 32) tma_prefetch_desc(&w_map);\n  __syncthreads();\n",
                   "  if (TMA && tid == 32) tma_prefetch_desc(&w_map);\n  __syncthreads();\n  if (a.units > 0) return;\n")]),
    "w8d-warps8": ("F1's direct loads by 8 warps of 4 k-blocks a CTA, not 16 of 2",
                   [("constexpr int W8D_WARPS = 16;\nconstexpr int W8D_BATCH = 2; ",
                     "constexpr int W8D_WARPS = 8;\nconstexpr int W8D_BATCH = 4; ")]),
    "w8-ring-only": ("F1's plan never takes the direct loads (the ring, with its split merge, for every shape)",
                     [("ops/gemv.py", "W8D_ROWS, W8D_MAX_K, W8D_MAX_BYTES = 16, 4096, 16 << 20",
                       "W8D_ROWS, W8D_MAX_K, W8D_MAX_BYTES = 16, 4096, 0")]),
    "w8-direct-64mib": ("F1's plan takes the direct loads up to 64 MiB of W (N 16384 at K 4096 too), not 16",
                        [("ops/gemv.py", "W8D_ROWS, W8D_MAX_K, W8D_MAX_BYTES = 16, 4096, 16 << 20",
                          "W8D_ROWS, W8D_MAX_K, W8D_MAX_BYTES = 16, 4096, 64 << 20")]),
    "w8d-copy-only": ("probe, wrong results: F1's direct loads of W and x, no math",
                      [("      const bool in = g < M && k < K;\n", """      const bool in = g < M && k < K;
      {
        uint32_t z = wv[b][cc][0].x ^ wv[b][cc][0].y ^ wv[b][cc][0].z ^ wv[b][cc][0].w ^ wv[b][cc][1].x ^
                     wv[b][cc][1].y ^ wv[b][cc][1].z ^ wv[b][cc][1].w;
        if (in) {
          const uint4 xq = *reinterpret_cast<const uint4*>(xp);
          z ^= xq.x ^ xq.y ^ xq.z ^ xq.w;
        }
        acc[0] += (Acc)(z & 0x7Fu);
        continue;
      }
""")]),
    "w8-max-splits2": ("F1's ring splits K over at most 2 CTAs, not 16",
                       [("ops/gemv.py", "W8_ROWS, W8_KT, W8_MIN_TILES, W8_MAX_SPLITS = 32, 512, 2, 16",
                         "W8_ROWS, W8_KT, W8_MIN_TILES, W8_MAX_SPLITS = 32, 512, 2, 2")]),
    "w8-min-tiles1": ("F1's plan lets a split hold one tile, not two",
                      [("ops/gemv.py", "W8_ROWS, W8_KT, W8_MIN_TILES, W8_MAX_SPLITS = 32, 512, 2, 16",
                        "W8_ROWS, W8_KT, W8_MIN_TILES, W8_MAX_SPLITS = 32, 512, 1, 16")]),
    "w8-one-split": ("F1's plan splits K for no M",
                     [("ops/gemv.py", "W8_MAX_SPLITS) if mt == 1 else 1\n", "W8_MAX_SPLITS) if False else 1\n")]),
    "copy-only": ("probe, wrong results: the tensor-core design loads W (and each part's x fragments) and does "
                  "no math", [(_CHUNK, _CHUNK + '''      {
        uint32_t z = 0u;
#pragma unroll
        for (int rt = 0; rt < 2; ++rt)
#pragma unroll
          for (int h = 0; h < 2; ++h) z ^= wc[rt][h].x ^ wc[rt][h].y ^ wc[rt][h].z ^ wc[rt][h].w;
#pragma unroll
        for (int i = 0; i < FPB; ++i)
#pragma unroll
          for (int mt = 0; mt < MT; ++mt)
            if (mt * 8 + g < mrows) {
              const uint4* p = reinterpret_cast<const uint4*>(xs + (mt * 8 + g) * xr + i * slb + jx);
              const uint4 t0 = p[0], t1 = p[1];
              z ^= t0.x ^ t0.y ^ t0.z ^ t0.w ^ t1.x ^ t1.y ^ t1.z ^ t1.w;
            }
        acc[0][0][0] += __uint_as_float(z & 0x007FFFFFu);
        continue;
      }
''')]),
    "no-dequant": ("probe, wrong results: the codes enter the mma as raw bf16 bits (no mask, fma or rounding)",
                   [(_AF, "              const uint32_t af[4] = {w0, w1, u0, u1};\n")]),
    "no-sigma": ("probe, wrong results: no group sums of x (sigma)",
                 [("      if (zero_points) {\n        for (int u = tid; u < mrows * FPB * nrun;",
                   "      if (false) {\n        for (int u = tid; u < mrows * FPB * nrun;")]),
    "no-xload": ("probe, wrong results: x staged as zeros, not loaded",
                 [("          if (j_lo + jj < j_hi)\n            val =", "          if (false)\n            val =")]),
    "one-split": ("F2's plan splits K for no M (one range a row, x staged in slices)",
                  [("ops/gemv.py", "TC_MAX_SPLITS) if mt == 1 else 1\n", "TC_MAX_SPLITS) if False else 1\n")]),
    "max-splits4": ("the plan splits K over at most 4 CTAs, not 8",
                    [("ops/gemv.py", "TC_MAX_SPLITS = 8", "TC_MAX_SPLITS = 4")]),
    "max-splits16": ("the plan splits K over at most 16 CTAs, not 8",
                     [("ops/gemv.py", "TC_MAX_SPLITS = 8", "TC_MAX_SPLITS = 16"),
                      ("constexpr int TC_MAX_SPLITS = 8;", "constexpr int TC_MAX_SPLITS = 16;")]),
    "max-splits2": ("the plan splits K over at most 2 CTAs, not 8",
                    [("ops/gemv.py", "TC_MAX_SPLITS = 8", "TC_MAX_SPLITS = 2")]),
    "min-chunks8": ("the plan gives a split at least 8 chunks, not 2",
                    [("ops/gemv.py", "TC_WARPS, TC_ROWS, TC_MIN_CHUNKS = 4, 32, 2",
                      "TC_WARPS, TC_ROWS, TC_MIN_CHUNKS = 4, 32, 8")]),
    "stages4": ("a ring of four tiles a warp (three ahead) at two CTAs an SM, not two tiles at three",
                [("constexpr int TC_STAGES = 2;", "constexpr int TC_STAGES = 4;"),
                 ("__launch_bounds__(TC_WARPS * 32, MT == 1 ? 3 : 2)", "__launch_bounds__(TC_WARPS * 32, 2)"),
                 ("ops/gemv.py", "TC_CTAS_PER_SM = {1: 3, 4: 2}", "TC_CTAS_PER_SM = {1: 2, 4: 2}")]),
}

# The probe of F1's structure with the TMA fill.
VARIANTS["w8-tma-copy-only"] = ("probe, wrong results: w8-copy-only with the w8-tma fill",
                                VARIANTS["w8-copy-only"][1] + VARIANTS["w8-tma"][1])

DECODE_NK = [(16384, 4096), (4096, 4096), (1024, 4096), (4096, 16384)]
# (mode, bits, M, N, K): F1 and F2 at the decode shapes of the full-width LLM
# (M = 4), F1 w8a8's whole call at its first, and a short prefill's M = 1000.
SHAPES = ([("w8", 8, 4, n, k) for n, k in DECODE_NK] + [("w8a8k", 8, 4, n, k) for n, k in DECODE_NK]
          + [("w8a8", 8, 4, 16384, 4096), ("w8", 8, 1000, 4096, 4096), ("w8a8k", 8, 1000, 4096, 4096)]
          + [("w4", 4, 4, n, k) for n, k in DECODE_NK] + [("g8", 8, 4, n, k) for n, k in DECODE_NK]
          + [("g2", 2, 4, 16384, 4096), ("g4", 4, 4, 16384, 4096), ("w4", 4, 1000, 4096, 4096)])


def worker(tag: str, main: bool, modes=None) -> None:
    """Time the cases of SHAPES (those of ``modes`` only, if given; main also
    the dense matmul) with the package in the current directory."""
    sys.path.insert(0, os.getcwd())
    import torch
    from lowbit_quant_fa2_paddle_tpu_torch.ops import gemv as G
    from lowbit_quant_fa2_paddle_tpu_torch.utils.benchmark import cuda_time_ms

    g = torch.Generator(device="cuda").manual_seed(0)
    out, rec = [], {}
    shapes = SHAPES + ([("dense", 16, 4, n, k) for n, k in DECODE_NK] if main else [])
    for mode, bits, m, n, k in shapes:
        if modes and mode not in modes:
            continue
        x = torch.randn(m, k, generator=g, device="cuda").bfloat16()
        w = torch.randn(n, k, generator=g, device="cuda") / math.sqrt(k)
        if mode == "dense":
            wt = [w.bfloat16()]
            fn = lambda c: torch.matmul(x, c[0].T)  # noqa: E731
        elif mode == "w8a8k":  # F1's kernel alone, on INT8 codes quantized once
            xq, xs = G.quant_activations(x)
            wt = list(G.pack_weights_per_channel(w, bits=8))
            fn = lambda c: G._gemv_cuda(xq, xs, c[0], c[1], None, bits=8, grouped=False, group_size=0,  # noqa: E731
                                        neg7=False, out_dtype=torch.bfloat16, wrapper=G.wq_matmul_per_channel)
        elif mode in ("w4", "w8", "w8a8"):
            wt = list(G.pack_weights_per_channel(w, bits=bits))
            act = "int8" if mode == "w8a8" else "bf16"
            fn = lambda c, b=bits, a=act: G.wq_matmul_per_channel(x, c[0], c[1], bits=b, activation=a)  # noqa: E731
        else:
            wt = list(G.pack_weights(w, group_size=128, bits=bits))
            fn = lambda c, b=bits: G.wq_matmul_fused(x, c[0], c[1], c[2], bits=b, group_size=128)  # noqa: E731
        wbytes = sum(t.numel() * t.element_size() for t in wt)
        copies = [[t.clone() for t in wt] for _ in range(min(64, max(2, math.ceil(128e6 / wbytes))))]
        it = itertools.cycle([functools.partial(fn, c) for c in copies])
        ms = cuda_time_ms(lambda: next(it)(), warmup=len(copies), reps=100)
        out.append(f"{mode} M{m} N{n} K{k} {ms * 1e3:.2f} us ({wbytes / ms / 1e9:.3f} TB/s)")
        rec[f"{mode} M{m} N{n} K{k}"] = {"ms": ms, "tb_per_s": wbytes / ms / 1e9}
        del copies, wt, w
    print(f"[{tag}] " + " | ".join(out) + " (bf16 x)", flush=True)
    print(json.dumps({"build": tag, "times": rec}), flush=True)


def prepare(name: str) -> str:
    """A copy of the package with the variant's patches; its directory."""
    root = os.path.join(REPO, "build", "gemv_ab", name)
    shutil.rmtree(root, ignore_errors=True)
    shutil.copytree(os.path.join(REPO, PKG), os.path.join(root, PKG), ignore=shutil.ignore_patterns("build"))
    for patch in VARIANTS[name][1]:
        src, old, new = patch if len(patch) == 3 else (os.path.join("csrc", SRC), *patch)
        path = os.path.join(root, PKG, src)
        with open(path) as f:
            text = f.read()
        if old not in text:
            raise RuntimeError(f"variant {name}: patch does not apply to {src}: {old[:60]!r}")
        with open(path, "w") as f:
            f.write(text.replace(old, new))
    return root


BUILD = "from lowbit_quant_fa2_paddle_tpu_torch.ops import _build; _build.library()"


def main(names, base=None, modes=()) -> None:
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    dirs = {"main": REPO}
    if base:
        dirs["base"] = os.path.abspath(base)
    dirs.update({name: prepare(name) for name in names})
    for i in range(0, len(dirs), 3):  # three builds at a time on the machine's cores
        procs = [subprocess.Popen([sys.executable, "-c", BUILD], cwd=d) for d in list(dirs.values())[i:i + 3]]
        if any(p.wait() != 0 for p in procs):
            raise RuntimeError("a build failed")
    if base:
        print(f"base: the package of {base}", flush=True)
    for name in names:
        print(f"{name}: {VARIANTS[name][0]}", flush=True)
    order = list(dirs)
    for tag in order + order[::-1]:
        subprocess.run([sys.executable, os.path.abspath(__file__), "--worker", tag, *modes], cwd=dirs[tag],
                       check=True)


if __name__ == "__main__":
    if sys.argv[1:2] == ["--worker"]:
        worker(sys.argv[2], main=sys.argv[2] == "main", modes=sys.argv[3:])
    elif sys.argv[1:2] == ["--build"]:
        d = prepare(sys.argv[2])
        subprocess.run([sys.executable, "-c", BUILD], cwd=d, check=True)
        print(d, flush=True)
    else:
        args = sys.argv[1:]
        base, modes = None, ()
        if args[:1] == ["--base"]:
            base, args = args[1], args[2:]
        if args[:1] == ["--modes"]:
            modes, args = tuple(args[1].split(",")) + ("dense",), args[2:]
        names = list(VARIANTS) if args == ["all"] else args
        unknown = [n for n in names if n not in VARIANTS]
        if unknown:
            sys.exit(f"unknown variants {unknown}; known: {list(VARIANTS)}")
        main(names, base, modes)
