"""Kernel F2 (packed-weight GEMV) against variants of its own source and
against another tree's build, on one CUDA card.

    python3 script/torch_gemv_ab.py [--base DIR] [VARIANT ...]
    python3 script/torch_gemv_ab.py --build VARIANT     (build one variant's copy, print its directory)

Each variant is a patch of ``csrc/gemv.cu`` (see VARIANTS), built in its own
copy of the package under ``build/gemv_ab/<name>/``; ``--base DIR`` adds the
package of another tree as "base" (for example the parent commit unpacked
by ``git archive`` into a directory that ``.gitignore`` lists). Every build
(the checkout's as "main", then base and each variant) times, in its own
process with ``utils.benchmark.cuda_time_ms``, F2 with bf16 x at M 4 on the
full-width LLM's decode shapes: per-channel w4 at (N, K) = (16384, 4096),
(4096, 4096), (1024, 4096) and (4096, 16384), and grouped 2/4/8-bit (group
128) at (16384, 4096), and w4 at M 1000, N = K = 4096 (a short prefill),
each call reading a distinct copy of the weights
(over 128 MB in all) so that every call streams them from HBM, with the
TB/s of packed bytes (weights and scales); main also times F1 w8 and
``torch.matmul`` on the dense bf16 weight at (16384, 4096). The processes
run in turns main, base, v1, v2, ..., then the same in reverse, so each
build is compared with main within one call. Prints the card's name and
power limit first. With no variant, every variant runs. The probes give
wrong results on purpose: they time a part of the kernel.
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

# name: (what it changes, [(old, new), ...] on csrc/gemv.cu, or (file under the package, old, new))
VARIANTS = {
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
    "one-split": ("the plan splits K for no M (one range a row, x staged in slices)",
                  [("ops/gemv.py", "if mt == 1 else 1\n", "if False else 1\n")]),
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


# (mode, bits, M, N, K): the decode shapes of the full-width LLM (M = 4), and
# a short prefill's M = 1000.
SHAPES = [("w4", 4, 4, 16384, 4096), ("w4", 4, 4, 4096, 4096), ("w4", 4, 4, 1024, 4096), ("w4", 4, 4, 4096, 16384),
          ("g2", 2, 4, 16384, 4096), ("g4", 4, 4, 16384, 4096), ("g8", 8, 4, 16384, 4096), ("w4", 4, 1000, 4096, 4096)]


def worker(tag: str, main: bool) -> None:
    """Time F2 (and, for main, F1 and the dense matmul) from the package in
    the current directory."""
    sys.path.insert(0, os.getcwd())
    import torch
    from lowbit_quant_fa2_paddle_tpu_torch.ops import gemv as G
    from lowbit_quant_fa2_paddle_tpu_torch.utils.benchmark import cuda_time_ms

    g = torch.Generator(device="cuda").manual_seed(0)
    out, rec = [], {}
    shapes = SHAPES + ([("w8", 8, 4, 16384, 4096), ("dense", 16, 4, 16384, 4096)] if main else [])
    for mode, bits, m, n, k in shapes:
        x = torch.randn(m, k, generator=g, device="cuda").bfloat16()
        w = torch.randn(n, k, generator=g, device="cuda") / math.sqrt(k)
        if mode == "dense":
            wt = [w.bfloat16()]
            fn = lambda c: torch.matmul(x, c[0].T)  # noqa: E731
        elif mode in ("w4", "w8"):
            wt = list(G.pack_weights_per_channel(w, bits=bits))
            fn = lambda c, b=bits: G.wq_matmul_per_channel(x, c[0], c[1], bits=b)  # noqa: E731
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


def main(names, base=None) -> None:
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
        subprocess.run([sys.executable, os.path.abspath(__file__), "--worker", tag], cwd=dirs[tag], check=True)


if __name__ == "__main__":
    if sys.argv[1:2] == ["--worker"]:
        worker(sys.argv[2], main=sys.argv[2] == "main")
    elif sys.argv[1:2] == ["--build"]:
        d = prepare(sys.argv[2])
        subprocess.run([sys.executable, "-c", BUILD], cwd=d, check=True)
        print(d, flush=True)
    else:
        args = sys.argv[1:]
        base = None
        if args[:1] == ["--base"]:
            base, args = args[1], args[2:]
        names = args or list(VARIANTS)
        unknown = [n for n in names if n not in VARIANTS]
        if unknown:
            sys.exit(f"unknown variants {unknown}; known: {list(VARIANTS)}")
        main(names, base)
