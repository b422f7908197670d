"""Kernels D (decode attention) and E (attention over packed KIVI K/V) against
variants of their own sources, and against another tree's build, on one CUDA
card.

    python3 script/torch_decode_ab.py [--base DIR] [--sass] [--step] [all | VARIANT ...]

Each variant is a patch of ``csrc/decode_attention.cuh`` or
``csrc/fused_kv_attention_wgmma.cuh`` (see VARIANTS), built in its own copy of
the package under ``build/decode_ab/<name>/``; ``--base DIR`` adds the package
of another tree as "base" (for example the parent commit unpacked by ``git
archive`` into a directory that ``.gitignore`` lists). Every build (the
checkout's as "main", then base and each variant) times, in its own process
with ``utils.benchmark.cuda_time_ms``: D at b4 h32 hk8 s32768 d128 (every
length 32768) with the int8 and the bf16 cache, and the int4 and k4v8 caches
where the build has them (on both QK chains), with the GB/s of cache bytes
streamed, and E with
4-bit K/V at b4 h32 s8192 d64 (group 256), with its TFLOP/s; main also times
SDPA (one query per head over the bf16 cache, and on E's K/V dequantized to
bf16). ``--step`` adds the whole decode step: the full-width LLM (dim 4096,
32 query heads x 128, 8 KV heads, depth 32, vocab 256, bf16, random seeded
weights) prefills a b4 32,704-token prompt into the int8 cache, then
``decode_tokens`` generates 16 tokens and, in a second call timed by the
host clock, 32 more (a build whose ``decode_tokens`` is a loop of
``llm_decode_step`` times that loop; one that captures a CUDA graph times
the replays of the graph its first call captured); main
also times the eager loop of ``llm_decode_step`` itself from the same
caches. The processes run in turns main, base, v1, v2, ..., then the same in
reverse, so each build is compared with main within one call. ``--sass``
first compares, kernel by kernel, the SASS (``cuobjdump -sass``, addresses
and encodings dropped) of every D kernel of base (single-token,
multi-token / INT8-PV and paged, at every head dim base has) with main's
kernel of the same template arguments; main's kernels at head dims base
lacks are counted; it exits with an error unless both builds hold all 90
single-token kernels at head dims 32-128, main holds every kernel of
base's, and each pair is identical, and then prints its verdict again as
the last line. Prints the card's name and power limit first. Named variants
run; ``all`` runs every
variant; with none named, main runs against base alone. The
probes give wrong results on purpose: they time a part of the kernel.
"""

from __future__ import annotations

import os
import re
import shutil
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = "lowbit_quant_fa2_paddle_tpu_torch"
D_SRC = "decode_attention.cuh"
E_SRC = "fused_kv_attention_wgmma.cuh"

# name: (what it changes, [(file under csrc/, old, new), ...])
VARIANTS = {
    "d-copy-only": ("probe, wrong results: D's consumers release each tile as it lands (the loads alone)",
                    [(D_SRC, "      const float* vs_t = vs_s + st * BK;\n",
                      "      const float* vs_t = vs_s + st * BK;\n"
                      "      if (nv > 0) {\n        __syncwarp();\n        if (lane == 0) mbar_arrive(&empty[st]);\n"
                      "        continue;\n      }\n")]),
    "d-no-pv": ("probe, wrong results: D without its PV loop (loads, QK, softmax, P stores)",
                [(D_SRC, "      if (nv == BK) {\n#pragma unroll 8  // measured 6% faster than 4 on the int8 cache\n"
                         "        for (int kl = 0; kl < BK; ++kl) pv_key(kl);\n"
                         "      } else {\n        for (int kl = 0; kl < nv; ++kl) pv_key(kl);\n      }\n", "")]),
    "d-8k-tiles": ("D with tiles of up to 8 KB of K/V (half the keys a tile, two or three CTAs an SM)",
                   [(D_SRC, "<= 16384 ? 64 : 32 * (kKRow + kVRow) <= 16384 ? 32 : 16;",
                     "<= 8192 ? 64 : 32 * (kKRow + kVRow) <= 8192 ? 32 : 16;")]),
    "d-no-scales": ("probe, wrong results: D without the per-token scale copies",
                    [(D_SRC, "        cp_async4(ks_s + st * BK + i, ksg + key0 + i);\n", ""),
                     (D_SRC, "        if constexpr (kVQuant) cp_async4(vs_s + st * BK + i, vsg + key0 + i);\n", "")]),
    "e-nowiden": ("probe, wrong results: E's producer lands the packed tiles but widens nothing",
                  [(E_SRC, "        widen<D, BITS>(pk, smem", "        if (false) widen<D, BITS>(pk, smem"),
                   (E_SRC, "        widen<D, BITS>(pk + L::kPackBytes",
                    "        if (false) widen<D, BITS>(pk + L::kPackBytes")]),
    "e-regs160": ("E at d64 with 160 registers a consumer thread and 32 a producer thread (not 152 / 56)",
                  [(E_SRC, "constexpr int kRegC = D == 64 ? 152 : 232;", "constexpr int kRegC = D == 64 ? 160 : 232;"),
                   (E_SRC, "constexpr int kRegP = D == 64 ? 56 : 40;", "constexpr int kRegP = D == 64 ? 32 : 40;")]),
    "e-unroll2": ("E's producer with its one-group row loop unrolled by 2, not 1",
                  [(E_SRC, "#pragma unroll 1\n      for (int r = r0; r < BKV; r += RPP) {\n        const uint2 x",
                    "#pragma unroll 2\n      for (int r = r0; r < BKV; r += RPP) {\n        const uint2 x")]),
}


def d_sass_kernels(binary: str) -> dict:
    """Kernel D's kernels in a built library: {(D, K and V types, int_qk,
    masks, kExt): (instructions without addresses, encodings)}, kExt "0" for
    the single-token kernels, "1" T-token, "2" T-token with INT8 PV."""
    cuda = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    dump = subprocess.run([os.path.join(cuda, "bin", "cuobjdump"), "-sass", binary], capture_output=True, text=True,
                          check=True).stdout
    kernels, key = {}, None
    for line in dump.splitlines():
        if "Function :" in line:
            # decode_kernel<D, KT, VT, kIntQK, kMasks[, kExt, Ext...]>, mangled; kExt 0 is single-token
            m = re.search(r"decode_kernelILi(\d+)E(.+?)Lb([01])ELb([01])E(?:Li(\d)E)?", line)
            key = (m.group(1), m.group(2), m.group(3), m.group(4), m.group(5) or "0") if m else None
            if key is not None:
                kernels[key] = ([], [])
        elif key is not None:
            kernels[key][1].extend(re.findall(r"/\*\s*(0x[0-9a-f]{16})\s*\*/", line))
            if re.search(r"/\*[0-9a-f]{4,}\*/", line):  # an instruction, after its address
                text = re.sub(r"/\*[0-9a-f]+\*/", "", line.split(";")[0]).strip()
                kernels[key][0].append(re.sub(r"_GLOBAL__N__\w+?_cu_[0-9a-f]+", "(anonymous)", text))
    return kernels


def library_of(root: str) -> str:
    """The path of the kernel library built from the package under ``root``."""
    return subprocess.run([sys.executable, "-c", "from lowbit_quant_fa2_paddle_tpu_torch.ops import _build; "
                           "print(_build.library_path())"], cwd=root, capture_output=True, text=True,
                          check=True).stdout.strip()


#: Kernel D's single-token instances in a build: head dims 32/64/128 x
#: (K bf16 on the float chain, K int8 or 4-bit on either chain) x V
#: bf16/int8/4-bit x with and without masks.
D_SINGLE_TOKEN_KERNELS = 3 * 5 * 3 * 2


def sass_diff(main_bin: str, base_bin: str) -> tuple:
    """Prints, for each D kernel of base (every head dim, single-token,
    multi-token and paged), whether main's kernel of the same template
    arguments has the same instructions (and encodings). Returns (ok,
    verdict line): ok only when both builds hold all D_SINGLE_TOKEN_KERNELS
    single-token kernels at head dims 32-128, main holds every kernel of
    base's and each pair is identical. Main's kernels at head dims base
    lacks (80 and 96) are counted, not compared."""
    a, b = d_sass_kernels(main_bin), d_sass_kernels(base_bin)
    new_dims = sorted({key[0] for key in a} - {key[0] for key in b}, key=int)
    n_new = sum(key[0] in new_dims for key in a)
    ladder = lambda ks: sum(key[4] == "0" and key[0] in ("32", "64", "128") for key in ks)  # noqa: E731
    same = ladder(a) == ladder(b) == D_SINGLE_TOKEN_KERNELS
    for key in sorted(b):
        name = "decode_kernel<D={}, {}, int_qk={}, masks={}, kExt={}>".format(*key)
        if key not in a:
            print(f"sass {name}: MISSING in main", flush=True)
            same = False
            continue
        (la, ea), (lb, eb) = a[key], b[key]
        if la == lb:
            print(f"sass {name}: instructions identical ({len(la)}), encodings "
                  f"{'identical' if ea == eb else 'differ'}", flush=True)
            continue
        same = False
        diff = [(i, x, y) for i, (x, y) in enumerate(zip(la, lb)) if x != y]
        print(f"sass {name}: DIFFERS, main {len(la)} / base {len(lb)} instructions, {len(diff)} of the common "
              f"positions differ", flush=True)
        for i, x, y in diff[:8]:
            print(f"    {i}: main {x} | base {y}", flush=True)
    dims = sorted({key[0] for key in b}, key=int)
    verdict = (f"sass: all {len(b)} D kernels of base (head dims {'/'.join(dims)}; {ladder(b)} single-token at "
               f"32-128) compared with main's (main holds {len(a)}, {n_new} of them at head dims "
               f"{'/'.join(new_dims) or 'none'} new), {'all identical' if same else 'NOT all identical'}")
    print(verdict, flush=True)
    return same, verdict


def step_worker(main: bool) -> str:
    """Decode ms/token of the full-width LLM at a 32K context, int8 cache,
    dense weights, from the package in the current directory."""
    import time

    import torch
    from lowbit_quant_fa2_paddle_tpu_torch.models import llm

    b, prompt_len, warm, n = 4, 32704, 16, 48
    cfg = llm.LLMConfig(vocab=256, dim=4096, depth=32, num_heads=32, num_kv_heads=8, max_seq=32768,
                        dtype=torch.bfloat16)
    gen = torch.Generator(device="cuda").manual_seed(0)
    model = llm.init_llm_params(cfg, gen)
    prompt = torch.randint(0, cfg.vocab, (b, prompt_len), generator=gen, device="cuda")
    logits, caches = llm.llm_prefill(model, prompt, cfg)
    token = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
    del logits
    copy = [{k: v.clone() for k, v in c.items()} for c in caches] if main else None
    # The first call decodes the warm-up tokens (with the graph decode: its
    # eager first step and the capture); the second, timed, goes on from them
    # (replays of the same graph, or eager steps).
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    toks, caches = llm.decode_tokens(model, token, caches, warm, cfg)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    llm.decode_tokens(model, toks[:, -1], caches, n - warm, cfg)
    torch.cuda.synchronize()
    t_end = time.perf_counter()
    ms = (t_end - t1) / (n - warm) * 1e3
    out = f"decode_tokens {ms:.3f} ms/token over tokens {warm + 1}-{n} ({t1 - t0:.2f} s the first {warm})"
    if main:
        t = token
        for i in range(n):
            if i == warm:
                torch.cuda.synchronize()
                t1 = time.perf_counter()
            step_logits, copy = llm.llm_decode_step(model, t, copy, cfg)
            t = torch.argmax(step_logits, dim=-1).to(torch.int32)
        torch.cuda.synchronize()
        out += f" | eager llm_decode_step loop {(time.perf_counter() - t1) / (n - warm) * 1e3:.3f} ms/token"
    return out


def worker(tag: str, main: bool, step: bool) -> None:
    """Time D and E (and with ``step`` the whole decode step) from the
    package in the current directory."""
    sys.path.insert(0, os.getcwd())
    import torch
    from lowbit_quant_fa2_paddle_tpu_torch.ops import decode as DD
    from lowbit_quant_fa2_paddle_tpu_torch.ops import fused_kv as FK
    from lowbit_quant_fa2_paddle_tpu_torch.utils.benchmark import cuda_time_ms

    out = []
    if step:
        out.append(step_worker(main))
        torch.cuda.empty_cache()
    g = torch.Generator(device="cuda").manual_seed(0)
    b, h, hk, d, s = 4, 32, 8, 128, 32768
    # (name, k_bits, v_bits); a build without _unpack4_cols has no 4-bit caches.
    modes = [("int8", 8, 8), ("bf16", 16, 16)] + ([("int4", 4, 4), ("k4v8", 4, 8)] if hasattr(DD, "_unpack4_cols")
                                                 else [])
    for name, k_bits, v_bits in modes:
        kq, ks = DD.quantize_token(torch.randn(b, hk, s, d, generator=g, device="cuda").bfloat16(), bits=k_bits)
        vq, vs = DD.quantize_token(torch.randn(b, hk, s, d, generator=g, device="cuda").bfloat16(), bits=v_bits)
        q = torch.randn(b, h, d, generator=g, device="cuda").bfloat16()
        lens = torch.full((b,), s, dtype=torch.int32, device="cuda")
        sides = dict(kv_bits=k_bits) if k_bits == v_bits else dict(k_bits=k_bits, v_bits=v_bits)
        ms = cuda_time_ms(lambda: DD.decode_attention(q, kq, vq, ks, lens, v_scale=vs, **sides), warmup=5,
                          reps=50)
        cache = sum(t.numel() * t.element_size() for t in (kq, vq, ks)) + (vs.numel() * 4 if v_bits != 16 else 0)
        out.append(f"D {name} {ms:.4f} ({cache / ms / 1e6:.0f} GB/s)")
        if k_bits == 4:  # the integer QK chain at 4-bit K
            ms = cuda_time_ms(lambda: DD.decode_attention(q, kq, vq, ks, lens, v_scale=vs, compute_mode="int_qk",
                                                          **sides), warmup=5, reps=50)
            out.append(f"D {name} int_qk {ms:.4f}")
        if main and name == "int8":  # a yardstick of the card's streaming rate: one device copy (read + write)
            dst = torch.empty_like(kq)
            cp = cuda_time_ms(lambda: dst.copy_(kq), warmup=3, reps=20)
            out.append(f"copy of K {cp:.4f} ({2 * kq.numel() / cp / 1e6:.0f} GB/s read + write)")
            del dst
        if main and name == "bf16":
            sdpa = cuda_time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
                q[:, :, None], kq, vq, enable_gqa=True), warmup=3, reps=20)
            out.append(f"SDPA bf16 cache {sdpa:.4f}")
        del kq, vq, ks, vs
    b, h, s, d = 4, 32, 8192, 64
    q = torch.randn(b, h, s, d, generator=g, device="cuda").bfloat16()
    kp, ks, km = FK.quant_kv_grouped((torch.randn(b, h, s, d, generator=g, device="cuda") + 0.5).bfloat16(), bits=4,
                                     group=256)
    vp, vs, vm = FK.quant_kv_grouped(torch.randn(b, h, s, d, generator=g, device="cuda").bfloat16(), bits=4,
                                     group=256)
    ms = cuda_time_ms(lambda: FK.fused_packed_kv_attention(q, kp, vp, ks, km, vs, vm, bits=4), warmup=2, reps=10)
    flops = 4.0 * b * h * s * s * d
    out.append(f"E int4 {ms:.3f} ({flops / ms / 1e9:.0f} TFLOP/s)")
    if main:
        kd = FK.dequant_kv_grouped(kp, ks, km, bits=4, group=256)
        vd = FK.dequant_kv_grouped(vp, vs, vm, bits=4, group=256)
        sdpa = cuda_time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(q, kd, vd), warmup=2, reps=10)
        out.append(f"SDPA dequantized {sdpa:.3f} ({flops / sdpa / 1e9:.0f} TFLOP/s)")
    print(f"[{tag}] " + " | ".join(out) + " (ms)", flush=True)


def prepare(name: str) -> str:
    """A copy of the package with the variant's patches; its directory."""
    root = os.path.join(REPO, "build", "decode_ab", name)
    shutil.rmtree(root, ignore_errors=True)
    shutil.copytree(os.path.join(REPO, PKG), os.path.join(root, PKG), ignore=shutil.ignore_patterns("build"))
    for src, old, new in VARIANTS[name][1]:
        path = os.path.join(root, PKG, "csrc", src)
        with open(path) as f:
            text = f.read()
        if old not in text:
            raise RuntimeError(f"variant {name}: patch does not apply to {src}: {old[:60]!r}")
        with open(path, "w") as f:
            f.write(text.replace(old, new))
    return root


def main(names, base=None, step=False, sass=False) -> None:
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    dirs = {"main": REPO}
    if base:
        dirs["base"] = os.path.abspath(base)
    dirs.update({name: prepare(name) for name in names})
    build = "from lowbit_quant_fa2_paddle_tpu_torch.ops import _build; _build.library()"
    for i in range(0, len(dirs), 3):  # three builds at a time on the machine's cores
        procs = [subprocess.Popen([sys.executable, "-c", build], cwd=d) for d in list(dirs.values())[i:i + 3]]
        if any(p.wait() != 0 for p in procs):
            raise RuntimeError("a build failed")
    for tag, d in dirs.items():  # each build's registers and spills of D and E (ptxas)
        logs = [os.path.join(r, f) for r, _, fs in os.walk(os.path.join(d, PKG, "csrc", "build")) for f in fs
                if f.endswith(".so.log")]
        text = open(max(logs, key=os.path.getmtime)).read() if logs else ""
        for name, spill, regs in re.findall(
                r"Function properties for (\S+)\n\s+(.*spill loads)\n.*?Used (\d+) registers", text):
            if re.search(r"decode_kernelI.*?Lb[01]ELb[01]E(?!Li[12]E)", name) or "fused_kv" in name:  # single-token D
                kind = re.search(r"(decode_kernelILi\d+E\w{1,40}?Lb[01]E|fused_kv_wgmma_kernelILi\d+ELi\d)", name)
                print(f"[{tag}] regs={regs} {spill.strip()} {kind.group(1) if kind else name[:60]}", flush=True)
    verdict = None
    if base:
        print(f"base: the package of {base}", flush=True)
        if sass:
            ok, verdict = sass_diff(library_of(REPO), library_of(dirs["base"]))
            if not ok:
                sys.exit(verdict)
    for name in names:
        print(f"{name}: {VARIANTS[name][0]}", flush=True)
    order = list(dirs)
    for tag in order + order[::-1]:
        subprocess.run([sys.executable, os.path.abspath(__file__), "--worker", tag] + (["--step"] if step else []),
                       cwd=dirs[tag], check=True)
    if verdict:
        print(verdict, flush=True)  # the last line


if __name__ == "__main__":
    if sys.argv[1:2] == ["--worker"]:
        worker(sys.argv[2], main=sys.argv[2] == "main", step="--step" in sys.argv[3:])
    else:
        args = sys.argv[1:]
        base = None
        if args[:1] == ["--base"]:
            base, args = args[1], args[2:]
        step, sass = "--step" in args, "--sass" in args
        args = [a for a in args if a not in ("--step", "--sass")]
        names = list(VARIANTS) if args == ["all"] else args
        unknown = [n for n in names if n not in VARIANTS]
        if unknown:
            sys.exit(f"unknown variants {unknown}; known: {list(VARIANTS)}")
        main(names, base, step, sass)
