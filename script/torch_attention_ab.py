"""Kernel A's wgmma design against variants of its own source and against
another tree's build, on one CUDA card.

    python3 script/torch_attention_ab.py [--base DIR] [--sass] [--masked] [--pairs N] [all | VARIANT ...]

Each variant is a patch of ``csrc/attention_fwd_wgmma.cu`` or of the shared
header ``csrc/sm90.cuh`` (see VARIANTS),
built in its own copy of the package under ``build/attention_ab/<name>/``;
``--base DIR`` adds the package of another tree as "base" (for example the
parent commit unpacked by ``git archive`` into a directory that
``.gitignore`` lists). Every build (the checkout's as "main", then base and
each variant's) times kernel A in its own process: int8 with Q quantized in
the kernel and fp at b1 h30 s17776 d64 (the DiT's shape) and at b1 h32 hk8
s32704 d128 causal (one batch row of the LLM prefill), with
``utils.benchmark.cuda_time_ms``; main and base also time packed INT4/INT2
K, INT8 V and INT8 V with INT8 PV at the DiT shape. The processes run in
turns main, base, v1, v2, ..., then the same in reverse, so each build is
compared with main within one call; ``--pairs N`` repeats that N times.
``--sass`` first compares, kernel by kernel, the SASS (``cuobjdump -sass``,
addresses and encodings dropped) of main's kernels (without fp32 PV) with
base's kernels of the same template arguments, where base
predates the masks', fp32 PV's or the bias's template argument. ``--masked`` times
the masked kernels (kMasks) at chip_smoke.py phase 15's shapes instead
(``masked_worker``). Prints the card's name and power limit
first. Named variants run; ``all`` runs every variant; with none named, main
runs against base alone.
"""

from __future__ import annotations

import os
import re
import shutil
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = "lowbit_quant_fa2_paddle_tpu_torch"
SRC = os.path.join("csrc", "attention_fwd_wgmma.cuh")

# name: (what it changes, [(old, new), ...] on csrc/attention_fwd_wgmma.cu, or
# (file under csrc/, old, new))
VARIANTS = {
    "nwg2": ("two consumer warpgroups at d64 instead of three",
             [("constexpr int kNWG = D == 64 ? 3 : 2;", "constexpr int kNWG = 2;")]),
    "noturns": ("no named-barrier turns between the consumer warpgroups",
                [("    if (wg == NWG - 1) named_bar_arrive(kBarTurn, 256);\n", ""),
                 ("      named_bar_sync(bar_mine, 256);\n", ""), ("    named_bar_sync(bar_mine, 256);\n", ""),
                 ("      named_bar_arrive(bar_other, 256);\n", ""), ("    named_bar_arrive(bar_other, 256);\n", ""),
                 ("    if (wg != NWG - 1) named_bar_arrive(bar_other, 256);\n", "")]),
    "exp2f": ("exp2f (with its range fix-up) instead of ex2.approx.ftz",
              [("sm90.cuh", "  asm(\"ex2.approx.ftz.f32 %0, %1;\\n\" : \"=f\"(y) : \"f\"(x));", "  y = exp2f(x);")]),
    "int-round": ("bf16 rounding of s - m by integer round-to-nearest-even, not cvt.rn.bf16x2",
                  [("          const uint32_t dd = pack_bf16x2(s0 - shift[hf], s1 - shift[hf]);\n"
                    "          s0 = ex2(bf16_lo(dd));\n          s1 = ex2(bf16_hi(dd));",
                    "          const uint32_t u0 = __float_as_uint(s0 - shift[hf]), u1 = __float_as_uint(s1 - shift[hf]);\n"
                    "          s0 = ex2(__uint_as_float((u0 + 0x7FFFu + ((u0 >> 16) & 1u)) & 0xFFFF0000u));\n"
                    "          s1 = ex2(__uint_as_float((u1 + 0x7FFFu + ((u1 >> 16) & 1u)) & 0xFFFF0000u));")]),
    "i2f-trick": ("the s32 dot to f32 through the bits of 1.5*2^23 + c instead of I2FP",
                  [("(float)sacc[4 * nt + e]", "i2f_exact(sacc[4 * nt + e])")]),
    "nosoftmax": ("probe, wrong results: no row maximum and no exp2 (P = bf16 of s, alpha = 1)",
                  [("#pragma unroll\n      for (int hf = 0; hf < 2; ++hf) {\n        float m4[4];",
                    "      alpha[0] = alpha[1] = 1.0f;\n      if (false)\n      for (int hf = 0; hf < 2; ++hf) {\n"
                    "        float m4[4];"),
                   ("          s0 = ex2(bf16_lo(dd));\n          s1 = ex2(bf16_hi(dd));",
                    "          s0 = bf16_lo(dd);\n          s1 = bf16_hi(dd);")]),
}


def masked_worker(tag: str) -> None:
    """Time kernel A's masked kernels (kMasks) from the package in the
    current directory at chip_smoke.py phase 15's shapes: int8 (Q quantized
    in the kernel) at b4 h32 s32768 d64 causal with a window of 4096 and of
    1024 + 128 sinks, fp with the window of 4096, int8 at the window LLM's
    prefill (b4 h32 hk8 s32704 d128, window 4096) and the logit cap 50 at
    the DiT shape."""
    sys.path.insert(0, os.getcwd())
    import torch
    from lowbit_quant_fa2_paddle_tpu_torch.ops import quant as qo
    from lowbit_quant_fa2_paddle_tpu_torch.ops.attention import lowbit_attention
    from lowbit_quant_fa2_paddle_tpu_torch.utils.benchmark import cuda_time_ms

    out = []
    rows = (("window4096", (4, 32, 32, 32768, 64, True), dict(window_size=4096), "int8"),
            ("window1024+sink128", (4, 32, 32, 32768, 64, True), dict(window_size=1024, sink_size=128), "int8"),
            ("fp window4096", (4, 32, 32, 32768, 64, True), dict(window_size=4096), "fp"),
            ("llm window4096", (4, 32, 8, 32704, 128, True), dict(window_size=4096), "int8"),
            ("dit cap50", (1, 30, 30, 17776, 64, False), dict(logit_cap=50.0), "int8"))
    for name, (b, h, hk, s, d, causal), opts, mode in rows:
        g = torch.Generator(device="cuda").manual_seed(0)
        q = torch.randn(b, h, s, d, generator=g, device="cuda").bfloat16()
        k, v = (torch.randn(b, hk, s, d, generator=g, device="cuda").bfloat16() for _ in range(2))
        if mode == "int8":
            kc, ks = qo.quant_int8(k, qo.k_mean(k), gran="per_token")
            call = lambda q=q, kc=kc, ks=ks, v=v: lowbit_attention(q, kc, v, None, ks, is_causal=causal, **opts)  # noqa: E731
        else:
            call = lambda q=q, k=k, v=v: lowbit_attention(q, k, v, is_causal=causal, **opts)  # noqa: E731
        out.append(f"{name} {cuda_time_ms(call, warmup=2, reps=10):.3f}")
        del q, k, v, call
        torch.cuda.empty_cache()
    print(f"[{tag} masked] " + " | ".join(out) + " (ms)", flush=True)


def worker(tag: str, lowbit: bool) -> None:
    """Time kernel A from the package in the current directory."""
    sys.path.insert(0, os.getcwd())
    import torch
    from lowbit_quant_fa2_paddle_tpu_torch.ops import quant as qo
    from lowbit_quant_fa2_paddle_tpu_torch.ops.attention import lowbit_attention
    from lowbit_quant_fa2_paddle_tpu_torch.utils.benchmark import cuda_time_ms

    out = []
    for shape, (h, hk, s, d, causal) in (("dit", (30, 30, 17776, 64, False)),
                                         ("prefill", (32, 8, 32704, 128, True))):
        g = torch.Generator(device="cuda").manual_seed(0)
        q = torch.randn(1, h, s, d, generator=g, device="cuda").bfloat16()
        k, v = (torch.randn(1, hk, s, d, generator=g, device="cuda").bfloat16() for _ in range(2))
        km = qo.k_mean(k)
        runs = {"int8": ((q, *qo.quant_int8(k, km, gran="per_token")), {}), "fp": ((q, k), {})}
        if lowbit and shape == "dit":
            runs["int4-K"] = ((q, *qo.quant_int4(k, km, gran="per_token")), {"k_pack_bits": 4})
            runs["int2-K"] = ((q, *qo.quant_int2(k, km, gran="per_token")), {"k_pack_bits": 2})
            v8, vs, vm = qo.quant_v_int8_per_channel(v, smooth_v=True)
            runs["int8-V"] = ((q, runs["int8"][0][1], runs["int8"][0][2]), {"v8": (v8, vs, vm)})
            runs["int8-PV"] = ((q, runs["int8"][0][1], runs["int8"][0][2]), {"v8": (v8, vs, vm), "pv_int8": True})
        for name, (args, kw) in runs.items():
            if "v8" in kw:
                v8, vs, vm = kw.pop("v8")
                call = (lambda a=args, v8=v8, vs=vs, vm=vm, kw=kw: lowbit_attention(
                    a[0], a[1], v8, None, a[2], v_scale=vs, v_mean=vm, is_causal=causal, **kw))
            elif len(args) == 3:
                call = lambda a=args, kw=kw: lowbit_attention(a[0], a[1], v, None, a[2], is_causal=causal, **kw)  # noqa: E731
            else:
                call = lambda a=args: lowbit_attention(a[0], a[1], v, is_causal=causal)  # noqa: E731
            out.append(f"{shape} {name} {cuda_time_ms(call, warmup=2, reps=10):.3f}")
        if shape == "prefill" or lowbit:
            sdpa = cuda_time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
                q, k, v, is_causal=causal, enable_gqa=hk != h), warmup=2, reps=10)
            out.append(f"{shape} sdpa {sdpa:.3f}")
        del q, k, v
    print(f"[{tag}] " + " | ".join(out) + " (ms)", flush=True)


def prepare(name: str) -> str:
    """A copy of the package with the variant's patch; its directory."""
    root = os.path.join(REPO, "build", "attention_ab", name)
    shutil.rmtree(root, ignore_errors=True)
    shutil.copytree(os.path.join(REPO, PKG), os.path.join(root, PKG), ignore=shutil.ignore_patterns("build"))
    for patch in VARIANTS[name][1]:
        src, old, new = patch if len(patch) == 3 else (os.path.basename(SRC), *patch)
        path = os.path.join(root, PKG, "csrc", src)
        with open(path) as f:
            text = f.read()
        if old not in text:
            raise RuntimeError(f"variant {name}: patch does not apply to {src}: {old[:60]!r}")
        with open(path, "w") as f:
            f.write(text.replace(old, new))
    return root


def sass_kernels(binary: str) -> dict:
    """Kernel A's kernels in a built library or cubin: {(D, int8, staged,
    pv8, masks, pv32, bias): (instructions without addresses, encodings)}.
    A kernel of a build from before the masks (or fp32 PV, or the bias)
    counts as one without them."""
    cuda = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    dump = subprocess.run([os.path.join(cuda, "bin", "cuobjdump"), "-sass", binary], capture_output=True, text=True,
                          check=True).stdout
    kernels, key = {}, None
    for line in dump.splitlines():
        if "Function :" in line:
            # attn_fwd_wgmma_kernel<D, kInt8, kStaged, kPV8[, kMasks[, kPV32, kBias]]>, mangled
            m = re.search(r"attn_fwd_wgmma_kernelILi(\d+)E((?:Lb[01]E){3,6})E", line)
            key = None
            if m:
                flags = tuple(f == "1" for f in re.findall(r"Lb([01])E", m.group(2)))
                key = (int(m.group(1)), *flags, *((False,) * (6 - len(flags))))
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


def sass_diff(main_bin: str, base_bin: str) -> bool:
    """Prints, for each kernel without fp32 PV that both binaries hold (with
    and without the masks and the bias), whether its instructions (and their
    encodings, with the scheduling bits) are the same, and the first
    differing instructions where they are not. True when every such kernel's
    instructions are the same."""
    a, b = sass_kernels(main_bin), sass_kernels(base_bin)
    same = True
    for key in sorted(k for k in a if not k[5] and k in b):
        (la, ea), (lb, eb) = a[key], b[key]
        name = "attn_fwd_wgmma_kernel<{}, int8={}, staged={}, pv8={}, masks={}, bias={}>".format(*key[:5], key[6])
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
    n = sum(1 for k in a if not k[5] and k in b)
    want = sum(1 for k in b if not k[5])
    print(f"sass: {n} of base's {want} kernels of A without fp32 PV ({len(b)} in all) compared with main's (main "
          f"holds {len(a)}), {'all identical' if same and n == want else 'NOT all identical'}", flush=True)
    return same and n == want


def main(names, base=None, sass=False, pairs=1, masked=False) -> None:
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
    if base:
        print(f"base: the package of {base}", flush=True)
        if sass:
            sass_diff(library_of(REPO), library_of(dirs["base"]))
    for name in names:
        print(f"{name}: {VARIANTS[name][0]}", flush=True)
    order = list(dirs)
    for tag in (order + order[::-1]) * pairs:
        subprocess.run([sys.executable, os.path.abspath(__file__), "--masked-worker" if masked else "--worker", tag],
                       cwd=dirs[tag], check=True)


if __name__ == "__main__":
    if sys.argv[1:2] == ["--worker"]:
        worker(sys.argv[2], lowbit=sys.argv[2] in ("main", "base"))
    elif sys.argv[1:2] == ["--masked-worker"]:
        masked_worker(sys.argv[2])
    else:
        args = sys.argv[1:]
        base = None
        if args[:1] == ["--base"]:
            base, args = args[1], args[2:]
        sass, masked = "--sass" in args, "--masked" in args
        args = [a for a in args if a not in ("--sass", "--masked")]
        pairs = 1
        if "--pairs" in args:
            i = args.index("--pairs")
            pairs, args = int(args[i + 1]), args[:i] + args[i + 2:]
        names = list(VARIANTS) if args == ["all"] else args
        unknown = [n for n in names if n not in VARIANTS]
        if unknown:
            sys.exit(f"unknown variants {unknown}; known: {list(VARIANTS)}")
        main(names, base, sass, pairs, masked)
