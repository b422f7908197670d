"""Kernels G1/G2's wgmma design against variants of its own source, and against
another tree's build, on one CUDA card.

    python3 script/torch_attention_bwd_ab.py [--base DIR] [--sass] [--d256] [all | VARIANT ...]

Each variant is a patch of ``csrc/attention_bwd_wgmma.cuh`` (G1/G2's device
code) or of the shared header ``csrc/sm90.cuh`` (see VARIANTS), built in its own copy of the package
under ``build/attention_bwd_ab/<name>/``; ``--base DIR`` adds the package of
another tree as "base" (for example the parent commit unpacked by ``git
archive`` into a directory that ``.gitignore`` lists). Every build (the
checkout's as "main", then base and each variant) times G1 (dq) and G2 (dk,
dv) in its own process with ``utils.benchmark.cuda_time_ms``: bf16 operands
and int8 codes (the quantized mode) at b1 h30 s17776 d64 (the DiT training
step's shape), and bf16 causal GQA 32q/8kv d128 at s8192; main also times
aten's flash-attention backward (dq, dk, dv in one call; at the GQA shape on
K and V repeated to 32 heads). The processes run in turns main, base, v1,
v2, ..., then the same in reverse, so each build is compared with main within
one call. Prints the card's name and power limit first. Named variants run;
``all`` runs every variant; with none named, main runs against base alone.
``--sass`` first compares, kernel by kernel, the SASS (``cuobjdump -sass``,
addresses and the anonymous namespace's names dropped) of the d64/d128 G1
and G2 kernels of main's build with base's, and prints a verdict line.
``--d256`` adds the head_dim-256 shape (b1 h8 s17776 d256, the DiT with
256-wide heads) to main's timings, beside aten's flash backward there.
"""

from __future__ import annotations

import os
import re
import shutil
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = "lowbit_quant_fa2_paddle_tpu_torch"
SRC = "attention_bwd_wgmma.cuh"

# name: (what it changes, [(file under csrc/, old, new), ...])
VARIANTS = {
    "exp2f": ("exp2f (with its range fix-up) instead of ex2.approx.ftz",
              [("sm90.cuh", "  asm(\"ex2.approx.ftz.f32 %0, %1;\\n\" : \"=f\"(y) : \"f\"(x));", "  y = exp2f(x);")]),
    "noturns": ("G1 without named-barrier turns between its consumer warpgroups",
                [(SRC, "  if (wg != NWG - 1) named_bar_arrive(bar_other, 256);\n", ""),
                 (SRC, "  if (wg == NWG - 1) named_bar_arrive(kBarTurn, 256);\n", "")]
                + [(SRC, f"{ind}{call}(bar_{who}, 256);\n", "") for call, who in (("named_bar_sync", "mine"),
                                                                                 ("named_bar_arrive", "other"))
                   for ind in ("    ", "  ")]),
    "g1-nwg2": ("G1 with two consumer warpgroups at d64 instead of three",
                [(SRC, "static constexpr int NWG = D == 64 ? 3 : D == 128 ? 2 : 1;  // consumer warpgroups",
                  "static constexpr int NWG = D == 64 ? 2 : D == 128 ? 2 : 1;  // consumer warpgroups")]),
    "g2-serial": ("G2 at d64 without the next tile's S^T, dP^T under this one's dk, dv",
                  [(SRC, "static constexpr bool kOverlap = D == 64;", "static constexpr bool kOverlap = false;")]),
    "g2-smem-a": ("G2 at d64 with K and V read from shared memory (_ss) instead of register A fragments",
                  [(SRC, "static constexpr bool kRegA = D == 64;", "static constexpr bool kRegA = false;")]),
    "noexp2": ("probe, wrong results: p = s2, no exp2 (the products, loads, masks and packs alone)",
               [(SRC, "float p = ex2(s2 - lse[hf]);", "float p = s2;"),
                (SRC, "float p = ex2(s2 - ((e & 1) ? l2.y : l2.x));", "float p = s2;")]),
}


def worker(tag: str, main: bool, d256: bool = False) -> None:
    """Time G1 and G2 from the package in the current directory."""
    sys.path.insert(0, os.getcwd())
    import torch
    from lowbit_quant_fa2_paddle_tpu_torch.ops import attention_bwd as AB
    from lowbit_quant_fa2_paddle_tpu_torch.ops.attention import flash_attention_fp
    from lowbit_quant_fa2_paddle_tpu_torch.utils.benchmark import cuda_time_ms

    out = []
    shapes = [("dit", (30, 30, 17776, 64, False)), ("gqa-d128", (32, 8, 8192, 128, True))]
    if d256 and main:  # older builds have no d256 instances
        shapes.append(("dit-d256", (8, 8, 17776, 256, False)))
    for shape, (h, hk, s, d, causal) in shapes:
        g = torch.Generator(device="cuda").manual_seed(0)
        q, do = (torch.randn(1, h, s, d, generator=g, device="cuda").bfloat16() for _ in range(2))
        k, v = (torch.randn(1, hk, s, d, generator=g, device="cuda").bfloat16() for _ in range(2))
        o, lse2 = flash_attention_fp(q, k, v, is_causal=causal, return_lse=True)
        for quantized in (False, True) if shape.startswith("dit") else (False,):
            args, kw = AB.bwd_operands(q, k, v, o.bfloat16(), lse2, do, is_causal=causal, sm_scale=d**-0.5,
                                       quantized=quantized)
            g1 = cuda_time_ms(lambda: AB.attention_bwd_dq(*args, **kw, dq_dtype=torch.bfloat16), warmup=2, reps=10)
            g2 = cuda_time_ms(lambda: AB.attention_bwd_dkv(*args, **kw, dkv_dtype=torch.bfloat16), warmup=2, reps=10)
            out.append(f"{shape}{' int8' if quantized else ''} G1 {g1:.3f} G2 {g2:.3f}")
        if main:
            kr, vr = (x.repeat_interleave(h // hk, dim=1) for x in (k, v))
            fwd = torch.ops.aten._scaled_dot_product_flash_attention(q, kr, vr, 0.0, causal, False)
            fo, flse, cq, ck, mq, mk, seed, offset = fwd[:8]
            aten = cuda_time_ms(lambda: torch.ops.aten._scaled_dot_product_flash_attention_backward(
                do, q, kr, vr, fo, flse, cq, ck, mq, mk, 0.0, causal, seed, offset), warmup=2, reps=10)
            out.append(f"{shape} aten {aten:.3f}")
        del q, k, v, do, o, args
    print(f"[{tag}] " + " | ".join(out) + " (ms)", flush=True)


def prepare(name: str) -> str:
    """A copy of the package with the variant's patches; its directory."""
    root = os.path.join(REPO, "build", "attention_bwd_ab", name)
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


def sass_kernels(binary: str) -> dict:
    """G1's and G2's kernels in a built library: {(kernel, D, int8):
    (instructions without addresses, encodings)}."""
    cuda = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    dump = subprocess.run([os.path.join(cuda, "bin", "cuobjdump"), "-sass", binary], capture_output=True, text=True,
                          check=True).stdout
    kernels, key = {}, None
    for line in dump.splitlines():
        if "Function :" in line:
            m = re.search(r"(attn_bwd_dq_wgmma_kernel|attn_bwd_dkv_wgmma_kernel)ILi(\d+)ELb([01])E", line)
            key = (m.group(1), int(m.group(2)), m.group(3) == "1") if m else None
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


def sass_diff(main_bin: str, base_bin: str) -> bool:
    """Prints, for each G1/G2 kernel of base (d64, d128; bf16 and int8), whether
    main's kernel of the same template arguments has the same instructions
    (and encodings), then a verdict line. True when all 8 are identical."""
    a, b = sass_kernels(main_bin), sass_kernels(base_bin)
    same = len(b) == 8
    for key in sorted(b):
        name = "{}<D={}, int8={}>".format(*key)
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
    print(f"sass: {len(b)} G1/G2 kernels of base compared with main's (main holds {len(a)}, "
          f"{sum(k[1] == 256 for k in a)} at d256), {'all identical' if same else 'NOT all identical'}", flush=True)
    return same


def main(names, base=None, sass=False, d256=False) -> None:
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
    for tag in order + order[::-1]:
        subprocess.run([sys.executable, os.path.abspath(__file__), "--worker", tag] + (["--d256"] if d256 else []),
                       cwd=dirs[tag], check=True)


if __name__ == "__main__":
    if sys.argv[1:2] == ["--worker"]:
        worker(sys.argv[2], main=sys.argv[2] == "main", d256="--d256" in sys.argv[3:])
    else:
        args = sys.argv[1:]
        base = None
        if args[:1] == ["--base"]:
            base, args = args[1], args[2:]
        sass, d256 = "--sass" in args, "--d256" in args
        args = [a for a in args if a not in ("--sass", "--d256")]
        names = list(VARIANTS) if args == ["all"] else args
        unknown = [n for n in names if n not in VARIANTS]
        if unknown:
            sys.exit(f"unknown variants {unknown}; known: {list(VARIANTS)}")
        main(names, base, sass, d256)
