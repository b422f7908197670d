"""Instructions per (q, k) pair in the attention kernels' main loops, from the SASS of a built library.

    python3 script/torch_attention_sass.py [LIBRARY.so ...]

With no argument it builds the port's kernels (``ops/_build.py``) and reads
that library. For every instance of kernel A (the wgmma design's
``attn_fwd_wgmma_kernel``, the ``mma.sync`` design's ``attn_fwd_kernel``) and
of kernels G1/G2 (``attn_bwd_dq_wgmma_kernel`` / ``attn_bwd_dkv_wgmma_kernel``)
in each library it finds the innermost loop that holds the exp2s (one per
pair), drops the masked code (G's masked copy of the per-pair chain, the
branch of two that each hold a tile's exp2s with the more integer compares;
else A's branch over at least one FSEL to MASK_VALUE per pair and no exp2),
divides what is left by
the (q, k) pairs a thread takes per iteration and prints the total, the
tensor-core instructions (HGMMA, HMMA, IMMA) and the instructions of the
conversion and MUFU pipes (F2F, F2FP, I2F, I2FP, MUFU), each per pair. Needs
``cuobjdump`` from the CUDA toolkit, so it runs on the machine with the card.
"""

from __future__ import annotations

import collections
import os
import re
import shutil
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
INSN = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(@!?U?P\w+\s+)?([A-Z0-9_.]+)([^;]*);")


def cuobjdump() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump"),
                 shutil.which("cuobjdump")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("cuobjdump not found: set CUDA_HOME or put it on PATH")


def pairs_per_iteration(head: str):
    """(q, k) pairs one thread takes per main-loop iteration, or None for a
    kernel this script does not read."""
    if "attn_fwd_wgmma_kernel" in head:
        return 64  # 64 rows x 128 keys per warpgroup
    if "attn_fwd_kernel" in head:
        return 32
    if "attn_bwd_dq_wgmma_kernel" in head or "attn_bwd_dkv_wgmma_kernel" in head:
        return 32  # 64 x 64 per warpgroup
    return None


def branch_target(rest: str):
    t = re.search(r"0x([0-9a-f]+)", rest)
    return int(t.group(1), 16) if t else None


def main_loop_counts(body_text: str, pairs: int):
    ins = [(int(m.group(1), 16), (m.group(2) or "").strip(), m.group(3), m.group(4)) for m in INSN.finditer(body_text)]
    at = {a: i for i, (a, _, _, _) in enumerate(ins)}
    loop = None
    for i, (a, _, op, rest) in enumerate(ins):
        t = branch_target(rest) if op.startswith("BRA") else None
        if t is not None and t < a and t in at:
            body = ins[at[t]:i + 1]
            if sum(x[2] == "MUFU.EX2" for x in body) >= pairs and (loop is None or len(body) < len(loop)):
                loop = body
    if loop is None:
        return None
    ex2 = lambda blk: sum(x[2] == "MUFU.EX2" for x in blk)  # noqa: E731
    copies, masked = [], []
    for a, pred, op, rest in loop:
        t = branch_target(rest) if op.startswith("BRA") else None
        if t is not None and t > a:
            blk = [x for x in loop if a < x[0] < t]
            if pairs <= ex2(blk) < ex2(loop):
                copies.append(blk)
            elif pred and sum(x[2].startswith(("FSEL", "SEL")) for x in blk) >= pairs and not ex2(blk):
                masked.append(blk)
    if copies:
        drop = max(copies, key=lambda blk: sum(x[2].startswith("ISETP") for x in blk))
    else:
        drop = min(masked, key=len) if masked else []
    drop = {x[0] for x in drop}
    return collections.Counter(x[2] for x in loop if x[0] not in drop)


def report(lib: str) -> None:
    sass = subprocess.run([cuobjdump(), "-sass", lib], capture_output=True, text=True, check=True).stdout
    print(lib)
    for part in re.split(r"(?=\n\s+Function : )", sass):
        head = part.split("\n", 2)[1].strip() if part.count("\n") > 1 else ""
        pairs = pairs_per_iteration(head)
        if pairs is None:
            continue
        c = main_loop_counts(part, pairs)
        if c is None:
            continue
        slow = {k: v for k, v in c.items() if k.startswith(("MUFU", "F2F", "I2F"))}
        tensor = sum(v for k, v in c.items() if k.startswith(("HGMMA", "HMMA", "IMMA")))
        print(f"  {head.split(':', 1)[1].strip()[-72:]}")
        print(f"    {sum(c.values()) / pairs:.2f} instructions per pair; tensor cores {tensor / pairs:.3f}; "
              f"conversion/MUFU {sum(slow.values()) / pairs:.2f}: "
              + ", ".join(f"{k} {v / pairs:.2f}" for k, v in sorted(slow.items())))


if __name__ == "__main__":
    libs = sys.argv[1:]
    if not libs:
        sys.path.insert(0, REPO)
        from lowbit_quant_fa2_paddle_tpu_torch.ops import _build

        _build.library()
        libs = [_build.library_path()]
    for lib in libs:
        report(lib)
