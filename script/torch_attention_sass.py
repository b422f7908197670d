"""Instructions per (q, k) pair in kernel A's main loop, from the SASS of a built library.

    python3 script/torch_attention_sass.py [LIBRARY.so ...]

With no argument it builds the port's kernels (``ops/_build.py``) and reads
that library. For every instance of kernel A in each library (the wgmma
design's ``attn_fwd_wgmma_kernel``, the ``mma.sync`` design's
``attn_fwd_kernel``) it finds the innermost loop that holds the exp2s,
drops the masked block (the branch over the FSELs to MASK_VALUE), divides
what is left by the (q, k) pairs a thread takes per iteration (64 on the
wgmma design, 32 on mma.sync) and prints the total and the instructions of
the conversion and MUFU pipes (F2F, F2FP, I2F, I2FP, MUFU), each per pair.
Needs ``cuobjdump`` from the CUDA toolkit, so it runs on the machine with
the card.
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
    masked = []
    for a, pred, op, rest in loop:
        t = branch_target(rest) if op.startswith("BRA") and pred else None
        if t is not None and t > a:
            blk = [x for x in loop if a < x[0] < t]
            if any("-2.38197" in x[3] for x in blk) and not any(x[2] == "MUFU.EX2" for x in blk):
                masked.append(blk)
    drop = {x[0] for x in min(masked, key=len)} if masked else set()
    return collections.Counter(x[2] for x in loop if x[0] not in drop)


def report(lib: str) -> None:
    sass = subprocess.run([cuobjdump(), "-sass", lib], capture_output=True, text=True, check=True).stdout
    print(lib)
    for part in re.split(r"(?=\n\s+Function : )", sass):
        head = part.split("\n", 2)[1].strip() if part.count("\n") > 1 else ""
        if "attn_fwd_wgmma_kernel" not in head and "attn_fwd_kernel" not in head:
            continue
        pairs = 64 if "wgmma" in head else 32
        c = main_loop_counts(part, pairs)
        if c is None:
            continue
        slow = {k: v for k, v in c.items() if k.startswith(("MUFU", "F2F", "I2F"))}
        print(f"  {head.split(':', 1)[1].strip()[-72:]}")
        print(f"    {sum(c.values()) / pairs:.2f} instructions per pair; conversion/MUFU "
              f"{sum(slow.values()) / pairs:.2f}: " + ", ".join(f"{k} {v / pairs:.2f}" for k, v in sorted(slow.items())))


if __name__ == "__main__":
    libs = sys.argv[1:]
    if not libs:
        sys.path.insert(0, REPO)
        from lowbit_quant_fa2_paddle_tpu_torch.ops import _build

        _build.library()
        libs = [_build.library_path()]
    for lib in libs:
        report(lib)
