"""The error terms of kernel A's fp32 PV, on one CUDA card.

    python3 script/torch_pv32_terms.py [--rows N]

fp32 PV (``pv_dtype=torch.float32``) splits P and V into three bf16 terms
each (``x1 = bf16(x)``, ``x2 = bf16(x - x1)``, ``x3 = bf16(x - x1 - x2)``) and
forms O += P V per KV tile (64 keys) as the six bf16 tensor-core products
whose terms' orders add to at most 2, ``P3 V1 + P2 V2 + P1 V3 + P2 V1 + P1
V2 + P1 V1``, summed on the tensor cores from zero for each 64-column block
and added to O in f32. Against the exact sum of the same f32 P times the f32
V it differs by

1. the dropped products ``P2 V3 + P3 V2 + P3 V3``;
2. P's split residual, ``(P - P1 - P2 - P3) V``;
3. V's split residual, ``P (V - V1 - V2 - V3)``;
4. the accumulation: the tensor cores' f32 sums and the online rescaling by
   the tiles' alphas, in the kernel's order.

To tell the tensor cores' sums from f32 rounding as such, the same six
products are also summed in IEEE f32 (each tile's product by an f32 matmul
with TF32 off, the tiles then weighted and added in f32).

For int8 Q codes and int8 K codes (exact integer dots) the kernel's logits,
and so its P, are the plain version's bit for bit, so each term is computed
here in f64 from the plain version's own P (``attention_fwd_plain``'s tile
walk: each tile's P against the running maximum, weighted by
``2^(m_tile - m_last)``). Unit-normal f32 V, at b1 h8 s4096 for head dims
64, 128 and 256, non-causal and causal (whose first rows see 1-16 keys, so
that o is near one key's V). Prints, per head dim and mask, max|.| of the kernel's and
the plain version's output against the f64 sum of the same P, the kernel's
against the plain version's (what ``chip_smoke.py`` holds to PV32_MAX_DO),
terms 1-3, the six products summed in f64 against the f64 sum (terms 1-3
together), the kernel against those six products in f64 (term 4), and
the six products summed in IEEE f32 against them in f64; then the error
that each other way of forming P V in SCHEMES would leave (its products
summed in f64 against the f64 sum of the same P): the three-product scheme
this kernel replaced, four or five bf16 products of a two-term P, and
3xTF32. Prints the card's name and power limit first.
"""

from __future__ import annotations

import os
import subprocess
import sys

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def split(x: torch.Tensor, n: int = 3) -> list:
    """x's first ``n`` bf16 terms as f32 (each difference exact in f32)."""
    terms, r = [], x
    for _ in range(n):
        terms.append(r.to(torch.bfloat16).float())
        r = r - terms[-1]
    return terms


def tf32_split(x: torch.Tensor) -> list:
    """x's two TF32 terms as f32, each rounded to 10 mantissa bits to the
    nearest, ties away (``cvt.rna.tf32.f32``, as CUTLASS's 3xTF32 splits)."""
    def rna(y):
        return ((y.contiguous().view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)

    hi = rna(x)
    return [hi, rna(x - hi)]


#: The kernel's products, (P term, V term), 0-based.
PRODUCTS = ((2, 0), (1, 1), (0, 2), (1, 0), (0, 1), (0, 0))
#: Ways to form P V on the tensor cores: (operand type, P's terms, V's
#: terms, products as (P term, V term)).
SCHEMES = {
    "3 bf16 products, 2-term P and V (the earlier kernel)": ("bf16", 2, 2, ((0, 0), (1, 0), (0, 1))),
    "(b) 4 bf16 products, 2-term P and V": ("bf16", 2, 2, ((0, 0), (1, 0), (0, 1), (1, 1))),
    "(b) 4 bf16 products, 2-term P, 3-term V": ("bf16", 2, 3, ((0, 0), (1, 0), (0, 1), (0, 2))),
    "(b) 5 bf16 products, 2-term P, 3-term V": ("bf16", 2, 3, ((0, 0), (1, 0), (0, 1), (1, 1), (0, 2))),
    "6 bf16 products, 3-term P and V (the kernel)": ("bf16", 3, 3, PRODUCTS),
    "(a) 3xTF32": ("tf32", 2, 2, ((0, 0), (1, 0), (0, 1))),
}


def scheme_terms(x: torch.Tensor, kind: str, n: int) -> list:
    return split(x, n) if kind == "bf16" else tf32_split(x)


def terms(b: int, h: int, s: int, d: int, rows: int, gen: torch.Generator, causal: bool) -> dict:
    from lowbit_quant_fa2_paddle_tpu_torch.ops.attention import LOG2E, attention_fwd_plain, kv_tile, lowbit_attention
    from lowbit_quant_fa2_paddle_tpu_torch.ops.quant import quant_int8

    q = torch.randn(b, h, s, d, generator=gen, device="cuda")
    k = torch.randn(b, h, s, d, generator=gen, device="cuda") + 0.3
    v = torch.randn(b, h, s, d, generator=gen, device="cuda")
    c = LOG2E / d**0.5
    q8, qs = quant_int8(q, gran="per_token")
    k8, ks = quant_int8(k, gran="per_token")
    o_k = lowbit_attention(q8, k8, v, qs, ks, pv_dtype=torch.float32, out_dtype=torch.float32, is_causal=causal)
    qs = qs.float() * torch.tensor(c, dtype=torch.float32, device="cuda")  # as the wrapper folds sm_scale·log2e in
    o_p, _ = attention_fwd_plain(q8, k8, v, qs, ks, None, causal=causal, sm_scale_log2e=c, out_dtype=torch.float32,
                                 pv_f32=True)
    tile = kv_tile(False, d, pv_f32=True)
    nt = s // tile
    vt = split(v)
    vd = v.double()
    worst = dict.fromkeys(("kernel - exact", "plain - exact", "kernel - plain", "dropped products", "P residual",
                           "V residual", "6 products - exact", "kernel - 6 products", "6 products in f32 - in f64"),
                          0.0)
    worst.update(dict.fromkeys(SCHEMES, 0.0))
    v_terms = {(kind, n): [x.double() for x in scheme_terms(v, kind, n)] for kind, _, n, _ in SCHEMES.values()}
    torch.backends.cuda.matmul.allow_tf32 = False
    for lo in range(0, s, rows):
        sl = slice(lo, lo + rows)
        # The plain version's logits, P and weights (attention_fwd_plain, int8 Q codes).
        sc = ((q8[:, :, sl].float() @ k8.float().transpose(-1, -2)) * ks[:, :, None, :]) * qs[:, :, sl, None]
        if causal:
            keys, queries = torch.arange(s, device="cuda"), torch.arange(lo, lo + rows, device="cuda")
            sc = sc.masked_fill(keys[None, :] > queries[:, None], float("-inf"))
        sc = sc.view(b, h, -1, nt, tile)
        m_run = torch.cummax(sc.amax(dim=-1), dim=-1).values
        p = torch.exp2(sc - m_run[..., None])
        w = torch.exp2(m_run - m_run[..., -1:])
        l = (p.sum(dim=-1) * w).sum(dim=-1, keepdim=True).double()
        pt = split(p)
        wd = w.double()[..., None]
        flat = lambda x: (x.double() * wd).view(b, h, -1, s)  # noqa: E731
        exact = flat(p) @ vd / l
        six = sum(flat(pt[i]) @ vt[j].double() for i, j in PRODUCTS) / l
        # The same products summed in f32: tile j's keys [j*tile, (j+1)*tile), weighted by w_j.
        p_t = [x.view(b, h, -1, nt, tile).transpose(2, 3) for x in pt]  # [b, h, nt, rows, tile]
        v_t = [x.view(b, h, nt, tile, d) for x in vt]
        per_tile = sum(p_t[i] @ v_t[j] for i, j in PRODUCTS)  # [b, h, nt, rows, d] f32
        six32 = (per_tile * w.transpose(2, 3)[..., None]).sum(dim=2) / l.float()
        got = {
            "kernel - exact": o_k[:, :, sl].double() - exact,
            "plain - exact": o_p[:, :, sl].double() - exact,
            "kernel - plain": (o_k[:, :, sl] - o_p[:, :, sl]).double(),
            "dropped products": sum(flat(pt[i]) @ vt[j].double() for i, j in ((1, 2), (2, 1), (2, 2))) / l,
            "P residual": flat(p.double() - sum(x.double() for x in pt)) @ vd / l,
            "V residual": flat(p) @ (vd - sum(x.double() for x in vt)) / l,
            "6 products - exact": six - exact,
            "kernel - 6 products": o_k[:, :, sl].double() - six,
            "6 products in f32 - in f64": six32.double() - six,
        }
        for name, (kind, n_p, n_v, products) in SCHEMES.items():
            p_terms = scheme_terms(p, kind, n_p)
            got[name] = sum(flat(p_terms[i]) @ v_terms[(kind, n_v)][j] for i, j in products) / l - exact
        for key, x in got.items():
            worst[key] = max(worst[key], float(x.abs().max()))
        del sc, p, w, pt, exact, six, got, per_tile, six32
    worst["max|o|"] = float(o_p.abs().max())
    return worst


def main(rows: int) -> None:
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    gen = torch.Generator(device="cuda").manual_seed(15)
    for d in (64, 128, 256):
        for causal in (False, True):
            r = terms(1, 8, 4096, d, rows, gen, causal)
            print(f"fp32 PV d{d} b1 h8 s4096{' causal' if causal else ''}: "
                  + ", ".join(f"{k} {v:.3e}" for k, v in r.items()), flush=True)


if __name__ == "__main__":
    args = sys.argv[1:]
    main(int(args[args.index("--rows") + 1]) if "--rows" in args else 256)
