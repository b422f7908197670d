"""The error terms of kernel A's fp32 PV, on one CUDA card.

    python3 script/torch_pv32_terms.py [--rows N]

fp32 PV (``pv_dtype=torch.float32``) forms O += P V per KV tile as three bf16
tensor-core products, ``P_hi V_hi + P_lo V_hi + P_hi V_lo`` (``hi = bf16(x)``,
``lo = bf16(x - hi)``), accumulated in f32. Against the exact sum of the same
f32 P times the f32 V it differs by

1. the dropped ``P_lo V_lo``;
2. P's split residual, ``(P - P_hi - P_lo) V``;
3. V's split residual, ``P (V - V_hi - V_lo)``;
4. the accumulation: the tensor cores' f32 sums and the online rescaling by
   the tiles' alphas, in the kernel's order.

To tell the tensor cores' sums from f32 rounding as such, the same three
products are also summed in IEEE f32 (each tile's product by an f32 matmul
with TF32 off, the tiles then weighted and added in f32).

For int8 Q codes and int8 K codes (exact integer dots) the kernel's logits,
and so its P, are the plain version's bit for bit, so each term is computed
here in f64 from the plain version's own P (``attention_fwd_plain``'s tile
walk: each tile's P against the running maximum, weighted by
``2^(m_tile - m_last)``). Non-causal, unit-normal f32 V, at b1 h8 s4096 for
head dims 64, 128 and 256. Prints, per head dim, max|.| of the kernel's and
the plain version's output against the f64 sum of the same P, the kernel's
against the plain version's (what ``chip_smoke.py`` holds to PV32_MAX_DO),
terms 1-3, the three products summed in f64 against the f64 sum (terms 1-3
together), the kernel against those three products in f64 (term 4), and
the three products summed in IEEE f32 against them in f64.
Prints the card's name and power limit first.
"""

from __future__ import annotations

import os
import subprocess
import sys

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def split(x: torch.Tensor):
    """x's bf16 hi and lo terms as f32 (x - hi is exact in f32)."""
    hi = x.to(torch.bfloat16).float()
    return hi, (x - hi).to(torch.bfloat16).float()


def terms(b: int, h: int, s: int, d: int, rows: int, gen: torch.Generator) -> dict:
    from lowbit_quant_fa2_paddle_tpu_torch.ops.attention import LOG2E, attention_fwd_plain, kv_tile, lowbit_attention
    from lowbit_quant_fa2_paddle_tpu_torch.ops.quant import quant_int8

    q = torch.randn(b, h, s, d, generator=gen, device="cuda")
    k = torch.randn(b, h, s, d, generator=gen, device="cuda") + 0.3
    v = torch.randn(b, h, s, d, generator=gen, device="cuda")
    c = LOG2E / d**0.5
    q8, qs = quant_int8(q, gran="per_token")
    k8, ks = quant_int8(k, gran="per_token")
    o_k = lowbit_attention(q8, k8, v, qs, ks, pv_dtype=torch.float32, out_dtype=torch.float32)
    qs = qs.float() * torch.tensor(c, dtype=torch.float32, device="cuda")  # as the wrapper folds sm_scale·log2e in
    o_p, _ = attention_fwd_plain(q8, k8, v, qs, ks, None, causal=False, sm_scale_log2e=c, out_dtype=torch.float32,
                                 pv_f32=True)
    tile = kv_tile(False, d)
    nt = s // tile
    vh, vl = split(v)
    vd = v.double()
    worst = dict.fromkeys(("kernel - exact", "plain - exact", "kernel - plain", "P_lo V_lo", "P residual",
                           "V residual", "3 products - exact", "kernel - 3 products", "3 products in f32 - in f64"),
                          0.0)
    torch.backends.cuda.matmul.allow_tf32 = False
    for lo in range(0, s, rows):
        sl = slice(lo, lo + rows)
        # The plain version's logits, P and weights (attention_fwd_plain, int8 Q codes).
        sc = ((q8[:, :, sl].float() @ k8.float().transpose(-1, -2)) * ks[:, :, None, :]) * qs[:, :, sl, None]
        sc = sc.view(b, h, -1, nt, tile)
        m_run = torch.cummax(sc.amax(dim=-1), dim=-1).values
        p = torch.exp2(sc - m_run[..., None])
        w = torch.exp2(m_run - m_run[..., -1:])
        l = (p.sum(dim=-1) * w).sum(dim=-1, keepdim=True).double()
        ph, pl = split(p)
        wd = w.double()[..., None]
        flat = lambda x: (x.double() * wd).view(b, h, -1, s)  # noqa: E731
        exact = flat(p) @ vd / l
        three = (flat(ph) @ vh.double() + flat(pl) @ vh.double() + flat(ph) @ vl.double()) / l
        # The same products summed in f32: tile j's keys [j*tile, (j+1)*tile), weighted by w_j.
        ph_t, pl_t = (x.view(b, h, -1, nt, tile).transpose(2, 3) for x in (ph, pl))  # [b, h, nt, rows, tile]
        vh_t, vl_t = (x.view(b, h, nt, tile, d) for x in (vh, vl))
        per_tile = ph_t @ vh_t + pl_t @ vh_t + ph_t @ vl_t  # [b, h, nt, rows, d] f32
        three32 = (per_tile * w.transpose(2, 3)[..., None]).sum(dim=2) / l.float()
        got = {
            "kernel - exact": o_k[:, :, sl].double() - exact,
            "plain - exact": o_p[:, :, sl].double() - exact,
            "kernel - plain": (o_k[:, :, sl] - o_p[:, :, sl]).double(),
            "P_lo V_lo": flat(pl) @ vl.double() / l,
            "P residual": flat(p.double() - ph.double() - pl.double()) @ vd / l,
            "V residual": flat(p) @ (vd - vh.double() - vl.double()) / l,
            "3 products - exact": three - exact,
            "kernel - 3 products": o_k[:, :, sl].double() - three,
            "3 products in f32 - in f64": three32.double() - three,
        }
        for key, x in got.items():
            worst[key] = max(worst[key], float(x.abs().max()))
        del sc, p, w, ph, pl, exact, three, got, per_tile, three32
    worst["max|o|"] = float(o_p.abs().max())
    return worst


def main(rows: int) -> None:
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    gen = torch.Generator(device="cuda").manual_seed(15)
    for d in (64, 128, 256):
        r = terms(1, 8, 4096, d, rows, gen)
        print(f"fp32 PV d{d} b1 h8 s4096: " + ", ".join(f"{k} {v:.3e}" for k, v in r.items()), flush=True)


if __name__ == "__main__":
    args = sys.argv[1:]
    main(int(args[args.index("--rows") + 1]) if "--rows" in args else 256)
