"""Kernel A's INT8 PV against its plain version over many random draws, to
see what moves its base-2 LSE, on one CUDA card.

    python3 script/torch_pv8_lse.py [--seeds N] [--out FILE]

Runs ``chip_smoke.py`` phase 4's INT8-PV edges (``PV8_EDGES``) once per
seed 0 .. N-1 (default 20), each seed drawing every edge's inputs as that
phase does. For each draw it reports max|dlse| over the rows and, for every
row, the change in the row's sum of p8 codes that its dlse means:
``l = 127 * 2^(lse - m)`` is the plain version's sum in codes (``m`` the
row's largest logit, from logits formed as the plain version forms them)
and ``dl = l * (2^dlse - 1)``. A dl of a code or a few at a row of small
``l`` says a P rounded to the other side of a p8 step, not that the kernel
is off. Prints the card's name and power limit first, a line a draw, then
the worst draw of each edge; ``--out`` also writes every reading as JSON.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def logits(q, k, ks, k_bits, c):
    """f32 logits [1, h, sq, sk] (base 2) as the plain version forms them."""
    import torch
    from lowbit_quant_fa2_paddle_tpu_torch.ops.quant import absmax_scale, quant_codes, unpack_int4
    from lowbit_quant_fa2_paddle_tpu_torch.ops.reference import _repeat_kv

    h = q.shape[1]
    if ks is None:
        return (q.to(torch.bfloat16).float() @ _repeat_kv(k.to(torch.bfloat16), h).float().transpose(-1, -2)) * c
    kf = _repeat_kv(k if k_bits == 8 else unpack_int4(k), h).float()
    sc = absmax_scale(q.float().abs().amax(dim=-1, keepdim=True))
    codes, qs = quant_codes(q.float(), sc).float(), sc[..., 0] * c
    return ((codes @ kf.transpose(-1, -2)) * _repeat_kv(ks.float()[:, :, None, :], h)) * qs[..., None]


def draw(seed):
    """One draw of every edge: ``{edge: reading}``."""
    import torch
    import chip_smoke
    from lowbit_quant_fa2_paddle_tpu_torch.ops import quant as qo
    from lowbit_quant_fa2_paddle_tpu_torch.ops.attention import LOG2E, attention_fwd_plain, lowbit_attention

    gen = torch.Generator(device="cuda").manual_seed(seed)
    out = {}
    for name, (k_bits, q_mode, causal, h, hk, d, sq, sk) in chip_smoke.PV8_EDGES.items():
        q = torch.randn(1, h, sq, d, generator=gen, device="cuda").bfloat16()
        k = (torch.randn(1, hk, sk, d, generator=gen, device="cuda") + 0.3).bfloat16()
        v8, vs, vm = qo.quant_v_int8_per_channel(torch.randn(1, hk, sk, d, generator=gen, device="cuda").bfloat16(),
                                                 smooth_v=True)
        ks = None
        if q_mode != "fp":
            k, ks = {8: qo.quant_int8, 4: qo.quant_int4}[k_bits](k, qo.k_mean(k), gran="per_token")
        kb = 8 if k_bits == 16 else k_bits
        c = LOG2E / math.sqrt(d)
        o, lse = lowbit_attention(q, k, v8, None, ks, v_scale=vs, v_mean=vm, pv_int8=True, is_causal=causal,
                                  k_pack_bits=kb, return_lse=True)
        _, lse_ref = attention_fwd_plain(q, k, v8, None, ks, vm, causal=causal, sm_scale_log2e=c,
                                         out_dtype=torch.bfloat16, k_bits=kb, v_scale=vs, pv_int8=True)
        s = logits(q, k, ks, kb, c)
        if causal:
            s = s.masked_fill(torch.ones(sq, sk, dtype=torch.bool, device="cuda").triu(1), -float("inf"))
        m = s.amax(dim=-1)
        l_ref = 127.0 * torch.exp2((lse_ref - m).double())
        dlse = (lse - lse_ref).double()
        dl = l_ref * (torch.exp2(dlse) - 1.0)
        i = int(dlse.abs().flatten().argmax())
        row = i % sq
        out[name] = {"max_dlse": float(dlse.abs().max()), "row": row, "keys": row + 1 if causal else sk,
                     "l": float(l_ref.flatten()[i]), "dl": float(dl.flatten()[i]),
                     "max_abs_dl": float(dl.abs().max()), "rows_over_1e-3": int((dlse.abs() > 1e-3).sum()),
                     "min_l": float(l_ref.min())}
        del q, k, v8, o, lse, lse_ref, s
    return out


def main():
    args = sys.argv[1:]
    seeds = int(args[args.index("--seeds") + 1]) if "--seeds" in args else 20
    path = args[args.index("--out") + 1] if "--out" in args else None
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    readings = {}
    for seed in range(seeds):
        readings[seed] = draw(seed)
        print(f"seed {seed}: " + " | ".join(
            f"{name} max|dlse| {r['max_dlse']:.3g} (row {r['row']}, {r['keys']} keys, l {r['l']:.1f}, "
            f"dl {r['dl']:+.3g}) max|dl| {r['max_abs_dl']:.3g} rows>1e-3 {r['rows_over_1e-3']}"
            for name, r in readings[seed].items()), flush=True)
    for name in readings[0]:
        worst = max(readings, key=lambda sd: readings[sd][name]["max_dlse"])
        r = readings[worst][name]
        print(f"worst {name}: seed {worst} max|dlse| {r['max_dlse']:.4g} at l {r['l']:.1f} (dl {r['dl']:+.3g}); "
              f"max|dl| over seeds {max(readings[sd][name]['max_abs_dl'] for sd in readings):.3g}; draws over 1e-3 "
              f"{sum(readings[sd][name]['max_dlse'] > 1e-3 for sd in readings)} of {seeds}", flush=True)
    if path:
        with open(path, "w") as f:
            json.dump(readings, f, indent=1)


if __name__ == "__main__":
    main()
