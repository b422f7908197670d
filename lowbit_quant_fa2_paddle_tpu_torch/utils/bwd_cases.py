"""Kernels G1/G2's head_dim-256 cases on the card: the edges of the d256
instances (``csrc/attention_bwd_wgmma_d256.cu``) in both modes, each with
its inputs and the comparison of the kernels with the plain version. The
card tests (``tests/test_torch_package.py``) and ``chip_smoke.py`` (phase
18) both run this grid.

A case is ``(quantized, causal, window, h, hk, d, sq, sk, dtype)``: d 256,
or 192 padded to 256. The bounds are phase 6's: per gradient cos >= 0.99999
and max|d| <= 2 bf16 ulps of its max|.|, finite, the dtype of the input, the
same bits on a second run (no atomics), one G1 and one G2 launch a call,
both at kernel head dim 256 and on the wgmma design.
"""

from __future__ import annotations

import math

import torch

from ..ops import attention_bwd as AB
from ..ops.attention import LOG2E
from ..ops.metrics import cosine_similarity
from ..ops.reference import attention_reference

CASES = {
    # Sq and Sk around the 64-row tiles, not a multiple of 4 (lse and di rows that do not start on 16 bytes).
    "d256-sq127-sk129-gqa": (False, False, 0, 4, 2, 256, 127, 129, torch.bfloat16),
    "d256-sq1-sk777": (False, False, 0, 4, 4, 256, 1, 777, torch.bfloat16),
    "d256-sq777-sk1-causal": (False, True, 0, 4, 4, 256, 777, 1, torch.bfloat16),
    "d256-causal-gqa-16q8kv-s777": (False, True, 0, 16, 8, 256, 777, 777, torch.bfloat16),
    "d256-window256-gqa-s777": (False, True, 256, 4, 2, 256, 777, 777, torch.bfloat16),
    "d256-f32-in-f32-out": (False, False, 0, 2, 1, 256, 300, 300, torch.float32),
    "d256-int8-sq129-sk300-gqa": (True, False, 0, 4, 2, 256, 129, 300, torch.bfloat16),
    "d256-int8-causal-gqa-s777": (True, True, 0, 8, 2, 256, 777, 777, torch.bfloat16),
    "d256-int8-window256-s700": (True, True, 256, 4, 4, 256, 700, 700, torch.bfloat16),
    "d192-causal-gqa-s500": (False, True, 0, 4, 2, 192, 500, 500, torch.bfloat16),
    "d192-int8-window128-s300": (True, True, 128, 4, 2, 192, 300, 300, torch.bfloat16),
}


def case_inputs(name: str, gen: torch.Generator, device="cuda") -> tuple:
    """``(q, k, v, o, lse2, do, flash_bwd options)`` of a case: random
    operands, the dense forward's o (plus noise, so that ds does not vanish
    where a row sees a single key; the formulas hold for any o) and base-2
    LSE."""
    quantized, causal, window, h, hk, d, sq, sk, dtype = CASES[name]
    q = torch.randn(1, h, sq, d, generator=gen, device=device).to(dtype)
    k = (torch.randn(1, hk, sk, d, generator=gen, device=device) + 0.3).to(dtype)
    v = torch.randn(1, hk, sk, d, generator=gen, device=device).to(dtype)
    do = torch.randn(1, h, sq, d, generator=gen, device=device).to(dtype)
    o, lse = attention_reference(q, k, v, is_causal=causal, window_size=window or None, return_lse=True)
    o = (o.float() + 0.5 * torch.randn(o.shape, generator=gen, device=device)).to(dtype)
    opts = dict(is_causal=causal, sm_scale=1.0 / math.sqrt(d), quantized=quantized, window=window)
    return q, k, v, o, lse * LOG2E, do, opts


def bf16_ulp(x: float) -> float:
    return 2.0 ** (math.floor(math.log2(x)) - 7) if x > 0 else 0.0


def check_case(name: str, gen: torch.Generator) -> dict:
    """Runs a case twice through G1/G2 (``flash_bwd``) and once through the
    plain version on the same operands; returns the comparison and ``ok``."""
    q, k, v, o, lse2, do, opts = case_inputs(name, gen)
    g1, g2 = AB.attention_bwd_dq, AB.attention_bwd_dkv
    before = [(g.launches_by_design["wgmma"], g.launches_by_dim[256]) for g in (g1, g2)]
    got = AB.flash_bwd(q, k, v, o, lse2, do, **opts)
    again = AB.flash_bwd(q, k, v, o, lse2, do, **opts)
    after = [(g.launches_by_design["wgmma"], g.launches_by_dim[256]) for g in (g1, g2)]
    args, kw = AB.bwd_operands(q, k, v, o, lse2, do, **opts)
    want = AB.attention_bwd_plain(*args, **kw, dq_dtype=q.dtype, dkv_dtype=k.dtype)
    torch.cuda.synchronize()
    r = {"launches_ok": all(a == (b0 + 2, b1 + 2) for a, (b0, b1) in zip(after, before))}
    ok = r["launches_ok"]
    for grad, a, a2, b in zip(("dq", "dk", "dv"), got, again, want):
        top = float(b.float().abs().max())
        g = {"cos": float(cosine_similarity(a, b)), "max_d": float((a.float() - b.float()).abs().max()),
             "bound": 2 * bf16_ulp(top), "finite": bool(torch.isfinite(a.float()).all()),
             "same_bits_twice": torch.equal(a, a2), "dtype_ok": a.dtype == b.dtype == q.dtype,
             "shape_ok": a.shape == b.shape}
        g["ok"] = (g["finite"] and g["cos"] >= 0.99999 and g["max_d"] <= g["bound"] and g["same_bits_twice"]
                   and g["dtype_ok"] and g["shape_ok"])
        r[grad] = g
        ok = ok and g["ok"]
    r["ok"] = ok
    return r
