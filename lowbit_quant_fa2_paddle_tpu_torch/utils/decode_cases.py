"""Kernel D's multi-token (verify) and INT8-PV cases on the card: the edges
of its T-row masks and of INT8 PV, each with its inputs and the comparison
of the kernel with the plain version on its own tiles. The card tests
(``tests/test_torch_package.py``) and ``chip_smoke.py`` (phase 16) both run
this grid.

A case is ``(T, cache mode, compute_mode, d, b, h, hk, S_max, lengths,
window, sink, q dtype[, logit cap])``; ``lengths`` None asks for lengths
around a split boundary of the call's own plan. The ``d256-`` cases run the
head_dim-256 instances (``csrc/decode_attention_multi_d256.cu``), the hd256
LLM's 16 query and 8 KV heads. The bounds are phase 9's: cos >= 0.99999,
max|do| <= one bf16 ulp of max|o|, max|dlse| <= 1e-4, rows that see no key
o = 0 and lse = -1e30, the same bits on a second run, every launch on D's
design and on the case's variant (``ops.decode.launch_variant``).
"""

from __future__ import annotations

import math

import torch

from ..ops import decode as DD
from ..ops.metrics import cosine_similarity

CACHES = {"int8": (8, 8), "bf16": (16, 16), "int4": (4, 4), "k4v8": (4, 8), "k16v8": (16, 8)}
CASES = {
    # T rows whose limits straddle a 64-key tile edge (lengths 129, 130, 66: limits 126-129, 127-130, 63-66).
    "t4-tile-edge": (4, "int8", "auto", 128, 4, 32, 8, 4096, [129, 130, 66, 4096], 0, 0, torch.bfloat16),
    # ... and a split edge of the call's plan (lengths chunk + 1 .. chunk + 3).
    "t4-split-edge": (4, "int8", "auto", 128, 4, 32, 8, 4096, None, 0, 0, torch.bfloat16),
    "t8-split-edge-bf16": (8, "bf16", "auto", 128, 2, 32, 8, 4096, None, 0, 0, torch.bfloat16),
    # A window whose band start moves with t across a tile edge (577 - 3 - 256 + t = 318 + t), with sinks.
    "t4-window256-band-edge": (4, "int8", "auto", 128, 4, 32, 8, 4096, [577, 578, 4096, 1000], 256, 0,
                               torch.bfloat16),
    "t4-window256-sink4-band-edge": (4, "k4v8", "int_qk", 128, 4, 32, 8, 4096, [577, 578, 4096, 1000], 256, 4,
                                     torch.bfloat16),
    # Lengths below T + window (260), one below T.
    "t4-window256-short": (4, "int8", "auto", 128, 4, 32, 8, 4096, [100, 258, 259, 2], 256, 0, torch.bfloat16),
    "t3-int4-d64": (3, "int4", "auto", 64, 2, 8, 8, 1000, [1000, 2], 0, 0, torch.bfloat16),
    "t2-k4v8-f32-q-d32": (2, "k4v8", "auto", 32, 3, 8, 2, 777, [777, 1, 500], 0, 0, torch.float32),
    # INT8 PV: rows with no key (lengths 1, 2 at T 4), an all-masked tile of a row that sees keys elsewhere
    # (length 65: rows 0-2 see keys 0-63 only, so their P in tile 64.. is 0: pa = 1e-7, codes 0).
    "pv8-t4-masked-tiles": (4, "int8", "int", 128, 4, 32, 8, 4096, [1, 2, 65, 4096], 0, 0, torch.bfloat16),
    "pv8-t1": (1, "int8", "int", 128, 4, 32, 8, 4096, [4096, 1, 2000, 0], 0, 0, torch.bfloat16),
    "pv8-t4-window300-sink8": (4, "int8", "int", 128, 4, 32, 8, 4096, [4096, 64, 310, 3001], 300, 8,
                               torch.bfloat16),
    "pv8-t4-split-edge": (4, "int8", "int", 128, 4, 32, 8, 4096, None, 0, 0, torch.bfloat16),
    "pv8-t2-k4v8-d64": (2, "k4v8", "int", 64, 2, 8, 2, 1000, [1000, 3], 0, 0, torch.bfloat16),
    "pv8-t1-bf16-k-d128": (1, "k16v8", "int", 128, 2, 32, 8, 1000, [1000, 65], 0, 0, torch.bfloat16),
    "pv8-t3-d32-f32-q": (3, "int8", "int", 32, 2, 8, 2, 500, [500, 0], 0, 0, torch.float32),
    # Head_dim 256: T 1-8 on every cache mode and both chains, the window / sink walk, the cap, INT8 PV.
    "d256-t4-int8-split-edge": (4, "int8", "auto", 256, 2, 16, 8, 2048, None, 0, 0, torch.bfloat16),
    "d256-t8-bf16": (8, "bf16", "auto", 256, 2, 16, 8, 1000, [1000, 130], 0, 0, torch.bfloat16),
    "d256-t3-int4": (3, "int4", "auto", 256, 2, 16, 8, 1000, [777, 2], 0, 0, torch.bfloat16),
    "d256-t2-k4v8-int-qk-window256-sink4": (2, "k4v8", "int_qk", 256, 2, 16, 8, 1000, [577, 1000], 256, 4,
                                            torch.bfloat16),
    "d256-t4-int8-window256-cap30": (4, "int8", "auto", 256, 2, 16, 8, 1000, [577, 1000], 256, 0, torch.bfloat16,
                                     30.0),
    "d256-t8-k4v8-f32-q": (8, "k4v8", "auto", 256, 1, 16, 8, 700, [700], 0, 0, torch.float32),
    "d256-pv8-t4-masked-tiles": (4, "int8", "int", 256, 2, 16, 8, 1000, [1000, 33], 0, 0, torch.bfloat16),
    "d256-pv8-t1-window300-sink8": (1, "int8", "int", 256, 2, 16, 8, 1000, [1000, 310], 300, 8, torch.bfloat16),
    "d256-pv8-t2-bf16-k": (2, "k16v8", "int", 256, 2, 16, 8, 600, [600, 3], 0, 0, torch.bfloat16),
}


def case_inputs(name: str, gen: torch.Generator, device="cuda") -> tuple:
    """``(q, k, v, k_scale, v_scale, lengths, options, plain options)`` of a
    case: random bf16 K/V quantized per token into its cache mode."""
    t, cache, mode, d, b, h, hk, s, lengths, window, sink, q_dtype, *cap = CASES[name]
    cap = cap[0] if cap else 0.0
    k_bits, v_bits = CACHES[cache]
    k = torch.randn(b, hk, s, d, generator=gen, device=device).bfloat16()
    v = torch.randn(b, hk, s, d, generator=gen, device=device).bfloat16()
    (kq, ks), (vq, vs) = DD.quantize_token(k, bits=k_bits), DD.quantize_token(v, bits=v_bits)
    q = torch.randn(b, t, h, d, generator=gen, device=device).to(q_dtype)
    int_qk = k_bits != 16 and (mode in ("int", "int_qk") or (mode == "auto" and k_bits == 8))
    int_pv = mode == "int" and v_bits == 8
    plan = DD.kernel_partition(q, kq, vq, int_qk=int_qk, int_pv=int_pv, window=window, sink=sink, logit_cap=cap)
    if lengths is None:
        lengths = [plan["split_keys"] + i for i in (1, 2, 3)] + [2 * plan["split_keys"] + 1]
    lens = torch.tensor(lengths[:b], dtype=torch.int32, device=device)
    opts = dict(v_scale=vs, k_bits=k_bits, v_bits=v_bits, compute_mode=mode, window_size=window or None,
                sink_size=sink, logit_cap=cap)
    plain = dict(sm_scale=1.0 / math.sqrt(d), int_qk=int_qk, out_dtype=q.dtype, window=window,
                 sink=sink if window else 0, int_pv=int_pv, split_keys=plan["split_keys"], warps=plan["warps"],
                 logit_cap=cap)
    return q, kq, vq, ks, vs if v_bits != 16 else None, lens, opts, plain


def check_case(name: str, gen: torch.Generator) -> dict:
    """Runs a case twice through the kernel and once through the plain
    version on the kernel's tiles; returns the comparison and ``ok``."""
    q, kq, vq, ks, vs, lens, opts, plain = case_inputs(name, gen)
    b, t = q.shape[:2]
    multi = DD.kernel_partition(q, kq, vq, int_qk=plain["int_qk"], int_pv=plain["int_pv"])["multi"]
    variant = DD.launch_variant(multi, t, DD.cache_bits(kq, q), DD.cache_bits(vq, q), b)
    n = DD.decode_attention.launches_by_design["bulk_ring"]
    n_variant = DD.decode_attention.launches_by_variant.get(variant, 0)
    o, lse = DD.decode_attention(q, kq, vq, ks, lens, **opts, return_lse=True)
    o2, lse2 = DD.decode_attention(q, kq, vq, ks, lens, **opts, return_lse=True)
    o_ref, lse_ref = DD.decode_attention_plain(q, kq, vq, ks, vs, lens, **plain)
    torch.cuda.synchronize()
    limits = lens.long()[:, None] - (t - 1) + torch.arange(t, device=lens.device)  # [B, T]
    empty = limits <= 0
    r = {
        "cos": float(cosine_similarity(o, o_ref)),
        "max_do": float((o.float() - o_ref.float()).abs().max()),
        "max_dlse": float((lse - lse_ref).abs().max()),
        "bf16_ulp": 2.0 ** (math.floor(math.log2(float(o_ref.float().abs().max()))) - 7),
        "finite": bool(torch.isfinite(o.float()).all()),
        "same_bits_twice": torch.equal(o, o2) and torch.equal(lse, lse2),
        "empty_rows_ok": bool((o[empty].float() == 0).all()) and bool((lse[empty] == -1e30).all()),
        "on_design": DD.decode_attention.launches_by_design["bulk_ring"] == n + 2,
        "on_variant": DD.decode_attention.launches_by_variant.get(variant, 0) == n_variant + 2,
        "shape_ok": tuple(o.shape) == tuple(q.shape) and tuple(lse.shape) == tuple(q.shape[:-1]),
        "lengths": lens.tolist(),
    }
    r["ok"] = (r["finite"] and r["cos"] >= 0.99999 and r["max_do"] <= r["bf16_ulp"] and r["max_dlse"] <= 1e-4
               and r["same_bits_twice"] and r["empty_rows_ok"] and r["on_design"] and r["on_variant"] and r["shape_ok"])
    return r
