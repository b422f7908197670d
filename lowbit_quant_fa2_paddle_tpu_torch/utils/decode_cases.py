"""Kernel D's multi-token (verify) and INT8-PV cases on the card: the edges
of its T-row masks and of INT8 PV, each with its inputs and the comparison
of the kernel with the plain version on its own tiles. The card tests
(``tests/test_torch_package.py``) and ``chip_smoke.py`` (phase 16) both run
this grid.

A case is ``(T, cache mode, compute_mode, d, b, h, hk, S_max, lengths,
window, sink, q dtype[, logit cap])``; ``lengths`` None asks for lengths
around a split boundary of the call's own plan. The ``d256-`` cases run the
head_dim-256 instances (``csrc/decode_attention_multi_d256.cu``), the hd256
LLM's 16 query and 8 KV heads; the ``d96-`` and ``d80-`` cases the
instances off the ladder (``csrc/decode_attention*_d80_96.cu``: T 1 takes
the single-token kernels), every cache mode and both QK chains, 4-bit rows
of 40 bytes at d80 (copied in 8-byte pieces) with window phases that start
at odd keys; the ``d16-``, ``d48-``, ``d112-``, ``d144-``, ``d192-`` and
``d240-`` cases the instances that take the head dim at run time
(``csrc/decode_attention*_dyn.cu``, laid out for 128 or 256): every cache
mode and both chains, rows that end inside a QK window and 4-bit rows of
8, 24, 56, 72 and 120 bytes (copied in 8-byte pieces), Nemotron-4's GQA
group of 12 at d192. The bounds are phase 9's: cos >= 0.99999,
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
    # Head dims 96 (Phi-3-mini) and 80 (Phi-2): T 1-8, tile and split edges, every cache mode and both chains,
    # the window / sink walk, the cap, INT8 PV.
    "d96-t1-int8-split-edge": (1, "int8", "auto", 96, 2, 8, 8, 2048, None, 0, 0, torch.bfloat16),
    "d96-t4-bf16-tile-edge": (4, "bf16", "auto", 96, 2, 8, 2, 1000, [129, 34], 0, 0, torch.bfloat16),
    "d96-t8-int4": (8, "int4", "auto", 96, 2, 8, 8, 700, [700, 9], 0, 0, torch.bfloat16),
    "d96-t1-int4-int-qk": (1, "int4", "int_qk", 96, 2, 8, 8, 700, [700, 9], 0, 0, torch.bfloat16),
    "d96-t4-int4-int-qk": (4, "int4", "int_qk", 96, 2, 8, 8, 700, [700, 9], 0, 0, torch.bfloat16),
    "d96-t2-k4v8-window256-sink4": (2, "k4v8", "auto", 96, 2, 8, 2, 1000, [577, 1000], 256, 4, torch.bfloat16),
    "d96-t4-int8-window256-cap30": (4, "int8", "auto", 96, 2, 8, 2, 1000, [577, 1000], 256, 0, torch.bfloat16,
                                    30.0),
    "d96-t1-k4v8-f32-q": (1, "k4v8", "auto", 96, 2, 8, 2, 777, [777, 1], 0, 0, torch.float32),
    "d96-pv8-t4-masked-tiles": (4, "int8", "int", 96, 2, 8, 2, 1000, [1000, 65], 0, 0, torch.bfloat16),
    "d96-pv8-t1-bf16-k": (1, "k16v8", "int", 96, 2, 8, 8, 600, [600, 3], 0, 0, torch.bfloat16),
    "d80-t1-int8-split-edge": (1, "int8", "auto", 80, 2, 8, 8, 2048, None, 0, 0, torch.bfloat16),
    "d80-t3-bf16-tile-edge": (3, "bf16", "auto", 80, 2, 8, 2, 1000, [129, 33], 0, 0, torch.bfloat16),
    "d80-t1-int4-window101-sink3": (1, "int4", "auto", 80, 2, 8, 2, 1000, [578, 1000], 101, 3, torch.bfloat16),
    "d80-t1-int4-int-qk-window100-sink8": (1, "int4", "int_qk", 80, 2, 8, 8, 777, [400, 777], 100, 8,
                                           torch.bfloat16),
    "d80-t4-k4v8-int-qk-window100-sink8": (4, "k4v8", "int_qk", 80, 2, 8, 8, 777, [400, 777], 100, 8,
                                           torch.bfloat16),
    "d80-t4-int4-int-qk-window100-sink8": (4, "int4", "int_qk", 80, 2, 8, 8, 777, [400, 777], 100, 8,
                                           torch.bfloat16),
    "d80-t2-k4v8-cap20": (2, "k4v8", "auto", 80, 2, 8, 2, 700, [700, 65], 0, 0, torch.bfloat16, 20.0),
    "d80-t1-int8-f32-chain-f32-q": (1, "int8", "f32", 80, 2, 8, 2, 777, [777, 2], 0, 0, torch.float32),
    "d80-t8-k16v8": (8, "k16v8", "auto", 80, 1, 8, 1, 500, [500], 0, 0, torch.bfloat16),
    "d80-pv8-t2-window300-sink8": (2, "int8", "int", 80, 2, 8, 2, 1000, [1000, 310], 300, 8, torch.bfloat16),
    # Head dims at run time: 112 (MPT-30B) and 192 (Nemotron-4-340B, 12 query heads a KV head) in every cache
    # mode and on both chains, 16, 48, 144 and 240 at their row edges; T 1-8, tile and split edges, a window
    # with sinks, the cap, INT8 PV.
    "d112-t1-int8-split-edge": (1, "int8", "auto", 112, 2, 8, 8, 2048, None, 0, 0, torch.bfloat16),
    "d112-t4-bf16-tile-edge": (4, "bf16", "auto", 112, 2, 8, 2, 1000, [129, 34], 0, 0, torch.bfloat16),
    "d112-t8-int4": (8, "int4", "auto", 112, 2, 8, 8, 700, [700, 9], 0, 0, torch.bfloat16),
    "d112-t1-int4-int-qk-window100-sink8": (1, "int4", "int_qk", 112, 2, 8, 8, 777, [400, 777], 100, 8,
                                            torch.bfloat16),
    "d112-t4-k4v8-int-qk-window101-sink3": (4, "k4v8", "int_qk", 112, 2, 8, 2, 777, [578, 777], 101, 3,
                                            torch.bfloat16),
    "d112-t2-int8-window256-cap30": (2, "int8", "auto", 112, 2, 8, 2, 1000, [577, 1000], 256, 0, torch.bfloat16,
                                     30.0),
    "d112-t1-int8-f32-chain-f32-q": (1, "int8", "f32", 112, 2, 8, 2, 777, [777, 2], 0, 0, torch.float32),
    "d112-t1-k4v8-f32-q": (1, "k4v8", "auto", 112, 2, 8, 2, 777, [777, 1], 0, 0, torch.float32),
    "d112-pv8-t4-masked-tiles": (4, "int8", "int", 112, 2, 8, 2, 1000, [1000, 65], 0, 0, torch.bfloat16),
    "d112-pv8-t1-bf16-k": (1, "k16v8", "int", 112, 2, 8, 8, 600, [600, 3], 0, 0, torch.bfloat16),
    "d192-t1-int8-group12-split-edge": (1, "int8", "auto", 192, 2, 24, 2, 2048, None, 0, 0, torch.bfloat16),
    "d192-t4-bf16-group12": (4, "bf16", "auto", 192, 1, 24, 2, 600, [600], 0, 0, torch.bfloat16),
    "d192-t2-int4-int-qk-group12": (2, "int4", "int_qk", 192, 2, 12, 1, 700, [700, 9], 0, 0, torch.bfloat16),
    "d192-t1-k4v8-window256-sink4": (1, "k4v8", "auto", 192, 2, 12, 1, 1000, [577, 1000], 256, 4, torch.bfloat16),
    "d192-t3-int4-cap30": (3, "int4", "auto", 192, 2, 12, 1, 700, [700, 65], 0, 0, torch.bfloat16, 30.0),
    "d192-t1-int8-f32-chain-f32-q": (1, "int8", "f32", 192, 2, 12, 1, 500, [500, 2], 0, 0, torch.float32),
    "d192-pv8-t4-window300-sink8": (4, "int8", "int", 192, 2, 12, 1, 1000, [1000, 310], 300, 8, torch.bfloat16),
    "d192-pv8-t1-k4v8": (1, "k4v8", "int", 192, 2, 12, 1, 600, [600, 33], 0, 0, torch.bfloat16),
    "d16-t4-int8-tile-edge": (4, "int8", "auto", 16, 2, 8, 2, 777, [129, 66], 0, 0, torch.bfloat16),
    "d16-t1-k4v8-window100-sink8": (1, "k4v8", "auto", 16, 2, 8, 8, 777, [400, 777], 100, 8, torch.bfloat16),
    "d16-pv8-t2-bf16-k": (2, "k16v8", "int", 16, 2, 8, 2, 500, [500, 3], 0, 0, torch.bfloat16),
    "d48-t8-int4-int-qk": (8, "int4", "int_qk", 48, 1, 8, 1, 700, [700], 0, 0, torch.bfloat16),
    "d48-t1-bf16-f32-q-split-edge": (1, "bf16", "auto", 48, 2, 8, 8, 2048, None, 0, 0, torch.float32),
    "d144-t1-int4-window101-sink3": (1, "int4", "auto", 144, 2, 8, 2, 1000, [578, 1000], 101, 3, torch.bfloat16),
    "d144-t4-k4v8-int-qk": (4, "k4v8", "int_qk", 144, 2, 8, 2, 700, [700, 9], 0, 0, torch.bfloat16),
    "d240-t2-int8-cap20": (2, "int8", "auto", 240, 2, 8, 2, 700, [700, 65], 0, 0, torch.bfloat16, 20.0),
    "d240-t1-int4-int-qk-split-edge": (1, "int4", "int_qk", 240, 2, 8, 8, 2048, None, 0, 0, torch.bfloat16),
    "d240-pv8-t4-masked-tiles": (4, "int8", "int", 240, 2, 8, 2, 1000, [1000, 33], 0, 0, torch.bfloat16),
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


#: Kernel D over the paged cache: ``(T, cache mode, compute_mode, d, b, h,
#: hk, page, W, lengths, window, sink, q dtype[, logit cap])``, W the table's
#: pages a sequence. Tiles that span pages (page 8-32 under 64-key tiles) and
#: pages that hold several tiles (64-256), lengths 0 and at page edges, the
#: window / sink walk, INT8 PV, every cache mode and head dim.
PAGED_CASES = {
    "paged-t1-int8-p16": (1, "int8", "auto", 128, 4, 32, 8, 16, 40, [0, 80, 640, 115], 0, 0, torch.bfloat16),
    "paged-t4-int8-p64-window256-sink4": (4, "int8", "auto", 128, 4, 32, 8, 64, 12, [577, 578, 768, 3], 256, 4,
                                          torch.bfloat16),
    "paged-t1-bf16-p8-d64": (1, "bf16", "auto", 64, 3, 8, 2, 8, 50, [400, 1, 64], 0, 0, torch.bfloat16),
    "paged-t2-int4-p8-d64": (2, "int4", "auto", 64, 2, 8, 8, 8, 40, [320, 17], 0, 0, torch.bfloat16),
    "paged-t1-k4v8-p256": (1, "k4v8", "auto", 128, 2, 32, 8, 256, 4, [1024, 257], 0, 0, torch.bfloat16),
    "paged-t3-k4v8-int-qk-p8-d32": (3, "k4v8", "int_qk", 32, 3, 8, 2, 8, 30, [240, 2, 100], 0, 0, torch.float32),
    "paged-t1-int4-int-qk-p32-window100": (1, "int4", "int_qk", 128, 2, 32, 8, 32, 16, [512, 150], 100, 0,
                                           torch.bfloat16),
    "paged-t1-int8-p16-window256-cap30": (1, "int8", "auto", 128, 2, 32, 8, 16, 40, [640, 300], 256, 0,
                                          torch.bfloat16, 30.0),
    "paged-pv8-t4-p16": (4, "int8", "int", 128, 4, 32, 8, 16, 40, [1, 65, 640, 333], 0, 0, torch.bfloat16),
    "paged-pv8-t1-p8-window100-sink8-d64": (1, "int8", "int", 64, 2, 8, 2, 8, 40, [320, 110], 100, 8,
                                            torch.bfloat16),
    "paged-d256-t1-int8-p16": (1, "int8", "auto", 256, 2, 16, 8, 16, 32, [512, 33], 0, 0, torch.bfloat16),
    "paged-d256-t4-k4v8-p64": (4, "k4v8", "auto", 256, 2, 16, 8, 64, 8, [512, 70], 0, 0, torch.bfloat16),
    "paged-d256-pv8-t2-p8": (2, "int8", "int", 256, 2, 16, 8, 8, 40, [320, 9], 0, 0, torch.bfloat16),
    "paged-d256-t1-bf16-p32-window100": (1, "bf16", "auto", 256, 2, 16, 8, 32, 10, [320, 64], 100, 0,
                                         torch.bfloat16),
    "paged-d96-t1-int8-p16": (1, "int8", "auto", 96, 2, 8, 8, 16, 32, [512, 33], 0, 0, torch.bfloat16),
    "paged-d96-t4-bf16-p8": (4, "bf16", "auto", 96, 2, 8, 2, 8, 40, [320, 9], 0, 0, torch.bfloat16),
    "paged-d96-pv8-t2-p64-window100-sink8": (2, "int8", "int", 96, 2, 8, 2, 64, 8, [512, 120], 100, 8,
                                             torch.bfloat16),
    "paged-d80-t1-int4-p8": (1, "int4", "auto", 80, 2, 8, 2, 8, 40, [320, 17], 0, 0, torch.bfloat16),
    "paged-d80-t4-k4v8-int-qk-p32-window101": (4, "k4v8", "int_qk", 80, 2, 8, 2, 32, 16, [512, 150], 101, 0,
                                               torch.bfloat16),
    "paged-d80-t1-k16v8-p64-cap30": (1, "k16v8", "auto", 80, 2, 8, 8, 64, 8, [512, 70], 0, 0, torch.bfloat16, 30.0),
    "paged-d112-t1-int8-p64": (1, "int8", "auto", 112, 2, 8, 8, 64, 8, [512, 70], 0, 0, torch.bfloat16),
    "paged-d112-t4-int4-p8": (4, "int4", "auto", 112, 2, 8, 2, 8, 40, [320, 9], 0, 0, torch.bfloat16),
    "paged-d112-pv8-t2-p16-window100-sink8": (2, "int8", "int", 112, 2, 8, 2, 16, 32, [512, 120], 100, 8,
                                              torch.bfloat16),
    "paged-d192-t4-int8-p64-group12": (4, "int8", "auto", 192, 1, 24, 2, 64, 8, [500], 0, 0, torch.bfloat16),
    "paged-d192-t1-k4v8-int-qk-p32-window101": (1, "k4v8", "int_qk", 192, 2, 12, 1, 32, 16, [512, 150], 101, 0,
                                                torch.bfloat16),
    "paged-d16-t1-int4-p8": (1, "int4", "auto", 16, 2, 8, 2, 8, 40, [320, 17], 0, 0, torch.bfloat16),
    "paged-d48-t2-bf16-p32-cap30": (2, "bf16", "auto", 48, 2, 8, 8, 32, 16, [512, 33], 0, 0, torch.bfloat16, 30.0),
    "paged-d144-t1-int4-int-qk-p16": (1, "int4", "int_qk", 144, 2, 8, 2, 16, 32, [512, 33], 0, 0, torch.bfloat16),
    "paged-d240-t3-k16v8-p64": (3, "k16v8", "auto", 240, 2, 8, 8, 64, 8, [512, 70], 0, 0, torch.bfloat16),
}


def paged_pool(k, v, k_bits, v_bits, page, gen, lengths=None, window=0, sink=0, q_tokens=1):
    """Contiguous K/V ``[B, Hk, W·page, D]`` quantized per token and written
    into a pool of pages ``[Hk, n_pages, page, Dc]`` through a shuffled table
    ``[B, W]`` (two pages more than the table names). With
    ``lengths``, every page no sequence's walk visits gets NaN scales (and
    NaN rows in a bf16 cache), so a read of one shows. Returns ``(pool
    dict of k, v, k_scale, v_scale, the table, the contiguous quantized
    cache as (kq, vq, ks, vs))``."""
    b, hk, rows, _ = k.shape
    width = rows // page
    (kq, ks), (vq, vs) = DD.quantize_token(k, bits=k_bits), DD.quantize_token(v, bits=v_bits)
    n_pages = b * width + 2
    perm = torch.randperm(n_pages, generator=torch.Generator().manual_seed(int(torch.randint(
        0, 2**31 - 1, (1,), generator=gen, device=gen.device))))
    table = perm[: b * width].reshape(b, width).to(torch.int32)

    def to_pool(x):
        pool = torch.zeros((hk, n_pages, page) + tuple(x.shape[3:]), dtype=x.dtype, device=x.device)
        src = x.reshape((b, hk, width, page) + tuple(x.shape[3:])).transpose(0, 1)  # [Hk, B, W, page, ..]
        pool[:, table.long().to(x.device)] = src
        return pool

    pool = {"k": to_pool(kq), "v": to_pool(vq), "k_scale": to_pool(ks), "v_scale": to_pool(vs)}
    if lengths is not None:
        visited = set()
        for i, n in enumerate(lengths):
            for lo, hi in DD.walk_rows(int(n), rows, window=window, sink=sink, q_tokens=q_tokens):
                if hi > lo:
                    visited |= {int(table[i, p]) for p in range(lo // page, -(-hi // page))}
        dead = torch.tensor(sorted(set(range(n_pages)) - visited), dtype=torch.long, device=k.device)
        for name, bits in (("k", k_bits), ("v", v_bits), ("k_scale", 0), ("v_scale", 0)):
            if bits in (0, 16):
                pool[name][:, dead] = float("nan")
    return pool, table.to(k.device), (kq, vq, ks, vs)


def paged_case_inputs(name: str, gen: torch.Generator, device="cuda") -> tuple:
    """``(q, pool, table, lengths, options, plain options, contiguous
    cache)`` of a paged case (:func:`paged_pool`, unvisited pages NaN)."""
    t, cache, mode, d, b, h, hk, page, width, lengths, window, sink, q_dtype, *cap = PAGED_CASES[name]
    cap = cap[0] if cap else 0.0
    k_bits, v_bits = CACHES[cache]
    k = torch.randn(b, hk, width * page, d, generator=gen, device=device).bfloat16()
    v = torch.randn(b, hk, width * page, d, generator=gen, device=device).bfloat16()
    pool, table, contiguous = paged_pool(k, v, k_bits, v_bits, page, gen, lengths=lengths, window=window, sink=sink,
                                         q_tokens=t)
    q = torch.randn(b, t, h, d, generator=gen, device=device).to(q_dtype)
    int_qk = k_bits != 16 and (mode in ("int", "int_qk") or (mode == "auto" and k_bits == 8))
    int_pv = mode == "int" and v_bits == 8
    plan = DD.kernel_partition(q, pool["k"], pool["v"], int_qk=int_qk, int_pv=int_pv, window=window, sink=sink,
                               logit_cap=cap, page_table=table)
    lens = torch.tensor(lengths, dtype=torch.int32, device=device)
    opts = dict(v_scale=pool["v_scale"] if v_bits != 16 else None, k_bits=k_bits, v_bits=v_bits, compute_mode=mode,
                window_size=window or None, sink_size=sink, logit_cap=cap)
    plain = dict(sm_scale=1.0 / math.sqrt(d), int_qk=int_qk, out_dtype=q.dtype, window=window,
                 sink=sink if window else 0, int_pv=int_pv, split_keys=plan["split_keys"], warps=plan["warps"],
                 logit_cap=cap)
    return q, pool, table, lens, opts, plain, contiguous


def check_paged_case(name: str, gen: torch.Generator) -> dict:
    """A paged case twice through the kernel and once through the plain
    version on the kernel's tiles (the visited pages gathered), at
    :func:`check_case`'s bounds; also whether the contiguous kernel on the
    same rows (``W·page`` a sequence, so the same plan) gives the same bits
    (reported, not required: one paged token runs the T-token kernel at
    T = 1, the contiguous call the single-token one)."""
    q, pool, table, lens, opts, plain, (kq, vq, ks, vs) = paged_case_inputs(name, gen)
    b, t = q.shape[:2]
    k_bits, v_bits = opts["k_bits"], opts["v_bits"]
    multi = 2 if plain["int_pv"] else 1
    variant = DD.launch_variant(multi, t, k_bits, v_bits, b, paged=True)
    n = DD.decode_attention.launches_by_design["bulk_ring"]
    n_variant = DD.decode_attention.launches_by_variant.get(variant, 0)
    o, lse = DD.decode_attention(q, pool["k"], pool["v"], pool["k_scale"], lens, page_table=table, **opts,
                                 return_lse=True)
    o2, lse2 = DD.decode_attention(q, pool["k"], pool["v"], pool["k_scale"], lens, page_table=table, **opts,
                                   return_lse=True)
    o_ref, lse_ref = DD.decode_attention_paged_plain(q, pool["k"], pool["v"], pool["k_scale"], opts["v_scale"], lens,
                                                     table, **plain)
    on_design = DD.decode_attention.launches_by_design["bulk_ring"] == n + 2
    on_variant = DD.decode_attention.launches_by_variant.get(variant, 0) == n_variant + 2
    copts = {**opts, "v_scale": vs if v_bits != 16 else None}
    oc, lc = DD.decode_attention(q, kq, vq, ks, lens, **copts, return_lse=True)
    torch.cuda.synchronize()
    limits = lens.long()[:, None] - (t - 1) + torch.arange(t, device=lens.device)
    empty = limits <= 0
    r = {
        "cos": float(cosine_similarity(o, o_ref)),
        "max_do": float((o.float() - o_ref.float()).abs().max()),
        "max_dlse": float((lse - lse_ref).abs().max()),
        "bf16_ulp": 2.0 ** (math.floor(math.log2(float(o_ref.float().abs().max()))) - 7),
        "finite": bool(torch.isfinite(o.float()).all()),
        "same_bits_twice": torch.equal(o, o2) and torch.equal(lse, lse2),
        "empty_rows_ok": bool((o[empty].float() == 0).all()) and bool((lse[empty] == -1e30).all()),
        "on_design": on_design,
        "on_variant": on_variant,
        "shape_ok": tuple(o.shape) == tuple(q.shape) and tuple(lse.shape) == tuple(q.shape[:-1]),
        "contiguous_bits_equal": torch.equal(o, oc) and torch.equal(lse, lc),
        "lengths": lens.tolist(),
    }
    r["ok"] = (r["finite"] and r["cos"] >= 0.99999 and r["max_do"] <= r["bf16_ulp"] and r["max_dlse"] <= 1e-4
               and r["same_bits_twice"] and r["empty_rows_ok"] and r["on_design"] and r["on_variant"] and r["shape_ok"])
    return r
