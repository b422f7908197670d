"""Kernel A's mask cases: one grid of modes and edges, with the inputs of a
case and the comparison of the kernel's output with the plain version's.
The card tests (``tests/test_torch_package.py``) and ``chip_smoke.py`` both
run this grid.

A mode is ``(q mode, K bits, V mode, head_dim)``: ``q mode`` "int8" (Q codes
from C1), "fused" (bf16 Q quantized in the kernel) or "fp"; ``V mode``
"bf16", "int8" (INT8 V, bf16 PV) or "int8_pv". An edge is ``(causal, Sq,
Sk, options)`` with :func:`~..ops.attention.lowbit_attention`'s mask
options; ``seg`` asks for segment ids of varlen sequences that split inside
the 128-key tiles, the last :data:`NO_KEY_ROWS` query rows in a segment no
key has; ``bias`` ("vector" or "matrix") for a random bias of that shape;
``pv32`` for fp32 PV on f32 V (out f32). Three grids: :data:`MODES` ×
:data:`EDGES` (the masks), :data:`MODES_D256` × :data:`EDGES_D256` (head_dim
256 and a padded 192) and :data:`EXTRA_MODES` × :data:`EXTRA_EDGES` (the bias
and fp32 PV, at head dims 64, 128 and 256 with INT8 and bf16 QK).
"""

from __future__ import annotations

import math

import torch

from ..ops.attention import LOG2E, _mask_args
from ..ops.metrics import cosine_similarity
from ..ops.quant import quant_int2, quant_int4, quant_int8, quant_v_int8_per_channel

#: The card's bound on fp32 PV's output against the plain version (f32): the
#: bound the plain version is held to against JAX's f32 products
#: (``tests/test_torch_hd256.py``'s F32_MAX_DO). The kernel's three bf16
#: terms of P and of V and six products a 16-key step drop terms below 2^-24
#: of |P V|; chip_smoke.py's PV32_MAX_DO.
PV32_MAX_DO = 1e-5

MODES = {
    "int8-d64": ("int8", 8, "bf16", 64), "fused-d64": ("fused", 8, "bf16", 64), "fused-d128": ("fused", 8, "bf16", 128),
    "fp-d64": ("fp", 16, "bf16", 64), "fp-d128": ("fp", 16, "bf16", 128), "int4-k-d64": ("fused", 4, "bf16", 64),
    "int2-k-d128": ("fused", 2, "bf16", 128), "int8-v-d128": ("fused", 8, "int8", 128),
    "int8-pv-d64": ("fused", 8, "int8_pv", 64),
}
EDGES = {
    "window100": (True, 700, 700, dict(window_size=100)),  # below the tile
    "window300": (True, 700, 700, dict(window_size=300)),  # not a tile multiple
    "window300-sink70": (True, 700, 700, dict(window_size=300, sink_size=70)),
    "window150-sink200": (True, 777, 777, dict(window_size=150, sink_size=200)),  # sink >= window
    "offset-empty-band": (True, 200, 300, dict(window_size=100, q_position_offset=1000)),
    "offset-sq300-sk700-window256": (True, 300, 700, dict(window_size=256, q_position_offset=400)),
    "segments": (False, 777, 777, dict(seg=True)),
    "segments-causal-window64": (True, 777, 777, dict(seg=True, window_size=64)),
    "cap5": (False, 500, 600, dict(logit_cap=5.0)),
    "cap2-causal-window200-sink8": (True, 600, 600, dict(logit_cap=2.0, window_size=200, sink_size=8)),
}
#: Kernel A at head_dim 256 in every mode, and head_dim 192 (padded to 256).
MODES_D256 = {
    "int8-d256": ("int8", 8, "bf16", 256), "fused-d256": ("fused", 8, "bf16", 256), "fp-d256": ("fp", 16, "bf16", 256),
    "int4-k-d256": ("fused", 4, "bf16", 256), "int2-k-d256": ("fused", 2, "bf16", 256),
    "int8-v-d256": ("fused", 8, "int8", 256), "int8-pv-d256": ("fused", 8, "int8_pv", 256),
    "fused-d192": ("fused", 8, "bf16", 192),
    "fp-d192": ("fp", 16, "bf16", 192),
}
#: The head_dim-256 edges: unmasked (non-causal, causal, ragged against the
#: 64-key tile) and masked.
EDGES_D256 = {
    "plain": (False, 300, 333, {}),
    "causal": (True, 333, 333, {}),
    "causal-sq130-sk777": (True, 130, 777, dict(q_position_offset=647)),
    "window100-sink70": (True, 400, 400, dict(window_size=100, sink_size=70)),
    "segments": (False, 400, 400, dict(seg=True)),
    "cap5": (False, 300, 300, dict(logit_cap=5.0)),
}
#: The bias (a per-key vector or a full matrix, natural-log units) alone and
#: with causal masking, a window and the cap; and fp32 PV (pv_dtype f32:
#: f32 V given, or int8 V codes) at its edges. Each runs in the modes of
#: :data:`EXTRA_MODES`.
EXTRA_EDGES = {
    "bias-vector": (False, 300, 333, dict(bias="vector")),
    "bias-matrix": (False, 300, 333, dict(bias="matrix")),
    "bias-vector-causal-window100-cap3": (True, 400, 400, dict(bias="vector", window_size=100, logit_cap=3.0)),
    "bias-matrix-causal-cap2": (True, 333, 333, dict(bias="matrix", logit_cap=2.0)),
    "pv32": (False, 300, 333, dict(pv32=True)),
    "pv32-causal-window100-sink8": (True, 400, 400, dict(pv32=True, window_size=100, sink_size=8)),
    "pv32-bias-matrix-causal": (True, 333, 333, dict(pv32=True, bias="matrix")),
}
EXTRA_MODES = {
    "fused-d64": ("fused", 8, "bf16", 64), "fp-d128": ("fp", 16, "bf16", 128), "int4-k-d128": ("fused", 4, "bf16", 128),
    "int8-v-d64": ("fused", 8, "int8", 64), "fused-d256": ("fused", 8, "bf16", 256),
    "int4-k-d256": ("fused", 4, "bf16", 256), "int8-v-d256": ("fused", 8, "int8", 256),
    "fp-d256": ("fp", 16, "bf16", 256),
}


#: The (mode, edge) pairs of the head_dim-256 and the bias / fp32 PV grids.
def extra_cases() -> list:
    return [(m, e) for m in MODES_D256 for e in EDGES_D256] + [(m, e) for m in EXTRA_MODES for e in EXTRA_EDGES]


HEADS, KV_HEADS = 4, 2
SEG_CUTS = (50, 200, 333)
NO_KEY_ROWS = 20


def segment_ids(n: int, cuts, device) -> torch.Tensor:
    """``[1, n]`` int32 ids, one more after each cut."""
    ids = torch.zeros(n, dtype=torch.int32, device=device)
    for c in cuts:
        ids[c:] += 1
    return ids[None]


def plain_masks(causal: bool, s_q: int, opts: dict) -> dict:
    """``attention_fwd_plain``'s mask arguments for ``lowbit_attention``'s
    mask options ``opts``."""
    window, sink, q_offset = _mask_args(s_q, causal, opts.get("window_size"), opts.get("sink_size", 0),
                                        opts.get("q_position_offset", 0))
    return dict(window=window, sink=sink, q_offset=q_offset, q_segment_ids=opts.get("q_segment_ids"),
                kv_segment_ids=opts.get("kv_segment_ids"), logit_cap=opts.get("logit_cap", 0.0))


def make_case(mode: str, edge: str, gen: torch.Generator, device) -> dict:
    """One case's inputs, GQA :data:`HEADS` q / :data:`KV_HEADS` kv heads:
    ``args`` and ``kw`` for ``lowbit_attention`` (without ``return_lse``),
    ``plain_args`` and ``plain_kw`` for ``attention_fwd_plain``, and
    ``empty_rows``, the rows no key is visible to."""
    q_mode, k_bits, v_mode, d = {**MODES, **MODES_D256, **EXTRA_MODES}[mode]
    causal, sq, sk, opts = {**EDGES, **EDGES_D256, **EXTRA_EDGES}[edge]
    opts = dict(opts)
    q = torch.randn(1, HEADS, sq, d, generator=gen, device=device).bfloat16()
    k = (torch.randn(1, KV_HEADS, sk, d, generator=gen, device=device) + 0.3).bfloat16()
    v = torch.randn(1, KV_HEADS, sk, d, generator=gen, device=device)
    pv32 = opts.pop("pv32", False)
    if not pv32:
        v = v.bfloat16()
    bias = opts.pop("bias", None)
    if bias is not None:
        opts["bias"] = torch.randn(1, HEADS, 1 if bias == "vector" else sq, sk, generator=gen, device=device)
    seg = opts.pop("seg", False)
    if seg:
        opts["kv_segment_ids"] = segment_ids(sk, SEG_CUTS, device)
        opts["q_segment_ids"] = segment_ids(sq, SEG_CUTS, device)
        opts["q_segment_ids"][:, sq - NO_KEY_ROWS:] = 99  # no key of segment 99
    vs = vm = None
    if v_mode != "bf16":
        v, vs, vm = quant_v_int8_per_channel(v, smooth_v=True)
    c = 1.0 / math.sqrt(d) * LOG2E
    q_scale = k_scale = qs = None
    if q_mode != "fp":
        k, k_scale = {8: quant_int8, 4: quant_int4, 2: quant_int2}[k_bits](k, gran="per_token")
    if q_mode == "int8":
        q, q_scale = quant_int8(q, gran="per_token")
        qs = q_scale * torch.tensor(c, dtype=torch.float32, device=device)
    kbits = 8 if k_bits == 16 else k_bits
    pv_int8 = v_mode == "int8_pv"
    window = plain_masks(causal, sq, opts)
    empty = HEADS * sq if edge == "offset-empty-band" else HEADS * NO_KEY_ROWS if seg else 0
    out = torch.float32 if pv32 else torch.bfloat16
    extra, plain_extra = {}, {}
    if pv32:
        extra, plain_extra = dict(pv_dtype=torch.float32, out_dtype=out), dict(pv_f32=not pv_int8)
    if bias is not None:
        plain_extra["bias"] = opts["bias"]
    return dict(args=(q, k, v, q_scale, k_scale),
                kw=dict(v_scale=vs, v_mean=vm, pv_int8=pv_int8, is_causal=causal, k_pack_bits=kbits, **opts, **extra),
                plain_args=(q, k, v, qs, k_scale, vm),
                plain_kw=dict(causal=causal, sm_scale_log2e=c, out_dtype=out, k_bits=kbits, v_scale=vs,
                              pv_int8=pv_int8, **window, **plain_extra),
                empty_rows=empty)


def masked_stats(o, lse, o_ref, lse_ref) -> dict:
    """The kernel's ``(o, lse)`` against the plain version's over the rows
    some key is visible to (cosine, max |do|, finite, max |dlse|), and
    whether the rest (``lse = -1e30`` in the plain version) are ``o = 0``,
    ``lse = -1e30`` in the kernel (``empty_ok``), with their count."""
    empty = lse_ref == -1e30
    live = ~empty
    r = {"cos": 1.0, "max_do": 0.0, "finite": True, "max_dlse": 0.0}
    if live.any():
        a, b = o[live].float(), o_ref[live].float()
        r = {"cos": float(cosine_similarity(a, b)), "max_do": float((a - b).abs().max()),
             "finite": bool(torch.isfinite(a).all()), "max_dlse": float((lse[live] - lse_ref[live]).abs().max())}
    r["empty_rows"] = int(empty.sum())
    r["empty_ok"] = torch.equal(lse == -1e30, empty) and (not empty.any() or float(o[empty].float().abs().max()) == 0.0)
    return r
