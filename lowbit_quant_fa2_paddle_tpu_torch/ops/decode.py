"""Single-token decode attention over the quantized KV cache (kernel D), and
the cache ops.

PyTorch/CUDA counterpart of ``lowbit_quant_fa2_paddle_tpu/ops/decode.py``.
The cache is a dict of tensors with the JAX package's keys: ``k``/``v``
``[B, Hk, S_max, D]`` (int8 codes for 8 bits, bf16 rows for 16) or
``[B, Hk, S_max, D/2]`` (4 bits: two codes a byte, halves of D), ``k_scale``/
``v_scale`` ``[B, Hk, S_max]`` f32 per-token scales (ones for 16 bits) and
``length`` int32 ``[B]``, which stays on the device. Each side has its own
width, so the KIVI-style k4v8 mix (4-bit K, int8 V) is one cache.

``decode_attention`` takes the plain PyTorch version below for tensors on
the CPU and launches ``csrc/decode_attention.cu`` for CUDA tensors (one
launch: a split-KV pass whose last CTA per row group merges the splits; one
design, ``kernel_design``: a producer warp's ring of bulk copies on
mbarriers, consumer warps that each own whole tiles, QK on ``mma.sync``, PV
in f32); nothing falls back.

Semantics of one query token per sequence, as the TPU kernel computes them:

* integer chain (int8 K with ``compute_mode`` "auto" or "int_qk", 4-bit K
  with "int_qk"): each query row is quantized, ``qa = fma(max|q|, 1/127,
  1e-7)``, ``q8 = round_away(q / qa)``; the integer dot with the K codes is
  exact; ``s = sI·(qa·sm_scale)·ks·log2e``;
* float chain (bf16 K, 4-bit K by default, or ``compute_mode="f32"``):
  ``s = (q·k)·sm_scale·ks·log2e`` in f32;
* ``logit_cap`` c: ``s = c·tanh(s / c)`` in natural units, before ``·log2e``;
* keys at ``pos >= length`` get ``-0.7·FLT_MAX``, and with ``window_size`` W
  those below ``length - W`` too, but for the ``sink_size`` leading keys
  (StreamingLLM's sinks); softmax in base 2 with f32
  P (not rounded to bf16, unlike kernel A); a quantized V's scale is folded
  into P after ``l`` is summed; PV in f32;
* ``o = acc / l`` in ``q.dtype``, base-2 LSE ``m + log2 l``; a row with no
  visible key gives ``o = 0`` and ``lse = -1e30``.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional, Tuple

import torch

from lowbit_quant_fa2_paddle_tpu_torch.ops import _build
from lowbit_quant_fa2_paddle_tpu_torch.ops.attention import LOG2E, MASK_VALUE, NEG_INIT, _not_ported
from lowbit_quant_fa2_paddle_tpu_torch.ops.quant import (
    INT4_QMAX,
    INT8_QMAX,
    absmax_scale,
    cdiv,
    pack_codes,
    quant_codes,
    unpack_int4,
)

#: Keys a split of kernel D is a whole multiple of (its tiles hold 64, 32
#: or 16 keys: ``BK`` in csrc/decode_attention.cu).
KV_TILE = 64
#: Query rows (heads of one KV group) per CTA of kernel D, at most.
MAX_ROWS = 8
#: Waves of resident CTAs the split-KV pass aims for.
WAVES = 1
#: Splits of one row group, at most (the merging CTA keeps a weight per
#: split and warp in shared memory).
MAX_SPLITS = 64
#: Consumer warps per CTA of kernel D; each leaves one partial state per split.
WARPS = 4
#: Designs of kernel D: one, for every mode (int8/4-bit/bf16 K and V, both
#: QK chains, d32/64/128).
DESIGNS = ("bulk_ring",)

_OUT_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


# ---------------------------------------------------------------------------
# Quantized KV cache ops
# ---------------------------------------------------------------------------


def _check_bits(k_bits: int, v_bits: int) -> None:
    if k_bits not in (16, 8, 4) or v_bits not in (16, 8, 4):
        raise ValueError(f"cache bits must be 16, 8 or 4, got k_bits={k_bits} v_bits={v_bits}")


def _unpack4_cols(packed: torch.Tensor) -> torch.Tensor:
    """Nibble-packed ``[..., D/2]`` int8 -> ``[..., D]`` f32 codes (halves of
    D: byte i holds column i low and column i + D/2 high)."""
    return unpack_int4(packed).float()


def init_kv_cache(
    b: int, hk: int, s_max: int, d: int, *, bits: int = 8,
    k_bits: Optional[int] = None, v_bits: Optional[int] = None, device="cuda",
) -> dict:
    """Contiguous KV cache with per-token scales: int8 codes for 8 bits,
    nibble-packed ``[.., D/2]`` int8 for 4, bf16 rows for 16 (scales stay
    ones), on the CUDA card unless ``device`` says otherwise.
    ``k_bits``/``v_bits`` override ``bits`` per side (k4v8: ``k_bits=4``,
    ``v_bits=8``)."""
    k_bits = bits if k_bits is None else k_bits
    v_bits = bits if v_bits is None else v_bits
    _check_bits(k_bits, v_bits)

    def buf(nbits):
        dtype = torch.bfloat16 if nbits == 16 else torch.int8
        return torch.zeros((b, hk, s_max, d // 2 if nbits == 4 else d), dtype=dtype, device=device)

    return {
        "k": buf(k_bits),
        "v": buf(v_bits),
        "k_scale": torch.ones((b, hk, s_max), dtype=torch.float32, device=device),
        "v_scale": torch.ones((b, hk, s_max), dtype=torch.float32, device=device),
        "length": torch.zeros((b,), dtype=torch.int32, device=device),
    }


def quantize_token(x: torch.Tensor, *, bits: int = 8) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row symmetric quantization over the last dim (new-token K/V rows
    ``[B, Hk, D]``, or whole prefill K/V ``[B, Hk, S, D]``): int8 codes and
    f32 scales ``amax/qmax + 1e-7`` (the fma form XLA compiles; qmax 127, or
    7 for ``bits=4``), codes rounded half away from zero and clipped to
    ±qmax. ``bits=4`` packs the codes two a byte in halves of D (``[.., D/2]``:
    ``codes[:D/2] & 0xF | codes[D/2:] << 4``). ``bits=16`` keeps bf16 rows
    with unit scales."""
    if bits == 16:
        return x.to(torch.bfloat16), torch.ones(x.shape[:-1], dtype=torch.float32, device=x.device)
    _check_bits(bits, bits)
    xf = x.float()
    scale = absmax_scale(xf.abs().amax(dim=-1, keepdim=True), bits)
    codes = quant_codes(xf, scale, INT4_QMAX if bits == 4 else INT8_QMAX)
    return pack_codes(codes, bits), scale[..., 0]


def cache_bits(buf: torch.Tensor, new_row: torch.Tensor) -> int:
    """A cache side's bit depth from its dtype and width."""
    if buf.dtype != torch.int8:
        return 16
    return 8 if buf.shape[-1] == new_row.shape[-1] else 4


def append_kv(cache: dict, k_new: torch.Tensor, v_new: torch.Tensor) -> dict:
    """Quantize one token's K/V ``[B, Hk, D]`` and write it at each
    sequence's ``length``; returns the cache with ``length + 1``.

    Unlike the JAX function this writes the cache tensors IN PLACE (a copy
    of a long-context cache per token would cost more than the decode
    itself): the returned dict shares them, and only ``length`` is new. A
    write at ``length >= S_max`` lands on row ``S_max - 1``, as JAX's
    ``dynamic_update_slice`` clamps it. Nothing is read back to the host.
    """
    kq, ks = quantize_token(k_new, bits=cache_bits(cache["k"], k_new))
    vq, vs = quantize_token(v_new, bits=cache_bits(cache["v"], v_new))
    length = cache["length"]
    s_max = cache["k"].shape[2]
    pos = length.long().clamp(0, s_max - 1)
    bi = torch.arange(pos.shape[0], device=pos.device)
    cache["k"][bi, :, pos] = kq
    cache["v"][bi, :, pos] = vq
    cache["k_scale"][bi, :, pos] = ks
    cache["v_scale"][bi, :, pos] = vs
    return {**cache, "length": length + 1}


def append_kv_multi(cache: dict, k_new: torch.Tensor, v_new: torch.Tensor) -> dict:
    raise _not_ported("append_kv_multi (speculative verify)", "2d")


# ---------------------------------------------------------------------------
# Kernel D
# ---------------------------------------------------------------------------


def decode_attention_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    k_scale: torch.Tensor,
    v_scale: Optional[torch.Tensor],
    lengths: torch.Tensor,
    *,
    sm_scale: float,
    int_qk: bool,
    out_dtype: torch.dtype,
    window: int = 0,
    sink: int = 0,
    logit_cap: float = 0.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of kernel D on its own inputs: ``q [B,H,D]``,
    contiguous ``k``/``v [B,Hk,S,D]`` (``[B,Hk,S,D/2]`` for a 4-bit side,
    read from its width as ``cache_bits`` does), ``k_scale [B,Hk,S]``,
    ``v_scale`` (quantized V only), ``lengths [B]``; ``window`` (0: none)
    keeps each sequence's keys ``[max(len - window, 0), len) ∪ [0, sink)``;
    ``logit_cap`` (0: none) caps the logits in natural units. One softmax
    over the whole cache in closed form; the kernel and the TPU kernel run
    it online over tiles, so they differ only in summation order. Returns
    ``(o [B,H,D], lse2 [B,H])``.
    """
    b, h, d = q.shape
    hk, s_max = k.shape[1], k.shape[2]
    dev = q.device
    f32 = lambda x: torch.tensor(x, dtype=torch.float32, device=dev)  # noqa: E731
    values = lambda x: _unpack4_cols(x) if cache_bits(x, q) == 4 else x.float()  # noqa: E731
    qg = q.float().reshape(b, hk, h // hk, d)
    kt = values(k).transpose(-1, -2)
    if int_qk:
        qa = absmax_scale(qg.abs().amax(dim=-1, keepdim=True))
        # Integer-valued f32 products: exact while |sum| < 2^24 (127·127·D).
        s = (quant_codes(qg, qa).float() @ kt) * (qa * f32(sm_scale))
    else:
        s = (qg @ kt) * f32(sm_scale)
    s = s * k_scale.float()[:, :, None, :]
    if logit_cap > 0:
        s = f32(logit_cap) * torch.tanh(s / f32(logit_cap))
    s = s * f32(LOG2E)
    pos = torch.arange(s_max, device=dev)[None, :]
    length = lengths.long().clamp(0, s_max)[:, None]
    valid = pos < length
    if window > 0:
        valid = valid & ((pos >= length - window) | (pos < sink))
    s = torch.where(valid[:, None, None, :], s, f32(MASK_VALUE))
    m = s.amax(dim=-1, keepdim=True).clamp_min(NEG_INIT)
    p = torch.exp2(s - m)
    l = p.sum(dim=-1, keepdim=True)
    if v.dtype == torch.int8:
        p = p * v_scale.float()[:, :, None, :]
    # Rows past the length are zeros here, as the kernel never loads them.
    vf = values(v).masked_fill(~valid[:, None, :, None], 0.0)
    empty = l == 0.0
    ls = torch.where(empty, torch.ones_like(l), l)
    o = (p @ vf) / ls
    lse = m + torch.log2(ls)
    return o.to(out_dtype).reshape(b, h, d), lse[..., 0].reshape(b, h)


@functools.lru_cache(maxsize=None)
def _resident_ctas(device_index: int, d: int, k_bits: int, v_bits: int, int_qk: bool, masks: bool = False) -> int:
    """CTAs of this split-pass variant (cache bits 16, 8 or 4 a side; with
    ``masks``, the kernel that takes a window or a cap) the whole card holds
    at once: the kernel's occupancy per SM (a host-side query) times the SM
    count."""
    per_sm = ctypes.c_int(0)
    with torch.cuda.device(device_index):
        err = _build.library().lowbit_decode_ctas_per_sm(
            d, int(k_bits), int(v_bits), int(int_qk), int(masks), ctypes.byref(per_sm)
        )
    _build.check(err, "decode_attention occupancy")
    return max(1, per_sm.value) * torch.cuda.get_device_properties(device_index).multi_processor_count


def num_splits(s_max: int, ctas: int, slots: int) -> Tuple[int, int]:
    """Split-KV plan ``(n_splits, keys per split)`` for ``ctas`` (batch, KV
    head, row group) rows on a card that holds ``slots`` CTAs at once: as
    many splits as fill ``WAVES`` whole waves (every CTA does the same work,
    so a partial last wave costs a whole CTA time), each split a whole
    number of ``KV_TILE`` tiles, at most ``MAX_SPLITS`` splits. It depends
    on the cache size, never on the lengths: reading them would sync the
    decode loop."""
    tiles = cdiv(s_max, KV_TILE)
    want = max(1, min(WAVES * slots // ctas, tiles, MAX_SPLITS))
    per = cdiv(tiles, want)
    return cdiv(tiles, per), per * KV_TILE


def window_keys(window: int, sink: int) -> int:
    """Keys of the compacted walk a windowed call plans its splits over: the
    sink tiles, then ``ceil(window / KV_TILE) + 1`` tiles from the window's
    first tile (the window's rows straddle one more tile), ``KV_TILE`` keys
    each, whatever the cache size (the TPU kernel's ``n_band``)."""
    return (cdiv(sink, KV_TILE) + cdiv(window, KV_TILE) + 1) * KV_TILE


def split_plan(s_max: int, ctas: int, slots: int, window: int = 0, sink: int = 0) -> Tuple[int, int]:
    """The split plan of a call: :func:`num_splits` over the cache's rows,
    or with a window over the compacted walk's keys (:func:`window_keys`),
    which the kernel maps onto each sequence's sink and window rows on the
    device. Never from the lengths: the decode loop must not sync."""
    return num_splits(window_keys(window, sink) if window else s_max, ctas, slots)


def rows_per_cta(group: int) -> int:
    """Query rows a CTA takes: the largest divisor of the GQA group up to
    ``MAX_ROWS`` (a larger group re-reads its KV head once per CTA)."""
    return max(r for r in range(1, min(group, MAX_ROWS) + 1) if group % r == 0)


def kernel_design(k_int8: bool = True, v_int8: bool = True, int_qk: bool = True) -> str:
    """Which design of kernel D runs a mode (``k_int8``/``v_int8``: the side
    holds int8 or packed 4-bit codes): ``"bulk_ring"`` for every cache type
    and QK chain. The choice is static, by mode."""
    if int_qk and not k_int8:
        raise ValueError("the integer QK chain needs an int8 K cache (int8 or packed 4-bit codes)")
    return "bulk_ring"


_TICKETS: dict = {}


def _tickets(device: torch.device, n: int) -> torch.Tensor:
    """Zeroed int32 counters of the splits' merge, one per (batch, KV head,
    row group), kept per device. The kernel leaves them zero, so calls on
    one stream reuse them without a clearing launch."""
    t = _TICKETS.get(device)
    if t is None or t.numel() < n:
        t = torch.zeros(max(n, 1024), dtype=torch.int32, device=device)
        _TICKETS[device] = t
    return t


def _decode_attention_cuda(q, k, v, k_scale, v_scale, lengths, *, sm_scale, int_qk, out_dtype, need_lse, window=0,
                           sink=0, logit_cap=0.0):
    b, h, d = q.shape
    hk, s_max = k.shape[1], k.shape[2]
    if d not in (32, 64, 128):
        raise _not_ported(f"decode head_dim {d} (kernel D takes 32, 64, 128)", "2d")
    if out_dtype not in _OUT_CODES:
        raise TypeError(f"decode output dtype must be f32/bf16/f16, not {out_dtype}")
    if k.dtype not in (torch.int8, torch.bfloat16) or v.dtype not in (torch.int8, torch.bfloat16):
        raise TypeError(f"kernel D takes int8 (codes or packed 4-bit) or bf16 caches, not {k.dtype}/{v.dtype}")
    tensors = [q, k, v, k_scale, lengths] + ([v_scale] if v_scale is not None else [])
    if any(x.device != q.device for x in tensors):
        raise ValueError("decode inputs must all be on one device")
    if not (k.is_contiguous() and v.is_contiguous() and k_scale.is_contiguous()):
        raise ValueError("kernel D takes contiguous caches")
    if v_scale is not None and not v_scale.is_contiguous():
        raise ValueError("kernel D takes a contiguous v_scale")
    if k.data_ptr() % 16 or v.data_ptr() % 16:
        raise ValueError("kernel D needs 16-byte aligned caches")
    if k_scale.dtype != torch.float32 or (v_scale is not None and v_scale.dtype != torch.float32):
        raise TypeError("cache scales must be f32")
    if lengths.dtype != torch.int32 or not lengths.is_contiguous():
        raise TypeError("lengths must be a contiguous int32 tensor")
    rows = rows_per_cta(h // hk)
    row_groups = hk * (h // hk // rows)
    if b > 65535 or row_groups > 65535:
        raise ValueError(f"batch and KV heads x row groups are CUDA grid dims (at most 65535): {b}, {h}")
    # A side's bits from its dtype and width: a 4-bit row is D/2 bytes.
    k_bits, v_bits = cache_bits(k, q), cache_bits(v, q)
    design = kernel_design(k_bits != 16, v_bits != 16, int_qk)
    slots = _resident_ctas(q.device.index or 0, d, k_bits, v_bits, int_qk, bool(window or logit_cap))
    n_splits, chunk = split_plan(s_max, b * row_groups, slots, window, sink)
    # bf16 queries go in as they are; others as f32.
    qk = q.contiguous() if q.dtype in (torch.float32, torch.bfloat16) else q.float().contiguous()
    part_acc = torch.empty((b, h, n_splits * WARPS, d), dtype=torch.float32, device=q.device)
    part_ml = torch.empty((b, h, n_splits * WARPS, 2), dtype=torch.float32, device=q.device)
    o = torch.empty((b, h, d), dtype=out_dtype, device=q.device)
    lse = torch.empty((b, h), dtype=torch.float32, device=q.device) if need_lse else None
    tickets = _tickets(q.device, b * row_groups)
    lib = _build.library()
    with torch.cuda.device(q.device):
        err = lib.lowbit_decode_attn(
            qk.data_ptr(), k.data_ptr(), v.data_ptr(), k_scale.data_ptr(),
            v_scale.data_ptr() if v_scale is not None else None, lengths.data_ptr(),
            part_acc.data_ptr(), part_ml.data_ptr(), tickets.data_ptr(), o.data_ptr(),
            lse.data_ptr() if lse is not None else None,
            b, h, hk, s_max, d, rows, k_bits, v_bits, int(int_qk), int(qk.dtype == torch.bfloat16),
            _OUT_CODES[out_dtype], n_splits, chunk, window, sink, float(sm_scale), float(logit_cap),
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    _build.check(err, "decode_attention")
    decode_attention.launches += 1
    decode_attention.launches_by_design[design] += 1
    return o, lse


def decode_attention(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    k_scale: torch.Tensor,
    lengths: torch.Tensor,
    *,
    v_scale: Optional[torch.Tensor] = None,
    page_table: Optional[torch.Tensor] = None,
    sm_scale: Optional[float] = None,
    logit_cap: float = 0.0,
    kv_bits: int = 8,
    k_bits: Optional[int] = None,
    v_bits: Optional[int] = None,
    window_size: Optional[int] = None,
    sink_size: int = 0,
    return_lse: bool = False,
    compute_mode: str = "auto",
):
    """Single-token decode attention over a contiguous int8, 4-bit or bf16
    KV cache (GQA/MQA): ``q [B, H, D]`` float, ``k_cache``/``v_cache
    [B, Hk, S, D]`` (``[B, Hk, S, D/2]`` for a side of 4 bits: ``kv_bits=4``,
    or ``k_bits=4, v_bits=8`` for k4v8), ``k_scale``/``v_scale [B, Hk, S]``,
    ``lengths [B]`` int32 on q's device. Query head ``h`` reads KV head
    ``h // (H / Hk)``. ``sm_scale`` defaults to ``1/sqrt(D)``.
    ``compute_mode`` "auto" takes the integer QK chain for 8-bit K and the
    float chain otherwise; "int_qk" takes the integer chain for 4-bit K too.

    ``window_size`` W attends each sequence's last W rows (itself
    included) and, under a window, its first ``sink_size`` rows too;
    ``logit_cap`` c caps the logits as ``c·tanh(s / c)``.

    Returns ``o [B, H, D]`` in ``q.dtype`` and, with ``return_lse``, the
    base-2 LSE ``[B, H]``. Lengths past ``S`` count as ``S``. The TPU
    function's tiling knobs (``block_kv``, ``heads_per_step``,
    ``compact_window``, ``clamp_walk``, ``fast_interior``, ``interpret``) are
    not ported.
    """
    if page_table is not None:
        raise _not_ported("the paged KV cache (page_table)", "5")
    if q.dim() == 4:
        raise _not_ported("multi-token decode q [B, T, H, D] (speculative verify)", "2d")
    if compute_mode == "int":
        raise _not_ported("compute_mode='int' (INT8 PV)", "2e")
    if compute_mode not in ("auto", "int_qk", "f32"):
        raise ValueError(f"unknown compute_mode {compute_mode!r}")
    k_bits = kv_bits if k_bits is None else k_bits
    v_bits = kv_bits if v_bits is None else v_bits
    _check_bits(k_bits, v_bits)
    if q.dim() != 3 or k_cache.dim() != 4:
        raise ValueError(f"q must be [B, H, D] and the caches [B, Hk, S, D]: {tuple(q.shape)}, {tuple(k_cache.shape)}")
    b, h, d = q.shape
    _, hk, s_max, _ = k_cache.shape
    width = lambda bits: d // 2 if bits == 4 else d  # noqa: E731
    if tuple(k_cache.shape) != (b, hk, s_max, width(k_bits)) or tuple(v_cache.shape) != (b, hk, s_max, width(v_bits)):
        raise ValueError(f"caches must be [B, Hk, S, D] (D/2 at 4 bits) with D={d}, k_bits={k_bits}, "
                         f"v_bits={v_bits}: {tuple(k_cache.shape)}, {tuple(v_cache.shape)}")
    for side, cache, bits in (("k", k_cache, k_bits), ("v", v_cache, v_bits)):
        if (cache.dtype == torch.int8) != (bits != 16):
            raise TypeError(f"a {bits}-bit {side} cache holds {'bf16 rows' if bits == 16 else 'int8 bytes'}, "
                            f"not {cache.dtype}")
    if hk == 0 or h % hk:
        raise ValueError(f"query heads {h} not a multiple of kv heads {hk}")
    if tuple(k_scale.shape) != (b, hk, s_max):
        raise ValueError(f"k_scale must be [B, Hk, S], got {tuple(k_scale.shape)}")
    v_quantized = v_cache.dtype == torch.int8
    if v_quantized and (v_scale is None or tuple(v_scale.shape) != (b, hk, s_max)):
        raise ValueError("a quantized V cache needs v_scale [B, Hk, S]")
    if tuple(lengths.shape) != (b,):
        raise ValueError(f"lengths must be [B], got {tuple(lengths.shape)}")
    int_qk = k_cache.dtype == torch.int8 and (compute_mode == "int_qk" or (compute_mode == "auto" and k_bits == 8))
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    window = int(window_size) if window_size else 0
    if window < 0 or sink_size < 0 or logit_cap < 0:
        raise ValueError(f"window_size, sink_size and logit_cap must be >= 0: {window_size}, {sink_size}, {logit_cap}")
    # A window as long as the cache hides no row (lengths count at most S).
    window = window if window < s_max else 0
    masks = dict(window=window, sink=int(sink_size) if window else 0, logit_cap=float(logit_cap))

    args = (q, k_cache, v_cache, k_scale, v_scale if v_quantized else None, lengths)
    if q.device.type == "cpu":
        o, lse = decode_attention_plain(*args, sm_scale=sm_scale, int_qk=int_qk, out_dtype=q.dtype, **masks)
    elif q.device.type == "cuda":
        o, lse = _decode_attention_cuda(
            *args, sm_scale=sm_scale, int_qk=int_qk, out_dtype=q.dtype, need_lse=return_lse, **masks
        )
    else:
        raise ValueError(f"decode_attention runs on cpu or cuda tensors, not {q.device}")
    return (o, lse) if return_lse else o


#: Launches of kernel D in this process (one per call), in all and per
#: design. CPU calls do not count.
decode_attention.launches = 0
decode_attention.launches_by_design = {design: 0 for design in DESIGNS}
