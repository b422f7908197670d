"""Decode attention over the quantized KV cache (kernel D), one query token a
sequence or T of them (the speculative verify step), and the cache ops.

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
in f32, or with ``compute_mode="int"`` on an int8 V as an integer product);
nothing falls back. T query tokens ``q [B, T, H, D]`` and INT8 PV run the
kernel's multi-token instances (``csrc/decode_attention_multi.cu`` at head
dims 32, 64 and 128, ``csrc/decode_attention_multi_d256.cu`` at 256,
``csrc/decode_attention_multi_d80_96.cu`` at 80 and 96,
``csrc/decode_attention_multi_dyn.cu`` at the other multiples of 16 up to
256); one token without INT8 PV runs the single-token ones
(``csrc/decode_attention.cu`` at head dims 32, 64 and 128,
``csrc/decode_attention_d256.cu`` at 256, ``csrc/decode_attention_d80_96.cu``
at 80 and 96: Phi-2's and Phi-3-mini's head dims, whose rows the kernel keeps
at the cache's own width; ``csrc/decode_attention_dyn.cu`` at every other
multiple of 16 from 16 to 256, e.g. MPT-30B's 112 and Nemotron-4's 192,
instances that take the head dim at run time, laid out for 128 or for 256;
``csrc/decode_attention_dyn512.cu`` and its ``_multi``/``_paged`` twins at
every multiple of 16 from 272 to 512, laid out for 512). Head dims that are
not multiples of 16, and those above 512, raise.

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

The paged cache (``page_table``, the serving engine's pool): ``k``/``v``
``[Hk, n_pages, page, Dc]``, scales ``[Hk, n_pages, page]``, ``page_table
[B, W]`` int32; row ``r`` of sequence ``b`` lives at page ``page_table[b, r //
page]``, offset ``r % page``, so a sequence holds at most ``W·page`` rows.
Every mode above runs paged. On the card the paged calls take the
multi-token instances' paged twins (``csrc/decode_attention_paged.cu``,
``csrc/decode_attention_paged_d256.cu``), one token as T = 1: the producer
forms each tile from one pair of bulk copies per page the tile touches,
reading the table on the device; the tiles, the consumers, the split plan
and the merge are the contiguous kernels'. Only the pages of rows the walk
visits are read, by the kernel and by the plain version alike: a table
entry past a sequence's used pages, or below its window, may name a page
that another sequence owns.

T query tokens (``q [B, T, H, D]``, ``lengths`` counting all T new rows):
token ``t`` sees ``pos < limit_t = length - (T - 1 - t)``, and under a
window its band ``[limit_t - W, limit_t)`` plus the sinks. The kernel takes
the query rows of one KV head token-major (row ``t·g + gh``, the TPU
kernel's layout), so all T tokens stream the cache once.

INT8 PV (``compute_mode="int"``, int8 V only; as in JAX it also puts a 4-bit
K on the integer QK chain): per tile of the kernel's walk and per query row,
after ``l`` has summed P and the V scale is folded in, ``pa = fma(max p,
1/127, 1e-7)``, ``p8 = trunc(p / pa + 0.5)`` and ``acc = acc·alpha + (p8 ·
V codes)·pa``. The result depends on the tiles (the TPU function says so),
so the plain version walks the kernel's tiles (:func:`walk_tiles`).
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
from lowbit_quant_fa2_paddle_tpu_torch.utils import tuning

#: Keys a split of kernel D is a whole multiple of (its tiles hold 64, 32
#: or 16 keys: ``BK`` in csrc/decode_attention.cu).
KV_TILE = 64
#: Query rows (heads of one KV group) per CTA of kernel D, at most.
MAX_ROWS = 8
#: Waves of resident CTAs the split-KV pass aims for, unless the tuning
#: cache holds ``waves`` for the call (:func:`tuned_waves`).
WAVES = 1
#: Splits of one row group, at most (the merging CTA keeps a weight per
#: split and warp in shared memory).
MAX_SPLITS = 64
#: Consumer warps per CTA of kernel D; each leaves one partial state per split.
WARPS = 4
#: Designs of kernel D: one, for every mode (int8/4-bit/bf16 K and V, both
#: QK chains, every head dim of :data:`CARD_HEAD_DIMS`, one or T query
#: tokens, f32 or INT8 PV).
DESIGNS = ("bulk_ring",)
#: The head dims with instances of their own: the power-of-two ladder, and
#: 80 and 96 (the ``_d80_96`` sources).
HEAD_DIMS = (32, 64, 80, 96, 128, 256)
#: Every head dim kernel D takes on the card: the multiples of 16 from 16 to
#: 512. Those outside :data:`HEAD_DIMS` run the instances that take the head
#: dim at run time (the ``_dyn`` sources, laid out for 128 or for 256; the
#: ``_dyn512`` ones, laid out for 512).
CARD_HEAD_DIMS = tuple(range(16, 513, 16))

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
    """Quantize T tokens' K/V ``[B, Hk, T, D]`` and write them at each
    sequence's ``length``; returns the cache with ``length + T``. The codes
    and scales are those of T single appends (per-token scales do not depend
    on the position).

    In place, as :func:`append_kv`. JAX's ``dynamic_update_slice`` clamps the
    START of the T rows to ``[0, S_max - T]``, so near the end all T rows
    shift back together (``append_kv`` clamps its one row to ``S_max - 1``);
    so does this. Nothing is read back to the host."""
    t = k_new.shape[2]
    kq, ks = quantize_token(k_new, bits=cache_bits(cache["k"], k_new))
    vq, vs = quantize_token(v_new, bits=cache_bits(cache["v"], v_new))
    length = cache["length"]
    s_max = cache["k"].shape[2]
    if t > s_max:
        raise ValueError(f"{t} new rows do not fit a cache of {s_max}")
    pos = length.long().clamp(0, s_max - t)[:, None] + torch.arange(t, device=length.device)  # [B, T]
    bi = torch.arange(pos.shape[0], device=pos.device)[:, None]
    cache["k"][bi, :, pos] = kq.transpose(1, 2)
    cache["v"][bi, :, pos] = vq.transpose(1, 2)
    cache["k_scale"][bi, :, pos] = ks.transpose(1, 2)
    cache["v_scale"][bi, :, pos] = vs.transpose(1, 2)
    return {**cache, "length": length + t}


# ---------------------------------------------------------------------------
# Kernel D
# ---------------------------------------------------------------------------


def instance_dim(d: int) -> int:
    """The head dim the instance that runs head dim ``d`` is laid out for:
    ``d`` itself in :data:`HEAD_DIMS`, else 128 (``d <= 128``), 256 or 512
    (the instances that take the head dim at run time)."""
    return d if d in HEAD_DIMS else 128 if d <= 128 else 256 if d <= 256 else 512


def tile_keys(d: int, k_bits: int, v_bits: int) -> int:
    """Keys of one tile of kernel D's walk at head dim ``d`` (``Cfg::BK`` in
    csrc/decode_attention.cuh, of the instance :func:`instance_dim` names):
    64 while 64 rows of K and V fit 16 KB, else 32, else 16."""
    w = instance_dim(d)
    row = sum(w // 2 if bits == 4 else w * (2 if bits == 16 else 1) for bits in (k_bits, v_bits))
    return 64 if 64 * row <= 16384 else 32 if 32 * row <= 16384 else 16


def _entry(lib, name: str, d: int):
    """The C entry of kernel D's instances at head dim ``d``: ``name`` for
    d32-d128, its ``_d256`` or ``_d80_96`` twin in their own sources, its
    ``_dyn`` twin (the head dim at run time) at the other multiples of 16 up
    to 256, its ``_dyn512`` twin above."""
    suffix = ("" if d in (32, 64, 128) else "_d256" if d == 256 else "_d80_96" if d in (80, 96)
              else "_dyn" if d < 256 else "_dyn512")
    return getattr(lib, name + suffix)


def check_head_dim(d: int) -> None:
    """Raises, naming its ROADMAP item, for a head dim kernel D does not take
    on the card: above 512 ("3h": 16 f32 PV columns a lane for 8 rows are
    already 128 of a thread's 255 registers, and the widest rows' 16-key
    tiles 32 KB a stage), or not a multiple of 16 ("3")."""
    if d > 512:
        raise _not_ported(f"decode head_dim {d} > 512 on the GPU", "3h")
    if d not in CARD_HEAD_DIMS:
        raise _not_ported(f"decode head_dim {d} (kernel D takes the multiples of 16 from 16 to 512)", "3")


def walk_tiles(length: int, s_max: int, *, tile: int, window: int = 0, sink: int = 0, q_tokens: int = 1,
               split_keys: Optional[int] = None, warps: int = 1) -> list:
    """The tiles kernel D walks for one sequence, as ``(first key, end,
    part)`` in the order each part visits them: the walk's logical keys
    (the cache's rows, or with a window :func:`window_keys` of the union
    band ``W + T - 1``) cut into splits of ``split_keys`` (None: one split),
    each split's sink-phase rows ``[start, min(sink, length))`` and
    window-phase rows (from the first visible row, not from an aligned
    tile) in tiles of ``tile`` keys, tile ``j`` of a split going to part
    ``split·warps + j % warps`` (its consumer warp). Reads ``length`` on the
    host: the plain version's walk, not the kernel's."""
    w = window + q_tokens - 1 if window else 0
    keys = window_keys(w, sink) if w else s_max
    chunk = split_keys or cdiv(keys, KV_TILE) * KV_TILE
    length = min(max(length, 0), s_max)
    tiles = []
    for split in range(cdiv(keys, chunk)):
        start = split * chunk
        ranges = [(start, min(start + chunk, length))]
        if w:
            sink_keys = cdiv(sink, KV_TILE) * KV_TILE
            lo_w = max(length - w, sink)
            ws = lo_w // KV_TILE * KV_TILE
            ranges = [(start, min(start + chunk, sink_keys, sink, length)),
                      (max(ws + max(start - sink_keys, 0), lo_w), min(ws + start + chunk - sink_keys, length))]
        j = 0
        for lo, hi in ranges:
            for k0 in range(lo, hi, tile):
                tiles.append((k0, min(k0 + tile, hi), split * warps + j % warps))
                j += 1
    return tiles


def _pv8_attention(s, m, vf, v_scale, lengths, *, tile, window, sink, q_tokens, split_keys, warps):
    """INT8 PV over kernel D's tiles for logits ``s [B, Hk, R, S]`` (base 2,
    masked) with row maxima ``m``: returns ``(o·l [B, Hk, R, D], l)``. Each
    part (split, warp) keeps its running maximum over its tiles in order
    (a cumulative maximum), so a tile's P is ``exp2(s - m_tile)`` as the
    kernel forms it; its codes and ``pa`` follow; the tiles' sums are
    weighted by ``exp2(m_tile - m)``, which is what the kernel's alphas and
    split merge multiply out to."""
    b, hk, rows, s_max = s.shape
    dev = s.device
    nums, ls = [], []
    for i, length in enumerate(lengths.tolist()):
        tiles = walk_tiles(length, s_max, tile=tile, window=window, sink=sink, q_tokens=q_tokens,
                           split_keys=split_keys, warps=warps)
        n = len(tiles)
        tile_of = torch.full((s_max,), n, dtype=torch.long)  # n: a key no tile holds
        by_part: dict = {}
        for j, (k0, k1, part) in enumerate(tiles):
            tile_of[k0:k1] = j
            by_part.setdefault(part, []).append(j)
        tile_of = tile_of.to(dev).expand(hk, rows, s_max)
        longest = max((len(js) for js in by_part.values()), default=0)
        seq = torch.tensor([js + [n] * (longest - len(js)) for js in by_part.values()] or [[n]], device=dev)
        si = s[i]
        t_max = torch.full((hk, rows, n + 1), MASK_VALUE, device=dev).scatter_reduce(-1, tile_of, si, "amax")
        m_tile = torch.full((hk, rows, n + 1), NEG_INIT, device=dev)
        m_tile[..., seq] = torch.cummax(t_max[..., seq], dim=-1).values.clamp_min(NEG_INIT)
        m_tile[..., n] = NEG_INIT
        m_key = torch.gather(m_tile, -1, tile_of)
        p = torch.exp2(si - m_key)
        c = torch.exp2(m_key - m[i])
        ls.append((p * c).sum(dim=-1, keepdim=True))
        pv = p * v_scale[i].float()[:, None, :]  # the V scale folded in after l
        p_max = torch.zeros((hk, rows, n + 1), device=dev).scatter_reduce(-1, tile_of, pv, "amax")
        pa = torch.gather(absmax_scale(p_max), -1, tile_of)
        p8 = torch.floor(pv / pa + 0.5)  # p >= 0: trunc(p / pa + 0.5)
        nums.append((p8 * torch.where(p8 > 0, pa * c, 0.0)) @ vf[i])
    return torch.stack(nums), torch.stack(ls)


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
    int_pv: bool = False,
    split_keys: Optional[int] = None,
    warps: int = 1,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of kernel D on its own inputs: ``q [B,H,D]`` or
    ``[B,T,H,D]`` (token ``t`` sees ``pos < length - (T-1-t)``), contiguous
    ``k``/``v [B,Hk,S,D]`` (``[B,Hk,S,D/2]`` for a 4-bit side, read from its
    width as ``cache_bits`` does), ``k_scale [B,Hk,S]``, ``v_scale``
    (quantized V only), ``lengths [B]``; ``window`` (0: none) keeps each
    token's keys ``[max(limit - window, 0), limit) ∪ [0, sink)``;
    ``logit_cap`` (0: none) caps the logits in natural units. Without
    ``int_pv`` one softmax over the whole cache in closed form; the kernel
    and the TPU kernel run it online over tiles, so they differ only in
    summation order. With ``int_pv`` (an int8 V) P is requantized per tile
    of kernel D's walk: ``split_keys`` and ``warps`` give the kernel's
    partition (on the card: :func:`kernel_partition`; the CPU default, one
    split and one warp, walks the tiles in order as the TPU kernel walks its
    blocks). Returns ``(o [B,(T,)H,D], lse2 [B,(T,)H])``.
    """
    single = q.dim() == 3
    q4 = q[:, None] if single else q
    b, t, h, d = q4.shape
    hk, s_max = k.shape[1], k.shape[2]
    g = h // hk
    rows = t * g
    dev = q.device
    f32 = lambda x: torch.tensor(x, dtype=torch.float32, device=dev)  # noqa: E731
    values = lambda x: _unpack4_cols(x) if cache_bits(x, q) == 4 else x.float()  # noqa: E731
    # Rows of one KV head token-major (row t·g + gh), as the kernels take them.
    qg = q4.float().reshape(b, t, hk, g, d).transpose(1, 2).reshape(b, hk, rows, d)
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
    pos = torch.arange(s_max, device=dev)
    limit = lengths.long().clamp(0, s_max)[:, None, None] - (t - 1) + (torch.arange(rows, device=dev) // g)[:, None]
    valid = pos < limit  # [B, rows, S]
    if window > 0:
        valid = valid & ((pos >= limit - window) | (pos < sink))
    s = torch.where(valid[:, None], s, f32(MASK_VALUE))
    m = s.amax(dim=-1, keepdim=True).clamp_min(NEG_INIT)
    # Rows no token sees are zeros here, as the kernel never loads them.
    vf = values(v).masked_fill(~valid.any(dim=1)[:, None, :, None], 0.0)
    if int_pv:
        if v.dtype != torch.int8 or cache_bits(v, q) != 8:
            raise ValueError("INT8 PV takes an int8 V cache")
        o, l = _pv8_attention(s, m, vf, v_scale, lengths, tile=tile_keys(d, cache_bits(k, q), 8), window=window,
                              sink=sink, q_tokens=t, split_keys=split_keys, warps=warps)
    else:
        p = torch.exp2(s - m)
        l = p.sum(dim=-1, keepdim=True)
        if v.dtype == torch.int8:
            p = p * v_scale.float()[:, :, None, :]
        # A product per token (its g rows): the matmul's summation order
        # may depend on its row count, and each token then gets the bits of
        # the single-token call at its own length.
        o = torch.cat([p[:, :, i * g:(i + 1) * g] @ vf for i in range(t)], dim=2)
    empty = l == 0.0
    ls = torch.where(empty, torch.ones_like(l), l)
    o = (o / ls).to(out_dtype).reshape(b, hk, t, g, d).transpose(1, 2).reshape(b, t, h, d)
    lse = (m + torch.log2(ls))[..., 0].reshape(b, hk, t, g).transpose(1, 2).reshape(b, t, h)
    return (o[:, 0], lse[:, 0]) if single else (o, lse)


def walk_rows(length: int, rows: int, *, window: int = 0, sink: int = 0, q_tokens: int = 1) -> list:
    """The row ranges ``[lo, hi)`` of one sequence that kernel D's walk
    visits, of a cache of ``rows`` rows: ``[0, length)``, or under a window
    the sinks ``[0, min(sink, length))`` and the union band from the first
    token's window start (``length - (T - 1) - window``) to ``length``."""
    length = min(max(int(length), 0), rows)
    if not window:
        return [(0, length)]
    lo = max(length - (q_tokens - 1) - window, 0)
    return [(0, min(sink, length)), (lo, length)]


def gather_pages(k, v, k_scale, v_scale, lengths, page_table, *, window: int = 0, sink: int = 0,
                 q_tokens: int = 1):
    """A paged cache ``[Hk, n_pages, page, Dc]`` as the contiguous cache
    ``[B, Hk, W·page, Dc]`` of the rows kernel D's walk visits
    (:func:`walk_rows`, whole pages): only the table entries of those pages
    are read, every other row is zero (codes and scales alike). Reads the
    lengths and the table on the host: the plain version's gather."""
    hk, _, page, _ = k.shape
    b, width = page_table.shape
    rows = width * page

    def empty(x):
        return torch.zeros((b, hk, rows) + tuple(x.shape[3:]), dtype=x.dtype, device=x.device)

    out = [empty(x) if x is not None else None for x in (k, v, k_scale, v_scale)]
    table = page_table.cpu()
    for i, length in enumerate(lengths.tolist()):
        logical = sorted({p for lo, hi in walk_rows(length, rows, window=window, sink=sink, q_tokens=q_tokens)
                          if hi > lo for p in range(lo // page, cdiv(hi, page))})
        if not logical:
            continue
        src = table[i, logical].long().to(k.device)
        dst = (torch.tensor(logical, device=k.device)[:, None] * page + torch.arange(page, device=k.device)).reshape(-1)
        for o, x in zip(out, (k, v, k_scale, v_scale)):
            if x is not None:
                o[i][:, dst] = x[:, src].reshape((hk, -1) + tuple(x.shape[3:]))
    return out


def decode_attention_paged_plain(q, k, v, k_scale, v_scale, lengths, page_table, *, window: int = 0, sink: int = 0,
                                 **kw) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`decode_attention_plain` over a paged cache: the visited pages
    gathered into a contiguous cache of ``W·page`` rows a sequence
    (:func:`gather_pages`), whose walk, splits included, is the kernel's."""
    t = q.shape[1] if q.dim() == 4 else 1
    kc, vc, ksc, vsc = gather_pages(k, v, k_scale, v_scale, lengths, page_table, window=window, sink=sink,
                                    q_tokens=t)
    return decode_attention_plain(q, kc, vc, ksc, vsc, lengths, window=window, sink=sink, **kw)


@functools.lru_cache(maxsize=None)
def _resident_ctas(device_index: int, d: int, k_bits: int, v_bits: int, int_qk: bool, masks: bool = False,
                   multi: int = 0, paged: bool = False) -> int:
    """CTAs of this split-pass variant (cache bits 16, 8 or 4 a side; with
    ``masks``, the kernel that takes a window or a cap; ``multi`` 1 the
    multi-token kernel, 2 the multi-token kernel with INT8 PV; ``paged``
    their paged twins) the whole card holds at once: the kernel's occupancy
    per SM (a host-side query) times the SM count."""
    per_sm = ctypes.c_int(0)
    lib = _build.library()
    with torch.cuda.device(device_index):
        if paged:
            err = _entry(lib, "lowbit_decode_paged_ctas_per_sm", d)(d, int(k_bits), int(v_bits), int(int_qk),
                                                                    int(multi == 2), ctypes.byref(per_sm))
        elif multi:
            err = _entry(lib, "lowbit_decode_multi_ctas_per_sm", d)(d, int(k_bits), int(v_bits), int(int_qk),
                                                                    int(multi == 2), ctypes.byref(per_sm))
        else:
            err = _entry(lib, "lowbit_decode_ctas_per_sm", d)(d, int(k_bits), int(v_bits), int(int_qk), int(masks),
                                                              ctypes.byref(per_sm))
    _build.check(err, "decode_attention occupancy")
    return max(1, per_sm.value) * torch.cuda.get_device_properties(device_index).multi_processor_count


def num_splits(s_max: int, ctas: int, slots: int, waves: float = WAVES) -> Tuple[int, int]:
    """Split-KV plan ``(n_splits, keys per split)`` for ``ctas`` (batch, KV
    head, row group) rows on a card that holds ``slots`` CTAs at once: as
    many splits as fill ``waves`` waves (every CTA does the same work, so a
    partial last wave costs a whole CTA time; 0.5 fills half of one), each
    split a whole number of ``KV_TILE`` tiles, at most ``MAX_SPLITS``
    splits. It depends on the cache size, never on the lengths: reading
    them would sync the decode loop."""
    tiles = cdiv(s_max, KV_TILE)
    want = max(1, min(int(waves * slots) // ctas, tiles, MAX_SPLITS))
    per = cdiv(tiles, want)
    return cdiv(tiles, per), per * KV_TILE


def window_keys(window: int, sink: int) -> int:
    """Keys of the compacted walk a windowed call plans its splits over: the
    sink tiles, then ``ceil(window / KV_TILE) + 1`` tiles from the window's
    first tile (the window's rows straddle one more tile), ``KV_TILE`` keys
    each, whatever the cache size (the TPU kernel's ``n_band``)."""
    return (cdiv(sink, KV_TILE) + cdiv(window, KV_TILE) + 1) * KV_TILE


def split_plan(s_max: int, ctas: int, slots: int, window: int = 0, sink: int = 0,
               waves: float = WAVES) -> Tuple[int, int]:
    """The split plan of a call: :func:`num_splits` over the cache's rows,
    or with a window over the compacted walk's keys (:func:`window_keys`),
    which the kernel maps onto each sequence's sink and window rows on the
    device. Never from the lengths: the decode loop must not sync."""
    return num_splits(window_keys(window, sink) if window else s_max, ctas, slots, waves)


def tuned_waves(k_bits: int, v_bits: int, d: int, s_max: int, device=None) -> Optional[float]:
    """The ``waves`` of the tuning cache's ``decode_k{k_bits}v{v_bits}``
    entry at head dim ``d`` and ``pow2_bucket(s_max)`` for ``device``'s
    kind (``utils/tuning.py``; the bits are the cache's own, 16 for bf16),
    or None: no entry, or one without a positive number of waves."""
    ent = tuning.lookup_entry(f"decode_k{k_bits}v{v_bits}", d, tuning.pow2_bucket(s_max), False,
                              device=tuning.device_kind(device))
    waves = ent.get("waves") if ent else None
    if isinstance(waves, (int, float)) and not isinstance(waves, bool) and 0 < waves < math.inf:
        return float(waves)
    return None


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


def kernel_partition(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, int_qk: bool, int_pv: bool = False,
                     window: int = 0, sink: int = 0, logit_cap: float = 0.0,
                     page_table: Optional[torch.Tensor] = None, waves: Optional[float] = None,
                     slots: Optional[int] = None) -> dict:
    """How kernel D cuts a call on the card: the variant (``multi`` 0 for
    the single-token kernels, 1 for T tokens, 2 with INT8 PV; ``paged``
    the paged twins of 1 and 2, which take one token as T = 1), rows a CTA
    (``rows``), the grid's row groups, the split plan (``n_splits``,
    ``split_keys``, over ``waves`` waves) and the warps a split's tiles go
    to; the last two are what :func:`decode_attention_plain` takes to walk
    the same tiles. T tokens plan their window splits over the union band
    ``W + T - 1``; a paged cache over its ``W·page`` logical rows a
    sequence. ``waves`` None takes the tuning cache's entry for a
    contiguous, unwindowed call (:func:`tuned_waves`, keyed by ``q``'s
    device), else :data:`WAVES`. ``slots`` (the CTAs the card holds at
    once) is queried from the card unless given."""
    t = q.shape[1] if q.dim() == 4 else 1
    b, h, d = q.shape[0], q.shape[-2], q.shape[-1]
    paged = page_table is not None
    if paged:
        hk, s_max = k.shape[0], page_table.shape[1] * k.shape[2]
    else:
        hk, s_max = k.shape[1], k.shape[2]
    multi = 2 if int_pv else 1 if t > 1 or paged else 0
    rows = rows_per_cta(t * (h // hk))
    row_groups = hk * (t * (h // hk) // rows)
    walk = window + t - 1 if window else 0
    k_bits, v_bits = cache_bits(k, q), cache_bits(v, q)
    if slots is None:
        slots = _resident_ctas(q.device.index or 0, d, k_bits, v_bits, int_qk, bool(window or logit_cap), multi,
                               paged)
    if waves is None:
        waves = (None if window or paged else tuned_waves(k_bits, v_bits, d, s_max, q.device)) or WAVES
    n_splits, chunk = split_plan(s_max, b * row_groups, slots, walk, sink, waves)
    return dict(multi=multi, paged=paged, rows=rows, row_groups=row_groups, n_splits=n_splits, split_keys=chunk,
                warps=WARPS, walk_window=walk, waves=waves)


def launch_variant(multi: int, t: int, k_bits: int, v_bits: int, b: int, paged: bool = False) -> str:
    """The key of :attr:`decode_attention.launches_by_variant` for a launch:
    the kernel instance (``multi`` and ``paged`` of
    :func:`kernel_partition`), the tokens T, each side's bits and the
    batch."""
    kind = ("single-token", "T-token", "T-token INT8 PV")[multi]
    return f"{'paged ' if paged else ''}{kind} T{t} k{k_bits}v{v_bits} b{b}"


def _decode_attention_cuda(q, k, v, k_scale, v_scale, lengths, *, sm_scale, int_qk, out_dtype, need_lse, window=0,
                           sink=0, logit_cap=0.0, int_pv=False, page_table=None, waves=None):
    single = q.dim() == 3
    b, t, h, d = (q.shape[0], 1, *q.shape[1:]) if single else q.shape
    paged = page_table is not None
    if paged:
        hk, n_pages, page = k.shape[:3]
        s_max = page_table.shape[1] * page
    else:
        hk, s_max = k.shape[1], k.shape[2]
    check_head_dim(d)
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
    if paged and (page_table.dtype != torch.int32 or not page_table.is_contiguous()
                  or page_table.device != q.device):
        raise TypeError("page_table must be a contiguous int32 tensor on q's device")
    plan = kernel_partition(q, k, v, int_qk=int_qk, int_pv=int_pv, window=window, sink=sink, logit_cap=logit_cap,
                            page_table=page_table, waves=waves)
    rows, row_groups, n_splits = plan["rows"], plan["row_groups"], plan["n_splits"]
    if b > 65535 or row_groups > 65535:
        raise ValueError(f"batch and KV heads x row groups are CUDA grid dims (at most 65535): {b}, {t * h}")
    # A side's bits from its dtype and width: a 4-bit row is D/2 bytes.
    k_bits, v_bits = cache_bits(k, q), cache_bits(v, q)
    design = kernel_design(k_bits != 16, v_bits != 16, int_qk)
    # bf16 queries go in as they are; others as f32. T tokens go in as the
    # kernel's rows: KV head by KV head, token-major ([B, Hk·T·g, D]).
    qk = q if q.dtype in (torch.float32, torch.bfloat16) else q.float()
    h_rows = t * h
    if not single:
        qk = qk.reshape(b, t, hk, h // hk, d).transpose(1, 2).reshape(b, h_rows, d)
    qk = qk.contiguous()
    part_acc = torch.empty((b, h_rows, n_splits * WARPS, d), dtype=torch.float32, device=q.device)
    part_ml = torch.empty((b, h_rows, n_splits * WARPS, 2), dtype=torch.float32, device=q.device)
    o = torch.empty((b, h_rows, d), dtype=out_dtype, device=q.device)
    lse = torch.empty((b, h_rows), dtype=torch.float32, device=q.device) if need_lse else None
    tickets = _tickets(q.device, b * row_groups)
    lib = _build.library()
    common = (qk.data_ptr(), k.data_ptr(), v.data_ptr(), k_scale.data_ptr(),
              v_scale.data_ptr() if v_scale is not None else None, lengths.data_ptr(),
              part_acc.data_ptr(), part_ml.data_ptr(), tickets.data_ptr(), o.data_ptr(),
              lse.data_ptr() if lse is not None else None,
              b, h_rows, hk, s_max, d, rows, k_bits, v_bits, int(int_qk), int(qk.dtype == torch.bfloat16),
              _OUT_CODES[out_dtype], n_splits, plan["split_keys"])
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        if paged:
            err = _entry(lib, "lowbit_decode_attn_paged", d)(
                *common, plan["walk_window"], sink, t, int(int_pv), page_table.data_ptr(), n_pages, page,
                page_table.shape[1], float(sm_scale), float(logit_cap), stream)
        elif plan["multi"]:
            err = _entry(lib, "lowbit_decode_attn_multi", d)(*common, plan["walk_window"], sink, t, int(int_pv),
                                                             float(sm_scale), float(logit_cap), stream)
        else:
            err = _entry(lib, "lowbit_decode_attn", d)(*common, window, sink, float(sm_scale), float(logit_cap),
                                                       stream)
    _build.check(err, "decode_attention")
    decode_attention.launches += 1
    decode_attention.launches_by_design[design] += 1
    variant = launch_variant(plan["multi"], t, k_bits, v_bits, b, paged)
    decode_attention.launches_by_variant[variant] = decode_attention.launches_by_variant.get(variant, 0) + 1
    decode_attention.launches_by_dim[d] += 1
    decode_attention.launches_by_splits[n_splits] = decode_attention.launches_by_splits.get(n_splits, 0) + 1
    if single:
        return o, lse
    o = o.reshape(b, hk, t, h // hk, d).transpose(1, 2).reshape(b, t, h, d)
    if lse is not None:
        lse = lse.reshape(b, hk, t, h // hk).transpose(1, 2).reshape(b, t, h)
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
    waves: Optional[float] = None,
):
    """Decode attention over a contiguous or paged int8, 4-bit or bf16 KV
    cache (GQA/MQA): ``q [B, H, D]`` float, or ``[B, T, H, D]`` for T query tokens
    (the speculative verify step: ``lengths`` counts all T new rows, and
    token ``t`` sees ``pos < lengths - (T - 1 - t)``), ``k_cache``/``v_cache
    [B, Hk, S, D]`` (``[B, Hk, S, D/2]`` for a side of 4 bits: ``kv_bits=4``,
    or ``k_bits=4, v_bits=8`` for k4v8), ``k_scale``/``v_scale [B, Hk, S]``,
    ``lengths [B]`` int32 on q's device; with ``page_table [B, W]`` int32 the
    caches are the pool ``[Hk, n_pages, page, D]`` (page a power of two)
    and the scales ``[Hk, n_pages, page]``, and a sequence's row ``r`` lives at
    page ``page_table[b, r // page]`` (see the module note; only the pages of
    rows the walk visits are read). Query head ``h`` reads KV head
    ``h // (H / Hk)``. ``sm_scale`` defaults to ``1/sqrt(D)``.
    ``compute_mode`` "auto" takes the integer QK chain for 8-bit K and the
    float chain otherwise; "int_qk" takes the integer chain for 4-bit K too;
    "int" does too and, on an int8 V, runs PV on int8 P codes (INT8 PV; a
    bf16 or 4-bit V keeps the f32 PV); "f32" takes the float chain.

    ``window_size`` W attends each token's last W rows (itself included)
    and, under a window, its first ``sink_size`` rows too; ``logit_cap`` c
    caps the logits as ``c·tanh(s / c)``.

    ``waves`` sets how many waves of resident CTAs the card's split-KV plan
    fills (:func:`num_splits`); None takes the tuning cache's entry for a
    contiguous, unwindowed call (``utils/tuning.py``, as JAX's ``block_kv``
    None does), else :data:`WAVES`. The plan moves only the order in which
    the splits are summed. CPU tensors ignore it.

    Returns ``o`` shaped as ``q`` in ``q.dtype`` and, with ``return_lse``,
    the base-2 LSE ``[B, (T,) H]``. Lengths past ``S`` count as ``S``. The
    TPU function's tiling knobs (``block_kv``, ``heads_per_step``,
    ``compact_window``, ``clamp_walk``, ``fast_interior``, ``interpret``) are
    not ported.
    """
    if waves is not None and not 0 < waves < math.inf:
        raise ValueError(f"waves must be a positive number, got {waves}")
    if compute_mode not in ("auto", "int", "int_qk", "f32"):
        raise ValueError(f"unknown compute_mode {compute_mode!r}")
    k_bits = kv_bits if k_bits is None else k_bits
    v_bits = kv_bits if v_bits is None else v_bits
    _check_bits(k_bits, v_bits)
    paged = page_table is not None
    if q.dim() not in (3, 4) or k_cache.dim() != 4:
        raise ValueError(f"q must be [B, H, D] or [B, T, H, D] and the caches [B, Hk, S, D] (paged: [Hk, n_pages, "
                         f"page, D]): {tuple(q.shape)}, {tuple(k_cache.shape)}")
    b, h, d = q.shape[0], q.shape[-2], q.shape[-1]
    if paged:
        hk, n_pages, page, _ = k_cache.shape
        lead, scale_shape = (hk, n_pages, page), (hk, n_pages, page)
        if page_table.dim() != 2 or page_table.shape[0] != b or page_table.dtype != torch.int32:
            raise ValueError(f"page_table must be [B, W] int32 with B={b}: {tuple(page_table.shape)}, "
                             f"{page_table.dtype}")
        if page < 1 or page & (page - 1):
            raise ValueError(f"the page size must be a power of two, got {page}")
        s_max = page_table.shape[1] * page
    else:
        _, hk, s_max, _ = k_cache.shape
        lead, scale_shape = (b, hk, s_max), (b, hk, s_max)
    width = lambda bits: d // 2 if bits == 4 else d  # noqa: E731
    if tuple(k_cache.shape) != lead + (width(k_bits),) or tuple(v_cache.shape) != lead + (width(v_bits),):
        raise ValueError(f"caches must be {'[Hk, n_pages, page, D]' if paged else '[B, Hk, S, D]'} (D/2 at 4 bits) "
                         f"with D={d}, k_bits={k_bits}, v_bits={v_bits}: {tuple(k_cache.shape)}, "
                         f"{tuple(v_cache.shape)}")
    for side, cache, bits in (("k", k_cache, k_bits), ("v", v_cache, v_bits)):
        if (cache.dtype == torch.int8) != (bits != 16):
            raise TypeError(f"a {bits}-bit {side} cache holds {'bf16 rows' if bits == 16 else 'int8 bytes'}, "
                            f"not {cache.dtype}")
    if hk == 0 or h % hk:
        raise ValueError(f"query heads {h} not a multiple of kv heads {hk}")
    if tuple(k_scale.shape) != scale_shape:
        raise ValueError(f"k_scale must be {list(scale_shape)}, got {tuple(k_scale.shape)}")
    v_quantized = v_cache.dtype == torch.int8
    if v_quantized and (v_scale is None or tuple(v_scale.shape) != scale_shape):
        raise ValueError(f"a quantized V cache needs v_scale {list(scale_shape)}")
    if tuple(lengths.shape) != (b,):
        raise ValueError(f"lengths must be [B], got {tuple(lengths.shape)}")
    int_qk = k_cache.dtype == torch.int8 and (compute_mode in ("int", "int_qk") or (compute_mode == "auto"
                                                                                    and k_bits == 8))
    int_pv = compute_mode == "int" and v_bits == 8
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    window = int(window_size) if window_size else 0
    if window < 0 or sink_size < 0 or logit_cap < 0:
        raise ValueError(f"window_size, sink_size and logit_cap must be >= 0: {window_size}, {sink_size}, {logit_cap}")
    # A window as long as the cache hides no row (lengths count at most S).
    window = window if window < s_max else 0
    opts = dict(window=window, sink=int(sink_size) if window else 0, logit_cap=float(logit_cap), int_pv=int_pv)
    if q.dim() == 4 and q.shape[1] == 1 and not int_pv and not paged:  # one token: the single-token kernels
        out = decode_attention(q[:, 0], k_cache, v_cache, k_scale, lengths, v_scale=v_scale, sm_scale=sm_scale,
                               logit_cap=logit_cap, k_bits=k_bits, v_bits=v_bits, window_size=window_size,
                               sink_size=sink_size, return_lse=return_lse, compute_mode=compute_mode, waves=waves)
        return tuple(x[:, None] for x in out) if return_lse else out[:, None]

    args = (q, k_cache, v_cache, k_scale, v_scale if v_quantized else None, lengths)
    if q.device.type == "cpu":
        if paged:
            o, lse = decode_attention_paged_plain(*args, page_table, sm_scale=sm_scale, int_qk=int_qk,
                                                  out_dtype=q.dtype, **opts)
        else:
            o, lse = decode_attention_plain(*args, sm_scale=sm_scale, int_qk=int_qk, out_dtype=q.dtype, **opts)
    elif q.device.type == "cuda":
        o, lse = _decode_attention_cuda(
            *args, sm_scale=sm_scale, int_qk=int_qk, out_dtype=q.dtype, need_lse=return_lse, page_table=page_table,
            waves=waves, **opts
        )
    else:
        raise ValueError(f"decode_attention runs on cpu or cuda tensors, not {q.device}")
    return (o, lse) if return_lse else o


#: Launches of kernel D in this process (one per call), in all, per design
#: and per :func:`launch_variant` (keys appear at their first launch). CPU
#: calls do not count.
decode_attention.launches = 0
decode_attention.launches_by_design = {design: 0 for design in DESIGNS}
decode_attention.launches_by_variant = {}
#: Launches per head dim (the head_dim-256, the 80/96 and the run-time head
#: dim instances live in sources of their own).
decode_attention.launches_by_dim = {d: 0 for d in CARD_HEAD_DIMS}
#: Launches per split count of the plan (keys appear at their first launch).
decode_attention.launches_by_splits = {}
