"""FlashAttention-2 forward with low-bit or bf16 QK and bf16 or INT8 PV
(kernel A).

PyTorch/CUDA counterpart of the forward kernels in
``lowbit_quant_fa2_paddle_tpu/ops/attention.py``. On the TPU two schedules
(K-major ``lowbit_attention_km`` and Q-major ``lowbit_attention``) exist
because of the matrix unit's lane layout; on the GPU kernel A carries their
features and takes natural layouts:
``q [B,H,Sq,D]``, ``k [B,Hk,Sk,D]`` (``[B,Hk,Sk,D/2]`` or ``[B,Hk,Sk,D/4]``
packed), ``v [B,Hk,Sk,D]``, ``o [B,H,Sq,D]``.

The operand types select the mode:

* ``q`` int8 codes + ``q_scale``, ``k`` int8 codes + ``k_scale``: INT8 QK;
* ``q`` float, ``k`` int8 codes + ``k_scale``: Q is quantized per token
  inside the kernel (the TPU kernel's ``fused_quant_q``), then INT8 QK;
* ``k_pack_bits`` 4 (``k_packed_int4``) or 2: ``k`` holds packed INT4
  (halves of D) or INT2 (quarters of D) codes, unpacked to INT8 in the
  kernel; the logical D comes from ``q`` and ``v``;
* ``q`` and ``k`` float: the FA-2 baseline, bf16 QK (f32 Q/K are rounded to
  bf16 first).

PV runs bf16 × bf16 → f32, V rounded to bf16 as the TPU kernel's default
``pv_dtype`` does; int8 V codes (per-channel ``v_scale`` ``[B,Hk,D]``) widen
to bf16 exactly, or with ``pv_int8`` multiply as an exact INT8 dot against P
requantized to [0, 127]. ``pv_dtype=torch.float32`` keeps the softmax chain
in f32 (no bf16 rounding of ``s - m`` or of P) and V as given: the kernel
splits P and V into three bf16 terms each (all 24 bits) and sums the six
products whose terms' orders add to at most 2 per 16 keys, over tiles of 64
keys; ``pv_int8`` keeps its bf16 chain, as in JAX. The LSE comes back in base 2, ``-1e30`` for rows with no
visible key.

Every mode takes the TPU kernel's masks: a causal sliding window with
attention sinks, a query position offset, segment ids and a logit cap; and
an additive ``bias`` in natural-log units, a per-key vector ``[B,H,1,Sk]``
or a full matrix ``[B,H,Sq,Sk]``, scaled by log2(e) in f32 and added to
the base-2 logits after the scale, before the cap and the masks.
Causal calls visit only the KV tiles of each q block's band
(:func:`kv_visits`, the TPU kernel's ``_tri_schedule``), sink tiles first;
the kernel and the plain version walk the same list.

Every mode of kernel A (the DiT's int8, fp, int4 and int8_v8 impls, the LLM
prefill, the training forward, INT8 PV) runs on one Hopper design
(``kernel_design``): ``csrc/attention_fwd_wgmma.cuh`` (TMA, ``wgmma``,
warp-specialised), instantiated at head dims 64 and 128 in
``attention_fwd_wgmma.cu`` (KV tiles of 128 keys), with the bias in
``attention_fwd_wgmma_bias.cu``, with fp32 PV in
``attention_fwd_wgmma_pv32.cu`` and ``attention_fwd_wgmma_pv32_d256.cu`` (KV
tiles of 64 keys), and at head_dim 256 in ``attention_fwd_wgmma_d256.cu``
(KV tiles of 64 keys), and at head_dim 512 in ``attention_fwd_wgmma_d512.cu``
and ``attention_fwd_wgmma_d512_masked.cu`` (KV tiles of 64 keys, O's columns
split between two warpgroups; no fp32 PV), all behind the one C entry
``lowbit_attn_fwd_wgmma``. Smaller head dims are zero-padded to the next of
64, 128, 256 and 512; above 512 the port raises. The tile is part of the rounding
(P rounds against the running maximum of each tile), so the plain version
takes the tile of the kernel that runs the call (``kv_tile``).

``lowbit_attention`` takes the plain PyTorch version below for tensors on the
CPU and launches the kernel for CUDA tensors; nothing falls back.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from lowbit_quant_fa2_paddle_tpu_torch.ops import _build
from lowbit_quant_fa2_paddle_tpu_torch.ops.quant import absmax_scale, quant_codes, unpack_int2, unpack_int4
from lowbit_quant_fa2_paddle_tpu_torch.ops.reference import _repeat_kv

LOG2E = math.log2(math.e)
LOG2_127 = math.log2(127.0)
MASK_VALUE = -0.7 * torch.finfo(torch.float32).max
NEG_INIT = -1e30

#: Keys per KV tile of kernel A's design (``BKV`` in its source) up to head_dim
#: 128.
KV_TILE = {"wgmma": 128}
#: Keys per KV tile of the head_dim-256 and -512 kernels and of the fp32-PV
#: ones (``kBKV<D, kPV32>``).
KV_TILE_D256 = 64
#: The head dims kernel A is built for; a call pads its head dim up to the
#: next of them. 257-511 pad to 512 (one set of instances, not one for each
#: multiple of 64 that the JAX launcher pads to).
KERNEL_DIMS = (64, 128, 256, 512)
#: Elements of one chunk of f32 logits in the plain version (1 GiB).
_PLAIN_CHUNK_ELEMS = 1 << 28
_UNPACK = {4: unpack_int4, 2: unpack_int2}


def kernel_design(pv_int8: bool = False) -> str:
    """Which design of kernel A runs a mode: ``"wgmma"`` for every mode,
    INT8 PV included."""
    return "wgmma"


def kernel_dim(head_dim: int) -> int:
    """The head dim of the kernel that runs a call: the next of 64, 128, 256
    and 512 (zero columns pad the rest). Above 512 it raises: a 64-row bf16
    Q tile and one stage of 64-key bf16 K and V would pass the 227 KB of
    shared memory a block can have, and O split over two warpgroups would
    pass the registers."""
    for dp in KERNEL_DIMS:
        if head_dim <= dp:
            return dp
    raise _not_ported(f"head_dim {head_dim} > 512 on the GPU", "3h")


def kv_tile(pv_int8: bool = False, head_dim: int = 128, pv_f32: bool = False) -> int:
    """Keys per KV tile of the kernel that runs the mode at ``head_dim``:
    the design's 128, or 64 above head_dim 128 (the head_dim-256 and -512
    kernels) and with fp32 PV."""
    return KV_TILE_D256 if head_dim > 128 or pv_f32 else KV_TILE[kernel_design(pv_int8)]


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet (ROADMAP.md Queue 1, item {item})")


def kv_visits(q_lo: int, q_hi: int, s_k: int, tile: int, *, causal: bool, window: int = 0, sink: int = 0,
              q_offset: int = 0) -> list:
    """The KV tiles kernel A visits, in order, for the query rows ``[q_lo,
    q_hi)`` (one CTA's block): ``_tri_schedule``'s semantics in the JAX
    package. Non-causal: every tile. Causal: the tiles up to the diagonal of
    the block's last row (positions shifted by ``q_offset``); with a
    ``window``, from the tile of the block's first row's lowest visible key
    ``q_lo + q_offset - window + 1``, after the ``sink`` tiles below that
    band (keys ``[0, sink)`` stay visible). A block whose band is empty still
    gets one visit, fully masked, so its rows come out ``o = 0``, ``lse =
    -1e30``. The result does not depend on the tiles visited beyond those
    that hold a visible key: a fully masked tile leaves every row's running
    maximum and sums as they are."""
    nk = -(-s_k // tile)
    if not causal:
        return list(range(nk))
    lo, hi = q_lo + q_offset, q_hi - 1 + q_offset
    j_max = min(nk, -(-(hi + 1) // tile))
    j_min = max(0, (lo - window + 1) // tile) if window > 0 else 0
    if j_min >= j_max:
        j_max = max(j_max, 1)
        j_min = j_max - 1
    sink_tiles = -(-sink // tile) if window > 0 and sink > 0 else 0
    return list(range(min(sink_tiles, j_min))) + list(range(j_min, j_max))


def _mask_args(s_q: int, causal: bool, window_size, sink_size: int, q_position_offset: int):
    """``(window, sink, q_offset)`` as the kernel takes them, with the JAX
    launcher's rules: a window (or an offset) needs ``causal``; a window that
    covers every key of every row (``>= Sq + offset``) is none; sinks count
    only under a window."""
    q_offset = int(q_position_offset)
    if q_offset and not causal:
        raise ValueError("q_position_offset is a causal-mask shift: it needs is_causal")
    window = 0
    if window_size is not None:
        if not causal:
            raise ValueError("window_size needs is_causal (a causal sliding window)")
        if window_size < 1:
            raise ValueError(f"window_size must be at least 1, got {window_size}")
        window = int(window_size) if window_size < s_q + q_offset else 0
    if sink_size < 0:
        raise ValueError(f"sink_size must be >= 0, got {sink_size}")
    return window, int(sink_size) if window > 0 else 0, q_offset


def _visible(rows: torch.Tensor, cols: torch.Tensor, s_k: int, causal: bool, window: int, sink: int):
    """``[n, c]`` mask of the keys at positions ``cols`` that the query rows
    at (offset) positions ``rows`` see: the KV edge, the causal diagonal, the
    window ``(r - window, r]`` and the sinks ``[0, sink)`` (the TPU kernel's
    per-element masks)."""
    vis = (cols < s_k)[None, :].expand(rows.shape[0], -1)
    if causal:
        vis = vis & (cols[None, :] <= rows[:, None])
        if window > 0:
            inw = cols[None, :] + window > rows[:, None]
            if sink > 0:
                inw = inw | (cols < sink)[None, :]
            vis = vis & inw
    return vis


def attention_fwd_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    q_scale: Optional[torch.Tensor],
    k_scale: Optional[torch.Tensor],
    v_mean: Optional[torch.Tensor],
    *,
    causal: bool,
    sm_scale_log2e: float,
    out_dtype: torch.dtype,
    k_bits: int = 8,
    v_scale: Optional[torch.Tensor] = None,
    pv_int8: bool = False,
    window: int = 0,
    sink: int = 0,
    q_offset: int = 0,
    q_segment_ids: Optional[torch.Tensor] = None,
    kv_segment_ids: Optional[torch.Tensor] = None,
    logit_cap: float = 0.0,
    bias: Optional[torch.Tensor] = None,
    pv_f32: bool = False,
):
    """Plain PyTorch version of kernel A on the kernel's own inputs.

    ``q_scale`` (int8 ``q`` only) already carries ``sm_scale * log2(e)``;
    ``k_bits`` 4 or 2 says ``k`` holds packed codes; int8 ``v`` comes with
    ``v_scale``. ``window``/``sink``/``q_offset`` as :func:`_mask_args`
    returns them; segment ids ``[B, Sq]`` / ``[B, Sk]``; ``logit_cap``
    applies ``c·tanh(s/c)`` to the base-2 logits with ``c = cap·log2(e)``,
    before the mask; ``bias`` ``[B, H, 1 or Sq, Sk]`` in natural-log units is
    taken to base 2 in f32 (as the TPU launcher and the kernel do) and added
    after the scale and before the cap. Works through q-row chunks
    so the f32 logits stay within 1 GiB, each over the KV tiles
    :func:`kv_visits` lists for its rows. The softmax follows the kernel's online recurrence over KV tiles
    of ``kv_tile`` keys (those of the design that runs the mode), in closed
    form: tile ``j`` rounds its P against the running maximum ``m_j`` and is
    weighted by ``2^(m_j - m_last)``, so P rounds to bf16 (or to ``p8`` with
    ``pv_int8``) exactly where the kernel rounds it and the two differ only
    in summation order. With ``pv_f32`` nothing rounds to bf16: P is f32 and
    V is taken as given. A row no key is visible to gives ``o = 0`` (no
    ``v_mean``) and ``lse = -1e30``. Returns ``(o, lse2)``.
    """
    b, h, s_q, _ = q.shape
    s_k = k.shape[2]
    dev = q.device
    c = torch.tensor(sm_scale_log2e, dtype=torch.float32, device=dev)
    quant = k.dtype == torch.int8
    tile = kv_tile(pv_int8, q.shape[-1], pv_f32)
    if k_bits != 8:
        k = _UNPACK[k_bits](k)
    n_tiles = -(-s_k // tile)
    pad = n_tiles * tile - s_k
    kf = _repeat_kv(k if quant else k.to(torch.bfloat16), h).float()
    kf = torch.nn.functional.pad(kf, (0, 0, 0, pad))
    vf = _repeat_kv(v if v.dtype == torch.int8 or pv_f32 else v.to(torch.bfloat16), h).float()
    vf = torch.nn.functional.pad(vf, (0, 0, 0, pad))
    ks = torch.nn.functional.pad(_repeat_kv(k_scale.float()[:, :, None, :], h), (0, pad)) if quant else None
    vs = _repeat_kv(v_scale.float()[:, :, None, :], h) if v_scale is not None else None
    vm = _repeat_kv(v_mean.float()[:, :, None, :], h) if v_mean is not None else None
    segs = q_segment_ids is not None
    if segs:
        kseg = torch.nn.functional.pad(kv_segment_ids.to(torch.int64), (0, pad), value=-1)
    cap2 = torch.tensor(logit_cap * LOG2E, dtype=torch.float32, device=dev) if logit_cap > 0 else None
    if bias is not None:
        bias = torch.nn.functional.pad(bias.float() * torch.tensor(LOG2E, dtype=torch.float32, device=dev), (0, pad))
    # Rows a chunk takes: its visited keys grow with its rows under a window.
    per_row = b * h * tile
    rows = max(1, _PLAIN_CHUNK_ELEMS // (per_row * n_tiles))
    if window > 0:
        sink_tiles = -(-sink // tile)
        most = lambda r: min(n_tiles, sink_tiles + (r + window - 1) // tile + 2)  # noqa: E731
        while rows < s_q and most(2 * rows) * per_row * 2 * rows <= _PLAIN_CHUNK_ELEMS:
            rows *= 2
    outs, lses = [], []
    for lo in range(0, s_q, rows):
        qc = q[:, :, lo : lo + rows]
        n = qc.shape[2]
        visits = kv_visits(lo, lo + n, s_k, tile, causal=causal, window=window, sink=sink, q_offset=q_offset)
        cols = (torch.tensor(visits, device=dev)[:, None] * tile + torch.arange(tile, device=dev)).reshape(-1)
        contiguous = visits == list(range(visits[0], visits[-1] + 1))
        take = (lambda x, dim: x.narrow(dim, visits[0] * tile, len(visits) * tile)) if contiguous else (
            lambda x, dim: x.index_select(dim, cols))
        kc = take(kf, 2)
        if not quant:
            s = (qc.to(torch.bfloat16).float() @ kc.transpose(-1, -2)) * c
        else:
            if qc.dtype == torch.int8:
                codes, qs = qc.float(), q_scale[:, :, lo : lo + rows].float()
            else:
                sc = absmax_scale(qc.float().abs().amax(dim=-1, keepdim=True))
                codes, qs = quant_codes(qc.float(), sc).float(), sc[..., 0] * c
            # Integer-valued f32 products: exact while |sum| < 2^24.
            s = ((codes @ kc.transpose(-1, -2)) * take(ks, 3)) * qs[..., None]
        del kc
        if bias is not None:
            s = s + take(bias if bias.shape[2] == 1 else bias[:, :, lo : lo + n], 3)
        if cap2 is not None:
            s = cap2 * torch.tanh(s / cap2)
        pos = torch.arange(lo, lo + n, device=dev) + q_offset
        vis = _visible(pos, cols, s_k, causal, window, sink)[None, None]
        if segs:
            vis = vis & (q_segment_ids[:, lo : lo + n, None].to(torch.int64) == take(kseg, 1)[:, None, :])[:, None]
        s = s.masked_fill(~vis, MASK_VALUE)
        del vis
        nt = len(visits)
        s = s.view(b, h, n, nt, tile)
        m_run = torch.cummax(s.amax(dim=-1), dim=-1).values.clamp_min(NEG_INIT)  # [b,h,n,T]
        shift = m_run - LOG2_127 if pv_int8 else m_run
        if pv_f32:
            p = torch.exp2(s - shift[..., None])
        else:
            p = torch.exp2((s - shift[..., None]).to(torch.bfloat16).float()).to(torch.bfloat16).float()
        del s
        if pv_int8:
            # p8 = int8(bf16(P + 0.5)), saturating at 127 as XLA's convert does.
            p = (p + 0.5).to(torch.bfloat16).float().trunc().clamp_max(127.0)
        m = m_run[..., -1:]
        w = torch.exp2(m_run - m)
        l = (p.sum(dim=-1) * w).sum(dim=-1, keepdim=True)
        o = (p * w[..., None]).view(b, h, n, nt * tile) @ take(vf, 2)
        del p
        empty = l == 0.0
        ls = torch.where(empty, torch.ones_like(l), l)
        o = o / ls
        if vs is not None:
            o = o * vs
        if vm is not None:
            o = o + (~empty).float() * vm
        outs.append(o.to(out_dtype))
        lse = m + torch.log2(ls)
        if pv_int8:
            lse = lse - LOG2_127
        lses.append(torch.where(empty, torch.full_like(l, NEG_INIT), lse)[..., 0])
    return torch.cat(outs, dim=2), torch.cat(lses, dim=2)


def bf16_terms(x: torch.Tensor) -> list:
    """``x`` (f32) as the three bf16 terms ``t1 = bf16(x)``, ``t2 = bf16(x -
    t1)``, ``t3 = bf16(x - t1 - t2)`` that kernel A's fp32 PV reads as one
    ``[.., 3D]`` V row (``Layout::kVCols`` in ``csrc/attention_fwd_wgmma.cuh``):
    each difference is exact in f32, and the three carry all 24 bits of
    ``x``'s significand (the kernel splits P the same way)."""
    t1 = x.to(torch.bfloat16)
    r = x - t1.float()
    t2 = r.to(torch.bfloat16)
    return [t1, t2, (r - t2.float()).to(torch.bfloat16)]


def _attention_fwd_cuda(
    q, k, v, q_scale, k_scale, v_mean, *, causal, sm_scale_log2e, out_dtype, need_lse, k_bits, v_scale, pv_int8,
    window=0, sink=0, q_offset=0, q_segment_ids=None, kv_segment_ids=None, logit_cap=0.0, bias=None, pv_f32=False,
):
    """Launch kernel A (``csrc/attention_fwd_wgmma*.cu``). Head dims below 64,
    between 64 and 128, or between 128 and 256 are zero-padded to the next
    (:func:`kernel_dim`): zero Q/K columns leave QK^T and the Q absmax
    unchanged, and zero V columns are sliced off. Packed K cannot be padded;
    its D is 64, 128, 256 or 512. fp32 PV has no kernel above 256. fp32 PV hands the kernel V as three bf16 terms
    of one ``[.., 3D]`` row (:func:`bf16_terms`; int8 codes are exact in the
    first)."""
    b, h, s_q, d = q.shape
    hk, s_k = k.shape[1], k.shape[2]
    dp = kernel_dim(d)
    if b > 65535 or h > 65535:
        raise ValueError(f"batch and heads are CUDA grid dims (at most 65535): {b}, {h}")
    if k_bits != 8 and dp != d:
        raise ValueError(f"packed K on the GPU needs head_dim 64, 128, 256 or 512 (pad before quantizing), got {d}")
    if pv_f32 and dp > 256:
        raise _not_ported(f"fp32 PV at head_dim {d} > 256 on the GPU", "3h")
    quant = k.dtype == torch.int8
    if q.dtype == torch.int8:
        mode = 0
    elif quant:
        mode = 1 if q.dtype == torch.bfloat16 else 2
        q = q if mode == 1 else q.float()
    else:
        mode, k_bits = 3, 16
        q, k = q.to(torch.bfloat16), k.to(torch.bfloat16)
    v_mode = 0 if v.dtype != torch.int8 else 2 if pv_int8 else 1
    if v_mode == 0 and not pv_f32:
        v = v.to(torch.bfloat16)
    if dp != d:
        pad = lambda x: torch.nn.functional.pad(x, (0, dp - d)) if x is not None else None  # noqa: E731
        q, k, v, v_scale, v_mean = pad(q), pad(k), pad(v), pad(v_scale), pad(v_mean)
    if pv_f32:
        v = torch.cat(bf16_terms(v.float()), dim=-1)
    if q_segment_ids is not None:
        q_segment_ids = q_segment_ids.to(torch.int32).contiguous()
        kv_segment_ids = kv_segment_ids.to(torch.int32).contiguous()
    tensors = [q, k, v] + [x for x in (q_scale, k_scale, v_scale, v_mean, q_segment_ids, kv_segment_ids, bias)
                           if x is not None]
    if any(x.device != q.device for x in tensors):
        raise ValueError("attention inputs must all be on one device")
    design = kernel_design(pv_int8)
    # TMA moves 16-byte chunks from 16-byte aligned tensors.
    aligned = lambda x: (  # noqa: E731
        x if x is None or (x.is_contiguous() and x.data_ptr() % 16 == 0) else x.clone(memory_format=torch.contiguous_format))
    q, k, v = aligned(q), aligned(k), aligned(v)
    q_scale, k_scale, v_scale, v_mean = (
        aligned(x.float()) if x is not None else None for x in (q_scale, k_scale, v_scale, v_mean))
    bias = bias.float().contiguous() if bias is not None else None
    out_f32 = out_dtype != torch.bfloat16
    o = torch.empty((b, h, s_q, dp), dtype=torch.float32 if out_f32 else torch.bfloat16, device=q.device)
    lse = torch.empty((b, h, s_q), dtype=torch.float32, device=q.device) if need_lse else None
    lib = _build.library()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    ptrs = [x.data_ptr() if x is not None else None
            for x in (q, k, v, q_scale, k_scale, v_scale, v_mean, q_segment_ids, kv_segment_ids, bias, o, lse)]
    with torch.cuda.device(q.device):
        err = lib.lowbit_attn_fwd_wgmma(*ptrs, b, h, hk, s_q, s_k, dp, mode, k_bits, v_mode, int(out_f32),
                                        int(causal), window, sink, q_offset, bias.shape[2] if bias is not None else 0,
                                        int(pv_f32), sm_scale_log2e, logit_cap * LOG2E, stream)
    _build.check(err, "lowbit_attention")
    lowbit_attention.launches += 1
    lowbit_attention.launches_by_design[design] += 1
    lowbit_attention.launches_by_dim[dp] += 1
    o = o[..., :d]
    return (o if o.dtype == out_dtype else o.to(out_dtype)), lse


def lowbit_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    q_scale: Optional[torch.Tensor] = None,
    k_scale: Optional[torch.Tensor] = None,
    *,
    v_scale: Optional[torch.Tensor] = None,
    v_mean: Optional[torch.Tensor] = None,
    q_segment_ids: Optional[torch.Tensor] = None,
    kv_segment_ids: Optional[torch.Tensor] = None,
    bias: Optional[torch.Tensor] = None,
    is_causal: bool = False,
    window_size: Optional[int] = None,
    sink_size: int = 0,
    q_position_offset: int = 0,
    sm_scale: Optional[float] = None,
    k_packed_int4: bool = False,
    k_pack_bits: int = 8,
    pv_int8: bool = False,
    logit_cap: float = 0.0,
    pv_dtype: torch.dtype = torch.bfloat16,
    out_dtype: Optional[torch.dtype] = None,
    return_lse: bool = False,
):
    """Attention forward (kernel A) on natural layouts; see the module note
    for the modes. ``q_scale`` ``[B,H,Sq]`` / ``k_scale`` ``[B,Hk,Sk]`` are
    per-row dequant scales (``sm_scale·log2e`` is folded into ``q_scale``
    here, as in the TPU launcher). ``k_packed_int4`` (or ``k_pack_bits=4``)
    and ``k_pack_bits=2`` take packed K codes, with D a multiple of 64. int8 ``v``
    takes per-channel ``v_scale`` ``[B,Hk,D]``; ``pv_int8`` then runs PV as
    an INT8 dot. ``v_mean`` ``[B,Hk,D]`` is added back to rows with at least
    one visible key (smooth-V). ``sm_scale`` defaults to ``1/sqrt(D)``.

    Masks, as the TPU kernel takes them: causal masking is top-left aligned,
    key ``c`` visible to query ``r`` iff ``c <= r + q_position_offset``;
    ``window_size`` (causal only) keeps keys ``c + window > r + offset``,
    plus the ``sink_size`` leading keys (sinks count only under a window);
    ``q_segment_ids`` ``[B,Sq]`` / ``kv_segment_ids`` ``[B,Sk]`` keep keys
    of the query's segment; ``logit_cap`` caps the logits as ``cap·tanh(s /
    cap)`` (in base 2, after the scale, before the mask). ``bias`` (natural
    log units, a per-key vector ``[B,H,1,Sk]`` or a matrix ``[B,H,Sq,Sk]``,
    per query head) is added to the logits after the scale, before the cap
    and the masks. A row that sees no key gives ``o = 0`` and ``lse =
    -1e30``. ``pv_dtype=torch.float32`` runs P in f32 against V as given
    (``pv_int8`` keeps its bf16 chain, as in JAX).

    Returns ``o`` ``[B,H,Sq,D]`` (bf16 when QK is quantized or V is int8,
    else ``v.dtype``, unless ``out_dtype``) and, with ``return_lse``, the
    base-2 LSE ``[B,H,Sq]``.
    """
    if pv_dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"pv_dtype must be torch.bfloat16 or torch.float32, got {pv_dtype}")
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k and v must be [B, H, S, D]")
    k_bits = 4 if k_packed_int4 else k_pack_bits
    if k_bits not in (8, 4, 2):
        raise ValueError(f"k_pack_bits must be 8, 4 or 2, got {k_pack_bits}")
    b, h, s_q, d = q.shape
    _, hk, s_k, d_k = k.shape
    if tuple(v.shape) != (b, hk, s_k, d):
        raise ValueError(f"v must be [B, Hk, Sk, D] with D={d}: {tuple(v.shape)}")
    if tuple(k.shape) != (b, hk, s_k, d * k_bits // 8) or d * k_bits % 8:
        raise ValueError(f"k must be [B, Hk, Sk, D*{k_bits}/8] with D={d}: {tuple(k.shape)}")
    if hk == 0 or h % hk:
        raise ValueError(f"query heads {h} not a multiple of kv heads {hk}")
    kernel_dim(d)  # head dims above 512 have no kernel (raises)
    if s_k < 1:
        raise ValueError("need at least one key")
    q_int8, k_int8, v_int8 = q.dtype == torch.int8, k.dtype == torch.int8, v.dtype == torch.int8
    if k_bits != 8 and not k_int8:
        raise ValueError("packed K is int8 bytes of codes")
    if k_bits != 8 and d % 64:
        raise ValueError(f"packed K needs a head_dim that is a multiple of 64 (pad before quantizing), got {d}")
    if q_int8 and (not k_int8 or q_scale is None or k_scale is None):
        raise ValueError("int8 q needs int8 k codes and both q_scale and k_scale")
    if k_int8 and k_scale is None:
        raise ValueError("int8 k needs k_scale")
    if not q_int8 and q_scale is not None:
        raise ValueError("q_scale goes with int8 q codes; float q is quantized in-kernel")
    if not k_int8 and k_scale is not None:
        raise ValueError("k_scale goes with int8 k codes")
    if v_int8 != (v_scale is not None):
        raise ValueError("int8 v codes and v_scale go together")
    if pv_int8 and not v_int8:
        raise ValueError("pv_int8 needs int8 v codes")
    if q_scale is not None and tuple(q_scale.shape) != (b, h, s_q):
        raise ValueError(f"q_scale must be [B, H, Sq], got {tuple(q_scale.shape)}")
    if k_scale is not None and tuple(k_scale.shape) != (b, hk, s_k):
        raise ValueError(f"k_scale must be [B, Hk, Sk], got {tuple(k_scale.shape)}")
    for name, x in (("v_scale", v_scale), ("v_mean", v_mean)):
        if x is not None and tuple(x.shape) != (b, hk, d):
            raise ValueError(f"{name} must be [B, Hk, D], got {tuple(x.shape)}")
    if (q_segment_ids is None) != (kv_segment_ids is None):
        raise ValueError("q_segment_ids and kv_segment_ids go together")
    if q_segment_ids is not None and (tuple(q_segment_ids.shape) != (b, s_q)
                                      or tuple(kv_segment_ids.shape) != (b, s_k)):
        raise ValueError(f"segment ids must be [B, Sq] and [B, Sk]: {tuple(q_segment_ids.shape)}, "
                         f"{tuple(kv_segment_ids.shape)}")
    if logit_cap < 0:
        raise ValueError(f"logit_cap must be >= 0, got {logit_cap}")
    if bias is not None and (bias.dim() != 4 or tuple(bias.shape[:2]) != (b, h) or bias.shape[2] not in (1, s_q)
                             or bias.shape[3] != s_k):
        raise ValueError(f"bias must be [B, H, 1, Sk] or [B, H, Sq, Sk] = [{b}, {h}, 1 or {s_q}, {s_k}], got "
                         f"{tuple(bias.shape)}")
    window, sink, q_offset = _mask_args(s_q, is_causal, window_size, sink_size, q_position_offset)

    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    sm_scale_log2e = float(sm_scale) * LOG2E
    if q_int8:
        q_scale = q_scale.float() * torch.tensor(sm_scale_log2e, dtype=torch.float32, device=q_scale.device)
    if out_dtype is None:
        out_dtype = torch.bfloat16 if k_int8 or v_int8 else v.dtype

    args = (q, k, v, q_scale, k_scale, v_mean)
    kw = dict(causal=is_causal, sm_scale_log2e=sm_scale_log2e, out_dtype=out_dtype, k_bits=k_bits,
              v_scale=v_scale, pv_int8=pv_int8, window=window, sink=sink, q_offset=q_offset,
              q_segment_ids=q_segment_ids, kv_segment_ids=kv_segment_ids, logit_cap=float(logit_cap), bias=bias,
              pv_f32=pv_dtype == torch.float32 and not pv_int8)
    if q.device.type == "cpu":
        o, lse = attention_fwd_plain(*args, **kw)
    elif q.device.type == "cuda":
        o, lse = _attention_fwd_cuda(*args, **kw, need_lse=return_lse)
    else:
        raise ValueError(f"lowbit_attention runs on cpu or cuda tensors, not {q.device}")
    return (o, lse) if return_lse else o


#: Launches of kernel A in this process (CPU calls do not count), in all and
#: per design.
lowbit_attention.launches = 0
lowbit_attention.launches_by_design = {design: 0 for design in KV_TILE}
#: Launches per kernel head dim (the padded one, :func:`kernel_dim`).
lowbit_attention.launches_by_dim = {dp: 0 for dp in KERNEL_DIMS}


def flash_attention_fp(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    is_causal: bool = False,
    window_size: Optional[int] = None,
    sink_size: int = 0,
    sm_scale: Optional[float] = None,
    return_lse: bool = False,
):
    """Floating-point FlashAttention-2 on kernel A — the baseline the low-bit
    path is compared against. HND in, HND out (``v.dtype``); with
    ``return_lse`` also the base-2 LSE, as the TPU function returns it."""
    if q.dtype == torch.int8 or k.dtype == torch.int8:
        raise ValueError("flash_attention_fp takes float q/k; int8 codes need scales")
    return lowbit_attention(
        q, k, v, is_causal=is_causal, window_size=window_size, sink_size=sink_size,
        sm_scale=sm_scale, return_lse=return_lse,
    )
