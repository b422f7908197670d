"""Public API: low-bit attention entry points on PyTorch tensors.

Counterpart of ``lowbit_quant_fa2_paddle_tpu/core.py``. Layouts follow the
reference: ``tensor_layout="HND"`` is ``[B, H, S, D]``, ``"NHD"`` is
``[B, S, H, D]``; internally everything runs HND.

LSE contract: ``return_lse`` returns the natural-log row logsumexp of the
scaled logits, corrected for K smoothing.

GPU notes: ``kernel_space``, ``fuse_quant``, ``quantization_backend``,
``block_q``, ``block_kv`` and ``interpret`` are accepted for drop-in parity
with the TPU package and change nothing here. There is one attention kernel
with its own tiles; Q is quantized inside it whenever the granularity is
per-token (bit-identical to external per-token codes), and externally at
per-block granularity. The TPU package's Q-major INT4 route (kernel B with
``fused_k_bits=4``) gives the same values as the packed route by its own
docstring, so INT4 always runs the packed route here.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from lowbit_quant_fa2_paddle_tpu_torch.ops import quant as quant_ops
from lowbit_quant_fa2_paddle_tpu_torch.ops.attention import (
    LOG2E,
    flash_attention_fp,
    kernel_dim,
    lowbit_attention,
)
from lowbit_quant_fa2_paddle_tpu_torch.ops.reference import _repeat_kv, attention_reference

__all__ = [
    "lowbit_fa_attn",
    "lowbit_fa_qk_int8_pv_fp16",
    "lowbit_fa_qk_int8_pv_int8",
    "lowbit_fa_qk_int4_pv_fp16",
    "lowbit_fa_qk_int2_pv_fp16",
    "lowbit_fa_mixed_bits",
    "lowbit_fa_varlen",
    "lowbit_fa_multi_precision",
    "lowbit_fa_multi_precision_jit",
    "lowbit_fa_qk_int8_pv_fp16_triton",
    "lowbit_fa_qk_int8_pv_fp16_cuda",
    "lowbit_fa_qk_int8_pv_fp8_cuda",
    "lowbit_fa_qk_int4_pv_fp16_triton",
    "sageattn",
    "sageattn_qk_int8_pv_fp16_triton",
    "sageattn_qk_int8_pv_fp16_cuda",
    "sageattn_qk_int8_pv_fp8_cuda",
    "sageattn_qk_int4_pv_fp16_triton",
    "sageattn_varlen",
    "sageattn_multi_precision",
    "compute_scale",
    "select_quantization",
    "quantize_with_bitmap",
    "manual_scaled_dot_product_attention",
]


def _to_hnd(x: torch.Tensor, tensor_layout: str) -> torch.Tensor:
    if tensor_layout == "HND":
        return x
    if tensor_layout == "NHD":
        return x.transpose(1, 2)
    raise ValueError(f"unknown tensor_layout {tensor_layout!r}")


def _from_hnd(x: torch.Tensor, tensor_layout: str) -> torch.Tensor:
    return x if tensor_layout == "HND" else x.transpose(1, 2)


def _pad_head_dim(x: torch.Tensor, multiple: int = 64) -> torch.Tensor:
    """Zero-pad the last dim up to a multiple of 64. Zero columns leave QK^T
    and abs-max scales unchanged."""
    d = x.shape[-1]
    target = max(multiple, -(-d // multiple) * multiple)
    return x if target == d else torch.nn.functional.pad(x, (0, target - d))


def _gran_block(qk_quant_gran: str, which: str) -> tuple[str, int]:
    """Map the reference's granularity names onto (gran, block): per-warp and
    per-thread map to per-token scales; per-block uses Q blocks of 128 and
    K blocks of 64."""
    if qk_quant_gran in ("per_token", "per_thread", "per_warp"):
        return "per_token", 128
    if qk_quant_gran == "per_block":
        return "per_block", 128 if which == "q" else 64
    raise ValueError(f"unknown qk_quant_gran {qk_quant_gran!r}")


def _finish_lse(lse2: torch.Tensor, q: torch.Tensor, km: Optional[torch.Tensor], sm_scale: float):
    """Base-2 kernel LSE -> natural log, plus the smooth-K term
    ``q · kmᵀ · sm_scale``."""
    lse = lse2 / LOG2E
    if km is not None:
        km = _repeat_kv(km, q.shape[1])
        lse = lse + torch.einsum("bhqd,bhkd->bhqk", q.float(), km.float())[..., 0] * sm_scale
    return lse


def _smooth_q_bias(qm: torch.Tensor, kp: torch.Tensor, km: Optional[torch.Tensor], sm_scale: float):
    """Per-key smooth-Q correction ``qm · (K - km)ᵀ · sm_scale`` ``[B, H, 1,
    Sk]`` (GQA-aware), in f32: the bias that makes attention over ``q - qm``
    exact, the remaining ``qm · km`` term being constant along each row."""
    b, h = qm.shape[0], qm.shape[1]
    hk = kp.shape[1]
    kf = kp.float()
    if km is not None:
        kf = kf - km.float()
    qm_g = qm[:, :, 0, :].reshape(b, hk, h // hk, -1)
    corr = torch.einsum("bkgd,bksd->bkgs", qm_g, kf).reshape(b, h, -1)
    return (corr * sm_scale)[:, :, None, :]


def _smooth_q(qp: torch.Tensor, kp: torch.Tensor, km: Optional[torch.Tensor], sm_scale: float, smooth_q: bool):
    """Q for quantization and the attention bias: with ``smooth_q``, Q minus
    its per-channel mean over the sequence (in ``qp.dtype``) and the bias
    that adds the mean's logits back; else ``(qp, None)``."""
    if not smooth_q:
        return qp, None
    qm = qp.float().mean(dim=2, keepdim=True)  # [B, H, 1, D]
    return (qp.float() - qm).to(qp.dtype), _smooth_q_bias(qm, kp, km, sm_scale)


def _pv_dtype(pv_accum_dtype: str) -> torch.dtype:
    """The PV operand type of a ``pv_accum_dtype``: "fp16", "fp16+fp32" and
    "fp32" take bf16 P/V operands with an f32 accumulator, "fp32+fp32" f32
    operands."""
    if pv_accum_dtype == "fp32+fp32":
        return torch.float32
    if pv_accum_dtype not in ("fp16", "fp16+fp32", "fp32"):
        raise ValueError(f"unknown pv_accum_dtype {pv_accum_dtype!r}")
    return torch.bfloat16


def _quant_q(qp: torch.Tensor, qk_quant_gran: str):
    """Q for the kernel: float Q quantized per token inside it, or external
    per-block codes from kernel C1."""
    gq, bq = _gran_block(qk_quant_gran, "q")
    if gq == "per_token":
        return qp, None
    return quant_ops.quant_int8(qp, gran=gq, block=bq)


def _finish(out, qp, km, sm_scale: float, d_og: int, tensor_layout: str, return_lse: bool):
    """Unpad the head dim, restore the layout, and turn the kernel's LSE
    into the API's natural-log LSE."""
    if return_lse:
        o, lse2 = out
        return _from_hnd(o[..., :d_og], tensor_layout), _finish_lse(lse2, qp, km, sm_scale)
    return _from_hnd(out[..., :d_og], tensor_layout)


def lowbit_fa_qk_int8_pv_fp16(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    tensor_layout: str = "HND",
    quantization_backend: str = "pallas",
    is_causal: bool = False,
    sm_scale: Optional[float] = None,
    qk_quant_gran: str = "per_token",
    pv_accum_dtype: str = "fp32",
    smooth_k: bool = True,
    smooth_v: bool = False,
    return_lse: bool = False,
    *,
    smooth_q: bool = False,
    window_size: Optional[int] = None,
    sink_size: int = 0,
    kernel_space: str = "auto",
    fuse_quant: Optional[bool] = None,
    block_q: int = 1024,
    block_kv: int = 1024,
    interpret: Optional[bool] = None,
):
    """INT8-QK attention with bf16 PV and an fp32 accumulator (reference
    ``sageattn_qk_int8_pv_fp16_*``): smooth-K (K minus its sequence mean
    before quantization), optional smooth-V (V's mean added back in the
    epilogue), per-token or per-block scales, causal or not, GQA.

    ``pv_accum_dtype`` "fp16", "fp16+fp32" and "fp32" all mean bf16 P/V
    operands with an fp32 accumulator; "fp32+fp32" runs P and V in f32
    (kernel A's fp32 PV). ``smooth_q`` takes Q's per-channel mean out
    before quantization and adds its logits back as a per-key bias (exact);
    the LSE still uses the original Q.
    """
    pv_dtype = _pv_dtype(pv_accum_dtype)
    q, k, v = (_to_hnd(x, tensor_layout) for x in (q, k, v))
    d_og = q.shape[-1]
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d_og)
    qp, kp = _pad_head_dim(q), _pad_head_dim(k)

    km = quant_ops.k_mean(kp) if smooth_k else None
    gk, bk = _gran_block(qk_quant_gran, "k")
    k_codes, k_scale = quant_ops.quant_int8(kp, km, gran=gk, block=bk)
    qq, bias = _smooth_q(qp, kp, km, sm_scale, smooth_q)
    q_in, q_scale = _quant_q(qq, qk_quant_gran)
    v_in, v_mean = v, None
    if smooth_v:
        v_mean = v.float().mean(dim=2)  # [B, Hk, D]
        v_in = (v.float() - v_mean[:, :, None, :]).to(v.dtype)
        v_mean = _pad_head_dim(v_mean)
    out = lowbit_attention(
        q_in, k_codes, _pad_head_dim(v_in), q_scale, k_scale,
        v_mean=v_mean, bias=bias, is_causal=is_causal, window_size=window_size, sink_size=sink_size,
        sm_scale=sm_scale, pv_dtype=pv_dtype, out_dtype=v.dtype, return_lse=return_lse,
    )
    return _finish(out, qp, km, sm_scale, d_og, tensor_layout, return_lse)


def lowbit_fa_qk_int8_pv_int8(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    tensor_layout: str = "HND",
    is_causal: bool = False,
    sm_scale: Optional[float] = None,
    qk_quant_gran: str = "per_token",
    smooth_k: bool = True,
    smooth_v: bool = True,
    return_lse: bool = False,
    *,
    window_size: Optional[int] = None,
    sink_size: int = 0,
    kernel_space: str = "auto",
    fuse_quant: Optional[bool] = None,
    pv_int8: bool = False,
    block_q: int = 1024,
    block_kv: int = 1024,
    interpret: Optional[bool] = None,
):
    """INT8-QK attention with per-channel INT8 V (reference
    ``sageattn_qk_int8_pv_fp8_cuda``; the TPU package's stand-in for FP8 PV):
    V is quantized per channel over the sequence, optionally after taking out
    its mean (``smooth_v``, on by default), and the kernel applies
    ``v_scale`` and adds the mean back in its epilogue. ``pv_int8`` runs PV
    as an exact INT8 dot against P requantized to [0, 127]; by default the V
    codes widen to bf16."""
    q, k, v = (_to_hnd(x, tensor_layout) for x in (q, k, v))
    d_og = q.shape[-1]
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d_og)
    qp, kp = _pad_head_dim(q), _pad_head_dim(k)
    km = quant_ops.k_mean(kp) if smooth_k else None
    gk, bk = _gran_block(qk_quant_gran, "k")
    k_codes, k_scale = quant_ops.quant_int8(kp, km, gran=gk, block=bk)
    q_in, q_scale = _quant_q(qp, qk_quant_gran)
    v_codes, v_scale, v_mean = quant_ops.quant_v_int8_per_channel(_pad_head_dim(v), smooth_v=smooth_v)
    out = lowbit_attention(
        q_in, k_codes, v_codes, q_scale, k_scale,
        v_scale=v_scale, v_mean=v_mean, pv_int8=pv_int8, is_causal=is_causal, window_size=window_size,
        sink_size=sink_size, sm_scale=sm_scale, out_dtype=v.dtype, return_lse=return_lse,
    )
    return _finish(out, qp, km, sm_scale, d_og, tensor_layout, return_lse)


def _packed_k_attention(q, k, v, bits, tensor_layout, is_causal, sm_scale, qk_quant_gran, smooth_k,
                        return_lse, window_size, sink_size, smooth_q=False):
    """INT8 Q × packed INT4/INT2 K (kernel C2 or C3, then A), bf16 PV. K is
    quantized at the JAX package's padding (a multiple of 64: the INT2 scale
    is an RMS over the row); where kernel A's head dim is wider (192 -> 256)
    the codes are repacked with zero columns, and Q and V padded to it."""
    q, k, v = (_to_hnd(x, tensor_layout) for x in (q, k, v))
    d_og = q.shape[-1]
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d_og)
    qp, kp = _pad_head_dim(q), _pad_head_dim(k)
    km = quant_ops.k_mean(kp) if smooth_k else None
    gk, bk = _gran_block(qk_quant_gran, "k")
    quant_k = quant_ops.quant_int4 if bits == 4 else quant_ops.quant_int2
    k_packed, k_scale = quant_k(kp, km, gran=gk, block=bk)
    qq, bias = _smooth_q(qp, kp, km, sm_scale, smooth_q)
    q_in, q_scale = _quant_q(qq, qk_quant_gran)
    v_in = _pad_head_dim(v)
    dp = kernel_dim(kp.shape[-1])
    if dp != kp.shape[-1]:
        unpack = quant_ops.unpack_int4 if bits == 4 else quant_ops.unpack_int2
        k_packed = quant_ops.pack_codes(_pad_head_dim(unpack(k_packed), dp), bits)
        q_in, v_in = _pad_head_dim(q_in, dp), _pad_head_dim(v_in, dp)
    out = lowbit_attention(
        q_in, k_packed, v_in, q_scale, k_scale,
        k_pack_bits=bits, bias=bias, is_causal=is_causal, window_size=window_size, sink_size=sink_size,
        sm_scale=sm_scale, out_dtype=v.dtype, return_lse=return_lse,
    )
    return _finish(out, qp, km, sm_scale, d_og, tensor_layout, return_lse)


def lowbit_fa_qk_int4_pv_fp16(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    tensor_layout: str = "HND",
    is_causal: bool = False,
    sm_scale: Optional[float] = None,
    qk_quant_gran: str = "per_token",
    smooth_k: bool = True,
    return_lse: bool = False,
    *,
    smooth_q: bool = False,
    window_size: Optional[int] = None,
    sink_size: int = 0,
    kernel_space: str = "auto",
    fuse_quant: Optional[bool] = None,
    block_q: int = 1024,
    block_kv: int = 1024,
    interpret: Optional[bool] = None,
):
    """INT8-Q × INT4-K attention with bf16 PV (reference
    ``sageattn_qk_int4_pv_fp16_triton``): smooth-K, then K quantized per
    token (or per block of 64) to INT4 codes packed two per byte (kernel
    C2), unpacked inside kernel A. ``smooth_q`` as in
    :func:`lowbit_fa_qk_int8_pv_fp16`."""
    return _packed_k_attention(q, k, v, 4, tensor_layout, is_causal, sm_scale, qk_quant_gran, smooth_k,
                               return_lse, window_size, sink_size, smooth_q)


def lowbit_fa_qk_int2_pv_fp16(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    tensor_layout: str = "HND",
    is_causal: bool = False,
    sm_scale: Optional[float] = None,
    qk_quant_gran: str = "per_token",
    smooth_k: bool = True,
    return_lse: bool = False,
    *,
    window_size: Optional[int] = None,
    sink_size: int = 0,
    fuse_quant: Optional[bool] = None,
    interpret: Optional[bool] = None,
):
    """INT8-Q × INT2-K attention with bf16 PV: K codes in {-1, 0, 1} at the
    Lloyd-Max scale ``1.224·rms``, four per byte (kernel C3), a quarter of
    INT8 K's bytes. Accuracy is well below INT4."""
    return _packed_k_attention(q, k, v, 2, tensor_layout, is_causal, sm_scale, qk_quant_gran, smooth_k,
                               return_lse, window_size, sink_size)


def quantize_with_bitmap(k: torch.Tensor, bitmap, *, block: int = 128) -> torch.Tensor:
    """Mixed-precision error injection per token block (reference
    ``quantize_with_bitmap``): blocks flagged 1 in ``bitmap`` keep their
    values, blocks flagged 0 are rounded through INT4 (per-block absmax,
    round half to even as ``jnp.round``). Returns a float tensor of
    ``k.dtype`` for the INT8 pipeline. Plain PyTorch ops, as the TPU package
    computes it in plain XLA; the scale is the fma form its compiled code
    uses."""
    b, h, s, d = k.shape
    nblk = -(-s // block)
    kb = torch.nn.functional.pad(k.float(), (0, 0, 0, nblk * block - s)).reshape(b, h, nblk, block, d)
    scale4 = quant_ops.absmax_scale(kb.abs().amax(dim=(3, 4), keepdim=True), bits=4)
    k4 = torch.round(kb / scale4).clamp(-7.0, 7.0) * scale4
    keep8 = torch.as_tensor(bitmap, device=k.device).reshape(1, 1, nblk, 1, 1).bool()
    mixed = torch.where(keep8, kb, k4).reshape(b, h, nblk * block, d)[:, :, :s]
    return mixed.to(k.dtype)


def lowbit_fa_mixed_bits(q, k, v, bitmap, *, tensor_layout: str = "HND", block: int = 128, **kw):
    """Per-token-block bit allocation: the INT8 path over K whose blocks were
    mixed INT8/INT4 by importance ``bitmap`` (reference bitmap bench)."""
    kh = _to_hnd(k, tensor_layout)
    k_mixed = _from_hnd(quantize_with_bitmap(kh, bitmap, block=block), tensor_layout)
    return lowbit_fa_qk_int8_pv_fp16(q, k_mixed, v, tensor_layout=tensor_layout, **kw)


def lowbit_fa_varlen(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    cu_seqlens_q: torch.Tensor,
    cu_seqlens_k: torch.Tensor,
    max_seqlen_q: Optional[int] = None,
    max_seqlen_k: Optional[int] = None,
    is_causal: bool = False,
    sm_scale: Optional[float] = None,
    qk_quant_gran: str = "per_token",
    smooth_k: bool = True,
    *,
    window_size: Optional[int] = None,
    sink_size: int = 0,
    return_lse: bool = False,
    kernel_space: str = "auto",
    fuse_quant: Optional[bool] = None,
    interpret: Optional[bool] = None,
):
    """Ragged-batch INT8 attention (reference ``sageattn_varlen``): packed
    ``[total_tokens, H, D]`` inputs with ``cu_seqlens_*`` prefix sums, run as
    one batch of segment ids in kernel A (tokens of different sequences never
    see each other; causal masking within a segment is per-sequence causal
    masking, the sequences being contiguous). Segment ids come from
    ``torch.searchsorted`` on the inputs' device, with no host sync.
    ``window_size``/``sink_size`` count in packed positions (within-sequence
    distances; the sinks are the first packed keys, so only the first
    sequence has them). Smooth-K takes the mean over the whole packed batch,
    as the reference and the JAX package do. ``return_lse`` also returns the
    natural-log LSE ``[H, total_q]``, corrected for smooth-K.

    ``max_seqlen_*``, ``kernel_space``, ``fuse_quant`` and ``interpret`` are
    accepted for parity and change nothing here: kernel A takes the packed
    batch whole, and quantizes Q inside it at per-token granularity
    (externally at per-block). Returns ``o [total_q, H, D]`` in ``v.dtype``.
    """
    if q.dim() != 3 or k.dim() != 3 or v.dim() != 3:
        raise ValueError("varlen q, k and v are packed [total_tokens, H, D]")
    d_og = q.shape[-1]
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d_og)
    qh, kh, vh = (x.transpose(0, 1)[None] for x in (q, k, v))  # [1, H, T, D]

    def segments(cu, n):
        cu = torch.as_tensor(cu, device=q.device)
        return torch.searchsorted(cu[1:].contiguous(), torch.arange(n, device=q.device, dtype=cu.dtype),
                                  right=True).to(torch.int32)[None]

    q_seg, kv_seg = segments(cu_seqlens_q, q.shape[0]), segments(cu_seqlens_k, k.shape[0])
    qp, kp = _pad_head_dim(qh), _pad_head_dim(kh)
    km = quant_ops.k_mean(kp) if smooth_k else None
    gk, bk = _gran_block(qk_quant_gran, "k")
    k_codes, k_scale = quant_ops.quant_int8(kp, km, gran=gk, block=bk)
    q_in, q_scale = _quant_q(qp, qk_quant_gran)
    out = lowbit_attention(
        q_in, k_codes, _pad_head_dim(vh), q_scale, k_scale, q_segment_ids=q_seg, kv_segment_ids=kv_seg,
        is_causal=is_causal, window_size=window_size, sink_size=sink_size, sm_scale=sm_scale, out_dtype=v.dtype,
        return_lse=return_lse,
    )
    o = (out[0] if return_lse else out)[0, :, :, :d_og].transpose(0, 1)
    if return_lse:
        return o, _finish_lse(out[1], qp, km, sm_scale)[0]
    return o


def compute_scale(x: torch.Tensor) -> torch.Tensor:
    """Per-tensor absmax scale ``max|x| / 127`` the selector averages
    (reference ``compute_scale``)."""
    return x.float().abs().amax() / 127.0


def select_quantization(q: torch.Tensor, k: torch.Tensor, *, fp16_threshold=0.2, int8_threshold=0.05) -> str:
    """Pick a precision from the average scale, with the reference's
    thresholds: above 0.2 fp16, above 0.05 int8, else int4. Reads the
    statistic on the host (one device sync)."""
    avg = float((compute_scale(q) + compute_scale(k)) / 2.0)
    if avg > fp16_threshold:
        return "fp16"
    if avg > int8_threshold:
        return "int8"
    return "int4"


def lowbit_fa_multi_precision_jit(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    tensor_layout: str = "HND",
    is_causal: bool = False,
    sm_scale: Optional[float] = None,
    window_size: Optional[int] = None,
    sink_size: int = 0,
    fp16_threshold: float = 0.2,
    int8_threshold: float = 0.05,
    interpret: Optional[bool] = None,
):
    """Multi-precision dispatch with settable thresholds. The TPU package
    compiles all three branches and picks one on the device inside ``jit``;
    PyTorch runs eagerly, so this is the same host-side dispatch as
    :func:`lowbit_fa_multi_precision`."""
    choice = select_quantization(q, k, fp16_threshold=fp16_threshold, int8_threshold=int8_threshold)
    kw = dict(tensor_layout=tensor_layout, is_causal=is_causal, window_size=window_size, sink_size=sink_size,
              sm_scale=sm_scale)
    if choice == "fp16":
        qh, kh, vh = (_to_hnd(x, tensor_layout) for x in (q, k, v))
        o = flash_attention_fp(qh, kh, vh, is_causal=is_causal, window_size=window_size, sink_size=sink_size,
                               sm_scale=sm_scale)
        return _from_hnd(o.to(v.dtype), tensor_layout)
    if choice == "int8":
        return lowbit_fa_qk_int8_pv_fp16(q, k, v, **kw)
    return lowbit_fa_qk_int4_pv_fp16(q, k, v, **kw)


def lowbit_fa_multi_precision(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    tensor_layout: str = "HND",
    is_causal: bool = False,
    sm_scale: Optional[float] = None,
    window_size: Optional[int] = None,
    sink_size: int = 0,
    interpret: Optional[bool] = None,
):
    """Bit allocation at the call (reference ``sageattn_multi_precision``):
    from the tensors' scales, fp16 (the bf16 FA-2 baseline), int8 or int4,
    decided on the host. Every branch honours the layout and the mask."""
    return lowbit_fa_multi_precision_jit(
        q, k, v, tensor_layout=tensor_layout, is_causal=is_causal, sm_scale=sm_scale,
        window_size=window_size, sink_size=sink_size,
    )


def lowbit_fa_attn(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    tensor_layout: str = "HND",
    is_causal: bool = False,
    sm_scale: Optional[float] = None,
    return_lse: bool = False,
    *,
    bits: str = "int8",
    **kwargs,
):
    """Dispatching entry point (reference ``sageattn``), by ``bits``:
    ``"int8"`` (INT8 QK, bf16 PV), ``"int8_v8"`` (INT8 QK, INT8 V),
    ``"int4"`` / ``"int2"`` (INT8 Q × packed INT4 / INT2 K), ``"fp"`` (the
    bf16 FA-2 baseline) or ``"auto"`` (:func:`lowbit_fa_multi_precision`,
    which returns no LSE). With ``return_lse`` the others return the
    natural-log LSE."""
    if bits == "auto":
        if return_lse:
            raise ValueError("bits='auto' does not export the LSE (pick a bits mode)")
        return lowbit_fa_multi_precision(
            q, k, v, tensor_layout=tensor_layout, is_causal=is_causal, sm_scale=sm_scale,
            window_size=kwargs.pop("window_size", None), sink_size=kwargs.pop("sink_size", 0),
        )
    entry = {
        "int8": lowbit_fa_qk_int8_pv_fp16, "int8_v8": lowbit_fa_qk_int8_pv_int8,
        "int4": lowbit_fa_qk_int4_pv_fp16, "int2": lowbit_fa_qk_int2_pv_fp16,
    }.get(bits)
    if entry is not None:
        return entry(q, k, v, tensor_layout=tensor_layout, is_causal=is_causal, sm_scale=sm_scale,
                     return_lse=return_lse, **kwargs)
    if bits == "fp":
        qh, kh, vh = (_to_hnd(x, tensor_layout) for x in (q, k, v))
        out = flash_attention_fp(qh, kh, vh, is_causal=is_causal, sm_scale=sm_scale, return_lse=return_lse, **kwargs)
        if return_lse:
            o, lse2 = out
            return _from_hnd(o.to(v.dtype), tensor_layout), lse2 / LOG2E
        return _from_hnd(out.to(v.dtype), tensor_layout)
    raise ValueError(f"unknown bits {bits!r}")


def manual_scaled_dot_product_attention(q, k, v, *, is_causal=False, sm_scale=None, tensor_layout="HND"):
    """Naive exact attention (reference src/core.py:46-71)."""
    qh, kh, vh = (_to_hnd(x, tensor_layout) for x in (q, k, v))
    return _from_hnd(attention_reference(qh, kh, vh, is_causal=is_causal, sm_scale=sm_scale), tensor_layout)


# Legacy reference names: the *_triton / *_cuda suffixes select the
# quantization granularity of the same accuracy class (per_block ≙ the
# triton kernels, per_token ≙ the per-warp/per-thread CUDA kernels).
sageattn = lowbit_fa_attn


def sageattn_qk_int8_pv_fp16_triton(q, k, v, **kw):
    kw.setdefault("qk_quant_gran", "per_block")
    return lowbit_fa_qk_int8_pv_fp16(q, k, v, **kw)


def sageattn_qk_int8_pv_fp16_cuda(q, k, v, **kw):
    kw.setdefault("qk_quant_gran", "per_token")
    return lowbit_fa_qk_int8_pv_fp16(q, k, v, **kw)


def sageattn_qk_int8_pv_fp8_cuda(q, k, v, **kw):
    """The reference's FP8-PV kernel maps to INT8 V, as in the TPU package."""
    return lowbit_fa_qk_int8_pv_int8(q, k, v, **kw)


def sageattn_qk_int4_pv_fp16_triton(q, k, v, **kw):
    return lowbit_fa_qk_int4_pv_fp16(q, k, v, **kw)


sageattn_varlen = lowbit_fa_varlen
sageattn_multi_precision = lowbit_fa_multi_precision
lowbit_fa_qk_int8_pv_fp16_triton = sageattn_qk_int8_pv_fp16_triton
lowbit_fa_qk_int8_pv_fp16_cuda = sageattn_qk_int8_pv_fp16_cuda
lowbit_fa_qk_int8_pv_fp8_cuda = sageattn_qk_int8_pv_fp8_cuda
lowbit_fa_qk_int4_pv_fp16_triton = sageattn_qk_int4_pv_fp16_triton
