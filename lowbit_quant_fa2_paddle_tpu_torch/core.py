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
per-block granularity.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from lowbit_quant_fa2_paddle_tpu_torch.ops import quant as quant_ops
from lowbit_quant_fa2_paddle_tpu_torch.ops.attention import (
    LOG2E,
    _not_ported,
    flash_attention_fp,
    lowbit_attention,
)
from lowbit_quant_fa2_paddle_tpu_torch.ops.reference import _repeat_kv, attention_reference

__all__ = [
    "lowbit_fa_attn",
    "lowbit_fa_qk_int8_pv_fp16",
    "lowbit_fa_qk_int8_pv_fp16_triton",
    "lowbit_fa_qk_int8_pv_fp16_cuda",
    "sageattn",
    "sageattn_qk_int8_pv_fp16_triton",
    "sageattn_qk_int8_pv_fp16_cuda",
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
    operands with an fp32 accumulator; "fp32+fp32" (fp32 operands) is not
    ported yet. ``smooth_q`` needs the bias path and is not ported yet.
    """
    if smooth_q:
        raise _not_ported("smooth_q (per-key bias)", "3f")
    if pv_accum_dtype == "fp32+fp32":
        raise _not_ported("pv_accum_dtype='fp32+fp32'", "3g")
    if pv_accum_dtype not in ("fp16", "fp16+fp32", "fp32"):
        raise ValueError(f"unknown pv_accum_dtype {pv_accum_dtype!r}")
    q, k, v = (_to_hnd(x, tensor_layout) for x in (q, k, v))
    d_og = q.shape[-1]
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d_og)
    qp, kp = _pad_head_dim(q), _pad_head_dim(k)

    km = quant_ops.k_mean(kp) if smooth_k else None
    gq, bq = _gran_block(qk_quant_gran, "q")
    gk, bk = _gran_block(qk_quant_gran, "k")
    k_codes, k_scale = quant_ops.quant_int8(kp, km, gran=gk, block=bk)
    if gq == "per_token":
        q_in, q_scale = qp, None  # quantized per token inside the kernel
    else:
        q_in, q_scale = quant_ops.quant_int8(qp, gran=gq, block=bq)
    v_in, v_mean = v, None
    if smooth_v:
        v_mean = v.float().mean(dim=2)  # [B, Hk, D]
        v_in = (v.float() - v_mean[:, :, None, :]).to(v.dtype)
        v_mean = _pad_head_dim(v_mean)
    out = lowbit_attention(
        q_in, k_codes, _pad_head_dim(v_in), q_scale, k_scale,
        v_mean=v_mean, is_causal=is_causal, window_size=window_size, sink_size=sink_size,
        sm_scale=sm_scale, out_dtype=v.dtype, return_lse=return_lse,
    )
    if return_lse:
        o, lse2 = out
        return _from_hnd(o[..., :d_og], tensor_layout), _finish_lse(lse2, qp, km, sm_scale)
    return _from_hnd(out[..., :d_og], tensor_layout)


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
    ``"int8"`` (INT8 QK, bf16 PV) or ``"fp"`` (the bf16 FA-2 baseline).
    With ``return_lse`` both return the natural-log LSE."""
    if bits == "int8":
        return lowbit_fa_qk_int8_pv_fp16(
            q, k, v, tensor_layout=tensor_layout, is_causal=is_causal,
            sm_scale=sm_scale, return_lse=return_lse, **kwargs
        )
    if bits == "fp":
        qh, kh, vh = (_to_hnd(x, tensor_layout) for x in (q, k, v))
        out = flash_attention_fp(qh, kh, vh, is_causal=is_causal, sm_scale=sm_scale, return_lse=return_lse, **kwargs)
        if return_lse:
            o, lse2 = out
            return _from_hnd(o.to(v.dtype), tensor_layout), lse2 / LOG2E
        return _from_hnd(out.to(v.dtype), tensor_layout)
    if bits in ("auto", "int8_v8", "int4", "int2"):
        item = {"auto": "4", "int8_v8": "3d", "int4": "3e", "int2": "3e"}[bits]
        raise _not_ported(f"bits={bits!r}", item)
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


lowbit_fa_qk_int8_pv_fp16_triton = sageattn_qk_int8_pv_fp16_triton
lowbit_fa_qk_int8_pv_fp16_cuda = sageattn_qk_int8_pv_fp16_cuda
