"""FlashAttention-2 backward (kernels G1 and G2) and the trainable attention
functions.

PyTorch/CUDA counterpart of ``lowbit_quant_fa2_paddle_tpu/ops/attention_bwd.py``.
From the forward's residuals ``(q, k, v, o, lse2)`` (``lse2`` the base-2 LSE)
and ``di = rowsum(dO·O)``:

  p  = exp2(s2 - lse2)            s2 = q·k · sm_scale·log2(e)
  dv = p^T dO,  dp = dO V^T,  ds = p · (dp - di) · sm_scale
  dq = ds K    (G1),   dk = ds^T Q   (G2, summed over each KV head's group)

G1 and G2 run on the Hopper design of ``csrc/attention_bwd_wgmma.cu`` (TMA,
``wgmma``, warp-specialised; ``kernel_design``), whose note says what bounds
them on the H100; its head_dim-256 instances are
``csrc/attention_bwd_wgmma_d256.cu``'s (head dims 129-255 padded to 256).
Their operands are bf16 (f32 inputs are rounded to bf16 for
the tensor cores, as kernel A does) or, with ``quantized``, int8 per-token
codes from kernel C1 with the dequant scales folded into the per-pair chain,
as in the TPU kernels. ``p`` and ``ds`` are f32 and round to bf16 only as
operands of the products, and come from the final LSE, so no tile enters the
rounding: the kernels differ from the plain version in summation order alone.
Causal masking is top-left aligned; a causal ``window`` keeps keys ``c`` with
``c + window > r``.

:func:`flash_bwd` takes the plain PyTorch version below for tensors on the
CPU and launches G1 then G2 (``attention_bwd_dq``, ``attention_bwd_dkv``,
each counting its launches) for CUDA tensors; nothing falls back.
:func:`flash_attention_trainable` and :func:`lowbit_attention_trainable` are
``torch.autograd.Function``\\ s whose backward is :func:`flash_bwd`.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from lowbit_quant_fa2_paddle_tpu_torch.core import lowbit_fa_qk_int8_pv_fp16
from lowbit_quant_fa2_paddle_tpu_torch.ops import _build
from lowbit_quant_fa2_paddle_tpu_torch.ops.attention import LOG2E, MASK_VALUE, flash_attention_fp, kernel_dim
from lowbit_quant_fa2_paddle_tpu_torch.ops.quant import quant_int8
from lowbit_quant_fa2_paddle_tpu_torch.ops.reference import _repeat_kv

#: Elements of one chunk of f32 logits in the plain version (1 GiB).
_PLAIN_CHUNK_ELEMS = 1 << 28
#: The designs of G1/G2: one, on Hopper's TMA and ``wgmma``.
DESIGNS = ("wgmma",)


def kernel_design(quantized: bool = False) -> str:
    """Which design of G1/G2 runs a mode: ``"wgmma"`` for bf16 operands and
    for int8 codes alike."""
    return "wgmma"


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).float()


def attention_bwd_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    do: torch.Tensor,
    lse2: torch.Tensor,
    di: torch.Tensor,
    q_scale: Optional[torch.Tensor] = None,
    k_scale: Optional[torch.Tensor] = None,
    v_scale: Optional[torch.Tensor] = None,
    do_scale: Optional[torch.Tensor] = None,
    *,
    causal: bool,
    window: int = 0,
    scale2: float,
    ds_scale: float,
    dq_dtype: torch.dtype,
    dkv_dtype: torch.dtype,
):
    """Plain PyTorch version of G1 and G2 together, on the kernels' own inputs:
    ``q``, ``do`` ``[B,H,Sq,D]`` and ``k``, ``v`` ``[B,Hk,Sk,D]``, bf16 or int8
    codes with per-row scales (``q_scale``/``do_scale`` ``[B,H,Sq]``,
    ``k_scale``/``v_scale`` ``[B,Hk,Sk]``); ``lse2`` and ``di`` ``[B,H,Sq]``
    f32. Works through q-row chunks so the f32 logits stay within 1 GiB. ``p``
    and ``ds`` round to bf16 where the kernels round them, so on the card the
    two differ only in summation order. Returns ``(dq, dk, dv)``."""
    b, h, s_q, d = q.shape
    hk, s_k = k.shape[1], k.shape[2]
    g = h // hk
    dev = q.device
    quant = q.dtype == torch.int8
    c2 = torch.tensor(scale2, dtype=torch.float32, device=dev)
    cds = torch.tensor(ds_scale, dtype=torch.float32, device=dev)
    kf = _repeat_kv(k, h).float()
    vf = _repeat_kv(v, h).float()
    ks = _repeat_kv(k_scale.float()[:, :, None, :], h) if quant else None
    vs = _repeat_kv(v_scale.float()[:, :, None, :], h) if quant else None
    col = torch.arange(s_k, device=dev)
    dq = torch.empty((b, h, s_q, d), dtype=torch.float32, device=dev)
    dk = torch.zeros((b, h, s_k, d), dtype=torch.float32, device=dev)
    dv = torch.zeros((b, h, s_k, d), dtype=torch.float32, device=dev)
    rows = max(1, _PLAIN_CHUNK_ELEMS // (b * h * s_k))
    for lo in range(0, s_q, rows):
        sl = slice(lo, lo + rows)
        qc, doc = q[:, :, sl].float(), do[:, :, sl].float()
        # bf16 or integer-valued f32 products (exact while |sum| < 2^24).
        s = qc @ kf.transpose(-1, -2)
        dp = doc @ vf.transpose(-1, -2)
        if quant:
            qs = q_scale[:, :, sl].float()[..., None]
            dos = do_scale[:, :, sl].float()[..., None]
            s2 = (s * (qs * c2)) * ks
            dp = (dp * dos) * vs
        else:
            s2 = s * c2
        del s
        if causal:
            row = lo + torch.arange(qc.shape[2], device=dev)[:, None]
            keep = col[None, :] <= row
            if window > 0:
                keep = keep & (col[None, :] + window > row)
            s2 = s2.masked_fill(~keep, MASK_VALUE)
        p = torch.exp2(s2 - lse2[:, :, sl, None].float())
        del s2
        ds = (p * (dp - di[:, :, sl, None].float())) * cds
        del dp
        dq[:, :, sl] = _bf16(ds * ks if quant else ds) @ _bf16(kf)
        dv += _bf16(p * dos if quant else p).transpose(-1, -2) @ _bf16(doc)
        dk += _bf16(ds * qs if quant else ds).transpose(-1, -2) @ _bf16(qc)
        del p, ds
    dk = dk.view(b, hk, g, s_k, d).sum(dim=2)
    dv = dv.view(b, hk, g, s_k, d).sum(dim=2)
    return dq.to(dq_dtype), dk.to(dkv_dtype), dv.to(dkv_dtype)


def _check_kernel_inputs(q, k, v, do, lse2, di, scales):
    b, h, s_q, d = q.shape
    hk, s_k = k.shape[1], k.shape[2]
    if d not in (64, 128, 256):
        raise ValueError(f"G1/G2 take head_dim 64, 128 or 256 (pad first), got {d}")
    if b > 65535 or h > 65535:
        raise ValueError(f"batch and heads are CUDA grid dims (at most 65535): {b}, {h}")
    quant = q.dtype == torch.int8
    want = torch.int8 if quant else torch.bfloat16
    tensors = [q, k, v, do, lse2, di] + [x for x in scales if x is not None]
    if any(x.dtype != want for x in (q, k, v, do)):
        raise TypeError(f"G1/G2 take q, k, v, dO all {want}")
    if quant and any(x is None for x in scales):
        raise ValueError("int8 codes need all four scales")
    if any(x.device.type != "cuda" or x.device != q.device for x in tensors):
        raise ValueError("G1/G2 inputs must all be on one CUDA device")
    if any(not x.is_contiguous() or x.data_ptr() % 16 for x in (q, k, v, do)):
        raise ValueError("G1/G2 take contiguous, 16-byte aligned q, k, v, dO")
    if any(x.dtype != torch.float32 or not x.is_contiguous() for x in tensors[4:]):
        raise ValueError("lse2, di and the scales must be contiguous f32")


def _launch(parts, q, k, v, do, lse2, di, scales, *, causal, window, scale2, ds_scale, dq_dtype, dkv_dtype):
    _check_kernel_inputs(q, k, v, do, lse2, di, scales)
    quant = q.dtype == torch.int8
    b, h, s_q, d = q.shape
    hk, s_k = k.shape[1], k.shape[2]
    out = lambda dt: torch.float32 if dt == torch.float32 else torch.bfloat16  # noqa: E731
    dq = torch.empty((b, h, s_q, d), dtype=out(dq_dtype), device=q.device) if parts & 1 else None
    dk = torch.empty((b, hk, s_k, d), dtype=out(dkv_dtype), device=q.device) if parts & 2 else None
    dv = torch.empty_like(dk) if parts & 2 else None
    ptrs = [x.data_ptr() if x is not None else None for x in (q, k, v, do, lse2, di, *scales, dq, dk, dv)]
    lib = _build.library()
    with torch.cuda.device(q.device):
        err = lib.lowbit_attn_bwd_wgmma(
            *ptrs,
            b, h, hk, s_q, s_k, d, int(quant), int(causal), int(window),
            int(dq_dtype == torch.float32), int(dkv_dtype == torch.float32), parts, scale2, ds_scale,
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    _build.check(err, "attention_bwd")
    return dq, dk, dv, kernel_design(quant)


def attention_bwd_dq(q, k, v, do, lse2, di, q_scale=None, k_scale=None, v_scale=None, do_scale=None, *, causal,
                     window=0, scale2, ds_scale, dq_dtype):
    """Kernel G1 on CUDA tensors: ``dq`` from the operands
    :func:`bwd_operands` forms (contiguous, head_dim 64, 128 or 256). Returns
    ``dq`` in ``dq_dtype`` (the kernel writes bf16 or f32; other types are
    cast)."""
    dq, _, _, design = _launch(1, q, k, v, do, lse2, di, (q_scale, k_scale, v_scale, do_scale), causal=causal,
                               window=window, scale2=scale2, ds_scale=ds_scale, dq_dtype=dq_dtype, dkv_dtype=dq_dtype)
    attention_bwd_dq.launches += 1
    attention_bwd_dq.launches_by_design[design] += 1
    attention_bwd_dq.launches_by_dim[q.shape[-1]] += 1
    return dq.to(dq_dtype)


def attention_bwd_dkv(q, k, v, do, lse2, di, q_scale=None, k_scale=None, v_scale=None, do_scale=None, *, causal,
                      window=0, scale2, ds_scale, dkv_dtype):
    """Kernel G2 on CUDA tensors: ``(dk, dv)``, summed over each KV head's
    group, from the operands :func:`attention_bwd_dq` takes."""
    _, dk, dv, design = _launch(2, q, k, v, do, lse2, di, (q_scale, k_scale, v_scale, do_scale), causal=causal,
                                window=window, scale2=scale2, ds_scale=ds_scale, dq_dtype=dkv_dtype,
                                dkv_dtype=dkv_dtype)
    attention_bwd_dkv.launches += 1
    attention_bwd_dkv.launches_by_design[design] += 1
    attention_bwd_dkv.launches_by_dim[q.shape[-1]] += 1
    return dk.to(dkv_dtype), dv.to(dkv_dtype)


#: Launches of kernels G1 and G2 in this process (CPU calls do not count), in
#: all, per design and per kernel head dim (the head_dim-256 instances live in
#: their own source).
attention_bwd_dq.launches = 0
attention_bwd_dkv.launches = 0
attention_bwd_dq.launches_by_design = {design: 0 for design in DESIGNS}
attention_bwd_dkv.launches_by_design = {design: 0 for design in DESIGNS}
attention_bwd_dq.launches_by_dim = {d: 0 for d in (64, 128, 256)}
attention_bwd_dkv.launches_by_dim = {d: 0 for d in (64, 128, 256)}


def bwd_operands(q, k, v, o, lse2, do, *, is_causal: bool, sm_scale: float, quantized: bool = False, window: int = 0):
    """What G1/G2 and :func:`attention_bwd_plain` take, from the backward's
    inputs: bf16 ``q, k, v, dO`` (f32 inputs rounded for the tensor cores)
    or, with ``quantized``, their per-token INT8 codes and scales from kernel
    C1 (no K mean; four C1 launches on the card); ``lse2`` in f32 and
    ``di = rowsum(o·do)`` in f32, which JAX also computes outside its
    kernels. Returns ``(args, kwargs)``."""
    di = (o.float() * do.float()).sum(dim=-1)
    if quantized:
        (q, qs), (k, ks), (v, vs), (do, dos) = (quant_int8(x, gran="per_token") for x in (q, k, v, do))
        scales = (qs, ks, vs, dos)
    else:
        q, k, v, do = (x.to(torch.bfloat16) for x in (q, k, v, do))
        scales = (None,) * 4
    scale2 = float(sm_scale) * LOG2E
    kw = dict(causal=bool(is_causal), window=int(window) if is_causal and window else 0, scale2=scale2,
              ds_scale=scale2 / LOG2E)
    return (q, k, v, do, lse2.float(), di, *scales), kw


def _attention_bwd_cuda(q, k, v, do, lse2, di, *scales, causal, window, scale2, ds_scale, dq_dtype, dkv_dtype):
    """Launch G1, then G2. Head dims below 64, 128 or 256 are zero-padded to
    the next of them (``kernel_dim``, which refuses above 256): zero columns
    of q, k, v and dO leave every product (and the codes' scales)
    unchanged, and the padded columns of dq, dk and dv are sliced off."""
    d = q.shape[-1]
    dp = kernel_dim(d)
    if dp != d:
        q, k, v, do = (torch.nn.functional.pad(x, (0, dp - d)) for x in (q, k, v, do))
    # TMA and the kernels' row loads move 16-byte chunks: rows must start on 16-byte boundaries.
    q, k, v, do = (x if x.is_contiguous() and x.data_ptr() % 16 == 0 else x.clone(memory_format=torch.contiguous_format)
                   for x in (q, k, v, do))
    lse2, di = lse2.contiguous(), di.contiguous()
    scales = tuple(x.float().contiguous() if x is not None else None for x in scales)
    kw = dict(causal=causal, window=window, scale2=scale2, ds_scale=ds_scale)
    dq = attention_bwd_dq(q, k, v, do, lse2, di, *scales, **kw, dq_dtype=dq_dtype)
    dk, dv = attention_bwd_dkv(q, k, v, do, lse2, di, *scales, **kw, dkv_dtype=dkv_dtype)
    return dq[..., :d], dk[..., :d], dv[..., :d]


def flash_bwd(q, k, v, o, lse2, do, *, is_causal: bool, sm_scale: float, quantized: bool = False, window: int = 0):
    """FA-2 backward (counterpart of the TPU package's ``_flash_bwd``):
    ``q`` ``[B,H,Sq,D]``, ``k``/``v`` ``[B,Hk,Sk,D]``, the forward's ``o`` and
    base-2 ``lse2`` ``[B,H,Sq]``, the cotangent ``do``. Returns
    ``(dq, dk, dv)`` in q's and k's dtypes. With ``quantized`` the QK^T and
    dO·V^T products run on per-token INT8 codes of q, k, v and dO (kernel
    C1, no K mean). ``window`` (causal only) keeps keys ``c`` with
    ``c + window > r``."""
    b, h, s_q, d = q.shape
    if k.dim() != 4 or tuple(v.shape) != tuple(k.shape) or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"k and v must be [B, Hk, Sk, D]: {tuple(k.shape)}, {tuple(v.shape)}")
    hk, s_k = k.shape[1], k.shape[2]
    if hk == 0 or h % hk:
        raise ValueError(f"query heads {h} not a multiple of kv heads {hk}")
    if tuple(o.shape) != tuple(q.shape) or tuple(do.shape) != tuple(q.shape) or tuple(lse2.shape) != (b, h, s_q):
        raise ValueError("o and do must be [B, H, Sq, D] and lse2 [B, H, Sq]")
    if s_q < 1 or s_k < 1:
        raise ValueError("need at least one query and one key")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"flash_bwd runs on cpu or cuda tensors, not {q.device}")
    args, kw = bwd_operands(q, k, v, o, lse2, do, is_causal=is_causal, sm_scale=sm_scale, quantized=quantized,
                            window=window)
    out = dict(dq_dtype=q.dtype, dkv_dtype=k.dtype)
    if q.device.type == "cpu":
        return attention_bwd_plain(*args, **kw, **out)
    return _attention_bwd_cuda(*args, **kw, **out)


def _sm_scale(sm_scale: Optional[float], q: torch.Tensor) -> float:
    return 1.0 / math.sqrt(q.shape[-1]) if sm_scale is None else float(sm_scale)


class _FlashAttentionFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, is_causal, sm_scale, window_size):
        o, lse2 = flash_attention_fp(q, k, v, is_causal=is_causal, window_size=window_size, sm_scale=sm_scale,
                                     return_lse=True)
        o = o.to(q.dtype)
        ctx.save_for_backward(q, k, v, o, lse2)
        ctx.is_causal, ctx.sm_scale, ctx.window = is_causal, sm_scale, int(window_size) if window_size else 0
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse2 = ctx.saved_tensors
        dq, dk, dv = flash_bwd(q, k, v, o, lse2, do, is_causal=ctx.is_causal, sm_scale=_sm_scale(ctx.sm_scale, q),
                               window=ctx.window)
        return dq, dk, dv, None, None, None


class _LowbitAttentionFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, is_causal, sm_scale, bwd_quantized, window_size):
        o, lse = lowbit_fa_qk_int8_pv_fp16(q, k, v, is_causal=is_causal, window_size=window_size, sm_scale=sm_scale,
                                           return_lse=True)
        o = o.to(q.dtype)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.is_causal, ctx.sm_scale, ctx.bwd_quantized = is_causal, sm_scale, bwd_quantized
        ctx.window = int(window_size) if window_size else 0
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        lse2 = lse.float() * LOG2E  # natural log -> base 2 for G1/G2
        dq, dk, dv = flash_bwd(q, k, v, o, lse2, do, is_causal=ctx.is_causal, sm_scale=_sm_scale(ctx.sm_scale, q),
                               quantized=ctx.bwd_quantized, window=ctx.window)
        return dq, dk, dv, None, None, None, None


def flash_attention_trainable(q, k, v, is_causal=False, sm_scale=None, block_q=None, block_kv=None,
                              window_size=None):
    """Differentiable FA-2 (bf16/f32), GQA included: the forward is
    ``flash_attention_fp(..., return_lse=True)`` on kernel A, the backward G1
    and G2 on the saved ``(q, k, v, o, lse2)``. Returns ``o`` in q's dtype.
    ``block_q``/``block_kv`` are accepted for parity and change nothing on
    the GPU: the tiles are the kernels' own (the TPU package's tuned backward
    blocks are a TPU table). ``window_size`` (causal only) trains a
    sliding-window model: kernel A's band in the forward, G1/G2 masking the
    same ``(r - window, r]`` keys in the backward."""
    return _FlashAttentionFn.apply(q, k, v, bool(is_causal), sm_scale, window_size)


def lowbit_attention_trainable(q, k, v, is_causal=False, sm_scale=None, block_q=None, block_kv=None,
                               bwd_quantized=False, window_size=None):
    """Differentiable INT8-QK attention (quantization-aware training): the
    forward is the serving path ``lowbit_fa_qk_int8_pv_fp16(...,
    return_lse=True)`` (smooth-K, C1, A), whose natural-log LSE is already
    corrected for smooth-K; the backward turns it to base 2 and runs G1/G2
    straight through the quantizer. ``bwd_quantized`` runs the backward's
    QK^T and dO·V^T on INT8 codes (four more C1 launches). ``block_q``,
    ``block_kv`` and ``window_size`` as in :func:`flash_attention_trainable`."""
    return _LowbitAttentionFn.apply(q, k, v, bool(is_causal), sm_scale, bool(bwd_quantized), window_size)
