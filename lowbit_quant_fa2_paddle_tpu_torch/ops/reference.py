"""Reference oracles: exact fp32 attention and quantization round-trip math.

PyTorch counterpart of ``lowbit_quant_fa2_paddle_tpu/ops/reference.py``: the
same plain math, on tensors. These functions are the oracle every kernel of
the port is held against.

Layout convention: all functions here take **HND** tensors ``[B, H, S, D]``.
Scales follow the same convention with the quantized axis reduced away.

fp32 matmuls on a CUDA card must run in full fp32 for these to be exact
references: callers keep ``torch.backends.cuda.matmul.allow_tf32`` False
(PyTorch's default).
"""

from __future__ import annotations

import math
from typing import Optional

import torch

LOG2E = math.log2(math.e)  # 1.4426950408889634
#: Mask additive constant. Not -inf: exp(-inf - -inf) = NaN in online softmax.
DEFAULT_MASK_VALUE = -0.7 * torch.finfo(torch.float32).max


# ---------------------------------------------------------------------------
# Exact attention oracle
# ---------------------------------------------------------------------------


def _repeat_kv(x: torch.Tensor, h_q: int) -> torch.Tensor:
    """GQA: KV head ``j`` serves query heads ``j*g .. j*g+g-1``."""
    h_kv = x.shape[1]
    if h_kv == h_q:
        return x
    if h_q % h_kv:
        raise ValueError(f"query heads {h_q} not a multiple of kv heads {h_kv}")
    return x.repeat_interleave(h_q // h_kv, dim=1)


def attention_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    is_causal: bool = False,
    window_size: Optional[int] = None,
    sink_size: int = 0,
    sm_scale: Optional[float] = None,
    q_segment_ids: Optional[torch.Tensor] = None,
    kv_segment_ids: Optional[torch.Tensor] = None,
    logit_cap: Optional[float] = None,
    return_lse: bool = False,
):
    """Exact fp32 scaled-dot-product attention on HND ``[B, H, S, D]`` inputs.

    Supports GQA (``k``/``v`` may have fewer heads), causal masking (key
    ``c`` visible to query ``r`` iff ``c <= r``), a causal sliding window of
    ``window_size`` keys including self plus ``sink_size`` always-visible
    leading keys, segment-id masking and tanh logit capping.

    Returns ``o`` (same dtype as ``q``) and, when ``return_lse``, the
    natural-log logsumexp of the scaled logits per row, ``[B, H, Sq]``.
    """
    _, h_q, s_q, d = q.shape
    s_k = k.shape[2]
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)

    qf = q.float()
    kf = _repeat_kv(k.float(), h_q)
    vf = _repeat_kv(v.float(), h_q)

    logits = torch.einsum("bhqd,bhkd->bhqk", qf, kf) * sm_scale
    if logit_cap is not None and logit_cap > 0:
        logits = logit_cap * torch.tanh(logits / logit_cap)

    mask = None
    if is_causal:
        row = torch.arange(s_q, device=q.device)[:, None]
        col = torch.arange(s_k, device=q.device)[None, :]
        mask = col <= row
        if window_size is not None:
            inw = col + window_size > row
            if sink_size > 0:
                inw = inw | (col < sink_size)
            mask = mask & inw
        mask = mask[None, None]
    if q_segment_ids is not None:
        if kv_segment_ids is None:
            raise ValueError("q_segment_ids needs kv_segment_ids")
        seg = q_segment_ids[:, None, :, None] == kv_segment_ids[:, None, None, :]
        mask = seg if mask is None else mask & seg
    if mask is not None:
        logits = torch.where(mask, logits, torch.full_like(logits, DEFAULT_MASK_VALUE))

    m = logits.amax(dim=-1, keepdim=True)
    p = torch.exp(logits - m)
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bhqk,bhkd->bhqd", p / l, vf).to(q.dtype)
    if return_lse:
        return o, (m + torch.log(l))[..., 0]
    return o


def attention_reference_chunked(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    is_causal: bool = False,
    sm_scale: Optional[float] = None,
    chunk: int = 1024,
):
    """Memory-bounded exact attention: the math of :func:`attention_reference`
    per q-chunk, so the logits never exceed ``[B, H, chunk, Sk]`` — the oracle
    at sequence lengths where the dense one would need tens of GB."""
    s_q, d = q.shape[2], q.shape[3]
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    kf = _repeat_kv(k.float(), q.shape[1])
    vf = _repeat_kv(v.float(), q.shape[1])
    col = torch.arange(k.shape[2], device=q.device)[None, :]
    out = []
    for lo in range(0, s_q, chunk):
        qc = q[:, :, lo : lo + chunk].float()
        logits = torch.einsum("bhqd,bhkd->bhqk", qc, kf) * sm_scale
        if is_causal:
            row = lo + torch.arange(qc.shape[2], device=q.device)[:, None]
            logits = torch.where(
                col <= row, logits, torch.full_like(logits, DEFAULT_MASK_VALUE)
            )
        m = logits.amax(dim=-1, keepdim=True)
        p = torch.exp(logits - m)
        out.append(torch.einsum("bhqk,bhkd->bhqd", p / p.sum(-1, keepdim=True), vf))
    return torch.cat(out, dim=2).to(q.dtype)


# ---------------------------------------------------------------------------
# Quantization reference math
# ---------------------------------------------------------------------------


def round_away(x: torch.Tensor) -> torch.Tensor:
    """Round half away from zero (``torch.round`` rounds half to even).

    Not ``sign(x) * floor(|x| + 0.5)``: the add rounds 0.49999997 up to 1.
    Ties are found exactly, as a fractional part of 0.5, and moved outward.
    """
    r = torch.round(x)
    t = torch.trunc(x)
    return torch.where((x - t).abs() == 0.5, t + torch.sign(x), r)


def quant_symmetric_ref(
    x: torch.Tensor,
    *,
    bits: int = 8,
    block: int = 0,
    eps: float = 1e-7,
):
    """Symmetric abs-max quantization oracle over HND ``[B, H, S, D]``.

    One scale per ``block`` consecutive seq rows (``block=1`` is per token,
    ``block=0`` per tensor). Returns ``(codes int8, scale)`` with codes in
    ``[-(2^(bits-1)-1), 2^(bits-1)-1]`` and ``scale`` of shape
    ``[B, H, ceil(S/block)]`` (``[B, H, 1]`` per tensor).
    """
    b, h, s, d = x.shape
    qmax = float(2 ** (bits - 1) - 1)
    xf = x.float()
    if block == 0:
        scale = xf.abs().amax(dim=(2, 3), keepdim=True) / qmax + eps
        codes = round_away(xf / scale)
        scale_out = scale[..., 0]
    else:
        nblk = -(-s // block)
        xp = torch.nn.functional.pad(xf, (0, 0, 0, nblk * block - s))
        xb = xp.reshape(b, h, nblk, block, d)
        scale = xb.abs().amax(dim=(3, 4), keepdim=True) / qmax + eps
        codes = round_away(xb / scale).reshape(b, h, nblk * block, d)[:, :, :s]
        scale_out = scale[..., 0, 0]
    return codes.clamp(-qmax, qmax).to(torch.int8), scale_out


def dequant_symmetric_ref(codes: torch.Tensor, scale: torch.Tensor, *, block: int = 0):
    """Inverse of :func:`quant_symmetric_ref`."""
    s = codes.shape[2]
    c = codes.float()
    if block == 0:
        return c * scale[:, :, :, None]
    scale_rows = scale.repeat_interleave(block, dim=2)[:, :, :s]
    return c * scale_rows[..., None]


def quant_group_asym_ref(x: torch.Tensor, *, bits: int, group: int):
    """Asymmetric min/max group quantization oracle along the last dim
    (KIVI convention): ``scale = (max-min)/(2^bits - 1)``,
    ``code = round((x - min)/scale)``.

    Returns ``(codes int32, scale, mn)``; codes in ``[0, 2^bits-1]``.
    """
    *lead, d = x.shape
    if d % group:
        raise ValueError(f"last dim {d} not a multiple of group {group}")
    xg = x.float().reshape(*lead, d // group, group)
    mn = xg.amin(dim=-1, keepdim=True)
    mx = xg.amax(dim=-1, keepdim=True)
    scale = (mx - mn) / (2**bits - 1)
    scale = torch.where(scale == 0, torch.ones_like(scale), scale)
    codes = round_away((xg - mn) / scale).clamp(0, 2**bits - 1).to(torch.int32)
    return codes.reshape(*lead, d), scale[..., 0], mn[..., 0]


def dequant_group_asym_ref(codes: torch.Tensor, scale: torch.Tensor, mn: torch.Tensor, *, group: int):
    *lead, d = codes.shape
    cg = codes.float().reshape(*lead, d // group, group)
    return (cg * scale[..., None] + mn[..., None]).reshape(*lead, d)


# ---------------------------------------------------------------------------
# Smooth-K helper math
# ---------------------------------------------------------------------------


def smooth_k_reference(k: torch.Tensor):
    """Return ``(k - mean, mean)`` with the f32 mean over the sequence axis.

    Subtracting the per-(B,H,D) K mean before quantization removes the shared
    outlier direction (smooth-K); the softmax output is invariant and only the
    LSE shifts, by ``q·kmᵀ·sm_scale``.
    """
    km = k.float().mean(dim=2, keepdim=True)
    return (k.float() - km).to(k.dtype), km


def lse_smooth_k_correction(lse: torch.Tensor, q: torch.Tensor, km: torch.Tensor, sm_scale: float):
    """Correct an LSE computed on smoothed K back to the true LSE:
    ``lse_true = lse_smoothed + (q @ kmᵀ) * sm_scale`` (natural log)."""
    corr = torch.einsum("bhqd,bhkd->bhqk", q.float(), km.float())[..., 0]
    return lse + corr * sm_scale


def attention_quantized_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    q_bits: int = 8,
    k_bits: int = 8,
    block_q: int = 128,
    block_k: int = 64,
    smooth_k: bool = True,
    is_causal: bool = False,
    sm_scale: Optional[float] = None,
):
    """Quantize-then-attend oracle: what a perfect kernel consuming per-block
    quantized Q/K should produce. Separates kernel faults from quantization
    error in tests."""
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    k_s = smooth_k_reference(k)[0] if smooth_k else k
    q_c, q_s = quant_symmetric_ref(q, bits=q_bits, block=block_q)
    k_c, k_s_scale = quant_symmetric_ref(k_s, bits=k_bits, block=block_k)
    q_dq = dequant_symmetric_ref(q_c, q_s, block=block_q)
    k_dq = dequant_symmetric_ref(k_c, k_s_scale, block=block_k)
    return attention_reference(q_dq, k_dq, v, is_causal=is_causal, sm_scale=sm_scale).to(q.dtype)
