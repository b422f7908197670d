"""INT8 quantization feeding the low-bit attention kernel (kernel C1).

PyTorch/CUDA counterpart of ``lowbit_quant_fa2_paddle_tpu/ops/quant.py``:
``quant_int8`` (per-token or per-block absmax INT8 with fused K-mean
subtraction) and ``k_mean``. The CUDA kernel is ``csrc/quant_int8.cu``; its
source note says what bounds it on the H100 and how the design answers.

Scale convention: scales come back as per-token rows ``[B, H, S]`` (per-block
granularity repeats the block scalar across its rows), so the attention
kernel has one interface for every granularity.

``quant_int8`` takes the plain PyTorch version below for a tensor on the CPU
and launches the kernel for a CUDA tensor. There is no fallback between the
two: a CUDA tensor that the kernel cannot take raises.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from lowbit_quant_fa2_paddle_tpu_torch.ops import _build
from lowbit_quant_fa2_paddle_tpu_torch.ops.reference import round_away

INT8_QMAX = 127.0
EPS = 1e-7

# f32 values of 1/127 and EPS: the JAX kernel's ``amax / 127 + EPS`` compiles
# (XLA) to ``fma(amax, f32(1/127), f32(EPS))``, one rounding. The plain
# version forms the exact product in f64 and rounds the sum once more to f32,
# which equals the fma except when the f64 sum lands exactly on an f32
# rounding midpoint.
_RECIP127_F32 = torch.tensor(1.0 / INT8_QMAX, dtype=torch.float32).item()
_EPS_F32 = torch.tensor(EPS, dtype=torch.float32).item()

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def absmax_scale(amax: torch.Tensor) -> torch.Tensor:
    """``amax / 127 + EPS`` in the JAX kernel's rounding (see above)."""
    return (amax.double() * _RECIP127_F32 + _EPS_F32).float()


def quant_codes(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """``clamp(round_half_away(x / scale), ±127)`` as int8; IEEE division."""
    return round_away(x / scale).clamp(-INT8_QMAX, INT8_QMAX).to(torch.int8)


def k_mean(k: torch.Tensor) -> torch.Tensor:
    """Per-(B,H,D) mean of K over the sequence axis, ``[B,H,1,D]`` f32."""
    return k.float().mean(dim=2, keepdim=True)


def quant_int8_plain(
    x: torch.Tensor, km: Optional[torch.Tensor], *, per_token: bool, block: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of kernel C1 (same semantics, bit for bit)."""
    b, h, s, d = x.shape
    xf = x.float()
    if per_token:
        if km is not None:
            xf = xf - km.float()
        scale = absmax_scale(xf.abs().amax(dim=-1, keepdim=True))
        return quant_codes(xf, scale), scale[..., 0]
    nblk = cdiv(s, block)
    # Rows past S are zeros before the K-mean subtraction, as in the kernel.
    xp = torch.nn.functional.pad(xf, (0, 0, 0, nblk * block - s))
    if km is not None:
        xp = xp - km.float()
    xb = xp.reshape(b, h, nblk, block, d)
    scale = absmax_scale(xb.abs().amax(dim=(3, 4), keepdim=True))
    codes = quant_codes(xb, scale).reshape(b, h, nblk * block, d)[:, :, :s]
    rows = scale[..., 0, 0].repeat_interleave(block, dim=2)[:, :, :s]
    return codes, rows.contiguous()


def quant_int8(
    x: torch.Tensor,
    km: Optional[torch.Tensor] = None,
    *,
    gran: str = "per_block",
    block: int = 128,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric INT8 quantization of HND ``[B, H, S, D]`` (kernel C1).

    ``km`` (optional ``[B, H, 1, D]``) is subtracted before quantization —
    the fused smooth-K path. ``gran`` is ``"per_token"`` (one scale per row)
    or ``"per_block"`` (one scale per ``block`` rows; rows past S count as
    zeros before the ``km`` subtraction).

    Returns ``(codes int8 [B,H,S,D], scale f32 [B,H,S])`` in natural layout
    (the TPU package's pre-transposed ``layout="ds"`` is not ported).
    """
    if gran not in ("per_block", "per_token"):
        raise ValueError(f"unknown gran {gran!r}")
    if x.dim() != 4:
        raise ValueError(f"expected [B, H, S, D], got {tuple(x.shape)}")
    per_token = gran == "per_token"
    if not per_token and block < 1:
        raise ValueError(f"block must be >= 1, got {block}")
    b, h, s, d = x.shape
    if km is not None and tuple(km.shape) != (b, h, 1, d):
        raise ValueError(f"km must be [B, H, 1, D] = {(b, h, 1, d)}, got {tuple(km.shape)}")
    if x.device.type == "cpu":
        return quant_int8_plain(x, km, per_token=per_token, block=block)
    if x.device.type != "cuda":
        raise ValueError(f"quant_int8 runs on cpu or cuda tensors, not {x.device}")
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"quant_int8 kernel takes f32/bf16/f16, not {x.dtype}")
    if not per_token and cdiv(s, block) > 65535:
        raise ValueError(f"per-block quant_int8 takes at most 65535 blocks per head, got {cdiv(s, block)}")
    x = x.contiguous()
    kmc = km.float().contiguous() if km is not None else None
    codes = torch.empty(x.shape, dtype=torch.int8, device=x.device)
    scale = torch.empty((b, h, s), dtype=torch.float32, device=x.device)
    lib = _build.library()
    err = lib.lowbit_quant_int8(
        x.data_ptr(), _DTYPE_CODES[x.dtype], kmc.data_ptr() if kmc is not None else None,
        codes.data_ptr(), scale.data_ptr(), b * h, s, d, 0 if per_token else block,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.check(err, "quant_int8")
    quant_int8.launches += 1
    return codes, scale


#: Launches of the C1 kernel in this process (CPU calls do not count).
quant_int8.launches = 0
