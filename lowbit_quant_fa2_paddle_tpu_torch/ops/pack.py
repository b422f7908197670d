"""Group-wise asymmetric quantization packed into int32 words (KIVI's host
format), the quantized matmul built on it, and the ``WQLinear`` layer.

PyTorch counterpart of ``lowbit_quant_fa2_paddle_tpu/ops/pack.py``. Codes
are packed ``32 // bits`` per int32 word, CONSECUTIVE codes per word (code
``i`` of a word at bit ``i * bits``) — unlike the parts-of-K layout of the
fused kernels (``ops/gemv.py``). Everything here is plain PyTorch on any
device, as the JAX package computes it in plain XLA; ``WQLinear`` with
``backend="fused"`` runs kernel F2 instead.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from lowbit_quant_fa2_paddle_tpu_torch.ops import gemv
from lowbit_quant_fa2_paddle_tpu_torch.ops.reference import round_away


def pack_along_last_dim(codes: torch.Tensor, bits: int) -> torch.Tensor:
    """Pack unsigned ``codes`` (< 2^bits) along the last dim into int32
    words, ``32 // bits`` consecutive codes per word."""
    if bits not in (2, 4, 8):
        raise ValueError(f"bits must be 2, 4 or 8, got {bits}")
    fpi = 32 // bits
    *lead, d = codes.shape
    if d % fpi:
        raise ValueError(f"last dim {d} must be a multiple of {fpi}")
    c = codes.to(torch.int64).reshape(*lead, d // fpi, fpi)
    words = c[..., 0]
    for i in range(1, fpi):
        words = words | (c[..., i] << (i * bits))
    return torch.where(words >= 2**31, words - 2**32, words).to(torch.int32)


def unpack_along_last_dim(words: torch.Tensor, bits: int) -> torch.Tensor:
    """Inverse of :func:`pack_along_last_dim`: int32 codes."""
    fpi = 32 // bits
    w = words.to(torch.int64)[..., None] & 0xFFFFFFFF
    shifts = torch.arange(fpi, dtype=torch.int64, device=words.device) * bits
    codes = (w >> shifts) & (2**bits - 1)
    return codes.reshape(*words.shape[:-1], words.shape[-1] * fpi).to(torch.int32)


def quantize_and_pack_along_last_dim(x: torch.Tensor, *, group_size: int, bits: int
                                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Asymmetric group quantization along the last dim, then packing.
    Returns ``(packed int32 [*, D*bits/32], scale [*, D/group], mn [*,
    D/group])`` with ``code = clip(round((x - mn) / scale), 0, 2^bits - 1)``
    (``scale = (max - min) / (2^bits - 1)``, 1 where that is 0)."""
    *lead, d = x.shape
    if d % group_size:
        raise ValueError(f"last dim {d} must be a multiple of group_size {group_size}")
    xg = x.float().reshape(*lead, d // group_size, group_size)
    mn = xg.amin(dim=-1)
    mx = xg.amax(dim=-1)
    scale = (mx - mn) / (2**bits - 1)
    scale = torch.where(scale == 0, torch.ones_like(scale), scale)
    codes = round_away((xg - mn[..., None]) / scale[..., None]).clamp(0, 2**bits - 1)
    return pack_along_last_dim(codes.reshape(*lead, d), bits), scale, mn


def unpack_and_dequant_along_last_dim(packed: torch.Tensor, scale: torch.Tensor, mn: torch.Tensor, *,
                                      group_size: int, bits: int) -> torch.Tensor:
    """Inverse: ``x ≈ code * scale + mn`` in f32."""
    codes = unpack_along_last_dim(packed, bits)
    *lead, d = codes.shape
    cg = codes.float().reshape(*lead, d // group_size, group_size)
    return (cg * scale[..., None] + mn[..., None]).reshape(*lead, d)


def quantized_matmul(x: torch.Tensor, packed_w: torch.Tensor, scale: torch.Tensor, mn: torch.Tensor, *,
                     group_size: int, bits: int) -> torch.Tensor:
    """``x @ W^T`` with ``W [N, K]`` stored in the host format: dequantize,
    then one f32 matmul, in ``x.dtype``. Differentiable in ``x``."""
    w = unpack_and_dequant_along_last_dim(packed_w, scale, mn, group_size=group_size, bits=bits)
    return (x.float() @ w.T).to(x.dtype)


class WQLinear(nn.Module):
    """Weight-quantized linear layer over grouped asymmetric packed weights.

    ``backend="host"`` keeps the int32-word host format and runs
    :func:`quantized_matmul`; ``"fused"`` keeps the parts-of-K byte layout
    (``gemv.pack_weights``) and runs kernel F2 (``gemv.wq_matmul_fused``).
    ``trainable=True`` makes the layer differentiable in its input and
    bias, with the quantization params frozen on both backends (the fused
    one through ``gemv.wq_matmul_trainable``). ``packed_w``, ``scale`` and
    ``mn`` are buffers; ``bias`` is a parameter that requires a gradient
    only when trainable."""

    def __init__(self, packed_w: torch.Tensor, scale: torch.Tensor, mn: Optional[torch.Tensor],
                 bias: Optional[torch.Tensor], group_size: int, bits: int, backend: str = "host",
                 trainable: bool = False):
        super().__init__()
        if backend not in ("host", "fused"):
            raise ValueError(f"unknown backend {backend!r}")
        self.group_size, self.bits, self.backend, self.trainable = group_size, bits, backend, trainable
        self.register_buffer("packed_w", packed_w)
        self.register_buffer("scale", scale)
        self.register_buffer("mn", mn)
        self.bias = None if bias is None else nn.Parameter(bias.detach().clone(), requires_grad=trainable)

    @classmethod
    def from_dense(cls, w: torch.Tensor, bias: Optional[torch.Tensor] = None, *, group_size: int = 128,
                   bits: int = 4, backend: str = "host", trainable: bool = False) -> "WQLinear":
        """Quantize a dense ``[N, K]`` weight on its device."""
        w = w.detach()
        if backend == "fused":
            packed, scale, mn = gemv.pack_weights(w, group_size=group_size, bits=bits)
        else:
            packed, scale, mn = quantize_and_pack_along_last_dim(w, group_size=group_size, bits=bits)
        return cls(packed, scale, mn, bias, group_size, bits, backend, trainable)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.backend == "fused":
            mm = gemv.wq_matmul_trainable if self.trainable else gemv.wq_matmul_fused
            y = mm(x, self.packed_w, self.scale, self.mn, bits=self.bits, group_size=self.group_size)
        else:
            y = quantized_matmul(x, self.packed_w, self.scale, self.mn, group_size=self.group_size, bits=self.bits)
        return y if self.bias is None else y + self.bias
