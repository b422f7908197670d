"""Quantization feeding the low-bit attention kernel (kernels C1, C2, C3).

PyTorch/CUDA counterpart of ``lowbit_quant_fa2_paddle_tpu/ops/quant.py``:

* ``quant_int8`` (C1): per-token or per-block absmax INT8 with fused K-mean
  subtraction;
* ``quant_int4`` (C2): absmax INT4, two codes per byte in halves-of-D order
  (the low nibble of byte ``i`` is column ``i``, the high nibble column
  ``i + D/2``);
* ``quant_int2`` (C3): 3-level Lloyd-Max codes in {-1, 0, 1} with scale
  ``1.224 * rms + EPS``, four codes per byte in quarters-of-D order (bits
  ``2p..2p+1`` of byte ``i`` hold column ``i + p*D/4``);
* ``unpack_int4`` / ``unpack_int2``, ``quant_v_int8_per_channel`` (plain
  PyTorch, as the JAX package computes it outside any kernel) and ``k_mean``.

The three kernels are one CUDA source, ``csrc/quant.cu``, templated on the
bit width; its source note says what bounds it on the H100. Each has two
designs (``kernel_design``): ``"vector"`` reads x where it lies (any batch,
head and row strides, e.g. the DiT's K as a view of its qkv projection), 16
bytes a lane, one pass over HBM; ``"scalar"`` takes the rest, on a
contiguous copy.

Scale convention: scales come back as per-token rows ``[B, H, S]`` (per-block
granularity repeats the block scalar across its rows), so the attention
kernel has one interface for every granularity.

Each quantizer takes its plain PyTorch version below for a tensor on the CPU
and launches its kernel for a CUDA tensor. There is no fallback between the
two: a CUDA tensor that the kernel cannot take raises.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from lowbit_quant_fa2_paddle_tpu_torch.ops import _build
from lowbit_quant_fa2_paddle_tpu_torch.ops.reference import round_away

INT8_QMAX = 127.0
INT4_QMAX = 7.0
INT2_QMAX = 1.0
EPS = 1e-7
_QMAX = {8: INT8_QMAX, 4: INT4_QMAX, 2: INT2_QMAX}


def _f32(x: float) -> float:
    return torch.tensor(x, dtype=torch.float32).item()


# f32 values of 1/qmax, 1.224 and EPS: the JAX kernels' ``amax / qmax + EPS``
# and ``1.224 * rms + EPS`` compile (XLA) to one fma each, e.g.
# ``fma(amax, f32(1/127), f32(EPS))``. The plain version forms the exact
# product in f64 and rounds the sum once more to f32, which equals the fma
# except when the f64 sum lands exactly on an f32 rounding midpoint.
_RECIP_F32 = {8: _f32(1.0 / INT8_QMAX), 4: _f32(1.0 / INT4_QMAX)}
_LLOYD_MAX_F32 = _f32(1.224)
_EPS_F32 = _f32(EPS)

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}

#: The designs of kernels C1, C2 and C3 (see ``kernel_design``).
DESIGNS = ("vector", "scalar")
#: The vector design: lanes of 16 bytes a row, threads a CTA, and the most
#: 16-byte loads a thread holds for one block (``csrc/quant.cu``).
VECTOR_LANES = (4, 8, 16, 32)
VECTOR_THREADS, VECTOR_MAX_LOADS = 256, 8


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def absmax_scale(amax: torch.Tensor, bits: int = 8) -> torch.Tensor:
    """``amax / qmax + EPS`` in the JAX kernel's rounding (see above)."""
    return (amax.double() * _RECIP_F32[bits] + _EPS_F32).float()


def rms_scale(sumsq: torch.Tensor, n: int) -> torch.Tensor:
    """The INT2 scale ``1.224 * sqrt(sumsq / n) + EPS``: the f64 sum of
    squares, the rms formed in f64 and rounded once to f32, then the fma as
    above, as the kernel computes it. JAX sums the squares in f32 in XLA's
    order, so its scales differ from these by a few ulp."""
    sig = torch.sqrt(sumsq.double() / n).float()
    return (sig.double() * _LLOYD_MAX_F32 + _EPS_F32).float()


def quant_codes(x: torch.Tensor, scale: torch.Tensor, qmax: float = INT8_QMAX) -> torch.Tensor:
    """``clamp(round_half_away(x / scale), ±qmax)`` as int8; IEEE division."""
    return round_away(x / scale).clamp(-qmax, qmax).to(torch.int8)


def pack_codes(codes: torch.Tensor, bits: int) -> torch.Tensor:
    """int8 codes ``[..., D]`` -> ``[..., D*bits/8]``: ``8/bits`` codes per
    byte, code ``p`` of byte ``i`` from column ``i + p*W`` (``W`` bytes per
    row) at bit ``p*bits`` — halves-of-D for 4 bits, quarters for 2."""
    if bits == 8:
        return codes
    n = 8 // bits
    w = codes.shape[-1] // n
    c = codes.to(torch.int32) & ((1 << bits) - 1)
    packed = sum(c[..., p * w : (p + 1) * w] << (bits * p) for p in range(n))
    return packed.to(torch.uint8).view(torch.int8)


def _unpack(packed: torch.Tensor, bits: int) -> torch.Tensor:
    p32 = packed.to(torch.int32)
    half = 1 << (bits - 1)
    mask = (1 << bits) - 1
    parts = [(((p32 >> (bits * p)) & mask) ^ half) - half for p in range(8 // bits)]
    return torch.cat(parts, dim=-1).to(torch.int8)


def unpack_int4(packed: torch.Tensor) -> torch.Tensor:
    """Halves-of-D nibble-packed int4 codes -> int8 ``[..., 2*W]``."""
    return _unpack(packed, 4)


def unpack_int2(packed: torch.Tensor) -> torch.Tensor:
    """Quarters-of-D 2-bit codes -> int8 ``[..., 4*W]``."""
    return _unpack(packed, 2)


def k_mean(k: torch.Tensor) -> torch.Tensor:
    """Per-(B,H,D) mean of K over the sequence axis, ``[B,H,1,D]`` f32,
    summed in f32 as K is read (no f32 copy of K; any strides)."""
    return torch.mean(k, dim=2, keepdim=True, dtype=torch.float32)


def _scale(x: torch.Tensor, bits: int, dims) -> torch.Tensor:
    if bits == 2:
        n = math.prod(x.shape[d] for d in dims)
        return rms_scale((x.double() ** 2).sum(dim=dims, keepdim=True), n)
    return absmax_scale(x.abs().amax(dim=dims, keepdim=True), bits)


def _quant_plain(x, km, *, bits: int, per_token: bool, block: int):
    b, h, s, d = x.shape
    qmax = _QMAX[bits]
    xf = x.float()
    if per_token:
        if km is not None:
            xf = xf - km.float()
        scale = _scale(xf, bits, (-1,))
        return pack_codes(quant_codes(xf, scale, qmax), bits), scale[..., 0]
    nblk = cdiv(s, block)
    # Rows past S are zeros before the K-mean subtraction, as in the kernel.
    xp = torch.nn.functional.pad(xf, (0, 0, 0, nblk * block - s))
    if km is not None:
        xp = xp - km.float()
    xb = xp.reshape(b, h, nblk, block, d)
    scale = _scale(xb, bits, (3, 4))
    codes = quant_codes(xb, scale, qmax).reshape(b, h, nblk * block, d)[:, :, :s]
    rows = scale[..., 0, 0].repeat_interleave(block, dim=2)[:, :, :s]
    return pack_codes(codes, bits), rows.contiguous()


def quant_int8_plain(
    x: torch.Tensor, km: Optional[torch.Tensor], *, per_token: bool, block: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of kernel C1 (same semantics, bit for bit)."""
    return _quant_plain(x, km, bits=8, per_token=per_token, block=block)


def quant_int4_plain(
    x: torch.Tensor, km: Optional[torch.Tensor], *, per_token: bool, block: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of kernel C2 (same semantics, bit for bit)."""
    return _quant_plain(x, km, bits=4, per_token=per_token, block=block)


def quant_int2_plain(
    x: torch.Tensor, km: Optional[torch.Tensor], *, per_token: bool, block: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of kernel C3 (the rms in f64; see ``rms_scale``)."""
    return _quant_plain(x, km, bits=2, per_token=per_token, block=block)


def kernel_design(x: torch.Tensor, bits: int, per_token: bool, block: int) -> str:
    """Which design of ``csrc/quant.cu`` quantizes ``x`` ``[B, H, S, D]``,
    by shape, dtype, strides and alignment alone: ``"vector"`` for 8, 4 or
    2 bits when a row is 4, 8, 16 or 32 lanes of 16 bytes (bf16/f16 D 32, 64,
    128 or 256; f32 D 16 to 128), the last dim is contiguous and every row
    starts on 16 bytes, and, per block, ``block`` rows are a whole number of
    the CTA's loads, at most ``VECTOR_MAX_LOADS`` a thread (bf16 block 128 at
    d128, 64 at d256). ``"scalar"`` otherwise."""
    if bits not in (8, 4, 2) or x.dtype not in _DTYPE_CODES or x.dim() != 4:
        return "scalar"
    esize = x.element_size()
    lanes, rest = divmod(x.shape[-1] * esize, 16)
    if rest or lanes not in VECTOR_LANES or x.stride(-1) != 1:
        return "scalar"
    if x.data_ptr() % 16 or any(x.stride(i) * esize % 16 for i in range(3) if x.shape[i] > 1):
        return "scalar"
    if not per_token:
        loads, rest = divmod(block * lanes, VECTOR_THREADS)
        if rest or not 1 <= loads <= VECTOR_MAX_LOADS:
            return "scalar"
    return "vector"


def _quantize(x, km, *, gran: str, block: int, bits: int, wrapper) -> Tuple[torch.Tensor, torch.Tensor]:
    name = wrapper.__name__
    if gran not in ("per_block", "per_token"):
        raise ValueError(f"unknown gran {gran!r}")
    if x.dim() != 4:
        raise ValueError(f"expected [B, H, S, D], got {tuple(x.shape)}")
    per_token = gran == "per_token"
    if not per_token and block < 1:
        raise ValueError(f"block must be >= 1, got {block}")
    b, h, s, d = x.shape
    if d % (8 // bits):
        raise ValueError(f"{name} packs {8 // bits} codes per byte: head_dim {d} must be a multiple of {8 // bits}")
    if km is not None and tuple(km.shape) != (b, h, 1, d):
        raise ValueError(f"km must be [B, H, 1, D] = {(b, h, 1, d)}, got {tuple(km.shape)}")
    if x.device.type == "cpu":
        return _quant_plain(x, km, bits=bits, per_token=per_token, block=block)
    if x.device.type != "cuda":
        raise ValueError(f"{name} runs on cpu or cuda tensors, not {x.device}")
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"{name} kernel takes f32/bf16/f16, not {x.dtype}")
    if not per_token and cdiv(s, block) > 65535:
        raise ValueError(f"per-block {name} takes at most 65535 blocks per head, got {cdiv(s, block)}")
    design = kernel_design(x, bits, per_token, block)
    kmc = km.float().contiguous() if km is not None else None
    if kmc is not None and kmc.data_ptr() % 16:
        kmc = kmc.clone()
    kmp = kmc.data_ptr() if kmc is not None else None
    codes = torch.empty((b, h, s, d * bits // 8), dtype=torch.int8, device=x.device)
    scale = torch.empty((b, h, s), dtype=torch.float32, device=x.device)
    lib = _build.library()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    blk = 0 if per_token else block
    if design == "vector":
        err = lib.lowbit_quant_vec(x.data_ptr(), _DTYPE_CODES[x.dtype], x.stride(0), x.stride(1), x.stride(2), h,
                                   kmp, codes.data_ptr(), scale.data_ptr(), b * h, s, d, blk, bits, stream)
    else:
        x = x.contiguous()
        err = lib.lowbit_quant(x.data_ptr(), _DTYPE_CODES[x.dtype], kmp, codes.data_ptr(), scale.data_ptr(),
                               b * h, s, d, blk, bits, stream)
    _build.check(err, name)
    wrapper.launches += 1
    wrapper.launches_by_design[design] += 1
    return codes, scale


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
    return _quantize(x, km, gran=gran, block=block, bits=8, wrapper=quant_int8)


def quant_int4(
    x: torch.Tensor,
    km: Optional[torch.Tensor] = None,
    *,
    gran: str = "per_block",
    block: int = 128,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric INT4 quantization with nibble packing (kernel C2); ``km``
    and ``gran`` as in :func:`quant_int8`. Scale ``amax / 7 + EPS``.

    Returns ``(packed int8 [B,H,S,D/2], scale f32 [B,H,S])``; byte ``i``
    holds column ``i`` (low nibble) and ``i + D/2`` (high nibble).
    """
    return _quantize(x, km, gran=gran, block=block, bits=4, wrapper=quant_int4)


def quant_int2(
    x: torch.Tensor,
    km: Optional[torch.Tensor] = None,
    *,
    gran: str = "per_block",
    block: int = 128,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric INT2 quantization (kernel C3): codes in {-1, 0, 1} with the
    Lloyd-Max scale ``1.224 * rms + EPS`` (the rms over the row, or over the
    whole block with rows past S counted as zeros before ``km``).

    Returns ``(packed int8 [B,H,S,D/4], scale f32 [B,H,S])`` in
    quarters-of-D order.
    """
    return _quantize(x, km, gran=gran, block=block, bits=2, wrapper=quant_int2)


#: Launches of the C1, C2 and C3 kernels in this process (CPU calls do not
#: count), in all and per design.
quant_int8.launches = 0
quant_int4.launches = 0
quant_int2.launches = 0
quant_int8.launches_by_design = {design: 0 for design in DESIGNS}
quant_int4.launches_by_design = {design: 0 for design in DESIGNS}
quant_int2.launches_by_design = {design: 0 for design in DESIGNS}


def quant_v_int8_per_channel(
    v: torch.Tensor, *, smooth_v: bool = False
) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    """Per-channel INT8 V: one scale per (B, H, d) column over the sequence,
    optionally after extracting the per-channel mean (smooth-V). Plain
    PyTorch ops on any device, as the JAX package computes it in plain XLA;
    the scale is the fma form its compiled code uses.

    Returns ``(codes int8 [B,H,S,D], v_scale f32 [B,H,D], v_mean f32 [B,H,D] | None)``.
    """
    vf = v.float()
    vm = None
    if smooth_v:
        vm = vf.mean(dim=2)
        vf = vf - vm[:, :, None, :]
    scale = absmax_scale(vf.abs().amax(dim=2))
    return quant_codes(vf, scale[:, :, None, :]), scale, vm
