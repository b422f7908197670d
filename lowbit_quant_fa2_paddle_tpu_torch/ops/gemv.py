"""Weight-quantized matmul over packed weights (kernels F1 and F2).

PyTorch/CUDA counterpart of ``lowbit_quant_fa2_paddle_tpu/ops/gemv.py``:

* ``pack_weights`` / ``unpack_weights``: asymmetric group quantization of a
  dense ``[N, K]`` weight, unsigned codes packed **parts-of-K** (byte ``j``
  of part ``i`` holds ``k = j + i*K/fpb``: halves of K for 4 bits, quarters
  for 2, one code per byte for 8);
* ``pack_weights_per_channel``: symmetric per-output-channel w8/w4; 4-bit
  codes are stored unsigned (``c + 7``) halves-of-K;
* ``dequant_weights`` and ``WQWeight``, an ``nn.Module`` holding the packed
  per-channel weight (and an optional bias) that the models use;
* ``wq_matmul_per_channel`` (kernel F1): ``x @ W^T`` with int8 per-channel
  codes and a rank-1 scale epilogue, with bf16/f32 activations or, for
  ``activation="int8"``, per-token INT8 activations and an integer dot
  (w8a8). 4-bit per-channel weights run F2 with one group per half of K
  and zero-points ``-7 * scale``, as the JAX package routes them;
* ``wq_matmul_fused`` (kernel F2): grouped 2/4/8-bit weights; each code
  enters the dot as ``x_dtype(code * scale)``, the dot is rounded to
  ``x.dtype``, and the zero-point term ``sigma @ mn^T`` (``sigma`` the f32
  sums of x per group) is added in f32 after it;
* ``wq_matmul_trainable``: a ``torch.autograd.Function`` whose backward is
  ``g @ W_deq`` through a dense matmul, the quantization params frozen.

Route: ``M >= 1024`` rows (prefill, the DiT's 17,776 tokens) dequantize W
once and take ``torch.matmul``, as the JAX package leaves that to XLA;
smaller M runs the kernel. On CPU tensors the kernels' plain PyTorch
versions below run instead; a CUDA tensor launches ``csrc/gemv.cu`` or
raises. F1 and F2 each have two designs (``kernel_design``, by the type x
reaches the kernel in): bf16 x, and F1's int8 x, run the dot on the tensor
cores (``"tensor_core"``, ``mma.sync``: F1 takes the int8 codes as they lie,
as exact bf16 for bf16 x and as s8 for int8 x, from a producer warp's ring
of bulk-copied tiles (for int8 x, where the row blocks alone about fill
the card, a deep ring of TMA boxes, a CTA an SM over all of K with x
staged beside W),
or, for up to 8 x rows and at most 16 MiB of W, by direct loads with no
split of K across CTAs, planned by ``w8_plan``; F2
dequantizes each code exactly to
``bf16(f32(code * scale))``, planned by ``tc_plan``; both split K over CTAs
and merge the splits in a fixed order); f32 x keeps its f32 products on the
CUDA cores (``"cuda_core"``). The scales are formed as JAX computes them op by op (division, then
the ``+ 1e-8``), so packed weights equal the JAX package's bit for bit.
"""

from __future__ import annotations

import functools
import math
from typing import Optional, Tuple

import torch
from torch import nn

from lowbit_quant_fa2_paddle_tpu_torch.ops import _build
from lowbit_quant_fa2_paddle_tpu_torch.ops.reference import round_away

#: Rows of x from which the matmul dequantizes W once and runs a dense
#: matmul (the JAX package's threshold).
DENSE_ROUTE_M = 1024
#: The designs of F1 and F2 (see ``kernel_design``).
DESIGNS = ("tensor_core", "cuda_core")
#: The tensor-core design's plan: warps a CTA, rows of W a warp item, fewest
#: 64-byte chunks a split; by m-tiles a CTA, the x values of a staged row
#: (``tc_x_values`` in the source) and the CTAs an SM holds.
TC_WARPS, TC_ROWS, TC_MIN_CHUNKS = 4, 32, 2
#: Most K splits (the merge loads every split's partial at once).
TC_MAX_SPLITS = 8
TC_X_VALUES = {1: 1024, 4: 512}
TC_CTAS_PER_SM = {1: 3, 4: 2}
#: F1's tensor-core plan: rows of W and k values a tile (a CTA's unit is a
#: tile row block over a range of K), fewest tiles a split, most splits of K,
#: and by m-tiles a unit the CTAs an SM holds (``csrc/gemv.cu`` W8_*, w8_ctas).
W8_ROWS, W8_KT, W8_MIN_TILES, W8_MAX_SPLITS = 32, 512, 2, 16
W8_CTAS_PER_SM = {1: 4, 4: 2}
#: F1's direct-load structure (``csrc/gemv.cu`` W8D_*): rows of W a CTA, the
#: largest K, and the largest W it takes (bytes).
W8D_ROWS, W8D_MAX_K, W8D_MAX_BYTES = 16, 4096, 16 << 20
#: F1's load structures, in the order the C entry numbers them: the ring of
#: bulk-copied tiles, the direct loads, and the deep ring (one CTA an SM).
W8_STRUCTURES = ("ring", "direct", "deep")
_X_CODES = {torch.bfloat16: 1, torch.int8: 2}


# ---------------------------------------------------------------------------
# Pack (parts-of-K)
# ---------------------------------------------------------------------------


def _pack_parts(codes: torch.Tensor, bits: int) -> torch.Tensor:
    """Unsigned int codes ``[N, K]`` -> int8 ``[N, K*bits/8]``, parts-of-K."""
    if bits == 8:
        return codes.to(torch.uint8).view(torch.int8)
    fpb = 8 // bits
    kw = codes.shape[-1] // fpb
    c = codes.to(torch.int32)
    acc = c[..., :kw]
    for i in range(1, fpb):
        acc = acc | (c[..., i * kw : (i + 1) * kw] << (i * bits))
    return acc.to(torch.uint8).view(torch.int8)


def pack_weights(w: torch.Tensor, *, group_size: int = 128, bits: int = 4
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Asymmetric group quantization of a dense ``[N, K]`` weight, packed
    parts-of-K. Returns ``(packed int8 [N, K*bits/8], scale f32 [N,
    K/group_size], mn f32 [N, K/group_size])`` with ``w ≈ code*scale + mn``
    and unsigned codes in ``[0, 2^bits)``."""
    if bits not in (2, 4, 8):
        raise ValueError(f"bits must be 2, 4 or 8, got {bits}")
    n, k = w.shape
    if k % group_size or k % (8 // bits):
        raise ValueError(f"K={k} must be a multiple of group_size={group_size} and of {8 // bits}")
    wf = w.float().reshape(n, k // group_size, group_size)
    mn = wf.amin(dim=-1)
    mx = wf.amax(dim=-1)
    scale = (mx - mn) / (2**bits - 1)
    scale = torch.where(scale == 0, torch.ones_like(scale), scale)
    codes = round_away((wf - mn[..., None]) / scale[..., None]).clamp(0, 2**bits - 1)
    return _pack_parts(codes.reshape(n, k), bits), scale, mn


def unpack_weights(packed: torch.Tensor, *, bits: int) -> torch.Tensor:
    """Inverse of :func:`pack_weights`: unsigned int32 codes ``[N, K]``."""
    p = packed.to(torch.int32) & 0xFF
    if bits == 8:
        return p
    mask = (1 << bits) - 1
    return torch.cat([(p >> (i * bits)) & mask for i in range(8 // bits)], dim=-1)


def pack_weights_per_channel(w: torch.Tensor, *, bits: int = 8) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-output-channel quantization ``w ≈ code * scale[n]``
    (scale ``max|w| / qmax + 1e-8``). Returns ``(packed int8 [N,
    K*bits/8], scale f32 [N])``: signed int8 codes for 8 bits; for 4 bits
    the codes ``c + 7`` in [0, 14], packed halves-of-K (low nibble ``k``,
    high nibble ``k + K/2``)."""
    if bits not in (4, 8):
        raise ValueError(f"per-channel bits must be 4 or 8, got {bits}")
    n, k = w.shape
    qmax = 127.0 if bits == 8 else 7.0
    wf = w.float()
    scale = wf.abs().amax(dim=-1) / qmax + 1e-8
    codes = round_away(wf / scale[:, None]).clamp(-qmax, qmax).to(torch.int32)
    if bits == 8:
        return codes.to(torch.int8), scale
    if k % 2:
        raise ValueError(f"4-bit packing needs an even K, got {k}")
    return _pack_parts(codes + 7, 4), scale


def dequant_weights(
    packed: torch.Tensor,
    scale: torch.Tensor,
    mn: Optional[torch.Tensor] = None,
    *,
    bits: int,
    group_size: Optional[int] = None,
) -> torch.Tensor:
    """The f32 ``[N, K]`` weight from either format: per-channel symmetric
    (``scale [N]``; 4-bit stored as ``c + 7``) or grouped asymmetric
    (``scale``/``mn [N, G]``)."""
    n = packed.shape[0]
    if scale.dim() == 1:
        if bits == 8:
            codes = packed.float()
        else:
            codes = (unpack_weights(packed, bits=4) - 7).float()
        return codes * scale.float()[:, None]
    if group_size is None:
        raise ValueError("grouped weights need group_size")
    codes = unpack_weights(packed, bits=bits).float()
    g_total = codes.shape[1] // group_size
    w = codes.reshape(n, g_total, group_size) * scale.float()[..., None]
    if mn is not None:
        w = w + mn.float()[..., None]
    return w.reshape(n, codes.shape[1])


# ---------------------------------------------------------------------------
# Plain versions of kernels F1 and F2 (the small-M route)
# ---------------------------------------------------------------------------


def _x_dtype(dtype: torch.dtype) -> torch.dtype:
    """The type x enters the dot in: bf16 for 16-bit x, else f32."""
    return torch.bfloat16 if dtype in (torch.bfloat16, torch.float16) else torch.float32


def quant_activations(x2: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-token INT8 activations of the w8a8 route, plain ops on any
    device: ``xs = max|x| / 127 + 1e-8`` (division, then the add, as JAX
    computes it op by op) and ``clamp(round_away(x / xs), ±127)``. Returns
    ``(xq int8 [M, K], xs f32 [M])``."""
    xf = x2.float()
    xs = xf.abs().amax(dim=-1, keepdim=True) / 127.0 + 1e-8
    return round_away(xf / xs).clamp(-127, 127).to(torch.int8), xs[:, 0]


def wq_matmul_per_channel_plain(x2: torch.Tensor, packed: torch.Tensor, scale: torch.Tensor, *,
                                x_scale: Optional[torch.Tensor] = None, out_dtype: torch.dtype) -> torch.Tensor:
    """Plain PyTorch version of kernel F1 on its own inputs: ``x2 [M, K]``
    (bf16 or f32, or int8 codes with ``x_scale [M]``), int8 codes ``[N,
    K]``, ``scale [N]``. ``y = f32(x . code) * scale``, or
    ``(f32(i32 dot) * x_scale) * scale`` for int8 x, in ``out_dtype``."""
    if x2.dtype == torch.int8:
        # f64 products and sums of int8 codes are exact: the int32 dot.
        d = (x2.double() @ packed.double().T).float() * x_scale.float()[:, None]
    else:
        d = x2.float() @ packed.float().T
    return (d * scale.float()[None, :]).to(out_dtype)


def wq_matmul_fused_plain(x2: torch.Tensor, packed: torch.Tensor, scale: torch.Tensor,
                          mn: Optional[torch.Tensor], *, bits: int, group_size: int) -> torch.Tensor:
    """Plain PyTorch version of kernel F2 on ``x2 [M, K]``: ``y =
    x2.dtype(x . x_dtype(code * scale))`` (x in ``x_dtype`` too), then
    ``y + sigma @ mn^T`` in f32, ``sigma`` the f32 sums of x per group, and
    ``x2.dtype`` again."""
    n, k = packed.shape[0], x2.shape[1]
    g_total = k // group_size
    xd = _x_dtype(x2.dtype)
    codes = unpack_weights(packed, bits=bits).float().reshape(n, g_total, group_size)
    w = (codes * scale.float()[..., None]).to(xd).float().reshape(n, k)
    out = (x2.to(xd).float() @ w.T).to(x2.dtype)
    if mn is not None:
        sigma = x2.float().reshape(-1, g_total, group_size).sum(dim=-1)
        out = (out.float() + sigma @ mn.float().T).to(x2.dtype)
    return out


# ---------------------------------------------------------------------------
# The kernel launch
# ---------------------------------------------------------------------------


def kernel_design(x_dtype: torch.dtype = torch.bfloat16) -> str:
    """Which design of kernels F1 and F2 runs activations of ``x_dtype`` (as
    they reach the kernel): ``"tensor_core"`` for bf16 (``mma.sync``; the
    exact bf16 weights times bf16 x are exact in f32) and for F1's int8
    activation codes (an s8 product, exact in s32), ``"cuda_core"`` for f32
    (f32 products, which the tensor cores cannot form exactly)."""
    if x_dtype in (torch.bfloat16, torch.int8):
        return "tensor_core"
    if x_dtype == torch.float32:
        return "cuda_core"
    raise TypeError(f"kernels F1/F2 take bf16, f32 or (F1) int8 activations, not {x_dtype}")


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def tc_plan(m: int, n: int, k: int, bits: int, n_sms: int) -> Tuple[int, int, int, int, int]:
    """The tensor-core design's launch plan ``(mt, ksplit, cps, spc, gx)``
    for ``x [m, k] @ W^T [k, n]`` on ``n_sms`` SMs: ``mt`` m-tiles of 8 x
    rows a CTA (1 up to 8 rows, else 4); with one m-tile the packed row is
    split over CTAs into ``ksplit`` ranges of ``cps`` 64-byte chunks, as
    many as fill the card's warp slots once with items of 32 rows (at least
    ``TC_MIN_CHUNKS`` chunks a range, at most ``TC_MAX_SPLITS`` ranges),
    with four (M > 8) it is not split, since each split's partial sums would
    be M x N floats; a CTA stages x
    for slices of ``spc`` chunks of its range (``TC_X_VALUES[mt]`` values a
    row at most); ``gx`` CTAs along N, every warp walking the same number of
    items. It depends on shapes only."""
    fpb = 8 // bits
    kb = k // fpb
    mt = 1 if m <= 8 else 4
    mblocks = _cdiv(m, 8 * mt)
    chunks = _cdiv(kb, 64)
    items = _cdiv(n, TC_ROWS)
    slots = n_sms * TC_CTAS_PER_SM[mt] * TC_WARPS
    ksplit = min(max(1, slots // (items * mblocks)), _cdiv(chunks, TC_MIN_CHUNKS), TC_MAX_SPLITS) if mt == 1 else 1
    cps = _cdiv(chunks, ksplit)
    ksplit = _cdiv(chunks, cps)
    spc = min(cps, max(1, TC_X_VALUES[mt] // fpb // 64))
    per_warp = _cdiv(items * ksplit * mblocks, slots)  # the same number of items for every warp
    return mt, ksplit, cps, spc, _cdiv(items, TC_WARPS * per_warp)


def w8_plan(m: int, n: int, k: int, n_sms: int, x_int8: bool = False) -> Tuple[str, int, int, int, int]:
    """F1's tensor-core plan ``(structure, mt, ksplit, tps, grid)`` for ``x
    [m, k] @ W^T [k, n]`` on ``n_sms`` SMs (``structure`` one of
    ``W8_STRUCTURES``). ``"direct"``: up to 8 x rows, K up to ``W8D_MAX_K``
    and W up to ``W8D_MAX_BYTES`` run the direct-load kernel, ``ceil(n /
    W8D_ROWS)`` CTAs, no split (there the ring's split merge costs more than
    the loads). ``"deep"``: up to 8 rows of int8 x (``x_int8``) whose units
    of ``W8_ROWS`` rows fill between 3/4 of the SMs and all of them once (N
    4096 at K 16384 on an H100) take the deep ring, a CTA an SM over all of
    K, no split and so no merge (bf16 x is faster split: one SM's four warps
    do not keep up with its dequantization). Else ``"ring"``: ``mt`` m-tiles of 8 x rows a unit (1 up to 8
    rows, else 4); with one m-tile K is split into ``ksplit`` ranges of
    ``tps`` tiles of ``W8_KT`` values, as many as fill the card's CTA slots
    once with units of ``W8_ROWS`` rows (at least ``W8_MIN_TILES`` tiles a
    range unless K has fewer, at most ``W8_MAX_SPLITS``); with four it is not
    split, since each split's partial dots would be M x N; ``grid`` CTAs, at
    most one a slot, each walking its units. It depends on shapes only."""
    ktiles = _cdiv(k, W8_KT)
    if m <= 8 and k <= W8D_MAX_K and n * k <= W8D_MAX_BYTES:
        return "direct", 1, 1, ktiles, _cdiv(n, W8D_ROWS)
    mt = 1 if m <= 8 else 4
    units = _cdiv(n, W8_ROWS) * _cdiv(m, 8 * mt)
    if x_int8 and mt == 1 and 3 * n_sms <= 4 * units <= 4 * n_sms:
        return "deep", 1, 1, ktiles, units
    slots = n_sms * W8_CTAS_PER_SM[mt]
    ksplit = min(max(1, slots // units), _cdiv(ktiles, W8_MIN_TILES), W8_MAX_SPLITS) if mt == 1 else 1
    tps = _cdiv(ktiles, ksplit)
    ksplit = _cdiv(ktiles, tps)
    return "ring", mt, ksplit, tps, min(units * ksplit, slots)


_TICKETS: dict = {}


def _tickets(device: torch.device, n: int) -> torch.Tensor:
    """Zeroed int32 counters of the split merge, one per (m-block, 32-row
    item), kept per device; the kernel leaves them zero."""
    t = _TICKETS.get(device)
    if t is None or t.numel() < n:
        t = torch.zeros(max(n, 4096), dtype=torch.int32, device=device)
        _TICKETS[device] = t
    return t


@functools.lru_cache(maxsize=None)
def _sm_count(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def _gemv_tc_cuda(x2, packed, scale, mn, *, bits, group_size, neg7, s_row, s_group):
    """Launch F2's tensor-core design on bf16 ``x2 [M, K]`` (checked by
    ``_gemv_cuda``); returns bf16 ``y [M, N]``."""
    m, k = x2.shape
    n = packed.shape[0]
    dev = x2.device
    mt, ksplit, cps, spc, gx = tc_plan(m, n, k, bits, _sm_count(dev.index if dev.index is not None else
                                                                torch.cuda.current_device()))
    y = torch.empty((m, n), dtype=torch.bfloat16, device=dev)
    part = tickets = None
    if ksplit > 1:  # the splits' partial sums and their merge tickets
        part = torch.empty(2 * ksplit * m * n, dtype=torch.float32, device=dev)
        tickets = _tickets(dev, _cdiv(m, 8 * mt) * _cdiv(n, TC_ROWS))
    with torch.cuda.device(dev):
        err = _build.library().lowbit_gemv_tc(
            x2.data_ptr(), packed.data_ptr(), scale.data_ptr(), mn.data_ptr() if mn is not None else None,
            y.data_ptr(), part.data_ptr() if part is not None else None,
            tickets.data_ptr() if tickets is not None else None, m, n, k, bits, group_size, s_row, s_group,
            int(neg7), mt, ksplit, cps, spc, gx, torch.cuda.current_stream(dev).cuda_stream,
        )
    _build.check(err, "wq_matmul_fused")
    return y


def _gemv_w8_cuda(x2, x_scale, packed, scale, *, out_dtype):
    """Launch F1's tensor-core design on bf16 x or int8 codes ``x2 [M, K]``
    (with ``x_scale [M]``; checked by ``_gemv_cuda``); returns ``y [M, N]``."""
    m, k = x2.shape
    n = packed.shape[0]
    dev = x2.device
    n_sms = _sm_count(dev.index if dev.index is not None else torch.cuda.current_device())
    structure, mt, ksplit, tps, grid = w8_plan(m, n, k, n_sms, x_int8=x2.dtype == torch.int8)
    y = torch.empty((m, n), dtype=out_dtype, device=dev)
    part = tickets = None
    if ksplit > 1:  # the splits' partial dots and their merge tickets
        part = torch.empty(ksplit * m * n, dtype=torch.int32 if x2.dtype == torch.int8 else torch.float32, device=dev)
        tickets = _tickets(dev, _cdiv(m, 8 * mt) * _cdiv(n, W8_ROWS))
    with torch.cuda.device(dev):
        err = _build.library().lowbit_gemv_w8(
            x2.data_ptr(), x_scale.data_ptr() if x_scale is not None else None, packed.data_ptr(), scale.data_ptr(),
            y.data_ptr(), part.data_ptr() if part is not None else None,
            tickets.data_ptr() if tickets is not None else None, m, n, k, _X_CODES[x2.dtype],
            int(out_dtype == torch.float32), W8_STRUCTURES.index(structure), mt, ksplit, tps, grid,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    _build.check(err, "wq_matmul_per_channel")
    return y


def _gemv_cuda(x2, x_scale, packed, scale, mn, *, bits, grouped, group_size, neg7, out_dtype, wrapper):
    """Launch F1, or F2, on its design for ``x2``'s type."""
    name = wrapper.__name__
    m, k = x2.shape
    n, kb = packed.shape
    if x2.dtype not in (torch.float32, torch.bfloat16, torch.int8) or (grouped and x2.dtype == torch.int8):
        raise TypeError(f"{name} kernel takes f32, bf16 or (F1) int8 activations, not {x2.dtype}")
    if out_dtype not in (torch.float32, torch.bfloat16) or (x2.dtype != torch.int8 and out_dtype != x2.dtype):
        raise TypeError(f"{name} kernel writes f32 or bf16 (x's type), not {out_dtype}")
    tensors = [x2, packed, scale] + [t for t in (x_scale, mn) if t is not None]
    if any(t.device != x2.device for t in tensors):
        raise ValueError(f"{name} inputs must all be on one device")
    if kb % 16:
        raise ValueError(f"{name} kernel streams 16-byte chunks: packed row bytes {kb} must be a multiple of 16")
    if grouped and group_size % 16:
        raise ValueError(f"{name} kernel needs a group size that is a multiple of 16, got {group_size}")
    if packed.data_ptr() % 16 or x2.data_ptr() % 16:
        raise ValueError(f"{name} kernel needs 16-byte aligned x and weights")
    s_row, s_group = (1, 0) if scale.dim() == 1 else (scale.shape[1], 1)
    design = kernel_design(x2.dtype)
    if design == "tensor_core" and not grouped:
        y = _gemv_w8_cuda(x2, x_scale, packed, scale, out_dtype=out_dtype)
    elif design == "tensor_core":
        y = _gemv_tc_cuda(x2, packed, scale, mn, bits=bits, group_size=group_size, neg7=neg7, s_row=s_row,
                          s_group=s_group)
    else:
        y = torch.empty((m, n), dtype=torch.float32, device=x2.device)
        with torch.cuda.device(x2.device):
            err = _build.library().lowbit_gemv(
                x2.data_ptr(), packed.data_ptr(), scale.data_ptr(), mn.data_ptr() if mn is not None else None,
                y.data_ptr(), m, n, k, bits, int(grouped), group_size, s_row, s_group, int(neg7),
                torch.cuda.current_stream(x2.device).cuda_stream,
            )
        _build.check(err, name)
    wrapper.launches += 1
    wrapper.launches_by_design[design] += 1
    return y


def _check_device(x: torch.Tensor, name: str) -> None:
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} runs on cpu or cuda tensors, not {x.device}")


def _dense_route(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ W^T`` through a dense matmul on the dequantized weight, in bf16
    (f32 for f32 x), as the JAX package's large-M route."""
    wt = w.to(torch.bfloat16 if x.dtype != torch.float32 else torch.float32)
    if x.dtype not in (torch.bfloat16, torch.float32):  # f16 x bf16 promotes to f32
        return (x.float() @ wt.float().T).to(x.dtype)
    return (x @ wt.T).to(x.dtype)


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------


def wq_matmul_per_channel(
    x: torch.Tensor,
    packed: torch.Tensor,
    scale: torch.Tensor,
    *,
    bits: int = 8,
    activation: str = "bf16",
) -> torch.Tensor:
    """``x @ W^T`` with symmetric per-channel W (:func:`pack_weights_per_channel`),
    ``x [..., K]`` -> ``[..., N]`` in ``x.dtype``. Kernel F1 for 8 bits
    (``activation="int8"`` quantizes x per token and takes the integer dot);
    4 bits run kernel F2 with two groups per row and zero-points ``-7·scale``
    (``activation`` does not apply, as in JAX). ``M >= 1024`` rows take the
    dense route. The TPU function's ``block_n`` and ``interpret`` are not
    ported."""
    _check_device(x, "wq_matmul_per_channel")
    if bits not in (4, 8):
        raise ValueError(f"per-channel bits must be 4 or 8, got {bits}")
    if activation not in ("bf16", "int8"):
        raise ValueError(f"unknown activation {activation!r}")
    *lead, k = x.shape
    n = packed.shape[0]
    if tuple(packed.shape) != (n, k * bits // 8) or tuple(scale.shape) != (n,):
        raise ValueError(f"packed [N, K*bits/8] and scale [N] expected for K={k}: "
                         f"{tuple(packed.shape)}, {tuple(scale.shape)}")
    m = math.prod(lead)
    if m >= DENSE_ROUTE_M:
        return _dense_route(x, dequant_weights(packed, scale, bits=bits))
    x2 = x.reshape(m, k)
    if bits == 4:
        if x.device.type == "cpu":
            sc = scale.float()[:, None].repeat(1, 2)
            mn = (-7.0 * scale.float())[:, None].expand(n, 2)
            return wq_matmul_fused(x, packed, sc, mn, bits=4, group_size=k // 2)
        y = _gemv_cuda(x2.to(_x_dtype(x.dtype)).contiguous(), None, packed, scale.float().contiguous(), None,
                       bits=4, grouped=True, group_size=k // 2, neg7=True, out_dtype=x.dtype,
                       wrapper=wq_matmul_fused)
        return y.reshape(*lead, n)
    if activation == "int8":
        xk, xs = quant_activations(x2)
    else:
        xk, xs = x2.to(_x_dtype(x.dtype)), None
    if x.device.type == "cpu":
        y = wq_matmul_per_channel_plain(xk, packed, scale, x_scale=xs, out_dtype=x.dtype)
    else:
        y = _gemv_cuda(xk.contiguous(), xs, packed, scale.float().contiguous(), None, bits=8, grouped=False,
                       group_size=0, neg7=False, out_dtype=x.dtype, wrapper=wq_matmul_per_channel)
    return y.reshape(*lead, n)


def wq_matmul_fused(
    x: torch.Tensor,
    packed: torch.Tensor,
    scale: torch.Tensor,
    mn: Optional[torch.Tensor] = None,
    *,
    bits: int = 4,
    group_size: int = 128,
) -> torch.Tensor:
    """``x @ W^T`` with W packed parts-of-K (:func:`pack_weights`): kernel
    F2 below 1024 rows, the dense route from there. ``x [..., K]`` ->
    ``[..., N]`` in ``x.dtype``. Each part of K must hold whole groups. The
    TPU function's ``block_n``, ``block_k`` and ``interpret`` are not
    ported."""
    _check_device(x, "wq_matmul_fused")
    if bits not in (2, 4, 8):
        raise ValueError(f"bits must be 2, 4 or 8, got {bits}")
    *lead, k = x.shape
    n = packed.shape[0]
    fpb = 8 // bits
    g_total = k // group_size
    if tuple(packed.shape) != (n, k // fpb) or tuple(scale.shape) != (n, g_total) or k % group_size:
        raise ValueError(f"packed [N, K*bits/8] and scale [N, K/group_size] expected for K={k}, "
                         f"group_size={group_size}: {tuple(packed.shape)}, {tuple(scale.shape)}")
    if mn is not None and tuple(mn.shape) != (n, g_total):
        raise ValueError(f"mn must be [N, K/group_size], got {tuple(mn.shape)}")
    m = math.prod(lead)
    if m >= DENSE_ROUTE_M:
        w = dequant_weights(packed, scale, mn, bits=bits, group_size=group_size)
        return _dense_route(x, w)
    if (k // fpb) % group_size:
        raise ValueError(f"each part of K ({k // fpb} codes) must hold whole groups of {group_size}")
    x2 = x.reshape(m, k)
    if x.device.type == "cpu":
        y = wq_matmul_fused_plain(x2, packed, scale, mn, bits=bits, group_size=group_size)
    else:
        y = _gemv_cuda(x2.contiguous(), None, packed, scale.float().contiguous(),
                       mn.float().contiguous() if mn is not None else None, bits=bits, grouped=True,
                       group_size=group_size, neg7=False, out_dtype=x.dtype, wrapper=wq_matmul_fused)
    return y.reshape(*lead, n)


#: Launches of kernels F1 and F2 in this process (CPU calls and the dense
#: route do not count; 4-bit per-channel weights count as F2), in all and per
#: design.
wq_matmul_per_channel.launches = 0
wq_matmul_fused.launches = 0
wq_matmul_per_channel.launches_by_design = {design: 0 for design in DESIGNS}
wq_matmul_fused.launches_by_design = {design: 0 for design in DESIGNS}


# ---------------------------------------------------------------------------
# Differentiable wrapper (training through frozen quantized weights)
# ---------------------------------------------------------------------------


class _WQMatmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, packed, scale, mn, bits, group_size):
        ctx.save_for_backward(packed, scale, mn)
        ctx.bits, ctx.group_size = bits, group_size
        if scale.dim() == 1:
            return wq_matmul_per_channel(x, packed, scale, bits=bits)
        return wq_matmul_fused(x, packed, scale, mn, bits=bits, group_size=group_size)

    @staticmethod
    def backward(ctx, g):
        packed, scale, mn = ctx.saved_tensors
        w = dequant_weights(packed, scale, mn, bits=ctx.bits, group_size=ctx.group_size)
        return _dense_route(g, w.T), None, None, None, None, None


def wq_matmul_trainable(
    x: torch.Tensor,
    packed: torch.Tensor,
    scale: torch.Tensor,
    mn: Optional[torch.Tensor] = None,
    *,
    bits: int = 4,
    group_size: Optional[int] = 128,
) -> torch.Tensor:
    """Differentiable ``x @ W^T`` over frozen packed weights: the forward is
    :func:`wq_matmul_per_channel` (``scale.dim() == 1``) or
    :func:`wq_matmul_fused`; the backward returns ``dL/dx = g @ W_deq``
    through a dense matmul, and nothing to the quantization params."""
    if scale.dim() == 1 and mn is not None:
        raise ValueError("the per-channel symmetric format has no zero-points")
    return _WQMatmul.apply(x, packed.detach(), scale.detach(), mn.detach() if mn is not None else None,
                           bits, group_size)


# ---------------------------------------------------------------------------
# The packed layer the models use
# ---------------------------------------------------------------------------


class WQWeight(nn.Module):
    """A per-channel packed weight ``W [N, K]`` (``pack_weights_per_channel``)
    as a layer: ``forward(x) = x @ W^T (+ bias)`` through
    :func:`wq_matmul_per_channel`. ``packed``, ``scale`` and ``bias`` are
    buffers; ``bits`` is 8 or 4."""

    def __init__(self, packed: torch.Tensor, scale: torch.Tensor, bits: int, bias: Optional[torch.Tensor] = None):
        super().__init__()
        if bits not in (4, 8) or packed.dim() != 2 or tuple(scale.shape) != (packed.shape[0],):
            raise ValueError(f"WQWeight wants packed [N, K*bits/8], scale [N], bits 4 or 8: "
                             f"{tuple(packed.shape)}, {tuple(scale.shape)}, {bits}")
        self.bits = bits
        self.register_buffer("packed", packed)
        self.register_buffer("scale", scale)
        self.register_buffer("bias", bias)

    @classmethod
    def from_dense(cls, w: torch.Tensor, *, bits: int = 8, bias: Optional[torch.Tensor] = None) -> "WQWeight":
        """Pack a dense ``[N, K]`` (``nn.Linear.weight``) on its device."""
        packed, scale = pack_weights_per_channel(w.detach(), bits=bits)
        return cls(packed, scale, bits, None if bias is None else bias.detach().clone())

    @property
    def out_features(self) -> int:
        return self.packed.shape[0]

    @property
    def in_features(self) -> int:
        return self.packed.shape[1] * 8 // self.bits

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = wq_matmul_per_channel(x, self.packed, self.scale, bits=self.bits)
        return y if self.bias is None else y + self.bias

    def extra_repr(self) -> str:
        return f"in_features={self.in_features}, out_features={self.out_features}, bits={self.bits}"
