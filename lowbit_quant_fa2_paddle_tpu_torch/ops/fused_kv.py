"""Attention over K and V kept as packed low-bit codes with KIVI-style
per-channel group scales and zero-points (kernel E).

PyTorch/CUDA counterpart of ``lowbit_quant_fa2_paddle_tpu/ops/fused_kv.py``:

* ``quant_kv_grouped``: asymmetric quantization of ``[B, H, S, D]`` with
  one ``(scale, mn)`` row of D per ``group`` tokens (the sequence is
  zero-padded to whole groups BEFORE the min and max are taken, so a ragged
  last group's scale and mn see those zeros), unsigned codes packed along D
  (halves of D for 4 bits, quarters for 2); plain PyTorch ops, bit-equal to
  the JAX function run op by op;
* ``fused_packed_kv_attention`` (kernel E, ``csrc/fused_kv_attention_wgmma.cu``):
  attention with K and V resident as those codes, dequantized inside the
  kernel (one Hopper design, ``kernel_design``: TMA of the packed tiles, a
  producer warpgroup that widens them to bf16 in shared memory, ``wgmma``
  products on 128-key tiles, 64 at head dims 256 and 512). GQA, causal (top-left
  aligned: query row ``r`` sees keys ``0..r``, also when Sq != Sk), any Sk,
  every head dim that is a multiple of 16 from 16 to 512 (64, 128, 256 and
  512 on kernels of their own; the others on the kernel of the next of those
  widths, the columns past the head dim zeros, ``csrc/fused_kv_attention_wgmma_pad.cu``
  and, above 256, ``csrc/fused_kv_attention_wgmma_d512.cu``, whose two
  consumer warpgroups split O's columns as kernel A's d512 kernel's do).
  Q, K and V enter the two products as bf16 (the TPU kernel dots f32 Q and
  K); P is f32 for the softmax and bf16 in PV; a row with no visible weight
  gives 0.

The wrapper takes the plain PyTorch version below for CPU tensors and
launches the kernel for CUDA tensors; nothing falls back.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from lowbit_quant_fa2_paddle_tpu_torch.ops import _build
from lowbit_quant_fa2_paddle_tpu_torch.ops.attention import LOG2E, MASK_VALUE, NEG_INIT, _not_ported
from lowbit_quant_fa2_paddle_tpu_torch.ops.quant import cdiv, pack_codes
from lowbit_quant_fa2_paddle_tpu_torch.ops.reference import round_away

#: Elements of one chunk of f32 logits in the plain version (1 GiB).
_PLAIN_CHUNK_ELEMS = 1 << 28
#: Designs of kernel E: one, for every mode (bits 4 and 2, every head dim).
DESIGNS = ("wgmma",)
#: The head dims kernel E takes on the card: the multiples of 16 from 16 to 512.
HEAD_DIMS = tuple(range(16, 513, 16))


def kernel_design(bits: int = 4) -> str:
    """Which design of kernel E runs a mode: ``"wgmma"`` for both bit
    widths. The choice is static, by mode."""
    if bits not in (4, 2):
        raise ValueError(f"bits must be 4 or 2, got {bits}")
    return "wgmma"


def quant_kv_grouped(x: torch.Tensor, *, bits: int = 4, group: int = 256
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Asymmetric per-channel group quantization of ``[B, H, S, D]`` along
    the sequence. Returns ``(packed int8 [B, H, S, D*bits/8], scale f32
    [B, H, ceil(S/group), D], mn f32 [B, H, ceil(S/group), D])`` with
    ``x ≈ code * scale + mn`` (``scale = (max - min) / (2^bits - 1)``, 1
    where that is 0)."""
    if bits not in (4, 2):
        raise ValueError(f"bits must be 4 or 2, got {bits}")
    b, h, s, d = x.shape
    if d % (8 // bits):
        raise ValueError(f"head_dim {d} must be a multiple of {8 // bits}")
    s_pad = cdiv(s, group) * group
    xf = torch.nn.functional.pad(x.float(), (0, 0, 0, s_pad - s))
    xg = xf.reshape(b, h, s_pad // group, group, d)
    mn = xg.amin(dim=3)
    mx = xg.amax(dim=3)
    qmax = 2**bits - 1
    scale = (mx - mn) / qmax
    scale = torch.where(scale == 0, torch.ones_like(scale), scale)
    codes = round_away((xg - mn[:, :, :, None]) / scale[:, :, :, None]).clamp(0, qmax)
    codes = codes.reshape(b, h, s_pad, d)[:, :, :s]
    return pack_codes(codes.to(torch.int32), bits), scale, mn


def _unpack_unsigned(packed: torch.Tensor, bits: int) -> torch.Tensor:
    """Packed codes -> unsigned int32 codes in ``[0, 2^bits)``."""
    p32 = packed.to(torch.int32) & 0xFF
    mask = (1 << bits) - 1
    return torch.cat([(p32 >> (bits * i)) & mask for i in range(8 // bits)], dim=-1)


def dequant_kv_grouped(packed: torch.Tensor, scale: torch.Tensor, mn: torch.Tensor, *, bits: int,
                       group: int) -> torch.Tensor:
    """The bf16 values kernel E computes from packed codes, ``[B, H, S, D]``:
    ``bf16(fma(code, scale, mn))`` with the group's rows (the product and
    sum exact in f64, then rounded to f32: the fma but for double-rounding
    ties)."""
    s = packed.shape[2]
    codes = _unpack_unsigned(packed, bits).double()
    sc = scale.double().repeat_interleave(group, dim=2)[:, :, :s]
    m = mn.double().repeat_interleave(group, dim=2)[:, :, :s]
    return (codes * sc + m).float().to(torch.bfloat16)


def fused_kv_attention_plain(
    q: torch.Tensor,
    k_packed: torch.Tensor,
    v_packed: torch.Tensor,
    k_scale: torch.Tensor,
    k_mn: torch.Tensor,
    v_scale: torch.Tensor,
    v_mn: torch.Tensor,
    *,
    bits: int,
    group: int,
    causal: bool,
    sm_scale_log2e: float,
    out_dtype: torch.dtype,
) -> torch.Tensor:
    """Plain PyTorch version of kernel E on its own inputs: one softmax over
    all keys in closed form (the kernel and the TPU kernel run it online
    over tiles), rounding Q, K, V and P's PV operand to bf16 where the
    kernel does. Works through q-row chunks so the f32 logits stay within
    1 GiB."""
    b, h, sq, d = q.shape
    hk, sk = k_packed.shape[1], k_packed.shape[2]
    grp = h // hk
    dev = q.device
    kd = dequant_kv_grouped(k_packed, k_scale, k_mn, bits=bits, group=group).float()[:, :, None]
    vd = dequant_kv_grouped(v_packed, v_scale, v_mn, bits=bits, group=group).float()[:, :, None]
    qg = q.to(torch.bfloat16).float().reshape(b, hk, grp, sq, d)
    c = torch.tensor(sm_scale_log2e, dtype=torch.float32, device=dev)
    mask_value = torch.tensor(MASK_VALUE, dtype=torch.float32, device=dev)
    col = torch.arange(sk, device=dev)
    out = torch.empty((b, hk, grp, sq, d), dtype=out_dtype, device=dev)
    rows = max(1, _PLAIN_CHUNK_ELEMS // max(1, b * h * sk))
    for r0 in range(0, sq, rows):
        r1 = min(sq, r0 + rows)
        s = (qg[:, :, :, r0:r1] @ kd.transpose(-1, -2)) * c
        if causal:
            row = torch.arange(r0, r1, device=dev)
            s = torch.where(col[None, :] > row[:, None], mask_value, s)
        m = s.amax(dim=-1, keepdim=True).clamp_min(NEG_INIT)
        p = torch.exp2(s - m)
        del s
        l = p.sum(dim=-1, keepdim=True)
        o = (p.to(torch.bfloat16).float() @ vd) / torch.where(l == 0.0, torch.ones_like(l), l)
        out[:, :, :, r0:r1] = o.to(out_dtype)
        del p, o
    return out.reshape(b, h, sq, d)


def pack_row_bytes(d: int, bits: int) -> int:
    """Bytes between the packed rows kernel E reads: the row's ``d·bits/8``
    rounded up to a multiple of 16 (a TMA box row)."""
    return cdiv(d * bits // 8, 16) * 16


def _fused_kv_cuda(q, kp, vp, ks, km, vs, vm, *, bits, group, causal, sm_scale_log2e, out_dtype):
    b, h, sq, d = q.shape
    hk, sk = kp.shape[1], kp.shape[2]
    if d > 512:
        # A 64-key bf16 K and V tile beside a 64-row bf16 Q tile is already
        # 192 of the 227 KB of shared memory at 512.
        raise _not_ported(f"kernel E at head_dim {d} > 512", "3h")
    if d not in HEAD_DIMS:
        raise _not_ported(f"kernel E at head_dim {d} (it takes the multiples of 16 from 16 to 512)", "3")
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"kernel E writes f32 or bf16, not {out_dtype}")
    tensors = (kp, vp, ks, km, vs, vm)
    if any(t.device != q.device for t in tensors):
        raise ValueError("fused_packed_kv_attention inputs must all be on one device")
    if b > 65535 or h > 65535:
        raise ValueError(f"batch and heads are CUDA grid dims (at most 65535): {b}, {h}")
    if q.dtype not in (torch.float32, torch.bfloat16):
        q = q.float()
    q = q.contiguous()
    kp, vp = kp.contiguous(), vp.contiguous()
    row = pack_row_bytes(d, bits)
    if row != kp.shape[-1]:
        # Rows that are not 16-byte multiples, padded for the TMA boxes: a
        # copy of the packed K and V.
        kp, vp = (torch.nn.functional.pad(x, (0, row - x.shape[-1])) for x in (kp, vp))
    ks, km, vs, vm = (t.float().contiguous() for t in (ks, km, vs, vm))
    # TMA and 16-byte loads want 16-byte aligned starts.
    q, kp, vp, ks, km, vs, vm = (t if t.data_ptr() % 16 == 0 else t.clone() for t in (q, kp, vp, ks, km, vs, vm))
    o = torch.empty((b, h, sq, d), dtype=out_dtype, device=q.device)
    design = kernel_design(bits)
    lib = _build.library()
    with torch.cuda.device(q.device):
        err = lib.lowbit_fused_kv_attn_wgmma(
            q.data_ptr(), kp.data_ptr(), vp.data_ptr(), ks.data_ptr(), km.data_ptr(), vs.data_ptr(),
            vm.data_ptr(), o.data_ptr(), b, h, hk, sq, sk, d, bits, group, ks.shape[2], int(causal),
            int(q.dtype == torch.float32), int(out_dtype == torch.float32), row, float(sm_scale_log2e),
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    _build.check(err, "fused_packed_kv_attention")
    fused_packed_kv_attention.launches += 1
    fused_packed_kv_attention.launches_by_design[design] += 1
    fused_packed_kv_attention.launches_by_dim[d] += 1
    return o


def fused_packed_kv_attention(
    q: torch.Tensor,
    k_packed: torch.Tensor,
    v_packed: torch.Tensor,
    k_scale: torch.Tensor,
    k_mn: torch.Tensor,
    v_scale: torch.Tensor,
    v_mn: torch.Tensor,
    *,
    bits: int = 4,
    is_causal: bool = False,
    sm_scale: Optional[float] = None,
    group: int = 256,
    kernel_space: str = "q",
    out_dtype: torch.dtype = torch.bfloat16,
) -> torch.Tensor:
    """Attention with K and V resident as packed ``bits``-bit codes from
    :func:`quant_kv_grouped` with the same ``group``: ``q [B, H, Sq, D]``
    float, ``k_packed``/``v_packed [B, Hk, Sk, D*bits/8]``, scales and mns
    ``[B, Hk, ceil(Sk/group), D]``. Query head ``h`` reads KV head ``h //
    (H / Hk)``; ``sm_scale`` defaults to ``1/sqrt(D)``. Returns ``[B, H, Sq,
    D]`` in ``out_dtype``.

    ``kernel_space`` (the TPU's K-major schedule) is accepted and changes
    nothing; the TPU function's ``block_q`` and ``interpret`` are not
    ported.
    """
    if bits not in (4, 2):
        raise ValueError(f"bits must be 4 or 2, got {bits}")
    if kernel_space not in ("q", "k"):
        raise ValueError(f"unknown kernel_space {kernel_space!r}")
    if q.dim() != 4 or k_packed.dim() != 4:
        raise ValueError(f"q and the packed K/V must be 4-D: {tuple(q.shape)}, {tuple(k_packed.shape)}")
    b, h, sq, d = q.shape
    _, hk, sk, dp = k_packed.shape
    if dp * 8 != d * bits or tuple(v_packed.shape) != (b, hk, sk, dp) or k_packed.shape[0] != b:
        raise ValueError(f"packed K/V must be [B, Hk, Sk, D*bits/8] with D={d}: "
                         f"{tuple(k_packed.shape)}, {tuple(v_packed.shape)}")
    if hk == 0 or h % hk:
        raise ValueError(f"GQA requires num_q_heads ({h}) divisible by num_kv_heads ({hk})")
    n_groups = k_scale.shape[2]
    for t in (k_scale, k_mn, v_scale, v_mn):
        if tuple(t.shape) != (b, hk, n_groups, d):
            raise ValueError(f"scales and mns must be [B, Hk, nG, D] = {(b, hk, n_groups, d)}, got {tuple(t.shape)}")
    if n_groups * group < sk or sk == 0:
        raise ValueError(f"{n_groups} groups of {group} do not cover {sk} keys")
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    args = (q, k_packed, v_packed, k_scale, k_mn, v_scale, v_mn)
    kw = dict(bits=bits, group=group, causal=is_causal, sm_scale_log2e=float(sm_scale) * LOG2E,
              out_dtype=out_dtype)
    if q.device.type == "cpu":
        return fused_kv_attention_plain(*args, **kw)
    if q.device.type == "cuda":
        return _fused_kv_cuda(*args, **kw)
    raise ValueError(f"fused_packed_kv_attention runs on cpu or cuda tensors, not {q.device}")


#: Launches of kernel E in this process (CPU calls do not count), in all
#: and per design.
fused_packed_kv_attention.launches = 0
fused_packed_kv_attention.launches_by_design = {design: 0 for design in DESIGNS}
#: Launches per head dim.
fused_packed_kv_attention.launches_by_dim = {d: 0 for d in HEAD_DIMS}
