"""Ring attention over a sequence group with base-2 LSE merging.

Counterpart of ``lowbit_quant_fa2_paddle_tpu/parallel/ring.py``. Each rank
holds a sequence shard of Q, K and V (rank ``i`` of the group holds positions
``[i·S/n, (i+1)·S/n)``). K and V travel around the ring as quantized codes
and scale rows: int8 K codes (half a bf16 K's bytes), packed INT4 under
``k_bits=4`` (a quarter), and per-channel int8 V codes with their scale
under ``v_bits=8``. Each hop runs kernel A on the local Q codes against the
visiting shard and merges the partial by its base-2 LSE.

* Smooth-K takes the global K mean: one all-reduce of the shards' sums.
* Causal: the hop from the diagonal shard runs causal; a shard from an
  earlier rank runs unmasked (or, under a window, causal at the query offset
  of the hop); a shard from a later rank is skipped, kernel and merge (a
  merge of zero weight changes nothing).
* A window of W keys runs ``min(n, 2 + (W - 2) // s_loc)`` hops; the
  rotation stops there, so the hops past it send nothing.
* The merge runs in hop order. ``return_lse`` gives the natural-log LSE
  with the smooth-K correction (GQA included), as the single-device entry
  points do.

``kernel_space`` is accepted and does nothing: the TPU package's K-major
schedule is a layout device of the TPU, and kernel A takes natural layouts.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from lowbit_quant_fa2_paddle_tpu_torch.core import _finish_lse
from lowbit_quant_fa2_paddle_tpu_torch.ops import quant as quant_ops
from lowbit_quant_fa2_paddle_tpu_torch.ops.attention import lowbit_attention
from lowbit_quant_fa2_paddle_tpu_torch.parallel import transport
from lowbit_quant_fa2_paddle_tpu_torch.parallel.mesh import Mesh


def _merge(state, o_p: torch.Tensor, lse2_p: torch.Tensor):
    """Streaming merge of a normalized partial ``(o_p, base-2 lse2_p)`` into
    the running ``(o_acc, l_acc, m)``: the partial's unnormalized share is
    ``o_p · 2^lse2_p``."""
    o_acc, l_acc, m = state
    m_new = torch.maximum(m, lse2_p)
    m_safe = torch.where(torch.isfinite(m_new), m_new, torch.zeros_like(m_new))
    a = torch.where(torch.isfinite(m), torch.exp2(m - m_safe), torch.zeros_like(m))
    b = torch.where(torch.isfinite(lse2_p), torch.exp2(lse2_p - m_safe), torch.zeros_like(lse2_p))
    return o_acc * a[..., None] + o_p.float() * b[..., None], l_acc * a + b, m_new


def n_hops(n: int, s_loc: int, window_size: Optional[int]) -> int:
    """Hops a ring of ``n`` shards of ``s_loc`` tokens runs: all of them, or
    under a window those whose shard holds a key some local query sees (hop
    ``t``'s closest pair is ``(t - 1)·s_loc + 1`` apart)."""
    if window_size is None:
        return n
    return min(n, 2 + (int(window_size) - 2) // s_loc) if window_size >= 2 else 1


def ring_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    group,
    is_causal: bool = False,
    window_size: Optional[int] = None,
    sm_scale: Optional[float] = None,
    smooth_k: bool = True,
    k_bits: int = 8,
    v_bits: Optional[int] = None,
    kernel_space: str = "k",
    return_lse: bool = False,
    **kernel_kw,
):
    """Quantized ring attention on this rank's shards ``q [B, H, S/n, D]``,
    ``k``/``v [B, Hk, S/n, D]`` over ``group`` (``None``: one rank).

    ``k_bits`` 8 (int8 K codes) or 4 (packed INT4 K); ``v_bits`` None
    (float V) or 8 (per-channel int8 V codes). ``kernel_kw`` goes to kernel
    A. Returns the local ``o`` in ``q.dtype`` and, with ``return_lse``, the
    natural-log LSE ``[B, H, S/n]``."""
    del kernel_space
    if k_bits not in (8, 4) or v_bits not in (None, 8):
        raise ValueError(f"k_bits must be 8 or 4 and v_bits None or 8, got {k_bits}, {v_bits}")
    if window_size is not None and not is_causal:
        raise ValueError("window_size requires is_causal")
    b, h, s_loc, d = q.shape
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    n, idx = transport.size(group), transport.rank(group)

    km = None
    if smooth_k:
        k_sum = k.float().sum(dim=2, keepdim=True)
        km = transport.all_reduce(k_sum, group, site="ring.k_mean") / (n * k.shape[2])

    q_codes, q_scale = quant_ops.quant_int8(q, gran="per_token")
    quant_k = quant_ops.quant_int4 if k_bits == 4 else quant_ops.quant_int8
    k_blk, k_s_blk = quant_k(k, km, gran="per_token")
    v_blk, v_s_blk = v, None
    if v_bits == 8:
        v_blk, v_s_blk, _ = quant_ops.quant_v_int8_per_channel(v)

    state = (torch.zeros((b, h, s_loc, d), dtype=torch.float32, device=q.device),
             torch.zeros((b, h, s_loc), dtype=torch.float32, device=q.device),
             torch.full((b, h, s_loc), -math.inf, dtype=torch.float32, device=q.device))
    window = None if window_size is None else int(window_size)
    hops = n_hops(n, s_loc, window)

    def attend(causal: bool, q_off: int = 0):
        return lowbit_attention(
            q_codes, k_blk, v_blk, q_scale, k_s_blk, v_scale=v_s_blk, k_pack_bits=k_bits, is_causal=causal,
            window_size=window, q_position_offset=q_off, sm_scale=sm_scale, return_lse=True,
            out_dtype=torch.float32, **kernel_kw,
        )

    for t in range(hops):
        src = (idx - t) % n
        if not is_causal:
            state = _merge(state, *attend(False))
        elif t == 0:
            state = _merge(state, *attend(True))
        elif src < idx:
            state = _merge(state, *(attend(True, q_off=t * s_loc) if window is not None else attend(False)))
        if t < hops - 1:
            k_blk, k_s_blk, v_blk, v_s_blk = transport.ring_shift([k_blk, k_s_blk, v_blk, v_s_blk], group,
                                                                  site="ring.kv")

    o_acc, l_acc, m = state
    l_safe = torch.where(l_acc == 0.0, torch.ones_like(l_acc), l_acc)
    o = (o_acc / l_safe[..., None]).to(q.dtype)
    if return_lse:
        return o, _finish_lse(m + torch.log2(l_safe), q, km, sm_scale)
    return o


def make_ring_attention(mesh: Mesh, *, axis_name: str = "seq", is_causal: bool = False, **kw):
    """Ring attention over ``mesh``'s ``axis_name`` group: a callable on this
    rank's sequence shards ``(q, k, v)``."""
    group = mesh.group(axis_name)

    def fn(q, k, v):
        return ring_attention(q, k, v, group=group, is_causal=is_causal, **kw)

    return fn
