"""Ulysses sequence parallelism: an all-to-all from sequence to head shards
around a local attention call, and back.

Counterpart of ``lowbit_quant_fa2_paddle_tpu/parallel/ulysses.py``. Each rank
holds ``[B, H, S/n, D]``; the reshard gives it ``[B, H/n, S, D]`` (its heads
over the whole sequence), attention runs locally, and the inverse reshard
returns ``[B, H, S/n, D]``. The head counts (and the KV head count) must
divide by the group's size.

``wire_bits=8`` quantizes before the reshard, so the all-to-alls carry int8
codes and scale rows in place of three bf16 tensors: Q and K as per-token
codes (kernel C1, K after the global smooth-K mean), V as codes of one
per-channel scale that the whole group shares (an all-reduce max of the
shards' column maxima), so codes from different shards agree after the
reshard. Kernel A then runs on the codes.
"""

from __future__ import annotations

import functools
from typing import Callable, Optional

import torch

from lowbit_quant_fa2_paddle_tpu_torch.core import lowbit_fa_qk_int8_pv_fp16
from lowbit_quant_fa2_paddle_tpu_torch.ops import quant as quant_ops
from lowbit_quant_fa2_paddle_tpu_torch.ops.attention import lowbit_attention
from lowbit_quant_fa2_paddle_tpu_torch.parallel import transport
from lowbit_quant_fa2_paddle_tpu_torch.parallel.mesh import Mesh


def ulysses_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    group,
    attn_fn: Optional[Callable] = None,
    is_causal: bool = False,
    wire_bits: Optional[int] = None,
    smooth_k: bool = True,
    kernel_space: str = "k",
    **attn_kw,
):
    """Ulysses attention on this rank's sequence shards (``[B, H, S/n, D]``)
    over ``group``. ``attn_fn(q, k, v)`` runs on the head shards (default:
    ``lowbit_fa_qk_int8_pv_fp16`` with ``is_causal`` and ``attn_kw``);
    ``wire_bits=8`` sends codes instead and runs kernel A on them, and takes
    no ``attn_fn``. ``smooth_k`` is read by the int8 wire alone: the default
    ``attn_fn`` always smooths K, as JAX's does."""
    del kernel_space
    n = transport.size(group)
    for name, x in (("query", q), ("key/value", k)):
        if x.shape[1] % n:
            raise ValueError(f"{name} heads {x.shape[1]} do not divide over {n} Ulysses ranks")

    def fwd(x, site):  # [B, H, S/n, ...] -> [B, H/n, S, ...]
        return transport.all_to_all(x, group, split_dim=1, concat_dim=2, site=site)

    def bwd(x):  # [B, H/n, S, D] -> [B, H, S/n, D]
        return transport.all_to_all(x, group, split_dim=2, concat_dim=1, site="ulysses.out")

    if wire_bits is not None:
        if wire_bits != 8:
            raise ValueError(f"wire_bits must be None or 8, got {wire_bits}")
        if attn_fn is not None:
            raise ValueError("wire_bits selects the built-in int8 kernel; it takes no attn_fn")
        km = None
        if smooth_k:
            k_sum = k.float().sum(dim=2, keepdim=True)
            km = transport.all_reduce(k_sum, group, site="ulysses.k_mean") / (n * k.shape[2])
        q_codes, q_scale = quant_ops.quant_int8(q, gran="per_token")
        k_codes, k_scale = quant_ops.quant_int8(k, km, gran="per_token")
        vf = v.float()
        amax = transport.all_reduce(vf.abs().amax(dim=2), group, op="max", site="ulysses.v_amax")  # [B, Hk, D]
        v_scale = quant_ops.absmax_scale(amax)
        v_codes = quant_ops.quant_codes(vf, v_scale[:, :, None, :])
        h_loc = v.shape[1] // n  # this rank's KV heads after the reshard
        idx = transport.rank(group)
        o = lowbit_attention(
            fwd(q_codes, "ulysses.q"), fwd(k_codes, "ulysses.k"), fwd(v_codes, "ulysses.v"),
            fwd(q_scale[..., None], "ulysses.q_scale")[..., 0], fwd(k_scale[..., None], "ulysses.k_scale")[..., 0],
            v_scale=v_scale[:, idx * h_loc:(idx + 1) * h_loc], is_causal=is_causal, out_dtype=v.dtype, **attn_kw,
        )
        return bwd(o)

    if attn_fn is None:
        # As JAX builds it: without smooth_k, so K is smoothed here whatever
        # smooth_k says (only the int8 wire above reads it).
        attn_fn = functools.partial(lowbit_fa_qk_int8_pv_fp16, is_causal=is_causal, **attn_kw)
    return bwd(attn_fn(fwd(q, "ulysses.q"), fwd(k, "ulysses.k"), fwd(v, "ulysses.v")))


def make_ulysses_attention(mesh: Mesh, *, axis_name: str = "seq", **kw):
    """Ulysses attention over ``mesh``'s ``axis_name`` group: a callable on
    this rank's sequence shards ``(q, k, v)``."""
    group = mesh.group(axis_name)

    def fn(q, k, v):
        return ulysses_attention(q, k, v, group=group, **kw)

    return fn
