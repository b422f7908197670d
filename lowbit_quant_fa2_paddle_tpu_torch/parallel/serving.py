"""Decode attention over sharded quantized KV caches (kernel D).

Counterpart of ``lowbit_quant_fa2_paddle_tpu/parallel/serving.py``:

* context-sharded decode: one sequence's cache cut along the sequence over
  the ranks of a group (long-context serving). Each rank runs kernel D over
  its shard at its local length ``clamp(len - idx·s_loc, 0, s_loc)``, and the
  partials merge by their base-2 LSE across ranks: a max all-reduce, then
  sum all-reduces of ``o·w`` and ``w`` (an empty shard has weight 0). Every
  rank gets the whole output.
* head-sharded decode: the tensor-parallel layout. KV-head shards decode
  independently, with no exchange.
"""

from __future__ import annotations

from typing import Optional

import torch

from lowbit_quant_fa2_paddle_tpu_torch.ops import decode as dec
from lowbit_quant_fa2_paddle_tpu_torch.parallel import transport
from lowbit_quant_fa2_paddle_tpu_torch.parallel.mesh import Mesh


def context_sharded_decode(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    k_scale: torch.Tensor,
    lengths: torch.Tensor,
    *,
    group,
    v_scale: Optional[torch.Tensor] = None,
    **kw,
):
    """``q`` ``[B, H, D]`` (the same on every rank); this rank's cache shard
    ``[B, Hk, S/n, D]`` and scales ``[B, Hk, S/n]``, rank ``i`` of ``group``
    holding positions ``[i·S/n, (i+1)·S/n)``; ``lengths`` ``[B]`` the global
    valid lengths. ``kw`` goes to ``decode_attention``. Returns ``o``
    ``[B, H, D]`` in ``q.dtype``."""
    idx = transport.rank(group)
    s_loc = k_cache.shape[2]
    loc_len = (lengths - idx * s_loc).clamp(0, s_loc).to(torch.int32)
    o_p, lse2 = dec.decode_attention(q, k_cache, v_cache, k_scale, loc_len, v_scale=v_scale, return_lse=True, **kw)
    m = transport.all_reduce(lse2, group, op="max", site="decode.lse_max")
    w = torch.exp2(lse2 - m)  # an empty shard: lse2 = -1e30, w = 0
    o_num = transport.all_reduce(o_p.float() * w[..., None], group, site="decode.o")
    w_den = transport.all_reduce(w, group, site="decode.w")
    return (o_num / torch.where(w_den == 0.0, torch.ones_like(w_den), w_den)[..., None]).to(q.dtype)


def make_context_sharded_decode(mesh: Mesh, *, axis_name: str = "seq", **kw):
    """Context-sharded decode over ``mesh``'s ``axis_name`` group: a callable
    ``(q, k_cache, v_cache, k_scale, lengths, v_scale)`` on this rank's
    cache shards."""
    group = mesh.group(axis_name)

    def fn(q, k_cache, v_cache, k_scale, lengths, v_scale):
        return context_sharded_decode(q, k_cache, v_cache, k_scale, lengths, group=group, v_scale=v_scale, **kw)

    return fn


def make_head_sharded_decode(mesh: Mesh, **kw):
    """Tensor-parallel decode: a callable ``(q, k_cache, v_cache, k_scale,
    lengths, v_scale)`` on this rank's query heads ``[B, H/n, D]`` and KV-head
    cache shards ``[B, Hk/n, S, D]``; no exchange."""
    del mesh  # the head shards are independent

    def fn(q, k_cache, v_cache, k_scale, lengths, v_scale):
        return dec.decode_attention(q, k_cache, v_cache, k_scale, lengths, v_scale=v_scale, **kw)

    return fn
