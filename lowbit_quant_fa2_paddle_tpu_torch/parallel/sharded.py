"""Head- and batch-sharded attention, the strategy facade, and the DiT's
attention swapped for a sharded one.

Counterpart of ``lowbit_quant_fa2_paddle_tpu/parallel/sharded.py``. The
xfuser degrees map onto mesh axes:

* ``data``  — batch shards (data parallel, and CFG parallel: the cond/uncond
  pair is a batch of 2);
* ``model`` — head shards (tensor parallel: attention needs no exchange);
* ``seq``   — Ulysses all-to-all or ring attention over sequence shards.

A rank's local inputs are its ``[B/data, H/model, S/seq, D]`` block. The TPU
package's ``fsdp_shardings`` (a parameter layout for the sharded training
step) is not ported yet.
"""

from __future__ import annotations

import contextlib
import functools
from typing import Callable, Optional

from lowbit_quant_fa2_paddle_tpu_torch.core import lowbit_fa_qk_int8_pv_fp16
from lowbit_quant_fa2_paddle_tpu_torch.models import dit as dit_mod
from lowbit_quant_fa2_paddle_tpu_torch.parallel.mesh import Mesh
from lowbit_quant_fa2_paddle_tpu_torch.parallel.ring import ring_attention
from lowbit_quant_fa2_paddle_tpu_torch.parallel.ulysses import ulysses_attention


def make_head_parallel_attention(mesh: Mesh, *, attn_fn: Optional[Callable] = None, **attn_kw):
    """Batch over ``data``, heads over ``model``: each rank attends its own
    heads of its own rows, with no exchange (the caller's output projection
    does the communication). A callable on the local ``(q, k, v)``."""
    del mesh  # the shards are independent; the mesh only says how they were cut
    return attn_fn if attn_fn is not None else functools.partial(lowbit_fa_qk_int8_pv_fp16, **attn_kw)


def make_parallel_attention(
    mesh: Mesh,
    *,
    seq_strategy: str = "ulysses",
    is_causal: bool = False,
    seq_axis: str = "seq",
    **attn_kw,
):
    """Batch on ``data``, heads on ``model``, sequence on ``seq`` by
    ``seq_strategy`` (``"ulysses"``, ``"ring"`` or ``"none"``): a callable on
    the local ``(q, k, v)``."""
    group = mesh.group(seq_axis)
    if seq_strategy == "ulysses":
        return functools.partial(ulysses_attention, group=group, is_causal=is_causal, **attn_kw)
    if seq_strategy == "ring":
        return functools.partial(ring_attention, group=group, is_causal=is_causal, **attn_kw)
    if seq_strategy == "none":
        return functools.partial(lowbit_fa_qk_int8_pv_fp16, is_causal=is_causal, **attn_kw)
    raise ValueError(f"unknown seq_strategy {seq_strategy!r}")


@contextlib.contextmanager
def dit_attention(attn: Callable):
    """Run the DiT's attention as ``attn(q, k, v)`` (whatever ``attn_impl``
    a forward names) inside the block: with a sequence-sharded ``attn``, each
    rank then runs the token-wise layers on its own sequence shard
    ``[B, S/n, dim]`` (the JAX example's patch of ``models.dit._attention``)."""
    orig = dit_mod._attention
    dit_mod._attention = lambda q, k, v, impl: attn(q, k, v).to(q.dtype)
    try:
        yield
    finally:
        dit_mod._attention = orig
