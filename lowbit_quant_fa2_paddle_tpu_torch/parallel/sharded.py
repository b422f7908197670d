"""Head- and batch-sharded attention, the strategy facade, and the DiT's
attention swapped for a sharded one.

Counterpart of ``lowbit_quant_fa2_paddle_tpu/parallel/sharded.py``. The
xfuser degrees map onto mesh axes:

* ``data``  — batch shards (data parallel, and CFG parallel: the cond/uncond
  pair is a batch of 2);
* ``model`` — head shards (tensor parallel: attention needs no exchange);
* ``seq``   — Ulysses all-to-all or ring attention over sequence shards.

A rank's local inputs are its ``[B/data, H/model, S/seq, D]`` block.

The fully-sharded (ZeRO-3) layout of the DiT's parameters: :func:`fsdp_shardings`
is JAX's spec for each leaf, and :class:`FSDPDiT` a DiT of which a rank keeps
only its shard of each parameter, gathering a unit's tensors (the time
embedding, one block, the final layer) on use and dropping them after.
"""

from __future__ import annotations

import contextlib
import functools
from typing import Callable, Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.func import functional_call

from lowbit_quant_fa2_paddle_tpu_torch.core import lowbit_fa_qk_int8_pv_fp16
from lowbit_quant_fa2_paddle_tpu_torch.models import dit as dit_mod
from lowbit_quant_fa2_paddle_tpu_torch.parallel import transport
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


def fsdp_shardings(model: dit_mod.DiT, mesh: Mesh, *, axis: str = "data") -> Dict[str, Optional[int]]:
    """JAX's fully-sharded layout of ``model``'s parameters over ``mesh``'s
    ``axis``: for each leaf of the TPU package's tree (keyed by its path,
    ``models.dit.jax_param_paths``) the dimension, in JAX's layout, that is
    sharded, or ``None`` where the leaf stays replicated. The rule is JAX's:
    the dimensions largest first, the first whose size ``axis`` divides and
    is at least its size; a scalar, or a leaf with no such dimension, stays
    whole. ``model`` may live on the meta device: only shapes are read."""
    n = mesh.size(axis)
    params = dict(model.named_parameters())
    out = {}
    for path, name, transposed in dit_mod.jax_param_paths(model.cfg):
        shape = tuple(params[name].shape)
        shape = shape[::-1] if transposed else shape  # the port's [out, in] is JAX's w [in, out]
        out[path] = next((d for d in sorted(range(len(shape)), key=lambda i: -shape[i])
                          if shape[d] % n == 0 and shape[d] >= n), None)
    return out


def _port_dim(jax_dim: Optional[int], ndim: int, transposed: bool) -> Optional[int]:
    return None if jax_dim is None else (ndim - 1 - jax_dim if transposed else jax_dim)


class FSDPDiT(nn.Module):
    """A rank's fully-sharded DiT: each parameter as the chunk this rank's
    ``data`` index selects along its :func:`fsdp_shardings` dimension (the
    replicated ones whole). ``forward(x, t, attn_impl)`` has ``models.dit.DiT``'s
    semantics on this rank's rows: each unit's tensors (the time embedding,
    a block, the final layer) are gathered (``transport.gather_from``) just
    before the unit runs, as the unsharded module's parameters
    (``torch.func.functional_call`` on a template on the meta device), and
    dropped after it. Under autograd the gathered weights stay alive until
    the backward, whose gradients are reduce-scattered back to the shards;
    the replicated leaves enter through ``transport.copy_to``, whose backward
    all-reduces their gradients. Either way each shard's gradient is summed
    over the axis, so a data-sharded batch trains as ZeRO-3 does.
    Built by :meth:`from_model`; :meth:`gathered` is the whole model again."""

    def __init__(self, cfg: dit_mod.DiTConfig, mesh: Mesh, shards: Dict[str, torch.Tensor],
                 dims: Dict[str, Optional[int]]):
        super().__init__()
        self.cfg, self.group = cfg, mesh.group("data")
        self.names = list(shards)
        self.dims = dims
        self.shards = nn.ParameterList(nn.Parameter(shards[n], requires_grad=shards[n].requires_grad)
                                       for n in self.names)
        self._template = [dit_mod.DiT(cfg, device="meta")]  # a list: not a submodule, no parameters of ours

    @classmethod
    def from_model(cls, model: dit_mod.DiT, mesh: Mesh) -> "FSDPDiT":
        """This rank's shard of every parameter of ``model`` over ``data``
        (copies: the caller may free ``model``)."""
        spec = fsdp_shardings(model, mesh)
        params = dict(model.named_parameters())
        n, idx = mesh.size("data"), mesh.index("data")
        shards, dims = {}, {}
        for path, name, transposed in dit_mod.jax_param_paths(model.cfg):
            p = params[name].detach()
            dims[name] = _port_dim(spec[path], p.dim(), transposed)
            chunk = p if dims[name] is None else p.chunk(n, dim=dims[name])[idx]
            shards[name] = chunk.clone().requires_grad_(params[name].requires_grad)
        return cls(model.cfg, mesh, shards, dims)

    def _unit(self, prefix: str) -> Dict[str, torch.Tensor]:
        """The whole tensors of the parameters under ``prefix``, keyed by
        their names below it."""
        out = {}
        for name, shard in zip(self.names, self.shards):
            if name.startswith(prefix):
                d = self.dims[name]
                if d is None:
                    full = transport.copy_to(shard, self.group, site="fsdp.replicated")
                else:
                    full = transport.gather_from(shard, self.group, dim=d, site="fsdp.gather")
                out[name[len(prefix):]] = full
        return out

    def forward(self, x: torch.Tensor, t: torch.Tensor, attn_impl: str = "int8") -> torch.Tensor:
        tmpl = self._template[0]
        c = dit_mod.timestep_embedding(t, self.cfg.time_embed_dim, self.cfg.dtype)
        p = self._unit("t_in.")
        c = F.linear(c, p["weight"], p["bias"])
        p = self._unit("t_out.")
        c = F.linear(F.silu(c), p["weight"], p["bias"])
        for i, blk in enumerate(tmpl.blocks):
            x = functional_call(blk, self._unit(f"blocks.{i}."), (x, c, attn_impl))
        p = self._unit("final.")
        return F.linear(dit_mod._layer_norm(x), p["weight"], p["bias"])

    @torch.no_grad()
    def gathered(self) -> dit_mod.DiT:
        """The whole model from the ranks' shards (every rank of ``data``
        calls it), on the shards' device."""
        model = dit_mod._empty_model(self.cfg, self.shards[0].device)
        params = dict(model.named_parameters())
        for name, shard in zip(self.names, self.shards):
            d = self.dims[name]
            full = shard if d is None else transport.all_gather(shard.detach(), self.group, dim=d, site="fsdp.gather")
            params[name].copy_(full)
        return model
