"""Every exchange of the parallel layer: all-reduce (sum, max), all-to-all,
all-gather and the ring shift, over a ``torch.distributed`` process group.

The counterpart of the XLA collectives that ``shard_map`` lowers the JAX
package's ``psum`` / ``pmax`` / ``all_to_all`` / ``ppermute`` to. Where the
tensors travel follows the group's backend, which the caller picks:

* NCCL: the tensors stay on the device, and the exchange is device to
  device;
* gloo: CUDA tensors go through host memory and back (gloo's collectives run
  on CPU tensors). This is how ranks that share one card exchange: NCCL
  refuses two ranks on one device.

The route is decided from the backend once per group and logged once; it is
never a reaction to a failure.

:func:`copy_to`, :func:`reduce_from` and :func:`gather_from` are the
exchanges that carry a gradient (``torch.autograd.Function``\\ s over the
ones above), for the tensor-, sequence- and FSDP-sharded DiT: each counts
its backward's exchange under its own site with ``.bwd`` appended.

A group of ``None`` is one rank alone: every exchange is the identity and
nothing is counted. ``Wire`` counts what this process sends, per call site
(``site``): calls, and bytes per dtype. The CPU tests read it to hold the
ring's payload to int8 codes.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Dict, List, Optional, Sequence

import torch
import torch.distributed as dist

log = logging.getLogger(__name__)

_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}


@dataclasses.dataclass
class SiteCount:
    calls: int = 0
    bytes: Dict[str, int] = dataclasses.field(default_factory=dict)


class Wire:
    """What this process sent, per call site: ``sent[site].calls`` and
    ``sent[site].bytes[str(dtype)]``. A rank's bytes are those its tensors
    carry onto the wire, once per exchange: an all-reduce counts its input,
    an all-to-all the chunks for the other ranks, a ring shift the tensors
    sent to the next rank, an all-gather its own shard."""

    def __init__(self):
        self.sent: Dict[str, SiteCount] = {}

    def reset(self) -> None:
        self.sent.clear()

    def add(self, site: str, tensors: Sequence[torch.Tensor], fraction: float = 1.0) -> None:
        c = self.sent.setdefault(site, SiteCount())
        c.calls += 1
        for t in tensors:
            key = str(t.dtype).replace("torch.", "")
            c.bytes[key] = c.bytes.get(key, 0) + int(t.numel() * t.element_size() * fraction)

    def summary(self) -> Dict[str, dict]:
        return {site: {"calls": c.calls, "bytes": dict(c.bytes)} for site, c in sorted(self.sent.items())}


#: The process's count (reset by callers around what they measure).
WIRE = Wire()

_logged_routes: set = set()


def size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def rank(group) -> int:
    return 0 if group is None else dist.get_rank(group)


def through_host(group, x: torch.Tensor) -> bool:
    """True where ``x`` must be copied to host memory for ``group``: a CUDA
    tensor on a group whose backend is not NCCL."""
    backend = str(dist.get_backend(group))
    host = x.device.type != "cpu" and backend != "nccl"
    route = (backend, x.device.type, host)
    if route not in _logged_routes:
        _logged_routes.add(route)
        log.info("parallel transport: %s group, %s tensors %s", backend, x.device.type,
                 "through host memory" if host else "in place")
    return host


def _on_wire(group, x: torch.Tensor) -> torch.Tensor:
    x = x.contiguous()
    return x.cpu() if through_host(group, x) else x


def all_reduce(x: torch.Tensor, group, *, op: str = "sum", site: str) -> torch.Tensor:
    """The elementwise sum or max of ``x`` over ``group``; a new tensor on
    ``x``'s device."""
    if size(group) == 1:
        return x
    WIRE.add(site, [x])
    buf = _on_wire(group, x)
    if buf.data_ptr() == x.data_ptr():  # all_reduce works in place: never on the caller's tensor
        buf = buf.clone()
    dist.all_reduce(buf, op=_OPS[op], group=group)
    return buf.to(x.device)


def all_to_all(x: torch.Tensor, group, *, split_dim: int, concat_dim: int, site: str) -> torch.Tensor:
    """JAX's tiled ``all_to_all``: ``x``'s ``split_dim`` is cut into
    ``size(group)`` chunks, chunk ``j`` goes to rank ``j``, and what arrives
    from rank ``j`` is placed ``j``-th along ``concat_dim`` (source-major)."""
    n = size(group)
    if n == 1:
        return x
    if x.shape[split_dim] % n:
        raise ValueError(f"all_to_all: dim {split_dim} of {tuple(x.shape)} does not split into {n} ranks")
    split_dim %= x.dim()
    concat_dim %= x.dim()
    chunks = x.unflatten(split_dim, (n, x.shape[split_dim] // n)).movedim(split_dim, 0)
    WIRE.add(site, [chunks], fraction=(n - 1) / n)
    buf = _on_wire(group, chunks)
    out = torch.empty_like(buf)
    dist.all_to_all_single(out, buf, group=group)
    return out.to(x.device).movedim(0, concat_dim).flatten(concat_dim, concat_dim + 1)


def all_gather(x: torch.Tensor, group, *, dim: int, site: str) -> torch.Tensor:
    """The ranks' ``x`` concatenated along ``dim`` in rank order."""
    n = size(group)
    if n == 1:
        return x
    WIRE.add(site, [x])
    buf = _on_wire(group, x)
    parts = [torch.empty_like(buf) for _ in range(n)]
    dist.all_gather(parts, buf, group=group)
    return torch.cat(parts, dim=dim).to(x.device)


def reduce_scatter(x: torch.Tensor, group, *, dim: int, site: str) -> torch.Tensor:
    """The sum of the ranks' ``x`` over ``group``, cut into ``size(group)``
    chunks along ``dim``; rank ``i`` gets chunk ``i`` (the inverse layout of
    :func:`all_gather`). Runs as an all-to-all of the chunks and a local sum
    in f32, rounded once to ``x``'s dtype: gloo has no reduce-scatter."""
    n = size(group)
    if n == 1:
        return x
    dim %= x.dim()
    if x.shape[dim] % n:
        raise ValueError(f"reduce_scatter: dim {dim} of {tuple(x.shape)} does not split into {n} ranks")
    got = all_to_all(x, group, split_dim=dim, concat_dim=dim, site=site)  # [.., n·chunk, ..], source-major
    return got.unflatten(dim, (n, x.shape[dim] // n)).float().sum(dim=dim).to(x.dtype)


class _CopyTo(torch.autograd.Function):
    """Identity forward; the gradient all-reduced (summed) over the group."""

    @staticmethod
    def forward(ctx, x, group, site):
        ctx.group, ctx.site = group, site
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.group, site=ctx.site + ".bwd"), None, None


class _ReduceFrom(torch.autograd.Function):
    """All-reduce (sum, in f32) forward; the gradient passed on as it is."""

    @staticmethod
    def forward(ctx, x, group, site):
        return all_reduce(x.float(), group, site=site)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _GatherFrom(torch.autograd.Function):
    """All-gather forward along ``dim``; the gradient reduce-scattered back
    to this rank's chunk."""

    @staticmethod
    def forward(ctx, x, group, dim, site):
        ctx.group, ctx.dim, ctx.site = group, dim, site
        return all_gather(x, group, dim=dim, site=site)

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter(g, ctx.group, dim=ctx.dim, site=ctx.site + ".bwd"), None, None, None


def copy_to(x: torch.Tensor, group, *, site: str) -> torch.Tensor:
    """Megatron's ``f``: ``x`` as it is, the same on every rank of ``group``;
    in the backward the ranks' gradients are summed (``site + ".bwd"``). The
    input of a column-parallel product."""
    return x if size(group) == 1 else _CopyTo.apply(x, group, site)


def reduce_from(x: torch.Tensor, group, *, site: str) -> torch.Tensor:
    """Megatron's ``g``: the sum of the ranks' partial ``x`` over ``group``,
    taken in f32; the gradient goes back to each rank as it is. The output
    of a row-parallel product."""
    return x.float() if size(group) == 1 else _ReduceFrom.apply(x, group, site)


def gather_from(x: torch.Tensor, group, *, dim: int, site: str) -> torch.Tensor:
    """:func:`all_gather` with a gradient: the backward reduce-scatters the
    whole tensor's gradient back to this rank's chunk (``site + ".bwd"``)."""
    return x if size(group) == 1 else _GatherFrom.apply(x, group, dim, site)


def ring_shift(tensors: Sequence[Optional[torch.Tensor]], group, *, site: str) -> List[Optional[torch.Tensor]]:
    """``ppermute`` by one: each rank sends ``tensors`` to the next rank of
    ``group`` (group rank ``i`` to ``(i + 1) % n``) and returns those of the
    previous one. ``None`` entries stay ``None``."""
    n = size(group)
    if n == 1:
        return list(tensors)
    live = [t for t in tensors if t is not None]
    WIRE.add(site, live)
    me = rank(group)
    nxt, prv = dist.get_global_rank(group, (me + 1) % n), dist.get_global_rank(group, (me - 1) % n)
    send = [_on_wire(group, t) for t in live]
    recv = [torch.empty_like(t) for t in send]
    ops = [dist.P2POp(dist.isend, t, nxt, group) for t in send]
    ops += [dist.P2POp(dist.irecv, t, prv, group) for t in recv]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    got = iter(r.to(t.device) for r, t in zip(recv, live))
    return [None if t is None else next(got) for t in tensors]
