"""Pipeline parallelism over a ``pp`` group (GPipe microbatching).

Counterpart of ``lowbit_quant_fa2_paddle_tpu/parallel/pipeline.py``. The layer
stack is cut into P stages, one per rank of the group; microbatches move
from stage to stage by the ring shift in the classic (M + P - 1)-step
schedule, and the last stage's outputs are all-reduced to every rank at the
end. ``make_pipelined_dit`` runs the DiT's blocks this way, the embeddings
and the final head on every rank.
"""

from __future__ import annotations

from typing import Callable

import torch

from lowbit_quant_fa2_paddle_tpu_torch.models import dit as dit_mod
from lowbit_quant_fa2_paddle_tpu_torch.parallel import transport
from lowbit_quant_fa2_paddle_tpu_torch.parallel.mesh import Mesh


def pipeline_apply(stage_fn: Callable, stage_params, x_microbatches: torch.Tensor, *, group) -> torch.Tensor:
    """``stage_fn(stage_params, x) -> x`` applies this rank's stage, for the
    microbatches ``[M, mb, ...]`` that every rank holds (only stage 0's
    injections are read). At step ``t`` stage ``p`` works on microbatch
    ``t - p``; a stage with nothing to do that step passes on what it holds
    without computing. Returns the last stage's outputs ``[M, mb, ...]`` on
    every rank."""
    n_stages, stage = transport.size(group), transport.rank(group)
    m = x_microbatches.shape[0]
    steps = m + n_stages - 1
    buf = torch.zeros_like(x_microbatches)
    state = torch.zeros_like(x_microbatches[0])
    for t in range(steps):
        mb = t - stage
        y = state
        if 0 <= mb < m:
            y = stage_fn(stage_params, x_microbatches[mb] if stage == 0 else state)
            if stage == n_stages - 1:
                buf[mb] = y
        if t < steps - 1:
            (state,) = transport.ring_shift([y], group, site="pipeline.shift")
    if stage != n_stages - 1:
        buf.zero_()
    return transport.all_reduce(buf, group, site="pipeline.out")


def make_pipelined_dit(mesh: Mesh, cfg: dit_mod.DiTConfig, *, axis_name: str = "pp", microbatches: int = 4,
                       attn_impl: str = "exact"):
    """The DiT's block stack pipelined over ``mesh``'s ``axis_name`` group:
    ``fn(model, x, t) -> eps`` with ``model`` a whole ``models.dit.DiT`` on
    every rank (depth divisible by the stages; a stage runs its own
    ``depth / P`` blocks). The batch splits into ``microbatches``, which share
    one timestep: the pipeline takes ``t[0]``'s conditioning for every row,
    the diffusion sampler's case. ``attn_impl`` is the blocks' attention
    (JAX's pipeline runs ``"exact"``)."""
    group = mesh.group(axis_name)
    n_stages, stage = transport.size(group), transport.rank(group)
    if cfg.depth % n_stages:
        raise ValueError(f"depth {cfg.depth} does not split into {n_stages} stages")
    per_stage = cfg.depth // n_stages

    def fn(model: dit_mod.DiT, x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        b, s, d = x.shape
        if b % microbatches:
            raise ValueError(f"batch {b} does not split into {microbatches} microbatches")
        mb = b // microbatches
        c = dit_mod.timestep_embedding(t, cfg.time_embed_dim, cfg.dtype)
        c = model.t_out(torch.nn.functional.silu(model.t_in(c)))
        c_rep = c[:1].expand(mb, -1)

        def stage_fn(blocks, xm):
            for blk in blocks:
                xm = blk(xm, c_rep, attn_impl)
            return xm

        blocks = model.blocks[stage * per_stage:(stage + 1) * per_stage]
        y = pipeline_apply(stage_fn, blocks, x.reshape(microbatches, mb, s, d), group=group).reshape(b, s, d)
        return model.final(dit_mod._layer_norm(y))

    return fn
