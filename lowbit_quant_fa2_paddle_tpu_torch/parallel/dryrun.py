"""The DiT's training step sharded over data × seq × model, and the
multi-rank dry run.

Counterpart of ``lowbit_quant_fa2_paddle_tpu/parallel/dryrun.py``. JAX jits
``sgd_train_step(attn_impl="int8_train")`` over a mesh with the parameters
laid out by :func:`param_shardings` and lets GSPMD place the exchanges. Here
each rank runs its own shard of the same step (:func:`sharded_sgd_train_step`
on a :class:`TPDiT`), with the exchanges written out:

* ``data``: batch rows are sharded;
* ``model``: Megatron-style tensor parallelism. ``qkv`` and ``mlp_in`` are
  column-parallel (their input's gradient summed over ``model`` in the
  backward: ``transport.copy_to``), ``proj`` and ``mlp_out`` row-parallel
  (their partial products summed over ``model`` in the forward:
  ``transport.reduce_from``), their biases added after the sum;
* ``seq``: token rows are sharded. The token-wise layers run on the local
  rows; attention gathers K and V over ``seq`` (``transport.gather_from``,
  whose backward reduce-scatters dK and dV), so each rank attends its own
  query rows against every key (kernel A forward, G1/G2 backward with Sq ≠
  Sk) for any head count, and smooth-K's mean is taken over the whole
  sequence, as in the single-process step.

The loss is the global mean: each rank sums its rows' squared errors over
the global element count, the gradients are summed over data × seq, and
every parameter then takes JAX's update ``p - bf16(lr·g)``. Replicated
parameters (adaLN, the embeddings, the final layer, the row-parallel biases)
get the whole gradient on every ``model`` rank, since the activations are
the same there after each row-parallel sum; so nothing is reduced over
``model``.

:func:`run_training_step_dryrun` is JAX's dry run for one rank of an
``n``-rank world: the sharded step at :func:`_factor`'s degrees, then the
pipelined DiT, the collectives, the sharded decode and the serving engine.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from lowbit_quant_fa2_paddle_tpu_torch.models import dit as dit_mod
from lowbit_quant_fa2_paddle_tpu_torch.parallel import mesh as M, transport
from lowbit_quant_fa2_paddle_tpu_torch.parallel.mesh import Mesh

#: Gradients are summed in f32 buckets of at most this many elements.
GRAD_BUCKET = 1 << 25


def _factor(n: int) -> Dict[str, int]:
    """JAX's split of ``n`` ranks into data/seq/model degrees, lighting every
    axis it can (8 -> 2 × 2 × 2; 4 -> data 2 × seq 2 × model 1)."""
    degrees = {"data": 1, "seq": 1, "model": 1}
    for axis in ("data", "seq", "model", "data", "seq", "model", "data"):
        if n % 2 == 0 and n > 1:
            degrees[axis] *= 2
            n //= 2
    degrees["data"] *= n  # the odd factor left
    return degrees


_COLUMN, _ROW = ("qkv", "mlp_in"), ("proj", "mlp_out")


def param_shardings(model: dit_mod.DiT, mesh: Optional[Mesh] = None) -> Dict[str, tuple]:
    """JAX's tensor-parallel spec of each leaf, keyed by its JAX path
    (``models.dit.jax_param_paths``), in JAX's layout: ``qkv``/``mlp_in``
    column-sharded on ``model`` (``(None, "model")``, their bias
    ``("model",)``), ``proj``/``mlp_out`` row-sharded (``("model", None)``,
    their bias replicated ``()``), the rest replicated. JAX's specs, for
    parity; :meth:`TPDiT.from_model` cuts ``qkv`` by whole heads."""
    del mesh  # the specs name the axis; its size does not change them
    out = {}
    for path, _, _ in dit_mod.jax_param_paths(model.cfg):
        names = path.split("/")
        leaf = names[-1]
        if any(n in names for n in _COLUMN):
            out[path] = (None, "model") if leaf == "w" else ("model",)
        elif any(n in names for n in _ROW):
            out[path] = ("model", None) if leaf == "w" else ()
        else:
            out[path] = ()
    return out


class TPBlock(nn.Module):
    """One DiT block's shard on a ``model`` rank: ``qkv`` for its heads,
    ``mlp_in`` for its hidden columns, ``proj``/``mlp_out`` for the matching
    input columns (their biases whole), ``ada`` whole."""

    def __init__(self, cfg: dit_mod.DiTConfig, heads: int, mlp_cols: int, device=None):
        super().__init__()
        d, hd = cfg.dim, cfg.head_dim
        kw = dict(device=device, dtype=cfg.dtype)
        self.heads = heads
        self.qkv = nn.Linear(d, 3 * heads * hd, **kw)
        self.proj = nn.Linear(heads * hd, d, **kw)
        self.mlp_in = nn.Linear(d, mlp_cols, **kw)
        self.mlp_out = nn.Linear(mlp_cols, d, **kw)
        self.ada = nn.Linear(cfg.time_embed_dim, 6 * d, **kw)

    def forward(self, x: torch.Tensor, c: torch.Tensor, attn_impl: str, model_group, seq_group) -> torch.Tensor:
        b, s, _ = x.shape
        h = self.heads
        mod = self.ada(F.silu(c))[:, None, :]
        sh_a, sc_a, g_a, sh_m, sc_m, g_m = mod.chunk(6, dim=-1)
        xa = transport.copy_to(dit_mod._layer_norm(x) * (1 + sc_a) + sh_a, model_group, site="tp.qkv_in")
        qkv = self.qkv(xa).reshape(b, s, 3, h, -1)
        q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))  # [B, H/model, S/seq, hd]
        k = transport.gather_from(k, seq_group, dim=2, site="seq.k")
        v = transport.gather_from(v, seq_group, dim=2, site="seq.v")
        o = dit_mod._attention(q, k, v, attn_impl).transpose(1, 2).reshape(b, s, -1).to(x.dtype)
        attn = transport.reduce_from(F.linear(o, self.proj.weight), model_group, site="tp.proj")
        x = x + g_a * (attn + self.proj.bias).to(x.dtype)
        xm = transport.copy_to(dit_mod._layer_norm(x) * (1 + sc_m) + sh_m, model_group, site="tp.mlp_in")
        hid = F.gelu(self.mlp_in(xm), approximate="tanh")
        out = transport.reduce_from(F.linear(hid, self.mlp_out.weight), model_group, site="tp.mlp_out")
        return x + g_m * (out + self.mlp_out.bias).to(x.dtype)


class TPDiT(nn.Module):
    """A rank's shard of the DiT for the data × seq × model step:
    ``forward(x, t, attn_impl)`` on this rank's ``[B/data, S/seq, dim]`` rows
    and ``[B/data]`` timesteps gives its rows of the predicted noise (the
    same on every ``model`` rank). Built by :meth:`from_model`;
    :meth:`gathered` is the whole model again."""

    def __init__(self, cfg: dit_mod.DiTConfig, mesh: Mesh, device=None):
        super().__init__()
        m = mesh.size("model")
        mlp_d = int(cfg.mlp_ratio * cfg.dim)
        if cfg.num_heads % m or mlp_d % m:
            raise ValueError(f"{cfg.num_heads} heads and {mlp_d} hidden columns do not split over model={m}")
        self.cfg, self.mesh = cfg, mesh
        te = cfg.time_embed_dim
        kw = dict(device=device, dtype=cfg.dtype)
        self.t_in = nn.Linear(te, te, **kw)
        self.t_out = nn.Linear(te, te, **kw)
        self.blocks = nn.ModuleList(TPBlock(cfg, cfg.num_heads // m, mlp_d // m, device) for _ in range(cfg.depth))
        self.final = nn.Linear(cfg.dim, cfg.dim, **kw)

    @staticmethod
    def _cuts(cfg: dit_mod.DiTConfig, m: int, idx: int):
        """(name in a block, slicer of the whole tensor) for this ``model``
        rank. The physical split is head-aligned: JAX's ``P(None, "model")``
        cuts the fused qkv weight (columns ``[3][heads][head_dim]``) into
        contiguous blocks, which at model 2 give rank 0 all of q and half of
        k (GSPMD reshuffles behind the scenes); a rank here must attend whole
        heads, so it takes q, k and v each for heads ``idx·H/m .. (idx+1)·H/m``.
        The products and sums are the same; only which rank holds which
        columns differs."""
        h, hd, d = cfg.num_heads, cfg.head_dim, cfg.dim
        hl, cols = h // m, int(cfg.mlp_ratio * d) // m
        heads = slice(idx * hl, (idx + 1) * hl)
        rows = slice(idx * cols, (idx + 1) * cols)
        return {
            "qkv.weight": lambda w: w.view(3, h, hd, d)[:, heads].reshape(3 * hl * hd, d),
            "qkv.bias": lambda b: b.view(3, h, hd)[:, heads].reshape(-1),
            "proj.weight": lambda w: w[:, idx * hl * hd:(idx + 1) * hl * hd],
            "mlp_in.weight": lambda w: w[rows],
            "mlp_in.bias": lambda b: b[rows],
            "mlp_out.weight": lambda w: w[:, rows],
        }

    @classmethod
    @torch.no_grad()
    def from_model(cls, model: dit_mod.DiT, mesh: Mesh) -> "TPDiT":
        """This ``model`` rank's shard of ``model`` (copies)."""
        dev = model.final.weight.device
        out = cls(model.cfg, mesh, device="meta").to_empty(device=dev)
        cuts = cls._cuts(model.cfg, mesh.size("model"), mesh.index("model"))
        mine = dict(out.named_parameters())
        for name, p in model.named_parameters():
            key = name.split(".", 2)[-1] if name.startswith("blocks.") else name
            mine[name].copy_(cuts[key](p) if key in cuts else p)
        return out

    def forward(self, x: torch.Tensor, t: torch.Tensor, attn_impl: str = "int8_train") -> torch.Tensor:
        mg, sg = self.mesh.group("model"), self.mesh.group("seq")
        c = dit_mod.timestep_embedding(t, self.cfg.time_embed_dim, self.cfg.dtype)
        c = self.t_out(F.silu(self.t_in(c)))
        for blk in self.blocks:
            x = blk(x, c, attn_impl, mg, sg)
        return self.final(dit_mod._layer_norm(x))

    @torch.no_grad()
    def gathered(self) -> dit_mod.DiT:
        """The whole model from the ``model`` ranks' shards (each of them
        calls it), on the shards' device: the inverse of :meth:`from_model`."""
        cfg, mg = self.cfg, self.mesh.group("model")
        m = self.mesh.size("model")
        h, hd, d = cfg.num_heads, cfg.head_dim, cfg.dim
        model = dit_mod._empty_model(cfg, self.final.weight.device)
        mine = dict(self.named_parameters())
        for name, p in model.named_parameters():
            key = name.split(".", 2)[-1] if name.startswith("blocks.") else name
            x = mine[name].detach()
            if key == "qkv.weight":
                x = transport.all_gather(x.view(3, h // m, hd, d), mg, dim=1, site="tp.gather").reshape(3 * d, d)
            elif key == "qkv.bias":
                x = transport.all_gather(x.view(3, h // m, hd), mg, dim=1, site="tp.gather").reshape(-1)
            elif key in ("proj.weight", "mlp_out.weight"):
                x = transport.all_gather(x, mg, dim=1, site="tp.gather")
            elif key in ("mlp_in.weight", "mlp_in.bias"):
                x = transport.all_gather(x, mg, dim=0, site="tp.gather")
            p.copy_(x)
        return model


def _sum_grads(grads: Sequence[torch.Tensor], groups: Sequence) -> List[torch.Tensor]:
    """Each gradient summed over every group in ``groups`` (``None`` skipped),
    in f32 buckets of at most ``GRAD_BUCKET`` elements, back in its dtype."""
    groups = [g for g in groups if transport.size(g) > 1]
    if not groups:
        return list(grads)
    out, i = [], 0
    while i < len(grads):
        j, n = i, 0
        while j < len(grads) and (j == i or n + grads[j].numel() <= GRAD_BUCKET):
            n += grads[j].numel()
            j += 1
        flat = torch.cat([g.reshape(-1).float() for g in grads[i:j]])
        for g in groups:
            flat = transport.all_reduce(flat, g, site="grads")
        for g, part in zip(grads[i:j], flat.split([g.numel() for g in grads[i:j]])):
            out.append(part.view(g.shape).to(g.dtype))
        i = j
    return out


def sharded_diffusion_loss(model: nn.Module, x0: torch.Tensor, t: torch.Tensor, noise: torch.Tensor, n_global: int,
                           attn_impl: str = "int8_train") -> torch.Tensor:
    """This rank's share of ``models.dit.diffusion_loss`` through a sharded
    DiT (a :class:`TPDiT`, or ``parallel.sharded.FSDPDiT``): its rows' summed
    squared error over ``n_global``, the element count of the global batch,
    so that the shares summed over the batch's axes are the global mean."""
    t = t.float()
    a = torch.cos(0.5 * math.pi * t)[:, None, None].to(x0.dtype)
    s = torch.sin(0.5 * math.pi * t)[:, None, None].to(x0.dtype)
    pred = model(a * x0 + s * noise, t * 1000.0, attn_impl=attn_impl)
    return ((pred.float() - noise.float()) ** 2).sum() / n_global


def sharded_sgd_train_step(model: TPDiT, x0: torch.Tensor, t: torch.Tensor, noise: torch.Tensor, lr: float = 1e-4,
                           attn_impl: str = "int8_train") -> torch.Tensor:
    """``models.dit.sgd_train_step`` on this rank's shard: ``x0``/``noise``
    its ``[B/data, S/seq, dim]`` rows, ``t`` its ``[B/data]`` timesteps.
    Updates the shard's parameters in place (``p - bf16(lr·g)`` after the
    gradients are summed over data × seq) and returns the global loss, the
    same on every rank."""
    mesh = model.mesh
    dg, sg = mesh.group("data"), mesh.group("seq")
    n_global = x0.numel() * mesh.size("data") * mesh.size("seq")
    params = [p for p in model.parameters() if p.requires_grad]
    loss = sharded_diffusion_loss(model, x0, t, noise, n_global, attn_impl)
    grads = _sum_grads(torch.autograd.grad(loss, params), (dg, sg))
    with torch.no_grad():
        for p, g in zip(params, grads):
            p.sub_(lr * g.to(p.dtype))
        total = loss.detach()
        for g in (dg, sg):
            total = transport.all_reduce(total, g, site="loss")
    return total


# ---------------------------------------------------------------------------
# The dry run
# ---------------------------------------------------------------------------


def _finite(x: torch.Tensor) -> bool:
    return bool(torch.isfinite(x.float()).all())


def _gen(device, seed: int) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed)


def _training_step(n: int, device) -> float:
    mesh = M.make_mesh(_factor(n))
    if not mesh.member:
        return float("nan")
    d_model, d_seq, d_data = mesh.size("model"), mesh.size("seq"), mesh.size("data")
    cfg = dit_mod.tiny_config(num_heads=max(4, d_model), dim=128 * max(1, d_model))
    b, s = 2 * d_data, 128 * d_seq
    model = dit_mod.init_dit_params(cfg, _gen(device, 0), device=device)
    x0 = torch.randn(b, s, cfg.dim, generator=_gen(device, 1), device=device).to(cfg.dtype)
    t, noise = dit_mod.draw_t_noise(x0, _gen(device, 2))
    tp = TPDiT.from_model(model, mesh)
    rows = ("data", "seq", None)
    loss = sharded_sgd_train_step(tp, M.shard(x0, mesh, rows), M.shard(t, mesh, ("data",)),
                                  M.shard(noise, mesh, rows), attn_impl="int8_train")
    if not _finite(loss):
        raise AssertionError(f"sharded int8_train step: loss {float(loss)}")
    return float(loss)


def _pipeline_dryrun(pp: int, device) -> None:
    """One pipelined DiT forward (``pp`` stages) on tiny shapes."""
    from lowbit_quant_fa2_paddle_tpu_torch.parallel.pipeline import make_pipelined_dit

    cfg = dit_mod.tiny_config(depth=2 * pp)
    mesh = M.make_mesh({"pp": pp})
    if not mesh.member:
        return
    model = dit_mod.init_dit_params(cfg, _gen(device, 0), device=device)
    mb = 2
    x = torch.randn(2 * mb, 64, cfg.dim, generator=_gen(device, 1), device=device).to(cfg.dtype)
    t = torch.full((2 * mb,), 10.0, device=device)
    with torch.no_grad():
        out = make_pipelined_dit(mesh, cfg, microbatches=mb)(model, x, t)
    if not _finite(out):
        raise AssertionError("pipelined DiT: non-finite output")


def _collectives_dryrun(n: int, device) -> None:
    """Ring attention with a k4v8 wire, the windowed ring and Ulysses with an
    int8 wire over a ``seq`` mesh of ``n`` ranks."""
    from lowbit_quant_fa2_paddle_tpu_torch.parallel import make_ring_attention, make_ulysses_attention

    mesh = M.make_mesh({"seq": n})
    if not mesh.member:
        return
    q, k, v = (M.shard(torch.randn(1, n, 128 * n, 64, generator=_gen(device, 3 + i), device=device).bfloat16(),
                       mesh, (None, None, "seq", None)) for i in range(3))
    for fn in (make_ring_attention(mesh, is_causal=True, k_bits=4, v_bits=8),
               make_ring_attention(mesh, is_causal=True, window_size=200),
               make_ulysses_attention(mesh, wire_bits=8)):
        if not _finite(fn(q, k, v)):
            raise AssertionError("collectives dry run: non-finite output")


def _sharded_decode_dryrun(n: int, device) -> None:
    """Context-sharded (LSE merge over ``seq``) and head-sharded (``model``)
    decode over int8 caches."""
    from lowbit_quant_fa2_paddle_tpu_torch.ops import decode as dec
    from lowbit_quant_fa2_paddle_tpu_torch.parallel import make_context_sharded_decode, make_head_sharded_decode

    b, h, hk, d, s = 2, 8, 4, 64, 256 * n
    q = torch.randn(b, h, d, generator=_gen(device, 5), device=device)
    k = torch.randn(b, hk, s, d, generator=_gen(device, 6), device=device).bfloat16()
    v = torch.randn(b, hk, s, d, generator=_gen(device, 7), device=device).bfloat16()
    kq, ksx = dec.quantize_token(k, bits=8)
    vq, vsx = dec.quantize_token(v, bits=8)
    lengths = torch.full((b,), s, dtype=torch.int32, device=device)
    cache = (None, None, "seq", None)
    mesh = M.make_mesh({"seq": n})
    if mesh.member:
        o = make_context_sharded_decode(mesh)(q, *(M.shard(x, mesh, sp) for x, sp in (
            (kq, cache), (vq, cache), (ksx, cache[:3]))), lengths, M.shard(vsx, mesh, cache[:3]))
        if not _finite(o):
            raise AssertionError("context-sharded decode: non-finite output")
    mesh = M.make_mesh({"model": n})
    if mesh.member:
        heads = (None, "model", None, None)
        o = make_head_sharded_decode(mesh)(M.shard(q, mesh, heads[:3]), M.shard(kq, mesh, heads),
                                           M.shard(vq, mesh, heads), M.shard(ksx, mesh, heads[:3]), lengths,
                                           M.shard(vsx, mesh, heads[:3]))
        if not _finite(o):
            raise AssertionError("head-sharded decode: non-finite output")


def _serving_engine_dryrun(device) -> None:
    """A few ``ServingEngine`` ticks (admission, prefill, batched paged
    decode, retirement), then a budgeted chunked prefill beside a decoding
    slot."""
    from lowbit_quant_fa2_paddle_tpu_torch import serving
    from lowbit_quant_fa2_paddle_tpu_torch.models import llm

    cfg = llm.LLMConfig(vocab=64, dim=64, depth=1, num_heads=2, num_kv_heads=1, max_seq=128)
    params = llm.init_llm_params(cfg, _gen(device, 0), device=device)
    eng = serving.ServingEngine(params, cfg, serving.ServingConfig(page_size=8, num_pages=16, max_batch=2))
    eng.add_request([1, 2, 3, 4, 5], 4)
    eng.add_request([5, 4, 3], 3)
    done = eng.run()
    if not (len(done) == 2 and all(len(t) > 0 for t in done.values())):
        raise AssertionError(f"serving engine: {done}")
    engb = serving.ServingEngine(params, cfg, serving.ServingConfig(page_size=8, num_pages=32, max_batch=2,
                                                                     prefill_budget=8))
    engb.add_request([1, 2, 3], 4)
    engb.step()  # seat the short request
    engb.add_request(list(range(1, 29)), 3)  # 28 tokens: 4 chunks
    done = engb.run()
    if not (len(done) == 2 and all(len(t) > 0 for t in done.values())):
        raise AssertionError(f"serving engine with a prefill budget: {done}")


def run_training_step_dryrun(n_devices: int, *, device="cuda") -> dict:
    """JAX's dry run for this rank of a world of at least ``n_devices``
    ranks (every rank of the world calls it: the meshes' groups are made
    collectively). The sharded ``int8_train`` step on ``tiny_config``
    (``num_heads=max(4, model)``, ``dim=128·max(1, model)``) at batch
    ``2·data`` and ``128·seq`` tokens, which must give a finite loss; with two
    or more ranks also the pipelined DiT, ring (k4v8, windowed) and Ulysses
    (int8 wire), context- and head-sharded decode and, on the world's rank
    0, the serving engine. ``device`` is where every rank computes (ranks
    may share one card). Returns the step's loss (``nan`` off the mesh)."""
    loss = _training_step(n_devices, device)
    if n_devices >= 2:
        degrees = _factor(n_devices)
        _pipeline_dryrun(min(2, n_devices), device)
        _collectives_dryrun(min(4, degrees["seq"] * degrees["data"] * degrees["model"]), device)
        _sharded_decode_dryrun(min(4, n_devices), device)
        if not dist.is_initialized() or dist.get_rank() == 0:
            _serving_engine_dryrun(device)
    return {"loss": loss, "degrees": _factor(n_devices)}
