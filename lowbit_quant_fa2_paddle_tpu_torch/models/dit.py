"""DiT denoiser (CogVideoX-2b class) on the low-bit attention API.

Counterpart of ``lowbit_quant_fa2_paddle_tpu/models/dit.py`` as an
``nn.Module``. The attention implementation is chosen per call:

* ``attn_impl="exact"`` — fp32 reference attention (``ops/reference.py``);
* ``attn_impl="fp"``    — kernel A in its bf16 FA-2 mode (the baseline);
* ``attn_impl="int8"``  — smooth-K INT8 QK through kernels C1 and A (the
  product);
* ``attn_impl="int8_v8"`` — INT8 QK and smooth-V per-channel INT8 V (C1, A);
* ``attn_impl="int4"``  — INT8 Q × packed INT4 K (C2, A);
* ``attn_impl="flash_train"`` — differentiable FA-2: kernel A forward,
  kernels G1/G2 backward (``ops/attention_bwd.py``);
* ``attn_impl="int8_train"`` — quantization-aware training: the int8
  serving path forward (C1, A), G1/G2 backward straight through.

``"int8_t"`` / ``"int4_t"`` / ``"fp_t"`` (the TPU package's transposed-space
dataflow, a layout device of the TPU) run the plain ``"int8"`` / ``"int4"`` /
``"fp"`` paths.

:func:`diffusion_loss` and :func:`sgd_train_step` train the model through
any impl (``"exact"`` runs autograd through the fp32 reference attention).

:func:`quantize_dit_params` packs the block projections per channel
(``ops.gemv.WQWeight``); at the CogVideoX shape their rows (17,776 tokens)
take the dequantize-once dense route, no F kernel. Models are built on the
CUDA card unless the caller passes another ``device``.

Flagship config: CogVideoX-2b's geometry, 30 heads × head_dim 64, hidden
1920, depth 30, ~17.8k tokens for a 49×480×720 video latent.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Mapping, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from lowbit_quant_fa2_paddle_tpu_torch.core import (
    lowbit_fa_qk_int4_pv_fp16,
    lowbit_fa_qk_int8_pv_fp16,
    lowbit_fa_qk_int8_pv_int8,
)
from lowbit_quant_fa2_paddle_tpu_torch.ops.attention import flash_attention_fp
from lowbit_quant_fa2_paddle_tpu_torch.ops.attention_bwd import flash_attention_trainable, lowbit_attention_trainable
from lowbit_quant_fa2_paddle_tpu_torch.ops.gemv import WQWeight
from lowbit_quant_fa2_paddle_tpu_torch.ops.reference import attention_reference


@dataclasses.dataclass(frozen=True)
class DiTConfig:
    dim: int = 1920
    depth: int = 30
    num_heads: int = 30
    mlp_ratio: float = 4.0
    time_embed_dim: int = 256
    dtype: torch.dtype = torch.bfloat16

    @property
    def head_dim(self) -> int:
        return self.dim // self.num_heads


def tiny_config(**kw) -> DiTConfig:
    base = dict(dim=128, depth=2, num_heads=4, time_embed_dim=32)
    base.update(kw)
    return DiTConfig(**base)


def cogvideox_2b_config(**kw) -> DiTConfig:
    """CogVideoX-2b attention geometry (30 heads, head_dim 64)."""
    base = dict(dim=1920, depth=30, num_heads=30, time_embed_dim=512)
    base.update(kw)
    return DiTConfig(**base)


def _attention(q, k, v, impl: str):
    """q/k/v: [B, H, S, D] (HND)."""
    if impl == "exact":
        return attention_reference(q, k, v)
    if impl in ("fp", "fp_t"):
        return flash_attention_fp(q, k, v).to(q.dtype)
    if impl in ("int8", "int8_t"):
        return lowbit_fa_qk_int8_pv_fp16(q, k, v)
    if impl == "int8_v8":
        return lowbit_fa_qk_int8_pv_int8(q, k, v)
    if impl in ("int4", "int4_t"):
        return lowbit_fa_qk_int4_pv_fp16(q, k, v)
    if impl == "flash_train":
        return flash_attention_trainable(q, k, v).to(q.dtype)
    if impl == "int8_train":
        return lowbit_attention_trainable(q, k, v).to(q.dtype)
    raise ValueError(f"unknown attn_impl {impl!r}")


def _layer_norm(x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """LayerNorm without affine: f32 statistics, population variance."""
    x32 = x.float()
    xc = x32 - x32.mean(dim=-1, keepdim=True)  # one centred copy for autograd to keep
    var = (xc**2).mean(dim=-1, keepdim=True)
    return (xc * torch.rsqrt(var + eps)).to(x.dtype)


def timestep_embedding(t: torch.Tensor, dim: int, dtype: torch.dtype) -> torch.Tensor:
    """Sinusoidal embedding ``[cos, sin]`` of diffusion timesteps ``t`` [B]."""
    half = dim // 2
    freqs = torch.exp(-math.log(10000.0) * torch.arange(half, dtype=torch.float32, device=t.device) / half)
    ang = t.float()[:, None] * freqs[None, :]
    return torch.cat([torch.cos(ang), torch.sin(ang)], dim=-1).to(dtype)


class DiTBlock(nn.Module):
    def __init__(self, cfg: DiTConfig, device=None):
        super().__init__()
        d, mlp_d = cfg.dim, int(cfg.mlp_ratio * cfg.dim)
        kw = dict(device=device, dtype=cfg.dtype)
        self.num_heads = cfg.num_heads
        self.qkv = nn.Linear(d, 3 * d, **kw)
        self.proj = nn.Linear(d, d, **kw)
        self.mlp_in = nn.Linear(d, mlp_d, **kw)
        self.mlp_out = nn.Linear(mlp_d, d, **kw)
        # adaLN modulation: shift/scale/gate for attention and MLP.
        self.ada = nn.Linear(cfg.time_embed_dim, 6 * d, **kw)

    def forward(self, x: torch.Tensor, c: torch.Tensor, attn_impl: str) -> torch.Tensor:
        b, s, d = x.shape
        h = self.num_heads
        mod = self.ada(F.silu(c))[:, None, :]
        sh_a, sc_a, g_a, sh_m, sc_m, g_m = mod.chunk(6, dim=-1)
        xa = _layer_norm(x) * (1 + sc_a) + sh_a
        qkv = self.qkv(xa).reshape(b, s, 3, h, d // h)
        q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))  # [B, H, S, hd]
        o = _attention(q, k, v, attn_impl).transpose(1, 2).reshape(b, s, d).to(x.dtype)
        x = x + g_a * self.proj(o)
        xm = _layer_norm(x) * (1 + sc_m) + sh_m
        return x + g_m * self.mlp_out(F.gelu(self.mlp_in(xm), approximate="tanh"))


class DiT(nn.Module):
    """Denoiser: ``forward(x [B, S, dim], t [B])`` -> predicted noise."""

    def __init__(self, cfg: DiTConfig, device=None):
        super().__init__()
        self.cfg = cfg
        te = cfg.time_embed_dim
        kw = dict(device=device, dtype=cfg.dtype)
        self.t_in = nn.Linear(te, te, **kw)
        self.t_out = nn.Linear(te, te, **kw)
        self.blocks = nn.ModuleList(DiTBlock(cfg, device) for _ in range(cfg.depth))
        self.final = nn.Linear(cfg.dim, cfg.dim, **kw)

    def forward(self, x: torch.Tensor, t: torch.Tensor, attn_impl: str = "int8") -> torch.Tensor:
        c = timestep_embedding(t, self.cfg.time_embed_dim, self.cfg.dtype)
        c = self.t_out(F.silu(self.t_in(c)))
        for blk in self.blocks:
            x = blk(x, c, attn_impl)
        return self.final(_layer_norm(x))


def dit_forward(model: DiT, x: torch.Tensor, t: torch.Tensor, *, attn_impl: str = "int8") -> torch.Tensor:
    """Denoiser forward: ``x`` [B, S, dim] noisy latents, ``t`` [B] timesteps
    -> predicted noise [B, S, dim]. The blocks run as a Python loop (the TPU
    package's ``scan_blocks`` is a compile-time device)."""
    return model(x, t, attn_impl=attn_impl)


def _empty_model(cfg: DiTConfig, device) -> DiT:
    """A DiT with uninitialised storage on ``device``, without the default
    init pass."""
    return DiT(cfg, device="meta").to_empty(device=device)


@torch.no_grad()
def init_dit_params(cfg: DiTConfig, generator: torch.Generator, device="cuda") -> DiT:
    """Random DiT drawn from the TPU package's init distributions: each dense
    ``w ~ N(0, 1/d_in)`` (``final``: ``N(0, 0.02²)``), zero biases; adaLN
    ``w ~ N(0, 0.02²)`` with gate biases 1 for the two gates and 0 for
    shifts and scales, so every block exercises its attention. ``generator``
    must live on ``device``."""
    model = _empty_model(cfg, device)
    dev = model.final.weight.device

    def dense(lin: nn.Linear, scale: Optional[float] = None) -> None:
        scale = 1.0 / math.sqrt(lin.in_features) if scale is None else scale
        w = torch.randn(lin.out_features, lin.in_features, generator=generator, device=dev)
        lin.weight.copy_(w * scale)
        lin.bias.zero_()

    dense(model.t_in)
    dense(model.t_out)
    d = cfg.dim
    for blk in model.blocks:
        for lin in (blk.qkv, blk.proj, blk.mlp_in, blk.mlp_out):
            dense(lin)
        dense(blk.ada, 0.02)
        blk.ada.bias[2 * d : 3 * d] = 1.0  # g_a
        blk.ada.bias[5 * d :] = 1.0  # g_m
    dense(model.final, 0.02)
    return model


@torch.no_grad()
def params_from_jax(tree: Mapping[str, Any], cfg: DiTConfig, device="cuda") -> DiT:
    """Load the TPU package's DiT param pytree, given as numpy arrays
    (``{"t_embed": {"in", "out"}, "blocks": [...], "final"}``, each dense a
    ``{"w": [d_in, d_out], "b": [d_out]}``). ``w`` is transposed for
    ``nn.Linear``; values are cast to ``cfg.dtype``."""
    model = _empty_model(cfg, device)
    if len(tree["blocks"]) != cfg.depth:
        raise ValueError(f"tree has {len(tree['blocks'])} blocks, config depth {cfg.depth}")

    def load(lin: nn.Linear, p: Mapping[str, Any]) -> None:
        w = torch.from_numpy(np.array(p["w"], dtype=np.float32))
        b = torch.from_numpy(np.array(p["b"], dtype=np.float32))
        if tuple(w.shape) != (lin.in_features, lin.out_features):
            raise ValueError(f"weight {tuple(w.shape)} does not fit {lin}")
        lin.weight.copy_(w.T)
        lin.bias.copy_(b)

    load(model.t_in, tree["t_embed"]["in"])
    load(model.t_out, tree["t_embed"]["out"])
    for blk, p in zip(model.blocks, tree["blocks"]):
        for name in ("qkv", "proj", "mlp_in", "mlp_out", "ada"):
            load(getattr(blk, name), p[name])
    load(model.final, tree["final"])
    return model


@torch.no_grad()
def params_to_jax(model: DiT) -> dict:
    """The TPU package's parameter tree of ``model`` as numpy f32 arrays
    (each dense ``{"w": [d_in, d_out], "b": [d_out]}``), the inverse of
    :func:`params_from_jax`: what ``utils.checkpoint.save_params`` writes.
    Packed-weight layers raise."""
    def dense(lin: nn.Module) -> dict:
        if not isinstance(lin, nn.Linear):
            raise TypeError(f"a packed {type(lin).__name__}: JAX's parameter files hold dense weights")
        return {"w": np.ascontiguousarray(lin.weight.detach().float().cpu().T.numpy()),
                "b": lin.bias.detach().float().cpu().numpy()}

    return {
        "t_embed": {"in": dense(model.t_in), "out": dense(model.t_out)},
        "blocks": [{name: dense(getattr(blk, name)) for name in ("qkv", "proj", "mlp_in", "mlp_out", "ada")}
                   for blk in model.blocks],
        "final": dense(model.final),
    }


def jax_param_paths(cfg: DiTConfig):
    """``(JAX path, port parameter name, transposed)`` for every leaf of the
    TPU package's parameter tree (paths as ``"blocks/0/qkv/w"``): each dense
    ``w`` [d_in, d_out] is the port's ``weight`` [d_out, d_in] transposed,
    each ``b`` its ``bias``. The layouts of ``parallel/`` read their specs on
    JAX's side through it."""
    dense = [("t_embed/in", "t_in"), ("t_embed/out", "t_out")]
    dense += [(f"blocks/{i}/{n}", f"blocks.{i}.{n}") for i in range(cfg.depth)
              for n in ("qkv", "proj", "mlp_in", "mlp_out", "ada")]
    dense.append(("final", "final"))
    for jax_path, name in dense:
        yield jax_path + "/w", name + ".weight", True
        yield jax_path + "/b", name + ".bias", False


_WQ_DIT_KEYS = ("qkv", "proj", "mlp_in", "mlp_out")


def quantize_dit_params(params: DiT, *, bits: int = 8) -> DiT:
    """A DiT whose block projections (qkv, proj, mlp_in, mlp_out, with their
    biases) are per-channel packed ``WQWeight`` layers; the adaLN
    modulation, the time embedding and the final head are the input's own
    modules (small and conditioning-critical, as in JAX)."""
    out = DiT.__new__(DiT)
    nn.Module.__init__(out)
    out.cfg, out.t_in, out.t_out, out.final = params.cfg, params.t_in, params.t_out, params.final
    out.blocks = nn.ModuleList()
    for blk in params.blocks:
        nb = DiTBlock.__new__(DiTBlock)
        nn.Module.__init__(nb)
        nb.num_heads, nb.ada = blk.num_heads, blk.ada
        for key in _WQ_DIT_KEYS:
            lin = getattr(blk, key)
            setattr(nb, key, WQWeight.from_dense(lin.weight, bits=bits, bias=lin.bias))
        out.blocks.append(nb)
    return out


# ---------------------------------------------------------------------------
# Training step (diffusion denoising MSE)
# ---------------------------------------------------------------------------


def draw_t_noise(x0: torch.Tensor, generator: torch.Generator):
    """A timestep ``t ~ U[0, 1)`` per batch row and unit-normal noise of
    ``x0``'s shape and dtype, from ``generator`` (on ``x0``'s device) — for
    callers without the TPU package's key, which :func:`diffusion_loss`
    draws from inside."""
    t = torch.rand(x0.shape[0], generator=generator, device=x0.device)
    noise = torch.randn(x0.shape, generator=generator, device=x0.device).to(x0.dtype)
    return t, noise


def diffusion_loss(model: DiT, x0: torch.Tensor, t: torch.Tensor, noise: torch.Tensor,
                   attn_impl: str = "exact") -> torch.Tensor:
    """DDPM-style epsilon-prediction MSE: ``xt = cos(πt/2)·x0 + sin(πt/2)·noise``
    (the two factors cast to x0's dtype first, as JAX does), then the f32
    mean of ``(model(xt, 1000·t) - noise)²``. ``t`` [B] and ``noise`` are
    given (JAX draws them from its key; :func:`draw_t_noise` draws them
    here)."""
    t = t.float()
    a = torch.cos(0.5 * math.pi * t)[:, None, None].to(x0.dtype)
    s = torch.sin(0.5 * math.pi * t)[:, None, None].to(x0.dtype)
    xt = a * x0 + s * noise
    pred = model(xt, t * 1000.0, attn_impl=attn_impl)
    return torch.mean((pred.float() - noise.float()) ** 2)


def sgd_train_step(model: DiT, batch: torch.Tensor, t: torch.Tensor, noise: torch.Tensor, lr: float = 1e-4,
                   attn_impl: str = "exact") -> torch.Tensor:
    """One SGD step on :func:`diffusion_loss`; updates ``model``'s parameters
    in place and returns the loss. Rounds as JAX's ``p - lr * g.astype(p.dtype)``:
    ``lr·g`` rounded to the parameter's dtype, then the subtraction rounded
    again (``p.add_(g, alpha=-lr)`` would round once and give other bf16
    values). The gradients are taken with ``torch.autograd.grad``, so none
    stays on the parameters after the step."""
    params = [p for p in model.parameters() if p.requires_grad]
    loss = diffusion_loss(model, batch, t, noise, attn_impl)
    grads = torch.autograd.grad(loss, params)
    with torch.no_grad():
        for p, g in zip(params, grads):
            p.sub_(lr * g.to(p.dtype))
    return loss.detach()
