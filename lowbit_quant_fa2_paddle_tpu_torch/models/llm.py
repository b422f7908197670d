"""GQA transformer LM on the low-bit stack: causal INT8 prefill (kernels C1
and A), one-shot or in chunks -> quantized KV cache -> split-KV decode
(kernel D), with dense or packed weights (kernels F1/F2).

Counterpart of ``lowbit_quant_fa2_paddle_tpu/models/llm.py`` as an
``nn.Module``. Blocks hold bias-free ``wq``/``wk``/``wv``/``wo``/``w1``/``w2``
(``nn.Linear``, or ``ops.gemv.WQWeight`` after :func:`quantize_llm_params`)
and RMS norms ``ln1``/``ln2``; the model holds ``embed`` (tied with the
output projection) and ``ln_f``. Inference runs without autograd; the one
differentiable entry is :func:`llm_logits`, which ``models/train.py`` trains
through. Models are built on the CUDA card unless the caller passes another
``device``.

Cache precision per side is ``kv_bits``/``k_bits``/``v_bits`` in {16, 8, 4}
(bf16 rows, int8 codes or nibble-packed 4-bit codes; ``k_bits=4, v_bits=8``
is the KIVI-style k4v8 cache of the JAX package's 128K point). ``w_bits`` is
accepted and, as in JAX, read by nothing: :func:`quantize_llm_params` packs
the weights.

Long prompts prefill in chunks (:func:`llm_prefill_chunked`) at bounded
activation memory. On the card :func:`decode_tokens` runs its steps as one
captured CUDA graph, replayed once a token (the JAX package's jitted
``lax.scan``); CPU tensors take a Python loop over the plain versions.

``window_size`` makes it the Mistral-class sliding-window LM: each position
attends its last ``window_size`` tokens, itself included, at prefill (kernel
A's band) and at decode (kernel D's compacted window walk, which reads
O(window) cache rows a token), plus StreamingLLM's ``sink_size`` leading
tokens. The chunked prefill takes full causal attention only.

Greedy speculative decoding (:func:`speculative_generate`): a draft model
proposes ``spec_k`` tokens through :func:`decode_tokens` (its captured step
replayed once a token), the target scores them all in one
:func:`llm_verify_step` (kernel D over T query tokens, which streams each
cache once), and the caches roll back in place past the first mismatch, so
the output is the target's own greedy generation.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import math
import weakref
from typing import Any, List, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from lowbit_quant_fa2_paddle_tpu_torch.core import lowbit_fa_qk_int8_pv_fp16
from lowbit_quant_fa2_paddle_tpu_torch.ops import attention_bwd, fused_kv, gemv
from lowbit_quant_fa2_paddle_tpu_torch.ops import decode as dec
from lowbit_quant_fa2_paddle_tpu_torch.ops import quant as quant_ops
from lowbit_quant_fa2_paddle_tpu_torch.ops.attention import KERNEL_DIMS, flash_attention_fp, lowbit_attention
from lowbit_quant_fa2_paddle_tpu_torch.ops.gemv import WQWeight
from lowbit_quant_fa2_paddle_tpu_torch.ops.reference import attention_reference


@dataclasses.dataclass(frozen=True)
class LLMConfig:
    vocab: int = 256
    dim: int = 256
    depth: int = 2
    num_heads: int = 8
    num_kv_heads: int = 2
    max_seq: int = 512
    rope_theta: float = 10000.0
    dtype: torch.dtype = torch.float32
    kv_bits: int = 8
    k_bits: Optional[int] = None
    v_bits: Optional[int] = None
    w_bits: Optional[int] = None
    window_size: Optional[int] = None
    sink_size: int = 0

    def __post_init__(self):
        dec._check_bits(self.eff_k_bits, self.eff_v_bits)

    @property
    def head_dim(self) -> int:
        return self.dim // self.num_heads

    @property
    def eff_k_bits(self) -> int:
        return self.kv_bits if self.k_bits is None else self.k_bits

    @property
    def eff_v_bits(self) -> int:
        return self.kv_bits if self.v_bits is None else self.v_bits


def tiny_llm_config(**kw) -> LLMConfig:
    return LLMConfig(**kw)


def _rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    x32 = x.float()
    n = x32 * torch.rsqrt((x32 * x32).mean(dim=-1, keepdim=True) + eps)
    return (n * w.float()).to(x.dtype)


class RMSNorm(nn.Module):
    """RMS norm with f32 statistics and a learned scale (no bias)."""

    def __init__(self, dim: int, dtype: torch.dtype, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim, dtype=dtype, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _rms_norm(x, self.weight)


class LLMBlock(nn.Module):
    def __init__(self, cfg: LLMConfig, device=None):
        super().__init__()
        d, kv_d = cfg.dim, cfg.num_kv_heads * cfg.head_dim
        kw = dict(bias=False, device=device, dtype=cfg.dtype)
        self.wq = nn.Linear(d, d, **kw)
        self.wk = nn.Linear(d, kv_d, **kw)
        self.wv = nn.Linear(d, kv_d, **kw)
        self.wo = nn.Linear(d, d, **kw)
        self.w1 = nn.Linear(d, 4 * d, **kw)
        self.w2 = nn.Linear(4 * d, d, **kw)
        self.ln1 = RMSNorm(d, cfg.dtype, device)
        self.ln2 = RMSNorm(d, cfg.dtype, device)


class LLM(nn.Module):
    def __init__(self, cfg: LLMConfig, device=None):
        super().__init__()
        self.cfg = cfg
        self.embed = nn.Embedding(cfg.vocab, cfg.dim, device=device, dtype=cfg.dtype)
        self.blocks = nn.ModuleList(LLMBlock(cfg, device) for _ in range(cfg.depth))
        self.ln_f = RMSNorm(cfg.dim, cfg.dtype, device)

    def logits(self, x: torch.Tensor) -> torch.Tensor:
        """Final norm and the tied output projection ``x @ embed^T``."""
        return F.linear(self.ln_f(x), self.embed.weight)


_WQ_KEYS = ("wq", "wk", "wv", "wo", "w1", "w2")


def _empty_model(cfg: LLMConfig, device) -> LLM:
    return LLM(cfg, device="meta").to_empty(device=device).requires_grad_(False)


@torch.no_grad()
def init_llm_params(cfg: LLMConfig, generator: torch.Generator, device="cuda") -> LLM:
    """Random LLM from the JAX package's init distributions: each dense
    ``w ~ N(0, 1/d_in)``, ``embed ~ N(0, 0.02²)``, norms ones. ``generator``
    must live on ``device``."""
    model = _empty_model(cfg, device)
    dev = model.embed.weight.device

    def normal(shape, scale):
        return torch.randn(*shape, generator=generator, device=dev).mul_(scale)

    model.embed.weight.copy_(normal((cfg.vocab, cfg.dim), 0.02))
    for blk in model.blocks:
        for key in _WQ_KEYS:
            lin = getattr(blk, key)
            lin.weight.copy_(normal((lin.out_features, lin.in_features), 1.0 / math.sqrt(lin.in_features)))
        blk.ln1.weight.fill_(1.0)
        blk.ln2.weight.fill_(1.0)
    model.ln_f.weight.fill_(1.0)
    return model


@torch.no_grad()
def params_from_jax(tree: Mapping[str, Any], cfg: LLMConfig, device="cuda") -> LLM:
    """Load the JAX package's LLM param tree, given as numpy arrays
    (``{"embed": [vocab, dim], "blocks": [{"wq": [in, out], ...,
    "ln1", "ln2"}, ...], "ln_f"}``). Dense weights are transposed for
    ``nn.Linear``; values are cast to ``cfg.dtype``. A tree from JAX's
    ``quantize_llm_params`` has packed leaves (the JAX package's
    ``WQWeight`` holding numpy ``packed`` int8 ``[out, in*bits/8]`` and
    ``scale`` f32 ``[out]``, and ``bits``), which become ``WQWeight``
    layers as they are."""
    model = _empty_model(cfg, device)
    if len(tree["blocks"]) != cfg.depth:
        raise ValueError(f"tree has {len(tree['blocks'])} blocks, config depth {cfg.depth}")

    def arr(x) -> torch.Tensor:
        return torch.from_numpy(np.array(x, dtype=np.float32))

    def load(param: torch.Tensor, x, transpose=False) -> None:
        t = arr(x)
        t = t.T if transpose else t
        if tuple(t.shape) != tuple(param.shape):
            raise ValueError(f"weight {tuple(t.shape)} does not fit {tuple(param.shape)}")
        param.copy_(t)

    load(model.embed.weight, tree["embed"])
    load(model.ln_f.weight, tree["ln_f"])
    for blk, p in zip(model.blocks, tree["blocks"]):
        for key in _WQ_KEYS:
            leaf, lin = p[key], getattr(blk, key)
            if not hasattr(leaf, "packed"):
                load(lin.weight, leaf, transpose=True)
                continue
            dev = lin.weight.device
            w = WQWeight(torch.from_numpy(np.array(leaf.packed, dtype=np.int8)).to(dev),
                         torch.from_numpy(np.array(leaf.scale, dtype=np.float32)).to(dev), int(leaf.bits))
            if (w.out_features, w.in_features) != (lin.out_features, lin.in_features):
                raise ValueError(f"packed {key} {tuple(w.packed.shape)} does not fit {lin}")
            setattr(blk, key, w)
        load(blk.ln1.weight, p["ln1"])
        load(blk.ln2.weight, p["ln2"])
    return model


@torch.no_grad()
def params_to_jax(model: LLM) -> dict:
    """The JAX package's parameter tree of ``model`` as numpy f32 arrays
    (dense weights ``[in, out]``), the inverse of :func:`params_from_jax`:
    what ``utils.checkpoint.save_params`` writes. Packed-weight layers raise."""
    def arr(t: torch.Tensor, transpose=False) -> np.ndarray:
        x = t.detach().float().cpu()
        return np.ascontiguousarray((x.T if transpose else x).numpy())

    blocks = []
    for blk in model.blocks:
        entry = {}
        for key in _WQ_KEYS:
            lin = getattr(blk, key)
            if not isinstance(lin, nn.Linear):
                raise TypeError(f"{key} is a packed {type(lin).__name__}: JAX's parameter files hold dense weights")
            entry[key] = arr(lin.weight, transpose=True)
        entry["ln1"], entry["ln2"] = arr(blk.ln1.weight), arr(blk.ln2.weight)
        blocks.append(entry)
    return {"embed": arr(model.embed.weight), "blocks": blocks, "ln_f": arr(model.ln_f.weight)}


def quantize_llm_params(params: LLM, *, bits: int = 8) -> LLM:
    """A model whose six block matrices are per-channel packed ``WQWeight``
    layers (``bits`` 8 or 4, packed on the weights' device) and whose
    embedding and norms are the input's own modules, so the dense and the
    packed model live side by side at the cost of the packed bytes."""
    out = LLM.__new__(LLM)
    nn.Module.__init__(out)
    out.cfg, out.embed, out.ln_f = params.cfg, params.embed, params.ln_f
    out.blocks = nn.ModuleList()
    for blk in params.blocks:
        nb = LLMBlock.__new__(LLMBlock)
        nn.Module.__init__(nb)
        for key in _WQ_KEYS:
            setattr(nb, key, WQWeight.from_dense(getattr(blk, key).weight, bits=bits))
        nb.ln1, nb.ln2 = blk.ln1, blk.ln2
        out.blocks.append(nb)
    return out


def _mm(x: torch.Tensor, w: nn.Module) -> torch.Tensor:
    """``x @ W^T`` by weight type: ``nn.Linear`` runs PyTorch's dense matmul
    (as the JAX package leaves it to XLA), ``WQWeight`` the packed-weight
    matmul (kernel F1 or F2 below 1024 rows)."""
    return w(x)


def _rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: [B, H, S, D]; positions: [B, S] (may live on the device)."""
    d = x.shape[-1]
    exponent = -torch.arange(0, d // 2, dtype=torch.float32, device=x.device) / (d // 2)
    # theta as a scalar base (f32 pow, as a 0-d f32 tensor gives): no host
    # tensor is copied to the card, so a CUDA graph can capture this.
    freqs = torch.pow(float(theta), exponent)
    ang = positions.float()[:, None, :, None] * freqs  # [B, 1, S, D/2]
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., : d // 2], x[..., d // 2 :]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1).to(x.dtype)


def _attn_prefill(q, k, v, attn_impl: str, window=None, sink=0):
    if attn_impl in ("int8", "int8_t"):
        return lowbit_fa_qk_int8_pv_fp16(q, k, v, is_causal=True, window_size=window, sink_size=sink)
    if attn_impl in ("ref", "exact"):
        return attention_reference(q, k, v, is_causal=True, window_size=window, sink_size=sink)
    raise ValueError(f"unknown attn_impl {attn_impl!r}")


def _qkv(blk: LLMBlock, x: torch.Tensor, cfg: LLMConfig):
    b, s, _ = x.shape
    h, hk, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    xa = blk.ln1(x)
    q = _mm(xa, blk.wq).reshape(b, s, h, hd).transpose(1, 2)
    k = _mm(xa, blk.wk).reshape(b, s, hk, hd).transpose(1, 2)
    v = _mm(xa, blk.wv).reshape(b, s, hk, hd).transpose(1, 2)
    return q, k, v


def _mlp(blk: LLMBlock, x: torch.Tensor) -> torch.Tensor:
    return x + _mm(F.silu(_mm(blk.ln2(x), blk.w1)), blk.w2)


def _forward(params: LLM, tokens: torch.Tensor, cfg: LLMConfig, attn_impl: str, on_kv=None) -> torch.Tensor:
    """All-position logits ``[B, S, vocab]``; ``on_kv(k, v)`` sees each
    layer's roped K and V after the layer has run. Records autograd wherever
    the caller does."""
    b, s = tokens.shape
    x = params.embed(tokens)
    pos = torch.arange(s, device=tokens.device).expand(b, s)
    for blk in params.blocks:
        q, k, v = _qkv(blk, x, cfg)
        q = _rope(q, pos, cfg.rope_theta)
        k = _rope(k, pos, cfg.rope_theta)
        o = _attn_prefill(q, k, v, attn_impl, cfg.window_size, cfg.sink_size)
        x = x + _mm(o.transpose(1, 2).reshape(b, s, -1).to(x.dtype), blk.wo)
        x = _mlp(blk, x)
        if on_kv is not None:
            on_kv(k, v)
        del q, k, v, o
    return params.logits(x)


def llm_logits(params: LLM, tokens: torch.Tensor, cfg: LLMConfig, *, attn_impl: str = "ref") -> torch.Tensor:
    """The prompt's all-position logits ``[B, S, vocab]`` with no cache, and
    differentiable: what the JAX package's training differentiates through
    ``llm_prefill(..., attn_impl="ref")`` (``models/train.py``). ``attn_impl``
    as :func:`llm_prefill`'s; ``"ref"``, the exact fp32 attention, is the
    one that trains (the int8 path has no gradient)."""
    return _forward(params, tokens, cfg, attn_impl)


@torch.no_grad()
def llm_prefill(
    params: LLM,
    tokens: torch.Tensor,  # [B, S]
    cfg: LLMConfig,
    *,
    attn_impl: str = "int8",
) -> Tuple[torch.Tensor, List[dict]]:
    """Run the prompt through the model; returns ``(logits [B, S, vocab],
    per-layer quantized KV caches)`` with every cache at ``max_seq`` rows and
    ``length = S``. ``attn_impl``: ``"int8"`` (kernels C1 and A; ``"int8_t"``
    is the same) or ``"ref"`` (the exact fp32 oracle). Inference: records no
    autograd graph, whether or not the parameters ask for gradients
    (:func:`llm_logits` is the differentiable forward)."""
    b, s = tokens.shape
    hk, hd = cfg.num_kv_heads, cfg.head_dim
    caches = []

    def keep(k, v):  # the layer's cache from the prefill K/V, quantized per token
        cache = dec.init_kv_cache(b, hk, cfg.max_seq, hd, k_bits=cfg.eff_k_bits, v_bits=cfg.eff_v_bits,
                                  device=k.device)
        kq, ks = dec.quantize_token(k, bits=cfg.eff_k_bits)
        vq, vs = dec.quantize_token(v, bits=cfg.eff_v_bits)
        cache["k"][:, :, :s] = kq
        cache["v"][:, :, :s] = vq
        cache["k_scale"][:, :, :s] = ks
        cache["v_scale"][:, :, :s] = vs
        cache["length"].fill_(s)
        caches.append(cache)

    return _forward(params, tokens, cfg, attn_impl, keep), caches


def merge_lse(o1: torch.Tensor, l1: torch.Tensor, o2: torch.Tensor, l2: torch.Tensor) -> torch.Tensor:
    """Merge two partial attentions over disjoint key sets via their base-2
    LSEs (the contract of ring attention and prefix reuse)."""
    m = torch.maximum(l1, l2)
    w1 = torch.exp2(l1 - m)
    w2 = torch.exp2(l2 - m)
    den = w1 + w2
    o = o1.float() * (w1 / den)[..., None] + o2.float() * (w2 / den)[..., None]
    return o.to(o1.dtype)


def _dequant_cache_rows(codes: torch.Tensor, scale: torch.Tensor, bits: int, dtype: torch.dtype) -> torch.Tensor:
    """Per-token cache codes ``[.., S, Dc]`` -> values ``[.., S, D]`` in
    ``dtype`` (``Dc = D/2`` at 4 bits, halves of D)."""
    if bits == 16:
        return codes.to(dtype)
    vals = dec._unpack4_cols(codes) if bits == 4 else codes
    # One pass over the (strided) rows: the f32 product rounded once to
    # ``dtype``, the same bits as ``(vals.float() * scale).to(dtype)``.
    return torch.mul(vals, scale[..., None], out=torch.empty(vals.shape, dtype=dtype, device=vals.device))


@torch.no_grad()
def llm_prefill_chunked(
    params: LLM,
    tokens: torch.Tensor,  # [B, S]
    cfg: LLMConfig,
    *,
    chunk: int = 4096,
) -> Tuple[torch.Tensor, List[dict]]:
    """Prompt prefill in chunks of ``chunk`` tokens at bounded activation
    memory (a b4 128K prompt at dim 4096 prefills on one card; the one-shot
    prefill's activations would not fit). Per chunk and layer: causal
    attention within the chunk (K quantized per token by kernel C1, then
    kernel A with Q quantized in the kernel), and, past the first chunk,
    attention over the cache's first ``c0`` rows as they are stored (int8 K
    codes, packed 4-bit K codes or bf16 K into kernel A; V dequantized to
    bf16), the two merged through their base-2 LSEs (:func:`merge_lse`);
    then the chunk's K/V rows are quantized into the cache.

    The attention path quantizes K per chunk, not over the whole sequence
    as the one-shot prefill does, so the cache values follow
    :func:`llm_prefill`'s to cos > 0.999 (0.99 with 4-bit K) and the
    last-token logits to cos > 0.999 (0.995), as in JAX. Returns
    ``(last-token logits [B, vocab], caches)``."""
    b, s = tokens.shape
    if cfg.window_size is not None:
        raise ValueError("the chunked prefill takes full causal attention: window_size must be None")
    if s > cfg.max_seq:
        raise ValueError(f"a {s}-token prompt does not fit max_seq {cfg.max_seq}")
    if chunk < 1:
        raise ValueError(f"chunk must be positive, got {chunk}")
    caches = [dec.init_kv_cache(b, cfg.num_kv_heads, cfg.max_seq, cfg.head_dim, k_bits=cfg.eff_k_bits,
                                v_bits=cfg.eff_v_bits, device=tokens.device) for _ in params.blocks]
    x = None
    for c0 in range(0, s, chunk):
        x = _prefill_chunk(params, tokens[:, c0 : c0 + chunk], caches, c0, cfg)
    return params.logits(x[:, -1]), caches


def _attend_cache(q: torch.Tensor, cache: dict, c0: int, cfg: LLMConfig):
    """Non-causal attention of a chunk's queries over the cache's first
    ``c0`` rows, with its base-2 LSE: kernel A on the int8 or packed 4-bit K
    codes with their scales (Q quantized in the kernel), or in bf16 for a
    bf16 K; V dequantized to bf16. The row slices are strided views of the
    ``S_max``-row cache, which kernel A copies contiguous."""
    kb, vb = cfg.eff_k_bits, cfg.eff_v_bits
    v_pre = _dequant_cache_rows(cache["v"][:, :, :c0], cache["v_scale"][:, :, :c0], vb, torch.bfloat16)
    k_pre = cache["k"][:, :, :c0]
    if kb == 16:
        return flash_attention_fp(q, k_pre, v_pre, return_lse=True)
    pack = kb
    if kb == 4 and cfg.head_dim not in KERNEL_DIMS:
        # Kernel A takes packed K at its own head dims (64, 128, 256, 512)
        # only; the unpacked codes are the same values in its int8 mode.
        k_pre, pack = quant_ops.unpack_int4(k_pre), 8
    return lowbit_attention(q, k_pre, v_pre, k_scale=cache["k_scale"][:, :, :c0], k_pack_bits=pack,
                            return_lse=True)


def _prefill_chunk(params: LLM, toks: torch.Tensor, caches: List[dict], c0: int, cfg: LLMConfig) -> torch.Tensor:
    """One chunk of :func:`llm_prefill_chunked` at positions ``c0 ..``:
    writes its rows into every layer's cache (in place) and returns the
    last layer's activations ``[B, sc, dim]``."""
    b, sc = toks.shape
    x = params.embed(toks)
    pos = (c0 + torch.arange(sc, device=toks.device)).expand(b, sc)
    for blk, cache in zip(params.blocks, caches):
        q, k, v = _qkv(blk, x, cfg)
        q = _rope(q, pos, cfg.rope_theta)
        k = _rope(k, pos, cfg.rope_theta)
        kc, ksc = quant_ops.quant_int8(k, gran="per_token")
        o, lse = lowbit_attention(q, kc, v.to(torch.bfloat16), k_scale=ksc, is_causal=True, return_lse=True)
        del kc, ksc
        if c0 > 0:
            o_pre, lse_pre = _attend_cache(q, cache, c0, cfg)
            o = merge_lse(o_pre, lse_pre, o, lse)
            del o_pre, lse_pre
        x = x + _mm(o.transpose(1, 2).reshape(b, sc, -1).to(x.dtype), blk.wo)
        del q, o, lse
        x = _mlp(blk, x)
        kq, ks = dec.quantize_token(k, bits=cfg.eff_k_bits)
        vq, vs = dec.quantize_token(v, bits=cfg.eff_v_bits)
        cache["k"][:, :, c0 : c0 + sc] = kq
        cache["v"][:, :, c0 : c0 + sc] = vq
        cache["k_scale"][:, :, c0 : c0 + sc] = ks
        cache["v_scale"][:, :, c0 : c0 + sc] = vs
        cache["length"].fill_(c0 + sc)
        del k, v, kq, vq
    return x


@torch.no_grad()
def llm_decode_step(
    params: LLM,
    token: torch.Tensor,  # [B]
    caches: List[dict],
    cfg: LLMConfig,
) -> Tuple[torch.Tensor, List[dict]]:
    """One autoregressive step through kernel D: appends the token's K/V to
    every layer's cache (in place; see ``ops.decode.append_kv``) and returns
    ``(logits [B, vocab], caches)``. The position is each cache's device
    ``length``; nothing is read back to the host."""
    b = token.shape[0]
    x = params.embed(token)[:, None, :]  # [B, 1, D]
    pos = caches[0]["length"][:, None]  # [B, 1]
    new_caches = []
    for blk, cache in zip(params.blocks, caches):
        q, k, v = _qkv(blk, x, cfg)
        q = _rope(q, pos, cfg.rope_theta)[:, :, 0]  # [B, H, hd]
        k = _rope(k, pos, cfg.rope_theta)[:, :, 0]
        cache = dec.append_kv(cache, k, v[:, :, 0])
        o = dec.decode_attention(
            q, cache["k"], cache["v"], cache["k_scale"], cache["length"],
            v_scale=cache["v_scale"], k_bits=cfg.eff_k_bits, v_bits=cfg.eff_v_bits,
            window_size=cfg.window_size, sink_size=cfg.sink_size,
        )  # [B, H, hd]
        x = x + _mm(o.reshape(b, 1, -1).to(x.dtype), blk.wo)
        x = _mlp(blk, x)
        new_caches.append(cache)
    return params.logits(x[:, 0]), new_caches


def _counted_wrappers() -> tuple:
    """Every kernel wrapper that counts its launches."""
    return (quant_ops.quant_int8, quant_ops.quant_int4, quant_ops.quant_int2, lowbit_attention,
            dec.decode_attention, gemv.wq_matmul_per_channel, gemv.wq_matmul_fused,
            fused_kv.fused_packed_kv_attention, attention_bwd.attention_bwd_dq, attention_bwd.attention_bwd_dkv)


#: The per-key launch counters a wrapper may keep beside its per-design
#: ones: kernel D per variant, kernels A, D, E, G1/G2 per head dim, kernels
#: D and F1/F2 per split count of their plan.
_BY_KEYS = ("variant", "dim", "splits")


def _launch_counts() -> dict:
    """The launch counters, in all (key None), per design (the design's
    name) and per :data:`_BY_KEYS` key (``(kind, key)``, e.g. ``("variant",
    key)`` for kernel D's variants, ``("dim", d)`` per head dim)."""
    out = {}
    for w in _counted_wrappers():
        out[(w, None)] = w.launches
        for design, n in getattr(w, "launches_by_design", {}).items():
            out[(w, design)] = n
        for kind in _BY_KEYS:
            for key, n in getattr(w, f"launches_by_{kind}", {}).items():
                out[(w, (kind, key))] = n
    return out


def _add_launch_counts(counts: dict, times: int = 1) -> None:
    for (w, key), n in counts.items():
        if key is None:
            w.launches += n * times
        elif isinstance(key, tuple):
            by = getattr(w, f"launches_by_{key[0]}")
            by[key[1]] = by.get(key[1], 0) + n * times
        else:
            w.launches_by_design[key] += n * times


def _graph_step(params: LLM, tok: torch.Tensor, caches: List[dict], cfg: LLMConfig) -> None:
    """One greedy step in place: ``tok`` becomes the argmax successor and
    every cache's ``length`` buffer advances by one (as its rows do)."""
    logits, new = llm_decode_step(params, tok, caches, cfg)
    tok.copy_(torch.argmax(logits, dim=-1))
    for cache, nc in zip(caches, new):
        cache["length"].copy_(nc["length"])


@contextlib.contextmanager
def capture_graph(graph: "torch.cuda.CUDAGraph"):
    """``torch.cuda.graph(graph)`` with Python's cyclic garbage collector
    paused until the capture ends: a CUDA graph that the collector frees
    during a capture (one of an engine dropped earlier, whose programs sit
    in a reference cycle) resets itself there, which CUDA forbids while a
    stream captures, and the capture fails. The collector frees it after."""
    enabled = gc.isenabled()
    gc.disable()
    try:
        with torch.cuda.graph(graph):
            yield
    finally:
        if enabled:
            gc.enable()


class _DecodeGraph:
    """A captured decode step: what it was captured for (``key``; the model
    by weak reference), its token buffer and the launches one replay makes,
    per counter."""

    def __init__(self, key: tuple, params: LLM, graph: "torch.cuda.CUDAGraph", tok: torch.Tensor, launches: dict):
        self.key, self.params, self.graph, self.tok, self.launches = key, weakref.ref(params), graph, tok, launches


#: The most recently captured decode step (its pool holds the step's
#: intermediate buffers, not the model or the caches). A further
#: :func:`decode_tokens` call on the same model, config and cache tensors
#: replays it; any other call releases it before capturing its own.
_last_graph: Optional[_DecodeGraph] = None
_CACHE_KEYS = ("k", "v", "k_scale", "v_scale", "length")


def _graph_key(params: LLM, caches: List[dict], cfg: LLMConfig, token: torch.Tensor) -> tuple:
    tensors = tuple((t.data_ptr(), tuple(t.shape), t.dtype) for c in caches for t in (c[k] for k in _CACHE_KEYS))
    return (id(params), cfg, tuple(token.shape), token.device, tensors)


def _decode_tokens_graph(params, token, caches, n, cfg):
    """:func:`decode_tokens` on the card: the step (``_graph_step``) is
    captured once per (model, config, cache tensors) and replayed once a
    token. A new capture runs the first step eagerly on a side stream
    before capturing, so the kernels are built and every lazily made buffer
    (kernel D's tickets, F1/F2's merge tickets, the occupancy query, cuBLAS'
    workspace) exists before the capture. A failed capture raises."""
    global _last_graph
    dev = token.device
    out = torch.empty((token.shape[0], n), dtype=torch.int32, device=dev)
    key = _graph_key(params, caches, cfg, token)
    entry = _last_graph
    first = 0
    if entry is None or entry.key != key or entry.params() is not params:
        _last_graph = entry = None
        tok = token.to(torch.int32).clone()
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            _graph_step(params, tok, caches, cfg)
        torch.cuda.current_stream(dev).wait_stream(side)
        out[:, 0].copy_(tok)
        first = 1
        if n == 1:
            return out, caches
        graph = torch.cuda.CUDAGraph()
        before = _launch_counts()
        with capture_graph(graph):
            _graph_step(params, tok, caches, cfg)
        after = _launch_counts()
        # The capture recorded the launches; none ran. Each replay runs them.
        launches = {k: after[k] - before.get(k, 0) for k in after}
        _add_launch_counts(launches, -1)
        _last_graph = entry = _DecodeGraph(key, params, graph, tok, launches)
    else:
        entry.tok.copy_(token)
    for i in range(first, n):
        entry.graph.replay()
        _add_launch_counts(entry.launches)
        out[:, i].copy_(entry.tok)
    return out, caches


@torch.no_grad()
def decode_tokens(
    params: LLM,
    token: torch.Tensor,  # [B], the token fed at the current position
    caches: List[dict],
    n: int,
    cfg: LLMConfig,
) -> Tuple[torch.Tensor, List[dict]]:
    """Greedy-decode ``n`` tokens with the argmax kept on the device, so no
    step waits for the host. Returns ``(tokens [B, n] int32, caches)``; the
    same tokens and cache contents as looping :func:`llm_decode_step` by
    hand. The given caches advance in place, their ``length`` buffers
    included, and come back as they are.

    On the card the steps run as one captured CUDA graph of
    :func:`llm_decode_step` and the argmax, replayed once a token (the JAX
    package's jitted ``lax.scan``); a second call on the same caches
    replays the same graph. CPU tensors run the same step in a Python loop
    over the plain versions."""
    if n < 1:
        return torch.empty((token.shape[0], 0), dtype=torch.int32, device=token.device), caches
    if token.device.type == "cuda":
        return _decode_tokens_graph(params, token, caches, n, cfg)
    tok = token.to(torch.int32).clone()
    out = torch.empty((token.shape[0], n), dtype=torch.int32)
    for i in range(n):
        _graph_step(params, tok, caches, cfg)
        out[:, i] = tok
    return out, caches


@torch.no_grad()
def generate(
    params: LLM,
    prompt: torch.Tensor,  # [B, S]
    n_new: int,
    cfg: LLMConfig,
    *,
    attn_impl: str = "int8",
) -> torch.Tensor:
    """Greedy generation: prefill, then :func:`decode_tokens` (one CUDA graph
    of the step on the card). Returns ``[B, n_new]`` int32 tokens."""
    logits, caches = llm_prefill(params, prompt, cfg, attn_impl=attn_impl)
    token = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
    del logits
    if n_new == 1:
        return token[:, None]
    toks, _ = decode_tokens(params, token, caches, n_new - 1, cfg)
    return torch.cat([token[:, None], toks], dim=1)


def rollback_caches(caches: List[dict], lengths: torch.Tensor) -> List[dict]:
    """Set every layer cache's length IN PLACE: each cache's own ``length``
    buffer takes ``lengths``, and the caches come back as they are. Rows
    past it are dead (every consumer masks ``pos < length``) and the next
    append overwrites them. Since the buffers stay the same tensors, a
    :func:`decode_tokens` call on rolled-back caches replays the step it
    captured for them (its key holds the buffers' addresses) instead of
    capturing a new one."""
    for c in caches:
        c["length"].copy_(lengths)
    return caches


@torch.no_grad()
def llm_verify_step(
    params: LLM,
    tokens: torch.Tensor,  # [B, T]: the last accepted token, then the drafts
    caches: List[dict],
    cfg: LLMConfig,
) -> Tuple[torch.Tensor, List[dict]]:
    """The speculative verify step: feeds T tokens at once at positions
    ``length .. length + T - 1``, appends their K/V to every layer's cache
    (in place, ``ops.decode.append_kv_multi``; ``length += T``) and runs
    kernel D over the T query tokens, token ``t`` seeing its causal prefix
    (under ``window_size``/``sink_size`` its own window), so each cache is
    streamed once for all T. Returns ``(logits [B, T, vocab], caches)``:
    row ``t`` scores the successor of fed token ``t``. On a rejection the
    caller rolls the lengths back with :func:`rollback_caches`. Runs
    eagerly."""
    b, t = tokens.shape
    x = params.embed(tokens)  # [B, T, D]
    pos = caches[0]["length"][:, None] + torch.arange(t, device=tokens.device)  # [B, T]
    new_caches = []
    for blk, cache in zip(params.blocks, caches):
        q, k, v = _qkv(blk, x, cfg)
        q = _rope(q, pos, cfg.rope_theta)  # [B, H, T, hd]
        k = _rope(k, pos, cfg.rope_theta)
        cache = dec.append_kv_multi(cache, k, v)
        o = dec.decode_attention(
            q.transpose(1, 2), cache["k"], cache["v"], cache["k_scale"], cache["length"],
            v_scale=cache["v_scale"], k_bits=cfg.eff_k_bits, v_bits=cfg.eff_v_bits,
            window_size=cfg.window_size, sink_size=cfg.sink_size,
        )  # [B, T, H, hd]
        x = x + _mm(o.reshape(b, t, -1).to(x.dtype), blk.wo)
        x = _mlp(blk, x)
        new_caches.append(cache)
    return params.logits(x), new_caches


@torch.no_grad()
def speculative_generate(
    params: LLM,
    prompt: torch.Tensor,  # [1, S]
    n_new: int,
    cfg: LLMConfig,
    *,
    draft_params: LLM,
    draft_cfg: LLMConfig,
    spec_k: int = 4,
    attn_impl: str = "int8",
    return_stats: bool = False,
):
    """Greedy speculative decoding of one sequence: each round the draft
    model proposes ``k`` tokens (:func:`decode_tokens`, one replay of its
    captured step a token on the card), the target scores the last emitted
    token and the first ``k - 1`` drafts in one :func:`llm_verify_step`,
    keeps the drafts up to the first mismatch and emits its own token
    there, and both caches roll back in place to the kept rows. The output
    is the target's greedy generation (``generate``) whatever the draft
    proposes; the host reads the drafts and the target's choices once a
    round. The draft may be any model of the same vocabulary, the target's
    own weights at fewer bits included. ``max_seq`` must hold prompt +
    ``n_new`` + ``spec_k`` rows in both models, else ``ValueError``.

    Returns ``[1, n_new]`` int32 tokens and, with ``return_stats``, a dict
    of ``rounds``, ``mean_accepted`` (drafts accepted a round), ``spec_k``
    and ``k_per_round`` (the drafts of each round, which its verify step
    feeds; fewer than ``spec_k`` only near ``max_seq``)."""
    if prompt.shape[0] != 1:
        raise ValueError(f"speculative_generate is single-sequence, got a batch of {prompt.shape[0]}")
    if draft_cfg.vocab != cfg.vocab:
        raise ValueError(f"the draft's vocab {draft_cfg.vocab} is not the target's {cfg.vocab}")
    logits, caches = llm_prefill(params, prompt, cfg, attn_impl=attn_impl)
    _, dcaches = llm_prefill(draft_params, prompt, draft_cfg, attn_impl=attn_impl)
    cur = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)  # the target picks every emitted token
    del logits
    dev = prompt.device
    out = [int(cur[0])]
    length = prompt.shape[1]  # both caches' length, kept on the host
    accepted, k_per_round = 0, []
    while len(out) < n_new:
        # A round appends k rows to each cache: past max_seq a write would
        # clamp onto accepted rows.
        k = min(spec_k, cfg.max_seq - length, draft_cfg.max_seq - length)
        if k < 1:
            raise ValueError(f"speculative_generate: cache capacity exhausted (target {length}/{cfg.max_seq}, "
                             f"draft {length}/{draft_cfg.max_seq}); size max_seq >= prompt + n_new + spec_k")
        drafts, dcaches = decode_tokens(draft_params, cur, dcaches, k, draft_cfg)  # [1, k]
        fed = torch.cat([cur[:, None], drafts[:, :-1]], dim=1)
        vlogits, caches = llm_verify_step(params, fed, caches, cfg)
        dtoks, greedy = torch.stack([drafts[0], torch.argmax(vlogits[0], dim=-1).to(torch.int32)]).tolist()
        m = 0
        while m < k and dtoks[m] == greedy[m]:
            m += 1
        k_per_round.append(k)
        accepted += m
        if m == k:
            # Every draft matched; the last was never fed, so it is the next
            # round's first token. All k fed rows stay in both caches.
            out.extend(dtoks)
            cur = drafts[:, -1]
            length += k
        else:
            # Keep the fed rows up to the last match; the target's own token
            # at the mismatch is emitted and fed next round.
            out.extend(dtoks[:m] + [greedy[m]])
            length += m + 1
            keep = torch.full((1,), length, dtype=torch.int32, device=dev)
            rollback_caches(caches, keep)
            rollback_caches(dcaches, keep)
            cur = torch.full((1,), greedy[m], dtype=torch.int32, device=dev)
    tokens = torch.tensor([out[:n_new]], dtype=torch.int32, device=dev)
    if return_stats:
        rounds = len(k_per_round)
        return tokens, {"rounds": rounds, "mean_accepted": accepted / max(rounds, 1), "spec_k": spec_k,
                        "k_per_round": k_per_round}
    return tokens
