"""Continuous-batching LLM serving engine over the paged quantized KV cache.

PyTorch/CUDA counterpart of ``lowbit_quant_fa2_paddle_tpu/serving.py``:

* control plane: the port's native C++ continuous-batching scheduler
  (``host.Scheduler``, ``csrc/lowbit_host.cpp``): FIFO admission over
  decode slots and a paged KV pool, with worst-case reservation ("reserve")
  or lazy admission relieved by LRU prefix-cache eviction and preemption;
* data plane: the batch of running requests shares one paged int8 or 4-bit
  KV cache per layer (``[Hk, num_pages + 1, page, Dc]`` on the card) and one
  paged kernel-D call per layer and tick (``ops.decode.decode_attention``
  with ``page_table``); new tokens' K/V are quantized and written into their
  pages in the step. Inactive slots write into the pool's last page, which
  the scheduler never hands out (JAX drops writes to an out-of-range page
  id; a CUDA index out of range is a device-side assert), so the first
  ``num_pages`` pages hold what JAX's pool holds.

The engine's state lives on the caches' device: the caches, and per
decode program the static input tensors (tokens, lengths, table, active)
that each tick fills in place from the host scheduler's arrays before it
runs. On the card the single-token tick, the ``multi_step`` segment and
the speculative verify tick are CUDA graphs (JAX's process-wide jitted
programs, here per engine, keyed as JAX keys them: the model config, page
size, cache bits, and ``n`` for a segment or the verify tick's tokens): the
engine's first program runs its first tick eagerly (building the kernels
and every lazily made buffer) and captures at its second, a later program
captures at its first, and every later run replays. Prefill and prefill
chunks run eagerly.
On the CPU every tick runs eagerly through the kernels' plain versions.

Request lifecycle: ``add_request`` queues -> the scheduler admits (prompt
pages allocated) -> the prefill writes the prompt's quantized KV into its
pages and samples the first token -> the request joins the batched decode
tick until ``max_new_tokens`` or its ``eos_token`` -> pages and slot
released. With ``ServingConfig(prefill_budget=...)`` the prefill runs one
bounded chunk per tick beside the decode tick.
"""

from __future__ import annotations

import collections
import dataclasses
import hashlib
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from lowbit_quant_fa2_paddle_tpu_torch import host
from lowbit_quant_fa2_paddle_tpu_torch.models import llm as L
from lowbit_quant_fa2_paddle_tpu_torch.ops import decode as dec
from lowbit_quant_fa2_paddle_tpu_torch.ops import quant as quant_ops
from lowbit_quant_fa2_paddle_tpu_torch.ops.attention import lowbit_attention


@dataclasses.dataclass(frozen=True)
class ServingConfig:
    """Engine shape knobs; the JAX package's ``ServingConfig``, whose notes
    give each option's semantics."""

    page_size: int = 64  # tokens per KV page
    num_pages: int = 64  # shared page pool size (the scheduler's)
    max_batch: int = 4  # decode slots
    kv_bits: int = 8  # 8 (int8) or 4 (nibble-packed) KV pages
    k_bits: Optional[int] = None  # per-side overrides (k4v8: k_bits=4, v_bits=8)
    v_bits: Optional[int] = None
    max_pages_per_seq: Optional[int] = None  # the table's width; default the pool
    # Hash-chained prefix-page sharing (a hit's first-token logits come from
    # the chunked path over the quantized prefix: cos > 0.999 against a
    # miss, so a hit may sample another token near an argmax tie).
    prefix_caching: bool = True
    admission: str = "reserve"  # or "lazy" (LRU eviction, then preemption)
    spec_ngram: int = 0  # n-gram (prompt lookup) speculation: the n; 0 off
    spec_k: int = 4  # fed rows a speculative tick verifies (>= 2)
    multi_step: int = 1  # decode ticks a segment runs on the device (empty queue)
    prefill_budget: Optional[int] = None  # prompt tokens a tick prefills (page multiple)
    async_fetch: bool = False  # sampled tokens stay on the device until retirement

    @property
    def table_width(self) -> int:
        return self.num_pages if self.max_pages_per_seq is None else self.max_pages_per_seq

    @property
    def eff_k_bits(self) -> int:
        return self.kv_bits if self.k_bits is None else self.k_bits

    @property
    def eff_v_bits(self) -> int:
        return self.kv_bits if self.v_bits is None else self.v_bits


def _empty_paged_caches(cfg: L.LLMConfig, scfg: ServingConfig, device) -> List[dict]:
    """Per layer the pool ``k``/``v`` ``[Hk, num_pages + 1, page, Dc]`` int8
    (Dc = D/2 at 4 bits) and ``k_scale``/``v_scale`` ``[Hk, num_pages + 1,
    page]`` f32 ones: JAX's pool plus one spare page, the target of inactive
    slots' writes."""
    hk, hd = cfg.num_kv_heads, cfg.head_dim
    dk = hd if scfg.eff_k_bits == 8 else hd // 2
    dv = hd if scfg.eff_v_bits == 8 else hd // 2
    n = scfg.num_pages + 1
    shape_s = (hk, n, scfg.page_size)
    return [
        {
            "k": torch.zeros(shape_s + (dk,), dtype=torch.int8, device=device),
            "v": torch.zeros(shape_s + (dv,), dtype=torch.int8, device=device),
            "k_scale": torch.ones(shape_s, dtype=torch.float32, device=device),
            "v_scale": torch.ones(shape_s, dtype=torch.float32, device=device),
        }
        for _ in range(cfg.depth)
    ]


def paged_state_from_jax(caches, table: Optional[np.ndarray] = None, device="cuda") -> Tuple[List[dict], object]:
    """The JAX engine's paged caches (a list per layer of ``k``/``v``/
    ``k_scale``/``v_scale`` arrays ``[Hk, num_pages, page, ..]``, as numpy or
    anything ``np.asarray`` takes) as the port's pool, with the spare page
    appended (zero codes, unit scales), and its page table (numpy ``[B, W]``)
    as an int32 tensor on ``device``. Feeds both engines' kernels the same
    pool."""
    out = []
    for c in caches:
        layer = {}
        for name in ("k", "v", "k_scale", "v_scale"):
            x = torch.from_numpy(np.array(c[name]))
            spare = (torch.ones if name.endswith("scale") else torch.zeros)(
                (x.shape[0], 1) + tuple(x.shape[2:]), dtype=x.dtype)
            layer[name] = torch.cat([x, spare], dim=1).to(device)
        out.append(layer)
    tbl = None if table is None else torch.from_numpy(np.asarray(table, np.int32).copy()).to(device)
    return out, tbl


class PrefixCache:
    """Hash-chained prefix-page cache: each full prompt page is keyed by the
    SHA-256 of its tokens chained with the previous page's digest; cached
    pages are pinned in the scheduler's refcounted pool and shared
    copy-free; LRU eviction drops only the cache's own pin."""

    def __init__(self, sched: host.Scheduler, page_size: int):
        self._sched = sched
        self._page = page_size
        self._entries: "collections.OrderedDict[bytes, int]" = collections.OrderedDict()
        self.hits = 0
        self.misses = 0

    def _chain(self, prompt: np.ndarray):
        digest = b""
        tokens = np.ascontiguousarray(prompt, np.int64)
        for j in range(len(prompt) // self._page):
            page_bytes = tokens[j * self._page : (j + 1) * self._page].tobytes()
            digest = hashlib.sha256(digest + page_bytes).digest()
            yield j, digest

    def lookup(self, prompt: np.ndarray, max_pages: int) -> List[int]:
        """Longest cached page run covering the prompt's leading full pages,
        at most ``max_pages``."""
        pids: List[int] = []
        for j, h in self._chain(prompt):
            if j >= max_pages:
                break
            pid = self._entries.get(h)
            if pid is None:
                break
            self._entries.move_to_end(h)
            pids.append(pid)
        return pids

    def register(self, prompt: np.ndarray, pages: Sequence[int]) -> None:
        """Pin and index every full prompt page of a just-prefilled request."""
        for j, h in self._chain(prompt):
            if h in self._entries:
                self._entries.move_to_end(h)
                continue
            self._sched.ref_page(pages[j])
            self._entries[h] = pages[j]

    def evict_one(self) -> bool:
        """Evict the least recently used entry whose page returns to the
        pool (only the cache's pin left); False when there is none."""
        for key, pid in self._entries.items():
            if self._sched.page_ref(pid) == 1:
                del self._entries[key]
                self._sched.unref_page(pid)
                return True
        return False

    def __len__(self) -> int:
        return len(self._entries)


def _quantize_rows(k: torch.Tensor, v: torch.Tensor, kv_bits: Tuple[int, int]) -> tuple:
    """A prompt's K/V ``[1, Hk, S, D]`` quantized per token: ``(kq [Hk, S,
    dk], ks [Hk, S], vq, vs)``."""
    kq, ks = dec.quantize_token(k, bits=kv_bits[0])
    vq, vs = dec.quantize_token(v, bits=kv_bits[1])
    return kq[0], ks[0], vq[0], vs[0]


def _fused_quant_attention(q, k, v, **kw):
    """Kernel A with K quantized per token by kernel C1 and Q in the kernel
    (the JAX function's ``fused_quant=True``)."""
    kc, ksc = quant_ops.quant_int8(k, gran="per_token")
    return lowbit_attention(q, kc, v, k_scale=ksc, return_lse=True, **kw)


def _chunked_prefill_forward(params: L.LLM, suffix: torch.Tensor, prefix_kv: List[tuple], s_pre: int,
                             cfg: L.LLMConfig, kv_bits: Tuple[int, int], prefix_valid: Optional[int] = None):
    """Prefill of ``suffix [1, S]`` over cached quantized prefix rows
    (``prefix_kv`` per layer ``(k codes [Hk, Sp, dk], ks [Hk, Sp], v codes,
    vs)``): the suffix's causal self-attention (kernels C1 + A) and its
    cross-attention over the prefix (kernel A on the int8 codes with their
    scales, Q quantized in the kernel; a 4-bit K dequantized and
    requantized to int8 by C1), merged through their base-2 LSEs. With
    ``prefix_valid`` the prefix is padded to ``s_pre`` rows and only its
    first ``prefix_valid`` count: the pad rows are masked by segment ids and
    positions start at ``prefix_valid``. A windowed model's cross-attention
    is causal-banded at the suffix's offset (``q_position_offset``), its
    sinks global. Returns ``(last-token logits [vocab], per-layer quantized
    rows)``."""
    b, s = suffix.shape
    dev = suffix.device
    x = params.embed(suffix)
    pos0 = s_pre if prefix_valid is None else prefix_valid
    pos = (pos0 + torch.arange(s, device=dev)).expand(b, s)
    seg_kw = {}
    if prefix_valid is not None:
        seg_kw = dict(q_segment_ids=torch.zeros((1, s), dtype=torch.int32, device=dev),
                      kv_segment_ids=(torch.arange(s_pre, device=dev)[None] >= prefix_valid).to(torch.int32))
    kb, vb = kv_bits
    per_layer = []
    for blk, (kc_pre, ks_pre, vc_pre, vs_pre) in zip(params.blocks, prefix_kv):
        q, k, v = L._qkv(blk, x, cfg)
        q = L._rope(q, pos, cfg.rope_theta)
        k = L._rope(k, pos, cfg.rope_theta)
        v_pre = L._dequant_cache_rows(vc_pre, vs_pre, vb, torch.bfloat16)[None]
        cross_kw, self_kw = dict(is_causal=False), {}
        if cfg.window_size is not None:
            if prefix_valid is not None:
                raise ValueError("windowed chunks take exact prefixes")
            cross_kw = dict(is_causal=True, window_size=cfg.window_size, sink_size=cfg.sink_size,
                            q_position_offset=s_pre)
            self_kw = dict(window_size=cfg.window_size, sink_size=max(0, cfg.sink_size - s_pre))
        if kb == 4:
            k_pre = L._dequant_cache_rows(kc_pre, ks_pre, 4, torch.bfloat16)[None]
            o1, l1 = _fused_quant_attention(q, k_pre, v_pre, **seg_kw, **cross_kw)
        else:
            o1, l1 = lowbit_attention(q, kc_pre[None], v_pre, k_scale=ks_pre[None], return_lse=True, **seg_kw,
                                      **cross_kw)
        o2, l2 = _fused_quant_attention(q, k, v.to(torch.bfloat16), is_causal=True, **self_kw)
        o = L.merge_lse(o1, l1, o2, l2)
        x = x + L._mm(o.transpose(1, 2).reshape(b, s, -1).to(x.dtype), blk.wo)
        x = L._mlp(blk, x)
        per_layer.append(_quantize_rows(k, v, kv_bits))
    return params.logits(x[:, -1])[0], per_layer


def _prefill_forward(params: L.LLM, tokens: torch.Tensor, cfg: L.LLMConfig, kv_bits: Tuple[int, int]):
    """The prompt forward of ``models/llm.py`` (int8 causal attention,
    kernels C1 and A; the window band for a windowed model) returning the
    last token's logits and each layer's per-token quantized K/V rows."""
    b, s = tokens.shape
    x = params.embed(tokens)
    pos = torch.arange(s, device=tokens.device).expand(b, s)
    per_layer = []
    for blk in params.blocks:
        q, k, v = L._qkv(blk, x, cfg)
        q = L._rope(q, pos, cfg.rope_theta)
        k = L._rope(k, pos, cfg.rope_theta)
        o = L._attn_prefill(q, k, v, "int8", cfg.window_size, cfg.sink_size)
        x = x + L._mm(o.transpose(1, 2).reshape(b, s, -1).to(x.dtype), blk.wo)
        x = L._mlp(blk, x)
        per_layer.append(_quantize_rows(k, v, kv_bits))
    return params.logits(x[:, -1])[0], per_layer


def _spec_decode_step(params: L.LLM, caches: List[dict], tokens: torch.Tensor, lengths: torch.Tensor,
                      page_table: torch.Tensor, active: torch.Tensor, *, cfg: L.LLMConfig, page_size: int,
                      kv_bits: Tuple[int, int]) -> torch.Tensor:
    """One batched step of T fed tokens a slot (``tokens [B, T]``,
    ``lengths [B]`` counting all T): each active slot's T rows of quantized
    K/V are written into their pages (in place; inactive slots into the
    spare page), then kernel D runs over the paged cache, T query tokens a
    slot. Returns logits ``[B, T, vocab]``, row t scoring the successor of
    fed token t. Nothing is read back to the host, so the step captures as
    a CUDA graph.

    As in JAX, the T rows run as one batch: the dense layers at M = B·T
    rows and kernel D over T query tokens, so a verify tick streams the
    weights and the cache once. A row's logits then round as a matmul of
    B·T rows does, not as the single-token tick's B rows: equal tokens up
    to argmax near-ties."""
    b, t = tokens.shape
    spare = caches[0]["k"].shape[1] - 1
    x = params.embed(tokens)  # [B, T, D]
    pos = lengths[:, None].long() - t + torch.arange(t, device=tokens.device)[None]  # [B, T]
    kv_lengths = torch.where(active, lengths, torch.zeros_like(lengths))
    page_idx = torch.clamp(torch.div(pos, page_size, rounding_mode="floor"), 0, page_table.shape[1] - 1)
    pid = torch.where(active[:, None], page_table.gather(1, page_idx).long(), torch.full_like(pos, spare))
    off = torch.remainder(torch.clamp(pos, min=0), page_size)
    for blk, cache in zip(params.blocks, caches):
        q, k, v = L._qkv(blk, x, cfg)  # [B, H, T, hd]
        q = L._rope(q, pos, cfg.rope_theta)  # [B, H, T, hd]
        k = L._rope(k, pos, cfg.rope_theta)
        kq, ks = dec.quantize_token(k.transpose(1, 2), bits=kv_bits[0])  # [B, T, Hk, dk]
        vq, vs = dec.quantize_token(v.transpose(1, 2), bits=kv_bits[1])
        cache["k"][:, pid, off] = kq.permute(2, 0, 1, 3)
        cache["v"][:, pid, off] = vq.permute(2, 0, 1, 3)
        cache["k_scale"][:, pid, off] = ks.permute(2, 0, 1)
        cache["v_scale"][:, pid, off] = vs.permute(2, 0, 1)
        o = dec.decode_attention(
            q.transpose(1, 2), cache["k"], cache["v"], cache["k_scale"], kv_lengths, v_scale=cache["v_scale"],
            page_table=page_table, k_bits=kv_bits[0], v_bits=kv_bits[1], window_size=cfg.window_size,
            sink_size=cfg.sink_size,
        )  # [B, T, H, hd]
        x = x + L._mm(o.reshape(b, t, -1).to(x.dtype), blk.wo)
        x = L._mlp(blk, x)
    return params.logits(x)


def _decode_step(params, caches, tokens, lengths, page_table, active, *, cfg, page_size, kv_bits) -> torch.Tensor:
    """One batched decode tick (``tokens [B]``): the T = 1 case of
    :func:`_spec_decode_step`, so the speculative path runs the same body.
    Returns logits ``[B, vocab]``."""
    return _spec_decode_step(params, caches, tokens[:, None], lengths, page_table, active, cfg=cfg,
                             page_size=page_size, kv_bits=kv_bits)[:, 0]


def _decode_sample_step(params, caches, tokens, lengths, page_table, active, *, cfg, page_size,
                        kv_bits) -> torch.Tensor:
    """:func:`_decode_step` and the greedy argmax: the sampled tokens
    ``[B]`` int32, on the device."""
    logits = _decode_step(params, caches, tokens, lengths, page_table, active, cfg=cfg, page_size=page_size,
                          kv_bits=kv_bits)
    return torch.argmax(logits, dim=-1).to(torch.int32)


def _multi_decode_steps(params, caches, tokens, lengths0, page_table, active, *, n, cfg, page_size,
                        kv_bits) -> torch.Tensor:
    """``n`` decode ticks with the argmax fed back on the device: step i
    runs :func:`_decode_step` at ``lengths0 + i + 1``, so the stream is that
    of n single ticks. Returns tokens ``[B, n]`` int32."""
    toks = tokens.to(torch.int32)
    out = []
    for i in range(n):
        toks = _decode_sample_step(params, caches, toks, lengths0 + (i + 1), page_table, active, cfg=cfg,
                                   page_size=page_size, kv_bits=kv_bits)
        out.append(toks)
    return torch.stack(out, dim=1)


class _NgramIndex:
    """Prompt-lookup drafting index: for the history's last n tokens, the
    tokens that followed their most recent previous occurrence."""

    def __init__(self, n: int):
        self.n = n
        self.toks: List[int] = []
        self._last: Dict[tuple, int] = {}
        self._prev: Dict[tuple, int] = {}

    def extend(self, toks) -> None:
        for t in toks:
            self.toks.append(int(t))
            i = len(self.toks)
            if i >= self.n:
                g = tuple(self.toks[i - self.n :])
                if g in self._last:
                    self._prev[g] = self._last[g]
                self._last[g] = i - self.n

    def draft(self, k: int) -> List[int]:
        if len(self.toks) < self.n:
            return []
        g = tuple(self.toks[-self.n :])
        s = self._prev.get(g)
        if s is None:
            return []
        return self.toks[s + self.n : s + self.n + k]


def _scatter_pages_body(caches: List[dict], per_layer: List[tuple], pids: torch.Tensor, page_size: int) -> None:
    """Write per-token quantized rows (``(kq [Hk, S, dk], ks [Hk, S], vq,
    vs)`` a layer, starting at a page boundary) into the pages ``pids`` (a
    device tensor, in order), the last page's tail zero-padded; in place."""
    n = pids.shape[0]
    for c, rows in zip(caches, per_layer):
        for name, x in zip(("k", "k_scale", "v", "v_scale"), rows):
            hk, s_rows = x.shape[0], x.shape[1]
            x = F.pad(x, [0, 0] * (x.dim() - 2) + [0, n * page_size - s_rows])
            c[name][:, pids] = x.reshape((hk, n, page_size) + tuple(x.shape[2:]))


def _budgeted_prefill_chunk(params, caches, toks_c, prefix_pids, dest_pids, prefix_valid=None, *, cfg, page_size,
                            kv_bits) -> torch.Tensor:
    """One slice of an admitted prompt's prefill: gather the request's
    already-written pages ``prefix_pids`` as prefix rows, run the chunk
    ``toks_c [1, sc]`` over them (:func:`_chunked_prefill_forward`; none:
    :func:`_prefill_forward`), and write the chunk's rows into
    ``dest_pids``. Returns the chunk's last-token logits."""
    n_pre = prefix_pids.shape[0]
    if n_pre:
        s_pre = n_pre * page_size
        prefix_kv = []
        for c in caches:
            hk = c["k"].shape[0]
            prefix_kv.append((c["k"][:, prefix_pids].reshape(hk, s_pre, -1),
                              c["k_scale"][:, prefix_pids].reshape(hk, s_pre),
                              c["v"][:, prefix_pids].reshape(hk, s_pre, -1),
                              c["v_scale"][:, prefix_pids].reshape(hk, s_pre)))
        logits, per_layer = _chunked_prefill_forward(params, toks_c, prefix_kv, s_pre, cfg, kv_bits,
                                                     prefix_valid=prefix_valid)
    else:
        logits, per_layer = _prefill_forward(params, toks_c, cfg, kv_bits)
    _scatter_pages_body(caches, per_layer, dest_pids, page_size)
    return logits


def _write_pages(caches: List[dict], payload: List[dict], pids: torch.Tensor) -> None:
    """Write page-shaped payloads (``[Hk, n, page, ..]`` a field) back into
    the pool (the preemption resume), in place."""
    for c, p in zip(caches, payload):
        for name in c:
            c[name][:, pids] = p[name].to(c[name].device)


class _TickProgram:
    """One of the engine's decode programs (the tick, an n-tick segment or
    the T-token verify tick, whose fed tokens are ``[B, t]``) with its
    static device inputs. On the card its first run is eager (on a
    side stream: the kernels' lazily made buffers and cuBLAS's workspace
    come into being there) unless ``warm`` (another program of the engine
    ran the same step eagerly), the next run captures a CUDA graph, and
    every run replays it; on the CPU every run is eager."""

    def __init__(self, fn, device, b: int, w: int, warm: bool = False, t: int = 0):
        self.fn, self.device, self.warm = fn, device, warm
        self.tokens = torch.zeros((b, t) if t else (b,), dtype=torch.int32, device=device)
        self.lengths = torch.zeros((b,), dtype=torch.int32, device=device)
        self.table = torch.zeros((b, w), dtype=torch.int32, device=device)
        self.active = torch.zeros((b,), dtype=torch.bool, device=device)
        self.out: Optional[torch.Tensor] = None
        self.graph = None
        self.runs = 0
        self.launches: dict = {}

    def _call(self):
        return self.fn(self.tokens, self.lengths, self.table, self.active)

    def __call__(self, tokens, lengths, table, active) -> torch.Tensor:
        """Runs on the given inputs (host arrays or device tensors, copied
        into the static inputs in place; host arrays are copied first, so
        the caller may change them while the copy is in flight) and returns
        the output tensor (the program's own buffer under a graph)."""
        for dst, src in ((self.tokens, tokens), (self.lengths, lengths), (self.table, table), (self.active, active)):
            if isinstance(src, np.ndarray):
                src = torch.from_numpy(src.copy())
            dst.copy_(src, non_blocking=True)
        self.runs += 1
        if self.device.type != "cuda":
            return self._call()
        if self.graph is not None:
            self.graph.replay()
            L._add_launch_counts(self.launches)
            return self.out
        cur = torch.cuda.current_stream(self.device)
        if self.runs == 1 and not self.warm:
            side = torch.cuda.Stream(self.device)
            side.wait_stream(cur)
            with torch.cuda.stream(side):
                out = self._call()
            cur.wait_stream(side)
            return out
        graph = torch.cuda.CUDAGraph()
        before = L._launch_counts()
        with torch.cuda.graph(graph):
            self.out = self._call()
        after = L._launch_counts()
        self.launches = {k: after[k] - before.get(k, 0) for k in after}
        L._add_launch_counts(self.launches, -1)  # the capture ran nothing
        self.graph = graph
        graph.replay()
        L._add_launch_counts(self.launches)
        return self.out


class ServingEngine:
    """Single-host continuous-batching engine for the port's LLM.

    >>> eng = ServingEngine(model, cfg, ServingConfig(page_size=8))
    >>> rid = eng.add_request([1, 2, 3], max_new_tokens=16)
    >>> done = eng.run()           # or eng.step() in a service loop
    >>> done[rid]                  # generated token ids
    """

    def __init__(self, params: L.LLM, cfg: L.LLMConfig, scfg: ServingConfig = ServingConfig()):
        if cfg.num_heads % cfg.num_kv_heads:
            raise ValueError("num_heads must be a multiple of num_kv_heads")
        self.params = params
        self.cfg = cfg
        self.scfg = scfg
        self.device = params.embed.weight.device
        if scfg.admission not in ("reserve", "lazy"):
            raise ValueError("admission must be 'reserve' or 'lazy'")
        if scfg.eff_k_bits not in (8, 4) or scfg.eff_v_bits not in (8, 4):
            raise ValueError("the engine serves int8 or 4-bit pages (kv_bits/k_bits/v_bits 8 or 4)")
        if cfg.window_size is not None and scfg.admission == "lazy":
            raise ValueError(
                "sliding-window models require admission='reserve' "
                "(rolling page reclamation replaces lazy admission's "
                "preemption as the memory-bound mechanism)"
            )
        self.sched = host.Scheduler(scfg.num_pages, scfg.page_size, scfg.max_batch, lazy=scfg.admission == "lazy")
        self.prefix_cache = (
            PrefixCache(self.sched, scfg.page_size) if scfg.prefix_caching and cfg.window_size is None else None
        )
        self._shared: Dict[int, int] = {}
        self.caches = _empty_paged_caches(cfg, scfg, self.device)
        b, w = scfg.max_batch, scfg.table_width
        self._table = np.zeros((b, w), np.int32)
        self._lengths = np.zeros((b,), np.int32)
        self._active = np.zeros((b,), bool)
        self._slot_rid = np.full((b,), -1, np.int32)
        self._next_tok = np.zeros((b,), np.int32)
        self._prompts: Dict[int, np.ndarray] = {}
        self._waiting_rids: List[int] = []
        self._max_new: Dict[int, int] = {}
        self._eos: Dict[int, Optional[int]] = {}
        self.outputs: Dict[int, List[int]] = {}
        self._finished: Dict[int, List[int]] = {}
        self._paused: Dict[int, dict] = {}
        self._admit_order: List[int] = []
        self.preemptions = 0
        self._kv_bits = (scfg.eff_k_bits, scfg.eff_v_bits)
        self._budget: Optional[int] = None
        self._prefilling: "collections.OrderedDict[int, int]" = collections.OrderedDict()
        self._prefilling_shared: Dict[int, int] = {}
        if scfg.prefill_budget is not None:
            if scfg.prefill_budget <= 0:
                raise ValueError("prefill_budget must be positive")
            if scfg.admission != "reserve":
                raise ValueError(
                    "prefill_budget requires admission='reserve' (a "
                    "half-prefilled request holds pages but is not "
                    "preemptible)")
            self._budget = -(-scfg.prefill_budget // scfg.page_size) * scfg.page_size
        self._async = scfg.async_fetch
        if self._async:
            if scfg.admission != "reserve":
                raise ValueError("async_fetch requires admission='reserve'")
            if scfg.spec_ngram > 0 or scfg.multi_step > 1:
                raise ValueError("async_fetch excludes spec_ngram/multi_step (both need token values per tick)")
        self._next_tok_dev: Optional[torch.Tensor] = None
        self._pending: List[tuple] = []
        self._out_count: Dict[int, int] = {}
        self.multi_segments = 0
        if scfg.multi_step > 1:
            if scfg.admission != "reserve":
                raise ValueError("multi_step requires admission='reserve'")
            if scfg.spec_ngram > 0:
                raise ValueError("multi_step and spec_ngram are exclusive")
        self._spec = scfg.spec_ngram > 0
        self.spec_rounds = self.spec_accepted = 0
        if self._spec:
            if scfg.admission != "reserve":
                raise ValueError("spec_ngram requires admission='reserve'")
            if scfg.spec_k < 2:
                raise ValueError("spec_k must be >= 2 (room for >= 1 draft)")
            self._ngram: Dict[int, _NgramIndex] = {}
        self._programs: Dict[tuple, _TickProgram] = {}
        self.decode_ticks = 0
        self.prefill_chunks = 0

    # -- device programs -----------------------------------------------------

    def _step_kw(self) -> dict:
        return dict(cfg=self.cfg, page_size=self.scfg.page_size, kv_bits=self._kv_bits)

    def _program(self, kind: str, n: int = 0) -> _TickProgram:
        """The engine's decode program of ``kind`` ("decode": a tick and its
        argmax, whose tokens the sync path fetches and async fetch keeps on
        the device; "multi": an ``n``-tick segment; "verify": the
        speculative tick of ``n`` fed tokens a slot, its logits), under
        JAX's key (model config, page size, cache bits, and ``n``)."""
        key = (kind, self.cfg, self.scfg.page_size, self._kv_bits, n)
        prog = self._programs.get(key)
        if prog is None:
            kw = self._step_kw()
            if kind == "multi":
                def fn(t, ln, tb, ac):
                    return _multi_decode_steps(self.params, self.caches, t, ln, tb, ac, n=n, **kw)
            elif kind == "verify":
                def fn(t, ln, tb, ac):
                    return _spec_decode_step(self.params, self.caches, t, ln, tb, ac, **kw)
            else:
                def fn(t, ln, tb, ac):
                    return _decode_sample_step(self.params, self.caches, t, ln, tb, ac, **kw)
            warm = any(p.runs for p in self._programs.values())
            prog = self._programs[key] = _TickProgram(fn, self.device, self.scfg.max_batch, self.scfg.table_width,
                                                      warm, n if kind == "verify" else 0)
        return prog

    def _dev(self, x: np.ndarray) -> torch.Tensor:
        """A copy of a host array on the engine's device (the host may
        change the array while the copy is in flight)."""
        return torch.from_numpy(np.array(x, copy=True)).to(self.device)

    # -- request intake ------------------------------------------------------

    def add_request(self, prompt_tokens: Sequence[int], max_new_tokens: int, eos_token: Optional[int] = None) -> int:
        """Queue a request; ``eos_token`` stops it early (the token is
        included in the output) on every decode path."""
        prompt = np.asarray(prompt_tokens, np.int32)
        if prompt.ndim != 1 or prompt.size == 0:
            raise ValueError("a prompt is a non-empty 1-d token sequence")
        if eos_token is not None and self._async:
            raise ValueError("eos_token needs per-tick token values; disable async_fetch for stop-token requests")
        spec_slack = self.scfg.spec_k if self._spec else 0
        need_w = -(-(prompt.size + max_new_tokens + spec_slack - 1) // self.scfg.page_size)
        if need_w > self.scfg.table_width:
            raise MemoryError("request exceeds the static page-table width")
        shared: List[int] = []
        if self.prefix_cache is not None:
            shared = self.prefix_cache.lookup(prompt, (prompt.size - 1) // self.scfg.page_size)
        max_new_sched = int(max_new_tokens)
        if self.cfg.window_size is not None:
            cap = self.cfg.sink_size + self.cfg.window_size + 3 * self.scfg.page_size + self.scfg.multi_step
            max_new_sched = max(1, min(max_new_sched, cap))
        rid = self.sched.add(int(prompt.size), max_new_sched + spec_slack, shared)
        if self._spec:
            self._ngram[rid] = _NgramIndex(self.scfg.spec_ngram)
            self._ngram[rid].extend(prompt)
        self._shared[rid] = len(shared)
        self._waiting_rids.append(rid)
        self._prompts[rid] = prompt
        self._max_new[rid] = int(max_new_tokens)
        self._eos[rid] = None if eos_token is None else int(eos_token)
        self.outputs[rid] = []
        return rid

    # -- lifecycle -----------------------------------------------------------

    def _chunk(self, toks: np.ndarray, prefix_pids, dest_pids, prefix_valid=None) -> torch.Tensor:
        self.prefill_chunks += 1
        with torch.no_grad():
            return _budgeted_prefill_chunk(
                self.params, self.caches, self._dev(toks[None].astype(np.int64)),
                self._dev(np.asarray(prefix_pids, np.int64)), self._dev(np.asarray(dest_pids, np.int64)),
                prefix_valid, **self._step_kw())

    def _prefill(self, rid: int) -> None:
        """Blocking prefill: one unbounded chunk (a hit's shared pages are
        its prefix pages)."""
        prompt = self._prompts.pop(rid)
        self._waiting_rids.remove(rid)
        pages = self.sched.page_table(rid)
        n_shared = self._shared.pop(rid, 0)
        s_pre = n_shared * self.scfg.page_size
        logits = self._chunk(prompt[s_pre:], pages[:n_shared], pages[n_shared:])
        self._finish_prefill(rid, logits, prompt, pages, n_shared)

    def _finish_prefill(self, rid, logits, prompt, pages, n_shared) -> None:
        p = self.scfg.page_size
        if self.prefix_cache is not None:
            self.prefix_cache.hits += n_shared
            self.prefix_cache.misses += max(0, min(prompt.size // p, (prompt.size - 1) // p) - n_shared)
            self.prefix_cache.register(prompt, pages)
        slot = self.sched.info(rid)["slot"]
        tok = int(torch.argmax(logits))
        self.outputs[rid].append(tok)
        self._out_count[rid] = 1
        if self._spec:
            self._ngram[rid].extend([tok])
        if self._done(rid):
            self._retire(rid, slot)
            return
        self._seat(rid, slot, tok, prompt.size, pages)

    def _begin_prefill(self, rid: int) -> None:
        self._waiting_rids.remove(rid)
        n_shared = self._shared.pop(rid, 0)
        self._prefilling_shared[rid] = n_shared
        self._prefilling[rid] = n_shared * self.scfg.page_size

    def _prefill_progress(self) -> None:
        """One chunk a tick while decode slots are live (oldest admission
        first); back to back while the batch is idle."""
        if not self._prefilling:
            return
        if self._active.any():
            self._prefill_chunk_tick(next(iter(self._prefilling)))
            return
        while self._prefilling and not self._active.any():
            self._prefill_chunk_tick(next(iter(self._prefilling)))

    def _prefill_chunk_tick(self, rid: int) -> None:
        p = self.scfg.page_size
        done = self._prefilling[rid]
        prompt = self._prompts[rid]
        sc = min(self._budget, prompt.size - done)
        pages = self.sched.page_table(rid)
        j0 = done // p
        n_dest = -(-sc // p)
        if self.cfg.window_size is None:
            # The prefix gather bucketed to the next power of two (pad pages
            # repeat page 0; the pad rows are masked by segment ids).
            nb = j0 if j0 == 0 else 1 << (j0 - 1).bit_length()
            prefix_pids = pages[:j0] + [pages[0]] * (nb - j0)
            pv = done if j0 else None
        else:
            prefix_pids, pv = pages[:j0], None
        logits = self._chunk(prompt[done : done + sc], prefix_pids, pages[j0 : j0 + n_dest], pv)
        done += sc
        if done < prompt.size:
            self._prefilling[rid] = done
            return
        del self._prefilling[rid]
        prompt = self._prompts.pop(rid)
        n_shared = self._prefilling_shared.pop(rid)
        self._finish_prefill(rid, logits, prompt, pages, n_shared)

    def _seat(self, rid: int, slot: int, next_tok: int, length: int, pages: Sequence[int]) -> None:
        self._slot_rid[slot] = rid
        self._active[slot] = True
        self._next_tok[slot] = next_tok
        if self._async and self._next_tok_dev is not None:
            self._next_tok_dev[slot] = next_tok
        self._lengths[slot] = length
        row = np.zeros((self.scfg.table_width,), np.int32)
        row[: len(pages)] = pages
        self._table[slot] = row
        self._admit_order.append(rid)

    def _preempt(self, rid: int) -> None:
        """Swap a running request out: its private pages' KV to host memory,
        its slot and pages released, re-queued at the front."""
        slot = int(np.nonzero(self._slot_rid == rid)[0][0])
        pages = self.sched.page_table(rid)
        n_shared = self.sched.info(rid)["shared"]
        priv = np.asarray(pages[n_shared:], np.int64)
        if priv.size and priv.min() < 0:
            raise AssertionError("preempt saw trimmed holes")
        idx = self._dev(priv)
        saved = [{name: c[name][:, idx].cpu() for name in c} for c in self.caches]
        self.sched.preempt(rid)
        self._paused[rid] = {"payload": saved, "next_tok": int(self._next_tok[slot]), "n_shared": n_shared}
        self._slot_rid[slot] = -1
        self._active[slot] = False
        self._lengths[slot] = 0
        self._admit_order.remove(rid)
        self.preemptions += 1

    def _resume(self, rid: int) -> None:
        """Re-admit a preempted request: its saved KV into its new pages, bit
        for bit."""
        rec = self._paused.pop(rid)
        info = self.sched.info(rid)
        pages = self.sched.page_table(rid)
        _write_pages(self.caches, rec["payload"], self._dev(np.asarray(pages[rec["n_shared"]:], np.int64)))
        self._seat(rid, info["slot"], rec["next_tok"], info["length"], pages)

    def _done(self, rid: int) -> bool:
        out = self.outputs[rid]
        if len(out) >= self._max_new[rid]:
            return True
        eos = self._eos.get(rid)
        return eos is not None and bool(out) and out[-1] == eos

    def _retire(self, rid: int, slot: int) -> None:
        self._out_count.pop(rid, None)
        self._eos.pop(rid, None)
        self.sched.release(rid)
        if self._spec:
            self._ngram.pop(rid, None)
        self._finished[rid] = self.outputs[rid]
        if rid in self._admit_order:
            self._admit_order.remove(rid)
        if self._slot_rid[slot] == rid:
            self._slot_rid[slot] = -1
            self._active[slot] = False
            self._lengths[slot] = 0

    def cancel_request(self, rid: int) -> List[int]:
        """Abort a request in any pre-finished state; returns the tokens it
        generated so far. Its pages and shared-page pins are released."""
        if rid in self._finished:
            return self._finished[rid]
        self._drain_pending()
        if rid in self._prefilling:
            self.sched.release(rid)
            del self._prefilling[rid]
            del self._prompts[rid]
            self._prefilling_shared.pop(rid, None)
        elif rid in self._prompts:
            self.sched.cancel(rid)
            self._waiting_rids.remove(rid)
            del self._prompts[rid]
            self._shared.pop(rid, None)
        elif rid in self._paused:
            self.sched.cancel(rid)
            del self._paused[rid]
        elif rid in self._slot_rid:
            slot = int(np.nonzero(self._slot_rid == rid)[0][0])
            self.sched.release(rid)
            self._admit_order.remove(rid)
            self._slot_rid[slot] = -1
            self._active[slot] = False
            self._lengths[slot] = 0
        else:
            raise ValueError(f"unknown rid {rid}")
        toks = self.outputs.get(rid, [])
        if self._spec:
            self._ngram.pop(rid, None)
        self._finished[rid] = toks
        self._max_new.pop(rid, None)
        self._eos.pop(rid, None)
        return toks

    def step(self) -> Dict[int, List[int]]:
        """One engine tick: admit and prefill, then one batched decode tick
        (or a multi-step segment, or a speculative tick). Returns the
        requests that finished during it."""
        done_before = set(self._finished)
        if self.prefix_cache is not None:
            for rid in self._waiting_rids:
                pids = self.prefix_cache.lookup(self._prompts[rid],
                                                (self._prompts[rid].size - 1) // self.scfg.page_size)
                if len(pids) != self._shared[rid]:
                    self.sched.update_shared(rid, pids)
                    self._shared[rid] = len(pids)
        st = self.sched.step()
        admitted = list(st["admitted"])
        while st["waiting"] and self.prefix_cache is not None:
            if self.sched.stats()["used_slots"] >= self.scfg.max_batch:
                break
            if not self.prefix_cache.evict_one():
                break
            st = self.sched.step()
            admitted += st["admitted"]
        for rid in admitted:
            if rid in self._paused:
                self._resume(rid)
            elif self._budget is not None:
                self._begin_prefill(rid)
            else:
                self._prefill(rid)
        if self._budget is not None:
            self._prefill_progress()

        slots = np.nonzero(self._active)[0]
        if slots.size and self.scfg.admission == "lazy":
            slots = self._relieve_page_pressure(slots)
        n_seg = 0
        if (slots.size and self.scfg.multi_step > 1 and (not self._prompts or self._budget is not None)
                and not self._paused):
            min_rem = min(self._max_new[int(self._slot_rid[s])] - len(self.outputs[int(self._slot_rid[s])])
                          for s in slots)
            n_seg = min(self.scfg.multi_step, min_rem)
            n_seg = 1 << (max(n_seg, 1).bit_length() - 1)
        if n_seg >= 2:
            self._step_multi(slots, n_seg)
        elif slots.size and self._spec:
            self._step_speculative(slots)
        elif slots.size:
            for slot in slots:
                rid = int(self._slot_rid[slot])
                new_len = self.sched.append_token(rid)
                assert new_len > 0, "page pressure relief failed"
                self._lengths[slot] = new_len
                self._update_slot_table(slot, rid, new_len)
            self.decode_ticks += 1
            if self._async:
                if self._next_tok_dev is None:
                    self._next_tok_dev = self._dev(self._next_tok)
                prog = self._program("decode")
                with torch.no_grad():
                    nxt = prog(self._next_tok_dev, self._lengths, self._table, self._active).clone()
                self._next_tok_dev = nxt  # feeds the next tick, no fetch
                slot_rids = {int(sl): int(self._slot_rid[sl]) for sl in slots}
                self._pending.append((slot_rids, nxt))
                if any(self._out_count[rid] + 1 >= self._max_new[rid] for rid in slot_rids.values()):
                    self._drain_pending()
                    for sl, rid in slot_rids.items():
                        if len(self.outputs[rid]) >= self._max_new[rid]:
                            self._retire(rid, sl)
                        else:
                            self._next_tok[sl] = self.outputs[rid][-1]
                else:
                    for rid in slot_rids.values():
                        self._out_count[rid] += 1
            else:
                prog = self._program("decode")
                with torch.no_grad():
                    toks = prog(self._next_tok, self._lengths, self._table, self._active).cpu().numpy()
                for slot in slots:
                    rid = int(self._slot_rid[slot])
                    tok = int(toks[slot])
                    self.outputs[rid].append(tok)
                    if self._done(rid):
                        self._retire(rid, slot)
                    else:
                        self._next_tok[slot] = tok
        return {r: t for r, t in self._finished.items() if r not in done_before}

    def _drain_pending(self) -> None:
        """Materialize every deferred tick's tokens (async_fetch) with one
        batched device-to-host copy."""
        if not self._pending:
            return
        toks_host = torch.stack([t for _, t in self._pending]).cpu().numpy()
        for (slot_rids, _), tok in zip(self._pending, toks_host):
            for sl, rid in slot_rids.items():
                self.outputs[rid].append(int(tok[sl]))
                self._out_count[rid] = len(self.outputs[rid])
        self._pending.clear()

    def _update_slot_table(self, slot: int, rid: int, new_len: int, spec_slack: int = 0) -> None:
        """Rolling page reclamation (windowed models), then the slot's row of
        the page table (trimmed holes point at the newest page: the walk
        never reads them)."""
        if self.cfg.window_size is not None:
            ps = self.scfg.page_size
            sink_pages = -(-self.cfg.sink_size // ps)
            reclaim = (new_len - spec_slack - self.cfg.window_size) // ps
            if reclaim > sink_pages:
                self.sched.trim(rid, reclaim, start=sink_pages)
        pages = self.sched.page_table(rid)
        if pages and min(pages) < 0:
            safe = pages[-1]
            pages = [p if p >= 0 else safe for p in pages]
        self._table[slot, : len(pages)] = pages

    def _step_multi(self, slots: np.ndarray, n: int) -> None:
        """One multi-step segment: n rows pre-appended a slot, the n ticks
        as one device program, the n tokens distributed."""
        lengths0 = np.array(self._lengths)
        for slot in slots:
            rid = int(self._slot_rid[slot])
            new_len = 0
            for _ in range(n):
                new_len = self.sched.append_token(rid)
                assert new_len > 0, "multi-step append outran the reservation"
            self._lengths[slot] = new_len
            self._update_slot_table(slot, rid, new_len, spec_slack=n - 1)
        prog = self._program("multi", n)
        with torch.no_grad():
            toks = prog(self._next_tok, lengths0, self._table, self._active).cpu().numpy()
        self.multi_segments += 1
        self.decode_ticks += n
        for slot in slots:
            rid = int(self._slot_rid[slot])
            emit = [int(t) for t in toks[slot]]
            eos = self._eos.get(rid)
            if eos is not None and eos in emit:
                emit = emit[: emit.index(eos) + 1]
            self.outputs[rid].extend(emit)
            if self._done(rid):
                self._retire(rid, slot)
            else:
                self._next_tok[slot] = emit[-1]

    def _step_speculative(self, slots: np.ndarray) -> None:
        """One n-gram speculative tick: drafts from each slot's history,
        spec_k fed rows verified in one multi-token decode (the "verify"
        program), the matching prefix and the target's token emitted, the
        rest rolled back."""
        t = self.scfg.spec_k
        toks = np.zeros((self.scfg.max_batch, t), np.int32)
        drafts: Dict[int, List[int]] = {}
        for slot in slots:
            rid = int(self._slot_rid[slot])
            d = self._ngram[rid].draft(t - 1)
            rem = self._max_new[rid] - len(self.outputs[rid])
            d = d[: max(0, rem - 1)]
            drafts[rid] = d
            toks[slot, 0] = self._next_tok[slot]
            toks[slot, 1 : 1 + len(d)] = d
            new_len = 0
            for _ in range(t):
                new_len = self.sched.append_token(rid)
                assert new_len > 0, "speculative append outran the reservation"
            self._lengths[slot] = new_len
            self._update_slot_table(slot, rid, new_len, spec_slack=t - 1)
        self.decode_ticks += 1
        prog = self._program("verify", t)
        with torch.no_grad():
            logits = prog(toks, self._lengths, self._table, self._active)
            greedy = torch.argmax(logits, dim=-1).cpu().numpy()
        for slot in slots:
            rid = int(self._slot_rid[slot])
            d = drafts[rid]
            g = greedy[slot]
            m = 0
            while m < len(d) and d[m] == int(g[m]):
                m += 1
            emit = d[:m] + [int(g[m])]
            eos = self._eos.get(rid)
            if eos is not None and eos in emit:
                emit = emit[: emit.index(eos) + 1]
            self.spec_rounds += 1
            self.spec_accepted += m
            keep = m + 1
            if keep < t:
                self._lengths[slot] = self.sched.rollback(rid, t - keep)
            self._ngram[rid].extend(emit)
            self.outputs[rid].extend(emit)
            if self._done(rid):
                self._retire(rid, slot)
            else:
                self._next_tok[slot] = emit[-1]

    def _relieve_page_pressure(self, slots: np.ndarray) -> np.ndarray:
        """Lazy admission: before the tick's appends, free every page the
        active slots will allocate, by LRU cache eviction, then by
        preempting the youngest running request."""
        while True:
            needed = 0
            for slot in slots:
                rid = int(self._slot_rid[slot])
                length = int(self._lengths[slot])
                if (length % self.scfg.page_size == 0
                        and length // self.scfg.page_size >= len(self.sched.page_table(rid))):
                    needed += 1
            if self.sched.stats()["free_pages"] >= needed:
                return slots
            if self.prefix_cache is not None and self.prefix_cache.evict_one():
                continue
            if len(self._admit_order) <= 1:
                raise MemoryError("page pool exhausted with a single running request (admission accounting bug)")
            self._preempt(self._admit_order[-1])
            slots = np.nonzero(self._active)[0]

    def run(self, max_steps: int = 10_000) -> Dict[int, List[int]]:
        """Drive :meth:`step` until every queued request completes."""
        for _ in range(max_steps):
            if not self._prompts and not self._active.any() and not self._paused:
                break
            self.step()
        else:
            raise RuntimeError("serving loop did not drain")
        return dict(self._finished)

    @property
    def finished(self) -> Dict[int, List[int]]:
        return dict(self._finished)

    def stats(self) -> dict:
        s = self.sched.stats()
        s["active_slots"] = int(self._active.sum())
        s["finished"] = len(self._finished)
        s["preemptions"] = self.preemptions
        s["paused"] = len(self._paused)
        if self._budget is not None:
            s["prefilling"] = len(self._prefilling)
        if self.prefix_cache is not None:
            s["cached_pages"] = len(self.prefix_cache)
            s["prefix_hits"] = self.prefix_cache.hits
            s["prefix_misses"] = self.prefix_cache.misses
        if self._spec:
            s["spec_rounds"] = self.spec_rounds
            s["spec_tokens_per_round"] = round((self.spec_accepted + self.spec_rounds) / max(1, self.spec_rounds), 3)
        return s
