"""Train the in-repo toy LLM on synthetic arithmetic, and grade it.

Counterpart of ``lowbit_quant_fa2_paddle_tpu/models/train.py``: a
character-level LM over fixed-format zero-padded addition facts
``"07+42=049;"``, 10 characters each, so a few-shot prompt is ``k*10 + 6``
tokens ending in ``"ab+cd="`` and the answer is always 3 digits and ``";"``.
The committed checkpoint ``eval_out/arith_llm.npz`` was trained on it.

:func:`train_toy_llm` is JAX's recipe: AdamW on the all-position logits of
the exact-attention forward (``models.llm.llm_logits``), optax's
``adamw(warmup_cosine_decay_schedule(0, lr, min(100, steps // 10), steps),
weight_decay=1e-4)`` step for step (:class:`AdamW`, :func:`warmup_cosine_lr`),
token batches from ``RandomState(seed + 1)`` ``scan_chunk`` at a time
(:func:`arith_stream_batch`, the same draws as JAX's). Training runs no
kernel of the port: the exact attention is plain PyTorch, as JAX's ``"ref"``.
:func:`eval_accuracy` grades greedy answers generated through the quantized
cache (``models.llm.generate``: kernels C1 and A for the prefill, D for the
decode). The DiT's training is ``models/dit.sgd_train_step``.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import functools
import math
from typing import Callable, List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from lowbit_quant_fa2_paddle_tpu_torch.models import llm as L

CHARS = "0123456789+=;"
VOCAB = len(CHARS)  # 13
EOS = CHARS.index(";")
FACT_LEN = 10  # "ab+cd=xyz;"
ANS_LEN = 4  # "xyz;"
Q_LEN = 6  # "ab+cd="


def encode(s: str) -> List[int]:
    return [CHARS.index(c) for c in s]


def decode_ids(ids) -> str:
    return "".join(CHARS[int(i)] for i in ids if 0 <= int(i) < VOCAB)


def fact(a: int, b: int) -> str:
    return f"{a:02d}+{b:02d}={a + b:03d};"


def arith_stream_batch(rng: np.random.RandomState, batch: int, seq_len: int) -> np.ndarray:
    """``[batch, seq_len + 1]`` int32: concatenated facts, example-aligned;
    the same draws (two ``randint(0, 100, (batch, n_facts))``) and the same
    tokens as the JAX package's for the same ``rng`` state, built as arrays
    instead of strings."""
    n_facts = -(-(seq_len + 1) // FACT_LEN)
    a = rng.randint(0, 100, size=(batch, n_facts))
    b = rng.randint(0, 100, size=(batch, n_facts))
    s = a + b
    plus, eq, semi = (np.full_like(a, CHARS.index(c)) for c in "+=;")
    facts = np.stack([a // 10, a % 10, plus, b // 10, b % 10, eq, s // 100, s // 10 % 10, s % 10, semi], axis=-1)
    return facts.reshape(batch, n_facts * FACT_LEN)[:, : seq_len + 1].astype(np.int32)


def arith_llm_config(**kw) -> L.LLMConfig:
    """The checkpoint's geometry: dim 256, depth 4, 8 query heads, 2 KV
    heads (head dim 32), vocab 13, f32."""
    base = dict(vocab=VOCAB, dim=256, depth=4, num_heads=8, num_kv_heads=2, max_seq=128, dtype=torch.float32)
    base.update(kw)
    return L.LLMConfig(**base)


def make_eval_prompts(n: int, *, few_shot: int = 3, seed: int = 123) -> Tuple[np.ndarray, List[str]]:
    """Held-out eval set: ``n`` prompts ``[n, few_shot*10 + 6]`` ending in
    ``"ab+cd="`` and the true 3-digit answers; the same draws as the JAX
    package's for the same seed."""
    rng = np.random.RandomState(seed)
    prompts = np.empty((n, few_shot * FACT_LEN + Q_LEN), np.int32)
    answers = []
    for i in range(n):
        shots = "".join(fact(int(rng.randint(0, 100)), int(rng.randint(0, 100))) for _ in range(few_shot))
        a, b = int(rng.randint(0, 100)), int(rng.randint(0, 100))
        prompts[i] = encode(shots + f"{a:02d}+{b:02d}=")
        answers.append(f"{a + b:03d}")
    return prompts, answers


def grade_answer(gen_ids, answer: str) -> bool:
    """Exact task match: the 3 generated digits equal the true sum."""
    return decode_ids(gen_ids[:3]) == answer


def _loss(params: L.LLM, tok_in: torch.Tensor, tok_tgt: torch.Tensor, cfg: L.LLMConfig) -> torch.Tensor:
    """Mean next-token NLL of the exact-attention forward's logits, in f32."""
    logp = F.log_softmax(L.llm_logits(params, tok_in, cfg, attn_impl="ref").float(), dim=-1)
    return -logp.gather(-1, tok_tgt[..., None])[..., 0].mean()


@functools.lru_cache(maxsize=None)
def _libm():
    """The C library's f32 ``cosf``, ``fmaf`` and ``powf``."""
    lib = ctypes.CDLL(ctypes.util.find_library("m"))
    for name, n in (("cosf", 1), ("fmaf", 3), ("powf", 2)):
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = ctypes.c_float, [ctypes.c_float] * n
    return lib


def warmup_cosine_lr(count: int, peak: float, warmup_steps: int, decay_steps: int) -> float:
    """optax's ``warmup_cosine_decay_schedule(0.0, peak, warmup_steps,
    decay_steps)`` (end value 0, exponent 1) at ``count``: a linear ramp from
    0 over ``warmup_steps`` (none at 0), then ``peak · ½(1 + cos(π·c/T))``
    with ``c = count - warmup_steps`` clamped at ``T = decay_steps -
    warmup_steps`` (``decay_steps`` includes the warm-up, and the end value
    is 0). In f32 and in the order XLA compiles optax's expression on a
    CPU, so the values are the same bits: a division by a constant as a
    product with its f32 reciprocal, π/T folded into one constant
    ``π·(1/T)``, ``½·peak`` into another, the ramp's two multiply-adds fused,
    and the C library's ``cosf``."""
    f32, m = np.float32, _libm()
    if count < warmup_steps:
        c = f32(min(max(count, 0), warmup_steps))
        frac = m.fmaf(-c, f32(1) / f32(warmup_steps), 1.0)
        return float(f32(m.fmaf(frac, -peak, f32(peak))))
    t = f32(decay_steps - warmup_steps)
    c = min(f32(count - warmup_steps), t)
    cosine = f32(1) + f32(m.cosf(c * (f32(math.pi) * (f32(1) / t))))
    return float(cosine * (f32(0.5) * f32(peak)))


class AdamW:
    """``optax.adamw(schedule, weight_decay=1e-4)`` (b1 0.9, b2 0.999, eps
    1e-8) over ``params`` in place, in optax's order of
    operations: ``m = (1-b1)·g + b1·m``, ``v = (1-b2)·g² + b2·v``, the bias
    corrections ``1 - b^t`` at the incremented count, ``u = m̂ / (√v̂ + eps)
    + wd·p``, then ``p + (-lr)·u`` with ``lr`` the schedule at the count
    before the update (so the first update of a warm-up from 0 is zero).
    ``torch.optim.AdamW`` differs (weight decay 1e-2 by default, and another
    order).

    :meth:`update` reads the step's ``-lr`` and bias corrections from the
    device tensor ``scalars`` (:meth:`scalars_at` gives them for a count)
    and makes no host value, so a CUDA graph can capture it."""

    B1, B2, EPS, WEIGHT_DECAY = 0.9, 0.999, 1e-8, 1e-4

    def __init__(self, params: Sequence[torch.Tensor], schedule: Callable[[int], float]):
        self.params = list(params)
        self.schedule = schedule
        self.m = [torch.zeros_like(p) for p in self.params]
        self.v = [torch.zeros_like(p) for p in self.params]
        self.scalars = torch.zeros(3, dtype=torch.float32, device=self.params[0].device)

    def scalars_at(self, count: int) -> List[float]:
        """``[-lr, 1 - b1^t, 1 - b2^t]`` (f32 values) of update ``count``
        (``t = count + 1``)."""
        f32, m = np.float32, _libm()
        return [float(-f32(self.schedule(count))), float(f32(1) - f32(m.powf(self.B1, count + 1))),
                float(f32(1) - f32(m.powf(self.B2, count + 1)))]

    @torch.no_grad()
    def update(self, grads: Sequence[torch.Tensor]) -> None:
        """One update with ``scalars`` as they stand."""
        neg_lr, bc1, bc2 = self.scalars[0], self.scalars[1], self.scalars[2]
        b1, b2 = self.B1, self.B2
        for p, g, m, v in zip(self.params, grads, self.m, self.v):
            m.mul_(b1).add_(g * (1 - b1))
            v.mul_(b2).add_(g * g * (1 - b2))
            u = (m / bc1) / (torch.sqrt(v / bc2) + self.EPS) + p * self.WEIGHT_DECAY
            p.add_(u * neg_lr)


class _Step:
    """One training step of ``params`` on the tokens in the static buffer
    ``tok``: the loss, its gradients, the AdamW update, the loss kept in
    ``loss``. On the card the step is captured once as a CUDA graph and
    replayed; its first call runs it eagerly on a side stream before the
    capture, so cuBLAS' workspace and autograd's device state exist (the
    capture records and runs nothing). The schedule's scalars for every
    count go to the device once, and each step copies its row into the
    optimizer's ``scalars`` on the device, so no step waits for the host."""

    def __init__(self, params: L.LLM, cfg: L.LLMConfig, opt: AdamW, batch: int, seq_len: int, steps: int):
        self.params, self.cfg, self.opt = params, cfg, opt
        self.ps = list(params.parameters())
        dev = self.ps[0].device
        self.tok = torch.zeros(batch, seq_len + 1, dtype=torch.long, device=dev)
        self.loss = torch.zeros((), dtype=torch.float32, device=dev)
        self.table = torch.tensor([opt.scalars_at(c) for c in range(steps)], dtype=torch.float32).to(dev)
        self.graph = None
        self.count = 0

    def _body(self) -> None:
        loss = _loss(self.params, self.tok[:, :-1], self.tok[:, 1:], self.cfg)
        self.opt.update(torch.autograd.grad(loss, self.ps))
        self.loss.copy_(loss.detach())

    def __call__(self, tok: torch.Tensor) -> torch.Tensor:
        self.tok.copy_(tok)
        self.opt.scalars.copy_(self.table[self.count])
        if self.tok.device.type != "cuda":
            self._body()
        elif self.graph is not None:
            self.graph.replay()
        else:
            dev = self.tok.device
            side = torch.cuda.Stream(dev)
            side.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(side):
                self._body()
            torch.cuda.current_stream(dev).wait_stream(side)
            self.graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(self.graph):
                self._body()
        self.count += 1
        return self.loss


def train_steps(params: L.LLM, cfg: L.LLMConfig, *, steps: int = 3000, batch: int = 64, seq_len: int = 64,
                lr: float = 1e-3, seed: int = 0, scan_chunk: int = 50, verbose=None) -> List[float]:
    """:func:`train_toy_llm`'s loop on given parameters, trained in place
    (their ``requires_grad`` is on while it runs and restored after); on
    the card one CUDA graph of the step, replayed (:class:`_Step`). Returns
    the per-chunk mean losses; ``scan_chunk=1`` gives every step's."""
    ps = list(params.parameters())
    was = [p.requires_grad for p in ps]
    dev = ps[0].device
    opt = AdamW(ps, lambda c: warmup_cosine_lr(c, lr, min(100, steps // 10), steps))
    rng = np.random.RandomState(seed + 1)
    losses: List[float] = []
    done = 0
    try:
        for p in ps:
            p.requires_grad_(True)
        step = _Step(params, cfg, opt, batch, seq_len, steps)
        while done < steps:
            c = min(scan_chunk, steps - done)
            toks = torch.from_numpy(np.stack([arith_stream_batch(rng, batch, seq_len) for _ in range(c)]))
            toks = toks.to(dev).long()
            ls = torch.empty(c, device=dev)
            for i in range(c):
                ls[i] = step(toks[i])
            losses.append(float(np.mean(ls.cpu().numpy())))
            done += c
            if verbose:
                verbose(done, losses[-1])
    finally:
        for p, w in zip(ps, was):
            p.requires_grad_(w)
    return losses


def train_toy_llm(cfg: L.LLMConfig, *, steps: int = 3000, batch: int = 64, seq_len: int = 64, lr: float = 1e-3,
                  seed: int = 0, scan_chunk: int = 50, verbose=None, device="cuda") -> Tuple[L.LLM, List[float]]:
    """AdamW with a warm-up and cosine decay over ``steps`` (JAX's recipe;
    ``scan_chunk`` steps a chunk of token batches, the chunk's mean loss
    kept). Parameters from ``models.llm.init_llm_params`` with a generator
    seeded by ``seed`` on ``device``. Returns ``(params, per-chunk mean
    losses)``."""
    params = L.init_llm_params(cfg, torch.Generator(device=device).manual_seed(seed), device=device)
    losses = train_steps(params, cfg, steps=steps, batch=batch, seq_len=seq_len, lr=lr, seed=seed,
                         scan_chunk=scan_chunk, verbose=verbose)
    return params, losses


def eval_accuracy(params: L.LLM, cfg: L.LLMConfig, prompts: np.ndarray, answers: List[str], *,
                  batch: int = 32) -> Tuple[float, List[str]]:
    """Batched greedy generation through the quantized cache
    (``models.llm.generate``: kernels C1 and A prefill, D decodes, in the
    cache mode ``cfg`` names); returns ``(exact-match accuracy, the
    generated 3-digit answers)``."""
    dev = params.embed.weight.device
    preds: List[str] = []
    for i in range(0, len(prompts), batch):
        pb = torch.from_numpy(np.ascontiguousarray(prompts[i:i + batch])).to(dev)
        out = L.generate(params, pb, ANS_LEN, cfg).cpu().numpy()
        preds.extend(decode_ids(row[:3]) for row in out)
    acc = float(np.mean([p == a for p, a in zip(preds, answers)]))
    return acc, preds
