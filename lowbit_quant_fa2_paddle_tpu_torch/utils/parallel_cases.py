"""The parallel layer's cases, and the rank processes that run them.

Each case names a mesh, a strategy and its inputs. A rank takes its shard of
the inputs, runs the strategy over gloo, and the shards of the result are
gathered; rank 0 keeps them. The suites:

* ``cpu``: the CPU tests (``tests/test_torch_parallel.py``) at small sizes,
  inputs from numpy with a seed, so the test can put the same inputs through
  the JAX package's ``make_*`` wrappers. One world of 8 ranks runs every
  case on the mesh it names (ranks past the mesh's size sit the case out);
  the world of 2 (``init``) joins through torchrun's environment variables.
* ``card``: ``chip_smoke.py``'s parallel phase. Four ranks share the card
  (``cuda:0``), exchanging over gloo through host memory, at full width:
  ring attention at the CogVideoX-2b shape, Ulysses, the facade, context-
  and head-sharded decode at the full-width LLM's decode shape, CogVideoX-2b
  denoise steps with ring and Ulysses attention, and the pipelined DiT.
  Every result is held to the single-process port on the card, each rank
  counts its kernel launches, and the whole runs with every launch counter
  zeroed first; rank 0 writes the report.
* ``dryrun`` (CPU, ``tests/test_torch_dryrun.py``) and ``train`` (the card,
  ``chip_smoke.py``'s phase 23): the DiT's training layouts.

Card suites joined by commas (``--suite card,train``) run in turn in the
same ranks, which then start once; each writes ``rank<r>.<suite>.json``.

Run one rank: ``python -m lowbit_quant_fa2_paddle_tpu_torch.utils.parallel_cases
--suite cpu --world 8 --rank 0 --init file:///tmp/rdv --out DIR``; :func:`spawn`
starts all of them and :func:`wait` waits for them, ending every rank if one
fails. This module imports no JAX.
"""

from __future__ import annotations

import argparse
import functools
import json
import logging
import math
import os
import subprocess
import sys
import time
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from lowbit_quant_fa2_paddle_tpu_torch import parallel as P
from lowbit_quant_fa2_paddle_tpu_torch.core import lowbit_fa_qk_int8_pv_fp16
from lowbit_quant_fa2_paddle_tpu_torch.models import dit
from lowbit_quant_fa2_paddle_tpu_torch.ops import decode as DD
from lowbit_quant_fa2_paddle_tpu_torch.ops.attention import lowbit_attention
from lowbit_quant_fa2_paddle_tpu_torch.ops.attention_bwd import attention_bwd_dkv, attention_bwd_dq
from lowbit_quant_fa2_paddle_tpu_torch.ops.metrics import cosine_similarity
from lowbit_quant_fa2_paddle_tpu_torch.ops.quant import quant_int4, quant_int8
from lowbit_quant_fa2_paddle_tpu_torch.parallel import dryrun, mesh as M, sharded, transport
from lowbit_quant_fa2_paddle_tpu_torch.parallel.pipeline import make_pipelined_dit
from lowbit_quant_fa2_paddle_tpu_torch.parallel.ulysses import ulysses_attention

SEQ = (None, None, "seq", None)
ATTN_SPECS = {"ring": SEQ, "ulysses": SEQ, "ulysses_fn": SEQ, "head_parallel": ("data", "model", None, None),
              "facade": ("data", "model", "seq", None)}

# name: (kind, mesh degrees, inputs, strategy keywords). Inputs: ("qkv", seed,
# b, h, hk, s, d, k shift, dtype), ("decode", seed, b, h, hk, s, d, lengths),
# ("dit", depth, microbatches, s).
CPU_CASES = {
    "ring": ("ring", {"seq": 4}, ("qkv", 0, 2, 8, 8, 256, 64, 1.0, "float32"), {}),
    "ring-causal": ("ring", {"seq": 4}, ("qkv", 0, 2, 8, 8, 256, 64, 1.0, "float32"), {"is_causal": True}),
    "ring-lse": ("ring", {"seq": 4}, ("qkv", 1, 2, 8, 8, 256, 64, 0.0, "float32"), {"return_lse": True}),
    "ring-k4v8": ("ring", {"seq": 4}, ("qkv", 5, 2, 8, 8, 256, 64, 0.0, "float32"), {"k_bits": 4, "v_bits": 8}),
    "ring-k4v8-causal": ("ring", {"seq": 4}, ("qkv", 5, 2, 8, 8, 256, 64, 0.0, "float32"),
                         {"k_bits": 4, "v_bits": 8, "is_causal": True}),
    "ring-degree8": ("ring", {"seq": 8}, ("qkv", 2, 2, 8, 8, 512, 64, 0.0, "float32"), {"is_causal": True}),
    # 64 tokens a shard: a window of 100 runs 3 of the 4 hops.
    "ring-window": ("ring", {"seq": 4}, ("qkv", 3, 1, 4, 4, 256, 64, 0.5, "float32"),
                    {"is_causal": True, "window_size": 100, "return_lse": True}),
    "ring-gqa": ("ring", {"seq": 4}, ("qkv", 0, 1, 8, 2, 256, 64, 0.0, "float32"), {"is_causal": True}),
    "ring-gqa-lse": ("ring", {"seq": 4}, ("qkv", 2, 1, 8, 2, 128, 64, 0.0, "float32"), {"return_lse": True}),
    "ulysses": ("ulysses", {"seq": 4}, ("qkv", 3, 2, 8, 8, 256, 64, 0.0, "float32"), {}),
    "ulysses-causal": ("ulysses", {"seq": 4}, ("qkv", 3, 2, 8, 8, 256, 64, 0.0, "float32"), {"is_causal": True}),
    "ulysses-wire8": ("ulysses", {"seq": 4}, ("qkv", 6, 2, 8, 8, 256, 64, 0.5, "float32"), {"wire_bits": 8}),
    "ulysses-wire8-causal": ("ulysses", {"seq": 4}, ("qkv", 6, 2, 8, 8, 256, 64, 0.5, "float32"),
                             {"wire_bits": 8, "is_causal": True}),
    "ulysses-gqa": ("ulysses", {"seq": 2}, ("qkv", 1, 1, 8, 4, 256, 64, 0.0, "float32"), {}),
    # smooth_k=False on the float route, through the facade and through
    # ulysses_attention itself: K is smoothed all the same, as in JAX. A K
    # mean of 8 makes unsmoothed codes differ beyond the bounds.
    "ulysses-smooth_k-false-facade": ("facade", {"seq": 4}, ("qkv", 8, 2, 8, 8, 256, 64, 8.0, "float32"),
                                      {"seq_strategy": "ulysses", "smooth_k": False}),
    "ulysses-smooth_k-false": ("ulysses_fn", {"seq": 4}, ("qkv", 8, 2, 8, 8, 256, 64, 8.0, "float32"),
                               {"smooth_k": False}),
    "head-parallel": ("head_parallel", {"data": 2, "model": 4}, ("qkv", 4, 2, 8, 8, 256, 64, 0.0, "float32"), {}),
    "facade-ulysses": ("facade", {"data": 2, "seq": 2, "model": 2}, ("qkv", 5, 2, 8, 8, 256, 64, 0.0, "float32"),
                       {"seq_strategy": "ulysses"}),
    "facade-ring": ("facade", {"data": 2, "seq": 2, "model": 2}, ("qkv", 5, 2, 8, 8, 256, 64, 0.0, "float32"),
                    {"seq_strategy": "ring"}),
    "decode-context-full": ("context_decode", {"seq": 4}, ("decode", 11, 2, 8, 2, 512, 64, [512, 512]), {}),
    "decode-context-ragged": ("context_decode", {"seq": 4}, ("decode", 11, 2, 8, 2, 512, 64, [400, 130]), {}),
    "decode-head": ("head_decode", {"model": 4}, ("decode", 12, 2, 8, 4, 256, 64, [256, 200]), {}),
    "pipeline-pp2": ("pipeline", {"pp": 2}, ("dit", 4, 4, 64), {"microbatches": 4}),
    "pipeline-pp4": ("pipeline", {"pp": 4}, ("dit", 4, 4, 64), {"microbatches": 4}),
    # The wire's payload: bf16 inputs, one shard of 64 tokens a rank.
    "payload-int8": ("ring", {"seq": 4}, ("qkv", 7, 1, 2, 2, 256, 64, 0.0, "bfloat16"), {}),
    "payload-k4": ("ring", {"seq": 4}, ("qkv", 7, 1, 2, 2, 256, 64, 0.0, "bfloat16"), {"k_bits": 4}),
    "payload-v8": ("ring", {"seq": 4}, ("qkv", 7, 1, 2, 2, 256, 64, 0.0, "bfloat16"), {"v_bits": 8}),
    "payload-window": ("ring", {"seq": 4}, ("qkv", 7, 1, 2, 2, 256, 64, 0.0, "bfloat16"),
                       {"is_causal": True, "window_size": 100}),
    "payload-ulysses-wire8": ("ulysses", {"seq": 4}, ("qkv", 7, 1, 4, 4, 256, 64, 0.0, "bfloat16"),
                              {"wire_bits": 8}),
    "payload-ulysses": ("ulysses", {"seq": 4}, ("qkv", 7, 1, 4, 4, 256, 64, 0.0, "bfloat16"), {}),
}
CPU_WORLD = 8
# The two-process bring-up (JAX's test_distributed_init): an all-reduce, then
# causal ring attention sequence-sharded over both processes.
INIT_RING = ("qkv", 11, 1, 2, 2, 256, 64, 0.0, "float32")


def qkv_inputs(seed, b, h, hk, s, d, k_shift, dtype):
    """q ``[b, h, s, d]``, k and v ``[b, hk, s, d]`` from a numpy seed (f32;
    the torch side casts to ``dtype``)."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, h, s, d), dtype=np.float32)
    k = rng.standard_normal((b, hk, s, d), dtype=np.float32) + np.float32(k_shift)
    v = rng.standard_normal((b, hk, s, d), dtype=np.float32)
    return q, k, v


def decode_inputs(seed, b, h, hk, s, d, lengths):
    """A query ``[b, h, d]`` and an int8 per-token KV cache from a numpy seed:
    ``(q, k codes, k scale, v codes, v scale, lengths)`` as numpy arrays, the
    codes made by the port's C1 (its plain version on the CPU)."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, h, d), dtype=np.float32)
    k = rng.standard_normal((b, hk, s, d), dtype=np.float32)
    v = rng.standard_normal((b, hk, s, d), dtype=np.float32)
    kc, ks = quant_int8(torch.from_numpy(k), gran="per_token")
    vc, vs = quant_int8(torch.from_numpy(v), gran="per_token")
    return q, kc.numpy(), ks.numpy(), vc.numpy(), vs.numpy(), np.array(lengths, np.int32)


def dit_inputs(depth, microbatches, s):
    """The pipeline case's tiny DiT (``models.dit.tiny_config(depth)``, from
    a torch seed on the CPU), its latents ``[2·microbatches, s, dim]`` (f32
    numpy; bf16 on both sides) and one timestep for every row."""
    cfg = dit.tiny_config(depth=depth)
    model = dit.init_dit_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    x = np.random.default_rng(1).standard_normal((2 * microbatches, s, cfg.dim), dtype=np.float32)
    return cfg, model, x, np.full((2 * microbatches,), 37.0, np.float32)


def case_inputs(name: str):
    kind, _, spec, _ = CPU_CASES[name]
    if spec[0] == "qkv":
        return qkv_inputs(*spec[1:])
    if spec[0] == "decode":
        return decode_inputs(*spec[1:])
    return dit_inputs(*spec[1:])


def _attention_fn(kind, mesh, kw):
    if kind == "ring":
        return P.make_ring_attention(mesh, **kw)
    if kind == "ulysses":
        return P.make_ulysses_attention(mesh, **kw)
    if kind == "ulysses_fn":
        return functools.partial(ulysses_attention, group=mesh.group("seq"), **kw)
    if kind == "head_parallel":
        return sharded.make_head_parallel_attention(mesh, **kw)
    return sharded.make_parallel_attention(mesh, **kw)


def run_attention(kind, mesh, kw, q, k, v):
    """``kind``'s strategy on this rank's shards of the global ``q, k, v``:
    the gathered ``o`` (and ``lse``) and what this rank sent."""
    spec = ATTN_SPECS[kind]
    fn = _attention_fn(kind, mesh, kw)
    local = [M.shard(x, mesh, spec) for x in (q, k, v)]
    transport.WIRE.reset()
    out = fn(*local)
    wire = transport.WIRE.summary()
    o, lse = out if kw.get("return_lse") else (out, None)
    r = {"o": M.gather(o, mesh, spec), "wire": wire}
    if lse is not None:
        r["lse"] = M.gather(lse, mesh, spec[:3])
    return r


def run_decode(kind, mesh, q, kc, ks, vc, vs, lengths):
    if kind == "context_decode":
        fn = P.make_context_sharded_decode(mesh)
        specs = [(), SEQ, SEQ, SEQ[:3], (), SEQ[:3]]
        out_spec = ()
    else:
        fn = P.make_head_sharded_decode(mesh)
        q_spec = (None, "model", None)
        specs = [q_spec, (None, "model", None, None), (None, "model", None, None), q_spec, (), q_spec]
        out_spec = q_spec
    args = [M.shard(x, mesh, s) for x, s in zip((q, kc, vc, ks, lengths, vs), specs)]
    transport.WIRE.reset()
    o = fn(*args)
    wire = transport.WIRE.summary()
    return {"o": M.gather(o, mesh, out_spec), "wire": wire}


def run_pipeline(mesh, cfg, model, x, t, microbatches, attn_impl="exact"):
    fn = make_pipelined_dit(mesh, cfg, microbatches=microbatches, attn_impl=attn_impl)
    transport.WIRE.reset()
    with torch.no_grad():
        out = fn(model, x, t)
    return {"o": out, "wire": transport.WIRE.summary()}


def run_cpu_case(name: str, mesh) -> dict:
    kind, _, spec, kw = CPU_CASES[name]
    inputs = case_inputs(name)
    if spec[0] == "qkv":
        q, k, v = (torch.from_numpy(x).to(getattr(torch, spec[-1])) for x in inputs)
        return run_attention(kind, mesh, kw, q, k, v)
    if spec[0] == "decode":
        return run_decode(kind, mesh, *(torch.from_numpy(x) for x in inputs))
    cfg, model, x, t = inputs
    x, t = torch.from_numpy(x).to(cfg.dtype), torch.from_numpy(t)
    r = run_pipeline(mesh, cfg, model, x, t, kw["microbatches"])
    with torch.no_grad():
        r["sequential"] = dit.dit_forward(model, x, t, attn_impl="exact")
    return r


def cpu_suite(rank: int, out_dir: str) -> dict:
    results = {}
    for name, (_, degrees, _, _) in CPU_CASES.items():
        mesh = M.make_mesh(degrees)
        if mesh.member:
            results[name] = run_cpu_case(name, mesh)
    mesh = M.make_mesh({"seq": 4})
    if mesh.member:  # six heads over four Ulysses ranks
        q = torch.zeros(1, 6, 16, 64)
        try:
            _attention_fn("ulysses", mesh, {})(q, q, q)
        except ValueError as e:
            results["ulysses-indivisible"] = str(e)
    return results


def init_suite(rank: int, out_dir: str) -> dict:
    """The two-process bring-up: an all-reduce of ``rank + 1``, then causal
    ring attention over both processes."""
    mesh = M.make_mesh({"seq": -1})
    total = transport.all_reduce(torch.full((3,), float(rank + 1)), dist.group.WORLD, site="init")
    q, k, v = (torch.from_numpy(x) for x in qkv_inputs(*INIT_RING[1:]))
    return {"all_reduce": total, "world": dist.get_world_size(),
            **run_attention("ring", mesh, {"is_causal": True}, q, k, v)}


# ---------------------------------------------------------------------------
# The card suite (chip_smoke.py's parallel phase)
# ---------------------------------------------------------------------------

CARD_WORLD = 4
#: Where the card suite runs (every rank on the one card).
CARD = "cuda"
#: The DiT's attention shape (CogVideoX-2b: 30 heads of 64 over a 49x480x720
#: video latent's 17,776 tokens).
DIT_SHAPE = (1, 30, 17776, 64)
#: The full-width LLM's decode shape: b4, 32 query and 8 KV heads of 128 over
#: a 32K int8 cache; the lengths leave shards of 8,192 rows whole, partly and
#: wholly empty.
DECODE_SHAPE = dict(b=4, h=32, hk=8, s=32768, d=128, lengths=[32768, 1, 4097, 20000])
#: Bounds against the single-process port on the card: JAX's
#: test_parallel.py against the dense oracle (cos > 0.999 for int8, > 0.99 for
#: packed INT4 K; the int8 ring's LSE within 5e-2 + 1e-2·|lse|); decode: phase 9's cosine,
#: one bf16 ulp of max|o| for the head shards (the same kernel over fewer
#: heads) and two for the context shards (each shard's partial rounds to
#: bf16 before the merge); the sequence-parallel DiT step: frames
#: (x - 0.1·eps) cos >= 0.999 and eps cos >= 0.99 (the int8_v8 bound of phase
#: 5); the pipelined forward, the same blocks on microbatches: eps cos >= 0.999.
RING_COS = {8: 0.999, 4: 0.99}
LSE_ATOL, LSE_RTOL = 5e-2, 1e-2
DECODE_COS = 0.99999
FRAME_COS, EPS_COS, PIPELINE_COS = 0.999, 0.99, 0.999


def _wrappers():
    return {"A": lowbit_attention, "C1": quant_int8, "C2": quant_int4, "D": DD.decode_attention,
            "G1": attention_bwd_dq, "G2": attention_bwd_dkv}


def launch_reset() -> None:
    for w in _wrappers().values():
        w.launches = 0
        for key in w.launches_by_design:
            w.launches_by_design[key] = 0


def launch_counts() -> dict:
    return {name: {"launches": w.launches, "by_design": dict(w.launches_by_design)} for name, w in _wrappers().items()}


def _cos(a, b) -> float:
    return float(cosine_similarity(a.float(), b.float()))


def _bf16_ulp(x: float) -> float:
    return 2.0 ** (math.floor(math.log2(x)) - 7)


class CardRun:
    """One rank's run of the card suite: per case its launches, what it
    sent, its host seconds and (rank 0) its comparison with the
    single-process port."""

    def __init__(self, rank: int):
        self.rank = rank
        self.cases: Dict[str, dict] = {}
        self.gen = torch.Generator(device=CARD)

    def randn(self, *shape, seed: int, dtype=torch.bfloat16):
        self.gen.manual_seed(seed)
        return torch.randn(*shape, generator=self.gen, device=CARD).to(dtype)

    def run(self, name: str, fn, mesh) -> Optional[object]:
        """``fn()`` on this rank with the launch counters zeroed just before
        and read just after; ranks outside ``mesh`` sit it out."""
        dist.barrier()
        if not mesh.member:
            return None
        torch.cuda.synchronize()
        launch_reset()
        transport.WIRE.reset()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        self.cases[name] = {"launches": launch_counts(), "wire": transport.WIRE.summary(),
                            "host_s": time.perf_counter() - t0}
        return out

    def check(self, name: str, ok: bool, **stats) -> None:
        self.cases[name].update(stats)
        print(f"[parallel] rank {self.rank} {name}: " + " ".join(
            f"{k}={v:.6g}" if isinstance(v, float) else f"{k}={v}" for k, v in stats.items()), flush=True)
        if not ok:
            raise AssertionError(f"parallel case {name} is out of its bounds: {stats}")


def card_attention_cases(run: CardRun) -> None:
    """(a) ring attention at the DiT shape over 4 ranks, (b) Ulysses at degree
    2 over a data-2 mesh (a CFG batch of 2), (c) the facade at model 2 x ring
    2; each gathered and held to the single-process int8 entry point."""
    b, h, s, d = DIT_SHAPE
    cases = [
        ("a ring int8", {"seq": 4}, "ring", b, dict(return_lse=True)),
        ("a ring int8 causal", {"seq": 4}, "ring", b, dict(is_causal=True, return_lse=True)),
        ("a ring k4v8", {"seq": 4}, "ring", b, dict(k_bits=4, v_bits=8, return_lse=True)),
        ("a ring k4v8 causal", {"seq": 4}, "ring", b, dict(k_bits=4, v_bits=8, is_causal=True, return_lse=True)),
        ("b ulysses", {"data": 2, "seq": 2}, "facade", 2, dict(seq_strategy="ulysses")),
        ("b ulysses wire8", {"data": 2, "seq": 2}, "facade", 2, dict(seq_strategy="ulysses", wire_bits=8)),
        ("c facade model2 ring2", {"seq": 2, "model": 2}, "facade", b, dict(seq_strategy="ring")),
    ]
    for i, (name, degrees, kind, bb, kw) in enumerate(cases):
        mesh = M.make_mesh(degrees)
        q = run.randn(bb, h, s, d, seed=100 + i)
        k = run.randn(bb, h, s, d, seed=200 + i) + 1.0  # a K mean for the global smooth-K
        v = run.randn(bb, h, s, d, seed=300 + i)
        r = run.run(name, lambda: run_attention(kind, mesh, kw, q, k, v), mesh)
        if run.rank != 0:
            continue
        causal = kw.get("is_causal", False)
        want = lowbit_fa_qk_int8_pv_fp16(q, k, v, is_causal=causal, return_lse=kw.get("return_lse", False))
        o_ref, lse_ref = want if kw.get("return_lse") else (want, None)
        stats = {"cos": _cos(r["o"], o_ref), "max_do": float((r["o"].float() - o_ref.float()).abs().max()),
                 "finite": bool(torch.isfinite(r["o"].float()).all())}
        ok = stats["finite"] and stats["cos"] > RING_COS[kw.get("k_bits", 8)]
        if lse_ref is not None:
            err = (r["lse"] - lse_ref).abs()
            stats["max_dlse"] = float(err.max())
            if kw.get("k_bits", 8) == 8:  # INT4 K moves the LSE by its own noise: JAX bounds only O there
                ok = ok and bool((err <= LSE_ATOL + LSE_RTOL * lse_ref.abs()).all())
        run.check(name, ok, **stats)
        del want, o_ref, lse_ref, r


def card_decode_cases(run: CardRun) -> None:
    """(d) context-sharded decode over 4 shards of the 32K int8 cache and
    head-sharded decode over 4 head shards, each held to single-process D."""
    c = DECODE_SHAPE
    q = run.randn(c["b"], c["h"], c["d"], seed=400)
    kc, ks = quant_int8(run.randn(c["b"], c["hk"], c["s"], c["d"], seed=401), gran="per_token")
    vc, vs = quant_int8(run.randn(c["b"], c["hk"], c["s"], c["d"], seed=402), gran="per_token")
    lengths = torch.tensor(c["lengths"], dtype=torch.int32, device=CARD)
    for name, kind, degrees, ulps in (("d context decode", "context_decode", {"seq": 4}, 2),
                                      ("d head decode", "head_decode", {"model": 4}, 1)):
        mesh = M.make_mesh(degrees)
        r = run.run(name, lambda: run_decode(kind, mesh, q, kc, ks, vc, vs, lengths), mesh)
        if run.rank != 0:
            continue
        want = DD.decode_attention(q, kc, vc, ks, lengths, v_scale=vs)
        ulp = _bf16_ulp(float(want.float().abs().max()))
        stats = {"cos": _cos(r["o"], want), "max_do": float((r["o"].float() - want.float()).abs().max()),
                 "bf16_ulp": ulp, "finite": bool(torch.isfinite(r["o"].float()).all())}
        run.check(name, stats["finite"] and stats["cos"] >= DECODE_COS and stats["max_do"] <= ulps * ulp, **stats)


def card_dit_cases(run: CardRun) -> None:
    """(e) one CogVideoX-2b denoise step (depth 30, dim 1920) with ring-4
    attention (b1) and one with Ulysses-2 attention over a data-2 mesh (a CFG
    batch of 2), each rank running the token-wise layers on its sequence
    shard; (f) the pipelined DiT at pp 2 (15 blocks a stage) over a data-2
    mesh, a CFG batch of 2 a data rank in 2 microbatches. Held to the
    single-process int8 step and forward."""
    cfg = dit.cogvideox_2b_config()
    model = dit.init_dit_params(cfg, torch.Generator(device=CARD).manual_seed(0), device=CARD)
    s = DIT_SHAPE[2]
    x = run.randn(4, s, cfg.dim, seed=500)
    t = torch.full((4,), 500.0, device=CARD)
    steps = {}

    def seq_step(mesh, attn, bb):
        spec = ("data", "seq", None)
        xl, tl = M.shard(x[:bb], mesh, spec), M.shard(t[:bb], mesh, ("data",))
        with torch.no_grad(), sharded.dit_attention(attn):
            eps = model(xl, tl, attn_impl="int8")
        return M.gather(eps, mesh, spec)

    ring = M.make_mesh({"seq": 4})
    steps["e dit ring4 step"] = (1, run.run("e dit ring4 step", lambda: seq_step(ring, P.make_ring_attention(ring),
                                                                                   1), ring))
    uly = M.make_mesh({"data": 2, "seq": 2})
    steps["e dit ulysses2 step"] = (2, run.run("e dit ulysses2 step",
                                               lambda: seq_step(uly, P.make_ulysses_attention(uly), 2), uly))
    pp = M.make_mesh({"data": 2, "pp": 2})

    def pipelined():
        xl, tl = M.shard(x, pp, ("data", None, None)), M.shard(t, pp, ("data",))
        return M.gather(run_pipeline(pp, cfg, model, xl, tl, 2, attn_impl="int8")["o"], pp, ("data", None, None))

    steps["f pipelined dit pp2"] = (4, run.run("f pipelined dit pp2", pipelined, pp))
    if run.rank != 0:
        return
    with torch.no_grad():
        want = model(x, t, attn_impl="int8")
    for name, (bb, eps) in steps.items():
        stats = {"eps_cos": _cos(eps, want[:bb]), "finite": bool(torch.isfinite(eps.float()).all())}
        ok = stats["finite"] and stats["eps_cos"] >= (PIPELINE_COS if name.startswith("f") else EPS_COS)
        if name.startswith("e"):
            stats["frame_cos"] = _cos(x[:bb] - 0.1 * eps, x[:bb] - 0.1 * want[:bb])
            ok = ok and stats["frame_cos"] >= FRAME_COS
        run.check(name, ok, **stats)


def card_suite(rank: int, out_dir: str) -> dict:
    run = CardRun(rank)
    t0 = time.perf_counter()
    card_attention_cases(run)
    card_decode_cases(run)
    card_dit_cases(run)
    torch.cuda.synchronize()
    return {"rank": rank, "seconds": time.perf_counter() - t0, "cases": run.cases,
            "peak_gib": torch.cuda.max_memory_allocated() / 2**30}


# ---------------------------------------------------------------------------
# The training layouts: the CPU dry-run suite and the card's training suite
# ---------------------------------------------------------------------------

DRYRUN_WORLD = 8
#: The learning rate of the sharded step's comparisons, the one of
#: tests/test_torch_dit_train.py's bounds.
STEP_LR = 1e-2
ROWS = ("data", "seq", None)
#: The data degrees of the FSDP training step's cases: at 4 every leaf of
#: tiny_config is sharded; at 3 the time embedding, the 128-wide biases and
#: mlp_in's bias stay whole on every rank.
FSDP_STEP_DATA = (4, 3)


def _check_step(loss, loss_ref, got: dit.DiT, want: dit.DiT, before: dict, lr: float) -> dict:
    """tests/test_torch_dit_train.py's bounds on a training step: the loss
    within 2e-3 relative; every updated tensor that starts nonzero within one
    bf16 ulp of its max|p|; every zero-initialised bias, whose new value is
    the whole update, at a cosine of the updates >= 0.8. Returns the worst
    of each and whether all hold."""
    want_p = dict(want.named_parameters())
    rel = abs(float(loss) / float(loss_ref) - 1.0)
    worst_ulps, worst_cos, ok = 0.0, 1.0, rel <= 2e-3
    for name, p in got.named_parameters():
        a, b = p.detach().double(), want_p[name].detach().double()
        if float(before[name].abs().max()) > 0:
            ulp = _bf16_ulp(float(b.abs().max()))
            worst_ulps = max(worst_ulps, float((a - b).abs().max()) / ulp)
        else:
            c = float(torch.nn.functional.cosine_similarity((a / lr).reshape(-1), (b / lr).reshape(-1), dim=0))
            worst_cos = min(worst_cos, c)
    ok = ok and worst_ulps <= 1.0 and worst_cos >= 0.8
    return {"loss": float(loss), "loss_ref": float(loss_ref), "loss_rel": rel, "worst_ulps": worst_ulps,
            "worst_zero_bias_cos": worst_cos, "ok": ok}


def _fsdp_step(fs: sharded.FSDPDiT, mesh, x0: torch.Tensor, t: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
    """One int8_train SGD step through the FSDP layout, a test of its
    backward: this rank's share of the loss as the sharded step takes it,
    the shards' gradients as the gathers' and copies' backwards leave them
    (summed over ``data``), then JAX's update ``p - bf16(lr·g)``. Returns the
    global loss."""
    n_global = x0.numel() * mesh.size("data")
    loss = dryrun.sharded_diffusion_loss(fs, x0, t, noise, n_global, "int8_train")
    grads = torch.autograd.grad(loss, list(fs.shards))
    with torch.no_grad():
        for p, g in zip(fs.shards, grads):
            p.sub_(STEP_LR * g.to(p.dtype))
    return transport.all_reduce(loss.detach(), mesh.group("data"), site="loss")


def dryrun_suite(rank: int, out_dir: str) -> dict:
    """The CPU tests' training layouts (``tests/test_torch_dryrun.py``), on
    inputs the test writes to ``out_dir/inputs.pt`` from the JAX package:
    (1) the FSDP forward of tiny_config over data 4, a batch row a rank;
    (2) one int8_train step through the FSDP layout over each of
    ``FSDP_STEP_DATA``, a batch row a rank; (3) one sharded int8_train step
    over data 2 × seq 2 × model 2 at JAX's dry-run shapes; (4)
    ``run_training_step_dryrun(8)``. Rank 0 keeps the gathered outputs, the
    updated parameters in JAX's tree and what was sent."""
    inputs = torch.load(os.path.join(out_dir, "inputs.pt"))
    results = {}
    f = inputs["fsdp"]
    mesh = M.make_mesh({"data": 4})
    if mesh.member:
        cfg = dit.tiny_config()
        fs = sharded.FSDPDiT.from_model(dit.params_from_jax(f["tree"], cfg, device="cpu"), mesh)
        transport.WIRE.reset()
        with torch.no_grad():
            o = fs(M.shard(f["x"].to(cfg.dtype), mesh, ("data", None, None)), M.shard(f["t"], mesh, ("data",)),
                   attn_impl="exact")
        results["fsdp"] = {"o": M.gather(o, mesh, ("data", None, None)), "wire": transport.WIRE.summary(),
                           "shard_shapes": {n: tuple(p.shape) for n, p in zip(fs.names, fs.shards)},
                           "gathered": dit.params_to_jax(fs.gathered())}
    fst = inputs["fsdp_step"]
    for n in FSDP_STEP_DATA:
        mesh = M.make_mesh({"data": n})
        if not mesh.member:
            continue
        cfg = dit.tiny_config()
        fs = sharded.FSDPDiT.from_model(dit.params_from_jax(f["tree"], cfg, device="cpu"), mesh)
        rows = ("data", None, None)
        transport.WIRE.reset()
        loss = _fsdp_step(fs, mesh, M.shard(fst["x0"][:n].to(cfg.dtype), mesh, rows),
                          M.shard(fst["t"][:n], mesh, ("data",)), M.shard(fst["noise"][:n].to(cfg.dtype), mesh, rows))
        wire = transport.WIRE.summary()
        whole = [name for name in fs.names if fs.dims[name] is None]
        # A replicated leaf must come out of the step the same on every rank.
        differ = [name for name, p in zip(fs.names, fs.shards) if fs.dims[name] is None
                  and not all(torch.equal(p, q) for q in transport.all_gather(p.detach()[None], mesh.group("data"),
                                                                               dim=0, site="check"))]
        results[f"fsdp step data{n}"] = {"loss": float(loss), "tree": dit.params_to_jax(fs.gathered()),
                                         "wire": wire, "replicated": whole, "replicated_differ": differ}
    st = inputs["step"]
    mesh = M.make_mesh(dryrun._factor(DRYRUN_WORLD))
    if mesh.member:
        cfg = dit.tiny_config(num_heads=st["num_heads"], dim=st["dim"])
        tp = dryrun.TPDiT.from_model(dit.params_from_jax(st["tree"], cfg, device="cpu"), mesh)
        transport.WIRE.reset()
        loss = dryrun.sharded_sgd_train_step(tp, M.shard(st["x0"].bfloat16(), mesh, ROWS),
                                             M.shard(st["t"], mesh, ("data",)),
                                             M.shard(st["noise"].bfloat16(), mesh, ROWS), lr=STEP_LR,
                                             attn_impl="int8_train")
        wire = transport.WIRE.summary()
        new = dit.params_to_jax(tp.gathered())
        results["step"] = {"loss": float(loss), "tree": new, "wire": wire,
                           "n_params": sum(p.numel() for p in tp.parameters())}
    results["dryrun"] = dryrun.run_training_step_dryrun(DRYRUN_WORLD, device="cpu")
    return results


#: Phase 23's mesh for the sharded step (data 1 × seq 2 × model 2: both
#: exchanging axes lit; _factor(4) would leave model at 1), its batch, the
#: FSDP forward's batch, and the depth of both at CogVideoX-2b's full width:
#: 4 of 30, for the smoke's time (depth 8 added ~27 s and left the whole
#: smoke 110 s short of its limit) and the card's memory (rank 0 runs the
#: single-process reference step beside its shard: 14.6 GiB at depth 4).
TRAIN_DEGREES = {"seq": 2, "model": 2}
TRAIN_BATCH, FSDP_BATCH = 2, 4
TRAIN_DEPTH = 4
#: The FSDP forward against the single-process forward of the same rows (a
#: batch row at a time, as the ranks run them): JAX's test_fsdp bound, |d| <=
#: 2e-2 + 2e-2·|y| elementwise. The gathered weights are the same bits and
#: the products the same shapes, so the outputs are expected equal (the
#: bit-equality is reported); against a b4 forward, whose GEMMs sum in
#: another order, four blocks of bf16 roundings put single elements past
#: this bound (max|d| 0.031, cos 0.999985).
FSDP_ATOL = FSDP_RTOL = 2e-2


def train_suite(rank: int, out_dir: str) -> dict:
    """Phase 23 (a) and (b) on the card: (a) one int8_train step of the
    CogVideoX-2b DiT (dim 1920, 30 heads × 64, depth ``TRAIN_DEPTH``,
    17,776 tokens a sample) over data 1 × seq 2 × model 2 at batch 2, held by
    rank 0 to the single-process ``sgd_train_step`` on the same weights,
    latents, t and noise at ``_check_step``'s bounds (the updated shards
    gathered back whole); (b) the FSDP forward over data 4 at batch 4
    (``attn_impl="int8"``), held by rank 0 to the single-process forward of
    the same rows.
    Each run's launches, bytes by wire site and host seconds per rank."""
    run = CardRun(rank)
    torch.cuda.reset_peak_memory_stats()  # the card suite may have run first in this process
    t0 = time.perf_counter()
    cfg = dit.cogvideox_2b_config(depth=TRAIN_DEPTH)
    s = DIT_SHAPE[2]

    mesh = M.make_mesh(TRAIN_DEGREES)
    model = dit.init_dit_params(cfg, torch.Generator(device=CARD).manual_seed(0), device=CARD)
    x0 = run.randn(TRAIN_BATCH, s, cfg.dim, seed=600)
    t, noise = dit.draw_t_noise(x0, torch.Generator(device=CARD).manual_seed(601))
    tp = dryrun.TPDiT.from_model(model, mesh)
    if rank != 0:
        del model
    local = (M.shard(x0, mesh, ROWS), M.shard(t, mesh, ("data",)), M.shard(noise, mesh, ROWS))
    loss = run.run("a sharded int8_train step", lambda: dryrun.sharded_sgd_train_step(
        tp, *local, lr=STEP_LR, attn_impl="int8_train"), mesh)
    got = tp.gathered()
    del tp, local
    if rank == 0:
        before = {n: p.detach().clone() for n, p in model.named_parameters()}
        loss_ref = dit.sgd_train_step(model, x0, t, noise, lr=STEP_LR, attn_impl="int8_train")
        r = _check_step(loss, loss_ref, got, model, before, STEP_LR)
        run.check("a sharded int8_train step", r.pop("ok") and bool(torch.isfinite(loss)), **r)
        del model, before
    del got, x0, noise
    torch.cuda.empty_cache()

    mesh = M.make_mesh({"data": 4})
    model = dit.init_dit_params(cfg, torch.Generator(device=CARD).manual_seed(0), device=CARD)
    x = run.randn(FSDP_BATCH, s, cfg.dim, seed=610)
    t = torch.tensor([50.0, 300.0, 600.0, 950.0], device=CARD)
    fs = sharded.FSDPDiT.from_model(model, mesh)
    if rank != 0:
        del model
    rows = ("data", None, None)
    xl, tl = M.shard(x, mesh, rows), M.shard(t, mesh, ("data",))

    def fsdp_forward():
        with torch.no_grad():
            return M.gather(fs(xl, tl, attn_impl="int8"), mesh, rows)

    out = run.run("b fsdp forward", fsdp_forward, mesh)
    if rank == 0:
        with torch.no_grad():  # each rank's rows as that rank ran them: a batch row at a time
            want = torch.cat([model(x[i:i + 1], t[i:i + 1], attn_impl="int8") for i in range(FSDP_BATCH)])
        d = (out.float() - want.float()).abs()
        stats = {"max_d": float(d.max()), "cos": _cos(out, want), "bit_equal": bool(torch.equal(out, want)),
                 "finite": bool(torch.isfinite(out.float()).all()),
                 "worst_of_bound": float((d / (FSDP_ATOL + FSDP_RTOL * want.float().abs())).max())}
        run.check("b fsdp forward", stats["finite"] and stats["worst_of_bound"] <= 1.0, **stats)
    torch.cuda.synchronize()
    return {"rank": rank, "seconds": time.perf_counter() - t0, "cases": run.cases,
            "peak_gib": torch.cuda.max_memory_allocated() / 2**30}


SUITES = {"cpu": cpu_suite, "init": init_suite, "card": card_suite, "dryrun": dryrun_suite, "train": train_suite}
CARD_SUITES = ("card", "train")


# ---------------------------------------------------------------------------
# Processes
# ---------------------------------------------------------------------------


def rank_env(repo: str) -> dict:
    """A rank's environment: the repo on the path, one intra-op thread, and
    gloo on the loopback device (the card's machine has no other)."""
    env = dict(os.environ)
    env["PYTHONPATH"] = repo + os.pathsep + env.get("PYTHONPATH", "")
    env.setdefault("GLOO_SOCKET_IFNAME", "lo")
    env["OMP_NUM_THREADS"] = "1"
    return env


def spawn(suite: str, world: int, out_dir: str, *, env_rank: bool = False) -> List[subprocess.Popen]:
    """Start ``world`` ranks of ``suite``, rendezvousing through a file in
    ``out_dir``; each writes its log to ``out_dir/rank<r>.log``. With
    ``env_rank`` the ranks read their rank and world size from torchrun's
    variables."""
    repo = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    os.makedirs(out_dir, exist_ok=True)
    init = "file://" + os.path.join(os.path.abspath(out_dir), "rendezvous")
    procs = []
    for r in range(world):
        env = rank_env(repo)
        cmd = [sys.executable, "-m", "lowbit_quant_fa2_paddle_tpu_torch.utils.parallel_cases", "--suite", suite,
               "--init", init, "--out", out_dir]
        if env_rank:
            env.update(RANK=str(r), WORLD_SIZE=str(world))
        else:
            cmd += ["--rank", str(r), "--world", str(world)]
        with open(os.path.join(out_dir, f"rank{r}.log"), "w") as log:
            procs.append(subprocess.Popen(cmd, cwd=repo, env=env, stdout=log, stderr=subprocess.STDOUT))
    return procs


def wait(procs: List[subprocess.Popen], out_dir: str, timeout_s: float) -> None:
    """Wait for every rank; if one fails or time runs out, end the others and
    raise with the failed ranks' logs."""
    deadline = time.monotonic() + timeout_s
    failed = None
    while any(p.poll() is None for p in procs):
        failed = next((r for r, p in enumerate(procs) if p.poll() not in (None, 0)), None)
        if failed is not None or time.monotonic() > deadline:
            break
        time.sleep(0.1)
    for p in procs:
        if p.poll() is None:
            p.kill()
        p.wait()
    bad = [r for r, p in enumerate(procs) if p.returncode != 0]
    if bad:
        logs = []
        for r in bad:
            with open(os.path.join(out_dir, f"rank{r}.log")) as f:
                logs.append(f"--- rank {r} (exit {procs[r].returncode}) ---\n{f.read()[-6000:]}")
        raise RuntimeError(f"parallel ranks {bad} failed (first: {failed})\n" + "\n".join(logs))


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--suite", required=True,
                   help=f"one of {sorted(SUITES)}, or card suites {CARD_SUITES} joined by commas (run in turn)")
    p.add_argument("--init", required=True, help="init_method, e.g. file:///tmp/rendezvous")
    p.add_argument("--out", required=True, help="directory for the results")
    p.add_argument("--rank", type=int, default=None)
    p.add_argument("--world", type=int, default=None)
    args = p.parse_args(argv)
    suites = args.suite.split(",")
    card = all(s in CARD_SUITES for s in suites)
    if not (card or (len(suites) == 1 and suites[0] in SUITES)):
        p.error(f"--suite {args.suite!r}: one of {sorted(SUITES)}, or card suites joined by commas")
    torch.set_num_threads(1)
    if card:
        torch.cuda.set_device(0)  # every rank shares the one card
    M.init_distributed("gloo", init_method=args.init, rank=args.rank, world_size=args.world)
    rank = dist.get_rank()
    logging.basicConfig(level=logging.INFO, format=f"[parallel] rank {rank}: %(message)s")
    for suite in suites:
        results = SUITES[suite](rank, args.out)
        if card:
            with open(os.path.join(args.out, f"rank{rank}.{suite}.json"), "w") as f:
                json.dump(results, f)
        elif rank == 0:
            torch.save(results, os.path.join(args.out, "results.pt"))
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
