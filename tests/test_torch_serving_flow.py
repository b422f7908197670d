"""The port's serving engine on its own, on a tiny random model (CPU, the
kernels' plain versions), mirroring the JAX package's tests/test_serving*.py:

* batching invariance: a request's tokens alone and among others are the
  same; with the prefix cache off they are ``models/llm.generate``'s;
* ``multi_step`` segments and ``async_fetch`` give the single ticks' tokens;
* ``eos_token`` stops a request on every decode path;
* a prefix-cache hit's first-token logits follow the whole prefill's;
* a request cancelled mid-prefill (budgeted) releases its pages, and
  chunking never skips a decode tick of the live slots;
* a sliding-window model's rolling reclamation keeps its live pages bounded
  and its tokens ``generate``'s;
* the same validation errors as the JAX engine;
* the engine and its host runtime import no JAX.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from lowbit_quant_fa2_paddle_tpu_torch.models import llm as TL
from lowbit_quant_fa2_paddle_tpu_torch.serving import ServingConfig, ServingEngine

# One intra-op thread: the suite runs a worker per core, and torch's thread
# pool, spinning under that load, slowed small CPU ops up to 50-fold.
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = TL.LLMConfig(vocab=64, dim=128, depth=2, num_heads=4, num_kv_heads=2, max_seq=128)


@pytest.fixture(scope="module")
def model():
    return TL.init_llm_params(CFG, torch.Generator().manual_seed(0), device="cpu")


def _prompts(n, seed=0, lo=3, hi=30):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, CFG.vocab, int(rng.integers(lo, hi))).tolist() for _ in range(n)]


def _serve(model, prompts, max_new, cfg=CFG, **opts):
    base = dict(page_size=8, num_pages=48, max_batch=3, prefix_caching=False)
    eng = ServingEngine(model, cfg, ServingConfig(**{**base, **opts}))
    rids = [eng.add_request(p, max_new) for p in prompts]
    out = eng.run()
    return [out[r] for r in rids], eng


def _first_logits(eng):
    """Each request's first-token logits (its prefill's, f32), by rid, kept
    as the engine hands them to ``_finish_prefill``."""
    first, finish = {}, eng._finish_prefill

    def keep(rid, logits, *rest):
        first[rid] = logits.float()
        return finish(rid, logits, *rest)

    eng._finish_prefill = keep
    return first


def test_batching_invariance_and_generate(model):
    prompts = _prompts(5)
    batched, eng = _serve(model, prompts, 6)
    for p, got in zip(prompts, batched):
        alone, _ = _serve(model, [p], 6)
        assert alone == [got]
        assert got == TL.generate(model, torch.tensor([p]), 6, CFG)[0].tolist()
    assert eng.stats()["free_pages"] == 48 and eng.stats()["outstanding"] == 0


@pytest.mark.parametrize("opts", [dict(multi_step=4), dict(async_fetch=True), dict(multi_step=8, prefill_budget=16)],
                         ids=["multi_step4", "async_fetch", "multi_step8-budget"])
def test_multi_step_and_async_fetch_equal_single_ticks(model, opts):
    prompts = _prompts(4, seed=1)
    single, _ = _serve(model, prompts, 9, **({"prefill_budget": 16} if "prefill_budget" in opts else {}))
    got, eng = _serve(model, prompts, 9, **opts)
    assert got == single
    if "multi_step" in opts:
        assert eng.multi_segments > 0


@pytest.mark.parametrize("opts", [{}, dict(multi_step=4), dict(spec_ngram=2, spec_k=3)],
                         ids=["single", "multi_step", "spec_ngram"])
def test_eos_token_stops_on_every_path(model, opts):
    prompt = _prompts(1, seed=2)[0]
    full, _ = _serve(model, [prompt], 10)
    eos = full[0][3]
    eng = ServingEngine(model, CFG, ServingConfig(page_size=8, num_pages=48, max_batch=2, prefix_caching=False, **opts))
    rid = eng.add_request(prompt, 10, eos_token=eos)
    out = eng.run()[rid]
    assert out == full[0][: full[0].index(eos) + 1]
    assert eng.stats()["free_pages"] == 48


def test_spec_ngram_equals_plain_and_cancel_mid_prefill(model):
    prompts = [p * 3 for p in _prompts(3, seed=3, lo=3, hi=6)]  # repeats: the n-gram index drafts
    plain, _ = _serve(model, prompts, 8)
    spec, eng = _serve(model, prompts, 8, spec_ngram=2, spec_k=4)
    assert spec == plain and eng.stats()["spec_rounds"] > 0
    # Budgeted prefill: a long prompt mid-chunk, cancelled, returns its pages;
    # a live slot decodes on every tick while another prompt chunks.
    eng = ServingEngine(model, CFG, ServingConfig(page_size=8, num_pages=48, max_batch=2, prefill_budget=8,
                                                  prefix_caching=False))
    short = eng.add_request(_prompts(1, seed=4, lo=4, hi=5)[0], 12)
    eng.step()  # the short prompt prefills and seats
    long = eng.add_request(_prompts(1, seed=5, lo=60, hi=61)[0], 4)
    for _ in range(3):
        n = len(eng.outputs[short])
        eng.step()
        assert len(eng.outputs[short]) == n + 1  # no decode tick skipped while the long prompt chunks
    assert eng.stats()["prefilling"] == 1 and eng.prefill_chunks == 4
    assert eng.cancel_request(long) == []
    eng.cancel_request(short)
    st = eng.stats()
    assert st["free_pages"] == 48 and st["outstanding"] == 0 and st["prefilling"] == 0


def test_prefix_hits_follow_the_miss(model):
    """A prefix-cache hit's first-token logits come from the chunked path
    over the quantized prefix pages: cos >= 0.999 against the same prompt
    prefilled whole (JAX's approximation note), read where the engine
    finishes a prefill."""
    shared = _prompts(1, seed=7, lo=40, hi=41)[0]
    prompts = [shared + [1, 2, 3], shared + [4, 5]]
    logits = []
    for caching in (False, True):
        eng = ServingEngine(model, CFG, ServingConfig(page_size=8, num_pages=48, max_batch=1, prefix_caching=caching))
        first = _first_logits(eng)
        rids = [eng.add_request(p, 2) for p in prompts]
        eng.run()
        logits.append([first[r] for r in rids])
        if caching:
            assert eng.stats()["prefix_hits"] == 5  # 40 shared tokens: 5 pages of 8
    assert torch.equal(logits[0][0], logits[1][0])  # the first prompt misses
    assert float(torch.nn.functional.cosine_similarity(logits[0][1], logits[1][1], dim=0)) >= 0.999


def test_windowed_rolling_reclamation(model):
    """A window-16 model generating 40 tokens from 10: its live pages stay
    within (sink + window) / page + JAX's slack, and its tokens are
    ``generate``'s on the same window."""
    cfg = TL.LLMConfig(**{**CFG.__dict__, "window_size": 16, "sink_size": 4})
    prompt = _prompts(1, seed=6, lo=10, hi=11)[0]
    eng = ServingEngine(model, cfg, ServingConfig(page_size=4, num_pages=24, max_batch=1, prefix_caching=False,
                                                  max_pages_per_seq=16))
    rid = eng.add_request(prompt, 40)
    live = []
    while not eng.finished:
        eng.step()
        live.append(24 - eng.stats()["free_pages"])  # the request's live pages
    assert max(live) <= (4 + 16) // 4 + 3
    assert eng.finished[rid] == TL.generate(model, torch.tensor([prompt]), 40, cfg)[0].tolist()


@pytest.mark.parametrize("opts,cfg_kw,match", [
    (dict(admission="eager"), {}, "admission"),
    (dict(admission="lazy"), dict(window_size=16), "sliding-window"),
    (dict(prefill_budget=0), {}, "positive"),
    (dict(prefill_budget=16, admission="lazy"), {}, "prefill_budget requires"),
    (dict(async_fetch=True, admission="lazy"), {}, "async_fetch requires"),
    (dict(async_fetch=True, spec_ngram=2), {}, "async_fetch excludes"),
    (dict(multi_step=4, admission="lazy"), {}, "multi_step requires"),
    (dict(multi_step=4, spec_ngram=2), {}, "exclusive"),
    (dict(spec_ngram=2, admission="lazy"), {}, "spec_ngram requires"),
    (dict(spec_ngram=2, spec_k=1), {}, "spec_k"),
    (dict(kv_bits=16), {}, "int8 or 4-bit pages"),
])
def test_validation_errors(model, opts, cfg_kw, match):
    cfg = TL.LLMConfig(**{**CFG.__dict__, **cfg_kw})
    with pytest.raises(ValueError, match=match):
        ServingEngine(model, cfg, ServingConfig(**opts))


def test_request_errors(model):
    eng = ServingEngine(model, CFG, ServingConfig(page_size=8, num_pages=4, max_batch=1, async_fetch=True))
    with pytest.raises(MemoryError, match="page-table width"):
        eng.add_request([1] * 30, 8)
    with pytest.raises(ValueError, match="eos_token"):
        eng.add_request([1, 2], 2, eos_token=3)
    with pytest.raises(ValueError, match="unknown rid"):
        eng.cancel_request(99)


def test_engine_imports_no_jax():
    code = ("import sys\nimport lowbit_quant_fa2_paddle_tpu_torch.serving\nimport lowbit_quant_fa2_paddle_tpu_torch.host\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'lowbit_quant_fa2_paddle_tpu')]\n"
            "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True, timeout=120)
