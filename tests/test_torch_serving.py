"""Port parity: the port's ``ServingEngine`` against the JAX package's, on
the trained checkpoint ``eval_out/arith_llm.npz`` (random weights give
argmax ties between the two sides' summation orders).

Both engines serve the same requests (arithmetic prompts, some sharing a
30-token prefix) under one ``ServingConfig`` and must give the same token
streams, request for request, and the same scheduler outcomes (prefix hits,
preemptions, speculative rounds):

* reserve admission with the prefix cache;
* lazy admission on a tight pool, with preemption and bit-exact resume;
* the budgeted chunked prefill (budget 16, pages of 8: three chunks a
  prompt, interleaved with decode ticks);
* n-gram speculation (spec_ngram 2, spec_k 4);
* 4-bit pages.

Each JAX run is made once, by a module-scoped fixture. The data plane is
also held directly: the JAX engine's paged pool and page table, mid-run,
carried into the port (``serving.paged_state_from_jax``), and one decode
tick and one 4-token verify tick of each side's step function on that same
pool give logits at cos >= 0.99999 and the same argmax.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lowbit_quant_fa2_paddle_tpu import serving as JS
from lowbit_quant_fa2_paddle_tpu.models import llm as JL
from lowbit_quant_fa2_paddle_tpu.models import train as JT
from lowbit_quant_fa2_paddle_tpu.utils.checkpoint import load_params
from lowbit_quant_fa2_paddle_tpu_torch import serving as TS
from lowbit_quant_fa2_paddle_tpu_torch.models import llm as TL
from lowbit_quant_fa2_paddle_tpu_torch.models import train as TT
from lowbit_quant_fa2_paddle_tpu_torch.ops.metrics import cosine_similarity
from lowbit_quant_fa2_paddle_tpu_torch.utils.checkpoint import load_params_npz

# One intra-op thread: the suite runs a worker per core, and torch's thread
# pool, spinning under that load, slowed small CPU ops up to 50-fold.
torch.set_num_threads(1)

CKPT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "eval_out", "arith_llm.npz")
#: The answer's 3 digits and ";": past it the model guesses the next fact's
#: random digits, where the two sides' orders may break near-ties apart.
MAX_NEW = TT.ANS_LEN
#: name: (ServingConfig options, requests): the runs both engines make.
RUNS = {
    "reserve-prefix": (dict(page_size=8, num_pages=64, max_batch=3), 6),
    # Three 36-token prompts fill 27 of 28 pages of 4; their first decode
    # tick needs three more.
    "lazy-preempt": (dict(page_size=4, num_pages=28, max_batch=3, admission="lazy", prefix_caching=False), 5),
    "budget": (dict(page_size=8, num_pages=48, max_batch=2, prefill_budget=16, prefix_caching=False), 4),
    "spec-ngram": (dict(page_size=8, num_pages=48, max_batch=2, spec_ngram=2, spec_k=4, prefix_caching=False), 4),
    "int4-pages": (dict(page_size=8, num_pages=48, max_batch=2, kv_bits=4, prefix_caching=False), 4),
}


def _prompts(n):
    """Arithmetic prompts of 36 tokens; the even ones share prompt 0's
    30-token few-shot prefix (three full pages of 8 hit the prefix cache)."""
    prompts, _ = TT.make_eval_prompts(n, seed=5)
    return [np.concatenate([prompts[0, :30], p[30:]]) if i % 2 == 0 else p for i, p in enumerate(prompts)]


@pytest.fixture(scope="module")
def models():
    like = JL.init_llm_params(__import__("jax").random.PRNGKey(0), JT.arith_llm_config())
    return load_params(CKPT, like), TL.params_from_jax(load_params_npz(CKPT), TT.arith_llm_config(), device="cpu")


def _serve(module, params, cfg, opts, n):
    eng = module.ServingEngine(params, cfg, module.ServingConfig(**opts))
    rids = [eng.add_request(p.tolist(), MAX_NEW) for p in _prompts(n)]
    out = eng.run()
    return [out[r] for r in rids], eng.stats(), eng


@pytest.fixture(scope="module")
def jax_runs(models):
    j_params, _ = models
    return {name: _serve(JS, j_params, JT.arith_llm_config(), opts, n)[:2] for name, (opts, n) in RUNS.items()}


@pytest.mark.parametrize("run", list(RUNS))
def test_engine_streams_equal_jax(models, jax_runs, run):
    opts, n = RUNS[run]
    j_out, j_stats = jax_runs[run]
    t_out, t_stats, eng = _serve(TS, models[1], TT.arith_llm_config(), opts, n)
    assert t_out == j_out
    assert all(len(t) == MAX_NEW for t in t_out)
    for key in ("preemptions", "prefix_hits", "prefix_misses", "cached_pages", "spec_rounds",
                "spec_tokens_per_round", "free_pages", "outstanding"):
        assert t_stats.get(key) == j_stats.get(key), key
    if run == "reserve-prefix":
        assert t_stats["prefix_hits"] > 0
    if run == "lazy-preempt":
        assert t_stats["preemptions"] > 0
    if run == "budget":
        assert eng.prefill_chunks == 3 * n  # 36 tokens in chunks of 16
    if run == "spec-ngram":
        assert t_stats["spec_rounds"] > 0
    # Every answer is the right sum: the streams are the model's, not noise.
    answers = TT.make_eval_prompts(n, seed=5)[1]
    sums = [TT.decode_ids(p[-6:]) for p in _prompts(n)]
    assert [TT.grade_answer(t, f"{int(s[:2]) + int(s[3:5]):03d}") for t, s in zip(t_out, sums)] == [True] * n
    assert len(answers) == n


@pytest.mark.parametrize("t", [1, 4])
def test_step_on_jax_paged_state_matches(models, t):
    """The JAX engine mid-run (three requests seated, their pages written)
    hands its pool and table to the port; one tick of each side's step
    function (T = 1: a decode tick; T = 4: a speculative verify tick) on
    that pool gives the same logits (cos >= 0.99999) and argmax, and writes
    the same codes into the pool's pages."""
    j_params, model = models
    cfg_j, cfg_t = JT.arith_llm_config(), TT.arith_llm_config()
    opts = dict(page_size=8, num_pages=32, max_batch=3, prefix_caching=False)
    eng = JS.ServingEngine(j_params, cfg_j, JS.ServingConfig(**opts))
    for p in _prompts(3):
        eng.add_request(p.tolist(), 12)
    for _ in range(3):
        eng.step()
    lengths = eng._lengths + t  # the rows this tick appends
    tokens = np.tile(eng._next_tok[:, None], (1, t)).astype(np.int32)
    caches_np = [{k: np.array(v) for k, v in c.items()} for c in eng.caches]
    t_caches, table = TS.paged_state_from_jax(caches_np, eng._table, device="cpu")
    assert all(torch.equal(tc[k][:, :-1], torch.from_numpy(c[k])) for tc, c in zip(t_caches, caches_np) for k in c)
    kw = dict(cfg=cfg_j, page_size=8, kv_bits=(8, 8), interpret=None)
    j_logits, j_caches = JS._spec_decode_step(j_params, eng.caches, jnp.asarray(tokens), jnp.asarray(lengths),
                                              jnp.asarray(eng._table), jnp.asarray(eng._active), **kw)
    with torch.no_grad():
        t_logits = TS._spec_decode_step(model, t_caches, torch.from_numpy(tokens), torch.from_numpy(lengths),
                                        table, torch.from_numpy(eng._active), cfg=cfg_t, page_size=8,
                                        kv_bits=(8, 8))
    j_logits = torch.from_numpy(np.array(j_logits))
    assert float(cosine_similarity(t_logits, j_logits)) >= 0.99999
    assert torch.equal(t_logits.argmax(-1), j_logits.argmax(-1))
    for tc, jc in zip(t_caches, j_caches):
        for k in ("k", "v"):
            assert torch.equal(tc[k][:, :-1], torch.from_numpy(np.array(jc[k]))), k
