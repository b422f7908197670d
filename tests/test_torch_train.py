"""Port parity: the toy LLM's training (``models/train.py``) against the JAX
package's, on the CPU.

* ``arith_stream_batch``: the same int32 tokens as JAX's for the same
  ``RandomState``;
* ``warmup_cosine_lr``: optax's ``warmup_cosine_decay_schedule`` (jitted, as
  JAX's training evaluates it) bit for bit at every count;
* 20 steps of ``train_steps`` from JAX's initial parameters (carried across
  by ``params_from_jax``) against ``train_toy_llm(steps=20, scan_chunk=1)``
  at batch 8 and 32 tokens: every step's loss within 1e-5 relative
  (measured on a CPU: 2.4e-7), and the parameters after the 20 steps within
  2e-6 of JAX's (an absolute bound: AdamW moves a parameter by at most ~lr
  = 1e-3 a step, and the f32 summation orders of the two sides' matmuls and
  reductions differ; measured 5.7e-7);
* ``eval_accuracy`` on the committed checkpoint ``eval_out/arith_llm.npz``
  (int8 cache) gives JAX's answers;
* inference records no autograd graph, and the port's own training run
  at JAX's test_llm_train recipe lowers the loss and learns the format.
"""

import os

import jax
import numpy as np
import optax
import pytest
import torch

from lowbit_quant_fa2_paddle_tpu.models import llm as JL
from lowbit_quant_fa2_paddle_tpu.models import train as JT
from lowbit_quant_fa2_paddle_tpu.utils.checkpoint import load_params
from lowbit_quant_fa2_paddle_tpu_torch.models import llm as TL
from lowbit_quant_fa2_paddle_tpu_torch.models import train as TT
from lowbit_quant_fa2_paddle_tpu_torch.utils.checkpoint import load_params_npz

# One intra-op thread: the suite runs a worker per core, and torch's thread
# pool, spinning under that load, slowed small CPU ops up to 50-fold.
torch.set_num_threads(1)

CKPT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "eval_out", "arith_llm.npz")
STEPS, BATCH, SEQ = 20, 8, 32
LOSS_RTOL, PARAM_ATOL = 1e-5, 2e-6


@pytest.mark.parametrize("seed,batch,seq_len", [(0, 4, 31), (1, 64, 64), (2, 3, 9), (3, 8, 32)])
def test_arith_stream_batch_equals_jax(seed, batch, seq_len):
    rng_t, rng_j = np.random.RandomState(seed), np.random.RandomState(seed)
    for _ in range(3):  # consecutive draws from one stream
        got, want = TT.arith_stream_batch(rng_t, batch, seq_len), JT.arith_stream_batch(rng_j, batch, seq_len)
        assert got.dtype == want.dtype == np.int32
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("steps", [20, 150, 3000])
def test_schedule_equals_optax(steps):
    """Every count of train_toy_llm's schedule (warm-up min(100, steps //
    10), decay over all the steps), the same f32 bits as optax's."""
    warmup = min(100, steps // 10)
    sched = optax.warmup_cosine_decay_schedule(0.0, 1e-3, warmup_steps=warmup, decay_steps=steps)
    counts = np.arange(steps + 1, dtype=np.int32)
    want = np.asarray(jax.jit(jax.vmap(sched))(counts))
    got = np.array([TT.warmup_cosine_lr(int(c), 1e-3, warmup, steps) for c in counts], np.float32)
    np.testing.assert_array_equal(got, want)
    assert got[0] == 0.0 and got[-1] == 0.0 and got.max() == np.float32(1e-3)


def test_schedule_without_warmup_starts_at_the_peak():
    sched = optax.warmup_cosine_decay_schedule(0.0, 1e-3, warmup_steps=0, decay_steps=7)
    got = [TT.warmup_cosine_lr(c, 1e-3, 0, 7) for c in range(8)]
    assert got[0] == np.float32(1e-3)
    np.testing.assert_array_equal(np.array(got, np.float32), np.asarray(jax.jit(jax.vmap(sched))(np.arange(8))))


@pytest.fixture(scope="module")
def jax_training():
    """JAX's 20 steps (one a chunk, so every step's loss) and its initial
    parameters."""
    cfg = JT.arith_llm_config()
    init = JL.init_llm_params(jax.random.PRNGKey(0), cfg)
    params, losses = JT.train_toy_llm(cfg, steps=STEPS, batch=BATCH, seq_len=SEQ, scan_chunk=1)
    tree = lambda p: jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), p)  # noqa: E731
    return tree(init), tree(params), losses


def test_train_steps_match_jax(jax_training):
    init, want, losses_j = jax_training
    cfg = TT.arith_llm_config()
    model = TL.params_from_jax(init, cfg, device="cpu")
    losses = TT.train_steps(model, cfg, steps=STEPS, batch=BATCH, seq_len=SEQ, scan_chunk=1)
    assert len(losses) == STEPS
    np.testing.assert_allclose(losses, losses_j, rtol=LOSS_RTOL, atol=0)
    got = TL.params_to_jax(model)
    for a, b in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want)):
        np.testing.assert_allclose(a, b, rtol=0, atol=PARAM_ATOL)
    assert not any(p.requires_grad for p in model.parameters())  # restored after training


def test_first_adamw_update_is_zero():
    """optax takes the schedule at the count before the update: a warm-up
    from 0 makes the first update exactly zero, weight decay included."""
    p = [torch.randn(5, 3), torch.randn(7)]
    before = [x.clone() for x in p]
    opt = TT.AdamW(p, lambda c: TT.warmup_cosine_lr(c, 1e-3, 10, 100))
    for count, changes in ((0, False), (1, True)):
        opt.scalars.copy_(torch.tensor(opt.scalars_at(count)))
        opt.update([torch.randn_like(x) for x in p])
        assert all(torch.equal(a, b) != changes for a, b in zip(p, before)), count


def test_eval_accuracy_on_the_checkpoint_matches_jax():
    """Batched greedy answers through the int8 cache: JAX's answers and
    accuracy on 16 held-out prompts."""
    cfg_j = JT.arith_llm_config()
    j_params = load_params(CKPT, JL.init_llm_params(jax.random.PRNGKey(0), cfg_j))
    prompts, answers = TT.make_eval_prompts(16)
    acc_j, preds_j = JT.eval_accuracy(j_params, cfg_j, prompts, answers, batch=16)
    cfg = TT.arith_llm_config()
    model = TL.params_from_jax(load_params_npz(CKPT), cfg, device="cpu")
    acc, preds = TT.eval_accuracy(model, cfg, prompts, answers, batch=8)
    assert preds == preds_j and acc == acc_j == 1.0


def test_inference_records_no_graph():
    """With every parameter asking for gradients, ``llm_prefill`` and
    ``generate`` record no graph; ``llm_logits`` does, and its gradients
    reach every parameter."""
    cfg = TT.arith_llm_config(dim=64, depth=1, num_heads=4, num_kv_heads=2)
    model = TL.init_llm_params(cfg, torch.Generator().manual_seed(0), device="cpu").requires_grad_(True)
    toks = torch.from_numpy(TT.make_eval_prompts(2, few_shot=1)[0]).long()
    logits, caches = TL.llm_prefill(model, toks, cfg)
    assert not logits.requires_grad and not any(c["k"].requires_grad for c in caches)
    out = TL.generate(model, toks, TT.ANS_LEN, cfg)
    assert out.shape == (2, TT.ANS_LEN) and not out.requires_grad
    trained = TL.llm_logits(model, toks, cfg)
    torch.testing.assert_close(trained, TL.llm_prefill(model, toks, cfg, attn_impl="ref")[0], rtol=0, atol=0)
    grads = torch.autograd.grad(trained.sum(), list(model.parameters()))
    assert all(g is not None and bool(torch.isfinite(g).all()) for g in grads)


def test_training_reduces_loss_and_learns_format():
    """JAX's tests/test_llm_train.py recipe on the port: dim 64, depth 2,
    150 steps at batch 32, lr 2e-3; the loss falls below 0.8x its first
    chunk's and every answer is three digits."""
    cfg = TT.arith_llm_config(dim=64, depth=2, num_heads=4, num_kv_heads=2)
    params, losses = TT.train_toy_llm(cfg, steps=150, batch=32, seq_len=31, scan_chunk=50, lr=2e-3, device="cpu")
    assert len(losses) == 3 and losses[-1] < losses[0] * 0.8, losses
    prompts, answers = TT.make_eval_prompts(8, few_shot=2)
    _, preds = TT.eval_accuracy(params, cfg, prompts, answers, batch=8)
    assert all(len(p) == 3 and p.isdigit() for p in preds), preds
