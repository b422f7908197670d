"""Port parity: the LLM of the PyTorch package against the JAX package.

Two models, both carried across with ``params_from_jax``:

* a tiny random bf16 model (dim 256, depth 2, 8 query heads, 2 KV heads,
  head dim 32) from the JAX package's own init. Both sides round every dense
  layer to bf16, in different places, so logits and cache values are held
  by cosine: >= 0.9999 (measured on a CPU: logits 0.99996 for int8 prefill,
  0.99998 for ref; cache values >= 0.99995; decode-step logits >= 0.99996).
  Layer 0's cache codes are equal (nothing before them differs); deeper
  layers' codes differ where the bf16 activations do (measured: 22-34% of
  layer 1's codes, by at most 3), which the test reports;
* the trained arithmetic checkpoint ``eval_out/arith_llm.npz`` (f32), whose
  logits have real margins: greedy ``generate`` must give the same tokens as
  JAX, with the int8, bf16, int4 and k4v8 caches, and with per-channel w8
  and w4 weights (``quantize_llm_params``, bit-equal to JAX's packing).

4-bit caches step their codes by a seventh of the row maximum, so where the
two sides' bf16 activations differ a flipped code moves a value by far more
than at 8 bits: their decode-step logits are held at cos >= 0.999 (measured
on a CPU: int4 0.99982, k4v8 0.99991). ``llm_prefill_chunked`` is held to
JAX's own bounds against the one-shot prefill (tests/test_llm.py): cache K
rows cos >= 0.999 (0.99 for 4-bit K), last-token logits >= 0.999 (0.995),
both against JAX's chunked prefill and against the port's one-shot one
(measured: k4v8 K rows 0.99320 and logits 0.99736 against the one-shot;
>= 0.99906 against JAX's).

Every model is built on the CPU (``device="cpu"``): the constructors default
to the CUDA card.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lowbit_quant_fa2_paddle_tpu.models import llm as JL
from lowbit_quant_fa2_paddle_tpu.models import train as JT
from lowbit_quant_fa2_paddle_tpu.ops import decode as jd
from lowbit_quant_fa2_paddle_tpu.utils.checkpoint import load_params
from lowbit_quant_fa2_paddle_tpu_torch.models import llm as TL
from lowbit_quant_fa2_paddle_tpu_torch.models import train as TT
from lowbit_quant_fa2_paddle_tpu_torch.ops import decode as td
from lowbit_quant_fa2_paddle_tpu_torch.ops.metrics import cosine_similarity
from lowbit_quant_fa2_paddle_tpu_torch.utils.checkpoint import load_params_npz

# One intra-op thread: the suite runs a worker per core, and torch's thread
# pool, spinning under that load, slowed small CPU ops up to 50-fold.
torch.set_num_threads(1)

CKPT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "eval_out", "arith_llm.npz")
COS_MIN = 0.9999
TINY = dict(dim=256, depth=2, num_heads=8, num_kv_heads=2, max_seq=64)
#: Cache modes by their LLMConfig fields.
CACHES = {"int8": dict(kv_bits=8), "bf16": dict(kv_bits=16), "int4": dict(kv_bits=4), "k4v8": dict(kv_bits=8, k_bits=4)}
COS_4BIT = 0.999


def _f32(x) -> np.ndarray:
    return np.array(jnp.asarray(x).astype(jnp.float32))


def _cos(port: torch.Tensor, want) -> float:
    return float(cosine_similarity(port.float(), torch.from_numpy(_f32(want))))


@pytest.fixture(scope="module")
def tiny():
    params = JL.init_llm_params(jax.random.PRNGKey(0), JL.tiny_llm_config(**TINY, dtype=jnp.bfloat16))
    tree = jax.tree_util.tree_map(_f32, params)
    model = TL.params_from_jax(tree, TL.tiny_llm_config(**TINY, dtype=torch.bfloat16), device="cpu")
    tokens = np.random.default_rng(0).integers(0, 256, (2, 40)).astype(np.int32)
    return params, tree, model, tokens


def _cfgs(**kw):
    return JL.tiny_llm_config(**TINY, dtype=jnp.bfloat16, **kw), TL.tiny_llm_config(**TINY, dtype=torch.bfloat16, **kw)


def test_params_from_jax_puts_each_weight_where_jax_has_it(tiny):
    _, tree, model, _ = tiny
    for i, blk in enumerate(model.blocks):
        for key in ("wq", "wk", "wv", "wo", "w1", "w2"):
            w = getattr(blk, key).weight
            assert w.dtype == torch.bfloat16 and not w.requires_grad
            assert torch.equal(w.float(), torch.from_numpy(tree["blocks"][i][key].T.copy())), (i, key)
        assert torch.equal(blk.ln1.weight.float(), torch.from_numpy(tree["blocks"][i]["ln1"]))
    assert torch.equal(model.embed.weight.float(), torch.from_numpy(tree["embed"]))
    assert tuple(model.blocks[0].wk.weight.shape) == (2 * 32, 256)  # nn.Linear is [out, in]


@pytest.mark.parametrize("impl", ["int8", "ref"])
def test_prefill_matches_jax(tiny, impl):
    params, _, model, tokens = tiny
    cfg_j, cfg_t = _cfgs()
    j_logits, j_caches = JL.llm_prefill(params, jnp.asarray(tokens), cfg_j, attn_impl=impl)
    t_logits, t_caches = TL.llm_prefill(model, torch.from_numpy(tokens), cfg_t, attn_impl=impl)
    assert t_logits.shape == (2, 40, 256) and torch.isfinite(t_logits.float()).all()
    assert _cos(t_logits, j_logits) >= COS_MIN
    s = tokens.shape[1]
    shares = []
    for li, (jc, tc) in enumerate(zip(j_caches, t_caches)):
        assert tc["length"].tolist() == [s, s]
        for side in ("k", "v"):
            codes, scale = tc[side], tc[f"{side}_scale"]
            assert codes.dtype == torch.int8 and codes.shape == (2, 2, 64, 32)
            j_codes, j_scale = np.asarray(jc[side]), np.asarray(jc[f"{side}_scale"])
            values = codes.float() * scale[..., None]
            assert _cos(values, j_codes.astype(np.float32) * j_scale[..., None]) >= COS_MIN
            assert not codes[:, :, s:].any() and bool((scale[:, :, s:] == 1).all())
            shares.append(float((codes.numpy()[:, :, :s] != j_codes[:, :, :s]).mean()))
            if li == 0:
                np.testing.assert_array_equal(codes.numpy(), j_codes)
                # JAX's eager prefill rounds the scale with two roundings, the
                # port (and JAX under jit) with one fma: at most one ulp apart.
                assert np.abs(scale.numpy().view(np.int32) - j_scale.view(np.int32)).max() <= 1
    print(f"share of cache codes that differ from JAX, per layer and side: {shares}")
    assert max(shares) < 0.5


@pytest.mark.parametrize("bits", [8, 16])
def test_decode_steps_match_jax(tiny, bits):
    params, _, model, tokens = tiny
    cfg_j, cfg_t = _cfgs(kv_bits=bits)
    # The exact prefill (fast in JAX's interpret mode); the steps run kernel D.
    _, j_caches = JL.llm_prefill(params, jnp.asarray(tokens), cfg_j, attn_impl="ref")
    _, t_caches = TL.llm_prefill(model, torch.from_numpy(tokens), cfg_t, attn_impl="ref")
    feed = np.random.default_rng(1).integers(0, 256, (8, 2)).astype(np.int32)
    step = jax.jit(lambda p, t, c: JL.llm_decode_step(p, t, c, cfg_j))
    for i in range(8):
        j_logits, j_caches = step(params, jnp.asarray(feed[i]), j_caches)
        t_logits, t_caches = TL.llm_decode_step(model, torch.from_numpy(feed[i]), t_caches, cfg_t)
        assert _cos(t_logits, j_logits) >= COS_MIN, i
    assert t_caches[0]["length"].tolist() == [48, 48]
    assert t_caches[1]["k"].dtype == (torch.int8 if bits == 8 else torch.bfloat16)


def test_decode_tokens_equals_stepping(tiny):
    _, _, model, tokens = tiny
    _, cfg = _cfgs()
    logits, caches = TL.llm_prefill(model, torch.from_numpy(tokens), cfg)
    copy = [{k: v.clone() for k, v in c.items()} for c in caches]
    tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
    got, _ = TL.decode_tokens(model, tok, caches, 5, cfg)
    want = []
    for _ in range(5):
        step_logits, copy = TL.llm_decode_step(model, tok, copy, cfg)
        tok = torch.argmax(step_logits, dim=-1).to(torch.int32)
        want.append(tok)
    assert got.dtype == torch.int32 and got.shape == (2, 5)
    assert torch.equal(got, torch.stack(want, dim=1))


def test_generate_one_token_is_the_prefill_argmax(tiny):
    _, _, model, tokens = tiny
    _, cfg = _cfgs()
    out = TL.generate(model, torch.from_numpy(tokens), 1, cfg)
    logits, _ = TL.llm_prefill(model, torch.from_numpy(tokens), cfg)
    assert torch.equal(out[:, 0], torch.argmax(logits[:, -1], dim=-1).to(torch.int32))


def test_rollback_caches_sets_lengths_only(tiny):
    _, _, model, tokens = tiny
    _, cfg = _cfgs()
    _, caches = TL.llm_prefill(model, torch.from_numpy(tokens), cfg)
    buffers = [c["length"] for c in caches]
    back = TL.rollback_caches(caches, torch.tensor([3, 5], dtype=torch.int32))
    assert all(c["length"].tolist() == [3, 5] for c in back)
    assert all(b["k"] is c["k"] for b, c in zip(back, caches))
    # In place: each cache keeps its own length buffer (a captured decode step replays on it).
    assert back is caches and all(c["length"] is buf for c, buf in zip(caches, buffers))


@pytest.fixture(scope="module")
def checkpoint():
    like = JL.init_llm_params(jax.random.PRNGKey(0), JT.arith_llm_config())
    j_params = load_params(CKPT, like)
    tree = load_params_npz(CKPT)
    return j_params, tree, TL.params_from_jax(tree, TT.arith_llm_config(), device="cpu")


def test_load_params_npz_matches_jax_load(checkpoint):
    j_params, tree, _ = checkpoint
    leaves_j, struct_j = jax.tree_util.tree_flatten(j_params)
    leaves_t, struct_t = jax.tree_util.tree_flatten(tree)
    assert struct_t == struct_j
    for a, b in zip(leaves_j, leaves_t):
        np.testing.assert_array_equal(np.asarray(a), b)


@pytest.mark.parametrize("bits", [8, 16])
def test_checkpoint_generate_is_token_identical_to_jax(checkpoint, bits):
    j_params, _, model = checkpoint
    prompts, answers = TT.make_eval_prompts(16)
    j_out = np.asarray(JL.generate(j_params, jnp.asarray(prompts), TT.ANS_LEN, JT.arith_llm_config(kv_bits=bits)))
    t_out = TL.generate(model, torch.from_numpy(prompts), TT.ANS_LEN, TT.arith_llm_config(kv_bits=bits))
    assert t_out.dtype == torch.int32
    np.testing.assert_array_equal(t_out.numpy(), j_out)
    assert np.mean([TT.grade_answer(row, a) for row, a in zip(t_out.numpy(), answers)]) == 1.0


@pytest.mark.parametrize("n,few_shot,seed", [(16, 3, 123), (64, 3, 123), (5, 0, 7), (9, 5, 1)])
def test_make_eval_prompts_equals_jax(n, few_shot, seed):
    tp, ta = TT.make_eval_prompts(n, few_shot=few_shot, seed=seed)
    jp, ja = JT.make_eval_prompts(n, few_shot=few_shot, seed=seed)
    np.testing.assert_array_equal(tp, jp)
    assert tp.dtype == jp.dtype and ta == ja


def test_task_alphabet_matches_jax():
    assert (TT.CHARS, TT.VOCAB, TT.EOS) == (JT.CHARS, JT.VOCAB, JT.EOS)
    s = TT.fact(7, 42) + TT.fact(99, 99)
    assert s == JT.fact(7, 42) + JT.fact(99, 99) == "07+42=049;99+99=198;"
    assert TT.encode(s) == JT.encode(s) and TT.decode_ids(TT.encode(s)) == s


def test_unknown_prefill_impl_raises(tiny):
    _, _, model, tokens = tiny
    with pytest.raises(ValueError, match="attn_impl"):
        TL.llm_prefill(model, torch.from_numpy(tokens), _cfgs()[1], attn_impl="int4")


def test_init_llm_params_shapes_and_scale():
    cfg = TL.tiny_llm_config(dim=128, depth=1, num_heads=4, num_kv_heads=2, vocab=32)
    model = TL.init_llm_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    n = sum(p.numel() for p in model.parameters())
    assert n == 32 * 128 + 128 + 128 * 128 * 2 + 2 * 128 * 64 + 2 * 4 * 128 * 128 + 2 * 128
    w1 = model.blocks[0].w1.weight
    assert abs(float(w1.std()) - 128**-0.5) < 0.01
    assert torch.equal(model.ln_f.weight, torch.ones(128))


@pytest.mark.parametrize("bits", [8, 16])
def test_merge_lse_of_two_key_halves_equals_one_decode(bits):
    """Decode over keys [0, 150) and [150, 300) separately, merged through
    their base-2 LSEs, equals one decode over all 300 keys."""
    rng = np.random.default_rng(7)
    k = torch.from_numpy(rng.standard_normal((2, 2, 300, 32)).astype(np.float32))
    v = torch.from_numpy(rng.standard_normal((2, 2, 300, 32)).astype(np.float32))
    q = torch.from_numpy(rng.standard_normal((2, 8, 32)).astype(np.float32))
    (kq, ks), (vq, vs) = td.quantize_token(k, bits=bits), td.quantize_token(v, bits=bits)

    def run(lo, hi):
        n = torch.full((2,), hi - lo, dtype=torch.int32)
        return td.decode_attention(q, kq[:, :, lo:hi].contiguous(), vq[:, :, lo:hi].contiguous(),
                                   ks[:, :, lo:hi].contiguous(), n, v_scale=vs[:, :, lo:hi].contiguous(),
                                   kv_bits=bits, return_lse=True)

    (o1, l1), (o2, l2), (o, _) = run(0, 150), run(150, 300), run(0, 300)
    torch.testing.assert_close(TL.merge_lse(o1, l1, o2, l2), o, rtol=0, atol=2e-6)


# ---------------------------------------------------------------------------
# Weight-quantized models (kernels F1/F2)
# ---------------------------------------------------------------------------

KEYS = ("wq", "wk", "wv", "wo", "w1", "w2")


@pytest.fixture(scope="module")
def tiny_packed(tiny):
    params, _, model, _ = tiny
    return {bits: (JL.quantize_llm_params(params, bits=bits), TL.quantize_llm_params(model, bits=bits))
            for bits in (8, 4)}


@pytest.mark.parametrize("bits", [8, 4])
def test_quantize_llm_params_bit_exact_and_shares_the_rest(tiny, tiny_packed, bits):
    _, _, model, _ = tiny
    jq, tq = tiny_packed[bits]
    for i, blk in enumerate(tq.blocks):
        for key in KEYS:
            w = getattr(blk, key)
            assert w.bits == bits and not isinstance(getattr(model.blocks[i], key), type(w))
            np.testing.assert_array_equal(w.packed.numpy(), np.asarray(jq["blocks"][i][key].packed))
            np.testing.assert_array_equal(w.scale.numpy(), np.asarray(jq["blocks"][i][key].scale))
        assert blk.ln1 is model.blocks[i].ln1 and blk.ln2 is model.blocks[i].ln2
    assert tq.embed is model.embed and tq.ln_f is model.ln_f and tq.cfg is model.cfg
    assert not any(b.wq.weight.requires_grad for b in model.blocks)  # the dense model is untouched


@pytest.mark.parametrize("bits,cos_min", [(8, COS_MIN), (4, 0.995)])
def test_packed_prefill_and_decode_match_jax(tiny, tiny_packed, bits, cos_min):
    """Prefill (80 rows) and decode (2 rows) both run the packed matmul.
    w4's dot carries 7·scale·sum(x) and is rounded to bf16 before the
    zero-point term takes it out again (JAX's design, kept), so a
    summation-order flip there moves y by an ulp of the larger dot: the
    bound is 0.995 (measured on a CPU: 0.99778-0.99849; JAX's own w4 logits
    against its dense weights 0.952; w8 0.99997)."""
    _, _, _, tokens = tiny
    jq, tq = tiny_packed[bits]
    cfg_j, cfg_t = _cfgs()
    j_logits, j_caches = JL.llm_prefill(jq, jnp.asarray(tokens), cfg_j, attn_impl="ref")
    t_logits, t_caches = TL.llm_prefill(tq, torch.from_numpy(tokens), cfg_t, attn_impl="ref")
    assert _cos(t_logits, j_logits) >= cos_min
    feed = np.random.default_rng(2).integers(0, 256, (3, 2)).astype(np.int32)
    step = jax.jit(lambda p, t, c: JL.llm_decode_step(p, t, c, cfg_j))
    for i in range(3):
        j_logits, j_caches = step(jq, jnp.asarray(feed[i]), j_caches)
        t_logits, t_caches = TL.llm_decode_step(tq, torch.from_numpy(feed[i]), t_caches, cfg_t)
        assert _cos(t_logits, j_logits) >= cos_min, i


@pytest.mark.parametrize("bits", [8, 4])
def test_params_from_jax_loads_a_quantized_tree(tiny, tiny_packed, bits):
    _, _, _, tokens = tiny
    jq, tq = tiny_packed[bits]
    tree = jax.tree_util.tree_map(np.asarray, jq)  # WQWeight nodes holding numpy arrays
    loaded = TL.params_from_jax(tree, _cfgs()[1], device="cpu")
    for a, b in zip(loaded.blocks, tq.blocks):
        for key in KEYS:
            assert torch.equal(getattr(a, key).packed, getattr(b, key).packed)
            assert torch.equal(getattr(a, key).scale, getattr(b, key).scale)
    toks = torch.from_numpy(tokens[:, :9])
    assert torch.equal(TL.llm_prefill(loaded, toks, _cfgs()[1])[0], TL.llm_prefill(tq, toks, _cfgs()[1])[0])


def test_w_bits_is_accepted_and_read_by_nothing():
    assert TL.LLMConfig(w_bits=8).w_bits == 8


@pytest.mark.parametrize("bits", [8, 4])
def test_checkpoint_packed_generate_is_token_identical_to_jax(checkpoint, bits):
    """16 prompts x 36 tokens: the prefill (576 rows) and the decode steps
    both run the packed matmul."""
    j_params, _, model = checkpoint
    prompts, answers = TT.make_eval_prompts(16)
    cfg_j, cfg_t = JT.arith_llm_config(kv_bits=8), TT.arith_llm_config(kv_bits=8)
    j_out = np.asarray(JL.generate(JL.quantize_llm_params(j_params, bits=bits), jnp.asarray(prompts), TT.ANS_LEN,
                                   cfg_j))
    t_out = TL.generate(TL.quantize_llm_params(model, bits=bits), torch.from_numpy(prompts), TT.ANS_LEN, cfg_t)
    np.testing.assert_array_equal(t_out.numpy(), j_out)
    assert np.mean([TT.grade_answer(row, a) for row, a in zip(t_out.numpy(), answers)]) >= 0.9375


# ---------------------------------------------------------------------------
# 4-bit caches, chunked prefill, the decode loop
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["int4", "k4v8"])
def test_config_takes_4bit_caches(mode):
    cfg = TL.tiny_llm_config(**CACHES[mode])
    assert (cfg.eff_k_bits, cfg.eff_v_bits) == ((4, 4) if mode == "int4" else (4, 8))
    with pytest.raises(ValueError, match="16, 8 or 4"):
        TL.LLMConfig(kv_bits=2)


def _values(cache, side, bits, n=None):
    codes, scale = cache[side][:, :, :n], cache[f"{side}_scale"][:, :, :n]
    return TL._dequant_cache_rows(codes, scale, bits, torch.float32)


def _jax_values(cache, side, bits, n=None):
    return np.asarray(JL._dequant_cache_rows(cache[side][:, :, :n], cache[f"{side}_scale"][:, :, :n], bits,
                                             jnp.float32))


@pytest.mark.parametrize("bits", [16, 8, 4])
def test_dequant_cache_rows_matches_jax(bits):
    rng = np.random.default_rng(bits)
    x = (rng.standard_normal((2, 2, 9, 64)) * 2).astype(np.float32)
    jq, js = jax.jit(lambda a: jd.quantize_token(a, bits=bits))(jnp.asarray(x))
    got = TL._dequant_cache_rows(torch.from_numpy(_f32(jq)).to(torch.bfloat16 if bits == 16 else torch.int8),
                                 torch.from_numpy(np.array(js)), bits, torch.float32)
    np.testing.assert_array_equal(got.numpy(), np.asarray(JL._dequant_cache_rows(jq, js, bits, jnp.float32)))


@pytest.mark.parametrize("mode", ["int4", "k4v8"])
def test_prefill_4bit_caches_match_jax(tiny, mode):
    """The one-shot prefill builds packed ``[B, Hk, S_max, D/2]`` 4-bit
    sides: layer 0's codes equal JAX's, deeper layers' values by cosine."""
    params, _, model, tokens = tiny
    cfg_j, cfg_t = _cfgs(**CACHES[mode])
    j_logits, j_caches = JL.llm_prefill(params, jnp.asarray(tokens), cfg_j)
    t_logits, t_caches = TL.llm_prefill(model, torch.from_numpy(tokens), cfg_t)
    assert _cos(t_logits, j_logits) >= COS_MIN
    for li, (jc, tc) in enumerate(zip(j_caches, t_caches)):
        for side, bits in (("k", cfg_t.eff_k_bits), ("v", cfg_t.eff_v_bits)):
            width = 16 if bits == 4 else 32
            assert tc[side].dtype == torch.int8 and tc[side].shape == (2, 2, 64, width)
            assert _cos(_values(tc, side, bits), _jax_values(jc, side, bits)) >= COS_4BIT
            if li == 0:
                np.testing.assert_array_equal(tc[side].numpy(), np.asarray(jc[side]))


@pytest.mark.parametrize("mode", ["int4", "k4v8"])
def test_decode_steps_4bit_match_jax(tiny, mode):
    """Eight steps through kernel D's 4-bit modes (the float QK chain that
    "auto" takes at 4-bit K) from the exact prefill's caches."""
    params, _, model, tokens = tiny
    cfg_j, cfg_t = _cfgs(**CACHES[mode])
    _, j_caches = JL.llm_prefill(params, jnp.asarray(tokens), cfg_j, attn_impl="ref")
    _, t_caches = TL.llm_prefill(model, torch.from_numpy(tokens), cfg_t, attn_impl="ref")
    feed = np.random.default_rng(1).integers(0, 256, (8, 2)).astype(np.int32)
    step = jax.jit(lambda p, t, c: JL.llm_decode_step(p, t, c, cfg_j))
    worst = 1.0
    for i in range(8):
        j_logits, j_caches = step(params, jnp.asarray(feed[i]), j_caches)
        t_logits, t_caches = TL.llm_decode_step(model, torch.from_numpy(feed[i]), t_caches, cfg_t)
        worst = min(worst, _cos(t_logits, j_logits))
    print(f"{mode}: worst decode-step logits cos {worst:.6f}")
    assert worst >= COS_4BIT
    assert t_caches[0]["length"].tolist() == [48, 48]


CHUNKED = dict(dim=256, depth=2, num_heads=8, num_kv_heads=2, max_seq=96)


def _chunked_cfgs(mode):
    return (JL.tiny_llm_config(**CHUNKED, dtype=jnp.bfloat16, **CACHES[mode]),
            TL.tiny_llm_config(**CHUNKED, dtype=torch.bfloat16, **CACHES[mode]))


def _bounds(cfg):
    """JAX's own bounds (tests/test_llm.py): K rows, last-token logits."""
    return (0.99, 0.995) if cfg.eff_k_bits == 4 else (0.999, 0.999)


@pytest.mark.parametrize("mode", ["int8", "bf16", "k4v8"])
def test_chunked_prefill_matches_jax(tiny, mode):
    """Chunks of 16 over a 40-token prompt (three chunks, the last short),
    as JAX's test runs it: the same lengths, dequantized K rows and the
    last-token logits against JAX's chunked prefill."""
    params, _, model, tokens = tiny
    cfg_j, cfg_t = _chunked_cfgs(mode)
    j_logits, j_caches = JL.llm_prefill_chunked(params, jnp.asarray(tokens), cfg_j, chunk=16)
    t_logits, t_caches = TL.llm_prefill_chunked(model, torch.from_numpy(tokens), cfg_t, chunk=16)
    k_min, logits_min = _bounds(cfg_t)
    assert t_logits.shape == (2, 256) and torch.isfinite(t_logits.float()).all()
    assert _cos(t_logits, j_logits) >= logits_min
    for jc, tc in zip(j_caches, t_caches):
        assert tc["length"].tolist() == np.asarray(jc["length"]).tolist() == [40, 40]
        assert _cos(_values(tc, "k", cfg_t.eff_k_bits, 40), _jax_values(jc, "k", cfg_j.eff_k_bits, 40)) >= k_min
        assert _cos(_values(tc, "v", cfg_t.eff_v_bits, 40), _jax_values(jc, "v", cfg_j.eff_v_bits, 40)) >= k_min
        assert not tc["k"][:, :, 40:].any() and bool((tc["k_scale"][:, :, 40:] == 1).all())


@pytest.mark.parametrize("mode", ["int8", "bf16", "k4v8"])
def test_chunked_prefill_matches_one_shot(tiny, mode):
    """The port's chunked prefill against its own one-shot prefill, at JAX's
    bounds; greedy decoding goes on alike from either cache."""
    _, _, model, tokens = tiny
    _, cfg = _chunked_cfgs(mode)
    full_logits, full_caches = TL.llm_prefill(model, torch.from_numpy(tokens), cfg)
    logits, caches = TL.llm_prefill_chunked(model, torch.from_numpy(tokens), cfg, chunk=16)
    k_min, logits_min = _bounds(cfg)
    for cf, cc in zip(full_caches, caches):
        assert cc["length"].tolist() == [40, 40]
        assert float(cosine_similarity(_values(cc, "k", cfg.eff_k_bits, 40), _values(cf, "k", cfg.eff_k_bits, 40))) >= k_min
    assert float(cosine_similarity(logits.float(), full_logits[:, -1].float())) >= logits_min
    toks_full, _ = TL.decode_tokens(model, torch.argmax(full_logits[:, -1], -1), full_caches, 4, cfg)
    toks, _ = TL.decode_tokens(model, torch.argmax(logits, -1), caches, 4, cfg)
    assert float((toks_full == toks).float().mean()) >= 0.75


#: Head dim 64: the cross-attention over a 4-bit K cache takes kernel A's
#: packed-INT4 mode (at head dim 32 it unpacks the codes to int8).
CHUNKED_D64 = dict(dim=256, depth=2, num_heads=4, num_kv_heads=2, max_seq=96)


@pytest.fixture(scope="module")
def tiny_d64():
    params = JL.init_llm_params(jax.random.PRNGKey(0), JL.tiny_llm_config(**CHUNKED_D64, dtype=jnp.bfloat16))
    model = TL.params_from_jax(jax.tree_util.tree_map(_f32, params),
                               TL.tiny_llm_config(**CHUNKED_D64, dtype=torch.bfloat16), device="cpu")
    return params, model


def _packed_k_chunked(model, tokens, cfg, monkeypatch):
    """The port's chunked prefill (chunks of 16), with the K packing of
    every kernel A call it makes."""
    packs = []

    def spy(*args, **kw):
        packs.append(kw.get("k_pack_bits", 8))
        return real(*args, **kw)

    real = TL.lowbit_attention
    monkeypatch.setattr(TL, "lowbit_attention", spy)
    out = TL.llm_prefill_chunked(model, torch.from_numpy(tokens), cfg, chunk=16)
    monkeypatch.setattr(TL, "lowbit_attention", real)
    # Per layer: one causal call a chunk (int8 K) and one over the packed cache for chunks 2 and 3.
    assert sorted(packs) == [4] * 4 + [8] * 6
    return out


@pytest.mark.parametrize("mode", ["int4", "k4v8"])
def test_chunked_prefill_packed_k_matches_jax(tiny, tiny_d64, mode, monkeypatch):
    """Head dim 64, 4-bit K: the cross-attention runs kernel A's packed-INT4
    mode on the cache's own nibbles; against JAX's chunked prefill at its
    bounds (the same lengths, K and V rows, last-token logits)."""
    params, model = tiny_d64
    tokens = tiny[3]
    cfg_j = JL.tiny_llm_config(**CHUNKED_D64, dtype=jnp.bfloat16, **CACHES[mode])
    cfg_t = TL.tiny_llm_config(**CHUNKED_D64, dtype=torch.bfloat16, **CACHES[mode])
    assert cfg_t.head_dim == 64
    j_logits, j_caches = JL.llm_prefill_chunked(params, jnp.asarray(tokens), cfg_j, chunk=16)
    t_logits, t_caches = _packed_k_chunked(model, tokens, cfg_t, monkeypatch)
    k_min, logits_min = _bounds(cfg_t)
    assert t_logits.shape == (2, 256) and torch.isfinite(t_logits.float()).all()
    assert _cos(t_logits, j_logits) >= logits_min
    for jc, tc in zip(j_caches, t_caches):
        assert tc["length"].tolist() == np.asarray(jc["length"]).tolist() == [40, 40]
        assert tc["k"].shape == (2, 2, 96, 32)
        assert _cos(_values(tc, "k", 4, 40), _jax_values(jc, "k", 4, 40)) >= k_min
        assert _cos(_values(tc, "v", cfg_t.eff_v_bits, 40), _jax_values(jc, "v", cfg_j.eff_v_bits, 40)) >= k_min
    # Reported, not bounded: each package's chunked prefill against its own
    # one-shot one (the worst layer's K rows, the last-token logits).
    jf_logits, jf_caches = JL.llm_prefill(params, jnp.asarray(tokens), cfg_j)
    tf_logits, tf_caches = TL.llm_prefill(model, torch.from_numpy(tokens), cfg_t)
    j_k = min(_cos(torch.tensor(_jax_values(a, "k", 4, 40)), _jax_values(f, "k", 4, 40))
              for a, f in zip(j_caches, jf_caches))
    t_k = min(float(cosine_similarity(_values(a, "k", 4, 40), _values(f, "k", 4, 40)))
              for a, f in zip(t_caches, tf_caches))
    j_l = _cos(torch.tensor(_f32(j_logits)), jf_logits[:, -1])
    t_l = float(cosine_similarity(t_logits.float(), tf_logits[:, -1].float()))
    print(f"{mode} chunked vs one-shot: K rows JAX {j_k:.5f} port {t_k:.5f}; logits JAX {j_l:.5f} port {t_l:.5f}")


@pytest.mark.parametrize("mode", ["k4v8"])
def test_chunked_prefill_packed_k_matches_one_shot(tiny, tiny_d64, mode, monkeypatch):
    """The same against the port's own one-shot prefill, at JAX's bounds,
    which JAX's test sets for k4v8. The int4 cache is held to JAX's chunked
    prefill only: its cross-attention reads 4-bit V, and JAX's own chunked
    prefill stays below these bounds there (printed by
    ``test_chunked_prefill_packed_k_matches_jax[int4]``)."""
    _, model = tiny_d64
    tokens = tiny[3]
    cfg = TL.tiny_llm_config(**CHUNKED_D64, dtype=torch.bfloat16, **CACHES[mode])
    full_logits, full_caches = TL.llm_prefill(model, torch.from_numpy(tokens), cfg)
    logits, caches = _packed_k_chunked(model, tokens, cfg, monkeypatch)
    k_min, logits_min = _bounds(cfg)
    for cf, cc in zip(full_caches, caches):
        assert cc["length"].tolist() == [40, 40]
        assert float(cosine_similarity(_values(cc, "k", 4, 40), _values(cf, "k", 4, 40))) >= k_min
    assert float(cosine_similarity(logits.float(), full_logits[:, -1].float())) >= logits_min


def test_chunked_prefill_in_one_chunk_is_the_in_chunk_attention(tiny):
    """A chunk as long as the prompt has no cache to attend: the result does
    not depend on the chunk size past the prompt length."""
    _, _, model, tokens = tiny
    _, cfg = _chunked_cfgs("int8")
    a = TL.llm_prefill_chunked(model, torch.from_numpy(tokens), cfg, chunk=40)
    b = TL.llm_prefill_chunked(model, torch.from_numpy(tokens), cfg, chunk=4096)
    assert torch.equal(a[0], b[0])
    assert all(torch.equal(x[k], y[k]) for x, y in zip(a[1], b[1]) for k in x)


def test_chunked_prefill_checks_its_arguments(tiny):
    _, _, model, tokens = tiny
    with pytest.raises(ValueError, match="max_seq"):
        TL.llm_prefill_chunked(model, torch.from_numpy(tokens),
                               TL.tiny_llm_config(**dict(TINY, max_seq=32), dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="chunk"):
        TL.llm_prefill_chunked(model, torch.from_numpy(tokens), _chunked_cfgs("int8")[1], chunk=0)


@pytest.mark.parametrize("mode", ["int4", "k4v8"])
def test_generate_4bit_caches_match_jax(tiny, mode):
    """Greedy generation on the random tiny model, whose logits have small
    margins: the share of tokens equal to JAX's is printed and held to
    0.75, the agreement JAX's own test asks of k4v8 against int8 (measured
    on a CPU: int4 0.8125, k4v8 1.0)."""
    params, _, model, tokens = tiny
    cfg_j, cfg_t = _cfgs(**CACHES[mode])
    j_out = np.asarray(JL.generate(params, jnp.asarray(tokens), 8, cfg_j))
    t_out = TL.generate(model, torch.from_numpy(tokens), 8, cfg_t).numpy()
    agree = float((j_out == t_out).mean())
    print(f"{mode}: token agreement with JAX {agree:.4f}")
    assert t_out.shape == (2, 8) and agree >= 0.75


@pytest.mark.parametrize("mode", ["int4", "k4v8"])
def test_checkpoint_generate_4bit_caches_token_identical_to_jax(checkpoint, mode):
    j_params, _, model = checkpoint
    prompts, answers = TT.make_eval_prompts(16)
    j_out = np.asarray(JL.generate(j_params, jnp.asarray(prompts), TT.ANS_LEN, JT.arith_llm_config(**CACHES[mode])))
    t_out = TL.generate(model, torch.from_numpy(prompts), TT.ANS_LEN, TT.arith_llm_config(**CACHES[mode]))
    np.testing.assert_array_equal(t_out.numpy(), j_out)
    assert np.mean([TT.grade_answer(row, a) for row, a in zip(t_out.numpy(), answers)]) == 1.0


def test_decode_tokens_takes_zero_steps(tiny):
    _, _, model, tokens = tiny
    _, cfg = _cfgs()
    logits, caches = TL.llm_prefill(model, torch.from_numpy(tokens), cfg)
    tok = torch.argmax(logits[:, -1], dim=-1)
    none, same = TL.decode_tokens(model, tok, caches, 0, cfg)
    assert none.shape == (2, 0) and none.dtype == torch.int32 and same is caches
    assert all(c["length"].tolist() == [40, 40] for c in caches)


@pytest.mark.parametrize("mode", ["int8", "k4v8"])
def test_decode_tokens_advances_the_callers_caches_in_place(tiny, mode):
    """The caller's caches come back as they went in, every layer's
    ``length`` buffer advanced by the tokens decoded (the graph on the card
    replays these same buffers), and a second call goes on from them as one
    longer call does."""
    _, _, model, tokens = tiny
    _, cfg = _cfgs(**CACHES[mode])
    logits, caches = TL.llm_prefill(model, torch.from_numpy(tokens), cfg)
    _, again = TL.llm_prefill(model, torch.from_numpy(tokens), cfg)
    tok = torch.argmax(logits[:, -1], dim=-1)
    buffers = [c["length"] for c in caches]
    got, out = TL.decode_tokens(model, tok, caches, 3, cfg)
    assert out is caches and all(c["length"] is buf for c, buf in zip(caches, buffers))
    assert all(c["length"].tolist() == [43, 43] for c in caches)
    assert tok.tolist() == torch.argmax(logits[:, -1], dim=-1).tolist()  # the caller's token is not written
    more, _ = TL.decode_tokens(model, got[:, -1], caches, 2, cfg)
    whole, _ = TL.decode_tokens(model, tok, again, 5, cfg)
    assert torch.equal(torch.cat([got, more], dim=1), whole)
    assert all(torch.equal(c[k], w[k]) for c, w in zip(caches, again) for k in c)
    assert all(c["length"].tolist() == [45, 45] for c in caches)


def test_launch_counts_add_and_restore():
    """The graph decode adds a captured step's launches once a replay, in
    all, per design and per kernel D variant (a key the capture added)."""
    before = TL._launch_counts()
    delta = {key: 0 for key in before}
    d_key = (td.decode_attention, None)
    variant = td.launch_variant(1, 4, 8, 8, 1)
    v_key = (td.decode_attention, ("variant", variant))
    delta[d_key], delta[(td.decode_attention, "bulk_ring")], delta[v_key] = 3, 3, 3
    TL._add_launch_counts(delta, 5)
    assert td.decode_attention.launches == before[d_key] + 15
    assert td.decode_attention.launches_by_design["bulk_ring"] == before[(td.decode_attention, "bulk_ring")] + 15
    assert td.decode_attention.launches_by_variant[variant] == before.get(v_key, 0) + 15
    TL._add_launch_counts(delta, -5)
    assert TL._launch_counts() == {**before, v_key: before.get(v_key, 0)}


# ---------------------------------------------------------------------------
# The sliding-window / sink LLM (window 16, sink 4 on the tiny model)
# ---------------------------------------------------------------------------

WINDOW = dict(window_size=16, sink_size=4)


@pytest.mark.parametrize("impl", ["int8", "ref"])
def test_window_prefill_matches_jax(tiny, impl):
    """Prefill with a 16-token window and 4 sinks: kernel A's band (int8)
    or the exact oracle (ref), logits and cache values at the file's cosine
    bound; the window changes the logits."""
    params, _, model, tokens = tiny
    cfg_j, cfg_t = _cfgs(**WINDOW)
    j_logits, j_caches = JL.llm_prefill(params, jnp.asarray(tokens), cfg_j, attn_impl=impl)
    t_logits, t_caches = TL.llm_prefill(model, torch.from_numpy(tokens), cfg_t, attn_impl=impl)
    assert _cos(t_logits, j_logits) >= COS_MIN
    for jc, tc in zip(j_caches, t_caches):
        values = tc["k"].float() * tc["k_scale"][..., None]
        assert _cos(values, np.asarray(jc["k"]).astype(np.float32) * np.asarray(jc["k_scale"])[..., None]) >= COS_MIN
    full, _ = TL.llm_prefill(model, torch.from_numpy(tokens), _cfgs()[1], attn_impl=impl)
    assert _cos(t_logits[:, -1], full[:, -1].float().numpy()) < 0.9999


@pytest.mark.parametrize("bits", [8, 16])
def test_window_decode_steps_match_jax(tiny, bits):
    """Decode steps through kernel D's window walk (the sinks and the last
    16 rows of a 40- to 48-token context), from the exact prefill, at the
    file's cosine bound."""
    params, _, model, tokens = tiny
    cfg_j, cfg_t = _cfgs(kv_bits=bits, **WINDOW)
    _, j_caches = JL.llm_prefill(params, jnp.asarray(tokens), cfg_j, attn_impl="ref")
    _, t_caches = TL.llm_prefill(model, torch.from_numpy(tokens), cfg_t, attn_impl="ref")
    feed = np.random.default_rng(2).integers(0, 256, (8, 2)).astype(np.int32)
    step = jax.jit(lambda p, t, c: JL.llm_decode_step(p, t, c, cfg_j))
    for i in range(8):
        j_logits, j_caches = step(params, jnp.asarray(feed[i]), j_caches)
        t_logits, t_caches = TL.llm_decode_step(model, torch.from_numpy(feed[i]), t_caches, cfg_t)
        assert _cos(t_logits, j_logits) >= COS_MIN, i


def test_window_generate_matches_jax(tiny):
    """Greedy generation of the windowed tiny model (int8 prefill and cache)
    gives JAX's tokens."""
    params, _, model, tokens = tiny
    cfg_j, cfg_t = _cfgs(**WINDOW)
    j_out = np.asarray(JL.generate(params, jnp.asarray(tokens), 8, cfg_j))
    t_out = TL.generate(model, torch.from_numpy(tokens), 8, cfg_t)
    np.testing.assert_array_equal(t_out.numpy(), j_out)


def test_window_decode_tokens_equals_stepping(tiny):
    _, _, model, tokens = tiny
    _, cfg = _cfgs(kv_bits=8, k_bits=4, **WINDOW)
    logits, caches = TL.llm_prefill(model, torch.from_numpy(tokens), cfg)
    copy = [{k: v.clone() for k, v in c.items()} for c in caches]
    tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
    got, _ = TL.decode_tokens(model, tok, caches, 5, cfg)
    want = []
    for _ in range(5):
        step_logits, copy = TL.llm_decode_step(model, tok, copy, cfg)
        tok = torch.argmax(step_logits, dim=-1).to(torch.int32)
        want.append(tok)
    assert torch.equal(got, torch.stack(want, dim=1))


def test_chunked_prefill_raises_on_a_window(tiny):
    """As JAX asserts: the chunked prefill takes full causal attention."""
    _, _, model, tokens = tiny
    with pytest.raises(ValueError, match="window_size"):
        TL.llm_prefill_chunked(model, torch.from_numpy(tokens), _cfgs(**WINDOW)[1])


def test_window_config_is_accepted():
    cfg = TL.LLMConfig(window_size=4096, sink_size=4)
    assert (cfg.window_size, cfg.sink_size) == (4096, 4)
