"""Port parity: kernel D's multi-token (verify) and INT8-PV modes, the
multi-row cache append, and speculative decoding, against the JAX package.

Inputs come from numpy with a seed and go to both sides. JAX runs its Pallas
decode kernel in interpret mode on the CPU, jitted (its quantizers then form
every scale as XLA compiles it, one fma); the port runs its plain version.

* ``decode_attention`` with ``q [B, T, H, D]``: both sides compute in f32
  and differ only in summation order, so the single-token file's bounds
  hold (cos >= 0.999999, max|do| <= 2e-6, max|dlse| <= 1e-5; measured on a
  CPU: max|do| <= 3e-7, max|dlse| <= 1e-6). Each T-row equals the
  single-token call at ``length - (T-1-t)``, bit for bit on the integer QK
  chain.
* INT8 PV (``compute_mode="int"``) requantizes P per tile, so the result
  depends on the tiles. At JAX's ``block_kv=64`` (the port's tile) without a
  window both walk the same tiles in the same order and differ by rounding
  only: the file's bounds (measured max|do| <= 2.7e-7). At JAX's default
  block (one block of 384 here) or with a window (the port's window tiles
  start at the first visible row, JAX's at an aligned page) P's codes are
  cut from other maxima: each code moves P by up to half a step of
  ``max p / 127``, so outputs of magnitude ~1-3 move by up to ~1e-2
  (measured 1.2e-2): max|do| <= 3e-2 and cos >= 0.9999; the LSE does not
  depend on the codes (max|dlse| <= 1e-5).
* ``append_kv_multi``: codes, scales and lengths bit for bit against JAX's
  jitted function, including a start clamped to ``S_max - T``.
* ``llm_verify_step`` on a small f32 model from JAX's init: logits at cos >=
  0.99999 against JAX's, and each row against the sequential
  ``llm_decode_step`` it stands for (cos >= 0.99999, the same argmax).
* ``speculative_generate`` gives ``generate``'s tokens on the trained
  checkpoint ``eval_out/arith_llm.npz`` (random weights give argmax ties),
  with a distinct random draft, a self-draft (every draft accepted) and a
  self-draft through an int4 cache.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lowbit_quant_fa2_paddle_tpu.models import llm as JL
from lowbit_quant_fa2_paddle_tpu.ops import decode as jd
from lowbit_quant_fa2_paddle_tpu_torch.models import llm as TL
from lowbit_quant_fa2_paddle_tpu_torch.models import train as TT
from lowbit_quant_fa2_paddle_tpu_torch.ops import decode as td
from lowbit_quant_fa2_paddle_tpu_torch.ops.metrics import cosine_similarity
from lowbit_quant_fa2_paddle_tpu_torch.utils.checkpoint import load_params_npz

# One intra-op thread: the suite runs a worker per core, and torch's thread
# pool, spinning under that load, slowed small CPU ops up to 50-fold.
torch.set_num_threads(1)

CKPT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "eval_out", "arith_llm.npz")
COS_MIN, MAX_DO, MAX_DLSE = 0.999999, 2e-6, 1e-5
PV8_COS_MIN, PV8_MAX_DO = 0.9999, 3e-2
#: Cache modes: (k_bits, v_bits, compute_mode).
MODES = {"int8": (8, 8, "auto"), "bf16": (16, 16, "auto"), "int4": (4, 4, "auto"), "int4-int-qk": (4, 4, "int_qk"),
         "k4v8": (4, 8, "auto"), "k4v8-int-qk": (4, 8, "int_qk"), "int8-f32": (8, 8, "f32")}
OPTS = {"full": {}, "window64": dict(window_size=64), "window64-sink4": dict(window_size=64, sink_size=4)}


def _np(x) -> np.ndarray:
    return np.array(x.astype(jnp.float32) if x.dtype == jnp.bfloat16 else x)


def _torch(x) -> torch.Tensor:
    t = torch.from_numpy(_np(x))
    return t.to(torch.bfloat16) if x.dtype == jnp.bfloat16 else t


def _inputs(t, k_bits, v_bits, seed, b=4, h=8, hk=2, d=64, s=300):
    """q [B, T, H, D] and the quantized caches; lengths: full, shorter than
    T (row 0 sees nothing), T - 1 + 1, and one inside a tile."""
    rng = np.random.default_rng(seed)
    quant = jax.jit(jd.quantize_token, static_argnames="bits")
    kq, ks = quant(jnp.asarray(rng.standard_normal((b, hk, s, d)).astype(np.float32)), bits=k_bits)
    vq, vs = quant(jnp.asarray(rng.standard_normal((b, hk, s, d)).astype(np.float32)), bits=v_bits)
    q = rng.standard_normal((b, t, h, d)).astype(np.float32)
    lengths = np.array([s, 1, t, 137][:b], np.int32)
    return q, kq, vq, ks, vs, lengths


def _both(q, kq, vq, ks, vs, lengths, **kw):
    jfn = jax.jit(lambda q_, l_: jd.decode_attention(q_, kq, vq, ks, l_, v_scale=vs, return_lse=True, **kw))
    jo, jl = jfn(jnp.asarray(q), jnp.asarray(lengths))
    kw.pop("block_kv", None)
    to, tl = td.decode_attention(torch.from_numpy(q), _torch(kq), _torch(vq), _torch(ks), torch.from_numpy(lengths),
                                 v_scale=_torch(vs), return_lse=True, **kw)
    return to, tl, torch.from_numpy(_np(jo)), torch.from_numpy(_np(jl))


@pytest.mark.parametrize("opts", list(OPTS))
@pytest.mark.parametrize("mode", list(MODES))
def test_multitoken_decode_matches_jax(mode, opts):
    """T query tokens (T = 2, 3 or 4 by case) over the int8, bf16, int4 and
    k4v8 caches on both QK chains, with a window with and without sinks,
    against JAX's kernel in interpret mode, at the file's bounds; rows that
    see no key give o = 0 and lse = -1e30 on both sides."""
    k_bits, v_bits, compute_mode = MODES[mode]
    t = 2 + (len(mode) + len(opts)) % 3
    q, kq, vq, ks, vs, lengths = _inputs(t, k_bits, v_bits, seed=k_bits + 3 * v_bits + t)
    to, tl, jo, jl = _both(q, kq, vq, ks, vs, lengths, k_bits=k_bits, v_bits=v_bits, compute_mode=compute_mode,
                           **OPTS[opts])
    assert to.shape == (4, t, 8, 64) and tl.shape == (4, t, 8) and torch.isfinite(to).all()
    assert float(cosine_similarity(to, jo)) >= COS_MIN
    assert float((to - jo).abs().max()) <= MAX_DO
    assert float((tl - jl).abs().max()) <= MAX_DLSE
    # Length 1: only the last token sees a key.
    assert float(to[1, : t - 1].abs().max()) == 0.0 and torch.all(tl[1, : t - 1] == torch.tensor(-1e30))
    assert float(to[1, t - 1].abs().max()) > 0.0


@pytest.mark.parametrize("t", [2, 3, 4])
def test_multitoken_decode_gqa_d128_matches_jax(t):
    """The full-width model's GQA group (4 query heads a KV head) at d128:
    T x 4 rows a KV head, more than one CTA's 8 at T = 3 and 4."""
    q, kq, vq, ks, vs, lengths = _inputs(t, 8, 8, seed=40 + t, h=8, hk=2, d=128)
    to, tl, jo, jl = _both(q, kq, vq, ks, vs, lengths)
    assert float((to - jo).abs().max()) <= MAX_DO and float((tl - jl).abs().max()) <= MAX_DLSE


@pytest.mark.parametrize("opts", ["full", "window64-sink4"])
@pytest.mark.parametrize("mode", ["int8", "k4v8-int-qk", "bf16", "int4"])
def test_multitoken_rows_equal_single_token_calls(mode, opts):
    """Row t of a T-token call is the single-token call at ``length - (T-1-t)``
    with the same query (what speculative decoding's exactness rests on): bit
    for bit on the integer QK chain, whose dots are exact; within 1e-6 on
    the float chain, where the plain version's matmul may sum a row in
    another order for another row count."""
    k_bits, v_bits, compute_mode = MODES[mode]
    t = 4
    q, kq, vq, ks, vs, lengths = _inputs(t, k_bits, v_bits, seed=60 + k_bits)
    args = [_torch(kq), _torch(vq), _torch(ks)]
    kw = dict(v_scale=_torch(vs), k_bits=k_bits, v_bits=v_bits, compute_mode=compute_mode, return_lse=True,
              **OPTS[opts])
    multi, multi_lse = td.decode_attention(torch.from_numpy(q), *args, torch.from_numpy(lengths), **kw)
    for i in range(t):
        rows = torch.from_numpy(np.maximum(lengths - (t - 1 - i), 0))
        single, single_lse = td.decode_attention(torch.from_numpy(q[:, i]), *args, rows, **kw)
        tol = 0.0 if compute_mode == "int_qk" or k_bits == 8 else 1e-6  # the integer chain: exact
        torch.testing.assert_close(multi[:, i], single, rtol=0, atol=tol)
        torch.testing.assert_close(multi_lse[:, i], single_lse, rtol=0, atol=tol)


def test_one_token_in_the_multi_token_layout_is_the_single_token_call():
    q, kq, vq, ks, vs, lengths = _inputs(1, 8, 8, seed=70)
    args = [_torch(kq), _torch(vq), _torch(ks), torch.from_numpy(lengths)]
    four = td.decode_attention(torch.from_numpy(q), *args, v_scale=_torch(vs))
    three = td.decode_attention(torch.from_numpy(q[:, 0]), *args, v_scale=_torch(vs))
    assert four.shape == (4, 1, 8, 64) and torch.equal(four[:, 0], three)


# ---------------------------------------------------------------------------
# INT8 PV
# ---------------------------------------------------------------------------

PV8_MODES = {"int8": (8, 8), "k4v8": (4, 8), "bf16-k": (16, 8)}


@pytest.mark.parametrize("t", [1, 3])
@pytest.mark.parametrize("mode", list(PV8_MODES))
def test_int8_pv_matches_jax_at_the_ports_tile(mode, t):
    """compute_mode="int" on an int8 V (4-bit K on the integer chain, a bf16
    K on the float one) against JAX at block_kv=64: the same tiles in the
    same order, so the same codes; the file's bounds."""
    k_bits, v_bits = PV8_MODES[mode]
    q, kq, vq, ks, vs, lengths = _inputs(t, k_bits, v_bits, seed=80 + k_bits + t)
    q = q[:, 0] if t == 1 else q  # one token as [B, H, D]: JAX returns that shape for it
    kw = dict(k_bits=k_bits, v_bits=v_bits, compute_mode="int")
    to, tl, jo, jl = _both(q, kq, vq, ks, vs, lengths, block_kv=64, **kw)
    assert float(cosine_similarity(to, jo)) >= COS_MIN
    assert float((to - jo).abs().max()) <= MAX_DO
    assert float((tl - jl).abs().max()) <= MAX_DLSE
    # The codes matter: the f32 PV differs by more than rounding.
    f32_pv = td.decode_attention(torch.from_numpy(q), _torch(kq), _torch(vq), _torch(ks), torch.from_numpy(lengths),
                                 v_scale=_torch(vs), k_bits=k_bits, v_bits=v_bits, compute_mode="int_qk")
    assert float((to - f32_pv).abs().max()) > 1e-4


@pytest.mark.parametrize("case", ["default-block", "window100-sink8", "window64"])
def test_int8_pv_matches_jax_on_other_tiles(case):
    """At JAX's default block (one block of 384) and under a window (the
    port's window tiles start at the first visible row) the codes come from
    other tile maxima: the looser bounds of the module note."""
    opts = {} if case == "default-block" else OPTS.get(case, dict(window_size=100, sink_size=8))
    q, kq, vq, ks, vs, lengths = _inputs(3, 8, 8, seed=90 + len(case))
    block = {} if case == "default-block" else dict(block_kv=64)
    to, tl, jo, jl = _both(q, kq, vq, ks, vs, lengths, compute_mode="int", **block, **opts)
    assert float(cosine_similarity(to, jo)) >= PV8_COS_MIN
    assert float((to - jo).abs().max()) <= PV8_MAX_DO
    assert float((tl - jl).abs().max()) <= MAX_DLSE


def test_int8_pv_walks_the_kernels_tiles():
    """The plain version's tiles: splits of split_keys keys, tiles of the
    kernel's BK, window-phase tiles from the first visible row, dealt to
    the warps in turn; the codes follow the partition."""
    assert td.tile_keys(128, 8, 8) == 64 and td.tile_keys(128, 16, 8) == 32 and td.tile_keys(128, 16, 16) == 32
    assert td.tile_keys(64, 16, 16) == 64 and td.tile_keys(256, 16, 16) == 16
    tiles = td.walk_tiles(300, 512, tile=64, split_keys=128, warps=4)
    assert tiles == [(0, 64, 0), (64, 128, 1), (128, 192, 4), (192, 256, 5), (256, 300, 8)]
    # Window 100 + T - 1 = 102 over length 300, sink 8: the sink rows, then
    # rows 198.. from the first visible one (one split of window_keys keys).
    tiles = td.walk_tiles(300, 512, tile=64, window=100, sink=8, q_tokens=3)
    assert tiles == [(0, 8, 0), (198, 262, 0), (262, 300, 0)]
    q, kq, vq, ks, vs, lengths = _inputs(2, 8, 8, seed=99)
    args = [torch.from_numpy(q), _torch(kq), _torch(vq), _torch(ks), _torch(vs), torch.from_numpy(lengths)]
    kw = dict(sm_scale=0.125, int_qk=True, out_dtype=torch.float32, int_pv=True)
    one = td.decode_attention_plain(*args, **kw)[0]
    split = td.decode_attention_plain(*args, **kw, split_keys=64, warps=4)[0]
    assert not torch.equal(one, split) and float((one - split).abs().max()) <= PV8_MAX_DO


def test_int8_pv_needs_an_int8_v_and_leaves_other_caches_on_the_f32_pv():
    """As in JAX, "int" runs INT8 PV on an int8 V only: a bf16 or 4-bit V
    keeps the f32 PV (and "int" still puts a 4-bit K on the integer chain)."""
    q, kq, vq, ks, vs, lengths = _inputs(2, 4, 4, seed=100)
    args = [torch.from_numpy(q), _torch(kq), _torch(vq), _torch(ks), torch.from_numpy(lengths)]
    a = td.decode_attention(*args, v_scale=_torch(vs), kv_bits=4, compute_mode="int")
    b = td.decode_attention(*args, v_scale=_torch(vs), kv_bits=4, compute_mode="int_qk")
    assert torch.equal(a, b)
    with pytest.raises(ValueError, match="int8 V"):
        td.decode_attention_plain(*args[:4], _torch(vs), args[4], sm_scale=0.125, int_qk=True,
                                  out_dtype=torch.float32, int_pv=True)


# ---------------------------------------------------------------------------
# append_kv_multi
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("bits", [8, 16, 4, "k4v8"])
def test_append_kv_multi_matches_jax(bits):
    """Two appends of T = 3 rows at lengths 0, 2, S_max - 1 and S_max: the
    last two starts clamp to S_max - 3 as ``dynamic_update_slice`` clamps
    them (all three rows shift back together); codes, scales and lengths
    bit for bit."""
    rng = np.random.default_rng(7)
    b, hk, s_max, d, t = 4, 2, 8, 64, 3
    lengths = np.array([0, 2, s_max - 1, s_max], np.int32)
    sides = dict(k_bits=4, v_bits=8) if bits == "k4v8" else dict(bits=bits)
    jc = jd.init_kv_cache(b, hk, s_max, d, **sides)
    jc["length"] = jnp.asarray(lengths)
    tc = td.init_kv_cache(b, hk, s_max, d, **sides, device="cpu")
    tc["length"] = torch.from_numpy(lengths.copy())
    append = jax.jit(jd.append_kv_multi)
    for _ in range(2):
        k = (rng.standard_normal((b, hk, t, d)) * 3).astype(np.float32)
        v = (rng.standard_normal((b, hk, t, d)) * 2).astype(np.float32)
        jc = append(jc, jnp.asarray(k), jnp.asarray(v))
        tc = td.append_kv_multi(tc, torch.from_numpy(k), torch.from_numpy(v))
    for key in ("k", "v", "k_scale", "v_scale", "length"):
        got, want = tc[key], jc[key]
        got = got.float().numpy() if got.dtype == torch.bfloat16 else got.numpy()
        np.testing.assert_array_equal(got.view(np.uint8), _np(want).view(np.uint8), err_msg=key)
    assert tc["length"].tolist() == [6, 8, 13, 14]


def test_append_kv_multi_equals_single_appends():
    """Away from the end, T rows appended at once are T single appends."""
    rng = np.random.default_rng(8)
    k = torch.from_numpy(rng.standard_normal((2, 2, 3, 64)).astype(np.float32))
    v = torch.from_numpy(rng.standard_normal((2, 2, 3, 64)).astype(np.float32))
    a = td.init_kv_cache(2, 2, 16, 64, k_bits=4, v_bits=8, device="cpu")
    a["length"] = torch.tensor([0, 5], dtype=torch.int32)
    b = {key: val.clone() for key, val in a.items()}
    a = td.append_kv_multi(a, k, v)
    for i in range(3):
        b = td.append_kv(b, k[:, :, i], v[:, :, i])
    assert all(torch.equal(a[key], b[key]) for key in a)


# ---------------------------------------------------------------------------
# llm_verify_step and speculative_generate
# ---------------------------------------------------------------------------

SMALL = dict(vocab=64, dim=64, depth=2, num_heads=4, num_kv_heads=2, max_seq=128)


@pytest.fixture(scope="module")
def small():
    params = JL.init_llm_params(jax.random.PRNGKey(0), JL.tiny_llm_config(**SMALL))
    tree = jax.tree_util.tree_map(lambda x: np.array(x, np.float32), params)
    model = TL.params_from_jax(tree, TL.tiny_llm_config(**SMALL), device="cpu")
    prompt = np.random.default_rng(1).integers(0, 64, (2, 12)).astype(np.int32)
    return params, model, prompt


@pytest.mark.parametrize("opts", [{}, dict(window_size=8, sink_size=2), dict(kv_bits=8, k_bits=4)])
def test_verify_step_matches_jax(small, opts):
    """Four fed tokens over the prefilled caches: logits against JAX's
    verify step, and the appended cache rows' codes equal (layer 0, where
    nothing before differs). A 4-bit K steps its codes by a seventh of the
    row maximum, so where the two sides' f32 activations differ by rounding
    a flipped code moves a logit by more: cos >= 0.999 there, as
    tests/test_torch_llm.py holds the 4-bit decode steps."""
    params, model, prompt = small
    cfg_j, cfg_t = JL.tiny_llm_config(**SMALL, **opts), TL.tiny_llm_config(**SMALL, **opts)
    _, j_caches = JL.llm_prefill(params, jnp.asarray(prompt), cfg_j)
    _, t_caches = TL.llm_prefill(model, torch.from_numpy(prompt), cfg_t)
    fed = np.array([[7, 21, 3, 9], [1, 2, 3, 4]], np.int32)
    j_logits, j_caches = jax.jit(lambda p, t, c: JL.llm_verify_step(p, t, c, cfg_j))(params, jnp.asarray(fed),
                                                                                      j_caches)
    t_logits, t_caches = TL.llm_verify_step(model, torch.from_numpy(fed), t_caches, cfg_t)
    assert t_logits.shape == (2, 4, 64)
    cos_min = 0.999 if opts.get("k_bits") == 4 else 0.99999
    assert float(cosine_similarity(t_logits, torch.from_numpy(np.array(j_logits)))) >= cos_min
    assert t_caches[0]["length"].tolist() == [16, 16]
    np.testing.assert_array_equal(t_caches[0]["k"][:, :, 12:16].numpy(), np.asarray(j_caches[0]["k"])[:, :, 12:16])


@pytest.mark.parametrize("opts", [{}, dict(window_size=8, sink_size=2)])
def test_verify_step_rows_match_decode_steps(small, opts):
    """Verify-step row t against the t-th sequential llm_decode_step from
    the same prefill: cos >= 0.99999 and the same argmax."""
    _, model, prompt = small
    cfg = TL.tiny_llm_config(**SMALL, **opts)
    _, caches_a = TL.llm_prefill(model, torch.from_numpy(prompt), cfg)
    _, caches_b = TL.llm_prefill(model, torch.from_numpy(prompt), cfg)
    fed = torch.tensor([[7, 21, 3], [5, 5, 60]], dtype=torch.int32)
    v_logits, _ = TL.llm_verify_step(model, fed, caches_a, cfg)
    for t in range(3):
        s_logits, caches_b = TL.llm_decode_step(model, fed[:, t], caches_b, cfg)
        assert float(cosine_similarity(v_logits[:, t], s_logits)) >= 0.99999, t
        assert torch.equal(torch.argmax(v_logits[:, t], dim=-1), torch.argmax(s_logits, dim=-1)), t


@pytest.fixture(scope="module")
def checkpoint():
    cfg = TT.arith_llm_config()
    model = TL.params_from_jax(load_params_npz(CKPT), cfg, device="cpu")
    prompts, answers = TT.make_eval_prompts(4, few_shot=3)
    return cfg, model, prompts, answers


N_NEW = 2 * TT.ANS_LEN  # an answer and the next fact's first digits


def _generate(model, prompt, cfg):
    return TL.generate(model, torch.from_numpy(prompt[None]), N_NEW, cfg)


@pytest.mark.parametrize("spec_k", [2, 3])
def test_speculative_equals_generate_with_a_distinct_draft(checkpoint, spec_k):
    """A random draft (one layer, dim 64): low acceptance, the target's
    tokens all the same."""
    cfg, model, prompts, _ = checkpoint
    draft_cfg = TL.tiny_llm_config(vocab=cfg.vocab, dim=64, depth=1, num_heads=2, num_kv_heads=1,
                                   max_seq=cfg.max_seq)
    draft = TL.init_llm_params(draft_cfg, torch.Generator().manual_seed(9), device="cpu")
    for prompt in prompts:
        got, stats = TL.speculative_generate(model, torch.from_numpy(prompt[None]), N_NEW, cfg, draft_params=draft,
                                             draft_cfg=draft_cfg, spec_k=spec_k, return_stats=True)
        assert got.dtype == torch.int32 and torch.equal(got, _generate(model, prompt, cfg))
        assert stats["rounds"] >= 1 and 0 <= stats["mean_accepted"] < spec_k


@pytest.mark.parametrize("draft_mode", ["self", "self-int4-cache"])
def test_speculative_equals_generate_with_a_self_draft(checkpoint, draft_mode):
    """The target itself as the draft accepts every draft (mean accepted ==
    spec_k); through an int4 cache it still gives the target's tokens."""
    cfg, model, prompts, answers = checkpoint
    draft_cfg = cfg if draft_mode == "self" else TT.arith_llm_config(kv_bits=4)
    for prompt, answer in zip(prompts, answers):
        got, stats = TL.speculative_generate(model, torch.from_numpy(prompt[None]), N_NEW, cfg, draft_params=model,
                                             draft_cfg=draft_cfg, spec_k=4, return_stats=True)
        assert torch.equal(got, _generate(model, prompt, cfg))
        assert TT.grade_answer(got[0].numpy(), answer)
        if draft_mode == "self":
            assert stats["mean_accepted"] == stats["spec_k"] == 4 and stats["rounds"] == 2


def test_speculative_generate_checks_capacity_and_batch(checkpoint):
    cfg, model, prompts, _ = checkpoint
    prompt = torch.from_numpy(prompts[:1])
    with pytest.raises(ValueError, match="capacity"):
        TL.speculative_generate(model, prompt, 200, cfg, draft_params=model, draft_cfg=cfg)
    with pytest.raises(ValueError, match="single-sequence"):
        TL.speculative_generate(model, torch.from_numpy(prompts[:2]), 4, cfg, draft_params=model, draft_cfg=cfg)
