"""Port parity at the head dims that kernels D and E take at run time (every
multiple of 16 up to 256 without an instance of its own: MPT-30B's 112,
Nemotron-4-340B's 192 and the rest), each against the JAX package fed the
same numpy inputs from a seed. JAX runs its Pallas kernels in interpret mode
(both take the head dim whole as a block's last dim); the port runs its
plain versions (kernel D on the tiles of the instance that runs the head
dim, laid out for 128 or for 256).

Bounds, as the files of the same functions at other head dims set them:

* kernel D, float PV: test_torch_hd96.py's (cos >= 0.999999, max|do| <=
  2e-6, max|dlse| <= 1e-5), contiguous and paged (every page no walk visits
  NaN), one token and T = 4; every cache mode on both QK chains at 112 and
  192; INT8 PV at 192 at JAX's ``block_kv`` equal to the port's tile there
  (32 keys: the same codes), at the same bounds;
* kernel E: test_torch_fused_kv.py's (cos >= 0.999, max|do| <= 3e-2: the
  port rounds Q, K and V to bf16 for the tensor cores);
* the tiny LLM at head dim 112 (2 query and 2 KV heads, dim 224, depth 2):
  test_torch_hd96.py's, logits cos >= 0.9999 after the prefill and each of 3
  decode steps (0.999 with 4-bit K); speculative_generate token-equal to
  generate.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lowbit_quant_fa2_paddle_tpu.models import llm as JL
from lowbit_quant_fa2_paddle_tpu.ops import decode as jd
from lowbit_quant_fa2_paddle_tpu.ops import fused_kv as JF
from lowbit_quant_fa2_paddle_tpu_torch.models import llm as TL
from lowbit_quant_fa2_paddle_tpu_torch.ops import decode as td
from lowbit_quant_fa2_paddle_tpu_torch.ops import fused_kv as TF
from lowbit_quant_fa2_paddle_tpu_torch.ops.metrics import cosine_similarity

# One intra-op thread: the suite runs a worker per core, and torch's thread
# pool, spinning under that load, slowed small CPU ops up to 50-fold.
torch.set_num_threads(1)

COS_MIN, MAX_DO, MAX_DLSE = 0.999999, 2e-6, 1e-5
E_COS, E_MAX_DO = 0.999, 3e-2
LLM_COS, LLM_COS_4BIT = 0.9999, 0.999
#: JAX's token quantizer, jitted once for the file.
_quant = jax.jit(jd.quantize_token, static_argnames="bits")


def _np(x) -> np.ndarray:
    return np.array(x.astype(jnp.float32) if x.dtype == jnp.bfloat16 else x)


def _torch(x) -> torch.Tensor:
    t = torch.from_numpy(_np(x))
    return t.to(torch.bfloat16) if x.dtype == jnp.bfloat16 else t


def _close(to, tl, jo, jl):
    jo, jl = torch.from_numpy(_np(jo)), torch.from_numpy(_np(jl))
    assert to.shape == jo.shape and tl.shape == jl.shape and torch.isfinite(to).all()
    assert float(cosine_similarity(to, jo)) >= COS_MIN
    assert float((to - jo).abs().max()) <= MAX_DO
    assert float((tl - jl).abs().max()) <= MAX_DLSE


# ---------------------------------------------------------------------------
# Kernel D
# ---------------------------------------------------------------------------

#: Cache modes: (k_bits, v_bits, compute_mode). "int" is INT8 PV.
MODES = {"int8": (8, 8, "auto"), "int8-f32": (8, 8, "f32"), "bf16": (16, 16, "auto"), "int4": (4, 4, "auto"),
         "int4-int-qk": (4, 4, "int_qk"), "k4v8": (4, 8, "auto"), "k4v8-int-qk": (4, 8, "int_qk"),
         "int8-pv8": (8, 8, "int")}
#: (head dim, mode, T): the four caches on both chains at 112 and 192, one
#: mode each at 16, 48, 160 and 240, INT8 PV at 192 (a 32-key tile).
CASES = [(d, mode, t) for d in (112, 192) for mode, t in (
    ("int8", 1), ("int8-f32", 4), ("bf16", 1), ("int4", 4), ("int4-int-qk", 1), ("k4v8", 4), ("k4v8-int-qk", 4))] + [
    (192, "int8-pv8", 4), (16, "int8", 4), (48, "k4v8-int-qk", 1), (160, "int4", 1), (240, "bf16", 4)]


def _inputs(d, t, k_bits, v_bits, seed, b=3, h=4, hk=2, s=100):
    """q [B, (T,) H, D] and the quantized caches; lengths: full, shorter
    than T (row 0 sees nothing at T > 1), and one inside a tile. At head dim
    192 the heads are Nemotron-4's group of 12 to a KV head."""
    if d == 192:
        h, hk = 12, 1
    rng = np.random.default_rng(seed)
    kq, ks = _quant(jnp.asarray(rng.standard_normal((b, hk, s, d)).astype(np.float32)), bits=k_bits)
    vq, vs = _quant(jnp.asarray(rng.standard_normal((b, hk, s, d)).astype(np.float32)), bits=v_bits)
    q = rng.standard_normal((b, t, h, d) if t > 1 else (b, h, d)).astype(np.float32)
    lengths = np.array([s, 1, 67][:b], np.int32)  # s = 100: two 64-key tiles, the second ragged
    return q, kq, vq, ks, vs, lengths


@pytest.mark.parametrize("d,mode,t", CASES, ids=[f"d{d}-{mode}-t{t}" for d, mode, t in CASES])
def test_decode_head_dims_match_jax(d, mode, t):
    """Kernel D's plain version at the run-time head dims against JAX's
    decode_attention: the cache modes and chains of :data:`CASES`, INT8 PV
    at JAX's block_kv equal to the port's tile (the instance laid out for
    128 or 256)."""
    k_bits, v_bits, compute = MODES[mode]
    q, kq, vq, ks, vs, lengths = _inputs(d, t, k_bits, v_bits, seed=d + 7 * k_bits + v_bits + t)
    kw = dict(k_bits=k_bits, v_bits=v_bits, compute_mode=compute)
    tile = td.tile_keys(d, k_bits, v_bits)
    assert tile == td.tile_keys(td.instance_dim(d), k_bits, v_bits) and td.instance_dim(d) == (128 if d <= 128
                                                                                                  else 256)
    block = dict(block_kv=tile) if compute == "int" else {}
    jfn = jax.jit(lambda q_, l_: jd.decode_attention(q_, kq, vq, ks, l_, v_scale=vs, return_lse=True, **kw, **block))
    jo, jl = jfn(jnp.asarray(q), jnp.asarray(lengths))
    to, tl = td.decode_attention(torch.from_numpy(q), _torch(kq), _torch(vq), _torch(ks), torch.from_numpy(lengths),
                                 v_scale=_torch(vs), return_lse=True, **kw)
    _close(to, tl, jo, jl)


PAGED = {
    # name: (mode, d, page, T)
    "int4-d112-p16-t4": ("int4", 112, 16, 4),
}


@pytest.mark.parametrize("case", list(PAGED))
def test_paged_decode_d112_matches_jax(case):
    """The paged cache at head dim 112: a shuffled pool, lengths 0, two
    pages, the whole table and one inside a page; every page no walk visits
    holds NaN scales."""
    mode, d, page, t = PAGED[case]
    k_bits, v_bits, compute = MODES[mode]
    b, h, hk, width = 4, 4, 2, 8
    rng = np.random.default_rng(d + page + t)
    n_pages = b * width + 3
    kq, ks = (np.array(x) for x in _quant(jnp.asarray(rng.standard_normal((hk, n_pages, page, d)), jnp.float32),
                                        bits=k_bits))
    vq, vs = (np.array(x) for x in _quant(jnp.asarray(rng.standard_normal((hk, n_pages, page, d)), jnp.float32),
                                        bits=v_bits))
    table = rng.permutation(n_pages)[: b * width].reshape(b, width).astype(np.int32)
    lengths = np.array([0, 2 * page, width * page, 3 * page + 5], np.int32)
    visited = {int(table[i, p]) for i, n in enumerate(lengths) for p in range(-(-int(n) // page))}
    dead = np.array(sorted(set(range(n_pages)) - visited))
    ks[:, dead] = np.nan
    vs[:, dead] = np.nan
    q = rng.standard_normal((b, t, h, d) if t > 1 else (b, h, d)).astype(np.float32)
    kw = dict(k_bits=k_bits, v_bits=v_bits, compute_mode=compute, return_lse=True)
    jfn = jax.jit(functools.partial(jd.decode_attention, **kw))
    jo, jl = jfn(jnp.asarray(q), jnp.asarray(kq), jnp.asarray(vq), jnp.asarray(ks), jnp.asarray(lengths),
                 v_scale=jnp.asarray(vs), page_table=jnp.asarray(table))
    to, tl = td.decode_attention(torch.from_numpy(q), torch.from_numpy(kq), torch.from_numpy(vq),
                                 torch.from_numpy(ks), torch.from_numpy(lengths), v_scale=torch.from_numpy(vs),
                                 page_table=torch.from_numpy(table), **kw)
    _close(to, tl, jo, jl)


def test_card_head_dims_and_labels():
    """Kernel D takes every multiple of 16 from 16 to 256 on the card, the
    ones outside HEAD_DIMS on the run-time instances (laid out for 128 or
    256); the rest raise naming ROADMAP item 3 (not a multiple of 16) or 3h
    (above 256). Kernel E takes the same head dims."""
    assert td.CARD_HEAD_DIMS == tuple(range(16, 257, 16)) == TF.HEAD_DIMS
    assert set(td.HEAD_DIMS) < set(td.CARD_HEAD_DIMS)
    assert set(td.decode_attention.launches_by_dim) == set(td.CARD_HEAD_DIMS)
    assert [td.instance_dim(d) for d in (16, 48, 80, 112, 128, 144, 192, 240, 256)] == [128, 128, 80, 128, 128,
                                                                                         256, 256, 256, 256]
    for d in td.CARD_HEAD_DIMS:
        td.check_head_dim(d)
    for d, item in ((104, "3"), (8, "3"), (200, "3"), (272, "3h"), (320, "3h")):
        with pytest.raises(NotImplementedError, match=f"item {item}\\)"):
            td.check_head_dim(d)
    assert [TF.pack_row_bytes(d, bits) for d, bits in ((48, 2), (112, 2), (112, 4), (128, 4), (192, 2))] == [
        16, 32, 64, 64, 48]


# ---------------------------------------------------------------------------
# Kernel E
# ---------------------------------------------------------------------------

E_CASES = [(d, bits, causal) for d in (48, 112, 192) for bits, causal in ((4, d != 112), (2, d == 112))]


@pytest.mark.parametrize("d,bits,causal", E_CASES, ids=[f"d{d}-int{bits}-{'causal' if c else 'full'}"
                                                        for d, bits, c in E_CASES])
def test_fused_kv_head_dims_match_jax(d, bits, causal):
    """Kernel E's plain version at head dims 48, 112 and 192, 4- and 2-bit
    (2-bit rows of 12, 28 and 48 bytes), causal and not, GQA 4/2, 100 keys
    in groups of 64 (the second ragged), against JAX's
    fused_packed_kv_attention on the same packed codes, scales and mns (the
    port's quant_kv_grouped, bit-equal to JAX's run op by op:
    test_torch_fused_kv.py holds the two equal; it does not depend on the
    head dim)."""
    rng = np.random.default_rng(d + bits)
    q = rng.standard_normal((1, 4, 64, d)).astype(np.float32)
    k = (rng.standard_normal((1, 2, 100, d)) + 0.5).astype(np.float32)
    v = (rng.standard_normal((1, 2, 100, d)) - 0.3).astype(np.float32)
    tk = TF.quant_kv_grouped(torch.from_numpy(k), bits=bits, group=64)
    tv = TF.quant_kv_grouped(torch.from_numpy(v), bits=bits, group=64)
    jk, jv = ([jnp.asarray(x.numpy()) for x in t] for t in (tk, tv))
    want = JF.fused_packed_kv_attention(jnp.asarray(q), jk[0], jv[0], jk[1], jk[2], jv[1], jv[2], bits=bits,
                                        group=64, out_dtype=jnp.float32, is_causal=causal)
    o = TF.fused_packed_kv_attention(torch.from_numpy(q), tk[0], tv[0], tk[1], tk[2], tv[1], tv[2], bits=bits,
                                     group=64, out_dtype=torch.float32, is_causal=causal)
    want = torch.from_numpy(np.array(want))
    assert o.shape == (1, 4, 64, d) and o.dtype == torch.float32
    assert float(cosine_similarity(o, want)) >= E_COS
    assert float((o - want).abs().max()) <= E_MAX_DO


# ---------------------------------------------------------------------------
# A tiny LLM at head dim 112
# ---------------------------------------------------------------------------

HD112 = dict(dim=224, depth=2, num_heads=2, num_kv_heads=2, max_seq=32)
LLM_CACHES = {"int8": dict(kv_bits=8), "int4": dict(kv_bits=4)}


def _bf16_tree(tree):
    return jax.tree_util.tree_map(lambda x: jnp.asarray(x, jnp.bfloat16), tree)


@pytest.fixture(scope="module")
def hd112():
    """JAX's tiny LLM params at head dim 112 from numpy (JAX's init
    distributions: dense N(0, 1/d_in), embed N(0, 0.02^2), norms ones), the
    port's model of them and the prompt tokens."""
    rng = np.random.default_rng(112)
    dim, kv = HD112["dim"], HD112["num_kv_heads"] * 112

    def dense(i, o):
        return (rng.standard_normal((i, o)) / np.sqrt(i)).astype(np.float32)

    blocks = [{"wq": dense(dim, dim), "wk": dense(dim, kv), "wv": dense(dim, kv), "wo": dense(dim, dim),
               "w1": dense(dim, 4 * dim), "w2": dense(4 * dim, dim), "ln1": np.ones(dim, np.float32),
               "ln2": np.ones(dim, np.float32)} for _ in range(HD112["depth"])]
    params = _bf16_tree({"embed": (rng.standard_normal((256, dim)) * 0.02).astype(np.float32), "blocks": blocks,
                         "ln_f": np.ones(dim, np.float32)})
    tree = jax.tree_util.tree_map(lambda x: np.array(x.astype(jnp.float32)), params)
    model = TL.params_from_jax(tree, TL.tiny_llm_config(**HD112, dtype=torch.bfloat16), device="cpu")
    tokens = np.random.default_rng(113).integers(0, 256, (2, 24)).astype(np.int32)
    return params, model, tokens


def _cfgs(cache):
    return (JL.tiny_llm_config(**HD112, dtype=jnp.bfloat16, **LLM_CACHES[cache]),
            TL.tiny_llm_config(**HD112, dtype=torch.bfloat16, **LLM_CACHES[cache]))


@pytest.fixture(scope="module")
def jax_prefill(hd112):
    """JAX's llm_prefill of the fixture's tokens into a cache mode, once per
    module and mode (JAX's arrays are immutable; no step donates them)."""
    params, _, tokens = hd112
    return functools.lru_cache(maxsize=None)(lambda cache: jax.jit(
        lambda p, t: JL.llm_prefill(p, t, _cfgs(cache)[0]))(params, jnp.asarray(tokens)))


@pytest.mark.parametrize("cache", list(LLM_CACHES))
def test_hd112_llm_prefill_and_decode_match_jax(hd112, jax_prefill, cache):
    """llm_prefill (kernel A pads the head dim to 128) and 3 decode steps
    (kernel D at head dim 112, the run-time instance on the card) on the
    int8 and int4 caches (4-bit rows of 56 bytes)."""
    params, model, tokens = hd112
    cfg_j, cfg_t = _cfgs(cache)
    assert cfg_t.head_dim == 112
    j_logits, j_caches = jax_prefill(cache)
    t_logits, t_caches = TL.llm_prefill(model, torch.from_numpy(tokens), cfg_t)
    assert float(cosine_similarity(t_logits.float(), torch.from_numpy(_np(j_logits)))) >= LLM_COS
    bound = LLM_COS_4BIT if cfg_t.eff_k_bits == 4 else LLM_COS
    feed = np.random.default_rng(114).integers(0, 256, (3, 2)).astype(np.int32)
    step = jax.jit(lambda p, t, c: JL.llm_decode_step(p, t, c, cfg_j))
    for i in range(3):
        j_logits, j_caches = step(params, jnp.asarray(feed[i]), j_caches)
        t_logits, t_caches = TL.llm_decode_step(model, torch.from_numpy(feed[i]), t_caches, cfg_t)
        assert float(cosine_similarity(t_logits.float(), torch.from_numpy(_np(j_logits)))) >= bound, i
    assert t_caches[0]["length"].tolist() == [27, 27]
    assert tuple(t_caches[0]["k"].shape) == (2, 2, 32, 56 if cfg_t.eff_k_bits == 4 else 112)


def test_hd112_speculative_generate_equals_generate(hd112):
    """The port's speculative_generate on the head-dim-112 model (spec_k 4,
    the model through an int4 cache as the draft; on the card its verify
    steps run kernel D's T-token run-time instance) gives generate's
    tokens."""
    _, model, tokens = hd112
    cfg = TL.tiny_llm_config(**HD112, dtype=torch.bfloat16, kv_bits=8)
    draft = TL.tiny_llm_config(**HD112, dtype=torch.bfloat16, kv_bits=4)
    prompt = torch.from_numpy(tokens[:1, :12])
    toks, stats = TL.speculative_generate(model, prompt, 8, cfg, draft_params=model, draft_cfg=draft, spec_k=4,
                                          return_stats=True)
    assert torch.equal(toks, TL.generate(model, prompt, 8, cfg))
    assert stats["rounds"] >= 2
