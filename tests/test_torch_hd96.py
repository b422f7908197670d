"""Port parity for the off-ladder slice: kernel D at head dims 80 and 96
(Phi-2's and Phi-3-mini's), tiny LLMs at those head dims, fp32 PV with bf16
QK at head_dim 256, and the checkpoint files, each against the JAX package
fed the same numpy inputs from a seed. JAX runs its Pallas kernels in
interpret mode (kernel D takes the head dim whole as its block's last dim);
the port runs its plain versions (kernel D's own tiles at these dims).

Bounds, as the files of the same functions at other head dims set them:

* kernel D, float PV: test_torch_decode.py's (cos >= 0.999999, max|do| <=
  2e-6, max|dlse| <= 1e-5), contiguous and paged (every page no walk
  visits NaN), one token and T = 4, every cache mode on both QK chains;
  INT8 PV at JAX's ``block_kv=64`` (kernel D's tile at these dims: the same
  codes): the same bounds;
* the tiny LLMs (4 query heads, 2 KV heads, depth 2: dim 384 at head_dim
  96, 320 at 80): test_torch_hd256.py's, logits cos >= 0.9999 after the
  prefill and each of 4 decode steps (0.999 with 4-bit K);
* fp32 PV with bf16 QK at head_dim 256: f32 grade, max|do| and max|dlse|
  <= 1e-5 (test_torch_hd256.py's F32_MAX_DO);
* checkpoints: the same arrays, bit for bit, and the same meta file, in
  both directions.
"""

import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lowbit_quant_fa2_paddle_tpu.models import llm as JL
from lowbit_quant_fa2_paddle_tpu.ops import attention as jattn
from lowbit_quant_fa2_paddle_tpu.ops import decode as jd
from lowbit_quant_fa2_paddle_tpu.utils import checkpoint as jckpt
from lowbit_quant_fa2_paddle_tpu_torch.models import dit as TD
from lowbit_quant_fa2_paddle_tpu_torch.models import llm as TL
from lowbit_quant_fa2_paddle_tpu_torch.ops import decode as td
from lowbit_quant_fa2_paddle_tpu_torch.ops.attention import lowbit_attention
from lowbit_quant_fa2_paddle_tpu_torch.ops.metrics import cosine_similarity
from lowbit_quant_fa2_paddle_tpu_torch.utils import checkpoint as tckpt

# One intra-op thread: the suite runs a worker per core, and torch's thread
# pool, spinning under that load, slowed small CPU ops up to 50-fold.
torch.set_num_threads(1)

COS_MIN, MAX_DO, MAX_DLSE = 0.999999, 2e-6, 1e-5
F32_MAX_DO, F32_MAX_DLSE = 1e-5, 1e-5
LLM_COS, LLM_COS_4BIT = 0.9999, 0.999


def _np(x) -> np.ndarray:
    return np.array(x.astype(jnp.float32) if x.dtype == jnp.bfloat16 else x)


def _torch(x) -> torch.Tensor:
    t = torch.from_numpy(_np(x))
    return t.to(torch.bfloat16) if x.dtype == jnp.bfloat16 else t


def _close(to, tl, jo, jl, cos_min=COS_MIN, max_do=MAX_DO, max_dlse=MAX_DLSE):
    jo, jl = torch.from_numpy(_np(jo)), torch.from_numpy(_np(jl))
    assert to.shape == jo.shape and tl.shape == jl.shape and torch.isfinite(to).all()
    assert float(cosine_similarity(to, jo)) >= cos_min
    assert float((to - jo).abs().max()) <= max_do
    assert float((tl - jl).abs().max()) <= max_dlse


# ---------------------------------------------------------------------------
# Kernel D at head dims 80 and 96
# ---------------------------------------------------------------------------

#: Cache modes: (k_bits, v_bits, compute_mode). "int" is INT8 PV.
MODES = {"int8": (8, 8, "auto"), "bf16": (16, 16, "auto"), "int4": (4, 4, "auto"), "int4-int-qk": (4, 4, "int_qk"),
         "k4v8": (4, 8, "auto"), "k4v8-int-qk": (4, 8, "int_qk"), "k16v8": (16, 8, "auto"), "int8-f32": (8, 8, "f32"),
         "int8-pv8": (8, 8, "int"), "k4v8-pv8": (4, 8, "int")}


def _inputs(d, t, k_bits, v_bits, seed, b=4, h=8, hk=2, s=140):
    """q [B, (T,) H, D] and the quantized caches; lengths: full, shorter
    than T (row 0 sees nothing at T > 1), and two inside tiles."""
    rng = np.random.default_rng(seed)
    quant = jax.jit(jd.quantize_token, static_argnames="bits")
    kq, ks = quant(jnp.asarray(rng.standard_normal((b, hk, s, d)).astype(np.float32)), bits=k_bits)
    vq, vs = quant(jnp.asarray(rng.standard_normal((b, hk, s, d)).astype(np.float32)), bits=v_bits)
    q = rng.standard_normal((b, t, h, d) if t > 1 else (b, h, d)).astype(np.float32)
    lengths = np.array([s, 1, 131, 67][:b], np.int32)
    return q, kq, vq, ks, vs, lengths


#: Each mode at one head dim and one token count: (d, T), both head dims
#: and both counts over every cache mode and chain.
WHERE = {"int8": (96, 1), "bf16": (80, 4), "int4": (96, 4), "int4-int-qk": (80, 1), "k4v8": (80, 1),
         "k4v8-int-qk": (96, 4), "k16v8": (96, 1), "int8-f32": (80, 4), "int8-pv8": (96, 4), "k4v8-pv8": (80, 1)}


@pytest.mark.parametrize("mode", list(MODES))
def test_decode_off_ladder_matches_jax(mode):
    """Kernel D's plain version at head dims 80 and 96 on every cache mode
    and both QK chains, one token or T = 4 (:data:`WHERE`), INT8 PV at JAX's
    block_kv=64, against JAX's decode_attention."""
    k_bits, v_bits, compute = MODES[mode]
    d, t = WHERE[mode]
    q, kq, vq, ks, vs, lengths = _inputs(d, t, k_bits, v_bits, seed=d + 7 * k_bits + v_bits + t)
    kw = dict(k_bits=k_bits, v_bits=v_bits, compute_mode=compute)
    block = dict(block_kv=64) if compute == "int" else {}
    jfn = jax.jit(lambda q_, l_: jd.decode_attention(q_, kq, vq, ks, l_, v_scale=vs, return_lse=True, **kw, **block))
    jo, jl = jfn(jnp.asarray(q), jnp.asarray(lengths))
    to, tl = td.decode_attention(torch.from_numpy(q), _torch(kq), _torch(vq), _torch(ks), torch.from_numpy(lengths),
                                 v_scale=_torch(vs), return_lse=True, **kw)
    _close(to, tl, jo, jl)
    # The kernel's tile: 64 keys while 64 rows of K and V fit 16 KB.
    assert td.tile_keys(d, k_bits, v_bits) == {(96, 16, 16): 32, (80, 16, 16): 32, (96, 16, 8): 32}.get(
        (d, k_bits, v_bits), 64)


def test_decode_off_ladder_window_sinks_and_cap_match_jax():
    """A window with sinks and a logit cap on the k4v8 cache's integer chain,
    T = 3, at head_dim 80."""
    q, kq, vq, ks, vs, lengths = _inputs(80, 3, 4, 8, seed=81)
    kw = dict(k_bits=4, v_bits=8, compute_mode="int_qk", window_size=64, sink_size=4, logit_cap=20.0)
    jo, jl = jax.jit(lambda q_: jd.decode_attention(q_, kq, vq, ks, jnp.asarray(lengths), v_scale=vs,
                                                    return_lse=True, **kw))(jnp.asarray(q))
    to, tl = td.decode_attention(torch.from_numpy(q), _torch(kq), _torch(vq), _torch(ks), torch.from_numpy(lengths),
                                 v_scale=_torch(vs), return_lse=True, **kw)
    _close(to, tl, jo, jl)


PAGED = {
    # name: (mode, d, page, T)
    "int8-d96-p8-t1": ("int8", 96, 8, 1), "int4-d80-p16-t4": ("int4", 80, 16, 4),
    "k4v8-int-qk-d96-p8-t4": ("k4v8-int-qk", 96, 8, 4), "bf16-d80-p16-t1": ("bf16", 80, 16, 1),
}


@pytest.mark.parametrize("case", list(PAGED))
def test_paged_decode_off_ladder_matches_jax(case):
    """The paged cache at head dims 80 and 96: a shuffled pool, lengths 0,
    two pages, the whole table and one inside a page; every page no walk
    visits holds NaN scales (and NaN rows in a bf16 pool)."""
    mode, d, page, t = PAGED[case]
    k_bits, v_bits, compute = MODES[mode]
    b, h, hk, width = 4, 8, 2, 8
    rng = np.random.default_rng(d + page + t)
    n_pages = b * width + 3
    quant = jax.jit(jd.quantize_token, static_argnames="bits")
    kq, ks = (np.array(x) for x in quant(jnp.asarray(rng.standard_normal((hk, n_pages, page, d)), jnp.float32),
                                        bits=k_bits))
    vq, vs = (np.array(x) for x in quant(jnp.asarray(rng.standard_normal((hk, n_pages, page, d)), jnp.float32),
                                        bits=v_bits))
    table = rng.permutation(n_pages)[: b * width].reshape(b, width).astype(np.int32)
    lengths = np.array([0, 2 * page, width * page, 3 * page + 5], np.int32)
    visited = {int(table[i, p]) for i, n in enumerate(lengths) for p in range(-(-int(n) // page))}
    dead = np.array(sorted(set(range(n_pages)) - visited))
    for arr, bits in ((kq, k_bits), (vq, v_bits)):
        if bits == 16:
            arr[:, dead] = np.nan
    ks[:, dead] = np.nan
    vs[:, dead] = np.nan
    if k_bits == 16:
        kq, vq = jnp.asarray(kq, jnp.bfloat16), jnp.asarray(vq, jnp.bfloat16)
    q = rng.standard_normal((b, t, h, d) if t > 1 else (b, h, d)).astype(np.float32)
    vs_opt = vs if v_bits != 16 else None
    kw = dict(k_bits=k_bits, v_bits=v_bits, compute_mode=compute, return_lse=True)
    jfn = jax.jit(functools.partial(jd.decode_attention, **kw))
    jo, jl = jfn(jnp.asarray(q), jnp.asarray(kq), jnp.asarray(vq), jnp.asarray(ks), jnp.asarray(lengths),
                 v_scale=None if vs_opt is None else jnp.asarray(vs_opt), page_table=jnp.asarray(table))
    to, tl = td.decode_attention(torch.from_numpy(q), _torch(jnp.asarray(kq)), _torch(jnp.asarray(vq)),
                                 torch.from_numpy(ks), torch.from_numpy(lengths),
                                 v_scale=None if vs_opt is None else torch.from_numpy(vs_opt),
                                 page_table=torch.from_numpy(table), **kw)
    _close(to, tl, jo, jl)


# ---------------------------------------------------------------------------
# Tiny LLMs at head dims 96 and 80
# ---------------------------------------------------------------------------

SHAPES = {96: dict(dim=384, depth=2, num_heads=4, num_kv_heads=2, max_seq=64),
          80: dict(dim=320, depth=2, num_heads=4, num_kv_heads=2, max_seq=64)}
CACHES = {"int8": dict(kv_bits=8), "k4v8": dict(kv_bits=8, k_bits=4)}


def _bf16_tree(tree):
    """A numpy f32 tree rounded to bf16, as JAX's bf16 params."""
    return jax.tree_util.tree_map(lambda x: jnp.asarray(x, jnp.bfloat16), tree)


@functools.lru_cache(maxsize=None)
def _model(d):
    """JAX's tiny LLM params at head dim d from numpy (JAX's init
    distributions: dense N(0, 1/d_in), embed N(0, 0.02^2), norms ones) and
    the port's model of them."""
    cfg = SHAPES[d]
    rng = np.random.default_rng(d)
    dim, kv = cfg["dim"], cfg["num_kv_heads"] * d

    def dense(i, o):
        return (rng.standard_normal((i, o)) / np.sqrt(i)).astype(np.float32)

    blocks = [{"wq": dense(dim, dim), "wk": dense(dim, kv), "wv": dense(dim, kv), "wo": dense(dim, dim),
               "w1": dense(dim, 4 * dim), "w2": dense(4 * dim, dim), "ln1": np.ones(dim, np.float32),
               "ln2": np.ones(dim, np.float32)} for _ in range(cfg["depth"])]
    params = _bf16_tree({"embed": (rng.standard_normal((256, dim)) * 0.02).astype(np.float32), "blocks": blocks,
                         "ln_f": np.ones(dim, np.float32)})
    tree = jax.tree_util.tree_map(lambda x: np.array(x.astype(jnp.float32)), params)
    model = TL.params_from_jax(tree, TL.tiny_llm_config(**cfg, dtype=torch.bfloat16), device="cpu")
    return params, model


@pytest.mark.parametrize("d,cache", [(96, "int8"), (80, "k4v8")])
def test_off_ladder_llm_prefill_and_decode_match_jax(d, cache):
    """llm_prefill (kernel A pads the head dim to 128) and 4 decode steps
    (kernel D at the head dim itself): head_dim 96 on the int8 cache, 80 on
    the k4v8 cache (4-bit rows of 40 bytes)."""
    params, model = _model(d)
    cfg_j = JL.tiny_llm_config(**SHAPES[d], dtype=jnp.bfloat16, **CACHES[cache])
    cfg_t = TL.tiny_llm_config(**SHAPES[d], dtype=torch.bfloat16, **CACHES[cache])
    assert cfg_t.head_dim == d
    tokens = np.random.default_rng(d).integers(0, 256, (2, 40)).astype(np.int32)
    j_logits, j_caches = jax.jit(lambda p, t: JL.llm_prefill(p, t, cfg_j))(params, jnp.asarray(tokens))
    t_logits, t_caches = TL.llm_prefill(model, torch.from_numpy(tokens), cfg_t)
    assert float(cosine_similarity(t_logits.float(), torch.from_numpy(_np(j_logits)))) >= LLM_COS
    bound = LLM_COS_4BIT if cfg_t.eff_k_bits == 4 else LLM_COS
    feed = np.random.default_rng(d + 1).integers(0, 256, (4, 2)).astype(np.int32)
    step = jax.jit(lambda p, t, c: JL.llm_decode_step(p, t, c, cfg_j))
    for i in range(4):
        j_logits, j_caches = step(params, jnp.asarray(feed[i]), j_caches)
        t_logits, t_caches = TL.llm_decode_step(model, torch.from_numpy(feed[i]), t_caches, cfg_t)
        assert float(cosine_similarity(t_logits.float(), torch.from_numpy(_np(j_logits)))) >= bound, i
    assert t_caches[0]["length"].tolist() == [44, 44]
    assert tuple(t_caches[0]["k"].shape) == (2, 2, 64, d // 2 if cfg_t.eff_k_bits == 4 else d)


# ---------------------------------------------------------------------------
# fp32 PV with bf16 QK at head_dim 256
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("causal", [True, False])
def test_fp32_pv_bf16_qk_d256_matches_jax(causal):
    """pv_dtype=float32 with bf16 Q and K at head_dim 256 (the kernel's
    64-key tiles, one stage of the ring on the card) against JAX's
    lowbit_attention_km with pv_dtype=jnp.float32: f32 grade."""
    rng = np.random.default_rng(70 + causal)
    q = rng.standard_normal((1, 4, 200, 256)).astype(np.float32)
    k = (rng.standard_normal((1, 2, 200, 256)) + 0.3).astype(np.float32)
    v = rng.standard_normal((1, 2, 200, 256)).astype(np.float32)
    b16 = lambda x: jnp.asarray(x, jnp.bfloat16)  # noqa: E731
    jo, jl = jattn.lowbit_attention_km(jnp.swapaxes(b16(q), 2, 3), b16(k), jnp.swapaxes(jnp.asarray(v), 2, 3),
                                       pv_dtype=jnp.float32, out_dtype=jnp.float32, is_causal=causal,
                                       return_lse=True)
    to, tl = lowbit_attention(torch.from_numpy(q).bfloat16(), torch.from_numpy(k).bfloat16(), torch.from_numpy(v),
                              pv_dtype=torch.float32, out_dtype=torch.float32, is_causal=causal, return_lse=True)
    assert to.dtype == torch.float32
    _close(to, tl, jnp.swapaxes(jo, 2, 3), jl, cos_min=0.99999, max_do=F32_MAX_DO, max_dlse=F32_MAX_DLSE)


# ---------------------------------------------------------------------------
# Checkpoints
# ---------------------------------------------------------------------------


def _jax_pair(kind):
    """A tiny JAX model's bf16 params and the port's model of them."""
    if kind == "llm":
        params, model = _model(96)
        return params, model
    rng = np.random.default_rng(5)

    def dense(i, o):
        return {"w": rng.standard_normal((i, o)).astype(np.float32), "b": rng.standard_normal(o).astype(np.float32)}

    params = _bf16_tree({"t_embed": {"in": dense(32, 32), "out": dense(32, 32)},
                         "blocks": [{"qkv": dense(64, 192), "proj": dense(64, 64), "mlp_in": dense(64, 256),
                                     "mlp_out": dense(256, 64), "ada": dense(32, 384)} for _ in range(2)],
                         "final": dense(64, 64)})
    cfg_t = TD.DiTConfig(dim=64, depth=2, num_heads=2, time_embed_dim=32, dtype=torch.bfloat16)
    tree = jax.tree_util.tree_map(lambda x: np.array(x.astype(jnp.float32)), params)
    return params, TD.params_from_jax(tree, cfg_t, device="cpu")


def _same_files(a, b):
    with np.load(a) as x, np.load(b) as y:
        assert sorted(x.files) == sorted(y.files)
        for key in x.files:
            assert x[key].dtype == y[key].dtype and x[key].shape == y[key].shape, key
            assert x[key].tobytes() == y[key].tobytes(), key


@pytest.mark.parametrize("kind", ["llm", "dit"])
def test_params_files_round_trip_with_jax(kind, tmp_path):
    """save_params of the port's model writes JAX's file (the same keys and
    bits as JAX's save_params of the same weights), JAX's load_params reads
    it back to the bf16 params, and the port's load_params reads JAX's file
    to the same weights."""
    params, model = _jax_pair(kind)
    tckpt.save_params(str(tmp_path / "port.npz"), model)
    jckpt.save_params(str(tmp_path / "jax.npz"), params)
    _same_files(tmp_path / "port.npz", tmp_path / "jax.npz")
    back = jckpt.load_params(str(tmp_path / "port.npz"), params)
    for x, y in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(params)):
        assert x.dtype == y.dtype and np.array_equal(_np(x), _np(y))
    loaded = tckpt.load_params(str(tmp_path / "jax.npz"), model)
    assert type(loaded) is type(model)
    for (name, x), (_, y) in zip(loaded.state_dict().items(), model.state_dict().items()):
        assert x.dtype == y.dtype and torch.equal(x, y), name


@pytest.mark.parametrize("codes", ["int8", "int4-range"])
def test_quantized_cache_files_round_trip_with_jax(codes, tmp_path):
    """save_quantized_cache writes JAX's arrays and meta file for the same
    cache (codes within [-7, 7] packed two a byte), and each side reads the
    other's file back to the cache, bit for bit."""
    rng = np.random.default_rng(11)
    lim = 127 if codes == "int8" else 7
    cache = {"k": rng.integers(-lim, lim + 1, (2, 2, 64, 96)).astype(np.int8),
             "v": rng.integers(-lim, lim + 1, (2, 2, 64, 96)).astype(np.int8),
             "k_scale": rng.random((2, 2, 64)).astype(np.float32),
             "v_scale": rng.random((2, 2, 64)).astype(np.float32),
             "length": np.array([40, 44], np.int32)}
    tckpt.save_quantized_cache(str(tmp_path / "port.npz"), {k: torch.from_numpy(v) for k, v in cache.items()})
    jckpt.save_quantized_cache(str(tmp_path / "jax.npz"), {k: jnp.asarray(v) for k, v in cache.items()})
    _same_files(tmp_path / "port.npz", tmp_path / "jax.npz")
    with open(tmp_path / "port.npz.meta.json") as f, open(tmp_path / "jax.npz.meta.json") as g:
        text = f.read()
        assert text == g.read() and json.loads(text)["k"]["packed"] == (codes != "int8")
    from_jax = tckpt.load_quantized_cache(str(tmp_path / "jax.npz"), device="cpu")
    from_port = jckpt.load_quantized_cache(str(tmp_path / "port.npz"))
    for name, want in cache.items():
        assert from_jax[name].dtype == torch.from_numpy(want).dtype
        assert np.array_equal(from_jax[name].numpy(), want) and np.array_equal(np.asarray(from_port[name]), want)
