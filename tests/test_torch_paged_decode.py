"""Port parity: kernel D over the paged KV cache (``page_table``) against the
JAX package's paged ``decode_attention``.

Inputs come from numpy with a seed and go to both sides: a pool of pages
``[Hk, n_pages, page, Dc]`` shared by the batch through a shuffled table, JAX
running its Pallas kernel in interpret mode (its block is the page), the port
its plain version (the visited pages gathered into a contiguous cache). Every
page that no sequence's walk visits — the pool's spare pages, a sequence's
pages past its length, pages below its window — holds NaN codes' scales (and
NaN rows in a bf16 cache), so a read of one shows in the output.

* Float PV: both sides compute in f32 and differ only in summation order,
  so the contiguous file's bounds hold (cos >= 0.999999, max|do| <= 2e-6,
  max|dlse| <= 1e-5).
* INT8 PV (``compute_mode="int"``): P is requantized per tile, JAX's tile
  being the page and the port's kernel D's 64 keys, so the codes come from
  other maxima: the speculative file's bounds (max|do| <= 3e-2, cos >=
  0.9999, max|dlse| <= 1e-5).
* The port's paged call equals its contiguous call on the same rows bit for
  bit (the plain version gathers, then runs the contiguous walk).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lowbit_quant_fa2_paddle_tpu.ops import decode as jd
from lowbit_quant_fa2_paddle_tpu_torch.ops import decode as td
from lowbit_quant_fa2_paddle_tpu_torch.ops.metrics import cosine_similarity

# One intra-op thread: the suite runs a worker per core, and torch's thread
# pool, spinning under that load, slowed small CPU ops up to 50-fold.
torch.set_num_threads(1)

COS_MIN, MAX_DO, MAX_DLSE = 0.999999, 2e-6, 1e-5
PV8_COS_MIN, PV8_MAX_DO = 0.9999, 3e-2
#: Cache modes: (k_bits, v_bits, compute_mode).
MODES = {"int8": (8, 8, "auto"), "int4": (4, 4, "auto"), "k4v8": (4, 8, "auto"), "bf16": (16, 16, "auto"),
         "int4-int-qk": (4, 4, "int_qk"), "int8-pv8": (8, 8, "int")}
OPTS = {"full": {}, "window24-sink4": dict(window_size=24, sink_size=4)}
B, H, HK, D, W = 4, 8, 2, 64, 8  # W: table width (pages a sequence may hold)


def _pool(page, k_bits, v_bits, t, opts, seed):
    """A shuffled pool and table, lengths 0, two pages, the whole table and
    one inside a page; every unvisited page NaN (see the module note)."""
    rng = np.random.default_rng(seed)
    n_pages = B * W + 3
    quant = jax.jit(jd.quantize_token, static_argnames="bits")
    kq, ks = (np.array(x) for x in quant(jnp.asarray(rng.standard_normal((HK, n_pages, page, D)), jnp.float32),
                                        bits=k_bits))
    vq, vs = (np.array(x) for x in quant(jnp.asarray(rng.standard_normal((HK, n_pages, page, D)), jnp.float32),
                                        bits=v_bits))
    table = rng.permutation(n_pages)[: B * W].reshape(B, W).astype(np.int32)
    lengths = np.array([0, 2 * page, W * page, 3 * page + 5], np.int32)
    window, sink = opts.get("window_size", 0), opts.get("sink_size", 0)
    visited = set()
    for i, n in enumerate(lengths):
        for lo, hi in td.walk_rows(int(n), W * page, window=window, sink=sink, q_tokens=t):
            if hi > lo:
                visited |= {int(table[i, p]) for p in range(lo // page, -(-hi // page))}
    dead = np.array(sorted(set(range(n_pages)) - visited))
    assert dead.size > 3
    for arr, bits in ((kq, k_bits), (vq, v_bits)):
        if bits == 16:
            arr[:, dead] = np.nan
    ks[:, dead] = np.nan
    vs[:, dead] = np.nan
    q = rng.standard_normal((B, t, H, D)).astype(np.float32)
    return q, kq, vq, ks, vs, lengths, table


def _to_torch(x):
    if x.dtype == jnp.bfloat16:
        return torch.from_numpy(np.array(x, np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(x))


@pytest.mark.parametrize("opts", list(OPTS), ids=list(OPTS))
@pytest.mark.parametrize("t", [1, 4])
@pytest.mark.parametrize("page", [8, 16])
@pytest.mark.parametrize("mode", ["int8", "int4", "k4v8"])
def test_paged_decode_matches_jax(mode, page, t, opts):
    k_bits, v_bits, compute = MODES[mode]
    q, kq, vq, ks, vs, lengths, table = _pool(page, k_bits, v_bits, t, OPTS[opts], seed=page + t)
    qj = q[:, 0] if t == 1 else q
    kw = dict(k_bits=k_bits, v_bits=v_bits, compute_mode=compute, return_lse=True, **OPTS[opts])
    jfn = jax.jit(functools.partial(jd.decode_attention, **kw))
    jo, jl = jfn(jnp.asarray(qj), jnp.asarray(kq), jnp.asarray(vq), jnp.asarray(ks), jnp.asarray(lengths),
                 v_scale=jnp.asarray(vs), page_table=jnp.asarray(table))
    to, tl = td.decode_attention(torch.from_numpy(qj), _to_torch(kq), _to_torch(vq), _to_torch(ks),
                                 torch.from_numpy(lengths), v_scale=_to_torch(vs),
                                 page_table=torch.from_numpy(table), **kw)
    jo, jl = np.array(jo), np.array(jl)
    assert to.shape == jo.shape and tl.shape == jl.shape
    assert np.isfinite(to.numpy()).all() and np.isfinite(tl.numpy()).all()
    assert float(cosine_similarity(to, torch.from_numpy(jo))) >= COS_MIN
    assert np.abs(to.numpy() - jo).max() <= MAX_DO
    assert np.abs(tl.numpy() - jl).max() <= MAX_DLSE


@pytest.mark.parametrize("mode", ["bf16", "int4-int-qk", "int8-pv8"])
def test_paged_decode_other_modes_match_jax(mode):
    """The bf16 pool, the integer QK chain at 4-bit K and INT8 PV, at page
    16, T 4, under a window with sinks."""
    k_bits, v_bits, compute = MODES[mode]
    opts = OPTS["window24-sink4"]
    q, kq, vq, ks, vs, lengths, table = _pool(16, k_bits, v_bits, 4, opts, seed=7)
    if k_bits == 16:
        kq, vq = jnp.asarray(kq, jnp.bfloat16), jnp.asarray(vq, jnp.bfloat16)
        ks = np.where(np.isnan(ks), np.nan, 1.0).astype(np.float32)
    kw = dict(k_bits=k_bits, v_bits=v_bits, compute_mode=compute, return_lse=True, **opts)
    jfn = jax.jit(functools.partial(jd.decode_attention, **kw))
    vs_j = jnp.asarray(vs) if v_bits != 16 else None
    jo, jl = jfn(jnp.asarray(q), jnp.asarray(kq), jnp.asarray(vq), jnp.asarray(ks), jnp.asarray(lengths),
                 v_scale=vs_j, page_table=jnp.asarray(table))
    to, tl = td.decode_attention(torch.from_numpy(q), _to_torch(kq), _to_torch(vq), _to_torch(ks),
                                 torch.from_numpy(lengths), v_scale=_to_torch(vs) if v_bits != 16 else None,
                                 page_table=torch.from_numpy(table), **kw)
    jo, jl = np.array(jo), np.array(jl)
    assert np.isfinite(to.numpy()).all()
    cos_min, max_do = (PV8_COS_MIN, PV8_MAX_DO) if compute == "int" else (COS_MIN, MAX_DO)
    assert float(cosine_similarity(to, torch.from_numpy(jo))) >= cos_min
    assert np.abs(to.numpy() - jo).max() <= max_do
    assert np.abs(tl.numpy() - jl).max() <= MAX_DLSE


@pytest.mark.parametrize("mode", list(MODES))
def test_paged_equals_contiguous_on_the_same_rows(mode):
    """The paged plain version is the contiguous one over the gathered rows,
    bit for bit, INT8 PV's walk over ``W·page`` rows included."""
    k_bits, v_bits, compute = MODES[mode]
    opts = OPTS["window24-sink4"]
    q, kq, vq, ks, vs, lengths, table = _pool(8, k_bits, v_bits, 2, opts, seed=11)
    tk, tv, tks, tvs = (_to_torch(x) for x in (kq, vq, ks, vs))
    if k_bits == 16:
        tk, tv = tk.to(torch.bfloat16), tv.to(torch.bfloat16)
    tbl = torch.from_numpy(table).long()

    def contiguous(x):  # [Hk, n_pages, page, ..] -> [B, Hk, W * page, ..] through the table, NaN pages zeroed
        x = torch.nan_to_num(x, nan=0.0) if x.is_floating_point() else x
        return x[:, tbl].transpose(0, 1).reshape((B, HK, W * 8) + tuple(x.shape[3:]))

    kw = dict(k_bits=k_bits, v_bits=v_bits, compute_mode=compute, return_lse=True, **opts)
    lens = torch.from_numpy(lengths)
    vs_t = tvs if v_bits != 16 else None
    po, pl = td.decode_attention(torch.from_numpy(q), tk, tv, tks, lens, v_scale=vs_t,
                                 page_table=torch.from_numpy(table), **kw)
    co, cl = td.decode_attention(torch.from_numpy(q), contiguous(tk), contiguous(tv), contiguous(tks), lens,
                                 v_scale=contiguous(vs_t) if vs_t is not None else None, **kw)
    torch.testing.assert_close(po, co, rtol=0, atol=0)
    torch.testing.assert_close(pl, cl, rtol=0, atol=0)


def test_gather_pages_reads_only_the_walk():
    """The gather reads the table only at the visited pages: entries past a
    sequence's used pages may name any page, or none (-1)."""
    q, kq, vq, ks, vs, lengths, table = _pool(8, 8, 8, 1, {}, seed=3)
    tbl = table.copy()
    for i, n in enumerate(lengths):
        tbl[i, -(-int(n) // 8):] = -1
    args = [torch.from_numpy(x) for x in (q[:, 0], kq, vq, ks)]
    lens = torch.from_numpy(lengths)
    a = td.decode_attention(*args, lens, v_scale=torch.from_numpy(vs), page_table=torch.from_numpy(table))
    b = td.decode_attention(*args, lens, v_scale=torch.from_numpy(vs), page_table=torch.from_numpy(tbl))
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert torch.isfinite(a).all() and bool((a[0] == 0).all())  # length 0: o = 0


@pytest.mark.parametrize("bad,match", [
    (dict(page=12), "power of two"),
    (dict(page=0), "power of two"),
    (dict(table_dtype=torch.int64), "page_table"),
    (dict(table_rows=3), "page_table"),
    (dict(scale_shape=(HK, 9, 8)), "k_scale"),
])
def test_paged_decode_checks_its_arguments(bad, match):
    page = bad.get("page", 8)
    q = torch.zeros(B, H, D)
    k = torch.zeros(HK, 10, page, D, dtype=torch.int8)
    ks = torch.ones(bad.get("scale_shape", (HK, 10, page)))
    table = torch.zeros(bad.get("table_rows", B), 2, dtype=bad.get("table_dtype", torch.int32))
    with pytest.raises(ValueError, match=match):
        td.decode_attention(q, k, k.clone(), ks, torch.zeros(B, dtype=torch.int32), v_scale=torch.ones(HK, 10, page),
                            page_table=table)
