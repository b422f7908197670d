"""Port parity: the quantized KV cache ops and decode attention (kernel D) of
the PyTorch package against the JAX package.

Inputs come from numpy with a seed and go to both sides. JAX runs its Pallas
decode kernel in interpret mode on the CPU; the port runs its plain version.

* ``quantize_token``/``append_kv``/``init_kv_cache`` at 16, 8 and 4 bits
  (4: nibbles in halves of D) and ``_unpack4_cols``: codes and scales bit
  for bit, against the JAX functions as they run compiled (``jax.jit``),
  including exact .5 ties and the rows past the written length. Compiled
  XLA forms the scale ``amax/qmax + 1e-7`` as one fma; JAX run op by op
  divides and then adds, which moves ~28% of scales by one ulp
  (test_jax_eager_scale_is_not_the_fma).
* ``decode_attention``: both sides compute in f32 and differ only in
  summation order (JAX online over blocks of up to 2048 keys, and at 4-bit K
  two half-width dots, the port in closed form): cos >= 0.999999, max|do|
  <= 2e-6 and max|dlse| <= 1e-5 on outputs of magnitude ~1 (measured on a
  CPU: max|do| <= 3.9e-7, max|dlse| <= 9.6e-7, the int4 and k4v8 caches on
  both QK chains included). bf16 queries give bf16 outputs, equal here.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lowbit_quant_fa2_paddle_tpu.ops import decode as jd
from lowbit_quant_fa2_paddle_tpu_torch.ops import decode as td
from lowbit_quant_fa2_paddle_tpu_torch.ops.metrics import cosine_similarity
from lowbit_quant_fa2_paddle_tpu_torch.ops.quant import absmax_scale

# One intra-op thread: the suite runs a worker per core, and torch's thread
# pool, spinning under that load, slowed small CPU ops up to 50-fold.
torch.set_num_threads(1)

COS_MIN, MAX_DO, MAX_DLSE = 0.999999, 2e-6, 1e-5


def _np(x) -> np.ndarray:
    return np.array(x.astype(jnp.float32) if x.dtype == jnp.bfloat16 else x)


def _torch(x) -> torch.Tensor:
    t = torch.from_numpy(_np(x))
    return t.to(torch.bfloat16) if x.dtype == jnp.bfloat16 else t


def _bits_equal(port: torch.Tensor, want) -> None:
    """Same dtype class and the same bits."""
    assert port.dtype == (torch.bfloat16 if want.dtype == jnp.bfloat16 else torch.from_numpy(np.array(want)).dtype)
    got = port.float().numpy() if port.dtype == torch.bfloat16 else port.numpy()
    exp = _np(want)
    assert got.shape == exp.shape
    np.testing.assert_array_equal(got.view(np.uint8), exp.view(np.uint8))


def _rows_with_ties(rng, shape, bits=8):
    """f32 rows whose ``bits``-bit quantization hits exact .5 ties: after the
    row maximum fixes the scale, some entries are set to (n + 0.5) * scale
    wherever the f32 division gives n + 0.5 back exactly."""
    x = (rng.standard_normal(shape) * 3).astype(np.float32)
    flat = x.reshape(-1, shape[-1])
    amax = np.abs(flat).max(axis=1)
    scale = absmax_scale(torch.from_numpy(amax)[:, None], bits)[:, 0].numpy()
    top = 120 if bits == 8 else 6
    ties = 0
    for i in range(flat.shape[0]):
        for j in rng.choice(np.arange(1, shape[-1]), size=8, replace=False):
            n = int(rng.integers(-top, top))
            y = np.float32(n + 0.5) * scale[i]
            if abs(y) < amax[i] and y / scale[i] == np.float32(n + 0.5) and np.abs(flat[i]).argmax() != j:
                flat[i, j] = y
                ties += 1
    return x, ties


@pytest.mark.parametrize("bits", [8, 16, 4])
def test_quantize_token_matches_jax(bits):
    x, ties = _rows_with_ties(np.random.default_rng(0), (3, 2, 40, 64), 4 if bits == 4 else 8)
    assert ties > 100
    jc, js = jax.jit(lambda a: jd.quantize_token(a, bits=bits))(jnp.asarray(x))
    tc, ts = td.quantize_token(torch.from_numpy(x), bits=bits)
    _bits_equal(tc, jc)
    _bits_equal(ts, js)


def test_quantize_token_rounds_ties_away_from_zero():
    scale = absmax_scale(torch.tensor([[127.0]]))[0, 0]
    x = torch.stack([torch.tensor(127.0), 0.5 * scale, -0.5 * scale, torch.tensor(0.0)])[None]
    codes, got = td.quantize_token(x)
    assert float(got[0]) == float(scale)
    assert codes.tolist() == [[127, 1, -1, 0]]  # torch.round gives 0 and -0


def test_quantize_token_4bit_packs_halves_of_d():
    """qmax 7, codes clipped to ±7 and rounded half away from zero, byte i
    holding column i in its low nibble and column i + D/2 in its high one."""
    scale = absmax_scale(torch.tensor([[7.0]]), 4)[0, 0]
    row = torch.tensor([7.0, -2.5 * float(scale), 0.5 * float(scale), 0.0, 3.0, -7.0, 1.5 * float(scale), -0.5 * float(scale)])
    packed, got = td.quantize_token(row[None], bits=4)
    assert float(got[0]) == float(scale) and packed.dtype == torch.int8 and packed.shape == (1, 4)
    assert td._unpack4_cols(packed).tolist() == [[7.0, -3.0, 1.0, 0.0, 3.0, -7.0, 2.0, -1.0]]
    assert (packed.view(torch.uint8)[0] & 0xF).tolist() == [7, 13, 1, 0]  # -3 as a nibble is 13


def test_jax_eager_scale_is_not_the_fma():
    """JAX run op by op computes ``amax / 127`` and then ``+ 1e-7`` (two
    roundings); compiled, XLA emits one fma. The port follows the compiled
    form everywhere, so it matches JAX's decode (jitted) bit for bit, and
    JAX's eager prefill up to one ulp of some scales (ROADMAP Queue 3)."""
    x = (np.random.default_rng(1).standard_normal((4, 3, 500, 64)) * 3).astype(np.float32)
    eager = np.asarray(jd.quantize_token(jnp.asarray(x))[1])
    jitted = np.asarray(jax.jit(jd.quantize_token)(jnp.asarray(x))[1])
    port = td.quantize_token(torch.from_numpy(x))[1].numpy()
    np.testing.assert_array_equal(port, jitted)
    differ = eager != jitted
    assert 0.05 < differ.mean() < 0.6
    assert np.abs(eager.view(np.int32) - jitted.view(np.int32)).max() == 1


@pytest.mark.parametrize("bits", [8, 16, 4, "k4v8"])
def test_append_kv_matches_jax(bits):
    """Three appends at lengths 0, 4 and S_max: the last row writes clamp to
    row S_max - 1 as ``dynamic_update_slice`` does; rows past the written
    length keep their initial zeros and ones."""
    rng = np.random.default_rng(2)
    b, hk, s_max, d = 3, 2, 6, 64
    lengths = np.array([0, 4, s_max], np.int32)
    sides = dict(k_bits=4, v_bits=8) if bits == "k4v8" else dict(bits=bits)
    jc = jd.init_kv_cache(b, hk, s_max, d, **sides)
    jc["length"] = jnp.asarray(lengths)
    tc = td.init_kv_cache(b, hk, s_max, d, **sides, device="cpu")
    tc["length"] = torch.from_numpy(lengths.copy())
    append = jax.jit(jd.append_kv)
    for _ in range(3):
        k, _ = _rows_with_ties(rng, (b, hk, d), 4 if bits in (4, "k4v8") else 8)
        v = (rng.standard_normal((b, hk, d)) * 2).astype(np.float32)
        jc = append(jc, jnp.asarray(k), jnp.asarray(v))
        tc = td.append_kv(tc, torch.from_numpy(k), torch.from_numpy(v))
    for key in ("k", "v", "k_scale", "v_scale", "length"):
        _bits_equal(tc[key], jc[key])
    assert tc["length"].tolist() == [3, 7, 9]


@pytest.mark.parametrize("sides", [dict(bits=4), dict(k_bits=4, v_bits=8), dict(k_bits=8, v_bits=4),
                                   dict(k_bits=4, v_bits=16), dict(bits=8)])
def test_init_kv_cache_matches_jax(sides):
    """Packed ``[B, Hk, S, D/2]`` int8 zeros for a 4-bit side, ``D`` wide for
    8 bits, bf16 for 16; f32 unit scales and int32 zero lengths."""
    jc = jd.init_kv_cache(2, 3, 5, 64, **sides)
    tc = td.init_kv_cache(2, 3, 5, 64, **sides, device="cpu")
    assert set(tc) == set(jc)
    for key in jc:
        _bits_equal(tc[key], jc[key])


def test_unpack4_cols_matches_jax():
    """Every byte value, sign-extended low and high nibbles in halves of D."""
    packed = np.random.default_rng(3).permutation(np.arange(-128, 128, dtype=np.int8)).reshape(4, 2, 32)
    got = td._unpack4_cols(torch.from_numpy(packed))
    assert got.dtype == torch.float32
    _bits_equal(got, jax.jit(jd._unpack4_cols)(jnp.asarray(packed)))


def _decode_inputs(b, h, hk, d, s, k_bits, v_bits, seed):
    rng = np.random.default_rng(seed)
    k = rng.standard_normal((b, hk, s, d)).astype(np.float32)
    v = rng.standard_normal((b, hk, s, d)).astype(np.float32)
    q = rng.standard_normal((b, h, d)).astype(np.float32)
    quant = jax.jit(jd.quantize_token, static_argnames="bits")
    kq, ks = quant(jnp.asarray(k), bits=k_bits)
    vq, vs = quant(jnp.asarray(v), bits=v_bits)
    lengths = np.array([s, 0, 1, 137][:b], np.int32)
    return q, kq, vq, ks, vs, lengths


@pytest.mark.parametrize(
    "k_bits,v_bits,h,hk,d,s,mode,lse",
    [
        (8, 8, 8, 2, 32, 300, "auto", True),   # GQA 8q/2kv, S_max not a multiple of the JAX block (384)
        (8, 8, 4, 4, 64, 300, "auto", False),  # MHA
        (8, 8, 8, 2, 128, 300, "auto", True),
        (16, 16, 8, 2, 32, 300, "auto", False),
        (16, 16, 4, 4, 64, 300, "auto", True),
        (16, 16, 8, 2, 128, 300, "auto", True),
        (8, 8, 4, 4, 64, 2500, "auto", True),  # five JAX blocks of 512, the last ragged
        (8, 16, 8, 2, 64, 300, "auto", True),  # int8 K, bf16 V
        (8, 8, 8, 2, 64, 300, "f32", True),    # int8 K on the float chain
    ],
)
def test_decode_attention_matches_jax(k_bits, v_bits, h, hk, d, s, mode, lse):
    q, kq, vq, ks, vs, lengths = _decode_inputs(4, h, hk, d, s, k_bits, v_bits, seed=d + s + k_bits)
    kw = dict(k_bits=k_bits, v_bits=v_bits, compute_mode=mode, return_lse=lse)
    jout = jd.decode_attention(jnp.asarray(q), kq, vq, ks, jnp.asarray(lengths), v_scale=vs, **kw)
    tout = td.decode_attention(torch.from_numpy(q), _torch(kq), _torch(vq), _torch(ks), torch.from_numpy(lengths),
                               v_scale=_torch(vs), **kw)
    jo, to = (jout[0], tout[0]) if lse else (jout, tout)
    jo = torch.from_numpy(_np(jo))
    assert to.dtype == torch.float32 and to.shape == (4, h, d) and torch.isfinite(to).all()
    assert float(cosine_similarity(to, jo)) >= COS_MIN
    assert float((to - jo).abs().max()) <= MAX_DO
    assert float(to[1].abs().max()) == 0.0  # length 0: no visible key
    if lse:
        jl, tl = torch.from_numpy(_np(jout[1])), tout[1]
        assert tl.shape == (4, h)
        assert float((tl - jl).abs().max()) <= MAX_DLSE
        assert torch.all(tl[1] == torch.tensor(-1e30))


@pytest.mark.parametrize(
    "k_bits,v_bits,h,hk,d,s,mode",
    [
        (4, 4, 8, 2, 32, 300, "auto"),      # int4, GQA 8q/2kv; "auto" is the float chain at 4-bit K
        (4, 4, 4, 4, 64, 300, "auto"),      # MHA
        (4, 4, 8, 2, 128, 300, "auto"),
        (4, 4, 8, 2, 64, 300, "int_qk"),    # the integer chain: q quantized, nibble dots exact
        (4, 4, 4, 4, 128, 300, "int_qk"),
        (4, 4, 4, 4, 64, 2500, "auto"),     # five JAX blocks of 512, the last ragged
        (4, 8, 8, 2, 32, 300, "auto"),      # k4v8
        (4, 8, 4, 4, 64, 300, "auto"),
        (4, 8, 8, 2, 128, 300, "auto"),
        (4, 8, 8, 2, 128, 300, "int_qk"),
        (4, 8, 8, 2, 32, 300, "int_qk"),
        (4, 8, 4, 4, 64, 2500, "int_qk"),
        (8, 4, 8, 2, 64, 300, "auto"),      # int8 K, 4-bit V
        (4, 16, 8, 2, 64, 300, "auto"),     # 4-bit K, bf16 V
    ],
)
def test_decode_attention_4bit_matches_jax(k_bits, v_bits, h, hk, d, s, mode):
    """The int4 and k4v8 caches (and the other mixes) on both QK chains,
    against JAX's Pallas kernel in interpret mode, with the bounds of
    test_decode_attention_matches_jax."""
    q, kq, vq, ks, vs, lengths = _decode_inputs(4, h, hk, d, s, k_bits, v_bits, seed=d + s + 3 * k_bits + v_bits)
    kw = dict(k_bits=k_bits, v_bits=v_bits, compute_mode=mode, return_lse=True)
    jo, jl = jd.decode_attention(jnp.asarray(q), kq, vq, ks, jnp.asarray(lengths), v_scale=vs, **kw)
    to, tl = td.decode_attention(torch.from_numpy(q), _torch(kq), _torch(vq), _torch(ks), torch.from_numpy(lengths),
                                 v_scale=_torch(vs), **kw)
    jo, jl = torch.from_numpy(_np(jo)), torch.from_numpy(_np(jl))
    assert to.dtype == torch.float32 and to.shape == (4, h, d) and torch.isfinite(to).all()
    assert float(cosine_similarity(to, jo)) >= COS_MIN
    assert float((to - jo).abs().max()) <= MAX_DO
    assert float((tl - jl).abs().max()) <= MAX_DLSE
    assert float(to[1].abs().max()) == 0.0 and torch.all(tl[1] == torch.tensor(-1e30))


def test_decode_attention_4bit_chains_agree_where_exact():
    """At 4-bit K the integer chain quantizes q and the float chain does not:
    the two differ by q's rounding only (cos >= 0.999), and each equals the
    plain version on the unpacked codes as an int8 cache."""
    q, kq, vq, ks, vs, lengths = _decode_inputs(4, 8, 2, 64, 300, 4, 8, seed=11)
    args = [torch.from_numpy(q), _torch(kq), _torch(vq), _torch(ks), torch.from_numpy(lengths)]
    f_chain = td.decode_attention(*args, v_scale=_torch(vs), k_bits=4, v_bits=8)
    i_chain = td.decode_attention(*args, v_scale=_torch(vs), k_bits=4, v_bits=8, compute_mode="int_qk")
    assert float(cosine_similarity(f_chain, i_chain)) >= 0.999 and not torch.equal(f_chain, i_chain)
    k8 = td._unpack4_cols(args[1]).to(torch.int8)
    i8 = td.decode_attention(args[0], k8, *args[2:], v_scale=_torch(vs), kv_bits=8)
    torch.testing.assert_close(i_chain, i8, rtol=0, atol=0)
    f8 = td.decode_attention(args[0], k8, *args[2:], v_scale=_torch(vs), kv_bits=8, compute_mode="f32")
    torch.testing.assert_close(f_chain, f8, rtol=0, atol=0)


def test_decode_attention_bf16_query_matches_jax():
    q, kq, vq, ks, vs, lengths = _decode_inputs(4, 8, 2, 128, 300, 8, 8, seed=3)
    jo = jd.decode_attention(jnp.asarray(q, jnp.bfloat16), kq, vq, ks, jnp.asarray(lengths), v_scale=vs)
    to = td.decode_attention(torch.from_numpy(q).bfloat16(), _torch(kq), _torch(vq), _torch(ks),
                             torch.from_numpy(lengths), v_scale=_torch(vs))
    assert to.dtype == torch.bfloat16
    np.testing.assert_array_equal(to.float().numpy(), _np(jo))


def test_decode_attention_ignores_rows_past_length():
    """Stale rows past the length (as after a rollback) change nothing."""
    q, kq, vq, ks, vs, lengths = _decode_inputs(4, 8, 2, 64, 200, 16, 16, seed=4)
    args = [torch.from_numpy(q), _torch(kq), _torch(vq), _torch(ks), torch.from_numpy(lengths)]
    clean = td.decode_attention(*args, kv_bits=16)
    k2, v2 = args[1].clone(), args[2].clone()
    for i, n in enumerate(lengths):
        k2[i, :, n:] = float("nan")
        v2[i, :, n:] = float("inf")
    stale = td.decode_attention(args[0], k2, v2, *args[3:], kv_bits=16)
    torch.testing.assert_close(stale, clean, rtol=0, atol=0)


@pytest.mark.parametrize("bad", [dict(kv_bits=2), dict(k_bits=4, v_bits=6)])
def test_unknown_cache_bits_raise(bad):
    with pytest.raises(ValueError, match="16, 8 or 4"):
        td.init_kv_cache(1, 2, 8, 64, device="cpu", **{("bits" if k == "kv_bits" else k): v for k, v in bad.items()})
    q, kq, vq, ks, vs, lengths = _decode_inputs(4, 4, 4, 32, 64, 8, 8, seed=5)
    with pytest.raises(ValueError, match="16, 8 or 4"):
        td.decode_attention(torch.from_numpy(q), _torch(kq), _torch(vq), _torch(ks), torch.from_numpy(lengths),
                            v_scale=_torch(vs), **bad)


@pytest.mark.parametrize("cache_bits,said", [(8, dict(kv_bits=4)), (4, dict(kv_bits=8)), (16, dict(k_bits=4))])
def test_cache_width_must_match_the_bits(cache_bits, said):
    """A 4-bit side is D/2 bytes wide: a cache whose width or dtype does not
    match the bits the caller names raises instead of reading garbage."""
    q, kq, vq, ks, vs, lengths = _decode_inputs(4, 4, 4, 32, 64, cache_bits, cache_bits, seed=5)
    with pytest.raises((ValueError, TypeError)):
        td.decode_attention(torch.from_numpy(q), _torch(kq), _torch(vq), _torch(ks), torch.from_numpy(lengths),
                            v_scale=_torch(vs), **said)


def test_decode_attention_takes_cpu_or_cuda_only():
    q = torch.zeros(1, 2, 64, device="meta")
    k = torch.zeros(1, 2, 8, 64, dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        td.decode_attention(q, k, k, torch.ones(1, 2, 8, device="meta"),
                            torch.ones(1, dtype=torch.int32, device="meta"), kv_bits=16)


@pytest.mark.parametrize(
    "s_max,ctas,slots,want",
    [(32768, 32, 528, (16, 2048)), (32768, 32, 264, (8, 4096)), (300, 8, 528, None), (64, 1, 528, None),
     (100000, 4096, 264, None),
     # kernel D's occupancies on the H100 (1 to 3 CTAs an SM of 132)
     (32768, 1, 396, (64, 512)), (32768, 32, 132, (4, 8192)), (32768, 32, 396, (12, 2752)),
     (4096, 32, 264, (8, 512)), (128, 128, 396, (2, 64))],
)
def test_split_plan_fills_whole_waves(s_max, ctas, slots, want):
    """Whole 64-key multiples covering S_max, at most WAVES whole waves of
    resident CTAs, at most MAX_SPLITS splits (the merging CTA keeps a
    weight per split and warp)."""
    n, chunk = td.num_splits(s_max, ctas, slots)
    assert chunk % td.KV_TILE == 0 and n >= 1
    assert (n - 1) * chunk < s_max <= n * chunk
    assert n == 1 or n * ctas <= td.WAVES * slots
    assert n <= td.MAX_SPLITS
    if want is not None:
        assert (n, chunk) == want


@pytest.mark.parametrize("k_int8,v_int8,int_qk", [(True, True, True), (True, True, False), (True, False, True),
                                                  (False, False, False), (False, True, False)])
def test_kernel_design_by_mode(k_int8, v_int8, int_qk):
    """Kernel D has one design for every cache type and QK chain, and
    counts its launches by it."""
    assert td.kernel_design(k_int8, v_int8, int_qk) == "bulk_ring"
    assert td.DESIGNS == ("bulk_ring",)
    assert set(td.decode_attention.launches_by_design) == set(td.DESIGNS)


def test_kernel_design_needs_int8_k_for_the_integer_chain():
    with pytest.raises(ValueError, match="int8 K"):
        td.kernel_design(False, True, True)


@pytest.mark.parametrize("bits", [8, 16, 4])
@pytest.mark.parametrize("where", ["tile-127-128-129", "split-boundary"])
def test_decode_lengths_at_tile_and_split_edges_match_jax(bits, where):
    """Lengths around a 128-key boundary and around a split boundary of the
    plan (S_max 600 over 8 (batch, KV head) rows on 264 resident CTAs: 64-key
    splits), against the JAX function jitted."""
    b, h, hk, d, s = 4, 8, 2, 64, 600
    if where == "split-boundary":
        chunk = td.num_splits(s, b * hk, 264)[1]
        lengths = np.array([chunk - 1, chunk, chunk + 1, 2 * chunk + 1], np.int32)
    else:
        lengths = np.array([127, 128, 129, s], np.int32)
    q, kq, vq, ks, vs, _ = _decode_inputs(b, h, hk, d, s, bits, bits, seed=7 + bits)
    jfn = jax.jit(lambda *a: jd.decode_attention(*a[:5], v_scale=a[5], k_bits=bits, v_bits=bits, return_lse=True))
    jo, jl = jfn(jnp.asarray(q), kq, vq, ks, jnp.asarray(lengths), vs)
    to, tl = td.decode_attention(torch.from_numpy(q), _torch(kq), _torch(vq), _torch(ks), torch.from_numpy(lengths),
                                 v_scale=_torch(vs), kv_bits=bits, return_lse=True)
    jo = torch.from_numpy(_np(jo))
    assert float(cosine_similarity(to, jo)) >= COS_MIN
    assert float((to - jo).abs().max()) <= MAX_DO
    assert float((tl - torch.from_numpy(_np(jl))).abs().max()) <= MAX_DLSE


@pytest.mark.parametrize("group,rows", [(1, 1), (4, 4), (8, 8), (12, 6), (16, 8), (7, 7), (9, 3)])
def test_rows_per_cta_divides_the_group(group, rows):
    assert td.rows_per_cta(group) == rows


def test_lengths_past_the_cache_count_as_its_size():
    """An append at ``length == S_max`` overwrites row S_max - 1 and leaves
    ``length = S_max + 1``. The port reads such a length as S_max. JAX pads
    the cache to its block (here 300 -> 384) with zero codes and zero
    scales, and counts the padded row at position 300 as a visible key with
    logit 0 (ROADMAP Queue 3)."""
    q, kq, vq, ks, vs, _ = _decode_inputs(2, 4, 4, 64, 300, 8, 8, seed=6)
    args = [_torch(kq), _torch(vq), _torch(ks)]
    over, full = (torch.tensor([n, n], dtype=torch.int32) for n in (301, 300))
    t_over = td.decode_attention(torch.from_numpy(q), *args, over, v_scale=_torch(vs), return_lse=True)
    t_full = td.decode_attention(torch.from_numpy(q), *args, full, v_scale=_torch(vs), return_lse=True)
    torch.testing.assert_close(t_over, t_full, rtol=0, atol=0)
    j_over = jd.decode_attention(jnp.asarray(q), kq, vq, ks, jnp.asarray(over.numpy()), v_scale=vs, return_lse=True)
    j_full = jd.decode_attention(jnp.asarray(q), kq, vq, ks, jnp.asarray(full.numpy()), v_scale=vs, return_lse=True)
    assert float((torch.from_numpy(_np(j_full[1])) - t_full[1]).abs().max()) <= MAX_DLSE
    # JAX: one more key of weight 2^(0 - m) enters l, so its LSE grows.
    assert float((torch.from_numpy(_np(j_over[1])) - t_over[1]).min()) > 1e-4


@pytest.mark.parametrize("buf_dtype,width,bits", [(torch.int8, 64, 8), (torch.int8, 32, 4), (torch.bfloat16, 64, 16)])
def test_cache_bits_matches_jax(buf_dtype, width, bits):
    j_buf = jnp.zeros((1, 1, 2, width), jnp.int8 if buf_dtype == torch.int8 else jnp.bfloat16)
    assert jd.cache_bits(j_buf, jnp.zeros((1, 1, 64))) == bits
    assert td.cache_bits(torch.zeros(1, 1, 2, width, dtype=buf_dtype), torch.zeros(1, 1, 64)) == bits


# ---------------------------------------------------------------------------
# Kernel D's window / sink walk and its logit cap
# ---------------------------------------------------------------------------

WINDOW_MODES = {"int8": (8, 8, "auto"), "bf16": (16, 16, "auto"), "int4": (4, 4, "auto"),
                "int4-int-qk": (4, 4, "int_qk"), "k4v8": (4, 8, "auto"), "k4v8-int-qk": (4, 8, "int_qk")}
WINDOW_OPTIONS = {
    "window64": dict(window_size=64),
    "window64-sink4": dict(window_size=64, sink_size=4),
    "window100-sink150": dict(window_size=100, sink_size=150),  # the sinks at and past the window's start
    "cap1.5": dict(logit_cap=1.5),
    "window100-sink8-cap2": dict(window_size=100, sink_size=8, logit_cap=2.0),
}


@pytest.mark.parametrize("opts", list(WINDOW_OPTIONS))
@pytest.mark.parametrize("mode", list(WINDOW_MODES))
def test_decode_window_and_cap_match_jax(mode, opts):
    """decode_attention with a window, window + sinks and the logit cap, on
    the int8, bf16, int4 and k4v8 caches and both QK chains, against JAX's
    kernel in interpret mode (its compacted walk), at the file's bounds.
    Lengths: shorter than the window, a window start inside a 64-key tile
    (300 - 64 = 236), one at a tile edge (192 - 64 = 128), and 0."""
    k_bits, v_bits, compute_mode = WINDOW_MODES[mode]
    q, kq, vq, ks, vs, _ = _decode_inputs(4, 8, 2, 64, 300, k_bits, v_bits, seed=k_bits + 5 * v_bits)
    lengths = np.array([40, 300, 192, 0], np.int32)
    kw = dict(k_bits=k_bits, v_bits=v_bits, compute_mode=compute_mode, return_lse=True, **WINDOW_OPTIONS[opts])
    jo, jl = jd.decode_attention(jnp.asarray(q), kq, vq, ks, jnp.asarray(lengths), v_scale=vs, **kw)
    to, tl = td.decode_attention(torch.from_numpy(q), _torch(kq), _torch(vq), _torch(ks), torch.from_numpy(lengths),
                                 v_scale=_torch(vs), **kw)
    jo, jl = torch.from_numpy(_np(jo)), torch.from_numpy(_np(jl))
    assert to.shape == (4, 8, 64) and torch.isfinite(to).all()
    assert float(cosine_similarity(to, jo)) >= COS_MIN
    assert float((to - jo).abs().max()) <= MAX_DO
    assert float((tl - jl).abs().max()) <= MAX_DLSE
    assert float(to[3].abs().max()) == 0.0 and torch.all(tl[3] == torch.tensor(-1e30))


@pytest.mark.parametrize("d", [32, 128])
def test_decode_window_matches_jax_at_other_head_dims(d):
    q, kq, vq, ks, vs, _ = _decode_inputs(4, 8, 2, d, 500, 8, 8, seed=d)
    lengths = np.array([500, 129, 64, 65], np.int32)
    kw = dict(window_size=128, sink_size=64, return_lse=True)
    jo, jl = jd.decode_attention(jnp.asarray(q), kq, vq, ks, jnp.asarray(lengths), v_scale=vs, **kw)
    to, tl = td.decode_attention(torch.from_numpy(q), _torch(kq), _torch(vq), _torch(ks), torch.from_numpy(lengths),
                                 v_scale=_torch(vs), **kw)
    assert float((to - torch.from_numpy(_np(jo))).abs().max()) <= MAX_DO
    assert float((tl - torch.from_numpy(_np(jl))).abs().max()) <= MAX_DLSE


def test_decode_window_reads_only_the_window_and_the_sinks():
    """Rows outside [len - W, len) and [0, sink) change nothing, whatever
    they hold (the kernel never loads them)."""
    q, kq, vq, ks, vs, _ = _decode_inputs(4, 8, 2, 64, 300, 16, 16, seed=9)
    lengths = np.array([300, 200, 100, 50], np.int32)
    args = [torch.from_numpy(q), _torch(kq), _torch(vq), _torch(ks), torch.from_numpy(lengths)]
    kw = dict(kv_bits=16, window_size=40, sink_size=8)
    clean = td.decode_attention(*args, **kw)
    k2, v2 = args[1].clone(), args[2].clone()
    for i, n in enumerate(lengths):
        k2[i, :, 8 : n - 40] = float("nan")
        v2[i, :, 8 : n - 40] = float("inf")
    stale = td.decode_attention(args[0], k2, v2, *args[3:], **kw)
    torch.testing.assert_close(stale, clean, rtol=0, atol=0)


def test_decode_window_as_long_as_the_cache_is_no_window():
    q, kq, vq, ks, vs, lengths = _decode_inputs(4, 8, 2, 64, 300, 8, 8, seed=10)
    args = [torch.from_numpy(q), _torch(kq), _torch(vq), _torch(ks), torch.from_numpy(lengths)]
    a = td.decode_attention(*args, v_scale=_torch(vs), return_lse=True)
    b = td.decode_attention(*args, v_scale=_torch(vs), window_size=300, sink_size=4, return_lse=True)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("window,sink,want", [(64, 0, 2 * 64), (100, 0, 3 * 64), (4096, 0, 65 * 64),
                                              (4096, 4, 66 * 64), (8192, 128, 131 * 64), (100, 200, 7 * 64)])
def test_windowed_split_plan_depends_on_the_window_not_the_cache(window, sink, want):
    """A windowed call plans its splits over sink tiles + ceil(W / 64) + 1
    tiles of 64 keys: the same plan for a 32K and a 128K cache (it reads no
    length), unlike the full walk's, which covers S_max."""
    assert td.window_keys(window, sink) == want
    plans = {s_max: td.split_plan(s_max, 32, 396, window, sink) for s_max in (32768, 131072)}
    assert len(set(plans.values())) == 1
    n, chunk = plans[32768]
    assert (n - 1) * chunk < want <= n * chunk and chunk % td.KV_TILE == 0
    assert td.split_plan(32768, 32, 396) != td.split_plan(131072, 32, 396)


@pytest.mark.parametrize("kw,match", [(dict(window_size=-1), "window_size"), (dict(logit_cap=-2.0), "logit_cap")])
def test_bad_decode_options_raise(kw, match):
    q, kq, vq, ks, vs, lengths = _decode_inputs(4, 4, 4, 32, 64, 8, 8, seed=5)
    with pytest.raises(ValueError, match=match):
        td.decode_attention(torch.from_numpy(q), _torch(kq), _torch(vq), _torch(ks), torch.from_numpy(lengths),
                            v_scale=_torch(vs), **kw)
