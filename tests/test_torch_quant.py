"""Port parity: quantization (kernels C1, C2, C3) of the PyTorch package
against the JAX package. Inputs are made with numpy from a seed and handed to
both sides; the JAX kernels run in Pallas interpret mode on the CPU, the port
runs its plain versions. INT8 and INT4 codes AND scales must be equal, bit for
bit. INT2 scales carry an rms: the port sums the squares in f64 (the
correctly rounded rms), JAX in f32 in XLA's order, so they are held to a few
ulp and the codes to equality away from the rounding boundary (see
``test_quant_int2_matches_jax``)."""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lowbit_quant_fa2_paddle_tpu.ops import quant as jq
from lowbit_quant_fa2_paddle_tpu_torch.ops import quant as tq

# One intra-op thread: the suite runs a worker per core, and torch's thread
# pool, spinning under that load, slowed small CPU ops up to 50-fold.
torch.set_num_threads(1)


def _both(x, km, gran, block):
    jc, js = jq.quant_int8(jnp.asarray(x), None if km is None else jnp.asarray(km), gran=gran, block=block)
    tc, ts = tq.quant_int8(torch.from_numpy(x), None if km is None else torch.from_numpy(km), gran=gran, block=block)
    return np.asarray(jc), np.asarray(js), tc.numpy(), ts.numpy()


@pytest.mark.parametrize(
    "gran,block,s,with_km",
    [
        ("per_token", 128, 256, False),
        ("per_token", 128, 300, True),  # ragged S
        ("per_block", 64, 256, True),
        ("per_block", 64, 300, True),  # ragged edge block: rows past S enter as -km
        ("per_block", 128, 200, False),
    ],
)
def test_quant_int8_matches_jax(gran, block, s, with_km):
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((1, 3, s, 64)) * 2).astype(np.float32)
    km = (rng.standard_normal((1, 3, 1, 64)) * 3).astype(np.float32) if with_km else None
    jc, js, tc, ts = _both(x, km, gran, block)
    assert tc.dtype == np.int8 and tc.shape == x.shape and ts.shape == x.shape[:3]
    np.testing.assert_array_equal(tc, jc)
    np.testing.assert_array_equal(ts.view(np.uint32), js.view(np.uint32))


def test_quant_int8_bf16_input_matches_jax():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 2, 130, 64)).astype(np.float32)
    jc, js = jq.quant_int8(jnp.asarray(x, jnp.bfloat16), gran="per_token")
    tc, ts = tq.quant_int8(torch.from_numpy(x).bfloat16(), gran="per_token")
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


def test_quant_int8_rounds_ties_away_from_zero():
    """Rows built so that x/scale lands exactly on k + 0.5: round half away
    from zero (torch.round alone would round half to even)."""
    rng = np.random.default_rng(2)
    s, d = 64, 64
    x = np.clip(rng.standard_normal((1, 1, s, d)), -2.5, 2.5).astype(np.float32)
    x[..., 0] = (3.0 + rng.random((1, 1, s))).astype(np.float32)  # the row absmax
    scale = tq.absmax_scale(torch.from_numpy(np.abs(x).max(-1))).numpy()
    n_ties = 0
    for r in range(s):
        for j, k in enumerate([0.5, 1.5, 2.5, 5.5, -0.5, -3.5, 10.5, 60.5]):
            val = np.float32(k * np.float64(scale[0, 0, r]))
            if abs(val) < x[0, 0, r, 0] and np.float64(val) == k * np.float64(scale[0, 0, r]):
                x[0, 0, r, 1 + j] = val
                n_ties += 1
    assert n_ties > 100
    jc, js, tc, ts = _both(x, None, "per_token", 128)
    np.testing.assert_array_equal(ts, js)
    np.testing.assert_array_equal(tc, jc)
    assert (tc[0, 0, :, 1] == 1).all()  # 0.5 -> 1, not 0
    ties = torch.tensor([0.5, 1.5, 2.5, -0.5, -2.5, 0.49999997])
    assert tq.round_away(ties).tolist() == [1.0, 2.0, 3.0, -1.0, -3.0, 0.0]


def test_k_mean_matches_jax():
    rng = np.random.default_rng(3)
    k = rng.standard_normal((2, 3, 333, 64)).astype(np.float32) + 0.5
    want = np.asarray(jq.k_mean(jnp.asarray(k)))
    got = tq.k_mean(torch.from_numpy(k)).numpy()
    assert got.shape == (2, 3, 1, 64)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


def test_quant_int8_rejects_bad_input():
    with pytest.raises(ValueError):
        tq.quant_int8(torch.zeros(1, 1, 4, 64), gran="per_channel")
    with pytest.raises(ValueError):
        tq.quant_int8(torch.zeros(1, 1, 4, 64), torch.zeros(1, 1, 4, 64))


@pytest.mark.parametrize("block", [0, 1, 64])
def test_quant_reference_math_matches_jax(block):
    """The quantization oracles of ops/reference.py, port vs JAX."""
    from lowbit_quant_fa2_paddle_tpu.ops import reference as jr
    from lowbit_quant_fa2_paddle_tpu_torch.ops import reference as tr

    x = np.random.default_rng(4).standard_normal((1, 2, 100, 64)).astype(np.float32)
    jc, js = jr.quant_symmetric_ref(jnp.asarray(x), block=block)
    tc, ts = tr.quant_symmetric_ref(torch.from_numpy(x), block=block)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-6)
    jd = jr.dequant_symmetric_ref(jc, js, block=block)
    td = tr.dequant_symmetric_ref(tc, ts, block=block)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-6)
    if block == 0:
        jg = jr.quant_group_asym_ref(jnp.asarray(x), bits=4, group=32)
        tg = tr.quant_group_asym_ref(torch.from_numpy(x), bits=4, group=32)
        np.testing.assert_array_equal(tg[0].numpy(), np.asarray(jg[0]))
        np.testing.assert_allclose(
            tr.dequant_group_asym_ref(*tg, group=32).numpy(),
            np.asarray(jr.dequant_group_asym_ref(*jg, group=32)), rtol=1e-5, atol=1e-6)


def _pair(x, km, dtype):
    jx = jnp.asarray(x, jnp.bfloat16 if dtype == "bf16" else jnp.float32)
    tx = torch.from_numpy(x).to(torch.bfloat16 if dtype == "bf16" else torch.float32)
    jkm = None if km is None else jnp.asarray(km)
    tkm = None if km is None else torch.from_numpy(km)
    return jx, jkm, tx, tkm


def _lowbit_inputs(gran, with_km, d, seed):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((1, 4, 300, d)) * 2).astype(np.float32)  # ragged S = 300
    km = (rng.standard_normal((1, 4, 1, d)) * 3).astype(np.float32) if with_km else None
    return x, km, ("per_token", 128) if gran == "per_token" else ("per_block", 64)


@pytest.mark.parametrize("gran,with_km,dtype,d", list(itertools.product(
    ["per_token", "per_block"], [False, True], ["f32", "bf16"], [64, 128])))
def test_quant_int4_matches_jax(gran, with_km, dtype, d):
    """Kernel C2: packed bytes and scales bit-equal to JAX (the scale is the
    fma form ``fma(amax, f32(1/7), 1e-7)``, as for INT8)."""
    x, km, (g, block) = _lowbit_inputs(gran, with_km, d, seed=10 + d)
    jx, jkm, tx, tkm = _pair(x, km, dtype)
    jc, js = jq.quant_int4(jx, jkm, gran=g, block=block)
    tc, ts = tq.quant_int4(tx, tkm, gran=g, block=block)
    assert tc.dtype == torch.int8 and tuple(tc.shape) == (1, 4, 300, d // 2) and tuple(ts.shape) == (1, 4, 300)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(ts.numpy().view(np.uint32), np.asarray(js).view(np.uint32))


@pytest.mark.parametrize("gran,with_km,dtype,d", list(itertools.product(
    ["per_token", "per_block"], [False, True], ["f32", "bf16"], [64, 128])))
def test_quant_int2_matches_jax(gran, with_km, dtype, d):
    """Kernel C3. The scale is ``1.224·rms + EPS`` with the rms of a row (D
    squares) or of a block (64·D). JAX sums the squares in f32 in XLA's
    order; the port in f64. Measured on a CPU: at most 3 ulp apart per token
    and 9 per block (the f32 sum's error grows with the count), so the bounds
    are 4 and 16 ulp. Codes are equal except where ``|x/scale|`` lies within
    1e-5 of the 0.5 boundary, where an ulp of scale may flip them; such
    elements are counted and must be rare."""
    x, km, (g, block) = _lowbit_inputs(gran, with_km, d, seed=20 + d)
    jx, jkm, tx, tkm = _pair(x, km, dtype)
    jc, js = jq.quant_int2(jx, jkm, gran=g, block=block)
    tc, ts = tq.quant_int2(tx, tkm, gran=g, block=block)
    assert tc.dtype == torch.int8 and tuple(tc.shape) == (1, 4, 300, d // 4)
    js, ts = np.asarray(js), ts.numpy()
    ulps = np.abs(js.view(np.int32).astype(np.int64) - ts.view(np.int32).astype(np.int64)).max()
    assert ulps <= (4 if gran == "per_token" else 16), ulps
    jcodes, tcodes = np.asarray(jq.unpack_int2(jc)), tq.unpack_int2(tc).numpy()
    assert set(np.unique(tcodes).tolist()) <= {-1, 0, 1}
    xs = tx.float().numpy() - (0.0 if km is None else km)
    near = np.abs(np.abs(xs / ts[..., None]) - 0.5) < 1e-5
    assert near.mean() < 1e-3
    np.testing.assert_array_equal(tcodes[~near], jcodes[~near])


@pytest.mark.parametrize("bits", [4, 2])
def test_unpack_matches_jax(bits):
    packed = np.random.default_rng(5).integers(-128, 128, (2, 3, 17, 16), dtype=np.int8)
    jf, tf = (jq.unpack_int4, tq.unpack_int4) if bits == 4 else (jq.unpack_int2, tq.unpack_int2)
    got = tf(torch.from_numpy(packed)).numpy()
    assert got.shape == (2, 3, 17, 16 * 8 // bits)
    np.testing.assert_array_equal(got, np.asarray(jf(jnp.asarray(packed))))
    np.testing.assert_array_equal(tq.pack_codes(torch.from_numpy(got), bits).numpy(), packed)


@pytest.mark.parametrize("smooth_v", [False, True])
def test_quant_v_int8_per_channel_matches_jitted_jax(smooth_v):
    """Plain ops on both sides; compiled JAX forms the scale as one fma (the
    DiT runs it under ``jit``), which the port follows: bit-equal without
    smooth-V. With it, the per-channel mean is an f32 sum of S values taken
    in another order, so the centred V, and through its absmax the scale,
    may move (measured: 23% of scales, by at most 2 ulp); codes then move
    by at most one step, at ties of ``v/scale``."""
    v = (np.random.default_rng(6).standard_normal((2, 3, 150, 64)) + 0.7).astype(np.float32)
    jf = jax.jit(lambda x: jq.quant_v_int8_per_channel(x, smooth_v=smooth_v))
    jc, js, jm = (None if a is None else np.asarray(a) for a in jf(jnp.asarray(v)))
    tc, ts, tm = tq.quant_v_int8_per_channel(torch.from_numpy(v), smooth_v=smooth_v)
    assert tc.dtype == torch.int8 and tuple(ts.shape) == (2, 3, 64)
    tc, ts = tc.numpy(), ts.numpy()
    if not smooth_v:
        assert tm is None and jm is None
        np.testing.assert_array_equal(ts, js)
        np.testing.assert_array_equal(tc, jc)
        return
    np.testing.assert_allclose(tm.numpy(), jm, rtol=1e-6, atol=1e-7)
    assert np.abs(ts.view(np.int32).astype(np.int64) - js.view(np.int32)).max() <= 2
    dc = np.abs(tc.astype(np.int32) - jc)
    assert dc.max() <= 1 and dc.mean() < 1e-3


def test_lowbit_quant_rejects_bad_input():
    with pytest.raises(ValueError, match="multiple of 4"):
        tq.quant_int2(torch.zeros(1, 1, 4, 66))
    with pytest.raises(ValueError, match="multiple of 2"):
        tq.quant_int4(torch.zeros(1, 1, 4, 63))
    with pytest.raises(ValueError):
        tq.quant_int4(torch.zeros(1, 1, 4, 64), gran="per_channel")


@pytest.mark.parametrize("case", ["bf16", "strided"])
def test_k_mean_bf16_and_strided_match_jax(case):
    """``k_mean`` reads K as it is, with no f32 copy: a bf16 K, and the DiT's
    K as a strided view of its qkv projection, against JAX's ``k_mean`` on
    the same values, at ``test_k_mean_matches_jax``'s tolerance."""
    rng = np.random.default_rng(7)
    b, s, h, d = 2, 333, 3, 64
    qkv = (rng.standard_normal((b, s, 3, h, d)) + 0.5).astype(np.float32)
    if case == "bf16":
        k = np.ascontiguousarray(qkv[:, :, 1].transpose(0, 2, 1, 3))
        jk, tk = jnp.asarray(k, jnp.bfloat16), torch.from_numpy(k).bfloat16()
    else:
        tk = torch.from_numpy(qkv)[:, :, 1].transpose(1, 2)
        assert not tk.is_contiguous()
        jk = jnp.asarray(np.ascontiguousarray(tk.numpy()))
    want = np.asarray(jq.k_mean(jk))
    got = tq.k_mean(tk).numpy()
    assert got.shape == (b, h, 1, d) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


def test_k_mean_then_quant_int8_codes_against_jax():
    """The main path's steps 1-2 through each package's own code: ``k_mean``
    of the DiT's bf16 K (a strided view of qkv on the port's side, with a
    per-channel mean; b1 h6 s2048 d64, cut from h30 s17776), then per-token
    ``quant_int8`` with that mean. The two means sum in other orders, so they
    differ in some channels (measured on a CPU: 116 of 384, by at most 2
    ulp), and with them a row's scale where its absmax channel differs (1537
    of 12,288 rows). Measured: 1 of 786,432 codes differs, by one step. Held
    to that share; every code is equal where the channel's two means agree
    bit for bit."""
    rng = np.random.default_rng(11)
    b, s, h, d = 1, 2048, 6, 64
    qkv = rng.standard_normal((b, s, 3, h, d)).astype(np.float32)
    qkv[:, :, 1] += rng.standard_normal((1, 1, h, d)).astype(np.float32) * 2  # K's per-channel mean
    tk = torch.from_numpy(qkv).bfloat16()[:, :, 1].transpose(1, 2)
    jk = jnp.asarray(np.ascontiguousarray(tk.float().numpy()), jnp.bfloat16)
    tkm, jkm = tq.k_mean(tk), jq.k_mean(jk)
    tc, _ = tq.quant_int8(tk, tkm, gran="per_token")
    jc, _ = jq.quant_int8(jk, jkm, gran="per_token")
    tkm, jkm = tkm.numpy(), np.asarray(jkm)
    np.testing.assert_allclose(tkm, jkm, rtol=1e-6, atol=1e-7)
    dc = np.abs(tc.numpy().astype(np.int32) - np.asarray(jc))
    assert dc.max() <= 1
    assert (dc > 0).mean() <= 1 / 786432
    same_km = np.broadcast_to(tkm.view(np.int32) == jkm.view(np.int32), dc.shape)
    assert not (dc[same_km] > 0).any()


def _dit_k_view(b, s, h, d, dtype=torch.bfloat16, seed=0):
    """K as the DiT hands it over: ``[B, H, S, hd]``, a view of the qkv
    projection ``[B, S, 3, H, hd]`` (row stride 3·H·hd)."""
    g = torch.Generator().manual_seed(seed)
    qkv = torch.randn(b, s, 3 * h * d, generator=g).to(dtype).reshape(b, s, 3, h, d)
    return qkv[:, :, 1].transpose(1, 2)


@pytest.mark.parametrize("case,want", [
    ("dit-k-view", "vector"),
    ("llm-prefill-k", "vector"),
    ("per-block-64-d64", "vector"),
    ("per-block-128-d128", "vector"),
    ("per-block-64-dit-k-view", "vector"),
    ("f16-d256", "vector"),
    ("f32-d128", "vector"),
    ("int2", "vector"),
    ("bf16-d40", "scalar"),
    ("misaligned-view", "scalar"),
    ("f32-d6", "scalar"),
    ("f32-d256", "scalar"),
    ("per-block-128-d256", "scalar"),
    ("per-block-16-d64", "scalar"),
])
def test_kernel_design_rule(case, want):
    """C1/C2/C3's design is chosen by shape, dtype, strides and alignment:
    the vector design reads every model path's K where it lies, at 8, 4 and
    2 bits; what it cannot read (a row that is not 4-32 lanes of 16 bytes,
    rows off 16 bytes, a block past its registers) goes to the scalar
    design."""
    bits, per_token, block = 8, True, 128
    if case == "dit-k-view":
        x = _dit_k_view(1, 50, 2, 64)
        assert not x.is_contiguous() and x.stride(2) == 3 * 2 * 64
    elif case == "llm-prefill-k":
        x = torch.zeros(4, 8, 40, 128, dtype=torch.bfloat16)
    elif case == "per-block-64-d64":
        x, per_token, block = torch.zeros(1, 2, 100, 64, dtype=torch.bfloat16), False, 64
    elif case == "per-block-128-d128":
        x, per_token, block = torch.zeros(1, 2, 100, 128, dtype=torch.bfloat16), False, 128
    elif case == "per-block-64-dit-k-view":
        x, per_token, block, bits = _dit_k_view(1, 50, 2, 64), False, 64, 4
    elif case == "f16-d256":
        x, bits = torch.zeros(1, 2, 10, 256, dtype=torch.float16), 4
    elif case == "f32-d128":
        x = torch.zeros(1, 2, 10, 128)
    elif case == "int2":
        x, bits = torch.zeros(1, 2, 10, 64, dtype=torch.bfloat16), 2
    elif case == "bf16-d40":
        x = torch.zeros(1, 2, 10, 40, dtype=torch.bfloat16)
    elif case == "misaligned-view":
        x = torch.zeros(1, 2, 10, 65, dtype=torch.bfloat16)[..., 1:]
        assert x.shape[-1] == 64 and x.data_ptr() % 16
    elif case == "f32-d6":
        x = torch.zeros(1, 2, 10, 6)
    elif case == "f32-d256":
        x = torch.zeros(1, 2, 10, 256)
    elif case == "per-block-128-d256":
        x, per_token = torch.zeros(1, 2, 10, 256, dtype=torch.bfloat16), False
    else:
        x, per_token, block = torch.zeros(1, 2, 100, 64, dtype=torch.bfloat16), False, 16
    assert tq.kernel_design(x, bits, per_token, block) == want


@pytest.mark.parametrize("bits,gran,block", [(8, "per_token", 128), (8, "per_block", 64), (4, "per_token", 128),
                                             (4, "per_block", 64), (8, "per_block", 128)])
def test_plain_versions_read_strided_views(bits, gran, block):
    """The plain versions of C1 and C2 give the same codes and scales on the
    DiT's strided K view as on its contiguous copy, per token and per block
    (ragged S = 50 against block 64/128), with the K mean."""
    x = _dit_k_view(1, 50, 2, 64, seed=bits)
    km = tq.k_mean(x)
    plain = tq.quant_int8_plain if bits == 8 else tq.quant_int4_plain
    got = plain(x, km, per_token=gran == "per_token", block=block)
    want = plain(x.contiguous(), km, per_token=gran == "per_token", block=block)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    via = (tq.quant_int8 if bits == 8 else tq.quant_int4)(x, km, gran=gran, block=block)
    assert torch.equal(via[0], want[0]) and torch.equal(via[1], want[1])


@pytest.mark.parametrize("d", [64, 128])
def test_int4_lane_packing_matches_pack_codes(d):
    """The vector design's INT4 packing, emulated lane by lane: lane t of a
    row's d/8 lanes holds the codes of columns 8t..8t+7 as bytes in two
    little-endian words (low nibbles); the words of lane t + lanes/2 (columns
    + d/2) arrive by one shuffle down and are or-ed in four bits up; the low
    half of the lanes store 8 bytes each at byte 8t. That equals
    ``pack_codes`` (byte i = column i | column i + d/2 << 4)."""
    lanes, e = d // 8, 8
    codes = np.random.default_rng(d).integers(-7, 8, (37, d)).astype(np.int8)
    words = (codes.astype(np.int64) & 0xF).astype(np.uint8).view(np.uint32).reshape(37, lanes, e // 4)
    got = np.zeros((37, d // 2), np.uint8)
    for t in range(lanes // 2):
        w = words[:, t] | (words[:, t + lanes // 2] << np.uint32(4))
        got[:, t * e:(t + 1) * e] = w.view(np.uint8).reshape(37, e)
    want = tq.pack_codes(torch.from_numpy(codes), 4).numpy().view(np.uint8)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("d", [32, 64, 128, 256])
def test_int2_lane_packing_matches_pack_codes(d):
    """The vector design's INT2 packing, emulated lane by lane for bf16 rows
    (lanes = d/8 of 8 columns): lane t holds the codes of columns 8t..8t+7 as
    bytes in two little-endian words (2 low bits each); one shuffle down by
    lanes/2 brings the words of lane t + lanes/2 (columns + d/2), or-ed in 4
    bits up; one down by lanes/4 then brings those of lane t + lanes/4
    (columns + d/4, with + 3d/4 from its first step), or-ed in 2 bits up;
    the lowest quarter of the lanes store 8 bytes each at byte 8t. A shuffle
    past the warp's last lane returns the lane's own word, unused. That
    equals ``pack_codes`` (bits 2p of byte i = column i + p*d/4)."""
    lanes, e, rows = d // 8, 8, 64
    codes = np.random.default_rng(d).integers(-1, 2, (rows, d)).astype(np.int8)
    words = (codes.astype(np.int64) & 0x3).astype(np.uint8).view(np.uint32).reshape(rows, lanes, e // 4)
    warp = words.reshape(-1, 32, e // 4)  # a warp holds 32 / lanes consecutive rows
    lane = np.arange(32)

    def shfl_down(w, delta):
        return w[:, np.where(lane + delta < 32, lane + delta, lane)]

    warp = warp | (shfl_down(warp, lanes // 2) << np.uint32(4))
    warp = warp | (shfl_down(warp, lanes // 4) << np.uint32(2))
    words = warp.reshape(rows, lanes, e // 4)
    got = np.zeros((rows, d // 4), np.uint8)
    for t in range(lanes // 4):
        got[:, t * e:(t + 1) * e] = words[:, t].view(np.uint8).reshape(rows, e)
    want = tq.pack_codes(torch.from_numpy(codes), 2).numpy().view(np.uint8)
    np.testing.assert_array_equal(got, want)


_MAGIC = np.float32(1.5 * 2**23)


def _round_away_np(x):
    t = np.trunc(x)
    return np.where(np.abs(x - t) >= np.float32(0.5), t + np.sign(x), t).astype(np.float32)


def _codes_by_reciprocal(v, s, qmax, bits):
    """``code_of`` of ``csrc/quant.cu``'s vector design in f32 numpy (every
    operation rounds once to nearest, as the intrinsics do): q0 = RN(v ·
    RN(1/s)); its nearest integer through 1.5·2^23; the IEEE division where
    q0 lies within 2^-15 of a half-integer; the clamped code out of the bits
    of c + 1.5·2^23. Returns the codes and the share that took the division."""
    q0 = v * (np.float32(1) / s)
    n = (q0 + _MAGIC) - _MAGIC
    exact = np.abs(q0 - n) > np.float32(0.5 - 2**-15)
    with np.errstate(divide="ignore", invalid="ignore"):
        n = np.where(exact, _round_away_np(v / s), n)
    c = np.clip(n, -qmax, qmax).astype(np.float32)
    return (c + _MAGIC).view(np.uint32) & np.uint32((1 << bits) - 1), float(exact.mean())


@pytest.mark.parametrize("bits", [8, 4, 2])
def test_reciprocal_codes_equal_division(bits):
    """The vector design's codes equal ``clamp(round_away(v / s))`` with the
    IEEE division for every v around each rounding boundary ±(k + 1/2)·s
    (k = 0 .. qmax + 1, 64 f32 ulps each side: for INT2 the 0.5 boundary is
    the only one below the clamp) and for uniform v in [-amax, amax], at
    scales of mantissa 1, 1 + ulp, 2 - ulp and random mantissas from 1e-7
    (EPS alone) to 1e36 (the largest absmax / 127), and the scales
    fma(amax, 1/qmax, 1e-7) of random absmax values (INT2: 1.224·rms + EPS
    of random rms)."""
    qmax = {8: 127, 4: 7, 2: 1}[bits]
    rng = np.random.default_rng(bits)
    mant = np.concatenate([[1.0, np.nextafter(np.float32(1), np.float32(2)), np.nextafter(np.float32(2), 1)],
                           1 + rng.random(29)]).astype(np.float32)
    exps = np.array([-23, -20, -9, -1, 0, 1, 7, 30, 119], np.float32)
    stat = torch.from_numpy(rng.random(64).astype(np.float32) * 50)
    formed = tq.rms_scale(stat.double() ** 2 * 64, 64) if bits == 2 else tq.absmax_scale(stat, bits)
    scales = np.concatenate([(mant[:, None] * np.exp2(exps)[None]).ravel(), formed.numpy(),
                             np.float32([1e-7])]).astype(np.float32)
    k = np.arange(qmax + 2, dtype=np.float64) + 0.5
    ulps = np.arange(-64, 65, dtype=np.int32)
    share = []
    for s in scales:
        mid = (k * np.float64(s)).astype(np.float32)
        near = (mid.view(np.int32)[:, None] + ulps[None]).view(np.float32).ravel()
        amax = np.float32(qmax * s)
        v = np.concatenate([near, -near, (rng.random(4096) * 2 - 1).astype(np.float32) * amax])
        got, _ = _codes_by_reciprocal(v, np.float32(s), np.float32(qmax), bits)
        want_c = np.clip(_round_away_np(v / np.float32(s)), -qmax, qmax).astype(np.int64) & ((1 << bits) - 1)
        np.testing.assert_array_equal(got.astype(np.int64), want_c, err_msg=f"scale {s!r}")
        share.append(_codes_by_reciprocal(v[2 * near.size:], np.float32(s), np.float32(qmax), bits)[1])
    # On uniform v the division is the rare path: ~2^-14 of the elements.
    assert float(np.mean(share)) < 1e-3
    # The code bits out of c + 1.5 * 2^23: the low byte is c's two's complement.
    c = np.arange(-qmax, qmax + 1, dtype=np.float32)
    np.testing.assert_array_equal((c + _MAGIC).view(np.uint32) & 0xFF, c.astype(np.int64) & 0xFF)
