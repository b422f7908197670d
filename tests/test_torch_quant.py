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
