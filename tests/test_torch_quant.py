"""Port parity: INT8 quantization (kernel C1) of the PyTorch package against
the JAX package. Inputs are made with numpy from a seed and handed to both
sides; the JAX kernel runs in Pallas interpret mode on the CPU, the port runs
its plain version. Codes AND scales must be equal, bit for bit."""

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
