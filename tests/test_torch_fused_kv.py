"""Port parity: attention over KIVI-grouped packed K/V (kernel E) and its
quantizer, against the JAX package on the same numpy inputs.

``quant_kv_grouped`` is bit-exact (op by op as JAX runs it; the sequence is
zero-padded to whole groups before the min and max). The attention runs the
kernel's plain version on the CPU and JAX's Pallas kernel in interpret mode.
The port rounds Q, K and V to bf16 for the tensor cores where JAX dots f32
Q and K, so it is held to cos >= 0.999 and max|do| <= 3e-2 (measured on a
CPU: cos >= 0.999998, max|do| <= 6e-3), and on K/V already on the 4-bit
grid to JAX's own ``atol=5e-3``.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lowbit_quant_fa2_paddle_tpu.ops import fused_kv as JF
from lowbit_quant_fa2_paddle_tpu_torch.ops import fused_kv as TF
from lowbit_quant_fa2_paddle_tpu_torch.ops.metrics import cosine_similarity

# One intra-op thread: the suite runs a worker per core, and torch's thread
# pool, spinning under that load, slowed small CPU ops up to 50-fold.
torch.set_num_threads(1)


def _qkv(seed, b, h, hk, sq, sk, d=64):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, h, sq, d)).astype(np.float32)
    k = (rng.standard_normal((b, hk, sk, d)) + 0.5).astype(np.float32)  # offset: zero-points matter
    v = (rng.standard_normal((b, hk, sk, d)) - 0.3).astype(np.float32)
    return q, k, v


def _both(q, k, v, bits, group, **kw):
    jk = JF.quant_kv_grouped(jnp.asarray(k), bits=bits, group=group)
    jv = JF.quant_kv_grouped(jnp.asarray(v), bits=bits, group=group)
    tk = TF.quant_kv_grouped(torch.from_numpy(k), bits=bits, group=group)
    tv = TF.quant_kv_grouped(torch.from_numpy(v), bits=bits, group=group)
    o_jax = JF.fused_packed_kv_attention(jnp.asarray(q), jk[0], jv[0], jk[1], jk[2], jv[1], jv[2], bits=bits,
                                         group=group, out_dtype=jnp.float32, **kw)
    o = TF.fused_packed_kv_attention(torch.from_numpy(q), tk[0], tv[0], tk[1], tk[2], tv[1], tv[2], bits=bits,
                                     group=group, out_dtype=torch.float32, **kw)
    return o, torch.from_numpy(np.array(o_jax))


@pytest.mark.parametrize("bits,group,s", [(4, 64, 400), (4, 128, 512), (2, 64, 400), (2, 256, 300)])
def test_quant_kv_grouped_bit_exact(bits, group, s):
    x = np.random.default_rng(0).standard_normal((2, 3, s, 64)).astype(np.float32) + 1.0
    jp, js, jm = JF.quant_kv_grouped(jnp.asarray(x), bits=bits, group=group)
    tp, ts, tm = TF.quant_kv_grouped(torch.from_numpy(x), bits=bits, group=group)
    assert tp.dtype == torch.int8 and tp.shape == (2, 3, s, 64 * bits // 8)
    assert ts.shape == (2, 3, math.ceil(s / group), 64)
    for t, j in ((tp, jp), (ts, js), (tm, jm)):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    np.testing.assert_array_equal(TF._unpack_unsigned(tp, bits).numpy(), np.asarray(JF._unpack_unsigned(jp, bits)))


def test_ragged_last_group_sees_the_padding_zeros():
    """All-positive rows: the ragged last group's min is the zero padding."""
    x = torch.full((1, 1, 300, 64), 2.0)
    x[:, :, 256:] += torch.arange(44.0)[:, None] / 44
    _, scale, mn = TF.quant_kv_grouped(x, bits=4, group=256)
    assert bool((mn[:, :, 1] == 0).all()) and bool((mn[:, :, 0] == 2).all())
    assert bool((scale[:, :, 0] == 1).all())  # a constant group: scale 0 becomes 1


@pytest.mark.parametrize(
    "bits,causal,b,h,hk,sq,sk",
    [(4, False, 1, 2, 2, 512, 512), (2, True, 1, 2, 2, 512, 512), (4, False, 1, 8, 2, 400, 400),
     (2, True, 1, 8, 2, 400, 400), (4, True, 2, 4, 2, 300, 520), (2, False, 2, 4, 2, 300, 520),
     (4, True, 1, 4, 2, 520, 300)],
)
def test_fused_kv_attention_matches_jax(bits, causal, b, h, hk, sq, sk):
    """GQA 8/2, ragged 400, Sq 300 vs Sk 520 and Sq 520 vs Sk 300 (causal
    is top-left aligned)."""
    o, want = _both(*_qkv(1, b, h, hk, sq, sk), bits, 256, is_causal=causal)
    assert o.shape == (b, h, sq, 64) and o.dtype == torch.float32
    assert float(cosine_similarity(o, want)) >= 0.999
    assert float((o - want).abs().max()) <= 3e-2


@pytest.mark.parametrize(
    "bits,causal,b,h,hk,sq,sk,d,group",
    [(4, False, 1, 4, 4, 200, 300, 64, 32), (2, True, 1, 4, 2, 300, 300, 64, 128),
     (4, True, 1, 8, 2, 700, 1000, 128, 256)],
)
def test_plain_version_at_the_wgmma_tile_edges_matches_jax(bits, causal, b, h, hk, sq, sk, d, group):
    """Groups smaller than kernel E's 128-key tile (32) and equal to it (128)
    with a ragged Sk 300, and causal GQA 8q/2kv d128 at Sq 700 / Sk 1000
    (JAX in interpret mode)."""
    o, want = _both(*_qkv(8, b, h, hk, sq, sk, d), bits, group, is_causal=causal)
    assert o.shape == (b, h, sq, d) and o.dtype == torch.float32
    assert float(cosine_similarity(o, want)) >= 0.999
    assert float((o - want).abs().max()) <= 3e-2


@pytest.mark.parametrize("bits", [4, 2])
def test_kernel_design_by_bits(bits):
    """Kernel E has one design, the same for both bit widths, and counts
    its launches by it."""
    assert TF.kernel_design(bits) == TF.kernel_design() == "wgmma"
    assert TF.DESIGNS == ("wgmma",)
    assert set(TF.fused_packed_kv_attention.launches_by_design) == set(TF.DESIGNS)
    with pytest.raises(ValueError, match="bits"):
        TF.kernel_design(8)


def test_group_64_and_kernel_space_is_a_no_op():
    q, k, v = _qkv(2, 2, 4, 2, 300, 520)
    o, want = _both(q, k, v, 4, 64, is_causal=True)
    assert float(cosine_similarity(o, want)) >= 0.999 and float((o - want).abs().max()) <= 3e-2
    o_k, want_k = _both(q, k, v, 4, 64, is_causal=True, kernel_space="k")
    assert torch.equal(o_k, o) and float(cosine_similarity(want_k, want)) > 0.9999


def test_exact_on_grid_values():
    """K/V already on the 4-bit grid: dequantization is exact, and the port
    meets JAX's own test tolerance against JAX."""
    rng = np.random.default_rng(4)
    q = rng.standard_normal((1, 2, 512, 64)).astype(np.float32)
    k = rng.integers(0, 16, (1, 2, 512, 64)).astype(np.float32) * 0.1 - 0.8
    v = rng.integers(0, 16, (1, 2, 512, 64)).astype(np.float32) * 0.05 - 0.4
    o, want = _both(q, k, v, 4, 256)
    np.testing.assert_allclose(o.numpy(), want.numpy(), atol=5e-3, rtol=1e-2)


def test_empty_rows_give_zero():
    """Rows whose every logit lies below the running-max floor (-1e30) keep
    l = 0 and come out as 0, in JAX as in the port."""
    q, k, v = _qkv(5, 1, 2, 2, 128, 256)
    q[:, :, :3] = -1e30
    k[:] = np.abs(k) + 1.0  # every q.k of those rows is below -1e30
    o, want = _both(q, k, v, 4, 256)
    assert float(o[:, :, :3].abs().max()) == 0.0 and float(want[:, :, :3].abs().max()) == 0.0
    assert float(cosine_similarity(o, want)) >= 0.999


def test_bf16_out_and_q():
    q, k, v = _qkv(6, 1, 4, 4, 200, 200)
    kp, ks, km = TF.quant_kv_grouped(torch.from_numpy(k), bits=4, group=256)
    vp, vs, vm = TF.quant_kv_grouped(torch.from_numpy(v), bits=4, group=256)
    o32 = TF.fused_packed_kv_attention(torch.from_numpy(q), kp, vp, ks, km, vs, vm, out_dtype=torch.float32)
    o16 = TF.fused_packed_kv_attention(torch.from_numpy(q).bfloat16(), kp, vp, ks, km, vs, vm)
    assert o16.dtype == torch.bfloat16
    assert torch.equal(o16, o32.bfloat16())  # q is rounded to bf16 either way


def test_bad_inputs_raise():
    q, k, v = _qkv(7, 1, 3, 2, 64, 64)
    kp, ks, km = TF.quant_kv_grouped(torch.from_numpy(k), bits=4, group=64)
    vp, vs, vm = TF.quant_kv_grouped(torch.from_numpy(v), bits=4, group=64)
    with pytest.raises(ValueError, match="GQA"):
        TF.fused_packed_kv_attention(torch.from_numpy(q), kp, vp, ks, km, vs, vm, group=64)
    q4 = torch.zeros(1, 4, 64, 64)
    with pytest.raises(ValueError, match="cover"):
        TF.fused_packed_kv_attention(q4, kp, vp, ks, km, vs, vm, group=32)
    with pytest.raises(ValueError, match="packed"):
        TF.fused_packed_kv_attention(q4, kp, vp, ks, km, vs, vm, group=64, bits=2)
    with pytest.raises(ValueError, match="kernel_space"):
        TF.fused_packed_kv_attention(q4, kp, vp, ks, km, vs, vm, group=64, kernel_space="t")
