"""Port parity: packed-weight matmuls (kernels F1/F2), their packing, the
host pack format and WQLinear, against the JAX package on the same numpy
inputs.

Packing is bit-exact: the port forms each scale as JAX run op by op does
(division, then the add). The matmuls run the kernels' plain versions on
the CPU and JAX's Pallas kernels in interpret mode; they compute the same
products and differ in summation order only, so they are held to cos >=
0.99999 and max|dy| <= 2 bf16 ulps of max|y| (f32: 1e-5 max|y|). The w8a8
route (integer dot) is bit-exact.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lowbit_quant_fa2_paddle_tpu.ops import gemv as JG
from lowbit_quant_fa2_paddle_tpu.ops import pack as JP
from lowbit_quant_fa2_paddle_tpu_torch.ops import gemv as TG
from lowbit_quant_fa2_paddle_tpu_torch.ops import pack as TP
from lowbit_quant_fa2_paddle_tpu_torch.ops.metrics import cosine_similarity

# One intra-op thread: the suite runs a worker per core, and torch's thread
# pool, spinning under that load, slowed small CPU ops up to 50-fold.
torch.set_num_threads(1)

N, K = 384, 512


def _w(seed=0, n=N, k=K):
    return (np.random.default_rng(seed).standard_normal((n, k)) * 0.1).astype(np.float32)


def _x(m, dtype, seed=1, k=K):
    """The same activations on both sides (bf16 values when dtype is bf16)."""
    x = np.random.default_rng(seed).standard_normal((m, k)).astype(np.float32)
    xt = torch.from_numpy(x).to(dtype)
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    return xt, jnp.asarray(xt.float().numpy()).astype(jdt)


def _np(a) -> np.ndarray:
    return np.array(jnp.asarray(a).astype(jnp.float32))


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _close(y: torch.Tensor, y_jax) -> None:
    want = torch.from_numpy(_np(y_jax))
    assert y.shape == want.shape
    assert float(cosine_similarity(y, want)) >= 0.99999
    ymax = float(want.abs().max())
    tol = 2 * 2.0 ** (math.floor(math.log2(ymax)) - 7) if y.dtype == torch.bfloat16 else 1e-5 * ymax
    assert float((y.float() - want).abs().max()) <= tol


@pytest.mark.parametrize("bits", [2, 4, 8])
@pytest.mark.parametrize("gs", [64, 128])
def test_pack_weights_bit_exact(bits, gs):
    w = _w()
    jp, js, jm = JG.pack_weights(jnp.asarray(w), group_size=gs, bits=bits)
    tp, ts, tm = TG.pack_weights(torch.from_numpy(w), group_size=gs, bits=bits)
    assert tp.dtype == torch.int8 and tp.shape == (N, K * bits // 8)
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    np.testing.assert_array_equal(TG.unpack_weights(tp, bits=bits).numpy(), np.asarray(JG.unpack_weights(jp, bits=bits)))
    w_deq = TG.dequant_weights(tp, ts, tm, bits=bits, group_size=gs)
    np.testing.assert_array_equal(w_deq.numpy(), np.asarray(JG.dequant_weights(jp, js, jm, bits=bits, group_size=gs)))


@pytest.mark.parametrize("bits", [8, 4])
def test_pack_weights_per_channel_bit_exact(bits):
    w = _w(2)
    jp, js = JG.pack_weights_per_channel(jnp.asarray(w), bits=bits)
    tp, ts = TG.pack_weights_per_channel(torch.from_numpy(w), bits=bits)
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(TG.dequant_weights(tp, ts, bits=bits).numpy(),
                                  np.asarray(JG.dequant_weights(jp, js, bits=bits)))


def test_per_channel_scale_is_division_then_add():
    """``max|w| / 127 + 1e-8`` in two roundings, as JAX runs it op by op;
    the single fma (what a compiled program forms) differs on some rows."""
    w = _w(3, n=4096, k=64)
    _, ts = TG.pack_weights_per_channel(torch.from_numpy(w))
    amax = np.abs(w).max(axis=1)
    two = (amax / np.float32(127.0)).astype(np.float32) + np.float32(1e-8)
    fma = (amax.astype(np.float64) * np.float64(np.float32(1 / 127)) + np.float64(np.float32(1e-8))).astype(np.float32)
    np.testing.assert_array_equal(ts.numpy(), two)
    assert (two != fma).any()


@pytest.mark.parametrize("m", [3, 64, 1024])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bits,activation", [(8, "bf16"), (8, "int8"), (4, "bf16"), (4, "int8")])
def test_per_channel_matmul_matches_jax(bits, activation, dtype, m):
    """F1 (8 bits; w8a8 with int8 activations) and the 4-bit route through
    F2, and the dense route from 1024 rows."""
    jp, js = JG.pack_weights_per_channel(jnp.asarray(_w(4)), bits=bits)
    xt, xj = _x(m, dtype)
    y = TG.wq_matmul_per_channel(xt, _t(jp), _t(js), bits=bits, activation=activation)
    y_jax = JG.wq_matmul_per_channel(xj, jp, js, bits=bits, activation=activation)
    assert y.dtype == dtype
    if bits == 8 and activation == "int8" and m < TG.DENSE_ROUTE_M:
        np.testing.assert_array_equal(y.float().numpy(), _np(y_jax))  # exact integer dot
    else:
        _close(y, y_jax)


@pytest.mark.parametrize("m", [3, 64, 1024])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bits", [2, 4, 8])
def test_grouped_matmul_matches_jax(bits, dtype, m):
    jp, js, jm = JG.pack_weights(jnp.asarray(_w(5)), group_size=64, bits=bits)
    xt, xj = _x(m, dtype, seed=6)
    y = TG.wq_matmul_fused(xt, _t(jp), _t(js), _t(jm), bits=bits, group_size=64)
    assert y.dtype == dtype and y.shape == (m, N)
    _close(y, JG.wq_matmul_fused(xj, jp, js, jm, bits=bits, group_size=64))


def test_grouped_matmul_without_mn_and_lead_dims():
    jp, js, _ = JG.pack_weights(jnp.asarray(_w(7)), group_size=128, bits=4)
    xt, xj = _x(6, torch.bfloat16, seed=8)
    y = TG.wq_matmul_fused(xt.reshape(2, 3, K), _t(jp), _t(js), None, bits=4, group_size=128)
    assert y.shape == (2, 3, N)
    _close(y.reshape(6, N), JG.wq_matmul_fused(xj, jp, js, None, bits=4, group_size=128))


def test_w4_per_channel_runs_the_grouped_route():
    """4-bit per-channel weights are F2 with one group per half of K and
    zero-points -7 * scale: the same result as calling it so."""
    tp, ts = TG.pack_weights_per_channel(torch.from_numpy(_w(9)), bits=4)
    x = torch.from_numpy(_x(5, torch.float32)[0].numpy())
    sc = ts[:, None].repeat(1, 2)
    mn = (-7.0 * ts)[:, None].expand(N, 2)
    torch.testing.assert_close(TG.wq_matmul_per_channel(x, tp, ts, bits=4),
                               TG.wq_matmul_fused(x, tp, sc, mn, bits=4, group_size=K // 2), rtol=0, atol=0)


@pytest.mark.parametrize("fmt", ["grouped", "per_channel8", "per_channel4"])
def test_trainable_grad_matches_jax(fmt):
    w = jnp.asarray(_w(10))
    x = np.random.default_rng(11).standard_normal((5, K)).astype(np.float32)
    if fmt == "grouped":
        p, s, mn = JG.pack_weights(w, group_size=128, bits=4)
        kw = dict(bits=4, group_size=128)
    else:
        bits = 8 if fmt == "per_channel8" else 4
        (p, s), mn = JG.pack_weights_per_channel(w, bits=bits), None
        kw = dict(bits=bits)
    g_jax = jax.grad(lambda x: jnp.sum(jnp.sin(JG.wq_matmul_trainable(x, p, s, mn, **kw))))(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    scale = _t(s).requires_grad_(True)
    y = TG.wq_matmul_trainable(xt, _t(p), scale, _t(mn) if mn is not None else None, **kw)
    torch.sin(y).sum().backward()
    assert float(cosine_similarity(xt.grad, torch.from_numpy(np.asarray(g_jax)))) >= 0.9995
    assert scale.grad is None  # the quantization params are frozen


def test_trainable_rejects_mn_with_per_channel_scale():
    tp, ts = TG.pack_weights_per_channel(torch.from_numpy(_w(12)), bits=4)
    with pytest.raises(ValueError, match="zero-points"):
        TG.wq_matmul_trainable(torch.zeros(3, K), tp, ts, torch.zeros(N, 4), bits=4)


def test_wqweight_layer():
    w = torch.from_numpy(_w(13))
    b = torch.linspace(-1, 1, N)
    layer = TG.WQWeight.from_dense(w, bits=8, bias=b)
    packed, scale = TG.pack_weights_per_channel(w, bits=8)
    assert torch.equal(layer.packed, packed) and torch.equal(layer.scale, scale)
    assert (layer.in_features, layer.out_features, layer.bits) == (K, N, 8)
    assert {n for n, _ in layer.named_buffers()} == {"packed", "scale", "bias"} and not list(layer.parameters())
    x = torch.randn(2, 3, K, generator=torch.Generator().manual_seed(0))
    torch.testing.assert_close(layer(x), TG.wq_matmul_per_channel(x, packed, scale) + b, rtol=0, atol=0)
    with pytest.raises(ValueError):
        TG.WQWeight(packed, scale[:-1], 8)


# ---------------------------------------------------------------------------
# ops/pack.py: the host format and WQLinear
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("bits", [2, 4, 8])
def test_host_pack_bit_exact(bits):
    codes = np.random.default_rng(14).integers(0, 2**bits, (3, 5, 64)).astype(np.int32)
    jw = JP.pack_along_last_dim(jnp.asarray(codes), bits)
    tw = TP.pack_along_last_dim(torch.from_numpy(codes), bits)
    assert tw.dtype == torch.int32 and tw.shape == (3, 5, 64 * bits // 32)
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
    np.testing.assert_array_equal(TP.unpack_along_last_dim(tw, bits).numpy(), codes)


@pytest.mark.parametrize("bits,gs", [(2, 32), (4, 64), (8, 128)])
def test_host_quantize_and_dequant_bit_exact(bits, gs):
    x = np.random.default_rng(15).standard_normal((4, 256)).astype(np.float32) + 0.3
    jp, js, jm = JP.quantize_and_pack_along_last_dim(jnp.asarray(x), group_size=gs, bits=bits)
    tp, ts, tm = TP.quantize_and_pack_along_last_dim(torch.from_numpy(x), group_size=gs, bits=bits)
    for t, j in ((tp, jp), (ts, js), (tm, jm)):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    deq = TP.unpack_and_dequant_along_last_dim(tp, ts, tm, group_size=gs, bits=bits)
    np.testing.assert_array_equal(deq.numpy(), np.asarray(JP.unpack_and_dequant_along_last_dim(
        jp, js, jm, group_size=gs, bits=bits)))


@pytest.mark.parametrize("backend", ["host", "fused"])
def test_wqlinear_matches_jax(backend):
    w, bias = _w(16), np.linspace(-1, 1, N).astype(np.float32)
    x = np.random.default_rng(17).standard_normal((4, K)).astype(np.float32)
    j = JP.WQLinear.from_dense(jnp.asarray(w), bias=jnp.asarray(bias), group_size=128, bits=4, backend=backend)
    t = TP.WQLinear.from_dense(torch.from_numpy(w), bias=torch.from_numpy(bias), group_size=128, bits=4,
                               backend=backend)
    np.testing.assert_array_equal(t.packed_w.numpy(), np.asarray(j.packed_w))
    _close(t(torch.from_numpy(x)), j(jnp.asarray(x)))
    if backend == "host":
        _close(TP.quantized_matmul(torch.from_numpy(x), t.packed_w, t.scale, t.mn, group_size=128, bits=4),
               JP.quantized_matmul(jnp.asarray(x), j.packed_w, j.scale, j.mn, group_size=128, bits=4))


@pytest.mark.parametrize("backend", ["host", "fused"])
def test_wqlinear_trainable_freezes_quant_params(backend):
    w = torch.from_numpy(_w(18))
    lin = TP.WQLinear.from_dense(w, bias=torch.zeros(N), group_size=128, bits=4, backend=backend, trainable=True)
    x = torch.randn(4, K, generator=torch.Generator().manual_seed(1), requires_grad=True)
    (lin(x) ** 2).sum().backward()
    assert x.grad is not None and bool((x.grad != 0).any())
    assert lin.bias.grad is not None and bool((lin.bias.grad != 0).any())
    assert [n for n, p in lin.named_parameters() if p.requires_grad] == ["bias"]
    frozen = TP.WQLinear.from_dense(w, bias=torch.zeros(N), group_size=128, bits=4, backend=backend)
    assert not frozen.bias.requires_grad


def test_bad_arguments_raise():
    w = torch.from_numpy(_w(19))
    with pytest.raises(ValueError):
        TG.pack_weights(w, bits=3)
    with pytest.raises(ValueError):
        TG.pack_weights_per_channel(w, bits=2)
    tp, ts, tm = TG.pack_weights(w, group_size=128, bits=2)
    with pytest.raises(ValueError, match="whole groups"):  # a part of K holds 128 codes: fine; 64 not
        TG.wq_matmul_fused(torch.zeros(3, 256), *TG.pack_weights(w[:, :256], group_size=128, bits=2), bits=2,
                           group_size=128)
    with pytest.raises(ValueError):
        TG.wq_matmul_fused(torch.zeros(3, K), tp, ts[:, :-1], tm, bits=2, group_size=128)
    with pytest.raises(ValueError):
        TG.wq_matmul_per_channel(torch.zeros(3, K), *TG.pack_weights_per_channel(w), activation="fp8")
    with pytest.raises(ValueError):
        TP.WQLinear.from_dense(w, backend="gpu")


def test_kernel_design_by_dtype():
    """F1 and F2 run bf16 activations on the tensor cores, and so does F1
    its int8 activation codes (w8a8); f32 ones, whose f32 products the
    tensor cores cannot form exactly, run on the CUDA cores."""
    assert TG.kernel_design(torch.bfloat16) == TG.kernel_design() == "tensor_core"
    assert TG.kernel_design(torch.int8) == "tensor_core"
    assert TG.kernel_design(torch.float32) == "cuda_core"
    assert set(TG.DESIGNS) == {"tensor_core", "cuda_core"}
    assert TG.wq_matmul_fused.launches_by_design.keys() == set(TG.DESIGNS)
    assert TG.wq_matmul_per_channel.launches_by_design.keys() == set(TG.DESIGNS)
    with pytest.raises(TypeError):
        TG.kernel_design(torch.float16)


@pytest.mark.parametrize("bits", [2, 4, 8])
def test_tensor_core_dequant_is_exact(bits):
    """The tensor-core design's dequantization, emulated bit for bit: the
    code of part i, byte b of a half-word, masked in place into the bits of
    2^23 (2^23 + 2^sh code, sh = 8b + bits*i), then one fma with scale 2^-sh
    and -2^23 scale 2^-sh (exact in f64, rounded once to f32), equals JAX's
    f32(code * scale) for every code, part and byte at random and extreme
    scales; both then round to bf16 the same way."""
    rng = np.random.default_rng(bits)
    fpb = 8 // bits
    scales = np.concatenate([rng.uniform(1e-6, 1.0, 64), [1e-30, 3.0e-5, 0.1234567, 7.5, 1e20]]).astype(np.float32)
    codes = np.arange(1 << bits, dtype=np.uint32)
    for i in range(fpb):
        for b in range(2):
            sh = 8 * b + bits * i
            word = (codes << sh) | (np.uint32(0xA5A5A5A5) & ~np.uint32(((1 << bits) - 1) << sh))
            masked = (word & np.uint32(((1 << bits) - 1) << sh)) | np.uint32(0x4B000000)
            v = masked.view(np.float32).astype(np.float64)
            for s in scales:
                s_sh = np.float32(s) * np.float32(2.0 ** -sh)
                o_sh = s_sh * np.float32(-8388608.0)
                got = (v * np.float64(s_sh) + np.float64(o_sh)).astype(np.float32)
                want = codes.astype(np.float32) * np.float32(s)
                np.testing.assert_array_equal(got, want)  # so the packed bf16 rounding sees JAX's f32


PLAN_SHAPES = [(4, 16384, 4096, 4), (4, 1024, 4096, 4), (4, 4096, 16384, 4), (4, 16384, 4096, 2),
               (1, 16384, 4096, 8), (9, 1000, 1024, 2), (1000, 4096, 4096, 4), (8, 300, 1056, 4), (4, 64, 448, 2)]


@pytest.mark.parametrize("m,n,k,bits", PLAN_SHAPES)
def test_tensor_core_plan(m, n, k, bits):
    """The tensor-core design's plan on an H100's 132 SMs: its split ranges
    cover the packed row once (no empty range), K is split only with one
    m-tile (M <= 8) and then into at most TC_MAX_SPLITS ranges (one
    cluster) of at least TC_MIN_CHUNKS chunks unless the row has fewer, a
    staged slice holds at most TC_X_VALUES[mt]
    x values a row, and the grid gives every warp the same number of 32-row
    items: one while they fit the card's warp slots."""
    mt, ksplit, cps, spc, gx = TG.tc_plan(m, n, k, bits, 132)
    fpb = 8 // bits
    chunks = -(-(k // fpb) // 64)
    mblocks = -(-m // (8 * mt))
    items = -(-n // TG.TC_ROWS)
    assert mt == (1 if m <= 8 else 4)
    assert (ksplit - 1) * cps < chunks <= ksplit * cps
    assert ksplit == 1 or (mt == 1 and cps >= min(TG.TC_MIN_CHUNKS, chunks) and ksplit <= TG.TC_MAX_SPLITS)
    assert 1 <= spc <= cps and spc * 64 * fpb <= TG.TC_X_VALUES[mt]
    slots = 132 * TG.TC_CTAS_PER_SM[mt] * TG.TC_WARPS
    per_warp = -(-items * ksplit * mblocks // slots)
    assert gx == -(-items // (TG.TC_WARPS * per_warp))
    if items * mblocks * ksplit <= slots:
        assert gx == -(-items // TG.TC_WARPS)  # one item per warp


def test_w8_int8_to_bf16_is_exact():
    """F1's tensor-core design turns each int8 code into a bf16 for the bf16
    product, two codes a 32-bit word, emulated bit for bit: with byte b in
    the low byte of a half, (b & 0x7F) | 0x4300 is the bf16 128 + (b & 127)
    and (b & 0x80) | 0x4300 the bf16 128 (b < 128) or 256; one fma in bf16,
    t * -1 + a, gives their difference exactly. That is the signed code for
    all 256 bytes (the 255 codes of ``pack_weights_per_channel`` and -128),
    as the bf16 that the plain version's f32 code rounds to."""
    b = np.arange(256, dtype=np.uint32)  # byte values as stored
    c = b.astype(np.uint8).view(np.int8).astype(np.float32)
    a_bits = ((b & np.uint32(0x7F)) | np.uint32(0x4300)).astype(np.uint16)
    t_bits = ((b & np.uint32(0x80)) | np.uint32(0x4300)).astype(np.uint16)
    a = torch.from_numpy(a_bits.view(np.int16)).view(torch.bfloat16)
    t = torch.from_numpy(t_bits.view(np.int16)).view(torch.bfloat16)
    np.testing.assert_array_equal(a.float().numpy(), 128 + (b & 0x7F).astype(np.float32))
    np.testing.assert_array_equal(t.float().numpy(), np.where(b >= 128, 256.0, 128.0).astype(np.float32))
    # The fma's exact result is an integer of at most 8 significant bits: bf16 holds it, no rounding.
    exact = t.double() * -1.0 + a.double()
    got = exact.to(torch.bfloat16)
    assert torch.equal(got.double(), exact)
    np.testing.assert_array_equal(got.float().numpy(), c)
    assert torch.equal(got, torch.from_numpy(c).bfloat16())


W8_PLAN_SHAPES = [(4, 16384, 4096), (4, 4096, 4096), (4, 1024, 4096), (4, 4096, 16384), (1, 16384, 4096),
                  (1, 1024, 4096), (1, 4096, 16384), (1000, 4096, 4096), (1000, 1024, 4096), (1000, 16384, 4096),
                  (64, 1024, 256), (9, 300, 528), (8, 64, 16)]


@pytest.mark.parametrize("x_int8", [False, True], ids=["bf16-x", "int8-x"])
@pytest.mark.parametrize("m,n,k", W8_PLAN_SHAPES)
def test_w8_plan(m, n, k, x_int8):
    """F1's tensor-core plan on an H100's 132 SMs: its split ranges cover K
    once (no empty range), K is split only with one m-tile (M <= 8) and then
    into at most W8_MAX_SPLITS ranges of at least W8_MIN_TILES tiles unless K
    has fewer, and the grid is every unit while they fit the card's CTA
    slots, else the slots (each CTA walks its units). On the ring at M <= 8
    there are at least 128 units, about one an SM. The small matrices (N 1024
    and 4096 at K 4096) take the direct loads instead, whose 16-row CTAs need
    no split, and, with int8 x, N 4096 at K 16384 (128 units of 32 rows,
    between 3/4 of the SMs and all of them) the deep ring, a CTA an SM over
    all of K."""
    structure, mt, ksplit, tps, grid = TG.w8_plan(m, n, k, 132, x_int8=x_int8)
    ktiles = -(-k // TG.W8_KT)
    units = -(-n // TG.W8_ROWS) * -(-m // (8 * mt))
    assert structure in TG.W8_STRUCTURES
    # Up to 8 x rows, K <= 4096 and W <= 16 MiB: the direct loads, 16 rows a CTA, K not split.
    assert (structure == "direct") == (m <= 8 and k <= TG.W8D_MAX_K and n * k <= TG.W8D_MAX_BYTES)
    if structure == "direct":
        assert (mt, ksplit, grid) == (1, 1, -(-n // TG.W8D_ROWS)) and tps * TG.W8_KT >= k
        return
    # Up to 8 rows of int8 x whose 32-row units fill 99 to 132 SMs once: the deep ring, one unit a CTA, all of K.
    assert (structure == "deep") == (x_int8 and m <= 8 and 99 <= units <= 132)
    assert (structure == "deep") == (x_int8 and (m, n, k) in ((4, 4096, 16384), (1, 4096, 16384)))
    if structure == "deep":
        assert (mt, ksplit, tps, grid) == (1, 1, ktiles, units)
        return
    slots = 132 * TG.W8_CTAS_PER_SM[mt]
    assert mt == (1 if m <= 8 else 4)
    assert (ksplit - 1) * tps < ktiles <= ksplit * tps
    assert ksplit == 1 or (mt == 1 and tps >= min(TG.W8_MIN_TILES, ktiles) and ksplit <= TG.W8_MAX_SPLITS)
    assert grid == min(units * ksplit, slots)
    if m <= 8 and k >= 4096:
        assert units * ksplit >= 128
