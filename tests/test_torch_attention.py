"""Port parity: attention forward (kernel A) of the PyTorch package against
the JAX package, and against the port's own fp32 oracle.

Inputs come from numpy with a seed and go to both sides. JAX runs its Pallas
kernels in interpret mode on the CPU; the port runs its plain version, which
rounds P to bf16 exactly where the TPU kernel does. At these sizes the TPU
kernel takes one KV block, so the two compute the same row maxima and differ
only in summation order.

Tolerances, port vs JAX: cos >= 0.9999, max|do| <= 2e-2 (outputs are O(1);
bf16 P and bf16 outputs round at ~4e-3 to 1.6e-2 for the few-key causal
rows), max|dlse| <= 2e-2. The LSE bound is loose because JAX lowers exp2 of
a bf16 tile to exp(bf16(ln 2) * x): the TPU kernel's softmax runs in base
e^0.6914 = 2^0.9975, which biases its LSE by up to ~1e-2
(test_jax_bf16_exp2_rounds_ln2). The port computes exp2 itself; its fp LSE
is held to the exact fp32 oracle at 5e-3. Port vs the oracle: cos >= 0.999,
the bound the JAX tests hold INT8 to.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lowbit_quant_fa2_paddle_tpu as jlq
import lowbit_quant_fa2_paddle_tpu_torch as tlq
from lowbit_quant_fa2_paddle_tpu_torch.ops.attention import lowbit_attention
from lowbit_quant_fa2_paddle_tpu_torch.ops.metrics import cosine_similarity
from lowbit_quant_fa2_paddle_tpu_torch.ops.reference import attention_reference

COS_MIN, MAX_DO, MAX_DLSE = 0.9999, 2e-2, 2e-2


def _qkv(h=4, hk=4, s=300, d=64, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((1, h, s, d)).astype(np.float32)
    k = (rng.standard_normal((1, hk, s, d)) + 0.3).astype(np.float32)  # a K mean for smooth-K
    v = rng.standard_normal((1, hk, s, d)).astype(np.float32)
    return q, k, v


def _torch(x, dtype=torch.float32):
    return torch.from_numpy(x).to(dtype)


def _jax(x, dtype=jnp.float32):
    return jnp.asarray(x, dtype)


def _close(o_port, o_jax, lse_port=None, lse_jax=None):
    o_jax = torch.from_numpy(np.array(jnp.asarray(o_jax, jnp.float32)))
    o_port = o_port.float()
    assert o_port.shape == o_jax.shape
    assert torch.isfinite(o_port).all()
    assert float(cosine_similarity(o_port, o_jax)) >= COS_MIN
    assert float((o_port - o_jax).abs().max()) <= MAX_DO
    if lse_port is not None:
        lse_jax = torch.from_numpy(np.array(lse_jax))
        assert lse_port.shape == lse_jax.shape
        assert float((lse_port - lse_jax).abs().max()) <= MAX_DLSE


@pytest.mark.parametrize(
    "causal,hk,gran",
    [(False, 4, "per_token"), (True, 4, "per_token"), (False, 2, "per_token"),
     (True, 2, "per_token"), (True, 4, "per_block")],
)
def test_int8_matches_jax(causal, hk, gran):
    q, k, v = _qkv(hk=hk)
    jo, jl = jlq.lowbit_fa_qk_int8_pv_fp16(
        _jax(q), _jax(k), _jax(v), is_causal=causal, qk_quant_gran=gran, return_lse=True)
    to, tl = tlq.lowbit_fa_qk_int8_pv_fp16(
        _torch(q), _torch(k), _torch(v), is_causal=causal, qk_quant_gran=gran, return_lse=True)
    _close(to, jo, tl, jl)
    ref = attention_reference(_torch(q), _torch(k), _torch(v), is_causal=causal)
    assert float(cosine_similarity(to, ref)) >= 0.999


def test_int8_bf16_nhd_smooth_v_d128_matches_jax():
    q, k, v = _qkv(h=2, hk=2, s=200, d=128, seed=1)
    nhd = lambda x: np.ascontiguousarray(x.transpose(0, 2, 1, 3))  # noqa: E731
    q, k, v = nhd(q), nhd(k), nhd(v + 0.5)
    kw = dict(tensor_layout="NHD", smooth_v=True)
    jo = jlq.lowbit_fa_qk_int8_pv_fp16(_jax(q, jnp.bfloat16), _jax(k, jnp.bfloat16), _jax(v, jnp.bfloat16), **kw)
    to = tlq.lowbit_fa_qk_int8_pv_fp16(_torch(q, torch.bfloat16), _torch(k, torch.bfloat16),
                                       _torch(v, torch.bfloat16), **kw)
    assert to.dtype == torch.bfloat16 and to.shape == q.shape
    _close(to, jo)


@pytest.mark.parametrize("causal,hk", [(False, 4), (True, 2)])
def test_fp_matches_jax(causal, hk):
    q, k, v = _qkv(hk=hk, seed=2)
    b16 = lambda x: _jax(x, jnp.bfloat16)  # noqa: E731
    jo, jl = jlq.flash_attention_fp(b16(q), b16(k), b16(v), is_causal=causal, return_lse=True)
    t16 = lambda x: _torch(x, torch.bfloat16)  # noqa: E731
    to, tl = tlq.flash_attention_fp(t16(q), t16(k), t16(v), is_causal=causal, return_lse=True)
    assert to.dtype == torch.bfloat16
    _close(to, jo, tl, jl)
    ref, ref_lse = attention_reference(t16(q), t16(k), t16(v), is_causal=causal, return_lse=True)
    assert float(cosine_similarity(to, ref)) >= 0.999
    assert float((tl - ref_lse / math.log(2)).abs().max()) <= 5e-3


def test_jax_bf16_exp2_rounds_ln2():
    """The JAX package's exp2 on bf16 is exp(bf16(ln 2) * x), not 2^x; the
    port's plain version and kernel compute 2^x (recorded in ROADMAP.md)."""
    x = -np.linspace(0.0, 20.0, 4001, dtype=np.float32)
    xb = jnp.asarray(x, jnp.bfloat16)
    got = np.asarray(jnp.exp2(xb).astype(jnp.float32))
    ln2_bf16 = float(jnp.asarray(math.log(2.0), jnp.bfloat16))
    assert ln2_bf16 == 0.69140625
    want = np.asarray(jnp.exp(xb * jnp.asarray(ln2_bf16, jnp.bfloat16)).astype(jnp.float32))
    np.testing.assert_array_equal(got, want)
    true = torch.exp2(torch.from_numpy(np.array(xb.astype(jnp.float32)))).bfloat16().float().numpy()
    assert (got > true).mean() > 0.5  # the rounded base makes P systematically larger


def test_fp_dispatch_returns_natural_lse():
    q, k, v = (_torch(x) for x in _qkv(s=96, seed=3))
    o, lse = tlq.lowbit_fa_attn(q, k, v, bits="fp", return_lse=True)
    ref_o, ref_lse = attention_reference(q, k, v, return_lse=True)
    assert float(cosine_similarity(o, ref_o)) >= 0.999
    assert float((lse - ref_lse).abs().max()) <= 1e-2


def test_external_int8_q_matches_fused_quant():
    """INT8 Q codes + scales give the same output as float Q quantized
    inside the kernel (the two modes share the codes exactly)."""
    q, k, v = (_torch(x) for x in _qkv(s=150, seed=4))
    from lowbit_quant_fa2_paddle_tpu_torch.ops.quant import quant_int8

    kc, ks = quant_int8(k, gran="per_token")
    qc, qs = quant_int8(q, gran="per_token")
    o_fused, l_fused = lowbit_attention(q, kc, v, None, ks, return_lse=True)
    o_ext, l_ext = lowbit_attention(qc, kc, v, qs, ks, return_lse=True)
    torch.testing.assert_close(o_ext, o_fused, rtol=0, atol=0)
    torch.testing.assert_close(l_ext, l_fused, rtol=0, atol=0)


@pytest.mark.parametrize(
    "kw,exc",
    [
        (dict(window_size=8, is_causal=True), NotImplementedError),
        (dict(sink_size=4), NotImplementedError),
        (dict(logit_cap=30.0), NotImplementedError),
        (dict(q_position_offset=4), NotImplementedError),
        (dict(k_packed_int4=True), NotImplementedError),
        (dict(pv_int8=True), NotImplementedError),
        (dict(pv_dtype=torch.float32), NotImplementedError),
        (dict(bias=torch.zeros(1, 1, 1, 8)), NotImplementedError),
    ],
)
def test_unported_flags_raise(kw, exc):
    q = torch.randn(1, 1, 8, 64)
    with pytest.raises(exc, match="ROADMAP"):
        lowbit_attention(q, q, q, **kw)


def test_unported_entry_points_raise():
    q = torch.randn(1, 1, 8, 64)
    for bits in ("int4", "int8_v8", "auto"):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            tlq.lowbit_fa_attn(q, q, q, bits=bits)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tlq.lowbit_fa_qk_int8_pv_fp16(q, q, q, smooth_q=True)
    with pytest.raises(ValueError):
        lowbit_attention(q.to(torch.int8), q, q)


@pytest.mark.parametrize(
    "kw",
    [dict(), dict(is_causal=True), dict(is_causal=True, window_size=40, sink_size=8), dict(logit_cap=2.0),
     dict(segments=True)],
)
def test_attention_reference_matches_jax(kw):
    """The fp32 oracle of ops/reference.py (GQA 4q/2kv), port vs JAX, incl.
    its natural-log LSE; plus the chunked oracle and smooth-K helpers."""
    from lowbit_quant_fa2_paddle_tpu.ops import reference as jr
    from lowbit_quant_fa2_paddle_tpu_torch.ops import reference as tr

    q, k, v = _qkv(hk=2, s=130, seed=5)
    kw = dict(kw)
    if kw.pop("segments", False):
        seg = np.repeat(np.arange(3), [50, 40, 40])[None].astype(np.int32)
        kw.update(q_segment_ids=seg, kv_segment_ids=seg)
    tkw = {n: torch.from_numpy(x) if isinstance(x, np.ndarray) else x for n, x in kw.items()}
    jkw = {n: jnp.asarray(x) if isinstance(x, np.ndarray) else x for n, x in kw.items()}
    jo, jl = jr.attention_reference(_jax(q), _jax(k), _jax(v), return_lse=True, **jkw)
    to, tl = tr.attention_reference(_torch(q), _torch(k), _torch(v), return_lse=True, **tkw)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-5, atol=1e-5)
    if not kw or kw == dict(is_causal=True):
        tc = tr.attention_reference_chunked(_torch(q), _torch(k), _torch(v), chunk=48, **kw)
        np.testing.assert_allclose(tc.numpy(), to.numpy(), rtol=1e-4, atol=1e-5)
        ks, km = tr.smooth_k_reference(_torch(k))
        jks, jkm = jr.smooth_k_reference(_jax(k))
        np.testing.assert_allclose(ks.numpy(), np.asarray(jks), rtol=1e-5, atol=1e-6)
        tq = tr.attention_quantized_reference(_torch(q), _torch(k), _torch(v), **kw)
        jq = jr.attention_quantized_reference(_jax(q), _jax(k), _jax(v), **kw)
        np.testing.assert_allclose(tq.numpy(), np.asarray(jq), rtol=1e-4, atol=1e-4)
        kmq = tr.lse_smooth_k_correction(tl, _torch(q), km[:, [0, 0, 1, 1]], 0.125)
        jkmq = jr.lse_smooth_k_correction(jl, _jax(q), jnp.repeat(jkm, 2, axis=1), 0.125)
        np.testing.assert_allclose(kmq.numpy(), np.asarray(jkmq), rtol=1e-5, atol=1e-5)
