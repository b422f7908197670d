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
the bound the JAX tests hold INT8 to; the low-bit modes take the JAX tests'
own bounds (int4 > 0.99, int2 > 0.9, int8_v8 > 0.999).

The packed-K and INT8-V modes meet the same port-vs-JAX bounds. ``pv_int8``
gets its own: its P is requantized to integers in [0, 127], and JAX's
base-2^0.9975 exponent moves some codes by one against the port's 2^x, so it
is held to cos >= 0.999 and max|do| <= 5e-2 (measured on a CPU: cos
0.999994, max|do| 2.7e-2, max|dlse| 1.4e-2).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lowbit_quant_fa2_paddle_tpu as jlq
import lowbit_quant_fa2_paddle_tpu_torch as tlq
from lowbit_quant_fa2_paddle_tpu_torch.ops.attention import lowbit_attention
from lowbit_quant_fa2_paddle_tpu_torch.ops.metrics import cosine_similarity
from lowbit_quant_fa2_paddle_tpu_torch.ops.reference import attention_reference

# One intra-op thread: the suite runs a worker per core, and torch's thread
# pool, spinning under that load, slowed small CPU ops up to 50-fold.
torch.set_num_threads(1)

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


def _close(o_port, o_jax, lse_port=None, lse_jax=None, cos_min=COS_MIN, max_do=MAX_DO, max_dlse=MAX_DLSE):
    o_jax = torch.from_numpy(np.array(jnp.asarray(o_jax, jnp.float32)))
    o_port = o_port.float()
    assert o_port.shape == o_jax.shape
    assert torch.isfinite(o_port).all()
    assert float(cosine_similarity(o_port, o_jax)) >= cos_min
    assert float((o_port - o_jax).abs().max()) <= max_do
    if lse_port is not None:
        lse_jax = torch.from_numpy(np.array(lse_jax))
        assert lse_port.shape == lse_jax.shape
        assert float((lse_port - lse_jax).abs().max()) <= max_dlse


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


@pytest.mark.parametrize("tile", [64, 128])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("mode", ["int8", "fp", "int8_pv"])
def test_plain_version_at_each_kv_tile_matches_jax(mode, causal, tile, monkeypatch):
    """The int8, fp and INT8-PV modes' plain version at the design's KV tile
    (the wgmma design's 128 keys, which every mode runs on) and at 64
    against the JAX package: the tile moves only where P (or p8) rounds,
    within the port-vs-JAX bounds (INT8 PV's own, as in
    ``test_pv_int8_matches_jax``). s 400 is three whole 128-key tiles and a
    ragged one. INT8 PV's LSE sums p8 codes that JAX forms with the base
    2^(1 - 0.0025) (bf16 ln 2): the gap is about 0.0025 times the spread of
    the shifted logits, which reaches ~17 here (0.040 at either tile on a
    CPU, 0.014 on ``test_pv_int8_matches_jax``'s inputs), so its LSE is held
    to 5e-2."""
    from lowbit_quant_fa2_paddle_tpu_torch.ops import attention as tattn

    monkeypatch.setitem(tattn.KV_TILE, "wgmma", tile)
    assert tattn.kv_tile() == tile and tattn.kv_tile(pv_int8=True) == tile
    q, k, v = _qkv(h=4, hk=2, s=400, seed=11)
    if mode == "int8_pv":
        kw = dict(is_causal=causal, pv_int8=True, return_lse=True)
        jo, jl = jlq.lowbit_fa_qk_int8_pv_int8(_jax(q), _jax(k), _jax(v + 0.5), **kw)
        to, tl = tlq.lowbit_fa_qk_int8_pv_int8(_torch(q), _torch(k), _torch(v + 0.5), **kw)
        _close(to, jo, tl, jl, cos_min=0.999, max_do=5e-2, max_dlse=5e-2)
        return
    if mode == "int8":
        jo, jl = jlq.lowbit_fa_qk_int8_pv_fp16(_jax(q), _jax(k), _jax(v), is_causal=causal, return_lse=True)
        to, tl = tlq.lowbit_fa_qk_int8_pv_fp16(_torch(q), _torch(k), _torch(v), is_causal=causal, return_lse=True)
    else:
        b16, t16 = (lambda x: _jax(x, jnp.bfloat16)), (lambda x: _torch(x, torch.bfloat16))
        jo, jl = jlq.flash_attention_fp(b16(q), b16(k), b16(v), is_causal=causal, return_lse=True)
        to, tl = tlq.flash_attention_fp(t16(q), t16(k), t16(v), is_causal=causal, return_lse=True)
    _close(to, jo, tl, jl)


@pytest.mark.parametrize("pv_int8", [False, True])
def test_kernel_design_by_mode(pv_int8):
    """Every mode of kernel A, INT8 PV included, runs on the wgmma design,
    whose 128-key tile the plain version follows."""
    from lowbit_quant_fa2_paddle_tpu_torch.ops import attention as tattn

    assert tattn.kernel_design(pv_int8) == "wgmma" and tattn.kv_tile(pv_int8) == 128
    assert set(tattn.KV_TILE) == set(lowbit_attention.launches_by_design) == {"wgmma"}


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


def _unported_call(case):
    """A call this slice does not take on the GPU; each raises before any
    CUDA work (the launchers check first), so the CPU reaches the raise."""
    from lowbit_quant_fa2_paddle_tpu_torch.ops import attention_bwd as tbwd
    from lowbit_quant_fa2_paddle_tpu_torch.ops import decode as tdec

    if case == "a-head-dim-576":
        q = torch.randn(1, 1, 8, 576)
        return lambda: lowbit_attention(q, q, q)
    if case == "a-fp32-pv-head-dim-320":
        from lowbit_quant_fa2_paddle_tpu_torch.ops import attention as tattn

        q = torch.randn(1, 1, 8, 320)
        return lambda: tattn._attention_fwd_cuda(q, q, q, None, None, None, causal=False, sm_scale_log2e=0.08,
                                                 out_dtype=torch.float32, need_lse=False, k_bits=8, v_scale=None,
                                                 pv_int8=False, pv_f32=True)
    if case == "g-trainable-head-dim-320":
        return lambda: tbwd.check_bwd_head_dim(320)
    if case == "g-head-dim-320":
        q = torch.randn(1, 1, 8, 320)
        lse = torch.zeros(1, 1, 8)
        return lambda: tbwd._attention_bwd_cuda(q, q, q, q, lse, lse, None, None, None, None, causal=False, window=0,
                                                scale2=0.09, ds_scale=0.0625, dq_dtype=torch.float32,
                                                dkv_dtype=torch.float32)
    if case == "e-head-dim-528":
        from lowbit_quant_fa2_paddle_tpu_torch.ops import fused_kv as tfkv

        q, kp, ks = torch.randn(1, 1, 8, 528), torch.zeros(1, 1, 8, 264, dtype=torch.int8), torch.ones(1, 1, 8, 1)
        return lambda: tfkv._fused_kv_cuda(q, kp, kp, ks, ks, ks, ks, bits=4, group=8, causal=False,
                                           sm_scale_log2e=0.15, out_dtype=torch.float32)
    d = 104 if case == "d-head-dim-104" else 528
    cache = torch.zeros(1, 1, 16, d, dtype=torch.int8)
    q = torch.randn(1, 2, 1, d) if case.startswith("d-t-tokens") else torch.randn(1, 1, 1, d)
    ones, lens = torch.ones(1, 1, 16), torch.full((1,), 16, dtype=torch.int32)
    return lambda: tdec._decode_attention_cuda(q[:, 0] if q.shape[1] == 1 else q, cache, cache, ones, ones, lens,
                                               sm_scale=0.1, int_qk=True, out_dtype=torch.float32, need_lse=False)


#: The calls of _unported_call and the ROADMAP item each names.
UNPORTED = {"a-head-dim-576": "3h", "a-fp32-pv-head-dim-320": "3h", "g-head-dim-320": "3h",
            "g-trainable-head-dim-320": "3h", "d-head-dim-528": "3h", "d-t-tokens-head-dim-528": "3h",
            "e-head-dim-528": "3h", "d-head-dim-104": "3"}


@pytest.mark.parametrize("case", list(UNPORTED))
def test_unported_flags_raise(case):
    """What the port still raises for, each naming its ROADMAP item (which
    JAX takes: not a bad input): kernels A, D (one token or T) and E above
    their ceiling of head_dim 512, fp32 PV and G1/G2 (and the trainable
    entry points' check) above 256 ("3h"), and kernel D at a head dim that
    is not a multiple of 16 ("3")."""
    with pytest.raises(NotImplementedError, match=f"ROADMAP.md Queue 1, item {UNPORTED[case]}\\)"):
        _unported_call(case)()


@pytest.mark.parametrize("shape", [(1, 1, 1, 8), (1, 2, 4, 8), (1, 2, 1, 7), (2, 8)])
def test_bad_bias_shapes_raise(shape):
    """A bias is a per-key vector [B, H, 1, Sk] or a matrix [B, H, Sq, Sk]
    of the call's query heads: other shapes are ValueErrors."""
    q = torch.randn(1, 2, 8, 64)
    with pytest.raises(ValueError, match="bias"):
        lowbit_attention(q, q, q, bias=torch.zeros(shape))


@pytest.mark.parametrize(
    "kw,match",
    [
        (dict(window_size=8), "is_causal"),
        (dict(q_position_offset=4), "is_causal"),
        (dict(window_size=0, is_causal=True), "at least 1"),
        (dict(sink_size=-1), "sink_size"),
        (dict(logit_cap=-1.0), "logit_cap"),
        (dict(q_segment_ids=torch.zeros(1, 8, dtype=torch.int32)), "together"),
        (dict(q_segment_ids=torch.zeros(1, 8), kv_segment_ids=torch.zeros(1, 7)), r"\[B, Sq\]"),
    ],
)
def test_bad_mask_options_raise(kw, match):
    """The JAX launcher's asserts, as ValueErrors: a window or a query
    offset needs causal masking, a window is at least one key, segment ids
    come in pairs of the batch's shapes."""
    q = torch.randn(1, 1, 8, 64)
    with pytest.raises(ValueError, match=match):
        lowbit_attention(q, q, q, **kw)


def test_unported_entry_points_raise():
    """The entry points take smooth_q and "fp32+fp32" now; a head dim above
    512 still raises (ROADMAP), an unknown accumulation policy and int8 q
    without K codes are ValueErrors."""
    q = torch.randn(1, 1, 8, 64)
    for fn in (tlq.lowbit_fa_qk_int8_pv_fp16, tlq.lowbit_fa_qk_int4_pv_fp16):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            fn(*(torch.randn(1, 1, 8, 576),) * 3, smooth_q=True)
        assert fn(q, q, q, smooth_q=True).shape == q.shape
    with pytest.raises(ValueError, match="pv_accum_dtype"):
        tlq.lowbit_fa_qk_int8_pv_fp16(q, q, q, pv_accum_dtype="fp64")
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


# ---------------------------------------------------------------------------
# Packed INT4 / INT2 K, INT8 V and INT8 PV (kernels C2, C3 and A's modes)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("bits", [4, 2])
@pytest.mark.parametrize(
    "causal,hk,gran",
    [(False, 4, "per_token"), (True, 2, "per_token"), (False, 2, "per_block"), (True, 4, "per_block")],
)
def test_packed_k_matches_jax(bits, causal, hk, gran):
    """INT8 Q × packed INT4 / INT2 K, causal or not, GQA, per-token or
    per-block (Q external through C1 at per-block)."""
    q, k, v = _qkv(hk=hk, seed=6)
    name = f"lowbit_fa_qk_int{bits}_pv_fp16"
    kw = dict(is_causal=causal, qk_quant_gran=gran, return_lse=True)
    jo, jl = getattr(jlq.core, name)(_jax(q), _jax(k), _jax(v), **kw)
    to, tl = getattr(tlq, name)(_torch(q), _torch(k), _torch(v), **kw)
    assert to.dtype == torch.float32
    _close(to, jo, tl, jl)


@pytest.mark.parametrize("smooth_v,d", [(False, 64), (True, 64), (True, 128)])
def test_int8_v_matches_jax(smooth_v, d):
    """Per-channel INT8 V widened to bf16 for the PV product (JAX's default
    ``pv_int8=False``), with and without smooth-V."""
    q, k, v = _qkv(hk=2, d=d, seed=7)
    kw = dict(smooth_v=smooth_v, return_lse=True)
    jo, jl = jlq.lowbit_fa_qk_int8_pv_int8(_jax(q), _jax(k), _jax(v + 0.5), **kw)
    to, tl = tlq.lowbit_fa_qk_int8_pv_int8(_torch(q), _torch(k), _torch(v + 0.5), **kw)
    _close(to, jo, tl, jl)


@pytest.mark.parametrize("causal,d", [(False, 64), (True, 128)])
def test_pv_int8_matches_jax(causal, d):
    """INT8 P × INT8 V (the module note gives the bound and its reason)."""
    q, k, v = _qkv(hk=2, d=d, seed=8)
    kw = dict(is_causal=causal, pv_int8=True, return_lse=True)
    jo, jl = jlq.lowbit_fa_qk_int8_pv_int8(_jax(q), _jax(k), _jax(v + 0.5), **kw)
    to, tl = tlq.lowbit_fa_qk_int8_pv_int8(_torch(q), _torch(k), _torch(v + 0.5), **kw)
    _close(to, jo, tl, jl, cos_min=0.999, max_do=5e-2)


@pytest.mark.parametrize("bits,bound", [("int4", 0.99), ("int2", 0.9), ("int8_v8", 0.999)])
@pytest.mark.parametrize("causal", [False, True])
def test_lowbit_modes_track_oracle(bits, bound, causal):
    """The JAX tests' bounds against the fp32 oracle (test_api.py,
    test_lowbit_variants.py), at their shape b1 h4 s256 d64."""
    rng = np.random.default_rng(9)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 4, 256, 64)).astype(np.float32)) for _ in range(3))
    if bits == "int8_v8":
        v = v + 1.0
    o = tlq.lowbit_fa_attn(q, k, v, is_causal=causal, bits=bits)
    assert float(cosine_similarity(o, attention_reference(q, k, v, is_causal=causal))) > bound


def test_pv_int8_saturates_p8_at_the_row_max():
    """With ``pv_int8`` the row maximum's logit after the shift is log2(127)
    = 6.9887, which rounds to 7.0 in bf16: P = 2^7 = 128, and bf16(128 + 0.5)
    = 128. XLA's f32/bf16 -> s8 convert saturates that to 127, so p8 must be
    127, never the -128 a wrapping cast gives. Two keys whose logits differ
    by 1 (base 2): p8 = 127 and bf16(2^5.96875 -> 2^6) = 64."""
    one = np.asarray(jnp.asarray(128.0, jnp.bfloat16).astype(jnp.int8))
    jitted = np.asarray(jax.jit(lambda x: x.astype(jnp.int8))(jnp.asarray(128.0, jnp.bfloat16)))
    assert int(one) == int(jitted) == 127
    d = 64
    c = 1.0 / math.sqrt(d) * math.log2(math.e)
    q = torch.zeros(1, 1, 1, d)
    q[..., 0] = 1.0
    k = torch.zeros(1, 1, 2, d, dtype=torch.int8)
    k[0, 0, 0, 0], k[0, 0, 1, 0] = 127, 0
    # Logits s = (q_code · k_code) · k_scale · q_scale, with q's code 127 and
    # q_scale = (1/127 + EPS) · sm_scale · log2(e): key 0 gets ~1, key 1 gets 0.
    q_scale = (1.0 / 127.0 + 1e-7) * c
    k_scale = torch.tensor([[[1.0 / (127 * 127 * q_scale), 0.0]]])
    v = torch.tensor([[[[3] * d, [-5] * d]]], dtype=torch.int8)
    v_scale = torch.full((1, 1, d), 0.5)
    o, lse = lowbit_attention(q, k, v, None, k_scale, v_scale=v_scale, pv_int8=True, return_lse=True,
                              out_dtype=torch.float32)
    s_max = 1.0  # key 0's logit in base 2; key 1's is 0
    p8 = torch.tensor([127.0, 64.0])
    want = (p8[0] * 3 + p8[1] * -5) / p8.sum() * 0.5
    assert float((o[0, 0, 0] - want).abs().max()) <= 1e-6
    assert abs(float(lse[0, 0, 0]) - (s_max + math.log2(191.0) - math.log2(127.0))) <= 1e-5


@pytest.mark.parametrize("bits", [4, 2])
def test_packed_k_equals_unpacked_codes(bits):
    """Packed K gives exactly what its unpacked INT8 codes give: packing only
    changes storage."""
    from lowbit_quant_fa2_paddle_tpu_torch.ops import quant as tqo

    q, k, v = (_torch(x) for x in _qkv(hk=2, s=200, seed=10))
    packed, ks = (tqo.quant_int4 if bits == 4 else tqo.quant_int2)(k, gran="per_token")
    codes = (tqo.unpack_int4 if bits == 4 else tqo.unpack_int2)(packed)
    o_p, l_p = lowbit_attention(q, packed, v, None, ks, k_pack_bits=bits, return_lse=True)
    o_u, l_u = lowbit_attention(q, codes, v, None, ks, return_lse=True)
    assert torch.equal(o_p, o_u) and torch.equal(l_p, l_u)
    if bits == 4:
        assert torch.equal(lowbit_attention(q, packed, v, None, ks, k_packed_int4=True), o_p)


@pytest.mark.parametrize("bits", ["int8_v8", "int4", "int2", "auto"])
def test_dispatch_by_bits(bits):
    """``lowbit_fa_attn(bits=...)`` runs the matching entry point; ``auto``
    picks int4 for unit-normal tensors (average absmax scale ~0.03) and
    exports no LSE."""
    q, k, v = (_torch(x) for x in _qkv(s=128, seed=11))
    direct = {
        "int8_v8": tlq.lowbit_fa_qk_int8_pv_int8, "int4": tlq.lowbit_fa_qk_int4_pv_fp16,
        "int2": tlq.lowbit_fa_qk_int2_pv_fp16, "auto": tlq.lowbit_fa_qk_int4_pv_fp16,
    }[bits]
    from lowbit_quant_fa2_paddle_tpu_torch.core import select_quantization

    assert select_quantization(q, k) == "int4"
    assert torch.equal(tlq.lowbit_fa_attn(q, k, v, bits=bits), direct(q, k, v))
    if bits == "auto":
        with pytest.raises(ValueError, match="LSE"):
            tlq.lowbit_fa_attn(q, k, v, bits=bits, return_lse=True)
    else:
        o, lse = tlq.lowbit_fa_attn(q, k, v, bits=bits, return_lse=True)
        assert lse.shape == (1, 4, 128) and torch.equal(o, direct(q, k, v))


@pytest.mark.parametrize("scale", [100.0, 10.0, 0.1])
def test_multi_precision_matches_jax(scale):
    """The selector at the JAX test's three scales (fp16 / int8 / int4),
    then the chosen branch against JAX's."""
    from lowbit_quant_fa2_paddle_tpu.core import select_quantization as jsel
    from lowbit_quant_fa2_paddle_tpu_torch.core import select_quantization as tsel

    ones = np.ones((1, 1, 8, 8), np.float32) * scale
    want = {100.0: "fp16", 10.0: "int8", 0.1: "int4"}[scale]
    assert jsel(_jax(ones), _jax(ones)) == tsel(_torch(ones), _torch(ones)) == want
    q, k, v = _qkv(s=200, seed=12)
    q, k = q * scale / 4, k * scale / 4
    b16 = want == "fp16"
    jo = jlq.lowbit_fa_multi_precision(*(_jax(x, jnp.bfloat16 if b16 else jnp.float32) for x in (q, k, v)))
    to = tlq.lowbit_fa_multi_precision(*(_torch(x, torch.bfloat16 if b16 else torch.float32) for x in (q, k, v)))
    assert tsel(_torch(q), _torch(k)) == want
    _close(to, jo)
    from lowbit_quant_fa2_paddle_tpu_torch.core import lowbit_fa_multi_precision_jit

    assert torch.equal(lowbit_fa_multi_precision_jit(*(_torch(x) for x in (q, k, v))),
                       tlq.lowbit_fa_multi_precision(*(_torch(x) for x in (q, k, v))))


def test_quantize_with_bitmap_matches_jitted_jax():
    """Blocks flagged 0 round through INT4 with ``jnp.round`` (half to even,
    unlike the kernels' half away from zero); the scale is the fma form that
    compiled JAX uses. Rows are seeded with exact ties k + 0.5 of the scale."""
    from lowbit_quant_fa2_paddle_tpu.core import quantize_with_bitmap as jqb
    from lowbit_quant_fa2_paddle_tpu_torch.core import quantize_with_bitmap as tqb
    from lowbit_quant_fa2_paddle_tpu_torch.ops.quant import absmax_scale

    rng = np.random.default_rng(13)
    k = rng.uniform(-2.0, 2.0, (1, 2, 300, 64)).astype(np.float32)
    k[0, :, 0, 0] = 3.5  # the absmax of every block of head 0, 1 rows 0..127
    scale = float(absmax_scale(torch.tensor(3.5), bits=4))
    ties = 0
    for j, m in enumerate([0.5, 1.5, 2.5, -0.5, -2.5]):
        val = np.float32(m * scale)
        if float(val) == m * scale:
            k[0, :, 1, j] = val
            ties += 1
    assert ties >= 3
    bitmap = np.array([0, 1, 0], np.int32)
    want = np.asarray(jax.jit(lambda x, b: jqb(x, b))(jnp.asarray(k), jnp.asarray(bitmap)))
    got = tqb(torch.from_numpy(k), torch.from_numpy(bitmap)).numpy()
    np.testing.assert_array_equal(got, want)
    assert got[0, 0, 1, 0] == 0.0 and got[0, 0, 1, 1] == np.float32(2 * scale)  # 0.5 -> 0, 1.5 -> 2
    np.testing.assert_array_equal(got[:, :, 128:256], k[:, :, 128:256])  # the int8 block is untouched


def test_mixed_bits_matches_jax():
    q, k, v = _qkv(hk=2, seed=14)
    bitmap = np.array([1, 0, 1], np.int32)
    jo = jlq.lowbit_fa_mixed_bits(_jax(q), _jax(k), _jax(v), jnp.asarray(bitmap), is_causal=True)
    to = tlq.lowbit_fa_mixed_bits(_torch(q), _torch(k), _torch(v), torch.from_numpy(bitmap), is_causal=True)
    _close(to, jo)


@pytest.mark.parametrize(
    "case",
    ["packed_d96", "pv_int8_float_v", "int8_v_no_scale", "pack_bits_3", "packed_shape"],
)
def test_bad_low_bit_inputs_raise(case):
    q = torch.randn(1, 2, 8, 64)
    k8 = torch.zeros(1, 2, 8, 64, dtype=torch.int8)
    ks = torch.ones(1, 2, 8)
    v = torch.randn(1, 2, 8, 64)
    args = {
        "packed_d96": ((torch.randn(1, 2, 8, 96), torch.zeros(1, 2, 8, 48, dtype=torch.int8),
                        torch.randn(1, 2, 8, 96), None, ks), dict(k_pack_bits=4)),
        "pv_int8_float_v": ((q, k8, v, None, ks), dict(pv_int8=True)),
        "int8_v_no_scale": ((q, k8, v.to(torch.int8), None, ks), dict()),
        "pack_bits_3": ((q, k8, v, None, ks), dict(k_pack_bits=3)),
        "packed_shape": ((q, k8, v, None, ks), dict(k_packed_int4=True)),
    }[case]
    with pytest.raises(ValueError):
        lowbit_attention(*args[0], **args[1])


# ---------------------------------------------------------------------------
# Kernel A's masks: the visit list, the window / sinks / q offset / segment
# ids / logit cap against JAX's lowbit_attention_km (interpret mode), the
# empty-row contract, and lowbit_fa_varlen.
# ---------------------------------------------------------------------------

from lowbit_quant_fa2_paddle_tpu.ops import attention as jattn  # noqa: E402
from lowbit_quant_fa2_paddle_tpu.ops import quant as jquant  # noqa: E402
from lowbit_quant_fa2_paddle_tpu_torch.ops import attention as tattn  # noqa: E402

SCHEDULES = [
    # (nq, nk, block_q, block_kv, window, sink, q_offset)
    (4, 4, 128, 128, 0, 0, 0), (5, 3, 128, 256, 0, 0, 0), (6, 6, 128, 128, 200, 0, 0),
    (6, 6, 128, 128, 128, 0, 0), (8, 8, 64, 128, 100, 0, 0), (6, 6, 128, 128, 200, 70, 0),
    (6, 6, 128, 128, 150, 200, 0), (6, 6, 128, 128, 300, 130, 0), (4, 8, 128, 128, 0, 0, 384),
    (4, 8, 128, 128, 256, 0, 384), (4, 8, 128, 128, 256, 64, 400), (3, 2, 128, 128, 100, 0, 1000),
    (3, 2, 128, 128, 100, 10, 1000), (3, 4, 192, 128, 64, 0, 700), (7, 7, 192, 128, 500, 300, 0),
    (2, 5, 128, 128, 1, 0, 0), (2, 5, 128, 128, 1, 1, 200), (4, 4, 128, 128, 129, 0, -100),
]


@pytest.mark.parametrize("nq,nk,bq,bk,window,sink,q_offset", SCHEDULES)
def test_visit_list_equals_tri_schedule(nq, nk, bq, bk, window, sink, q_offset):
    """The port's visit list per q block is the JAX package's causal
    triangular/band schedule: the same (i, j) entries in the same order and
    the same first/last flags, for windows below, at and above the tile,
    sinks below and past the window, query offsets (one that empties every
    band: one masked visit each) and a negative one."""
    i_tbl, j_tbl, flags, n = jattn._tri_schedule(nq, nk, bq, bk, window, q_offset, sink)
    i_want, j_want, f_want = (np.asarray(x).tolist() for x in (i_tbl, j_tbl, flags))
    i_got, j_got, f_got = [], [], []
    for qi in range(nq):
        js = tattn.kv_visits(qi * bq, (qi + 1) * bq, nk * bk, bk, causal=True, window=window, sink=sink,
                             q_offset=q_offset)
        i_got += [qi] * len(js)
        j_got += js
        f_got += [(2 if p == 0 else 0) | (1 if p == len(js) - 1 else 0) for p in range(len(js))]
    assert (i_got, j_got, f_got) == (i_want, j_want, f_want) and len(i_got) == n


def test_visit_list_of_a_non_causal_call_is_every_tile():
    assert tattn.kv_visits(0, 128, 777, 128, causal=False, window=0) == list(range(7))


def _codes(k, bits):
    """JAX's K codes (jitted, as the TPU launcher's callers run it) for both
    sides: int8, or packed INT4 in halves of D."""
    quant = {8: jquant.quant_int8, 4: jquant.quant_int4}[bits]
    kc, ks = jax.jit(lambda x: quant(x, gran="per_token"))(_jax(k))
    return kc, ks, torch.from_numpy(np.array(kc)), torch.from_numpy(np.array(ks))


def _masked_pair(mode, q, k, v, causal, mask):
    """(port o, port lse2, JAX o, JAX lse2) of kernel A on the same inputs:
    JAX's lowbit_attention_km (Q quantized in the kernel for the int8 and
    int4 modes, bf16 Q/K for fp) against the port's lowbit_attention."""
    jmask, tmask = dict(mask), dict(mask)
    for key in ("q_segment_ids", "kv_segment_ids"):
        if key in mask:
            jmask[key], tmask[key] = _jax(mask[key], jnp.int32), torch.from_numpy(mask[key])
    vT = jnp.swapaxes(_jax(v, jnp.bfloat16), 2, 3)
    if mode == "fp":
        b16 = lambda x: _jax(x, jnp.bfloat16)  # noqa: E731
        jo, jl = jattn.lowbit_attention_km(jnp.swapaxes(b16(q), 2, 3), b16(k), vT, is_causal=causal,
                                           return_lse=True, **jmask)
        to, tl = lowbit_attention(_torch(q, torch.bfloat16), _torch(k, torch.bfloat16), _torch(v, torch.bfloat16),
                                  is_causal=causal, return_lse=True, **tmask)
    else:
        bits = 4 if mode == "int4" else 8
        jkc, jks, tkc, tks = _codes(k, bits)
        jo, jl = jattn.lowbit_attention_km(_jax(q), jkc, vT, None, jks, fused_quant_q=True, k_pack_bits=bits,
                                           is_causal=causal, return_lse=True, **jmask)
        to, tl = lowbit_attention(_torch(q), tkc, _torch(v, torch.bfloat16), None, tks, k_pack_bits=bits,
                                  is_causal=causal, return_lse=True, **tmask)
    return to, tl, jnp.swapaxes(jo, 2, 3), jl


def _segments(s, cuts):
    ids = np.zeros((1, s), np.int32)
    for c in cuts:
        ids[:, c:] += 1
    return ids


MASKS = {
    "window200": (True, dict(window_size=200)),
    "window200-sink70": (True, dict(window_size=200, sink_size=70)),
    "segments": (False, dict(q_segment_ids=_segments(640, (100, 333, 500)),
                             kv_segment_ids=_segments(640, (100, 333, 500)))),
    "segments-causal-window64": (True, dict(q_segment_ids=_segments(640, (100, 333)),
                                            kv_segment_ids=_segments(640, (100, 333)), window_size=64)),
    "q-offset100-window150": (True, dict(q_position_offset=100, window_size=150)),
    "logit-cap2": (False, dict(logit_cap=2.0)),
    "logit-cap3-causal-window256": (True, dict(logit_cap=3.0, window_size=256)),
}


@pytest.mark.parametrize("mask", list(MASKS))
@pytest.mark.parametrize("mode", ["int8", "fp", "int4"])
def test_masks_match_jax(mode, mask):
    """Kernel A's masks in the int8 (Q quantized in the kernel), fp and
    packed-INT4 K modes, GQA 4q/2kv, d64, s 640 (five 128-key tiles, the
    band over several), against JAX's lowbit_attention_km at the
    port-vs-JAX bounds. The q offset shifts the queries past the keys' start
    (Sq 512 over Sk 640)."""
    causal, kw = MASKS[mask]
    q, k, v = _qkv(h=4, hk=2, s=640, seed=31)
    if "q_position_offset" in kw:
        q = q[:, :, :512]
    to, tl, jo, jl = _masked_pair(mode, q, k, v, causal, kw)
    _close(to, jo, tl, jl)


@pytest.mark.parametrize("mode", ["int8", "fp"])
def test_masks_d128_match_jax(mode):
    """A d128 case: a causal window with sinks, segments and the cap
    together, MHA."""
    q, k, v = _qkv(h=2, hk=2, s=600, d=128, seed=32)
    kw = dict(window_size=130, sink_size=20, logit_cap=4.0, q_segment_ids=_segments(600, (250,)),
              kv_segment_ids=_segments(600, (250,)))
    to, tl, jo, jl = _masked_pair(mode, q, k, v, True, kw)
    _close(to, jo, tl, jl)


@pytest.mark.parametrize("mode", ["int8", "fp"])
def test_empty_rows_give_zero_output_and_neg_init_lse(mode):
    """Rows that no key is visible to, from a query offset past every key's
    window and from a q segment that no key shares, come out o = 0 and
    lse = -1e30 on both sides (the zero-weight contract of the ring merge)."""
    q, k, v = _qkv(h=2, hk=2, s=300, seed=33)
    cases = [(dict(window_size=100, q_position_offset=1000), slice(None)),
             (dict(q_segment_ids=_segments(300, (250,)) * 7, kv_segment_ids=_segments(300, (250,))),
              slice(250, None))]
    for kw, empty in cases:
        to, tl, jo, jl = _masked_pair(mode, q, k, v, "window_size" in kw, kw)
        jo, jl = torch.from_numpy(np.array(jnp.asarray(jo, jnp.float32))), torch.from_numpy(np.array(jl))
        for o, lse in ((to.float(), tl), (jo, jl)):
            assert float(o[:, :, empty].abs().max()) == 0.0
            assert bool((lse[:, :, empty] == -1e30).all())
        if empty != slice(None):
            _close(to[:, :, :250], jo[:, :, :250].numpy(), tl[:, :, :250], jl[:, :, :250].numpy())


def test_sinks_without_a_window_change_nothing():
    q, k, v = (_torch(x) for x in _qkv(s=200, seed=34))
    kc, ks = _codes(k.numpy(), 8)[2:]
    for causal in (False, True):
        a = lowbit_attention(q, kc, v, None, ks, is_causal=causal, return_lse=True)
        b = lowbit_attention(q, kc, v, None, ks, is_causal=causal, sink_size=16, return_lse=True)
        assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_window_covering_every_key_is_no_window():
    """A window of at least Sq + offset keys masks nothing (the JAX
    launcher drops it): the same bits as plain causal attention."""
    q, k, v = (_torch(x) for x in _qkv(s=200, seed=35))
    a = lowbit_attention(q, k, v, is_causal=True, return_lse=True)
    b = lowbit_attention(q, k, v, is_causal=True, window_size=200, sink_size=8, return_lse=True)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


VARLEN_CU = [0, 37, 300, 301, 520, 640]


@pytest.mark.parametrize(
    "causal,kw", [(False, {}), (True, {}), (True, dict(window_size=64)), (False, dict(qk_quant_gran="per_block"))],
    ids=["non-causal", "causal", "causal-window64", "per-block"])
def test_varlen_matches_jax(causal, kw):
    """lowbit_fa_varlen (and its sageattn_varlen name) on ragged cu_seqlens
    (a one-token sequence among them), packed [T, H, D], against the JAX
    package's: the output at the port-vs-JAX bounds; the LSE against JAX's
    kernel LSE with its smooth-K correction (JAX's varlen returns none)."""
    q, k, v = _qkv(h=4, hk=2, s=640, seed=36)
    packed = lambda x: np.ascontiguousarray(x[0].transpose(1, 0, 2))  # noqa: E731
    q, k, v = packed(q), packed(k), packed(v)
    cu = np.array(VARLEN_CU, np.int32)
    jo = jlq.lowbit_fa_varlen(_jax(q), _jax(k), _jax(v), jnp.asarray(cu), jnp.asarray(cu), is_causal=causal, **kw)
    to, tl = tlq.sageattn_varlen(_torch(q), _torch(k), _torch(v), torch.from_numpy(cu), torch.from_numpy(cu),
                                 is_causal=causal, return_lse=True, **kw)
    assert tlq.sageattn_varlen is tlq.lowbit_fa_varlen
    assert to.shape == q.shape and to.dtype == torch.float32 and tl.shape == (4, 640)
    _close(to, jo)
    # JAX's LSE for the same call: its kernel's base-2 LSE, corrected as its varlen entry would.
    from lowbit_quant_fa2_paddle_tpu import core as jcore

    seg = jnp.searchsorted(jnp.asarray(cu)[1:], jnp.arange(640), side="right")[None]
    qh, kh, vh = (jnp.swapaxes(_jax(x), 0, 1)[None] for x in (q, k, v))
    km = jquant.k_mean(kh)
    gran = kw.get("qk_quant_gran", "per_token")
    kc, ks = jquant.quant_int8(kh, km, gran=gran, block=128 if gran == "per_token" else 64)
    if gran == "per_token":
        q_in, q_scale, fused = qh, None, True
    else:
        q_in, q_scale = jquant.quant_int8(qh, gran=gran, block=128, layout="ds")
        fused = False
    _, jl2 = jattn.lowbit_attention_km(q_in, kc, jnp.swapaxes(vh, 2, 3), q_scale, ks, fused_quant_q=fused,
                                       q_segment_ids=seg, kv_segment_ids=seg, is_causal=causal,
                                       window_size=kw.get("window_size"), sm_scale=0.125, out_dtype=jnp.float32,
                                       return_lse=True)
    jl = jcore._finish_lse(jl2, qh, km, 0.125)[0]
    assert float((tl - torch.from_numpy(np.array(jl))).abs().max()) <= MAX_DLSE


def test_varlen_keeps_sequences_apart():
    """Each sequence of a varlen call equals a dense call on that sequence
    alone, up to the smooth-K mean (over the whole packed batch in varlen):
    cos >= 0.999 against the fp32 oracle per sequence."""
    q, k, v = _qkv(h=2, hk=2, s=640, seed=37)
    packed = lambda x: _torch(np.ascontiguousarray(x[0].transpose(1, 0, 2)))  # noqa: E731
    cu = torch.tensor(VARLEN_CU, dtype=torch.int32)
    o = tlq.lowbit_fa_varlen(packed(q), packed(k), packed(v), cu, cu, is_causal=True)
    for a, b in zip(VARLEN_CU[:-1], VARLEN_CU[1:]):
        ref = attention_reference(*(_torch(x[:, :, a:b]) for x in (q, k, v)), is_causal=True)
        got = o[a:b].transpose(0, 1)[None]
        if b - a == 1:
            torch.testing.assert_close(got, ref, rtol=0, atol=2e-2)
        else:
            assert float(cosine_similarity(got, ref)) >= 0.999


@pytest.mark.parametrize("bits", ["int8", "int8_v8", "int4", "int2", "fp"])
def test_entry_points_run_the_window(bits):
    """Every entry that passes window_size/sink_size on to kernel A now runs
    them: lowbit_fa_attn by bits, each held to the fp32 oracle with the same
    window and sinks at its mode's bound."""
    q, k, v = (_torch(x) for x in _qkv(h=4, hk=2, s=400, seed=38))
    kw = dict(is_causal=True, window_size=100, sink_size=20)
    o = tlq.lowbit_fa_attn(q, k, v, bits=bits, **kw)
    ref = attention_reference(q, k, v, **kw)
    bound = {"int4": 0.99, "int2": 0.9}.get(bits, 0.999)
    assert float(cosine_similarity(o, ref)) >= bound
    full = attention_reference(q, k, v, is_causal=True)
    assert float(cosine_similarity(ref, full)) < 0.99  # the window changes the answer
