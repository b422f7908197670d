"""Port parity for the head_dim-256 slice: kernel A at head_dim 256 (and 192,
padded to 256), its bias, smooth_q and fp32 PV, kernel D at head_dim 256,
and a head_dim-256 LLM, each against the JAX package fed the same numpy
inputs from a seed. JAX runs its Pallas kernels in interpret mode; the port
runs its plain versions (the kernels' own tiles: 64 keys at head_dim 256).

Bounds, with the measured values on a CPU:

* kernel A's bf16-P modes: the port-vs-JAX bounds of test_torch_attention.py
  (cos >= 0.9999, max|do| <= 2e-2, max|dlse| <= 2e-2; INT8 PV cos >= 0.999,
  max|do| and max|dlse| <= 5e-2): P rounds to bf16 against each 64-key tile's
  running maximum here and against one block's in JAX;
* the bias: the same bounds (measured max|do| 7.8e-3 vector, 1.6e-2 matrix
  with causal masking and the cap); mirroring tests/test_lowbit_variants.py
  ::test_attention_bias, the Q-major call with fp32 PV is also held to the
  fp32 oracle at cos > 0.999;
* smooth_q: the same bounds; its LSE uses the original q (the JAX LSE
  contract, tests/test_kernel_space_api.py:172-180);
* fp32 PV: no bf16 rounding on either side, so f32 grade: max|do| <= 1e-5
  and max|dlse| <= 1e-5 at unit-normal inputs (measured 4.8e-7 / 9.5e-7);
* kernel D at head_dim 256: test_torch_decode.py's bounds (cos >= 0.999999,
  max|do| <= 2e-6, max|dlse| <= 1e-5);
* the head_dim-256 LLM (dim 512, 2 query heads, 1 KV head, depth 2):
  test_torch_llm.py's bounds, logits cos >= 0.9999 (4-bit cache 0.999).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lowbit_quant_fa2_paddle_tpu as jlq
import lowbit_quant_fa2_paddle_tpu_torch as tlq
from lowbit_quant_fa2_paddle_tpu.models import llm as JL
from lowbit_quant_fa2_paddle_tpu.ops import attention as jattn
from lowbit_quant_fa2_paddle_tpu.ops import decode as jd
from lowbit_quant_fa2_paddle_tpu.ops import quant as jquant
from lowbit_quant_fa2_paddle_tpu.ops.reference import attention_reference as j_reference
from lowbit_quant_fa2_paddle_tpu_torch.models import llm as TL
from lowbit_quant_fa2_paddle_tpu_torch.ops import attention as tattn
from lowbit_quant_fa2_paddle_tpu_torch.ops import decode as td
from lowbit_quant_fa2_paddle_tpu_torch.ops.attention import lowbit_attention
from lowbit_quant_fa2_paddle_tpu_torch.ops.metrics import cosine_similarity
from lowbit_quant_fa2_paddle_tpu_torch.ops.reference import attention_reference

# One intra-op thread: the suite runs a worker per core, and torch's thread
# pool, spinning under that load, slowed small CPU ops up to 50-fold.
torch.set_num_threads(1)

COS_MIN, MAX_DO, MAX_DLSE = 0.9999, 2e-2, 2e-2
F32_MAX_DO, F32_MAX_DLSE = 1e-5, 1e-5


def _qkv(h=4, hk=2, s=160, d=256, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((1, h, s, d)).astype(np.float32)
    k = (rng.standard_normal((1, hk, s, d)) + 0.3).astype(np.float32)
    v = rng.standard_normal((1, hk, s, d)).astype(np.float32)
    return q, k, v


def _t(x, dtype=torch.float32):
    return torch.from_numpy(np.ascontiguousarray(x)).to(dtype)


def _j(x, dtype=jnp.float32):
    return jnp.asarray(x, dtype)


def _np(x) -> torch.Tensor:
    return torch.from_numpy(np.array(jnp.asarray(x, jnp.float32)))


def _close(o_port, o_jax, lse_port=None, lse_jax=None, cos_min=COS_MIN, max_do=MAX_DO, max_dlse=MAX_DLSE):
    o_jax = _np(o_jax)
    o_port = o_port.float()
    assert o_port.shape == o_jax.shape and torch.isfinite(o_port).all()
    assert float(cosine_similarity(o_port, o_jax)) >= cos_min
    assert float((o_port - o_jax).abs().max()) <= max_do
    if lse_port is not None:
        assert float((lse_port - _np(lse_jax)).abs().max()) <= max_dlse


# ---------------------------------------------------------------------------
# Kernel A at head_dim 256 and 192
# ---------------------------------------------------------------------------

ENTRIES = {
    # name: (entry point, its keyword arguments, bound overrides)
    "int8": ("lowbit_fa_qk_int8_pv_fp16", dict(is_causal=True), {}),
    "int8-per-block": ("lowbit_fa_qk_int8_pv_fp16", dict(qk_quant_gran="per_block"), {}),
    "int4": ("lowbit_fa_qk_int4_pv_fp16", dict(is_causal=True), {}),
    "int2": ("lowbit_fa_qk_int2_pv_fp16", dict(), {}),
    "int8-v": ("lowbit_fa_qk_int8_pv_int8", dict(is_causal=True), {}),
    "int8-pv": ("lowbit_fa_qk_int8_pv_int8", dict(pv_int8=True), dict(cos_min=0.999, max_do=5e-2, max_dlse=5e-2)),
}


@pytest.mark.parametrize("d", [256, 192])
@pytest.mark.parametrize("mode", list(ENTRIES))
def test_head_dim_256_matches_jax(mode, d):
    """Each low-bit entry point at head_dim 256 (kernel A's 64-key tiles) and
    192 (padded to 256 in the port, to 192 in JAX), GQA 4q/2kv, against
    JAX's, with its LSE."""
    name, kw, bounds = ENTRIES[mode]
    q, k, v = _qkv(d=d, seed=d + len(mode))
    if "int8_pv_int8" in name:
        v = v + 0.5
    jo, jl = getattr(jlq.core, name)(_j(q), _j(k), _j(v), return_lse=True, **kw)
    to, tl = getattr(tlq, name)(_t(q), _t(k), _t(v), return_lse=True, **kw)
    assert to.shape == q.shape
    _close(to, jo, tl, jl, **bounds)


@pytest.mark.parametrize("causal", [False, True])
def test_fp_head_dim_256_matches_jax(causal):
    """The bf16 FA-2 baseline at head_dim 256 (GQA 4q/2kv), with its LSE."""
    q, k, v = _qkv(seed=5)
    jo, jl = jlq.flash_attention_fp(*(_j(x, jnp.bfloat16) for x in (q, k, v)), is_causal=causal, return_lse=True)
    to, tl = tlq.flash_attention_fp(*(_t(x, torch.bfloat16) for x in (q, k, v)), is_causal=causal, return_lse=True)
    _close(to, jo, tl, jl)


def test_head_dim_tiles():
    """The plain version walks the tile of the kernel that runs the call:
    128 keys up to head_dim 128, 64 above; the kernel's head dim is the
    next of 64, 128, 256."""
    assert [tattn.kv_tile(head_dim=d) for d in (32, 64, 128, 129, 192, 256)] == [128, 128, 128, 64, 64, 64]
    assert [tattn.kernel_dim(d) for d in (1, 64, 65, 128, 129, 256)] == [64, 64, 128, 128, 256, 256]


# ---------------------------------------------------------------------------
# The bias
# ---------------------------------------------------------------------------

BIAS_CASES = {
    # name: (vector, causal, kv heads, logit cap, head_dim)
    "vector": (True, False, 4, 0.0, 64),
    "matrix-causal-gqa": (False, True, 2, 0.0, 64),
    "vector-causal-gqa-cap3": (True, True, 2, 3.0, 64),
    "matrix-cap2": (False, False, 4, 2.0, 64),
    "vector-d256-causal-gqa": (True, True, 2, 0.0, 256),
}


@pytest.mark.parametrize("case", list(BIAS_CASES))
def test_bias_matches_jax(case):
    """Kernel A's bias (natural-log units, a per-key vector [B,H,1,Sk] or a
    matrix [B,H,Sq,Sk]), added after the scale and before the cap and the
    masks, against JAX's lowbit_attention_km with Q quantized in the kernel
    over int8 K codes."""
    vector, causal, hk, cap, d = BIAS_CASES[case]
    q, k, v = _qkv(hk=hk, s=300 if d == 64 else 160, d=d, seed=20 + d)
    s = q.shape[2]
    bias = np.random.default_rng(21).standard_normal((1, 4, 1 if vector else s, s)).astype(np.float32)
    kc, ks = jax.jit(lambda x: jquant.quant_int8(x, gran="per_token"))(_j(k))
    kw = dict(is_causal=causal, logit_cap=cap, return_lse=True)
    jo, jl = jattn.lowbit_attention_km(_j(q), kc, jnp.swapaxes(_j(v, jnp.bfloat16), 2, 3), None, ks,
                                       fused_quant_q=True, bias=_j(bias), **kw)
    to, tl = lowbit_attention(_t(q), _t(np.array(kc), torch.int8), _t(v, torch.bfloat16), None, _t(np.array(ks)),
                              bias=_t(bias), **kw)
    _close(to, jnp.swapaxes(jo, 2, 3), tl, jl)


@pytest.mark.parametrize("vector", [True, False])
def test_attention_bias_matches_jax_and_the_oracle(vector):
    """tests/test_lowbit_variants.py::test_attention_bias on both sides: INT8
    Q/K codes, fp32 PV, f32 output, the bias a vector or a matrix; the port
    against JAX's Q-major lowbit_attention at f32 grade, and against the
    fp32 oracle with the bias at cos > 0.999."""
    b, h, s, d = 1, 2, 256, 64
    q, k, v = _qkv(h=h, hk=h, s=s, d=d, seed=30)
    bias = np.random.default_rng(31).standard_normal((b, h, 1 if vector else s, s)).astype(np.float32)
    jqc, jqs = jquant.quant_int8(_j(q), gran="per_token")
    jkc, jks = jquant.quant_int8(_j(k), gran="per_token")
    kw = dict(pv_dtype=jnp.float32, out_dtype=jnp.float32)
    jo = jattn.lowbit_attention(jqc, jkc, _j(v), jqs, jks, bias=_j(bias), **kw)
    to = lowbit_attention(_t(np.array(jqc), torch.int8), _t(np.array(jkc), torch.int8), _t(v), _t(np.array(jqs)),
                          _t(np.array(jks)), bias=_t(bias), pv_dtype=torch.float32, out_dtype=torch.float32)
    assert to.dtype == torch.float32
    _close(to, jo, max_do=F32_MAX_DO)
    logits = torch.einsum("bhqd,bhkd->bhqk", _t(q), _t(k)) / d ** 0.5 + _t(bias)
    ref = torch.einsum("bhqk,bhkd->bhqd", torch.softmax(logits, dim=-1), _t(v))
    assert float(cosine_similarity(to, ref)) > 0.999


# ---------------------------------------------------------------------------
# smooth_q
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["lowbit_fa_qk_int8_pv_fp16", "lowbit_fa_qk_int4_pv_fp16"])
def test_smooth_q_matches_jax(name):
    """smooth_q on both entry points, causal GQA, Q with a large common
    channel component (tests/test_kernel_space_api.py:153-170): the port
    against JAX with its LSE (of the original q), and against the oracle:
    at least as close as without smooth_q, and cos > 0.999."""
    q, k, v = _qkv(s=256, d=64, seed=40)
    q = q.copy()
    q[..., :8] += 30.0
    jo, jl = getattr(jlq, name)(_j(q), _j(k), _j(v), is_causal=True, smooth_q=True, return_lse=True)
    to, tl = getattr(tlq, name)(_t(q), _t(k), _t(v), is_causal=True, smooth_q=True, return_lse=True)
    _close(to, jo, tl, jl)
    ref = attention_reference(_t(q), _t(k), _t(v), is_causal=True)
    plain = getattr(tlq, name)(_t(q), _t(k), _t(v), is_causal=True)
    cos_sq, cos_plain = float(cosine_similarity(to, ref)), float(cosine_similarity(plain, ref))
    assert cos_sq >= cos_plain - 1e-6 and cos_sq > 0.999


def test_smooth_q_lse_contract():
    """tests/test_kernel_space_api.py::test_smooth_q_lse_contract on the
    port: o cos > 0.999 and the natural-log LSE within 0.05 of the fp32
    oracle's, and the port's LSE within the port-vs-JAX bound of JAX's."""
    q, k, v = _qkv(s=256, d=64, seed=41)
    q = q.copy()
    q[..., :4] += 10.0
    o, lse = tlq.lowbit_fa_qk_int8_pv_fp16(_t(q), _t(k), _t(v), is_causal=True, smooth_q=True, return_lse=True)
    ref_o, ref_lse = attention_reference(_t(q), _t(k), _t(v), is_causal=True, return_lse=True)
    assert float(cosine_similarity(o, ref_o)) > 0.999
    assert float((lse - ref_lse).abs().max()) < 0.05
    _, jl = j_reference(_j(q), _j(k), _j(v), is_causal=True, return_lse=True)
    assert float((lse - _np(jl)).abs().max()) < 0.05


# ---------------------------------------------------------------------------
# fp32 PV
# ---------------------------------------------------------------------------

PV32_CASES = {
    # name: (q/k mode, V: "f32" or "int8" codes, causal, head_dim)
    "int8-qk-f32-v": ("int8", "f32", True, 64),
    "int8-qk-int8-v": ("int8", "int8", False, 128),
    "fp-qk-f32-v": ("fp", "f32", False, 64),
    "int8-qk-f32-v-d256": ("int8", "f32", True, 256),
}


@pytest.mark.parametrize("case", list(PV32_CASES))
def test_fp32_pv_matches_jax(case):
    """pv_dtype=float32 against JAX's pv_dtype=jnp.float32 (lowbit_attention_km):
    the softmax chain and PV in f32 on both sides (Q quantized in the kernel
    over int8 K codes, or bf16 Q/K), V f32 or int8 codes with per-channel
    scales, f32 output: f32 grade."""
    qk, vmode, causal, d = PV32_CASES[case]
    q, k, v = _qkv(s=200, d=d, seed=50 + d)
    kw = dict(is_causal=causal, return_lse=True)
    vs = None
    if vmode == "int8":
        vc, vs, _ = jax.jit(lambda x: jquant.quant_v_int8_per_channel(x, smooth_v=False))(_j(v))
        jv, tv = jnp.swapaxes(vc, 2, 3), _t(np.array(vc), torch.int8)
    else:
        jv, tv = jnp.swapaxes(_j(v), 2, 3), _t(v)
    jvs, tvs = (vs, _t(np.array(vs))) if vs is not None else (None, None)
    if qk == "int8":
        kc, ks = jax.jit(lambda x: jquant.quant_int8(x, gran="per_token"))(_j(k))
        jo, jl = jattn.lowbit_attention_km(_j(q), kc, jv, None, ks, fused_quant_q=True, v_scale=jvs,
                                           pv_dtype=jnp.float32, out_dtype=jnp.float32, **kw)
        to, tl = lowbit_attention(_t(q), _t(np.array(kc), torch.int8), tv, None, _t(np.array(ks)), v_scale=tvs,
                                  pv_dtype=torch.float32, out_dtype=torch.float32, **kw)
    else:
        b16 = lambda x: _j(x, jnp.bfloat16)  # noqa: E731
        jo, jl = jattn.lowbit_attention_km(jnp.swapaxes(b16(q), 2, 3), b16(k), jv, pv_dtype=jnp.float32,
                                           out_dtype=jnp.float32, **kw)
        to, tl = lowbit_attention(_t(q, torch.bfloat16), _t(k, torch.bfloat16), tv, pv_dtype=torch.float32,
                                  out_dtype=torch.float32, **kw)
    assert to.dtype == torch.float32
    _close(to, jnp.swapaxes(jo, 2, 3), tl, jl, max_do=F32_MAX_DO, max_dlse=F32_MAX_DLSE)


def test_fp32_pv_entry_point_matches_jax():
    """pv_accum_dtype="fp32+fp32" on lowbit_fa_qk_int8_pv_fp16 (f32 inputs,
    f32 output) against JAX's, with its LSE; and pv_int8 keeps its bf16
    chain whatever pv_dtype says."""
    q, k, v = _qkv(s=200, d=64, seed=60)
    kw = dict(is_causal=True, pv_accum_dtype="fp32+fp32", return_lse=True)
    jo, jl = jlq.lowbit_fa_qk_int8_pv_fp16(_j(q), _j(k), _j(v), **kw)
    to, tl = tlq.lowbit_fa_qk_int8_pv_fp16(_t(q), _t(k), _t(v), **kw)
    _close(to, jo, tl, jl, max_do=F32_MAX_DO, max_dlse=F32_MAX_DLSE)
    from lowbit_quant_fa2_paddle_tpu_torch.ops.quant import quant_int8, quant_v_int8_per_channel

    kc, ks = quant_int8(_t(k), gran="per_token")
    vc, vs, vm = quant_v_int8_per_channel(_t(v), smooth_v=True)
    a = lowbit_attention(_t(q), kc, vc, None, ks, v_scale=vs, v_mean=vm, pv_int8=True, return_lse=True)
    b = lowbit_attention(_t(q), kc, vc, None, ks, v_scale=vs, v_mean=vm, pv_int8=True, pv_dtype=torch.float32,
                         return_lse=True)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


# ---------------------------------------------------------------------------
# Kernel D at head_dim 256
# ---------------------------------------------------------------------------

D_COS, D_MAX_DO, D_MAX_DLSE = 0.999999, 2e-6, 1e-5
PV8_COS_MIN, PV8_MAX_DO = 0.9999, 3e-2
DECODE_MODES = {
    "int8": (8, 8, "auto", {}), "bf16": (16, 16, "auto", {}), "int4": (4, 4, "auto", {}),
    "int4-int-qk": (4, 4, "int_qk", {}), "k4v8": (4, 8, "auto", {}),
    "k4v8-int-qk-window64-sink4": (4, 8, "int_qk", dict(window_size=64, sink_size=4)),
    "int8-f32-window100-cap2": (8, 8, "f32", dict(window_size=100, logit_cap=2.0)),
}


@pytest.mark.parametrize("mode", list(DECODE_MODES))
def test_decode_head_dim_256_matches_jax(mode):
    """Kernel D at head_dim 256 on every cache type and both QK chains, with
    a window and sinks and the cap, GQA 8q/2kv, lengths [300, 0, 1, 137],
    against JAX's decode_attention at test_torch_decode.py's bounds."""
    k_bits, v_bits, compute_mode, opts = DECODE_MODES[mode]
    rng = np.random.default_rng(70 + k_bits + v_bits)
    k, v = (rng.standard_normal((4, 2, 300, 256)).astype(np.float32) for _ in range(2))
    q = rng.standard_normal((4, 8, 256)).astype(np.float32)
    quant = jax.jit(jd.quantize_token, static_argnames="bits")
    kq, ks = quant(_j(k), bits=k_bits)
    vq, vs = quant(_j(v), bits=v_bits)
    lengths = np.array([300, 0, 1, 137], np.int32)
    kw = dict(k_bits=k_bits, v_bits=v_bits, compute_mode=compute_mode, return_lse=True, **opts)
    jo, jl = jd.decode_attention(_j(q), kq, vq, ks, jnp.asarray(lengths), v_scale=vs, **kw)
    tt = lambda x: _t(np.array(x.astype(jnp.float32)), torch.bfloat16) if x.dtype == jnp.bfloat16 else _t(  # noqa: E731
        np.array(x), torch.int8 if x.dtype == jnp.int8 else torch.float32)
    to, tl = td.decode_attention(_t(q), tt(kq), tt(vq), tt(ks), torch.from_numpy(lengths), v_scale=tt(vs), **kw)
    jo, jl = _np(jo), _np(jl)
    assert to.shape == (4, 8, 256) and torch.isfinite(to).all()
    assert float(cosine_similarity(to, jo)) >= D_COS
    assert float((to - jo).abs().max()) <= D_MAX_DO
    assert float((tl - jl).abs().max()) <= D_MAX_DLSE
    assert float(to[1].abs().max()) == 0.0 and torch.all(tl[1] == torch.tensor(-1e30))


#: T-token modes at head_dim 256: (k_bits, v_bits, compute_mode, T, options).
MULTI_MODES = {
    "int8-t2": (8, 8, "auto", 2, {}), "bf16-t3": (16, 16, "auto", 3, {}), "int4-t4": (4, 4, "auto", 4, {}),
    "k4v8-int-qk-t4-window64-sink4": (4, 8, "int_qk", 4, dict(window_size=64, sink_size=4)),
    "int8-f32-t2-cap2": (8, 8, "f32", 2, dict(logit_cap=2.0)),
}


def _decode_both(t, k_bits, v_bits, seed, **kw):
    """Kernel D's inputs at head_dim 256 (GQA 8q/2kv, lengths [300, 1, T,
    137]) through JAX's jitted decode_attention and the port's; returns
    (port o, port lse, JAX o, JAX lse)."""
    rng = np.random.default_rng(seed)
    k, v = (rng.standard_normal((4, 2, 300, 256)).astype(np.float32) for _ in range(2))
    q = rng.standard_normal((4, t, 8, 256)).astype(np.float32)
    q = q[:, 0] if t == 1 else q  # one token as [B, H, D]: JAX returns that shape for it
    quant = jax.jit(jd.quantize_token, static_argnames="bits")
    kq, ks = quant(_j(k), bits=k_bits)
    vq, vs = quant(_j(v), bits=v_bits)
    lengths = np.array([300, 1, t, 137], np.int32)
    kw = dict(k_bits=k_bits, v_bits=v_bits, return_lse=True, **kw)
    jo, jl = jax.jit(lambda q_, l_: jd.decode_attention(q_, kq, vq, ks, l_, v_scale=vs, **kw))(_j(q),
                                                                                              jnp.asarray(lengths))
    kw.pop("block_kv", None)
    tt = lambda x: _t(np.array(x.astype(jnp.float32)), torch.bfloat16) if x.dtype == jnp.bfloat16 else _t(  # noqa: E731
        np.array(x), torch.int8 if x.dtype == jnp.int8 else torch.float32)
    to, tl = td.decode_attention(_t(q), tt(kq), tt(vq), tt(ks), torch.from_numpy(lengths), v_scale=tt(vs), **kw)
    return to, tl, _np(jo), _np(jl)


@pytest.mark.parametrize("mode", list(MULTI_MODES))
def test_decode_head_dim_256_multitoken_matches_jax(mode):
    """Kernel D's T-token mode at head_dim 256 (T 2-4; the card's
    decode_attention_multi_d256.cu) on every cache type and both QK chains,
    a window with sinks, the cap, against JAX's decode_attention at
    test_torch_decode.py's bounds; rows that see no key give o = 0 and lse =
    -1e30 on both sides."""
    k_bits, v_bits, compute_mode, t, opts = MULTI_MODES[mode]
    to, tl, jo, jl = _decode_both(t, k_bits, v_bits, 80 + t + k_bits, compute_mode=compute_mode, **opts)
    assert to.shape == (4, t, 8, 256) and torch.isfinite(to).all()
    assert float(cosine_similarity(to, jo)) >= D_COS
    assert float((to - jo).abs().max()) <= D_MAX_DO
    assert float((tl - jl).abs().max()) <= D_MAX_DLSE
    assert float(to[1, : t - 1].abs().max()) == 0.0 and torch.all(tl[1, : t - 1] == torch.tensor(-1e30))


@pytest.mark.parametrize("t", [1, 3])
def test_decode_head_dim_256_int8_pv_matches_jax(t):
    """INT8 PV (compute_mode "int") at head_dim 256 on the int8 cache against
    JAX at block_kv=32, the port's tile there (``tile_keys``): the same tiles
    in the same order. A p whose p / pa + 0.5 lies within rounding of an
    integer takes the neighbouring code on one side (measured: none at T 1,
    max|do| 2.7e-7; one at T 3, 7.9e-4 in the row of length 137), so the
    bounds are test_torch_speculative.py's for INT8 PV (cos >= 0.9999,
    max|do| <= 3e-2) and the LSE, which no code enters, test_torch_decode.py's
    1e-5; the codes matter (the f32 PV differs by more than 1e-4)."""
    assert td.tile_keys(256, 8, 8) == 32
    to, tl, jo, jl = _decode_both(t, 8, 8, 90 + t, compute_mode="int", block_kv=32)
    assert float(cosine_similarity(to, jo)) >= PV8_COS_MIN
    assert float((to - jo).abs().max()) <= PV8_MAX_DO
    assert float((tl - jl).abs().max()) <= D_MAX_DLSE
    f32_pv, _, _, _ = _decode_both(t, 8, 8, 90 + t, compute_mode="int_qk")
    assert float((to - f32_pv).abs().max()) > 1e-4


# ---------------------------------------------------------------------------
# A head_dim-256 LLM
# ---------------------------------------------------------------------------

HD256 = dict(dim=512, depth=2, num_heads=2, num_kv_heads=1, max_seq=64)
CACHES = {"int8": dict(kv_bits=8), "bf16": dict(kv_bits=16), "k4v8": dict(kv_bits=8, k_bits=4)}
LLM_COS, LLM_COS_4BIT = 0.9999, 0.999


@pytest.fixture(scope="module")
def hd256():
    params = JL.init_llm_params(jax.random.PRNGKey(3), JL.tiny_llm_config(**HD256, dtype=jnp.bfloat16))
    tree = jax.tree_util.tree_map(lambda x: np.array(jnp.asarray(x).astype(jnp.float32)), params)
    model = TL.params_from_jax(tree, TL.tiny_llm_config(**HD256, dtype=torch.bfloat16), device="cpu")
    tokens = np.random.default_rng(3).integers(0, 256, (2, 40)).astype(np.int32)
    return params, tree, model, tokens


def _cfgs(cache):
    return (JL.tiny_llm_config(**HD256, dtype=jnp.bfloat16, **CACHES[cache]),
            TL.tiny_llm_config(**HD256, dtype=torch.bfloat16, **CACHES[cache]))


@pytest.fixture(scope="module")
def jax_prefill(hd256):
    """JAX's (eager) llm_prefill of the fixture's tokens into a cache mode,
    once per module and mode: the tests that start from it share it (JAX's
    arrays are immutable; no step here donates them)."""
    params, _, _, tokens = hd256
    return functools.lru_cache(maxsize=None)(lambda cache: JL.llm_prefill(params, jnp.asarray(tokens),
                                                                          _cfgs(cache)[0]))


def test_hd256_params_from_jax(hd256):
    """params_from_jax carries the head_dim-256 model's weights where JAX has
    them (nn.Linear is [out, in]: wk is [1 x 256, 512])."""
    _, tree, model, _ = hd256
    assert TL.tiny_llm_config(**HD256).head_dim == 256
    for i, blk in enumerate(model.blocks):
        for key in ("wq", "wk", "wv", "wo", "w1", "w2"):
            assert torch.equal(getattr(blk, key).weight.float(), torch.from_numpy(tree["blocks"][i][key].T.copy()))
    assert tuple(model.blocks[0].wk.weight.shape) == (256, 512)


@pytest.mark.parametrize("cache", list(CACHES))
def test_hd256_prefill_and_decode_match_jax(hd256, jax_prefill, cache):
    """The int8 prefill (kernels C1 and A at head_dim 256) and 4 decode steps
    (kernel D at head_dim 256) on the int8, bf16 and k4v8 caches: logits cos
    >= 0.9999 against JAX's (0.999 with 4-bit K)."""
    params, _, model, tokens = hd256
    cfg_j, cfg_t = _cfgs(cache)
    bound = LLM_COS_4BIT if cfg_t.eff_k_bits == 4 else LLM_COS
    j_logits, j_caches = jax_prefill(cache)
    t_logits, t_caches = TL.llm_prefill(model, torch.from_numpy(tokens), cfg_t)
    assert t_logits.shape == (2, 40, 256)
    assert float(cosine_similarity(t_logits.float(), _np(j_logits))) >= LLM_COS
    feed = np.random.default_rng(4).integers(0, 256, (4, 2)).astype(np.int32)
    step = jax.jit(lambda p, t, c: JL.llm_decode_step(p, t, c, cfg_j))
    for i in range(4):
        j_logits, j_caches = step(params, jnp.asarray(feed[i]), j_caches)
        t_logits, t_caches = TL.llm_decode_step(model, torch.from_numpy(feed[i]), t_caches, cfg_t)
        assert float(cosine_similarity(t_logits.float(), _np(j_logits))) >= bound, i
    assert t_caches[0]["length"].tolist() == [44, 44]


@pytest.mark.parametrize("cache", ["int8", "k4v8"])
def test_hd256_verify_step_matches_jax(hd256, jax_prefill, cache):
    """llm_verify_step of 4 fed tokens over the prefilled caches (kernel D's
    T-token mode at head_dim 256 on the card): logits against JAX's jitted
    verify step at the LLM bounds (cos >= 0.9999; 0.999 with 4-bit K), and
    each row against the port's sequential llm_decode_step from the same
    prefill (cos >= 0.99999, the same argmax)."""
    params, _, model, tokens = hd256
    cfg_j, cfg_t = _cfgs(cache)
    bound = LLM_COS_4BIT if cfg_t.eff_k_bits == 4 else LLM_COS
    _, j_caches = jax_prefill(cache)
    _, t_caches = TL.llm_prefill(model, torch.from_numpy(tokens), cfg_t)
    _, step_caches = TL.llm_prefill(model, torch.from_numpy(tokens), cfg_t)
    fed = np.random.default_rng(5).integers(0, 256, (2, 4)).astype(np.int32)
    j_logits, _ = jax.jit(lambda p, t, c: JL.llm_verify_step(p, t, c, cfg_j))(params, jnp.asarray(fed), j_caches)
    t_logits, t_caches = TL.llm_verify_step(model, torch.from_numpy(fed), t_caches, cfg_t)
    assert t_logits.shape == (2, 4, 256) and t_caches[0]["length"].tolist() == [44, 44]
    assert float(cosine_similarity(t_logits.float(), _np(j_logits))) >= bound
    for i in range(4):
        s_logits, step_caches = TL.llm_decode_step(model, torch.from_numpy(fed[:, i]), step_caches, cfg_t)
        assert float(cosine_similarity(t_logits[:, i].float(), s_logits.float())) >= 0.99999, i
        assert torch.equal(torch.argmax(t_logits[:, i], -1), torch.argmax(s_logits, -1)), i


def test_hd256_speculative_generate_matches_jax(hd256):
    """speculative_generate on the hd256 model (spec_k 4, the model itself
    through an int4 cache as the draft; the card's verify steps run kernel
    D's T-token instances at head_dim 256): the tokens and the rounds equal
    JAX's speculative_generate of the same inputs, and the port's
    generate."""
    params, _, model, tokens = hd256
    cfg_j, cfg_t = _cfgs("int8")
    draft_j, draft_t = JL.tiny_llm_config(**HD256, dtype=jnp.bfloat16, kv_bits=4), TL.tiny_llm_config(
        **HD256, dtype=torch.bfloat16, kv_bits=4)
    prompt = tokens[:1, :12]
    j_toks, j_stats = JL.speculative_generate(params, jnp.asarray(prompt), 6, cfg_j, draft_params=params,
                                              draft_cfg=draft_j, spec_k=4, return_stats=True)
    t_toks, t_stats = TL.speculative_generate(model, torch.from_numpy(prompt), 6, cfg_t, draft_params=model,
                                              draft_cfg=draft_t, spec_k=4, return_stats=True)
    np.testing.assert_array_equal(t_toks.numpy(), np.asarray(j_toks))
    assert t_stats["rounds"] == j_stats["rounds"] and t_stats["mean_accepted"] == j_stats["mean_accepted"]
    assert torch.equal(t_toks, TL.generate(model, torch.from_numpy(prompt), 6, cfg_t))
