"""Port parity above head_dim 256: kernel A at head dims 320 and 512 (the
port pads 257-511 to its d512 kernel, JAX to a multiple of 64), kernel D at
272, 320 and 512 (the instances laid out for 512), kernel E at 320 and 512,
and an LLM with heads of 512, each against the JAX package fed the same
numpy inputs from a seed. JAX runs its Pallas kernels in interpret mode; the
port runs its plain versions (kernel A's 64-key tiles above head_dim 128,
kernel D's tiles of the instance that runs the head dim).

Bounds, those of tests/test_torch_hd256.py (none looser):

* kernel A's bf16-P modes: cos >= 0.9999, max|do| <= 2e-2, max|dlse| <=
  2e-2; INT8 PV cos >= 0.999, max|do| and max|dlse| <= 5e-2 (P rounds to
  bf16 against each 64-key tile's running maximum here, one block's in JAX);
  the masks and the bias at the same bounds;
* kernel D: cos >= 0.999999, max|do| <= 2e-6, max|dlse| <= 1e-5; INT8 PV at
  JAX's ``block_kv`` equal to the port's tile (16 keys at d512): cos >=
  0.9999, max|do| <= 3e-2, max|dlse| <= 1e-5;
* kernel E: tests/test_torch_head_dims.py's (cos >= 0.999, max|do| <=
  3e-2: the port rounds Q, K and V to bf16 for the tensor cores);
* the LLM at head dim 512 (dim 1024, 2 query heads, 1 KV head, depth 2):
  logits cos >= 0.9999 (0.999 with 4-bit K) after the prefill, the decode
  steps, the chunked prefill and the verify step; speculative_generate and
  the serving engine token-equal to JAX's.

fp32 PV, which has no kernel above head_dim 256, and the backward (G1/G2),
are held to raise on the card in tests/test_torch_attention.py.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lowbit_quant_fa2_paddle_tpu as jlq
import lowbit_quant_fa2_paddle_tpu_torch as tlq
from lowbit_quant_fa2_paddle_tpu import serving as JS
from lowbit_quant_fa2_paddle_tpu.models import llm as JL
from lowbit_quant_fa2_paddle_tpu.ops import attention as jattn
from lowbit_quant_fa2_paddle_tpu.ops import decode as jd
from lowbit_quant_fa2_paddle_tpu.ops import fused_kv as JF
from lowbit_quant_fa2_paddle_tpu.ops import quant as jquant
from lowbit_quant_fa2_paddle_tpu_torch import serving as TS
from lowbit_quant_fa2_paddle_tpu_torch.models import llm as TL
from lowbit_quant_fa2_paddle_tpu_torch.ops import attention as tattn
from lowbit_quant_fa2_paddle_tpu_torch.ops import decode as td
from lowbit_quant_fa2_paddle_tpu_torch.ops import fused_kv as TF
from lowbit_quant_fa2_paddle_tpu_torch.ops.attention import lowbit_attention
from lowbit_quant_fa2_paddle_tpu_torch.ops.metrics import cosine_similarity

# One intra-op thread: the suite runs a worker per core, and torch's thread
# pool, spinning under that load, slowed small CPU ops up to 50-fold.
torch.set_num_threads(1)

COS_MIN, MAX_DO, MAX_DLSE = 0.9999, 2e-2, 2e-2
PV8_BOUNDS = dict(cos_min=0.999, max_do=5e-2, max_dlse=5e-2)
D_COS, D_MAX_DO, D_MAX_DLSE = 0.999999, 2e-6, 1e-5
PV8_COS_MIN, PV8_MAX_DO = 0.9999, 3e-2
E_COS, E_MAX_DO = 0.999, 3e-2
LLM_COS, LLM_COS_4BIT = 0.9999, 0.999


def _qkv(h=2, hk=1, s=200, d=512, seed=0):
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


def _tt(x) -> torch.Tensor:
    """A JAX array as the port's tensor of the same type (bf16, int8, f32)."""
    if x.dtype == jnp.bfloat16:
        return _t(np.array(x.astype(jnp.float32)), torch.bfloat16)
    return _t(np.array(x), torch.int8 if x.dtype == jnp.int8 else torch.float32)


def _close(o_port, o_jax, lse_port=None, lse_jax=None, cos_min=COS_MIN, max_do=MAX_DO, max_dlse=MAX_DLSE):
    o_jax = _np(o_jax)
    o_port = o_port.float()
    assert o_port.shape == o_jax.shape and torch.isfinite(o_port).all()
    assert float(cosine_similarity(o_port, o_jax)) >= cos_min
    assert float((o_port - o_jax).abs().max()) <= max_do
    if lse_port is not None:
        assert float((lse_port - _np(lse_jax)).abs().max()) <= max_dlse


# ---------------------------------------------------------------------------
# Kernel A at head dims 512 and 320
# ---------------------------------------------------------------------------

ENTRIES = {
    # name: (entry point, its keyword arguments, bound overrides)
    "int8": ("lowbit_fa_qk_int8_pv_fp16", dict(is_causal=True), {}),
    "int8-per-block": ("lowbit_fa_qk_int8_pv_fp16", dict(qk_quant_gran="per_block"), {}),
    "int4": ("lowbit_fa_qk_int4_pv_fp16", dict(is_causal=True), {}),
    "int2": ("lowbit_fa_qk_int2_pv_fp16", dict(), {}),
    "int8-v": ("lowbit_fa_qk_int8_pv_int8", dict(is_causal=True), {}),
    "int8-pv": ("lowbit_fa_qk_int8_pv_int8", dict(pv_int8=True), PV8_BOUNDS),
}
A_CASES = [(m, 512) for m in ENTRIES] + [(m, 320) for m in ("int8", "int4", "int8-pv")]


@pytest.mark.parametrize("mode,d", A_CASES, ids=[f"{m}-d{d}" for m, d in A_CASES])
def test_head_dim_512_matches_jax(mode, d):
    """Each low-bit entry point at head_dim 512 (kernel A's d512 kernel,
    64-key tiles) and some at 320 (padded to 512 in the port, K repacked
    from JAX's 320 for the packed modes; 320 in JAX), GQA 2q/1kv, against
    JAX's, with its LSE."""
    name, kw, bounds = ENTRIES[mode]
    q, k, v = _qkv(d=d, seed=d + len(mode))
    if "int8_pv_int8" in name:
        v = v + 0.5
    jo, jl = getattr(jlq.core, name)(_j(q), _j(k), _j(v), return_lse=True, **kw)
    to, tl = getattr(tlq, name)(_t(q), _t(k), _t(v), return_lse=True, **kw)
    assert to.shape == q.shape
    _close(to, jo, tl, jl, **bounds)


@pytest.mark.parametrize("d,causal", [(512, True), (320, False)])
def test_fp_head_dim_512_matches_jax(d, causal):
    """The bf16 FA-2 baseline at head dims 512 and 320 (GQA 2q/1kv), with its
    LSE."""
    q, k, v = _qkv(d=d, seed=5 + d)
    jo, jl = jlq.flash_attention_fp(*(_j(x, jnp.bfloat16) for x in (q, k, v)), is_causal=causal, return_lse=True)
    to, tl = tlq.flash_attention_fp(*(_t(x, torch.bfloat16) for x in (q, k, v)), is_causal=causal, return_lse=True)
    _close(to, jo, tl, jl)


def _segments(s, cuts):
    ids = np.zeros((1, s), np.int32)
    for c in cuts:
        ids[:, c:] += 1
    return ids


MASKS = {
    # name: (q/k mode, head dim, causal, options)
    "int8-d512-window100-sink20-cap4-segments": (
        "int8", 512, True, dict(window_size=100, sink_size=20, logit_cap=4.0, q_segment_ids=_segments(300, (190,)),
                                kv_segment_ids=_segments(300, (190,)))),
    "fp-d512-q-offset100-window150": ("fp", 512, True, dict(q_position_offset=100, window_size=150)),
    "int4-d512-segments": ("int4", 512, False, dict(q_segment_ids=_segments(300, (70, 200)),
                                                   kv_segment_ids=_segments(300, (70, 200)))),
    "int8-d320-cap2-causal-window64": ("int8", 320, True, dict(logit_cap=2.0, window_size=64)),
}


@pytest.mark.parametrize("case", list(MASKS))
def test_masks_head_dim_512_match_jax(case):
    """Kernel A's masks above head_dim 256 (a window with sinks, segment ids,
    the cap, a q offset) in the int8 (Q quantized in the kernel), fp and
    packed-INT4 K modes, GQA 2q/1kv, s 300, against JAX's
    lowbit_attention_km (which takes the head dim whole)."""
    mode, d, causal, mask = MASKS[case]
    q, k, v = _qkv(s=300, d=d, seed=31 + d)
    if "q_position_offset" in mask:
        q = q[:, :, :200]
    jmask, tmask = dict(mask), dict(mask)
    for key in ("q_segment_ids", "kv_segment_ids"):
        if key in mask:
            jmask[key], tmask[key] = _j(mask[key], jnp.int32), torch.from_numpy(mask[key])
    vT = jnp.swapaxes(_j(v, jnp.bfloat16), 2, 3)
    if mode == "fp":
        jo, jl = jattn.lowbit_attention_km(jnp.swapaxes(_j(q, jnp.bfloat16), 2, 3), _j(k, jnp.bfloat16), vT,
                                           is_causal=causal, return_lse=True, **jmask)
        to, tl = lowbit_attention(_t(q, torch.bfloat16), _t(k, torch.bfloat16), _t(v, torch.bfloat16),
                                  is_causal=causal, return_lse=True, **tmask)
    else:
        bits = 4 if mode == "int4" else 8
        quant = {8: jquant.quant_int8, 4: jquant.quant_int4}[bits]
        kc, ks = jax.jit(lambda x: quant(x, gran="per_token"))(_j(k))
        jo, jl = jattn.lowbit_attention_km(_j(q), kc, vT, None, ks, fused_quant_q=True, k_pack_bits=bits,
                                           is_causal=causal, return_lse=True, **jmask)
        to, tl = lowbit_attention(_t(q), _tt(kc), _t(v, torch.bfloat16), None, _tt(ks), k_pack_bits=bits,
                                  is_causal=causal, return_lse=True, **tmask)
    _close(to, jnp.swapaxes(jo, 2, 3), tl, jl)


@pytest.mark.parametrize("vector", [True, False])
def test_bias_head_dim_512_matches_jax(vector):
    """The bias at head_dim 512 (a per-key vector, causal with the cap; a
    matrix), Q quantized in the kernel over int8 K codes, against JAX's
    lowbit_attention_km."""
    q, k, v = _qkv(s=200, seed=20)
    bias = np.random.default_rng(21).standard_normal((1, 2, 1 if vector else 200, 200)).astype(np.float32)
    kc, ks = jax.jit(lambda x: jquant.quant_int8(x, gran="per_token"))(_j(k))
    kw = dict(is_causal=vector, logit_cap=3.0 if vector else 0.0, return_lse=True)
    jo, jl = jattn.lowbit_attention_km(_j(q), kc, jnp.swapaxes(_j(v, jnp.bfloat16), 2, 3), None, ks,
                                       fused_quant_q=True, bias=_j(bias), **kw)
    to, tl = lowbit_attention(_t(q), _tt(kc), _t(v, torch.bfloat16), None, _tt(ks), bias=_t(bias), **kw)
    _close(to, jnp.swapaxes(jo, 2, 3), tl, jl)


def test_q_codes_head_dim_512_match_jax():
    """INT8 Q codes given with their scales (kernel A's q mode 0) at head_dim
    512, INT8 V widened to bf16 with v_scale and v_mean, against JAX's
    Q-major lowbit_attention on the same codes."""
    q, k, v = _qkv(s=200, seed=40)
    jqc, jqs = jquant.quant_int8(_j(q), gran="per_token")
    jkc, jks = jquant.quant_int8(_j(k), gran="per_token")
    jvc, jvs, jvm = jax.jit(lambda x: jquant.quant_v_int8_per_channel(x, smooth_v=True))(_j(v))
    jo, jl = jattn.lowbit_attention(jqc, jkc, jvc, jqs, jks, v_scale=jvs, v_mean=jvm, is_causal=True,
                                    return_lse=True)
    to, tl = lowbit_attention(_tt(jqc), _tt(jkc), _tt(jvc), _tt(jqs), _tt(jks), v_scale=_tt(jvs), v_mean=_tt(jvm),
                              is_causal=True, return_lse=True)
    _close(to, jo, tl, jl)


def test_head_dim_512_tiles_and_ceiling():
    """The plain version walks the d512 kernel's 64-key tiles (257-511 pad
    to 512, which the kernel pads them to); above 512 kernel A raises naming
    ROADMAP item 3h, and so does kernel D and kernel E."""
    assert [tattn.kv_tile(head_dim=d) for d in (257, 320, 448, 512)] == [64] * 4
    assert [tattn.kernel_dim(d) for d in (257, 320, 448, 511, 512)] == [512] * 5
    assert tattn.KERNEL_DIMS == (64, 128, 256, 512)
    assert set(tattn.lowbit_attention.launches_by_dim) == set(tattn.KERNEL_DIMS)
    with pytest.raises(NotImplementedError, match="item 3h\\)"):
        tattn.kernel_dim(576)
    with pytest.raises(NotImplementedError, match="item 3h\\)"):
        td.check_head_dim(528)
    assert [td.instance_dim(d) for d in (272, 320, 400, 512)] == [512] * 4
    assert [td.tile_keys(512, kb, vb) for kb, vb in ((8, 8), (16, 16), (4, 4), (4, 8))] == [16, 16, 32, 16]
    assert TF.HEAD_DIMS == td.CARD_HEAD_DIMS == tuple(range(16, 513, 16))
    assert TF.pack_row_bytes(512, 4) == 256 and TF.pack_row_bytes(400, 4) == 208


# ---------------------------------------------------------------------------
# Kernel D at head dims 272, 320 and 512
# ---------------------------------------------------------------------------

#: Cache modes: (k_bits, v_bits, compute_mode, options). "int" is INT8 PV.
DECODE_MODES = {
    "int8": (8, 8, "auto", {}), "bf16": (16, 16, "auto", {}), "int4": (4, 4, "auto", {}),
    "int4-int-qk": (4, 4, "int_qk", {}), "k4v8": (4, 8, "auto", {}),
    "k4v8-int-qk-window40-sink4": (4, 8, "int_qk", dict(window_size=40, sink_size=4)),
    "int8-f32-window50-cap2": (8, 8, "f32", dict(window_size=50, logit_cap=2.0)),
    "int8-pv8": (8, 8, "int", {}),
}
#: (head dim, mode, T): the four caches and INT8 PV at 512, 4-bit rows of 136
#: and 160 bytes at 272 and 320, both QK chains, the window, sinks and cap,
#: T 1 and 4, INT8 PV at 512 and 272.
D_CASES = [(512, m, 1) for m in ("int8", "bf16", "int4", "k4v8", "int8-pv8")] + [
    (512, "k4v8-int-qk-window40-sink4", 4), (272, "int4", 1), (272, "int8-pv8", 4),
    (272, "k4v8-int-qk-window40-sink4", 4), (320, "bf16", 4), (320, "int4-int-qk", 1),
    (320, "int8-f32-window50-cap2", 1)]


def _decode_inputs(d, t, k_bits, v_bits, seed, b=3, h=4, hk=1, s=100):
    """q [B, (T,) H, D] and JAX's quantized caches (GQA 4q/1kv); lengths:
    full, shorter than T (row 0 sees nothing at T > 1), one inside a tile."""
    rng = np.random.default_rng(seed)
    quant = jax.jit(jd.quantize_token, static_argnames="bits")
    kq, ks = quant(_j(rng.standard_normal((b, hk, s, d))), bits=k_bits)
    vq, vs = quant(_j(rng.standard_normal((b, hk, s, d))), bits=v_bits)
    q = rng.standard_normal((b, t, h, d) if t > 1 else (b, h, d)).astype(np.float32)
    return q, kq, vq, ks, vs, np.array([s, 1, 67][:b], np.int32)


@pytest.mark.parametrize("d,mode,t", D_CASES, ids=[f"d{d}-{m}-t{t}" for d, m, t in D_CASES])
def test_decode_head_dim_512_matches_jax(d, mode, t):
    """Kernel D's plain version above head_dim 256 (the tiles of the
    instances laid out for 512) against JAX's decode_attention in interpret
    mode: every cache mode and both QK chains, a window with sinks, the
    cap, T 1 and 4, INT8 PV at JAX's block_kv equal to the port's tile (the
    same codes; the f32 PV differs from it by more than 1e-4). Rows that see
    no key give o = 0 and lse = -1e30 on both sides."""
    k_bits, v_bits, compute, opts = DECODE_MODES[mode]
    q, kq, vq, ks, vs, lengths = _decode_inputs(d, t, k_bits, v_bits, seed=d + 7 * k_bits + v_bits + t)
    tile = td.tile_keys(d, k_bits, v_bits)
    assert td.instance_dim(d) == 512 and tile == td.tile_keys(512, k_bits, v_bits)
    kw = dict(k_bits=k_bits, v_bits=v_bits, compute_mode=compute, return_lse=True, **opts)
    block = dict(block_kv=tile) if compute == "int" else {}
    jo, jl = jax.jit(lambda q_, l_: jd.decode_attention(q_, kq, vq, ks, l_, v_scale=vs, **kw, **block))(
        _j(q), jnp.asarray(lengths))
    to, tl = td.decode_attention(_t(q), _tt(kq), _tt(vq), _tt(ks), torch.from_numpy(lengths), v_scale=_tt(vs), **kw)
    jo, jl = _np(jo), _np(jl)
    assert to.shape == jo.shape and torch.isfinite(to).all()
    cos_min, max_do = (PV8_COS_MIN, PV8_MAX_DO) if compute == "int" else (D_COS, D_MAX_DO)
    assert float(cosine_similarity(to, jo)) >= cos_min
    assert float((to - jo).abs().max()) <= max_do
    assert float((tl - jl).abs().max()) <= D_MAX_DLSE
    assert float(to[1, : t - 1].abs().max() if t > 1 else 0.0) == 0.0
    if compute == "int":
        f32_pv, _ = td.decode_attention(_t(q), _tt(kq), _tt(vq), _tt(ks), torch.from_numpy(lengths),
                                        v_scale=_tt(vs), **{**kw, "compute_mode": "int_qk"})
        assert float((to - f32_pv).abs().max()) > 1e-4


PAGED = {
    # name: (mode, d, page, T)
    "int8-d512-p16-t1": ("int8", 512, 16, 1),
    "k4v8-d320-p8-t4": ("k4v8", 320, 8, 4),
}


@pytest.mark.parametrize("case", list(PAGED))
def test_paged_decode_head_dim_512_matches_jax(case):
    """The paged cache above head_dim 256: a shuffled pool, lengths 0, two
    pages, the whole table and one inside a page; every page no walk visits
    holds NaN scales."""
    mode, d, page, t = PAGED[case]
    k_bits, v_bits, compute, _ = DECODE_MODES[mode]
    b, h, hk, width = 4, 4, 1, 6
    rng = np.random.default_rng(d + page + t)
    n_pages = b * width + 3
    quant = jax.jit(jd.quantize_token, static_argnames="bits")
    kq, ks = (np.array(x) for x in quant(_j(rng.standard_normal((hk, n_pages, page, d))), bits=k_bits))
    vq, vs = (np.array(x) for x in quant(_j(rng.standard_normal((hk, n_pages, page, d))), bits=v_bits))
    table = rng.permutation(n_pages)[: b * width].reshape(b, width).astype(np.int32)
    lengths = np.array([0, 2 * page, width * page, 3 * page + 5], np.int32)
    visited = {int(table[i, p]) for i, n in enumerate(lengths) for p in range(-(-int(n) // page))}
    dead = np.array(sorted(set(range(n_pages)) - visited))
    ks[:, dead] = np.nan
    vs[:, dead] = np.nan
    q = rng.standard_normal((b, t, h, d) if t > 1 else (b, h, d)).astype(np.float32)
    kw = dict(k_bits=k_bits, v_bits=v_bits, compute_mode=compute, return_lse=True)
    jo, jl = jax.jit(functools.partial(jd.decode_attention, **kw))(
        jnp.asarray(q), jnp.asarray(kq), jnp.asarray(vq), jnp.asarray(ks), jnp.asarray(lengths),
        v_scale=jnp.asarray(vs), page_table=jnp.asarray(table))
    to, tl = td.decode_attention(torch.from_numpy(q), torch.from_numpy(kq), torch.from_numpy(vq),
                                 torch.from_numpy(ks), torch.from_numpy(lengths), v_scale=torch.from_numpy(vs),
                                 page_table=torch.from_numpy(table), **kw)
    jo, jl = _np(jo), _np(jl)
    assert to.shape == jo.shape and torch.isfinite(to).all()
    assert float(cosine_similarity(to, jo)) >= D_COS
    assert float((to - jo).abs().max()) <= D_MAX_DO
    assert float((tl - jl).abs().max()) <= D_MAX_DLSE


# ---------------------------------------------------------------------------
# Kernel E at head dims 320 and 512
# ---------------------------------------------------------------------------

E_CASES = [(512, 4, True), (512, 2, False), (320, 4, False)]


@pytest.mark.parametrize("d,bits,causal", E_CASES, ids=[f"d{d}-int{bits}-{'causal' if c else 'full'}"
                                                        for d, bits, c in E_CASES])
def test_fused_kv_head_dim_512_matches_jax(d, bits, causal):
    """Kernel E's plain version at head dims 512 and 320 (the width-512
    kernel's, exact and padded), 4- and 2-bit, causal and not, GQA 4/2, 100
    keys in groups of 64 (the second ragged), against JAX's
    fused_packed_kv_attention on the same packed codes, scales and mns."""
    rng = np.random.default_rng(d + bits)
    q = rng.standard_normal((1, 4, 64, d)).astype(np.float32)
    k = (rng.standard_normal((1, 2, 100, d)) + 0.5).astype(np.float32)
    v = (rng.standard_normal((1, 2, 100, d)) - 0.3).astype(np.float32)
    tk = TF.quant_kv_grouped(torch.from_numpy(k), bits=bits, group=64)
    tv = TF.quant_kv_grouped(torch.from_numpy(v), bits=bits, group=64)
    jk, jv = ([jnp.asarray(x.numpy()) for x in t] for t in (tk, tv))
    want = JF.fused_packed_kv_attention(jnp.asarray(q), jk[0], jv[0], jk[1], jk[2], jv[1], jv[2], bits=bits,
                                        group=64, out_dtype=jnp.float32, is_causal=causal)
    o = TF.fused_packed_kv_attention(torch.from_numpy(q), tk[0], tv[0], tk[1], tk[2], tv[1], tv[2], bits=bits,
                                     group=64, out_dtype=torch.float32, is_causal=causal)
    want = torch.from_numpy(np.array(want))
    assert o.shape == (1, 4, 64, d) and o.dtype == torch.float32
    assert float(cosine_similarity(o, want)) >= E_COS
    assert float((o - want).abs().max()) <= E_MAX_DO


# ---------------------------------------------------------------------------
# An LLM with heads of 512
# ---------------------------------------------------------------------------

HD512 = dict(dim=1024, depth=2, num_heads=2, num_kv_heads=1, max_seq=64)
CACHES = {"int8": dict(kv_bits=8), "bf16": dict(kv_bits=16), "int4": dict(kv_bits=4),
          "k4v8": dict(kv_bits=8, k_bits=4)}


@pytest.fixture(scope="module")
def hd512():
    init = jax.jit(JL.init_llm_params, static_argnums=1)
    params = init(jax.random.PRNGKey(5), JL.tiny_llm_config(**HD512, dtype=jnp.bfloat16))
    tree = jax.tree_util.tree_map(lambda x: np.array(jnp.asarray(x).astype(jnp.float32)), params)
    model = TL.params_from_jax(tree, TL.tiny_llm_config(**HD512, dtype=torch.bfloat16), device="cpu")
    tokens = np.random.default_rng(5).integers(0, 256, (2, 40)).astype(np.int32)
    return params, tree, model, tokens


def _cfgs(cache):
    return (JL.tiny_llm_config(**HD512, dtype=jnp.bfloat16, **CACHES[cache]),
            TL.tiny_llm_config(**HD512, dtype=torch.bfloat16, **CACHES[cache]))


@pytest.fixture(scope="module")
def jax_prefill(hd512):
    """JAX's llm_prefill of the fixture's tokens into a cache mode, jitted
    (the eager call traces each op alone), once per module and mode (JAX's
    arrays are immutable; no step here donates them)."""
    params, _, _, tokens = hd512
    return functools.lru_cache(maxsize=None)(
        lambda cache: jax.jit(functools.partial(JL.llm_prefill, cfg=_cfgs(cache)[0]))(params, jnp.asarray(tokens)))


def test_hd512_params_from_jax(hd512):
    """params_from_jax carries the model with heads of 512 where JAX has its
    weights (nn.Linear is [out, in]: wk is [1 x 512, 1024])."""
    _, tree, model, _ = hd512
    assert TL.tiny_llm_config(**HD512).head_dim == 512
    for i, blk in enumerate(model.blocks):
        for key in ("wq", "wk", "wv", "wo", "w1", "w2"):
            assert torch.equal(getattr(blk, key).weight.float(), torch.from_numpy(tree["blocks"][i][key].T.copy()))
    assert tuple(model.blocks[0].wk.weight.shape) == (512, 1024)


@pytest.mark.parametrize("cache", list(CACHES))
def test_hd512_prefill_and_decode_match_jax(hd512, jax_prefill, cache):
    """The prefill (kernels C1 and A at head_dim 512) and 2 decode steps
    (kernel D laid out for 512) on the int8, bf16, int4 and k4v8 caches:
    logits cos >= 0.9999 against JAX's (0.999 with 4-bit K)."""
    params, _, model, tokens = hd512
    cfg_j, cfg_t = _cfgs(cache)
    bound = LLM_COS_4BIT if cfg_t.eff_k_bits == 4 else LLM_COS
    j_logits, j_caches = jax_prefill(cache)
    t_logits, t_caches = TL.llm_prefill(model, torch.from_numpy(tokens), cfg_t)
    assert t_logits.shape == (2, 40, 256)
    assert float(cosine_similarity(t_logits.float(), _np(j_logits))) >= LLM_COS
    feed = np.random.default_rng(6).integers(0, 256, (2, 2)).astype(np.int32)
    step = jax.jit(lambda p, t, c: JL.llm_decode_step(p, t, c, cfg_j))
    for i in range(2):
        j_logits, j_caches = step(params, jnp.asarray(feed[i]), j_caches)
        t_logits, t_caches = TL.llm_decode_step(model, torch.from_numpy(feed[i]), t_caches, cfg_t)
        assert float(cosine_similarity(t_logits.float(), _np(j_logits))) >= bound, i
    assert t_caches[0]["length"].tolist() == [42, 42]


@pytest.mark.parametrize("cache", ["int8", "k4v8"])
def test_hd512_chunked_prefill_matches_jax(hd512, cache):
    """llm_prefill_chunked in chunks of 20 (kernel A over the cache's int8
    codes, and with 4-bit K over its packed INT4 codes at head_dim 512):
    the last token's logits against JAX's chunked prefill (cos >= 0.9999;
    0.999 with 4-bit K) and the cache rows as JAX writes them."""
    params, _, model, tokens = hd512
    cfg_j, cfg_t = _cfgs(cache)
    bound = LLM_COS_4BIT if cfg_t.eff_k_bits == 4 else LLM_COS
    j_logits, j_caches = JL.llm_prefill_chunked(params, jnp.asarray(tokens), cfg_j, chunk=20)
    t_logits, t_caches = TL.llm_prefill_chunked(model, torch.from_numpy(tokens), cfg_t, chunk=20)
    assert float(cosine_similarity(t_logits.float(), _np(j_logits))) >= bound
    assert t_caches[-1]["length"].tolist() == [40, 40]
    assert tuple(t_caches[-1]["k"].shape) == tuple(j_caches[-1]["k"].shape)


def test_hd512_verify_step_matches_jax(hd512, jax_prefill):
    """llm_verify_step of 4 fed tokens over the prefilled int8 caches (kernel
    D's T-token mode laid out for 512 on the card): logits against JAX's
    jitted verify step (cos >= 0.9999), and each row against the port's
    sequential llm_decode_step from the same prefill (cos >= 0.99999, the
    same argmax)."""
    params, _, model, tokens = hd512
    cfg_j, cfg_t = _cfgs("int8")
    _, j_caches = jax_prefill("int8")
    _, t_caches = TL.llm_prefill(model, torch.from_numpy(tokens), cfg_t)
    _, step_caches = TL.llm_prefill(model, torch.from_numpy(tokens), cfg_t)
    fed = np.random.default_rng(7).integers(0, 256, (2, 4)).astype(np.int32)
    j_logits, _ = jax.jit(lambda p, t, c: JL.llm_verify_step(p, t, c, cfg_j))(params, jnp.asarray(fed), j_caches)
    t_logits, t_caches = TL.llm_verify_step(model, torch.from_numpy(fed), t_caches, cfg_t)
    assert t_logits.shape == (2, 4, 256) and t_caches[0]["length"].tolist() == [44, 44]
    assert float(cosine_similarity(t_logits.float(), _np(j_logits))) >= LLM_COS
    for i in range(4):
        s_logits, step_caches = TL.llm_decode_step(model, torch.from_numpy(fed[:, i]), step_caches, cfg_t)
        assert float(cosine_similarity(t_logits[:, i].float(), s_logits.float())) >= 0.99999, i
        assert torch.equal(torch.argmax(t_logits[:, i], -1), torch.argmax(s_logits, -1)), i


def test_hd512_speculative_generate_matches_jax(hd512, monkeypatch):
    """speculative_generate on the hd512 model (spec_k 4, the model itself
    through an int4 cache as the draft; the verify steps run kernel D's
    T-token instances laid out for 512 on the card): the tokens and the
    rounds equal JAX's speculative_generate of the same inputs (its prefill
    and verify step jitted: the same functions, traced once instead of op
    by op), and the port's generate."""
    monkeypatch.setattr(JL, "llm_prefill", jax.jit(JL.llm_prefill, static_argnames=("cfg", "attn_impl", "interpret")))
    monkeypatch.setattr(JL, "llm_verify_step", jax.jit(JL.llm_verify_step, static_argnames=("cfg", "interpret")))
    params, _, model, tokens = hd512
    cfg_j, cfg_t = _cfgs("int8")
    draft_j, draft_t = _cfgs("int4")
    prompt = tokens[:1, :12]
    j_toks, j_stats = JL.speculative_generate(params, jnp.asarray(prompt), 6, cfg_j, draft_params=params,
                                              draft_cfg=draft_j, spec_k=4, return_stats=True)
    t_toks, t_stats = TL.speculative_generate(model, torch.from_numpy(prompt), 6, cfg_t, draft_params=model,
                                              draft_cfg=draft_t, spec_k=4, return_stats=True)
    np.testing.assert_array_equal(t_toks.numpy(), np.asarray(j_toks))
    assert t_stats["rounds"] == j_stats["rounds"] and t_stats["mean_accepted"] == j_stats["mean_accepted"]
    assert torch.equal(t_toks, TL.generate(model, torch.from_numpy(prompt), 6, cfg_t))


SERVE = dict(page_size=8, num_pages=24, max_batch=2, prefix_caching=False)


@pytest.fixture(scope="module")
def jax_engine(hd512):
    """JAX's ServingEngine on the hd512 model (int8 pages of 8, 2 slots): 3
    requests of 12, 20 and 12 tokens (two prompt lengths: two prefill
    compiles), 5 new each; its streams and stats, made once."""
    params, _, _, tokens = hd512
    cfg_j, _ = _cfgs("int8")
    eng = JS.ServingEngine(params, cfg_j, JS.ServingConfig(**SERVE))
    rids = [eng.add_request(tokens[i % 2, : 12 + 8 * (i % 2)].tolist(), 5) for i in range(3)]
    out = eng.run()
    return [out[r] for r in rids], eng.stats()


def test_hd512_engine_streams_equal_jax(hd512, jax_engine):
    """The port's ServingEngine on the same requests and config (the paged
    decode ticks run kernel D's paged instances laid out for 512 on the
    card): the same token streams, request for request, and the same decode
    ticks and preemptions as JAX's."""
    _, _, model, tokens = hd512
    _, cfg_t = _cfgs("int8")
    eng = TS.ServingEngine(model, cfg_t, TS.ServingConfig(**SERVE))
    rids = [eng.add_request(tokens[i % 2, : 12 + 8 * (i % 2)].tolist(), 5) for i in range(3)]
    out = eng.run()
    j_streams, j_stats = jax_engine
    assert [list(out[r]) for r in rids] == [list(s) for s in j_streams]
    t_stats = eng.stats()
    for key in ("decode_ticks", "preemptions"):
        if key in j_stats:
            assert t_stats[key] == j_stats[key], key
