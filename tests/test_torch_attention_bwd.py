"""Port parity: the FA-2 backward (kernels G1/G2 and their plain version)
and the trainable attention functions, against the JAX package on the same
numpy inputs.

``flash_bwd`` is held to JAX's ``_flash_bwd`` called directly (Pallas in
interpret mode, one block at these lengths), both fed JAX's forward ``o`` and
``lse2`` so the two backwards see one softmax. Bounds, with max|d| in bf16
ulps of the gradient's max|.| (measured on a CPU):

* bf16 inputs and the quantized mode (C1's codes equal JAX's): cos >= 0.99999,
  max|d| <= 1 ulp (measured <= 0.25): the same roundings in another order;
* f32 inputs: cos >= 0.9999, max|d| <= 4 ulps (measured <= 1.8): the port
  rounds q, k, v and dO to bf16 for the tensor cores, JAX dots f32.

The trainable functions through ``torch.autograd.grad`` against ``jax.grad``:
cos >= 0.9999, max|d| <= 4 ulps (measured cos >= 0.99999, <= 2.6 ulps). JAX's
forward LSE is off the fp32 oracle by up to 1.1e-2 (base 2) at s256, from its
bf16 ``exp2`` (ROADMAP Queue 3); its backward then forms p from it, the
port's from its own 2^x forward. Against the port's fp32 oracle under
autograd: cos >= 0.999 for ``flash_attention_trainable`` and the quantized
backward (measured >= 0.99998 and >= 0.9998), and the int8-forward function
is held to the fp one at cos >= 0.99, as the JAX package's own test holds it.
"""

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lowbit_quant_fa2_paddle_tpu.ops import attention_bwd as jbwd
from lowbit_quant_fa2_paddle_tpu.ops.attention import flash_attention_fp as jax_flash_fp
from lowbit_quant_fa2_paddle_tpu_torch.ops import attention_bwd as tbwd
from lowbit_quant_fa2_paddle_tpu_torch.ops.metrics import cosine_similarity
from lowbit_quant_fa2_paddle_tpu_torch.ops.reference import attention_reference

# One intra-op thread: the suite runs a worker per core, and torch's thread
# pool, spinning under that load, slowed small CPU ops up to 50-fold.
torch.set_num_threads(1)


def _t(x, dtype=torch.float32):
    return torch.from_numpy(np.array(jnp.asarray(x).astype(jnp.float32))).to(dtype)


def _ulps(got, want):
    """max|got - want| in bf16 ulps of max|want|."""
    top = float(want.float().abs().max())
    return float((got.float() - want.float()).abs().max()) / 2.0 ** (math.floor(math.log2(top)) - 7)


def _inputs(seed, h, hk, s, d, dtype):
    rng = np.random.default_rng(seed)
    q, do = (rng.standard_normal((1, h, s, d)).astype(np.float32) for _ in range(2))
    k, v = (rng.standard_normal((1, hk, s, d)).astype(np.float32) for _ in range(2))
    return tuple(jnp.asarray(x, dtype) for x in (q, k + 0.3, v, do))


# name: (dtype, causal, h, hk, s, d, quantized, window)
BWD_CASES = {
    "bf16": (jnp.bfloat16, False, 4, 4, 256, 64, False, 0),
    "bf16-causal": (jnp.bfloat16, True, 4, 4, 256, 64, False, 0),
    "f32": (jnp.float32, False, 4, 4, 256, 64, False, 0),
    "f32-causal": (jnp.float32, True, 4, 4, 256, 64, False, 0),
    "gqa-hk2-causal": (jnp.bfloat16, True, 4, 2, 256, 64, False, 0),
    "gqa-hk1": (jnp.bfloat16, False, 4, 1, 256, 64, False, 0),
    "ragged-s300-causal": (jnp.bfloat16, True, 4, 4, 300, 64, False, 0),
    "d128": (jnp.bfloat16, False, 4, 4, 256, 128, False, 0),
    "d32-causal-gqa": (jnp.bfloat16, True, 4, 2, 200, 32, False, 0),
    "quantized": (jnp.bfloat16, False, 4, 4, 256, 64, True, 0),
    "quantized-causal-gqa-s300": (jnp.bfloat16, True, 4, 2, 300, 64, True, 0),
    "window64-s384": (jnp.bfloat16, True, 4, 4, 384, 64, False, 64),
    "d128-causal-gqa-s301": (jnp.bfloat16, True, 4, 2, 301, 128, False, 0),
    "window128-gqa-hk2-s384": (jnp.bfloat16, True, 4, 2, 384, 64, False, 128),
    # Head_dim 256 (the kernels' d256 instances on the card; 192 pads to them).
    "d256": (jnp.bfloat16, False, 2, 2, 160, 256, False, 0),
    "d256-f32-causal": (jnp.float32, True, 2, 2, 160, 256, False, 0),
    "d256-quantized-causal-gqa": (jnp.bfloat16, True, 4, 2, 130, 256, True, 0),
    "d256-window48-gqa": (jnp.bfloat16, True, 4, 2, 192, 256, False, 48),
    "d192-causal-gqa": (jnp.bfloat16, True, 4, 2, 150, 192, False, 0),
    "d192-quantized": (jnp.bfloat16, False, 2, 1, 128, 192, True, 0),
}


@pytest.mark.parametrize("name", list(BWD_CASES))
def test_flash_bwd_matches_jax(name):
    dtype, causal, h, hk, s, d, quantized, window = BWD_CASES[name]
    q, k, v, do = _inputs(0, h, hk, s, d, dtype)
    sm = 1.0 / math.sqrt(d)
    o, lse2 = jax_flash_fp(q, k, v, is_causal=causal, window_size=window or None, sm_scale=sm, return_lse=True)
    o = o.astype(dtype)
    fn = jax.jit(functools.partial(jbwd._flash_bwd, is_causal=causal, sm_scale=sm, quantized=quantized,
                                   window=window))
    want = fn(q, k, v, o, lse2, do)
    tdt = torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32
    got = tbwd.flash_bwd(*(_t(x, tdt) for x in (q, k, v, o)), _t(lse2), _t(do, tdt), is_causal=causal, sm_scale=sm,
                         quantized=quantized, window=window)
    cos_min, max_ulps = (0.9999, 4.0) if dtype == jnp.float32 else (0.99999, 1.0)
    for grad, a, b in zip(("dq", "dk", "dv"), got, want):
        b = _t(b)
        assert a.dtype == tdt and a.shape == b.shape, grad
        assert float(cosine_similarity(a, b)) >= cos_min, grad
        assert _ulps(a, b) <= max_ulps, grad


def _port_grads(fn, q, k, v, tgt, dtype, *args):
    qt, kt, vt = (_t(x, dtype).requires_grad_() for x in (q, k, v))
    o = fn(qt, kt, vt, *args)
    assert o.dtype == dtype
    return torch.autograd.grad((o.float() * _t(tgt)).sum(), (qt, kt, vt))


def _oracle_grads(q, k, v, tgt, causal):
    qt, kt, vt = (_t(x).requires_grad_() for x in (q, k, v))
    return torch.autograd.grad((attention_reference(qt, kt, vt, is_causal=causal) * _t(tgt)).sum(), (qt, kt, vt))


TRAINABLE = {
    "flash": (jbwd.flash_attention_trainable, tbwd.flash_attention_trainable, ()),
    "lowbit": (jbwd.lowbit_attention_trainable, tbwd.lowbit_attention_trainable, ()),
    "lowbit-bwd-quantized": (jbwd.lowbit_attention_trainable, tbwd.lowbit_attention_trainable,
                             (None, None, None, True)),
}


@pytest.mark.parametrize("window", [32, 100])
@pytest.mark.parametrize("dtype", [jnp.bfloat16, jnp.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("fn", list(TRAINABLE))
def test_trainable_window_grads_match_jax(fn, dtype, window):
    """Both trainable functions with a causal sliding window (kernel A's
    band forward, G1/G2's window backward), GQA 4q/2kv, s 256, against
    ``jax.grad`` of the JAX functions at test_trainable_grads_match_jax's
    bounds."""
    jfn, tfn, _ = TRAINABLE[fn]
    # The positional arguments before window_size: sm_scale, block_q, block_kv (and bwd_quantized).
    extra = {"flash": (None,) * 3, "lowbit": (None,) * 3 + (False,), "lowbit-bwd-quantized": (None,) * 3 + (True,)}[fn]
    q, k, v, tgt = _inputs(5, 4, 2, 256, 64, dtype)
    tgt = tgt.astype(jnp.float32)
    want = jax.grad(lambda q, k, v: jnp.sum(jfn(q, k, v, True, *extra, window).astype(jnp.float32) * tgt),
                    (0, 1, 2))(q, k, v)
    tdt = torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32
    got = _port_grads(tfn, q, k, v, tgt, tdt, True, *extra, window)
    for grad, a, b in zip("qkv", got, want):
        b = _t(b)
        assert a.dtype == tdt and a.shape == b.shape, grad
        assert float(cosine_similarity(a, b)) >= 0.9999, grad
        assert _ulps(a, b) <= 4.0, grad


@pytest.mark.parametrize("dtype", [jnp.bfloat16, jnp.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("fn", list(TRAINABLE))
def test_trainable_grads_match_jax(fn, causal, dtype):
    jfn, tfn, extra = TRAINABLE[fn]
    q, k, v, tgt = _inputs(1, 4, 2, 256, 64, dtype)
    tgt = tgt.astype(jnp.float32)
    want = jax.grad(lambda q, k, v: jnp.sum(jfn(q, k, v, causal, *extra).astype(jnp.float32) * tgt),
                    (0, 1, 2))(q, k, v)
    tdt = torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32
    got = _port_grads(tfn, q, k, v, tgt, tdt, causal, *extra)
    for grad, a, b in zip("qkv", got, want):
        b = _t(b)
        assert a.dtype == tdt and a.shape == b.shape, grad
        assert float(cosine_similarity(a, b)) >= 0.9999, grad
        assert _ulps(a, b) <= 4.0, grad


@pytest.mark.parametrize("window", [0, 40])
@pytest.mark.parametrize("fn", list(TRAINABLE))
def test_trainable_grads_match_jax_at_head_dim_256(fn, window):
    """Both trainable functions at head_dim 256 (bf16, causal, GQA 4q/2kv,
    s 128, with and without a window) against ``jax.grad`` of the JAX
    functions: cos >= 0.99999 and max|d| <= 4 ulps."""
    jfn, tfn, _ = TRAINABLE[fn]
    extra = {"flash": (None,) * 3, "lowbit": (None,) * 3 + (False,), "lowbit-bwd-quantized": (None,) * 3 + (True,)}[fn]
    q, k, v, tgt = _inputs(6, 4, 2, 128, 256, jnp.bfloat16)
    tgt = tgt.astype(jnp.float32)
    want = jax.grad(lambda q, k, v: jnp.sum(jfn(q, k, v, True, *extra, window or None).astype(jnp.float32) * tgt),
                    (0, 1, 2))(q, k, v)
    got = _port_grads(tfn, q, k, v, tgt, torch.bfloat16, True, *extra, window or None)
    for grad, a, b in zip("qkv", got, want):
        b = _t(b)
        assert a.dtype == torch.bfloat16 and a.shape == b.shape, grad
        assert float(cosine_similarity(a, b)) >= 0.99999, grad
        assert _ulps(a, b) <= 4.0, grad


@pytest.mark.parametrize("causal", [False, True])
def test_trainable_grads_track_the_fp32_oracle(causal):
    q, k, v, tgt = _inputs(2, 4, 2, 256, 64, jnp.float32)
    oracle = _oracle_grads(q, k, v, tgt, causal)
    flash = _port_grads(tbwd.flash_attention_trainable, q, k, v, tgt, torch.float32, causal)
    lowbit = _port_grads(tbwd.lowbit_attention_trainable, q, k, v, tgt, torch.float32, causal)
    quantized = _port_grads(tbwd.lowbit_attention_trainable, q, k, v, tgt, torch.float32, causal, None, None, None,
                            True)
    for grad, f, lb, qz, o in zip("qkv", flash, lowbit, quantized, oracle):
        assert float(cosine_similarity(f, o)) >= 0.999, grad
        assert float(cosine_similarity(qz, o)) >= 0.999, grad
        assert float(cosine_similarity(lb, f)) >= 0.99, grad


def test_window_size_raises_and_blocks_change_nothing():
    """``window_size`` runs on both trainable functions (it raised before
    kernel A took the window): its gradients equal JAX's at the bounds of
    test_trainable_grads_match_jax and differ from full causal ones; the
    backward tile sizes change nothing."""
    q, k, v, tgt = _inputs(3, 2, 2, 130, 64, jnp.bfloat16)
    tgt32 = tgt.astype(jnp.float32)
    for jfn, fn, extra in ((jbwd.flash_attention_trainable, tbwd.flash_attention_trainable, (None,) * 3 + (64,)),
                           (jbwd.lowbit_attention_trainable, tbwd.lowbit_attention_trainable,
                            (None,) * 3 + (False, 64))):
        got = _port_grads(fn, q, k, v, tgt, torch.bfloat16, True, *extra)
        want = jax.grad(lambda q, k, v: jnp.sum(jfn(q, k, v, True, *extra).astype(jnp.float32) * tgt32),
                        (0, 1, 2))(q, k, v)
        for a, b in zip(got, want):
            assert float(cosine_similarity(a, _t(b))) >= 0.9999 and _ulps(a, _t(b)) <= 4.0
        base = _port_grads(fn, q, k, v, tgt, torch.bfloat16, True)
        assert not torch.equal(got[0], base[0])
        tiled = _port_grads(fn, q, k, v, tgt, torch.bfloat16, True, None, 64, 128)
        assert all(torch.equal(a, b) for a, b in zip(base, tiled))


def test_kernel_design_by_mode():
    """bf16 operands (the training path) and int8 codes both run on the wgmma
    design, whose launches each wrapper counts apart."""
    assert tbwd.kernel_design() == tbwd.kernel_design(False) == tbwd.kernel_design(True) == "wgmma"
    assert tbwd.DESIGNS == ("wgmma",)
    for fn in (tbwd.attention_bwd_dq, tbwd.attention_bwd_dkv):
        assert set(fn.launches_by_design) == set(tbwd.DESIGNS)


@pytest.mark.parametrize("quantized,causal,window", [(False, False, 0), (False, True, 48), (True, True, 0)],
                         ids=["float", "float-window48", "quantized-causal"])
def test_plain_version_is_independent_of_its_chunks(monkeypatch, quantized, causal, window):
    """p comes from the final LSE, so the backward's rounding depends on no
    tile: attention_bwd_plain gives the same gradients whatever its q-row
    chunks (1 row, 7 rows, all rows), up to the order of its f32 sums (dk and
    dv add the chunks; a one-row QK^T takes another BLAS path), within a
    sixteenth of a bf16 ulp of max|grad| (measured 1/256). So the kernels of
    either design, whatever their tiles, differ from it only in summation
    order, unlike kernel A's plain version, which follows A's KV tile."""
    q, k, v, do = _inputs(4, 4, 2, 150, 64, jnp.bfloat16)
    o, lse2 = jax_flash_fp(q, k, v, is_causal=causal, window_size=window or None, return_lse=True)
    args, kw = tbwd.bwd_operands(*(_t(x, torch.bfloat16) for x in (q, k, v, o)), _t(lse2), _t(do, torch.bfloat16),
                                 is_causal=causal, sm_scale=0.125, quantized=quantized, window=window)
    outs = []
    for rows in (1, 7, 150):
        monkeypatch.setattr(tbwd, "_PLAIN_CHUNK_ELEMS", rows * 4 * 150)
        outs.append(tbwd.attention_bwd_plain(*args, **kw, dq_dtype=torch.float32, dkv_dtype=torch.float32))
    for other in outs[1:]:
        for a, b in zip(outs[0], other):
            assert float((a - b).abs().max()) <= float(a.abs().max()) * 2.0**-12
