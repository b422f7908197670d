"""Port parity: the DiT denoiser of the PyTorch package against the JAX
package, on the JAX package's own random parameters (loaded through
``params_from_jax``) and the same numpy latents.

Three denoise steps ``x <- x - 0.1 * eps`` per attention impl at
tiny_config(dim=256, num_heads=4, depth=2), s256, bf16. Both sides round
every dense layer to bf16, but in different places (PyTorch's linear adds
the bias before rounding, XLA after), so the bound is a frame cosine of
0.9999 and an MSE of 1e-4 for each impl, not bit equality (measured on a
CPU: cos 0.999999, MSE 2e-6 for exact, fp and int8; int4 and int8_v8 the
same bounds). The port's low-bit
paths must also track its own exact path as the JAX e2e regression demands
(cos > 0.99, MSE < 0.5).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lowbit_quant_fa2_paddle_tpu.models import dit as jdit
from lowbit_quant_fa2_paddle_tpu_torch.models import dit as tdit
from lowbit_quant_fa2_paddle_tpu_torch.ops.metrics import cosine_similarity, mse

# One intra-op thread: the suite runs a worker per core, and torch's thread
# pool, spinning under that load, slowed small CPU ops up to 50-fold.
torch.set_num_threads(1)

STEPS, SEQ = 3, 256


@pytest.fixture(scope="module")
def models():
    cfg_j = jdit.tiny_config(num_heads=4, dim=256, depth=2)
    params = jdit.init_dit_params(jax.random.PRNGKey(0), cfg_j)
    tree = jax.tree_util.tree_map(lambda a: np.asarray(a.astype(jnp.float32)), params)
    cfg_t = tdit.tiny_config(num_heads=4, dim=256, depth=2)
    x0 = np.random.default_rng(1).standard_normal((1, SEQ, cfg_t.dim)).astype(np.float32)
    return cfg_j, params, tdit.params_from_jax(tree, cfg_t, device="cpu"), x0


def _timesteps():
    return [1000.0 * (1.0 - i / STEPS) for i in range(STEPS)]


def _jax_generate(cfg, params, x0, impl):
    step = jax.jit(lambda x, t: x - 0.1 * jdit.dit_forward(params, x, t, cfg, attn_impl=impl))
    x = jnp.asarray(x0, cfg.dtype)
    for t in _timesteps():
        x = step(x, jnp.array([t]))
    return torch.from_numpy(np.array(x.astype(jnp.float32)))


@torch.no_grad()
def _port_generate(model, x0, impl):
    x = torch.from_numpy(x0).to(model.cfg.dtype)
    for t in _timesteps():
        x = x - 0.1 * tdit.dit_forward(model, x, torch.tensor([t]), attn_impl=impl)
    return x.float()


def test_params_from_jax_layout(models):
    _, params, model, _ = models
    w = np.asarray(params["blocks"][1]["qkv"]["w"].astype(jnp.float32))
    assert torch.equal(model.blocks[1].qkv.weight.float(), torch.from_numpy(w.T.copy()))
    assert model.blocks[0].ada.weight.dtype == torch.bfloat16


@pytest.mark.parametrize("impl", ["exact", "fp", "int8", "int4", "int8_v8"])
def test_denoise_steps_track_jax(models, impl):
    cfg_j, params, model, x0 = models
    want = _jax_generate(cfg_j, params, x0, impl)
    got = _port_generate(model, x0, impl)
    assert got.shape == want.shape and torch.isfinite(got).all()
    assert float(cosine_similarity(got, want)) >= 0.9999, impl
    assert float(mse(got, want)) <= 1e-4, impl


def test_int8_tracks_exact(models):
    _, _, model, x0 = models
    base = _port_generate(model, x0, "exact")
    for impl in ("int8", "int8_t", "int8_v8", "int4", "fp"):
        out = _port_generate(model, x0, impl)
        assert float(cosine_similarity(out, base)) > 0.99, impl
        assert float(mse(out, base)) < 0.5, impl


def test_init_dit_params_distributions():
    cfg = tdit.tiny_config(dim=256, num_heads=4, depth=1)
    model = tdit.init_dit_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    blk = model.blocks[0]
    assert abs(float(blk.qkv.weight.detach().float().std()) - 1 / 16) < 3e-3
    assert abs(float(blk.ada.weight.detach().float().std()) - 0.02) < 2e-3
    d = cfg.dim
    gates = blk.ada.bias.detach().float()
    assert gates[2 * d : 3 * d].eq(1).all() and gates[5 * d :].eq(1).all()
    assert gates[: 2 * d].eq(0).all() and gates[3 * d : 5 * d].eq(0).all()
    x = torch.randn(1, 64, d, generator=torch.Generator().manual_seed(1)).bfloat16()
    out = tdit.dit_forward(model, x, torch.tensor([500.0]), attn_impl="int8")
    assert out.shape == x.shape and torch.isfinite(out.float()).all()


def test_transposed_impls_run_the_plain_paths(models):
    """``int4_t`` is the TPU's layout device for ``int4``: the same values."""
    _, _, model, x0 = models
    x = torch.from_numpy(x0[:, :96]).bfloat16()
    t = torch.tensor([500.0])
    for impl in ("int4", "int8"):
        want = tdit.dit_forward(model, x, t, attn_impl=impl)
        assert torch.equal(tdit.dit_forward(model, x, t, attn_impl=impl + "_t"), want), impl


def test_unknown_impl_raises(models):
    _, _, model, x0 = models
    x = torch.from_numpy(x0[:, :64]).bfloat16()
    with pytest.raises(ValueError, match="unknown attn_impl"):
        tdit.dit_forward(model, x, torch.tensor([1.0]), attn_impl="int3")


@pytest.mark.parametrize("bits", [8, 4])
def test_quantize_dit_params_bit_exact_and_shares_the_rest(models, bits):
    _, params, model, _ = models
    jq = jdit.quantize_dit_params(params, bits=bits)
    tq = tdit.quantize_dit_params(model, bits=bits)
    for i, blk in enumerate(tq.blocks):
        for key in ("qkv", "proj", "mlp_in", "mlp_out"):
            w, jw = getattr(blk, key), jq["blocks"][i][key]
            np.testing.assert_array_equal(w.packed.numpy(), np.asarray(jw["wq"].packed))
            np.testing.assert_array_equal(w.scale.numpy(), np.asarray(jw["wq"].scale))
            assert torch.equal(w.bias, getattr(model.blocks[i], key).bias)
        assert blk.ada is model.blocks[i].ada and blk.num_heads == model.blocks[i].num_heads
    assert tq.t_in is model.t_in and tq.final is model.final


@pytest.mark.parametrize("bits,cos_min", [(8, 0.9999), (4, 0.995)])
def test_packed_forward_tracks_jax(models, bits, cos_min):
    """One forward of s256 (256 rows: the packed-matmul route) with int8
    attention. w4 rounds its dot, which carries 7·scale·sum(x), to bf16
    before the zero-point term takes that out (as JAX does; 3-6% off the
    exact product for inputs with a mean), so a summation-order flip moves
    an output by an ulp of the larger dot: bound 0.995 (measured on a CPU:
    0.99729; w8 passes 0.9999)."""
    cfg_j, params, model, x0 = models
    jq = jdit.quantize_dit_params(params, bits=bits)
    tq = tdit.quantize_dit_params(model, bits=bits)
    want = jdit.dit_forward(jq, jnp.asarray(x0, cfg_j.dtype), jnp.array([500.0]), cfg_j, attn_impl="int8")
    with torch.no_grad():
        got = tdit.dit_forward(tq, torch.from_numpy(x0).bfloat16(), torch.tensor([500.0]), attn_impl="int8")
    want = torch.from_numpy(np.asarray(want.astype(jnp.float32)))
    assert got.shape == want.shape and torch.isfinite(got.float()).all()
    assert float(cosine_similarity(got, want)) >= cos_min
