"""Port parity: DiT training (``diffusion_loss``, ``sgd_train_step``) against
the JAX package on tiny_config at b2 s64 (and on tiny_config(dim=512,
num_heads=2), whose heads are 256 wide: the kernels' head_dim-256 backward
on the card), with the JAX package's random
parameters (loaded through ``params_from_jax``), the same numpy latents, and
``t`` and ``noise`` drawn exactly as JAX's ``diffusion_loss`` draws them from
its key.

Bounds (measured on a CPU, one step at lr 1e-2, for each of exact,
flash_train and int8_train):

* the loss within 2e-3 relative (measured 8.4e-4 to 8.6e-4): both sides
  round every dense layer to bf16, in different places (PyTorch's linear
  adds the bias before rounding, XLA after);
* each updated leaf that starts nonzero within 1 bf16 ulp of its max|p|
  (measured <= 0.12): ``lr·g`` is below half an ulp of most weights;
* each zero-initialised bias, whose new value is the whole update
  ``-bf16(lr·g)``: cosine of the updates >= 0.8 (measured >= 0.85 on the
  time embedding's input bias, whose gradient, ~1e-4, is set by the adaLN
  path's bf16 roundings; >= 0.99 in the blocks).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lowbit_quant_fa2_paddle_tpu.models import dit as jdit
from lowbit_quant_fa2_paddle_tpu_torch.models import dit as tdit

# One intra-op thread: the suite runs a worker per core, and torch's thread
# pool, spinning under that load, slowed small CPU ops up to 50-fold.
torch.set_num_threads(1)

LR = 1e-2
IMPLS = ["exact", "flash_train", "int8_train"]


def _t(x):
    return torch.from_numpy(np.array(jnp.asarray(x).astype(jnp.float32)))


#: tiny_config with 256-wide heads.
HD256 = dict(dim=512, num_heads=2)


def _setup(**kw):
    cfg_j = jdit.tiny_config(**kw)
    params = jdit.init_dit_params(jax.random.PRNGKey(0), cfg_j)
    tree = jax.tree_util.tree_map(lambda a: np.asarray(a.astype(jnp.float32)), params)
    x0 = jnp.asarray(np.random.default_rng(1).standard_normal((2, 64, cfg_j.dim)).astype(np.float32), cfg_j.dtype)
    key = jax.random.PRNGKey(3)
    # JAX's diffusion_loss draws these from the key; the port takes them.
    kt, kn = jax.random.split(key)
    t = jax.random.uniform(kt, (x0.shape[0],), minval=0.0, maxval=1.0)
    noise = jax.random.normal(kn, x0.shape, x0.dtype)
    port = (_t(x0).bfloat16(), _t(t), _t(noise).bfloat16())
    return cfg_j, params, tree, x0, key, port


@pytest.fixture(scope="module")
def setup():
    return _setup()


@pytest.fixture(scope="module")
def setup256():
    return _setup(**HD256)


def _model(tree, **kw):
    return tdit.params_from_jax(tree, tdit.tiny_config(**kw), device="cpu")


def _leaves(model, jtree):
    """(name, port tensor, JAX leaf) for every dense weight and bias."""
    mods = [("t_in", model.t_in, jtree["t_embed"]["in"]), ("t_out", model.t_out, jtree["t_embed"]["out"])]
    for i, (blk, p) in enumerate(zip(model.blocks, jtree["blocks"])):
        mods += [(f"blocks.{i}.{n}", getattr(blk, n), p[n]) for n in ("qkv", "proj", "mlp_in", "mlp_out", "ada")]
    mods.append(("final", model.final, jtree["final"]))
    for name, lin, p in mods:
        yield name + ".w", lin.weight.detach().float().T, p["w"]
        yield name + ".b", lin.bias.detach().float(), p["b"]


def _cos64(a, b):
    return float(torch.nn.functional.cosine_similarity(a.double().reshape(-1), b.double().reshape(-1), dim=0))


def _check_step(setup, impl, **kw):
    cfg_j, params, tree, x0, key, (xb, t, noise) = setup
    new, loss_j = jax.jit(lambda p: jdit.sgd_train_step(p, x0, key, cfg_j, lr=LR, attn_impl=impl))(params)
    model = _model(tree, **kw)
    assert model.cfg.head_dim == cfg_j.head_dim
    loss = tdit.sgd_train_step(model, xb, t, noise, lr=LR, attn_impl=impl)
    assert loss.dtype == torch.float32 and loss.dim() == 0
    assert abs(float(loss) / float(loss_j) - 1.0) <= 2e-3
    old = {name: _t(p) for name, _, p in _leaves(_model(tree, **kw), params)}
    for name, got, want in _leaves(model, new):
        want = _t(want)
        if float(old[name].abs().max()) > 0:
            ulp = 2.0 ** (math.floor(math.log2(float(want.abs().max()))) - 7)
            assert float((got - want).abs().max()) <= ulp, name
        else:
            assert _cos64(got / LR, want / LR) >= 0.8, name


@pytest.mark.parametrize("impl", IMPLS)
def test_sgd_train_step_matches_jax(setup, impl):
    _check_step(setup, impl)


@pytest.mark.parametrize("impl", ["flash_train", "int8_train"])
def test_sgd_train_step_matches_jax_at_head_dim_256(setup256, impl):
    """One step of the tiny DiT with two 256-wide heads, at the bounds of
    test_sgd_train_step_matches_jax."""
    _check_step(setup256, impl, **HD256)


@pytest.mark.parametrize("impl", IMPLS)
def test_loss_falls_over_three_steps(setup, impl):
    """As the JAX package's own DiT training tests ask: a fixed batch, lr
    1e-2, three steps."""
    *_, tree, _, _, (xb, t, noise) = setup
    model = _model(tree)
    losses = [float(tdit.sgd_train_step(model, xb, t, noise, lr=LR, attn_impl=impl)) for _ in range(3)]
    assert np.isfinite(losses).all() and losses[-1] < losses[0], losses


def test_sgd_step_rounds_the_update_first(setup):
    """``p - bf16(lr·g)``, rounded again: JAX's ``p - lr * g.astype(p.dtype)``.
    One rounding (``add_(g, alpha=-lr)``) gives other bf16 values."""
    *_, tree, _, _, (xb, t, noise) = setup
    model = _model(tree)
    params = list(model.parameters())
    before = [p.detach().clone() for p in params]
    grads = torch.autograd.grad(tdit.diffusion_loss(model, xb, t, noise), params)
    tdit.sgd_train_step(model, xb, t, noise, lr=LR)
    once_differs = False
    for p, p0, g in zip(params, before, grads):
        assert torch.equal(p.detach(), p0 - LR * g.to(p0.dtype)), p.shape
        once_differs |= not torch.equal(p.detach(), p0.add(g, alpha=-LR))
        assert p.grad is None
    assert once_differs


def test_draw_t_noise():
    x0 = torch.zeros(3, 8, 16, dtype=torch.bfloat16)
    t, noise = tdit.draw_t_noise(x0, torch.Generator().manual_seed(0))
    t2, noise2 = tdit.draw_t_noise(x0, torch.Generator().manual_seed(0))
    assert t.shape == (3,) and t.dtype == torch.float32 and bool(((t >= 0) & (t < 1)).all())
    assert noise.shape == x0.shape and noise.dtype == x0.dtype
    assert torch.equal(t, t2) and torch.equal(noise, noise2)
