"""Port parity: the DiT's training layouts (``parallel/dryrun.py``,
``parallel/sharded.py``'s FSDP) against the JAX package's, on the same
parameters and latents.

The port's side runs once for the module in 8 gloo rank processes
(``utils/parallel_cases.dryrun_suite``) on inputs this module draws with
JAX and writes first: the FSDP forward over data 4, one int8_train step
through the FSDP layout over data 4 and over data 3, one sharded int8_train
step over data 2 × seq 2 × model 2 at JAX's dry-run shapes (tiny_config with
4 heads and dim 256, batch 4, 256 tokens), and ``run_training_step_dryrun(8)``.
The JAX side runs ``dit_forward`` under ``fsdp_shardings`` and
``sgd_train_step`` under ``param_shardings`` on the 8-device CPU mesh (Pallas
in interpret mode); the port runs its kernels' plain versions.

Bounds: the FSDP forward within JAX's own test_fsdp bound (|d| <= 2e-2 +
2e-2·|y|, here elementwise on the port against JAX); the sharded step at
tests/test_torch_dit_train.py's bounds (the loss within 2e-3 relative, each
updated tensor that starts nonzero within one bf16 ulp of its max|p|, each
zero-initialised bias at a cosine of the updates >= 0.8), at its lr 1e-2.
JAX's FSDP test runs only a forward; the FSDP step is held at the same bounds
to the port's single-process ``sgd_train_step``.
"""

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from lowbit_quant_fa2_paddle_tpu.models import dit as jdit
from lowbit_quant_fa2_paddle_tpu.parallel import dryrun as jdryrun, mesh as jmesh, sharded as jsharded
from lowbit_quant_fa2_paddle_tpu_torch.models import dit as tdit
from lowbit_quant_fa2_paddle_tpu_torch.parallel import dryrun, mesh as M, sharded
from lowbit_quant_fa2_paddle_tpu_torch.utils import parallel_cases as pc

# One intra-op thread: the suite runs a worker per core, and torch's thread
# pool, spinning under that load, slowed small CPU ops up to 50-fold.
torch.set_num_threads(1)

RANK_TIMEOUT_S = 600
FSDP_TOL = 2e-2
STEP_CFG = dict(num_heads=4, dim=256)  # JAX's dry run at 8 devices: model 2
STEP_B, STEP_S = 4, 256


def _tree_np(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(jnp.asarray(a, jnp.float32)), tree)


def _tree_torch(tree):
    return jax.tree_util.tree_map(lambda a: torch.from_numpy(np.array(a)), _tree_np(tree))


def _flat(tree):
    """{JAX path ("blocks/0/qkv/w"): leaf} of a DiT parameter tree."""
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        out["/".join(str(getattr(p, "key", getattr(p, "idx", None))) for p in path)] = leaf
    return out


def _inputs():
    """JAX's test_fsdp inputs at batch 4 and JAX's dry-run step inputs: the
    parameters from PRNGKey(0), latents from PRNGKey(1), and the t and noise
    that diffusion_loss draws from PRNGKey(2)."""
    cfg = jdit.tiny_config()
    fsdp = {"params": jdit.init_dit_params(jax.random.PRNGKey(0), cfg),
            "x": jax.random.normal(jax.random.PRNGKey(1), (4, 64, cfg.dim), cfg.dtype), "t": jnp.full((4,), 5.0)}
    scfg = jdit.tiny_config(**STEP_CFG)
    x0 = jax.random.normal(jax.random.PRNGKey(1), (STEP_B, STEP_S, scfg.dim), scfg.dtype)
    key = jax.random.PRNGKey(2)
    kt, kn = jax.random.split(key)
    step = {"params": jdit.init_dit_params(jax.random.PRNGKey(0), scfg), "x0": x0, "key": key,
            "t": jax.random.uniform(kt, (STEP_B,), minval=0.0, maxval=1.0),
            "noise": jax.random.normal(kn, x0.shape, x0.dtype)}
    return cfg, fsdp, scfg, step


def _fsdp_step_inputs():
    """Latents, t in [0, 1) and noise for the FSDP training step, a row for
    each rank of the widest data degree, from a numpy seed (f32; the step
    takes them in bf16)."""
    rng = np.random.RandomState(7)
    b, s, d = max(pc.FSDP_STEP_DATA), 64, jdit.tiny_config().dim
    return {"x0": torch.from_numpy(rng.standard_normal((b, s, d)).astype(np.float32)),
            "t": torch.from_numpy(rng.uniform(size=b).astype(np.float32)),
            "noise": torch.from_numpy(rng.standard_normal((b, s, d)).astype(np.float32))}


class Ranks:
    def __init__(self, tmp_path_factory):
        self.dir = str(tmp_path_factory.mktemp("dryrun"))
        self.cfg, self.fsdp, self.scfg, self.step = _inputs()
        self.fsdp_step = _fsdp_step_inputs()
        f, st = self.fsdp, self.step
        torch.save({"fsdp": {"tree": _tree_torch(f["params"]), "x": torch.from_numpy(np.array(f["x"], np.float32)),
                             "t": torch.from_numpy(np.array(f["t"]))},
                    "fsdp_step": self.fsdp_step,
                    "step": {"tree": _tree_torch(st["params"]), **STEP_CFG,
                             **{k: torch.from_numpy(np.array(st[k], np.float32)) for k in ("x0", "t", "noise")}}},
                   f"{self.dir}/inputs.pt")
        self.procs = pc.spawn("dryrun", pc.DRYRUN_WORLD, self.dir)
        self._results = None

    @property
    def results(self):
        if self._results is None:
            pc.wait(self.procs, self.dir, RANK_TIMEOUT_S)
            self._results = torch.load(f"{self.dir}/results.pt", weights_only=False)
        return self._results

    def close(self):
        for p in self.procs:
            if p.poll() is None:
                p.kill()
            p.wait()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    r = Ranks(tmp_path_factory)
    yield r
    r.close()


def _spec(sharding):
    return tuple(sharding.spec)


def _jax_dim(spec):
    return next((i for i, a in enumerate(spec) if a is not None), None)


@pytest.mark.parametrize("which", ["tiny", "cogvideox_2b"])
def test_fsdp_shardings_match_jax(which):
    """The sharded dimension of every leaf, JAX's rule read on JAX's layout,
    over data 4: tiny_config and CogVideoX-2b's width (shapes only: the
    port's model on the meta device, JAX's under eval_shape)."""
    make = {"tiny": (jdit.tiny_config, tdit.tiny_config),
            "cogvideox_2b": (jdit.cogvideox_2b_config, tdit.cogvideox_2b_config)}[which]
    cfg_j, cfg_t = make[0](depth=2), make[1](depth=2)
    shapes = jax.eval_shape(lambda: jdit.init_dit_params(jax.random.PRNGKey(0), cfg_j))
    want = {k: _jax_dim(_spec(s)) for k, s in _flat(jsharded.fsdp_shardings(shapes, jmesh.make_mesh({"data": 4}),
                                                                            axis="data")).items()}
    mesh = M.Mesh({"data": 4, "pp": 1, "seq": 1, "model": 1}, None, {})
    got = sharded.fsdp_shardings(tdit.DiT(cfg_t, device="meta"), mesh)
    assert got == want
    if which == "tiny":  # JAX's test: every 2D weight sharded (128 % 4 == 0 throughout)
        assert all(got[k] is not None for k in got if k.endswith("/w"))


@pytest.mark.parametrize("which", ["tiny", "dryrun"])
def test_param_shardings_match_jax(which):
    cfg_kw = {} if which == "tiny" else STEP_CFG
    cfg_j, cfg_t = jdit.tiny_config(**cfg_kw), tdit.tiny_config(**cfg_kw)
    params = jdit.init_dit_params(jax.random.PRNGKey(0), cfg_j)
    mesh = jmesh.make_mesh(jdryrun._factor(8))
    want = {k: _spec(s) for k, s in _flat(jdryrun.param_shardings(params, mesh)).items()}
    got = dryrun.param_shardings(tdit.DiT(cfg_t, device="meta"))
    assert got == want


@pytest.mark.parametrize("n", [1, 2, 3, 4, 6, 8, 12, 16])
def test_factor_matches_jax(n):
    assert dryrun._factor(n) == jdryrun._factor(n)


def test_fsdp_forward_matches_jax(ranks):
    """The port's FSDP forward (4 ranks, a batch row each, every unit's
    tensors gathered on use) against JAX's dit_forward under fsdp_shardings
    (attn_impl="exact"), and the shards: each rank holds a quarter of every
    weight, and the gathered shards are the parameters again."""
    cfg, f = ranks.cfg, ranks.fsdp
    mesh = jmesh.make_mesh({"data": 4})
    params = jax.device_put(f["params"], jsharded.fsdp_shardings(f["params"], mesh, axis="data"))
    want = np.asarray(jax.jit(lambda p, x, t: jdit.dit_forward(p, x, t, cfg, attn_impl="exact"))(
        params, f["x"], f["t"]), np.float32)
    r = ranks.results["fsdp"]
    got = r["o"].float().numpy()
    assert got.shape == want.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=FSDP_TOL, rtol=FSDP_TOL)
    assert r["shard_shapes"]["blocks.0.qkv.weight"] == (3 * cfg.dim // 4, cfg.dim)  # JAX's dim 1 of w [in, out]
    spec = sharded.fsdp_shardings(tdit.DiT(tdit.tiny_config(), device="meta"),
                                  M.Mesh({"data": 4, "pp": 1, "seq": 1, "model": 1}, None, {}))
    assert r["wire"]["fsdp.gather"]["calls"] == sum(d is not None for d in spec.values())  # each gathered once
    for path, leaf in _flat(_tree_np(f["params"])).items():
        back = _flat(r["gathered"])[path]
        np.testing.assert_array_equal(back, np.asarray(jnp.asarray(leaf, cfg.dtype).astype(jnp.float32)))


@pytest.mark.parametrize("data", pc.FSDP_STEP_DATA)
def test_fsdp_train_step_matches_single_process_step(ranks, data):
    """One int8_train SGD step through the FSDP layout (a batch row a rank;
    the gathers' backwards reduce-scatter the gradients, the replicated
    leaves' copies all-reduce theirs) against the port's single-process
    ``sgd_train_step`` on the same rows, at ``_check_step``'s bounds. At
    data 3 the time embedding and the 128-wide biases stay whole: each must
    have its gradient summed over the axis once and come out of the step the
    same on every rank."""
    cfg = tdit.tiny_config()
    r = ranks.results[f"fsdp step data{data}"]
    inp = {k: v[:data] for k, v in ranks.fsdp_step.items()}
    model = tdit.params_from_jax(_tree_np(ranks.fsdp["params"]), cfg, device="cpu")
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    loss_ref = tdit.sgd_train_step(model, inp["x0"].to(cfg.dtype), inp["t"], inp["noise"].to(cfg.dtype),
                                   lr=pc.STEP_LR, attn_impl="int8_train")
    check = pc._check_step(r["loss"], loss_ref, tdit.params_from_jax(r["tree"], cfg, device="cpu"), model, before,
                           pc.STEP_LR)
    assert check.pop("ok"), check
    assert r["replicated_differ"] == []
    assert len(r["replicated"]) > 0 if data == 3 else r["replicated"] == []
    assert r["wire"].get("fsdp.replicated.bwd", {"calls": 0})["calls"] == len(r["replicated"])


def test_sharded_int8_train_step_matches_jax(ranks):
    """One int8_train step on 8 ranks (data 2 × seq 2 × model 2; qkv cut by
    whole heads, K and V gathered over seq) against JAX's sgd_train_step
    jitted under param_shardings on the 8-device mesh, same parameters,
    batch and key; the updated shards gathered back whole."""
    cfg, st = ranks.scfg, ranks.step
    mesh = jmesh.make_mesh(jdryrun._factor(8))
    params = jax.device_put(st["params"], jdryrun.param_shardings(st["params"], mesh))
    batch = jax.device_put(st["x0"], NamedSharding(mesh, P("data", "seq", None)))
    step = jax.jit(functools.partial(jdit.sgd_train_step, cfg=cfg, lr=pc.STEP_LR, attn_impl="int8_train"))
    with mesh:
        new, loss_j = step(params, batch, st["key"])
    r = ranks.results["step"]
    assert math.isfinite(r["loss"]) and abs(r["loss"] / float(loss_j) - 1.0) <= 2e-3
    old, new, got = _flat(_tree_np(st["params"])), _flat(_tree_np(new)), _flat(r["tree"])
    assert set(got) == set(new)
    for path, want in new.items():
        g = got[path].astype(np.float64)
        if np.abs(old[path]).max() > 0:
            ulp = 2.0 ** (math.floor(math.log2(float(np.abs(want).max()))) - 7)
            assert float(np.abs(g - want).max()) <= ulp, path
        else:
            a, b = g.reshape(-1) / pc.STEP_LR, want.astype(np.float64).reshape(-1) / pc.STEP_LR
            assert float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b))) >= 0.8, path


def test_sharded_step_reduces_gradients_over_data_and_seq(ranks):
    """Each rank holds the tensor-parallel shards for 2 of 4 heads, and what
    it sends: one all-reduce of the f32 gradient bucket over data and one
    over seq, the loss over both, and no gradient over model (the row- and
    column-parallel exchanges carry the activations and their gradients)."""
    r = ranks.results["step"]
    cfg = tdit.tiny_config(**STEP_CFG)
    full = sum(p.numel() for p in tdit.DiT(cfg, device="meta").parameters())
    wire = r["wire"]
    assert r["n_params"] < full
    assert wire["grads"]["calls"] == 2 and wire["grads"]["bytes"] == {"float32": 2 * 4 * r["n_params"]}
    assert wire["loss"]["calls"] == 2
    # Forward: per block one sum after proj and one after mlp_out, K and V gathered; the backward mirrors them.
    for site, calls in (("tp.proj", 2), ("tp.mlp_out", 2), ("tp.qkv_in.bwd", 2), ("tp.mlp_in.bwd", 2),
                        ("seq.k", 2), ("seq.v", 2), ("seq.k.bwd", 2), ("seq.v.bwd", 2)):
        assert wire[site]["calls"] == calls, site


def test_run_training_step_dryrun_completes_on_8_ranks(ranks):
    r = ranks.results["dryrun"]
    assert r["degrees"] == {"data": 2, "seq": 2, "model": 2}
    assert math.isfinite(r["loss"])


def test_tensor_parallel_cut_is_head_aligned():
    """The physical cut of qkv takes q, k and v each for the rank's whole
    heads (JAX's spec cuts the fused columns into contiguous blocks); the
    other cuts follow JAX's spec; gathering the shards of every model rank
    gives the model back."""
    cfg = tdit.tiny_config(num_heads=4, dim=256)
    model = tdit.init_dit_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    h, hd, d = cfg.num_heads, cfg.head_dim, cfg.dim
    w = model.blocks[0].qkv.weight.detach()
    for idx in range(2):
        mesh = M.Mesh({"data": 1, "pp": 1, "seq": 1, "model": 2}, {"data": 0, "pp": 0, "seq": 0, "model": idx}, {})
        tp = dryrun.TPDiT.from_model(model, mesh)
        blk = tp.blocks[0]
        got = blk.qkv.weight.detach().view(3, 2, hd, d)
        assert torch.equal(got, w.view(3, h, hd, d)[:, 2 * idx:2 * idx + 2])
        assert torch.equal(blk.proj.weight, model.blocks[0].proj.weight[:, idx * 2 * hd:(idx + 1) * 2 * hd])
        assert torch.equal(blk.proj.bias, model.blocks[0].proj.bias)
        mlp = model.blocks[0].mlp_in.weight.shape[0] // 2
        assert torch.equal(blk.mlp_in.weight, model.blocks[0].mlp_in.weight[idx * mlp:(idx + 1) * mlp])
        assert torch.equal(blk.mlp_out.weight, model.blocks[0].mlp_out.weight[:, idx * mlp:(idx + 1) * mlp])
        assert torch.equal(blk.ada.weight, model.blocks[0].ada.weight)


def test_one_rank_sharded_step_is_the_step():
    """On a mesh of one rank the sharded step is ``sgd_train_step``: the same
    loss and the same updated bits."""
    cfg = tdit.tiny_config()
    model = tdit.init_dit_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    tp = dryrun.TPDiT.from_model(model, M.make_mesh({}))
    x0 = torch.randn(2, 64, cfg.dim, generator=torch.Generator().manual_seed(1)).bfloat16()
    t, noise = tdit.draw_t_noise(x0, torch.Generator().manual_seed(2))
    loss = tdit.sgd_train_step(model, x0, t, noise, lr=pc.STEP_LR, attn_impl="int8_train")
    loss_tp = dryrun.sharded_sgd_train_step(tp, x0, t, noise, lr=pc.STEP_LR, attn_impl="int8_train")
    assert float(loss) == float(loss_tp)
    for (n, p), (_, q) in zip(model.named_parameters(), tp.gathered().named_parameters()):
        assert torch.equal(p, q), n
