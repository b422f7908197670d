"""Port parity: the parallel layer (``lowbit_quant_fa2_paddle_tpu_torch.parallel``)
against the JAX package's, on the same numpy inputs.

The port's side runs in real processes over gloo: one world of 8 ranks runs
every case of ``utils/parallel_cases.CPU_CASES`` on the mesh it names, and a
world of 2 joins through torchrun's variables (``init_distributed``), each
started once for the module over a ``file://`` rendezvous under the test's
temporary directory. The JAX side runs the ``make_*`` wrappers on the
8-device CPU mesh (Pallas in interpret mode); the port runs its kernels'
plain versions.

Tolerances, port vs JAX, each the port's single-device bound against JAX:
attention (ring, Ulysses, head-parallel, the facade; ``test_torch_attention``)
cos >= 0.9999, max|do| <= 2e-2, max|dlse| <= 2e-2; decode
(``test_torch_decode``) cos >= 0.999999, max|do| <= 2e-6; the pipelined DiT
(``test_torch_dit``) a cosine of 0.9999 and an MSE of 1e-4. Port vs the dense
fp32 oracle, JAX's own bounds: cos > 0.999 (> 0.99 with packed INT4 K), LSE
within 5e-2 + 1e-2·|lse|; and the pipeline within 5e-2 + 5e-2·|y| of the
port's sequential forward.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from lowbit_quant_fa2_paddle_tpu.models import dit as jdit
from lowbit_quant_fa2_paddle_tpu.parallel import mesh as jmesh, ring as jring, ulysses as julysses
from lowbit_quant_fa2_paddle_tpu.parallel import pipeline as jpipeline, serving as jserving, sharded as jsharded
from lowbit_quant_fa2_paddle_tpu_torch.models import dit as tdit
from lowbit_quant_fa2_paddle_tpu_torch.ops.metrics import cosine_similarity, mse
from lowbit_quant_fa2_paddle_tpu_torch.ops.reference import attention_reference
from lowbit_quant_fa2_paddle_tpu_torch.parallel import ring as tring, transport
from lowbit_quant_fa2_paddle_tpu_torch.parallel.ulysses import ulysses_attention
from lowbit_quant_fa2_paddle_tpu_torch.utils import parallel_cases as pc

# One intra-op thread: the suite runs a worker per core, and torch's thread
# pool, spinning under that load, slowed small CPU ops up to 50-fold.
torch.set_num_threads(1)

COS_MIN, MAX_DO, MAX_DLSE = 0.9999, 2e-2, 2e-2
DECODE_COS, DECODE_MAX_DO = 0.999999, 2e-6
RANK_TIMEOUT_S = 600


class Ranks:
    """The port's rank processes, started once for the module; results are
    read when a test first needs them."""

    def __init__(self, tmp_path_factory):
        self.dirs = {"cpu": str(tmp_path_factory.mktemp("world8")), "init": str(tmp_path_factory.mktemp("world2"))}
        self.procs = {"cpu": pc.spawn("cpu", pc.CPU_WORLD, self.dirs["cpu"]),
                      "init": pc.spawn("init", 2, self.dirs["init"], env_rank=True)}
        self.results = {}

    def __getitem__(self, suite):
        if suite not in self.results:
            pc.wait(self.procs[suite], self.dirs[suite], RANK_TIMEOUT_S)
            self.results[suite] = torch.load(f"{self.dirs[suite]}/results.pt")
        return self.results[suite]

    def close(self):
        for procs in self.procs.values():
            for p in procs:
                if p.poll() is None:
                    p.kill()
                p.wait()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    r = Ranks(tmp_path_factory)
    yield r
    r.close()


def _np(x) -> np.ndarray:
    return np.array(jnp.asarray(x, jnp.float32))


def _close(port, want, lse_port=None, lse_want=None, cos_min=COS_MIN, max_do=MAX_DO, max_dlse=MAX_DLSE):
    want = torch.from_numpy(_np(want))
    port = port.float()
    assert port.shape == want.shape
    assert torch.isfinite(port).all()
    assert float(cosine_similarity(port, want)) >= cos_min
    assert float((port - want).abs().max()) <= max_do
    if lse_port is not None:
        lse_want = torch.from_numpy(_np(lse_want))
        assert lse_port.shape == lse_want.shape
        assert float((lse_port - lse_want).abs().max()) <= max_dlse


def _jax_ulysses_fn(mesh, **kw):
    """JAX's ``ulysses_attention`` itself under shard_map (sequence-sharded)."""
    spec = P(None, None, "seq", None)
    fn = functools.partial(julysses.ulysses_attention, axis_name="seq", **kw)
    return jax.jit(jax.shard_map(fn, mesh=mesh, in_specs=(spec, spec, spec), out_specs=spec, check_vma=False))


def _jax_attention(name):
    kind, degrees, spec, kw = pc.CPU_CASES[name]
    q, k, v = (jnp.asarray(x, getattr(jnp, spec[-1])) for x in pc.case_inputs(name))
    mesh = jmesh.make_mesh(degrees)
    make = {"ring": jring.make_ring_attention, "ulysses": julysses.make_ulysses_attention,
            "ulysses_fn": _jax_ulysses_fn, "head_parallel": jsharded.make_head_parallel_attention,
            "facade": jsharded.make_parallel_attention}[kind]
    out = make(mesh, **kw)(q, k, v)
    return out if kw.get("return_lse") else (out, None)


def _oracle(name):
    _, _, spec, kw = pc.CPU_CASES[name]
    q, k, v = (torch.from_numpy(x) for x in pc.case_inputs(name))
    return attention_reference(q, k, v, is_causal=kw.get("is_causal", False), window_size=kw.get("window_size"),
                               return_lse=True)


ATTENTION_CASES = [n for n, c in pc.CPU_CASES.items() if c[0] in pc.ATTN_SPECS and not n.startswith("payload")]


@pytest.mark.parametrize("name", ATTENTION_CASES)
def test_attention_matches_jax(ranks, name):
    """Ring (non-causal, causal, k_bits=4/v_bits=8, a window, GQA with the
    LSE, degree 8), Ulysses (both wires, GQA, and ``smooth_k=False`` on the
    float route through the facade and through ``ulysses_attention``
    itself: K smoothed all the same, as JAX's), head-parallel and the 3-D
    facade (data x seq x model, both strategies) against JAX's wrappers, and
    against the dense oracle at JAX's bounds."""
    r = ranks["cpu"][name]
    o_j, lse_j = _jax_attention(name)
    _close(r["o"], o_j, r.get("lse"), lse_j)
    o_ref, lse_ref = _oracle(name)
    cos_min = 0.99 if pc.CPU_CASES[name][3].get("k_bits") == 4 else 0.999
    assert float(cosine_similarity(r["o"].float(), o_ref)) > cos_min
    if "lse" in r:
        assert bool(((r["lse"] - lse_ref).abs() <= 5e-2 + 1e-2 * lse_ref.abs()).all())


@pytest.mark.parametrize("name", [n for n, c in pc.CPU_CASES.items() if c[0].endswith("decode")])
def test_sharded_decode_matches_jax(ranks, name):
    """Context-sharded decode at JAX's lengths cases (every shard full; shards
    left partly and wholly empty) and head-sharded decode, against JAX's
    wrappers and single-device decode."""
    from lowbit_quant_fa2_paddle_tpu.ops import decode as jdec

    kind, degrees, _, _ = pc.CPU_CASES[name]
    q, kc, ks, vc, vs, lengths = (jnp.asarray(x) for x in pc.case_inputs(name))
    mesh = jmesh.make_mesh(degrees)
    if kind == "context_decode":
        fn = jserving.make_context_sharded_decode(mesh, block_kv=128)
    else:
        fn = jserving.make_head_sharded_decode(mesh)
    o = ranks["cpu"][name]["o"]
    _close(o, fn(q, kc, vc, ks, lengths, vs), cos_min=DECODE_COS, max_do=DECODE_MAX_DO)
    _close(o, jdec.decode_attention(q, kc, vc, ks, lengths, v_scale=vs), cos_min=DECODE_COS, max_do=DECODE_MAX_DO)


@pytest.mark.parametrize("name", [n for n, c in pc.CPU_CASES.items() if c[0] == "pipeline"])
def test_pipelined_dit_matches_jax(ranks, name):
    """``make_pipelined_dit`` at JAX's (pp, microbatches) cases against JAX's
    on the same weights and latents, and against the port's sequential
    forward at JAX's bound."""
    _, degrees, _, kw = pc.CPU_CASES[name]
    cfg, model, x, t = pc.case_inputs(name)
    jcfg = jdit.tiny_config(depth=cfg.depth)
    params = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jcfg.dtype), tdit.params_to_jax(model))
    pp = degrees["pp"]
    mesh = Mesh(np.array(jax.devices()[:pp]), ("pp",))
    fn = jax.jit(jpipeline.make_pipelined_dit(mesh, jcfg, microbatches=kw["microbatches"]))
    want = torch.from_numpy(_np(fn(params, jnp.asarray(x, jcfg.dtype), jnp.asarray(t))))
    r = ranks["cpu"][name]
    got = r["o"].float()
    assert got.shape == want.shape and torch.isfinite(got).all()
    assert float(cosine_similarity(got, want)) >= 0.9999
    assert float(mse(got, want)) <= 1e-4
    seq = r["sequential"].float()
    assert bool(((got - seq).abs() <= 5e-2 + 5e-2 * seq.abs()).all())
    # Every step but the last shifts one microbatch's activations.
    m = kw["microbatches"]
    assert r["wire"]["pipeline.shift"]["calls"] == m + pp - 2


@pytest.mark.parametrize("name,calls", [("payload-int8", 3), ("payload-k4", 3), ("payload-v8", 3),
                                        ("payload-window", 2)])
def test_ring_payload_is_codes(ranks, name, calls):
    """The ring's wire carries codes, counted by the transport on rank 0: int8
    K codes are half a bf16 ring's K bytes, packed INT4 K a quarter, int8 V
    codes half of bf16 V; f32 scale rows ride beside them; a window of 100
    over shards of 64 runs 3 hops and so sends only 2 shifts."""
    _, _, spec, kw = pc.CPU_CASES[name]
    b, _, hk, s, d = spec[2], spec[3], spec[4], spec[5], spec[6]
    s_loc = s // 4
    bf16_k = 2 * b * hk * s_loc * d  # what a bf16 ring sends for K a hop
    sent = ranks["cpu"][name]["wire"]["ring.kv"]
    assert sent["calls"] == calls
    per_hop = {k: v / calls for k, v in sent["bytes"].items()}
    k_bytes = bf16_k // 4 if kw.get("k_bits") == 4 else bf16_k // 2
    if kw.get("v_bits") == 8:
        assert per_hop == {"int8": k_bytes + bf16_k // 2, "float32": 4 * b * hk * (s_loc + d)}
    else:
        assert per_hop == {"int8": k_bytes, "bfloat16": bf16_k, "float32": 4 * b * hk * s_loc}
    assert tring.n_hops(4, s_loc, kw.get("window_size")) == calls + 1
    assert ranks["cpu"][name]["wire"]["ring.k_mean"]["bytes"] == {"float32": 4 * b * hk * d}


def test_ulysses_wire8_sends_half_the_bytes(ranks):
    """Ulysses' reshard carries int8 Q/K/V codes and f32 scale rows under
    ``wire_bits=8``: half the bf16 all-to-alls' bytes, plus the rows."""
    bf16 = ranks["cpu"]["payload-ulysses"]["wire"]
    int8 = ranks["cpu"]["payload-ulysses-wire8"]["wire"]
    for side in ("q", "k", "v"):
        assert set(bf16[f"ulysses.{side}"]["bytes"]) == {"bfloat16"}
        assert int8[f"ulysses.{side}"]["bytes"] == {"int8": bf16[f"ulysses.{side}"]["bytes"]["bfloat16"] // 2}
    assert int8["ulysses.v_amax"]["bytes"] == {"float32": 4 * 4 * 64}  # [B, Hk, D] column maxima


def test_two_process_init_all_reduce_and_ring(ranks):
    """Two processes join through torchrun's RANK/WORLD_SIZE (init_distributed),
    all-reduce, and run causal ring attention over both (JAX's
    test_distributed_init), against JAX's ring on a 2-device mesh and the
    oracle."""
    r = ranks["init"]
    assert r["world"] == 2 and torch.equal(r["all_reduce"], torch.full((3,), 3.0))
    q, k, v = pc.qkv_inputs(*pc.INIT_RING[1:])
    o_j = jring.make_ring_attention(jmesh.make_mesh({"seq": 2}), is_causal=True)(q, k, v)
    _close(r["o"], o_j)
    o_ref = attention_reference(*(torch.from_numpy(x) for x in (q, k, v)), is_causal=True)
    assert float(cosine_similarity(r["o"].float(), o_ref)) > 0.999


def test_one_rank_ring_is_single_device_attention():
    """A group of one (``None``) is the identity: the ring is one hop of
    kernel A on int8 Q codes and equals the single-device path's result, and
    nothing goes on the wire."""
    from lowbit_quant_fa2_paddle_tpu_torch.core import lowbit_fa_qk_int8_pv_fp16

    q, k, v = (torch.from_numpy(x) for x in pc.qkv_inputs(0, 1, 4, 2, 100, 64, 0.5, "float32"))
    transport.WIRE.reset()
    for causal in (False, True):
        o, lse = tring.ring_attention(q, k, v, group=None, is_causal=causal, return_lse=True)
        o_1, lse_1 = lowbit_fa_qk_int8_pv_fp16(q, k, v, is_causal=causal, return_lse=True)
        assert float((o - o_1).abs().max()) <= 1e-6 and float((lse - lse_1).abs().max()) <= 1e-5
    assert transport.WIRE.summary() == {}


def test_bad_arguments_raise():
    q = torch.randn(1, 4, 64, 64)
    with pytest.raises(ValueError, match="attn_fn"):
        ulysses_attention(q, q, q, group=None, wire_bits=8, attn_fn=lambda *a: a[0])
    with pytest.raises(ValueError, match="k_bits"):
        tring.ring_attention(q, q, q, group=None, k_bits=2)
    with pytest.raises(ValueError, match="is_causal"):
        tring.ring_attention(q, q, q, group=None, window_size=16)


def test_ulysses_heads_that_do_not_divide_raise(ranks):
    """Six heads over four Ulysses ranks raise on every rank, before any
    exchange."""
    assert "do not divide over 4 Ulysses ranks" in ranks["cpu"]["ulysses-indivisible"]


def test_ring_hops_under_a_window():
    assert [tring.n_hops(4, 64, w) for w in (None, 1, 2, 65, 66, 129, 130, 1000)] == [4, 1, 2, 2, 3, 3, 4, 4]
    assert tring.n_hops(8, 100, 250) == 4
