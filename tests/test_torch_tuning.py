"""Port parity: the tuning cache (``utils/tuning.py``) and the launch plans
that read it, against the JAX package.

* The cache's API is JAX's: the same calls with ``device=`` given return
  the same values and leave the same user file (keys, entries, the bundled
  layer under the user file, a corrupt file read as empty). Each package
  reads a variable and a default file of its own, and the port's bundled
  layer starts empty.
* The consult, through the pure plan functions (the CTA slots and SM count
  passed in, the device kind ``"cpu"`` of CPU tensors): a ``decode_k*v*``
  entry's ``waves`` sets kernel D's split plan for contiguous, unwindowed
  calls; a ``gemv_w*`` entry's ``max_splits`` caps the K splits of F1's
  ring plan and F2's tensor-core plan. Without an entry every plan is
  today's (the values below were computed by the code before the cache
  existed).
* Kernel D's plain version given a tuned plan's ``split_keys`` meets JAX's
  ``decode_attention`` (interpret mode) at ``tests/test_torch_decode.py``'s
  bounds in every cache mode on the f32 PV, where the plan moves only the
  summation order. (INT8 PV's codes follow the tiles, so its result moves
  with the plan: ``tests/test_torch_speculative.py`` holds that mode.)
"""

import json
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lowbit_quant_fa2_paddle_tpu.ops import decode as jd
from lowbit_quant_fa2_paddle_tpu.utils import tuning as jt
from lowbit_quant_fa2_paddle_tpu_torch.ops import decode as td
from lowbit_quant_fa2_paddle_tpu_torch.ops import gemv as tg
from lowbit_quant_fa2_paddle_tpu_torch.ops.metrics import cosine_similarity
from lowbit_quant_fa2_paddle_tpu_torch.utils import tuning as tt

# One intra-op thread: the suite runs a worker per core, and torch's thread
# pool, spinning under that load, slowed small CPU ops up to 50-fold.
torch.set_num_threads(1)

COS_MIN, MAX_DO, MAX_DLSE = 0.999999, 2e-6, 1e-5  # tests/test_torch_decode.py


@pytest.fixture()
def caches(tmp_path, monkeypatch):
    """Both packages' user caches in ``tmp_path``, their memory copies dropped."""
    paths = {"jax": str(tmp_path / "jax" / "tuning.json"), "torch": str(tmp_path / "torch" / "tuning.json")}
    monkeypatch.setenv("LOWBIT_FA_TUNING_CACHE", paths["jax"])
    monkeypatch.setenv("LOWBIT_FA_TORCH_TUNING_CACHE", paths["torch"])
    for mod in (jt, tt):
        mod.clear_memory_cache()
    yield paths
    for mod in (jt, tt):
        mod.clear_memory_cache()


def _both(fn):
    """``fn(module)`` on JAX's module and the port's; returns both results."""
    return fn(jt), fn(tt)


def _files(paths):
    out = []
    for key in ("jax", "torch"):
        with open(paths[key]) as f:
            out.append(json.load(f))
    return out


def test_record_lookup_roundtrip_matches_jax(caches):
    def calls(m):
        got = [m.lookup("km", 64, 4096, False, device="v5e")]
        got.append(m.record("km", 64, 4096, False, 2048, 512, 88.6, device="v5e"))
        got += [m.lookup("km", 64, 4096, False, device="v5e"), m.lookup("km", 64, 4096, True, device="v5e"),
                m.lookup("km", 64, 8192, False, device="v5e"), m.lookup("km", 64, 4096, False, device="other")]
        m.record("decode_k8v8", 128, 32768, False, 0, 0, device="v5e", extra={"waves": 0.5, "us": 101.5})
        got.append(m.lookup_entry("decode_k8v8", 128, 32768, False, device="v5e"))
        m.clear_memory_cache()  # survives a fresh in-process load
        got += [m.lookup("km", 64, 4096, False, device="v5e"), m.lookup_entry("decode_k8v8", 128, 32768, False,
                                                                                device="v5e")]
        return got

    j, t = _both(calls)
    assert j[1] == caches["jax"] and t[1] == caches["torch"]
    assert j[:1] + j[2:] == t[:1] + t[2:]
    assert t[2] == (2048, 512) and t[-1]["waves"] == 0.5
    fj, ft = _files(caches)
    assert fj == ft and fj["v5e|km|d64|s4096|c0"]["tflops"] == 88.6


def test_bundled_defaults_layer_matches_jax(caches, tmp_path, monkeypatch):
    bundled = tmp_path / "bundled.json"
    bundled.write_text(json.dumps({"v5e|km|d64|s1234|c0": {"block_q": 1024, "block_kv": 256, "tflops": 1.0}}))
    for mod in (jt, tt):
        monkeypatch.setattr(mod, "_bundled_path", lambda: str(bundled))
        mod.clear_memory_cache()

    def calls(m):
        got = [m.lookup("km", 64, 1234, False, device="v5e")]  # visible with no user cache...
        m.record("km", 64, 1234, False, 512, 512, 2.0, device="v5e")  # ...the user cache overrides it...
        got.append(m.lookup("km", 64, 1234, False, device="v5e"))
        m.record("km", 64, 9999, False, 256, 256, 3.0, device="v5e")
        m.clear_memory_cache()
        got.append(m.lookup("km", 64, 1234, False, device="v5e"))
        return got

    j, t = _both(calls)
    assert j == t == [(1024, 256), (512, 512), (512, 512)]
    fj, ft = _files(caches)
    # ...and the user cache FILE never absorbs bundled entries.
    assert fj == ft and set(ft) == {"v5e|km|d64|s1234|c0", "v5e|km|d64|s9999|c0"}


@pytest.mark.parametrize("garbage", ["{not json", ""])
def test_corrupt_cache_never_raises(caches, garbage):
    for path in caches.values():
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "w") as f:
            f.write(garbage)

    def calls(m):
        m.clear_memory_cache()
        got = [m.lookup("km", 64, 512, False), m.lookup_entry("gemv_w8", 4096, 4096, False)]
        m.record("km", 64, 512, False, 256, 256)  # and record still works (overwrites the corrupt file)
        return got + [m.lookup("km", 64, 512, False)]

    j, t = _both(calls)
    assert j == t == [None, None, (256, 256)]
    # On a CPU both key the default device "cpu".
    assert tt.device_kind() == jax.devices()[0].device_kind == "cpu"
    fj, ft = _files(caches)
    assert fj == ft and list(ft) == ["cpu|km|d64|s512|c0"]


def test_json_that_is_not_an_object_reads_as_empty(caches):
    """Valid JSON that is not an object (JAX's module raises on it) reads as
    an empty cache, and record replaces it."""
    os.makedirs(os.path.dirname(caches["torch"]), exist_ok=True)
    with open(caches["torch"], "w") as f:
        f.write("[1, 2]")
    assert tt.lookup("km", 64, 512, False) is None and tt.lookup_entry("km", 64, 512, False) is None
    tt.record("gemv_w8", 4096, 4096, False, 0, 0, extra={"max_splits": 2})
    assert tt.lookup_entry("gemv_w8", 4096, 4096, False)["max_splits"] == 2


@pytest.mark.parametrize("s", [0, 1, 2, 3, 5, 6, 7, 100, 181, 182, 1000, 4000, 4096, 5793, 5794, 32768, 33000, 131072,
                               133120, 185363, 185364, 200000])
def test_pow2_bucket_and_keys_match_jax(s):
    assert tt.pow2_bucket(s) == jt.pow2_bucket(s)
    assert tt._key("decode_k4v8", 128, tt.pow2_bucket(s), s % 2 == 1, "NVIDIA_H100") == \
        jt._key("decode_k4v8", 128, jt.pow2_bucket(s), s % 2 == 1, "NVIDIA_H100")


def test_the_port_keeps_its_own_file_and_starts_empty(monkeypatch):
    monkeypatch.delenv("LOWBIT_FA_TORCH_TUNING_CACHE", raising=False)
    monkeypatch.delenv("LOWBIT_FA_TUNING_CACHE", raising=False)
    assert tt.cache_path() != jt.cache_path() and tt.cache_path().endswith("lowbit_fa_torch/tuning.json")
    with open(tt._bundled_path()) as f:
        assert json.load(f) == {}
    with open(jt._bundled_path()) as f:
        assert all(key.startswith("TPU_") for key in json.load(f))  # TPU winners, not carried over
    assert tt.device_kind("cpu") == "cpu" and tt.device_kind(torch.device("cpu")) == "cpu"


# ---------------------------------------------------------------------------
# The consult: kernel D's split plan
# ---------------------------------------------------------------------------

#: Kernel D's plans before the cache existed: (S_max, CTAs, slots) -> (n_splits, split_keys).
TODAY_D = {(32768, 32, 528): (16, 2048), (32768, 32, 396): (12, 2752), (32768, 8, 528): (64, 512),
           (4096, 32, 264): (8, 512), (600, 8, 264): (10, 64), (131072, 32, 396): (12, 10944)}


def _decode_cache(b, h, hk, d, s, k_bits, v_bits):
    """A query and empty caches of the shapes and types a plan reads."""
    def side(bits):
        return torch.zeros((b, hk, s, d // 2 if bits == 4 else d), dtype=torch.bfloat16 if bits == 16 else torch.int8)

    return torch.zeros(b, h, d), side(k_bits), side(v_bits), torch.ones(b, hk, s), torch.ones(b, hk, s)


@pytest.mark.parametrize("key", list(TODAY_D))
def test_decode_plan_without_an_entry_is_todays(caches, key):
    s_max, ctas, slots = key
    assert td.num_splits(s_max, ctas, slots) == td.num_splits(s_max, ctas, slots, 1.0) == TODAY_D[key]
    # b4 x 8 KV heads x 1 row group = 32 CTAs at h32 (GQA 4: 4 rows a CTA).
    if ctas == 32:
        q, kq, vq, _, _ = _decode_cache(4, 32, 8, 32, s_max, 8, 8)
        plan = td.kernel_partition(q, kq, vq, int_qk=True, slots=slots)
        assert (plan["n_splits"], plan["split_keys"], plan["waves"]) == TODAY_D[key] + (td.WAVES,)


@pytest.mark.parametrize("waves", [0.25, 0.5, 2.0, 4.0, 3])
@pytest.mark.parametrize("bits", [(8, 8), (16, 16), (4, 4), (4, 8)])
def test_decode_entry_sets_the_waves(caches, waves, bits):
    kb, vb = bits
    b, h, hk, d, s, slots = 4, 32, 8, 32, 4096, 528
    q, kq, vq, _, _ = _decode_cache(b, h, hk, d, s, kb, vb)
    today = td.kernel_partition(q, kq, vq, int_qk=kb == 8, slots=slots)
    tt.record(f"decode_k{kb}v{vb}", d, tt.pow2_bucket(s), False, 0, 0, device="cpu", extra={"waves": waves})
    assert td.tuned_waves(kb, vb, d, s, "cpu") == waves
    assert td.tuned_waves(kb, vb, d, s, "meta") is None  # another device kind
    plan = td.kernel_partition(q, kq, vq, int_qk=kb == 8, slots=slots)
    want = td.num_splits(s, b * hk, slots, waves)
    assert (plan["n_splits"], plan["split_keys"], plan["waves"]) == want + (waves,)
    # At most `waves` waves of the card's slots (one split at least), at most MAX_SPLITS.
    assert want[0] * b * hk <= max(waves * slots, b * hk) and want[0] <= td.MAX_SPLITS
    assert want != (today["n_splits"], today["split_keys"])
    # Nearest power-of-two bucket: a cache of 4000 rows reads the 4096 entry, one of 6000 (8192) does not.
    for rows, tuned in ((4000, True), (6000, False)):
        q2, k2, v2, _, _ = _decode_cache(b, h, hk, d, rows, kb, vb)
        p2 = td.kernel_partition(q2, k2, v2, int_qk=kb == 8, slots=slots)
        assert p2["waves"] == (waves if tuned else td.WAVES)
    # Windowed and paged calls keep WAVES, as JAX consults only unwindowed contiguous calls; so do
    # other head dims and other cache bits, and an explicit waves wins.
    assert td.kernel_partition(q, kq, vq, int_qk=kb == 8, window=300, slots=slots)["waves"] == td.WAVES
    pool_k = kq[0].reshape(hk, s // 64, 64, -1)
    pool_v = vq[0].reshape(hk, s // 64, 64, -1)
    table = torch.arange(s // 64, dtype=torch.int32).repeat(b, 1)
    assert td.kernel_partition(q, pool_k, pool_v, int_qk=kb == 8, page_table=table, slots=slots)["waves"] == td.WAVES
    assert td.kernel_partition(q, kq, vq, int_qk=kb == 8, slots=slots, waves=1.0)["n_splits"] == today["n_splits"]
    other = (16, 16) if bits != (16, 16) else (8, 8)
    assert td.tuned_waves(*other, d, s, "cpu") is None and td.tuned_waves(kb, vb, 64, s, "cpu") is None


@pytest.mark.parametrize("bad", [0, -1, "2", None, True, float("nan"), float("inf")])
def test_a_bad_decode_entry_is_no_entry(caches, bad):
    tt.record("decode_k8v8", 32, 4096, False, 0, 0, device="cpu", extra={"waves": bad})
    tt.record("decode_k16v16", 32, 4096, False, 512, 1024, device="cpu")  # a JAX-style entry: no waves
    q, kq, vq, _, _ = _decode_cache(4, 32, 8, 32, 4096, 8, 8)
    assert td.tuned_waves(8, 8, 32, 4096, "cpu") is None and td.tuned_waves(16, 16, 32, 4096, "cpu") is None
    plan = td.kernel_partition(q, kq, vq, int_qk=True, slots=264)
    assert (plan["n_splits"], plan["split_keys"]) == TODAY_D[(4096, 32, 264)]
    with pytest.raises(ValueError, match="waves"):
        td.decode_attention(q, kq, vq, torch.ones(4, 8, 4096), torch.full((4,), 9, dtype=torch.int32),
                            v_scale=torch.ones(4, 8, 4096), waves=0)


# ---------------------------------------------------------------------------
# The consult: F1's and F2's K splits
# ---------------------------------------------------------------------------

#: The plans before the cache existed, at the full-width LLM's decode shapes (M 4, 132 SMs).
TODAY_TC = {(4096, 4096): (1, 8, 4, 4, 32), (1024, 4096): (1, 8, 4, 4, 8), (16384, 4096): (1, 3, 11, 8, 128),
            (4096, 16384): (1, 8, 16, 8, 32)}
TODAY_W8 = {(4096, 4096): ("direct", 1, 1, 8, 256), (1024, 4096): ("direct", 1, 1, 8, 64),
            (16384, 4096): ("ring", 1, 1, 8, 512), (4096, 16384): ("ring", 1, 4, 8, 512)}


@pytest.mark.parametrize("nk", list(TODAY_TC))
def test_gemv_plans_without_an_entry_are_todays(caches, nk):
    n, k = nk
    assert tg.tuned_max_splits(4, n, k, "cpu") is None and tg.tuned_max_splits(8, n, k, "cpu") is None
    assert tg.tc_plan(4, n, k, 4, 132) == tg.tc_plan(4, n, k, 4, 132, max_splits=tg.TC_MAX_SPLITS) == TODAY_TC[nk]
    assert tg.w8_plan(4, n, k, 132) == tg.w8_plan(4, n, k, 132, max_splits=tg.W8_MAX_SPLITS) == TODAY_W8[nk]


@pytest.mark.parametrize("cap", [1, 2, 4, 8, 16, 64])
def test_gemv_entry_caps_the_k_splits(caches, cap):
    n, k = 4096, 16384
    for bits in (4, 8):
        tt.record(f"gemv_w{bits}", k, tt.pow2_bucket(n), False, 0, 0, device="cpu", extra={"max_splits": cap})
        assert tg.tuned_max_splits(bits, n, k, "cpu") == cap
        assert tg.tuned_max_splits(bits, 5000, k, "cpu") == cap  # N 5000 reads the 4096 bucket
        assert tg.tuned_max_splits(bits, n, 4096, "cpu") is None  # another K
    # F2's tensor-core plan (w4 per-channel): at most cap ranges, and never above TC_MAX_SPLITS.
    mt, ksplit, cps, spc, gx = tg.tc_plan(4, n, k, 4, 132, max_splits=cap)
    assert ksplit == min(cap, TODAY_TC[(n, k)][1]) and mt == 1
    chunks = -(-(k // 2) // 64)
    assert (ksplit - 1) * cps < chunks <= ksplit * cps
    # F1's ring: at most cap ranges, never above W8_MAX_SPLITS.
    structure, mt, ksplit, tps, grid = tg.w8_plan(4, n, k, 132, max_splits=cap)
    assert structure == "ring" and ksplit == min(cap, TODAY_W8[(n, k)][2]) and grid == min(512 // 4 * ksplit, 528)
    # The direct and deep structures and plans over more than 8 rows take no split: the cap changes nothing.
    assert tg.w8_plan(4, 4096, 4096, 132, max_splits=cap) == TODAY_W8[(4096, 4096)]
    assert tg.w8_plan(4, n, k, 132, x_int8=True, max_splits=cap) == tg.w8_plan(4, n, k, 132, x_int8=True)
    assert tg.tc_plan(16, n, k, 4, 132, max_splits=cap) == tg.tc_plan(16, n, k, 4, 132)
    assert tg.w8_plan(16, n, k, 132, max_splits=cap) == tg.w8_plan(16, n, k, 132)


@pytest.mark.parametrize("bad", [0, -2, 2.5, "4", True, None])
def test_a_bad_gemv_entry_is_no_entry(caches, bad):
    tt.record("gemv_w4", 4096, 4096, False, 0, 512, device="cpu", extra={"max_splits": bad})
    assert tg.tuned_max_splits(4, 4096, 4096, "cpu") is None
    x = torch.randn(4, 256)
    with pytest.raises(ValueError, match="max_splits"):
        tg.wq_matmul_per_channel(x, *tg.pack_weights_per_channel(torch.randn(64, 256), bits=8), max_splits=0)


# ---------------------------------------------------------------------------
# Kernel D's plain version at a tuned plan, against JAX
# ---------------------------------------------------------------------------


def _jax_inputs(b, h, hk, d, s, k_bits, v_bits, seed):
    rng = np.random.default_rng(seed)
    k = rng.standard_normal((b, hk, s, d)).astype(np.float32)
    v = rng.standard_normal((b, hk, s, d)).astype(np.float32)
    q = rng.standard_normal((b, h, d)).astype(np.float32)
    quant = jax.jit(jd.quantize_token, static_argnames="bits")
    kq, ks = quant(jnp.asarray(k), bits=k_bits)
    vq, vs = quant(jnp.asarray(v), bits=v_bits)
    return q, kq, vq, ks, vs


def _t(x) -> torch.Tensor:
    a = np.array(x.astype(jnp.float32) if x.dtype == jnp.bfloat16 else x)
    return torch.from_numpy(a).to(torch.bfloat16) if x.dtype == jnp.bfloat16 else torch.from_numpy(a)


@pytest.mark.parametrize("mode", ["int8", "bf16", "int4", "k4v8"])
@pytest.mark.parametrize("waves", [0.5, 4.0])
def test_plain_version_at_a_tuned_plan_matches_jax(caches, mode, waves):
    kb, vb, cm = {"int8": (8, 8, "auto"), "bf16": (16, 16, "auto"), "int4": (4, 4, "auto"),
                  "k4v8": (4, 8, "int_qk")}[mode]
    b, h, hk, d, s, slots = 4, 8, 2, 64, 2500, 264
    q, kq, vq, ks, vs = _jax_inputs(b, h, hk, d, s, kb, vb, seed=len(mode) + int(waves))
    tt.record(f"decode_k{kb}v{vb}", d, tt.pow2_bucket(s), False, 0, 0, device="cpu", extra={"waves": waves})
    tq, tk, tv = torch.from_numpy(q), _t(kq), _t(vq)
    int_qk = kb != 16 and (kb == 8 or cm != "auto")
    plan = td.kernel_partition(tq, tk, tv, int_qk=int_qk, slots=slots)
    today = td.num_splits(s, b * hk, slots)
    assert (plan["n_splits"], plan["split_keys"]) == td.num_splits(s, b * hk, slots, waves) != today
    chunk = plan["split_keys"]
    lengths = np.array([s, chunk - 1, chunk + 1, 2 * chunk + 1], np.int32)
    to, tl = td.decode_attention_plain(tq, tk, tv, _t(ks), _t(vs) if vb != 16 else None, torch.from_numpy(lengths),
                                       sm_scale=1.0 / math.sqrt(d), int_qk=int_qk, out_dtype=torch.float32,
                                       split_keys=chunk, warps=plan["warps"])
    jo, jl = jd.decode_attention(jnp.asarray(q), kq, vq, ks, jnp.asarray(lengths), v_scale=vs, k_bits=kb, v_bits=vb,
                                 compute_mode=cm, return_lse=True)
    jo, jl = torch.from_numpy(np.array(jo)), torch.from_numpy(np.array(jl))
    assert torch.isfinite(to).all() and float(cosine_similarity(to, jo)) >= COS_MIN
    assert float((to - jo).abs().max()) <= MAX_DO
    assert float((tl - jl).abs().max()) <= MAX_DLSE
    # The entry point on CPU tensors runs the same plain version (the plan is the card's).
    got = td.decode_attention(tq, tk, tv, _t(ks), torch.from_numpy(lengths), v_scale=_t(vs), k_bits=kb, v_bits=vb,
                              compute_mode=cm)
    assert torch.equal(got, to)
