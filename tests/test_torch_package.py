"""Package checks for the PyTorch/CUDA port, plus its kernel-vs-plain tests.

The CPU checks: importing the port loads no JAX; CPU tensors never touch a
kernel (launch counters stay 0); the kernels build for sm_90a from this
repository's sources only, with exact (not fast) math; model and cache
constructors build on the CUDA card unless told otherwise.

The tests marked ``gpu`` compare each CUDA kernel with its plain PyTorch
version on the card and skip without one. This file imports no JAX, so on a
machine without it they run with
``python -m pytest --noconftest tests/test_torch_package.py -m gpu``.
"""

import inspect
import itertools
import math
import os
import subprocess
import sys

import pytest
import torch

from lowbit_quant_fa2_paddle_tpu_torch.ops import _build
from lowbit_quant_fa2_paddle_tpu_torch.ops import attention as lowbit_attention_ops
from lowbit_quant_fa2_paddle_tpu_torch.ops.attention import LOG2E, attention_fwd_plain, lowbit_attention
from lowbit_quant_fa2_paddle_tpu_torch.utils import bwd_cases, decode_cases, mask_cases
from lowbit_quant_fa2_paddle_tpu_torch.ops.attention_bwd import (
    attention_bwd_dkv,
    attention_bwd_dq,
    attention_bwd_plain,
    bwd_operands,
    flash_bwd,
)
from lowbit_quant_fa2_paddle_tpu_torch.models import dit, llm
from lowbit_quant_fa2_paddle_tpu_torch.ops import gemv
from lowbit_quant_fa2_paddle_tpu_torch.ops import decode as decode_ops
from lowbit_quant_fa2_paddle_tpu_torch.ops import fused_kv as fused_kv_ops
from lowbit_quant_fa2_paddle_tpu_torch.ops.decode import (
    decode_attention,
    decode_attention_plain,
    init_kv_cache,
    quantize_token,
)
from lowbit_quant_fa2_paddle_tpu_torch.ops.fused_kv import (
    fused_kv_attention_plain,
    fused_packed_kv_attention,
    quant_kv_grouped,
)
from lowbit_quant_fa2_paddle_tpu_torch.ops.metrics import cosine_similarity
from lowbit_quant_fa2_paddle_tpu_torch.ops.quant import (
    k_mean,
    kernel_design,
    quant_int2,
    quant_int2_plain,
    quant_int4,
    quant_int4_plain,
    quant_int8,
    quant_int8_plain,
    quant_v_int8_per_channel,
)

# One intra-op thread: the suite runs a worker per core, and torch's thread
# pool, spinning under that load, slowed small CPU ops up to 50-fold.
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_port_imports_no_jax():
    code = (
        "import sys\n"
        "import lowbit_quant_fa2_paddle_tpu_torch as p\n"
        "import lowbit_quant_fa2_paddle_tpu_torch.models.dit\n"
        "import lowbit_quant_fa2_paddle_tpu_torch.models.llm\n"
        "import lowbit_quant_fa2_paddle_tpu_torch.models.train\n"
        "import lowbit_quant_fa2_paddle_tpu_torch.ops.attention_bwd\n"
        "import lowbit_quant_fa2_paddle_tpu_torch.ops.fused_kv\n"
        "import lowbit_quant_fa2_paddle_tpu_torch.ops.gemv\n"
        "import lowbit_quant_fa2_paddle_tpu_torch.ops.pack\n"
        "import lowbit_quant_fa2_paddle_tpu_torch.utils.benchmark\n"
        "import lowbit_quant_fa2_paddle_tpu_torch.utils.checkpoint\n"
        "import lowbit_quant_fa2_paddle_tpu_torch.parallel\n"
        "import lowbit_quant_fa2_paddle_tpu_torch.parallel.mesh\n"
        "import lowbit_quant_fa2_paddle_tpu_torch.parallel.transport\n"
        "import lowbit_quant_fa2_paddle_tpu_torch.parallel.ring\n"
        "import lowbit_quant_fa2_paddle_tpu_torch.parallel.ulysses\n"
        "import lowbit_quant_fa2_paddle_tpu_torch.parallel.sharded\n"
        "import lowbit_quant_fa2_paddle_tpu_torch.parallel.serving\n"
        "import lowbit_quant_fa2_paddle_tpu_torch.parallel.pipeline\n"
        "import lowbit_quant_fa2_paddle_tpu_torch.parallel.dryrun\n"
        "import lowbit_quant_fa2_paddle_tpu_torch.utils.parallel_cases\n"
        "import lowbit_quant_fa2_paddle_tpu_torch.utils.tuning\n"
        "import lowbit_quant_fa2_paddle_tpu_torch.utils.profiling\n"
        "import lowbit_quant_fa2_paddle_tpu_torch.utils.logger\n"
        "import lowbit_quant_fa2_paddle_tpu_torch.utils.parser\n"
        "import lowbit_quant_fa2_paddle_tpu_torch.evalkit\n"
        "import lowbit_quant_fa2_paddle_tpu_torch.evalkit.config\n"
        "import lowbit_quant_fa2_paddle_tpu_torch.evalkit.datasets\n"
        "import lowbit_quant_fa2_paddle_tpu_torch.evalkit.grader\n"
        "import lowbit_quant_fa2_paddle_tpu_torch.evalkit.inference\n"
        "import lowbit_quant_fa2_paddle_tpu_torch.evalkit.perceptual\n"
        "import lowbit_quant_fa2_paddle_tpu_torch.tools\n"
        "import lowbit_quant_fa2_paddle_tpu_torch.tools.autotune\n"
        "import lowbit_quant_fa2_paddle_tpu_torch.tools.llm_accuracy_eval\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'lowbit_quant_fa2_paddle_tpu')]\n"
        "assert not bad, bad\n"
    )
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True, timeout=120)


def test_cpu_tensors_launch_no_kernel():
    wrappers = (quant_int8, quant_int4, quant_int2, lowbit_attention, decode_attention, gemv.wq_matmul_per_channel,
                gemv.wq_matmul_fused, fused_packed_kv_attention, attention_bwd_dq, attention_bwd_dkv)
    before = [w.launches for w in wrappers]
    x = torch.randn(1, 2, 70, 64)
    codes, scale = quant_int8(x, gran="per_token")
    lowbit_attention(x, codes, x, None, scale)
    lowbit_attention(x, x, x)
    for quant, bits in ((quant_int4, 4), (quant_int2, 2)):
        packed, ks = quant(x, gran="per_block", block=64)
        lowbit_attention(x, packed, x, None, ks, k_pack_bits=bits)
    vc, vs, _ = quant_v_int8_per_channel(x)
    lowbit_attention(x, codes, vc, None, scale, v_scale=vs, pv_int8=True)
    decode_attention(x[:, :, 0], codes, codes, scale, torch.tensor([70], dtype=torch.int32), v_scale=scale)
    w = torch.randn(96, 128)
    for bits, act in ((8, "bf16"), (8, "int8"), (4, "bf16")):
        gemv.wq_matmul_per_channel(x[0, 0, :3].repeat(1, 2), *gemv.pack_weights_per_channel(w, bits=bits),
                                   bits=bits, activation=act)
    gemv.wq_matmul_fused(x[0, 0, :3].repeat(1, 2), *gemv.pack_weights(w, group_size=32, bits=2), bits=2,
                         group_size=32)
    kp, ks, km = quant_kv_grouped(x, bits=4, group=64)
    fused_packed_kv_attention(x, kp, kp, ks, km, ks, km, bits=4, group=64)
    lse2 = torch.zeros(1, 2, 70)
    for quantized in (False, True):
        flash_bwd(x, x, x, x, lse2, x, is_causal=True, sm_scale=0.125, quantized=quantized)
    assert [w.launches for w in wrappers] == before


def test_build_command_targets_sm90a_from_repo_sources():
    compiles, link = _build.nvcc_commands("out.so")
    for cmd in compiles + [link]:
        assert "arch=compute_90a,code=sm_90a" in cmd
        assert not any("fast_math" in a or "fast-math" in a for a in cmd)
    srcs = [a for cmd in compiles for a in cmd if a.endswith(".cu")]
    assert len(srcs) == len(compiles)  # one nvcc per source, run side by side
    assert sorted(os.path.basename(s) for s in srcs) == [
        "attention_bwd_wgmma.cu", "attention_bwd_wgmma_d256.cu", "attention_fwd_wgmma.cu",
        "attention_fwd_wgmma_bias.cu", "attention_fwd_wgmma_d256.cu", "attention_fwd_wgmma_d512.cu",
        "attention_fwd_wgmma_d512_masked.cu", "attention_fwd_wgmma_pv32.cu", "attention_fwd_wgmma_pv32_d256.cu",
        "decode_attention.cu", "decode_attention_d256.cu", "decode_attention_d80_96.cu", "decode_attention_dyn.cu",
        "decode_attention_dyn512.cu", "decode_attention_multi.cu", "decode_attention_multi_d256.cu",
        "decode_attention_multi_d80_96.cu", "decode_attention_multi_dyn.cu", "decode_attention_multi_dyn512.cu",
        "decode_attention_paged.cu", "decode_attention_paged_d256.cu", "decode_attention_paged_d80_96.cu",
        "decode_attention_paged_dyn.cu", "decode_attention_paged_dyn512.cu", "fused_kv_attention_wgmma.cu",
        "fused_kv_attention_wgmma_d512.cu", "fused_kv_attention_wgmma_pad.cu", "gemv.cu", "quant.cu"]
    assert all(os.path.dirname(s) == _build.CSRC_DIR for s in srcs)
    assert all(f"-I{_build.CSRC_DIR}" in cmd for cmd in compiles)  # the shared headers, e.g. sm90.cuh
    assert os.path.join(_build.CSRC_DIR, "sm90.cuh") in _build.hashed_files()
    assert os.path.join(_build.CSRC_DIR, "decode_attention.cuh") in _build.hashed_files()
    assert os.path.join(_build.CSRC_DIR, "attention_fwd_wgmma.cuh") in _build.hashed_files()
    assert os.path.join(_build.CSRC_DIR, "attention_bwd_wgmma.cuh") in _build.hashed_files()
    assert os.path.join(_build.CSRC_DIR, "fused_kv_attention_wgmma.cuh") in _build.hashed_files()
    assert "-shared" in link and link[-len(compiles):] == [cmd[-1] for cmd in compiles]
    assert _build.CSRC_DIR.startswith(os.path.join(REPO, "lowbit_quant_fa2_paddle_tpu_torch"))
    assert os.path.dirname(_build.library_path()) == _build.BUILD_DIR
    with open(os.path.join(REPO, ".gitignore")) as f:
        assert "lowbit_quant_fa2_paddle_tpu_torch/csrc/build/" in f.read().split()


@pytest.mark.parametrize("edited,rebuilds", [("sm90.cuh", True), ("attention_fwd.cu", True), ("new.h", True),
                                             ("notes.txt", False), ("build/stale.so.log", False)])
def test_library_path_follows_sources_and_headers(tmp_path, monkeypatch, edited, rebuilds):
    """The build cache key covers every source and header under csrc/: an
    edited header gives a new library path (so no stale build is loaded), a
    file the build does not read does not."""
    import shutil

    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC_DIR, csrc, ignore=shutil.ignore_patterns("build"))
    (csrc / "build").mkdir()
    monkeypatch.setattr(_build, "CSRC_DIR", str(csrc))
    monkeypatch.setattr(_build, "BUILD_DIR", str(csrc / "build"))
    before = _build.library_path()
    assert os.path.dirname(before) == str(csrc / "build")
    with open(csrc / edited, "a") as f:
        f.write("\n// edited\n")
    assert (_build.library_path() != before) == rebuilds


CONSTRUCTORS = {
    "llm": lambda gen, **kw: llm.init_llm_params(
        llm.tiny_llm_config(dim=64, depth=1, num_heads=2, num_kv_heads=1, vocab=16), gen, **kw).parameters(),
    "dit": lambda gen, **kw: dit.init_dit_params(
        dit.tiny_config(dim=64, depth=1, num_heads=1, time_embed_dim=16), gen, **kw).parameters(),
    "kv_cache": lambda gen, **kw: init_kv_cache(1, 1, 8, 64, **kw).values(),
}


@pytest.mark.parametrize("name", list(CONSTRUCTORS))
def test_constructors_default_to_the_card(name):
    """Left to their defaults, models and caches land on the CUDA card, and
    without one they raise: nothing falls back to the CPU. Asked for the
    CPU, they build there."""
    for fn in (llm.init_llm_params, llm.params_from_jax, dit.init_dit_params, dit.params_from_jax, init_kv_cache):
        assert inspect.signature(fn).parameters["device"].default == "cuda", fn
    make = CONSTRUCTORS[name]
    assert all(t.device.type == "cpu" for t in make(torch.Generator(), device="cpu"))
    if torch.cuda.is_available():
        assert all(t.device.type == "cuda" for t in make(torch.Generator("cuda")))
    else:
        with pytest.raises((AssertionError, RuntimeError)):
            list(make(torch.Generator()))


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("gran,block,s", [("per_token", 128, 1000), ("per_block", 64, 1000), ("per_block", 128, 512)])
def test_quant_kernel_equals_plain(cuda, gran, block, s):
    g = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn(2, 3, s, 64, generator=g, device=cuda).bfloat16()
    km = torch.randn(2, 3, 1, 64, generator=g, device=cuda)
    codes, scale = quant_int8(x, km, gran=gran, block=block)
    want_c, want_s = quant_int8_plain(x, km, per_token=gran == "per_token", block=block)
    assert torch.equal(codes, want_c) and torch.equal(scale, want_s)


@pytest.mark.gpu
@pytest.mark.parametrize("bits,gran,block,d", [(4, "per_token", 128, 64), (4, "per_block", 64, 128),
                                               (2, "per_token", 128, 128), (2, "per_block", 64, 64)])
def test_lowbit_quant_kernels_equal_plain(cuda, bits, gran, block, d):
    """C2 bit for bit; C3 too, since both sides sum the squares in f64."""
    g = torch.Generator(device=cuda).manual_seed(3)
    x = torch.randn(2, 3, 1000, d, generator=g, device=cuda).bfloat16()
    km = torch.randn(2, 3, 1, d, generator=g, device=cuda)
    quant, plain = (quant_int4, quant_int4_plain) if bits == 4 else (quant_int2, quant_int2_plain)
    n = quant.launches
    codes, scale = quant(x, km, gran=gran, block=block)
    want_c, want_s = plain(x, km, per_token=gran == "per_token", block=block)
    assert quant.launches == n + 1
    assert torch.equal(codes, want_c) and torch.equal(scale, want_s)


QUANT_DTYPES = {"bf16": torch.bfloat16, "f16": torch.float16, "f32": torch.float32}


QUANT_FNS = {8: (quant_int8, quant_int8_plain), 4: (quant_int4, quant_int4_plain), 2: (quant_int2, quant_int2_plain)}


@pytest.mark.gpu
@pytest.mark.parametrize("bits,dtype,d", list(itertools.product([8, 4, 2], list(QUANT_DTYPES), [64, 128, 256])))
def test_quant_vector_design_equals_plain(cuda, bits, dtype, d):
    """C1/C2/C3 against their plain versions, codes and scales bit for bit
    (C3's f64 sums of squares, merged in another order, still give the plain
    version's f32 scales), at
    S 1, 3, 7, 777 and 1000 (ragged against the vector design's 32-256-row
    CTAs and 64/128-row blocks; the edge block's missing rows enter as
    -km), per token and per block 64/128, with and without km. Each call
    counts one launch on the design ``kernel_design`` names: vector for
    every bf16/f16 row and f32 up to d128, except blocks past its registers
    (block 128 at d256), which run scalar."""
    quant, plain = QUANT_FNS[bits]
    g = torch.Generator(device=cuda).manual_seed(100 * bits + d)
    for s in (1, 3, 7, 777, 1000):
        x = (torch.randn(2, 3, s, d, generator=g, device=cuda) * 2 + 0.5).to(QUANT_DTYPES[dtype])
        km = torch.randn(2, 3, 1, d, generator=g, device=cuda)
        if dtype != "f32" or d <= 128:
            assert kernel_design(x, bits, True, 128) == "vector"
        for (gran, block), k in itertools.product([("per_token", 128), ("per_block", 64), ("per_block", 128)],
                                                  (None, km)):
            design = kernel_design(x, bits, gran == "per_token", block)
            before = dict(quant.launches_by_design)
            codes, scale = quant(x, k, gran=gran, block=block)
            want_c, want_s = plain(x, k, per_token=gran == "per_token", block=block)
            torch.cuda.synchronize()
            assert quant.launches_by_design == {**before, design: before[design] + 1}
            case = (s, gran, block, k is not None, design)
            assert torch.equal(codes, want_c), case
            assert torch.equal(scale, want_s), case


@pytest.mark.gpu
@pytest.mark.parametrize("bits", [8, 4, 2])
def test_quant_reads_dit_k_view_where_it_lies(cuda, bits):
    """The DiT's K, a strided view of its qkv projection (30 heads x 64,
    S 4000), goes to the vector design with no copy: bit-equal to the plain
    version per token and per block 64, and the call raises the peak of
    allocated memory by no more than the codes and scales it returns. A
    view whose rows do not start on 16 bytes runs the scalar design (on a
    contiguous copy), bit-equal too."""
    quant, plain = QUANT_FNS[bits]
    g = torch.Generator(device=cuda).manual_seed(20 + bits)
    s, h, d = 4000, 30, 64
    qkv = torch.randn(1, s, 3 * h * d, generator=g, device=cuda).bfloat16().reshape(1, s, 3, h, d)
    k = qkv[:, :, 1].transpose(1, 2)
    km = k_mean(k)
    assert not k.is_contiguous() and kernel_design(k, bits, True, 128) == "vector"
    for gran, block in (("per_token", 128), ("per_block", 64)):
        before = dict(quant.launches_by_design)
        codes, scale = quant(k, km, gran=gran, block=block)
        want_c, want_s = plain(k, km, per_token=gran == "per_token", block=block)
        assert quant.launches_by_design == {**before, "vector": before["vector"] + 1}
        assert torch.equal(codes, want_c) and torch.equal(scale, want_s), gran
    del codes, scale, want_c, want_s
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    codes, scale = quant(k, km, gran="per_token")
    torch.cuda.synchronize()
    rounded = sum(-(-t.numel() * t.element_size() // 512) * 512 for t in (codes, scale))
    assert torch.cuda.max_memory_allocated() - base <= rounded
    x = torch.randn(1, 4, 777, 65, generator=g, device=cuda).bfloat16()[..., 1:]
    assert kernel_design(x, bits, True, 128) == "scalar"
    before = dict(quant.launches_by_design)
    codes, scale = quant(x, x.float().mean(dim=2, keepdim=True), gran="per_token")
    want_c, want_s = plain(x, x.float().mean(dim=2, keepdim=True), per_token=True, block=128)
    assert quant.launches_by_design == {**before, "scalar": before["scalar"] + 1}
    assert torch.equal(codes, want_c) and torch.equal(scale, want_s)


@pytest.mark.gpu
@pytest.mark.parametrize(
    "mode,causal,h,hk,d,s",
    [("fused", False, 4, 4, 64, 1000), ("fused", True, 8, 2, 64, 777), ("int8", False, 4, 2, 128, 300),
     ("fp", True, 4, 4, 64, 1000), ("fp", False, 2, 1, 128, 129)],
)
def test_attention_kernel_matches_plain(cuda, mode, causal, h, hk, d, s):
    g = torch.Generator(device=cuda).manual_seed(1)
    q = torch.randn(1, h, s, d, generator=g, device=cuda).bfloat16()
    k = torch.randn(1, hk, s, d, generator=g, device=cuda).bfloat16()
    v = torch.randn(1, hk, s, d, generator=g, device=cuda).bfloat16()
    vm = torch.randn(1, hk, d, generator=g, device=cuda)
    q_scale = k_scale = None
    if mode != "fp":
        k, k_scale = quant_int8(k, gran="per_token")
    if mode == "int8":
        q, q_scale = quant_int8(q, gran="per_token")
    o, lse = lowbit_attention(q, k, v, q_scale, k_scale, v_mean=vm, is_causal=causal, return_lse=True)
    c = torch.tensor(1.0 / math.sqrt(d) * LOG2E, dtype=torch.float32, device=cuda)
    qs = q_scale * c if q_scale is not None else None
    o_ref, lse_ref = attention_fwd_plain(q, k, v, qs, k_scale, vm, causal=causal,
                                         sm_scale_log2e=float(c), out_dtype=torch.bfloat16)
    torch.cuda.synchronize()
    assert float(cosine_similarity(o, o_ref)) >= 0.9999
    assert float((o.float() - o_ref.float()).abs().max()) <= 2e-2
    assert float((lse - lse_ref).abs().max()) <= 1e-3


@pytest.mark.gpu
@pytest.mark.parametrize(
    "bits,h,hk,d,s,lengths",
    [(8, 32, 8, 128, 4500, [4500, 1, 4097, 0]), (16, 32, 8, 128, 4500, [4500, 1, 4097, 0]),
     (8, 8, 8, 64, 1000, [1000, 77]), (16, 8, 2, 32, 1000, [1000, 0, 513])],
)
def test_decode_kernel_matches_plain(cuda, bits, h, hk, d, s, lengths):
    g = torch.Generator(device=cuda).manual_seed(2)
    b = len(lengths)
    k = torch.randn(b, hk, s, d, generator=g, device=cuda).bfloat16()
    v = torch.randn(b, hk, s, d, generator=g, device=cuda).bfloat16()
    q = torch.randn(b, h, d, generator=g, device=cuda).bfloat16()
    (kq, ks), (vq, vs) = quantize_token(k, bits=bits), quantize_token(v, bits=bits)
    lens = torch.tensor(lengths, dtype=torch.int32, device=cuda)
    n = decode_attention.launches
    o, lse = decode_attention(q, kq, vq, ks, lens, v_scale=vs, kv_bits=bits, return_lse=True)
    o_ref, lse_ref = decode_attention_plain(q, kq, vq, ks, vs if bits == 8 else None, lens,
                                            sm_scale=1.0 / math.sqrt(d), int_qk=bits == 8, out_dtype=q.dtype)
    torch.cuda.synchronize()
    assert decode_attention.launches == n + 1
    ulp = 2.0 ** (math.floor(math.log2(float(o_ref.float().abs().max()))) - 7)  # bf16 ulp of max|o|
    assert float(cosine_similarity(o, o_ref)) >= 0.99999
    assert float((o.float() - o_ref.float()).abs().max()) <= ulp
    assert float((lse - lse_ref).abs().max()) <= 1e-4
    if 0 in lengths:
        i = lengths.index(0)
        assert float(o[i].float().abs().max()) == 0.0 and bool((lse[i] == -1e30).all())


@pytest.mark.gpu
@pytest.mark.parametrize(
    "k_bits,v_mode,causal,h,hk,d,s",
    [(4, "bf16", False, 4, 4, 64, 1000), (2, "bf16", True, 8, 2, 128, 777), (8, "int8", False, 4, 2, 64, 1000),
     (8, "int8_pv", True, 4, 4, 128, 300), (4, "int8_pv", False, 2, 1, 64, 129)],
)
def test_attention_low_bit_modes_match_plain(cuda, k_bits, v_mode, causal, h, hk, d, s):
    g = torch.Generator(device=cuda).manual_seed(4)
    q = torch.randn(1, h, s, d, generator=g, device=cuda).bfloat16()
    k = torch.randn(1, hk, s, d, generator=g, device=cuda).bfloat16()
    v = torch.randn(1, hk, s, d, generator=g, device=cuda).bfloat16()
    quant = {8: quant_int8, 4: quant_int4, 2: quant_int2}[k_bits]
    kc, ks = quant(k, gran="per_token")
    vs = vm = None
    if v_mode != "bf16":
        v, vs, vm = quant_v_int8_per_channel(v, smooth_v=True)
    kw = dict(v_scale=vs, v_mean=vm, pv_int8=v_mode == "int8_pv")
    o, lse = lowbit_attention(q, kc, v, None, ks, k_pack_bits=k_bits, is_causal=causal, return_lse=True, **kw)
    o_ref, lse_ref = attention_fwd_plain(q, kc, v, None, ks, vm, causal=causal, sm_scale_log2e=1.0 / math.sqrt(d) * LOG2E,
                                         out_dtype=torch.bfloat16, k_bits=k_bits, v_scale=vs,
                                         pv_int8=v_mode == "int8_pv")
    torch.cuda.synchronize()
    assert float(cosine_similarity(o, o_ref)) >= 0.9999
    assert float((o.float() - o_ref.float()).abs().max()) <= 2e-2
    assert float((lse - lse_ref).abs().max()) <= 1e-3


@pytest.mark.gpu
@pytest.mark.parametrize(
    "mode,m,n,k,dtype",
    [("w8", 4, 1024, 4096, torch.bfloat16), ("w8a8", 3, 384, 512, torch.bfloat16), ("w4", 4, 4096, 1024, torch.bfloat16),
     ("g2", 5, 512, 1024, torch.bfloat16), ("g4", 64, 256, 1024, torch.float32), ("g8", 7, 384, 512, torch.float32),
     ("w8", 64, 1024, 256, torch.float32), ("w4", 900, 256, 512, torch.bfloat16)],
)
def test_gemv_kernels_match_plain(cuda, mode, m, n, k, dtype):
    """F1 (w8, w8a8) and F2 (w4 per-channel, grouped 2/4/8-bit, group 128)
    against their plain versions: the same products summed in another
    order (bf16: 2 ulps of the larger of max|y| and F2's dot before its
    zero-point term; f32: 1e-5 of it)."""
    g = torch.Generator(device=cuda).manual_seed(5)
    w = torch.randn(n, k, generator=g, device=cuda) / math.sqrt(k)
    x = torch.randn(m, k, generator=g, device=cuda).to(dtype)
    if mode in ("w8", "w8a8", "w4"):
        bits = 4 if mode == "w4" else 8
        p, s = gemv.pack_weights_per_channel(w, bits=bits)
        wrapper = gemv.wq_matmul_fused if bits == 4 else gemv.wq_matmul_per_channel
        launches = wrapper.launches
        y = gemv.wq_matmul_per_channel(x, p, s, bits=bits, activation="int8" if mode == "w8a8" else "bf16")
        if mode == "w8":
            y_ref, dot = gemv.wq_matmul_per_channel_plain(x, p, s, out_dtype=dtype), None
        elif mode == "w8a8":
            xq, xs = gemv.quant_activations(x)
            y_ref, dot = gemv.wq_matmul_per_channel_plain(xq, p, s, x_scale=xs, out_dtype=dtype), None
        else:
            sc = s[:, None].repeat(1, 2)
            y_ref = gemv.wq_matmul_fused_plain(x, p, sc, (-7.0 * s)[:, None].expand(n, 2), bits=4, group_size=k // 2)
            dot = gemv.wq_matmul_fused_plain(x, p, sc, None, bits=4, group_size=k // 2)
    else:
        bits = int(mode[1])
        p, s, mn = gemv.pack_weights(w, group_size=128, bits=bits)
        wrapper = gemv.wq_matmul_fused
        launches = wrapper.launches
        y = gemv.wq_matmul_fused(x, p, s, mn, bits=bits, group_size=128)
        y_ref = gemv.wq_matmul_fused_plain(x, p, s, mn, bits=bits, group_size=128)
        dot = gemv.wq_matmul_fused_plain(x, p, s, None, bits=bits, group_size=128)
    torch.cuda.synchronize()
    assert wrapper.launches == launches + 1 and y.dtype == dtype
    top = max(float(y_ref.float().abs().max()), float(dot.float().abs().max()) if dot is not None else 0.0)
    tol = 2 * 2.0 ** (math.floor(math.log2(top)) - 7) if dtype == torch.bfloat16 else 1e-5 * top
    assert float(cosine_similarity(y, y_ref)) >= 0.99999
    assert float((y.float() - y_ref.float()).abs().max()) <= tol


@pytest.mark.gpu
@pytest.mark.parametrize(
    "bits,causal,b,h,hk,sq,sk,d,group",
    [(4, False, 2, 4, 4, 1000, 1000, 64, 256), (2, True, 1, 8, 2, 700, 1000, 128, 64),
     (4, True, 1, 4, 2, 1000, 300, 64, 128), (2, False, 1, 2, 1, 129, 77, 64, 32)],
)
def test_fused_kv_kernel_matches_plain(cuda, bits, causal, b, h, hk, sq, sk, d, group):
    g = torch.Generator(device=cuda).manual_seed(6)
    q = torch.randn(b, h, sq, d, generator=g, device=cuda).bfloat16()
    k = (torch.randn(b, hk, sk, d, generator=g, device=cuda) + 0.5).bfloat16()
    v = (torch.randn(b, hk, sk, d, generator=g, device=cuda) - 0.3).bfloat16()
    kp, ks, km = quant_kv_grouped(k, bits=bits, group=group)
    vp, vs, vm = quant_kv_grouped(v, bits=bits, group=group)
    n = fused_packed_kv_attention.launches
    o = fused_packed_kv_attention(q, kp, vp, ks, km, vs, vm, bits=bits, is_causal=causal, group=group,
                                  out_dtype=torch.float32)
    o_ref = fused_kv_attention_plain(q, kp, vp, ks, km, vs, vm, bits=bits, group=group, causal=causal,
                                     sm_scale_log2e=LOG2E / math.sqrt(d), out_dtype=torch.float32)
    torch.cuda.synchronize()
    assert fused_packed_kv_attention.launches == n + 1
    assert float(cosine_similarity(o, o_ref)) >= 0.99999
    assert float((o - o_ref).abs().max()) <= 2e-2


@pytest.mark.gpu
@pytest.mark.parametrize(
    "quantized,causal,window,h,hk,d,s,dtype",
    [(False, False, 0, 4, 4, 64, 1000, torch.bfloat16), (False, True, 0, 8, 2, 128, 777, torch.bfloat16),
     (True, False, 0, 4, 2, 64, 300, torch.bfloat16), (True, True, 0, 4, 4, 128, 500, torch.bfloat16),
     (False, True, 256, 4, 4, 64, 700, torch.bfloat16), (False, False, 0, 2, 1, 64, 129, torch.float32),
     (True, True, 0, 4, 2, 32, 200, torch.bfloat16)],
)
def test_attention_bwd_kernels_match_plain(cuda, quantized, causal, window, h, hk, d, s, dtype):
    """G1/G2 against attention_bwd_plain on the same operands: p and ds round
    to bf16 in both, so they differ in summation order only (and a bf16
    rounding of p or ds that this flips): cos >= 0.99999 and max|d| within 2
    bf16 ulps of the gradient's max|.|."""
    g = torch.Generator(device=cuda).manual_seed(7)
    q = torch.randn(1, h, s, d, generator=g, device=cuda).to(dtype)
    k = (torch.randn(1, hk, s, d, generator=g, device=cuda) + 0.3).to(dtype)
    v = torch.randn(1, hk, s, d, generator=g, device=cuda).to(dtype)
    do = torch.randn(1, h, s, d, generator=g, device=cuda).to(dtype)
    from lowbit_quant_fa2_paddle_tpu_torch.ops.reference import attention_reference

    o, lse = attention_reference(q, k, v, is_causal=causal, window_size=window or None, return_lse=True)
    lse2 = lse * LOG2E
    sm = 1.0 / math.sqrt(d)
    n1, n2 = attention_bwd_dq.launches, attention_bwd_dkv.launches
    got = flash_bwd(q, k, v, o, lse2, do, is_causal=causal, sm_scale=sm, quantized=quantized, window=window)
    assert (attention_bwd_dq.launches, attention_bwd_dkv.launches) == (n1 + 1, n2 + 1)
    args, kw = bwd_operands(q, k, v, o, lse2, do, is_causal=causal, sm_scale=sm, quantized=quantized, window=window)
    want = attention_bwd_plain(*args, **kw, dq_dtype=dtype, dkv_dtype=dtype)
    torch.cuda.synchronize()
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert a.shape == b.shape and a.dtype == b.dtype == dtype, name
        top = float(b.float().abs().max())
        assert float(cosine_similarity(a, b)) >= 0.99999, name
        assert float((a.float() - b.float()).abs().max()) <= 2 * 2.0 ** (math.floor(math.log2(top)) - 7), name


WGMMA_BWD_EDGES = {
    # name: (causal, window, h, hk, d, sq, sk, dtype)
    "sq1-sk1": (False, 0, 4, 4, 64, 1, 1, torch.bfloat16),
    "sq127-sk129-gqa": (False, 0, 4, 2, 64, 127, 129, torch.bfloat16),
    "sq129-sk127-causal": (True, 0, 4, 4, 64, 129, 127, torch.bfloat16),
    "sq1-sk777": (False, 0, 4, 4, 64, 1, 777, torch.bfloat16),
    "sq777-sk1-causal": (True, 0, 4, 4, 64, 777, 1, torch.bfloat16),
    "sq129-sk777-d128": (False, 0, 4, 4, 128, 129, 777, torch.bfloat16),
    "causal-gqa-32q8kv-d128-s777": (True, 0, 32, 8, 128, 777, 777, torch.bfloat16),
    "window256-s1000": (True, 256, 4, 4, 64, 1000, 1000, torch.bfloat16),
    "window256-gqa-d128-s777": (True, 256, 4, 2, 128, 777, 777, torch.bfloat16),
    "d32-padded-causal-gqa": (True, 0, 4, 2, 32, 300, 300, torch.bfloat16),
    "f32-in-f32-out": (False, 0, 2, 1, 64, 300, 300, torch.float32),
}


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(WGMMA_BWD_EDGES))
def test_wgmma_attention_bwd_edges_match_plain(cuda, case):
    """G1/G2's wgmma design at its edges: Sq and Sk of 1, 127, 129 and 777
    (lse and di rows that do not start on 16 bytes), Sq != Sk, causal GQA
    32q/8kv d128, a window of 256, d32 padded to 64, f32 inputs and outputs.
    Every launch on the wgmma design; the plain version's bounds (cos >=
    0.99999, max|d| <= 2 bf16 ulps of max|grad|); dq, dk and dv the same
    bits on a second run (no atomics). o is the forward's plus noise, so that
    ds does not vanish where a row sees a single key (the formulas hold for
    any o)."""
    causal, window, h, hk, d, sq, sk, dtype = WGMMA_BWD_EDGES[case]
    from lowbit_quant_fa2_paddle_tpu_torch.ops.reference import attention_reference

    g = torch.Generator(device=cuda).manual_seed(9)
    q = torch.randn(1, h, sq, d, generator=g, device=cuda).to(dtype)
    k = (torch.randn(1, hk, sk, d, generator=g, device=cuda) + 0.3).to(dtype)
    v = torch.randn(1, hk, sk, d, generator=g, device=cuda).to(dtype)
    do = torch.randn(1, h, sq, d, generator=g, device=cuda).to(dtype)
    o, lse = attention_reference(q, k, v, is_causal=causal, window_size=window or None, return_lse=True)
    o = (o.float() + 0.5 * torch.randn(o.shape, generator=g, device=cuda)).to(dtype)
    lse2 = lse * LOG2E
    kw = dict(is_causal=causal, sm_scale=1.0 / math.sqrt(d), window=window)
    n1, n2 = attention_bwd_dq.launches_by_design["wgmma"], attention_bwd_dkv.launches_by_design["wgmma"]
    got = flash_bwd(q, k, v, o, lse2, do, **kw)
    again = flash_bwd(q, k, v, o, lse2, do, **kw)
    assert attention_bwd_dq.launches_by_design["wgmma"] == n1 + 2
    assert attention_bwd_dkv.launches_by_design["wgmma"] == n2 + 2
    args, kargs = bwd_operands(q, k, v, o, lse2, do, **kw)
    want = attention_bwd_plain(*args, **kargs, dq_dtype=dtype, dkv_dtype=dtype)
    torch.cuda.synchronize()
    for name, a, a2, b in zip(("dq", "dk", "dv"), got, again, want):
        assert a.shape == b.shape and a.dtype == b.dtype == dtype, name
        assert torch.equal(a, a2), name
        assert bool(torch.isfinite(a.float()).all()), name
        top = float(b.float().abs().max())
        assert float(cosine_similarity(a, b)) >= 0.99999, name
        assert float((a.float() - b.float()).abs().max()) <= 2 * 2.0 ** (math.floor(math.log2(top)) - 7), name


@pytest.mark.parametrize("case", list(bwd_cases.CASES))
def test_bwd_cases_run_the_plain_version_on_the_cpu(case):
    """Each head_dim-256 card case of ``utils/bwd_cases.py`` built on the
    CPU: the plain version gives finite gradients of the inputs' shapes and
    dtypes, and the same gradients (to 1e-6 in f32) on the operands
    zero-padded to 256 columns and sliced back, as the card pads 129-255."""
    q, k, v, o, lse2, do, opts = bwd_cases.case_inputs(case, torch.Generator().manual_seed(9), "cpu")
    args, kw = bwd_operands(q, k, v, o, lse2, do, **opts)
    want = attention_bwd_plain(*args, **kw, dq_dtype=torch.float32, dkv_dtype=torch.float32)
    for x, ref in zip(want, (q, k, v)):
        assert x.shape == ref.shape and bool(torch.isfinite(x).all())
    got = flash_bwd(q, k, v, o, lse2, do, **opts)
    assert [x.dtype for x in got] == [q.dtype, k.dtype, v.dtype]
    d = q.shape[-1]
    padded = [torch.nn.functional.pad(x, (0, 256 - d)) if i < 4 else x for i, x in enumerate(args)]
    again = attention_bwd_plain(*padded, **kw, dq_dtype=torch.float32, dkv_dtype=torch.float32)
    for a, b in zip(again, want):
        torch.testing.assert_close(a[..., :d], b, rtol=1e-6, atol=1e-6)
        assert not bool(a[..., d:].any())


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(bwd_cases.CASES))
def test_attention_bwd_d256_cases_match_plain(cuda, case):
    """G1/G2's head_dim-256 instances (and d192 padded to them) against the
    plain version at the edges of ``utils/bwd_cases.py`` (ragged Sq/Sk of 1,
    127, 129 and 777, causal GQA, windows, f32, int8 codes): phase 6's
    bounds, the same bits twice, every launch at kernel head dim 256 on the
    wgmma design."""
    r = bwd_cases.check_case(case, torch.Generator(device=cuda).manual_seed(9))
    assert r["ok"], r


WGMMA_EDGES = {
    # name: (mode, causal, h, hk, d, sq, sk, q dtype, out dtype, v_mean)
    "sk1": ("fused", False, 4, 4, 64, 200, 1, torch.bfloat16, None, False),
    "sk127": ("fused", False, 4, 2, 64, 200, 127, torch.bfloat16, None, False),
    "sk128-fp": ("fp", False, 4, 4, 64, 200, 128, torch.bfloat16, None, False),
    "sk129-d128": ("int8", False, 4, 4, 128, 200, 129, torch.bfloat16, None, False),
    "sk300-fp-d128": ("fp", False, 4, 2, 128, 200, 300, torch.bfloat16, None, False),
    "causal-sq300-sk500": ("fused", True, 4, 4, 64, 300, 500, torch.bfloat16, None, False),
    "causal-sq700-sk260-fp": ("fp", True, 4, 2, 64, 700, 260, torch.bfloat16, None, False),
    "causal-gqa-32q8kv-d128": ("fused", True, 32, 8, 128, 777, 777, torch.bfloat16, None, False),
    "f32-q-f32-out": ("fused", False, 4, 4, 64, 300, 300, torch.float32, torch.float32, False),
    "fp-d128-f32-out": ("fp", True, 4, 4, 128, 300, 300, torch.bfloat16, torch.float32, False),
    "v-mean": ("fused", False, 4, 2, 128, 300, 400, torch.bfloat16, None, True),
}


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(WGMMA_EDGES))
def test_wgmma_attention_edges_match_plain(cuda, case):
    """Kernel A's wgmma design at its edges: key counts around the 128-key
    tile, causal with Sq != Sk and Sq not a multiple of the 128-row CTA, GQA
    32q/8kv d128, f32 q quantized in the kernel, f32 output and v_mean,
    against the plain version at the design's tile (the same roundings, other
    summation order); with and without the LSE, the same output."""
    mode, causal, h, hk, d, sq, sk, q_dtype, out_dtype, with_vm = WGMMA_EDGES[case]
    g = torch.Generator(device=cuda).manual_seed(8)
    q = torch.randn(1, h, sq, d, generator=g, device=cuda).to(q_dtype)
    k = (torch.randn(1, hk, sk, d, generator=g, device=cuda) + 0.3).bfloat16()
    v = torch.randn(1, hk, sk, d, generator=g, device=cuda).bfloat16()
    vm = torch.randn(1, hk, d, generator=g, device=cuda) if with_vm else None
    q_scale = k_scale = qs = None
    c = torch.tensor(1.0 / math.sqrt(d) * LOG2E, dtype=torch.float32, device=cuda)
    if mode != "fp":
        k, k_scale = quant_int8(k, gran="per_token")
    if mode == "int8":
        q, q_scale = quant_int8(q, gran="per_token")
        qs = q_scale * c
    n, n_wgmma = lowbit_attention.launches, lowbit_attention.launches_by_design["wgmma"]
    kw = dict(v_mean=vm, is_causal=causal, out_dtype=out_dtype)
    o, lse = lowbit_attention(q, k, v, q_scale, k_scale, **kw, return_lse=True)
    o2 = lowbit_attention(q, k, v, q_scale, k_scale, **kw)
    assert lowbit_attention.launches == n + 2 and lowbit_attention.launches_by_design["wgmma"] == n_wgmma + 2
    o_ref, lse_ref = attention_fwd_plain(q, k, v, qs, k_scale, vm, causal=causal, sm_scale_log2e=float(c),
                                         out_dtype=o.dtype)
    torch.cuda.synchronize()
    assert o.shape == (1, h, sq, d) and torch.equal(o, o2)
    assert bool(torch.isfinite(o.float()).all())
    assert float(cosine_similarity(o, o_ref)) >= 0.99999
    assert float((o.float() - o_ref.float()).abs().max()) <= 2e-2
    assert float((lse - lse_ref).abs().max()) <= 1e-3


DECODE_EDGES = {
    # name: (bits, b, h, hk, d, s, lengths (None: around a split boundary), q dtype)
    "lengths-127-128-129-int8": (8, 4, 32, 8, 128, 2048, [127, 128, 129, 2048], torch.bfloat16),
    "lengths-127-128-129-bf16": (16, 4, 32, 8, 128, 2048, [127, 128, 129, 2048], torch.bfloat16),
    "split-boundary-int8": (8, 4, 32, 8, 128, 4096, None, torch.bfloat16),
    "split-boundary-bf16": (16, 4, 32, 8, 128, 4096, None, torch.bfloat16),
    "gqa-group8-int8": (8, 2, 64, 8, 128, 3000, [3000, 1999], torch.bfloat16),
    "gqa-group8-bf16": (16, 2, 64, 8, 128, 3000, [3000, 1999], torch.bfloat16),
    "f32-q-d32-int8": (8, 3, 8, 2, 32, 777, [777, 1, 500], torch.float32),
    "f32-q-d32-bf16": (16, 3, 8, 2, 32, 777, [777, 1, 0], torch.float32),
    # head_dim 256 (decode_attention_d256.cu): 32-key int8 tiles, 16-key bf16 tiles
    "d256-int8": (8, 4, 16, 8, 256, 2048, [2048, 1, 129, 0], torch.bfloat16),
    "d256-bf16": (16, 4, 16, 8, 256, 2048, [2048, 1, 129, 0], torch.bfloat16),
    "d256-split-boundary-int8": (8, 4, 16, 8, 256, 4096, None, torch.bfloat16),
    "d256-split-boundary-bf16": (16, 4, 16, 8, 256, 4096, None, torch.bfloat16),
    "d256-f32-q-int8": (8, 3, 8, 2, 256, 777, [777, 1, 500], torch.float32),
    "d256-f32-q-bf16": (16, 3, 8, 2, 256, 777, [777, 1, 0], torch.float32),
}


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(DECODE_EDGES))
def test_decode_edges_match_plain(cuda, case):
    """Kernel D's design at its edges: lengths around a 128-key boundary and
    around a split boundary of its plan (lengths chunk - 1, chunk, chunk + 1),
    a GQA group of 8, f32 queries at d32 (split into three bf16 terms, not
    rounded). Every launch on the design; the plain version's bounds (cos
    >= 0.99999, max|do| <= one bf16 ulp of max|o|, max|dlse| <= 1e-4, empty
    rows 0 / -1e30); o and the LSE the same bits on a second run."""
    bits, b, h, hk, d, s, lengths, q_dtype = DECODE_EDGES[case]
    if lengths is None:
        slots = decode_ops._resident_ctas(0, d, bits, bits, bits == 8)
        chunk = decode_ops.num_splits(s, b * hk, slots)[1]
        lengths = [chunk - 1, chunk, chunk + 1, 2 * chunk + 1]
    g = torch.Generator(device=cuda).manual_seed(10)
    k = torch.randn(b, hk, s, d, generator=g, device=cuda).bfloat16()
    v = torch.randn(b, hk, s, d, generator=g, device=cuda).bfloat16()
    q = torch.randn(b, h, d, generator=g, device=cuda).to(q_dtype)
    (kq, ks), (vq, vs) = quantize_token(k, bits=bits), quantize_token(v, bits=bits)
    lens = torch.tensor(lengths, dtype=torch.int32, device=cuda)
    design = decode_ops.kernel_design(bits == 8, bits == 8, bits == 8)
    n = decode_attention.launches_by_design[design]
    o, lse = decode_attention(q, kq, vq, ks, lens, v_scale=vs, kv_bits=bits, return_lse=True)
    o2, lse2 = decode_attention(q, kq, vq, ks, lens, v_scale=vs, kv_bits=bits, return_lse=True)
    o_ref, lse_ref = decode_attention_plain(q, kq, vq, ks, vs if bits == 8 else None, lens,
                                            sm_scale=1.0 / math.sqrt(d), int_qk=bits == 8, out_dtype=q.dtype)
    torch.cuda.synchronize()
    assert decode_attention.launches_by_design[design] == n + 2
    assert torch.equal(o, o2) and torch.equal(lse, lse2)
    ulp = 2.0 ** (math.floor(math.log2(float(o_ref.float().abs().max()))) - 7)
    assert float(cosine_similarity(o, o_ref)) >= 0.99999
    assert float((o.float() - o_ref.float()).abs().max()) <= ulp
    assert float((lse - lse_ref).abs().max()) <= 1e-4
    for i, n_keys in enumerate(lengths):
        if n_keys == 0:
            assert float(o[i].float().abs().max()) == 0.0 and bool((lse[i] == -1e30).all())


# Kernel D's 4-bit modes: (k_bits, v_bits, compute_mode) by name.
DECODE_4BIT_MODES = {"int4": (4, 4, "auto"), "int4-int-qk": (4, 4, "int_qk"), "k4v8": (4, 8, "auto"),
                     "k4v8-int-qk": (4, 8, "int_qk"), "k8v4": (8, 4, "auto"), "k4v16": (4, 16, "auto")}
DECODE_4BIT_SHAPES = {
    # name: (b, h, hk, d, s, lengths (None: around a split boundary), q dtype)
    "d128-gqa-s4500": (4, 32, 8, 128, 4500, [4500, 1, 4097, 0], torch.bfloat16),
    "lengths-127-128-129": (4, 32, 8, 128, 2048, [127, 128, 129, 2048], torch.bfloat16),
    "split-boundary": (4, 32, 8, 128, 4096, None, torch.bfloat16),
    "gqa-group8": (2, 64, 8, 128, 3000, [3000, 1999], torch.bfloat16),
    "d64-mha": (2, 8, 8, 64, 1000, [1000, 77], torch.bfloat16),
    "f32-q-d32": (3, 8, 2, 32, 777, [777, 1, 0], torch.float32),
    "d256-gqa": (4, 16, 8, 256, 3000, [3000, 1, 1025, 0], torch.bfloat16),
    "d256-split-boundary": (4, 16, 8, 256, 4096, None, torch.bfloat16),
    "d256-f32-q": (3, 8, 2, 256, 777, [777, 1, 0], torch.float32),
}


def _decode_4bit_case(cuda, mode, shape):
    k_bits, v_bits, compute_mode = DECODE_4BIT_MODES[mode]
    b, h, hk, d, s, lengths, q_dtype = DECODE_4BIT_SHAPES[shape]
    int_qk = compute_mode == "int_qk" or k_bits == 8
    if lengths is None:
        chunk = decode_ops.num_splits(s, b * hk, decode_ops._resident_ctas(0, d, k_bits, v_bits, int_qk))[1]
        lengths = [chunk - 1, chunk, chunk + 1, 2 * chunk + 1]
    g = torch.Generator(device=cuda).manual_seed(11)
    k = torch.randn(b, hk, s, d, generator=g, device=cuda).bfloat16()
    v = torch.randn(b, hk, s, d, generator=g, device=cuda).bfloat16()
    q = torch.randn(b, h, d, generator=g, device=cuda).to(q_dtype)
    (kq, ks), (vq, vs) = quantize_token(k, bits=k_bits), quantize_token(v, bits=v_bits)
    lens = torch.tensor(lengths, dtype=torch.int32, device=cuda)
    kw = dict(v_scale=vs, k_bits=k_bits, v_bits=v_bits, compute_mode=compute_mode, return_lse=True)
    plain = (q, kq, vq, ks, vs if v_bits != 16 else None, lens)
    return kw, (q, kq, vq, ks, lens), plain, dict(sm_scale=1.0 / math.sqrt(d), int_qk=int_qk, out_dtype=q.dtype), lengths


@pytest.mark.gpu
@pytest.mark.parametrize("shape", list(DECODE_4BIT_SHAPES))
@pytest.mark.parametrize("mode", list(DECODE_4BIT_MODES))
def test_decode_4bit_kernels_match_plain(cuda, mode, shape):
    """Kernel D's packed 4-bit sides (int4, k4v8 and the other mixes; the
    float and the integer QK chain) against the plain version at phase 9's
    edges: cos >= 0.99999, max|do| <= one bf16 ulp of max|o|, max|dlse| <=
    1e-4, empty rows 0 / -1e30, the same bits on a second run, every launch
    on the design."""
    kw, args, plain, plain_kw, lengths = _decode_4bit_case(cuda, mode, shape)
    n = decode_attention.launches_by_design["bulk_ring"]
    o, lse = decode_attention(*args, **kw)
    o2, lse2 = decode_attention(*args, **kw)
    o_ref, lse_ref = decode_attention_plain(*plain, **plain_kw)
    torch.cuda.synchronize()
    assert decode_attention.launches_by_design["bulk_ring"] == n + 2
    assert torch.equal(o, o2) and torch.equal(lse, lse2)
    ulp = 2.0 ** (math.floor(math.log2(float(o_ref.float().abs().max()))) - 7)
    assert float(cosine_similarity(o, o_ref)) >= 0.99999
    assert float((o.float() - o_ref.float()).abs().max()) <= ulp
    assert float((lse - lse_ref).abs().max()) <= 1e-4
    for i, n_keys in enumerate(lengths):
        if n_keys == 0:
            assert float(o[i].float().abs().max()) == 0.0 and bool((lse[i] == -1e30).all())


GRAPH_CACHES = {"int8": dict(kv_bits=8), "bf16": dict(kv_bits=16), "int4": dict(kv_bits=4),
                "k4v8": dict(kv_bits=8, k_bits=4)}


@pytest.mark.gpu
@pytest.mark.parametrize("weights", ["dense", "w4"])
@pytest.mark.parametrize("mode", list(GRAPH_CACHES))
def test_decode_tokens_graph_equals_eager_stepping(cuda, mode, weights):
    """``decode_tokens`` on the card (one captured step, replayed) against a
    loop of ``llm_decode_step`` from cloned caches: the same tokens and
    bit-equal caches; the launch counters count each replay (depth D
    launches a step, 6 F2 launches a layer and step with w4 weights); D's
    and F2's merge tickets are zero after the replays; a second call
    replays the cached graph."""
    cfg = llm.tiny_llm_config(dim=256, depth=2, num_heads=4, num_kv_heads=2, max_seq=128, dtype=torch.bfloat16,
                              **GRAPH_CACHES[mode])
    model = llm.init_llm_params(cfg, torch.Generator(device=cuda).manual_seed(3))
    if weights == "w4":
        model = llm.quantize_llm_params(model, bits=4)
    prompt = torch.randint(0, cfg.vocab, (2, 40), generator=torch.Generator(device=cuda).manual_seed(4), device=cuda)
    logits, caches = llm.llm_prefill(model, prompt, cfg)
    tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
    copy = [{k: v.clone() for k, v in c.items()} for c in caches]
    n_d, n_f2 = decode_attention.launches, gemv.wq_matmul_fused.launches
    got, out_caches = llm.decode_tokens(model, tok, caches, 6, cfg)
    torch.cuda.synchronize()
    f2_per_step = 6 * cfg.depth if weights == "w4" else 0
    assert decode_attention.launches - n_d == 6 * cfg.depth
    assert gemv.wq_matmul_fused.launches - n_f2 == 6 * f2_per_step
    want, t = [], tok
    for _ in range(6):
        step_logits, copy = llm.llm_decode_step(model, t, copy, cfg)
        t = torch.argmax(step_logits, dim=-1).to(torch.int32)
        want.append(t)
    assert torch.equal(got, torch.stack(want, dim=1))
    for c, w in zip(out_caches, copy):
        assert all(torch.equal(c[k], w[k]) for k in c), mode
    assert int(out_caches[0]["length"][0]) == 46
    assert not decode_ops._TICKETS[got.device].any()
    if weights == "w4":
        assert not gemv._TICKETS[got.device].any()
    graph = llm._last_graph
    n_d = decode_attention.launches
    more, _ = llm.decode_tokens(model, got[:, -1], out_caches, 3, cfg)  # replays the graph captured above
    torch.cuda.synchronize()
    assert llm._last_graph is graph and decode_attention.launches - n_d == 3 * cfg.depth
    assert int(out_caches[1]["length"][1]) == 49 and more.shape == (2, 3)


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["int8", "k4v8", "bf16"])
def test_chunked_prefill_on_the_card(cuda, mode):
    """``llm_prefill_chunked`` at head_dim 64 (4-bit K into kernel A's
    packed mode): per layer one C1 and one A a chunk and one more A for
    every chunk after the first; the same caches as the CPU run of the plain
    versions up to the kernels' rounding (K rows cos >= 0.999, 0.99 at 4
    bits; last-token logits >= 0.999, 0.995)."""
    cfg = llm.tiny_llm_config(dim=256, depth=2, num_heads=4, num_kv_heads=2, max_seq=300, dtype=torch.bfloat16,
                              **GRAPH_CACHES[mode])
    model = llm.init_llm_params(cfg, torch.Generator(device="cpu").manual_seed(3), device="cpu")
    prompt = torch.randint(0, cfg.vocab, (2, 280), generator=torch.Generator().manual_seed(4))
    want_logits, want = llm.llm_prefill_chunked(model, prompt, cfg, chunk=128)
    n_a, n_c1 = lowbit_attention.launches, quant_int8.launches
    logits, caches = llm.llm_prefill_chunked(model.to(cuda), prompt.to(cuda), cfg, chunk=128)
    torch.cuda.synchronize()
    assert quant_int8.launches - n_c1 == 3 * cfg.depth and lowbit_attention.launches - n_a == 5 * cfg.depth
    k_min, logits_min = (0.99, 0.995) if cfg.eff_k_bits == 4 else (0.999, 0.999)
    assert float(cosine_similarity(logits.float().cpu(), want_logits.float())) >= logits_min
    for c, w in zip(caches, want):
        assert c["length"].tolist() == [280, 280]
        got_k = llm._dequant_cache_rows(c["k"][:, :, :280].cpu(), c["k_scale"][:, :, :280].cpu(), cfg.eff_k_bits,
                                        torch.float32)
        want_k = llm._dequant_cache_rows(w["k"][:, :, :280], w["k_scale"][:, :, :280], cfg.eff_k_bits, torch.float32)
        assert float(cosine_similarity(got_k, want_k)) >= k_min


FUSED_KV_EDGES = {
    # name: (bits, causal, b, h, hk, sq, sk, d, group, q dtype, out dtype)
    "group32": (4, False, 1, 8, 8, 1000, 1000, 64, 32, torch.bfloat16, torch.bfloat16),
    "group512-gqa": (4, True, 1, 8, 2, 1000, 1000, 64, 512, torch.bfloat16, torch.bfloat16),
    "sk129": (2, False, 1, 8, 8, 300, 129, 64, 64, torch.bfloat16, torch.bfloat16),
    "sk777-group100": (4, False, 1, 8, 4, 300, 777, 64, 100, torch.bfloat16, torch.bfloat16),
    "causal-sq700-sk1000-d128": (2, True, 1, 16, 4, 700, 1000, 128, 128, torch.bfloat16, torch.bfloat16),
    "causal-sq1000-sk300-d128-group32": (4, True, 1, 8, 8, 1000, 300, 128, 32, torch.bfloat16, torch.bfloat16),
    "f32-q-f32-out": (4, False, 1, 4, 4, 300, 300, 64, 256, torch.float32, torch.float32),
    # Head dim 256 (64-key tiles) and the head dims below a kernel's width (the columns past the head dim
    # zeros; 4-bit rows of 24 and 56 bytes and 2-bit rows of 4, 12, 28 and 36 bytes padded to 16 for TMA).
    "d256": (4, True, 1, 8, 2, 700, 1000, 256, 128, torch.bfloat16, torch.bfloat16),
    "d256-int2-sk129": (2, False, 1, 4, 4, 300, 129, 256, 64, torch.bfloat16, torch.float32),
    "d16-int2": (2, False, 1, 4, 2, 300, 300, 16, 64, torch.bfloat16, torch.bfloat16),
    "d48-int4-causal": (4, True, 1, 4, 2, 500, 500, 48, 128, torch.bfloat16, torch.bfloat16),
    "d48-int2-group100": (2, False, 1, 8, 4, 300, 777, 48, 100, torch.bfloat16, torch.bfloat16),
    "d112-int4-causal": (4, True, 1, 8, 2, 700, 1000, 112, 128, torch.bfloat16, torch.bfloat16),
    "d112-int2-f32-q-f32-out": (2, False, 1, 4, 4, 300, 300, 112, 256, torch.float32, torch.float32),
    "d144-int2-causal-sq1000-sk300": (2, True, 1, 8, 8, 1000, 300, 144, 32, torch.bfloat16, torch.bfloat16),
    "d192-int4-gqa12": (4, False, 1, 12, 1, 300, 1000, 192, 256, torch.bfloat16, torch.bfloat16),
    "d192-int2-causal": (2, True, 1, 4, 2, 500, 500, 192, 128, torch.bfloat16, torch.bfloat16),
    "d240-int4-sk777": (4, False, 1, 4, 2, 300, 777, 240, 64, torch.bfloat16, torch.bfloat16),
}


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(FUSED_KV_EDGES))
def test_wgmma_fused_kv_edges_match_plain(cuda, case):
    """Kernel E's wgmma design at its edges: groups smaller and larger than
    its 128-key tile (and 100, which crosses tiles), Sk just past a tile and
    ragged, causal Sq != Sk at d128, f32 q and output, head dim 256 and the
    head dims below a kernel's width (16-240). Every launch on the design
    and at the head dim; the plain version's bounds (cos >= 0.99999, max|do|
    <= 2e-2); the same bits on a second run."""
    bits, causal, b, h, hk, sq, sk, d, group, q_dtype, out_dtype = FUSED_KV_EDGES[case]
    g = torch.Generator(device=cuda).manual_seed(11)
    q = torch.randn(b, h, sq, d, generator=g, device=cuda).to(q_dtype)
    k = (torch.randn(b, hk, sk, d, generator=g, device=cuda) + 0.5).bfloat16()
    v = (torch.randn(b, hk, sk, d, generator=g, device=cuda) - 0.3).bfloat16()
    args = (q, *quant_kv_grouped(k, bits=bits, group=group), *quant_kv_grouped(v, bits=bits, group=group))
    args = (args[0], args[1], args[4], args[2], args[3], args[5], args[6])  # q, kp, vp, ks, km, vs, vm
    design = fused_kv_ops.kernel_design(bits)
    n, n_dim = fused_packed_kv_attention.launches_by_design[design], fused_packed_kv_attention.launches_by_dim[d]
    kw = dict(bits=bits, is_causal=causal, group=group, out_dtype=out_dtype)
    o = fused_packed_kv_attention(*args, **kw)
    o2 = fused_packed_kv_attention(*args, **kw)
    o_ref = fused_kv_attention_plain(*args, bits=bits, group=group, causal=causal,
                                     sm_scale_log2e=LOG2E / math.sqrt(d), out_dtype=out_dtype)
    torch.cuda.synchronize()
    assert fused_packed_kv_attention.launches_by_design[design] == n + 2
    assert fused_packed_kv_attention.launches_by_dim[d] == n_dim + 2
    assert o.shape == (b, h, sq, d) and o.dtype == out_dtype and torch.equal(o, o2)
    assert bool(torch.isfinite(o.float()).all())
    assert float(cosine_similarity(o, o_ref)) >= 0.99999
    assert float((o.float() - o_ref.float()).abs().max()) <= 2e-2


GEMV_TC_CASES = {
    # name: (mode, bits, group, m, n, k); mode "w4" is the 4-bit per-channel format
    "w4-m4-n1024-k4096-split": ("w4", 4, None, 4, 1024, 4096),
    "g4-group128-m4-n1024-k4096-split": ("g", 4, 128, 4, 1024, 4096),
    "g2-group32-m1-n1000-k4096": ("g", 2, 32, 1, 1000, 4096),
    "g8-group512-m8-n4096-k4096": ("g", 8, 512, 8, 4096, 4096),
    "g4-group32-m9-n1000-k1024": ("g", 4, 32, 9, 1000, 1024),
    "g2-group512-m1000-n520-k2048": ("g", 2, 512, 1000, 520, 2048),
    "g8-group32-m4-n256-k16384": ("g", 8, 32, 4, 256, 16384),
    "g4-group512-m4-n1024-k16384": ("g", 4, 512, 4, 1024, 16384),
    "g2-group128-m4-n16384-k4096": ("g", 2, 128, 4, 16384, 4096),
    "w4-m1-n4096-k16384": ("w4", 4, None, 1, 4096, 16384),
    "w4-m1000-n1000-k1024": ("w4", 4, None, 1000, 1000, 1024),
    "g4-group48-m4-n300-k1056-partial-chunk": ("g", 4, 48, 4, 300, 1056),
    "g2-group16-m9-n64-k448-partial-chunk": ("g", 2, 16, 9, 64, 448),
}


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(GEMV_TC_CASES))
def test_gemv_tensor_core_design_matches_plain(cuda, case):
    """F2's tensor-core design (bf16 x) against its plain version: N 1024
    (K split over CTAs, merged by the last warp) and N not a multiple of 16
    or 32, M 1, 4, 8, 9 and 1000, K 16384, groups 16 to 512 at 2, 4 and 8
    bits, packed rows that end inside a 64-byte chunk, and the 4-bit
    per-channel format. The same products summed in another order: max|dy|
    <= 2 bf16 ulps of the larger of max|y| and the dot before the
    zero-point term; the same bits on a second run; every launch on the
    design."""
    mode, bits, group, m, n, k = GEMV_TC_CASES[case]
    g = torch.Generator(device=cuda).manual_seed(12)
    w = torch.randn(n, k, generator=g, device=cuda) / math.sqrt(k)
    x = torch.randn(m, k, generator=g, device=cuda).bfloat16()
    if mode == "w4":
        p, s = gemv.pack_weights_per_channel(w, bits=4)
        sc, mn, gs = s[:, None].repeat(1, 2), (-7.0 * s)[:, None].expand(n, 2), k // 2
        call = lambda: gemv.wq_matmul_per_channel(x, p, s, bits=4)  # noqa: E731
    else:
        p, sc, mn = gemv.pack_weights(w, group_size=group, bits=bits)
        gs = group
        call = lambda: gemv.wq_matmul_fused(x, p, sc, mn, bits=bits, group_size=group)  # noqa: E731
    before = gemv.wq_matmul_fused.launches_by_design["tensor_core"]
    y, y2 = call(), call()
    y_ref = gemv.wq_matmul_fused_plain(x, p, sc, mn, bits=bits, group_size=gs)
    dot = gemv.wq_matmul_fused_plain(x, p, sc, None, bits=bits, group_size=gs)
    torch.cuda.synchronize()
    assert gemv.wq_matmul_fused.launches_by_design["tensor_core"] == before + 2
    assert y.shape == (m, n) and y.dtype == torch.bfloat16 and torch.equal(y, y2)
    top = max(float(y_ref.float().abs().max()), float(dot.float().abs().max()))
    assert bool(torch.isfinite(y.float()).all())
    assert float(cosine_similarity(y, y_ref)) >= 0.99999
    assert float((y.float() - y_ref.float()).abs().max()) <= 2 * 2.0 ** (math.floor(math.log2(top)) - 7)


W8_TC_CASES = {
    # name: (m, n, k)
    "m4-n16384-k4096": (4, 16384, 4096),
    "m4-n4096-k4096": (4, 4096, 4096),
    "m4-n1024-k4096": (4, 1024, 4096),
    "m5-n1000-k1040-direct-ragged": (5, 1000, 1040),
    "m2-n2000-k8208-split-ragged": (2, 2000, 8208),
    "m4-n4096-k16384": (4, 4096, 16384),
    "m3-n3900-k16400-deep-ragged": (3, 3900, 16400),
    "m8-n4000-k16384-deep": (8, 4000, 16384),
    "m8-n2000-k8208-split-ragged": (8, 2000, 8208),
    "m1-n1000-k4160-ragged-tile": (1, 1000, 4160),
    "m7-n300-k528": (7, 300, 528),
    "m8-n64-k16": (8, 64, 16),
    "m9-n130-k512": (9, 130, 512),
    "m64-n1024-k256": (64, 1024, 256),
    "m33-n200-k4176": (33, 200, 4176),
    "m1000-n4096-k4096": (1000, 4096, 4096),
}


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(W8_TC_CASES))
@pytest.mark.parametrize("mode", ["w8", "w8a8", "w8a8-f32-x"])
def test_gemv_w8_tensor_core_design_matches_plain(cuda, mode, case):
    """F1's tensor-core design against its plain version: w8 (bf16 x, exact
    bf16 codes on mma.sync, f32 sums in another order) within 2 bf16 ulps of
    max|y|; w8a8 (INT8 codes of bf16 or f32 x on the s8 mma, an exact s32
    dot and the plain version's epilogue; f32 x gives f32 y) bit for bit.
    The decode shapes (N 1024 and 4096 at K 4096 on the direct loads, N
    16384 on the ring, N 4096 at K 16384 on the deep ring with int8 x (TMA
    boxes, x staged beside W, a CTA an SM over all of K; N 3900 there, K
    ending 16 bytes into a tile; M 8) and with K split over CTAs and merged
    by the last CTA with bf16 x (also N 2000 at K 8208, M 2 and 8), M 1 to 1000 (four m-tiles a unit past 8), N
    not a multiple of the 16- or 32-row tile, K ending inside a tile's first
    segment and inside a later one. The same bits on a second run; every
    launch on the design."""
    m, n, k = W8_TC_CASES[case]
    dtype = torch.float32 if mode == "w8a8-f32-x" else torch.bfloat16
    g = torch.Generator(device=cuda).manual_seed(13)
    w = torch.randn(n, k, generator=g, device=cuda) / math.sqrt(k)
    x = torch.randn(m, k, generator=g, device=cuda).to(dtype)
    p, s = gemv.pack_weights_per_channel(w, bits=8)
    act = "bf16" if mode == "w8" else "int8"
    before = dict(gemv.wq_matmul_per_channel.launches_by_design)
    y = gemv.wq_matmul_per_channel(x, p, s, bits=8, activation=act)
    y2 = gemv.wq_matmul_per_channel(x, p, s, bits=8, activation=act)
    if mode == "w8":
        y_ref = gemv.wq_matmul_per_channel_plain(x, p, s, out_dtype=dtype)
    else:
        xq, xs = gemv.quant_activations(x)
        y_ref = gemv.wq_matmul_per_channel_plain(xq, p, s, x_scale=xs, out_dtype=dtype)
    torch.cuda.synchronize()
    assert gemv.wq_matmul_per_channel.launches_by_design == {**before, "tensor_core": before["tensor_core"] + 2}
    assert y.shape == (m, n) and y.dtype == dtype and torch.equal(y, y2)
    if mode == "w8":
        top = float(y_ref.float().abs().max())
        assert float((y.float() - y_ref.float()).abs().max()) <= 2 * 2.0 ** (math.floor(math.log2(top)) - 7)
    else:
        assert torch.equal(y, y_ref)


PV8_CASES = {
    # name: (q mode, k bits, causal, h, hk, d, sq, sk, smooth-V, out dtype)
    "sk777-ragged-scales": ("fused", 8, False, 4, 4, 64, 300, 777, False, None),
    "causal-sq700-sk1000": ("fused", 8, True, 4, 2, 64, 700, 1000, False, None),
    "causal-sq1000-sk300-d128": ("fused", 8, True, 4, 4, 128, 1000, 300, False, None),
    "causal-gqa-32q8kv-d128-s777": ("fused", 8, True, 32, 8, 128, 777, 777, False, None),
    "gqa-8q2kv-d64-s1000": ("int8", 8, False, 8, 2, 64, 1000, 1000, False, None),
    "v-mean-d64": ("fused", 8, False, 4, 4, 64, 500, 500, True, None),
    "v-mean-d128-f32-out": ("fused", 8, True, 4, 2, 128, 400, 400, True, torch.float32),
    "int4-k-d64": ("fused", 4, False, 4, 2, 64, 300, 777, True, None),
    "int2-k-d128": ("fused", 2, True, 4, 4, 128, 500, 500, False, None),
    "bf16-qk-d64": ("fp", 16, False, 4, 2, 64, 300, 777, True, None),
    "bf16-qk-causal-d128": ("fp", 16, True, 4, 4, 128, 777, 777, False, None),
}


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(PV8_CASES))
def test_wgmma_pv_int8_matches_plain(cuda, case):
    """Kernel A's INT8-PV mode on the wgmma design: Sk 777 (ragged, and K
    scale rows that do not start on 16 bytes), causal with Sq != Sk, GQA,
    d64 and d128, v_mean, packed INT4/INT2 K, bf16 QK, f32 output, against
    the plain version at the design's tile (the same roundings of P and p8,
    another summation order): cos >= 0.99999, max|do| <= 2e-2, max|dlse| <=
    1e-3; the same bits on a second run; every launch on the design."""
    q_mode, k_bits, causal, h, hk, d, sq, sk, smooth_v, out_dtype = PV8_CASES[case]
    g = torch.Generator(device=cuda).manual_seed(13)
    q = torch.randn(1, h, sq, d, generator=g, device=cuda).bfloat16()
    k = (torch.randn(1, hk, sk, d, generator=g, device=cuda) + 0.3).bfloat16()
    v = torch.randn(1, hk, sk, d, generator=g, device=cuda).bfloat16()
    v8, vs, vm = quant_v_int8_per_channel(v, smooth_v=smooth_v)
    c = 1.0 / math.sqrt(d) * LOG2E
    q_scale = k_scale = qs = None
    if q_mode != "fp":
        k, k_scale = {8: quant_int8, 4: quant_int4, 2: quant_int2}[k_bits](k, gran="per_token")
    if q_mode == "int8":
        q, q_scale = quant_int8(q, gran="per_token")
        qs = q_scale * torch.tensor(c, dtype=torch.float32, device=cuda)
    kw = dict(v_scale=vs, v_mean=vm, pv_int8=True, is_causal=causal, out_dtype=out_dtype,
              k_pack_bits=8 if k_bits == 16 else k_bits)
    n = lowbit_attention.launches_by_design["wgmma"]
    o, lse = lowbit_attention(q, k, v8, q_scale, k_scale, **kw, return_lse=True)
    o2, lse2 = lowbit_attention(q, k, v8, q_scale, k_scale, **kw, return_lse=True)
    o_ref, lse_ref = attention_fwd_plain(q, k, v8, qs, k_scale, vm, causal=causal, sm_scale_log2e=c,
                                         out_dtype=o.dtype, k_bits=8 if k_bits == 16 else k_bits, v_scale=vs,
                                         pv_int8=True)
    torch.cuda.synchronize()
    assert lowbit_attention.launches_by_design["wgmma"] == n + 2
    assert o.shape == (1, h, sq, d) and torch.equal(o, o2) and torch.equal(lse, lse2)
    assert bool(torch.isfinite(o.float()).all())
    assert float(cosine_similarity(o, o_ref)) >= 0.99999
    assert float((o.float() - o_ref.float()).abs().max()) <= 2e-2
    assert float((lse - lse_ref).abs().max()) <= 1e-3


@pytest.mark.parametrize("edge", list(mask_cases.EDGES))
def test_mask_cases_give_the_plain_version_one_call(edge):
    """On the CPU, a mask case's options for ``lowbit_attention`` and its
    arguments for ``attention_fwd_plain`` describe the same call, and its
    rows that see no key are those the case expects."""
    case = mask_cases.make_case("fused-d64", edge, torch.Generator().manual_seed(21), "cpu")
    o, lse = lowbit_attention(*case["args"], **case["kw"], return_lse=True)
    o_ref, lse_ref = attention_fwd_plain(*case["plain_args"], **case["plain_kw"])
    assert torch.equal(o, o_ref) and torch.equal(lse, lse_ref)
    r = mask_cases.masked_stats(o, lse, o_ref, lse_ref)
    assert r["empty_ok"] and r["empty_rows"] == case["empty_rows"]


@pytest.mark.gpu
@pytest.mark.parametrize("edge", list(mask_cases.EDGES))
@pytest.mark.parametrize("mode", list(mask_cases.MODES))
def test_attention_masks_match_plain(cuda, mode, edge):
    """Kernel A's masks in every mode, against the plain version (which walks
    the same KV tiles), over the grid of ``utils/mask_cases.py``: a window
    below and not a multiple of the 128-key tile, sinks not a tile multiple
    and past the window's start, a q_position_offset that empties every
    row's band (o = 0, lse = -1e30) and one with Sq != Sk, segment ids
    splitting inside tiles (with a q segment no key shares), segments under
    a causal window, the logit cap; GQA 4q/2kv. Phase 4's bounds, the same
    bits on a second run, every launch on the wgmma design."""
    case = mask_cases.make_case(mode, edge, torch.Generator(device=cuda).manual_seed(21), cuda)
    n = lowbit_attention.launches_by_design["wgmma"]
    o, lse = lowbit_attention(*case["args"], **case["kw"], return_lse=True)
    o2, lse2 = lowbit_attention(*case["args"], **case["kw"], return_lse=True)
    o_ref, lse_ref = attention_fwd_plain(*case["plain_args"], **case["plain_kw"])
    torch.cuda.synchronize()
    assert lowbit_attention.launches_by_design["wgmma"] == n + 2
    assert torch.equal(o, o2) and torch.equal(lse, lse2)
    r = mask_cases.masked_stats(o, lse, o_ref, lse_ref)
    assert r["finite"] and r["empty_ok"], r
    assert r["cos"] >= 0.99999 and r["max_do"] <= 2e-2 and r["max_dlse"] <= 1e-3, r
    assert r["empty_rows"] == case["empty_rows"]


@pytest.mark.parametrize("mode,edge", mask_cases.extra_cases())
def test_extra_cases_give_the_plain_version_one_call(mode, edge):
    """On the CPU, each case of the head_dim-256 grid and of the bias / fp32
    PV grid describes one call: ``lowbit_attention`` with the case's options
    equals ``attention_fwd_plain`` with the case's arguments bit for bit
    (both take the bias in natural-log units)."""
    case = mask_cases.make_case(mode, edge, torch.Generator().manual_seed(22), "cpu")
    o, lse = lowbit_attention(*case["args"], **case["kw"], return_lse=True)
    o_ref, lse_ref = attention_fwd_plain(*case["plain_args"], **case["plain_kw"])
    assert torch.equal(o, o_ref) and torch.equal(lse, lse_ref)
    assert o.dtype == (torch.float32 if case["kw"].get("pv_dtype") == torch.float32 else torch.bfloat16)


@pytest.mark.gpu
@pytest.mark.parametrize("mode,edge", mask_cases.extra_cases())
def test_attention_d256_bias_and_fp32_pv_match_plain(cuda, mode, edge):
    """Kernel A at head_dim 256 in every mode (and 192, padded), unmasked
    and at the masks' edges; the bias (vector and matrix, with causal
    masking, a window and the cap) and fp32 PV at d64/d128/d256: against
    the plain version at phase 4's bounds, fp32 PV's output (f32) within
    ``mask_cases.PV32_MAX_DO``, the same bits on a second run, every launch
    on the wgmma design and on the kernel of its head dim."""
    case = mask_cases.make_case(mode, edge, torch.Generator(device=cuda).manual_seed(22), cuda)
    dp = lowbit_attention_ops.kernel_dim(case["args"][0].shape[-1])
    n, n_dim = lowbit_attention.launches_by_design["wgmma"], lowbit_attention.launches_by_dim[dp]
    o, lse = lowbit_attention(*case["args"], **case["kw"], return_lse=True)
    o2, lse2 = lowbit_attention(*case["args"], **case["kw"], return_lse=True)
    o_ref, lse_ref = attention_fwd_plain(*case["plain_args"], **case["plain_kw"])
    torch.cuda.synchronize()
    assert lowbit_attention.launches_by_design["wgmma"] == n + 2 and lowbit_attention.launches_by_dim[dp] == n_dim + 2
    assert torch.equal(o, o2) and torch.equal(lse, lse2)
    r = mask_cases.masked_stats(o, lse, o_ref, lse_ref)
    assert r["finite"] and r["empty_ok"], r
    max_do = mask_cases.PV32_MAX_DO if case["kw"].get("pv_dtype") == torch.float32 else 2e-2
    assert r["cos"] >= 0.99999 and r["max_do"] <= max_do and r["max_dlse"] <= 1e-3, r


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["int8", "bf16", "k4v8"])
def test_hd256_llm_on_the_card(cuda, mode):
    """A head_dim-256 model (dim 512, 2 query heads, 1 KV head): its prefill
    runs kernel A at d256 (one launch a layer), ``decode_tokens`` gives the
    tokens and bit-equal caches of a loop of ``llm_decode_step`` (kernel D
    at d256), and ``llm_prefill_chunked`` (A's packed INT4 K at d256 for
    k4v8) meets the one-shot prefill's last-token logits at cos >= 0.999
    (0.995 at 4-bit K)."""
    cfg = llm.tiny_llm_config(dim=512, depth=2, num_heads=2, num_kv_heads=1, max_seq=300, dtype=torch.bfloat16,
                              **GRAPH_CACHES[mode])
    assert cfg.head_dim == 256
    model = llm.init_llm_params(cfg, torch.Generator(device=cuda).manual_seed(7))
    prompt = torch.randint(0, cfg.vocab, (2, 280), generator=torch.Generator(device=cuda).manual_seed(8), device=cuda)
    n_a, n_a256 = lowbit_attention.launches, lowbit_attention.launches_by_dim[256]
    logits, caches = llm.llm_prefill(model, prompt[:, :200], cfg)
    assert lowbit_attention.launches - n_a == cfg.depth and lowbit_attention.launches_by_dim[256] - n_a256 == cfg.depth
    tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
    copy = [{k: v.clone() for k, v in c.items()} for c in caches]
    n_d, n_d256 = decode_attention.launches, decode_attention.launches_by_dim[256]
    got, out_caches = llm.decode_tokens(model, tok, caches, 6, cfg)
    torch.cuda.synchronize()
    assert decode_attention.launches - n_d == 6 * cfg.depth == decode_attention.launches_by_dim[256] - n_d256
    want, t = [], tok
    for _ in range(6):
        step_logits, copy = llm.llm_decode_step(model, t, copy, cfg)
        t = torch.argmax(step_logits, dim=-1).to(torch.int32)
        want.append(t)
    assert torch.equal(got, torch.stack(want, dim=1))
    for c, w in zip(out_caches, copy):
        assert all(torch.equal(c[k], w[k]) for k in c), mode
    full, _ = llm.llm_prefill(model, prompt, cfg)
    last, _ = llm.llm_prefill_chunked(model, prompt, cfg, chunk=128)
    bound = 0.995 if cfg.eff_k_bits == 4 else 0.999
    assert float(cosine_similarity(last.float(), full[:, -1].float())) >= bound


# Kernel D's windowed modes: (k_bits, v_bits, compute_mode) by name, and the
# edges (b4 h32 hk8, S, head_dim, lengths, decode_attention's options).
DECODE_WINDOW_MODES = {"int8": (8, 8, "auto"), "bf16": (16, 16, "auto"), "int4": (4, 4, "auto"),
                       "int4-int-qk": (4, 4, "int_qk"), "k4v8": (4, 8, "auto"), "k4v8-int-qk": (4, 8, "int_qk")}
DECODE_WINDOW_EDGES = {
    # lengths: shorter than the window, its start inside a 64-key tile, at a tile edge, none
    "window256": (2048, 128, [100, 1000, 1280, 0], dict(window_size=256)),
    "window256-sink4": (2048, 128, [100, 1000, 1280, 2048], dict(window_size=256, sink_size=4)),
    # sink at and past the window's start (1000 >= 1200 - 300), a length inside the sinks
    "window300-sink1000": (2048, 128, [1200, 700, 2000, 1], dict(window_size=300, sink_size=1000)),
    "cap2": (2048, 128, [2048, 1, 1500, 0], dict(logit_cap=2.0)),
    "window512-sink64-cap3-d64": (4500, 64, [4500, 577, 4097, 64], dict(window_size=512, sink_size=64, logit_cap=3.0)),
    "window100-sink10-d32": (1000, 32, [1000, 50, 333, 99], dict(window_size=100, sink_size=10)),
    "window300-sink8-cap2-d256": (2048, 256, [2048, 100, 1300, 0], dict(window_size=300, sink_size=8, logit_cap=2.0)),
}


@pytest.mark.gpu
@pytest.mark.parametrize("d,mode", [(96, "int8"), (96, "k4v8"), (80, "bf16"), (80, "k4v8")])
def test_off_ladder_llm_on_the_card(cuda, d, mode):
    """A model at head_dim 96 (dim 384) or 80 (dim 320), 4 query and 2 KV
    heads: its prefill runs kernel A padded to 128 (one launch a layer), and
    ``decode_tokens`` gives the tokens and bit-equal caches of a loop of
    ``llm_decode_step``, every kernel D launch at the head dim itself
    (``csrc/decode_attention*_d80_96.cu``)."""
    cfg = llm.tiny_llm_config(dim=4 * d, depth=2, num_heads=4, num_kv_heads=2, max_seq=300, dtype=torch.bfloat16,
                              **GRAPH_CACHES[mode])
    assert cfg.head_dim == d
    model = llm.init_llm_params(cfg, torch.Generator(device=cuda).manual_seed(7))
    prompt = torch.randint(0, cfg.vocab, (2, 200), generator=torch.Generator(device=cuda).manual_seed(8), device=cuda)
    n_a, n_a128 = lowbit_attention.launches, lowbit_attention.launches_by_dim[128]
    logits, caches = llm.llm_prefill(model, prompt, cfg)
    assert lowbit_attention.launches - n_a == cfg.depth == lowbit_attention.launches_by_dim[128] - n_a128
    tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
    copy = [{k: v.clone() for k, v in c.items()} for c in caches]
    n_d, n_dd = decode_attention.launches, decode_attention.launches_by_dim[d]
    got, out_caches = llm.decode_tokens(model, tok, caches, 6, cfg)
    torch.cuda.synchronize()
    assert decode_attention.launches - n_d == 6 * cfg.depth == decode_attention.launches_by_dim[d] - n_dd
    want, t = [], tok
    for _ in range(6):
        step_logits, copy = llm.llm_decode_step(model, t, copy, cfg)
        t = torch.argmax(step_logits, dim=-1).to(torch.int32)
        want.append(t)
    assert torch.equal(got, torch.stack(want, dim=1))
    for c, w in zip(out_caches, copy):
        assert all(torch.equal(c[k], w[k]) for k in c), mode


@pytest.mark.gpu
@pytest.mark.parametrize("d,heads,mode", [(112, (4, 4), "int8"), (112, (4, 4), "int4"), (192, (12, 1), "k4v8"),
                                          (48, (4, 2), "bf16")])
def test_run_time_head_dim_llm_on_the_card(cuda, d, heads, mode):
    """A model at a head dim kernel D takes at run time (112: MPT-30B's; 192
    with 12 query heads a KV head: Nemotron-4's; 48): its prefill runs kernel
    A padded to its kernel dim (one launch a layer), and ``decode_tokens``
    gives the tokens and bit-equal caches of a loop of ``llm_decode_step``,
    every kernel D launch at the head dim itself
    (``csrc/decode_attention*_dyn.cu``)."""
    h, hk = heads
    cfg = llm.tiny_llm_config(dim=h * d, depth=2, num_heads=h, num_kv_heads=hk, max_seq=300, dtype=torch.bfloat16,
                              **GRAPH_CACHES[mode])
    assert cfg.head_dim == d
    model = llm.init_llm_params(cfg, torch.Generator(device=cuda).manual_seed(9))
    prompt = torch.randint(0, cfg.vocab, (2, 200), generator=torch.Generator(device=cuda).manual_seed(10), device=cuda)
    dp = 64 if d <= 64 else 128 if d <= 128 else 256
    n_a, n_adp = lowbit_attention.launches, lowbit_attention.launches_by_dim[dp]
    logits, caches = llm.llm_prefill(model, prompt, cfg)
    assert lowbit_attention.launches - n_a == cfg.depth == lowbit_attention.launches_by_dim[dp] - n_adp
    tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
    copy = [{k: v.clone() for k, v in c.items()} for c in caches]
    n_d, n_dd = decode_attention.launches, decode_attention.launches_by_dim[d]
    got, out_caches = llm.decode_tokens(model, tok, caches, 6, cfg)
    torch.cuda.synchronize()
    assert decode_attention.launches - n_d == 6 * cfg.depth == decode_attention.launches_by_dim[d] - n_dd
    want, t = [], tok
    for _ in range(6):
        step_logits, copy = llm.llm_decode_step(model, t, copy, cfg)
        t = torch.argmax(step_logits, dim=-1).to(torch.int32)
        want.append(t)
    assert torch.equal(got, torch.stack(want, dim=1))
    for c, w in zip(out_caches, copy):
        assert all(torch.equal(c[k], w[k]) for k in c), mode


@pytest.mark.gpu
@pytest.mark.parametrize("edge", list(DECODE_WINDOW_EDGES))
@pytest.mark.parametrize("mode", list(DECODE_WINDOW_MODES))
def test_decode_window_modes_match_plain(cuda, mode, edge):
    """Kernel D's compacted window walk, its sinks and the logit cap, on
    every cache type and both QK chains, against the plain version at
    phase 9's bounds (cos >= 0.99999, max|do| <= one bf16 ulp of max|o|,
    max|dlse| <= 1e-4, empty rows 0 / -1e30); the same bits on a second
    run, every launch on the design."""
    k_bits, v_bits, compute_mode = DECODE_WINDOW_MODES[mode]
    s, d, lengths, kw = DECODE_WINDOW_EDGES[edge]
    b, h, hk = 4, 32, 8
    int_qk = compute_mode == "int_qk" or k_bits == 8
    g = torch.Generator(device=cuda).manual_seed(23)
    k = torch.randn(b, hk, s, d, generator=g, device=cuda).bfloat16()
    v = torch.randn(b, hk, s, d, generator=g, device=cuda).bfloat16()
    q = torch.randn(b, h, d, generator=g, device=cuda).bfloat16()
    (kq, ks), (vq, vs) = quantize_token(k, bits=k_bits), quantize_token(v, bits=v_bits)
    lens = torch.tensor(lengths, dtype=torch.int32, device=cuda)
    n = decode_attention.launches_by_design["bulk_ring"]
    args = dict(v_scale=vs, k_bits=k_bits, v_bits=v_bits, compute_mode=compute_mode, return_lse=True, **kw)
    o, lse = decode_attention(q, kq, vq, ks, lens, **args)
    o2, lse2 = decode_attention(q, kq, vq, ks, lens, **args)
    window = kw.get("window_size", 0)
    o_ref, lse_ref = decode_attention_plain(
        q, kq, vq, ks, vs if v_bits != 16 else None, lens, sm_scale=1.0 / math.sqrt(d), int_qk=int_qk,
        out_dtype=q.dtype, window=window, sink=kw.get("sink_size", 0) if window else 0,
        logit_cap=kw.get("logit_cap", 0.0))
    torch.cuda.synchronize()
    assert decode_attention.launches_by_design["bulk_ring"] == n + 2
    assert torch.equal(o, o2) and torch.equal(lse, lse2)
    ulp = 2.0 ** (math.floor(math.log2(float(o_ref.float().abs().max()))) - 7)
    assert float(cosine_similarity(o, o_ref)) >= 0.99999
    assert float((o.float() - o_ref.float()).abs().max()) <= ulp
    assert float((lse - lse_ref).abs().max()) <= 1e-4
    for i, n_keys in enumerate(lengths):
        if n_keys == 0:
            assert float(o[i].float().abs().max()) == 0.0 and bool((lse[i] == -1e30).all())


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["int8", "bf16", "k4v8"])
def test_windowed_decode_tokens_graph_equals_eager_stepping(cuda, mode):
    """The sliding-window / sink LLM (window 16, sink 4) on the card: its
    prefill runs kernel A's band, and ``decode_tokens`` (one captured step,
    replayed) gives the tokens and the bit-equal caches of a loop of
    ``llm_decode_step`` from cloned caches, with depth D launches a step
    and D's merge tickets back at zero."""
    cfg = llm.tiny_llm_config(dim=256, depth=2, num_heads=4, num_kv_heads=2, max_seq=128, dtype=torch.bfloat16,
                              window_size=16, sink_size=4, **GRAPH_CACHES[mode])
    model = llm.init_llm_params(cfg, torch.Generator(device=cuda).manual_seed(5))
    prompt = torch.randint(0, cfg.vocab, (2, 40), generator=torch.Generator(device=cuda).manual_seed(6), device=cuda)
    n_a = lowbit_attention.launches
    logits, caches = llm.llm_prefill(model, prompt, cfg)
    assert lowbit_attention.launches - n_a == cfg.depth
    tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
    copy = [{k: v.clone() for k, v in c.items()} for c in caches]
    n_d = decode_attention.launches
    got, out_caches = llm.decode_tokens(model, tok, caches, 6, cfg)
    torch.cuda.synchronize()
    assert decode_attention.launches - n_d == 6 * cfg.depth
    want, t = [], tok
    for _ in range(6):
        step_logits, copy = llm.llm_decode_step(model, t, copy, cfg)
        t = torch.argmax(step_logits, dim=-1).to(torch.int32)
        want.append(t)
    assert torch.equal(got, torch.stack(want, dim=1))
    for c, w in zip(out_caches, copy):
        assert all(torch.equal(c[k], w[k]) for k in c), mode
    assert not decode_ops._TICKETS[got.device].any()


# ---------------------------------------------------------------------------
# Kernel D's multi-token (verify) and INT8-PV modes
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", list(decode_cases.CASES))
def test_decode_cases_run_the_plain_version_on_the_cpu(case, monkeypatch):
    """Each card case of ``utils/decode_cases.py`` built on the CPU (the
    occupancy query stubbed at 396 resident CTAs, 3 an SM of an H100's 132):
    the plain version on the kernel's tiles gives finite outputs of q's
    shape, rows that see no key o = 0 and lse = -1e30, and each T-row of a
    call without INT8 PV is the single-token call at its own length: bit for
    bit on the integer QK chain (exact dots); on the float chain, where the
    matmul may sum each row in another order for another row count, the LSE
    within 2e-6 and o within one ulp of its type (bf16 here: 2^-7 of it)."""
    monkeypatch.setattr(decode_ops, "_resident_ctas", lambda *a, **k: 396)
    q, kq, vq, ks, vs, lens, opts, plain = decode_cases.case_inputs(case, torch.Generator().manual_seed(12), "cpu")
    o, lse = decode_attention_plain(q, kq, vq, ks, vs, lens, **plain)
    t = q.shape[1]
    assert o.shape == q.shape and lse.shape == q.shape[:-1] and torch.isfinite(o.float()).all()
    limits = lens.long()[:, None] - (t - 1) + torch.arange(t)
    assert bool((o[limits <= 0].float() == 0).all()) and bool((lse[limits <= 0] == -1e30).all())
    assert bool((lse[limits > 0] > -1e30).all())
    if not plain["int_pv"]:
        for i in range(t):
            single = decode_attention_plain(q[:, i], kq, vq, ks, vs, (limits[:, i]).clamp(min=0).int(), **plain)
            exact = plain["int_qk"]
            ulp = 2.0 ** -7 if q.dtype == torch.bfloat16 else 2e-6
            torch.testing.assert_close(single[0].float(), o[:, i].float(), rtol=0 if exact else ulp,
                                       atol=0 if exact else 2e-6)
            torch.testing.assert_close(single[1], lse[:, i], rtol=0, atol=0 if exact else 2e-6)


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(decode_cases.CASES))
def test_decode_multitoken_and_int8_pv_match_plain(cuda, case):
    """Kernel D's T-token and INT8-PV instances against the plain version on
    the kernel's own tiles at the edges of ``utils/decode_cases.py`` (T rows
    straddling a tile and a split, a window whose band start moves with t,
    lengths below T + window, INT8 PV with all-masked tiles): phase 9's
    bounds, empty rows 0 / -1e30, the same bits twice, every launch on the
    design."""
    r = decode_cases.check_case(case, torch.Generator(device=cuda).manual_seed(12))
    assert r["ok"], r


# ---------------------------------------------------------------------------
# Kernel D over the paged cache
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", list(decode_cases.PAGED_CASES))
def test_paged_cases_run_the_plain_version_on_the_cpu(case, monkeypatch):
    """Each paged card case of ``utils/decode_cases.py`` built on the CPU
    (occupancy stubbed as above): the paged call, which reads only the pages
    its walk visits (every other page NaN), equals the contiguous call on the
    same rows bit for bit, and rows that see no key give o = 0, lse =
    -1e30."""
    monkeypatch.setattr(decode_ops, "_resident_ctas", lambda *a, **k: 396)
    q, pool, table, lens, opts, plain, (kq, vq, ks, vs) = decode_cases.paged_case_inputs(
        case, torch.Generator().manual_seed(12), "cpu")
    o, lse = decode_attention(q, pool["k"], pool["v"], pool["k_scale"], lens, page_table=table, **opts,
                              return_lse=True)
    oc, lc = decode_attention(q, kq, vq, ks, lens, **{**opts, "v_scale": vs if opts["v_bits"] != 16 else None},
                              return_lse=True)
    assert o.shape == q.shape and torch.isfinite(o.float()).all()
    assert torch.equal(o, oc) and torch.equal(lse, lc)
    limits = lens.long()[:, None] - (q.shape[1] - 1) + torch.arange(q.shape[1])
    assert bool((o[limits <= 0].float() == 0).all()) and bool((lse[limits <= 0] == -1e30).all())


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(decode_cases.PAGED_CASES))
def test_decode_paged_cases_match_plain(cuda, case):
    """Kernel D's paged instances against the paged plain version on the
    kernel's tiles (``utils/decode_cases.py``: tiles across pages, pages of
    several tiles, every unvisited page NaN): phase 9's bounds, empty rows,
    the same bits twice, every launch on the design and the paged variant."""
    r = decode_cases.check_paged_case(case, torch.Generator(device=cuda).manual_seed(12))
    assert r["ok"], r
