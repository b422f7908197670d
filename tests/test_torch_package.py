"""Package checks for the PyTorch/CUDA port, plus its kernel-vs-plain tests.

The CPU checks: importing the port loads no JAX; CPU tensors never touch a
kernel (launch counters stay 0); the kernels build for sm_90a from this
repository's sources only, with exact (not fast) math.

The tests marked ``gpu`` compare each CUDA kernel with its plain PyTorch
version on the card and skip without one. This file imports no JAX, so on a
machine without it they run with
``python -m pytest --noconftest tests/test_torch_package.py -m gpu``.
"""

import math
import os
import subprocess
import sys

import pytest
import torch

from lowbit_quant_fa2_paddle_tpu_torch.ops import _build
from lowbit_quant_fa2_paddle_tpu_torch.ops.attention import LOG2E, attention_fwd_plain, lowbit_attention
from lowbit_quant_fa2_paddle_tpu_torch.ops.decode import decode_attention, decode_attention_plain, quantize_token
from lowbit_quant_fa2_paddle_tpu_torch.ops.metrics import cosine_similarity
from lowbit_quant_fa2_paddle_tpu_torch.ops.quant import (
    quant_int2,
    quant_int2_plain,
    quant_int4,
    quant_int4_plain,
    quant_int8,
    quant_int8_plain,
    quant_v_int8_per_channel,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_port_imports_no_jax():
    code = (
        "import sys\n"
        "import lowbit_quant_fa2_paddle_tpu_torch as p\n"
        "import lowbit_quant_fa2_paddle_tpu_torch.models.dit\n"
        "import lowbit_quant_fa2_paddle_tpu_torch.models.llm\n"
        "import lowbit_quant_fa2_paddle_tpu_torch.models.train\n"
        "import lowbit_quant_fa2_paddle_tpu_torch.utils.benchmark\n"
        "import lowbit_quant_fa2_paddle_tpu_torch.utils.checkpoint\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'lowbit_quant_fa2_paddle_tpu')]\n"
        "assert not bad, bad\n"
    )
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True, timeout=120)


def test_cpu_tensors_launch_no_kernel():
    wrappers = (quant_int8, quant_int4, quant_int2, lowbit_attention, decode_attention)
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
    assert [w.launches for w in wrappers] == before


def test_build_command_targets_sm90a_from_repo_sources():
    compiles, link = _build.nvcc_commands("out.so")
    for cmd in compiles + [link]:
        assert "arch=compute_90a,code=sm_90a" in cmd
        assert not any("fast_math" in a or "fast-math" in a for a in cmd)
    srcs = [a for cmd in compiles for a in cmd if a.endswith(".cu")]
    assert len(srcs) == len(compiles)  # one nvcc per source, run side by side
    assert sorted(os.path.basename(s) for s in srcs) == ["attention_fwd.cu", "decode_attention.cu", "quant.cu"]
    assert all(os.path.dirname(s) == _build.CSRC_DIR for s in srcs)
    assert "-shared" in link and link[-3:] == [cmd[-1] for cmd in compiles]
    assert _build.CSRC_DIR.startswith(os.path.join(REPO, "lowbit_quant_fa2_paddle_tpu_torch"))
    assert os.path.dirname(_build.library_path()) == _build.BUILD_DIR
    with open(os.path.join(REPO, ".gitignore")) as f:
        assert "lowbit_quant_fa2_paddle_tpu_torch/csrc/build/" in f.read().split()


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
