"""lowbit_quant_fa2_paddle_tpu_torch — the low-bit FlashAttention-2 library
in PyTorch, with hand-written CUDA kernels for NVIDIA Hopper (sm_90a).

A port of ``lowbit_quant_fa2_paddle_tpu`` (JAX/Pallas on TPU), which stays
beside it as the reference. This package imports ``torch`` and never
``jax``. Ported so far: the attention forward (kernel A) with INT8, packed
INT4 or packed INT2 K and bf16 or INT8 V and its masks (causal sliding
window with sinks, segment ids, query offset, logit cap), its quantizers
(kernels C1, C2, C3), the fp FA-2 baseline on the same kernel, the
dispatching API with mixed-bit and multi-precision selection and the
ragged-batch ``lowbit_fa_varlen``, the DiT denoiser that runs them, LLM
generation (full causal or sliding-window with sinks) over an int8, 4-bit or
bf16 KV cache with decode attention over one or T query tokens (kernel D;
greedy speculative decoding through a multi-token verify step), weight-quantized models over packed-weight matmuls
(kernels F1/F2, ``ops/gemv.py``, ``ops/pack.py``), attention over
KIVI-grouped packed K/V (kernel E, ``ops/fused_kv.py``), and the FA-2
backward (kernels G1/G2, ``ops/attention_bwd.py``) under the trainable
attention functions exported here, which train the DiT
(``models/dit.sgd_train_step``); the toy LLM's training is not ported.
Those modules stand as in the JAX package. On CPU tensors every kernel runs
its plain PyTorch version; on CUDA tensors it launches the kernel, built
with nvcc at first use.
"""

from lowbit_quant_fa2_paddle_tpu_torch.core import (
    lowbit_fa_attn,
    lowbit_fa_mixed_bits,
    lowbit_fa_multi_precision,
    lowbit_fa_qk_int2_pv_fp16,
    lowbit_fa_qk_int4_pv_fp16,
    lowbit_fa_qk_int4_pv_fp16_triton,
    lowbit_fa_qk_int8_pv_fp8_cuda,
    lowbit_fa_qk_int8_pv_fp16,
    lowbit_fa_qk_int8_pv_fp16_cuda,
    lowbit_fa_qk_int8_pv_fp16_triton,
    lowbit_fa_qk_int8_pv_int8,
    lowbit_fa_varlen,
    manual_scaled_dot_product_attention,
    sageattn,
    sageattn_multi_precision,
    sageattn_qk_int4_pv_fp16_triton,
    sageattn_qk_int8_pv_fp8_cuda,
    sageattn_qk_int8_pv_fp16_cuda,
    sageattn_qk_int8_pv_fp16_triton,
    sageattn_varlen,
)
from lowbit_quant_fa2_paddle_tpu_torch.ops.attention import flash_attention_fp
from lowbit_quant_fa2_paddle_tpu_torch.ops.attention_bwd import flash_attention_trainable, lowbit_attention_trainable

__version__ = "0.1.0"

__all__ = [
    "lowbit_fa_attn",
    "lowbit_fa_qk_int8_pv_fp16",
    "lowbit_fa_qk_int8_pv_int8",
    "lowbit_fa_qk_int4_pv_fp16",
    "lowbit_fa_qk_int2_pv_fp16",
    "lowbit_fa_mixed_bits",
    "lowbit_fa_varlen",
    "lowbit_fa_multi_precision",
    "flash_attention_fp",
    "flash_attention_trainable",
    "lowbit_attention_trainable",
    "lowbit_fa_qk_int8_pv_fp16_triton",
    "lowbit_fa_qk_int8_pv_fp16_cuda",
    "lowbit_fa_qk_int8_pv_fp8_cuda",
    "lowbit_fa_qk_int4_pv_fp16_triton",
    "sageattn",
    "sageattn_qk_int8_pv_fp16_triton",
    "sageattn_qk_int8_pv_fp16_cuda",
    "sageattn_qk_int8_pv_fp8_cuda",
    "sageattn_qk_int4_pv_fp16_triton",
    "sageattn_varlen",
    "sageattn_multi_precision",
    "manual_scaled_dot_product_attention",
]
