// Kernels G1 and G2 at head_dim 256: the FlashAttention-2 backward's dq and
// dk, dv in both modes (bf16 operands, int8 per-token codes), causal, with
// the causal window, GQA, any Sq and Sk, f32 or bf16 gradients.
//
// Replace the TPU kernels of lowbit_quant_fa2_paddle_tpu/ops/attention_bwd.py
// launched by _flash_bwd, _bwd_dq_kernel (G1, pallas_call at :302) and
// _bwd_dkv_kernel (G2, pallas_call at :346), at head dims 129-256 (the JAX
// backward takes any head dim; the caller pads 129-255 to 256). The device
// code is attention_bwd_wgmma.cuh's at D = 256 (design note in
// attention_bwd_wgmma.cu): G1 with one consumer warpgroup over a 2-stage
// K/V ring, G2 with its two consumer warpgroups making dv and dk over the
// same 64 keys. These instances live in their own translation unit so that
// nvcc builds them beside the d64/d128 ones, which keep their code.

#include "attention_bwd_wgmma.cuh"

// A checked call of lowbit_attn_bwd_wgmma at D 256.
int attn_bwd_d256(const AttnBwdArgs& a, int B, int quantized, int parts, cudaStream_t st) {
  return quantized ? launch<256, true>(a, B, parts, st) : launch<256, false>(a, B, parts, st);
}
