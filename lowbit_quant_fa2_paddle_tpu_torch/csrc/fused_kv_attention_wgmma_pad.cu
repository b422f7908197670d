// Kernel E at head dim 256 and at every head dim that is a multiple of 16 up
// to 256 other than 64 and 128 (design note in fused_kv_attention_wgmma.cuh):
// the kernels of width 64, 128 and 256 with the head dim at run time (kPad),
// and the exact d256 kernels (64-key tiles, O as two 128-column halves).
// These instances live in their own translation unit so that nvcc builds
// them beside fused_kv_attention_wgmma.cu, whose C entry calls fused_kv_pad.
//
// Replaces the TPU kernel lowbit_quant_fa2_paddle_tpu/ops/fused_kv.py:
// _fused_kv_kernel (pallas_call at :377) at those head dims, e.g. 112
// (MPT-30B) and 192 (Nemotron-4-340B), which it takes whole.

#include "fused_kv_attention_wgmma.cuh"

int fused_kv_pad(const FusedKvArgs& a, const void* k, const void* v, int B, int bits, cudaStream_t stream) {
  const bool four = bits == 4;
  if (a.d == 256) return four ? launch<256, 4, false>(a, k, v, B, stream) : launch<256, 2, false>(a, k, v, B, stream);
  if (a.d < 64) return four ? launch<64, 4, true>(a, k, v, B, stream) : launch<64, 2, true>(a, k, v, B, stream);
  if (a.d < 128) return four ? launch<128, 4, true>(a, k, v, B, stream) : launch<128, 2, true>(a, k, v, B, stream);
  if (a.d < 256) return four ? launch<256, 4, true>(a, k, v, B, stream) : launch<256, 2, true>(a, k, v, B, stream);
  return (int)cudaErrorInvalidValue;
}
