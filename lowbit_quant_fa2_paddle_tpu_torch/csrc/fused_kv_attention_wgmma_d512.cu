// Kernel E at head dims 272-512 (design note in
// fused_kv_attention_wgmma.cuh): the width-512 kernel, exact at 512 and with
// the head dim at run time (kPad) below it, its O split by columns between
// two consumer warpgroups as kernel A's d512 kernel's. These instances live
// in their own translation unit so that nvcc builds them beside the others.
//
// Replaces the TPU kernel lowbit_quant_fa2_paddle_tpu/ops/fused_kv.py:
// _fused_kv_kernel (pallas_call at :377) at those head dims, which it takes
// whole.

#include "fused_kv_attention_wgmma.cuh"

int fused_kv_d512(const FusedKvArgs& a, const void* k, const void* v, int B, int bits, cudaStream_t stream) {
  const bool four = bits == 4;
  if (a.d == 512) return four ? launch<512, 4, false>(a, k, v, B, stream) : launch<512, 2, false>(a, k, v, B, stream);
  if (a.d > 256 && a.d < 512)
    return four ? launch<512, 4, true>(a, k, v, B, stream) : launch<512, 2, true>(a, k, v, B, stream);
  return (int)cudaErrorInvalidValue;
}
