// Kernel E: attention over K and V kept as packed 4- or 2-bit codes with
// KIVI-grouped scales and zero-points (design note in
// fused_kv_attention_wgmma.cuh). This source holds the C entry and the
// kernels at head dims 64 and 128; fused_kv_attention_wgmma_pad.cu those at
// 256 and at every other head dim that is a multiple of 16 up to 256.
//
// Replaces the TPU kernel lowbit_quant_fa2_paddle_tpu/ops/fused_kv.py:
// _fused_kv_kernel (launched by fused_packed_kv_attention, pallas_call at
// :377).

#include "fused_kv_attention_wgmma.cuh"

// All tensors contiguous, natural layout, 16-byte aligned.
//   q: [B, H, Sq, D] f32 (q_f32 1) or bf16.   o: [B, H, Sq, D] f32 (out_f32 1) or bf16.
//   k, v: [B, Hk, Sk, pack_row] packed unsigned codes (bits 4 or 2) in the
//   first D*bits/8 bytes of each row; pack_row is D*bits/8 rounded up to a
//   multiple of 16.
//   k_scale, k_mn, v_scale, v_mn: [B, Hk, n_groups, D] f32, n_groups * group >= Sk.
// D: a multiple of 16 from 16 to 256. Returns cudaGetLastError()
// (cudaErrorInvalidValue for an unsupported D, bits or pack_row, or a
// tensor map the driver refuses).
extern "C" int lowbit_fused_kv_attn_wgmma(const void* q, const void* k, const void* v, const float* k_scale,
                                          const float* k_mn, const float* v_scale, const float* v_mn, void* o, int B,
                                          int H, int Hk, int Sq, int Sk, int D, int bits, int group, int n_groups,
                                          int causal, int q_f32, int out_f32, int pack_row, float sm_scale_log2e,
                                          void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B < 1 || H < 1 || Hk < 1 || H % Hk || Sq < 1 || Sk < 1 || group < 1 || (long long)n_groups * group < Sk ||
      B > 65535 || H > 65535 || (long long)B * Hk * n_groups * D >= (1LL << 31) || D < 16 || D > 256 || D % 16 ||
      (bits != 4 && bits != 2) || pack_row != (D * bits / 8 + 15) / 16 * 16)
    return (int)cudaErrorInvalidValue;
  const Args a{q, k_scale, k_mn, v_scale, v_mn, o, H, Hk, Sq, Sk, group, n_groups, causal, q_f32, out_f32, D,
               pack_row, sm_scale_log2e};
  if (D == 64 && bits == 4) return launch<64, 4, false>(a, k, v, B, st);
  if (D == 64 && bits == 2) return launch<64, 2, false>(a, k, v, B, st);
  if (D == 128 && bits == 4) return launch<128, 4, false>(a, k, v, B, st);
  if (D == 128 && bits == 2) return launch<128, 2, false>(a, k, v, B, st);
  return fused_kv_pad(a, k, v, B, bits, st);
}
