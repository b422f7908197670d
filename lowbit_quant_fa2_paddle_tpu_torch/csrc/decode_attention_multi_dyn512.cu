// Kernel D's multi-token and INT8-PV instances at head dims 272-512 (every
// multiple of 16): T query tokens a sequence (the speculative verify step)
// over an int8, packed 4-bit or bf16 cache, on both QK chains, with the
// window / sink walk and the cap; and INT8 PV (compute_mode "int") on an
// int8 V, one 8-column group of a lane after the other.
//
// Replaces the TPU kernel lowbit_quant_fa2_paddle_tpu/ops/decode.py:
// _decode_kernel (pallas_call at :727) at those head dims with q_tokens > 1
// or int_pv. The device code is decode_attention.cuh's kernel with kExt 1
// or 2 and Cfg::kDyn laid out for 512 (decode_attention_dyn512.cu). These
// instances live in their own translation unit so that nvcc builds them
// beside the other sources.

#include "decode_attention.cuh"

// lowbit_decode_attn_multi's arguments (decode_attention_multi.cu) at head dims 272-512.
extern "C" int lowbit_decode_attn_multi_dyn512(const void* q, const void* k, const void* v, const float* k_scale,
                                            const float* v_scale, const int* lengths, float* part_acc,
                                            float* part_ml, int* tickets, void* o, float* lse, int B, int H, int Hk,
                                            int S, int D, int R, int k_bits, int v_bits, int int_qk, int q_bf16,
                                            int out_code, int n_splits, int chunk, int window, int sink,
                                            int q_tokens, int int_pv, float sm_scale, float logit_cap,
                                            void* stream) {
  if (R < 1 || R > RMAX || (H / Hk) % R || q_tokens < 1 || (H / Hk) % q_tokens || chunk % 64 || out_code < 0 ||
      out_code > 2 || n_splits < 1 || window < 0 || sink < 0 || logit_cap < 0.0f || (int_pv && v_bits != 8))
    return (int)cudaErrorInvalidValue;
  const LaunchMulti launch{q,       k_scale,  v_scale, k,        v,      lengths, part_acc, part_ml,
                           tickets, o,        lse,     B,        H,      Hk,      S,        R,
                           n_splits, chunk,   q_bf16,  out_code, window, window > 0 ? sink : 0, q_tokens, int_pv,
                           sm_scale, logit_cap, static_cast<cudaStream_t>(stream), D};
  return with_variant_dyn512(launch, D, k_bits, v_bits, int_qk);
}

// lowbit_decode_multi_ctas_per_sm (decode_attention_multi.cu) at head dims 272-512.
extern "C" int lowbit_decode_multi_ctas_per_sm_dyn512(int D, int k_bits, int v_bits, int int_qk, int int_pv,
                                                   int* ctas_per_sm) {
  return with_variant_dyn512(OccupancyMulti{ctas_per_sm, int_pv}, D, k_bits, v_bits, int_qk);
}
