// Kernel D at head_dim 256: single-token decode attention over a contiguous
// int8, packed 4-bit or bf16 cache (each side its own; k4v8), on both QK
// chains, with the window / sink walk and the logit cap.
//
// Replaces the TPU kernel lowbit_quant_fa2_paddle_tpu/ops/decode.py:
// _decode_kernel (launched by decode_attention, pallas_call at :727) at
// head_dim 256 with one query token a sequence. The device code is
// decode_attention.cuh's kernel (design note in decode_attention.cu) at
// D = 256: a tile holds 32 keys of int8 K and V (16 of bf16, 64 of int4, 32
// of k4v8) within its 16 KB, each lane owns 8 output columns of every row
// (CPL), the QK windows walk 4 (integer chain) or 8 (float chain) 64- or
// 32-byte steps of a K row. These instances live in their own translation
// unit so that nvcc builds them beside the d32/64/128 ones (decode_attention.cu),
// which keep their code; the multi-token and INT8-PV instances at 256 are
// decode_attention_multi_d256.cu's.

#include "decode_attention.cuh"

// lowbit_decode_attn's arguments (decode_attention.cu) with D = 256.
extern "C" int lowbit_decode_attn_d256(const void* q, const void* k, const void* v, const float* k_scale,
                                       const float* v_scale, const int* lengths, float* part_acc, float* part_ml,
                                       int* tickets, void* o, float* lse, int B, int H, int Hk, int S, int D, int R,
                                       int k_bits, int v_bits, int int_qk, int q_bf16, int out_code, int n_splits,
                                       int chunk, int window, int sink, float sm_scale, float logit_cap,
                                       void* stream) {
  if (D != 256 || R < 1 || R > RMAX || (H / Hk) % R || chunk % 64 || out_code < 0 || out_code > 2 ||
      n_splits < 1 || window < 0 || sink < 0 || logit_cap < 0.0f)
    return (int)cudaErrorInvalidValue;
  const Launch launch{q,       k_scale, v_scale, k,        v,      lengths, part_acc, part_ml,
                      tickets, o,       lse,     B,        H,      Hk,      S,        R,
                      n_splits, chunk,  q_bf16,  out_code, window, window > 0 ? sink : 0, sm_scale, logit_cap,
                      static_cast<cudaStream_t>(stream)};
  return with_k<256>(launch, k_bits, v_bits, int_qk);
}

// lowbit_decode_ctas_per_sm (decode_attention.cu) at D = 256.
extern "C" int lowbit_decode_ctas_per_sm_d256(int D, int k_bits, int v_bits, int int_qk, int masks,
                                              int* ctas_per_sm) {
  if (D != 256) return (int)cudaErrorInvalidValue;
  return with_k<256>(Occupancy{ctas_per_sm, masks != 0}, k_bits, v_bits, int_qk);
}
