// Kernel D at head dims 80 and 96: single-token decode attention over a
// contiguous int8, packed 4-bit or bf16 cache (each side its own; k4v8,
// k16v8), on both QK chains, with the window / sink walk and the logit cap.
//
// Replaces the TPU kernel lowbit_quant_fa2_paddle_tpu/ops/decode.py:
// _decode_kernel (launched by decode_attention, pallas_call at :727) at the
// head dims of Phi-3-mini (96: 3072 / 32 heads) and Phi-2 (80), which the
// TPU kernel takes whole as its block's last dim (:381). The device code is
// decode_attention.cuh's kernel (design note in decode_attention.cu) at D =
// 80 or 96 (Cfg::kOffLadder): the shared rows carry the cache's own width
// (96 or 80 bytes of int8, 48 or 40 of 4-bit codes, 192 or 160 of bf16); QK
// walks 3 windows of 32 (int8) or 16 (4-bit) bytes a row, a bf16 row 3
// windows of 64 bytes at d96 and 5 of 32 at d80; at d80 an int8 or 4-bit
// row ends inside its third window, whose words past the end read the next
// row's bytes against zero query words (exact: integer or exact-bf16
// products with 0). In PV each lane owns 4 columns, so 24 lanes work at d96
// and 20 at d80 (a 4-bit V: 12 / 10 of each half), the rest idle. A 4-bit
// row at d80 is 40 bytes, not a 16-byte multiple, so the producer copies
// that side in 8-byte cp.async pieces from every lane (a window's first row
// may sit at any key), the other side by bulk copies. The ladder's kernels
// (d32-d256) compile from the same source as before: every difference is a
// Cfg constant they keep or an `if constexpr (kOffLadder ...)` branch.
// These instances live in their own translation unit so that nvcc builds
// them beside the others; decode_attention_multi_d80_96.cu and
// decode_attention_paged_d80_96.cu hold their T-token, INT8-PV and paged
// twins.

#include "decode_attention.cuh"

// lowbit_decode_attn's arguments (decode_attention.cu) with D = 80 or 96.
extern "C" int lowbit_decode_attn_d80_96(const void* q, const void* k, const void* v, const float* k_scale,
                                         const float* v_scale, const int* lengths, float* part_acc, float* part_ml,
                                         int* tickets, void* o, float* lse, int B, int H, int Hk, int S, int D, int R,
                                         int k_bits, int v_bits, int int_qk, int q_bf16, int out_code, int n_splits,
                                         int chunk, int window, int sink, float sm_scale, float logit_cap,
                                         void* stream) {
  if ((D != 80 && D != 96) || R < 1 || R > RMAX || (H / Hk) % R || chunk % 64 || out_code < 0 || out_code > 2 ||
      n_splits < 1 || window < 0 || sink < 0 || logit_cap < 0.0f)
    return (int)cudaErrorInvalidValue;
  const Launch launch{q,       k_scale, v_scale, k,        v,      lengths, part_acc, part_ml,
                      tickets, o,       lse,     B,        H,      Hk,      S,        R,
                      n_splits, chunk,  q_bf16,  out_code, window, window > 0 ? sink : 0, sm_scale, logit_cap,
                      static_cast<cudaStream_t>(stream)};
  return with_variant_d80_96(launch, D, k_bits, v_bits, int_qk);
}

// lowbit_decode_ctas_per_sm (decode_attention.cu) at D = 80 or 96.
extern "C" int lowbit_decode_ctas_per_sm_d80_96(int D, int k_bits, int v_bits, int int_qk, int masks,
                                                int* ctas_per_sm) {
  return with_variant_d80_96(Occupancy{ctas_per_sm, masks != 0}, D, k_bits, v_bits, int_qk);
}
