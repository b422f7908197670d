// Kernel D over the paged KV cache at the head dims taken at run time (every
// multiple of 16 from 16 to 256 without an instance of its own): the paged
// instances of decode_attention_paged.cu (design note there) with
// Cfg::kDyn, as decode_attention_dyn.cu instantiates the contiguous ones. A
// 4-bit side whose rows are not 16-byte multiples (d % 32 == 16) comes in
// 8-byte cp.async pieces, a key's row looked up in the table by one lane and
// shuffled to the lanes that copy its pieces; every other side by one bulk
// copy a page run.
//
// Replaces the TPU kernel lowbit_quant_fa2_paddle_tpu/ops/decode.py:
// _decode_kernel (pallas_call at :727) with a page_table at those head dims.
// These instances live in their own translation unit so that nvcc builds
// them beside the other sources.

#include "decode_attention.cuh"

// lowbit_decode_attn_paged's arguments (decode_attention_paged.cu) at the run-time head dims.
extern "C" int lowbit_decode_attn_paged_dyn(const void* q, const void* k, const void* v, const float* k_scale,
                                            const float* v_scale, const int* lengths, float* part_acc,
                                            float* part_ml, int* tickets, void* o, float* lse, int B, int H, int Hk,
                                            int S, int D, int R, int k_bits, int v_bits, int int_qk, int q_bf16,
                                            int out_code, int n_splits, int chunk, int window, int sink,
                                            int q_tokens, int int_pv, const int* table, int n_pages, int page,
                                            int width, float sm_scale, float logit_cap, void* stream) {
  LaunchPaged launch;
  const int err = paged_launch(&launch, q, k, v, k_scale, v_scale, lengths, table, part_acc, part_ml, tickets, o, lse,
                               B, H, Hk, S, R, q_bf16, out_code, n_splits, chunk, window, sink, q_tokens, int_pv,
                               n_pages, page, width, v_bits, sm_scale, logit_cap, stream);
  launch.head_dim = D;
  return err ? err : with_variant_dyn(launch, D, k_bits, v_bits, int_qk);
}

// lowbit_decode_paged_ctas_per_sm (decode_attention_paged.cu) at the run-time head dims.
extern "C" int lowbit_decode_paged_ctas_per_sm_dyn(int D, int k_bits, int v_bits, int int_qk, int int_pv,
                                                   int* ctas_per_sm) {
  return with_variant_dyn(OccupancyPaged{ctas_per_sm, int_pv}, D, k_bits, v_bits, int_qk);
}
