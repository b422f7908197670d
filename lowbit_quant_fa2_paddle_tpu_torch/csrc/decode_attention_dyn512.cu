// Kernel D at every head dim that is a multiple of 16 from 272 to 512:
// single-token decode attention over a contiguous int8, packed 4-bit or bf16
// cache (each side its own; k4v8, k16v8), on both QK chains, with the window
// / sink walk and the logit cap.
//
// Replaces the TPU kernel lowbit_quant_fa2_paddle_tpu/ops/decode.py:
// _decode_kernel (launched by decode_attention, pallas_call at :727) at head
// dims above 256, which the TPU kernel takes whole as its block's last dim.
// The device code is decode_attention.cuh's kernel (design note in
// decode_attention.cu) with the head dim taken at run time (Cfg::kDyn), as
// decode_attention_dyn.cu's, laid out for 512: 16 PV columns a lane in two
// groups of 8 (columns 8 lane .. and 256 + 8 lane ..; a 4-bit V's nibbles of
// bytes 8 (lane & 15) .. and 128 + 8 (lane & 15) ..), so every multiple of
// 16 fills whole groups and a lane idles in a group past the head dim; the
// 128 f32 of a lane's accumulator (8 rows x 16 columns) leave no room for
// the float chain's query fragments (192 registers at 512: 3 bf16 terms a
// word), which live in shared memory (Cfg::kQSmem); tiles of 16 keys, and
// 4 ring stages where 8 of the widest rows (bf16 K and V, 2 KB a key) would
// pass 128 KB. No fixed-width 512 instance: the run-time instances were
// measured 2-39% slower than fixed ones at the widths that have both
// (PERF.md), and the d512 rows are read against the byte bound.
// decode_attention_multi_dyn512.cu and decode_attention_paged_dyn512.cu
// hold the T-token, INT8-PV and paged twins.

#include "decode_attention.cuh"

// lowbit_decode_attn's arguments (decode_attention.cu) with D any multiple
// of 16 from 272 to 512.
extern "C" int lowbit_decode_attn_dyn512(const void* q, const void* k, const void* v, const float* k_scale,
                                      const float* v_scale, const int* lengths, float* part_acc, float* part_ml,
                                      int* tickets, void* o, float* lse, int B, int H, int Hk, int S, int D, int R,
                                      int k_bits, int v_bits, int int_qk, int q_bf16, int out_code, int n_splits,
                                      int chunk, int window, int sink, float sm_scale, float logit_cap,
                                      void* stream) {
  if (R < 1 || R > RMAX || (H / Hk) % R || chunk % 64 || out_code < 0 || out_code > 2 || n_splits < 1 ||
      window < 0 || sink < 0 || logit_cap < 0.0f)
    return (int)cudaErrorInvalidValue;
  const Launch launch{q,       k_scale, v_scale, k,        v,      lengths, part_acc, part_ml,
                      tickets, o,       lse,     B,        H,      Hk,      S,        R,
                      n_splits, chunk,  q_bf16,  out_code, window, window > 0 ? sink : 0, sm_scale, logit_cap,
                      static_cast<cudaStream_t>(stream), D};
  return with_variant_dyn512(launch, D, k_bits, v_bits, int_qk);
}

// lowbit_decode_ctas_per_sm (decode_attention.cu) at head dims 272-512.
extern "C" int lowbit_decode_ctas_per_sm_dyn512(int D, int k_bits, int v_bits, int int_qk, int masks, int* ctas_per_sm) {
  return with_variant_dyn512(Occupancy{ctas_per_sm, masks != 0}, D, k_bits, v_bits, int_qk);
}
