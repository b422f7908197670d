// Kernel D at every head dim that is a multiple of 16 from 16 to 256 and has
// no instance of its own (16, 48, 112, 144, ..., 240): single-token decode
// attention over a contiguous int8, packed 4-bit or bf16 cache (each side
// its own; k4v8, k16v8), on both QK chains, with the window / sink walk and
// the logit cap.
//
// Replaces the TPU kernel lowbit_quant_fa2_paddle_tpu/ops/decode.py:
// _decode_kernel (launched by decode_attention, pallas_call at :727) at the
// head dims of models such as MPT-30B (112: 7168 / 64 heads) and
// Nemotron-4-340B (192: 18432 / 96), which the TPU kernel takes whole as its
// block's last dim. The device code is decode_attention.cuh's kernel (design
// note in decode_attention.cu) with the head dim taken at run time
// (Cfg::kDyn): two instances a mode, laid out for 128 (head dims 16-128, 4
// PV columns a lane) and for 256 (144-256, 8 a lane), rather than one a head
// dim: ten head dims at three sources each (as 80 and 96 took) would
// multiply the build. A call's rows lie at the cache's own width (d bytes of
// int8, d/2 of 4-bit codes, 2d of bf16) in stages laid out for the widest;
// QK walks the row's own windows of 32 bytes (16 of 4-bit K), a last half
// window (an int8 or 4-bit row at d % 32 == 16) reading the next row's
// integer codes against zero query words; the lanes whose PV columns lie
// past d idle; 4-bit rows that are not 16-byte multiples come by 8-byte
// cp.async pieces. decode_attention_multi_dyn.cu and
// decode_attention_paged_dyn.cu hold the T-token, INT8-PV and paged twins.

#include "decode_attention.cuh"

// lowbit_decode_attn's arguments (decode_attention.cu) with D any multiple
// of 16 from 16 to 256.
extern "C" int lowbit_decode_attn_dyn(const void* q, const void* k, const void* v, const float* k_scale,
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
  return with_variant_dyn(launch, D, k_bits, v_bits, int_qk);
}

// lowbit_decode_ctas_per_sm (decode_attention.cu) at the run-time head dims.
extern "C" int lowbit_decode_ctas_per_sm_dyn(int D, int k_bits, int v_bits, int int_qk, int masks, int* ctas_per_sm) {
  return with_variant_dyn(Occupancy{ctas_per_sm, masks != 0}, D, k_bits, v_bits, int_qk);
}
