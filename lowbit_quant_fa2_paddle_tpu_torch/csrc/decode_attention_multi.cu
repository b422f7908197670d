// Kernel D's multi-token instances: T query tokens a sequence (the
// speculative verify step), and INT8 PV (compute_mode "int").
//
// Replaces the TPU kernel lowbit_quant_fa2_paddle_tpu/ops/decode.py:
// _decode_kernel (pallas_call at :727) with q_tokens > 1 (its rows
// t * g + gh, row t masked at pos < length - (T - 1 - t), the window walk
// widened by T - 1) and with int_pv (P requantized to int8 per row and tile,
// an integer product with the V codes). The device code is the single-token
// kernel's (decode_attention.cuh, design note in decode_attention.cu) with
// kExt 1 (T rows a sequence) or 2 (and INT8 PV); these instances live in
// their own translation unit so that nvcc builds them beside the
// single-token ones.
//
// Rows: the wrapper hands the queries over KV head by KV head, token-major
// ([B, Hk * T * g, D]), so a CTA takes up to 8 rows (t, gh) of one KV head
// and the merge writes each row where the single-token kernel would write
// a head. A KV head with more than 8 rows (T * g > 8: the full-width
// model's g = 4 at T = 4 makes 16) is taken by T * g / R CTAs, each of which
// streams the head's cache rows: the cache is read once per row group, not
// once (its second reads may hit L2).
//
// Masks: each row keeps pos < len - (T - 1 - t); the walk covers the union
// of the rows' windows (the kernel gets `window` = W + T - 1, which the
// split plan also uses, so it still reads no length on the host), and in
// its window phase row t keeps pos >= len - (W + T - 1) + t. Only the keys
// within T - 1 of the length or of the band's start differ between rows.
//
// INT8 PV: P (with the V scale folded in after l) lies in the warp's
// scratch as in the f32 path; each lane takes one row and a quarter of the
// tile for the row's maximum (two shuffles), writes its codes p8 =
// trunc(p / pa + 0.5) with pa = fma(max p, 1/127, 1e-7) over P's scratch,
// then multiplies on the CUDA cores: 4 keys at a time, its V columns'
// bytes regrouped by byte permutes into one word of 4 keys a column, one
// dp4a per (row, column) into s32 sums; acc = alpha acc + f32(sum) pa.
// The result depends on the tiles (BK keys, the window phase's tiles from
// the first visible row), which the plain version follows.

#include "decode_attention.cuh"

// lowbit_decode_attn's arguments (decode_attention.cu), with H the query
// rows T * Hk * g (q [B, H, D] KV head by KV head, token-major; o, lse and
// the partials in the same row order), `window` the union band W + T - 1
// (0: none), then q_tokens T >= 1 and int_pv (INT8 PV: v_bits 8, with
// int_qk or a bf16 K). R rows a CTA divide (H / Hk). One launch. Returns
// cudaGetLastError() (cudaErrorInvalidValue for what it does not take).
extern "C" int lowbit_decode_attn_multi(const void* q, const void* k, const void* v, const float* k_scale,
                                        const float* v_scale, const int* lengths, float* part_acc, float* part_ml,
                                        int* tickets, void* o, float* lse, int B, int H, int Hk, int S, int D, int R,
                                        int k_bits, int v_bits, int int_qk, int q_bf16, int out_code, int n_splits,
                                        int chunk, int window, int sink, int q_tokens, int int_pv, float sm_scale,
                                        float logit_cap, void* stream) {
  if (R < 1 || R > RMAX || (H / Hk) % R || q_tokens < 1 || (H / Hk) % q_tokens || chunk % 64 || out_code < 0 ||
      out_code > 2 || n_splits < 1 || window < 0 || sink < 0 || logit_cap < 0.0f || (int_pv && v_bits != 8))
    return (int)cudaErrorInvalidValue;
  const LaunchMulti launch{q,       k_scale,  v_scale, k,        v,      lengths, part_acc, part_ml,
                           tickets, o,        lse,     B,        H,      Hk,      S,        R,
                           n_splits, chunk,   q_bf16,  out_code, window, window > 0 ? sink : 0, q_tokens, int_pv,
                           sm_scale, logit_cap, static_cast<cudaStream_t>(stream)};
  return with_variant(launch, D, k_bits, v_bits, int_qk);
}

// How many CTAs of the multi-token variant (INT8 PV with int_pv) one SM of
// the current device holds at once, into *ctas_per_sm. Host-side only.
extern "C" int lowbit_decode_multi_ctas_per_sm(int D, int k_bits, int v_bits, int int_qk, int int_pv,
                                               int* ctas_per_sm) {
  return with_variant(OccupancyMulti{ctas_per_sm, int_pv}, D, k_bits, v_bits, int_qk);
}
