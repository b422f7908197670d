// Kernel D: single-token decode attention over a contiguous quantized or bf16 KV cache.
//
// The device code lives in decode_attention.cuh; this file instantiates and
// launches its single-token kernels, decode_attention_multi.cu its
// multi-token (T query tokens) and INT8-PV ones.
//
// Replaces the TPU kernel lowbit_quant_fa2_paddle_tpu/ops/decode.py:
// _decode_kernel (launched by decode_attention, pallas_call at :727) for one
// query token per sequence over a contiguous cache: int8 codes or packed
// 4-bit codes with per-token f32 scales, or bf16 rows, chosen per side (the
// TPU kernel's kv_bits 8 / 4 / 16 and k4v8); GQA; lengths read on the
// device; base-2 LSE out. A 4-bit row holds two codes a byte in halves of D:
// byte i carries column i in its low nibble and column i + D/2 in its high
// one (ops/decode.py quantize_token, JAX's _unpack4_cols).
//
// Math per key, as in the TPU kernel:
//   integer chain (int8 K by default, 4-bit K with compute_mode "int_qk"):
//            qa = fma(max|q|, 1/127, 1e-7), q8 = round_away(q / qa)
//            s  = ((f32(q8 . k8) * (qa * sm_scale)) * ks) * log2e
//   float:   s  = (((q . k) * sm_scale) * ks) * log2e          (f32 sums)
//   with a logit cap c: s = c tanh(s / c) in natural units, before log2e;
//   s = -0.7 * FLT_MAX where pos >= length;  online softmax in base 2 with
//   f32 P (P is NOT rounded to bf16); l sums P; an int8 V's scale is folded
//   into P after that; acc += P V in f32; o = acc / l, lse = m + log2 l.
//   A sliding window keeps pos >= length - window, and its sinks pos < sink
//   (the TPU kernel's window/sink compacted walk).
//
// Bound on the H100: memory. Decode streams the whole cache once per token
// (at b4 hk8 s32768 d128: 268 MB of int8 K/V, 537 MB of bf16) for ~2
// operations per byte. The KV axis is split so that every SM gets work: one
// CTA per (batch, KV head, query rows, split), and the last CTA of a (batch,
// KV head, rows) to finish, found by an atomic ticket, merges the splits in
// a fixed order (the same bits whichever CTA finished last) and writes o and
// the LSE. One launch per call. The split count comes from the cache size
// (with a window: from the window, sink tiles + ceil(window / 64) + 1 tiles
// of 64 keys, whatever the cache size) and the kernel's occupancy on the
// host, never from the lengths (reading them there would sync the decode
// loop); each split maps its logical keys onto the rows of the sink and the
// window phase on the device, from the length. The window and the cap are a
// template parameter (kMasks): calls without them run kernels that carry
// none of their code (with it in every kernel, the integer chain at 4-bit K
// ran 7-8% slower on an H100). Rows at or past a sequence's
// length are never loaded: after a rollback they may hold stale data. A
// split wholly past the length gives m = -1e30, l = 0 and no weight.
//
// Design (160 threads): one producer warp keeps NST stages of BK keys in
// flight: lane 0 copies the tile's K and V rows (contiguous in the cache) with
// one cp.async.bulk each, completion counted in bytes on the stage's
// mbarrier; the per-token f32 scales, whose rows need not start on 16 bytes,
// come by 4-byte cp.async from every lane, which arrive on the same barrier
// when they land. Four consumer warps each own whole tiles (tile j goes to
// warp j % 4) and keep their own online-softmax state for the CTA's R <= 8
// query rows, so nothing in the loop waits on the other warps. QK runs on the
// tensor cores with the K tile as the A operand (16 keys) and the query rows
// as B (n = 8): mma.sync m16n8k32 s8 on the integer chain (exact integer
// dots, as __dp4a), m16n8k16 bf16 otherwise (bf16 queries: exact products,
// f32 sums in another order; f32 queries are split into three bf16 terms hi
// + mid + lo, which carry all 24 bits, so nothing is rounded to bf16). Each
// thread reads 4 to 16 contiguous bytes of a K row, so the dimension order inside
// an mma is permuted, the same for K and the queries. P stays f32: the warp
// writes P (times the V scale) to its own shared scratch and runs PV on the
// CUDA cores in f32, each lane 4 (d128) output columns of every row, a V row
// read once per warp. The per-warp states merge through the split partials.
//
// A 4-bit side is read as it lies: the bulk copies move its packed rows (D/2
// bytes), each consumer widens the nibbles in registers, exactly and with no
// conversion instruction. Integer chain: a nibble n shifted to the top of its
// byte is the s8 value 16 n, so the operands are the bytes (w << 4) &
// 0xF0F0F0F0 (low nibbles) and w & 0xF0F0F0F0 (high nibbles); the dot comes
// out 16 times too large, exactly (|sum| < 2^24), and is scaled by 1/16.
// Float chain: the biased nibble u = n + 8 (w ^ 0x88888888) in the low
// mantissa bits of bf16 128 is 128 + u, and one bf16x2 fma takes 136 off.
// PV: each lane's columns lie in one half of D, so it reads the low or the
// high nibbles of its bytes, each u placed in the mantissa of 2^23 and 2^23
// + 8 subtracted.
//
// Measured on an H100 80GB HBM3 at 700 W (script/torch_decode_ab.py) at b4
// h32 hk8 s32768 d128: int8 cache 0.107 ms, bf16 0.185 (SDPA with one query
// a head: 0.185); with the loads alone (its copy-only probe) 0.095 / 0.183,
// about 2.9 TB/s of cache bytes: the load structure, not the math, bounds it.

#include "decode_attention.cuh"

// All tensors contiguous, natural layout.
//   q: [B, H, D] f32 (q_bf16 0) or bf16 (1).   k, v: [B, Hk, S, D] int8
//   codes (k_bits / v_bits 8), [B, Hk, S, D/2] packed 4-bit codes (4) or
//   bf16 (16), 16-byte aligned.   k_scale: [B, Hk, S] f32.   v_scale:
//   [B, Hk, S] f32 (quantized V only, else null).   lengths: [B]
//   int32 on the device.   part_acc: [B, H, 4 n_splits, D] f32 and part_ml:
//   [B, H, 4 n_splits, 2] f32 scratch.   tickets: [B, Hk * (H / Hk) / R]
//   int32, zero before the launch and left zero after it (calls that share
//   them run one after another).   o: [B, H, D] f32 (out_code 0), bf16 (1)
//   or f16 (2).   lse: [B, H] f32 (base 2) or null.
// R query rows (a divisor of H / Hk, at most 8) per CTA; splits of `chunk`
// keys (a multiple of 64), at most 64 splits, over the cache's rows, or with
// window > 0 over the logical keys of the compacted walk (sink rounded up to
// 64, then the window phase); sink counts only under a window; logit_cap 0
// is none. One launch. Returns
// cudaGetLastError() (cudaErrorInvalidValue for an unsupported D, mode or
// output type, or too many splits).
extern "C" int lowbit_decode_attn(const void* q, const void* k, const void* v, const float* k_scale,
                                  const float* v_scale, const int* lengths, float* part_acc, float* part_ml,
                                  int* tickets, void* o, float* lse, int B, int H, int Hk, int S, int D, int R,
                                  int k_bits, int v_bits, int int_qk, int q_bf16, int out_code, int n_splits,
                                  int chunk, int window, int sink, float sm_scale, float logit_cap, void* stream) {
  if (R < 1 || R > RMAX || (H / Hk) % R || chunk % 64 || out_code < 0 || out_code > 2 || n_splits < 1 ||
      window < 0 || sink < 0 || logit_cap < 0.0f)
    return (int)cudaErrorInvalidValue;
  const Launch launch{q,       k_scale, v_scale, k,        v,      lengths, part_acc, part_ml,
                      tickets, o,       lse,     B,        H,      Hk,      S,        R,
                      n_splits, chunk,  q_bf16,  out_code, window, window > 0 ? sink : 0, sm_scale, logit_cap,
                      static_cast<cudaStream_t>(stream)};
  return with_variant(launch, D, k_bits, v_bits, int_qk);
}

// How many CTAs of the variant (D, k_bits, v_bits, int_qk; with the window
// and cap, masks) one SM of the current device holds at once, into
// *ctas_per_sm. Returns a cudaError_t. Host-side only: it does not touch the
// stream.
extern "C" int lowbit_decode_ctas_per_sm(int D, int k_bits, int v_bits, int int_qk, int masks, int* ctas_per_sm) {
  return with_variant(Occupancy{ctas_per_sm, masks != 0}, D, k_bits, v_bits, int_qk);
}
