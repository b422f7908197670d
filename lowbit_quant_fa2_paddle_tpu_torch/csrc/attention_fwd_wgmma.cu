// Kernel A on Hopper's own machinery: FlashAttention-2 forward with INT8,
// packed INT4/INT2 or bf16 QK and bf16 or INT8 PV, by TMA, wgmma and warp
// specialisation.
//
// Replaces the TPU kernel lowbit_quant_fa2_paddle_tpu/ops/attention.py:
// _attn_body_km (launched by lowbit_attention_km, pallas_call at :1491 and
// :1502) in every mode: INT8 Q codes with per-row scales, or bf16/f32 Q
// quantized per row in the prologue; INT8 K codes, or K packed two (INT4,
// halves of D) or four (INT2, quarters of D) codes per byte, with per-row
// scales; or bf16 Q/K (fp mode); bf16 V, or per-channel INT8 V codes widened
// to bf16 exactly, or multiplied as an exact INT8 dot against P requantized
// to [0, 127] (INT8 PV), with a v_scale epilogue; an optional v_mean; bf16
// or f32 output; causal (top-left aligned) or not; GQA; any Sq, Sk; base-2
// LSE out; head_dim 64 or 128 (this file) and 256 (attention_fwd_wgmma_d256.cu,
// KV tiles of 64 keys). These are the DiT's int8, fp, int4 and
// int8_v8 impls, the LLM prefill, the training forward and pv_int8. The
// masks of every mode, as the TPU kernel's _attn_body_km computes them
// (:382-413): a causal sliding window (keys c + window > r + q_offset) with
// attention sinks (keys c < sink), q_offset (query positions shifted, for
// ring hops and windowed prefix prefill), segment ids (varlen), the KV
// edge, and a logit cap s = c2 tanh(s / c2) in base 2 before the mask; an
// additive bias (:379-384), a per-key vector [B, H, 1, Sk] or a full matrix
// [B, H, Sq, Sk] in base 2 (scaled by log2 e on the host), added after the
// scale and before the cap and the masks; and fp32 PV (pv_dtype f32, :327,
// :454-455: no bf16 rounding of s - m or of P; attention_fwd_wgmma_pv32.cu).
// A row that sees no key gives o = 0 and lse = -1e30.
//
// Arithmetic over KV tiles of BKV keys, as in the TPU kernel:
//   s  = (f32(i32 Q8 K8^T) * k_scale) * q_scale   q_scale holds sm_scale*log2e
//   s  = f32(Qbf Kbf^T) * sm_scale*log2e          fp mode
//   masked s = MASK_VALUE;  m' = max(m, rowmax s)
//   P = bf16(exp2(bf16(s - m')));  l = 2^(m-m') l + sum P;  acc = 2^(m-m') acc + P V
//   o = acc / l (* v_scale) (+ v_mean where l > 0);  lse2 = m + log2 l, or -1e30 where l == 0
// INT8 PV: the x127 requantization is folded into the shift,
//   P = bf16(exp2(bf16(s - (m' - log2 127))));  p8 = min(trunc(bf16(P + 0.5)), 127)
//   l = 2^(m-m') l + sum p8;  acc = 2^(m-m') acc + f32(i32 p8 V8);  lse2 -= log2 127
//
// Bound on the H100: the tensor cores (4*D operations per (q, k) pair), and
// at d64 as much the per-pair softmax chain: 11-14 instructions issued per
// pair, one exp2 on the 16-per-clock MUFU pipe, and latency between its
// dependent steps. The chain is cut to what the rounding needs: s - m' and
// P round two at a time by cvt.rn.bf16x2.f32 (not integer rounding, not
// F2F one at a time), exp2 is ex2.approx.ftz (see ex2), and the s32 -> f32
// conversion is I2FP (measured faster here than the exact bit trick
// i2f_exact, which the widening of INT8 V uses).
//
// Design: one CTA per (64 x NWG q rows, head, batch) of NWG consumer
// warpgroups (3 at d64, 2 at d128) and one producer warpgroup, which gives
// its registers away (setmaxnreg). Its first thread keeps a ring of STAGES
// K/V tiles in flight by TMA from 3-D tensor maps [B*Hk, Sk, row] (rows past
// Sk arrive as zeros, so V's never bring a neighbour's NaN), with full/empty
// mbarriers, and its threads copy the tile's K scales (a head's row of Sk
// f32 need not start on the 16 bytes TMA wants). K and V land in swizzled
// shared memory (128-byte swizzle for rows of 128 bytes, 64-byte for int8
// d64 rows; bf16 d128 in two 64-column halves). Packed K and INT8 V arrive
// as they lie in memory in a staging ring, and the producer warpgroup
// widens them into those tiles (per-byte sign extension of the nibbles or
// 2-bit fields; int8 to bf16 through the bits of 1.5*2^23 + c), so the
// consumers run the same loop in every mode. Each consumer warpgroup owns
// 64 query rows; its Q rows are loaded (or quantized) once into swizzled
// shared memory. S = Q K^T comes from wgmma with both operands in shared
// memory (m64n128k32 s8 or m64n128k16 bf16); the softmax runs on the
// accumulator in registers; P goes to bf16 in registers and is the A operand
// of O += P V (m64nDk16, V MN-major from shared memory). The warpgroups take
// turns on named barriers: each issues S of tile j+1 and PV of tile j as two
// groups, and runs the softmax of tile j+1 as soon as S is in, under its own
// PV and the others' products. Causal CTAs are launched heaviest first and
// stop their KV loop at the diagonal; with a window they start it at the
// band's first tile, after the tiles that hold sink keys (the TPU kernel's
// _tri_schedule): the producer and the consumers walk that visit list
// alike, and the ring's stage and phase follow the visit, not the tile.
// Only tiles at the diagonal, the band's lower edge, the sinks or the KV
// edge, and every tile of a call with segment ids, are masked. A bias runs
// the kBias kernels (attention_fwd_wgmma_bias.cu; at d256 the masked
// kernels are these): a vector's values at the tile's keys ride in the
// ring beside the K scales, a matrix is read by the consumers where it lies
// at their accumulator's positions (each element once); the
// producer's first warp copies a tile's segment ids into shared memory
// beside its K scales. QK's type, the staging ring and the masks (kMasks:
// a window, a q offset, segment ids or a cap) are template parameters (8
// kernels per head_dim); the Q, K and V formats and the output type are
// read at run time. Calls without masks run kernels that carry none of the
// masks' state: they take Args alone and compile to the same SASS as before
// masks (script/torch_attention_ab.py --sass compares them).
//
// INT8 PV is two more kernels per head_dim and mask setting (INT8 or bf16 QK). 8-bit
// wgmma takes B K-major, so the producer rewrites each staged INT8 V tile as
// V^T, [D][128 keys] in 128-byte swizzled rows, with the keys of each 32-key
// chunk in the order of the s8 A fragment: the S accumulator gives a thread
// keys 2t, 2t+1 of each 8-key block, the fragment wants slots 4t .. 4t+3 and
// 16+4t .. of a chunk, so slot 16h + 4t + i holds key 16h + 8(i>>1) + 2t +
// (i&1) and p8 packs into A with byte permutes. p8 = min(floor(P +
// 0.501953125), 127): for bf16 P that is trunc(bf16(P + 0.5)) (the bf16
// rounding of P + 0.5 moves floor only for P in [0.498046875, 0.5), which
// the extra 2^-9 covers); floor is an fadd.rm with 2^23, the saturation a
// byte subtract, l a dp4a of the packed bytes. O += P V runs as m64nDk32 s8
// into an s32 tile that is folded into the f32 O after each product.
//
// Head_dim 256 (attention_fwd_wgmma_d256.cu): KV tiles of 64 keys (S is
// m64n64), two consumer warpgroups at setmaxnreg 232, Q rows of 256 / 512
// bytes in 2 / 4 swizzled column blocks as K and V; PV as two m64n128k16
// products a 16-key step (V's column blocks 0-1 and 2-3) into the 128 f32 of
// O; INT8 PV's V^T rows are 64 bytes (64-byte swizzle) and its product runs
// in two halves of 128 columns, each waited for and folded into O before
// the next (a 64 x 256 s32 tile beside O would not fit), without the overlap
// of S and PV. Head dims 129-255 are zero-padded to 256 by the caller.
//
// fp32 PV (kPV32, attention_fwd_wgmma_pv32.cu and attention_fwd_wgmma_pv32_d256.cu):
// the masked kernels with 64-key tiles, P = ex2(s - m) in f32, l summed in
// f32, P split into three bf16 terms P1 = bf16(P), P2 = bf16(P - P1), P3 =
// bf16(P - P1 - P2), and V given by the host as three bf16 terms of one
// 3D-wide row (V1 | V2 | V3 the same way; int8 codes are exact in V1): for
// each 16-key step the six products P3 V1, P2 V2, P1 V3, P2 V1, P1 V2, P1
// V1 (each factor's 24 bits; the dropped terms are below 2^-24 of P V) into
// a 64-column block's own f32 accumulator that its first product starts at
// zero, which the CUDA cores then add to the running O (the tensor cores'
// f32 sums across tiles had cost 2.7-3.5e-6 of O), one block after another,
// without the overlap of S and PV. Two terms each (three products) would
// leave P_lo V_lo and V's split residual, each up to 2^-16 of P V, which
// rows that see few keys (one P near 1 against |V| up to 4) show at
// 1.5-2.1e-5 on an H100. At d64 it runs two consumer warpgroups (P's three
// fragments beside S need the registers); at d256 the ring has one stage.

#include "attention_fwd_wgmma.cuh"

// All tensors contiguous, natural layout, 16-byte aligned.
//   q: [B, H, Sq, D] int8 codes (q_mode 0), bf16 (1, 3) or f32 (2).
//   k: q_mode 0-2: [B, Hk, Sk, D*k_bits/8] int8, codes (k_bits 8) or packed
//      INT4 (4) / INT2 (2) codes; q_mode 3: [B, Hk, Sk, D] bf16 (k_bits 16).
//   v: [B, Hk, Sk, D] bf16 (v_mode 0) or int8 codes (v_mode 1, bf16 PV; v_mode
//      2, INT8 PV) with v_scale [B, Hk, D] f32; with pv32, [B, Hk, Sk, 3D]
//      bf16, V's three bf16 terms V1 | V2 | V3 (v_mode 1: int8 codes in V1,
//      the others zero, v_scale applied in the epilogue).
//   q_scale: [B, H, Sq] f32, already times sm_scale*log2e (q_mode 0 only).
//   k_scale: [B, Hk, Sk] f32 (q_mode 0-2).   v_mean: [B, Hk, D] f32 or null.
//   q_seg: [B, Sq] int32 and kv_seg: [B, Sk] int32 segment ids, or both null.
//   bias: [B, H, bias_rows, Sk] f32 in natural-log units (bias_rows 1 or Sq),
//   or null with bias_rows 0; the kernel takes it to base 2 as it loads it.
//   o: [B, H, Sq, D] bf16 (out_f32 = 0) or f32.   lse: [B, H, Sq] f32 (base 2) or null.
//   window: 0 (none) or the keys a causal row sees, itself included; sink:
//   the leading keys every row sees under a window; q_offset: added to every
//   query's position (causal only); logit_cap2: cap * log2(e), 0 for none;
//   pv32: fp32 PV (not with v_mode 2).
//   D: 64, 128 (this source's kernels) or 256 (attention_fwd_wgmma_d256.cu);
//   fp32 PV runs attention_fwd_wgmma_pv32.cu's kernels (64/128) or
//   attention_fwd_wgmma_pv32_d256.cu's, and a bias without it
//   attention_fwd_wgmma_bias.cu's.
// Returns cudaGetLastError() (cudaErrorInvalidValue for a D, mode or pv32
// no kernel takes, or a tensor map cuTensorMapEncodeTiled refuses).
extern "C" int lowbit_attn_fwd_wgmma(const void* q, const void* k, const void* v, const float* q_scale,
                                     const float* k_scale, const float* v_scale, const float* v_mean,
                                     const int* q_seg, const int* kv_seg, const float* bias, void* o, float* lse,
                                     int B, int H, int Hk, int Sq, int Sk, int D, int q_mode, int k_bits, int v_mode,
                                     int out_f32, int causal, int window, int sink, int q_offset, int bias_rows,
                                     int pv32, float sm_scale_log2e, float logit_cap2, void* stream) {
  const AttnFwdCall c{q, k, v, q_scale, k_scale, v_scale, v_mean, q_seg, kv_seg, bias, o, lse, B, H, Hk, Sq, Sk, D,
                      q_mode, k_bits, v_mode, out_f32, causal, window, sink, q_offset, bias_rows, pv32,
                      sm_scale_log2e, logit_cap2, static_cast<cudaStream_t>(stream)};
  if (const int bad = attn_check(c)) return bad;
  if (pv32) return D == 256 ? attn_fwd_pv32_d256(c) : attn_fwd_pv32(c);
  if (D == 256) return attn_fwd_d256(c);
  if (bias) return attn_fwd_bias(c);
  const BiasArgs a = args_of(c);
  return D == 64 ? dispatch<64>(a, v_mode == 2, k, v, B, c.stream) : dispatch<128>(a, v_mode == 2, k, v, B, c.stream);
}
