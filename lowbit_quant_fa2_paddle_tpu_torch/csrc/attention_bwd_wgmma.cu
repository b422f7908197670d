// Kernels G1 and G2 on Hopper's own machinery: the FlashAttention-2
// backward by TMA, wgmma and warp specialisation.
//
// Replace the TPU kernels of lowbit_quant_fa2_paddle_tpu/ops/attention_bwd.py
// launched by _flash_bwd: _bwd_dq_kernel (G1, pallas_call at :302) and
// _bwd_dkv_kernel (G2, pallas_call at :346). From the forward's base-2 LSE
// and di = rowsum(dO * O), for every visible pair (r, c), exactly as the
// plain version (attention_bwd_plain in ops/attention_bwd.py):
//   s2 = q.k * scale2                  scale2 = sm_scale * log2(e)
//   p  = exp2(s2 - lse2[r]),  dp = dO.v,  ds = p * (dp - di[r]) * sm_scale
//   G1: dq[r] = sum_c bf16(ds) bf16(k[c])
//   G2: dv[c] = sum_r bf16(p) bf16(dO[r]),  dk[c] = sum_r bf16(ds) bf16(q[r]),
//       with r over every query head of the KV head's group (GQA).
// Float mode: q, k, v, dO arrive as bf16 (the wrapper rounds f32 inputs for
// the tensor cores). Quantized mode: int8 per-token codes with f32 scales,
//   s2 = (f32(i32(q8.k8)) * (qs * scale2)) * ks,  dp = (f32(i32(dO8.v8)) * dos) * vs;
// G1 folds ks into ds; G2 folds qs into ds and dos into p; the codes enter the
// bf16 products exactly, widened by the producer warpgroup.
// p and ds stay f32 and round to bf16 only as operands. Masks: causal
// top-left (c <= r), the causal window (c + window > r), rows past Sq and
// keys past Sk (TMA fills them with zeros, and exp2(0 - lse) is not 0).
//
// Bound on the H100: the tensor cores. G1 runs three products (QK^T, dO V^T,
// dS K) and G2 four (K Q^T, V dO^T, P^T dO, dS^T Q), each 2*D operations per
// visible pair; at b1 h30 s17776 d64 that is 3.64 and 4.85 TFLOP against
// ~0.3 GB of operands. Beside them the per-pair chain (one exp2 on the MUFU
// pipe, the ds arithmetic, two bf16 packs in G2) on the CUDA cores, whose
// latency the consumer warpgroups hide under each other's products.
//
// Design: a producer warpgroup gives its registers away (setmaxnreg); its
// first thread keeps a ring of tiles in flight by TMA from 3-D tensor maps
// [B*heads, S, D] into swizzled shared memory (128-byte swizzle for rows of
// 128 bytes, bf16 d128 rows in two 64-column halves, 64-byte for int8 d64
// rows) with full/empty mbarriers. In the quantized mode the tiles arrive on
// a third barrier, and the producer warpgroup widens the int8 tiles that
// feed a bf16 product (K in G1; Q and dO in G2) into bf16 tiles beside them
// and copies the per-row scales, so the consumers run one loop in every
// mode. Consumer warpgroups own 64 rows each; G1's take turns on named
// barriers, as in kernel A.
// G1 (dq) is the forward's shape with K in V's place: one CTA per (64 x NWG
// q rows, head, batch), NWG = 3 at d64, 2 at d128; the consumers load their Q
// and dO rows once; the ring streams 64-key K and V tiles. S = Q K^T and
// dP = dO V^T are wgmma with both operands in shared memory; ds is formed in
// the S accumulator's registers, packed to bf16 and fed as the register A
// operand of dq += dS K, K's tile read MN-major through a second descriptor.
// Each block of products issues S and dP of tile j+1 and dS K of tile j, and
// ds of j+1 is formed under dS K. lse and di are final, so nothing rescales.
// G2 (dk, dv): one CTA per (128 keys, KV head, batch), two consumer
// warpgroups of 64 keys each holding dk and dv in f32 registers, which
// issue their products freely (turns measured slower here); they load
// their K and V rows once, as register A fragments at d64 and into shared
// memory at d128. The ring streams 64-row Q and dO tiles of each head of
// the GQA group (group head outer, q tile inner: a fixed order, so the same
// sums come out on every run; no atomics), and the producer's first warp
// copies each tile's lse and di with plain loads (a 1-D TMA of a head's row
// faults where it does not start on 16 bytes). From S^T = K Q^T and dP^T =
// V dO^T, P^T and dS^T come out in the accumulator layout, which is the
// register A layout of dv += P^T dO and dk += dS^T Q, dO and Q read
// MN-major from the tiles that fed S^T and dP^T (their widened copies in
// the quantized mode).
// At d64 each block issues S^T, dP^T of tile i+1 and the dk, dv products of
// tile i; at d128 (dk and dv alone hold 128 registers a thread) the two run
// one after the other. Causal CTAs stop at the diagonal (G1's launched
// heaviest first) and the window's edge; only diagonal, window-edge and
// ragged tiles test the masks (their chain is compiled apart), and the tile
// loops are peeled so that no product sits on a branch.
//
// Head_dim 256 (attention_bwd_wgmma_d256.cu; the device code is
// attention_bwd_wgmma.cuh's, shared with this source, whose d64/d128
// kernels keep their code): G1 runs one consumer warpgroup of 64 q rows
// (dq is 128 f32 registers a thread, S and dP 64 more) over a ring of 2
// stages of 64-key K and V tiles (resident Q and dO and a stage take 64 KB
// each in bf16), dS K as two products of 128 columns. G2's dk and dv would
// take 256 registers a thread, so its two consumer warpgroups split the work
// over the same 64 keys: warpgroup 0 forms S^T and P^T and makes dv,
// warpgroup 1 forms S^T, dP^T and dS^T and makes dk (five products a tile,
// one after the other); K and V stay in shared memory beside a ring of 2
// stages of Q and dO (the int8 ones and their widened copies in the
// quantized mode, where the q rows' scales are read from global memory).
// Head dims 129-255 are zero-padded to 256 by the caller.

#include "attention_bwd_wgmma.cuh"

// All tensors contiguous, natural layout, 16-byte aligned:
//   q, dO: [B, H, Sq, D];  k, v: [B, Hk, Sk, D]; bf16 (quantized = 0) or int8
//   per-token codes (quantized = 1) with q_scale, do_scale [B, H, Sq] and
//   k_scale, v_scale [B, Hk, Sk] f32.
//   lse: [B, H, Sq] f32, base 2;  di: [B, H, Sq] f32 = rowsum(dO * O).
//   dq: [B, H, Sq, D], dk, dv: [B, Hk, Sk, D]; f32 (dq_f32 / dkv_f32 = 1) or bf16.
//   parts: 1 launches G1 (dq), 2 launches G2 (dk, dv), 3 both, G1 first.
//   window: the causal sliding window (keys c with c + window > r), 0 for none.
//   scale2 = sm_scale * log2(e);  ds_scale = scale2 / log2(e).
//   D: 64, 128 (this source's kernels) or 256 (attention_bwd_wgmma_d256.cu).
// Returns cudaGetLastError() (cudaErrorInvalidValue for an unsupported D,
// missing operands or a tensor map the driver refuses).
extern "C" int lowbit_attn_bwd_wgmma(const void* q, const void* k, const void* v, const void* dO, const float* lse,
                                     const float* di, const float* q_scale, const float* k_scale,
                                     const float* v_scale, const float* do_scale, void* dq, void* dk, void* dv, int B,
                                     int H, int Hk, int Sq, int Sk, int D, int quantized, int causal, int window,
                                     int dq_f32, int dkv_f32, int parts, float scale2, float ds_scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (Hk <= 0 || H % Hk != 0 || Sq < 1 || Sk < 1 || window < 0 || parts < 1 || parts > 3)
    return (int)cudaErrorInvalidValue;
  if (quantized && (!q_scale || !k_scale || !v_scale || !do_scale)) return (int)cudaErrorInvalidValue;
  if (((parts & 1) && !dq) || ((parts & 2) && (!dk || !dv))) return (int)cudaErrorInvalidValue;
  const Args a{q, k, v, dO, lse, di, q_scale, k_scale, v_scale, do_scale, dq, dk, dv,
               H, Hk, Sq, Sk, causal, window, dq_f32, dkv_f32, scale2, ds_scale};
  if (D == 64) return quantized ? launch<64, true>(a, B, parts, st) : launch<64, false>(a, B, parts, st);
  if (D == 128) return quantized ? launch<128, true>(a, B, parts, st) : launch<128, false>(a, B, parts, st);
  if (D == 256) return attn_bwd_d256(a, B, quantized, parts, st);
  return (int)cudaErrorInvalidValue;
}
