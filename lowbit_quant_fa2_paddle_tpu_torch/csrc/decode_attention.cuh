// Kernel D's device code, shared by its single-token instances
// (decode_attention.cu, decode_attention_d256.cu, decode_attention_d80_96.cu,
// decode_attention_dyn.cu), its multi-token / INT8-PV instances
// (decode_attention_multi.cu, decode_attention_multi_d256.cu,
// decode_attention_multi_d80_96.cu, decode_attention_multi_dyn.cu) and their
// paged twins (decode_attention_paged*.cu); the design note is in
// decode_attention.cu.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "sm90.cuh"

namespace {

using namespace sm90;

constexpr int NW = 4;          // consumer warps
constexpr int NT = 32 * (NW + 1);
constexpr int RMAX = 8;        // query rows per CTA, at most (the mma's n)
// Ring stages (Cfg::NST), a multiple of NW: the tiles of a stage all go to
// one warp, so a warp never waits on a phase that another warp's tile still
// holds. 2 NW, or NW where 2 NW stages of the widest rows (bf16 at d512)
// would pass 128 KB.
constexpr int NST_MAX = 2 * NW;
constexpr float MASK_VALUE = (float)(-0.7 * 3.4028234663852886e38);
constexpr float NEG_INIT = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

// ---------------------------------------------------------------------------
// Helpers
// ---------------------------------------------------------------------------

// A bulk copy global -> shared, completion in bytes on bar, with an L2
// evict-first policy: the cache is read once a call (measured 1.5% faster
// on the bf16 cache than the default policy).
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "{\n.reg .b64 pol;\ncreatepolicy.fractional.L2::evict_first.b64 pol, 1.0;\n"
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes.L2::cache_hint [%0], [%1], %2, [%3], pol;\n}\n"
      ::"r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_u32(dst)), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(smem_u32(dst)), "l"(src) : "memory");
}

// Arrives on bar once this thread's earlier cp.async copies have landed
// (the barrier's expected count includes this arrival).
__device__ __forceinline__ void cp_async_mbar_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void mma_s8(int (&c)[4], uint32_t a0, uint32_t a1, uint32_t a2, uint32_t a3, uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], uint32_t a0, uint32_t a1, uint32_t a2, uint32_t a3,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Four int8 codes of a word to exact floats: each byte, biased by 128, is
// placed in the mantissa of 2^23 and the bias subtracted.
__device__ __forceinline__ void widen_i8(uint32_t w, float* f) {
  const uint32_t u = w ^ 0x80808080u;
#pragma unroll
  for (int i = 0; i < 4; ++i) f[i] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540 | i)) - 8388736.0f;
}

// N contiguous bytes of shared memory (N = 1, 2, 4, 8, 16) as words.
template <int N>
__device__ __forceinline__ void lds(const unsigned char* p, uint32_t* w) {
  if constexpr (N == 16) {
    const uint4 x = *reinterpret_cast<const uint4*>(p);
    w[0] = x.x, w[1] = x.y, w[2] = x.z, w[3] = x.w;
  } else if constexpr (N == 8) {
    const uint2 x = *reinterpret_cast<const uint2*>(p);
    w[0] = x.x, w[1] = x.y;
  } else if constexpr (N == 4) {
    w[0] = *reinterpret_cast<const uint32_t*>(p);
  } else if constexpr (N == 2) {
    w[0] = *reinterpret_cast<const uint16_t*>(p);
  } else {
    w[0] = *p;
  }
}

// The element type of a 4-bit cache side: two codes a byte, halves of D.
struct Nib4 {};

template <typename T>
struct IsNib4 {
  static constexpr bool value = false;
};
template <>
struct IsNib4<Nib4> {
  static constexpr bool value = true;
};

// Bytes of a cache row of D elements.
template <typename T, int D>
constexpr int row_bytes() {
  return IsNib4<T>::value ? D / 2 : D * (int)sizeof(T);
}

// The CPL (at most 8) elements of a V row a lane owns, as floats. For a 4-bit V, p
// points at the CPL bytes that hold them and `nib_shift` is 0 for the low
// nibbles (the first half of D) or 4 for the high ones.
template <typename VT, int CPL>
__device__ __forceinline__ void v_cols(const unsigned char* p, float* f, int nib_shift) {
  if constexpr (CPL == 8 && (IsNib4<VT>::value || sizeof(VT) == 1)) {
    // d256: two words of 4 codes (int8) or of 4 bytes of nibbles.
    uint32_t w[2];
    lds<8>(p, w);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if constexpr (IsNib4<VT>::value) {
        const uint32_t u = ((w[h] >> nib_shift) & 0x0F0F0F0Fu) ^ 0x08080808u;  // n + 8 a byte
#pragma unroll
        for (int i = 0; i < 4; ++i)
          f[4 * h + i] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540 | i)) - 8388616.0f;
      } else {
        widen_i8(w[h], f + 4 * h);
      }
    }
  } else if constexpr (IsNib4<VT>::value) {
    uint32_t w[1];
    lds<CPL>(p, w);
    const uint32_t u = ((w[0] >> nib_shift) & 0x0F0F0F0Fu) ^ 0x08080808u;  // n + 8 a byte
#pragma unroll
    for (int i = 0; i < CPL; ++i) f[i] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540 | i)) - 8388616.0f;
  } else if constexpr (sizeof(VT) == 1) {
    uint32_t w[1];
    lds<CPL>(p, w);
    if constexpr (CPL == 4) {
      widen_i8(w[0], f);
    } else {
#pragma unroll
      for (int i = 0; i < CPL; ++i) f[i] = (float)(int8_t)(w[0] >> (8 * i));
    }
  } else {
    uint32_t w[CPL >= 2 ? CPL / 2 : 1];
    lds<2 * CPL>(p, w);
#pragma unroll
    for (int i = 0; i < CPL; ++i) f[i] = i & 1 ? bf16_hi(w[i / 2]) : bf16_lo(w[i / 2]);
  }
}

// ---------------------------------------------------------------------------
// Shapes and shared memory of one variant
// ---------------------------------------------------------------------------

// The template D of the instances that take the head dim at run time
// (decode_attention*_dyn.cu, and at W 512 decode_attention*_dyn512.cu):
// kDynD | W takes every head dim d that is a multiple of 16 with 16 <= d <=
// W, its rows at the cache's own width (d bytes of int8, d/2 of 4-bit codes,
// 2d of bf16) and its shared memory laid out for W.
constexpr int kDynD = 1 << 12;

template <int D, typename KT, typename VT, bool kIntQK>
struct Cfg {
  static constexpr bool kKNib = IsNib4<KT>::value, kVNib = IsNib4<VT>::value;
  // Head dim at run time (kDynD), at most W; else D itself.
  static constexpr bool kDyn = (D & kDynD) != 0;
  static constexpr int W = D & (kDynD - 1);
  static constexpr int kKRow = row_bytes<KT, W>();  // bytes of a cache row (the widest one, kDyn)
  static constexpr int kVRow = row_bytes<VT, W>();
  // Head dims off the power-of-two ladder (80 and 96, decode_attention_d80_96.cu
  // and its twins): their rows need not fill whole QK windows, and a lane
  // cannot own D / 32 columns. Everything they change is under
  // `if constexpr (kOffLadder)` or a constant the ladder dims keep.
  static constexpr bool kOffLadder = !kDyn && (W & (W - 1)) != 0;
  // The lanes whose PV columns lie past the row's idle (pv_lane): off the
  // ladder, and at a head dim below W.
  static constexpr bool kPartial = kOffLadder || kDyn;
  // Keys per tile: 16 KB of K/V at most (measured faster than 8 KB for the
  // bf16 cache), 16 at least.
  static constexpr int BK = 64 * (kKRow + kVRow) <= 16384 ? 64 : 32 * (kKRow + kVRow) <= 16384 ? 32 : 16;
  // QK operands: per window of WB bytes of a K row each thread (t = lane &
  // 3) reads LB contiguous bytes, which give 2 MMA operand words a row: MMA
  // products per window. An integer-chain word carries 4 dimensions (s8),
  // a float-chain word 2 (bf16x2); a 4-bit row's LB bytes carry LB low and
  // LB high nibbles. Off the ladder the integer chain takes the small
  // windows (d96: 3 windows of 32 bytes of int8 K, of 16 of 4-bit K) and a
  // bf16 row that 64-byte windows do not cover (d80) 8 bytes a thread. At a
  // head dim taken at run time int8 K on the integer chain takes the
  // ladder's 64-byte windows (the last one read on past the row's end), the
  // rest the small ones (32 bytes, 16 of 4-bit K), which a bf16 row fills
  // exactly (2d bytes, d % 16 == 0).
  static constexpr int LB = kDyn ? (kKNib ? 4 : kIntQK ? 16 : 8)
                        : kIntQK ? (W >= 64 && !kOffLadder ? (kKNib ? 8 : 16) : (kKNib ? 4 : 8))
                                 : (kKNib ? 4 : sizeof(KT) == 2 && kKRow % 64 ? 8 : 8 * (int)sizeof(KT));
  static constexpr int WB = 4 * LB;
  // Windows a row takes (at most, kDyn: a call's row skips those past its
  // end). At d80 an int8 or 4-bit row ends inside its last window (80 of 96
  // bytes, 40 of 48), and so may one at run time: the words past the row's
  // end read the next row's bytes (or the V ring's: all in shared memory,
  // and integer codes, never NaN), and their query words are zero
  // (kOverRead, or a word's qbyte past the row at run time), so the dot is
  // exact.
  static constexpr int NWIN = (kKRow + WB - 1) / WB;
  static constexpr bool kOverRead = NWIN * WB != kKRow;
  static constexpr int MMA = kIntQK ? (kKNib ? LB / 4 : LB / 8) : kKNib || sizeof(KT) == 1 ? 2 : LB / 8;
  // Output columns a lane owns in PV: W / 32, or 4 off the ladder, where the
  // lanes whose columns lie past the row's (pv_lane) idle in PV. They come
  // in NCG groups of CG (at most 8): at W 512 a lane owns columns 8 lane ..
  // and 256 + 8 lane .. (a 4-bit V: the nibbles of bytes 8 (lane & 15) ..
  // and 128 + 8 (lane & 15) ..), so that every head dim that is a multiple
  // of 16 fills whole groups, and INT8 PV sums one group at a time.
  static constexpr int CPL = kOffLadder ? 4 : W / 32;
  static constexpr int CG = CPL > 8 ? 8 : CPL, NCG = CPL / CG;
  // The float chain's query fragments (3 bf16 terms a word) at W 512 would
  // take 192 registers beside the 128 of the accumulator: they live in
  // shared memory, read once a window and tile.
  static constexpr bool kQSmem = !kIntQK && W > 256;
  // The head dim of a call: the run-time one (kDyn), else D.
  __device__ static int dim(int head_dim) { return kDyn ? head_dim : W; }
  // The first dimension of operand word u of thread t in window w, at head
  // dim dh. A 4-bit row's words hold the low nibbles (dimensions b0 ..)
  // first, then the high ones (dh/2 + b0 ..), b0 the thread's first byte.
  __device__ static constexpr int qdim(int w, int t, int u, int dh = W) {
    constexpr int per = kIntQK ? 4 : 2;
    if constexpr (kKNib) {
      const int b0 = w * WB + t * LB;
      return u < MMA ? b0 + per * u : dh / 2 + b0 + per * (u - MMA);
    } else {
      return (w * WB + t * LB) / (int)sizeof(KT) + per * u;
    }
  }
  // The byte of a K row where operand word u of thread t in window w starts
  // (a word never straddles the row's end: 80 and 40 are multiples of 4).
  __device__ static constexpr int qbyte(int w, int t, int u) {
    constexpr int per = kIntQK ? 4 : 2;
    if constexpr (kKNib)
      return w * WB + t * LB + per * (u % MMA);
    else
      return qdim(w, t, u) * (int)sizeof(KT);
  }
  // Off the ladder and at run time: whether a lane owns PV columns of group
  // cg at head dim dh, and their first column (a 4-bit V's lanes 0-15 take
  // the low nibbles, columns 16 CG cg + CG (lane & 15) .., lanes 16-31 the
  // high ones, dh/2 + 16 CG cg + CG (lane & 15) ..).
  __device__ static constexpr bool pv_lane(int lane, int dh = W, int cg = 0) {
    return kVNib ? 16 * CG * cg + (lane & 15) * CG < dh / 2 : 32 * CG * cg + lane * CG < dh;
  }
  __device__ static constexpr int pv_col(int lane, int dh = W, int cg = 0) {
    return kVNib ? (lane >= 16 ? dh / 2 : 0) + 16 * CG * cg + (lane & 15) * CG : 32 * CG * cg + lane * CG;
  }
  // Sides whose rows are not 16-byte multiples (4-bit rows at d80, 40
  // bytes; at run time 4-bit rows at d % 32 == 16) come by 8-byte cp.async
  // from every producer lane instead of one bulk copy: a bulk copy moves
  // 16-byte multiples from 16-byte aligned rows, which a window's first row
  // need not be.
  static constexpr bool kKBulk = kKRow % 16 == 0, kVBulk = kVRow % 16 == 0;
  static constexpr int kBulkRow = (kKBulk ? kKRow : 0) + (kVBulk ? kVRow : 0);  // bulk-copied bytes a key
  // A call's rows: the bytes of a K and a V row at head dim dh, and whether
  // each side comes by bulk copies (the compile-time values but at run time).
  struct Rows {
    int k, v;
    bool k_bulk, v_bulk;
    __device__ int bulk() const { return (k_bulk ? k : 0) + (v_bulk ? v : 0); }
  };
  __device__ static Rows rows(int dh) {
    if constexpr (kDyn) {
      const int k = kKNib ? dh / 2 : dh * (int)sizeof(KT), v = kVNib ? dh / 2 : dh * (int)sizeof(VT);
      return Rows{k, v, k % 16 == 0, v % 16 == 0};
    } else {
      return Rows{kKRow, kVRow, kKBulk, kVBulk};
    }
  }
  static constexpr int NST = 8 * BK * (kKRow + kVRow) <= 131072 ? NST_MAX : NW;
  static constexpr int kKOff = 0;
  static constexpr int kVOff = kKOff + NST * BK * kKRow;
  static constexpr int kKsOff = kVOff + NST * BK * kVRow;  // NST x BK f32 K scales
  static constexpr int kVsOff = kKsOff + NST * BK * 4;     // NST x BK f32 V scales
  // Per consumer warp: BK x 8 f32 P and 8 alphas. The prologue's query
  // buffers (RMAX x D f32, RMAX x D int8 codes, RMAX scales) live here first.
  static constexpr int kPWarp = BK * RMAX * 4 + RMAX * 4;
  static constexpr int kPOff = kVsOff + NST * BK * 4;
  static constexpr int kQf = kPOff, kQ8 = kQf + RMAX * W * 4, kQs = kQ8 + RMAX * W;
  static constexpr int kQBytes = RMAX * W * 5 + RMAX * 4;
  // kQSmem: the query fragments, [NWIN][MMA][3 terms][32 lanes] words x 2.
  static constexpr int kBqOff = kPOff + (NW * kPWarp > kQBytes ? NW * kPWarp : (kQBytes + 15) / 16 * 16);
  static constexpr int kBqBytes = kQSmem ? NWIN * MMA * 3 * 32 * 8 : 0;
  static constexpr int kBarOff = kBqOff + kBqBytes;
  static constexpr int kTotal = kBarOff + 2 * NST * 8 + 16;  // + the ticket
  // The merge's part weights, (NW + 1) x n_parts f32, reuse the ring.
  static constexpr int kMaxParts = kVOff / ((NW + 1) * 4);
  static_assert(kKRow % 8 == 0 && kVRow % 8 == 0, "rows come in 16-byte bulk copies or 8-byte cp.async");
  static_assert(NWIN * WB >= kKRow && (!kOverRead || kOffLadder), "the QK windows cover a K row");
  static_assert(!kOffLadder || (W == 80 || W == 96), "off the ladder: head dims 80 and 96");
  static_assert(!kDyn || W == 128 || W == 256 || W == 512,
                "head dims at run time: up to 128 (4 columns a lane), 256 (8) or 512 (16)");
};

// bf16x2 of the biased nibbles (u = n + 8) in bits 0-3 and 16-19 of t: the
// pair (128 + u) - 136 = n, exact.
__device__ __forceinline__ uint32_t nib_pair_to_bf16x2(uint32_t t) {
  uint32_t r;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;\n" : "=r"(r) : "r"((t & 0x000F000Fu) | 0x43004300u), "r"(0x3F803F80u),
      "r"(0xC308C308u));  // x * 1.0 - 136.0
  return r;
}

// The 2 MMA operand words of one K row that a thread takes for a window, from
// its LB bytes at p: s8 codes for the integer chain (a 4-bit row's 16 times
// too large, see the note), exact bf16 pairs for the float chain.
template <typename KT, bool kIntQK, int LB>
__device__ __forceinline__ void k_words(const unsigned char* p, uint32_t* w) {
  if constexpr (IsNib4<KT>::value && kIntQK) {
    uint32_t x[LB / 4];
    lds<LB>(p, x);
#pragma unroll
    for (int i = 0; i < LB / 4; ++i) w[i] = (x[i] << 4) & 0xF0F0F0F0u, w[LB / 4 + i] = x[i] & 0xF0F0F0F0u;
  } else if constexpr (IsNib4<KT>::value) {  // LB == 4: one packed word, 4 bf16 pairs
    uint32_t x[1];
    lds<4>(p, x);
    const uint32_t u = x[0] ^ 0x88888888u;
    const uint32_t t01 = __byte_perm(u, 0, 0x4140), t23 = __byte_perm(u, 0, 0x4342);  // bytes 0, 1 / 2, 3 at bits 0, 16
    w[0] = nib_pair_to_bf16x2(t01), w[1] = nib_pair_to_bf16x2(t23);
    w[2] = nib_pair_to_bf16x2(t01 >> 4), w[3] = nib_pair_to_bf16x2(t23 >> 4);
  } else if constexpr (kIntQK) {
    lds<LB>(p, w);
  } else if constexpr (sizeof(KT) == 1) {
    uint32_t x[2];
    lds<8>(p, x);
#pragma unroll
    for (int i = 0; i < 2; ++i) w[2 * i] = i8x2_to_bf16x2<0>(x[i]), w[2 * i + 1] = i8x2_to_bf16x2<2>(x[i]);
  } else {
    lds<LB>(p, w);
  }
}

// The paged cache's arguments (kExt 3 and 4): the tokens T, the pool's pages
// and page size (a power of two, log2 in page_shift), the table [B, width]
// of each sequence's physical pages. Converts to T, so that the kernel reads
// its tokens as it reads the multi-token kernels' int.
struct PagedExt {
  int q_tokens, n_pages, page_shift, width;
  const int* table;
  __device__ __forceinline__ operator int() const { return q_tokens; }
};

// The causal limits of a thread's two query rows in the multi-token kernels
// (kExt > 0): keys pos < lim, and in the window phase pos >= lo.
struct RowLimits {
  int lim[2], lo[2];
};
struct NoRowLimits {};

// ---------------------------------------------------------------------------
// The kernel. Grid: (n_splits, Hk * groups, B), groups = (H / Hk) / R.
//
// kExt 0: one query token a sequence (H query heads). kExt 1: T tokens
// (the single int of `ext`); H counts the rows T * Hk * g, KV head by KV
// head and token-major (row t * g + gh of a KV head, as the TPU kernel's
// r = t * g + gh), each row masked at its own limit len - (T - 1 - t), and
// `window` is the union band W + T - 1 that the walk covers (row t keeps
// pos >= len - window + t in the window phase). kExt 2: kExt 1 with INT8 PV
// on an int8 V. kExt 3 and 4: kExt 1 and 2 over the paged cache (k, v
// [Hk, n_pages, page, Dc], the scales [Hk, n_pages, page], `ext` a
// PagedExt, S the table's W * page rows a sequence): only the producer
// differs, forming each tile from one pair of bulk copies per page it
// touches. The multi-token kernels are all kMasks instances. Their
// code sits in `if constexpr (kExt ...)` branches and their extra argument
// in a parameter pack that is empty for kExt 0, so the single-token
// kernels compile from the same source as before.
// ---------------------------------------------------------------------------

template <int D, typename KT, typename VT, bool kIntQK, bool kMasks, int kExt = 0, typename... Ext>
__global__ void __launch_bounds__(NT) decode_kernel(
    const void* __restrict__ q, const KT* __restrict__ k, const VT* __restrict__ v,
    const float* __restrict__ k_scale, const float* __restrict__ v_scale, const int* __restrict__ lengths,
    float* __restrict__ part_acc, float* __restrict__ part_ml, int* __restrict__ tickets, void* __restrict__ o,
    float* __restrict__ lse, int H, int Hk, int S, int R, int n_splits, int chunk, int q_bf16, int out_code,
    int window, int sink, float sm_scale, float logit_cap, int head_dim, Ext... ext) {
  static_assert(kExt == 0 || (kMasks && sizeof...(Ext) == 1), "the multi-token kernels take masks and T");
  static_assert(kExt % 2 || kExt == 0 || std::is_same<VT, int8_t>::value, "INT8 PV takes an int8 V");
  constexpr bool kPaged = kExt >= 3;
  using C = Cfg<D, KT, VT, kIntQK>;
  constexpr int BK = C::BK, CPL = C::CPL, CG = C::CG, NCG = C::NCG, NST = C::NST;
  constexpr bool kVQuant = C::kVNib || sizeof(VT) == 1;  // per-token V scales
  // The head dim and the rows of this call (the instance's own but at run
  // time, kDyn). Rows lie at their own width in a stage laid out for W.
  const int dh = C::dim(head_dim);
  const typename C::Rows rw = C::rows(dh);

  extern __shared__ __align__(16) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + C::kBarOff);
  uint64_t* empty = full + NST;
  int* ticket_s = reinterpret_cast<int*>(empty + NST);
  float* ks_s = reinterpret_cast<float*>(smem + C::kKsOff);
  float* vs_s = reinterpret_cast<float*>(smem + C::kVsOff);

  const int split = blockIdx.x, b = blockIdx.z;
  const int groups = (H / Hk) / R;
  const int hk = blockIdx.y / groups;
  const int h0 = hk * (H / Hk) + (blockIdx.y % groups) * R;  // first query head of this CTA
  const int tid = threadIdx.x, warp = tid / 32, lane = tid & 31;
  const long long kh = (long long)b * Hk + hk;
  const int len = min(max(lengths[b], 0), S);
  // This split's keys: one range [a0, a1), or with a window two, [a0, a1)
  // of the sink phase and [b0, b1) of the window phase (the TPU kernel's
  // compacted walk). The splits cut a logical key axis: sink_keys keys of
  // the sink tiles, then 64-key tiles from ws, the window's first tile; a
  // logical key maps to itself in the sink phase and to ws + (l - sink_keys)
  // in the window phase. Each phase keeps only its visible keys, pos <
  // min(sink, len) and max(len - window, sink) <= pos < len, so the two
  // partition the visible keys and no row below the window is loaded.
  const int start = split * chunk;
  int a0 = start, a1 = min(start + chunk, len), b0 = 0, b1 = 0;
  if (kMasks && window > 0) {
    const int sink_keys = (sink + 63) / 64 * 64;
    const int lo_w = max(len - window, sink), ws = lo_w / 64 * 64;
    a1 = min(min(start + chunk, sink_keys), min(sink, len));
    b0 = max(ws + max(start - sink_keys, 0), lo_w);
    b1 = min(ws + start + chunk - sink_keys, len);
  }
  const int n_a = a1 > a0 ? (a1 - a0 + BK - 1) / BK : 0;
  const int n_tiles = n_a + (kMasks && b1 > b0 ? (b1 - b0 + BK - 1) / BK : 0);
  // Tile j's first key and the end of its range.
  auto tile_key0 = [&](int j) { return !kMasks || j < n_a ? a0 + j * BK : b0 + (j - n_a) * BK; };
  auto tile_end = [&](int j) { return !kMasks || j < n_a ? a1 : b1; };
  const int n_parts = n_splits * NW;

  if (tid == 0) {
    for (int s = 0; s < NST; ++s) {
      mbar_init(&full[s], 1 + 32);  // the bulk copies' thread, then every lane's scale copies
      mbar_init(&empty[s], 1);      // lane 0 of the warp that owns the tile
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp == NW) {
    if constexpr (kPaged) {
      // ---- producer warp over the paged cache: tile j's keys [key0, key0 + n)
      // are a run of each page they touch, one bulk copy of K and one of V a
      // run, the scales a key at a time. Lane l looks up the cache rows of
      // keys l and l + 32 before the stage frees (the table reads wait while
      // the ring is full, not after); lane 0 takes each run's first row by a
      // shuffle. No table entry past the tile is read ----
      static_assert(BK <= 64, "a lane holds the rows of two keys of a tile");
      const PagedExt pg{ext...};
      const int page = 1 << pg.page_shift;
      const int* tbl = pg.table + (long long)b * pg.width;
      const long long head_rows = (long long)hk * pg.n_pages * page;
      const unsigned char* kg = reinterpret_cast<const unsigned char*>(k) + head_rows * rw.k;
      const unsigned char* vg = reinterpret_cast<const unsigned char*>(v) + head_rows * rw.v;
      const float* ksg = k_scale + head_rows;
      const float* vsg = kVQuant ? v_scale + head_rows : nullptr;
      for (int j = 0; j < n_tiles; ++j) {
        const int st = j % NST, key0 = tile_key0(j), n = min(BK, tile_end(j) - key0);
        long long rows[2] = {0, 0};
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int key = key0 + lane + 32 * u;
          if (lane + 32 * u < n) rows[u] = (long long)__ldg(tbl + (key >> pg.page_shift)) * page + (key & (page - 1));
        }
        mbar_wait(&empty[st], ((j / NST) & 1) ^ 1);
        if (lane == 0) mbar_arrive_expect_tx(&full[st], n * rw.bulk());
        for (int i = 0; i < n;) {  // warp-uniform
          const int run = min(n - i, page - ((key0 + i) & (page - 1)));
          const long long row = __shfl_sync(0xffffffffu, i < 32 ? rows[0] : rows[1], i & 31);
          if (lane == 0) {
            if (rw.k_bulk)
              bulk_copy(smem + C::kKOff + st * BK * C::kKRow + i * rw.k, kg + row * rw.k, run * rw.k, &full[st]);
            if (rw.v_bulk)
              bulk_copy(smem + C::kVOff + st * BK * C::kVRow + i * rw.v, vg + row * rw.v, run * rw.v, &full[st]);
          }
          i += run;
        }
        if constexpr (C::kDyn || !C::kKBulk || !C::kVBulk) {
          // 40-byte rows (4-bit at d80) in 8-byte pieces, piece e of the tile
          // on lane e % 32, each key's row taken from the lane that looked it
          // up.
          auto pieces = [&](unsigned char* dst, const unsigned char* src, int row_bytes) {
            const int per = row_bytes / 8;
            for (int e0 = 0; e0 < n * per; e0 += 32) {  // warp-uniform
              const int e = e0 + lane, i = e / per;
              const long long r0 = __shfl_sync(0xffffffffu, rows[0], i & 31);
              const long long r1 = __shfl_sync(0xffffffffu, rows[1], i & 31);
              if (e < n * per)
                cp_async8(dst + i * row_bytes + 8 * (e % per), src + (i < 32 ? r0 : r1) * row_bytes + 8 * (e % per));
            }
          };
          if (!rw.k_bulk) pieces(smem + C::kKOff + st * BK * C::kKRow, kg, rw.k);
          if (!rw.v_bulk) pieces(smem + C::kVOff + st * BK * C::kVRow, vg, rw.v);
        }
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int i = lane + 32 * u;
          if (i < n) {
            cp_async4(ks_s + st * BK + i, ksg + rows[u]);
            if constexpr (kVQuant) cp_async4(vs_s + st * BK + i, vsg + rows[u]);
          }
        }
        cp_async_mbar_arrive(&full[st]);
      }
    } else {
      // ---- producer warp: stage j % NST takes tile j; nothing past its range is read ----
      const unsigned char* kg = reinterpret_cast<const unsigned char*>(k) + kh * S * rw.k;
      const unsigned char* vg = reinterpret_cast<const unsigned char*>(v) + kh * S * rw.v;
      const float* ksg = k_scale + kh * S;
      const float* vsg = kVQuant ? v_scale + kh * S : nullptr;
      for (int j = 0; j < n_tiles; ++j) {
        const int st = j % NST, key0 = tile_key0(j), n = min(BK, tile_end(j) - key0);
        mbar_wait(&empty[st], ((j / NST) & 1) ^ 1);
        if (lane == 0) {
          mbar_arrive_expect_tx(&full[st], n * rw.bulk());
          if (rw.k_bulk)
            bulk_copy(smem + C::kKOff + st * BK * C::kKRow, kg + (long long)key0 * rw.k, n * rw.k, &full[st]);
          if (rw.v_bulk)
            bulk_copy(smem + C::kVOff + st * BK * C::kVRow, vg + (long long)key0 * rw.v, n * rw.v, &full[st]);
        }
        if constexpr (C::kDyn || !C::kKBulk || !C::kVBulk) {
          // 40-byte rows (4-bit at d80; 8 bytes more than a 16-byte multiple
          // at run time): a tile of them starts 16-byte aligned only at an
          // even key, so that side comes in 8-byte pieces from every lane.
          if (!rw.k_bulk)
            for (int e = lane; e < n * rw.k / 8; e += 32)
              cp_async8(smem + C::kKOff + st * BK * C::kKRow + 8 * e, kg + (long long)key0 * rw.k + 8 * e);
          if (!rw.v_bulk)
            for (int e = lane; e < n * rw.v / 8; e += 32)
              cp_async8(smem + C::kVOff + st * BK * C::kVRow + 8 * e, vg + (long long)key0 * rw.v + 8 * e);
        }
        for (int i = lane; i < n; i += 32) {
          cp_async4(ks_s + st * BK + i, ksg + key0 + i);
          if constexpr (kVQuant) cp_async4(vs_s + st * BK + i, vsg + key0 + i);
        }
        cp_async_mbar_arrive(&full[st]);
      }
    }
  } else {
    // ---- consumer warps ----
    const int g = lane >> 2, t = lane & 3;
    // The CTA's query rows (zeros past R), then per row the int8 codes:
    // qa = fma(max|q|, 1/127, 1e-7), code = clamp(round_away(q / qa)).
    float* q_f = reinterpret_cast<float*>(smem + C::kQf);
    int8_t* q8 = reinterpret_cast<int8_t*>(smem + C::kQ8);
    float* qsc_s = reinterpret_cast<float*>(smem + C::kQs);
    // (Rows of W floats; at run time the columns past dh stay zero.)
    constexpr int W = C::W;
    for (int i = tid; i < RMAX * W; i += 32 * NW) {
      const int r = i / W;
      float x = 0.0f;
      if (r < R && (!C::kDyn || i % W < dh)) {
        const long long at = ((long long)b * H + h0 + r) * dh + i % W;
        x = q_bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(q)[at]) : static_cast<const float*>(q)[at];
      }
      q_f[i] = x;
    }
    named_bar_sync(1, 32 * NW);
    if constexpr (kIntQK) {
      for (int r = warp; r < RMAX; r += NW) {
        float amax = 0.0f;
        for (int d = lane; d < W; d += 32) amax = fmaxf(amax, fabsf(q_f[r * W + d]));
        const float sc = __fmaf_rn(warp_max(amax), 1.0f / 127.0f, 1e-7f);
        for (int d = lane; d < W; d += 32) {
          const float c = fminf(fmaxf(roundf(__fdiv_rn(q_f[r * W + d], sc)), -127.0f), 127.0f);
          q8[r * W + d] = static_cast<int8_t>(c);
        }
        if (lane == 0) qsc_s[r] = __fmul_rn(sc, sm_scale);
      }
      named_bar_sync(1, 32 * NW);
    }
    // B fragments of the query rows (n = g), in the dimension order of the
    // K operand words (Cfg::qdim): product c of window w takes words 2c and
    // 2c + 1. f32 queries: three bf16 terms.
    const int nqs = kIntQK || q_bf16 ? 1 : 3;
    uint32_t bq[C::kQSmem ? 1 : C::NWIN][C::MMA][kIntQK ? 1 : 3][2];
    // (kQSmem: the fragments go to shared memory, warp 0 writing them.)
    uint32_t* bq_s = reinterpret_cast<uint32_t*>(smem + C::kBqOff);
    auto put_bq = [&](int w, int u, int qs, uint32_t x) {
      if constexpr (C::kQSmem) {
        if (warp == 0) bq_s[(((w * C::MMA + u / 2) * 3 + qs) * 32 + lane) * 2 + u % 2] = x;
      } else {
        bq[w][u / 2][qs][u % 2] = x;
      }
    };
#pragma unroll
    for (int w = 0; w < C::NWIN; ++w)
#pragma unroll
      for (int u = 0; u < 2 * C::MMA; ++u) {
        const int d0 = C::qdim(w, t, u, dh);
        if constexpr (C::kOverRead || C::kDyn) {
          // A word past the K row's end meets zero query words.
          if (C::qbyte(w, t, u) >= rw.k) {
#pragma unroll
            for (int qs = 0; qs < (kIntQK ? 1 : 3); ++qs) put_bq(w, u, qs, 0u);
            continue;
          }
        }
        if constexpr (kIntQK) {
          put_bq(w, u, 0, *reinterpret_cast<const uint32_t*>(q8 + g * W + d0));
        } else {
          float rem[2] = {q_f[g * W + d0], q_f[g * W + d0 + 1]};
#pragma unroll
          for (int qs = 0; qs < 3; ++qs) {
            float tr[2];
#pragma unroll
            for (int i = 0; i < 2; ++i) {
              tr[i] = __bfloat162float(__float2bfloat16_rn(rem[i]));
              rem[i] -= tr[i];  // exact
            }
            put_bq(w, u, qs, pack_bf16x2(tr[0], tr[1]));
          }
        }
      }
    float qsc_r[2] = {sm_scale, sm_scale};
    if constexpr (kIntQK) qsc_r[0] = qsc_s[2 * t], qsc_r[1] = qsc_s[2 * t + 1];
    named_bar_sync(1, 32 * NW);  // the query buffers become P scratch

    float* p_s = reinterpret_cast<float*>(smem + C::kPOff + warp * C::kPWarp);  // [BK][RMAX]
    float* alpha_s = p_s + BK * RMAX;
    std::conditional_t<(kExt > 0), RowLimits, NoRowLimits> rl;
    if constexpr (kExt > 0) {
      const int n_tok = (ext + ...), grp = (H / Hk) / n_tok;
#pragma unroll
      for (int qi = 0; qi < 2; ++qi) {
        const int tok = ((blockIdx.y % groups) * R + 2 * t + qi) / grp;  // this row's query token
        rl.lim[qi] = len - (n_tok - 1) + tok;
        rl.lo[qi] = len - window + tok;
      }
    }
    float m_run[2] = {NEG_INIT, NEG_INIT}, l_run[2] = {0.0f, 0.0f};  // queries 2t, 2t + 1
    float acc[RMAX][CPL];  // rows x columns [CPL lane, CPL lane + CPL)
#pragma unroll
    for (int r = 0; r < RMAX; ++r)
#pragma unroll
      for (int c = 0; c < CPL; ++c) acc[r][c] = 0.0f;

    for (int j = warp; j < n_tiles; j += NW) {
      const int st = j % NST, key0 = tile_key0(j), nv = min(BK, tile_end(j) - key0);
      mbar_wait(&full[st], (j / NST) & 1);
      const unsigned char* Kt = smem + C::kKOff + st * BK * C::kKRow;
      const unsigned char* Vt = smem + C::kVOff + st * BK * C::kVRow;
      const float* ks_t = ks_s + st * BK;
      const float* vs_t = vs_s + st * BK;

      // ---- S = K Q^T: keys 16 mt + g (+ 8) x queries 2t, 2t + 1 ----
      float s[BK / 16][4];
#pragma unroll
      for (int mt = 0; mt < BK / 16; ++mt) {
        const unsigned char* r0 = Kt + (mt * 16 + g) * rw.k;
        const unsigned char* r1 = r0 + 8 * rw.k;
        if constexpr (kIntQK) {
          int c4[4] = {0, 0, 0, 0};
#pragma unroll
          for (int w = 0; w < C::NWIN; ++w) {
            if (C::kDyn && w * C::WB >= rw.k) break;  // the row's windows (warp-uniform)
            uint32_t w0[2 * C::MMA], w1[2 * C::MMA];
            k_words<KT, true, C::LB>(r0 + w * C::WB + t * C::LB, w0);
            k_words<KT, true, C::LB>(r1 + w * C::WB + t * C::LB, w1);
#pragma unroll
            for (int c = 0; c < C::MMA; ++c)
              mma_s8(c4, w0[2 * c], w1[2 * c], w0[2 * c + 1], w1[2 * c + 1], bq[w][c][0][0], bq[w][c][0][1]);
          }
#pragma unroll
          for (int e = 0; e < 4; ++e) s[mt][e] = (float)c4[e];  // |dot| < 2^24: exact
        } else {
          float c4[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
          for (int w = 0; w < C::NWIN; ++w) {
            if (C::kDyn && w * C::WB >= rw.k) break;  // the row's windows (warp-uniform)
            uint32_t w0[2 * C::MMA], w1[2 * C::MMA];  // 4 MMA elements of each row as bf16x2
            k_words<KT, false, C::LB>(r0 + w * C::WB + t * C::LB, w0);
            k_words<KT, false, C::LB>(r1 + w * C::WB + t * C::LB, w1);
#pragma unroll
            for (int c = 0; c < C::MMA; ++c)
#pragma unroll
              for (int qs = 0; qs < 3; ++qs)
                if (qs < nqs) {
                  if constexpr (C::kQSmem) {
                    const uint2 bb = reinterpret_cast<const uint2*>(bq_s)[((w * C::MMA + c) * 3 + qs) * 32 + lane];
                    mma_bf16(c4, w0[2 * c], w1[2 * c], w0[2 * c + 1], w1[2 * c + 1], bb.x, bb.y);
                  } else {
                    mma_bf16(c4, w0[2 * c], w1[2 * c], w0[2 * c + 1], w1[2 * c + 1], bq[w][c][qs][0],
                             bq[w][c][qs][1]);
                  }
                }
          }
#pragma unroll
          for (int e = 0; e < 4; ++e) s[mt][e] = c4[e];
        }
        if constexpr (C::kKNib && kIntQK) {
#pragma unroll
          for (int e = 0; e < 4; ++e) s[mt][e] *= 0.0625f;  // the codes came as 16 n: exact
        }
        if constexpr (kMasks) {
#pragma unroll
          for (int e = 0; e < 4; ++e)
            s[mt][e] = __fmul_rn(__fmul_rn(s[mt][e], qsc_r[e & 1]), ks_t[mt * 16 + g + 8 * (e >> 1)]);
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int kl = mt * 16 + g + 8 * (e >> 1);
            float x = __fmul_rn(s[mt][e], qsc_r[e & 1]);
            x = __fmul_rn(__fmul_rn(x, ks_t[kl]), LOG2E);
            s[mt][e] = kl < nv ? x : MASK_VALUE;
          }
        }
      }
      if constexpr (kMasks) {
        // The logit cap in natural units, then log2(e) and the mask.
        if (logit_cap > 0.0f) {
#pragma unroll
          for (int mt = 0; mt < BK / 16; ++mt)
#pragma unroll
            for (int e = 0; e < 4; ++e) s[mt][e] = __fmul_rn(logit_cap, tanhf(__fdiv_rn(s[mt][e], logit_cap)));
        }
        if constexpr (kExt > 0) {
          // Each row at its own causal limit, and in the window phase at its
          // own band start.
          const bool in_band = window > 0 && j >= n_a;
#pragma unroll
          for (int mt = 0; mt < BK / 16; ++mt)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int kl = mt * 16 + g + 8 * (e >> 1), pos = key0 + kl;
              const bool ok = kl < nv && pos < rl.lim[e & 1] && (!in_band || pos >= rl.lo[e & 1]);
              s[mt][e] = ok ? __fmul_rn(s[mt][e], LOG2E) : MASK_VALUE;
            }
        } else {
#pragma unroll
        for (int mt = 0; mt < BK / 16; ++mt)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            s[mt][e] = mt * 16 + g + 8 * (e >> 1) < nv ? __fmul_rn(s[mt][e], LOG2E) : MASK_VALUE;
        }
      }

      // ---- online softmax of queries 2t, 2t + 1 (a column's keys lie on the 8 lanes of one t) ----
      float alpha[2];
#pragma unroll
      for (int qi = 0; qi < 2; ++qi) {
        float mx = MASK_VALUE;
#pragma unroll
        for (int mt = 0; mt < BK / 16; ++mt) mx = fmaxf(mx, fmaxf(s[mt][qi], s[mt][qi + 2]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 8));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 16));
        const float m_new = fmaxf(m_run[qi], mx);
        alpha[qi] = exp2f(m_run[qi] - m_new);
        float sum = 0.0f;
#pragma unroll
        for (int mt = 0; mt < BK / 16; ++mt)
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            const float p = exp2f(s[mt][qi + 2 * hf] - m_new);
            s[mt][qi + 2 * hf] = p;
            sum += p;
          }
        sum += __shfl_xor_sync(0xffffffffu, sum, 4);
        sum += __shfl_xor_sync(0xffffffffu, sum, 8);
        sum += __shfl_xor_sync(0xffffffffu, sum, 16);
        l_run[qi] = alpha[qi] * l_run[qi] + sum;
        m_run[qi] = m_new;
      }
      // P (times an int8 V's scale) and alpha into the warp's scratch.
#pragma unroll
      for (int mt = 0; mt < BK / 16; ++mt)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int kl = mt * 16 + g + 8 * hf;
          float p0 = s[mt][2 * hf], p1 = s[mt][2 * hf + 1];
          if constexpr (kVQuant) {
            const float vsc = vs_t[kl];
            p0 = __fmul_rn(p0, vsc);
            p1 = __fmul_rn(p1, vsc);
          }
          store2(p_s + kl * RMAX + 2 * t, p0, p1);
        }
      if (g == 0) store2(alpha_s + 2 * t, alpha[0], alpha[1]);
      __syncwarp();

      if constexpr (kExt == 2 || kExt == 4) {
        // ---- INT8 PV: per query row, pa = fma(max p, 1/127, 1e-7) over the
        // tile and p8 = trunc(p / pa + 0.5) (the V scale is already in p);
        // acc = alpha acc + (p8 . V codes) pa, the product in s32 by dp4a ----
        // Lane: row pr, quarter pq of the tile's keys. Keys past nv hold
        // p = 0, so their codes are 0. Rows past R (zero query rows, p > 0)
        // carry codes that nothing reads: every use below is under r < R.
        constexpr int KQ = BK / 4;
        const int pr = lane & 7, pq = lane >> 3;
        float pv[KQ];
        float mx = 0.0f;
#pragma unroll
        for (int i = 0; i < KQ; ++i) {
          pv[i] = p_s[(pq * KQ + i) * RMAX + pr];
          mx = fmaxf(mx, pv[i]);
        }
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 8));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 16));
        const float pa = __fmaf_rn(mx, 1.0f / 127.0f, 1e-7f);
        __syncwarp();  // P is read; its codes [RMAX][BK] and the RMAX pa take its place
        unsigned char* p8_s = reinterpret_cast<unsigned char*>(p_s);
        float* pa_s = reinterpret_cast<float*>(p8_s + RMAX * BK);
#pragma unroll
        for (int i = 0; i < KQ; i += 4) {
          uint32_t w = 0;
#pragma unroll
          for (int e = 0; e < 4; ++e)
            w |= (uint32_t)__float2int_rz(__fadd_rn(__fdiv_rn(pv[i + e], pa), 0.5f)) << (8 * e);
          *reinterpret_cast<uint32_t*>(p8_s + pr * BK + pq * KQ + i) = w;
        }
        if (pq == 0) pa_s[pr] = pa;
        __syncwarp();
        // Four keys at a time: the lane's CG V columns of 4 rows, regrouped
        // into one word of 4 keys a column, against each row's word of codes;
        // one column group after the other.
#pragma unroll
        for (int cg = 0; cg < NCG; ++cg) {
        int acc_i[RMAX][CG];
#pragma unroll
        for (int r = 0; r < RMAX; ++r)
#pragma unroll
          for (int c = 0; c < CG; ++c) acc_i[r][c] = 0;
        // (Off the ladder and at run time an idle lane reads lane 0's columns; nothing keeps
        // what it sums.)
        const unsigned char* vcol = Vt + (C::kPartial && !C::pv_lane(lane, dh, cg) ? 0 : C::pv_col(lane, dh, cg));
#pragma unroll 4
        for (int k4 = 0; k4 < BK; k4 += 4) {
          uint32_t col[CG];
          if constexpr (CG == 8) {
            // d256: a key's 8 columns are two words; column c is byte c % 4
            // of word c / 4.
            uint32_t x[4][2];
#pragma unroll
            for (int e = 0; e < 4; ++e) lds<8>(vcol + (k4 + e) * rw.v, x[e]);
#pragma unroll
            for (int c = 0; c < CG; ++c) {
              const int wd = c >> 2;
              const uint32_t sel = (c & 3) | ((c & 3) + 4) << 4;
              col[c] = __byte_perm(__byte_perm(x[0][wd], x[1][wd], sel), __byte_perm(x[2][wd], x[3][wd], sel), 0x5410);
            }
          } else {
          uint32_t x[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) lds<CG>(vcol + (k4 + e) * rw.v, &x[e]);
#pragma unroll
          for (int c = 0; c < CG; ++c) {
            const uint32_t sel = c | (c + 4) << 4;  // byte c of the first word, then of the second
            col[c] = __byte_perm(__byte_perm(x[0], x[1], sel), __byte_perm(x[2], x[3], sel), 0x5410);
          }
          }
#pragma unroll
          for (int r = 0; r < RMAX; ++r) {
            if (r < R) {
              const int pw = *reinterpret_cast<const int*>(p8_s + r * BK + k4);
#pragma unroll
              for (int c = 0; c < CG; ++c) acc_i[r][c] = __dp4a((int)col[c], pw, acc_i[r][c]);
            }
          }
        }
#pragma unroll
        for (int r = 0; r < RMAX; ++r) {
          if (r < R) {
            const float a = alpha_s[r], pa_r = pa_s[r];
#pragma unroll
            for (int c = 0; c < CG; ++c)
              acc[r][cg * CG + c] = fmaf(acc[r][cg * CG + c], a, __fmul_rn((float)acc_i[r][c], pa_r));
          }
        }
        }
      } else {
      // ---- acc = alpha acc + P V on the CUDA cores, in f32 ----
#pragma unroll
      for (int r = 0; r < RMAX; ++r) {
        if (r < R) {
          const float a = alpha_s[r];
#pragma unroll
          for (int c = 0; c < CPL; ++c) acc[r][c] *= a;
        }
      }
      // A 4-bit V: lanes 0-15 take the low nibbles (columns lane * CPL ..),
      // lanes 16-31 the high ones of the same bytes.
      // Off the ladder and at run time an idle lane reads lane 0's columns; nothing keeps
      // what it sums.
      const int vl = C::kPartial && !C::pv_lane(lane, dh) ? 0 : lane;
      const unsigned char* vcol = Vt + (C::kVNib ? (vl & 15) * CG : vl * CG * (int)sizeof(VT));
      const int nib_shift = vl >= 16 ? 4 : 0;
      // Column group cg's bytes lie 16 CG cg (4-bit) or 32 CG cg elements
      // on; a lane idle in a group (at run time) reads group 0's.
      int vgrp[NCG];
#pragma unroll
      for (int cg = 0; cg < NCG; ++cg)
        vgrp[cg] = C::kPartial && !C::pv_lane(lane, dh, cg) ? 0
                   : C::kVNib                               ? 16 * CG * cg
                                                            : 32 * CG * cg * (int)sizeof(VT);
      auto pv_key = [&](int kl) {
        float vf[CPL];
#pragma unroll
        for (int cg = 0; cg < NCG; ++cg) v_cols<VT, CG>(vcol + vgrp[cg] + kl * rw.v, vf + cg * CG, nib_shift);
        const float4 pa = *reinterpret_cast<const float4*>(p_s + kl * RMAX);
        const float4 pb = R > 4 ? *reinterpret_cast<const float4*>(p_s + kl * RMAX + 4) : make_float4(0, 0, 0, 0);
        const float p[RMAX] = {pa.x, pa.y, pa.z, pa.w, pb.x, pb.y, pb.z, pb.w};
#pragma unroll
        for (int r = 0; r < RMAX; ++r) {
          if (r < R) {
#pragma unroll
            for (int c = 0; c < CPL; ++c) acc[r][c] = fmaf(p[r], vf[c], acc[r][c]);
          }
        }
      };
      if (nv == BK) {
#pragma unroll 8  // measured 6% faster than 4 on the int8 cache
        for (int kl = 0; kl < BK; ++kl) pv_key(kl);
      } else {
        for (int kl = 0; kl < nv; ++kl) pv_key(kl);
      }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[st]);
    }

    // ---- this warp's unnormalised (acc, m, l): part split * NW + warp ----
    const int part = split * NW + warp;
    if constexpr (C::kPartial) {
#pragma unroll
      for (int cg = 0; cg < NCG; ++cg) {
      if (C::pv_lane(lane, dh, cg)) {
#pragma unroll
        for (int r = 0; r < RMAX; ++r) {
          if (r < R) {
            float* dst = part_acc + (((long long)b * H + h0 + r) * n_parts + part) * dh + C::pv_col(lane, dh, cg);
#pragma unroll
            for (int c = 0; c < CG; ++c) dst[c] = acc[r][cg * CG + c];
          }
        }
      }
      }
    } else {
#pragma unroll
    for (int r = 0; r < RMAX; ++r) {
      if (r < R) {
        float* dst = part_acc + (((long long)b * H + h0 + r) * n_parts + part) * dh + lane * CPL;
#pragma unroll
        for (int c = 0; c < CPL; ++c) dst[c] = acc[r][c];
      }
    }
    }
    if (g == 0) {
#pragma unroll
      for (int qi = 0; qi < 2; ++qi) {
        const int r = 2 * t + qi;
        if (r < R) {
          float* ml = part_ml + (((long long)b * H + h0 + r) * n_parts + part) * 2;
          ml[0] = m_run[qi];
          ml[1] = l_run[qi];
        }
      }
    }
  }

  // ---- the last CTA of this (batch, KV head, rows) merges every part ----
  // One warp per row: its lanes take parts lane, lane + 32, ... for m and l
  // (warp reductions in a fixed order), leave each part's weight in shared
  // memory (the ring, idle now), then sum the weighted parts column by
  // column with the loads of all parts in flight.
  const int idx = blockIdx.z * gridDim.y + blockIdx.y;
  __threadfence();
  __syncthreads();
  if (tid == 0) *ticket_s = atomicAdd(&tickets[idx], 1);
  __syncthreads();
  if (*ticket_s != n_splits - 1) return;
  __threadfence();
  float* w_s = reinterpret_cast<float*>(smem) + warp * n_parts;
  for (int r = warp; r < R; r += NW + 1) {
    const long long row = (long long)b * H + h0 + r;
    const float* ml = part_ml + row * n_parts * 2;
    float m = NEG_INIT;
    for (int p = lane; p < n_parts; p += 32)
      if (__ldcg(ml + 2 * p + 1) > 0.0f) m = fmaxf(m, __ldcg(ml + 2 * p));
    m = warp_max(m);
    float l = 0.0f;
    for (int p = lane; p < n_parts; p += 32) {
      const float ls = __ldcg(ml + 2 * p + 1);
      const float w = ls > 0.0f ? exp2f(__ldcg(ml + 2 * p) - m) : 0.0f;  // an empty part has no weight
      l = fmaf(w, ls, l);
      w_s[p] = w;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) l += __shfl_xor_sync(0xffffffffu, l, o);
    __syncwarp();
    const float ls = l == 0.0f ? 1.0f : l;
    // Off the ladder and at run time the lanes past the row's columns redo lane 0's columns
    // and store nothing. (Column groups of CG, 32 CG apart, one after the
    // other.)
#pragma unroll 1
    for (int cg = 0; cg < NCG; ++cg) {
    const int col0 = 32 * CG * cg + lane * CG;
    const int mcol = C::kPartial && col0 >= dh ? 0 : col0;
    const float* pa = part_acc + row * n_parts * dh + mcol;
    float a[CG];
#pragma unroll
    for (int c = 0; c < CG; ++c) a[c] = 0.0f;
#pragma unroll 4
    for (int p = 0; p < n_parts; ++p) {
      const float w = w_s[p];
#pragma unroll
      for (int c = 0; c < CG; ++c) a[c] = fmaf(w, __ldcg(pa + (long long)p * dh + c), a[c]);
    }
#pragma unroll
    for (int c = 0; c < CG; ++c) {
      if (C::kPartial && col0 >= dh) break;
      const long long at = row * dh + col0 + c;
      const float out = __fdiv_rn(a[c], ls);
      if (out_code == 0)
        static_cast<float*>(o)[at] = out;
      else if (out_code == 1)
        static_cast<__nv_bfloat16*>(o)[at] = __float2bfloat16_rn(out);
      else
        static_cast<__half*>(o)[at] = __float2half_rn(out);
    }
    }
    if (lse && lane == 0) lse[row] = m + log2f(ls);
    __syncwarp();
  }
  if (tid == 0) tickets[idx] = 0;  // ready for the next call on the stream
}

// Runs op.run<D, KT, VT, kIntQK>() for the variant the bit widths name
// (16: bf16 rows, 8: int8 codes, 4: packed 4-bit codes).
template <int D, typename KT, bool kIntQK, typename Op>
int with_v(const Op& op, int v_bits) {
  switch (v_bits) {
    case 8: return op.template run<D, KT, int8_t, kIntQK>();
    case 4: return op.template run<D, KT, Nib4, kIntQK>();
    case 16: return op.template run<D, KT, __nv_bfloat16, kIntQK>();
    default: return (int)cudaErrorInvalidValue;
  }
}

template <int D, typename Op>
int with_k(const Op& op, int k_bits, int v_bits, int int_qk) {
  switch (k_bits) {
    case 8: return int_qk ? with_v<D, int8_t, true>(op, v_bits) : with_v<D, int8_t, false>(op, v_bits);
    case 4: return int_qk ? with_v<D, Nib4, true>(op, v_bits) : with_v<D, Nib4, false>(op, v_bits);
    case 16: return int_qk ? (int)cudaErrorInvalidValue : with_v<D, __nv_bfloat16, false>(op, v_bits);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename Op>
int with_variant(const Op& op, int D, int k_bits, int v_bits, int int_qk) {
  switch (D) {
    case 32: return with_k<32>(op, k_bits, v_bits, int_qk);
    case 64: return with_k<64>(op, k_bits, v_bits, int_qk);
    case 128: return with_k<128>(op, k_bits, v_bits, int_qk);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The head dims off the ladder (the d80_96 sources' instances).
template <typename Op>
int with_variant_d80_96(const Op& op, int D, int k_bits, int v_bits, int int_qk) {
  switch (D) {
    case 80: return with_k<80>(op, k_bits, v_bits, int_qk);
    case 96: return with_k<96>(op, k_bits, v_bits, int_qk);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The head dims taken at run time (the _dyn sources' instances): every
// multiple of 16 from 16 to 256, on the instance laid out for 128 (4
// columns a lane) or for 256 (8). The op carries the head dim (head_dim).
template <typename Op>
int with_variant_dyn(const Op& op, int D, int k_bits, int v_bits, int int_qk) {
  if (D < 16 || D > 256 || D % 16) return (int)cudaErrorInvalidValue;
  return D <= 128 ? with_k<kDynD | 128>(op, k_bits, v_bits, int_qk) : with_k<kDynD | 256>(op, k_bits, v_bits, int_qk);
}

// The head dims above 256 (the _dyn512 sources' instances): every multiple
// of 16 from 272 to 512, on the instance laid out for 512 (16 columns a
// lane in two groups of 8).
template <typename Op>
int with_variant_dyn512(const Op& op, int D, int k_bits, int v_bits, int int_qk) {
  if (D <= 256 || D > 512 || D % 16) return (int)cudaErrorInvalidValue;
  return with_k<kDynD | 512>(op, k_bits, v_bits, int_qk);
}


// The launch of one single-token variant (decode_attention.cu and, at
// head_dim 256, decode_attention_d256.cu).
struct Launch {
  const void* q;
  const float *ks, *vs;
  const void *k, *v;
  const int* lengths;
  float *part_acc, *part_ml;
  int* tickets;
  void* o;
  float* lse;
  int B, H, Hk, S, R, n_splits, chunk, q_bf16, out_code, window, sink;
  float sm_scale, logit_cap;
  cudaStream_t st;
  int head_dim = 0;  // the head dim of the instances that take it at run time

  template <int D, typename KT, typename VT, bool kIntQK>
  int run() const {
    constexpr int smem = Cfg<D, KT, VT, kIntQK>::kTotal;
    if (n_splits * NW > Cfg<D, KT, VT, kIntQK>::kMaxParts) return (int)cudaErrorInvalidValue;
    const bool masks = window > 0 || logit_cap > 0.0f;
    auto kern = masks ? decode_kernel<D, KT, VT, kIntQK, true> : decode_kernel<D, KT, VT, kIntQK, false>;
    const cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid(n_splits, Hk * ((H / Hk) / R), B);
    kern<<<grid, NT, smem, st>>>(q, static_cast<const KT*>(k), static_cast<const VT*>(v), ks, vs, lengths, part_acc,
                                 part_ml, tickets, o, lse, H, Hk, S, R, n_splits, chunk, q_bf16, out_code, window,
                                 sink, sm_scale, logit_cap, head_dim);
    return (int)cudaGetLastError();
  }
};

// How many CTAs of one variant an SM holds at once.
struct Occupancy {
  int* ctas_per_sm;
  bool masks;

  template <int D, typename KT, typename VT, bool kIntQK>
  int run() const {
    constexpr int smem = Cfg<D, KT, VT, kIntQK>::kTotal;
    auto kern = masks ? decode_kernel<D, KT, VT, kIntQK, true> : decode_kernel<D, KT, VT, kIntQK, false>;
    cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err == cudaSuccess) err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(ctas_per_sm, kern, NT, smem);
    return (int)err;
  }
};

// The paged launches (decode_attention_paged.cu and, at head_dim 256,
// decode_attention_paged_d256.cu): kExt 3, or with int_pv kExt 4, on the
// same terms as multi_kernel's.
template <int D, typename KT, typename VT, bool kIntQK>
auto paged_kernel(int int_pv, cudaError_t* err) {
  auto kern = decode_kernel<D, KT, VT, kIntQK, true, 3, PagedExt>;
  if (int_pv) {
    if constexpr (std::is_same<VT, int8_t>::value && (kIntQK || std::is_same<KT, __nv_bfloat16>::value)) {
      kern = decode_kernel<D, KT, VT, kIntQK, true, 4, PagedExt>;
    } else {
      *err = cudaErrorInvalidValue;
      return kern;
    }
  }
  *err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, Cfg<D, KT, VT, kIntQK>::kTotal);
  return kern;
}

struct LaunchPaged {
  const void* q;
  const float *ks, *vs;
  const void *k, *v;
  const int* lengths;
  float *part_acc, *part_ml;
  int* tickets;
  void* o;
  float* lse;
  int B, H, Hk, S, R, n_splits, chunk, q_bf16, out_code, window, sink, int_pv;
  PagedExt pg;
  float sm_scale, logit_cap;
  cudaStream_t st;
  int head_dim = 0;  // as Launch's

  template <int D, typename KT, typename VT, bool kIntQK>
  int run() const {
    using C = Cfg<D, KT, VT, kIntQK>;
    if (n_splits * NW > C::kMaxParts) return (int)cudaErrorInvalidValue;
    cudaError_t err;
    const auto kern = paged_kernel<D, KT, VT, kIntQK>(int_pv, &err);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid(n_splits, Hk * ((H / Hk) / R), B);
    kern<<<grid, NT, C::kTotal, st>>>(q, static_cast<const KT*>(k), static_cast<const VT*>(v), ks, vs, lengths,
                                      part_acc, part_ml, tickets, o, lse, H, Hk, S, R, n_splits, chunk, q_bf16,
                                      out_code, window, sink, sm_scale, logit_cap, head_dim, pg);
    return (int)cudaGetLastError();
  }
};

struct OccupancyPaged {
  int* ctas_per_sm;
  int int_pv;

  template <int D, typename KT, typename VT, bool kIntQK>
  int run() const {
    cudaError_t err;
    const auto kern = paged_kernel<D, KT, VT, kIntQK>(int_pv, &err);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(ctas_per_sm, kern, NT, Cfg<D, KT, VT, kIntQK>::kTotal);
    return (int)err;
  }
};

// Checks a paged call's arguments (lowbit_decode_attn_paged and its d256
// twin) and fills its launch; returns cudaErrorInvalidValue for what it does
// not take.
inline int paged_launch(LaunchPaged* l, const void* q, const void* k, const void* v, const float* k_scale,
                        const float* v_scale, const int* lengths, const int* table, float* part_acc, float* part_ml,
                        int* tickets, void* o, float* lse, int B, int H, int Hk, int S, int R, int q_bf16,
                        int out_code, int n_splits, int chunk, int window, int sink, int q_tokens, int int_pv,
                        int n_pages, int page, int width, int v_bits, float sm_scale, float logit_cap, void* stream) {
  int shift = 0;
  while ((1 << shift) < page) ++shift;
  if (R < 1 || R > RMAX || (H / Hk) % R || q_tokens < 1 || (H / Hk) % q_tokens || chunk % 64 || out_code < 0 ||
      out_code > 2 || n_splits < 1 || window < 0 || sink < 0 || logit_cap < 0.0f || (int_pv && v_bits != 8) ||
      page < 1 || (1 << shift) != page || width < 1 || S != width * page || n_pages < 1 || table == nullptr)
    return (int)cudaErrorInvalidValue;
  *l = LaunchPaged{q,        k_scale, v_scale, k,        v,      lengths, part_acc, part_ml,
                   tickets,  o,       lse,     B,        H,      Hk,      S,        R,
                   n_splits, chunk,   q_bf16,  out_code, window, window > 0 ? sink : 0, int_pv,
                   PagedExt{q_tokens, n_pages, shift, width, table},
                   sm_scale, logit_cap, static_cast<cudaStream_t>(stream)};
  return 0;
}

// The multi-token launches (decode_attention_multi.cu and, at head_dim 256,
// decode_attention_multi_d256.cu). The multi-token instance a call takes, its dynamic shared memory allowed:
// kExt 1, or with int_pv kExt 2 (INT8 PV), which exists for an int8 V with K
// on the integer chain or a bf16 K (which has no integer chain). *err is
// cudaErrorInvalidValue where there is no such instance.
template <int D, typename KT, typename VT, bool kIntQK>
auto multi_kernel(int int_pv, cudaError_t* err) {
  auto kern = decode_kernel<D, KT, VT, kIntQK, true, 1, int>;
  if (int_pv) {
    if constexpr (std::is_same<VT, int8_t>::value && (kIntQK || std::is_same<KT, __nv_bfloat16>::value)) {
      kern = decode_kernel<D, KT, VT, kIntQK, true, 2, int>;
    } else {
      *err = cudaErrorInvalidValue;
      return kern;
    }
  }
  *err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, Cfg<D, KT, VT, kIntQK>::kTotal);
  return kern;
}

struct LaunchMulti {
  const void* q;
  const float *ks, *vs;
  const void *k, *v;
  const int* lengths;
  float *part_acc, *part_ml;
  int* tickets;
  void* o;
  float* lse;
  int B, H, Hk, S, R, n_splits, chunk, q_bf16, out_code, window, sink, q_tokens, int_pv;
  float sm_scale, logit_cap;
  cudaStream_t st;
  int head_dim = 0;  // as Launch's

  template <int D, typename KT, typename VT, bool kIntQK>
  int run() const {
    using C = Cfg<D, KT, VT, kIntQK>;
    if (n_splits * NW > C::kMaxParts) return (int)cudaErrorInvalidValue;
    cudaError_t err;
    const auto kern = multi_kernel<D, KT, VT, kIntQK>(int_pv, &err);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid(n_splits, Hk * ((H / Hk) / R), B);
    kern<<<grid, NT, C::kTotal, st>>>(q, static_cast<const KT*>(k), static_cast<const VT*>(v), ks, vs, lengths,
                                      part_acc, part_ml, tickets, o, lse, H, Hk, S, R, n_splits, chunk, q_bf16,
                                      out_code, window, sink, sm_scale, logit_cap, head_dim, q_tokens);
    return (int)cudaGetLastError();
  }
};

struct OccupancyMulti {
  int* ctas_per_sm;
  int int_pv;

  template <int D, typename KT, typename VT, bool kIntQK>
  int run() const {
    cudaError_t err;
    const auto kern = multi_kernel<D, KT, VT, kIntQK>(int_pv, &err);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(ctas_per_sm, kern, NT, Cfg<D, KT, VT, kIntQK>::kTotal);
    return (int)err;
  }
};

}  // namespace
