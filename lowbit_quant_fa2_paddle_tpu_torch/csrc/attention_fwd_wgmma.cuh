// Kernel A's device code and launch, shared by its instances:
// attention_fwd_wgmma.cu (head dims 64 and 128, and the one C entry),
// attention_fwd_wgmma_bias.cu (the bias at 64 and 128),
// attention_fwd_wgmma_pv32.cu (fp32 PV at 64 and 128),
// attention_fwd_wgmma_pv32_d256.cu (fp32 PV at 256),
// attention_fwd_wgmma_d256.cu (head_dim 256, every other mode) and
// attention_fwd_wgmma_d512.cu / attention_fwd_wgmma_d512_masked.cu (head_dim
// 512 without and with masks or a bias). The design note is in
// attention_fwd_wgmma.cu.

#pragma once

#include <climits>
#include <type_traits>

#include "sm90.cuh"

// One call of the C entry lowbit_attn_fwd_wgmma, its arguments as it takes
// them (attention_fwd_wgmma.cu documents them).
struct AttnFwdCall {
  const void *q, *k, *v;
  const float *q_scale, *k_scale, *v_scale, *v_mean;
  const int *q_seg, *kv_seg;
  const float* bias;
  void* o;
  float* lse;
  int B, H, Hk, Sq, Sk, D, q_mode, k_bits, v_mode, out_f32, causal, window, sink, q_offset, bias_rows, pv32;
  float sm_scale_log2e, logit_cap2;
  cudaStream_t stream;
};
// The instances of the other sources, which the C entry routes a checked
// call to: D 256 without fp32 PV (attention_fwd_wgmma_d256.cu); fp32 PV at
// D 64/128 (attention_fwd_wgmma_pv32.cu) and at 256
// (attention_fwd_wgmma_pv32_d256.cu); a bias at D 64/128 without fp32 PV
// (attention_fwd_wgmma_bias.cu).
int attn_fwd_d256(const AttnFwdCall& c);
int attn_fwd_pv32(const AttnFwdCall& c);
int attn_fwd_pv32_d256(const AttnFwdCall& c);
int attn_fwd_bias(const AttnFwdCall& c);
int attn_fwd_d512(const AttnFwdCall& c);
int attn_fwd_d512_masked(const AttnFwdCall& c);

namespace {

using namespace sm90;

// Keys per KV tile: 128, or 64 at d256 and d512 (the registers of a 64 x
// 256 O accumulator beside S; two stages of bf16 K and V beside its Q tile)
// and with fp32 PV (V's three bf16 terms, 6 bytes an element in the ring).
template <int D, bool kPV32 = false>
constexpr int kBKV = D >= 256 || kPV32 ? 64 : 128;
// Consumer warpgroups per CTA, each owning 64 query rows: three at d64 (more
// softmax warps to hide its latency), two at d128 and d256 (the registers of
// the O accumulator), and two at d64 with fp32 PV (P's three fragments). At
// d512 the two share 64 rows (kCS).
template <int D, bool kPV32 = false>
constexpr int kNWG = D == 64 && !kPV32 ? 3 : 2;
// Warpgroups that split one 64-row block's O by columns: 2 at d512, each
// owning 256 columns (a 64 x 512 f32 O is 256 registers a thread, above
// the 255 a thread can have), each computing the whole S itself and the
// same softmax from it; 1 below.
template <int D>
constexpr int kCS = D > 256 ? 2 : 1;
constexpr float MASK_VALUE = (float)(-0.7 * 3.4028234663852886e38);
constexpr float NEG_INIT = -1e30f;
constexpr float LOG2_127 = 6.9886846867721655f;
// f32(log2 e): a bias in natural-log units times this, rounded once
// (__fmul_rn), is the f32 product the TPU launcher takes to base 2.
constexpr float LOG2E = 1.4426950408889634f;
// floor(P + P8_BIAS) = trunc(bf16(P + 0.5)) for bf16 P in [0, 128].
constexpr float P8_BIAS = 0.501953125f;
// Named barriers: 1 .. NWG order the consumer warpgroups' products, NWG + 1
// .. 2 NWG close each one's Q prologue (0 is __syncthreads).
constexpr int kBarTurn = 1;

enum QMode { Q_INT8 = 0, Q_FUSED_BF16 = 1, Q_FUSED_F32 = 2, Q_FP = 3 };

struct Args {
  const void* q;
  const float* q_scale;
  const float* k_scale;
  const float* v_scale;
  const float* v_mean;
  void* o;
  float* lse;
  int H, Hk, Sq, Sk, causal, q_mode, k_bits, v_int8, out_f32;  // v_int8: INT8 V codes (bf16 or INT8 PV)
  float sm_scale_log2e;
};

// Args with the masks: the kMasks kernels take these, the others Args alone,
// so that their parameters, and with them their code, are those they had
// before masks.
struct MaskedArgs : Args {
  const int* q_seg;   // [B, Sq] segment ids, or null
  const int* kv_seg;  // [B, Sk], with q_seg
  int window, sink, q_offset;  // window 0: none; sink only under a window; q_offset shifts q positions
  float logit_cap2;  // cap * log2(e), 0: none
};
// MaskedArgs with the bias: the kBias kernels take these (a template half
// of the masked kernels, as the masks are of the others).
struct BiasArgs : MaskedArgs {
  const float* bias;  // [B, H, bias_rows, Sk] f32 in natural-log units, or null
  int bias_rows;      // 1: a per-key vector; Sq: a full matrix
};
template <bool kMasks, bool kBias = false>
using ArgsOf = typename std::conditional<kBias, BiasArgs, typename std::conditional<kMasks, MaskedArgs, Args>::type>::type;

// Shared memory: STAGES K tiles, STAGES V tiles, the Q tile (all 1024-byte
// aligned), with kStaged the STAGES staging tiles of packed K and of INT8 V,
// then STAGES K-scale tiles (INT8 QK), STAGES tiles of the keys' segment
// ids (kMasks) and STAGES tiles of a bias vector (kBias, without fp32 PV,
// whose bf16 d128 kernel has no 2 KB to spare), the Q row scales and the
// mbarriers. The fp kernels with masks drop the Q row scales they never
// read, so their stage counts stay.
template <int D, bool kInt8, bool kStaged, bool kMasks, bool kPV32 = false, bool kBias = false>
struct Layout {
  static constexpr int BKV = kBKV<D, kPV32>;
  static constexpr int BQ = 64 * kNWG<D, kPV32> / kCS<D>;  // query rows per CTA
  // Columns of a V row in shared memory: D, or with fp32 PV its three bf16
  // terms V1 | V2 | V3.
  static constexpr int kVCols = kPV32 ? 3 * D : D;
  static constexpr int kRowBytes = D * (kInt8 ? 1 : 2);  // bytes of a Q/K row
  static constexpr int kSw = kRowBytes >= 128 ? 128 : 64;  // swizzle width = bytes per row of a column block
  static constexpr int kQBytes = BQ * kRowBytes;  // Q, NWG x 64 rows
  static constexpr int kKBytes = BKV * kRowBytes;
  static constexpr int kVBytes = BKV * kVCols * 2;
  static constexpr int kPBytes = kStaged && kInt8 ? BKV * D / 2 : 0;  // packed K as loaded (INT4 at most)
  static constexpr int kV8Bytes = kStaged && !kPV32 ? BKV * D : 0;     // INT8 V as loaded
  static constexpr int kSBytes = kInt8 ? BKV * 4 : 0;
  static constexpr int kGBytes = kMasks ? BKV * 4 : 0;  // segment ids of the tile's keys
  static constexpr int kBBytes = kBias && !kPV32 ? BKV * 4 : 0;  // a bias vector's values at the tile's keys
  static constexpr int kQsBytes = kInt8 || !kMasks ? BQ * 4 : 0;
  static constexpr int kStageBytes = kKBytes + kVBytes + kPBytes + kV8Bytes + kSBytes + kGBytes + kBBytes;
  static constexpr int kFixed = kQBytes + kQsBytes + 9 * 8 + 1024;  // + barriers + alignment slack
  // (One stage only for fp32 PV at d256: 16-32 KB of K and 96 KB of V's
  // terms a stage beside a 32-64 KB Q tile.)
  static constexpr int kStages = 3 * kStageBytes + kFixed <= 232448 ? 3 : 2 * kStageBytes + kFixed <= 232448 ? 2 : 1;
  static constexpr int kKOff = 0;
  static constexpr int kVOff = kKOff + kStages * kKBytes;
  static constexpr int kQOff = kVOff + kStages * kVBytes;
  static constexpr int kPOff = kQOff + kQBytes;
  static constexpr int kV8Off = kPOff + kStages * kPBytes;
  static constexpr int kSOff = kV8Off + kStages * kV8Bytes;
  static constexpr int kGOff = kSOff + kStages * kSBytes;
  static constexpr int kBOff = kGOff + kStages * kGBytes;
  static constexpr int kQsOff = kBOff + kStages * kBBytes;
  static constexpr int kBarOff = kQsOff + kQsBytes;
  static constexpr int kTotal = kBarOff + 3 * kStages * 8;
};

// floor(a / b) for b > 0 (q_offset may be negative).
__device__ __forceinline__ int floor_div(int a, int b) { return a >= 0 ? a / b : -((-a + b - 1) / b); }

// A kMasks kernel's q block: its masks and its visit list (the TPU kernel's
// _tri_schedule). Causal, the tiles from j_lo up to the block's diagonal,
// after the n_sink tiles below j_lo that hold sink keys; an empty band keeps
// one (fully masked) visit.
struct Visits {
  bool segs;
  int window, sink, q_off;
  int j_lo, n_sink, n;  // the band's first tile, the sink tiles before it, the visits
  // The KV tile of visit i.
  __device__ __forceinline__ int tile(int i) const { return i < n_sink ? i : j_lo + i - n_sink; }
};
struct NoMasks {};

template <int BQ, int BKV>
__device__ __forceinline__ Visits visits_of(const MaskedArgs& a, bool causal, int q0, int nkv, int n_tiles) {
  Visits v{a.kv_seg != nullptr, a.window, a.sink, a.q_offset, 0, 0, n_tiles};
  if (causal) {
    int j_hi = min(nkv, floor_div(q0 + BQ + v.q_off + BKV - 1, BKV));
    if (v.window > 0) v.j_lo = max(0, floor_div(q0 + v.q_off - v.window + 1, BKV));
    if (v.j_lo >= j_hi) {
      j_hi = max(j_hi, 1);
      v.j_lo = j_hi - 1;
    }
    if (v.window > 0 && v.sink > 0) v.n_sink = min((v.sink + BKV - 1) / BKV, v.j_lo);
    v.n = v.n_sink + j_hi - v.j_lo;
  }
  return v;
}

// Per-byte sign extension of the 4-bit (2-bit) field at the bottom of each
// byte of w.
__device__ __forceinline__ uint32_t sext4(uint32_t w) { return __vsub4((w & 0x0F0F0F0Fu) ^ 0x08080808u, 0x08080808u); }
__device__ __forceinline__ uint32_t sext2(uint32_t w) { return __vsub4((w & 0x03030303u) ^ 0x02020202u, 0x02020202u); }

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Widen one staged tile of packed K (BITS 4 or 2) into the int8 K tile of
// swizzled rows of SW bytes, one of 128 producer threads: code p of byte i
// of a packed row goes to column p * (row bytes) + i. Rows wider than SW
// (d256) lie in D / SW column blocks of BKV rows.
template <int BITS, int D, int SW, int BKV>
__device__ __forceinline__ void widen_k(const uint32_t* src, unsigned char* Kt, int ptid) {
  constexpr int RB = D * BITS / 8, WPR = RB / 4;
  if constexpr (D > SW) {
    // Four words at a time: the producer's 40 registers spill a whole
    // unrolled tile at d256.
#pragma unroll 4
    for (int i = 0; i < BKV * WPR / 128; ++i) {
      const int w = ptid + 128 * i;
      const int r = w / WPR, col = 4 * (w % WPR);
      const uint32_t x = src[w];
#pragma unroll
      for (int p = 0; p < 8 / BITS; ++p)
        *reinterpret_cast<uint32_t*>(Kt + (p * RB + col) / SW * BKV * SW +
                                     swizzle_offset<SW>(r * SW + (p * RB + col) % SW)) =
            BITS == 4 ? sext4(x >> (4 * p)) : sext2(x >> (2 * p));
    }
  } else {
#pragma unroll
  for (int i = 0; i < BKV * WPR / 128; ++i) {
    const int w = ptid + 128 * i;
    const int r = w / WPR, col = 4 * (w % WPR);
    const uint32_t x = src[w];
#pragma unroll
    for (int p = 0; p < 8 / BITS; ++p)
      *reinterpret_cast<uint32_t*>(Kt + swizzle_offset<SW>(r * SW + p * RB + col)) =
          BITS == 4 ? sext4(x >> (4 * p)) : sext2(x >> (2 * p));
  }
  }
}

// Widen one staged tile of INT8 V codes into the bf16 V tile (64-column
// halves of swizzled 128-byte rows), one of 128 producer threads.
template <int D, int BKV>
__device__ __forceinline__ void widen_v(const uint2* src, unsigned char* Vt, int ptid) {
  if constexpr (D >= 256) {
    // Four 8-byte groups at a time (as widen_k at d256).
#pragma unroll 4
    for (int i = 0; i < BKV * D / 8 / 128; ++i) {
      const int w = ptid + 128 * i;
      const int r = w / (D / 8), col = 8 * (w % (D / 8));
      const uint2 x = src[w];
      *reinterpret_cast<uint4*>(Vt + (col / 64) * BKV * 128 + swizzle_offset<128>(r * 128 + (col % 64) * 2)) =
          make_uint4(i8x2_to_bf16x2<0>(x.x), i8x2_to_bf16x2<2>(x.x), i8x2_to_bf16x2<0>(x.y), i8x2_to_bf16x2<2>(x.y));
    }
  } else {
#pragma unroll
  for (int i = 0; i < BKV * D / 8 / 128; ++i) {
    const int w = ptid + 128 * i;
    const int r = w / (D / 8), col = 8 * (w % (D / 8));
    const uint2 x = src[w];
    *reinterpret_cast<uint4*>(Vt + (col / 64) * BKV * 128 + swizzle_offset<128>(r * 128 + (col % 64) * 2)) =
        make_uint4(i8x2_to_bf16x2<0>(x.x), i8x2_to_bf16x2<2>(x.x), i8x2_to_bf16x2<0>(x.y), i8x2_to_bf16x2<2>(x.y));
  }
  }
}

// Rewrite one staged tile of INT8 V codes ([BKV keys][D] bytes) as V^T in
// the V tile's place: row d of BKV bytes (BKV-byte swizzle), byte 16 hc + 4 t
// + i holding key 16 hc + 8 (i >> 1) + 2 t + (i & 1), one of 128 producer
// threads. A unit is 4 columns x 16 keys: four 4-byte loads per slot group
// t, byte permutes, and four 4-byte stores; the order of the rows and slot
// groups rotates with the thread, so the stores of a warp fall on 32 banks.
template <int D, int BKV>
__device__ __forceinline__ void transpose_v(const unsigned char* src, unsigned char* Vt, int ptid) {
  constexpr int NDQ = D / 4;
  const int tr = (ptid >> 3) & 3;
#pragma unroll 1
  for (int u = ptid; u < NDQ * (BKV / 16); u += 128) {
    const int dq = u % NDQ, hc = u / NDQ, rot = (dq >> 1) & 3;
#pragma unroll
    for (int tt = 0; tt < 4; ++tt) {
      const int t = (tt + tr) & 3;
      const unsigned char* s0 = src + (16 * hc + 2 * t) * D + 4 * dq;
      const uint32_t i0 = *reinterpret_cast<const uint32_t*>(s0), i1 = *reinterpret_cast<const uint32_t*>(s0 + D);
      const uint32_t i2 = *reinterpret_cast<const uint32_t*>(s0 + 8 * D);
      const uint32_t i3 = *reinterpret_cast<const uint32_t*>(s0 + 9 * D);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int r = (k + rot) & 3;
        const uint32_t sel = (uint32_t)(r | ((r + 4) << 4));
        *reinterpret_cast<uint32_t*>(Vt + swizzle_offset<BKV>((4 * dq + r) * BKV + 16 * hc + 4 * t)) =
            __byte_perm(__byte_perm(i0, i1, sel), __byte_perm(i2, i3, sel), 0x5410);
      }
    }
  }
}

template <int D, bool kInt8, bool kStaged, bool kPV8, bool kMasks, bool kPV32 = false, bool kBias = false>
__global__ void __launch_bounds__(128 * (kNWG<D, kPV32> + 1), 1)
    attn_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap k_map, const __grid_constant__ CUtensorMap v_map,
                          const ArgsOf<kMasks, kBias> args) {
  static_assert(!kPV32 || (kMasks && kBias && !kPV8), "fp32 PV runs in the bias kernels, without INT8 PV");
  static_assert(!kBias || kMasks, "the bias kernels are masked kernels");
  using L = Layout<D, kInt8, kStaged, kMasks, kPV32, kBias>;
  constexpr int S = L::kStages;
  constexpr int kSw = L::kSw;
  using SAcc = typename std::conditional<kInt8, int, float>::type;
  constexpr int NWG = kNWG<D, kPV32>, BQ = L::BQ, BKV = L::BKV;
  // O columns a consumer warpgroup owns (kCS warpgroups share 64 rows).
  constexpr int CS = kCS<D>, DV = D / CS;
  static_assert(CS == 1 || !kPV32, "fp32 PV has no column split");
  // INT8 PV at d256 (and on d512's 256-column halves) multiplies in two
  // halves of 128 columns, one after the other: a 64 x 256 s32 tile beside
  // the f32 O would not fit the registers.
  constexpr bool kSplitPV8 = kPV8 && DV == 256;
  // fp32 PV sums each tile's products in 64-column blocks, one block waited
  // for and added to O before the next (pv32_blocks below), so PV and S take
  // turns. A ring of one stage (d512's bf16 QK and staged modes) also runs
  // PV before the next tile's S: the next tile lands in the stage PV reads.
  constexpr bool kSerialPV = kSplitPV8 || kPV32 || S == 1;

  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::kBarOff);
  uint64_t* empty = full + S;
  uint64_t* staged = empty + S;  // the staging ring's TMA loads (kStaged)

  const int H = args.H, Hk = args.Hk, Sq = args.Sq, Sk = args.Sk;
  const bool causal = args.causal != 0;
  const int nq = (Sq + BQ - 1) / BQ;
  const int qb = causal ? nq - 1 - (int)blockIdx.x : (int)blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kh = b * Hk + h / (H / Hk);
  const int q0 = qb * BQ;
  const int nkv = (Sk + BKV - 1) / BKV;
  // The KV tiles this block visits, in order: tiles 0 .. n_tiles - 1, or
  // with kMasks n_tiles visits of its Visits list, which the producer and
  // the consumers walk alike, the ring's stage and phase by the visit. The
  // masks' state lives only in the kMasks kernels (if constexpr), so the
  // others compile to the code they had before masks.
  typename std::conditional<kMasks, int, const int>::type n_tiles =
      causal ? min(nkv, (q0 + BQ + BKV - 1) / BKV) : nkv;
  typename std::conditional<kMasks, Visits, NoMasks>::type vis;
  if constexpr (kMasks) {
    vis = visits_of<BQ, BKV>(args, causal, q0, nkv, n_tiles);
    n_tiles = vis.n;
  }
  // A bias vector (kBias, without fp32 PV) rides in the ring: the producer
  // copies each tile's values beside its K scales.
  typename std::conditional<(L::kBBytes > 0), bool, const bool>::type vbias = false;
  if constexpr (L::kBBytes > 0) vbias = args.bias != nullptr && args.bias_rows == 1;

  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      // Arrivals: the TMA thread's, then those of the threads that copy K
      // scales and segment ids (the first warp) or widen staged tiles (the
      // warpgroup).
      if constexpr (L::kBBytes > 0)
        mbar_init(&full[s], kStaged ? 1 + 128 : kInt8 || vis.segs || vbias ? 1 + 32 : 1);
      else if constexpr (kMasks)
        mbar_init(&full[s], kStaged ? 1 + 128 : kInt8 || vis.segs ? 1 + 32 : 1);
      else
        mbar_init(&full[s], kStaged ? 1 + 128 : kInt8 ? 1 + 32 : 1);
      mbar_init(&empty[s], 4 * NWG);  // lane 0 of each consumer warp
      mbar_init(&staged[s], 1);
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == NWG) {
    // ---- producer ----
    setmaxnreg_dec<NWG == 2 ? 40 : 32>();
    const int ptid = threadIdx.x - 128 * NWG;
    const float* ksg = kInt8 ? args.k_scale + (long long)kh * Sk : nullptr;
    // Packed K (k_bits 4 or 2) and INT8 V come through the staging ring.
    const int k_bits = args.k_bits;
    const bool k_packed = kStaged && kInt8 && k_bits < 8, v_int8 = kStaged && !kPV32 && args.v_int8 != 0;
    const int pk_row = D * k_bits / 8;  // bytes of a packed K row
    if (ptid == 0) {
      tma_prefetch_desc(&k_map);
      tma_prefetch_desc(&v_map);
    }
    if (kStaged || ptid < 32) {
      for (int j = 0; j < n_tiles; ++j) {
        const int st = j % S;
        typename std::conditional<kMasks, int, const int>::type key0 = j * BKV;
        if constexpr (kMasks) key0 = vis.tile(j) * BKV;
        const uint32_t parity = (j / S) & 1;
        mbar_wait(&empty[st], parity ^ 1);
        unsigned char* Kt = smem + L::kKOff + st * L::kKBytes;
        unsigned char* Vt = smem + L::kVOff + st * L::kVBytes;
        if (ptid == 0) {
          mbar_arrive_expect_tx(&full[st], (k_packed ? 0 : L::kKBytes) + (v_int8 ? 0 : L::kVBytes));
          if (kStaged) mbar_arrive_expect_tx(&staged[st], (k_packed ? BKV * pk_row : 0) + (v_int8 ? BKV * D : 0));
          if (k_packed) {
            tma_load_3d(smem + L::kPOff + st * L::kPBytes, &k_map, &staged[st], 0, key0, kh);
          } else {
#pragma unroll
            for (int c = 0; c < L::kRowBytes / kSw; ++c)
              tma_load_3d(Kt + c * BKV * kSw, &k_map, &full[st], c * kSw / (kInt8 ? 1 : 2), key0, kh);
          }
          if (v_int8) {
            // (Rows wider than a 256-byte box come as two boxes of a 4-d map.)
            if constexpr (D > 256)
              tma_load_4d(smem + L::kV8Off + st * L::kV8Bytes, &v_map, &staged[st], 0, 0, key0, kh);
            else
              tma_load_3d(smem + L::kV8Off + st * L::kV8Bytes, &v_map, &staged[st], 0, key0, kh);
          } else {
#pragma unroll
            for (int c = 0; c < L::kVCols / 64; ++c)
              tma_load_3d(Vt + c * BKV * 128, &v_map, &full[st], c * 64, key0, kh);
          }
        }
        if constexpr (kInt8) {
          float* ks_t = reinterpret_cast<float*>(smem + L::kSOff + st * L::kSBytes);
          for (int i = ptid; i < BKV; i += kStaged ? 128 : 32) ks_t[i] = key0 + i < Sk ? ksg[key0 + i] : 0.0f;
        }
        if constexpr (kMasks) {
          if (vis.segs) {
            int* kg_t = reinterpret_cast<int*>(smem + L::kGOff + st * L::kGBytes);
            const int* kvs = args.kv_seg + (long long)b * Sk;
            for (int i = ptid; i < BKV; i += kStaged ? 128 : 32) kg_t[i] = key0 + i < Sk ? kvs[key0 + i] : 0;
          }
        }
        if constexpr (kStaged) {
          mbar_wait(&staged[st], parity);
          if constexpr (kInt8) {
            const uint32_t* pk_src = reinterpret_cast<const uint32_t*>(smem + L::kPOff + st * L::kPBytes);
            if (k_packed && k_bits == 4) widen_k<4, D, kSw, BKV>(pk_src, Kt, ptid);
            if (k_packed && k_bits == 2) widen_k<2, D, kSw, BKV>(pk_src, Kt, ptid);
          }
          if constexpr (kPV8)
            transpose_v<D, BKV>(smem + L::kV8Off + st * L::kV8Bytes, Vt, ptid);
          else if (v_int8)
            widen_v<D, BKV>(reinterpret_cast<const uint2*>(smem + L::kV8Off + st * L::kV8Bytes), Vt, ptid);
          fence_proxy_async();
        }
        if constexpr (L::kBBytes > 0) {
          if (vbias) {
            float* b_t = reinterpret_cast<float*>(smem + L::kBOff + st * L::kBBytes);
            const float* bg = args.bias + ((long long)b * H + h) * Sk;
            for (int i = ptid; i < BKV; i += kStaged ? 128 : 32)
              b_t[i] = key0 + i < Sk ? __fmul_rn(bg[key0 + i], LOG2E) : 0.0f;
          }
          if (kStaged || kInt8 || vis.segs || vbias) mbar_arrive(&full[st]);
        } else if constexpr (kMasks) {
          if (kStaged || kInt8 || vis.segs) mbar_arrive(&full[st]);
        } else {
          if (kStaged || kInt8) mbar_arrive(&full[st]);
        }
      }
    }
  } else {
    // ---- consumers: warpgroup wg owns CTA rows 64*(wg/CS) .. + 63 and O
    // columns DV*(wg%CS) .. + DV - 1 ----
    setmaxnreg_inc<NWG == 2 ? 232 : 160>();
    const int tid = threadIdx.x & 127, warp = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, t = lane & 3;
    const int r_base = 64 * (wg / CS), cb = wg % CS;
    unsigned char* Qs = smem + L::kQOff;
    float* qs_s = reinterpret_cast<float*>(smem + L::kQsOff);
    const long long qh = (long long)b * H + h;
    const float sm_scale_log2e = args.sm_scale_log2e;

    // Q tile into swizzled shared memory: codes/values as they lie, or
    // quantized per row (the TPU kernel's fused_quant_q):
    // scale = fma(amax, 1/127, 1e-7), code = clamp(roundf(q / scale)), and
    // the row scale carries sm_scale * log2(e).
    // (With CS > 1 the row block's warpgroups share the work and the Q tile.)
    if (!kInt8 || args.q_mode == Q_INT8) {
      const unsigned char* qg = static_cast<const unsigned char*>(args.q) + qh * Sq * L::kRowBytes;
      constexpr int CPR = L::kRowBytes / 16;
      for (int c = tid + 128 * cb; c < 64 * CPR; c += 128 * CS) {
        const int r = r_base + c / CPR, byte = (c % CPR) * 16;
        int4 val = make_int4(0, 0, 0, 0);
        if (q0 + r < Sq) val = *reinterpret_cast<const int4*>(qg + (long long)(q0 + r) * L::kRowBytes + byte);
        *reinterpret_cast<int4*>(Qs + (byte / kSw) * BQ * kSw + swizzle_offset<kSw>(r * kSw + byte % kSw)) = val;
      }
      if (kInt8 && tid < 64 && cb == 0)
        qs_s[r_base + tid] = q0 + r_base + tid < Sq ? args.q_scale[qh * Sq + q0 + r_base + tid] : 0.0f;
    } else {
      constexpr int E = D / 32;  // contiguous elements per lane
      const bool q_f32 = args.q_mode == Q_FUSED_F32;
      for (int rr = cb * (16 / CS); rr < (cb + 1) * (16 / CS); ++rr) {
        const int r = r_base + warp * 16 + rr;
        const bool ok = q0 + r < Sq;
        const long long at = (qh * Sq + q0 + r) * D + lane * E;
        float x[E];
        float amax = 0.0f;
#pragma unroll
        for (int i = 0; i < E; ++i) {
          x[i] = !ok    ? 0.0f
                 : q_f32 ? static_cast<const float*>(args.q)[at + i]
                         : __bfloat162float(static_cast<const __nv_bfloat16*>(args.q)[at + i]);
          amax = fmaxf(amax, fabsf(x[i]));
        }
        const float sc = __fmaf_rn(warp_max(amax), 1.0f / 127.0f, 1e-7f);
        typename std::conditional<E >= 8, uint64_t, uint32_t>::type packed = 0, packed_hi = 0;
#pragma unroll
        for (int i = 0; i < E; ++i) {
          const float c = fminf(fmaxf(roundf(__fdiv_rn(x[i], sc)), -127.0f), 127.0f);
          if (i < 8)
            packed |= (decltype(packed))(uint8_t)(int8_t)c << (8 * i);
          else
            packed_hi |= (decltype(packed))(uint8_t)(int8_t)c << (8 * (i - 8));
        }
        const int byte = lane * E;
        unsigned char* dst = Qs + (byte / kSw) * BQ * kSw + swizzle_offset<kSw>(r * kSw + byte % kSw);
        if constexpr (E == 16)
          *reinterpret_cast<uint4*>(dst) =
              make_uint4((uint32_t)packed, (uint32_t)(packed >> 32), (uint32_t)packed_hi, (uint32_t)(packed_hi >> 32));
        else if constexpr (E == 2)
          *reinterpret_cast<uint16_t*>(dst) = (uint16_t)packed;
        else if constexpr (E == 8)
          *reinterpret_cast<uint64_t*>(dst) = packed;
        else
          *reinterpret_cast<uint32_t*>(dst) = packed;
        if (lane == 0) qs_s[r] = __fmul_rn(sc, sm_scale_log2e);
      }
    }
    fence_proxy_async();
    named_bar_sync(kBarTurn + NWG + wg / CS, 128 * CS);
    float qsc[2] = {0.0f, 0.0f};
    if constexpr (kInt8) {
      qsc[0] = qs_s[r_base + warp * 16 + g];
      qsc[1] = qs_s[r_base + warp * 16 + g + 8];
    }

    const uint32_t q_addr = smem_u32(Qs) + r_base * kSw;
    const uint32_t k_addr = smem_u32(smem + L::kKOff);
    // V's tiles at this warpgroup's first O column (bf16: 64-column blocks
    // of BKV 128-byte rows; INT8 PV's V^T: rows of BKV bytes).
    const uint32_t v_addr = smem_u32(smem + L::kVOff) + cb * (kPV8 ? DV * BKV : DV / 64 * BKV * 128);
    constexpr int KSTEPS = L::kRowBytes / 32;  // 32 bytes of K depth per product

    SAcc sacc[BKV / 2];
    float oacc[DV / 2];
    uint32_t pk[kPV8 ? 1 : BKV / 8][2];  // P as bf16x2: [8-key column tile][row g, row g + 8]
    uint32_t a8[kPV8 ? BKV / 32 : 1][4];  // INT8 PV: p8 as s8 A fragments of each 32-key chunk
    int pv[kPV8 ? (kSplitPV8 ? DV / 4 : DV / 2) : 1];  // INT8 PV: one tile's (half's) i32 p8 V8
    uint32_t pl[kPV32 ? BKV / 8 : 1][2];  // fp32 PV: P's second bf16 term, as pk
    uint32_t p3[kPV32 ? BKV / 8 : 1][2];  // ... and its third
    // fp32 PV: one tile's products of one 64-column block, added to O on the
    // CUDA cores.
    float pacc[kPV32 ? 32 : 1];
#pragma unroll
    for (int i = 0; i < DV / 2; ++i) oacc[i] = 0.0f;
    if constexpr (kPV32) {
#pragma unroll
      for (int i = 0; i < 32; ++i) pacc[i] = 0.0f;
    }
    if constexpr (kPV8) {
#pragma unroll
      for (int i = 0; i < BKV / 32; ++i) a8[i][0] = a8[i][1] = a8[i][2] = a8[i][3] = 0u;
    } else {
#pragma unroll
      for (int i = 0; i < BKV / 8; ++i) pk[i][0] = pk[i][1] = 0u;
    }
    float m_run[2] = {NEG_INIT, NEG_INIT};
    float l_run[2] = {0.0f, 0.0f};  // per-thread partial row sums

    auto issue_s = [&](int st) {
#pragma unroll
      for (int ks = 0; ks < KSTEPS; ++ks) {
        const int byte = ks * 32, chunk = byte / kSw, in = byte % kSw;
        const uint64_t da = make_desc(q_addr + chunk * BQ * kSw + in, 16, 8 * kSw, kSw);
        const uint64_t db = make_desc(k_addr + st * L::kKBytes + chunk * BKV * kSw + in, 16, 8 * kSw, kSw);
        if constexpr (BKV == 64) {
          if constexpr (kInt8) {
            if (ks == 0)
              wgmma_m64n64k32_s32_s8_ss_init(sacc, da, db);
            else
              wgmma_m64n64k32_s32_s8_ss(sacc, da, db, 1);
          } else {
            if (ks == 0)
              wgmma_m64n64k16_f32_bf16_ss_init(sacc, da, db);
            else
              wgmma_m64n64k16_f32_bf16_ss(sacc, da, db, 1);
          }
        } else
        if constexpr (kInt8) {
          if (ks == 0)
            wgmma_m64n128k32_s32_s8_ss_init(sacc, da, db);
          else
            wgmma_m64n128k32_s32_s8_ss(sacc, da, db, 1);
        } else {
          if (ks == 0)
            wgmma_m64n128k16_f32_bf16_ss_init(sacc, da, db);
          else
            wgmma_m64n128k16_f32_bf16_ss(sacc, da, db, 1);
        }
      }
    };
    // O += a (16 keys of P as bf16 fragments) times the 16 V rows at vk, over
    // every column: at d256 two products of 128 columns (V's column blocks
    // 0-1 and 2-3).
    auto pv_bf16 = [&](const uint32_t(&a)[4], uint32_t vk) {
      if constexpr (D == 64) {
        wgmma_m64n64k16_f32_bf16_rs(oacc, a, make_desc(vk, BKV * 128, 1024, 128), 1);
      } else {
        wgmma_m64n128k16_f32_bf16_rs(*reinterpret_cast<float(*)[64]>(&oacc[0]), a,
                                     make_desc(vk, BKV * 128, 1024, 128), 1);
        if constexpr (DV == 256)
          wgmma_m64n128k16_f32_bf16_rs(*reinterpret_cast<float(*)[64]>(&oacc[64]), a,
                                       make_desc(vk + 2 * BKV * 128, BKV * 128, 1024, 128), 1);
      }
    };
    // fp32 PV: a (16 keys of a P term) times 64 columns of the 16 V rows at
    // vk into the block's own accumulator, which its first product starts at
    // zero.
    auto pv32 = [&](const uint32_t(&a)[4], uint32_t vk, int accumulate) {
      if constexpr (kPV32)
        wgmma_m64n64k16_f32_bf16_rs(*reinterpret_cast<float(*)[32]>(&pacc[0]), a,
                                    make_desc(vk, BKV * 128, 1024, 128), accumulate);
    };
    auto issue_pv = [&](int st) {
      if constexpr (kSplitPV8) {
        // (pv8_split multiplies INT8 PV at d256.)
      } else if constexpr (kPV8) {
        // p8 (registers) times V^T (K-major, 128-byte rows), 32 keys a product.
#pragma unroll
        for (int kk = 0; kk < BKV / 32; ++kk) {
          const uint64_t db = make_desc(v_addr + st * L::kVBytes + kk * 32, 16, 1024, 128);
          if constexpr (D == 64) {
            if (kk == 0)
              wgmma_m64n64k32_s32_s8_rs_init(pv, a8[kk], db);
            else
              wgmma_m64n64k32_s32_s8_rs(pv, a8[kk], db, 1);
          } else {
            if (kk == 0)
              wgmma_m64n128k32_s32_s8_rs_init(pv, a8[kk], db);
            else
              wgmma_m64n128k32_s32_s8_rs(pv, a8[kk], db, 1);
          }
        }
      } else if constexpr (kPV32) {
        // (pv32_blocks multiplies fp32 PV.)
      } else if constexpr (DV == 256) {
#pragma unroll
        for (int kk = 0; kk < BKV / 16; ++kk) {
          const uint32_t a[4] = {pk[2 * kk][0], pk[2 * kk][1], pk[2 * kk + 1][0], pk[2 * kk + 1][1]};
          const uint32_t vk = v_addr + st * L::kVBytes + kk * 16 * 128;
          pv_bf16(a, vk);
        }
      } else {
#pragma unroll
        for (int kk = 0; kk < BKV / 16; ++kk) {
          const uint32_t a[4] = {pk[2 * kk][0], pk[2 * kk][1], pk[2 * kk + 1][0], pk[2 * kk + 1][1]};
          // 16 keys of V: rows of 128 bytes, 8-key groups 1024 bytes apart,
          // 64-column halves BKV * 128 bytes apart.
          const uint64_t db = make_desc(v_addr + st * L::kVBytes + kk * 16 * 128, BKV * 128, 1024, 128);
          if constexpr (D == 64)
            wgmma_m64n64k16_f32_bf16_rs(oacc, a, db, 1);
          else
            wgmma_m64n128k16_f32_bf16_rs(oacc, a, db, 1);
        }
      }
    };
    // After wgmma_wait<1>: S is in; after wgmma_wait<0>: so is O, and P's
    // registers are free.
    auto s_ready = [&]() {
#pragma unroll
      for (int i = 0; i < BKV / 2; ++i) pin(sacc[i]);
    };
    auto o_ready = [&]() {
      if constexpr (kPV8 && !kSplitPV8) {
        // Fold the tile's i32 product into O (|p8 V8| sums < 2^24: exact).
#pragma unroll
        for (int i = 0; i < DV / 2; ++i) pin(pv[i]);
#pragma unroll
        for (int i = 0; i < BKV / 32; ++i) pin(a8[i][0]), pin(a8[i][1]), pin(a8[i][2]), pin(a8[i][3]);
#pragma unroll
        for (int i = 0; i < DV / 2; ++i) oacc[i] += (float)pv[i];
      } else {
#pragma unroll
        for (int i = 0; i < DV / 2; ++i) pin(oacc[i]);
#pragma unroll
        for (int i = 0; i < BKV / 8; ++i) pin(pk[i][0]), pin(pk[i][1]);
      }
    };
    // INT8 PV at d256: the tile's p8 (a8) times V^T (K-major rows of BKV
    // bytes) in two products of 128 columns, each waited for and folded
    // into O before the next reuses the s32 tile.
    auto pv8_split = [&](int st) {
      if constexpr (kSplitPV8) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BKV / 32; ++kk) {
          const uint64_t db = make_desc(v_addr + st * L::kVBytes + half * 128 * BKV + kk * 32, 16, 8 * BKV, BKV);
          if (kk == 0)
            wgmma_m64n128k32_s32_s8_rs_init(*reinterpret_cast<int(*)[64]>(&pv[0]), a8[kk], db);
          else
            wgmma_m64n128k32_s32_s8_rs(*reinterpret_cast<int(*)[64]>(&pv[0]), a8[kk], db, 1);
        }
        wgmma_commit();
        wgmma_wait<0>();
#pragma unroll
        for (int i = 0; i < 64; ++i) pin(pv[i]);
#pragma unroll
        for (int i = 0; i < 64; ++i) oacc[64 * half + i] += (float)pv[i];
      }
      }
    };

    // fp32 PV: the tile's P (three bf16 terms: pk, pl, p3) times V (three
    // bf16 terms V1 | V2 | V3, D columns each) in 64-column blocks, one at a
    // time: for each 16-key step the six products whose terms' orders add
    // to at most 2 (P3 V1, P2 V2, P1 V3, P2 V1, P1 V2, P1 V1, the smallest
    // first; the dropped ones are below 2^-24 of P V) into the block's own
    // f32 accumulator from zero, which the CUDA cores add to O once in, so
    // no tile's rounding rides on the running O.
    auto pv32_blocks = [&](int st) {
      if constexpr (kPV32) {
#pragma unroll
        for (int blk = 0; blk < D / 64; ++blk) {
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < BKV / 16; ++kk) {
            const uint32_t a1[4] = {pk[2 * kk][0], pk[2 * kk][1], pk[2 * kk + 1][0], pk[2 * kk + 1][1]};
            const uint32_t a2[4] = {pl[2 * kk][0], pl[2 * kk][1], pl[2 * kk + 1][0], pl[2 * kk + 1][1]};
            const uint32_t a3[4] = {p3[2 * kk][0], p3[2 * kk][1], p3[2 * kk + 1][0], p3[2 * kk + 1][1]};
            const uint32_t v1 = v_addr + st * L::kVBytes + blk * BKV * 128 + kk * 16 * 128;
            const uint32_t v2 = v1 + (D / 64) * BKV * 128, v3 = v2 + (D / 64) * BKV * 128;
            pv32(a3, v1, kk > 0);
            pv32(a2, v2, 1);
            pv32(a1, v3, 1);
            pv32(a2, v1, 1);
            pv32(a1, v2, 1);
            pv32(a1, v1, 1);
          }
          wgmma_commit();
          wgmma_wait<0>();
#pragma unroll
          for (int i = 0; i < 32; ++i) pin(pacc[i]);
#pragma unroll
          for (int i = 0; i < 32; ++i) oacc[32 * blk + i] += pacc[i];
        }
#pragma unroll
        for (int i = 0; i < BKV / 8; ++i) {
          pin(pk[i][0]), pin(pk[i][1]), pin(pl[i][0]), pin(pl[i][1]), pin(p3[i][0]), pin(p3[i][1]);
        }
      }
    };

    // PV of tile j with nothing else in flight: INT8 PV at d256, fp32 PV (a
    // block at a time).
    auto pv_serial = [&](int st) {
      if constexpr (kSplitPV8) {
        pv8_split(st);
      } else if constexpr (kPV32) {
        pv32_blocks(st);
      } else {
        wgmma_fence();
        issue_pv(st);
        wgmma_commit();
        wgmma_wait<0>();
        o_ready();
      }
    };

    // The softmax of tile j (in ring stage st) in two halves. The first
    // needs only the S accumulator: s, m, alpha and P (as f32 of bf16
    // values, in s) while the previous tile's PV product may still run. The
    // second packs P into pk and rescales O and l, once that product is done.
    float s[BKV / 2];
    float alpha[2];
    auto softmax_s = [&](int j, int st) {
      const int key0 = j * BKV;
      if constexpr (kInt8) {
        const float* ks_t = reinterpret_cast<const float*>(smem + L::kSOff + st * L::kSBytes);
#pragma unroll
        for (int nt = 0; nt < BKV / 8; ++nt) {
          const float2 k2 = *reinterpret_cast<const float2*>(ks_t + nt * 8 + 2 * t);
#pragma unroll
          for (int e = 0; e < 4; ++e)
            s[4 * nt + e] = __fmul_rn(__fmul_rn((float)sacc[4 * nt + e], (e & 1) ? k2.y : k2.x), qsc[e >> 1]);
        }
      } else {
#pragma unroll
        for (int i = 0; i < BKV / 2; ++i) s[i] = __fmul_rn(sacc[i], sm_scale_log2e);
      }
      // The bias, taken to base 2 where it is loaded, after the scale and
      // before the cap and the masks: a vector from the ring's tile (the
      // producer scaled it), keys 2t, 2t + 1 of each 8-key block; a matrix
      // (or any bias with fp32 PV) read where it lies, rows g and g + 8 of
      // the warp (a row past Sq reads row Sq - 1 and is not stored), no key
      // past Sk (those are masked).
      if constexpr (L::kBBytes > 0) {
        if (vbias) {
          const float* b_t = reinterpret_cast<const float*>(smem + L::kBOff + st * L::kBBytes);
#pragma unroll
          for (int nt = 0; nt < BKV / 8; ++nt) {
            const float2 bb = *reinterpret_cast<const float2*>(b_t + nt * 8 + 2 * t);
            s[4 * nt] = __fadd_rn(s[4 * nt], bb.x);
            s[4 * nt + 1] = __fadd_rn(s[4 * nt + 1], bb.y);
            s[4 * nt + 2] = __fadd_rn(s[4 * nt + 2], bb.x);
            s[4 * nt + 3] = __fadd_rn(s[4 * nt + 3], bb.y);
          }
        }
      }
      if constexpr (kBias) {
        if (args.bias != nullptr && !vbias) {
          const int r0 = q0 + r_base + warp * 16 + g;
          const float* bh = args.bias + qh * args.bias_rows * Sk;
          const float* b0 = args.bias_rows == 1 ? bh : bh + (long long)min(r0, Sq - 1) * Sk;
          const float* b1 = args.bias_rows == 1 ? bh : bh + (long long)min(r0 + 8, Sq - 1) * Sk;
#pragma unroll
          for (int nt = 0; nt < BKV / 8; ++nt)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int col = key0 + nt * 8 + 2 * t + e;
              if (col < Sk) {
                s[4 * nt + e] = __fadd_rn(s[4 * nt + e], __fmul_rn(__ldg(b0 + col), LOG2E));
                s[4 * nt + 2 + e] = __fadd_rn(s[4 * nt + 2 + e], __fmul_rn(__ldg(b1 + col), LOG2E));
              }
            }
        }
      }
      // The logit cap, in base 2 after the scale and before the mask, with
      // the accurate tanhf (tanh.approx's 2^-11 moves P too far).
      if constexpr (kMasks) {
        const float cap2 = args.logit_cap2;
        if (cap2 > 0.0f) {
#pragma unroll
          for (int i = 0; i < BKV / 2; ++i) s[i] = __fmul_rn(cap2, tanhf(__fdiv_rn(s[i], cap2)));
        }
      }
      if constexpr (kMasks) {
        // A tile wholly inside every row's band and the KV edge, with no
        // segments, takes no mask. The masks' state is formed here, in the
        // masked branch only.
        const bool segs = vis.segs;
        const int window = vis.window, sink = vis.sink;
        const int row_lo = q0 + r_base + warp * 16 + vis.q_off;  // the warp's first row's position
        if ((causal && key0 + BKV - 1 > row_lo) || key0 + BKV > Sk || segs ||
            (window > 0 && row_lo + 15 - key0 >= window)) {
          // Rows g, g + 8 see a key at c iff c <= hi (the KV edge and the
          // causal diagonal), c >= lo or c < sink (the window and its
          // sinks), and, with segments, c holds the row's segment.
          int hi[2], lo[2], qseg[2] = {0, 0};
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            const int pos = row_lo + g + 8 * hf, r = q0 + r_base + warp * 16 + g + 8 * hf;
            hi[hf] = causal ? min(Sk - 1, pos) : Sk - 1;
            lo[hf] = window > 0 ? pos - window + 1 : INT_MIN;
            if (segs && r < Sq) qseg[hf] = args.q_seg[(long long)b * Sq + r];
          }
          const int* kg_t = reinterpret_cast<const int*>(smem + L::kGOff + st * L::kGBytes);
#pragma unroll
          for (int nt = 0; nt < BKV / 8; ++nt) {
            const int2 kseg = segs ? *reinterpret_cast<const int2*>(kg_t + nt * 8 + 2 * t) : make_int2(0, 0);
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int col = key0 + nt * 8 + 2 * t + (e & 1), hf = e >> 1;
              const bool seen =
                  col <= hi[hf] && (col >= lo[hf] || col < sink) && ((e & 1) ? kseg.y : kseg.x) == qseg[hf];
              if (!seen) s[4 * nt + e] = MASK_VALUE;
            }
          }
        }
      } else {
        const int row_lo = q0 + r_base + warp * 16;
        if ((causal && key0 + BKV - 1 > row_lo) || key0 + BKV > Sk) {
#pragma unroll
          for (int i = 0; i < BKV / 2; ++i) {
            const int col = key0 + (i / 4) * 8 + 2 * t + (i & 1);
            const int row = row_lo + g + 8 * ((i >> 1) & 1);
            if (col >= Sk || (causal && col > row)) s[i] = MASK_VALUE;
          }
        }
      }
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        float m4[4];  // four independent chains, not one of 32
#pragma unroll
        for (int c = 0; c < 4; ++c) m4[c] = fmaxf(s[4 * c + 2 * hf], s[4 * c + 2 * hf + 1]);
#pragma unroll
        for (int nt = 4; nt < BKV / 8; ++nt)
          m4[nt & 3] = fmaxf(m4[nt & 3], fmaxf(s[4 * nt + 2 * hf], s[4 * nt + 2 * hf + 1]));
        float mx = fmaxf(fmaxf(m4[0], m4[1]), fmaxf(m4[2], m4[3]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m_run[hf], mx);
        alpha[hf] = ex2(m_run[hf] - m_new);
        m_run[hf] = m_new;
      }
      // INT8 PV folds the x127 requantization into the shift.
      const float shift[2] = {kPV8 ? m_run[0] - LOG2_127 : m_run[0], kPV8 ? m_run[1] - LOG2_127 : m_run[1]};
#pragma unroll
      for (int nt = 0; nt < BKV / 8; ++nt)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          float& s0 = s[4 * nt + 2 * hf];
          float& s1 = s[4 * nt + 2 * hf + 1];
          if constexpr (kPV32) {
            // fp32 PV: s - m and P stay f32.
            s0 = ex2(s0 - shift[hf]);
            s1 = ex2(s1 - shift[hf]);
          } else {
          const uint32_t dd = pack_bf16x2(s0 - shift[hf], s1 - shift[hf]);
          s0 = ex2(bf16_lo(dd));
          s1 = ex2(bf16_hi(dd));
          }
        }
    };
    auto softmax_o = [&]() {
      if constexpr (kPV8) {
        // p8 of each 8-key block (keys 2t, 2t+1): floor(bf16 P + P8_BIAS) as
        // the low byte of an fadd.rm with 2^23; four blocks make one chunk's
        // A words, saturated at 127; l sums the bytes.
        unsigned lsum[2] = {0u, 0u};
#pragma unroll
        for (int c = 0; c < BKV / 32; ++c)
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            uint32_t q[4];
#pragma unroll
            for (int b = 0; b < 4; ++b) {
              const int nt = 4 * c + b;
              const uint32_t p = pack_bf16x2(s[4 * nt + 2 * hf], s[4 * nt + 2 * hf + 1]);
              const float y0 = __fadd_rd(bf16_lo(p) + P8_BIAS, 8388608.0f);
              const float y1 = __fadd_rd(bf16_hi(p) + P8_BIAS, 8388608.0f);
              q[b] = __byte_perm(__float_as_uint(y0), __float_as_uint(y1), 0x0040);
            }
            uint32_t w0 = __byte_perm(q[0], q[1], 0x5410), w1 = __byte_perm(q[2], q[3], 0x5410);
            w0 -= (w0 >> 7) & 0x01010101u;  // 128 -> 127 (the only byte with bit 7)
            w1 -= (w1 >> 7) & 0x01010101u;
            a8[c][hf] = w0;
            a8[c][2 + hf] = w1;
            lsum[hf] = __dp4a(w0, 0x01010101u, lsum[hf]);
            lsum[hf] = __dp4a(w1, 0x01010101u, lsum[hf]);
          }
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) l_run[hf] = alpha[hf] * l_run[hf] + (float)lsum[hf];
#pragma unroll
        for (int i = 0; i < DV / 2; ++i) oacc[i] *= alpha[(i >> 1) & 1];
      } else if constexpr (kPV32) {
        // l sums P in f32; P goes to the products as three bf16 terms, P1 =
        // bf16(P), P2 = bf16(P - P1), P3 = bf16(P - P1 - P2) (each
        // difference exact in f32): all 24 bits of P.
        float lsum[2] = {0.0f, 0.0f};
#pragma unroll
        for (int nt = 0; nt < BKV / 8; ++nt)
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            const float p0 = s[4 * nt + 2 * hf], p1 = s[4 * nt + 2 * hf + 1];
            const uint32_t p = pack_bf16x2(p0, p1);
            const float r0 = p0 - bf16_lo(p), r1 = p1 - bf16_hi(p);
            const uint32_t q = pack_bf16x2(r0, r1);
            pk[nt][hf] = p;
            pl[nt][hf] = q;
            p3[nt][hf] = pack_bf16x2(r0 - bf16_lo(q), r1 - bf16_hi(q));
            lsum[hf] += p0 + p1;
          }
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) l_run[hf] = alpha[hf] * l_run[hf] + lsum[hf];
#pragma unroll
        for (int i = 0; i < DV / 2; ++i) oacc[i] *= alpha[(i >> 1) & 1];
      } else {
        float lsum[2] = {0.0f, 0.0f};
#pragma unroll
        for (int nt = 0; nt < BKV / 8; ++nt)
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            const uint32_t p = pack_bf16x2(s[4 * nt + 2 * hf], s[4 * nt + 2 * hf + 1]);
            pk[nt][hf] = p;
            lsum[hf] += bf16_lo(p) + bf16_hi(p);
          }
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) l_run[hf] = alpha[hf] * l_run[hf] + lsum[hf];
#pragma unroll
        for (int i = 0; i < DV / 2; ++i) oacc[i] *= alpha[(i >> 1) & 1];
      }
    };

    // Turns: warpgroup 0 goes first, then 1, ...; each block of products of
    // one warpgroup is followed by one of the next. The last warpgroup skips
    // its last hand-over, so every arrival meets a wait. A block issues S of
    // the next tile, then PV of this one, as two groups: the next softmax
    // starts once S is in, under PV.
    const int bar_mine = kBarTurn + wg, bar_other = kBarTurn + (wg + 1) % NWG;
    if (wg == NWG - 1) named_bar_arrive(kBarTurn, 256);
    mbar_wait(&full[0], 0);
    named_bar_sync(bar_mine, 256);
    wgmma_fence();
    issue_s(0);
    wgmma_commit();
    named_bar_arrive(bar_other, 256);
    wgmma_wait<0>();
    s_ready();
    if constexpr (kMasks)
      softmax_s(vis.tile(0), 0);
    else
      softmax_s(0, 0);
    softmax_o();
    if constexpr (kSerialPV) {
      // One product at a time (INT8 PV at d256, fp32 PV, one ring stage): PV
      // of tile j, then S of tile j + 1 (in its turn) and its softmax. The
      // turns order S alone; the last one is empty, as the other loop's last
      // PV turn.
      for (int j = 0; j + 1 < n_tiles; ++j) {
        const int st = j % S, st1 = (j + 1) % S;
        pv_serial(st);
        if (lane == 0) mbar_arrive(&empty[st]);
        mbar_wait(&full[st1], ((j + 1) / S) & 1);
        named_bar_sync(bar_mine, 256);
        wgmma_fence();
        issue_s(st1);
        wgmma_commit();
        named_bar_arrive(bar_other, 256);
        wgmma_wait<0>();
        s_ready();
        if constexpr (kMasks)
          softmax_s(vis.tile(j + 1), st1);
        else
          softmax_s(j + 1, st1);
        softmax_o();
      }
      named_bar_sync(bar_mine, 256);
      if (wg != NWG - 1) named_bar_arrive(bar_other, 256);
      pv_serial((n_tiles - 1) % S);
    } else {
    // The last tile is peeled off so that no product is issued, and no
    // accumulator written, on a path the compiler cannot prove uniform.
    for (int j = 0; j + 1 < n_tiles; ++j) {
      const int st = j % S, st1 = (j + 1) % S;
      mbar_wait(&full[st1], ((j + 1) / S) & 1);
      named_bar_sync(bar_mine, 256);
      wgmma_fence();
      issue_s(st1);
      wgmma_commit();
      issue_pv(st);
      wgmma_commit();
      named_bar_arrive(bar_other, 256);
      wgmma_wait<1>();
      s_ready();
      if constexpr (kMasks)
        softmax_s(vis.tile(j + 1), st1);
      else
        softmax_s(j + 1, st1);
      wgmma_wait<0>();
      o_ready();
      if (lane == 0) mbar_arrive(&empty[st]);
      softmax_o();
    }
    named_bar_sync(bar_mine, 256);
    wgmma_fence();
    issue_pv((n_tiles - 1) % S);
    wgmma_commit();
    if (wg != NWG - 1) named_bar_arrive(bar_other, 256);
    wgmma_wait<0>();
    o_ready();
    }

    // ---- epilogue ----
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      l_run[hf] += __shfl_xor_sync(0xffffffffu, l_run[hf], 1);
      l_run[hf] += __shfl_xor_sync(0xffffffffu, l_run[hf], 2);
    }
    const float* vm = args.v_mean ? args.v_mean + (long long)kh * D + cb * DV : nullptr;
    const float* vs = args.v_int8 ? args.v_scale + (long long)kh * D + cb * DV : nullptr;
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int row = q0 + r_base + warp * 16 + g + 8 * hf;
      if (row >= Sq) continue;
      const bool empty_row = l_run[hf] == 0.0f;
      const float ls = empty_row ? 1.0f : l_run[hf];
      const long long obase = (qh * Sq + row) * D + cb * DV;
#pragma unroll
      for (int dt = 0; dt < DV / 8; ++dt) {
        const int d = dt * 8 + 2 * t;
        float o0 = __fdiv_rn(oacc[4 * dt + 2 * hf], ls);
        float o1 = __fdiv_rn(oacc[4 * dt + 2 * hf + 1], ls);
        if (vs) {
          o0 = __fmul_rn(o0, vs[d]);
          o1 = __fmul_rn(o1, vs[d + 1]);
        }
        if (vm && !empty_row) {
          o0 += vm[d];
          o1 += vm[d + 1];
        }
        if (args.out_f32)
          store2(static_cast<float*>(args.o) + obase + d, o0, o1);
        else
          store2(static_cast<__nv_bfloat16*>(args.o) + obase + d, o0, o1);
      }
      if (args.lse && t == 0 && cb == 0)
        args.lse[qh * Sq + row] = empty_row ? NEG_INIT : m_run[hf] + log2f(ls) - (kPV8 ? LOG2_127 : 0.0f);
    }
  }
}

// K's and V's tensor maps as the kernel loads them: int8 / bf16 rows into
// swizzled tiles, packed K and INT8 V rows as they lie into the staging ring.
template <int D, bool kInt8, bool kStaged, bool kPV8, bool kMasks, bool kPV32 = false, bool kBias = false>
int launch(const BiasArgs& a, const void* k, const void* v, int B, cudaStream_t stream) {
  using L = Layout<D, kInt8, kStaged, kMasks, kPV32, kBias>;
  constexpr int BKV = L::BKV;
  const cuuint64_t rows = (cuuint64_t)B * a.Hk, sk = (cuuint64_t)a.Sk;
  const bool k_packed = kInt8 && a.k_bits < 8;
  CUtensorMap k_map, v_map;
  bool ok;
  if (k_packed) {
    const cuuint32_t rb = D * a.k_bits / 8;
    const cuuint64_t dims[3] = {rb, sk, rows}, strides[2] = {rb, sk * rb};
    const cuuint32_t box[3] = {rb, BKV, 1};
    ok = make_tensor_map(&k_map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 3, k, dims, strides, box, CU_TENSOR_MAP_SWIZZLE_NONE);
  } else {
    const cuuint64_t dims[3] = {D, sk, rows}, strides[2] = {L::kRowBytes, sk * L::kRowBytes};
    const cuuint32_t box[3] = {L::kSw / (kInt8 ? 1 : 2), BKV, 1};
    ok = make_tensor_map(&k_map, kInt8 ? CU_TENSOR_MAP_DATA_TYPE_UINT8 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, k, dims,
                         strides, box, L::kSw == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B);
  }
  if (a.v_int8 && !kPV32 && D > 256) {
    // A box row holds at most 256 elements: rows of D bytes as D / 256
    // boxes of 256, which land row after row as the 3-d map's would.
    const cuuint64_t dims[4] = {256, D / 256, sk, rows}, strides[3] = {256, D, sk * D};
    const cuuint32_t box[4] = {256, D / 256, BKV, 1};
    ok = ok && make_tensor_map(&v_map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 4, v, dims, strides, box,
                               CU_TENSOR_MAP_SWIZZLE_NONE);
  } else if (a.v_int8 && !kPV32) {
    const cuuint64_t dims[3] = {D, sk, rows}, strides[2] = {D, sk * D};
    const cuuint32_t box[3] = {D, BKV, 1};
    ok = ok && make_tensor_map(&v_map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 3, v, dims, strides, box,
                               CU_TENSOR_MAP_SWIZZLE_NONE);
  } else {
    const cuuint64_t dims[3] = {L::kVCols, sk, rows}, strides[2] = {L::kVCols * 2, sk * L::kVCols * 2};
    const cuuint32_t box[3] = {64, BKV, 1};
    ok = ok && make_tensor_map(&v_map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, v, dims, strides, box,
                               CU_TENSOR_MAP_SWIZZLE_128B);
  }
  if (!ok) return (int)cudaErrorInvalidValue;
  auto kern = attn_fwd_wgmma_kernel<D, kInt8, kStaged, kPV8, kMasks, kPV32, kBias>;
  constexpr int smem = L::kTotal + 1024;
  const cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((a.Sq + L::BQ - 1) / L::BQ, a.H, B);
  kern<<<grid, 128 * (kNWG<D, kPV32> + 1), smem, stream>>>(k_map, v_map, static_cast<const ArgsOf<kMasks, kBias>&>(a));
  return (int)cudaGetLastError();
}

template <int D, bool kMasks, bool kBias = false>
int dispatch_modes(const BiasArgs& a, bool pv8, const void* k, const void* v, int B, cudaStream_t st) {
  const bool staged = a.k_bits < 8 || a.v_int8;
  if (pv8)
    return a.q_mode == Q_FP ? launch<D, false, true, true, kMasks, false, kBias>(a, k, v, B, st)
                            : launch<D, true, true, true, kMasks, false, kBias>(a, k, v, B, st);
  if (a.q_mode == Q_FP)
    return staged ? launch<D, false, true, false, kMasks, false, kBias>(a, k, v, B, st)
                  : launch<D, false, false, false, kMasks, false, kBias>(a, k, v, B, st);
  return staged ? launch<D, true, true, false, kMasks, false, kBias>(a, k, v, B, st)
                : launch<D, true, false, false, kMasks, false, kBias>(a, k, v, B, st);
}

// The masked kernels (kMasks) take a window, a q offset, segment ids or a
// logit cap; every other call runs the kernels without them (with the
// masks' state in every kernel, the d64 kernels spilled). A call with a
// bias runs the bias kernels (dispatch_bias); at d256 and d512 the masked
// kernels are the bias kernels.
inline bool has_masks(const BiasArgs& a) {
  return a.window > 0 || a.q_offset != 0 || a.kv_seg != nullptr || a.logit_cap2 > 0.0f;
}
template <int D>
int dispatch(const BiasArgs& a, bool pv8, const void* k, const void* v, int B, cudaStream_t st) {
  const bool masks = has_masks(a);
  if constexpr (D == 256) {
    if (masks || a.bias != nullptr) return dispatch_modes<D, true, true>(a, pv8, k, v, B, st);
    return dispatch_modes<D, false>(a, pv8, k, v, B, st);
  } else {
    return masks ? dispatch_modes<D, true>(a, pv8, k, v, B, st) : dispatch_modes<D, false>(a, pv8, k, v, B, st);
  }
}

// The bias kernels (kBias, attention_fwd_wgmma_bias.cu at d64/d128): the
// masked kernels with the bias. With the bias in every masked kernel,
// chip_smoke.py phase 15's masked calls ran up to 12% slower at d128 and
// with the cap on an H100 80GB HBM3 at 700 W.
template <int D>
int dispatch_bias(const BiasArgs& a, bool pv8, const void* k, const void* v, int B, cudaStream_t st) {
  return dispatch_modes<D, true, true>(a, pv8, k, v, B, st);
}

// fp32 PV (kPV32): the bias kernels, INT8 or bf16 QK, packed K through the
// staging ring; V always comes as three bf16 terms (int8 codes exact in the
// first). At d256 a stage of bf16 K (32 KB) and V's terms (96 KB) beside the
// 64 KB bf16 Q tile fits once: one stage.
template <int D>
int dispatch_pv32(const BiasArgs& a, const void* k, const void* v, int B, cudaStream_t st) {
  if (a.q_mode == Q_FP) return launch<D, false, false, false, true, true, true>(a, k, v, B, st);
  return a.k_bits < 8 ? launch<D, true, true, false, true, true, true>(a, k, v, B, st)
                      : launch<D, true, false, false, true, true, true>(a, k, v, B, st);
}

// The C entry's checks: cudaErrorInvalidValue for arguments no kernel
// takes, else 0.
inline int attn_check(const AttnFwdCall& c) {
  const bool k_ok = c.q_mode == Q_FP ? c.k_bits == 16 : (c.k_bits == 8 || c.k_bits == 4 || c.k_bits == 2);
  const bool d_ok = c.D == 64 || c.D == 128 || c.D == 256 || c.D == 512;
  if (!k_ok || !d_ok || c.q_mode < Q_INT8 || c.q_mode > Q_FP || c.v_mode < 0 || c.v_mode > 2 ||
      (c.v_mode != 0 && c.v_scale == nullptr) || (c.q_mode != Q_FP && c.k_scale == nullptr) ||
      (c.q_mode == Q_INT8 && c.q_scale == nullptr) || ((c.q_seg == nullptr) != (c.kv_seg == nullptr)) ||
      c.window < 0 || c.sink < 0 || c.logit_cap2 < 0.0f || (!c.causal && (c.window != 0 || c.q_offset != 0)) ||
      (c.bias == nullptr) != (c.bias_rows == 0) || (c.bias != nullptr && c.bias_rows != 1 && c.bias_rows != c.Sq) ||
      (c.pv32 && (c.v_mode == 2 || c.D == 512)))
    return (int)cudaErrorInvalidValue;
  return 0;
}

// A checked call's kernel arguments.
inline BiasArgs args_of(const AttnFwdCall& c) {
  return BiasArgs{{{c.q, c.q_scale, c.k_scale, c.v_scale, c.v_mean, c.o, c.lse, c.H, c.Hk, c.Sq, c.Sk, c.causal,
                    c.q_mode, c.k_bits, c.v_mode != 0, c.out_f32, c.sm_scale_log2e},
                   c.q_seg, c.kv_seg, c.window, c.window > 0 ? c.sink : 0, c.q_offset, c.logit_cap2},
                  c.bias, c.bias_rows};
}

}  // namespace
