// Kernel E's device code (instances in fused_kv_attention_wgmma.cu: the C
// entry and head dims 64 and 128; fused_kv_attention_wgmma_pad.cu: head dim
// 256 and every head dim below its kernel's width).
//
// Kernel E on Hopper's own machinery: attention over K and V kept as packed
// 4- or 2-bit codes with per-(token group, channel) scales and zero-points
// (KIVI grouping), by TMA, wgmma and warp specialisation.
//
// Replaces the TPU kernel lowbit_quant_fa2_paddle_tpu/ops/fused_kv.py:
// _fused_kv_kernel (launched by fused_packed_kv_attention, pallas_call at
// :377). Its K-major twin _fused_kv_kernel_km is a TPU schedule and has no
// counterpart here.
//
// Inputs: codes packed along D (halves of D for 4 bits: byte i holds column
// i in its low nibble and i + D/2 in its high one; quarters for 2 bits: bits
// 2p..2p+1 hold column i + p*D/4), unsigned; one (scale, mn) row of D f32 per
// `group` consecutive tokens, so a key's value is code * scale + mn of its
// group. K and V stay packed in device memory; they are widened in shared
// memory only.
//
// Math per KV tile of BKV keys, as in the TPU kernel, with the operands
// rounded to bf16 for the tensor cores (the TPU kernel dots f32 Q and K):
//   K, V = bf16(fma(code, scale[g], mn[g]))         g = key / group; keys >= Sk are 0
//   s    = f32(bf16(Q) K^T) * sm_scale*log2e
//   masked s = MASK_VALUE (-0.7 * FLT_MAX): keys >= Sk, and col > row when
//              causal (top-left aligned: row r sees keys 0..r, also when Sq != Sk)
//   m' = max(m, rowmax s);  P = exp2(s - m') in f32;  l = 2^(m-m') l + sum P
//   acc = 2^(m-m') acc + bf16(P) V                  (bf16 x bf16 -> f32)
//   o = acc / l, with l == 0 read as 1 (a row with nothing visible gives 0)
//
// Bound on the H100: the tensor cores, 4*D operations per (q, k) pair (at b4
// h32 s8192 d64, 2.2 TFLOP against 0.07 GB of packed K/V), and the per-pair
// softmax chain. Every CTA widens the whole K and V of its head (2*D values
// per key, against 4*D*BQ products per key), so the widening has to run
// beside the products, not between them.
//
// Design: that of kernel A's fp mode (attention_fwd_wgmma.cu) with a producer
// that widens. One CTA per (64 x NWG q rows, head, batch) of NWG consumer
// warpgroups (3 at d64, 2 at d128) and one producer warpgroup. The
// producer's first thread keeps a ring of packed K/V tiles of 128 keys in
// flight by TMA (a KV head's packed rows are contiguous: one box per tile and
// side, 4 KB at d64 INT4; rows past Sk arrive as zeros). Its 128 threads
// widen each tile, 16 bytes of bf16 per thread and step: the codes of one
// 8-byte piece of a packed row go through the bits of 2^23 + c (exact),
// one fma with the group's scale and mn (f32 rows, read as float4 from L1/L2
// by the thread that needs them, so any group size works: a tile may hold
// many groups or part of one), and packed cvt.rn.bf16x2, into swizzled bf16
// K and V tiles of a second ring, then arrive on that stage's full barrier.
// A producer-only named barrier frees a staging slot before its next TMA.
// The consumers run A's loop unchanged but for the softmax's rounding: S =
// QK^T by bf16 wgmma (both operands in shared memory), the softmax of tile
// j+1 under PV of tile j, P in registers as PV's A operand, turns on named
// barriers between the warpgroups. Causal CTAs are launched heaviest first
// and stop at the diagonal; only diagonal and ragged tiles are masked.
// Templates: D x bits x kPad; q and output type at run time.
//
// Head dims: the kernels run at widths D = 64, 128 and 256. At 256
// (fused_kv_attention_wgmma_pad.cu) a KV tile holds 64 keys (the 64 x 256
// f32 O accumulator of a warpgroup beside S, as kernel A's d256 kernel),
// two consumer warpgroups, S as m64n64 products and PV as two m64n128
// products a 16-key step. A head dim d below its width (kPad: any multiple
// of 16 up to 256 that is not 64, 128 or 256; d is a run-time argument)
// runs the kernel of the next width up: the packed rows and the scale rows
// keep their own width d, the Q tile's and the widened K/V tiles' columns
// past d are zeros (the tiles' once, before the first tile), so S and the
// first d columns of O are exact, and only those are written. A packed row
// that is not a multiple of 16 bytes (4-bit at d % 32 == 16, 2-bit at d %
// 64 != 0) cannot be a TMA box row: the host hands those rows over padded
// to 16 bytes (args.pack_row), a copy of the packed K and V.
//
// Measured on an H100 80GB HBM3 at 700 W (script/torch_decode_ab.py): 7.8
// ms at b4 h32 s8192 d64 int4 (SDPA on K/V dequantized to bf16: 4.36); with
// the widening left out the consumers alone take 4.6 ms at 160 registers
// and 6.1 at 152. The widening's instructions, and the registers the
// producer needs for them, are what hold E above A's fp rate.

#pragma once

#include <type_traits>

#include "sm90.cuh"

// A call's arguments (global: fused_kv_pad takes them across sources).
struct FusedKvArgs {
  const void* q;
  const float* k_scale;
  const float* k_mn;
  const float* v_scale;
  const float* v_mn;
  void* o;
  int H, Hk, Sq, Sk, group, n_groups, causal, q_f32, out_f32;
  int d, pack_row;  // the head dim (D but in the kPad kernels), bytes between packed rows
  float sm_scale_log2e;
};

namespace {

using namespace sm90;

// Keys per tile: 128, or 64 at d256 (the registers of its O accumulator).
template <int D>
constexpr int kBKV = D == 256 ? 64 : 128;
template <int D>
constexpr int kNWG = D == 64 ? 3 : 2;
// Registers a thread keeps after setmaxnreg (NWG C + P <= 512 per lane
// across the warpgroups). At d64 kernel A's 160 / 32 leaves the widening
// producer spilling (9.4 ms at b4 h32 s8192 int4); 152 / 56 measured 7.8.
template <int D>
constexpr int kRegC = D == 64 ? 152 : 232;
template <int D>
constexpr int kRegP = D == 64 ? 56 : 40;
constexpr float MASK_VALUE = (float)(-0.7 * 3.4028234663852886e38);
constexpr float NEG_INIT = -1e30f;
// Named barriers: 1 .. NWG order the consumer warpgroups' products, NWG + 1
// .. 2 NWG close each one's Q prologue, 2 NWG + 1 is the producer's own.
constexpr int kBarTurn = 1;

using Args = FusedKvArgs;

// Shared memory: STAGES bf16 K tiles, STAGES bf16 V tiles, the Q tile (all
// 1024-byte aligned; rows of 128 bytes, 128-byte swizzle, d128 in two
// 64-column halves), SLOTS staging slots of packed K and V as TMA lands
// them, then the mbarriers.
template <int D, int BITS>
struct Layout {
  static constexpr int BKV = kBKV<D>;
  static constexpr int BQ = 64 * kNWG<D>;
  static constexpr int kRowBytes = D * 2;
  static constexpr int kPackRow = D * BITS / 8;  // bytes of a packed row
  static constexpr int kQBytes = BQ * kRowBytes;
  static constexpr int kTileBytes = BKV * kRowBytes;
  static constexpr int kPackBytes = BKV * kPackRow;
  static constexpr int kStages = D == 64 ? 3 : 2;
  static constexpr int kFixed = 2 * kStages * kTileBytes + kQBytes + 1024 + 256;  // + alignment slack, barriers
  static constexpr int kSlots = kFixed + 8 * kPackBytes <= 232448 ? 4 : kFixed + 6 * kPackBytes <= 232448 ? 3 : 2;
  static constexpr int kKOff = 0;
  static constexpr int kVOff = kKOff + kStages * kTileBytes;
  static constexpr int kQOff = kVOff + kStages * kTileBytes;
  static constexpr int kPOff = kQOff + kQBytes;  // slot s: packed K, then packed V
  static constexpr int kBarOff = kPOff + kSlots * 2 * kPackBytes;
  static constexpr int kTotal = kBarOff + (2 * kStages + kSlots) * 8;
  static_assert(kTotal + 1024 <= 232448, "shared memory");
};

// f32 of the code in byte K of w (< 256): the bits of 2^23 + c, minus 2^23.
template <int K>
__device__ __forceinline__ float code_f32(uint32_t w) {
  return __uint_as_float(__byte_perm(w, 0x4B000000u, 0x7540 | K)) - 8388608.0f;
}

// 4 codes (the bytes of c) widened with their columns' scale and mn, as 8
// bytes.
__device__ __forceinline__ uint2 widen4(uint32_t c, const float4& s, const float4& m) {
  return make_uint2(pack_bf16x2(fmaf(code_f32<0>(c), s.x, m.x), fmaf(code_f32<1>(c), s.y, m.y)),
                    pack_bf16x2(fmaf(code_f32<2>(c), s.z, m.z), fmaf(code_f32<3>(c), s.w, m.w)));
}

// 8 codes (the bytes of c0, then of c1) widened with their columns' scale
// and mn: bf16(fma(code, scale, mn)), as 16 bytes.
__device__ __forceinline__ uint4 widen8(uint32_t c0, uint32_t c1, const float4& s0, const float4& s1,
                                        const float4& m0, const float4& m1) {
  return make_uint4(pack_bf16x2(fmaf(code_f32<0>(c0), s0.x, m0.x), fmaf(code_f32<1>(c0), s0.y, m0.y)),
                    pack_bf16x2(fmaf(code_f32<2>(c0), s0.z, m0.z), fmaf(code_f32<3>(c0), s0.w, m0.w)),
                    pack_bf16x2(fmaf(code_f32<0>(c1), s1.x, m1.x), fmaf(code_f32<1>(c1), s1.y, m1.y)),
                    pack_bf16x2(fmaf(code_f32<2>(c1), s1.z, m1.z), fmaf(code_f32<3>(c1), s1.w, m1.w)));
}

__device__ __forceinline__ float4 ld4(const float* p) { return __ldg(reinterpret_cast<const float4*>(p)); }

// Widen one staged tile of packed codes into a swizzled bf16 tile, one of
// the 128 producer threads, in steps of one 8-byte piece of a packed row:
// piece wp holds the codes of columns 8 wp + p * PART .. + 7 for each part
// p, written as 16 bytes of bf16 (a warp's rows then cover all 32 banks).
// Offsets are 32-bit and the row loops are not unrolled, so that the
// producer keeps to its registers. Keys at or past Sk become zeros (their group may
// lie past the scale rows). When the tile's keys below Sk share one group
// (any group that is a multiple of 128), the thread loads its columns'
// scale and mn once per part; otherwise once per row and part.
template <int D, int BITS>
__device__ __forceinline__ void widen(const unsigned char* src, unsigned char* dst, const float* scale,
                                      const float* mn, int base, int key0, int Sk, int group, int ptid) {
  constexpr int BKV = kBKV<D>;
  constexpr int FPB = 8 / BITS, PART = D / FPB, PR = D * BITS / 8;
  constexpr int PPR = PR / 8;     // 8-byte pieces per packed row
  constexpr int RPP = 128 / PPR;  // rows per pass of the warpgroup
  constexpr uint32_t M4 = ((1u << BITS) - 1u) * 0x01010101u;
  const int wp = ptid % PPR, r0 = ptid / PPR;
  const int n_valid = min(BKV, Sk - key0);
  auto out_at = [&](int r, int col) {
    return reinterpret_cast<uint4*>(dst + (col / 64) * BKV * 128 + swizzle_offset<128>(r * 128 + (col % 64) * 2));
  };
  if (key0 / group == (key0 + n_valid - 1) / group) {
    const int row = base + (key0 / group) * D;
#pragma unroll
    for (int p = 0; p < FPB; ++p) {
      const int col = 8 * wp + p * PART;
      const float4 s0 = ld4(scale + row + col), s1 = ld4(scale + row + col + 4);
      const float4 m0 = ld4(mn + row + col), m1 = ld4(mn + row + col + 4);
#pragma unroll 1
      for (int r = r0; r < BKV; r += RPP) {
        const uint2 x = *reinterpret_cast<const uint2*>(src + r * PR + 8 * wp);
        *out_at(r, col) = r < n_valid ? widen8((x.x >> (p * BITS)) & M4, (x.y >> (p * BITS)) & M4, s0, s1, m0, m1)
                                      : make_uint4(0u, 0u, 0u, 0u);
      }
    }
    return;
  }
#pragma unroll 1
  for (int r = r0; r < BKV; r += RPP) {
    const uint2 x = *reinterpret_cast<const uint2*>(src + r * PR + 8 * wp);
    const bool ok = r < n_valid;
    const int row = base + (ok ? (key0 + r) / group : 0) * D;
#pragma unroll
    for (int p = 0; p < FPB; ++p) {
      const int col = 8 * wp + p * PART;
      uint4 out = make_uint4(0u, 0u, 0u, 0u);
      if (ok)
        out = widen8((x.x >> (p * BITS)) & M4, (x.y >> (p * BITS)) & M4, ld4(scale + row + col),
                     ld4(scale + row + col + 4), ld4(mn + row + col), ld4(mn + row + col + 4));
      *out_at(r, col) = out;
    }
  }
}

// widen at a head dim d below the kernel's width D (kPad), d a multiple of
// 16: packed rows of d * BITS / 8 bytes, staged `prow` bytes apart; parts of
// d / FPB columns; pieces of PB bytes of a row (8, or 4 where a 2-bit part
// is not a multiple of 8 columns, d % 32 == 16), written as 2 PB bytes of
// bf16 a part. The scale and mn rows are d wide. The columns past d are
// never written (they hold the zeros zero_pad_columns put there). Threads
// past the pieces of a whole number of rows a pass idle. As widen, a tile
// whose keys below Sk share one group loads each part's scale and mn once.
template <int D, int BITS, int PB>
__device__ __forceinline__ void widen_pad(const unsigned char* src, unsigned char* dst, const float* scale,
                                          const float* mn, int base, int key0, int Sk, int group, int ptid, int d,
                                          int prow) {
  constexpr int BKV = kBKV<D>;
  constexpr int FPB = 8 / BITS;
  constexpr uint32_t M4 = ((1u << BITS) - 1u) * 0x01010101u;
  const int part = d / FPB, ppr = d * BITS / 8 / PB, rpp = 128 / ppr;
  const int wp = ptid % ppr, r0 = ptid / ppr;
  if (r0 >= rpp) return;
  const int n_valid = min(BKV, Sk - key0);
  auto out_at = [&](int r, int col) {
    return dst + (col / 64) * BKV * 128 + swizzle_offset<128>(r * 128 + (col % 64) * 2);
  };
  // The piece of row r for part p (columns col ..), given its columns' scale
  // and mn (the second float4s unused at PB 4).
  auto piece = [&](int r, int p, int col, bool ok, const float4& s0, const float4& s1, const float4& m0,
                   const float4& m1) {
    if constexpr (PB == 8) {
      const uint2 x = *reinterpret_cast<const uint2*>(src + r * prow + 8 * wp);
      *reinterpret_cast<uint4*>(out_at(r, col)) =
          ok ? widen8((x.x >> (p * BITS)) & M4, (x.y >> (p * BITS)) & M4, s0, s1, m0, m1) : make_uint4(0u, 0u, 0u, 0u);
    } else {
      const uint32_t x = *reinterpret_cast<const uint32_t*>(src + r * prow + 4 * wp);
      *reinterpret_cast<uint2*>(out_at(r, col)) = ok ? widen4((x >> (p * BITS)) & M4, s0, m0) : make_uint2(0u, 0u);
    }
  };
  auto loads = [&](int at, float4& s0, float4& s1, float4& m0, float4& m1) {
    s0 = ld4(scale + at), m0 = ld4(mn + at);
    if constexpr (PB == 8) s1 = ld4(scale + at + 4), m1 = ld4(mn + at + 4);
  };
  float4 s0 = make_float4(0, 0, 0, 0), s1 = s0, m0 = s0, m1 = s0;
  if (key0 / group == (key0 + n_valid - 1) / group) {
    const int row = base + (key0 / group) * d;
#pragma unroll
    for (int p = 0; p < FPB; ++p) {
      const int col = PB * wp + p * part;
      loads(row + col, s0, s1, m0, m1);
#pragma unroll 1
      for (int r = r0; r < BKV; r += rpp) piece(r, p, col, r < n_valid, s0, s1, m0, m1);
    }
    return;
  }
#pragma unroll 1
  for (int r = r0; r < BKV; r += rpp) {
    const bool ok = r < n_valid;
    const int row = base + (ok ? (key0 + r) / group : 0) * d;
#pragma unroll
    for (int p = 0; p < FPB; ++p) {
      const int col = PB * wp + p * part;
      if (ok) loads(row + col, s0, s1, m0, m1);
      piece(r, p, col, ok, s0, s1, m0, m1);
    }
  }
}

// The columns [d, D) of every K and V tile of the ring (2 S tiles of BKV
// rows), zeroed by the producer's threads before the first tile (kPad).
template <int D, int S>
__device__ __forceinline__ void zero_pad_columns(unsigned char* tiles, int tile_bytes, int d, int ptid) {
  constexpr int BKV = kBKV<D>;
  const int c0 = d / 8, per_row = D / 8 - c0;  // 16-byte chunks of 8 columns past d a row
  for (int e = ptid; e < 2 * S * BKV * per_row; e += 128) {
    const int tile = e / (BKV * per_row), rem = e % (BKV * per_row), r = rem / per_row, c = 8 * (c0 + rem % per_row);
    *reinterpret_cast<uint4*>(tiles + tile * tile_bytes + (c / 64) * BKV * 128 +
                              swizzle_offset<128>(r * 128 + (c % 64) * 2)) = make_uint4(0u, 0u, 0u, 0u);
  }
}

template <int D, int BITS, bool kPad>
__global__ void __launch_bounds__(128 * (kNWG<D> + 1), 1)
    fused_kv_wgmma_kernel(const __grid_constant__ CUtensorMap k_map, const __grid_constant__ CUtensorMap v_map,
                          const Args args) {
  using L = Layout<D, BITS>;
  constexpr int BKV = L::BKV;
  constexpr int S = L::kStages, NS = L::kSlots;
  constexpr int NWG = kNWG<D>, BQ = L::BQ;

  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::kBarOff);
  uint64_t* empty = full + S;
  uint64_t* staged = empty + S;

  const int H = args.H, Hk = args.Hk, Sq = args.Sq, Sk = args.Sk;
  const bool causal = args.causal != 0;
  const int nq = (Sq + BQ - 1) / BQ;
  const int qb = causal ? nq - 1 - (int)blockIdx.x : (int)blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kh = b * Hk + h / (H / Hk);
  const int q0 = qb * BQ;
  const int nkv = (Sk + BKV - 1) / BKV;
  const int n_tiles = causal ? min(nkv, (q0 + BQ + BKV - 1) / BKV) : nkv;

  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], 128);       // every producer thread, after widening
      mbar_init(&empty[s], 4 * NWG);  // lane 0 of each consumer warp
    }
    for (int s = 0; s < NS; ++s) mbar_init(&staged[s], 1);
    mbar_fence_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == NWG) {
    // ---- producer ----
    setmaxnreg_dec<kRegP<D>>();
    const int ptid = threadIdx.x - 128 * NWG;
    const int dh = kPad ? args.d : D, prow = kPad ? args.pack_row : L::kPackRow;
    const int sbase = kh * args.n_groups * dh;  // < 2^31 (checked at launch)
    const CUtensorMap* km = &k_map;
    const CUtensorMap* vmap = &v_map;
    if constexpr (kPad) zero_pad_columns<D, S>(smem + L::kKOff, L::kTileBytes, dh, ptid);
    auto load = [=](int j) {  // packed tile j into staging slot j % NS
      const int slot = j % NS;
      unsigned char* dk = smem + L::kPOff + slot * 2 * L::kPackBytes;
      mbar_arrive_expect_tx(&staged[slot], 2 * BKV * prow);
      tma_load_3d(dk, km, &staged[slot], 0, j * BKV, kh);
      tma_load_3d(dk + L::kPackBytes, vmap, &staged[slot], 0, j * BKV, kh);
    };
    if (ptid == 0) {
      tma_prefetch_desc(km);
      tma_prefetch_desc(vmap);
      for (int j = 0; j < NS - 1 && j < n_tiles; ++j) load(j);
    }
    for (int j = 0; j < n_tiles; ++j) {
      // Every producer thread is done with tile j - 1, so its slot
      // ((j + NS - 1) % NS) takes the next load.
      named_bar_sync(kBarTurn + 2 * NWG, 128);
      if (ptid == 0 && j + NS - 1 < n_tiles) load(j + NS - 1);
      const int st = j % S, slot = j % NS;
      mbar_wait(&empty[st], ((j / S) & 1) ^ 1);
      mbar_wait(&staged[slot], (j / NS) & 1);
      const unsigned char* pk = smem + L::kPOff + slot * 2 * L::kPackBytes;
      if constexpr (kPad) {
        // Pieces of 4 bytes where a 2-bit part is not 8 columns a multiple.
        auto wid = [&](auto pb) {
          constexpr int PB = decltype(pb)::value;
          widen_pad<D, BITS, PB>(pk, smem + L::kKOff + st * L::kTileBytes, args.k_scale, args.k_mn, sbase,
                                 j * BKV, Sk, args.group, ptid, dh, prow);
          widen_pad<D, BITS, PB>(pk + L::kPackBytes, smem + L::kVOff + st * L::kTileBytes, args.v_scale,
                                 args.v_mn, sbase, j * BKV, Sk, args.group, ptid, dh, prow);
        };
        if (BITS == 2 && dh % 32)
          wid(std::integral_constant<int, 4>());
        else
          wid(std::integral_constant<int, 8>());
      } else {
        widen<D, BITS>(pk, smem + L::kKOff + st * L::kTileBytes, args.k_scale, args.k_mn, sbase, j * BKV, Sk,
                       args.group, ptid);
        widen<D, BITS>(pk + L::kPackBytes, smem + L::kVOff + st * L::kTileBytes, args.v_scale, args.v_mn, sbase,
                       j * BKV, Sk, args.group, ptid);
      }
      fence_proxy_async();
      mbar_arrive(&full[st]);
    }
  } else {
    // ---- consumers: warpgroup wg owns CTA rows 64*wg .. 64*wg + 63 ----
    setmaxnreg_inc<kRegC<D>>();
    const int tid = threadIdx.x & 127, warp = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, t = lane & 3;
    const int r_base = 64 * wg;
    unsigned char* Qs = smem + L::kQOff;
    const long long qh = (long long)b * H + h;
    const float sm_scale_log2e = args.sm_scale_log2e;
    const int dh = kPad ? args.d : D;

    // Q rounded to bf16 into swizzled shared memory (16 bytes a step); the
    // columns past dh are zeros.
    {
      constexpr int CPR = L::kRowBytes / 16;
      for (int c = tid; c < 64 * CPR; c += 128) {
        const int r = r_base + c / CPR, e0 = (c % CPR) * 8, byte = 2 * e0;
        uint4 val = make_uint4(0u, 0u, 0u, 0u);
        if (q0 + r < Sq && (!kPad || e0 < dh)) {
          const long long at = (qh * Sq + q0 + r) * dh + e0;
          if (args.q_f32) {
            const float4 a = *reinterpret_cast<const float4*>(static_cast<const float*>(args.q) + at);
            const float4 c4 = *reinterpret_cast<const float4*>(static_cast<const float*>(args.q) + at + 4);
            val = make_uint4(pack_bf16x2(a.x, a.y), pack_bf16x2(a.z, a.w), pack_bf16x2(c4.x, c4.y),
                             pack_bf16x2(c4.z, c4.w));
          } else {
            val = *reinterpret_cast<const uint4*>(static_cast<const __nv_bfloat16*>(args.q) + at);
          }
        }
        *reinterpret_cast<uint4*>(Qs + (byte / 128) * BQ * 128 + swizzle_offset<128>(r * 128 + byte % 128)) = val;
      }
    }
    fence_proxy_async();
    named_bar_sync(kBarTurn + NWG + wg, 128);

    const uint32_t q_addr = smem_u32(Qs) + r_base * 128;
    const uint32_t k_addr = smem_u32(smem + L::kKOff);
    const uint32_t v_addr = smem_u32(smem + L::kVOff);
    constexpr int KSTEPS = L::kRowBytes / 32;  // 16 bf16 of depth per product

    float sacc[BKV / 2];  // S, then P in f32 in place
    float oacc[D / 2];
    uint32_t pk[BKV / 8][2];  // P as bf16x2: [8-key column tile][row g, row g + 8]
#pragma unroll
    for (int i = 0; i < D / 2; ++i) oacc[i] = 0.0f;
#pragma unroll
    for (int i = 0; i < BKV / 8; ++i) pk[i][0] = pk[i][1] = 0u;
    float m_run[2] = {NEG_INIT, NEG_INIT};
    float l_run[2] = {0.0f, 0.0f};  // per-thread partial row sums of f32 P

    auto issue_s = [&](int st) {
#pragma unroll
      for (int ks = 0; ks < KSTEPS; ++ks) {
        const int byte = ks * 32, chunk = byte / 128, in = byte % 128;
        const uint64_t da = make_desc(q_addr + chunk * BQ * 128 + in, 16, 1024, 128);
        const uint64_t db = make_desc(k_addr + st * L::kTileBytes + chunk * BKV * 128 + in, 16, 1024, 128);
        if constexpr (BKV == 64) {
          if (ks == 0)
            wgmma_m64n64k16_f32_bf16_ss_init(sacc, da, db);
          else
            wgmma_m64n64k16_f32_bf16_ss(sacc, da, db, 1);
        } else {
          if (ks == 0)
            wgmma_m64n128k16_f32_bf16_ss_init(sacc, da, db);
          else
            wgmma_m64n128k16_f32_bf16_ss(sacc, da, db, 1);
        }
      }
    };
    auto issue_pv = [&](int st) {
#pragma unroll
      for (int kk = 0; kk < BKV / 16; ++kk) {
        const uint32_t a[4] = {pk[2 * kk][0], pk[2 * kk][1], pk[2 * kk + 1][0], pk[2 * kk + 1][1]};
        const uint32_t vk = v_addr + st * L::kTileBytes + kk * 16 * 128;
        const uint64_t db = make_desc(vk, BKV * 128, 1024, 128);
        if constexpr (D == 64) {
          wgmma_m64n64k16_f32_bf16_rs(oacc, a, db, 1);
        } else {
          // At d256 two products of 128 columns (column blocks 0-1, 2-3).
          wgmma_m64n128k16_f32_bf16_rs(*reinterpret_cast<float(*)[64]>(&oacc[0]), a, db, 1);
          if constexpr (D == 256)
            wgmma_m64n128k16_f32_bf16_rs(*reinterpret_cast<float(*)[64]>(&oacc[64]), a,
                                         make_desc(vk + 2 * BKV * 128, BKV * 128, 1024, 128), 1);
        }
      }
    };
    auto s_ready = [&]() {
#pragma unroll
      for (int i = 0; i < BKV / 2; ++i) pin(sacc[i]);
    };
    auto o_ready = [&]() {
#pragma unroll
      for (int i = 0; i < D / 2; ++i) pin(oacc[i]);
#pragma unroll
      for (int i = 0; i < BKV / 8; ++i) pin(pk[i][0]), pin(pk[i][1]);
    };

    // The softmax of tile j in two halves: the first needs only S (m, alpha
    // and P in f32, in place) and runs under the previous tile's PV; the
    // second packs P into pk and rescales O and l once that product is done.
    float alpha[2];
    auto softmax_s = [&](int j) {
      const int key0 = j * BKV;
#pragma unroll
      for (int i = 0; i < BKV / 2; ++i) sacc[i] = __fmul_rn(sacc[i], sm_scale_log2e);
      const int row_lo = q0 + r_base + warp * 16;
      if ((causal && key0 + BKV - 1 > row_lo) || key0 + BKV > Sk) {
#pragma unroll
        for (int i = 0; i < BKV / 2; ++i) {
          const int col = key0 + (i / 4) * 8 + 2 * t + (i & 1);
          const int row = row_lo + g + 8 * ((i >> 1) & 1);
          if (col >= Sk || (causal && col > row)) sacc[i] = MASK_VALUE;
        }
      }
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        float m4[4];  // four independent chains, not one of 32
#pragma unroll
        for (int c = 0; c < 4; ++c) m4[c] = fmaxf(sacc[4 * c + 2 * hf], sacc[4 * c + 2 * hf + 1]);
#pragma unroll
        for (int nt = 4; nt < BKV / 8; ++nt)
          m4[nt & 3] = fmaxf(m4[nt & 3], fmaxf(sacc[4 * nt + 2 * hf], sacc[4 * nt + 2 * hf + 1]));
        float mx = fmaxf(fmaxf(m4[0], m4[1]), fmaxf(m4[2], m4[3]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m_run[hf], mx);
        alpha[hf] = ex2(m_run[hf] - m_new);
        m_run[hf] = m_new;
      }
#pragma unroll
      for (int i = 0; i < BKV / 2; ++i) sacc[i] = ex2(sacc[i] - m_run[(i >> 1) & 1]);
    };
    auto softmax_o = [&]() {
      float lsum[2] = {0.0f, 0.0f};
#pragma unroll
      for (int nt = 0; nt < BKV / 8; ++nt)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const float p0 = sacc[4 * nt + 2 * hf], p1 = sacc[4 * nt + 2 * hf + 1];
          pk[nt][hf] = pack_bf16x2(p0, p1);
          lsum[hf] += p0 + p1;
        }
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) l_run[hf] = alpha[hf] * l_run[hf] + lsum[hf];
#pragma unroll
      for (int i = 0; i < D / 2; ++i) oacc[i] *= alpha[(i >> 1) & 1];
    };

    // Turns as in kernel A: each block of one warpgroup's products (S of
    // the next tile, PV of this one, as two groups) is followed by one of
    // the next warpgroup's; the last warpgroup skips its last hand-over.
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
    softmax_s(0);
    softmax_o();
    // The last tile is peeled off so that no product is issued on a path
    // the compiler cannot prove uniform.
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
      softmax_s(j + 1);
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

    // ---- epilogue ----
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      l_run[hf] += __shfl_xor_sync(0xffffffffu, l_run[hf], 1);
      l_run[hf] += __shfl_xor_sync(0xffffffffu, l_run[hf], 2);
    }
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int row = q0 + r_base + warp * 16 + g + 8 * hf;
      if (row >= Sq) continue;
      const float ls = l_run[hf] == 0.0f ? 1.0f : l_run[hf];
      const long long obase = (qh * Sq + row) * dh;
#pragma unroll
      for (int dt = 0; dt < D / 8; ++dt) {
        if (kPad && dt * 8 >= dh) break;  // columns past the head dim
        const int d = dt * 8 + 2 * t;
        const float o0 = __fdiv_rn(oacc[4 * dt + 2 * hf], ls);
        const float o1 = __fdiv_rn(oacc[4 * dt + 2 * hf + 1], ls);
        if (args.out_f32)
          store2(static_cast<float*>(args.o) + obase + d, o0, o1);
        else
          store2(static_cast<__nv_bfloat16*>(args.o) + obase + d, o0, o1);
      }
    }
  }
}

// Launches the kernel at width D for a call at head dim a.d (kPad when
// a.d < D), packed rows a.pack_row bytes apart.
template <int D, int BITS, bool kPad>
int launch(const Args& a, const void* k, const void* v, int B, cudaStream_t stream) {
  using L = Layout<D, BITS>;
  const cuuint64_t rb = a.pack_row;
  const cuuint64_t dims[3] = {rb, (cuuint64_t)a.Sk, (cuuint64_t)B * a.Hk}, strides[2] = {rb, (cuuint64_t)a.Sk * rb};
  const cuuint32_t box[3] = {(cuuint32_t)rb, (cuuint32_t)L::BKV, 1};
  CUtensorMap k_map, v_map;
  if (!make_tensor_map(&k_map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 3, k, dims, strides, box, CU_TENSOR_MAP_SWIZZLE_NONE) ||
      !make_tensor_map(&v_map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 3, v, dims, strides, box, CU_TENSOR_MAP_SWIZZLE_NONE))
    return (int)cudaErrorInvalidValue;
  auto kern = fused_kv_wgmma_kernel<D, BITS, kPad>;
  constexpr int smem = L::kTotal + 1024;
  const cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((a.Sq + L::BQ - 1) / L::BQ, a.H, B);
  kern<<<grid, 128 * (kNWG<D> + 1), smem, stream>>>(k_map, v_map, a);
  return (int)cudaGetLastError();
}

}  // namespace

// The calls of fused_kv_attention_wgmma_pad.cu: head dim 256, and every
// head dim below its kernel's width (64, 128 or 256).
int fused_kv_pad(const FusedKvArgs& a, const void* k, const void* v, int B, int bits, cudaStream_t stream);
