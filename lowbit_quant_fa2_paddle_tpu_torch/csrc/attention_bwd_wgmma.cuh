// Kernels G1/G2's device code and launch, shared by their instances:
// attention_bwd_wgmma.cu (head dims 64 and 128, and the one C entry) and
// attention_bwd_wgmma_d256.cu (head_dim 256). The design note is in
// attention_bwd_wgmma.cu.

#pragma once

#include <type_traits>

#include "sm90.cuh"

// One call's operands as the kernels take them (the C entry
// lowbit_attn_bwd_wgmma in attention_bwd_wgmma.cu documents them).
struct AttnBwdArgs {
  const void* q;
  const void* k;
  const void* v;
  const void* dO;
  const float* lse;       // [B, H, Sq], base 2
  const float* di;        // [B, H, Sq]
  const float* q_scale;   // [B, H, Sq]   (quantized mode)
  const float* k_scale;   // [B, Hk, Sk]
  const float* v_scale;   // [B, Hk, Sk]
  const float* do_scale;  // [B, H, Sq]
  void* dq;
  void* dk;
  void* dv;
  int H, Hk, Sq, Sk, causal, window, dq_f32, dkv_f32;
  float scale2, ds_scale;
};

// The head_dim-256 instances (attention_bwd_wgmma_d256.cu), to which the C
// entry routes a checked call at D 256.
int attn_bwd_d256(const AttnBwdArgs& a, int B, int quantized, int parts, cudaStream_t st);

namespace {

using namespace sm90;

// Named barriers: 1 .. NWG order G1's consumer warpgroups' products, NWG + 1
// .. 2 NWG close each one's prologue (0 is __syncthreads).
constexpr int kBarTurn = 1;

using Args = AttnBwdArgs;

// How the _ss products read a row of q, k, v or dO: RB bytes (bf16 or int8
// codes), in column blocks of SW bytes, SW the swizzle width.
template <int D, bool Q8>
struct Row {
  static constexpr int RB = Q8 ? D : 2 * D;
  static constexpr int SW = RB >= 128 ? 128 : 64;
};

// Rows [row0, row0 + 64) of a [rows, RB bytes] matrix (rows at or past n as
// zeros) into swizzled shared memory at CTA row r0 of a tile of R rows, by
// the 128 threads of one warpgroup.
template <int RB, int SW, int R>
__device__ __forceinline__ void load_rows(unsigned char* tile, int r0, const unsigned char* src, int row0, int n,
                                          int tid) {
  constexpr int CPR = RB / 16;  // 16-byte chunks per row
  for (int c = tid; c < 64 * CPR; c += 128) {
    const int r = r0 + c / CPR, byte = (c % CPR) * 16;
    int4 val = make_int4(0, 0, 0, 0);
    if (row0 + c / CPR < n) val = *reinterpret_cast<const int4*>(src + (long long)(row0 + c / CPR) * RB + byte);
    *reinterpret_cast<int4*>(tile + (byte / SW) * R * SW + swizzle_offset<SW>(r * SW + byte % SW)) = val;
  }
}

// Widen a tile of R rows of D int8 codes (rows of SW = D bytes, swizzled;
// at d256 two column blocks of SW = 128 bytes, R rows apart) into a bf16
// tile of 128-byte-swizzled 64-column halves, by the 128 threads of the
// producer warpgroup.
template <int D, int SW, int R>
__device__ __forceinline__ void widen(const unsigned char* src, unsigned char* dst, int ptid) {
#pragma unroll 2
  for (int i = 0; i < R * D / 8 / 128; ++i) {
    const int w = ptid + 128 * i;
    const int r = w / (D / 8), c = 8 * (w % (D / 8));
    uint2 x;
    if constexpr (D > SW)
      x = *reinterpret_cast<const uint2*>(src + (c / SW) * R * SW + swizzle_offset<SW>(r * SW + c % SW));
    else
      x = *reinterpret_cast<const uint2*>(src + swizzle_offset<SW>(r * SW + c));
    *reinterpret_cast<uint4*>(dst + (c / 64) * R * 128 + swizzle_offset<128>(r * 128 + (c % 64) * 2)) =
        make_uint4(i8x2_to_bf16x2<0>(x.x), i8x2_to_bf16x2<2>(x.x), i8x2_to_bf16x2<0>(x.y), i8x2_to_bf16x2<2>(x.y));
  }
}

// One _ss product d = A B^T over RB bytes of contraction (bf16 k16 or s8
// k32 steps of 32 bytes; K-major, SW-swizzled column blocks of A and B RA /
// RBt rows apart), N = 64.
template <int RB, int SW, int RA, int RBt, typename Acc>
__device__ __forceinline__ void product_ss(Acc (&d)[32], uint32_t a_addr, uint32_t b_addr) {
#pragma unroll
  for (int ks = 0; ks < RB / 32; ++ks) {
    const int byte = ks * 32, chunk = byte / SW, in = byte % SW;
    const uint64_t da = make_desc(a_addr + chunk * RA * SW + in, 16, 8 * SW, SW);
    const uint64_t db = make_desc(b_addr + chunk * RBt * SW + in, 16, 8 * SW, SW);
    if constexpr (std::is_same<Acc, int>::value) {
      if (ks == 0)
        wgmma_m64n64k32_s32_s8_ss_init(d, da, db);
      else
        wgmma_m64n64k32_s32_s8_ss(d, da, db, 1);
    } else {
      if (ks == 0)
        wgmma_m64n64k16_f32_bf16_ss_init(d, da, db);
      else
        wgmma_m64n64k16_f32_bf16_ss(d, da, db, 1);
    }
  }
}

// d = A B^T with A (64 rows x RB bytes) from registers, a[ks] the A
// fragment of 32-byte contraction step ks (bf16 k16 or s8 k32: the 32-bit
// words at bytes 4t and 16 + 4t of rows g and g + 8 of each warp's 16), and
// B as in product_ss.
template <int RB, int SW, int RBt, typename Acc>
__device__ __forceinline__ void product_rs_kb(Acc (&d)[32], const uint32_t (&a)[RB / 32][4], uint32_t b_addr) {
#pragma unroll
  for (int ks = 0; ks < RB / 32; ++ks) {
    const int byte = ks * 32;
    const uint64_t db = make_desc(b_addr + (byte / SW) * RBt * SW + byte % SW, 16, 8 * SW, SW);
    if constexpr (std::is_same<Acc, int>::value) {
      if (ks == 0)
        wgmma_m64n64k32_s32_s8_rs_init(d, a[ks], db);
      else
        wgmma_m64n64k32_s32_s8_rs(d, a[ks], db, 1);
    } else {
      if (ks == 0)
        wgmma_m64n64k16_f32_bf16_rs_kb_init(d, a[ks], db);
      else
        wgmma_m64n64k16_f32_bf16_rs_kb(d, a[ks], db, 1);
    }
  }
}

// The A fragments of rows r0 and r0 + 8 (this thread's, of a [rows, RB
// bytes] matrix; rows at or past n as zeros) for product_rs_kb.
template <int RB>
__device__ __forceinline__ void load_fragments(uint32_t (&a)[RB / 32][4], const unsigned char* src, int r0, int n,
                                               int t) {
#pragma unroll
  for (int ks = 0; ks < RB / 32; ++ks)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int row = r0 + 8 * (j & 1);
      const unsigned char* at = src + (long long)row * RB + ks * 32 + (j >> 1) * 16 + 4 * t;
      a[ks][j] = row < n ? *reinterpret_cast<const uint32_t*>(at) : 0u;
    }
}

// acc += X T for 64 rows: X (64 x 64) as packed bf16 pairs in the
// accumulator layout (x[nt][hf]: columns 8 nt + 2t, +1 of row g + 8 hf), T a
// swizzled tile of 64 rows of D read MN-major (column halves R rows apart);
// at d256 two products of 128 columns (T's column halves 0-1, then 2-3).
template <int D, int R>
__device__ __forceinline__ void product_rs(float (&acc)[D / 2], const uint32_t (&x)[8][2], uint32_t t_addr) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint32_t a[4] = {x[2 * kk][0], x[2 * kk][1], x[2 * kk + 1][0], x[2 * kk + 1][1]};
    const uint64_t db = make_desc(t_addr + kk * 16 * 128, R * 128, 1024, 128);
    if constexpr (D == 64) {
      wgmma_m64n64k16_f32_bf16_rs(acc, a, db, 1);
    } else if constexpr (D == 256) {
      wgmma_m64n128k16_f32_bf16_rs(*reinterpret_cast<float(*)[64]>(&acc[0]), a, db, 1);
      wgmma_m64n128k16_f32_bf16_rs(*reinterpret_cast<float(*)[64]>(&acc[64]), a,
                                   make_desc(t_addr + 2 * R * 128 + kk * 16 * 128, R * 128, 1024, 128), 1);
    } else {
      wgmma_m64n128k16_f32_bf16_rs(acc, a, db, 1);
    }
  }
}

template <typename T, int N>
__device__ __forceinline__ void pin_all(T (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) pin(r[i]);
}
__device__ __forceinline__ void pin_all(uint32_t (&r)[8][2]) {
#pragma unroll
  for (int i = 0; i < 8; ++i) pin(r[i][0]), pin(r[i][1]);
}

// p and ds are written over the products they come from: f32 values as
// they are, or as the bits of an s32 accumulator (quantized mode), so they
// take no registers of their own.
__device__ __forceinline__ float f32_bits(float x) { return x; }
__device__ __forceinline__ float f32_bits(int x) { return __int_as_float(x); }
__device__ __forceinline__ void set_f32(float& r, float x) { r = x; }
__device__ __forceinline__ void set_f32(int& r, float x) { r = __float_as_int(x); }

// The 64 x 64 f32 tile x (accumulator layout, see f32_bits) as bf16 pairs.
template <typename Acc>
__device__ __forceinline__ void pack_tile(uint32_t (&out)[8][2], const Acc (&x)[32]) {
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf)
      out[nt][hf] = pack_bf16x2(f32_bits(x[4 * nt + 2 * hf]), f32_bits(x[4 * nt + 2 * hf + 1]));
}

__device__ __forceinline__ bool hidden(int row, int col, int Sq, int Sk, bool causal, int window) {
  return row >= Sq || col >= Sk || (causal && (col > row || (window > 0 && col + window <= row)));
}

__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  return p + ((1024 - (smem_u32(p) & 1023)) & 1023);
}

// ---------------------------------------------------------------------------
// G1: dq
// ---------------------------------------------------------------------------

// At d256 one consumer warpgroup (its dq is 128 f32 registers a thread, S
// and dP 64 more) and 2 stages: the resident 64 Q and dO rows and a stage of
// K and V take 64 KB each in bf16.
template <int D, bool Q8>
struct DqLayout {
  static constexpr int NWG = D == 64 ? 3 : D == 128 ? 2 : 1;  // consumer warpgroups
  static constexpr int BQ = 64 * NWG;          // q rows per CTA
  static constexpr int BKV = 64;               // keys per tile
  static constexpr int kStages = D == 256 ? 2 : 4;
  static constexpr int RB = Row<D, Q8>::RB, SW = Row<D, Q8>::SW;
  static constexpr int kQBytes = BQ * RB;       // Q, and dO
  static constexpr int kTileBytes = BKV * RB;   // a K or a V tile as loaded
  static constexpr int kWBytes = Q8 ? BKV * D * 2 : 0;  // K widened to bf16
  static constexpr int kSBytes = Q8 ? 2 * BKV * 4 : 0;  // k and v scales of a tile
  static constexpr int kQOff = 0;
  static constexpr int kDOOff = kQBytes;
  static constexpr int kKOff = 2 * kQBytes;
  static constexpr int kVOff = kKOff + kStages * kTileBytes;
  static constexpr int kWOff = kVOff + kStages * kTileBytes;
  static constexpr int kSOff = kWOff + kStages * kWBytes;
  static constexpr int kBarOff = kSOff + kStages * kSBytes;
  static constexpr int kTotal = kBarOff + 3 * kStages * 8;
  static_assert(kTotal + 1024 <= 232448, "G1's shared memory exceeds a CTA's 227 KB");
};

template <int D, bool Q8>
__global__ void __launch_bounds__(128 * (DqLayout<D, Q8>::NWG + 1), 1)
    attn_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap k_map, const __grid_constant__ CUtensorMap v_map,
                             const Args a) {
  using L = DqLayout<D, Q8>;
  using Acc = typename std::conditional<Q8, int, float>::type;
  constexpr int NWG = L::NWG, BQ = L::BQ, BKV = L::BKV, S = L::kStages, RB = L::RB, SW = L::SW;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::kBarOff);
  uint64_t* empty = full + S;
  uint64_t* staged = empty + S;  // the int8 tiles' TMA loads (quantized)

  const int H = a.H, Sq = a.Sq, Sk = a.Sk;
  const bool causal = a.causal != 0;
  const int window = causal ? a.window : 0;
  const int nq = (Sq + BQ - 1) / BQ;
  const int qb = causal ? nq - 1 - (int)blockIdx.x : (int)blockIdx.x;  // heaviest first
  const int h = blockIdx.y, b = blockIdx.z;
  const int kh = b * a.Hk + h / (H / a.Hk);
  const int q0 = qb * BQ;
  // KV tiles with a visible key: up to the diagonal, from the window's edge.
  // A CTA whose rows see no key runs one tile, masked whole.
  int j_lo = 0, j_hi = (Sk + BKV - 1) / BKV - 1;
  if (causal) {
    j_hi = min(j_hi, (q0 + BQ - 1) / BKV);
    if (window > 0) j_lo = min(j_hi, max(0, (q0 - window + 1) / BKV));
  }
  const int n_tiles = j_hi - j_lo + 1;

  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      // Arrivals: the TMA thread's, or (quantized) the producer warpgroup's
      // after widening K and copying the scales.
      mbar_init(&full[s], Q8 ? 128 : 1);
      mbar_init(&empty[s], 4 * NWG);  // lane 0 of each consumer warp
      mbar_init(&staged[s], 1);
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == NWG) {
    // ---- producer ----
    if constexpr (NWG > 1) setmaxnreg_dec<NWG == 2 ? 40 : 32>();
    const int ptid = threadIdx.x - 128 * NWG;
    if (ptid == 0) {
      tma_prefetch_desc(&k_map);
      tma_prefetch_desc(&v_map);
    }
    if (Q8 || ptid == 0) {
      for (int i = 0; i < n_tiles; ++i) {
        const int st = i % S, key0 = (j_lo + i) * BKV;
        const uint32_t parity = (i / S) & 1;
        mbar_wait(&empty[st], parity ^ 1);
        unsigned char* Kt = smem + L::kKOff + st * L::kTileBytes;
        unsigned char* Vt = smem + L::kVOff + st * L::kTileBytes;
        uint64_t* bar = Q8 ? &staged[st] : &full[st];
        if (ptid == 0) {
          mbar_arrive_expect_tx(bar, 2 * L::kTileBytes);
#pragma unroll
          for (int c = 0; c < RB / SW; ++c) {
            tma_load_3d(Kt + c * BKV * SW, &k_map, bar, c * SW / (Q8 ? 1 : 2), key0, kh);
            tma_load_3d(Vt + c * BKV * SW, &v_map, bar, c * SW / (Q8 ? 1 : 2), key0, kh);
          }
        }
        if constexpr (Q8) {
          float* sc = reinterpret_cast<float*>(smem + L::kSOff + st * L::kSBytes);
          if (ptid < BKV) {
            const bool ok = key0 + ptid < Sk;
            sc[ptid] = ok ? a.k_scale[(long long)kh * Sk + key0 + ptid] : 0.0f;
            sc[BKV + ptid] = ok ? a.v_scale[(long long)kh * Sk + key0 + ptid] : 0.0f;
          }
          mbar_wait(&staged[st], parity);
          widen<D, SW, BKV>(Kt, smem + L::kWOff + st * L::kWBytes, ptid);
          fence_proxy_async();
          mbar_arrive(&full[st]);
        }
      }
    }
    return;
  }

  // ---- consumers: warpgroup wg owns CTA rows 64*wg .. 64*wg + 63 ----
  if constexpr (NWG > 1) setmaxnreg_inc<NWG == 2 ? 232 : 160>();
  const int tid = threadIdx.x & 127, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int r_base = 64 * wg;
  const long long qh = (long long)b * H + h;
  const float scale2 = a.scale2, ds_scale = a.ds_scale;
  // This thread's rows: q0 + r_base + warp*16 + g + 8*hf. Rows past Sq take
  // lse = di = 0 (and zero scales) over zero Q and dO rows, so their ds is 0
  // (never stored).
  const int row_lo = q0 + r_base + warp * 16;
  load_rows<RB, SW, BQ>(smem + L::kQOff, r_base, static_cast<const unsigned char*>(a.q) + qh * Sq * RB, q0 + r_base,
                        Sq, tid);
  load_rows<RB, SW, BQ>(smem + L::kDOOff, r_base, static_cast<const unsigned char*>(a.dO) + qh * Sq * RB,
                        q0 + r_base, Sq, tid);
  float lse[2], di[2], qs2[2] = {0.0f, 0.0f}, dos[2] = {0.0f, 0.0f};
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int row = row_lo + g + 8 * hf;
    const bool ok = row < Sq;
    lse[hf] = ok ? a.lse[qh * Sq + row] : 0.0f;
    di[hf] = ok ? a.di[qh * Sq + row] : 0.0f;
    if constexpr (Q8) {
      qs2[hf] = ok ? __fmul_rn(a.q_scale[qh * Sq + row], scale2) : 0.0f;
      dos[hf] = ok ? a.do_scale[qh * Sq + row] : 0.0f;
    }
  }
  fence_proxy_async();
  named_bar_sync(kBarTurn + NWG + wg, 128);

  const uint32_t q_addr = smem_u32(smem + L::kQOff) + r_base * SW;
  const uint32_t do_addr = smem_u32(smem + L::kDOOff) + r_base * SW;
  const uint32_t k_addr = smem_u32(smem + L::kKOff), v_addr = smem_u32(smem + L::kVOff);
  // K as the bf16 operand of dS K: the tile itself, or its widened copy.
  const uint32_t kb_addr = Q8 ? smem_u32(smem + L::kWOff) : k_addr;
  constexpr int kKbStride = Q8 ? L::kWBytes : L::kTileBytes;

  Acc sacc[32], pacc[32];  // S and dP; ds is written over S
  float dq[D / 2];
  uint32_t dsk[8][2];  // dS as bf16x2: [8-key column tile][row g, row g + 8]
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dq[i] = 0.0f;

  auto issue_s = [&](int st) {
    product_ss<RB, SW, BQ, BKV>(sacc, q_addr, k_addr + st * L::kTileBytes);
    product_ss<RB, SW, BQ, BKV>(pacc, do_addr, v_addr + st * L::kTileBytes);
  };
  auto s_ready = [&]() {
    pin_all(sacc);
    pin_all(pacc);
  };
  auto dq_ready = [&]() {
    pin_all(dq);
    pin_all(dsk);
  };
  // ds of tile j (ring stage st), over S; the pair masks only where
  // `masked` (a type, so the unmasked tiles' code holds no mask test).
  auto form_tile = [&](int j, int st, auto masked) {
    const int key0 = j * BKV;
    const float* sc = reinterpret_cast<const float*>(smem + L::kSOff + st * L::kSBytes);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      float2 k2 = make_float2(0.0f, 0.0f), v2 = k2;
      if constexpr (Q8) {
        k2 = *reinterpret_cast<const float2*>(sc + nt * 8 + 2 * t);
        v2 = *reinterpret_cast<const float2*>(sc + BKV + nt * 8 + 2 * t);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = 4 * nt + e, hf = e >> 1;
        const float ks = (e & 1) ? k2.y : k2.x;
        float s2, dp;
        if constexpr (Q8) {
          s2 = __fmul_rn(__fmul_rn((float)sacc[i], qs2[hf]), ks);
          dp = __fmul_rn(__fmul_rn((float)pacc[i], dos[hf]), (e & 1) ? v2.y : v2.x);
        } else {
          s2 = __fmul_rn(sacc[i], scale2);
          dp = pacc[i];
        }
        float p = ex2(s2 - lse[hf]);
        if (decltype(masked)::value &&
            hidden(row_lo + g + 8 * hf, key0 + nt * 8 + 2 * t + (e & 1), Sq, Sk, causal, window))
          p = 0.0f;
        const float ds = __fmul_rn(__fmul_rn(p, dp - di[hf]), ds_scale);
        set_f32(sacc[i], Q8 ? __fmul_rn(ds, ks) : ds);
      }
    }
  };
  // Only ragged, diagonal and window-edge tiles hold hidden pairs.
  auto form_ds = [&](int j, int st) {
    const int key0 = j * BKV;
    if (key0 + BKV > Sk || (causal && (key0 + BKV - 1 > row_lo || (window > 0 && key0 + window <= row_lo + 15))))
      form_tile(j, st, std::true_type{});
    else
      form_tile(j, st, std::false_type{});
  };

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
  form_ds(j_lo, 0);
  pack_tile(dsk, sacc);
  // The last tile's dS K is peeled off so that no product sits on a branch.
  for (int i = 0; i + 1 < n_tiles; ++i) {
    const int st = i % S, st1 = (i + 1) % S;
    mbar_wait(&full[st1], ((i + 1) / S) & 1);
    named_bar_sync(bar_mine, 256);
    wgmma_fence();
    issue_s(st1);
    wgmma_commit();
    product_rs<D, BKV>(dq, dsk, kb_addr + st * kKbStride);
    wgmma_commit();
    named_bar_arrive(bar_other, 256);
    wgmma_wait<1>();
    s_ready();
    form_ds(j_lo + i + 1, st1);
    wgmma_wait<0>();
    dq_ready();
    if (lane == 0) mbar_arrive(&empty[st]);
    pack_tile(dsk, sacc);
  }
  named_bar_sync(bar_mine, 256);
  wgmma_fence();
  product_rs<D, BKV>(dq, dsk, kb_addr + ((n_tiles - 1) % S) * kKbStride);
  wgmma_commit();
  if (wg != NWG - 1) named_bar_arrive(bar_other, 256);
  wgmma_wait<0>();
  dq_ready();

#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int row = row_lo + g + 8 * hf;
    if (row >= Sq) continue;
    const long long o = (qh * Sq + row) * D;
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt) {
      const float x0 = dq[4 * dt + 2 * hf], x1 = dq[4 * dt + 2 * hf + 1];
      if (a.dq_f32)
        store2(static_cast<float*>(a.dq) + o + dt * 8 + 2 * t, x0, x1);
      else
        store2(static_cast<__nv_bfloat16*>(a.dq) + o + dt * 8 + 2 * t, x0, x1);
    }
  }
}

// ---------------------------------------------------------------------------
// G2: dk, dv
// ---------------------------------------------------------------------------

// At d256 dk and dv together would take 256 f32 registers a thread. There
// the two consumer warpgroups split the work over the same 64 keys
// (kSplit): warpgroup 0 makes dv (S^T, then dv += P^T dO), warpgroup 1 dk
// (S^T and dP^T, then dk += dS^T Q), each into one 64 x 256 f32 accumulator;
// both form S^T, so a tile takes five products instead of four. K and V (64
// rows each) stay in shared memory beside a ring of 2 stages of Q and dO;
// in the quantized mode the consumers read the q rows' scales where they lie
// (a stage has no room left for them).
template <int D, bool Q8>
struct DkvLayout {
  static constexpr bool kSplit = D == 256;
  static constexpr int NWG = 2;        // consumer warpgroups
  static constexpr int BK = kSplit ? 64 : 64 * NWG;  // keys per CTA
  static constexpr int QT = 64;        // q rows per streamed tile
  static constexpr bool kOverlap = D == 64;  // next tile's S^T, dP^T under this one's dk, dv
  static constexpr bool kRegA = D == 64;     // K and V as register A operands (their fragments fit at d64)
  static constexpr int RB = Row<D, Q8>::RB, SW = Row<D, Q8>::SW;
  static constexpr int kKBytes = kRegA ? 0 : BK * RB;  // K, and V
  static constexpr int kTileBytes = QT * RB;            // a Q or a dO tile as loaded
  static constexpr int kWBytes = Q8 ? QT * D * 2 : 0;   // Q, and dO, widened to bf16
  static constexpr int kNV = Q8 && !kSplit ? 4 : 2;     // per-row vectors: lse, di (, qs, dos)
  static constexpr int kVecBytes = kNV * QT * 4;
  static constexpr int kStageBytes = 2 * kTileBytes + 2 * kWBytes + kVecBytes;
  static constexpr int kStages = kSplit ? 2 : (2 * kKBytes + 4 * kStageBytes + 2048 <= 232448 ? 4 : 3);
  static constexpr int kKOff = 0;
  static constexpr int kVOff = kKBytes;
  static constexpr int kQOff = 2 * kKBytes;
  static constexpr int kDOOff = kQOff + kStages * kTileBytes;
  static constexpr int kWOff = kDOOff + kStages * kTileBytes;  // per stage: Q, then dO
  static constexpr int kVecOff = kWOff + kStages * 2 * kWBytes;
  static constexpr int kBarOff = kVecOff + kStages * kVecBytes;
  static constexpr int kTotal = kBarOff + 3 * kStages * 8;
  static_assert(kTotal + 1024 <= 232448, "G2's shared memory exceeds a CTA's 227 KB");
};

// The consumers of G2 at d256 (DkvLayout::kSplit): warpgroup 0 makes dv,
// warpgroup 1 dk, over keys k0 .. k0 + 63 of KV head kvh, whose group's
// query heads start at qh0; the n = G * ni streamed tiles as the producer
// walks them.
template <int D, bool Q8>
__device__ __forceinline__ void dkv_split_consumers(unsigned char* smem, uint64_t* full, uint64_t* empty,
                                                    const Args& a, int k0, long long kvh, int qh0, int i_lo,
                                                    int ni, int n, bool causal, int window) {
  using L = DkvLayout<D, Q8>;
  using Acc = typename std::conditional<Q8, int, float>::type;
  constexpr int BK = L::BK, QT = L::QT, S = L::kStages, RB = L::RB, SW = L::SW;
  setmaxnreg_inc<232>();
  const int wg = threadIdx.x / 128;
  const int tid = threadIdx.x & 127, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int Sq = a.Sq, Sk = a.Sk;
  const float scale2 = a.scale2, ds_scale = a.ds_scale;
  const int c_lo = k0 + warp * 16;  // this thread's keys: c_lo + g + 8*hf
  // K's rows by warpgroup 0, V's by warpgroup 1; both use K, and each its
  // keys' scales.
  load_rows<RB, SW, BK>(smem + (wg == 0 ? L::kKOff : L::kVOff), 0,
                        static_cast<const unsigned char*>(wg == 0 ? a.k : a.v) + kvh * Sk * RB, k0, Sk, tid);
  float ks[2] = {0.0f, 0.0f}, vs[2] = {0.0f, 0.0f};
  if constexpr (Q8) {
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int key = c_lo + g + 8 * hf;
      if (key < Sk) {
        ks[hf] = a.k_scale[kvh * Sk + key];
        vs[hf] = a.v_scale[kvh * Sk + key];
      }
    }
  }
  fence_proxy_async();
  named_bar_sync(kBarTurn, 256);  // K and V are in

  const uint32_t k_addr = smem_u32(smem + L::kKOff), v_addr = smem_u32(smem + L::kVOff);
  const uint32_t q_addr = smem_u32(smem + L::kQOff), do_addr = smem_u32(smem + L::kDOOff);
  // Q and dO as the bf16 operands of dk and dv: the tiles, or their widened copies.
  const uint32_t qb_addr = Q8 ? smem_u32(smem + L::kWOff) : q_addr;
  const uint32_t dob_addr = Q8 ? smem_u32(smem + L::kWOff + L::kWBytes) : do_addr;
  constexpr int kBStride = Q8 ? 2 * L::kWBytes : L::kTileBytes;

  auto run = [&](auto dk_role) {
    constexpr bool kDk = decltype(dk_role)::value;
    Acc sacc[32], pacc[kDk ? 32 : 1];  // S^T (and dP^T); p or ds is written over them
    float acc[D / 2];                  // dv, or dk
    uint32_t pk[8][2];                 // P^T or dS^T as bf16x2, accumulator layout
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.0f;
    // p (warpgroup 0, with dos folded in) or ds (warpgroup 1, with qs) of
    // the tile of q rows from q0 of head qh in ring stage st, as G2's
    // form_tile computes them; the pair masks only where `masked`.
    auto form_tile = [&](int q0, int qh, int st, auto masked) {
      const float* vec = reinterpret_cast<const float*>(smem + L::kVecOff + st * L::kVecBytes);
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const float2 l2 = *reinterpret_cast<const float2*>(vec + nt * 8 + 2 * t);
        const float2 d2 = *reinterpret_cast<const float2*>(vec + QT + nt * 8 + 2 * t);
        float q2[2] = {0.0f, 0.0f}, o2[2] = {0.0f, 0.0f};
        if constexpr (Q8) {
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int row = q0 + nt * 8 + 2 * t + c;
            if (row < Sq) {
              q2[c] = a.q_scale[(long long)qh * Sq + row];
              o2[c] = a.do_scale[(long long)qh * Sq + row];
            }
          }
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = 4 * nt + e, hf = e >> 1;
          const float qs = q2[e & 1], dos = o2[e & 1];
          float s2;
          if constexpr (Q8)
            s2 = __fmul_rn(__fmul_rn((float)sacc[i], __fmul_rn(qs, scale2)), ks[hf]);
          else
            s2 = __fmul_rn(sacc[i], scale2);
          float p = ex2(s2 - ((e & 1) ? l2.y : l2.x));
          if (decltype(masked)::value &&
              hidden(q0 + nt * 8 + 2 * t + (e & 1), c_lo + g + 8 * hf, Sq, Sk, causal, window))
            p = 0.0f;
          if constexpr (kDk) {
            float dp;
            if constexpr (Q8)
              dp = __fmul_rn(__fmul_rn((float)pacc[i], dos), vs[hf]);
            else
              dp = pacc[i];
            const float ds = __fmul_rn(__fmul_rn(p, dp - ((e & 1) ? d2.y : d2.x)), ds_scale);
            set_f32(pacc[i], Q8 ? __fmul_rn(ds, qs) : ds);
          } else {
            set_f32(sacc[i], Q8 ? __fmul_rn(p, dos) : p);
          }
        }
      }
    };
    for (int idx = 0; idx < n; ++idx) {
      const int st = idx % S;
      const int q0 = (i_lo + idx % ni) * QT, qh = qh0 + idx / ni;
      mbar_wait(&full[st], (idx / S) & 1);
      wgmma_fence();
      product_ss<RB, SW, BK, QT>(sacc, k_addr, q_addr + st * L::kTileBytes);
      if constexpr (kDk) product_ss<RB, SW, BK, QT>(pacc, v_addr, do_addr + st * L::kTileBytes);
      wgmma_commit();
      wgmma_wait<0>();
      pin_all(sacc);
      if constexpr (kDk) pin_all(pacc);
      // Only ragged, diagonal and window-edge tiles hold hidden pairs.
      if (q0 + QT > Sq || c_lo + 15 >= Sk ||
          (causal && (c_lo + 15 > q0 || (window > 0 && c_lo + window <= q0 + QT - 1))))
        form_tile(q0, qh, st, std::true_type{});
      else
        form_tile(q0, qh, st, std::false_type{});
      if constexpr (kDk)
        pack_tile(pk, pacc);
      else
        pack_tile(pk, sacc);
      wgmma_fence();
      product_rs<D, QT>(acc, pk, (kDk ? qb_addr : dob_addr) + st * kBStride);
      wgmma_commit();
      wgmma_wait<0>();
      pin_all(acc);
      pin_all(pk);
      if (lane == 0) mbar_arrive(&empty[st]);
    }
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int key = c_lo + g + 8 * hf;
      if (key >= Sk) continue;
      const long long o = (kvh * Sk + key) * D;
#pragma unroll
      for (int dt = 0; dt < D / 8; ++dt) {
        const int at = 4 * dt + 2 * hf;
        if (a.dkv_f32)
          store2(static_cast<float*>(kDk ? a.dk : a.dv) + o + dt * 8 + 2 * t, acc[at], acc[at + 1]);
        else
          store2(static_cast<__nv_bfloat16*>(kDk ? a.dk : a.dv) + o + dt * 8 + 2 * t, acc[at], acc[at + 1]);
      }
    }
  };
  if (wg == 0)
    run(std::false_type{});
  else
    run(std::true_type{});
}

template <int D, bool Q8>
__global__ void __launch_bounds__(128 * (DkvLayout<D, Q8>::NWG + 1), 1)
    attn_bwd_dkv_wgmma_kernel(const __grid_constant__ CUtensorMap q_map, const __grid_constant__ CUtensorMap do_map,
                              const Args a) {
  using L = DkvLayout<D, Q8>;
  using Acc = typename std::conditional<Q8, int, float>::type;
  constexpr int NWG = L::NWG, BK = L::BK, QT = L::QT, S = L::kStages, RB = L::RB, SW = L::SW;
  // Producer threads that copy lse, di (and qs, dos): the first warp, or
  // (quantized) the warpgroup, which also widens the tiles.
  constexpr int NP = Q8 ? 128 : 32;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::kBarOff);
  uint64_t* empty = full + S;
  uint64_t* staged = empty + S;

  const int H = a.H, Hk = a.Hk, G = H / Hk, Sq = a.Sq, Sk = a.Sk;
  const bool causal = a.causal != 0;
  const int window = causal ? a.window : 0;
  const int hk = blockIdx.y, b = blockIdx.z;
  const int k0 = blockIdx.x * BK;
  const long long kvh = (long long)b * Hk + hk;
  // q tiles with a row that sees one of these keys: from the diagonal, up to
  // the window's edge; walked for each head of the group. A CTA whose keys
  // no row sees runs one tile, masked whole.
  int i_lo = 0, i_hi = (Sq + QT - 1) / QT - 1;
  if (causal) {
    if (window > 0) i_hi = min(i_hi, (k0 + BK - 1 + window - 1) / QT);
    i_lo = min(i_hi, k0 / QT);
  }
  const int ni = i_hi - i_lo + 1, n = G * ni;

  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      // Arrivals: the TMA thread's (float mode) and the copying threads'.
      mbar_init(&full[s], Q8 ? NP : 1 + NP);
      mbar_init(&empty[s], 4 * NWG);
      mbar_init(&staged[s], 1);
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == NWG) {
    // ---- producer ----
    setmaxnreg_dec<40>();
    const int ptid = threadIdx.x - 128 * NWG;
    if (ptid == 0) {
      tma_prefetch_desc(&q_map);
      tma_prefetch_desc(&do_map);
    }
    if (ptid < NP) {
      for (int idx = 0; idx < n; ++idx) {
        const int st = idx % S;
        const uint32_t parity = (idx / S) & 1;
        const int q0 = (i_lo + idx % ni) * QT;
        const int qh = b * H + hk * G + idx / ni;
        mbar_wait(&empty[st], parity ^ 1);
        unsigned char* Qt = smem + L::kQOff + st * L::kTileBytes;
        unsigned char* dOt = smem + L::kDOOff + st * L::kTileBytes;
        uint64_t* bar = Q8 ? &staged[st] : &full[st];
        if (ptid == 0) {
          mbar_arrive_expect_tx(bar, 2 * L::kTileBytes);
#pragma unroll
          for (int c = 0; c < RB / SW; ++c) {
            tma_load_3d(Qt + c * QT * SW, &q_map, bar, c * SW / (Q8 ? 1 : 2), q0, qh);
            tma_load_3d(dOt + c * QT * SW, &do_map, bar, c * SW / (Q8 ? 1 : 2), q0, qh);
          }
        }
        float* vec = reinterpret_cast<float*>(smem + L::kVecOff + st * L::kVecBytes);
        for (int x = ptid; x < L::kNV * QT; x += NP) {
          const int which = x / QT, r = x % QT;
          const float* src = which == 0 ? a.lse : which == 1 ? a.di : which == 2 ? a.q_scale : a.do_scale;
          vec[x] = q0 + r < Sq ? src[(long long)qh * Sq + q0 + r] : 0.0f;
        }
        if constexpr (Q8) {
          unsigned char* W = smem + L::kWOff + st * 2 * L::kWBytes;
          mbar_wait(&staged[st], parity);
          widen<D, SW, QT>(Qt, W, ptid);
          widen<D, SW, QT>(dOt, W + L::kWBytes, ptid);
          fence_proxy_async();
        }
        mbar_arrive(&full[st]);
      }
    }
    return;
  }
  if constexpr (L::kSplit) {
    dkv_split_consumers<D, Q8>(smem, full, empty, a, k0, kvh, b * H + hk * G, i_lo, ni, n, causal, window);
    return;
  }

  // ---- consumers: warpgroup wg owns keys k0 + 64*wg .. k0 + 64*wg + 63 ----
  setmaxnreg_inc<232>();
  const int tid = threadIdx.x & 127, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int r_base = 64 * wg;
  const float scale2 = a.scale2, ds_scale = a.ds_scale;
  const int c_lo = k0 + r_base + warp * 16;  // this thread's keys: c_lo + g + 8*hf
  const unsigned char* kg = static_cast<const unsigned char*>(a.k) + kvh * Sk * RB;
  const unsigned char* vg = static_cast<const unsigned char*>(a.v) + kvh * Sk * RB;
  uint32_t kf[L::kRegA ? RB / 32 : 1][4], vf[L::kRegA ? RB / 32 : 1][4];  // K, V as A fragments (kRegA)
  if constexpr (L::kRegA) {
    load_fragments<RB>(kf, kg, c_lo + g, Sk, t);
    load_fragments<RB>(vf, vg, c_lo + g, Sk, t);
  } else {
    load_rows<RB, SW, BK>(smem + L::kKOff, r_base, kg, k0 + r_base, Sk, tid);
    load_rows<RB, SW, BK>(smem + L::kVOff, r_base, vg, k0 + r_base, Sk, tid);
  }
  float ks[2] = {0.0f, 0.0f}, vs[2] = {0.0f, 0.0f};
  if constexpr (Q8) {
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int key = c_lo + g + 8 * hf;
      if (key < Sk) {
        ks[hf] = a.k_scale[kvh * Sk + key];
        vs[hf] = a.v_scale[kvh * Sk + key];
      }
    }
  }
  fence_proxy_async();
  named_bar_sync(kBarTurn + NWG + wg, 128);

  const uint32_t k_addr = smem_u32(smem + L::kKOff) + r_base * SW;
  const uint32_t v_addr = smem_u32(smem + L::kVOff) + r_base * SW;
  const uint32_t q_addr = smem_u32(smem + L::kQOff), do_addr = smem_u32(smem + L::kDOOff);
  // Q and dO as the bf16 operands of dk and dv: the tiles, or their widened copies.
  const uint32_t qb_addr = Q8 ? smem_u32(smem + L::kWOff) : q_addr;
  const uint32_t dob_addr = Q8 ? smem_u32(smem + L::kWOff + L::kWBytes) : do_addr;
  constexpr int kBStride = Q8 ? 2 * L::kWBytes : L::kTileBytes;

  Acc sacc[32], pacc[32];  // S^T and dP^T; p and ds are written over them
  float dk[D / 2], dv[D / 2];
  uint32_t pp[8][2], pd[8][2];  // P^T and dS^T as bf16x2, accumulator layout
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.0f;

  auto issue_s = [&](int st) {
    if constexpr (L::kRegA) {
      product_rs_kb<RB, SW, QT>(sacc, kf, q_addr + st * L::kTileBytes);
      product_rs_kb<RB, SW, QT>(pacc, vf, do_addr + st * L::kTileBytes);
    } else {
      product_ss<RB, SW, BK, QT>(sacc, k_addr, q_addr + st * L::kTileBytes);
      product_ss<RB, SW, BK, QT>(pacc, v_addr, do_addr + st * L::kTileBytes);
    }
  };
  auto issue_kv = [&](int st) {
    product_rs<D, QT>(dv, pp, dob_addr + st * kBStride);
    product_rs<D, QT>(dk, pd, qb_addr + st * kBStride);
  };
  auto s_ready = [&]() {
    pin_all(sacc);
    pin_all(pacc);
  };
  auto kv_ready = [&]() {
    pin_all(dk);
    pin_all(dv);
    pin_all(pp);
    pin_all(pd);
  };
  // p and ds of streamed tile idx (ring stage st, q rows from q0), over S^T
  // and dP^T, with the quantized mode's dos folded into p and qs into ds;
  // the pair masks only where `masked` (a type, as in G1).
  auto form_tile = [&](int q0, int st, auto masked) {
    const float* vec = reinterpret_cast<const float*>(smem + L::kVecOff + st * L::kVecBytes);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const float2 l2 = *reinterpret_cast<const float2*>(vec + nt * 8 + 2 * t);
      const float2 d2 = *reinterpret_cast<const float2*>(vec + QT + nt * 8 + 2 * t);
      float2 q2 = make_float2(0.0f, 0.0f), o2 = q2;
      if constexpr (Q8) {
        q2 = *reinterpret_cast<const float2*>(vec + 2 * QT + nt * 8 + 2 * t);
        o2 = *reinterpret_cast<const float2*>(vec + 3 * QT + nt * 8 + 2 * t);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = 4 * nt + e, hf = e >> 1;
        const float qs = (e & 1) ? q2.y : q2.x, dos = (e & 1) ? o2.y : o2.x;
        float s2, dp;
        if constexpr (Q8) {
          s2 = __fmul_rn(__fmul_rn((float)sacc[i], __fmul_rn(qs, scale2)), ks[hf]);
          dp = __fmul_rn(__fmul_rn((float)pacc[i], dos), vs[hf]);
        } else {
          s2 = __fmul_rn(sacc[i], scale2);
          dp = pacc[i];
        }
        float p = ex2(s2 - ((e & 1) ? l2.y : l2.x));
        if (decltype(masked)::value && hidden(q0 + nt * 8 + 2 * t + (e & 1), c_lo + g + 8 * hf, Sq, Sk, causal, window))
          p = 0.0f;
        const float ds = __fmul_rn(__fmul_rn(p, dp - ((e & 1) ? d2.y : d2.x)), ds_scale);
        set_f32(sacc[i], Q8 ? __fmul_rn(p, dos) : p);
        set_f32(pacc[i], Q8 ? __fmul_rn(ds, qs) : ds);
      }
    }
  };
  // Only ragged, diagonal and window-edge tiles hold hidden pairs.
  auto form = [&](int idx, int st) {
    const int q0 = (i_lo + idx % ni) * QT;
    if (q0 + QT > Sq || c_lo + 15 >= Sk || (causal && (c_lo + 15 > q0 || (window > 0 && c_lo + window <= q0 + QT - 1))))
      form_tile(q0, st, std::true_type{});
    else
      form_tile(q0, st, std::false_type{});
  };

  // The two warpgroups issue their products freely: turns as in G1 measured
  // slower here (PERF.md §6).
  if constexpr (L::kOverlap) {
    mbar_wait(&full[0], 0);
    wgmma_fence();
    issue_s(0);
    wgmma_commit();
    wgmma_wait<0>();
    s_ready();
    form(0, 0);
    pack_tile(pp, sacc);
    pack_tile(pd, pacc);
    // The last tile's dk, dv products are peeled off (no product on a branch).
    for (int idx = 0; idx + 1 < n; ++idx) {
      const int st = idx % S, st1 = (idx + 1) % S;
      mbar_wait(&full[st1], ((idx + 1) / S) & 1);
      wgmma_fence();
      issue_s(st1);
      wgmma_commit();
      issue_kv(st);
      wgmma_commit();
      wgmma_wait<1>();
      s_ready();
      form(idx + 1, st1);
      wgmma_wait<0>();
      kv_ready();
      if (lane == 0) mbar_arrive(&empty[st]);
      pack_tile(pp, sacc);
      pack_tile(pd, pacc);
    }
    wgmma_fence();
    issue_kv((n - 1) % S);
    wgmma_commit();
    wgmma_wait<0>();
    kv_ready();
  } else {
    for (int idx = 0; idx < n; ++idx) {
      const int st = idx % S;
      mbar_wait(&full[st], (idx / S) & 1);
      wgmma_fence();
      issue_s(st);
      wgmma_commit();
      wgmma_wait<0>();
      s_ready();
      form(idx, st);
      pack_tile(pp, sacc);
      pack_tile(pd, pacc);
      wgmma_fence();
      issue_kv(st);
      wgmma_commit();
      wgmma_wait<0>();
      kv_ready();
      if (lane == 0) mbar_arrive(&empty[st]);
    }
  }

#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int key = c_lo + g + 8 * hf;
    if (key >= Sk) continue;
    const long long o = (kvh * Sk + key) * D;
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt) {
      const int at = 4 * dt + 2 * hf;
      if (a.dkv_f32) {
        store2(static_cast<float*>(a.dk) + o + dt * 8 + 2 * t, dk[at], dk[at + 1]);
        store2(static_cast<float*>(a.dv) + o + dt * 8 + 2 * t, dv[at], dv[at + 1]);
      } else {
        store2(static_cast<__nv_bfloat16*>(a.dk) + o + dt * 8 + 2 * t, dk[at], dk[at + 1]);
        store2(static_cast<__nv_bfloat16*>(a.dv) + o + dt * 8 + 2 * t, dv[at], dv[at + 1]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Launch
// ---------------------------------------------------------------------------

// A [rows, S, D] tensor map of bf16 values or int8 codes, loading boxes of
// SW bytes x box_rows rows into SW-swizzled tiles.
template <int D, bool Q8>
bool rows_map(CUtensorMap* map, const void* ptr, int S, long long rows, int box_rows) {
  constexpr int E = Q8 ? 1 : 2, SW = Row<D, Q8>::SW;
  const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)S, (cuuint64_t)rows};
  const cuuint64_t strides[2] = {(cuuint64_t)D * E, (cuuint64_t)S * D * E};
  const cuuint32_t box[3] = {SW / E, (cuuint32_t)box_rows, 1};
  return make_tensor_map(map, Q8 ? CU_TENSOR_MAP_DATA_TYPE_UINT8 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, ptr, dims,
                         strides, box, SW == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B);
}

template <typename Kern>
int launch_kernel(Kern kern, const CUtensorMap& m0, const CUtensorMap& m1, dim3 grid, int threads, int smem,
                  const Args& a, cudaStream_t st) {
  const cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  kern<<<grid, threads, smem, st>>>(m0, m1, a);
  return (int)cudaGetLastError();
}

template <int D, bool Q8>
int launch(const Args& a, int B, int parts, cudaStream_t st) {
  CUtensorMap m0, m1;
  if (parts & 1) {
    using L = DqLayout<D, Q8>;
    const long long rows = (long long)B * a.Hk;
    if (!rows_map<D, Q8>(&m0, a.k, a.Sk, rows, L::BKV) || !rows_map<D, Q8>(&m1, a.v, a.Sk, rows, L::BKV))
      return (int)cudaErrorInvalidValue;
    const int err = launch_kernel(attn_bwd_dq_wgmma_kernel<D, Q8>, m0, m1, dim3((a.Sq + L::BQ - 1) / L::BQ, a.H, B),
                                  128 * (L::NWG + 1), L::kTotal + 1024, a, st);
    if (err != 0) return err;
  }
  if (parts & 2) {
    using L = DkvLayout<D, Q8>;
    const long long rows = (long long)B * a.H;
    if (!rows_map<D, Q8>(&m0, a.q, a.Sq, rows, L::QT) || !rows_map<D, Q8>(&m1, a.dO, a.Sq, rows, L::QT))
      return (int)cudaErrorInvalidValue;
    const int err = launch_kernel(attn_bwd_dkv_wgmma_kernel<D, Q8>, m0, m1, dim3((a.Sk + L::BK - 1) / L::BK, a.Hk, B),
                                  128 * (L::NWG + 1), L::kTotal + 1024, a, st);
    if (err != 0) return err;
  }
  return 0;
}

}  // namespace
