// Kernels G1 and G2: the FlashAttention-2 backward.
//
// Replace the TPU kernels of lowbit_quant_fa2_paddle_tpu/ops/attention_bwd.py
// launched by _flash_bwd: _bwd_dq_kernel (G1, pallas_call at :302) and
// _bwd_dkv_kernel (G2, pallas_call at :346). From the forward's base-2 LSE and
// di = rowsum(dO * O), for every visible pair (r, c):
//   s2 = q.k * scale2                  scale2 = sm_scale * log2(e)
//   p  = exp2(s2 - lse2[r])
//   dp = dO.v
//   ds = p * (dp - di[r]) * sm_scale
//   G1: dq[r] = sum_c bf16(ds) bf16(k[c])
//   G2: dv[c] = sum_r bf16(p) bf16(dO[r]),  dk[c] = sum_r bf16(ds) bf16(q[r]),
//       with r over every query head of the KV head's group (GQA).
// Float mode: q, k, v, dO arrive as bf16 (the wrapper rounds f32 inputs for
// the tensor cores) and QK^T, dO V^T accumulate in f32. Quantized mode: int8
// per-token codes with f32 scales, as the TPU kernels take them:
//   s2 = (f32(i32(q8.k8)) * (qs * scale2)) * ks,  dp = (f32(i32(dO8.v8)) * dos) * vs;
// G1 folds ks into ds; G2 folds qs into ds and dos into p; the codes enter the
// bf16 products exactly. p and ds stay f32 and are rounded to bf16 only as
// operands. Masks: causal top-left (c <= r), the causal window
// (c + window > r), and rows past Sq or keys past Sk, which give p = 0 (the TPU
// code pads them instead; the sums are the same).
//
// Bound on the H100: the tensor cores. G1 runs three products (QK^T, dO V^T,
// dS K) and G2 four (QK^T, dO V^T, P^T dO, dS^T Q), each 2*D operations per
// visible pair; at b1 h30 s17776 d64 that is 3.64 and 4.85 TFLOP against
// ~0.3 GB of operands. In this simple form the per-pair chain (exp2 and the
// ds products) on the CUDA cores also weighs.
// Design: G1 runs one CTA of 4 warps per (64 q rows, head, batch); each warp
// owns 16 rows, forms S and dP for 16 x 64 keys per KV tile with mma.sync
// (m16n8k16 bf16 or m16n8k32 s8), computes ds in registers and feeds it as
// the A operand of dq += dS K, K's B fragments coming from ldmatrix.trans, so
// S, P and dS never touch shared memory. The loop over KV tiles replaces the
// TPU's sequential grid axis and stops at the causal diagonal and the window.
// G2 runs one CTA per (64 keys, KV head, batch) and forms the transposed
// tiles S^T = K Q^T and dP^T = V dO^T directly (each warp 16 keys), so P^T
// and dS^T are A operands in registers as well: dv += P^T dO, dk += dS^T Q,
// with dO and Q by ldmatrix.trans. No tile is transposed through memory. G2
// walks the (group head, q tile) pairs in a fixed order and keeps dk and dv
// in registers: no atomics, the same sums on every run. Its q tile is 64 rows
// at d64 and 32 at d128, so the two f32 accumulators (2 * D/2 registers a
// thread) leave room for the tiles' products. Tiles stream through a
// two-stage cp.async ring in padded (bank-conflict-free) shared memory; int8
// tiles that feed a bf16 product are widened once in shared memory.
// wgmma/TMA and fusing G1 into G2 are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int NTHREADS = 128;  // 4 warps
constexpr int BQ = 64;         // G1: q rows per CTA (16 per warp)
constexpr int BKV = 64;        // G1: keys per tile; G2: keys per CTA (16 per warp)

struct Args {
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
  int H, Hk, Sq, Sk, causal, window;
  float scale2, ds_scale;
};

// ---------------------------------------------------------------------------
// PTX helpers
// ---------------------------------------------------------------------------

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

template <typename T>
__device__ __forceinline__ uint32_t ld32(const T* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// ROWS rows of CPR 16-byte chunks each, from global rows of src_stride bytes
// (rows row0..) into shared rows of dst_stride bytes, by cp.async. Thread tid
// copies chunk tid % CPR of rows tid / CPR + i * (NTHREADS / CPR). Rows at or
// past n are zero-filled.
template <int ROWS, int CPR>
__device__ __forceinline__ void load_rows(unsigned char* dst, int dst_stride, const unsigned char* src,
                                          long long src_stride, int row0, int n, int tid) {
  constexpr int RPP = NTHREADS / CPR;  // rows per pass
  static_assert(NTHREADS % CPR == 0 && (ROWS % RPP == 0 || RPP % ROWS == 0), "tile rows must split evenly");
  const int r0 = tid / CPR, cc = tid % CPR;
  if (RPP > ROWS && r0 >= ROWS) return;
#pragma unroll
  for (int i = 0; i < (ROWS + RPP - 1) / RPP; ++i) {
    const int r = r0 + i * RPP;
    const bool ok = row0 + r < n;
    cp_async16(dst + r * dst_stride + cc * 16, src + (ok ? row0 + r : 0) * src_stride + cc * 16, ok);
  }
}

// Widen a staged int8 tile (ROWS x D codes, rows of sstride bytes) into a
// bf16 tile (rows of dstride elements): codes are exact in bf16.
template <int ROWS, int D>
__device__ __forceinline__ void widen(const int8_t* src, int sstride, __nv_bfloat16* dst, int dstride, int tid) {
  for (int w = tid; w < ROWS * D / 4; w += NTHREADS) {
    const int r = w / (D / 4), c = w % (D / 4);
    const uint32_t x = ld32(src + r * sstride + 4 * c);
    uint2 out;
    out.x = pack_bf16((float)(int8_t)(x & 0xFF), (float)(int8_t)((x >> 8) & 0xFF));
    out.y = pack_bf16((float)(int8_t)((x >> 16) & 0xFF), (float)(int8_t)(x >> 24));
    *reinterpret_cast<uint2*>(dst + r * dstride + 4 * c) = out;
  }
}

// s = A B^T for a warp: A holds the warp's 16 rows (stride as elements), B
// NT groups of 8 rows (stride bs); the contraction runs over D. bf16 x bf16 ->
// f32 (m16n8k16), or int8 x int8 -> s32 (m16n8k32) returned as f32, exact for
// |sum| < 2^24 (at most 127^2 * 128 here). s[nt] is the accumulator fragment:
// rows g, g+8 of the warp, columns nt*8 + 2t, +1.
template <typename E, int D, int NT>
__device__ __forceinline__ void dot_tile(float (&s)[NT][4], const E* A, int as, const E* B, int bs, int lane) {
  constexpr bool I8 = std::is_same<E, int8_t>::value;
  constexpr int KW = I8 ? 32 : 16;  // contraction per mma
  constexpr int HALF = KW / 2;
  using Acc = typename std::conditional<I8, int, float>::type;
  const int g = lane >> 2, t = lane & 3;
  const int c0 = I8 ? 4 * t : 2 * t;
  Acc acc[NT][4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0;
#pragma unroll
  for (int ks = 0; ks < D / KW; ++ks) {
    const E* ar = A + g * as + ks * KW + c0;
    const uint32_t a[4] = {ld32(ar), ld32(ar + 8 * as), ld32(ar + HALF), ld32(ar + 8 * as + HALF)};
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const E* br = B + (nt * 8 + g) * bs + ks * KW + c0;
      if constexpr (I8)
        mma_s8(acc[nt], a, ld32(br), ld32(br + HALF));
      else
        mma_bf16(acc[nt], a, ld32(br), ld32(br + HALF));
    }
  }
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[nt][e] = (float)acc[nt][e];
}

// acc += X T for a warp: X (16 x 16*KK) is given as the bf16 pairs of an
// accumulator fragment (pa[nt][hf] = columns nt*8 + 2t, +1 of row g + 8*hf),
// which is the A fragment of a k16 step; T is a bf16 tile [16*KK][D] (stride
// ts), whose B fragments come from ldmatrix.trans.
template <int D, int KK>
__device__ __forceinline__ void mma_xt(float (&acc)[D / 8][4], const uint32_t (&pa)[2 * KK][2],
                                       const __nv_bfloat16* T, int ts, int lane) {
#pragma unroll
  for (int kk = 0; kk < KK; ++kk) {
    const uint32_t a[4] = {pa[2 * kk][0], pa[2 * kk][1], pa[2 * kk + 1][0], pa[2 * kk + 1][1]};
    const int row = kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
#pragma unroll
    for (int dp = 0; dp < D / 16; ++dp) {
      uint32_t bv[4];
      ldmatrix_x4_trans(bv, T + row * ts + dp * 16 + (lane >> 4) * 8);
      mma_bf16(acc[2 * dp], a, bv[0], bv[1]);
      mma_bf16(acc[2 * dp + 1], a, bv[2], bv[3]);
    }
  }
}

template <bool QUANT>
using Elem = typename std::conditional<QUANT, int8_t, __nv_bfloat16>::type;

// ---------------------------------------------------------------------------
// G1: dq
// ---------------------------------------------------------------------------

template <int D, bool QUANT>
struct DqSmem {
  using E = Elem<QUANT>;
  static constexpr int kStr = D + 16 / (int)sizeof(E);  // elements per padded row
  static constexpr int kWStr = D + 8;                    // widened bf16 row
  static constexpr int kTile = BQ * kStr * (int)sizeof(E);
  static_assert(BQ == BKV, "Q, dO, K and V tiles share one size");
  static constexpr int kQ = 0;
  static constexpr int kDO = kTile;
  static constexpr int kK = 2 * kTile;  // two stages
  static constexpr int kV = 4 * kTile;  // two stages
  static constexpr int kKW = 6 * kTile;  // widened K (quantized)
  static constexpr int kVec = kKW + (QUANT ? BKV * kWStr * 2 : 0);  // ks, vs per stage (quantized)
  static constexpr int kTotal = kVec + (QUANT ? 2 * 2 * BKV * 4 : 0);
};

template <int D, bool QUANT, typename OutT>
__global__ void __launch_bounds__(NTHREADS) attn_bwd_dq_kernel(const Args a) {
  using L = DqSmem<D, QUANT>;
  using E = typename L::E;
  constexpr int NT = BKV / 8, DT = D / 8;
  constexpr int CPR = D * (int)sizeof(E) / 16;
  constexpr int ROWB = L::kStr * (int)sizeof(E);
  constexpr long long GROW = D * (long long)sizeof(E);  // bytes per global row
  extern __shared__ __align__(16) unsigned char smem[];

  const int H = a.H, Sq = a.Sq, Sk = a.Sk;
  const bool causal = a.causal != 0;
  const int window = causal ? a.window : 0;
  const int nq = (Sq + BQ - 1) / BQ;
  const int qb = causal ? nq - 1 - (int)blockIdx.x : (int)blockIdx.x;  // heaviest first
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (H / a.Hk);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int q0 = qb * BQ;
  const long long qh = (long long)b * H + h, kh = (long long)b * a.Hk + hk;
  const unsigned char* kg = static_cast<const unsigned char*>(a.k) + kh * Sk * GROW;
  const unsigned char* vg = static_cast<const unsigned char*>(a.v) + kh * Sk * GROW;

  load_rows<BQ, CPR>(smem + L::kQ, ROWB, static_cast<const unsigned char*>(a.q) + qh * Sq * GROW, GROW, q0, Sq, tid);
  load_rows<BQ, CPR>(smem + L::kDO, ROWB, static_cast<const unsigned char*>(a.dO) + qh * Sq * GROW, GROW, q0, Sq,
                     tid);
  cp_async_commit();

  // This thread's rows: q0 + warp*16 + g + 8*hf.
  float lse[2], di[2], qs2[2] = {0.0f, 0.0f}, dos[2] = {0.0f, 0.0f};
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int row = q0 + warp * 16 + g + 8 * hf;
    const bool ok = row < Sq;
    const long long i = qh * Sq + (ok ? row : 0);
    lse[hf] = ok ? a.lse[i] : 0.0f;
    di[hf] = ok ? a.di[i] : 0.0f;
    if constexpr (QUANT) {
      qs2[hf] = ok ? __fmul_rn(a.q_scale[i], a.scale2) : 0.0f;
      dos[hf] = ok ? a.do_scale[i] : 0.0f;
    }
  }

  // KV tiles with a visible key: up to the diagonal, from the window's edge.
  const int nkv = (Sk + BKV - 1) / BKV;
  int j_lo = 0, j_hi = nkv - 1;
  if (causal) {
    j_hi = min(j_hi, (q0 + BQ - 1) / BKV);
    if (window > 0) j_lo = max(0, (q0 - window + 1) / BKV);
  }
  const int ntile = j_hi - j_lo + 1;

  auto load_tile = [&](int j, int buf) {
    const int key0 = j * BKV;
    load_rows<BKV, CPR>(smem + L::kK + buf * L::kTile, ROWB, kg, GROW, key0, Sk, tid);
    load_rows<BKV, CPR>(smem + L::kV + buf * L::kTile, ROWB, vg, GROW, key0, Sk, tid);
    if constexpr (QUANT) {
      // Threads 0-63 copy the tile's k scales, 64-127 its v scales.
      static_assert(NTHREADS == 2 * BKV, "one scale per thread");
      float* vec = reinterpret_cast<float*>(smem + L::kVec) + buf * 2 * BKV;
      const int r = tid & (BKV - 1);
      const bool ok = key0 + r < Sk;
      cp_async4(vec + tid, (tid < BKV ? a.k_scale : a.v_scale) + kh * Sk + (ok ? key0 + r : 0), ok);
    }
  };

  float acc[DT][4];
#pragma unroll
  for (int i = 0; i < DT; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.0f;

  if (ntile > 0) load_tile(j_lo, 0);
  cp_async_commit();
  for (int it = 0; it < ntile; ++it) {
    const int j = j_lo + it, buf = it & 1;
    if (it + 1 < ntile) load_tile(j + 1, buf ^ 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();

    const E* Kt = reinterpret_cast<const E*>(smem + L::kK + buf * L::kTile);
    const E* Vt = reinterpret_cast<const E*>(smem + L::kV + buf * L::kTile);
    const __nv_bfloat16* Kb;  // K as the bf16 operand of dS K
    int kbs;
    if constexpr (QUANT) {
      __nv_bfloat16* W = reinterpret_cast<__nv_bfloat16*>(smem + L::kKW);
      widen<BKV, D>(Kt, L::kStr, W, L::kWStr, tid);
      __syncthreads();
      Kb = W;
      kbs = L::kWStr;
    } else {
      Kb = Kt;
      kbs = L::kStr;
    }

    float s[NT][4], dpv[NT][4];
    dot_tile<E, D, NT>(s, reinterpret_cast<const E*>(smem + L::kQ) + warp * 16 * L::kStr, L::kStr, Kt, L::kStr,
                       lane);
    dot_tile<E, D, NT>(dpv, reinterpret_cast<const E*>(smem + L::kDO) + warp * 16 * L::kStr, L::kStr, Vt, L::kStr,
                       lane);

    const int key0 = j * BKV, r0 = q0 + warp * 16;
    const bool need_mask = r0 + 15 >= Sq || key0 + BKV > Sk || (causal && key0 + BKV - 1 > r0) ||
                           (window > 0 && key0 + window <= r0 + 15);
    const float* sc = QUANT ? reinterpret_cast<const float*>(smem + L::kVec) + buf * 2 * BKV : nullptr;
    uint32_t pa[NT][2];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        float d2[2];
#pragma unroll
        for (int e2 = 0; e2 < 2; ++e2) {
          const int e = 2 * hf + e2;
          const int cl = nt * 8 + 2 * t + e2;  // key within the tile
          float s2, dp;
          if constexpr (QUANT) {
            s2 = __fmul_rn(__fmul_rn(s[nt][e], qs2[hf]), sc[cl]);
            dp = __fmul_rn(__fmul_rn(dpv[nt][e], dos[hf]), sc[BKV + cl]);
          } else {
            s2 = __fmul_rn(s[nt][e], a.scale2);
            dp = dpv[nt][e];
          }
          float p = exp2f(s2 - lse[hf]);
          if (need_mask) {
            const int row = r0 + g + 8 * hf, col = key0 + cl;
            if (row >= Sq || col >= Sk || (causal && (col > row || (window > 0 && col + window <= row)))) p = 0.0f;
          }
          float ds = __fmul_rn(__fmul_rn(p, dp - di[hf]), a.ds_scale);
          if constexpr (QUANT) ds = __fmul_rn(ds, sc[cl]);
          d2[e2] = ds;
        }
        pa[nt][hf] = pack_bf16(d2[0], d2[1]);
      }
    mma_xt<D, BKV / 16>(acc, pa, Kb, kbs, lane);
    __syncthreads();
  }
  cp_async_wait<0>();

#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int row = q0 + warp * 16 + g + 8 * hf;
    if (row >= Sq) continue;
    OutT* o = static_cast<OutT*>(a.dq) + (qh * Sq + row) * D;
#pragma unroll
    for (int dt = 0; dt < DT; ++dt) store2(o + dt * 8 + 2 * t, acc[dt][2 * hf], acc[dt][2 * hf + 1]);
  }
}

// ---------------------------------------------------------------------------
// G2: dk, dv
// ---------------------------------------------------------------------------

template <int D, bool QUANT>
struct DkvSmem {
  using E = Elem<QUANT>;
  static constexpr int QT = D == 64 ? 64 : 32;  // q rows per inner tile
  static constexpr int kStr = D + 16 / (int)sizeof(E);
  static constexpr int kWStr = D + 8;
  static constexpr int kKVTile = BKV * kStr * (int)sizeof(E);
  static constexpr int kQTile = QT * kStr * (int)sizeof(E);
  static constexpr int kNV = QUANT ? 4 : 2;  // per-row vectors: lse, di (, qs, dos)
  static constexpr int kK = 0;
  static constexpr int kV = kKVTile;
  static constexpr int kQ = 2 * kKVTile;         // two stages
  static constexpr int kDO = kQ + 2 * kQTile;    // two stages
  static constexpr int kW = kDO + 2 * kQTile;    // widened Q and dO (quantized)
  static constexpr int kWTile = QUANT ? QT * kWStr * 2 : 0;
  static constexpr int kVec = kW + 2 * kWTile;
  static constexpr int kTotal = kVec + 2 * kNV * QT * 4;
};

template <int D, bool QUANT, typename OutT>
__global__ void __launch_bounds__(NTHREADS) attn_bwd_dkv_kernel(const Args a) {
  using L = DkvSmem<D, QUANT>;
  using E = typename L::E;
  constexpr int QT = L::QT, NT = QT / 8, DT = D / 8;
  constexpr int CPR = D * (int)sizeof(E) / 16;
  constexpr int ROWB = L::kStr * (int)sizeof(E);
  constexpr long long GROW = D * (long long)sizeof(E);
  extern __shared__ __align__(16) unsigned char smem[];

  const int H = a.H, Hk = a.Hk, G = H / Hk, Sq = a.Sq, Sk = a.Sk;
  const bool causal = a.causal != 0;
  const int window = causal ? a.window : 0;
  const int hk = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int k0 = blockIdx.x * BKV;
  const long long kh = (long long)b * Hk + hk;

  load_rows<BKV, CPR>(smem + L::kK, ROWB, static_cast<const unsigned char*>(a.k) + kh * Sk * GROW, GROW, k0, Sk, tid);
  load_rows<BKV, CPR>(smem + L::kV, ROWB, static_cast<const unsigned char*>(a.v) + kh * Sk * GROW, GROW, k0, Sk, tid);
  cp_async_commit();

  // This thread's keys: k0 + warp*16 + g + 8*hf.
  float ks[2] = {0.0f, 0.0f}, vs[2] = {0.0f, 0.0f};
  if constexpr (QUANT) {
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int key = k0 + warp * 16 + g + 8 * hf;
      if (key < Sk) {
        ks[hf] = a.k_scale[kh * Sk + key];
        vs[hf] = a.v_scale[kh * Sk + key];
      }
    }
  }

  // q tiles with a row that sees one of these keys: from the diagonal, up to
  // the window's edge; walked for each head of the group.
  const int nq = (Sq + QT - 1) / QT;
  int i_lo = 0, i_hi = nq - 1;
  if (causal) {
    i_lo = k0 / QT;
    if (window > 0) i_hi = min(i_hi, (k0 + BKV - 1 + window - 1) / QT);
  }
  const int ni = max(0, i_hi - i_lo + 1);
  const int n = G * ni;

  auto load_tile = [&](int idx, int buf) {
    const int gi = idx / ni, q0 = (i_lo + idx % ni) * QT;
    const long long qh = (long long)b * H + hk * G + gi;
    load_rows<QT, CPR>(smem + L::kQ + buf * L::kQTile, ROWB, static_cast<const unsigned char*>(a.q) + qh * Sq * GROW,
                       GROW, q0, Sq, tid);
    load_rows<QT, CPR>(smem + L::kDO + buf * L::kQTile, ROWB,
                       static_cast<const unsigned char*>(a.dO) + qh * Sq * GROW, GROW, q0, Sq, tid);
    float* vec = reinterpret_cast<float*>(smem + L::kVec) + buf * L::kNV * QT;
    for (int x = tid; x < L::kNV * QT; x += NTHREADS) {
      const int which = x / QT, r = x % QT;
      const bool ok = q0 + r < Sq;
      const float* src = which == 0 ? a.lse : which == 1 ? a.di : which == 2 ? a.q_scale : a.do_scale;
      cp_async4(vec + x, src + qh * Sq + (ok ? q0 + r : 0), ok);
    }
  };

  float dk[DT][4], dv[DT][4];
#pragma unroll
  for (int i = 0; i < DT; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[i][e] = dv[i][e] = 0.0f;

  if (n > 0) load_tile(0, 0);
  cp_async_commit();
  for (int idx = 0; idx < n; ++idx) {
    const int buf = idx & 1;
    if (idx + 1 < n) load_tile(idx + 1, buf ^ 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();

    const int q0 = (i_lo + idx % ni) * QT;
    const E* Qt = reinterpret_cast<const E*>(smem + L::kQ + buf * L::kQTile);
    const E* dOt = reinterpret_cast<const E*>(smem + L::kDO + buf * L::kQTile);
    const __nv_bfloat16 *Qb, *dOb;  // Q and dO as the bf16 operands of dk and dv
    int bs;
    if constexpr (QUANT) {
      __nv_bfloat16* W = reinterpret_cast<__nv_bfloat16*>(smem + L::kW);
      widen<QT, D>(Qt, L::kStr, W, L::kWStr, tid);
      widen<QT, D>(dOt, L::kStr, W + QT * L::kWStr, L::kWStr, tid);
      __syncthreads();
      Qb = W;
      dOb = W + QT * L::kWStr;
      bs = L::kWStr;
    } else {
      Qb = Qt;
      dOb = dOt;
      bs = L::kStr;
    }
    const float* vec = reinterpret_cast<const float*>(smem + L::kVec) + buf * L::kNV * QT;

    // S^T and dP^T for this warp's 16 keys x QT rows.
    float st[NT][4], dpt[NT][4];
    dot_tile<E, D, NT>(st, reinterpret_cast<const E*>(smem + L::kK) + warp * 16 * L::kStr, L::kStr, Qt, L::kStr,
                       lane);
    dot_tile<E, D, NT>(dpt, reinterpret_cast<const E*>(smem + L::kV) + warp * 16 * L::kStr, L::kStr, dOt, L::kStr,
                       lane);

    const int c0 = k0 + warp * 16;
    const bool need_mask = c0 + 15 >= Sk || q0 + QT > Sq || (causal && c0 + 15 > q0) ||
                           (window > 0 && c0 + window <= q0 + QT - 1);
    uint32_t pp[NT][2], pd[NT][2];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        float p2[2], d2[2];
#pragma unroll
        for (int e2 = 0; e2 < 2; ++e2) {
          const int e = 2 * hf + e2;
          const int rl = nt * 8 + 2 * t + e2;  // q row within the tile
          const float lse = vec[rl], di = vec[QT + rl];
          float s2, dp, qs = 0.0f, dos = 0.0f;
          if constexpr (QUANT) {
            qs = vec[2 * QT + rl];
            dos = vec[3 * QT + rl];
            s2 = __fmul_rn(__fmul_rn(st[nt][e], __fmul_rn(qs, a.scale2)), ks[hf]);
            dp = __fmul_rn(__fmul_rn(dpt[nt][e], dos), vs[hf]);
          } else {
            s2 = __fmul_rn(st[nt][e], a.scale2);
            dp = dpt[nt][e];
          }
          float p = exp2f(s2 - lse);
          if (need_mask) {
            const int key = c0 + g + 8 * hf, row = q0 + rl;
            if (row >= Sq || key >= Sk || (causal && (key > row || (window > 0 && key + window <= row)))) p = 0.0f;
          }
          float ds = __fmul_rn(__fmul_rn(p, dp - di), a.ds_scale);
          if constexpr (QUANT) {
            p = __fmul_rn(p, dos);
            ds = __fmul_rn(ds, qs);
          }
          p2[e2] = p;
          d2[e2] = ds;
        }
        pp[nt][hf] = pack_bf16(p2[0], p2[1]);
        pd[nt][hf] = pack_bf16(d2[0], d2[1]);
      }
    mma_xt<D, QT / 16>(dv, pp, dOb, bs, lane);
    mma_xt<D, QT / 16>(dk, pd, Qb, bs, lane);
    __syncthreads();
  }
  cp_async_wait<0>();

#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int key = k0 + warp * 16 + g + 8 * hf;
    if (key >= Sk) continue;
    OutT* ok_ = static_cast<OutT*>(a.dk) + (kh * Sk + key) * D;
    OutT* ov = static_cast<OutT*>(a.dv) + (kh * Sk + key) * D;
#pragma unroll
    for (int dt = 0; dt < DT; ++dt) {
      store2(ok_ + dt * 8 + 2 * t, dk[dt][2 * hf], dk[dt][2 * hf + 1]);
      store2(ov + dt * 8 + 2 * t, dv[dt][2 * hf], dv[dt][2 * hf + 1]);
    }
  }
}

// ---------------------------------------------------------------------------
// Launch
// ---------------------------------------------------------------------------

template <typename Kern>
int launch_kernel(Kern kern, dim3 grid, int smem, const Args& a, cudaStream_t st) {
  const cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  kern<<<grid, NTHREADS, smem, st>>>(a);
  return (int)cudaGetLastError();
}

template <int D, bool QUANT>
int launch(const Args& a, int B, int dq_f32, int dkv_f32, int parts, cudaStream_t st) {
  if (parts & 1) {
    constexpr int smem = DqSmem<D, QUANT>::kTotal;
    const dim3 grid((a.Sq + BQ - 1) / BQ, a.H, B);
    const int err = dq_f32 ? launch_kernel(attn_bwd_dq_kernel<D, QUANT, float>, grid, smem, a, st)
                           : launch_kernel(attn_bwd_dq_kernel<D, QUANT, __nv_bfloat16>, grid, smem, a, st);
    if (err != 0) return err;
  }
  if (parts & 2) {
    constexpr int smem = DkvSmem<D, QUANT>::kTotal;
    const dim3 grid((a.Sk + BKV - 1) / BKV, a.Hk, B);
    const int err = dkv_f32 ? launch_kernel(attn_bwd_dkv_kernel<D, QUANT, float>, grid, smem, a, st)
                            : launch_kernel(attn_bwd_dkv_kernel<D, QUANT, __nv_bfloat16>, grid, smem, a, st);
    if (err != 0) return err;
  }
  return 0;
}

}  // namespace

// All tensors contiguous, natural layout.
//   q, dO: [B, H, Sq, D];  k, v: [B, Hk, Sk, D]; bf16 (quantized = 0) or int8
//   per-token codes (quantized = 1) with q_scale, do_scale [B, H, Sq] and
//   k_scale, v_scale [B, Hk, Sk] f32.
//   lse: [B, H, Sq] f32, base 2;  di: [B, H, Sq] f32 = rowsum(dO * O).
//   dq: [B, H, Sq, D], dk, dv: [B, Hk, Sk, D]; f32 (dq_f32 / dkv_f32 = 1) or bf16.
//   parts: 1 launches G1 (dq), 2 launches G2 (dk, dv), 3 both, G1 first.
//   window: the causal sliding window (keys c with c + window > r), 0 for none.
//   scale2 = sm_scale * log2(e);  ds_scale = scale2 / log2(e).
// Returns cudaGetLastError() (cudaErrorInvalidValue for an unsupported D or
// missing operands).
extern "C" int lowbit_attn_bwd(const void* q, const void* k, const void* v, const void* dO, const float* lse,
                               const float* di, const float* q_scale, const float* k_scale, const float* v_scale,
                               const float* do_scale, void* dq, void* dk, void* dv, int B, int H, int Hk, int Sq,
                               int Sk, int D, int quantized, int causal, int window, int dq_f32, int dkv_f32,
                               int parts, float scale2, float ds_scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (Hk <= 0 || H % Hk != 0 || Sq < 1 || Sk < 1 || window < 0 || parts < 1 || parts > 3) return (int)cudaErrorInvalidValue;
  if (quantized && (!q_scale || !k_scale || !v_scale || !do_scale)) return (int)cudaErrorInvalidValue;
  if (((parts & 1) && !dq) || ((parts & 2) && (!dk || !dv))) return (int)cudaErrorInvalidValue;
  const Args a{q, k, v, dO, lse, di, q_scale, k_scale, v_scale, do_scale, dq, dk, dv,
               H, Hk, Sq, Sk, causal, window, scale2, ds_scale};
  if (D == 64) return quantized ? launch<64, true>(a, B, dq_f32, dkv_f32, parts, st)
                                : launch<64, false>(a, B, dq_f32, dkv_f32, parts, st);
  if (D == 128) return quantized ? launch<128, true>(a, B, dq_f32, dkv_f32, parts, st)
                                 : launch<128, false>(a, B, dq_f32, dkv_f32, parts, st);
  return (int)cudaErrorInvalidValue;
}
