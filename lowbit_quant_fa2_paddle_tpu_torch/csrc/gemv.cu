// Kernels F1 and F2: y = x @ W^T with W stored packed, for decode-sized M.
//
// Replaces the TPU kernels lowbit_quant_fa2_paddle_tpu/ops/gemv.py:
//   F1 _wq_pc_kernel / _wq_pc_kernel_int8 (launched by wq_matmul_per_channel,
//      pallas_call at :255): int8 per-channel symmetric codes, rank-1 scale
//      epilogue, bf16/f32 activations or per-token INT8 activations (w8a8);
//   F2 _wq_kernel (launched by wq_matmul_fused, pallas_call at :368): grouped
//      2/4/8-bit unsigned codes packed parts-of-K, and the 4-bit per-channel
//      weights, which the JAX package routes through it with one group per
//      half of K and zero-points -7 * scale.
//
// Math per output (m, n), as in the TPU kernels:
//   F1:       y = out(f32(sum_k x[k] * code[k]) * scale[n])        (f32 sums)
//   F1 w8a8:  y = out((f32(sum_k x8[k] * code[k]) * xs[m]) * scale[n])  (i32)
//   F2:       y1 = out(sum_k x[k] * xt(code[k] * scale[n, g(k)]))
//             y  = out(f32(y1) + sum_g mn[n, g] * sigma[m, g])  (with zero-points)
//   where xt is bf16 for bf16 x and f32 for f32 x, out is x's type, sigma the
//   f32 sums of x over each group, and the zero-point term is formed in f32
//   after the dot is rounded, as the TPU package adds it outside its kernel.
//   The 4-bit per-channel mode reads scale [N] and forms mn = -7 * scale.
//   Byte j of part i of a packed row holds k = j + i*K/fpb (fpb = 8/bits
//   codes per byte, part i at bits i*bits).
//
// Bound on the H100: memory. At decode (M = 4) each packed byte is used for
// 2*M*fpb FLOPs, far below the ~295 FLOPs per byte where the tensor cores
// would bound; the least time is the packed bytes over 3.35 TB/s. The card
// streams 6.7 G 4-bit codes per ms and issues ~33 G thread-instructions per
// ms: ~5 instructions a code at 4 bits (2.5 at 2, 10 at 8), so at 2 and 4
// bits the dot cannot stay on the CUDA cores.
//
// Two designs (ops/gemv.py kernel_design).
//
// "tensor_core" (gemv_tc_kernel: F2 with bf16 x). The dot runs on
// mma.sync.m16n8k16 bf16 -> f32 with W as the A operand (16 rows x 16 k) and
// up to 8 x rows as B. The contraction runs over k in any order, so a thread
// takes 16 contiguous packed bytes of each of its rows g and g + 8 as they
// lie into its A slots: byte 4q + 2h + e of part i fills slot 2t + 8h + e of
// k-step 4i + q, and the matching B slots are x[k .. k + 3] at k = j + 4q +
// i*K/fpb, from the staged x in shared memory. Each code
// is dequantized exactly to JAX's bf16(f32(code * scale)): the code is masked
// in place into the bits of 2^23 (2^23 + 2^e * code, e its bit position in a
// half-word), one fma with scale * 2^-e and -2^23 * scale * 2^-e rounds the
// product once, and cvt.rn.bf16x2 rounds two at a time: ~2.5 instructions a
// code. Each warp walks items of 32 rows (two 16-row tiles sharing each B
// fragment) and keeps the tile after the one it computes in flight (32 rows
// x 128 bytes, one TMA load each, 128-byte swizzle, on an mbarrier). A CTA
// of 4 warps takes its range of the packed row (K split over CTAs) in
// slices: for each, the first tiles are put in flight, then its m-block of
// x and the f32 group sums sigma of the slice are staged in shared memory,
// once for the 4 items of a pass. The zero-point term is formed per slice
// from sigma in f32. With one split a warp writes y; with
// several it writes f32 partials (dot and zero-point term apart), and the
// last warp of a (rows, m-block) item to arrive, found by an atomic ticket
// that it resets, loads every split's partials at once and sums them in
// split order, rounds the dot to bf16 and adds the term: the same bits every
// run (measured faster than merging the splits of a cluster through
// distributed shared memory). The plan (m-block, splits, slices, grid)
// comes from ops/gemv.py tc_plan.
//
// "cuda_core" (gemv_kernel: F1, and F2 with f32 x, whose f32 products the
// tensor cores cannot form exactly). A CTA of 4 warps owns 4 rows of W;
// its warps split K, each lane streaming 16 packed bytes of every row at a
// time with a 16-byte evict-first load, and reading the x values of those
// codes (16 per part per x row) straight from global memory through L1, where
// the 4 rows and 4 warps of a CTA reuse them. f32 accumulation, a warp
// reduction by shuffles, then a fixed-order sum of the 4 warps through shared
// memory: the result does not depend on scheduling. x rows come in tiles of 4
// (M <= 4) or 8; larger M re-reads W per tile.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "sm90.cuh"

namespace {

using sm90::mbar_arrive_expect_tx;
using sm90::mbar_fence_init;
using sm90::mbar_init;
using sm90::mbar_wait;
using sm90::tma_load_3d;
using sm90::tma_prefetch_desc;

constexpr int NTHREADS = 128;
constexpr int NWARPS = NTHREADS / 32;
constexpr int RW = 4;  // rows of W per CTA

struct Args {
  const void* x;
  const float* x_scale;  // [M], int8 x only
  const unsigned char* w;
  const float* scale;
  const float* mn;  // [N, G] or null
  void* y;
  int M, N, K;
  int group_size;
  int s_row, s_group;  // scale[n * s_row + g * s_group]
  int neg7;            // mn = -7 * scale (4-bit per-channel weights)
};

__device__ __forceinline__ void load4(const float* p, float (&v)[4]) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  v[0] = t.x;
  v[1] = t.y;
  v[2] = t.z;
  v[3] = t.w;
}

__device__ __forceinline__ void load4(const __nv_bfloat16* p, float (&v)[4]) {
  const uint2 t = *reinterpret_cast<const uint2*>(p);
  v[0] = __uint_as_float(t.x << 16);
  v[1] = __uint_as_float(t.x & 0xFFFF0000u);
  v[2] = __uint_as_float(t.y << 16);
  v[3] = __uint_as_float(t.y & 0xFFFF0000u);
}

// A value rounded to T and back to f32.
template <typename T>
__device__ __forceinline__ float round_to(float v) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) return __bfloat162float(__float2bfloat16_rn(v));
  return v;
}

__device__ __forceinline__ void store1(float* p, float v) { *p = v; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

__device__ __forceinline__ uint32_t word_of(const uint4& v, int q) {
  return q == 0 ? v.x : q == 1 ? v.y : q == 2 ? v.z : v.w;
}

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// XT: x in memory (float, bf16, or int8 codes for w8a8); OT: y's type.
// GROUPED: F2 (unsigned codes times a per-group scale); else F1 (signed
// int8 codes, BITS 8). MT: x rows per CTA.
template <typename XT, typename OT, bool GROUPED, int BITS, int MT>
__global__ void __launch_bounds__(NTHREADS) gemv_kernel(const Args a) {
  constexpr int FPB = 8 / BITS;
  constexpr uint32_t MASK = (1u << BITS) - 1u;
  constexpr bool kInt8 = std::is_same<XT, int8_t>::value;
  using Acc = typename std::conditional<kInt8, int, float>::type;
  static_assert(GROUPED || BITS == 8, "F1 takes int8 codes");
  static_assert(!(GROUPED && kInt8), "INT8 activations run F1 only");

  __shared__ Acc red[NWARPS][RW][MT];
  __shared__ float redz[NWARPS][RW][MT];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int n0 = blockIdx.x * RW, m0 = blockIdx.y * MT;
  const int M = a.M, N = a.N, K = a.K;
  const int KB = K / FPB;  // packed bytes per row = codes per part
  const int nchunks = KB / 16;
  const XT* X = static_cast<const XT*>(a.x);
  const bool zero_points = GROUPED && (a.mn != nullptr || a.neg7);
  const int G = GROUPED ? K / a.group_size : 1;

  Acc acc[RW][MT];
  float zp[RW][MT];
#pragma unroll
  for (int r = 0; r < RW; ++r)
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      acc[r][m] = 0;
      zp[r][m] = 0.0f;
    }

  for (int c = warp * 32 + lane; c < nchunks; c += NTHREADS) {
    const int j0 = c * 16;
    uint4 wv[RW];
#pragma unroll
    for (int r = 0; r < RW; ++r)
      wv[r] = n0 + r < N ? __ldcs(reinterpret_cast<const uint4*>(a.w + (size_t)(n0 + r) * KB + j0))
                         : make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
    for (int i = 0; i < FPB; ++i) {
      const int k0 = j0 + i * KB;
      float s[RW], mnv[RW], sx[MT];
      if constexpr (GROUPED) {
        const int g = k0 / a.group_size;  // a 16-code run lies in one group
#pragma unroll
        for (int r = 0; r < RW; ++r) {
          const int row = min(n0 + r, N - 1);
          s[r] = a.scale[(size_t)row * a.s_row + (size_t)g * a.s_group];
          mnv[r] = a.neg7 ? __fmul_rn(-7.0f, s[r]) : (a.mn ? a.mn[(size_t)row * G + g] : 0.0f);
        }
#pragma unroll
        for (int m = 0; m < MT; ++m) sx[m] = 0.0f;
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        if constexpr (kInt8) {
          int xw[MT];
#pragma unroll
          for (int m = 0; m < MT; ++m)
            xw[m] = m0 + m < M ? *reinterpret_cast<const int*>(X + (size_t)(m0 + m) * K + k0 + 4 * q) : 0;
#pragma unroll
          for (int r = 0; r < RW; ++r) {
            const int wq = (int)word_of(wv[r], q);
#pragma unroll
            for (int m = 0; m < MT; ++m) acc[r][m] = __dp4a(wq, xw[m], acc[r][m]);
          }
        } else {
          float xv[MT][4];
#pragma unroll
          for (int m = 0; m < MT; ++m) {
            if (m0 + m < M) {
              load4(X + (size_t)(m0 + m) * K + k0 + 4 * q, xv[m]);
            } else {
              xv[m][0] = xv[m][1] = xv[m][2] = xv[m][3] = 0.0f;
            }
            if constexpr (GROUPED) {
              if (zero_points) sx[m] += (xv[m][0] + xv[m][1]) + (xv[m][2] + xv[m][3]);
            }
          }
#pragma unroll
          for (int r = 0; r < RW; ++r) {
            const uint32_t word = word_of(wv[r], q);
#pragma unroll
            for (int bb = 0; bb < 4; ++bb) {
              const uint32_t code = (word >> (8 * bb + i * BITS)) & MASK;
              float wval;
              if constexpr (GROUPED)
                wval = round_to<XT>(__fmul_rn((float)code, s[r]));
              else
                wval = (float)(int8_t)code;
#pragma unroll
              for (int m = 0; m < MT; ++m) acc[r][m] = fmaf(xv[m][bb], wval, acc[r][m]);
            }
          }
        }
      }
      if constexpr (GROUPED) {
        if (zero_points) {
#pragma unroll
          for (int r = 0; r < RW; ++r)
#pragma unroll
            for (int m = 0; m < MT; ++m) zp[r][m] = fmaf(mnv[r], sx[m], zp[r][m]);
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < RW; ++r)
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      const Acc v = warp_sum(acc[r][m]);
      const float z = zero_points ? warp_sum(zp[r][m]) : 0.0f;
      if (lane == 0) {
        red[warp][r][m] = v;
        redz[warp][r][m] = z;
      }
    }
  __syncthreads();
  if (tid >= RW * MT) return;
  const int r = tid / MT, m = tid % MT;
  const int n = n0 + r, mm = m0 + m;
  if (n >= N || mm >= M) return;
  Acc tot = red[0][r][m];
  float ztot = redz[0][r][m];
#pragma unroll
  for (int w = 1; w < NWARPS; ++w) {
    tot += red[w][r][m];
    ztot += redz[w][r][m];
  }
  float out;
  if constexpr (kInt8) {
    out = __fmul_rn(__fmul_rn((float)tot, a.x_scale[mm]), a.scale[n]);
  } else if constexpr (!GROUPED) {
    out = __fmul_rn(tot, a.scale[n]);
  } else {
    out = round_to<OT>(tot);
    if (zero_points) out = __fadd_rn(out, ztot);
  }
  store1(static_cast<OT*>(a.y) + (size_t)mm * N + n, out);
}

template <typename XT, typename OT, bool GROUPED, int BITS>
int launch(const Args& a, cudaStream_t st) {
  const unsigned gx = (unsigned)((a.N + RW - 1) / RW);
  if (a.M <= 4) {
    gemv_kernel<XT, OT, GROUPED, BITS, 4><<<dim3(gx, (a.M + 3) / 4), NTHREADS, 0, st>>>(a);
  } else {
    if ((a.M + 7) / 8 > 65535) return (int)cudaErrorInvalidValue;
    gemv_kernel<XT, OT, GROUPED, BITS, 8><<<dim3(gx, (a.M + 7) / 8), NTHREADS, 0, st>>>(a);
  }
  return (int)cudaGetLastError();
}

template <typename XT, typename OT>
int dispatch_bits(int bits, const Args& a, cudaStream_t st) {
  switch (bits) {
    case 2: return launch<XT, OT, true, 2>(a, st);
    case 4: return launch<XT, OT, true, 4>(a, st);
    case 8: return launch<XT, OT, true, 8>(a, st);
    default: return (int)cudaErrorInvalidValue;
  }
}


// ---------------------------------------------------------------------------
// Design "tensor_core": F2 with bf16 x on mma.sync
// ---------------------------------------------------------------------------

constexpr int TC_WARPS = 4;
constexpr int TC_ROWS = 32;   // rows of W per warp item: two 16-row tiles
// A warp's ring of tiles of its 32 rows x 128 bytes (two 64-byte chunks),
// loaded by TMA: the tile it computes and the next (measured against four
// stages at two CTAs an SM: three CTAs with two stages is faster).
constexpr int TC_STAGES = 2;
constexpr int TC_TILE_BYTES = TC_ROWS * 128;
constexpr int TC_MAX_SPLITS = 8;  // splits of a packed row
// Staged x values a row of a CTA: 1024 for one m-tile (16 KB), 512 for four (32 KB).
__host__ __device__ constexpr int tc_x_values(int mt) { return mt == 1 ? 1024 : 512; }

struct TcArgs {
  const __nv_bfloat16* x;
  const unsigned char* w;
  const float* scale;
  const float* mn;  // [N, G] or null
  __nv_bfloat16* y;
  float* part;   // ksplit > 1: [2][ksplit][M][N] f32 (the dots, then the zero-point terms)
  int* tickets;  // ksplit > 1: [m-blocks][row items], zero on entry, left zero
  int M, N, K, KB, group_size, s_row, s_group, neg7, zero_points;
  int ksplit, cps, spc;  // splits of the packed row, 64-byte chunks per split and per staged slice
};

// Shared memory of one CTA, from the plan: each warp's ring of tiles of its
// rows (128-byte swizzle) and their barriers, the staged x rows (FPB parts of slb values and 16 bytes of padding,
// which keeps the B loads of a quarter warp on distinct banks), the sums of
// x over 16-value runs and over the slice's groups (zero-points only), and
// each warp's result tile (the dot, then the zero-point term).
template <int BITS, int MT>
struct TcSmem {
  static constexpr int FPB = 8 / BITS, MB = 8 * MT, RS = MB + 1;
  static constexpr int kRingBytes = TC_WARPS * TC_STAGES * TC_TILE_BYTES;  // 1024-byte aligned tiles
  static constexpr int kBarOff = kRingBytes;                                   // a full barrier per tile
  int slb, xr, nrun, ngl, x_off, run_off, sig_off, res_off, total;
  __host__ __device__ TcSmem(int spc, bool zp) {
    slb = spc * 64;
    xr = FPB * slb + 8;
    nrun = slb / 16;
    ngl = nrun + 1;
    x_off = kBarOff + TC_WARPS * TC_STAGES * 8;
    run_off = x_off + MB * xr * 2;
    sig_off = run_off + (zp ? MB * FPB * nrun * 4 : 0);
    res_off = sig_off + (zp ? MB * FPB * ngl * 4 : 0);
    total = res_off + TC_WARPS * 2 * 32 * RS * 4 + 1024;  // + alignment slack
  }
};

__device__ __forceinline__ void mma_bf16_16816(float (&c)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, "
      "{%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// f32(code * scale) exactly, for the code at bits [sh, sh + BITS) of w
// (sh < 16): the code masked into the bits of 2^23 gives 2^23 + 2^sh code,
// and fma(that, scale 2^-sh, -2^23 scale 2^-sh) is code * scale rounded once.
// (sh is a constant once the callers' loops are unrolled: one LOP3, one FFMA.)
template <int BITS>
__device__ __forceinline__ float dq(uint32_t w, int sh, float s, float o) {
  return fmaf(__uint_as_float((w & (((1u << BITS) - 1u) << sh)) | 0x4B000000u), s, o);
}

template <int BITS, int MT>
__global__ void __launch_bounds__(TC_WARPS * 32, MT == 1 ? 3 : 2)
    gemv_tc_kernel(const __grid_constant__ CUtensorMap w_map, const TcArgs a) {
  constexpr int FPB = 8 / BITS, MB = 8 * MT, S = TC_STAGES;
  using L = TcSmem<BITS, MT>;
  constexpr int RS = L::RS;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (sm90::smem_u32(smem_raw) & 1023)) & 1023);
  const L lay(a.spc, a.zero_points != 0);
  const int slb = lay.slb, xr = lay.xr, nrun = lay.nrun, ngl = lay.ngl;
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem + lay.x_off);
  float* runs = reinterpret_cast<float*>(smem + lay.run_off);
  float* sig = reinterpret_cast<float*>(smem + lay.sig_off);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, tq = lane & 3;
  unsigned char* ring = smem + warp * S * TC_TILE_BYTES;  // [stage][32 rows][128 bytes], swizzled
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + L::kBarOff) + warp * S;
  float* res = reinterpret_cast<float*>(smem + lay.res_off) + warp * 2 * 32 * RS;  // [dot, zp][row][m]
  const int KB = a.KB, N = a.N, gs = a.group_size;
  const int ks = blockIdx.y, m0 = blockIdx.z * MB, mrows = min(MB, a.M - m0);
  const bool zero_points = a.zero_points != 0;
  const int n_items = (N + TC_ROWS - 1) / TC_ROWS;
  // This CTA's chunks of the packed row, taken in slices of spc chunks (slb bytes).
  const int c_lo = ks * a.cps, c_hi = min(c_lo + a.cps, (KB + 63) / 64);

  // The scale rows of this thread's rows of an item: tile rt, row g (h 0)
  // and g + 8 (h 1).
  int srow[2][2];
  auto rows = [&](int item) {
#pragma unroll
    for (int rt = 0; rt < 2; ++rt)
#pragma unroll
      for (int h = 0; h < 2; ++h) srow[rt][h] = min(item * TC_ROWS + 16 * rt + g + 8 * h, N - 1);
  };
  // Tiles a warp has consumed (its ring's position) and, on lane 0, the TMA
  // load of the tile of 128 bytes from byte j of rows n0 .. n0 + 31 into
  // ring stage st (past the rows or the row end: zeros).
  int cnt = 0;
  auto issue = [&](int j, int n0, int st) {
    if (lane == 0) {
      mbar_arrive_expect_tx(&bar[st], TC_TILE_BYTES);
      tma_load_3d(ring + st * TC_TILE_BYTES, &w_map, &bar[st], j, n0, 0);
    }
  };
  if (tid == 0) {
    for (int i = 0; i < TC_WARPS * S; ++i) mbar_init(reinterpret_cast<uint64_t*>(smem + L::kBarOff) + i, 1);
    mbar_fence_init();
  }
  if (tid == 32) tma_prefetch_desc(&w_map);
  __syncthreads();

  // Every warp makes the same number of passes (the CTA's barriers), one item a pass.
  const int passes = (n_items + gridDim.x * TC_WARPS - 1) / (gridDim.x * TC_WARPS);
  for (int pass = 0; pass < passes; ++pass) {
    const int item = (pass * gridDim.x + blockIdx.x) * TC_WARPS + warp;
    const bool active = item < n_items;
    const int n0 = item * TC_ROWS;
    if (active) rows(item);
    float acc[2][MT][4];
#pragma unroll
    for (int rt = 0; rt < 2; ++rt)
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) acc[rt][mt][0] = acc[rt][mt][1] = acc[rt][mt][2] = acc[rt][mt][3] = 0.0f;
    float zp[MB];  // the zero-point term of row n0 + lane
#pragma unroll
    for (int m = 0; m < MB; ++m) zp[m] = 0.0f;

    for (int s_lo = c_lo; s_lo < c_hi; s_lo += a.spc) {
      const int nc = min(a.spc, c_hi - s_lo), nt = (nc + 1) / 2;  // chunks, tiles of two chunks
      const int j_lo = s_lo * 64, j_hi = min(KB, (s_lo + nc) * 64);  // this slice of the split's range
      // The slice's first tiles in flight, under the staging of x.
      if (active) {
        __syncwarp();  // every lane is done with the stages these tiles land in
        for (int b = 0; b < min(S - 1, nt); ++b) issue(j_lo + 128 * b, n0, (cnt + b) % S);
      }
      __syncthreads();  // the previous slice's x and sigma are no longer read
      // ---- x rows m0 .. m0 + mrows - 1, this slice of each part, into shared memory ----
      {
        const int vpp = slb / 8;  // 16-byte vectors per part
        for (int v = tid; v < mrows * FPB * vpp; v += TC_WARPS * 32) {
          const int m = v / (FPB * vpp), r = v % (FPB * vpp), i = r / vpp, jj = (r % vpp) * 8;
          uint4 val = make_uint4(0u, 0u, 0u, 0u);
          if (j_lo + jj < j_hi)
            val = *reinterpret_cast<const uint4*>(a.x + (size_t)(m0 + m) * a.K + (size_t)i * KB + j_lo + jj);
          *reinterpret_cast<uint4*>(xs + m * xr + i * slb + jj) = val;
        }
      }
      __syncthreads();
      // ---- sigma: f32 sums of x over 16-value runs, then over each group's runs in the slice ----
      if (zero_points) {
        for (int u = tid; u < mrows * FPB * nrun; u += TC_WARPS * 32) {
          const int m = u / (FPB * nrun), r = u % (FPB * nrun);
          const uint4* p = reinterpret_cast<const uint4*>(xs + m * xr + r * 16);
          const uint4 v0 = p[0], v1 = p[1];
          const uint32_t wv[8] = {v0.x, v0.y, v0.z, v0.w, v1.x, v1.y, v1.z, v1.w};
          float s = 0.0f;
#pragma unroll
          for (int e = 0; e < 8; ++e) s += sm90::bf16_lo(wv[e]) + sm90::bf16_hi(wv[e]);
          runs[u] = s;
        }
        __syncthreads();
        for (int u = tid; u < mrows * FPB * ngl; u += TC_WARPS * 32) {
          const int m = u / (FPB * ngl), r = u % (FPB * ngl), i = r / ngl, gl = r % ngl;
          const int gg = j_lo / gs + gl;
          const int b0 = max(gg * gs, j_lo), b1 = min(gg * gs + gs, j_hi);
          float s = 0.0f;
#pragma unroll 4
          for (int j = b0; j < b1; j += 16) s += runs[(m * FPB + i) * nrun + (j - j_lo) / 16];
          sig[u] = s;
        }
        __syncthreads();
      }
      if (!active) continue;

      for (int ci = 0; ci < nc; ++ci) {
        const int c = s_lo + ci, b = ci >> 1, cc = ci & 1;
        const int j = c * 64 + 16 * tq;  // this thread's 16 bytes of each row
        const int jx = j - j_lo;
        const int gi = j < KB ? j / gs : 0;
        // The scales of every part, loaded under the wait.
        float sr[FPB][2][2];
#pragma unroll
        for (int i = 0; i < FPB; ++i)
#pragma unroll
          for (int rt = 0; rt < 2; ++rt)
#pragma unroll
            for (int h = 0; h < 2; ++h)
              sr[i][rt][h] =
                  __ldg(a.scale + (size_t)srow[rt][h] * a.s_row + (size_t)(gi + i * (KB / gs)) * a.s_group);
        const int st = (cnt + b) % S;
        if (cc == 0) {
          if (b + S - 1 < nt) {
            __syncwarp();  // the stage of tile b - 1 is read by every lane
            issue(j_lo + 128 * (b + S - 1), n0, (cnt + b + S - 1) % S);
          }
          mbar_wait(&bar[st], ((cnt + b) / S) & 1);
        }
        // Row r of a tile: 128 bytes, 16-byte chunk q at q ^ (r % 8) (r % 8 = g).
        const unsigned char* tile = ring + st * TC_TILE_BYTES + (((4 * cc + tq) ^ g) << 4);
        uint4 wc[2][2];
#pragma unroll
        for (int rt = 0; rt < 2; ++rt)
#pragma unroll
          for (int h = 0; h < 2; ++h) wc[rt][h] = *reinterpret_cast<const uint4*>(tile + (16 * rt + g + 8 * h) * 128);
#pragma unroll
        for (int i = 0; i < FPB; ++i) {
          // B: x rows mt*8 + g, values k = j + i*KB .. + 15 as bf16 pairs.
          uint32_t bx[MT][8];
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            const int m = mt * 8 + g;
            uint4 t0 = make_uint4(0u, 0u, 0u, 0u), t1 = t0;
            if (m < mrows) {
              const uint4* p = reinterpret_cast<const uint4*>(xs + m * xr + i * slb + jx);
              t0 = p[0];
              t1 = p[1];
            }
            bx[mt][0] = t0.x, bx[mt][1] = t0.y, bx[mt][2] = t0.z, bx[mt][3] = t0.w;
            bx[mt][4] = t1.x, bx[mt][5] = t1.y, bx[mt][6] = t1.z, bx[mt][7] = t1.w;
          }
          // Scales of part i: byte 0 of a half-word at bit BITS*i, byte 1 at 8 + BITS*i.
          float sa[2][2], oa[2][2], sb[2][2], ob[2][2];
#pragma unroll
          for (int rt = 0; rt < 2; ++rt)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              sa[rt][h] = sr[i][rt][h] * (1.0f / (float)(1 << (BITS * i)));
              sb[rt][h] = sa[rt][h] * (1.0f / 256.0f);
              oa[rt][h] = sa[rt][h] * -8388608.0f;
              ob[rt][h] = sb[rt][h] * -8388608.0f;
            }
#pragma unroll
          for (int q = 0; q < 4; ++q) {
#pragma unroll
            for (int rt = 0; rt < 2; ++rt) {
              const uint32_t w0 = word_of(wc[rt][0], q), w1 = word_of(wc[rt][1], q);
              const uint32_t u0 = w0 >> 16, u1 = w1 >> 16;
              const uint32_t af[4] = {
                  sm90::pack_bf16x2(dq<BITS>(w0, BITS * i, sa[rt][0], oa[rt][0]),
                                    dq<BITS>(w0, 8 + BITS * i, sb[rt][0], ob[rt][0])),
                  sm90::pack_bf16x2(dq<BITS>(w1, BITS * i, sa[rt][1], oa[rt][1]),
                                    dq<BITS>(w1, 8 + BITS * i, sb[rt][1], ob[rt][1])),
                  sm90::pack_bf16x2(dq<BITS>(u0, BITS * i, sa[rt][0], oa[rt][0]),
                                    dq<BITS>(u0, 8 + BITS * i, sb[rt][0], ob[rt][0])),
                  sm90::pack_bf16x2(dq<BITS>(u1, BITS * i, sa[rt][1], oa[rt][1]),
                                    dq<BITS>(u1, 8 + BITS * i, sb[rt][1], ob[rt][1]))};
#pragma unroll
              for (int mt = 0; mt < MT; ++mt) mma_bf16_16816(acc[rt][mt], af, bx[mt][2 * q], bx[mt][2 * q + 1]);
            }
          }
        }
      }
      cnt += nt;
      // The zero-point term of this slice's groups for row n0 + lane.
      if (zero_points) {
        const int sr0 = min(n0 + lane, N - 1), G = a.K / gs;
        for (int i = 0; i < FPB; ++i)
          for (int gl = 0; gl < ngl && (j_lo / gs + gl) * gs < j_hi; ++gl) {
            const float mnv = a.neg7 ? __fmul_rn(-7.0f, a.scale[(size_t)sr0 * a.s_row])
                                     : a.mn[(size_t)sr0 * G + i * (KB / gs) + j_lo / gs + gl];
#pragma unroll
            for (int m = 0; m < MB; ++m)
              if (m < mrows) zp[m] = fmaf(mnv, sig[(m * FPB + i) * ngl + gl], zp[m]);
          }
      }
    }
    if (!active) continue;
    // ---- epilogue: the dot and zero-point tiles through shared memory, lane
    // r owns row n0 + r ----
#pragma unroll
    for (int rt = 0; rt < 2; ++rt)
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          res[(16 * rt + g + 8 * (e >> 1)) * RS + mt * 8 + 2 * tq + (e & 1)] = acc[rt][mt][e];
#pragma unroll
    for (int m = 0; m < MB; ++m) res[(32 + lane) * RS + m] = zp[m];
    __syncwarp();
    const int n = n0 + lane;
    if (a.ksplit == 1) {
      if (n < N) {
#pragma unroll
        for (int m = 0; m < MB; ++m) {
          if (m >= mrows) break;
          const float d = res[lane * RS + m];
          const float out = zero_points ? __fadd_rn(round_to<__nv_bfloat16>(d), res[(32 + lane) * RS + m]) : d;
          a.y[(size_t)(m0 + m) * N + n] = __float2bfloat16_rn(out);
        }
      }
    } else {
      // f32 partials [2][ksplit][M][N]; the last split of these rows to
      // arrive (an atomic ticket it resets) sums them in split order.
      const size_t plane = (size_t)a.M * N;
      if (n < N) {
#pragma unroll
        for (int m = 0; m < MB; ++m) {
          if (m >= mrows) break;
          a.part[(size_t)ks * plane + (size_t)(m0 + m) * N + n] = res[lane * RS + m];
          a.part[(size_t)(a.ksplit + ks) * plane + (size_t)(m0 + m) * N + n] = res[(32 + lane) * RS + m];
        }
      }
      __threadfence();
      __syncwarp();
      int ticket = 0;
      int* tk = a.tickets + (size_t)blockIdx.z * n_items + item;
      if (lane == 0) ticket = atomicAdd(tk, 1);
      ticket = __shfl_sync(0xffffffffu, ticket, 0);
      if (ticket == a.ksplit - 1) {
        __threadfence();
        if (n < N) {
#pragma unroll
          for (int m = 0; m < MB; ++m) {
            if (m >= mrows) break;
            float dv[TC_MAX_SPLITS], zv[TC_MAX_SPLITS];  // every split's loads in flight together
#pragma unroll
            for (int sp = 0; sp < TC_MAX_SPLITS; ++sp) {
              const size_t at = (size_t)(m0 + m) * N + n;
              dv[sp] = sp < a.ksplit ? __ldcg(a.part + (size_t)sp * plane + at) : 0.0f;
              zv[sp] = sp < a.ksplit ? __ldcg(a.part + (size_t)(a.ksplit + sp) * plane + at) : 0.0f;
            }
            float d = 0.0f, z = 0.0f;
#pragma unroll
            for (int sp = 0; sp < TC_MAX_SPLITS; ++sp) d += dv[sp], z += zv[sp];
            const float out = zero_points ? __fadd_rn(round_to<__nv_bfloat16>(d), z) : d;
            a.y[(size_t)(m0 + m) * N + n] = __float2bfloat16_rn(out);
          }
        }
        if (lane == 0) *tk = 0;  // ready for the next call on the stream
      }
    }
    __syncwarp();
  }
}

template <int BITS, int MT>
int launch_tc(const TcArgs& a, int gx, cudaStream_t st) {
  const TcSmem<BITS, MT> lay(a.spc, a.zero_points != 0);
  // W as [1][N rows][KB bytes], tiles of 32 rows x 128 bytes, 128-byte swizzle.
  CUtensorMap w_map;
  const cuuint64_t dims[3] = {(cuuint64_t)a.KB, (cuuint64_t)a.N, 1};
  const cuuint64_t strides[2] = {(cuuint64_t)a.KB, (cuuint64_t)a.KB * a.N};
  const cuuint32_t box[3] = {128, TC_ROWS, 1};
  if (!sm90::make_tensor_map(&w_map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 3, a.w, dims, strides, box,
                             CU_TENSOR_MAP_SWIZZLE_128B))
    return (int)cudaErrorInvalidValue;
  auto kern = gemv_tc_kernel<BITS, MT>;
  if (lay.total > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, lay.total);
    if (err != cudaSuccess) return (int)err;
  }
  const unsigned mblocks = (unsigned)((a.M + 8 * MT - 1) / (8 * MT));
  kern<<<dim3((unsigned)gx, (unsigned)a.ksplit, mblocks), TC_WARPS * 32, lay.total, st>>>(w_map, a);
  return (int)cudaGetLastError();
}

template <int MT>
int dispatch_tc(int bits, const TcArgs& a, int gx, cudaStream_t st) {
  switch (bits) {
    case 2: return launch_tc<2, MT>(a, gx, st);
    case 4: return launch_tc<4, MT>(a, gx, st);
    case 8: return launch_tc<8, MT>(a, gx, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// All tensors contiguous.
//   x: [M, K] f32 (x_code 0), bf16 (1) or int8 codes (2, with x_scale [M] f32).
//   w: [N, K*bits/8] packed codes, parts-of-K; K*bits/8 a multiple of 16.
//   F1 (grouped 0): bits 8, signed codes, scale [N]; out f32 (0) or bf16 (1),
//     the type of the activations the caller was given.
//   F2 (grouped 1): unsigned codes, scale [N, G] (s_row G, s_group 1) or, with
//     neg7, [N] (s_row 1, s_group 0) and mn = -7 * scale; mn [N, G] or null;
//     group_size a multiple of 16 that divides K/fpb; out is x's type.
//   y: [M, N].
// Returns cudaGetLastError() (cudaErrorInvalidValue for what it does not take).
extern "C" int lowbit_gemv(const void* x, const float* x_scale, const void* w, const float* scale,
                           const float* mn, void* y, int M, int N, int K, int x_code, int out_code,
                           int bits, int grouped, int group_size, int s_row, int s_group, int neg7,
                           void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (M < 1 || N < 1 || K < 1 || (bits != 2 && bits != 4 && bits != 8)) return (int)cudaErrorInvalidValue;
  const int fpb = 8 / bits;
  if (K % fpb || (K / fpb) % 16) return (int)cudaErrorInvalidValue;
  if (grouped) {
    if (group_size < 16 || group_size % 16 || (K / fpb) % group_size || x_code == 2 || out_code != x_code)
      return (int)cudaErrorInvalidValue;
  } else if (bits != 8 || mn || neg7 || (x_code == 2) != (x_scale != nullptr) ||
             (x_code != 2 && out_code != x_code)) {
    return (int)cudaErrorInvalidValue;
  }
  const Args a{x, x_scale, static_cast<const unsigned char*>(w), scale, mn, y, M, N, K,
               group_size, s_row, s_group, neg7};
  if (!grouped) {
    if (x_code == 0) return launch<float, float, false, 8>(a, st);
    if (x_code == 1) return launch<__nv_bfloat16, __nv_bfloat16, false, 8>(a, st);
    if (out_code == 0) return launch<int8_t, float, false, 8>(a, st);
    return launch<int8_t, __nv_bfloat16, false, 8>(a, st);
  }
  if (x_code == 0) return dispatch_bits<float, float>(bits, a, st);
  return (int)cudaErrorInvalidValue;  // bf16 x: lowbit_gemv_tc
}

// F2 with bf16 x on the "tensor_core" design. All tensors contiguous.
//   x: [M, K] bf16.   w: [N, K*bits/8] packed codes, parts-of-K; K*bits/8 a
//   multiple of 16.   scale: [N, G] (s_row G, s_group 1) or, with neg7, [N]
//   (s_row 1, s_group 0) and mn = -7 * scale; mn: [N, G] or null;
//   group_size a multiple of 16 that divides K*bits/8.   y: [M, N] bf16.
//   The plan (ops/gemv.py tc_plan): mt 1 (M <= 8) or 4 x-row tiles of 8 per
//   CTA; ksplit splits of cps 64-byte chunks of the packed row, each taken in
//   slices of spc chunks whose x a CTA stages (at most tc_x_values(mt) values
//   a row, ksplit <= TC_MAX_SPLITS); gx CTAs along N. With ksplit > 1: part
//   [2, ksplit, M, N] f32 scratch and tickets [ceil(M/(8 mt)) * ceil(N/32)]
//   int32, zero (the kernel leaves them zero).
// Returns cudaGetLastError() (cudaErrorInvalidValue for what it does not take).
extern "C" int lowbit_gemv_tc(const void* x, const void* w, const float* scale, const float* mn, void* y,
                              float* part, int* tickets, int M, int N, int K, int bits, int group_size, int s_row,
                              int s_group, int neg7, int mt, int ksplit, int cps, int spc, int gx, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (M < 1 || N < 1 || K < 1 || (bits != 2 && bits != 4 && bits != 8) || (mt != 1 && mt != 4))
    return (int)cudaErrorInvalidValue;
  const int fpb = 8 / bits;
  if (K % fpb) return (int)cudaErrorInvalidValue;
  const int KB = K / fpb, chunks = (KB + 63) / 64;
  if (KB % 16 || group_size < 16 || group_size % 16 || KB % group_size || ksplit < 1 || ksplit > TC_MAX_SPLITS ||
      cps < 1 || spc < 1 || spc * 64 * fpb > tc_x_values(mt) || (ksplit - 1) * cps >= chunks ||
      ksplit * cps < chunks || gx < 1 ||
      (M + 8 * mt - 1) / (8 * mt) > 65535 || (ksplit > 1 && (!part || !tickets)))
    return (int)cudaErrorInvalidValue;
  const TcArgs a{static_cast<const __nv_bfloat16*>(x), static_cast<const unsigned char*>(w), scale, mn,
                 static_cast<__nv_bfloat16*>(y), part, tickets, M, N, K, KB, group_size, s_row, s_group, neg7,
                 (mn != nullptr || neg7) ? 1 : 0, ksplit, cps, spc};
  return mt == 1 ? dispatch_tc<1>(bits, a, gx, st) : dispatch_tc<4>(bits, a, gx, st);
}
