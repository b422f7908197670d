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
// ms: ~5 instructions a code at 4 bits (2.5 at 2, 10 at 8), so the dot
// cannot stay on the CUDA cores.
//
// Designs (ops/gemv.py kernel_design): "tensor_core" for bf16 x (F1 and F2)
// and F1's int8 x; "cuda_core" for f32 x (F1 and F2), whose f32 products the
// tensor cores cannot form exactly.
//
// F1 on "tensor_core" (gemv_w8_kernel, C entry lowbit_gemv_w8). A CTA is 4
// consumer warps and a producer warp walking units of (32 rows of W, an
// m-block of x, a range of K) over the grid. The producer keeps a ring of
// stages in flight (2 at 4 CTAs an SM with one x m-tile, 5 at 2 with four),
// each a tile of 32 rows x 512 bytes of W: one cp.async.bulk a row (its 512
// contiguous bytes; measured faster there than four TMA boxes of 32 rows x
// 128 bytes, and than 128-row boxes of 128 bytes, whose scattered rows
// stream W at ~2.0 TB/s) into rows 576 bytes apart, so the two rows of a
// quarter warp sit in disjoint banks. Each warp loads the next tile's x
// fragments from global memory (L1) before this tile's wait (with four
// m-tiles, this tile's). The deep ring (int8 x, M <= 8, where the row blocks
// alone about fill the SMs once: one CTA an SM over all of K, 8 stages, no
// merge) fills each stage by four TMA boxes of 32 rows x 128 bytes, 128-byte
// swizzle, issued by one lane (one producer warp's 32 bulk copies a stage
// fall behind a whole SM's rate), and stages the tile's k range of every x
// row beside W, one cp.async.bulk a row (one CTA's four warps cannot hide
// x's latency from L1). A full and an empty mbarrier a stage; the ring runs
// on across units. Consumer warp w takes the tile's 128-byte segment w, all
// 32 rows: two 16-row tiles as the A operand, x as B (8 rows a fragment). A
// thread takes 16-byte chunks t and t + 4 of its rows g and g + 8 as they
// lie; the contraction runs over k in any order, so those bytes fill its A
// slots and the same k values of x its B slots. At the end of a unit the
// four warps' partial dots are summed in warp order through shared memory.
// The product:
//   int8 x (w8a8): mma.sync.m16n8k32 s8 x s8 -> s32 on the bytes as they
//     lie; y = (f32(dot) * xs[m]) * scale[n], bit-equal to the plain version;
//   bf16 x: each code becomes its exact bf16, two at a time: a byte permute
//     puts the two bytes in the low bytes of the halves, two masks make the
//     bf16 pairs 128 + (b & 127) and 128 or 256 by the sign bit, and one
//     packed fma takes their difference (2 instructions a code); then
//     mma.sync.m16n8k16 bf16 -> f32; y = f32(dot) * scale[n].
// K is split over CTAs where the rows alone do not fill the card (ops/gemv.py
// w8_plan): each split writes its partial dots (f32, or s32 for int8 x), and
// the last CTA of a unit's rows to arrive, found by an atomic ticket that it
// resets, sums them in split order and applies the epilogue: the same bits
// every run (measured faster than merging the splits of a thread block
// cluster in rank 0's shared memory: launching the splits as clusters slows
// the ring). The merge costs ~2.5 us (three dependent round trips), so
// matrices of at most 16 MiB at M <= 8 run gemv_w8_direct_kernel instead:
// 16 rows a CTA of 16 warps that split K, loads straight from global
// memory, no ring and no merge across CTAs.
//
// F2 on "tensor_core" (gemv_tc_kernel: bf16 x). The dot runs on
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
// "cuda_core" (gemv_kernel: F1 and F2 with f32 x). A CTA of 4 warps owns 4 rows of W;
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
  const float* x;
  const unsigned char* w;
  const float* scale;
  const float* mn;  // [N, G] or null
  float* y;
  int M, N, K;
  int group_size;
  int s_row, s_group;  // scale[n * s_row + g * s_group]
  int neg7;            // mn = -7 * scale (4-bit per-channel weights)
};

__device__ __forceinline__ uint32_t word_of(const uint4& v, int q) {
  return q == 0 ? v.x : q == 1 ? v.y : q == 2 ? v.z : v.w;
}

// A value rounded to bf16 and back to f32.
__device__ __forceinline__ float round_bf16(float v) { return __bfloat162float(__float2bfloat16_rn(v)); }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// GROUPED: F2 (unsigned codes times a per-group scale); else F1 (signed
// int8 codes, BITS 8). MT: x rows per CTA.
template <bool GROUPED, int BITS, int MT>
__global__ void __launch_bounds__(NTHREADS) gemv_kernel(const Args a) {
  constexpr int FPB = 8 / BITS;
  constexpr uint32_t MASK = (1u << BITS) - 1u;
  static_assert(GROUPED || BITS == 8, "F1 takes int8 codes");

  __shared__ float red[NWARPS][RW][MT];
  __shared__ float redz[NWARPS][RW][MT];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int n0 = blockIdx.x * RW, m0 = blockIdx.y * MT;
  const int M = a.M, N = a.N, K = a.K;
  const int KB = K / FPB;  // packed bytes per row = codes per part
  const int nchunks = KB / 16;
  const float* X = a.x;
  const bool zero_points = GROUPED && (a.mn != nullptr || a.neg7);
  const int G = GROUPED ? K / a.group_size : 1;

  float acc[RW][MT], zp[RW][MT];
#pragma unroll
  for (int r = 0; r < RW; ++r)
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      acc[r][m] = 0.0f;
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
        float xv[MT][4];
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          if (m0 + m < M) {
            const float4 t = *reinterpret_cast<const float4*>(X + (size_t)(m0 + m) * K + k0 + 4 * q);
            xv[m][0] = t.x, xv[m][1] = t.y, xv[m][2] = t.z, xv[m][3] = t.w;
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
            const float wval = GROUPED ? __fmul_rn((float)code, s[r]) : (float)(int8_t)code;
#pragma unroll
            for (int m = 0; m < MT; ++m) acc[r][m] = fmaf(xv[m][bb], wval, acc[r][m]);
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
      const float v = warp_sum(acc[r][m]);
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
  float tot = red[0][r][m], ztot = redz[0][r][m];
#pragma unroll
  for (int w = 1; w < NWARPS; ++w) {
    tot += red[w][r][m];
    ztot += redz[w][r][m];
  }
  float out;
  if constexpr (!GROUPED) {
    out = __fmul_rn(tot, a.scale[n]);
  } else {
    out = zero_points ? __fadd_rn(tot, ztot) : tot;
  }
  a.y[(size_t)mm * N + n] = out;
}

template <bool GROUPED, int BITS>
int launch(const Args& a, cudaStream_t st) {
  const unsigned gx = (unsigned)((a.N + RW - 1) / RW);
  if (a.M <= 4) {
    gemv_kernel<GROUPED, BITS, 4><<<dim3(gx, (a.M + 3) / 4), NTHREADS, 0, st>>>(a);
  } else {
    if ((a.M + 7) / 8 > 65535) return (int)cudaErrorInvalidValue;
    gemv_kernel<GROUPED, BITS, 8><<<dim3(gx, (a.M + 7) / 8), NTHREADS, 0, st>>>(a);
  }
  return (int)cudaGetLastError();
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
          const float out = zero_points ? __fadd_rn(round_bf16(d), res[(32 + lane) * RS + m]) : d;
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
            const float out = zero_points ? __fadd_rn(round_bf16(d), z) : d;
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

// ---------------------------------------------------------------------------
// Design "tensor_core" of F1: int8 codes times bf16 or int8 x on mma.sync
// ---------------------------------------------------------------------------

constexpr int W8_CONSUMERS = 4;                      // consumer warps a CTA, then the producer warp
constexpr int W8_THREADS = 32 * (W8_CONSUMERS + 1);
constexpr int W8_ROWS = 32;                          // rows of W a tile
constexpr int W8_KT = 128 * W8_CONSUMERS;            // k values (bytes of a row) a tile: a 128-byte segment a warp
// Tiles in flight a CTA and CTAs an SM: 2 x 4 at one x m-tile (measured faster
// than 5 x 2 and 3 x 3), 5 x 2 at four (registers), W8_DEEP_STAGES x 1 on
// the deep ring.
constexpr int W8_DEEP_STAGES = 8;
__host__ __device__ constexpr int w8_stages(int mt, bool deep) { return deep ? W8_DEEP_STAGES : mt == 1 ? 2 : 5; }
__host__ __device__ constexpr int w8_ctas(int mt, bool deep) { return deep ? 1 : mt == 1 ? 4 : 2; }
constexpr int W8_MAX_SPLITS = 16;                    // splits of K (ops/gemv.py W8_MAX_SPLITS)
constexpr int W8_PITCH = W8_KT + 64;                 // rows 2p, 2p + 1 of a quarter warp in disjoint banks
// How a stage's W is filled: one cp.async.bulk a row, rows W8_PITCH apart,
// or (the deep ring, where one producer warp's bulk copies, one a row, fall
// behind a whole SM's rate) four TMA boxes of 32 rows x 128 bytes, 128-byte
// swizzle, one a consumer warp's segment.
__host__ __device__ constexpr bool w8_tma_fill(bool deep) { return deep; }
__host__ __device__ constexpr int w8_w_bytes(bool tma) { return W8_ROWS * (tma ? W8_KT : W8_PITCH); }
// The deep ring's stage also holds the tile's k range of every x row (one
// cp.async.bulk a row), rows w8_xpitch apart: the two rows of a quarter
// warp's B loads fall in disjoint banks. (The 4-CTA ring reads x through L1.)
__host__ __device__ constexpr int w8_xpitch(bool s8) { return s8 ? W8_KT + 64 : 2 * W8_KT + 16; }

// Shared memory of one CTA: the ring of stages (W, then on the deep ring x
// rows 0 .. xrows - 1; on 1024 bytes for the TMA swizzle), a full and an
// empty barrier a stage, and each consumer warp's partial dot tile [32
// rows][MB + 1].
template <int MT, bool DEEP>
struct W8Smem {
  static constexpr int MB = 8 * MT, RS = MB + 1;
  static constexpr int S = w8_stages(MT, DEEP);
  static constexpr bool TMA = w8_tma_fill(DEEP);
  __host__ __device__ static int stage(int xrows, bool s8) {
    const int bytes = w8_w_bytes(TMA) + xrows * w8_xpitch(s8);
    return TMA ? (bytes + 1023) & ~1023 : bytes;
  }
  __host__ __device__ static int bar_off(int xrows, bool s8) { return S * stage(xrows, s8); }
  __host__ __device__ static int res_off(int xrows, bool s8) { return bar_off(xrows, s8) + 2 * S * 8; }
  __host__ __device__ static int total(int xrows, bool s8) {
    return res_off(xrows, s8) + W8_CONSUMERS * W8_ROWS * RS * 4 + (TMA ? 1024 : 0);  // + alignment slack
  }
};

struct W8Args {
  const void* x;         // [M, K] bf16 or int8 codes
  const float* x_scale;  // [M], int8 x
  const unsigned char* w;
  const float* scale;    // [N]
  void* y;               // [M, N] bf16, or f32 (int8 x with out_f32)
  void* part;            // ksplit > 1: [ksplit][M][N] partial dots, f32 (bf16 x) or s32 (int8 x)
  int* tickets;          // ksplit > 1: [m-blocks][row blocks], zero on entry, left zero
  int M, N, K, out_f32, ksplit, tps, units;  // tps: tiles a split; units: row blocks x m-blocks x splits
};

__device__ __forceinline__ void mma_s8_16832(int (&c)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A bulk copy global -> shared, completion in bytes on bar, L2 evict-first
// (W is read once).
__device__ __forceinline__ void w8_bulk_copy(void* dst, const void* src, uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "{\n.reg .b64 pol;\ncreatepolicy.fractional.L2::evict_first.b64 pol, 1.0;\n"
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes.L2::cache_hint [%0], [%1], %2, [%3], pol;\n}\n"
      ::"r"(sm90::smem_u32(dst)), "l"(src), "r"(bytes), "r"(sm90::smem_u32(bar))
      : "memory");
}

// The same with the default L2 policy (x is read by every CTA).
__device__ __forceinline__ void w8_bulk_copy_keep(void* dst, const void* src, uint32_t bytes, uint64_t* bar) {
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
               ::"r"(sm90::smem_u32(dst)), "l"(src), "r"(bytes), "r"(sm90::smem_u32(bar))
               : "memory");
}

// bf16x2 of the int8 codes in bytes I and J of w (I in the low half), exact:
// with byte b in the low byte of each half, (b & 0x7F) | 0x4300 is the bf16
// 128 + (b & 127) and (b & 0x80) | 0x4300 the bf16 128 (b >= 0) or 256
// (b < 0); their difference, one packed fma, is the signed code.
template <int I, int J>
__device__ __forceinline__ uint32_t i8x2_to_bf16x2_exact(uint32_t w) {
  const uint32_t p = __byte_perm(w, 0u, (J << 8) | I);  // b_I in byte 0, b_J in byte 2
  const uint32_t a = (p & 0x007F007Fu) | 0x43004300u, t = (p & 0x00800080u) | 0x43004300u;
  uint32_t c;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;\n" : "=r"(c) : "r"(t), "r"(0xBF80BF80u), "r"(a));  // a - t
  return c;
}

template <bool XS8, int MT, bool DEEP>
__global__ void __launch_bounds__(W8_THREADS, w8_ctas(MT, DEEP))
    gemv_w8_kernel(const __grid_constant__ CUtensorMap w_map, const W8Args a) {
  using L = W8Smem<MT, DEEP>;
  using Acc = typename std::conditional<XS8, int, float>::type;
  constexpr int MB = L::MB, S = L::S, RS = L::RS, XB = XS8 ? 1 : 2, XP = w8_xpitch(XS8);
  constexpr bool TMA = L::TMA;
  constexpr int WB = w8_w_bytes(TMA);
  // x rows a stage holds: on the deep ring (one m-tile, so m-block 0) every row.
  const int xrows = DEEP ? a.M : 0, sb = L::stage(xrows, XS8);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* smem = TMA ? smem_raw + ((1024 - (sm90::smem_u32(smem_raw) & 1023)) & 1023) : smem_raw;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::bar_off(xrows, XS8));
  uint64_t* empty = full + S;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int K = a.K, ktiles = (K + W8_KT - 1) / W8_KT, mblocks = (a.M + MB - 1) / MB;
  const int rblocks = a.units / (mblocks * a.ksplit);
  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], W8_CONSUMERS);
    }
    mbar_fence_init();
  }
  if (TMA && tid == 32) tma_prefetch_desc(&w_map);
  __syncthreads();

  if (warp == W8_CONSUMERS) {
    // ---- producer: every tile of this CTA's units in flight, S at a time ----
    int it = 0;
    for (int u = blockIdx.x; u < a.units; u += gridDim.x) {
      const int sp = u / mblocks % a.ksplit, rb = u / (mblocks * a.ksplit);
      const int kt1 = min(sp * a.tps + a.tps, ktiles), rows = min(W8_ROWS, a.N - rb * W8_ROWS);
      for (int kt = sp * a.tps; kt < kt1; ++kt, ++it) {
        const int st = it % S, k0 = kt * W8_KT, bytes = min(W8_KT, K - k0);
        if (it >= S) mbar_wait(&empty[st], (it / S - 1) & 1);
        unsigned char* stage = smem + st * sb;
        // W: TMA boxes of the segments that start inside K (rows past N are
        // zero-filled), or a bulk copy a row (rows past N are not loaded:
        // their stale codes meet only outputs that are not stored); then the
        // staged x rows.
        const int segs = (bytes + 127) / 128;
        if (lane == 0) {
          mbar_arrive_expect_tx(&full[st], (TMA ? segs * W8_ROWS * 128 : rows * bytes) + xrows * XB * bytes);
          if (TMA)
            for (int s = 0; s < segs; ++s)
              tma_load_3d(stage + s * W8_ROWS * 128, &w_map, &full[st], k0 + 128 * s, rb * W8_ROWS, 0);
        }
        __syncwarp();
        if (!TMA && lane < rows)
          w8_bulk_copy(stage + lane * W8_PITCH, a.w + (size_t)(rb * W8_ROWS + lane) * K + k0, bytes, &full[st]);
        if (lane < xrows)
          w8_bulk_copy_keep(stage + WB + lane * XP, static_cast<const unsigned char*>(a.x) + ((size_t)lane * K + k0) * XB,
                            bytes * XB, &full[st]);
      }
    }
    return;
  }

  // ---- consumers: warp w takes segment w (128 k values) of every tile, all 32 rows ----
  // Fragment row g reads tile row gr: in the swizzled TMA boxes rows 2p and
  // 2p + 1 of a quarter warp go to rows p and p + 4, whose chunks lie in
  // disjoint halves of the banks.
  const int g = lane >> 2, t = lane & 3, gr = TMA ? ((g & 1) << 2) | (g >> 1) : g;
  Acc* res = reinterpret_cast<Acc*>(smem + L::res_off(xrows, XS8));  // [warp][row][m]
  int it = 0;
  for (int u = blockIdx.x; u < a.units; u += gridDim.x) {
    const int mb = u % mblocks, sp = u / mblocks % a.ksplit, rb = u / (mblocks * a.ksplit);
    const int kt1 = min(sp * a.tps + a.tps, ktiles);
    const int m0 = mb * MB, mrows = min(MB, a.M - m0);
    Acc acc[2][MT][4];
#pragma unroll
    for (int rt = 0; rt < 2; ++rt)
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) acc[rt][mt][0] = acc[rt][mt][1] = acc[rt][mt][2] = acc[rt][mt][3] = 0;

    // B: x rows m0 + 8 mt + g at the k values of chunks t and t + 4 of this
    // warp's segment of tile kt (16 each); zero past M or K. On the deep ring
    // from the stage after the wait. Else, with one x m-tile, the next
    // tile's fragments are loaded from global memory (L1) before this one's
    // wait (their latency hidden under the tile), with four before the wait.
    constexpr int XJ = XS8 ? 1 : 2;
    constexpr bool XST = DEEP, kPrefetch = !DEEP && MT == 1;
    auto load_x = [&](int kt, const unsigned char* stage, uint4 (&xv)[2][MT][XJ]) {
#pragma unroll
      for (int cc = 0; cc < 2; ++cc) {
        const int k = kt * W8_KT + 128 * warp + 16 * (t + 4 * cc);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          const int m = m0 + 8 * mt + g;
          const bool in = m < a.M && k < K;
#pragma unroll
          for (int j = 0; j < XJ; ++j) {
            const uint4* p =
                XST ? reinterpret_cast<const uint4*>(stage + WB + g * XP + (k - kt * W8_KT) * XB) + j
                    : reinterpret_cast<const uint4*>(static_cast<const unsigned char*>(a.x) +
                                                     ((size_t)m * K + k) * XB) + j;
            xv[cc][mt][j] = in ? (XST ? *p : __ldg(p)) : make_uint4(0u, 0u, 0u, 0u);
          }
        }
      }
    };
    uint4 xv[2][MT][XJ], xn[2][MT][XJ];
    if (kPrefetch) load_x(sp * a.tps, nullptr, xn);
    for (int kt = sp * a.tps; kt < kt1; ++kt, ++it) {
      const int st = it % S, ks = kt * W8_KT + 128 * warp;  // this warp's segment
      const unsigned char* stage = smem + st * sb;
      if constexpr (kPrefetch) {
#pragma unroll
        for (int cc = 0; cc < 2; ++cc)
#pragma unroll
          for (int j = 0; j < XJ; ++j) xv[cc][0][j] = xn[cc][0][j];
        if (kt + 1 < kt1) load_x(kt + 1, nullptr, xn);
      } else if constexpr (!XST) {
        load_x(kt, nullptr, xv);
      }
      mbar_wait(&full[st], (it / S) & 1);
      if (ks < K) {  // a segment past K holds no codes
        if constexpr (XST) load_x(kt, stage, xv);
#pragma unroll
        for (int cc = 0; cc < 2; ++cc) {
          const int c = t + 4 * cc;  // this thread's 16-byte chunk of each of its rows
          uint4 wv[2][2];            // rows 16 rt + 8 h + g
#pragma unroll
          for (int rt = 0; rt < 2; ++rt)
#pragma unroll
            for (int h = 0; h < 2; ++h)
              wv[rt][h] = *reinterpret_cast<const uint4*>(
                  stage + (TMA ? warp * (W8_ROWS * 128) + (16 * rt + 8 * h + gr) * 128 + ((c ^ gr) << 4)
                                : (16 * rt + 8 * h + g) * W8_PITCH + 128 * warp + 16 * c));
          if constexpr (XS8) {
            // Two k32 steps of 8 bytes: A = words 2s, 2s + 1 of rows g, g + 8; B = the same words of x.
#pragma unroll
            for (int s = 0; s < 2; ++s)
#pragma unroll
              for (int rt = 0; rt < 2; ++rt) {
                const uint32_t af[4] = {word_of(wv[rt][0], 2 * s), word_of(wv[rt][1], 2 * s),
                                        word_of(wv[rt][0], 2 * s + 1), word_of(wv[rt][1], 2 * s + 1)};
#pragma unroll
                for (int mt = 0; mt < MT; ++mt)
                  mma_s8_16832(acc[rt][mt], af, word_of(xv[cc][mt][0], 2 * s), word_of(xv[cc][mt][0], 2 * s + 1));
              }
          } else {
            // k16 step q: codes 4q, 4q + 1 fill slots 2t, 2t + 1 and codes 4q + 2, 4q + 3 slots 2t + 8, 2t + 9;
            // B: x values 4q .. 4q + 3 of the chunk, words 2q and 2q + 1 of its 32 bytes.
#pragma unroll
            for (int q = 0; q < 4; ++q)
#pragma unroll
              for (int rt = 0; rt < 2; ++rt) {
                const uint32_t w0 = word_of(wv[rt][0], q), w1 = word_of(wv[rt][1], q);
                const uint32_t af[4] = {i8x2_to_bf16x2_exact<0, 1>(w0), i8x2_to_bf16x2_exact<0, 1>(w1),
                                        i8x2_to_bf16x2_exact<2, 3>(w0), i8x2_to_bf16x2_exact<2, 3>(w1)};
#pragma unroll
                for (int mt = 0; mt < MT; ++mt)
                  mma_bf16_16816(acc[rt][mt], af, word_of(xv[cc][mt][q >> 1], 2 * (q & 1)),
                                 word_of(xv[cc][mt][q >> 1], 2 * (q & 1) + 1));
              }
          }
        }
      }
      __syncwarp();
      if (lane == 0) sm90::mbar_arrive(&empty[st]);
    }

    // ---- epilogue: the warps' partial dots through shared memory, summed in
    // warp order by warp 0, whose lane r owns row n0 + r ----
#pragma unroll
    for (int rt = 0; rt < 2; ++rt)
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          res[(warp * W8_ROWS + 16 * rt + 8 * (e >> 1) + gr) * RS + 8 * mt + 2 * t + (e & 1)] = acc[rt][mt][e];
    sm90::named_bar_sync(1, 32 * W8_CONSUMERS);
    if (warp == 0) {
      const int n = rb * W8_ROWS + lane;
      const float sn = n < a.N ? a.scale[n] : 0.0f;
      auto dot = [&](int m) {
        Acc d = res[lane * RS + m];
#pragma unroll
        for (int w = 1; w < W8_CONSUMERS; ++w) d += res[(w * W8_ROWS + lane) * RS + m];
        return d;
      };
      auto store = [&](int m, Acc tot) {
        const float out =
            XS8 ? __fmul_rn(__fmul_rn((float)tot, a.x_scale[m]), sn) : __fmul_rn((float)tot, sn);
        if (a.out_f32)
          static_cast<float*>(a.y)[(size_t)m * a.N + n] = out;
        else
          static_cast<__nv_bfloat16*>(a.y)[(size_t)m * a.N + n] = __float2bfloat16_rn(out);
      };
      if (a.ksplit == 1) {
        if (n < a.N)
          for (int m = 0; m < mrows; ++m) store(m0 + m, dot(m));
      } else {
        // Partial dots [ksplit][M][N]; the last split of these rows to arrive
        // (an atomic ticket it resets) sums them in split order.
        Acc* part = static_cast<Acc*>(a.part);
        const size_t plane = (size_t)a.M * a.N;
        if (n < a.N)
          for (int m = 0; m < mrows; ++m) part[(size_t)sp * plane + (size_t)(m0 + m) * a.N + n] = dot(m);
        __threadfence();
        __syncwarp();
        int* tk = a.tickets + (size_t)mb * rblocks + rb;
        int ticket = 0;
        if (lane == 0) ticket = atomicAdd(tk, 1);
        ticket = __shfl_sync(0xffffffffu, ticket, 0);
        if (ticket == a.ksplit - 1) {
          __threadfence();
          if (n < a.N)
            for (int m = 0; m < mrows; ++m) {
              const size_t at = (size_t)(m0 + m) * a.N + n;
              Acc tot = 0;
              for (int s = 0; s < a.ksplit; ++s) tot += __ldcg(part + (size_t)s * plane + at);
              store(m0 + m, tot);
            }
          if (lane == 0) *tk = 0;  // ready for the next call on the stream
        }
      }
    }
    sm90::named_bar_sync(1, 32 * W8_CONSUMERS);  // res is rewritten by the next unit
  }
}


// F1 "tensor_core" with direct loads (ops/gemv.py w8_plan: one x m-tile, K
// at most W8D_MAX_K and at most 16 MiB of W, where the ring would split K
// and its merge costs more than the loads). A CTA of 16 warps owns 16 rows
// of W; warp w takes the 128-value k-blocks w, w + 16 (at most W8D_BATCH),
// loading all its A fragments (16 bytes of rows g and g + 8 at chunks t and
// t + 4, evict-first) straight from global memory first; then the CTA
// stages its x rows in shared memory (rows padded so that a quarter warp's
// B loads fall in distinct banks), and the warps' partial dots are summed
// in warp order through shared memory. No ring and no split of K across
// CTAs: the launch and one round trip. (16 warps of 2 k-blocks, not 8 of 4:
// each warp's dequantization after its loads land is half as long.)
constexpr int W8D_WARPS = 16;
constexpr int W8D_BATCH = 2;                                 // k-blocks of 128 values a warp
constexpr int W8D_MAX_K = W8D_WARPS * W8D_BATCH * 128;       // 4096 (ops/gemv.py W8D_MAX_K)
__host__ __device__ constexpr int w8d_pitch(int K, bool s8) { return s8 ? K + 64 : 2 * K + 16; }

template <bool XS8>
__global__ void __launch_bounds__(W8D_WARPS * 32, 2) gemv_w8_direct_kernel(const W8Args a) {
  using Acc = typename std::conditional<XS8, int, float>::type;
  constexpr int RS = 9;
  __shared__ Acc red[W8D_WARPS][16][RS];
  extern __shared__ __align__(16) unsigned char xsm[];  // [M][pitch] x values
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int K = a.K, M = a.M, kblocks = (K + 127) / 128, n0 = blockIdx.x * 16, pitch = w8d_pitch(K, XS8);
  // Rows past N read row N - 1: their dots are never stored.
  const unsigned char* wr[2] = {a.w + (size_t)min(n0 + g, a.N - 1) * K, a.w + (size_t)min(n0 + g + 8, a.N - 1) * K};
  uint4 wv[W8D_BATCH][2][2];
#pragma unroll
  for (int b = 0; b < W8D_BATCH; ++b)
#pragma unroll
    for (int cc = 0; cc < 2; ++cc) {
      const int k = (warp + b * W8D_WARPS) * 128 + 16 * (t + 4 * cc);
#pragma unroll
      for (int h = 0; h < 2; ++h)
        wv[b][cc][h] = k < K ? __ldcs(reinterpret_cast<const uint4*>(wr[h] + k)) : make_uint4(0u, 0u, 0u, 0u);
    }
  // x rows 0 .. M - 1 into shared memory, 16 bytes a thread at a time.
  const int rowv = K * (XS8 ? 1 : 2) / 16;
  for (int v = threadIdx.x; v < M * rowv; v += W8D_WARPS * 32) {
    const int m = v / rowv, j = v % rowv;
    *reinterpret_cast<uint4*>(xsm + m * pitch + 16 * j) =
        __ldg(reinterpret_cast<const uint4*>(static_cast<const unsigned char*>(a.x) + (size_t)m * K * (XS8 ? 1 : 2)) + j);
  }
  __syncthreads();
  Acc acc[4] = {0, 0, 0, 0};
#pragma unroll
  for (int b = 0; b < W8D_BATCH; ++b) {
    if ((warp + b * W8D_WARPS) * 128 >= K) break;  // uniform: past K
#pragma unroll
    for (int cc = 0; cc < 2; ++cc) {
      const int k = (warp + b * W8D_WARPS) * 128 + 16 * (t + 4 * cc);
      // B: x row g (zero past M or K) at the chunk's 16 k values.
      const unsigned char* xp = xsm + g * pitch + k * (XS8 ? 1 : 2);
      const bool in = g < M && k < K;
      if constexpr (XS8) {
        const uint4 xv = in ? *reinterpret_cast<const uint4*>(xp) : make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
        for (int s = 0; s < 2; ++s) {
          const uint32_t af[4] = {word_of(wv[b][cc][0], 2 * s), word_of(wv[b][cc][1], 2 * s),
                                  word_of(wv[b][cc][0], 2 * s + 1), word_of(wv[b][cc][1], 2 * s + 1)};
          mma_s8_16832(acc, af, word_of(xv, 2 * s), word_of(xv, 2 * s + 1));
        }
      } else {
        const uint4 x0 = in ? *reinterpret_cast<const uint4*>(xp) : make_uint4(0u, 0u, 0u, 0u);
        const uint4 x1 = in ? *reinterpret_cast<const uint4*>(xp + 16) : make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const uint32_t w0 = word_of(wv[b][cc][0], q), w1 = word_of(wv[b][cc][1], q);
          const uint32_t af[4] = {i8x2_to_bf16x2_exact<0, 1>(w0), i8x2_to_bf16x2_exact<0, 1>(w1),
                                  i8x2_to_bf16x2_exact<2, 3>(w0), i8x2_to_bf16x2_exact<2, 3>(w1)};
          const uint4& xq = q < 2 ? x0 : x1;
          mma_bf16_16816(acc, af, word_of(xq, 2 * (q & 1)), word_of(xq, 2 * (q & 1) + 1));
        }
      }
    }
  }
#pragma unroll
  for (int e = 0; e < 4; ++e) red[warp][g + 8 * (e >> 1)][2 * t + (e & 1)] = acc[e];
  __syncthreads();
  for (int i = threadIdx.x; i < 16 * M; i += W8D_WARPS * 32) {
    const int r = i & 15, m = i >> 4, n = n0 + r;
    if (n >= a.N) continue;
    Acc tot = red[0][r][m];
#pragma unroll
    for (int w = 1; w < W8D_WARPS; ++w) tot += red[w][r][m];
    const float sn = a.scale[n];
    const float out = XS8 ? __fmul_rn(__fmul_rn((float)tot, a.x_scale[m]), sn) : __fmul_rn((float)tot, sn);
    if (a.out_f32)
      static_cast<float*>(a.y)[(size_t)m * a.N + n] = out;
    else
      static_cast<__nv_bfloat16*>(a.y)[(size_t)m * a.N + n] = __float2bfloat16_rn(out);
  }
}

template <bool XS8, int MT, bool DEEP>
int launch_ring(const W8Args& a, int grid, cudaStream_t st) {
  // With the TMA fill, W as [1][N rows][K bytes] in boxes of 32 rows x 128 bytes, 128-byte swizzle.
  CUtensorMap w_map = {};
  const cuuint64_t wd[3] = {(cuuint64_t)a.K, (cuuint64_t)a.N, 1};
  const cuuint64_t ws[2] = {(cuuint64_t)a.K, (cuuint64_t)a.K * a.N};
  const cuuint32_t wb[3] = {128, W8_ROWS, 1};
  if (W8Smem<MT, DEEP>::TMA &&
      !sm90::make_tensor_map(&w_map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 3, a.w, wd, ws, wb, CU_TENSOR_MAP_SWIZZLE_128B))
    return (int)cudaErrorInvalidValue;
  auto kern = gemv_w8_kernel<XS8, MT, DEEP>;
  const int bytes = W8Smem<MT, DEEP>::total(DEEP ? a.M : 0, XS8);
  const cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  kern<<<grid, W8_THREADS, bytes, st>>>(w_map, a);
  return (int)cudaGetLastError();
}

// Structures (ops/gemv.py W8_STRUCTURES): 0 the ring, 1 the direct loads, 2 the deep ring.
template <bool XS8>
int launch_w8(const W8Args& a, int structure, int mt, int grid, cudaStream_t st) {
  if (structure == 1) {
    const int xbytes = a.M * w8d_pitch(a.K, XS8);
    auto dk = gemv_w8_direct_kernel<XS8>;
    if (xbytes > 48 * 1024) {
      const cudaError_t err = cudaFuncSetAttribute(dk, cudaFuncAttributeMaxDynamicSharedMemorySize, xbytes);
      if (err != cudaSuccess) return (int)err;
    }
    dk<<<grid, W8D_WARPS * 32, xbytes, st>>>(a);
    return (int)cudaGetLastError();
  }
  if (structure == 2) return launch_ring<XS8, 1, true>(a, grid, st);
  return mt == 1 ? launch_ring<XS8, 1, false>(a, grid, st) : launch_ring<XS8, 4, false>(a, grid, st);
}

}  // namespace

// Design "cuda_core": F1 and F2 with f32 x. All tensors contiguous.
//   x: [M, K] f32.   w: [N, K*bits/8] packed codes, parts-of-K; K*bits/8 a
//   multiple of 16.
//   F1 (grouped 0): bits 8, signed codes, scale [N].
//   F2 (grouped 1): unsigned codes, scale [N, G] (s_row G, s_group 1) or, with
//     neg7, [N] (s_row 1, s_group 0) and mn = -7 * scale; mn [N, G] or null;
//     group_size a multiple of 16 that divides K/fpb.
//   y: [M, N] f32.
// Returns cudaGetLastError() (cudaErrorInvalidValue for what it does not take).
extern "C" int lowbit_gemv(const void* x, const void* w, const float* scale, const float* mn, void* y, int M, int N,
                           int K, int bits, int grouped, int group_size, int s_row, int s_group, int neg7,
                           void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (M < 1 || N < 1 || K < 1 || (bits != 2 && bits != 4 && bits != 8)) return (int)cudaErrorInvalidValue;
  const int fpb = 8 / bits;
  if (K % fpb || (K / fpb) % 16) return (int)cudaErrorInvalidValue;
  if (grouped ? (group_size < 16 || group_size % 16 || (K / fpb) % group_size) : (bits != 8 || mn || neg7))
    return (int)cudaErrorInvalidValue;
  const Args a{static_cast<const float*>(x), static_cast<const unsigned char*>(w), scale, mn,
               static_cast<float*>(y), M, N, K, group_size, s_row, s_group, neg7};
  if (!grouped) return launch<false, 8>(a, st);
  switch (bits) {
    case 2: return launch<true, 2>(a, st);
    case 4: return launch<true, 4>(a, st);
    default: return launch<true, 8>(a, st);
  }
}

// F1 on the "tensor_core" design. All tensors contiguous, x and w on 16 bytes.
//   x: [M, K] bf16 (x_code 1, y bf16) or int8 codes (x_code 2, with x_scale
//   [M] f32; y f32 with out_f32, else bf16); K a multiple of 16.
//   w: [N, K] int8 codes.   scale: [N] f32.   y: [M, N].
//   The plan (ops/gemv.py w8_plan), by structure: 0 the ring, mt 1 (M <= 8)
//   or 4 x-row tiles of 8 per unit, K in ksplit ranges of tps tiles of 512
//   values (ksplit > 1 only with mt 1, at most W8_MAX_SPLITS), grid CTAs;
//   1 the direct-load kernel (M <= 8, K <= 4096, mt 1, ksplit 1, grid
//   ceil(N/16) CTAs); 2 the deep ring (M <= 8, mt 1, ksplit 1, one CTA an
//   SM). With ksplit > 1: part [ksplit, M, N] f32 (bf16 x) or int32 (int8 x)
//   scratch and tickets [ceil(M/8) * ceil(N/32)] int32, zero (the kernel
//   leaves them zero).
// Returns cudaGetLastError() (cudaErrorInvalidValue for what it does not take).
extern "C" int lowbit_gemv_w8(const void* x, const float* x_scale, const void* w, const float* scale, void* y,
                              void* part, int* tickets, int M, int N, int K, int x_code, int out_f32, int structure,
                              int mt, int ksplit, int tps, int grid, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int ktiles = (K + W8_KT - 1) / W8_KT;
  const bool direct = structure == 1;
  if (M < 1 || N < 1 || K < 16 || K % 16 || (x_code != 1 && x_code != 2) || (x_code == 2) != (x_scale != nullptr) ||
      (x_code == 1 && out_f32) || structure < 0 || structure > 2 || (mt != 1 && mt != 4) || ksplit < 1 ||
      ksplit > W8_MAX_SPLITS || tps < 1 || (ksplit - 1) * tps >= ktiles || ksplit * tps < ktiles || grid < 1 ||
      (ksplit > 1 && (mt != 1 || structure != 0 || !part || !tickets)) ||
      (structure != 0 && (mt != 1 || M > 8 || ksplit != 1)) || (direct && K > W8D_MAX_K))
    return (int)cudaErrorInvalidValue;
  const long long units = (long long)((N + W8_ROWS - 1) / W8_ROWS) * ((M + 8 * mt - 1) / (8 * mt)) * ksplit;
  if (units > (1ll << 30) || (direct && (long long)grid * 16 < N)) return (int)cudaErrorInvalidValue;
  const W8Args a{x, x_scale, static_cast<const unsigned char*>(w), scale, y, part, tickets, M, N, K, out_f32,
                 ksplit, tps, (int)units};
  return x_code == 2 ? launch_w8<true>(a, structure, mt, grid, st) : launch_w8<false>(a, structure, mt, grid, st);
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
