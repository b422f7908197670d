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
// would bound; the least time is the packed bytes over 3.35 TB/s. The TPU
// kernel holds a whole row tile and all of x in VMEM and runs one MXU dot
// per part; here no operand is staged in shared memory. A CTA of 4 warps
// owns 4 rows of W (so N/4 CTAs fill the card even at N = 1024); its warps
// split K, each lane streaming 16 packed bytes of every row at a time with a
// 16-byte evict-first load, and reading the x values of those codes
// (16 per part per x row) straight from global memory through L1, where the
// 4 rows and 4 warps of a CTA reuse them. f32 accumulation, a warp
// reduction by shuffles, then a fixed-order sum of the 4 warps through
// shared memory: the result does not depend on scheduling. x rows come in
// tiles of 4 (M <= 4) or 8; larger M re-reads W per tile. Unpacking in
// bulk, tensor cores for larger M and a split over K for small N are later
// speed work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

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
  return dispatch_bits<__nv_bfloat16, __nv_bfloat16>(bits, a, st);
}
