// Kernels C1, C2, C3: symmetric INT8 / INT4 / INT2 quantization of HND
// [B, H, S, D] rows, one template on the bit width.
//
// Replaces the TPU kernels of lowbit_quant_fa2_paddle_tpu/ops/quant.py:
//   C1 _quant_int8_kernel / _nokm (launched by quant_int8, pallas_call :215),
//   C2 _quant_int4_kernel / _nokm (quant_int4, :327),
//   C3 _quant_int2_kernel / _nokm (quant_int2, :406).
//
// Semantics, as the TPU kernels compute them when JAX compiles them:
//   v     = x - km                         (f32; km optional, per (b, h, d))
//   INT8  scale = fma(amax, f32(1/127), 1e-7)   (XLA's form of amax/127 + EPS)
//   INT4  scale = fma(amax, f32(1/7), 1e-7)
//   INT2  scale = fma(f32(sqrt(sum v^2 / n)), f32(1.224), 1e-7)   Lloyd-Max
//   code  = clamp(roundf(v / scale), -qmax, qmax)   IEEE division, ties away
// The INT2 sum of squares runs in f64 (each square is exact there), so the
// scale is the correctly rounded rms up to the last f64 bit; XLA sums in f32
// in its own order and lands within an ulp or two of it.
// Per block, rows past S count as zeros BEFORE the km subtraction, so they
// enter the edge block's statistic as -km (the TPU kernel's _mask_edge_rows
// order). Scales are emitted per row, [B, H, S].
//
// Packing (8 / BITS codes per byte): code p of byte i of a row holds column
// i + p*W at bits [p*BITS, (p+1)*BITS), W = D*BITS/8 bytes per row: halves of
// D for INT4 (low nibble column i, high nibble column i + D/2), quarters of D
// for INT2. INT8 is the degenerate case (one code per byte).
//
// Bound on the H100: memory. Each kernel reads 2 (bf16) or 4 (f32) bytes and
// writes BITS/8 byte per element, a few FLOPs each, far below the 295
// FLOP/byte ridge. The design keeps one pass over HBM: a warp owns a row (per
// token) or a CTA owns a row block (per block); the second read of the row for
// the codes hits L1/L2, and each thread gathers the 8/BITS columns of one
// output byte so every byte is written once. No fast-math: codes depend on
// exact division.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

template <typename T>
__device__ __forceinline__ float load_f32(const T* p);
template <>
__device__ __forceinline__ float load_f32<float>(const float* p) { return *p; }
template <>
__device__ __forceinline__ float load_f32<__nv_bfloat16>(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
template <>
__device__ __forceinline__ float load_f32<__half>(const __half* p) { return __half2float(*p); }

// The row (or block) statistic a bit width scales by: absmax for INT8/INT4,
// the f64 sum of squares for INT2.
template <int BITS>
struct Stat {
  using T = typename std::conditional<BITS == 2, double, float>::type;
  static constexpr float kQmax = BITS == 8 ? 127.0f : BITS == 4 ? 7.0f : 1.0f;

  static __device__ __forceinline__ T add(T a, float v) {
    if constexpr (BITS == 2) {
      return a + (double)v * (double)v;
    } else {
      return fmaxf(a, fabsf(v));
    }
  }
  static __device__ __forceinline__ T merge(T a, T b) {
    if constexpr (BITS == 2) {
      return a + b;
    } else {
      return fmaxf(a, b);
    }
  }
  // n: elements the statistic covers (the rms divides by it).
  static __device__ __forceinline__ float scale(T r, int n) {
    if constexpr (BITS == 2) {
      const float sig = __double2float_rn(__dsqrt_rn(__ddiv_rn(r, (double)n)));
      return __fmaf_rn(sig, 1.224f, 1e-7f);
    } else {
      return __fmaf_rn(r, 1.0f / kQmax, 1e-7f);
    }
  }
};

template <int BITS, typename T>
__device__ __forceinline__ T warp_merge(T v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = Stat<BITS>::merge(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

template <int BITS>
__device__ __forceinline__ uint32_t quant_bits(float v, float scale) {
  constexpr float q = Stat<BITS>::kQmax;
  const float c = fminf(fmaxf(roundf(__fdiv_rn(v, scale)), -q), q);
  return static_cast<uint32_t>(static_cast<int>(c)) & ((1u << BITS) - 1u);
}

// Byte i of one row: codes of columns i + p*W, p < 8/BITS.
template <int BITS, typename T>
__device__ __forceinline__ uint8_t pack_byte(const T* xr, const float* kmr, int i, int W,
                                             float scale) {
  uint32_t byte = 0;
#pragma unroll
  for (int p = 0; p < 8 / BITS; ++p) {
    float v = load_f32(xr + i + p * W);
    if (kmr) v = v - kmr[i + p * W];
    byte |= quant_bits<BITS>(v, scale) << (p * BITS);
  }
  return static_cast<uint8_t>(byte);
}

constexpr int kThreads = 256;

// One warp per row.
template <int BITS, typename T>
__global__ void __launch_bounds__(kThreads) quant_per_token(
    const T* __restrict__ x, const float* __restrict__ km, uint8_t* __restrict__ out,
    float* __restrict__ scale, long long rows, int S, int D) {
  using St = Stat<BITS>;
  const long long row = (long long)blockIdx.x * (kThreads / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const T* xr = x + row * D;
  const float* kmr = km ? km + (row / S) * D : nullptr;
  typename St::T r = 0;
  for (int d = lane; d < D; d += 32) {
    float v = load_f32(xr + d);
    if (kmr) v = v - kmr[d];
    r = St::add(r, v);
  }
  const float s = St::scale(warp_merge<BITS>(r), D);
  const int W = D * BITS / 8;
  uint8_t* orow = out + row * W;
  for (int i = lane; i < W; i += 32) orow[i] = pack_byte<BITS>(xr, kmr, i, W, s);
  if (lane == 0) scale[row] = s;
}

// One CTA per (b*h, block of rows).
template <int BITS, typename T>
__global__ void __launch_bounds__(kThreads) quant_per_block(
    const T* __restrict__ x, const float* __restrict__ km, uint8_t* __restrict__ out,
    float* __restrict__ scale, int S, int D, int block) {
  using St = Stat<BITS>;
  __shared__ typename St::T red[kThreads / 32];
  const long long bh = blockIdx.x;
  const int row0 = blockIdx.y * block;
  const T* xb = x + bh * S * D;
  const float* kmr = km ? km + bh * D : nullptr;
  const int n = block * D;
  typename St::T r = 0;
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const int row = row0 + i / D, d = i % D;
    float v = row < S ? load_f32(xb + (long long)row * D + d) : 0.0f;
    if (kmr) v = v - kmr[d];
    r = St::add(r, v);
  }
  r = warp_merge<BITS>(r);
  const int warp = threadIdx.x / 32, lane = threadIdx.x & 31;
  if (lane == 0) red[warp] = r;
  __syncthreads();
  if (warp == 0) {
    r = warp_merge<BITS>(lane < kThreads / 32 ? red[lane] : typename St::T(0));
    if (lane == 0) red[0] = r;
  }
  __syncthreads();
  const float s = St::scale(red[0], n);
  const int W = D * BITS / 8;
  uint8_t* ob = out + bh * S * W;
  for (int i = threadIdx.x; i < block * W; i += kThreads) {
    const int row = row0 + i / W, c = i % W;
    if (row >= S) break;
    ob[(long long)row * W + c] = pack_byte<BITS>(xb + (long long)row * D, kmr, c, W, s);
  }
  for (int i = threadIdx.x; i < block && row0 + i < S; i += kThreads) scale[bh * S + row0 + i] = s;
}

template <int BITS, typename T>
void launch(const void* x, const float* km, uint8_t* out, float* scale, long long bh, int S,
            int D, int block, cudaStream_t stream) {
  const T* xt = static_cast<const T*>(x);
  if (block <= 0) {
    const long long rows = bh * S;
    const unsigned grid = (unsigned)((rows + kThreads / 32 - 1) / (kThreads / 32));
    quant_per_token<BITS, T><<<grid, kThreads, 0, stream>>>(xt, km, out, scale, rows, S, D);
  } else {
    dim3 grid((unsigned)bh, (S + block - 1) / block);
    quant_per_block<BITS, T><<<grid, kThreads, 0, stream>>>(xt, km, out, scale, S, D, block);
  }
}

template <int BITS>
int dispatch_dtype(const void* x, int x_dtype, const float* km, uint8_t* out, float* scale,
                   long long bh, int S, int D, int block, cudaStream_t st) {
  switch (x_dtype) {
    case 0: launch<BITS, float>(x, km, out, scale, bh, S, D, block, st); break;
    case 1: launch<BITS, __nv_bfloat16>(x, km, out, scale, bh, S, D, block, st); break;
    case 2: launch<BITS, __half>(x, km, out, scale, bh, S, D, block, st); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// x: [bh, S, D] contiguous, dtype 0 = f32, 1 = bf16, 2 = f16.
// km: [bh, D] f32 or null. codes: [bh, S, D*bits/8] int8 (packed for bits 4
// and 2; D a multiple of 8/bits). scale: [bh, S] f32. block <= 0 selects
// per-token scales. bits: 8, 4 or 2. Returns cudaGetLastError().
extern "C" int lowbit_quant(const void* x, int x_dtype, const float* km, int8_t* codes,
                            float* scale, long long bh, int S, int D, int block, int bits,
                            void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  uint8_t* out = reinterpret_cast<uint8_t*>(codes);
  switch (bits) {
    case 8: return dispatch_dtype<8>(x, x_dtype, km, out, scale, bh, S, D, block, st);
    case 4: return dispatch_dtype<4>(x, x_dtype, km, out, scale, bh, S, D, block, st);
    case 2: return dispatch_dtype<2>(x, x_dtype, km, out, scale, bh, S, D, block, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
