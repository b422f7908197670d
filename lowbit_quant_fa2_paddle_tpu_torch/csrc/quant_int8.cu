// Kernel C1: symmetric absmax INT8 quantization of HND [B, H, S, D] rows.
//
// Replaces the TPU kernel lowbit_quant_fa2_paddle_tpu/ops/quant.py:
// _quant_int8_kernel / _quant_int8_kernel_nokm (launched by quant_int8).
//
// Semantics, bit for bit with the TPU kernel as JAX compiles it:
//   v     = x - km                         (f32; km optional, per (b, h, d))
//   scale = fma(amax, f32(1/127), 1e-7)    (XLA's form of `amax / 127 + EPS`)
//   code  = clamp(roundf(v / scale), -127, 127)   IEEE division, ties away
// Per block, rows past S count as zeros BEFORE the km subtraction, so they
// enter the edge block's absmax as |km| (the TPU kernel's _mask_edge_rows
// order). Scales are emitted per row, [B, H, S].
//
// Bound on the H100: memory. The kernel reads 2 (bf16) or 4 (f32) bytes and
// writes 1 byte per element, a few FLOPs each, far below the 295 FLOP/byte
// ridge. The design keeps one pass over HBM: a warp owns a row (per token)
// or a CTA owns a row block (per block); the second read of the row for the
// codes hits L1/L2. No fast-math: codes depend on exact division.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float absmax_scale(float amax) {
  return __fmaf_rn(amax, 1.0f / 127.0f, 1e-7f);
}

__device__ __forceinline__ int8_t quant_code(float v, float scale) {
  float c = roundf(__fdiv_rn(v, scale));
  return static_cast<int8_t>(fminf(fmaxf(c, -127.0f), 127.0f));
}

constexpr int kThreads = 256;

// One warp per row.
template <typename T>
__global__ void __launch_bounds__(kThreads) quant_int8_per_token(
    const T* __restrict__ x, const float* __restrict__ km, int8_t* __restrict__ codes,
    float* __restrict__ scale, long long rows, int S, int D) {
  const long long row = (long long)blockIdx.x * (kThreads / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const T* xr = x + row * D;
  const float* kmr = km ? km + (row / S) * D : nullptr;
  float amax = 0.0f;
  for (int d = lane; d < D; d += 32) {
    float v = load_f32(xr + d);
    if (kmr) v = v - kmr[d];
    amax = fmaxf(amax, fabsf(v));
  }
  const float s = absmax_scale(warp_max(amax));
  int8_t* cr = codes + row * D;
  for (int d = lane; d < D; d += 32) {
    float v = load_f32(xr + d);
    if (kmr) v = v - kmr[d];
    cr[d] = quant_code(v, s);
  }
  if (lane == 0) scale[row] = s;
}

// One CTA per (b*h, block of rows).
template <typename T>
__global__ void __launch_bounds__(kThreads) quant_int8_per_block(
    const T* __restrict__ x, const float* __restrict__ km, int8_t* __restrict__ codes,
    float* __restrict__ scale, int S, int D, int block) {
  __shared__ float red[kThreads / 32];
  const long long bh = blockIdx.x;
  const int row0 = blockIdx.y * block;
  const T* xb = x + bh * S * D;
  const float* kmr = km ? km + bh * D : nullptr;
  const int n = block * D;
  float amax = 0.0f;
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const int r = row0 + i / D, d = i % D;
    float v = r < S ? load_f32(xb + (long long)r * D + d) : 0.0f;
    if (kmr) v = v - kmr[d];
    amax = fmaxf(amax, fabsf(v));
  }
  amax = warp_max(amax);
  const int warp = threadIdx.x / 32, lane = threadIdx.x & 31;
  if (lane == 0) red[warp] = amax;
  __syncthreads();
  if (warp == 0) {
    amax = warp_max(lane < kThreads / 32 ? red[lane] : 0.0f);
    if (lane == 0) red[0] = amax;
  }
  __syncthreads();
  const float s = absmax_scale(red[0]);
  int8_t* cb = codes + bh * S * D;
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const int r = row0 + i / D, d = i % D;
    if (r >= S) break;
    float v = load_f32(xb + (long long)r * D + d);
    if (kmr) v = v - kmr[d];
    cb[(long long)r * D + d] = quant_code(v, s);
  }
  for (int r = threadIdx.x; r < block && row0 + r < S; r += kThreads) scale[bh * S + row0 + r] = s;
}

template <typename T>
void launch(const void* x, const float* km, int8_t* codes, float* scale, long long bh, int S,
            int D, int block, cudaStream_t stream) {
  const T* xt = static_cast<const T*>(x);
  if (block <= 0) {
    const long long rows = bh * S;
    const unsigned grid = (unsigned)((rows + kThreads / 32 - 1) / (kThreads / 32));
    quant_int8_per_token<T><<<grid, kThreads, 0, stream>>>(xt, km, codes, scale, rows, S, D);
  } else {
    dim3 grid((unsigned)bh, (S + block - 1) / block);
    quant_int8_per_block<T><<<grid, kThreads, 0, stream>>>(xt, km, codes, scale, S, D, block);
  }
}

}  // namespace

// x: [bh, S, D] contiguous, dtype 0 = f32, 1 = bf16, 2 = f16.
// km: [bh, D] f32 or null. codes: [bh, S, D] int8. scale: [bh, S] f32.
// block <= 0 selects per-token scales. Returns cudaGetLastError().
extern "C" int lowbit_quant_int8(const void* x, int x_dtype, const float* km, int8_t* codes,
                                 float* scale, long long bh, int S, int D, int block,
                                 void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (x_dtype) {
    case 0: launch<float>(x, km, codes, scale, bh, S, D, block, st); break;
    case 1: launch<__nv_bfloat16>(x, km, codes, scale, bh, S, D, block, st); break;
    case 2: launch<__half>(x, km, codes, scale, bh, S, D, block, st); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
