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
// writes BITS/8 byte per element, a few operations each, far below the 295
// FLOP/byte ridge. Two designs (ops/quant.py kernel_design picks one by
// shape):
//
// "vector" (C1, C2, C3; every model path): a row is LANES lanes of 16 bytes
// (8 bf16/f16 or 4 f32 values a lane; LANES 4, 8, 16 or 32), so a warp holds
// 32/LANES rows a load. x is read where it lies, through its batch, head and
// row strides (the last dim contiguous, rows on 16 bytes), e.g. the DiT's K
// as a view of its qkv projection. A CTA's rows lie in one (b, h), so each
// lane keeps its columns of km in registers. Per token, a warp issues the
// loads of kGroups row groups before any math and keeps them in registers;
// the row's statistic is a shuffle over its lanes (the absmax, or for INT2
// each lane's f64 sum of its squares merged by f64 xor-shuffles), and the
// codes come from the same registers: one pass over HBM. Per block, a CTA
// owns one block (at most 8 loads a thread) and reduces it through shared
// memory in a fixed order. INT8 lanes store their 8 (f32: 4) codes in one
// store; for INT4 the high nibbles (columns + D/2) sit LANES/2 lanes up and
// arrive by one shuffle, and the low half of the row's lanes store the
// packed bytes; for INT2 the codes of columns + D/2 arrive by one shuffle
// down by LANES/2, then those of columns + D/4 (with theirs) by one down by
// LANES/4, and the lowest quarter of the row's lanes store. A warp's scales
// are gathered into lanes and stored together.
//   The code needs round(RN(v / scale)). The vector design multiplies by
// r = RN(1/scale) (one correctly rounded reciprocal a row) instead: q0 =
// RN(v*r) lies within |v/scale| * 3 * 2^-24 of the exact quotient, which is
// < 2^-15 for |v/scale| < 128, and for |q0| >= 128 both clamp to +-qmax. So
// wherever q0 is more than 2^-15 from a half-integer its nearest integer is
// the code; elsewhere (a few elements in 10^5) the element takes the IEEE
// division. The codes are those of the division for every f32 v and scale
// (tests/test_torch_quant.py emulates this over the rounding boundaries).
// The integer code leaves through the bits of c + 1.5*2^23 (exact for |c| <=
// 2^22), not a float-to-int conversion.
//
// "scalar" (inputs the vector design cannot read): x
// contiguous; a warp owns a row (per token) or a CTA owns a row block (per
// block); scalar loads, the second read of the row for the codes hits L1/L2,
// and each thread gathers the 8/BITS columns of one output byte so every byte
// is written once.
//
// No fast-math, and the roundings that matter are written as intrinsics
// (__fmul_rn, __fadd_rn, ...), which nvcc never contracts into an fma.

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
      // r / n as a multiply by 2^-p where n = 2^p (every per-token row and
      // every power-of-two block), exact as the division is.
      const double q = (n & (n - 1)) ? __ddiv_rn(r, (double)n)
                                     : __dmul_rn(r, __hiloint2double((1024 - __ffs(n)) << 20, 0));
      const float sig = __double2float_rn(__dsqrt_rn(q));
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

constexpr int kThreads = 256;  // both designs

// ---------------------------------------------------------------------------
// Design "scalar"
// ---------------------------------------------------------------------------

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

// ---------------------------------------------------------------------------
// Design "vector"
// ---------------------------------------------------------------------------

constexpr unsigned kFull = 0xffffffffu;
constexpr float kMagic = 12582912.0f;  // 1.5 * 2^23: c + kMagic holds integer c in its low bits
constexpr int kGroups = 4;             // row groups a warp loads before any math (per token)
constexpr int kMaxLoads = 8;           // 16-byte loads a thread holds (per block)
constexpr int kFewLoads = 2;           // blocks of at most this many loads run 8 CTAs an SM

// A lane's 16 bytes of a row as f32 values.
template <typename T>
struct Lane {
  static constexpr int E = 16 / sizeof(T);
  static __device__ __forceinline__ void unpack(const uint4& r, float (&f)[E]) {
    const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if constexpr (std::is_same<T, float>::value) {
        f[i] = __uint_as_float(w[i]);
      } else if constexpr (std::is_same<T, __nv_bfloat16>::value) {
        f[2 * i] = __uint_as_float(w[i] << 16);
        f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
      } else {
        const float2 h = __half22float2(*reinterpret_cast<const __half2*>(&w[i]));
        f[2 * i] = h.x;
        f[2 * i + 1] = h.y;
      }
    }
  }
};

// v = x - km for a lane's values, and their statistic folded into r (in
// order: the f64 sum of squares depends on it).
template <int BITS, typename T>
__device__ __forceinline__ void centre(const uint4& raw, const float (&kmv)[Lane<T>::E],
                                       float (&v)[Lane<T>::E], typename Stat<BITS>::T& r) {
  Lane<T>::unpack(raw, v);
#pragma unroll
  for (int j = 0; j < Lane<T>::E; ++j) {
    v[j] = __fsub_rn(v[j], kmv[j]);
    r = Stat<BITS>::add(r, v[j]);
  }
}

// The code of v as the low BITS of a word: round(RN(v / s)) clamped, from
// q0 = RN(v * rs), rs = RN(1 / s); the IEEE division only where q0 lies
// within 2^-15 of a half-integer (see the note at the top).
template <int BITS>
__device__ __forceinline__ uint32_t code_of(float v, float s, float rs) {
  constexpr float q = Stat<BITS>::kQmax;
  const float q0 = __fmul_rn(v, rs);
  float n = __fsub_rn(__fadd_rn(q0, kMagic), kMagic);
  if (fabsf(__fsub_rn(q0, n)) > 0.5f - 0x1p-15f) n = roundf(__fdiv_rn(v, s));
  const float c = fminf(fmaxf(n, -q), q);
  return __float_as_uint(__fadd_rn(c, kMagic)) & ((1u << BITS) - 1u);
}

// A lane's E codes, one a byte (INT8 codes, or INT4 / INT2 codes in the low bits).
template <int BITS, int E>
__device__ __forceinline__ void lane_codes(const float (&v)[E], float s, float rs, uint32_t (&w)[E / 4]) {
#pragma unroll
  for (int k = 0; k < E / 4; ++k) {
    const uint32_t lo = __byte_perm(code_of<BITS>(v[4 * k], s, rs), code_of<BITS>(v[4 * k + 1], s, rs), 0x0040);
    const uint32_t hi = __byte_perm(code_of<BITS>(v[4 * k + 2], s, rs), code_of<BITS>(v[4 * k + 3], s, rs), 0x0040);
    w[k] = __byte_perm(lo, hi, 0x5410);
  }
}

// Store a lane's bytes of one row. INT4: byte i holds columns i and i + D/2,
// which lie in lanes t and t + LANES/2 of the row; one shuffle brings the
// high nibbles down and the low half of the row's lanes store. INT2: byte i
// holds columns i + p*D/4 (bits 2p), which lie in lanes t + p*LANES/4; the
// shuffle by LANES/2 brings columns + D/2 to bits 4, the one by LANES/4 then
// brings columns + D/4 and + 3D/4 to bits 2 and 6, and the lowest quarter of
// the row's lanes store. Every lane of the warp runs the shuffles.
template <int BITS, int LANES, int E>
__device__ __forceinline__ void store_codes(uint32_t (&w)[E / 4], uint8_t* orow, int t, bool valid) {
  if constexpr (BITS == 4 || BITS == 2) {
#pragma unroll
    for (int k = 0; k < E / 4; ++k) w[k] |= __shfl_down_sync(kFull, w[k], LANES / 2) << 4;
    valid = valid && t < LANES / 2;
  }
  if constexpr (BITS == 2) {
#pragma unroll
    for (int k = 0; k < E / 4; ++k) w[k] |= __shfl_down_sync(kFull, w[k], LANES / 4) << 2;
    valid = valid && t < LANES / 4;
  }
  if (!valid) return;
  if constexpr (E == 8) {
    *reinterpret_cast<uint2*>(orow + t * E) = make_uint2(w[0], w[1]);
  } else {
    *reinterpret_cast<uint32_t*>(orow + t * E) = w[0];
  }
}

template <int E>
__device__ __forceinline__ void load_km(const float* km, long long bh, int D, int col, float (&kmv)[E]) {
#pragma unroll
  for (int j = 0; j < E; j += 4) {
    const float4 k4 = km ? __ldg(reinterpret_cast<const float4*>(km + bh * D + col + j)) : make_float4(0, 0, 0, 0);
    kmv[j] = k4.x;
    kmv[j + 1] = k4.y;
    kmv[j + 2] = k4.z;
    kmv[j + 3] = k4.w;
  }
}

// Strides of x in elements: sb (batch), sh (head), ss (row); the last dim is
// contiguous. Per token: a CTA covers kGroups * 8 * 32/LANES rows of one
// (b, h); CTAs run (b, h) fastest, so CTAs in flight read neighbouring heads
// of the same rows (one span of the DiT's qkv rows).
template <int BITS, typename T, int LANES>
__global__ void __launch_bounds__(kThreads) quant_per_token_vec(
    const T* __restrict__ x, long long sb, long long sh, long long ss, int H, const float* __restrict__ km,
    uint8_t* __restrict__ out, float* __restrict__ scale, int BH, int S) {
  constexpr int E = Lane<T>::E, D = LANES * E, W = D * BITS / 8, RPW = 32 / LANES;
  constexpr int ROWS_WARP = kGroups * RPW, ROWS_CTA = ROWS_WARP * (kThreads / 32);
  const int bh = blockIdx.x % BH;
  const int warp = threadIdx.x / 32, lane = threadIdx.x & 31;
  const int sub = lane / LANES, t = lane % LANES;
  const int row0 = (blockIdx.x / BH) * ROWS_CTA + warp * ROWS_WARP;
  const T* xb = x + (long long)(bh / H) * sb + (long long)(bh % H) * sh + t * E;
  uint4 raw[kGroups];
#pragma unroll
  for (int g = 0; g < kGroups; ++g) {
    const int r = row0 + g * RPW + sub;
    raw[g] = r < S ? __ldg(reinterpret_cast<const uint4*>(xb + r * ss)) : make_uint4(0, 0, 0, 0);
  }
  float kmv[E];
  load_km(km, bh, D, t * E, kmv);
  if constexpr (BITS == 2) {
    // The rows' sums of squares first, each merged over its lanes; then the
    // scale and its reciprocal once a row, in lane j for row j = g * RPW + sub
    // of the warp's ROWS_WARP, so the f64 square root runs once for all of
    // them; the lanes of each row read theirs back.
    float v[kGroups][E];
    double sum[kGroups];
#pragma unroll
    for (int g = 0; g < kGroups; ++g) {
      sum[g] = 0.0;
      centre<BITS, T>(raw[g], kmv, v[g], sum[g]);
#pragma unroll
      for (int o = LANES / 2; o > 0; o >>= 1) sum[g] = Stat<BITS>::merge(sum[g], __shfl_xor_sync(kFull, sum[g], o));
    }
    double mine = 0.0;
#pragma unroll
    for (int g = 0; g < kGroups; ++g) {
      const double r = __shfl_sync(kFull, sum[g], (lane % RPW) * LANES);
      if (lane / RPW == g) mine = r;
    }
    const float sj = Stat<BITS>::scale(mine, D), rj = __frcp_rn(sj);
#pragma unroll
    for (int g = 0; g < kGroups; ++g) {
      const int r = row0 + g * RPW + sub;
      uint32_t w[E / 4];
      lane_codes<BITS>(v[g], __shfl_sync(kFull, sj, g * RPW + sub), __shfl_sync(kFull, rj, g * RPW + sub), w);
      store_codes<BITS, LANES, E>(w, out + ((long long)bh * S + r) * W, t, r < S);
    }
    if (lane < ROWS_WARP && row0 + lane < S) scale[(long long)bh * S + row0 + lane] = sj;
    return;
  }
  float sc[kGroups];
#pragma unroll
  for (int g = 0; g < kGroups; ++g) {
    const int r = row0 + g * RPW + sub;
    float v[E];
    typename Stat<BITS>::T m = 0;
    centre<BITS, T>(raw[g], kmv, v, m);
#pragma unroll
    for (int o = LANES / 2; o > 0; o >>= 1) m = Stat<BITS>::merge(m, __shfl_xor_sync(kFull, m, o));
    const float s = Stat<BITS>::scale(m, D);
    sc[g] = s;
    uint32_t w[E / 4];
    lane_codes<BITS>(v, s, __frcp_rn(s), w);
    store_codes<BITS, LANES, E>(w, out + ((long long)bh * S + r) * W, t, r < S);
  }
  // The warp's ROWS_WARP scales, row j = g * RPW + sub from lane sub * LANES,
  // gathered into lane j and stored as one run.
  float mine = 0.0f;
#pragma unroll
  for (int g = 0; g < kGroups; ++g) {
    const float s = __shfl_sync(kFull, sc[g], (lane % RPW) * LANES);
    if (lane / RPW == g) mine = s;
  }
  if (lane < ROWS_WARP && row0 + lane < S) scale[(long long)bh * S + row0 + lane] = mine;
}

// Per block: a CTA owns rows [blk * block, (blk + 1) * block) of one (b, h),
// loads = block * LANES / 256 loads a thread (1 to MAXL), all in registers;
// rows past S load as zeros and enter the statistic as -km. A CTA's life is
// one load latency and a reduction, so the kernel for blocks of at most
// kFewLoads loads (block 64 at d64) holds registers for those alone and
// keeps 8 CTAs an SM.
template <int BITS, typename T, int LANES, int MAXL>
__global__ void __launch_bounds__(kThreads, MAXL <= kFewLoads ? 8 : 1) quant_per_block_vec(
    const T* __restrict__ x, long long sb, long long sh, long long ss, int H, const float* __restrict__ km,
    uint8_t* __restrict__ out, float* __restrict__ scale, int BH, int S, int block) {
  constexpr int E = Lane<T>::E, D = LANES * E, W = D * BITS / 8, RPL = kThreads / LANES;
  using St = Stat<BITS>;
  __shared__ typename St::T red[kThreads / 32];
  const int bh = blockIdx.x % BH;
  const int row0 = (blockIdx.x / BH) * block, loads = block / RPL;
  const int sub = threadIdx.x / LANES, t = threadIdx.x % LANES;
  const T* xb = x + (long long)(bh / H) * sb + (long long)(bh % H) * sh + t * E;
  uint4 raw[MAXL];
#pragma unroll
  for (int c = 0; c < MAXL; ++c) {
    const int r = row0 + c * RPL + sub;
    raw[c] = c < loads && r < S ? __ldg(reinterpret_cast<const uint4*>(xb + r * ss)) : make_uint4(0, 0, 0, 0);
  }
  float kmv[E];
  load_km(km, bh, D, t * E, kmv);
  typename St::T m = 0;
#pragma unroll
  for (int c = 0; c < MAXL; ++c) {
    if (c < loads) {
      float v[E];
      centre<BITS, T>(raw[c], kmv, v, m);
    }
  }
  m = warp_merge<BITS>(m);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x / 32] = m;
  __syncthreads();
  m = red[0];  // the warps' statistics merged in a fixed order
#pragma unroll
  for (int i = 1; i < kThreads / 32; ++i) m = St::merge(m, red[i]);
  float s, rs;
  if constexpr (BITS == 2) {  // the f64 square root once, in thread 0
    __shared__ float sr[2];
    if (threadIdx.x == 0) {
      sr[0] = St::scale(m, block * D);
      sr[1] = __frcp_rn(sr[0]);
    }
    __syncthreads();
    s = sr[0], rs = sr[1];
  } else {
    s = St::scale(m, block * D), rs = __frcp_rn(s);
  }
#pragma unroll
  for (int c = 0; c < MAXL; ++c) {
    if (c < loads) {
      const int r = row0 + c * RPL + sub;
      float v[E];
      typename St::T unused = 0;
      centre<BITS, T>(raw[c], kmv, v, unused);
      uint32_t w[E / 4];
      lane_codes<BITS>(v, s, rs, w);
      store_codes<BITS, LANES, E>(w, out + ((long long)bh * S + r) * W, t, r < S);
    }
  }
  for (int i = threadIdx.x; i < block && row0 + i < S; i += kThreads) scale[(long long)bh * S + row0 + i] = s;
}

template <int BITS, typename T, int LANES>
void launch_vec(const void* x, long long sb, long long sh, long long ss, int H, const float* km, uint8_t* out,
                float* scale, int BH, int S, int block, cudaStream_t stream) {
  const T* xt = static_cast<const T*>(x);
  if (block <= 0) {
    constexpr int rows = kGroups * (32 / LANES) * (kThreads / 32);
    const unsigned grid = (unsigned)(((long long)S + rows - 1) / rows * BH);
    quant_per_token_vec<BITS, T, LANES><<<grid, kThreads, 0, stream>>>(xt, sb, sh, ss, H, km, out, scale, BH, S);
  } else {
    const unsigned grid = (unsigned)(((long long)S + block - 1) / block * BH);
    if (block * LANES / kThreads <= kFewLoads) {
      quant_per_block_vec<BITS, T, LANES, kFewLoads><<<grid, kThreads, 0, stream>>>(xt, sb, sh, ss, H, km, out,
                                                                                   scale, BH, S, block);
    } else {
      quant_per_block_vec<BITS, T, LANES, kMaxLoads><<<grid, kThreads, 0, stream>>>(xt, sb, sh, ss, H, km, out,
                                                                                   scale, BH, S, block);
    }
  }
}

template <int BITS, typename T>
int dispatch_lanes(const void* x, long long sb, long long sh, long long ss, int H, const float* km, uint8_t* out,
                   float* scale, int BH, int S, int D, int block, cudaStream_t st) {
  const int lanes = D / Lane<T>::E;
  if (D % Lane<T>::E) return (int)cudaErrorInvalidValue;
  if (block > 0 && (block * lanes % kThreads || block * lanes / kThreads > kMaxLoads))
    return (int)cudaErrorInvalidValue;
  switch (lanes) {
    case 4: launch_vec<BITS, T, 4>(x, sb, sh, ss, H, km, out, scale, BH, S, block, st); break;
    case 8: launch_vec<BITS, T, 8>(x, sb, sh, ss, H, km, out, scale, BH, S, block, st); break;
    case 16: launch_vec<BITS, T, 16>(x, sb, sh, ss, H, km, out, scale, BH, S, block, st); break;
    case 32: launch_vec<BITS, T, 32>(x, sb, sh, ss, H, km, out, scale, BH, S, block, st); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

template <int BITS>
int dispatch_vec(const void* x, int x_dtype, long long sb, long long sh, long long ss, int H, const float* km,
                 uint8_t* out, float* scale, int BH, int S, int D, int block, cudaStream_t st) {
  switch (x_dtype) {
    case 0: return dispatch_lanes<BITS, float>(x, sb, sh, ss, H, km, out, scale, BH, S, D, block, st);
    case 1: return dispatch_lanes<BITS, __nv_bfloat16>(x, sb, sh, ss, H, km, out, scale, BH, S, D, block, st);
    case 2: return dispatch_lanes<BITS, __half>(x, sb, sh, ss, H, km, out, scale, BH, S, D, block, st);
    default: return (int)cudaErrorInvalidValue;
  }
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

// Design "vector" (bits 8, 4 or 2). x: [B, H, S, D] with element strides sb, sh,
// ss and a contiguous last dim, every row on 16 bytes; D * sizeof(dtype) =
// 16 * LANES, LANES 4, 8, 16 or 32; per block (block > 0), block * LANES a
// multiple of 256 and at most 8 * 256. km, codes and scale as for
// lowbit_quant (bh = B * H). Returns cudaGetLastError(), or
// cudaErrorInvalidValue for a shape the design does not take.
extern "C" int lowbit_quant_vec(const void* x, int x_dtype, long long sb, long long sh, long long ss, int H,
                                const float* km, int8_t* codes, float* scale, int bh, int S, int D, int block,
                                int bits, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  uint8_t* out = reinterpret_cast<uint8_t*>(codes);
  switch (bits) {
    case 8: return dispatch_vec<8>(x, x_dtype, sb, sh, ss, H, km, out, scale, bh, S, D, block, st);
    case 4: return dispatch_vec<4>(x, x_dtype, sb, sh, ss, H, km, out, scale, bh, S, D, block, st);
    case 2: return dispatch_vec<2>(x, x_dtype, sb, sh, ss, H, km, out, scale, bh, S, D, block, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
