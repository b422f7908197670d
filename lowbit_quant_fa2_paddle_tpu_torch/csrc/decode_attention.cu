// Kernel D: single-token decode attention over a contiguous int8 or bf16 KV cache.
//
// Replaces the TPU kernel lowbit_quant_fa2_paddle_tpu/ops/decode.py:
// _decode_kernel (launched by decode_attention, pallas_call at :727) for one
// query token per sequence over a contiguous cache: int8 codes with per-token
// f32 scales or bf16 rows, chosen per side; GQA; lengths read on the device;
// base-2 LSE out.
//
// Math per key, as in the TPU kernel:
//   int8 K:  qa = fma(max|q|, 1/127, 1e-7), q8 = round_away(q / qa)
//            s  = ((f32(q8 . k8) * (qa * sm_scale)) * ks) * log2e
//   float:   s  = (((q . k) * sm_scale) * ks) * log2e          (f32 dot)
//   s = -0.7 * FLT_MAX where pos >= length;  online softmax in base 2 with
//   f32 P (P is NOT rounded to bf16); l sums P; an int8 V's scale is folded
//   into P after that; acc += P V in f32; o = acc / l, lse = m + log2 l.
//
// Bound on the H100: memory. Decode streams the whole cache once per token
// (at b4 hk8 s32768 d128: 268 MB of int8 K/V, 537 MB of bf16) for ~2 FLOPs
// per byte. The TPU kernel walks the cache with one grid row per (batch, KV
// head); that would fill 32 of 132 SMs here. So the KV axis is split: the
// first kernel gives each CTA one (batch, KV head, query rows, split) and
// writes the split's unnormalised (acc, m, l); the second merges the splits.
// The split count comes from the cache size and the SM count on the host,
// never from the lengths (reading them there would sync the decode loop).
// Rows at or past a sequence's length are never loaded: after a rollback
// they may hold stale data. A split wholly past the length writes
// m = -1e30, l = 0 and the merge gives it no weight.
//
// Design of the split pass (4 warps): K/V tiles of 64 keys stream through a
// two-stage cp.async ring in padded shared memory. QK: each thread dots one
// key with the CTA's query rows over half of D (__dp4a on int8 codes, fma on
// floats); the softmax runs one warp per query row; PV: each thread owns 4
// output columns of every row for a quarter (d128) of the keys, so a V word
// is loaded and widened once for all rows. int8 codes widen by a byte
// permute and one subtraction, off the conversion pipe. mma/wgmma and TMA
// are later work.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BK = 64;    // keys per tile
constexpr int NT = 128;   // threads per CTA of the split pass
constexpr int RMAX = 8;   // query rows per CTA, at most
constexpr int SROW = BK + 1;  // padded row of the score buffers (floats)
constexpr float MASK_VALUE = (float)(-0.7 * 3.4028234663852886e38);
constexpr float NEG_INIT = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

// ---------------------------------------------------------------------------
// Helpers
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

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Four int8 codes of a word to exact floats: each byte, biased by 128, is
// placed in the mantissa of 2^23 and the bias subtracted.
__device__ __forceinline__ void widen(uint32_t w, float* f) {
  const uint32_t u = w ^ 0x80808080u;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    f[i] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540 | i)) - 8388736.0f;
}

// Two bf16 of a word to floats.
__device__ __forceinline__ void widen_bf16(uint32_t w, float* f) {
  f[0] = __uint_as_float(w << 16);
  f[1] = __uint_as_float(w & 0xffff0000u);
}

// The elements of one 16-byte chunk of a cache row, as floats.
template <typename T>
__device__ __forceinline__ void widen16(const uint4& c, float* f) {
  if constexpr (sizeof(T) == 1) {
    widen(c.x, f);
    widen(c.y, f + 4);
    widen(c.z, f + 8);
    widen(c.w, f + 12);
  } else {
    widen_bf16(c.x, f);
    widen_bf16(c.y, f + 2);
    widen_bf16(c.z, f + 4);
    widen_bf16(c.w, f + 6);
  }
}

// The four elements [4c, 4c+4) of a cache row, as floats.
template <typename T>
__device__ __forceinline__ void widen4(const unsigned char* row, int c, float* f) {
  if constexpr (sizeof(T) == 1) {
    widen(*reinterpret_cast<const uint32_t*>(row + 4 * c), f);
  } else {
    const uint2 w = *reinterpret_cast<const uint2*>(row + 8 * c);
    widen_bf16(w.x, f);
    widen_bf16(w.y, f + 2);
  }
}

// Address of cache row `key` of the (batch, KV head) row `bh`. This is the
// one place a paged cache would look the row up in its page table.
template <typename T>
__device__ __forceinline__ const T* cache_row(const T* base, long long bh, int key, int S, int width) {
  return base + (bh * S + key) * (long long)width;
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
template <>
__device__ __forceinline__ __half from_f32<__half>(float v) { return __float2half_rn(v); }

// ---------------------------------------------------------------------------
// Shared memory of the split pass. Cache rows are padded by 16 bytes, so the
// 8 rows a quarter-warp reads with 16-byte loads fall on distinct banks.
// ---------------------------------------------------------------------------

template <int D, typename KT, typename VT>
struct Smem {
  static constexpr int kKRow = D * (int)sizeof(KT) + 16;  // bytes
  static constexpr int kVRow = D * (int)sizeof(VT) + 16;
  static constexpr int kKOff = 0;
  static constexpr int kVOff = kKOff + 2 * BK * kKRow;
  static constexpr int kKsOff = kVOff + 2 * BK * kVRow;      // 2 x BK f32 K scales
  static constexpr int kVsOff = kKsOff + 2 * BK * 4;         // 2 x BK f32 V scales
  static constexpr int kSOff = kVsOff + 2 * BK * 4;          // 2 halves x RMAX x SROW f32
  static constexpr int kQOff = kSOff + 2 * RMAX * SROW * 4;  // RMAX x D f32 queries
  static constexpr int kQ8Off = kQOff + RMAX * D * 4;        // RMAX x D int8 query codes
  static constexpr int kMiscOff = kQ8Off + RMAX * D;         // alpha[RMAX], q scale[RMAX]
  static constexpr int kLoop = kMiscOff + 2 * RMAX * 4;
  static constexpr int kKG = NT / (D / 4);                   // key groups of the PV pass
  static constexpr int kRed = kKG * RMAX * D * 4;            // PV partials, after the loop
  static constexpr int kTotal = kLoop > kRed ? kLoop : kRed;
  static_assert(kQOff % 16 == 0 && kQ8Off % 16 == 0, "16-byte aligned query buffers");
};

// ---------------------------------------------------------------------------
// Split pass. Grid: (n_splits, Hk * groups, B), groups = (H / Hk) / R.
// ---------------------------------------------------------------------------

template <int D, typename KT, typename VT, bool kIntQK>
__global__ void __launch_bounds__(NT) decode_split_kernel(
    const float* __restrict__ q, const KT* __restrict__ k, const VT* __restrict__ v,
    const float* __restrict__ k_scale, const float* __restrict__ v_scale,
    const int* __restrict__ lengths, float* __restrict__ part_acc, float* __restrict__ part_ml,
    int H, int Hk, int S, int R, int n_splits, int chunk, float sm_scale) {
  using L = Smem<D, KT, VT>;
  constexpr bool kVInt8 = sizeof(VT) == 1;
  constexpr int KCPR = D * (int)sizeof(KT) / 16;  // 16-byte chunks per K row
  constexpr int VCPR = D * (int)sizeof(VT) / 16;
  constexpr int EPC = 16 / (int)sizeof(KT);       // K elements per chunk
  constexpr int KG = L::kKG;
  constexpr int CW = D / 4;                       // 4-column groups per row

  extern __shared__ __align__(16) unsigned char smem[];
  float* ks_s = reinterpret_cast<float*>(smem + L::kKsOff);
  float* vs_s = reinterpret_cast<float*>(smem + L::kVsOff);
  float* S0 = reinterpret_cast<float*>(smem + L::kSOff);  // [2][RMAX][SROW]
  float* q_s = reinterpret_cast<float*>(smem + L::kQOff);
  int8_t* q8_s = reinterpret_cast<int8_t*>(smem + L::kQ8Off);
  float* alpha_s = reinterpret_cast<float*>(smem + L::kMiscOff);
  float* qsc_s = alpha_s + RMAX;

  const int split = blockIdx.x, b = blockIdx.z;
  const int groups = (H / Hk) / R;
  const int hk = blockIdx.y / groups;
  const int h0 = hk * (H / Hk) + (blockIdx.y % groups) * R;  // first query head of this CTA
  const int tid = threadIdx.x, warp = tid / 32, lane = tid & 31;
  const long long kh = (long long)b * Hk + hk;

  const int len = min(max(lengths[b], 0), S);
  const int start = split * chunk;
  const int end = min(start + chunk, len);
  float* pacc = part_acc + ((long long)b * H + h0) * n_splits * D;
  float* pml = part_ml + ((long long)b * H + h0) * n_splits * 2;

  if (start >= end) {  // nothing visible in this split
    for (int i = tid; i < R * D; i += NT) pacc[((long long)(i / D) * n_splits + split) * D + i % D] = 0.0f;
    if (tid < R) {
      pml[((long long)tid * n_splits + split) * 2] = NEG_INIT;
      pml[((long long)tid * n_splits + split) * 2 + 1] = 0.0f;
    }
    return;
  }

  // ---- K/V tile loads; nothing at or past `end` is read ----
  auto load_tile = [&](int key0, int buf) {
    unsigned char* Kd = smem + L::kKOff + buf * BK * L::kKRow;
    unsigned char* Vd = smem + L::kVOff + buf * BK * L::kVRow;
    for (int c = tid; c < BK * KCPR; c += NT) {
      const int r = c / KCPR, cc = c % KCPR;
      const bool ok = key0 + r < end;
      const KT* src = cache_row(k, kh, ok ? key0 + r : start, S, D) + cc * EPC;
      cp_async16(Kd + r * L::kKRow + cc * 16, src, ok);
    }
    for (int c = tid; c < BK * VCPR; c += NT) {
      const int r = c / VCPR, cc = c % VCPR;
      const bool ok = key0 + r < end;
      const VT* src = cache_row(v, kh, ok ? key0 + r : start, S, D) + cc * (16 / (int)sizeof(VT));
      cp_async16(Vd + r * L::kVRow + cc * 16, src, ok);
    }
    if (tid < BK) {
      const bool ok = key0 + tid < end;
      cp_async4(ks_s + buf * BK + tid, cache_row(k_scale, kh, ok ? key0 + tid : start, S, 1), ok);
      if constexpr (kVInt8)
        cp_async4(vs_s + buf * BK + tid, cache_row(v_scale, kh, ok ? key0 + tid : start, S, 1), ok);
    }
  };

  const int n_tiles = (end - start + BK - 1) / BK;
  load_tile(start, 0);
  cp_async_commit();

  // ---- the CTA's query rows; int8 K quantizes them per row here ----
  const float* qg = q + ((long long)b * H + h0) * D;
  for (int i = tid; i < R * D; i += NT) q_s[i] = qg[i];
  __syncthreads();
  if constexpr (kIntQK) {
    for (int r = warp; r < R; r += NT / 32) {
      float amax = 0.0f;
      for (int d = lane; d < D; d += 32) amax = fmaxf(amax, fabsf(q_s[r * D + d]));
      const float sc = __fmaf_rn(warp_max(amax), 1.0f / 127.0f, 1e-7f);
      for (int d = lane; d < D; d += 32) {
        const float c = fminf(fmaxf(roundf(__fdiv_rn(q_s[r * D + d], sc)), -127.0f), 127.0f);
        q8_s[r * D + d] = static_cast<int8_t>(c);
      }
      if (lane == 0) qsc_s[r] = __fmul_rn(sc, sm_scale);
    }
  }

  // Softmax state of the rows this warp owns (rows warp, warp + 4).
  float m_run[RMAX / 4], l_run[RMAX / 4];
#pragma unroll
  for (int i = 0; i < RMAX / 4; ++i) {
    m_run[i] = NEG_INIT;
    l_run[i] = 0.0f;
  }
  // PV accumulator: rows x columns [4 cg, 4 cg + 4) over keys kg, kg + KG, ...
  const int cg = tid % CW, kg = tid / CW;
  float acc[RMAX][4];
#pragma unroll
  for (int r = 0; r < RMAX; ++r) acc[r][0] = acc[r][1] = acc[r][2] = acc[r][3] = 0.0f;

  // QK: thread (half, key) dots one key over half of the row's chunks.
  const int qk_key = tid % BK, half = tid / BK;
  constexpr int HC = KCPR / 2;  // chunks per half

  for (int j = 0; j < n_tiles; ++j) {
    const int buf = j & 1;
    const int key0 = start + j * BK;
    if (j + 1 < n_tiles) load_tile(key0 + BK, buf ^ 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();

    const unsigned char* Kt = smem + L::kKOff + buf * BK * L::kKRow;
    const unsigned char* Vt = smem + L::kVOff + buf * BK * L::kVRow;
    const int n_valid = min(BK, end - key0);

    // ---- QK partial dots -> S0[half][r][key] ----
    {
      float dot[RMAX];
#pragma unroll
      for (int r = 0; r < RMAX; ++r) dot[r] = 0.0f;
      if (qk_key < n_valid) {
        const unsigned char* krow = Kt + qk_key * L::kKRow;
        if constexpr (kIntQK) {
          int idot[RMAX];
#pragma unroll
          for (int r = 0; r < RMAX; ++r) idot[r] = 0;
#pragma unroll
          for (int c = half * HC; c < (half + 1) * HC; ++c) {
            const uint4 kw = *reinterpret_cast<const uint4*>(krow + 16 * c);
#pragma unroll
            for (int r = 0; r < RMAX; ++r) {
              if (r < R) {
                const uint4 qw = *reinterpret_cast<const uint4*>(q8_s + r * D + 16 * c);
                idot[r] = __dp4a((int)kw.x, (int)qw.x, idot[r]);
                idot[r] = __dp4a((int)kw.y, (int)qw.y, idot[r]);
                idot[r] = __dp4a((int)kw.z, (int)qw.z, idot[r]);
                idot[r] = __dp4a((int)kw.w, (int)qw.w, idot[r]);
              }
            }
          }
#pragma unroll
          for (int r = 0; r < RMAX; ++r) dot[r] = (float)idot[r];  // |half dot| < 2^24: exact
        } else {
#pragma unroll
          for (int c = half * HC; c < (half + 1) * HC; ++c) {
            float kf[EPC];
            widen16<KT>(*reinterpret_cast<const uint4*>(krow + 16 * c), kf);
#pragma unroll
            for (int r = 0; r < RMAX; ++r) {
              if (r < R) {
                const float* qr = q_s + r * D + c * EPC;
#pragma unroll
                for (int e = 0; e < EPC; e += 4) {
                  const float4 q4 = *reinterpret_cast<const float4*>(qr + e);
                  dot[r] = fmaf(q4.x, kf[e], dot[r]);
                  dot[r] = fmaf(q4.y, kf[e + 1], dot[r]);
                  dot[r] = fmaf(q4.z, kf[e + 2], dot[r]);
                  dot[r] = fmaf(q4.w, kf[e + 3], dot[r]);
                }
              }
            }
          }
        }
      }
#pragma unroll
      for (int r = 0; r < RMAX; ++r)
        if (r < R) S0[(half * RMAX + r) * SROW + qk_key] = dot[r];
    }
    __syncthreads();

    // ---- online softmax, one warp per row: S0[0] <- P (x V scale) ----
#pragma unroll
    for (int i = 0; i < RMAX / 4; ++i) {
      const int r = warp + 4 * i;
      if (r < R) {
        float s[BK / 32];
        float mx = MASK_VALUE;
#pragma unroll
        for (int e = 0; e < BK / 32; ++e) {
          const int key = lane + 32 * e;
          float x = S0[r * SROW + key] + S0[(RMAX + r) * SROW + key];
          if constexpr (kIntQK) x = __fmul_rn(x, qsc_s[r]);
          else x = __fmul_rn(x, sm_scale);
          x = __fmul_rn(__fmul_rn(x, ks_s[buf * BK + key]), LOG2E);
          s[e] = key < n_valid ? x : MASK_VALUE;
          mx = fmaxf(mx, s[e]);
        }
        const float m_new = fmaxf(m_run[i], warp_max(mx));
        const float alpha = exp2f(m_run[i] - m_new);
        float sum = 0.0f;
#pragma unroll
        for (int e = 0; e < BK / 32; ++e) {
          const int key = lane + 32 * e;
          const float p = exp2f(s[e] - m_new);
          sum += p;
          S0[r * SROW + key] = kVInt8 ? __fmul_rn(p, vs_s[buf * BK + key]) : p;
        }
        l_run[i] = alpha * l_run[i] + warp_sum(sum);
        m_run[i] = m_new;
        if (lane == 0) alpha_s[r] = alpha;
      }
    }
    __syncthreads();

    // ---- acc = alpha acc + P V ----
#pragma unroll
    for (int r = 0; r < RMAX; ++r) {
      if (r < R) {
        const float a = alpha_s[r];
        acc[r][0] *= a;
        acc[r][1] *= a;
        acc[r][2] *= a;
        acc[r][3] *= a;
      }
    }
    for (int key = kg; key < n_valid; key += KG) {
      float vf[4];
      widen4<VT>(Vt + key * L::kVRow, cg, vf);
#pragma unroll
      for (int r = 0; r < RMAX; ++r) {
        if (r < R) {
          const float p = S0[r * SROW + key];
          acc[r][0] = fmaf(p, vf[0], acc[r][0]);
          acc[r][1] = fmaf(p, vf[1], acc[r][1]);
          acc[r][2] = fmaf(p, vf[2], acc[r][2]);
          acc[r][3] = fmaf(p, vf[3], acc[r][3]);
        }
      }
    }
    __syncthreads();
  }

  // ---- the split's unnormalised (acc, m, l) ----
  float* red = reinterpret_cast<float*>(smem);  // [KG][RMAX][D]
#pragma unroll
  for (int r = 0; r < RMAX; ++r) {
    if (r < R) {
      float* dst = red + (kg * RMAX + r) * D + 4 * cg;
      *reinterpret_cast<float4*>(dst) = make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
    }
  }
  __syncthreads();
  for (int i = tid; i < R * D; i += NT) {
    const int r = i / D, d = i % D;
    float sum = 0.0f;
    for (int g = 0; g < KG; ++g) sum += red[(g * RMAX + r) * D + d];
    pacc[((long long)r * n_splits + split) * D + d] = sum;
  }
  if (lane == 0) {
#pragma unroll
    for (int i = 0; i < RMAX / 4; ++i) {
      const int r = warp + 4 * i;
      if (r < R) {
        pml[((long long)r * n_splits + split) * 2] = m_run[i];
        pml[((long long)r * n_splits + split) * 2 + 1] = l_run[i];
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Merge pass: one CTA per (batch, query head); thread d owns column d.
// ---------------------------------------------------------------------------

template <typename OutT>
__global__ void __launch_bounds__(128) decode_merge_kernel(const float* __restrict__ part_acc,
                                                           const float* __restrict__ part_ml,
                                                           OutT* __restrict__ o,
                                                           float* __restrict__ lse, int n_splits,
                                                           int D) {
  const long long bh = blockIdx.x;
  const float* ml = part_ml + bh * n_splits * 2;
  float m = NEG_INIT;
  for (int s = 0; s < n_splits; ++s)
    if (ml[2 * s + 1] > 0.0f) m = fmaxf(m, ml[2 * s]);
  const int d = threadIdx.x;
  float l = 0.0f, acc = 0.0f;
  for (int s = 0; s < n_splits; ++s) {
    const float ls = ml[2 * s + 1];
    if (ls > 0.0f) {  // an empty split has no weight
      const float w = exp2f(ml[2 * s] - m);
      l = fmaf(w, ls, l);
      if (d < D) acc = fmaf(w, part_acc[(bh * n_splits + s) * D + d], acc);
    }
  }
  const float ls = l == 0.0f ? 1.0f : l;
  if (d < D) o[bh * D + d] = from_f32<OutT>(__fdiv_rn(acc, ls));
  if (lse && d == 0) lse[bh] = m + log2f(ls);
}

// The launch of one split-pass variant.
struct SplitLaunch {
  const float *q, *ks, *vs;
  const void *k, *v;
  const int* lengths;
  float *part_acc, *part_ml;
  int B, H, Hk, S, R, n_splits, chunk;
  float sm_scale;
  cudaStream_t st;

  template <int D, typename KT, typename VT, bool kIntQK>
  int run() const {
    constexpr int smem = Smem<D, KT, VT>::kTotal;
    auto kern = decode_split_kernel<D, KT, VT, kIntQK>;
    const cudaError_t err =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid(n_splits, Hk * ((H / Hk) / R), B);
    kern<<<grid, NT, smem, st>>>(q, static_cast<const KT*>(k), static_cast<const VT*>(v), ks, vs,
                                 lengths, part_acc, part_ml, H, Hk, S, R, n_splits, chunk,
                                 sm_scale);
    return (int)cudaGetLastError();
  }
};

// How many CTAs of one split-pass variant an SM holds at once.
struct SplitOccupancy {
  int* ctas_per_sm;

  template <int D, typename KT, typename VT, bool kIntQK>
  int run() const {
    constexpr int smem = Smem<D, KT, VT>::kTotal;
    auto kern = decode_split_kernel<D, KT, VT, kIntQK>;
    cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(ctas_per_sm, kern, NT, smem);
    return (int)err;
  }
};

// Runs op.run<D, KT, VT, kIntQK>() for the variant the flags name.
template <int D, typename KT, bool kIntQK, typename Op>
int with_v(const Op& op, int v_int8) {
  if (v_int8) return op.template run<D, KT, int8_t, kIntQK>();
  return op.template run<D, KT, __nv_bfloat16, kIntQK>();
}

template <int D, typename Op>
int with_k(const Op& op, int k_int8, int v_int8, int int_qk) {
  if (k_int8 && int_qk) return with_v<D, int8_t, true>(op, v_int8);
  if (k_int8) return with_v<D, int8_t, false>(op, v_int8);
  if (int_qk) return (int)cudaErrorInvalidValue;
  return with_v<D, __nv_bfloat16, false>(op, v_int8);
}

template <typename Op>
int with_variant(const Op& op, int D, int k_int8, int v_int8, int int_qk) {
  switch (D) {
    case 32: return with_k<32>(op, k_int8, v_int8, int_qk);
    case 64: return with_k<64>(op, k_int8, v_int8, int_qk);
    case 128: return with_k<128>(op, k_int8, v_int8, int_qk);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// All tensors contiguous, natural layout.
//   q: [B, H, D] f32.   k, v: [B, Hk, S, D] int8 codes (k_int8 / v_int8) or bf16.
//   k_scale: [B, Hk, S] f32.   v_scale: [B, Hk, S] f32 (int8 V only, else null).
//   lengths: [B] int32 on the device.   part_acc: [B, H, n_splits, D] f32 and
//   part_ml: [B, H, n_splits, 2] f32 scratch.   o: [B, H, D] f32 (out_code 0),
//   bf16 (1) or f16 (2).   lse: [B, H] f32 (base 2) or null.
// R query rows (a divisor of H / Hk, at most 8) per CTA; splits of `chunk`
// keys (a multiple of 64). Returns cudaGetLastError() (cudaErrorInvalidValue
// for an unsupported D, mode or output type).
extern "C" int lowbit_decode_attn(const float* q, const void* k, const void* v,
                                  const float* k_scale, const float* v_scale, const int* lengths,
                                  float* part_acc, float* part_ml, void* o, float* lse, int B,
                                  int H, int Hk, int S, int D, int R, int k_int8, int v_int8,
                                  int int_qk, int out_code, int n_splits, int chunk,
                                  float sm_scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (R < 1 || R > RMAX || (H / Hk) % R || chunk % BK || out_code < 0 || out_code > 2)
    return (int)cudaErrorInvalidValue;
  const SplitLaunch launch{q,        k_scale, v_scale, k,        v,     lengths,
                           part_acc, part_ml, B,       H,        Hk,    S,
                           R,        n_splits, chunk,  sm_scale, st};
  const int err = with_variant(launch, D, k_int8, v_int8, int_qk);
  if (err) return err;
  const unsigned grid = (unsigned)((long long)B * H);
  switch (out_code) {
    case 0:
      decode_merge_kernel<float><<<grid, 128, 0, st>>>(part_acc, part_ml, static_cast<float*>(o),
                                                       lse, n_splits, D);
      break;
    case 1:
      decode_merge_kernel<__nv_bfloat16><<<grid, 128, 0, st>>>(
          part_acc, part_ml, static_cast<__nv_bfloat16*>(o), lse, n_splits, D);
      break;
    default:
      decode_merge_kernel<__half><<<grid, 128, 0, st>>>(part_acc, part_ml, static_cast<__half*>(o),
                                                        lse, n_splits, D);
      break;
  }
  return (int)cudaGetLastError();
}

// How many CTAs of the split-pass variant (D, k_int8, v_int8, int_qk) one SM
// of the current device holds at once, into *ctas_per_sm. Returns a
// cudaError_t. Host-side only: it does not touch the stream.
extern "C" int lowbit_decode_ctas_per_sm(int D, int k_int8, int v_int8, int int_qk,
                                         int* ctas_per_sm) {
  return with_variant(SplitOccupancy{ctas_per_sm}, D, k_int8, v_int8, int_qk);
}
