// Kernel A: FlashAttention-2 forward with INT8 or bf16 QK and bf16 PV.
//
// Replaces the TPU kernel lowbit_quant_fa2_paddle_tpu/ops/attention.py:
// _attn_body_km (launched by lowbit_attention_km, pallas_call at :1491 and
// :1502) for the features of the DiT path: INT8 Q codes with per-row scales
// or float Q quantized per row in the prologue, INT8 K codes with per-row
// scales, or bf16 Q/K (fp mode); bf16 P and V with an fp32 accumulator;
// optional smooth-V mean epilogue; causal (top-left aligned) or not; GQA;
// any Sk (ragged last KV tile); base-2 LSE out; head_dim 64 or 128.
//
// Math per KV tile, as in the TPU kernel:
//   s  = (i32(Q8 K8^T) * k_scale) * q_scale      q_scale holds sm_scale*log2e
//   s  = f32(Qbf Kbf^T) * sm_scale*log2e         fp mode
//   masked s = MASK_VALUE (-0.7 * FLT_MAX)
//   m' = max(m, rowmax s);  P = bf16(exp2(bf16(s - m')));  l = 2^(m-m') l + sum P
//   acc = 2^(m-m') acc + P V                     (bf16 x bf16 -> f32)
//   o = acc / l (+ v_mean where l > 0); lse2 = m + log2 l, or -1e30 where l == 0
//
// Bound on the H100: the tensor cores (4*D FLOPs per (q, k) pair; at
// b1 h30 s17776 d64 one call is 2.43 TFLOP against ~70 MB of operands), and
// in this simple form the per-element softmax chain on the CUDA cores.
// Design: one CTA of 4 warps per (64 q rows, head, batch); each warp owns 16
// rows and keeps m, l and the O accumulator in registers across the KV loop
// (the loop replaces the TPU's sequential grid axis). QK runs on
// mma.sync m16n8k32 s8 (or m16n8k16 bf16), and the QK accumulator is reused
// in registers as the A operand of the PV mma.sync m16n8k16 bf16, so S and P
// never touch shared memory. K, V (and K scales) stream through a two-stage
// cp.async ring in padded (bank-conflict-free) shared memory; V's B operand
// comes from ldmatrix.trans. Causal CTAs stop their KV loop at the diagonal
// and are launched heaviest first. wgmma/TMA are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int BQ = 64;   // query rows per CTA
constexpr int BKV = 64;  // keys per tile
constexpr int NTHREADS = 128;
constexpr float MASK_VALUE = (float)(-0.7 * 3.4028234663852886e38);
constexpr float NEG_INIT = -1e30f;

enum QMode { Q_INT8 = 0, Q_FUSED_BF16 = 1, Q_FUSED_F32 = 2, Q_FP = 3 };

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

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
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

__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  __nv_bfloat162 v = __halves2bfloat162(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

template <typename T>
__device__ __forceinline__ float to_f32(T v);
template <>
__device__ __forceinline__ float to_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ void store2(T* p, float a, float b);
template <>
__device__ __forceinline__ void store2<float>(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
template <>
__device__ __forceinline__ void store2<__nv_bfloat16>(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// ---------------------------------------------------------------------------
// Shared-memory layout. Rows are padded by 16 bytes so that the 8 rows a
// quad-group of lanes touches fall on distinct banks.
// ---------------------------------------------------------------------------

template <int D, int QM>
struct Smem {
  static constexpr bool kInt8 = QM != Q_FP;
  static constexpr int kQKElem = kInt8 ? 1 : 2;       // bytes per Q/K element
  static constexpr int kQKStride = D + 16 / kQKElem;  // elements per padded row
  static constexpr int kVStride = D + 8;              // bf16 elements per padded row
  static constexpr int kQBytes = BQ * kQKStride * kQKElem;
  static constexpr int kKBytes = BKV * kQKStride * kQKElem;
  static constexpr int kVBytes = BKV * kVStride * 2;
  static constexpr int kSBytes = kInt8 ? BKV * 4 : 0;
  static constexpr int kQOff = 0;
  static constexpr int kKOff = kQOff + kQBytes;
  static constexpr int kVOff = kKOff + 2 * kKBytes;
  static constexpr int kSOff = kVOff + 2 * kVBytes;
  static constexpr int kQsOff = kSOff + 2 * kSBytes;  // BQ f32 q scales
  static constexpr int kTotal = kQsOff + BQ * 4;
};

template <int D, int QM, typename QT, typename OutT>
__global__ void __launch_bounds__(NTHREADS) attn_fwd_kernel(
    const QT* __restrict__ q, const void* __restrict__ k_ptr,
    const __nv_bfloat16* __restrict__ v, const float* __restrict__ q_scale,
    const float* __restrict__ k_scale, const float* __restrict__ v_mean, OutT* __restrict__ o,
    float* __restrict__ lse, int H, int Hk, int Sq, int Sk, int causal, float sm_scale_log2e) {
  using L = Smem<D, QM>;
  constexpr bool kInt8 = L::kInt8;
  using KT = typename std::conditional<kInt8, int8_t, __nv_bfloat16>::type;
  constexpr int KSTEPS = kInt8 ? D / 32 : D / 16;  // QK mma k-steps
  constexpr int NT = BKV / 8;                       // S n-tiles per warp
  constexpr int DT = D / 8;                         // O n-tiles per warp

  extern __shared__ __align__(16) unsigned char smem[];
  KT* Qs = reinterpret_cast<KT*>(smem + L::kQOff);
  float* qs_s = reinterpret_cast<float*>(smem + L::kQsOff);

  const int nq = (Sq + BQ - 1) / BQ;
  const int qb = causal ? nq - 1 - (int)blockIdx.x : (int)blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (H / Hk);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = qb * BQ;

  const long long qh = (long long)b * H + h;
  const long long kh = (long long)b * Hk + hk;
  const KT* kg = static_cast<const KT*>(k_ptr) + kh * Sk * D;
  const __nv_bfloat16* vg = v + kh * Sk * D;
  const float* ksg = kInt8 ? k_scale + kh * Sk : nullptr;

  // ---- prologue: the Q tile into shared memory as MMA-ready codes/values ----
  if constexpr (QM == Q_INT8 || QM == Q_FP) {
    const KT* qg = reinterpret_cast<const KT*>(q) + qh * Sq * D;
    constexpr int CPR = D * sizeof(KT) / 16;  // 16-byte chunks per row
    for (int c = tid; c < BQ * CPR; c += NTHREADS) {
      const int r = c / CPR, cc = c % CPR;
      const bool ok = q0 + r < Sq;
      const KT* src = qg + (long long)(ok ? q0 + r : 0) * D + cc * (16 / sizeof(KT));
      cp_async16(Qs + r * L::kQKStride + cc * (16 / sizeof(KT)), src, ok);
    }
    cp_async_commit();
    if constexpr (QM == Q_INT8) {
      for (int r = tid; r < BQ; r += NTHREADS)
        qs_s[r] = q0 + r < Sq ? q_scale[qh * Sq + q0 + r] : 0.0f;
    }
    cp_async_wait<0>();
  } else {
    // In-kernel per-row Q quantization (the TPU kernel's fused_quant_q):
    // scale = fma(amax, 1/127, 1e-7), code = clamp(roundf(q / scale)),
    // and the row scale carries sm_scale * log2(e).
    const QT* qg = q + qh * Sq * D;
    for (int rr = 0; rr < BQ / 4; ++rr) {
      const int r = warp * (BQ / 4) + rr;
      const bool ok = q0 + r < Sq;
      float x[D / 32];
      float amax = 0.0f;
#pragma unroll
      for (int i = 0; i < D / 32; ++i) {
        x[i] = ok ? to_f32(qg[(long long)(q0 + r) * D + lane + 32 * i]) : 0.0f;
        amax = fmaxf(amax, fabsf(x[i]));
      }
      const float sc = __fmaf_rn(warp_max(amax), 1.0f / 127.0f, 1e-7f);
#pragma unroll
      for (int i = 0; i < D / 32; ++i) {
        const float c = fminf(fmaxf(roundf(__fdiv_rn(x[i], sc)), -127.0f), 127.0f);
        Qs[r * L::kQKStride + lane + 32 * i] = static_cast<int8_t>(c);
      }
      if (lane == 0) qs_s[r] = __fmul_rn(sc, sm_scale_log2e);
    }
  }
  __syncthreads();

  // A fragments of this warp's 16 rows, held for the whole KV loop.
  uint32_t qa[KSTEPS][4];
  {
    const int r0 = warp * 16 + g;
#pragma unroll
    for (int ks = 0; ks < KSTEPS; ++ks) {
      constexpr int KW = kInt8 ? 32 : 16;  // elements per k-step
      constexpr int HALF = KW / 2;
      const int col = ks * KW + (kInt8 ? 4 * t : 2 * t);
      qa[ks][0] = *reinterpret_cast<const uint32_t*>(Qs + r0 * L::kQKStride + col);
      qa[ks][1] = *reinterpret_cast<const uint32_t*>(Qs + (r0 + 8) * L::kQKStride + col);
      qa[ks][2] = *reinterpret_cast<const uint32_t*>(Qs + r0 * L::kQKStride + col + HALF);
      qa[ks][3] = *reinterpret_cast<const uint32_t*>(Qs + (r0 + 8) * L::kQKStride + col + HALF);
    }
  }
  float qsc[2] = {0.0f, 0.0f};
  if constexpr (kInt8) {
    qsc[0] = qs_s[warp * 16 + g];
    qsc[1] = qs_s[warp * 16 + g + 8];
  }

  // ---- KV loop ----
  const int nkv = (Sk + BKV - 1) / BKV;
  const int n_tiles = causal ? min(nkv, (q0 + BQ + BKV - 1) / BKV) : nkv;

  auto load_tile = [&](int j, int buf) {
    const int key0 = j * BKV;
    KT* Kd = reinterpret_cast<KT*>(smem + L::kKOff + buf * L::kKBytes);
    __nv_bfloat16* Vd = reinterpret_cast<__nv_bfloat16*>(smem + L::kVOff + buf * L::kVBytes);
    constexpr int KCPR = D * sizeof(KT) / 16;
    for (int c = tid; c < BKV * KCPR; c += NTHREADS) {
      const int r = c / KCPR, cc = c % KCPR;
      const bool ok = key0 + r < Sk;
      const KT* src = kg + (long long)(ok ? key0 + r : 0) * D + cc * (16 / sizeof(KT));
      cp_async16(Kd + r * L::kQKStride + cc * (16 / sizeof(KT)), src, ok);
    }
    constexpr int VCPR = D * 2 / 16;
    for (int c = tid; c < BKV * VCPR; c += NTHREADS) {
      const int r = c / VCPR, cc = c % VCPR;
      const bool ok = key0 + r < Sk;  // V rows past Sk are zero-filled
      const __nv_bfloat16* src = vg + (long long)(ok ? key0 + r : 0) * D + cc * 8;
      cp_async16(Vd + r * L::kVStride + cc * 8, src, ok);
    }
    if constexpr (kInt8) {
      float* Sd = reinterpret_cast<float*>(smem + L::kSOff + buf * L::kSBytes);
      if (tid < BKV) {
        const bool ok = key0 + tid < Sk;
        cp_async4(Sd + tid, ksg + (ok ? key0 + tid : 0), ok);
      }
    }
  };

  float m_run[2] = {NEG_INIT, NEG_INIT};
  float l_run[2] = {0.0f, 0.0f};  // per-thread partial row sums
  float acc[DT][4];
#pragma unroll
  for (int i = 0; i < DT; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.0f;

  load_tile(0, 0);
  cp_async_commit();
  for (int j = 0; j < n_tiles; ++j) {
    const int buf = j & 1;
    if (j + 1 < n_tiles) load_tile(j + 1, buf ^ 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();

    const KT* Kt = reinterpret_cast<const KT*>(smem + L::kKOff + buf * L::kKBytes);
    const __nv_bfloat16* Vt =
        reinterpret_cast<const __nv_bfloat16*>(smem + L::kVOff + buf * L::kVBytes);
    const int key0 = j * BKV;

    // S = Q K^T for 16 rows x 64 keys per warp.
    float s[NT][4];
    if constexpr (kInt8) {
      const float* St = reinterpret_cast<const float*>(smem + L::kSOff + buf * L::kSBytes);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        int c[4] = {0, 0, 0, 0};
        const KT* krow = Kt + (nt * 8 + g) * L::kQKStride + 4 * t;
#pragma unroll
        for (int ks = 0; ks < KSTEPS; ++ks)
          mma_s8(c, qa[ks], *reinterpret_cast<const uint32_t*>(krow + ks * 32),
                 *reinterpret_cast<const uint32_t*>(krow + ks * 32 + 16));
        const float k0 = St[nt * 8 + 2 * t], k1 = St[nt * 8 + 2 * t + 1];
        s[nt][0] = __fmul_rn(__fmul_rn((float)c[0], k0), qsc[0]);
        s[nt][1] = __fmul_rn(__fmul_rn((float)c[1], k1), qsc[0]);
        s[nt][2] = __fmul_rn(__fmul_rn((float)c[2], k0), qsc[1]);
        s[nt][3] = __fmul_rn(__fmul_rn((float)c[3], k1), qsc[1]);
      }
    } else {
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        float c[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        const KT* krow = Kt + (nt * 8 + g) * L::kQKStride + 2 * t;
#pragma unroll
        for (int ks = 0; ks < KSTEPS; ++ks)
          mma_bf16(c, qa[ks], *reinterpret_cast<const uint32_t*>(krow + ks * 16),
                   *reinterpret_cast<const uint32_t*>(krow + ks * 16 + 8));
#pragma unroll
        for (int e = 0; e < 4; ++e) s[nt][e] = __fmul_rn(c[e], sm_scale_log2e);
      }
    }

    // Causal diagonal and ragged-edge masks.
    const bool need_mask = (causal && key0 + BKV - 1 > q0 + warp * 16) || key0 + BKV > Sk;
    if (need_mask) {
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = key0 + nt * 8 + 2 * t + (e & 1);
          const int row = q0 + warp * 16 + g + 8 * (e >> 1);
          if (col >= Sk || (causal && col > row)) s[nt][e] = MASK_VALUE;
        }
    }

    // Online softmax in base 2; P rounds to bf16 as in the TPU kernel.
    float m_new[2], alpha[2];
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      float mx = s[0][2 * hf];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) mx = fmaxf(mx, fmaxf(s[nt][2 * hf], s[nt][2 * hf + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      m_new[hf] = fmaxf(m_run[hf], mx);
      alpha[hf] = exp2f(m_run[hf] - m_new[hf]);
      m_run[hf] = m_new[hf];
    }
    uint32_t pa[NT][2];  // P packed as bf16 pairs: [nt][row half]
    float lsum[2] = {0.0f, 0.0f};
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const float d0 = __bfloat162float(__float2bfloat16_rn(s[nt][2 * hf] - m_new[hf]));
        const float d1 = __bfloat162float(__float2bfloat16_rn(s[nt][2 * hf + 1] - m_new[hf]));
        const __nv_bfloat16 p0 = __float2bfloat16_rn(exp2f(d0));
        const __nv_bfloat16 p1 = __float2bfloat16_rn(exp2f(d1));
        lsum[hf] += __bfloat162float(p0) + __bfloat162float(p1);
        pa[nt][hf] = pack_bf16(p0, p1);
      }
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) l_run[hf] = alpha[hf] * l_run[hf] + lsum[hf];
#pragma unroll
    for (int dt = 0; dt < DT; ++dt) {
      acc[dt][0] *= alpha[0];
      acc[dt][1] *= alpha[0];
      acc[dt][2] *= alpha[1];
      acc[dt][3] *= alpha[1];
    }

    // O += P V. The S accumulator layout of n-tiles (2kk, 2kk+1) is the A
    // fragment of a k16 step; V's B fragments come from ldmatrix.trans.
#pragma unroll
    for (int kk = 0; kk < BKV / 16; ++kk) {
      const uint32_t a[4] = {pa[2 * kk][0], pa[2 * kk][1], pa[2 * kk + 1][0], pa[2 * kk + 1][1]};
      const int vrow = kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
#pragma unroll
      for (int dp = 0; dp < D / 16; ++dp) {
        uint32_t bv[4];
        ldmatrix_x4_trans(bv, Vt + vrow * L::kVStride + dp * 16 + (lane >> 4) * 8);
        mma_bf16(acc[2 * dp], a, bv[0], bv[1]);
        mma_bf16(acc[2 * dp + 1], a, bv[2], bv[3]);
      }
    }
    __syncthreads();
  }

  // ---- epilogue ----
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    l_run[hf] += __shfl_xor_sync(0xffffffffu, l_run[hf], 1);
    l_run[hf] += __shfl_xor_sync(0xffffffffu, l_run[hf], 2);
  }
  const float* vm = v_mean ? v_mean + kh * D : nullptr;
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int row = q0 + warp * 16 + g + 8 * hf;
    if (row >= Sq) continue;
    const bool empty = l_run[hf] == 0.0f;
    const float ls = empty ? 1.0f : l_run[hf];
    OutT* orow = o + (qh * Sq + row) * D;
#pragma unroll
    for (int dt = 0; dt < DT; ++dt) {
      const int d = dt * 8 + 2 * t;
      float o0 = __fdiv_rn(acc[dt][2 * hf], ls);
      float o1 = __fdiv_rn(acc[dt][2 * hf + 1], ls);
      if (vm && !empty) {
        o0 += vm[d];
        o1 += vm[d + 1];
      }
      store2(orow + d, o0, o1);
    }
    if (lse && t == 0) lse[qh * Sq + row] = empty ? NEG_INIT : m_run[hf] + log2f(ls);
  }
}

template <int D, int QM, typename QT, typename OutT>
int launch(const void* q, const void* k, const void* v, const float* q_scale,
           const float* k_scale, const float* v_mean, void* o, float* lse, int B, int H, int Hk,
           int Sq, int Sk, int causal, float sm_scale_log2e, cudaStream_t stream) {
  constexpr int smem = Smem<D, QM>::kTotal;
  auto kern = attn_fwd_kernel<D, QM, QT, OutT>;
  const cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((Sq + BQ - 1) / BQ, H, B);
  kern<<<grid, NTHREADS, smem, stream>>>(
      static_cast<const QT*>(q), k, static_cast<const __nv_bfloat16*>(v), q_scale, k_scale,
      v_mean, static_cast<OutT*>(o), lse, H, Hk, Sq, Sk, causal, sm_scale_log2e);
  return (int)cudaGetLastError();
}

template <int D, typename OutT>
int dispatch_q(int q_mode, const void* q, const void* k, const void* v, const float* q_scale,
               const float* k_scale, const float* v_mean, void* o, float* lse, int B, int H,
               int Hk, int Sq, int Sk, int causal, float c, cudaStream_t st) {
  switch (q_mode) {
    case Q_INT8:
      return launch<D, Q_INT8, int8_t, OutT>(q, k, v, q_scale, k_scale, v_mean, o, lse, B, H,
                                             Hk, Sq, Sk, causal, c, st);
    case Q_FUSED_BF16:
      return launch<D, Q_FUSED_BF16, __nv_bfloat16, OutT>(q, k, v, q_scale, k_scale, v_mean, o,
                                                          lse, B, H, Hk, Sq, Sk, causal, c, st);
    case Q_FUSED_F32:
      return launch<D, Q_FUSED_F32, float, OutT>(q, k, v, q_scale, k_scale, v_mean, o, lse, B,
                                                 H, Hk, Sq, Sk, causal, c, st);
    case Q_FP:
      return launch<D, Q_FP, __nv_bfloat16, OutT>(q, k, v, q_scale, k_scale, v_mean, o, lse, B,
                                                   H, Hk, Sq, Sk, causal, c, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

template <int D>
int dispatch_out(int out_f32, int q_mode, const void* q, const void* k, const void* v,
                 const float* q_scale, const float* k_scale, const float* v_mean, void* o,
                 float* lse, int B, int H, int Hk, int Sq, int Sk, int causal, float c,
                 cudaStream_t st) {
  if (out_f32)
    return dispatch_q<D, float>(q_mode, q, k, v, q_scale, k_scale, v_mean, o, lse, B, H, Hk, Sq,
                                Sk, causal, c, st);
  return dispatch_q<D, __nv_bfloat16>(q_mode, q, k, v, q_scale, k_scale, v_mean, o, lse, B, H,
                                      Hk, Sq, Sk, causal, c, st);
}

}  // namespace

// All tensors contiguous, natural layout.
//   q: [B, H, Sq, D] int8 codes (q_mode 0), bf16 (1, 3) or f32 (2).
//   k: [B, Hk, Sk, D] int8 codes (q_mode 0-2) or bf16 (3).   v: [B, Hk, Sk, D] bf16.
//   q_scale: [B, H, Sq] f32, already times sm_scale*log2e (q_mode 0 only).
//   k_scale: [B, Hk, Sk] f32 (q_mode 0-2).   v_mean: [B, Hk, D] f32 or null.
//   o: [B, H, Sq, D] bf16 (out_f32 = 0) or f32.   lse: [B, H, Sq] f32 (base 2) or null.
// Returns cudaGetLastError() (cudaErrorInvalidValue for an unsupported D/mode).
extern "C" int lowbit_attn_fwd(const void* q, const void* k, const void* v, const float* q_scale,
                               const float* k_scale, const float* v_mean, void* o, float* lse,
                               int B, int H, int Hk, int Sq, int Sk, int D, int q_mode,
                               int out_f32, int causal, float sm_scale_log2e, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 64)
    return dispatch_out<64>(out_f32, q_mode, q, k, v, q_scale, k_scale, v_mean, o, lse, B, H, Hk,
                            Sq, Sk, causal, sm_scale_log2e, st);
  if (D == 128)
    return dispatch_out<128>(out_f32, q_mode, q, k, v, q_scale, k_scale, v_mean, o, lse, B, H,
                             Hk, Sq, Sk, causal, sm_scale_log2e, st);
  return (int)cudaErrorInvalidValue;
}
