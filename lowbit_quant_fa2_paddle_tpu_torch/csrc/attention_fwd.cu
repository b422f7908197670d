// Kernel A, its INT8 PV mode on mma.sync: FlashAttention-2 forward with
// INT8, packed INT4/INT2 or bf16 QK and P requantized to INT8 for an exact
// INT8 PV dot. Every other mode of kernel A runs on the Hopper design of
// attention_fwd_wgmma.cu; the wrapper picks the kernel by mode.
//
// Replaces the TPU kernel lowbit_quant_fa2_paddle_tpu/ops/attention.py:
// _attn_body_km (launched by lowbit_attention_km, pallas_call at :1491 and
// :1502) with pv_int8: INT8 Q codes with per-row scales or float Q quantized
// per row in the prologue; INT8 K codes, or K packed two (INT4, halves of D)
// or four (INT2, quarters of D) codes per byte, with per-row scales; or bf16
// Q/K (fp mode); per-channel INT8 V codes with a v_scale (and optional
// v_mean) epilogue; causal (top-left aligned) or not; GQA; any Sk (ragged
// last KV tile); base-2 LSE out; head_dim 64 or 128.
//
// Math per KV tile of 64 keys, as in the TPU kernel:
//   s  = (i32(Q8 K8^T) * k_scale) * q_scale      q_scale holds sm_scale*log2e
//   s  = f32(Qbf Kbf^T) * sm_scale*log2e         fp mode
//   masked s = MASK_VALUE (-0.7 * FLT_MAX)
//   m' = max(m, rowmax s)
//   P = bf16(exp2(bf16(s - (m' - log2 127))))    in [0, 128]
//   p8 = min(trunc(bf16(P + 0.5)), 127)          saturates as XLA's f32->s8 convert does
//   l = 2^(m-m') l + sum p8;  acc = 2^(m-m') acc + i32(p8 V8)
//   o = acc / l * v_scale (+ v_mean where l > 0)
//   lse2 = m + log2 l - log2 127, or -1e30 where l == 0
//
// Bound on the H100: the tensor cores (4*D operations per (q, k) pair), and
// in this simple form the per-element softmax chain on the CUDA cores.
// Design: one CTA of 4 warps per (64 q rows, head, batch); each warp owns 16
// rows and keeps m, l and the O accumulator in registers across the KV loop
// (the loop replaces the TPU's sequential grid axis). QK runs on
// mma.sync m16n8k32 s8 (or m16n8k16 bf16), and the QK accumulator is reused
// in registers as the A operand of the PV mma.sync, so S and P never touch
// shared memory. K, V (and K scales) stream through a two-stage cp.async ring
// in padded (bank-conflict-free) shared memory. Causal CTAs stop their KV
// loop at the diagonal and are launched heaviest first.
//
// Packed K and INT8 V arrive as they lie in memory and are staged by
// cp.async; after the tile's barrier one pass over shared memory widens
// packed K to the int8 K tile (per-byte sign extension,
// __vsub4((w & 0x0F0F0F0F) ^ 0x08080808, 0x08080808) for nibbles, the same
// with 0x03/0x02 for 2-bit codes) and TRANSPOSES V into a [D][keys] int8
// tile, because the s8 B fragment wants four consecutive keys per column and
// ldmatrix.trans moves only b16. The P accumulator gives each thread keys
// 2t, 2t+1 of every 8-key n-tile, while the s8 A fragment wants slots
// 4t..4t+3 (and 16+4t..) of a 32-key chunk; the contraction runs over keys,
// so slot 16h + 4t + i holds key 16h + 8*(i>>1) + 2t + (i&1), and the V^T
// tile stores its keys in that same permuted order. Packed K and the output
// type are template parameters; the launch bounds keep d128 at 3 resident
// CTAs per SM.

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
constexpr float LOG2_127 = 6.9886846867721655f;

enum QMode { Q_INT8 = 0, Q_FUSED_BF16 = 1, Q_FUSED_F32 = 2, Q_FP = 3 };

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const float* q_scale;
  const float* k_scale;
  const float* v_scale;
  const float* v_mean;
  void* o;
  float* lse;
  int H, Hk, Sq, Sk, causal, k_bits, out_f32;  // out_f32 picks the instantiation
  float sm_scale_log2e;
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

// Per-byte sign extension of the 4-bit (2-bit) field at the bottom of each
// byte of w.
__device__ __forceinline__ uint32_t sext4(uint32_t w) {
  return __vsub4((w & 0x0F0F0F0Fu) ^ 0x08080808u, 0x08080808u);
}
__device__ __forceinline__ uint32_t sext2(uint32_t w) {
  return __vsub4((w & 0x03030303u) ^ 0x02020202u, 0x02020202u);
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

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// One KV tile of BKV rows, CPR 16-byte chunks each, from global rows of
// src_stride bytes into shared rows of dst_stride bytes, by cp.async. Thread
// tid copies chunk tid % CPR of rows tid / CPR + i * (NTHREADS / CPR), so its
// only loop state is one row and one chunk. Rows past Sk are zero-filled.
template <int CPR>
__device__ __forceinline__ void load_rows(unsigned char* dst, int dst_stride, const unsigned char* src,
                                          long long src_stride, int key0, int Sk, int tid) {
  constexpr int RPP = NTHREADS / CPR;  // rows per pass
  static_assert(NTHREADS % CPR == 0 && (BKV % RPP == 0 || RPP % BKV == 0), "tile rows must split evenly");
  const int r0 = tid / CPR, cc = tid % CPR;
  if (RPP > BKV && r0 >= BKV) return;
#pragma unroll
  for (int i = 0; i < (BKV + RPP - 1) / RPP; ++i) {
    const int r = r0 + i * RPP;
    const bool ok = key0 + r < Sk;
    cp_async16(dst + r * dst_stride + cc * 16, src + (ok ? key0 + r : 0) * src_stride + cc * 16, ok);
  }
}

// Widen one staged tile of packed K (BITS 4 or 2; WPR 32-bit words per row)
// into the int8 K tile, rows of STRIDE bytes: code p of each byte of word c
// of a row goes to column p * (4 * WPR) + 4 * c + (its byte).
template <int BITS, int WPR, int STRIDE>
__device__ __forceinline__ void unpack_rows(const uint32_t* src, int8_t* Kd, int tid) {
  for (int w = tid; w < BKV * WPR; w += NTHREADS) {
    const int r = w / WPR, c = w % WPR;
    const uint32_t x = src[w];
    int8_t* dst = Kd + r * STRIDE + 4 * c;
#pragma unroll
    for (int p = 0; p < 8 / BITS; ++p)
      *reinterpret_cast<uint32_t*>(dst + p * 4 * WPR) = BITS == 4 ? sext4(x >> (4 * p)) : sext2(x >> (2 * p));
  }
}

// ---------------------------------------------------------------------------
// Shared-memory layout. Rows are padded by 16 bytes so that the 8 rows a
// quad-group of lanes touches fall on distinct banks. Packed K (KPACK)
// adds a staging ring for the codes as loaded.
// ---------------------------------------------------------------------------

template <int D, int QM, bool KPACK>
struct Smem {
  static constexpr bool kInt8 = QM != Q_FP;
  static constexpr int kQKElem = kInt8 ? 1 : 2;       // bytes per Q/K element
  static constexpr int kQKStride = D + 16 / kQKElem;  // elements per padded row
  static constexpr int kVTStride = BKV + 16;          // int8 keys per padded V^T row
  static constexpr int kQBytes = BQ * kQKStride * kQKElem;
  static constexpr int kKBytes = BKV * kQKStride * kQKElem;
  static constexpr int kVBytes = D * kVTStride;   // the MMA-ready int8 V^T tile [D][keys]
  static constexpr int kV8Bytes = BKV * D;        // int8 V as loaded
  static constexpr int kSBytes = kInt8 ? BKV * 4 : 0;
  static constexpr int kKPBytes = KPACK ? BKV * D / 2 : 0;     // packed K as loaded
  static constexpr int kQOff = 0;
  static constexpr int kKOff = kQOff + kQBytes;
  static constexpr int kVOff = kKOff + 2 * kKBytes;
  static constexpr int kV8Off = kVOff + kVBytes;
  static constexpr int kSOff = kV8Off + 2 * kV8Bytes;
  static constexpr int kQsOff = kSOff + 2 * kSBytes;  // BQ f32 q scales
  static constexpr int kKPOff = kQsOff + BQ * 4;
  static constexpr int kTotal = kKPOff + 2 * kKPBytes;
};

template <int QM>
using QType = typename std::conditional<
    QM == Q_INT8, int8_t,
    typename std::conditional<QM == Q_FUSED_F32, float, __nv_bfloat16>::type>::type;

// Resident CTAs per SM that the register budget must allow: 4 at d64 (at
// most 128 registers a thread), 3 at d128 (at most 170); one register past
// that and the SM holds one CTA fewer.
template <int D>
constexpr int kMinCtas = D == 64 ? 4 : 3;

template <int D, int QM, bool KPACK, typename OutT>
__global__ void __launch_bounds__(NTHREADS, kMinCtas<D>) attn_fwd_kernel(const Args args) {
  using L = Smem<D, QM, KPACK>;
  using QT = QType<QM>;
  constexpr bool kInt8 = L::kInt8;
  using KT = typename std::conditional<kInt8, int8_t, __nv_bfloat16>::type;
  constexpr int KSTEPS = kInt8 ? D / 32 : D / 16;  // QK mma k-steps
  constexpr int NT = BKV / 8;                       // S n-tiles per warp
  constexpr int DT = D / 8;                         // O n-tiles per warp

  extern __shared__ __align__(16) unsigned char smem[];
  KT* Qs = reinterpret_cast<KT*>(smem + L::kQOff);
  float* qs_s = reinterpret_cast<float*>(smem + L::kQsOff);

  const int H = args.H, Hk = args.Hk, Sq = args.Sq, Sk = args.Sk;
  const bool causal = args.causal != 0;
  const float sm_scale_log2e = args.sm_scale_log2e;
  // Packed K: bytes per packed row (D/2 for INT4, D/4 for INT2).
  const int kpw = KPACK ? D * args.k_bits / 8 : 0;

  const int nq = (Sq + BQ - 1) / BQ;
  const int qb = causal ? nq - 1 - (int)blockIdx.x : (int)blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (H / Hk);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = qb * BQ;

  const long long qh = (long long)b * H + h;
  const long long kh = (long long)b * Hk + hk;
  const KT* kg = static_cast<const KT*>(args.k) + kh * Sk * D;
  const unsigned char* kgp = static_cast<const unsigned char*>(args.k) + kh * Sk * kpw;
  const unsigned char* vg = static_cast<const unsigned char*>(args.v) + kh * Sk * D;
  const float* ksg = kInt8 ? args.k_scale + kh * Sk : nullptr;

  // ---- prologue: the Q tile into shared memory as MMA-ready codes/values ----
  if constexpr (QM == Q_INT8 || QM == Q_FP) {
    const KT* qg = static_cast<const KT*>(args.q) + qh * Sq * D;
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
        qs_s[r] = q0 + r < Sq ? args.q_scale[qh * Sq + q0 + r] : 0.0f;
    }
    cp_async_wait<0>();
  } else {
    // In-kernel per-row Q quantization (the TPU kernel's fused_quant_q):
    // scale = fma(amax, 1/127, 1e-7), code = clamp(roundf(q / scale)),
    // and the row scale carries sm_scale * log2(e).
    const QT* qg = static_cast<const QT*>(args.q) + qh * Sq * D;
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

  // Start the cp.async copies of tile j into ring stage buf: K rows as they
  // lie in memory (int8 / bf16 into the MMA tile, packed codes into the
  // staging ring), V rows (bf16 into the MMA tile, int8 into the staging
  // ring), and the K scales.
  auto load_tile = [&](int j, int buf) {
    const int key0 = j * BKV;
    if constexpr (KPACK) {
      unsigned char* Kd = smem + L::kKPOff + buf * L::kKPBytes;
      if (kpw == D / 2)
        load_rows<D / 32>(Kd, D / 2, kgp, D / 2, key0, Sk, tid);
      else
        load_rows<D / 64>(Kd, D / 4, kgp, D / 4, key0, Sk, tid);
    } else {
      load_rows<D * sizeof(KT) / 16>(smem + L::kKOff + buf * L::kKBytes, L::kQKStride * sizeof(KT),
                                     reinterpret_cast<const unsigned char*>(kg), D * sizeof(KT), key0, Sk, tid);
    }
    load_rows<D / 16>(smem + L::kV8Off + buf * L::kV8Bytes, D, vg, D, key0, Sk, tid);
    if constexpr (kInt8) {
      float* Sd = reinterpret_cast<float*>(smem + L::kSOff + buf * L::kSBytes);
      if (tid < BKV) {
        const bool ok = key0 + tid < Sk;
        cp_async4(Sd + tid, ksg + (ok ? key0 + tid : 0), ok);
      }
    }
  };

  // Widen the staged tile of stage buf into the tiles the MMAs read.
  auto widen_tile = [&](int buf) {
    if constexpr (KPACK) {
      const uint32_t* src = reinterpret_cast<const uint32_t*>(smem + L::kKPOff + buf * L::kKPBytes);
      int8_t* Kd = reinterpret_cast<int8_t*>(smem + L::kKOff + buf * L::kKBytes);
      if (kpw == D / 2)
        unpack_rows<4, D / 8, L::kQKStride>(src, Kd, tid);
      else
        unpack_rows<2, D / 16, L::kQKStride>(src, Kd, tid);
    }
    {  // V^T with the keys of each 32-key chunk in the A fragment's slot order.
      const unsigned char* src = smem + L::kV8Off + buf * L::kV8Bytes;
      unsigned char* VT = smem + L::kVOff;
      for (int w = tid; w < D * (BKV / 4); w += NTHREADS) {
        const int d = w % D, wi = w / D;  // wi: word of the V^T row (4 slots)
        const int key = 32 * (wi >> 3) + 16 * ((wi >> 2) & 1) + 2 * (wi & 3);
        const uint32_t x = (uint32_t)src[key * D + d] | ((uint32_t)src[(key + 1) * D + d] << 8) |
                           ((uint32_t)src[(key + 8) * D + d] << 16) |
                           ((uint32_t)src[(key + 9) * D + d] << 24);
        *reinterpret_cast<uint32_t*>(VT + d * L::kVTStride + 4 * wi) = x;
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
    widen_tile(buf);
    __syncthreads();

    const KT* Kt = reinterpret_cast<const KT*>(smem + L::kKOff + buf * L::kKBytes);
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

    // Online softmax in base 2; P rounds to bf16 as in the TPU kernel, then
    // to p8.
    float m_new[2], alpha[2], shift[2];
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
      // The x127 requantization of P is folded into the shift.
      shift[hf] = m_new[hf] - LOG2_127;
    }
    // P per n-tile and row half: two p8 bytes in the low 16 bits.
    uint32_t pa[NT][2];
    float lsum[2] = {0.0f, 0.0f};
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const float d0 = __bfloat162float(__float2bfloat16_rn(s[nt][2 * hf] - shift[hf]));
        const float d1 = __bfloat162float(__float2bfloat16_rn(s[nt][2 * hf + 1] - shift[hf]));
        const __nv_bfloat16 p0 = __float2bfloat16_rn(exp2f(d0));
        const __nv_bfloat16 p1 = __float2bfloat16_rn(exp2f(d1));
        const int c0 = min(__float2int_rz(__bfloat162float(__float2bfloat16_rn(__bfloat162float(p0) + 0.5f))), 127);
        const int c1 = min(__float2int_rz(__bfloat162float(__float2bfloat16_rn(__bfloat162float(p1) + 0.5f))), 127);
        lsum[hf] += (float)(c0 + c1);
        pa[nt][hf] = (uint32_t)c0 | ((uint32_t)c1 << 8);
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

    {
      // O += i32(p8 V8): per 32-key chunk, slots 4t..4t+3 hold n-tiles
      // (4c, 4c+1) and slots 16+4t.. hold (4c+2, 4c+3) of this thread's row.
      const unsigned char* VT = smem + L::kVOff;
      uint32_t a8[BKV / 32][4];
#pragma unroll
      for (int cc = 0; cc < BKV / 32; ++cc) {
        a8[cc][0] = pa[4 * cc][0] | (pa[4 * cc + 1][0] << 16);
        a8[cc][1] = pa[4 * cc][1] | (pa[4 * cc + 1][1] << 16);
        a8[cc][2] = pa[4 * cc + 2][0] | (pa[4 * cc + 3][0] << 16);
        a8[cc][3] = pa[4 * cc + 2][1] | (pa[4 * cc + 3][1] << 16);
      }
#pragma unroll
      for (int dt = 0; dt < DT; ++dt) {
        int c[4] = {0, 0, 0, 0};
        const unsigned char* vrow = VT + (dt * 8 + g) * L::kVTStride + 4 * t;
#pragma unroll
        for (int cc = 0; cc < BKV / 32; ++cc)
          mma_s8(c, a8[cc], *reinterpret_cast<const uint32_t*>(vrow + cc * 32),
                 *reinterpret_cast<const uint32_t*>(vrow + cc * 32 + 16));
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[dt][e] += (float)c[e];
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
  const float* vm = args.v_mean ? args.v_mean + kh * D : nullptr;
  const float* vs = args.v_scale + kh * D;
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int row = q0 + warp * 16 + g + 8 * hf;
    if (row >= Sq) continue;
    const bool empty = l_run[hf] == 0.0f;
    const float ls = empty ? 1.0f : l_run[hf];
    const long long obase = (qh * Sq + row) * D;
#pragma unroll
    for (int dt = 0; dt < DT; ++dt) {
      const int d = dt * 8 + 2 * t;
      float o0 = __fdiv_rn(acc[dt][2 * hf], ls);
      float o1 = __fdiv_rn(acc[dt][2 * hf + 1], ls);
      o0 = __fmul_rn(o0, vs[d]);
      o1 = __fmul_rn(o1, vs[d + 1]);
      if (vm && !empty) {
        o0 += vm[d];
        o1 += vm[d + 1];
      }
      store2(static_cast<OutT*>(args.o) + obase + d, o0, o1);
    }
    if (args.lse && t == 0) {
      args.lse[qh * Sq + row] = empty ? NEG_INIT : m_run[hf] + log2f(ls) - LOG2_127;
    }
  }
}

template <int D, int QM, bool KPACK>
int launch(const Args& a, int B, cudaStream_t stream) {
  constexpr int smem = Smem<D, QM, KPACK>::kTotal;
  auto kern = a.out_f32 ? attn_fwd_kernel<D, QM, KPACK, float> : attn_fwd_kernel<D, QM, KPACK, __nv_bfloat16>;
  const cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((a.Sq + BQ - 1) / BQ, a.H, B);
  kern<<<grid, NTHREADS, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

// Packed K is an INT8-QK mode; the fp mode takes bf16 K only.
template <int D, int QM>
int dispatch_k(const Args& a, int B, cudaStream_t st) {
  if constexpr (QM != Q_FP) {
    if (a.k_bits < 8) return launch<D, QM, true>(a, B, st);
  }
  return launch<D, QM, false>(a, B, st);
}

template <int D>
int dispatch_q(int q_mode, const Args& a, int B, cudaStream_t st) {
  switch (q_mode) {
    case Q_INT8: return dispatch_k<D, Q_INT8>(a, B, st);
    case Q_FUSED_BF16: return dispatch_k<D, Q_FUSED_BF16>(a, B, st);
    case Q_FUSED_F32: return dispatch_k<D, Q_FUSED_F32>(a, B, st);
    case Q_FP: return dispatch_k<D, Q_FP>(a, B, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// All tensors contiguous, natural layout.
//   q: [B, H, Sq, D] int8 codes (q_mode 0), bf16 (1, 3) or f32 (2).
//   k: q_mode 0-2: [B, Hk, Sk, D*k_bits/8] int8, codes (k_bits 8) or packed
//      INT4 (4) / INT2 (2) codes; q_mode 3: [B, Hk, Sk, D] bf16 (k_bits 16).
//   v: [B, Hk, Sk, D] int8 codes with v_scale [B, Hk, D] f32 (v_mode 2,
//      INT8 PV: the only V mode this kernel runs).
//   q_scale: [B, H, Sq] f32, already times sm_scale*log2e (q_mode 0 only).
//   k_scale: [B, Hk, Sk] f32 (q_mode 0-2).   v_mean: [B, Hk, D] f32 or null.
//   o: [B, H, Sq, D] bf16 (out_f32 = 0) or f32.   lse: [B, H, Sq] f32 (base 2) or null.
// The same arguments as lowbit_attn_fwd_wgmma, which runs every other mode.
// Returns cudaGetLastError() (cudaErrorInvalidValue for an unsupported D or
// mode).
extern "C" int lowbit_attn_fwd(const void* q, const void* k, const void* v, const float* q_scale,
                               const float* k_scale, const float* v_scale, const float* v_mean,
                               void* o, float* lse, int B, int H, int Hk, int Sq, int Sk, int D,
                               int q_mode, int k_bits, int v_mode, int out_f32, int causal,
                               float sm_scale_log2e, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool k_ok = q_mode == Q_FP ? k_bits == 16 : (k_bits == 8 || k_bits == 4 || k_bits == 2);
  if (!k_ok || v_mode != 2 || v_scale == nullptr) return (int)cudaErrorInvalidValue;
  const Args a{q, k, v, q_scale, k_scale, v_scale, v_mean, o, lse,
               H, Hk, Sq, Sk, causal, k_bits, out_f32, sm_scale_log2e};
  if (D == 64) return dispatch_q<64>(q_mode, a, B, st);
  if (D == 128) return dispatch_q<128>(q_mode, a, B, st);
  return (int)cudaErrorInvalidValue;
}
