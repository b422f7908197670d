// Kernel E: attention over K and V stored as packed 4- or 2-bit codes with
// per-(token group, channel) scales and zero-points (KIVI grouping).
//
// Replaces the TPU kernel lowbit_quant_fa2_paddle_tpu/ops/fused_kv.py:
// _fused_kv_kernel (launched by fused_packed_kv_attention, pallas_call at
// :377). Its K-major twin _fused_kv_kernel_km is a TPU schedule and has no
// counterpart here.
//
// Inputs: codes packed along D (halves of D for 4 bits: byte i holds column
// i in its low nibble and i + D/2 in its high one; quarters for 2 bits: bits
// 2p..2p+1 hold column i + p*D/4), unsigned; one (scale, mn) row of D f32 per
// `group` consecutive tokens, so a key's value is code * scale + mn of its
// group.
//
// Math per KV tile, as in the TPU kernel, with the operands rounded to bf16
// for the tensor cores (the TPU kernel dots f32 Q and K):
//   K, V = bf16(fma(code, scale[g], mn[g]))         g = key / group
//   s    = f32(bf16(Q) K^T) * sm_scale*log2e
//   masked s = MASK_VALUE (-0.7 * FLT_MAX): keys >= Sk, and col > row when
//              causal (top-left aligned: row r sees keys 0..r, also when Sq != Sk)
//   m' = max(m, rowmax s);  P = exp2(s - m') in f32;  l = 2^(m-m') l + sum P
//   acc = 2^(m-m') acc + bf16(P) V                  (bf16 x bf16 -> f32)
//   o = acc / l, with l == 0 read as 1 (a row with nothing visible gives 0)
//
// Bound on the H100: the tensor cores, 4*D FLOPs per (q, k) pair (at b4 h32
// s8192 d64, 2.2 TFLOP against 0.07 GB of packed K/V), and in this simple
// form the dequantization and softmax on the CUDA cores: every CTA widens
// the whole K and V of its head. Design: one CTA of 4 warps per (64 q rows,
// head, batch), each warp 16 rows with m, l and the O accumulator in
// registers across the KV loop, as kernel A's fp mode. Packed K and V tiles
// of 64 keys stream through a two-stage cp.async ring; after each tile's
// barrier one pass widens them in shared memory to bf16 tiles (a thread
// keeps its columns' scale and mn rows in registers while the group holds);
// QK^T and PV run on mma.sync m16n8k16 bf16, P reused in registers as PV's A
// operand and V's B fragments from ldmatrix.trans. Causal CTAs stop at the
// diagonal and are launched heaviest first. Widening in registers and
// wgmma/TMA are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;   // query rows per CTA
constexpr int BKV = 64;  // keys per tile
constexpr int NTHREADS = 128;
constexpr float MASK_VALUE = (float)(-0.7 * 3.4028234663852886e38);
constexpr float NEG_INIT = -1e30f;

struct Args {
  const void* q;
  const unsigned char* k;
  const unsigned char* v;
  const float* k_scale;
  const float* k_mn;
  const float* v_scale;
  const float* v_mn;
  void* o;
  int H, Hk, Sq, Sk, group, n_groups, causal, q_f32, out_f32;
  float sm_scale_log2e;
};

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
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

// Shared memory: the bf16 K and V tiles (rows padded by 16 bytes so the 8
// rows a quad-group touches fall on distinct banks; the Q tile of the
// prologue lives in the V tile) and a two-stage ring of packed K and V.
template <int D, int BITS>
struct Smem {
  static constexpr int kStride = D + 8;           // bf16 elements per padded row
  static constexpr int kDp = D * BITS / 8;        // packed bytes per key
  static constexpr int kTile = BKV * kStride * 2;  // one bf16 tile
  static constexpr int kPack = BKV * kDp;          // one packed tile
  static constexpr int kKOff = 0;
  static constexpr int kVOff = kKOff + kTile;
  static constexpr int kPackOff = kVOff + kTile;  // [stage][K, V]
  static constexpr int kTotal = kPackOff + 4 * kPack;
};

template <int D, int BITS>
__global__ void __launch_bounds__(NTHREADS) fused_kv_kernel(const Args a) {
  using L = Smem<D, BITS>;
  constexpr int FPB = 8 / BITS;    // codes per byte
  constexpr int DP = L::kDp;       // packed bytes per key
  constexpr int CPR = DP / 16;     // 16-byte chunks per packed row
  constexpr int PART = D / FPB;    // columns per part
  constexpr uint32_t MASK = (1u << BITS) - 1u;
  constexpr int KSTEPS = D / 16;
  constexpr int NT = BKV / 8;
  constexpr int DT = D / 8;
  static_assert(NTHREADS % DP == 0, "a thread keeps the same byte column of every row");

  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* Kt = reinterpret_cast<__nv_bfloat16*>(smem + L::kKOff);
  __nv_bfloat16* Vt = reinterpret_cast<__nv_bfloat16*>(smem + L::kVOff);

  const int H = a.H, Hk = a.Hk, Sq = a.Sq, Sk = a.Sk;
  const bool causal = a.causal != 0;
  const int nq = (Sq + BQ - 1) / BQ;
  const int qb = causal ? nq - 1 - (int)blockIdx.x : (int)blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (H / Hk);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = qb * BQ;
  const long long qh = (long long)b * H + h;
  const long long kh = (long long)b * Hk + hk;
  const unsigned char* kg = a.k + kh * Sk * DP;
  const unsigned char* vg = a.v + kh * Sk * DP;
  const long long sbase = kh * a.n_groups * D;

  // ---- prologue: Q rounded to bf16, into the V tile, then A fragments ----
  {
    __nv_bfloat16* Qs = Vt;
    for (int e = tid; e < BQ * D; e += NTHREADS) {
      const int r = e / D, c = e % D;
      float x = 0.0f;
      if (q0 + r < Sq) {
        const long long i = (qh * Sq + q0 + r) * D + c;
        x = a.q_f32 ? static_cast<const float*>(a.q)[i]
                    : __bfloat162float(static_cast<const __nv_bfloat16*>(a.q)[i]);
      }
      Qs[r * L::kStride + c] = __float2bfloat16_rn(x);
    }
  }
  __syncthreads();
  uint32_t qa[KSTEPS][4];
  {
    const __nv_bfloat16* Qs = Vt;
    const int r0 = warp * 16 + g;
#pragma unroll
    for (int ks = 0; ks < KSTEPS; ++ks) {
      const int col = ks * 16 + 2 * t;
      qa[ks][0] = *reinterpret_cast<const uint32_t*>(Qs + r0 * L::kStride + col);
      qa[ks][1] = *reinterpret_cast<const uint32_t*>(Qs + (r0 + 8) * L::kStride + col);
      qa[ks][2] = *reinterpret_cast<const uint32_t*>(Qs + r0 * L::kStride + col + 8);
      qa[ks][3] = *reinterpret_cast<const uint32_t*>(Qs + (r0 + 8) * L::kStride + col + 8);
    }
  }

  // ---- KV loop ----
  const int nkv = (Sk + BKV - 1) / BKV;
  const int n_tiles = causal ? min(nkv, (q0 + BQ + BKV - 1) / BKV) : nkv;

  auto load_tile = [&](int j, int buf) {
    const int key0 = j * BKV;
    unsigned char* dk = smem + L::kPackOff + (2 * buf) * L::kPack;
    unsigned char* dv = dk + L::kPack;
    for (int c = tid; c < BKV * CPR; c += NTHREADS) {
      const int r = c / CPR, cc = c % CPR;
      const bool ok = key0 + r < Sk;
      const long long src = (long long)(ok ? key0 + r : 0) * DP + cc * 16;
      cp_async16(dk + r * DP + cc * 16, kg + src, ok);
      cp_async16(dv + r * DP + cc * 16, vg + src, ok);
    }
  };

  // Widen the staged packed tile of stage buf into the bf16 K and V tiles.
  // Thread tid owns byte column tid % DP of rows tid / DP + i * (128 / DP),
  // that is columns c + p * PART, and keeps their scale and mn while the
  // group holds. Keys past Sk become zeros.
  const int bc = tid % DP;
  int g_have = -1;
  float ksc[FPB], kmn[FPB], vsc[FPB], vmn[FPB];
  auto widen_tile = [&](int j, int buf) {
    const int key0 = j * BKV;
    const unsigned char* sk = smem + L::kPackOff + (2 * buf) * L::kPack;
    const unsigned char* sv = sk + L::kPack;
    for (int r = tid / DP; r < BKV; r += NTHREADS / DP) {
      const int key = key0 + r;
      const uint32_t bk = sk[r * DP + bc], bv = sv[r * DP + bc];
      if (key < Sk) {
        const int grp = key / a.group;
        if (grp != g_have) {
          g_have = grp;
          const long long base = sbase + (long long)grp * D + bc;
#pragma unroll
          for (int p = 0; p < FPB; ++p) {
            ksc[p] = a.k_scale[base + p * PART];
            kmn[p] = a.k_mn[base + p * PART];
            vsc[p] = a.v_scale[base + p * PART];
            vmn[p] = a.v_mn[base + p * PART];
          }
        }
#pragma unroll
        for (int p = 0; p < FPB; ++p) {
          const int col = bc + p * PART;
          Kt[r * L::kStride + col] = __float2bfloat16_rn(fmaf((float)((bk >> (p * BITS)) & MASK), ksc[p], kmn[p]));
          Vt[r * L::kStride + col] = __float2bfloat16_rn(fmaf((float)((bv >> (p * BITS)) & MASK), vsc[p], vmn[p]));
        }
      } else {
#pragma unroll
        for (int p = 0; p < FPB; ++p) {
          Kt[r * L::kStride + bc + p * PART] = __float2bfloat16_rn(0.0f);
          Vt[r * L::kStride + bc + p * PART] = __float2bfloat16_rn(0.0f);
        }
      }
    }
  };

  float m_run[2] = {NEG_INIT, NEG_INIT};
  float l_run[2] = {0.0f, 0.0f};  // per-thread partial row sums of f32 P
  float acc[DT][4];
#pragma unroll
  for (int i = 0; i < DT; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.0f;

  if (n_tiles > 0) load_tile(0, 0);
  cp_async_commit();
  for (int j = 0; j < n_tiles; ++j) {
    const int buf = j & 1;
    if (j + 1 < n_tiles) load_tile(j + 1, buf ^ 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    widen_tile(j, buf);
    __syncthreads();
    const int key0 = j * BKV;

    // S = Q K^T for 16 rows x 64 keys per warp.
    float s[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      float c[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      const __nv_bfloat16* krow = Kt + (nt * 8 + g) * L::kStride + 2 * t;
#pragma unroll
      for (int ks = 0; ks < KSTEPS; ++ks)
        mma_bf16(c, qa[ks], *reinterpret_cast<const uint32_t*>(krow + ks * 16),
                 *reinterpret_cast<const uint32_t*>(krow + ks * 16 + 8));
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = __fmul_rn(c[e], a.sm_scale_log2e);
    }

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

    // Online softmax in base 2 with f32 P; PV takes P rounded to bf16.
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
    uint32_t pa[NT][2];
    float lsum[2] = {0.0f, 0.0f};
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const float p0 = exp2f(s[nt][2 * hf] - m_new[hf]);
        const float p1 = exp2f(s[nt][2 * hf + 1] - m_new[hf]);
        lsum[hf] += p0 + p1;
        pa[nt][hf] = pack_bf16(__float2bfloat16_rn(p0), __float2bfloat16_rn(p1));
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

    // O += P V: the S accumulator of n-tiles (2kk, 2kk+1) is the A fragment
    // of a k16 step; V's B fragments come from ldmatrix.trans.
#pragma unroll
    for (int kk = 0; kk < BKV / 16; ++kk) {
      const uint32_t af[4] = {pa[2 * kk][0], pa[2 * kk][1], pa[2 * kk + 1][0], pa[2 * kk + 1][1]};
      const int vrow = kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
#pragma unroll
      for (int dp = 0; dp < D / 16; ++dp) {
        uint32_t bv[4];
        ldmatrix_x4_trans(bv, Vt + vrow * L::kStride + dp * 16 + (lane >> 4) * 8);
        mma_bf16(acc[2 * dp], af, bv[0], bv[1]);
        mma_bf16(acc[2 * dp + 1], af, bv[2], bv[3]);
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
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int row = q0 + warp * 16 + g + 8 * hf;
    if (row >= Sq) continue;
    const float ls = l_run[hf] == 0.0f ? 1.0f : l_run[hf];
    const long long obase = (qh * Sq + row) * D;
#pragma unroll
    for (int dt = 0; dt < DT; ++dt) {
      const int d = dt * 8 + 2 * t;
      const float o0 = __fdiv_rn(acc[dt][2 * hf], ls);
      const float o1 = __fdiv_rn(acc[dt][2 * hf + 1], ls);
      if (a.out_f32)
        *reinterpret_cast<float2*>(static_cast<float*>(a.o) + obase + d) = make_float2(o0, o1);
      else
        *reinterpret_cast<__nv_bfloat162*>(static_cast<__nv_bfloat16*>(a.o) + obase + d) =
            __floats2bfloat162_rn(o0, o1);
    }
  }
}

template <int D, int BITS>
int launch(const Args& a, int B, cudaStream_t st) {
  constexpr int smem = Smem<D, BITS>::kTotal;
  const cudaError_t err =
      cudaFuncSetAttribute(fused_kv_kernel<D, BITS>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((a.Sq + BQ - 1) / BQ, a.H, B);
  fused_kv_kernel<D, BITS><<<grid, NTHREADS, smem, st>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// All tensors contiguous, natural layout.
//   q: [B, H, Sq, D] f32 (q_f32 1) or bf16.   o: [B, H, Sq, D] f32 (out_f32 1) or bf16.
//   k, v: [B, Hk, Sk, D*bits/8] packed unsigned codes (bits 4 or 2).
//   k_scale, k_mn, v_scale, v_mn: [B, Hk, n_groups, D] f32, n_groups * group >= Sk.
// Returns cudaGetLastError() (cudaErrorInvalidValue for an unsupported D/bits).
extern "C" int lowbit_fused_kv_attn(const void* q, const void* k, const void* v, const float* k_scale,
                                    const float* k_mn, const float* v_scale, const float* v_mn, void* o,
                                    int B, int H, int Hk, int Sq, int Sk, int D, int bits, int group,
                                    int n_groups, int causal, int q_f32, int out_f32, float sm_scale_log2e,
                                    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B < 1 || H < 1 || Hk < 1 || H % Hk || Sq < 1 || Sk < 1 || group < 1 ||
      (long long)n_groups * group < Sk || B > 65535 || H > 65535)
    return (int)cudaErrorInvalidValue;
  const Args a{q, static_cast<const unsigned char*>(k), static_cast<const unsigned char*>(v), k_scale, k_mn,
               v_scale, v_mn, o, H, Hk, Sq, Sk, group, n_groups, causal, q_f32, out_f32, sm_scale_log2e};
  if (D == 64 && bits == 4) return launch<64, 4>(a, B, st);
  if (D == 64 && bits == 2) return launch<64, 2>(a, B, st);
  if (D == 128 && bits == 4) return launch<128, 4>(a, B, st);
  if (D == 128 && bits == 2) return launch<128, 2>(a, B, st);
  return (int)cudaErrorInvalidValue;
}
