// Kernel A's fp32-PV instances at head_dim 256, INT8 and bf16 QK (pv_dtype
// float32; pv_accum_dtype "fp32+fp32" in core.py).
//
// Replaces the TPU kernel lowbit_quant_fa2_paddle_tpu/ops/attention.py:
// _attn_body_km (pallas_call at :1491 and :1502) with pv_dtype = float32
// (:327, :454-455) at head dims 129-256 (padded to 256 by the caller). The
// device code is attention_fwd_wgmma.cuh's kernel with kPV32 at D = 256
// (design notes there and in attention_fwd_wgmma.cu): 64-key tiles, two
// consumer warpgroups, P and V in three bf16 terms each, six products a
// 16-key step into a 64-column block's own accumulator, four blocks a tile
// added to O on the CUDA cores one after another. A stage holds 16 KB (INT8
// QK) or 32 KB (bf16 QK) of K and 96 KB of V's terms beside a 32 or 64 KB Q
// tile, so the ring has one stage: the next tile's loads wait for this one's
// products. These instances live in their own translation unit so that nvcc
// builds them beside the others.

#include "attention_fwd_wgmma.cuh"

// A checked call with fp32 PV at D 256.
int attn_fwd_pv32_d256(const AttnFwdCall& c) {
  return dispatch_pv32<256>(args_of(c), c.k, c.v, c.B, c.stream);
}
