// Kernel A's fp32-PV instances at head dims 64 and 128 (pv_dtype float32;
// pv_accum_dtype "fp32+fp32" in core.py).
//
// Replaces the TPU kernel lowbit_quant_fa2_paddle_tpu/ops/attention.py:
// _attn_body_km (pallas_call at :1491 and :1502) with pv_dtype = float32
// (:327, :454-455): the softmax chain in f32, P and V in f32 in the PV
// product. The device code is attention_fwd_wgmma.cuh's kernel with kPV32
// (the design note is in attention_fwd_wgmma.cu): the masked kernels, INT8
// or bf16 QK, packed K through the staging ring, 64-key tiles, P and V in
// three bf16 terms each and six bf16 products a 16-key step (the terms'
// orders adding to at most 2) into a 64-column block's own f32 accumulator
// (its first product at scale-d 0), added to the f32 O on the CUDA cores
// once the block's products are in. Its instances live in their own
// translation unit so that nvcc builds them beside the others.

#include "attention_fwd_wgmma.cuh"

// A checked call with fp32 PV, D 64 or 128.
int attn_fwd_pv32(const AttnFwdCall& c) {
  const BiasArgs a = args_of(c);
  return c.D == 64 ? dispatch_pv32<64>(a, c.k, c.v, c.B, c.stream) : dispatch_pv32<128>(a, c.k, c.v, c.B, c.stream);
}
