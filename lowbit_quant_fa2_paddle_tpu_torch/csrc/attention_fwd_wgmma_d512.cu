// Kernel A at head_dim 512 without masks or a bias: INT8 QK (Q codes given
// or quantized in the kernel), bf16 QK, packed INT4/INT2 K, INT8 V (widened
// or INT8 PV). attention_fwd_wgmma_d512_masked.cu holds the masked and bias
// kernels at 512; fp32 PV has no d512 kernel.
//
// Replaces the TPU kernel lowbit_quant_fa2_paddle_tpu/ops/attention.py:
// _attn_body_km (pallas_call at :1491 and :1502) at head dims 257-512 (the
// JAX launcher pads them to a multiple of 64, core.py:73-82; this kernel
// takes 512 and the caller pads 257-511: one set of instances instead of
// four, at the cost of up to 37.5% zero columns at d320). The device code
// is attention_fwd_wgmma.cuh's kernel at D = 512 (design note in
// attention_fwd_wgmma.cu): a CTA of 64 query rows, its two consumer
// warpgroups each owning 256 of O's columns (kCS) and each computing the
// whole S = Q K^T itself, KV tiles of 64 keys. These instances live in their
// own translation unit so that nvcc builds them beside the others.

#include "attention_fwd_wgmma.cuh"

// A checked call at D 512 without masks or a bias.
int attn_fwd_d512(const AttnFwdCall& c) {
  const BiasArgs a = args_of(c);
  return dispatch_modes<512, false>(a, c.v_mode == 2, c.k, c.v, c.B, c.stream);
}
