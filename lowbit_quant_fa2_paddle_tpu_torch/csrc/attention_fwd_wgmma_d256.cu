// Kernel A at head_dim 256, every mode but fp32 PV: INT8 QK (Q codes given
// or quantized in the kernel), bf16 QK, packed INT4/INT2 K, INT8 V (widened
// or INT8 PV), the masks and the bias.
//
// Replaces the TPU kernel lowbit_quant_fa2_paddle_tpu/ops/attention.py:
// _attn_body_km (pallas_call at :1491 and :1502) at head dims 129-256 (the
// JAX launcher pads head dims to a multiple of 64, core.py:73-82; this
// kernel takes 256, the caller pads 129-255). The device code is
// attention_fwd_wgmma.cuh's kernel at D = 256 (design note in
// attention_fwd_wgmma.cu): KV tiles of 64 keys, two consumer warpgroups,
// PV as two 128-column products, INT8 PV in two halves one after the
// other. fp32 PV at d256 is attention_fwd_wgmma_pv32_d256.cu's. These
// instances live in their own translation unit so that nvcc builds them
// beside the d64/d128 ones, which keep their code.

#include "attention_fwd_wgmma.cuh"

// A checked call at D 256 without fp32 PV.
int attn_fwd_d256(const AttnFwdCall& c) {
  const BiasArgs a = args_of(c);
  return dispatch<256>(a, c.v_mode == 2, c.k, c.v, c.B, c.stream);
}
