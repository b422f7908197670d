// Kernel A at head_dim 512 with masks or a bias (a window with sinks, a q
// offset, segment ids, a logit cap, a bias vector or matrix), in every mode
// attention_fwd_wgmma_d512.cu takes: at d512, as at d256, the masked kernels
// are the bias kernels.
//
// Replaces the TPU kernel lowbit_quant_fa2_paddle_tpu/ops/attention.py:
// _attn_body_km (pallas_call at :1491 and :1502) with masks or a bias at
// head dims 257-512 (design note in attention_fwd_wgmma.cu, the d512 split
// of O in attention_fwd_wgmma_d512.cu). These instances live in their own
// translation unit so that nvcc builds them beside the others.

#include "attention_fwd_wgmma.cuh"

// A checked call at D 512 with masks or a bias.
int attn_fwd_d512_masked(const AttnFwdCall& c) {
  const BiasArgs a = args_of(c);
  return dispatch_modes<512, true, true>(a, c.v_mode == 2, c.k, c.v, c.B, c.stream);
}
