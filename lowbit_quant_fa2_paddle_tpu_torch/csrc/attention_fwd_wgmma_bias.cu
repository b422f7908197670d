// Kernel A's bias instances at head dims 64 and 128: every mode's masked
// kernel with an additive bias (a per-key vector [B, H, 1, Sk] or a full
// matrix [B, H, Sq, Sk], in natural-log units), taken to base 2 where it is
// loaded and added after the scale, before the cap and the masks.
//
// Replaces the TPU kernel lowbit_quant_fa2_paddle_tpu/ops/attention.py:
// _attn_body_km (pallas_call at :1491 and :1502) with bias (:379-384; the
// launcher scales it by log2 e in f32, :1416-1424), and so the Q-major
// lowbit_attention's bias callers (:1183 / :1194, bias at :848). The device
// code is attention_fwd_wgmma.cuh's kernel with kBias (design note in
// attention_fwd_wgmma.cu). These instances live in their own translation
// unit, built beside the others; the masked kernels without the bias keep
// their code.

#include "attention_fwd_wgmma.cuh"

// A checked call with a bias, D 64 or 128, without fp32 PV.
int attn_fwd_bias(const AttnFwdCall& c) {
  const BiasArgs a = args_of(c);
  return c.D == 64 ? dispatch_bias<64>(a, c.v_mode == 2, c.k, c.v, c.B, c.stream)
                   : dispatch_bias<128>(a, c.v_mode == 2, c.k, c.v, c.B, c.stream);
}
