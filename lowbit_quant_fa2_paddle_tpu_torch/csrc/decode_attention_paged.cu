// Kernel D over the paged KV cache: the serving engine's pool of pages.
//
// Replaces the TPU kernel lowbit_quant_fa2_paddle_tpu/ops/decode.py:
// _decode_kernel (pallas_call at :727) with a page_table (:508-567): the
// caches [Hk, n_pages, page, Dc] (int8 codes, packed 4-bit codes or bf16
// rows, each side its own), the scales [Hk, n_pages, page], the table
// [B, W] int32; row r of sequence b at page table[b, r / page], offset
// r % page; one query token or T (the speculative verify step), the window /
// sink walk, the cap, INT8 PV and the LSE, at head dims 32, 64 and 128
// (decode_attention_paged_d256.cu takes 256).
//
// The device code is decode_attention.cuh's kernel with kExt 3 (T rows, one
// token as T = 1) or 4 (and INT8 PV): the multi-token instances' code
// (decode_attention_multi.cu) but for the producer warp. A tile of BK keys
// (64, 32 or 16, whatever the page size) may lie on several pages and a page
// may hold several tiles, so the producer cuts the tile's keys into runs of
// one page each and issues one cp.async.bulk of K and one of V a run (a run
// of rows is contiguous within its page; every row is a multiple of 16 bytes,
// so every run starts 16-byte aligned), the scales by 4-byte cp.async a key,
// every table entry read on the device (__ldg). The stage's expected bytes
// are the tile's, as in the contiguous kernels, so the consumers, the split
// plan (over the table's W * page logical rows, never the lengths: the
// engine replays the decode tick as a CUDA graph) and the merge are the
// contiguous ones. Only the rows of the walk are read: a table entry past a
// sequence's used pages, or below its window, is never touched (after the
// engine's rolling reclamation such an entry may name another sequence's
// page). The contiguous kernels (kExt 0-2) compile from the same source as
// before: the paged producer is an `if constexpr (kPaged)` branch and its
// arguments ride in the Ext pack as a PagedExt.

#include "decode_attention.cuh"

// lowbit_decode_attn_multi's arguments (decode_attention_multi.cu) with S =
// width * page, then the table [B, width] int32 on the device, the pool's
// n_pages and the page size (a power of two). One token is q_tokens 1.
extern "C" int lowbit_decode_attn_paged(const void* q, const void* k, const void* v, const float* k_scale,
                                        const float* v_scale, const int* lengths, float* part_acc, float* part_ml,
                                        int* tickets, void* o, float* lse, int B, int H, int Hk, int S, int D, int R,
                                        int k_bits, int v_bits, int int_qk, int q_bf16, int out_code, int n_splits,
                                        int chunk, int window, int sink, int q_tokens, int int_pv, const int* table,
                                        int n_pages, int page, int width, float sm_scale, float logit_cap,
                                        void* stream) {
  LaunchPaged launch;
  const int err = paged_launch(&launch, q, k, v, k_scale, v_scale, lengths, table, part_acc, part_ml, tickets, o, lse,
                               B, H, Hk, S, R, q_bf16, out_code, n_splits, chunk, window, sink, q_tokens, int_pv,
                               n_pages, page, width, v_bits, sm_scale, logit_cap, stream);
  return err ? err : with_variant(launch, D, k_bits, v_bits, int_qk);
}

// How many CTAs of the paged variant (INT8 PV with int_pv) one SM of the
// current device holds at once, into *ctas_per_sm. Host-side only.
extern "C" int lowbit_decode_paged_ctas_per_sm(int D, int k_bits, int v_bits, int int_qk, int int_pv,
                                               int* ctas_per_sm) {
  return with_variant(OccupancyPaged{ctas_per_sm, int_pv}, D, k_bits, v_bits, int_qk);
}
