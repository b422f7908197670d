#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (H100, sm_90a).

    python3 chip_smoke.py

First, before any module of the port is imported, the tuning cache
(LOWBIT_FA_TORCH_TUNING_CACHE) is pointed at a file in a temp dir of this
run, printed and removed at the end: no user's cache moves a figure, and
only phase 24 records entries. Phases, each of which raises on failure
(exit code 1, no result line):

1. device: a CUDA card is required; prints nvidia-smi's name and power limit;
2. build: compiles the port's kernels (csrc/*.cu) with nvcc, prints seconds
   and each kernel's registers and spills;
3. kernels C1, C2, C3 (quant_int8, quant_int4, quant_int2) against their
   plain PyTorch versions on the card at the CogVideoX-2b K shape b1 h30
   s17776 d64 with the K mean, per token and per block, at a ragged s1000,
   at d128, on the DiT's K as it hands it over (a strided view of its qkv
   projection; per block 64 with the edge blocks of s17776 and s1000), and
   (C1) at the LLM prefill's K (b4 h8 s32704 d128): codes and scales must be
   equal, every launch on the vector design. C1 timed per token on the DiT K
   view and on a contiguous K of its shape, at the LLM prefill K and per
   block 64; C2 per token on the view and contiguous; C3 per token on the
   view and contiguous and per block 64; each with GB/s, its share of the
   bound, the plain version's ms and its design; and k_mean on the DiT K
   view;
4. kernel A (lowbit_attention) against its plain version: int8 with Q
   quantized in the kernel, int8 with external Q codes, fp, causal, GQA
   8q/2kv, d128, ragged s1000, smooth-V and the checkpoint's prefill, with
   and without the LSE; then int8 (Q quantized in the kernel) and fp at b1
   h30 s17776 d64 and at the LLM prefill's shape (causal GQA 32q/8kv d128
   s32704, one batch row), each timed beside PyTorch's SDPA in bf16 (a
   baseline) with the SM clock sampled after the timing, its TFLOP/s, its
   tensor-core bound and its exp2 floor (one exp2 per visible (q, k) pair on
   the 16-per-clock MUFU pipe of 132 SMs at 1.98 GHz). Every mode runs on
   the wgmma design (csrc/attention_fwd_wgmma.cu); then its low-bit modes
   (packed INT4 K, packed INT2 K, INT8 V, INT8 V with INT8 PV) at b1 h30
   s17776 d64, causal GQA 8q/2kv d128 and ragged s1000, timed at the first,
   INT8 PV also at its edges (Sk 777, causal Sq 700 / Sk 1000 d128, GQA
   32q/8kv d128, packed INT4 K, bf16 QK), the same bits twice. The plain version rounds P
   (or p8) where the kernel does and differs only in summation order, so
   the bounds are cos >= 0.99999, max|do| <= 2e-2 (a bf16 ulp of outputs up
   to 4 is 1.6e-2) and max|dlse| <= 1e-3, except that INT8 PV's bf16-QK
   edge, whose logits the two sum in another order, holds a row past 1e-3
   to a change of at most 3 codes in its sum of p8 codes (one exponent
   argument across one bf16 step; PV8_MAX_DL). Then the entry points
   lowbit_fa_attn(bits="int2"), (bits="auto") and (bits="int8_v8",
   pv_int8=True) at b1 h30 s17776 d64, each with its launch counts, kernel
   A's by design;
5. main path: the full-width, full-depth CogVideoX-2b DiT (dim 1920, 30
   heads x 64, depth 30, random weights from a seeded generator) takes 3
   denoise steps x <- x - 0.1 * eps on b1 s17776 latents with each of
   attn_impl="int8", "int8_v8", "int4" and "fp". The frames must be finite
   and agree with fp (cos >= 0.999), the first step's eps must agree with
   fp (cos >= 0.99 for int8_v8, >= 0.98 for int4, the JAX package's DiT
   bound), and the launch counters must show every attention call went
   through kernel A (90 per impl, all on the wgmma design) and every K
   quantization through C1 (90
   for int8 and int8_v8) or C2 (90 for int4), all on the vector design (K
   read where it lies in the qkv projection). One int8 step under
   torch.profiler: device ms and kernel counts of A, C1/C2, PyTorch's copy
   and mean kernels, the GEMMs and the rest. Then one step with per-channel
   w8 weights (quantize_dit_params) and int8 attention: eps cos vs the dense
   step >= 0.99, and no F launch (17,776 rows take the dense route), and
   its other 2 steps (frame cos vs fp printed); every impl's frames kept for
   phase 24's perceptual scores;
6. kernels G1/G2 (attention_bwd_dq, attention_bwd_dkv) through flash_bwd
   against attention_bwd_plain: float and quantized (int8 codes) at b1 h30
   s17776 d64 bf16, causal GQA 8q/2kv d128 at a ragged s1000 (both modes),
   a causal window of 256 at s2048, f32 inputs at b1 h4 s512 d64, and the
   wgmma design's edges (Sq/Sk 127/129, causal 129/127, Sq 1 Sk 777 d128,
   causal GQA 32q/8kv d128 s777, window 256 GQA d128 s777, d32 padded);
   cos >= 0.99999 and max|d| <= 2 bf16 ulps of each gradient's max|.| (the
   plain version rounds p and ds where the kernels do); one G1 and one G2
   per call, both on the wgmma design (csrc/attention_bwd_wgmma.cu), and
   four C1 with the quantized mode; the float DiT-shape gradients the same
   bits on a second run. Each timed alone at the DiT shape beside the plain
   version (the pair) and aten's flash-attention backward (dq, dk, dv in one
   call, given SDPA's forward outputs);
7. gradients of flash_attention_trainable (cos >= 0.999),
   lowbit_attention_trainable (>= 0.99) and its bwd_quantized (>= 0.999)
   against a dense fp32 autograd oracle at b2 h4 s1024 d64 bf16, both
   causal settings, with their launches (A, G1, G2 once each, G1/G2 on the
   wgmma design; C1 once for the int8 forward and four more for the
   quantized backward);
8. DiT training: tiny_config, 3 sgd_train_steps at lr 1e-2 must lower the
   loss; then the full-width CogVideoX-2b DiT (depth 30, random weights) on
   a b1 s17776 latent with flash_train, then int8_train, each on a fresh
   model: a warm-up forward and backward (gradients finite), 3
   sgd_train_steps at lr 1e-4 (ms, loss, peak memory, the share of
   parameters the first step changed), exactly depth launches of A, G1 and
   G2 per step (and of C1 for int8_train, on the vector design), every G1
   and G2 on the wgmma design, and none of C2/C3/D/E/F, one step
   under torch.profiler (device ms of G1, G2, A, C1, GEMMs, the rest); the
   two impls' first losses within 1% and block 0's qkv weight gradients at
   cos >= 0.99;
9. kernel D (decode_attention) against its plain version: int8, bf16, int4
   and k4v8 caches (4-bit K on the float chain that "auto" takes and on the
   integer chain, "int_qk") at b4 h32 hk8 d128 S_max 32768 with lengths [32768, 1, 4097, 0],
   d64 MHA, d32 GQA 8q/2kv, and the checkpoint's b64 S_max 128 with f32
   queries, with and without the LSE; and the design's edges: lengths
   127/128/129, lengths at a split boundary +- 1 (from the split plan), a
   GQA group of 8 (64q/8kv d128) and f32 queries at d32. Both sides are f32
   and differ only in summation order: cos >= 0.99999, max|do| <= one bf16
   ulp of max|o|, max|dlse| <= 1e-4; the same bits on a second run, every
   launch on D's design (csrc/decode_attention.cu). Timed at every length
   32768 in every mode, with the GB/s of cache bytes streamed (SDPA, one
   query per head, beside the bf16 cache);
10. (run after phase 13) kernels F1/F2 (wq_matmul_per_channel,
   wq_matmul_fused) against their plain versions: w8, w8a8, w4
   per-channel and grouped 2/4/8-bit (group
   128) at the full-width decode shapes M=4 x (N, K) in {(4096, 4096),
   (1024, 4096), (16384, 4096), (4096, 16384)} bf16, w8/w4 at the
   checkpoint's shapes with M=64 f32 x, and M=1000; cos >= 0.99999 and
   max|dy| <= 2 bf16 ulps (f32: 1e-5) of the larger of max|y| and F2's dot
   before its zero-point term, w8a8 bit-equal, the decode shapes the same
   bits twice, every F1 and F2 launch on its design (bf16 x and F1's int8 x
   on the tensor cores: M 4 and M 1000; f32 x on the CUDA cores: M 64).
   Timed at the decode shapes (N 1024 included) with the weights read from
   HBM, beside torch.matmul on the dense bf16 W, and summed to a 32-layer
   decode step; w8a8 timed whole (with its plain-op activation quantizer)
   and as the kernel alone; the copy-only probe of F2's tensor-core design
   (script/torch_gemv_ab.py, built while the first phases run) gives the
   TB/s its loads alone reach; then the w8a8 and grouped entry points once
   each, counted;
11. kernel E (fused_packed_kv_attention) against its plain version: bits 4
   and 2, causal or not, at b4 h32 s8192 d64 (the kivi4 sweep shape) and
   GQA 32q/8kv d128 at a ragged s1000 and at Sq 700 != Sk 1000 (group 64),
   and the wgmma design's edges (groups 32 and 512 against its 128-key
   tiles, Sk 129, Sk 777 with group 100, causal Sq 700 / Sk 1000 at d128);
   cos >= 0.99999, max|do| <= 2e-2, the same bits on a second run, every
   launch on the wgmma design (csrc/fused_kv_attention_wgmma.cu); timed at
   b4 h32 s8192 d64 beside SDPA on the dequantized bf16 K/V; its entry
   point once, counted;
12. the trained checkpoint eval_out/arith_llm.npz: greedy generate of 4
   tokens on 64 three-shot addition prompts with per-channel w8 and w4
   weights on the int8 cache; task exact-match >= 0.98 in every run (printed
   beside the JAX package's CPU figures 1.0 and 0.984375 for w8 and w4),
   launch counts per run (6 F per layer and decode step, none in the
   2,304-row prefill; f32 x, so all on the CUDA-core design). Its runs with
   the int8, bf16, int4 and k4v8 caches are phase 24's ladder;
13. LLM main path at full width (dim 4096, 32 query heads x 128, 8 KV
   heads, vocab 256, bf16, depth LLM13_DEPTH = 16 of the geometry's 32 for
   the run's time limit, random weights from a seeded generator): generate 64 tokens at b4 from a 32,704-token prompt with
   max_seq 32768, with the int8 cache, the bf16 cache, and then w8 and w4
   weights (quantize_llm_params of the same model) on the int8 cache, each
   as llm_prefill then decode_tokens, whose steps run as one captured CUDA
   graph (an eager first step, the capture, 62 replays, over three calls).
   Prints block-weight bytes, prefill seconds, decode ms per token (host
   clock over one call of 53 replays, and the device time of 8 single-replay
   calls from CUDA events), peak memory; the first
   decode step's int8-vs-bf16 logits cos must be >=
   0.999 and w8-vs-dense >= 0.99 (w4 printed); the counters must show depth
   A (wgmma design) and C1 (vector design) launches per prefill, depth x 63 D launches (all
   on D's design), and 6 x depth x 63 F1 (w8) or F2 (w4) launches, all on the
   tensor-core design, and none at prefill. Then one decode step per weight
   format at a 256-token context through utils.profiling.trace (a
   torch.profiler session that writes a Chrome trace into the run's temp
   dir, which must name D's kernel and, with w8 / w4 weights, F's), and one
   per cache mode at the full 32K context with dense weights under
   torch.profiler: device ms of F, the dense GEMMs, D and the rest;
14. long context at the same full width, depth cut to 8 of 32 for the
   run's time limit (bench/llm_e2e_bench.py at its --ctx 131072): first,
   at phase 13's 32K b4 prompt, llm_prefill_chunked
   (chunks of 4096) against the one-shot llm_prefill with the int8 and the
   k4v8 cache (last-token logits cos >= 0.999 / 0.995, the JAX package's
   test bounds), and 16 graph-decoded tokens against a loop of
   llm_decode_step from cloned k4v8 caches (identical tokens, bit-equal
   caches), both timed; then b4, a 131,072-token prompt, max_seq 133,120,
   the k4v8 cache (~6.8 GB over the 8 layers): the chunked prefill (per
   layer one C1 and one A
   a chunk, one more A for every chunk after the first) and 32 graph-decoded
   tokens (depth x 32 D launches, all on bulk_ring), with prefill seconds,
   decode ms per token, cache GB and peak memory; the strided cache-slice
   copies' and the V dequantization's share of the prefill; the last
   prefill chunk and one decode step under torch.profiler; then kernel A at
   that chunk's shapes (in-chunk causal int8 K; packed int4 K over the
   cache's 126,976 rows, non-causal) and kernel D on layer 0's 128K k4v8
   cache (both QK chains) against their plain versions, at phase 4's and
   phase 9's bounds, the packed-K A and the float-chain D timed; and
   phase 15's 128K rows (below);
15. kernel A's masks and kernel D's window walk (run after phase 13, on its
   model, before phase 14): A in every mode (int8, Q quantized in the
   kernel, fp, packed INT4/INT2 K, INT8 V, INT8 PV; d64 and d128) at the
   masks' edges (a window below and not a multiple of the 128-key tile,
   sinks not a tile multiple and past the window's start, a q offset that
   empties every band, Sq != Sk, segment ids cut inside tiles with a q
   segment no key has, the logit cap with and without a window) against
   the plain version at phase 4's bounds, empty rows o = 0 / lse -1e30, the
   same bits twice, every launch on wgmma; then A timed at
   bench/window_bench.py's prefill shape (b4 h32 s32768 d64 causal, int8):
   full, window 4096, window 1024, window 1024 + sink 128, fp window 4096
   beside SDPA with the boolean band mask; at the window LLM's prefill
   shape (b4 h32 hk8 s32704 d128, window 4096, with and without 4 sinks;
   these two rows carry the window LLM's prefill launches); lowbit_fa_varlen at b1
   h32 d128 over 32,768 ragged causal tokens (one C1 and one A; SDPA with
   the block-diagonal mask beside it); the logit cap 50 at the DiT shape;
   each against the plain version on all its inputs (the int8 rows one
   batch row at a time). D's window walk at b4
   h32 hk8 S_max 32768 d128 (window 4096, + 4 and + 128 sinks; int8 on both
   chains, bf16 beside SDPA with a window mask, k4v8 on both chains) at
   lengths below the window, at and inside tile edges and full, against the
   plain version at phase 9's bounds, the same bits twice, timed at full
   length; window 8192 (+ 128 sinks) on phase 14's 128K k4v8 layer-0 cache,
   both chains. Then phase 13's model with window_size 4096 (Mistral-7B's
   sliding_window), b4, the 32,704-token prompt: llm_prefill and 32 graph
   tokens with the int8 and the bf16 cache, then int8 with 4 sinks
   (StreamingLLM); depth A / C1 launches a prefill and depth x 32 D a
   decode, first-step logits int8 vs bf16 cache cos >= 0.999, 16 graph
   tokens equal to the eager loop's with bit-equal caches, one profiled
   decode step (D's share), window vs full-causal logits printed;
16. kernel D's multi-token (verify) and INT8-PV instances and speculative
   decoding (run after phase 15, on phase 13's model, before phase 14): the
   edge grid of utils/decode_cases.py (T rows straddling a tile and a split,
   a window whose band start moves with t, lengths below T + window, INT8
   PV with all-masked tiles; int8, bf16, int4 and k4v8 caches, both QK
   chains, d32/64/128) against the plain version on the kernel's own tiles
   at phase 9's bounds, the same bits twice; D over T = 1, 2, 4, 8 tokens at
   b1 and b4 (h32 hk8 S_max 32768 d128, int8 cache) timed with GB/s and its
   bound (the cache read once, whatever T) beside SDPA over the bf16 cache
   with the causal tail mask (a baseline), INT8 PV against "auto" at b4, T 4
   at b4 with lengths 4-131, the int4 cache at b1, every launch counted on
   its variant (ops.decode.launch_variant); then at full width, b1, the
   first row of phase 13's prompt, the int8 cache, 64 new tokens:
   generate's prefill and graph
   decode (the reference tokens and ms per token), and speculative_generate
   with spec_k 4 and two drafts (the same weights through an int4 cache; w4
   weights through an int4 cache), each token-equal to generate, with
   rounds, mean accepted, ms per emitted token and launch counts (depth D a
   verify step on the T-token variant at T = its drafts, depth D a drafted
   token on the single-token int4 variant, 6 x depth F2 a drafted token for
   w4), one 4-token verify step's host wall and device ms, and its rows
   against 4 sequential decode steps (same argmax; cos >= 0.9999 in bf16
   at the 32K context, where the two split the keys otherwise, and >=
   0.99999 after a 16-token prompt and in f32 at depth 2 after 16 and
   1,000 tokens); then the
   trained checkpoint: speculative_generate of 8 tokens on each of 64
   prompts with the int4-cache and the w4 self-drafts, equal to generate on
   every prompt, exact-match >= 0.98;
17. kernel A's rest and kernel D at head_dim 256 (run last, after phase
   14): A at d256 in every mode (int8, Q codes given or quantized in the
   kernel, fp, packed INT4/INT2 K, INT8 V, INT8 PV) and at d192 (padded),
   unmasked and at the masks' edges, and the bias (vector and matrix, with
   causal masking, a window and the cap) and fp32 PV (pv_dtype float32, f32
   V or int8 codes, d64/d128/d256, INT8 and bf16 QK) at their edges, over
   the grids of utils/mask_cases.py, against the plain version at phase 4's
   bounds (fp32 PV's f32 output within PV32_MAX_DO, 1e-5), the same bits
   twice, every launch on the kernel of its head dim; A timed in every mode at bench.py:119's b4
   h8 s4096 d256 (SDPA bf16 at d256 under its own dispatch beside fp),
   int8 at the hd256 LLM's
   prefill (b4 h16 hk8 s32704 d256 causal), the bias vector at the DiT
   shape and the matrix at b1 h8 s4096 d128 (SDPA with a float attn_mask
   beside them), fp32 PV at the DiT shape and at d256 with INT8 and with
   bf16 QK at bench.py:119's shape (SDPA on f32 inputs beside each);
   D at d256 in every cache mode of phase 9 at b4 h16 hk8 S_max 32768
   (lengths 32768/1/4097/0), a split boundary +- 1, f32 queries and a
   window of 300 + 8 sinks with the cap 2, at phase 9's bounds, timed at
   every length 32768 (SDPA beside bf16); C1 on the hd256 LLM's K (b4 h8
   d256, per token, over 32,704 and 4,096 tokens) bit-equal to its plain
   version on the vector design, timed. Then the full-width LLM with
   256-wide heads (bench/llm_e2e_bench.py --heads 16 --kv-heads 8
   --head-dim 256: dim 4096, depth 16 of 32 for the run's time limit,
   Gemma 2 9B's attention geometry, random seeded weights), b4 from a
   32,704-token prompt: llm_prefill and
   63 graph-decoded tokens on the int8 and then the bf16 cache (depth A and
   C1 launches a prefill, depth x 63 D, all A and D at d256), first-step
   logits int8 vs bf16 cache cos >= 0.999, then llm_prefill_chunked
   (4096) into a k4v8 cache against the one-shot prefill's last-token
   logits (cos >= 0.995) and A on its last chunk (packed INT4 K over the
   cache's 28,672 rows) against the plain version, timed;
18. kernels G1/G2 and D's T-token / INT8-PV instances at head_dim 256 (run
   after phase 17, on its model): G1/G2 over utils/bwd_cases.py (d256 and
   d192, bf16 and int8 codes, ragged Sq/Sk, causal GQA, windows, f32) at
   phase 6's bounds, the same bits twice, every launch at head dim 256;
   both trainable functions at d256 (with and without a causal window)
   against a dense fp32 oracle; G1/G2 timed at b1 h8 s17776 d256 beside
   aten's flash backward; D over utils/decode_cases.py's d256 cases (T
   1-8, every cache mode, both chains, window / sink, cap, INT8 PV) at
   phase 9's bounds, and timed at h16 hk8 S_max 32768 d256 (T 1-8 at b1 and
   b4 on the int8 cache beside SDPA with the causal tail mask, T 4 on the
   bf16, int4 and k4v8 caches, INT8 PV at b4); phase 16's full-width
   verify path on phase 17's model (b1, 32K, spec_k 4, the int4-cache and
   w4 drafts token-equal to generate); then the DiT with 256-wide heads
   (CogVideoX-2b's depth 30 and latent with Gemma-2B's 8 x 256 attention,
   hidden 2048): per training impl a warm-up backward, block 0's attention
   on its own q, k, v against the fp32 oracle, 3 SGD steps with launch
   counts (every G1/G2 at head dim 256), peak memory and a profiled step.

19. kernel D over the paged KV cache and the serving engine (run after
   phase 16's full-width runs, on phase 13's model, before phase 14): the paged edge grid of
   utils/decode_cases.py (tiles across pages and pages of several tiles,
   lengths 0 and at page edges, T 1-4, window / sink, cap, INT8 PV, every
   cache mode, d32-d256, every unvisited page NaN) against the paged plain
   version at phase 9's bounds; paged D at b8 h32 hk8 d128 with 32,768 rows
   a sequence in shuffled pages of 16, 64 and 4096 (int8, k4v8) against the
   plain version, timed beside the contiguous kernel on the same rows; then
   ServingEngine on phase 13's model: 16 requests of 1,024-8,192 tokens (8
   sharing a 4,096-token prefix), 64 new tokens, pages of 64, 8 slots, under
   (a) reserve admission, (b) lazy admission on the largest pool of at
   most 60% of (a)'s peak pages on which the host scheduler preempts
   (preemptions, streams equal (a)'s), (c) the prefix cache (hits; hit
   requests' first-token logits cos >= 0.999 against (a)'s), (d) a prefill
   budget of 2048 (one-chunk prompts' streams equal (a)'s, first-token
   logits cos >= 0.999, no decode tick skipped), (e) n-gram speculation
   (spec_ngram 3, spec_k 4; streams equal (a)'s), (f) multi_step 8 and
   async_fetch (streams equal (a)'s), (g) k4v8 pages and w8 weights
   (logged), each with tokens out, TTFT p50/p99, tokens/s (and decode
   tokens/s over the steps that prefilled nothing), peak pages and memory
   and launch counts; the decode tick's host wall against its graph
   replay's device ms and its profile (D, GEMMs, the rest); (h) the
   window-4096 twin, 4 requests of 12,288 tokens, budgets 2048 and 12,288
   (one chunk): live pages within window / page + 3, first-token logits cos
   >= 0.999 against generate's, the one-chunk run's tokens equal to
   generate's; (i) the trained checkpoint's 64 prompts through the engine
   on int8, int4 and k4v8 pages: exact-match equal to generate's on the
   same cache mode.

20. kernel D at head dims 80 and 96 and the Phi-3-mini-geometry LLM (run
   after phase 18): D over utils/decode_cases.py's d80/d96 cases, contiguous and
   paged (T 1-8, every cache mode and both chains, tile and split edges, a
   window with sinks, the cap, INT8 PV, 40-byte 4-bit rows, pages of
   8-64) at phase 9's bounds, every launch at its head dim; C1 at the d96
   prefill's K (padded to 128 by the entry point: vector; left 96 wide:
   scalar), bit-equal and timed; D timed in every cache mode at b8 h32 hk32
   S_max 4096 d96 (Phi-3-mini's decode) and S_max 2048 d80 (Phi-2's),
   with the byte bound and SDPA (one query a head over the bf16 cache)
   beside, and its T-token (T 4) and paged (pages of 64) instances at d96;
   F1 w8 at the model's MLP matrices (M 8); then the model (dim 3072, 32
   heads and 32 KV heads of 96, depth 16 of 32, vocab 32064, 1.91 B random
   seeded parameters) at b8 from 3,968-token prompts: llm_prefill and 63
   graph-decoded tokens on the int8, bf16, int4 and k4v8 caches and with
   w8 weights (launch counts, every D at head dim 96; first-step logits
   int8 vs bf16 cache cos >= 0.999; an int8 decode step profiled);
   speculative_generate (b1, spec_k 4, int4 self-draft) token-equal to
   generate; ServingEngine (pages of 64, 8 slots, 8 requests of
   1,024-3,968 tokens, 32 new each, int8 pages) with each stream equal to
   generate's on its prompt alone or parting at a near-tie (generate's row
   puts the engine's token at most 4 times the b1-vs-b8 step's largest
   |logit difference| below its own); the int8 cache saved and reloaded
   (utils/checkpoint.py) decodes the same tokens.

21. kernels D and E at the head dims they take at run time and the
   MPT-30B-geometry LLM (run last): D over utils/decode_cases.py's d16, d48,
   d112, d144, d192 and d240 cases, contiguous and paged (T 1-8, every cache
   mode and both chains, tile and split edges, a window with sinks, the
   cap, INT8 PV, rows that end inside a QK window, 4-bit rows of 8-120
   bytes, Nemotron-4's GQA group of 12) at phase 9's bounds, every launch at
   its head dim; C1 at the d112 prefill's K (padded to 128 by the entry
   point), bit-equal and timed; A at one row of that prefill (b1 h64 hk64
   s4032 d112 padded to 128, causal, int8) beside SDPA; D timed in every
   cache mode at b8 h64 hk64 S_max 4096 d112 (MPT-30B's decode) and b8 h96
   hk8 S_max 4096 d192 (Nemotron-4-340B's), with the byte bound and SDPA
   beside, and its T-token (T 4) and paged (pages of 64) instances at d112;
   E at d48, d112 and d192 (bits 4 and 2, causal and not) at phase 11's
   bounds, timed at b4 h32 s8192 d112 int4 beside SDPA on the dequantized
   K/V, with the wrapper's padded copy of the packed rows timed alone; F1
   w8 at the model's MLP matrices (M 8); then the model (dim 7168, 64 heads
   and 64 KV heads of 112, depth 12 of MPT-30B's 48 for the run's time
   limit, vocab 50432, random seeded parameters) at b8 from 4,032-token prompts into caches of
   4,096 rows: llm_prefill and 63 graph-decoded tokens on the int8, bf16,
   int4 and k4v8 caches and with w8 weights (every D at head dim 112, A at
   kernel dim 128; first-step logits int8 vs bf16 cache cos >= 0.999; an
   int8 decode step profiled); speculative_generate (b1, spec_k 4, int4 and
   w4 self-drafts) token-equal to generate; ServingEngine (pages of 64, 8
   slots, 8 requests of 1,024-4,032 tokens, 32 new each, int8 pages) with
   each stream equal to generate's or parting at a near-tie (phase 20's
   rule).

22. the parallel layer (parallel/ over torch.distributed): four
   rank processes (utils/parallel_cases.py, suite "card") share the card
   (cuda:0) and exchange over gloo through host memory, the kernels built
   by this process first, so no rank runs nvcc: (a) ring attention at the
   DiT shape b1 h30 s17776 d64 (4,444 tokens a rank), int8 non-causal and
   causal and k_bits=4/v_bits=8, gathered O and LSE against the
   single-process lowbit_fa_qk_int8_pv_fp16 (cos > 0.999, > 0.99 with INT4
   K; LSE within 5e-2 + 1e-2·|lse|: JAX's test_parallel.py bounds against
   its oracle); (b) Ulysses at degree 2 (15 heads a rank) over a data-2
   mesh (a CFG batch of 2), wire_bits None and 8; (c) the facade at model 2
   x ring 2; (d) context-sharded decode over 4 shards of the full-width
   LLM's 32K int8 cache (b4 h32 hk8 d128, lengths 32768/1/4097/20000:
   shards whole, partly and wholly empty; cos >= 0.99999, max|do| <= 2 bf16
   ulps of max|o|) and head-sharded decode over 4 head shards (1 ulp)
   against single-process D; (e) one CogVideoX-2b denoise step (depth 30,
   dim 1920) with ring-4 attention (b1) and one with Ulysses-2 attention (a
   CFG batch of 2 over data 2), each rank running the token-wise layers on
   its sequence shard: frames x - 0.1·eps cos >= 0.999 and eps cos >= 0.99
   against the single-process int8 step; (f) the pipelined DiT at pp 2 (15
   blocks a stage) over data 2, a CFG batch of 2 a data rank in 2
   microbatches: eps cos >= 0.999 against the sequential forward. Each
   rank's launches are counted per case from zero (A on the wgmma design,
   C1/C2 on vector, D on its design; none of another kernel), with its
   bytes on the wire per call site; a failing rank fails the phase. The
   ranks share one card, so their seconds are no scaling figure. Then, in
   this process alone, kernel A at the ring's hop shape (b1 h30 sq4444
   sk4444 d64, int8 codes, f32 output: the diagonal shard causal, an
   earlier rank's shard unmasked) beside SDPA and kernel D at the context
   shard (b4 h32 hk8 S_max 8192 d128, int8) against their plain versions,
   timed with their bounds.

23. the training paths (run last): the same four rank processes as
   phase 22's (suite "train", run after suite "card" in those processes,
   which start once for both) share the card: (a) one int8_train step of the
   CogVideoX-2b DiT at full width (dim 1920, 30 heads x 64, 17,776 tokens a
   sample; depth TRAIN_DEPTH, the width whole) sharded over data 1 x seq 2
   x model 2 at batch 2 (parallel/dryrun.py: qkv/mlp_in column-parallel
   with qkv cut by whole heads, proj/mlp_out row-parallel, K and V gathered
   over seq so each rank attends its 8,888 query rows against all 17,776
   keys, the gradients summed over data x seq), the loss and the updated
   shards gathered back whole held by rank 0 to the single-process
   sgd_train_step on the same weights, latents, t and noise at
   tests/test_torch_dit_train.py's bounds (loss within 2e-3 relative, each
   tensor that starts nonzero within one bf16 ulp of its max|p|, each
   zero-initialised bias at an update cosine >= 0.8), every rank launching
   A, C1, G1 and G2 once a block (A and G on wgmma, C1 on vector) and no
   other kernel; (b) the FSDP-sharded DiT forward (parallel/sharded.py:
   each parameter a quarter a rank, a block's tensors gathered on use) over
   data 4 at batch 4, attn_impl="int8", against the single-process forward
   of the same rows (a row at a time, as each rank runs them) within JAX's
   test_fsdp bound (|d| <= 2e-2 + 2e-2·|y|; the same bits expected and
   reported), A and C1 once a block a rank. Then, in this process alone, kernel A's int8 forward and
   G1/G2 at a rank's attention shape (b2 h15 sq8888 sk17776 d64) against
   their plain versions, timed beside SDPA and aten's flash backward, and
   kernel C1 on the gathered K (b2 h15 s17776 d64, contiguous) against its
   plain version, timed;
   (c) the toy LLM trained on the card at JAX's recipe (models/train.py:
   train_toy_llm, arith_llm_config, 3000 steps of AdamW at batch 64 x 64
   tokens, lr 1e-3): the loss must fall below 0.8x its first chunk's; then
   eval_accuracy on 128 held-out prompts through the bf16, int8, int4 and
   k4v8 caches (C1 and A prefill, D decodes, counted), every answer three
   digits, the accuracies reported beside the committed checkpoint's on the
   same prompts; the parameters saved with utils/checkpoint.save_params and
   loaded back equal.

24. the tooling (run last): tools.autotune in this process, each sweep
   timed in turns (5 rounds of 20 calls back to back between CUDA events;
   median and spread) and saved into the run's cache: kernel D's waves (0.5,
   1, 2, 4; 1 is the heuristic) for the int8, bf16, int4 and k4v8 caches at
   phase 13's decode shape (b4 h32 hk8 S_max 32768 d128), F1's (w8) and
   F2's (w4) K-split caps (1, 2, 4, 8, and 16 for w8; the largest is the
   heuristic) at phase 10's four decode shapes (M 4), then --space k and
   --space bwd at b4 h32 s4096 d64 (one row each: A and G1/G2 run one tile
   plan). Then, counted from 0, decode_attention in each cache mode under
   the saved waves (lengths 32768/1/4097/0): every launch on the tuned split
   count, against the plain version walking the same split_keys at phase
   9's bounds, the same bits twice; wq_matmul_per_channel (w8, w4) under the
   saved caps at the four shapes: every launch on the tuned K splits,
   against the plain version at phase 10's bounds, the same bits twice.
   Then tools.llm_accuracy_eval's trained ladder on the checkpoint (64
   prompts; bf16, int8, k4v8, int4 caches, the window ladder at 16 + 4
   sinks, the engine's plain and n-gram runs): each row beside the JAX
   package's CPU figure (JAX_LADDER*), none more than 1/64 below it, the
   cache rows >= 0.98, each cache and window row one generate's launches
   (A, C1 a layer, D a layer and step), every launch on its design. Then
   evalkit.perceptual's scores (SSIM, random-feature cos, band MSEs) of
   phase 5's int8, int8_v8, int4 and w8 frames against its fp frames, beside
   the frame cos; and phase 13's traces listed.
25. kernels A, D and E above head_dim 256 (up to 512) and an LLM of 8 heads
   of 512 (run last): kernel A's head_dim-512 grid of utils/mask_cases.py
   (every mode but fp32 PV at 512, and 320 and 448 padded to 512; unmasked,
   the masks' edges, the bias) against attention_fwd_plain at phase 4's
   bounds; kernel D's d272/d320/d400/d512 cases of utils/decode_cases.py,
   contiguous and paged, at phase 9's bounds; kernel E at d320 and d512,
   bits 4 and 2, at phase 11's; each the same bits twice and every launch
   at its (kernel) head dim. Timed: C1 at the prefill's K (b4 h2 s32704
   d512, the scalar design, bit-equal), A d512 in every mode at b4 h8 s4096
   (SDPA bf16 beside the fp mode, the backend it picked named) and int8 at
   the LLM's prefill shape, E d512 int4 at b4 h8 s4096 (SDPA on the
   dequantized K/V), D d512 in every cache mode at b4 h8 hk2 S_max 32768,
   its T-token row at b1 and its paged row at b8. Then the LLM (dim 4096,
   8 query heads of 512 over 2 KV heads, depth 8, random seeded weights):
   geometry_llm_phase at b4 from 32,704-token prompts (every cache and w8,
   A at kernel dim 512, D at head dim 512, C1 on the scalar design, D's
   share of a profiled decode step), llm_prefill_chunked in chunks of
   4,096 against the one-shot prefill (cos >= 0.999 int8, >= 0.995 k4v8,
   A over the cache's int8 codes and packed INT4 K against the plain
   version), phase 16's speculative path at b1 (tokens equal to generate),
   and the serving engine (8 requests, 32 new, pages of 64; phase 20's
   near-tie rule).

Then one JSON line of kernel records (each with its bound: the larger of
its bytes over 3.35 TB/s and its operations over the H100 SXM's peak for
their type, and a library call's time where one PyTorch call computes the
same function), and last ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import dataclasses
import functools
import itertools
import json
import math
import os
import statistics
import re
import shutil
import subprocess
import sys
import tempfile
import time
import traceback

import torch

REPO = os.path.dirname(os.path.abspath(__file__))
PKG = "lowbit_quant_fa2_paddle_tpu_torch"
B, H, S, D = 1, 30, 17776, 64
COS_MIN, MAX_DO, MAX_DLSE = 0.99999, 2e-2, 1e-3
STEPS = 3
# H100 SXM datasheet peaks (dense): HBM3 bytes/s and operations/s per type.
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {"bf16": 989e12, "int8": 1979e12}
# exp2 results per clock of one SM (the MUFU pipe; NVIDIA's CUDA C++
# Programming Guide, compute capability 9.0), the SMs of an H100 SXM, and
# its maximum SM clock.
EX2_PER_CLK_PER_SM, N_SMS, MAX_SM_HZ = 16, 132, 1.98e9


def log(*a):
    print(*a, flush=True)


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def bound(n_bytes, ops=None):
    """The least time (ms) the card could take and what sets it: the bytes
    moved over HBM's rate, or the operations over the peak rate of their
    type (summed over types), whichever is larger."""
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = sum(n / PEAK_OPS[kind] for kind, n in (ops or {}).items())
    return {"bound_ms": max(t_bytes, t_ops) * 1e3, "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def exp_floor_ms(pairs):
    """The least time of one exp2 per (q, k) pair on the MUFU pipe at the
    card's maximum clock."""
    return pairs / (N_SMS * EX2_PER_CLK_PER_SM * MAX_SM_HZ) * 1e3


def sm_clock_mhz():
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, timeout=60).stdout.split()
    return float(out[0]) if out else float("nan")


def bf16_ulp(x):
    return 2.0 ** (math.floor(math.log2(x)) - 7)


#: The card's name and power limit as nvidia-smi reports them (device_phase).
CARD = "not read"


def device_phase():
    global CARD
    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is False: this smoke run needs a CUDA card")
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()
    log(out[0])
    CARD = out[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"torch {torch.__version__} cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}"
        f" count {torch.cuda.device_count()}")
    return out[0]


def build_phase():
    from lowbit_quant_fa2_paddle_tpu_torch.ops import _build

    t0 = time.perf_counter()
    _build.library()
    secs = time.perf_counter() - t0
    log(f"[build] {secs:.1f} s")
    with open(_build.library_path() + ".log") as f:
        text = f.read()
    for name, spill, regs in re.findall(
        r"Function properties for (\S+)\n\s+(.*spill loads)\n.*?Used (\d+) registers", text
    ):
        log(f"[build] regs={regs:>3} {spill.strip()} {name[:90]}")
    return secs


def stats(o, o_ref, lse=None, lse_ref=None):
    from lowbit_quant_fa2_paddle_tpu_torch.ops.metrics import cosine_similarity

    r = {
        "cos": float(cosine_similarity(o, o_ref)),
        "max_do": float((o.float() - o_ref.float()).abs().max()),
        "finite": bool(torch.isfinite(o.float()).all()),
    }
    if lse is not None:
        r["max_dlse"] = float((lse - lse_ref).abs().max())
    return r


def check_close(name, r, max_dlse=MAX_DLSE):
    ok = (r["finite"] and r["cos"] >= COS_MIN and r["max_do"] <= MAX_DO and r.get("max_dlse", 0.0) <= max_dlse
          and r.get("same_bits_twice", True) and r.get("on_dim", True))
    log(f"[A] {name}: " + " ".join(f"{k}={v:.6g}" if isinstance(v, float) else f"{k}={v}" for k, v in r.items()))
    if not ok:
        raise AssertionError(f"kernel A disagrees with its plain version in case {name}: {r}")


def dit_k_view(gen, s=S, h=H, d=D):
    """K as the DiT hands it to the attention entry points: [B, H, S, hd], a
    strided view of the qkv projection [B, S, 3, H, hd] (row stride 3·H·hd)."""
    qkv = torch.randn(B, s, 3 * h * d, generator=gen, device="cuda").bfloat16().reshape(B, s, 3, h, d)
    return qkv[:, :, 1].transpose(1, 2)


def time_quant(name, tag, quant, plain, ks, gran, block, bits):
    """Kernel and plain ms of one quantizer case, alternating between two
    inputs (each larger than the L2), with GB/s and the share of the bound
    of the bytes it must move (x read once, codes and scales written once),
    and the design that ran."""
    from lowbit_quant_fa2_paddle_tpu_torch.ops import quant as qo
    from lowbit_quant_fa2_paddle_tpu_torch.utils.benchmark import cuda_time_ms

    kms = [qo.k_mean(k) for k in ks]
    turn = [0]

    def call(fn, **kw):
        turn[0] ^= 1
        return fn(ks[turn[0]], kms[turn[0]], **kw)

    pt = gran == "per_token"
    ms = cuda_time_ms(lambda: call(quant, gran=gran, block=block), warmup=4, reps=30)
    plain_ms = cuda_time_ms(lambda: call(plain, per_token=pt, block=block), warmup=1, reps=5)
    k = ks[0]
    moved = nbytes(k, kms[0]) + k.numel() * bits // 8 + k[..., 0].numel() * 4
    lim = bound(moved)
    design = qo.kernel_design(k, bits, pt, block)
    log(f"[{name}] {tag} {gran}{'' if pt else f' {block}'} ({design}): kernel {ms:.4f} ms "
        f"({moved / ms / 1e6:.0f} GB/s, {lim['bound_ms'] / ms:.0%} of bound {lim['bound_ms']:.4f} ms), "
        f"plain {plain_ms:.4f} ms")
    return {"ms": ms, "plain_ms": plain_ms, **lim, "library_ms": None, "design": design}


def quant_phase(gen):
    from lowbit_quant_fa2_paddle_tpu_torch.ops.quant import k_mean, kernel_design, quant_int8, quant_int8_plain

    worst = 0.0
    for s, gran, block, layout in [(S, "per_token", 128, "contiguous"), (S, "per_block", 64, "contiguous"),
                                   (1000, "per_token", 128, "contiguous"), (1000, "per_block", 64, "contiguous"),
                                   (S, "per_token", 128, "view"), (S, "per_block", 64, "view"),
                                   (1000, "per_block", 64, "view")]:
        if layout == "view":
            k = dit_k_view(gen, s)
        else:
            k = (torch.randn(B, H, s, D, generator=gen, device="cuda") + 0.5).bfloat16()
        km = k_mean(k)
        n = quant_int8.launches_by_design["vector"]
        codes, scale = quant_int8(k, km, gran=gran, block=block)
        want_c, want_s = quant_int8_plain(k, km, per_token=gran == "per_token", block=block)
        torch.cuda.synchronize()
        dc = int((codes.int() - want_c.int()).abs().max())
        ds = float((scale - want_s).abs().max())
        worst = max(worst, dc, ds)
        on_vector = quant_int8.launches_by_design["vector"] == n + 1
        log(f"[C1] s{s} {gran} {layout} K: codes_equal={torch.equal(codes, want_c)} "
            f"scales_equal={torch.equal(scale, want_s)} vector={on_vector}")
        if not (torch.equal(codes, want_c) and torch.equal(scale, want_s) and on_vector):
            raise AssertionError(f"kernel C1 differs from its plain version (or left the vector design) at s{s} "
                                 f"{gran} {layout}: {dc} {ds}")
    # The LLM prefill's K: b4, 8 KV heads, 32,704 tokens, d128, per token.
    k = (torch.randn(4, 8, 32704, 128, generator=gen, device="cuda") + 0.5).bfloat16()
    km = k_mean(k)
    codes, scale = quant_int8(k, km, gran="per_token")
    want_c, want_s = quant_int8_plain(k, km, per_token=True, block=128)
    torch.cuda.synchronize()
    log(f"[C1] LLM prefill K b4 h8 s32704 d128 per_token ({kernel_design(k, 8, True, 128)}): "
        f"codes_equal={torch.equal(codes, want_c)} scales_equal={torch.equal(scale, want_s)}")
    if not (torch.equal(codes, want_c) and torch.equal(scale, want_s)):
        raise AssertionError("kernel C1 differs from its plain version at the LLM prefill K shape")
    del k, km, codes, scale, want_c, want_s
    recs = {}
    for tag, shape, layout, gran, block in [
            ("view", (B, H, S, D), "view", "per_token", 128),
            ("contiguous", (B, H, S, D), "contiguous", "per_token", 128),
            ("prefill", (4, 8, 32704, 128), "contiguous", "per_token", 128),
            ("block64", (B, H, S, D), "contiguous", "per_block", 64)]:
        ks = [dit_k_view(gen) if layout == "view" else torch.randn(*shape, generator=gen, device="cuda").bfloat16()
              for _ in range(2)]
        recs[tag] = {"max_abs_err": worst, **time_quant(
            "C1", f"b{shape[0]} h{shape[1]} s{shape[2]} d{shape[3]} {layout} K", quant_int8, quant_int8_plain, ks,
            gran, block, 8)}
        del ks
        torch.cuda.empty_cache()
    # k_mean on the DiT's K view: one read of K, no f32 copy.
    from lowbit_quant_fa2_paddle_tpu_torch.utils.benchmark import cuda_time_ms

    ks = [dit_k_view(gen) for _ in range(2)]
    turn = [0]

    def km_call():
        turn[0] ^= 1
        return k_mean(ks[turn[0]])

    ms = cuda_time_ms(km_call, warmup=4, reps=30)
    lim = bound(ks[0].numel() * 2 + B * H * D * 4)
    log(f"[k_mean] DiT K view b{B} h{H} s{S} d{D}: {ms:.4f} ms ({lim['bound_ms'] / ms:.0%} of bound "
        f"{lim['bound_ms']:.4f} ms)")
    recs["k_mean_ms"] = ms
    return recs


def lowbit_quant_phase(gen):
    from lowbit_quant_fa2_paddle_tpu_torch.ops import quant as qo

    records = {}
    for bits, quant, plain in ((4, qo.quant_int4, qo.quant_int4_plain), (2, qo.quant_int2, qo.quant_int2_plain)):
        name, worst = f"C{2 if bits == 4 else 3}", 0.0
        cases = [(S, D, "per_token", 128, "contiguous"), (S, D, "per_block", 64, "contiguous"),
                 (1000, D, "per_token", 128, "contiguous"), (1000, D, "per_block", 64, "contiguous"),
                 (1000, 128, "per_token", 128, "contiguous"), (1000, 128, "per_block", 64, "contiguous")]
        cases += [(S, D, "per_token", 128, "view"), (1000, D, "per_block", 64, "view")]
        if bits == 2:
            cases += [(S, D, "per_block", 64, "view")]
        for s, d, gran, block, layout in cases:
            if layout == "view":
                k = dit_k_view(gen, s, d=d)
            else:
                k = (torch.randn(B, H, s, d, generator=gen, device="cuda") + 0.5).bfloat16()
            km = qo.k_mean(k)
            n = dict(quant.launches_by_design)
            codes, scale = quant(k, km, gran=gran, block=block)
            want_c, want_s = plain(k, km, per_token=gran == "per_token", block=block)
            torch.cuda.synchronize()
            ulps = int((scale.view(torch.int32).long() - want_s.view(torch.int32).long()).abs().max())
            worst = max(worst, float((scale - want_s).abs().max()))
            on_vector = quant.launches_by_design["vector"] == n["vector"] + 1
            ok = torch.equal(codes, want_c) and ulps == 0 and on_vector
            log(f"[{name}] s{s} d{d} {gran} {layout} K: codes_equal={torch.equal(codes, want_c)} "
                f"scale_ulps={ulps} vector={on_vector}")
            if not ok:
                raise AssertionError(f"kernel {name} differs from its plain version at s{s} d{d} {gran} {layout}")
        timed_cases = [("view", "per_token"), ("contiguous", "per_token")]
        if bits == 2:
            timed_cases.append(("contiguous", "per_block"))
        for layout, gran in timed_cases:
            ks = [dit_k_view(gen) if layout == "view" else torch.randn(B, H, S, D, generator=gen, device="cuda")
                  .bfloat16() for _ in range(2)]
            rec = time_quant(name, f"b{B} h{H} s{S} d{D} {layout} K", quant, plain, ks, gran, 64, bits)
            records[(bits, layout if gran == "per_token" else "block64")] = {"max_abs_err": worst, **rec}
            del ks
    return records


def attn_inputs(gen, h, hk, s, d, mode, causal=False, smooth_v=False, dtype=torch.bfloat16):
    from lowbit_quant_fa2_paddle_tpu_torch.ops.attention import LOG2E
    from lowbit_quant_fa2_paddle_tpu_torch.ops.quant import k_mean, quant_int8

    q = torch.randn(1, h, s, d, generator=gen, device="cuda").to(dtype)
    k = (torch.randn(1, hk, s, d, generator=gen, device="cuda") + 0.3).to(dtype)
    v = torch.randn(1, hk, s, d, generator=gen, device="cuda").to(dtype)
    vm = torch.randn(1, hk, d, generator=gen, device="cuda") if smooth_v else None
    c = 1.0 / math.sqrt(d) * LOG2E
    q_scale = k_scale = qs = None
    if mode != "fp":
        k, k_scale = quant_int8(k, k_mean(k), gran="per_token")
    if mode == "int8":
        q, q_scale = quant_int8(q, gran="per_token")
        qs = q_scale * torch.tensor(c, dtype=torch.float32, device="cuda")
    kernel_args = (q, k, v, q_scale, k_scale)
    plain_args = (q, k, v, qs, k_scale, vm)
    return kernel_args, plain_args, dict(v_mean=vm, is_causal=causal), c


def attention_phase(gen):
    from lowbit_quant_fa2_paddle_tpu_torch.ops.attention import attention_fwd_plain, lowbit_attention

    cases = [
        ("int8 fused-Q", dict(h=8, hk=8, s=2048, d=64, mode="fused")),
        ("int8 external-Q", dict(h=8, hk=8, s=2048, d=64, mode="int8")),
        ("fp", dict(h=8, hk=8, s=2048, d=64, mode="fp")),
        ("int8 causal", dict(h=8, hk=8, s=2048, d=64, mode="fused", causal=True)),
        ("fp causal", dict(h=8, hk=8, s=2048, d=64, mode="fp", causal=True)),
        ("int8 GQA 8q/2kv", dict(h=8, hk=2, s=2048, d=64, mode="fused")),
        ("int8 d128", dict(h=8, hk=8, s=2048, d=128, mode="fused")),
        ("fp d128 causal", dict(h=8, hk=4, s=1500, d=128, mode="fp", causal=True)),
        ("int8 ragged s1000", dict(h=8, hk=8, s=1000, d=64, mode="int8")),
        ("int8 smooth-V", dict(h=8, hk=8, s=1000, d=64, mode="fused", smooth_v=True)),
        # The checkpoint's prefill: f32, d32 padded to 64 by the API.
        ("int8 causal GQA 8q/2kv d64 s36 f32", dict(h=8, hk=2, s=36, d=64, mode="fused", causal=True,
                                                    dtype=torch.float32)),
    ]
    for name, kw in cases:
        kargs, pargs, opts, c = attn_inputs(gen, **kw)
        o, lse = lowbit_attention(*kargs, **opts, return_lse=True)
        o_ref, lse_ref = attention_fwd_plain(*pargs, causal=opts["is_causal"], sm_scale_log2e=c,
                                             out_dtype=torch.bfloat16)
        torch.cuda.synchronize()
        check_close(name, stats(o, o_ref, lse, lse_ref))
        if name == "int8 fused-Q":  # the no-LSE launch writes the same output
            o2 = lowbit_attention(*kargs, **opts)
            if not torch.equal(o2, o):
                raise AssertionError("kernel A output differs with return_lse=False")
            log("[A] return_lse=False: output identical")
    return {f"{mode} {shape}": time_attention(gen, mode, *A_SHAPES[shape], plain_reps=3 if shape == "dit" else 1)
            for shape in A_SHAPES for mode in ("fused", "fp")}


# The shapes kernel A is timed at: the DiT's (b1 h30 s17776 d64) and one
# batch row of the LLM prefill's (causal GQA 32q/8kv d128 s32704).
A_SHAPES = {"dit": (H, H, S, D, False), "prefill": (32, 8, 32704, 128, True)}


def time_attention(gen, mode, h, hk, s, d, causal, plain_reps=1):
    """Kernel A (``mode`` "fused": int8 with Q quantized in the kernel, or
    "fp") at b1 ``h``/``hk`` heads, ``s`` rows of ``d`` (padded to the
    kernel's head dim by the entry point): the same bits twice, held to its
    plain version at phase 4's bounds, then timed beside the plain version
    and SDPA in bf16."""
    from lowbit_quant_fa2_paddle_tpu_torch.ops.attention import (attention_fwd_plain, kernel_design, kernel_dim,
                                                                 lowbit_attention)
    from lowbit_quant_fa2_paddle_tpu_torch.utils.benchmark import attention_flops, cuda_time_ms, tflops

    name = f"{mode} b1 h{h} hk{hk} s{s} d{d}{' causal' if causal else ''}"
    kargs, pargs, opts, c = attn_inputs(gen, h, hk, s, d, mode, causal=causal)
    n = lowbit_attention.launches_by_dim[kernel_dim(d)]
    o, lse = lowbit_attention(*kargs, **opts, return_lse=True)
    o2, lse2 = lowbit_attention(*kargs, **opts, return_lse=True)

    def plain():
        return attention_fwd_plain(*pargs, causal=causal, sm_scale_log2e=c, out_dtype=torch.bfloat16)

    o_ref, lse_ref = plain()
    torch.cuda.synchronize()
    r = stats(o, o_ref, lse, lse_ref)
    r["same_bits_twice"] = torch.equal(o, o2) and torch.equal(lse, lse2)
    r["on_dim"] = lowbit_attention.launches_by_dim[kernel_dim(d)] == n + 2
    check_close(name, r)
    del o, lse, o2, lse2, o_ref, lse_ref
    ms = cuda_time_ms(lambda: lowbit_attention(*kargs, **opts), warmup=2, reps=10)
    mhz = sm_clock_mhz()
    plain_ms = cuda_time_ms(plain, warmup=1, reps=plain_reps)
    flops = attention_flops(1, h, d, s, s, causal)
    pairs = h * (s * (s + 1) // 2 if causal else s * s)
    q_, k_, v_, _, ks_ = kargs
    # int8: QK^T on int8 codes, PV in bf16; fp: both products in bf16.
    ops = {"int8": flops // 2, "bf16": flops // 2} if mode == "fused" else {"bf16": flops}
    lim = bound(nbytes(q_, k_, v_, ks_) + h * s * d * 2, ops)
    del kargs, pargs
    # Baseline only (a library kernel, not the port): SDPA in bf16, GQA as the kernel runs it.
    q, k, v = (torch.randn(1, n, s, d, generator=gen, device="cuda").bfloat16() for n in (h, hk, hk))
    sdpa_ms = cuda_time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        q, k, v, is_causal=causal, enable_gqa=hk != h), warmup=2, reps=10)
    del q, k, v
    tf, floor = tflops(flops, ms / 1e3), exp_floor_ms(pairs)
    log(f"[A] {name} ({kernel_design()}): kernel {ms:.3f} ms ({tf:.1f} TFLOP/s) at SM clock {mhz:.0f} MHz, "
        f"plain {plain_ms:.3f} ms, bound {lim['bound_ms']:.3f} ms ({lim['bound_by']}), exp2 floor {floor:.3f} ms, "
        f"SDPA bf16 {sdpa_ms:.3f} ms ({tflops(flops, sdpa_ms / 1e3):.1f} TFLOP/s)")
    return {"max_abs_err": r["max_do"], "ms": ms, "plain_ms": plain_ms, "tflops": tf, **lim,
            # SDPA computes the fp mode's function; the int8 mode's has no library call.
            "library_ms": sdpa_ms if mode == "fp" else None, "sdpa_ms": sdpa_ms, "exp_floor_ms": floor,
            "sm_mhz": mhz, "design": kernel_design()}


LOWBIT_MODES = {"int4-K": (4, "bf16"), "int2-K": (2, "bf16"), "int8-V": (8, "int8"), "int8-PV": (8, "int8_pv")}


def lowbit_attn_inputs(gen, mode, h, hk, s, d):
    """Float Q (quantized in the kernel), K codes with the K mean taken out,
    and bf16 V or smooth-V per-channel INT8 V codes, for a low-bit mode."""
    from lowbit_quant_fa2_paddle_tpu_torch.ops import quant as qo

    k_bits, v_mode = LOWBIT_MODES[mode]
    q = torch.randn(1, h, s, d, generator=gen, device="cuda").bfloat16()
    k = (torch.randn(1, hk, s, d, generator=gen, device="cuda") + 0.3).bfloat16()
    v = torch.randn(1, hk, s, d, generator=gen, device="cuda").bfloat16()
    quant = {8: qo.quant_int8, 4: qo.quant_int4, 2: qo.quant_int2}[k_bits]
    kc, ks = quant(k, qo.k_mean(k), gran="per_token")
    vs = vm = None
    if v_mode != "bf16":
        v, vs, vm = qo.quant_v_int8_per_channel(v, smooth_v=True)
    kw = dict(v_scale=vs, v_mean=vm, pv_int8=v_mode == "int8_pv")
    return (q, kc, v, None, ks), dict(k_pack_bits=k_bits, **kw), dict(k_bits=k_bits, **kw)


def lowbit_attention_phase(gen):
    from lowbit_quant_fa2_paddle_tpu_torch.ops.attention import (
        LOG2E,
        attention_fwd_plain,
        kernel_design,
        lowbit_attention,
    )
    from lowbit_quant_fa2_paddle_tpu_torch.utils.benchmark import attention_flops, cuda_time_ms, tflops

    records = {}
    for mode, (_, v_mode) in LOWBIT_MODES.items():
        for case, (h, hk, s, d, causal) in [("b1 h30 s17776 d64", (H, H, S, D, False)),
                                            ("causal GQA 8q/2kv d128 s2048", (8, 2, 2048, 128, True)),
                                            ("ragged s1000", (8, 8, 1000, D, False))]:
            args, kw, pkw = lowbit_attn_inputs(gen, mode, h, hk, s, d)
            o, lse = lowbit_attention(*args, **kw, is_causal=causal, return_lse=True)
            c = 1.0 / math.sqrt(d) * LOG2E
            pargs = args[:5] + (pkw.pop("v_mean"),)

            def plain():
                return attention_fwd_plain(*pargs, causal=causal, sm_scale_log2e=c, out_dtype=torch.bfloat16, **pkw)

            o_ref, lse_ref = plain()
            torch.cuda.synchronize()
            r = stats(o, o_ref, lse, lse_ref)
            check_close(f"{mode} {case}", r)
            if case == "ragged s1000":  # the no-LSE launch writes the same output
                if not torch.equal(lowbit_attention(*args, **kw, is_causal=causal), o):
                    raise AssertionError(f"kernel A ({mode}) output differs with return_lse=False")
                log(f"[A] {mode} return_lse=False: output identical")
            if case.startswith("b1 h30"):
                del o_ref, lse_ref
                ms = cuda_time_ms(lambda: lowbit_attention(*args, **kw), warmup=2, reps=10)
                plain_ms = cuda_time_ms(plain, warmup=1, reps=3)
                flops = attention_flops(B, H, D, S, S, False)
                tf = tflops(flops, ms / 1e3)
                ops = {"int8": flops} if mode == "int8-PV" else {"int8": flops // 2, "bf16": flops // 2}
                lim = bound(nbytes(*args, kw["v_scale"], kw["v_mean"]) + B * H * S * D * 2, ops)
                log(f"[A] {mode} b{B} h{H} s{S} d{D}: kernel {ms:.3f} ms ({tf:.1f} TFLOP/s), plain {plain_ms:.3f} ms, "
                    f"bound {lim['bound_ms']:.3f} ms")
                records[mode] = {"max_abs_err": r["max_do"], "ms": ms, "plain_ms": plain_ms, "tflops": tf, **lim,
                                 "library_ms": None, "exp_floor_ms": exp_floor_ms(H * S * S),
                                 "design": kernel_design(v_mode == "int8_pv")}
            else:
                records[mode]["max_abs_err"] = max(records[mode]["max_abs_err"], r["max_do"])
            del args, o, lse
    records["int8-PV"]["max_abs_err"] = max(records["int8-PV"]["max_abs_err"], pv_int8_edges(gen))
    return records


# INT8 PV's edges on the wgmma design: (k bits, q mode, causal, h, hk, d, sq, sk).
# With bf16 QK (k bits 16) the kernel sums the logits in another order than
# the plain version, which can move an exponent argument across one bf16 step
# (2^-5 near the top) and so one p8 by at most 127 * (2^(1/32) - 1) = 2.8
# codes: the row's LSE moves by log2(1 + dl / l), l its sum of p8 codes
# (script/torch_pv8_lse.py: 20 draws, |dl| at most 2). Such a row is held to
# |dl| <= PV8_MAX_DL codes where its |dlse| exceeds 1e-3; the int8-QK edges
# (exact logits) keep 1e-3.
PV8_EDGES = {"sk777": (8, "fused", False, 8, 8, 64, 300, 777),
             "causal sq700 sk1000 d128": (8, "fused", True, 8, 2, 128, 700, 1000),
             "causal GQA 32q/8kv d128 s777": (8, "fused", True, 32, 8, 128, 777, 777),
             "int4-K d64 sk777": (4, "fused", False, 8, 2, 64, 500, 777),
             "bf16 QK d64 s1000": (16, "fp", True, 8, 8, 64, 1000, 1000)}
PV8_MAX_DL = 3.0


def pv8_code_shift(q, k, lse, lse_ref, causal, c):
    """The change in each row's sum of p8 codes that its LSE gap means, with
    bf16 QK: l = 127 * 2^(lse_ref - m), m the row's largest logit as the
    plain version forms it, and dl = l * (2^dlse - 1)."""
    h, sq, sk = q.shape[1], q.shape[2], k.shape[2]
    kf = k.bfloat16().float().repeat_interleave(h // k.shape[1], dim=1)
    s = (q.bfloat16().float() @ kf.transpose(-1, -2)) * c
    if causal:
        s = s.masked_fill(torch.ones(sq, sk, dtype=torch.bool, device=s.device).triu(1), -float("inf"))
    l_ref = 127.0 * torch.exp2((lse_ref - s.amax(dim=-1)).double())
    return l_ref * (torch.exp2((lse - lse_ref).double()) - 1.0)


def pv_int8_edges(gen):
    """Kernel A's INT8 PV at the edges of its design against the plain
    version (phase 4's bounds), the same bits twice, every launch on the
    wgmma design. Returns the largest max|do|."""
    from lowbit_quant_fa2_paddle_tpu_torch.ops import quant as qo
    from lowbit_quant_fa2_paddle_tpu_torch.ops.attention import LOG2E, attention_fwd_plain, lowbit_attention

    worst = 0.0
    for name, (k_bits, q_mode, causal, h, hk, d, sq, sk) in PV8_EDGES.items():
        q = torch.randn(1, h, sq, d, generator=gen, device="cuda").bfloat16()
        k = (torch.randn(1, hk, sk, d, generator=gen, device="cuda") + 0.3).bfloat16()
        v8, vs, vm = qo.quant_v_int8_per_channel(torch.randn(1, hk, sk, d, generator=gen, device="cuda").bfloat16(),
                                                 smooth_v=True)
        ks = None
        if q_mode != "fp":
            k, ks = {8: qo.quant_int8, 4: qo.quant_int4}[k_bits](k, qo.k_mean(k), gran="per_token")
        kb = 8 if k_bits == 16 else k_bits
        kw = dict(v_scale=vs, v_mean=vm, pv_int8=True, is_causal=causal, k_pack_bits=kb, return_lse=True)
        n = lowbit_attention.launches_by_design["wgmma"]
        (o, lse), (o2, lse2) = (lowbit_attention(q, k, v8, None, ks, **kw) for _ in range(2))
        o_ref, lse_ref = attention_fwd_plain(q, k, v8, None, ks, vm, causal=causal, sm_scale_log2e=LOG2E / math.sqrt(d),
                                             out_dtype=torch.bfloat16, k_bits=kb, v_scale=vs, pv_int8=True)
        torch.cuda.synchronize()
        same = torch.equal(o, o2) and torch.equal(lse, lse2)
        on_design = lowbit_attention.launches_by_design["wgmma"] == n + 2
        r = stats(o, o_ref, lse, lse_ref)
        max_dlse = MAX_DLSE
        if q_mode == "fp":
            dl = pv8_code_shift(q, k, lse, lse_ref, causal, LOG2E / math.sqrt(d))
            over = ((lse - lse_ref).abs() > MAX_DLSE) & (dl.abs() > PV8_MAX_DL)
            r.update(max_abs_dl=float(dl.abs().max()), rows_over_bound=int(over.sum()))
            max_dlse = math.inf if not bool(over.any()) else MAX_DLSE
        check_close(f"int8-PV edge {name} same_bits_twice={same} wgmma:{on_design}", r, max_dlse)
        if not (same and on_design):
            raise AssertionError(f"kernel A INT8 PV edge {name}: same bits {same}, on the wgmma design {on_design}")
        worst = max(worst, r["max_do"])
    return worst


def entry_point_phase(gen):
    """The slice's entry points at the flagship shape: lowbit_fa_attn with
    bits="int2", "auto" (which picks int4 for unit-normal tensors) and
    "int8_v8" with pv_int8, each run with the counters set to 0 just before
    it. Each output must be finite and track the fp baseline: INT2 K
    perturbs each logit with noise of ~0.45 (natural log), which caps the
    output cosine near exp(-0.45^2 / 2) = 0.90 at any length (bound 0.85);
    INT4 K (bound 0.98); INT8 PV rounds every P to an integer of [0, 127],
    an error of ~1/24 of the signal at 17,776 unit-normal keys (bound
    0.99)."""
    import lowbit_quant_fa2_paddle_tpu_torch as lq
    from lowbit_quant_fa2_paddle_tpu_torch.ops.metrics import cosine_similarity

    q, k, v = (torch.randn(B, H, S, D, generator=gen, device="cuda").bfloat16() for _ in range(3))
    o_fp = lq.lowbit_fa_attn(q, k, v, bits="fp")
    runs = {}
    for name, kw, want, cos_min in [
        ("int2", dict(bits="int2"), {"A": 1, "C1": 0, "C2": 0, "C3": 1}, 0.85),
        ("auto", dict(bits="auto"), {"A": 1, "C1": 0, "C2": 1, "C3": 0}, 0.98),
        ("int8_v8 pv_int8", dict(bits="int8_v8", pv_int8=True), {"A": 1, "C1": 1, "C2": 0, "C3": 0}, 0.99),
    ]:
        count_reset()
        o = lq.lowbit_fa_attn(q, k, v, **kw)
        torch.cuda.synchronize()
        got, designs = counts(), design_counts()
        got = {key: got[key] for key in want}
        # Every quantizer launch on the vector design (K contiguous, d64).
        c_designs = {key: design_counts(key) for key in ("C1", "C2", "C3")}
        c_want = {key: {"vector": want[key], "scalar": 0} for key in c_designs}
        cos = float(cosine_similarity(o, o_fp))
        finite = bool(torch.isfinite(o.float()).all())
        log(f"[api] lowbit_fa_attn({', '.join(f'{a}={b!r}' for a, b in kw.items())}) b{B} h{H} s{S} d{D}: "
            f"launches {got} (want {want}), kernel A by design {designs}, quantizers by design {c_designs}, "
            f"cos vs fp {cos:.6f}, finite={finite}")
        if (got != want or designs != {"wgmma": want["A"]} or c_designs != c_want or not finite
                or tuple(o.shape) != (B, H, S, D) or cos < cos_min):
            raise AssertionError(f"entry point {name}: launches {got}, {designs}, {c_designs}, cos {cos}, "
                                 f"finite {finite}")
        runs[name] = got
    return runs


DIT_IMPLS = ("int8", "int8_v8", "int4", "fp")
#: The Chrome trace profile_classes wrote last (with a trace_dir).
PROFILED = {"trace": None}
GEMM_NAMES = ("gemm", "gemv", "xmma", "nvjet", "cutlass", "splitk")
#: The port's gemv kernels (F1/F2), which GEMM_NAMES would also take.
F_NAMES = ("::gemv_kernel", "::gemv_tc_kernel", "::gemv_w8_kernel", "::gemv_w8_direct_kernel")


def profile_classes(fn, classes, ranges=(), trace_dir=None):
    """Runs ``fn`` once under torch.profiler and sums its kernels' device ms
    by class: ``classes`` maps a class to the pieces of a lower-case kernel
    name that put a kernel in it (the first class that matches takes it;
    no match: "other"). Each name in ``ranges`` is a record_function range
    that ``fn`` opens; its entry is the device ms of the kernels launched
    inside it, which their classes count as well. With ``trace_dir`` the
    session is the port's ``utils.profiling.trace``, which writes a Chrome
    trace there (the path: ``PROFILED["trace"]``). Returns (ms by class and
    range, kernels by class, the "other" kernels as (ms, count, name),
    largest first)."""
    from lowbit_quant_fa2_paddle_tpu_torch.utils import profiling

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    session = profiling.trace(trace_dir) if trace_dir else torch.profiler.profile(activities=acts)
    with session as prof:
        fn()
        torch.cuda.synchronize()
    PROFILED["trace"] = getattr(prof, "trace_path", None)
    keys = list(classes) + ["other"]
    ms, n, other = dict.fromkeys(keys + list(ranges), 0.0), dict.fromkeys(keys, 0), []
    for e in prof.key_averages():
        if e.key in ranges:
            # The range's CPU entry sums the kernels launched inside it.
            if e.device_type == torch.autograd.DeviceType.CPU:
                ms[e.key] += e.device_time_total / 1e3
            continue
        # Kernels only: a CPU op's entry repeats its kernels' device time.
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        name = e.key.lower()
        key = next((c for c, pieces in classes.items() if any(piece in name for piece in pieces)), "other")
        ms[key] += e.device_time_total / 1e3
        n[key] += e.count
        if key == "other":
            other.append((e.device_time_total / 1e3, e.count, e.key[:70]))
    return ms, n, sorted(other, reverse=True)


def dit_step_profile(model, x, t, impl):
    """Device ms and kernel counts of one denoise step by class, from the
    kernel events of torch.profiler: A, C1/C2, PyTorch's copy kernels (casts,
    ``.contiguous()``, the output transpose), its mean kernels (``k_mean``,
    LayerNorm's statistics), the dense GEMMs (cuBLAS) and the rest; with the
    rest's largest kernels. Runs under the caller's inference mode."""
    from lowbit_quant_fa2_paddle_tpu_torch.models import dit

    cats, n, other = profile_classes(
        lambda: dit.dit_forward(model, x, t, attn_impl=impl),
        {"A": ("attn_fwd",), "C1/C2": ("quant_per",), "copy": ("copy",), "mean": ("meanops",), "GEMM": GEMM_NAMES})
    top = ", ".join(f"{name} x{c} {ms:.2f}" for ms, c, name in other[:4])
    return cats, n, top


def main_path_phase():
    from lowbit_quant_fa2_paddle_tpu_torch.evalkit.perceptual import latent_to_frames
    from lowbit_quant_fa2_paddle_tpu_torch.models import dit
    from lowbit_quant_fa2_paddle_tpu_torch.ops.metrics import cosine_similarity, mse

    cfg = dit.cogvideox_2b_config()
    gen = torch.Generator(device="cuda").manual_seed(0)
    t0 = time.perf_counter()
    model = dit.init_dit_params(cfg, gen)
    n_params = sum(p.numel() for p in model.parameters())
    x0 = torch.randn(1, S, cfg.dim, generator=gen, device="cuda").to(cfg.dtype)
    torch.cuda.synchronize()
    log(f"[dit] cogvideox_2b dim {cfg.dim} depth {cfg.depth} heads {cfg.num_heads}x{cfg.head_dim}: "
        f"{n_params / 1e9:.3f} B params, init {time.perf_counter() - t0:.1f} s")
    ts = [torch.tensor([1000.0 * (1.0 - i / STEPS)], device="cuda") for i in range(STEPS)]

    with torch.inference_mode():
        for impl in DIT_IMPLS:  # warm-up, outside the counted runs
            dit.dit_forward(model, x0, ts[0], attn_impl=impl)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        frames, step_ms, launches, eps0, designs = {}, {}, {}, {}, {}
        for impl in DIT_IMPLS:
            x = x0
            times = []
            count_reset()
            for i, t in enumerate(ts):
                t1 = time.perf_counter()
                eps = dit.dit_forward(model, x, t, attn_impl=impl)
                x = x - 0.1 * eps
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t1) * 1e3)
                if i == 0:
                    eps0[impl] = eps.float()
            launches[impl] = counts()
            designs[impl] = {name: design_counts(name) for name in ("A", "C1", "C2")}
            frames[impl], step_ms[impl] = x.float(), times
        peak = torch.cuda.max_memory_allocated()
        # One int8 step under torch.profiler: where the device time goes.
        prof_ms, prof_n, prof_top = dit_step_profile(model, x0, ts[0], "int8")
    want_n = cfg.depth * STEPS
    res = {"launches": launches, "ms_per_step": step_ms, "peak_gib": peak / 2**30, "frame_cos": {}, "eps_cos": {},
           "profile": {"ms": prof_ms, "kernels": prof_n}}
    for impl in DIT_IMPLS:
        log(f"[dit] {impl}: ms/step " + ", ".join(f"{t:.1f}" for t in step_ms[impl]))
    log(f"[dit] peak memory {peak / 2**30:.2f} GiB")
    log("[dit] int8 step device ms (profiler): " + ", ".join(f"{k} {v:.3f}" for k, v in prof_ms.items())
        + f"; total {sum(prof_ms.values()):.3f}; kernels {prof_n}; largest other: {prof_top}")
    if not all(bool(torch.isfinite(f).all()) for f in frames.values()):
        raise AssertionError("non-finite DiT frames")
    eps_min = {"int8": 0.98, "int8_v8": 0.99, "int4": 0.98}
    for impl in DIT_IMPLS[:-1]:
        cos = float(cosine_similarity(frames[impl], frames["fp"]))
        err = float(mse(frames[impl], frames["fp"]))
        eps_cos = float(cosine_similarity(eps0[impl], eps0["fp"]))
        res["frame_cos"][impl], res["eps_cos"][impl] = cos, eps_cos
        log(f"[dit] {impl} vs fp: frame cos {cos:.6f} mse {err:.3e}; first-step eps cos {eps_cos:.6f}")
        if cos < 0.999 or eps_cos < eps_min[impl]:
            raise AssertionError(f"{impl} vs fp: frame cos {cos} (>= 0.999), eps cos {eps_cos} (>= {eps_min[impl]})")
    for impl in DIT_IMPLS:
        want = {"A": want_n, "C1": want_n if impl in ("int8", "int8_v8") else 0,
                "C2": want_n if impl == "int4" else 0, "C3": 0, "D": 0, "E": 0, "F1": 0, "F2": 0, "G1": 0, "G2": 0}
        # Every A launch on the wgmma design, every C1/C2 launch on the vector design.
        want_designs = {"A": {"wgmma": want_n}, "C1": {"vector": want["C1"], "scalar": 0},
                        "C2": {"vector": want["C2"], "scalar": 0}}
        log(f"[dit] {impl} launches {launches[impl]} (want {want}), by design {designs[impl]}")
        if launches[impl] != want or designs[impl] != want_designs:
            raise AssertionError(f"DiT {impl}: launch counts {launches[impl]} != {want} or {designs[impl]}")

    # Per-channel w8 weights with int8 attention, one step counted: 17,776
    # rows take the dequantize-once dense route, so no F kernel runs. Then
    # its other steps, for its frames (phase 24's perceptual scores).
    qmodel = dit.quantize_dit_params(model, bits=8)
    with torch.inference_mode():
        dit.dit_forward(qmodel, x0, ts[0], attn_impl="int8")  # warm-up
        torch.cuda.synchronize()
        count_reset()
        t1 = time.perf_counter()
        eps = dit.dit_forward(qmodel, x0, ts[0], attn_impl="int8")
        torch.cuda.synchronize()
        w8_ms = (time.perf_counter() - t1) * 1e3
        got, got_c1 = counts(), design_counts("C1")
        x = x0 - 0.1 * eps
        for t in ts[1:]:
            x = x - 0.1 * dit.dit_forward(qmodel, x, t, attn_impl="int8")
        frames["w8"] = x.float()
    # The frames evalkit's perceptual scorers read (4 channel planes of the
    # 101 x 176 token grid), kept on the host for phase 24.
    res["frames"] = {impl: latent_to_frames(f[..., :4].cpu().numpy()) for impl, f in frames.items()}
    res["frame_cos"]["w8"] = float(cosine_similarity(frames["w8"], frames["fp"]))
    log(f"[dit] w8 weights + int8 attention vs fp after {STEPS} steps: frame cos {res['frame_cos']['w8']:.6f}")
    del frames
    cos = float(cosine_similarity(eps.float(), eps0["int8"]))
    want = {"A": cfg.depth, "C1": cfg.depth, "C2": 0, "C3": 0, "D": 0, "E": 0, "F1": 0, "F2": 0, "G1": 0, "G2": 0}
    log(f"[dit] w8 weights + int8 attention: {w8_ms:.1f} ms/step, eps cos vs dense weights {cos:.6f}, "
        f"finite={bool(torch.isfinite(eps.float()).all())}, launches {got} (want {want}), C1 by design {got_c1}")
    if (cos < 0.99 or got != want or got_c1 != {"vector": cfg.depth, "scalar": 0}
            or not bool(torch.isfinite(eps.float()).all())):
        raise AssertionError(f"DiT w8 step: eps cos {cos} (>= 0.99), launches {got} != {want} or {got_c1}")
    res["w8"] = {"ms_per_step": w8_ms, "eps_cos": cos}
    return res


# ---------------------------------------------------------------------------
# Kernels G1/G2 (FA-2 backward) and DiT training
# ---------------------------------------------------------------------------


def bwd_inputs(gen, h, hk, s, d, causal, window, dtype, sk=None, b=1):
    """q, k, v, dO (Sq = s, Sk = sk or s, batch b) and the forward's o and
    base-2 LSE (kernel A; the dense reference for the window, which A does
    not take yet)."""
    from lowbit_quant_fa2_paddle_tpu_torch.ops.attention import LOG2E, flash_attention_fp
    from lowbit_quant_fa2_paddle_tpu_torch.ops.reference import attention_reference

    sk = sk or s
    q = torch.randn(b, h, s, d, generator=gen, device="cuda").to(dtype)
    k = (torch.randn(b, hk, sk, d, generator=gen, device="cuda") + 0.3).to(dtype)
    v = torch.randn(b, hk, sk, d, generator=gen, device="cuda").to(dtype)
    do = torch.randn(b, h, s, d, generator=gen, device="cuda").to(dtype)
    if window:
        o, lse = attention_reference(q, k, v, is_causal=causal, window_size=window, return_lse=True)
        lse2 = lse * LOG2E
    else:
        o, lse2 = flash_attention_fp(q, k, v, is_causal=causal, return_lse=True)
    return q, k, v, o.to(dtype), lse2, do


def check_bwd(name, got, want):
    """Kernel vs plain: p and ds round to bf16 in both, so they differ in
    summation order only (and a bf16 rounding of p or ds that this flips):
    cos >= 0.99999 per gradient and max|d| <= 2 bf16 ulps of its max|.|."""
    worst = 0.0
    for grad, a, b in zip(("dq", "dk", "dv"), got, want):
        r = stats(a, b)
        tol = 2 * bf16_ulp(float(b.float().abs().max()))
        log(f"[G] {name} {grad}: cos={r['cos']:.7f} max_d={r['max_do']:.4g} (bound {tol:.3g}) finite={r['finite']}")
        if not (r["finite"] and r["cos"] >= COS_MIN and r["max_do"] <= tol and a.dtype == b.dtype):
            raise AssertionError(f"kernels G1/G2 disagree with their plain version ({name}, {grad}): {r}")
        worst = max(worst, r["max_do"])
    return worst


def g_design_counts():
    """G1's and G2's launches per design since the last count_reset()."""
    return {name: dict(_wrappers()[name].launches_by_design) for name in ("G1", "G2")}


def bwd_phase(gen):
    """G1/G2 against attention_bwd_plain on the same operands, through
    flash_bwd (counted: one G1 and one G2 a call, both on the wgmma design,
    and four C1 with quantized); the float DiT-shape gradients the same bits
    on a second run. Then timed one by one at the DiT shape beside the plain
    version (which computes the pair) and aten's flash-attention backward
    (dq, dk and dv together, given SDPA's own forward outputs: a baseline,
    never on the path)."""
    from lowbit_quant_fa2_paddle_tpu_torch.ops import attention_bwd as AB

    cases = [
        ("float b1 h30 s17776 d64", dict(h=H, hk=H, s=S, d=D, causal=False, window=0, quantized=False)),
        ("quantized b1 h30 s17776 d64", dict(h=H, hk=H, s=S, d=D, causal=False, window=0, quantized=True)),
        ("float causal GQA 8q/2kv d128 s1000", dict(h=8, hk=2, s=1000, d=128, causal=True, window=0,
                                                    quantized=False)),
        ("quantized causal GQA 8q/2kv d128 s1000", dict(h=8, hk=2, s=1000, d=128, causal=True, window=0,
                                                        quantized=True)),
        ("float causal window 256 s2048", dict(h=8, hk=8, s=2048, d=64, causal=True, window=256, quantized=False)),
        ("float f32 b1 h4 s512 d64", dict(h=4, hk=4, s=512, d=64, causal=False, window=0, quantized=False,
                                          dtype=torch.float32)),
        # The wgmma design's edges: Sq, Sk around its 64-row tiles and not a
        # multiple of 4 (lse and di rows that do not start on 16 bytes).
        ("float GQA 4q/2kv Sq 127 Sk 129", dict(h=4, hk=2, s=127, sk=129, d=64, causal=False, window=0,
                                                quantized=False)),
        ("float causal Sq 129 Sk 127", dict(h=4, hk=4, s=129, sk=127, d=64, causal=True, window=0, quantized=False)),
        ("float d128 Sq 1 Sk 777", dict(h=4, hk=4, s=1, sk=777, d=128, causal=False, window=0, quantized=False)),
        ("float causal GQA 32q/8kv d128 s777", dict(h=32, hk=8, s=777, d=128, causal=True, window=0,
                                                    quantized=False)),
        ("float causal window 256 GQA 4q/2kv d128 s777", dict(h=4, hk=2, s=777, d=128, causal=True, window=256,
                                                              quantized=False)),
        ("float d32 causal GQA 8q/2kv s300", dict(h=8, hk=2, s=300, d=32, causal=True, window=0, quantized=False)),
    ]
    worst = {False: 0.0, True: 0.0}
    for name, kw in cases:
        quantized, causal, window = kw["quantized"], kw["causal"], kw["window"]
        q, k, v, o, lse2, do = bwd_inputs(gen, kw["h"], kw["hk"], kw["s"], kw["d"], causal, window,
                                          kw.get("dtype", torch.bfloat16), kw.get("sk"))
        count_reset()
        got = AB.flash_bwd(q, k, v, o, lse2, do, is_causal=causal, sm_scale=1.0 / math.sqrt(kw["d"]),
                           quantized=quantized, window=window)
        torch.cuda.synchronize()
        launches, designs = counts(), g_design_counts()
        want_l = {key: 0 for key in launches} | {"G1": 1, "G2": 1, "C1": 4 if quantized else 0}
        want_d = {AB.kernel_design(quantized): 1}
        if launches != want_l or designs != {"G1": want_d, "G2": want_d}:
            raise AssertionError(f"flash_bwd ({name}): launches {launches} != {want_l} or designs {designs}")
        if name == cases[0][0]:  # no atomics: the same bits on every run
            again = AB.flash_bwd(q, k, v, o, lse2, do, is_causal=causal, sm_scale=1.0 / math.sqrt(kw["d"]))
            same = [bool(torch.equal(a, b)) for a, b in zip(got, again)]
            log(f"[G] {name}: dq, dk, dv the same bits on a second run: {same}")
            if not all(same):
                raise AssertionError(f"flash_bwd ({name}) differs between two runs: {same}")
            del again
        args, kargs = AB.bwd_operands(q, k, v, o, lse2, do, is_causal=causal, sm_scale=1.0 / math.sqrt(kw["d"]),
                                      quantized=quantized, window=window)
        want = AB.attention_bwd_plain(*args, **kargs, dq_dtype=q.dtype, dkv_dtype=k.dtype)
        torch.cuda.synchronize()
        worst[quantized] = max(worst[quantized], check_bwd(name, got, want))
        del q, k, v, o, lse2, do, got, want, args

    return {"quantized" if quantized else "float": bwd_timed(gen, H, S, D, quantized, worst[quantized], "G")
            for quantized in (False, True)}


def bwd_timed(gen, h, s, d, quantized, max_abs_err, tag, b=1, sk=None, inputs=None):
    """G1 and G2 timed one by one at b h s d (Sk = sk or s; non-causal, bf16
    inputs, in the mode ``quantized`` says; ``inputs`` bwd_inputs' tuple to
    reuse) beside the plain version (which computes the pair) and, for bf16
    operands, aten's flash-attention backward (dq, dk and dv together, given
    SDPA's own forward outputs: a baseline, never on the path); each
    kernel's bound counts the products the function needs (3 for dq, 4 for
    dk and dv). Returns {"G1": record, "G2": record}."""
    from lowbit_quant_fa2_paddle_tpu_torch.ops import attention_bwd as AB
    from lowbit_quant_fa2_paddle_tpu_torch.utils.benchmark import (
        attention_bwd_flops,
        attention_product_flops,
        cuda_time_ms,
        tflops,
    )

    sk = sk or s
    flops = attention_product_flops(b, h, d, s, sk, False)
    mode = "quantized" if quantized else "float"
    q, k, v, o, lse2, do = inputs or bwd_inputs(gen, h, h, s, d, False, 0, torch.bfloat16, sk=sk, b=b)
    args, kargs = AB.bwd_operands(q, k, v, o, lse2, do, is_causal=False, sm_scale=1.0 / math.sqrt(d),
                                  quantized=quantized)
    design = AB.kernel_design(quantized)
    ms1 = cuda_time_ms(lambda: AB.attention_bwd_dq(*args, **kargs, dq_dtype=torch.bfloat16), warmup=2, reps=10)
    ms2 = cuda_time_ms(lambda: AB.attention_bwd_dkv(*args, **kargs, dkv_dtype=torch.bfloat16), warmup=2, reps=10)
    plain_ms = cuda_time_ms(lambda: AB.attention_bwd_plain(*args, **kargs, dq_dtype=torch.bfloat16,
                                                           dkv_dtype=torch.bfloat16), warmup=1, reps=3)
    # QK^T and dO V^T run on int8 codes in the quantized mode; the rest is bf16.
    lim1 = bound(nbytes(*args) + nbytes(q), {"int8": 2 * flops, "bf16": flops} if quantized else {"bf16": 3 * flops})
    lim2 = bound(nbytes(*args) + nbytes(k, v),
                 {"int8": 2 * flops, "bf16": 2 * flops} if quantized else {"bf16": 4 * flops})
    library_ms = None
    if not quantized:  # the same float backward, dq, dk and dv in one call
        fwd = torch.ops.aten._scaled_dot_product_flash_attention(q, k, v, 0.0, False, False)
        out, lse, cq, ck, mq, mk, seed, offset = fwd[:8]
        library_ms = cuda_time_ms(lambda: torch.ops.aten._scaled_dot_product_flash_attention_backward(
            do, q, k, v, out, lse, cq, ck, mq, mk, 0.0, False, seed, offset), warmup=2, reps=10)
        del fwd, out, lse
    pair_tf = tflops(attention_bwd_flops(b, h, d, s, sk, False), (ms1 + ms2) / 1e3)
    shape = f"b{b} h{h} s{s} d{d}" if sk == s else f"b{b} h{h} sq{s} sk{sk} d{d}"
    log(f"[{tag}] {CARD}: {mode} {shape} ({design}): G1 {ms1:.3f} ms (bound {lim1['bound_ms']:.3f}), G2 "
        f"{ms2:.3f} ms (bound {lim2['bound_ms']:.3f}), G1 + G2 {pair_tf:.1f} TFLOP/s at the 2.5x-forward "
        f"convention, plain (both) {plain_ms:.3f} ms, aten flash backward (dq, dk, dv) {library_ms}")
    common = {"max_abs_err": max_abs_err, "plain_ms": plain_ms, "library_ms": library_ms, "design": design}
    return {"G1": {**common, "ms": ms1, **lim1}, "G2": {**common, "ms": ms2, **lim2}}


def bwd_accuracy_phase(gen):
    """Gradients of the trainable functions against a dense fp32 autograd
    oracle at b2 h4 s1024 d64 bf16, both causal settings (the H100
    counterpart of the TPU record's accuracy rows): flash >= 0.999, the
    int8 forward >= 0.99 (its LSE is the quantized softmax's), the quantized
    backward >= 0.999. Each backward: one G1 and one G2, four more C1 with
    bwd_quantized."""
    import lowbit_quant_fa2_paddle_tpu_torch as lq
    from lowbit_quant_fa2_paddle_tpu_torch.ops import attention_bwd as AB
    from lowbit_quant_fa2_paddle_tpu_torch.ops.metrics import cosine_similarity
    from lowbit_quant_fa2_paddle_tpu_torch.ops.reference import attention_reference

    b, h, s, d = 2, 4, 1024, 64
    q, k, v, g = (torch.randn(b, h, s, d, generator=gen, device="cuda").bfloat16() for _ in range(4))
    res, quantized_launches = {}, {"G1": 0, "G2": 0}
    for causal in (False, True):
        xs = [x.float().requires_grad_() for x in (q, k, v)]
        oracle = torch.autograd.grad((attention_reference(*xs, is_causal=causal) * g.float()).sum(), xs)
        for name, fn, extra, cos_min, c1 in (("flash", lq.flash_attention_trainable, (), 0.999, 0),
                                             ("lowbit", lq.lowbit_attention_trainable, (), 0.99, 1),
                                             ("lowbit bwd_quantized", lq.lowbit_attention_trainable,
                                              (None, None, None, True), 0.999, 5)):
            xs = [x.detach().requires_grad_() for x in (q, k, v)]
            count_reset()
            o = fn(*xs, causal, *extra)
            grads = torch.autograd.grad((o.float() * g.float()).sum(), xs)
            torch.cuda.synchronize()
            got = counts()
            design = AB.kernel_design(bool(extra))
            if g_design_counts() != {kern: {design: 1} for kern in ("G1", "G2")}:
                raise AssertionError(f"{name} causal={causal}: G1/G2 designs {g_design_counts()} (want {design})")
            want = {key: 0 for key in got} | {"A": 1, "G1": 1, "G2": 1, "C1": c1}
            cos = [float(cosine_similarity(a, r)) for a, r in zip(grads, oracle)]
            res[f"{name} causal={causal}"] = cos
            log(f"[train] grad cos vs fp32 oracle, {name}, causal={causal}: dq {cos[0]:.6f} dk {cos[1]:.6f} "
                f"dv {cos[2]:.6f}; launches {got}")
            if min(cos) < cos_min or got != want:
                raise AssertionError(f"{name} causal={causal}: grad cos {cos} (>= {cos_min}), launches {got} != {want}")
            if extra:
                quantized_launches = {key: quantized_launches[key] + got[key] for key in quantized_launches}
    return res, quantized_launches


TRAIN_IMPLS = ("flash_train", "int8_train")
TRAIN_LR = 1e-4


def train_step_profile(model, x0, tgen, impl):
    """Device ms of one training step by kernel, from the kernel events of
    torch.profiler: G1, G2, A, C1, the dense GEMMs (cuBLAS) and the rest."""
    from lowbit_quant_fa2_paddle_tpu_torch.models import dit

    t, noise = dit.draw_t_noise(x0, tgen)
    cats, _, other = profile_classes(
        lambda: dit.sgd_train_step(model, x0, t, noise, lr=TRAIN_LR, attn_impl=impl),
        {"G1": ("attn_bwd_dq",), "G2": ("attn_bwd_dkv",), "A": ("attn_fwd",), "C1": ("quant_per",),
         "GEMM": GEMM_NAMES})
    top = ", ".join(f"{n} x{c} {ms:.1f}" for ms, c, n in other[:4])
    return cats, top


def train_phase():
    """The DiT's training path: at tiny_config on the card, three steps at lr
    1e-2 must lower the loss; then the full-width CogVideoX-2b DiT (dim 1920,
    30 heads x 64, depth 30, random weights from a seeded generator) on one
    17,776-token latent, for each of flash_train and int8_train on a fresh
    copy of the model: a warm-up forward and backward with no update (its
    gradients are checked), then 3 sgd_train_steps at lr 1e-4 with t and
    noise from a seeded generator, counted step by step, then one step under
    torch.profiler."""
    from lowbit_quant_fa2_paddle_tpu_torch.models import dit
    from lowbit_quant_fa2_paddle_tpu_torch.ops.metrics import cosine_similarity

    tiny = dit.tiny_config()
    xb = torch.randn(2, 64, tiny.dim, generator=torch.Generator(device="cuda").manual_seed(3), device="cuda").bfloat16()
    t, noise = dit.draw_t_noise(xb, torch.Generator(device="cuda").manual_seed(4))
    for impl in TRAIN_IMPLS:
        m = dit.init_dit_params(tiny, torch.Generator(device="cuda").manual_seed(0))
        losses = [float(dit.sgd_train_step(m, xb, t, noise, lr=1e-2, attn_impl=impl)) for _ in range(3)]
        log(f"[train] tiny_config {impl}, lr 1e-2, fixed batch: losses {losses}")
        if not (all(math.isfinite(x) for x in losses) and losses[-1] < losses[0]):
            raise AssertionError(f"tiny_config {impl}: loss did not fall: {losses}")

    cfg = dit.cogvideox_2b_config()
    x0 = torch.randn(1, S, cfg.dim, generator=torch.Generator(device="cuda").manual_seed(5), device="cuda")
    x0 = x0.to(cfg.dtype)
    res, qkv_grad = {}, {}
    for impl in TRAIN_IMPLS:
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        model = dit.init_dit_params(cfg, torch.Generator(device="cuda").manual_seed(0))
        params = list(model.parameters())
        n_params = sum(p.numel() for p in params)
        t, noise = dit.draw_t_noise(x0, torch.Generator(device="cuda").manual_seed(6))
        loss = dit.diffusion_loss(model, x0, t, noise, impl)
        grads = torch.autograd.grad(loss, params)
        finite = all(bool(torch.isfinite(g).all()) for g in grads)
        qkv_grad[impl] = grads[next(i for i, p in enumerate(params) if p is model.blocks[0].qkv.weight)].float()
        warm_loss = float(loss.detach())
        del grads, loss
        torch.cuda.synchronize()
        log(f"[train] {impl}: {n_params / 1e9:.3f} B params; init and warm-up {time.perf_counter() - t0:.1f} s, "
            f"warm-up loss {warm_loss:.6f}, gradients finite={finite}")
        if not finite:
            raise AssertionError(f"{impl}: non-finite warm-up gradients")
        before = [p.detach().cpu() for p in params]
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        tgen = torch.Generator(device="cuda").manual_seed(7)
        losses, step_ms, launches, designs, changed = [], [], [], [], None
        for i in range(STEPS):
            t, noise = dit.draw_t_noise(x0, tgen)
            torch.cuda.synchronize()
            count_reset()
            t1 = time.perf_counter()
            loss = dit.sgd_train_step(model, x0, t, noise, lr=TRAIN_LR, attn_impl=impl)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t1) * 1e3)
            launches.append(counts())
            designs.append({**g_design_counts(), "C1": design_counts("C1")})
            losses.append(float(loss))
            if i == 0:
                changed = sum(int((p.detach() != p0.to(p.device)).sum()) for p, p0 in zip(params, before)) / n_params
                del before
        peak = torch.cuda.max_memory_allocated()
        params_finite = all(bool(torch.isfinite(p).all()) for p in params)
        cats, top = train_step_profile(model, x0, tgen, impl)
        log(f"[train] {impl} b1 s{S}: ms/step " + ", ".join(f"{x:.1f}" for x in step_ms) + "; losses "
            + ", ".join(f"{x:.6f}" for x in losses) + f"; peak {peak / 2**30:.2f} GiB; share of parameters the first "
            f"step changed {changed:.4f}; parameters finite={params_finite}")
        log(f"[train] {impl} step device ms (profiler): " + ", ".join(f"{k} {v:.1f}" for k, v in cats.items())
            + f"; total {sum(cats.values()):.1f}; largest other: {top}")
        want = {"A": cfg.depth, "C1": cfg.depth if impl == "int8_train" else 0, "C2": 0, "C3": 0, "D": 0, "E": 0,
                "F1": 0, "F2": 0, "G1": cfg.depth, "G2": cfg.depth}
        want_d = {"wgmma": cfg.depth}
        want_c1 = {"vector": want["C1"], "scalar": 0}  # the DiT's K view on the vector design
        log(f"[train] {impl} launches per step {launches} (want {want}); G1/G2/C1 by design {designs}")
        if any(got != want for got in launches) or any(d != {"G1": want_d, "G2": want_d, "C1": want_c1}
                                                        for d in designs):
            raise AssertionError(f"{impl}: launches per step {launches} != {want} or G1/G2/C1 designs {designs}")
        if not (params_finite and all(math.isfinite(x) for x in losses)):
            raise AssertionError(f"{impl}: non-finite loss or parameters: {losses}")
        res[impl] = {"ms_per_step": step_ms, "losses": losses, "warm_loss": warm_loss, "peak_gib": peak / 2**30,
                     "changed": changed, "profile": cats, "launches": launches, "designs": designs}
        del model, params
    rel = abs(res["int8_train"]["warm_loss"] / res["flash_train"]["warm_loss"] - 1.0)
    rel1 = abs(res["int8_train"]["losses"][0] / res["flash_train"]["losses"][0] - 1.0)
    cos = float(cosine_similarity(qkv_grad["int8_train"], qkv_grad["flash_train"]))
    log(f"[train] int8_train vs flash_train: first loss rel diff {rel:.3e} (warm-up), {rel1:.3e} (step 1); "
        f"block 0 qkv weight gradient cos {cos:.6f}")
    if rel > 0.01 or rel1 > 0.01 or cos < 0.99:
        raise AssertionError(f"int8_train vs flash_train: loss rel {rel} / {rel1} (<= 0.01), qkv grad cos {cos} (>= 0.99)")
    res["qkv_grad_cos"] = cos
    return res


#: Kernel D's cache modes in phase 9: (k_bits, v_bits, compute_mode). "auto"
#: takes the integer QK chain at 8-bit K and the float chain at 4-bit K.
DECODE_MODES = {"int8": (8, 8, "auto"), "bf16": (16, 16, "auto"), "int4": (4, 4, "auto"),
                "int4 int_qk": (4, 4, "int_qk"), "k4v8": (4, 8, "auto"), "k4v8 int_qk": (4, 8, "int_qk")}


def decode_inputs(gen, b, h, hk, d, s, mode, lengths, q_dtype=torch.bfloat16):
    from lowbit_quant_fa2_paddle_tpu_torch.ops.decode import quantize_token

    k_bits, v_bits, compute_mode = DECODE_MODES[mode]
    k = torch.randn(b, hk, s, d, generator=gen, device="cuda").bfloat16()
    v = torch.randn(b, hk, s, d, generator=gen, device="cuda").bfloat16()
    (kq, ks), (vq, vs) = quantize_token(k, bits=k_bits), quantize_token(v, bits=v_bits)
    q = torch.randn(b, h, d, generator=gen, device="cuda").to(q_dtype)
    lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    kernel_args = (q, kq, vq, ks, lens)
    plain_args = (q, kq, vq, ks, vs if v_bits != 16 else None, lens)
    int_qk = k_bits == 8 or compute_mode == "int_qk"
    plain_kw = dict(sm_scale=1.0 / math.sqrt(d), int_qk=int_qk, out_dtype=q.dtype)
    kernel_kw = dict(v_scale=vs, k_bits=k_bits, v_bits=v_bits, compute_mode=compute_mode)
    return kernel_args, kernel_kw, plain_args, plain_kw


def decode_phase(gen):
    """Kernel D against its plain version (see the module note, phase 9) in
    every cache mode of DECODE_MODES, its edges (lengths at 127/128/129 and
    at a split boundary +- 1, a GQA group of 8, f32 queries at d32), the
    same bits on a second run, every launch on its one design; then timed."""
    from lowbit_quant_fa2_paddle_tpu_torch.ops import decode as DD
    from lowbit_quant_fa2_paddle_tpu_torch.utils.benchmark import cuda_time_ms

    b, h, hk, d, s = 4, 32, 8, 128, 32768
    # The split plan of the b4 h32 hk8 d128 edge case (S_max 4096), for the
    # lengths around its first split boundary (the plan follows the mode's occupancy).
    slots = {mode: DD._resident_ctas(0, d, kb, vb, kb == 8 or cm == "int_qk")
             for mode, (kb, vb, cm) in DECODE_MODES.items()}
    cases = [
        ("d128 GQA 32q/8kv s32768", dict(b=b, h=h, hk=hk, d=d, s=s, lengths=[s, 1, 4097, 0])),
        ("d64 MHA s5000", dict(b=2, h=8, hk=8, d=64, s=5000, lengths=[5000, 77])),
        ("d32 GQA 8q/2kv s1000", dict(b=3, h=8, hk=2, d=32, s=1000, lengths=[1000, 0, 513])),
        # The checkpoint's decode: b64, S_max 128, lengths 36-38, f32 queries.
        ("d32 GQA 8q/2kv b64 s128 f32", dict(b=64, h=8, hk=2, d=32, s=128, lengths=[36 + i % 3 for i in range(64)],
                                             q_dtype=torch.float32)),
        ("edge d128 lengths 127/128/129", dict(b=4, h=h, hk=hk, d=d, s=4096, lengths=[127, 128, 129, 4096])),
        ("edge d128 GQA group 8 (64q/8kv)", dict(b=2, h=64, hk=8, d=d, s=3000, lengths=[3000, 1999])),
        ("edge d32 f32 queries s777", dict(b=3, h=8, hk=2, d=32, s=777, lengths=[777, 1, 500], q_dtype=torch.float32)),
    ]
    records = {}
    for mode in DECODE_MODES:
        chunk = DD.num_splits(4096, 4 * hk, slots[mode])[1]
        edge = ("edge d128 split boundary +-1", dict(b=4, h=h, hk=hk, d=d, s=4096,
                                                     lengths=[chunk - 1, chunk, chunk + 1, 2 * chunk + 1]))
        worst = 0.0
        for name, kw in cases + [edge]:
            kargs, kkw, pargs, pkw = decode_inputs(gen, mode=mode, **kw)
            n = DD.decode_attention.launches_by_design[DD.kernel_design()]
            o, lse = DD.decode_attention(*kargs, **kkw, return_lse=True)
            o2, lse2 = DD.decode_attention(*kargs, **kkw, return_lse=True)
            o_ref, lse_ref = DD.decode_attention_plain(*pargs, **pkw)
            torch.cuda.synchronize()
            r = stats(o, o_ref, lse, lse_ref)
            ulp = bf16_ulp(float(o_ref.float().abs().max()))
            empty = [i for i, n_ in enumerate(kw["lengths"]) if n_ == 0]
            empty_ok = all(float(o[i].float().abs().max()) == 0.0 and bool((lse[i] == -1e30).all()) for i in empty)
            same = torch.equal(o, o2) and torch.equal(lse, lse2)
            on_design = DD.decode_attention.launches_by_design[DD.kernel_design()] == n + 2
            fields = " ".join(f"{k}={v:.6g}" if isinstance(v, float) else f"{k}={v}" for k, v in r.items())
            log(f"[D] {mode} {name} (lengths {kw['lengths'][:5]}): {fields} bf16_ulp={ulp:.3g} "
                f"empty_rows_ok={empty_ok} same_bits_twice={same} design={DD.kernel_design()}:{on_design}")
            if not (r["finite"] and r["cos"] >= COS_MIN and r["max_do"] <= ulp and r["max_dlse"] <= 1e-4 and empty_ok
                    and same and on_design):
                raise AssertionError(f"kernel D disagrees with its plain version ({mode}, {name}): {r}")
            worst = max(worst, r["max_do"])
            if name.startswith("d128"):  # the no-LSE launch writes the same output
                if not torch.equal(DD.decode_attention(*kargs, **kkw), o):
                    raise AssertionError("kernel D output differs with return_lse=False")
            del kargs, pargs, o, o_ref, o2
        kargs, kkw, pargs, pkw = decode_inputs(gen, b, h, hk, d, s, mode, [s] * b)
        ms = cuda_time_ms(lambda: DD.decode_attention(*kargs, **kkw), warmup=5, reps=50)
        plain_ms = cuda_time_ms(lambda: DD.decode_attention_plain(*pargs, **pkw), warmup=1, reps=5)
        q, kq, vq, ks, lens = kargs
        cache_bytes = nbytes(kq, vq, ks, pargs[4])
        gbps = cache_bytes / (ms * 1e-3) / 1e9
        lim = bound(cache_bytes + nbytes(q, lens) * 2)  # q read, o written
        # No single PyTorch call decodes packed nibbles or int8 codes.
        library_ms = None
        if mode == "bf16":  # one SDPA call, one query per head, over the same bf16 cache
            q4 = q[:, :, None]
            library_ms = cuda_time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
                q4, kq, vq, enable_gqa=True), warmup=3, reps=20)
        log(f"[D] {mode} b{b} h{h} hk{hk} d{d} s{s} (all lengths {s}): kernel {ms:.4f} ms "
            f"({gbps:.1f} GB/s of {cache_bytes / 1e6:.1f} MB cache), plain {plain_ms:.4f} ms, "
            f"bound {lim['bound_ms']:.4f} ms, SDPA {library_ms}")
        records[mode] = {"max_abs_err": worst, "ms": ms, "plain_ms": plain_ms, "gbps": gbps, **lim,
                         "library_ms": library_ms, "design": DD.kernel_design()}
        del kargs, pargs
    return records


def _wrappers():
    from lowbit_quant_fa2_paddle_tpu_torch.ops.attention import lowbit_attention
    from lowbit_quant_fa2_paddle_tpu_torch.ops.attention_bwd import attention_bwd_dkv, attention_bwd_dq
    from lowbit_quant_fa2_paddle_tpu_torch.ops.decode import decode_attention
    from lowbit_quant_fa2_paddle_tpu_torch.ops.fused_kv import fused_packed_kv_attention
    from lowbit_quant_fa2_paddle_tpu_torch.ops.gemv import wq_matmul_fused, wq_matmul_per_channel
    from lowbit_quant_fa2_paddle_tpu_torch.ops.quant import quant_int2, quant_int4, quant_int8

    return {"A": lowbit_attention, "C1": quant_int8, "C2": quant_int4, "C3": quant_int2, "D": decode_attention,
            "E": fused_packed_kv_attention, "F1": wq_matmul_per_channel, "F2": wq_matmul_fused,
            "G1": attention_bwd_dq, "G2": attention_bwd_dkv}


def count_reset():
    for name, w in _wrappers().items():
        w.launches = 0
        for key in getattr(w, "launches_by_design", {}):
            w.launches_by_design[key] = 0
        getattr(w, "launches_by_variant", {}).clear()
        for key in getattr(w, "launches_by_dim", {}):
            w.launches_by_dim[key] = 0


def variant_counts():
    """Kernel D's launches per variant (``ops.decode.launch_variant``) since
    the last count_reset()."""
    return {k: n for k, n in _wrappers()["D"].launches_by_variant.items() if n}


def design_counts(name="A"):
    """A kernel's launches per design since the last count_reset()."""
    return dict(_wrappers()[name].launches_by_design)


def counts():
    return {name: w.launches for name, w in _wrappers().items()}


def check_counts(where, got, depth, decode_steps, f1=0, f2=0, f_design="tensor_core", c1_design="vector"):
    """The launches of one generate: A and C1 once per layer at prefill (C1
    on ``c1_design``), D once per layer and decode step, and the given F1/F2
    counts, all on ``f_design``."""
    want = {"A": depth, "C1": depth, "C2": 0, "C3": 0, "D": depth * decode_steps, "E": 0, "F1": f1, "F2": f2,
            "G1": 0, "G2": 0}
    from lowbit_quant_fa2_paddle_tpu_torch.ops.decode import kernel_design as d_design

    designs = design_counts()  # the prefill's A on the wgmma design
    d_designs = design_counts("D")  # every decode launch on D's one design
    c1_designs = design_counts("C1")  # the prefill's K quantization, on the vector design but for wide rows
    log(f"[{where}] launches {got} (want {want}), kernel A by design {designs}, kernel D by design {d_designs}, "
        f"kernel C1 by design {c1_designs}")
    # F1 and F2 run bf16 activations on the tensor cores, f32 ones (the checkpoint) on the CUDA cores.
    f_want = {f"F{i}": {design: n if design == f_design else 0 for design in ("tensor_core", "cuda_core")}
              for i, n in ((1, f1), (2, f2))}
    f_designs = {key: design_counts(key) for key in f_want}
    if f1 or f2:
        log(f"[{where}] kernels F1/F2 by design {f_designs}")
    if (got != want or designs != {"wgmma": depth} or d_designs != {d_design(): want["D"]}
            or f_designs != f_want or c1_designs != {c1_design: depth, ("scalar" if c1_design == "vector" else
                                                                          "vector"): 0}):
        raise AssertionError(f"{where}: launch counts {got} != {want} or {designs} or {d_designs} or {f_designs} "
                             f"or {c1_designs}")


#: The checkpoint's cache modes by their LLMConfig fields (phase 23 (c)).
CKPT_MODES = (("int8", dict(kv_bits=8)), ("bf16", dict(kv_bits=16)), ("int4", dict(kv_bits=4)),
              ("k4v8", dict(kv_bits=8, k_bits=4)))


# ---------------------------------------------------------------------------
# Kernels F1/F2 (packed-weight matmul) and E (packed-KV attention)
# ---------------------------------------------------------------------------

# The full-width LLM's matrices (N, K) at dim 4096 with 8 KV heads x 128
# (wq/wo, wk/wv, w1, w2) and how many of each a layer holds; the checkpoint's.
DECODE_NK = {(4096, 4096): 2, (1024, 4096): 2, (16384, 4096): 1, (4096, 16384): 1}
LLM_DEPTH = 32
CKPT_NK = [(256, 256), (64, 256), (1024, 256), (256, 1024)]
# Mode -> kernel: per-channel w8 (bf16 x, or per-token INT8 x), per-channel w4
# (run as grouped 4-bit), grouped asymmetric 2/4/8-bit with group 128.
GEMV_MODES = {"w8": "F1", "w8a8": "F1", "w4": "F2", "g2": "F2", "g4": "F2", "g8": "F2"}


def gemv_weights(gen, mode, n, k):
    from lowbit_quant_fa2_paddle_tpu_torch.ops import gemv as G

    w = torch.randn(n, k, generator=gen, device="cuda") / math.sqrt(k)
    if mode in ("w8", "w8a8", "w4"):
        packed, scale = G.pack_weights_per_channel(w, bits=4 if mode == "w4" else 8)
        return {"packed": packed, "scale": scale, "mn": None}, w
    packed, scale, mn = G.pack_weights(w, group_size=128, bits=int(mode[1]))
    return {"packed": packed, "scale": scale, "mn": mn}, w


def gemv_call(mode, x, wt):
    from lowbit_quant_fa2_paddle_tpu_torch.ops import gemv as G

    if mode in ("w8", "w8a8", "w4"):
        return G.wq_matmul_per_channel(x, wt["packed"], wt["scale"], bits=4 if mode == "w4" else 8,
                                       activation="int8" if mode == "w8a8" else "bf16")
    return G.wq_matmul_fused(x, wt["packed"], wt["scale"], wt["mn"], bits=int(mode[1]), group_size=128)


def gemv_plain(mode, x, wt):
    """The kernel's plain version on the same 2-D x, routed as the JAX
    package routes the mode."""
    from lowbit_quant_fa2_paddle_tpu_torch.ops import gemv as G

    p, s = wt["packed"], wt["scale"]
    if mode == "w8":
        return G.wq_matmul_per_channel_plain(x, p, s, out_dtype=x.dtype)
    if mode == "w8a8":
        xq, xs = G.quant_activations(x)
        return G.wq_matmul_per_channel_plain(xq, p, s, x_scale=xs, out_dtype=x.dtype)
    if mode == "w4":
        sc = s[:, None].repeat(1, 2)
        mn = (-7.0 * s)[:, None].expand(s.shape[0], 2)
        return G.wq_matmul_fused_plain(x, p, sc, mn, bits=4, group_size=x.shape[1] // 2)
    return G.wq_matmul_fused_plain(x, p, s, wt["mn"], bits=int(mode[1]), group_size=128)


def gemv_dot_max(mode, x, wt):
    """max|y| of F2's dot before the zero-point term (0 for F1): F2 rounds
    that dot to x's type and then adds the term, so a summation-order flip
    there moves y by an ulp of the dot, which can exceed y."""
    from lowbit_quant_fa2_paddle_tpu_torch.ops import gemv as G

    if GEMV_MODES[mode] == "F1":
        return 0.0
    if mode == "w4":
        sc = wt["scale"][:, None].repeat(1, 2)
        dot = G.wq_matmul_fused_plain(x, wt["packed"], sc, None, bits=4, group_size=x.shape[1] // 2)
    else:
        dot = G.wq_matmul_fused_plain(x, wt["packed"], wt["scale"], None, bits=int(mode[1]), group_size=128)
    return float(dot.float().abs().max())


def check_gemv(name, y, y_ref, dot_max=0.0):
    """Kernel vs plain: the same products summed in another order, so
    max|dy| <= 2 bf16 ulps of the larger of max|y| and F2's max|dot|
    (f32: 1e-5 of it)."""
    r = stats(y, y_ref)
    ymax = max(float(y_ref.float().abs().max()), dot_max)
    tol = 2 * bf16_ulp(ymax) if y.dtype == torch.bfloat16 else 1e-5 * ymax
    log(f"[F] {name}: cos={r['cos']:.7f} max_dy={r['max_do']:.4g} (bound {tol:.3g}; max|y| "
        f"{float(y_ref.float().abs().max()):.4g}, max|dot| {dot_max:.4g}) finite={r['finite']}")
    if not (r["finite"] and r["cos"] >= COS_MIN and r["max_do"] <= tol):
        raise AssertionError(f"kernel {name} disagrees with its plain version: {r}, bound {tol}")
    return r["max_do"]


def cycle_ms(fns, reps=50):
    """Median ms of one call, cycling over ``fns`` that read distinct copies
    of the weights (over 100 MB in all), so each call reads them from HBM
    and not from the 50 MB L2, as a decode step streaming GBs does."""
    from lowbit_quant_fa2_paddle_tpu_torch.utils.benchmark import cuda_time_ms

    it = itertools.cycle(fns)
    return cuda_time_ms(lambda: next(it)(), warmup=len(fns), reps=reps)


# The copy-only probe of F2's tensor-core design (script/torch_gemv_ab.py):
# its package copy is built while the first phases run.
GEMV_AB = os.path.join(REPO, "script", "torch_gemv_ab.py")
_probe_build = {}


def start_gemv_probe_build():
    # At the lowest priority: its ~25 nvcc processes would otherwise take the
    # CPU from the phases that run beside it.
    _probe_build["proc"] = subprocess.Popen(["nice", "-n", "19", sys.executable, GEMV_AB, "--build", "copy-only"],
                                            cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def gemv_copy_only_probe():
    """TB/s of packed bytes that F2's load structure alone reaches (the
    copy-only variant: the same loads of W and x, no math, wrong results) at
    the decode shapes, timed in its own process on this card."""
    proc = _probe_build.pop("proc")
    out = proc.communicate(timeout=600)[0]
    if proc.returncode != 0:
        raise RuntimeError(f"building the copy-only probe failed:\n{out[-4000:]}")
    run = subprocess.run([sys.executable, GEMV_AB, "--worker", "copy-only", "w4", "g2", "g4", "g8"],
                         cwd=out.strip().splitlines()[-1], capture_output=True, text=True, timeout=600)
    if run.returncode != 0:
        raise RuntimeError(f"the copy-only probe failed:\n{run.stdout[-2000:]}{run.stderr[-4000:]}")
    times = json.loads(run.stdout.strip().splitlines()[-1])["times"]
    log("[F] copy-only probe (loads of W and x alone, script/torch_gemv_ab.py): " +
        ", ".join(f"{key} {t['ms'] * 1e3:.2f} us {t['tb_per_s']:.3f} TB/s" for key, t in times.items()))
    return times


def gemv_phase(gen):
    """Kernels F1 and F2 against their plain versions: every mode at the
    full-width decode shapes (M = 4, bf16); w8 and w4 at the checkpoint's
    shapes with M = 64 and f32 x; M = 1000, the largest kernel-route M.
    Timed at the decode shapes (kernel, plain, and torch.matmul on the dense
    bf16 W), summed to a decode step of the 32-layer model. Then each mode's
    entry point once with the counters at 0 (w8a8 and the grouped modes run
    on no model path: this is their path)."""
    from lowbit_quant_fa2_paddle_tpu_torch.ops.pack import WQLinear
    from lowbit_quant_fa2_paddle_tpu_torch.utils.benchmark import cuda_time_ms

    from lowbit_quant_fa2_paddle_tpu_torch.ops import gemv as G

    worst = {mode: 0.0 for mode in GEMV_MODES}
    count_reset()
    want = {key: {design: 0 for design in G.DESIGNS} for key in ("F1", "F2")}

    def check(name, mode, x, wt, y, y_ref):
        # w8a8 (an exact integer dot, the plain version's epilogue) must be bit-equal.
        want[GEMV_MODES[mode]][G.kernel_design(torch.int8 if mode == "w8a8" else x.dtype)] += 1
        if mode == "w8a8" and not torch.equal(y, y_ref):
            raise AssertionError(f"kernel F1 (w8a8) {name}: not bit-equal to its plain version")
        worst[mode] = max(worst[mode], check_gemv(f"{mode} {name}", y, y_ref, gemv_dot_max(mode, x, wt)))

    for n, k in DECODE_NK:
        x = torch.randn(4, k, generator=gen, device="cuda").bfloat16()
        for mode in GEMV_MODES:
            wt, _ = gemv_weights(gen, mode, n, k)
            y, y2, y_ref = gemv_call(mode, x, wt), gemv_call(mode, x, wt), gemv_plain(mode, x, wt)
            torch.cuda.synchronize()
            want[GEMV_MODES[mode]][G.kernel_design(torch.int8 if mode == "w8a8" else x.dtype)] += 1
            if not torch.equal(y, y2):
                raise AssertionError(f"kernel {GEMV_MODES[mode]} ({mode}) M4 N{n} K{k}: not the same bits twice")
            check(f"M4 N{n} K{k} bf16 (same bits twice)", mode, x, wt, y, y_ref)
    for n, k in CKPT_NK:
        x = torch.randn(64, k, generator=gen, device="cuda")
        for mode in ("w8", "w4"):
            wt, _ = gemv_weights(gen, mode, n, k)
            check(f"M64 N{n} K{k} f32", mode, x, wt, gemv_call(mode, x, wt), gemv_plain(mode, x, wt))
    x = torch.randn(1000, 4096, generator=gen, device="cuda").bfloat16()
    for mode in ("w8", "w8a8", "w4", "g4"):
        wt, _ = gemv_weights(gen, mode, 4096, 4096)
        check("M1000 N4096 K4096 bf16", mode, x, wt, gemv_call(mode, x, wt), gemv_plain(mode, x, wt))
    got = {key: design_counts(key) for key in want}
    log(f"[F] F1/F2 launches by design {got} (want {want}: bf16 x and F1's int8 x on the tensor cores, f32 x on "
        f"the CUDA cores)")
    if got != want:
        raise AssertionError(f"kernels F1/F2 launches by design {got} != {want}")

    records = {mode: {"max_abs_err": worst[mode]} for mode in GEMV_MODES}
    step_ms = dict.fromkeys(list(GEMV_MODES) + ["dense"], 0.0)
    step_bytes = dict.fromkeys(list(GEMV_MODES) + ["dense"], 0)
    for (n, k), per_layer in DECODE_NK.items():
        x = torch.randn(4, k, generator=gen, device="cuda").bfloat16()
        for mode in GEMV_MODES:
            wt, w = gemv_weights(gen, mode, n, k)
            wbytes = nbytes(wt["packed"], wt["scale"], wt["mn"])
            copies = min(64, max(2, math.ceil(128e6 / wbytes)))
            wts = [{key: (v.clone() if v is not None else None) for key, v in wt.items()} for _ in range(copies)]
            ms = cycle_ms([functools.partial(gemv_call, mode, x, c) for c in wts])
            design = G.kernel_design(torch.int8 if mode == "w8a8" else x.dtype)
            step_ms[mode] += per_layer * LLM_DEPTH * ms
            step_bytes[mode] += per_layer * LLM_DEPTH * wbytes
            line = f"[F] {mode} M4 N{n} K{k}: {'call' if mode == 'w8a8' else 'kernel'} {ms * 1e3:.2f} us " \
                   f"({wbytes / (ms * 1e-3) / 1e9:.0f} GB/s of {wbytes / 1e6:.2f} MB packed)"
            records[mode].setdefault("shape_ms", {})[f"N{n} K{k}"] = ms
            if mode == "w8a8":
                # F1's kernel alone, on INT8 codes of x quantized once outside the clock.
                xq, xs = G.quant_activations(x)
                kernel_ms = cycle_ms([functools.partial(G._gemv_cuda, xq, xs, c["packed"], c["scale"], None, bits=8,
                                                        grouped=False, group_size=0, neg7=False,
                                                        out_dtype=torch.bfloat16, wrapper=G.wq_matmul_per_channel)
                                      for c in wts])
                records[mode].setdefault("shape_kernel_ms", {})[f"N{n} K{k}"] = kernel_ms
                line += f", kernel alone {kernel_ms * 1e3:.2f} us"
            if (n, k) == (16384, 4096):  # w1: the shape of the kernels line
                plain_ms = cuda_time_ms(lambda: gemv_plain(mode, x, wt), warmup=1, reps=5)
                lim = bound(wbytes + nbytes(x) + 4 * n * 2)
                records[mode].update(ms=ms, plain_ms=plain_ms, design=design, **lim)
                if mode == "w8a8":
                    records[mode]["kernel_ms"] = kernel_ms
                line += f", plain {plain_ms:.4f} ms, bound {lim['bound_ms'] * 1e3:.2f} us"
            log(line + f" [{design}]")
            del wts
        wd = w.bfloat16()
        copies = max(2, math.ceil(128e6 / nbytes(wd)))
        wds = [wd.clone() for _ in range(copies)]
        dense_ms = cycle_ms([functools.partial(torch.matmul, x, c.T) for c in wds])
        step_ms["dense"] += per_layer * LLM_DEPTH * dense_ms
        step_bytes["dense"] += per_layer * LLM_DEPTH * nbytes(wd)
        log(f"[F] dense bf16 torch.matmul M4 N{n} K{k}: {dense_ms * 1e3:.2f} us "
            f"({nbytes(wd) / (dense_ms * 1e-3) / 1e9:.0f} GB/s of {nbytes(wd) / 1e6:.1f} MB)")
        if (n, k) == (16384, 4096):
            for mode in GEMV_MODES:
                records[mode]["library_ms"] = dense_ms
        del wds
    # F1's w8 over a decode step, shape by shape (DECODE_NK x 32 layers).
    log("[F] F1 w8 by shape, M4: " + ", ".join(f"{key} {ms * 1e3:.2f} us" for key, ms in records["w8"]["shape_ms"].items())
        + "; w8a8 kernel alone: " + ", ".join(f"{key} {ms * 1e3:.2f} us"
                                             for key, ms in records["w8a8"]["shape_kernel_ms"].items()))
    for mode, ms in step_ms.items():
        gb = step_bytes[mode] / 1e9
        log(f"[F] decode step, {LLM_DEPTH} layers, M4: {mode} {ms:.3f} ms ({gb:.2f} GB of weights, "
            f"{gb / (ms * 1e-3):.0f} GB/s; bound {bound(step_bytes[mode])['bound_ms']:.3f} ms)")
    records["step_ms"], records["step_gb"] = step_ms, {m: b / 1e9 for m, b in step_bytes.items()}
    records["copy_only"] = gemv_copy_only_probe()

    x = torch.randn(4, 4096, generator=gen, device="cuda").bfloat16()
    w = torch.randn(4096, 4096, generator=gen, device="cuda") / 64.0
    entry = {
        "w8a8": lambda: gemv_call("w8a8", x, gemv_weights(gen, "w8a8", 4096, 4096)[0]),
        "g2": functools.partial(WQLinear.from_dense(w, bits=2, backend="fused"), x),
        "g4": functools.partial(WQLinear.from_dense(w, bits=4, backend="fused"), x),
        "g8": functools.partial(WQLinear.from_dense(w, bits=8, backend="fused"), x),
    }
    for mode, fn in entry.items():
        count_reset()
        y = fn()
        torch.cuda.synchronize()
        got = counts()
        want = {key: int(key == GEMV_MODES[mode]) for key in got}
        log(f"[F] entry point {mode}: launches {got}, finite={bool(torch.isfinite(y.float()).all())}")
        if got != want or not bool(torch.isfinite(y.float()).all()):
            raise AssertionError(f"entry point {mode}: launches {got} != {want}")
        records[mode]["launches"] = got[GEMV_MODES[mode]]
    return records


def fused_kv_inputs(gen, b, h, hk, sq, sk, d, bits, group):
    from lowbit_quant_fa2_paddle_tpu_torch.ops.fused_kv import quant_kv_grouped

    q = torch.randn(b, h, sq, d, generator=gen, device="cuda").bfloat16()
    k = (torch.randn(b, hk, sk, d, generator=gen, device="cuda") + 0.5).bfloat16()
    v = (torch.randn(b, hk, sk, d, generator=gen, device="cuda") - 0.3).bfloat16()
    kp, ks, km = quant_kv_grouped(k, bits=bits, group=group)
    vp, vs, vm = quant_kv_grouped(v, bits=bits, group=group)
    return q, kp, vp, ks, km, vs, vm


def fused_kv_edges(gen, dims, tag):
    """Kernel E against its plain version at head dims ``dims``, bits 4 and
    2, causal and not (GQA 8q/2kv, Sq 300 / Sk 1000, group 128), at phase
    11's bounds, the same bits twice, every launch at its head dim. Returns
    the worst max|do| by head dim."""
    from lowbit_quant_fa2_paddle_tpu_torch.ops import fused_kv as FK
    from lowbit_quant_fa2_paddle_tpu_torch.ops.attention import LOG2E

    worst = {}
    for d in dims:
        for bits in (4, 2):
            for causal in (False, True):
                name = f"d{d} int{bits} {'causal ' if causal else ''}GQA 8q/2kv sq300 sk1000 group128"
                args = fused_kv_inputs(gen, 1, 8, 2, 300, 1000, d, bits, 128)
                n = FK.fused_packed_kv_attention.launches_by_dim[d]
                o = FK.fused_packed_kv_attention(*args, bits=bits, is_causal=causal, group=128)
                o2 = FK.fused_packed_kv_attention(*args, bits=bits, is_causal=causal, group=128)
                o_ref = FK.fused_kv_attention_plain(*args, bits=bits, group=128, causal=causal,
                                                    sm_scale_log2e=LOG2E / math.sqrt(d), out_dtype=torch.bfloat16)
                torch.cuda.synchronize()
                r = stats(o, o_ref)
                same = torch.equal(o, o2)
                on_dim = FK.fused_packed_kv_attention.launches_by_dim[d] == n + 2
                log(f"[{tag}] {name}: " + " ".join(f"{k}={v:.6g}" if isinstance(v, float) else f"{k}={v}"
                                                   for k, v in r.items()) + f" same_bits_twice={same} on_dim={on_dim}")
                if not (r["finite"] and r["cos"] >= COS_MIN and r["max_do"] <= MAX_DO and same and on_dim):
                    raise AssertionError(f"kernel E disagrees with its plain version in case {name}: {r}")
                worst[d] = max(worst.get(d, 0.0), r["max_do"])
                del args, o, o2, o_ref
    return worst


def fused_kv_phase(gen):
    """Kernel E against its plain version: bits 4 and 2, causal or not, at
    the kivi4 sweep shape b4 h32 s8192 d64 (group 256) and GQA 32q/8kv d128
    at a ragged s1000 and at Sq 700 != Sk 1000 with group 64. The plain
    version rounds where the kernel does and sums in closed form, so cos >=
    0.99999, max|do| <= 2e-2. Timed at b4 h32 s8192 d64 beside SDPA on the
    dequantized bf16 K/V; then its entry point once with the counters at 0
    (the sweep's kivi4 row is its path)."""
    from lowbit_quant_fa2_paddle_tpu_torch.ops import fused_kv as FK
    from lowbit_quant_fa2_paddle_tpu_torch.ops.attention import LOG2E
    from lowbit_quant_fa2_paddle_tpu_torch.utils.benchmark import attention_flops, cuda_time_ms, tflops

    worst = 0.0
    design = FK.kernel_design()
    shapes = [("b4 h32 s8192 d64", (4, 32, 32, 8192, 8192, 64, 256)),
              ("GQA 32q/8kv d128 s1000", (2, 32, 8, 1000, 1000, 128, 256)),
              ("GQA 32q/8kv d128 sq700 sk1000 group64", (2, 32, 8, 700, 1000, 128, 64))]
    # The design's edges: groups smaller and larger than its 128-key tile,
    # key counts just past one tile and ragged, causal Sq != Sk at d128.
    edges = [("edge group32 s1000", (1, 8, 8, 1000, 1000, 64, 32)),
             ("edge group512 GQA 8q/2kv s1000", (1, 8, 2, 1000, 1000, 64, 512)),
             ("edge sk129", (1, 8, 8, 300, 129, 64, 64)),
             ("edge sk777 group100", (1, 8, 4, 300, 777, 64, 100)),
             ("edge d128 sq700 sk1000", (1, 16, 4, 700, 1000, 128, 128))]
    for bits in (4, 2):
        for causal in (False, True):
            for shape, (b, h, hk, sq, sk, d, group) in shapes + edges:
                name = f"int{bits} {'causal ' if causal else ''}{shape}"
                args = fused_kv_inputs(gen, b, h, hk, sq, sk, d, bits, group)
                n = FK.fused_packed_kv_attention.launches_by_design[design]
                o = FK.fused_packed_kv_attention(*args, bits=bits, is_causal=causal, group=group)
                o2 = FK.fused_packed_kv_attention(*args, bits=bits, is_causal=causal, group=group)
                o_ref = FK.fused_kv_attention_plain(*args, bits=bits, group=group, causal=causal,
                                                    sm_scale_log2e=LOG2E / math.sqrt(d), out_dtype=torch.bfloat16)
                torch.cuda.synchronize()
                r = stats(o, o_ref)
                same = torch.equal(o, o2)
                on_design = FK.fused_packed_kv_attention.launches_by_design[design] == n + 2
                log(f"[E] {name}: " + " ".join(f"{k}={v:.6g}" if isinstance(v, float) else f"{k}={v}"
                                               for k, v in r.items()) + f" same_bits_twice={same} {design}:{on_design}")
                if not (r["finite"] and r["cos"] >= COS_MIN and r["max_do"] <= MAX_DO and same and on_design):
                    raise AssertionError(f"kernel E disagrees with its plain version in case {name}: {r}")
                worst = max(worst, r["max_do"])
                del args, o, o2, o_ref
    b, h, s, d, bits, group = 4, 32, 8192, 64, 4, 256
    args = fused_kv_inputs(gen, b, h, h, s, s, d, bits, group)
    flops = attention_flops(b, h, d, s, s, False)
    ms = cuda_time_ms(lambda: FK.fused_packed_kv_attention(*args, bits=bits), warmup=2, reps=10)
    causal_ms = cuda_time_ms(lambda: FK.fused_packed_kv_attention(*args, bits=bits, is_causal=True), warmup=2, reps=10)
    plain_ms = cuda_time_ms(lambda: FK.fused_kv_attention_plain(*args, bits=bits, group=group, causal=False,
                                                                 sm_scale_log2e=LOG2E / math.sqrt(d),
                                                                 out_dtype=torch.bfloat16), warmup=1, reps=2)
    kd = FK.dequant_kv_grouped(args[1], args[3], args[4], bits=bits, group=group)
    vd = FK.dequant_kv_grouped(args[2], args[5], args[6], bits=bits, group=group)
    sdpa_ms = cuda_time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(args[0], kd, vd), warmup=2,
                           reps=10)
    lim = bound(nbytes(*args) + nbytes(args[0]), {"bf16": flops})
    log(f"[E] int4 b{b} h{h} s{s} d{d}: kernel {ms:.3f} ms ({tflops(flops, ms / 1e3):.1f} TFLOP/s), causal "
        f"{causal_ms:.3f} ms, plain {plain_ms:.3f} ms, bound {lim['bound_ms']:.3f} ms; SDPA on the dequantized "
        f"bf16 K/V {sdpa_ms:.3f} ms ({tflops(flops, sdpa_ms / 1e3):.1f} TFLOP/s)")
    count_reset()
    o = FK.fused_packed_kv_attention(*args, bits=bits)
    torch.cuda.synchronize()
    got = counts()
    want = {key: int(key == "E") for key in got}
    by_design = dict(FK.fused_packed_kv_attention.launches_by_design)
    log(f"[E] entry point fused_packed_kv_attention(bits=4) b{b} h{h} s{s} d{d}: launches {got}, E by design "
        f"{by_design}")
    if got != want or by_design != {design: 1} or not bool(torch.isfinite(o.float()).all()):
        raise AssertionError(f"kernel E entry point: launches {got} != {want} or {by_design}")
    return {"max_abs_err": worst, "ms": ms, "plain_ms": plain_ms, **lim, "library_ms": sdpa_ms,
            "causal_ms": causal_ms, "launches": got["E"], "design": design}


# The JAX package's exact-match on the same 64 prompts with the int8 cache,
# run on a CPU: the figure the port must reproduce, not a card figure.
JAX_CPU_EXACT_MATCH = {8: 1.0, 4: 0.984375}


def checkpoint_wq_phase():
    """The trained checkpoint with per-channel w8 and w4 weights on the int8
    cache, 64 three-shot prompts. Prefill has 64 x 36 >= 1024 rows (dense
    route, no F); each decode step runs 6 F launches per layer."""
    from lowbit_quant_fa2_paddle_tpu_torch.models import llm, train
    from lowbit_quant_fa2_paddle_tpu_torch.utils.checkpoint import load_params_npz

    tree = load_params_npz(os.path.join(REPO, "eval_out", "arith_llm.npz"))
    prompts, answers = train.make_eval_prompts(64, few_shot=3)
    prompt = torch.from_numpy(prompts).cuda()
    cfg = train.arith_llm_config(kv_bits=8)
    model = llm.params_from_jax(tree, cfg)
    out = {}
    for bits in (8, 4):
        qmodel = llm.quantize_llm_params(model, bits=bits)
        count_reset()
        toks = llm.generate(qmodel, prompt, train.ANS_LEN, cfg).cpu().numpy()
        steps = train.ANS_LEN - 1
        f = 6 * cfg.depth * steps
        check_counts(f"ckpt w{bits}", counts(), cfg.depth, steps, f1=f if bits == 8 else 0, f2=f if bits == 4 else 0,
                     f_design="cuda_core")
        acc = sum(train.grade_answer(row, a) for row, a in zip(toks, answers)) / len(answers)
        log(f"[ckpt] w{bits} weights, int8 cache: task exact-match {acc:.6f} on {len(answers)} prompts "
            f"(the JAX package on a CPU: {JAX_CPU_EXACT_MATCH[bits]})")
        if acc < 0.98:
            raise AssertionError(f"checkpoint exact-match {acc} < 0.98 with w{bits} weights")
        out[bits] = acc
    return out


def decode_step_profile(model, prompt, cfg, trace_dir=None):
    """Device ms of one decode step by kernel class, from the kernel events
    of torch.profiler: F (our gemv kernels), dense GEMMs (cuBLAS), D, and
    the rest, with the rest's largest kernels by name; with ``trace_dir``
    through ``utils.profiling.trace``, which writes the step's Chrome trace
    there."""
    from lowbit_quant_fa2_paddle_tpu_torch.models import llm

    logits, caches = llm.llm_prefill(model, prompt, cfg)
    tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
    del logits
    for _ in range(2):
        _, caches = llm.llm_decode_step(model, tok, caches, cfg)
    cats, _, other = profile_classes(lambda: llm.llm_decode_step(model, tok, caches, cfg),
                                     {"F": F_NAMES, "GEMM": GEMM_NAMES, "D": ("decode",)}, trace_dir=trace_dir)
    top = ", ".join(f"{name} x{n} {ms:.3f}" for ms, n, name in other[:5])
    return cats, f"{len(other)} other kernel names; top: {top}"


def check_trace(path, f):
    """The kernel names of a Chrome trace that utils.profiling.trace wrote:
    it must name kernel D's kernel and, with ``f``, one of F's (F1/F2)."""
    with open(path) as fh:
        events = json.load(fh)["traceEvents"]
    names = sorted({e["name"] for e in events if e.get("cat") == "kernel"})
    d_names = [n for n in names if "decode" in n.lower()]
    f_names = [n for n in names if any(piece in n.lower() for piece in F_NAMES)]
    log(f"[trace] {path}: {os.path.getsize(path)} bytes, {len(events)} events, {len(names)} kernel names; D "
        f"{[n[:60] for n in d_names]}; F {[n[:60] for n in f_names]}")
    if not d_names or bool(f_names) != f:
        raise AssertionError(f"the trace {path} names D's kernel {d_names} and F's {f_names} (want F: {f})")
    return {"path": path, "D": d_names, "F": f_names}


class FirstLogits:
    """Keeps the first decode step's logits: a hook on the final norm, which
    ``decode_tokens`` runs eagerly for its first step (then under capture,
    where the hook records nothing, and never again: replays run no
    Python)."""

    def __init__(self, model):
        self.model, self.logits = model, None
        self.handle = model.ln_f.register_forward_hook(self._hook)

    def _hook(self, module, inputs, out):
        if out.dim() == 2 and self.logits is None and not torch.cuda.is_current_stream_capturing():
            self.logits = torch.nn.functional.linear(out, self.model.embed.weight).float()

    def remove(self):
        self.handle.remove()


def graph_decode(model, token, caches, n, cfg, spread=8):
    """``n`` tokens of ``decode_tokens`` in three parts: one call of 2
    tokens (its eager first step, the capture, one replay), then one call
    of n - 2 - spread tokens, which replays the captured step, on the host
    clock from enqueue to the last token on the card (wall ms/token), then
    ``spread`` calls of one token between two CUDA events each (each
    replay's device time, with the call's two token copies; the stream
    sleeps before each, so the host's work for the call lies outside the
    events, as in ``cuda_time_ms``). The calls go
    on from each other's last token, as one call of n tokens does. Then D's
    and F1/F2's merge tickets must be zero. Returns (tokens, caches, wall
    ms/token, replay ms list, seconds of the first call)."""
    from lowbit_quant_fa2_paddle_tpu_torch.models import llm
    from lowbit_quant_fa2_paddle_tpu_torch.ops import decode as DD
    from lowbit_quant_fa2_paddle_tpu_torch.ops import gemv as G
    from lowbit_quant_fa2_paddle_tpu_torch.utils.benchmark import SLEEP_CYCLES

    if n < spread + 3:
        raise ValueError(f"{n} tokens do not cover the capture, a timed call and {spread} single replays")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    parts = [llm.decode_tokens(model, token, caches, 2, cfg)[0]]
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    parts.append(llm.decode_tokens(model, parts[-1][:, -1], caches, n - 2 - spread, cfg)[0])
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    replay_ms = []
    for _ in range(spread):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SLEEP_CYCLES)
        a.record()
        parts.append(llm.decode_tokens(model, parts[-1][:, -1], caches, 1, cfg)[0])
        b.record()
        b.synchronize()
        replay_ms.append(a.elapsed_time(b))
    # D's and F1/F2's merge tickets: each last CTA resets its own, replay after replay.
    if any(bool(t.any()) for t in (*DD._TICKETS.values(), *G._TICKETS.values())):
        raise AssertionError("a merge ticket is not zero after the graph's replays")
    wall_ms = (t2 - t1) / (n - 2 - spread) * 1e3
    return torch.cat(parts, dim=1), caches, wall_ms, replay_ms, t1 - t0


#: Phase 13's model depth: 16 of its geometry's 32, for the run's time limit
#: (the widths whole). Phases 15, 16 and 19 run the same model.
LLM13_DEPTH = 16


def full_width_phase():
    from lowbit_quant_fa2_paddle_tpu_torch.models import llm
    from lowbit_quant_fa2_paddle_tpu_torch.ops.metrics import cosine_similarity

    b, prompt_len, n_new = 4, 32704, 64
    cfg = llm.LLMConfig(vocab=256, dim=4096, depth=LLM13_DEPTH, num_heads=32, num_kv_heads=8, max_seq=32768,
                        dtype=torch.bfloat16)
    gen = torch.Generator(device="cuda").manual_seed(0)
    t0 = time.perf_counter()
    model = llm.init_llm_params(cfg, gen)
    n_params = sum(p.numel() for p in model.parameters())
    prompt = torch.randint(0, cfg.vocab, (b, prompt_len), generator=gen, device="cuda")
    torch.cuda.synchronize()
    log(f"[llm] dim {cfg.dim} depth {cfg.depth} heads {cfg.num_heads}x{cfg.head_dim} kv heads {cfg.num_kv_heads} "
        f"vocab {cfg.vocab} bf16: {n_params / 1e9:.3f} B params, init {time.perf_counter() - t0:.1f} s")
    small = dataclasses.replace(cfg, max_seq=512)
    llm.generate(model, prompt[:, :256], 2, small)  # warm-up, not counted
    packed = {wb: llm.quantize_llm_params(model, bits=wb) for wb in (8, 4)}
    for wb in (8, 4):
        llm.generate(packed[wb], prompt[:, :64], 2, small)  # warm-up of the F kernels, not counted
    dense_gb = sum(nbytes(getattr(blk, key).weight) for blk in model.blocks for key in llm._WQ_KEYS) / 1e9
    weight_gb = {"int8": dense_gb, "bf16": dense_gb}
    for wb in (8, 4):
        weight_gb[f"w{wb}"] = sum(nbytes(getattr(blk, key).packed, getattr(blk, key).scale)
                                  for blk in packed[wb].blocks for key in llm._WQ_KEYS) / 1e9
    res = {}
    # Dense weights with the int8 and the bf16 cache, then packed w8 and w4
    # weights with the int8 cache; F runs once per matrix and decode step
    # (prefill's 130,816 rows take the dense route). generate's two stages
    # run here one by one, so each has its own clock: llm_prefill, the
    # argmax, decode_tokens (one eager step, the capture, n_new - 2 replays).
    f_steps = 6 * cfg.depth * (n_new - 1)
    for mode, bits, m_run, f1, f2 in (("int8", 8, model, 0, 0), ("bf16", 16, model, 0, 0),
                                      ("w8", 8, packed[8], f_steps, 0), ("w4", 8, packed[4], 0, f_steps)):
        cfg_m = dataclasses.replace(cfg, kv_bits=bits)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        first = FirstLogits(m_run)
        count_reset()
        t0 = time.perf_counter()
        logits, caches = llm.llm_prefill(m_run, prompt, cfg_m)
        token = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
        del logits
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
        steps, caches, wall_ms, replay_ms, call_s = graph_decode(m_run, token, caches, n_new - 1, cfg_m)
        toks = torch.cat([token[:, None], steps], dim=1)
        got = counts()
        first.remove()
        peak = torch.cuda.max_memory_allocated()
        row_bytes = cfg.head_dim * (1 if bits == 8 else 2) + 4  # codes or bf16 row, f32 scale
        cache_gb = cfg.depth * 2 * b * cfg.num_kv_heads * cfg.max_seq * row_bytes / 1e9
        log(f"[llm] {mode}: {weight_gb[mode]:.3f} GB of block weights, {'bf16' if bits == 16 else 'int8'} cache "
            f"({cache_gb:.2f} GB over {cfg.depth} layers): prefill {prefill_s:.3f} s, "
            f"graph decode {wall_ms:.3f} ms/token wall over {n_new - 11} replays in one call (single-replay "
            f"device ms median {statistics.median(replay_ms):.3f}, min {min(replay_ms):.3f}, max "
            f"{max(replay_ms):.3f} over {len(replay_ms)}; the first call, with its eager first step and capture, "
            f"{call_s:.2f} s), peak {peak / 2**30:.2f} GiB")
        check_counts(f"llm {mode}", got, cfg.depth, n_new - 1, f1=f1, f2=f2)
        if tuple(toks.shape) != (b, n_new) or not bool(((toks >= 0) & (toks < cfg.vocab)).all()):
            raise AssertionError(f"bad generated tokens: shape {tuple(toks.shape)}")
        if first.logits is None or not bool(torch.isfinite(first.logits).all()):
            raise AssertionError("no or non-finite first-step logits")
        res[mode] = {"prefill_s": prefill_s, "decode_ms_per_token": wall_ms, "replay_ms": replay_ms,
                     "decode_call_s": call_s, "peak_gib": peak / 2**30, "weight_gb": weight_gb[mode],
                     "launches": got, "tokens": toks.cpu(), "logits": first.logits}
        del toks, first, caches, steps
    cos = float(cosine_similarity(res["int8"]["logits"], res["bf16"]["logits"]))
    agree = float((res["int8"]["tokens"] == res["bf16"]["tokens"]).float().mean())
    log(f"[llm] first decode step logits cos int8 vs bf16 cache {cos:.6f}; generated-token agreement {agree:.4f}")
    if cos < 0.999:
        raise AssertionError(f"int8 vs bf16 cache first-step logits cos {cos} < 0.999")
    for mode in ("w8", "w4"):
        wcos = float(cosine_similarity(res[mode]["logits"], res["int8"]["logits"]))
        wagree = float((res[mode]["tokens"] == res["int8"]["tokens"]).float().mean())
        res[mode]["logits_cos_vs_dense"] = wcos
        log(f"[llm] first decode step logits cos {mode} vs dense weights (int8 cache) {wcos:.6f}; "
            f"generated-token agreement {wagree:.4f}")
        if mode == "w8" and wcos < 0.99:
            raise AssertionError(f"w8 vs dense first-step logits cos {wcos} < 0.99")
    first_int8 = res["int8"]["logits"]
    for mode in res:
        del res[mode]["tokens"], res[mode]["logits"]
    # One decode step per weight format (a 256-token context: F and the
    # GEMMs do not depend on it) through utils.profiling.trace, whose Chrome
    # trace must name kernel D's kernel and, with packed weights, F's.
    for mode, m_run in (("dense", model), ("w8", packed[8]), ("w4", packed[4])):
        cats, top = decode_step_profile(m_run, prompt[:, :256], small, trace_dir=os.path.join(TMP, "traces"))
        res.setdefault("profile", {})[mode] = cats
        log(f"[llm] decode step device ms at a 256-token context, {mode} weights: " +
            ", ".join(f"{k} {v:.3f}" for k, v in cats.items()) + f"; total {sum(cats.values()):.3f}; {top}")
        res.setdefault("traces", {})[mode] = check_trace(PROFILED["trace"], f=mode != "dense")
    # The same at the full context (a 32,704-token prompt, S_max 32768), dense
    # weights, per cache mode: D streams the whole cache there.
    for mode, bits in (("int8", 8), ("bf16", 16)):
        t0 = time.perf_counter()
        cats, top = decode_step_profile(model, prompt, dataclasses.replace(cfg, kv_bits=bits))
        torch.cuda.empty_cache()
        res.setdefault("profile_32k", {})[mode] = cats
        log(f"[llm] decode step device ms at a {prompt_len + 2}-token context, {mode} cache, dense weights: " +
            ", ".join(f"{k} {v:.3f}" for k, v in cats.items()) + f"; total {sum(cats.values()):.3f}; {top} "
            f"({time.perf_counter() - t0:.1f} s with its prefill)")
    del packed
    # Phase 15's windowed LLM runs on this model (no second init).
    res["_model"], res["_first_logits_int8"], res["_prompt"] = model, first_int8, prompt
    return res


def cache_step_profile(model, token, caches, cfg):
    """Device ms of one eager decode step over the given caches by kernel
    class (as decode_step_profile), after one unprofiled step."""
    from lowbit_quant_fa2_paddle_tpu_torch.models import llm

    _, caches = llm.llm_decode_step(model, token, caches, cfg)
    return profile_classes(lambda: llm.llm_decode_step(model, token, caches, cfg),
                           {"F": F_NAMES, "GEMM": GEMM_NAMES, "D": ("decode",)})[0]


def long_prefill_attention_check(model, toks, cache, c0, cfg, where="128K chunked prefill", tag="long"):
    """Kernel A as the chunked prefill runs it on its chunk at ``c0``, on
    layer 0's queries (GQA, d128): the in-chunk causal attention (K codes
    per token from C1, Sq = Sk = chunk) and, in the packed-INT4 mode, the
    non-causal attention over the cache's first c0 rows
    (``llm._attend_cache``: 4-bit or int8 K codes with their per-token
    scales, V dequantized to bf16), each against attention_fwd_plain on the same
    inputs, one batch row at a time, at phase 4's bounds; the second timed,
    with its bound. Returns the second's record."""
    from lowbit_quant_fa2_paddle_tpu_torch.models import llm
    from lowbit_quant_fa2_paddle_tpu_torch.ops import quant as qo
    from lowbit_quant_fa2_paddle_tpu_torch.ops.attention import (
        LOG2E,
        attention_fwd_plain,
        kernel_design,
        lowbit_attention,
    )
    from lowbit_quant_fa2_paddle_tpu_torch.utils.benchmark import attention_flops, cuda_time_ms

    b, sc = toks.shape
    h, hk, d = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    pos = (c0 + torch.arange(sc, device="cuda")).expand(b, sc)
    q, k, v = llm._qkv(model.blocks[0], model.embed(toks), cfg)
    q, k = llm._rope(q, pos, cfg.rope_theta), llm._rope(k, pos, cfg.rope_theta)
    c = 1.0 / math.sqrt(d) * LOG2E

    def check(name, o, lse, k, v, ks, causal, k_bits):
        r = {"cos": 1.0, "max_do": 0.0, "finite": True, "max_dlse": 0.0}
        plain_ms = 0.0
        for i in range(b):
            a, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            o_ref, lse_ref = attention_fwd_plain(q[i : i + 1], k[i : i + 1], v[i : i + 1], None, ks[i : i + 1], None,
                                                 causal=causal, sm_scale_log2e=c, out_dtype=torch.bfloat16,
                                                 k_bits=k_bits)
            e.record()
            e.synchronize()
            plain_ms += a.elapsed_time(e)
            ri = stats(o[i : i + 1], o_ref, lse[i : i + 1], lse_ref)
            r = {"cos": min(r["cos"], ri["cos"]), "max_do": max(r["max_do"], ri["max_do"]),
                 "finite": r["finite"] and ri["finite"], "max_dlse": max(r["max_dlse"], ri["max_dlse"])}
            del o_ref, lse_ref
        check_close(f"{name}, {where}'s chunk at c0 {c0} (b{b} h{h} hk{hk} sq{sc} sk{k.shape[2]} d{d})", r)
        return r, plain_ms

    kc, kcs = qo.quant_int8(k, gran="per_token")
    vb = v.to(torch.bfloat16)
    o, lse = lowbit_attention(q, kc, vb, k_scale=kcs, is_causal=True, return_lse=True)
    check("in-chunk int8 K, causal", o, lse, kc, vb, kcs, True, 8)
    del k, v, kc, kcs, vb, o, lse
    o, lse = llm._attend_cache(q, cache, c0, cfg)
    k, ks = cache["k"][:, :, :c0].contiguous(), cache["k_scale"][:, :, :c0].contiguous()
    v = llm._dequant_cache_rows(cache["v"][:, :, :c0], cache["v_scale"][:, :, :c0], cfg.eff_v_bits, torch.bfloat16)
    kb = cfg.eff_k_bits
    r, plain_ms = check(f"{'packed int4' if kb == 4 else 'int8'} K over the cache, non-causal", o, lse, k, v, ks,
                        False, kb)
    ms = cuda_time_ms(lambda: lowbit_attention(q, k, v, k_scale=ks, k_pack_bits=kb, return_lse=True), warmup=1, reps=3)
    flops = attention_flops(b, h, d, sc, c0, False)
    lim = bound(nbytes(q, k, ks, v) + nbytes(q) + b * h * sc * 4, {"int8": flops // 2, "bf16": flops // 2})
    log(f"[{tag}] kernel A {'packed int4' if kb == 4 else 'int8'} K at c0 {c0}: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms (its {b} batch "
        f"rows), bound {lim['bound_ms']:.3f} ms ({lim['bound_by']})")
    return {"max_abs_err": r["max_do"], "ms": ms, "plain_ms": plain_ms, **lim, "library_ms": None,
            "exp_floor_ms": exp_floor_ms(b * h * sc * c0), "design": kernel_design(False)}


def long_decode_check(gen, cache, cfg):
    """Kernel D as the 128K decode runs it: layer 0's k4v8 cache (S_max
    133,120, its own lengths) and a random query of the step's shape,
    against decode_attention_plain at phase 9's bounds on both QK chains,
    the same bits twice, every launch on its design; the float chain (the
    one "auto" takes, the path's) timed, with the bound of the rows it
    reads. Returns its record."""
    from lowbit_quant_fa2_paddle_tpu_torch.ops import decode as DD
    from lowbit_quant_fa2_paddle_tpu_torch.utils.benchmark import cuda_time_ms

    b, d = cache["k"].shape[0], cfg.head_dim
    q = torch.randn(b, cfg.num_heads, d, generator=gen, device="cuda").bfloat16()
    args = (q, cache["k"], cache["v"], cache["k_scale"], cache["length"])
    kw = dict(v_scale=cache["v_scale"], k_bits=4, v_bits=8)
    worst = 0.0
    for chain in ("auto", "int_qk"):
        n = DD.decode_attention.launches_by_design[DD.kernel_design()]
        o, lse = DD.decode_attention(*args, **kw, compute_mode=chain, return_lse=True)
        o2, lse2 = DD.decode_attention(*args, **kw, compute_mode=chain, return_lse=True)
        o_ref, lse_ref = DD.decode_attention_plain(q, cache["k"], cache["v"], cache["k_scale"], cache["v_scale"],
                                                   cache["length"], sm_scale=1.0 / math.sqrt(d),
                                                   int_qk=chain == "int_qk", out_dtype=q.dtype)
        torch.cuda.synchronize()
        r = stats(o, o_ref, lse, lse_ref)
        ulp = bf16_ulp(float(o_ref.float().abs().max()))
        same = torch.equal(o, o2) and torch.equal(lse, lse2)
        on_design = DD.decode_attention.launches_by_design[DD.kernel_design()] == n + 2
        log(f"[long] kernel D k4v8 {chain} on layer 0's 128K cache (lengths {cache['length'].tolist()}): " +
            " ".join(f"{k}={v:.6g}" if isinstance(v, float) else f"{k}={v}" for k, v in r.items()) +
            f" bf16_ulp={ulp:.3g} same_bits_twice={same} design={DD.kernel_design()}:{on_design}")
        if not (r["finite"] and r["cos"] >= COS_MIN and r["max_do"] <= ulp and r["max_dlse"] <= 1e-4 and same
                and on_design):
            raise AssertionError(f"kernel D disagrees with its plain version on the 128K k4v8 cache ({chain}): {r}")
        worst = max(worst, r["max_do"])
        del o, o2, o_ref
    ms = cuda_time_ms(lambda: DD.decode_attention(*args, **kw), warmup=5, reps=50)
    plain_ms = cuda_time_ms(lambda: DD.decode_attention_plain(q, cache["k"], cache["v"], cache["k_scale"],
                                                              cache["v_scale"], cache["length"],
                                                              sm_scale=1.0 / math.sqrt(d), int_qk=False,
                                                              out_dtype=q.dtype), warmup=1, reps=3)
    rows = int(cache["length"].clamp(max=cache["k"].shape[2]).sum())
    row_bytes = d // 2 + d + 4 + 4  # packed K, int8 V, their scales
    lim = bound(cfg.num_kv_heads * rows * row_bytes + nbytes(q, cache["length"]) * 2)
    log(f"[long] kernel D k4v8 at the 128K decode's shape: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"bound {lim['bound_ms']:.4f} ms")
    return {"max_abs_err": worst, "ms": ms, "plain_ms": plain_ms, **lim, "library_ms": None,
            "design": DD.kernel_design()}


def long_context_phase():
    """Phase 14: the full-width LLM (phase 13's widths; depth 8 of its 32,
    cut for the run's time limit) prefills a b4
    131,072-token prompt in chunks of 4096 into a k4v8 cache (max_seq
    133,120: the prompt and llm_e2e_bench's gen-block of 2048) and decodes
    32 tokens through the CUDA graph; launch counts, peak memory, the
    strided cache-slice copies' share of the prefill, one profiled decode
    step, then kernels A and D at this run's shapes against their plain
    versions. Before it, at phase 13's b4 32,704-token prompt: chunked against
    one-shot prefill (int8, k4v8; last-token logits cos >= 0.999 / 0.995,
    tests/test_llm.py's bounds), and the graph decode against the eager loop
    of llm_decode_step from cloned k4v8 caches (the same tokens, bit-equal
    caches), each timed."""
    from lowbit_quant_fa2_paddle_tpu_torch.models import llm
    from lowbit_quant_fa2_paddle_tpu_torch.ops.metrics import cosine_similarity

    b, ctx, chunk, n_new = 4, 131072, 4096, 32
    cfg = llm.LLMConfig(vocab=256, dim=4096, depth=8, num_heads=32, num_kv_heads=8, max_seq=ctx + 2048,
                        dtype=torch.bfloat16, kv_bits=8, k_bits=4)
    gen = torch.Generator(device="cuda").manual_seed(0)
    model = llm.init_llm_params(cfg, gen)
    res = {}

    # Chunked against one-shot at 32K, then graph against loop on the k4v8 caches.
    prompt = torch.randint(0, cfg.vocab, (b, 32704), generator=gen, device="cuda")
    for mode, sides in (("int8", dict(kv_bits=8, k_bits=None)), ("k4v8", dict(kv_bits=8, k_bits=4))):
        cfg_m = dataclasses.replace(cfg, max_seq=32768, **sides)
        t0 = time.perf_counter()
        full, caches = llm.llm_prefill(model, prompt, cfg_m)
        full = full[:, -1].float()
        del caches
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        last, caches = llm.llm_prefill_chunked(model, prompt, cfg_m, chunk=chunk)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        cos = float(cosine_similarity(last.float(), full))
        want = 0.995 if cfg_m.eff_k_bits == 4 else 0.999
        log(f"[long] 32K {mode}: chunked (chunk {chunk}) vs one-shot prefill last-token logits cos {cos:.6f} "
            f"(>= {want}); one-shot {t1 - t0:.3f} s, chunked {t2 - t1:.3f} s")
        if not (cos >= want and bool(torch.isfinite(last).all())):
            raise AssertionError(f"chunked vs one-shot prefill cos {cos} < {want} ({mode})")
        res[f"chunked_vs_one_shot_{mode}"] = {"cos": cos, "one_shot_s": t1 - t0, "chunked_s": t2 - t1}
        del full
        if mode == "k4v8":
            token = torch.argmax(last, dim=-1).to(torch.int32)
            copy = [{k: v.clone() for k, v in c.items()} for c in caches]
            n_cmp = 16
            graph_toks, caches, wall_ms, replay_ms, _ = graph_decode(model, token, caches, n_cmp, cfg_m)
            t, loop_toks = token, []
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(n_cmp):
                logits, copy = llm.llm_decode_step(model, t, copy, cfg_m)
                t = torch.argmax(logits, dim=-1).to(torch.int32)
                loop_toks.append(t)
            torch.cuda.synchronize()
            loop_ms = (time.perf_counter() - t0) / n_cmp * 1e3
            same_toks = torch.equal(graph_toks, torch.stack(loop_toks, dim=1))
            same_caches = all(torch.equal(c[k], w[k]) for c, w in zip(caches, copy) for k in c)
            log(f"[long] 32K k4v8 graph vs eager loop, {n_cmp} tokens: tokens identical {same_toks}, caches bit-equal "
                f"{same_caches}; graph {wall_ms:.3f} ms/token wall (replay median {statistics.median(replay_ms):.3f}), "
                f"eager loop {loop_ms:.3f} ms/token wall")
            if not (same_toks and same_caches):
                raise AssertionError("the graph decode differs from the eager loop of llm_decode_step")
            res["graph_vs_loop_32k_k4v8"] = {"graph_ms": wall_ms, "replay_ms_median": statistics.median(replay_ms),
                                             "loop_ms": loop_ms}
            del copy
        del caches, last
    del prompt
    torch.cuda.synchronize()
    torch.cuda.empty_cache()

    # The 128K run.
    prompt = torch.randint(0, cfg.vocab, (b, ctx), generator=gen, device="cuda")
    torch.cuda.reset_peak_memory_stats()
    count_reset()
    t0 = time.perf_counter()
    last, caches = llm.llm_prefill_chunked(model, prompt, cfg, chunk=chunk)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    pre = counts()
    token = torch.argmax(last, dim=-1).to(torch.int32)
    count_reset()
    toks, caches, wall_ms, replay_ms, call_s = graph_decode(model, token, caches, n_new, cfg)
    dec = counts()
    d_designs = design_counts("D")
    peak = torch.cuda.max_memory_allocated()
    cache_gb = sum(nbytes(*(c[k] for k in ("k", "v", "k_scale", "v_scale"))) for c in caches) / 1e9
    n_chunks = ctx // chunk
    want_pre = {"A": cfg.depth * (2 * n_chunks - 1), "C1": cfg.depth * n_chunks, "C2": 0, "C3": 0, "D": 0, "E": 0,
                "F1": 0, "F2": 0, "G1": 0, "G2": 0}
    want_dec = {**{k: 0 for k in want_pre}, "D": cfg.depth * n_new}
    log(f"[long] 128K b{b} k4v8: prefill {prefill_s:.3f} s ({n_chunks} chunks of {chunk}), graph decode "
        f"{wall_ms:.3f} ms/token wall over {n_new - 10} replays in one call (single-replay device ms median "
        f"{statistics.median(replay_ms):.3f}, min {min(replay_ms):.3f}, max {max(replay_ms):.3f}; the first call "
        f"{call_s:.2f} s), cache {cache_gb:.2f} GB over {cfg.depth} layers, peak {peak / 2**30:.2f} GiB")
    log(f"[long] launches: prefill {pre} (want {want_pre}), decode {dec} (want {want_dec}), D by design {d_designs}")
    if pre != want_pre or dec != want_dec or d_designs != {"bulk_ring": cfg.depth * n_new}:
        raise AssertionError(f"128K launch counts: {pre} / {dec} / {d_designs}")
    if not (bool(torch.isfinite(last).all()) and bool(((toks >= 0) & (toks < cfg.vocab)).all())
            and int(caches[-1]["length"][0]) == ctx + n_new):
        raise AssertionError("128K: non-finite logits, bad tokens or a wrong cache length")
    # The cache-row slices that each chunk's cross-attention copies (a strided
    # K slice and its scales, which kernel A takes contiguous) and the V rows
    # it dequantizes to bf16, timed once for one layer at every chunk start
    # and counted for every layer.
    c = caches[0]
    copy_ms = dequant_ms = 0.0
    for c0 in range(chunk, ctx, chunk):
        copy_ms += cuda_event_ms(lambda: (c["k"][:, :, :c0].contiguous(), c["k_scale"][:, :, :c0].contiguous()))
        dequant_ms += cuda_event_ms(lambda: llm._dequant_cache_rows(c["v"][:, :, :c0], c["v_scale"][:, :, :c0],
                                                                    cfg.eff_v_bits, torch.bfloat16))
    copy_s, dequant_s = copy_ms * cfg.depth / 1e3, dequant_ms * cfg.depth / 1e3
    log(f"[long] strided K-slice copies {copy_s:.3f} s ({100 * copy_s / prefill_s:.2f}% of the prefill), "
        f"V dequantization {dequant_s:.3f} s ({100 * dequant_s / prefill_s:.2f}%)")
    # One chunk of the prefill under torch.profiler: the last one again (c0
    # = ctx - chunk: the largest cache slice; it rewrites the same rows).
    chunk_ms = profile_classes(lambda: llm._prefill_chunk(model, prompt[:, ctx - chunk:], caches, ctx - chunk, cfg),
                               {"A": ("attn_fwd",), "C1": ("quant_per",), "copy": ("copy",), "GEMM": GEMM_NAMES})[0]
    log(f"[long] the last prefill chunk (c0 {ctx - chunk}) device ms: " +
        ", ".join(f"{k} {v:.2f}" for k, v in chunk_ms.items()) + f"; total {sum(chunk_ms.values()):.2f}")
    cats = cache_step_profile(model, toks[:, -1], caches, cfg)
    log(f"[long] decode step device ms at a {ctx + n_new + 1}-token context, k4v8 cache, dense weights: " +
        ", ".join(f"{k} {v:.3f}" for k, v in cats.items()) + f"; total {sum(cats.values()):.3f}")
    # The two kernels' new shapes on this path, against their plain versions.
    res["A_cross"] = long_prefill_attention_check(model, prompt[:, ctx - chunk:], caches[0], ctx - chunk, cfg)
    res["D"] = long_decode_check(gen, caches[0], cfg)
    # Phase 15's window walk on the same cache.
    res["D_window"] = long_window_decode_check(gen, caches[0], cfg)
    res.update({"prefill_s": prefill_s, "decode_ms_per_token": wall_ms, "replay_ms": replay_ms, "peak_gib": peak / 2**30,
                "cache_gb": cache_gb, "launches_prefill": pre, "launches": dec, "copy_share": copy_s / prefill_s,
                "dequant_share": dequant_s / prefill_s, "profile": cats, "last_chunk_ms": chunk_ms})
    del caches, last, toks, prompt, model
    return res


# ---------------------------------------------------------------------------
# Phase 15: kernel A's masks and kernel D's window walk
# ---------------------------------------------------------------------------

def check_masked(tag, r, prefix="A15"):
    log(f"[{prefix}] {tag}: " + " ".join(f"{k}={v:.6g}" if isinstance(v, float) else f"{k}={v}" for k, v in r.items()))
    if not (r["finite"] and r["cos"] >= COS_MIN and r["max_do"] <= MAX_DO and r["max_dlse"] <= MAX_DLSE
            and r["empty_ok"] and r.get("same_bits_twice", True) and r.get("on_design", True)):
        raise AssertionError(f"kernel A's masks disagree with the plain version ({tag}): {r}")


def mask_edge_phase(gen):
    """Kernel A's masks in every mode at its edges (the grid of
    utils/mask_cases.py, which the card tests run too), GQA 4q/2kv, against
    attention_fwd_plain (which walks the same KV tiles) at phase 4's bounds;
    rows that see no key o = 0 and lse -1e30; the same bits twice; every
    launch on the wgmma design."""
    from lowbit_quant_fa2_paddle_tpu_torch.ops.attention import attention_fwd_plain, lowbit_attention
    from lowbit_quant_fa2_paddle_tpu_torch.utils import mask_cases

    n_cases = 0
    for mode in mask_cases.MODES:
        worst = {"cos": 1.0, "max_do": 0.0, "max_dlse": 0.0}
        for edge in mask_cases.EDGES:
            case = mask_cases.make_case(mode, edge, gen, "cuda")
            n = lowbit_attention.launches_by_design["wgmma"]
            o, lse = lowbit_attention(*case["args"], **case["kw"], return_lse=True)
            o2, lse2 = lowbit_attention(*case["args"], **case["kw"], return_lse=True)
            o_ref, lse_ref = attention_fwd_plain(*case["plain_args"], **case["plain_kw"])
            torch.cuda.synchronize()
            r = mask_cases.masked_stats(o, lse, o_ref, lse_ref)
            r["same_bits_twice"] = torch.equal(o, o2) and torch.equal(lse, lse2)
            r["on_design"] = lowbit_attention.launches_by_design["wgmma"] == n + 2
            r["empty_ok"] = r["empty_ok"] and r["empty_rows"] == case["empty_rows"]
            check_masked(f"{mode}, {edge}", r)
            worst = {"cos": min(worst["cos"], r["cos"]), "max_do": max(worst["max_do"], r["max_do"]),
                     "max_dlse": max(worst["max_dlse"], r["max_dlse"])}
            n_cases += 1
        log(f"[A15] masks, {mode}: {len(mask_cases.EDGES)} edges, worst cos={worst['cos']:.6g} "
            f"max_do={worst['max_do']:.4g} max_dlse={worst['max_dlse']:.4g}, empty rows 0 / -1e30, same bits twice, "
            f"every launch on wgmma")
    return n_cases


def visible_pairs(s_q, s_k, causal=True, window=0, sink=0, q_offset=0, cu=None):
    """(q, k) pairs kernel A's masks leave visible, per head: causal within
    the window (r - window, r] and the sinks [0, sink); with ``cu``, causal
    within each segment."""
    if cu is not None:
        return sum((b - a) * (b - a + 1) // 2 if causal else (b - a) ** 2 for a, b in zip(cu[:-1], cu[1:]))
    if not causal:
        return s_q * s_k
    p = torch.arange(s_q, dtype=torch.int64) + q_offset
    hi = p.clamp(max=s_k - 1)
    lo = (p - window + 1).clamp(min=0) if window else torch.zeros_like(p)
    n = (hi - lo + 1).clamp(min=0)
    if window and sink:
        n = n + torch.minimum(torch.full_like(p, sink), lo).clamp(min=0).minimum(hi + 1)
    return int(n.sum())


def a_record(name, call, plain, pairs, h, d, mode, byte_tensors, out_bytes, library=None, prefix="A15",
             library_backend="efficient"):
    """Kernel A on one windowed/segmented/capped call: the same bits twice,
    against the plain version at phase 4's bounds, timed beside the plain
    version (one call between CUDA events) and a library call where one
    computes the same function (under SDPA's memory-efficient backend, or
    its own dispatch with ``library_backend`` None); bound: 4·D operations per visible pair (QK in int8
    for the int8 modes, PV in bf16, or in int8 for "int8-PV") and the bytes
    of its inputs and output."""
    from lowbit_quant_fa2_paddle_tpu_torch.ops.attention import lowbit_attention
    from lowbit_quant_fa2_paddle_tpu_torch.utils import mask_cases
    from lowbit_quant_fa2_paddle_tpu_torch.utils.benchmark import cuda_time_ms, tflops

    n = lowbit_attention.launches_by_design["wgmma"]
    o, lse = call(True)
    o2, lse2 = call(True)
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    o_ref, lse_ref = plain()
    b.record()
    b.synchronize()
    plain_ms = a.elapsed_time(b)
    r = mask_cases.masked_stats(o, lse, o_ref, lse_ref)
    r["same_bits_twice"] = torch.equal(o, o2) and torch.equal(lse, lse2)
    r["on_design"] = lowbit_attention.launches_by_design["wgmma"] == n + 2
    check_masked(name, r, prefix)
    del o, o2, lse, lse2, o_ref, lse_ref
    ms = cuda_time_ms(lambda: call(False), warmup=2, reps=10)
    flops = 4 * d * pairs * h
    ops = {"bf16": flops} if mode == "fp" else {"int8": flops} if mode == "int8-PV" else {
        "int8": flops // 2, "bf16": flops // 2}
    lim = bound(nbytes(*byte_tensors) + out_bytes, ops)
    library_ms = None
    if library is not None and library_backend is None:
        library_ms = cuda_time_ms(library, warmup=1, reps=3)
    elif library is not None:  # with a mask: SDPA's math backend would materialise [B, H, S, S]
        with torch.nn.attention.sdpa_kernel(torch.nn.attention.SDPBackend.EFFICIENT_ATTENTION):
            library_ms = cuda_time_ms(library, warmup=1, reps=3)
    log(f"[{prefix}] {name}: kernel {ms:.3f} ms ({tflops(flops, ms / 1e3):.1f} TFLOP/s over {pairs * h:.4g} visible "
        f"pairs), plain {plain_ms:.3f} ms, bound {lim['bound_ms']:.4f} ms ({lim['bound_by']}, "
        f"{lim['bound_ms'] / ms:.1%} of it), exp2 floor {exp_floor_ms(pairs * h):.4f} ms, library {library_ms}")
    return {"max_abs_err": r["max_do"], "ms": ms, "plain_ms": plain_ms, **lim, "library_ms": library_ms,
            "exp_floor_ms": exp_floor_ms(pairs * h), "design": "wgmma"}


def band_mask(s, window=0, sink=0, cu=None):
    """The boolean [S, S] mask of a causal window with sinks (or of causal
    segments), for SDPA's attn_mask (True: visible)."""
    r = torch.arange(s, device="cuda")[:, None]
    c = torch.arange(s, device="cuda")[None, :]
    m = c <= r
    if window:
        m &= (c + window > r) | (c < sink)
    if cu is not None:
        seg = torch.searchsorted(torch.tensor(cu[1:], device="cuda"), torch.arange(s, device="cuda"), right=True)
        m &= seg[:, None] == seg[None, :]
    return m


def window_attention_phase(gen):
    """Kernel A with the band at bench/window_bench.py's prefill shape, b4
    h32 s32768 d64 causal, int8 (K codes from C1 with its mean, Q quantized
    in the kernel): full, window 4096, window 1024, window 1024 + sink 128,
    and fp at window 4096 beside SDPA with the boolean band mask; the window
    LLM's prefill shape (b4 h32 hk8 s32704 d128, window 4096, with and
    without 4 sinks); the varlen entry at b1 h32 d128 over 32,768 ragged
    tokens; the logit cap at the DiT shape. Each against the plain version
    on all of its inputs (the int8 rows one batch row at a time, as phase
    14 does) and timed."""
    from lowbit_quant_fa2_paddle_tpu_torch import core
    from lowbit_quant_fa2_paddle_tpu_torch.ops.attention import LOG2E, attention_fwd_plain, lowbit_attention
    from lowbit_quant_fa2_paddle_tpu_torch.ops.quant import k_mean, quant_int8
    from lowbit_quant_fa2_paddle_tpu_torch.utils import mask_cases
    from lowbit_quant_fa2_paddle_tpu_torch.utils.benchmark import cuda_time_ms

    rec = {}

    def int8_rows(b, h, hk, s, d, cases, tag):
        q = torch.randn(b, h, s, d, generator=gen, device="cuda").bfloat16()
        k = (torch.randn(b, hk, s, d, generator=gen, device="cuda") + 0.3).bfloat16()
        v = torch.randn(b, hk, s, d, generator=gen, device="cuda").bfloat16()
        kc, ks = quant_int8(k, k_mean(k), gran="per_token")
        c = 1.0 / math.sqrt(d) * LOG2E
        for key, (window, sink) in cases.items():
            kw = dict(is_causal=True, window_size=window, sink_size=sink)
            masks = mask_cases.plain_masks(True, s, kw)
            name = f"int8 {key}; {tag}"
            rows = lambda masks=masks: (  # noqa: E731
                attention_fwd_plain(q[i : i + 1], kc[i : i + 1], v[i : i + 1], None, ks[i : i + 1], None, causal=True,
                                    sm_scale_log2e=c, out_dtype=torch.bfloat16, **masks) for i in range(b))
            rec[name] = a_record(
                name, lambda lse, kw=kw: lowbit_attention(q, kc, v, None, ks, **kw, return_lse=lse),
                lambda rows=rows: tuple(torch.cat(x) for x in zip(*rows())),
                visible_pairs(s, s, True, masks["window"], masks["sink"]), b * h, d, "int8", (q, kc, ks, v),
                b * h * s * d * 2)
        del q, k, v, kc, ks

    bench = "b4 h32 s32768 d64 causal"
    int8_rows(4, 32, 32, 32768, 64, {"full causal": (None, 0), "window 4096": (4096, 0), "window 1024": (1024, 0),
                                      "window 1024 + sink 128": (1024, 128)}, bench)
    int8_rows(4, 32, 8, 32704, 128, {"window 4096": (4096, 0), "window 4096 + sink 4": (4096, 4)},
              "window LLM prefill b4 h32 hk8 s32704 d128 causal")
    # fp at window 4096 beside SDPA with the boolean band mask (one call fits in memory).
    b, h, s, d = 4, 32, 32768, 64
    q, k, v = (torch.randn(b, h, s, d, generator=gen, device="cuda").bfloat16() for _ in range(3))
    kw = dict(is_causal=True, window_size=4096)
    masks = mask_cases.plain_masks(True, s, kw)
    c = 1.0 / math.sqrt(d) * LOG2E
    band = band_mask(s, 4096)
    plain = lambda: attention_fwd_plain(q, k, v, None, None, None, causal=True, sm_scale_log2e=c,  # noqa: E731
                                        out_dtype=torch.bfloat16, **masks)
    name = f"fp window 4096; {bench}"
    rec[name] = a_record(name, lambda lse: lowbit_attention(q, k, v, **kw, return_lse=lse), plain,
                         visible_pairs(s, s, True, 4096), b * h, d, "fp", (q, k, v), b * h * s * d * 2,
                         library=lambda: torch.nn.functional.scaled_dot_product_attention(q, k, v, attn_mask=band))
    del q, k, v, band
    torch.cuda.empty_cache()
    # The varlen entry: b1 h32 d128, 32,768 tokens in ragged causal sequences.
    cu = [0, 1000, 9000, 9001, 20000, 32768]
    h, t, d = 32, 32768, 128
    q, k, v = (torch.randn(t, h, d, generator=gen, device="cuda").bfloat16() for _ in range(3))
    cu_t = torch.tensor(cu, dtype=torch.int32, device="cuda")
    count_reset()
    o_entry = core.lowbit_fa_varlen(q, k, v, cu_t, cu_t, is_causal=True)
    varlen_launches = counts()
    if varlen_launches["A"] != 1 or varlen_launches["C1"] != 1 or design_counts() != {"wgmma": 1}:
        raise AssertionError(f"lowbit_fa_varlen launches {varlen_launches} (want one C1 and one A on wgmma)")
    entry_ms = cuda_time_ms(lambda: core.lowbit_fa_varlen(q, k, v, cu_t, cu_t, is_causal=True), warmup=2, reps=10)
    qh, kh, vh = (x.transpose(0, 1)[None] for x in (q, k, v))
    kc, ks = quant_int8(kh, k_mean(kh), gran="per_token")
    seg = torch.searchsorted(cu_t[1:].contiguous(), torch.arange(t, device="cuda", dtype=torch.int32),
                             right=True).to(torch.int32)[None]
    kw = dict(is_causal=True, q_segment_ids=seg, kv_segment_ids=seg)
    masks = mask_cases.plain_masks(True, t, kw)
    c = 1.0 / math.sqrt(d) * LOG2E
    plain = lambda: attention_fwd_plain(qh, kc, vh, None, ks, None, causal=True, sm_scale_log2e=c,  # noqa: E731
                                        out_dtype=torch.bfloat16, **masks)
    seg_mask = band_mask(t, cu=cu)
    name = "int8 segment ids (varlen, 5 sequences of 1-11,000 tokens); b1 h32 s32768 d128 causal"
    rec[name] = a_record(name, lambda lse: lowbit_attention(qh, kc, vh, None, ks, **kw, return_lse=lse), plain,
                         visible_pairs(t, t, True, cu=cu), h, d, "int8", (q, kc, ks, v, seg), t * h * d * 2,
                         library=lambda: torch.nn.functional.scaled_dot_product_attention(qh, kh, vh,
                                                                                           attn_mask=seg_mask))
    rec[name]["launches"] = varlen_launches["A"]
    rec[name]["entry_ms"] = entry_ms
    # The entry quantizes K as above and hands kernel A the same call: the same bits.
    same = torch.equal(o_entry, lowbit_attention(qh, kc, vh, None, ks, **kw)[0].transpose(0, 1))
    log(f"[A15] lowbit_fa_varlen entry (C1 + A): {entry_ms:.3f} ms; its output the same bits as the kernel call "
        f"checked above: {same}")
    if not same:
        raise AssertionError("lowbit_fa_varlen's output differs from kernel A's on the same codes")
    del q, k, v, qh, kh, vh, kc, ks, seg_mask, o_entry
    torch.cuda.empty_cache()
    # The logit cap at the DiT shape (Gemma 2's attention cap, 50).
    h, s, d = H, S, D
    q = torch.randn(1, h, s, d, generator=gen, device="cuda").bfloat16()
    k = (torch.randn(1, h, s, d, generator=gen, device="cuda") + 0.3).bfloat16()
    v = torch.randn(1, h, s, d, generator=gen, device="cuda").bfloat16()
    kc, ks = quant_int8(k, k_mean(k), gran="per_token")
    c = 1.0 / math.sqrt(d) * LOG2E
    plain = lambda: attention_fwd_plain(q, kc, v, None, ks, None, causal=False, sm_scale_log2e=c,  # noqa: E731
                                        out_dtype=torch.bfloat16, logit_cap=50.0)
    name = f"int8 logit cap 50; DiT shape b1 h{h} s{s} d{d}"
    rec[name] = a_record(name, lambda lse: lowbit_attention(q, kc, v, None, ks, logit_cap=50.0, return_lse=lse),
                         plain, s * s, h, d, "int8", (q, kc, ks, v), h * s * d * 2)
    del q, k, v, kc, ks
    return rec


#: Kernel D's windowed modes in phase 15: (k_bits, v_bits, compute_mode).
WINDOW_DECODE_MODES = {"int8 cache": (8, 8, "auto"), "int8 cache, float chain": (8, 8, "f32"),
                       "bf16 cache": (16, 16, "auto"), "k4v8 cache": (4, 8, "auto"),
                       "k4v8 cache, integer chain": (4, 8, "int_qk")}


def window_decode_record(tag, q, kq, vq, ks, vs, lens, k_bits, v_bits, chain, window, sink):
    """Kernel D with a window (and sinks) against its plain version at phase
    9's bounds, the same bits twice, every launch on its design; timed beside
    the plain version; bound: the bytes of the rows it reads. For a bf16
    cache, SDPA with one query a head and a boolean window mask is the
    library call."""
    from lowbit_quant_fa2_paddle_tpu_torch.ops import decode as DD
    from lowbit_quant_fa2_paddle_tpu_torch.utils.benchmark import cuda_time_ms

    b, h, d = q.shape
    hk, s_max = kq.shape[1], kq.shape[2]
    kw = dict(v_scale=vs, k_bits=k_bits, v_bits=v_bits, compute_mode=chain, window_size=window, sink_size=sink)
    pkw = dict(sm_scale=1.0 / math.sqrt(d), int_qk=k_bits == 8 and chain != "f32" or chain == "int_qk",
               out_dtype=q.dtype, window=window, sink=sink)
    vs_p = vs if v_bits != 16 else None
    n = DD.decode_attention.launches_by_design[DD.kernel_design()]
    o, lse = DD.decode_attention(q, kq, vq, ks, lens, **kw, return_lse=True)
    o2, lse2 = DD.decode_attention(q, kq, vq, ks, lens, **kw, return_lse=True)
    o_ref, lse_ref = DD.decode_attention_plain(q, kq, vq, ks, vs_p, lens, **pkw)
    torch.cuda.synchronize()
    r = stats(o, o_ref, lse, lse_ref)
    ulp = bf16_ulp(float(o_ref.float().abs().max()))
    same = torch.equal(o, o2) and torch.equal(lse, lse2)
    on_design = DD.decode_attention.launches_by_design[DD.kernel_design()] == n + 2
    log(f"[D15] {tag} (lengths {lens.tolist()}): " +
        " ".join(f"{k}={v:.6g}" if isinstance(v, float) else f"{k}={v}" for k, v in r.items()) +
        f" bf16_ulp={ulp:.3g} same_bits_twice={same} design={DD.kernel_design()}:{on_design}")
    if not (r["finite"] and r["cos"] >= COS_MIN and r["max_do"] <= ulp and r["max_dlse"] <= 1e-4 and same
            and on_design):
        raise AssertionError(f"kernel D's window walk disagrees with its plain version ({tag}): {r}")
    del o, o2, o_ref
    ms = cuda_time_ms(lambda: DD.decode_attention(q, kq, vq, ks, lens, **kw), warmup=5, reps=50)
    plain_ms = cuda_time_ms(lambda: DD.decode_attention_plain(q, kq, vq, ks, vs_p, lens, **pkw), warmup=1, reps=3)
    length = lens.long().clamp(max=s_max)
    rows = int((length.clamp(max=window) + (length - window).clamp(min=0).clamp(max=sink)).sum())
    # K and V rows (packed, int8 or bf16), K's scale (read for every cache) and a quantized V's.
    row_bytes = (d // 2 if k_bits == 4 else d * (2 if k_bits == 16 else 1)) + d * (2 if v_bits == 16 else 1) + 4
    row_bytes += 4 if v_bits != 16 else 0
    lim = bound(hk * rows * row_bytes + nbytes(q, lens) * 2)
    library_ms = None
    if k_bits == 16:
        pos = torch.arange(s_max, device="cuda")[None, :]
        vis = (pos < length.cuda()[:, None]) & ((pos >= length.cuda()[:, None] - window) | (pos < sink))
        vis = vis[:, None, None, :]
        q4 = q[:, :, None]
        library_ms = cuda_time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
            q4, kq, vq, attn_mask=vis, enable_gqa=True), warmup=3, reps=20)
    log(f"[D15] {tag}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {lim['bound_ms']:.4f} ms "
        f"({rows} rows a KV head; {lim['bound_ms'] / ms:.1%} of it), library {library_ms}")
    return {"max_abs_err": r["max_do"], "ms": ms, "plain_ms": plain_ms, **lim, "library_ms": library_ms,
            "design": DD.kernel_design()}


def window_decode_phase(gen):
    """Kernel D's window walk at b4 h32 hk8 S_max 32768 d128 (window 4096;
    + 4 and + 128 sinks), int8 (both chains), bf16 and k4v8 (both chains):
    checked at lengths below the window, at and inside a tile edge and
    full, then timed at full length."""
    from lowbit_quant_fa2_paddle_tpu_torch.ops.decode import quantize_token

    b, h, hk, d, s = 4, 32, 8, 128, 32768
    k = torch.randn(b, hk, s, d, generator=gen, device="cuda").bfloat16()
    v = torch.randn(b, hk, s, d, generator=gen, device="cuda").bfloat16()
    q = torch.randn(b, h, d, generator=gen, device="cuda").bfloat16()
    check = torch.tensor([32768, 30001, 4160, 100], dtype=torch.int32, device="cuda")
    full = torch.full((b,), s, dtype=torch.int32, device="cuda")
    rec = {}
    for mode, (k_bits, v_bits, chain) in WINDOW_DECODE_MODES.items():
        (kq, ks), (vq, vs) = quantize_token(k, bits=k_bits), quantize_token(v, bits=v_bits)
        sinks = (0, 4, 128) if mode == "int8 cache" else (0, 128)
        for sink in sinks:
            tag = f"{mode}, window 4096{f' + sink {sink}' if sink else ''}"
            window_decode_record(f"{tag}, check", q, kq, vq, ks, vs, check, k_bits, v_bits, chain, 4096, sink)
            rec[tag] = window_decode_record(f"{tag}, b{b} h{h} hk{hk} d{d} S_max {s}", q, kq, vq, ks, vs, full,
                                            k_bits, v_bits, chain, 4096, sink)
        del kq, vq, ks, vs
    return rec


def long_window_decode_check(gen, cache, cfg):
    """Kernel D's window walk on layer 0's 128K k4v8 cache (window 8192,
    with and without 128 sinks, both QK chains), against the plain version
    and timed beside the full walk (long_decode_check's)."""
    q = torch.randn(cache["k"].shape[0], cfg.num_heads, cfg.head_dim, generator=gen, device="cuda").bfloat16()
    rec = {}
    for sink in (0, 128):
        for chain in ("auto", "int_qk"):
            chain_tag = ", integer chain" if chain == "int_qk" else ""
            tag = f"k4v8 cache{chain_tag}, window 8192{f' + sink {sink}' if sink else ''}"
            rec[tag] = window_decode_record(f"{tag} on layer 0's 128K cache", q, cache["k"], cache["v"],
                                            cache["k_scale"], cache["v_scale"], cache["length"], 4, 8, chain, 8192,
                                            sink)
    return rec


def window_llm_phase(model, full_logits):
    """The sliding-window LLM at full width: phase 13's model with
    window_size 4096 (Mistral-7B-v0.1's sliding_window), b4, its
    32,704-token prompt, llm_prefill then 32 tokens through decode_tokens,
    with the int8 and the bf16 cache, then int8 with StreamingLLM's 4 sinks.
    Checks: depth A (wgmma) and C1 (vector) per prefill and depth x tokens D
    launches (bulk_ring); the first decode step's logits int8 vs bf16 cache
    cos >= 0.999; on the int8 run 16 graph tokens against the eager loop
    from cloned caches (the same tokens, bit-equal caches). Records prefill
    seconds, ms per token, peak memory, one profiled decode step, and the
    windowed vs full-causal first-step logits cos (no bound)."""
    from lowbit_quant_fa2_paddle_tpu_torch.models import llm
    from lowbit_quant_fa2_paddle_tpu_torch.ops.metrics import cosine_similarity

    b, prompt_len, n_new = 4, 32704, 32
    gen = torch.Generator(device="cuda").manual_seed(0)
    base = model.cfg
    prompt = torch.randint(0, base.vocab, (b, prompt_len), generator=gen, device="cuda")
    res = {}
    for mode, bits, sink in (("int8", 8, 0), ("bf16", 16, 0), ("int8 sink 4", 8, 4)):
        cfg = dataclasses.replace(base, max_seq=32768, kv_bits=bits, window_size=4096, sink_size=sink)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        first = FirstLogits(model)
        count_reset()
        t0 = time.perf_counter()
        logits, caches = llm.llm_prefill(model, prompt, cfg)
        token = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
        del logits
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
        pre, pre_designs = counts(), (design_counts("A"), design_counts("C1"))
        cmp = None
        if mode == "int8":
            copy = [{k: v.clone() for k, v in c.items()} for c in caches]
            graph_toks, caches, _, _, _ = graph_decode(model, token, caches, 16, cfg)
            t, loop_toks = token, []
            for _ in range(16):
                step_logits, copy = llm.llm_decode_step(model, t, copy, cfg)
                t = torch.argmax(step_logits, dim=-1).to(torch.int32)
                loop_toks.append(t)
            same_toks = torch.equal(graph_toks, torch.stack(loop_toks, dim=1))
            same_caches = all(torch.equal(c[k], w[k]) for c, w in zip(caches, copy) for k in c)
            log(f"[llm15] window 4096 int8: 16 graph tokens vs the eager loop: tokens identical {same_toks}, caches "
                f"bit-equal {same_caches}")
            if not (same_toks and same_caches):
                raise AssertionError("the windowed graph decode differs from the eager loop of llm_decode_step")
            cmp = {"tokens_identical": same_toks, "caches_bit_equal": same_caches}
            del copy, graph_toks
            token = t
        count_reset()
        steps, caches, wall_ms, replay_ms, call_s = graph_decode(model, token, caches, n_new, cfg)
        dec = counts()
        peak = torch.cuda.max_memory_allocated()
        first.remove()
        d_designs = design_counts("D")
        want_pre = {**{k: 0 for k in pre}, "A": cfg.depth, "C1": cfg.depth}
        want_dec = {**{k: 0 for k in pre}, "D": cfg.depth * n_new}
        log(f"[llm15] window 4096{f' + sink {sink}' if sink else ''}, {'bf16' if bits == 16 else 'int8'} cache: "
            f"prefill {prefill_s:.3f} s, graph decode {wall_ms:.3f} ms/token wall over {n_new - 10} replays "
            f"(single-replay device ms median {statistics.median(replay_ms):.3f}, min {min(replay_ms):.3f}, max "
            f"{max(replay_ms):.3f}; the first call {call_s:.2f} s), peak {peak / 2**30:.2f} GiB; launches prefill "
            f"{pre} "
            f"(want {want_pre}), decode {dec} (want {want_dec}), D by design {d_designs}")
        if (pre != want_pre or dec != want_dec or d_designs != {"bulk_ring": cfg.depth * n_new}
                or pre_designs != ({"wgmma": cfg.depth}, {"vector": cfg.depth, "scalar": 0})):
            raise AssertionError(f"window LLM launch counts: {pre} / {dec} / {d_designs} / {pre_designs}")
        if not (bool(((steps >= 0) & (steps < cfg.vocab)).all()) and first.logits is not None
                and bool(torch.isfinite(first.logits).all())):
            raise AssertionError("window LLM: bad tokens or non-finite first-step logits")
        res[mode] = {"prefill_s": prefill_s, "decode_ms_per_token": wall_ms, "replay_ms": replay_ms,
                     "peak_gib": peak / 2**30, "launches_prefill": pre, "launches": dec, "graph_vs_loop": cmp,
                     "logits": first.logits}
        if mode == "int8":
            cats = cache_step_profile(model, steps[:, -1], caches, cfg)
            res[mode]["profile"] = cats
            log(f"[llm15] window 4096 int8 decode step device ms at a {prompt_len + 16 + n_new + 1}-token context: " +
                ", ".join(f"{k} {v:.3f}" for k, v in cats.items()) + f"; total {sum(cats.values()):.3f} "
                f"(D {cats['D'] / sum(cats.values()):.1%})")
        del caches, steps, first
    cos = float(cosine_similarity(res["int8"]["logits"], res["bf16"]["logits"]))
    vs_full = float(cosine_similarity(res["int8"]["logits"], full_logits))
    sink_vs = float(cosine_similarity(res["int8 sink 4"]["logits"], res["int8"]["logits"]))
    log(f"[llm15] first decode step logits: window int8 vs bf16 cache cos {cos:.6f} (>= 0.999); window vs full "
        f"causal (phase 13, int8) cos {vs_full:.6f}; sink 4 vs none cos {sink_vs:.6f} (no bound)")
    if cos < 0.999:
        raise AssertionError(f"window LLM int8 vs bf16 cache first-step logits cos {cos} < 0.999")
    for mode in res:
        del res[mode]["logits"]
    res.update({"cos_int8_bf16": cos, "cos_window_vs_full": vs_full, "cos_sink_vs_none": sink_vs})
    return res


# ---------------------------------------------------------------------------
# Phase 16: kernel D's multi-token (verify) and INT8-PV modes, speculative decoding
# ---------------------------------------------------------------------------

SPEC_T = (1, 2, 4, 8)


def spec_record(tag, q, kq, vq, ks, vs, lens, k_bits, v_bits, mode, kv_bf16=None, prefix="D16"):
    """Kernel D over ``q [B, T, H, D]`` against its plain version on the
    kernel's own tiles at phase 9's bounds, the same bits twice, every
    launch on its design; timed beside the plain version and, given the
    cache's bf16 K/V (``kv_bf16``), beside SDPA with T queries a head and the
    causal tail mask (a baseline: SDPA reads the bf16 cache, not the
    kernel's). Bound: the cache rows the call reads, once, whatever T."""
    from lowbit_quant_fa2_paddle_tpu_torch.ops import decode as DD
    from lowbit_quant_fa2_paddle_tpu_torch.utils.benchmark import cuda_time_ms

    b, t, h, d = q.shape
    hk, s_max = kq.shape[1], kq.shape[2]
    int_qk = k_bits != 16 and (mode in ("int", "int_qk") or (mode == "auto" and k_bits == 8))
    int_pv = mode == "int" and v_bits == 8
    kw = dict(v_scale=vs, k_bits=k_bits, v_bits=v_bits, compute_mode=mode)
    plan = DD.kernel_partition(q, kq, vq, int_qk=int_qk, int_pv=int_pv)
    pkw = dict(sm_scale=1.0 / math.sqrt(d), int_qk=int_qk, out_dtype=q.dtype, int_pv=int_pv,
               split_keys=plan["split_keys"], warps=plan["warps"])
    vs_p = vs if v_bits != 16 else None
    variant = DD.launch_variant(plan["multi"], t, k_bits, v_bits, b)
    n = DD.decode_attention.launches_by_design[DD.kernel_design()]
    n_variant = DD.decode_attention.launches_by_variant.get(variant, 0)
    o, lse = DD.decode_attention(q, kq, vq, ks, lens, **kw, return_lse=True)
    o2, lse2 = DD.decode_attention(q, kq, vq, ks, lens, **kw, return_lse=True)
    o_ref, lse_ref = DD.decode_attention_plain(q, kq, vq, ks, vs_p, lens, **pkw)
    torch.cuda.synchronize()
    r = stats(o, o_ref, lse, lse_ref)
    ulp = bf16_ulp(float(o_ref.float().abs().max()))
    same = torch.equal(o, o2) and torch.equal(lse, lse2)
    on_design = (DD.decode_attention.launches_by_design[DD.kernel_design()] == n + 2
                 and DD.decode_attention.launches_by_variant.get(variant, 0) == n_variant + 2)
    log(f"[{prefix}] {tag} (lengths {lens.tolist()}; {plan['rows']} rows a CTA, {plan['row_groups'] // hk} CTAs a KV "
        f"head and split, {plan['n_splits']} splits of {plan['split_keys']} keys): " +
        " ".join(f"{k}={v:.6g}" if isinstance(v, float) else f"{k}={v}" for k, v in r.items()) +
        f" bf16_ulp={ulp:.3g} same_bits_twice={same} design={DD.kernel_design()}, {variant}:{on_design}")
    if not (r["finite"] and r["cos"] >= COS_MIN and r["max_do"] <= ulp and r["max_dlse"] <= 1e-4 and same
            and on_design):
        raise AssertionError(f"kernel D ({tag}) disagrees with its plain version: {r}")
    del o, o2, o_ref
    ms = cuda_time_ms(lambda: DD.decode_attention(q, kq, vq, ks, lens, **kw), warmup=5, reps=50)
    plain_ms = cuda_time_ms(lambda: DD.decode_attention_plain(q, kq, vq, ks, vs_p, lens, **pkw), warmup=1, reps=3)
    cache_bytes = nbytes(kq, vq, ks, vs_p) * int(lens.clamp(max=s_max).sum()) // (b * s_max)
    lim = bound(cache_bytes + nbytes(q, lens) + nbytes(q))  # q and lengths read, o written
    library_ms = None
    if kv_bf16 is not None:
        k16, v16 = kv_bf16
        pos = torch.arange(s_max, device="cuda")
        tail = pos[None, :] <= (s_max - t + torch.arange(t, device="cuda"))[:, None]  # [T, S]
        q4 = q.transpose(1, 2)
        library_ms = cuda_time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
            q4, k16, v16, attn_mask=tail, enable_gqa=True), warmup=3, reps=20)
    gbps = cache_bytes / (ms * 1e-3) / 1e9
    log(f"[{prefix}] {CARD}: {tag}: kernel {ms:.4f} ms ({gbps:.1f} GB/s of {cache_bytes / 1e6:.1f} MB cache), plain "
        f"{plain_ms:.4f} ms, bound {lim['bound_ms']:.4f} ms ({lim['bound_ms'] / ms:.1%} of it), SDPA on the bf16 "
        f"cache {library_ms}")
    return {"max_abs_err": r["max_do"], "ms": ms, "plain_ms": plain_ms, **lim, "library_ms": library_ms,
            "gbps": gbps, "design": DD.kernel_design(), "variant": variant}


def spec_kernel_phase(gen):
    """Phase 16, kernels: the edge grid of utils/decode_cases.py (T rows
    straddling a tile and a split, a window whose band start moves with t,
    lengths below T + window, INT8 PV with all-masked tiles) at phase 9's
    bounds; then D over T = 1, 2, 4, 8 tokens at b1 and b4 (h32 hk8 S_max
    32768 d128, int8 cache, every length 32768) beside SDPA on the bf16
    cache with the causal tail mask; INT8 PV against "auto" at b4 (T 1 and
    4); T 4 at b4 with lengths 4-131; the draft's int4 cache at b1, one
    token."""
    from lowbit_quant_fa2_paddle_tpu_torch.ops.decode import quantize_token
    from lowbit_quant_fa2_paddle_tpu_torch.utils import decode_cases

    # Phase 18 runs the d256 ones, phase 25 those above 256.
    for name in (n for n, c in decode_cases.CASES.items() if not n.startswith("d256-") and c[3] <= 256):
        r = decode_cases.check_case(name, gen)
        log(f"[D16] edge {name}: " + " ".join(f"{k}={v:.6g}" if isinstance(v, float) else f"{k}={v}"
                                              for k, v in r.items()))
        if not r["ok"]:
            raise AssertionError(f"kernel D's edge case {name} disagrees with its plain version: {r}")
    h, hk, d, s = 32, 8, 128, 32768
    k = torch.randn(4, hk, s, d, generator=gen, device="cuda").bfloat16()
    v = torch.randn(4, hk, s, d, generator=gen, device="cuda").bfloat16()
    (kq, ks), (vq, vs) = quantize_token(k, bits=8), quantize_token(v, bits=8)
    rec = {}
    for b in (1, 4):
        lens = torch.full((b,), s, dtype=torch.int32, device="cuda")
        for t in SPEC_T:
            q = torch.randn(b, t, h, d, generator=gen, device="cuda").bfloat16()
            rec[f"int8 T{t} b{b}"] = spec_record(f"int8 cache, T {t}, b{b} h{h} hk{hk} S_max {s} d{d}", q, kq[:b],
                                                 vq[:b], ks[:b], vs[:b], lens, 8, 8, "auto", (k[:b], v[:b]))
            if b == 4 and t in (1, 4):
                rec[f"int8 INT8 PV T{t} b{b}"] = spec_record(
                    f"int8 cache, INT8 PV, T {t}, b{b} h{h} hk{hk} S_max {s} d{d}", q, kq, vq, ks, vs, lens, 8, 8,
                    "int")
                log(f"[D16] {CARD}: INT8 PV vs auto, T {t} b{b}: {rec[f'int8 INT8 PV T{t} b{b}']['ms']:.4f} ms vs "
                    f"{rec[f'int8 T{t} b{b}']['ms']:.4f} ms")
    # T 4 at the same shape with short lengths: a key more or less in a row
    # (an off-by-one of a row's limit) moves o far past the bound, which a
    # length of 32768 would hide.
    lens = torch.tensor([4, 9, 66, 131], dtype=torch.int32, device="cuda")
    q = torch.randn(4, 4, h, d, generator=gen, device="cuda").bfloat16()
    rec["int8 T4 b4, lengths 4-131"] = spec_record(f"int8 cache, T 4, b4 h{h} hk{hk} S_max {s} d{d}, lengths 4-131",
                                                  q, kq, vq, ks, vs, lens, 8, 8, "auto")
    del kq, vq, ks, vs
    (kq, ks), (vq, vs) = quantize_token(k[:1], bits=4), quantize_token(v[:1], bits=4)
    q = torch.randn(1, 1, h, d, generator=gen, device="cuda").bfloat16()
    lens = torch.full((1,), s, dtype=torch.int32, device="cuda")
    rec["int4 T1 b1"] = spec_record(f"int4 cache (the drafts'), T 1, b1 h{h} hk{hk} S_max {s} d{d}", q, kq, vq, ks,
                                    vs, lens, 4, 4, "auto")
    return rec


def spec_variants(cfg, draft_cfg, stats):
    """Kernel D's launches by variant in one speculative_generate of one
    sequence: a verify step of k drafts runs the target's layers on the
    T-token kernel at T = k (the single-token kernel at k = 1), each drafted
    token the draft's layers on the single-token kernel."""
    from lowbit_quant_fa2_paddle_tpu_torch.ops.decode import launch_variant

    want = {}
    steps = [(0, 1, draft_cfg, sum(stats["k_per_round"]))] + [(int(k > 1), k, cfg, 1) for k in stats["k_per_round"]]
    for multi, t, c, n in steps:
        key = launch_variant(multi, t, c.eff_k_bits, c.eff_v_bits, 1)
        want[key] = want.get(key, 0) + c.depth * n
    return {k: n for k, n in want.items() if n}


def check_spec_counts(where, got, variants, cfg, draft_cfg, stats, f2_per_token=0):
    """The launches of one speculative_generate: A and C1 once a layer of
    each prefill, D once a layer of the target a verify step and once a
    layer of the draft a drafted token, each on its variant
    (``spec_variants``), F2 ``f2_per_token`` a drafted token (a w4 draft)."""
    depth, draft_depth = cfg.depth, draft_cfg.depth
    drafted = sum(stats["k_per_round"])
    want = {"A": depth + draft_depth, "C1": depth + draft_depth, "C2": 0, "C3": 0,
            "D": depth * stats["rounds"] + draft_depth * drafted, "E": 0, "F1": 0, "F2": f2_per_token * drafted,
            "G1": 0, "G2": 0}
    want_v = spec_variants(cfg, draft_cfg, stats)
    d_designs = design_counts("D")
    log(f"[{where}] launches {got} (want {want}: {stats['rounds']} verify steps, {drafted} drafted tokens), "
        f"kernel D by design {d_designs}, by variant {variants} (want {want_v})")
    if got != want or d_designs != {"bulk_ring": want["D"]} or variants != want_v:
        raise AssertionError(f"{where}: launch counts {got} != {want}, or {d_designs}, or {variants} != {want_v}")


def spec_full_width_phase(model, prompt, tag="spec", max_seq=32768):
    """Phase 16, the full-width verify path: phase 13's model at b1 on the
    first row of its 32,704-token prompt (or another model's on its own,
    with caches of ``max_seq`` rows), the int8 cache, 64 new tokens.
    generate's two stages (llm_prefill, then the graph decode of 63 tokens)
    give the reference tokens and ms per token; then speculative_generate
    with spec_k 4 and two drafts: the same weights through an int4 cache
    (example/llm_generate.py --spec-k), and w4 weights (quantize_llm_params)
    through an int4 cache. Each must give generate's tokens; prints rounds,
    mean accepted, ms per emitted token (wall, whole call, and without the
    two prefills measured alone), launch counts (depth D a verify step,
    draft depth D a drafted token, F2 6 x depth a drafted token for w4).
    Then one verify step of 4 tokens at the end of the prompt: host
    wall, and device ms by kernel class under torch.profiler; and its rows
    against 4 sequential decode steps (verify_rows_check) there and after a
    16-token prompt, and in f32 at depth 2. ``tag`` marks its log lines."""
    from lowbit_quant_fa2_paddle_tpu_torch.models import llm

    n_new, spec_k = 64, 4
    cfg = dataclasses.replace(model.cfg, max_seq=max_seq, kv_bits=8)
    draft_cfg = dataclasses.replace(cfg, kv_bits=4)
    p1 = prompt[:1]
    ctx = f"{p1.shape[1]}-token"
    res = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, caches = llm.llm_prefill(model, p1, cfg)
    token = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
    del logits
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    count_reset()
    steps, caches, wall_ms, replay_ms, call_s = graph_decode(model, token, caches, n_new - 1, cfg)
    ref = torch.cat([token[:, None], steps], dim=1)
    del caches, steps
    res["generate"] = {"prefill_s": prefill_s, "ms_per_token": wall_ms, "replay_ms": statistics.median(replay_ms),
                       "launches": counts(), "variants": variant_counts()}
    log(f"[{tag}] {CARD}: generate's tokens {ref[0].tolist()}")
    log(f"[{tag}] {CARD}: generate b1, int8 cache: prefill {prefill_s:.3f} s, graph decode {wall_ms:.3f} ms/token wall "
        f"(single replay median {statistics.median(replay_ms):.3f} ms device)")
    w4 = llm.quantize_llm_params(model, bits=4)
    llm.generate(w4, p1[:, :64], 2, dataclasses.replace(draft_cfg, max_seq=512))  # warm-up of F2, not counted
    for name, draft in (("self, int4 cache", model), ("w4 weights, int4 cache", w4)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, dc = llm.llm_prefill(draft, p1, draft_cfg)
        torch.cuda.synchronize()
        draft_prefill_s = time.perf_counter() - t0
        del dc
        torch.cuda.empty_cache()
        count_reset()
        t0 = time.perf_counter()
        toks, st = llm.speculative_generate(model, p1, n_new, cfg, draft_params=draft, draft_cfg=draft_cfg,
                                            spec_k=spec_k, return_stats=True)
        torch.cuda.synchronize()
        total_s = time.perf_counter() - t0
        got, variants = counts(), variant_counts()
        equal = torch.equal(toks, ref)
        decode_ms = (total_s - prefill_s - draft_prefill_s) / (n_new - 1) * 1e3
        log(f"[{tag}] {CARD}: {name}: {n_new} tokens equal to generate's: {equal}; {st['rounds']} rounds, mean accepted "
            f"{st['mean_accepted']:.3f} of {spec_k} (k per round {st['k_per_round']}); whole call {total_s:.3f} s "
            f"({total_s / n_new * 1e3:.3f} ms per emitted token), without the two prefills (target "
            f"{prefill_s:.3f} s, draft {draft_prefill_s:.3f} s, each measured alone) {decode_ms:.3f} ms per token "
            f"vs generate's graph decode {wall_ms:.3f}")
        if not equal:
            raise AssertionError(f"speculative_generate ({name}) differs from generate: {toks} vs {ref}")
        check_spec_counts(f"{tag} {name}", got, variants, cfg, draft_cfg, st, 6 * cfg.depth if draft is w4 else 0)
        res[name] = {"rounds": st["rounds"], "mean_accepted": st["mean_accepted"], "total_s": total_s,
                     "decode_ms_per_token": decode_ms, "draft_prefill_s": draft_prefill_s, "launches": got,
                     "variants": variants, "k_per_round": st["k_per_round"]}
    del w4
    # One verify step of 4 tokens at the end of the prompt, host wall and device time.
    _, caches = llm.llm_prefill(model, p1, cfg)
    length = caches[0]["length"].clone()
    fed = ref[:, :4].contiguous()
    walls = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, caches = llm.llm_verify_step(model, fed, caches, cfg)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
        caches = llm.rollback_caches(caches, length)
    after = []
    cats = profile_classes(lambda: after.append(llm.llm_verify_step(model, fed, caches, cfg)[1]),
                           {"D": ("decode",), "GEMM": GEMM_NAMES})[0]
    caches = after[0]
    res["verify"] = {"host_wall_ms": statistics.median(walls), "device_ms": cats}
    log(f"[{tag}] {CARD}: verify step (4 tokens, b1, {ctx} int8 cache, depth {cfg.depth}): host wall median "
        f"{statistics.median(walls):.3f} ms (of {[round(w, 3) for w in walls]}), device ms " +
        ", ".join(f"{k} {v:.3f}" for k, v in cats.items()) + f"; total {sum(cats.values()):.3f}")
    # The verify step's rows against sequential decode steps: the same argmax,
    # and cos >= 0.99999, but 0.9999 at the end of phase 13's 32K context in bf16.
    # There kernel D's T-token variant splits the keys otherwise than the
    # single-token kernel (other row groups, so another split plan and merge
    # order): within a bf16 ulp a layer, which 32 bf16 layers carry to 1-2
    # ulps of the logits (cos 0.99994-0.99996 on an H100 80GB HBM3). After a
    # 16-token prompt (one split holds keys) the two give the same bits.
    verify_rows_check(model, llm.rollback_caches(caches, length), fed, cfg, f"bf16, {ctx} context", 0.9999)
    del caches
    _, caches = llm.llm_prefill(model, p1[:, :16].contiguous(), cfg)
    verify_rows_check(model, caches, p1[:, 16:20].to(torch.int32).contiguous(), cfg, "bf16, 16-token context",
                      COS_MIN)
    del caches
    # The same width in f32 (depth cut to 2, weights from a seed), where the
    # rows lie far apart (a decode step's logits against the next's: cos
    # 0.65-0.81), after 16 and 1,000 prompt tokens (T g = 16 rows a KV head,
    # 2 CTAs, d128).
    cfg32 = dataclasses.replace(cfg, depth=2, dtype=torch.float32, max_seq=2048)
    model32 = llm.init_llm_params(cfg32, torch.Generator(device="cuda").manual_seed(5))
    for n in (16, 1000):
        _, caches = llm.llm_prefill(model32, p1[:, :n].contiguous(), cfg32)
        verify_rows_check(model32, caches, p1[:, n:n + 4].to(torch.int32).contiguous(), cfg32,
                          f"f32, depth 2, {n}-token context", COS_MIN)
        del caches
    del model32
    return res


def verify_rows_check(model, caches, fed, cfg, where, cos_min):
    """Row t of one llm_verify_step over ``fed [1, T]`` against the t-th
    sequential llm_decode_step from the same caches: cos >= ``cos_min`` and
    the same argmax (tests/test_torch_speculative.py's
    test_verify_step_rows_match_decode_steps). Logs, for scale, the cos of
    each decode step's logits with the next step's (what a row off by one
    would show)."""
    from lowbit_quant_fa2_paddle_tpu_torch.models import llm
    from lowbit_quant_fa2_paddle_tpu_torch.ops.metrics import cosine_similarity

    length = caches[0]["length"].clone()
    v_logits, caches = llm.llm_verify_step(model, fed, caches, cfg)
    caches = llm.rollback_caches(caches, length)
    rows, steps = [], []
    for t in range(fed.shape[1]):
        s_logits, caches = llm.llm_decode_step(model, fed[:, t], caches, cfg)
        steps.append(s_logits)
        rows.append({"cos": float(cosine_similarity(v_logits[:, t], s_logits)),
                     "max_d": float((v_logits[:, t].float() - s_logits.float()).abs().max()),
                     "same_argmax": torch.equal(torch.argmax(v_logits[:, t], -1), torch.argmax(s_logits, -1))})
    next_cos = [round(float(cosine_similarity(steps[t], steps[t + 1])), 6) for t in range(len(steps) - 1)]
    log(f"[spec] verify rows vs decode steps ({where}, T {fed.shape[1]}, cos >= {cos_min}): {rows}; each decode "
        f"step's logits against the next step's: cos {next_cos}, max|logits| {float(steps[0].abs().max()):.4g}")
    if not all(r["cos"] >= cos_min and r["same_argmax"] for r in rows):
        raise AssertionError(f"llm_verify_step's rows differ from sequential decode steps ({where}): {rows}")


def spec_launches(variant, spec_r):
    """D's launches of one variant (``ops.decode.launch_variant``) on phase
    16's full-width path, as its runs counted them: generate, then
    speculative_generate with each draft."""
    return sum(r["variants"].get(variant, 0) for r in spec_r.values() if "variants" in r)


def spec_checkpoint_phase():
    """Phase 16 on the trained checkpoint: speculative_generate of ANS_LEN x
    2 tokens on 64 three-shot prompts, one sequence at a time, with the
    target through an int4 cache and with w4 weights through an int4 cache
    as drafts (spec_k 4), each equal to generate on the same prompt alone;
    exact-match of the answers >= 0.98; launch counts per run."""
    from lowbit_quant_fa2_paddle_tpu_torch.models import llm, train
    from lowbit_quant_fa2_paddle_tpu_torch.utils.checkpoint import load_params_npz

    tree = load_params_npz(os.path.join(REPO, "eval_out", "arith_llm.npz"))
    prompts, answers = train.make_eval_prompts(64, few_shot=3)
    cfg = train.arith_llm_config(kv_bits=8)
    draft_cfg = train.arith_llm_config(kv_bits=4)
    model = llm.params_from_jax(tree, cfg)
    w4 = llm.quantize_llm_params(model, bits=4)
    n_new = 2 * train.ANS_LEN
    refs = [llm.generate(model, torch.from_numpy(p[None]).cuda(), n_new, cfg) for p in prompts]
    res = {}
    for name, draft in (("self, int4 cache", model), ("w4 weights, int4 cache", w4)):
        rounds = accepted = 0
        correct, equal = 0, 0
        for p, a, ref in zip(prompts, answers, refs):
            count_reset()
            toks, st = llm.speculative_generate(model, torch.from_numpy(p[None]).cuda(), n_new, cfg,
                                                draft_params=draft, draft_cfg=draft_cfg, spec_k=4, return_stats=True)
            got, variants = counts(), variant_counts()
            want_d = cfg.depth * (st["rounds"] + sum(st["k_per_round"]))
            want_v = spec_variants(cfg, draft_cfg, st)
            if got["D"] != want_d or got["A"] != 2 * cfg.depth or variants != want_v:
                raise AssertionError(f"ckpt spec {name}: launches {got}, want D {want_d} and A {2 * cfg.depth}; "
                                     f"D by variant {variants}, want {want_v}")
            equal += int(torch.equal(toks, ref))
            correct += int(train.grade_answer(toks[0].cpu().numpy(), a))
            rounds += st["rounds"]
            accepted += st["mean_accepted"] * st["rounds"]
        acc = correct / len(prompts)
        log(f"[spec ckpt] {CARD}: {name}: {equal}/{len(prompts)} prompts equal to generate's tokens, task exact-match "
            f"{acc:.4f}, {rounds} rounds, mean accepted {accepted / rounds:.3f} of 4")
        if equal != len(prompts) or acc < 0.98:
            raise AssertionError(f"checkpoint speculative_generate ({name}): {equal} equal, exact-match {acc}")
        res[name] = {"exact_match": acc, "rounds": rounds, "mean_accepted": accepted / rounds}
    return res


# ---------------------------------------------------------------------------
# Phase 17: kernel A at head_dim 256, its bias and fp32 PV; kernel D at
# head_dim 256; the head_dim-256 LLM at full width.
# ---------------------------------------------------------------------------

#: fp32 PV's output (f32) against the plain version's: JAX's f32 grade, the
#: bound the plain version meets against JAX (tests/test_torch_hd256.py's
#: F32_MAX_DO). The kernel splits P and V into three bf16 terms each (all 24
#: bits) and sums the six products whose terms' orders add to at most 2 (the
#: dropped ones below 2^-24 of |P V|) for each 64-column block of a tile from
#: zero on the tensor cores, the blocks added to O on the CUDA cores.
PV32_MAX_DO = 1e-5


def hd256_edge_phase(gen):
    """Kernel A's head_dim-256 grid (every mode at d256 and 192, unmasked and
    at the masks' edges) and the bias / fp32 PV grid (d64, d128, d256) of
    utils/mask_cases.py against attention_fwd_plain at phase 4's bounds
    (fp32 PV: max|do| <= PV32_MAX_DO), the same bits twice, every launch on
    the wgmma design and the kernel of its head dim. Returns the worst
    max|do| per group."""
    from lowbit_quant_fa2_paddle_tpu_torch.ops.attention import attention_fwd_plain, kernel_dim, lowbit_attention
    from lowbit_quant_fa2_paddle_tpu_torch.utils import mask_cases

    worst = {}
    for mode, edge in mask_cases.extra_cases():
        case = mask_cases.make_case(mode, edge, gen, "cuda")
        pv32 = case["kw"].get("pv_dtype") == torch.float32
        dp = kernel_dim(case["args"][0].shape[-1])
        n, n_dim = lowbit_attention.launches_by_design["wgmma"], lowbit_attention.launches_by_dim[dp]
        o, lse = lowbit_attention(*case["args"], **case["kw"], return_lse=True)
        o2, lse2 = lowbit_attention(*case["args"], **case["kw"], return_lse=True)
        o_ref, lse_ref = attention_fwd_plain(*case["plain_args"], **case["plain_kw"])
        torch.cuda.synchronize()
        r = mask_cases.masked_stats(o, lse, o_ref, lse_ref)
        r["same_bits_twice"] = torch.equal(o, o2) and torch.equal(lse, lse2)
        r["on_design"] = (lowbit_attention.launches_by_design["wgmma"] == n + 2
                          and lowbit_attention.launches_by_dim[dp] == n_dim + 2)
        check_masked(f"{mode} {edge}", r, "A17")
        if pv32 and r["max_do"] > PV32_MAX_DO:
            raise AssertionError(f"fp32 PV max|do| {r['max_do']} > {PV32_MAX_DO} ({mode} {edge})")
        group = "fp32 PV" if pv32 else "bias" if "bias" in case["kw"] else "d256"
        worst[group] = max(worst.get(group, 0.0), r["max_do"])
        del case, o, o2, lse, lse2, o_ref, lse_ref
    log(f"[A17] {len(mask_cases.extra_cases())} cases; worst max|do| by group: " +
        ", ".join(f"{k} {v:.3g}" for k, v in worst.items()))
    return worst


#: Kernel A at head_dim 256 at bench.py:119's shape (b4 h8 s4096 d256,
#: non-causal) in each mode: (K bits, V mode) on C1/C2/C3 codes, Q
#: quantized in the kernel; "fp" bf16 Q/K.
def hd256_quant_phase(gen):
    """Kernel C1 at the shapes the hd256 LLM's prefills give it: K of b4, 8
    KV heads, 256 wide, per token with its mean, over the one-shot prompt
    (32,704 tokens) and over one chunk of the chunked prefill (4,096): codes
    and scales bit-equal to quant_int8_plain, on the vector design, then
    timed as phase 3 times it."""
    from lowbit_quant_fa2_paddle_tpu_torch.ops.quant import k_mean, kernel_design, quant_int8, quant_int8_plain

    recs = {}
    for tag, s in (("prefill", 32704), ("chunk", 4096)):
        k = (torch.randn(4, 8, s, 256, generator=gen, device="cuda") + 0.5).bfloat16()
        km = k_mean(k)
        n = quant_int8.launches_by_design["vector"]
        codes, scale = quant_int8(k, km, gran="per_token")
        on_vector = quant_int8.launches_by_design["vector"] == n + 1
        want_c, want_s = quant_int8_plain(k, km, per_token=True, block=128)
        torch.cuda.synchronize()
        same = torch.equal(codes, want_c) and torch.equal(scale, want_s)
        log(f"[C1-17] hd256 K b4 h8 s{s} d256 per_token ({kernel_design(k, 8, True, 128)}): "
            f"codes_equal={torch.equal(codes, want_c)} scales_equal={torch.equal(scale, want_s)} vector={on_vector}")
        if not (same and on_vector):
            raise AssertionError(f"kernel C1 differs from its plain version (or left the vector design) at the "
                                 f"hd256 LLM's K b4 h8 s{s} d256")
        del k, km, codes, scale, want_c, want_s
        ks = [torch.randn(4, 8, s, 256, generator=gen, device="cuda").bfloat16() for _ in range(2)]
        recs[tag] = {"max_abs_err": 0.0, **time_quant("C1-17", f"b4 h8 s{s} d256 contiguous K", quant_int8,
                                                      quant_int8_plain, ks, "per_token", 128, 8)}
        del ks
    return recs


A17_MODES = {"int8": (8, "bf16"), "fp": (16, "bf16"), "int4-K": (4, "bf16"), "int2-K": (2, "bf16"),
             "int8-V": (8, "int8"), "int8-PV": (8, "int8_pv")}


def a_mode_record(gen, name, b, h, hk, s, d, causal, k_bits, v_mode, bias=None, pv32=False, library=None,
                  prefix="A17"):
    """Kernel A in one mode (K bits 16/8/4/2 on C1/C2/C3 codes with Q
    quantized in the kernel, or bf16 Q/K at 16; V "bf16", "int8" or
    "int8_pv") on random inputs of one shape, with a bias or fp32 PV:
    a_record's check against the plain version and its times; ``library``
    makes the library call from (q, k, v, bias), run under its own
    dispatch or, with a bias or fp32 PV, SDPA's efficient backend."""
    from lowbit_quant_fa2_paddle_tpu_torch.ops import quant as qo
    from lowbit_quant_fa2_paddle_tpu_torch.ops.attention import LOG2E, attention_fwd_plain, lowbit_attention

    q = torch.randn(b, h, s, d, generator=gen, device="cuda").bfloat16()
    k = (torch.randn(b, hk, s, d, generator=gen, device="cuda") + 0.3).bfloat16()
    v = torch.randn(b, hk, s, d, generator=gen, device="cuda")
    v = v if pv32 else v.bfloat16()
    c = 1.0 / math.sqrt(d) * LOG2E
    ks = vs = vm = None
    if k_bits != 16:
        quant = {8: qo.quant_int8, 4: qo.quant_int4, 2: qo.quant_int2}[k_bits]
        k, ks = quant(k, qo.k_mean(k), gran="per_token")
    if v_mode != "bf16":
        v, vs, vm = qo.quant_v_int8_per_channel(v, smooth_v=True)
    kb, pv8 = 8 if k_bits == 16 else k_bits, v_mode == "int8_pv"
    extra = dict(pv_dtype=torch.float32, out_dtype=torch.float32) if pv32 else {}
    out = torch.float32 if pv32 else torch.bfloat16

    def call(lse):
        return lowbit_attention(q, k, v, None, ks, v_scale=vs, v_mean=vm, k_pack_bits=kb, pv_int8=pv8,
                                is_causal=causal, bias=bias, return_lse=lse, **extra)

    def plain():
        return attention_fwd_plain(q, k, v, None, ks, vm, causal=causal, sm_scale_log2e=c, out_dtype=out,
                                   k_bits=kb, v_scale=vs, pv_int8=pv8, bias=bias, pv_f32=pv32)

    pairs = b * (s * (s + 1) // 2 if causal else s * s)
    lib = None if library is None else library(q, k, v, bias)
    r = a_record(name, call, plain, pairs, h, d, "fp" if k_bits == 16 else "int8-PV" if pv8 else "int8",
                 (q, k, v, ks, vs, vm, bias), b * h * s * d * (4 if pv32 else 2), lib, prefix,
                 library_backend=None if bias is None and not pv32 else "efficient")
    if pv32:
        if r["max_abs_err"] > PV32_MAX_DO:
            raise AssertionError(f"{name}: fp32 PV max|do| {r['max_abs_err']} > {PV32_MAX_DO}")
        # The products as the kernel runs them: QK in its type, PV as six bf16 products.
        qk = {"int8": 2 * d * pairs * h} if k_bits != 16 else {"bf16": 2 * d * pairs * h}
        pv = 6 * 2 * d * pairs * h
        r.update(bound(nbytes(q, k, v, ks, vs, vm) + b * h * s * d * 4, {**qk, "bf16": qk.get("bf16", 0) + pv}))
    return r


def hd256_attention_phase(gen):
    """Kernel A at head_dim 256 in every mode at bench.py:119's b4 h8 s4096
    d256 (SDPA bf16 at d256 beside the fp mode), int8 at the hd256 LLM's
    prefill (b4 h16 hk8 s32704 d256 causal); the bias at the DiT shape (a
    per-key vector) and at b1 h8 s4096 d128 (a matrix; a DiT-shape matrix
    would be 38 GB), int8, beside SDPA with a float attn_mask; fp32 PV at the
    DiT shape (int8 QK, f32 V, f32 out) beside SDPA on f32 inputs. Each
    against the plain version, the same bits twice, timed (a_record)."""
    sdpa = torch.nn.functional.scaled_dot_product_attention
    records = {}

    def run(name, *args, **kw):
        records[name] = a_mode_record(gen, name, *args, **kw)

    def sdpa_with(dtype, mask):
        """A library call (built before it is timed): SDPA on q and random K
        and V of q's shape in ``dtype`` (MHA calls), with ``mask`` (the
        bias, broadcast over the rows of a vector) as its float attn_mask."""
        def make(q, k, v, bias):
            q2 = q.to(dtype)
            k2, v2 = torch.randn_like(q2), torch.randn_like(q2)
            m = None
            if mask:
                m = bias.to(dtype)
                m = m.expand(-1, -1, q.shape[2], -1) if m.shape[2] == 1 else m
            return lambda: sdpa(q2, k2, v2, attn_mask=m)
        return make

    bench = (4, 8, 8, 4096, 256, False)
    for mode, (k_bits, v_mode) in A17_MODES.items():
        # SDPA computes the fp mode's function (bf16 at d256, under its own
        # dispatch: no mask, so its flash backend takes it); the others have
        # no library call.
        run(f"d256 {mode}; b4 h8 s4096 d256", *bench, k_bits, v_mode,
            library=(lambda q, k, v, _: (lambda: sdpa(q, k, v))) if mode == "fp" else None)
    run("d256 int8; hd256 LLM prefill b4 h16 hk8 s32704 d256 causal", 4, 16, 8, 32704, 256, True, 8, "bf16")
    vec = torch.randn(B, H, 1, S, generator=gen, device="cuda")
    run(f"int8 bias vector; DiT shape b{B} h{H} s{S} d{D}", B, H, H, S, D, False, 8, "bf16", bias=vec,
        library=sdpa_with(torch.bfloat16, True))
    mat = torch.randn(1, 8, 4096, 4096, generator=gen, device="cuda")
    run("int8 bias matrix; b1 h8 s4096 d128", 1, 8, 8, 4096, 128, False, 8, "bf16", bias=mat,
        library=sdpa_with(torch.bfloat16, True))
    del vec, mat
    run(f"int8 QK fp32 PV (f32 V); DiT shape b{B} h{H} s{S} d{D}", B, H, H, S, D, False, 8, "bf16", pv32=True,
        library=sdpa_with(torch.float32, False))
    # fp32 PV at head_dim 256 (attention_fwd_wgmma_pv32_d256.cu: one stage of
    # the ring) with INT8 and with bf16 QK, at bench.py:119's shape.
    for qk_bits, qk_name in ((8, "int8"), (16, "bf16")):
        run(f"d256 {qk_name} QK fp32 PV (f32 V); b4 h8 s4096 d256", *bench, qk_bits, "bf16", pv32=True,
            library=sdpa_with(torch.float32, False))
    return records


def hd256_decode_phase(gen):
    """Kernel D at head_dim 256 (decode_attention_d256.cu) in every cache
    mode of DECODE_MODES against its plain version at phase 9's bounds, the
    same bits twice: at b4 h16 hk8 S_max 32768 (lengths 32768, 1, 4097, 0),
    at a split boundary +- 1, with f32 queries, and with a window of 300 +
    8 sinks and the cap 2; then timed at every length 32768 (SDPA, one
    query per head, beside the bf16 cache)."""
    from lowbit_quant_fa2_paddle_tpu_torch.ops import decode as DD
    from lowbit_quant_fa2_paddle_tpu_torch.utils.benchmark import cuda_time_ms

    b, h, hk, d, s = 4, 16, 8, 256, 32768
    records = {}
    for mode, (kb, vb, cm) in DECODE_MODES.items():
        chunk = DD.num_splits(4096, b * hk, DD._resident_ctas(0, d, kb, vb, kb == 8 or cm == "int_qk"))[1]
        cases = [("lengths 32768/1/4097/0", dict(s=s, lengths=[s, 1, 4097, 0]), {}),
                 ("split boundary +-1", dict(s=4096, lengths=[chunk - 1, chunk, chunk + 1, 2 * chunk + 1]), {}),
                 ("f32 queries", dict(s=777, lengths=[777, 1, 0, 500], q_dtype=torch.float32), {}),
                 ("window 300 + 8 sinks, cap 2", dict(s=4096, lengths=[4096, 100, 1300, 0]),
                  dict(window_size=300, sink_size=8, logit_cap=2.0))]
        worst = 0.0
        for name, kw, opts in cases:
            kargs, kkw, pargs, pkw = decode_inputs(gen, b, h, hk, d, mode=mode, **kw)
            n = DD.decode_attention.launches_by_dim[256]
            o, lse = DD.decode_attention(*kargs, **kkw, **opts, return_lse=True)
            o2, lse2 = DD.decode_attention(*kargs, **kkw, **opts, return_lse=True)
            window = opts.get("window_size", 0)
            o_ref, lse_ref = DD.decode_attention_plain(*pargs, **pkw, window=window, sink=opts.get("sink_size", 0),
                                                       logit_cap=opts.get("logit_cap", 0.0))
            torch.cuda.synchronize()
            r = stats(o, o_ref, lse, lse_ref)
            ulp = bf16_ulp(float(o_ref.float().abs().max()))
            empty = [i for i, n_ in enumerate(kw["lengths"]) if n_ == 0]
            empty_ok = all(float(o[i].float().abs().max()) == 0.0 and bool((lse[i] == -1e30).all()) for i in empty)
            same = torch.equal(o, o2) and torch.equal(lse, lse2)
            on_kernel = DD.decode_attention.launches_by_dim[256] == n + 2
            log(f"[D17] {mode} d256 {name}: " + " ".join(f"{k}={v:.6g}" if isinstance(v, float) else f"{k}={v}"
                                                       for k, v in r.items()) +
                f" bf16_ulp={ulp:.3g} empty_rows_ok={empty_ok} same_bits_twice={same} d256_kernel={on_kernel}")
            if not (r["finite"] and r["cos"] >= COS_MIN and r["max_do"] <= ulp and r["max_dlse"] <= 1e-4 and empty_ok
                    and same and on_kernel):
                raise AssertionError(f"kernel D at d256 disagrees with its plain version ({mode}, {name}): {r}")
            worst = max(worst, r["max_do"])
            del kargs, pargs, o, o2, o_ref
        kargs, kkw, pargs, pkw = decode_inputs(gen, b, h, hk, d, s, mode, [s] * b)
        ms = cuda_time_ms(lambda: DD.decode_attention(*kargs, **kkw), warmup=5, reps=50)
        plain_ms = cuda_time_ms(lambda: DD.decode_attention_plain(*pargs, **pkw), warmup=1, reps=3)
        q, kq, vq, ks, lens = kargs
        cache_bytes = nbytes(kq, vq, ks, pargs[4])
        lim = bound(cache_bytes + nbytes(q, lens) * 2)
        library_ms = None
        if mode == "bf16":
            library_ms = cuda_time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
                q[:, :, None], kq, vq, enable_gqa=True), warmup=3, reps=20)
        log(f"[D17] {mode} b{b} h{h} hk{hk} d{d} s{s}: kernel {ms:.4f} ms "
            f"({cache_bytes / (ms * 1e-3) / 1e9:.1f} GB/s of {cache_bytes / 1e6:.1f} MB cache), plain "
            f"{plain_ms:.4f} ms, bound {lim['bound_ms']:.4f} ms, SDPA {library_ms}")
        records[mode] = {"max_abs_err": worst, "ms": ms, "plain_ms": plain_ms, **lim, "library_ms": library_ms,
                         "design": DD.kernel_design()}
        del kargs, pargs
    return records


def hd256_llm_phase():
    """The full-width LLM with 256-wide heads (bench/llm_e2e_bench.py --heads
    16 --kv-heads 8 --head-dim 256: dim 4096, depth 16 of its 32, cut for
    the run's time limit; Gemma 2 9B's attention geometry), random seeded
    weights, b4 from a 32,704-token
    prompt: llm_prefill then 63 graph-decoded tokens (64 with the prefill's)
    on the int8 and then the bf16 cache, one cache alive at a time; the
    first decode step's logits int8 vs bf16 cache cos >= 0.999; then
    llm_prefill_chunked (chunks of 4096) into a k4v8 cache against the
    one-shot prefill's last-token logits, cos >= 0.995, and kernel A on its
    last chunk (packed INT4 K over the cache) against the plain version.
    Launches: depth A (all at d256) and C1 a prefill, depth x 63 D (all at
    d256) a decode."""
    from lowbit_quant_fa2_paddle_tpu_torch.models import llm
    from lowbit_quant_fa2_paddle_tpu_torch.ops import decode as DD
    from lowbit_quant_fa2_paddle_tpu_torch.ops.attention import lowbit_attention
    from lowbit_quant_fa2_paddle_tpu_torch.ops.metrics import cosine_similarity

    b, prompt_len, n_new, chunk = 4, 32704, 64, 4096
    cfg = llm.LLMConfig(vocab=256, dim=4096, depth=16, num_heads=16, num_kv_heads=8, max_seq=32768,
                        dtype=torch.bfloat16)
    gen = torch.Generator(device="cuda").manual_seed(0)
    t0 = time.perf_counter()
    model = llm.init_llm_params(cfg, gen)
    n_params = sum(p.numel() for p in model.parameters())
    prompt = torch.randint(0, cfg.vocab, (b, prompt_len), generator=gen, device="cuda")
    torch.cuda.synchronize()
    log(f"[hd256] dim {cfg.dim} depth {cfg.depth} heads {cfg.num_heads}x{cfg.head_dim} kv heads "
        f"{cfg.num_kv_heads} bf16: {n_params / 1e9:.3f} B params, init {time.perf_counter() - t0:.1f} s")
    llm.generate(model, prompt[:, :256], 2, dataclasses.replace(cfg, max_seq=512))  # warm-up, not counted
    res = {}
    for mode, bits in (("int8", 8), ("bf16", 16)):
        cfg_m = dataclasses.replace(cfg, kv_bits=bits)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        first = FirstLogits(model)
        count_reset()
        t0 = time.perf_counter()
        logits, caches = llm.llm_prefill(model, prompt, cfg_m)
        token = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
        last = logits[:, -1].float()
        del logits
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
        steps, caches, wall_ms, replay_ms, call_s = graph_decode(model, token, caches, n_new - 1, cfg_m)
        got, a_dim, d_dim = counts(), dict(lowbit_attention.launches_by_dim), dict(DD.decode_attention.launches_by_dim)
        first.remove()
        peak = torch.cuda.max_memory_allocated()
        cache_gb = sum(nbytes(*c.values()) for c in caches) / 1e9
        log(f"[hd256] {mode} cache ({cache_gb:.2f} GB over {cfg.depth} layers): prefill {prefill_s:.3f} s, graph "
            f"decode {wall_ms:.3f} ms/token wall over {n_new - 11} replays in one call (single-replay device ms "
            f"median {statistics.median(replay_ms):.3f}, min {min(replay_ms):.3f}, max {max(replay_ms):.3f}; the "
            f"first call {call_s:.2f} s), peak {peak / 2**30:.2f} GiB; kernel A by head dim {a_dim}, kernel D by "
            f"head dim {d_dim}")
        check_counts(f"hd256 {mode}", got, cfg.depth, n_new - 1)
        if a_dim[256] != cfg.depth or d_dim[256] != cfg.depth * (n_new - 1):
            raise AssertionError(f"hd256 {mode}: A/D launches by head dim {a_dim} / {d_dim}")
        if first.logits is None or not bool(torch.isfinite(first.logits).all()) or steps.shape != (b, n_new - 1):
            raise AssertionError("hd256: no or non-finite first-step logits, or bad tokens")
        res[mode] = {"prefill_s": prefill_s, "decode_ms_per_token": wall_ms, "replay_ms": replay_ms,
                     "peak_gib": peak / 2**30, "launches": got, "a_d256": a_dim[256], "d_d256": d_dim[256],
                     "logits": first.logits, "last": last}
        del caches, steps, first
    cos = float(cosine_similarity(res["int8"]["logits"], res["bf16"]["logits"]))
    log(f"[hd256] first decode step logits cos int8 vs bf16 cache {cos:.6f} (>= 0.999)")
    if cos < 0.999:
        raise AssertionError(f"hd256: int8 vs bf16 cache first-step logits cos {cos} < 0.999")
    full_last = res["int8"]["last"]
    for mode in ("int8", "bf16"):
        del res[mode]["logits"], res[mode]["last"]
    cfg_c = dataclasses.replace(cfg, kv_bits=8, k_bits=4)
    torch.cuda.empty_cache()
    count_reset()
    t0 = time.perf_counter()
    last, caches = llm.llm_prefill_chunked(model, prompt, cfg_c, chunk=chunk)
    torch.cuda.synchronize()
    chunked_s = time.perf_counter() - t0
    got, a256 = counts(), lowbit_attention.launches_by_dim[256]
    cos = float(cosine_similarity(last.float(), full_last))
    n_chunks = -(-prompt_len // chunk)
    log(f"[hd256] k4v8 chunked prefill (chunk {chunk}) {chunked_s:.3f} s vs one-shot last-token logits cos "
        f"{cos:.6f} (>= 0.995); launches {got}, kernel A at d256 {a256}")
    if cos < 0.995:
        raise AssertionError(f"hd256: chunked vs one-shot prefill cos {cos} < 0.995")
    if got["A"] != a256 or a256 != cfg.depth * (2 * n_chunks - 1) or got["C1"] != cfg.depth * n_chunks:
        raise AssertionError(f"hd256 chunked prefill launches {got}, A at d256 {a256}")
    c0 = (n_chunks - 1) * chunk
    res["A_cross"] = long_prefill_attention_check(model, prompt[:, c0:], caches[0], c0, cfg_c,
                                                  where="hd256 chunked prefill", tag="hd256")
    res["chunked"] = {"prefill_s": chunked_s, "cos": cos, "a_d256": a256, "cross_launches": a256 - got["C1"],
                      "c1": got["C1"]}
    del caches
    res["_model"], res["_prompt"] = model, prompt  # phase 18's speculative decoding runs on them
    return res


# ---------------------------------------------------------------------------
# Phase 18: kernels G1/G2 at head_dim 256 and DiT training on 256-wide heads;
# kernel D's T-token and INT8-PV instances at head_dim 256 and the hd256
# LLM's speculative decoding.
# ---------------------------------------------------------------------------


def hd256_bwd_phase(gen):
    """G1/G2's head_dim-256 instances: the edge grid of utils/bwd_cases.py
    (d256 and d192, bf16 and int8 codes, ragged Sq/Sk, causal GQA, windows,
    f32) at phase 6's bounds, the same bits twice, every launch at kernel
    head dim 256; then both trainable functions at d256 (b1 h4 s1024, with
    and without causal masking and with a causal window of 256) against a
    dense fp32 oracle under autograd at phase 7's bounds; then G1 and G2
    timed at the DiT with 256-wide heads' shape, b1 h8 s17776 d256, as phase
    6 times them at d64. Returns (records, the quantized backward's
    launches)."""
    import lowbit_quant_fa2_paddle_tpu_torch as lq
    from lowbit_quant_fa2_paddle_tpu_torch.ops import attention_bwd as AB
    from lowbit_quant_fa2_paddle_tpu_torch.ops.metrics import cosine_similarity
    from lowbit_quant_fa2_paddle_tpu_torch.ops.reference import attention_reference
    from lowbit_quant_fa2_paddle_tpu_torch.utils import bwd_cases

    worst = {False: 0.0, True: 0.0}
    for name in bwd_cases.CASES:
        r = bwd_cases.check_case(name, gen)
        log(f"[G18] edge {name}: launches_ok={r['launches_ok']} " + "; ".join(
            f"{g} cos={r[g]['cos']:.7f} max_d={r[g]['max_d']:.4g} (bound {r[g]['bound']:.3g}) "
            f"same_bits_twice={r[g]['same_bits_twice']}" for g in ("dq", "dk", "dv")))
        if not r["ok"]:
            raise AssertionError(f"kernels G1/G2 at head_dim 256 disagree with their plain version ({name}): {r}")
        quantized = bwd_cases.CASES[name][0]
        worst[quantized] = max([worst[quantized]] + [r[g]["max_d"] for g in ("dq", "dk", "dv")])
    b, h, s, d = 1, 4, 1024, 256
    q, k, v, g = (torch.randn(b, h, s, d, generator=gen, device="cuda").bfloat16() for _ in range(4))
    quantized_launches = {"G1": 0, "G2": 0}
    for causal, window in ((False, None), (True, None), (True, 256)):
        xs = [x.float().requires_grad_() for x in (q, k, v)]
        oracle = torch.autograd.grad((attention_reference(*xs, is_causal=causal, window_size=window)
                                      * g.float()).sum(), xs)
        for name, fn, extra, cos_min, c1 in (("flash", lq.flash_attention_trainable, (), 0.999, 0),
                                             ("lowbit", lq.lowbit_attention_trainable, (None, None, None, False),
                                              0.99, 1),
                                             ("lowbit bwd_quantized", lq.lowbit_attention_trainable,
                                              (None, None, None, True), 0.999, 5)):
            extra = extra or (None, None, None)
            xs = [x.detach().requires_grad_() for x in (q, k, v)]
            count_reset()
            o = fn(*xs, causal, *extra, window)
            grads = torch.autograd.grad((o.float() * g.float()).sum(), xs)
            torch.cuda.synchronize()
            got = counts()
            dims = {kern: dict(_wrappers()[kern].launches_by_dim) for kern in ("G1", "G2")}
            want = {key: 0 for key in got} | {"A": 1, "G1": 1, "G2": 1, "C1": c1}
            cos = [float(cosine_similarity(a, r)) for a, r in zip(grads, oracle)]
            log(f"[G18] grad cos vs fp32 oracle, {name} d{d} causal={causal} window={window}: dq {cos[0]:.6f} dk "
                f"{cos[1]:.6f} dv {cos[2]:.6f}; launches {got}, G1/G2 by head dim {dims}")
            if min(cos) < cos_min or got != want or any(n[256] != 1 for n in dims.values()):
                raise AssertionError(f"{name} d{d} causal={causal} window={window}: grad cos {cos} (>= {cos_min}), "
                                     f"launches {got} != {want} or by head dim {dims}")
            if extra[-1]:
                quantized_launches = {key: quantized_launches[key] + got[key] for key in quantized_launches}
    del q, k, v, g, xs, oracle
    shape = (8, S, 256)
    records = {"quantized" if qz else "float": bwd_timed(gen, *shape, qz, worst[qz], "G18") for qz in (False, True)}
    return records, quantized_launches


class AttnCapture:
    """Keeps the first DiT block's attention inputs (q, k, v) on the next
    forward and, in its backward, the cotangent of the attention output and
    the gradients of q, k and v: ``models.dit._attention`` wrapped until
    ``remove()``."""

    def __init__(self):
        from lowbit_quant_fa2_paddle_tpu_torch.models import dit

        self.dit, self.orig, self.got = dit, dit._attention, {}
        dit._attention = self

    def __call__(self, q, k, v, impl):
        o = self.orig(q, k, v, impl)
        if not self.got:
            self.got.update(q=q.detach(), k=k.detach(), v=v.detach())
            for name, x in (("dq", q), ("dk", k), ("dv", v), ("do", o)):
                x.register_hook(lambda grad, name=name: self.got.__setitem__(name, grad.detach()))
        return o

    def remove(self):
        self.dit._attention = self.orig


def oracle_attention_grads(q, k, v, do):
    """dq, dk, dv of non-causal attention in fp32 under autograd (the dense
    oracle of ops/reference.py), one head at a time."""
    from lowbit_quant_fa2_paddle_tpu_torch.ops.reference import attention_reference

    grads = [torch.empty(x.shape, dtype=torch.float32, device=x.device) for x in (q, k, v)]
    for i in range(q.shape[1]):
        xs = [x[:, i:i + 1].float().requires_grad_() for x in (q, k, v)]
        gs = torch.autograd.grad((attention_reference(*xs) * do[:, i:i + 1].float()).sum(), xs)
        for out, gi in zip(grads, gs):
            out[:, i:i + 1] = gi
        del xs, gs
    return grads


def hd256_train_phase():
    """The DiT's training path on 256-wide heads: CogVideoX-2b's depth 30,
    time embedding 512 and 17,776-token latent with Gemma-2B's attention
    width (hidden 2048 = 8 heads x 256; google/gemma-2b config.json), random
    weights from a seeded generator, full depth. For flash_train, then
    int8_train on a fresh copy: a warm-up forward and backward (gradients
    finite) that keeps the first block's attention inputs q, k, v; the
    impl's trainable function on them (b1 h8 s17776 d256, G1/G2 at d256)
    with a unit-normal cotangent, its gradients held to a dense fp32 oracle
    (cos >= 0.999; int8_train >= 0.99, its forward being the quantized
    softmax). The model's own cotangent there (the loss's, max|do| ~1e-6)
    leaves the attention gradients a residue of cancelling terms below the
    operands' bf16 rounding: the kernels, the plain version and the oracle
    disagree on it at d64 as at d256 (cos 0.04-0.97), so those are logged,
    not held. Then 3 sgd_train_steps at lr 1e-4, counted step by step
    (every G1 and G2 launch at kernel head dim 256: depth x 3 each), then
    one step under torch.profiler."""
    import lowbit_quant_fa2_paddle_tpu_torch as lq
    from lowbit_quant_fa2_paddle_tpu_torch.models import dit
    from lowbit_quant_fa2_paddle_tpu_torch.ops.metrics import cosine_similarity

    cfg = dit.cogvideox_2b_config(dim=2048, num_heads=8)
    x0 = torch.randn(1, S, cfg.dim, generator=torch.Generator(device="cuda").manual_seed(5), device="cuda")
    x0 = x0.to(cfg.dtype)
    res = {}
    for impl, cos_min in (("flash_train", 0.999), ("int8_train", 0.99)):
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        model = dit.init_dit_params(cfg, torch.Generator(device="cuda").manual_seed(0))
        params = list(model.parameters())
        n_params = sum(p.numel() for p in params)
        t, noise = dit.draw_t_noise(x0, torch.Generator(device="cuda").manual_seed(6))
        cap = AttnCapture()
        try:
            loss = dit.diffusion_loss(model, x0, t, noise, impl)
            grads = torch.autograd.grad(loss, params)
        finally:
            cap.remove()
        finite = all(bool(torch.isfinite(g).all()) for g in grads)
        warm_loss = float(loss.detach())
        del grads, loss
        got = cap.got
        q, k, v = got["q"], got["k"], got["v"]
        own = oracle_attention_grads(q, k, v, got["do"])
        own_cos = [float(cosine_similarity(got[n], o)) for n, o in zip(("dq", "dk", "dv"), own)]
        del own
        fn = lq.flash_attention_trainable if impl == "flash_train" else lq.lowbit_attention_trainable
        gco = torch.randn(q.shape, generator=torch.Generator(device="cuda").manual_seed(8), device="cuda").bfloat16()
        xs = [x.detach().requires_grad_() for x in (q, k, v)]
        count_reset()
        grads = torch.autograd.grad((fn(*xs).float() * gco.float()).sum(), xs)
        g_dims = {kern: _wrappers()[kern].launches_by_dim[256] for kern in ("G1", "G2")}
        oracle = oracle_attention_grads(q, k, v, gco)
        cos = [float(cosine_similarity(a, o)) for a, o in zip(grads, oracle)]
        del cap, got, q, k, v, xs, grads, oracle, gco
        torch.cuda.synchronize()
        log(f"[train18] {impl} (dim {cfg.dim}, {cfg.num_heads} heads x {cfg.head_dim}, depth {cfg.depth}): "
            f"{n_params / 1e9:.3f} B params; init and warm-up {time.perf_counter() - t0:.1f} s, warm-up loss "
            f"{warm_loss:.6f}, gradients finite={finite}; on block 0's q, k, v with a unit-normal cotangent, "
            f"gradients vs the fp32 oracle: dq {cos[0]:.6f} dk {cos[1]:.6f} dv {cos[2]:.6f} (>= {cos_min}), G1/G2 "
            f"at d256 {g_dims}; with the model's own cotangent (not held): dq {own_cos[0]:.4f} dk {own_cos[1]:.4f} "
            f"dv {own_cos[2]:.4f}")
        if not finite or min(cos) < cos_min or g_dims != {"G1": 1, "G2": 1}:
            raise AssertionError(f"{impl} at head_dim 256: warm-up gradients finite={finite}, block 0 attention "
                                 f"gradient cos {cos} (>= {cos_min}), G1/G2 at d256 {g_dims}")
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        tgen = torch.Generator(device="cuda").manual_seed(7)
        losses, step_ms, launches, dims = [], [], [], []
        for _ in range(STEPS):
            t, noise = dit.draw_t_noise(x0, tgen)
            torch.cuda.synchronize()
            count_reset()
            t1 = time.perf_counter()
            loss = dit.sgd_train_step(model, x0, t, noise, lr=TRAIN_LR, attn_impl=impl)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t1) * 1e3)
            launches.append(counts())
            dims.append({kern: _wrappers()[kern].launches_by_dim[256] for kern in ("A", "G1", "G2")})
            losses.append(float(loss))
        peak = torch.cuda.max_memory_allocated()
        params_finite = all(bool(torch.isfinite(p).all()) for p in params)
        cats, top = train_step_profile(model, x0, tgen, impl)
        log(f"[train18] {CARD}: {impl} b1 s{S} d256: ms/step " + ", ".join(f"{x:.1f}" for x in step_ms)
            + "; losses " + ", ".join(f"{x:.6f}" for x in losses) + f"; peak {peak / 2**30:.2f} GiB; parameters "
            f"finite={params_finite}")
        log(f"[train18] {CARD}: {impl} step device ms (profiler): " + ", ".join(f"{k} {v:.1f}" for k, v in cats.items())
            + f"; total {sum(cats.values()):.1f}; G1 + G2 share {(cats['G1'] + cats['G2']) / sum(cats.values()):.1%};"
            f" largest other: {top}")
        want = {"A": cfg.depth, "C1": cfg.depth if impl == "int8_train" else 0, "C2": 0, "C3": 0, "D": 0, "E": 0,
                "F1": 0, "F2": 0, "G1": cfg.depth, "G2": cfg.depth}
        want_dim = {"A": cfg.depth, "G1": cfg.depth, "G2": cfg.depth}
        log(f"[train18] {impl} launches per step {launches} (want {want}); at kernel head dim 256 {dims}; G1/G2 at "
            f"d256 over the {STEPS} steps: {sum(x['G1'] for x in dims)} / {sum(x['G2'] for x in dims)}")
        if any(x != want for x in launches) or any(x != want_dim for x in dims):
            raise AssertionError(f"{impl} at head_dim 256: launches per step {launches} != {want} or at d256 {dims}")
        if not (params_finite and all(math.isfinite(x) for x in losses)):
            raise AssertionError(f"{impl} at head_dim 256: non-finite loss or parameters: {losses}")
        res[impl] = {"ms_per_step": step_ms, "losses": losses, "warm_loss": warm_loss, "peak_gib": peak / 2**30,
                     "profile": cats, "launches": launches, "oracle_cos": cos, "own_cotangent_cos": own_cos,
                     "g_d256": {kern: sum(x[kern] for x in dims) for kern in ("G1", "G2")}}
        del model, params
    return res


def hd256_spec_phase(model, prompt):
    """Phase 16's full-width verify path (spec_full_width_phase) on phase
    17's model with 256-wide heads: b1 from the first row of its 32,704-token
    prompt, int8 cache, spec_k 4, the int4-cache and w4 self-drafts, each
    token-equal to generate, every verify step on the T-token d256 variant."""
    return spec_full_width_phase(model, prompt, "spec18")


def hd256_spec_kernel_phase(gen):
    """Kernel D's T-token and INT8-PV instances at head_dim 256
    (decode_attention_multi_d256.cu): the d256 cases of utils/decode_cases.py
    (T 1-8 on the int8, bf16, int4 and k4v8 caches, both QK chains, the
    window / sink walk, the cap, INT8 PV with masked tiles) at phase 9's
    bounds, the same bits twice; then timed as phase 16 times them, at the
    hd256 LLM's shape (h16 hk8 S_max 32768 d256, every length 32768): the
    int8 cache at T 1, 2, 4, 8 at b1 and b4, the bf16, int4 and k4v8 caches
    at T 4 b1 (the bf16 rows beside SDPA with the causal tail mask), INT8 PV
    at T 1 and 4 b4."""
    from lowbit_quant_fa2_paddle_tpu_torch.ops.decode import quantize_token
    from lowbit_quant_fa2_paddle_tpu_torch.utils import decode_cases

    for name in (n for n in decode_cases.CASES if n.startswith("d256-")):
        r = decode_cases.check_case(name, gen)
        log(f"[D18] edge {name}: " + " ".join(f"{k}={v:.6g}" if isinstance(v, float) else f"{k}={v}"
                                              for k, v in r.items()))
        if not r["ok"]:
            raise AssertionError(f"kernel D's head_dim-256 edge case {name} disagrees with its plain version: {r}")
    h, hk, d, s = 16, 8, 256, 32768
    k = torch.randn(4, hk, s, d, generator=gen, device="cuda").bfloat16()
    v = torch.randn(4, hk, s, d, generator=gen, device="cuda").bfloat16()
    rec = {}
    shape = f"h{h} hk{hk} S_max {s} d{d}"
    for cache, k_bits, v_bits in (("int8", 8, 8), ("bf16", 16, 16), ("int4", 4, 4), ("k4v8", 4, 8)):
        (kq, ks), (vq, vs) = quantize_token(k, bits=k_bits), quantize_token(v, bits=v_bits)
        for b in (1, 4) if cache == "int8" else (1,):
            lens = torch.full((b,), s, dtype=torch.int32, device="cuda")
            for t in SPEC_T if cache == "int8" else (4,):
                q = torch.randn(b, t, h, d, generator=gen, device="cuda").bfloat16()
                rec[f"d256 {cache} T{t} b{b}"] = spec_record(
                    f"d256 {cache} cache, T {t}, b{b} {shape}", q, kq[:b], vq[:b], ks[:b], vs[:b], lens, k_bits,
                    v_bits, "auto", (k[:b], v[:b]) if cache in ("int8", "bf16") else None, "D18")
                if cache == "int8" and b == 4 and t in (1, 4):
                    rec[f"d256 int8 INT8 PV T{t} b{b}"] = spec_record(
                        f"d256 int8 cache, INT8 PV, T {t}, b{b} {shape}", q, kq, vq, ks, vs, lens, 8, 8, "int",
                        None, "D18")
        del kq, vq, ks, vs
    return rec



# ---------------------------------------------------------------------------
# Phase 19: kernel D over the paged cache, then the serving engine at full width
# ---------------------------------------------------------------------------

#: The paged kernel step's shape: the engine's decode tick at b8 (max_batch)
#: over 32K rows a sequence, phase 13's 32 query and 8 KV heads of 128.
PAGED_SHAPE = dict(b=8, h=32, hk=8, d=128, rows=32768)
PAGED_MODES = {"int8": (8, 8), "k4v8": (4, 8)}
PAGED_PAGES = (16, 64, 4096)


def paged_decode_phase(gen):
    """Kernel D over the paged cache: the edge grid of
    utils/decode_cases.py's PAGED_CASES (tiles across pages and pages of
    several tiles, lengths 0 and at page edges, T 1-4, window / sink, cap,
    INT8 PV, every cache mode, d32-d256; every unvisited page NaN) against
    the paged plain version on the kernel's tiles at phase 9's bounds, the
    same bits twice, every launch on the paged variant; then at b8 h32 hk8
    d128 with 32,768 rows a sequence in pages of 16, 64 and 4096 (the pages
    in a shuffled order) on the int8 and the k4v8 cache: against the plain
    version, timed beside the contiguous single-token kernel on the same
    rows (bytes bound: the cache once, the table, q and o)."""
    from lowbit_quant_fa2_paddle_tpu_torch.ops import decode as DD
    from lowbit_quant_fa2_paddle_tpu_torch.utils import decode_cases
    from lowbit_quant_fa2_paddle_tpu_torch.utils.benchmark import cuda_time_ms

    worst = 0.0
    # (Phase 25 runs the cases above head dim 256.)
    for case in (n for n, c in decode_cases.PAGED_CASES.items() if c[3] <= 256):
        r = decode_cases.check_paged_case(case, gen)
        log(f"[D19] {case}: " + " ".join(f"{k}={v:.6g}" if isinstance(v, float) else f"{k}={v}"
                                         for k, v in r.items()))
        if not r["ok"]:
            raise AssertionError(f"paged kernel D disagrees with its plain version ({case}): {r}")
        worst = max(worst, r["max_do"])
    sh = PAGED_SHAPE
    b, h, hk, d, rows = sh["b"], sh["h"], sh["hk"], sh["d"], sh["rows"]
    records = {}
    for mode, (kb, vb) in PAGED_MODES.items():
        k = torch.randn(b, hk, rows, d, generator=gen, device="cuda").bfloat16()
        v = torch.randn(b, hk, rows, d, generator=gen, device="cuda").bfloat16()
        q = torch.randn(b, h, d, generator=gen, device="cuda").bfloat16()
        lens = torch.full((b,), rows, dtype=torch.int32, device="cuda")
        kw = dict(k_bits=kb, v_bits=vb)
        contiguous_ms = None
        for page in PAGED_PAGES:
            pool, table, (kq, vq, ks, vs) = decode_cases.paged_pool(k, v, kb, vb, page, gen)
            if contiguous_ms is None:
                contiguous_ms = cuda_time_ms(lambda: DD.decode_attention(q, kq, vq, ks, lens, v_scale=vs, **kw),
                                             warmup=5, reps=50)
            del kq, vq, ks, vs

            def call(lse=False):
                return DD.decode_attention(q, pool["k"], pool["v"], pool["k_scale"], lens, v_scale=pool["v_scale"],
                                           page_table=table, return_lse=lse, **kw)

            n = DD.decode_attention.launches_by_variant.get(DD.launch_variant(1, 1, kb, vb, b, paged=True), 0)
            o, lse = call(True)
            o2, lse2 = call(True)
            on_variant = DD.decode_attention.launches_by_variant.get(
                DD.launch_variant(1, 1, kb, vb, b, paged=True), 0) == n + 2
            o_ref, lse_ref = DD.decode_attention_paged_plain(q, pool["k"], pool["v"], pool["k_scale"],
                                                             pool["v_scale"], lens, table, sm_scale=1.0 / math.sqrt(d),
                                                             int_qk=kb == 8, out_dtype=q.dtype)
            torch.cuda.synchronize()
            r = stats(o, o_ref, lse, lse_ref)
            same = torch.equal(o, o2) and torch.equal(lse, lse2)
            ulp = bf16_ulp(float(o_ref.float().abs().max()))
            if not (r["finite"] and r["cos"] >= COS_MIN and r["max_do"] <= ulp and r["max_dlse"] <= 1e-4 and same
                    and on_variant):
                raise AssertionError(f"paged kernel D disagrees with its plain version ({mode}, page {page}): {r}")
            del o, o2, lse, lse2, o_ref, lse_ref
            ms = cuda_time_ms(call, warmup=5, reps=50)
            plain_ms = cuda_time_ms(lambda: DD.decode_attention_paged_plain(
                q, pool["k"], pool["v"], pool["k_scale"], pool["v_scale"], lens, table, sm_scale=1.0 / math.sqrt(d),
                int_qk=kb == 8, out_dtype=q.dtype), warmup=1, reps=3)
            cache_bytes = b * hk * rows * ((d // 2 if kb == 4 else d) + (d // 2 if vb == 4 else d) + 8)
            lim = bound(cache_bytes + nbytes(table, lens) + 2 * nbytes(q))
            log(f"[D19] paged {mode} page {page} b{b} h{h} hk{hk} d{d} {rows} rows a sequence (shuffled pages): "
                f"cos={r['cos']:.7f} max_do={r['max_do']:.3g} max_dlse={r['max_dlse']:.3g} same_bits_twice={same}; "
                f"kernel {ms:.4f} ms ({cache_bytes / (ms * 1e-3) / 1e9:.1f} GB/s), contiguous kernel on the same "
                f"rows {contiguous_ms:.4f} ms ({ms / contiguous_ms:.3f}x), plain {plain_ms:.3f} ms, bound "
                f"{lim['bound_ms']:.4f} ms")
            records[(mode, page)] = {"max_abs_err": r["max_do"], "ms": ms, "plain_ms": plain_ms, **lim,
                                     "library_ms": None, "contiguous_ms": contiguous_ms, "design": "bulk_ring"}
            del pool, table
        del k, v
    log(f"[D19] {len(decode_cases.PAGED_CASES)} paged edge cases, worst max|do| {worst:.3g}")
    return records


#: Phase 19's traffic: 16 requests, prompt lengths below (the even ones
#: share a 4,096-token prefix), 64 new tokens each, pages of 64, 8 slots.
SERVE_NEW, SERVE_PAGE, SERVE_BATCH, SERVE_SHARED, SERVE_BUDGET = 64, 64, 8, 4096, 2048
SERVE_SHARED_LENS = (4160, 4500, 5000, 5800, 6400, 7100, 7800, 8192)
SERVE_OTHER_LENS = (1024, 2000, 2500, 3333, 4500, 6000, 7000, 8192)
# Run (b)'s pool: 396 pages, 45% of (a)'s peak of 872; lazy admission of this
# traffic preempts 21 times there (the count depends on the pages alone, not
# on the tokens). Above about half of the peak it admits with room for nearly
# every append.
SERVE_LAZY_POOL, SERVE_LAZY_PREEMPTIONS = 396, 16


def serve_prompts(vocab, seed=19):
    """The 16 prompts, from a seed: each a 256-token random block repeated
    to its length (so the n-gram index finds repeats); the even ones start
    with the same 4,096 tokens."""
    g = torch.Generator().manual_seed(seed)

    def blocks(n):
        block = torch.randint(0, vocab, (256,), generator=g)
        return block.repeat(-(-n // 256))[:n]

    shared = blocks(SERVE_SHARED)
    prompts = []
    for a, o in zip(SERVE_SHARED_LENS, SERVE_OTHER_LENS):
        prompts.append(torch.cat([shared, blocks(a - SERVE_SHARED)]).tolist())
        prompts.append(blocks(o).tolist())
    return prompts


def serve_run(tag, model, cfg, prompts, scfg, hook=None):
    """Serve ``prompts`` through one engine (``hook(engine)`` first, where
    given): streams, first-token logits, TTFT p50/p99, tokens/s, peak pages
    and memory, decode ticks skipped while a prompt was chunking, launch
    counts."""
    from lowbit_quant_fa2_paddle_tpu_torch import serving

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    count_reset()
    eng = serving.ServingEngine(model, cfg, scfg)
    first = first_logits(eng)
    if hook is not None:
        hook(eng)
    t0 = time.perf_counter()
    rids = [eng.add_request(p, SERVE_NEW) for p in prompts]
    ttft, peak_pages, skipped, steps = {}, 0, 0, 0
    decode_s, decode_tokens = 0.0, 0  # over the steps that prefilled nothing
    while len(eng.finished) < len(rids):
        live, ticks, chunks = bool(eng._active.any()), eng.decode_ticks, eng.prefill_chunks
        emitted = sum(len(o) for o in eng.outputs.values())
        t_step = time.perf_counter()
        eng.step()
        steps += 1
        skipped += live and eng.decode_ticks == ticks
        now = time.perf_counter()
        if eng.prefill_chunks == chunks:
            decode_s += now - t_step
            decode_tokens += sum(len(o) for o in eng.outputs.values()) - emitted
        ttft.update({r: now - t0 for r in rids if r not in ttft and eng.outputs[r]})
        peak_pages = max(peak_pages, scfg.num_pages - eng.sched.stats()["free_pages"])
        if steps > 20000:
            raise AssertionError(f"{tag}: the engine did not drain")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    streams = [eng.finished[r] for r in rids]
    out = sum(len(s) for s in streams)
    t = sorted(ttft.values())
    res = {"rids": rids, "streams": streams, "first_logits": [first[r] for r in rids], "stats": eng.stats(),
           "wall_s": wall, "tokens_out": out, "tokens_per_s": out / wall,
           "decode_tokens_per_s": decode_tokens / decode_s if decode_s else None, "ttft_p50_s": statistics.median(t),
           "ttft_p99_s": statistics.quantiles(t, n=100, method="inclusive")[98], "peak_pages": peak_pages,
           "peak_gib": torch.cuda.max_memory_allocated() / 2**30, "skipped_ticks": skipped,
           "launches": counts(), "variants": variant_counts(), "decode_ticks": eng.decode_ticks,
           "multi_segments": eng.multi_segments, "prefill_chunks": eng.prefill_chunks}
    if not all(len(s) == SERVE_NEW and all(0 <= x < cfg.vocab for x in s) for s in streams):
        raise AssertionError(f"{tag}: bad streams (lengths {[len(s) for s in streams]})")
    st = res["stats"]
    log(f"[serve] {tag}: {len(rids)} requests, {out} tokens out in {wall:.2f} s ({res['tokens_per_s']:.1f} tokens/s; "
        f"decode {decode_tokens} tokens in {decode_s:.2f} s of steps without a prefill, "
        f"{res['decode_tokens_per_s'] or 0:.1f} tokens/s), "
        f"TTFT p50 {res['ttft_p50_s']:.3f} s p99 {res['ttft_p99_s']:.3f} s, {eng.decode_ticks} decode ticks, "
        f"{eng.prefill_chunks} prefill chunks, peak {peak_pages} of {scfg.num_pages} pages, peak "
        f"{res['peak_gib']:.2f} GiB; preemptions {st['preemptions']}, prefix hits {st.get('prefix_hits')}, spec "
        f"rounds {st.get('spec_rounds')} ({st.get('spec_tokens_per_round')} tokens a round), multi-step segments "
        f"{eng.multi_segments}; launches {res['launches']}, D by variant {res['variants']}")
    del eng
    return res


def serve_config(prompts, **kw):
    """The engine configuration of phase 19: pages of 64, 8 slots, a pool
    of every request's worst case (prompt + 64 new + the speculative
    slack), a table wide enough for the longest."""
    from lowbit_quant_fa2_paddle_tpu_torch import serving

    worst = [-(-(len(p) + SERVE_NEW + 4) // SERVE_PAGE) for p in prompts]
    base = dict(page_size=SERVE_PAGE, num_pages=sum(worst), max_batch=SERVE_BATCH, max_pages_per_seq=max(worst),
                prefix_caching=False)
    return serving.ServingConfig(**{**base, **kw})


def first_logits(eng):
    """Each request's first-token logits (its prefill's, f32 on the host),
    by rid, kept as the engine hands them to ``_finish_prefill``."""
    first, finish = {}, eng._finish_prefill

    def keep(rid, logits, *rest):
        first[rid] = logits.float().cpu()
        return finish(rid, logits, *rest)

    eng._finish_prefill = keep
    return first


def first_logits_cos(a, b, which):
    from lowbit_quant_fa2_paddle_tpu_torch.ops.metrics import cosine_similarity

    return [float(cosine_similarity(a["first_logits"][i], b["first_logits"][i])) for i in which]


# (e): a verify row's logits against the single-token tick's recomputation
# of the same row, and how far (e)'s row may put (a)'s token below its own
# where the streams part, in units of the largest row difference seen. The
# verify tick runs its dense layers at M = B·T rows and the tick at M = B:
# their matmuls round differently, and so do the rows they write.
SPEC_ROW_COS, SPEC_TIE = 0.9999, 4.0


def verify_programs_wrapped(eng, wrap):
    """``eng``'s verify programs handed out as ``wrap(program)``: a callable
    the engine calls as it calls the program."""
    program = eng._program

    def get(kind, n=0):
        prog = program(kind, n)
        return wrap(prog) if kind == "verify" else prog

    eng._program = get


def spec_rows_recorded(rows, eng):
    """Keeps, for each live request of ``eng``, the verify row that scored
    each of its tokens: ``rows[rid][i]`` (f32 on the host) for output ``i``
    (a later round's row replaces a rejected one's)."""
    def wrap(prog):
        def run(*inputs):
            logits = prog(*inputs)
            host = logits.float().cpu()
            for slot in eng._active.nonzero()[0]:
                rid = int(eng._slot_rid[slot])
                base = len(eng.outputs[rid])
                for i in range(host.shape[1]):
                    rows.setdefault(rid, {})[base + i] = host[slot, i]
            return logits
        return run

    verify_programs_wrapped(eng, wrap)


def spec_rows_check(model, cfg, prompts, ticks=2):
    """(e)'s row check: 8 requests of the traffic's first 2,048 tokens
    through an engine with spec_ngram 3, spec_k 4; on each of its first
    ``ticks`` verify ticks (the first eager, the second captured) every live
    row's logits against the single-token tick's recomputation of that row
    (``_spec_decode_step`` at T = 1 from the same pages, row after row, each
    writing its own K/V row; then the verify program again, so the engine
    goes on from its own rows): cos >= SPEC_ROW_COS. Returns the smallest
    cos, the largest |logit difference| and whether the verify program's
    second run gave the same bits."""
    from lowbit_quant_fa2_paddle_tpu_torch import serving
    from lowbit_quant_fa2_paddle_tpu_torch.ops.metrics import cosine_similarity

    seen = []
    short = [p[:2048] for p in prompts[:SERVE_BATCH]]
    eng = serving.ServingEngine(model, cfg, serve_config(short, spec_ngram=3, spec_k=4))

    def wrap(prog):
        def run(*inputs):
            logits = prog(*inputs)
            if len(seen) >= ticks:
                return logits
            ver = logits.clone()
            t = ver.shape[1]
            single = torch.stack([serving._spec_decode_step(
                eng.params, eng.caches, prog.tokens[:, i : i + 1], prog.lengths - (t - 1 - i), prog.table,
                prog.active, **eng._step_kw())[:, 0] for i in range(t)], dim=1)
            again = prog(*inputs)
            live = prog.active.nonzero()[:, 0]
            v, one = ver[live].float(), single[live].float()
            cos = [float(cosine_similarity(v[j, i], one[j, i])) for j in range(len(live)) for i in range(t)]
            seen.append((min(cos), float((v - one).abs().max()), bool(torch.equal(again, ver))))
            return again
        return run

    verify_programs_wrapped(eng, wrap)
    for p in short:
        eng.add_request(p, SERVE_NEW)
    while len(seen) < ticks and not eng.finished:
        eng.step()
    res = {"min_cos": min(c for c, _, _ in seen), "max_abs": max(m for _, m, _ in seen),
           "rerun_equal": all(e for _, _, e in seen), "ticks": len(seen)}
    prog = next(p for k, p in eng._programs.items() if k[0] == "verify")
    if prog.device.type == "cuda":  # the verify tick's host wall and its graph's device ms
        if prog.graph is None:
            raise AssertionError("the verify tick was not captured as a CUDA graph")
        walls = []
        for _ in range(4):
            t0 = time.perf_counter()
            eng.step()
            walls.append((time.perf_counter() - t0) * 1e3)
        res.update(host_wall_ms=statistics.median(walls),
                   replay_ms=statistics.median(cuda_event_ms(prog.graph.replay) for _ in range(5)))
        log(f"[serve] (e) verify tick at {SERVE_BATCH} live slots x 4 tokens (contexts ~2K): host wall of step() "
            f"median {res['host_wall_ms']:.3f} ms, one graph replay {res['replay_ms']:.3f} ms on the device")
    del eng, prog
    log(f"[serve] (e) verify rows against single-token ticks, {len(seen)} verify ticks of {SERVE_BATCH} slots x 4 "
        f"rows: min cos {res['min_cos']:.7f}, max |logit difference| {res['max_abs']:.4g}; the verify program run "
        f"again gave the same bits: {res['rerun_equal']}")
    if len(seen) < ticks or res["min_cos"] < SPEC_ROW_COS:
        raise AssertionError(f"(e) rows: {seen} (cos bound {SPEC_ROW_COS})")
    return res


def spec_divergence(e, a, rows):
    """Where (e)'s streams part from (a)'s: (request, first differing
    token, (e)'s row's logit of its own token less that of (a)'s token),
    inf where no verify row scored that token (the prefill's first)."""
    split = []
    for n, (rid, x, y) in enumerate(zip(e["rids"], e["streams"], a["streams"])):
        p = next((i for i, (u, v) in enumerate(zip(x, y)) if u != v), None)
        if p is not None:
            row = rows.get(rid, {}).get(p)
            split.append((n, p, math.inf if row is None else float(row[x[p]] - row[y[p]])))
    return split


def tick_measure(model, cfg, prompts):
    """The decode tick at 8 live slots (8 requests of the traffic's first
    2,048 tokens, the tick's graph captured): host wall of ``step()`` (to
    the tokens on the host) over 8 ticks against the device ms of one graph
    replay between CUDA events, and one tick under torch.profiler by kernel
    class (D, the GEMMs, the rest)."""
    from lowbit_quant_fa2_paddle_tpu_torch import serving

    scfg = serve_config([p[:2048] for p in prompts[:SERVE_BATCH]])
    eng = serving.ServingEngine(model, cfg, scfg)
    for p in prompts[:SERVE_BATCH]:
        eng.add_request(p[:2048], 40)
    for _ in range(4):  # admission and prefill, the eager tick, the capture
        eng.step()
    torch.cuda.synchronize()
    walls = []
    for _ in range(8):
        t0 = time.perf_counter()
        eng.step()
        walls.append((time.perf_counter() - t0) * 1e3)
    prog = next(p for k, p in eng._programs.items() if k[0] == "decode")
    if prog.graph is None:
        raise AssertionError("the decode tick was not captured as a CUDA graph")
    replay = [cuda_event_ms(prog.graph.replay) for _ in range(5)]
    cats = profile_classes(eng.step, {"D": ("decode_kernel",), "GEMM": GEMM_NAMES})[0]
    res = {"host_wall_ms": statistics.median(walls), "replay_ms": statistics.median(replay), "profile": cats}
    log(f"[serve] decode tick at {SERVE_BATCH} live slots (contexts ~2K): host wall of step() median "
        f"{res['host_wall_ms']:.3f} ms (min {min(walls):.3f}), one graph replay {res['replay_ms']:.3f} ms on the "
        f"device; profiled tick device ms: " + ", ".join(f"{k} {v:.3f}" for k, v in cats.items()))
    del eng
    return res


def serving_phase(model):
    """Phase 19: the serving engine (ServingEngine over the paged int8
    cache) at full width on phase 13's model: 16 requests of 1,024-8,192
    tokens (8 sharing a 4,096-token prefix), 64 new tokens each, pages of
    64, 8 slots. Runs (a) reserve, no prefix cache (the reference streams);
    (b) lazy admission on a pool of SERVE_LAZY_POOL pages, 45% of (a)'s
    peak (at least SERVE_LAZY_PREEMPTIONS preemptions, streams equal
    (a)'s); (c) the prefix cache (hit pages > 0, the hit requests'
    first-token logits cos >= 0.999 against (a)'s); (d) budget 2048
    (one-chunk prompts' streams equal (a)'s, every first-token logits cos >=
    0.999, no decode tick skipped while chunking); (e) spec_ngram 3, spec_k
    4, the verify tick batched as in JAX (each verify row at cos >=
    SPEC_ROW_COS against a single-token tick's recomputation, and streams
    equal (a)'s up to a near-tie: where one parts from (a)'s, (e)'s row
    puts (a)'s token at most SPEC_TIE times the rows' largest difference
    below its own); (f) multi_step 8, and async_fetch (streams equal
    (a)'s); (g) k4v8 pages and w8 weights (logged); then the decode tick's
    host wall against its device ms and its profile."""
    from lowbit_quant_fa2_paddle_tpu_torch.models import llm

    cfg = dataclasses.replace(model.cfg, max_seq=8192 + SERVE_NEW + 8)
    prompts = serve_prompts(cfg.vocab)
    res = {}
    a = res["a"] = serve_run("(a) reserve", model, cfg, prompts, serve_config(prompts))
    for name in ("A", "C1", "D"):
        if not a["launches"][name]:
            raise AssertionError(f"(a): kernel {name} was not launched on the serving path")
    if set(a["variants"]) != {f"paged T-token T1 k8v8 b{SERVE_BATCH}"}:
        raise AssertionError(f"(a): kernel D ran other variants than the paged tick: {a['variants']}")
    pool = SERVE_LAZY_POOL
    b = res["b"] = serve_run(f"(b) lazy, pool {pool} pages ({pool / a['peak_pages']:.1%} of (a)'s peak "
                             f"{a['peak_pages']})", model, cfg, prompts,
                             serve_config(prompts, admission="lazy", num_pages=pool))
    if b["stats"]["preemptions"] < SERVE_LAZY_PREEMPTIONS or b["streams"] != a["streams"]:
        raise AssertionError(f"(b): preemptions {b['stats']['preemptions']}, streams equal (a)'s "
                             f"{b['streams'] == a['streams']}")
    c = res["c"] = serve_run("(c) prefix cache", model, cfg, prompts, serve_config(prompts, prefix_caching=True))
    hits = [i for i in range(0, len(prompts), 2)][1:]  # the shared-prefix requests after the first
    cos_c = first_logits_cos(c, a, hits)
    log(f"[serve] (c) hit requests' first-token logits cos against (a): {[round(x, 6) for x in cos_c]}; streams "
        f"equal (a)'s on {sum(x == y for x, y in zip(c['streams'], a['streams']))} of {len(prompts)}")
    if c["stats"]["prefix_hits"] <= 0 or min(cos_c) < 0.999:
        raise AssertionError(f"(c): prefix hits {c['stats']['prefix_hits']}, first-token cos {cos_c}")
    d = res["d"] = serve_run(f"(d) prefill budget {SERVE_BUDGET}", model, cfg, prompts,
                             serve_config(prompts, prefill_budget=SERVE_BUDGET))
    short = [i for i, p in enumerate(prompts) if len(p) <= SERVE_BUDGET]
    cos_d = first_logits_cos(d, a, range(len(prompts)))
    log(f"[serve] (d) first-token logits cos against (a): min {min(cos_d):.6f}; one-chunk requests {short}; decode "
        f"ticks skipped while chunking {d['skipped_ticks']}")
    if (any(d["streams"][i] != a["streams"][i] for i in short) or min(cos_d) < 0.999 or d["skipped_ticks"]
            or not short):
        raise AssertionError(f"(d): short streams equal {[d['streams'][i] == a['streams'][i] for i in short]}, "
                             f"min cos {min(cos_d)}, skipped ticks {d['skipped_ticks']}")
    rows_check = res["e rows"] = spec_rows_check(model, cfg, prompts)
    rows = {}
    e = res["e"] = serve_run("(e) spec_ngram 3, spec_k 4", model, cfg, prompts,
                             serve_config(prompts, spec_ngram=3, spec_k=4),
                             hook=functools.partial(spec_rows_recorded, rows))
    tie = SPEC_TIE * rows_check["max_abs"]
    split = spec_divergence(e, a, rows)
    log(f"[serve] (e) streams equal (a)'s on {len(prompts) - len(split)} of {len(prompts)}; the others first differ "
        f"at (request, token, (e)'s row's logit of its token over (a)'s token's): {split}; near-tie bound {tie:.4g} "
        f"({SPEC_TIE} x the rows' largest |logit difference|)")
    if not e["stats"]["spec_rounds"] or any(gap > tie for _, _, gap in split):
        raise AssertionError(f"(e): spec rounds {e['stats']['spec_rounds']}, streams parting at a logit gap above "
                             f"{tie:.4g}: {[x for x in split if x[2] > tie]}")
    for tag, kw in (("(f) multi_step 8", dict(multi_step=8)), ("(f) async_fetch", dict(async_fetch=True))):
        f = res[tag] = serve_run(tag, model, cfg, prompts, serve_config(prompts, **kw))
        if f["streams"] != a["streams"] or ("multi" in tag and not f["multi_segments"]):
            raise AssertionError(f"{tag}: streams equal (a)'s {[x == y for x, y in zip(f['streams'], a['streams'])]}")
    res["g k4v8"] = serve_run("(g) k4v8 pages", model, cfg, prompts, serve_config(prompts, k_bits=4, v_bits=8))
    w8 = llm.quantize_llm_params(model, bits=8)
    res["g w8"] = serve_run("(g) w8 weights", w8, cfg, prompts, serve_config(prompts))
    agree = sum(x == y for x, y in zip(res["g w8"]["streams"], a["streams"]))
    log(f"[serve] (g) streams equal (a)'s: k4v8 pages {sum(x == y for x, y in zip(res['g k4v8']['streams'], a['streams']))}"
        f", w8 weights {agree} of {len(prompts)}")
    del w8
    if torch.cuda.is_available():
        res["tick"] = tick_measure(model, cfg, prompts)
    for r in res.values():
        for key in ("first_logits", "streams", "rids"):
            r.pop(key, None)
    return res


def serving_window_phase(model):
    """Phase 19 (h): phase 15's window-4096 model (phase 13's weights), 4
    requests of 12,288 tokens, 64 new, pages of 64, with a prefill budget
    of 2048 and then of 12,288 (one chunk): the live pages of every request
    stay within window / page + 3 after its first decode tick (rolling
    reclamation); against that model's ``generate`` (b4, one-shot prefill,
    graph decode), both runs' tokens are equal and their first-token logits
    at cos >= 0.999 (the budget-2048 run's chunks see the quantized rows of
    the chunks before them, JAX's approximation class). generate runs each
    prompt's prefill alone and the decode at b4: the engine's row counts."""
    from lowbit_quant_fa2_paddle_tpu_torch import serving
    from lowbit_quant_fa2_paddle_tpu_torch.models import llm
    from lowbit_quant_fa2_paddle_tpu_torch.ops.metrics import cosine_similarity

    n_req, s = 4, 12288
    cfg = dataclasses.replace(model.cfg, max_seq=s + SERVE_NEW, window_size=4096, sink_size=0)
    g = torch.Generator(device="cuda").manual_seed(21)
    prompts = torch.randint(0, cfg.vocab, (n_req, s), generator=g, device="cuda")
    # generate's two stages with the engine's row counts (a matmul's rounding
    # depends on them): each prompt's prefill alone, as the engine prefills
    # a request, then the b4 graph decode, as its 4 slots decode.
    firsts, parts = [], []
    for p in prompts:
        logits, caches = llm.llm_prefill(model, p[None], cfg)
        firsts.append(logits[0, -1].float())
        parts.append(caches)
        del logits
    caches = [{key: torch.cat([c[i][key] for c in parts]) for key in parts[0][i]} for i in range(cfg.depth)]
    del parts
    want_first = torch.stack(firsts).cpu()
    token = torch.argmax(torch.stack(firsts), dim=-1).to(torch.int32)
    steps, _ = llm.decode_tokens(model, token, caches, SERVE_NEW - 1, cfg)
    want = torch.cat([token[:, None], steps], dim=1).cpu()
    del caches, steps, firsts
    limit = cfg.window_size // SERVE_PAGE + 3
    res = {}
    for budget in (SERVE_BUDGET, s):
        scfg = serving.ServingConfig(page_size=SERVE_PAGE, num_pages=n_req * (s + SERVE_NEW) // SERVE_PAGE + 8,
                                     max_batch=n_req, prefill_budget=budget, prefix_caching=False)
        count_reset()
        eng = serving.ServingEngine(model, cfg, scfg)
        first = first_logits(eng)
        rids = [eng.add_request(p.tolist(), SERVE_NEW) for p in prompts]
        live, t0 = 0, time.perf_counter()
        while len(eng.finished) < n_req:
            eng.step()
            for r in rids:
                if r not in eng.finished and len(eng.outputs[r]) >= 2:
                    live = max(live, sum(p >= 0 for p in eng.sched.page_table(r)))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = torch.tensor([eng.finished[r] for r in rids], dtype=torch.int32)
        cos = min(float(cosine_similarity(first[r], want_first[i])) for i, r in enumerate(rids))
        agree = float((got == want).float().mean())
        launches = counts()
        del eng
        log(f"[serve] (h) window 4096, {n_req} x {s} tokens, budget {budget}: {wall:.2f} s, max live pages a request "
            f"{live} (limit {limit}), first-token logits cos against generate's min {cos:.6f}, tokens equal "
            f"generate's {bool(torch.equal(got, want))} (agreement {agree:.4f}), launches {launches}")
        if live > limit or cos < 0.999 or not torch.equal(got, want):
            raise AssertionError(f"(h) budget {budget}: live pages {live} (limit {limit}), first-token cos {cos}, "
                                 f"token agreement {agree}")
        res[budget] = {"wall_s": wall, "live_pages": live, "first_cos": cos, "agreement": agree, "launches": launches}
    return res


def serving_checkpoint_phase():
    """Phase 19 (i): the trained checkpoint through the engine, 64 prompts,
    4 new tokens, int8, int4 and k4v8 pages: the task exact-match equals the
    port's generate's on the same cache mode; then spec_ngram 3, spec_k 4
    on int8 pages, whose streams equal the int8 run's token for token (the
    checkpoint's argmax has no near-ties for the verify tick's rounding to
    flip)."""
    from lowbit_quant_fa2_paddle_tpu_torch import serving
    from lowbit_quant_fa2_paddle_tpu_torch.models import llm
    from lowbit_quant_fa2_paddle_tpu_torch.models import train as T
    from lowbit_quant_fa2_paddle_tpu_torch.utils.checkpoint import load_params_npz

    model = llm.params_from_jax(load_params_npz(os.path.join(REPO, "eval_out", "arith_llm.npz")),
                                T.arith_llm_config(), device="cuda")
    prompts, answers = T.make_eval_prompts(64)
    res, streams = {}, {}
    for mode, (kb, vb), opts in (("int8", (8, 8), {}), ("int4", (4, 4), {}), ("k4v8", (4, 8), {}),
                                 ("int8 spec_ngram 3", (8, 8), dict(spec_ngram=3, spec_k=4))):
        cfg = T.arith_llm_config(k_bits=kb, v_bits=vb)
        eng = serving.ServingEngine(model, cfg, serving.ServingConfig(
            page_size=8, num_pages=64 * 6, max_batch=16, k_bits=kb, v_bits=vb, prefix_caching=False, **opts))
        rids = [eng.add_request(p.tolist(), T.ANS_LEN) for p in prompts]
        out = eng.run()
        streams[mode] = [out[r] for r in rids]
        em_engine = sum(T.grade_answer(out[r], a) for r, a in zip(rids, answers)) / len(answers)
        gen_toks = llm.generate(model, torch.from_numpy(prompts).cuda(), T.ANS_LEN, cfg).cpu().numpy()
        em_gen = sum(T.grade_answer(row, a) for row, a in zip(gen_toks, answers)) / len(answers)
        same = sum(out[r] == row.tolist() for r, row in zip(rids, gen_toks))
        rounds = eng.stats().get("spec_rounds")
        log(f"[serve] (i) checkpoint, {mode} pages: exact-match engine {em_engine:.4f}, generate {em_gen:.4f}; "
            f"streams equal generate's on {same} of 64" + (f"; {rounds} spec rounds" if opts else ""))
        if em_engine != em_gen:
            raise AssertionError(f"(i) {mode}: engine exact-match {em_engine} != generate's {em_gen}")
        if opts and (streams[mode] != streams["int8"] or not rounds):
            raise AssertionError(f"(i) {mode}: {rounds} spec rounds; streams equal the int8 run's on "
                                 f"{sum(x == y for x, y in zip(streams[mode], streams['int8']))} of 64")
        res[mode] = {"exact_match": em_engine, "generate_exact_match": em_gen, "streams_equal": same}
    return res


# ---------------------------------------------------------------------------
# Phase 20: kernel D at head dims 80 and 96, and a full-width LLM with
# Phi-3-mini's attention geometry (generate, speculative decoding, serving,
# the quantized cache's checkpoint).
# ---------------------------------------------------------------------------

#: microsoft/Phi-3-mini-4k-instruct's config.json: hidden_size 3072, 32
#: attention heads and 32 KV heads (head dim 96), 32 layers, vocab_size
#: 32064, max_position_embeddings 4096, rope_theta 10000. The MLP is
#: LLMConfig's 4·d, so the model has Phi-3-mini's attention geometry and the
#: repo's MLP. Depth 16 of its 32 layers, for the run's time limit (the
#: widths whole; 1.91 B parameters).
PHI3 = dict(vocab=32064, dim=3072, depth=16, num_heads=32, num_kv_heads=32, max_seq=4096, rope_theta=10000.0)
PHI3_BATCH, PHI3_PROMPT, PHI3_NEW = 8, 3968, 64
#: Kernel D's timed shapes off the ladder, (b, h, hk, S_max): Phi-3-mini's
#: decode at b8 (head dim 96) and Phi-2's (32 query and 32 KV heads of 80,
#: its 2K context).
OFFLADDER_SHAPES = {96: (8, 32, 32, 4096), 80: (8, 32, 32, 2048)}
#: The engine's traffic: 8 requests of 1,024-3,968 tokens, 32 new each, over
#: pages of 64 in 8 slots.
PHI3_SERVE_LENS, PHI3_SERVE_NEW = (1024, 1500, 2000, 2500, 3000, 3333, 3700, 3968), 32
#: Where an engine stream parts from generate's, generate's row may put the
#: engine's token at most this many times the largest |logit difference|
#: between a decode step at b1 and the same step at b8 (the engine's 8
#: slots) below its own token (phase 19 (e)'s rule).
PHI3_TIE = 4.0


def dim_edge_phase(gen, dims, tag):
    """Kernel D's edge cases of utils/decode_cases.py at the head dims
    ``dims``, contiguous and paged: every cache mode and both QK chains, T
    1-8 at tile and split edges, a window with sinks, the cap, INT8 PV, rows
    that end inside a QK window or are not 16-byte multiples; phase 9's
    bounds, the same bits twice, every launch on the case's variant and at
    the case's head dim. Returns the worst max|do| by head dim."""
    from lowbit_quant_fa2_paddle_tpu_torch.ops import decode as DD
    from lowbit_quant_fa2_paddle_tpu_torch.utils import decode_cases

    worst = {}
    cases = [(n, False) for n, c in decode_cases.CASES.items() if c[3] in dims] + [
        (n, True) for n, c in decode_cases.PAGED_CASES.items() if c[3] in dims]
    for name, paged in cases:
        d = (decode_cases.PAGED_CASES if paged else decode_cases.CASES)[name][3]
        n = DD.decode_attention.launches_by_dim[d]
        r = (decode_cases.check_paged_case if paged else decode_cases.check_case)(name, gen)
        # Two kernel calls a case (and the paged case's contiguous call on the same rows).
        r["on_dim"] = DD.decode_attention.launches_by_dim[d] - n == (3 if paged else 2)
        log(f"[{tag}] {name}: " + " ".join(f"{k}={v:.6g}" if isinstance(v, float) else f"{k}={v}"
                                           for k, v in r.items()))
        if not (r["ok"] and r["on_dim"]):
            raise AssertionError(f"kernel D at d{d} disagrees with its plain version ({name}): {r}")
        worst[d] = max(worst.get(d, 0.0), r["max_do"])
    log(f"[{tag}] {len(cases)} cases at head dims {dims}; worst max|do| by head dim {worst}")
    return worst


def offladder_edge_phase(gen):
    """dim_edge_phase at head dims 80 and 96 (decode_attention*_d80_96.cu):
    4-bit rows of 40 bytes with window phases that start at odd keys, pages
    of 8-64."""
    return dim_edge_phase(gen, (80, 96), "D20")


def prefill_k_quant_phase(gen, b, hk, s, d, tag, unpadded=True):
    """Kernel C1 at a prefill's K (b, hk KV heads, s rows of d): the int8
    entry point pads K to 128 columns first (the JAX launcher's multiple of
    64), so the model's C1 runs on 128-wide rows, the vector design; with
    ``unpadded``, a K left d wide (not 4-32 lanes of 16 bytes) takes the
    scalar design. Each: codes and scales bit-equal to quant_int8_plain, the
    launch on the design, then timed."""
    from lowbit_quant_fa2_paddle_tpu_torch.core import _pad_head_dim
    from lowbit_quant_fa2_paddle_tpu_torch.ops.quant import k_mean, kernel_design, quant_int8, quant_int8_plain

    recs = {}
    for vtag, pad in (("padded to 128", True),) + (((f"{d} wide", False),) if unpadded else ()):
        def make():
            k = (torch.randn(b, hk, s, d, generator=gen, device="cuda") + 0.5).bfloat16()
            return _pad_head_dim(k) if pad else k
        k = make()
        km = k_mean(k)
        design = kernel_design(k, 8, True, 128)
        n = quant_int8.launches_by_design[design]
        codes, scale = quant_int8(k, km, gran="per_token")
        on_design = quant_int8.launches_by_design[design] == n + 1
        want_c, want_s = quant_int8_plain(k, km, per_token=True, block=128)
        torch.cuda.synchronize()
        same = torch.equal(codes, want_c) and torch.equal(scale, want_s)
        log(f"[{tag}] prefill K b{b} h{hk} s{s} d{d} {vtag} ({design}): codes_equal="
            f"{torch.equal(codes, want_c)} scales_equal={torch.equal(scale, want_s)} on_design={on_design}")
        if not (same and on_design and (design == "vector") == pad):
            raise AssertionError(f"kernel C1 at the prefill's K ({vtag}): design {design}, equal {same}")
        del k, km, codes, scale, want_c, want_s
        recs[vtag] = {"max_abs_err": 0.0, **time_quant(tag, f"b{b} h{hk} s{s} d{d} {vtag}", quant_int8,
                                                       quant_int8_plain, [make(), make()], "per_token", 128, 8)}
    return recs


def offladder_quant_phase(gen):
    """prefill_k_quant_phase at the Phi-3-mini-geometry prefill's K (b8, 32
    KV heads, 3,968 rows of 96), padded and left 96 wide (192-byte rows)."""
    return prefill_k_quant_phase(gen, PHI3_BATCH, 32, PHI3_PROMPT, 96, "C1-20")


def phi3_prefill_attention_phase(gen):
    """Kernel A at one batch row of the Phi-3-mini-geometry prefill (b1 h32
    hk32 s3968 causal; int8 K codes, Q quantized in the kernel), head dim 96
    zero-padded to the d128 kernel by the entry point, as llm_prefill calls
    it: the same bits twice and every launch at kernel dim 128, against
    attention_fwd_plain at d96 at phase 4's bounds, then timed beside the
    plain version and SDPA in bf16 (time_attention)."""
    return time_attention(gen, "fused", PHI3["num_heads"], PHI3["num_kv_heads"], PHI3_PROMPT,
                          PHI3["dim"] // PHI3["num_heads"], True)


def decode_rows_phase(gen, shapes, tag, spec_shape, paged_shape):
    """Kernel D timed in every cache mode of DECODE_MODES at ``shapes`` ({d:
    (b, h, hk, S_max)}, every length S_max), against its plain version at
    phase 9's bounds, with the cache's byte bound and SDPA's time (one
    query a head over the bf16 cache of that shape) as the library
    baseline, with the backend SDPA's dispatch picked for that call; then
    the T-token instance at ``spec_shape`` (d, b, h, hk, S_max; T 4, int8:
    the speculative verify step) and the paged one at ``paged_shape`` (d,
    b, h, hk, rows a sequence; pages of 64 in a shuffled pool, int8: the
    serving engine's tick; no library call)."""
    from lowbit_quant_fa2_paddle_tpu_torch.ops import decode as DD
    from lowbit_quant_fa2_paddle_tpu_torch.utils import decode_cases
    from lowbit_quant_fa2_paddle_tpu_torch.utils.benchmark import cuda_time_ms

    sdpa = torch.nn.functional.scaled_dot_product_attention
    records = {}

    def record(key, call, plain, byte_tensors, q, library_ms, library_backend):
        o, lse = call()
        o2, lse2 = call()
        o_ref, lse_ref = plain()
        torch.cuda.synchronize()
        r = stats(o, o_ref, lse, lse_ref)
        ulp = bf16_ulp(float(o_ref.float().abs().max()))
        same = torch.equal(o, o2) and torch.equal(lse, lse2)
        log(f"[{tag}] {key}: " + " ".join(f"{k}={v:.6g}" if isinstance(v, float) else f"{k}={v}"
                                          for k, v in r.items()) + f" bf16_ulp={ulp:.3g} same_bits_twice={same}")
        if not (r["finite"] and r["cos"] >= COS_MIN and r["max_do"] <= ulp and r["max_dlse"] <= 1e-4 and same):
            raise AssertionError(f"kernel D disagrees with its plain version ({key}): {r}")
        ms = cuda_time_ms(call, warmup=5, reps=50)
        plain_ms = cuda_time_ms(plain, warmup=1, reps=3)
        moved = nbytes(*byte_tensors) + nbytes(q) * 2
        lim = bound(moved)
        log(f"[{tag}] {key}: kernel {ms:.4f} ms ({moved / (ms * 1e-3) / 1e9:.1f} GB/s of {moved / 1e6:.1f} MB), plain "
            f"{plain_ms:.4f} ms, bound {lim['bound_ms']:.4f} ms ({lim['bound_ms'] / ms:.0%}), SDPA {library_ms}")
        records[key] = {"max_abs_err": r["max_do"], "ms": ms, "plain_ms": plain_ms, **lim, "library_ms": library_ms,
                        "library_backend": library_backend, "design": DD.kernel_design()}

    for d, (b, h, hk, s) in shapes.items():
        qb = torch.randn(b, h, d, generator=gen, device="cuda").bfloat16()
        kb, vb = (torch.randn(b, hk, s, d, generator=gen, device="cuda").bfloat16() for _ in range(2))
        lib = cuda_time_ms(lambda: sdpa(qb[:, :, None], kb, vb, enable_gqa=True), warmup=3, reps=20)
        lib_backend = sdpa_picked(qb[:, :, None], kb, vb, enable_gqa=True)
        del qb, kb, vb
        for mode in DECODE_MODES:
            kargs, kkw, pargs, pkw = decode_inputs(gen, b, h, hk, d, s, mode, [s] * b)
            n = DD.decode_attention.launches_by_dim[d]
            record(f"d{d} {mode} cache b{b} h{h} hk{hk} S_max {s}",
                   lambda: DD.decode_attention(*kargs, **kkw, return_lse=True),
                   lambda: DD.decode_attention_plain(*pargs, **pkw), [x for x in pargs[1:5] if x is not None],
                   pargs[0], lib, lib_backend)
            if DD.decode_attention.launches_by_dim[d] == n:
                raise AssertionError(f"kernel D at d{d} was not launched")
            del kargs, pargs
    # The T-token (verify) and paged (engine tick) instances, int8.
    d, b, h, hk, s = spec_shape
    k = torch.randn(b, hk, s, d, generator=gen, device="cuda").bfloat16()
    v = torch.randn(b, hk, s, d, generator=gen, device="cuda").bfloat16()
    (kq, ks), (vq, vs) = DD.quantize_token(k, bits=8), DD.quantize_token(v, bits=8)
    q = torch.randn(b, 4, h, d, generator=gen, device="cuda").bfloat16()
    lens = torch.full((b,), s, dtype=torch.int32, device="cuda")
    plan = DD.kernel_partition(q, kq, vq, int_qk=True)
    record(f"d{d} T4 int8 cache b{b} h{h} hk{hk} S_max {s} (verify step)",
           lambda: DD.decode_attention(q, kq, vq, ks, lens, v_scale=vs, return_lse=True),
           lambda: DD.decode_attention_plain(q, kq, vq, ks, vs, lens, sm_scale=d ** -0.5, int_qk=True,
                                             out_dtype=q.dtype, split_keys=plan["split_keys"], warps=plan["warps"]),
           [kq, vq, ks, vs], q,
           cuda_time_ms(lambda: sdpa(q.transpose(1, 2), k, v, enable_gqa=True), warmup=3, reps=20),
           sdpa_picked(q.transpose(1, 2), k, v, enable_gqa=True))
    del k, v, kq, vq, ks, vs, q
    d, b, h, hk, s = paged_shape
    page = 64
    k = torch.randn(b, hk, s, d, generator=gen, device="cuda").bfloat16()
    v = torch.randn(b, hk, s, d, generator=gen, device="cuda").bfloat16()
    pool, table, _ = decode_cases.paged_pool(k, v, 8, 8, page, gen)
    del k, v
    q = torch.randn(b, 1, h, d, generator=gen, device="cuda").bfloat16()
    lens = torch.full((b,), s, dtype=torch.int32, device="cuda")
    plan = DD.kernel_partition(q, pool["k"], pool["v"], int_qk=True, page_table=table)
    record(f"d{d} paged int8 cache, pages of {page}, b{b} h{h} hk{hk} {s} rows a sequence (engine tick)",
           lambda: DD.decode_attention(q, pool["k"], pool["v"], pool["k_scale"], lens, v_scale=pool["v_scale"],
                                       page_table=table, return_lse=True),
           lambda: DD.decode_attention_paged_plain(q, pool["k"], pool["v"], pool["k_scale"], pool["v_scale"], lens,
                                                   table, sm_scale=d ** -0.5, int_qk=True, out_dtype=q.dtype,
                                                   split_keys=plan["split_keys"], warps=plan["warps"]),
           [x[:, table.long().flatten()] for x in (pool["k"], pool["v"], pool["k_scale"], pool["v_scale"])], q, None,
           None)
    del pool, q
    return records


def offladder_decode_phase(gen):
    """decode_rows_phase at OFFLADDER_SHAPES (head dims 96 and 80), its
    T-token and paged rows at d96 (b1 and b8, h32 hk32, 4,096 rows)."""
    return decode_rows_phase(gen, OFFLADDER_SHAPES, "D20", (96, 1, 32, 32, 4096), (96, PHI3_BATCH, 32, 32, 4096))


def f1_rows_phase(gen, shapes, m, tag):
    """Kernel F1 (w8, bf16 x) at a model's w8 decode (M ``m``): its MLP
    matrices ``shapes`` ((N, K) pairs), against the plain version at phase
    10's bound, timed over copies of the weights (more than the L2) beside
    torch.matmul on dense bf16 W."""
    from lowbit_quant_fa2_paddle_tpu_torch.ops import gemv as G

    recs = {}
    for n, k in shapes:
        x = torch.randn(m, k, generator=gen, device="cuda").bfloat16()
        copies = [gemv_weights(gen, "w8", n, k) for _ in range(4)]
        wt, w = copies[0]
        n_tc = G.wq_matmul_per_channel.launches_by_design["tensor_core"]
        y = gemv_call("w8", x, wt)
        err = check_gemv(f"F1 w8 M{m} N{n} K{k}", y, gemv_plain("w8", x, wt))
        if G.wq_matmul_per_channel.launches_by_design["tensor_core"] != n_tc + 1:
            raise AssertionError(f"F1 w8 M{m} N{n} K{k} did not run on the tensor_core design")
        ms = cycle_ms([functools.partial(gemv_call, "w8", x, c[0]) for c in copies])
        plain_ms = cycle_ms([functools.partial(gemv_plain, "w8", x, c[0]) for c in copies], reps=5)
        dense = [c[1].bfloat16() for c in copies]
        lib = cycle_ms([functools.partial(torch.matmul, x, wd.T) for wd in dense])
        lim = bound(nbytes(x, wt["packed"], wt["scale"], y))
        log(f"[{tag}] F1 w8 M{m} N{n} K{k} (tensor_core): kernel {ms:.4f} ms, plain {plain_ms:.4f}, bound "
            f"{lim['bound_ms']:.4f} ({lim['bound_ms'] / ms:.0%}), torch.matmul dense bf16 {lib:.4f}")
        recs[(n, k)] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, **lim, "library_ms": lib,
                        "design": "tensor_core"}
        del copies, dense, wt, w, x, y
    return recs


def phi3_f1_phase(gen):
    """f1_rows_phase at the Phi-3-mini-geometry model's MLP matrices, N
    12288 K 3072 and N 3072 K 12288, M 8."""
    return f1_rows_phase(gen, ((12288, 3072), (3072, 12288)), PHI3_BATCH, "F20")


def decode_step_classes(model, token, caches, cfg):
    """One eager decode step under torch.profiler: device ms by kernel class
    (D, dense GEMMs, the rest) and of the kernels that the cache appends
    (ops.decode.append_kv: the new token's K/V quantized by plain ops and
    written at each sequence's length), which the rest holds."""
    from lowbit_quant_fa2_paddle_tpu_torch.models import llm
    from lowbit_quant_fa2_paddle_tpu_torch.ops import decode as DD

    for _ in range(2):
        _, caches = llm.llm_decode_step(model, token, caches, cfg)
    append = DD.append_kv

    def ranged(*args, **kw):
        with torch.profiler.record_function("append_kv"):
            return append(*args, **kw)

    DD.append_kv = ranged
    try:
        cats, _, _ = profile_classes(lambda: llm.llm_decode_step(model, token, caches, cfg),
                                     {"D": ("decode",), "GEMM": GEMM_NAMES}, ranges=("append_kv",))
    finally:
        DD.append_kv = append
    return cats


def geometry_llm_phase(config, batch, prompt_len, n_new, seed, tag, max_seq=None, c1_design="vector"):
    """An LLM of ``config`` (LLMConfig's fields), random weights from a seed,
    bf16: b``batch`` prompts of ``prompt_len`` tokens, ``n_new`` new tokens
    through generate's two stages (llm_prefill, then the CUDA-graph
    decode_tokens) on the int8, bf16, int4 and k4v8 caches (of ``max_seq``
    rows, else the config's) and with w8 weights (int8 cache; made after
    the other runs, so that only one extra copy of the weights and one cache
    are alive at a time); launches per run (A and C1 a layer at prefill, on
    the wgmma design and ``c1_design``; D a layer and step, all at the head dim; F1
    six a layer and step with w8); the first decode step's logits cos int8
    vs bf16 cache >= 0.999; a decode step profiled on the int8 cache.
    Returns the model and prompt for the phases that follow."""
    from lowbit_quant_fa2_paddle_tpu_torch.models import llm
    from lowbit_quant_fa2_paddle_tpu_torch.ops import decode as DD
    from lowbit_quant_fa2_paddle_tpu_torch.ops.attention import kernel_dim, lowbit_attention
    from lowbit_quant_fa2_paddle_tpu_torch.ops.metrics import cosine_similarity

    cfg = llm.LLMConfig(**config, dtype=torch.bfloat16)
    run_cfg = dataclasses.replace(cfg, max_seq=max_seq or cfg.max_seq)
    hd, dp = cfg.head_dim, kernel_dim(cfg.head_dim)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    t0 = time.perf_counter()
    model = llm.init_llm_params(cfg, gen)
    n_params = sum(p.numel() for p in model.parameters())
    prompt = torch.randint(0, cfg.vocab, (batch, prompt_len), generator=gen, device="cuda")
    torch.cuda.synchronize()
    log(f"[{tag}] dim {cfg.dim} depth {cfg.depth} heads {cfg.num_heads}x{hd} kv heads {cfg.num_kv_heads} "
        f"vocab {cfg.vocab} bf16: {n_params / 1e9:.3f} B params, init {time.perf_counter() - t0:.1f} s; caches of "
        f"{run_cfg.max_seq} rows")
    small = dataclasses.replace(cfg, max_seq=512)
    llm.generate(model, prompt[:, :256], 2, small)  # warm-up, not counted
    res = {}
    runs = (("int8", dict(kv_bits=8)), ("bf16", dict(kv_bits=16)), ("int4", dict(kv_bits=4)),
            ("k4v8", dict(kv_bits=8, k_bits=4)), ("w8", dict(kv_bits=8)))
    m_run = model
    for mode, bits in runs:
        cfg_m = dataclasses.replace(run_cfg, **bits)
        f1 = 0
        if mode == "w8":
            m_run = llm.quantize_llm_params(model, bits=8)
            llm.generate(m_run, prompt[:, :64], 2, small)  # warm-up of F1, not counted
            f1 = 6 * cfg.depth * (n_new - 1)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        first = FirstLogits(m_run)
        count_reset()
        t0 = time.perf_counter()
        logits, caches = llm.llm_prefill(m_run, prompt, cfg_m)
        token = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
        del logits
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
        steps, caches, wall_ms, replay_ms, call_s = graph_decode(m_run, token, caches, n_new - 1, cfg_m)
        got, d_dim, variants = counts(), dict(DD.decode_attention.launches_by_dim), variant_counts()
        a_dim = dict(lowbit_attention.launches_by_dim)
        first.remove()
        peak = torch.cuda.max_memory_allocated()
        cache_gb = sum(nbytes(*c.values()) for c in caches) / 1e9
        log(f"[{tag}] {mode} ({cache_gb:.2f} GB of cache over {cfg.depth} layers): prefill {prefill_s:.3f} s, graph "
            f"decode {wall_ms:.3f} ms/token wall over {n_new - 11} replays in one call (single-replay device ms "
            f"median {statistics.median(replay_ms):.3f}, min {min(replay_ms):.3f}, max {max(replay_ms):.3f}; the "
            f"first call {call_s:.2f} s), peak {peak / 2**30:.2f} GiB; kernel D by head dim "
            f"{ {k: v for k, v in d_dim.items() if v} }, variants {variants}")
        check_counts(f"{tag} {mode}", got, cfg.depth, n_new - 1, f1=f1, c1_design=c1_design)
        if d_dim[hd] != cfg.depth * (n_new - 1) or a_dim[dp] != cfg.depth:
            raise AssertionError(f"{tag} {mode}: D launches by head dim {d_dim}, A by kernel dim {a_dim}")
        if first.logits is None or not bool(torch.isfinite(first.logits).all()) or steps.shape != (
                batch, n_new - 1) or not bool(((steps >= 0) & (steps < cfg.vocab)).all()):
            raise AssertionError(f"{tag} {mode}: no or non-finite first-step logits, or bad tokens")
        res[mode] = {"prefill_s": prefill_s, "decode_ms_per_token": wall_ms, "replay_ms": statistics.median(replay_ms),
                     "peak_gib": peak / 2**30, "launches": got, "variants": variants, "logits": first.logits,
                     "cache_gb": cache_gb}
        if mode == "int8":
            res["profile"] = decode_step_classes(model, steps[:, -1].contiguous(), caches, cfg_m)
            prof = res["profile"]
            log(f"[{tag}] one eager decode step at ~{prompt_len} tokens (int8 cache, b{batch}), device ms: D "
                f"{prof['D']:.3f}, GEMM {prof['GEMM']:.3f}, other {prof['other']:.3f} (of it the cache appends "
                f"{prof['append_kv']:.3f}); total {prof['D'] + prof['GEMM'] + prof['other']:.3f}")
        del caches, steps, first
    del m_run
    cos = float(cosine_similarity(res["int8"]["logits"], res["bf16"]["logits"]))
    log(f"[{tag}] first decode step logits cos int8 vs bf16 cache {cos:.6f} (>= 0.999)")
    if cos < 0.999:
        raise AssertionError(f"{tag}: int8 vs bf16 cache first-step logits cos {cos} < 0.999")
    for mode, _ in runs:
        del res[mode]["logits"]
    res["_model"], res["_prompt"] = model, prompt
    return res


def phi3_llm_phase():
    """geometry_llm_phase on PHI3 (1.91 B parameters), b8 prompts of 3,968
    tokens, 64 new tokens, seed 3."""
    return geometry_llm_phase(PHI3, PHI3_BATCH, PHI3_PROMPT, PHI3_NEW, 3, "phi3")


def phi3_spec_phase(model, prompt):
    """Phase 16's full-width verify path (spec_full_width_phase) on the Phi-3
    model: b1 from the first of its 3,968-token prompts, int8 cache, spec_k
    4, the int4-cache and w4 self-drafts, each token-equal to generate,
    every verify step on the T-token d96 variant."""
    return spec_full_width_phase(model, prompt, "spec20", max_seq=PHI3["max_seq"])


def tie_bound(model, prompt, cfg, batch, tie):
    """``tie`` times the largest |logit difference| between one decode step
    of a sequence at b1 and the same step with the sequence's cache
    repeated ``batch`` times (M = batch rows in every matmul, as the
    engine's slots run them)."""
    from lowbit_quant_fa2_paddle_tpu_torch.models import llm

    logits, caches = llm.llm_prefill(model, prompt, cfg)
    tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
    del logits
    wide = [{k: v.repeat_interleave(batch, dim=0) for k, v in c.items()} for c in caches]
    one, _ = llm.llm_decode_step(model, tok, caches, cfg)
    many, _ = llm.llm_decode_step(model, tok.repeat(batch), wide, cfg)
    delta = float((one[0].float() - many[0].float()).abs().max())
    del caches, wide
    return tie * delta, delta


def geometry_serving_phase(model, lens, n_new, batch, tie_factor, tag, seed, max_seq=None):
    """ServingEngine on a model: pages of 64, ``batch`` slots, int8 pages,
    requests of ``lens`` tokens (prompts from the model's vocab, a seed),
    ``n_new`` new tokens each; every stream against generate on its prompt
    alone (b1, caches of ``max_seq`` rows): equal, or parting at a near-tie
    (generate's own row puts the engine's token at most ``tie_factor`` x
    the b1-vs-batch row difference below generate's); every D launch on the
    paged variant at the model's head dim."""
    from lowbit_quant_fa2_paddle_tpu_torch import serving
    from lowbit_quant_fa2_paddle_tpu_torch.models import llm
    from lowbit_quant_fa2_paddle_tpu_torch.ops import decode as DD

    cfg = dataclasses.replace(model.cfg, kv_bits=8, max_seq=max_seq or model.cfg.max_seq)
    hd = cfg.head_dim
    g = torch.Generator().manual_seed(seed)
    prompts = [torch.randint(0, cfg.vocab, (n,), generator=g).tolist() for n in lens]
    worst = [-(-(len(p) + n_new + 4) // 64) for p in prompts]
    scfg = serving.ServingConfig(page_size=64, num_pages=sum(worst), max_batch=batch,
                                 max_pages_per_seq=max(worst), prefix_caching=False)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    count_reset()
    eng = serving.ServingEngine(model, cfg, scfg)
    t0 = time.perf_counter()
    rids = [eng.add_request(p, n_new) for p in prompts]
    steps = 0
    while len(eng.finished) < len(rids):
        eng.step()
        steps += 1
        if steps > 5000:
            raise AssertionError(f"{tag} serving: the engine did not drain")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got, variants, d_dim = counts(), variant_counts(), dict(DD.decode_attention.launches_by_dim)
    streams = [eng.finished[r] for r in rids]
    out = sum(len(s) for s in streams)
    log(f"[{tag}] engine: {len(rids)} requests, {out} tokens out in {wall:.2f} s ({out / wall:.1f} tokens/s), "
        f"{eng.decode_ticks} decode ticks, peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; launches {got}, "
        f"D by variant {variants}, by head dim { {k: v for k, v in d_dim.items() if v} }")
    tick_variant = f"paged T-token T1 k8v8 b{batch}"
    if set(variants) != {tick_variant} or d_dim[hd] != got["D"] or not (got["A"] and got["C1"]):
        raise AssertionError(f"{tag} serving: launches {got}, variants {variants}, by head dim {d_dim}")
    del eng
    tie, delta = tie_bound(model, torch.tensor([prompts[0]], device="cuda"), cfg, batch, tie_factor)
    parted = []
    for i, (p, s) in enumerate(zip(prompts, streams)):
        ids = torch.tensor([p], device="cuda")
        ref = llm.generate(model, ids, n_new, cfg)[0].tolist()
        at = next((j for j, (x, y) in enumerate(zip(s, ref)) if x != y), None)
        if at is None:
            continue
        # generate's own row at the parting token (eager steps from the prefill).
        logits, caches = llm.llm_prefill(model, ids, cfg)
        row, tok = logits[0, -1], torch.tensor([ref[0]], dtype=torch.int32, device="cuda")
        del logits
        for j in range(at):
            row, caches = llm.llm_decode_step(model, tok, caches, cfg)
            row, tok = row[0], torch.tensor([ref[j + 1]], dtype=torch.int32, device="cuda")
        gap = float(row[ref[at]].float() - row[s[at]].float())
        parted.append((i, at, gap))
        del caches
    log(f"[{tag}] engine streams equal generate's on {len(prompts) - len(parted)} of {len(prompts)}; partings "
        f"(request, token, generate's row's logit of its token over the engine's): {parted}; near-tie bound "
        f"{tie:.4g} ({tie_factor} x the b1-vs-b{batch} step's largest |logit difference| {delta:.4g})")
    if any(gap > tie for _, _, gap in parted):
        raise AssertionError(f"{tag} serving: streams part from generate's above the near-tie bound {tie}: {parted}")
    return {"wall_s": wall, "tokens_per_s": out / wall, "launches": got, "variants": variants,
            "parted": parted, "tie": tie, "decode_ticks": steps}


def phi3_serving_phase(model):
    """geometry_serving_phase on the Phi-3 model: 8 slots, PHI3_SERVE_LENS
    requests of 32 new tokens (seed 20), PHI3_TIE."""
    return geometry_serving_phase(model, PHI3_SERVE_LENS, PHI3_SERVE_NEW, PHI3_BATCH, PHI3_TIE, "phi3", 20)


def phi3_checkpoint_phase(model, prompt):
    """The Phi-3 model's int8 cache after a b1 prefill of the first prompt
    written with utils.checkpoint.save_quantized_cache (a layer a file, in a
    temporary directory), read back with load_quantized_cache: the same
    bits, and decode_tokens on it gives the tokens it gives on the cache
    the prefill made."""
    import tempfile

    from lowbit_quant_fa2_paddle_tpu_torch.models import llm
    from lowbit_quant_fa2_paddle_tpu_torch.utils import checkpoint

    cfg = dataclasses.replace(model.cfg, kv_bits=8)
    logits, caches = llm.llm_prefill(model, prompt[:1], cfg)
    token = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
    del logits
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        for i, c in enumerate(caches):
            checkpoint.save_quantized_cache(os.path.join(tmp, f"layer{i}.npz"), c)
        save_s = time.perf_counter() - t0
        size = sum(os.path.getsize(os.path.join(tmp, f)) for f in os.listdir(tmp))
        t0 = time.perf_counter()
        loaded = [checkpoint.load_quantized_cache(os.path.join(tmp, f"layer{i}.npz")) for i in range(len(caches))]
        load_s = time.perf_counter() - t0
    same = all(torch.equal(c[k], l[k]) for c, l in zip(caches, loaded) for k in c)
    a, _ = llm.decode_tokens(model, token, caches, 16, cfg)
    b, _ = llm.decode_tokens(model, token, loaded, 16, cfg)
    equal = torch.equal(a, b)
    log(f"[phi3] int8 cache checkpoint (b1, {cfg.depth} layers, {size / 1e9:.3f} GB on disk): save {save_s:.2f} s, "
        f"load {load_s:.2f} s, same bits {same}, 16 decoded tokens equal {equal}")
    if not (same and equal):
        raise AssertionError(f"phi3: the reloaded cache differs (bits {same}, tokens {equal})")
    return {"save_s": save_s, "load_s": load_s, "bytes": size}


# ---------------------------------------------------------------------------
# Phase 21: kernels D and E at the head dims they take at run time (every
# multiple of 16 up to 256 without an instance of its own), and a full-width
# LLM with MPT-30B's attention geometry (generate, speculative decoding,
# serving).
# ---------------------------------------------------------------------------

#: mosaicml/mpt-30b's config.json: d_model 7168, n_heads 64 (head dim 112),
#: n_layers 48, expansion_ratio 4, max_seq_len 8192, vocab_size 50432.
#: LLMConfig's 4·d MLP is MPT's width; its RoPE and SiLU stand in for MPT's
#: ALiBi and GELU. Depth 12 of 48, for the run's time limit (48 bf16 layers
#: would take 59 GB; the widths are whole), random weights from a seed;
#: the runs' caches hold
#: 4,096 rows (4,032-token prompts and 64 new tokens: the bf16 cache at b8
#: takes 11.3 GB).
MPT30B = dict(vocab=50432, dim=7168, depth=12, num_heads=64, num_kv_heads=64, max_seq=8192, rope_theta=10000.0)
MPT_BATCH, MPT_PROMPT, MPT_NEW, MPT_CACHE_ROWS = 8, 4032, 64, 4096
#: Kernel D's timed shapes at run-time head dims, (b, h, hk, S_max): MPT-30B's
#: decode (64 query and 64 KV heads of 112) and Nemotron-4-340B's (hidden
#: 18432: 96 query and 8 KV heads of 192, NVIDIA's technical report), b8 at 4K.
RT_DECODE_SHAPES = {112: (8, 64, 64, 4096), 192: (8, 96, 8, 4096)}
#: The head dims of utils/decode_cases.py's run-time cases.
RT_EDGE_DIMS = (16, 48, 112, 144, 192, 240)
#: The engine's traffic: 8 requests of 1,024-4,032 tokens, 32 new each, over
#: pages of 64 in 8 slots.
MPT_SERVE_LENS, MPT_SERVE_NEW = (1024, 1500, 2000, 2500, 3000, 3333, 3700, 4032), 32


def rt_dim_edge_phase(gen):
    """dim_edge_phase at the run-time head dims 16, 48, 112, 144, 192 and 240
    (decode_attention*_dyn.cu): rows that end inside a QK window, 4-bit rows
    of 8-120 bytes in 8-byte pieces, Nemotron-4's GQA group of 12."""
    return dim_edge_phase(gen, RT_EDGE_DIMS, "D21")


def mpt_quant_phase(gen):
    """prefill_k_quant_phase at the MPT-30B-geometry prefill's K (b8, 64 KV
    heads, 4,032 rows of 112, padded to 128 as the model's C1 runs it)."""
    return prefill_k_quant_phase(gen, MPT_BATCH, MPT30B["num_kv_heads"], MPT_PROMPT, 112, "C1-21", unpadded=False)


def mpt_prefill_attention_phase(gen):
    """Kernel A at one batch row of the MPT-30B-geometry prefill (b1 h64 hk64
    s4032 causal, int8 K codes, Q quantized in the kernel), head dim 112
    zero-padded to the d128 kernel by the entry point (time_attention)."""
    return time_attention(gen, "fused", MPT30B["num_heads"], MPT30B["num_kv_heads"], MPT_PROMPT, 112, True)


def rt_dim_decode_phase(gen):
    """decode_rows_phase at RT_DECODE_SHAPES (MPT-30B's d112 and
    Nemotron-4's d192 decode), its T-token and paged rows at d112 (b1 and
    b8, h64 hk64, 4,096 rows)."""
    return decode_rows_phase(gen, RT_DECODE_SHAPES, "D21", (112, 1, 64, 64, 4096), (112, MPT_BATCH, 64, 64, 4096))


def rt_dim_fused_kv_phase(gen):
    """Kernel E at head dims 48, 112 and 192 (the kernels of widths 64, 128
    and 256 with the head dim at run time, fused_kv_attention_wgmma_pad.cu)
    against its plain version at phase 11's bounds, bits 4 and 2, causal
    and not (GQA 8q/2kv, Sq 300 / Sk 1000, group 128; 2-bit rows of 12, 28
    and 48 bytes and 4-bit rows of 24 and 56 bytes, padded to 16 for TMA by
    the wrapper), the same bits twice, every launch at its head dim; then
    timed at b4 h32 s8192 d112 int4 (group 256) beside SDPA on the
    dequantized bf16 K/V, with the wrapper's padded copy of the packed K and
    V timed alone; then its entry point once with the counters at 0."""
    from lowbit_quant_fa2_paddle_tpu_torch.ops import fused_kv as FK
    from lowbit_quant_fa2_paddle_tpu_torch.ops.attention import LOG2E
    from lowbit_quant_fa2_paddle_tpu_torch.utils.benchmark import attention_flops, cuda_time_ms, tflops

    design = FK.kernel_design()
    worst = fused_kv_edges(gen, (48, 112, 192), "E21")
    b, h, s, d, bits, group = 4, 32, 8192, 112, 4, 256
    args = fused_kv_inputs(gen, b, h, h, s, s, d, bits, group)
    flops = attention_flops(b, h, d, s, s, False)
    ms = cuda_time_ms(lambda: FK.fused_packed_kv_attention(*args, bits=bits), warmup=2, reps=10)
    causal_ms = cuda_time_ms(lambda: FK.fused_packed_kv_attention(*args, bits=bits, is_causal=True), warmup=2, reps=10)
    row = FK.pack_row_bytes(d, bits)
    pad_ms = cuda_time_ms(lambda: [torch.nn.functional.pad(x, (0, row - x.shape[-1])) for x in args[1:3]], warmup=2,
                          reps=10)
    plain_ms = cuda_time_ms(lambda: FK.fused_kv_attention_plain(*args, bits=bits, group=group, causal=False,
                                                                 sm_scale_log2e=LOG2E / math.sqrt(d),
                                                                 out_dtype=torch.bfloat16), warmup=1, reps=2)
    kd = FK.dequant_kv_grouped(args[1], args[3], args[4], bits=bits, group=group)
    vd = FK.dequant_kv_grouped(args[2], args[5], args[6], bits=bits, group=group)
    sdpa_ms = cuda_time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(args[0], kd, vd), warmup=2,
                           reps=10)
    del kd, vd
    lim = bound(nbytes(*args) + nbytes(args[0]), {"bf16": flops})
    log(f"[E21] int4 b{b} h{h} s{s} d{d}: kernel {ms:.3f} ms ({tflops(flops, ms / 1e3):.1f} TFLOP/s; of it the "
        f"wrapper's copy of the packed K and V to {row}-byte rows {pad_ms:.4f} ms), causal {causal_ms:.3f} ms, plain "
        f"{plain_ms:.3f} ms, bound {lim['bound_ms']:.3f} ms ({lim['bound_by']}); SDPA on the dequantized bf16 K/V "
        f"{sdpa_ms:.3f} ms ({tflops(flops, sdpa_ms / 1e3):.1f} TFLOP/s)")
    count_reset()
    o = FK.fused_packed_kv_attention(*args, bits=bits)
    torch.cuda.synchronize()
    got = counts()
    by_dim = {k: v for k, v in FK.fused_packed_kv_attention.launches_by_dim.items() if v}
    log(f"[E21] entry point fused_packed_kv_attention(bits=4) b{b} h{h} s{s} d{d}: launches {got}, E by head dim "
        f"{by_dim}")
    if got != {key: int(key == "E") for key in got} or by_dim != {d: 1} or not bool(torch.isfinite(o.float()).all()):
        raise AssertionError(f"kernel E entry point at d{d}: launches {got}, by head dim {by_dim}")
    return {"max_abs_err": max(worst.values()), "worst_by_dim": worst, "ms": ms, "plain_ms": plain_ms, **lim,
            "library_ms": sdpa_ms, "causal_ms": causal_ms, "pad_ms": pad_ms, "launches": got["E"], "design": design}


def mpt_f1_phase(gen):
    """f1_rows_phase at the MPT-30B-geometry model's MLP matrices, N 28672
    K 7168 and N 7168 K 28672, M 8."""
    return f1_rows_phase(gen, ((28672, 7168), (7168, 28672)), MPT_BATCH, "F21")


def mpt_llm_phase():
    """geometry_llm_phase on MPT30B at depth 12, b8 prompts of 4,032 tokens,
    64 new tokens, caches of 4,096 rows, seed 21: every D at head dim 112
    (the run-time instances), A at kernel dim 128."""
    return geometry_llm_phase(MPT30B, MPT_BATCH, MPT_PROMPT, MPT_NEW, 21, "mpt", max_seq=MPT_CACHE_ROWS)


def mpt_spec_phase(model, prompt):
    """spec_full_width_phase on the MPT-30B-geometry model: b1 from the first
    of its 4,032-token prompts, int8 cache of 4,160 rows (the prompt, 64 new
    tokens and spec_k more, which speculative_generate asks for, rounded to
    a page), spec_k 4, the int4-cache and w4 self-drafts token-equal to
    generate, every verify step on the T-token run-time variant at d112."""
    return spec_full_width_phase(model, prompt, "spec21", max_seq=MPT_CACHE_ROWS + 64)


def mpt_serving_phase(model):
    """geometry_serving_phase on the MPT-30B-geometry model: 8 slots, int8
    pages of 64, MPT_SERVE_LENS requests of 32 new tokens (seed 21),
    PHI3_TIE's near-tie rule, every D launch on the paged variant at d112."""
    return geometry_serving_phase(model, MPT_SERVE_LENS, MPT_SERVE_NEW, MPT_BATCH, PHI3_TIE, "mpt", 21,
                                  max_seq=MPT_CACHE_ROWS)

# ---------------------------------------------------------------------------
# Phase 25: kernels A, D and E above head_dim 256 (up to 512), and an LLM of
# 8 heads of 512 at full width (generate, chunked prefill, speculative
# decoding, serving).
# ---------------------------------------------------------------------------

#: Phase 13's width (dim 4096) as 8 query heads of 512 over 2 KV heads: the
#: cache holds phase 13's bytes a token (2 x 512 = 8 x 128 a side), so kernel
#: D's rows read against phase 9's d128 rows. No public model the port runs
#: has heads this wide. Depth 8 (the 128K phase's cut, for the run's time
#: limit; the widths are whole), random weights from a seed, caches of
#: 32,768 rows.
HD512 = dict(vocab=256, dim=4096, depth=8, num_heads=8, num_kv_heads=2, max_seq=32768)
HD512_BATCH, HD512_PROMPT, HD512_NEW, HD512_CHUNK = 4, 32704, 64, 4096
#: Kernel D's edge cases above 256 (utils/decode_cases.py) and its timed
#: decode shape: the hd512 LLM's b4 at 32K.
HD512_EDGE_DIMS = (272, 320, 400, 512)
HD512_DECODE_SHAPES = {512: (4, 8, 2, 32768)}
#: The engine's traffic: 8 requests of 1,024-4,032 tokens, 32 new each, over
#: pages of 64 in 8 slots (phases 20-21's), caches of 4,096 rows.
HD512_SERVE_LENS, HD512_SERVE_NEW, HD512_SERVE_ROWS = (1024, 1500, 2000, 2500, 3000, 3333, 3700, 4032), 32, 4096


def sdpa_picked(q, k, v, **kw):
    """The backend SDPA's own dispatch picks for a call on q, k, v (its
    keyword arguments ``kw``), as the dispatcher names it
    (``torch._fused_sdp_choice``), or "refuses" where it has none."""
    from torch.nn.attention import SDPBackend

    name = SDPBackend(torch._fused_sdp_choice(q, k, v, **kw)).name
    return "refuses" if name == "ERROR" else name.lower().replace("_attention", "")


def hd512_edge_phase(gen):
    """Kernel A's head_dim-512 grid of utils/mask_cases.py (every mode at
    512, and 320 and 448 padded to 512, unmasked, at the masks' edges and
    with the bias) against attention_fwd_plain at phase 4's bounds, the same
    bits twice, every launch on the wgmma design at kernel dim 512; kernel D
    at head dims 272, 320, 400 and 512 (dim_edge_phase); kernel E at 320
    and 512 (fused_kv_edges). Returns the worst max|do| of each."""
    from lowbit_quant_fa2_paddle_tpu_torch.ops.attention import attention_fwd_plain, lowbit_attention
    from lowbit_quant_fa2_paddle_tpu_torch.utils import mask_cases

    worst_a = 0.0
    for mode, edge in mask_cases.d512_cases():
        case = mask_cases.make_case(mode, edge, gen, "cuda")
        n, n_dim = lowbit_attention.launches_by_design["wgmma"], lowbit_attention.launches_by_dim[512]
        o, lse = lowbit_attention(*case["args"], **case["kw"], return_lse=True)
        o2, lse2 = lowbit_attention(*case["args"], **case["kw"], return_lse=True)
        o_ref, lse_ref = attention_fwd_plain(*case["plain_args"], **case["plain_kw"])
        torch.cuda.synchronize()
        r = mask_cases.masked_stats(o, lse, o_ref, lse_ref)
        r["same_bits_twice"] = torch.equal(o, o2) and torch.equal(lse, lse2)
        r["on_design"] = (lowbit_attention.launches_by_design["wgmma"] == n + 2
                          and lowbit_attention.launches_by_dim[512] == n_dim + 2)
        r["empty_ok"] = r["empty_ok"] and r["empty_rows"] == case["empty_rows"]
        check_masked(f"{mode} {edge}", r, "A25")
        worst_a = max(worst_a, r["max_do"])
        del case, o, o2, lse, lse2, o_ref, lse_ref
    log(f"[A25] {len(mask_cases.d512_cases())} cases at kernel dim 512; worst max|do| {worst_a:.4g}")
    worst_d = dim_edge_phase(gen, HD512_EDGE_DIMS, "D25")
    worst_e = fused_kv_edges(gen, (320, 512), "E25")
    return {"A": worst_a, "D": worst_d, "E": worst_e}


def hd512_quant_phase(gen):
    """Kernel C1 at the hd512 LLM's prefill K (b4, 2 KV heads, 32,704 rows of
    512, per token with its mean): rows of 1,024 bytes are 64 lanes of 16,
    past the vector design's 32, so the scalar design runs it; codes and
    scales bit-equal to quant_int8_plain, then timed as phase 3 times it."""
    from lowbit_quant_fa2_paddle_tpu_torch.ops.quant import k_mean, kernel_design, quant_int8, quant_int8_plain

    b, hk, s, d = HD512_BATCH, HD512["num_kv_heads"], HD512_PROMPT, 512
    k = (torch.randn(b, hk, s, d, generator=gen, device="cuda") + 0.5).bfloat16()
    km = k_mean(k)
    design = kernel_design(k, 8, True, 128)
    n = quant_int8.launches_by_design[design]
    codes, scale = quant_int8(k, km, gran="per_token")
    on_design = quant_int8.launches_by_design[design] == n + 1
    want_c, want_s = quant_int8_plain(k, km, per_token=True, block=128)
    torch.cuda.synchronize()
    same = torch.equal(codes, want_c) and torch.equal(scale, want_s)
    log(f"[C1-25] prefill K b{b} h{hk} s{s} d{d} ({design}): codes_equal={torch.equal(codes, want_c)} "
        f"scales_equal={torch.equal(scale, want_s)} on_design={on_design}")
    if not (same and on_design and design == "scalar"):
        raise AssertionError(f"kernel C1 at the hd512 prefill's K: design {design}, equal {same}")
    del k, km, codes, scale, want_c, want_s
    ks = [(torch.randn(b, hk, s, d, generator=gen, device="cuda") + 0.5).bfloat16() for _ in range(2)]
    rec = {"max_abs_err": 0.0, **time_quant("C1-25", f"b{b} h{hk} s{s} d{d}", quant_int8, quant_int8_plain, ks,
                                            "per_token", 128, 8)}
    del ks
    return rec


def hd512_attention_phase(gen):
    """Kernel A at head_dim 512 in every mode at bench.py:119's b4 h8 s4096
    (SDPA bf16 at the fp mode's shape, under its own dispatch, the backend
    it picked named), and int8 at the hd512 LLM's prefill (b4 h8 hk2 s32704
    causal); then kernel E at b4 h8 s4096 d512 int4 (group 256) beside SDPA
    on the dequantized bf16 K/V. Each against its plain version, the same
    bits twice, timed."""
    from lowbit_quant_fa2_paddle_tpu_torch.ops import fused_kv as FK
    from lowbit_quant_fa2_paddle_tpu_torch.ops.attention import LOG2E
    from lowbit_quant_fa2_paddle_tpu_torch.utils.benchmark import attention_flops, cuda_time_ms, tflops

    sdpa = torch.nn.functional.scaled_dot_product_attention
    records = {}
    backends = {}

    def fp_library(q, k, v, _):
        backends["fp"] = sdpa_picked(q, k, v)
        log(f"[A25] SDPA bf16 at b4 h8 s4096 d512: {backends['fp']}")
        return None if backends["fp"] == "refuses" else (lambda: sdpa(q, k, v))

    bench = (4, 8, 8, 4096, 512, False)
    for mode, (k_bits, v_mode) in A17_MODES.items():
        name = f"d512 {mode}; b4 h8 s4096 d512"
        records[name] = a_mode_record(gen, name, *bench, k_bits, v_mode, prefix="A25",
                                      library=fp_library if mode == "fp" else None)
        records[name]["library_backend"] = backends.get("fp") if mode == "fp" else None
    b, h, hk, s = HD512_BATCH, HD512["num_heads"], HD512["num_kv_heads"], HD512_PROMPT
    name = f"d512 int8; hd512 LLM prefill b{b} h{h} hk{hk} s{s} d512 causal"
    records[name] = a_mode_record(gen, name, b, h, hk, s, 512, True, 8, "bf16", prefix="A25")
    # Kernel E at d512.
    b, h, s, d, bits, group = 4, 8, 4096, 512, 4, 256
    args = fused_kv_inputs(gen, b, h, h, s, s, d, bits, group)
    o = FK.fused_packed_kv_attention(*args, bits=bits)
    o2 = FK.fused_packed_kv_attention(*args, bits=bits)
    o_ref = FK.fused_kv_attention_plain(*args, bits=bits, group=group, causal=False,
                                        sm_scale_log2e=LOG2E / math.sqrt(d), out_dtype=torch.bfloat16)
    torch.cuda.synchronize()
    r = stats(o, o_ref)
    if not (r["finite"] and r["cos"] >= COS_MIN and r["max_do"] <= MAX_DO and torch.equal(o, o2)):
        raise AssertionError(f"kernel E at d512 disagrees with its plain version: {r}")
    del o, o2, o_ref
    flops = attention_flops(b, h, d, s, s, False)
    ms = cuda_time_ms(lambda: FK.fused_packed_kv_attention(*args, bits=bits), warmup=2, reps=10)
    plain_ms = cuda_time_ms(lambda: FK.fused_kv_attention_plain(*args, bits=bits, group=group, causal=False,
                                                                 sm_scale_log2e=LOG2E / math.sqrt(d),
                                                                 out_dtype=torch.bfloat16), warmup=1, reps=2)
    kd = FK.dequant_kv_grouped(args[1], args[3], args[4], bits=bits, group=group)
    vd = FK.dequant_kv_grouped(args[2], args[5], args[6], bits=bits, group=group)
    backend = sdpa_picked(args[0], kd, vd)
    sdpa_ms = None if backend == "refuses" else cuda_time_ms(lambda: sdpa(args[0], kd, vd), warmup=2, reps=10)
    del kd, vd
    lim = bound(nbytes(*args) + nbytes(args[0]), {"bf16": flops})
    log(f"[E25] int4 b{b} h{h} s{s} d{d}: {r}; kernel {ms:.3f} ms ({tflops(flops, ms / 1e3):.1f} TFLOP/s), plain "
        f"{plain_ms:.3f} ms, bound {lim['bound_ms']:.3f} ms ({lim['bound_by']}); SDPA on the dequantized bf16 K/V "
        f"({backend}) {sdpa_ms}")
    count_reset()
    o = FK.fused_packed_kv_attention(*args, bits=bits)
    torch.cuda.synchronize()
    got = counts()
    by_dim = {k: v for k, v in FK.fused_packed_kv_attention.launches_by_dim.items() if v}
    log(f"[E25] entry point fused_packed_kv_attention(bits=4) b{b} h{h} s{s} d{d}: launches {got}, E by head dim "
        f"{by_dim}")
    if got != {key: int(key == "E") for key in got} or by_dim != {d: 1} or not bool(torch.isfinite(o.float()).all()):
        raise AssertionError(f"kernel E entry point at d{d}: launches {got}, by head dim {by_dim}")
    records["E"] = {"max_abs_err": r["max_do"], "ms": ms, "plain_ms": plain_ms, **lim, "library_ms": sdpa_ms,
                    "library_backend": backend, "launches": got["E"], "design": FK.kernel_design()}
    return records


def hd512_decode_phase(gen):
    """decode_rows_phase at HD512_DECODE_SHAPES (the hd512 LLM's decode: b4
    h8 hk2 S_max 32768, every cache mode), its T-token row at b1 (the
    verify step) and its paged row at b8 with 4,096 rows a sequence (the
    engine's tick), each timed SDPA call with the backend it picked."""
    _, h, hk, s = HD512_DECODE_SHAPES[512]
    recs = decode_rows_phase(gen, HD512_DECODE_SHAPES, "D25", (512, 1, h, hk, s), (512, 8, h, hk, HD512_SERVE_ROWS))
    for key, r in recs.items():
        log(f"[D25] {key}: SDPA bf16 {r['library_backend']}")
    return recs


def hd512_llm_phase():
    """geometry_llm_phase on HD512 at depth 8, b4 prompts of 32,704 tokens,
    64 new tokens, seed 25: every A at kernel dim 512, every D at head dim
    512 (the instances laid out for 512), C1 on the scalar design (rows of
    1,024 bytes), D's share of one profiled decode step."""
    return geometry_llm_phase(HD512, HD512_BATCH, HD512_PROMPT, HD512_NEW, 25, "hd512", c1_design="scalar")


def hd512_chunked_phase(model, prompt):
    """llm_prefill_chunked (chunks of 4,096) of the hd512 LLM's prompts into
    the int8 and the k4v8 cache against the one-shot llm_prefill's
    last-token logits (cos >= 0.999 int8, >= 0.995 k4v8), launches (A a
    layer a chunk in-chunk and over the cache's codes from the second, all
    at kernel dim 512; C1 a layer a chunk); then kernel A on the last chunk
    (in-chunk, and over the cache's int8 codes or packed INT4 K) against the
    plain version (long_prefill_attention_check)."""
    from lowbit_quant_fa2_paddle_tpu_torch.models import llm
    from lowbit_quant_fa2_paddle_tpu_torch.ops.attention import lowbit_attention
    from lowbit_quant_fa2_paddle_tpu_torch.ops.metrics import cosine_similarity

    res = {}
    chunk = HD512_CHUNK
    n_chunks = -(-prompt.shape[1] // chunk)
    for mode, bits, cos_min in (("int8", dict(kv_bits=8), 0.999), ("k4v8", dict(kv_bits=8, k_bits=4), 0.995)):
        cfg = dataclasses.replace(model.cfg, **bits)
        torch.cuda.empty_cache()
        logits, caches = llm.llm_prefill(model, prompt, cfg)
        full_last = logits[:, -1].float()
        del logits, caches
        count_reset()
        t0 = time.perf_counter()
        last, caches = llm.llm_prefill_chunked(model, prompt, cfg, chunk=chunk)
        torch.cuda.synchronize()
        chunked_s = time.perf_counter() - t0
        got, a512 = counts(), lowbit_attention.launches_by_dim[512]
        cos = float(cosine_similarity(last.float(), full_last))
        log(f"[hd512] {mode} chunked prefill (chunk {chunk}) {chunked_s:.3f} s vs one-shot last-token logits cos "
            f"{cos:.6f} (>= {cos_min}); launches {got}, kernel A at d512 {a512}")
        if cos < cos_min:
            raise AssertionError(f"hd512 {mode}: chunked vs one-shot prefill cos {cos} < {cos_min}")
        if got["A"] != a512 or a512 != model.cfg.depth * (2 * n_chunks - 1) or got["C1"] != model.cfg.depth * n_chunks:
            raise AssertionError(f"hd512 {mode} chunked prefill launches {got}, A at d512 {a512}")
        c0 = (n_chunks - 1) * chunk
        cross = long_prefill_attention_check(model, prompt[:, c0:], caches[0], c0, cfg,
                                             where=f"hd512 {mode} chunked prefill", tag="hd512")
        res[mode] = {"prefill_s": chunked_s, "cos": cos, "a_d512": a512, "c1": got["C1"], "A_cross": cross,
                     "cross_launches": a512 - got["C1"]}
        del caches, last, full_last
    return res


def hd512_spec_phase(model, prompt):
    """spec_full_width_phase on the hd512 model: b1 from the first of its
    32,704-token prompts, int8 cache of 32,832 rows (the prompt, 64 new
    tokens and spec_k more, rounded to a page), spec_k 4, the int4-cache and
    w4 self-drafts token-equal to generate, every verify step on kernel D's
    T-token instance laid out for 512."""
    return spec_full_width_phase(model, prompt, "spec25", max_seq=HD512["max_seq"] + 64)


def hd512_serving_phase(model):
    """geometry_serving_phase on the hd512 model: 8 slots, int8 pages of 64,
    HD512_SERVE_LENS requests of 32 new tokens (seed 25), PHI3_TIE's
    near-tie rule, every D launch on the paged variant at d512."""
    return geometry_serving_phase(model, HD512_SERVE_LENS, HD512_SERVE_NEW, 8, PHI3_TIE, "hd512", 25,
                                  max_seq=HD512_SERVE_ROWS)


def rank_suites_phase():
    """Phases 22 and 23 (a)/(b) (see the module note): utils/parallel_cases.py's
    card suites "card" and "train", in turn in the same four rank processes
    on the card (the kernels built by this process first; the ranks start
    once for both); their ``[parallel]`` lines logged, each suite's reports
    returned by rank."""
    import tempfile

    from lowbit_quant_fa2_paddle_tpu_torch.utils import parallel_cases as pc

    suites = ("card", "train")
    with tempfile.TemporaryDirectory() as tmp:
        procs = pc.spawn(",".join(suites), pc.CARD_WORLD, tmp)
        try:
            pc.wait(procs, tmp, timeout_s=600)
        finally:
            for r in range(pc.CARD_WORLD):
                with open(os.path.join(tmp, f"rank{r}.log")) as f:
                    for line in f:
                        if line.startswith("[parallel]"):
                            log(line.rstrip())
        reports = {}
        for suite in suites:
            reports[suite] = []
            for r in range(pc.CARD_WORLD):
                with open(os.path.join(tmp, f"rank{r}.{suite}.json")) as f:
                    reports[suite].append(json.load(f))
    return reports


def rank_case_summary(reports, name, want, tag="parallel"):
    """One case of the rank suites: every rank that ran it launched exactly
    the kernels of ``want`` (a set, or a dict of launches each rank must
    count), each on its design, and no other; its launches summed over the
    ranks, rank 0's bytes a call by wire site and each rank's host seconds
    logged."""
    from lowbit_quant_fa2_paddle_tpu_torch.ops.decode import kernel_design as d_design

    ranks = [rep["cases"][name] for rep in reports if name in rep["cases"]]
    designs = {"A": "wgmma", "C1": "vector", "C2": "vector", "D": d_design(), "G1": "wgmma", "G2": "wgmma"}
    for r, c in enumerate(ranks):
        for kern, got in c["launches"].items():
            on_design = got["by_design"].get(designs[kern], 0) == got["launches"]
            count_ok = want.get(kern, 0) == got["launches"] if isinstance(want, dict) else (
                (got["launches"] > 0) == (kern in want))
            if not count_ok or not on_design:
                raise AssertionError(f"{tag} {name}: rank {r} launched {kern} {got} (want {want} on {designs})")
    launches = {kern: sum(c["launches"][kern]["launches"] for c in ranks) for kern in designs}
    wire = ranks[0]["wire"]
    per_call = {site: {dt: n // w["calls"] for dt, n in w["bytes"].items()} for site, w in wire.items()}
    log(f"[{tag}] {name}: {len(ranks)} ranks, launches {launches} (each on {designs}), host s by rank "
        f"{[round(c['host_s'], 2) for c in ranks]} (ranks share one card: no scaling figure); rank 0's bytes a "
        f"call by site {per_call} ({ {site: w['calls'] for site, w in wire.items()} } calls)")
    return {"launches": launches, "wire": wire, "ranks": len(ranks), "host_s": [c["host_s"] for c in ranks]}


def parallel_phase(reports):
    """Phase 22 (see the module note) from the ranks' reports of the card
    suite: each case's launches summed over the ranks that ran it, rank 0's
    bytes on the wire and the ranks' seconds."""
    summary = {}
    for name in reports[0]["cases"]:
        # Every rank that ran the case launched its kernels, each on its design, and no other.
        want = {"D"} if " decode" in name else {"A", "C1", "C2"} if "k4v8" in name else {"A", "C1"}
        summary[name] = rank_case_summary(reports, name, want)
    log(f"[parallel] ranks' seconds {[round(rep['seconds'], 1) for rep in reports]}, peak GiB "
        f"{[round(rep['peak_gib'], 2) for rep in reports]}")
    return summary


RING_HOP = (30, 4444, 64)  # the ring's hop at the DiT shape: heads, tokens a rank, head dim


def parallel_rows_phase(gen):
    """Phase 22's kernel rows, in this process alone: kernel A as a ring hop
    runs it (int8 Q and K codes, bf16 V, f32 output and the LSE) at
    RING_HOP, over the diagonal shard (causal) and an earlier rank's
    (unmasked), beside SDPA in bf16; kernel D at the context shard of
    phase 22's decode (b4 h32 hk8 S_max 8192 d128, int8 cache, every length
    8192) against its plain version at phase 9's bounds, with its byte
    bound."""
    from lowbit_quant_fa2_paddle_tpu_torch.ops import decode as DD
    from lowbit_quant_fa2_paddle_tpu_torch.ops.attention import LOG2E, attention_fwd_plain, lowbit_attention
    from lowbit_quant_fa2_paddle_tpu_torch.ops.quant import k_mean, quant_int8
    from lowbit_quant_fa2_paddle_tpu_torch.utils.benchmark import cuda_time_ms

    h, s, d = RING_HOP
    rows = {}
    q = torch.randn(1, h, s, d, generator=gen, device="cuda").bfloat16()
    k = (torch.randn(1, h, s, d, generator=gen, device="cuda") + 1.0).bfloat16()
    v = torch.randn(1, h, s, d, generator=gen, device="cuda").bfloat16()
    qc, qs = quant_int8(q, gran="per_token")
    kc, ks = quant_int8(k, k_mean(k), gran="per_token")
    c = LOG2E / math.sqrt(d)
    for causal, what in ((True, "the diagonal shard, causal"), (False, "an earlier rank's shard, unmasked")):
        def call(lse, causal=causal):
            return lowbit_attention(qc, kc, v, qs, ks, is_causal=causal, out_dtype=torch.float32, return_lse=lse)

        def plain(causal=causal):
            return attention_fwd_plain(qc, kc, v, qs * c, ks, None, causal=causal, sm_scale_log2e=c,
                                       out_dtype=torch.float32)

        rows[what] = a_record(f"ring hop ({what}) b1 h{h} sq{s} sk{s} d{d}", call, plain,
                              visible_pairs(s, s, causal), h, d, "int8", [qc, qs, kc, ks, v], h * s * (d + 1) * 4,
                              library=lambda causal=causal: torch.nn.functional.scaled_dot_product_attention(
                                  q, k, v, is_causal=causal), prefix="P22", library_backend=None)
    del q, k, v, qc, kc
    b, h, hk, d, s = 4, 32, 8, 128, 8192
    kargs, kkw, pargs, pkw = decode_inputs(gen, b, h, hk, d, s, "int8", [s] * b)
    n = DD.decode_attention.launches_by_design[DD.kernel_design()]
    o, lse = DD.decode_attention(*kargs, **kkw, return_lse=True)
    o2, lse2 = DD.decode_attention(*kargs, **kkw, return_lse=True)
    o_ref, lse_ref = DD.decode_attention_plain(*pargs, **pkw)
    torch.cuda.synchronize()
    r = stats(o, o_ref, lse, lse_ref)
    ulp = bf16_ulp(float(o_ref.float().abs().max()))
    r["same_bits_twice"] = torch.equal(o, o2) and torch.equal(lse, lse2)
    r["on_design"] = DD.decode_attention.launches_by_design[DD.kernel_design()] == n + 2
    log(f"[P22] context shard: " + " ".join(f"{k}={v:.6g}" if isinstance(v, float) else f"{k}={v}"
                                            for k, v in r.items()) + f" bf16_ulp={ulp:.3g}")
    if not (r["finite"] and r["cos"] >= COS_MIN and r["max_do"] <= ulp and r["max_dlse"] <= 1e-4
            and r["same_bits_twice"] and r["on_design"]):
        raise AssertionError(f"kernel D disagrees with its plain version at the context shard: {r}")
    ms = cuda_time_ms(lambda: DD.decode_attention(*kargs, **kkw), warmup=5, reps=50)
    plain_ms = cuda_time_ms(lambda: DD.decode_attention_plain(*pargs, **pkw), warmup=1, reps=3)
    q_, kq, vq, ks_, lens = kargs
    lim = bound(nbytes(kq, vq, ks_, pargs[4]) + nbytes(q_, lens) * 2)
    log(f"[P22] D int8 context shard b{b} h{h} hk{hk} S_max {s} d{d}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"bound {lim['bound_ms']:.4f} ms ({lim['bound_by']}, {lim['bound_ms'] / ms:.0%} of it)")
    # No PyTorch call decodes int8 codes: no library time.
    rows["context shard"] = {"max_abs_err": r["max_do"], "ms": ms, "plain_ms": plain_ms, **lim, "library_ms": None,
                             "design": DD.kernel_design()}
    return rows


# ---------------------------------------------------------------------------
# Phase 23: the training paths (the sharded DiT step, FSDP, the toy LLM)
# ---------------------------------------------------------------------------

#: The sharded step's attention on a rank: batch 2, 15 of CogVideoX-2b's 30
#: heads (model 2), 8,888 query rows (seq 2) against all 17,776 keys, d64.
SHARD_ATTN = (2, 15, 8888, 17776, 64)


def train_parallel_phase(reports):
    """Phase 23 (a) and (b) (see the module note) from the ranks' reports of
    the training suite: each case's launches summed over the ranks, rank 0's
    bytes on the wire and its comparison."""
    from lowbit_quant_fa2_paddle_tpu_torch.utils import parallel_cases as pc

    n = pc.TRAIN_DEPTH
    summary = {}
    for key, name, want in (("a", "a sharded int8_train step", {"A": n, "C1": n, "G1": n, "G2": n}),
                            ("b", "b fsdp forward", {"A": n, "C1": n})):
        summary[key] = rank_case_summary(reports, name, want, tag="train")
        summary[key]["check"] = {k: v for k, v in reports[0]["cases"][name].items()
                                 if k not in ("launches", "wire", "host_s")}
        log(f"[train] {name}: rank 0's comparison {summary[key]['check']}")
    summary["seconds"] = [rep["seconds"] for rep in reports]
    summary["peak_gib"] = [rep["peak_gib"] for rep in reports]
    log(f"[train] ranks' seconds {[round(x, 1) for x in summary['seconds']]}, peak GiB "
        f"{[round(x, 2) for x in summary['peak_gib']]} (depth {n}; the ranks share one card)")
    return summary


def train_rows_phase(gen):
    """Phase 23's kernel rows, in this process alone, at a rank's attention
    shape in the sharded step (SHARD_ATTN, Sq != Sk): kernel A's int8
    forward as the trainable forward runs it (Q quantized in the kernel, K
    codes with the whole sequence's mean, bf16 V, the LSE) against its plain
    version, timed beside SDPA in bf16; G1 and G2 on bf16 operands (the
    int8_train backward) through flash_bwd against attention_bwd_plain,
    counted, then timed beside aten's flash backward; C1 on the K that the
    rank gathers over seq (contiguous, the whole sequence) against its plain
    version, timed."""
    from lowbit_quant_fa2_paddle_tpu_torch.ops import attention_bwd as AB
    from lowbit_quant_fa2_paddle_tpu_torch.ops.attention import LOG2E, attention_fwd_plain, lowbit_attention
    from lowbit_quant_fa2_paddle_tpu_torch.ops.quant import k_mean, kernel_design, quant_int8, quant_int8_plain

    b, h, sq, sk, d = SHARD_ATTN
    shape = f"b{b} h{h} sq{sq} sk{sk} d{d}"
    q = torch.randn(b, h, sq, d, generator=gen, device="cuda").bfloat16()
    k = (torch.randn(b, h, sk, d, generator=gen, device="cuda") + 0.3).bfloat16()
    v = torch.randn(b, h, sk, d, generator=gen, device="cuda").bfloat16()
    km = k_mean(k)
    n_vec = quant_int8.launches_by_design["vector"]
    kc, ks = quant_int8(k, km, gran="per_token")
    want_c, want_s = quant_int8_plain(k, km, per_token=True, block=128)
    torch.cuda.synchronize()
    c1_err = max(int((kc.int() - want_c.int()).abs().max()), float((ks - want_s).abs().max()))
    on_vector = quant_int8.launches_by_design["vector"] == n_vec + 1
    log(f"[C1] gathered K b{b} h{h} s{sk} d{d} per_token ({kernel_design(k, 8, True, 128)}): "
        f"codes_equal={torch.equal(kc, want_c)} scales_equal={torch.equal(ks, want_s)} vector={on_vector}")
    if not (torch.equal(kc, want_c) and torch.equal(ks, want_s) and on_vector):
        raise AssertionError(f"kernel C1 differs from its plain version (or left the vector design) on the "
                             f"gathered K b{b} h{h} s{sk} d{d}: {c1_err}")
    del km, want_c, want_s
    c1_rec = {"max_abs_err": c1_err, **time_quant(
        "C1", f"b{b} h{h} s{sk} d{d} contiguous (gathered) K", quant_int8, quant_int8_plain,
        [k, torch.randn(b, h, sk, d, generator=gen, device="cuda").bfloat16()], "per_token", 128, 8)}
    c = LOG2E / math.sqrt(d)

    def call(lse):
        return lowbit_attention(q, kc, v, None, ks, out_dtype=torch.bfloat16, return_lse=lse)

    def plain():
        return attention_fwd_plain(q, kc, v, None, ks, None, causal=False, sm_scale_log2e=c, out_dtype=torch.bfloat16)

    rows = {"A": a_record(f"int8 forward, Q quantized in-kernel, {shape}", call, plain, b * sq * sk, h, d, "int8",
                          [q, kc, ks, v], b * h * sq * (d * 2 + 4),
                          library=lambda: torch.nn.functional.scaled_dot_product_attention(q, k, v),
                          prefix="P23", library_backend=None), "C1": c1_rec}
    del q, k, v, kc, ks
    inputs = bwd_inputs(gen, h, h, sq, d, False, 0, torch.bfloat16, sk=sk, b=b)
    count_reset()
    got = AB.flash_bwd(*inputs, is_causal=False, sm_scale=1.0 / math.sqrt(d))
    torch.cuda.synchronize()
    launches, designs = counts(), g_design_counts()
    want_l = {key: 0 for key in launches} | {"G1": 1, "G2": 1}
    if launches != want_l or designs != {"G1": {"wgmma": 1}, "G2": {"wgmma": 1}}:
        raise AssertionError(f"flash_bwd at {shape}: launches {launches} != {want_l} or designs {designs}")
    args, kargs = AB.bwd_operands(*inputs, is_causal=False, sm_scale=1.0 / math.sqrt(d))
    want = AB.attention_bwd_plain(*args, **kargs, dq_dtype=torch.bfloat16, dkv_dtype=torch.bfloat16)
    torch.cuda.synchronize()
    worst = check_bwd(f"float {shape}", got, want)
    del got, want, args
    rows.update(bwd_timed(gen, h, sq, d, False, worst, "P23", b=b, sk=sk, inputs=inputs))
    return rows


#: Phase 23 (c): the toy LLM's recipe (JAX's bench/llm_train_arith.py) and
#: its held-out prompts.
TOY_STEPS, TOY_BATCH, TOY_SEQ, TOY_LR, TOY_PROMPTS = 3000, 64, 64, 1e-3, 128


def toy_llm_phase():
    """Phase 23 (c) (see the module note)."""
    import tempfile

    from lowbit_quant_fa2_paddle_tpu_torch.models import llm, train
    from lowbit_quant_fa2_paddle_tpu_torch.utils.checkpoint import load_params, load_params_npz, save_params

    cfg = train.arith_llm_config()
    count_reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params, losses = train.train_toy_llm(cfg, steps=TOY_STEPS, batch=TOY_BATCH, seq_len=TOY_SEQ, lr=TOY_LR, seed=0)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    train_launches = counts()
    log(f"[toy] train_toy_llm {TOY_STEPS} steps b{TOY_BATCH} x {TOY_SEQ} tokens lr {TOY_LR}: {train_s:.1f} s "
        f"({train_s / TOY_STEPS * 1e3:.2f} ms a step on the host clock); chunk losses first {losses[0]:.6f}, "
        f"last {losses[-1]:.6f} ({len(losses)} chunks); launches {train_launches} (the exact attention trains: none)")
    if not (all(math.isfinite(x) for x in losses) and losses[-1] < 0.8 * losses[0]):
        raise AssertionError(f"toy LLM: the loss did not fall below 0.8x its first chunk's: {losses}")
    if any(train_launches.values()):
        raise AssertionError(f"toy LLM training launched a kernel: {train_launches}")
    prompts, answers = train.make_eval_prompts(TOY_PROMPTS, few_shot=3)
    ckpt = load_params_npz(os.path.join(REPO, "eval_out", "arith_llm.npz"))
    n_calls = -(-TOY_PROMPTS // 32)
    res = {"losses": losses, "train_s": train_s, "acc": {}, "ckpt_acc": {}, "launches": {}}
    for mode, sides in CKPT_MODES:
        cfg_m = train.arith_llm_config(**sides)
        count_reset()
        acc, preds = train.eval_accuracy(params, cfg_m, prompts, answers, batch=32)
        res["launches"][mode] = counts()
        check_counts(f"toy {mode}", res["launches"][mode], n_calls * cfg.depth, train.ANS_LEN - 1)
        acc_ckpt, _ = train.eval_accuracy(llm.params_from_jax(ckpt, cfg_m), cfg_m, prompts, answers, batch=32)
        res["acc"][mode], res["ckpt_acc"][mode] = acc, acc_ckpt
        log(f"[toy] {mode} cache: exact-match {acc:.4f} on {TOY_PROMPTS} held-out prompts (the committed "
            f"checkpoint {acc_ckpt:.4f}); first answers {preds[:6]} for {answers[:6]}")
        if not all(len(p) == 3 and p.isdigit() for p in preds):
            raise AssertionError(f"toy LLM {mode}: answers that are not three digits: {preds}")
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "toy_llm.npz")
        save_params(path, params)
        back = load_params(path, params)
        same = all(torch.equal(a, b_) for a, b_ in zip(params.parameters(), back.parameters()))
    log(f"[toy] save_params / load_params round trip: parameters equal={same}")
    if not same:
        raise AssertionError("toy LLM: the saved and loaded parameters differ")
    return res


# ---------------------------------------------------------------------------
# Phase 24: the tooling (the tuning cache and its autotuner, the cache-accuracy
# ladder, evalkit's perceptual scores; phase 13 ran the profiling helper)
# ---------------------------------------------------------------------------

#: This run's temp dir (main): the tuning cache's file, the traces, the ladder's JSON.
TMP = None
#: Rounds of turns and calls a timed sample of the autotuner's sweeps.
TOOL_ROUNDS, TOOL_CALLS = 5, 20
#: Kernel D's sweep shape (phase 13's decode: b4 h32 hk8 d128, S_max 32768) and
#: the caches swept, by --kv-bits.
TUNE_D = dict(b=4, h=32, hk=8, d=128, s=32768)
TUNE_KV_BITS = {"int8": "8", "bf16": "16", "int4": "4", "k4v8": "k4v8"}
#: The gemv sweep: per-channel w8 (F1) and w4 (F2) at phase 10's decode shapes, M 4.
TUNE_GEMV_BITS = {"w8": 8, "w4": 4}
#: The attention spaces' shape: b4 h32 s4096 d64.
TUNE_ATTN = ["--batch", "4", "--heads", "32", "--seq", "4096", "--head_dim", "64"]
#: The JAX package's figures for the trained ladder's 64 prompts, from
#: bench/llm_accuracy_eval.py run on a CPU: the cache rows, the window rows
#: (window 16 + 4 sinks) and the engine rung (16 prompts; spec_tokens_per_round
#: 1.021 there).
JAX_LADDER = {"bf16": 1.0, "int8": 1.0, "k4v8": 1.0, "int4": 1.0}
JAX_LADDER_WINDOW = {"bf16": 1.0, "int8": 1.0, "k4v8": 0.984375}
JAX_LADDER_ENGINE = {"engine_plain": 1.0, "engine_spec_ngram": 1.0}


def tool_args(*args):
    return [str(a) for a in args] + ["--rounds", str(TOOL_ROUNDS), "--calls", str(TOOL_CALLS)]


def tuning_sweeps():
    """The autotuner in this process, each sweep saved into the run's
    cache: D's waves per cache at TUNE_D, F1's and F2's K-split caps at
    phase 10's decode shapes, then the k and bwd spaces (one row each,
    nothing to tune)."""
    from lowbit_quant_fa2_paddle_tpu_torch.tools import autotune

    b, h, hk, d, s = (TUNE_D[k] for k in "b h hk d s".split())
    out = {"decode": {}, "gemv": {}, "attn": {}}
    for mode, kv in TUNE_KV_BITS.items():
        r = autotune.main(tool_args("--space", "decode", "--kv-bits", kv, "--batch", b, "--heads", h, "--kv-heads", hk,
                                    "--head_dim", d, "--seq", s) + ["--save"])
        out["decode"][mode] = r
        log(f"[tool] decode {mode} cache b{b} h{h} hk{hk} d{d} S_max {s}, {TOOL_ROUNDS} rounds of {TOOL_CALLS} calls: "
            + "; ".join(f"waves {x['waves']:g} ({x['n_splits']} splits) median {x['ms']:.4f} ms spread "
                        f"{x['spread_ms']:.4f}{' [heuristic]' if x['heuristic'] else ''}" for x in r["rows"])
            + f" -> saved waves {r['best']['waves']:g}")
    for mode, bits in TUNE_GEMV_BITS.items():
        for n, k in DECODE_NK:
            r = autotune.main(tool_args("--space", "gemv", "--gemv-bits", bits, "--gemv-m", 4, "--gemv-n", n,
                                        "--gemv-k", k) + ["--save"])
            out["gemv"][(mode, n, k)] = r
            log(f"[tool] gemv {mode} M4 N{n} K{k}: " + "; ".join(
                f"max_splits {x['max_splits']} ({x['structure']}, {x['ksplit']} splits) median {x['ms'] * 1e3:.2f} us "
                f"spread {x['spread_ms'] * 1e3:.2f}{' [heuristic]' if x['heuristic'] else ''}" for x in r["rows"])
                + f" -> saved max_splits {r['best']['max_splits']}")
    for space in ("k", "bwd"):
        r = autotune.main(tool_args("--space", space, *TUNE_ATTN) + ["--save"])
        out["attn"][space] = r["best"]
        log(f"[tool] --space {space} b4 h32 s4096 d64: {r['best']['ms']:.4f} ms ({r['best']['tflops']:.1f} TFLOP/s, "
            f"design {r['best']['design']}, spread {r['best']['spread_ms']:.4f}); {r.get('not_saved')}")
    return out


def tuned_decode_check(gen, sweeps):
    """Kernel D through decode_attention under the saved waves, per cache:
    the launches on the tuned split count, the output against the plain
    version walking the same split_keys at phase 9's bounds, the same bits
    twice; the kernels-line record (ms: the sweep's median for the winner)."""
    from lowbit_quant_fa2_paddle_tpu_torch.ops import decode as DD
    from lowbit_quant_fa2_paddle_tpu_torch.utils.benchmark import cuda_time_ms

    b, h, hk, d, s = (TUNE_D[k] for k in "b h hk d s".split())
    records = {}
    for mode in TUNE_KV_BITS:
        best = sweeps[mode]["best"]
        kargs, kkw, pargs, pkw = decode_inputs(gen, b, h, hk, d, s, mode, [s, 1, 4097, 0])
        q, kq, vq, ks, lens = kargs
        waves = DD.tuned_waves(*DECODE_MODES[mode][:2], d, s, q.device)
        plan = DD.kernel_partition(q, kq, vq, int_qk=pkw["int_qk"])
        before = dict(DD.decode_attention.launches_by_splits)
        o, lse = DD.decode_attention(*kargs, **kkw, return_lse=True)
        o2, lse2 = DD.decode_attention(*kargs, **kkw, return_lse=True)
        o_ref, lse_ref = DD.decode_attention_plain(*pargs, **pkw, split_keys=plan["split_keys"], warps=plan["warps"])
        torch.cuda.synchronize()
        by_splits = {n: c - before.get(n, 0) for n, c in DD.decode_attention.launches_by_splits.items()
                     if c != before.get(n, 0)}
        r = stats(o, o_ref, lse, lse_ref)
        ulp = bf16_ulp(float(o_ref.float().abs().max()))
        same = torch.equal(o, o2) and torch.equal(lse, lse2)
        log(f"[D24] {mode} cache under the saved waves {waves:g}: plan {plan['n_splits']} splits of "
            f"{plan['split_keys']} keys, launches by split count {by_splits}; cos={r['cos']:.7f} max_do={r['max_do']:.4g} "
            f"(bound {ulp:.3g}) max_dlse={r['max_dlse']:.3g} same_bits_twice={same}")
        if not (waves == best["waves"] and plan["n_splits"] == best["n_splits"] and by_splits == {best["n_splits"]: 2}
                and r["finite"] and r["cos"] >= COS_MIN and r["max_do"] <= ulp and r["max_dlse"] <= 1e-4 and same):
            raise AssertionError(f"kernel D under the tuned plan ({mode}): waves {waves}, plan {plan}, launches "
                                 f"{by_splits}, {r}, same bits {same}; the sweep's winner {best}")
        full = torch.full_like(lens, s)
        plain_ms = cuda_time_ms(lambda: DD.decode_attention_plain(*pargs[:5], full, **pkw), warmup=1, reps=3)
        cache_bytes = nbytes(kq, vq, ks, pargs[4])
        library_ms = None
        if mode == "bf16":  # one SDPA call, one query per head, over the same bf16 cache
            library_ms = cuda_time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
                q[:, :, None], kq, vq, enable_gqa=True), warmup=3, reps=20)
        heuristic = next(x for x in sweeps[mode]["rows"] if x["heuristic"])
        records[mode] = {"max_abs_err": r["max_do"], "ms": best["ms"], "spread_ms": best["spread_ms"],
                         "plain_ms": plain_ms, **bound(cache_bytes + nbytes(q, lens) * 2), "library_ms": library_ms,
                         "design": DD.kernel_design(), "waves": waves, "n_splits": plan["n_splits"],
                         "launches": by_splits[best["n_splits"]], "heuristic_ms": heuristic["ms"],
                         "heuristic_spread_ms": heuristic["spread_ms"], "heuristic_splits": heuristic["n_splits"]}
        del kargs, pargs, o, o2, o_ref
    return records


def tuned_gemv_check(gen, sweeps):
    """F1 (w8) and F2 (w4) through wq_matmul_per_channel under the saved
    K-split caps at phase 10's decode shapes: the launches on the tuned
    split count, the output against the plain version at phase 10's
    bounds, the same bits twice; the kernels-line records."""
    from lowbit_quant_fa2_paddle_tpu_torch.ops import gemv as G
    from lowbit_quant_fa2_paddle_tpu_torch.utils.benchmark import cuda_time_ms

    records = {}
    library = {}
    for mode, bits in TUNE_GEMV_BITS.items():
        wrapper = G.wq_matmul_fused if bits == 4 else G.wq_matmul_per_channel  # w4 runs F2
        for n, k in DECODE_NK:
            best = sweeps[(mode, n, k)]["best"]
            x = torch.randn(4, k, generator=gen, device="cuda").bfloat16()
            wt, w = gemv_weights(gen, mode, n, k)
            cap = G.tuned_max_splits(bits, n, k, x.device)
            before = dict(wrapper.launches_by_splits)
            y, y2, y_ref = gemv_call(mode, x, wt), gemv_call(mode, x, wt), gemv_plain(mode, x, wt)
            torch.cuda.synchronize()
            by_splits = {c: v - before.get(c, 0) for c, v in wrapper.launches_by_splits.items() if v != before.get(c, 0)}
            same = torch.equal(y, y2)
            err = check_gemv(f"{mode} M4 N{n} K{k} under the saved max_splits {cap} (launches by K splits "
                             f"{by_splits}, same bits twice {same})", y, y_ref, gemv_dot_max(mode, x, wt))
            if cap != best["max_splits"] or by_splits != {best["ksplit"]: 2} or not same:
                raise AssertionError(f"{mode} N{n} K{k} under the tuned plan: cap {cap}, launches {by_splits}, same "
                                     f"bits {same}; the sweep's winner {best}")
            if (n, k) not in library:
                wd = w.bfloat16()
                wds = [wd.clone() for _ in range(max(2, math.ceil(128e6 / nbytes(wd))))]
                library[(n, k)] = cycle_ms([functools.partial(torch.matmul, x, c.T) for c in wds])
                del wds
            heuristic = next(r for r in sweeps[(mode, n, k)]["rows"] if r["heuristic"])
            wbytes = nbytes(wt["packed"], wt["scale"])
            records[(mode, n, k)] = {
                "max_abs_err": err, "ms": best["ms"], "spread_ms": best["spread_ms"],
                "plain_ms": cuda_time_ms(lambda: gemv_plain(mode, x, wt), warmup=1, reps=3),
                **bound(wbytes + nbytes(x) + 4 * n * 2), "library_ms": library[(n, k)],
                "design": G.kernel_design(x.dtype), "max_splits": cap, "ksplit": best["ksplit"],
                "launches": by_splits[best["ksplit"]], "heuristic_ms": heuristic["ms"],
                "heuristic_spread_ms": heuristic["spread_ms"], "heuristic_ksplit": heuristic["ksplit"]}
    return records


def ladder_phase():
    """The trained ladder of tools.llm_accuracy_eval on the checkpoint (64
    prompts): every row beside the JAX package's CPU figure, none more than
    1/64 below it, the four cache rows at >= 0.98 (phase 12's bound), each
    cache and window row's launches one generate's (A and C1 once a layer at
    prefill, D once a layer and decode step; A on wgmma, C1 on vector, D on
    its design)."""
    from lowbit_quant_fa2_paddle_tpu_torch.models import train
    from lowbit_quant_fa2_paddle_tpu_torch.ops.decode import kernel_design as d_design
    from lowbit_quant_fa2_paddle_tpu_torch.tools import llm_accuracy_eval as E

    depth = train.arith_llm_config().depth
    count_reset()
    out = E.main(["--checkpoint", os.path.join(REPO, "eval_out", "arith_llm.npz"),
                  "--json", os.path.join(TMP, "torch_llm_result.json")])
    designs = {name: design_counts(name) for name in ("A", "C1", "D")}
    want_row = {"A": depth, "C1": depth, "D": depth * (train.ANS_LEN - 1)}
    rows = [(f"{m} cache", out["table"][m], JAX_LADDER[m]) for m in E.MODES]
    rows += [(f"{m} cache, window {E.WINDOW} + {E.SINK} sinks", out["window_table"][m], JAX_LADDER_WINDOW[m])
             for m in E.WINDOW_MODES]
    rows += [(key, out["serving_spec"][key], JAX_LADDER_ENGINE[key]) for key in JAX_LADDER_ENGINE]
    for name, row, jax_acc in rows:
        extra = {k: row[k] for k in ("generation_agreement_vs_bf16", "spec_tokens_per_round", "token_agreement")
                 if k in row}
        log(f"[ladder] {name}: task exact-match {row['task_accuracy']:.6f} (the JAX package on a CPU: {jax_acc}) "
            f"{extra} launches {row['launches']}")
        if row["task_accuracy"] < jax_acc - 1 / 64:
            raise AssertionError(f"ladder row {name}: {row['task_accuracy']} is more than 1/64 below JAX's {jax_acc}")
        if not name.startswith("engine") and row["launches"] != want_row:
            raise AssertionError(f"ladder row {name}: launches {row['launches']} != {want_row}")
    for m in E.MODES:
        if out["table"][m]["task_accuracy"] < 0.98:
            raise AssertionError(f"checkpoint exact-match {out['table'][m]['task_accuracy']} < 0.98 with the {m} cache")
    got = counts()
    log(f"[ladder] launches over the ladder {got}, by design {designs}")
    if (designs["A"] != {"wgmma": got["A"]} or designs["C1"] != {"vector": got["C1"], "scalar": 0}
            or designs["D"] != {d_design(): got["D"]}):
        raise AssertionError(f"the ladder's launches by design {designs} (all {got})")
    return out


def perceptual_phase(frames, frame_cos):
    """evalkit.perceptual's scores of phase 5's per-impl frames (after its 3
    steps; w8 weights with int8 attention) against its fp run, beside the
    frame cos; no bound yet."""
    from lowbit_quant_fa2_paddle_tpu_torch.evalkit.perceptual import perceptual_report

    out = {}
    for impl in ("int8", "int8_v8", "int4", "w8"):
        rep = perceptual_report(frames[impl], frames["fp"])
        if not all(math.isfinite(v) for v in rep.values()):
            raise AssertionError(f"non-finite perceptual scores for {impl}: {rep}")
        out[impl] = rep
        log(f"[perceptual] DiT {impl} vs fp, {frames[impl].shape[0]} frames of {frames[impl].shape[1]} x "
            f"{frames[impl].shape[2]}: frame cos {frame_cos[impl]:.6f}; " + ", ".join(f"{k} {v:.6g}" for k, v in rep.items()))
    return out


def tooling_phase(gen, dit_r, llm_r):
    """Phase 24 (see the module note)."""
    from lowbit_quant_fa2_paddle_tpu_torch.utils import tuning

    log(f"[tool] the tuning cache: {tuning.cache_path()} (entries before the sweeps: {len(tuning._load())})")
    sweeps = tuning_sweeps()
    with open(tuning.cache_path()) as f:
        saved = json.load(f)
    log(f"[tool] {len(saved)} entries saved: " + ", ".join(f"{k}: " + json.dumps({x: v[x] for x in v if x in
                                                                                   ("waves", "max_splits", "us")})
                                                       for k, v in sorted(saved.items())))
    # The path: D and F under the saved plans, then the ladder, counted from 0.
    count_reset()
    dec = tuned_decode_check(gen, sweeps["decode"])
    gemv = tuned_gemv_check(gen, sweeps["gemv"])
    ladder = ladder_phase()
    perceptual = perceptual_phase(dit_r.pop("frames"), dit_r["frame_cos"])
    log(f"[trace] phase 13's decode-step traces: " + "; ".join(
        f"{mode}: {os.path.basename(t['path'])} D {len(t['D'])} F {len(t['F'])} kernel names"
        for mode, t in llm_r["traces"].items()))
    return {"decode": dec, "gemv": gemv, "attn": sweeps["attn"], "ladder": ladder, "perceptual": perceptual}


def cuda_event_ms(fn):
    """Device ms of one call between two CUDA events."""
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b)


def timed(phase, *args):
    """Run one phase and log its seconds (the card's memory cache emptied
    after it)."""
    t0 = time.perf_counter()
    out = phase(*args)
    torch.cuda.empty_cache()
    log(f"[time] {phase.__name__}: {time.perf_counter() - t0:.1f} s")
    return out


def main():
    global TMP
    # Before any module of the port is imported: the tuning cache is this
    # run's own file, so no user's cache moves a phase's figures.
    TMP = tempfile.mkdtemp(prefix="chip_smoke_")
    os.environ["LOWBIT_FA_TORCH_TUNING_CACHE"] = os.path.join(TMP, "tuning.json")
    log(f"[tool] LOWBIT_FA_TORCH_TUNING_CACHE={os.environ['LOWBIT_FA_TORCH_TUNING_CACHE']}")
    try:
        run()
    finally:
        shutil.rmtree(TMP, ignore_errors=True)


def run():
    smi = device_phase()
    sys.path.insert(0, REPO)
    if not os.path.isdir(os.path.join(REPO, PKG)):
        raise RuntimeError(f"the port package {PKG}/ is not next to chip_smoke.py")
    build_s = build_phase()
    start_gemv_probe_build()
    gen = torch.Generator(device="cuda").manual_seed(1234)
    c1 = timed(quant_phase, gen)
    lowq = timed(lowbit_quant_phase, gen)
    attn = timed(attention_phase, gen)
    lowa = timed(lowbit_attention_phase, gen)
    api = timed(entry_point_phase, gen)
    dit_r = timed(main_path_phase)
    bwd = timed(bwd_phase, gen)
    _, qz_launches = timed(bwd_accuracy_phase, gen)
    train_r = timed(train_phase)
    dec = timed(decode_phase, gen)
    fkv = timed(fused_kv_phase, gen)
    # Phase 12's w8 and w4 runs (its cache rows are phase 24's ladder).
    timed(checkpoint_wq_phase)
    llm_r = timed(full_width_phase)
    # Phase 10 after phase 13: by then the copy-only probe's package copy,
    # built at the lowest priority beside the phases before, is ready.
    gemv = timed(gemv_phase, gen)
    # Phase 15 (its 128K decode rows run in phase 14, on that phase's cache).
    timed(mask_edge_phase, gen)
    win_a = timed(window_attention_phase, gen)
    win_d = timed(window_decode_phase, gen)
    model_13, prompt_13 = llm_r.pop("_model"), llm_r.pop("_prompt")
    win_llm = timed(window_llm_phase, model_13, llm_r.pop("_first_logits_int8"))
    # Phase 16 (kernels, then phase 13's model at b1, then the checkpoint).
    spec_d = timed(spec_kernel_phase, gen)
    spec_r = timed(spec_full_width_phase, model_13, prompt_13)
    # Phase 19 (paged D, then the serving engine on phase 13's model and its
    # window-4096 twin, then the checkpoint through the engine).
    d19 = timed(paged_decode_phase, gen)
    serve19 = timed(serving_phase, model_13)
    timed(serving_window_phase, model_13)
    del model_13, prompt_13
    timed(serving_checkpoint_phase)
    timed(spec_checkpoint_phase)
    long_r = timed(long_context_phase)
    # Phase 17 (its kernels, then the head_dim-256 model at full width).
    edge17 = timed(hd256_edge_phase, gen)
    c1_17 = timed(hd256_quant_phase, gen)
    a17 = timed(hd256_attention_phase, gen)
    d17 = timed(hd256_decode_phase, gen)
    llm17 = timed(hd256_llm_phase)
    # Phase 18 (G1/G2 and D's T-token instances at head_dim 256, then the hd256
    # model's speculative decoding, then the DiT on 256-wide heads).
    bwd18, qz18 = timed(hd256_bwd_phase, gen)
    d18 = timed(hd256_spec_kernel_phase, gen)
    model_17, prompt_17 = llm17.pop("_model"), llm17.pop("_prompt")
    spec18 = timed(hd256_spec_phase, model_17, prompt_17)
    del model_17, prompt_17
    train18 = timed(hd256_train_phase)
    # Phase 20 (kernel D at head dims 80 and 96, then the Phi-3-mini-geometry
    # model: generate in every cache mode and w8, speculative decoding, the
    # serving engine, the quantized cache's checkpoint).
    edge20 = timed(offladder_edge_phase, gen)
    c1_20 = timed(offladder_quant_phase, gen)
    a20 = timed(phi3_prefill_attention_phase, gen)
    d20 = timed(offladder_decode_phase, gen)
    f1_20 = timed(phi3_f1_phase, gen)
    phi3 = timed(phi3_llm_phase)
    model_20, prompt_20 = phi3.pop("_model"), phi3.pop("_prompt")
    spec20 = timed(phi3_spec_phase, model_20, prompt_20)
    serve20 = timed(phi3_serving_phase, model_20)
    timed(phi3_checkpoint_phase, model_20, prompt_20)
    del model_20, prompt_20
    # Phase 21 (kernels D and E at the run-time head dims, A, C1 and F1 at the
    # MPT-30B geometry's shapes, then the MPT-30B-geometry model: generate in
    # every cache mode and w8, speculative decoding, the serving engine).
    edge21 = timed(rt_dim_edge_phase, gen)
    c1_21 = timed(mpt_quant_phase, gen)
    a21 = timed(mpt_prefill_attention_phase, gen)
    d21 = timed(rt_dim_decode_phase, gen)
    e21 = timed(rt_dim_fused_kv_phase, gen)
    f1_21 = timed(mpt_f1_phase, gen)
    mpt = timed(mpt_llm_phase)
    model_21, prompt_21 = mpt.pop("_model"), mpt.pop("_prompt")
    spec21 = timed(mpt_spec_phase, model_21, prompt_21)
    serve21 = timed(mpt_serving_phase, model_21)
    del model_21, prompt_21
    # Phases 22 and 23 (a)/(b): the parallel layer, then the sharded DiT
    # training step and the FSDP forward, in the same four ranks on the card.
    ranks = timed(rank_suites_phase)
    # Phase 22's cases, then its kernel rows timed in this process alone.
    par = timed(parallel_phase, ranks["card"])
    par_rows = timed(parallel_rows_phase, gen)
    # Phase 23: (a)/(b)'s cases, their kernel rows in this process, then the
    # toy LLM trained and graded.
    tr = timed(train_parallel_phase, ranks["train"])
    tr_rows = timed(train_rows_phase, gen)
    toy = timed(toy_llm_phase)
    # Phase 24: the tooling.
    tool = timed(tooling_phase, gen, dit_r, llm_r)
    # Phase 25: A, D and E above head_dim 256 (their edge grids, then timed
    # rows), then the LLM of 8 heads of 512: generate in every cache mode and
    # w8, the chunked prefill, speculative decoding, the serving engine.
    edge25 = timed(hd512_edge_phase, gen)
    c1_25 = timed(hd512_quant_phase, gen)
    a25 = timed(hd512_attention_phase, gen)
    d25 = timed(hd512_decode_phase, gen)
    hd512 = timed(hd512_llm_phase)
    model_25, prompt_25 = hd512.pop("_model"), hd512.pop("_prompt")
    chunked25 = timed(hd512_chunked_phase, model_25, prompt_25)
    spec25 = timed(hd512_spec_phase, model_25, prompt_25)
    serve25 = timed(hd512_serving_phase, model_25)
    del model_25, prompt_25
    src = f"{PKG}/csrc"
    dl = dit_r["launches"]
    replaces_a = "lowbit_quant_fa2_paddle_tpu/ops/attention.py:1502"
    wgmma_src = dict(route="cuda", source=f"{src}/attention_fwd_wgmma.cu", replaces=replaces_a)
    timing = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    a_keys = timing + ("exp_floor_ms", "design")
    prefill = "LLM prefill shape b1 h32 hk8 s32704 d128 causal"
    quant_src = dict(route="cuda", source=f"{src}/quant.cu")
    replaces_c = "lowbit_quant_fa2_paddle_tpu/ops/quant.py:"
    kernels = [
        # C1/C2 on the DiT's K as it hands it over (a strided view of qkv), then
        # on a contiguous K of the same shape (no model path), the LLM
        # prefill's K and per block 64 (no model path).
        # Phase 23 (b)'s FSDP forward runs C1 and A at these shapes too (b1 a rank).
        dict(name="quant_int8", **quant_src, replaces=replaces_c + "215",
             launches=dl["int8"]["C1"] + tr["b"]["launches"]["C1"], **c1["view"]),
        dict(name="quant_int8 (contiguous DiT-shape K)", **quant_src, replaces=replaces_c + "215", launches=0,
             **c1["contiguous"]),
        dict(name="quant_int8 (LLM prefill K b4 h8 s32704 d128)", **quant_src, replaces=replaces_c + "215",
             launches=llm_r["int8"]["launches"]["C1"], **c1["prefill"]),
        dict(name="quant_int8 (per block 64, DiT-shape K)", **quant_src, replaces=replaces_c + "215", launches=0,
             **c1["block64"]),
        dict(name="quant_int4", **quant_src, replaces=replaces_c + "327", launches=dl["int4"]["C2"],
             **lowq[(4, "view")]),
        dict(name="quant_int4 (contiguous DiT-shape K)", **quant_src, replaces=replaces_c + "327", launches=0,
             **lowq[(4, "contiguous")]),
        # C3 on the bits="int2" entry point's contiguous K, then on the DiT's K
        # view and per block 64 (no model path runs C3 on those).
        dict(name="quant_int2", **quant_src, replaces=replaces_c + "406", launches=api["int2"]["C3"],
             **lowq[(2, "contiguous")]),
        dict(name="quant_int2 (DiT K view)", **quant_src, replaces=replaces_c + "406", launches=0, **lowq[(2, "view")]),
        dict(name="quant_int2 (per block 64, DiT-shape K)", **quant_src, replaces=replaces_c + "406", launches=0,
             **lowq[(2, "block64")]),
        dict(name="attention_fwd (int8, Q quantized in-kernel)", launches=dl["int8"]["A"] + tr["b"]["launches"]["A"],
             **wgmma_src, **{k: attn["fused dit"][k] for k in a_keys}),
        dict(name="attention_fwd (fp)", launches=dl["fp"]["A"], **wgmma_src, **{k: attn["fp dit"][k] for k in a_keys}),
        dict(name=f"attention_fwd (int8, Q quantized in-kernel; {prefill})", launches=llm_r["int8"]["launches"]["A"],
             **wgmma_src, **{k: attn["fused prefill"][k] for k in a_keys}),
        # No model path runs fp at this shape (the LLM prefill runs int8): 0.
        dict(name=f"attention_fwd (fp; {prefill})", launches=0, **wgmma_src,
             **{k: attn["fp prefill"][k] for k in a_keys}),
        dict(name="attention_fwd (int4 K)", launches=dl["int4"]["A"], **wgmma_src,
             **{k: lowa["int4-K"][k] for k in a_keys}),
        dict(name="attention_fwd (int2 K)", launches=api["int2"]["A"], **wgmma_src,
             **{k: lowa["int2-K"][k] for k in a_keys}),
        dict(name="attention_fwd (int8 V)", launches=dl["int8_v8"]["A"], **wgmma_src,
             **{k: lowa["int8-V"][k] for k in a_keys}),
        dict(name="attention_fwd (int8 V, int8 PV)", launches=api["int8_v8 pv_int8"]["A"], **wgmma_src,
             **{k: lowa["int8-PV"][k] for k in a_keys}),
    ] + [
        dict(name=f"decode_attention ({mode} cache)", route="cuda", source=f"{src}/decode_attention.cu",
             replaces="lowbit_quant_fa2_paddle_tpu/ops/decode.py:727", launches=launches, **dec[mode])
        for mode, launches in (
            ("int8", llm_r["int8"]["launches"]["D"]), ("bf16", llm_r["bf16"]["launches"]["D"]),
            # The int4 decodes of the checkpoint's ladder (phase 24) and of the toy LLM's grading (phase 23 (c)).
            ("int4", tool["ladder"]["table"]["int4"]["launches"]["D"] + toy["launches"]["int4"]["D"]),
            # k4v8 at this shape is on no model path (the 128K decode's row follows); the
            # integer QK chain at 4-bit K on none ("auto" takes the float chain).
            ("k4v8", 0), ("int4 int_qk", 0), ("k4v8 int_qk", 0))
    ] + [
        dict(name="decode_attention (k4v8 cache; 128K decode b4 h32 hk8 S_max 133120 d128)", route="cuda",
             source=f"{src}/decode_attention.cu", replaces="lowbit_quant_fa2_paddle_tpu/ops/decode.py:727",
             launches=long_r["launches"]["D"], **long_r["D"]),
        # The cross-attention launches of the 128K prefill: all of A's but the
        # in-chunk one that follows each C1.
        dict(name="attention_fwd (packed int4 K; 128K chunked prefill over the cache, b4 h32 hk8 sq4096 "
             "sk126976 d128)", launches=long_r["launches_prefill"]["A"] - long_r["launches_prefill"]["C1"],
             **wgmma_src, **long_r["A_cross"]),
    ] + [
        dict(name=name, route="cuda", source=f"{src}/gemv.cu",
             replaces="lowbit_quant_fa2_paddle_tpu/ops/gemv.py:" + ("255" if GEMV_MODES[mode] == "F1" else "368"),
             launches=launches, **{k: gemv[mode][k] for k in timing + ("design",) + (("kernel_ms",) if mode == "w8a8"
                                                                                        else ())})
        for name, mode, launches in [
            ("wq_matmul_per_channel (F1: w8, bf16 x)", "w8", llm_r["w8"]["launches"]["F1"]),
            ("wq_matmul_per_channel (F1: w8a8, int8 x)", "w8a8", gemv["w8a8"]["launches"]),
            ("wq_matmul_fused (F2: w4 per-channel)", "w4", llm_r["w4"]["launches"]["F2"]),
            ("wq_matmul_fused (F2: 2-bit, group 128)", "g2", gemv["g2"]["launches"]),
            ("wq_matmul_fused (F2: 4-bit, group 128)", "g4", gemv["g4"]["launches"]),
            ("wq_matmul_fused (F2: 8-bit, group 128)", "g8", gemv["g8"]["launches"]),
        ]
    ] + [
        # Phase 15: A's masks. The window LLM's prefills run the two rows at its
        # shape (int8 and bf16 cache: window 4096; the sink run: + 4 sinks).
        dict(name=f"attention_fwd ({key})", launches=launches, **wgmma_src, **{k: win_a[key][k] for k in a_keys})
        for key, launches in [
            (f"int8 {w}; b4 h32 s32768 d64 causal", 0)
            for w in ("full causal", "window 4096", "window 1024", "window 1024 + sink 128")] + [
            ("fp window 4096; b4 h32 s32768 d64 causal", 0),
            ("int8 window 4096; window LLM prefill b4 h32 hk8 s32704 d128 causal",
             win_llm["int8"]["launches_prefill"]["A"] + win_llm["bf16"]["launches_prefill"]["A"]),
            ("int8 window 4096 + sink 4; window LLM prefill b4 h32 hk8 s32704 d128 causal",
             win_llm["int8 sink 4"]["launches_prefill"]["A"]),
            ("int8 segment ids (varlen, 5 sequences of 1-11,000 tokens); b1 h32 s32768 d128 causal",
             win_a["int8 segment ids (varlen, 5 sequences of 1-11,000 tokens); b1 h32 s32768 d128 causal"]["launches"]),
            (f"int8 logit cap 50; DiT shape b1 h{H} s{S} d{D}", 0),
        ]
    ] + [
        # Phase 15: D's window walk; the window LLM's decode runs the int8, bf16
        # and int8 + 4 sinks rows at this shape.
        dict(name=f"decode_attention ({key}; b4 h32 hk8 S_max 32768 d128)", route="cuda",
             source=f"{src}/decode_attention.cu", replaces="lowbit_quant_fa2_paddle_tpu/ops/decode.py:727",
             launches=launches, **{k: win_d[key][k] for k in timing + ("design",)})
        for key, launches in [(key, {"int8 cache, window 4096": win_llm["int8"]["launches"]["D"],
                                     "int8 cache, window 4096 + sink 4": win_llm["int8 sink 4"]["launches"]["D"],
                                     "bf16 cache, window 4096": win_llm["bf16"]["launches"]["D"]}.get(key, 0))
                              for key in win_d]
    ] + [
        dict(name=f"decode_attention ({key}; layer 0's 128K cache, b4 h32 hk8 S_max 133120 d128)", route="cuda",
             source=f"{src}/decode_attention.cu", replaces="lowbit_quant_fa2_paddle_tpu/ops/decode.py:727",
             launches=0, **{k: long_r["D_window"][key][k] for k in timing + ("design",)})
        for key in long_r["D_window"]
    ] + [
        # Phase 16: D over T tokens and with INT8 PV. A row's launches are what
        # the full-width runs (generate, speculative_generate with each draft)
        # counted for its variant (kernel instance, T, cache bits, batch): the
        # int8 b1 rows generate's graph decode (T 1) and the verify steps of T
        # drafts, the int4 row the drafts' decode. The b4 rows and INT8 PV (an
        # entry-point mode, as in JAX) are on no model path.
        dict(name=f"decode_attention ({key}; h32 hk8 S_max 32768 d128)",
             route="cuda", source=f"{src}/" + ("decode_attention.cu" if spec_d[key]["variant"].startswith("single")
                                               else "decode_attention_multi.cu"),
             replaces="lowbit_quant_fa2_paddle_tpu/ops/decode.py:727",
             launches=spec_launches(spec_d[key]["variant"], spec_r),
             **{k: spec_d[key][k] for k in timing + ("design",)})
        for key in spec_d
    ] + [
        dict(name="fused_packed_kv_attention (int4 K/V)", route="cuda", source=f"{src}/fused_kv_attention_wgmma.cu",
             replaces="lowbit_quant_fa2_paddle_tpu/ops/fused_kv.py:377", launches=fkv["launches"],
             **{k: fkv[k] for k in timing + ("design",)}),
    ] + [
        dict(name=f"{fn} ({kern}, {desc})", route="cuda", source=f"{src}/attention_bwd_wgmma.cu",
             replaces="lowbit_quant_fa2_paddle_tpu/ops/attention_bwd.py:" + ("302" if kern == "G1" else "346"),
             launches=launches, **{k: bwd[mode][kern][k] for k in timing + ("design",)})
        for fn, kern in (("attention_bwd_dq", "G1"), ("attention_bwd_dkv", "G2"))
        for mode, desc, launches in (
            ("float", "bf16 operands", sum(c[kern] for c in train_r["flash_train"]["launches"])),
            ("quantized", "int8 codes", qz_launches[kern]),
        )
    ]
    # Phase 17: kernel A at head_dim 256 (its own source) in every mode, the
    # bias and fp32 PV; the hd256 LLM's prefills run the int8 causal row (its
    # two one-shot prefills and the chunked prefill's in-chunk calls) and the
    # chunked prefill's cross-attention row; kernel D at head_dim 256, whose
    # int8 and bf16 rows the hd256 LLM's graph decodes run.
    d256_src = f"{src}/attention_fwd_wgmma_d256.cu"
    chunked = llm17["chunked"]
    a17_launches = {"d256 int8; hd256 LLM prefill b4 h16 hk8 s32704 d256 causal":
                    llm17["int8"]["a_d256"] + llm17["bf16"]["a_d256"] + chunked["a_d256"] - chunked["cross_launches"]}
    a17_source = {key: (f"{src}/attention_fwd_wgmma_pv32_d256.cu" if "d256" in key else
                        f"{src}/attention_fwd_wgmma_pv32.cu") if "fp32 PV" in key else
                  d256_src if "d256" in key else f"{src}/attention_fwd_wgmma_bias.cu" for key in a17}
    kernels += [
        dict(name=f"attention_fwd ({key})", route="cuda", source=a17_source[key], replaces=replaces_a,
             launches=a17_launches.get(key, 0), **{k: a17[key][k] for k in a_keys})
        for key in a17
    ] + [
        dict(name="attention_fwd (packed int4 K d256; hd256 chunked prefill's last chunk over the cache, b4 h16 hk8 "
             "sq4096 sk28672 d256)", route="cuda", source=d256_src, replaces=replaces_a,
             launches=chunked["cross_launches"], **{k: llm17["A_cross"][k] for k in a_keys}),
    ] + [
        # C1 on the hd256 LLM's K: its one-shot prefills (int8 and bf16 cache)
        # and its chunked prefill's chunks.
        dict(name="quant_int8 (hd256 LLM prefill K b4 h8 s32704 d256)", **quant_src, replaces=replaces_c + "215",
             launches=llm17["int8"]["launches"]["C1"] + llm17["bf16"]["launches"]["C1"], **c1_17["prefill"]),
        dict(name="quant_int8 (hd256 LLM chunked prefill's chunk K b4 h8 s4096 d256)", **quant_src,
             replaces=replaces_c + "215", launches=chunked["c1"], **c1_17["chunk"]),
    ] + [
        dict(name=f"decode_attention ({mode} cache; b4 h16 hk8 S_max 32768 d256)", route="cuda",
             source=f"{src}/decode_attention_d256.cu", replaces="lowbit_quant_fa2_paddle_tpu/ops/decode.py:727",
             launches=llm17[mode]["d_d256"] if mode in ("int8", "bf16") else 0,
             **{k: d17[mode][k] for k in timing + ("design",)})
        for mode in d17
    ]
    # Phase 18: G1/G2 at head_dim 256 (their own source), whose float rows the
    # DiT with 256-wide heads' training steps run (flash_train and int8_train
    # both take the float backward) and whose int8-code rows the trainable
    # functions' bwd_quantized checks run; kernel D's T-token and INT8-PV
    # instances at head_dim 256, whose rows the hd256 model's generate and
    # speculative_generate counted per variant (the single-token rows are
    # decode_attention_d256.cu's).
    kernels += [
        dict(name=f"{fn} ({kern}, {desc}; DiT with 256-wide heads b1 h8 s{S} d256)", route="cuda",
             source=f"{src}/attention_bwd_wgmma_d256.cu",
             replaces="lowbit_quant_fa2_paddle_tpu/ops/attention_bwd.py:" + ("302" if kern == "G1" else "346"),
             launches=launches, **{k: bwd18[mode][kern][k] for k in timing + ("design",)})
        for fn, kern in (("attention_bwd_dq", "G1"), ("attention_bwd_dkv", "G2"))
        for mode, desc, launches in (
            ("float", "bf16 operands", sum(train18[impl]["g_d256"][kern] for impl in TRAIN_IMPLS)),
            ("quantized", "int8 codes", qz18[kern]),
        )
    ] + [
        dict(name=f"decode_attention ({key}; h16 hk8 S_max 32768 d256)", route="cuda",
             source=f"{src}/" + ("decode_attention_d256.cu" if d18[key]["variant"].startswith("single")
                                 else "decode_attention_multi_d256.cu"),
             replaces="lowbit_quant_fa2_paddle_tpu/ops/decode.py:727", launches=spec_launches(d18[key]["variant"], spec18),
             **{k: d18[key][k] for k in timing + ("design",)})
        for key in d18
    ]
    # Phase 19: kernel D over the paged cache (its own source); the pages of
    # 64 rows carry the engine's decode ticks at b8 (run (a) for int8, (g)'s
    # k4v8 run for k4v8), the other page sizes no model path.
    serve_launches = {"int8": serve19["a"]["variants"].get(f"paged T-token T1 k8v8 b{SERVE_BATCH}", 0),
                      "k4v8": serve19["g k4v8"]["variants"].get(f"paged T-token T1 k4v8 b{SERVE_BATCH}", 0)}
    kernels += [
        dict(name=f"decode_attention (paged {mode} cache, pages of {page}; b8 h32 hk8 32K rows a sequence d128)",
             route="cuda", source=f"{src}/decode_attention_paged.cu",
             replaces="lowbit_quant_fa2_paddle_tpu/ops/decode.py:727",
             launches=serve_launches[mode] if page == SERVE_PAGE else 0,
             **{k: d19[(mode, page)][k] for k in timing + ("design", "contiguous_ms")})
        for mode in PAGED_MODES for page in PAGED_PAGES
    ]
    # Phase 20: kernel D at head dims 80 and 96 (their own sources). The Phi-3
    # model's generate runs the d96 rows of its cache modes (int8 twice: the
    # dense and the w8 run), speculative_generate the T-token row (its T 4
    # verify steps) and the engine the paged row (its ticks); the integer
    # chain at 4-bit K and head dim 80 (Phi-2's shape) are on no model path.
    # C1 runs the prefill's K padded to 128 columns; F1 the w8 run's MLP
    # matrices (one launch each a layer and step).
    d20_launches = {f"d96 {mode} cache b8 h32 hk32 S_max 4096": phi3[mode]["launches"]["D"]
                    for mode in ("bf16", "int4", "k4v8")}
    d20_launches["d96 int8 cache b8 h32 hk32 S_max 4096"] = phi3["int8"]["launches"]["D"] + phi3["w8"]["launches"]["D"]
    d20_launches["d96 T4 int8 cache b1 h32 hk32 S_max 4096 (verify step)"] = spec_launches("T-token T4 k8v8 b1",
                                                                                            spec20)
    d20_launches[f"d96 paged int8 cache, pages of 64, b8 h32 hk32 4096 rows a sequence (engine tick)"] = serve20[
        "variants"].get(f"paged T-token T1 k8v8 b{PHI3_BATCH}", 0)
    # A runs every prefill of the Phi-3 model's runs at kernel dim 128:
    # generate's (b8) in each mode, speculative_generate's (b1, target and
    # draft) and the engine's (1,024-3,968 tokens).
    a20_launches = (sum(phi3[m]["launches"]["A"] for m in ("int8", "bf16", "int4", "k4v8", "w8"))
                    + sum(r["launches"]["A"] for r in spec20.values() if "launches" in r) + serve20["launches"]["A"])
    kernels += [
        dict(name=f"attention_fwd (int8, Q quantized in-kernel; Phi-3-mini-geometry prefill b1 h32 hk32 "
             f"s{PHI3_PROMPT} d96 padded to 128 causal)", launches=a20_launches, **wgmma_src,
             **{k: a20[k] for k in a_keys}),
    ] + [
        dict(name=f"decode_attention ({key})", route="cuda",
             source=f"{src}/decode_attention_" + ("paged_" if "paged" in key else "multi_" if "T4" in key else "")
             + "d80_96.cu", replaces="lowbit_quant_fa2_paddle_tpu/ops/decode.py:727",
             launches=d20_launches.get(key, 0), **{k: d20[key][k] for k in timing + ("design",)})
        for key in d20
    ] + [
        dict(name=f"quant_int8 (Phi-3-mini-geometry prefill K b8 h32 s{PHI3_PROMPT} d96, {tag})", **quant_src,
             replaces=replaces_c + "215",
             launches=sum(phi3[m]["launches"]["C1"] for m in ("int8", "bf16", "int4", "k4v8", "w8")) if c1_20[tag][
                 "design"] == "vector" else 0, **c1_20[tag])
        for tag in c1_20
    ] + [
        dict(name=f"wq_matmul_per_channel (F1: w8, bf16 x; Phi-3-mini-geometry decode M8 N{n} K{k})", route="cuda",
             source=f"{src}/gemv.cu", replaces="lowbit_quant_fa2_paddle_tpu/ops/gemv.py:255",
             launches=phi3["w8"]["launches"]["F1"] // 6, **f1_20[(n, k)])
        for n, k in f1_20
    ]
    # Phase 21: kernel D at the run-time head dims (the _dyn sources). The MPT
    # model's generate runs the d112 rows of its cache modes (int8 twice: the
    # dense and the w8 run), speculative_generate the T-token row and the
    # engine the paged row; Nemotron-4's d192 rows are on no model path. A
    # runs every prefill of the MPT runs at kernel dim 128, C1 their K padded
    # to 128 columns, F1 the w8 run's MLP matrices; kernel E at d112 its
    # entry point's one launch.
    mpt_modes = ("int8", "bf16", "int4", "k4v8", "w8")
    d21_launches = {f"d112 {mode} cache b8 h64 hk64 S_max 4096": mpt[mode]["launches"]["D"]
                    for mode in ("bf16", "int4", "k4v8")}
    d21_launches["d112 int8 cache b8 h64 hk64 S_max 4096"] = mpt["int8"]["launches"]["D"] + mpt["w8"]["launches"]["D"]
    d21_launches["d112 T4 int8 cache b1 h64 hk64 S_max 4096 (verify step)"] = spec_launches("T-token T4 k8v8 b1",
                                                                                            spec21)
    d21_launches[f"d112 paged int8 cache, pages of 64, b8 h64 hk64 4096 rows a sequence (engine tick)"] = serve21[
        "variants"].get(f"paged T-token T1 k8v8 b{MPT_BATCH}", 0)
    a21_launches = (sum(mpt[m]["launches"]["A"] for m in mpt_modes)
                    + sum(r["launches"]["A"] for r in spec21.values() if "launches" in r) + serve21["launches"]["A"])
    kernels += [
        dict(name=f"attention_fwd (int8, Q quantized in-kernel; MPT-30B-geometry prefill b1 h64 hk64 s{MPT_PROMPT} "
             f"d112 padded to 128 causal)", launches=a21_launches, **wgmma_src, **{k: a21[k] for k in a_keys}),
    ] + [
        dict(name=f"decode_attention ({key})", route="cuda",
             source=f"{src}/decode_attention_" + ("paged_" if "paged" in key else "multi_" if "T4" in key else "")
             + "dyn.cu", replaces="lowbit_quant_fa2_paddle_tpu/ops/decode.py:727",
             launches=d21_launches.get(key, 0), **{k: d21[key][k] for k in timing + ("design",)})
        for key in d21
    ] + [
        dict(name=f"quant_int8 (MPT-30B-geometry prefill K b8 h64 s{MPT_PROMPT} d112, {tag})", **quant_src,
             replaces=replaces_c + "215", launches=sum(mpt[m]["launches"]["C1"] for m in mpt_modes), **c1_21[tag])
        for tag in c1_21
    ] + [
        dict(name=f"wq_matmul_per_channel (F1: w8, bf16 x; MPT-30B-geometry decode M8 N{n} K{k})", route="cuda",
             source=f"{src}/gemv.cu", replaces="lowbit_quant_fa2_paddle_tpu/ops/gemv.py:255",
             launches=mpt["w8"]["launches"]["F1"] // 6, **f1_21[(n, k)])
        for n, k in f1_21
    ] + [
        dict(name="fused_packed_kv_attention (int4 K/V, b4 h32 s8192 d112: the d128 kernel with the head dim at run "
             "time)", route="cuda", source=f"{src}/fused_kv_attention_wgmma_pad.cu",
             replaces="lowbit_quant_fa2_paddle_tpu/ops/fused_kv.py:377", launches=e21["launches"],
             **{k: e21[k] for k in timing + ("design",)}),
    ]
    # Phase 22: kernel A at the ring's hop shape, launched by the ranks' ring
    # hops at that shape (phase (a)'s int8 rings and the ring-4 denoise step's
    # b1 hops: one diagonal hop a rank in the causal ring, the rest
    # unmasked), and kernel D at the context shard (one launch a rank).
    diag = par["a ring int8 causal"]["ranks"]
    hop_launches = {"the diagonal shard, causal": diag,
                    "an earlier rank's shard, unmasked": par["a ring int8"]["launches"]["A"]
                    + par["a ring int8 causal"]["launches"]["A"] - diag + par["e dit ring4 step"]["launches"]["A"]}
    h_, s_, d_ = RING_HOP
    kernels += [
        dict(name=f"attention_fwd (int8 codes, f32 out; ring hop over {what}, b1 h{h_} sq{s_} sk{s_} d{d_})",
             launches=n, **wgmma_src, **{k: par_rows[what][k] for k in a_keys})
        for what, n in hop_launches.items()
    ] + [
        dict(name="decode_attention (int8 cache; context shard of 4, b4 h32 hk8 S_max 8192 d128)", route="cuda",
             source=f"{src}/decode_attention.cu", replaces="lowbit_quant_fa2_paddle_tpu/ops/decode.py:727",
             launches=par["d context decode"]["launches"]["D"],
             **{k: par_rows["context shard"][k] for k in timing + ("design",)}),
    ]
    # Phase 23: A and G1/G2 at a rank's attention shape in the sharded step,
    # and C1 on the K a rank gathers over seq, launched by every rank of (a)
    # once a block.
    shard = "sharded DiT step's rank shape b{} h{} sq{} sk{} d{}".format(*SHARD_ATTN)
    gb, gh, _, gsk, gd = SHARD_ATTN
    kernels += [
        dict(name=f"quant_int8 (sharded DiT step's gathered K b{gb} h{gh} s{gsk} d{gd}, contiguous)", **quant_src,
             replaces=replaces_c + "215", launches=tr["a"]["launches"]["C1"],
             **{k: tr_rows["C1"][k] for k in timing + ("design",)}),
        dict(name=f"attention_fwd (int8, Q quantized in-kernel; {shard})", launches=tr["a"]["launches"]["A"],
             **wgmma_src, **{k: tr_rows["A"][k] for k in a_keys}),
    ] + [
        dict(name=f"{fn} ({kern}, bf16 operands; {shard})", route="cuda", source=f"{src}/attention_bwd_wgmma.cu",
             replaces="lowbit_quant_fa2_paddle_tpu/ops/attention_bwd.py:" + ("302" if kern == "G1" else "346"),
             launches=tr["a"]["launches"][kern], **{k: tr_rows[kern][k] for k in timing + ("design",)})
        for fn, kern in (("attention_bwd_dq", "G1"), ("attention_bwd_dkv", "G2"))
    ]
    # Phase 24: kernel D and F1/F2 under the plans the autotuner saved, as
    # decode_attention and wq_matmul_per_channel launch them after a --save.
    d_keys = timing + ("design", "waves", "n_splits", "heuristic_ms", "heuristic_splits", "spread_ms",
                       "heuristic_spread_ms")
    kernels += [
        dict(name=f"decode_attention ({mode} cache, tuned waves {r['waves']:g}: {r['n_splits']} splits; b{TUNE_D['b']} "
             f"h{TUNE_D['h']} hk{TUNE_D['hk']} S_max {TUNE_D['s']} d{TUNE_D['d']})", route="cuda",
             source=f"{src}/decode_attention.cu", replaces="lowbit_quant_fa2_paddle_tpu/ops/decode.py:727",
             launches=r["launches"], **{k: r[k] for k in d_keys})
        for mode, r in tool["decode"].items()
    ]
    f_keys = timing + ("design", "max_splits", "ksplit", "heuristic_ms", "heuristic_ksplit", "spread_ms",
                       "heuristic_spread_ms")
    kernels += [
        dict(name=f"{'wq_matmul_per_channel (F1: w8' if mode == 'w8' else 'wq_matmul_fused (F2: w4 per-channel'}, "
             f"bf16 x, tuned max_splits {r['max_splits']}: {r['ksplit']} K splits; M4 N{n} K{k})", route="cuda",
             source=f"{src}/gemv.cu", replaces="lowbit_quant_fa2_paddle_tpu/ops/gemv.py:" + ("255" if mode == "w8"
                                                                                           else "368"),
             launches=r["launches"], **{k_: r[k_] for k_ in f_keys})
        for (mode, n, k), r in tool["gemv"].items()
    ]
    # Phase 25: A at kernel dim 512 launched by every prefill of the hd512
    # runs (the one-shot prefills at b4 32,704 tokens, the chunked prefill's
    # in-chunk calls, the speculative and engine prefills), in the int8 mode
    # with Q quantized in the kernel, and by the chunked prefill over the
    # cache's int8 codes or packed INT4 K (rows of their own); the other
    # modes are on no model path. D at d512: each cache's generate, the
    # verify steps and the engine's ticks. C1 the hd512 prefills' K (scalar
    # design); E its entry point's launch.
    hd512_modes = ("int8", "bf16", "int4", "k4v8", "w8")
    a25_launches = (sum(hd512[m]["launches"]["A"] for m in hd512_modes)
                    + sum(r["a_d512"] - r["cross_launches"] for r in chunked25.values())
                    + sum(r["launches"]["A"] for r in spec25.values() if "launches" in r) + serve25["launches"]["A"])
    c0_25 = (-(-HD512_PROMPT // HD512_CHUNK) - 1) * HD512_CHUNK
    c1_25_launches = (sum(hd512[m]["launches"]["C1"] for m in hd512_modes) + sum(r["c1"] for r in chunked25.values())
                      + sum(r["launches"]["C1"] for r in spec25.values() if "launches" in r)
                      + serve25["launches"]["C1"])
    b5, h5, hk5 = HD512_BATCH, HD512["num_heads"], HD512["num_kv_heads"]
    prefill25 = f"hd512 LLM prefill b{b5} h{h5} hk{hk5} s{HD512_PROMPT} d512 causal"
    a5_src = dict(route="cuda", source=f"{src}/attention_fwd_wgmma_d512.cu", replaces=replaces_a)
    a25_keys = a_keys + ("library_backend",)
    d25_launches = {f"d512 {mode} cache b{b5} h{h5} hk{hk5} S_max 32768": hd512[mode]["launches"]["D"]
                    for mode in ("bf16", "int4", "k4v8")}
    d25_launches[f"d512 int8 cache b{b5} h{h5} hk{hk5} S_max 32768"] = (hd512["int8"]["launches"]["D"]
                                                                        + hd512["w8"]["launches"]["D"])
    d25_launches[f"d512 T4 int8 cache b1 h{h5} hk{hk5} S_max 32768 (verify step)"] = spec_launches(
        "T-token T4 k8v8 b1", spec25)
    d25_launches[f"d512 paged int8 cache, pages of 64, b8 h{h5} hk{hk5} {HD512_SERVE_ROWS} rows a sequence (engine "
                 f"tick)"] = serve25["variants"].get("paged T-token T1 k8v8 b8", 0)
    kernels += [
        dict(name=f"attention_fwd (d512 {mode}; b4 h8 s4096 d512)",
             launches=0, **a5_src, **{k: a25[f"d512 {mode}; b4 h8 s4096 d512"].get(k) for k in a25_keys})
        for mode in A17_MODES
    ] + [
        dict(name=f"attention_fwd (int8, Q quantized in-kernel; {prefill25})", launches=a25_launches, **a5_src,
             **{k: a25[f"d512 int8; {prefill25}"].get(k) for k in a_keys}),
    ] + [
        dict(name=f"attention_fwd ({'int8' if mode == 'int8' else 'packed int4'} K d512; hd512 chunked prefill's last "
             f"chunk over the cache, b{b5} h{h5} hk{hk5} sq{HD512_PROMPT - c0_25} sk{c0_25} d512)",
             launches=r["cross_launches"], **a5_src, **{k: r["A_cross"][k] for k in a_keys})
        for mode, r in chunked25.items()
    ] + [
        dict(name=f"quant_int8 (hd512 LLM prefill K b{b5} h{hk5} s{HD512_PROMPT} d512)", **quant_src,
             replaces=replaces_c + "215", launches=c1_25_launches, **c1_25),
        dict(name="fused_packed_kv_attention (int4 K/V, b4 h8 s4096 d512: the width-512 kernel)", route="cuda",
             source=f"{src}/fused_kv_attention_wgmma_d512.cu", replaces="lowbit_quant_fa2_paddle_tpu/ops/fused_kv.py:377",
             launches=a25["E"]["launches"], **{k: a25["E"][k] for k in timing + ("design", "library_backend")}),
    ] + [
        dict(name=f"decode_attention ({key})", route="cuda",
             source=f"{src}/decode_attention_" + ("paged_" if "paged" in key else "multi_" if "T4" in key else "")
             + "dyn512.cu", replaces="lowbit_quant_fa2_paddle_tpu/ops/decode.py:727",
             launches=d25_launches.get(key, 0), **{k: d25[key][k] for k in timing + ("design", "library_backend")})
        for key in d25
    ]
    log(f"[toy] phase 23 toy LLM: loss {toy['losses'][0]:.4f} -> {toy['losses'][-1]:.4f} in {toy['train_s']:.1f} s; "
        f"exact-match by cache {toy['acc']} (checkpoint {toy['ckpt_acc']})")
    log(f"[hd512] phase 25 edge grids worst max|do| {edge25}; generate ms/token by cache "
        + ", ".join(f"{m} {hd512[m]['decode_ms_per_token']:.3f}" for m in hd512_modes)
        + f"; D {hd512['profile']['D']:.3f} of "
        f"{hd512['profile']['D'] + hd512['profile']['GEMM'] + hd512['profile']['other']:.3f} device ms of an eager "
        f"int8 decode step; chunked vs one-shot cos " + ", ".join(f"{m} {r['cos']:.6f}" for m, r in chunked25.items())
        + f"; speculative (int4 self-draft) {spec25['self, int4 cache']['decode_ms_per_token']:.3f} ms per token "
        f"without its prefills; engine {serve25['tokens_per_s']:.1f} tokens/s")
    log(f"[mpt] phase 21 D edge grid worst max|do| by head dim {edge21}; E worst by head dim {e21['worst_by_dim']}; "
        f"generate ms/token by cache " + ", ".join(f"{m} {mpt[m]['decode_ms_per_token']:.3f}" for m in mpt_modes)
        + f"; speculative (int4 self-draft) {spec21['self, int4 cache']['decode_ms_per_token']:.3f} ms per token "
        f"without its prefills; engine {serve21['tokens_per_s']:.1f} tokens/s")
    log(f"[phi3] phase 20 D edge grid worst max|do| by head dim {edge20}; generate ms/token by cache "
        + ", ".join(f"{m} {phi3[m]['decode_ms_per_token']:.3f}" for m in ("int8", "bf16", "int4", "k4v8", "w8"))
        + f"; speculative (int4 self-draft) {spec20['self, int4 cache']['decode_ms_per_token']:.3f} ms per token "
        f"without its prefills; engine {serve20['tokens_per_s']:.1f} "
        f"tokens/s")
    log(f"[hd256] phase 17 A edge grid worst max|do| by group {edge17}; launches at d256: A "
        f"{sum(r['launches'] for r in kernels if 'd256' in r['name'] and r['name'].startswith('attention'))}, D "
        f"{sum(r['launches'] for r in kernels if 'd256' in r['name'] and r['name'].startswith('decode'))}, G1 "
        f"{sum(r['launches'] for r in kernels if 'd256' in r['name'] and r['name'].startswith('attention_bwd_dq'))}, G2 "
        f"{sum(r['launches'] for r in kernels if 'd256' in r['name'] and r['name'].startswith('attention_bwd_dkv'))}")
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": device}))


if __name__ == "__main__":
    try:
        main()
    except Exception:
        traceback.print_exc()
        print("chip_smoke: FAILED", file=sys.stderr)
        sys.exit(1)
