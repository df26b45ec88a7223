#!/usr/bin/env python3
"""Smoke run of the PyTorch port (`src/repro_torch`) on one CUDA card.

    python3 chip_smoke.py            # from the root of a checkout
    python3 chip_smoke.py --profile  # adds a torch.profiler phase (f)

Written for the NVIDIA H100: it builds the port's CUDA kernels from
`src/repro_torch/csrc/` with nvcc (sm_90a), holds each kernel against its
plain PyTorch version on the card, checks full-width f32 logits and greedy
tokens between the kernel path, the paged kernel path and the dense path,
then serves greedy requests through `Engine` in bf16 on the served model,
Qwen3-0.6B wrapped with AltUp K=2 (recycled), at its full width and depth,
with seeded random weights: once over contiguous slot caches and once
over a paged KV pool with prefix reuse. It then does the same for the
second served family, RWKV-6 "Finch" 1.6B wrapped with AltUp K=2, whose
recurrence runs through the WKV kernel, and for the windowed one,
gemma3-4b wrapped with AltUp K=2 (5 local layers with a 1024-row ring
cache to 1 global layer); it trains the served model at full width and
serves the trained weights; then the MoE family, qwen2-moe-a2.7b
wrapped with AltUp K=2, served at full depth and trained at 2 layers;
then the encoder-decoder family, t5-large wrapped with AltUp K=2
(with Sequence-AltUp beside it) and whisper-tiny wrapped with AltUp
K=2, served through Engine.generate and (T5) trained at full depth;
then deepseek-v3-671b wrapped with AltUp K=2 (multi-head latent
attention), at every published width, served at 5 layers with all 256
routed experts and trained at 2; last the zamba2-1.2b hybrid (Mamba-2
layers and one weight-tied shared attention block) wrapped with AltUp
K=2, served at full width and depth and trained at 12 layers, and
llava-next-mistral-7b (the VLM family, served text-only, trained with
its 576 stub image tokens) and granite-3-2b, each wrapped with AltUp
K=2; then serves over a tensor-parallel "model" axis (Engine(mesh=)): one
NCCL rank, and two gloo ranks sharing the card. Phases:

  (a) device   card name and power limit, as nvidia-smi gives them
  (b) build    nvcc build of every kernel, seconds and ptxas report;
               the flash source (b-build-flash) finishes while phase c
               checks the others, and is waited for before c-flash
  (c) kernels  each kernel vs its plain version at the shapes the serve
               phases give it (and at a spread of depths from 0 to
               2048): max error; device ms per call (torch.profiler) of
               the kernel (for the ragged decode attention, the split
               and the merge kernel together), its plain version and the
               library yardstick;
               the wrapper's ms per call (CUDA events); the bytes bound.
               c-paged also holds the paged kernel bitwise against the
               contiguous one on the same rows, through a permuted table;
               c-wkv holds the WKV kernel at (i)'s decode step, (h)'s
               forward, an odd length and a zero state (bitwise equal to
               no state)
      c-flash  the flash-attention kernel through ops.mha_flash, which no
               served path calls (as in the reference): Qwen3-0.6B's
               attention at full width as a causal prefill (B=4,
               S=T=2048), non-causal, with T > S, with int8 and fp8
               codes from quant.quantize; gemma3-4b's local layer (dh
               320, window 1024); untimed edge shapes, among them an S
               that is not a multiple of the bf16 kernel's query tile
               and code rows too narrow for a tensor map (dh 40 int8, dh
               24 fp8); the causal over non-causal time (fully masked
               tiles are skipped). Each bf16 case prints the producer
               the kernel ran (TmaProducer or CpAsyncProducer, from the
               kernel name in the profile that times it), and the odd
               cases check it; every profile counts exactly one flash
               kernel a call
      c-flash-paged  ops.mha_flash_paged over a 512-page pool of 16 rows
               with garbage in the free and tail pages: causal, window
               256 and int8, bitwise equal to the contiguous kernel on
               the same rows; then, untimed, pages of 5 rows (bf16 and
               fp8), which take the cp.async producer. The checked call
               of case 1 (bf16) and of the paged causal case runs with
               the launch counts set to 0 just before and read just
               after: the slice's path
      c-ragged-quant, c-paged-quant  the fused dequant of both
               entry points (int8 and fp8 codes, f32 scales, bf16 and f32
               queries) at c-ragged's and c-paged's shapes against
               ref.ragged_decode_quant_ref / paged_ragged_decode_ref, the
               paged one bitwise equal to the contiguous one; bytes bound
               with 1-byte codes and two 4-byte scales per row-head; no
               library call dequantizes and attends (SDPA on dequantized
               k/v is printed beside, labelled as such); then bf16 k/v
               under f32 queries, untimed; then every int8 and e4m3 code
               through the kernel, exactly
      c-ragged-shapes, c-paged-shapes  both entry points at Dh 320 (rep
               2, Hk 4: gemma3-4b), Dh 240 (gemma3-12b), Dh 85 (rep 1:
               rows that take the scalar tail) and rep 8 (Dh 128), with
               lengths at the span edges, four k/v storages (f32, bf16,
               int8, fp8), bf16 and f32 queries, paged bitwise equal to
               contiguous; Dh 320 timed in bf16 with its bound
      c-paged-long  one paged slot of 40960 rows (2560 table pages) and
               seven short ones, four storages, both query types,
               bitwise equal to contiguous; timed in bf16 with its bound
      c-* case j*  the fused AltUp and the decode attention at gemma3-4b's
               served shapes: AltUp at 8 tokens of d 2560; both entry
               points at Dh 320 (Hk 4, rep 2) halfway through (j) and
               j-paged, ring lengths (<= 1024) and global lengths; int8
               codes (contiguous) and fp8 codes (paged) at j-paged's
               ring shape; each timed with its bound
      c-* case m  the fused AltUp and the decode attention at
               qwen2-moe-a2.7b's served shapes (m-serve): AltUp at 8
               tokens of d 2048; the decode attention halfway through
               m-serve (16 kv heads of 128, rep 1); timed with its bound
      c-altup case l  the fused AltUp at deepseek-v3-671b's served step
               (8 tokens of d 7168, bf16), timed with its bound
      c-* cases z*, v*, granite*  the fused AltUp at zamba2-1.2b's step
               (8 tokens of d 2048, bf16 and f32) and llava's (d 4096);
               both decode-attention entry points halfway through
               z-serve (32 kv heads of 64, rep 1: the shared block),
               bf16 and f32 queries, float, int8 and fp8 k/v, the paged
               one bitwise equal to the contiguous one; the decode
               attention halfway through v-serve (8 kv heads of 128, rep
               4) and granite's serve (8 kv heads of 64, rep 4); each
               timed with its bound, SDPA beside
      c-* cases n-*, w-*  the same at t5-large's (n-serve: AltUp at 8
               tokens of d 1024 in f32; the decode attention halfway, 16
               kv heads of 64, rep 1, f32 storage and queries, then int8
               codes) and whisper-tiny's served shapes (w-serve: AltUp
               at 8 tokens of d 384, the decode attention over 6 kv
               heads of 64, bf16); each timed with its bound, SDPA beside
  (d) parity   full-width f32 decode_step logits over a chunked prefill
               and 16 greedy steps for 4 slots: the kernel path and the
               paged kernel path (permuted block table) vs the dense path
      d-quant  the same with int8 and with fp8 caches: the fused dequant
               vs the dense dequant path (1e-3, tokens identical), and,
               not gated, the quantized logits' distance from the
               unquantized f32 path's
      d-graph  the replaying Engine against the eager reference (the same
               static-buffer step called directly), full width, f32,
               contiguous and paged: 4 requests with logprobs, tokens
               identical, logprobs and every cache leaf within 1e-5
               (expected bitwise)
  (e) serve    8 greedy bf16 requests (prompts of 32-512 tokens, 64 new
               tokens each) through Engine(n_slots=8, max_len=2048,
               prefix_cache=False), through the eager reference; the
               kernels' launch counts of that run show the path used them
      e-graph  the same through Engine as a user calls it, whose
               pure-decode steps replay CUDA graphs: tokens and step
               counts identical to the eager run, one replay per
               pure-decode step, one capture per shape, launch counts
               (a replay adds its capture's counts) equal to the eager
               run's once the captures' warm-ups are taken out
      e-quant  the same traffic from int8 caches: the ragged kernel's
               launches (its fused dequant) == 28 x decode steps, and the
               cache bytes against (e)'s; e-quant-graph replayed, as
               e-graph
  (g) paged    16 greedy bf16 requests sharing a 250-token system prompt
               through Engine(paged=True, n_slots=16, n_pages=512), the
               prefix cache on: hits, page aliasing, a boundary-page copy
               per hit, over-commit of the pool, and the paged kernel's
               launch counts of that run; g-graph replayed, as e-graph
               (pool counters identical too)
      g-spill  the host spill tier: a prefix spilled to the host and
               restored serves the same tokens as the resident prefix;
               every copy, spill and restore held bitwise on the card
      g-quant  (g)'s traffic and gates from an fp8 pool; g-quant-graph
               replayed
  (h) parity   rwkv6-1.6b + AltUp K=2 at full width, f32: forward logits
               on 2 prompts of 64 tokens, then a token-by-token prefill
               and 16 greedy decode_steps, the kernel path vs the dense
               path; with, ungated, the per-layer record of both paths
               (time mix, channel mix, AltUp output), each layer's WKV
               through the kernel, the dense chunked form and the f32
               scan against a float64 scan, each decode layer's fused
               AltUp against float64, and the logits' magnitude
  (i) rwkv     8 greedy bf16 requests (prompts of 32-256 tokens, 32 new
               tokens) through Engine(n_slots=8, max_len=512) with the
               prefix cache on, at 8 of the 24 layers (I_SERVE_LAYERS,
               since PR 28): a max_new=1 donor over a prefix, then a
               request extending it hits and serves a cold engine's
               tokens; the WKV kernel launches 8 times per step;
               i-graph replayed (every step of a recurrent plan is
               chunk 1, so every step replays), as e-graph
      i-paged  4 bf16 requests through Engine(paged=True) and the
               contiguous engine, both replayed: tokens identical, every
               step replayed, no prefix hit (a recurrent plan's state is
               per slot; it reuses no pages)
  (j) gemma3-4b + AltUp K=2, sliding windows over ring caches:
      j-parity full-width f32 decode_step logits of the kernel path and
               the paged kernel path vs the dense path: a prefill of
               1100 and 1013 tokens in direct chunks of 64 (a chunk
               reads its rings before it writes, across the wrap), then
               16 greedy S=1 steps; tokens identical, every cache row
               below the sink within 1e-3, the dense logits within 1e-3
               of forward on the same tokens
      j-serve  8 greedy bf16 requests (prompts of 64-1150 tokens, two
               past the window, one that wraps during decode; 40 new)
               through Engine(n_slots=8, max_len=2048,
               prefix_cache=False): chunk-1 prefill, so every step is
               S=1 and launches one AltUp and one decode-attention
               kernel a layer; the eager twin (this line) and a replayed
               run held against it as e-graph at 6 layers (5 on rings,
               1 global; cut so the run fits its time), then j-graph
               replayed at 6 of the 34 layers (6 launches of each a
               step, 5 on rings, 1 global; cut for the run's time),
               every step a replay, with
               the replayed step's device ms
      j-paged  a 600-token system prompt served first, then 8 requests
               extending it (tails of 32-480 tokens, 32 new) over a pool
               of pages of 16 rows with prefix reuse: every hit copies
               the prompt's 38 pages and aliases none; the eager twin
               at 6 layers held as j-serve's; j-paged-graph replayed at
               6 layers (cut for the run's time), and its
               hits' tokens equal a cold engine's
      j-quant  j-paged's traffic from int8 slot caches (the contiguous
               ring copy, j-quant-int8-graph) and from an fp8 pool
               (j-quant-fp8-graph), both replayed only, at 6 layers (5
               on rings, 1 global; since PR 28), each run's hits'
               tokens equal to a cold engine's
  (s) self-speculative decoding (greedy) through Engine(speculative=True),
      every round from replayed CUDA graphs (snapshot + draft + ring
      restore, verify, post-verify restore), no new kernel:
      s-parity f32, TF32 off: speculative against non-speculative tokens,
               identical, on Qwen3-0.6B + AltUp K=2 at full width and
               depth (drafts through 14 of 28 layers), two requests:
               contiguous, paged (a donor, then a request that hits 130
               of its rows) and int8 slot caches; then gemma3-4b + AltUp
               K=2 at full width, 12 layers (10 on rings of 1024 rows, 2
               global), one request decoding across the wrap; then the
               contiguous case with a full-depth draft (every draft
               accepted, captures included) under a repetition penalty
               of 1.4, with logprobs. Gates: rounds ran, each replaying
               one draft and one verify graph (and one restore on
               rings), and the draft graphs launched the fused AltUp and
               the decode attention (paged: its paged entry point); the
               penalty case accepted drafts and its logprobs are within
               1e-3 of the non-speculative engine's
      s-serve  bf16, speculative against non-speculative, both replayed,
               on one stream (prompt 288, 64 new) and on (e)'s 8
               requests: decode tok/s, median and p80 ms of a round and
               of a step, accept rate, mean k, tokens a round, device ms
               of one draft round, one verify and one step (their most
               replayed graphs back to back; on (e)'s load their top
               kernels by torch.profiler), kernels a round, captures
               and their seconds; token agreement (not gated: bf16
               rounds the verify's dense chunk attention and the step's
               kernel differently), with the first differing position
               and the non-speculative run's top-2 logit margin there;
               the roofline's speculative_bytes at the measured accept
               rate and mean k (bytes_speedup, the round's bytes over a
               step's) beside the measured ratios
  (u) seeded sampling (temperature > 0), plain torch ops captured in the
      step's graphs (no new kernel; sampled steps still run the AltUp and
      decode-attention kernels):
      u-rng    the port's threefry2x32 on the card against the same
               functions on the CPU (which the CPU tests hold bitwise
               against jax.random): key data, 3-deep fold_in chains,
               random_bits and uniform (minval 0 and tiny) at (8,
               151936), bitwise; gumbel within 2e-6; categorical ids
               identical; the filters' keep masks over an 18-row top-k /
               top-p / min-p grid identical, or differing only at a
               threshold within its rounding: a top-p mass within the
               two sides' measured f32 cumsum errors added (or 1e-6), a
               min-p logit within 2e-6
      u-parity f32, TF32 off, Qwen3-0.6B + AltUp K=2 at full width, 8
               layers (28 before PR 28), 8 requests (greedy and sampled; temperatures
               0.7-1.2, top_k 0 / 50, top_p 0.9 / 1.0, min_p 0 / 0.05,
               one with repetition_penalty 1.3 and logprobs): tokens of
               the eager engine identical to the replayed one
               (contiguous, paged with a prefix hit, int8 caches), two
               seeded requests identical to B=1 generate(sampling=sp);
               Engine(speculative=True): eager and replayed identical,
               two replayed runs identical, the greedy requests' tokens
               identical to the non-speculative engine's; sampled graphs
               captured, the kernels launched
      u-serve  bf16, (e)'s load with temperature 0.8, top_k 50, top_p
               0.95, replayed: decode tok/s and median / p80 step ms
               against the greedy e-graph run's, the device ms of a
               sampled and a greedy step graph (back to back) and their
               kernels, the sampler's device ms at (8, 151936) split
               into threefry, Gumbel, sort and filters and the rest,
               port launches a decode step (gated as (e)'s), and a
               sampled speculative run: accept rate, mean k, ms a round
  (k) training (no kernel has a backward pass: the differentiated path
      runs none), then the trained weights served through the kernels:
      k-grad   Qwen3-0.6B + AltUp K=2 at full width, 2 layers, f32, TF32
               off: loss_fn and every leaf's gradient on the card against
               the CPU from one seeded init (loss 1e-5 relative, each
               leaf max|Δ| <= 1e-4 of its max); the fused and the plain
               cross entropy (no z-loss), and remat "full" against
               "none", on the card, within the same bound; the port's
               launch counts unchanged across the differentiated steps
      k-train  Trainer(device="cuda") on the registry's full qwen3-0.6b
               + AltUp K=2 (28 layers, bf16): the launcher's TrainConfig
               at 12 steps (cut for the run's time) of 8 x 512 tokens in 2
               microbatches (Adafactor, lr 0.3, warmup 10); gates: finite
               losses, the last 5 averaging at least 1 nat below the
               first; median step ms (steps 3-12), tokens/s, MFU over the bf16 dense
               peak, peak memory; one more step under torch.profiler
               (device ms against the median: the busy share; the top
               kernels); the plain attention's and the cross entropy's
               device ms at the step's shapes, timed alone
      k-resume full width, 4 layers: 6 steps straight against 3, a
               checkpoint, a new Trainer resumed from it and 3 more,
               deterministic algorithms on: equal final loss; the
               checkpoint read by bridge.load_npz bit for bit equal to
               the parameters written
      k-serve  k-train's weights (AltUp p and g moved by training), cast
               to f32, through Engine: 4 prompts of the pipeline, 16
               greedy tokens, through the kernels (graphs replayed) and
               with both kernel flags off: tokens identical, chosen-token
               logprobs within 1e-3, the kernels launched
  (m) qwen2-moe-a2.7b + AltUp K=2 (24 layers, d 2048, 16 heads of 128,
      60 routed experts padded to 64, top 4, 4 shared), the MoE family:
      its FFN is plain torch (routing, a stable sort, grouped products),
      served through the AltUp and decode-attention kernels:
      m-parity f32, TF32 off: moe_block's layer of experts on 128 tokens
               on the card against the CPU, with capacity_for's drops
               and drop-free, expert ids identical, outputs within 1e-5
               of the max, aux within 1e-6; a decode-shaped block under
               torch.cuda.set_sync_debug_mode("error") (no host sync, so
               a captured step may route); at 2 layers, (d)'s parity
               (kernel and paged kernel paths against the dense path,
               then int8), and a paged engine whose requests hit 130
               rows of a donor, kernels against dense: tokens identical,
               logits (logprobs) within 1e-3
      m-grad   2 layers, f32: loss_fn with the aux loss and every leaf's
               gradient (router and experts included) on the card
               against the CPU: each leaf within 1e-4 of its max, the
               aux within 1e-6, no kernel launched
      m-train  Trainer at full width and 2 layers, bf16, 12 steps of 8 x
               512 tokens in 2 microbatches: a falling loss, tokens/s,
               MFU from model_flops_per_token (routed experts at top_k /
               num_experts), peak memory
      m-serve  (e)'s traffic at 12 of the 24 layers, replayed
               (m-serve-graph): the numbers of (e), 12 AltUp and 12
               decode-attention launches a decode step, parameter bytes and the peak memory after
               init, the step graph's device ms, the MoE FFN's share of
               a step's kernel time (an eager step under torch.profiler,
               each moe_block in a record_function range), a
               decode-shaped block's device ms against its bytes bound;
               m-serve-twin: the eager engine against the replayed one
               at 4 layers, as e-graph; m-serve-paged: at 4 layers, 8
               requests extending a 250-token prompt through a page
               pool and through contiguous caches, both with prefix
               reuse and replayed: tokens and hits identical
  (n) t5-large + AltUp K=2 (24 + 24 layers, d 1024, 16 heads of 64, f32,
      relative position bias, no RoPE), the encoder-decoder family,
      served by Engine.generate(encoder_frames=) through the AltUp and
      decode-attention kernels (cross-attention stays dense, as in the
      reference; decode reads no relative bias, as the reference's
      decode does not); the kernels at its shapes are timed in phase c
      (c-altup / c-ragged cases n-*, w-*):
      n-parity f32, TF32 off, full width and depth: 4 rows of 512 encoder
               tokens, an 8-token prompt fed token by token, then 16
               greedy steps through decode_step, the kernel path against
               the dense path over one encode's cross caches: logits
               within 1e-3, tokens identical, 24 AltUp and 24
               decode-attention launches a step; then from int8 and fp8
               self caches (cross caches float), as d-quant
      n-serve  Engine.generate on 8 rows of 512 encoder tokens,
               16-token prompts, 64 new tokens, f32, eager (generate
               captures no CUDA graph): ms a step (each decode_step
               synchronized), decode tok/s, the encode's ms, self and
               cross cache bytes, peak memory; launches == 24 x steps
               for each kernel
      n-seq    t5-large with a Sequence-AltUp encoder (stride 4) in each
               mode (altup, stride_skip, avgpool) and the unreduced
               baseline: the encoder output on the card against the CPU
               at 4 encoder layers (1e-4 of the max), each mode's encoder
               device ms at full depth (B=8 x 512) beside the
               baseline's, then greedy generate of the altup mode, kernel
               path against dense path: tokens identical, 0 AltUp and 24
               decode-attention launches a step
      n-grad   loss_fn gradients at full width, 2 + 2 layers, on a
               span_corruption batch, card against CPU: each leaf within
               1e-4 of its max (the bias tables named), and a
               Sequence-AltUp case whose scalars get gradients
      n-train  Trainer at full width and depth, f32, span_corruption
               (8 rows, 512 encoder and 128 decoder tokens, Adafactor,
               lr 0.1), 10 steps: ms a step, tokens/s (encoder and decoder), MFU
               over the f32 peak (encoder parameters per encoder token,
               decoder parameters per decoder token), peak memory, a
               falling loss (second half's mean below the first's)
  (w) whisper-tiny + AltUp K=2 (4 + 4 layers, d 384, 6 heads of 64),
      1500 frames of seeded f32 noise for the stubbed audio frontend:
      w-parity f32, as n-parity (float self caches; 4 + 4 launches a step)
      w-serve  bf16, Engine.generate on 8 rows, 4-token prompts, 64 new
               tokens, as n-serve
  (l) deepseek-v3-671b + AltUp K=2 (d 7168, 128 heads, q_lora_rank
      1536, kv_lora_rank 512, head dims 128 / 64 / 128, 3 dense layers of
      d_ff 18432 then MoE layers of 256 routed experts top 8 and 1 shared
      expert, vocab 129280), every width as published, depth (and, where
      a line's `reduced` says so, routed experts) cut to fit the card; MLA
      attention runs no kernel, as in the reference (the latent slice is
      dequantized and attended densely), the AltUp kernel every layer:
      l-parity f32, TF32 off, 4 layers, 32 experts: (d)'s parity, float,
               int8 and fp8 latents (1e-3, tokens identical, exactly 4
               AltUp launches a step on each fused side and no other
               launch); then a donor and two requests sharing 130 of its
               rows through the contiguous and the paged engine, both
               replayed: tokens identical, logprobs within 1e-5
      l-serve-twin  (e)'s traffic at 4 layers (all 256 experts), eager
               against replayed, as e-graph
      l-serve-graph the same at 5 layers (3 dense + 2 MoE, 51.4 GB of
               bf16 weights), replayed: (e)'s numbers, one AltUp launch
               a layer a step and no attention kernel, the step graph's
               device ms, the MoE FFN's and MLA attention's shares of an
               eager step's kernel time (record_function ranges), the
               weight and expert bytes a decode step reads and their
               bounds, peak memory at init and in the run
      l-serve-paged 4 layers, int8 latents, m-serve-paged's traffic
               through Engine(paged=True), eager against replayed:
               tokens, hits and pool counters identical, pages aliased
      l-grad   2 layers (1 dense, 1 MoE of 16 experts), f32: loss_fn and
               every leaf's gradient on the card against the CPU, 1e-4 of
               each leaf's max, aux within 1e-6, no kernel launched
      l-train  Trainer at 2 layers (32 experts), bf16, 12 steps of 8 x
               512 tokens at lr 0.02: a falling loss, tokens/s, MFU,
               peak memory
  (z) zamba2-1.2b + AltUp K=2 (38 Mamba-2 layers, d 2048, state 64,
      conv 4, 64 heads of 64; one shared attention + FFN block, 32 heads
      of 64, d_ff 8192, after every 6 mamba layers: 13 segments, 44
      AltUp layers), the Mamba-2 block in plain torch (as in the
      reference), B1 every layer, B2 / B4 in the shared invocations:
      z-parity full width and depth, f32, TF32 off, 2 prompts of 24
               tokens fed one a step (the engine's chunk-1 prefill of a
               recurrent plan), then 8 greedy steps: the kernel path
               and the paged kernel path against the dense path (1e-3,
               tokens identical), exactly 44 AltUp and 6 decode-attention
               launches a step on each kernel side; float (the prefill's
               last logits also against the dense forward), int8 and fp8
               (the dense side reads the kernel side's caches, as d-quant)
      z-serve  (i)'s traffic (a 64-token donor, then 7 requests of 32-256
               tokens, one extending the donor's prompt by 32; 32 new)
               through Engine(n_slots=8, max_len=512): an eager twin at
               6 mamba layers against a replayed run at the same depth
               (contiguous float, paged int8), then replayed, contiguous
               float and int8 and paged float / int8 at 12 mamba layers
               (cut for the run's time): median and
               p80 step ms, decode tok/s, the recurrent hit (contiguous:
               one, its tokens a cold engine's; paged: none), the step
               graph's device ms against its bytes bound (weights and
               the f32 ssm state read and written; and the whole step's,
               with the KV rows the replay reads by the roofline's
               decode_kv_bytes), the mamba layers' and shared
               invocations' shares of an eager step's kernel time; paged
               tokens equal to contiguous ones
      z-grad   12 mamba layers (2 shared invocations), f32: loss_fn and
               every leaf's gradient on the card against the CPU, 1e-4 of
               each leaf's max, the tied block's named; no kernel
      z-train  Trainer at 12 mamba layers, bf16, AdamW: a falling loss,
               ms a step, tokens/s, MFU, peak memory
  (v) llava-next-mistral-7b + AltUp K=2 (32 layers, d 4096, 32 / 8 heads
      of 128, 576 stub image tokens of d 4096 projected by img_proj):
      v-serve  (e)'s traffic, text-only (as the reference serves it), full
               width and depth, replayed: (e)'s gates and numbers, the
               step graph's device ms against its weight bytes and
               against the whole step's (weights + KV rows read)
      v-train  Trainer at 4 layers, bf16, AdamW, batches of 512 tokens
               after 576 image embeddings (the pipeline's): a falling
               loss, ms a step, MFU over text and image positions
  granite      granite-3-2b + AltUp K=2 (40 layers, d 2048, 32 / 8 heads
               of 64, vocabulary 49155 padded to 49408), (e)'s traffic
               replayed at full width and depth, as v-serve
  (x) examples the three examples/*_torch.py through their main() on the
               card: quickstart and serve_altup as written,
               train_altup_lm at its ~100M model for 15 steps, a
               checkpoint, and a resume to 30: seconds and losses; gates:
               finite losses, serve_altup's paged tokens equal to its
               contiguous ones, no KV-cache bytes added by K=4
  (t) tensor parallelism: Engine(mesh=) over a "model" axis
      t-serve-a  one NCCL rank (a process group of one, make_mesh((1,),
               ("model",))): Qwen3-0.6B + AltUp K=2 at full width and
               depth served from replayed graphs through Engine(mesh=)
               beside the un-meshed Engine, contiguous and paged; gates:
               tokens, step counts and kernel launches identical, graphs
               captured with their collectives; both engines' most
               replayed step graph, device ms (the collectives' cost at
               N = 1)
      t-serve-b  two spawned ranks sharing the card over gloo (NCCL
               refuses two ranks on one device), eager (gloo's
               collectives cannot be captured): Qwen3-0.6B + AltUp K=2 at
               4 layers (8 q / 4 kv heads a rank; contiguous and paged)
               and qwen2-moe-a2.7b + AltUp K=2 at 2 layers (32 experts
               a rank), full width; gates: every rank's tokens and kernel
               launches equal to a one-rank run's at the same depth,
               captures 0, logits within T_B_LOGIT_TOL of one rank's; a
               collective that fails on CUDA tensors fails the run, its
               line printed with which and why. Phase c's c-ragged /
               c-paged cases t-* time the decode attention at the ranks'
               local heads
      t-serve-c  the recurrent and encoder-decoder families and slots
               over "data". (a) one NCCL rank, replayed: rwkv6-1.6b + K=2
               at 4 layers and zamba2-1.2b + K=2 at 6 mamba layers
               (contiguous and paged), full width, through Engine(mesh=)
               beside the un-meshed Engine on t-serve-b's traffic; gates:
               tokens, step counts and launches (B1, B2 / B4, B6)
               identical, graphs captured; both replays' device ms. (b)
               two gloo ranks sharing the card, eager, f32: RWKV-6,
               zamba2 and t5-large + K=2 (2 + 2 layers,
               generate(encoder_frames=)) at model = 2, Qwen3-0.6B + K=2
               (4 layers) at data = 2 (two slots a rank); gates: tokens
               and launches equal to
               a one-rank run's, captures 0, the model-axis logits within
               T_B_LOGIT_TOL; then RWKV-6 and zamba2 again in bf16, their
               logits gated on T_B_LOGIT_TOL, their tokens compared (the
               one-rank logits' top-2 margin printed where they part).
               Phase c's cases tc-* hold the WKV kernel at 16 and 8 heads
               (N = 2, 4) and the decode attention at t5-large's 8 local
               heads against their plain versions
      t-serve-d  the rest of A11's serving over data = 2, two gloo ranks
               sharing the card, eager, Qwen3-0.6B + K=2 at 4 layers,
               bf16 and int8: (a) paged caches, (g)'s shared system
               prompt, 6 requests through 4 slots: tokens and launches
               equal to one rank's, both ranks' pools bitwise equal
               (each step's written rows all-gathered), pages aliased;
               (b) the long-context layout, one slot of 8192 rows and a
               5000-token prompt whose rows both ranks hold: tokens equal
               to one rank's, the split pass and the merge over gathered
               spans launched once a layer a decode step (B2 never),
               each rank's caches half of one rank's, logits within
               T_B_LOGIT_TOL; the rows and bytes each step gathers.
               Phase c's c-split-merge cases td-* hold the split pass on
               each rank's rows + the merge over the gathered spans
               bitwise against the unsharded B2 call (32768 rows over 2
               and 4 ranks and an uneven split; bf16, int8, fp8) and
               time them against it
  t-train      training over a mesh (Trainer(mesh=), loss_fn(mesh=)): (a)
               one NCCL rank, k-train's model, bitwise the un-meshed
               Trainer; (b) two gloo ranks sharing the card over "model",
               f32 and bf16, against one rank's gradients, steps and a
               restored checkpoint; (c) Qwen3 at 4 layers over data 2 x
               model 1 (b's ranks) and data 2 x model 2 (four ranks):
               gradients summed over the data ranks and losses against
               the whole batch's, replicated leaves' digests equal on
               every rank; (d) qwen2-moe at published widths and 2
               layers over data 2 x model 2 with its capacity drops:
               the expert-parallel block and a Trainer step against the
               routing emulated on one rank, the dropped assignments,
               the all-to-alls' calls and bytes
  (f) profile  (--profile only) device busy share of pure decode steps,
               of the (e) engine, (f-profile-quant) of the e-quant
               engine, (f-profile-paged) of the (g) engine,
               (f-profile-paged-quant) of the g-quant engine and
               (f-profile-rwkv) of the (i) engine, each eager and (the
               "-graph" lines) replayed, the port's kernel records held
               against the launch counters of the same steps; replayed
               engines also give the gap between the kernels of a replay
               (back-to-back replays by CUDA events against their kernels'
               device time); and, in c-flash, a fit of a bf16 flash
               block's fixed cost beside its per-tile cost (block-cost)

Every phase prints one line; any failure raises and exits non-zero. The
second-to-last line is the per-kernel JSON record; the last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
The k phases write their checkpoints to a temporary directory under the
git-ignored build/, removed when they end. It exits 1 without printing a
result when no CUDA device is present, and fails when the repository's
`src/repro_torch` is not beside it.
"""
from __future__ import annotations

import concurrent.futures
import contextlib
import functools
import importlib.util
import io
import json
import math
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
PKG = ROOT / "src" / "repro_torch"
DEV = "cuda"


def served_config(**kw):
    """Qwen3-0.6B wrapped with AltUp K=2 (recycled: vocab > 100k)."""
    from repro_torch.configs import get_config
    return get_config("qwen3-0.6b", altup_k=2).replace(**kw)


def rwkv_config(**kw):
    """RWKV-6 1.6B wrapped with AltUp K=2 (not recycled: vocab 65536)."""
    from repro_torch.configs import get_config
    return get_config("rwkv6-1.6b", altup_k=2).replace(**kw)


F32_TOL = dict(atol=2e-5, rtol=2e-5)     # kernel vs plain, f32 in and out
# WKV kernel vs plain, f32: sums over Dh in another order, FMA-contracted,
# carried through up to 512 recurrent steps, on values of order 10
WKV_F32_TOL = dict(atol=1e-4, rtol=1e-4)
BF16_TOL = dict(atol=2e-2, rtol=2e-2)    # outputs rounded to bf16 (1 ulp)
PARITY_TOL = dict(atol=1e-3, rtol=1e-3)  # 28-layer f32 logits, two paths
# device_ms filter of the ragged decode attention: a call launches the
# split kernel (ragged_decode_split_kernel or
# paged_ragged_decode_split_kernel) and ragged_decode_merge_kernel, and
# this substring of the three names sums both kernels of the call (two
# matching launches per call, which device_ms checks)
RAGGED_KERNELS = "ragged_decode_"


T_START = time.perf_counter()


def line(tag, **vals):
    """One phase's JSON line, with the script's elapsed seconds."""
    vals["elapsed_s"] = time.perf_counter() - T_START
    print(f"[{tag}] " + json.dumps(vals), flush=True)


def time_ms(torch, fn, iters=100, warmup=10):
    """Mean device time of fn() in ms, by CUDA events over `iters` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def hardware(dtype_name):
    """The card's roofline model (the port's config.H100_SXM: NVIDIA's H100
    SXM data sheet, dense rates, 700 W) at the peak rate of the type the
    operations run in: bf16 tensor cores, or f32."""
    from repro_torch.config import H100_SXM, H100_SXM_F32
    return {"float32": H100_SXM_F32, "bfloat16": H100_SXM}[dtype_name]


def bound_ms(nbytes, nops, dtype_name):
    """Least time for the work, through the port's roofline_terms: max of
    bytes over the HBM rate and operations over the peak rate of their
    type. Returns (ms, "bytes"|"operations")."""
    from repro_torch.roofline.analysis import roofline_terms
    t = roofline_terms(nops, nbytes, 0.0, n_chips=1,
                       hw=hardware(dtype_name))
    return (1e3 * t["step_s_lower_bound"],
            "bytes" if t["memory_s"] >= t["compute_s"] else "operations")


def max_err(torch, a, b):
    return float((a.float() - b.float()).abs().max())


def perturb_rwkv(torch, params, cfg, seed):
    """Seeded values for the RWKV-6 leaves the reference starts at zero
    (ts_b, w_b, u) and a spread of decay bases, then AltUp p/g. Scales
    follow the fan-in so that w_base + lora(x) stays below ~1.5, where
    the reference's chunked form keeps 1/A inside f32 (16 steps)."""
    gen = torch.Generator(device=DEV).manual_seed(seed)
    rw = cfg.rwkv
    with torch.no_grad():
        p = params["seg0"]["rwkv"]
        for leaf, scale in (("ts_b", 1.0 / math.sqrt(rw.token_shift_lora)),
                            ("w_b", 0.4 / math.sqrt(rw.decay_lora)),
                            ("u", 0.5)):
            t = p[leaf]
            t.copy_(scale * torch.randn(t.shape, generator=gen, device=DEV))
        wb = p["w_base"]
        wb.copy_(-4.0 + 3.5 * torch.rand(wb.shape, generator=gen,
                                         device=DEV))
    perturb_altup(torch, params, seed + 1)


def perturb_altup(torch, params, seed):
    """p = I + 0.2·N(0,1), g = 1 + 0.2·N(0,1): at init (p = I, g = 1)
    predict and correct are trivial and would test nothing. Every AltUp
    segment, the encoder's (`enc/seg`) after the decoder's, the hybrid's
    shared block (its unstacked (K, K) p); then the Sequence-AltUp
    scalars (a1, a2, b) + 0.2·N(0,1) away from (1, 0, 1), where the
    layer would be stride-and-skip."""
    gen = torch.Generator(device=params["embed"].device).manual_seed(seed)
    segs = [params[n] for n in params.keys() if n.startswith("seg")]
    if "enc" in params:
        segs.append(params["enc"]["seg"])
    if "shared_blk" in params:
        segs.append(params["shared_blk"])
    with torch.no_grad():
        for seg in segs:
            if "altup_p" not in seg:
                continue
            p, g = seg["altup_p"], seg["altup_g"]
            eye = torch.eye(p.shape[-1], device=p.device)
            p.copy_(eye + 0.2 * torch.randn(p.shape, generator=gen,
                                            device=p.device))
            g.copy_(1 + 0.2 * torch.randn(g.shape, generator=gen,
                                          device=g.device))
        if "seq_altup" in params:
            for name, base in (("a1", 1.0), ("a2", 0.0), ("b", 1.0)):
                t = params["seq_altup"][name]
                t.copy_(base + 0.2 * torch.randn(t.shape, generator=gen,
                                                 device=t.device))


# ---------------------------------------------------------------------------
# (c) kernels against their plain versions
# ---------------------------------------------------------------------------

def check_altup(torch, ops, ref, dtype, T, K=2, d=1024, seed=0):
    gen = torch.Generator(device=DEV).manual_seed(seed)
    xw = torch.randn(T, K, d, generator=gen, device=DEV).to(dtype)
    xt = torch.randn(T, d, generator=gen, device=DEV).to(dtype)
    p = torch.eye(K, device=DEV) + 0.3 * torch.randn(
        K, K, generator=gen, device=DEV)
    g = 1 + 0.3 * torch.randn(K, generator=gen, device=DEV)
    sel = (torch.arange(K, device=DEV) == 1).float()

    def launch():
        return ops.altup_predict_correct(xw, xt, sel, p, g)

    def plain():
        return ref.altup_predict_correct_ref(xw, xt, sel, p, g)
    got, want = launch(), plain()
    torch.cuda.synchronize()
    tol = F32_TOL if dtype == torch.float32 else BF16_TOL
    torch.testing.assert_close(got, want, **tol)
    name = "float32" if dtype == torch.float32 else "bfloat16"
    esz = xw.element_size()
    nbytes = (2 * K + 1) * T * d * esz + (K * K + 2 * K) * 4
    nops = T * d * (2 * K * K + 4 * K + 1)
    b_ms, b_by = bound_ms(nbytes, nops, "float32")   # computed in f32
    res = {"dtype": name, "T": T, "K": K, "d": d,
            "max_abs_err": max_err(torch, got, want),
            "ms": device_ms(torch, launch, "altup_predict_correct_kernel",
                            per_call=1),
            "plain_ms": device_ms(torch, plain),
            "wrapper_ms": time_ms(torch, launch, iters=200),
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
            "bytes": nbytes, "tol": tol}
    res["bound_share"] = b_ms / res["ms"]
    return res


def stored_kv(torch, k, v, store, dtype):
    """k, v as the cache stores them: store None keeps q's dtype; "bf16"
    or "f32" stores float k/v in that type (a float storage mode other
    than the activations'); "int8" / "fp8" gives codes and f32 scales
    from the port's quant.quantize on the card. Returns (k, v, k_scale,
    v_scale)."""
    from repro_torch.kernels import quant as Q
    if store is None:
        return k, v, None, None
    if store in ("bf16", "f32"):
        t = torch.bfloat16 if store == "bf16" else torch.float32
        return k.to(t), v.to(t), None, None
    spec = Q.resolve_kv_spec(store, dtype)
    (kc, ks), (vc, vs) = Q.quantize(k, spec), Q.quantize(v, spec)
    return kc, vc, ks, vs


def kv_row_bytes(k, k_scale, Dh):
    """Bytes of one (row, kv head) of k and v, with their scales."""
    return 2 * Dh * k.element_size() + (0 if k_scale is None else 2 * 4)


def check_ragged(torch, ops, ref, dtype, lens_host, Hk=8, rep=2, Dh=128,
                 T=2048, store=None, timed=True, seed=1):
    """ops.ragged_decode_attn on CUDA tensors (the kernel) against its
    plain version; store as in stored_kv ("int8" / "fp8": the fused
    dequant, against ref.ragged_decode_quant_ref). Timed cases add device
    ms of the kernel, the plain version and the library call (SDPA on the
    masked GQA problem; for codes, which it cannot read, SDPA on the
    dequantized k/v, printed beside and no library call)."""
    import torch.nn.functional as F
    gen = torch.Generator(device=DEV).manual_seed(seed)
    B, H = len(lens_host), Hk * rep
    q = torch.randn(B, 1, H, Dh, generator=gen, device=DEV).to(dtype)
    k = torch.randn(B, T, Hk, Dh, generator=gen, device=DEV).to(dtype)
    v = torch.randn(B, T, Hk, Dh, generator=gen, device=DEV).to(dtype)
    k, v, ks, vs = stored_kv(torch, k, v, store, dtype)
    lens = torch.tensor(lens_host, dtype=torch.int32, device=DEV)
    qg = q[:, 0].reshape(B, Hk, rep, Dh)

    def launch():
        return ops.ragged_decode_attn(q, k, v, lens, ks, vs)

    def plain():
        if ks is None:
            return ref.ragged_decode_ref(qg, k, v, lens)
        return ref.ragged_decode_quant_ref(qg, k, v, ks, vs, lens)
    got, want = launch(), plain().reshape(B, 1, H, Dh)
    torch.cuda.synchronize()
    tol = F32_TOL if dtype == torch.float32 else BF16_TOL
    torch.testing.assert_close(got, want, **tol)
    for b in range(B):
        if lens_host[b] == 0 and not bool((got[b] == 0).all()):
            raise AssertionError(f"empty slot {b} is not exact zeros")
    name = "float32" if dtype == torch.float32 else "bfloat16"
    res = {"dtype": name, "store": store, "B": B, "Hk": Hk, "rep": rep,
           "Dh": Dh, "T": T, "lengths": lens_host,
           "max_abs_err": max_err(torch, got, want), "tol": tol}
    if not timed:
        return res
    esz = q.element_size()
    rows = sum(lens_host)
    nbytes = rows * Hk * kv_row_bytes(k, ks, Dh) + 2 * B * H * Dh * esz \
        + 4 * B
    nops = rows * Hk * rep * Dh * 4
    # the arithmetic of the codes' path (dequant, dots) is f32
    b_ms, b_by = bound_ms(nbytes, nops, name if ks is None else "float32")
    # library yardstick: one SDPA call on the same masked GQA problem,
    # timed here only (the port never calls it)
    kd = k if ks is None else ref.dequant_ref(k, ks, dtype)
    vd = v if vs is None else ref.dequant_ref(v, vs, dtype)
    qs = q.permute(0, 2, 1, 3)                        # (B, H, 1, Dh)
    kt, vt = (t.to(dtype).permute(0, 2, 1, 3) for t in (kd, vd))
    mask = (torch.arange(T, device=DEV)[None, :] < lens[:, None])
    mask = mask[:, None, None, :]

    def library():
        return F.scaled_dot_product_attention(qs, kt, vt, attn_mask=mask,
                                              enable_gqa=True)
    lib = library()
    live = lens > 0                  # SDPA gives NaN on an all-masked row
    lib_err = max_err(torch, lib[live].permute(0, 2, 1, 3), want[live])
    sdpa_ms = device_ms(torch, library)
    res.update({
        "ms": device_ms(torch, launch, RAGGED_KERNELS, per_call=2),
        "plain_ms": device_ms(torch, plain),
        "wrapper_ms": time_ms(torch, launch),
        "bound_ms": b_ms, "bound_by": b_by,
        # no single PyTorch call dequantizes and attends
        "library_ms": sdpa_ms if ks is None else None,
        "sdpa_on_dequantized_ms": None if ks is None else sdpa_ms,
        "library_max_abs_err_nonempty": lib_err, "bytes": nbytes})
    return res


def check_all_codes(torch, ops):
    """Every int8 code and every float8_e4m3fn code (NaN codes included)
    through the contiguous kernel's value path: one row of Dh = 256
    codes as v (k zero codes, scales 1), so that the output is that row
    as f32, held exactly (the kernel converts codes with integer
    arithmetic and paired e4m3 conversions, not one conversion per
    element; the score path shares the same conversion)."""
    res = {}
    for kind, dt in (("int8", torch.int8), ("fp8", torch.float8_e4m3fn)):
        row = torch.arange(256, dtype=torch.uint8, device=DEV).view(dt)
        v = row.reshape(1, 1, 1, 256)
        k = torch.zeros(1, 1, 1, 256, dtype=torch.uint8,
                        device=DEV).view(dt)
        ones = torch.ones(1, 1, 1, device=DEV)
        got = ops.ragged_decode_attn(
            torch.zeros(1, 1, 1, 256, device=DEV), k, v,
            torch.ones(1, dtype=torch.int32, device=DEV), ones, ones)
        torch.testing.assert_close(got.reshape(256), row.float(), atol=0,
                                   rtol=0, equal_nan=True)
        res[kind] = "exact"
    return res


def pages_for(rows, page):
    return -(-rows // page)


def paged_table(torch, gen, reserve, n_shared, n_pages, npg):
    """(B, npg) int32 block table over a seeded random permutation of the
    pool's pages, laid out as PagePool lays it out: slot b holds
    reserve[b] pages, the first n_shared of them the same pages for every
    slot (an aliased prompt prefix), the rest its own; an idle slot
    (reserve 0) and the entries past a slot's reservation are 0."""
    perm = torch.randperm(n_pages, generator=gen).tolist()
    if n_shared + sum(max(r - n_shared, 0) for r in reserve) > n_pages:
        raise ValueError("the pool cannot hold these reservations")
    bt = torch.zeros(len(reserve), npg, dtype=torch.int32)
    nxt = n_shared
    for b, r in enumerate(reserve):
        if r:
            own = perm[nxt:nxt + r - n_shared]
            nxt += r - n_shared
            bt[b, :r] = torch.tensor(perm[:n_shared] + own)
    return bt.to(DEV)


def check_paged(torch, ops, ref, dtype, lens_host, reserve, n_shared=0,
                n_pages=1024, Hk=8, rep=2, Dh=128, T=2048, t_max=2048,
                page=16, store=None, timed=True, seed=4):
    """The paged kernel over a random pool of n_pages pages plus the sink,
    through the block table of paged_table (T // page entries per slot)
    with the read bound t_max, against its plain version and, bitwise,
    against the contiguous kernel on the same rows gathered into
    contiguous caches; store as in stored_kv (codes with (R, Hk) pool
    scales)."""
    import torch.nn.functional as F
    gen = torch.Generator(device=DEV).manual_seed(seed)
    B, H, npg = len(lens_host), Hk * rep, T // page
    R = (n_pages + 1) * page
    q = torch.randn(B, 1, H, Dh, generator=gen, device=DEV).to(dtype)
    kp = torch.randn(R, Hk, Dh, generator=gen, device=DEV).to(dtype)
    vp = torch.randn(R, Hk, Dh, generator=gen, device=DEV).to(dtype)
    kp, vp, ksp, vsp = stored_kv(torch, kp, vp, store, dtype)
    lens = torch.tensor(lens_host, dtype=torch.int32, device=DEV)
    bt = paged_table(torch, torch.Generator().manual_seed(seed), reserve,
                     n_shared, n_pages, npg)
    grows = (bt.long()[:, :, None] * page
             + torch.arange(page, device=DEV)).reshape(B, T)

    def gathered(pool):
        """The contiguous read slice of the same rows, (B, t_max, ...),
        1-byte codes through their uint8 view."""
        if pool is None:
            return None
        raw = pool.view(torch.uint8) if pool.element_size() == 1 else pool
        return raw[grows[:, :t_max]].view(pool.dtype)
    k, v, ks, vs = (gathered(t) for t in (kp, vp, ksp, vsp))
    qg = q[:, 0].reshape(B, Hk, rep, Dh)

    def launch():
        return ops.paged_ragged_decode_attn(q, kp, vp, lens, bt, ksp, vsp,
                                            page=page, t_max=t_max)

    def plain():
        return ref.paged_ragged_decode_ref(qg, kp, vp, lens, bt, ksp, vsp,
                                           page=page, t_max=t_max)
    got, want = launch(), plain().reshape(B, 1, H, Dh)
    contiguous = ops.ragged_decode_attn(q, k, v, lens, ks, vs)
    torch.cuda.synchronize()
    tol = F32_TOL if dtype == torch.float32 else BF16_TOL
    torch.testing.assert_close(got, want, **tol)
    for b in range(B):
        if lens_host[b] == 0 and not bool((got[b] == 0).all()):
            raise AssertionError(f"empty slot {b} is not exact zeros")
    if not torch.equal(got, contiguous):
        raise AssertionError(
            f"paged kernel differs from the contiguous kernel on the same "
            f"rows: max abs {max_err(torch, got, contiguous)}")
    name = "float32" if dtype == torch.float32 else "bfloat16"
    res = {"dtype": name, "store": store, "B": B, "Hk": Hk, "rep": rep,
           "Dh": Dh, "page": page, "pool_pages": n_pages,
           "table_pages": npg, "t_max": t_max,
           "lengths": lens_host, "shared_pages": n_shared,
           "max_abs_err": max_err(torch, got, want),
           "bitwise_equal_contiguous": True, "tol": tol}
    if not timed:
        return res
    esz = q.element_size()
    # bytes: each pool row that some slot reads, once (an aliased page is
    # one input however many slots read it), q, out, lengths, table entries
    rows = torch.cat([grows[b, :n] for b, n in enumerate(lens_host)])
    distinct = int(rows.unique().numel())
    table = sum(pages_for(n, page) for n in lens_host)
    nbytes = (distinct * Hk * kv_row_bytes(kp, ksp, Dh)
              + 2 * B * H * Dh * esz + 4 * B + 4 * table)
    nops = sum(lens_host) * Hk * rep * Dh * 4
    b_ms, b_by = bound_ms(nbytes, nops, name if ksp is None else "float32")
    # no single PyTorch call reads through a block table; SDPA on rows
    # gathered (and dequantized) beforehand is printed beside it, labelled
    # as such
    kd = k if ks is None else ref.dequant_ref(k, ks, dtype)
    vd = v if vs is None else ref.dequant_ref(v, vs, dtype)
    qs = q.permute(0, 2, 1, 3)
    kt, vt = (t.to(dtype).permute(0, 2, 1, 3) for t in (kd, vd))
    mask = (torch.arange(t_max, device=DEV)[None, :] < lens[:, None])
    mask = mask[:, None, None, :]

    def sdpa_gathered():
        return F.scaled_dot_product_attention(qs, kt, vt, attn_mask=mask,
                                              enable_gqa=True)
    res.update({
        "distinct_rows_read": distinct,
        "ms": device_ms(torch, launch, RAGGED_KERNELS, per_call=2),
        "plain_ms": device_ms(torch, plain),
        "wrapper_ms": time_ms(torch, launch),
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
        "sdpa_on_pregathered_rows_ms": device_ms(torch, sdpa_gathered),
        "bytes": nbytes})
    return res


def ragged_stores(torch, dtype):
    """The four k/v storages under queries of `dtype`: q's own float type,
    the other float type, int8 and fp8 codes."""
    return (None, "f32" if dtype == torch.bfloat16 else "bf16", "int8",
            "fp8")


def check_shapes(torch, ops, ref):
    """Both entry points at the head shapes the split kernels were widened
    for: gemma3-4b's (Dh 320, rep 2, Hk 4) and gemma3-12b's (Dh 240, rep
    2, Hk 8) widths, an odd width whose rows take the scalar tail (Dh 85,
    rep 1), and the widest grouping (rep 8, Dh 128); 8 slots with lengths
    at the span edges, T = 1024, four storages, bf16 and f32 queries,
    paged bitwise equal to contiguous. The Dh 320 case is timed in bf16
    (bf16 k/v). Yields (tag, case, result)."""
    from repro_torch.kernels.ragged_decode_attention import SPAN
    lens = [0, 1, SPAN - 1, SPAN, SPAN + 1, 517, 1000, 1024]
    for case, kw in (("dh320", dict(Dh=320, rep=2, Hk=4)),
                     ("dh240", dict(Dh=240, rep=2, Hk=8)),
                     ("dh85", dict(Dh=85, rep=1, Hk=8)),
                     ("rep8", dict(Dh=128, rep=8, Hk=4))):
        for dtype in (torch.bfloat16, torch.float32):
            for store in ragged_stores(torch, dtype):
                timed = (case == "dh320" and dtype == torch.bfloat16
                         and store is None)
                yield "c-ragged-shapes", case, check_ragged(
                    torch, ops, ref, dtype, lens, T=1024, store=store,
                    timed=timed, **kw)
                yield "c-paged-shapes", case, check_paged(
                    torch, ops, ref, dtype, lens, reserve=[64] * 8,
                    n_pages=520, T=1024, t_max=1024, store=store,
                    timed=timed, **kw)


def check_long_slot(torch, ops, ref):
    """The paged entry point over one slot of 40960 rows and seven short
    ones, page 16: 2560 table pages, past the 2048 that the kernel before
    the split staged per slot. Four storages, bf16 and f32 queries,
    bitwise equal to the contiguous kernel on the same 40960-row caches;
    timed in bf16 (bf16 k/v). Yields results."""
    lens = [40960, 1, 100, 300, 17, 500, 129, 64]
    reserve = [pages_for(n, 16) for n in lens]
    for dtype in (torch.bfloat16, torch.float32):
        for store in ragged_stores(torch, dtype):
            yield check_paged(
                torch, ops, ref, dtype, lens, reserve=reserve,
                n_pages=sum(reserve) + 8, T=40960, t_max=40960, store=store,
                timed=dtype == torch.bfloat16 and store is None)
            torch.cuda.empty_cache()


def check_wkv(torch, ops, ref, dtype, B, H, Dh, S, state, seed=7):
    """The WKV kernel through ops.rwkv6_wkv on (B, S, H, Dh) inputs, u
    (H, Dh) and a random state updated in place (state="random") or none
    (state=None), against its plain version on the same rows. Inputs:
    r, k, v ~ N(0, 1), w = exp(-exp(N(0, 1) - 1)), state ~ N(0, 1)."""
    gen = torch.Generator(device=DEV).manual_seed(seed)

    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device=DEV)
    r, k, v = (rnd(B, S, H, Dh).to(dtype) for _ in range(3))
    w = torch.exp(-torch.exp(rnd(B, S, H, Dh) - 1)).to(dtype)
    u = rnd(H, Dh).to(dtype)
    s0 = rnd(B, H, Dh, Dh) if state == "random" else None

    def fold(t):
        return t.transpose(1, 2).reshape(B * H, S, Dh)
    want_o, want_s = ref.rwkv6_wkv_ref(fold(r), fold(k), fold(v), fold(w),
                                       u, None if s0 is None
                                       else s0.reshape(B * H, Dh, Dh))
    want_o = want_o.reshape(B, H, S, Dh).transpose(1, 2)
    st = None if s0 is None else s0.clone()
    got_o, got_s = ops.rwkv6_wkv(r, k, v, w, u, st)
    torch.cuda.synchronize()
    if st is not None and got_s is not st:
        raise AssertionError("the WKV kernel did not update the state in "
                             "place")
    tol = WKV_F32_TOL if dtype == torch.float32 else BF16_TOL
    torch.testing.assert_close(got_o, want_o, **tol)
    torch.testing.assert_close(got_s, want_s.reshape(B, H, Dh, Dh),
                               **WKV_F32_TOL)
    name = "float32" if dtype == torch.float32 else "bfloat16"
    esz = r.element_size()
    BH = B * H
    # each input once (the state if given), out and the final state once
    nbytes = (5 * BH * S * Dh * esz + H * Dh * esz
              + (2 if s0 is not None else 1) * BH * Dh * Dh * 4)
    # per step and head: out (Σᵢ rᵢ Sᵢⱼ, 2 per element) and the state
    # update (wᵢ Sᵢⱼ + kᵢ vⱼ, 3 per element), all f32
    nops = 5 * BH * S * Dh * Dh
    b_ms, b_by = bound_ms(nbytes, nops, "float32")

    def launch():
        return ops.rwkv6_wkv(r, k, v, w, u, st)

    def plain():
        return ref.rwkv6_wkv_ref(fold(r), fold(k), fold(v), fold(w), u,
                                 None if s0 is None
                                 else s0.reshape(BH, Dh, Dh))
    return {"dtype": name, "B": B, "H": H, "Dh": Dh, "S": S,
            "state": state or "none", "in_place": st is not None,
            "max_abs_err": max_err(torch, got_o, want_o),
            "state_max_abs_err": max_err(torch, got_s,
                                         want_s.reshape(B, H, Dh, Dh)),
            "ms": device_ms(torch, launch, "rwkv6_wkv_kernel", per_call=1),
            "plain_ms": device_ms(torch, plain, iters=5),
            "wrapper_ms": time_ms(torch, launch),
            "bound_ms": b_ms, "bound_by": b_by, "library": "none",
            "library_ms": None, "bytes": nbytes, "flop": nops, "tol": tol}


def check_wkv_zero_state(torch, ops, dtype, B=8, H=32, Dh=64, seed=8):
    """S = 1 from an all-zero state must equal the no-state case bitwise,
    output and final state."""
    gen = torch.Generator(device=DEV).manual_seed(seed)
    r, k, v, w = (torch.rand(B, 1, H, Dh, generator=gen, device=DEV)
                  .to(dtype) for _ in range(4))
    u = torch.randn(H, Dh, generator=gen, device=DEV).to(dtype)
    o_none, s_none = ops.rwkv6_wkv(r, k, v, w, u)
    zero = torch.zeros(B, H, Dh, Dh, device=DEV)
    o_zero, s_zero = ops.rwkv6_wkv(r, k, v, w, u, zero)
    torch.cuda.synchronize()
    if not (torch.equal(o_none, o_zero) and torch.equal(s_none, s_zero)):
        raise AssertionError(
            f"zero state differs from no state: out "
            f"{max_err(torch, o_none, o_zero)}, state "
            f"{max_err(torch, s_none, s_zero)}")
    return {"dtype": "float32" if dtype == torch.float32 else "bfloat16",
            "B": B, "H": H, "Dh": Dh, "S": 1, "bitwise_equal": True}


# ---------------------------------------------------------------------------
# (c-flash) the flash-attention kernel, reached through ops.mha_flash and
# ops.mha_flash_paged (no served path calls it, as in the reference)
# ---------------------------------------------------------------------------

def flash_pairs(S, T, causal, window):
    """Visible (query, key) pairs of one head: the work the kernel does
    once fully masked tiles are skipped (and the partly masked ones are
    not counted)."""
    total = 0
    for i in range(S):
        hi = min(T - 1, i) if causal else T - 1
        lo = max(0, i - window + 1) if window > 0 else 0
        total += max(0, hi - lo + 1)
    return total


def flash_bound(torch, q, k, k_scale, causal, window):
    """Bytes: q and out once, the kv rows some query sees once (rows past
    S are never visible under a causal mask), scales once. Operations:
    4·dh per visible pair, at the peak rate of the type the products
    run in (bf16 tensor cores for bf16 q, f32 for f32 q)."""
    B, S, H, dh = q.shape
    T, Hk = k.shape[1], k.shape[2]
    rows = min(T, S) if causal else T
    nbytes = (2 * q.numel() * q.element_size()
              + 2 * B * rows * Hk * dh * k.element_size()
              + (2 * B * rows * Hk * 4 if k_scale is not None else 0))
    nops = 4 * dh * B * H * flash_pairs(S, T, causal, window)
    name = "float32" if q.dtype == torch.float32 else "bfloat16"
    return nbytes, nops, bound_ms(nbytes, nops, name)


def flash_kernel_name(torch, dtype):
    """The profiler name of the flash kernel a query dtype runs: one launch
    a call, so device_ms counts exactly one per call."""
    return "flash_f32_kernel" if dtype == torch.float32 else \
        "flash_wgmma_kernel"


def flash_profile(torch, launch, dtype, timed, producer=None):
    """The flash kernel's device ms per call of launch() (timed only) and,
    for bf16 q, the producer it ran (TmaProducer or CpAsyncProducer, read
    from the profiled kernel name; `producer`, if given, must be it), from
    one profile that counts exactly one flash kernel a call."""
    if not timed and dtype == torch.float32:
        return {}
    ms, keys = profiled(torch, launch, flash_kernel_name(torch, dtype),
                        iters=50 if timed else 5, per_call=1)
    res = {"ms": ms} if timed else {}
    if dtype == torch.bfloat16:
        names = {p for k in keys for p in ("TmaProducer", "CpAsyncProducer")
                 if p in k}
        if len(names) != 1 or producer not in (None, *names):
            raise AssertionError(f"flash producers {names} in {keys}, want "
                                 f"{producer or 'one'}")
        res["producer"] = names.pop()
    return res


def flash_qkv(torch, B, S, T, H, Hk, dh, dtype, seed):
    gen = torch.Generator(device=DEV).manual_seed(seed)
    q = torch.randn(B, S, H, dh, generator=gen, device=DEV).to(dtype)
    k = torch.randn(B, T, Hk, dh, generator=gen, device=DEV).to(dtype)
    v = torch.randn(B, T, Hk, dh, generator=gen, device=DEV).to(dtype)
    return q, k, v


def window_mask(torch, S, T, causal, window):
    """(S, T) bool mask of visible keys, for SDPA's attn_mask."""
    i = torch.arange(S, device=DEV)[:, None]
    j = torch.arange(T, device=DEV)[None, :]
    m = torch.ones(S, T, dtype=torch.bool, device=DEV)
    if causal:
        m &= i >= j
    if window > 0:
        m &= i - j < window
    return m


def counted_call(torch, ops, launch, name, counted):
    """launch() once, synchronised. counted: every launch count is set to
    0 just before and read just after, and `name` must show exactly this
    one launch; returns (output, launches or None)."""
    if counted:
        ops.reset_launch_counts()
    out = launch()
    torch.cuda.synchronize()
    if not counted:
        return out, None
    counts = ops.launch_counts()
    if counts[name] != 1 or sum(counts.values()) != 1:
        raise AssertionError(f"launch counts {counts}: want one {name}")
    return out, counts[name]


def check_flash(torch, ops, ref, dtype, B, S, T, H, Hk, dh, causal=True,
                window=0, quant=None, timed=True, counted=False, seed=20,
                producer=None):
    """ops.mha_flash on a CUDA tensor (the kernel) against ref.mha_ref on
    the same inputs; quant="int8"|"fp8" gives k/v as codes and scales from
    the port's quant.quantize on the card. Timed cases add device ms per
    call of the kernel, the plain version and SDPA (enable_gqa; an
    explicit mask for a window; on the dequantized k/v for codes, which
    SDPA cannot read), the wrapper's ms and the bound. counted: the
    checked call is the slice's path, run with every launch count set to
    0 just before and read just after. bf16 cases report the producer the
    kernel ran (`producer`, if given, must be it)."""
    import torch.nn.functional as F
    from repro_torch.kernels import quant as Q
    q, k, v = flash_qkv(torch, B, S, T, H, Hk, dh, dtype, seed)
    ks = vs = None
    if quant is not None:
        spec = Q.resolve_kv_spec(quant, dtype)
        k, ks = Q.quantize(k, spec)
        v, vs = Q.quantize(v, spec)
    kw = dict(causal=causal, window=window)
    # block_q / block_k only validate the call: S and T pass as one block
    blocks = dict(block_q=S, block_k=T)

    def launch():
        return ops.mha_flash(q, k, v, ks, vs, **blocks, **kw)

    def plain():
        return ref.mha_ref(q, k, v, ks, vs, **kw)
    got, launches = counted_call(torch, ops, launch, "flash_attention",
                                 counted)
    want = plain()
    tol = F32_TOL if dtype == torch.float32 else BF16_TOL
    torch.testing.assert_close(got, want, **tol)
    res = {"dtype": "float32" if dtype == torch.float32 else "bfloat16",
           "B": B, "S": S, "T": T, "H": H, "Hk": Hk, "dh": dh,
           "causal": causal, "window": window, "quant": quant,
           "max_abs_err": max_err(torch, got, want), "tol": tol,
           "launches": launches}
    if not timed:
        return {**res,
                **flash_profile(torch, launch, dtype, False, producer)}
    nbytes, nops, (b_ms, b_by) = flash_bound(torch, q, k, ks, causal,
                                             window)
    kd = k if ks is None else ref.dequant_ref(k, ks, dtype)
    vd = v if vs is None else ref.dequant_ref(v, vs, dtype)
    qs, kt, vt = (t.transpose(1, 2) for t in (q, kd, vd))
    mask = None
    if window > 0:
        mask = window_mask(torch, S, T, causal, window)

    def library():
        return F.scaled_dot_product_attention(
            qs, kt, vt, attn_mask=mask, is_causal=causal and mask is None,
            enable_gqa=True)
    lib = library().transpose(1, 2)
    sdpa_ms = device_ms(torch, library)
    res.update({
        **flash_profile(torch, launch, dtype, True, producer),
        "plain_ms": device_ms(torch, plain, iters=10),
        "wrapper_ms": time_ms(torch, launch, iters=20),
        "bound_ms": b_ms, "bound_by": b_by,
        # SDPA reads no codes: on codes it is timed on the dequantized k/v
        # and is no library call of the same function
        "library_ms": sdpa_ms if quant is None else None,
        "sdpa_on_dequantized_ms": sdpa_ms if quant is not None else None,
        "library_max_abs_err": max_err(torch, lib, want),
        "bytes": nbytes, "flop": nops})
    return res


# c-flash's timed cases: qwen3-0.6b's attention at full width (16 q / 8 kv
# heads of 128) as a causal prefill, non-causal, with T > S and with int8
# and fp8 codes; gemma3-4b's local layer at full width (8 q / 4 kv heads
# of 320, window 1024), bf16 only
FLASH_CASES = (
    ("prefill", dict(B=4, S=2048, T=2048, H=16, Hk=8, dh=128)),
    ("non-causal", dict(B=4, S=512, T=512, H=16, Hk=8, dh=128,
                        causal=False)),
    ("t-gt-s", dict(B=4, S=512, T=2048, H=16, Hk=8, dh=128)),
    ("prefill-int8", dict(B=4, S=2048, T=2048, H=16, Hk=8, dh=128,
                          quant="int8")),
    ("prefill-fp8", dict(B=4, S=2048, T=2048, H=16, Hk=8, dh=128,
                         quant="fp8")),
    ("gemma3-4b-local", dict(B=1, S=4096, T=4096, H=8, Hk=4, dh=320,
                             window=1024)),
)
# untimed shapes at the edges: every padded head width (64, 256, 320), rep
# 1, 3 (a block's 64 rows not filled) and 4, windows that cut tiles, T < S
# and T > S, a window without the causal mask (future keys visible)
FLASH_ODD = (
    ("dh8-rep1", dict(B=2, S=100, T=100, H=2, Hk=2, dh=8)),
    ("dh40-rep3-window-only", dict(B=2, S=96, T=160, H=6, Hk=2, dh=40,
                                   causal=False, window=40)),
    ("dh240-rep4-window", dict(B=1, S=192, T=256, H=8, Hk=2, dh=240,
                               window=48)),
    ("dh320-fp8-window", dict(B=1, S=256, T=256, H=8, Hk=4, dh=320,
                              window=64, quant="fp8")),
    ("dh64-int8-t-lt-s", dict(B=2, S=128, T=64, H=4, Hk=4, dh=64,
                              quant="int8")),
    # S not a multiple of the bf16 kernel's 64 positions a block (rep 2)
    ("s200-partial-q-tile", dict(B=2, S=200, T=200, H=4, Hk=2, dh=128,
                                 producer="TmaProducer")),
    # code rows of 24 / 40 bytes: no tensor map, the cp.async producer
    ("dh40-int8-cpasync", dict(B=2, S=96, T=160, H=4, Hk=2, dh=40,
                               quant="int8", producer="CpAsyncProducer")),
    ("dh24-fp8-cpasync", dict(B=1, S=130, T=130, H=2, Hk=1, dh=24,
                              quant="fp8", window=50,
                              producer="CpAsyncProducer")),
)


def flash_skip_ratio(torch, ops, dtype, B=4, S=2048, H=16, Hk=8, dh=128):
    """Causal over non-causal device ms at case 1's shape: the TPU
    design skips the tiles above the diagonal, about half of them."""
    q, k, v = flash_qkv(torch, B, S, S, H, Hk, dh, dtype, seed=21)
    name = flash_kernel_name(torch, dtype)
    ms = {c: device_ms(torch, lambda: ops.mha_flash(q, k, v, causal=c),
                       name, iters=20, per_call=1)
          for c in (True, False)}
    return {"dtype": "float32" if dtype == torch.float32 else "bfloat16",
            "causal_ms": ms[True], "non_causal_ms": ms[False],
            "causal_over_non_causal": ms[True] / ms[False],
            "visible_pair_ratio": flash_pairs(S, S, True, 0)
            / flash_pairs(S, S, False, 0)}


def flash_block_cost(torch, ops, H=16, Hk=8, dh=128):
    """What a bf16 flash block costs beyond its kv tiles: two non-causal
    calls with the same number of blocks (B=4, S=2048 and B=2, S=4096; a
    block holds 64 positions) and twice the kv tiles a block (16 and 32
    of 128 rows), fitted as ms = blocks / SMs * (tiles * tile_us +
    block_us). block_us is the fixed cost of a block (its q and first kv
    loads, the softmax of its first tile and the P V of its last, not
    overlapped, the output store, the block's start and end)."""
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    fit = []
    for B, S in ((4, 2048), (2, 4096)):
        q, k, v = flash_qkv(torch, B, S, S, H, Hk, dh, torch.bfloat16, 23)
        ms = device_ms(torch, lambda: ops.mha_flash(q, k, v, causal=False,
                                                    block_q=S, block_k=S),
                       "flash_wgmma_kernel", iters=20, per_call=1)
        blocks = S // 64 * Hk * B
        fit.append((ms, blocks / n_sm, S // 128))
    (m1, w1, t1), (m2, w2, t2) = fit
    tile_us = 1e3 * (m2 / w2 - m1 / w1) / (t2 - t1)
    block_us = 1e3 * m1 / w1 - t1 * tile_us
    return {"dtype": "bfloat16", "sms": n_sm, "ms_s2048": m1, "ms_s4096": m2,
            "blocks_per_sm": w1, "tile_us": tile_us, "block_us": block_us,
            "block_share_s2048": block_us / (t1 * tile_us + block_us)}


# (c-flash-paged): 4 sequences of 1024 rows in a pool of 512 pages of 16
# rows (phase g's page), through a permuted table with one more page per
# sequence, a tail page of garbage past the valid rows; the other pool
# pages hold garbage too
FP_B, FP_S, FP_PAGES, FP_PAGE = 4, 1024, 512, 16


def check_flash_paged(torch, ops, ref, dtype, causal=True, window=0,
                      quant=None, counted=False, H=16, Hk=8, dh=128,
                      seed=22, B=FP_B, S=FP_S, page=FP_PAGE,
                      pool_pages=FP_PAGES, timed=True, producer=None):
    """ops.mha_flash_paged on a CUDA pool (the kernel) against
    ref.paged_attention_ref, and bitwise against the contiguous kernel
    (ops.mha_flash) on the same rows gathered through the table; counted
    as in check_flash. bf16 cases report the producer the paged kernel
    ran (`producer`, if given, must be it)."""
    import torch.nn.functional as F
    from repro_torch.kernels import quant as Q
    gen = torch.Generator(device=DEV).manual_seed(seed)
    nk = S // page + 1                               # the tail page
    R = pool_pages * page
    q = torch.randn(B, S, H, dh, generator=gen, device=DEV).to(dtype)
    # garbage: 100x the scale of the valid rows, so a leak shows
    kp = 100 * torch.randn(R, Hk, dh, generator=gen, device=DEV)
    vp = 100 * torch.randn(R, Hk, dh, generator=gen, device=DEV)
    perm = torch.randperm(pool_pages, generator=torch.Generator()
                          .manual_seed(seed))[:B * nk]
    bt = perm.reshape(B, nk).to(torch.int32).to(DEV)
    rows = (bt.long()[:, :, None] * page
            + torch.arange(page, device=DEV)).reshape(B, nk * page)
    valid = rows[:, :S].reshape(-1)
    kp[valid] = torch.randn(valid.numel(), Hk, dh, generator=gen, device=DEV)
    vp[valid] = torch.randn(valid.numel(), Hk, dh, generator=gen, device=DEV)
    kp, vp = kp.to(dtype), vp.to(dtype)
    ks = vs = None
    if quant is not None:
        spec = Q.resolve_kv_spec(quant, dtype)
        kp, ks = Q.quantize(kp, spec)
        vp, vs = Q.quantize(vp, spec)
    kw = dict(causal=causal, window=window)

    def launch():
        # block_q only validates the call: S passes as one block
        return ops.mha_flash_paged(q, kp, vp, bt, ks, vs, page=page,
                                   block_q=S, **kw)

    def plain():
        return ref.paged_attention_ref(q, kp, vp, bt, ks, vs, page=page,
                                       **kw)
    got, launches = counted_call(torch, ops, launch, "flash_attention_paged",
                                 counted)
    want = plain()
    gk, gv = kp[rows], vp[rows]                      # (B, nk·page, Hk, dh)
    gks = None if ks is None else ks[rows]
    gvs = None if vs is None else vs[rows]
    contiguous = ops.mha_flash(q, gk, gv, gks, gvs, block_q=S, block_k=page,
                               **kw)
    torch.cuda.synchronize()
    tol = F32_TOL if dtype == torch.float32 else BF16_TOL
    torch.testing.assert_close(got, want, **tol)
    if not torch.equal(got, contiguous):
        raise AssertionError(
            f"paged flash kernel differs from the contiguous kernel on the "
            f"same rows: max abs {max_err(torch, got, contiguous)}")
    res = {"dtype": "float32" if dtype == torch.float32 else "bfloat16",
           "B": B, "S": S, "H": H, "Hk": Hk, "dh": dh, "page": page,
           "pool_pages": pool_pages, "table_pages": nk, "causal": causal,
           "window": window, "quant": quant,
           "max_abs_err": max_err(torch, got, want),
           "bitwise_equal_contiguous": True, "launches": launches,
           "tol": tol}
    if not timed:
        return {**res,
                **flash_profile(torch, launch, dtype, False, producer)}
    nbytes, nops, (b_ms, b_by) = flash_bound(torch, q, gk, gks, causal,
                                             window)
    nbytes += 4 * bt.numel()
    qs, kt, vt = (t.transpose(1, 2) for t in (
        q, gk if ks is None else ref.dequant_ref(gk, gks, dtype),
        gv if vs is None else ref.dequant_ref(gv, gvs, dtype)))
    mask = window_mask(torch, S, nk * page, causal, window)

    def sdpa_gathered():
        return F.scaled_dot_product_attention(qs, kt, vt, attn_mask=mask,
                                              enable_gqa=True)
    res.update({
        **flash_profile(torch, launch, dtype, True, producer),
        # the contiguous kernel on the gathered rows, for the cost of paging
        "contiguous_same_rows_ms": device_ms(
            torch, lambda: ops.mha_flash(q, gk, gv, gks, gvs, block_q=S,
                                         block_k=page, **kw),
            flash_kernel_name(torch, dtype), per_call=1),
        "plain_ms": device_ms(torch, plain, iters=10),
        "wrapper_ms": time_ms(torch, launch, iters=20),
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
        "sdpa_on_pregathered_rows_ms": device_ms(torch, sdpa_gathered),
        "bytes": nbytes, "flop": nops})
    return res


# ---------------------------------------------------------------------------
# (d) full-width f32 parity: kernel path and paged kernel path vs dense path
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def no_cache_writes():
    """Contiguous decode steps inside the block write nothing to their
    caches (models.decode._update_at does nothing)."""
    import repro_torch.models.decode as D
    real = D._update_at
    D._update_at = lambda cache, new, idx: cache
    try:
        yield
    finally:
        D._update_at = real


def dequantized(torch, caches):
    """An f32 copy of quantized caches: each code leaf (k, v, latent)
    times its scale, the scale leaves left out."""
    from repro_torch.kernels import quant
    scale_of = {"k": "k_scale", "v": "v_scale", "latent": "latent_scale"}
    return {si: {n: (quant.dequantize(t, seg[scale_of[n]], torch.float32)
                     if scale_of.get(n) in seg else t.clone())
                 for n, t in seg.items() if not n.endswith("_scale")}
            for si, seg in caches.items()}


def parity_f32(torch, kind=None, base=None, dequant_dense=False):
    """Full-width f32 decode_step logits and greedy tokens of the kernel
    path ("k") and the paged kernel path ("p") against the dense path
    ("d"), over a chunked prefill and 16 decode steps. base: the config
    factory (served_config by default; m-parity passes qwen2-moe-a2.7b's
    at 2 layers).

    kind "int8" / "fp8" (d-quant): every side serves from quantized
    caches, and the dense side differs from the kernel side only in its
    S=1 attention (dense dequant, then sdpa, against the kernels' fused
    dequant) over the same codes: it runs the fused AltUp kernel too, so
    their prefills are one computation, and each decode step it reads a
    copy of the kernel side's caches taken after the kernel side's step
    (this step's rows included), with its own writes suppressed. Rounding
    to codes is discontinuous: the two attention paths' ~1e-7 differences
    would move a code it writes by a whole step now and then (seen: 2 of
    607744 logits 1.1e-3 apart after one such step), which is the
    rounding's doing, not the kernel's. An unquantized dense side ("f"),
    fed the kernel side's tokens, gives the quantized logits' distance
    from the unquantized ones, printed and not gated.

    dequant_dense (l-parity, quantized): the dense side is the
    unquantized f32 dense path (plain AltUp, float caches) and reads, at
    every step, prefill chunks included, an f32 copy of the kernel
    side's caches dequantized after the kernel side's step, its own
    writes suppressed: the kernel path's quantized caches against a
    dense path over the same values, where MLA (no attention kernel)
    would otherwise hold one computation against itself."""
    from repro_torch.models.decode import (decode_step, init_cache,
                                           init_paged_cache)
    from repro_torch.models.transformer import init_params
    from repro_torch.serve.engine import kv_bucket
    torch.backends.cuda.matmul.allow_tf32 = False   # full f32 products
    torch.backends.cudnn.allow_tf32 = False
    cfg = (base or served_config)(dtype="float32", param_dtype="float32")
    quant = kind is not None
    cfg_q = cfg.replace(kv_cache_dtype=kind) if quant else cfg
    cfgs = {"k": cfg_q.replace(ragged_decode_attn=None,
                               fused_decode_altup=None),
            "d": cfg_q.replace(ragged_decode_attn=False,
                               fused_decode_altup=None if quant else False)}
    if dequant_dense:
        cfgs["d"] = cfg.replace(ragged_decode_attn=False,
                                fused_decode_altup=False)
    cfgs["p"] = cfgs["k"]
    if quant:
        cfgs["f"] = cfgs["d"].replace(kv_cache_dtype="auto")
    params = init_params(cfg, seed=0, device=DEV)
    perturb_altup(torch, params, seed=10)
    B, T, C, n_dec, page = 4, 1024, 64, 16, 16
    gen = torch.Generator(device=DEV).manual_seed(2)
    plens = [37, 180, 5, 300]
    prompts = [torch.randint(0, cfg.vocab_size, (n,), generator=gen,
                             device=DEV) for n in plens]
    n_pages = B * T // page
    caches = {s: init_cache(c, B, T, device=DEV) for s, c in cfgs.items()
              if s != "p"}
    caches["p"] = init_paged_cache(cfgs["p"], B, T, n_pages=n_pages,
                                   page=page, device=DEV)
    # the paged side reads through a seeded permutation of the pool
    bt = torch.randperm(n_pages, generator=gen, device=DEV).reshape(
        B, T // page).to(torch.int32)
    pkw = {s: {} for s in cfgs}
    pkw["p"] = {"block_table": bt, "page_size": page}
    sides = tuple(cfgs)
    gated = ("k", "p")
    pos = [0] * B
    worst = {s: 0.0 for s in sides if s != "d"}
    last = {}
    steps = 0                       # decode_step calls of each side
    # chunked prefill: every slot feeds up to C prompt tokens per step
    while any(pos[b] < plens[b] for b in range(B)):
        steps += 1
        toks = torch.zeros(B, C, dtype=torch.long, device=DEV)
        nval = [min(C, plens[b] - pos[b]) for b in range(B)]
        for b in range(B):
            toks[b, :nval[b]] = prompts[b][pos[b]:pos[b] + nval[b]]
        kv_len = kv_bucket(max(p + n for p, n in zip(pos, nval)), 32, T)
        out = {}
        for side in sides:
            writes = contextlib.nullcontext()
            if dequant_dense and side == "d":
                caches["d"] = dequantized(torch, caches["k"])
                writes = no_cache_writes()
            with writes:
                out[side], _ = decode_step(
                    params, cfgs[side], caches[side], toks,
                    torch.tensor(pos, device=DEV),
                    n_valid=torch.tensor(nval, device=DEV), kv_len=kv_len,
                    **pkw[side])
        for b in range(B):
            if nval[b]:
                rows = {s: out[s][b, :nval[b], :cfg.vocab_size]
                        for s in sides}
                for s in gated:
                    torch.testing.assert_close(rows[s], rows["d"],
                                               **PARITY_TOL)
                for s in worst:
                    worst[s] = max(worst[s],
                                   max_err(torch, rows[s], rows["d"]))
                if pos[b] + nval[b] == plens[b]:
                    last[b] = {s: rows[s][-1] for s in sides}
        pos = [p + n for p, n in zip(pos, nval)]
    tok = {s: torch.stack([last[b][s].argmax() for b in range(B)])
           for s in sides}
    streams = {s: [tok[s].tolist()] for s in sides}
    min_gap = math.inf
    for _ in range(n_dec):
        steps += 1
        kv_len = kv_bucket(max(pos) + 1, 32, T)
        if quant:
            # the dense and unquantized sides take the kernel side's tokens
            tok["d"] = tok["f"] = tok["k"]
        lg = {}
        for side in sides:
            writes = contextlib.nullcontext()
            if quant and side == "d":
                # the kernel side's caches after its step (dequantized for
                # dequant_dense); no writes
                caches["d"] = (dequantized(torch, caches["k"])
                               if dequant_dense else
                               {si: {n: t.clone() for n, t in seg.items()}
                                for si, seg in caches["k"].items()})
                writes = no_cache_writes()
            with writes:
                logits, _ = decode_step(
                    params, cfgs[side], caches[side], tok[side][:, None],
                    torch.tensor(pos, device=DEV), kv_len=kv_len,
                    **pkw[side])
            lg[side] = logits[:, 0, :cfg.vocab_size]
        for s in gated:
            torch.testing.assert_close(lg[s], lg["d"], **PARITY_TOL)
        for s in worst:
            worst[s] = max(worst[s], max_err(torch, lg[s], lg["d"]))
        top2 = lg["d"].topk(2, dim=-1).values
        min_gap = min(min_gap, float((top2[:, 0] - top2[:, 1]).min()))
        for side in sides:
            tok[side] = lg[side].argmax(dim=-1)
            streams[side].append(tok[side].tolist())
        pos = [p + 1 for p in pos]
    if not streams["k"] == streams["p"] == streams["d"]:
        raise AssertionError(f"greedy tokens differ between the kernel, "
                             f"paged kernel and dense paths: {streams}")
    del params, caches
    torch.cuda.empty_cache()
    res = {"cfg": cfg_name(cfg), "kv_cache_dtype": kind or "auto",
           "dense_side": ("f32 dense over the kernel side's dequantized "
                          "caches" if dequant_dense else
                          "the kernel side's caches" if quant else
                          "its own caches"),
           "slots": B, "prompt_lens": plens, "decode_steps": n_dec,
           "max_abs_logit_err": worst["k"],
           "paged_max_abs_logit_err": worst["p"], "page": page,
           "tol": PARITY_TOL,
           "greedy_tokens_identical": True,
           "tokens_checked": B * (n_dec + 1),
           "steps_per_side": steps,
           "fused_altup_sides": sum(c.fused_decode_altup is not False
                                    for c in cfgs.values()),
           "min_top2_gap_dense": min_gap,
           "tf32": [torch.backends.cuda.matmul.allow_tf32,
                    torch.backends.cudnn.allow_tf32]}
    if quant:
        # not gated: the quantized dense path against the unquantized one
        res["max_abs_logit_diff_vs_unquantized"] = worst["f"]
        res["greedy_tokens_equal_unquantized"] = \
            streams["d"] == streams["f"]
    return res


def graph_parity_f32(torch, paged, tol=1e-5):
    """The replaying Engine against the eager reference at full width in
    f32: the same 4 requests (prompts of 5-300 tokens, 16 new, logprobs
    on) through each, contiguous or paged. Tokens identical; every chosen
    token's logprob and every cache leaf within `tol` (a replay runs the
    eager step's kernels on its buffers in its order: expected 0)."""
    from repro_torch.models.transformer import init_params
    from repro_torch.serve.sampling import SamplingParams
    torch.backends.cuda.matmul.allow_tf32 = False   # full f32 products
    torch.backends.cudnn.allow_tf32 = False
    cfg = served_config(dtype="float32", param_dtype="float32")
    params = init_params(cfg, seed=0, device=DEV)
    perturb_altup(torch, params, seed=12)
    gen = torch.Generator().manual_seed(13)
    plens, n_new = (37, 180, 5, 300), 16
    prompts = [torch.randint(0, cfg.vocab_size, (n,), generator=gen).tolist()
               for n in plens]
    kw = dict(paged=True, page_size=16) if paged else {}
    out = {}
    for replay in (False, True):
        eng = engine_class(replay)(cfg, params, max_len=512, n_slots=4,
                                   prefill_chunk=64, prefix_cache=False,
                                   device=DEV, **kw)
        rids = [eng.submit(p, sampling=SamplingParams(max_new=n_new,
                                                      logprobs=True))
                for p in prompts]
        done = eng.run()
        out[replay] = ([done[r].tokens for r in rids],
                       torch.tensor([done[r].logprobs for r in rids]),
                       eng._caches, eng.graph_stats)
    (tok_e, lp_e, c_e, _), (tok_r, lp_r, c_r, gs) = out[False], out[True]
    if tok_e != tok_r:
        raise AssertionError(f"replayed tokens differ: {tok_r} vs {tok_e}")
    lp_err = max_err(torch, lp_r, lp_e)

    def rows(leaf):
        # rows below the sink: padded tokens of one chunk all write a
        # slot's sink row (a pool's sink page), in no set order
        return leaf[:, :-16] if paged else leaf[:, :, :-1]
    pairs = [(rows(c_r[s][n]), rows(c_e[s][n])) for s in c_e for n in c_e[s]]
    cache_err = max(max_err(torch, a, b) for a, b in pairs)
    bitwise = all(torch.equal(a, b) for a, b in pairs) and \
        torch.equal(lp_r, lp_e)
    if lp_err > tol or cache_err > tol:
        raise AssertionError(f"replayed step off the eager one: logprobs "
                             f"{lp_err}, caches {cache_err}")
    if gs["replays"] < 1:
        raise AssertionError(f"no step replayed: {gs}")
    del params, out, c_e, c_r
    torch.cuda.empty_cache()
    return {"paged": paged, "prompt_lens": list(plens), "new_tokens": n_new,
            "tokens_identical": True, "logprob_max_abs_err": lp_err,
            "cache_max_abs_err": cache_err, "bitwise": bitwise, "tol": tol,
            "replays": gs["replays"], "captures": gs["captures"],
            "shapes": gs["shapes"]}


# ---------------------------------------------------------------------------
# (e) serve: the main path, through the entry points a user calls
# ---------------------------------------------------------------------------

E_PROMPTS, E_NEW = (32, 96, 160, 224, 288, 352, 416, 512), 64

# kernels a wrapper call launches on the card: the decode attention's
# split and merge kernel, one kernel for the others
KERNELS_PER_LAUNCH = {"ragged_decode_attention": 2,
                      "paged_ragged_decode_attention": 2}


def engine_class(replay):
    """Engine, whose pure-decode steps replay CUDA graphs on the card, or
    (replay=False) the eager reference it is held against: the same
    static-buffer step function, called directly every step."""
    from repro_torch.serve.engine import Engine
    if replay:
        return Engine

    class EagerEngine(Engine):
        # False: steps replay as in Engine (for work outside a counted run)
        eager = True

        def _run_step(self, key, fn):
            if self.eager:
                return fn()
            return super()._run_step(key, fn)

        def _run_round(self, key, fn, undo=None):
            if self.eager:
                return fn()
            return super()._run_round(key, fn, undo)
    return EagerEngine


def step_stats(eng):
    """Engine.stats without its timings: the counts a replayed run must
    share with the eager one."""
    return {k: v for k, v in eng.stats.items()
            if k not in ("prefill_s", "decode_s")}


def graph_window(before, after):
    """What the engine's graphs did between two graph_stats snapshots:
    captures (and all of the engine's), replays, the warm-ups'
    launches."""
    return {"captures": after["captures"] - before["captures"],
            "captures_total": after["captures"],
            "replays": after["replays"] - before["replays"],
            "shapes": after["shapes"],
            "warmup_launches": {k: n - before["warmup_launches"][k]
                                for k, n in after["warmup_launches"].items()},
            "replays_by_shape": {str(k): n for k, n in
                                 after["replays_by_shape"].items()},
            "launches_per_replay": {str(k): v for k, v in
                                    after["launches_per_replay"].items()}}


def hold_replay(eager, replayed, replays_want):
    """Gate a replayed serve phase against its eager twin: every request's
    tokens and the engine's step counts identical (and the pool counters,
    paged), one replay per pure-decode step, one capture per static shape,
    and the kernels' launch counts equal to the eager run's once the
    warm-ups' launches are taken out. Returns the fields to print."""
    if replayed["tokens"] != eager["tokens"]:
        raise AssertionError(f"replayed tokens differ from eager: "
                             f"{replayed['tokens']} vs {eager['tokens']}")
    for key in ("stats", "paged_stats"):
        if replayed.get(key) != eager.get(key):
            raise AssertionError(f"replayed {key} {replayed.get(key)} != "
                                 f"eager {eager.get(key)}")
    g = replayed["graph"]
    if g["replays"] != replays_want:
        raise AssertionError(f"{g['replays']} replays for {replays_want} "
                             f"pure-decode steps")
    if g["captures_total"] != len(g["shapes"]) or \
            not g["replays"] > len(g["shapes"]):
        raise AssertionError(f"not one capture per shape, reused: {g}")
    net = {k: n - g["warmup_launches"][k]
           for k, n in replayed["launches"].items()}
    if net != eager["launches"]:
        raise AssertionError(f"replayed launches {replayed['launches']} "
                             f"less warm-ups {g['warmup_launches']} != eager "
                             f"{eager['launches']}")
    return {"tokens_identical": True, "stats_identical": True,
            "launches_less_warmups_equal_eager": True,
            "replays_per_decode_step": g["replays"] / replays_want,
            "step_ms_median_over_eager": (replayed["decode_step_ms_median"]
                                          / eager["decode_step_ms_median"]),
            "decode_tok_s_over_eager": (replayed["decode_tok_s"]
                                        / eager["decode_tok_s"])}

def cache_bytes(eng):
    """Device bytes of the engine's caches, every leaf."""
    return sum(t.numel() * t.element_size()
               for seg in eng._caches.values() for t in seg.values())


def serve_bf16(torch, ops, profile=False, kind=None, replay=False,
               cfg=None, after=None):
    """Phase (e); kind "int8" / "fp8" serves the same traffic from
    quantized caches (e-quant); replay=True through the engine whose
    pure-decode steps replay CUDA graphs (e-graph, e-quant-graph),
    replay=False through the eager reference. cfg: another bf16 model
    for the same traffic (m-serve: qwen2-moe-a2.7b); after(eng, params):
    more fields for the result, from the engine after its run. The
    decode attention launches once a decode step in each attention
    layer; MLA layers launch none (as in the reference)."""
    from repro_torch.models.transformer import init_params, layer_plan
    from repro_torch.serve.sampling import SamplingParams
    cfg = served_config() if cfg is None else cfg      # bf16
    if kind is not None:
        cfg = cfg.replace(kv_cache_dtype=kind)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    params = init_params(cfg, seed=1, device=DEV)
    perturb_altup(torch, params, seed=11)
    init_mem = {"params_bytes": sum(t.numel() * t.element_size()
                                    for t in params.parameters()),
                "peak_mem_gb_init": torch.cuda.max_memory_allocated() / 1e9}
    eng = engine_class(replay)(cfg, params, max_len=2048, n_slots=8,
                               prefill_chunk=64, prefix_cache=False,
                               device=DEV)
    gen = torch.Generator().manual_seed(3)
    plens = list(E_PROMPTS)
    prompts = [torch.randint(0, cfg.vocab_size, (n,), generator=gen).tolist()
               for n in plens]
    n_new = E_NEW
    # warm-up request (cuBLAS handles, allocator) outside the counted run
    eng.submit(prompts[0][:16], sampling=SamplingParams(max_new=4))
    eng.run()
    eng.reset_stats()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()     # the peak of this run only
    gs0 = eng.graph_stats
    ops.reset_launch_counts()                # counts start at 0 right here
    t_run = time.perf_counter()
    rids = [eng.submit(p, sampling=SamplingParams(max_new=n_new))
            for p in prompts]
    decode_ms, steps = [], 0
    while eng.has_work:
        pf0 = eng.stats["prefill_tokens"]
        t0 = time.perf_counter()
        eng.step()                           # ends in the ids' device->host
        dt = time.perf_counter() - t0
        steps += 1
        if eng.stats["prefill_tokens"] == pf0:
            decode_ms.append(1e3 * dt)
    wall = time.perf_counter() - t_run
    counts = ops.launch_counts()             # read right after the run
    graph = graph_window(gs0, eng.graph_stats) if replay else None
    out = eng.collect()
    if sorted(out) != sorted(rids):
        raise AssertionError(f"not every request completed: {sorted(out)}")
    for rid in rids:
        c = out[rid]
        if len(c.tokens) != n_new or c.finish_reason != "length" or \
                not all(0 <= t < cfg.vocab_size for t in c.tokens):
            raise AssertionError(f"request {rid}: {c.finish_reason}, "
                                 f"{len(c.tokens)} tokens")
    n_layers = cfg.n_layers
    ragged_layers = sum(s.n for s in layer_plan(cfg) if s.kind == "attn")
    if counts["altup_predict_correct"] <= 0 or \
            (ragged_layers and counts["ragged_decode_attention"] <= 0):
        raise AssertionError(f"a kernel of the path never launched: {counts}")
    # one launch per layer per step: fused AltUp on every step, ragged
    # attention on the pure-decode (S=1) steps, and once more per layer in
    # each capture's warm-up
    warm = graph["warmup_launches"] if graph else dict.fromkeys(counts, 0)
    if counts["altup_predict_correct"] - warm["altup_predict_correct"] != \
            n_layers * steps or \
            counts["ragged_decode_attention"] - \
            warm["ragged_decode_attention"] != ragged_layers * len(decode_ms) \
            or counts["paged_ragged_decode_attention"] != 0:
        raise AssertionError(f"launch counts {counts} (warm-ups {warm}) do "
                             f"not match {steps} steps, {len(decode_ms)} "
                             f"decode steps")
    st = eng.stats
    decode_ms.sort()
    res = {"cfg": cfg_name(cfg), "requests": len(rids), "prompt_lens": plens,
           "new_tokens": n_new, "replay": replay, "graph": graph,
           "steps": steps, "decode_steps": len(decode_ms),
           "launches": counts, **init_mem,
           "kv_cache_dtype": kind or "auto", "cache_bytes": cache_bytes(eng),
           "ragged_launches_per_decode_step":
               counts["ragged_decode_attention"] / len(decode_ms),
           "prefill_tok_s": st["prefill_tokens"] / st["prefill_s"],
           "decode_tok_s": st["decode_tokens"] / st["decode_s"],
           "decode_step_ms_median": decode_ms[len(decode_ms) // 2],
           "decode_step_ms_p80": decode_ms[int(0.8 * len(decode_ms))],
           "decode_step_ms_min": decode_ms[0],
           "wall_s": wall,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    trace = {"tokens": [out[r].tokens for r in rids],
             "stats": step_stats(eng)}
    if after is not None:
        res.update(after(eng, params))
    prof = profile_decode(torch, ops, eng, prompts, replay) if profile \
        else None
    del eng, params
    torch.cuda.empty_cache()
    return res, trace, prof


# ---------------------------------------------------------------------------
# (g) paged serve with prefix reuse: the paged path, through Engine
# ---------------------------------------------------------------------------

# phase (g)'s traffic: a system prompt that is not a whole number of pages
# (so every hit aliases its full pages and copies its boundary page), then
# requests of that prompt plus a tail, on 16 slots over a pool of 4
# full-length requests' worth of pages
G_SYSTEM, G_REQUESTS, G_NEW = 250, 15, 64
G_SLOTS, G_PAGES, G_PAGE = 16, 512, 16


def paged_traffic(torch, vocab):
    """Phase (g)'s system prompt, tail lengths and prompts, from seed 5."""
    gen = torch.Generator().manual_seed(5)
    system = torch.randint(0, vocab, (G_SYSTEM,), generator=gen).tolist()
    tails = torch.randint(32, 257, (G_REQUESTS,), generator=gen).tolist()
    prompts = [system + torch.randint(0, vocab, (n,), generator=gen).tolist()
               for n in tails]
    return system, tails, prompts


@contextlib.contextmanager
def page_ops(torch, check):
    """Count the engine's boundary-page copies, spills and restores made
    inside the block; with `check`, hold each one bitwise against the
    pool rows it read or wrote (one host sync each)."""
    import repro_torch.serve.engine as E
    real = {n: getattr(E, n)
            for n in ("copy_pages", "scatter_pages", "_spill_entry")}
    n = {"copies": 0, "copied_pages": 0, "spills": 0, "restores": 0}

    def same(a, b):                          # two gather_pages blobs
        return all(torch.equal(a[s][k], b[s][k].to(a[s][k].device))
                   for s in a for k in a[s])

    def copy_pages(caches, dst, src, *, page):
        out = real["copy_pages"](caches, dst, src, page=page)
        n["copies"] += 1
        n["copied_pages"] += len(dst)
        if check and not same(E.gather_pages(caches, dst, page=page),
                              E.gather_pages(caches, src, page=page)):
            raise AssertionError("a copied page differs from its source")
        return out

    def scatter_pages(caches, blob, pages, *, page):
        out = real["scatter_pages"](caches, blob, pages, page=page)
        n["restores"] += 1
        if check:
            rows = len(pages) * page     # pooled k/v: (n, rows, Hk, Dh)
            want = {s: {k: t[:, :rows] for k, t in leaves.items()}
                    for s, leaves in blob.items()}
            if not same(E.gather_pages(caches, pages, page=page), want):
                raise AssertionError("restored pages differ from the blob")
        return out

    def spill_entry(caches, page, entry):
        blob = real["_spill_entry"](caches, page, entry)
        n["spills"] += 1
        if check and not same(E.gather_pages(caches, entry.pages, page=page),
                              blob):
            raise AssertionError("a spilled blob differs from its pages")
        return blob
    E.copy_pages, E.scatter_pages, E._spill_entry = (copy_pages,
                                                     scatter_pages,
                                                     spill_entry)
    try:
        yield n
    finally:
        for name, fn in real.items():
            setattr(E, name, fn)


def serve_paged_bf16(torch, ops, profile=False, kind=None, replay=False):
    """Phase (g); kind "int8" / "fp8" serves the same traffic from a
    quantized pool (g-quant); replay as in serve_bf16 (g-graph,
    g-quant-graph)."""
    from repro_torch.models.transformer import init_params
    from repro_torch.serve.sampling import SamplingParams
    cfg = served_config()                              # bf16
    if kind is not None:
        cfg = cfg.replace(kv_cache_dtype=kind)
    params = init_params(cfg, seed=1, device=DEV)
    perturb_altup(torch, params, seed=11)
    eng = engine_class(replay)(cfg, params, max_len=2048, n_slots=G_SLOTS,
                               prefill_chunk=64, paged=True,
                               page_size=G_PAGE, n_pages=G_PAGES,
                               device=DEV)
    system, tails, prompts = paged_traffic(torch, cfg.vocab_size)
    n_new = G_NEW
    # the warm request puts the system prompt in the prefix cache (and
    # warms cuBLAS and the allocator) outside the counted run
    eng.submit(system, sampling=SamplingParams(max_new=n_new))
    eng.run()
    eng.reset_stats()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    gs0 = eng.graph_stats
    with page_ops(torch, check=False) as pops:
        ops.reset_launch_counts()            # counts start at 0 right here
        t_run = time.perf_counter()
        rids = [eng.submit(p, sampling=SamplingParams(max_new=n_new))
                for p in prompts]
        decode_ms, steps = [], 0
        while eng.has_work:
            pf0 = eng.stats["prefill_tokens"]
            t0 = time.perf_counter()
            eng.step()                       # ends in the ids' device->host
            dt = time.perf_counter() - t0
            steps += 1
            if eng.stats["prefill_tokens"] == pf0:
                decode_ms.append(1e3 * dt)
        wall = time.perf_counter() - t_run
        counts = ops.launch_counts()         # read right after the run
    graph = graph_window(gs0, eng.graph_stats) if replay else None
    out = eng.collect()
    if sorted(out) != sorted(rids):
        raise AssertionError(f"not every request completed: {sorted(out)}")
    for rid in rids:
        c = out[rid]
        if len(c.tokens) != n_new or c.finish_reason != "length" or \
                not all(0 <= t < cfg.vocab_size for t in c.tokens):
            raise AssertionError(f"request {rid}: {c.finish_reason}, "
                                 f"{len(c.tokens)} tokens")
    st, ps = eng.stats, eng.paged_stats
    hits = st["prefix_hits"]
    if hits < 1 or ps["alias_acquisitions"] <= 0:
        raise AssertionError(f"no prefix reuse: {st}, {ps}")
    # every hit aliases the system prompt's full pages and copies its
    # boundary page (the warm request aliased nothing)
    if ps["alias_acquisitions"] != hits * (G_SYSTEM // G_PAGE) or \
            pops["copies"] != hits or pops["copied_pages"] != hits:
        raise AssertionError(f"{hits} hits, {pops}, {ps}: not one boundary "
                             f"copy and {G_SYSTEM // G_PAGE} aliased pages "
                             f"each")
    if st["concurrency_peak"] <= 4 or ps["pages_in_use_peak"] > G_PAGES:
        raise AssertionError(f"pool not over-committed as expected: {st}, "
                             f"{ps}")
    n_layers = cfg.n_layers
    warm = graph["warmup_launches"] if graph else dict.fromkeys(counts, 0)
    if counts["paged_ragged_decode_attention"] - \
            warm["paged_ragged_decode_attention"] != \
            n_layers * len(decode_ms) \
            or counts["ragged_decode_attention"] != 0 \
            or counts["altup_predict_correct"] - \
            warm["altup_predict_correct"] != n_layers * steps:
        raise AssertionError(f"launch counts {counts} (warm-ups {warm}) do "
                             f"not match {steps} steps, {len(decode_ms)} "
                             f"decode steps")
    decode_ms.sort()
    res = {"requests": len(rids), "system_prompt": len(system),
           "replay": replay, "graph": graph,
           "kv_cache_dtype": kind or "auto", "cache_bytes": cache_bytes(eng),
           "tails": tails, "new_tokens": n_new, "steps": steps,
           "decode_steps": len(decode_ms), "launches": counts,
           "paged_launches_per_decode_step":
               counts["paged_ragged_decode_attention"] / len(decode_ms),
           "prefix_hits": hits, "boundary_copies": pops["copies"],
           "prefill_tokens_saved": st["prefill_tokens_saved"],
           "concurrency_peak": st["concurrency_peak"],
           "prefill_tok_s": st["prefill_tokens"] / st["prefill_s"],
           "decode_tok_s": st["decode_tokens"] / st["decode_s"],
           "decode_step_ms_median": decode_ms[len(decode_ms) // 2],
           "decode_step_ms_p80": decode_ms[int(0.8 * len(decode_ms))],
           "decode_step_ms_min": decode_ms[0],
           "wall_s": wall, "paged_stats": ps,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    trace = {"tokens": [out[r].tokens for r in rids],
             "stats": step_stats(eng), "paged_stats": ps}
    prof = profile_decode(torch, ops, eng, prompts, replay) if profile \
        else None
    del eng, params
    torch.cuda.empty_cache()
    return res, trace, prof


def serve_spill_bf16(torch):
    """The host spill tier on the card. One slot over a 64-page pool (one
    max_len=1024 request's worth) serves requests of 508 tokens (a 500-
    token prefix, not a whole number of pages) and 16 new tokens, in
    order. Request x shares a's prefix. Served after a alone, x hits a's
    retained pages (alias + boundary copy); served after a and b, it hits
    a's blob, which b's admission spilled to the host, and restores it
    into fresh pages. The two x must give the same tokens, and every
    copy, spill and restore is held bitwise against the pool."""
    from repro_torch.models.transformer import init_params
    from repro_torch.serve.engine import Engine
    from repro_torch.serve.sampling import SamplingParams
    cfg = served_config()                              # bf16
    params = init_params(cfg, seed=1, device=DEV)
    perturb_altup(torch, params, seed=11)
    page, n_pages, n_new = 16, 64, 16
    gen = torch.Generator().manual_seed(6)

    def ids(n):
        return torch.randint(0, cfg.vocab_size, (n,), generator=gen).tolist()
    pre_a, pre_b = ids(500), ids(500)
    a, b, x = pre_a + ids(8), pre_b + ids(8), pre_a + ids(8)

    def serve(prompts):
        eng = Engine(cfg, params, max_len=1024, n_slots=1, prefill_chunk=64,
                     paged=True, page_size=page, n_pages=n_pages,
                     host_spill_pages=2 * n_pages, device=DEV)
        t0 = time.perf_counter()
        with page_ops(torch, check=True) as pops:
            rids = [eng.submit(p, sampling=SamplingParams(max_new=n_new))
                    for p in prompts]
            out = eng.run()
        wall = time.perf_counter() - t0
        toks = [out[r].tokens for r in rids]
        if any(len(t) != n_new for t in toks):
            raise AssertionError(f"a request fell short: {toks}")
        return {"tokens": toks, "stats": dict(eng.stats),
                "paged_stats": eng.paged_stats, "page_ops": pops,
                "wall_s": wall}
    resident = serve([a, x])
    spilled = serve([a, b, x])
    r, s = resident, spilled
    if r["stats"]["prefix_hits"] != 1 or r["page_ops"]["copies"] != 1 or \
            r["page_ops"]["spills"] or r["page_ops"]["restores"]:
        raise AssertionError(f"x did not hit a's resident pages: {r}")
    if s["stats"]["prefix_hits"] != 1 or s["page_ops"]["restores"] != 1 or \
            s["page_ops"]["spills"] < 1 or s["page_ops"]["copies"] or \
            s["paged_stats"]["spills"] < 1 or \
            s["paged_stats"]["restores"] != 1:
        raise AssertionError(f"x did not hit a's spilled blob: {s}")
    if r["tokens"][0] != s["tokens"][0] or r["tokens"][-1] != s["tokens"][-1]:
        raise AssertionError(f"restored prefix serves other tokens than the "
                             f"resident one: {r['tokens']} vs {s['tokens']}")
    del params
    torch.cuda.empty_cache()
    return {"prompt_lens": [len(a), len(b), len(x)], "prefix": len(pre_a),
            "page": page, "n_pages": n_pages, "new_tokens": n_new,
            "x_tokens_identical": True,
            "resident": {k: r[k] for k in ("page_ops", "paged_stats",
                                           "wall_s")},
            "spilled": {k: s[k] for k in ("page_ops", "paged_stats",
                                          "wall_s")}}


# ---------------------------------------------------------------------------
# (h) rwkv6-1.6b full-width f32 parity: WKV kernel path vs dense path
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def rwkv_recording():
    """Record, in call order, the outputs of every RWKV-6 time mix and
    channel mix and of every AltUp layer, the inputs of the dense chunked
    WKV, and the inputs and output of the fused AltUp kernel's decode
    wrapper: {"tm", "cm", "alt", "wkv_in", "fused"}: lists, one entry a
    layer in order."""
    import repro_torch.core.altup as A
    import repro_torch.kernels.ops as O
    import repro_torch.models.rwkv as R
    rec = {"tm": [], "cm": [], "alt": [], "wkv_in": [], "fused": []}
    real = {"tm": R.rwkv_time_mix, "cm": R.rwkv_channel_mix,
            "alt": A.altup_layer, "wkv_in": R.wkv_chunked,
            "fused": O.decode_altup_predict_correct}

    def tm(*a, **kw):
        out = real["tm"](*a, **kw)
        rec["tm"].append(out[0].detach().clone())
        return out

    def cm(*a, **kw):
        out = real["cm"](*a, **kw)
        rec["cm"].append(out[0].detach().clone())
        return out

    def alt(*a, **kw):
        out = real["alt"](*a, **kw)
        rec["alt"].append(out.detach().clone())
        return out

    def chunked(r, k, v, w, u, state, **kw):
        rec["wkv_in"].append(tuple(t.detach().clone()
                                   for t in (r, k, v, w, u, state)))
        return real["wkv_in"](r, k, v, w, u, state, **kw)

    def fused(*a):
        out = real["fused"](*a)
        rec["fused"].append((tuple(t.detach().clone() for t in a),
                             out.detach().clone()))
        return out
    R.rwkv_time_mix, R.rwkv_channel_mix, R.wkv_chunked = tm, cm, chunked
    A.altup_layer, O.decode_altup_predict_correct = alt, fused
    try:
        yield rec
    finally:
        R.rwkv_time_mix, R.rwkv_channel_mix = real["tm"], real["cm"]
        R.wkv_chunked, A.altup_layer = real["wkv_in"], real["alt"]
        O.decode_altup_predict_correct = real["fused"]


def wkv_f64(torch, r, k, v, w, u, state):
    """The WKV recurrence in float64, one step at a time: the exact value
    the kernel and the dense forms are held against."""
    f = torch.float64
    r, k, v, w = (t.to(f) for t in (r, k, v, w))
    uf = u.to(f)[None, :, :, None]
    s = state.to(f)
    outs = []
    for t in range(r.shape[1]):
        kv = k[:, t, :, :, None] * v[:, t, :, None, :]
        outs.append(torch.einsum("bhk,bhkv->bhv", r[:, t], s + uf * kv))
        s = w[:, t, :, :, None] * s + kv
    return torch.stack(outs, dim=1)


def per_layer_diff(torch, rec_k, rec_d):
    """Per layer: max |kernel path - dense path| of the time mix, the
    channel mix and the AltUp layer's output, and the largest |value| of
    the dense AltUp output."""
    return {"time_mix": [max_err(torch, a, b)
                         for a, b in zip(rec_k["tm"], rec_d["tm"])],
            "channel_mix": [max_err(torch, a, b)
                            for a, b in zip(rec_k["cm"], rec_d["cm"])],
            "altup": [max_err(torch, a, b)
                      for a, b in zip(rec_k["alt"], rec_d["alt"])],
            "altup_out_max_abs": [float(b.abs().max())
                                  for b in rec_d["alt"]]}


def wkv_local_errors(torch, ops, wkv_in):
    """Each layer's WKV inputs of the dense forward, through the kernel,
    the dense chunked form and the f32 sequential scan, each against the
    f64 scan: max abs error a layer, and the largest |output|."""
    import repro_torch.models.rwkv as R
    out = {"kernel": [], "chunked": [], "scan_f32": [], "out_max_abs": []}
    for r, k, v, w, u, s0 in wkv_in:
        exact = wkv_f64(torch, r, k, v, w, u, s0)
        got = {"kernel": ops.rwkv6_wkv(r, k, v, w, u, None)[0],
               "chunked": R.wkv_chunked(r, k, v, w, u, s0)[0],
               "scan_f32": R.wkv_scan(r, k, v, w, u, s0)[0]}
        for name, o in got.items():
            out[name].append(float((o.double() - exact).abs().max()))
        out["out_max_abs"].append(float(exact.abs().max()))
    return out


def altup_local_errors(torch, fused):
    """Each layer's fused AltUp kernel call of a decode step against the
    einsum predict+correct on the same inputs and both against float64:
    max abs error a layer."""
    from repro_torch.core import altup as A
    out = {"fused": [], "einsum": []}
    for (xw, xt, sel, p, g), got in fused:
        exact = A.correct(A.predict(xw.double(), p.double()), xt.double(),
                          sel.double(), g.double())
        dense = A.correct(A.predict(xw, p), xt, sel, g)
        out["fused"].append(float((got.double() - exact).abs().max()))
        out["einsum"].append(float((dense.double() - exact).abs().max()))
    return out


def rwkv_parity_f32(torch):
    from repro_torch.models.decode import decode_step, init_cache
    from repro_torch.models.transformer import forward, init_params
    torch.backends.cuda.matmul.allow_tf32 = False   # full f32 products
    torch.backends.cudnn.allow_tf32 = False
    cfg = rwkv_config(dtype="float32", param_dtype="float32")
    cfgs = {"k": cfg.replace(fused_decode_altup=None),
            "d": cfg.replace(fused_decode_altup=False)}
    wkv = {"k": None, "d": False}               # None: the kernel on CUDA
    params = init_params(cfg, seed=0, device=DEV)
    perturb_rwkv(torch, params, cfg, seed=20)
    B, S, n_dec = 2, 64, 16
    gen = torch.Generator(device=DEV).manual_seed(21)
    prompts = torch.randint(0, cfg.vocab_size, (B, S), generator=gen,
                            device=DEV)
    fwd, rec_fwd = {}, {}
    for s in "kd":
        # the per-layer record of each path (C2: which layer adds what)
        with rwkv_recording() as rec_fwd[s]:
            fwd[s] = forward(params, cfgs[s], prompts, wkv_kernel=wkv[s]
                             )[..., :cfg.vocab_size]
    torch.testing.assert_close(fwd["k"], fwd["d"], **PARITY_TOL)
    worst_fwd = max_err(torch, fwd["k"], fwd["d"])
    caches = {s: init_cache(cfgs[s], B, S + n_dec, device=DEV) for s in "kd"}
    worst = 0.0
    for t in range(S):                   # token-by-token prefill
        lg = {}
        for s in "kd":
            out, _ = decode_step(params, cfgs[s], caches[s],
                                 prompts[:, t:t + 1], t, wkv_kernel=wkv[s])
            lg[s] = out[:, 0, :cfg.vocab_size]
        torch.testing.assert_close(lg["k"], lg["d"], **PARITY_TOL)
        worst = max(worst, max_err(torch, lg["k"], lg["d"]))
    # the prefill's last logits are the forward's
    torch.testing.assert_close(lg["d"], fwd["d"][:, -1], **PARITY_TOL)
    tok = {s: lg[s].argmax(-1) for s in "kd"}
    streams = {s: [tok[s].tolist()] for s in "kd"}
    min_gap = math.inf
    rec_dec = {}
    for t in range(S, S + n_dec):
        for s in "kd":
            # the last step's per-layer record of each path
            with (rwkv_recording() if t == S + n_dec - 1
                  else contextlib.nullcontext({})) as rec_dec[s]:
                out, _ = decode_step(params, cfgs[s], caches[s],
                                     tok[s][:, None], t, wkv_kernel=wkv[s])
            lg[s] = out[:, 0, :cfg.vocab_size]
        torch.testing.assert_close(lg["k"], lg["d"], **PARITY_TOL)
        worst = max(worst, max_err(torch, lg["k"], lg["d"]))
        top2 = lg["d"].topk(2, dim=-1).values
        min_gap = min(min_gap, float((top2[:, 0] - top2[:, 1]).min()))
        for s in "kd":
            tok[s] = lg[s].argmax(-1)
            streams[s].append(tok[s].tolist())
    if streams["k"] != streams["d"]:
        raise AssertionError(f"greedy tokens differ between the WKV kernel "
                             f"path and the dense path: {streams}")
    state_err = max_err(torch, caches["k"]["seg0"]["wkv"],
                        caches["d"]["seg0"]["wkv"])
    from repro_torch.kernels import ops
    diagnosis = {
        "logit_max_abs": float(fwd["d"].abs().max()),
        "logit_std": float(fwd["d"].std()),
        "decode_logit_max_abs": float(lg["d"].abs().max()),
        "forward_err_over_logit_max_abs":
            worst_fwd / float(fwd["d"].abs().max()),
        "forward_per_layer": per_layer_diff(torch, rec_fwd["k"],
                                            rec_fwd["d"]),
        "decode_last_step_per_layer": per_layer_diff(torch, rec_dec["k"],
                                                     rec_dec["d"]),
        "forward_wkv_local_vs_f64": wkv_local_errors(
            torch, ops, rec_fwd["d"]["wkv_in"]),
        "decode_altup_local_vs_f64": altup_local_errors(
            torch, rec_dec["k"]["fused"])}
    del params, caches, rec_fwd, rec_dec
    torch.cuda.empty_cache()
    return {"prompts": B, "prompt_len": S, "decode_steps": n_dec,
            "forward_max_abs_logit_err": worst_fwd,
            "decode_max_abs_logit_err": worst,
            "final_wkv_state_max_abs_err": state_err, "tol": PARITY_TOL,
            "c2_diagnosis": diagnosis,
            "greedy_tokens_identical": True,
            "tokens_checked": B * (n_dec + 1),
            "min_top2_gap_dense": min_gap,
            "tf32": [torch.backends.cuda.matmul.allow_tf32,
                     torch.backends.cudnn.allow_tf32]}


# ---------------------------------------------------------------------------
# (i) rwkv6-1.6b bf16 serve with prefix reuse, through Engine
# ---------------------------------------------------------------------------

# phase (i)'s traffic: a donor of a 64-token prefix (max_new=1, so it stops
# at the prefix boundary, the recurrent validity rule), then 7 requests in
# one batch: the prefix plus 32 tokens, and 6 prompts of their own
I_PREFIX, I_EXTEND, I_NEW = 64, 32, 32
I_PROMPTS = (32, 128, 160, 192, 224, 256)
I_SLOTS, I_MAX_LEN = 8, 512
# (i)'s eager and replayed runs at 8 of the 24 layers (since PR 28, for
# the run's time: the eager twin took 31-62 s at full depth); h-parity
# and i-paged keep the full depth
I_SERVE_LAYERS = 8


def rwkv_traffic(torch, vocab):
    """Phase (i)'s donor prompt and its batch (the extender first), from
    seed 9."""
    gen = torch.Generator().manual_seed(9)

    def ids(n):
        return torch.randint(0, vocab, (n,), generator=gen).tolist()
    donor = ids(I_PREFIX)
    batch = [donor + ids(I_EXTEND)] + [ids(n) for n in I_PROMPTS]
    return donor, batch


def serve_recurrent_bf16(torch, ops, profile=False, replay=False, cfg=None,
                         kind=None, paged=False, after=None):
    """Phase (i); replay as in serve_bf16 (i-graph: every step of a
    recurrent plan is chunk 1, so every step replays). cfg: another bf16
    recurrent plan for the same traffic (z-serve: zamba2-1.2b, its
    Mamba-2 leaves perturbed), kind its kv_cache_dtype; paged: through
    Engine(paged=True, pages of 16), where a recurrent plan gets no
    prefix hit; after(eng, params): more fields for the result. Gates:
    one AltUp launch a layer a step, one WKV launch a rwkv layer a step,
    one decode-attention launch (the paged entry point when paged) a
    shared attention invocation a step, nothing else."""
    from repro_torch.models.transformer import init_params, layer_plan
    from repro_torch.serve.sampling import SamplingParams
    cfg = rwkv_config() if cfg is None else cfg        # bf16
    if kind is not None:
        cfg = cfg.replace(kv_cache_dtype=kind)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    params = init_params(cfg, seed=1, device=DEV)
    if cfg.family == "rwkv6":
        perturb_rwkv(torch, params, cfg, seed=22)
    else:
        perturb_mamba(torch, params, seed=22)
    params_bytes = sum(t.numel() * t.element_size()
                       for t in params.parameters())
    donor, batch = rwkv_traffic(torch, cfg.vocab_size)
    pkw = dict(paged=True, page_size=16) if paged else {}

    def engine(**kw):
        return engine_class(replay)(cfg, params, max_len=I_MAX_LEN,
                                    n_slots=I_SLOTS, device=DEV, **pkw, **kw)
    eng = engine()
    # warm-up request (cuBLAS handles, allocator) outside the counted run
    eng.submit(batch[1][:8], sampling=SamplingParams(max_new=4))
    eng.run()
    eng.reset_stats()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()     # the peak of this run only
    gs0 = eng.graph_stats
    ops.reset_launch_counts()                # counts start at 0 right here
    t_run = time.perf_counter()
    decode_ms, steps = [], 0

    def drive():
        nonlocal steps
        while eng.has_work:
            pf0 = eng.stats["prefill_tokens"]
            t0 = time.perf_counter()
            eng.step()                       # ends in the ids' device->host
            dt = time.perf_counter() - t0
            steps += 1
            if eng.stats["prefill_tokens"] == pf0:
                decode_ms.append(1e3 * dt)
    r_donor = eng.submit(donor, sampling=SamplingParams(max_new=1))
    drive()                                  # the donor retires at depth 64
    rids = [eng.submit(p, sampling=SamplingParams(max_new=I_NEW))
            for p in batch]
    drive()
    wall = time.perf_counter() - t_run
    counts = ops.launch_counts()             # read right after the run
    graph = graph_window(gs0, eng.graph_stats) if replay else None
    out = eng.collect()
    if sorted(out) != sorted([r_donor] + rids):
        raise AssertionError(f"not every request completed: {sorted(out)}")
    for rid in rids:
        c = out[rid]
        if len(c.tokens) != I_NEW or c.finish_reason != "length" or \
                not all(0 <= t < cfg.vocab_size for t in c.tokens):
            raise AssertionError(f"request {rid}: {c.finish_reason}, "
                                 f"{len(c.tokens)} tokens")
    st = dict(eng.stats)
    hits = (0, 0) if paged else (1, I_PREFIX)
    if (st["prefix_hits"], st["prefill_tokens_saved"]) != hits:
        raise AssertionError(f"not {hits[0]} prefix hit at the donor's "
                             f"depth: {st}")
    plan = layer_plan(cfg)
    attn = ("paged_ragged_decode_attention" if paged
            else "ragged_decode_attention")
    want = {"altup_predict_correct": max(s.layer_offset + s.n
                                         for s in plan),
            "rwkv6_wkv": sum(s.n for s in plan if s.kind == "rwkv"),
            attn: sum(s.n for s in plan if s.kind == "shared_attn")}
    warm = graph["warmup_launches"] if graph else dict.fromkeys(counts, 0)
    if any(counts[k] - warm[k] != want.get(k, 0) * steps for k in counts):
        raise AssertionError(f"launch counts {counts} (warm-ups {warm}) do "
                             f"not match {steps} steps of {want}")
    hit_tokens = list(out[rids[0]].tokens)
    trace = {"tokens": [out[r].tokens for r in [r_donor] + rids],
             "stats": step_stats(eng)}
    decode_ms.sort()
    res = {"cfg": cfg_name(cfg), "requests": 1 + len(rids),
           "donor_prompt": len(donor),
           "prompt_lens": [len(p) for p in batch], "new_tokens": I_NEW,
           "replay": replay, "graph": graph, "paged": paged,
           "kv_cache_dtype": kind or "auto", "params_bytes": params_bytes,
           "cache_bytes": cache_bytes(eng),
           "steps": steps, "decode_steps": len(decode_ms),
           "launches": counts,
           "launches_per_step": {k: (counts[k] - warm[k]) / steps
                                 for k in want},
           "prefix_hits": st["prefix_hits"],
           "prefill_tokens_saved": st["prefill_tokens_saved"],
           "prefill_tok_s": st["prefill_tokens"] / st["prefill_s"],
           "decode_tok_s": st["decode_tokens"] / st["decode_s"],
           "decode_step_ms_median": decode_ms[len(decode_ms) // 2],
           "decode_step_ms_p80": decode_ms[int(0.8 * len(decode_ms))],
           "decode_step_ms_min": decode_ms[0],
           "wall_s": wall,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    if paged:
        trace["paged_stats"] = dict(eng.paged_stats)
    if after is not None:
        res.update(after(eng, params))
    prof = (profile_decode(torch, ops, eng, batch[1:], replay) if profile
            else None)
    del eng
    if not paged:
        # the extender served cold, alone, on an engine of the same shape
        cold = engine(prefix_cache=False)
        rid = cold.submit(batch[0], sampling=SamplingParams(max_new=I_NEW))
        cold_tokens = list(cold.run()[rid].tokens)
        if cold_tokens != hit_tokens:
            raise AssertionError(f"the prefix hit serves other tokens than "
                                 f"a cold engine: {hit_tokens} vs "
                                 f"{cold_tokens}")
        res["hit_tokens_equal_cold"] = True
        del cold
    del params
    torch.cuda.empty_cache()
    return res, trace, prof


# ---------------------------------------------------------------------------
# (j) gemma3-4b + AltUp K=2: sliding windows over ring caches
# ---------------------------------------------------------------------------

# phase (j)'s traffic: 8 prompts from 64 to 1150 tokens, two of them past
# gemma3-4b's window of 1024 (their rings wrap during prefill), one of
# 1000 tokens (its rings wrap during decode), 40 new tokens each
J_PROMPTS, J_NEW = (64, 200, 420, 640, 860, 1000, 1100, 1150), 40
J_SLOTS, J_MAX_LEN = 8, 2048
# j-paged's traffic: a 600-token system prompt (served first, to put it in
# the prefix cache), then 8 requests of it plus a tail of 32-480 tokens,
# 32 new tokens each: the longer ones pass the window
J_SYSTEM, J_PAGED_NEW, J_PAGE = 600, 32, 16
# the depth at which j-serve and j-paged run their eager twin and the
# replayed run held against it (5 ring layers and 1 global: the plan's
# pattern once); the phase's numbers come from a replayed run at
# J_PAGED_LAYERS
J_TWIN_LAYERS = 6
# j-graph's and j-paged-graph's counted runs, cut for the run's time
# (the plan's pattern once of gemma3-4b's 34 layers)
J_PAGED_LAYERS = 6


def gemma_config(**kw):
    """gemma3-4b wrapped with AltUp K=2 (recycled: vocab > 100k)."""
    from repro_torch.configs import get_config
    return get_config("gemma3-4b", altup_k=2).replace(**kw)


def gemma_layers(cfg):
    """(ring layers, global layers) of the plan."""
    from repro_torch.models.transformer import layer_plan
    plan = layer_plan(cfg)
    ring = sum(s.n for s in plan if s.window > 0)
    return ring, sum(s.n for s in plan) - ring


def check_gemma_kernels(torch, ops, ref):
    """The fused AltUp and the decode attention at gemma3-4b's served
    shapes (j): AltUp at 8 tokens of d 2560; the decode attention at Dh
    320 (Hk 4, rep 2) halfway through (j), ring lengths (<= W, read
    through min(bucket, W)) on the local layers and full lengths on the
    global ones; the paged entry point at j-paged's halfway step (no page
    shared: a ring hit copies its pages); int8 codes (contiguous) and fp8
    codes (paged) at j-paged's ring shape, as j-quant serves them. Yields
    (tag, case, key, result)."""
    from repro_torch.serve.engine import kv_bucket
    cfg = gemma_config()
    W = cfg.window_size
    gemma = dict(Hk=cfg.n_kv_heads, rep=cfg.n_heads // cfg.n_kv_heads,
                 Dh=cfg.resolved_head_dim)
    j_lens = [n + J_NEW // 2 for n in J_PROMPTS]
    j_bucket = kv_bucket(max(j_lens), 32, J_MAX_LEN)
    _, jp_prompts, _ = gemma_traffic(torch, cfg.vocab_size, paged=True)
    jp_lens = [len(p) + J_PAGED_NEW // 2 for p in jp_prompts]
    jp_bucket = kv_bucket(max(jp_lens), 32, J_MAX_LEN)
    jp_ring = [min(n, W) for n in jp_lens]
    jp_paged = dict(reserve=[pages_for(len(p) + J_PAGED_NEW, J_PAGE)
                             for p in jp_prompts],
                    n_pages=J_SLOTS * J_MAX_LEN // J_PAGE, T=J_MAX_LEN,
                    page=J_PAGE, **gemma)
    for dtype in (torch.bfloat16, torch.float32):
        r = check_altup(torch, ops, ref, dtype, J_SLOTS, d=cfg.d_model)
        yield "c-altup", "j", (r["dtype"], "altup"), r
        for case, lens, t in (
                ("j-ring", [min(n, W) for n in j_lens], min(j_bucket, W)),
                ("j-global", j_lens, j_bucket)):
            r = check_ragged(torch, ops, ref, dtype, lens, T=t, **gemma)
            yield "c-ragged", case, (r["dtype"], case), r
        for case, lens, t in (
                ("j-paged-ring", jp_ring, min(jp_bucket, W)),
                ("j-paged-global", jp_lens, jp_bucket)):
            r = check_paged(torch, ops, ref, dtype, lens, t_max=t,
                            **jp_paged)
            yield "c-paged", case, (r["dtype"], case), r
    r = check_ragged(torch, ops, ref, torch.bfloat16, jp_ring,
                     T=min(jp_bucket, W), store="int8", **gemma)
    yield "c-ragged-quant", "j-quant-ring", \
        ("bfloat16", "j-quant-ring", "int8"), r
    r = check_paged(torch, ops, ref, torch.bfloat16, jp_ring,
                    t_max=min(jp_bucket, W), store="fp8", **jp_paged)
    yield "c-paged-quant", "j-quant-ring", \
        ("bfloat16", "j-quant-ring", "fp8"), r


def gemma_parity_f32(torch):
    """j-parity: full-width f32 decode_step logits of the kernel path
    ("k") and the paged kernel path ("p", a permuted block table) against
    the dense path ("d") on gemma3-4b + AltUp K=2: a prefill of 1100 and
    1013 tokens in direct chunks of 64 (each chunk reads its rings before
    writing, across the wrap), then 16 greedy S=1 steps (slot 1 wraps
    during them). Logits within PARITY_TOL every step, greedy tokens
    identical, every cache row below the sink within PARITY_TOL, and the
    dense path's logits at the last prompt position and each decode step
    within PARITY_TOL of `forward` on the same tokens."""
    from repro_torch.models.decode import (decode_step, init_cache,
                                           init_paged_cache, _gather_rows)
    from repro_torch.models.transformer import forward, init_params
    from repro_torch.serve.engine import kv_bucket
    torch.backends.cuda.matmul.allow_tf32 = False   # full f32 products
    torch.backends.cudnn.allow_tf32 = False
    cfg = gemma_config(dtype="float32", param_dtype="float32")
    cfgs = {"k": cfg.replace(ragged_decode_attn=None,
                             fused_decode_altup=None),
            "d": cfg.replace(ragged_decode_attn=False,
                             fused_decode_altup=False)}
    cfgs["p"] = cfgs["k"]
    params = init_params(cfg, seed=0, device=DEV)
    perturb_altup(torch, params, seed=30)
    B, T, C, n_dec, page = 2, J_MAX_LEN, 64, 16, 16
    gen = torch.Generator(device=DEV).manual_seed(31)
    plens = [1100, 1013]
    prompts = [torch.randint(0, cfg.vocab_size, (n,), generator=gen,
                             device=DEV) for n in plens]
    n_pages = B * T // page
    caches = {s: init_cache(cfgs[s], B, T, device=DEV) for s in "kd"}
    caches["p"] = init_paged_cache(cfgs["p"], B, T, n_pages=n_pages,
                                   page=page, device=DEV)
    bt = torch.randperm(n_pages, generator=gen, device=DEV).reshape(
        B, T // page).to(torch.int32)
    pkw = {"k": {}, "d": {}, "p": {"block_table": bt, "page_size": page}}
    sides = ("k", "p", "d")
    pos = [0] * B
    worst = {"k": 0.0, "p": 0.0}
    dense_rows = [[] for _ in range(B)]      # the dense path's logits
    last = {}
    t0 = time.perf_counter()
    while any(pos[b] < plens[b] for b in range(B)):
        toks = torch.zeros(B, C, dtype=torch.long, device=DEV)
        nval = [min(C, plens[b] - pos[b]) for b in range(B)]
        for b in range(B):
            toks[b, :nval[b]] = prompts[b][pos[b]:pos[b] + nval[b]]
        kv_len = kv_bucket(max(p + n for p, n in zip(pos, nval)), 32, T)
        out = {}
        for side in sides:
            out[side], _ = decode_step(
                params, cfgs[side], caches[side], toks,
                torch.tensor(pos, device=DEV),
                n_valid=torch.tensor(nval, device=DEV), kv_len=kv_len,
                **pkw[side])
        for b in range(B):
            if nval[b]:
                rows = {s: out[s][b, :nval[b], :cfg.vocab_size]
                        for s in sides}
                for s in worst:
                    torch.testing.assert_close(rows[s], rows["d"],
                                               **PARITY_TOL)
                    worst[s] = max(worst[s],
                                   max_err(torch, rows[s], rows["d"]))
                if pos[b] + nval[b] == plens[b]:
                    last[b] = {s: rows[s][-1] for s in sides}
                    dense_rows[b].append(rows["d"][-1])
        pos = [p + n for p, n in zip(pos, nval)]
    prefill_s = time.perf_counter() - t0
    tok = {s: torch.stack([last[b][s].argmax() for b in range(B)])
           for s in sides}
    streams = {s: [tok[s].tolist()] for s in sides}
    for _ in range(n_dec):
        kv_len = kv_bucket(max(pos) + 1, 32, T)
        lg = {}
        for side in sides:
            logits, _ = decode_step(
                params, cfgs[side], caches[side], tok[side][:, None],
                torch.tensor(pos, device=DEV), kv_len=kv_len, **pkw[side])
            lg[side] = logits[:, 0, :cfg.vocab_size]
        for s in worst:
            torch.testing.assert_close(lg[s], lg["d"], **PARITY_TOL)
            worst[s] = max(worst[s], max_err(torch, lg[s], lg["d"]))
        for b in range(B):
            dense_rows[b].append(lg["d"][b])
        for side in sides:
            tok[side] = lg[side].argmax(dim=-1)
            streams[side].append(tok[side].tolist())
        pos = [p + 1 for p in pos]
    if not streams["k"] == streams["p"] == streams["d"]:
        raise AssertionError(f"greedy tokens differ between the kernel, "
                             f"paged kernel and dense paths: {streams}")
    # every cache row below the sink: the contiguous kernel side against
    # the dense side, and the paged side's logical rows (the first W of a
    # ring segment) against the dense side's
    cache_err = {"k": 0.0, "p": 0.0}
    for si, seg in caches["d"].items():
        for name, want in seg.items():
            rows = want.shape[2] - 1
            got = caches["k"][si][name][:, :, :rows]
            torch.testing.assert_close(got, want[:, :, :rows], **PARITY_TOL)
            cache_err["k"] = max(cache_err["k"],
                                 max_err(torch, got, want[:, :, :rows]))
            grows = _gather_rows(bt, page, rows)
            pg = caches["p"][si][name][:, grows]
            torch.testing.assert_close(pg, want[:, :, :rows], **PARITY_TOL)
            cache_err["p"] = max(cache_err["p"],
                                 max_err(torch, pg, want[:, :, :rows]))
    # the dense path against forward on the same tokens: the last prompt
    # position and the 16 decode steps' positions
    fwd_err = 0.0
    for b in range(B):
        fed = torch.tensor([s[b] for s in streams["d"][:-1]], device=DEV)
        seq = torch.cat([prompts[b], fed])[None]
        with torch.no_grad():
            logits = forward(params, cfgs["d"], seq)[0, plens[b] - 1:,
                                                     :cfg.vocab_size]
        got = torch.stack(dense_rows[b])
        torch.testing.assert_close(got, logits, **PARITY_TOL)
        fwd_err = max(fwd_err, max_err(torch, got, logits))
        del logits
    ring, glob = gemma_layers(cfg)
    del params, caches
    torch.cuda.empty_cache()
    return {"config": cfg.name, "d_model": cfg.d_model,
            "head_dim": cfg.resolved_head_dim, "ring_layers": ring,
            "global_layers": glob, "window": cfg.window_size, "slots": B,
            "prompt_lens": plens, "prefill_chunk": C, "decode_steps": n_dec,
            "max_abs_logit_err": worst["k"],
            "paged_max_abs_logit_err": worst["p"],
            "cache_max_abs_err": cache_err["k"],
            "paged_cache_max_abs_err": cache_err["p"],
            "forward_max_abs_logit_err": fwd_err, "tol": PARITY_TOL,
            "greedy_tokens_identical": True,
            "tokens_checked": B * (n_dec + 1), "prefill_s": prefill_s,
            "tf32": [torch.backends.cuda.matmul.allow_tf32,
                     torch.backends.cudnn.allow_tf32]}


def gemma_traffic(torch, vocab, paged):
    """(j)'s prompts (seed 32), or j-paged's system prompt and batch
    (seed 33): returns (warm prompt or None, prompts, new tokens)."""
    if not paged:
        gen = torch.Generator().manual_seed(32)
        return None, [torch.randint(0, vocab, (n,), generator=gen).tolist()
                      for n in J_PROMPTS], J_NEW
    gen = torch.Generator().manual_seed(33)
    system = torch.randint(0, vocab, (J_SYSTEM,), generator=gen).tolist()
    tails = torch.randint(32, 481, (J_SLOTS,), generator=gen).tolist()
    return system, [system + torch.randint(0, vocab, (n,),
                                           generator=gen).tolist()
                    for n in tails], J_PAGED_NEW


def serve_gemma(torch, ops, kind=None, replay=False, paged=False,
                prefix_cache=False, cold_check=False, n_layers=None):
    """Phase (j) and its twins on gemma3-4b + AltUp K=2 in bf16 through
    Engine(n_slots=8, max_len=2048), at full depth or, n_layers given, cut
    to that many layers (full width). Ring plans prefill one token per
    step, so every step is S=1: each launches the fused AltUp kernel and
    the ragged decode kernel (its paged variant, paged=True) once per
    layer, 29 on rings and 5 on global caches, and each replays a graph
    when replay=True. kind "int8" / "fp8": quantized caches. paged /
    prefix_cache: j-paged's traffic (a served system prompt, then 8
    requests that extend it) over a pool of pages of 16 rows with prefix
    reuse; a paged ring hit aliases no page and copies every prefix page.
    cold_check: the batch served again on a cold engine (prefix cache
    off, replayed) must give every hit's tokens."""
    from repro_torch.models.transformer import init_params
    from repro_torch.serve.sampling import SamplingParams
    cfg = gemma_config(**({} if n_layers is None
                          else {"n_layers": n_layers}))    # bf16
    if kind is not None:
        cfg = cfg.replace(kv_cache_dtype=kind)
    params = init_params(cfg, seed=1, device=DEV)
    perturb_altup(torch, params, seed=34)
    warm_prompt, prompts, n_new = gemma_traffic(torch, cfg.vocab_size,
                                                paged=prefix_cache)
    kw = dict(paged=True, page_size=J_PAGE) if paged else {}

    def engine(cls, prefix):
        return cls(cfg, params, max_len=J_MAX_LEN, n_slots=J_SLOTS,
                   prefix_cache=prefix, device=DEV, **kw)
    eng = engine(engine_class(replay), prefix_cache)
    # the warm request: the system prompt, whose retained rows the batch
    # reuses (it stops at depth 631 <= max(600, W): a valid ring donor),
    # or a short request (cuBLAS handles, allocator). It replays its
    # steps on both twins (632 chunk-1 steps take ~45 s eager); the
    # counted run below is eager on the eager twin
    warm = warm_prompt if warm_prompt is not None else prompts[0][:16]
    eng.eager = False
    eng.submit(warm, sampling=SamplingParams(max_new=n_new))
    eng.run()
    eng.eager = not replay
    eng.reset_stats()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()     # the peak of this run only
    gs0 = eng.graph_stats
    with page_ops(torch, check=False) as pops:
        ops.reset_launch_counts()            # counts start at 0 right here
        t_run = time.perf_counter()
        rids = [eng.submit(p, sampling=SamplingParams(max_new=n_new))
                for p in prompts]
        step_ms, decode_ms, steps = [], [], 0
        while eng.has_work:
            pf0 = eng.stats["prefill_tokens"]
            t0 = time.perf_counter()
            eng.step()                       # ends in the ids' device->host
            dt = 1e3 * (time.perf_counter() - t0)
            steps += 1
            step_ms.append(dt)
            if eng.stats["prefill_tokens"] == pf0:
                decode_ms.append(dt)
        wall = time.perf_counter() - t_run
        counts = ops.launch_counts()         # read right after the run
    graph = graph_window(gs0, eng.graph_stats) if replay else None
    out = eng.collect()
    if sorted(out) != sorted(rids):
        raise AssertionError(f"not every request completed: {sorted(out)}")
    for rid in rids:
        c = out[rid]
        if len(c.tokens) != n_new or c.finish_reason != "length" or \
                not all(0 <= t < cfg.vocab_size for t in c.tokens):
            raise AssertionError(f"request {rid}: {c.finish_reason}, "
                                 f"{len(c.tokens)} tokens")
    st, ps = dict(eng.stats), eng.paged_stats
    if sorted(eng._inputs) != [1]:
        raise AssertionError(f"a ring plan stepped at chunk widths "
                             f"{sorted(eng._inputs)}, not 1 alone")
    ring, glob = gemma_layers(cfg)
    n_layers = cfg.n_layers
    attn = "paged_ragged_decode_attention" if paged \
        else "ragged_decode_attention"
    other = "ragged_decode_attention" if paged \
        else "paged_ragged_decode_attention"
    warm_l = graph["warmup_launches"] if graph else \
        dict.fromkeys(counts, 0)
    if ring + glob != n_layers or \
            counts[attn] - warm_l[attn] != n_layers * steps or \
            counts["altup_predict_correct"] - \
            warm_l["altup_predict_correct"] != n_layers * steps or \
            counts[other] != 0:
        raise AssertionError(f"launch counts {counts} (warm-ups {warm_l}) "
                             f"do not match {steps} S=1 steps of "
                             f"{n_layers} layers")
    res = {"config": cfg.name, "requests": len(rids),
           "prompt_lens": [len(p) for p in prompts], "new_tokens": n_new,
           "window": cfg.window_size, "ring_layers": ring,
           "global_layers": glob, "paged": paged,
           "prefix_cache": prefix_cache, "replay": replay, "graph": graph,
           "kv_cache_dtype": kind or "auto", "cache_bytes": cache_bytes(eng),
           "steps": steps, "decode_steps": len(decode_ms),
           "launches": counts,
           "attn_launches_per_step": (counts[attn] - warm_l[attn]) / steps,
           "altup_launches_per_step":
               (counts["altup_predict_correct"]
                - warm_l["altup_predict_correct"]) / steps,
           "prefill_tok_s": st["prefill_tokens"] / st["prefill_s"],
           "decode_tok_s": st["decode_tokens"] / st["decode_s"],
           "wall_s": wall,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    step_ms.sort()
    decode_ms.sort()
    res.update({"step_ms_median": step_ms[len(step_ms) // 2],
                "step_ms_p80": step_ms[int(0.8 * len(step_ms))],
                "decode_step_ms_median": decode_ms[len(decode_ms) // 2],
                "decode_step_ms_p80": decode_ms[int(0.8 * len(decode_ms))]})
    if prefix_cache:
        hits = st["prefix_hits"]
        npp = pages_for(J_SYSTEM, J_PAGE)
        res.update({"prefix_hits": hits,
                    "prefill_tokens_saved": st["prefill_tokens_saved"]})
        if hits < 1:
            raise AssertionError(f"no prefix hit: {st}")
        if paged:
            # a ring hit copies every prefix page and aliases none
            if ps["alias_acquisitions"] != 0 or pops["copies"] != hits or \
                    pops["copied_pages"] != hits * npp:
                raise AssertionError(f"{hits} hits, {pops}, {ps}: not "
                                     f"{npp} copied pages and no alias "
                                     f"each")
            res.update({"paged_stats": ps, "page_copies": pops["copies"],
                        "copied_pages": pops["copied_pages"],
                        "prefix_pages": npp})
    if replay:
        # device ms of one replayed step (the most replayed shape)
        res.update(replay_gaps(torch, eng))
    trace = {"tokens": [out[r].tokens for r in rids],
             "stats": step_stats(eng), "paged_stats": ps}
    del eng
    if cold_check:
        cold = engine(engine_class(True), False)
        crids = [cold.submit(p, sampling=SamplingParams(max_new=n_new))
                 for p in prompts]
        cout = cold.run()
        cold_tokens = [cout[r].tokens for r in crids]
        if cold_tokens != trace["tokens"]:
            raise AssertionError(f"prefix hits serve other tokens than a "
                                 f"cold engine: {trace['tokens']} vs "
                                 f"{cold_tokens}")
        res["hit_tokens_equal_cold"] = True
        del cold
    del params
    torch.cuda.empty_cache()
    return res, trace


# ---------------------------------------------------------------------------
# (k) training: gradients, a full-width run, resume, serving the result
# ---------------------------------------------------------------------------

K_GRAD_TOL = 1e-4        # per leaf: max|Δgrad| <= 1e-4 · max|grad|
K_LOSS_RTOL = 1e-5


def cfg_name(cfg):
    alt = cfg.altup
    return (f"{cfg.name} + AltUp K={alt.K}"
            f"{' recycled' if alt.recycled else ''}, {cfg.n_layers} "
            f"layers, {cfg.dtype}")


def to_device(params, device, dtype=None):
    """A copy of a ParamTree on `device` (cast to `dtype` if given), its
    leaves as trainable as the original's."""
    from repro_torch import tree as tree_lib
    from repro_torch.models.transformer import ParamTree
    leaves = tree_lib.leaves(params)
    return ParamTree(tree_lib.from_paths(
        (p, x.detach().to(device=device, dtype=dtype or x.dtype))
        for p, x in leaves)).requires_grad_(leaves[0][1].requires_grad)


def grads_on(torch, params, cfg, batch, loss=None):
    """(loss, {path: grad}) of loss_fn (or of `loss(params, batch)`)."""
    from repro_torch import tree as tree_lib
    from repro_torch.models.model import loss_fn
    paths, leaves = zip(*tree_lib.leaves(params))
    total = (loss_fn(params, cfg, batch)[0] if loss is None
             else loss(params, batch))
    grads = torch.autograd.grad(total, leaves)
    return float(total.detach()), dict(zip(paths, grads))


def worst_leaf(torch, got, want):
    """The leaf with the largest max|got - want| / max|want|: (ratio,
    path). Compared on got's device (want's leaves copied there)."""
    worst = (0.0, None)
    for path, w in want.items():
        g = got[path].float()
        w = w.to(g.device).float()
        scale = float(w.abs().max())
        err = float((g - w).abs().max())
        ratio = err / scale if scale else (0.0 if err == 0 else math.inf)
        if ratio > worst[0] or worst[1] is None:
            worst = (ratio, "/".join(path))
    return worst


def batch_on(torch, batch, device):
    return {k: torch.from_numpy(v).to(device) for k, v in batch.items()}


def train_grad_f32(torch, ops):
    """k-grad: loss_fn and every leaf's gradient on the card against the
    CPU, full width (Qwen3-0.6B + AltUp K=2, recycled), 2 layers, f32,
    TF32 off, from one seeded init copied to both devices; the fused and
    the plain cross entropy (no z-loss) on the card; remat "full" against
    "none" on the card; the port's kernel launch counts unchanged across
    the differentiated steps."""
    from repro_torch.data.pipeline import lm_batch
    from repro_torch.models import model as M
    from repro_torch.models.transformer import forward, init_params
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = served_config(n_layers=2, dtype="float32", param_dtype="float32")
    cpu = init_params(cfg, seed=20, device="cpu").requires_grad_(True)
    perturb_altup(torch, cpu, seed=21)
    dev = to_device(cpu, DEV)
    nb = lm_batch(cfg, 2, 256, seed=0, step=0)
    nb["mask"][1, :40] = 0.0                 # a masked stretch
    t0 = time.perf_counter()
    loss_cpu, g_cpu = grads_on(torch, cpu, cfg.replace(remat="none"),
                               batch_on(torch, nb, "cpu"))
    cpu_s = time.perf_counter() - t0
    bd = batch_on(torch, nb, DEV)
    c0 = ops.launch_counts()
    loss_dev, g_dev = grads_on(torch, dev, cfg, bd)           # remat full
    loss_none, g_none = grads_on(torch, dev, cfg.replace(remat="none"), bd)

    def xent(fused):
        def loss(params, batch):
            logits = forward(params, cfg, batch["tokens"], train=True)
            logits = logits.masked_fill(
                torch.arange(logits.shape[-1], device=DEV)
                >= cfg.vocab_size, -1e30)
            return M.cross_entropy(logits, batch["labels"], batch["mask"],
                                   z_loss=0.0, fused=fused)[0]
        return loss
    loss_plain, g_plain = grads_on(torch, dev, cfg, bd, loss=xent(False))
    loss_fused, g_fused = grads_on(torch, dev, cfg, bd, loss=xent(True))
    torch.cuda.synchronize()
    c1 = ops.launch_counts()
    res = {"cfg": cfg_name(cfg), "B": 2,
           "S": 256, "leaves": len(g_cpu), "cpu_s": cpu_s,
           "loss_cuda": loss_dev, "loss_cpu": loss_cpu,
           "loss_rel_err": abs(loss_dev - loss_cpu) / abs(loss_cpu),
           "launches_while_differentiating": {
               k: c1[k] - c0[k] for k in c1 if c1[k] != c0[k]}}
    for tag, got, want in (("cuda_vs_cpu", g_dev, g_cpu),
                           ("remat_full_vs_none", g_dev, g_none),
                           ("fused_vs_plain_xent", g_fused, g_plain)):
        ratio, path = worst_leaf(torch, got, want)
        res[tag] = {"worst_leaf": path, "max_err_over_max": ratio}
        if not ratio <= K_GRAD_TOL:
            raise AssertionError(f"k-grad {tag}: leaf {path} off by "
                                 f"{ratio:.3e} of its max (gate "
                                 f"{K_GRAD_TOL})")
    res["xent_loss_rel_err"] = abs(loss_fused - loss_plain) / loss_plain
    res["remat_loss_rel_err"] = abs(loss_none - loss_dev) / loss_dev
    if not (res["loss_rel_err"] <= K_LOSS_RTOL
            and res["xent_loss_rel_err"] <= K_LOSS_RTOL
            and res["remat_loss_rel_err"] <= K_LOSS_RTOL):
        raise AssertionError(f"k-grad losses apart: {res}")
    if res["launches_while_differentiating"]:
        raise AssertionError(f"the differentiated path launched kernels: "
                             f"{res['launches_while_differentiating']}")
    del cpu, dev, g_cpu, g_dev, g_none, g_plain, g_fused
    torch.cuda.empty_cache()
    return res


# cut for the run's time
K_STEPS, K_BATCH, K_SEQ, K_MB, K_LR = 10, 8, 512, 2, 0.3


def train_full(torch, ops, workdir):
    """k-train: Trainer(device="cuda") on the registry's full qwen3-0.6b +
    AltUp K=2 (28 layers, bf16), the launcher's TrainConfig at K_STEPS
    steps of 8 x 512 tokens in 2 microbatches (Adafactor, lr 0.3, warmup 10).
    Gates: finite losses, the mean of the last 5 at least 1 nat below the
    first. Then one more step under torch.profiler (device time, top
    kernels) and the plain attention's and the cross entropy's device ms
    at the step's shapes, timed alone. Returns (result, trainer)."""
    import numpy as np
    from repro_torch.launch.train import train_config
    from repro_torch.models import layers as Lyr
    from repro_torch.models import model as M
    from repro_torch.models.transformer import padded_vocab
    from repro_torch.train.trainer import Trainer
    cfg = served_config()
    tcfg = train_config(K_STEPS, K_BATCH, K_SEQ, K_MB, K_LR,
                        str(workdir / "k-train"))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    c0 = ops.launch_counts()
    t0 = time.perf_counter()
    tr = Trainer(cfg, tcfg, device=DEV)
    logs = []
    out = tr.run(log=logs.append)
    run_s = time.perf_counter() - t0
    c1 = ops.launch_counts()
    losses = [h["loss"] for h in out["history"]]
    med_s = float(np.median(tr.step_times[2:]))
    tokens = K_BATCH * K_SEQ
    flops_tok = M.model_flops_per_token(cfg)
    res = {"cfg": cfg_name(cfg),
           "steps": out["step"], "tokens_per_step": tokens,
           "microbatches": K_MB, "run_s": run_s,
           "first_step_s": tr.step_times[0],
           "median_step_ms_from_3": 1e3 * med_s,
           "p80_step_ms_from_3": 1e3 * float(
               np.percentile(tr.step_times[2:], 80)),
           "tokens_per_s": tokens / med_s,
           "model_flops_per_token": flops_tok,
           "mfu_bf16_dense_peak": flops_tok * tokens / med_s
           / hardware("bfloat16").peak_flops,
           "max_memory_allocated": torch.cuda.max_memory_allocated(),
           "loss_first": losses[0], "loss_last5_mean": sum(losses[-5:]) / 5,
           "losses": losses, "accuracy_last": out["history"][-1]["accuracy"],
           "stragglers": out["stragglers"], "log": logs,
           "launches": {k: c1[k] - c0[k] for k in c1 if c1[k] != c0[k]}}
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"k-train: a loss is not finite: {losses}")
    if not res["loss_last5_mean"] <= losses[0] - 1.0:
        raise AssertionError(f"k-train: the last 5 losses average "
                             f"{res['loss_last5_mean']:.4f}, not 1 nat "
                             f"below the first {losses[0]:.4f}")
    if res["launches"]:
        raise AssertionError(f"k-train launched kernels: {res['launches']}")
    res.update(profile_train_step(torch, tr, med_s))
    # the plain attention and the cross entropy at the step's shapes,
    # alone: each microbatch runs every layer's attention forward, again
    # in the recompute (remat "full") and backward; the loss once and
    # its backward
    B, S = K_BATCH // K_MB, K_SEQ
    g = torch.Generator(device=DEV).manual_seed(5)
    H, Hk, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim

    def leaf(*shape):
        return torch.randn(*shape, generator=g, device=DEV,
                           dtype=torch.bfloat16).requires_grad_(True)
    q, k, v = leaf(B, S, H, Dh), leaf(B, S, Hk, Dh), leaf(B, S, Hk, Dh)
    pos = torch.arange(S, device=DEV)

    def attn():
        return Lyr.sdpa(q, k, v, causal=True, window=0, q_pos=pos,
                        k_pos=pos)

    def attn_fwd():
        with torch.no_grad():
            attn()

    def attn_fwd_bwd():
        torch.autograd.grad(attn().float().sum(), (q, k, v))
    logits = leaf(B, S, padded_vocab(cfg))
    labels = torch.randint(0, cfg.vocab_size, (B, S), generator=g,
                           device=DEV)

    def xent_fwd_bwd():
        lg = logits.masked_fill(torch.arange(logits.shape[-1], device=DEV)
                                >= cfg.vocab_size, -1e30)
        loss, _ = M.cross_entropy(lg, labels)
        torch.autograd.grad(loss, (logits,))
    def dev_ms(fn):
        return time_ms(torch, fn, iters=10, warmup=2)
    a_ms = K_MB * cfg.n_layers * (dev_ms(attn_fwd) + dev_ms(attn_fwd_bwd))
    x_ms = K_MB * dev_ms(xent_fwd_bwd)
    res.update({"attention_ms_per_step_alone": a_ms,
                "attention_share_of_median_step": a_ms / (1e3 * med_s),
                "xent_ms_per_step_alone": x_ms,
                "xent_share_of_median_step": x_ms / (1e3 * med_s)})
    del q, k, v, logits
    tr.opt_state = None
    torch.cuda.empty_cache()
    return res, tr


def profile_train_step(torch, tr, med_s):
    """One more train step under torch.profiler: the device time of its
    kernels (against the unprofiled median step: the device busy share)
    and its top kernels by device time."""
    from torch.profiler import ProfilerActivity, profile
    batch = tr._batch(tr.step)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda._sleep(1)                 # takes a lost first record
        t0 = time.perf_counter()
        tr.params, tr.opt_state, _ = tr._step_fn(tr.params, tr.opt_state,
                                                 batch, tr.step)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    tr.step += 1
    kern = sorted((e for e in _device_kernels(prof) if MARKER not in e.key),
                  key=lambda e: -e.self_device_time_total)
    dev_us = sum(e.self_device_time_total for e in kern)
    if not dev_us:
        raise AssertionError("the profiled train step recorded no kernel")
    return {"profiled_step_wall_ms": 1e3 * wall,
            "profiled_step_device_ms": dev_us / 1e3,
            "profiled_step_kernels": sum(e.count for e in kern),
            "device_busy_share_of_median_step": (dev_us / 1e6) / med_s,
            "top_kernels": [[e.key[:70], e.count,
                             e.self_device_time_total / 1e3,
                             e.self_device_time_total / dev_us]
                            for e in kern[:12]]}


def train_resume(torch, workdir):
    """k-resume: full width, 4 layers, bf16: 6 steps straight against 3
    steps, a checkpoint, a new Trainer resumed from it and 3 more steps,
    deterministic algorithms on (the embedding's backward otherwise
    scatters with atomics): the same final loss. The checkpoint read back
    by bridge.load_npz equals the parameters it was written from, bit
    for bit."""
    import dataclasses
    from repro_torch import bridge
    from repro_torch import tree as tree_lib
    from repro_torch.train import checkpoint as ckpt_lib
    from repro_torch.train.trainer import Trainer
    from repro_torch.launch.train import train_config
    cfg = served_config(n_layers=4)
    base = train_config(6, 4, 256, 1, K_LR, str(workdir / "k-resume-a"))
    straight = dataclasses.replace(base, checkpoint_every=0)
    first = dataclasses.replace(base, steps=3, checkpoint_every=3,
                                checkpoint_dir=str(workdir / "k-resume-b"))
    rest = dataclasses.replace(first, steps=6, checkpoint_every=0)
    torch.use_deterministic_algorithms(True)
    try:
        r_straight = Trainer(cfg, straight, device=DEV).run(
            log=lambda s: None)
        tr = Trainer(cfg, first, device=DEV)
        tr.run(log=lambda s: None)
        saved = {p: x.detach().cpu() for p, x in tree_lib.leaves(tr.params)}
        del tr
        tr = Trainer(cfg, rest, device=DEV)
        if not (tr.maybe_resume() and tr.step == 3):
            raise AssertionError("k-resume: no checkpoint at step 3")
        r_resumed = tr.run(log=lambda s: None)
    finally:
        torch.use_deterministic_algorithms(False)
    a, b = r_straight["final_loss"], r_resumed["final_loss"]
    rel = abs(a - b) / abs(a)
    if not rel <= K_LOSS_RTOL:
        raise AssertionError(f"k-resume: final loss {b} against {a} "
                             f"straight")
    path = Path(first.checkpoint_dir) / "step-000000003" / "arrays.npz"
    loaded = bridge.load_npz(str(path), device="cpu")
    bad = [("/".join(p)) for p, x in tree_lib.leaves(loaded)
           if not torch.equal(x, saved[p])]
    if bad or len(saved) != len(tree_lib.leaves(loaded)):
        raise AssertionError(f"k-resume: load_npz differs at {bad[:3]}")
    del tr
    torch.cuda.empty_cache()
    return {"cfg": cfg_name(cfg),
            "steps": 6, "tokens_per_step": 4 * 256,
            "final_loss_straight": a, "final_loss_resumed": b,
            "final_loss_rel_err": rel,
            "losses_resumed": [h["loss"] for h in r_resumed["history"]],
            "checkpoint_bytes": path.stat().st_size,
            "load_npz_bitwise_leaves": len(saved)}


def serve_trained(torch, ops, params):
    """k-serve: k-train's weights (AltUp p and g moved off I and g_init by
    training) through Engine(device="cuda"): 4 prompts of the pipeline,
    16 greedy tokens, once through the kernels (fused AltUp and ragged
    decode attention, decode steps replayed from CUDA graphs) and once
    with both turned off. Served in f32 (the bf16 weights cast exactly),
    as the d phases hold the kernel path against the dense one: tokens
    identical, chosen-token logprobs within 1e-3, the kernels launched
    (the weights serve as the trainer left them, trainable: the engine's
    steps run without autograd)."""
    from repro_torch import tree as tree_lib
    from repro_torch.data.pipeline import lm_batch
    from repro_torch.serve.engine import Engine
    from repro_torch.serve.sampling import SamplingParams
    cfg = served_config(dtype="float32", param_dtype="float32")
    p32 = to_device(params, DEV, torch.float32)
    moved = {"altup_p_max_off_identity": 0.0, "altup_g_max_off_init": 0.0}
    with torch.no_grad():
        for path, x in tree_lib.leaves(p32):
            if path[-1] == "altup_p":
                off = x - torch.eye(x.shape[-1], device=DEV)
                key = "altup_p_max_off_identity"
            elif path[-1] == "altup_g":
                off = x - cfg.altup.g_init
                key = "altup_g_max_off_init"
            else:
                continue
            moved[key] = max(moved[key], float(off.abs().max()))
    if not min(moved.values()) > 0:
        raise AssertionError(f"k-serve: AltUp scalars did not move: {moved}")
    prompts = lm_batch(cfg, 4, 64, seed=1, step=10_000)["tokens"].tolist()
    out = {}
    for tag, flags in (("kernels", {}),
                       ("dense", dict(fused_decode_altup=False,
                                      ragged_decode_attn=False))):
        eng = Engine(cfg.replace(**flags), p32, max_len=256, n_slots=4,
                     prefix_cache=False, device=DEV)
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        rids = [eng.submit(p, sampling=SamplingParams(max_new=16,
                                                      logprobs=True))
                for p in prompts]
        done = eng.run()
        counts = ops.launch_counts()
        out[tag] = {"tokens": [list(done[r].tokens) for r in rids],
                    "logprobs": [list(done[r].logprobs) for r in rids],
                    "launches": {k: n for k, n in counts.items() if n},
                    "replays": eng.graph_stats["replays"]}
        del eng
    if out["kernels"]["tokens"] != out["dense"]["tokens"]:
        raise AssertionError(f"k-serve: kernel tokens "
                             f"{out['kernels']['tokens']} against dense "
                             f"{out['dense']['tokens']}")
    lp_err = max(abs(a - b) for ra, rb in zip(out["kernels"]["logprobs"],
                                              out["dense"]["logprobs"])
                 for a, b in zip(ra, rb))
    if not lp_err <= PARITY_TOL["atol"]:
        raise AssertionError(f"k-serve: chosen-token logprobs {lp_err} "
                             f"apart")
    kl = out["kernels"]["launches"]
    if not (kl.get("altup_predict_correct", 0) > 0
            and kl.get("ragged_decode_attention", 0) > 0):
        raise AssertionError(f"k-serve: kernels not launched: {kl}")
    if out["dense"]["launches"]:
        raise AssertionError(f"k-serve: the dense path launched "
                             f"{out['dense']['launches']}")
    del p32
    torch.cuda.empty_cache()
    return {**moved, "prompts": 4, "prompt_len": 64, "new": 16,
            "tokens_identical": True, "tokens": out["kernels"]["tokens"],
            "logprob_max_abs_diff": lp_err,
            "logprobs_first": out["kernels"]["logprobs"][0][:4],
            "launches_kernels": kl,
            "replays_kernels": out["kernels"]["replays"],
            "replays_dense": out["dense"]["replays"]}


# ---------------------------------------------------------------------------
# (s) self-speculative decoding: AltUp drafts, a chunk verify, rollback
# ---------------------------------------------------------------------------

# s-parity (f32): two requests a case; the ring case's one request decodes
# across the wrap of its 1024-row rings
S_PROMPTS, S_NEW = (45, 150), 24
S_DONOR_SHARED = 130          # the paged case's prefix hit, in rows
S_RING_PROMPT, S_RING_NEW, S_RING_LAYERS = 1000, 48, 12
# the "penalty" case: a full-depth draft (every draft accepted) under a
# repetition penalty, chosen-token logprobs held to S_LP_TOL
S_PENALTY, S_LP_TOL = 1.4, 1e-3
# s-serve (bf16): the single stream; the 8-slot load is (e)'s traffic
S_SINGLE_PROMPT, S_SINGLE_NEW = 288, 64


def spec_rounds(eng, ring, before=None):
    """What the speculative rounds of a run did, from the engine's round
    graphs (counters since the snapshot `before`, or the engine's life):
    replays of each phase, the draft graphs' kernel launches, all the
    rounds' launches a round, captures and their seconds. Gate: every
    round replayed one draft and one verify graph, and on a ring plan one
    post-verify restore: no round ran eagerly."""
    gs = eng.spec_graph_stats
    b = before or {"replays_by_shape": {}, "captures": 0, "capture_s": 0.0}
    st = eng.stats
    rounds = st["spec_rounds"]
    phases, draft, total = {}, {}, {}
    for key, n in gs["replays_by_shape"].items():
        n -= b["replays_by_shape"].get(key, 0)
        phases[key[0]] = phases.get(key[0], 0) + n
        for kern, m in gs["launches_per_replay"][key].items():
            total[kern] = total.get(kern, 0) + n * m
            if key[0] == "draft":
                draft[kern] = draft.get(kern, 0) + n * m
    want = {"draft": rounds, "verify": rounds}
    if ring:
        want["restore"] = rounds
    if {k: n for k, n in phases.items() if n} != want:
        raise AssertionError(f"round graph replays {phases} for {rounds} "
                             f"rounds")
    drafted = st["spec_drafted"]
    return {"spec_rounds": rounds, "spec_drafted": drafted,
            "spec_accepted": st["spec_accepted"],
            "accept_rate": st["spec_accepted"] / max(drafted, 1),
            "mean_k": st["spec_k_sum"] / max(rounds, 1),
            "tokens_per_round": (st["spec_accepted"] + rounds)
            / max(rounds, 1),
            "phase_replays": phases,
            "draft_launches": {k: n for k, n in draft.items() if n},
            "launches_per_round": {k: n / max(rounds, 1)
                                   for k, n in total.items() if n},
            "captures": gs["captures"] - b["captures"],
            "capture_s": gs["capture_s"] - b["capture_s"],
            "round_shapes": [list(k) for k in gs["shapes"]]}


def spec_parity_f32(torch, ops, case):
    """s-parity: greedy requests through Engine(speculative=True) and a
    non-speculative Engine, both replaying CUDA graphs, in f32 (TF32 off):
    "contiguous" and "int8" (int8 slot caches) on Qwen3-0.6B + AltUp K=2
    at full width and depth (D = 14 of 28 layers: default_draft_layers),
    two requests of S_PROMPTS tokens; "paged" the same over pages of 16
    rows, a donor served first and a request that hits its first
    S_DONOR_SHARED rows; "ring" on gemma3-4b + AltUp K=2 at full width, 12
    layers (10 on rings of 1024 rows, 2 global), one request decoding
    across the wrap; "penalty" as "contiguous" with a full-depth draft
    (the draft is the target, so rounds, their graph captures included,
    commit several tokens) under a repetition penalty of S_PENALTY, with
    logprobs. Gates: tokens identical, rounds ran, each from its graphs
    (spec_rounds), the draft graphs launched the fused AltUp and the
    decode attention (the paged entry point when paged), the hit taken by
    both engines; "penalty": drafts accepted, chosen-token logprobs
    within S_LP_TOL of the non-speculative engine's."""
    from repro_torch.models.transformer import init_params
    from repro_torch.serve.engine import Engine
    from repro_torch.serve.sampling import SamplingParams
    from repro_torch.serve.speculative import SpecConfig
    torch.backends.cuda.matmul.allow_tf32 = False   # full f32 products
    torch.backends.cudnn.allow_tf32 = False
    f32 = dict(dtype="float32", param_dtype="float32")
    gen = torch.Generator().manual_seed(41)
    kw = dict(max_len=512, n_slots=2, prefill_chunk=64, device=DEV)
    if case == "ring":
        cfg = gemma_config(n_layers=S_RING_LAYERS, **f32)
        kw["max_len"] = S_RING_PROMPT + S_RING_NEW
        plens, n_new = (S_RING_PROMPT,), S_RING_NEW
    else:
        cfg = served_config(**f32, **({"kv_cache_dtype": "int8"}
                                      if case == "int8" else {}))
        plens, n_new = S_PROMPTS, S_NEW
    if case == "paged":
        kw.update(paged=True, page_size=16)
    penalty = case == "penalty"
    sp = SamplingParams(max_new=n_new, **(
        {"repetition_penalty": S_PENALTY, "logprobs": True}
        if penalty else {}))
    params = init_params(cfg, seed=2, device=DEV)
    perturb_altup(torch, params, seed=42)
    prompts = [torch.randint(0, cfg.vocab_size, (n,), generator=gen).tolist()
               for n in plens]
    donor = None
    if case == "paged":
        donor = prompts[1]
        prompts[1] = donor[:S_DONOR_SHARED] + torch.randint(
            0, cfg.vocab_size, (20,), generator=gen).tolist()
    out, lps = {}, {}
    for spec in (False, True):
        spec_arg = (SpecConfig(draft_layers=cfg.n_layers)
                    if spec and penalty else spec)
        eng = Engine(cfg, params, speculative=spec_arg, **kw)
        if donor is not None:
            eng.submit(donor, sampling=SamplingParams(max_new=n_new))
            eng.run()
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        rids = [eng.submit(p, sampling=sp) for p in prompts]
        done = eng.run()
        out[spec] = ([list(done[r].tokens) for r in rids], eng,
                     ops.launch_counts())
        if penalty:
            lps[spec] = [list(done[r].logprobs) for r in rids]
    (tok_n, eng_n, _), (tok_s, eng_s, counts) = out[False], out[True]
    if tok_s != tok_n:
        raise AssertionError(f"s-parity {case}: speculative tokens {tok_s} "
                             f"against {tok_n}")
    lp_err = None
    if penalty:
        lp_err = max(abs(a - b) for x, y in zip(lps[True], lps[False])
                     for a, b in zip(x, y))
        if not (eng_s.stats["spec_accepted"] > 0 and lp_err <= S_LP_TOL):
            raise AssertionError(
                f"s-parity {case}: accepted {eng_s.stats['spec_accepted']}"
                f", logprob error {lp_err} (limit {S_LP_TOL})")
    rounds = spec_rounds(eng_s, ring=case == "ring")
    attn = ("paged_ragged_decode_attention" if case == "paged"
            else "ragged_decode_attention")
    dl = rounds["draft_launches"]
    if not (rounds["spec_rounds"] > 0 and dl.get("altup_predict_correct", 0)
            > 0 and dl.get(attn, 0) > 0):
        raise AssertionError(f"s-parity {case}: rounds {rounds}")
    hits = (eng_n.stats["prefix_hits"], eng_s.stats["prefix_hits"])
    if donor is not None and min(hits) < 1:
        raise AssertionError(f"s-parity {case}: prefix hits {hits}")
    ring, glob = gemma_layers(cfg) if case == "ring" else (0, cfg.n_layers)
    res = {"layers": cfg.n_layers, "ring_layers": ring,
           "global_layers": glob, "draft_layers": eng_s._draft_layers,
           "prompt_lens": [len(p) for p in prompts], "new_tokens": n_new,
           "max_depth": max(len(p) for p in prompts) + n_new,
           "prefix_hits": hits[1], "tokens_identical": True,
           "repetition_penalty": S_PENALTY if penalty else 1.0,
           "logprob_max_abs_err": lp_err, "launches": {k: n for k, n in counts.items() if n}, **rounds}
    del out, eng_n, eng_s, params
    torch.cuda.empty_cache()
    return res


def top2_margin(torch, params, cfg, tokens):
    """The top-2 logit margin at the last position of `tokens`, through
    forward (the dense path) in the serving dtype."""
    from repro_torch.models.transformer import forward
    logits = forward(params, cfg, torch.tensor([tokens], device=DEV))
    top = logits[0, -1, :cfg.vocab_size].float().topk(2).values
    return float(top[0] - top[1])


def spec_serve_bf16(torch, ops, load):
    """s-serve: Qwen3-0.6B + AltUp K=2 at full width and depth in bf16,
    speculative against non-speculative, both replaying CUDA graphs:
    "single" one stream (n_slots=1: the load where a draft pays), "e"
    (e)'s 8 requests. Each engine serves a warm-up request first, out of
    the counted run. Records decode tok/s, the median and p80 ms of a
    decode step or round, accepted / drafted, mean k, tokens a round, the
    device ms of one draft round, one verify and one non-speculative step
    (their most replayed graphs, back to back by CUDA events, after the
    run; on (e)'s load also their top kernels by torch.profiler), the
    kernels a round launches, captures and their seconds. In
    bf16 the verify's chunk attention (dense) and the step's (ragged
    kernel) round differently, so a near-tie may flip a greedy token:
    token agreement is recorded, with the first differing position and
    the non-speculative run's top-2 logit margin there, not gated."""
    from repro_torch.models.transformer import init_params
    from repro_torch.serve.engine import Engine
    from repro_torch.serve.sampling import SamplingParams
    cfg = served_config()                              # bf16
    params = init_params(cfg, seed=1, device=DEV)
    perturb_altup(torch, params, seed=11)
    gen = torch.Generator().manual_seed(3)
    if load == "single":
        plens, n_new, n_slots = (S_SINGLE_PROMPT,), S_SINGLE_NEW, 1
    else:
        plens, n_new, n_slots = E_PROMPTS, E_NEW, 8
    prompts = [torch.randint(0, cfg.vocab_size, (n,), generator=gen).tolist()
               for n in plens]
    runs = {}
    for spec in (False, True):
        eng = Engine(cfg, params, max_len=2048, n_slots=n_slots,
                     prefill_chunk=64, prefix_cache=False, speculative=spec,
                     device=DEV)
        eng.submit(prompts[0][:16], sampling=SamplingParams(max_new=8))
        eng.run()
        eng.reset_stats()
        before = eng.spec_graph_stats if spec else None
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        rids = [eng.submit(p, sampling=SamplingParams(max_new=n_new))
                for p in prompts]
        step_ms = []
        t_run = time.perf_counter()
        while eng.has_work:
            pf0 = eng.stats["prefill_tokens"]
            t0 = time.perf_counter()
            eng.step()
            if eng.stats["prefill_tokens"] == pf0:
                step_ms.append(1e3 * (time.perf_counter() - t0))
        wall = time.perf_counter() - t_run
        done = eng.collect()
        st = eng.stats
        step_ms.sort()
        r = {"decode_tok_s": st["decode_tokens"] / st["decode_s"],
             "decode_steps": len(step_ms),
             "step_ms_median": step_ms[len(step_ms) // 2],
             "step_ms_p80": step_ms[int(0.8 * len(step_ms))],
             "wall_s": wall,
             "launches": {k: n for k, n in ops.launch_counts().items()
                          if n}}
        graphs = eng._spec_graphs if spec else eng._graphs
        by_phase = {}
        for key, n in graphs.stats()["replays_by_shape"].items():
            phase = key[0] if spec else "step"
            if n > by_phase.get(phase, (None, 0))[1]:
                by_phase[phase] = (key, n)
        for phase, (key, _) in by_phase.items():
            if phase != "restore":
                replay = graphs._graphs[key][0].replay
                r[f"{phase}_device_ms"] = time_ms(torch, replay, iters=20,
                                                  warmup=3)
                r[f"{phase}_timed_shape"] = [str(v) for v in key]
                if load == "e":
                    r[f"{phase}_kernel_ms"], r[f"{phase}_top_kernels"] = \
                        top_kernels(torch, replay)
        if spec:
            r.update(spec_rounds(eng, ring=False, before=before))
            draft_layers = eng._draft_layers
        runs[spec] = ([list(done[rid].tokens) for rid in rids], r)
        del eng
    (tok_n, res_n), (tok_s, res_s) = runs[False], runs[True]
    agree = []
    for p, a, b in zip(prompts, tok_n, tok_s):
        j = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), None)
        agree.append(None if j is None else
                     {"position": j, "non_spec_top2_margin":
                      top2_margin(torch, params, cfg, p + a[:j])})
    if any(len(t) != n_new for t in tok_s + tok_n):
        raise AssertionError(f"s-serve {load}: a request did not complete")
    # the bytes model at the measured accept rate and mean k, each slot
    # at its depth halfway through the run, weights read once a step
    from repro_torch.roofline.analysis import speculative_bytes
    model = speculative_bytes(
        cfg, [n + n_new // 2 for n in plens], T=2048,
        draft_layers=draft_layers, k=res_s["mean_k"],
        accept_rate=res_s["accept_rate"], kv_dtype=cfg.kv_cache_dtype,
        param_bytes=sum(t.numel() * t.element_size()
                        for t in params.parameters()))
    del params
    torch.cuda.empty_cache()
    return {"requests": len(prompts), "prompt_lens": list(plens),
            "draft_layers": draft_layers,
            "bytes_model": model,
            "bytes_speedup": model["bytes_speedup"],
            "model_round_bytes_over_step_bytes":
                model["round_bytes"] / model["baseline_bytes_per_token"],
            "new_tokens": n_new, "n_slots": n_slots,
            "tokens_identical_requests": sum(a is None for a in agree),
            "first_differences": [a for a in agree if a is not None],
            "non_spec": res_n, "spec": res_s,
            "decode_tok_s_spec_over_non_spec":
                res_s["decode_tok_s"] / res_n["decode_tok_s"],
            "round_ms_median_over_step_ms_median":
                res_s["step_ms_median"] / res_n["step_ms_median"]}


def top_kernels(torch, fn, iters=3, top=6):
    """fn()'s kernels by device time (torch.profiler over `iters` calls,
    the marker first and left out): the summed device ms a call and the
    `top` largest as [name, ms a call, launches a call]. Not gated: a
    profiler run may lose a record now and then (profiled())."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda._sleep(1)
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    kern = sorted((e for e in _device_kernels(prof) if MARKER not in e.key),
                  key=lambda e: -e.self_device_time_total)
    return (sum(e.self_device_time_total for e in kern) / 1e3 / iters,
            [[e.key[:90], e.self_device_time_total / 1e3 / iters,
              e.count / iters] for e in kern[:top]])


def spec_phases(torch, ops):
    """The s phases, each line with its seconds; returns their seconds."""
    t_s = time.perf_counter()
    for case in ("contiguous", "paged", "int8", "ring", "penalty"):
        t0 = time.perf_counter()
        r = spec_parity_f32(torch, ops, case)
        line("s-parity", case=case, seconds=time.perf_counter() - t0, **r)
    for load in ("single", "e"):
        t0 = time.perf_counter()
        r = spec_serve_bf16(torch, ops, load)
        line("s-serve", load=load, seconds=time.perf_counter() - t0, **r)
    seconds = time.perf_counter() - t_s
    line("s-phases", seconds=seconds)
    return seconds


# ---------------------------------------------------------------------------
# (u) seeded sampling: the threefry stream on the card, sampled serving
# ---------------------------------------------------------------------------

U_V = 151936                  # Qwen3's vocabulary: a served row
U_GUMBEL_ATOL = 2e-6          # two ulps of the largest Gumbel value (~16)
U_MARGIN = 1e-6               # top-p mass / min-p logit off a threshold
U_PROMPTS, U_NEW = (16, 40, 64, 24, 96, 33, 57, 80), 16
U_SHARED = 40                 # u-parity paged: rows of the donor's prompt hit
# u-parity's requests: greedy and sampled, each filter, one with a penalty
# and logprobs, one seeded by its request id; entries 1 and 4 also go
# through B=1 generate()
U_REQUESTS = (dict(),
              dict(temperature=0.7, top_k=50, seed=101),
              dict(temperature=1.0, top_p=0.9, seed=102),
              dict(temperature=1.2, min_p=0.05, seed=103),
              dict(temperature=0.9, top_k=50, top_p=0.9, min_p=0.05,
                   seed=104),
              dict(temperature=0.8, repetition_penalty=1.3, logprobs=True,
                   seed=105),
              dict(),
              dict(temperature=1.1))
U_SERVE = dict(temperature=0.8, top_k=50, top_p=0.95)     # u-serve
U_PARITY_LAYERS = 8          # u-parity's depth (28 before PR 28, for time)


def mask_margin(torch, z, k, p, m, j):
    """How close token j of row z (f32, CPU) lies to the filters'
    thresholds, in float64: its top-p mass-before against p and its logit
    against the min-p line (top-k is exact); inf where a filter is off."""
    z64 = z.double()
    srt = torch.sort(z64, descending=True).values
    probs = torch.softmax(srt, dim=0)
    before = torch.cumsum(probs, dim=0) - probs
    pos = int((srt > z64[j]).sum())
    return {"top_p": abs(float(before[pos]) - p) if p < 1.0 else math.inf,
            "min_p": (abs(float(z64[j] - srt[0]) - math.log(m)) if m > 0.0
                      else math.inf)}


def mass_before_err(torch, z):
    """The largest error of the f32 top-p cumsum (the mass before each
    sorted position, as _filter_logits computes it) on z's device against
    float64 on the CPU, over the rows of z."""
    srt = torch.sort(z, dim=-1, descending=True).values
    probs = torch.softmax(srt, dim=-1)
    got = (torch.cumsum(probs, dim=-1) - probs).cpu().double()
    srt64 = srt.cpu().double()
    p64 = torch.softmax(srt64, dim=-1)
    return float((got - (torch.cumsum(p64, dim=-1) - p64)).abs().max())


def sampling_rng(torch):
    """u-rng: the port's PRNG and filters on the card against the CPU."""
    from repro_torch import prng
    from repro_torch.serve import sampling as samp
    # the CPU build's first multi-threaded log of a process may compute
    # one thread's share at ~1e-4 relative error (MKL, first call only):
    # make that call before the CPU side's Gumbel noise
    torch.log(torch.rand(1 << 20) + 0.5)
    gen = torch.Generator().manual_seed(61)
    seeds = (0, 1, 2**31 - 1, -1, 2**32 + 5, 7, 100, 12345)
    kc = torch.stack([prng.key_data(s) for s in seeds])
    kg = torch.stack([prng.key_data(s).to(DEV) for s in seeds])
    res = {"key_data_bitwise": torch.equal(kc, kg.cpu())}
    for _ in range(3):
        d = torch.randint(0, 2**32, (len(seeds),), generator=gen,
                          dtype=torch.int64)
        kc, kg = prng.fold_in(kc, d), prng.fold_in(kg, d.to(DEV))
    kc, kg = prng.fold_in(kc, 0x5BEC), prng.fold_in(kg, 0x5BEC)
    res["fold_chain_bitwise"] = torch.equal(kc, kg.cpu())
    res["random_bits_bitwise"] = torch.equal(
        prng.random_bits(kc, U_V), prng.random_bits(kg, U_V).cpu())
    tiny = float(torch.finfo(torch.float32).tiny)
    for name, lo in (("uniform_bitwise", 0.0), ("uniform_tiny_bitwise", tiny)):
        res[name] = torch.equal(
            prng.uniform(kc, U_V, lo, 1.0).view(torch.int32),
            prng.uniform(kg, U_V, lo, 1.0).cpu().view(torch.int32))
    res["gumbel_max_abs_err"] = max_err(torch, prng.gumbel(kc, U_V),
                                        prng.gumbel(kg, U_V).cpu())
    z = 3 * torch.randn((len(seeds), U_V), generator=gen)
    res["categorical_identical"] = torch.equal(
        prng.categorical(kc, z), prng.categorical(kg, z.to(DEV)).cpu())
    grid = [(k, p, m) for k in (0, 1, 50) for p in (0.9, 0.95, 1.0)
            for m in (0.0, 0.05)]
    z = 3 * torch.randn((len(grid), U_V), generator=gen)
    params = [torch.tensor([g[i] for g in grid],
                           dtype=torch.long if i == 0 else torch.float32)
              for i in range(3)]
    keep_c = samp._filter_logits(z, *params).isfinite()
    keep_g = samp._filter_logits(z.to(DEV), *(t.to(DEV) for t in params)
                                 ).isfinite().cpu()
    # a mask may differ only where the token lies at a threshold within
    # the rounding that decides it: the two sides' f32 cumsum errors
    # (top-p, measured here: the CPU's is the larger, ~1e-5 at this V),
    # or U_MARGIN; min-p logits within two ulps
    cumsum_err = {"cpu": mass_before_err(torch, z),
                  "card": mass_before_err(torch, z.to(DEV))}
    tol = {"top_p": max(U_MARGIN, sum(cumsum_err.values())),
           "min_p": 2 * U_MARGIN}
    diff = []
    for b, j in (keep_c != keep_g).nonzero().tolist():
        mg = mask_margin(torch, z[b], *grid[b], j)
        diff.append({"row": list(grid[b]), "token": j,
                     "kept_on_card": bool(keep_g[b, j]),
                     "margin": {k: v for k, v in mg.items()
                                if v != math.inf},
                     "explained": any(mg[k] <= tol[k] for k in mg)})
    res.update(filter_rows=len(grid), filter_kept=int(keep_c.sum()),
               top_p_cumsum_max_abs_err=cumsum_err, margin_tol=tol,
               filter_differing=diff)
    bitwise = [k for k, v in res.items() if k.endswith("bitwise")]
    if not (all(res[k] for k in bitwise) and res["categorical_identical"]
            and res["gumbel_max_abs_err"] <= U_GUMBEL_ATOL
            and all(d["explained"] for d in diff)):
        raise AssertionError(f"u-rng: {res}")
    res["gumbel_atol"] = U_GUMBEL_ATOL
    return res


def sampling_parity_f32(torch, ops):
    """u-parity: sampled serving eager against replayed, f32, full width,
    U_PARITY_LAYERS layers (see the module docstring)."""
    from repro_torch.models.transformer import init_params
    from repro_torch.serve.engine import Engine
    from repro_torch.serve.sampling import SamplingParams
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    f32 = dict(dtype="float32", param_dtype="float32")
    gen = torch.Generator().manual_seed(63)
    f32["n_layers"] = U_PARITY_LAYERS
    cfgs = {"auto": served_config(**f32),
            "int8": served_config(**f32, kv_cache_dtype="int8")}
    params = init_params(cfgs["auto"], seed=6, device=DEV)
    perturb_altup(torch, params, seed=64)
    V = cfgs["auto"].vocab_size
    prompts = [torch.randint(0, V, (n,), generator=gen).tolist()
               for n in U_PROMPTS]
    # paged: a donor first; requests 1 and 4 extend its prompt
    donor = torch.randint(0, V, (U_SHARED + 9,), generator=gen).tolist()
    shared = [donor[:U_SHARED] + p if i in (1, 4) else p
              for i, p in enumerate(prompts)]
    sps = [SamplingParams(max_new=U_NEW, **kw) for kw in U_REQUESTS]
    eager_cls = engine_class(False)

    def serve(cls, kind="auto", spec=False, paged=False):
        kw = dict(paged=True, page_size=16) if paged else {}
        eng = cls(cfgs[kind], params, max_len=256, n_slots=8,
                  prefill_chunk=64, speculative=spec, device=DEV, **kw)
        ps = prompts
        if paged:
            eng.submit(donor, sampling=SamplingParams(max_new=2))
            eng.run()
            ps = shared
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        rids = [eng.submit(p, sampling=sp) for p, sp in zip(ps, sps)]
        done = eng.run()
        counts = ops.launch_counts()
        return {"tokens": [list(done[r].tokens) for r in rids],
                "logprobs": [done[r].logprobs for r in rids],
                "eng": eng, "launches": {k: n for k, n in counts.items()
                                         if n}}

    def sampled_shapes(stats):
        return [list(k) for k in stats["shapes"] if k[-1] is True]

    res, fails = {}, []
    base = None
    for case, kw in (("contiguous", {}), ("paged", dict(paged=True)),
                     ("int8", dict(kind="int8")), ("spec", dict(spec=True))):
        t0 = time.perf_counter()
        eager, replayed = serve(eager_cls, **kw), serve(Engine, **kw)
        eng = replayed["eng"]
        r = {"tokens_identical": eager["tokens"] == replayed["tokens"],
             "launches": replayed["launches"]}
        lp = [abs(a - b) for x, y in zip(eager["logprobs"],
                                         replayed["logprobs"])
              if x is not None for a, b in zip(x, y)]
        r["logprob_max_abs_err"] = max(lp)
        gs = eng.spec_graph_stats if case == "spec" else eng.graph_stats
        r["sampled_graphs"] = sampled_shapes(gs)
        attn = ("paged_ragged_decode_attention" if case == "paged"
                else "ragged_decode_attention")
        ok = (r["tokens_identical"] and bool(r["sampled_graphs"])
              and r["launches"].get("altup_predict_correct", 0) > 0
              and r["launches"].get(attn, 0) > 0)
        if case == "contiguous":
            base = replayed
            static = [eng.generate([prompts[i]], sampling=sps[i]
                                   ).cpu().flatten().tolist() for i in (1, 4)]
            r["generate_identical"] = static == [base["tokens"][i]
                                                 for i in (1, 4)]
            ok &= r["generate_identical"]
        if case == "paged":
            r["prefix_hits"] = eng.stats["prefix_hits"]
            ok &= r["prefix_hits"] >= 2
        if case == "spec":
            again = serve(Engine, spec=True)
            greedy = [i for i, kw in enumerate(U_REQUESTS) if not kw]
            st = eng.stats
            r.update(run_to_run_identical=again["tokens"] ==
                     replayed["tokens"],
                     greedy_identical_to_non_spec=all(
                         replayed["tokens"][i] == base["tokens"][i]
                         for i in greedy),
                     spec_rounds=st["spec_rounds"],
                     accept_rate=st["spec_accepted"]
                     / max(st["spec_drafted"], 1),
                     mean_k=st["spec_k_sum"] / max(st["spec_rounds"], 1))
            ok &= (r["run_to_run_identical"]
                   and r["greedy_identical_to_non_spec"]
                   and st["spec_rounds"] > 0)
            del again
        r["seconds"] = time.perf_counter() - t0
        res[case] = r
        if not ok:
            fails.append(case)
        if case != "contiguous":
            del eager, replayed, eng
        torch.cuda.empty_cache()
    if fails:
        raise AssertionError(f"u-parity {fails}: {res}")
    del base, params
    torch.cuda.empty_cache()
    return {"requests": len(sps), "prompt_lens": list(U_PROMPTS),
            "new_tokens": U_NEW, "sampling": list(U_REQUESTS), **res}


def graph_ms(torch, fn, iters=20):
    """Device ms of fn() replayed from a CUDA graph, back to back by CUDA
    events: its kernels and the gaps between them, without the host's
    launches (fn warmed up on a side stream first)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return time_ms(torch, graph.replay, iters=iters, warmup=3)


def sampler_ms(torch):
    """The sampler's device ms at (8, 151936), each function replayed
    from a CUDA graph (graph_ms: called eagerly, the host launches its
    ~400 kernels slower than the card runs them; and the profiler loses
    a record now and then late in a run): the greedy sample_rows
    (penalty, argmax), the sampled one, and its pieces: random_bits
    (threefry), gumbel (threefry, then two logs), the sort alone and
    _filter_logits (sort, softmax, cumsum, three masks); the rest is the
    sampled call less the greedy one, gumbel and the filters. Bound: one
    read of the (8, V) f32 logits."""
    from repro_torch import prng
    from repro_torch.serve import sampling as samp
    B = 8
    gen = torch.Generator(device=DEV).manual_seed(65)
    rows = 3 * torch.randn((B, U_V), generator=gen, device=DEV)
    seen = torch.rand((B, U_V), generator=gen, device=DEV) < 0.001
    sp = {"temperature": torch.full((B,), U_SERVE["temperature"],
                                    device=DEV),
          "top_k": torch.full((B,), U_SERVE["top_k"], device=DEV),
          "top_p": torch.full((B,), U_SERVE["top_p"], device=DEV),
          "min_p": torch.zeros((B,), device=DEV),
          "rep_pen": torch.ones((B,), device=DEV),
          "key": torch.stack([prng.key_data(b) for b in range(B)]).to(DEV),
          "sample_idx": torch.arange(B, device=DEV)}
    keys = prng.fold_in(sp["key"], sp["sample_idx"])
    fns = {"greedy_ms": lambda: samp.sample_rows(rows, sp, seen),
           "sampled_ms": lambda: samp.sample_rows(rows, sp, seen,
                                                  any_sampled=True),
           "threefry_ms": lambda: prng.random_bits(keys, U_V),
           "gumbel_ms": lambda: prng.gumbel(keys, U_V),
           "sort_ms": lambda: torch.sort(rows, dim=-1, descending=True),
           "filters_ms": lambda: samp._filter_logits(
               rows, sp["top_k"], sp["top_p"], sp["min_p"])}
    out = {name: graph_ms(torch, fn) for name, fn in fns.items()}
    out["rest_ms"] = (out["sampled_ms"] - out["greedy_ms"]
                      - out["gumbel_ms"] - out["filters_ms"])
    out["bound_ms"], out["bound_by"] = bound_ms(B * U_V * 4, 0, "float32")
    return out


def sampling_serve_bf16(torch, ops, greedy):
    """u-serve: (e)'s load sampled (U_SERVE), replayed, against `greedy`,
    the e-graph run's result of the same script run (see the module
    docstring)."""
    from repro_torch.models.transformer import init_params
    from repro_torch.serve.engine import Engine
    from repro_torch.serve.sampling import SamplingParams
    cfg = served_config()                              # bf16, as (e)
    params = init_params(cfg, seed=1, device=DEV)
    perturb_altup(torch, params, seed=11)
    gen = torch.Generator().manual_seed(3)
    prompts = [torch.randint(0, cfg.vocab_size, (n,), generator=gen).tolist()
               for n in E_PROMPTS]
    sp = SamplingParams(max_new=E_NEW, **U_SERVE)
    res = {"requests": len(prompts), "prompt_lens": list(E_PROMPTS),
           "new_tokens": E_NEW, "sampling": U_SERVE}
    for spec in (False, True):
        eng = Engine(cfg, params, max_len=2048, n_slots=8, prefill_chunk=64,
                     prefix_cache=False, speculative=spec, device=DEV)
        eng.submit(prompts[0][:16], sampling=SamplingParams(
            max_new=4, **U_SERVE))
        eng.run()
        eng.reset_stats()
        gs0 = eng.graph_stats
        before = eng.spec_graph_stats if spec else None
        torch.cuda.synchronize()
        ops.reset_launch_counts()             # counts start at 0 right here
        rids = [eng.submit(p, sampling=sp) for p in prompts]
        step_ms, steps = [], 0
        while eng.has_work:
            pf0 = eng.stats["prefill_tokens"]
            t0 = time.perf_counter()
            eng.step()
            steps += 1
            if eng.stats["prefill_tokens"] == pf0:
                step_ms.append(1e3 * (time.perf_counter() - t0))
        counts = ops.launch_counts()          # read right after the run
        done = eng.collect()
        if any(len(done[r].tokens) != E_NEW for r in rids):
            raise AssertionError(f"u-serve spec={spec}: a request did not "
                                 f"complete")
        st = eng.stats
        step_ms.sort()
        r = {"decode_tok_s": st["decode_tokens"] / st["decode_s"],
             "decode_steps": len(step_ms),
             "step_ms_median": step_ms[len(step_ms) // 2],
             "step_ms_p80": step_ms[int(0.8 * len(step_ms))],
             "launches": {k: n for k, n in counts.items() if n}}
        if spec:
            r.update({k: v for k, v in spec_rounds(eng, ring=False,
                                                   before=before).items()
                      if k in ("spec_rounds", "accept_rate", "mean_k",
                               "tokens_per_round", "launches_per_round",
                               "captures", "round_shapes")})
            r["round_ms_over_sampled_step_ms"] = \
                r["step_ms_median"] / res["sampled"]["step_ms_median"]
            res["spec"] = r
            del eng
            continue
        graph = graph_window(gs0, eng.graph_stats)
        warm = graph["warmup_launches"]
        n_layers = cfg.n_layers
        if counts["altup_predict_correct"] - warm["altup_predict_correct"] \
                != n_layers * steps or counts["ragged_decode_attention"] \
                - warm["ragged_decode_attention"] != n_layers * len(step_ms):
            raise AssertionError(f"u-serve: launch counts {counts} (warm-ups "
                                 f"{warm}) against {steps} steps, "
                                 f"{len(step_ms)} decode steps")
        by_shape = eng.graph_stats["replays_by_shape"]
        if any(not key[-1] for key in by_shape):
            raise AssertionError(f"u-serve: a greedy graph replayed in a "
                                 f"sampled run: {by_shape}")
        key = max(by_shape, key=by_shape.get)
        r["altup_launches_per_step"] = (counts["altup_predict_correct"]
                                        - warm["altup_predict_correct"]) / steps
        r["ragged_launches_per_decode_step"] = (
            counts["ragged_decode_attention"]
            - warm["ragged_decode_attention"]) / len(step_ms)
        r["timed_shape"] = [str(v) for v in key]
        replay = eng._graphs._graphs[key][0].replay
        r["graph_device_ms"] = time_ms(torch, replay, iters=20, warmup=3)
        r["graph_kernel_ms"], r["graph_top_kernels"] = top_kernels(torch,
                                                                   replay)
        # the greedy graph of the same kv bucket on this engine, timed the
        # same way: one greedy request batch of the same prompts
        eng.reset_stats()
        gids = [eng.submit(p, sampling=SamplingParams(max_new=4))
                for p in prompts]
        eng.run()
        gkey = (key[0], key[1], False)
        greedy_graph = eng._graphs._graphs.get(gkey)
        if greedy_graph is not None:
            r["greedy_graph_device_ms"] = time_ms(torch, greedy_graph[0].replay,
                                                  iters=20, warmup=3)
            r["greedy_graph_kernel_ms"], _ = top_kernels(
                torch, greedy_graph[0].replay)
        del gids
        res["sampled"] = r
        del eng
        torch.cuda.empty_cache()
    res["sampler"] = sampler_ms(torch)
    g = greedy or {}
    res["greedy_e_graph"] = {k: g.get(k) for k in (
        "decode_tok_s", "decode_step_ms_median", "decode_step_ms_p80")}
    if g:
        res["decode_tok_s_sampled_over_greedy"] = \
            res["sampled"]["decode_tok_s"] / g["decode_tok_s"]
        res["step_ms_median_sampled_minus_greedy"] = \
            res["sampled"]["step_ms_median"] - g["decode_step_ms_median"]
    del params
    torch.cuda.empty_cache()
    return res


def sampling_phases(torch, ops, greedy=None):
    """The u phases, each line with its seconds; greedy: the e-graph
    run's result, which u-serve is set beside. Returns their seconds."""
    t_u = time.perf_counter()
    for tag, fn in (("u-rng", lambda: sampling_rng(torch)),
                    ("u-parity", lambda: sampling_parity_f32(torch, ops)),
                    ("u-serve", lambda: sampling_serve_bf16(torch, ops,
                                                            greedy))):
        t0 = time.perf_counter()
        r = fn()
        line(tag, seconds=time.perf_counter() - t0, **r)
    seconds = time.perf_counter() - t_u
    line("u-phases", seconds=seconds)
    return seconds


# ---------------------------------------------------------------------------
# (m) qwen2-moe-a2.7b + AltUp K=2: the MoE family, no new kernel
# ---------------------------------------------------------------------------

# m-parity, m-grad and m-train run the full width at 2 layers; m-serve's
# eager twin and its paged run at M_TWIN_LAYERS; m-serve itself at
# M_GRAPH_LAYERS of 24 (for the run's time)
M_LAYERS, M_TWIN_LAYERS = 2, 4
M_GRAPH_LAYERS = 12
M_BLOCK_TOKENS = 128        # m-parity's moe_block, card against CPU
M_BLOCK_TOL = 1e-5          # of the CPU output's max
M_AUX_RTOL = 1e-6
M_GRAD_B, M_GRAD_S = 2, 128
M_STEPS, M_BATCH, M_SEQ, M_MB = 12, 8, 512, 2
# m-serve's paged run: a shared prompt of 250 tokens (a donor serves it
# first), then 8 requests of it plus a tail, 32 new tokens
M_SYSTEM, M_PAGED_NEW = 250, 32
M_TAILS = (32, 64, 96, 128, 160, 192, 224, 256)


def moe_config(**kw):
    """qwen2-moe-a2.7b wrapped with AltUp K=2 (recycled: vocab > 100k)."""
    from repro_torch.configs import get_config
    return get_config("qwen2-moe-a2.7b", altup_k=2).replace(**kw)


def moe_layer0(torch, cfg, seed):
    """Layer 0's moe leaves of `cfg` drawn on the card, as a dict."""
    from repro_torch.models.moe import init_moe
    from repro_torch.models.transformer import prm_dtype
    gen = torch.Generator(device=DEV).manual_seed(seed)
    return init_moe(cfg.d_model, cfg.moe, prm_dtype(cfg), gen, DEV)


def moe_expert_bytes(cfg):
    """Bytes of one layer's routed expert weights (w1, w3, w2 of every
    padded expert) in the parameters' dtype."""
    m = cfg.moe
    esz = 2 if cfg.param_dtype == "bfloat16" else 4
    return 3 * m.padded_experts * cfg.d_model * m.d_expert * esz


def moe_block_parity(torch):
    """m-parity's moe_block: full width (d 2048, 64 padded experts, top
    4), f32, TF32 off, layer 0's experts on M_BLOCK_TOKENS tokens, on the
    card against the same call on the CPU, with capacity_for's drops and
    drop-free (capacity = tokens): expert ids identical, outputs within
    M_BLOCK_TOL of the CPU output's max, aux within M_AUX_RTOL. Then the
    drop-free block at a decode step's shape (8 tokens) under
    torch.cuda.set_sync_debug_mode("error"): it reads nothing back to the
    host, so a captured step may route; and its device ms replayed from
    a graph against its bytes bound (every padded expert's weights)."""
    from repro_torch.models import moe as moe_lib
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = moe_config(n_layers=1, dtype="float32", param_dtype="float32")
    m = cfg.moe
    p = moe_layer0(torch, cfg, seed=50)
    p_cpu = {k: ({n: t.cpu() for n, t in v.items()} if isinstance(v, dict)
                 else v.cpu()) for k, v in p.items()}
    gen = torch.Generator(device=DEV).manual_seed(51)
    x = torch.randn(1, M_BLOCK_TOKENS, cfg.d_model, generator=gen,
                    device=DEV)
    res = {"cfg": cfg_name(cfg), "tokens": M_BLOCK_TOKENS,
           "experts_padded": m.padded_experts, "top_k": m.top_k}
    with torch.no_grad():
        ids_d = moe_lib.router_probs(p, m, x[0])[1]
        ids_c = moe_lib.router_probs(p_cpu, m, x[0].cpu())[1]
        if not torch.equal(ids_d.cpu(), ids_c):
            raise AssertionError("m-parity: expert ids differ between the "
                                 "card and the CPU")
        for case, cap in (("drops", None), ("drop_free", M_BLOCK_TOKENS)):
            t0 = time.perf_counter()
            y_c, aux_c = moe_lib.moe_block(p_cpu, m, x.cpu(), capacity=cap)
            cpu_s = time.perf_counter() - t0
            y_d, aux_d = moe_lib.moe_block(p, m, x, capacity=cap)
            torch.cuda.synchronize()
            scale = float(y_c.abs().max())
            err = max_err(torch, y_d.cpu(), y_c) / scale
            aux_err = abs(float(aux_d) - float(aux_c)) / float(aux_c)
            c = cap or moe_lib.capacity_for(M_BLOCK_TOKENS, m)
            slot = moe_lib._dispatch_indices(ids_c, m.padded_experts)[1]
            res[case] = {"capacity": c, "dropped": int((slot >= c).sum()),
                         "max_err_over_max": err, "aux_rel_err": aux_err,
                         "aux": float(aux_d), "cpu_s": cpu_s}
            if not (err <= M_BLOCK_TOL and aux_err <= M_AUX_RTOL):
                raise AssertionError(f"m-parity moe_block {case}: {res}")
        # a decode step's block: no host sync on the card
        xd = x[:, :8].reshape(8, 1, cfg.d_model)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            moe_lib.moe_block(p, m, xd, capacity=8)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        res["decode_block_host_syncs"] = 0
    del p, p_cpu
    torch.cuda.empty_cache()
    return res


def moe_decode_block_ms(torch, cfg, B):
    """A decode step's MoE block on the card, bf16 at cfg's width: device
    ms of the drop-free block on (B, 1, d) replayed from a CUDA graph,
    against its bytes bound (every padded expert's weights read once)."""
    from repro_torch.models import moe as moe_lib
    p = moe_layer0(torch, cfg, seed=52)
    gen = torch.Generator(device=DEV).manual_seed(53)
    x = torch.randn(B, 1, cfg.d_model, generator=gen, device=DEV).to(
        torch.bfloat16)
    with torch.no_grad():
        ms = graph_ms(torch, lambda: moe_lib.moe_block(p, cfg.moe, x,
                                                       capacity=B))
    shared = 3 * cfg.d_model * cfg.moe.num_shared * cfg.moe.d_shared
    b_ms, b_by = bound_ms(moe_expert_bytes(cfg) + 2 * shared, 0,
                          "bfloat16")
    del p
    return {"moe_block_ms": ms, "moe_block_bound_ms": b_ms,
            "moe_block_bound_by": b_by}


def moe_paged_hit_f32(torch, ops):
    """m-parity's third case: a paged engine with a prefix hit, f32 at 2
    layers, the kernel path (the fused AltUp and the paged decode
    attention, replayed) against the dense path (both kernel flags off):
    a donor, then two requests sharing 130 of its rows; greedy tokens
    identical, chosen-token logprobs within PARITY_TOL, a hit on each
    side, the kernels launched."""
    from repro_torch.models.transformer import init_params
    from repro_torch.serve.engine import Engine
    from repro_torch.serve.sampling import SamplingParams
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = moe_config(n_layers=M_LAYERS, dtype="float32",
                     param_dtype="float32")
    params = init_params(cfg, seed=54, device=DEV)
    perturb_altup(torch, params, seed=55)
    gen = torch.Generator().manual_seed(56)

    def ids(n):
        return torch.randint(0, cfg.vocab_size, (n,), generator=gen).tolist()
    donor = ids(200)
    prompts = [donor[:130] + ids(20), donor[:130] + ids(45)]
    sp = SamplingParams(max_new=16, logprobs=True)
    out = {}
    for side, flag in (("kernel", None), ("dense", False)):
        c = cfg.replace(ragged_decode_attn=flag, fused_decode_altup=flag)
        eng = Engine(c, params, max_len=512, n_slots=2, prefill_chunk=64,
                     paged=True, page_size=16, device=DEV)
        eng.submit(donor, sampling=SamplingParams(max_new=4))
        eng.run()
        ops.reset_launch_counts()
        rids = [eng.submit(p, sampling=sp) for p in prompts]
        done = eng.run()
        out[side] = ([list(done[r].tokens) for r in rids],
                     [list(done[r].logprobs) for r in rids],
                     eng.stats["prefix_hits"], ops.launch_counts())
        del eng
    (tk, lk, hk, ck), (td, ld, hd, cd) = out["kernel"], out["dense"]
    lp_err = max(abs(a - b) for x, y in zip(lk, ld) for a, b in zip(x, y))
    if tk != td or lp_err > PARITY_TOL["atol"] or min(hk, hd) < 2 or \
            ck["paged_ragged_decode_attention"] <= 0 or \
            ck["altup_predict_correct"] <= 0 or any(cd.values()):
        raise AssertionError(f"m-parity paged hit: tokens {tk} vs {td}, "
                             f"logprob error {lp_err}, hits {hk}/{hd}, "
                             f"launches {ck} / {cd}")
    del params
    torch.cuda.empty_cache()
    return {"cfg": cfg_name(cfg), "prefix_hits": hk,
            "shared_rows": 130, "tokens_identical": True,
            "logprob_max_abs_err": lp_err, "tol": PARITY_TOL["atol"],
            "launches": {k: n for k, n in ck.items() if n}}


def moe_grad_f32(torch, ops):
    """m-grad: loss_fn (aux loss weighted in) and every leaf's gradient,
    router, experts and shared experts included, on the card against the
    CPU, full width at 2 layers, f32, TF32 off, remat "none" on both, from
    one seeded init drawn on the card and copied to the CPU: each leaf
    within K_GRAD_TOL of its max, loss within K_LOSS_RTOL, aux within
    M_AUX_RTOL; no kernel launched."""
    from repro_torch import tree as tree_lib
    from repro_torch.data.pipeline import lm_batch
    from repro_torch.models import model as M
    from repro_torch.models.transformer import init_params
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = moe_config(n_layers=M_LAYERS, dtype="float32",
                     param_dtype="float32", remat="none")
    dev = init_params(cfg, seed=57, device=DEV).requires_grad_(True)
    perturb_altup(torch, dev, seed=58)
    cpu = to_device(dev, "cpu")
    nb = lm_batch(cfg, M_GRAD_B, M_GRAD_S, seed=2, step=0)
    nb["mask"][1, :20] = 0.0

    def run(params, device):
        paths, leaves = zip(*tree_lib.leaves(params))
        total, m = M.loss_fn(params, cfg, batch_on(torch, nb, device))
        grads = torch.autograd.grad(total, leaves)
        vals = {k: float(v.detach()) for k, v in m.items()}
        vals["total"] = float(total.detach())
        return vals, dict(zip(paths, grads))
    t0 = time.perf_counter()
    m_cpu, g_cpu = run(cpu, "cpu")
    cpu_s = time.perf_counter() - t0
    c0 = ops.launch_counts()
    m_dev, g_dev = run(dev, DEV)
    torch.cuda.synchronize()
    c1 = ops.launch_counts()
    ratio, path = worst_leaf(torch, g_dev, g_cpu)
    moe_ratio, moe_path = worst_leaf(
        torch, {p: g for p, g in g_dev.items() if "moe" in p},
        {p: g for p, g in g_cpu.items() if "moe" in p})
    res = {"cfg": cfg_name(cfg), "B": M_GRAD_B, "S": M_GRAD_S,
           "leaves": len(g_cpu), "cpu_s": cpu_s,
           "loss_cuda": m_dev["loss"], "loss_cpu": m_cpu["loss"],
           "aux_cuda": m_dev["aux_loss"], "aux_cpu": m_cpu["aux_loss"],
           "loss_rel_err": abs(m_dev["loss"] - m_cpu["loss"]) / m_cpu["loss"],
           "aux_rel_err": abs(m_dev["aux_loss"] - m_cpu["aux_loss"])
           / m_cpu["aux_loss"],
           "total_rel_err": abs(m_dev["total"] - m_cpu["total"])
           / m_cpu["total"],
           "worst_leaf": path, "max_err_over_max": ratio,
           "worst_moe_leaf": moe_path, "moe_max_err_over_max": moe_ratio,
           "launches_while_differentiating": {
               k: c1[k] - c0[k] for k in c1 if c1[k] != c0[k]}}
    if not (ratio <= K_GRAD_TOL and res["loss_rel_err"] <= K_LOSS_RTOL
            and res["total_rel_err"] <= K_LOSS_RTOL
            and res["aux_rel_err"] <= M_AUX_RTOL) or \
            res["launches_while_differentiating"]:
        raise AssertionError(f"m-grad: {res}")
    del dev, cpu, g_cpu, g_dev
    torch.cuda.empty_cache()
    return res


def moe_train(torch, ops, workdir):
    """m-train: Trainer(device="cuda") on qwen2-moe-a2.7b + AltUp K=2 at
    full width and 2 layers, bf16 (full depth does not fit: its f32
    optimizer moments alone would need ~120 GB), the launcher's
    TrainConfig at M_STEPS steps of M_BATCH x M_SEQ tokens in M_MB
    microbatches. Gates: finite losses and aux losses, the mean of the
    last 3 losses below the first; tokens/s, peak memory and MFU from
    model_flops_per_token (routed experts at top_k / num_experts)."""
    import numpy as np
    from repro_torch.launch.train import train_config
    from repro_torch.models import model as M
    from repro_torch.train.trainer import Trainer
    cfg = moe_config(n_layers=M_LAYERS)
    tcfg = train_config(M_STEPS, M_BATCH, M_SEQ, M_MB, K_LR,
                        str(workdir / "m-train"))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    c0 = ops.launch_counts()
    tr = Trainer(cfg, tcfg, device=DEV)
    logs = []
    out = tr.run(log=logs.append)
    c1 = ops.launch_counts()
    losses = [h["loss"] for h in out["history"]]
    auxes = [h["aux_loss"] for h in out["history"]]
    med_s = float(np.median(tr.step_times[2:]))
    tokens = M_BATCH * M_SEQ
    flops_tok = M.model_flops_per_token(cfg)
    res = {"cfg": cfg_name(cfg), "steps": out["step"],
           "tokens_per_step": tokens, "microbatches": M_MB,
           "first_step_s": tr.step_times[0],
           "median_step_ms_3_on": 1e3 * med_s,
           "tokens_per_s": tokens / med_s,
           "active_params": M.active_param_count(cfg),
           "model_flops_per_token": flops_tok,
           "mfu_bf16_dense_peak": flops_tok * tokens / med_s
           / hardware("bfloat16").peak_flops,
           "max_memory_allocated": torch.cuda.max_memory_allocated(),
           "loss_first": losses[0],
           "loss_last3_mean": sum(losses[-3:]) / 3, "losses": losses,
           "aux_losses": auxes, "log": logs[-2:],
           "launches": {k: c1[k] - c0[k] for k in c1 if c1[k] != c0[k]}}
    if not all(math.isfinite(x) for x in losses + auxes) or \
            not res["loss_last3_mean"] < losses[0] or res["launches"]:
        raise AssertionError(f"m-train: {res}")
    del tr
    torch.cuda.empty_cache()
    return res


def moe_share(torch, eng):
    """The MoE FFN's share of a replayed decode step's device time:
    range_shares with every moe_block in a range (one a layer)."""
    import repro_torch.models.moe as moe_lib
    r = range_shares(torch, eng, {"moe_ffn": (moe_lib, "moe_block",
                                              eng.cfg.n_layers)})
    m = r.pop("ranges")["moe_ffn"]
    return {**r, "moe_ffn_kernel_ms": m["kernel_ms"],
            "moe_ffn_share_of_step_kernels": m["share"],
            "moe_ffn_share_sessions": m["sessions"],
            "moe_ffn_ranges": m["calls"]}


def range_shares(torch, eng, ranges):
    """Shares of a replayed decode step's device time: the engine's most
    replayed step graph, replayed back to back (CUDA events), and eager
    calls of the same static-buffer step under torch.profiler with every
    call of each `ranges` entry {name: (module, function name, calls a
    step)} in a record_function range of that name (a range's kernel
    time over the step's kernel time, the median of three sessions by
    the first range's share, with the step's top kernels). The eager
    calls write the rows their step wrote again."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function
    gs = eng.graph_stats
    key = max(gs["replays_by_shape"], key=gs["replays_by_shape"].get)
    graph = eng._graphs._graphs[key][0]
    replay_ms = time_ms(torch, graph.replay, iters=20, warmup=3)
    step = functools.partial(eng._static_step, eng._inputs[1], *key)
    real = {name: getattr(mod, attr)
            for name, (mod, attr, _) in ranges.items()}

    def ranged(name):
        def call(*a, **kw):
            with record_function(name):
                return real[name](*a, **kw)
        return call
    with torch.no_grad():
        step()
    torch.cuda.synchronize()
    # three profiler sessions (late in a process a session now and then
    # loses or gains records, profiled()): the median share is kept
    sessions = []
    for name, (mod, attr, _) in ranges.items():
        setattr(mod, attr, ranged(name))
    try:
        for _ in range(3):
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                torch.cuda._sleep(1)
                with torch.no_grad():
                    step()
                torch.cuda.synchronize()
            # the ranges also appear on the device's timeline, spanning
            # the idle time between an eager step's launches: only
            # kernels are summed
            kern = sorted((e for e in _device_kernels(prof)
                           if MARKER not in e.key and e.key not in ranges),
                          key=lambda e: -e.self_device_time_total)
            dev_us = sum(e.self_device_time_total for e in kern)
            per = {}
            for name, (_, _, want) in ranges.items():
                # the host-side ranges: their device time sums the
                # kernels of the ops inside them
                rng = [e for e in prof.key_averages() if e.key == name
                       and e.device_type == DeviceType.CPU]
                calls = sum(e.count for e in rng)
                if not dev_us or calls != want:
                    raise AssertionError(f"step profile: {dev_us} us of "
                                         f"kernels, {calls} {name} ranges "
                                         f"for {want}")
                per[name] = sum(e.device_time_total for e in rng)
            sessions.append((per, dev_us, kern))
    finally:
        for name, (mod, attr, _) in ranges.items():
            setattr(mod, attr, real[name])
    first = next(iter(ranges))
    sessions.sort(key=lambda t: t[0][first] / t[1])
    per, dev_us, kern = sessions[1]
    return {"replayed_shape": list(key), "device_ms_per_replay": replay_ms,
            "eager_step_kernel_ms": dev_us / 1e3,
            "eager_step_kernels": sum(e.count for e in kern),
            "ranges": {name: {"kernel_ms": per[name] / 1e3,
                              "share": per[name] / dev_us,
                              "sessions": [t[0][name] / t[1]
                                           for t in sessions],
                              "calls": ranges[name][2]}
                       for name in ranges},
            "top_kernels": [[e.key[:70], e.count,
                             e.self_device_time_total / 1e3]
                            for e in kern[:8]]}


def moe_serve(torch, ops):
    """m-serve: (e)'s traffic (8 requests, prompts of 32-512 tokens, 64
    new) on qwen2-moe-a2.7b + AltUp K=2 in bf16 through
    Engine(n_slots=8, max_len=2048, prefill_chunk=64,
    prefix_cache=False): the eager twin and a replayed run held against
    it (hold_replay) at M_TWIN_LAYERS, then the replayed run at
    M_GRAPH_LAYERS with serve_bf16's gates (one AltUp launch a layer a
    step, one ragged a layer a decode step) and its numbers, the step
    graph's device ms and the MoE FFN's share of it. Returns (twin line,
    counted run's line)."""
    from repro_torch.serve.engine import kv_bucket
    twin_cfg = moe_config(n_layers=M_TWIN_LAYERS)
    res_t, trace_t, _ = serve_bf16(torch, ops, cfg=twin_cfg)
    res_tr, trace_tr, _ = serve_bf16(torch, ops, cfg=twin_cfg, replay=True)
    held = hold_replay({**res_t, **trace_t}, {**res_tr, **trace_tr},
                       res_tr["decode_steps"])
    twin = {"eager": res_t, "replayed": res_tr, **held}
    cfg = moe_config(n_layers=M_GRAPH_LAYERS)

    def after(eng, params):
        extra = moe_share(torch, eng)
        extra.update(moe_decode_block_ms(torch, cfg, eng.n_slots))
        e_bytes = moe_expert_bytes(cfg) * cfg.n_layers
        extra.update({"expert_bytes_per_step": e_bytes,
                      "expert_bytes_bound_ms_per_step":
                          bound_ms(e_bytes, 0, "bfloat16")[0],
                      "moe_block_ms_x_layers_over_replay":
                          extra["moe_block_ms"] * cfg.n_layers
                          / extra["device_ms_per_replay"]})
        return extra
    res, _, _ = serve_bf16(torch, ops, cfg=cfg, replay=True, after=after)
    lens = [n + E_NEW // 2 for n in E_PROMPTS]
    res["kv_bucket_halfway"] = kv_bucket(max(lens), 32, 2048)
    res["altup_launches_per_step"] = (
        res["launches"]["altup_predict_correct"]
        - res["graph"]["warmup_launches"]["altup_predict_correct"]) \
        / res["steps"]
    return twin, res


def moe_paged_twin(torch, ops):
    """m-serve's paged run: M_TWIN_LAYERS layers, bf16, a donor serves a
    shared prompt of M_SYSTEM tokens, then 8 requests extend it, through
    Engine(paged=True, pages of 16) and through the contiguous engine,
    both replayed, the prefix cache on in both: tokens and hits
    identical (the same steps run on the same rows), pages aliased, the
    paged decode attention launched."""
    from repro_torch.models.transformer import init_params
    from repro_torch.serve.engine import Engine
    from repro_torch.serve.sampling import SamplingParams
    cfg = moe_config(n_layers=M_TWIN_LAYERS)
    params = init_params(cfg, seed=59, device=DEV)
    perturb_altup(torch, params, seed=60)
    gen = torch.Generator().manual_seed(61)

    def ids(n):
        return torch.randint(0, cfg.vocab_size, (n,), generator=gen).tolist()
    system = ids(M_SYSTEM)
    prompts = [system + ids(n) for n in M_TAILS]
    out = {}
    for paged in (False, True):
        kw = dict(paged=True, page_size=16) if paged else {}
        eng = Engine(cfg, params, max_len=1024, n_slots=8, prefill_chunk=64,
                     device=DEV, **kw)
        eng.submit(system, sampling=SamplingParams(max_new=1))
        eng.run()
        ops.reset_launch_counts()
        rids = [eng.submit(p, sampling=SamplingParams(max_new=M_PAGED_NEW))
                for p in prompts]
        done = eng.run()
        out[paged] = ([list(done[r].tokens) for r in rids],
                      eng.stats["prefix_hits"], eng.paged_stats,
                      ops.launch_counts(), eng.graph_stats["replays"])
        del eng
    (tc, hc, _, cc, rc), (tp, hp, ps, cp, rp) = out[False], out[True]
    if tc != tp or hc != hp or hp < len(prompts) or \
            ps["alias_acquisitions"] <= 0 or \
            cp["paged_ragged_decode_attention"] <= 0 or rp <= 0:
        raise AssertionError(f"m-serve paged: tokens equal {tc == tp}, "
                             f"hits {hc}/{hp}, {ps}, {cp}, replays {rp}")
    del params
    torch.cuda.empty_cache()
    return {"cfg": cfg_name(cfg), "system_prompt": M_SYSTEM,
            "tails": list(M_TAILS), "new_tokens": M_PAGED_NEW,
            "tokens_identical_to_contiguous": True, "prefix_hits": hp,
            "alias_acquisitions": ps["alias_acquisitions"],
            "replays": rp,
            "launches": {k: n for k, n in cp.items() if n}}


def check_moe_kernels(torch, ops, ref):
    """Both kernels of the MoE served path at m-serve's shapes, bf16:
    the AltUp kernel at its decode step (8 tokens of d 2048) and the
    decode attention halfway through it (16 kv heads of 128, rep 1).
    Returns {"altup": ..., "ragged": ...}."""
    from repro_torch.serve.engine import kv_bucket
    lens = [n + E_NEW // 2 for n in E_PROMPTS]
    return {"altup": check_altup(torch, ops, ref, torch.bfloat16, 8,
                                 d=2048),
            "ragged": check_ragged(torch, ops, ref, torch.bfloat16, lens,
                                   Hk=16, rep=1, Dh=128,
                                   T=kv_bucket(max(lens), 32, 2048))}


def moe_phases(torch, ops, workdir):
    """The m phases, each line with its seconds; returns m-serve's
    counted run's result."""
    t_m = time.perf_counter()
    t0 = time.perf_counter()
    line("m-parity", case="moe_block", **moe_block_parity(torch),
         seconds=time.perf_counter() - t0)
    base = functools.partial(moe_config, n_layers=M_LAYERS)
    for case, kind in (("contiguous-and-paged", None), ("int8", "int8")):
        t0 = time.perf_counter()
        r = parity_f32(torch, kind, base=base)
        line("m-parity", case=case, seconds=time.perf_counter() - t0, **r)
    t0 = time.perf_counter()
    line("m-parity", case="paged-prefix-hit",
         **moe_paged_hit_f32(torch, ops), seconds=time.perf_counter() - t0)
    t0 = time.perf_counter()
    line("m-grad", **moe_grad_f32(torch, ops),
         seconds=time.perf_counter() - t0)
    t0 = time.perf_counter()
    line("m-train", **moe_train(torch, ops, workdir),
         seconds=time.perf_counter() - t0)
    t0 = time.perf_counter()
    twin, res = moe_serve(torch, ops)
    line("m-serve-twin", twin_layers=M_TWIN_LAYERS, **twin)
    line("m-serve-graph", seconds=time.perf_counter() - t0, **res)
    t0 = time.perf_counter()
    line("m-serve-paged", **moe_paged_twin(torch, ops),
         seconds=time.perf_counter() - t0)
    line("m-phases", seconds=time.perf_counter() - t_m)
    return res


def rwkv_paged_bf16(torch, ops):
    """i-paged: rwkv6-1.6b + AltUp K=2 in bf16 through Engine(paged=True,
    pages of 16) and the contiguous engine, both replayed, 4 requests
    (prompts of 16-64 tokens, 16 new) through 4 slots: tokens identical,
    no prefix hit on the paged side (a recurrent plan reuses no pages),
    every step replayed, the WKV kernel launched."""
    from repro_torch.models.transformer import init_params
    from repro_torch.serve.engine import Engine
    from repro_torch.serve.sampling import SamplingParams
    cfg = rwkv_config()
    params = init_params(cfg, seed=3, device=DEV)
    perturb_rwkv(torch, params, cfg, seed=23)
    gen = torch.Generator().manual_seed(24)
    prompts = [torch.randint(0, cfg.vocab_size, (n,), generator=gen).tolist()
               for n in (16, 33, 48, 64)]
    out = {}
    for paged in (False, True):
        kw = dict(paged=True, page_size=16) if paged else {}
        eng = Engine(cfg, params, max_len=128, n_slots=4, device=DEV, **kw)
        ops.reset_launch_counts()
        rids = [eng.submit(p, sampling=SamplingParams(max_new=16))
                for p in prompts]
        done = eng.run()
        out[paged] = ([list(done[r].tokens) for r in rids],
                      dict(eng.stats), eng.graph_stats, ops.launch_counts())
        del eng
    (tc, sc, gc, cc), (tp, sp, gp, cp) = out[False], out[True]
    if tc != tp or sp["prefix_hits"] != 0 or \
            gp["replays"] != sp["steps"] or cp["rwkv6_wkv"] <= 0:
        raise AssertionError(f"i-paged: tokens equal {tc == tp}, stats "
                             f"{sp}, graphs {gp}, launches {cp}")
    del params
    torch.cuda.empty_cache()
    return {"cfg": cfg_name(cfg), "requests": len(prompts),
            "prompt_lens": [len(p) for p in prompts], "new_tokens": 16,
            "tokens_identical_to_contiguous": True, "steps": sp["steps"],
            "replays": gp["replays"], "captures": gp["captures"],
            "launches": {k: n for k, n in cp.items() if n}}


# ---------------------------------------------------------------------------
# (n) t5-large + AltUp K=2 and (w) whisper-tiny + AltUp K=2: the
# encoder-decoder family, served by Engine.generate(encoder_frames=)
# ---------------------------------------------------------------------------

# n-serve's traffic: 8 rows of 512 encoder tokens, 16-token decoder
# prompts, 64 new tokens; w-serve's: 8 rows of 1500 frames, 4-token
# prompts, 64 new tokens
N_ENC, N_ROWS, N_PROMPT, N_NEW = 512, 8, 16, 64
W_ENC, W_ROWS, W_PROMPT, W_NEW = 1500, 8, 4, 64
# n-parity / w-parity: 4 rows, an 8-token prompt fed token by token (as
# the reference's prefill feeds it), then 16 greedy steps
P_ROWS, P_PROMPT, P_STEPS = 4, 8, 16
N_GRAD_B, N_GRAD_ENC, N_GRAD_DEC = 2, 256, 64
# n-train: lr 0.1 (0.3, k-train's, swings the loss by 4-7 nats a step
# on T5; the batches' own spread is ~1-2 nats, so halves are compared)
N_TRAIN_STEPS, N_TRAIN_B, N_TRAIN_DEC, N_TRAIN_LR = 10, 8, 128, 0.1
SEQ_MODES = ("altup", "stride_skip", "avgpool")
SEQ_STRIDE = 4
SEQ_CPU_LAYERS = 4           # n-seq's card-against-CPU encoder depth
N_SEQ_TOL = 1e-4             # of the CPU encoder output's max


def t5_config(altup_k=2, **kw):
    """t5-large (24 + 24 layers, d 1024, 16 heads of 64, f32 as the
    paper's T5), wrapped with AltUp K=2 unless altup_k < 2."""
    from repro_torch.configs import t5
    cfg = t5.altup(t5.T5_LARGE, altup_k) if altup_k > 1 else t5.T5_LARGE
    return cfg.replace(**kw)


def t5_seq_config(mode, **kw):
    """t5-large with a Sequence-AltUp encoder (stride 4) in `mode`, or
    the unreduced baseline (mode None)."""
    from repro_torch.configs import t5
    cfg = t5.T5_LARGE.replace(**kw)
    return cfg if mode is None else t5.seq_altup(cfg, SEQ_STRIDE, mode)


def whisper_config(**kw):
    """whisper-tiny (4 + 4 layers, d 384, 6 heads of 64, bf16) wrapped
    with AltUp K=2 (not recycled: vocab 51865)."""
    from repro_torch.configs import get_config
    return get_config("whisper-tiny", altup_k=2).replace(**kw)


def encdec_inputs(torch, cfg, B, S_enc, seed):
    """The encoder's input on the card: token ids (B, S_enc) for T5,
    seeded f32 noise frames (B, S_enc, d) for whisper's stubbed
    frontend."""
    gen = torch.Generator(device=DEV).manual_seed(seed)
    if cfg.use_rel_pos_bias:
        return torch.randint(0, cfg.vocab_size, (B, S_enc), generator=gen,
                             device=DEV)
    return torch.randn(B, S_enc, cfg.d_model, generator=gen, device=DEV)


def check_encdec_kernels(torch, ops, ref):
    """Both kernels at the encoder-decoder family's served shapes: the
    AltUp kernel at n-serve's decode step (8 tokens of d 1024, f32) and
    at w-serve's (8 tokens of d 384, bf16); the decode attention halfway
    through n-serve (16 kv heads of 64, rep 1, f32 storage and queries,
    then int8 codes) and through w-serve (6 kv heads of 64, bf16)."""
    from repro_torch.serve.engine import kv_bucket
    n_lens = [N_PROMPT + N_NEW // 2] * N_ROWS
    w_lens = [W_PROMPT + N_NEW // 2] * W_ROWS
    n_T = kv_bucket(max(n_lens), 32, N_PROMPT + N_NEW)
    w_T = kv_bucket(max(w_lens), 32, W_PROMPT + W_NEW)
    return {
        "n-altup": check_altup(torch, ops, ref, torch.float32, N_ROWS,
                               d=1024),
        "n-ragged": check_ragged(torch, ops, ref, torch.float32, n_lens,
                                 Hk=16, rep=1, Dh=64, T=n_T),
        "n-ragged-int8": check_ragged(torch, ops, ref, torch.float32,
                                      n_lens, Hk=16, rep=1, Dh=64, T=n_T,
                                      store="int8"),
        "w-altup": check_altup(torch, ops, ref, torch.bfloat16, W_ROWS,
                               d=384),
        "w-ragged": check_ragged(torch, ops, ref, torch.bfloat16, w_lens,
                                 Hk=6, rep=1, Dh=64, T=w_T)}


def encdec_parity_f32(torch, ops, cfg, params, S_enc, kinds=(None,)):
    """n-parity / w-parity: f32, TF32 off, the kernel path ("k": the fused
    AltUp and the decode-attention kernels) against the dense path ("d")
    through decode_step over one encode's cross caches: P_PROMPT prompt
    tokens fed one at a time, then P_STEPS greedy steps, P_ROWS rows of
    S_enc encoder positions. Gates: every step's logits within
    PARITY_TOL, greedy tokens identical, and each kernel launched once a
    decoder layer a kernel-path step. kind "int8" / "fp8": both sides
    serve from quantized self caches (cross caches float); the dense side
    reads a copy of the kernel side's caches taken after the kernel
    side's step, its own writes suppressed, and runs the fused AltUp
    kernel too, as d-quant does (rounding to codes is discontinuous)."""
    from repro_torch.models.decode import (cross_caches, decode_step,
                                           init_cache)
    from repro_torch.serve.engine import kv_bucket
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    frames = encdec_inputs(torch, cfg, P_ROWS, S_enc, seed=32)
    gen = torch.Generator(device=DEV).manual_seed(33)
    prompt = torch.randint(0, cfg.vocab_size, (P_ROWS, P_PROMPT),
                           generator=gen, device=DEV)
    cross = cross_caches(params, cfg, frames)     # shared, never written
    T = P_PROMPT + P_STEPS
    out = {}
    for kind in kinds:
        quant = kind is not None
        c = cfg.replace(kv_cache_dtype=kind) if quant else cfg
        cfgs = {"k": c.replace(ragged_decode_attn=None,
                               fused_decode_altup=None),
                "d": c.replace(ragged_decode_attn=False,
                               fused_decode_altup=None if quant else False)}
        caches = {}
        for s, cs in cfgs.items():
            caches[s] = init_cache(cs, P_ROWS, T, device=DEV)
            caches[s]["cross"] = cross
        tok = {s: prompt[:, :1] for s in cfgs}
        streams = {s: [] for s in cfgs}
        worst, launched, min_gap = 0.0, {}, math.inf
        for t in range(T - 1):
            lg = {}
            for s in ("k", "d"):
                writes = contextlib.nullcontext()
                if quant and s == "d":
                    caches["d"] = {si: {n: x.clone() for n, x in seg.items()}
                                   for si, seg in caches["k"].items()
                                   if si != "cross"}
                    caches["d"]["cross"] = cross
                    writes = no_cache_writes()
                c0 = ops.launch_counts()
                with writes, torch.no_grad():
                    logits, _ = decode_step(params, cfgs[s], caches[s],
                                            tok[s], t,
                                            kv_len=kv_bucket(t + 1, 32, T))
                if s == "k":
                    c1 = ops.launch_counts()
                    for n in c1:
                        launched[n] = launched.get(n, 0) + c1[n] - c0[n]
                lg[s] = logits[:, 0, :cfg.vocab_size]
            torch.testing.assert_close(lg["k"], lg["d"], **PARITY_TOL)
            worst = max(worst, max_err(torch, lg["k"], lg["d"]))
            if t + 1 < P_PROMPT:
                tok = {s: prompt[:, t + 1:t + 2] for s in cfgs}
                continue
            top2 = lg["d"].topk(2, dim=-1).values
            min_gap = min(min_gap, float((top2[:, 0] - top2[:, 1]).min()))
            for s in cfgs:
                # quantized: the dense side takes the kernel side's tokens
                src = "k" if quant else s
                tok[s] = lg[src].argmax(dim=-1)[:, None]
                streams[s].append(lg[s].argmax(dim=-1).tolist())
        if streams["k"] != streams["d"]:
            raise AssertionError(f"greedy tokens differ between the kernel "
                                 f"and dense paths: {streams}")
        steps = T - 1
        want = {"altup_predict_correct":
                cfg.n_layers * steps if cfg.altup.enabled else 0,
                "ragged_decode_attention": cfg.n_layers * steps}
        got = {n: launched.get(n, 0) for n in want}
        if got != want or launched.get("paged_ragged_decode_attention"):
            raise AssertionError(f"kernel-path launches {launched}, want "
                                 f"{want}")
        out[kind or "float"] = {
            "max_abs_logit_err": worst, "tol": PARITY_TOL,
            "greedy_tokens_identical": True,
            "tokens_checked": P_ROWS * len(streams["k"]),
            "min_top2_gap_dense": min_gap, "steps": steps,
            "launches_per_step": {n: got[n] / steps for n in got}}
        del caches
    return {"cfg": cfg_name(cfg), "rows": P_ROWS, "encoder_positions":
            S_enc, "cross_len": int(cross["k"].shape[2]),
            "prompt_tokens": P_PROMPT, "greedy_steps": P_STEPS,
            "tf32": [torch.backends.cuda.matmul.allow_tf32,
                     torch.backends.cudnn.allow_tf32], **out}


@contextlib.contextmanager
def timed_steps(torch):
    """Time every decode_step the Engine calls and every cross-cache fill
    (the encode) prefill runs, each ending in a synchronize: yields the
    two lists of seconds."""
    from repro_torch.models import decode as D
    from repro_torch.serve import engine as E
    real_step, real_cross = E.decode_step, D.cross_caches
    step_s, enc_s, caches = [], [], []

    def step(*a, **kw):
        t0 = time.perf_counter()
        out = real_step(*a, **kw)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        if not caches:
            caches.append(out[1])
        return out

    def cross(*a, **kw):
        t0 = time.perf_counter()
        out = real_cross(*a, **kw)
        torch.cuda.synchronize()
        enc_s.append(time.perf_counter() - t0)
        return out
    E.decode_step, D.cross_caches = step, cross
    try:
        yield step_s, enc_s, caches
    finally:
        E.decode_step, D.cross_caches = real_step, real_cross


def encdec_serve(torch, ops, cfg, params, S_enc, rows, n_prompt, n_new,
                 seed):
    """n-serve / w-serve: Engine(n_slots=rows).generate(prompts, n_new,
    encoder_frames=) on `rows` rows of S_enc encoder positions and
    n_prompt-token decoder prompts, greedy, eager (generate captures no
    CUDA graph). A warm-up generate of 2 tokens runs first; the counts
    are set to 0 just before the counted run and read just after it.
    Gates: n_new in-vocabulary tokens a row, each kernel launched once a
    decoder layer a step (prefill's token steps included), no paged
    launch. Prints ms a step (each decode_step synchronized), decode
    tok/s, the encode's ms, cache bytes and the peak memory."""
    from repro_torch.serve.engine import Engine
    frames = encdec_inputs(torch, cfg, rows, S_enc, seed=seed)
    gen = torch.Generator(device=DEV).manual_seed(seed + 1)
    prompts = torch.randint(0, cfg.vocab_size, (rows, n_prompt),
                            generator=gen, device=DEV)
    eng = Engine(cfg, params, max_len=n_prompt + n_new, n_slots=rows,
                 device=DEV)
    eng.generate(prompts, 2, encoder_frames=frames)          # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with timed_steps(torch) as (step_s, enc_s, caches):
        ops.reset_launch_counts()            # counts start at 0 right here
        t0 = time.perf_counter()
        toks = eng.generate(prompts, n_new, encoder_frames=frames)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = ops.launch_counts()         # read right after the run
    steps = len(step_s)
    if toks.shape != (rows, n_new) or not bool(
            ((toks >= 0) & (toks < cfg.vocab_size)).all()):
        raise AssertionError(f"generate gave {tuple(toks.shape)} tokens")
    want = {"altup_predict_correct":
            cfg.n_layers * steps if cfg.altup.enabled else 0,
            "ragged_decode_attention": cfg.n_layers * steps,
            "paged_ragged_decode_attention": 0}
    if {n: counts[n] for n in want} != want or steps != n_prompt + n_new - 1:
        raise AssertionError(f"launch counts {counts} for {steps} steps, "
                             f"want {want}")
    dec = sorted(step_s[n_prompt:])
    esz = lambda t: t.numel() * t.element_size()
    c = caches[0]
    return {"cfg": cfg_name(cfg), "rows": rows, "encoder_positions": S_enc,
            "prompt_tokens": n_prompt, "new_tokens": n_new,
            "graphs": "none: generate runs eager", "steps": steps,
            "decode_steps": len(dec), "launches": counts,
            "launches_per_step": {n: counts[n] / steps for n in want},
            "encode_ms": 1e3 * enc_s[0],
            "prefill_ms": 1e3 * (sum(step_s[:n_prompt]) + enc_s[0]),
            "decode_step_ms_median": 1e3 * dec[len(dec) // 2],
            "decode_step_ms_p80": 1e3 * dec[int(0.8 * len(dec))],
            "decode_step_ms_min": 1e3 * dec[0],
            "decode_tok_s": rows * len(dec) / sum(dec),
            "wall_s": wall, "wall_tok_s": rows * n_new / wall,
            "self_cache_bytes": sum(esz(x) for k, seg in c.items()
                                    if k != "cross" for x in seg.values()),
            "cross_cache_bytes": sum(esz(x) for x in c["cross"].values()),
            "params_bytes": sum(esz(t) for t in params.parameters()),
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
            "tokens_row0": toks[0, :16].tolist()}


def t5_seq(torch, ops):
    """n-seq: t5-large with a Sequence-AltUp encoder in each mode (stride
    4; altup, stride_skip, avgpool) and the unreduced baseline. The
    encoder output on the card against the CPU at full width and
    SEQ_CPU_LAYERS encoder layers (1 row of 512 tokens; N_SEQ_TOL of the
    CPU output's max); then at full depth each mode's encoder device ms
    (CUDA events, B=8 x 512, f32, TF32 off) beside the baseline's: the
    paper's Table 2 comparison on this card, not a claim; then greedy
    generate of the altup mode, kernel path against dense path: tokens
    identical, 0 AltUp and 24 decode-attention launches a step."""
    from repro_torch.models.transformer import encode, init_params
    from repro_torch.serve.engine import Engine
    torch.backends.cuda.matmul.allow_tf32 = False
    res = {"stride": SEQ_STRIDE, "cpu_check": {}, "encoder_ms_full_depth": {}}
    for mode in (None,) + SEQ_MODES:
        cfg = t5_seq_config(mode, n_layers=SEQ_CPU_LAYERS,
                            n_encoder_layers=SEQ_CPU_LAYERS)
        p = init_params(cfg, seed=40, device=DEV)
        perturb_altup(torch, p, seed=41)
        x = encdec_inputs(torch, cfg, 1, N_ENC, seed=42)
        with torch.no_grad():
            got = encode(p, cfg, x)
            want = encode(to_device(p, "cpu"), cfg, x.cpu())
        ratio = max_err(torch, got.cpu(), want) / float(want.abs().max())
        res["cpu_check"][mode or "baseline"] = {
            "shape": list(got.shape), "max_err_over_max": ratio}
        if not ratio <= N_SEQ_TOL:
            raise AssertionError(f"n-seq {mode}: card vs CPU {ratio:.3e}")
        del p
    x = None
    for mode in (None,) + SEQ_MODES:
        cfg = t5_seq_config(mode)
        p = init_params(cfg, seed=43, device=DEV)
        perturb_altup(torch, p, seed=44)
        if x is None:
            x = encdec_inputs(torch, cfg, 8, N_ENC, seed=45)
        with torch.no_grad():
            ms = time_ms(torch, lambda: encode(p, cfg, x), iters=5,
                         warmup=2)
        res["encoder_ms_full_depth"][mode or "baseline"] = ms
        del p
        torch.cuda.empty_cache()
    base = res["encoder_ms_full_depth"]["baseline"]
    res["encoder_ms_over_baseline"] = {
        m: v / base for m, v in res["encoder_ms_full_depth"].items()}
    # greedy generate, the altup mode: kernel path against dense path
    cfg = t5_seq_config("altup")
    p = init_params(cfg, seed=46, device=DEV)
    perturb_altup(torch, p, seed=47)
    frames = encdec_inputs(torch, cfg, 2, N_ENC, seed=48)
    prompts = torch.randint(0, cfg.vocab_size, (2, 8), device=DEV,
                            generator=torch.Generator(device=DEV)
                            .manual_seed(49))
    toks = {}
    for side, flag in (("k", None), ("d", False)):
        c = cfg.replace(ragged_decode_attn=flag, fused_decode_altup=flag)
        eng = Engine(c, p, max_len=24, n_slots=2, device=DEV)
        ops.reset_launch_counts()
        toks[side] = eng.generate(prompts, 16, encoder_frames=frames)
        counts = ops.launch_counts()
        if side == "k":
            steps = 8 + 16 - 1
            res["generate_launches_per_step"] = {
                n: counts[n] / steps for n in ("altup_predict_correct",
                                              "ragged_decode_attention")}
            if counts["altup_predict_correct"] != 0 or \
                    counts["ragged_decode_attention"] != cfg.n_layers * steps:
                raise AssertionError(f"n-seq generate launches {counts}")
    if not torch.equal(toks["k"], toks["d"]):
        raise AssertionError(f"n-seq generate: kernel path {toks['k']} != "
                             f"dense {toks['d']}")
    res["generate_tokens_identical"] = True
    del p
    torch.cuda.empty_cache()
    return res


def encdec_param_split(cfg):
    """(encoder parameters, decoder parameters) of cfg from init_tree on
    the meta device: the encoder's stacked layers, its final norm and its
    bias table against everything else (the decoder's layers, the cross
    blocks, the tied embedding as the output projection, the final norm,
    the decoder's bias table)."""
    import torch
    from repro_torch import tree as tree_lib
    from repro_torch.models.transformer import init_tree
    enc = dec = 0
    for path, leaf in tree_lib.leaves(init_tree(cfg, None,
                                                torch.device("meta"))):
        n = int(leaf.numel())
        if path[0] == "enc" and path[1] != "cross":
            enc += n
        else:
            dec += n
    return enc, dec


def t5_grad_f32(torch, ops):
    """n-grad: loss_fn and every leaf's gradient of t5-large + AltUp K=2 at
    full width and 2 + 2 layers on a span_corruption batch (B 2, 256
    encoder and 64 decoder tokens), card against CPU, f32, TF32 off,
    remat "none", from one seeded init drawn on the card; a second case
    with a Sequence-AltUp encoder (3 encoder layers, so that one is
    reduced, and its scalars get gradients). Gate: each leaf within
    K_GRAD_TOL of its max, loss within K_LOSS_RTOL; no kernel launched.
    Names the worst leaf and the bias tables' and scalars' own ratios."""
    from repro_torch import tree as tree_lib
    from repro_torch.data.pipeline import span_corruption_batch
    from repro_torch.models.transformer import init_params
    torch.backends.cuda.matmul.allow_tf32 = False
    res = {}
    for case, cfg in (
            ("altup2", t5_config(n_layers=2, n_encoder_layers=2,
                                 remat="none")),
            ("seq-altup", t5_seq_config("altup", n_layers=2,
                                        n_encoder_layers=3, remat="none"))):
        dev = init_params(cfg, seed=50, device=DEV).requires_grad_(True)
        perturb_altup(torch, dev, seed=51)
        cpu = to_device(dev, "cpu")
        nb = span_corruption_batch(cfg, N_GRAD_B, N_GRAD_ENC, N_GRAD_DEC,
                                   seed=3, step=0)
        t0 = time.perf_counter()
        loss_cpu, g_cpu = grads_on(torch, cpu, cfg, batch_on(torch, nb,
                                                            "cpu"))
        cpu_s = time.perf_counter() - t0
        c0 = ops.launch_counts()
        loss_dev, g_dev = grads_on(torch, dev, cfg, batch_on(torch, nb, DEV))
        torch.cuda.synchronize()
        c1 = ops.launch_counts()
        ratio, path = worst_leaf(torch, g_dev, g_cpu)
        named = {}
        for p in g_cpu:
            if p[-1] in ("rel_bias_dec", "rel_bias_enc") or \
                    p[0] == "seq_altup":
                named["/".join(p)] = worst_leaf(
                    torch, {p: g_dev[p]}, {p: g_cpu[p]})[0]
        r = {"cfg": cfg_name(cfg) + (f", seq {cfg.seq_altup.mode}"
                                     if cfg.seq_altup.enabled else ""),
             "encoder_layers": cfg.n_encoder_layers, "B": N_GRAD_B,
             "encoder_tokens": N_GRAD_ENC, "decoder_tokens": N_GRAD_DEC,
             "leaves": len(g_cpu), "cpu_s": cpu_s, "loss_cuda": loss_dev,
             "loss_cpu": loss_cpu,
             "loss_rel_err": abs(loss_dev - loss_cpu) / abs(loss_cpu),
             "worst_leaf": path, "max_err_over_max": ratio,
             "named_leaves_max_err_over_max": named,
             "launches_while_differentiating": {
                 k: c1[k] - c0[k] for k in c1 if c1[k] != c0[k]}}
        if not (ratio <= K_GRAD_TOL and r["loss_rel_err"] <= K_LOSS_RTOL) \
                or r["launches_while_differentiating"]:
            raise AssertionError(f"n-grad {case}: {r}")
        res[case] = r
        del dev, cpu, g_cpu, g_dev
        torch.cuda.empty_cache()
    return res


def t5_train(torch, ops, workdir):
    """n-train: Trainer(device="cuda") on t5-large + AltUp K=2 at full
    width and depth, f32 (TF32 off), span_corruption batches of
    N_TRAIN_B rows, 512 encoder and N_TRAIN_DEC decoder tokens,
    Adafactor (the launcher's TrainConfig, lr N_TRAIN_LR), N_TRAIN_STEPS
    steps. Gates: finite losses, the mean of the second half of the
    steps below the mean of the first half, no kernel launched. MFU
    charges each encoder parameter 6 FLOPs per encoder token and each
    decoder parameter (cross blocks and the tied output embedding
    included) 6 per decoder token, against the f32 peak."""
    import dataclasses
    import numpy as np
    from repro_torch.launch.train import train_config
    from repro_torch.train.trainer import Trainer
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = t5_config()
    tcfg = dataclasses.replace(
        train_config(N_TRAIN_STEPS, N_TRAIN_B, N_TRAIN_DEC, 1, N_TRAIN_LR,
                     str(workdir / "n-train")),
        task="span_corruption", checkpoint_every=0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    c0 = ops.launch_counts()
    tr = Trainer(cfg, tcfg, device=DEV)
    logs = []
    out = tr.run(log=logs.append)
    c1 = ops.launch_counts()
    losses = [h["loss"] for h in out["history"]]
    first, second = np.split(np.asarray(losses), 2)
    med_s = float(np.median(tr.step_times[2:]))
    enc_p, dec_p = encdec_param_split(cfg)
    enc_tok, dec_tok = N_TRAIN_B * cfg.encoder_seq, N_TRAIN_B * N_TRAIN_DEC
    flops = 6.0 * (enc_p * enc_tok + dec_p * dec_tok)
    res = {"cfg": cfg_name(cfg), "steps": out["step"],
           "rows": N_TRAIN_B, "encoder_tokens_per_step": enc_tok,
           "decoder_tokens_per_step": dec_tok,
           "first_step_s": tr.step_times[0],
           "median_step_ms_3_on": 1e3 * med_s,
           "tokens_per_s": (enc_tok + dec_tok) / med_s,
           "encoder_params": enc_p, "decoder_params": dec_p,
           "model_flops_per_step": flops,
           "mfu_f32_peak": flops / med_s / hardware("float32").peak_flops,
           "max_memory_allocated": torch.cuda.max_memory_allocated(),
           "lr": N_TRAIN_LR, "loss_first_half_mean": float(np.mean(first)),
           "loss_second_half_mean": float(np.mean(second)),
           "losses": losses, "log": logs[-1:],
           "launches": {k: c1[k] - c0[k] for k in c1 if c1[k] != c0[k]}}
    if not all(math.isfinite(x) for x in losses) or res["launches"] or \
            not res["loss_second_half_mean"] < res["loss_first_half_mean"]:
        raise AssertionError(f"n-train: {res}")
    del tr
    torch.cuda.empty_cache()
    return res


def encdec_phases(torch, ops, workdir):
    """The n and w phases, each line with its seconds; returns (n-serve's
    result, w-serve's result)."""
    from repro_torch.models.transformer import init_params
    t_n = time.perf_counter()
    # n-parity: full width and depth, f32; float, then int8 / fp8 self
    # caches
    t0 = time.perf_counter()
    cfg = t5_config()
    params = init_params(cfg, seed=30, device=DEV)
    perturb_altup(torch, params, seed=31)
    line("n-parity", **encdec_parity_f32(torch, ops, cfg, params, N_ENC,
                                         kinds=(None, "int8", "fp8")),
         seconds=time.perf_counter() - t0)
    # n-serve: the same f32 weights through Engine.generate
    t0 = time.perf_counter()
    res_n = encdec_serve(torch, ops, cfg, params, N_ENC, N_ROWS, N_PROMPT,
                         N_NEW, seed=34)
    line("n-serve", seconds=time.perf_counter() - t0, **res_n)
    del params
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    line("n-seq", **t5_seq(torch, ops), seconds=time.perf_counter() - t0)
    t0 = time.perf_counter()
    line("n-grad", **t5_grad_f32(torch, ops),
         seconds=time.perf_counter() - t0)
    t0 = time.perf_counter()
    line("n-train", **t5_train(torch, ops, workdir),
         seconds=time.perf_counter() - t0)
    # w: whisper-tiny + AltUp K=2 over 1500 frames of seeded noise
    t0 = time.perf_counter()
    cfg = whisper_config(dtype="float32", param_dtype="float32")
    params = init_params(cfg, seed=60, device=DEV)
    perturb_altup(torch, params, seed=61)
    line("w-parity", **encdec_parity_f32(torch, ops, cfg, params, W_ENC),
         seconds=time.perf_counter() - t0)
    t0 = time.perf_counter()
    cfg = whisper_config()
    params = init_params(cfg, seed=62, device=DEV)
    perturb_altup(torch, params, seed=63)
    res_w = encdec_serve(torch, ops, cfg, params, W_ENC, W_ROWS, W_PROMPT,
                         W_NEW, seed=64)
    line("w-serve", seconds=time.perf_counter() - t0, **res_w)
    del params
    torch.cuda.empty_cache()
    line("nw-phases", seconds=time.perf_counter() - t_n)
    return res_n, res_w


# ---------------------------------------------------------------------------
# (l) deepseek-v3-671b + AltUp K=2: multi-head latent attention (MLA)
# ---------------------------------------------------------------------------

# depth and expert cuts; every width is the published one
L_SERVE_LAYERS = 5        # l-serve-graph: 3 dense + 2 MoE, 51.4 GB of bf16
L_TWIN_LAYERS = 4         # l-parity, l-serve-twin, l-serve-paged: 3 + 1
L_PARITY_EXPERTS = 32     # l-parity's routed experts (top 8, shared kept)
L_GRAD_EXPERTS = 16       # l-grad: 1 dense + 1 MoE layer, f32
L_TRAIN_EXPERTS = 32      # l-train: 1 dense + 1 MoE layer, bf16
L_PAGED_TOL = 1e-5        # contiguous against paged logprobs, f32
L_GRAD_B, L_GRAD_S = 2, 64
# l-train's Adafactor learning rate: at k-train's 0.3 the 2-layer model's
# losses swung from 12.4 to 29.8 in 12 steps and its router collapsed
# (aux 4.0); 0.1 and 0.05 spiked to 25-30; 0.02 fell 12.4 -> 6.3
L_LR = 0.02


def deepseek_config(n_layers, experts=None, first_dense=None, **kw):
    """deepseek-v3-671b wrapped with AltUp K=2 (recycled: vocab > 100k)
    at every published width, cut to n_layers (first_dense of them
    dense, the published 3 unless given) and, when given, to `experts`
    routed experts (top 8 and the shared expert kept)."""
    import dataclasses
    from repro_torch.configs import get_config
    cfg = get_config("deepseek-v3-671b", altup_k=2)
    moe = cfg.moe
    if experts is not None:
        moe = dataclasses.replace(moe, num_experts=experts)
    if first_dense is not None:
        moe = dataclasses.replace(moe, first_dense_layers=first_dense)
    return cfg.replace(n_layers=n_layers, moe=moe, **kw)


def deepseek_reduced(cfg):
    """What cfg cuts from the published deepseek-v3-671b, for a phase
    line's `reduced`."""
    m = cfg.moe
    out = [f"n_layers 61 -> {cfg.n_layers} ({m.first_dense_layers} dense "
           f"+ {cfg.n_layers - m.first_dense_layers} MoE)"]
    if m.num_experts != 256:
        out.append(f"routed experts 256 -> {m.num_experts} (top "
                   f"{m.top_k} and {m.num_shared} shared kept)")
    out.append("weights: seeded random")
    return out


def mla_parity_f32(torch, ops, kind):
    """l-parity: (d)'s parity_f32 (chunked prefill and 16 greedy steps,
    kernel and paged kernel paths against the dense path, 1e-3, tokens
    identical) at full width, L_TWIN_LAYERS layers, L_PARITY_EXPERTS
    routed experts; int8 / fp8 latents against an f32 dense MLA over the
    kernel side's dequantized latents (parity_f32's dequant_dense: MLA
    attention runs no kernel, so d-quant's dense side would be the
    kernel side's own computation), at 1e-3, inside one code step (int8
    1e-2, fp8 5e-2). MLA attention runs no kernel (as in the reference):
    gated on exactly n_layers AltUp launches a step on each fused side
    and no other launch."""
    cfg = deepseek_config(L_TWIN_LAYERS, L_PARITY_EXPERTS)
    ops.reset_launch_counts()
    r = parity_f32(torch, kind, base=functools.partial(
        deepseek_config, L_TWIN_LAYERS, L_PARITY_EXPERTS),
        dequant_dense=kind is not None)
    c = ops.launch_counts()
    want = cfg.n_layers * r["steps_per_side"] * r["fused_altup_sides"]
    others = {k: n for k, n in c.items() if k != "altup_predict_correct"}
    if c["altup_predict_correct"] != want or any(others.values()):
        raise AssertionError(f"l-parity {kind}: launches {c}, want "
                             f"{want} AltUp and nothing else")
    r.update(launches={k: n for k, n in c.items() if n},
             altup_launches_per_step_and_side=cfg.n_layers,
             reduced=deepseek_reduced(cfg))
    return r


def mla_paged_hit_f32(torch, ops):
    """l-parity's paged case: f32, TF32 off, L_TWIN_LAYERS layers and
    L_PARITY_EXPERTS experts, a donor of 200 tokens, then two requests
    sharing 130 of its rows (16 new tokens, logprobs), through the
    contiguous engine and through Engine(paged=True, pages of 16), both
    replayed, the prefix cache on in both: tokens identical, chosen-token
    logprobs within L_PAGED_TOL, a hit on each side, the AltUp kernel
    launched and no attention kernel."""
    from repro_torch.models.transformer import init_params
    from repro_torch.serve.engine import Engine
    from repro_torch.serve.sampling import SamplingParams
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = deepseek_config(L_TWIN_LAYERS, L_PARITY_EXPERTS, dtype="float32",
                          param_dtype="float32")
    params = init_params(cfg, seed=70, device=DEV)
    perturb_altup(torch, params, seed=71)
    gen = torch.Generator().manual_seed(72)

    def ids(n):
        return torch.randint(0, cfg.vocab_size, (n,), generator=gen).tolist()
    donor = ids(200)
    prompts = [donor[:130] + ids(20), donor[:130] + ids(45)]
    sp = SamplingParams(max_new=16, logprobs=True)
    out = {}
    for paged in (False, True):
        kw = dict(paged=True, page_size=16) if paged else {}
        eng = Engine(cfg, params, max_len=512, n_slots=2, prefill_chunk=64,
                     device=DEV, **kw)
        eng.submit(donor, sampling=SamplingParams(max_new=4))
        eng.run()
        ops.reset_launch_counts()
        rids = [eng.submit(p, sampling=sp) for p in prompts]
        done = eng.run()
        out[paged] = ([list(done[r].tokens) for r in rids],
                      [list(done[r].logprobs) for r in rids],
                      eng.stats["prefix_hits"], ops.launch_counts(),
                      eng.graph_stats["replays"])
        del eng
    (tc, lc, hc, cc, rc), (tp, lp, hp, cp, rp) = out[False], out[True]
    lp_err = max(abs(a - b) for x, y in zip(lc, lp) for a, b in zip(x, y))
    attn = ("ragged_decode_attention", "paged_ragged_decode_attention")
    if tc != tp or lp_err > L_PAGED_TOL or min(hc, hp) < 2 or \
            min(cc["altup_predict_correct"], cp["altup_predict_correct"]) \
            <= 0 or any(c[k] for c in (cc, cp) for k in attn) or \
            min(rc, rp) <= 0:
        raise AssertionError(f"l-parity paged hit: tokens {tc} vs {tp}, "
                             f"logprob error {lp_err}, hits {hc}/{hp}, "
                             f"launches {cc} / {cp}, replays {rc}/{rp}")
    del params
    torch.cuda.empty_cache()
    return {"cfg": cfg_name(cfg), "reduced": deepseek_reduced(cfg),
            "prefix_hits": hp, "shared_rows": 130,
            "tokens_identical": True, "logprob_max_abs_err": lp_err,
            "tol": L_PAGED_TOL, "replays": [rc, rp],
            "launches": {k: n for k, n in cp.items() if n}}


def mla_grad_f32(torch, ops):
    """l-grad: m-grad's scheme on deepseek-v3-671b + AltUp K=2 at full
    width, 2 layers (1 dense, 1 MoE of L_GRAD_EXPERTS routed experts,
    top 8, the shared expert), f32, TF32 off, remat "none": loss_fn and
    every leaf's gradient (the MLA leaves, router, experts and shared
    expert) on the card against the CPU from one seeded init drawn on the
    card: each leaf within K_GRAD_TOL of its max, loss within K_LOSS_RTOL,
    aux within M_AUX_RTOL; no kernel launched."""
    from repro_torch import tree as tree_lib
    from repro_torch.data.pipeline import lm_batch
    from repro_torch.models import model as M
    from repro_torch.models.transformer import init_params
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = deepseek_config(2, L_GRAD_EXPERTS, first_dense=1, dtype="float32",
                          param_dtype="float32", remat="none")
    dev = init_params(cfg, seed=73, device=DEV).requires_grad_(True)
    perturb_altup(torch, dev, seed=74)
    cpu = to_device(dev, "cpu")
    nb = lm_batch(cfg, L_GRAD_B, L_GRAD_S, seed=3, step=0)
    nb["mask"][1, :20] = 0.0

    def run(params, device):
        paths, leaves = zip(*tree_lib.leaves(params))
        total, m = M.loss_fn(params, cfg, batch_on(torch, nb, device))
        grads = torch.autograd.grad(total, leaves)
        vals = {k: float(v.detach()) for k, v in m.items()}
        vals["total"] = float(total.detach())
        return vals, dict(zip(paths, grads))
    t0 = time.perf_counter()
    m_cpu, g_cpu = run(cpu, "cpu")
    cpu_s = time.perf_counter() - t0
    c0 = ops.launch_counts()
    m_dev, g_dev = run(dev, DEV)
    torch.cuda.synchronize()
    c1 = ops.launch_counts()
    ratio, path = worst_leaf(torch, g_dev, g_cpu)
    part = {}
    for name, key in (("mla", "attn"), ("moe", "moe")):
        part[name] = worst_leaf(
            torch, {p: g for p, g in g_dev.items() if key in p},
            {p: g for p, g in g_cpu.items() if key in p})
    res = {"cfg": cfg_name(cfg), "reduced": deepseek_reduced(cfg),
           "B": L_GRAD_B, "S": L_GRAD_S, "leaves": len(g_cpu),
           "cpu_s": cpu_s,
           "loss_cuda": m_dev["loss"], "loss_cpu": m_cpu["loss"],
           "aux_cuda": m_dev["aux_loss"], "aux_cpu": m_cpu["aux_loss"],
           "loss_rel_err": abs(m_dev["loss"] - m_cpu["loss"]) / m_cpu["loss"],
           "aux_rel_err": abs(m_dev["aux_loss"] - m_cpu["aux_loss"])
           / m_cpu["aux_loss"],
           "total_rel_err": abs(m_dev["total"] - m_cpu["total"])
           / m_cpu["total"],
           "worst_leaf": path, "max_err_over_max": ratio,
           "worst_mla_leaf": part["mla"][1],
           "mla_max_err_over_max": part["mla"][0],
           "worst_moe_leaf": part["moe"][1],
           "moe_max_err_over_max": part["moe"][0],
           "launches_while_differentiating": {
               k: c1[k] - c0[k] for k in c1 if c1[k] != c0[k]}}
    if not (ratio <= K_GRAD_TOL and res["loss_rel_err"] <= K_LOSS_RTOL
            and res["total_rel_err"] <= K_LOSS_RTOL
            and res["aux_rel_err"] <= M_AUX_RTOL) or \
            res["launches_while_differentiating"]:
        raise AssertionError(f"l-grad: {res}")
    del dev, cpu, g_cpu, g_dev
    torch.cuda.empty_cache()
    return res


def mla_train(torch, ops, workdir):
    """l-train: Trainer(device="cuda") on deepseek-v3-671b + AltUp K=2
    at full width, 2 layers (1 dense, 1 MoE of L_TRAIN_EXPERTS routed
    experts, top 8, the shared expert), bf16, the launcher's TrainConfig
    at m-train's steps and batch and L_LR. Gates: finite losses and aux losses, the mean of
    the last 3 losses below the first, no kernel launched; tokens/s,
    MFU from model_flops_per_token, peak memory."""
    import numpy as np
    from repro_torch.launch.train import train_config
    from repro_torch.models import model as M
    from repro_torch.train.trainer import Trainer
    cfg = deepseek_config(2, L_TRAIN_EXPERTS, first_dense=1)
    tcfg = train_config(M_STEPS, M_BATCH, M_SEQ, M_MB, L_LR,
                        str(workdir / "l-train"))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    c0 = ops.launch_counts()
    tr = Trainer(cfg, tcfg, device=DEV)
    logs = []
    out = tr.run(log=logs.append)
    c1 = ops.launch_counts()
    losses = [h["loss"] for h in out["history"]]
    auxes = [h["aux_loss"] for h in out["history"]]
    med_s = float(np.median(tr.step_times[2:]))
    tokens = M_BATCH * M_SEQ
    flops_tok = M.model_flops_per_token(cfg)
    res = {"cfg": cfg_name(cfg), "reduced": deepseek_reduced(cfg),
           "lr": L_LR, "steps": out["step"], "tokens_per_step": tokens,
           "microbatches": M_MB, "first_step_s": tr.step_times[0],
           "median_step_ms_3_on": 1e3 * med_s,
           "tokens_per_s": tokens / med_s,
           "active_params": M.active_param_count(cfg),
           "model_flops_per_token": flops_tok,
           "mfu_bf16_dense_peak": flops_tok * tokens / med_s
           / hardware("bfloat16").peak_flops,
           "max_memory_allocated": torch.cuda.max_memory_allocated(),
           "loss_first": losses[0],
           "loss_last3_mean": sum(losses[-3:]) / 3, "losses": losses,
           "aux_losses": auxes, "log": logs[-2:],
           "launches": {k: c1[k] - c0[k] for k in c1 if c1[k] != c0[k]}}
    if not all(math.isfinite(x) for x in losses + auxes) or \
            not res["loss_last3_mean"] < losses[0] or res["launches"]:
        raise AssertionError(f"l-train: {res}")
    del tr
    torch.cuda.empty_cache()
    return res


def mla_serve(torch, ops):
    """l-serve: (e)'s traffic (8 requests, prompts of 32-512 tokens, 64
    new) on deepseek-v3-671b + AltUp K=2 in bf16 through Engine(n_slots=8,
    max_len=2048, prefill_chunk=64, prefix_cache=False), every routed
    expert kept: the eager twin and a replayed run held against it
    (hold_replay) at L_TWIN_LAYERS, then the replayed run at
    L_SERVE_LAYERS with serve_bf16's gates (one AltUp launch a layer a
    step, no attention kernel) and its numbers: the step graph's device
    ms, the MoE FFN's and MLA attention's shares of an eager step's
    kernel time, the expert and weight bytes a decode step reads and
    their bounds. Returns (twin line, served line)."""
    import repro_torch.models.layers as layers_lib
    import repro_torch.models.moe as moe_lib
    twin_cfg = deepseek_config(L_TWIN_LAYERS)
    res_t, trace_t, _ = serve_bf16(torch, ops, cfg=twin_cfg)
    res_tr, trace_tr, _ = serve_bf16(torch, ops, cfg=twin_cfg, replay=True)
    held = hold_replay({**res_t, **trace_t}, {**res_tr, **trace_tr},
                       res_tr["decode_steps"])
    twin = {"eager": res_t, "replayed": res_tr, **held,
            "reduced": deepseek_reduced(twin_cfg)}
    cfg = deepseek_config(L_SERVE_LAYERS)
    n_moe = cfg.n_layers - cfg.moe.first_dense_layers

    def after(eng, params):
        r = range_shares(torch, eng, {
            "moe_ffn": (moe_lib, "moe_block", n_moe),
            "mla_attn": (layers_lib, "mla_attention", cfg.n_layers)})
        ranges = r.pop("ranges")
        for name, v in ranges.items():
            r.update({f"{name}_kernel_ms": v["kernel_ms"],
                      f"{name}_share_of_step_kernels": v["share"],
                      f"{name}_share_sessions": v["sessions"],
                      f"{name}_ranges": v["calls"]})
        e_bytes = moe_expert_bytes(cfg) * n_moe
        w_bytes = sum(t.numel() * t.element_size()
                      for t in params.parameters())
        r.update({"expert_bytes_per_step": e_bytes,
                  "expert_bytes_bound_ms_per_step":
                      bound_ms(e_bytes, 0, "bfloat16")[0],
                  "weight_bytes_per_step": w_bytes,
                  "weight_bytes_bound_ms_per_step":
                      bound_ms(w_bytes, 0, "bfloat16")[0]})
        r["weight_bound_share_of_replay"] = \
            r["weight_bytes_bound_ms_per_step"] / r["device_ms_per_replay"]
        return r
    res, _, _ = serve_bf16(torch, ops, cfg=cfg, replay=True, after=after)
    res["altup_launches_per_step"] = (
        res["launches"]["altup_predict_correct"]
        - res["graph"]["warmup_launches"]["altup_predict_correct"]) \
        / res["steps"]
    res["reduced"] = deepseek_reduced(cfg)
    return twin, res


def mla_paged_int8(torch, ops):
    """l-serve-paged: L_TWIN_LAYERS layers, bf16, int8 latents, a donor
    serves a shared prompt of M_SYSTEM tokens, then 8 requests extend it
    (M_TAILS, M_PAGED_NEW new tokens) through Engine(paged=True, pages of
    16), eager and replayed: tokens, hits and pool counters identical,
    pages aliased, the AltUp kernel launched, no attention kernel."""
    from repro_torch.models.transformer import init_params
    from repro_torch.serve.sampling import SamplingParams
    cfg = deepseek_config(L_TWIN_LAYERS, kv_cache_dtype="int8")
    params = init_params(cfg, seed=75, device=DEV)
    perturb_altup(torch, params, seed=76)
    gen = torch.Generator().manual_seed(77)

    def ids(n):
        return torch.randint(0, cfg.vocab_size, (n,), generator=gen).tolist()
    system = ids(M_SYSTEM)
    prompts = [system + ids(n) for n in M_TAILS]
    out = {}
    for replay in (False, True):
        eng = engine_class(replay)(cfg, params, max_len=1024, n_slots=8,
                                   prefill_chunk=64, paged=True,
                                   page_size=16, device=DEV)
        eng.submit(system, sampling=SamplingParams(max_new=1))
        eng.run()
        ops.reset_launch_counts()
        rids = [eng.submit(p, sampling=SamplingParams(max_new=M_PAGED_NEW))
                for p in prompts]
        done = eng.run()
        out[replay] = ([list(done[r].tokens) for r in rids],
                       eng.stats["prefix_hits"], eng.paged_stats,
                       ops.launch_counts(), eng.graph_stats["replays"])
        del eng
    (te, he, pe, ce, _), (tr, hr, pr, cr, rr) = out[False], out[True]
    attn = ("ragged_decode_attention", "paged_ragged_decode_attention")
    if te != tr or he != hr or pe != pr or hr < len(prompts) or \
            pr["alias_acquisitions"] <= 0 or rr <= 0 or \
            min(ce["altup_predict_correct"], cr["altup_predict_correct"]) \
            <= 0 or any(c[k] for c in (ce, cr) for k in attn):
        raise AssertionError(f"l-serve-paged: tokens equal {te == tr}, "
                             f"hits {he}/{hr}, {pe} / {pr}, {ce} / {cr}, "
                             f"replays {rr}")
    del params
    torch.cuda.empty_cache()
    return {"cfg": cfg_name(cfg), "reduced": deepseek_reduced(cfg),
            "kv_cache_dtype": "int8", "system_prompt": M_SYSTEM,
            "tails": list(M_TAILS), "new_tokens": M_PAGED_NEW,
            "tokens_identical_to_eager": True, "prefix_hits": hr,
            "alias_acquisitions": pr["alias_acquisitions"],
            "replays": rr, "launches": {k: n for k, n in cr.items() if n}}


def mla_phases(torch, ops, workdir):
    """The l phases, each line with its seconds; returns l-serve-graph's
    result."""
    t_l = time.perf_counter()
    # the served cut's init peaks near 77 GB: what earlier phases left
    line("l-start", allocated_gb=torch.cuda.memory_allocated() / 1e9,
         reserved_gb=torch.cuda.memory_reserved() / 1e9)
    for case, kind in (("contiguous-and-paged", None), ("int8", "int8"),
                       ("fp8", "fp8")):
        t0 = time.perf_counter()
        r = mla_parity_f32(torch, ops, kind)
        line("l-parity", case=case, seconds=time.perf_counter() - t0, **r)
    t0 = time.perf_counter()
    line("l-parity", case="paged-prefix-hit",
         **mla_paged_hit_f32(torch, ops), seconds=time.perf_counter() - t0)
    t0 = time.perf_counter()
    twin, res = mla_serve(torch, ops)
    line("l-serve-twin", twin_layers=L_TWIN_LAYERS, **twin)
    line("l-serve-graph", seconds=time.perf_counter() - t0, **res)
    t0 = time.perf_counter()
    line("l-serve-paged", **mla_paged_int8(torch, ops),
         seconds=time.perf_counter() - t0)
    t0 = time.perf_counter()
    line("l-grad", **mla_grad_f32(torch, ops),
         seconds=time.perf_counter() - t0)
    t0 = time.perf_counter()
    line("l-train", **mla_train(torch, ops, workdir),
         seconds=time.perf_counter() - t0)
    line("l-phases", seconds=time.perf_counter() - t_l)
    return res


# ---------------------------------------------------------------------------
# (z) zamba2-1.2b + AltUp K=2: Mamba-2 layers and one weight-tied shared
# attention block; (v) llava-next-mistral-7b + AltUp K=2; granite-3-2b
# ---------------------------------------------------------------------------

# depth cuts; every width is the published one
Z_PARITY_B, Z_PARITY_S, Z_PARITY_NEW = 2, 12, 8    # z-parity, full depth
Z_PARITY_T, Z_PARITY_PAGE = 32, 16
Z_TWIN_LAYERS = 6        # z-serve's eager twins: 6 mamba + the shared block
Z_CUT_LAYERS = 12        # z-serve's runs, cut for the run's time (of 38)
Z_GRAD_LAYERS = 12       # z-grad, z-train: two runs of 6 mamba layers, so
                         # two shared invocations keep the tie
Z_GRAD_B, Z_GRAD_S = 2, 64
# z-grad's gate, per leaf, of the leaf's max: the chunked SSD's f32
# cumsums and exps, differentiated through 12 mamba layers, round more
# than attention does (K_GRAD_TOL); each f32 side is also held against
# the CPU's float64 gradients, printed beside
Z_GRAD_TOL = 3e-4
V_TRAIN_LAYERS = 4       # v-train: ~1.15 B parameters, AdamW moments f32
TRAIN_STEPS, TRAIN_MB = 6, 2
Z_TRAIN_BATCH, Z_TRAIN_SEQ = 8, 512
V_TRAIN_BATCH, V_TRAIN_SEQ = 4, 512      # text tokens, after 576 images
ADAMW_LR = 1e-3          # z-train, v-train: AdamW, constant


def zamba_config(n_layers=None, **kw):
    """zamba2-1.2b wrapped with AltUp K=2 (not recycled: vocab 32000),
    cut to n_layers mamba layers when given."""
    from repro_torch.configs import get_config
    cfg = get_config("zamba2-1.2b", altup_k=2)
    return cfg.replace(n_layers=n_layers or cfg.n_layers, **kw)


def llava_config(n_layers=None, **kw):
    """llava-next-mistral-7b wrapped with AltUp K=2 (not recycled)."""
    from repro_torch.configs import get_config
    cfg = get_config("llava-next-mistral-7b", altup_k=2)
    return cfg.replace(n_layers=n_layers or cfg.n_layers, **kw)


def granite_config(**kw):
    """granite-3-2b wrapped with AltUp K=2 (not recycled)."""
    from repro_torch.configs import get_config
    return get_config("granite-3-2b", altup_k=2).replace(**kw)


def reduced_depth(cfg, published):
    """A phase line's `reduced`: what cfg cuts from the published
    config."""
    cut = ([] if cfg.n_layers == published
           else [f"n_layers {published} -> {cfg.n_layers}"])
    return cut + ["weights: seeded random"]


def perturb_mamba(torch, params, seed):
    """Seeded dt_bias, D, conv_b and norm in every Mamba-2 layer (the
    reference starts them at 0, 1, 0 and 0, where the gate's norm and the
    skip would be trivial), then AltUp p/g (the shared block's too)."""
    gen = torch.Generator(device=DEV).manual_seed(seed)
    with torch.no_grad():
        for name in params.keys():
            if not name.startswith("seg") or "mamba" not in params[name]:
                continue
            mb = params[name]["mamba"]
            for leaf, base, scale in (("dt_bias", 0.0, 0.5), ("D", 1.0, 0.3),
                                      ("conv_b", 0.0, 0.1),
                                      ("norm", 0.0, 0.1)):
                t = mb[leaf]
                t.copy_(base + scale * torch.randn(
                    t.shape, generator=gen, device=DEV))
    perturb_altup(torch, params, seed + 1)


def check_new_family_kernels(torch, ops, ref):
    """The kernels at the served shapes of z-serve, v-serve and granite:
    the AltUp kernel at 8 tokens of d 2048 (zamba2-1.2b and granite; bf16
    and f32) and of d 4096 (llava); both decode-attention entry points
    halfway through z-serve (the shared block: 32 kv heads of 64, rep 1;
    the 7 requests and an idle slot; the paged one through a permuted
    table of 16-row pages, bitwise equal to the contiguous one), bf16
    queries timed, f32 untimed, over float, int8 and fp8 k/v; the decode
    attention halfway through v-serve (8 kv heads of 128, rep 4) and
    granite's serve (8 kv heads of 64, rep 4), bf16."""
    from repro_torch.serve.engine import kv_bucket
    _, batch = rwkv_traffic(torch, zamba_config().vocab_size)
    z_lens = [len(p) + I_NEW // 2 for p in batch] + [0]
    z_T = kv_bucket(max(z_lens), 32, I_MAX_LEN)
    z_reserve = [pages_for(len(p) + I_NEW, 16) for p in batch] + [0]
    e_lens = [n + E_NEW // 2 for n in E_PROMPTS]
    e_T = kv_bucket(max(e_lens), 32, 2048)
    out = {}
    for dtype, name in ((torch.bfloat16, "bf16"), (torch.float32, "f32")):
        out[f"z-altup-{name}"] = check_altup(torch, ops, ref, dtype, 8,
                                             d=2048)
        for store in (None, "int8", "fp8"):
            case = name + ("" if store is None else f"-{store}")
            timed = dtype == torch.bfloat16
            out[f"z-ragged-{case}"] = check_ragged(
                torch, ops, ref, dtype, z_lens, Hk=32, rep=1, Dh=64,
                T=z_T, store=store, timed=timed)
            out[f"z-paged-{case}"] = check_paged(
                torch, ops, ref, dtype, z_lens, z_reserve,
                n_pages=I_SLOTS * I_MAX_LEN // 16, Hk=32, rep=1, Dh=64,
                T=I_MAX_LEN, t_max=z_T, page=16, store=store, timed=timed)
    out["v-altup"] = check_altup(torch, ops, ref, torch.bfloat16, 8, d=4096)
    out["v-ragged"] = check_ragged(torch, ops, ref, torch.bfloat16, e_lens,
                                   Hk=8, rep=4, Dh=128, T=e_T)
    out["granite-ragged"] = check_ragged(torch, ops, ref, torch.bfloat16,
                                         e_lens, Hk=8, rep=4, Dh=64, T=e_T)
    return out


def hybrid_parity_f32(torch, ops, kind=None):
    """z-parity: zamba2-1.2b + AltUp K=2 at full width and depth, f32,
    TF32 off. Z_PARITY_B prompts of Z_PARITY_S tokens fed one token a
    step (the engine's chunk-1 prefill of a recurrent plan), then
    Z_PARITY_NEW greedy steps, through decode_step with per-slot
    positions on three sides: "k" the kernels over contiguous caches (B1
    in every layer, B2 in every shared invocation), "p" the same over a
    page pool through a permuted block table (B4), "d" the dense path.
    Gates: every step's logits of k and p within PARITY_TOL of d's,
    greedy tokens identical, exactly 44 AltUp and 6 decode-attention
    launches a step on k and p (the paged entry point on p) and none on
    d; float: the prefill's last logits within PARITY_TOL of the dense
    forward's. kind int8 / fp8: every side stores codes, and the dense
    side, fed the kernel side's tokens, runs the AltUp kernel too and
    reads the kernel side's attention caches after its step (this step's
    rows included) with its own writes suppressed, and the mamba state
    the kernel side started the step from (d-quant's scheme: the two
    differ only in the shared block's S=1 attention)."""
    from repro_torch.models.decode import (RECURRENT_LEAVES, decode_step,
                                           init_cache, init_paged_cache)
    from repro_torch.models.transformer import (forward, init_params,
                                                layer_plan)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    quant = kind is not None
    cfg = zamba_config(dtype="float32", param_dtype="float32",
                       kv_cache_dtype=kind or "auto")
    cfgs = {"k": cfg.replace(ragged_decode_attn=None,
                             fused_decode_altup=None),
            "d": cfg.replace(ragged_decode_attn=False,
                             fused_decode_altup=None if quant else False)}
    cfgs["p"] = cfgs["k"]
    params = init_params(cfg, seed=0, device=DEV)
    perturb_mamba(torch, params, seed=30)
    plan = layer_plan(cfg)
    n_alt = max(s.layer_offset + s.n for s in plan)
    n_shared = sum(s.kind == "shared_attn" for s in plan)
    B, S, n_dec = Z_PARITY_B, Z_PARITY_S, Z_PARITY_NEW
    T, page = Z_PARITY_T, Z_PARITY_PAGE
    n_pages = B * T // page
    gen = torch.Generator(device=DEV).manual_seed(31)
    prompts = torch.randint(0, cfg.vocab_size, (B, S), generator=gen,
                            device=DEV)
    caches = {"k": init_cache(cfgs["k"], B, T, device=DEV),
              "d": init_cache(cfgs["d"], B, T, device=DEV),
              "p": init_paged_cache(cfgs["p"], B, T, n_pages=n_pages,
                                    page=page, device=DEV)}
    bt = torch.randperm(n_pages, generator=gen, device=DEV).reshape(
        B, T // page).to(torch.int32)
    pkw = {"k": {}, "d": {}, "p": {"block_table": bt, "page_size": page}}
    launches = {s: dict.fromkeys(ops.launch_counts(), 0) for s in "kpd"}

    def step(toks, t):
        """One decode_step a side at depth t: {side: (B, V) logits}."""
        pos = torch.full((B,), t, dtype=torch.long, device=DEV)
        pre = {si: {n: x.clone() for n, x in seg.items()
                    if n in RECURRENT_LEAVES}
               for si, seg in caches["k"].items()}
        lg = {}
        for side in "kpd":
            writes = contextlib.nullcontext()
            if quant and side == "d":
                caches["d"] = {si: {n: (pre[si][n] if n in pre[si]
                                        else x.clone())
                                    for n, x in seg.items()}
                               for si, seg in caches["k"].items()}
                writes = no_cache_writes()
            c0 = ops.launch_counts()
            with writes:
                out, _ = decode_step(params, cfgs[side], caches[side],
                                     toks[side][:, None], pos, **pkw[side])
            for k, n in ops.launch_counts().items():
                launches[side][k] += n - c0[k]
            lg[side] = out[:, 0, :cfg.vocab_size]
        return lg
    worst = {"k": 0.0, "p": 0.0}

    def gate(lg):
        for s in "kp":
            torch.testing.assert_close(lg[s], lg["d"], **PARITY_TOL)
            worst[s] = max(worst[s], max_err(torch, lg[s], lg["d"]))
    for t in range(S):                   # token-by-token prefill
        lg = step({s: prompts[:, t] for s in "kpd"}, t)
        gate(lg)
    res_fwd = {}
    if not quant:
        fwd = forward(params, cfgs["d"], prompts)[:, -1, :cfg.vocab_size]
        torch.testing.assert_close(lg["d"], fwd, **PARITY_TOL)
        res_fwd = {"prefill_last_vs_forward_max_abs_err":
                   max_err(torch, lg["d"], fwd)}
    tok = {s: lg[s].argmax(-1) for s in "kpd"}
    streams = {s: [tok[s].tolist()] for s in "kpd"}
    min_gap = math.inf
    for t in range(S, S + n_dec):
        if quant:
            tok["d"] = tok["k"]
        lg = step(tok, t)
        gate(lg)
        top2 = lg["d"].topk(2, dim=-1).values
        min_gap = min(min_gap, float((top2[:, 0] - top2[:, 1]).min()))
        for s in "kpd":
            tok[s] = lg[s].argmax(-1)
            streams[s].append(tok[s].tolist())
    if not streams["k"] == streams["p"] == streams["d"]:
        raise AssertionError(f"z-parity {kind}: greedy tokens differ: "
                             f"{streams}")
    steps = S + n_dec
    want = {"k": {"altup_predict_correct": n_alt,
                  "ragged_decode_attention": n_shared},
            "p": {"altup_predict_correct": n_alt,
                  "paged_ragged_decode_attention": n_shared},
            "d": {"altup_predict_correct": n_alt if quant else 0}}
    for s in "kpd":
        if any(n != want[s].get(k, 0) * steps
               for k, n in launches[s].items()):
            raise AssertionError(f"z-parity {kind}: side {s} launched "
                                 f"{launches[s]} in {steps} steps, want "
                                 f"{want[s]} a step")
    state_err = max_err(torch, caches["k"]["seg0"]["ssm"],
                        caches["p"]["seg0"]["ssm"])
    del params, caches
    torch.cuda.empty_cache()
    return {"cfg": cfg_name(cfg), "kv_cache_dtype": kind or "auto",
            "altup_layers": n_alt, "shared_invocations": n_shared,
            "slots": B, "prompt_len": S, "decode_steps": n_dec,
            "page": page, "max_abs_logit_err": worst["k"],
            "paged_max_abs_logit_err": worst["p"],
            "contiguous_vs_paged_ssm_state_max_abs_err": state_err,
            **res_fwd, "tol": PARITY_TOL, "greedy_tokens_identical": True,
            "tokens_checked": B * (n_dec + 1), "steps_per_side": steps,
            "launches_per_step": {s: {k: n / steps for k, n in
                                      launches[s].items() if n}
                                  for s in "kpd"},
            "min_top2_gap_dense": min_gap,
            "tf32": [torch.backends.cuda.matmul.allow_tf32,
                     torch.backends.cudnn.allow_tf32]}


def replay_bound(torch, eng, params, extra_bytes=0):
    """The engine's most replayed step graph replayed back to back (CUDA
    events) against the bytes a step must read: every weight, plus
    `extra_bytes` (the recurrent state read and written), and the KV rows
    its attention reads (the port's roofline decode_kv_bytes, or
    paged_gather_bytes' total on a paged engine, at the cache's
    kv_cache_dtype). The replay reads the depths its static inputs hold
    (pos + n_valid of the last S=1 step, each slot's rows after its
    write). Both shares: weights (+ state) only, and the whole step."""
    from repro_torch.roofline import analysis as ra
    gs = eng.graph_stats
    key = max(gs["replays_by_shape"], key=gs["replays_by_shape"].get)
    ms = time_ms(torch, eng._graphs._graphs[key][0].replay, iters=20,
                 warmup=3)
    w_bytes = sum(t.numel() * t.element_size() for t in params.parameters())
    host = eng._inputs[1].host
    lengths = (host["pos"] + host["nval"]).tolist()
    kw = dict(T=eng.max_len, kv_dtype=eng.cfg.kv_cache_dtype)
    kv_bytes = (ra.paged_gather_bytes(eng.cfg, lengths, page=eng._page_size,
                                      **kw)["total"] if eng._paged
                else ra.decode_kv_bytes(eng.cfg, lengths, **kw))
    b_ms, _ = bound_ms(w_bytes + extra_bytes, 0, "bfloat16")
    s_ms, _ = bound_ms(w_bytes + extra_bytes + kv_bytes, 0, "bfloat16")
    return {"replayed_shape": list(key), "device_ms_per_replay": ms,
            "weight_bytes_per_step": w_bytes,
            "state_bytes_per_step": extra_bytes,
            "kv_bytes_per_step": kv_bytes, "kv_lengths": lengths,
            "bytes_bound_ms_per_step": b_ms,
            "bytes_bound_share_of_replay": b_ms / ms,
            "step_bytes_bound_ms": s_ms,
            "step_bytes_bound_share_of_replay": s_ms / ms}


def hybrid_serve(torch, ops):
    """z-serve: (i)'s traffic on zamba2-1.2b + AltUp K=2 in bf16 through
    Engine(n_slots=8, max_len=512) (chunk-1 prefill; every step replays):
    eager twins at Z_TWIN_LAYERS against replayed runs at the same depth
    (hold_replay), contiguous float and paged int8; then replayed,
    contiguous float and int8, paged float and paged int8 at
    Z_CUT_LAYERS, with serve_recurrent_bf16's gates (one
    AltUp launch a layer and one decode-attention launch a shared
    invocation a step: 44 and 6 at full depth; contiguous:
    one recurrent hit whose tokens are a cold engine's; paged: none). The
    contiguous float run adds its step graph's device ms against the
    bytes bound (weights, and the f32 ssm state read and written) and the
    mamba layers' and shared invocations' shares of an eager step's
    kernel time. Returns (twins, {case: counted run's result})."""
    import repro_torch.models.decode as dec_lib
    twins = {}
    for case, kw in (("contiguous", {}),
                     ("paged-int8", dict(paged=True, kind="int8"))):
        cfg_t = zamba_config(Z_TWIN_LAYERS)
        res_t, trace_t, _ = serve_recurrent_bf16(torch, ops, cfg=cfg_t, **kw)
        res_tr, trace_tr, _ = serve_recurrent_bf16(torch, ops, cfg=cfg_t,
                                                   replay=True, **kw)
        held = hold_replay({**res_t, **trace_t}, {**res_tr, **trace_tr},
                           res_tr["steps"])
        twins[case] = {"eager": res_t, "replayed": res_tr, **held,
                       "reduced": reduced_depth(cfg_t, 38)}
    cfg = zamba_config()

    def after(eng, params):
        segs = eng._caches.values()
        ssm = sum(seg["ssm"].numel() * 4 for seg in segs if "ssm" in seg)
        r = replay_bound(torch, eng, params, extra_bytes=2 * ssm)
        n_mamba = sum(seg["ssm"].shape[0] for seg in segs if "ssm" in seg)
        n_shared = sum(1 for seg in segs if "k" in seg)
        sh = range_shares(torch, eng, {
            "mamba": (dec_lib, "decode_mamba", n_mamba),
            "shared_attn": (dec_lib, "decode_attn", n_shared)})
        for name, v in sh.pop("ranges").items():
            r.update({f"{name}_kernel_ms": v["kernel_ms"],
                      f"{name}_share_of_step_kernels": v["share"],
                      f"{name}_share_sessions": v["sessions"],
                      f"{name}_ranges": v["calls"]})
        r.update({k: sh[k] for k in ("eager_step_kernel_ms",
                                     "eager_step_kernels", "top_kernels")})
        return r
    full = {}
    cut = zamba_config(Z_CUT_LAYERS)
    for case, c, kw in (("contiguous", cut, dict(after=after)),
                        ("contiguous-int8", cut, dict(kind="int8")),
                        ("paged", cut, dict(paged=True)),
                        ("paged-int8", cut, dict(paged=True, kind="int8"))):
        t0 = time.perf_counter()
        res, trace, _ = serve_recurrent_bf16(torch, ops, cfg=c,
                                             replay=True, **kw)
        res.update(seconds=time.perf_counter() - t0, tokens=trace["tokens"],
                   reduced=reduced_depth(c, 38))
        full[case] = res
    for a, b in (("contiguous-int8", "paged-int8"),):
        # printed, not gated: the contiguous extender starts from its hit,
        # the paged one prefills, so the steps' batches and kv buckets
        # differ
        full[b]["tokens_equal_contiguous"] = \
            full[b]["tokens"] == full[a]["tokens"]
    for res in full.values():
        res.pop("tokens")
    return twins, full


def hybrid_grad_f32(torch, ops):
    """z-grad: zamba2-1.2b + AltUp K=2 at full width, Z_GRAD_LAYERS
    mamba layers (two shared invocations of the tied block), f32, TF32
    off, remat "none": loss_fn and every leaf's gradient on the card
    against the CPU from one seeded init drawn on the card, each leaf
    within Z_GRAD_TOL of its max, the loss within K_LOSS_RTOL; no kernel
    launched. Both f32 sides are also held against the CPU's float64
    gradients (printed: each side's own rounding)."""
    from repro_torch import tree as tree_lib
    from repro_torch.data.pipeline import lm_batch
    from repro_torch.models import model as M
    from repro_torch.models.transformer import init_params
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = zamba_config(Z_GRAD_LAYERS, dtype="float32", param_dtype="float32",
                       remat="none")
    dev = init_params(cfg, seed=32, device=DEV).requires_grad_(True)
    perturb_mamba(torch, dev, seed=33)
    cpu = to_device(dev, "cpu")
    nb = lm_batch(cfg, Z_GRAD_B, Z_GRAD_S, seed=3, step=0)
    nb["mask"][1, :20] = 0.0

    def run(params, device, c=cfg):
        paths, leaves = zip(*tree_lib.leaves(params))
        total, m = M.loss_fn(params, c, batch_on(torch, nb, device))
        grads = torch.autograd.grad(total, leaves)
        return float(m["loss"].detach()), dict(zip(paths, grads))
    t0 = time.perf_counter()
    l_cpu, g_cpu = run(cpu, "cpu")
    cpu_s = time.perf_counter() - t0
    _, g_64 = run(to_device(dev, "cpu", torch.float64), "cpu",
                  cfg.replace(dtype="float64", param_dtype="float64"))
    c0 = ops.launch_counts()
    l_dev, g_dev = run(dev, DEV)
    torch.cuda.synchronize()
    c1 = ops.launch_counts()
    ratio, path = worst_leaf(torch, g_dev, g_cpu)
    part = {key: worst_leaf(torch,
                            {p: g for p, g in g_dev.items() if key in p},
                            {p: g for p, g in g_cpu.items() if key in p})
            for key in ("shared_blk", "mamba")}
    res = {"cfg": cfg_name(cfg), "reduced": reduced_depth(cfg, 38),
           "B": Z_GRAD_B, "S": Z_GRAD_S, "leaves": len(g_cpu),
           "cpu_s": cpu_s, "loss_cuda": l_dev, "loss_cpu": l_cpu,
           "loss_rel_err": abs(l_dev - l_cpu) / l_cpu,
           "worst_leaf": path, "max_err_over_max": ratio,
           "worst_shared_blk_leaf": part["shared_blk"][1],
           "shared_blk_max_err_over_max": part["shared_blk"][0],
           "worst_mamba_leaf": part["mamba"][1],
           "mamba_max_err_over_max": part["mamba"][0],
           "tol": Z_GRAD_TOL,
           "cuda_f32_vs_cpu_f64": worst_leaf(torch, g_dev, g_64),
           "cpu_f32_vs_cpu_f64": worst_leaf(torch, g_cpu, g_64),
           "launches_while_differentiating": {
               k: c1[k] - c0[k] for k in c1 if c1[k] != c0[k]}}
    if not (ratio <= Z_GRAD_TOL and res["loss_rel_err"] <= K_LOSS_RTOL) \
            or res["launches_while_differentiating"]:
        raise AssertionError(f"z-grad: {res}")
    del dev, cpu, g_cpu, g_dev, g_64
    torch.cuda.empty_cache()
    return res


def adamw_train(torch, ops, cfg, workdir, tag, batch, seq, published):
    """z-train / v-train: Trainer(device="cuda") on cfg in bf16, TRAIN_STEPS
    steps of `batch` x `seq` tokens (a VLM's rows carry the pipeline's
    n_image_tokens patch embeddings before them) in TRAIN_MB
    microbatches, AdamW at ADAMW_LR (constant). Gates: finite losses, the
    mean of the last 3 below the first, no kernel launched; ms a step,
    tokens/s and MFU over every position a step computes (text and
    image), peak memory."""
    import numpy as np
    from repro_torch.config import OptimizerConfig, TrainConfig
    from repro_torch.models import model as M
    from repro_torch.train.trainer import Trainer
    tcfg = TrainConfig(steps=TRAIN_STEPS, seq_len=seq, global_batch=batch,
                       microbatches=TRAIN_MB, checkpoint_every=0,
                       log_every=5, checkpoint_dir=str(workdir / tag),
                       optimizer=OptimizerConfig(
                           name="adamw", learning_rate=ADAMW_LR,
                           schedule="constant", warmup_steps=1))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    c0 = ops.launch_counts()
    tr = Trainer(cfg, tcfg, device=DEV)
    out = tr.run(log=lambda _: None)
    c1 = ops.launch_counts()
    losses = [h["loss"] for h in out["history"]]
    med_s = float(np.median(tr.step_times[2:]))
    positions = batch * (seq + cfg.n_image_tokens)
    flops_pos = M.model_flops_per_token(cfg)
    res = {"cfg": cfg_name(cfg), "reduced": reduced_depth(cfg, published),
           "optimizer": "adamw", "lr": ADAMW_LR, "steps": out["step"],
           "text_tokens_per_step": batch * seq,
           "image_positions_per_step": batch * cfg.n_image_tokens,
           "microbatches": TRAIN_MB, "first_step_s": tr.step_times[0],
           "median_step_ms_3_on": 1e3 * med_s,
           "positions_per_s": positions / med_s,
           "active_params": M.active_param_count(cfg),
           "model_flops_per_position": flops_pos,
           "mfu_bf16_dense_peak": flops_pos * positions / med_s
           / hardware("bfloat16").peak_flops,
           "max_memory_allocated": torch.cuda.max_memory_allocated(),
           "loss_first": losses[0],
           "loss_last3_mean": sum(losses[-3:]) / 3, "losses": losses,
           "launches": {k: c1[k] - c0[k] for k in c1 if c1[k] != c0[k]}}
    if not all(math.isfinite(x) for x in losses) or \
            not res["loss_last3_mean"] < losses[0] or res["launches"]:
        raise AssertionError(f"{tag}: {res}")
    del tr
    torch.cuda.empty_cache()
    return res


def dense_serve(torch, ops, cfg, published):
    """v-serve / granite: (e)'s traffic on cfg in bf16, replayed, with
    serve_bf16's gates (one AltUp launch a layer a step, one decode
    attention launch a layer a decode step), text only, and the step
    graph's device ms against its weight bytes."""
    res, _, _ = serve_bf16(torch, ops, cfg=cfg, replay=True,
                           after=lambda eng, params: replay_bound(
                               torch, eng, params))
    res["altup_launches_per_step"] = (
        res["launches"]["altup_predict_correct"]
        - res["graph"]["warmup_launches"]["altup_predict_correct"]) \
        / res["steps"]
    res["reduced"] = reduced_depth(cfg, published)
    return res


def run_example(torch, name, argv):
    """examples/<name>.py's main(argv) in this process, what it prints kept
    apart. Returns (its result, its printed lines, seconds)."""
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        res = mod.main(argv)
    torch.cuda.synchronize()
    return res, buf.getvalue().splitlines(), time.perf_counter() - t0


def example_phases(torch, workdir):
    """x-examples: quickstart_torch and serve_altup_torch as written, then
    train_altup_lm_torch at its ~100M model for 30 steps: 15, a checkpoint,
    and a resume from it to 30. Gates: every loss finite and the resumed
    run starting at 15; serve_altup's contiguous and paged engines serving
    the same tokens (the reference's paged == contiguous) and its K=4
    model adding no KV-cache bytes."""
    t_x = time.perf_counter()
    res, printed, sec = run_example(
        torch, "quickstart_torch", ["--ckpt", str(workdir / "quickstart")])
    quick = {"seconds": sec, "loss_first": res["losses"][0],
             "final_loss": res["final_loss"],
             "logits_finite": res["logits_finite"],
             "generated": res["generated"][0], "last_lines": printed[-2:]}
    res, printed, sec = run_example(torch, "serve_altup_torch", [])
    serve = {"seconds": sec, "cache_bytes": res["cache_bytes"],
             "kv_read_bytes": res["kv_read_bytes"],
             "added_cache_bytes": res["added_cache_bytes"],
             "paged_equals_contiguous": res["paged_equals_contiguous"],
             "tokens": sum(len(t) for t in res["tokens"]["paged"].values()),
             "stream_tokens": len(res["stream"]),
             "lines": [ln for ln in printed if "K=" in ln]}
    ckpt = ["--ckpt", str(workdir / "train"), "--checkpoint-every", "15"]
    first, _, sec1 = run_example(torch, "train_altup_lm_torch",
                                 ["--steps", "15"] + ckpt)
    second, printed, sec2 = run_example(
        torch, "train_altup_lm_torch", ["--steps", "30", "--resume"] + ckpt)
    train = {"params": first["params"], "seconds_first_15": sec1,
             "seconds_resumed_15": sec2, "loss_first": first["losses"][0],
             "loss_at_15": first["final_loss"],
             "resumed_from": second["resumed_from"],
             "final_loss": second["final_loss"], "last_line": printed[-1]}
    losses = first["losses"] + second["losses"] + [quick["loss_first"],
                                                   quick["final_loss"]]
    ok = (all(math.isfinite(x) for x in losses) and quick["logits_finite"]
          and serve["paged_equals_contiguous"]
          and serve["added_cache_bytes"] == 0
          and second["resumed_from"] == 15 and second["step"] == 30
          and len(second["losses"]) == 15)
    line("x-examples", seconds=time.perf_counter() - t_x, ok=ok,
         quickstart=quick, serve_altup=serve, train_altup_lm=train)
    if not ok:
        raise AssertionError("x-examples: a gate failed (see its line)")


def hybrid_phases(torch, ops, workdir):
    """The z phases, each line with its seconds; returns z-serve's
    full-depth results by case."""
    t_z = time.perf_counter()
    for kind in (None, "int8", "fp8"):
        t0 = time.perf_counter()
        r = hybrid_parity_f32(torch, ops, kind)
        line("z-parity", case=kind or "float", seconds=time.perf_counter()
             - t0, **r)
    t0 = time.perf_counter()
    twins, full = hybrid_serve(torch, ops)
    for case, r in twins.items():
        line("z-serve-twin", case=case, twin_layers=Z_TWIN_LAYERS, **r)
    for case, r in full.items():
        line("z-serve", case=case, **r)
    line("z-serve-seconds", seconds=time.perf_counter() - t0)
    t0 = time.perf_counter()
    line("z-grad", **hybrid_grad_f32(torch, ops),
         seconds=time.perf_counter() - t0)
    t0 = time.perf_counter()
    line("z-train", **adamw_train(torch, ops, zamba_config(Z_GRAD_LAYERS),
                                  workdir, "z-train", Z_TRAIN_BATCH,
                                  Z_TRAIN_SEQ, 38),
         seconds=time.perf_counter() - t0)
    line("z-phases", seconds=time.perf_counter() - t_z)
    return full


def vlm_granite_phases(torch, ops, workdir):
    """v-serve, v-train and granite's serve, each line with its seconds;
    returns (v-serve's result, granite's)."""
    t_v = time.perf_counter()
    t0 = time.perf_counter()
    res_v = dense_serve(torch, ops, llava_config(), 32)
    line("v-serve", seconds=time.perf_counter() - t0, **res_v)
    t0 = time.perf_counter()
    line("v-train", **adamw_train(torch, ops, llava_config(V_TRAIN_LAYERS),
                                  workdir, "v-train", V_TRAIN_BATCH,
                                  V_TRAIN_SEQ, 32),
         seconds=time.perf_counter() - t0)
    t0 = time.perf_counter()
    res_g = dense_serve(torch, ops, granite_config(), 40)
    line("granite-serve", seconds=time.perf_counter() - t0, **res_g)
    line("v-phases", seconds=time.perf_counter() - t_v)
    return res_v, res_g


# ---------------------------------------------------------------------------
# (t) tensor-parallel serving: Engine(mesh=) over a "model" axis
# ---------------------------------------------------------------------------

# t-serve-a: Qwen3-0.6B + AltUp K=2 at full width and depth, one NCCL rank
T_PROMPTS, T_NEW, T_MAX_LEN, T_PAGE = (48, 96, 160, 224), 24, 512, 16
# t-serve-b: two gloo ranks sharing the one card, eager; short prompts in
# chunks of 16 (a chunk's logits are all-gathered through the host)
T_RANKS, T_B_PROMPTS, T_B_NEW, T_B_CHUNK = 2, (16, 24, 32, 40), 8, 16
T_B_LAYERS = 4              # Qwen3-0.6B's depth in t-serve-b
T_B_MOE_LAYERS = 2          # qwen2-moe-a2.7b's
T_B_TIMEOUT_S = 300
# t-serve-b's logits over two ranks against one rank's, bf16: the partial
# sums of wo and w2 are rounded to bf16 before their all-reduce, a
# rounding the one-rank run does not make; of max(1, the logits' max |.|)
T_B_LOGIT_TOL = 5e-2


def tp_prompts(torch, vocab, lens, seed=5):
    gen = torch.Generator().manual_seed(seed)
    return [torch.randint(0, vocab, (n,), generator=gen).tolist()
            for n in lens]


def tp_serve(torch, ops, cfg, params, prompts, n_new, mesh=None,
             paged=False, replay=True, chunk=64, max_len=T_MAX_LEN):
    """One counted run of `prompts` (greedy, n_new tokens each) through
    Engine(mesh=) (replay=False: the eager EagerEngine), after a warm-up
    request outside the count. Returns the tokens, the kernels' launches
    (counts set to 0 just before the run, read just after), the step
    counts, the graph stats and, replayed, the device ms of the most
    replayed step graph replayed back to back (CUDA events)."""
    from repro_torch.serve.sampling import SamplingParams
    kw = dict(paged=True, page_size=T_PAGE) if paged else {}
    eng = engine_class(replay)(cfg, params, max_len=max_len,
                               n_slots=len(prompts), prefill_chunk=chunk,
                               mesh=mesh, device=DEV, **kw)
    eng.submit(prompts[0][:8], sampling=SamplingParams(max_new=2))
    eng.run()
    eng.reset_stats()
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    rids = [eng.submit(p, sampling=SamplingParams(max_new=n_new))
            for p in prompts]
    out = eng.run()
    torch.cuda.synchronize()
    res = {"launches": ops.launch_counts(),
           "tokens": [list(out[r].tokens) for r in rids],
           "stats": step_stats(eng), "graph_stats": eng.graph_stats}
    gs = eng.graph_stats
    if replay and gs and gs.get("replays"):
        key = max(gs["replays_by_shape"], key=gs["replays_by_shape"].get)
        res["replay_ms"] = time_ms(torch, eng._graphs._graphs[key][0].replay,
                                   iters=20, warmup=3)
        res["replayed_shape"] = list(key)
    del eng
    return res


def tp_one_rank(torch, ops, workdir):
    """t-serve-a: a process group of one NCCL rank and its mesh
    (make_mesh((1,), ("model",))); Qwen3-0.6B + AltUp K=2 served from
    replayed graphs through Engine(mesh=) beside the un-meshed Engine,
    contiguous and paged. Gates: tokens, step counts and kernel launches
    identical, graphs captured (with their collectives); prints both
    replays' device ms: the cost of the captured collectives at N = 1."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.transformer import init_params
    cfg = served_config()
    params = init_params(cfg, seed=1, device=DEV)
    perturb_altup(torch, params, seed=11)
    prompts = tp_prompts(torch, cfg.vocab_size, T_PROMPTS)
    dist.init_process_group("nccl", store=dist.FileStore(
        str(workdir / "store-a"), 1), rank=0, world_size=1)
    out = {"cfg": cfg_name(cfg), "prompt_lens": list(T_PROMPTS),
           "new_tokens": T_NEW}
    try:
        mesh = make_mesh((1,), ("model",), device=DEV)
        for paged in (False, True):
            plain = tp_serve(torch, ops, cfg, params, prompts, T_NEW,
                             paged=paged)
            meshed = tp_serve(torch, ops, cfg, params, prompts, T_NEW,
                              mesh=mesh, paged=paged)
            for key in ("tokens", "stats", "launches"):
                if meshed[key] != plain[key]:
                    raise AssertionError(
                        f"t-serve-a ({'paged' if paged else 'contiguous'}):"
                        f" {key} over the mesh {meshed[key]} != un-meshed "
                        f"{plain[key]}")
            gm = meshed["graph_stats"]
            if not gm["captures"] or gm["replays"] != \
                    plain["graph_stats"]["replays"]:
                raise AssertionError(f"t-serve-a: graphs {gm}")
            out["paged" if paged else "contiguous"] = {
                "tokens_identical": True, "launches": meshed["launches"],
                "launches_identical": True, "captures": gm["captures"],
                "replays": gm["replays"],
                "replayed_shape": meshed["replayed_shape"],
                "replay_ms": plain["replay_ms"],
                "replay_ms_mesh": meshed["replay_ms"],
                "collectives_ms": meshed["replay_ms"] - plain["replay_ms"]}
    finally:
        dist.destroy_process_group()
    del params
    torch.cuda.empty_cache()
    return out


def tp_logits_err(torch, cfg, params, shard, mesh, B=4, seed=6):
    """max |logits over the mesh - un-meshed| and the un-meshed logits'
    max |.| over a chunk of T_B_CHUNK seeded tokens and four S = 1 steps
    (B slots); the un-meshed side on rank 0 only. Every rank calls the
    meshed steps (they hold collectives)."""
    from repro_torch.models import decode
    gen = torch.Generator().manual_seed(seed)
    tok = torch.randint(0, cfg.vocab_size, (B, T_B_CHUNK + 4),
                        generator=gen).to(DEV)
    caches = decode.init_cache(cfg, B, 64, device=DEV, mesh=mesh)
    plain = (decode.init_cache(cfg, B, 64, device=DEV)
             if mesh.get_rank() == 0 else None)
    err = top = 0.0
    steps = [(0, slice(0, T_B_CHUNK))] + [
        (T_B_CHUNK + i, slice(T_B_CHUNK + i, T_B_CHUNK + i + 1))
        for i in range(4)]
    with torch.no_grad():
        for pos, cols in steps:
            got, _ = decode.decode_step(shard, cfg, caches, tok[:, cols], pos,
                                        mesh=mesh)
            if plain is None:
                continue
            want, _ = decode.decode_step(params, cfg, plain, tok[:, cols],
                                         pos)
            err = max(err, max_err(torch, got, want))
            top = max(top, want.float().abs().max().item())
    return err, top


def tp_rank(rank, world, workdir):
    """One rank of t-serve-b (a spawned process): a gloo process group on
    the FileStore under `workdir`, the mesh over it on the card, then the
    probe of each collective on CUDA tensors; if one raises, the rank
    writes which and why and stops. Then every rank serves (b)'s traffic
    on Qwen3-0.6B + AltUp K=2 (T_B_LAYERS layers, contiguous and paged)
    and qwen2-moe-a2.7b + AltUp K=2 (T_B_MOE_LAYERS layers) through
    Engine(mesh=), eager (gloo cannot be captured); rank 0 also serves
    it un-meshed (EagerEngine) and measures the logits' distance. Writes
    its results to rank<r>.json under workdir."""
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    import torch.distributed as dist
    from repro_torch import sharding as sh
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.transformer import init_params
    res = {"rank": rank}
    dist.init_process_group("gloo", store=dist.FileStore(
        str(workdir / "store-b"), world), rank=rank, world_size=world)
    try:
        mesh = make_mesh((world,), ("model",), device=DEV)
        if not probe_collectives(torch, mesh, res):
            return
        for tag, cfg in (
                ("qwen3", served_config(n_layers=T_B_LAYERS)),
                ("qwen2_moe", moe_config(n_layers=T_B_MOE_LAYERS))):
            t0 = time.perf_counter()
            params = init_params(cfg, seed=1, device=DEV)
            perturb_altup(torch, params, seed=11)
            prompts = tp_prompts(torch, cfg.vocab_size, T_B_PROMPTS)
            run = functools.partial(tp_serve, torch, ops, cfg, params,
                                    prompts, T_B_NEW, chunk=T_B_CHUNK,
                                    max_len=128)
            r = {"mesh": run(mesh=mesh)}
            if rank == 0:
                r["one_rank"] = run(replay=False)
            if tag == "qwen3":
                r["mesh_paged"] = run(mesh=mesh, paged=True)
                if rank == 0:
                    r["one_rank_paged"] = run(replay=False, paged=True)
            shard = sh.shard_params(params, cfg, mesh)
            r["logits_err"], r["logits_max"] = tp_logits_err(
                torch, cfg, params, shard, mesh)
            r["kv_heads_local"] = sh.local_kv_heads(cfg, mesh)
            r["seconds"] = time.perf_counter() - t0
            res[tag] = r
            del params, shard
            torch.cuda.empty_cache()
    finally:
        (workdir / f"rank{rank}.json").write_text(json.dumps(res))
        dist.destroy_process_group()


def spawn_ranks(target, workdir, tag, timeout_s=T_B_TIMEOUT_S,
                world=T_RANKS):
    """`world` (T_RANKS) spawned processes running target(rank, world,
    workdir), each writing rank<r>.json under workdir; waits (at most
    timeout_s), kills any left, and returns their records in rank
    order."""
    import torch.multiprocessing as mp
    ctx = mp.start_processes(target, args=(world, workdir),
                             nprocs=world, join=False,
                             start_method="spawn")
    deadline = time.monotonic() + timeout_s
    try:
        while not ctx.join(timeout=2):
            if time.monotonic() > deadline:
                raise AssertionError(f"{tag} ran past {timeout_s} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
    return [json.loads((workdir / f"rank{r}.json").read_text())
            for r in range(world)]


def probe_collectives(torch, mesh, res):
    """Each collective of the mesh's axes on CUDA tensors; on the first
    that raises, records which and why in res and returns False."""
    from repro_torch import sharding as sh
    probes = [("all_reduce", sh.model_all_reduce),
              ("all_gather", sh.model_all_gather)]
    if sh.batch_size(mesh) > 1:
        probes.append(("batch_all_gather", sh.batch_all_gather))
    for name, fn in probes:
        try:
            fn(torch.ones(4, 8, device=DEV, dtype=torch.bfloat16), mesh)
            torch.cuda.synchronize()
        except (RuntimeError, ValueError) as e:
            res.update(collective_failed=name, error=repr(e))
            return False
    return True


def fail_on_collective(ranks, out, tag, t0=None):
    """A collective that raised on CUDA tensors in a rank fails the run:
    the phase's line is printed with which collective and why, then
    AssertionError is raised with the error."""
    failed = [r for r in ranks if "collective_failed" in r]
    if not failed:
        return
    out.update(collective_failed=failed[0]["collective_failed"],
               error=failed[0]["error"])
    if t0 is not None:
        out["seconds"] = time.perf_counter() - t0
    line(tag, **out)
    raise AssertionError(f"{tag}: the collective "
                         f"{failed[0]['collective_failed']} failed on CUDA "
                         f"tensors: {failed[0]['error']}")


def hold_ranks(ranks, tag, runs, out):
    """Gate each run of `runs` ({result key: one-rank key}) of every rank
    against rank 0's one-rank run: tokens and kernel launches equal, no
    graph captured (gloo). Records the held runs in out[tag]."""
    rec = out.setdefault(tag, {})
    for run, one_key in runs.items():
        one = ranks[0][tag][one_key]
        for r in ranks:
            got = r[tag][run]
            if got["tokens"] != one["tokens"] or \
                    got["launches"] != one["launches"]:
                raise AssertionError(
                    f"{tag} {run} rank {r['rank']}: tokens "
                    f"{got['tokens']} launches {got['launches']} != "
                    f"one rank's {one['tokens']} {one['launches']}")
            gs = got.get("graph_stats")
            if gs is not None and gs.get("captures") != 0:
                raise AssertionError(f"{tag} {run} captured: {gs}")
        rec[run] = {"tokens_identical": True,
                    "launches": ranks[0][tag][run]["launches"],
                    "graph_stats": ranks[0][tag][run].get("graph_stats")}
    return rec


def tp_two_ranks(torch, workdir):
    """t-serve-b: T_RANKS spawned ranks sharing the one card over gloo
    (NCCL refuses two ranks on one device). A collective that failed on
    CUDA tensors fails the run (fail_on_collective). Gates: every rank's
    tokens
    equal and equal to the one-rank run's at the same depth, each rank's
    kernel launches equal to it, no graph captured (captures 0, said
    why), and the logits within T_B_LOGIT_TOL of the un-meshed ones."""
    t0 = time.perf_counter()
    ranks = spawn_ranks(tp_rank, workdir, "t-serve-b")
    out = {"ranks": T_RANKS, "backend": "gloo", "seconds":
           time.perf_counter() - t0}
    fail_on_collective(ranks, out, "t-serve-b")
    for tag in ("qwen3", "qwen2_moe"):
        runs = {k: k.replace("mesh", "one_rank") for k in ranks[0][tag]
                if k.startswith("mesh")}
        rec = hold_ranks(ranks, tag, runs, out)
        rec.update(layers=T_B_LAYERS if tag == "qwen3" else T_B_MOE_LAYERS,
                   kv_heads_local=ranks[0][tag]["kv_heads_local"],
                   logits_err=ranks[0][tag]["logits_err"],
                   logits_max=ranks[0][tag]["logits_max"],
                   seconds=max(r[tag]["seconds"] for r in ranks))
        if rec["logits_err"] > T_B_LOGIT_TOL * max(1.0, rec["logits_max"]):
            raise AssertionError(f"t-serve-b {tag}: logits {rec}")
    return out


def check_tp_kernels(torch, ops, ref):
    """Phase c's cases t-*: the decode attention's two entry points at
    t-serve-b's local heads (a rank of Qwen3's 8 q / 4 kv heads, of
    qwen2-moe's 8 / 8), halfway through its requests, against their
    plain versions, timed. {case: record}."""
    from repro_torch.serve.engine import kv_bucket
    lens = [n + T_B_NEW // 2 for n in T_B_PROMPTS] * 2
    t_max = kv_bucket(max(lens), 32, 128)
    kern = {}
    for case, hk, rep in (("t-qwen3", 4, 2), ("t-qwen2-moe", 8, 1)):
        kern[case + "-ragged"] = check_ragged(
            torch, ops, ref, torch.bfloat16, lens, Hk=hk, rep=rep, T=t_max)
    reserve = [pages_for(n + T_B_NEW, T_PAGE) for n in T_B_PROMPTS] * 2
    kern["t-qwen3-paged"] = check_paged(
        torch, ops, ref, torch.bfloat16, lens, reserve, n_pages=64, Hk=4,
        rep=2, T=128, t_max=t_max, page=T_PAGE)
    return kern


# t-serve-c: the recurrent and encoder-decoder families over "model" and
# slots over "data". (a) one NCCL rank, replayed, against the un-meshed
# engine at the same depth; (b) two gloo ranks sharing the card, eager,
# against one rank. Depths cut for the phase's time
TC_RWKV_LAYERS = 4          # rwkv6-1.6b's 24
TC_ZAMBA_LAYERS = 6         # zamba2-1.2b's 38 mamba layers (+ one shared)
TC_T5_LAYERS = 2            # t5-large's 24 + 24, (b)
TC_T5_ROWS, TC_T5_ENC, TC_T5_PROMPT, TC_T5_NEW = 4, 128, 8, 8
TC_QWEN_LAYERS = 4          # Qwen3-0.6B at data = 2, (b), f32


def tpc_recurrent(torch, name, n_layers, dtype=None):
    """(cfg, params) of rwkv6-1.6b or zamba2-1.2b + AltUp K=2 at full
    width, n_layers deep, seeded and perturbed (RWKV's u / w_b / decay
    bases, Mamba-2's dt_bias / D / conv_b / norm, AltUp's p / g)."""
    from repro_torch.models.transformer import init_params
    if name == "rwkv6":
        cfg = rwkv_config(n_layers=n_layers)
    else:
        cfg = zamba_config(n_layers=n_layers)
    if dtype is not None:
        cfg = cfg.replace(dtype=dtype, param_dtype=dtype)
    params = init_params(cfg, seed=1, device=DEV)
    if name == "rwkv6":
        perturb_rwkv(torch, params, cfg, seed=11)
    else:
        perturb_mamba(torch, params, seed=11)
    return cfg, params


def tpc_one_rank(torch, ops, workdir):
    """t-serve-c (a): a process group of one NCCL rank and its mesh;
    rwkv6-1.6b + K=2 (TC_RWKV_LAYERS layers) and zamba2-1.2b + K=2
    (TC_ZAMBA_LAYERS mamba layers, contiguous and paged) served from
    replayed graphs through Engine(mesh=) beside the un-meshed Engine, at
    full width, t-serve-b's short traffic. Gates: tokens, step counts and
    kernel launches (B1, B2 / B4, B6) identical, graphs captured and
    replayed as often; prints both replays' device ms."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_mesh
    dist.init_process_group("nccl", store=dist.FileStore(
        str(workdir / "store-c"), 1), rank=0, world_size=1)
    out = {"prompt_lens": list(T_B_PROMPTS), "new_tokens": T_B_NEW}
    try:
        mesh = make_mesh((1,), ("model",), device=DEV)
        for name, layers, modes in (("rwkv6", TC_RWKV_LAYERS, (False,)),
                                    ("zamba2", TC_ZAMBA_LAYERS,
                                     (False, True))):
            cfg, params = tpc_recurrent(torch, name, layers)
            prompts = tp_prompts(torch, cfg.vocab_size, T_B_PROMPTS)
            for paged in modes:
                run = functools.partial(tp_serve, torch, ops, cfg, params,
                                        prompts, T_B_NEW, paged=paged,
                                        max_len=128)
                plain, meshed = run(), run(mesh=mesh)
                tag = name + ("_paged" if paged else "")
                for key in ("tokens", "stats", "launches"):
                    if meshed[key] != plain[key]:
                        raise AssertionError(
                            f"t-serve-c (a) {tag}: {key} over the mesh "
                            f"{meshed[key]} != un-meshed {plain[key]}")
                gm = meshed["graph_stats"]
                if not gm["captures"] or gm["replays"] != \
                        plain["graph_stats"]["replays"]:
                    raise AssertionError(f"t-serve-c (a) {tag}: graphs {gm}")
                kern = ("rwkv6_wkv" if name == "rwkv6" else
                        "paged_ragged_decode_attention" if paged
                        else "ragged_decode_attention")
                if not meshed["launches"][kern] or \
                        not meshed["launches"]["altup_predict_correct"]:
                    raise AssertionError(f"t-serve-c (a) {tag}: launches "
                                         f"{meshed['launches']}")
                out[tag] = {
                    "cfg": cfg_name(cfg), "layers": cfg.n_layers,
                    "tokens_identical": True, "launches_identical": True,
                    "launches": meshed["launches"],
                    "captures": gm["captures"], "replays": gm["replays"],
                    "replayed_shape": meshed["replayed_shape"],
                    "replay_ms": plain["replay_ms"],
                    "replay_ms_mesh": meshed["replay_ms"]}
            del params
            torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
    return out


def tpc_generate(torch, ops, cfg, params, frames, prompts, n_new, mesh=None):
    """Engine(mesh=).generate(prompts, n_new, encoder_frames=frames),
    eager (generate captures no graph), after a 2-token warm-up: the
    tokens and the kernels' launches (counts set to 0 just before the
    counted call, read just after)."""
    from repro_torch.serve.engine import Engine
    eng = Engine(cfg, params, max_len=prompts.shape[1] + n_new,
                 n_slots=prompts.shape[0], mesh=mesh, device=DEV)
    eng.generate(prompts, 2, encoder_frames=frames)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    toks = eng.generate(prompts, n_new, encoder_frames=frames)
    torch.cuda.synchronize()
    return {"launches": ops.launch_counts(), "tokens": toks.tolist(),
            "graph_stats": eng.graph_stats}


def tpc_rank(rank, world, workdir):
    """One rank of t-serve-c (b) (a spawned process): a gloo process group
    on the card, a "model" mesh of both ranks and a data x model mesh (2,
    1), each collective probed on CUDA tensors (a failure is written, with
    why, and the rank stops). Serves, eager, through Engine(mesh=): RWKV-6
    (TC_RWKV_LAYERS) and zamba2 (TC_ZAMBA_LAYERS) on t-serve-b's traffic
    and t5-large + K=2 (TC_T5_LAYERS + TC_T5_LAYERS) through
    generate(encoder_frames=) at model = 2, Qwen3-0.6B + K=2
    (TC_QWEN_LAYERS) at data = 2; rank 0 also serves each un-meshed
    (EagerEngine) and measures the model-axis logits' distance. Every
    model here is f32: in bf16 the partial sums rounded before their
    all-reduce flip near-ties of random weights (zamba2 at 6 layers
    differed from one rank at the 7th of 8 greedy tokens on the card).
    Writes rank<r>.json under workdir."""
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    import torch.distributed as dist
    from repro_torch import sharding as sh
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.transformer import forward, init_params
    res = {"rank": rank}
    dist.init_process_group("gloo", store=dist.FileStore(
        str(workdir / "store-c-b"), world), rank=rank, world_size=world)
    try:
        model = make_mesh((world,), ("model",), device=DEV)
        data = make_mesh((world, 1), ("data", "model"), device=DEV)
        if not (probe_collectives(torch, model, res)
                and probe_collectives(torch, data, res)):
            return
        for name, layers in (("rwkv6", TC_RWKV_LAYERS),
                             ("zamba2", TC_ZAMBA_LAYERS)):
            t0 = time.perf_counter()
            cfg, params = tpc_recurrent(torch, name, layers, "float32")
            prompts = tp_prompts(torch, cfg.vocab_size, T_B_PROMPTS)
            run = functools.partial(tp_serve, torch, ops, cfg, params,
                                    prompts, T_B_NEW, max_len=128)
            r = {"mesh": run(mesh=model)}
            if rank == 0:
                r["one_rank"] = run(replay=False)
            shard = sh.shard_params(params, cfg, model)
            r["logits_err"], r["logits_max"] = tp_logits_err(
                torch, cfg, params, shard, model)
            r["seconds"] = time.perf_counter() - t0
            res[name] = r
            del params, shard
            torch.cuda.empty_cache()
        # the same two in bf16: logits gated, tokens compared
        for name, layers in (("rwkv6", TC_RWKV_LAYERS),
                             ("zamba2", TC_ZAMBA_LAYERS)):
            t0 = time.perf_counter()
            cfg, params = tpc_recurrent(torch, name, layers)
            prompts = tp_prompts(torch, cfg.vocab_size, T_B_PROMPTS)
            run = functools.partial(tp_serve, torch, ops, cfg, params,
                                    prompts, T_B_NEW, max_len=128)
            r = {"mesh": run(mesh=model)}
            if rank == 0:
                r["one_rank"] = run(replay=False)
                r["divergence"] = bf16_divergence(
                    torch, cfg, params, prompts, r["one_rank"]["tokens"],
                    r["mesh"]["tokens"])
            shard = sh.shard_params(params, cfg, model)
            r["logits_err"], r["logits_max"] = tp_logits_err(
                torch, cfg, params, shard, model)
            r["seconds"] = time.perf_counter() - t0
            res[name + "_bf16"] = r
            del params, shard
            torch.cuda.empty_cache()
        # t5-large through generate(encoder_frames=)
        t0 = time.perf_counter()
        cfg = t5_config(n_layers=TC_T5_LAYERS, n_encoder_layers=TC_T5_LAYERS)
        params = init_params(cfg, seed=1, device=DEV)
        perturb_altup(torch, params, seed=11)
        frames = encdec_inputs(torch, cfg, TC_T5_ROWS, TC_T5_ENC, seed=3)
        gen = torch.Generator(device=DEV).manual_seed(4)
        prompts = torch.randint(0, cfg.vocab_size, (TC_T5_ROWS, TC_T5_PROMPT),
                                generator=gen, device=DEV)
        run = functools.partial(tpc_generate, torch, ops, cfg, params,
                                frames, prompts, TC_T5_NEW)
        r = {"mesh": run(mesh=model)}
        if rank == 0:
            r["one_rank"] = run()
        shard = sh.shard_params(params, cfg, model)
        with torch.no_grad():
            got = forward(shard, cfg, prompts, encoder_frames=frames,
                          mesh=model)
            if rank == 0:
                want = forward(params, cfg, prompts, encoder_frames=frames)
                r["logits_err"] = max_err(torch, got, want)
                r["logits_max"] = want.float().abs().max().item()
        r["seconds"] = time.perf_counter() - t0
        res["t5_large"] = r
        del params, shard
        torch.cuda.empty_cache()
        # Qwen3-0.6B's slots over data = 2, f32
        t0 = time.perf_counter()
        cfg = served_config(n_layers=TC_QWEN_LAYERS, dtype="float32",
                            param_dtype="float32")
        params = init_params(cfg, seed=1, device=DEV)
        perturb_altup(torch, params, seed=11)
        prompts = tp_prompts(torch, cfg.vocab_size, T_B_PROMPTS)
        run = functools.partial(tp_serve, torch, ops, cfg, params, prompts,
                                T_B_NEW, chunk=T_B_CHUNK, max_len=128)
        r = {"mesh": run(mesh=data)}
        if rank == 0:
            r["one_rank"] = run(replay=False)
        r["slots"] = list(sh.slot_range(len(prompts), data))
        r["seconds"] = time.perf_counter() - t0
        res["qwen3_data"] = r
        del params
        torch.cuda.empty_cache()
    finally:
        (workdir / f"rank{rank}.json").write_text(json.dumps(res))
        dist.destroy_process_group()


def bf16_divergence(torch, cfg, params, prompts, one, mesh):
    """[request, token index, the one-rank logits' top-2 margin there] at
    each request's first token where the meshed run left the one-rank
    run (one, mesh: their tokens): the margin of the un-meshed forward's
    last logits over the prompt and the one-rank tokens before it. A
    margin of a few hundredths is a near-tie that the bf16 rounding of
    the partial sums may flip; a large one would be a fault."""
    from repro_torch.models.transformer import forward
    out = []
    for i, (a, b) in enumerate(zip(one, mesh)):
        j = next((t for t, (x, y) in enumerate(zip(a, b)) if x != y), None)
        if j is None:
            continue
        tok = torch.tensor([prompts[i] + a[:j]], device=DEV)
        with torch.no_grad():
            logits = forward(params, cfg, tok)[0, -1, :cfg.vocab_size]
        top = torch.topk(logits.float(), 2).values
        out.append([i, j, float(top[0] - top[1])])
    return out


def tpc_two_ranks(torch, workdir):
    """t-serve-c (b): T_RANKS spawned ranks sharing the card over gloo. A
    collective that failed on CUDA tensors fails the run
    (fail_on_collective). Gates: every rank's tokens and kernel launches
    equal to the one-rank run's at the same depth, no graph captured, the
    model-axis logits within T_B_LOGIT_TOL of max(1, |logits|) of one
    rank's, and the data ranks holding half the slots each. The bf16 run
    of RWKV-6 and zamba2 beside the f32 one (tag + "_bf16") is gated on
    its logits within T_B_LOGIT_TOL only: its tokens may leave one rank's
    at a near-tie, and at each such token the one-rank logits' top-2
    margin is printed (bf16_divergence)."""
    t0 = time.perf_counter()
    ranks = spawn_ranks(tpc_rank, workdir, "t-serve-c (b)")
    out = {"ranks": T_RANKS, "backend": "gloo", "dtype": "float32"}
    fail_on_collective(ranks, out, "t-serve-c-b", t0)
    for tag in ("rwkv6", "zamba2", "t5_large", "qwen3_data"):
        rec = hold_ranks(ranks, tag, {"mesh": "one_rank"}, out)
        rec["seconds"] = max(r[tag]["seconds"] for r in ranks)
        if tag == "qwen3_data":
            held = sorted(tuple(r[tag]["slots"]) for r in ranks)
            if held != [(0, 2), (2, 4)]:
                raise AssertionError(f"t-serve-c (b) data slots {held}")
            rec.update(slots=held)
            continue
        rec.update(logits_err=ranks[0][tag]["logits_err"],
                   logits_max=ranks[0][tag]["logits_max"])
        if rec["logits_err"] > T_B_LOGIT_TOL * max(1.0, rec["logits_max"]):
            raise AssertionError(f"t-serve-c (b) {tag}: logits {rec}")
    for tag in ("rwkv6_bf16", "zamba2_bf16"):
        one = ranks[0][tag]["one_rank"]
        rec = out[tag] = {
            "dtype": "bfloat16",
            "tokens_identical": [r[tag]["mesh"]["tokens"] == one["tokens"]
                                 for r in ranks],
            "ranks_agree": all(r[tag]["mesh"]["tokens"]
                               == ranks[0][tag]["mesh"]["tokens"]
                               for r in ranks),
            "bf16_divergence": ranks[0][tag]["divergence"],
            "logits_err": ranks[0][tag]["logits_err"],
            "logits_max": ranks[0][tag]["logits_max"],
            "seconds": max(r[tag]["seconds"] for r in ranks)}
        if rec["logits_err"] > T_B_LOGIT_TOL * max(1.0, rec["logits_max"]):
            raise AssertionError(f"t-serve-c (b) {tag}: logits {rec}")
    out["seconds"] = time.perf_counter() - t0
    return out


def check_tpc_kernels(torch, ops, ref):
    """Phase c's cases for t-serve-c: the WKV kernel at a rank's local
    heads of rwkv6-1.6b (8 slots, 16 heads of 64 at N = 2, 8 at N = 4, the
    state in place) and the decode attention at t5-large's local heads (8
    of 64 at N = 2, rep 1, f32, halfway through (b)'s generate), each
    against its plain version, timed. {case: record}."""
    from repro_torch.serve.engine import kv_bucket
    kern = {}
    for H in (16, 8):
        kern[f"tc-wkv-h{H}"] = check_wkv(torch, ops, ref, torch.bfloat16,
                                         B=8, H=H, Dh=64, S=1,
                                         state="random")
    lens = [TC_T5_PROMPT + TC_T5_NEW // 2] * TC_T5_ROWS
    kern["tc-t5-ragged"] = check_ragged(
        torch, ops, ref, torch.float32, lens, Hk=8, rep=1, Dh=64,
        T=kv_bucket(max(lens), 32, TC_T5_PROMPT + TC_T5_NEW))
    return kern


# t-serve-d: the rest of A11's serving over data = 2, two gloo ranks
# sharing the card, eager, against one rank. (a) paged caches over
# "data": (g)'s shared 250-token system prompt, TD_PAGED_REQ requests
# through TD_PAGED_SLOTS slots (recycled), pages aliased across the ranks;
# (b) the long-context layout: one slot of TD_LONG_MAX rows, a prompt of
# TD_LONG_PROMPT tokens whose rows both ranks hold. Qwen3-0.6B + K=2 at
# full width, TD_LAYERS deep
TD_LAYERS = 4               # Qwen3-0.6B's 28
TD_PAGED_SLOTS, TD_PAGED_REQ, TD_PAGED_NEW, TD_PAGED_MAX = 4, 6, 8, 512
TD_LONG_PROMPT, TD_LONG_NEW, TD_LONG_MAX, TD_LONG_CHUNK = 5000, 32, 8192, 256
TD_LOGIT_CHUNK = 1024       # the logits check's prefill chunks
# phase c's case of the split pass and the merge: (e)'s heads, a slot of
# TD_T rows over 2 and 4 ranks
TD_T = 32768
# a span's f32 partial state (unnormalised sums of up to 128 weighted
# rows, the max and the denominator) against its plain version
SPLIT_TOL = dict(atol=1e-3, rtol=1e-4)


def pool_digest(torch, caches):
    """sha256 of every row-pooled leaf's bytes, in order."""
    import hashlib
    from repro_torch.models.decode import _paged_row_axis
    h = hashlib.sha256()
    for seg in caches.values():
        for name, leaf in seg.items():
            if _paged_row_axis(name, leaf.ndim) is not None:
                h.update(leaf.contiguous().reshape(-1).view(torch.uint8)
                         .cpu().numpy().tobytes())
    return h.hexdigest()


def tpd_paged(torch, ops, cfg, params, prompts, mesh=None):
    """One counted run of `prompts` (greedy, TD_PAGED_NEW tokens each)
    through a paged EagerEngine over TD_PAGED_SLOTS slots (pages of
    T_PAGE rows), after a warm-up request outside the count: tokens,
    launches, paged counters, the pool's digest and, over a batch axis,
    the last step's pool sync (rows and bytes a rank sent)."""
    from repro_torch.serve.sampling import SamplingParams
    eng = engine_class(False)(cfg, params, max_len=TD_PAGED_MAX,
                              n_slots=TD_PAGED_SLOTS, prefill_chunk=64,
                              mesh=mesh, paged=True, page_size=T_PAGE,
                              device=DEV)
    eng.submit(prompts[0][:8], sampling=SamplingParams(max_new=2))
    eng.run()
    eng.reset_stats()
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    rids = [eng.submit(p, sampling=SamplingParams(max_new=TD_PAGED_NEW))
            for p in prompts]
    out = eng.run()
    torch.cuda.synchronize()
    res = {"launches": ops.launch_counts(),
           "tokens": [list(out[r].tokens) for r in rids],
           "stats": step_stats(eng), "paged_stats": eng.paged_stats,
           "pool_digest": pool_digest(torch, eng._caches),
           "slots": [eng._lo, eng._hi]}
    if mesh is not None:
        # a decode step's sync: one row a slot of this rank, every layer
        res["sync_rows_per_step"] = eng._hi - eng._lo
        res["sync_bytes_last_step"] = eng.last_sync_bytes
    del eng
    return res


def tpd_long(torch, ops, cfg, params, prompt, mesh=None):
    """One counted run of the long prompt (greedy, TD_LONG_NEW tokens)
    through an EagerEngine of one slot of TD_LONG_MAX rows, chunks of
    TD_LONG_CHUNK, after a warm-up request: tokens, launches, the bytes
    of the caches the rank holds."""
    from repro_torch.serve.sampling import SamplingParams
    eng = engine_class(False)(cfg, params, max_len=TD_LONG_MAX, n_slots=1,
                              prefill_chunk=TD_LONG_CHUNK, mesh=mesh,
                              device=DEV)
    eng.submit(prompt[:8], sampling=SamplingParams(max_new=2))
    eng.run()
    eng.reset_stats()
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    rid = eng.submit(prompt, sampling=SamplingParams(max_new=TD_LONG_NEW))
    out = eng.run()
    torch.cuda.synchronize()
    res = {"launches": ops.launch_counts(), "tokens": [list(out[rid].tokens)],
           "stats": step_stats(eng), "cache_bytes": cache_bytes(eng)}
    del eng
    return res


def tpd_logits_err(torch, cfg, params, shard, mesh, prompt):
    """max |logits under the long-context layout - un-meshed| and the
    un-meshed logits' max |.| over the long prompt in chunks of
    TD_LOGIT_CHUNK and two S = 1 steps (one slot, TD_LONG_MAX rows); the
    un-meshed side on rank 0 only."""
    from repro_torch import sharding as sh
    from repro_torch.models import decode
    tok = torch.tensor([prompt], device=DEV)
    seq = sh.SeqSplit(TD_LONG_MAX)
    caches = decode.init_cache(cfg, 1, TD_LONG_MAX, device=DEV, mesh=mesh,
                               seq=seq)
    plain = (decode.init_cache(cfg, 1, TD_LONG_MAX, device=DEV)
             if mesh.get_rank() == 0 else None)
    n = len(prompt) - 2
    steps = [(p, slice(p, min(p + TD_LOGIT_CHUNK, n)))
             for p in range(0, n, TD_LOGIT_CHUNK)]
    steps += [(n + i, slice(n + i, n + i + 1)) for i in range(2)]
    err = top = 0.0
    with torch.no_grad():
        for pos, cols in steps:
            got, _ = decode.decode_step(shard, cfg, caches, tok[:, cols], pos,
                                        mesh=mesh, seq=seq)
            if plain is None:
                continue
            want, _ = decode.decode_step(params, cfg, plain, tok[:, cols],
                                         pos)
            err = max(err, max_err(torch, got, want))
            top = max(top, want.float().abs().max().item())
    return err, top


def tpd_rank(rank, world, workdir):
    """One rank of t-serve-d (a spawned process): a gloo group on the
    card and a data x model mesh (2, 1), each collective probed on CUDA
    tensors (a failure is written, with why, and the rank stops). Serves
    Qwen3-0.6B + K=2 (TD_LAYERS) eager through Engine(mesh=): (a) paged,
    bf16 and int8, (b) the long-context layout, bf16 and int8, with the
    logits' distance; rank 0 also serves each un-meshed (EagerEngine).
    Writes rank<r>.json under workdir."""
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    import torch.distributed as dist
    from repro_torch import sharding as sh
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.transformer import init_params
    res = {"rank": rank}
    dist.init_process_group("gloo", store=dist.FileStore(
        str(workdir / "store-d"), world), rank=rank, world_size=world)
    try:
        data = make_mesh((world, 1), ("data", "model"), device=DEV)
        if not probe_collectives(torch, data, res):
            return
        cfg0 = served_config(n_layers=TD_LAYERS)
        params = init_params(cfg0, seed=1, device=DEV)
        perturb_altup(torch, params, seed=11)
        _, _, g_prompts = paged_traffic(torch, cfg0.vocab_size)
        long_prompt = tp_prompts(torch, cfg0.vocab_size, (TD_LONG_PROMPT,),
                                 seed=9)[0]
        for kind in ("bf16", "int8"):
            cfg = cfg0 if kind == "bf16" else cfg0.replace(
                kv_cache_dtype="int8")
            t0 = time.perf_counter()
            prompts = [p[:G_SYSTEM + 40] for p in g_prompts[:TD_PAGED_REQ]]
            r = {"mesh": tpd_paged(torch, ops, cfg, params, prompts, data)}
            if rank == 0:
                r["one_rank"] = tpd_paged(torch, ops, cfg, params, prompts)
            r["seconds"] = time.perf_counter() - t0
            res["paged_" + kind] = r
            t0 = time.perf_counter()
            r = {"mesh": tpd_long(torch, ops, cfg, params, long_prompt, data)}
            if rank == 0:
                r["one_rank"] = tpd_long(torch, ops, cfg, params, long_prompt)
            shard = sh.shard_params(params, cfg, data)
            r["logits_err"], r["logits_max"] = tpd_logits_err(
                torch, cfg, params, shard, data, long_prompt)
            # the workspace one S = 1 step gathers, per layer: every rank's
            # split pass over the spans of its rows at the run's last bucket
            split = sh.RowShard(cfg, data, TD_LONG_MAX)
            from repro_torch.serve.engine import kv_bucket
            tb = kv_bucket(TD_LONG_PROMPT + TD_LONG_NEW, 32, TD_LONG_MAX)
            spans = split.kernel_read(tb) // 128
            hk = sh.local_kv_heads(cfg, data)
            ws = spans * hk * (cfg.n_heads // cfg.n_kv_heads) * (
                cfg.resolved_head_dim + 2) * 4
            r.update(rows_per_rank=split.Tr, ranks=split.R,
                     workspace_bytes_per_layer=split.R * ws,
                     workspace_bytes_per_step=split.R * ws * cfg.n_layers,
                     seconds=time.perf_counter() - t0)
            res["long_" + kind] = r
            del shard
            torch.cuda.empty_cache()
    finally:
        (workdir / f"rank{rank}.json").write_text(json.dumps(res))
        dist.destroy_process_group()


def tpd_two_ranks(torch, workdir):
    """t-serve-d: T_RANKS spawned ranks sharing the card over gloo (a
    collective that fails on CUDA tensors fails the run). Gates: (a)
    every rank's tokens and launches equal the one-rank run's, its B4
    launched, both ranks' pools bitwise equal and their page counters
    equal, the slots split [0, 2) / [2, 4), pages aliased; (b) every
    rank's tokens equal the one-rank run's, the split pass and the merge
    launched as often as the one-rank run's B2 (once a layer a decode
    step) and B2 itself never, each rank's caches about half of one
    rank's, the logits within T_B_LOGIT_TOL of max(1, |logits|)."""
    t0 = time.perf_counter()
    ranks = spawn_ranks(tpd_rank, workdir, "t-serve-d")
    out = {"ranks": T_RANKS, "backend": "gloo", "layers": TD_LAYERS}
    fail_on_collective(ranks, out, "t-serve-d", t0)
    for kind in ("bf16", "int8"):
        tag = "paged_" + kind
        rec = hold_ranks(ranks, tag, {"mesh": "one_rank"}, out)
        meshed = [r[tag]["mesh"] for r in ranks]
        if len({m["pool_digest"] for m in meshed}) != 1 or any(
                m["paged_stats"] != meshed[0]["paged_stats"]
                for m in meshed):
            raise AssertionError(f"t-serve-d (a) {kind}: pools differ "
                                 f"{[m['pool_digest'] for m in meshed]}")
        held = sorted(tuple(m["slots"]) for m in meshed)
        ps = meshed[0]["paged_stats"]
        if held != [(0, 2), (2, 4)] or not ps["alias_acquisitions"] or \
                not meshed[0]["launches"]["paged_ragged_decode_attention"]:
            raise AssertionError(f"t-serve-d (a) {kind}: {held} {ps} "
                                 f"{meshed[0]['launches']}")
        rec.update(pools_identical=True, slots=held, paged_stats=ps,
                   sync_rows_per_step=meshed[0]["sync_rows_per_step"],
                   sync_bytes_last_step=[m["sync_bytes_last_step"]
                                         for m in meshed],
                   seconds=max(r[tag]["seconds"] for r in ranks))
        tag = "long_" + kind
        one = ranks[0][tag]["one_rank"]
        r0 = ranks[0][tag]
        for r in ranks:
            m = r[tag]["mesh"]
            lc = m["launches"]
            if m["tokens"] != one["tokens"] or lc["ragged_decode_attention"] \
                    or not lc["ragged_decode_split"] or \
                    lc["ragged_decode_split"] != lc["ragged_decode_merge"] \
                    or lc["ragged_decode_split"] != \
                    one["launches"]["ragged_decode_attention"] or \
                    m["cache_bytes"] > 0.6 * one["cache_bytes"]:
                raise AssertionError(f"t-serve-d (b) {kind} rank "
                                     f"{r['rank']}: {m} != one rank's {one}")
        rec = out[tag] = {
            "tokens_identical": True, "launches": r0["mesh"]["launches"],
            "one_rank_launches": one["launches"],
            "cache_bytes_per_rank": [r[tag]["mesh"]["cache_bytes"]
                                     for r in ranks],
            "cache_bytes_one_rank": one["cache_bytes"],
            "rows_per_rank": r0["rows_per_rank"], "rank_count": r0["ranks"],
            "workspace_bytes_per_layer": r0["workspace_bytes_per_layer"],
            "workspace_bytes_per_step": r0["workspace_bytes_per_step"],
            "logits_err": r0["logits_err"], "logits_max": r0["logits_max"],
            "seconds": max(r[tag]["seconds"] for r in ranks)}
        if rec["logits_err"] > T_B_LOGIT_TOL * max(1.0, rec["logits_max"]):
            raise AssertionError(f"t-serve-d (b) {kind}: logits {rec}")
    out["seconds"] = time.perf_counter() - t0
    return out


def check_split_merge(torch, ops, ref, store, cuts, timed=False, Hk=8,
                      rep=2, Dh=128, T=TD_T, seed=7):
    """Phase c's case for the long-context layout's S = 1 path at (e)'s
    heads (bf16 q): the split pass over each shard [cuts[i], cuts[i+1])
    (ops.ragged_decode_split, the rank's own lengths) and the merge over
    the workspaces concatenated in shard order (ops.ragged_decode_merge)
    bitwise equal to ops.ragged_decode_attn over the whole rows; each
    shard's workspace against the plain states (on its written spans),
    the merge against the plain merge of the same gathered workspace,
    and the whole against the plain attention, within B2's tolerances.
    Timed: device ms of the first shard's split, of the merge and of the
    unsharded call (torch.profiler, 50 calls), with their bounds."""
    from repro_torch.kernels.ragged_decode_attention import SPAN
    dtype = torch.bfloat16
    bounds = [0] + list(cuts) + [T]
    lens_host = sorted({0, 1, SPAN - 1, SPAN + 1, T} | {
        c + d for c in cuts for d in (-1, 1)})
    gen = torch.Generator(device=DEV).manual_seed(seed)
    B, H = len(lens_host), Hk * rep
    q = torch.randn(B, 1, H, Dh, generator=gen, device=DEV).to(dtype)
    k = torch.randn(B, T, Hk, Dh, generator=gen, device=DEV).to(dtype)
    v = torch.randn(B, T, Hk, Dh, generator=gen, device=DEV).to(dtype)
    k, v, ks, vs = stored_kv(torch, k, v, None if store == "bf16" else store,
                             dtype)
    lens = torch.tensor(lens_host, dtype=torch.int32, device=DEV)
    qg = q[:, 0].reshape(B, Hk, rep, Dh)

    def shard(i):
        lo, hi = bounds[i], bounds[i + 1]
        sl = (slice(None), slice(lo, hi))
        return (k[sl], v[sl], None if ks is None else ks[sl],
                None if vs is None else vs[sl],
                torch.clamp(lens - lo, 0, hi - lo))

    def split(i):
        kk, vv, kks, vvs, own = shard(i)
        return ops.ragged_decode_split(q, kk, vv, own, kks, vvs)
    parts = [split(i) for i in range(len(bounds) - 1)]
    ws = torch.cat(parts, dim=2)
    got = ops.ragged_decode_merge(ws, lens, dtype)
    whole = ops.ragged_decode_attn(q, k, v, lens, ks, vs)
    torch.cuda.synchronize()
    if not torch.equal(got, whole):
        raise AssertionError(f"split + merge over {cuts} ({store}) is not "
                             f"the whole call bit for bit: "
                             f"{max_err(torch, got, whole)}")
    errs = []
    for i, part in enumerate(parts if timed else ()):  # written spans only
        kk, vv, kks, vvs, own = shard(i)
        want = ref.ragged_decode_states_ref(qg, kk, vv, own, kks, vvs,
                                            span=SPAN)
        n = torch.div(own + SPAN - 1, SPAN, rounding_mode="floor")
        live = (torch.arange(part.shape[2], device=DEV)[None]
                < n[:, None])[:, None, :, None, None]
        part = torch.where(live, part, 0)
        torch.testing.assert_close(part, want, **SPLIT_TOL)
        errs.append(max_err(torch, part, want))
    plain_merge = ref.ragged_decode_merge_ref(ws, lens, dtype, span=SPAN)
    torch.testing.assert_close(got.reshape(plain_merge.shape), plain_merge,
                               **BF16_TOL)
    dense = (ref.ragged_decode_ref(qg, k, v, lens) if ks is None
             else ref.ragged_decode_quant_ref(qg, k, v, ks, vs, lens))
    torch.testing.assert_close(got.reshape(dense.shape), dense, **BF16_TOL)
    res = {"store": store, "cuts": list(cuts), "B": B, "Hk": Hk, "rep": rep,
           "Dh": Dh, "T": T, "lengths": lens_host, "bitwise_whole": True,
           "split_max_abs_err": max(errs) if errs else None,
           "merge_max_abs_err": max_err(torch, got.reshape(
               plain_merge.shape), plain_merge),
           "max_abs_err": max_err(torch, got.reshape(dense.shape), dense)}
    if not timed:
        return res
    # the first shard's split (a rank's), the merge, the unsharded call
    kk, vv, kks, vvs, own = shard(0)
    rows = int(own.sum())
    spans0 = int(torch.div(own + SPAN - 1, SPAN, rounding_mode="floor").sum())
    spans = int(torch.div(lens + SPAN - 1, SPAN, rounding_mode="floor").sum())
    state = rep * (Dh + 2) * 4 * Hk
    s_bytes = rows * Hk * kv_row_bytes(k, ks, Dh) + B * H * Dh * 2 + \
        spans0 * state + 4 * B
    s_bound = bound_ms(s_bytes, rows * Hk * rep * Dh * 4, "float32")
    m_bytes = spans * state + B * H * Dh * 2 + 4 * B
    m_bound = bound_ms(m_bytes, spans * Hk * rep * (Dh + 2) * 3, "float32")
    res.update({
        "split_ms": device_ms(torch, lambda: split(0),
                              "ragged_decode_split_kernel", per_call=1),
        "split_plain_ms": device_ms(torch, lambda: ref.ragged_decode_states_ref(
            qg, kk, vv, own, kks, vvs, span=SPAN), iters=1),
        "split_bound_ms": s_bound[0], "split_bound_by": s_bound[1],
        "split_bytes": s_bytes, "split_rows": rows,
        "merge_ms": device_ms(torch, lambda: ops.ragged_decode_merge(
            ws, lens, dtype), "ragged_decode_merge_kernel", per_call=1),
        "merge_plain_ms": device_ms(torch, lambda: ref.ragged_decode_merge_ref(
            ws, lens, dtype, span=SPAN), iters=1),
        "merge_bound_ms": m_bound[0], "merge_bound_by": m_bound[1],
        "merge_bytes": m_bytes, "spans": spans,
        "unsharded_ms": device_ms(torch, lambda: ops.ragged_decode_attn(
            q, k, v, lens, ks, vs), RAGGED_KERNELS, per_call=2)})
    return res


def check_tpd_kernels(torch, ops, ref):
    """Phase c's cases for t-serve-d: check_split_merge at D = 2 and 4
    (sharding.shard_rows' even splits of TD_T rows) and one uneven split,
    bf16, int8 and fp8 codes; timed at D = 2 (bf16 and int8). {case:
    record}."""
    from repro_torch import sharding as sh
    even = {D: [i * sh.shard_rows(TD_T, D) for i in range(1, D)]
            for D in (2, 4)}
    cases = {"d2": even[2], "d4": even[4], "uneven": [3 * 4096]}
    kern = {}
    for store in ("bf16", "int8", "fp8"):
        for name, cuts in cases.items():
            kern[f"td-{name}-{store}"] = check_split_merge(
                torch, ops, ref, store, cuts,
                timed=name == "d2" and store != "fp8")
    return kern


# t-train: A11's training over "model" (Trainer(mesh=), loss_fn(mesh=),
# the collectives' autograd Functions). (a) one NCCL rank: k-train's model
# at full width and depth beside the un-meshed Trainer, bitwise; (b) two
# gloo ranks sharing the card, f32, against one rank's un-meshed run
TT_STEPS = 3
TT_LR = 0.01                # constant: a step moves a leaf by 1% of its RMS
TT_QWEN_LAYERS = 4          # Qwen3-0.6B's 28, (b)
TT_RWKV_LAYERS = 2          # rwkv6-1.6b's 24, (b)
TT_ZAMBA_LAYERS = 6         # zamba2-1.2b's 38 mamba layers, (b)
TT_T5_LAYERS = 2            # t5-large's 24 + 24, (b)
TT_B_BATCH, TT_B_SEQ, TT_B_ENC = 2, 128, 128
# (b)'s gates in f32: the gathered gradients (of each leaf's largest
# entry, at least 1e-6 of the largest gradient), the losses of TT_STEPS
# Adafactor steps and the next step's after a restore (relative), the
# gathered parameters after the steps (of each leaf's largest entry)
TT_GRAD_TOL = 1e-4
TT_LOSS_RTOL = 1e-4
TT_PARAM_TOL = 1e-3
# bf16 distances are held to the f32 run's, at least f32's unit
# roundoff 2^-24, times the ratio of the two formats' unit roundoffs
# (2^-8 / 2^-24)
TT_BF16_SCALE = 2.0 ** 16
TT_F32_ROUNDOFF = 2.0 ** -24


def ttrain_tcfg(torch, steps, batch, seq, mb, ckpt, task="causal_lm"):
    """The launcher's TrainConfig (Adafactor at TT_LR, clipping at 1.0)
    with a constant schedule from step 0: TT_STEPS steps move the
    parameters, and no checkpoint but the ones asked for."""
    import dataclasses
    from repro_torch.launch.train import train_config
    tc = train_config(steps, batch, seq, mb, TT_LR, ckpt)
    return dataclasses.replace(
        tc, checkpoint_every=0, task=task,
        optimizer=dataclasses.replace(tc.optimizer, schedule="constant",
                                      warmup_steps=0))


def ttrain_one_rank(torch, workdir):
    """t-train (a): a world-1 NCCL group and its "model" mesh; k-train's
    config (Qwen3-0.6B + AltUp K=2, full width and depth, bf16) trained
    TT_STEPS Adafactor steps of K_BATCH x K_SEQ in K_MB microbatches with
    clipping by Trainer(mesh=) and by the un-meshed Trainer, same seed
    and batches, deterministic algorithms on. Gates: losses and every
    parameter bitwise equal, no collective issued (a group of one).
    Prints the median ms of a step of each."""
    import numpy as np
    import torch.distributed as dist
    from repro_torch import sharding as sh
    from repro_torch import tree as tree_lib
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.train.trainer import Trainer
    cfg = served_config()
    tcfg = ttrain_tcfg(torch, TT_STEPS, K_BATCH, K_SEQ, K_MB, "")
    dist.init_process_group("nccl" if DEV == "cuda" else "gloo",
                            store=dist.FileStore(str(workdir / "store-tt-a"),
                                                 1), rank=0, world_size=1)
    out = {"cfg": cfg_name(cfg), "steps": TT_STEPS,
           "tokens_per_step": K_BATCH * K_SEQ, "microbatches": K_MB}
    runs = {}
    torch.use_deterministic_algorithms(True)
    try:
        mesh = make_mesh((1,), ("model",), device=DEV)
        for tag, m in (("plain", None), ("mesh", mesh)):
            sh.reset_collective_counts()
            tr = Trainer(cfg, tcfg, m, device=DEV)
            res = tr.run(log=lambda s: None)
            torch.cuda.synchronize()
            runs[tag] = {"losses": [h["loss"] for h in res["history"]],
                         "grad_norms": [h["grad_norm"]
                                        for h in res["history"]],
                         "step_ms": [1e3 * s for s in tr.step_times],
                         "collectives": sh.collective_counts(),
                         "params": dict(tree_lib.leaves(tr.params))}
            del tr
            torch.cuda.empty_cache()
    finally:
        torch.use_deterministic_algorithms(False)
        dist.destroy_process_group()
    plain, meshed = runs["plain"], runs["mesh"]
    differ = [".".join(p) for p, t in plain["params"].items()
              if not torch.equal(t, meshed["params"][p])]
    out.update(losses=plain["losses"], grad_norms=plain["grad_norms"],
               losses_bitwise=plain["losses"] == meshed["losses"],
               params_bitwise=not differ, params_differ=differ[:4],
               collectives=meshed["collectives"],
               step_ms=plain["step_ms"], step_ms_mesh=meshed["step_ms"],
               median_step_ms=float(np.median(plain["step_ms"])),
               median_step_ms_mesh=float(np.median(meshed["step_ms"])))
    if not out["losses_bitwise"] or differ or meshed["collectives"]:
        line("t-train-a", **out)
        raise AssertionError(
            f"t-train (a): over a mesh of one rank losses "
            f"{meshed['losses']} vs {plain['losses']}, parameters "
            f"differing {differ[:4]}, collectives {meshed['collectives']}")
    del runs
    torch.cuda.empty_cache()
    return out


def ttrain_model(torch, name, dtype="float32"):
    """(cfg, whole params on the card, the trainer's task) of (b)'s model
    `name`, seeded and perturbed as t-serve-c's."""
    from repro_torch.models.transformer import init_params
    if name in ("rwkv6", "zamba2"):
        layers = TT_RWKV_LAYERS if name == "rwkv6" else TT_ZAMBA_LAYERS
        cfg, params = tpc_recurrent(torch, name, layers, dtype)
        return cfg, params, "causal_lm"
    if name == "t5":
        cfg = t5_config(n_layers=TT_T5_LAYERS, n_encoder_layers=TT_T5_LAYERS,
                        encoder_seq=TT_B_ENC)
        task = "span_corruption"
    else:
        cfg = served_config(n_layers=TT_QWEN_LAYERS,
                            context_parallel_attn=name == "qwen3_cp")
        task = "causal_lm"
    cfg = cfg.replace(dtype=dtype, param_dtype=dtype)
    params = init_params(cfg, seed=1, device=DEV)
    perturb_altup(torch, params, seed=11)
    return cfg, params, task


def ttrain_case(torch, name, mesh, rank, workdir, dtype="float32",
                checkpoint=True, batch_rows=TT_B_BATCH):
    """One model of t-train (b) (and (c): a mesh with a data axis, the
    batch of batch_rows split over its ranks) on this rank. Every rank
    also runs the
    un-meshed path (on the same card) and holds its own shard against
    the matching part of it (sharding.shard_leaf), so nothing is
    gathered to compare: the first batch's gradients over the mesh
    (on the rank's rows, summed over the data ranks; the digests of the
    replicated ones kept) against the whole batch's, TT_STEPS Adafactor
    steps
    of Trainer(mesh=) against the un-meshed Trainer (losses, the
    parameters after them), the collectives of one gradient and of the
    steps; then a checkpoint at model = 2 (gathered, rank 0 writes), one
    more meshed step, and rank 0 restores the checkpoint into its
    un-meshed Trainer and takes that step too (checkpoint=False: not
    this part; the context-parallel run, whose checkpoint is the flag-off
    run's). Returns the distances
    (gradients and parameters as shares of each leaf's largest entry,
    gradients at least 1e-6 of the largest gradient; losses relative),
    the counts, the digests of the replicated parameters after the steps
    and the seconds of each part."""
    import dataclasses
    import hashlib
    from repro_torch import sharding as sh
    from repro_torch import tree as tree_lib
    from repro_torch.data.pipeline import make_batch
    from repro_torch.models.model import loss_fn
    from repro_torch.models.transformer import ParamTree
    from repro_torch.train.trainer import Trainer
    t0 = time.perf_counter()
    cfg, whole, task = ttrain_model(torch, name, dtype)
    ckpt = str(workdir / f"tt-{name}-{dtype}")
    tcfg = ttrain_tcfg(torch, TT_STEPS, batch_rows, TT_B_SEQ, 1, ckpt, task)
    shards = sh.leaf_shards(cfg, mesh)
    res = {"layers": cfg.n_layers, "dtype": dtype, "seconds_parts": {}}

    def part(tag, t):
        torch.cuda.synchronize()
        res["seconds_parts"][tag] = time.perf_counter() - t

    def grads(params, m, b):
        params.requires_grad_(True)
        paths, leaves = zip(*tree_lib.leaves(params))
        total, metrics = loss_fn(params, cfg, b, mesh=m)
        g = torch.autograd.grad(total, leaves)
        if sh.batch_size(m) > 1:
            g = sh.batch_grad_sum(list(g), m)
        return float(metrics["loss"].detach()), dict(zip(paths, g))

    def digests(tree):
        return {"/".join(p): hashlib.sha256(t.detach().float().cpu()
                                            .numpy().tobytes()).hexdigest()
                for p, t in tree.items() if shards[p] is None}

    def clone(tree):
        return ParamTree(tree_lib.tree_map(torch.clone, tree))

    def dist_to(local, want, floor=0.0):
        """max over leaves of |local - the rank's part of want| over
        max(|want leaf|, floor)."""
        return max(
            (t.float() - sh.shard_leaf(want[p], shards[p], mesh).float())
            .abs().max().item() / max(want[p].abs().max().item(), floor,
                                      1e-30)
            for p, t in local.items())

    tr = Trainer(cfg, tcfg, mesh, device=DEV, params=clone(whole))
    batch = tr._batch(0)                   # the rank's rows
    glob = {k: torch.from_numpy(v).to(DEV)
            for k, v in make_batch(cfg, tcfg, 0).items()}
    t1 = time.perf_counter()
    sh.reset_collective_counts()
    loss, g = grads(sh.shard_params(clone(whole), cfg, mesh), mesh, batch)
    torch.cuda.synchronize()
    res["collectives_grad"] = sh.collective_counts()
    res["replicated"] = digests(g)
    want_loss, want = grads(clone(whole), None, glob)
    top = max(w.abs().max().item() for w in want.values())
    res["grad_err"] = dist_to(g, want, 1e-6 * top)
    res["loss_err"] = abs(loss - want_loss) / max(abs(want_loss), 1e-6)
    del g, want
    part("gradients", t1)
    t1 = time.perf_counter()
    sh.reset_collective_counts()
    hist = tr.run(log=lambda s: None)["history"]
    torch.cuda.synchronize()
    res["collectives_steps"] = sh.collective_counts()
    res["losses"] = [h["loss"] for h in hist]
    plain = Trainer(cfg, dataclasses.replace(tcfg, checkpoint_dir=""),
                    device=DEV, params=clone(whole))
    want = [h["loss"] for h in plain.run(log=lambda s: None)["history"]]
    res["want_losses"] = want
    res["losses_err"] = max(abs(a - b) / max(abs(b), 1e-6)
                            for a, b in zip(res["losses"], want))
    res["param_err"] = dist_to(dict(tree_lib.leaves(tr.params)),
                               dict(tree_lib.leaves(plain.params)))
    res["replicated_params"] = digests(dict(tree_lib.leaves(tr.params)))
    part("steps", t1)
    if not checkpoint:
        del tr, plain, whole
        torch.cuda.empty_cache()
        res["seconds"] = time.perf_counter() - t0
        return res
    t1 = time.perf_counter()
    tr.checkpoint()
    part("checkpoint", t1)
    tr.tcfg = dataclasses.replace(tcfg, steps=TT_STEPS + 1)
    res["next_loss"] = tr.run(log=lambda s: None)["history"][-1]["loss"]
    if rank == 0:
        t1 = time.perf_counter()
        plain.tcfg = dataclasses.replace(tcfg, steps=TT_STEPS + 1)
        plain.maybe_resume()
        res["restored_step"] = plain.step
        res["restored_next_loss"] = plain.run(
            log=lambda s: None)["history"][-1]["loss"]
        res["next_loss_err"] = (
            abs(res["restored_next_loss"] - res["next_loss"])
            / max(abs(res["restored_next_loss"]), 1e-6))
        part("restore", t1)
    del tr, plain, whole
    torch.cuda.empty_cache()
    res["seconds"] = time.perf_counter() - t0
    return res


TT_MODELS = ("qwen3", "qwen3_cp", "rwkv6", "zamba2", "t5")
# the models whose checkpoint (b) writes and restores: not the
# context-parallel run (the flag off's model and checkpoint), nor RWKV-6
# since PR 33 (its 2 GB of f32 embed and lm_head took 13 s to write)
TT_CHECKPOINTED = ("qwen3", "zamba2", "t5")


def ttrain_rank(rank, world, workdir):
    """One rank of t-train (b) (a spawned process): a gloo group on the
    card, the "model" mesh of both ranks, the collectives probed on CUDA
    tensors (the three forward ones and, under autograd, the backward
    all-reduce and reduce-scatter; a failure is written, with why, and the
    rank stops), then ttrain_case for each of TT_MODELS in f32 and Qwen3
    in bf16; then (c)'s data 2 x model 1 mesh of the same ranks, its
    collectives probed, and Qwen3 over it. Writes rank<r>.json under
    workdir."""
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_mesh
    res = {"rank": rank}
    torch.backends.cuda.matmul.allow_tf32 = False   # full f32 products
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group("gloo", store=dist.FileStore(
        str(workdir / "store-tt-b"), world), rank=rank, world_size=world)
    try:
        mesh = make_mesh((world,), ("model",), device=DEV)
        if not (probe_collectives(torch, mesh, res)
                and probe_train_collectives(torch, mesh, res)):
            return
        for name in TT_MODELS:
            res[name] = ttrain_case(torch, name, mesh, rank, workdir,
                                    checkpoint=name in TT_CHECKPOINTED)
        res["qwen3_bf16"] = ttrain_case(torch, "qwen3", mesh, rank, workdir,
                                        "bfloat16")
        # (c) over data 2 x model 1, the same two ranks
        t0 = time.perf_counter()
        data = make_mesh((world, 1), ("data", "model"), device=DEV)
        if not probe_data_collectives(torch, data, res):
            return
        res["qwen3_data2"] = ttrain_case(torch, "qwen3", data, rank, workdir,
                                         checkpoint=False,
                                         batch_rows=TT_C_BATCH)
        res["qwen3_data2"]["seconds"] = time.perf_counter() - t0
    finally:
        (workdir / f"rank{rank}.json").write_text(json.dumps(res))
        dist.destroy_process_group()


def probe_train_collectives(torch, mesh, res):
    """The backward collectives of training on CUDA tensors: an f's
    all-reduce and the reduce-scatter of gather_whole; on the first that
    raises, records which and why in res and returns False."""
    from repro_torch import sharding as sh
    for name, fn in (("copy_to_model backward all_reduce",
                      lambda x: sh.copy_to_model(x, mesh)),
                     ("gather_whole backward reduce_scatter",
                      lambda x: sh.gather_whole(x, mesh, 0))):
        try:
            x = torch.ones(4, 8, device=DEV, requires_grad=True)
            with torch.enable_grad():
                fn(x).sum().backward()
            torch.cuda.synchronize()
        except (RuntimeError, ValueError) as e:
            res.update(collective_failed=name, error=repr(e))
            return False
    return True


# t-train (c) and (d): A11's training over "data" and expert parallelism,
# gloo ranks sharing the card, f32. (c) Qwen3 at TT_QWEN_LAYERS over data
# 2 x model 1 ((b)'s two ranks) and data 2 x model 2 (four ranks) against
# the un-meshed path on the whole batch; (d) qwen2-moe at published widths
# and TT_D_LAYERS over data 2 x model 2 at its own capacity factor (drops)
# against the expert-parallel routing emulated on one rank (moe_ffn_local
# on each source shard's tokens at that shard's capacity)
TT_C_BATCH = 4              # (c)'s global batch of TT_B_SEQ
TT_C_RANKS = 4
TT_D_LAYERS = 2             # qwen2-moe's 24, (d)
TT_D_BATCH, TT_D_SEQ = 4, 128
# (c): the gathered gradients (of each leaf's largest entry) and the
# losses of TT_STEPS steps (relative); (d): the EP block's output and
# gradients (of each leaf's largest entry) and the aux loss and a
# Trainer step's loss (relative) against the emulation
TT_C_GRAD_TOL, TT_C_LOSS_RTOL = 1e-4, 1e-6
TT_D_TOL, TT_D_LOSS_RTOL = 1e-4, 1e-5
TT_D_AUX_W = 0.7


def probe_data_collectives(torch, mesh, res):
    """The collectives of training over a batch axis on CUDA tensors: the
    loss's batch sum under autograd, the gradients' all-reduce and the
    counts' all-gather; over a model axis of more than one rank also the
    experts' all-to-all forward and backward. On the first that raises,
    records which and why in res and returns False."""
    from repro_torch import sharding as sh
    probes = [("batch_sum", lambda x: sh.batch_sum(x, mesh).sum()),
              ("batch_grad_sum", lambda x: sh.batch_grad_sum(
                  [x.detach()], mesh)[0].sum()),
              ("batch_all_gather", lambda x: sh.batch_all_gather(
                  x.detach(), mesh).sum())]
    if sh.model_size(mesh) > 1:
        probes.append(("all_to_all", lambda x: sh.model_all_to_all(
            x.reshape(sh.model_size(mesh), -1), mesh).sum()))
    for name, fn in probes:
        try:
            x = torch.ones(4, 8, device=DEV, requires_grad=True)
            with torch.enable_grad():
                y = fn(x)
                if y.requires_grad:
                    y.backward()
            torch.cuda.synchronize()
        except (RuntimeError, ValueError) as e:
            res.update(collective_failed=name, error=repr(e))
            return False
    return True


def ep_emulation(torch, p, moe, x, shards, activation="silu"):
    """moe_block's expert-parallel result computed on one rank: the flat
    tokens of x (B, S, d) split in order into `shards` source shards, each
    routed by moe_ffn_local at capacity_for(its tokens), the aux loss of
    f_e and P_e averaged over the shards, the shared experts as moe_block
    runs them. Returns (out, aux, dropped assignments a shard)."""
    from repro_torch.models import moe as moe_lib
    from repro_torch.models.layers import ffn_block
    B, S, d = x.shape
    flat = x.reshape(B * S, d)
    n = B * S // shards
    cap = moe_lib.capacity_for(n, moe)
    ys, fs, Ps, drops = [], [], [], []
    for i in range(shards):
        xs = flat[i * n:(i + 1) * n]
        _, top_i, (f_e, P_e) = moe_lib.router_probs(p, moe, xs)
        slot = moe_lib._dispatch_indices(top_i, moe.padded_experts)[1]
        drops.append(int((slot >= cap).sum()))
        ys.append(moe_lib.moe_ffn_local(p, moe, xs, cap)[0])
        fs.append(f_e)
        Ps.append(P_e)
    aux = moe_lib.aux_loss(moe, sum(fs) / shards, sum(Ps) / shards)
    out = torch.cat(ys).reshape(B, S, d)
    if moe.num_shared > 0:
        out = ffn_block(p["shared"], x, activation) + out
    return out, aux, drops


def ttrain_moe_block(torch, cfg, mesh, rank):
    """(d)'s block check on this rank: layer 0's routed experts at
    published width (seeded on the card) over the mesh, expert-parallel,
    on the rank's rows of a seeded (TT_D_BATCH, TT_D_SEQ, d) input, and
    the gradients of sum(y * cot) + TT_D_AUX_W aux (the data ranks' parts
    summed); rank 0 gathers them and holds them against ep_emulation.
    Every rank counts its shard's dropped assignments."""
    import dataclasses
    from repro_torch import sharding as sh
    from repro_torch.models import moe as moe_lib
    moe = dataclasses.replace(cfg.moe, num_shared=0)
    whole = moe_layer0(torch, cfg.replace(moe=moe), seed=71)
    gen = torch.Generator(device=DEV).manual_seed(72)
    x = torch.randn(TT_D_BATCH, TT_D_SEQ, cfg.d_model, generator=gen,
                    device=DEV)
    cot = torch.randn(x.shape, generator=gen, device=DEV)
    D, M = sh.batch_size(mesh), sh.model_size(mesh)
    E = moe.padded_experts
    El, m, b = E // M, sh.model_rank(mesh), sh.batch_rank(mesh)
    rows = slice(b * TT_D_BATCH // D, (b + 1) * TT_D_BATCH // D)
    names = ("router", "w1", "w3", "w2")
    p = {k: (whole[k] if k == "router" else whole[k][m * El:(m + 1) * El])
         .clone().requires_grad_(True) for k in names}
    xr = x[rows].clone().requires_grad_(True)
    t0 = time.perf_counter()
    sh.reset_collective_counts()
    with torch.enable_grad():
        y, aux = moe_lib.moe_block(p, moe, xr, mesh=mesh)
        total = sh.batch_sum((y * cot[rows]).sum(), mesh) + \
            TT_D_AUX_W * aux
        g = torch.autograd.grad(total, [xr] + [p[k] for k in names])
    gp = sh.batch_grad_sum(list(g[1:]), mesh)
    torch.cuda.synchronize()
    res = {"collectives": sh.collective_counts(),
           "ep_ms": 1e3 * (time.perf_counter() - t0)}
    n = TT_D_BATCH * TT_D_SEQ // (D * M)
    cap = moe_lib.capacity_for(n, moe)
    mine = xr.detach().reshape(-1, cfg.d_model)[m * n:(m + 1) * n]
    top_i = moe_lib.router_probs(p, moe, mine)[1]
    slot = moe_lib._dispatch_indices(top_i, E)[1]
    res.update(capacity=cap, dropped=int((slot >= cap).sum()),
               tokens_a_shard=n, experts=E, d=cfg.d_model)
    y_all = sh.batch_all_gather(y.detach().contiguous(), mesh)
    gx_all = sh.batch_all_gather(g[0].contiguous(), mesh)
    got = {"router": gp[0]}
    for k, t in zip(names[1:], gp[1:]):
        got[k] = sh.gather_leaf(t, sh.LeafShard(0, E), mesh)
    if rank == 0:
        pw = {k: whole[k].clone().requires_grad_(True) for k in names}
        xw = x.clone().requires_grad_(True)
        with torch.enable_grad():
            ye, auxe, drops = ep_emulation(torch, pw, moe, xw, D * M)
            te = (ye * cot).sum() + TT_D_AUX_W * auxe
            ge = torch.autograd.grad(te, [xw] + [pw[k] for k in names])
        want = dict(zip(names, ge[1:]))

        def err(a, w):
            return ((a.float() - w.float()).abs().max().item()
                    / max(w.abs().max().item(), 1e-30))
        res.update(
            y_err=err(y_all, ye.detach()), grad_x_err=err(gx_all, ge[0]),
            grad_errs={k: err(got[k], want[k]) for k in names},
            aux=float(aux.detach()), aux_want=float(auxe.detach()),
            aux_err=abs(float(aux.detach()) - float(auxe.detach()))
            / abs(float(auxe.detach())),
            dropped_want=drops)
        del pw, xw, ye, ge, want
    del whole, p, got, g, gp
    torch.cuda.empty_cache()
    return res


def ttrain_moe_step(torch, cfg, mesh, rank):
    """(d)'s Trainer step on this rank: the 2-layer model (seeded,
    perturbed, f32, remat "none") through Trainer(mesh=) one Adafactor
    step of (TT_D_BATCH, TT_D_SEQ); rank 0 computes loss_fn on the whole
    batch at the same parameters with every MoE layer routed by
    ep_emulation (no mesh), and the step's loss and aux loss are held
    against it. Returns the collectives of the step, calls and bytes."""
    from repro_torch import sharding as sh
    from repro_torch.data.pipeline import make_batch
    from repro_torch.models import model as M
    from repro_torch.models import moe as moe_lib
    from repro_torch.models.transformer import init_params
    from repro_torch.train.trainer import Trainer
    whole = init_params(cfg, seed=73, device=DEV)
    perturb_altup(torch, whole, seed=74)
    tcfg = ttrain_tcfg(torch, 1, TT_D_BATCH, TT_D_SEQ, 1, "")
    t0 = time.perf_counter()
    tr = Trainer(cfg, tcfg, mesh, device=DEV, params=whole)
    if rank != 0:                  # only rank 0 emulates
        del whole
        torch.cuda.empty_cache()
    sh.reset_collective_counts()
    hist = tr.run(log=lambda s: None)["history"]
    torch.cuda.synchronize()
    res = {"collectives": sh.collective_counts(),
           "step_s": time.perf_counter() - t0,
           "loss": hist[0]["loss"], "aux_loss": hist[0]["aux_loss"]}
    del tr
    torch.cuda.empty_cache()
    if rank == 0:
        shards = sh.batch_size(mesh) * sh.model_size(mesh)
        real = moe_lib.moe_block

        def emulated(p, moe, x, mesh=None, activation="silu",
                     capacity=None):
            return ep_emulation(torch, p, moe, x, shards, activation)[:2]
        glob = {k: torch.from_numpy(v).to(DEV)
                for k, v in make_batch(cfg, tcfg, 0).items()}
        moe_lib.moe_block = emulated
        try:
            with torch.no_grad():
                _, m = M.loss_fn(whole, cfg, glob)
        finally:
            moe_lib.moe_block = real
        res.update(loss_want=float(m["loss"]), aux_want=float(m["aux_loss"]))
        res["loss_err"] = abs(res["loss"] - res["loss_want"]) / \
            abs(res["loss_want"])
        res["aux_err"] = abs(res["aux_loss"] - res["aux_want"]) / \
            abs(res["aux_want"])
        del whole, glob
        torch.cuda.empty_cache()
    return res


def ttrain_rank4(rank, world, workdir):
    """One rank of t-train (c) at data 2 x model 2 and (d) (a spawned
    process): a gloo group on the card, the ("data", "model") mesh of
    (2, world / 2), every collective of the path probed on CUDA tensors
    (a failure is written, with why, and the rank stops), then Qwen3
    (ttrain_case), (d)'s block check and its Trainer step. Writes
    rank<r>.json under workdir."""
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_mesh
    res = {"rank": rank}
    torch.backends.cuda.matmul.allow_tf32 = False   # full f32 products
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group("gloo", store=dist.FileStore(
        str(workdir / "store-tt-c"), world), rank=rank, world_size=world)
    try:
        mesh = make_mesh((2, world // 2), ("data", "model"), device=DEV)
        if not (probe_collectives(torch, mesh, res)
                and probe_train_collectives(torch, mesh, res)
                and probe_data_collectives(torch, mesh, res)):
            return
        t0 = time.perf_counter()
        res["qwen3_data2_model2"] = ttrain_case(
            torch, "qwen3", mesh, rank, workdir, checkpoint=False,
            batch_rows=TT_C_BATCH)
        res["qwen3_data2_model2"]["seconds"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        cfg = moe_config(n_layers=TT_D_LAYERS, dtype="float32",
                         param_dtype="float32", remat="none")
        res["moe_block"] = ttrain_moe_block(torch, cfg, mesh, rank)
        res["moe_step"] = ttrain_moe_step(torch, cfg, mesh, rank)
        res["moe_seconds"] = time.perf_counter() - t0
    finally:
        (workdir / f"rank{rank}.json").write_text(json.dumps(res))
        dist.destroy_process_group()


def ttrain_data_gates(ranks, tag):
    """(c)'s record of `tag` over `ranks` (each held its own shard: the
    worst rank's distance) and the gates that failed: gradients within
    TT_C_GRAD_TOL, the first loss and the steps' losses within
    TT_C_LOSS_RTOL, the replicated gradients' and parameters' digests
    equal on every rank."""
    r0 = ranks[0][tag]
    rec = {k: r0[k] for k in ("layers", "losses", "want_losses",
                              "collectives_grad", "collectives_steps",
                              "seconds_parts")}
    for k in ("grad_err", "loss_err", "losses_err", "param_err"):
        rec[k] = max(r[tag][k] for r in ranks)
    rec["seconds"] = max(r[tag]["seconds"] for r in ranks)
    rec["replicated_leaves"] = len(r0["replicated"])
    rec["replicated_bitwise"] = all(
        r[tag]["replicated"] == r0["replicated"]
        and r[tag]["replicated_params"] == r0["replicated_params"]
        for r in ranks)
    bad = [k for k, tol in (("grad_err", TT_C_GRAD_TOL),
                            ("loss_err", TT_C_LOSS_RTOL),
                            ("losses_err", TT_C_LOSS_RTOL))
           if not rec[k] <= tol]
    if not rec["replicated_bitwise"] or not rec["replicated_leaves"]:
        bad.append("replicated_bitwise")
    return rec, bad


def ttrain_four_ranks(torch, workdir):
    """t-train (c) at data 2 x model 2 and (d): TT_C_RANKS spawned ranks
    sharing the card over gloo (fail_on_collective). (c)'s gates as
    ttrain_data_gates. (d): the EP block's output and every gradient
    (x, router, w1, w3, w2) within TT_D_TOL of each leaf's max of the
    emulation's, its aux loss within TT_D_LOSS_RTOL, each shard's dropped
    assignments counted as the emulation counts them (and some dropped);
    a Trainer step's loss and aux loss within TT_D_LOSS_RTOL of the
    emulated model's; 2 all-to-alls forward and 2 backward a MoE layer,
    each of M (E / M) C d f32 bytes. Prints the collectives of each."""
    t0 = time.perf_counter()
    ranks = spawn_ranks(ttrain_rank4, workdir, "t-train (c, d)",
                        world=TT_C_RANKS)
    out = {"ranks": TT_C_RANKS, "backend": "gloo",
           "mesh": {"data": 2, "model": TT_C_RANKS // 2}}
    fail_on_collective(ranks, out, "t-train-c-d", t0)
    rec, bad = ttrain_data_gates(ranks, "qwen3_data2_model2")
    out["c_qwen3_data2_model2"] = rec
    blk = ranks[0]["moe_block"]
    M = TT_C_RANKS // 2
    a2a_bytes = M * (blk["experts"] // M) * blk["capacity"] * blk["d"] * 4
    out["d_block"] = dict(blk, dropped=[r["moe_block"]["dropped"]
                                        for r in ranks],
                          all_to_all_bytes_a_call=a2a_bytes)
    step = ranks[0]["moe_step"]
    out["d_step"] = step
    out["d_seconds"] = max(r["moe_seconds"] for r in ranks)
    blk = out["d_block"]
    if max([blk["y_err"], blk["grad_x_err"]]
           + list(blk["grad_errs"].values())) > TT_D_TOL:
        bad.append("d_block_errs")
    if blk["aux_err"] > TT_D_LOSS_RTOL:
        bad.append("d_block_aux")
    if blk["dropped"] != blk["dropped_want"] or not sum(blk["dropped"]):
        bad.append("d_dropped")
    if any(list(blk["collectives"].get(f"all_to_all/{tag}", ()))
           != [2, 2 * a2a_bytes] for tag in ("fwd", "bwd")):
        bad.append("d_block_all_to_all")
    if not (step["loss_err"] <= TT_D_LOSS_RTOL
            and step["aux_err"] <= TT_D_LOSS_RTOL):
        bad.append("d_step_loss")
    a2a = step["collectives"]
    if a2a.get("all_to_all/fwd", (0,))[0] != 2 * TT_D_LAYERS or \
            a2a.get("all_to_all/bwd", (0,))[0] != 2 * TT_D_LAYERS:
        bad.append("d_step_all_to_all")
    out["seconds"] = time.perf_counter() - t0
    if bad:
        line("t-train-c-d", **out)
        raise AssertionError(f"t-train (c, d): {bad}")
    return out


def ttrain_two_ranks(torch, workdir):
    """t-train (b): T_RANKS spawned ranks sharing the card over gloo
    (fail_on_collective). Gates for each model, f32: the gathered
    gradients within TT_GRAD_TOL of one rank's un-meshed gradients (of
    each leaf's max), the loss of the first batch and the TT_STEPS
    Adafactor steps' losses within TT_LOSS_RTOL, the gathered parameters
    after them within TT_PARAM_TOL of each leaf's max, every replicated
    leaf's
    gradient bitwise equal on both ranks, the checkpoint written at model
    = 2 restored into the un-meshed Trainer at TT_STEPS, whose next
    step's loss is the meshed trainer's within TT_LOSS_RTOL (all but the
    context-parallel run: the same model, the flag off's checkpoint).
    Qwen3 in
    bf16: the same distances within TT_BF16_SCALE times the f32 run's
    (at least TT_F32_ROUNDOFF). A parameter whose gradient is within
    rounding of zero takes an Adafactor step of either sign, so the
    parameters' distance is the loosest of these.
    Prints the collectives of one gradient and of the steps, calls and
    bytes."""
    t0 = time.perf_counter()
    ranks = spawn_ranks(ttrain_rank, workdir, "t-train (b)")
    out = {"ranks": T_RANKS, "backend": "gloo", "steps": TT_STEPS,
           "batch": [TT_B_BATCH, TT_B_SEQ]}
    fail_on_collective(ranks, out, "t-train-b", t0)
    r0 = ranks[0]
    for tag in TT_MODELS + ("qwen3_bf16",):
        rec = out[tag] = {k: r0[tag][k] for k in (
            "layers", "dtype", "losses", "want_losses", "restored_step",
            "next_loss", "restored_next_loss", "next_loss_err",
            "collectives_grad", "collectives_steps", "seconds_parts")
            if k in r0[tag]}
        # each rank held its own shard: the worst rank's distance
        for k in ("grad_err", "loss_err", "losses_err", "param_err"):
            rec[k] = max(r[tag][k] for r in ranks)
        rec["seconds"] = max(r[tag]["seconds"] for r in ranks)
        rec["replicated_leaves"] = len(r0[tag]["replicated"])
        rec["replicated_bitwise"] = all(
            r[tag]["replicated"] == r0[tag]["replicated"] for r in ranks)
    for tag in TT_MODELS:
        rec = out[tag]
        ckpt = tag in TT_CHECKPOINTED
        bad = [k for k, tol in (("grad_err", TT_GRAD_TOL),
                                ("loss_err", TT_LOSS_RTOL),
                                ("losses_err", TT_LOSS_RTOL),
                                ("param_err", TT_PARAM_TOL),
                                ("next_loss_err", TT_LOSS_RTOL))
               if (ckpt or k != "next_loss_err") and not rec[k] <= tol]
        if bad or not rec["replicated_bitwise"] or \
                (ckpt and rec["restored_step"] != TT_STEPS):
            line("t-train-b", **out)
            raise AssertionError(f"t-train (b) {tag}: {bad} {rec}")
    rec, f32 = out["qwen3_bf16"], out["qwen3"]
    rec["tolerances"] = {k: TT_BF16_SCALE * max(f32[k], TT_F32_ROUNDOFF)
                         for k in ("grad_err", "losses_err", "param_err",
                                   "next_loss_err")}
    bad = [k for k, tol in rec["tolerances"].items() if not rec[k] <= tol]
    if bad or not rec["replicated_bitwise"]:
        line("t-train-b", **out)
        raise AssertionError(f"t-train (b) qwen3 bf16: {bad} {rec}")
    rec, bad = ttrain_data_gates(ranks, "qwen3_data2")
    out["c_qwen3_data2_model1"] = rec
    if bad:
        line("t-train-b", **out)
        raise AssertionError(f"t-train (c) data 2 x model 1: {bad} {rec}")
    out["seconds"] = time.perf_counter() - t0
    return out


# the dry run's phase: Qwen3-0.6B + AltUp K=2 on the production meshes
DRY_ARCH, DRY_K = "qwen3-0.6b", 2
# the train program at 2 rows a rank of the 16 x 16 mesh (train_4k's 16
# rows hold whole-vocabulary logits past the card's memory, PERF.md)
DRY_TRAIN_B32 = ("train_4k_b32", 4096, 32, "train")
# the card's peak allocation against the meta count's temp bytes: within
# this share of the prediction plus DRY_MEM_SLACK bytes (PERF.md §6)
DRY_MEM_RTOL = 0.05
DRY_MEM_SLACK = 256 << 20


def dryrun_phases(torch, ops):
    """dryrun: launch/dryrun.py on Qwen3-0.6B + AltUp K=2. (a) meta counts
    of train_4k and decode_32k on 16 x 16 and train_4k on 2 x 16 x 16
    (and the train program at 2 rows a rank): the roofline terms, bound,
    useful FLOPs share, collectives by kind, predicted memory. (b) the
    16 x 16 cells and the 2-row train cell run on the card under the same
    fake group (dryrun.card_run): FLOPs equal to the meta count's (a
    difference named by op), the card's peak allocation within
    DRY_MEM_RTOL of the predicted temp bytes, an OOM only where the
    prediction exceeds the card; the step's device ms (collectives move
    nothing) beside step_s_lower_bound. (c) the decode cell again with
    the kernel levers at None: B1 (altup_predict_correct) and B2
    (ragged_decode_attention) launched on the rank's shard, once a layer
    each. (d) `python -m repro_torch.launch.dryrun` on decode_32k as a
    user runs it on the card (dryrun.main): exit 0, the card's FLOPs and
    peak as (b)'s gates hold them."""
    import torch.distributed as dist
    from repro_torch.config import SHAPES_BY_NAME, ShapeConfig
    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import fake_mesh, production_shape
    from repro_torch.models.transformer import layer_plan
    t0 = time.perf_counter()
    cfg = get_config(DRY_ARCH, altup_k=DRY_K)
    card_bytes = torch.cuda.get_device_properties(0).total_memory
    cells = [("train_4k", False), ("decode_32k", False), ("train_4k", True)]
    pred = {}
    for shape, mp in cells:
        rec = dryrun.run_cell(DRY_ARCH, shape, multi_pod=mp, altup_k=DRY_K,
                              analyze=False, device="meta", verbose=False)
        assert rec["status"] == "ok", rec.get("error")
        ro, mem = rec["roofline"], rec["memory"]
        pred[(shape, mp)] = rec
        line("dryrun-meta", cell=shape, mesh=list(production_shape(mp)[0]),
             count_s=rec["compile_s"],
             **{k: ro[k] for k in ("compute_s", "memory_s", "collective_s",
                                   "bound", "step_s_lower_bound",
                                   "useful_flops_frac")},
             flops=rec["cost_raw"]["flops"],
             bytes_accessed=rec["cost_raw"]["bytes accessed"],
             collectives={k: v for k, v in rec["collectives_raw"].items()
                          if k != "by_direction" and v},
             memory=mem)
    b32 = ShapeConfig(*DRY_TRAIN_B32)
    shape16, axes16 = production_shape(False)
    out = {}
    with fake_mesh(shape16, axes16) as mesh:
        c = dryrun.trace_cell(cfg, b32, mesh)
        pred[(b32.name, False)] = {
            "cost_raw": dryrun.cost_dict(c), "memory": dryrun.memory_dict(c),
            "flops_by_op": c["flops_by_op"],
            "roofline": dryrun.roofline_terms(
                c["flops"], c["bytes accessed"],
                dryrun.collective_bytes(c["collectives"])["total"],
                n_chips=256)}
        line("dryrun-meta", cell=b32.name, mesh=list(shape16),
             flops=c["flops"], bytes_accessed=c["bytes accessed"],
             memory=pred[(b32.name, False)]["memory"])
        for name in ("train_4k", "decode_32k", b32.name):
            shape = SHAPES_BY_NAME.get(name, b32)
            p = pred[(name, False)]
            mem = p["memory"]
            need = mem["argument_size_in_bytes"] + mem["temp_size_in_bytes"]
            fits = need <= card_bytes
            card = dryrun.card_run(cfg, shape, mesh)
            res = {"cell": name, "status_card": card["status_card"],
                   "predicted_fits": fits, "predicted_bytes": need,
                   "card_bytes": card_bytes,
                   "predicted_temp_bytes": mem["temp_size_in_bytes"]}
            if card["status_card"] == "oom":
                res["error"] = card["error"][:300]
                line("dryrun-card", **res)
                assert not fits, f"{name}: OOM where the count predicted " \
                    f"{need} of the card's {card_bytes} bytes"
                out[name] = res
                continue
            diff = {op: (card["flops_by_op"].get(op, 0),
                         p["flops_by_op"].get(op, 0))
                    for op in set(card["flops_by_op"]) | set(p["flops_by_op"])
                    if card["flops_by_op"].get(op, 0) !=
                    p["flops_by_op"].get(op, 0)}
            err = card["peak_bytes"] - mem["temp_size_in_bytes"]
            res.update(flops=card["flops"], flops_meta=p["cost_raw"]["flops"],
                       flops_diff_by_op=diff, step_ms=card["ms"],
                       step_s_lower_bound=p["roofline"]["step_s_lower_bound"],
                       card_peak_bytes=card["peak_bytes"],
                       argument_bytes=card["argument_bytes"],
                       argument_bytes_meta=mem["argument_size_in_bytes"],
                       mem_err_bytes=err,
                       mem_err_rel=err / max(mem["temp_size_in_bytes"], 1.0),
                       collectives=card["collectives"])
            line("dryrun-card", **res)
            assert fits, f"{name}: ran where the count predicted {need} " \
                f"of the card's {card_bytes} bytes"
            assert not diff, f"{name}: FLOPs differ by op (card, meta): " \
                f"{diff}"
            assert card["flops"] == p["cost_raw"]["flops"]
            assert abs(err) <= DRY_MEM_RTOL * mem["temp_size_in_bytes"] + \
                DRY_MEM_SLACK, f"{name}: card peak {card['peak_bytes']} " \
                f"against the count's {mem['temp_size_in_bytes']}"
            out[name] = res
        # (c) the decode cell with the kernel levers at None
        ops.reset_launch_counts()           # counts start at 0 right here
        card = dryrun.card_run(cfg, SHAPES_BY_NAME["decode_32k"], mesh,
                               kernels=True, timed=False)
        counts = ops.launch_counts()        # read right after the run
    assert not dist.is_initialized()
    n_attn = sum(seg.n for seg in layer_plan(cfg) if seg.kind == "attn")
    res = {"status_card": card["status_card"], "launches": counts,
           "attn_layers": n_attn, "peak_bytes": card.get("peak_bytes"),
           "flops": card.get("flops")}
    line("dryrun-kernels", cell="decode_32k", **res)
    assert card["status_card"] == "ok", card.get("error")
    for name in ("altup_predict_correct", "ragged_decode_attention"):
        assert counts.get(name, 0) == n_attn, (name, counts)
    # (d) the command a user runs on the card: the meta count, its solve
    # and the card's run of decode_32k in one record
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as work:
        path = Path(work) / "cell.json"
        rc = dryrun.main(["--arch", DRY_ARCH, "--shape", "decode_32k",
                          "--altup", str(DRY_K), "--out", str(path)])
        rec = json.loads(path.read_text())[0]
    line("dryrun-cli", rc=rc, status=rec["status"],
         status_card=rec.get("status_card"),
         memory_card=rec.get("memory_card"),
         temp_bytes=rec["memory"]["temp_size_in_bytes"],
         solve_rel_err=rec["cost"]["direct_rel_err"])
    assert rc == 0 and rec["status_card"] == "ok", rec.get("error_card")
    assert "flops_card" not in rec
    temp = rec["memory"]["temp_size_in_bytes"]
    assert abs(rec["memory_card"]["peak_bytes"] - temp) <= \
        DRY_MEM_RTOL * temp + DRY_MEM_SLACK, rec["memory_card"]
    line("dryrun-seconds", seconds=time.perf_counter() - t0)
    return out


def train_tp_phases(torch, workdir):
    """(t-train): (a), (b) with (c) over data 2 x model 1 in its ranks,
    then (c) over data 2 x model 2 and (d) in four ranks."""
    t0 = time.perf_counter()
    res_a = ttrain_one_rank(torch, workdir)
    line("t-train-a", seconds=time.perf_counter() - t0, **res_a)
    line("t-train-b", **ttrain_two_ranks(torch, workdir))
    line("t-train-c-d", **ttrain_four_ranks(torch, workdir))
    line("t-train", seconds=time.perf_counter() - t0)


def tp_phases(torch, ops, workdir):
    """(t): t-serve-a, t-serve-b, t-serve-c's (a) and (b), then
    t-serve-d. Returns t-serve-b's, t-serve-c (b)'s and t-serve-d's
    results."""
    t_t = time.perf_counter()
    line("t-serve-a", **tp_one_rank(torch, ops, workdir))
    res_b = tp_two_ranks(torch, workdir)
    line("t-serve-b", **res_b)
    t0 = time.perf_counter()
    res_ca = tpc_one_rank(torch, ops, workdir)
    line("t-serve-c-a", seconds=time.perf_counter() - t0, **res_ca)
    res_cb = tpc_two_ranks(torch, workdir)
    line("t-serve-c-b", **res_cb)
    res_d = tpd_two_ranks(torch, workdir)
    line("t-serve-d", **res_d)
    line("t-phases", seconds=time.perf_counter() - t_t)
    return res_b, res_cb, res_d


def _device_kernels(prof):
    """key_averages() entries of the kernels run on the card (the CPU-side
    ops that launched them carry the same time again, so only these are
    summed)."""
    from torch.autograd import DeviceType
    return [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]


# the first kernel of every profiler session: torch.cuda._sleep's spin
# kernel, which no timed function launches
MARKER = "spin_kernel"


def profiled(torch, fn, name_part=None, iters=50, per_call=None):
    """Device time per call of fn() and the names of the kernels it ran
    (only those whose name holds `name_part`, if given): their summed
    time from torch.profiler over `iters` calls. Free of the host time
    between launches, which CUDA events around a loop of calls would
    include.

    The profiler's records are not always whole on the card. From about
    the hundredth session of a process on, the kernel launched first in
    a session has its runtime launch record but no kernel record, in
    every session; so each session launches a marker kernel first, which
    is left out of the sums. Now and then a session loses a run of
    records, or records no device activity at all: such a session is run
    again, eight sessions at most. per_call: how many kernels matching
    name_part one call launches; the count must be exactly per_call x
    iters. Without it (functions of many kernels) the count must be a
    multiple of iters above 0: every call launches the same kernels."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    want = None if per_call is None else per_call * iters
    for _ in range(8):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            torch.cuda._sleep(1)
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        hits = [e for e in _device_kernels(prof)
                if MARKER not in e.key
                and (name_part is None or name_part in e.key)]
        n = sum(e.count for e in hits)
        if n and (n == want if want is not None else n % iters == 0):
            return (sum(e.self_device_time_total for e in hits) / 1e3 / iters,
                    [e.key for e in hits])
    raise AssertionError(f"kernels {name_part!r}: {n} in the profile, want "
                         f"{'k' if per_call is None else per_call} x "
                         f"{iters}")


def device_ms(torch, fn, name_part=None, iters=50, per_call=None):
    """profiled()'s device ms per call of fn()."""
    return profiled(torch, fn, name_part, iters, per_call)[0]


def profile_decode(torch, ops, eng, prompts, replay, n_steps=8,
                   sessions=3):
    """Device busy share of pure decode steps at the served shapes: the
    phase's own prompts, prefilled, then `n_steps` decode steps under
    torch.profiler. The port's kernel records are held against the launch
    counters of the same steps (a replayed graph's kernels included: its
    replays add their capture's counts), one record per launch and two
    per decode-attention call; a session that lost records is run again.
    A replaying engine also gives the gap between the kernels of its
    most replayed graph: replays back to back timed by CUDA events
    against the kernels' own device time (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.serve.sampling import SamplingParams
    for p in prompts:
        eng.submit(p, sampling=SamplingParams(
            max_new=sessions * n_steps + 4))
    while True:                              # through the prefill steps
        pf0 = eng.stats["prefill_tokens"]
        eng.step()
        if eng.stats["prefill_tokens"] == pf0:
            break
    for _ in range(sessions):
        torch.cuda.synchronize()
        c0 = ops.launch_counts()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            torch.cuda._sleep(1)             # takes a lost first record
            t0 = time.perf_counter()
            for _ in range(n_steps):
                eng.step()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        c1 = ops.launch_counts()
        kern = sorted((e for e in _device_kernels(prof)
                       if MARKER not in e.key),
                      key=lambda e: -e.self_device_time_total)
        want = sum((c1[k] - c0[k]) * KERNELS_PER_LAUNCH.get(k, 1)
                   for k in c1)
        got = sum(e.count for e in kern if "repro_torch::" in e.key)
        if got == want:
            break
    else:
        raise AssertionError(f"profiler records {got} port kernels for "
                             f"{want} counted launches")
    eng.run()
    dev_us = sum(e.self_device_time_total for e in kern)
    res = {"steps": n_steps, "replay": replay,
           "wall_ms_per_step": 1e3 * wall / n_steps,
           "device_ms_per_step": dev_us / 1e3 / n_steps,
           "wall_minus_device_ms_per_step": (1e3 * wall - dev_us / 1e3)
           / n_steps,
           "device_busy_share": (dev_us / 1e6) / wall,
           "kernels_per_step": sum(e.count for e in kern) / n_steps,
           "port_kernel_records": got, "port_kernel_launches_counted": want,
           "top_kernels": [[e.key[:70], e.count / n_steps,
                            e.self_device_time_total / 1e3 / n_steps]
                           for e in kern[:10]],
           # the port's own kernels, each with its launches and device ms
           # per step and its share of the step's device time
           "port_kernels": [[e.key[:70], e.count / n_steps,
                             e.self_device_time_total / 1e3 / n_steps,
                             e.self_device_time_total / dev_us]
                            for e in kern if "repro_torch::" in e.key]}
    if replay:
        res.update(replay_gaps(torch, eng))
    return res


def replay_gaps(torch, eng, iters=5):
    """How much of a replayed step is gaps between its kernels: the most
    replayed graph, replayed back to back (CUDA events over 50 replays),
    against the summed device time of its kernels (torch.profiler over
    `iters` replays). The port's kernel records must count exactly the
    launches the graph's capture recorded (two a decode-attention call);
    a session that lost one is run again. Such a session also loses a
    record or two of its ~14000 others now and then, so their count is
    printed, not gated. The replays
    run on the engine's last step inputs after its run, writing the rows
    that step wrote."""
    from torch.profiler import ProfilerActivity, profile
    gs = eng.graph_stats
    by_shape = gs["replays_by_shape"]
    key = max(by_shape, key=by_shape.get)
    graph = eng._graphs._graphs[key][0]
    want = iters * sum(n * KERNELS_PER_LAUNCH.get(k, 1)
                       for k, n in gs["launches_per_replay"][key].items())
    replay_ms = time_ms(torch, graph.replay, iters=50, warmup=5)
    for _ in range(8):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            torch.cuda._sleep(1)
            for _ in range(iters):
                graph.replay()
            torch.cuda.synchronize()
        kern = [e for e in _device_kernels(prof) if MARKER not in e.key]
        port = sum(e.count for e in kern if "repro_torch::" in e.key)
        if port == want:
            break
    else:
        raise AssertionError(f"replay profile: {port} port kernel records, "
                             f"want {want}")
    kern_ms = sum(e.self_device_time_total for e in kern) / 1e3 / iters
    return {"replayed_shape": list(key), "replay_ms": replay_ms,
            "replay_kernel_ms": kern_ms,
            "replay_records_per_replay": sum(e.count for e in kern) / iters,
            "replay_port_records": port,
            "replay_gap_share": 1.0 - kern_ms / replay_ms}


def main(argv) -> int:
    # k-resume runs with deterministic algorithms, which need cuBLAS's
    # fixed workspace; it must be set before cuBLAS starts
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    if not PKG.is_dir():
        print(f"chip_smoke: {PKG} not found; run from a checkout of the "
              f"repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    profile = "--profile" in argv

    # (a) device
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout
    print(smi.strip().splitlines()[0], flush=True)
    kind = torch.cuda.get_device_name(0)
    line("a-device", kind=kind, count=torch.cuda.device_count(),
         torch=torch.__version__, cuda=torch.version.cuda,
         capability=list(torch.cuda.get_device_capability(0)))

    # (b) build, one nvcc per source, all started together; the flash
    # source (45-70 s of nvcc, the others ~8 s) finishes in a thread while
    # phase c checks the other kernels, and is waited for before c-flash
    from repro_torch.kernels import build, ops, ref
    t0 = time.perf_counter()
    flash_build = concurrent.futures.ThreadPoolExecutor(1).submit(
        build.build, ["flash_attention"])
    info = build.build([n for n in build.sources()
                        if n != "flash_attention"])

    def built(tag, info):
        ptxas = {n: [ln.split("ptxas info    : ")[-1]
                     for ln in i["log"].splitlines()
                     if "registers" in ln or "spill" in ln]
                 for n, i in info.items()}
        line(tag, seconds=time.perf_counter() - t0,
             per_source={n: i["seconds"] for n, i in info.items()},
             ptxas=ptxas)
    built("b-build", info)

    # (c) kernels vs their plain versions, f32 products in full precision
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    altup = {}
    for dtype in (torch.bfloat16, torch.float32):
        # tokens per step: decode and prefill steps of (e) (8 slots, chunk
        # 64) and of (g) (16 slots), and a chunk of 8
        for T in (8, 16, 64, 512, 1024):
            r = check_altup(torch, ops, ref, dtype, T)
            altup[(r["dtype"], T)] = r
            line("c-altup", **r)
    # attention: the depths of a decode step halfway through (e), read
    # through the engine's kv-len bucket, then a spread of depths from
    # empty to full
    from repro_torch.serve.engine import kv_bucket
    e_lens = [n + E_NEW // 2 for n in E_PROMPTS]
    spread = [0, 2048, 1, 517, 1024, 77, 1999, 300]
    ragged = {}
    for dtype in (torch.bfloat16, torch.float32):
        for case, lens_host in (("e", e_lens), ("spread", spread)):
            r = check_ragged(torch, ops, ref, dtype, lens_host,
                             T=kv_bucket(max(lens_host), 32, 2048))
            ragged[(r["dtype"], case)] = r
            line("c-ragged", case=case, **r)
    # paged: the spread through a full pool of 1024 pages, then a step of
    # (g) halfway through: slot 0 idle (a zero table row), 15 slots that
    # share the system prompt's full pages, each its own after them
    _, tails, _ = paged_traffic(torch, served_config().vocab_size)
    g_lens = [0] + [G_SYSTEM + t + G_NEW // 2 for t in tails]
    g_reserve = [0] + [pages_for(G_SYSTEM + t + G_NEW, G_PAGE)
                       for t in tails]
    paged = {}
    for dtype in (torch.bfloat16, torch.float32):
        for case, kw in (
                ("g", dict(lens_host=g_lens, reserve=g_reserve,
                           n_shared=G_SYSTEM // G_PAGE, n_pages=G_PAGES,
                           t_max=kv_bucket(max(g_lens), 32, 2048))),
                ("spread", dict(lens_host=spread, reserve=[2048 // 16] * 8,
                                n_pages=1024))):
            r = check_paged(torch, ops, ref, dtype, **kw)
            paged[(r["dtype"], case)] = r
            line("c-paged", case=case, **r)
    # the fused dequant, both entry points, at the same shapes: (e)'s
    # halfway depths and the spread for the contiguous kernel, (g)'s
    # halfway step and the spread for the paged one, int8 and fp8 codes
    # with bf16 and f32 queries; then float k/v stored in bf16 under f32
    # queries (a float storage mode other than the activations'), untimed
    ragged_q, paged_q = {}, {}
    for dtype in (torch.bfloat16, torch.float32):
        for store in ("int8", "fp8"):
            for case, lens_host in (("e", e_lens), ("spread", spread)):
                r = check_ragged(torch, ops, ref, dtype, lens_host,
                                 T=kv_bucket(max(lens_host), 32, 2048),
                                 store=store)
                ragged_q[(r["dtype"], case, store)] = r
                line("c-ragged-quant", case=case, **r)
    line("c-ragged-quant", case="spread-bf16-kv",
         **check_ragged(torch, ops, ref, torch.float32, spread,
                        store="bf16", timed=False))
    line("c-ragged-quant", case="all-codes", **check_all_codes(torch, ops))
    for dtype in (torch.bfloat16, torch.float32):
        for store in ("int8", "fp8"):
            for case, kw in (
                    ("g", dict(lens_host=g_lens, reserve=g_reserve,
                               n_shared=G_SYSTEM // G_PAGE, n_pages=G_PAGES,
                               t_max=kv_bucket(max(g_lens), 32, 2048))),
                    ("spread", dict(lens_host=spread,
                                    reserve=[2048 // 16] * 8,
                                    n_pages=1024))):
                r = check_paged(torch, ops, ref, dtype, store=store, **kw)
                paged_q[(r["dtype"], case, store)] = r
                line("c-paged-quant", case=case, **r)
    # split-K: the head shapes the split kernels were widened for; one
    # paged slot of 40960 rows
    for tag, case, r in check_shapes(torch, ops, ref):
        line(tag, case=case, **r)
    for r in check_long_slot(torch, ops, ref):
        line("c-paged-long", **r)
    # gemma3-4b's served shapes (j)
    j_kern = {}
    for tag, case, key, r in check_gemma_kernels(torch, ops, ref):
        j_kern[key] = r
        line(tag, case=case, **r)
    # qwen2-moe-a2.7b's served shapes (m)
    m_kern = check_moe_kernels(torch, ops, ref)
    line("c-altup", case="m", **m_kern["altup"])
    line("c-ragged", case="m", **m_kern["ragged"])
    # deepseek-v3-671b's served shape (l): AltUp at 8 tokens of d 7168
    l_altup = check_altup(torch, ops, ref, torch.bfloat16, 8, d=7168)
    line("c-altup", case="l", **l_altup)
    # t5-large's and whisper-tiny's served shapes (n, w)
    nw_kern = check_encdec_kernels(torch, ops, ref)
    for case, r in nw_kern.items():
        line("c-altup" if "altup" in case else "c-ragged", case=case, **r)
    # zamba2-1.2b's, llava-next-mistral-7b's and granite-3-2b's served
    # shapes (z, v, granite)
    t0 = time.perf_counter()
    zv_kern = check_new_family_kernels(torch, ops, ref)
    for case, r in zv_kern.items():
        tag = ("c-altup" if "altup" in case else
               "c-paged" if "paged" in case else "c-ragged")
        line(tag, case=case, **r)
    line("c-zv-seconds", seconds=time.perf_counter() - t0)
    # the decode attention at t-serve-b's local heads (a rank of two)
    t_kern = check_tp_kernels(torch, ops, ref)
    for case, r in t_kern.items():
        line("c-paged" if "paged" in case else "c-ragged",
             case=case.removesuffix("-ragged").removesuffix("-paged"), **r)
    # the WKV kernel and the decode attention at t-serve-c's local heads
    tc_kern = check_tpc_kernels(torch, ops, ref)
    for case, r in tc_kern.items():
        line("c-wkv" if "wkv" in case else "c-ragged", case=case, **r)

    # WKV: (i)'s decode step (8 slots, 32 heads of 64, the state in
    # place), (h)'s forward (no state, 512 steps), an odd length with a
    # state, and the zero state against none
    wkv = {}
    for dtype in (torch.bfloat16, torch.float32):
        for case, kw in (("i-decode", dict(B=8, H=32, Dh=64, S=1,
                                           state="random")),
                         ("h-forward", dict(B=4, H=32, Dh=64, S=512,
                                            state=None)),
                         ("odd", dict(B=3, H=5, Dh=16, S=77,
                                      state="random"))):
            r = check_wkv(torch, ops, ref, dtype, **kw)
            wkv[(r["dtype"], case)] = r
            line("c-wkv", case=case, **r)
        line("c-wkv", case="zero-state",
             **check_wkv_zero_state(torch, ops, dtype))

    built("b-build-flash", flash_build.result())

    # flash attention through ops.mha_flash / mha_flash_paged: the timed
    # full-width cases, the edge shapes, the skip ratio, then the paged
    # entry point over a permuted pool with garbage, bitwise vs contiguous
    flash = {}
    for dtype in (torch.bfloat16, torch.float32):
        for case, kw in FLASH_CASES:
            if kw["dh"] > 128 and dtype == torch.float32:
                continue
            # case 1 in bf16 is the slice's path, counted from 0
            main = case == "prefill" and dtype == torch.bfloat16
            r = check_flash(torch, ops, ref, dtype, counted=main, **kw)
            flash[(r["dtype"], case)] = r
            line("c-flash", case=case, **r)
        for case, kw in FLASH_ODD:
            line("c-flash", case=case,
                 **check_flash(torch, ops, ref, dtype, timed=False, **kw))
        line("c-flash", case="skip-ratio",
             **flash_skip_ratio(torch, ops, dtype))
    if profile:
        line("c-flash", case="block-cost", **flash_block_cost(torch, ops))
    flash_paged = {}
    for dtype in (torch.bfloat16, torch.float32):
        for case, kw in (("causal", {}), ("window-256", dict(window=256)),
                         ("int8", dict(quant="int8"))):
            if kw.get("quant") and dtype == torch.float32:
                continue
            main = case == "causal" and dtype == torch.bfloat16
            r = check_flash_paged(torch, ops, ref, dtype, counted=main, **kw)
            flash_paged[(r["dtype"], case)] = r
            line("c-flash-paged", case=case, **r)
    # pages of 5 rows: no tensor-map box divides the kv tile, the cp.async
    # producer reads the pool (bf16 and fp8 codes), untimed
    for kw in ({}, dict(quant="fp8")):
        line("c-flash-paged", case="page-5" + ("-fp8" if kw else ""),
             **check_flash_paged(torch, ops, ref, torch.bfloat16, B=2, S=300,
                                 page=5, pool_pages=200, timed=False,
                                 producer="CpAsyncProducer", **kw))
    main_flash = flash[("bfloat16", "prefill")]
    main_flash_paged = flash_paged[("bfloat16", "causal")]
    torch.cuda.empty_cache()
    # the split pass and the merge over gathered spans (t-serve-d's
    # long-context layout) against the unsharded call
    t0 = time.perf_counter()
    td_kern = check_tpd_kernels(torch, ops, ref)
    for case, r in td_kern.items():
        line("c-split-merge", case=case, **r)
    line("c-split-merge-seconds", seconds=time.perf_counter() - t0)

    # (d) full-width f32 parity of the two paths, then of the fused
    # dequant against the dense dequant path, int8 and fp8
    line("d-parity", **parity_f32(torch))
    for store in ("int8", "fp8"):
        line("d-quant", **parity_f32(torch, store))
    # the replayed step against the eager one, full width, f32
    for pool in (False, True):
        line("d-graph", **graph_parity_f32(torch, pool))

    # (e) the main path: bf16 serving through Engine, eager and replayed
    # (its pure-decode steps replay CUDA graphs), then from int8 caches
    # (e-quant); each replayed phase held against its eager twin
    def serve_pair(fn, tag, tag_graph, prof_tag, base=None, **kw):
        res, trace, prof = fn(torch, ops, profile=profile, **kw)
        if base is not None:         # cache bytes against the float run's
            res[f"cache_bytes_over_{base[0]}"] = \
                res["cache_bytes"] / base[1]["cache_bytes"]
        line(tag, **res)
        if prof is not None:
            line(prof_tag, **prof)
        res_r, trace_r, prof_r = fn(torch, ops, profile=profile,
                                    replay=True, **kw)
        steps = res_r["steps"] if fn is serve_recurrent_bf16 \
            else res_r["decode_steps"]
        res_r.update(hold_replay({**res, **trace}, {**res_r, **trace_r},
                                 steps))
        line(tag_graph, **res_r)
        if prof_r is not None:
            line(prof_tag + "-graph", **prof_r)
        return res, res_r
    res, res_r = serve_pair(serve_bf16, "e-serve", "e-graph", "f-profile")
    res_eq, res_eq_r = serve_pair(serve_bf16, "e-quant", "e-quant-graph",
                                  "f-profile-quant", base=("e", res),
                                  kind="int8")

    # (g) the paged path: bf16 serving from a page pool with prefix reuse
    res_g, res_g_r = serve_pair(serve_paged_bf16, "g-paged-serve",
                                "g-graph", "f-profile-paged")
    line("g-spill", **serve_spill_bf16(torch))
    # (g-quant) the paged path from an fp8 pool
    res_gq, res_gq_r = serve_pair(serve_paged_bf16, "g-quant",
                                  "g-quant-graph", "f-profile-paged-quant",
                                  base=("g", res_g), kind="fp8")

    # (h) rwkv6-1.6b: full-width f32 parity of the WKV kernel path
    line("h-parity", **rwkv_parity_f32(torch))

    # (i) rwkv6-1.6b: bf16 serving through Engine with prefix reuse
    res_i, res_i_r = serve_pair(serve_recurrent_bf16, "i-rwkv-serve",
                                "i-graph", "f-profile-rwkv",
                                cfg=rwkv_config(n_layers=I_SERVE_LAYERS))
    # (i-paged) the same plan through a page pool: its recurrent state
    # stays per slot, replayed, tokens as the contiguous engine's
    t0 = time.perf_counter()
    line("i-paged", **rwkv_paged_bf16(torch, ops),
         seconds=time.perf_counter() - t0)
    # (j) gemma3-4b + AltUp K=2, sliding windows over ring caches:
    # full-width f32 parity across the wrap, then bf16 serving through
    # Engine, eager and replayed (every step of a ring plan is S=1, so
    # every step replays): (j) contiguous, j-paged with prefix reuse (a
    # ring hit copies every prefix page; the replayed run's hits against
    # a cold engine), and j-quant from int8 slot caches and from an fp8
    # pool, replayed only (an eager twin adds ~100 ms a chunk-1 step;
    # eager == replayed is held by j-serve and j-paged), each run's hits
    # against a cold engine
    line("j-parity", **gemma_parity_f32(torch))

    # The eager twin (~70 ms a chunk-1 step at full depth) runs at
    # J_TWIN_LAYERS, against a replayed run at the same depth; the
    # phase's numbers, launches and cold check come from a replayed run
    # at full depth
    def gemma_pair(tag, tag_graph, n_layers=None, **kw):
        res, trace = serve_gemma(torch, ops, n_layers=J_TWIN_LAYERS, **kw)
        line(tag, **res)
        res_t, trace_t = serve_gemma(torch, ops, replay=True,
                                     n_layers=J_TWIN_LAYERS, **kw)
        held = hold_replay({**res, **trace}, {**res_t, **trace_t},
                           res_t["steps"])
        res_r, _ = serve_gemma(torch, ops, replay=True, n_layers=n_layers,
                               cold_check=kw.get("paged", False), **kw)
        res_r.update(twin_layers=J_TWIN_LAYERS, twin=held,
                     twin_graph=res_t["graph"])
        line(tag_graph, **res_r)
        return res_r
    res_j_r = gemma_pair("j-serve", "j-graph", n_layers=J_PAGED_LAYERS)
    res_jp_r = gemma_pair("j-paged", "j-paged-graph", paged=True,
                          prefix_cache=True, n_layers=J_PAGED_LAYERS)
    # the quantized runs at J_TWIN_LAYERS (since PR 28, for the run's
    # time: ~37 s each at full depth)
    res_jq_r = serve_gemma(torch, ops, kind="int8", prefix_cache=True,
                           replay=True, cold_check=True,
                           n_layers=J_TWIN_LAYERS)[0]
    line("j-quant-int8-graph", **res_jq_r)
    res_jqp_r = serve_gemma(torch, ops, kind="fp8", paged=True,
                            prefix_cache=True, replay=True,
                            cold_check=True, n_layers=J_TWIN_LAYERS)[0]
    line("j-quant-fp8-graph", **res_jqp_r)

    # (s) self-speculative decoding: f32 parity of speculative against
    # non-speculative serving (Qwen3 contiguous, paged with a hit, int8;
    # gemma3-4b rings across the wrap), then bf16 numbers on one stream
    # and on (e)'s load
    spec_phases(torch, ops)

    # (u) seeded sampling: the PRNG on the card against the CPU, f32
    # sampled serving eager against replayed (speculative included), then
    # (e)'s load sampled, set beside the greedy e-graph run
    sampling_phases(torch, ops, res_r)

    # (k) training: gradients against the CPU, a full-width run, resume
    # from a checkpoint, then the trained weights served through the
    # kernels. Checkpoints go to a directory under build/, removed after
    (ROOT / "build").mkdir(exist_ok=True)
    t_k = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as work:
        work = Path(work)
        t0 = time.perf_counter()
        res_kg = train_grad_f32(torch, ops)
        line("k-grad", seconds=time.perf_counter() - t0, **res_kg)
        t0 = time.perf_counter()
        res_kt, trainer = train_full(torch, ops, work)
        line("k-train", seconds=time.perf_counter() - t0, **res_kt)
        t0 = time.perf_counter()
        res_kr = train_resume(torch, work)
        line("k-resume", seconds=time.perf_counter() - t0, **res_kr)
        t0 = time.perf_counter()
        res_ks = serve_trained(torch, ops, trainer.params)
        line("k-serve", seconds=time.perf_counter() - t0, **res_ks)
        del trainer
        torch.cuda.empty_cache()
    line("k-phases", seconds=time.perf_counter() - t_k)

    # (m) qwen2-moe-a2.7b + AltUp K=2, the MoE family: moe_block and the
    # kernel paths against the CPU and the dense path in f32, gradients
    # against the CPU, a few training steps, then the served path at full
    # depth, replayed, beside an eager twin and a paged run
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as work:
        res_m = moe_phases(torch, ops, Path(work))

    # (n) t5-large + AltUp K=2 and (w) whisper-tiny + AltUp K=2, the
    # encoder-decoder family: kernel path against dense path in f32,
    # Sequence-AltUp, gradients, training, then Engine.generate
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as work:
        res_n, res_w = encdec_phases(torch, ops, Path(work))

    # (l) deepseek-v3-671b + AltUp K=2, multi-head latent attention before
    # a dense or MoE FFN: no attention kernel (as in the reference), the
    # AltUp kernel in every layer; kernel path against dense path in f32,
    # contiguous against paged, served at every published width (depth
    # cut to fit the card), gradients and training at 2 layers
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as work:
        res_l = mla_phases(torch, ops, Path(work))

    # (z) zamba2-1.2b + AltUp K=2, the hybrid: Mamba-2 layers in plain
    # torch (as in the reference) and one weight-tied shared attention
    # block; the kernel path against the dense path in f32 at full depth,
    # served at full depth (contiguous and paged, float and int8),
    # gradients and training at 12 layers. (v) llava-next-mistral-7b +
    # AltUp K=2 served text-only at full depth and trained with its
    # image tokens at 4 layers; granite-3-2b + AltUp K=2 served
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as work:
        res_z = hybrid_phases(torch, ops, Path(work))
        res_v, res_gr = vlm_granite_phases(torch, ops, Path(work))

    # (x) the three examples, as a user runs them, on the card
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as work:
        example_phases(torch, Path(work))

    # (t) tensor-parallel serving through Engine(mesh=): one NCCL rank
    # from replayed graphs against the un-meshed engine, two gloo ranks
    # sharing the card, eager, against one rank
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as work:
        res_tp, res_tpc, res_tpd = tp_phases(torch, ops, Path(work))

    # (t-train) training over "model": Trainer(mesh=) over one NCCL rank
    # at full width and depth against the un-meshed Trainer, bitwise; two
    # gloo ranks sharing the card against one rank's gradients, steps and
    # a checkpoint restored into the un-meshed Trainer
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as work:
        train_tp_phases(torch, Path(work))

    # (dryrun) launch/dryrun.py: one rank of the 16 x 16 and 2 x 16 x 16
    # production meshes counted on meta, then run on the card under the
    # same fake group
    dryrun_phases(torch, ops)

    # the main path's launch counts: the replayed runs (Engine as a user
    # calls it)
    counts, counts_eq = res_r["launches"], res_eq_r["launches"]
    counts_g, counts_gq = res_g_r["launches"], res_gq_r["launches"]
    counts_i = res_i_r["launches"]

    # each kernel at the shape of the run its launches are counted in
    main_altup = altup[("bfloat16", 8)]      # (e)'s decode step
    main_ragged = ragged[("bfloat16", "e")]
    main_paged = paged[("bfloat16", "g")]
    main_wkv = wkv[("bfloat16", "i-decode")]
    main_ragged_q = ragged_q[("bfloat16", "e", "int8")]    # e-quant's
    main_paged_q = paged_q[("bfloat16", "g", "fp8")]       # g-quant's
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    kernels = [
        {"name": "altup_predict_correct", "route": "cuda",
         "source": "src/repro_torch/csrc/altup_fused.cu",
         "replaces": "src/repro/kernels/altup_fused.py:39",
         "launches": counts["altup_predict_correct"],
         **{k: main_altup[k] for k in keys}},
        {"name": "ragged_decode_attention", "route": "cuda",
         "source": "src/repro_torch/csrc/ragged_decode_attention.cu",
         "replaces": "src/repro/kernels/ragged_decode_attention.py:210",
         "launches": counts["ragged_decode_attention"],
         **{k: main_ragged[k] for k in keys}},
        {"name": "paged_ragged_decode_attention", "route": "cuda",
         "source": "src/repro_torch/csrc/ragged_decode_attention.cu",
         "replaces": "src/repro/kernels/ragged_decode_attention.py:122",
         "launches": counts_g["paged_ragged_decode_attention"],
         **{k: main_paged[k] for k in keys}},
        {"name": "ragged_decode_attention_quant", "route": "cuda",
         "source": "src/repro_torch/csrc/ragged_decode_attention.cu",
         "replaces": "src/repro/kernels/ragged_decode_attention.py:210",
         "launches": counts_eq["ragged_decode_attention"],
         **{k: main_ragged_q[k] for k in keys}},
        {"name": "paged_ragged_decode_attention_quant", "route": "cuda",
         "source": "src/repro_torch/csrc/ragged_decode_attention.cu",
         "replaces": "src/repro/kernels/ragged_decode_attention.py:122",
         "launches": counts_gq["paged_ragged_decode_attention"],
         **{k: main_paged_q[k] for k in keys}},
        {"name": "rwkv6_wkv", "route": "cuda",
         "source": "src/repro_torch/csrc/rwkv6_wkv.cu",
         "replaces": "src/repro/kernels/rwkv6_scan.py:53",
         "launches": counts_i["rwkv6_wkv"],
         **{k: main_wkv[k] for k in keys}},
        {"name": "flash_attention", "route": "cuda",
         "source": "src/repro_torch/csrc/flash_attention.cu",
         "replaces": "src/repro/kernels/flash_attention.py:120",
         "launches": main_flash["launches"],
         **{k: main_flash[k] for k in keys}},
        {"name": "flash_attention_paged", "route": "cuda",
         "source": "src/repro_torch/csrc/flash_attention.cu",
         "replaces": "src/repro/kernels/flash_attention.py:120",
         "launches": main_flash_paged["launches"],
         **{k: main_flash_paged[k] for k in keys}},
    ]
    # the same kernels at gemma3-4b's shapes, each with the launches of the
    # (j) run that serves them (the decode attention at a ring layer's
    # shape: 5 of the 6 launches a step)
    for name, src, replaces, res_run, case in (
            ("altup_predict_correct", "altup_fused.cu",
             "altup_fused.py:39", res_j_r, ("bfloat16", "altup")),
            ("ragged_decode_attention", "ragged_decode_attention.cu",
             "ragged_decode_attention.py:210", res_j_r,
             ("bfloat16", "j-ring")),
            ("paged_ragged_decode_attention", "ragged_decode_attention.cu",
             "ragged_decode_attention.py:122", res_jp_r,
             ("bfloat16", "j-paged-ring")),
            ("ragged_decode_attention_quant", "ragged_decode_attention.cu",
             "ragged_decode_attention.py:210", res_jq_r,
             ("bfloat16", "j-quant-ring", "int8")),
            ("paged_ragged_decode_attention_quant",
             "ragged_decode_attention.cu", "ragged_decode_attention.py:122",
             res_jqp_r, ("bfloat16", "j-quant-ring", "fp8"))):
        counter = name.removesuffix("_quant")
        kernels.append(
            {"name": name + "_gemma3_4b", "route": "cuda",
             "source": "src/repro_torch/csrc/" + src,
             "replaces": "src/repro/kernels/" + replaces,
             "launches": res_run["launches"][counter],
             **{k: j_kern[case][k] for k in keys}})
    # the same kernels at qwen2-moe-a2.7b's shapes, with m-serve's launches
    for name, src, replaces, key in (
            ("altup_predict_correct", "altup_fused.cu", "altup_fused.py:39",
             "altup"),
            ("ragged_decode_attention", "ragged_decode_attention.cu",
             "ragged_decode_attention.py:210", "ragged")):
        kernels.append(
            {"name": name + "_qwen2_moe", "route": "cuda",
             "source": "src/repro_torch/csrc/" + src,
             "replaces": "src/repro/kernels/" + replaces,
             "launches": res_m["launches"][name],
             **{k: m_kern[key][k] for k in keys}})
    # the same kernels at t5-large's and whisper-tiny's shapes, with
    # n-serve's and w-serve's launches
    for name, src, replaces, suffix, res_run, key in (
            ("altup_predict_correct", "altup_fused.cu", "altup_fused.py:39",
             "t5_large", res_n, "n-altup"),
            ("ragged_decode_attention", "ragged_decode_attention.cu",
             "ragged_decode_attention.py:210", "t5_large", res_n,
             "n-ragged"),
            ("altup_predict_correct", "altup_fused.cu", "altup_fused.py:39",
             "whisper_tiny", res_w, "w-altup"),
            ("ragged_decode_attention", "ragged_decode_attention.cu",
             "ragged_decode_attention.py:210", "whisper_tiny", res_w,
             "w-ragged")):
        kernels.append(
            {"name": f"{name}_{suffix}", "route": "cuda",
             "source": "src/repro_torch/csrc/" + src,
             "replaces": "src/repro/kernels/" + replaces,
             "launches": res_run["launches"][name],
             **{k: nw_kern[key][k] for k in keys}})
    # the AltUp kernel at deepseek-v3-671b's shape, with l-serve-graph's
    # launches
    kernels.append(
        {"name": "altup_predict_correct_deepseek_v3", "route": "cuda",
         "source": "src/repro_torch/csrc/altup_fused.cu",
         "replaces": "src/repro/kernels/altup_fused.py:39",
         "launches": res_l["launches"]["altup_predict_correct"],
         **{k: l_altup[k] for k in keys}})
    # the kernels at zamba2-1.2b's, llava-next-mistral-7b's and
    # granite-3-2b's shapes, with z-serve's (replayed, Z_CUT_LAYERS),
    # v-serve's and granite's launches
    for name, suffix, res_run, case in (
            ("altup_predict_correct", "zamba2", res_z["contiguous"],
             "z-altup-bf16"),
            ("ragged_decode_attention", "zamba2", res_z["contiguous"],
             "z-ragged-bf16"),
            ("paged_ragged_decode_attention", "zamba2", res_z["paged"],
             "z-paged-bf16"),
            ("ragged_decode_attention_quant", "zamba2",
             res_z["contiguous-int8"], "z-ragged-bf16-int8"),
            ("paged_ragged_decode_attention_quant", "zamba2",
             res_z["paged-int8"], "z-paged-bf16-int8"),
            ("altup_predict_correct", "llava_next", res_v, "v-altup"),
            ("ragged_decode_attention", "llava_next", res_v, "v-ragged"),
            ("altup_predict_correct", "granite", res_gr, "z-altup-bf16"),
            ("ragged_decode_attention", "granite", res_gr,
             "granite-ragged")):
        counter = name.removesuffix("_quant")
        altup = counter == "altup_predict_correct"
        kernels.append(
            {"name": f"{name}_{suffix}", "route": "cuda",
             "source": "src/repro_torch/csrc/" + (
                 "altup_fused.cu" if altup
                 else "ragged_decode_attention.cu"),
             "replaces": "src/repro/kernels/" + (
                 "altup_fused.py:39" if altup else
                 "ragged_decode_attention.py:122" if "paged" in counter
                 else "ragged_decode_attention.py:210"),
             "launches": res_run["launches"][counter],
             **{k: zv_kern[case][k] for k in keys}})
    # the decode attention at t-serve-b's local heads, with the launches of
    # its rank 0 (none when a collective failed on CUDA tensors)
    for name, suffix, tag, run, case in (
            ("ragged_decode_attention", "qwen3", "qwen3", "mesh",
             "t-qwen3-ragged"),
            ("paged_ragged_decode_attention", "qwen3", "qwen3",
             "mesh_paged", "t-qwen3-paged"),
            ("ragged_decode_attention", "qwen2_moe", "qwen2_moe", "mesh",
             "t-qwen2-moe-ragged")):
        if tag not in res_tp:
            continue
        kernels.append(
            {"name": f"{name}_tp{T_RANKS}_{suffix}", "route": "cuda",
             "source": "src/repro_torch/csrc/ragged_decode_attention.cu",
             "replaces": "src/repro/kernels/" + (
                 "ragged_decode_attention.py:122" if "paged" in name
                 else "ragged_decode_attention.py:210"),
             "launches": res_tp[tag][run]["launches"][name],
             **{k: t_kern[case][k] for k in keys}})
    # the WKV kernel and the decode attention at t-serve-c (b)'s local
    # heads (RWKV-6's 16 of 32, t5-large's 8 of 16), with its rank 0's
    # launches
    for name, src, replaces, tag, case in (
            ("rwkv6_wkv", "rwkv6_wkv.cu", "rwkv6_scan.py:53", "rwkv6",
             "tc-wkv-h16"),
            ("ragged_decode_attention", "ragged_decode_attention.cu",
             "ragged_decode_attention.py:210", "t5_large", "tc-t5-ragged")):
        if tag not in res_tpc:
            continue
        kernels.append(
            {"name": f"{name}_tp{T_RANKS}_{tag}", "route": "cuda",
             "source": "src/repro_torch/csrc/" + src,
             "replaces": "src/repro/kernels/" + replaces,
             "launches": res_tpc[tag]["mesh"]["launches"][name],
             **{k: tc_kern[case][k] for k in keys}})
    # the decode attention's split pass and its merge over gathered spans
    # at phase c's D = 2 case ((e)'s heads, a slot of TD_T rows over two
    # ranks; the split's numbers are the first rank's shard), with the
    # launches of t-serve-d (b)'s rank 0 (bf16)
    td = td_kern["td-d2-bf16"]
    for name, pre in (("ragged_decode_split", "split"),
                      ("ragged_decode_merge", "merge")):
        kernels.append(
            {"name": name, "route": "cuda",
             "source": "src/repro_torch/csrc/ragged_decode_attention.cu",
             "replaces": "src/repro/kernels/ragged_decode_attention.py:210",
             "launches": res_tpd["long_bf16"]["launches"][name],
             "max_abs_err": td[f"{pre}_max_abs_err"], "ms": td[f"{pre}_ms"],
             "plain_ms": td[f"{pre}_plain_ms"],
             "bound_ms": td[f"{pre}_bound_ms"],
             "bound_by": td[f"{pre}_bound_by"], "library_ms": None})
    line("z-total", seconds=time.perf_counter() - T_START)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
