#!/usr/bin/env python3
"""Smoke run of the PyTorch port (vorta_tpu_torch) on one NVIDIA GPU.

  python3 chip_smoke.py

Phases, each raising on failure:
  1. device: torch / CUDA versions, the card's name and power limit; build
     the CUDA kernels from csrc/ (one nvcc per source, in parallel); ptxas's
     registers and spills of every kernel, and of the Hopper path's fifteen
     instantiations (csrc/attn_sm90.cuh: flash's, flash_manual's bf16 and
     int8, sta_pipe's window walk, sta_window's two (runs padded to 32
     tokens or not), sta_row's (sta_window's unpadded kernel, built in
     csrc/sta_row.cu), sta_batched's pair-bit walk, sta_diag's five
     bisection variants over its chunk walk; and the backward's dq and
     dk/dv kernels of csrc/flash_bwd.cu on its pieces; none may spill)
     with its dynamic shared memory, and of the norm's and the qk
     prologue's warp-per-row kernels and unpool's batched 16-byte copy (72,
     27 and 24 in bf16 and f32; no spills either), and the f32 attention
     core's 10 users (held to 128 registers; their spills reported), the
     f32 tensor-core kernels and flash_manual's int8 one
     (flash_manual_int8_tc_kernel, with its dynamic shared memory; none may
     spill).
     Every flash, flash_manual, sta_pipe,
     sta_window and sta_batched row reports its achieved TFLOP/s, its share
     of the bound and its ratio to the library call; every sta_pipe,
     sta_window and sta_batched row also the mma.sync kernel's time in the
     same call,
     every fused_norm row its GB/s and share of the bytes bound beside
     F.layer_norm(x, (dim,), 1 + scale, shift) at B = 1, the same function;
     every qk prologue row its GB/s, share of the bytes bound and host us
     per call beside its block-per-row kernel's time in the same call.
  2. kernels: each kernel on the card against its plain PyTorch version on
     the same inputs, with kernel / plain / library / bound times: flash,
     AdaLN norm and qk prologue at the routing-off path's shapes (Wan-1.3B
     at 480p x 21 frames = 9,360 tokens, bf16); the prologue also at 720p x
     77f (1,72000,1536) and at Wan-14B's width (1,72000,5120), each on its
     warp-per-row kernel (launch counted) against the plain version and the
     block-per-row kernel (its normalised values within one bf16 ulp, v
     bitwise), the two timed in one call; flash also at 720p x 77f
     self-attention (1,12,72000,128), held against the plain version on one
     head, beside SDPA on all twelve; flash_manual, sta_pipe,
     pool_qkv and unpool at the routed path's (480p x 77 frames = 31,200
     tokens; sta_pipe also at 720p's tile), some heads routed away; unpool
     on its batched 16-byte copy (counted), bit for bit against the plain
     version and the first design's kernel (unpool_per_group), the two, the
     plain version and torch.gather over a precomputed index timed in one
     call with the host's enqueue hidden; the AdaLN norm also at 480p x
     77f (1,31200,1536).
  2h. the pool's head-map mode (pool_qkv / unpool over the routed heads
     alone) at HunyuanVideo 720p x 45f (1,24,43200,128) with K's own
     matching, 16 of 24 heads routed, and at Wan 720p x 77f
     (1,12,72000,128), 5 and 12 of 12 routed, against their plain versions
     and the active mode on the routed heads, timed beside the active mode
     (unpool as in phase 2: rows kernel, first design, plain, gather);
     the copy probe of tools/bench_pool.py at Wan 720p, bitwise against its
     plain version, beside pool_qkv, index_select and its bytes bound.
  2q. int8 kernels (quantized serving): flash_manual's and sta_pipe's int8
     QK modes against their plain versions on the same int8 q / k (Wan FULL
     (1,12,31744,128) and LOWRES (1,12,16384,128), 8 heads routed; the
     HunyuanVideo FULL joint layout (1,24,45056,128) with kv_bias; sta_pipe
     (1,12,31200,128) tile (4,6,4), and (1,24,43200,128) + 256 int8 text
     keys), each with its bracket (the plain version with qk_scale ignored
     must fail), the quality gate against the bf16 mode (mean relative
     error < 0.05), times against the bf16 mode and SDPA; W8A8
     int8_linear at the Wan FFN's 31,200 x 1,536 -> 8,960 and back against
     its plain version (the int8 product in f64, exact) and bf16 nn.Linear.
  2f. the STA fallbacks: sta_window at Wan 720p (1,12,72000,128) tile
     (4, 9, 10), 8 heads active, and at HunyuanVideo 45f (1,24,43200,128)
     tile (4, 9, 10) with 256 text keys (83 valid); sta_batched on the
     HunyuanVideo (2, 9, 8) joint layout (1,24,48384,128), blocks 432 / 1008,
     pair bits and kv_bias, 16 heads active; sta_row (a direct call) at Wan
     720p tile (5, 9, 8) and HunyuanVideo 45f tile (6, 9, 8) with the text
     tail; each against its plain version with its bracket, times against
     SDPA with the boolean / float mask and the bound of the visible pairs.
     sta_window, sta_batched and sta_row run their Hopper paths (each call
     counted once on it), held and timed beside their mma.sync kernels in
     the same call (within 2 TOL of each other); sta_batched also reports its slot
     lists' size (ops/sta_batched.py:pair_bit_walk) and the mma.sync
     kernel's fast / stable probe: both softmaxes with the served pair bits
     and bias, each alone and neither, and the SASS of both instantiations.
  2o. the kernels and modes of PR 8, each against its plain version and
     timed beside the call it would replace: fused_residual_norm at Wan
     (1,31200,1536) gate + AdaLN and HunyuanVideo (1,43456,3072) gate +
     affine + beta (x_new bitwise, y within the tolerance, beside the
     residual line then the fused_norm kernel) and its backward at
     (1,256,1536) (all seven gradients, relative L2 <= 1e-2); the five
     sta_diag variants at the tool's default (1,12,72000,128), tile
     (5,9,8), each launched once on its Hopper path (counted as
     sta_diag_wgmma), against the plain version and timed beside its
     mma.sync kernel (sta_diag_attention_mma_sync), sta_pipe's fast call
     and SDPA with the STA mask, with its share of the bound and, for
     dma_only, the boxes' bytes through L2 and their rate (dma_only all
     zeros on both kernels; no_dma run twice, timed only, then full held
     again); sta_pipe's stable softmax and
     dots / qk / sT variants at the same call (and stable with
     HunyuanVideo's 256-key text tail at (1,24,43200,128)); flash_manual's
     stable softmax at Wan FULL (1,12,31744,128) and the HunyuanVideo FULL
     joint layout with kv_bias; sta_batched's stable softmax on the
     (2, 9, 8) joint layout.
  3. model checks: a 2-block Wan-1.3B-width forward on the card (bf16,
     kernels) against the same weights on the CPU (f32, plain versions),
     routing off, then routed hard with the heads sent to all three experts,
     in bf16 and with qk_int8 + W8A8, and routed hard at tile (4, 9, 10) on
     a (4, 18, 80) grid, where the gates pick sta_window; routed hard under
     each of the JAX package's dispatch variables (VORTA_LOWRES_DISPATCH=
     batched / hybrid, VORTA_ROUTED_DISPATCH=switch), launches exact.
  4. main path, routing off: vorta_tpu_torch.cli.sample at full width and
     depth (30 blocks), --native_attention, 480p x 21 frames, 2 UniPC steps
     with CFG 5.0 = 4 DiT forwards, after one warm-up forward of a 2-block
     model at the same shapes; finite output of the right shape; exact
     launch counts.
  5. main path, routed: the same CLI at its defaults (480p x 77 frames,
     routing hard), 2 UniPC steps with CFG = 4 forwards after a warm-up
     forward; launch counts exact against the routing tables the run used,
     all three experts used; then the same with --qk_int8 --mm int8, the
     int8 QK mode launched wherever flash_manual is.
  5d. the routed forward under each dispatch: one Wan-1.3B 480p x 77f
     forward at full width and depth (random routers) masked, batched,
     hybrid and switch; launch counts exact, ms per forward, each output
     against the masked dispatch's.
  5b. tools/bench_pool.py's five stages (both, pool, copy, headmap5,
     headmap12) at Wan 720p, the plain and the kernel arms, ms per stage.
  5t. python -m vorta_tpu_torch.tools.sta_diag with its five variants at
     Wan 720p, in this process: ms per call, launches exact (warm-up and
     timed calls, 8 per variant), every one on the Hopper path
     (sta_diag_wgmma).
  5s. static scales: calibrate_mm on the card over one 480p x 77f routed
     W8A8 forward, then the forward with those static scales (amax / 127),
     its distance from the dynamic one and both times.
  6. one 720p x 77-frame forward (72,000 tokens), timed, routing off; then
     bench.py's routed arm: routed hard at t = 500 by the JAX package's
     trained router (assets/bench_router_wan1_3b_720p_half.npz), fed the
     time embedder of the model it was trained against
     (port_assets/wan1_3b_time_embedder_rngs0.npz).
  6f. main path, STA fallback: the CLI with --resume_dir at Wan-1.3B 720p x
     77f from the config.json that cli.train --sta_tile 4 9 10 writes (STA
     heads through sta_window), 2 UniPC steps with CFG = 4 forwards, random
     routers on all three experts; launch counts exact, sta_pipe never.
HunyuanVideo-13B (its phases free the Wan models first):
  a. kernels at HunyuanVideo's 720p x 45f shapes (grid (12, 45, 80) =
     43,200 video + 256 text tokens, 83 valid, 24 heads x 128, 16 of them
     routed to the expert under test): flash_manual with kv_bias on the
     FULL and LOWRES joint layouts and the STA text rows (block_q 256,
     block_kv 1024, kv_valid_len + bias), and with a bias that masks the
     kv block every row visits first; sta_pipe with the text tail (432-token
     tiles); pool_qkv with K's own matching, and unpool (as in phase 2); the qk prologue
     (head scope, text rows unrotated: warp-per-row beside block-per-row)
     and the AdaLN norm on the single block's joint stream.
  b. model check: a 1 dual + 1 single-block model at 13B widths on the card
     (bf16, kernels) against the same weights on the CPU (f32, plain
     versions), routing off and routed hard with the heads on all three
     experts.
  c. main path: vorta_tpu_torch.cli.sample --model hunyuan-13B at full width
     and depth (20 + 40 blocks), 720p x 45f, 2 Euler steps = 2 forwards,
     routing off (--native_attention) and routed hard (its default), after
     warm-up forwards of a 1 + 1-block model; launch counts exact (routed:
     against the run's routing tables, the LOWRES pool and unpool counted in
     head-map mode, as the JAX package pools there), all three experts used.
     Phases b and c run again with qk_int8 + W8A8 (the CLI's --qk_int8
     --mm int8): FULL and LOWRES in the int8 QK mode, routing off too.
     Phase b also runs routed hard at tile (2, 9, 8) on a (6, 18, 32) grid
     (sta_batched).  The CLI's --random_embeds marks all 256 text tokens
     valid, as the JAX CLI does.
  cf. main path, STA fallback: the CLI with --resume_dir at HunyuanVideo-13B
     720p x 45f from a config.json with sta_tile (2, 9, 8) (STA heads
     through sta_batched on the joint layout), 2 Euler steps; launch counts
     exact, sta_pipe never.
  d. HunyuanVideo's reference shape, 720p x 117f (108,000 + 256 tokens):
     one timed forward routed hard, then one routing off; launch counts
     exact (the STA heads through the kernel the gates pick there).
  e. Wan-14B (40 blocks, dim 5120) from an int4 stack through a depth-1
     model: its GiB, one 480p x 77f forward routed hard with its time and
     peak memory, and a 2-block check, card vs CPU on the same stack.
Serving the way users run it (no new kernel):
  f. torch_import: a synthetic diffusers Wan 2.1 T2V-1.3B checkpoint (full
     width, 30 blocks, random bf16 drawn from a seed, diffusers' key names,
     two safetensors shards) and a reference router.pt through cli.sample
     --torch_checkpoint --router_checkpoint, 480p x 77f routed, 2 UniPC
     steps with CFG; every parameter of the served model equals the host's
     own mapping of its source tensor (renames, fused projections, half-RoPE
     rows), bit for bit; again with --quantize_blocks int8 (the depth-1
     model's modules and the merged routers held); HunyuanVideo-13B's key
     set validated (20 + 40 blocks) and, at 2 + 2 blocks, loaded, held bit
     for bit and run 2 routed Euler steps at 720p x 45f; launches exact.
  g. step_cache: Wan-1.3B 720p x 77f routed by the trained router (and its
     time embedder), 10 UniPC steps with CFG, the fitted polynomial
     (assets/cache_poly_wan1_3b_720p.npz), at a threshold picked from a
     fixed ladder by the host's replay (some steps skipped, every sum 0.01
     from it): uncached, cached and at threshold 0; the card's skip flags
     against the host's f64 replay of cache_decision on the card's
     indicators (flags may differ only within 1e-4 of the threshold),
     launches exact (a skipped forward runs only its head's norm),
     threshold 0 bit for bit the uncached trajectory; s per denoise step.
  h. i2v: the image cross-attention (1,12,31200,128) x 257 keys on flash's
     Hopper path against its plain version (the padded keys random, so a
     row seeing them fails), timed beside SDPA with its bound; a 2-block
     Wan-1.3B-width forward with image_dim 1280, card vs CPU; cli.sample
     --image_embeds (257 x 1280) at 480p x 77f routed, every flash launch on
     the Hopper path; HunyuanVideo-13B with token replace at 720p x 45f,
     routed, one Euler step, the norm's row ranges counted
     (fused_norm_range), launches exact.
Prompt to video (no new kernel; the slice's path runs the DiT's kernels):
  i. text_encoders: UMT5-XXL, Llama-8B and CLIP-L at full width and depth
     (random bf16 from a seed): ms per encode (512; 256 + 95 template; 77
     tokens), parameter GiB, the bound; each at 2 layers card bf16 vs CPU
     f32, rel L2 < 0.05, UMT5's padded rows zero.
  j. vae_decode: one cuDNN conv3d over (1, 192, 77, 480, 832) bf16 (5.9e9
     elements: raises, or its end frames against pieces); both VAEs at full
     width card bf16 vs CPU f32 (rel L2 < 0.05), chunked vs one call on the
     card (f32: rel L2 <= 1e-3; bf16 reported), a single tile exact; then
     Wan 480p x 77f whole-clip, Wan 720p x 77f tiled, HunyuanVideo 720p x
     45f tiled and 720p x 21f whole-clip (its top stage 2.48e9 elements):
     s, peak GiB, FLOP bound.
  k. prompt_to_video: cli.sample --prompt --tokenizer_dir --decode through
     main(argv): Wan-1.3B 480p x 77f routed, 2 UniPC steps, whole-clip
     decode (frames against a decode apart); HunyuanVideo-13B 720p x 45f
     routed, 1 Euler step, --vae_tiling; encode s, s per step, decode s,
     launches exact (a toy BPE tokenizer, or a stand-in without the
     tokenizers package).
Evaluation and the last entry points (no new kernel; the serving kernels
through new entry points):
  l. bench_compare: python -m vorta_tpu_torch.cli.bench_compare through
     main(argv): Wan-1.3B 480p x 77f, 2 UniPC steps with CFG, the JAX
     package's 480p router (assets/bench_router_wan1_3b.npz, with its time
     embedder), the cached arm and --tau_sweep 0.2,0.5; again with --mm
     int8_static (1 step; 3 calibration forwards); HunyuanVideo-13B 720p x
     45f, 1 Euler step, baseline and vorta.  Each arm's launches exact (the
     baseline's: no flash_manual, sta_pipe, pool_qkv or unpool), the routing
     mix equal to the mix counted from the routing ids, every number of
     summary.json finite, the vorta arm's --seed latents bit for bit
     cli.sample's for the same seed, router and flags; s per step and the
     speed-ups recorded, not gated.
  m. calibrate_int8: the tool with --geom 480p --timesteps 400,700, its
     scales bit for bit the direct max over the same model's calibrate_mm
     forwards / 127, launches exact; then cli.sample --mm int8 --act_scales
     <that file>, one routed UniPC step with CFG, launches exact.
  n. fit_cache_poly: the tool at Wan-1.3B 480p x 77f, 8 Euler steps, CFG 5,
     the 480p router: 7 points, finite coefficients and r2, 16 routed
     forwards' launches exact; then cli.sample --cache_threshold 0.75
     --cache_poly <that file>, 4 UniPC steps with CFG, launches exact.
  o. profiling: io/profiling.profile_call on one routed Wan-1.3B 480p x 77f
     forward with the 480p router: every port kernel's device events,
     counted by its symbols, equal its launch counter; the top 25 device
     ops by name (sta_batched's counter stands for two CUDA launches, its
     live-slot pass and its kernel: off this path).
The f32 serving path (TF32 off for cuBLAS and cuDNN, checked first):
  p. f32_kernels: the eight kernels of the f32 serving path in their f32
     modes (csrc/attn_f32.cuh's FFMA core for sta_pipe and sta_batched and
     for flash and flash_manual at D 64 / small blocks, csrc/attn_f32_tc.cuh's
     tensor-core core (3xTF32 on wgmma) for flash and flash_manual at D 128
     with blocks multiples of 128, counted as <kernel>_f32_tc and timed in
     turns with the FFMA core at the same call, bound 3 x FLOP at 495
     TFLOP/s TF32 with the 67 TFLOP/s FFMA bound beside it, and a bracket
     of q, k, v rounded once to TF32 that must read >= 2e-4 at FULL and
     LOWRES; the norm, the prologue, pool and unpool instantiated
     on f32), each against its f32 plain version: attention worst |err| /
     max(|plain|, RMS) <= 1e-4, norm and prologue <= 1e-5, pool and unpool
     bit for bit where the picks agree; each call counted once on its
     <kernel>_f32 counter; brackets (the plain version without the tail
     mask, kv_bias, pair bits or text bias must fail the gate).  Shapes:
     flash at 480p x 21f self- and cross-attention (SDPA in f32 beside it)
     and per-head tables at blocks of 16, D 64; flash_manual's routed FULL
     and LOWRES calls at 480p x 77f with count-0 heads, kv_bias +
     kv_valid_len in both softmaxes, D 64 blocks of 16; sta_pipe at 480p x
     77f (masked SDPA beside it), the text tail in both softmaxes, wan-tiny's
     tile; sta_batched on hunyuan-tiny's joint layout (8-token tiles, both
     softmaxes) and HunyuanVideo (2, 9, 8)'s; the norm at (1,31200,1536),
     Wan-14B's width and dim 128 (F.layer_norm beside it); the prologue at
     Wan-1.3B's, HunyuanVideo's (head scope), Wan-14B's (eight warps a row)
     and the tiny models' widths; pool / unpool at 480p x 77f active mode
     and in head-map mode with K's matching (torch.gather beside unpool).
  q. f32 model checks: Wan 2 blocks at 1.3B widths off and routed, and
     HunyuanVideo 1 + 1 blocks at 13B widths routed, card f32 against CPU
     f32 from the same weights: rel L2 <= 1e-4, launches exact.
  r. f32 serving: cli.sample --dtype fp32 for Wan-1.3B at full width and
     depth, off at 480p x 21f and routed at 480p x 77f (one UniPC step x
     CFG each, s per step); wan-tiny and hunyuan-tiny through cli.sample (2
     steps, card against --device cpu from host-drawn weights, noise and
     embeddings: final latents rel L2 <= 1e-3, routing equal), through
     cli.bench_compare (every arm) and wan-tiny through
     tools.fit_cache_poly; every path's launches exact (f32_launches: no
     Hopper path, every launch of the eight kernels on its *_f32 counter,
     the 1.3B / 13B widths' flash / flash_manual launches on *_f32_tc)
     and each *_f32 counter non-zero on some path; then (f32_profile) one
     routed 480p x 77f forward in f32 split by op (cli.profile_forward
     --dtype fp32 --routing hard, in-process), and one with --qk_int8.
  v. f32_window_int8_kernels: sta_window and sta_row in f32 (the f32 core
     over csrc/window_walk_f32.cuh's window walk, stable softmax) and the
     int8 QK modes of flash_manual and sta_pipe with an f32 v (dp4a
     scores), each against its plain version on the same inputs (worst
     ratio <= 1e-4; a text-tail case's bracket, the text bias dropped, >= 2x
     that): sta_window at Wan 720p x 29f and 77f, tile (4, 9, 10), and
     HunyuanVideo 45f + 256 text keys (83 valid); sta_row at Wan 720p (5,
     9, 8); flash_manual at Wan's routed FULL / LOWRES and HunyuanVideo's
     joint FULL layout with kv_bias; sta_pipe at (1,12,31200,128) tile (4,
     6, 4) and with 256 int8 text keys; D 64 with text tails of 24 and 88
     keys, inactive heads zero; timed beside the plain version, f32 SDPA
     with TF32 off (a float mask) and the int8 modes beside the f32 mode.
     flash_manual's three served shapes run its tensor-core int8 kernel
     (csrc/attn_int8_tc.cuh, counted as flash_manual_int8_tc), timed in
     turns with the dp4a / FFMA mode at the same call, its bound QK at 1,979
     TOPS plus 3 x PV at 495 TFLOP/s beside the FFMA-rated one, brackets
     kv_bias dropped and the PV as one TF32 product (each >= 2x the
     tolerance).
  w. f32_window_int8_models: Wan 2 blocks at 1.3B widths routed at (4, 9,
     10) (sta_window f32) card f32 vs CPU f32 rel L2 <= 1e-4; Wan 2 blocks
     and HunyuanVideo 1 + 1 blocks (routed and off) with qk_int8 in f32,
     rel L2 <= 1e-3, the int8 values the two sides round differently
     counted; launches exact.
  x. f32_window_int8_serving: cli.sample --dtype fp32 --resume_dir at
     Wan-1.3B full width and depth, tile (4, 9, 10), 720p x 29f (sta_window
     f32 once a block with STA heads, sta_pipe never) and cli.sample
     --dtype fp32 --qk_int8 at 480p x 77f (flash_manual only in its int8
     mode with an f32 v, every launch on its tensor-core kernel), one UniPC
     step x CFG each, s per step and peak
     GiB; wan-tiny, hunyuan-tiny routed and off through cli.sample --dtype
     fp32 --qk_int8, 2 steps, card vs --device cpu rel L2 <= 1e-3.
Every main path's launch counts are exact, the Hopper path's subset
counters (flash_wgmma, flash_manual_wgmma, sta_pipe_wgmma,
sta_window_wgmma, sta_batched_wgmma, flash_dq_wgmma, flash_dkv_wgmma),
the prologue's warp-per-row counter (prologue_rows) and unpool's batched
copy's (unpool_rows) included: on the served paths every qk prologue
launch takes its warp-per-row kernel, every unpool launch (active and
head-map modes; phases 5, 5d, 6, 6f, c, cf, d) the batched copy, and
every flash, flash_manual, sta_pipe,
sta_window and sta_batched launch takes that path (flash_manual's int8 QK
mode too; phases 6f and cf for the two fallbacks), in training every
flash, dq and dk/dv launch but the STA expert's (96- and 360-token tiles);
sta_pipe's int8 QK mode, stable softmax and variants and
sta_batched's stable softmax (phases 2q, 2o) stay on their mma.sync
kernels, counted there.  Phase 6 counts its forwards' launches too.
Phases 1-6, a-o, p-r and v-x run under torch.inference_mode(); the training phases do not:
  7. training kernels: the flash forward with its log-sum-exp, and the dq
     and dk/dv backward kernels, each against its plain version at the four
     shapes the trainer gives them (480p x 77f: FULL, LOWRES, STA's
     96-token tiles, cross-attention to 512 text tokens), at the STA
     expert's shape at the bench router's geometry ((1,12,36000,128),
     blocks 360 = 8 x 45) and at 24-token blocks (8 x 3, tile (2, 3, 4) on
     (8, 30, 52)), with SDPA's backward (forward + backward, minus forward)
     as the library yardstick.  FULL, LOWRES and the cross-attention take
     the backward's Hopper kernels (counted as flash_dq_wgmma /
     flash_dkv_wgmma); there the mma.sync kernels are held against the
     plain version too and timed beside them in turns (Hopper, mma.sync,
     Hopper), each with TFLOP/s and share of the bound.
  8. gradient check: one router train step of a 2-block Wan-1.3B-width
     model on the card (bf16, kernels) against the CPU (f32, plain
     versions), same weights and draws: loss and router gradients; again at
     a 360-token tile (grid (10, 18, 16), tile (5, 9, 8)).
  9. main path, training: vorta_tpu_torch.cli.train at full width and depth
     (480p x 77f, soft routing with the teacher, remat), 2 optimizer steps
     of 2 micro-steps, a checkpoint, then resumed for a third step; launch
     counts exact against the count derived from the graph (train_launches).
  9h. main path, training at the bench router's geometry: cli.train
     --num_latent_t 10 --video_height 720 --video_width 1280 --sta_tile 5 9 8
     (36,000 tokens, 360-token tiles) at full width and depth, 2 optimizer
     steps of 1 micro-step; s per micro-step, peak memory, exact launches.
HunyuanVideo router training and sequence parallelism (no new kernel):
  10. Hunyuan gradient check: one router train step of a 2 + 2-block
     HunyuanVideo-13B-width model (grid (6, 9, 8), one STA tile, 432 + 256
     tokens) on the card (bf16, kernels) against the CPU (f32, plain
     versions), same weights and draws: loss within 2%, router gradients rel
     L2 <= 0.1; launches exact (the AdaLN norm and, in the teacher's
     off_ref pass, the qk prologue: the soft experts and off_ref run the
     plain chunked attention, as JAX runs its XLA reference).
  11. main path, Hunyuan training: cli.train --model hunyuan-13B
     --synthetic_data at full width and depth (20 + 40 blocks, 24 x 128
     heads) at 432 x 768 x 21 frames = (6, 27, 48) = 7,776 + 256 tokens (the
     (6, 9, 8) tile must divide the grid: 480 x 832 it does not), 1
     optimizer step of 1 micro-step, a checkpoint, resumed for a second (the
     resumed micro-step the steady one); s per micro-step, peak GiB,
     launches exact (hy_train_launches); then
     cli.sample --resume_dir --router_checkpoint <step dir> serves those
     routers for one routed Euler step, launches exact.
  12. SP at world size 1 through an NCCL group on a file:// store, each run
     bit for bit against the same run without a group, launches unchanged:
     cli.sample --sp_size 1 --dp_size 1 (Wan-1.3B routed 480p x 77f, 2
     UniPC steps with CFG), one HunyuanVideo-13B routed 720p x 45f Euler
     step through the pipeline's sp_group, and a 2-block Wan train step
     with sp_group and --shard_frozen's layer-sharded blocks (loss and
     router gradients); the time of one all_to_all at Wan's q shape.
Then a line of the W8A8, static-scale and Wan-14B numbers, a line of the
Hunyuan training and world-size-1 SP numbers, a line of the evaluation
phases' numbers, a line of the f32 phases' numbers, a {"kernels":
[...]} line (the prologue's row with its warp-per-row launches by path;
unpool's with unpool_rows' and the first design's time; sta_diag's with
sta_diag_wgmma's and its mma.sync kernel's times; sta_row's with
sta_row_wgmma's; flash_manual's int8 mode a row of its own; sta_pipe's, which
no main path runs, under its row's "modes"; pool_qkv's and unpool's
head-map mode under theirs, with the HunyuanVideo routed path's launches;
copy_probe a row whose launches are the pool benchmark tool's; sta_row, which no geometry of
the port's paths reaches, fused_residual_norm, which no model calls, and sta_diag, whose
launches are the sta_diag tool's, with "on_main_path": false; the stable softmax and
sta_pipe's variants under their kernels' "modes"; the eight f32 modes
under theirs as "f32", with their launches on the f32 paths, and sta_window's
and sta_row's as "f32", flash_manual's int8 QK mode with an f32 v under the
int8 row as "f32_v" (on its tensor-core kernel at the served shapes: its time, both
bounds, the dp4a / FFMA mode's time at the same call, its launches on the
tensor cores), sta_pipe's under its row as "int8_f32_v"), the card
line, and
the last line
{"ok": true, "device": {...}}.  Exits non-zero, printing no result, without
CUDA or without the package beside this file.
"""

from __future__ import annotations

import functools
import json
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent

# H100 SXM data-sheet peaks (dense): bf16 tensor cores, f32 outside them, HBM
PEAK_BF16 = 989e12
PEAK_F32 = 67e12
PEAK_TF32 = 495e12  # TF32 on the tensor cores: 3xTF32 gives f32-exact products at a third
PEAK_BYTES = 3.35e12

GRID_480P = (6, 30, 52)  # Wan latent grid of 480 x 832 x 21 frames: 9,360 tokens
GRID_480P_77F = (20, 30, 52)  # 480 x 832 x 77 frames: 31,200 tokens, the CLI's default
GRID_720P = (20, 45, 80)  # 720 x 1280 x 77 frames: 72,000 tokens
TEXT_LEN = 512
ROUTER_720P = "assets/bench_router_wan1_3b_720p_half.npz"
# bench.py's model's time embedder (nnx.Rngs(0)), which the router reads
TEMB_720P = "port_assets/wan1_3b_time_embedder_rngs0.npz"
# heads (full, lowres, sta) that the JAX package routes there at t = 500
# (BENCH_r05.json's routing_mix; port_assets/export_time_embedder.py --mix)
JAX_MIX_720P = (0, 164, 196)
# HunyuanVideo-13B: latent grids of 720 x 1280 at 45 and 117 frames, its
# text length and the text tokens --random_embeds marks valid
GRID_HY_45F = (12, 45, 80)  # 43,200 video tokens
GRID_HY_117F = (30, 45, 80)  # 108,000: the paper's reference shape
HY_TEXT, HY_VALID = 256, 83
# heads routed to the expert under test in the Hunyuan kernel checks: 16 of 24
HY_ACTIVE = tuple(int(i % 3 != 0) for i in range(24))


def log(msg: str) -> None:
    print(f"[smoke] {msg}", flush=True)


def bound_ms(flops: float, nbytes: float, peak_flops: float) -> tuple:
    t_ops, t_bytes = flops / peak_flops * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def with_rate(t: dict, flops: float) -> dict:
    """A timing (ms, bound_ms, library_ms) with its achieved TFLOP/s, its
    share of the bound and its ratio to the library call added."""
    t["tflops"] = flops / t["ms"] / 1e9
    t["bound_share"] = t["bound_ms"] / t["ms"]
    if t.get("library_ms"):
        t["vs_library"] = t["ms"] / t["library_ms"]
    return t


HOPPER_KERNELS = ("flash", "flash_manual", "sta_pipe", "sta_window", "sta_batched")


def served_on_wgmma(launches: dict, what: str) -> None:
    """On a served path every flash, flash_manual (the int8 QK mode too),
    sta_pipe, sta_window and sta_batched launch takes the Hopper path,
    every qk prologue launch the warp-per-row kernel and every unpool
    launch (either mode) the batched 16-byte copy (their counters are
    subsets)."""
    want = tuple(launches[k] for k in HOPPER_KERNELS)
    got = tuple(launches[f"{k}_wgmma"] for k in HOPPER_KERNELS)
    if got != want:
        raise RuntimeError(f"{what}: Hopper-path launches {HOPPER_KERNELS} {got} != {want}")
    if launches["prologue_rows"] != launches["prologue"]:
        raise RuntimeError(f"{what}: prologue launches {launches['prologue']}, "
                           f"{launches['prologue_rows']} of them warp-per-row")
    unpools = launches["unpool"] + launches["unpool_headmap"]
    if launches["unpool_rows"] != unpools:
        raise RuntimeError(f"{what}: unpool launches {unpools}, {launches['unpool_rows']} of "
                           "them on the batched 16-byte copy")
    log(f"{what}: " + ", ".join(f"{k} {g} of {w}" for k, g, w in zip(HOPPER_KERNELS, got, want))
        + f" launches on the Hopper path; prologue {launches['prologue_rows']} of "
        f"{launches['prologue']} warp-per-row; unpool {launches['unpool_rows']} of {unpools} "
        "on the batched 16-byte copy")


def sta_rates(t: dict, flops: float) -> dict:
    """``with_rate`` for an sta_pipe timing, and the mma.sync kernel's share
    of the bound and its time over the Hopper path's, from the same call."""
    with_rate(t, flops)
    t["mma_sync_tflops"] = flops / t["mma_sync_ms"] / 1e9
    t["mma_sync_bound_share"] = t["bound_ms"] / t["mma_sync_ms"]
    t["mma_sync_over_hopper"] = t["mma_sync_ms"] / t["ms"]
    return t


def sta_path_once(torch, what: str, fn, hopper: bool, kernel: str = "sta_pipe") -> None:
    """One call of an STA kernel, counted: launched once, on the Hopper path
    (<kernel>_wgmma) exactly where ``hopper``."""
    from vorta_tpu_torch.ops import _build

    _build.reset_launches()
    fn()
    torch.cuda.synchronize()
    got = (_build.launches[kernel], _build.launches[f"{kernel}_wgmma"])
    if got != (1, int(hopper)):
        raise RuntimeError(f"{what}: launches ({kernel}, {kernel}_wgmma) {got}, want "
                           f"(1, {int(hopper)})")
    log(f"{what}: {'on the Hopper path' if hopper else 'on the mma.sync kernel'}")


def ptxas_entries(logs: dict, entry: str) -> list:
    """(source, entry, registers line, spill line) of every kernel whose
    mangled name holds ``entry``, from nvcc's -Xptxas -v reports."""
    out = []
    for src, text in logs.items():
        name = spill = None
        for line in text.splitlines():
            if "Compiling entry function" in line:
                name = line.split("'")[1] if "'" in line else line
            elif "spill" in line:
                spill = line.strip()
            elif "registers" in line and name and entry in name:
                out.append((src, name, line.strip(), spill))
    return out


def build_kernels() -> None:
    """Build every kernel (one nvcc per source, in parallel) and report
    ptxas's registers and spills; the Hopper path's fifteen instantiations,
    the norm's and the prologue's warp-per-row kernels and unpool's batched
    copy must not spill (the f32 attention kernels' spills are reported)."""
    from vorta_tpu_torch.ops import _build

    t0 = time.time()
    _build.build_all()
    log(f"kernels built in {time.time() - t0:.1f}s into {_build.build_dir()}")
    for name, text in _build.ptxas_logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"ptxas {name}: {line.strip()}")
    from vorta_tpu_torch.ops.sta_pipe import window_walk
    from vorta_tpu_torch.ops.sta_window import window_box
    from vorta_tpu_torch.tools.sta_diag import diag_walk

    hopper = ptxas_entries(_build.ptxas_logs, "sm90_kernel")
    smem = _build.load("flash").vorta_attn_sm90_smem_bytes()
    # the window kernels' CTAs also hold their walk table: per served geometry
    sta_smem = {name: _build.load("sta_pipe").vorta_sta_sm90_smem_bytes(
        window_walk(grid, tile, (3, 3, 3), lt, box).shape[0])
        for name, grid, tile, lt, box in (
            ("sta_pipe wan_480p_77f", GRID_480P_77F, (4, 6, 4), 0, None),
            ("sta_pipe wan_720p_77f", GRID_720P, (5, 9, 8), 0, None),
            ("sta_pipe hunyuan_45f", GRID_HY_45F, (6, 9, 8), HY_TEXT, None),
            ("sta_window wan_720p_4910", GRID_720P, WAN_TILE_4910, 0,
             window_box(GRID_720P, WAN_TILE_4910)),
            ("sta_window hunyuan_45f_4910", GRID_HY_45F, WAN_TILE_4910, HY_TEXT,
             window_box(GRID_HY_45F, WAN_TILE_4910)),
            ("sta_row wan_720p_598", GRID_720P, (5, 9, 8), 0, None),
            ("sta_row hunyuan_45f_698", GRID_HY_45F, (6, 9, 8), HY_TEXT, None))}
    # sta_diag's CTA holds its chunk walk and chain 0's stash: the tool's default
    diag_smem = _build.load("sta_diag").vorta_sta_diag_sm90_smem_bytes(
        diag_walk(GRID_720P, (5, 9, 8)).shape[0])
    # sta_batched's CTA holds its slot list: 8 bytes for each of width x 8 slots
    # at HunyuanVideo (2, 9, 8) (46 kv blocks of 1,008 keys)
    batched_smem = _build.load("sta_batched").vorta_sta_batched_sm90_smem_bytes(46 * 8)
    bwd_smem = _build.load("flash_bwd").vorta_flash_bwd_sm90_smem_bytes
    for src, entry, regs, spill in hopper:
        extra = {"sta_pipe": sta_smem, "sta_window": sta_smem, "sta_row": sta_smem,
                 "sta_batched": batched_smem, "sta_diag": diag_smem}.get(src, smem)
        if src == "flash_bwd":
            extra = bwd_smem(int("flash_dkv_sm90_kernel" in entry))
        log(f"ptxas Hopper path {src} {entry}: {regs}; {spill}; dynamic shared memory "
            f"{extra} bytes")
    want = ["flash", "flash_bwd", "flash_bwd", "flash_manual", "flash_manual", "sta_batched",
            "sta_diag", "sta_diag", "sta_diag", "sta_diag", "sta_diag", "sta_pipe", "sta_row",
            "sta_window", "sta_window"]
    if sorted(src for src, *_ in hopper) != want or any(
            spill is None or "0 bytes spill stores, 0 bytes spill loads" not in spill
            for *_, spill in hopper):
        raise RuntimeError(f"the Hopper path's instantiations: {hopper} (flash's, the "
                           "backward's dq and dk/dv, flash_manual's bf16 and int8, "
                           "sta_diag's five variants, sta_pipe's, sta_window's two, sta_row's, "
                           "sta_batched's; no spills)")
    # the warp-per-row kernels: the norm's 72 (bf16 in, bf16 or f32 out; f32
    # in and out: 24 each), the prologue's 27 (bf16: one warp a row at 1-6
    # chunks a lane, two or four at 4-6; f32 the same and eight at 4-6);
    # unpool's batched copy, 24 (4, 8 or 16 stores a lane at D 128 and 64,
    # each with half as many kept-row loads or as many, in bf16 and f32): no
    # spills.  The f32 attention core's 18 (flash, sta_window, sta_row at D
    # 64 / 128; flash_manual and sta_pipe at D 64 / 128, f32 or int8 q / k;
    # sta_batched with and without pair bits), held to 128 registers so that
    # two 101 KB CTAs share an SM, and the f32 backward's 4 (dq, dk/dv at D
    # 64 / 128; one CTA an SM at D 128): spills reported.  The tensor-core
    # f32 kernels' 10 (flash's, flash_manual's, the window walks' of sta_pipe
    # and sta_window: one 193 KB CTA an SM; the
    # backward's dq with and without a partial 64-row tile, its dk/dv with and
    # without a partial tile and a partial 32-row q chunk: one 225 KB CTA an
    # SM): no spills; flash_manual's
    # int8 QK mode with an f32 v on the tensor cores (one 162 KB CTA an SM): no spills
    i8_smem = _build.load("flash_manual").vorta_flash_manual_int8_tc_smem_bytes()
    for src, entry, regs, spill in ptxas_entries(_build.ptxas_logs, "_int8_tc_kernel"):
        log(f"ptxas int8 tensor-core kernel {src} {entry}: {regs}; {spill}; dynamic shared "
            f"memory {i8_smem} bytes")
    for entry, count, spill_free in (("fused_norm_rows_kernel", 72, True),
                                     ("prologue_rows_kernel", 27, True),
                                     ("unpool_rows_kernel", 24, True),
                                     ("_f32_kernel", 22, False),
                                     ("_f32_tc_kernel", 10, True),
                                     ("_int8_tc_kernel", 1, True)):
        rows = ptxas_entries(_build.ptxas_logs, entry)
        log(f"ptxas {entry}: {len(rows)} instantiations, registers "
            f"{sorted({r.split('Used ')[1].split(' ')[0] for _, _, r, _ in rows})}")
        if not spill_free:
            for src, name, _, spill in rows:
                log(f"ptxas {entry} {src} {name[-60:]}: {spill}")
        if len(rows) != count or (spill_free and any(
                spill is None or "0 bytes spill stores, 0 bytes spill loads" not in spill
                for *_, spill in rows)):
            raise RuntimeError(f"{entry}: {rows} ({count}{'; no spills' * spill_free})")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("[smoke] FAILED: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    if not (HERE / "vorta_tpu_torch" / "csrc").is_dir():
        print("[smoke] FAILED: vorta_tpu_torch/ is not beside chip_smoke.py", file=sys.stderr)
        return 1
    sys.path.insert(0, str(HERE))
    # parity is checked in full f32 on the CPU side; keep the card's f32 off TF32 too
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.manual_seed(0)

    # ---- 1. device and build ------------------------------------------------
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    log(f"python {sys.version.split()[0]} torch {torch.__version__} cuda {torch.version.cuda}")
    log(f"card: {card} (torch sees {torch.cuda.get_device_name(0)}, "
        f"{torch.cuda.device_count()} device(s))")
    from vorta_tpu_torch.ops import _build

    build_kernels()

    import gc

    phase_s = {}

    def phase(name, fn, *args):
        t0 = time.time()
        out = fn(*args)
        gc.collect()
        torch.cuda.empty_cache()
        phase_s[name] = round(time.time() - t0, 1)
        log(f"phase {name}: {phase_s[name]} s")
        return out

    with torch.inference_mode():
        kernels = phase("kernels", lambda: check_kernels(torch, card)
                        + check_routed_kernels(torch, card))
        headmap = phase("headmap_kernels", check_headmap_kernels, torch, card)
        int8 = phase("int8_kernels", check_int8_kernels, torch, card)
        fallback = phase("fallback_kernels", check_fallback_kernels, torch, card)
        opt = phase("options_kernels", check_options_kernels, torch, card)
        phase("model_checks", lambda: (check_model(torch), check_routed_model(torch),
                                       check_routed_model(torch, int8=True),
                                       check_routed_model(torch, grid=(4, 18, 80),
                                                          tile=WAN_TILE_4910),
                                       [check_routed_model(torch, dispatch=disp)
                                        for disp in DISPATCHES],
                                       routed_reference_wan.cache_clear()))
        launches_off, per_step = phase("main_off", run_main_path, torch, card)
        launches_hard, per_step_hard = phase("main_routed", run_routed_main_path, torch, card)
        launches_disp, disp_ms = phase("wan_dispatch", run_wan_dispatch_paths, torch, card)
        launches_bench, bench_ms = phase("bench_pool", run_bench_pool, torch, card)
        launches_diag, diag_ms = phase("sta_diag", run_sta_diag_path, torch, card)
        launches_int8, per_step_int8 = phase("main_routed_int8", run_routed_main_path, torch,
                                             card, True)
        static = phase("static_scales", run_static_scales, torch, card)
        fwd_720p = phase("720p", run_720p_forward, torch, card)
        launches_4910, per_step_4910 = phase("wan_4910", run_wan_fallback_path, torch, card)
        hy_kernels = phase("hunyuan_kernels", check_hunyuan_kernels, torch, card)
        phase("hunyuan_model_check", lambda: (
            check_hunyuan_model(torch),
            check_hunyuan_model(torch, grid=(6, 18, 32), tile=HY_TILE_298,
                                modes=(("hard", False),))))
        hy_launches, hy_per_step = phase("hunyuan_main", run_hunyuan_main_path, torch, card)
        launches_298, per_step_298 = phase("hunyuan_298", run_hunyuan_fallback_path, torch,
                                           card)
        hy_ref = phase("hunyuan_117f", run_hunyuan_reference_shape, torch, card)
        q14 = phase("wan14b_int4", run_quantized_blocks, torch, card)
        imported = phase("torch_import", run_torch_import_path, torch, card)
        cache = phase("step_cache", run_step_cache_path, torch, card)
        img_attn = phase("i2v_kernel", check_image_attention, torch, card)
        phase("i2v_model_check", check_i2v_model, torch)
        i2v = phase("i2v", run_i2v_path, torch, card)
        token_rep = phase("token_replace", run_token_replace_path, torch, card)
        encoders = phase("text_encoders", run_text_encoders, torch, card)
        vae = phase("vae_decode", run_vae_decode, torch, card)
        p2v = phase("prompt_to_video", run_prompt_to_video, torch, card)
        launches_bc, compare = phase("bench_compare", run_bench_compare_path, torch, card)
        launches_cal, calib = phase("calibrate_int8", run_calibrate_path, torch, card)
        launches_fit, fit = phase("fit_cache_poly", run_fit_cache_poly_path, torch, card)
        launches_prof, prof = phase("profiling", run_profiling_path, torch, card)
        f32k = phase("f32_kernels", check_f32_kernels, torch, card)
        f32_models = phase("f32_model_checks", check_f32_models, torch)
        launches_f32, f32_serving = phase("f32_serving", run_f32_serving_path, torch, card)
        f32_profile = phase("f32_profile", run_f32_profile, torch, card)
        fwi_k = phase("f32_window_int8_kernels", check_f32_window_int8_kernels, torch, card)
        fwi_models = phase("f32_window_int8_models", check_f32_window_int8_models, torch)
        launches_fwi, fwi_serving = phase("f32_window_int8_serving",
                                          run_f32_window_int8_serving, torch, card)
    evaluation = {**launches_bc, **launches_cal, **launches_fit, **launches_prof,
                  **launches_f32, **launches_fwi}
    kernels += (int8_kernel_rows(int8) + fallback_kernel_rows(fallback)
                + options_kernel_rows(opt, diag_ms))
    for k in kernels:
        if k["name"] == "flash":  # the I2V image cross-attention: 257 keys, a kv tail
            k["shapes"]["image_cross_attention_31200x257"] = img_attn
            k["max_abs_err"] = max(k["max_abs_err"], img_attn["max_abs_err"])
        elif k["name"] == "sta_pipe":
            k["shapes"]["720p_77f_12_heads"] = opt["sta_pipe_fast"]
            k["max_abs_err"] = max(k["max_abs_err"], opt["sta_pipe_fast"]["max_abs_err"])
            k["modes"] = {"int8_qk": {"replaces": "vorta_tpu/ops/sta_pipe.py:197",
                                      "on_main_path": False, **int8["sta_pipe_int8"]},
                          **{m: mode_row(opt["sta_pipe"][m]) for m in opt["sta_pipe"]}}
        elif k["name"] in ("flash_manual", "sta_batched"):
            k["modes"] = {"stable": mode_row(opt[k["name"]])}
    for k in kernels:  # the f32 modes of the f32 serving path
        counter = {"qk_prologue": "prologue"}.get(k["name"], k["name"])
        if counter in F32_REPLACES:
            shapes = f32k[counter]
            k.setdefault("modes", {})["f32"] = {
                "replaces": F32_REPLACES[counter], "on_main_path": True,
                **mode_row(shapes), "worst_ratio": max(x["worst_ratio"] for x in shapes.values())}
    # the window-dense kernels in f32 and the int8 QK modes with an f32 v: sta_window's
    # on the (4, 9, 10) f32 path, flash_manual's on the --qk_int8 f32 path (under the int8
    # row), sta_row's and sta_pipe's on no served path (as their bf16 rows)
    rows_by_counter = {k["_counter"]: k for k in kernels}
    for kernel, (mode, replaces) in WINDOW_INT8_MODES.items():
        shapes = fwi_k[kernel]
        row, mode = ((rows_by_counter["flash_manual_int8"], "f32_v") if kernel == "flash_manual"
                     else (rows_by_counter[kernel], "int8_f32_v" if kernel == "sta_pipe"
                           else mode))
        counter = {"sta_window": "sta_window_f32", "sta_row": "sta_row_f32",
                   "flash_manual": "flash_manual_int8", "sta_pipe": "sta_pipe_int8"}[kernel]
        paths = {p: launches_fwi[p][counter] for p in launches_fwi}
        served = {"sta_window": "f32_hard_720p_29f_4910",
                  "flash_manual": "f32_hard_480p_77f_qk_int8"}.get(kernel)
        if served and not paths[served]:
            raise RuntimeError(f"{kernel}: its {mode} mode was launched on no served path")
        row.setdefault("modes", {})[mode] = {
            "replaces": replaces, "on_main_path": served is not None, **mode_row(shapes),
            "worst_ratio": max(x["worst_ratio"] for x in shapes.values()),
            "launches": paths[served] if served else 0, "launches_by_path": paths}
        if kernel == "flash_manual":  # the int8 tensor-core kernel's share
            tc_paths = {p: launches_fwi[p]["flash_manual_int8_tc"] for p in launches_fwi}
            if tc_paths[served] != paths[served]:
                raise RuntimeError(f"flash_manual f32_v: {tc_paths[served]} of {paths[served]} "
                                   "launches on the tensor cores")
            row["modes"][mode].update(tensor_core_launches=tc_paths[served],
                                      tensor_core_launches_by_path=tc_paths)
    kernels += phase("training_kernels", check_training_kernels, torch, card)
    phase("train_grads", lambda: (check_train_grads(torch),
                                  check_train_grads(torch, grid=(10, 18, 16), tile=TILE_360)))
    launches_train, train = phase("train_main", run_train_main_path, torch, card)
    launches_720h, train_720h = phase("train_720p_half", run_train_720p_half, torch, card)
    hy_grads = phase("hunyuan_train_grads", check_hunyuan_train_grads, torch)
    launches_hy_train, hy_train = phase("hunyuan_train_main", run_hunyuan_train_main_path, torch,
                                        card)
    launches_sp, sp1 = phase("sp_world_1", run_sp_world_one, torch, card)
    f32_train_k = phase("f32_training_kernels", check_f32_training_kernels, torch, card)
    f32_grads = phase("f32_train_grads", check_f32_train_grads, torch)
    launches_f32_train, f32_train = phase("f32_train_main", run_f32_train_main_path, torch, card)
    kernels.append(headmap["copy_probe"])

    def by_path(name):
        return {"off_480p_21f": launches_off[name], "hard_480p_77f": launches_hard[name],
                "hard_480p_77f_int8": launches_int8[name],
                **{f"hard_480p_77f_{d}": launches_disp[d][name] for d in launches_disp},
                "train_480p_77f": launches_train[name],
                "train_720p_half": launches_720h[name],
                **{p: hy_launches[p][name] for p in hy_launches},
                "hard_720p_77f_4910": launches_4910[name],
                "hunyuan_45f_298": launches_298[name],
                "bench_pool": launches_bench[name], "sta_diag": launches_diag[name],
                "import_wan_480p_77f": imported["wan"]["launches"][name],
                "import_wan_int8_blocks": imported["wan_int8_blocks"]["launches"][name],
                "import_hunyuan_2_2": imported["hunyuan"]["launches"][name],
                "step_cache_720p_77f": cache["launches"]["cached"][name],
                "i2v_480p_77f": i2v["launches"][name],
                "token_replace_hunyuan_45f": token_rep["launches"][name],
                "prompt_to_video_wan_480p_77f": p2v["wan"]["launches"][name],
                "prompt_to_video_hunyuan_45f": p2v["hunyuan"]["launches"][name],
                "train_hunyuan_13b": launches_hy_train["train"][name],
                "train_hunyuan_13b_resumed": launches_hy_train["train_resumed"][name],
                "sample_hunyuan_trained": launches_hy_train["sample"][name],
                **{p: launches_sp[p][name] for p in launches_sp},
                **{p: evaluation[p][name] for p in evaluation},
                **{p: launches_f32_train[p][name] for p in launches_f32_train}}

    for k in kernels:
        name = k.pop("_counter")
        paths = by_path(name)
        # the Hopper path's share of the launches (the prologue's: its
        # warp-per-row kernel's; unpool's: its batched copy's, both modes)
        sub = {"prologue": "prologue_rows", "unpool": "unpool_rows"}.get(name, f"{name}_wgmma")
        if sub in _build.launches:
            k["wgmma_launches_by_path" if sub.endswith("_wgmma") else "rows_launches_by_path"] = {
                **by_path(sub), "720p_77f_off": fwd_720p["launches_off"][sub],
                "720p_77f_routed": fwd_720p["launches_routed"][sub]}
        # the count of the path the kernel's slice brought: serving's routed
        # path (in int8 for the int8 mode), training for the kernels only
        # training launches, the STA fallbacks' two paths for theirs, the
        # pool benchmark tool for its copy probe
        k["launches"] = next((paths[p] for p in ("hard_480p_77f", "hard_480p_77f_int8",
                                                 "train_480p_77f", "hard_720p_77f_4910",
                                                 "hunyuan_45f_298", "bench_pool", "sta_diag")
                              if paths[p]), 0)
        k["launches_by_path"] = paths
        for mode, row in k.get("modes", {}).items():  # the softmax modes: no path runs them
            counter = f"{name}_{mode}"
            if counter in _build.launches and "launches_by_path" not in row:
                row["launches_by_path"] = by_path(counter)
                row["launches"] = sum(row["launches_by_path"].values())
            if f"{counter}_tc" in _build.launches:  # the f32 mode's tensor-core core
                row["tensor_core_launches_by_path"] = by_path(f"{counter}_tc")
                row["tensor_core_launches"] = sum(row["tensor_core_launches_by_path"].values())
        if name in F32_TRAIN_REPLACES:  # the f32 training path's modes (phase s)
            shapes = f32_train_k[name[6:] if name != "flash_lse" else "lse"]
            f32_paths = {p: launches_f32_train[p][name] for p in launches_f32_train}
            if not any(f32_paths.values()):
                raise RuntimeError(f"{name}: its f32 mode was launched on no f32 training path")
            k.setdefault("modes", {})["f32"] = {
                "replaces": F32_TRAIN_REPLACES[name], "on_main_path": True,
                **mode_row(shapes), "worst_ratio": max(x["worst_ratio"] for x in shapes.values()),
                "launches": f32_paths["train_f32_480p_29f"], "launches_by_path": f32_paths}
            # every f32 flash launch on the tensor cores, lse or not; the backward's on its
            # tensor-core dq and dk/dv
            tc_counter = "flash_f32_tc" if name == "flash_lse" else f"{name}_f32_tc"
            k["modes"]["f32"]["tensor_core_launches_by_path"] = {
                p: launches_f32_train[p][tc_counter] for p in launches_f32_train}
        if name in ("pool_qkv", "unpool"):  # the head-map mode: HunyuanVideo's routed path
            hm_paths = by_path(f"{name}_headmap")
            if not hm_paths["hunyuan"]:
                raise RuntimeError(f"{name}: the head-map mode was not launched on the "
                                   "HunyuanVideo routed path")
            k["modes"] = {**k.get("modes", {}), "head_map": dict(
                replaces="vorta_tpu/ops/coreset_pallas.py:" + ("418" if name == "pool_qkv"
                                                               else "545"),
                on_main_path=True, launches=hm_paths["hunyuan"], launches_by_path=hm_paths,
                **headmap[name]["hunyuan_45f_16of24"], shapes=headmap[name])}
        if name in hy_kernels:  # the Hunyuan shapes join the kernel's other shapes
            k["shapes"] = {**k.get("shapes", {}), **hy_kernels[name]}
            k["max_abs_err"] = max([k["max_abs_err"]] + [x["max_abs_err"]
                                                         for x in hy_kernels[name].values()])
        if name in ("sta_row", "fused_residual_norm", "sta_diag"):
            # sta_row: the JAX package's gates give no path of the port's sta_row;
            # fused_residual_norm: no model calls it, as in the JAX package;
            # sta_diag: a tool's kernel, launched on the sta_diag tool path
            k["on_main_path"] = False
            if name == "sta_diag" and not paths["sta_diag"]:
                raise RuntimeError("sta_diag: launched on no run of the sta_diag tool")
        elif not any(paths.values()):
            raise RuntimeError(f"{name}: launched on no main path")
    print(json.dumps({"w8a8": int8["w8a8"], "static_scales": static, "wan14b_int4": q14}))
    print(json.dumps({"serving": {
        "torch_import": {k: {m: v for m, v in imported[k].items() if m != "launches"}
                         for k in imported},
        "step_cache": {k: v for k, v in cache.items() if k != "launches"},
        "i2v_s_per_step": i2v["s_per_step"], "token_replace_s_per_step": token_rep["s_per_step"],
        "fused_norm_range_launches": token_rep["launches"]["fused_norm_range"],
        "text_encoders": encoders, "vae_decode": vae,
        "prompt_to_video": {"tokenizer": p2v["tokenizer"],
                            **{k: {m: v for m, v in p2v[k].items() if m != "launches"}
                               for k in ("wan", "hunyuan")}}}}))
    print(json.dumps({"hunyuan_training": {"gradient_check": hy_grads, **hy_train},
                      "sp_world_1": sp1}))
    print(json.dumps({"evaluation": {"bench_compare": compare, "calibrate_int8": calib,
                                     "fit_cache_poly": fit, "profiling": prof}}))
    print(json.dumps({"f32": {"model_checks_rel_l2": f32_models, "serving": f32_serving,
                              "routed_480p_77f_forward_by_op": f32_profile["f32"],
                              "routed_480p_77f_qk_int8_forward_by_op": f32_profile["f32_qk_int8"],
                              "training": {"gradient_checks": f32_grads, **f32_train,
                                           "dq_dkv_edges": f32_train_k["dq_dkv_edges"]},
                              "window_int8": {"model_checks": fwi_models,
                                              "serving": fwi_serving}}}))
    print(json.dumps({"kernels": kernels}))
    print(f"card: {card}; main path off (480p x 21f) {per_step:.3f} s per denoise step, "
          f"routed (480p x 77f) {per_step_hard:.3f} s per denoise step (4 forwards, "
          f"2 UniPC steps each); training (480p x 77f) {train['micro_s']:.3f} s per "
          f"micro-step, {train['step_s']:.3f} s per optimizer step, peak "
          f"{train['max_memory_gib']:.2f} GiB; HunyuanVideo-13B 720p x 45f off "
          f"{hy_per_step['hunyuan_off']:.3f}, routed {hy_per_step['hunyuan']:.3f} s per Euler "
          f"step (1 forward each); Wan 720p x 77f forward off {fwd_720p['off_ms']:.1f} ms, routed "
          f"(trained router, t = 500) {fwd_720p['routed_ms']:.1f} ms, off / routed "
          f"{fwd_720p['off_over_routed']:.3f}; Hunyuan 720p x 117f forward routed "
          f"{hy_ref['hard_ms']:.1f} ms, off "
          f"{hy_ref['off_ms']:.1f} ms; --qk_int8 --mm int8: Wan routed {per_step_int8:.3f} s "
          f"per denoise step, HunyuanVideo-13B off {hy_per_step['hunyuan_off_int8']:.3f}, "
          f"routed {hy_per_step['hunyuan_int8']:.3f} s per Euler step; Wan-14B int4 stack "
          f"{q14['stack_gib']:.2f} GiB, forward {q14['forward_ms']:.1f} ms, peak "
          f"{q14['peak_gib']:.2f} GiB; STA fallbacks: Wan-1.3B 720p x 77f tile (4, 9, 10) "
          f"(sta_window) {per_step_4910:.3f} s per denoise step, HunyuanVideo-13B 720p x 45f "
          f"tile (2, 9, 8) (sta_batched) {per_step_298:.3f} s per Euler step; training at "
          f"the bench router's geometry (10, 45, 80) tile (5, 9, 8) {train_720h['micro_s']:.3f} "
          f"s per micro-step, peak {train_720h['max_memory_gib']:.2f} GiB; Wan 480p x 77f "
          f"routed forward ms by dispatch {disp_ms}; bench_pool ms by stage {bench_ms}; "
          f"sta_diag ms per call by variant {diag_ms}; step cache (Wan-1.3B 720p x 77f routed, "
          f"10 UniPC steps, threshold {cache['threshold']}, {cache['cached_computed_forwards']} "
          f"of 20 forwards computed) {cache['cached_s_per_step']:.3f} s per denoise step, "
          f"uncached {cache['uncached_s_per_step']:.3f}; imported Wan-1.3B routed 480p x 77f "
          f"{imported['wan']['s_per_step']:.3f} s per denoise step, int8 blocks "
          f"{imported['wan_int8_blocks']['s_per_step']:.3f}; I2V Wan-1.3B 480p x 77f "
          f"{i2v['s_per_step']:.3f} s per denoise step; image cross-attention (1,12,31200,128) x "
          f"257 {img_attn['ms']:.4f} ms (bound {img_attn['bound_ms']:.4f}, SDPA "
          f"{img_attn['library_ms']:.4f}); token-replace HunyuanVideo-13B 720p x 45f "
          f"{token_rep['s_per_step']:.3f} s per Euler step; text encoders ms per encode "
          f"{ {k: round(v['ms'], 3) for k, v in encoders.items()} }; VAE decode s "
          f"{ {k: round(v['s'], 3) for k, v in vae.items() if 's' in v} }, peak GiB "
          f"{ {k: round(v['peak_gib'], 2) for k, v in vae.items() if 'peak_gib' in v} }; "
          f"prompt to video: Wan-1.3B 480p x 77f encode {p2v['wan']['encode_s']:.3f} s, "
          f"{p2v['wan']['s_per_step']:.3f} s per step, decode {p2v['wan']['decode_s']:.3f} s; "
          f"HunyuanVideo-13B 720p x 45f encode {p2v['hunyuan']['encode_s']:.3f} s, "
          f"{p2v['hunyuan']['s_per_step']:.3f} s per step, tiled decode "
          f"{p2v['hunyuan']['decode_s']:.3f} s; HunyuanVideo-13B training (6, 27, 48) "
          f"{hy_train['micro_s']:.3f} s per micro-step, peak {hy_train['max_memory_gib']:.2f} "
          f"GiB; SP at world size 1: Wan routed 480p x 77f {sp1['wan_sp_s_per_step']:.3f} s per "
          f"step (no group {sp1['wan_s_per_step']:.3f}), HunyuanVideo 720p x 45f "
          f"{sp1['hy_sp_s_per_step']:.3f} s per Euler step (no group "
          f"{sp1['hy_s_per_step']:.3f}), all_to_all share {sp1['wan_all_to_all_share']:.4f}; "
          f"bench_compare s per step (baseline, vorta, speedup) Wan 480p x 77f "
          f"{[compare['wan_480p_77f'][a]['s_per_step'] for a in ('baseline', 'vorta')]} "
          f"{compare['wan_480p_77f']['speedup']}, HunyuanVideo 720p x 45f "
          f"{[compare['hunyuan_45f'][a]['s_per_step'] for a in ('baseline', 'vorta')]} "
          f"{compare['hunyuan_45f']['speedup']}; profiled routed 480p x 77f forward "
          f"{prof['device_ms']:.1f} device ms; f32 (--dtype fp32) Wan-1.3B off 480p x 21f "
          f"{f32_serving['f32_off_480p_21f']['s_per_step']:.3f}, routed 480p x 77f "
          f"{f32_serving['f32_hard_480p_77f']['s_per_step']:.3f} s per UniPC step x CFG; f32 "
          f"training (480p x 29f) {f32_train['micro_s']:.3f} s per micro-step, peak "
          f"{f32_train['max_memory_gib']:.2f} GiB; f32 Wan-1.3B routed 720p x 29f at (4, 9, "
          f"10) (sta_window) {fwi_serving['f32_hard_720p_29f_4910']['s_per_step']:.3f}, "
          f"--qk_int8 480p x 77f {fwi_serving['f32_hard_480p_77f_qk_int8']['s_per_step']:.3f} "
          f"s per UniPC step x CFG; "
          f"launches off {launches_off}, routed {launches_hard}, "
          f"routed int8 {launches_int8}, training {launches_train}, hunyuan {hy_launches}, "
          f"wan (4, 9, 10) {launches_4910}, hunyuan (2, 9, 8) {launches_298}, training "
          f"720p_half {launches_720h}, wan dispatches {launches_disp}, bench_pool "
          f"{launches_bench}; "
          f"phases {phase_s}")
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


def time_ms(torch, fn, iters: int, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# Tolerance for bf16 outputs, element by element: |kernel - plain| <= TOL x
# max(|plain|, RMS(plain)).  One bf16 ulp is 2^-8 to 2^-7 of a value, so
# this allows 4 to 8 ulps at the element's own magnitude, floored at the
# output's RMS so that elements near 0 are not held to a tighter rule.  The
# two sides differ by an output rounding, and inside flash by P rounded to
# bf16 against a running max instead of the final one.
TOL = 2.0**-5


def worst_ratio(torch, got, want) -> float:
    """max |got - want| / max(|want|, RMS(want)), in f32."""
    got, want = got.float(), want.float()
    rms = want.pow(2).mean().sqrt()
    return ((got - want).abs() / torch.maximum(want.abs(), rms)).max().item()


def compare(torch, name: str, got, want) -> float:
    """max |got - want|; fails where an element is off by more than TOL."""
    torch.cuda.synchronize()
    if not torch.isfinite(got.float()).all():
        raise RuntimeError(f"{name}: non-finite kernel output")
    err = (got.float() - want.float()).abs().max().item()
    ratio = worst_ratio(torch, got, want)
    log(f"{name}: max_abs_err {err:.3e}, worst |err| / max(|plain|, RMS) {ratio:.3e} "
        f"(tolerance {TOL:g}; RMS(plain) {want.float().pow(2).mean().sqrt().item():.3e})")
    if not ratio <= TOL:
        raise RuntimeError(f"{name}: kernel disagrees with its plain version")
    return err


# The AdaLN norm's library yardstick: at B = 1 it is one F.layer_norm with
# weight 1 + scale and bias shift.  CUDA's layer_norm takes them in x's
# dtype, so they are rounded to bf16 first (outside the timed call).
NORM_LIBRARY = ("F.layer_norm(x, (dim,), 1 + scale, shift) at B = 1: the same function (its "
                "weight and bias rounded to bf16, the dtype CUDA's layer_norm takes)")


def device_ms(torch, fn, iters: int, warmup: int = 2) -> float:
    """``time_ms`` with the host's enqueue hidden: a sleep kernel queued
    first (~30 ms at the H100's clock) keeps the card busy while the host
    queues the whole run, so the events time the kernels back to back on
    the card, not the launches; for calls shorter than their wrapper's
    host time, which back-to-back launches would measure instead."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(50_000_000)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def host_us(torch, fn, n: int = 200) -> float:
    """Host microseconds per call of ``fn`` launched back to back (the card's
    queue drained after): where it reaches the kernel's time, the launches
    and not the card pace back-to-back calls."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt / n * 1e6


def norm_case(torch, name: str, x, sc, sh, iters: int) -> dict:
    """The AdaLN norm kernel on x (1, S, dim) with (1, dim) scale / shift
    against its plain version, timed on the card beside F.layer_norm
    (NORM_LIBRARY), with its GB/s and share of the bytes bound (x read, the
    output written, scale / shift read once); and both calls launched back
    to back with their host time per call."""
    import torch.nn.functional as F

    from vorta_tpu_torch.ops.fused_norm import _norm_ref, fused_norm

    dim = x.shape[-1]
    kern = lambda: fused_norm(x, sc, sh, None, None, False, 1e-6, False)  # noqa: E731
    plain = lambda: _norm_ref(x, sc, sh, None, None, rms=False, eps=1e-6,  # noqa: E731
                              out_f32=False)
    got, want = kern(), plain()
    err = compare(torch, name, got, want)
    ratio = worst_ratio(torch, got, want)
    w_lib, b_lib = (1.0 + sc[0]).to(x.dtype), sh[0].to(x.dtype)
    lib = lambda: F.layer_norm(x, (dim,), w_lib, b_lib, eps=1e-6)  # noqa: E731
    log(f"{name}: F.layer_norm (bf16 weight / bias) against the plain version: worst ratio "
        f"{worst_ratio(torch, lib(), want):.3e}")
    del got, want
    nbytes = 2 * x.numel() * x.element_size() + 2 * dim * 4
    b_ms, b_by = bound_ms(10.0 * x.numel(), nbytes, PEAK_F32)
    # the card's time of each call (device_ms), then the same calls launched
    # back to back from the host, where the wrapper's host time can pace them
    r = dict(ms=device_ms(torch, kern, iters), library_ms=device_ms(torch, lib, iters),
             plain_ms=time_ms(torch, plain, 5, 1), library=NORM_LIBRARY, bound_ms=b_ms,
             bound_by=b_by, max_abs_err=err, worst_ratio=ratio,
             back_to_back_ms=time_ms(torch, kern, iters),
             library_back_to_back_ms=time_ms(torch, lib, iters),
             host_us=host_us(torch, kern), library_host_us=host_us(torch, lib))
    r.update(gbps=nbytes / r["ms"] / 1e6, bound_share=b_ms / r["ms"],
             vs_library=r["ms"] / r["library_ms"])
    log(f"{name}: {r}")
    return r


def bf16_ulps(torch, a, b) -> float:
    """max |a - b| in bf16 ulps of the larger of the two, element by element."""
    a, b = a.float(), b.float()
    _, e = torch.frexp(torch.maximum(a.abs(), b.abs()))
    return ((a - b).abs() / torch.ldexp(torch.ones_like(a), e - 8)).max().item()


def prologue_case(torch, name: str, q, k, v, gq, gk, cos, sin, heads: int, scope: str,
                  iters: int) -> dict:
    """The qk prologue on the fused qkv product's column slices q / k / v:
    the warp-per-row kernel (its launch counted once on prologue_rows),
    against its plain version and the block-per-row kernel (v bitwise), its
    normalised values (an identity rotation: cos = 1, sin = 0) within one
    bf16 ulp of the block-per-row kernel's (only the order of the sums of
    squares differs; the rotated outputs' largest difference in ulps is
    reported: where the rotation's two products cancel, a one-ulp input
    moves more ulps of the result); the three timed in one call; GB/s and
    share of the bytes bound (q / k / v and the row's cos / sin read once,
    the three outputs written once, the gains read once), and the wrapper's
    host time per call launched back to back."""
    from vorta_tpu_torch.ops import _build
    from vorta_tpu_torch.ops.prologue import (
        _prologue_ref,
        fused_qk_prologue,
        fused_qk_prologue_block,
        prologue_layout,
    )

    s, dim = q.shape[1], q.shape[2]
    kw = dict(num_heads=heads, eps=1e-6, qk_norm=True, norm_scope=scope)
    kern = lambda: fused_qk_prologue(q, k, v, gq, gk, cos, sin, **kw)  # noqa: E731
    block = lambda: fused_qk_prologue_block(q, k, v, gq, gk, cos, sin, **kw)  # noqa: E731
    plain = lambda: _prologue_ref(q, k, v, gq, gk, cos, sin, **kw)  # noqa: E731
    if prologue_layout(dim, heads) is None:
        raise RuntimeError(f"prologue {name}: no warp-per-row layout for dim {dim}")
    for fn, rows in ((kern, 1), (block, 0)):
        _build.reset_launches()
        fn()
        torch.cuda.synchronize()
        got = (_build.launches["prologue"], _build.launches["prologue_rows"])
        if got != (1, rows):
            raise RuntimeError(f"prologue {name}: launches (prologue, prologue_rows) {got}, "
                               f"want (1, {rows})")
    got, old, want = kern(), block(), plain()
    err = max(compare(torch, f"prologue {n} {name}", a, b) for n, a, b in zip("qkv", got, want))
    compare(torch, f"prologue {name}, the block-per-row kernel", old[0], want[0])
    ulps = max(bf16_ulps(torch, a, b) for a, b in zip(got[:2], old[:2]))
    ratio = max(worst_ratio(torch, a, b) for a, b in zip(got, want))
    if not torch.equal(got[2], old[2]) or not torch.equal(got[2], want[2]):
        raise RuntimeError(f"prologue {name}: v is not moved bit for bit")
    del got, old, want
    one, zero = torch.ones_like(cos), torch.zeros_like(sin)
    normed = fused_qk_prologue(q, k, v, gq, gk, one, zero, **kw)
    normed_old = fused_qk_prologue_block(q, k, v, gq, gk, one, zero, **kw)
    ulps_norm = max(bf16_ulps(torch, a, b) for a, b in zip(normed[:2], normed_old[:2]))
    del normed, normed_old
    log(f"prologue {name}: warp-per-row against block-per-row: normalised values "
        f"{ulps_norm:g} bf16 ulps, rotated {ulps:g} (q, k); v bitwise")
    if ulps_norm > 1:
        raise RuntimeError(f"prologue {name}: the two kernels' norms differ by more than one "
                           "bf16 ulp")
    nbytes = 6 * s * dim * 2 + 2 * cos.numel() * 4 + 2 * dim * 4
    b_ms, b_by = bound_ms(20.0 * s * dim, nbytes, PEAK_F32)
    r = dict(ms=device_ms(torch, kern, iters), block_ms=device_ms(torch, block, iters),
             plain_ms=time_ms(torch, plain, 3, 1), library_ms=None, bound_ms=b_ms,
             bound_by=b_by, max_abs_err=err, worst_ratio=ratio, ulps_vs_block=ulps,
             norm_ulps_vs_block=ulps_norm,
             back_to_back_ms=time_ms(torch, kern, iters), host_us=host_us(torch, kern),
             block_host_us=host_us(torch, block))
    r.update(gbps=nbytes / r["ms"] / 1e6, bound_share=b_ms / r["ms"],
             block_bound_share=b_ms / r["block_ms"], block_over_rows=r["block_ms"] / r["ms"])
    log(f"prologue {name}: {r}")
    return r


def check_kernels(torch, card: str) -> list:
    import torch.nn.functional as F

    from vorta_tpu_torch.ops.flash import (
        dense_tables,
        sparse_flash_attention_raw,
        sparse_flash_attention_ref,
        tables_from_block_mask,
    )
    from vorta_tpu_torch.ops.rope import rope_cos_sin

    dev = torch.device("cuda")
    bf16 = torch.bfloat16
    s = GRID_480P[0] * GRID_480P[1] * GRID_480P[2]
    h, d, dim = 12, 128, 1536
    g = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=g, device=dev) * scale).to(bf16)

    # ---- flash: self-attention, padded to 10,240 with the 9,360 tail, block 1024.
    # Unit-RMS q and k with scale d^-0.5 give logits of std 1, as the model's
    # RMS-normed q/k do, so no single key dominates a row.  The padded tail
    # holds random values, not zeros: a kernel that ignored kv_valid_len
    # would give its 880 keys about 9% of each row's weight.
    sp = 10240
    q, k, v = (randn(1, h, sp, d) for _ in range(3))
    tab = dense_tables(sp // 1024, sp // 1024)
    ki, kc = tab.on(dev)
    kw = dict(scale=d**-0.5, block_q=1024, block_kv=1024, kv_valid_len=s)
    flash = lambda: sparse_flash_attention_raw(q, k, v, ki, kc, **kw)  # noqa: E731
    plain = lambda: sparse_flash_attention_ref(q, k, v, ki, kc, **kw)  # noqa: E731
    want = plain()[:, :, :s]
    err_self = compare(torch, "flash self-attention (1,12,10240,128), valid 9360",
                       flash()[:, :, :s], want)
    # the tolerance must reject what a kernel without the tail mask computes
    unmasked = sparse_flash_attention_ref(q, k, v, ki, kc, **{**kw, "kv_valid_len": None})
    miss = worst_ratio(torch, unmasked[:, :, :s], want)
    log(f"flash self-attention without the tail mask: worst ratio {miss:.3e} "
        f"(must exceed the tolerance {TOL:g})")
    if not miss > TOL:
        raise RuntimeError("flash check cannot tell a missing tail mask")
    del want, unmasked
    flops = 4.0 * s * s * d * h
    b_ms, b_by = bound_ms(flops, 4 * q.numel() * 2, PEAK_BF16)
    self_t = with_rate(dict(ms=time_ms(torch, flash, 10), plain_ms=time_ms(torch, plain, 2, 1),
                            library_ms=time_ms(torch, lambda: F.scaled_dot_product_attention(
                                q[:, :, :s], k[:, :, :s], v[:, :, :s]), 10),
                            bound_ms=b_ms, bound_by=b_by), flops)
    log(f"flash self-attention: {self_t}")
    del q, k, v

    # ---- flash at Wan 720p x 77f self-attention (1,12,72000,128), padded to
    # 71 x 1024: the largest flash call of the main path (one per block of a
    # 720p forward), against the plain version on head 0 (the plain version
    # on all twelve would hold 3.6 GB of scores per q block), SDPA on all
    s7 = GRID_720P[0] * GRID_720P[1] * GRID_720P[2]
    p7 = -(-s7 // 1024) * 1024
    q7, k7, v7 = (randn(1, h, p7, d) for _ in range(3))
    i7, c7 = dense_tables(p7 // 1024, p7 // 1024).on(dev)
    kw7 = dict(scale=d**-0.5, block_q=1024, block_kv=1024, kv_valid_len=s7)
    flash7 = lambda: sparse_flash_attention_raw(q7, k7, v7, i7, c7, **kw7)  # noqa: E731
    plain7 = lambda: sparse_flash_attention_ref(q7[:, :1], k7[:, :1], v7[:, :1],  # noqa: E731
                                                i7, c7, **kw7)
    want7, plain7_ms = timed_once(torch, plain7)
    err_720 = compare(torch, f"flash self-attention 720p, head 0 of (1,12,{p7},128), valid {s7}",
                      flash7()[:, :1, :s7], want7[:, :, :s7])
    del want7
    flops7 = 4.0 * s7 * s7 * d * h
    b7_ms, b7_by = bound_ms(flops7, 4 * h * s7 * d * 2, PEAK_BF16)
    t720 = with_rate(dict(ms=time_ms(torch, flash7, 3, 1), plain_ms=None,
                          plain_ms_one_head=plain7_ms,
                          library_ms=time_ms(torch, lambda: F.scaled_dot_product_attention(
                              q7[:, :, :s7], k7[:, :, :s7], v7[:, :, :s7]), 3, 1),
                          bound_ms=b7_ms, bound_by=b7_by, max_abs_err=err_720), flops7)
    log(f"flash self-attention 720p: {t720}")
    del q7, k7, v7

    # ---- flash: cross-attention to 512 text tokens, q padded to 5 x 2048
    qc = randn(1, h, sp, d)
    kcx, vcx = randn(1, h, TEXT_LEN, d), randn(1, h, TEXT_LEN, d)
    ti, tc = dense_tables(sp // 2048, 1).on(dev)
    kw_c = dict(scale=d**-0.5, block_q=2048, block_kv=512)
    err_cross = compare(torch, "flash cross-attention (1,12,10240,128) x 512",
                        sparse_flash_attention_raw(qc, kcx, vcx, ti, tc, **kw_c)[:, :, :s],
                        sparse_flash_attention_ref(qc, kcx, vcx, ti, tc, **kw_c)[:, :, :s])
    flops_c = 4.0 * s * TEXT_LEN * d * h
    bc_ms, bc_by = bound_ms(flops_c, (2 * qc.numel() + 2 * kcx.numel()) * 2, PEAK_BF16)
    cross_t = with_rate(dict(
        ms=time_ms(torch, lambda: sparse_flash_attention_raw(qc, kcx, vcx, ti, tc, **kw_c), 20),
        plain_ms=time_ms(torch, lambda: sparse_flash_attention_ref(qc, kcx, vcx, ti, tc,
                                                                   **kw_c), 3, 1),
        library_ms=time_ms(torch, lambda: F.scaled_dot_product_attention(
            qc[:, :, :s], kcx, vcx), 20),
        bound_ms=bc_ms, bound_by=bc_by), flops_c)
    log(f"flash cross-attention: {cross_t}")

    # ---- flash: small per-head tables with zero counts and a tail
    import numpy as np

    rng = np.random.default_rng(0)
    mask = rng.random((h, 8, 8)) < 0.4
    mask[:, 0, :] = False
    ptab = tables_from_block_mask(mask)
    qs, ks, vs = (randn(1, h, 2048, d) for _ in range(3))
    pi, pc = ptab.on(dev)
    kw_s = dict(scale=d**-0.5, block_q=256, block_kv=256, kv_valid_len=2000)
    err_sparse = compare(torch, "flash per-head tables (1,12,2048,128), zero counts",
                         sparse_flash_attention_raw(qs, ks, vs, pi, pc, **kw_s),
                         sparse_flash_attention_ref(qs, ks, vs, pi, pc, **kw_s))

    # ---- prologue on the fused qkv product's column slices: Wan-1.3B at 9,360
    # tokens and at 720p x 77f (72,000), Wan-14B's width (5,120, 40 heads) at 720p
    pros = {}
    for key, grid, width, heads in (("wan_480p_21f_9360", GRID_480P, dim, h),
                                    ("wan_720p_77f_72000", GRID_720P, dim, h),
                                    ("wan14b_720p_77f_72000", GRID_720P, 5120, 40)):
        rows = grid[0] * grid[1] * grid[2]
        qkv = randn(1, rows, 3 * width, scale=3.0)
        gq, gk = (1.0 + 0.1 * torch.randn(width, generator=g, device=dev) for _ in range(2))
        cos, sin = (torch.from_numpy(a).to(dev) for a in rope_cos_sin(grid, d))
        pros[key] = prologue_case(torch, f"(1,{rows},{width})", *qkv.split(width, dim=-1), gq,
                                  gk, cos, sin, heads, "row", 50 if rows < 20000 else 10)
        del qkv
        torch.cuda.empty_cache()
    pro_t = pros["wan_480p_21f_9360"]

    # ---- AdaLN norm with (1, 1536) scale / shift, as AdaLN passes them (column
    # slices of the (1, 6, 1536) modulation): (1, 9360, 1536), and the routed
    # path's (1, 31200, 1536), whose 192 MB of traffic exceed the 50 MB L2
    norms = {}
    for name, rows in (("wan_480p_21f_9360", s), ("wan_480p_77f_31200", 31200)):
        mod = torch.randn((1, 6, dim), generator=g, device=dev) * 0.3
        norms[name] = norm_case(torch, f"AdaLN norm (1,{rows},{dim})",
                                randn(1, rows, dim, scale=3.0), mod[:, 1], mod[:, 0], 50)
    norm_t = norms["wan_480p_21f_9360"]

    return [
        dict(name="flash", route="cuda", source="vorta_tpu_torch/csrc/flash.cu",
             replaces="vorta_tpu/ops/flash.py:128", _counter="flash",
             max_abs_err=max(err_self, err_cross, err_sparse, err_720), **self_t,
             shapes={"self_attention_9360": self_t, "cross_attention_9360x512": cross_t,
                     "self_attention_720p_72000": t720}),
        dict(name="fused_norm", route="cuda", source="vorta_tpu_torch/csrc/fused_norm.cu",
             replaces="vorta_tpu/ops/fused_norm.py:44", _counter="fused_norm",
             **{**norm_t, "max_abs_err": max(x["max_abs_err"] for x in norms.values())},
             shapes=norms),
        dict(name="qk_prologue", route="cuda", source="vorta_tpu_torch/csrc/prologue.cu",
             replaces="vorta_tpu/ops/prologue.py:67", _counter="prologue",
             **{**pro_t, "max_abs_err": max(x["max_abs_err"] for x in pros.values())},
             shapes=pros),
    ]

# Heads routed to the expert under test in the kernel checks: 8 of 12, the
# others routed away (zero counts / inactive), as the masked dispatch runs.
ACTIVE_HEADS = (1, 0, 1, 1, 0, 1, 1, 1, 0, 1, 1, 0)
# Pool picks: the kernel's f32 similarity sums run in another order than the
# plain version's, so an arg-min between two margins closer than this may
# flip; every disagreement must sit at such a near-tie.
PICK_EPS = 1e-5


def check_routed_kernels(torch, card: str) -> list:
    """The routed experts' kernels at Wan-1.3B 480p x 77f (31,200 tokens,
    12 heads x 128, bf16), against their plain versions."""
    import numpy as np
    import torch.nn.functional as F

    from vorta_tpu_torch.cli.sample import attention_config
    from vorta_tpu_torch.ops.coreset_pallas import pick_gaps, pool_qkv, pool_qkv_ref
    from vorta_tpu_torch.ops.experts import lowres_groups_for
    from vorta_tpu_torch.ops.flash_manual import (
        sparse_flash_attention_manual,
        sparse_flash_attention_manual_ref,
    )
    from vorta_tpu_torch.ops.routed_fused import routed_geometry
    from vorta_tpu_torch.ops.sta_pipe import (
        sta_pipe_attention,
        sta_pipe_attention_mma_sync,
        sta_pipe_attention_ref,
    )

    dev = torch.device("cuda")
    bf16 = torch.bfloat16
    h, d = 12, 128
    scale = d**-0.5
    cfg = attention_config("wan-1_3B", GRID_480P_77F)
    s = cfg.seq_len
    geo = routed_geometry(cfg)
    groups = lowres_groups_for(cfg)
    act = torch.tensor(ACTIVE_HEADS, device=dev)
    n_act = int(act.sum().item())
    g = torch.Generator(device=dev).manual_seed(5)

    def randn(*shape):  # unit RMS: the scale of qk-normed q/k
        return torch.randn(shape, generator=g, device=dev).to(bf16)

    out = []

    # ---- flash_manual: FULL (1,12,31744,128), tables (1,31,31), per-head counts,
    # and LOWRES (1,12,16384,128), tables (1,16,16).  The padded tails hold
    # random values: a kernel that ignored kv_valid_len would attend to them.
    fm = {}
    for name, call in (("full", geo.full), ("lowres", geo.lowres)):
        q, k, v = (randn(1, h, call.q_pad, d) for _ in range(3))
        ki, kc = call.tables.on(dev)
        cnt = torch.where(act[:, None] > 0, kc, 0).to(torch.int32)
        kw = dict(scale=scale, block_q=call.block_q, block_kv=call.block_kv,
                  kv_valid_len=call.valid_len, softmax="fast")
        kern = lambda: sparse_flash_attention_manual(q, k, v, ki, cnt, **kw)  # noqa: E731
        plain = lambda: sparse_flash_attention_manual_ref(q, k, v, ki, cnt, **kw)  # noqa: E731
        n = call.valid_len
        got, want = kern()[:, :, :n], plain()[:, :, :n]
        err = compare(torch, f"flash_manual {name} (1,12,{call.q_pad},128), valid {n}, "
                      f"{n_act} of 12 heads routed", got, want)
        if got[:, act == 0].any():
            raise RuntimeError(f"flash_manual {name}: a head routed away wrote non-zeros")
        unmasked = sparse_flash_attention_manual_ref(q, k, v, ki, cnt, **{**kw, "kv_valid_len": None})
        miss = worst_ratio(torch, unmasked[:, :, :n][:, act > 0], want[:, act > 0])
        log(f"flash_manual {name} without the tail mask: worst ratio {miss:.3e} "
            f"(must exceed the tolerance {TOL:g})")
        if not miss > TOL:
            raise RuntimeError(f"flash_manual {name} check cannot tell a missing tail mask")
        del got, want, unmasked
        flops = 4.0 * n * n * d * n_act
        b_ms, b_by = bound_ms(flops, 4 * n * d * 2 * n_act, PEAK_BF16)
        qa, ka, va = (x[:, act > 0, :n] for x in (q, k, v))
        fm[name] = with_rate(dict(ms=time_ms(torch, kern, 10),
                                  plain_ms=time_ms(torch, plain, 2, 1),
                                  library_ms=time_ms(torch, lambda: F.scaled_dot_product_attention(
                                      qa, ka, va), 10), bound_ms=b_ms, bound_by=b_by,
                                  max_abs_err=err), flops)
        log(f"flash_manual {name}: {fm[name]} ({n_act} heads)")
        del q, k, v, qa, ka, va
    out.append(dict(name="flash_manual", route="cuda",
                    source="vorta_tpu_torch/csrc/flash_manual.cu",
                    replaces="vorta_tpu/ops/flash_manual.py:31", _counter="flash_manual",
                    **{**fm["full"], "max_abs_err": max(fm["full"]["max_abs_err"],
                                                        fm["lowres"]["max_abs_err"])},
                    shapes={"full_31200": fm["full"], "lowres_15600": fm["lowres"]}))

    # ---- sta_pipe at the 480p tile (4,6,4) and the 720p tile (5,9,8)
    st = {}
    for name, grid, tile in (("480p_77f", GRID_480P_77F, (4, 6, 4)),
                             ("720p_77f", GRID_720P, (5, 9, 8))):
        n = grid[0] * grid[1] * grid[2]
        q, k, v = (randn(1, h, n, d) for _ in range(3))
        kw = dict(latent_shape=grid, tile=tile, window=(3, 3, 3), scale=scale)
        kern = lambda: sta_pipe_attention(q, k, v, act, **kw)  # noqa: E731
        mma = lambda: sta_pipe_attention_mma_sync(q, k, v, act, **kw)  # noqa: E731
        plain = lambda: sta_pipe_attention_ref(q, k, v, act, **kw)  # noqa: E731
        sta_path_once(torch, f"sta_pipe {name}", kern, True)
        got, want = kern(), plain()
        err = compare(torch, f"sta_pipe {name} (1,12,{n},128), tile {tile}, {n_act} of 12 "
                      "heads active", got, want)
        if got[:, act == 0].any():
            raise RuntimeError(f"sta_pipe {name}: an inactive head wrote non-zeros")
        compare(torch, f"sta_pipe {name} on the mma.sync kernel", mma(), want)
        del got, want
        keys = int(np.prod([min(3, grid[a] // tile[a]) * tile[a] for a in range(3)]))
        flops = 4.0 * n * keys * d * n_act
        b_ms, b_by = bound_ms(flops, 4 * n * d * 2 * n_act, PEAK_BF16)
        # SDPA with the boolean STA mask (S^2 bytes: 0.97 GB at 480p, 5.2 GB at
        # 720p), on the active heads; where the card refuses it, its error
        mask = sta_raster_mask(torch, grid, tile, dev)
        lib, lib_err = masked_sdpa_ms(torch, f"sta_pipe {name}",
                                      *(x[:, act > 0] for x in (q, k, v)), mask)
        del mask
        torch.cuda.empty_cache()
        st[name] = sta_rates(dict(ms=time_ms(torch, kern, 10),
                                  mma_sync_ms=time_ms(torch, mma, 10),
                                  plain_ms=time_ms(torch, plain, 2, 1), library_ms=lib,
                                  bound_ms=b_ms, bound_by=b_by, max_abs_err=err), flops)
        if lib_err:
            st[name]["library_error"] = lib_err
        log(f"sta_pipe {name}: {keys} keys per query; {st[name]} ({n_act} heads)")
        del q, k, v
    out.append(dict(name="sta_pipe", route="cuda", source="vorta_tpu_torch/csrc/sta_pipe.cu",
                    replaces="vorta_tpu/ops/sta_pipe.py:121", _counter="sta_pipe",
                    **{**st["480p_77f"], "max_abs_err": max(x["max_abs_err"] for x in st.values())},
                    shapes=st))

    # ---- pool_qkv / unpool: (1,12,31200,128) -> 3 x (1,12,15600,128) + picks
    q, k, v = (randn(1, h, s, d) for _ in range(3))
    pool = lambda: pool_qkv(q, k, v, groups, active=act, return_picks=True)  # noqa: E731
    pool_plain = lambda: pool_qkv_ref(q, k, v, groups, active=act)  # noqa: E731
    got, want = pool(), pool_plain()
    torch.cuda.synchronize()
    gaps = pick_gaps(got[3], want[3], q, groups)
    n_picks = n_act * groups.num_groups * groups.num_kept_margins
    log(f"pool_qkv picks: {gaps.numel()} of {n_picks} disagree with the plain version's, "
        f"largest |dsim| {gaps.max().item() if gaps.numel() else 0.0:.3e} "
        f"(each must be a near-tie, < {PICK_EPS:g})")
    if gaps.numel() and not gaps.max().item() < PICK_EPS:
        raise RuntimeError("pool_qkv: a pick disagrees away from a near-tie")
    # selection only: bitwise equal wherever the picks agree
    sh = (1, h, groups.num_groups, groups.num_kept_margins)
    agree = (got[3].reshape(sh) == want[3].reshape(sh)).all(-1)  # (1, H, G)
    for name, a, w in zip("qkv", got[:3], want[:3]):
        gsz = groups.num_groups
        kept_a = a[:, :, gsz:].reshape(*sh, d)[agree]
        kept_w = w[:, :, gsz:].reshape(*sh, d)[agree]
        if not (torch.equal(a[:, :, :gsz], w[:, :, :gsz]) and torch.equal(kept_a, kept_w)):
            raise RuntimeError(f"pool_qkv {name}: pooled rows differ where the picks agree")
    # the same kernel on bf16 q against the plain version on the unrounded
    # f32 q: the pick flip rate between a bf16 forward and an f32 one
    q32 = torch.randn((1, h, s, d), generator=g, device=dev)
    q16 = q32.to(bf16)
    flip = pick_gaps(pool_qkv(q16, q16, q16, groups, return_picks=True)[3],
                     pool_qkv_ref(q32, q32, q32, groups)[3], q32, groups).numel()
    log(f"pool_qkv picks from bf16 q vs from f32 q: {flip} of "
        f"{h * groups.num_groups * groups.num_kept_margins} differ")
    del q32, q16
    # reads all of q (the matching) but only the center and kept rows of k
    # and v; writes every head's pooled rows (zeros where inactive) and picks
    p_bytes = (n_act * (s + 2 * groups.pooled_length) * d * 2
               + h * (3 * groups.pooled_length * d * 2 + sh[2] * sh[3] * 4))
    bp_ms, bp_by = bound_ms(0.0, p_bytes, PEAK_BF16)
    pool_t = dict(ms=time_ms(torch, pool, 20), plain_ms=time_ms(torch, pool_plain, 3, 1),
                  library_ms=None, bound_ms=bp_ms, bound_by=bp_by, max_abs_err=0.0,
                  pick_disagreements=gaps.numel(), picks=n_picks, bf16_vs_f32_pick_flips=flip)
    log(f"pool_qkv: {pool_t}")
    picks = got[3]
    out_p = randn(1, h, groups.pooled_length, d)
    # reads the pooled rows and picks of the active heads, writes every head
    u_bytes = n_act * (groups.pooled_length * d * 2 + sh[2] * sh[3] * 4) + h * s * d * 2
    unpool_t = unpool_case(torch, "(1,12,15600,128) -> (1,12,31200,128), active mode", out_p,
                           q, groups, picks, [i for i in range(h) if ACTIVE_HEADS[i]], u_bytes,
                           active=act)
    out.append(dict(name="pool_qkv", route="cuda", source="vorta_tpu_torch/csrc/coreset_pool.cu",
                    replaces="vorta_tpu/ops/coreset_pallas.py:102", _counter="pool_qkv",
                    **pool_t))
    out.append(dict(name="unpool", route="cuda", source="vorta_tpu_torch/csrc/coreset_pool.cu",
                    replaces="vorta_tpu/ops/coreset_pallas.py:181", _counter="unpool",
                    **unpool_t))
    return out


def unpool_case(torch, name: str, out_p, q, groups, picks, heads, u_bytes: float,
                **kw) -> dict:
    """unpool's batched 16-byte copy against its plain version and the first
    design's kernel (``unpool_per_group``), bit for bit on the written heads
    ``heads`` (active mode: the active ones, whose rows the yardstick
    computes too; the inactive heads' zeros against the plain version;
    head-map mode: the mapped ones), counted once on ``unpool_rows``; then
    the two kernels, the plain version and the library yardstick timed in
    one call with the host's enqueue hidden (a call's host time is of the
    order of the kernel's).  The yardstick is one ``torch.gather(pooled, 2,
    idx)`` over the written heads, idx each token's source row (its kept
    row, else its group's centre) as a (B, n, S, D) int64 view expanded over
    D, built outside the timed window: the same values on those heads."""
    from vorta_tpu_torch.ops import _build
    from vorta_tpu_torch.ops.coreset_pallas import unpool, unpool_per_group, unpool_ref

    unp = lambda: unpool(out_p, q, groups, picks=picks, **kw)  # noqa: E731
    old = lambda: unpool_per_group(out_p, q, groups, picks=picks, **kw)  # noqa: E731
    plain = lambda: unpool_ref(out_p, q, groups, picks=picks, **kw)  # noqa: E731
    _build.reset_launches()
    got = unp()
    torch.cuda.synchronize()
    if _build.launches["unpool_rows"] != 1:
        raise RuntimeError(f"unpool {name}: not on the batched 16-byte copy ({_build.launches})")
    want = plain()
    hs = torch.tensor(heads, device=out_p.device)
    if not (torch.equal(got[:, hs], want[:, hs]) and torch.equal(got[:, hs], old()[:, hs])):
        raise RuntimeError(f"unpool {name}: the rows kernel differs from the plain version or "
                           "the first design's kernel on the written heads (pure selection)")
    if "active" in kw and not torch.equal(got, want):
        raise RuntimeError(f"unpool {name}: the inactive heads' zeros differ")
    b, _, p, d = out_p.shape
    rows = torch.arange(p, device=out_p.device, dtype=torch.float32).reshape(1, 1, p, 1)
    idx = unpool_ref(rows.expand(b, len(heads), p, 1).contiguous(), q[:, hs], groups,
                     picks=picks[:, hs]).long().expand(-1, -1, -1, d)
    src = out_p[:, hs].contiguous()
    lib = lambda: torch.gather(src, 2, idx)  # noqa: E731
    if not torch.equal(lib(), got[:, hs]):
        raise RuntimeError(f"unpool {name}: the torch.gather yardstick computes another function")
    del got, want
    b_ms, b_by = bound_ms(0.0, u_bytes, PEAK_BF16)
    r = dict(ms=device_ms(torch, unp, 20), per_group_ms=device_ms(torch, old, 20),
             ms_again=device_ms(torch, unp, 20), plain_ms=time_ms(torch, plain, 2, 1),
             library_ms=device_ms(torch, lib, 20), bound_ms=b_ms, bound_by=b_by,
             max_abs_err=0.0, heads=len(heads),
             library_covers="torch.gather(pooled, 2, idx) over the written heads")
    r["bound_share"] = b_ms / r["ms"]
    r["per_group_bound_share"] = b_ms / r["per_group_ms"]
    log(f"unpool {name}: bitwise (plain version, first design); {r} "
        f"({u_bytes / r['ms'] / 1e6:.1f} GB/s)")
    return r


def headmap_case(torch, name: str, q, k, v, groups, routed, kv_from_k: bool) -> dict:
    """pool_qkv and unpool in head-map mode over the heads ``routed`` (a
    (H,) 0/1 tuple) against their plain versions, compared on the routed
    heads only (the other heads' rows are uninitialized by contract), and
    timed beside the active mode on the same heads."""
    import numpy as np

    from vorta_tpu_torch.ops.coreset import group_view, slot_similarity
    from vorta_tpu_torch.ops.coreset_pallas import (
        head_map_for,
        pick_gaps,
        pool_qkv,
        pool_qkv_ref,
        unpool,
    )

    dev = q.device
    b, h, s, d = q.shape
    on = torch.tensor(routed, device=dev) > 0
    hm, n = head_map_for(on)
    act = on.to(torch.int32)
    kw = dict(head_map=hm, num_active=n)
    pool = lambda: pool_qkv(q, k, v, groups, kv_matching_from_k=kv_from_k,  # noqa: E731
                            return_picks=True, **kw)
    pool_act = lambda: pool_qkv(q, k, v, groups, kv_matching_from_k=kv_from_k,  # noqa: E731
                                return_picks=True, active=act)
    pool_plain = lambda: pool_qkv_ref(q, k, v, groups, kv_matching_from_k=kv_from_k,  # noqa: E731
                                      **kw)
    got, want = pool(), pool_plain()
    torch.cuda.synchronize()
    gaps = pick_gaps(got[3][:, on], want[3][:, on], q[:, on], groups)
    sh = (b, n, groups.num_groups, groups.num_kept_margins)
    log(f"pool_qkv head-map {name}: {n} of {h} heads routed; Q picks: {gaps.numel()} of "
        f"{int(np.prod(sh))} disagree with the plain version's, largest |dsim| "
        f"{gaps.max().item() if gaps.numel() else 0.0:.3e} (each must be a near-tie, < "
        f"{PICK_EPS:g})")
    if gaps.numel() and not gaps.max().item() < PICK_EPS:
        raise RuntimeError(f"pool_qkv head-map {name}: a pick disagrees away from a near-tie")
    q_agree = (got[3][:, on].reshape(sh) == want[3][:, on].reshape(sh)).all(-1)
    if kv_from_k:  # K and V follow K's matching: compare where its ranking has no near-tie
        k_sim = slot_similarity(group_view(k[:, on], groups), groups._geom.center_slot)
        kv_agree = k_sim.sort(dim=-1).values[..., :-1].diff(dim=-1).min(dim=-1).values > PICK_EPS
    else:
        kv_agree = q_agree
    gsz = groups.num_groups
    for x, a, w, agree in zip("qkv", got[:3], want[:3], (q_agree, kv_agree, kv_agree)):
        a, w = a[:, on], w[:, on]
        kept_a = a[:, :, gsz:].reshape(*sh, d)[agree]
        kept_w = w[:, :, gsz:].reshape(*sh, d)[agree]
        if not (torch.equal(a[:, :, :gsz], w[:, :, :gsz]) and torch.equal(kept_a, kept_w)):
            raise RuntimeError(f"pool_qkv head-map {name} {x}: routed heads' rows differ")
    # and against the active mode on the same heads: the same kernel body
    ref_act = pool_act()
    if not all(torch.equal(a[:, on], r[:, on]) for a, r in zip(got, ref_act)):
        raise RuntimeError(f"pool_qkv head-map {name}: routed heads differ from the active mode")
    del want, ref_act
    p = groups.pooled_length
    picks_b = int(np.prod(sh)) * 4
    # head-map mode reads and writes the routed heads only: all of q (and of k
    # with K's matching), the kept rows of k and v otherwise; 3 pooled outputs
    reads = n * ((1 + kv_from_k) * s + (2 - kv_from_k) * p) * d * 2
    p_bytes = reads + n * 3 * p * d * 2 + picks_b
    bp_ms, bp_by = bound_ms(0.0, p_bytes, PEAK_BF16)
    pool_r = dict(ms=time_ms(torch, pool, 20), active_ms=time_ms(torch, pool_act, 20),
                  plain_ms=time_ms(torch, pool_plain, 2, 1), library_ms=None, bound_ms=bp_ms,
                  bound_by=bp_by, max_abs_err=0.0, heads=n, pick_disagreements=gaps.numel())
    log(f"pool_qkv head-map {name}: {pool_r}")
    picks = got[3]
    out_p = torch.randn((b, h, p, d), device=dev).to(q.dtype)
    unp_act = lambda: unpool(out_p, q, groups, picks=picks, active=act)  # noqa: E731
    if not torch.equal(unpool(out_p, q, groups, picks=picks, **kw)[:, on], unp_act()[:, on]):
        raise RuntimeError(f"unpool head-map {name}: routed heads differ from the active mode")
    u_bytes = n * (p * d * 2 + s * d * 2) + picks_b
    unpool_r = unpool_case(torch, f"head-map {name}", out_p, q, groups, picks,
                           torch.nonzero(on).flatten().tolist(), u_bytes, **kw)
    unpool_r["active_ms"] = device_ms(torch, unp_act, 20)
    return {"pool_qkv": pool_r, "unpool": unpool_r}


def check_headmap_kernels(torch, card: str) -> dict:
    """The pool's head-map mode at HunyuanVideo 720p x 45f (1,24,43200,128)
    with K's own matching, 16 of 24 heads routed, and at Wan 720p x 77f
    (1,12,72000,128), 5 and 12 of 12 routed; and the copy probe of
    tools/bench_pool.py at Wan 720p against its plain version, bitwise,
    beside pool_qkv and its bytes bound."""
    from vorta_tpu_torch.cli.sample import attention_config
    from vorta_tpu_torch.ops.coreset_pallas import pool_qkv
    from vorta_tpu_torch.ops.experts import lowres_groups_for
    from vorta_tpu_torch.ops.layout import tile_sequence
    from vorta_tpu_torch.tools.bench_pool import copy_probe, copy_probe_ref

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(60)

    def randn(*shape):
        return torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)

    out = {"pool_qkv": {}, "unpool": {}}
    hy_groups = lowres_groups_for(attention_config("hunyuan-13B", GRID_HY_45F))
    q, k, v = (randn(1, 24, hy_groups.full_length, 128) for _ in range(3))
    for kern, r in headmap_case(torch, "hunyuan_45f_16of24", q, k, v, hy_groups, HY_ACTIVE,
                                True).items():
        out[kern]["hunyuan_45f_16of24"] = r
    del q, k, v
    torch.cuda.empty_cache()
    groups = lowres_groups_for(attention_config("wan-1_3B", GRID_720P))
    q, k, v = (randn(1, 12, groups.full_length, 128) for _ in range(3))
    for n in (5, 12):
        name = f"wan_720p_{n}of12"
        for kern, r in headmap_case(torch, name, q, k, v, groups,
                                    tuple(int(i < n) for i in range(12)), False).items():
            out[kern][name] = r

    # copy_probe: slot 0 as center, slots 0..U-1 as margins, no matching
    probe = lambda: copy_probe(q, k, v, groups)  # noqa: E731
    plain = lambda: copy_probe_ref(q, k, v, groups)  # noqa: E731
    if not all(torch.equal(a, w) for a, w in zip(probe(), plain())):
        raise RuntimeError("copy_probe: kernel and plain version differ (pure selection)")
    u, gn = groups.num_kept_margins, groups.num_groups
    # reads slots 0..U-1 of each group (slot 0 serves both), writes 1 + U rows, x 3 tensors
    c_bytes = 3 * 12 * gn * (u + 1 + u) * 128 * 2
    bc_ms, bc_by = bound_ms(0.0, c_bytes, PEAK_BF16)
    # one gather per tensor: torch.index_select of the probe's token indices
    tok = torch.arange(groups.full_length, device=dev).reshape(1, 1, -1, 1).float()
    slots = tile_sequence(tok, groups._geom.latent_shape, groups._geom.window).reshape(
        gn, groups.group_size).long()
    idx = torch.cat([slots[:, 0], slots[:, :u].reshape(-1)])
    lib = time_ms(torch, lambda: [torch.index_select(x, 2, idx) for x in (q, k, v)], 20)
    if not torch.equal(torch.index_select(q, 2, idx), probe()[0]):
        raise RuntimeError("copy_probe: index_select yardstick computes another function")
    pool_ms = time_ms(torch, lambda: pool_qkv(q, k, v, groups, return_picks=True), 20)
    cp = dict(ms=time_ms(torch, probe, 20), plain_ms=time_ms(torch, plain, 3, 1),
              library_ms=lib, bound_ms=bc_ms, bound_by=bc_by, max_abs_err=0.0,
              pool_qkv_ms=pool_ms,
              library_covers="torch.index_select, one call per tensor (q, k, v)")
    log(f"copy_probe (1,12,72000,128) -> 3 x (1,12,{groups.pooled_length},128): bitwise; {cp} "
        f"(pool_qkv, every head, with the matching: {pool_ms:.3f} ms)")
    del q, k, v
    out["copy_probe"] = dict(name="copy_probe", route="cuda",
                             source="vorta_tpu_torch/csrc/coreset_pool.cu",
                             replaces="tools/bench_pool.py:50", _counter="copy_probe", **cp)
    return out


def sta_raster_mask(torch, grid, tile, dev, window=(3, 3, 3)):
    """(S, S) bool: which raster tokens each raster token sees under STA."""
    import numpy as np

    from vorta_tpu_torch.geometry import inverse_permutation, sta_tile_mask, tile_permutation

    tpt = int(np.prod(tile))  # tile index of each raster token
    tile_of = torch.from_numpy(inverse_permutation(tile_permutation(grid, tile)) // tpt)
    tile_of = tile_of.to(dev).long()
    tmask = torch.from_numpy(sta_tile_mask(grid, window, tile)).to(dev)
    return tmask[tile_of][:, tile_of]  # one index dim at a time


def check_model(torch) -> None:
    """2 blocks at Wan-1.3B widths: card (bf16, kernels) vs CPU (f32, plain)."""
    import dataclasses

    from vorta_tpu_torch.config import WAN_1_3B, AttentionConfig
    from vorta_tpu_torch.models.wan import WanModel

    cfg = dataclasses.replace(WAN_1_3B, num_layers=2)
    grid = (2, 8, 10)  # 160 tokens: padded to one 1024 block with a tail
    attn = AttentionConfig(latent_shape=grid)
    ref_model = WanModel(cfg, dtype=torch.float32, device="cpu", seed=3)
    gpu_model = WanModel(cfg, dtype=torch.bfloat16, device="cuda", seed=3)
    gpu_model.load_state_dict(ref_model.state_dict())
    g = torch.Generator().manual_seed(4)
    lat = torch.randn((1, grid[0], 2 * grid[1], 2 * grid[2], 16), generator=g)
    ctx = torch.randn((1, TEXT_LEN, cfg.text_dim), generator=g)
    t = torch.tensor([800.0])
    want = ref_model(lat, t, ctx, attn_cfg=attn).sample
    got = gpu_model(lat.cuda(), t.cuda(), ctx.cuda(), attn_cfg=attn).sample.float().cpu()
    if not torch.isfinite(got).all():
        raise RuntimeError("model check: non-finite output on the card")
    rel = ((got - want).norm() / want.norm()).item()
    # bf16 activations against f32 through 2 blocks: a few percent at most
    log(f"model check (2 blocks, 1.3B widths, 160 tokens): rel L2 err card bf16 vs "
        f"CPU f32 = {rel:.4f} (tolerance 0.05)")
    if not rel < 0.05:
        raise RuntimeError("model check: the card's forward disagrees with the CPU's")


ROUTED_EXPERTS = (0, 1, 2) * 4  # the routed model checks' heads per expert: 4 each


@functools.lru_cache(maxsize=1)
def routed_reference_wan(torch):
    """check_routed_model's CPU reference: 2 blocks at Wan-1.3B widths in f32
    from seed 5, every router's weights 0 and its biases one-hot logits
    (ROUTED_EXPERTS), built once for phase 6's six checks, which only read
    it (the CPU's random init is the slow part of each check)."""
    import dataclasses

    from vorta_tpu_torch.config import WAN_1_3B
    from vorta_tpu_torch.models.wan import WanModel

    ref_model = WanModel(dataclasses.replace(WAN_1_3B, num_layers=2), dtype=torch.float32,
                         device="cpu", seed=5)
    with torch.no_grad():
        for block in ref_model.blocks:
            block.router.linear.weight.zero_()
            block.router.linear.bias.copy_(
                4.0 * torch.eye(3)[torch.tensor(ROUTED_EXPERTS)].reshape(-1))
    return ref_model


def check_routed_model(torch, int8: bool = False, grid=(8, 24, 20), tile=(4, 6, 4),
                       dispatch=(None, None, "masked")) -> None:
    """2 blocks at Wan-1.3B widths routed hard: card (bf16, kernels) vs CPU
    (f32, plain versions).  The routers' weights are 0 and their biases
    one-hot logits, so 4 heads go to each expert in both runs.  ``int8``:
    with qk_int8 and W8A8 on both sides.  The default grid has 3,840 tokens
    in tiles (2, 4, 5) per axis, so the 3-tile STA window is narrower than
    the grid on h and w; the STA heads take the kernel the gates pick.
    ``dispatch``: one of DISPATCHES, its variable set on both sides."""
    import dataclasses

    import numpy as np

    from vorta_tpu_torch.config import WAN_1_3B, AttentionConfig
    from vorta_tpu_torch.models.wan import WanModel
    from vorta_tpu_torch.ops import _build
    from vorta_tpu_torch.ops.routed_fused import routed_sta_kernel

    cfg = dataclasses.replace(WAN_1_3B, num_layers=2)
    attn = AttentionConfig(latent_shape=grid, sta_tile=tile, sta_window=(3, 3, 3),
                           lowres_window=(2, 3, 2), qk_int8=int8)
    sta_kernel = routed_sta_kernel(attn, 128, 2)
    mm = "int8" if int8 else "bf16"
    ref_model = routed_reference_wan(torch)
    experts = torch.tensor(ROUTED_EXPERTS)
    gpu_model = WanModel(cfg, dtype=torch.bfloat16, device="cuda", seed=5)
    gpu_model.load_state_dict(ref_model.state_dict())
    g = torch.Generator().manual_seed(6)
    lat = torch.randn((1, grid[0], 2 * grid[1], 2 * grid[2], 16), generator=g)
    ctx = torch.randn((1, TEXT_LEN, cfg.text_dim), generator=g)
    t = torch.tensor([700.0])
    with dispatch_env(*dispatch[:2]):
        want = ref_model(lat, t, ctx, attn_cfg=attn, routing_mode="hard",
                         mm_precision=mm).sample
        _build.reset_launches()
        res = gpu_model(lat.cuda(), t.cuda(), ctx.cuda(), attn_cfg=attn, routing_mode="hard",
                        mm_precision=mm)
    got = res.sample.float().cpu()
    launches = dict(_build.launches)
    if not (res.expert_ids == experts.numpy()).all():
        raise RuntimeError(f"routed model check: routing {res.expert_ids}")
    expected = routed_wan_launches(np.asarray(res.expert_ids)[None], sta_kernel, 1, dispatch[2],
                                   int8=int8)
    if launches != expected:
        raise RuntimeError(f"routed model check: launches {launches} != {expected}")
    if not torch.isfinite(got).all():
        raise RuntimeError("routed model check: non-finite output on the card")
    rel = ((got - want).norm() / want.norm()).item()
    # bf16 activations against f32 through 2 blocks, as the routing-off check,
    # plus the lowres picks that bf16 rounding flips (kernels phase: the flip
    # count) and that then swap a token's own output for its center's
    log(f"routed model check (2 blocks, 1.3B widths, {grid} = {attn.seq_len:,} tokens, tile "
        f"{tile} ({sta_kernel}), 4 heads per expert{', qk_int8 + W8A8' if int8 else ''}, "
        f"dispatch {dispatch[2]}): rel "
        f"L2 err card bf16 vs CPU f32 = {rel:.4f} (tolerance 0.05); launches {launches}")
    if not rel < 0.05:
        raise RuntimeError("routed model check: the card's forward disagrees with the CPU's")


def run_main_path(torch, card: str):
    import dataclasses

    from vorta_tpu_torch.cli.sample import main as sample_main
    from vorta_tpu_torch.config import WAN_1_3B, AttentionConfig
    from vorta_tpu_torch.models.wan import WanModel
    from vorta_tpu_torch.ops import _build

    # Warm cuBLAS / cuDNN and the caching allocator at the main path's shapes
    # with a 2-block model of the same widths, so that the timed steps show
    # the steady state of a serving process rather than first-call set-up.
    warm = WanModel(dataclasses.replace(WAN_1_3B, num_layers=2), dtype=torch.bfloat16,
                    device="cuda", seed=1)
    warm(torch.randn((1, GRID_480P[0], 2 * GRID_480P[1], 2 * GRID_480P[2], 16), device="cuda"),
         torch.tensor([900.0], device="cuda"), torch.randn((1, TEXT_LEN, 4096), device="cuda"),
         attn_cfg=AttentionConfig(latent_shape=GRID_480P))
    del warm
    torch.cuda.synchronize()

    out = HERE / "results" / "port_smoke" / "latents.npy"  # .npy under results/ is not tracked
    _build.reset_launches()
    res = sample_main([
        "--model", "wan-1_3B", "--native_attention", "--random_embeds",
        "--num_frames", "21", "--height", "480", "--width", "832",
        "--num_inference_steps", "2", "--guidance_scale", "5.0", "--scheduler", "unipc",
        "--seed", "0", "--dtype", "bf16", "--device", "cuda", "--output", str(out)])
    launches = dict(_build.launches)
    lat = res.latents
    if tuple(lat.shape) != (1, 6, 60, 104, 16) or not torch.isfinite(lat).all():
        raise RuntimeError(f"main path: output {tuple(lat.shape)}, finite "
                           f"{bool(torch.isfinite(lat).all())}")
    expected = {**dict.fromkeys(_build.KERNELS, 0), "flash": 60 * 4, "flash_wgmma": 60 * 4,
                "fused_norm": 61 * 4, "prologue": 30 * 4, "prologue_rows": 30 * 4}
    if launches != expected:
        raise RuntimeError(f"main path launches {launches} != expected {expected}")
    served_on_wgmma(launches, "main path off")
    per_step = res.denoise_s / res.steps
    log(f"main path: Wan-1.3B 30 blocks, 9,360 tokens, 2 UniPC steps x CFG: "
        f"{res.denoise_s:.3f} s ({per_step:.3f} s/step; model build {res.build_s:.1f} s) "
        f"on {card}; output std {lat.std().item():.4f}")
    return launches, per_step


def run_routed_main_path(torch, card: str, int8: bool = False):
    """cli.sample at its defaults: 480p x 77f, routing hard, 30 blocks;
    ``int8``: with --qk_int8 --mm int8, the int8 QK mode launched wherever
    flash_manual is."""
    import dataclasses

    import numpy as np

    from vorta_tpu_torch.cli.sample import attention_config
    from vorta_tpu_torch.cli.sample import main as sample_main
    from vorta_tpu_torch.config import WAN_1_3B
    from vorta_tpu_torch.models.wan import WanModel
    from vorta_tpu_torch.ops import _build

    t_grid, h_grid, w_grid = GRID_480P_77F
    warm = WanModel(dataclasses.replace(WAN_1_3B, num_layers=2), dtype=torch.bfloat16,
                    device="cuda", seed=1)
    warm(torch.randn((1, t_grid, 2 * h_grid, 2 * w_grid, 16), device="cuda"),
         torch.tensor([900.0], device="cuda"), torch.randn((1, TEXT_LEN, 4096), device="cuda"),
         attn_cfg=attention_config("wan-1_3B", GRID_480P_77F), routing_mode="hard")
    del warm
    torch.cuda.synchronize()

    out = HERE / "results" / "port_smoke" / f"latents_routed{'_int8' if int8 else ''}.npy"
    quant = ["--qk_int8", "--mm", "int8"] if int8 else []
    _build.reset_launches()
    res = sample_main(["--model", "wan-1_3B", "--random_embeds", "--num_inference_steps", "2",
                       "--seed", "0", "--device", "cuda", "--output", str(out), *quant])
    launches = dict(_build.launches)
    lat = res.latents
    if tuple(lat.shape) != (1, 20, 60, 104, 16) or not torch.isfinite(lat).all():
        raise RuntimeError(f"routed main path: output {tuple(lat.shape)}, finite "
                           f"{bool(torch.isfinite(lat).all())}")
    tables = np.stack(res.routing)  # (forwards, blocks, heads)
    if tables.shape != (4, 30, 12):
        raise RuntimeError(f"routed main path: routing tables {tables.shape}")
    heads = np.bincount(tables.reshape(-1), minlength=3)
    expected = routed_wan_launches(tables, "sta_pipe", tables.shape[0], int8=int8)
    if launches != expected:
        raise RuntimeError(f"routed main path launches {launches} != expected {expected}")
    served_on_wgmma(launches, f"routed main path{' int8' if int8 else ''}")
    if not (heads > 0).all():
        raise RuntimeError(f"routed main path: an expert got no head: {heads}")
    per_step = res.denoise_s / res.steps
    log(f"routed main path{' --qk_int8 --mm int8' if int8 else ''}: Wan-1.3B 30 blocks, 31,200 "
        f"tokens, routing hard, 2 UniPC steps x CFG: {res.denoise_s:.3f} s ({per_step:.3f} s/step; model build {res.build_s:.1f} s) "
        f"on {card}; heads per expert over the run: full {heads[0]}, lowres {heads[1]}, "
        f"sta {heads[2]}; launches {launches} (exact); output std {lat.std().item():.4f}")
    return launches, per_step


def run_720p_forward(torch, card: str) -> dict:
    """One Wan-1.3B forward at 720p x 77 frames (72,000 tokens), routing off
    then routed by the trained router: ms of each, their ratio, the routed
    arm's heads per expert (must be the JAX package's mix), launches exact."""
    from vorta_tpu_torch.config import WAN_1_3B, AttentionConfig
    from vorta_tpu_torch.models.wan import WanModel
    from vorta_tpu_torch.ops import _build

    grid = (20, 45, 80)
    model = WanModel(WAN_1_3B, dtype=torch.bfloat16, device="cuda", seed=0)
    g = torch.Generator(device="cuda").manual_seed(1)
    lat = torch.randn((1, 20, 90, 160, 16), generator=g, device="cuda")
    ctx = torch.randn((1, TEXT_LEN, 4096), generator=g, device="cuda")
    t = torch.tensor([900.0], device="cuda")
    attn = AttentionConfig(latent_shape=grid)
    model(lat, t, ctx, attn_cfg=attn)  # warm-up
    torch.cuda.synchronize()
    _build.reset_launches()
    t0 = time.time()
    out = model(lat, t, ctx, attn_cfg=attn).sample
    torch.cuda.synchronize()
    dt = time.time() - t0
    launches_off = dict(_build.launches)
    if not torch.isfinite(out).all():
        raise RuntimeError("720p forward: non-finite output")
    expected = {**dict.fromkeys(_build.KERNELS, 0), "flash": 60, "flash_wgmma": 60,
                "fused_norm": 61, "prologue": 30, "prologue_rows": 30}
    if launches_off != expected:
        raise RuntimeError(f"720p forward: launches {launches_off} != expected {expected}")
    served_on_wgmma(launches_off, "720p forward off")
    log(f"720p x 77f forward (72,000 tokens, 30 blocks, routing off): {dt * 1e3:.1f} ms "
        f"on {card}")

    # bench.py's routed arm: the same forward routed hard by the JAX
    # package's router trained at this geometry (tile (5, 9, 8)), reading
    # the timestep embedding of the model it was trained against
    import numpy as np

    from vorta_tpu_torch.io.from_jax import load_jax_params, load_router_npz

    load_router_npz(model, HERE / ROUTER_720P)
    load_jax_params(model, HERE / TEMB_720P)
    routed = AttentionConfig(latent_shape=grid, sta_tile=(5, 9, 8), sta_window=(3, 3, 3),
                             lowres_window=(2, 3, 2), tau_sparse=0.3)
    t500 = torch.tensor([500.0], device="cuda")
    model(lat, t500, ctx, attn_cfg=routed, routing_mode="hard")  # warm-up
    torch.cuda.synchronize()
    _build.reset_launches()
    t0 = time.time()
    res = model(lat, t500, ctx, attn_cfg=routed, routing_mode="hard")
    torch.cuda.synchronize()
    dt_r = time.time() - t0
    launches_r = dict(_build.launches)
    if not torch.isfinite(res.sample).all():
        raise RuntimeError("720p routed forward: non-finite output")
    heads = np.bincount(res.expert_ids.reshape(-1), minlength=3)
    log(f"720p x 77f forward routed hard ({ROUTER_720P}, {TEMB_720P}, t = 500): "
        f"{dt_r * 1e3:.1f} ms on {card}; routing off / routed = {dt / dt_r:.3f}; heads over "
        f"30 blocks: full {heads[0]}, lowres {heads[1]}, sta {heads[2]} (the JAX package: "
        f"full {JAX_MIX_720P[0]}, lowres {JAX_MIX_720P[1]}, sta {JAX_MIX_720P[2]})")
    if tuple(int(x) for x in heads) != JAX_MIX_720P:
        raise RuntimeError(f"720p routed forward: heads per expert {heads} != the JAX "
                           f"package's {JAX_MIX_720P}")
    expected = routed_wan_launches(np.asarray(res.expert_ids)[None], "sta_pipe", 1)
    if launches_r != expected:
        raise RuntimeError(f"720p routed forward: launches {launches_r} != expected {expected}")
    served_on_wgmma(launches_r, "720p forward routed")
    return dict(off_ms=dt * 1e3, routed_ms=dt_r * 1e3, off_over_routed=dt / dt_r,
                launches_off=launches_off, launches_routed=launches_r)


# ---- HunyuanVideo-13B ----------------------------------------------------------


def hy_text_mask(torch, dev, batch: int = 1):
    """(B, 256) bool: the first 83 text tokens valid, as --random_embeds makes them."""
    return (torch.arange(HY_TEXT, device=dev) < HY_VALID)[None].expand(batch, HY_TEXT)


def check_hunyuan_kernels(torch, card: str) -> dict:
    """The joint experts' kernels at HunyuanVideo-13B's 720p x 45f shapes,
    against their plain versions: {kernel counter: {shape: numbers}}."""
    import numpy as np
    import torch.nn.functional as F

    from vorta_tpu_torch.cli.sample import attention_config
    from vorta_tpu_torch.models.hunyuan import HUNYUAN_13B, hunyuan_rope_tables
    from vorta_tpu_torch.ops import joint_experts as joint
    from vorta_tpu_torch.ops.coreset import group_view, slot_similarity
    from vorta_tpu_torch.ops.coreset_pallas import pick_gaps, pool_qkv, pool_qkv_ref
    from vorta_tpu_torch.ops.experts import lowres_groups_for
    from vorta_tpu_torch.ops.flash import dense_tables
    from vorta_tpu_torch.ops.flash_manual import (
        sparse_flash_attention_manual,
        sparse_flash_attention_manual_ref,
    )
    from vorta_tpu_torch.ops.sta_pipe import (
        sta_pipe_attention,
        sta_pipe_attention_mma_sync,
        sta_pipe_attention_ref,
    )

    dev = torch.device("cuda")
    bf16 = torch.bfloat16
    h, d = 24, 128
    scale = d**-0.5
    cfg = attention_config("hunyuan-13B", GRID_HY_45F)
    jcfg = joint.JointConfig(cfg, HY_TEXT)
    layouts = joint.joint_layouts(jcfg)
    sv = cfg.seq_len
    groups = lowres_groups_for(cfg)
    act = torch.tensor(HY_ACTIVE, device=dev)
    n_act = int(act.sum().item())
    mask = hy_text_mask(torch, dev)
    text_bias = joint._text_bias(mask)
    g = torch.Generator(device=dev).manual_seed(40)

    def randn(*shape):  # unit RMS: the scale of qk-normed q/k
        return torch.randn(shape, generator=g, device=dev).to(bf16)

    out = {k: {} for k in ("flash_manual", "sta_pipe", "pool_qkv", "unpool", "prologue",
                           "fused_norm")}

    # ---- flash_manual with kv_bias: the FULL and LOWRES joint layouts (text at a
    # 1024 boundary), the STA expert's text rows (block_q 256 over [video | text]
    # padded to 1024, kv_valid_len + bias), and that call with the bias also
    # masking kv block 0, the first every row visits.  Padding holds random
    # values: a kernel that ignored the bias would attend to it.
    p = groups.pooled_length
    s_all = sv + HY_TEXT
    rows_t = layouts["sta_text_rows"]
    bias_t = joint._bias(mask, rows_t, sv)
    bias_first = bias_t.clone()
    bias_first[:, :1024] = -1e30
    cases = (  # name, layout, bias, kv_valid_len, q rows used, visible keys
        ("full", layouts["full"], joint._bias(mask, layouts["full"], sv), None,
         sv + HY_TEXT, sv + HY_VALID),
        ("lowres", layouts["lowres"], joint._bias(mask, layouts["lowres"], p), None,
         p + HY_TEXT, p + HY_VALID),
        ("sta_text_rows", rows_t, bias_t, s_all, HY_TEXT, sv + HY_VALID),
        ("bias_masks_first_block", rows_t, bias_first, s_all, HY_TEXT, sv - 1024 + HY_VALID),
    )
    for name, lay, bias, valid, q_rows, keys in cases:
        sq = lay.total if lay.block_q == lay.block_kv else lay.block_q
        q = randn(1, h, sq, d)
        k, v = (randn(1, h, lay.total, d) for _ in range(2))
        ki, kc = dense_tables(sq // lay.block_q, lay.total // lay.block_kv).on(dev)
        cnt = torch.where(act[:, None] > 0, kc, 0).to(torch.int32)
        kw = dict(scale=scale, block_q=lay.block_q, block_kv=lay.block_kv, kv_valid_len=valid,
                  kv_bias=bias, softmax="fast")
        kern = lambda: sparse_flash_attention_manual(q, k, v, ki, cnt, **kw)  # noqa: E731
        plain = lambda: sparse_flash_attention_manual_ref(q, k, v, ki, cnt, **kw)  # noqa: E731
        got, want = kern(), plain()
        err = compare(torch, f"flash_manual kv_bias {name} (1,24,{sq},128) x {lay.total}, "
                      f"blocks {lay.block_q}/{lay.block_kv}, {n_act} of 24 heads", got, want)
        if got[:, act == 0].any():
            raise RuntimeError(f"flash_manual {name}: a head routed away wrote non-zeros")
        ratio = worst_ratio(torch, got, want)
        unbiased = sparse_flash_attention_manual_ref(q, k, v, ki, cnt, **{**kw, "kv_bias": None})
        miss = worst_ratio(torch, unbiased[:, act > 0], want[:, act > 0])
        log(f"flash_manual {name} without the bias: worst ratio {miss:.3e}")
        if name in ("full", "bias_masks_first_block") and not miss > TOL:
            raise RuntimeError(f"flash_manual {name} check cannot tell a missing bias")
        del got, want, unbiased
        flops = 4.0 * q_rows * keys * d * n_act
        b_ms, b_by = bound_ms(flops, (2 * q_rows + 2 * keys) * d * 2 * n_act + lay.total * 4,
                              PEAK_BF16)
        lib, lib_err = None, None
        qa, ka, va = (x[:, act > 0] for x in (q, k, v))
        try:  # SDPA with the bias as an additive float mask
            fmask = bias.to(bf16)[None, None]
            lib = time_ms(torch, lambda: F.scaled_dot_product_attention(
                qa, ka, va, attn_mask=fmask), 5, 1)
        except (torch.OutOfMemoryError, RuntimeError) as e:
            lib_err = f"{type(e).__name__}: {str(e).splitlines()[0][:200]}"
            log(f"flash_manual {name}: SDPA with the float mask failed: {lib_err}")
        del qa, ka, va
        r = with_rate(dict(ms=time_ms(torch, kern, 5), plain_ms=time_ms(torch, plain, 2, 1),
                           library_ms=lib, bound_ms=b_ms, bound_by=b_by, max_abs_err=err,
                           worst_ratio=ratio, missing_bias_worst_ratio=miss), flops)
        if lib_err:
            r["library_error"] = lib_err
        out["flash_manual"][f"hunyuan_{name}"] = r
        log(f"flash_manual {name}: {r} ({n_act} heads)")
        del q, k, v
        torch.cuda.empty_cache()

    # ---- sta_pipe with the text tail: (1,24,43200,128), 432-token tiles, 256 text keys
    tile = cfg.sta_tile
    q, k, v = (randn(1, h, sv, d) for _ in range(3))
    tk, tv = (randn(1, h, HY_TEXT, d) for _ in range(2))
    kw = dict(latent_shape=GRID_HY_45F, tile=tile, window=cfg.sta_window, scale=scale,
              text_k=tk, text_v=tv, text_bias=text_bias)
    kern = lambda: sta_pipe_attention(q, k, v, act, **kw)  # noqa: E731
    mma = lambda: sta_pipe_attention_mma_sync(q, k, v, act, **kw)  # noqa: E731
    plain = lambda: sta_pipe_attention_ref(q, k, v, act, **kw)  # noqa: E731
    sta_path_once(torch, "sta_pipe + text tail", kern, True)
    got, want = kern(), plain()
    err = compare(torch, f"sta_pipe + text tail (1,24,{sv},128) + 256 text, tile {tile}, "
                  f"{n_act} of 24 heads", got, want)
    compare(torch, "sta_pipe + text tail on the mma.sync kernel", mma(), want)
    if got[:, act == 0].any():
        raise RuntimeError("sta_pipe text tail: an inactive head wrote non-zeros")
    ratio = worst_ratio(torch, got, want)
    no_tail = sta_pipe_attention_ref(q, k, v, act, **{**kw, "text_k": None, "text_v": None,
                                                       "text_bias": None})
    miss = worst_ratio(torch, no_tail[:, act > 0], want[:, act > 0])
    log(f"sta_pipe without the text tail: worst ratio {miss:.3e} (must exceed {TOL:g})")
    if not miss > TOL:
        raise RuntimeError("sta_pipe check cannot tell a missing text tail")
    del got, want, no_tail
    window_keys = int(np.prod([min(3, GRID_HY_45F[a] // tile[a]) * tile[a] for a in range(3)]))
    keys = window_keys + HY_VALID
    flops = 4.0 * sv * keys * d * n_act
    b_ms, b_by = bound_ms(flops, (4 * sv + 2 * HY_TEXT) * d * 2 * n_act, PEAK_BF16)
    # SDPA over [video | text] with the window's boolean mask and the text mask
    smask = torch.cat([sta_raster_mask(torch, GRID_HY_45F, tile, dev),
                       mask.expand(sv, HY_TEXT)], dim=1)
    ka, va = (torch.cat([a, b], dim=2)[:, act > 0] for a, b in ((k, tk), (v, tv)))
    lib, lib_err = masked_sdpa_ms(torch, "sta_pipe", q[:, act > 0], ka, va, smask)
    del smask, ka, va
    torch.cuda.empty_cache()
    r = sta_rates(dict(ms=time_ms(torch, kern, 10), mma_sync_ms=time_ms(torch, mma, 10),
                       plain_ms=time_ms(torch, plain, 2, 1), library_ms=lib, bound_ms=b_ms,
                       bound_by=b_by, max_abs_err=err, worst_ratio=ratio,
                       missing_tail_worst_ratio=miss), flops)
    if lib_err:
        r["library_error"] = lib_err
    out["sta_pipe"]["hunyuan_45f_text_tail"] = r
    log(f"sta_pipe text tail: {window_keys} window + {HY_VALID} text keys per query; {r} "
        f"({n_act} heads)")
    del q, k, v, tk, tv

    # ---- pool_qkv with K's own matching, and unpool: (1,24,43200,128) -> 21,600
    q, k, v = (randn(1, h, sv, d) for _ in range(3))
    pool = lambda: pool_qkv(q, k, v, groups, kv_matching_from_k=True, active=act,  # noqa: E731
                            return_picks=True)
    pool_plain = lambda: pool_qkv_ref(q, k, v, groups, kv_matching_from_k=True,  # noqa: E731
                                      active=act)
    got, want = pool(), pool_plain()
    torch.cuda.synchronize()
    gaps = pick_gaps(got[3], want[3], q, groups)
    n_picks = n_act * groups.num_groups * groups.num_kept_margins
    log(f"pool_qkv (K matching) Q picks: {gaps.numel()} of {n_picks} disagree with the plain "
        f"version's, largest |dsim| {gaps.max().item() if gaps.numel() else 0.0:.3e} "
        f"(each must be a near-tie, < {PICK_EPS:g})")
    if gaps.numel() and not gaps.max().item() < PICK_EPS:
        raise RuntimeError("pool_qkv: a pick disagrees away from a near-tie")
    sh = (1, h, groups.num_groups, groups.num_kept_margins)
    q_agree = (got[3].reshape(sh) == want[3].reshape(sh)).all(-1)
    k_sim = slot_similarity(group_view(k, groups), groups._geom.center_slot)
    k_clear = k_sim.sort(dim=-1).values[..., :-1].diff(dim=-1).min(dim=-1).values > PICK_EPS
    gsz = groups.num_groups
    for name, a, w, agree in zip("qkv", got[:3], want[:3], (q_agree, k_clear, k_clear)):
        kept_a = a[:, :, gsz:].reshape(*sh, d)[agree]
        kept_w = w[:, :, gsz:].reshape(*sh, d)[agree]
        if not (torch.equal(a[:, :, :gsz], w[:, :, :gsz]) and torch.equal(kept_a, kept_w)):
            raise RuntimeError(f"pool_qkv {name}: pooled rows differ away from near-ties")
    log(f"pool_qkv (K matching): pooled q equal where Q's picks agree, k and v where K's "
        f"ranking has no near-tie ({int(k_clear[:, act > 0].sum())} of {n_act * gsz} groups)")
    # reads all of q and k (the two matchings) and the kept rows of v
    p_bytes = (n_act * (2 * sv + p) * d * 2 + h * (3 * p * d * 2 + sh[2] * sh[3] * 4))
    bp_ms, bp_by = bound_ms(0.0, p_bytes, PEAK_BF16)
    out["pool_qkv"]["hunyuan_45f_k_matching"] = dict(
        ms=time_ms(torch, pool, 20), plain_ms=time_ms(torch, pool_plain, 2, 1), library_ms=None,
        bound_ms=bp_ms, bound_by=bp_by, max_abs_err=0.0, pick_disagreements=gaps.numel(),
        picks=n_picks)
    log(f"pool_qkv (K matching): {out['pool_qkv']['hunyuan_45f_k_matching']}")
    picks = got[3]
    out_p = randn(1, h, p, d)
    u_bytes = n_act * (p * d * 2 + sh[2] * sh[3] * 4) + h * sv * d * 2
    out["unpool"]["hunyuan_45f"] = unpool_case(
        torch, "(1,24,21600,128) -> (1,24,43200,128), active mode", out_p, q, groups, picks,
        [i for i in range(h) if HY_ACTIVE[i]], u_bytes, active=act)
    del q, k, v, got, want, out_p

    # ---- the qk prologue (head scope) and the AdaLN norm on the single block's
    # joint stream (1, 43456, 3072): column slices of its fused projection,
    # RoPE the identity on the 256 text rows
    dim = HUNYUAN_13B.dim
    sj = sv + HY_TEXT
    fused = randn(1, sj, 3 * dim + HUNYUAN_13B.mlp_dim).mul_(3.0)
    pq, pk, pv, _ = fused.split([dim, dim, dim, HUNYUAN_13B.mlp_dim], dim=-1)
    gq, gk = (1.0 + 0.1 * torch.randn(d, generator=g, device=dev) for _ in range(2))
    cos, sin = hunyuan_rope_tables(GRID_HY_45F, HUNYUAN_13B)
    cos = torch.from_numpy(np.concatenate([cos, np.ones((HY_TEXT, d // 2), np.float32)])).to(dev)
    sin = torch.from_numpy(np.concatenate([sin, np.zeros((HY_TEXT, d // 2), np.float32)])).to(dev)
    out["prologue"]["hunyuan_joint_43456"] = prologue_case(
        torch, f"(1,{sj},3072), head scope, text rows unrotated", pq, pk, pv, gq.repeat(h),
        gk.repeat(h), cos, sin, h, "head", 20)
    del fused, pq, pk, pv
    mod = torch.randn((1, 6, dim), generator=g, device=dev) * 0.3
    out["fused_norm"]["hunyuan_joint_43456"] = norm_case(
        torch, f"AdaLN norm (Hunyuan joint stream) (1,{sj},3072)",
        randn(1, sj, dim).mul_(3.0), mod[:, 1], mod[:, 0], 20)
    # ---- the token-replace norm: the first frame's rows under tr_emb's
    # modulation, the rest under the block's, as the I2V path runs it on a
    # dual block's video stream, on the single block's joint stream and, at
    # B = 2, on a batched CFG stream (batch strides of the row-offset views)
    n_first = GRID_HY_45F[1] * GRID_HY_45F[2]
    for key, b, rows in (("token_replace_video_43200", 1, sv),
                         ("token_replace_joint_43456", 1, sj),
                         ("token_replace_video_b2_43200", 2, sv)):
        mods = torch.randn((b, 4, dim), generator=g, device=dev) * 0.3
        out["fused_norm"][key] = token_replace_norm_case(
            torch, f"token-replace AdaLN norm ({b},{rows},3072), rows [0,{n_first}) apart",
            randn(b, rows, dim).mul_(3.0), mods.unbind(1), n_first, 20)
    return out


def token_replace_norm_case(torch, name: str, x, mods, n: int, iters: int) -> dict:
    """models.hunyuan._modulated with token replace: the norm kernel over
    rows [0, n) with tr_emb's scale / shift and over [n, S) with the
    block's, each writing its row-offset view of one output, against the
    plain norm of every row under both modulations and a per-row select;
    timed beside that plain version, with its share of the bytes bound (x
    read, the output written, the four (B, dim) vectors read once).  No one
    PyTorch call computes a norm with two modulations: library_ms is null."""
    from vorta_tpu_torch.models.common import FP32LayerNorm
    from vorta_tpu_torch.models.hunyuan import _modulated
    from vorta_tpu_torch.ops.fused_norm import _norm_ref

    sc, sh, tr_sc, tr_sh = mods
    norm = FP32LayerNorm(x.shape[-1], 1e-6, affine=False, device=x.device)
    first = (torch.arange(x.shape[1], device=x.device) < n)[None, :, None]

    def plain():
        ref = lambda a, b: _norm_ref(x, a, b, None, None, rms=False, eps=1e-6,  # noqa: E731
                                     out_f32=False)
        return torch.where(first, ref(tr_sc, tr_sh), ref(sc, sh))

    kern = lambda: _modulated(norm, x, sc, sh, tr_sc, tr_sh, n)  # noqa: E731
    got, want = kern(), plain()
    err = compare(torch, name, got, want)
    ratio = worst_ratio(torch, got, want)
    del got, want
    nbytes = 2 * x.numel() * x.element_size() + 4 * sc.numel() * 4
    b_ms, b_by = bound_ms(10.0 * x.numel(), nbytes, PEAK_F32)
    r = dict(ms=device_ms(torch, kern, iters), plain_ms=time_ms(torch, plain, 3, 1),
             library_ms=None, bound_ms=b_ms, bound_by=b_by, max_abs_err=err,
             worst_ratio=ratio, first_rows=n)
    r.update(gbps=nbytes / r["ms"] / 1e6, bound_share=b_ms / r["ms"])
    log(f"{name}: {r}")
    return r


def hy_inputs(torch, grid, dev, seed: int):
    """Latents for a token grid, Llama-width text states, CLIP pooled, mask."""
    g = torch.Generator(device=dev).manual_seed(seed)
    lat = torch.randn((1, grid[0], 2 * grid[1], 2 * grid[2], 16), generator=g, device=dev)
    text = torch.randn((1, HY_TEXT, 4096), generator=g, device=dev)
    pooled = torch.randn((1, 768), generator=g, device=dev)
    return lat, text, hy_text_mask(torch, dev), pooled


def hy_hard_launches(tables, int8: bool = False, sta_kernel: str = "sta_pipe",
                     dual: int = 20) -> dict:
    """Kernel launches of hard-routed Hunyuan forwards from their routing
    tables (forwards, blocks, heads; ``dual`` of the blocks dual-stream): per
    forward the prologue a block and the AdaLN norm 4 per dual block, 1 per
    single block, 1 in the head (60 and 121 at the 13B's 20 + 40);
    per block one flash_manual per routed expert (STA's for its text rows,
    except with sta_batched, which takes them itself), the STA kernel with
    STA, pool_qkv and unpool in head-map mode with LOWRES (as the JAX
    package's joint_lowres_attention pools whenever it is given its heads);
    ``int8``: FULL's and LOWRES's flash_manual in the int8 QK mode (the STA
    text rows stay bf16).  Every flash_manual launch takes the Hopper path,
    and so does every launch of the STA kernel on a served geometry
    (sta_pipe; sta_batched at (2, 9, 8); sta_window); every prologue launch
    the warp-per-row kernel, every unpool launch the batched 16-byte copy."""
    from vorta_tpu_torch.ops import _build

    has = [(tables == e).any(-1) for e in range(3)]  # per (forward, block)
    n_fwd, blocks = tables.shape[:2]
    text_rows = 0 if sta_kernel == "sta_batched" else int(has[2].sum())
    experts = int(has[0].sum() + has[1].sum())
    norms = 4 * dual + (blocks - dual) + 1
    return {**dict.fromkeys(_build.KERNELS, 0), "prologue": blocks * n_fwd,
            "prologue_rows": blocks * n_fwd, "fused_norm": norms * n_fwd,
            "flash_manual": experts + text_rows, sta_kernel: int(has[2].sum()),
            f"{sta_kernel}_wgmma": int(has[2].sum()), "pool_qkv_headmap": int(has[1].sum()),
            "unpool_headmap": int(has[1].sum()), "unpool_rows": int(has[1].sum()),
            "flash_manual_int8": experts if int8 else 0, "flash_manual_wgmma": experts + text_rows}


HY_MODEL_MODES = (("off", False), ("hard", False), ("off", True), ("hard", True))


def check_hunyuan_model(torch, grid=(6, 9, 16), tile=(6, 9, 8), modes=HY_MODEL_MODES) -> None:
    """1 dual + 1 single block at HunyuanVideo-13B widths: card (bf16,
    kernels) vs CPU (f32, plain versions) from the same weights, routing off
    and routed hard with 8 heads on each expert, by default on a
    window-dense grid (6, 9, 16) (tile (6, 9, 8): 864 tokens), with 83 of 256
    text tokens valid; each in bf16 and with qk_int8 + W8A8 (``modes``)."""
    import dataclasses

    import numpy as np

    from vorta_tpu_torch.cli.sample import attention_config
    from vorta_tpu_torch.models.hunyuan import HUNYUAN_13B, HunyuanModel
    from vorta_tpu_torch.ops import _build
    from vorta_tpu_torch.ops.joint_experts import JointConfig, joint_sta_kernel

    cfg = dataclasses.replace(HUNYUAN_13B, dual_layers=1, single_layers=1)
    attn = dataclasses.replace(attention_config("hunyuan-13B", grid), sta_tile=tile)
    sta_kernel = joint_sta_kernel(JointConfig(attn, HY_TEXT), 128, 2)
    experts = torch.tensor([0, 1, 2] * 8)
    gpu = HunyuanModel(cfg, dtype=torch.bfloat16, device="cuda", seed=3)
    for block in gpu.blocks:
        block.router.linear.weight.zero_()
        block.router.linear.bias.copy_(4.0 * torch.eye(3, device="cuda")[experts].reshape(-1))
    cpu = HunyuanModel(cfg, dtype=torch.float32, device="meta").to_empty(device="cpu")
    cpu.load_state_dict(gpu.state_dict())  # the same (bf16-rounded) weights in f32
    lat, text, mask, pooled = hy_inputs(torch, grid, torch.device("cuda"), 9)
    args = (lat, torch.tensor([700.0], device="cuda"), text, mask, pooled)
    g = torch.tensor([6000.0], device="cuda")
    for mode, int8 in modes:
        a = dataclasses.replace(attn, qk_int8=int8)
        mm = "int8" if int8 else "bf16"
        want = cpu(*(x.cpu() for x in args), guidance=g.cpu(), attn_cfg=a, routing_mode=mode,
                   mm_precision=mm).sample
        _build.reset_launches()
        res = gpu(*args, guidance=g, attn_cfg=a, routing_mode=mode, mm_precision=mm)
        got = res.sample.float().cpu()
        launches = dict(_build.launches)
        expected = {**dict.fromkeys(_build.KERNELS, 0), "flash_manual": 2, "prologue": 2,
                    "prologue_rows": 2, "fused_norm": 6, "flash_manual_int8": 2 if int8 else 0,
                    "flash_manual_wgmma": 2}
        if mode == "hard":
            if not (res.expert_ids == experts.numpy()).all():
                raise RuntimeError(f"Hunyuan model check: routing {res.expert_ids}")
            expected = hy_hard_launches(np.asarray(res.expert_ids)[None], int8, sta_kernel)
            expected.update(prologue=2, prologue_rows=2, fused_norm=6)
        if launches != expected:
            raise RuntimeError(f"Hunyuan model check {mode}: launches {launches} != {expected}")
        if not torch.isfinite(got).all():
            raise RuntimeError(f"Hunyuan model check {mode}: non-finite output on the card")
        rel = ((got - want).norm() / want.norm()).item()
        log(f"Hunyuan model check (1 + 1 blocks, 13B widths, {grid} = {attn.seq_len:,} + 256 "
            f"tokens, tile {tile} ({sta_kernel}), {mode}{', qk_int8 + W8A8' if int8 else ''}): "
            f"rel L2 err card bf16 vs CPU f32 = {rel:.4f} (tolerance 0.05); launches {launches}")
        if not rel < 0.05:
            raise RuntimeError("Hunyuan model check: the card's forward disagrees with the CPU's")
    del gpu, cpu


def hy_warm_up(torch, grid, modes, attn=None) -> None:
    """Warm cuBLAS and the caching allocator at a grid's shapes with a
    1 + 1-block model of HunyuanVideo-13B's widths (``attn``: the attention
    config, by default the CLI's)."""
    import dataclasses

    from vorta_tpu_torch.cli.sample import attention_config
    from vorta_tpu_torch.models.hunyuan import HUNYUAN_13B, HunyuanModel

    warm = HunyuanModel(dataclasses.replace(HUNYUAN_13B, dual_layers=1, single_layers=1),
                        dtype=torch.bfloat16, device="cuda", seed=1)
    lat, text, mask, pooled = hy_inputs(torch, grid, torch.device("cuda"), 2)
    for mode in modes:
        warm(lat, torch.tensor([900.0], device="cuda"), text, mask, pooled,
             guidance=torch.tensor([6000.0], device="cuda"),
             attn_cfg=attn or attention_config("hunyuan-13B", grid), routing_mode=mode)
    torch.cuda.synchronize()


def run_hunyuan_main_path(torch, card: str):
    """cli.sample --model hunyuan-13B at 720p x 45f, 60 blocks, 2 Euler steps:
    routing off, then routed hard (the CLI's default); each again with
    --qk_int8 --mm int8 for 1 Euler step."""
    import gc

    import numpy as np

    from vorta_tpu_torch.cli.sample import main as sample_main
    from vorta_tpu_torch.ops import _build

    hy_warm_up(torch, GRID_HY_45F, ("off", "hard"))
    launches, per_step = {}, {}
    quant = ["--qk_int8", "--mm", "int8"]
    for name, extra in (("hunyuan_off", ["--native_attention"]), ("hunyuan", []),
                        ("hunyuan_off_int8", ["--native_attention", *quant]),
                        ("hunyuan_int8", quant)):
        out = HERE / "results" / "port_smoke" / f"{name}_latents.npy"
        int8 = name.endswith("int8")
        n = 1 if int8 else 2  # Euler steps, one forward each
        _build.reset_launches()
        res = sample_main(["--model", "hunyuan-13B", *extra, "--random_embeds",
                           "--num_frames", "45", "--height", "720", "--width", "1280",
                           "--num_inference_steps", str(n), "--seed", "0", "--device", "cuda",
                           "--output", str(out)])
        launches[name] = dict(_build.launches)
        lat = res.latents
        if tuple(lat.shape) != (1, 12, 90, 160, 16) or not torch.isfinite(lat).all():
            raise RuntimeError(f"Hunyuan main path {name}: output {tuple(lat.shape)}, finite "
                               f"{bool(torch.isfinite(lat).all())}")
        if name.startswith("hunyuan_off"):
            expected = {**dict.fromkeys(_build.KERNELS, 0), "flash_manual": 60 * n,
                        "prologue": 60 * n, "prologue_rows": 60 * n, "fused_norm": 121 * n,
                        "flash_manual_int8": 60 * n if int8 else 0,
                        "flash_manual_wgmma": 60 * n}
            heads = None
        else:
            tables = np.stack(res.routing)  # (forwards, blocks, heads)
            if tables.shape != (n, 60, 24):
                raise RuntimeError(f"Hunyuan main path: routing tables {tables.shape}")
            expected = hy_hard_launches(tables, int8)
            heads = np.bincount(tables.reshape(-1), minlength=3)
            if not (heads > 0).all():
                raise RuntimeError(f"Hunyuan main path: an expert got no head: {heads}")
        if launches[name] != expected:
            raise RuntimeError(f"Hunyuan main path {name}: launches {launches[name]} != "
                               f"expected {expected}")
        served_on_wgmma(launches[name], f"Hunyuan main path {name}")
        per_step[name] = res.denoise_s / res.steps
        log(f"Hunyuan main path {name}{' (--qk_int8 --mm int8)' if int8 else ''}: "
            f"HunyuanVideo-13B 20 + 40 blocks, 43,200 + 256 tokens, "
            f"{n} Euler step(s) (1 forward each): {res.denoise_s:.3f} s ({per_step[name]:.3f} "
            f"s/step; model build {res.build_s:.1f} s) on {card}; "
            + (f"heads per expert over the run: full {heads[0]}, lowres {heads[1]}, sta "
               f"{heads[2]}; " if heads is not None else "")
            + f"launches {launches[name]} (exact); output std {lat.std().item():.4f}; peak "
            f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB")
        del res, lat
        gc.collect()
        torch.cuda.empty_cache()
    return launches, per_step


def run_hunyuan_reference_shape(torch, card: str) -> dict:
    """One HunyuanVideo-13B forward at 720p x 117f (108,000 + 256 tokens),
    routed hard by random routers, then one routing off; timed after a
    warm-up of a 1 + 1-block model at the same shapes; launch counts exact
    (the STA kernel the gates pick at this geometry)."""
    import numpy as np

    from vorta_tpu_torch.cli.sample import attention_config
    from vorta_tpu_torch.models.hunyuan import HUNYUAN_13B, HunyuanModel
    from vorta_tpu_torch.ops import _build
    from vorta_tpu_torch.ops.joint_experts import JointConfig, joint_sta_kernel

    hy_warm_up(torch, GRID_HY_117F, ("hard", "off"))
    model = HunyuanModel(HUNYUAN_13B, dtype=torch.bfloat16, device="cuda", seed=0)
    lat, text, mask, pooled = hy_inputs(torch, GRID_HY_117F, torch.device("cuda"), 1)
    attn = attention_config("hunyuan-13B", GRID_HY_117F)
    sta_kernel = joint_sta_kernel(JointConfig(attn, HY_TEXT), 128, 2)
    res = {"sta_kernel": sta_kernel}
    torch.cuda.reset_peak_memory_stats()
    for mode in ("hard", "off"):
        torch.cuda.synchronize()
        _build.reset_launches()
        t0 = time.time()
        out = model(lat, torch.tensor([500.0], device="cuda"), text, mask, pooled,
                    guidance=torch.tensor([6000.0], device="cuda"), attn_cfg=attn,
                    routing_mode=mode)
        torch.cuda.synchronize()
        res[f"{mode}_ms"] = (time.time() - t0) * 1e3
        launches = dict(_build.launches)
        if not torch.isfinite(out.sample).all():
            raise RuntimeError(f"Hunyuan 117f forward {mode}: non-finite output")
        if mode == "hard":
            expected = hy_hard_launches(np.asarray(out.expert_ids)[None], sta_kernel=sta_kernel)
        else:
            expected = {**dict.fromkeys(_build.KERNELS, 0), "flash_manual": 60,
                        "prologue": 60, "prologue_rows": 60, "fused_norm": 121,
                        "flash_manual_wgmma": 60}
        if launches != expected:
            raise RuntimeError(f"Hunyuan 117f forward {mode}: launches {launches} != "
                               f"{expected}")
        served_on_wgmma(launches, f"Hunyuan 117f forward {mode} (STA: {sta_kernel})")
        heads = ("" if out.expert_ids is None else
                 "; heads over 60 blocks: full {}, lowres {}, sta {}".format(
                     *np.bincount(out.expert_ids.reshape(-1), minlength=3)))
        log(f"HunyuanVideo-13B 720p x 117f forward (108,000 + 256 tokens, 60 blocks, {mode}, "
            f"t = 500): {res[f'{mode}_ms']:.1f} ms on {card}{heads}; peak "
            f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB")
        del out
    log(f"720p x 117f: routing off / routed = {res['off_ms'] / res['hard_ms']:.3f}")
    return res


# ---- the STA fallbacks: sta_window, sta_batched, sta_row ----------------------------

# the STA tiles where the JAX package leaves sta_pipe (its gates): Wan 720p
# (4, 9, 10) runs sta_window, HunyuanVideo 720p x 45f (2, 9, 8) sta_batched
WAN_TILE_4910 = (4, 9, 10)
HY_TILE_298 = (2, 9, 8)


def masked_sdpa_ms(torch, name: str, qa, ka, va, mask):
    """SDPA with a boolean or float mask on the active heads: (ms, error);
    where the card refuses it (memory), None and the error."""
    import torch.nn.functional as F

    try:
        return time_ms(torch, lambda: F.scaled_dot_product_attention(
            qa, ka, va, attn_mask=mask), 3, 1), None
    except (torch.OutOfMemoryError, RuntimeError) as e:
        err = f"{type(e).__name__}: {str(e).splitlines()[0][:200]}"
        log(f"{name}: SDPA with the mask failed: {err}")
        return None, err


def vs_mma_sync(torch, name: str, r: dict, got, mma_sync, flops: float) -> None:
    """A Hopper-path kernel's row beside its mma.sync kernel at the same
    call: that kernel's output against the Hopper path's (each within TOL
    of the plain version, so within 2 TOL of each other) and its time,
    TFLOP/s, share of the bound and time over the Hopper path's."""
    ratio = worst_ratio(torch, got, mma_sync())
    if not ratio <= 2 * TOL:
        raise RuntimeError(f"{name}: the Hopper path and the mma.sync kernel differ, worst "
                           f"ratio {ratio:.4f}")
    r.update(mma_sync_worst_ratio=ratio, mma_sync_ms=time_ms(torch, mma_sync, 5))
    sta_rates(r, flops)


def window_case(torch, name, kernel, plain, grid, tile, act, text=False, seed=50,
                mma_sync=None):
    """One window-dense STA kernel (sta_window or sta_row) against its plain
    version at a full-width shape: 720p Wan (12 heads) or HunyuanVideo 45f
    (24 heads, 256 text keys with 83 valid); times, bound and SDPA.
    ``mma_sync``: the kernel's mma.sync version, where ``kernel`` takes the
    Hopper path: each call counted once, on its path, and the two held and
    timed side by side (``vs_mma_sync``)."""
    import numpy as np

    from vorta_tpu_torch.ops import joint_experts as joint

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    h, d = act.numel(), 128
    n = grid[0] * grid[1] * grid[2]
    q, k, v = (torch.randn((1, h, n, d), generator=g, device=dev).to(torch.bfloat16)
               for _ in range(3))
    kw = dict(latent_shape=grid, tile=tile, window=(3, 3, 3), scale=d**-0.5)
    mask = hy_text_mask(torch, dev)
    if text:
        kw.update(text_k=torch.randn((1, h, HY_TEXT, d), generator=g, device=dev).bfloat16(),
                  text_v=torch.randn((1, h, HY_TEXT, d), generator=g, device=dev).bfloat16(),
                  text_bias=joint._text_bias(mask))
    n_act = int(act.sum().item())
    kern = lambda: kernel(q, k, v, act, **kw)  # noqa: E731
    plain_fn = lambda: plain(q, k, v, act, **kw)  # noqa: E731
    mma = None if mma_sync is None else (lambda: mma_sync(q, k, v, act, **kw))  # noqa: E731
    if mma is not None:
        sta_path_once(torch, f"{name} {grid} tile {tile}", kern, True, name)
        sta_path_once(torch, f"{name} {grid} tile {tile} (the yardstick)", mma, False, name)
    got, want = kern(), plain_fn()
    err = compare(torch, f"{name} (1,{h},{n},128){' + 256 text' if text else ''}, tile {tile}, "
                  f"{n_act} of {h} heads active", got, want)
    if got[:, act == 0].any():
        raise RuntimeError(f"{name}: an inactive head wrote non-zeros")
    r = dict(worst_ratio=worst_ratio(torch, got, want))
    if text:  # bracket: the plain version without the text tail must fail
        no_tail = plain(q, k, v, act, **{**kw, "text_k": None, "text_v": None,
                                         "text_bias": None})
        r["missing_tail_worst_ratio"] = worst_ratio(torch, no_tail[:, act > 0], want[:, act > 0])
        if not r["missing_tail_worst_ratio"] > TOL:
            raise RuntimeError(f"{name} check cannot tell a missing text tail")
        del no_tail
    del want
    window_keys = int(np.prod([min(3, grid[a] // tile[a]) * tile[a] for a in range(3)]))
    keys = window_keys + (HY_VALID if text else 0)
    flops = 4.0 * n * keys * d * n_act
    b_ms, b_by = bound_ms(flops, (4 * n + (2 * HY_TEXT if text else 0)) * d * 2 * n_act,
                          PEAK_BF16)
    qa = q[:, act > 0]
    smask = sta_raster_mask(torch, grid, tile, dev)
    if text:
        smask = torch.cat([smask, mask.expand(n, HY_TEXT)], dim=1)
        ka, va = (torch.cat([a, b], dim=2)[:, act > 0] for a, b in ((k, kw["text_k"]),
                                                                     (v, kw["text_v"])))
    else:
        ka, va = k[:, act > 0], v[:, act > 0]
    lib, lib_err = masked_sdpa_ms(torch, name, qa, ka, va, smask)
    del smask, qa, ka, va
    torch.cuda.empty_cache()
    r.update(ms=time_ms(torch, kern, 10), plain_ms=time_ms(torch, plain_fn, 2, 1), library_ms=lib,
             bound_ms=b_ms, bound_by=b_by, max_abs_err=err)
    if mma is not None:
        vs_mma_sync(torch, name, r, got, mma, flops)
    del got
    if lib_err:
        r["library_error"] = lib_err
    log(f"{name}: {window_keys} window keys per query; {r} (achieved "
        f"{flops / r['ms'] / 1e9:.1f} TFLOP/s on {n_act} heads)")
    return r


def check_fallback_kernels(torch, card: str) -> dict:
    """sta_window, sta_batched and sta_row on the card against their plain
    versions at the slice's full-width shapes: {kernel: {shape: numbers}}."""
    import dataclasses

    from vorta_tpu_torch.cli.sample import attention_config
    from vorta_tpu_torch.ops import joint_experts as joint
    from vorta_tpu_torch.ops.routed_fused import routed_sta_kernel
    from vorta_tpu_torch.ops.sta_batched import (
        pair_bit_walk,
        sta_flash_headbatched,
        sta_flash_headbatched_mma_sync,
        sta_flash_headbatched_ref,
    )
    from vorta_tpu_torch.ops.sta_row import (
        row_wgmma_path,
        sta_row_attention,
        sta_row_attention_mma_sync,
        sta_row_attention_ref,
        supports_row_dense,
    )
    from vorta_tpu_torch.ops.sta_window import (
        sta_window_attention,
        sta_window_attention_mma_sync,
        sta_window_attention_ref,
    )

    dev = torch.device("cuda")
    wan_act = torch.tensor(ACTIVE_HEADS, device=dev)
    hy_act = torch.tensor(HY_ACTIVE, device=dev)
    out = {"sta_window": {}, "sta_batched": {}, "sta_row": {}}

    # ---- sta_window: Wan 720p (4, 9, 10), where the routed dispatch runs it, and
    # HunyuanVideo 45f (4, 9, 10) with the text tail
    wan = dataclasses.replace(attention_config("wan-1_3B", GRID_720P), sta_tile=WAN_TILE_4910)
    if routed_sta_kernel(wan, 128, 2) != "sta_window":
        raise RuntimeError("Wan 720p (4, 9, 10): the gates do not pick sta_window")
    out["sta_window"]["wan_720p_4910"] = window_case(
        torch, "sta_window", sta_window_attention, sta_window_attention_ref, GRID_720P,
        WAN_TILE_4910, wan_act, mma_sync=sta_window_attention_mma_sync)
    out["sta_window"]["hunyuan_45f_4910_text"] = window_case(
        torch, "sta_window", sta_window_attention, sta_window_attention_ref, GRID_HY_45F,
        WAN_TILE_4910, hy_act, text=True, mma_sync=sta_window_attention_mma_sync)

    # ---- sta_batched: the HunyuanVideo 45f (2, 9, 8) joint layout (1,24,48384,128),
    # pair bits (3 x 7 sub-tiles), the bias of 83 valid text tokens, 16 heads active
    hy = dataclasses.replace(attention_config("hunyuan-13B", GRID_HY_45F), sta_tile=HY_TILE_298)
    jcfg = joint.JointConfig(hy, HY_TEXT)
    if joint.joint_sta_kernel(jcfg, 128, 2) != "sta_batched":
        raise RuntimeError("HunyuanVideo (2, 9, 8): the gates do not pick sta_batched")
    lay = joint.joint_layouts(jcfg)["sta"]
    ki, kc, bits = joint._joint_sta_tables(jcfg).on(dev)
    mask = hy_text_mask(torch, dev)
    bias = joint._bias(mask, lay, hy.seq_len)
    g = torch.Generator(device=dev).manual_seed(51)
    h, d, tpt = 24, 128, hy.tokens_per_tile
    q, k, v = (torch.randn((1, h, lay.total, d), generator=g, device=dev).to(torch.bfloat16)
               for _ in range(3))
    kw = dict(pair_bits=bits, tokens_per_tile=tpt, kv_bias=bias, scale=d**-0.5,
              block_q=lay.block_q, block_kv=lay.block_kv, softmax="fast")
    kern = lambda: sta_flash_headbatched(q, k, v, ki, kc, hy_act, **kw)  # noqa: E731
    plain = lambda: sta_flash_headbatched_ref(q, k, v, ki, kc, hy_act, **kw)  # noqa: E731
    mma = lambda: sta_flash_headbatched_mma_sync(q, k, v, ki, kc, hy_act, **kw)  # noqa: E731
    sta_path_once(torch, "sta_batched (2, 9, 8) joint", kern, True, "sta_batched")
    sta_path_once(torch, "sta_batched (2, 9, 8) joint (the yardstick)", mma, False,
                  "sta_batched")
    got, want = kern(), plain()
    n_act = int(hy_act.sum().item())
    err = compare(torch, f"sta_batched (1,24,{lay.total},128), blocks {lay.block_q}/"
                  f"{lay.block_kv}, pair bits, kv_bias, {n_act} of 24 heads", got, want)
    if got[:, hy_act == 0].any():
        raise RuntimeError("sta_batched: an inactive head wrote non-zeros")
    r = dict(worst_ratio=worst_ratio(torch, got, want))
    for bracket, extra in (("missing_bias", {"kv_bias": None}),
                           ("missing_bits", {"pair_bits": None})):
        miss = sta_flash_headbatched_ref(q, k, v, ki, kc, hy_act, **{**kw, **extra})
        r[f"{bracket}_worst_ratio"] = worst_ratio(torch, miss[:, hy_act > 0],
                                                  want[:, hy_act > 0])
        del miss
        if not r[f"{bracket}_worst_ratio"] > TOL:
            raise RuntimeError(f"sta_batched check cannot tell a {bracket.replace('_', ' ')}")
    del want
    # the pairs this run's data needs: visible (q, kv) sub-tile pairs times the
    # q rows of a sub-tile and the live (bias > -1e30) keys of the kv sub-tile
    vis = torch.from_numpy(joint._joint_sta_subtile_mask(jcfg)[0]).to(dev)
    live = (bias.reshape(-1, tpt) > -1e29).sum(dim=1)
    pairs = int((vis.long() * live[None]).sum().item()) * tpt
    flops = 4.0 * pairs * d * n_act
    b_ms, b_by = bound_ms(flops, 4 * lay.total * d * 2 * n_act + lay.total * 4, PEAK_BF16)
    full = vis.repeat_interleave(tpt, 0).repeat_interleave(tpt, 1)  # (S, S) bool, 2.3 GB
    fmask = torch.where(full, bias.to(torch.bfloat16), float("-inf"))
    del full
    lib, lib_err = masked_sdpa_ms(torch, "sta_batched", *(x[:, hy_act > 0] for x in (q, k, v)),
                                  fmask[None, None])
    del fmask
    torch.cuda.empty_cache()
    # the Hopper path's work: the 128 x 128 products of the slots its CTAs list
    lists = pair_bit_walk(*(x.cpu().numpy() for x in (ki, kc, bits, bias)), block_q=lay.block_q,
                          block_kv=lay.block_kv, tokens_per_tile=tpt)
    slots = sum(len(x) for x in lists)
    r.update(ms=time_ms(torch, kern, 10), plain_ms=time_ms(torch, plain, 2, 1), library_ms=lib,
             bound_ms=b_ms, bound_by=b_by, max_abs_err=err, pairs_per_head=pairs,
             hopper_slots_per_head=slots, hopper_useful_share=pairs / (slots * 128 * 128))
    vs_mma_sync(torch, "sta_batched", r, got, mma, flops)
    del got
    if lib_err:
        r["library_error"] = lib_err
    out["sta_batched"]["hunyuan_45f_298_joint"] = r
    log(f"sta_batched: {pairs:,} visible pairs per head; {r} (achieved "
        f"{flops / r['ms'] / 1e9:.1f} TFLOP/s on {n_act} heads)")
    del q, k, v
    torch.cuda.empty_cache()
    r["mma_sync_softmax_probe"] = probe_sta_batched_softmax(torch,
                                                            sta_flash_headbatched_mma_sync)

    # ---- sta_row, a direct call (no geometry of the port's paths reaches it):
    # Wan 720p (5, 9, 8) and HunyuanVideo 45f (6, 9, 8) with the text tail, both
    # admitted by the JAX package's row-dense gate, on the Hopper path beside
    # its mma.sync kernel
    for name, grid, tile, act, text in (("wan_720p_598", GRID_720P, (5, 9, 8), wan_act, False),
                                        ("hunyuan_45f_698_text", GRID_HY_45F, (6, 9, 8), hy_act,
                                         True)):
        lt = HY_TEXT if text else 0
        if not supports_row_dense(grid, tile, 128, 2, lt):
            raise RuntimeError(f"sta_row {name}: the row-dense gate refuses it")
        if not row_wgmma_path(128, grid, tile, text_len=lt):
            raise RuntimeError(f"sta_row {name}: the Hopper path's rule refuses it")
        out["sta_row"][name] = window_case(torch, "sta_row", sta_row_attention,
                                           sta_row_attention_ref, grid, tile, act, text=text,
                                           seed=52, mma_sync=sta_row_attention_mma_sync)
    return out


def sass_counts(lib: str, entry: str) -> dict:
    """{kernel: counts} of every kernel of ``lib`` (a built csrc library)
    whose mangled name holds ``entry``, from ``cuobjdump -sass``: its
    instructions, branches (BRA), exp2s (MUFU.EX2) and integer divisions by
    a runtime value (I2F.RP, the first instruction of nvcc's division
    sequence), the last also between its first and last mma.sync (HMMA):
    inside the product loop."""
    import shutil

    from vorta_tpu_torch.ops import _build

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    text = subprocess.run([tool, "-sass", str(_build.build_dir() / f"lib{lib}.so")],
                          capture_output=True, text=True, check=True).stdout
    bodies, name = {}, None
    for line in text.splitlines():
        if "Function :" in line:
            name = line.split("Function :")[1].strip()
            name = name if entry in name else None
            if name:
                bodies[name] = []
        elif name and "/*" in line and ";" in line:
            bodies[name].append(line)
    out = {}
    for name, lines in bodies.items():
        hmma = [i for i, line in enumerate(lines) if " HMMA" in line]
        loop = lines[hmma[0]:hmma[-1]] if hmma else []
        out[name] = {"instructions": len(lines),
                     **{op: sum(f" {op}" in line for line in lines)
                        for op in ("BRA", "MUFU.EX2", "I2F.RP")},
                     "I2F.RP_in_product_loop": sum(" I2F.RP" in line for line in loop)}
    return out


def probe_sta_batched_softmax(torch, kernel) -> dict:
    """Why sta_batched's mma.sync kernel runs its stable softmax faster than
    its fast one: ``kernel`` (that kernel's wrapper) timed in both modes on
    the HunyuanVideo (2, 9, 8) joint layout, 16 of 24 heads, with the served
    pair bits and kv_bias, with each of them alone and with neither (every
    visited block whole: the same loads and products in both modes, no
    per-score mask); and the SASS of both instantiations (branches, ex2)."""
    import dataclasses

    from vorta_tpu_torch.cli.sample import attention_config
    from vorta_tpu_torch.ops import joint_experts as joint

    dev = torch.device("cuda")
    hy = dataclasses.replace(attention_config("hunyuan-13B", GRID_HY_45F), sta_tile=HY_TILE_298)
    jcfg = joint.JointConfig(hy, HY_TEXT)
    lay = joint.joint_layouts(jcfg)["sta"]
    ki, kc, bits = joint._joint_sta_tables(jcfg).on(dev)
    bias = joint._bias(hy_text_mask(torch, dev), lay, hy.seq_len)
    g = torch.Generator(device=dev).manual_seed(53)
    q, k, v = (torch.randn((1, 24, lay.total, 128), generator=g, device=dev).to(torch.bfloat16)
               for _ in range(3))
    act = torch.tensor(HY_ACTIVE, device=dev)
    base = dict(tokens_per_tile=hy.tokens_per_tile, scale=128**-0.5, block_q=lay.block_q,
                block_kv=lay.block_kv)
    out = {}
    for case, extra in (("bits_and_bias", dict(pair_bits=bits, kv_bias=bias)),
                        ("bits", dict(pair_bits=bits)), ("bias", dict(kv_bias=bias)),
                        ("neither", {})):
        out[case] = {sm: time_ms(torch, lambda: kernel(q, k, v, ki, kc, act, softmax=sm,
                                                       **base, **extra), 5)
                     for sm in ("fast", "stable")}
    out["sass"] = {("stable" if "Lb1" in n else "fast"): c
                   for n, c in sass_counts("sta_batched", "sta_batched_kernelILi128E").items()}
    log(f"sta_batched mma.sync, fast vs stable (ms, 16 heads): {out}")
    return out


def fallback_kernel_rows(fb: dict) -> list:
    """The kernels line's rows of sta_window, sta_batched and sta_row, each
    with its first shape's numbers on top and all of them under ``shapes``."""
    meta = (("sta_window", "vorta_tpu/ops/sta_window.py:71"),
            ("sta_batched", "vorta_tpu/ops/sta_batched.py:30"),
            ("sta_row", "vorta_tpu/ops/sta_row.py:65"))
    rows = []
    for name, replaces in meta:
        shapes = fb[name]
        first = next(iter(shapes.values()))
        rows.append(dict(name=name, route="cuda", source=f"vorta_tpu_torch/csrc/{name}.cu",
                         replaces=replaces, _counter=name,
                         **{**first, "max_abs_err": max(x["max_abs_err"] for x in shapes.values())},
                         shapes=shapes))
    return rows


def routed_wan_launches(tables, sta_kernel: str, n_fwd: int, dispatch: str = "masked",
                        int8: bool = False) -> dict:
    """Kernel launches of hard-routed Wan forwards from their routing tables
    (forwards, blocks, heads) under a dispatch: "masked" (the default: each
    routed expert once per block, the pool in active mode), "batched" (the
    pool and unpool in head-map mode), "hybrid" (a pool and an unpool per
    LOWRES head) or "switch" (each head its own expert: a flash_manual per
    FULL / LOWRES head, an STA launch per STA head).  Every flash,
    flash_manual and sta_pipe launch takes the Hopper path, every prologue
    launch the warp-per-row kernel, every unpool launch the batched 16-byte
    copy; ``int8``: flash_manual in the int8 QK
    mode.  The STA kernel is sta_pipe, or sta_window at a tile whose window
    sta_pipe's gate refuses (every one of its served launches on the Hopper
    path too)."""
    from vorta_tpu_torch.ops import _build

    has = [(tables == e).any(-1) for e in range(3)]  # per (forward, block)
    heads = [(tables == e).sum(-1) for e in range(3)]
    blocks = tables.shape[1]
    out = {**dict.fromkeys(_build.KERNELS, 0), "flash": blocks * n_fwd,
           "fused_norm": (2 * blocks + 1) * n_fwd, "prologue": blocks * n_fwd,
           "prologue_rows": blocks * n_fwd,
           "flash_manual": int(has[0].sum() + has[1].sum()), sta_kernel: int(has[2].sum()),
           "pool_qkv": int(has[1].sum()), "unpool": int(has[1].sum())}
    if dispatch == "batched":
        out.update(pool_qkv=0, unpool=0, pool_qkv_headmap=int(has[1].sum()),
                   unpool_headmap=int(has[1].sum()))
    elif dispatch in ("hybrid", "switch"):
        out.update(pool_qkv=int(heads[1].sum()), unpool=int(heads[1].sum()))
    if dispatch == "switch":
        out.update({"flash_manual": int(heads[0].sum() + heads[1].sum()),
                    sta_kernel: int(heads[2].sum())})
    for k in HOPPER_KERNELS:
        out[f"{k}_wgmma"] = out[k]
    out["unpool_rows"] = out["unpool"] + out["unpool_headmap"]
    out["flash_manual_int8"] = out["flash_manual"] if int8 else 0
    return out


# the JAX package's alternative routed dispatches: (variable, value, name)
DISPATCHES = (("VORTA_LOWRES_DISPATCH", "batched", "batched"),
              ("VORTA_LOWRES_DISPATCH", "hybrid", "hybrid"),
              ("VORTA_ROUTED_DISPATCH", "switch", "switch"))


def dispatch_env(var=None, value=None):
    """A with-block with one dispatch variable set (none for the masked
    dispatch), the environment restored after it."""
    import os
    from unittest import mock

    return mock.patch.dict(os.environ, {var: value} if var else {})


def run_wan_fallback_path(torch, card: str):
    """cli.sample --resume_dir at Wan-1.3B 720p x 77f (72,000 tokens, 30
    blocks, routed hard by random routers), from the config.json that
    ``cli.train --sta_tile 4 9 10`` writes at 720p: the STA heads run
    sta_window; 2 UniPC steps with CFG = 4 forwards after a warm-up forward
    of a 2-block model; launch counts exact, sta_pipe never."""
    import dataclasses

    import numpy as np

    from vorta_tpu_torch.cli.sample import main as sample_main
    from vorta_tpu_torch.cli.train import attention_config as train_attention_config
    from vorta_tpu_torch.cli.train import parse_args as train_args
    from vorta_tpu_torch.config import WAN_1_3B
    from vorta_tpu_torch.models.wan import WanModel
    from vorta_tpu_torch.ops import _build

    run_dir = HERE / "results" / "port_smoke" / "wan_720p_4910"
    attn = train_attention_config(train_args([
        "--synthetic_data", "--output_dir", str(run_dir), "--video_height", "720",
        "--video_width", "1280", "--sta_tile", *map(str, WAN_TILE_4910)]))
    if attn.latent_shape != GRID_720P:
        raise RuntimeError(f"trainer geometry {attn.latent_shape}")
    run_dir.mkdir(parents=True, exist_ok=True)
    attn.save(run_dir / "config.json")  # the file the trainer writes
    warm = WanModel(dataclasses.replace(WAN_1_3B, num_layers=2), dtype=torch.bfloat16,
                    device="cuda", seed=1)
    warm(torch.randn((1, 20, 90, 160, 16), device="cuda"), torch.tensor([900.0], device="cuda"),
         torch.randn((1, TEXT_LEN, 4096), device="cuda"), attn_cfg=attn, routing_mode="hard")
    del warm
    torch.cuda.synchronize()
    _build.reset_launches()
    res = sample_main(["--model", "wan-1_3B", "--random_embeds", "--num_frames", "77",
                       "--height", "720", "--width", "1280", "--num_inference_steps", "2",
                       "--seed", "0", "--device", "cuda", "--resume_dir", str(run_dir),
                       "--output", str(run_dir / "latents.npy")])
    launches = dict(_build.launches)
    lat = res.latents
    if tuple(lat.shape) != (1, 20, 90, 160, 16) or not torch.isfinite(lat).all():
        raise RuntimeError(f"Wan (4, 9, 10) path: output {tuple(lat.shape)}, finite "
                           f"{bool(torch.isfinite(lat).all())}")
    tables = np.stack(res.routing)
    if tables.shape != (4, 30, 12):
        raise RuntimeError(f"Wan (4, 9, 10) path: routing tables {tables.shape}")
    heads = np.bincount(tables.reshape(-1), minlength=3)
    expected = routed_wan_launches(tables, "sta_window", 4)
    if launches != expected or launches["sta_pipe"]:
        raise RuntimeError(f"Wan (4, 9, 10) path launches {launches} != expected {expected}")
    served_on_wgmma(launches, "Wan (4, 9, 10) path")
    if not (heads > 0).all():
        raise RuntimeError(f"Wan (4, 9, 10) path: an expert got no head: {heads}")
    per_step = res.denoise_s / res.steps
    log(f"Wan (4, 9, 10) path: Wan-1.3B 30 blocks, 720p x 77f = 72,000 tokens, --resume_dir "
        f"config.json (sta_tile {WAN_TILE_4910}), routing hard, 2 UniPC steps x CFG: "
        f"{res.denoise_s:.3f} s ({per_step:.3f} s/step; model build {res.build_s:.1f} s) on "
        f"{card}; heads per expert over the run: full {heads[0]}, lowres {heads[1]}, sta "
        f"{heads[2]}; launches {launches} (exact); output std {lat.std().item():.4f}")
    return launches, per_step


def run_hunyuan_fallback_path(torch, card: str):
    """cli.sample --model hunyuan-13B --resume_dir at 720p x 45f (43,200 +
    256 tokens, 60 blocks, routed hard by random routers), from a
    config.json with the CLI's geometry but sta_tile (2, 9, 8): the STA heads
    run sta_batched over the joint layout (432 / 1008 blocks); 2 Euler steps
    after warm-up forwards of a 1 + 1-block model; launch counts exact,
    sta_pipe never."""
    import dataclasses

    import numpy as np

    from vorta_tpu_torch.cli.sample import attention_config
    from vorta_tpu_torch.cli.sample import main as sample_main
    from vorta_tpu_torch.ops import _build

    run_dir = HERE / "results" / "port_smoke" / "hunyuan_45f_298"
    attn = dataclasses.replace(attention_config("hunyuan-13B", GRID_HY_45F),
                               sta_tile=HY_TILE_298)
    run_dir.mkdir(parents=True, exist_ok=True)
    attn.save(run_dir / "config.json")
    hy_warm_up(torch, GRID_HY_45F, ("hard",), attn)
    _build.reset_launches()
    res = sample_main(["--model", "hunyuan-13B", "--random_embeds", "--num_frames", "45",
                       "--height", "720", "--width", "1280", "--num_inference_steps", "2",
                       "--seed", "0", "--device", "cuda", "--resume_dir", str(run_dir),
                       "--output", str(run_dir / "latents.npy")])
    launches = dict(_build.launches)
    lat = res.latents
    if tuple(lat.shape) != (1, 12, 90, 160, 16) or not torch.isfinite(lat).all():
        raise RuntimeError(f"Hunyuan (2, 9, 8) path: output {tuple(lat.shape)}, finite "
                           f"{bool(torch.isfinite(lat).all())}")
    tables = np.stack(res.routing)
    if tables.shape != (2, 60, 24):
        raise RuntimeError(f"Hunyuan (2, 9, 8) path: routing tables {tables.shape}")
    heads = np.bincount(tables.reshape(-1), minlength=3)
    expected = hy_hard_launches(tables, sta_kernel="sta_batched")
    if launches != expected or launches["sta_pipe"]:
        raise RuntimeError(f"Hunyuan (2, 9, 8) path launches {launches} != expected {expected}")
    served_on_wgmma(launches, "Hunyuan (2, 9, 8) path")
    if not (heads > 0).all():
        raise RuntimeError(f"Hunyuan (2, 9, 8) path: an expert got no head: {heads}")
    per_step = res.denoise_s / res.steps
    log(f"Hunyuan (2, 9, 8) path: HunyuanVideo-13B 20 + 40 blocks, 43,200 + 256 tokens (all "
        f"text valid, --random_embeds), --resume_dir config.json (sta_tile {HY_TILE_298}), "
        f"routing hard, 2 Euler steps: {res.denoise_s:.3f} s ({per_step:.3f} s/step; model "
        f"build {res.build_s:.1f} s) on {card}; heads per expert over the run: full "
        f"{heads[0]}, lowres {heads[1]}, sta {heads[2]}; launches {launches} (exact); output "
        f"std {lat.std().item():.4f}; peak {torch.cuda.max_memory_allocated() / 2**30:.1f} GiB")
    return launches, per_step


# ---- quantized serving --------------------------------------------------------

# the card's dense int8 tensor-core rate (data sheet), the QK product of the
# int8 modes; their PV product stays bf16
PEAK_INT8 = 1979e12
# the JAX package's quality gate for int8 QK (tests/test_routed_fused.py):
# mean |int8 - bf16| / mean |bf16| over the routed heads
INT8_GATE = 0.05


def mean_rel(got, ref) -> float:
    got, ref = got.float(), ref.float()
    return ((got - ref).abs().mean() / ref.abs().mean().clamp(min=1e-6)).item()


def int8_bound(qk_flops: float, pv_flops: float, nbytes: float) -> tuple:
    t_ops = (qk_flops / PEAK_INT8 + pv_flops / PEAK_BF16) * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def int8_case(torch, name, kern8, plain8, bracket, kern16, act, flops, nbytes, lib, rows=None):
    """One int8 QK kernel check: the kernel against its plain version on the
    same int8 q / k (tolerance TOL), heads routed away zero, the plain
    version with qk_scale ignored (the bracket) failing the tolerance, the
    quality gate against the bf16 mode on the unquantized q / k, and times.
    ``flops``: (QK, PV) operations; ``rows``: the output rows compared."""
    cut = (lambda x: x) if rows is None else (lambda x: x[:, :, :rows])
    got, want = cut(kern8()), cut(plain8())
    err = compare(torch, name, got, want)
    if got[:, act == 0].any():
        raise RuntimeError(f"{name}: a head routed away wrote non-zeros")
    ratio = worst_ratio(torch, got, want)
    miss = worst_ratio(torch, cut(bracket())[:, act > 0], want[:, act > 0])
    log(f"{name}, the plain version with qk_scale ignored: worst ratio {miss:.3e} (must fail "
        f"the tolerance {TOL:g})")
    if miss <= TOL:
        raise RuntimeError(f"{name}: the check cannot tell a missing qk_scale")
    rel = mean_rel(got[:, act > 0], cut(kern16())[:, act > 0])
    log(f"{name}: mean |int8 - bf16| / mean |bf16| = {rel:.4f} (gate {INT8_GATE})")
    if not rel < INT8_GATE:
        raise RuntimeError(f"{name}: the int8 mode fails the quality gate against bf16")
    del got, want
    b_ms, b_by = int8_bound(*flops, nbytes)
    # without qk_scale the int8 sums overflow exp2: the bracket's output is
    # not finite, which JSON cannot hold as a number
    r = dict(ms=time_ms(torch, kern8, 5), bf16_ms=time_ms(torch, kern16, 5),
             plain_ms=time_ms(torch, plain8, 1, 1), library_ms=lib(), bound_ms=b_ms,
             bound_by=b_by, max_abs_err=err, worst_ratio=ratio,
             bracket_worst_ratio=miss if abs(miss) < float("inf") else "non-finite",
             mean_rel_vs_bf16=rel)
    with_rate(r, sum(flops))
    log(f"{name}: {r} (int8 / bf16 time {r['ms'] / r['bf16_ms']:.3f})")
    return r


def check_int8_kernels(torch, card: str) -> dict:
    """flash_manual's and sta_pipe's int8 QK modes at the main paths' shapes
    (Wan-1.3B 480p x 77f FULL and LOWRES, 8 of 12 heads routed; the
    HunyuanVideo-13B 720p x 45f FULL joint layout with kv_bias, 16 of 24;
    sta_pipe at the 480p tile and with Hunyuan's text tail), q and k unit-RMS
    bf16 quantized per head as the dispatch does; and W8A8 at the Wan FFN's
    shapes.  Returns {"flash_manual_int8": {...}, "sta_pipe_int8": {...},
    "w8a8": {...}}."""
    import numpy as np
    import torch.nn.functional as F

    from vorta_tpu_torch.cli.sample import attention_config
    from vorta_tpu_torch.ops import joint_experts as joint
    from vorta_tpu_torch.ops.flash import dense_tables
    from vorta_tpu_torch.ops.flash_manual import (
        sparse_flash_attention_manual,
        sparse_flash_attention_manual_ref,
    )
    from vorta_tpu_torch.ops.qmm import int8_linear, int8_matmul_ref
    from vorta_tpu_torch.ops.routed_fused import quantize_per_head, quantize_qk, routed_geometry
    from vorta_tpu_torch.ops.sta_pipe import sta_pipe_attention, sta_pipe_attention_ref

    dev = torch.device("cuda")
    bf16 = torch.bfloat16
    d = 128
    scale = d**-0.5
    g = torch.Generator(device=dev).manual_seed(50)

    def randn(*shape):  # unit RMS: the scale of qk-normed q/k
        return torch.randn(shape, generator=g, device=dev).to(bf16)

    out = {"flash_manual_int8": {}, "sta_pipe_int8": {}}

    # ---- flash_manual: Wan FULL / LOWRES, and Hunyuan's FULL joint layout + kv_bias
    wan = attention_config("wan-1_3B", GRID_480P_77F)
    geo = routed_geometry(wan)
    hy = joint.JointConfig(attention_config("hunyuan-13B", GRID_HY_45F), HY_TEXT)
    hy_full = joint.joint_layouts(hy)["full"]
    hy_bias = joint._bias(hy_text_mask(torch, dev), hy_full, hy.video.seq_len)
    cases = (  # name, heads routed, padded length, blocks, tables, kv_valid_len, bias, rows, keys
        ("wan_full_31200", ACTIVE_HEADS, geo.full.q_pad, geo.full.block_q,
         geo.full.tables.on(dev), geo.full.valid_len, None, geo.full.valid_len,
         geo.full.valid_len),
        ("wan_lowres_15600", ACTIVE_HEADS, geo.lowres.q_pad, geo.lowres.block_q,
         geo.lowres.tables.on(dev), geo.lowres.valid_len, None, geo.lowres.valid_len,
         geo.lowres.valid_len),
        ("hunyuan_full_joint", HY_ACTIVE, hy_full.total, hy_full.block_q,
         dense_tables(hy_full.total // hy_full.block_q, hy_full.total // hy_full.block_q).on(dev),
         None, hy_bias, None, hy.video.seq_len + HY_VALID),
    )
    for name, heads, n, block, (ki, kc), valid, bias, rows, keys in cases:
        act = torch.tensor(heads, device=dev)
        n_act = int(act.sum().item())
        h = act.numel()
        q, k, v = (randn(1, h, n, d) for _ in range(3))
        q8, k8, qk_scale = quantize_qk(q, k)
        cnt = torch.where(act[:, None] > 0, kc, 0).to(torch.int32)
        kw = dict(scale=scale, block_q=block, block_kv=block, kv_valid_len=valid, kv_bias=bias,
                  softmax="fast")
        kw8 = dict(kw, qk_scale=qk_scale)
        qa, ka, va = (x[:, act > 0, :keys] for x in (q, k, v))
        fmask = None if bias is None else bias[:, :keys].to(bf16)[None, None]
        q_rows = rows or n
        out["flash_manual_int8"][name] = int8_case(
            torch, f"flash_manual int8 {name} (1,{h},{n},128), {n_act} of {h} heads routed",
            lambda: sparse_flash_attention_manual(q8, k8, v, ki, cnt, **kw8),
            lambda: sparse_flash_attention_manual_ref(q8, k8, v, ki, cnt, **kw8),
            lambda: sparse_flash_attention_manual_ref(q8.to(bf16), k8.to(bf16), v, ki, cnt, **kw),
            lambda: sparse_flash_attention_manual(q, k, v, ki, cnt, **kw),
            act, (2.0 * q_rows * keys * d * n_act,) * 2,
            (q_rows * d * 3 + keys * d * 3) * n_act,  # int8 q / k, bf16 v / out
            lambda: time_ms(torch, lambda: F.scaled_dot_product_attention(
                qa, ka, va, attn_mask=fmask), 5, 1),
            rows=rows)
        del q, k, v, q8, k8, qa, ka, va
        torch.cuda.empty_cache()

    # ---- sta_pipe: Wan's 480p tile, and Hunyuan's 432-token tiles with the text tail
    cases = (
        ("wan_480p_77f", ACTIVE_HEADS, GRID_480P_77F, (4, 6, 4), 0),
        ("hunyuan_45f_text_tail", HY_ACTIVE, GRID_HY_45F, (6, 9, 8), HY_TEXT),
    )
    for name, heads, grid, tile, lt in cases:
        act = torch.tensor(heads, device=dev, dtype=torch.int32)
        n_act = int(act.sum().item())
        h = act.numel()
        n = int(np.prod(grid))
        q, k, v = (randn(1, h, n, d) for _ in range(3))
        kw = dict(latent_shape=grid, tile=tile, window=(3, 3, 3), scale=scale)
        text = 0
        if lt:  # text_k shares k's per-head scale: quantized together
            tk, tv = randn(1, h, lt, d), randn(1, h, lt, d)
            q8, sq = quantize_per_head(q)
            kt8, sk = quantize_per_head(torch.cat([k, tk], dim=2))
            k8, tk8, qk_scale = kt8[:, :, :n], kt8[:, :, n:], sq * sk
            tail = dict(text_v=tv, text_bias=joint._text_bias(hy_text_mask(torch, dev)))
            kw8 = dict(kw, qk_scale=qk_scale, text_k=tk8, **tail)
            kw.update(tail, text_k=tk)
            bracket_kw = dict(kw8, text_k=tk8.to(bf16), qk_scale=None)
            text = HY_VALID
        else:
            q8, k8, qk_scale = quantize_qk(q, k)
            kw8 = dict(kw, qk_scale=qk_scale)
            bracket_kw = kw
        keys = int(np.prod([min(3, grid[a] // tile[a]) * tile[a] for a in range(3)])) + text
        qa, ka, va = (x[:, act > 0] for x in (q, k, v))
        out["sta_pipe_int8"][name] = int8_case(
            torch, f"sta_pipe int8 {name} (1,{h},{n},128), tile {tile}, {n_act} of {h} heads",
            lambda: sta_pipe_attention(q8, k8, v, act, **kw8),
            lambda: sta_pipe_attention_ref(q8, k8, v, act, **kw8),
            lambda: sta_pipe_attention_ref(q8.to(bf16), k8.to(bf16), v, act, **bracket_kw),
            lambda: sta_pipe_attention(q, k, v, act, **kw),
            act, (2.0 * n * keys * d * n_act,) * 2,
            (n * d * 4 + 3 * lt * d) * n_act,
            lambda: time_ms(torch, lambda: F.scaled_dot_product_attention(qa, ka, va), 3, 1))
        out["sta_pipe_int8"][name]["library"] = "SDPA over the whole sequence, no mask"
        sta_path_once(torch, f"sta_pipe int8 {name}",
                      lambda: sta_pipe_attention(q8, k8, v, act, **kw8), False)
        del q, k, v, q8, k8, qa, ka, va
        torch.cuda.empty_cache()

    # ---- W8A8 at the Wan FFN's shapes: 31,200 x 1,536 -> 8,960 and back.  The
    # plain version takes the int8 product in f64 (exact): the outputs agree
    # to the last bit but for the output rounding
    w8 = {}
    m = int(np.prod(GRID_480P_77F))
    for name, kin, kout in (("ffn_in_1536_8960", 1536, 8960), ("ffn_out_8960_1536", 8960, 1536)):
        x = randn(1, m, kin).mul_(3.0)
        w = (torch.randn((kout, kin), generator=g, device=dev) * kin**-0.5).to(bf16)
        b = randn(kout)
        kern = lambda: int8_linear(x, w, b)  # noqa: E731
        plain = lambda: int8_linear(x, w, b, matmul=int8_matmul_ref)  # noqa: E731
        got, want = kern(), plain()
        torch.cuda.synchronize()
        ratio = worst_ratio(torch, got, want)
        log(f"W8A8 {name}: worst |int8_linear - plain| / max(|plain|, RMS) {ratio:.3e} "
            f"(tolerance 2^-8, one bf16 ulp: the int32 sums are exact)")
        if not ratio <= 2.0**-8:
            raise RuntimeError(f"W8A8 {name}: int8_linear disagrees with its plain version")
        rel = mean_rel(got, F.linear(x, w, b))
        del got, want
        flops = 2.0 * m * kin * kout
        b_ms, b_by = bound_ms(flops, (m * kin + kin * kout + m * kout) * 2, PEAK_INT8)
        w8[name] = dict(ms=time_ms(torch, kern, 10), bf16_linear_ms=time_ms(
            torch, lambda: F.linear(x, w, b), 10), plain_ms=time_ms(torch, plain, 2, 1),
            bound_ms=b_ms, bound_by=b_by, worst_ratio=ratio, mean_rel_vs_bf16=rel)
        log(f"W8A8 {name}: {w8[name]} (int8 / bf16 nn.Linear "
            f"{w8[name]['ms'] / w8[name]['bf16_linear_ms']:.3f})")
        del x, w, b
    out["w8a8"] = w8
    return out


def int8_kernel_rows(int8: dict) -> list:
    """The int8 QK modes' rows of the kernels line: flash_manual's (launched
    on the int8 main paths) as a row of its own; sta_pipe's, which no main
    path runs (the STA expert stays bf16 under qk_int8, as in the JAX
    package), under the sta_pipe row's ``modes``."""
    fm = int8["flash_manual_int8"]
    first = fm["wan_full_31200"]
    return [dict(name="flash_manual (int8 QK mode)", route="cuda",
                 source="vorta_tpu_torch/csrc/flash_manual.cu",
                 replaces="vorta_tpu/ops/flash_manual.py:125", _counter="flash_manual_int8",
                 **{**first, "max_abs_err": max(x["max_abs_err"] for x in fm.values())},
                 shapes=fm)]


def run_static_scales(torch, card: str) -> dict:
    """Calibrate on the card (calibrate_mm: each site's per-layer max |x|)
    over one Wan-1.3B forward at 480p x 77f, routed hard, W8A8; then the
    same forward with those static scales (amax / 127), against the dynamic
    one: its distance and both times."""
    from vorta_tpu_torch.cli.sample import attention_config
    from vorta_tpu_torch.config import WAN_1_3B
    from vorta_tpu_torch.models.wan import WanModel

    model = WanModel(WAN_1_3B, dtype=torch.bfloat16, device="cuda", seed=0)
    g = torch.Generator(device="cuda").manual_seed(3)
    t_grid, h_grid, w_grid = GRID_480P_77F
    lat = torch.randn((1, t_grid, 2 * h_grid, 2 * w_grid, 16), generator=g, device="cuda")
    ctx = torch.randn((1, TEXT_LEN, 4096), generator=g, device="cuda")
    t = torch.tensor([700.0], device="cuda")
    attn = attention_config("wan-1_3B", GRID_480P_77F)
    kw = dict(attn_cfg=attn, routing_mode="hard", mm_precision="int8")
    calib = model(lat, t, ctx, calibrate_mm=True, **kw).mm_calibration
    scales = {site: amax / 127.0 for site, amax in calib.items()}
    log(f"calibration: {len(scales)} sites x {len(next(iter(scales.values())))} layers: "
        + ", ".join(f"{k} [{v.min().item():.3g}, {v.max().item():.3g}]"
                    for k, v in sorted(scales.items())))
    res = {}
    for name, extra in (("dynamic", {}), ("static", {"act_scales": scales}),
                        ("bf16", {"mm_precision": "bf16"})):
        run = lambda: model(lat, t, ctx, **{**kw, **extra}).sample  # noqa: E731
        res[name] = run()
        res[f"{name}_ms"] = time_ms(torch, run, 2, 1)
    rel_static = ((res["static"].float() - res["dynamic"].float()).norm()
                  / res["dynamic"].float().norm()).item()
    rel_bf16 = ((res["dynamic"].float() - res["bf16"].float()).norm()
                / res["bf16"].float().norm()).item()
    if not torch.isfinite(res["static"]).all():
        raise RuntimeError("static-scale forward: non-finite output")
    out = {"rel_l2_static_vs_dynamic": rel_static, "rel_l2_dynamic_vs_bf16": rel_bf16,
           **{k: v for k, v in res.items() if k.endswith("_ms")}}
    log(f"static int8 scales (480p x 77f, hard, W8A8, one forward): {out} on {card}")
    del model
    return out


def run_quantized_blocks(torch, card: str) -> dict:
    """Wan-14B (40 blocks, dim 5120) served from an int4 stack through a
    depth-1 model: one hard-routed forward at 480p x 77f (its stack's GiB,
    time and peak memory); then a 2-block check, the card against the CPU
    (f32, plain versions) on the same quantized stack."""
    import dataclasses
    import gc

    import numpy as np

    from vorta_tpu_torch.cli.sample import attention_config
    from vorta_tpu_torch.config import WAN_14B, AttentionConfig
    from vorta_tpu_torch.io.quant_serving import build_quantized_wan
    from vorta_tpu_torch.models.wan import WanModel

    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    model, stack = build_quantized_wan(WAN_14B, bits=4, seed=0, device="cuda")
    torch.cuda.synchronize()
    build_s = time.time() - t0
    stack_gib = stack.nbytes / 2**30
    g = torch.Generator(device="cuda").manual_seed(4)
    t_grid, h_grid, w_grid = GRID_480P_77F
    lat = torch.randn((1, t_grid, 2 * h_grid, 2 * w_grid, 16), generator=g, device="cuda")
    ctx = torch.randn((1, TEXT_LEN, 4096), generator=g, device="cuda")
    attn = attention_config("wan-1_3B", GRID_480P_77F)
    t0 = time.time()
    res = model(lat, torch.tensor([700.0], device="cuda"), ctx, attn_cfg=attn,
                routing_mode="hard", quantized_blocks=stack)
    torch.cuda.synchronize()
    fwd_ms = (time.time() - t0) * 1e3
    if tuple(res.sample.shape) != tuple(lat.shape) or not torch.isfinite(res.sample).all():
        raise RuntimeError("Wan-14B int4 forward: wrong shape or non-finite output")
    heads = np.bincount(res.expert_ids.reshape(-1), minlength=3)
    out = dict(stack_gib=stack_gib, build_s=build_s, forward_ms=fwd_ms,
               peak_gib=torch.cuda.max_memory_allocated() / 2**30,
               heads=dict(zip(("full", "lowres", "sta"), heads.tolist())))
    del res, lat, ctx
    # the 2-block check: the first two layers of the same stack, routing off,
    # 160 tokens, the non-block weights carried to the CPU model
    two = stack.first_layers(2)
    cpu = WanModel(dataclasses.replace(WAN_14B, num_layers=1), dtype=torch.float32,
                   device="meta").to_empty(device="cpu")
    cpu.load_state_dict(model.state_dict())
    grid = (2, 8, 10)
    g = torch.Generator().manual_seed(5)
    lat = torch.randn((1, grid[0], 2 * grid[1], 2 * grid[2], 16), generator=g)
    ctx = torch.randn((1, TEXT_LEN, 4096), generator=g)
    t = torch.tensor([700.0])
    a = AttentionConfig(latent_shape=grid)
    got = model(lat.cuda(), t.cuda(), ctx.cuda(), attn_cfg=a, quantized_blocks=two)
    want = cpu(lat, t, ctx, attn_cfg=a, quantized_blocks=two.to("cpu")).sample
    got = got.sample.float().cpu()
    rel = ((got - want).norm() / want.norm()).item()
    out["two_block_rel_l2"] = rel
    log(f"Wan-14B from an int4 stack (40 blocks, dim 5120): stack {stack_gib:.2f} GiB, built "
        f"{build_s:.1f} s; one forward 480p x 77f routed hard {fwd_ms:.1f} ms on {card}; peak "
        f"{out['peak_gib']:.2f} GiB; heads {out['heads']}; 2-block check card bf16 vs CPU f32 "
        f"on the same stack: rel L2 {rel:.4f} (tolerance 0.05)")
    if not rel < 0.05:
        raise RuntimeError("Wan-14B int4 2-block check: the card disagrees with the CPU")
    del model, stack, two, cpu
    gc.collect()
    return out


# ---- serving the way users run it: checkpoints, the step cache, I2V ----------

def synthetic_checkpoint(torch, shapes: dict, seed: int) -> dict:
    """{diffusers key: bf16 CPU tensor} drawn on the card from ``seed``:
    matrices at Flax's lecun scale (std 1/sqrt(fan in)), AdaLN tables at
    1/sqrt(dim), norm gains 1 + 0.02 N, biases 0.02 N."""
    import numpy as np

    g = torch.Generator(device="cuda").manual_seed(seed)
    out = {}
    for key, shape in shapes.items():
        w = torch.randn(shape, generator=g, device="cuda")
        if "scale_shift_table" in key:
            w = w / shape[-1] ** 0.5
        elif len(shape) >= 2:
            w = w / float(np.prod(shape[1:])) ** 0.5
        elif "norm" in key and key.endswith(".weight"):
            w = 1.0 + 0.02 * w
        else:
            w = 0.02 * w
        out[key] = w.to(torch.bfloat16).cpu()
    return out


def save_shards(torch, sd: dict, path: Path, n: int = 2) -> None:
    """``sd`` as ``n`` diffusers-style safetensors shards under ``path``."""
    from safetensors.torch import save_file

    path.mkdir(parents=True)
    keys = sorted(sd)
    for i in range(n):
        save_file({k: sd[k] for k in keys[i::n]},
                  str(path / f"diffusion_pytorch_model-{i + 1:05d}-of-{n:05d}.safetensors"))


# diffusers key pattern -> the port's parameter name, applied in order (the
# first match wins); the fused projections and the half-RoPE rows are below
WAN_RENAMES = ((r"\.to_out\.0\.", ".to_out."), (r"\.ffn\.net\.0\.proj\.", ".ffn.proj_in."),
               (r"\.ffn\.net\.2\.", ".ffn.proj_out."), (r"\.ff\.net\.0\.proj\.", ".proj_in."),
               (r"\.ff\.net\.2\.", ".proj_out."), (r"\.(norm[12])\.weight$", r".\1.scale"))
HY_RENAMES = (
    (r"^x_embedder\.proj\.", "x_embedder."),
    (r"^context_embedder\.time_text_embed\.timestep_embedder\.", "context_embedder.time_embedder."),
    (r"^context_embedder\.time_text_embed\.text_embedder\.linear_1\.",
     "context_embedder.text_pool_embedder."),
    (r"^context_embedder\.time_text_embed\.text_embedder\.linear_2\.",
     "context_embedder.text_pool_out."),
    (r"^context_embedder\.token_refiner\.refiner_blocks\.(\d+)\.attn\.to_out\.0\.",
     r"context_embedder.blocks.\1.to_out."),
    (r"^context_embedder\.token_refiner\.refiner_blocks\.(\d+)\.attn\.",
     r"context_embedder.blocks.\1."),
    (r"^context_embedder\.token_refiner\.refiner_blocks\.(\d+)\.norm_out\.",
     r"context_embedder.blocks.\1.gates."),
    (r"^context_embedder\.token_refiner\.refiner_blocks\.(\d+)\.(norm[12])\.weight$",
     r"context_embedder.blocks.\1.\2.scale"),
    (r"^context_embedder\.token_refiner\.refiner_blocks\.", "context_embedder.blocks."),
    (r"^time_text_embed\.text_embedder\.linear_([12])\.", r"time_text_embed.text_embedder_\1."),
    (r"^transformer_blocks\.(\d+)\.norm1\.", r"dual_blocks.\1.norm1_mod."),
    (r"^transformer_blocks\.(\d+)\.norm1_context\.", r"dual_blocks.\1.norm1_context_mod."),
    (r"^transformer_blocks\.", "dual_blocks."),
    (r"^single_transformer_blocks\.(\d+)\.norm\.", r"single_blocks.\1.norm_mod."),
    (r"^single_transformer_blocks\.", "single_blocks."),
    (r"^norm_out\.", "norm_out_mod."))
HY_AFTER = ((r"\.to_out\.0\.", ".to_out."), (r"\.net\.0\.proj\.", ".proj_in."),
            (r"\.net\.2\.", ".proj_out."))
# (prefix of the parts, the parts in order, the fused name, the parts whose
# rows take the half-RoPE permutation)
WAN_FUSED = (("attn1.", ("to_q", "to_k", "to_v"), "qkv", ("to_q", "to_k")),)
HY_FUSED = {"dual_blocks": (("attn.", ("to_q", "to_k", "to_v"), "qkv", ("to_q", "to_k")),
                            ("attn.", ("add_q_proj", "add_k_proj", "add_v_proj"), "add_qkv",
                             ("add_q_proj", "add_k_proj"))),
            "single_blocks": (("", ("attn.to_q", "attn.to_k", "attn.to_v", "proj_mlp"), "qkv_mlp",
                               ("attn.to_q", "attn.to_k")),)}


def half_rows(n: int, head_dim: int):
    """Row order of the contiguous-half RoPE layout: each head's even rows,
    then its odd ones."""
    import numpy as np

    per = np.concatenate([np.arange(0, head_dim, 2), np.arange(1, head_dim, 2)])
    return (np.arange(n // head_dim)[:, None] * head_dim + per[None]).reshape(-1)


def expected_port_state(torch, sd: dict, kind: str, head_dim: int) -> dict:
    """The port's parameters from a diffusers state dict, mapped here on the
    host on its own (renames, the fused projections concatenated, the q / k
    rows and gains of the self- / joint attention permuted): what the
    importer must have loaded, bit for bit."""
    import re

    first, after = ((), WAN_RENAMES) if kind == "wan" else (HY_RENAMES, HY_AFTER)
    out = {}
    for key, t in sd.items():
        name = key
        for pat, rep in first:  # the first match wins
            new = re.sub(pat, rep, name)
            if new != name:
                name = new
                break
        for pat, rep in after:
            name = re.sub(pat, rep, name)
        if re.search(r"(attn1|\.attn)\.norm_(q|k|added_q|added_k)\.weight$", name):
            t = t[torch.from_numpy(half_rows(t.shape[0], head_dim))]
        out[name] = t
    stacks = ({"blocks": WAN_FUSED} if kind == "wan" else HY_FUSED)
    for stack, groups in stacks.items():
        layers = sorted({int(k.split(".")[1]) for k in out if k.startswith(stack + ".")})
        for i in layers:
            for prefix, parts, fused, permuted in groups:
                base = f"{stack}.{i}.{prefix}"
                for p in ("weight", "bias"):
                    pieces = []
                    for part in parts:
                        t = out.pop(f"{base}{part}.{p}")
                        if part in permuted:
                            t = t[torch.from_numpy(half_rows(t.shape[0], head_dim))]
                        pieces.append(t)
                    out[f"{base}{fused}.{p}"] = torch.cat(pieces)
    return out


def check_loaded(torch, model, expected: dict, what: str, skip=()) -> int:
    """Every parameter of ``model`` equals its mapped source tensor bit for
    bit (cast to the parameter's dtype on the host); returns the count."""
    params = model.state_dict()
    names = sorted(k for k in params if not k.startswith(skip))
    missing = sorted(set(names) - set(expected))
    if missing:
        raise RuntimeError(f"{what}: no source tensor for {missing[:6]}")
    bad = [k for k in names if not torch.equal(params[k].cpu(), expected[k].to(params[k].dtype))]
    if bad:
        raise RuntimeError(f"{what}: {len(bad)} parameters differ from the mapped source, e.g. "
                           f"{bad[:6]}")
    return len(names)


def spied_sample(torch, argv: list, pipeline: str):
    """cli.sample's main(argv) and the model its pipeline served."""
    from unittest import mock

    from vorta_tpu_torch.cli import sample

    seen = {}
    cls = getattr(sample, pipeline)
    real = cls.__call__

    def spy(pipe, *args, **kw):
        seen["model"], seen["blocks"] = pipe.model, pipe.quantized_blocks
        return real(pipe, *args, **kw)

    with mock.patch.object(cls, "__call__", spy):
        res = sample.main(argv)
    return res, seen


def run_torch_import_path(torch, card: str) -> dict:
    """A synthetic diffusers Wan 2.1 T2V-1.3B checkpoint (full width, 30
    blocks, random bf16 from a seed, diffusers' key names, two safetensors
    shards) and a reference router.pt through cli.sample --torch_checkpoint
    --router_checkpoint (480p x 77f, routed hard, 2 UniPC steps with CFG),
    then the same with --quantize_blocks int8; HunyuanVideo-13B's key set at
    2 + 2 blocks (validated, loaded, 2 routed Euler steps at 720p x 45f).
    Every parameter equals the host's own mapping of its source tensor;
    launch counts exact."""
    import gc
    import tempfile

    import numpy as np

    from vorta_tpu_torch.config import WAN_1_3B
    from vorta_tpu_torch.io import torch_import as ti
    from vorta_tpu_torch.ops import _build
    from vorta_tpu_torch.ops.quant import QTensor

    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        t0 = time.time()
        sd = synthetic_checkpoint(torch, ti.wan_expected_shapes(WAN_1_3B), 15)
        routers = synthetic_checkpoint(torch, {
            f"blocks.{i}.router.linear.{p}": sh for i in range(30)
            for p, sh in (("weight", (36, 1536)), ("bias", (36,)))}, 16)
        save_shards(torch, sd, tmp / "wan")
        torch.save(routers, tmp / "router.pt")
        n_params = sum(t.numel() for t in sd.values())
        log(f"torch_import: synthetic Wan 2.1 T2V-1.3B checkpoint, {len(sd)} tensors, "
            f"{n_params / 1e9:.3f} B parameters in bf16, 2 shards + router.pt, written in "
            f"{time.time() - t0:.1f} s")
        expected = expected_port_state(torch, {**sd, **routers}, "wan", 128)
        argv = ["--model", "wan-1_3B", "--torch_checkpoint", str(tmp / "wan"),
                "--router_checkpoint", str(tmp / "router.pt"), "--random_embeds",
                "--num_inference_steps", "2", "--seed", "0", "--device", "cuda"]
        for name, extra in (("wan", []), ("wan_int8_blocks", ["--quantize_blocks", "int8"])):
            _build.reset_launches()
            res, seen = spied_sample(torch, argv + extra + [
                "--output", str(HERE / "results" / "port_smoke" / f"import_{name}.npy")],
                "WanT2VPipeline")
            launches = dict(_build.launches)
            lat = res.latents
            if tuple(lat.shape) != (1, 20, 60, 104, 16) or not torch.isfinite(lat).all():
                raise RuntimeError(f"torch_import {name}: output {tuple(lat.shape)}")
            tables = np.stack(res.routing)
            want = routed_wan_launches(tables, "sta_pipe", tables.shape[0])
            if tables.shape != (4, 30, 12) or launches != want:
                raise RuntimeError(f"torch_import {name}: launches {launches} != {want}")
            served_on_wgmma(launches, f"torch_import {name}")
            if seen["blocks"] is None:
                n = check_loaded(torch, seen["model"], expected, f"torch_import {name}")
            else:  # the depth-1 model's non-block modules; the stack's routers
                n = check_loaded(torch, seen["model"], expected, f"torch_import {name}",
                                 skip=("blocks.",))
                w = seen["blocks"].leaves["['router']['linear']['kernel'].value"]
                want_w = torch.stack([routers[f"blocks.{i}.router.linear.weight"].t()
                                      for i in range(30)])
                if not torch.equal(w.cpu(), want_w):
                    raise RuntimeError("torch_import: the merged routers differ")
                n_q = sum(isinstance(v, QTensor) for v in seen["blocks"].leaves.values())
                log(f"torch_import {name}: {n_q} of {len(seen['blocks'].leaves)} stacked leaves "
                    f"quantized, {seen['blocks'].nbytes / 2**30:.2f} GiB")
            heads = np.bincount(tables.reshape(-1), minlength=3)
            out[name] = dict(s_per_step=res.denoise_s / res.steps, build_s=res.build_s,
                             launches=launches)
            log(f"torch_import {name}: {n} parameters equal their mapped source tensors bit for "
                f"bit; 2 UniPC steps x CFG routed at 480p x 77f {res.denoise_s:.3f} s "
                f"({res.denoise_s / res.steps:.3f} s/step, load + build {res.build_s:.1f} s) on "
                f"{card}; heads full {heads[0]}, lowres {heads[1]}, sta {heads[2]}; launches "
                f"exact")
            del res, seen, lat
            gc.collect()
            torch.cuda.empty_cache()
        del sd, routers, expected
        out["hunyuan"] = run_hunyuan_import(torch, card, tmp)
    return out


def run_hunyuan_import(torch, card: str, tmp: Path) -> dict:
    """HunyuanVideo-13B's diffusers key set at 2 dual + 2 single blocks,
    routers included: validated against the importer's expected keys (and
    the full 20 + 40 set's count), loaded into the port's model, every
    parameter held to the host's mapping, 2 routed Euler steps at 720p x 45f
    with exact launches."""
    import dataclasses
    import gc

    import numpy as np
    from safetensors.torch import save_file

    from vorta_tpu_torch.cli.sample import attention_config
    from vorta_tpu_torch.io import torch_import as ti
    from vorta_tpu_torch.models.hunyuan import HUNYUAN_13B, HunyuanModel
    from vorta_tpu_torch.ops import _build
    from vorta_tpu_torch.pipelines.hunyuan_t2v import HunyuanSamplingConfig, HunyuanT2VPipeline

    cfg = dataclasses.replace(HUNYUAN_13B, dual_layers=2, single_layers=2)
    shapes = ti.hunyuan_expected_shapes(cfg, routers=True)
    full = ti.hunyuan_expected_keys(20, 40, 2, routers=True)
    checks = (ti.validate_hunyuan_checkpoint_keys(shapes, 2, 2, 2),
              ti.validate_hunyuan_checkpoint_keys(full, 20, 40, 2))
    if checks != (([], []), ([], [])):
        raise RuntimeError(f"Hunyuan key validation: {checks}")
    sd = synthetic_checkpoint(torch, shapes, 17)
    save_file(sd, str(tmp / "hunyuan.safetensors"))
    model = HunyuanModel(cfg, dtype=torch.bfloat16, device="cuda", seed=0)
    applied, missing = ti.load_hunyuan_torch_weights(model, tmp / "hunyuan.safetensors")
    if missing:
        raise RuntimeError(f"Hunyuan import: the model lacks {missing[:6]}")
    n = check_loaded(torch, model, expected_port_state(torch, sd, "hunyuan", 128),
                     "Hunyuan import")
    del sd
    gc.collect()
    lat, text, mask, pooled = hy_inputs(torch, GRID_HY_45F, torch.device("cuda"), 11)
    pipe = HunyuanT2VPipeline(model, attn_cfg=attention_config("hunyuan-13B", GRID_HY_45F))
    routing = []
    _build.reset_launches()
    t0 = time.time()
    final = pipe(lat, text, mask, pooled, sampling=HunyuanSamplingConfig(
        num_inference_steps=2, routing_mode="hard"), routing=routing)
    torch.cuda.synchronize()
    dt = time.time() - t0
    launches = dict(_build.launches)
    tables = np.stack(routing)
    want = hy_hard_launches(tables)
    want.update(prologue=4 * 2, prologue_rows=4 * 2, fused_norm=(4 * 2 + 2 + 1) * 2)
    if launches != want or not torch.isfinite(final).all():
        raise RuntimeError(f"Hunyuan import: launches {launches} != {want}, or non-finite")
    served_on_wgmma(launches, "Hunyuan import 2 + 2 blocks")
    log(f"Hunyuan import: 13B key set ({len(full)} keys at 20 + 40 blocks) validated; 2 + 2 "
        f"blocks loaded, {n} parameters equal their mapped source tensors bit for bit; 2 Euler "
        f"steps routed at 720p x 45f {dt:.3f} s on {card}; launches exact")
    del model, pipe, final
    gc.collect()
    torch.cuda.empty_cache()
    return dict(parameters=n, launches=launches)


def replay_cache(inds, threshold: float, coeffs, warmup: int, follow=None) -> list:
    """cache_decision replayed on the host in f64 over the indicators of a
    trajectory: [(host's skip, |acc - threshold|)] a step, each step after
    the card's decision where ``follow`` gives it, else the host's own."""
    import numpy as np

    out, prev, acc, valid, n = [], None, 0.0, False, len(inds)
    for i, ind in enumerate(inds):
        d = 0.0
        if prev is not None:
            d = np.abs(ind - prev).mean() / (np.abs(prev).mean() + 1e-8)
            if coeffs:
                d = float(np.polyval(np.asarray(coeffs, np.float64), d))
            d = max(d, 0.0)
        a = acc + d
        skip = valid and a < threshold and not (i < warmup or i == n - 1)
        out.append((skip, abs(a - threshold)))
        taken = skip if follow is None else follow[i]
        acc, valid, prev = (a if taken else 0.0), (valid or not taken), ind
    return out


def run_step_cache_path(torch, card: str) -> dict:
    """Wan-1.3B at 720p x 77f routed by the trained router (and the time
    embedder it was trained against), 10 UniPC steps with CFG, the fitted
    polynomial: uncached and cached at a threshold that skips some steps,
    through the pipeline's stepper; the skip flags against the host's f64
    replay, launches exact (the computed forwards' kernels; a skipped one
    only its head's norm), the host syncs of each step counted (PyTorch's
    sync debug mode), a computed step's as many as uncached; threshold 0 over the first SHORT steps of
    the same schedule bit for bit the uncached trajectory's state there."""
    import gc
    import warnings
    from types import SimpleNamespace

    import numpy as np

    from vorta_tpu_torch.cli.sample import load_cache_poly
    from vorta_tpu_torch.config import WAN_1_3B, AttentionConfig
    from vorta_tpu_torch.io.from_jax import load_jax_params, load_router_npz
    from vorta_tpu_torch.models.wan import WanModel
    from vorta_tpu_torch.ops import _build
    from vorta_tpu_torch.pipelines.wan_t2v import SamplingConfig, WanT2VPipeline, make_schedule

    steps, poly_path = 10, "assets/cache_poly_wan1_3b_720p.npz"
    coeffs = load_cache_poly(SimpleNamespace(cache_poly=str(HERE / poly_path)))
    model = WanModel(WAN_1_3B, dtype=torch.bfloat16, device="cuda", seed=0)
    load_router_npz(model, HERE / ROUTER_720P)
    load_jax_params(model, HERE / TEMB_720P)
    attn = AttentionConfig(latent_shape=GRID_720P, sta_tile=(5, 9, 8), sta_window=(3, 3, 3),
                           lowres_window=(2, 3, 2), tau_sparse=0.3)
    g = torch.Generator(device="cuda").manual_seed(21)
    lat = torch.randn((1, 20, 90, 160, 16), generator=g, device="cuda")
    pe = torch.randn((1, TEXT_LEN, 4096), generator=g, device="cuda")
    ne = torch.zeros_like(pe)
    pipe = WanT2VPipeline(model, attn_cfg=attn)
    base = SamplingConfig(num_inference_steps=steps, routing_mode="hard")
    sched = make_schedule(base)
    # the indicator each forward reads: temb6 at the step's timestep, f32
    inds = [model.condition_embedder(torch.full((1,), float(t), device="cuda"),
                                     pe.to(model.dtype))[1]
            .reshape(1, -1).float().cpu().double().numpy() for t in sched.timesteps]
    # the threshold: of a fixed ladder, the one whose host replay skips
    # closest to 4 of the 8 free steps, every sum at least 0.01 from it
    best = None
    for thr in (0.05, 0.1, 0.15, 0.2, 0.3, 0.4, 0.5, 0.75, 1.0, 1.5, 2.0):
        host = replay_cache(inds, thr, coeffs, 1)
        n_skip = sum(skip for skip, _ in host)
        if 0 < n_skip < steps - 2 and min(gap for _, gap in host[1:-1]) > 1e-2 and (
                best is None or abs(n_skip - 4) < abs(best[1] - 4)):
            best = (thr, n_skip)
    if best is None:
        raise RuntimeError("step cache: no threshold of the ladder skips some but not all "
                           "steps")
    thr = best[0]
    model(lat, torch.tensor([500.0], device="cuda"), pe, attn_cfg=attn,
          routing_mode="hard")  # warm-up
    torch.cuda.synchronize()
    short = 2  # steps of the threshold-0 run

    def trajectory(sampling, n_run, routing, cache_log):
        """The pipeline's loop (WanT2VPipeline.__call__) over the first
        ``n_run`` steps: (final latents, the latents after ``short`` steps,
        host syncs per step)."""
        init, step_fn, _ = pipe.make_stepper(sampling)
        carry, kept, syncs = init(lat), None, []
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                for i in range(n_run):
                    carry = step_fn(carry, i, pe, ne, routing=routing, cache_log=cache_log)
                    syncs.append(sum("synchronizing CUDA operation" in str(w.message)
                                     for w in caught) - sum(syncs))
                    if i == short - 1:
                        kept = carry[0].clone()
            finally:
                torch.cuda.set_sync_debug_mode("default")
        return carry[0], kept, syncs

    runs = {}
    for name, threshold, n_run in (("uncached", 0.0, steps), ("cached", thr, steps),
                                   ("threshold_0", 0.0, short)):
        sampling = SamplingConfig(num_inference_steps=steps, routing_mode="hard",
                                  cache_threshold=threshold, cache_warmup=1,
                                  cache_coefficients=coeffs if name != "uncached" else None)
        routing, cache_log = [], []
        _build.reset_launches()
        t0 = time.time()
        final, kept, syncs = trajectory(sampling, n_run, routing, cache_log)
        torch.cuda.synchronize()
        dt = time.time() - t0
        launches = dict(_build.launches)
        if not torch.isfinite(final).all():
            raise RuntimeError(f"step cache {name}: non-finite latents")
        skipped = sum(s for *_, s in cache_log)
        computed = 2 * n_run - skipped
        tables = np.stack(routing)
        want = routed_wan_launches(tables, "sta_pipe", computed)
        want["fused_norm"] += skipped  # a skipped forward runs only its head's norm
        if tables.shape[0] != computed or launches != want:
            raise RuntimeError(f"step cache {name}: launches {launches} != {want} "
                               f"({computed} forwards computed)")
        served_on_wgmma(launches, f"step cache {name}")
        runs[name] = dict(final=final, kept=kept, log=cache_log, s_per_step=dt / n_run,
                          computed_forwards=computed, launches=launches, syncs=syncs)
        log(f"step cache {name}: Wan-1.3B 720p x 77f routed, {n_run} of {steps} UniPC steps x "
            f"CFG, threshold {threshold}: {dt:.3f} s ({dt / n_run:.3f} s per denoise step) on "
            f"{card}; {computed} of {2 * n_run} forwards computed; launches exact; "
            f"host syncs per step {syncs}")
    flags = [s for _, arm, s in runs["cached"]["log"] if arm == 0]
    if [s for _, arm, s in runs["cached"]["log"] if arm == 1] != flags:
        raise RuntimeError("step cache: the CFG arms decided apart on one indicator")
    replay = replay_cache(inds, thr, coeffs, 1, follow=flags)
    off = [(i, gap) for i, ((host, gap), card_skip) in enumerate(zip(replay, flags))
           if host != card_skip]
    if any(gap >= 1e-4 for _, gap in off):
        raise RuntimeError(f"step cache: the card's skips {flags} differ from the host's "
                           f"replay {[h for h, _ in replay]} away from the threshold: {off}")
    if runs["threshold_0"]["log"] or not torch.equal(runs["threshold_0"]["final"],
                                                     runs["uncached"]["kept"]):
        raise RuntimeError("step cache: threshold 0 is not the uncached trajectory bit for bit")
    # the cache adds no sync: a step whose forwards all ran syncs as often as uncached
    ran = [i for i, s in enumerate(flags) if not s]
    if any(runs["cached"]["syncs"][i] != runs["uncached"]["syncs"][i] for i in ran):
        raise RuntimeError(f"step cache: host syncs per step {runs['cached']['syncs']} cached, "
                           f"{runs['uncached']['syncs']} uncached")
    rel = ((runs["cached"]["final"] - runs["uncached"]["final"]).norm()
           / runs["uncached"]["final"].norm()).item()
    log(f"step cache: threshold {thr} ({poly_path}) skipped steps "
        f"{[i for i, s in enumerate(flags) if s]} of {steps}; the card's flags equal the host's "
        f"f64 replay ({len(off)} near-threshold flips); threshold 0 bit for bit the uncached "
        f"trajectory over its first {short} steps; host syncs per step "
        f"{runs['cached']['syncs']} cached, {runs['uncached']['syncs']} uncached; cached vs uncached latents rel L2 {rel:.4f}; s per "
        f"denoise step cached {runs['cached']['s_per_step']:.3f}, uncached "
        f"{runs['uncached']['s_per_step']:.3f}")
    out = dict(threshold=thr, skipped_steps=[i for i, s in enumerate(flags) if s],
               rel_l2_vs_uncached=rel,
               **{f"{k}_{m}": runs[k][m] for k in ("uncached", "cached")
                  for m in ("s_per_step", "computed_forwards", "syncs")},
               launches={k: runs[k]["launches"] for k in runs})
    del model, pipe, runs, lat, pe, ne
    gc.collect()
    torch.cuda.empty_cache()
    return out


def check_image_attention(torch, card: str) -> dict:
    """The I2V image cross-attention, (1,12,31200,128) x 257 image keys
    (block_q 2048, block_kv 512, kv_valid_len 257: one valid key in the
    third 128-key slot, a fourth all padding), on the Hopper path against
    its plain version (the padded keys hold random values, which a row
    seeing them would weigh), timed beside SDPA."""
    import torch.nn.functional as F

    from vorta_tpu_torch.ops import _build
    from vorta_tpu_torch.ops.experts import padded_dense_attention
    from vorta_tpu_torch.ops.flash import (dense_tables, sparse_flash_attention_raw,
                                           sparse_flash_attention_ref, wgmma_path)

    dev, h, d, s, nk = torch.device("cuda"), 12, 128, 31200, 257
    g = torch.Generator(device=dev).manual_seed(31)
    sp = -(-s // 2048) * 2048
    q, k, v = (torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)
               for shape in ((1, h, sp, d), (1, h, 512, d), (1, h, 512, d)))
    ti, tc = dense_tables(sp // 2048, 1).on(dev)
    kw = dict(scale=d**-0.5, block_q=2048, block_kv=512, kv_valid_len=nk)
    if not wgmma_path(d, 2048, 512):
        raise RuntimeError("image cross-attention: not on the Hopper path")
    _build.reset_launches()
    got = padded_dense_attention(q[:, :, :s], k[:, :, :nk], v[:, :, :nk])
    torch.cuda.synchronize()
    if (_build.launches["flash"], _build.launches["flash_wgmma"]) != (1, 1):
        raise RuntimeError(f"image cross-attention: launches {dict(_build.launches)}")
    flash = lambda: sparse_flash_attention_raw(q, k, v, ti, tc, **kw)  # noqa: E731
    plain = lambda: sparse_flash_attention_ref(q, k, v, ti, tc, **kw)  # noqa: E731
    want = plain()[:, :, :s]
    err = compare(torch, "flash image cross-attention (1,12,31200,128) x 257 (the model's "
                  "padded_dense_attention call)", got, want)
    err = max(err, compare(torch, "flash image cross-attention, the raw call", flash()[:, :, :s],
                           want))
    seen = sparse_flash_attention_ref(q, k, v, ti, tc, **{**kw, "kv_valid_len": None})
    miss = worst_ratio(torch, seen[:, :, :s], want)
    if not miss > TOL:
        raise RuntimeError("image cross-attention check cannot tell padded keys seen")
    del seen, want
    flops = 4.0 * s * nk * d * h
    b_ms, b_by = bound_ms(flops, (2 * h * s * d + 2 * h * nk * d) * 2, PEAK_BF16)
    t = with_rate(dict(ms=time_ms(torch, flash, 20), plain_ms=time_ms(torch, plain, 3, 1),
                       library_ms=time_ms(torch, lambda: F.scaled_dot_product_attention(
                           q[:, :, :s], k[:, :, :nk], v[:, :, :nk]), 20),
                       bound_ms=b_ms, bound_by=b_by, max_abs_err=err,
                       padded_keys_seen_ratio=miss), flops)
    log(f"flash image cross-attention on {card}: {t}")
    return t


def check_i2v_model(torch) -> None:
    """2 blocks at Wan-1.3B widths with image_dim 1280, 257 image tokens:
    card (bf16, kernels) vs CPU (f32, plain versions), rel L2 < 0.05."""
    import dataclasses

    from vorta_tpu_torch.config import WAN_1_3B, AttentionConfig
    from vorta_tpu_torch.models.wan import WanModel

    cfg = dataclasses.replace(WAN_1_3B, num_layers=2, image_dim=1280)
    grid = (2, 8, 10)
    attn = AttentionConfig(latent_shape=grid)
    ref_model = WanModel(cfg, dtype=torch.float32, device="cpu", seed=7)
    gpu_model = WanModel(cfg, dtype=torch.bfloat16, device="cuda", seed=7)
    gpu_model.load_state_dict(ref_model.state_dict())
    g = torch.Generator().manual_seed(8)
    lat = torch.randn((1, grid[0], 2 * grid[1], 2 * grid[2], 16), generator=g)
    ctx = torch.randn((1, TEXT_LEN, cfg.text_dim), generator=g)
    img = torch.randn((1, 257, 1280), generator=g)
    t = torch.tensor([700.0])
    want = ref_model(lat, t, ctx, attn_cfg=attn, image_context=img).sample
    got = gpu_model(lat.cuda(), t.cuda(), ctx.cuda(), attn_cfg=attn,
                    image_context=img.cuda()).sample.float().cpu()
    text_only = ref_model(lat, t, ctx, attn_cfg=attn).sample
    rel = ((got - want).norm() / want.norm()).item()
    moved = ((want - text_only).norm() / want.norm()).item()
    log(f"I2V model check (2 blocks, 1.3B widths, image_dim 1280, 257 image tokens, 160 "
        f"tokens): rel L2 err card bf16 vs CPU f32 = {rel:.4f} (tolerance 0.05); the image "
        f"tokens move the CPU's output by {moved:.4f}")
    if not torch.isfinite(got).all() or not rel < 0.05 or not moved > 10 * rel:
        raise RuntimeError("I2V model check: the card disagrees with the CPU, or the image "
                           "branch changes nothing")


def run_i2v_path(torch, card: str) -> dict:
    """cli.sample --image_embeds (257 x 1280 CLIP tokens in a .npy): Wan-1.3B
    with image_dim 1280, 480p x 77f routed hard, 2 UniPC steps with CFG;
    every flash launch (self, text and image cross-attention) on the Hopper
    path, launches exact."""
    import gc

    import numpy as np

    from vorta_tpu_torch.ops import _build

    path = HERE / "results" / "port_smoke" / "image_embeds.npy"
    path.parent.mkdir(parents=True, exist_ok=True)
    np.save(path, np.random.default_rng(3).standard_normal((257, 1280)).astype(np.float32))
    _build.reset_launches()
    res, seen = spied_sample(torch, [
        "--model", "wan-1_3B", "--image_embeds", str(path), "--random_embeds",
        "--num_inference_steps", "2", "--seed", "0", "--device", "cuda", "--output",
        str(HERE / "results" / "port_smoke" / "latents_i2v.npy")], "WanT2VPipeline")
    launches = dict(_build.launches)
    if seen["model"].cfg.image_dim != 1280:
        raise RuntimeError("I2V path: the model took no image_dim from the file")
    lat = res.latents
    tables = np.stack(res.routing)
    want = routed_wan_launches(tables, "sta_pipe", tables.shape[0])
    n = tables.shape[0] * tables.shape[1]  # one image cross-attention a block
    want.update(flash=want["flash"] + n, flash_wgmma=want["flash_wgmma"] + n)
    if (tuple(lat.shape) != (1, 20, 60, 104, 16) or not torch.isfinite(lat).all()
            or launches != want):
        raise RuntimeError(f"I2V path: output {tuple(lat.shape)}, launches {launches} != {want}")
    served_on_wgmma(launches, "I2V path")
    log(f"I2V path: Wan-1.3B + image branch (image_dim 1280, 257 tokens), 480p x 77f routed, "
        f"2 UniPC steps x CFG: {res.denoise_s:.3f} s ({res.denoise_s / res.steps:.3f} s/step) "
        f"on {card}; launches exact, every flash launch on the Hopper path")
    out = dict(s_per_step=res.denoise_s / res.steps, launches=launches)
    del res, seen, lat
    gc.collect()
    torch.cuda.empty_cache()
    return out


def run_token_replace_path(torch, card: str) -> dict:
    """HunyuanVideo-13B (20 + 40 blocks) with image_condition_type=
    "token_replace" at 720p x 45f, routed hard, one Euler step through the
    pipeline: the first frame's 3,600 rows take tr_emb's modulation, every
    video norm run as two row ranges (fused_norm_range), launches exact."""
    import dataclasses
    import gc

    import numpy as np

    from vorta_tpu_torch.cli.sample import attention_config
    from vorta_tpu_torch.models.hunyuan import HUNYUAN_13B, HunyuanModel
    from vorta_tpu_torch.ops import _build
    from vorta_tpu_torch.pipelines.hunyuan_t2v import HunyuanSamplingConfig, HunyuanT2VPipeline

    cfg = dataclasses.replace(HUNYUAN_13B, image_condition_type="token_replace")
    model = HunyuanModel(cfg, dtype=torch.bfloat16, device="cuda", seed=0)
    lat, text, mask, pooled = hy_inputs(torch, GRID_HY_45F, torch.device("cuda"), 12)
    pipe = HunyuanT2VPipeline(model, attn_cfg=attention_config("hunyuan-13B", GRID_HY_45F))
    sampling = HunyuanSamplingConfig(num_inference_steps=1, routing_mode="hard")
    routing = []
    pipe(lat, text, mask, pooled, sampling=sampling)  # warm-up
    torch.cuda.synchronize()
    _build.reset_launches()
    t0 = time.time()
    final = pipe(lat, text, mask, pooled, sampling=sampling, routing=routing)
    torch.cuda.synchronize()
    dt = time.time() - t0
    launches = dict(_build.launches)
    want = hy_hard_launches(np.stack(routing))
    # the video norms (2 a dual block, 1 a single block) run as two ranges each
    want.update(fused_norm=want["fused_norm"] + 20 * 2 + 40, fused_norm_range=2 * (20 * 2 + 40))
    if launches != want or not torch.isfinite(final).all():
        raise RuntimeError(f"token replace: launches {launches} != {want}, or non-finite")
    served_on_wgmma(launches, "token replace")
    log(f"token replace: HunyuanVideo-13B 720p x 45f routed, 1 Euler step {dt:.3f} s on {card}; "
        f"{launches['fused_norm_range']} norm launches over row ranges (the first frame's "
        f"{GRID_HY_45F[1] * GRID_HY_45F[2]:,} rows apart); launches exact")
    del model, pipe, final
    gc.collect()
    torch.cuda.empty_cache()
    return dict(s_per_step=dt, launches=launches)


# ---- prompt to video: text encoders, VAEs, cli.sample --prompt / --decode ---------

PROMPT = "a cat walking on grass at sunset, cinematic shot"
# HunyuanVideo wraps the prompt in its instruction template: 95 template
# tokens cropped in front of the 256 the DiT reads (diffusers' crop_start)
HY_CROP = 95


def rel_l2(torch, got, want) -> float:
    got, want = got.float().cpu(), want.float().cpu()
    return ((got - want).norm() / want.norm()).item()


def param_gib(model) -> float:
    return sum(p.numel() * p.element_size() for p in model.parameters()) / 2**30


def encoder_specs():
    """name: (port class, full-size config, tokens, valid tokens, call)."""
    from vorta_tpu_torch.models.text_encoders import (CLIP_L, LLAMA_8B, CLIPTextEncoder,
                                                      LlamaTextEncoder)
    from vorta_tpu_torch.models.umt5 import UMT5_XXL, UMT5Encoder

    return {
        "umt5_xxl": (UMT5Encoder, UMT5_XXL, TEXT_LEN, 100, lambda m, ids, mask: m(ids, mask)),
        "llama_8b": (LlamaTextEncoder, LLAMA_8B, HY_TEXT + HY_CROP, HY_CROP + HY_VALID,
                     lambda m, ids, mask: m(ids, mask, crop_start=HY_CROP)),
        "clip_l": (CLIPTextEncoder, CLIP_L, 77, 77, lambda m, ids, mask: m(ids)),
    }


def encoder_inputs(torch, vocab: int, n: int, valid: int, seed: int):
    gen = torch.Generator().manual_seed(seed)
    ids = torch.randint(3, vocab, (1, n), generator=gen)
    return ids, torch.arange(n)[None] < valid


def run_text_encoders(torch, card: str) -> dict:
    """UMT5-XXL (24 layers, 4,096 wide), Llama-8B (32 layers) and CLIP-L (12)
    on the card, random bf16 weights from a seed: ms per encode of one
    prompt (UMT5: 512 tokens, 100 valid; Llama: 256 + 95 template tokens,
    cropped to 256; CLIP: 77) after warm-up, with the parameter GiB and the
    bound (2 x non-embedding parameters x tokens at the bf16 peak, or the
    weights' bytes).  Gates, each encoder at 2 layers at full width (its
    token table cut to 4,096 rows: a table size, not arithmetic): the card
    in bf16 against the CPU in f32 with the same weights, rel L2 < 0.05;
    UMT5's padded rows exactly zero on the card, as encode_prompt_wan gives
    them."""
    import dataclasses
    import gc

    out = {}
    for i, (name, (cls, cfg, n, valid, call)) in enumerate(encoder_specs().items()):
        small = dataclasses.replace(cfg, num_layers=2, vocab_size=4096)
        cpu = cls(small, dtype=torch.float32, device="cpu", seed=i)
        gpu = cls(small, dtype=torch.bfloat16, device="cuda", seed=i)
        gpu.load_state_dict(cpu.state_dict())
        ids, mask = encoder_inputs(torch, small.vocab_size, n, valid, 20 + i)
        got = call(gpu, ids.cuda(), mask.cuda())
        want = call(cpu, ids, mask)
        err = rel_l2(torch, got, want)
        if not (err < 0.05 and torch.isfinite(got.float()).all()):
            raise RuntimeError(f"{name}: 2 layers on the card vs the CPU, rel L2 {err:.4f}")
        if name == "umt5_xxl" and not (got[~mask.cuda()] == 0).all():
            raise RuntimeError("umt5: padded rows are not zero on the card")
        del cpu, gpu, got, want
        gc.collect()
        torch.cuda.empty_cache()
        model = cls(cfg, dtype=torch.bfloat16, device="cuda", seed=i)
        ids, mask = encoder_inputs(torch, cfg.vocab_size, n, valid, 30 + i)
        ids, mask = ids.cuda(), mask.cuda()
        ms = time_ms(torch, lambda: call(model, ids, mask), iters=5)
        body = sum(p.numel() for k, p in model.named_parameters()
                   if "embed" not in k and "position" not in k)
        flops = 2.0 * body * n
        bound, by = bound_ms(flops, body * 2.0, PEAK_BF16)
        out[name] = dict(ms=ms, param_gib=param_gib(model), tokens=n, layers=cfg.num_layers,
                         bound_ms=bound, bound_by=by, tflops=flops / ms / 1e9,
                         check_rel_l2_2_layers=err)
        log(f"text encoder {name}: {cfg.num_layers} layers, {out[name]['param_gib']:.2f} GiB of "
            f"bf16 weights, {n} tokens: {ms:.3f} ms per encode on {card} (bound {bound:.3f} ms "
            f"by {by}, {out[name]['tflops']:.0f} TFLOP/s); 2 layers card vs CPU rel L2 {err:.4f}")
        del model
        gc.collect()
        torch.cuda.empty_cache()
    return out


def decode_flops(torch, cls, cfg, z_shape, tiled: bool) -> float:
    """The decode's operations, counted on the meta device: 2 x outputs x
    (inputs x taps) of every convolution and 2 x outputs x width of the
    mid-block attention's products (the tiles' own work where tiled)."""
    from vorta_tpu_torch.models import wan_vae
    from vorta_tpu_torch.models.vae_tiling import tiled_decode

    vae = cls(cfg, dtype=torch.bfloat16, device="meta")
    count = [0.0]
    conv, bmm = wan_vae.F.conv3d, torch.bmm

    def conv_n(x, w, *args):
        y = conv(x, w, *args)
        count[0] += 2.0 * y.numel() * w[0].numel()
        return y

    def bmm_n(a, b):
        y = bmm(a, b)
        count[0] += 2.0 * y.numel() * a.shape[-1]
        return y

    z = torch.zeros(z_shape, device="meta")
    wan_vae.F.conv3d, torch.bmm = conv_n, bmm_n
    try:
        if tiled:
            tiled_decode(lambda zz: vae.decode(zz, denormalize=False), z)
        else:
            vae.decode(z, denormalize=False)
    finally:
        wan_vae.F.conv3d, torch.bmm = conv, bmm
    return count[0]


def conv3d_probe(torch) -> dict:
    """What one cuDNN conv3d does over the Wan decoder's widest input at
    480p x 77f: x (1, 192, 77, 480, 832) bf16, 5.9e9 elements (over 2^31),
    3 x 3 x 3 to 96 channels, padding 1.  Either it raises (recorded) or
    its frames 0 and 76 are held against the same frames computed from
    their three input frames alone."""
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda").manual_seed(40)
    x = torch.randn((1, 192, 77, 480, 832), generator=gen, device="cuda", dtype=torch.bfloat16)
    w = (torch.randn((96, 192, 3, 3, 3), generator=gen, device="cuda") / 72.0).bfloat16()
    out = dict(input=list(x.shape), input_elements=x.numel())
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    try:
        y = F.conv3d(x, w, padding=1)
        torch.cuda.synchronize()
    except (RuntimeError, torch.OutOfMemoryError) as e:
        out.update(ok=False, error=f"{type(e).__name__}: {str(e).splitlines()[0][:300]}")
        log(f"conv3d probe over {x.numel():,} elements raised: {out['error']}")
        del x, w
        torch.cuda.empty_cache()
        return out
    out.update(ok=True, s=time.time() - t0,
               peak_gib=torch.cuda.max_memory_allocated() / 2**30)
    errs = []
    for t in (0, 76):  # the frame from input frames t - 1, t, t + 1 (zeros past the ends)
        piece = F.pad(x[:, :, max(t - 1, 0):t + 2], (0, 0, 0, 0, int(t == 0), int(t == 76)))
        errs.append(rel_l2(torch, y[:, :, t], F.conv3d(piece, w, padding=(0, 1, 1))[:, :, 0]))
    out["rel_l2_frames_0_76"] = errs
    log(f"conv3d probe over {x.numel():,} elements ran in {out['s']:.3f} s, peak "
        f"{out['peak_gib']:.2f} GiB; frames 0 and 76 against their pieces: rel L2 {errs}")
    del x, w, y
    torch.cuda.empty_cache()
    return out


def vae_gates(torch) -> dict:
    """Both VAEs at full width: (a) a (1, 3, 8, 8) latent decoded on the
    card in bf16 against the CPU in f32, same weights, rel L2 < 0.05; (b)
    on the card in f32 (TF32 off), the decode in chunks of at most 2^24
    elements against one call over the whole clip, at (1, 6, 30, 52) (21
    frames of 240 x 416), rel L2 <= 1e-3; the same in bf16 reported (other
    call shapes let cuDNN pick other algorithms, whose bf16 roundings then
    differ) and held < 0.05; (c) tiled_decode at a single-tile shape
    (1, 4, 16, 16) is the whole-clip decode, bit for bit."""
    import gc

    from vorta_tpu_torch.models import hunyuan_vae as hv
    from vorta_tpu_torch.models import wan_vae as wv
    from vorta_tpu_torch.models.vae_tiling import tiled_decode

    def chunked_vs_whole(vae, z):
        with wv.chunk_budget(1 << 24):
            chunked = vae.decode(z)
        with wv.chunk_budget(1 << 62):
            whole = vae.decode(z)
        return rel_l2(torch, chunked, whole)

    out = {}
    gen = torch.Generator().manual_seed(41)
    for name, cls, cfg in (("wan", wv.WanVAE, wv.WAN_VAE), ("hunyuan", hv.HunyuanVAE,
                                                           hv.HUNYUAN_VAE)):
        cpu = cls(cfg, dtype=torch.float32, device="cpu", seed=1)
        gpu = cls(cfg, dtype=torch.bfloat16, device="cuda", seed=1)
        gpu.load_state_dict(cpu.state_dict())
        z = torch.randn((1, 3, 8, 8, 16), generator=gen)
        cpu_err = rel_l2(torch, gpu.decode(z.cuda()), cpu.decode(z))
        gpu32 = cls(cfg, dtype=torch.float32, device="cuda", seed=1)
        gpu32.load_state_dict(cpu.state_dict())
        del cpu
        z = torch.randn((1, 6, 30, 52, 16), generator=gen).cuda()
        chunk_err = chunked_vs_whole(gpu32, z)
        del gpu32
        chunk_err_bf16 = chunked_vs_whole(gpu, z)
        z = torch.randn((1, 4, 16, 16, 16), generator=gen).cuda()
        tiled = tiled_decode(lambda zz: gpu.decode(zz, denormalize=False), z)
        single = torch.equal(tiled, gpu.decode(z, denormalize=False))
        out[name] = dict(card_vs_cpu_rel_l2=cpu_err, chunked_vs_whole_rel_l2_f32=chunk_err,
                         chunked_vs_whole_rel_l2_bf16=chunk_err_bf16, single_tile_exact=single)
        log(f"VAE {name}: card bf16 vs CPU f32 rel L2 {cpu_err:.4f} (< 0.05); chunked (2^24) vs "
            f"one call rel L2 {chunk_err:.2e} in f32 (<= 1e-3), {chunk_err_bf16:.2e} in bf16 "
            f"(< 0.05); single tile exact {single}")
        if not (cpu_err < 0.05 and chunk_err <= 1e-3 and chunk_err_bf16 < 0.05 and single):
            raise RuntimeError(f"VAE {name}: gate failed {out[name]}")
        del gpu, tiled
        gc.collect()
        torch.cuda.empty_cache()
    return out


# (name, VAE, latent shape, tiled): Wan 480p x 77f whole-clip (the JAX CLI's
# default), Wan 720p x 77f tiled, HunyuanVideo 720p x 45f tiled, and
# HunyuanVideo 720p x 21f whole-clip (its top stage 2.48e9 elements)
VAE_DECODES = (("wan_480p_77f_whole", "wan", (1, 20, 60, 104, 16), False),
               ("wan_720p_77f_tiled", "wan", (1, 20, 90, 160, 16), True),
               ("hunyuan_720p_45f_tiled", "hunyuan", (1, 12, 90, 160, 16), True),
               ("hunyuan_720p_21f_whole", "hunyuan", (1, 6, 90, 160, 16), False))


def run_vae_decode(torch, card: str) -> dict:
    """The VAEs at full width on the card (random bf16 weights from a seed):
    the conv3d probe, the gates, then each of VAE_DECODES timed (host clock,
    synchronised; the whole-clip decodes after a warm-up decode, the tiled
    ones once: their tiles share one shape) with its peak memory above the
    weights and the latents (max_memory_allocated) and its FLOP bound."""
    import gc

    from vorta_tpu_torch.models import hunyuan_vae as hv
    from vorta_tpu_torch.models import wan_vae as wv
    from vorta_tpu_torch.models.vae_tiling import tiled_decode

    out = {"conv3d_probe": conv3d_probe(torch), "gates": vae_gates(torch)}
    vaes = {"wan": (wv.WanVAE, wv.WAN_VAE), "hunyuan": (hv.HunyuanVAE, hv.HUNYUAN_VAE)}
    for name, family, shape, tiled in VAE_DECODES:
        cls, cfg = vaes[family]
        vae = cls(cfg, dtype=torch.bfloat16, device="cuda", seed=0)
        z = torch.randn(shape, generator=torch.Generator(device="cuda").manual_seed(42),
                        device="cuda")

        def decode():
            if tiled:
                return tiled_decode(lambda zz: vae.decode(zz, denormalize=False), z)
            return vae.decode(z, denormalize=False)

        if not tiled:
            decode()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        t0 = time.time()
        px = decode()
        torch.cuda.synchronize()
        s = time.time() - t0
        peak = (torch.cuda.max_memory_allocated() - base) / 2**30
        frames = 4 * (shape[1] - 1) + 1
        if tuple(px.shape) != (1, frames, 8 * shape[2], 8 * shape[3], 3) or not torch.isfinite(
                px).all():
            raise RuntimeError(f"VAE {name}: output {tuple(px.shape)} or non-finite")
        flops = decode_flops(torch, cls, cfg, shape, tiled)
        # the widest activation: the last stage's input, at full resolution
        # (of a tile where tiled: (16, 32, 32) latent at most)
        lt, lh, lw = (min(a, b) for a, b in zip(shape[1:4], (16, 32, 32) if tiled else shape[1:4]))
        top = (4 * (lt - 1) + 1) * 64 * lh * lw * (cfg.base_dim * 2 if family == "wan"
                                                   else cfg.base_dims[1])
        out[name] = dict(s=s, peak_gib=peak, tflop=flops / 1e12, bound_s=flops / PEAK_BF16,
                         bound_share=flops / PEAK_BF16 / s, latent=list(shape[1:4]),
                         top_stage_elements=top)
        log(f"VAE {name}: latent {shape[1:4]} -> {frames} x {8 * shape[2]} x {8 * shape[3]} in "
            f"{s:.3f} s on {card}, peak {peak:.2f} GiB above the weights and latents; "
            f"{flops / 1e12:.1f} TFLOP, bound {flops / PEAK_BF16:.3f} s "
            f"({100 * flops / PEAK_BF16 / s:.1f}% of it); widest stage input "
            f"{top:.3g} elements")
        del vae, z, px
        gc.collect()
        torch.cuda.empty_cache()
    return out


class StandInTokenizer:
    """A deterministic stand-in with ``.encode(s).ids`` (a hash of each
    word), for a card machine without the ``tokenizers`` package."""

    def encode(self, s: str):
        import types
        import zlib

        return types.SimpleNamespace(ids=[3 + zlib.crc32(w.encode()) % 30000 for w in s.split()])


def prompt_tokenizer(tok_dir: Path):
    """(the patch to run cli.sample under, what tokenizes): a BPE of 100
    tokens trained here into ``tok_dir/tokenizer.json`` where the
    ``tokenizers`` package is installed (the real loader reads it), else
    the stand-in over ``io.text.load_tokenizer``."""
    import contextlib
    import importlib.util
    from unittest import mock

    from vorta_tpu_torch.io import text as text_io

    if importlib.util.find_spec("tokenizers") is None:
        return (mock.patch.object(text_io, "load_tokenizer", lambda path: StandInTokenizer()),
                "a stand-in (no tokenizers package): ids from a hash of each word")
    from tokenizers import Tokenizer, models, pre_tokenizers, trainers

    tok = Tokenizer(models.BPE(unk_token="<unk>"))
    tok.pre_tokenizer = pre_tokenizers.Whitespace()
    tok.train_from_iterator([PROMPT, "a dog running through a sunny field of flowers",
                             "a city at night"],
                            trainers.BpeTrainer(vocab_size=100,
                                                special_tokens=["<pad>", "<unk>", "</s>"]))
    tok_dir.mkdir(parents=True, exist_ok=True)
    tok.save(str(tok_dir / "tokenizer.json"))
    return contextlib.nullcontext(), "a BPE of 100 tokens trained here (tokenizers)"


def run_prompt_to_video(torch, card: str) -> dict:
    """cli.sample from a prompt to a video on the card, through main(argv):
    Wan-1.3B 480p x 77f routed hard (the CLI's defaults), UMT5-XXL, 2 UniPC
    steps x CFG, --decode whole-clip; HunyuanVideo-13B 720p x 45f routed,
    Llama-8B + CLIP-L, 1 Euler step, --decode --vae_tiling.  Random weights
    from the seed (the CLI warns), frames written as .npy through
    save_video.  Launches exact against the routing tables; Wan's frames
    against a whole-clip decode of the CLI's latents by a VAE built apart
    (rel L2 <= 1e-3)."""
    import gc

    import numpy as np

    from vorta_tpu_torch.models.wan_vae import WAN_VAE, WanVAE
    from vorta_tpu_torch.ops import _build

    out_dir = HERE / "results" / "port_smoke"
    patch, tokenizer = prompt_tokenizer(out_dir / "tokenizer")
    out = {"tokenizer": tokenizer}
    runs = (("wan", "WanT2VPipeline", (77, 480, 832),
             ["--model", "wan-1_3B", "--num_inference_steps", "2"]),
            ("hunyuan", "HunyuanT2VPipeline", (45, 720, 1280),
             ["--model", "hunyuan-13B", "--num_frames", "45", "--height", "720", "--width",
              "1280", "--num_inference_steps", "1", "--vae_tiling"]))
    for name, pipeline, (t, h, w), argv in runs:
        _build.reset_launches()
        with patch:
            res, _ = spied_sample(torch, argv + [
                "--prompt", PROMPT, "--tokenizer_dir", str(out_dir / "tokenizer"), "--decode",
                "--seed", "0", "--device", "cuda", "--output",
                str(out_dir / f"video_{name}.npy")], pipeline)
        launches = dict(_build.launches)
        tables = np.stack(res.routing)
        want = (routed_wan_launches(tables, "sta_pipe", tables.shape[0]) if name == "wan"
                else hy_hard_launches(tables))
        frames = np.load(res.video)
        if launches != want or frames.shape != (t, h, w, 3) or not np.isfinite(frames).all():
            raise RuntimeError(f"prompt to video {name}: frames {frames.shape}, launches "
                               f"{launches} != {want}")
        served_on_wgmma(launches, f"prompt to video {name}")
        row = dict(encode_s=res.encode_s, build_s=res.build_s,
                   s_per_step=res.denoise_s / res.steps, decode_s=res.decode_s,
                   frames=list(frames.shape), launches=launches)
        if name == "wan":
            vae = WanVAE(WAN_VAE, dtype=torch.bfloat16, device="cuda", seed=0)
            again = vae.decode(res.latents)[0]
            row["frames_vs_apart_rel_l2"] = rel_l2(torch, torch.from_numpy(frames), again)
            if not row["frames_vs_apart_rel_l2"] <= 1e-3:
                raise RuntimeError(f"prompt to video wan: frames vs a decode apart {row}")
            del vae, again
        out[name] = row
        log(f"prompt to video {name} ({t} x {h} x {w}): encode {res.encode_s:.3f} s, build "
            f"{res.build_s:.1f} s, {row['s_per_step']:.3f} s per step, decode "
            f"{res.decode_s:.3f} s on {card}; launches exact; tokenizer: {tokenizer}")
        del res, frames
        gc.collect()
        torch.cuda.empty_cache()
    return out


# ---- training ------------------------------------------------------------------

# lse tolerance: the kernel and the plain version take the same f32 logits
# and sum their exponentials in another order, so ~1e-6 relative; the
# backward outputs are bf16 and held by the TOL rule
LSE_RTOL, LSE_ATOL = 1e-5, 1e-4


# the bench router's training geometry (tools/train_bench_router.py --geom
# 720p_half): 720 x 1280 x 37 frames, STA tile (5, 9, 8) = 360 tokens
GRID_720P_HALF, TILE_360 = (10, 45, 80), (5, 9, 8)


def training_calls(torch):
    """The attention calls the trainer makes per block at 480p x 77f, as the
    expert wrappers build them: tables, padded lengths, valid lengths; and
    the STA expert's at the bench router's geometry (10, 45, 80), tile
    (5, 9, 8): blocks of 360 = 8 x 45, 27 tiles per q block, and at a tile
    of 24 = 8 x 3 tokens, (2, 3, 4) on (8, 30, 52), whose 8-row tail warp
    opens a CUDA block."""
    import dataclasses

    from vorta_tpu_torch.cli.sample import attention_config
    from vorta_tpu_torch.ops.experts import (
        _dense_tables_cached,
        _full_tables,
        _lowres_tables,
        _sta_tables,
        lowres_groups_for,
    )

    cfg = attention_config("wan-1_3B", GRID_480P_77F)
    s, p = cfg.seq_len, lowres_groups_for(cfg).pooled_length
    full, full_q, full_kv = _full_tables(cfg)
    low, low_q, low_kv = _lowres_tables(cfg)
    bq, bkv = cfg.sta_blocks

    def sta(grid, tile):
        c = dataclasses.replace(attention_config("wan-1_3B", grid), sta_tile=tile)
        n, b = c.seq_len, c.tokens_per_tile
        return dict(tables=_sta_tables(c), sq=n, skv=n, q_valid=n, kv_valid=n, bq=b, bkv=b,
                    grid=grid, tile=tile)

    return {
        "full_31200": dict(tables=full, sq=full_q, skv=full_kv, q_valid=s, kv_valid=s,
                           bq=cfg.block_q, bkv=cfg.block_kv),
        "lowres_15600": dict(tables=low, sq=low_q, skv=low_kv, q_valid=p, kv_valid=p,
                             bq=cfg.block_q, bkv=cfg.block_kv),
        "sta_31200_tile96": dict(tables=_sta_tables(cfg), sq=s, skv=s, q_valid=s, kv_valid=s,
                                 bq=bq, bkv=bkv, grid=GRID_480P_77F, tile=(4, 6, 4)),
        "cross_31200x512": dict(tables=_dense_tables_cached(16, 1), sq=16 * 2048, skv=TEXT_LEN,
                                q_valid=s, kv_valid=TEXT_LEN, bq=2048, bkv=TEXT_LEN),
        "sta_36000_tile360": sta(GRID_720P_HALF, TILE_360),
        "sta_12480_tile24": sta((8, 30, 52), (2, 3, 4)),
    }


def visible_pairs(c: dict) -> int:
    """(q, kv) pairs the function needs: valid q rows times the valid kv
    columns of the blocks their q block visits."""
    tab, bq, bkv = c["tables"], c["bq"], c["bkv"]
    n = 0
    for i in range(tab.kv_count.shape[1]):
        rows = min(max(c["q_valid"] - i * bq, 0), bq)
        cols = sum(min(max(c["kv_valid"] - int(j) * bkv, 0), bkv)
                   for j in tab.kv_index[0, i, :tab.kv_count[0, i]])
        n += rows * cols
    return n


def check_training_kernels(torch, card: str) -> list:
    """The forward's lse and the dq / dk/dv kernels at the trainer's shapes
    (12 heads x 128, bf16), against their plain versions.  Where the
    backward's rule holds (FULL, LOWRES, cross) the Hopper kernels run,
    counted, and the mma.sync kernels are held and timed beside them in
    turns (Hopper, mma.sync, Hopper); SDPA's backward is the library
    yardstick."""
    import torch.nn.functional as F

    from vorta_tpu_torch.ops import _build
    from vorta_tpu_torch.ops.flash import sparse_flash_attention_raw, sparse_flash_attention_ref
    from vorta_tpu_torch.ops.flash_bwd import (
        bwd_wgmma_path,
        flash_backward,
        flash_backward_mma_sync,
        flash_backward_ref,
        transpose_tables,
    )

    dev = torch.device("cuda")
    bf16 = torch.bfloat16
    h, d = 12, 128
    scale = d**-0.5
    g = torch.Generator(device=dev).manual_seed(11)
    res = {"lse": {}, "dq": {}, "dkv": {}}
    for name, c in training_calls(torch).items():
        sq, skv, qv, kvv = c["sq"], c["skv"], c["q_valid"], c["kv_valid"]
        q = torch.randn((1, h, sq, d), generator=g, device=dev).to(bf16)
        k, v = (torch.randn((1, h, skv, d), generator=g, device=dev).to(bf16) for _ in range(2))
        dout = torch.randn((1, h, sq, d), generator=g, device=dev).to(bf16)
        dout[:, :, qv:] = 0  # the trainer slices the padded rows off the output
        ki, kc = c["tables"].on(dev)
        qi, qc = (torch.from_numpy(a).to(dev) for a in transpose_tables(
            c["tables"].kv_index, c["tables"].kv_count, skv // c["bkv"]))
        kw = dict(scale=scale, block_q=c["bq"], block_kv=c["bkv"])
        valid = kvv if kvv != skv else None
        fwd = lambda: sparse_flash_attention_raw(q, k, v, ki, kc, kv_valid_len=valid,  # noqa: E731
                                                 return_lse=True, **kw)
        fwd_plain = lambda: sparse_flash_attention_ref(q, k, v, ki, kc, kv_valid_len=valid,  # noqa: E731
                                                       return_lse=True, **kw)
        out, lse = fwd()
        want_out, want_lse = fwd_plain()
        err = compare(torch, f"flash + lse {name} (1,12,{sq},128) x {skv}",
                      out[:, :, :qv], want_out[:, :, :qv])
        lse_err = (lse - want_lse).abs()
        bad = lse_err > LSE_ATOL + LSE_RTOL * want_lse.abs()
        log(f"flash lse {name}: max |err| {lse_err.max().item():.3e} (tolerance {LSE_ATOL:g} + "
            f"{LSE_RTOL:g} x |plain|), sentinel rows {int((want_lse == 1e30).sum())}")
        if bad.any() or not torch.isfinite(lse).all():
            raise RuntimeError(f"flash lse {name}: kernel disagrees with its plain version")
        del want_out, want_lse
        bkw = dict(kv_valid_len=kvv, **kw)
        args = (q, k, v, out, lse, dout, ki, kc, qi, qc)
        bwd = lambda **o: flash_backward(*args, **bkw, **o)  # noqa: E731
        bwd_mma = lambda **o: flash_backward_mma_sync(*args, **bkw, **o)  # noqa: E731
        bwd_plain = lambda: flash_backward_ref(q, k, v, out, lse, dout, ki, kc, **bkw)  # noqa: E731
        hopper = bwd_wgmma_path(d, c["bq"], c["bkv"])
        _build.reset_launches()
        got = bwd()
        torch.cuda.synchronize()
        took = (_build.launches["flash_dq_wgmma"], _build.launches["flash_dkv_wgmma"])
        if took != (int(hopper), int(hopper)):
            raise RuntimeError(f"flash backward {name}: Hopper-path launches {took}, "
                               f"want {(int(hopper),) * 2}")
        want = bwd_plain()
        errs = [compare(torch, f"flash backward d{n} {name}"
                        f" ({'Hopper' if hopper else 'mma.sync'} kernels)", a, w)
                for n, a, w in zip(("q", "k", "v"), got, want)]
        if got[1][:, :, kvv:].any() or got[2][:, :, kvv:].any():
            raise RuntimeError(f"flash backward {name}: padded kv rows got non-zero dk / dv")
        if hopper:  # the mma.sync kernels, the yardstick, on the same inputs
            old = bwd_mma()
            for n, a, w, o in zip(("q", "k", "v"), got, want, old):
                compare(torch, f"flash backward d{n} {name} (mma.sync kernels)", o, w)
                log(f"flash backward d{n} {name}: Hopper vs mma.sync kernels, worst ratio "
                    f"{worst_ratio(torch, a, o):.4f}")
            del old
        del got, want
        torch.cuda.empty_cache()

        # bounds: products over the visible pairs; each operand read once
        pairs = visible_pairs(c) * h
        rows_q, rows_kv = qv * h * d * 2, kvv * h * d * 2  # bytes of one (S, d) operand set
        fl_ms, fl_by = bound_ms(4.0 * pairs * d, 2 * rows_q + 2 * rows_kv + qv * h * 4, PEAK_BF16)
        dq_ms, dq_by = bound_ms(6.0 * pairs * d, 3 * rows_q + 2 * rows_kv + 2 * qv * h * 4,
                                PEAK_BF16)
        dkv_ms, dkv_by = bound_ms(8.0 * pairs * d, 2 * rows_q + 4 * rows_kv + 2 * qv * h * 4,
                                  PEAK_BF16)
        # library yardstick: SDPA on the valid rows (STA with the window's
        # boolean mask), forward and forward + backward; backward = the difference
        qs = q[:, :, :qv].detach().requires_grad_()
        ks = k[:, :, :kvv].detach().requires_grad_()
        vs = v[:, :, :kvv].detach().requires_grad_()
        go = dout[:, :, :qv]
        mask = sta_raster_mask(torch, c["grid"], c["tile"], dev) if "tile" in c else None
        lib_fwd = lib_bwd = None
        try:
            with torch.no_grad():
                lib_fwd = time_ms(torch, lambda: F.scaled_dot_product_attention(
                    qs, ks, vs, attn_mask=mask), 5, 1)
            lib_fb = time_ms(torch, lambda: torch.autograd.grad(
                F.scaled_dot_product_attention(qs, ks, vs, attn_mask=mask), (qs, ks, vs), go),
                5, 1)
            lib_bwd = lib_fb - lib_fwd
        except (torch.OutOfMemoryError, RuntimeError) as e:
            log(f"{name}: SDPA yardstick failed: {type(e).__name__}: {str(e).splitlines()[0]}")
        del qs, ks, vs, mask
        torch.cuda.empty_cache()
        plain_bwd = time_ms(torch, bwd_plain, 2, 1)
        res["lse"][name] = dict(ms=time_ms(torch, fwd, 10), plain_ms=time_ms(torch, fwd_plain, 2, 1),
                                library_ms=lib_fwd, bound_ms=fl_ms, bound_by=fl_by,
                                max_abs_err=max(err, lse_err.max().item()))
        for kind, alone, b_ms, b_by, err in (("dq", "need_dkv", dq_ms, dq_by, errs[0]),
                                              ("dkv", "need_dq", dkv_ms, dkv_by, max(errs[1:]))):
            # in turns, in one call: the kernel, the mma.sync yardstick, the kernel
            first = time_ms(torch, lambda: bwd(**{alone: False}), 10)
            mma_ms = time_ms(torch, lambda: bwd_mma(**{alone: False}), 10) if hopper else None
            again = time_ms(torch, lambda: bwd(**{alone: False}), 10) if hopper else first
            res[kind][name] = dict(ms=(first + again) / 2, path="hopper" if hopper else "mma_sync",
                                   plain_ms=plain_bwd, library_ms=lib_bwd, bound_ms=b_ms,
                                   bound_by=b_by, max_abs_err=err)
            if hopper:
                res[kind][name].update(mma_sync_ms=mma_ms,
                                       mma_sync_bound_share=b_ms / mma_ms,
                                       mma_sync_over_hopper=mma_ms / res[kind][name]["ms"])
        for kind, per_pair in (("lse", 4.0), ("dq", 6.0), ("dkv", 8.0)):
            log(f"{kind} {name}: {with_rate(res[kind][name], per_pair * pairs * d)}")
        if hopper:
            both = res["dq"][name]["ms"] + res["dkv"][name]["ms"]
            log(f"backward {name}: dq + dk/dv {both:.3f} ms on the Hopper kernels (mma.sync "
                f"{res['dq'][name]['mma_sync_ms'] + res['dkv'][name]['mma_sync_ms']:.3f}), "
                f"SDPA's backward {lib_bwd if lib_bwd is None else f'{lib_bwd:.3f}'} ms")
        del q, k, v, dout, out, lse
        torch.cuda.empty_cache()

    def entry(kind, name, source, replaces):
        shapes = res[kind]
        worst = max(x["max_abs_err"] for x in shapes.values())
        return dict(name=name, route="cuda", source=source, replaces=replaces, _counter=name,
                    **{**shapes["full_31200"], "max_abs_err": worst}, shapes=shapes,
                    **({"library_covers": "SDPA's backward computes dq, dk and dv in one call"}
                       if kind != "lse" else {}))

    return [entry("lse", "flash_lse", "vorta_tpu_torch/csrc/flash.cu", "vorta_tpu/ops/flash.py:237"),
            entry("dq", "flash_dq", "vorta_tpu_torch/csrc/flash_bwd.cu",
                  "vorta_tpu/ops/flash_bwd.py:75"),
            entry("dkv", "flash_dkv", "vorta_tpu_torch/csrc/flash_bwd.cu",
                  "vorta_tpu/ops/flash_bwd.py:116")]


def check_train_grads(torch, grid=(4, 12, 8), tile=(4, 6, 4)) -> None:
    """One router train step of a 2-block Wan-1.3B-width model: the card
    (bf16, kernels) against the CPU (f32, plain versions), the same weights
    and draws.  Grid (4, 12, 8): the STA tile (4, 6, 4) and the lowres
    window (2, 3, 2) divide it, so all three experts and their backward run;
    grid (10, 18, 16) with tile (5, 9, 8): the STA expert's flash forward
    and backward at blocks of 360 tokens."""
    import dataclasses

    from vorta_tpu_torch.cli.sample import attention_config
    from vorta_tpu_torch.config import WAN_1_3B
    from vorta_tpu_torch.models.wan import WanModel
    from vorta_tpu_torch.schedulers.flow_match import train_sigmas
    from vorta_tpu_torch.training.step import LossWeights, make_router_train_step, router_partition

    cfg = dataclasses.replace(WAN_1_3B, num_layers=2)
    attn = dataclasses.replace(attention_config("wan-1_3B", grid), sta_tile=tile)
    sig = train_sigmas(5.0)
    step = make_router_train_step(attn, LossWeights(), timestep_table=sig * 1000.0,
                                  sigma_table=sig)
    gen = torch.Generator().manual_seed(12)
    lat = torch.randn((1, grid[0], 2 * grid[1], 2 * grid[2], 16), generator=gen)
    ctx = torch.randn((1, TEXT_LEN, cfg.text_dim), generator=gen)
    eps = torch.randn(lat.shape, generator=gen)
    t, s = torch.tensor([float(sig[300] * 1000.0)]), torch.tensor([float(sig[300])])
    ref = WanModel(cfg, dtype=torch.float32, device="cpu", seed=13)

    def run(model, dev):
        routers = router_partition(model)
        loss, m = step.loss(model, *(x.to(dev) for x in (lat, ctx, t, s, eps)))
        grads = torch.autograd.grad(loss, list(routers.values()))
        return loss.item(), torch.cat([x.flatten().float().cpu() for x in grads]), m

    gpu = WanModel(cfg, dtype=torch.bfloat16, device="cuda", seed=13)
    gpu.load_state_dict(ref.state_dict())
    loss_g, grads_g, m = run(gpu, "cuda")
    del gpu
    loss_c, grads_c, _ = run(ref, "cpu")
    rel_loss = abs(loss_g - loss_c) / abs(loss_c)
    rel = ((grads_g - grads_c).norm() / grads_c.norm()).item()
    log(f"gradient check (2 blocks, 1.3B widths, {grid} = {attn.seq_len} tokens, tile {tile}, "
        f"t = {t.item():.1f}): "
        f"loss card {loss_g:.6f} vs CPU {loss_c:.6f} (rel {rel_loss:.2e}, tolerance 0.02); router "
        f"gradients rel L2 {rel:.4f} (tolerance 0.1; |grad| {grads_c.norm().item():.3e}); "
        f"card metrics { {k: round(float(v), 6) for k, v in m.items()} }")
    if not torch.isfinite(grads_g).all() or not (rel_loss <= 0.02 and rel <= 0.1):
        raise RuntimeError("gradient check: the card's train step disagrees with the CPU's")


def train_launches(kernels, num_layers: int) -> dict:
    """Kernel launches of one training micro-step (soft routing, teacher
    interleaved, remat on), derived from the graph:
      teacher, per block, no grad: flash self + cross without lse, the qk
        prologue, 2 AdaLN norms; its output head: 1 norm;
      student, per block, its forward run twice (once more in the backward,
        by the per-block recompute): 2 AdaLN norms, 3 expert flash + 1 cross
        flash.  Block 0's self-attention inputs need no gradient (frozen
        patch embedding and projections), so its experts run without lse
        and get no backward; its cross-attention q does (through the routed
        residual), so it runs with lse and gets dq only: the text k and v
        are frozen.  Blocks 1..L-1: 4 flash with lse; backward dq x 4 and
        dk/dv x 3 (the experts); the student's head: 1 norm.
      The Hopper path takes every flash launch but the STA expert's (its
      96- and 360-token tiles stay on mma.sync): the teacher's 2, and FULL,
      LOWRES and cross of each student forward; the backward's rule is the
      forward's, so every dq and dk/dv launch but the STA expert's too:
      block 0's cross dq, then per block FULL, LOWRES and cross dq and FULL
      and LOWRES dk/dv."""
    n = num_layers
    return {**dict.fromkeys(kernels, 0), "flash": 2 * n + 2 * 4 * n,
            "flash_wgmma": 2 * n + 2 * 3 * n,
            "flash_lse": 2 * (1 + 4 * (n - 1)), "flash_dq": 1 + 4 * (n - 1),
            "flash_dkv": 3 * (n - 1), "flash_dq_wgmma": 1 + 3 * (n - 1),
            "flash_dkv_wgmma": 2 * (n - 1), "fused_norm": 2 * n + 1 + 2 * 2 * n + 1,
            "prologue": n, "prologue_rows": n}


def run_train_main_path(torch, card: str):
    """cli.train at full width and depth (480p x 77f): 2 optimizer steps of 2
    micro-steps and a checkpoint, then resumed for a third step."""
    import math
    import shutil

    from vorta_tpu_torch.cli.train import main as train_main
    from vorta_tpu_torch.ops import _build

    out_dir = HERE / "results" / "port_smoke" / "train"  # listed in .gitignore
    shutil.rmtree(out_dir, ignore_errors=True)
    base = ["--model", "wan-1_3B", "--synthetic_data", "--gradient_accumulation_steps", "2",
            "--output_dir", str(out_dir)]
    per_micro = train_launches(_build.KERNELS, 30)
    runs = []
    for extra, micro in ((["--max_train_steps", "2"], 4),
                         (["--max_train_steps", "3", "--resume_from_checkpoint", "latest"], 2)):
        _build.reset_launches()
        res = train_main(base + extra)
        launches = dict(_build.launches)
        expected = {k: v * micro for k, v in per_micro.items()}
        if launches != expected:
            raise RuntimeError(f"training main path launches {launches} != expected {expected}")
        if len(res.micro_s) != micro:
            raise RuntimeError(f"training main path: {len(res.micro_s)} micro-steps, not {micro}")
        runs.append((res, launches))
    (first, launches), (second, _) = runs
    shutil.rmtree(out_dir, ignore_errors=True)
    metrics = first.metrics + second.metrics
    if not all(math.isfinite(m[k]) for m in metrics for k in ("loss", "grad_norm")):
        raise RuntimeError(f"training main path: non-finite metrics {metrics}")
    moved = max((first.router_final[k] - first.router_init[k]).abs().max().item()
                for k in first.router_init)
    if not moved > 0:
        raise RuntimeError("training main path: the routers did not change")
    if (first.final_step, second.init_step, second.final_step) != (2, 2, 3):
        raise RuntimeError(f"training main path: steps {first.final_step}, resumed at "
                           f"{second.init_step}, ended {second.final_step}")
    if any(not torch.equal(second.router_init[k], first.router_final[k])
           for k in first.router_final):
        raise RuntimeError("training main path: the resumed run did not start from the checkpoint")
    micro = first.micro_s[1:] + second.micro_s[1:]  # the first of each run warms up
    stats = dict(micro_s=sum(micro) / len(micro), step_s=second.step_s[0],
                 first_micro_s=first.micro_s[0],
                 max_memory_gib=max(first.max_memory_bytes, second.max_memory_bytes) / 2**30)
    log(f"training main path: Wan-1.3B 30 blocks, 31,200 tokens, soft routing + teacher, remat: "
        f"micro-steps {[round(x, 3) for x in first.micro_s + second.micro_s]} s, optimizer "
        f"steps {[round(x, 3) for x in first.step_s + second.step_s]} s; steady "
        f"{stats['micro_s']:.3f} s per micro-step, {stats['step_s']:.3f} s per optimizer step "
        f"(resumed run); peak memory {stats['max_memory_gib']:.2f} GiB; routers moved by up to "
        f"{moved:.3e}; resumed at step {second.init_step} on {card}")
    for m in metrics:
        log(f"training step {m['step']}: " + ", ".join(
            f"{k} {m[k]:.6g}" for k in ("loss", "l_fm", "l_reg", "l_last", "l_hidden",
                                         "grad_norm", "timestep")))
    log(f"training launches per micro-step {per_micro} (exact over 4 + 2 micro-steps)")
    return launches, stats


def run_train_720p_half(torch, card: str):
    """cli.train at the bench router's geometry (tools/train_bench_router.py
    --geom 720p_half): Wan-1.3B at full width and depth, 720 x 1280 x 37
    frames = (10, 45, 80) = 36,000 tokens, STA tile (5, 9, 8) = 360 tokens
    (the flash forward and backward at blocks of 8 x 45), 2 optimizer steps
    of 1 micro-step; launch counts exact, finite loss."""
    import json as _json
    import math
    import shutil

    from vorta_tpu_torch.cli.train import main as train_main
    from vorta_tpu_torch.ops import _build

    out_dir = HERE / "results" / "port_smoke" / "train_720p_half"  # listed in .gitignore
    shutil.rmtree(out_dir, ignore_errors=True)
    _build.reset_launches()
    res = train_main(["--model", "wan-1_3B", "--synthetic_data", "--num_latent_t", "10",
                      "--video_height", "720", "--video_width", "1280", "--sta_tile", "5", "9",
                      "8", "--gradient_accumulation_steps", "1", "--max_train_steps", "2",
                      "--output_dir", str(out_dir)])
    launches = dict(_build.launches)
    saved = _json.loads((out_dir / "config.json").read_text())
    shutil.rmtree(out_dir, ignore_errors=True)
    expected = {k: 2 * v for k, v in train_launches(_build.KERNELS, 30).items()}
    if launches != expected:
        raise RuntimeError(f"720p_half training launches {launches} != expected {expected}")
    if tuple(saved["latent_shape"]) != GRID_720P_HALF or tuple(saved["sta_tile"]) != TILE_360:
        raise RuntimeError(f"720p_half training: config.json {saved}")
    if res.final_step != 2 or len(res.micro_s) != 2 or not all(
            math.isfinite(m[k]) for m in res.metrics for k in ("loss", "grad_norm")):
        raise RuntimeError(f"720p_half training: steps {res.final_step}, metrics {res.metrics}")
    stats = dict(micro_s=res.micro_s[1], first_micro_s=res.micro_s[0],
                 max_memory_gib=res.max_memory_bytes / 2**30)
    log(f"training at the bench router's geometry: Wan-1.3B 30 blocks, {GRID_720P_HALF} = "
        f"36,000 tokens, tile {TILE_360} (360 tokens), soft routing + teacher, remat: "
        f"micro-steps {[round(x, 3) for x in res.micro_s]} s (the second {stats['micro_s']:.3f} "
        f"s), peak memory {stats['max_memory_gib']:.2f} GiB on {card}; losses "
        f"{[round(m['loss'], 6) for m in res.metrics]}; launches {launches} (exact)")
    return launches, stats


def run_wan_dispatch_paths(torch, card: str):
    """One full-width Wan-1.3B 480p x 77f forward (30 blocks, random weights
    and routers, routed hard at the CLI's geometry) under the masked dispatch
    and under each of the JAX package's dispatch variables: launch counts
    exact against the forward's routing, the output against the masked
    dispatch's, ms per forward (after a warm-up forward under the same
    variable)."""
    import numpy as np

    from vorta_tpu_torch.cli.sample import attention_config
    from vorta_tpu_torch.config import WAN_1_3B
    from vorta_tpu_torch.models.wan import WanModel
    from vorta_tpu_torch.ops import _build

    model = WanModel(WAN_1_3B, dtype=torch.bfloat16, device="cuda", seed=0)
    g = torch.Generator(device="cuda").manual_seed(3)
    t_g, h_g, w_g = GRID_480P_77F
    lat = torch.randn((1, t_g, 2 * h_g, 2 * w_g, 16), generator=g, device="cuda")
    ctx = torch.randn((1, TEXT_LEN, 4096), generator=g, device="cuda")
    t = torch.tensor([700.0], device="cuda")
    attn = attention_config("wan-1_3B", GRID_480P_77F)
    launches, ms, ref = {}, {}, None
    for var, value, name in ((None, None, "masked"),) + DISPATCHES:
        with dispatch_env(var, value):
            model(lat, t, ctx, attn_cfg=attn, routing_mode="hard")  # warm-up
            torch.cuda.synchronize()
            _build.reset_launches()
            t0 = time.time()
            res = model(lat, t, ctx, attn_cfg=attn, routing_mode="hard")
            torch.cuda.synchronize()
            ms[name] = (time.time() - t0) * 1e3
        launches[name] = dict(_build.launches)
        tables = np.asarray(res.expert_ids)[None]
        expected = routed_wan_launches(tables, "sta_pipe", 1, name)
        heads = np.bincount(tables.reshape(-1), minlength=3)
        if launches[name] != expected or not (heads > 0).all():
            raise RuntimeError(f"Wan dispatch {name}: launches {launches[name]} != {expected}, "
                               f"heads per expert {heads}")
        out = res.sample.float()
        if not torch.isfinite(out).all():
            raise RuntimeError(f"Wan dispatch {name}: non-finite output")
        if ref is None:
            ref = out
        rel = ((out - ref).norm() / ref.norm()).item()
        log(f"Wan-1.3B 480p x 77f forward, dispatch {name}: {ms[name]:.1f} ms on {card}; heads "
            f"per expert full {heads[0]}, lowres {heads[1]}, sta {heads[2]}; rel L2 vs the "
            f"masked dispatch {rel:.2e} (tolerance 1e-2); launches {launches[name]} (exact)")
        if not rel < 1e-2:
            raise RuntimeError(f"Wan dispatch {name}: output differs from the masked dispatch's")
    del model
    return launches, ms


def run_bench_pool(torch, card: str):
    """python -m vorta_tpu_torch.tools.bench_pool at every stage, both arms,
    in this process (the launch counters see it): ms per iteration."""
    from vorta_tpu_torch.ops import _build
    from vorta_tpu_torch.tools.bench_pool import STAGES
    from vorta_tpu_torch.tools.bench_pool import main as bench_main

    times, launches = {}, dict.fromkeys(_build.KERNELS, 0)
    for stage in STAGES:
        _build.reset_launches()
        times[stage] = bench_main(["--stage", stage])
        for k, v in _build.launches.items():
            launches[k] += v
        log(f"bench_pool --stage {stage}: {times[stage]} ms per iteration on {card}; "
            f"launches {dict((k, v) for k, v in _build.launches.items() if v)}")
    return launches, times


def timed_once(torch, fn):
    """(fn(), ms) with CUDA events around one call."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def mode_case(torch, name, kern, plain, fast, flops, nbytes, replaces, lib=None,
              rows=None) -> dict:
    """One softmax mode or variant of a ported kernel: held against its
    plain version (on ``rows`` of the sequence axis where given: the rows
    its caller reads back), timed beside the fast full call it would
    replace."""
    want, plain_ms = timed_once(torch, plain)
    got = kern()
    if rows is not None:
        pad = torch.ones(got.shape[2], dtype=torch.bool, device=got.device)
        pad[rows] = False
        log(f"{name}: on the {int(pad.sum())} padding rows its caller drops, worst ratio "
            f"{worst_ratio(torch, got[:, :, pad], want[:, :, pad]):.3e} (not gated)")
        got, want = got[:, :, rows], want[:, :, rows]
    err = compare(torch, name, got, want)
    del got, want
    b_ms, b_by = bound_ms(flops, nbytes, PEAK_BF16)
    r = with_rate(dict(replaces=replaces, on_main_path=False, ms=time_ms(torch, kern, 5),
                       plain_ms=plain_ms, fast_ms=time_ms(torch, fast, 5), bound_ms=b_ms,
                       bound_by=b_by, library_ms=lib, max_abs_err=err), flops)
    log(f"{name}: {r}")
    return r


def mode_row(shapes: dict) -> dict:
    """A mode's entry in its kernel's ``modes``: its first shape's numbers on
    top, all of them under ``shapes``."""
    first = next(iter(shapes.values()))
    return {**first, "max_abs_err": max(x["max_abs_err"] for x in shapes.values()),
            "shapes": shapes}


def check_options_kernels(torch, card: str) -> dict:
    """The kernels and modes PR 8 brought, on the card against their plain
    versions, timed: fused_residual_norm (forward at Wan / HunyuanVideo
    widths, backward at a small shape), the sta_diag variants at the tool's
    default, sta_pipe's stable softmax and variants, flash_manual's and
    sta_batched's stable softmax."""
    import dataclasses

    import numpy as np
    import torch.nn.functional as F

    from vorta_tpu_torch.cli.sample import attention_config
    from vorta_tpu_torch.ops import joint_experts as joint
    from vorta_tpu_torch.ops.flash import dense_tables
    from vorta_tpu_torch.ops.flash_manual import (
        sparse_flash_attention_manual,
        sparse_flash_attention_manual_ref,
    )
    from vorta_tpu_torch.ops.fused_norm import _res_norm_ref, fused_norm, fused_residual_norm
    from vorta_tpu_torch.ops.routed_fused import routed_geometry
    from vorta_tpu_torch.ops.sta_batched import sta_flash_headbatched, sta_flash_headbatched_ref
    from vorta_tpu_torch.ops.sta_pipe import (
        sta_pipe_attention,
        sta_pipe_attention_mma_sync,
        sta_pipe_attention_ref,
    )
    from vorta_tpu_torch.tools.sta_diag import (
        VARIANTS,
        sta_diag_attention,
        sta_diag_attention_mma_sync,
        sta_diag_ref,
    )

    dev = torch.device("cuda")
    bf16, f32 = torch.bfloat16, torch.float32
    g = torch.Generator(device=dev).manual_seed(80)

    def randn(*shape, dtype=bf16, scale=1.0):  # unit RMS: the scale of qk-normed q/k
        return (torch.randn(shape, generator=g, device=dev) * scale).to(dtype)

    out = {"fused_residual_norm": {}, "sta_diag": {}, "sta_pipe": {}, "flash_manual": {},
           "sta_batched": {}}

    # ---- fused_residual_norm: gate + AdaLN modulation at Wan-1.3B 480p x 77f, gate +
    # affine + beta at HunyuanVideo-13B 720p x 45f's joint stream
    for name, (n, dim), opts in (("wan_31200x1536_gate_mod", (31200, 1536), "gate_mod"),
                                 ("hunyuan_43456x3072_gate_affine_beta", (43456, 3072),
                                  "gate_affine")):
        x, dl = randn(1, n, dim), randn(1, n, dim)
        gate = randn(1, dim, dtype=f32, scale=0.3)
        sc = sh = ga = be = None
        if opts == "gate_mod":
            sc, sh = randn(1, dim, dtype=f32, scale=0.2), randn(1, dim, dtype=f32, scale=0.2)
        else:
            ga, be = 1 + randn(dim, dtype=f32, scale=0.1), randn(dim, dtype=f32, scale=0.1)
        args = (x, dl, gate, sc, sh, ga, be, 1e-6)
        kern = lambda: fused_residual_norm(*args)  # noqa: E731
        plain = lambda: _res_norm_ref(*args)  # noqa: E731
        xr, yr = plain()
        xn, y = kern()
        if not torch.equal(xn, xr):
            raise RuntimeError(f"fused_residual_norm {name}: x_new differs from the plain "
                               "version's (one rounding of the same f32 sum on both sides)")
        err = compare(torch, f"fused_residual_norm y {name}", y, yr)
        del xn, y, xr, yr

        def unfused():  # the residual line of models/wan.py, then the fused_norm kernel
            xu = (x.float() + dl.float() * gate[:, None, :]).to(bf16)
            return xu, fused_norm(xu, sc, sh, ga, be, False, 1e-6, False)

        b_ms, b_by = bound_ms(0.0, 4.0 * n * dim * 2, PEAK_BF16)
        out["fused_residual_norm"][name] = r = dict(
            ms=time_ms(torch, kern, 20), plain_ms=time_ms(torch, plain, 3, 1),
            unfused_ms=time_ms(torch, unfused, 20),
            library_ms=None, bound_ms=b_ms, bound_by=b_by, max_abs_err=err)
        log(f"fused_residual_norm {name}: {r} ({4.0 * n * dim * 2 / r['ms'] / 1e6:.1f} GB/s)")
        del x, dl
    # the backward through the Function against the plain version's autograd
    with torch.inference_mode(False), torch.enable_grad():
        b, n, dim = 1, 256, 1536
        vals = [randn(b, n, dim), randn(b, n, dim), randn(b, dim, dtype=f32, scale=0.3),
                randn(b, dim, dtype=f32, scale=0.2), randn(b, dim, dtype=f32, scale=0.2),
                1 + randn(dim, dtype=f32, scale=0.1), randn(dim, dtype=f32, scale=0.1)]
        w1, w2 = randn(b, n, dim, dtype=f32), randn(b, n, dim, dtype=f32)
        grads = []
        for fn in (fused_residual_norm, _res_norm_ref):
            leaves = [t.clone().requires_grad_() for t in vals]
            xn, y = fn(*leaves, 1e-6)
            ((xn.float() * w1).sum() + (y.float() * w2).sum()).backward()
            grads.append([t.grad.float() for t in leaves])
        rel = max(((a - w).norm() / w.norm()).item() for a, w in zip(*grads))
        log(f"fused_residual_norm backward (1,256,1536), all seven inputs: worst relative L2 "
            f"{rel:.3e} (tolerance 1e-2)")
        if not rel <= 1e-2:
            raise RuntimeError("fused_residual_norm: gradients disagree with the plain version's")
        out["fused_residual_norm"]["backward_rel_l2"] = rel
        del vals, grads, w1, w2

    # ---- sta_diag at the tool's default: (1,12,72000,128), tile (5,9,8), window (3,3,3)
    grid, tile, h, d = GRID_720P, (5, 9, 8), 12, 128
    n = grid[0] * grid[1] * grid[2]
    keys = int(np.prod([min(3, grid[a] // tile[a]) * tile[a] for a in range(3)]))
    q, k, v = (randn(1, h, n, d) for _ in range(3))
    all12 = torch.ones(h, device=dev, dtype=torch.int32)
    skw = dict(latent_shape=grid, tile=tile, window=(3, 3, 3))
    pipe_fast = lambda: sta_pipe_attention(q, k, v, all12, **skw)  # noqa: E731
    pipe_fast_ms = time_ms(torch, pipe_fast, 5)
    flops = 4.0 * n * keys * d * h
    # the fast call itself, every head active: the Hopper path against its plain
    # version, beside the mma.sync kernel in this call (its row under sta_pipe)
    sta_path_once(torch, "sta_pipe fast (1,12,72000,128)", pipe_fast, True)
    want, fast_plain_ms = timed_once(torch, lambda: sta_pipe_attention_ref(q, k, v, all12,
                                                                           **skw))
    fast_err = compare(torch, f"sta_pipe fast (1,12,72000,128) tile {tile}, 12 heads",
                       pipe_fast(), want)
    del want
    fast_b_ms, fast_b_by = bound_ms(flops, 4.0 * n * d * 2 * h, PEAK_BF16)
    out["sta_pipe_fast"] = dict(ms=pipe_fast_ms, mma_sync_ms=time_ms(
        torch, lambda: sta_pipe_attention_mma_sync(q, k, v, all12, **skw), 5),
        plain_ms=fast_plain_ms, bound_ms=fast_b_ms, bound_by=fast_b_by, max_abs_err=fast_err)
    # each q tile's K / V box once; the Hopper path's 128-row CTAs (3 a 360-row
    # tile) each read it through L2
    box_bytes = h * (n // int(np.prod(tile))) * keys * d * 2 * 2
    l2_bytes = box_bytes * -(-int(np.prod(tile)) // 128)
    for var in VARIANTS:
        kern = lambda: sta_diag_attention(q, k, v, variant=var, **skw)  # noqa: E731
        mma = lambda: sta_diag_attention_mma_sync(q, k, v, variant=var, **skw)  # noqa: E731
        sta_path_once(torch, f"sta_diag {var}", kern, True, kernel="sta_diag")
        mma_err = None
        if var == "dma_only":
            if kern().any() or mma().any():
                raise RuntimeError("sta_diag dma_only: a non-zero output")
            err, plain_ms = 0.0, None
            mma_err = 0.0
        elif var == "no_dma":  # undefined output: run twice and timed, not compared
            kern(), kern()
            torch.cuda.synchronize()
            err, plain_ms = None, None
        else:
            want, plain_ms = timed_once(torch, lambda: sta_diag_ref(q, k, v, variant=var, **skw))
            err = compare(torch, f"sta_diag {var} (1,12,72000,128) tile {tile}, Hopper path",
                          kern(), want)
            mma_err = compare(torch, f"sta_diag {var}, mma.sync kernel", mma(), want)
            del want
        if var == "dma_only":
            b_ms, b_by = bound_ms(0.0, 4.0 * n * d * 2 * h, PEAK_BF16)
        else:
            b_ms, b_by = bound_ms(flops, 4.0 * n * d * 2 * h, PEAK_BF16)
        out["sta_diag"][var] = r = dict(ms=time_ms(torch, kern, 5),
                                        mma_sync_ms=time_ms(torch, mma, 5),
                                        ms_again=time_ms(torch, kern, 5), plain_ms=plain_ms,
                                        bound_ms=b_ms, bound_by=b_by, max_abs_err=err,
                                        mma_sync_max_abs_err=mma_err,
                                        sta_pipe_fast_ms=pipe_fast_ms)
        r["bound_share"] = b_ms / r["ms"]
        r["mma_sync_bound_share"] = b_ms / r["mma_sync_ms"]
        r["l2_gb_per_s"] = l2_bytes / r["ms"] / 1e6
        log(f"sta_diag {var}: {r}; the boxes read {l2_bytes / 1e9:.2f} GB through L2 "
            f"({r['l2_gb_per_s']:.1f} GB/s: {box_bytes / 1e9:.2f} GB of boxes, each read by "
            f"the 3 128-row CTAs of its 360-row tile)")
    # no_dma left no copy in flight: full again, right
    compare(torch, "sta_diag full after no_dma", sta_diag_attention(q, k, v, **skw),
            sta_diag_ref(q, k, v, **skw))
    out["sta_diag"]["l2_bytes"] = l2_bytes
    out["sta_diag"]["box_bytes"] = box_bytes
    mask = sta_raster_mask(torch, grid, tile, dev)
    out["sta_diag"]["library_ms"], lib_err = masked_sdpa_ms(torch, "sta_diag", q, k, v, mask)
    if lib_err:
        out["sta_diag"]["library_error"] = lib_err
    out["sta_pipe_fast"]["library_ms"] = out["sta_diag"]["library_ms"]
    sta_rates(out["sta_pipe_fast"], flops)
    log(f"sta_pipe fast (1,12,72000,128), 12 heads: {out['sta_pipe_fast']}")
    del mask
    torch.cuda.empty_cache()

    # ---- sta_pipe's stable softmax and variants at the same call (12 heads)
    for mode, extra in (("stable", dict(softmax="stable")), ("dots", dict(variant="dots")),
                        ("qk", dict(variant="qk")), ("sT", dict(variant="sT"))):
        line = "228" if mode == "stable" else {"dots": "298", "qk": "294", "sT": "273"}[mode]
        mflops = flops / 2 if mode == "qk" else flops  # qk: no PV product
        sta_path_once(torch, f"sta_pipe {mode}",
                      lambda: sta_pipe_attention(q, k, v, all12, **skw, **extra), False)
        out["sta_pipe"][mode] = {"720p_77f_12_heads": mode_case(
            torch, f"sta_pipe {mode} (1,12,72000,128) tile {tile}",
            lambda: sta_pipe_attention(q, k, v, all12, **skw, **extra),
            lambda: sta_pipe_attention_ref(q, k, v, all12, **skw, **extra), pipe_fast,
            mflops, 4.0 * n * d * 2 * h, f"vorta_tpu/ops/sta_pipe.py:{line}")}
    del q, k, v
    # stable with HunyuanVideo's text tail: (1,24,43200,128) + 256 keys (83 valid), 16 heads
    hgrid, htile, h = GRID_HY_45F, (6, 9, 8), 24
    n = hgrid[0] * hgrid[1] * hgrid[2]
    act = torch.tensor(HY_ACTIVE, device=dev)
    n_act = int(act.sum().item())
    q, k, v = (randn(1, h, n, d) for _ in range(3))
    tk, tv = randn(1, h, HY_TEXT, d), randn(1, h, HY_TEXT, d)
    tb = torch.where(torch.arange(HY_TEXT, device=dev) < HY_VALID, 0.0, -1e30)[None]
    hkw = dict(latent_shape=hgrid, tile=htile, window=(3, 3, 3), text_k=tk, text_v=tv,
               text_bias=tb)
    hkeys = int(np.prod([min(3, hgrid[a] // htile[a]) * htile[a] for a in range(3)])) + HY_VALID
    sta_path_once(torch, "sta_pipe stable + text tail",
                  lambda: sta_pipe_attention(q, k, v, act, softmax="stable", **hkw), False)
    out["sta_pipe"]["stable"]["hunyuan_45f_text"] = mode_case(
        torch, f"sta_pipe stable (1,24,{n},128) + {HY_TEXT} text ({HY_VALID} valid), "
        f"{n_act} of 24 heads",
        lambda: sta_pipe_attention(q, k, v, act, softmax="stable", **hkw),
        lambda: sta_pipe_attention_ref(q, k, v, act, softmax="stable", **hkw),
        lambda: sta_pipe_attention(q, k, v, act, **hkw), 4.0 * n * hkeys * d * n_act,
        (4.0 * n + 2 * HY_TEXT) * d * 2 * n_act, "vorta_tpu/ops/sta_pipe.py:228")
    del q, k, v, tk, tv

    # ---- flash_manual's stable softmax: Wan FULL (1,12,31744,128), 8 routed, and the
    # HunyuanVideo FULL joint layout with kv_bias (1,24,45056,128), 16 routed
    call = routed_geometry(attention_config("wan-1_3B", GRID_480P_77F)).full
    wact = torch.tensor(ACTIVE_HEADS, device=dev)
    w_act = int(wact.sum().item())
    q, k, v = (randn(1, 12, call.q_pad, d) for _ in range(3))
    ki, kc = call.tables.on(dev)
    cnt = torch.where(wact[:, None] > 0, kc, 0).to(torch.int32)
    fkw = dict(scale=d**-0.5, block_q=call.block_q, block_kv=call.block_kv,
               kv_valid_len=call.valid_len)
    nv = call.valid_len
    qa, ka, va = (x[:, wact > 0, :nv] for x in (q, k, v))
    lib = time_ms(torch, lambda: F.scaled_dot_product_attention(qa, ka, va), 5)
    del qa, ka, va
    out["flash_manual"]["wan_full_31200"] = mode_case(
        torch, f"flash_manual stable (1,12,{call.q_pad},128), valid {nv}, {w_act} routed",
        lambda: sparse_flash_attention_manual(q, k, v, ki, cnt, softmax="stable", **fkw),
        lambda: sparse_flash_attention_manual_ref(q, k, v, ki, cnt, softmax="stable", **fkw),
        lambda: sparse_flash_attention_manual(q, k, v, ki, cnt, softmax="fast", **fkw),
        4.0 * nv * nv * d * w_act, 4.0 * nv * d * 2 * w_act,
        "vorta_tpu/ops/flash_manual.py:181", lib)
    del q, k, v
    hcfg = attention_config("hunyuan-13B", GRID_HY_45F)
    jcfg = joint.JointConfig(hcfg, HY_TEXT)
    lay = joint.joint_layouts(jcfg)["full"]
    mask = hy_text_mask(torch, dev)
    bias = joint._bias(mask, lay, hcfg.seq_len)
    q, k, v = (randn(1, h, lay.total, d) for _ in range(3))
    ki, kc = dense_tables(lay.total // lay.block_q, lay.total // lay.block_kv).on(dev)
    cnt = torch.where(act[:, None] > 0, kc, 0).to(torch.int32)
    fkw = dict(scale=d**-0.5, block_q=lay.block_q, block_kv=lay.block_kv, kv_bias=bias)
    rows, vis = hcfg.seq_len + HY_TEXT, hcfg.seq_len + HY_VALID
    qa, ka, va = (x[:, act > 0] for x in (q, k, v))
    lib = time_ms(torch, lambda: F.scaled_dot_product_attention(
        qa, ka, va, attn_mask=bias.to(bf16)[None, None]), 3)
    del qa, ka, va
    out["flash_manual"]["hunyuan_full_joint"] = mode_case(
        torch, f"flash_manual stable (1,24,{lay.total},128) with kv_bias, {n_act} routed",
        lambda: sparse_flash_attention_manual(q, k, v, ki, cnt, softmax="stable", **fkw),
        lambda: sparse_flash_attention_manual_ref(q, k, v, ki, cnt, softmax="stable", **fkw),
        lambda: sparse_flash_attention_manual(q, k, v, ki, cnt, softmax="fast", **fkw),
        4.0 * rows * vis * d * n_act, (2 * rows + 2 * vis) * d * 2 * n_act + lay.total * 4,
        "vorta_tpu/ops/flash_manual.py:181", lib)
    del q, k, v

    # ---- sta_batched's stable softmax: the HunyuanVideo (2, 9, 8) joint layout
    hy = dataclasses.replace(hcfg, sta_tile=HY_TILE_298)
    jcfg = joint.JointConfig(hy, HY_TEXT)
    lay = joint.joint_layouts(jcfg)["sta"]
    ki, kc, bits = joint._joint_sta_tables(jcfg).on(dev)
    bias = joint._bias(mask, lay, hy.seq_len)
    tpt = hy.tokens_per_tile
    q, k, v = (randn(1, h, lay.total, d) for _ in range(3))
    bkw = dict(pair_bits=bits, tokens_per_tile=tpt, kv_bias=bias, scale=d**-0.5,
               block_q=lay.block_q, block_kv=lay.block_kv)
    vis_t = torch.from_numpy(joint._joint_sta_subtile_mask(jcfg)[0]).to(dev)
    live = (bias.reshape(-1, tpt) > -1e29).sum(dim=1)
    pairs = int((vis_t.long() * live[None]).sum().item()) * tpt
    out["sta_batched"]["hunyuan_45f_298_joint"] = mode_case(
        torch, f"sta_batched stable (1,24,{lay.total},128), pair bits, kv_bias, {n_act} heads",
        lambda: sta_flash_headbatched(q, k, v, ki, kc, act, softmax="stable", **bkw),
        lambda: sta_flash_headbatched_ref(q, k, v, ki, kc, act, softmax="stable", **bkw),
        lambda: sta_flash_headbatched(q, k, v, ki, kc, act, softmax="fast", **bkw),
        4.0 * pairs * d * n_act, 4 * lay.total * d * 2 * n_act + lay.total * 4,
        "vorta_tpu/ops/sta_batched.py:155",
        # the joint STA expert reads back the video rows and the text rows; the
        # padding rows between them see only the text keys, where a few terms
        # cancel and bf16's rounding of P is not held to the gate's RMS floor
        rows=torch.cat([torch.arange(lay.video_len, device=dev),
                        torch.arange(lay.text_off, lay.text_off + HY_TEXT, device=dev)]))
    del q, k, v
    return out


def options_kernel_rows(opt: dict, diag_ms: dict) -> list:
    """The kernels line's rows of fused_residual_norm and sta_diag."""
    frn = opt["fused_residual_norm"]
    first = frn["wan_31200x1536_gate_mod"]
    shapes = {k: v for k, v in frn.items() if isinstance(v, dict)}
    diag = opt["sta_diag"]
    variants = {k: v for k, v in diag.items() if isinstance(v, dict)}
    full = variants["full"]
    return [
        dict(name="fused_residual_norm", route="cuda", source="vorta_tpu_torch/csrc/fused_norm.cu",
             replaces="vorta_tpu/ops/fused_norm.py:234", _counter="fused_residual_norm",
             **{**first, "max_abs_err": max(x["max_abs_err"] for x in shapes.values())},
             shapes=shapes, backward_rel_l2=frn["backward_rel_l2"],
             no_path="no model calls it, as in the JAX package (vorta_tpu/models/wan.py keeps "
                     "the residual adds in XLA); held against its plain version and timed in "
                     "the options_kernels phase"),
        dict(name="sta_diag", route="cuda", source="vorta_tpu_torch/csrc/sta_diag.cu",
             replaces="tools/sta_diag.py:45", _counter="sta_diag",
             **{**{k: full[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by")},
                "library_ms": diag["library_ms"],
                "max_abs_err": max(x["max_abs_err"] for x in variants.values()
                                   if x["max_abs_err"] is not None)},
             variants=variants, box_bytes=diag["box_bytes"], l2_bytes=diag["l2_bytes"],
             mma_sync_ms=full["mma_sync_ms"], tool_ms_per_call=diag_ms,
             library_covers="scaled_dot_product_attention with the boolean STA mask, 12 heads"),
    ]


def run_sta_diag_path(torch, card: str):
    """python -m vorta_tpu_torch.tools.sta_diag with all five variants, in
    this process (the launch counters see it): ms per call by variant, every
    launch on the Hopper path."""
    from vorta_tpu_torch.ops import _build
    from vorta_tpu_torch.tools import sta_diag

    _build.reset_launches()
    times = sta_diag.main(list(sta_diag.VARIANTS))
    launches = dict(_build.launches)
    n = 2 * 4 * len(sta_diag.VARIANTS)  # a warm-up and the timed calls, 4 each
    want = {**dict.fromkeys(_build.KERNELS, 0), "sta_diag": n, "sta_diag_wgmma": n}
    if set(times) != set(sta_diag.VARIANTS) or launches != want:
        raise RuntimeError(f"sta_diag tool: times {times}, launches {launches} (want {want})")
    log(f"sta_diag tool on {card}: ms per call {times}; launches {launches['sta_diag']}")
    return launches, times


# ---- HunyuanVideo router training and sequence parallelism -----------------------------

# the trainer's HunyuanVideo-13B geometry here: 432 x 768 x 21 frames = (6, 27, 48) =
# 7,776 video tokens, which the (6, 9, 8) tile and the (2, 3, 2) low-res window divide
# (they do not divide the 480 x 832 grids (5 or 20, 30, 52))
HY_TRAIN_GRID = (6, 27, 48)
HY_TRAIN_ARGS = ["--model", "hunyuan-13B", "--synthetic_data", "--num_latent_t", "6",
                 "--video_height", "432", "--video_width", "768"]


def hy_train_launches(dual: int, single: int) -> dict:
    """Kernel launches of one HunyuanVideo router-training micro-step (soft
    student, the teacher in "off_ref", remat), derived from the graph: the
    AdaLN norm 4 per dual and 1 per single block in the student's forward,
    again in its recompute and in the teacher's forward, and once in each
    stream's head (the token refiner's norms are plain LayerNorms); the qk
    prologue once per block in the teacher (soft keeps it unfused, as JAX's
    gate), on the warp-per-row kernel; no attention kernel: the soft
    experts and off_ref run the plain chunked attention, as JAX runs its
    XLA reference there."""
    from vorta_tpu_torch.ops import _build

    n = 4 * dual + single
    return {**dict.fromkeys(_build.KERNELS, 0), "fused_norm": 3 * n + 2,
            "prologue": dual + single, "prologue_rows": dual + single}


def check_hunyuan_train_grads(torch, grid=(6, 9, 8)) -> dict:
    """One router train step of a 2 + 2-block HunyuanVideo-13B-width model:
    the card (bf16, kernels) against the CPU (f32, plain versions), the
    same weights and draws; grid (6, 9, 8), one (6, 9, 8) tile: 432 video +
    256 text tokens (83 valid).  Loss within 2%, router gradients rel L2 <=
    0.1 (phase 8's gates); launches exact."""
    import dataclasses

    from vorta_tpu_torch.cli.sample import attention_config
    from vorta_tpu_torch.models.hunyuan import HUNYUAN_13B, HunyuanModel
    from vorta_tpu_torch.ops import _build
    from vorta_tpu_torch.schedulers.flow_match import train_sigmas
    from vorta_tpu_torch.training.step import (LossWeights, make_hunyuan_router_train_step,
                                               router_partition)

    cfg = dataclasses.replace(HUNYUAN_13B, dual_layers=2, single_layers=2)
    attn = attention_config("hunyuan-13B", grid)
    sig = train_sigmas(5.0)
    step = make_hunyuan_router_train_step(attn, LossWeights(hidden_layer_distill=1.0),
                                          timestep_table=sig * 1000.0, sigma_table=sig)
    lat, text, mask, pooled = (x.cpu() for x in hy_inputs(torch, grid, torch.device("cuda"), 14))
    eps = torch.randn(lat.shape, generator=torch.Generator().manual_seed(15))
    t, s = torch.tensor([float(sig[300] * 1000.0)]), torch.tensor([float(sig[300])])
    gpu = HunyuanModel(cfg, dtype=torch.bfloat16, device="cuda", seed=13)
    cpu = HunyuanModel(cfg, dtype=torch.float32, device="meta").to_empty(device="cpu")
    cpu.load_state_dict(gpu.state_dict())  # the same (bf16-rounded) weights in f32

    def run(model, dev):
        routers = router_partition(model)
        share, m = step.loss(model, *(x.to(dev) for x in (lat, text, mask, pooled, t, s, eps)))
        grads = torch.autograd.grad(share, list(routers.values()))
        return m["loss"].item(), torch.cat([x.flatten().float().cpu() for x in grads]), m

    _build.reset_launches()
    loss_g, grads_g, m = run(gpu, "cuda")
    launches = dict(_build.launches)
    del gpu
    loss_c, grads_c, _ = run(cpu, "cpu")
    expected = hy_train_launches(2, 2)
    if launches != expected:
        raise RuntimeError(f"Hunyuan gradient check: launches {launches} != {expected}")
    rel_loss = abs(loss_g - loss_c) / abs(loss_c)
    rel = ((grads_g - grads_c).norm() / grads_c.norm()).item()
    log(f"Hunyuan gradient check (2 + 2 blocks, 13B widths, {grid} = {attn.seq_len} + 256 "
        f"tokens, tile {attn.sta_tile}, t = {t.item():.1f}): loss card {loss_g:.6f} vs CPU "
        f"{loss_c:.6f} (rel {rel_loss:.2e}, tolerance 0.02); router gradients rel L2 {rel:.4f} "
        f"(tolerance 0.1; |grad| {grads_c.norm().item():.3e}); card metrics "
        f"{ {k: round(float(v), 6) for k, v in m.items()} }; launches {launches} (exact)")
    if not torch.isfinite(grads_g).all() or not (rel_loss <= 0.02 and rel <= 0.1):
        raise RuntimeError("Hunyuan gradient check: the card's train step disagrees with the CPU's")
    del cpu
    return dict(rel_loss=rel_loss, grad_rel_l2=rel)


def run_hunyuan_train_main_path(torch, card: str):
    """cli.train --model hunyuan-13B at full width and depth (20 + 40 blocks,
    24 x 128 heads), (6, 27, 48) = 7,776 video + 256 text tokens: 1
    optimizer step of 1 micro-step and a checkpoint, then resumed for a
    second (its micro-step, the process warm, is the steady one); launches
    exact; then cli.sample --resume_dir --router_checkpoint reads that step
    dir and takes one routed Euler step at the same grid."""
    import math
    import shutil

    import numpy as np

    from vorta_tpu_torch.cli import sample
    from vorta_tpu_torch.cli.train import main as train_main
    from vorta_tpu_torch.ops import _build
    from vorta_tpu_torch.ops.joint_experts import JointConfig, joint_sta_kernel
    from vorta_tpu_torch.training.step import router_partition

    out_dir = HERE / "results" / "port_smoke" / "train_hunyuan"  # listed in .gitignore
    shutil.rmtree(out_dir, ignore_errors=True)
    base = HY_TRAIN_ARGS + ["--gradient_accumulation_steps", "1", "--output_dir", str(out_dir)]
    per_micro = hy_train_launches(20, 40)
    runs = []
    for extra, micro in ((["--max_train_steps", "1"], 1),
                         (["--max_train_steps", "2", "--resume_from_checkpoint", "latest"], 1)):
        _build.reset_launches()
        res = train_main(base + extra)
        launches = dict(_build.launches)
        expected = {k: v * micro for k, v in per_micro.items()}
        if launches != expected:
            raise RuntimeError(f"Hunyuan training launches {launches} != expected {expected}")
        if len(res.micro_s) != micro:
            raise RuntimeError(f"Hunyuan training: {len(res.micro_s)} micro-steps, not {micro}")
        runs.append((res, launches))
        torch.cuda.empty_cache()
    (first, launches), (second, launches_resumed) = runs
    metrics = first.metrics + second.metrics
    if not all(math.isfinite(m[k]) for m in metrics for k in ("loss", "grad_norm")):
        raise RuntimeError(f"Hunyuan training: non-finite metrics {metrics}")
    moved = max((first.router_final[k] - first.router_init[k]).abs().max().item()
                for k in first.router_init)
    if not moved > 0 or (first.final_step, second.init_step, second.final_step) != (1, 1, 2):
        raise RuntimeError(f"Hunyuan training: routers moved {moved}, steps {first.final_step}, "
                           f"resumed at {second.init_step}, ended {second.final_step}")
    if any(not torch.equal(second.router_init[k], first.router_final[k])
           for k in first.router_final):
        raise RuntimeError("Hunyuan training: the resumed run did not start from the checkpoint")
    stats = dict(micro_s=second.micro_s[0], first_micro_s=first.micro_s[0],
                 max_memory_gib=max(first.max_memory_bytes, second.max_memory_bytes) / 2**30)
    log(f"Hunyuan training main path: HunyuanVideo-13B 20 + 40 blocks, {HY_TRAIN_GRID} = 7,776 "
        f"+ 256 tokens, tile (6, 9, 8), soft routing + the off_ref teacher, remat: micro-steps "
        f"{[round(x, 3) for x in first.micro_s + second.micro_s]} s (steady "
        f"{stats['micro_s']:.3f} s per micro-step, the resumed one; the first warms up); peak "
        f"memory "
        f"{stats['max_memory_gib']:.2f} GiB; routers moved by up to {moved:.3e}; resumed at "
        f"step {second.init_step} on {card}")
    for m in metrics:
        log(f"Hunyuan training step {m['step']}: " + ", ".join(
            f"{k} {m[k]:.6g}" for k in ("loss", "l_fm", "l_reg", "l_last", "l_hidden",
                                         "grad_norm", "timestep")))
    log(f"Hunyuan training launches per micro-step {per_micro} (exact over 1 + 1 micro-steps)")
    del first, second, runs
    torch.cuda.empty_cache()

    # serve the trained routers: the step dir and the run's config.json
    ckpt = out_dir / "ckpt" / "step-000002"
    seen = {}
    real = sample.apply_router_state

    def spy(model, state):
        real(model, state)
        seen["routers"] = {k: v.detach().cpu() for k, v in router_partition(model).items()}

    sample.apply_router_state = spy
    try:
        _build.reset_launches()
        with torch.inference_mode():
            res = sample.main(["--model", "hunyuan-13B", "--random_embeds", "--num_frames", "21",
                               "--height", "432", "--width", "768", "--num_inference_steps",
                               "1", "--seed", "0", "--resume_dir", str(out_dir),
                               "--router_checkpoint", str(ckpt), "--output",
                               str(out_dir / "sample.npy")])
    finally:
        sample.apply_router_state = real
    sample_launches = dict(_build.launches)
    state = torch.load(ckpt / "router", weights_only=True)
    if set(seen.get("routers", {})) != set(state) or any(
            not torch.equal(seen["routers"][k], state[k]) for k in state):
        raise RuntimeError("Hunyuan trained sample: the served routers are not the step dir's")
    tables = np.stack(res.routing)
    attn = sample.resolve_attention_config(sample.parse_args(
        ["--model", "hunyuan-13B", "--resume_dir", str(out_dir)]), HY_TRAIN_GRID)
    expected = hy_hard_launches(tables, sta_kernel=joint_sta_kernel(JointConfig(attn, HY_TEXT),
                                                                    128, 2))
    if sample_launches != expected or not torch.isfinite(res.latents).all():
        raise RuntimeError(f"Hunyuan trained sample: launches {sample_launches} != {expected}, "
                           f"finite {bool(torch.isfinite(res.latents).all())}")
    served_on_wgmma(sample_launches, "Hunyuan trained sample")
    heads = np.bincount(tables.reshape(-1), minlength=3)
    stats["sample_s_per_step"] = res.denoise_s
    log(f"Hunyuan trained sample: cli.sample --resume_dir --router_checkpoint {ckpt.name}, "
        f"{HY_TRAIN_GRID} grid, 1 routed Euler step {res.denoise_s:.3f} s; heads full "
        f"{heads[0]}, lowres {heads[1]}, sta {heads[2]}; launches {sample_launches} (exact)")
    shutil.rmtree(out_dir, ignore_errors=True)
    return {"train": launches, "train_resumed": launches_resumed,
            "sample": sample_launches}, stats


def run_sp_world_one(torch, card: str):
    """Sequence parallelism at world size 1 on the card, through a real NCCL
    process group (a file:// store), each run against the same run without
    a group, bit for bit, launches unchanged: cli.sample --sp_size 1
    --dp_size 1, Wan-1.3B routed 480p x 77f, 2 UniPC steps with CFG; one
    HunyuanVideo-13B routed 720p x 45f Euler step through the pipeline
    (sp_group); a 2-block Wan-1.3B-width train step with sp_group and the
    frozen blocks layer-sharded over the group (--shard_frozen), loss and
    router gradients.  Also the all_to_all's time at Wan's shape."""
    import dataclasses
    import shutil

    import torch.distributed as dist

    from vorta_tpu_torch.cli.sample import attention_config, main as sample_main
    from vorta_tpu_torch.config import WAN_1_3B
    from vorta_tpu_torch.models.hunyuan import HUNYUAN_13B, HunyuanModel
    from vorta_tpu_torch.models.wan import WanModel
    from vorta_tpu_torch.ops import _build
    from vorta_tpu_torch.parallel import all_to_all_heads_to_seq, make_mesh
    from vorta_tpu_torch.parallel.fsdp import shard_frozen_blocks
    from vorta_tpu_torch.pipelines.hunyuan_t2v import HunyuanSamplingConfig, HunyuanT2VPipeline
    from vorta_tpu_torch.schedulers.flow_match import train_sigmas
    from vorta_tpu_torch.training.step import LossWeights, make_router_train_step, router_partition

    tmp = HERE / "results" / "port_smoke" / "sp1"  # listed in .gitignore
    shutil.rmtree(tmp, ignore_errors=True)
    tmp.mkdir(parents=True)
    launches, stats = {}, {}

    def wan_sample(extra, name):
        _build.reset_launches()
        with torch.inference_mode():
            res = sample_main(["--model", "wan-1_3B", "--random_embeds", "--num_inference_steps",
                               "2", "--seed", "0", "--output", str(tmp / f"{name}.npy")] + extra)
        return res, dict(_build.launches)

    # the Hunyuan model and inputs, built once for both runs
    grid = GRID_HY_45F
    hy = HunyuanModel(HUNYUAN_13B, dtype=torch.bfloat16, device="cuda", seed=0)
    lat, text, mask, pooled = hy_inputs(torch, grid, torch.device("cuda"), 17)
    hy_attn = attention_config("hunyuan-13B", grid)
    hs = HunyuanSamplingConfig(num_inference_steps=1, routing_mode="hard")

    def hy_step(group):
        pipe = HunyuanT2VPipeline(hy, attn_cfg=hy_attn, sp_group=group)
        routing = []
        _build.reset_launches()
        torch.cuda.synchronize()
        t0 = time.time()
        with torch.inference_mode():
            out = pipe(lat, text, mask, pooled, sampling=hs, routing=routing)
        torch.cuda.synchronize()
        return out, dict(_build.launches), time.time() - t0

    # the 2-block Wan train step, no group first
    cfg2 = dataclasses.replace(WAN_1_3B, num_layers=2)
    wgrid = (4, 12, 8)
    wattn = attention_config("wan-1_3B", wgrid)
    sig = train_sigmas(5.0)
    gen = torch.Generator(device="cuda").manual_seed(18)
    wlat = torch.randn((1, wgrid[0], 2 * wgrid[1], 2 * wgrid[2], 16), generator=gen,
                       device="cuda")
    wctx = torch.randn((1, TEXT_LEN, cfg2.text_dim), generator=gen, device="cuda")
    weps = torch.randn(wlat.shape, generator=gen, device="cuda")
    wt = torch.tensor([float(sig[300] * 1000.0)], device="cuda")
    ws = torch.tensor([float(sig[300])], device="cuda")

    def train_step(model, group, sharded):
        step = make_router_train_step(wattn, LossWeights(hidden_layer_distill=1.0),
                                      timestep_table=sig * 1000.0, sigma_table=sig,
                                      sp_group=group, frozen_sharded=sharded)
        routers = router_partition(model)
        _build.reset_launches()
        share, m = step.loss(model, wlat, wctx, wt, ws, weps)
        grads, m = step.reduce(list(torch.autograd.grad(share, list(routers.values()))), m)
        torch.cuda.synchronize()
        return m, torch.cat([g.flatten() for g in grads]), dict(_build.launches)

    wan = WanModel(cfg2, dtype=torch.bfloat16, device="cuda", seed=19)
    m_plain, g_plain, l_plain = train_step(wan, None, None)
    ref_no_group, l_wan_plain = wan_sample([], "plain")
    hy_step(None)  # warms the freshly built model up
    hy_plain, l_hy_plain, hy_plain_s = hy_step(None)

    dist.init_process_group("nccl", init_method=f"file://{tmp}/store", rank=0, world_size=1)
    try:
        mesh = make_mesh(sp_size=1, dp_size=1)
        # the communicator starts at its first collective: start it before the timed runs
        dist.all_reduce(torch.ones(1, device="cuda"))
        # cli.sample joins the group the process holds (--dp_size asks for the mesh)
        with_group, l_wan_sp = wan_sample(["--sp_size", "1", "--dp_size", "1"], "sp1")
        if not torch.equal(with_group.latents, ref_no_group.latents) or l_wan_sp != l_wan_plain:
            raise RuntimeError(f"SP world 1: Wan cli.sample differs from the run without a group "
                               f"(launches {l_wan_sp} vs {l_wan_plain})")
        hy_sp, l_hy_sp, hy_sp_s = hy_step(mesh.sp_group)
        if not torch.equal(hy_sp, hy_plain) or l_hy_sp != l_hy_plain:
            raise RuntimeError(f"SP world 1: HunyuanVideo step differs (launches {l_hy_sp} vs "
                               f"{l_hy_plain})")
        served_on_wgmma(l_hy_sp, "SP world 1 HunyuanVideo 45f")
        shard_frozen_blocks(wan.blocks, mesh.dp_group)
        m_sp, g_sp, l_sp = train_step(wan, mesh.sp_group, mesh.dp_group)
        same = all(torch.equal(m_sp[k], m_plain[k]) for k in m_plain) and torch.equal(g_sp, g_plain)
        if not same or l_sp != l_plain:
            raise RuntimeError(f"SP world 1: the sharded train step differs: {m_sp} vs {m_plain}, "
                               f"launches {l_sp} vs {l_plain}")
        # one all_to_all at Wan 480p x 77f's q shape: 4 a block (q, k, v, out), 30 blocks
        x = torch.randn((1, 12, 31200, 128), device="cuda", dtype=torch.bfloat16)
        a2a_ms = device_ms(torch, lambda: all_to_all_heads_to_seq(x, mesh.sp_group), 10)
    finally:
        dist.destroy_process_group()
    wan_s, wan_sp_s = ref_no_group.denoise_s, with_group.denoise_s
    stats = dict(wan_s_per_step=wan_s / 2, wan_sp_s_per_step=wan_sp_s / 2,
                 hy_s_per_step=hy_plain_s, hy_sp_s_per_step=hy_sp_s, all_to_all_ms=a2a_ms,
                 wan_all_to_all_share=4 * 30 * 4 * a2a_ms / 1e3 / wan_sp_s)
    launches = {"sp1_wan_480p_77f": l_wan_sp, "sp1_hunyuan_45f": l_hy_sp,
                "sp1_train_wan_2blk": l_sp}
    log(f"SP at world size 1 (NCCL, file:// store) on {card}: Wan-1.3B cli.sample --sp_size 1 "
        f"--dp_size 1 480p x 77f routed, 2 UniPC steps with CFG, {wan_sp_s / 2:.3f} s per step "
        f"(no group {wan_s / 2:.3f}); HunyuanVideo-13B 720p x 45f routed, 1 Euler step "
        f"{hy_sp_s:.3f} s (no group {hy_plain_s:.3f}); latents bit for bit, launches unchanged; "
        f"the 2-block Wan train step with sp_group and the frozen blocks sharded over the "
        f"group: loss {float(m_sp['loss']):.6f} and router gradients bit for bit; one "
        f"all_to_all_heads_to_seq at (1, 12, 31200, 128) bf16 {a2a_ms:.4f} ms, 480 a Wan "
        f"sample's 4 forwards: {stats['wan_all_to_all_share']:.4f} of its denoise time")
    del hy, wan
    shutil.rmtree(tmp, ignore_errors=True)
    return launches, stats


# ---- evaluation and the last entry points (no new kernel) -----------------------------

ROUTER_480P = "assets/bench_router_wan1_3b.npz"  # the JAX package's router at 480p
CACHE_POLY_720P = "assets/cache_poly_wan1_3b_720p.npz"
EXPERTS = ("full", "lowres", "sta")


def off_wan_launches(n_fwd: int, blocks: int = 30) -> dict:
    """Kernel launches of ``n_fwd`` Wan forwards with routing off (Wan-1.3B's
    30 blocks by default)."""
    from vorta_tpu_torch.ops import _build

    return {**dict.fromkeys(_build.KERNELS, 0), "flash": 2 * blocks * n_fwd,
            "flash_wgmma": 2 * blocks * n_fwd, "fused_norm": (2 * blocks + 1) * n_fwd,
            "prologue": blocks * n_fwd, "prologue_rows": blocks * n_fwd}


def routed_run_launches(routing: list, cache_log: list) -> dict:
    """Kernel launches of a routed Wan run from its routing tables (one per
    computed forward) and step-cache log: a skipped forward runs only its
    head's norm."""
    import numpy as np

    want = routed_wan_launches(np.stack(routing), "sta_pipe", len(routing))
    want["fused_norm"] += sum(s for *_, s in cache_log)
    return want


def mix_of_ids(tables) -> dict:
    """The expert mix counted from routing ids, rounded as io/quality's."""
    import numpy as np

    ids = np.stack(tables)
    return {k: round(float((ids == e).sum()) / ids.size, 4) for e, k in enumerate(EXPERTS)}


def finite_numbers(tree, where: str = "summary") -> int:
    """Raise unless every number in ``tree`` is finite; their count."""
    import math

    if isinstance(tree, dict):
        return sum(finite_numbers(v, f"{where}.{k}") for k, v in tree.items())
    if isinstance(tree, list):
        return sum(finite_numbers(v, f"{where}[{i}]") for i, v in enumerate(tree))
    if isinstance(tree, (int, float)) and not isinstance(tree, bool):
        if not math.isfinite(tree):
            raise RuntimeError(f"{where} = {tree}: not finite")
        return 1
    return 0


def hooked(cls, tables: list, built: list):
    """A builder of ``cls`` whose models append each forward's routing ids
    to ``tables`` (a forward hook) and themselves to ``built``."""
    def build(*a, **kw):
        model = cls(*a, **kw)
        model.register_forward_hook(lambda m, inp, out: tables.append(out.expert_ids))
        built.append(model)
        return model
    return build


def run_bench_compare_path(torch, card: str):
    """python -m vorta_tpu_torch.cli.bench_compare through main(argv): Wan-1.3B
    480p x 77f, 2 UniPC steps with CFG, the JAX package's 480p router, the
    cached arm and a two-value tau sweep; Wan with --mm int8_static (1 step);
    HunyuanVideo-13B 720p x 45f, 1 Euler step.  Gates: every arm's launches
    exact (the baseline's: routing off, no routed kernel), the routing mix
    equal to the mix counted from the routing ids, every number in
    summary.json finite, and the vorta arm's --seed latents bit for bit
    cli.sample's for the same seed, router and flags."""
    import gc
    from unittest import mock

    import numpy as np

    from vorta_tpu_torch.cli import bench_compare, sample
    from vorta_tpu_torch.io.from_jax import load_trained_router
    from vorta_tpu_torch.ops import _build

    out = HERE / "results" / "port_smoke" / "compare"  # listed in .gitignore
    launches, stats = {}, {}
    wan = ["--model", "wan-1_3B", "--num_frames", "77", "--height", "480", "--width", "832",
           "--seed", "0", "--router_npz", str(HERE / ROUTER_480P)]

    def arms_exact(res, what, n_fwd, hunyuan=False):
        for arm, got in res.launches.items():
            if arm == "baseline":
                want = (off_wan_launches(n_fwd) if not hunyuan else {
                    **dict.fromkeys(_build.KERNELS, 0), "flash_manual": 60 * n_fwd,
                    "flash_manual_wgmma": 60 * n_fwd, "prologue": 60 * n_fwd,
                    "prologue_rows": 60 * n_fwd, "fused_norm": 121 * n_fwd})
            elif hunyuan:
                want = hy_hard_launches(np.stack(res.routing[arm]))
            else:
                want = routed_run_launches(res.routing[arm], res.cache_log[arm])
            if got != want:
                raise RuntimeError(f"bench_compare {what} arm {arm}: launches {got} != {want}")
            served_on_wgmma(got, f"bench_compare {what} {arm}")

    for name, extra, steps in (
            ("wan_480p_77f", ["--cache_threshold", "0.75", "--cache_poly",
                              str(HERE / CACHE_POLY_720P), "--tau_sweep", "0.2,0.5"], 2),
            ("wan_int8_static", ["--mm", "int8_static"], 1)):
        _build.reset_launches()
        res = bench_compare.main(wan + ["--num_inference_steps", str(steps),
                                        "--output_dir", str(out / name), *extra])
        launches[f"bench_compare_{name}"] = total = dict(_build.launches)
        summ = res.summary
        n_fwd = 2 * steps * 2  # the --seed run and the timed run, CFG's two forwards a step
        arms_exact(res, name, n_fwd)
        if len(res.routing["vorta"]) != n_fwd:
            raise RuntimeError(f"bench_compare {name}: {len(res.routing['vorta'])} routed "
                               f"forwards, not {n_fwd}")
        # the mix of return_scores (the --seed run) against the one counted from its ids
        mix = mix_of_ids(res.routing["vorta"][:n_fwd // 2])
        if summ["routing_mix"] != mix:
            raise RuntimeError(f"bench_compare {name}: routing_mix {summ['routing_mix']} != "
                               f"the routing ids' {mix}")
        for row in summ.get("tau_sweep", []):
            ids_mix = mix_of_ids(res.routing[f"tau_{row['tau']}"][:n_fwd // 2])
            if row["mix"] != ids_mix:
                raise RuntimeError(f"bench_compare tau {row['tau']}: mix {row['mix']} != "
                                   f"{ids_mix}")
        numbers = finite_numbers(summ)
        arm_sum = {k: sum(a[k] for a in res.launches.values()) for k in total}
        if name == "wan_int8_static":  # the 3 calibration forwards (t = 200, 500, 800)
            calib = {k: total[k] - arm_sum[k] for k in ("flash", "fused_norm", "prologue")}
            if calib != {"flash": 90, "fused_norm": 183, "prologue": 90}:
                raise RuntimeError(f"bench_compare int8_static: calibration launches {calib}")
        elif total != arm_sum:
            raise RuntimeError(f"bench_compare {name}: launches outside the arms")
        if name == "wan_480p_77f":
            # cli.sample with the same seed, router (and its time embedder) and flags
            port_wan = sample.WanModel

            def with_router(*a, **kw):
                model = port_wan(*a, **kw)
                load_trained_router(model, HERE / ROUTER_480P)
                return model

            with mock.patch.object(sample, "WanModel", with_router):
                ref = sample.main(["--model", "wan-1_3B", "--random_embeds", "--seed", "0",
                                   "--num_inference_steps", str(steps),
                                   "--output", str(out / "sample_vorta.npy")])
            if not torch.equal(ref.latents, res.latents["vorta"]):
                raise RuntimeError("bench_compare: the vorta arm's latents are not cli.sample's "
                                   "for the same seed, router and flags")
        stats[name] = {k: v for k, v in summ.items() if k not in ("vbench",)}
        log(f"bench_compare {name} on {card}: " + ", ".join(
            f"{arm} {summ[arm]['s_per_step']:.3f} s/step" for arm in res.launches
            if arm in summ) + f"; speedup {summ['speedup']}, routing mix {summ['routing_mix']}, "
            f"PSNR {summ['psnr_vorta_vs_baseline_db']} dB, SSIM {summ['ssim_vorta_vs_baseline']} "
            f"(random DiT weights); {numbers} numbers finite; launches exact per arm"
            + ("; the vorta arm bit for bit cli.sample's" if name == "wan_480p_77f" else ""))
        del res
        gc.collect()
        torch.cuda.empty_cache()

    _build.reset_launches()
    res = bench_compare.main(["--model", "hunyuan-13B", "--num_frames", "45", "--height", "720",
                              "--width", "1280", "--num_inference_steps", "1", "--seed", "0",
                              "--output_dir", str(out / "hunyuan_45f")])
    launches["bench_compare_hunyuan_45f"] = dict(_build.launches)
    arms_exact(res, "hunyuan_45f", 2, hunyuan=True)
    summ = res.summary
    finite_numbers(summ)
    stats["hunyuan_45f"] = {k: v for k, v in summ.items() if k != "vbench"}
    log(f"bench_compare hunyuan_45f on {card}: baseline {summ['baseline']['s_per_step']:.3f}, "
        f"vorta {summ['vorta']['s_per_step']:.3f} s per Euler step; speedup {summ['speedup']}, "
        f"PSNR {summ['psnr_vorta_vs_baseline_db']} dB, SSIM {summ['ssim_vorta_vs_baseline']} "
        "(random DiT weights); launches exact per arm")
    return launches, stats


def run_calibrate_path(torch, card: str):
    """python -m vorta_tpu_torch.tools.calibrate_int8 --geom 480p --timesteps
    400,700 through main(argv): its scales bit for bit a direct max over the
    same model's calibrate_mm forwards at those points, / 127; launches
    exact; then cli.sample --mm int8 --act_scales <that file>, one routed
    UniPC step with CFG, launches exact."""
    from unittest import mock

    import numpy as np

    from vorta_tpu_torch.cli.sample import main as sample_main
    from vorta_tpu_torch.config import WAN_1_3B
    from vorta_tpu_torch.ops import _build
    from vorta_tpu_torch.tools import calibrate_int8

    path = HERE / "results" / "port_smoke" / "act_scales_480p.npz"
    tables, built, launches = [], [], {}
    _build.reset_launches()
    t0 = time.time()
    with mock.patch.object(calibrate_int8, "WanModel",
                           hooked(calibrate_int8.WanModel, tables, built)):
        scales = calibrate_int8.main(["--geom", "480p", "--timesteps", "400,700", "--router",
                                      str(HERE / ROUTER_480P), "--out", str(path)])
    tool_s = time.time() - t0
    launches["calibrate_int8_480p"] = got = dict(_build.launches)
    want = routed_wan_launches(np.stack(tables), "sta_pipe", 2)
    if got != want:
        raise RuntimeError(f"calibrate_int8: launches {got} != {want}")
    model = built.pop()
    attn = calibrate_int8.bench_attn_cfg("480p")
    points = calibrate_int8.calibration_points((400.0, 700.0), "480p", WAN_1_3B.text_len,
                                               WAN_1_3B.text_dim, WAN_1_3B.in_channels,
                                               torch.device("cuda"))
    with torch.inference_mode():
        cal = [model(lat, t, ctx, attn_cfg=attn, routing_mode="hard",
                     calibrate_mm=True).mm_calibration for lat, t, ctx in points]
    direct = {k: (torch.maximum(cal[0][k], cal[1][k]).cpu().numpy() / 127.0).astype(np.float32)
              for k in cal[0]}
    saved = np.load(path)
    if set(direct) != set(scales) or set(saved.files) != set(scales) or not all(
            np.array_equal(scales[k], direct[k]) and np.array_equal(saved[k], direct[k])
            for k in direct):
        raise RuntimeError("calibrate_int8: the scales are not the direct max over the "
                           "calibration forwards / 127")
    del model, cal
    _build.reset_launches()
    res = sample_main(["--model", "wan-1_3B", "--random_embeds", "--num_inference_steps", "1",
                       "--seed", "0", "--mm", "int8", "--act_scales", str(path),
                       "--output", str(HERE / "results" / "port_smoke" / "static_scales.npy")])
    launches["sample_act_scales_480p"] = got = dict(_build.launches)
    want = routed_wan_launches(np.stack(res.routing), "sta_pipe", 2)
    if got != want or not torch.isfinite(res.latents).all():
        raise RuntimeError(f"cli.sample --act_scales: launches {got} != {want}, or non-finite")
    stats = {"tool_s": tool_s, "sites": len(scales),
             "scale_range": [float(min(v.min() for v in scales.values())),
                             float(max(v.max() for v in scales.values()))],
             "sample_s_per_step": res.denoise_s / res.steps}
    log(f"calibrate_int8 --geom 480p --timesteps 400,700 on {card}: {len(scales)} sites x 30 "
        f"layers in {tool_s:.1f} s, bit for bit the direct max / 127; cli.sample --mm int8 "
        f"--act_scales: {stats['sample_s_per_step']:.3f} s per step; launches exact")
    return launches, stats


def run_fit_cache_poly_path(torch, card: str):
    """python -m vorta_tpu_torch.tools.fit_cache_poly --model wan-1_3B at 480p
    x 77f, 8 Euler steps, CFG 5, the JAX package's 480p router: 7 points,
    finite coefficients and r2, launches exact (16 routed forwards); then
    cli.sample --cache_threshold 0.75 --cache_poly <that file>, 4 UniPC
    steps with CFG, launches exact."""
    from unittest import mock

    import numpy as np

    from vorta_tpu_torch.cli.sample import main as sample_main
    from vorta_tpu_torch.ops import _build
    from vorta_tpu_torch.tools import fit_cache_poly

    path = HERE / "results" / "port_smoke" / "cache_poly_480p.npz"
    tables, built, launches = [], [], {}
    _build.reset_launches()
    t0 = time.time()
    with mock.patch.object(fit_cache_poly, "WanModel",
                           hooked(fit_cache_poly.WanModel, tables, built)):
        rec = fit_cache_poly.main(["--model", "wan-1_3B", "--num_frames", "77", "--height",
                                   "480", "--width", "832", "--steps", "8", "--guidance_scale",
                                   "5", "--router", str(HERE / ROUTER_480P), "--out", str(path)])
    tool_s = time.time() - t0
    del built[:]
    launches["fit_cache_poly_480p"] = got = dict(_build.launches)
    want = routed_wan_launches(np.stack(tables), "sta_pipe", 16)
    if len(tables) != 16 or got != want:
        raise RuntimeError(f"fit_cache_poly: launches {got} != {want} ({len(tables)} forwards)")
    coeffs = np.load(path)["coefficients"]
    if rec["points"] != 7 or coeffs.shape != (5,) or not np.isfinite(coeffs).all() or not (
            np.isfinite(rec["r2_exact"])):
        raise RuntimeError(f"fit_cache_poly: {rec}")
    _build.reset_launches()
    res = sample_main(["--model", "wan-1_3B", "--random_embeds", "--num_inference_steps", "4",
                       "--seed", "0", "--cache_threshold", "0.75", "--cache_poly", str(path),
                       "--output", str(HERE / "results" / "port_smoke" / "cache_poly.npy")])
    launches["sample_cache_poly_480p"] = got = dict(_build.launches)
    want = routed_run_launches(res.routing, res.cache_log)
    if got != want or not torch.isfinite(res.latents).all():
        raise RuntimeError(f"cli.sample --cache_poly: launches {got} != {want}, or non-finite")
    skipped = sum(s for *_, s in res.cache_log)
    stats = {"tool_s": tool_s, "points": rec["points"], "r2": rec["r2_exact"],
             "coefficients": rec["coefficients"], "sample_skipped_forwards": skipped,
             "sample_s_per_step": res.denoise_s / res.steps}
    log(f"fit_cache_poly Wan-1.3B 480p x 77f, 8 Euler steps, CFG 5 on {card}: {rec['points']} "
        f"points in {tool_s:.1f} s, r2 {rec['r2_exact']:.4f}, coefficients {rec['coefficients']}; "
        f"cli.sample --cache_threshold 0.75 --cache_poly: {skipped} of {len(res.cache_log)} "
        f"forwards skipped, {stats['sample_s_per_step']:.3f} s per step; launches exact")
    return launches, stats


def run_profiling_path(torch, card: str):
    """io/profiling.profile_call on one routed Wan-1.3B 480p x 77f forward
    (the JAX package's 480p router, t = 500): each port kernel's device
    events, counted by its symbols (io/profiling.SYMBOL_COUNTERS), equal its
    launch counter for that forward; the top 25 device ops by name."""
    from vorta_tpu_torch.cli.sample import attention_config
    from vorta_tpu_torch.config import WAN_1_3B
    from vorta_tpu_torch.io import profiling
    from vorta_tpu_torch.io.from_jax import load_trained_router
    from vorta_tpu_torch.models.wan import WanModel
    from vorta_tpu_torch.ops import _build

    model = WanModel(WAN_1_3B, dtype=torch.bfloat16, device="cuda", seed=0)
    load_trained_router(model, HERE / ROUTER_480P)
    g = torch.Generator(device="cuda").manual_seed(5)
    t_grid, h_grid, w_grid = GRID_480P_77F
    lat = torch.randn((1, t_grid, 2 * h_grid, 2 * w_grid, 16), generator=g, device="cuda")
    ctx = torch.randn((1, TEXT_LEN, 4096), generator=g, device="cuda")
    t = torch.tensor([500.0], device="cuda")
    attn = attention_config("wan-1_3B", GRID_480P_77F)
    seen = []

    def forward():
        with torch.inference_mode():
            seen.append(model(lat, t, ctx, attn_cfg=attn, routing_mode="hard").expert_ids)

    forward()  # warm-up
    torch.cuda.synchronize()
    _build.reset_launches()
    t0 = time.time()
    rows = profiling.profile_call(forward, top=None, warmup=False)
    traced_s = time.time() - t0
    launches = dict(_build.launches)
    want = routed_wan_launches(seen[-1][None], "sta_pipe", 1)
    if launches != want:
        raise RuntimeError(f"profiling: launches {launches} != {want}")
    events = profiling.kernel_counts(rows)
    counters = sorted(set(profiling.SYMBOL_COUNTERS.values()))
    off = {c: (events.get(c, 0), launches[c]) for c in counters
           if events.get(c, 0) != launches[c]}
    if off or not rows:
        raise RuntimeError(f"profiling: device events by counter differ from the launch "
                           f"counters (events, launches): {off}")
    # one counter standing for more than one CUDA launch: sta_batched's Hopper path
    # launches its live-slot pass (sta_batched_live_kernel) before each kernel; this
    # path runs no sta_batched
    device_ms = sum(ms for _, ms, _ in rows)
    top = [{"op": name[:160], "ms": ms, "count": n} for name, ms, n in rows[:25]]
    launched = {c: events[c] for c in counters if events.get(c)}
    log(f"profiling: one routed Wan-1.3B 480p x 77f forward on {card}: {len(rows)} device op "
        f"names, {sum(n for *_, n in rows)} device events, {device_ms:.1f} ms of device time; "
        f"the port's kernels' events equal their launch counters ({launched}); "
        f"sta_batched's counter would stand for two launches (its live-slot pass), off this path")
    for row in top:
        log(f"  top op {row['ms']:9.3f} ms {row['count']:5d}x {row['op']}")
    del model
    return {"profiling_480p_77f": launches}, {"device_ms": device_ms, "traced_s": traced_s,
                                              "top": top}



# ---- the f32 serving path: the eight kernels' f32 modes ---------------------------

# f32 gates, each kernel against its plain version on the same f32 inputs,
# TF32 off on both sides: worst |err| / max(|plain|, RMS(plain)) at most
# TOL_F32_ATTN for the attention kernels (FFMA sums against cuBLAS's, in
# another order) and TOL_F32_ROW for the norm and the prologue (row sums in
# another order); pool and unpool bit for bit where the picks agree.
TOL_F32_ATTN = 1e-4
TOL_F32_ROW = 1e-5
F32_REPLACES = {"flash": "vorta_tpu/ops/flash.py:348", "flash_manual":
                "vorta_tpu/ops/flash_manual.py:346", "sta_pipe": "vorta_tpu/ops/sta_pipe.py:597",
                "sta_batched": "vorta_tpu/ops/sta_batched.py:284",
                "fused_norm": "vorta_tpu/ops/fused_norm.py:108",
                "prologue": "vorta_tpu/ops/prologue.py:163",
                "pool_qkv": "vorta_tpu/ops/coreset_pallas.py:418",
                "unpool": "vorta_tpu/ops/coreset_pallas.py:545"}


def check_full_f32(torch) -> None:
    """The f32 phases run with TF32 off: f32 products are f32."""
    if not (torch.backends.cuda.matmul.allow_tf32 is False
            and torch.get_float32_matmul_precision() == "highest"
            and torch.backends.cudnn.allow_tf32 is False):
        raise RuntimeError("f32 phases need TF32 off (cuBLAS and cuDNN) and the 'highest' f32 "
                           "matmul precision")


def tf32_rne(torch, x):
    """x rounded once to TF32 (10 mantissa bits, to nearest even) in integer
    ops: what a single TF32 product reads of an f32 operand."""
    b = x.contiguous().view(torch.int32)
    return ((b + 0xFFF + ((b >> 13) & 1)) & ~0x1FFF).view(torch.float32)


def f32_case(torch, name: str, counter: str, kern, plain, tol: float, flops: float,
             nbytes: float, *, lib=None, iters: int = 5, rows=None, bracket=None,
             bracket_min=None, also=(), zero_heads=None, bound=None, ffma=None,
             tf32_bracket=None, tf32_gate: bool = False, tc_counter=None,
             tc_bound=None) -> dict:
    """One f32 call of a kernel: launched once, on its ``<counter>_f32``
    mode (and once on each counter of ``also``), never on its Hopper path;
    held against its plain version (on ``rows`` of the sequence axis where
    given: the rows its caller reads); the heads of ``zero_heads`` (a bool
    (H,) mask) all zeros; ``bracket`` (a plain call the gate must reject: a
    missing mask), its worst ratio above ``tol`` or at least
    ``bracket_min``; timed beside the plain version and ``lib`` (a callable:
    one PyTorch call of the same function, or None).  ``bound``: (ms, by)
    where the work is not all f32 (the int8 modes' QK).  ``ffma``: the same
    call on the FFMA core where the rule sends ``kern`` to the tensor-core
    core (flash / flash_manual, ops/flash.py:f32_tc_path; sta_pipe /
    sta_window, ops/sta_pipe.py:sta_f32_tc_path): ``kern`` is then
    launched on ``<counter>_f32_tc`` (else never), the FFMA call is held to
    the same gate and timed in turns with ``kern``, and the row's bound is
    the 3xTF32 one (3 x FLOP at 495 TFLOP/s TF32), the FFMA's 67 TFLOP/s
    beside it, neither read above 100%.  ``tc_counter`` / ``tc_bound``: the
    tensor-core counter (``<counter>_f32_tc`` by default; the int8 mode's
    ``flash_manual_int8_tc``) and its (ms, by) where the 3xTF32 one does not
    fit (the int8 mode: QK at 1,979 TOPS, PV 3xTF32).  ``tf32_bracket``: the
    plain version with a single TF32 product (f32 q / k / v: q, k, v rounded
    once to TF32; the int8 mode: P and V), recorded, and at least
    F32_BRACKET x ``tol`` where ``tf32_gate``."""
    from vorta_tpu_torch.ops import _build

    _build.reset_launches()
    got = kern()
    torch.cuda.synchronize()
    counts = tuple(_build.launches[c] for c in (counter, f"{counter}_f32", *also))
    tc_counter = tc_counter or f"{counter}_f32_tc"
    tc = _build.launches.get(tc_counter, 0)
    if counts != (1,) * len(counts) or _build.launches.get(f"{counter}_wgmma", 0) \
            or tc != int(ffma is not None):
        raise RuntimeError(f"{name}: launches ({counter}, {counter}_f32, {also}) {counts}, "
                           f"on the Hopper path {_build.launches.get(f'{counter}_wgmma', 0)}, "
                           f"on the tensor-core core {tc} (want {int(ffma is not None)})")
    if zero_heads is not None and got[:, zero_heads].any():
        raise RuntimeError(f"{name}: a head routed away wrote non-zeros")
    want, plain_ms = timed_once(torch, plain)
    if rows is not None:
        got, want = got[:, :, rows], want[:, :, rows]
    if got.dtype != torch.float32 or not torch.isfinite(got).all():
        raise RuntimeError(f"{name}: output {got.dtype}, finite {bool(torch.isfinite(got).all())}")
    err = (got - want).abs().max().item()
    ratio = worst_ratio(torch, got, want)
    log(f"{name}: max_abs_err {err:.3e}, worst |err| / max(|plain|, RMS) {ratio:.3e} "
        f"(tolerance {tol:g})")
    if not ratio <= tol:
        raise RuntimeError(f"{name}: the f32 kernel disagrees with its plain version")
    r = dict(max_abs_err=err, worst_ratio=ratio)
    if ffma is not None:
        _build.reset_launches()
        alt = ffma()
        n = (_build.launches[f"{counter}_f32"], _build.launches[tc_counter])
        r["ffma_worst_ratio"] = worst_ratio(torch, alt if rows is None else alt[:, :, rows], want)
        log(f"{name}: the FFMA core at the same call, worst ratio {r['ffma_worst_ratio']:.3e}")
        if n != (1, 0) or not r["ffma_worst_ratio"] <= tol:
            raise RuntimeError(f"{name}: the FFMA core (launches {n}) disagrees")
        del alt
    if tf32_bracket is not None:
        miss = tf32_bracket()
        r["tf32_bracket_worst_ratio"] = worst_ratio(
            torch, miss if rows is None else miss[:, :, rows], want)
        log(f"{name}: one TF32 product, worst ratio {r['tf32_bracket_worst_ratio']:.3e} "
            f"({'must be' if tf32_gate else 'recorded; the bar is'} >= "
            f"{F32_BRACKET * tol:g})")
        if tf32_gate and not r["tf32_bracket_worst_ratio"] >= F32_BRACKET * tol:
            raise RuntimeError(f"{name}: the gate cannot tell a single TF32 product")
        del miss
    if bracket is not None:
        miss = bracket()
        r["bracket_worst_ratio"] = worst_ratio(torch, miss if rows is None else miss[:, :, rows],
                                               want)
        log(f"{name}: bracket worst ratio {r['bracket_worst_ratio']:.3e} (must be "
            f"{'above ' + format(tol, 'g') if bracket_min is None else f'>= {bracket_min:g}'})")
        if not (r["bracket_worst_ratio"] > tol if bracket_min is None
                else r["bracket_worst_ratio"] >= bracket_min):
            raise RuntimeError(f"{name}: the gate cannot tell the bracket")
        del miss
    del got, want
    b_ms, b_by = bound if bound is not None else bound_ms(flops, nbytes, PEAK_F32)
    if ffma is not None:  # the tensor-core core timed in turns with the FFMA core
        ms, f_ms = [], []
        for _ in range(2):
            ms.append(time_ms(torch, kern, iters))
            f_ms.append(time_ms(torch, ffma, iters))
        r.update(core="tensor_cores", ffma_ms=sum(f_ms) / 2, ffma_bound_ms=b_ms,
                 ffma_bound_share=b_ms / (sum(f_ms) / 2), tc_over_ffma=sum(ms) / sum(f_ms),
                 ffma_rated_bound_share=b_ms / (sum(ms) / 2))
        b_ms, b_by = tc_bound or bound_ms(3 * flops, nbytes, PEAK_TF32)
        r["ms"] = sum(ms) / 2
    else:
        r["ms"] = time_ms(torch, kern, iters)
        if counter in ("flash", "flash_manual", "sta_pipe", "sta_window"):
            r["core"] = "ffma"
    r.update(plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
             library_ms=lib() if lib is not None else None)
    if ffma is not None and not (r["bound_ms"] <= r["ms"] and r["ffma_bound_ms"] <= r["ffma_ms"]):
        raise RuntimeError(f"{name}: a time below its bound: {r}")
    if flops:
        with_rate(r, flops)
    else:
        r.update(gbps=nbytes / r["ms"] / 1e6, bound_share=b_ms / r["ms"])
        if r["library_ms"]:
            r["vs_library"] = r["ms"] / r["library_ms"]
    log(f"{name}: {r}")
    return r


def check_f32_kernels(torch, card: str) -> dict:
    """The eight kernels of the f32 serving path in their f32 modes on the
    card, each against its f32 plain version (gates above), with ms,
    TFLOP/s or GB/s, the share of the bound (67 TFLOP/s f32, 3.35 TB/s) and
    the library call (SDPA in f32 with TF32 off beside the attention rows):
    {kernel: {shape: numbers}}.  Covers the flash kv tail, kv_bias with
    kv_valid_len, pair bits, count-0 rows, inactive heads, the head-map
    mode with K matching, the stable and the fast softmax, the text tail,
    D 64 and 128, blocks of 8 and 16 rows."""
    import dataclasses

    import numpy as np
    import torch.nn.functional as F

    from vorta_tpu_torch.cli.sample import attention_config
    from vorta_tpu_torch.ops import joint_experts as joint
    from vorta_tpu_torch.ops.coreset_pallas import head_map_for, pick_gaps, pool_qkv, pool_qkv_ref
    from vorta_tpu_torch.ops.experts import lowres_groups_for
    from vorta_tpu_torch.ops.flash import (
        dense_tables,
        sparse_flash_attention_ffma,
        sparse_flash_attention_raw,
        sparse_flash_attention_ref,
        tables_from_block_mask,
    )
    from vorta_tpu_torch.ops.flash_manual import (
        sparse_flash_attention_manual,
        sparse_flash_attention_manual_ffma,
        sparse_flash_attention_manual_ref,
    )
    from vorta_tpu_torch.ops.fused_norm import _norm_ref, fused_norm
    from vorta_tpu_torch.ops.prologue import _prologue_ref, fused_qk_prologue, prologue_layout
    from vorta_tpu_torch.ops.rope import rope_cos_sin
    from vorta_tpu_torch.ops.routed_fused import routed_geometry
    from vorta_tpu_torch.ops.sta_batched import sta_flash_headbatched, sta_flash_headbatched_ref
    from vorta_tpu_torch.ops.sta_pipe import (
        sta_pipe_attention,
        sta_pipe_attention_ffma,
        sta_pipe_attention_ref,
    )

    check_full_f32(torch)
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(19)
    out = {k: {} for k in F32_REPLACES}

    def randn(*shape, scale=1.0):  # unit RMS: the scale of qk-normed q / k
        return torch.randn(shape, generator=g, device=dev) * scale

    def sdpa(q, k, v, iters=3, mask=None):
        return lambda: time_ms(torch, lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=mask), iters, 1)

    h, d = 12, 128
    act = torch.tensor(ACTIVE_HEADS, device=dev)
    n_act = int(act.sum().item())

    def tf32(*xs):
        return [tf32_rne(torch, x) for x in xs]

    # ---- flash: self-attention at 480p x 21f (the f32 off path's), padded to
    # 10 x 1024 with the 9,360 tail (its bracket: the plain version without the
    # tail mask); cross-attention to 512 text keys; per-head tables with count-0
    # q blocks and a tail at D 64, blocks of 16 (wan-tiny's).  The D = 128 calls
    # run on the tensor-core core, timed in turns with the FFMA core
    s = GRID_480P[0] * GRID_480P[1] * GRID_480P[2]
    sp = 10240
    q, k, v = (randn(1, h, sp, d) for _ in range(3))
    ki, kc = dense_tables(sp // 1024, sp // 1024).on(dev)
    kw = dict(scale=d**-0.5, block_q=1024, block_kv=1024, kv_valid_len=s)
    flops = 4.0 * s * s * d * h
    out["flash"]["self_attention_9360"] = f32_case(
        torch, "flash f32 self-attention (1,12,10240,128), valid 9360", "flash",
        lambda: sparse_flash_attention_raw(q, k, v, ki, kc, **kw),
        lambda: sparse_flash_attention_ref(q, k, v, ki, kc, **kw), TOL_F32_ATTN, flops,
        4 * h * s * d * 4, rows=slice(0, s), iters=3,
        lib=sdpa(*(x[:, :, :s] for x in (q, k, v))),
        bracket=lambda: sparse_flash_attention_ref(q, k, v, ki, kc,
                                                   **{**kw, "kv_valid_len": None}),
        ffma=lambda: sparse_flash_attention_ffma(q, k, v, ki, kc, **kw),
        tf32_bracket=lambda: sparse_flash_attention_ref(*tf32(q, k, v), ki, kc, **kw))
    kt, vt = randn(1, h, TEXT_LEN, d), randn(1, h, TEXT_LEN, d)
    ti, tc = dense_tables(sp // 2048, 1).on(dev)
    kwc = dict(scale=d**-0.5, block_q=2048, block_kv=512)
    out["flash"]["cross_attention_9360x512"] = f32_case(
        torch, "flash f32 cross-attention (1,12,10240,128) x 512", "flash",
        lambda: sparse_flash_attention_raw(q, kt, vt, ti, tc, **kwc),
        lambda: sparse_flash_attention_ref(q, kt, vt, ti, tc, **kwc), TOL_F32_ATTN,
        4.0 * s * TEXT_LEN * d * h, (2 * h * s * d + 2 * h * TEXT_LEN * d) * 4,
        rows=slice(0, s), lib=sdpa(q[:, :, :s], kt, vt, 10), iters=10,
        ffma=lambda: sparse_flash_attention_ffma(q, kt, vt, ti, tc, **kwc),
        tf32_bracket=lambda: sparse_flash_attention_ref(*tf32(q, kt, vt), ti, tc, **kwc))
    del q, k, v, kt, vt
    rng = np.random.default_rng(19)
    mask = rng.random((2, 6, 6)) < 0.5
    mask[:, 0, :] = False  # count-0 q blocks: zero rows
    mask[:, 1, 5] = True  # the tail block
    pi, pc = tables_from_block_mask(mask).on(dev)
    q, k, v = (randn(2, 2, 96, 64) for _ in range(3))
    kws = dict(scale=64**-0.5, block_q=16, block_kv=16, kv_valid_len=90)
    # the library call: f32 SDPA with the per-head block mask and the tail as a float mask
    vis = torch.from_numpy(mask).to(dev).repeat_interleave(16, 1).repeat_interleave(16, 2)
    vis[..., 90:] = False
    out["flash"]["per_head_tables_d64_blocks16"] = f32_case(
        torch, "flash f32 per-head tables (2,2,96,64), blocks 16, valid 90", "flash",
        lambda: sparse_flash_attention_raw(q, k, v, pi, pc, **kws),
        lambda: sparse_flash_attention_ref(q, k, v, pi, pc, **kws), TOL_F32_ATTN,
        4.0 * 96 * 96 * 64 * 4, 4 * 4 * 96 * 64 * 4, iters=10,
        lib=sdpa(q, k, v, 10, float_mask(torch, vis)[None]),
        bracket=lambda: sparse_flash_attention_ref(q, k, v, pi, pc,
                                                   **{**kws, "kv_valid_len": None}))

    # ---- flash_manual: the routed FULL call at 480p x 77f (fast, per-head counts:
    # heads routed away are count-0 rows), LOWRES; kv_bias with kv_valid_len
    # (the joint experts' text padding) in the stable and the fast softmax;
    # D 64 with 16-row blocks
    cfg = attention_config("wan-1_3B", GRID_480P_77F)
    geo = routed_geometry(cfg)
    for name, call in (("full_31200", geo.full), ("lowres_15600", geo.lowres)):
        q, k, v = (randn(1, h, call.q_pad, d) for _ in range(3))
        fi, fc = call.tables.on(dev)
        cnt = torch.where(act[:, None] > 0, fc, 0).to(torch.int32)
        kw = dict(scale=d**-0.5, block_q=call.block_q, block_kv=call.block_kv,
                  kv_valid_len=call.valid_len, softmax="fast")
        n = call.valid_len
        out["flash_manual"][name] = r = f32_case(
            torch, f"flash_manual f32 {name} (1,12,{call.q_pad},128), {n_act} of 12 heads",
            "flash_manual", lambda: sparse_flash_attention_manual(q, k, v, fi, cnt, **kw),
            lambda: sparse_flash_attention_manual_ref(q, k, v, fi, cnt, **kw), TOL_F32_ATTN,
            4.0 * n * n * d * n_act, 4 * n * d * 4 * n_act, rows=slice(0, n), iters=2,
            lib=sdpa(*(x[:, act > 0, :n] for x in (q, k, v)), 2),
            bracket=lambda: sparse_flash_attention_manual_ref(q, k, v, fi, cnt,
                                                              **{**kw, "kv_valid_len": None}),
            ffma=lambda: sparse_flash_attention_manual_ffma(q, k, v, fi, cnt, **kw),
            tf32_bracket=lambda: sparse_flash_attention_manual_ref(*tf32(q, k, v), fi, cnt,
                                                                   **kw), tf32_gate=True)
        got = sparse_flash_attention_manual(q, k, v, fi, cnt, **kw)
        if got[:, act == 0].any():
            raise RuntimeError(f"flash_manual f32 {name}: a count-0 head wrote non-zeros")
        del q, k, v, got
    q, k, v = (randn(1, 4, 2048, d) for _ in range(3))
    bias = torch.zeros((1, 2048), device=dev)
    bias[:, 1800:] = -1e30  # padded text keys
    bi, bc = dense_tables(8, 8).on(dev)
    for softmax in ("stable", "fast"):
        kw = dict(scale=d**-0.5, block_q=256, block_kv=256, kv_valid_len=1900, kv_bias=bias,
                  softmax=softmax)
        out["flash_manual"][f"kv_bias_tail_{softmax}"] = f32_case(
            torch, f"flash_manual f32 kv_bias + kv_valid_len 1900 (1,4,2048,128) {softmax}",
            "flash_manual", lambda: sparse_flash_attention_manual(q, k, v, bi, bc, **kw),
            lambda: sparse_flash_attention_manual_ref(q, k, v, bi, bc, **kw), TOL_F32_ATTN,
            4.0 * 2048 * 1800 * d * 4, 4 * 4 * 2048 * d * 4, iters=5,
            bracket=lambda: sparse_flash_attention_manual_ref(q, k, v, bi, bc,
                                                              **{**kw, "kv_bias": None}),
            lib=sdpa(q, k, v, 5, bias.reshape(1, 1, 1, -1)),
            ffma=lambda: sparse_flash_attention_manual_ffma(q, k, v, bi, bc, **kw),
            tf32_bracket=lambda: sparse_flash_attention_manual_ref(*tf32(q, k, v), bi, bc,
                                                                   **kw))
    q, k, v = (randn(1, 2, 64, 64) for _ in range(3))
    di, dc = dense_tables(4, 4).on(dev)
    kw = dict(scale=64**-0.5, block_q=16, block_kv=16, kv_valid_len=60, softmax="fast")
    out["flash_manual"]["d64_blocks16"] = f32_case(
        torch, "flash_manual f32 (1,2,64,64), blocks 16, valid 60", "flash_manual",
        lambda: sparse_flash_attention_manual(q, k, v, di, dc, **kw),
        lambda: sparse_flash_attention_manual_ref(q, k, v, di, dc, **kw), TOL_F32_ATTN,
        4.0 * 64 * 60 * 64 * 2, 4 * 2 * 64 * 64 * 4, iters=10,
        lib=sdpa(q, k[:, :, :60], v[:, :, :60], 10))
    del q, k, v

    # ---- sta_pipe: the routed STA call at 480p x 77f (tile (4, 6, 4), fast, 8 of
    # 12 heads active); the text tail (256 keys, 83 valid) in the stable and the
    # fast softmax at the (6, 9, 8) tile; D 64 at wan-tiny's tile (2, 2, 2).  The
    # D = 128 calls run on the tensor-core walk, timed in turns with the FFMA core
    # (the TF32 bracket gated at 480p)
    n = GRID_480P_77F[0] * GRID_480P_77F[1] * GRID_480P_77F[2]
    q, k, v = (randn(1, h, n, d) for _ in range(3))
    kw = dict(latent_shape=GRID_480P_77F, tile=(4, 6, 4), window=(3, 3, 3), scale=d**-0.5)
    keys = 12 * 18 * 12
    smask = sta_raster_mask(torch, GRID_480P_77F, (4, 6, 4), dev)
    out["sta_pipe"]["480p_77f"] = f32_case(
        torch, f"sta_pipe f32 (1,12,{n},128), tile (4,6,4), {n_act} of 12 heads", "sta_pipe",
        lambda: sta_pipe_attention(q, k, v, act, **kw),
        lambda: sta_pipe_attention_ref(q, k, v, act, **kw), TOL_F32_ATTN,
        4.0 * n * keys * d * n_act, 4 * n * d * 4 * n_act, iters=5,
        lib=lambda: masked_sdpa_ms(torch, "sta_pipe f32", *(x[:, act > 0] for x in (q, k, v)),
                                   smask)[0],
        ffma=lambda: sta_pipe_attention_ffma(q, k, v, act, **kw),
        tf32_bracket=lambda: sta_pipe_attention_ref(*tf32(q, k, v), act, **kw), tf32_gate=True)
    del q, k, v, smask
    torch.cuda.empty_cache()
    grid, tile = (6, 9, 16), (6, 9, 8)
    n = grid[0] * grid[1] * grid[2]
    q, k, v = (randn(1, 4, n, d) for _ in range(3))
    tk, tv = randn(1, 4, HY_TEXT, d), randn(1, 4, HY_TEXT, d)
    tb = torch.where(hy_text_mask(torch, dev)[0], 0.0, -1e30).reshape(1, HY_TEXT)
    a4 = torch.tensor([1, 0, 1, 1], device=dev)

    def tail_lib():
        """Masked f32 SDPA over the active heads, the window and the text
        keys' bias as one float mask (either softmax: the same function)."""
        sel = a4 > 0
        mask = torch.cat([float_mask(torch, sta_raster_mask(torch, grid, tile, dev)),
                          tb.reshape(1, -1).expand(n, -1)], dim=1)
        return masked_sdpa_ms(torch, "sta_pipe f32 text tail", q[:, sel],
                              torch.cat([k[:, sel], tk[:, sel]], dim=2),
                              torch.cat([v[:, sel], tv[:, sel]], dim=2), mask)[0]

    for softmax in ("stable", "fast"):
        kw = dict(latent_shape=grid, tile=tile, window=(3, 3, 3), scale=d**-0.5, text_k=tk,
                  text_v=tv, text_bias=tb, softmax=softmax)
        out["sta_pipe"][f"text_tail_{softmax}"] = f32_case(
            torch, f"sta_pipe f32 (1,4,{n},128) + 256 text keys (83 valid), tile {tile}, "
            f"{softmax}", "sta_pipe", lambda: sta_pipe_attention(q, k, v, a4, **kw),
            lambda: sta_pipe_attention_ref(q, k, v, a4, **kw), TOL_F32_ATTN,
            4.0 * n * (n + HY_VALID) * d * 3, 4 * n * d * 4 * 3, iters=5,
            bracket=lambda: sta_pipe_attention_ref(q, k, v, a4, **{**kw, "text_bias": None}),
            lib=tail_lib, ffma=lambda: sta_pipe_attention_ffma(q, k, v, a4, **kw),
            tf32_bracket=lambda: sta_pipe_attention_ref(*tf32(q, k, v), a4,
                                                        **{**kw, "text_k": tf32(tk)[0],
                                                           "text_v": tf32(tv)[0]}))
    q, k, v = (randn(1, 2, 4 * 4 * 4, 64) for _ in range(3))
    kw = dict(latent_shape=(4, 4, 4), tile=(2, 2, 2), window=(3, 3, 1), scale=64**-0.5)
    out["sta_pipe"]["d64_tile222"] = f32_case(
        torch, "sta_pipe f32 (1,2,64,64), tile (2,2,2), window (3,3,1)", "sta_pipe",
        lambda: sta_pipe_attention(q, k, v, torch.ones(2, device=dev), **kw),
        lambda: sta_pipe_attention_ref(q, k, v, torch.ones(2, device=dev), **kw),
        TOL_F32_ATTN, 4.0 * 64 * 32 * 64 * 2, 4 * 2 * 64 * 64 * 4, iters=10,
        lib=sdpa(q, k, v, 10, float_mask(torch, sta_raster_mask(torch, (4, 4, 4), (2, 2, 2), dev,
                                                                 (3, 3, 1)))))
    del q, k, v, tk, tv

    # ---- sta_batched: hunyuan-tiny's joint layout (tile (2, 2, 2): 8-row
    # blocks, pair bits, the text bias) in the fast and the stable softmax, and
    # HunyuanVideo 45f (2, 9, 8)'s joint layout (1,24,48384,128) fast, timed
    for name, hcfg, heads, dh, lt, valid in (
            ("hunyuan_tiny_joint", attention_config("hunyuan-tiny", (4, 6, 16)), 2, 64, 24,
             17),
            ("hunyuan_45f_298_joint", dataclasses.replace(
                attention_config("hunyuan-13B", GRID_HY_45F), sta_tile=HY_TILE_298), 24, 128,
             HY_TEXT, HY_VALID)):
        jcfg = joint.JointConfig(hcfg, lt)
        lay = joint.joint_layouts(jcfg)["sta"]
        ji, jc, bits = joint._joint_sta_tables(jcfg).on(dev)
        tmask = torch.zeros((1, lt), dtype=torch.bool, device=dev)
        tmask[:, :valid] = True
        bias = joint._bias(tmask, lay, hcfg.seq_len)
        tpt = hcfg.tokens_per_tile
        ja = torch.tensor([int(i % 3 != 0) for i in range(heads)], device=dev)
        q, k, v = (randn(1, heads, lay.total, dh) for _ in range(3))
        vis = torch.from_numpy(joint._joint_sta_subtile_mask(jcfg)[0]).to(dev)
        live = (bias.reshape(-1, tpt) > -1e29).sum(dim=1)
        pairs = int((vis.long() * live[None]).sum().item()) * tpt
        n_on = int(ja.sum().item())
        rows = torch.cat([torch.arange(hcfg.seq_len, device=dev),
                          lay.text_off + torch.arange(valid, device=dev)])  # what callers read

        def lib_pairs():
            """f32 SDPA with TF32 off on the active heads, the visible pairs
            and the text bias as one (S, S) float mask (9.4 GB at 48,384)."""
            full = vis.repeat_interleave(tpt, 0).repeat_interleave(tpt, 1)
            fmask = torch.where(full, bias.reshape(1, -1), float("-inf"))
            del full
            ms = sdpa(*(x[:, ja > 0] for x in (q, k, v)), mask=fmask[None, None], iters=2)()
            del fmask
            torch.cuda.empty_cache()
            return ms

        for softmax in (("fast", "stable") if name == "hunyuan_tiny_joint" else ("fast",)):
            kw = dict(pair_bits=bits, tokens_per_tile=tpt, kv_bias=bias, scale=dh**-0.5,
                      block_q=lay.block_q, block_kv=lay.block_kv, softmax=softmax)
            out["sta_batched"][f"{name}_{softmax}"] = f32_case(
                torch, f"sta_batched f32 {name} (1,{heads},{lay.total},{dh}), blocks "
                f"{lay.block_q}/{lay.block_kv}, pair bits, kv_bias, {softmax}", "sta_batched",
                lambda: sta_flash_headbatched(q, k, v, ji, jc, ja, **kw),
                lambda: sta_flash_headbatched_ref(q, k, v, ji, jc, ja, **kw), TOL_F32_ATTN,
                4.0 * pairs * dh * n_on, 4 * lay.total * dh * 4 * n_on, rows=rows, iters=3,
                lib=lib_pairs,
                bracket=lambda: sta_flash_headbatched_ref(q, k, v, ji, jc, ja,
                                                          **{**kw, "pair_bits": None}))
        del q, k, v
        torch.cuda.empty_cache()

    # ---- the AdaLN norm: 480p x 77f (1,31200,1536) and Wan-14B's (1,8192,5120)
    # on the warp-per-row kernel, the tiny models' dim 128 on the block kernel;
    # the library: F.layer_norm(x, (dim,), 1 + scale, shift) at B = 1
    for name, rows_, dim in (("wan_480p_77f_31200", 31200, 1536), ("wan14b_8192", 8192, 5120),
                             ("tiny_dim128", 416, 128)):
        x = randn(1, rows_, dim, scale=3.0)
        mod = randn(1, 6, dim, scale=0.3)
        sc, sh = mod[:, 1], mod[:, 0]
        out["fused_norm"][name] = f32_case(
            torch, f"AdaLN norm f32 (1,{rows_},{dim})", "fused_norm",
            lambda: fused_norm(x, sc, sh, None, None, False, 1e-6, False),
            lambda: _norm_ref(x, sc, sh, None, None, rms=False, eps=1e-6, out_f32=False),
            TOL_F32_ROW, 0.0, 2 * x.numel() * 4 + 2 * dim * 4, iters=20,
            lib=lambda: time_ms(torch, lambda: F.layer_norm(x, (dim,), 1.0 + sc[0], sh[0],
                                                            eps=1e-6), 20))
        del x, mod

    # ---- the qk prologue from the fused qkv product's column slices: 480p x 77f
    # (1,31200,1536) row scope and HunyuanVideo's width (3,072, 24 heads) head
    # scope on the warp-per-row kernel, Wan-14B's (5,120, 40 heads: 8 warps a
    # row in f32), the tiny models' (128, 2 heads of 64) on the block kernel
    for name, grid, width, heads, scope in (
            ("wan_480p_77f_31200", GRID_480P_77F, 1536, 12, "row"),
            ("hunyuan_width_head_scope", (2, 12, 16), 3072, 24, "head"),
            ("wan14b_width", (2, 12, 16), 5120, 40, "row"),
            ("tiny_128", (4, 6, 16), 128, 2, "head")):
        rows_ = grid[0] * grid[1] * grid[2]
        hd = width // heads
        qkv = randn(1, rows_, 3 * width, scale=3.0)
        qq, kk, vv = qkv.split(width, dim=-1)
        gq, gk = (1.0 + 0.1 * torch.randn(width, generator=g, device=dev) for _ in range(2))
        cos, sin = (torch.from_numpy(a).to(dev) for a in rope_cos_sin(grid, hd))
        pkw = dict(num_heads=heads, eps=1e-6, qk_norm=True, norm_scope=scope)
        layout = prologue_layout(width, heads, 4)
        out["prologue"][name] = f32_case(
            torch, f"qk prologue f32 (1,{rows_},{width}), {heads} heads, {scope} scope, "
            f"layout {layout}", "prologue",
            lambda: torch.cat(fused_qk_prologue(qq, kk, vv, gq, gk, cos, sin, **pkw)),
            lambda: torch.cat(_prologue_ref(qq, kk, vv, gq, gk, cos, sin, **pkw)),
            TOL_F32_ROW, 0.0, 6 * rows_ * width * 4 + 2 * rows_ * hd // 2 * 4, iters=10)
        out["prologue"][name]["layout"] = layout
        del qkv

    # ---- pool_qkv / unpool: 480p x 77f active mode (8 of 12 heads), then the
    # head-map mode with K's own matching (HunyuanVideo's LOWRES) at (1,8,6912,128)
    groups = lowres_groups_for(cfg)
    q, k, v = (randn(1, h, cfg.seq_len, d) for _ in range(3))

    def pool_case(name, groups_, q, k, v, heads, kv_from_k, **kwp):
        pool = lambda: pool_qkv(q, k, v, groups_, kv_matching_from_k=kv_from_k,  # noqa: E731
                                return_picks=True, **kwp)
        plain = lambda: pool_qkv_ref(q, k, v, groups_, kv_matching_from_k=kv_from_k,  # noqa: E731
                                     **kwp)
        from vorta_tpu_torch.ops import _build

        _build.reset_launches()
        got = pool()
        torch.cuda.synchronize()
        if _build.launches["pool_qkv_f32"] != 1:
            raise RuntimeError(f"pool_qkv f32 {name}: launches {_build.launches}")
        want, plain_ms = timed_once(torch, plain)
        hs = torch.tensor(heads, device=dev)
        n_h = len(heads)
        sh = (1, n_h, groups_.num_groups, groups_.num_kept_margins)
        gaps = pick_gaps(got[3][:, hs], want[3][:, hs], q[:, hs], groups_)
        if gaps.numel() and not gaps.max().item() < PICK_EPS:
            raise RuntimeError(f"pool_qkv f32 {name}: a pick disagrees away from a near-tie")
        q_agree = (got[3][:, hs].reshape(sh) == want[3][:, hs].reshape(sh)).all(-1)
        gsz = groups_.num_groups
        for x, a, w in zip("qkv", got[:3], want[:3]):
            a, w = a[:, hs], w[:, hs]
            agree = q_agree
            if kv_from_k and x != "q":  # K's own matching: where its picks agree
                ka = pool_qkv(k, k, k, groups_, return_picks=True)[3][:, hs]
                kw_ = pool_qkv_ref(k, k, k, groups_)[3][:, hs]
                agree = (ka.reshape(sh) == kw_.reshape(sh)).all(-1)
            if not (torch.equal(a[:, :, :gsz], w[:, :, :gsz]) and torch.equal(
                    a[:, :, gsz:].reshape(*sh, d)[agree], w[:, :, gsz:].reshape(*sh, d)[agree])):
                raise RuntimeError(f"pool_qkv f32 {name} {x}: pooled rows differ where the "
                                   "picks agree (they are copies)")
        p = groups_.pooled_length
        s_ = q.shape[2]
        nbytes = n_h * ((1 + kv_from_k) * s_ + (2 - kv_from_k) * p + 3 * p) * d * 4 \
            + int(np.prod(sh)) * 4
        b_ms, b_by = bound_ms(0.0, nbytes, PEAK_F32)
        r = dict(ms=device_ms(torch, pool, 10), plain_ms=plain_ms, library_ms=None,
                 bound_ms=b_ms, bound_by=b_by, max_abs_err=0.0, worst_ratio=0.0,
                 pick_disagreements=gaps.numel(), picks=int(np.prod(sh)), heads=n_h)
        r.update(gbps=nbytes / r["ms"] / 1e6, bound_share=b_ms / r["ms"])
        log(f"pool_qkv f32 {name}: {gaps.numel()} of {int(np.prod(sh))} picks disagree "
            f"(near-ties); rows bit for bit where the picks agree; {r}")
        picks = got[3]
        del got, want
        return r, picks

    active_heads = [i for i in range(h) if ACTIVE_HEADS[i]]
    out["pool_qkv"]["active_480p_77f"], picks = pool_case(
        "active_480p_77f", groups, q, k, v, active_heads, False, active=act)
    out_p = randn(1, h, groups.pooled_length, d)
    u_bytes = n_act * (groups.pooled_length * d * 4 + groups.num_groups
                       * groups.num_kept_margins * 4) + h * cfg.seq_len * d * 4
    out["unpool"]["active_480p_77f"] = unpool_f32_case(
        torch, "active_480p_77f", out_p, q, groups, picks, active_heads, u_bytes, active=act)
    del q, k, v, out_p
    hyg = lowres_groups_for(attention_config("hunyuan-13B", (6, 18, 64)))
    q, k, v = (randn(1, 8, hyg.full_length, d) for _ in range(3))
    routed = torch.tensor([1, 0, 1, 1, 0, 1, 1, 0], device=dev)
    hm, n_hm = head_map_for(routed)
    on = torch.nonzero(routed).flatten().tolist()
    out["pool_qkv"]["headmap_k_matching"], picks = pool_case(
        "head-map, K's matching (1,8,6912,128)", hyg, q, k, v, on, True, head_map=hm,
        num_active=n_hm)
    out_p = randn(1, 8, hyg.pooled_length, d)
    u_bytes = n_hm * (hyg.pooled_length * d * 4 + hyg.full_length * d * 4)
    out["unpool"]["headmap"] = unpool_f32_case(
        torch, "head-map (1,8,6912,128)", out_p, q, hyg, picks, on, u_bytes, head_map=hm,
        num_active=n_hm)
    del q, k, v, out_p
    torch.cuda.empty_cache()
    return out


def unpool_f32_case(torch, name: str, out_p, q, groups, picks, heads, u_bytes, **kw) -> dict:
    """unpool's f32 mode bit for bit against its plain version and the first
    design's kernel on the written heads (the active mode's zeros too),
    counted once on ``unpool_f32``, timed beside torch.gather of the same
    rows."""
    from vorta_tpu_torch.ops import _build
    from vorta_tpu_torch.ops.coreset_pallas import unpool, unpool_per_group, unpool_ref

    unp = lambda: unpool(out_p, q, groups, picks=picks, **kw)  # noqa: E731
    plain = lambda: unpool_ref(out_p, q, groups, picks=picks, **kw)  # noqa: E731
    _build.reset_launches()
    got = unp()
    torch.cuda.synchronize()
    if _build.launches["unpool_f32"] != 1:
        raise RuntimeError(f"unpool f32 {name}: launches {_build.launches}")
    rows_kernel = _build.launches["unpool_rows"] == 1
    want, plain_ms = timed_once(torch, plain)
    hs = torch.tensor(heads, device=out_p.device)
    old = unpool_per_group(out_p, q, groups, picks=picks, **kw)
    if not (torch.equal(got[:, hs], want[:, hs]) and torch.equal(got[:, hs], old[:, hs])):
        raise RuntimeError(f"unpool f32 {name}: differs from the plain version or the first "
                           "design's kernel on the written heads (pure selection)")
    if "active" in kw and not torch.equal(got, want):
        raise RuntimeError(f"unpool f32 {name}: the inactive heads' zeros differ")
    b, _, p, d = out_p.shape
    rows = torch.arange(p, device=out_p.device, dtype=torch.float32).reshape(1, 1, p, 1)
    idx = unpool_ref(rows.expand(b, len(heads), p, 1).contiguous(), q[:, hs], groups,
                     picks=picks[:, hs]).long().expand(-1, -1, -1, d)
    src = out_p[:, hs].contiguous()
    lib = lambda: torch.gather(src, 2, idx)  # noqa: E731
    if not torch.equal(lib(), got[:, hs]):
        raise RuntimeError(f"unpool f32 {name}: the torch.gather yardstick computes another "
                           "function")
    del got, want, old
    b_ms, b_by = bound_ms(0.0, u_bytes, PEAK_F32)
    r = dict(ms=device_ms(torch, unp, 20), plain_ms=plain_ms, library_ms=device_ms(torch, lib, 20),
             bound_ms=b_ms, bound_by=b_by, max_abs_err=0.0, worst_ratio=0.0, heads=len(heads),
             rows_kernel=rows_kernel,
             library_covers="torch.gather(pooled, 2, idx) over the written heads")
    r.update(gbps=u_bytes / r["ms"] / 1e6, bound_share=b_ms / r["ms"],
             vs_library=r["ms"] / r["library_ms"])
    log(f"unpool f32 {name}: bit for bit (plain version, first design); {r}")
    return r



F32_KERNELS = ("flash", "flash_manual", "sta_pipe", "sta_batched", "fused_norm", "prologue",
               "pool_qkv", "unpool")


def f32_launches(want: dict, full_width: bool) -> dict:
    """A path's launches in f32 from its bf16 count ``want``: no Hopper
    path (the f32 modes are their own kernels), and every launch of the
    eight serving kernels and of the backward's dq and dk/dv on its f32
    mode.  ``full_width``: the 1.3B / 13B widths (head dim 128), where the
    prologue's warp-per-row kernel takes every prologue launch, the
    tensor-core core every flash launch, the STA tiles' too
    (ops/flash.py:flash_f32_tc_path: D 128, blocks multiples of 8), and
    every flash_manual launch that bf16 sends to the Hopper path
    (ops/flash.py:f32_tc_path is wgmma_path's shape rule; flash_manual's
    int8 QK mode there takes its own tensor-core kernel,
    ``flash_manual_int8_tc``, and on these paths its launches are all at
    the Hopper shapes), the backward's tensor-core dq and dk/dv every dq
    and dk/dv launch (ops/flash.py:flash_f32_tc_path, the rule of flash's
    forward and backward), and the window walks' tensor-core walk every
    sta_pipe launch outside the int8 QK mode and every sta_window launch
    (ops/sta_pipe.py:sta_f32_tc_path); the tiny models' head dim 64 takes
    none of them."""
    out = dict(want)
    out["flash_f32_tc"] = want["flash"] if full_width else 0
    # the backward's rule (ops/flash.py:flash_f32_tc_path) takes every D 128 call
    out["flash_dq_f32_tc"] = want["flash_dq"] if full_width else 0
    out["flash_dkv_f32_tc"] = want["flash_dkv"] if full_width else 0
    # flash_manual's int8 QK mode takes its tensor-core kernel at the same shapes
    # (csrc/attn_int8_tc.cuh), counted as flash_manual_int8_tc: on these paths every
    # int8 launch is at the Hopper shapes
    int8_tc = min(want["flash_manual_int8"], want["flash_manual_wgmma"]) if full_width else 0
    out["flash_manual_f32_tc"] = want["flash_manual_wgmma"] - int8_tc if full_width else 0
    out["flash_manual_int8_tc"] = int8_tc
    # the window walks' tensor-core walk (ops/sta_pipe.py:sta_f32_tc_path) takes every
    # f32 q / k launch at head dim 128: every tile of these paths holds a multiple of 8
    # tokens; sta_pipe's int8 QK mode stays on the FFMA core
    out["sta_pipe_f32_tc"] = want["sta_pipe"] - want["sta_pipe_int8"] if full_width else 0
    out["sta_window_f32_tc"] = want["sta_window"] if full_width else 0
    for k in HOPPER_KERNELS + ("flash_dq", "flash_dkv"):
        out[f"{k}_wgmma"] = 0
    out["prologue_rows"] = out["prologue"] if full_width else 0
    for k in F32_KERNELS[:6] + ("flash_dq", "flash_dkv", "sta_window", "sta_row"):
        out[f"{k}_f32"] = out[k]
    out["pool_qkv_f32"] = out["pool_qkv"] + out["pool_qkv_headmap"]
    out["unpool_f32"] = out["unpool"] + out["unpool_headmap"]
    return out


def check_f32_models(torch) -> dict:
    """Reduced-depth forwards in f32, card (the kernels' f32 modes) against
    the CPU (plain versions) from the same weights: Wan 2 blocks at 1.3B
    widths off (160 tokens) and routed hard (grid (8, 24, 20), tile (4, 6,
    4), 4 heads per expert by one-hot routers), HunyuanVideo 1 + 1 blocks
    at 13B widths routed hard ((6, 9, 16), tile (6, 9, 8), 8 heads per
    expert, 83 of 256 text tokens valid): rel L2 <= 1e-4, launches exact."""
    import dataclasses

    import numpy as np

    from vorta_tpu_torch.cli.sample import attention_config
    from vorta_tpu_torch.config import WAN_1_3B, AttentionConfig
    from vorta_tpu_torch.models.hunyuan import HUNYUAN_13B, HunyuanModel
    from vorta_tpu_torch.models.wan import WanModel
    from vorta_tpu_torch.ops import _build

    check_full_f32(torch)
    out = {}

    def gate(name, got, want, launches, expected):
        if launches != expected:
            raise RuntimeError(f"f32 model check {name}: launches {launches} != {expected}")
        if got.dtype != torch.float32 or not torch.isfinite(got).all():
            raise RuntimeError(f"f32 model check {name}: output {got.dtype}, non-finite")
        rel = ((got - want).norm() / want.norm()).item()
        log(f"f32 model check {name}: rel L2 card f32 vs CPU f32 = {rel:.3e} (tolerance 1e-4); "
            f"launches exact")
        if not rel <= 1e-4:
            raise RuntimeError(f"f32 model check {name}: the card's forward disagrees")
        out[name] = rel

    cfg = dataclasses.replace(WAN_1_3B, num_layers=2)
    experts = torch.tensor([0, 1, 2] * 4)
    cpu = WanModel(cfg, dtype=torch.float32, device="cpu", seed=5)
    with torch.no_grad():
        for block in cpu.blocks:
            block.router.linear.weight.zero_()
            block.router.linear.bias.copy_(4.0 * torch.eye(3)[experts].reshape(-1))
    gpu = WanModel(cfg, dtype=torch.float32, device="cuda", seed=5)
    gpu.load_state_dict(cpu.state_dict())
    for name, grid, mode in (("wan_off_2x8x10", (2, 8, 10), "off"),
                             ("wan_routed_8x24x20", (8, 24, 20), "hard")):
        attn = (AttentionConfig(latent_shape=grid) if mode == "off" else AttentionConfig(
            latent_shape=grid, sta_tile=(4, 6, 4), sta_window=(3, 3, 3),
            lowres_window=(2, 3, 2)))
        g = torch.Generator().manual_seed(6)
        lat = torch.randn((1, grid[0], 2 * grid[1], 2 * grid[2], 16), generator=g)
        ctx = torch.randn((1, TEXT_LEN, cfg.text_dim), generator=g)
        t = torch.tensor([700.0])
        want = cpu(lat, t, ctx, attn_cfg=attn, routing_mode=mode).sample
        _build.reset_launches()
        res = gpu(lat.cuda(), t.cuda(), ctx.cuda(), attn_cfg=attn, routing_mode=mode)
        got = res.sample.cpu()
        if mode == "off":
            expected = off_wan_launches(1, blocks=2)
        else:
            if not (res.expert_ids == experts.numpy()).all():
                raise RuntimeError(f"f32 model check {name}: routing {res.expert_ids}")
            expected = routed_wan_launches(np.asarray(res.expert_ids)[None], "sta_pipe", 1)
        gate(name, got, want, dict(_build.launches), f32_launches(expected, True))
    del cpu, gpu

    hcfg = dataclasses.replace(HUNYUAN_13B, dual_layers=1, single_layers=1)
    grid = (6, 9, 16)
    attn = attention_config("hunyuan-13B", grid)
    hexperts = torch.tensor([0, 1, 2] * 8)
    gpu = HunyuanModel(hcfg, dtype=torch.float32, device="cuda", seed=3)
    for block in gpu.blocks:
        block.router.linear.weight.zero_()
        block.router.linear.bias.copy_(4.0 * torch.eye(3, device="cuda")[hexperts].reshape(-1))
    cpu = HunyuanModel(hcfg, dtype=torch.float32, device="meta").to_empty(device="cpu")
    cpu.load_state_dict(gpu.state_dict())
    lat, text, mask, pooled = hy_inputs(torch, grid, torch.device("cuda"), 9)
    args = (lat, torch.tensor([700.0], device="cuda"), text, mask, pooled)
    gd = torch.tensor([6000.0], device="cuda")
    want = cpu(*(x.cpu() for x in args), guidance=gd.cpu(), attn_cfg=attn,
               routing_mode="hard").sample
    _build.reset_launches()
    res = gpu(*args, guidance=gd, attn_cfg=attn, routing_mode="hard")
    if not (res.expert_ids == hexperts.numpy()).all():
        raise RuntimeError(f"f32 model check hunyuan: routing {res.expert_ids}")
    expected = hy_hard_launches(np.asarray(res.expert_ids)[None], dual=1)
    gate("hunyuan_routed_6x9x16", res.sample.cpu(), want, dict(_build.launches),
         f32_launches(expected, True))
    del cpu, gpu
    return out


def tiny_embeds(cfg, path: Path, seed: int) -> str:
    """A (1, text_len, text_dim) f32 embeddings file drawn on the host, so
    that the card's and the CPU's runs read the same conditioning."""
    import numpy as np

    rng = np.random.default_rng(seed)
    np.save(path, rng.standard_normal((1, cfg.text_len, cfg.text_dim)).astype(np.float32))
    return str(path)


def host_drawn(torch, module):
    """A with-block in which ``module``'s model constructors draw their weights
    on the host (then move them to the device) and the pipelines draw their
    noise on the host: the card's run and the CPU's start from the same
    numbers, as the RNGs of the two devices differ."""
    import contextlib
    from unittest import mock

    from vorta_tpu_torch.pipelines.hunyuan_t2v import HunyuanT2VPipeline
    from vorta_tpu_torch.pipelines.wan_t2v import WanT2VPipeline

    def on_host(cls):
        def build(cfg, dtype=torch.float32, device=None, seed: int = 0):
            return cls(cfg, dtype=dtype, device="cpu", seed=seed).to(device)
        return build

    def noise(self, generator, batch, frames, height, width):
        shape = (batch, (frames - 1) // 4 + 1, height // 8, width // 8,
                 self.model.cfg.in_channels)
        seed = generator.initial_seed()
        return torch.randn(shape, generator=torch.Generator().manual_seed(seed)).to(
            self.model.device)

    stack = contextlib.ExitStack()
    for name in ("WanModel", "HunyuanModel"):
        if hasattr(module, name):
            stack.enter_context(mock.patch.object(module, name, on_host(getattr(module, name))))
    for pipe in (WanT2VPipeline, HunyuanT2VPipeline):
        stack.enter_context(mock.patch.object(pipe, "prepare_latents", noise))
    return stack


def run_f32_serving_path(torch, card: str):
    """The f32 serving path through the normal entry points, on the card:
    cli.sample --dtype fp32 for Wan-1.3B at full width and depth, routing
    off at 480p x 21f and routed at 480p x 77f, one UniPC step x CFG each;
    wan-tiny and hunyuan-tiny (the f32 models the JAX tools build) routed
    through cli.sample, 2 steps, card against --device cpu from the same
    host-drawn weights, noise and embeddings (final latents rel L2 <=
    1e-3); cli.bench_compare --model wan-tiny and --model hunyuan-tiny (1
    step, every arm's launches exact); tools.fit_cache_poly (wan-tiny, 4
    steps).  Every path's launches exact, every *_f32 counter among them."""
    import dataclasses
    from unittest import mock

    import numpy as np

    from vorta_tpu_torch.cli import bench_compare, sample
    from vorta_tpu_torch.cli.sample import attention_config
    from vorta_tpu_torch.config import WAN_1_3B, WAN_TINY
    from vorta_tpu_torch.models.hunyuan import HUNYUAN_TINY
    from vorta_tpu_torch.models.wan import WanModel
    from vorta_tpu_torch.ops import _build
    from vorta_tpu_torch.tools import fit_cache_poly

    check_full_f32(torch)
    res_dir = HERE / "results" / "port_smoke" / "f32"  # listed in .gitignore
    res_dir.mkdir(parents=True, exist_ok=True)
    launches, stats = {}, {}

    # Wan-1.3B f32: warm cuBLAS and the allocator with a 2-block f32 model first
    for name, grid, frames, extra, want_of in (
            ("f32_off_480p_21f", GRID_480P, "21", ["--native_attention"],
             lambda res: off_wan_launches(2)),
            ("f32_hard_480p_77f", GRID_480P_77F, "77", [],
             lambda res: routed_wan_launches(np.stack(res.routing), "sta_pipe", 2))):
        warm = WanModel(dataclasses.replace(WAN_1_3B, num_layers=2), dtype=torch.float32,
                        device="cuda", seed=1)
        warm(torch.randn((1, grid[0], 2 * grid[1], 2 * grid[2], 16), device="cuda"),
             torch.tensor([900.0], device="cuda"), torch.randn((1, TEXT_LEN, 4096), device="cuda"),
             attn_cfg=attention_config("wan-1_3B", grid),
             routing_mode="off" if extra else "hard")
        del warm
        torch.cuda.synchronize()
        _build.reset_launches()
        res = sample.main(["--model", "wan-1_3B", "--dtype", "fp32", "--random_embeds",
                           "--num_frames", frames, "--height", "480", "--width", "832",
                           "--num_inference_steps", "1", "--seed", "0",
                           "--output", str(res_dir / f"{name}.npy"), *extra])
        launches[name] = got = dict(_build.launches)
        want = f32_launches(want_of(res), True)
        lat = res.latents
        if got != want or lat.dtype != torch.float32 or not torch.isfinite(lat).all():
            raise RuntimeError(f"{name}: launches {got} != {want}, or output {lat.dtype} "
                               "non-finite")
        stats[name] = {"s_per_step": res.denoise_s / res.steps, "forwards": 2,
                       "build_s": res.build_s}
        log(f"cli.sample --dtype fp32 Wan-1.3B {name}: {stats[name]['s_per_step']:.3f} s per "
            f"UniPC step x CFG (2 forwards) on {card}; launches exact {got}")
        del res
        torch.cuda.empty_cache()

    # the tiny models through cli.sample, card against the CPU, same host draws
    for model, cfg, size in (("wan-tiny", WAN_TINY, ["--num_frames", "13", "--height", "64",
                                                     "--width", "64"]),
                             ("hunyuan-tiny", HUNYUAN_TINY, ["--num_frames", "13", "--height",
                                                             "96", "--width", "256"])):
        emb = tiny_embeds(cfg, res_dir / f"{model}_embeds.npy", 7)
        base = ["--model", model, "--dtype", "fp32", "--prompt_embeds", emb,
                "--num_inference_steps", "2", "--seed", "0", *size]
        runs = {}
        for dev in ("cuda", "cpu"):
            _build.reset_launches()
            with host_drawn(torch, sample):
                runs[dev] = sample.main(base + ["--device", dev, "--output",
                                                str(res_dir / f"{model}_{dev}.npy")])
            if dev == "cuda":
                got = dict(_build.launches)
        res = runs["cuda"]
        tables = np.stack(res.routing)
        want = f32_launches(
            hy_hard_launches(tables, sta_kernel="sta_batched", dual=cfg.dual_layers)
            if model.startswith("hunyuan") else routed_wan_launches(tables, "sta_pipe",
                                                                   tables.shape[0]), False)
        if got != want:
            raise RuntimeError(f"cli.sample {model} fp32: launches {got} != {want}")
        if not all(np.array_equal(a, b) for a, b in zip(runs["cuda"].routing,
                                                         runs["cpu"].routing)):
            raise RuntimeError(f"cli.sample {model} fp32: the card routes otherwise than the CPU")
        a, b = runs["cuda"].latents.cpu(), runs["cpu"].latents
        rel = ((a - b).norm() / b.norm()).item()
        log(f"cli.sample {model} --dtype fp32, 2 steps: card vs --device cpu final latents "
            f"rel L2 {rel:.3e} (tolerance 1e-3); routing equal; launches exact {got}")
        if not (torch.isfinite(a).all() and rel <= 1e-3):
            raise RuntimeError(f"cli.sample {model} fp32: card and CPU disagree")
        launches[f"f32_sample_{model}"] = got
        stats[f"sample_{model}"] = {"rel_l2_vs_cpu": rel, "s_per_step": res.denoise_s / res.steps}

    # cli.bench_compare on the tiny models: every arm's launches exact
    for model, blocks, dual in (("wan-tiny", WAN_TINY.num_layers, None),
                                ("hunyuan-tiny", HUNYUAN_TINY.dual_layers
                                 + HUNYUAN_TINY.single_layers, HUNYUAN_TINY.dual_layers)):
        size = (["--num_frames", "13", "--height", "64", "--width", "64"] if dual is None
                else ["--num_frames", "13", "--height", "96", "--width", "256"])
        _build.reset_launches()
        res = bench_compare.main(["--model", model, "--num_inference_steps", "1", "--seed", "0",
                                  "--output_dir", str(res_dir / f"compare_{model}"), *size])
        n_fwd = 2 * (2 if dual is None else 1)  # the --seed and the timed run; Wan's CFG
        for arm, got in res.launches.items():
            if arm == "baseline":
                want = (off_wan_launches(n_fwd, blocks) if dual is None else {
                    **dict.fromkeys(_build.KERNELS, 0), "flash_manual": blocks * n_fwd,
                    "flash_manual_wgmma": blocks * n_fwd, "prologue": blocks * n_fwd,
                    "prologue_rows": blocks * n_fwd,
                    "fused_norm": (4 * dual + blocks - dual + 1) * n_fwd})
            elif dual is None:
                want = routed_run_launches(res.routing[arm], res.cache_log[arm])
            else:
                want = hy_hard_launches(np.stack(res.routing[arm]), sta_kernel="sta_batched",
                                        dual=dual)
            want = f32_launches(want, False)
            if got != want:
                raise RuntimeError(f"bench_compare {model} arm {arm}: launches {got} != {want}")
        finite_numbers(res.summary)
        launches[f"f32_bench_compare_{model}"] = dict(_build.launches)
        stats[f"bench_compare_{model}"] = {
            "speedup": res.summary["speedup"],
            "s_per_step": {a: res.summary[a]["s_per_step"] for a in res.launches
                           if a in res.summary}}
        log(f"cli.bench_compare --model {model} (f32) on {card}: {stats[f'bench_compare_{model}']}"
            "; every arm's launches exact")
        del res

    # tools.fit_cache_poly, wan-tiny (its default model), 4 steps
    tables, built = [], []
    _build.reset_launches()
    with mock.patch.object(fit_cache_poly, "WanModel",
                           hooked(fit_cache_poly.WanModel, tables, built)):
        rec = fit_cache_poly.main(["--steps", "4", "--degree", "2",
                                   "--out", str(res_dir / "cache_poly_tiny.npz")])
    del built[:]
    got = dict(_build.launches)
    want = f32_launches(routed_wan_launches(np.stack(tables), "sta_pipe", len(tables)), False)
    if len(tables) != 4 or got != want or not np.isfinite(rec["coefficients"]).all():
        raise RuntimeError(f"fit_cache_poly wan-tiny (f32): launches {got} != {want}, "
                           f"{len(tables)} forwards, {rec}")
    launches["f32_fit_cache_poly_wan_tiny"] = got
    stats["fit_cache_poly_wan_tiny"] = {"points": rec["points"], "r2": rec["r2_exact"]}
    log(f"tools.fit_cache_poly wan-tiny (f32) on {card}: {rec['points']} points, r2 "
        f"{rec['r2_exact']:.4f}; launches exact")
    lit = {k: sum(p.get(f"{k}_f32", 0) for p in launches.values()) for k in F32_KERNELS}
    if not all(lit.values()):
        raise RuntimeError(f"f32 serving: a kernel's f32 mode never launched: {lit}")
    log(f"f32 serving: *_f32 launches over the paths {lit}")
    return launches, stats



def run_f32_profile(torch, card: str) -> dict:
    """One routed Wan-1.3B 480p x 77f forward in f32 split by op, and one
    with --qk_int8: cli.profile_forward --dtype fp32 --routing hard [--qk_int8]
    in-process (random weights and routers, t = 900; a warm-up forward, then
    one under io/profiling's trace), its report kept off stdout.  Every
    flash, flash_manual and sta_pipe launch of the two forwards on the
    tensor cores (flash_manual's int8 mode on its own kernel,
    flash_manual_int8_tc; sta_pipe's on the window walk, sta_pipe_f32_tc):
    {"f32": ..., "f32_qk_int8": ...}."""
    import contextlib
    import io

    from vorta_tpu_torch.cli import profile_forward
    from vorta_tpu_torch.ops import _build

    out = {}
    for name, extra, tc in (("f32", [], "flash_manual_f32_tc"),
                            ("f32_qk_int8", ["--qk_int8"], "flash_manual_int8_tc")):
        _build.reset_launches()
        with contextlib.redirect_stdout(io.StringIO()):
            res = profile_forward.main(["--num_frames", "77", "--routing", "hard", "--dtype",
                                        "fp32", *extra])
        n = {k: _build.launches[k] for k in ("flash", "flash_f32_tc", "flash_manual", tc,
                                             "sta_pipe", "sta_pipe_f32_tc")}
        if not (n["flash"] == n["flash_f32_tc"] > 0 and n["flash_manual"] == n[tc] > 0
                and n["sta_pipe"] == n["sta_pipe_f32_tc"] > 0):
            raise RuntimeError(f"{name} profile: a flash / flash_manual / sta_pipe launch off "
                               f"the tensor cores {n}")
        out[name] = {k: res[k] for k in ("wall_ms", "device_ms", "idle_share",
                                         "heads_per_expert", "max_memory_gib", "groups", "top")}
        by_group = {g: (round(v["ms"], 3), round(v["share"], 4), v["launches"])
                    for g, v in out[name]["groups"].items()}
        log(f"{name} profile: one routed Wan-1.3B 480p x 77f forward ({' '.join(extra) or 'f32'}) "
            f"on {card}: wall {out[name]['wall_ms']:.1f} ms, device "
            f"{out[name]['device_ms']:.1f} ms, idle {out[name]['idle_share']:.4f}, heads "
            f"{out[name]['heads_per_expert']}; by group (ms, share, launches) {by_group}; "
            f"launches {n}")
    return out


# ---- training in f32: the f32 lse, the f32 dq and dk/dv kernels, cli.train --dtype fp32 ------

# f32 training gates (set before the first run): the kernels against their
# plain versions on the same f32 inputs, TF32 off on both sides, worst |err| /
# max(|plain|, RMS(plain)) <= TOL_F32_ATTN for out, dq, dk, dv (FFMA sums
# against cuBLAS's in another order), the lse within LSE_ATOL + LSE_RTOL x
# |plain|; each bracket (the plain version without the tail mask, with p and
# ds rounded to bf16) at least F32_BRACKET times that tolerance on that
# scale: rejected with a margin.  (A rounding bracket cannot reach a worst
# ratio of 2 itself: bf16 keeps 2^-8 of a value.)  Reduced-depth train
# steps card f32 vs CPU f32: loss rel <= 1e-4, router gradients rel L2 <=
# 1e-3; the tiny trainers' routers after 2 steps rel L2 <= 1e-3.
F32_BRACKET = 2.0
F32_TRAIN_REPLACES = {"flash_lse": "vorta_tpu/ops/flash.py:237",
                      "flash_dq": "vorta_tpu/ops/flash_bwd.py:75",
                      "flash_dkv": "vorta_tpu/ops/flash_bwd.py:116"}
# the smoke's f32 training grid: 480 x 832 x 29 frames (--num_latent_t 8)
GRID_F32_TRAIN = (8, 30, 52)


def f32_training_calls(torch) -> dict:
    """training_calls()'s six shapes (12 x 128 heads) and the tiny models'
    (2 x 64 heads): blocks of 16 and 8 rows over dense tables with q block
    0 visiting nothing (count 0: the lse sentinel, zero dq) and a kv tail."""
    import numpy as np

    from vorta_tpu_torch.ops.flash import tables_from_block_mask

    calls = {name: dict(c, h=12, d=128) for name, c in training_calls(torch).items()}
    for name, block, n, valid in (("tiny_blocks16_d64", 16, 6, 90), ("tiny_blocks8_d64", 8, 8, 61)):
        mask = np.ones((1, n, n), bool)
        mask[:, 0] = False
        calls[name] = dict(tables=tables_from_block_mask(mask), sq=n * block, skv=n * block,
                           q_valid=n * block, kv_valid=valid, bq=block, bkv=block, h=2, d=64)
    return calls


def bwd_rounded_p(torch, q, k, v, out, lse2, dout, kv_index, kv_count, *, scale, block_q,
                  block_kv, kv_valid_len):
    """The bracket of the f32 backward: flash_backward_ref's arithmetic with
    p and ds rounded to bf16, as the bf16 kernels round them."""
    from vorta_tpu_torch.ops.flash import _kv_column_limit
    from vorta_tpu_torch.ops.flash_bwd import LOG2E, NEG_INF, visible_blocks

    skv = k.shape[2]
    delta = (dout * out).sum(dim=-1, keepdim=True)
    blocks = visible_blocks(kv_index, kv_count, skv // block_kv).to(q.device)
    col_ok = _kv_column_limit(skv, block_kv, kv_valid_len, q.device)
    dq, dk, dv = (torch.zeros_like(x) for x in (q, k, v))
    for i in range(q.shape[2] // block_q):
        rows = slice(i * block_q, (i + 1) * block_q)
        vis = blocks[i].repeat_interleave(block_kv) & col_ok
        s2 = torch.where(vis, torch.einsum("bhqd,bhkd->bhqk", q[:, :, rows], k) * (scale * LOG2E),
                         NEG_INF)
        p = torch.exp2(s2 - lse2[:, :, rows])
        ds = p * (torch.einsum("bhqd,bhkd->bhqk", dout[:, :, rows], v) - delta[:, :, rows])
        p, ds = (x.bfloat16().float() for x in (p, ds))
        dq[:, :, rows] = torch.einsum("bhqk,bhkd->bhqd", ds, k) * scale
        dv += torch.einsum("bhqk,bhqd->bhkd", p, dout[:, :, rows])
        dk += torch.einsum("bhqk,bhqd->bhkd", ds, q[:, :, rows]) * scale
    return dq, dk, dv


def check_f32_training_kernels(torch, card: str) -> dict:
    """Phase s: the f32 forward with its lse and the f32 dq and dk/dv
    kernels at the trainer's six shapes and the tiny models' D = 64 shapes,
    each against its f32 plain version (gates above), launched once on its
    f32 mode and timed beside its bound (67 TFLOP/s f32) and f32 SDPA
    forward / backward with TF32 off; brackets at LOWRES (a kv tail).  At
    every D 128 call, the STA tiles of 96, 360 and 24 tokens too, the
    forward runs on the tensor-core core (flash_f32_tc,
    ops/flash.py:flash_f32_tc_path) and the backward on the tensor-core dq
    and dk/dv (flash_dq_f32_tc / flash_dkv_f32_tc, csrc/attn_f32_tc_bwd.cuh;
    the same rule), their STA blocks
    checked again on small tables with a kv tail and a count-0 q block
    (``check_f32_tc_edges``).  Each tensor-core call is
    held to the same gates beside the FFMA kernels at the same call
    (sparse_flash_attention_ffma, flash_backward_ffma), both timed in turns,
    its bound the 3xTF32 one (495 TFLOP/s TF32, a third of it f32-exact),
    with the bracket of its inputs rounded once to TF32 (q, k, v; the
    backward's q, k, v and dO: >= 2e-4 at FULL, LOWRES and STA 96); D 64
    stays on the FFMA kernels by rule: {"lse" | "dq" | "dkv": {shape:
    numbers}, "dq_dkv_edges": {block: numbers}} (the edges' forward and
    backward)."""
    import torch.nn.functional as F

    from vorta_tpu_torch.ops import _build
    from vorta_tpu_torch.ops.flash import (
        flash_f32_tc_path,
        sparse_flash_attention_ffma,
        sparse_flash_attention_raw,
        sparse_flash_attention_ref,
    )
    from vorta_tpu_torch.ops.flash_bwd import (
        flash_backward,
        flash_backward_ffma,
        flash_backward_ref,
        transpose_tables,
    )

    check_full_f32(torch)
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(20)
    res = {"lse": {}, "dq": {}, "dkv": {}}
    for name, c in f32_training_calls(torch).items():
        h, d, sq, skv, qv, kvv = c["h"], c["d"], c["sq"], c["skv"], c["q_valid"], c["kv_valid"]
        big = sq * skv * h > 1e9
        q = torch.randn((1, h, sq, d), generator=g, device=dev)
        k, v = (torch.randn((1, h, skv, d), generator=g, device=dev) for _ in range(2))
        dout = torch.randn((1, h, sq, d), generator=g, device=dev)
        dout[:, :, qv:] = 0  # the trainer slices the padded rows off the output
        ki, kc = c["tables"].on(dev)
        qi, qc = (torch.from_numpy(a).to(dev) for a in transpose_tables(
            c["tables"].kv_index, c["tables"].kv_count, skv // c["bkv"]))
        kw = dict(scale=d**-0.5, block_q=c["bq"], block_kv=c["bkv"])
        valid = kvv if kvv != skv else None
        fwd = lambda: sparse_flash_attention_raw(q, k, v, ki, kc, kv_valid_len=valid,  # noqa: E731
                                                 return_lse=True, **kw)
        # the tensor-core core where the rule holds (every D 128 call, the STA tiles
        # too), timed in turns with the FFMA core at the same call
        tc = flash_f32_tc_path(d, c["bq"], c["bkv"])
        ffma = lambda: sparse_flash_attention_ffma(q, k, v, ki, kc, kv_valid_len=valid,  # noqa: E731
                                                   return_lse=True, **kw)
        _build.reset_launches()
        out, lse = fwd()
        torch.cuda.synchronize()
        got_n = tuple(_build.launches[x] for x in ("flash", "flash_f32", "flash_lse", "flash_wgmma",
                                                   "flash_f32_tc"))
        if got_n != (1, 1, 1, 0, int(tc)):
            raise RuntimeError(f"f32 lse {name}: launches (flash, _f32, _lse, _wgmma, _f32_tc) "
                               f"{got_n}")
        (want_out, want_lse), fwd_plain_ms = timed_once(torch, lambda: sparse_flash_attention_ref(
            q, k, v, ki, kc, kv_valid_len=valid, return_lse=True, **kw))
        out_ratio = worst_ratio(torch, out[:, :, :qv], want_out[:, :, :qv])
        out_err = (out[:, :, :qv] - want_out[:, :, :qv]).abs().max().item()
        lse_err = (lse - want_lse).abs()
        lse_bad = int((lse_err > LSE_ATOL + LSE_RTOL * want_lse.abs()).sum())
        sentinel = int((want_lse == 1e30).sum())
        log(f"f32 flash + lse {name} (1,{h},{sq},{d}) x {skv}: out worst ratio {out_ratio:.3e} "
            f"(tolerance {TOL_F32_ATTN:g}); lse max |err| {lse_err.max().item():.3e} (tolerance "
            f"{LSE_ATOL:g} + {LSE_RTOL:g} x |plain|, {lse_bad} outside), sentinel rows {sentinel}")
        if not (out_ratio <= TOL_F32_ATTN and lse_bad == 0 and torch.isfinite(out).all()):
            raise RuntimeError(f"f32 flash + lse {name}: the kernel disagrees with its plain version")
        if sentinel and not (lse[want_lse == 1e30] == 1e30).all():
            raise RuntimeError(f"f32 flash lse {name}: the sentinel rows differ")
        tc_row = {}
        if tc:
            f_out, f_lse = ffma()
            f_bad = int((f_lse - want_lse).abs().gt(LSE_ATOL + LSE_RTOL * want_lse.abs()).sum())
            tc_row["ffma_worst_ratio"] = worst_ratio(torch, f_out[:, :, :qv], want_out[:, :, :qv])
            if not (tc_row["ffma_worst_ratio"] <= TOL_F32_ATTN and f_bad == 0):
                raise RuntimeError(f"f32 flash + lse {name}: the FFMA core disagrees")
            del f_out, f_lse
            miss = sparse_flash_attention_ref(*(tf32_rne(torch, x) for x in (q, k, v)), ki, kc,
                                              kv_valid_len=valid, **kw)
            tc_row["tf32_bracket_worst_ratio"] = worst_ratio(torch, miss[:, :, :qv],
                                                             want_out[:, :, :qv])
            del miss
            gated = name in ("full_31200", "lowres_15600", "sta_31200_tile96")
            bar = "must be" if gated else "recorded; the bar is"
            log(f"f32 flash + lse {name}: the FFMA core's worst ratio "
                f"{tc_row['ffma_worst_ratio']:.3e}; q, k, v rounded to TF32, worst ratio "
                f"{tc_row['tf32_bracket_worst_ratio']:.3e} ({bar} >= "
                f"{F32_BRACKET * TOL_F32_ATTN:g})")
            if gated and not tc_row["tf32_bracket_worst_ratio"] >= F32_BRACKET * TOL_F32_ATTN:
                raise RuntimeError(f"f32 flash + lse {name}: the gate cannot tell a single TF32 "
                                   "product")
        del want_out, want_lse
        bkw = dict(kv_valid_len=kvv, **kw)
        args = (q, k, v, out, lse, dout, ki, kc, qi, qc)
        bwd = lambda **o: flash_backward(*args, **bkw, **o)  # noqa: E731
        bwd_ffma = lambda **o: flash_backward_ffma(*args, **bkw, **o)  # noqa: E731
        plain = lambda: flash_backward_ref(q, k, v, out, lse, dout, ki, kc, **bkw)  # noqa: E731
        btc = flash_f32_tc_path(d, c["bq"], c["bkv"])  # the forward's rule
        _build.reset_launches()
        torch.cuda.reset_peak_memory_stats()
        mem0 = torch.cuda.memory_allocated()
        got = bwd()
        torch.cuda.synchronize()
        peak = (torch.cuda.max_memory_allocated() - mem0) / 2**30
        got_n = tuple(_build.launches[x] for x in ("flash_dq", "flash_dq_f32", "flash_dkv",
                                                   "flash_dkv_f32", "flash_dq_wgmma",
                                                   "flash_dkv_wgmma", "flash_dq_f32_tc",
                                                   "flash_dkv_f32_tc"))
        if got_n != (1, 1, 1, 1, 0, 0, int(btc), int(btc)):
            raise RuntimeError(f"f32 backward {name}: launches (dq, _f32, dkv, _f32, _wgmma x 2, "
                               f"_f32_tc x 2) {got_n}")
        want, bwd_plain_ms = timed_once(torch, plain)
        ratios = [worst_ratio(torch, a, w) for a, w in zip(got, want)]
        errs = [(a - w).abs().max().item() for a, w in zip(got, want)]
        log(f"f32 backward {name} ({'tensor cores' if btc else 'FFMA'}): dq / dk / dv worst ratio "
            f"{ratios[0]:.3e} / {ratios[1]:.3e} / {ratios[2]:.3e} (tolerance {TOL_F32_ATTN:g}); "
            f"max |err| {max(errs):.3e}; peak {peak:.3f} GiB above the inputs")
        if not (max(ratios) <= TOL_F32_ATTN and all(torch.isfinite(a).all() for a in got)):
            raise RuntimeError(f"f32 backward {name}: the kernels disagree with their plain version")
        if got[1][:, :, kvv:].any() or got[2][:, :, kvv:].any():
            raise RuntimeError(f"f32 backward {name}: kv rows past the tail got non-zero dk / dv")
        if not c["tables"].kv_count[0, 0] and got[0][:, :, :c["bq"]].any():
            raise RuntimeError(f"f32 backward {name}: the count-0 q block got non-zero dq")
        del got
        btc_row = {"peak_gib": peak}
        if btc:  # the FFMA kernels at the same call, and the bracket of one TF32 product
            torch.cuda.reset_peak_memory_stats()
            mem0 = torch.cuda.memory_allocated()
            f_got = bwd_ffma()
            torch.cuda.synchronize()
            btc_row["ffma_peak_gib"] = (torch.cuda.max_memory_allocated() - mem0) / 2**30
            btc_row["ffma_worst_ratio"] = max(worst_ratio(torch, a, w) for a, w in zip(f_got, want))
            if not btc_row["ffma_worst_ratio"] <= TOL_F32_ATTN:
                raise RuntimeError(f"f32 backward {name}: the FFMA kernels disagree")
            del f_got
            q1, k1, v1, d1 = (tf32_rne(torch, x) for x in (q, k, v, dout))
            btc_row["tf32_bracket_worst_ratio"] = max(worst_ratio(torch, a, w) for a, w in zip(
                flash_backward_ref(q1, k1, v1, out, lse, d1, ki, kc, **bkw), want))
            del q1, k1, v1, d1
            gated = name in ("full_31200", "lowres_15600", "sta_31200_tile96")
            bar = "must be" if gated else "recorded; the bar is"
            log(f"f32 backward {name}: the FFMA kernels' worst ratio "
                f"{btc_row['ffma_worst_ratio']:.3e}, peak {btc_row['ffma_peak_gib']:.3f} GiB; q, k, "
                f"v, dO rounded to TF32, worst ratio {btc_row['tf32_bracket_worst_ratio']:.3e} "
                f"({bar} >= {F32_BRACKET * TOL_F32_ATTN:g})")
            if gated and not btc_row["tf32_bracket_worst_ratio"] >= F32_BRACKET * TOL_F32_ATTN:
                raise RuntimeError(f"f32 backward {name}: the gate cannot tell a single TF32 "
                                   "product")
        brackets = {}
        if name == "lowres_15600":  # a kv tail at training's size: the gate must see both
            for what, miss in (
                    ("no_tail_mask", lambda: flash_backward_ref(
                        q, k, v, out, lse, dout, ki, kc, **{**bkw, "kv_valid_len": skv})),
                    ("p_ds_bf16", lambda: bwd_rounded_p(torch, q, k, v, out, lse, dout, ki, kc,
                                                        **bkw))):
                brackets[what] = max(worst_ratio(torch, a, w) for a, w in zip(miss(), want))
            log(f"f32 backward {name}: brackets (worst ratio of the plain version without the "
                f"tail mask / with p and ds in bf16) {brackets}")
            if not min(brackets.values()) >= F32_BRACKET * TOL_F32_ATTN:
                raise RuntimeError(f"f32 backward {name}: the gate cannot tell a bracket {brackets}")
        del want
        torch.cuda.empty_cache()

        pairs = visible_pairs(c) * h
        rows_q, rows_kv = qv * h * d * 4, kvv * h * d * 4
        fl = bound_ms(4.0 * pairs * d, 2 * rows_q + 2 * rows_kv + qv * h * 4, PEAK_F32)
        bwd_bytes = {"dq": 3 * rows_q + 2 * rows_kv + 2 * qv * h * 4,
                     "dkv": 2 * rows_q + 4 * rows_kv + 2 * qv * h * 4}
        dq_b = bound_ms(6.0 * pairs * d, bwd_bytes["dq"], PEAK_F32)
        dkv_b = bound_ms(8.0 * pairs * d, bwd_bytes["dkv"], PEAK_F32)
        lib_fwd = lib_bwd = None
        if d == 128:  # f32 SDPA (TF32 off) on the valid rows, STA with the window's mask
            qs, ks, vs = (x[:, :, :n].detach().requires_grad_() for x, n in
                          ((q, qv), (k, kvv), (v, kvv)))
            mask = sta_raster_mask(torch, c["grid"], c["tile"], dev) if "tile" in c else None
            try:
                with torch.no_grad():
                    lib_fwd = time_ms(torch, lambda: F.scaled_dot_product_attention(
                        qs, ks, vs, attn_mask=mask), 2 if big else 5, 1)
                lib_bwd = time_ms(torch, lambda: torch.autograd.grad(
                    F.scaled_dot_product_attention(qs, ks, vs, attn_mask=mask), (qs, ks, vs),
                    dout[:, :, :qv]), 2 if big else 5, 1) - lib_fwd
            except (torch.OutOfMemoryError, RuntimeError) as e:
                log(f"f32 {name}: SDPA yardstick failed: {type(e).__name__}: "
                    f"{str(e).splitlines()[0]}")
            del qs, ks, vs, mask
            torch.cuda.empty_cache()
        iters = 2 if big else 10
        if tc:  # in turns; the 3xTF32 bound, the FFMA one beside it
            ms, f_ms = [], []
            for _ in range(2):
                ms.append(time_ms(torch, fwd, iters, 1))
                f_ms.append(time_ms(torch, ffma, iters, 1))
            fwd_ms = sum(ms) / 2
            tc_row.update(core="tensor_cores", ffma_ms=sum(f_ms) / 2, ffma_bound_ms=fl[0],
                          ffma_bound_share=fl[0] / (sum(f_ms) / 2),
                          tc_over_ffma=sum(ms) / sum(f_ms))
            fl = bound_ms(3 * 4.0 * pairs * d, 2 * rows_q + 2 * rows_kv + qv * h * 4, PEAK_TF32)
            if not (fl[0] <= fwd_ms and tc_row["ffma_bound_ms"] <= tc_row["ffma_ms"]):
                raise RuntimeError(f"f32 flash + lse {name}: a time below its bound")
        else:
            fwd_ms = time_ms(torch, fwd, iters, 1)
            tc_row["core"] = "ffma"
        res["lse"][name] = dict(ms=fwd_ms, plain_ms=fwd_plain_ms,
                                library_ms=lib_fwd, bound_ms=fl[0], bound_by=fl[1],
                                max_abs_err=max(out_err, lse_err.max().item()),
                                worst_ratio=out_ratio, shape=[1, h, sq, d], keys=skv, **tc_row)
        for kind, alone, (b_ms, b_by), i, per_pair in (("dq", "need_dkv", dq_b, 0, 6.0),
                                                       ("dkv", "need_dq", dkv_b, 1, 8.0)):
            row = dict(btc_row)
            if btc:  # in turns; the 3xTF32 bound, the FFMA one beside it
                ms, f_ms = [], []
                for _ in range(2):
                    ms.append(time_ms(torch, lambda: bwd(**{alone: False}), iters, 1))
                    f_ms.append(time_ms(torch, lambda: bwd_ffma(**{alone: False}), iters, 1))
                k_ms = sum(ms) / 2
                row.update(core="tensor_cores", ffma_ms=sum(f_ms) / 2, ffma_bound_ms=b_ms,
                           ffma_bound_share=b_ms / (sum(f_ms) / 2), tc_over_ffma=sum(ms) / sum(f_ms))
                b_ms, b_by = bound_ms(3 * per_pair * pairs * d, bwd_bytes[kind], PEAK_TF32)
                if not (b_ms <= k_ms and row["ffma_bound_ms"] <= row["ffma_ms"]):
                    raise RuntimeError(f"f32 {kind} {name}: a time below its bound")
            else:
                k_ms = time_ms(torch, lambda: bwd(**{alone: False}), iters, 1)
                row["core"] = "ffma"
            res[kind][name] = dict(ms=k_ms, plain_ms=bwd_plain_ms, library_ms=lib_bwd, bound_ms=b_ms,
                                   bound_by=b_by, max_abs_err=errs[0] if i == 0 else max(errs[1:]),
                                   worst_ratio=ratios[0] if i == 0 else max(ratios[1:]),
                                   shape=[1, h, sq, d], keys=skv,
                                   **({"brackets": brackets} if brackets else {}), **row)
        for kind, per_pair in (("lse", 4.0), ("dq", 6.0), ("dkv", 8.0)):
            log(f"f32 {kind} {name}: {with_rate(res[kind][name], per_pair * pairs * d)}")
        del q, k, v, dout, out, lse
        torch.cuda.empty_cache()
    res["dq_dkv_edges"] = {block: check_f32_tc_edges(torch, block) for block in (96, 360, 24)}
    return res


def check_f32_tc_edges(torch, block: int) -> dict:
    """The tensor-core forward (with its lse) and dq and dk/dv at an STA
    block (96, 360, 24) on small tables that the trainer's raster never
    makes: q block 0 with count 0, a kv tail inside the last block (not a
    multiple of 8 at 24), other blocks visited at random; 12 x 128 heads,
    blocks 4 / 3 / 5 a side.  The forward: out against the plain version
    (worst ratio <= 1e-4), the lse within LSE_ATOL + LSE_RTOL x |plain|,
    block 0's rows exact zeros with the lse sentinel 1e30 while block 1's
    rows (the ones block 0's last 64-row tile runs into) match and see
    keys, counted once as flash_f32_tc.  The backward against the plain
    version (worst ratio <= 1e-4), exactly zero dq for the count-0 block
    and dk / dv past the tail, counted once each as _f32_tc."""
    import numpy as np

    from vorta_tpu_torch.ops import _build
    from vorta_tpu_torch.ops.flash import (sparse_flash_attention_raw, sparse_flash_attention_ref,
                                           tables_from_block_mask)
    from vorta_tpu_torch.ops.flash_bwd import flash_backward, flash_backward_ref, transpose_tables

    n, cut = {96: (4, 40), 360: (3, 100), 24: (5, 5)}[block]
    s, valid = n * block, n * block - cut
    rng = np.random.default_rng(block)
    mask = rng.random((1, n, n)) < 0.6
    mask[:, 0] = False
    mask[:, 1:, n - 1] = True
    tab = tables_from_block_mask(mask)
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(block)
    q, k, v, dout = (torch.randn((1, 12, s, 128), generator=g, device=dev) for _ in range(4))
    ki, kc = tab.on(dev)
    qi, qc = (torch.from_numpy(a).to(dev) for a in transpose_tables(tab.kv_index, tab.kv_count, n))
    kw = dict(scale=128**-0.5, block_q=block, block_kv=block, kv_valid_len=valid)
    _build.reset_launches()
    out, lse = sparse_flash_attention_raw(q, k, v, ki, kc, return_lse=True, **kw)
    torch.cuda.synchronize()
    fwd_tc = _build.launches["flash_f32_tc"]
    want_out, want_lse = sparse_flash_attention_ref(q, k, v, ki, kc, return_lse=True, **kw)
    fwd_ratio = worst_ratio(torch, out, want_out)
    next_ratio = worst_ratio(torch, out[:, :, block:2 * block], want_out[:, :, block:2 * block])
    lse_bad = int((lse - want_lse).abs().gt(LSE_ATOL + LSE_RTOL * want_lse.abs()).sum())
    fwd_edges = (not out[:, :, :block].any() and bool((lse[:, :, :block] == 1e30).all())
                 and bool((lse[:, :, block:2 * block] < 1e30).all()))
    log(f"f32 forward edges, blocks {block}: {n} x {n} blocks, q block 0 empty, kv tail at "
        f"{valid}: worst ratio {fwd_ratio:.3e}, block 1's rows {next_ratio:.3e} (tolerance "
        f"{TOL_F32_ATTN:g}); lse outside the gate {lse_bad}; block 0 exact zeros and sentinel, "
        f"block 1 seeing keys: {fwd_edges}; flash_f32_tc launches {fwd_tc}")
    if not (fwd_ratio <= TOL_F32_ATTN and lse_bad == 0 and fwd_edges and fwd_tc == 1
            and torch.isfinite(out).all()):
        raise RuntimeError(f"f32 forward edges, blocks {block}: the tensor-core core disagrees "
                           "with its plain version, or wrote a row it must not")
    del want_out, want_lse
    _build.reset_launches()
    got = flash_backward(q, k, v, out, lse, dout, ki, kc, qi, qc, **kw)
    torch.cuda.synchronize()
    n_tc = (_build.launches["flash_dq_f32_tc"], _build.launches["flash_dkv_f32_tc"])
    want = flash_backward_ref(q, k, v, out, lse, dout, ki, kc, **kw)
    ratio = max(worst_ratio(torch, a, w) for a, w in zip(got, want))
    zeros = not got[0][:, :, :block].any() and not got[1][:, :, valid:].any() \
        and not got[2][:, :, valid:].any()
    log(f"f32 backward edges, blocks {block}: worst ratio {ratio:.3e} (tolerance "
        f"{TOL_F32_ATTN:g}); exact zeros {zeros}; _f32_tc launches {n_tc}")
    if not (ratio <= TOL_F32_ATTN and zeros and n_tc == (1, 1)
            and all(torch.isfinite(a).all() for a in got)):
        raise RuntimeError(f"f32 backward edges, blocks {block}: the tensor-core kernels disagree "
                           "with their plain version, or wrote a row they must not")
    return dict(worst_ratio=ratio, forward_worst_ratio=fwd_ratio,
                forward_next_block_worst_ratio=next_ratio, kv_valid_len=valid, blocks=n,
                shape=[1, 12, s, 128])


def check_f32_train_grads(torch) -> dict:
    """Phase t: one f32 router train step of a 2-block Wan at 1.3B widths
    (grid (4, 12, 8), tile (4, 6, 4): every expert and its backward) and of
    a 1 + 1-block HunyuanVideo at 13B widths ((6, 9, 8) + 256 text tokens,
    83 valid), the card (f32 kernels) against the CPU (f32 plain versions)
    from the same weights and draws: loss rel <= 1e-4, router gradients rel
    L2 <= 1e-3 (set before any run), launches exact."""
    import dataclasses

    from vorta_tpu_torch.cli.sample import attention_config
    from vorta_tpu_torch.config import WAN_1_3B
    from vorta_tpu_torch.models.hunyuan import HUNYUAN_13B, HunyuanModel
    from vorta_tpu_torch.models.wan import WanModel
    from vorta_tpu_torch.ops import _build
    from vorta_tpu_torch.schedulers.flow_match import train_sigmas
    from vorta_tpu_torch.training.step import (LossWeights, make_hunyuan_router_train_step,
                                               make_router_train_step, router_partition)

    check_full_f32(torch)
    sig = train_sigmas(5.0)
    t, s = torch.tensor([float(sig[300] * 1000.0)]), torch.tensor([float(sig[300])])
    out = {}

    def gate(name, step, cpu, gpu, inputs, expected):
        def run(model, dev):
            routers = router_partition(model)
            share, m = step.loss(model, *(x.to(dev) for x in inputs))
            grads = torch.autograd.grad(share, list(routers.values()))
            return m["loss"].item(), torch.cat([x.flatten().cpu() for x in grads])

        _build.reset_launches()
        loss_g, grads_g = run(gpu, "cuda")
        launches = dict(_build.launches)
        loss_c, grads_c = run(cpu, "cpu")
        rel_loss = abs(loss_g - loss_c) / abs(loss_c)
        rel = ((grads_g - grads_c).norm() / grads_c.norm()).item()
        log(f"f32 gradient check {name}: loss card {loss_g:.8f} vs CPU {loss_c:.8f} (rel "
            f"{rel_loss:.2e}, tolerance 1e-4); router gradients rel L2 {rel:.3e} (tolerance 1e-3; "
            f"|grad| {grads_c.norm().item():.3e}); launches {launches}")
        if launches != expected:
            raise RuntimeError(f"f32 gradient check {name}: launches {launches} != {expected}")
        if not (torch.isfinite(grads_g).all() and rel_loss <= 1e-4 and rel <= 1e-3):
            raise RuntimeError(f"f32 gradient check {name}: the card's step disagrees with the CPU's")
        out[name] = dict(rel_loss=rel_loss, grad_rel_l2=rel)

    grid = (4, 12, 8)
    cfg = dataclasses.replace(WAN_1_3B, num_layers=2)
    step = make_router_train_step(attention_config("wan-1_3B", grid), LossWeights(),
                                  timestep_table=sig * 1000.0, sigma_table=sig)
    gen = torch.Generator().manual_seed(22)
    lat = torch.randn((1, grid[0], 2 * grid[1], 2 * grid[2], 16), generator=gen)
    ctx = torch.randn((1, TEXT_LEN, cfg.text_dim), generator=gen)
    eps = torch.randn(lat.shape, generator=gen)
    cpu = WanModel(cfg, dtype=torch.float32, device="cpu", seed=23)
    gpu = WanModel(cfg, dtype=torch.float32, device="cuda", seed=23)
    gpu.load_state_dict(cpu.state_dict())
    gate("wan_2_blocks_4x12x8", step, cpu, gpu, (lat, ctx, t, s, eps),
         f32_launches(train_launches(_build.KERNELS, 2), True))
    del cpu, gpu

    hgrid = (6, 9, 8)
    hcfg = dataclasses.replace(HUNYUAN_13B, dual_layers=1, single_layers=1)
    hstep = make_hunyuan_router_train_step(attention_config("hunyuan-13B", hgrid),
                                           LossWeights(hidden_layer_distill=1.0),
                                           timestep_table=sig * 1000.0, sigma_table=sig)
    hlat, text, mask, pooled = (x.cpu() for x in hy_inputs(torch, hgrid, torch.device("cuda"), 24))
    heps = torch.randn(hlat.shape, generator=torch.Generator().manual_seed(25))
    gpu = HunyuanModel(hcfg, dtype=torch.float32, device="cuda", seed=26)
    cpu = HunyuanModel(hcfg, dtype=torch.float32, device="meta").to_empty(device="cpu")
    cpu.load_state_dict(gpu.state_dict())
    gate("hunyuan_1_1_blocks_6x9x8", hstep, cpu, gpu, (hlat, text, mask, pooled, t, s, heps),
         f32_launches(hy_train_launches(1, 1), True))
    del cpu, gpu
    return out


def host_draws(torch):
    """A with-block in which the train step draws its timesteps and noise
    from a CPU generator seeded as the trainer's own, so that a run on the
    card and one with --device cpu draw the same numbers (the two devices'
    generators differ); with --device cpu the stream is the trainer's own."""
    from unittest import mock

    from vorta_tpu_torch.training.step import RouterTrainStep

    draw, hosts = RouterTrainStep.draw, {}

    def host_draw(self, generator, latents):
        gen = hosts.setdefault(id(generator),
                               torch.Generator().manual_seed(generator.initial_seed()))
        return draw(self, gen, latents)

    return mock.patch.object(RouterTrainStep, "draw", host_draw)


def run_f32_train_main_path(torch, card: str):
    """Phase u: cli.train --model wan-1_3B --dtype fp32 at its default device
    on (8, 30, 52) = 12,480 tokens (--num_latent_t 8): 2 optimizer steps of 1
    micro-step and a checkpoint, resumed to step 3, launches exact (every
    flash, dq and dk/dv on the f32 mode, no bf16 kernel), metrics finite,
    the routers moved; cli.sample --dtype fp32 --resume_dir serves that step
    dir for 1 UniPC step x CFG at the grid it trained (480 x 832 x 29
    frames); then wan-tiny and hunyuan-tiny through cli.train --dtype fp32
    on the card against --device cpu from the same host-drawn weights and
    draws (routers after 2 steps rel L2 <= 1e-3)."""
    import math
    import shutil

    import numpy as np

    from vorta_tpu_torch.cli import sample, train
    from vorta_tpu_torch.ops import _build
    from vorta_tpu_torch.ops.routed_fused import routed_sta_kernel

    check_full_f32(torch)
    out_dir = HERE / "results" / "port_smoke" / "train_f32"  # listed in .gitignore
    shutil.rmtree(out_dir, ignore_errors=True)
    base = ["--model", "wan-1_3B", "--dtype", "fp32", "--synthetic_data", "--num_latent_t",
            str(GRID_F32_TRAIN[0]), "--gradient_accumulation_steps", "1",
            "--output_dir", str(out_dir)]
    per_micro = f32_launches(train_launches(_build.KERNELS, 30), True)
    launches, runs = {}, []
    for path, extra, micro in (
            ("train_f32_480p_29f", ["--max_train_steps", "2"], 2),
            ("train_f32_480p_29f_resumed", ["--max_train_steps", "3", "--resume_from_checkpoint",
                                            "latest"], 1)):
        _build.reset_launches()
        res = train.main(base + extra)
        launches[path] = dict(_build.launches)
        expected = {k: v * micro for k, v in per_micro.items()}
        if launches[path] != expected or len(res.micro_s) != micro:
            raise RuntimeError(f"f32 training {path}: launches {launches[path]} != {expected}, "
                               f"or {len(res.micro_s)} micro-steps")
        runs.append(res)
        torch.cuda.empty_cache()
    first, second = runs
    metrics = first.metrics + second.metrics
    moved = max((first.router_final[k] - first.router_init[k]).abs().max().item()
                for k in first.router_init)
    if not all(math.isfinite(m[k]) for m in metrics for k in ("loss", "grad_norm")) \
            or not moved > 0 or (first.final_step, second.init_step, second.final_step) != (2, 2, 3):
        raise RuntimeError(f"f32 training: metrics {metrics}, routers moved {moved}, steps "
                           f"{first.final_step} / {second.init_step} / {second.final_step}")
    if any(not torch.equal(second.router_init[k], first.router_final[k]) for k in first.router_final):
        raise RuntimeError("f32 training: the resumed run did not start from the checkpoint")
    stats = dict(micro_s=first.micro_s[1], first_micro_s=first.micro_s[0],
                 resumed_micro_s=second.micro_s[0],
                 max_memory_gib=max(first.max_memory_bytes, second.max_memory_bytes) / 2**30)
    log(f"f32 training main path: cli.train --dtype fp32 Wan-1.3B 30 blocks, {GRID_F32_TRAIN} = "
        f"12,480 tokens, soft routing + teacher, remat: micro-steps "
        f"{[round(x, 3) for x in first.micro_s + second.micro_s]} s (steady {stats['micro_s']:.3f} "
        f"s, the first warms up); peak {stats['max_memory_gib']:.2f} GiB; routers moved by up to "
        f"{moved:.3e}; resumed at step {second.init_step} on {card}; launches per micro-step "
        f"{per_micro} (exact)")
    for m in metrics:
        log(f"f32 training step {m['step']}: " + ", ".join(
            f"{k} {m[k]:.6g}" for k in ("loss", "l_fm", "l_reg", "l_last", "grad_norm",
                                         "timestep")))
    del first, second, runs

    # serve the trained step dir in f32 at its grid
    ckpt = out_dir / "ckpt" / "step-000002"
    _build.reset_launches()
    with torch.inference_mode():
        res = sample.main(["--model", "wan-1_3B", "--dtype", "fp32", "--random_embeds",
                           "--num_frames", "29", "--height", "480", "--width", "832",
                           "--num_inference_steps", "1", "--seed", "0", "--resume_dir",
                           str(out_dir), "--router_checkpoint", str(ckpt),
                           "--output", str(out_dir / "sample.npy")])
    launches["sample_f32_trained"] = got = dict(_build.launches)
    attn = sample.resolve_attention_config(sample.parse_args(
        ["--model", "wan-1_3B", "--resume_dir", str(out_dir)]), GRID_F32_TRAIN)
    want = f32_launches(routed_wan_launches(np.stack(res.routing),
                                            routed_sta_kernel(attn, 128, 4), 2), True)
    if got != want or res.latents.dtype != torch.float32 or not torch.isfinite(res.latents).all():
        raise RuntimeError(f"f32 trained sample: launches {got} != {want}, or output "
                           f"{res.latents.dtype} non-finite")
    heads = np.bincount(np.stack(res.routing).reshape(-1), minlength=3)
    stats["sample_s_per_step"] = res.denoise_s / res.steps
    log(f"f32 trained sample: cli.sample --dtype fp32 --resume_dir --router_checkpoint "
        f"{ckpt.name} at {GRID_F32_TRAIN}: {stats['sample_s_per_step']:.3f} s per UniPC step x CFG; "
        f"heads full {heads[0]}, lowres {heads[1]}, sta {heads[2]}; launches exact")
    del res
    shutil.rmtree(out_dir, ignore_errors=True)
    torch.cuda.empty_cache()

    # the tiny trainers on the card against --device cpu, same host draws
    for model, hunyuan in (("wan-tiny", False), ("hunyuan-tiny", True)):
        runs = {}
        for dev in ("cuda", "cpu"):
            _build.reset_launches()
            with host_drawn(torch, train), host_draws(torch):
                runs[dev] = train.main(["--model", model, "--dtype", "fp32", "--device", dev,
                                        "--synthetic_data", "--max_train_steps", "2",
                                        "--gradient_accumulation_steps", "1", "--output_dir",
                                        str(out_dir / f"{model}_{dev}")])
            if dev == "cuda":
                got = dict(_build.launches)
        cfg = train.MODELS[model]
        per = (hy_train_launches(cfg.dual_layers, cfg.single_layers) if hunyuan
               else train_launches(_build.KERNELS, cfg.num_layers))
        want = {k: 2 * v for k, v in f32_launches(per, False).items()}
        a, b = (torch.cat([r.router_final[k].flatten() for k in sorted(r.router_final)])
                for r in (runs["cuda"], runs["cpu"]))
        rel = ((a - b).norm() / b.norm()).item()
        log(f"cli.train {model} --dtype fp32, 2 steps: card vs --device cpu routers rel L2 "
            f"{rel:.3e} (tolerance 1e-3); losses card {[round(m['loss'], 8) for m in runs['cuda'].metrics]} "
            f"cpu {[round(m['loss'], 8) for m in runs['cpu'].metrics]}; launches {got}")
        if got != want:
            raise RuntimeError(f"cli.train {model} fp32: launches {got} != {want}")
        if not (torch.isfinite(a).all() and rel <= 1e-3):
            raise RuntimeError(f"cli.train {model} fp32: card and CPU disagree")
        launches[f"train_f32_{model.replace('-', '_')}"] = got
        stats[f"train_{model}_rel_l2_vs_cpu"] = rel
    shutil.rmtree(out_dir, ignore_errors=True)
    return launches, stats


# ---- the window-dense kernels in f32 and int8 QK with an f32 v ---------------------------

# Gates, set before the first run: each kernel against its plain version on
# the same inputs (for the int8 modes the same int8 q / k), TF32 off, worst
# |err| / max(|plain|, RMS(plain)) <= TOL_F32_ATTN; each text-tail case's
# bracket (the plain version with the text bias dropped) at least
# F32_BRACKET times that.  Reduced-depth models card f32 vs CPU f32: Wan 2
# blocks routed at (4, 9, 10) rel L2 <= 1e-4; Wan 2 blocks and HunyuanVideo 1
# + 1 blocks with qk_int8 rel L2 <= TOL_INT8_F32_MODEL, looser because a
# 1e-7 difference upstream flips an int8 rounding at a half-way point (the
# flips are counted and printed); the tiny CLIs with --qk_int8 card vs
# --device cpu rel L2 <= 1e-3; every launch count exact.
TOL_INT8_F32_MODEL = 1e-3
# kernel -> (mode, the TPU kernel it replaces in that mode)
WINDOW_INT8_MODES = {"sta_window": ("f32", "vorta_tpu/ops/sta_window.py:596"),
                     "sta_row": ("f32", "vorta_tpu/ops/sta_row.py:352"),
                     "flash_manual": ("int8_f32", "vorta_tpu/ops/flash_manual.py:346"),
                     "sta_pipe": ("int8_f32", "vorta_tpu/ops/sta_pipe.py:597")}
# the f32 (4, 9, 10) serving grid: 720 x 1280 x 29 frames (--num_latent_t 8)
GRID_720P_29F = (8, 45, 80)


def int8_f32_bound(qk_ops: float, pv_flops: float, nbytes: float,
                   tensor_cores: bool = False) -> tuple:
    """The int8 QK mode with an f32 v: the QK products at the int8 tensor
    cores' 1,979 TOPS plus the PV products at 67 TFLOP/s f32 (FFMA), or with
    ``tensor_cores`` as three TF32 products at 495 TFLOP/s (3xTF32), or the
    bytes, whichever is longer."""
    pv_s = 3 * pv_flops / PEAK_TF32 if tensor_cores else pv_flops / PEAK_F32
    t_ops = (qk_ops / PEAK_INT8 + pv_s) * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def int8_one_tf32_pv(torch, q8, k8, v, kv_index, kv_count, *, qk_scale, scale, block_q,
                     block_kv, kv_valid_len=None, kv_bias=None, softmax="fast"):
    """flash_manual's plain int8 QK mode with an f32 v, its PV product taken
    as one TF32 product (P and V rounded once to TF32, then an f32 product):
    the bracket the kernel's 3xTF32 PV must beat.  For dense tables (each q
    block visits every kv block, or none: the served FULL, LOWRES and joint
    calls)."""
    from vorta_tpu_torch.ops.flash import _kv_column_limit
    from vorta_tpu_torch.ops.flash_manual import qk_factor

    if softmax != "fast":
        raise ValueError("the int8 mode is fast-only")
    b, h, sq, d = q8.shape
    skv = k8.shape[2]
    nkv = skv // block_kv
    ok = _kv_column_limit(skv, block_kv, skv if kv_valid_len is None else kv_valid_len,
                          q8.device)
    bias = 0.0 if kv_bias is None else kv_bias.reshape(skv).float()
    qkc = qk_factor(qk_scale, scale, h).to(q8.device)
    vt = tf32_rne(torch, v.float().contiguous())
    out = torch.zeros(v.shape[:2] + (sq, d), dtype=torch.float32, device=v.device)
    for hh in range(h):
        cnt = kv_count[hh if kv_count.shape[0] > 1 else 0].tolist()
        idx = kv_index[hh if kv_index.shape[0] > 1 else 0]
        kf = k8[:, hh].float()
        for i, c in enumerate(cnt):
            if c == 0:
                continue
            if c != nkv or sorted(idx[i, :c].tolist()) != list(range(nkv)):
                raise ValueError("int8_one_tf32_pv takes dense tables")
            rows = slice(i * block_q, (i + 1) * block_q)
            sc = (q8[:, hh, rows].float() @ kf.transpose(-1, -2)) * qkc[hh] + bias
            p = torch.where(ok, torch.exp2(sc), 0.0)
            l = p.sum(-1, keepdim=True)
            o = tf32_rne(torch, p) @ vt[:, hh]
            out[:, hh, rows] = torch.where(l == 0, 0.0, o / torch.where(l == 0, 1.0, l))
            del sc, p, o
    return out


def float_mask(torch, mask):
    """A boolean visibility mask as SDPA's float mask (0 or -inf), f32."""
    return torch.where(mask, 0.0, float("-inf"))


def check_f32_window_int8_kernels(torch, card: str) -> dict:
    """sta_window and sta_row in f32 (csrc/attn_f32.cuh over
    csrc/window_walk_f32.cuh) and the int8 QK modes of flash_manual and
    sta_pipe with an f32 v (dp4a scores) on the card, each against its plain
    version (gates above) at the shapes of their paths, D = 64, inactive
    heads and text tails of 24, 88 and 256 keys; times beside the plain
    version, f32 SDPA with TF32 off (the window or the text padding as a
    float mask) and, for the int8 modes, the f32 mode at the same call:
    {kernel: {shape: numbers}}."""
    import math

    import torch.nn.functional as F

    from vorta_tpu_torch.cli.sample import attention_config
    from vorta_tpu_torch.ops import joint_experts as joint
    from vorta_tpu_torch.ops.flash import dense_tables, f32_tc_path
    from vorta_tpu_torch.ops.flash_manual import (
        sparse_flash_attention_manual,
        sparse_flash_attention_manual_ffma,
        sparse_flash_attention_manual_ref,
    )
    from vorta_tpu_torch.ops.routed_fused import quantize_per_head, quantize_qk, routed_geometry
    from vorta_tpu_torch.ops.sta_pipe import (
        sta_f32_tc_path,
        sta_pipe_attention,
        sta_pipe_attention_ref,
    )
    from vorta_tpu_torch.ops.sta_row import sta_row_attention, sta_row_attention_ref
    from vorta_tpu_torch.ops.sta_window import (
        sta_window_attention,
        sta_window_attention_ffma,
        sta_window_attention_ref,
    )

    check_full_f32(torch)
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(21)
    out = {k: {} for k in WINDOW_INT8_MODES}

    def randn(*shape):  # unit RMS: the scale of qk-normed q / k
        return torch.randn(shape, generator=g, device=dev)

    def sdpa(q, k, v, mask=None, iters=2):
        return lambda: time_ms(torch, lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=mask), iters, 1)

    def text_bias(lt, valid):
        return torch.where(torch.arange(lt, device=dev) < valid, 0.0, -1e30)[None]

    def window_keys(grid, tile):
        return math.prod(min(3, grid[a] // tile[a]) * tile[a] for a in range(3))

    def window_lib(grid, tile, q, k, v, act, tk=None, tv=None, tb=None, window=(3, 3, 3)):
        """f32 SDPA over the active heads, the window (and the text keys'
        bias) as a float mask."""
        def run():
            n = q.shape[2]
            mask = float_mask(torch, sta_raster_mask(torch, grid, tile, dev, window))
            ka, va = k[:, act > 0], v[:, act > 0]
            if tk is not None:
                mask = torch.cat([mask, tb.reshape(1, -1).expand(n, -1)], dim=1)
                ka, va = torch.cat([ka, tk[:, act > 0]], dim=2), torch.cat([va, tv[:, act > 0]],
                                                                           dim=2)
            ms = sdpa(q[:, act > 0], ka, va, mask)()
            del mask, ka, va
            torch.cuda.empty_cache()
            return ms
        return run

    # ---- sta_window and sta_row in f32: the served (4, 9, 10) call at 720p x
    # 29f, 720p x 77f (the reference shape) and HunyuanVideo 45f + 256 text
    # keys (83 valid), sta_row at Wan 720p (5, 9, 8); D = 64 with 24 / 88 text
    # keys.  sta_window's D = 128 calls run on the tensor-core walk, timed in
    # turns with the FFMA core (the TF32 bracket gated at the served 720p x
    # 29f); sta_row's stay on the FFMA core
    act12 = torch.tensor(ACTIVE_HEADS, device=dev)
    hy_act = torch.tensor(HY_ACTIVE, device=dev)
    a3 = torch.tensor([1, 0, 1], device=dev)
    cases = (
        ("sta_window", "wan_720p_29f_4910", GRID_720P_29F, WAN_TILE_4910, act12, 128, 0, 0, 3),
        ("sta_window", "wan_720p_77f_4910", GRID_720P, WAN_TILE_4910, act12, 128, 0, 0, 2),
        ("sta_window", "hunyuan_45f_4910_text", GRID_HY_45F, WAN_TILE_4910, hy_act, 128, HY_TEXT,
         HY_VALID, 2),
        ("sta_window", "d64_4910_text24", (4, 9, 80), WAN_TILE_4910, a3, 64, 24, 19, 10),
        ("sta_row", "wan_720p_77f_598", GRID_720P, (5, 9, 8), act12, 128, 0, 0, 2),
        ("sta_row", "d64_238_text88", (4, 6, 32), (2, 3, 8), a3, 64, 88, 80, 10),
    )
    fns = {"sta_window": (sta_window_attention, sta_window_attention_ref),
           "sta_row": (sta_row_attention, sta_row_attention_ref)}

    def tf32(x):
        return None if x is None else tf32_rne(torch, x)

    for kernel, name, grid, tile, act, d, lt, valid, iters in cases:
        fn, plain = fns[kernel]
        h, n, n_act = act.numel(), math.prod(grid), int(act.sum().item())
        q, k, v = (randn(1, h, n, d) for _ in range(3))
        kw = dict(latent_shape=grid, tile=tile, window=(3, 3, 3), scale=d**-0.5)
        text = {}
        if lt:
            text = dict(text_k=randn(1, h, lt, d), text_v=randn(1, h, lt, d),
                        text_bias=text_bias(lt, valid))
        keys = window_keys(grid, tile) + valid
        r = out[kernel][name] = f32_case(
            torch, f"{kernel} f32 {name} (1,{h},{n},{d})"
            f"{f' + {lt} text ({valid} valid)' * bool(lt)}, tile {tile}, {n_act} of {h} heads",
            kernel,
            lambda: fn(q, k, v, act, **kw, **text), lambda: plain(q, k, v, act, **kw, **text),
            TOL_F32_ATTN, 4.0 * n * keys * d * n_act, (4 * n + 2 * lt) * d * 4 * n_act,
            iters=iters, zero_heads=act == 0,
            lib=window_lib(grid, tile, q, k, v, act, text.get("text_k"), text.get("text_v"),
                           text.get("text_bias")),
            bracket=(lambda: plain(q, k, v, act, **kw, **{**text, "text_bias": None})) if lt
            else None, bracket_min=F32_BRACKET * TOL_F32_ATTN,
            **(dict(ffma=lambda: sta_window_attention_ffma(q, k, v, act, **kw, **text),
                    tf32_bracket=lambda: plain(tf32(q), tf32(k), tf32(v), act, **kw, **{
                        **text, "text_k": tf32(text.get("text_k")),
                        "text_v": tf32(text.get("text_v"))}),
                    tf32_gate=name == "wan_720p_29f_4910")
               if kernel == "sta_window" and sta_f32_tc_path(d, grid, tile, text_len=lt)
               else {}))
        r["window_keys"] = window_keys(grid, tile)
        del q, k, v, text
        torch.cuda.empty_cache()

    # ---- flash_manual, int8 q / k with an f32 v: the routed FULL and LOWRES
    # calls at 480p x 77f (8 of 12 heads), HunyuanVideo's joint FULL layout with
    # kv_bias (8 of 24 heads: the routing-off arm's call), on the tensor cores
    # (csrc/attn_int8_tc.cuh; brackets: kv_bias dropped, the PV as one TF32
    # product) and timed in turns with the dp4a / FFMA mode at the same call; D 64
    # with 16-row blocks, a tail and a count-0 head on dp4a; each timed beside
    # the f32 mode (f32 q / k) and f32 SDPA
    cfg = attention_config("wan-1_3B", GRID_480P_77F)
    geo = routed_geometry(cfg)
    hcfg = attention_config("hunyuan-13B", GRID_HY_45F)
    lay = joint.joint_layouts(joint.JointConfig(hcfg, HY_TEXT))["full"]
    hy_bias = joint._bias(hy_text_mask(torch, dev), lay, hcfg.seq_len)
    hy8 = torch.tensor([int(i % 3 == 0) for i in range(24)], device=dev)
    manual_cases = (
        ("full_31200", 12, geo.full.q_pad, 128, geo.full.block_q, geo.full.block_kv,
         geo.full.valid_len, geo.full.tables, act12, None, 2),
        ("lowres_15600", 12, geo.lowres.q_pad, 128, geo.lowres.block_q, geo.lowres.block_kv,
         geo.lowres.valid_len, geo.lowres.tables, act12, None, 2),
        ("hunyuan_joint_full_kv_bias", 24, lay.total, 128, lay.block_q, lay.block_kv, None,
         dense_tables(lay.total // lay.block_q, lay.total // lay.block_kv), hy8, hy_bias, 2),
        ("d64_blocks16_tail_bias", 2, 64, 64, 16, 16, 60, dense_tables(4, 4),
         torch.tensor([1, 0], device=dev), text_bias(64, 55), 10),
    )
    for name, h, s, d, bq, bkv, valid, tables, act, bias, iters in manual_cases:
        qf, kf = randn(1, h, s, d), randn(1, h, s, d)
        q8, k8, qk_scale = quantize_qk(qf, kf)
        v = randn(1, h, s, d)
        ki, kc = tables.on(dev)
        cnt = torch.where(act[:, None] > 0, kc, 0).to(torch.int32)
        kw = dict(scale=d**-0.5, block_q=bq, block_kv=bkv, kv_valid_len=valid, kv_bias=bias,
                  softmax="fast")
        n_act = int(act.sum().item())
        n = valid or s
        vis = n if bias is None else int((bias > -1e29).sum().item())
        ops = 2.0 * n * vis * d * n_act
        nbytes = s * d * (2 + 8) * n_act
        tc = f32_tc_path(d, bq, bkv)  # the served shapes: the tensor-core int8 kernel
        r = out["flash_manual"][name] = f32_case(
            torch, f"flash_manual int8 q / k, f32 v {name} (1,{h},{s},{d}), {n_act} of {h} heads",
            "flash_manual", lambda: sparse_flash_attention_manual(
                q8, k8, v, ki, cnt, qk_scale=qk_scale, **kw),
            lambda: sparse_flash_attention_manual_ref(q8, k8, v, ki, cnt, qk_scale=qk_scale, **kw),
            TOL_F32_ATTN, 2 * ops, nbytes, also=("flash_manual_int8",),
            rows=slice(0, n), iters=iters, zero_heads=act == 0,
            bound=int8_f32_bound(ops, ops, nbytes),
            lib=sdpa(*(x[:, act > 0, :n] for x in (qf, kf, v)),
                     None if bias is None else bias[:, :n].reshape(1, 1, 1, n), 2),
            bracket=(lambda: sparse_flash_attention_manual_ref(
                q8, k8, v, ki, cnt, qk_scale=qk_scale, **{**kw, "kv_bias": None}))
            if bias is not None else None, bracket_min=F32_BRACKET * TOL_F32_ATTN,
            **(dict(ffma=lambda: sparse_flash_attention_manual_ffma(
                q8, k8, v, ki, cnt, qk_scale=qk_scale, **kw), tc_counter="flash_manual_int8_tc",
                tc_bound=int8_f32_bound(ops, ops, nbytes, tensor_cores=True),
                tf32_bracket=lambda: int8_one_tf32_pv(torch, q8, k8, v, ki, cnt,
                                                      qk_scale=qk_scale, **kw),
                tf32_gate=True) if tc else {}))
        r["f32_mode_ms"] = time_ms(torch, lambda: sparse_flash_attention_manual(
            qf, kf, v, ki, cnt, **kw), iters)
        r["f32_mode_core"] = "tensor_cores" if tc else "ffma"
        r["int8_over_f32_mode"] = r["ms"] / r["f32_mode_ms"]
        log(f"flash_manual int8 f32 {name} on {card}: {r['ms']:.3f} ms "
            f"({r.get('core', 'ffma')}; {r['tflops']:.1f} TFLOP/s, {r['bound_share']:.1%} of its "
            f"{r['bound_ms']:.3f} ms bound"
            + (f", {r['ffma_rated_bound_share']:.1%} of the FFMA-rated {r['ffma_bound_ms']:.3f}"
               f"; the dp4a / FFMA mode at the same call {r['ffma_ms']:.3f} ms" if tc else "")
            + f") against the f32 mode's {r['f32_mode_ms']:.3f} ms ({r['f32_mode_core']}, "
            f"{r['int8_over_f32_mode']:.3f}x) and f32 SDPA's {r['library_ms']:.3f} ms")
        del qf, kf, q8, k8, v
        torch.cuda.empty_cache()

    # ---- sta_pipe, int8 q / k / text keys with an f32 v: the routed STA call at
    # 480p x 77f (tile (4, 6, 4), 8 of 12 heads), a text tail (256 int8 text keys,
    # 83 valid) at the (6, 9, 8) tile, D 64 at wan-tiny's tile with 24 text keys
    pipe_cases = (
        ("480p_77f", GRID_480P_77F, (4, 6, 4), (3, 3, 3), act12, 128, 0, 0, 3),
        ("text_tail_698", (6, 9, 16), (6, 9, 8), (3, 3, 3), torch.tensor([1, 0, 1, 1],
                                                                           device=dev),
         128, HY_TEXT, HY_VALID, 5),
        ("d64_tile222_text24", (4, 4, 4), (2, 2, 2), (3, 3, 1), torch.tensor([1, 1],
                                                                              device=dev),
         64, 24, 21, 10),
    )
    for name, grid, tile, window, act, d, lt, valid, iters in pipe_cases:
        h, n, n_act = act.numel(), math.prod(grid), int(act.sum().item())
        qf, kf = randn(1, h, n, d), randn(1, h, n, d)
        q8, k8, qk_scale = quantize_qk(qf, kf)
        v = randn(1, h, n, d)
        kw = dict(latent_shape=grid, tile=tile, window=window, scale=d**-0.5)
        text, text_f32 = {}, {}
        if lt:
            tk = randn(1, h, lt, d)
            text = dict(text_k=quantize_per_head(tk)[0], text_v=randn(1, h, lt, d),
                        text_bias=text_bias(lt, valid))
            text_f32 = {**text, "text_k": tk}
        keys = math.prod(min(window[a], grid[a] // tile[a]) * tile[a] for a in range(3)) + valid
        ops = 2.0 * n * keys * d * n_act
        nbytes = (n * d * (2 + 8) + lt * d * 5) * n_act
        r = out["sta_pipe"][name] = f32_case(
            torch, f"sta_pipe int8 q / k, f32 v {name} (1,{h},{n},{d})"
            f"{f' + {lt} int8 text' * bool(lt)}, tile {tile}", "sta_pipe",
            lambda: sta_pipe_attention(q8, k8, v, act, qk_scale=qk_scale, **kw, **text),
            lambda: sta_pipe_attention_ref(q8, k8, v, act, qk_scale=qk_scale, **kw, **text),
            TOL_F32_ATTN, 2 * ops, nbytes, also=("sta_pipe_int8",), iters=iters,
            zero_heads=act == 0, bound=int8_f32_bound(ops, ops, nbytes),
            lib=window_lib(grid, tile, qf, kf, v, act, text_f32.get("text_k"),
                           text_f32.get("text_v"), text_f32.get("text_bias"), window),
            bracket=(lambda: sta_pipe_attention_ref(q8, k8, v, act, qk_scale=qk_scale, **kw,
                                                    **{**text, "text_bias": None}))
            if lt else None, bracket_min=F32_BRACKET * TOL_F32_ATTN)
        r["f32_mode_ms"] = time_ms(torch, lambda: sta_pipe_attention(qf, kf, v, act, **kw,
                                                                      **text_f32), iters)
        r["int8_over_f32_mode"] = r["ms"] / r["f32_mode_ms"]
        del qf, kf, q8, k8, v, text, text_f32
        torch.cuda.empty_cache()
    return out


def int8_flips(a: list, b: list) -> dict:
    """The int8 values two runs' per-head quantizations (lists of int8
    tensors, call by call) give differently: their count, of how many, and
    the largest difference (a flip at a half-way point moves a value by 1)."""
    if len(a) != len(b) or any(x.shape != y.shape for x, y in zip(a, b)):
        raise RuntimeError(f"int8 quantizations differ in number or shape: {len(a)} / {len(b)}")
    diff = [(x.int() - y.int()).abs() for x, y in zip(a, b)]
    return {"flipped": int(sum((d > 0).sum().item() for d in diff)),
            "of": int(sum(d.numel() for d in diff)),
            "max_step": int(max((d.max().item() for d in diff), default=0))}


def recorded_quantize(record: list):
    """A with-block in which every per-head int8 quantization (the routed
    dispatch's and the joint experts', through ops/routed_fused.py) appends
    its int8 output, on the host, to ``record``."""
    from unittest import mock

    from vorta_tpu_torch.ops import routed_fused

    real = routed_fused.quantize_per_head

    def quantize(x):
        x8, s = real(x)
        record.append(x8.cpu())
        return x8, s

    return mock.patch.object(routed_fused, "quantize_per_head", quantize)


def check_f32_window_int8_models(torch) -> dict:
    """Reduced-depth forwards in f32, card against the CPU from the same
    weights: Wan 2 blocks at 1.3B widths routed hard at tile (4, 9, 10) on a
    (4, 18, 80) grid (the STA heads on sta_window's f32 mode) and with
    qk_int8 at (8, 24, 20) (FULL and LOWRES on flash_manual's int8 mode with
    an f32 v), HunyuanVideo 1 + 1 blocks at 13B widths with qk_int8 routed
    hard and routing off; 4 / 8 heads per expert by one-hot routers; gates
    above, the int8 flips counted; launches exact."""
    import dataclasses

    import numpy as np

    from vorta_tpu_torch.cli.sample import attention_config
    from vorta_tpu_torch.config import WAN_1_3B, AttentionConfig
    from vorta_tpu_torch.models.hunyuan import HUNYUAN_13B, HunyuanModel
    from vorta_tpu_torch.models.wan import WanModel
    from vorta_tpu_torch.ops import _build
    from vorta_tpu_torch.ops.routed_fused import routed_sta_kernel

    check_full_f32(torch)
    out = {}

    def gate(name, got, want, launches, expected, tol, flips=None):
        if launches != expected:
            raise RuntimeError(f"f32 model check {name}: launches {launches} != {expected}")
        if got.dtype != torch.float32 or not torch.isfinite(got).all():
            raise RuntimeError(f"f32 model check {name}: output {got.dtype}, non-finite")
        rel = ((got - want).norm() / want.norm()).item()
        log(f"f32 model check {name}: rel L2 card f32 vs CPU f32 = {rel:.3e} (tolerance "
            f"{tol:g}); launches exact"
            + ("" if flips is None else f"; int8 values flipped card vs CPU: {flips}"))
        if not rel <= tol:
            raise RuntimeError(f"f32 model check {name}: the card's forward disagrees")
        out[name] = {"rel_l2": rel, **({} if flips is None else {"int8_flips": flips})}

    cfg = dataclasses.replace(WAN_1_3B, num_layers=2)
    experts = torch.tensor([0, 1, 2] * 4)
    cpu = WanModel(cfg, dtype=torch.float32, device="cpu", seed=5)
    with torch.no_grad():
        for block in cpu.blocks:
            block.router.linear.weight.zero_()
            block.router.linear.bias.copy_(4.0 * torch.eye(3)[experts].reshape(-1))
    gpu = WanModel(cfg, dtype=torch.float32, device="cuda", seed=5)
    gpu.load_state_dict(cpu.state_dict())
    for name, grid, tile, int8 in (("wan_routed_4x18x80_4910", (4, 18, 80), WAN_TILE_4910, False),
                                   ("wan_routed_8x24x20_qk_int8", (8, 24, 20), (4, 6, 4), True)):
        attn = AttentionConfig(latent_shape=grid, sta_tile=tile, sta_window=(3, 3, 3),
                               lowres_window=(2, 3, 2), qk_int8=int8)
        sta_kernel = routed_sta_kernel(attn, 128, 4)
        if sta_kernel != ("sta_pipe" if int8 else "sta_window"):
            raise RuntimeError(f"f32 model check {name}: the STA heads take {sta_kernel}")
        g = torch.Generator().manual_seed(6)
        lat = torch.randn((1, grid[0], 2 * grid[1], 2 * grid[2], 16), generator=g)
        ctx = torch.randn((1, TEXT_LEN, cfg.text_dim), generator=g)
        t = torch.tensor([700.0])
        rec = {"cpu": [], "cuda": []}
        with recorded_quantize(rec["cpu"]):
            want = cpu(lat, t, ctx, attn_cfg=attn, routing_mode="hard").sample
        _build.reset_launches()
        with recorded_quantize(rec["cuda"]):
            res = gpu(lat.cuda(), t.cuda(), ctx.cuda(), attn_cfg=attn, routing_mode="hard")
        got = res.sample.cpu()
        if not (res.expert_ids == experts.numpy()).all():
            raise RuntimeError(f"f32 model check {name}: routing {res.expert_ids}")
        expected = routed_wan_launches(np.asarray(res.expert_ids)[None], sta_kernel, 1,
                                       int8=int8)
        gate(name, got, want, dict(_build.launches), f32_launches(expected, True),
             TOL_INT8_F32_MODEL if int8 else 1e-4,
             int8_flips(rec["cuda"], rec["cpu"]) if int8 else None)
    del cpu, gpu

    hcfg = dataclasses.replace(HUNYUAN_13B, dual_layers=1, single_layers=1)
    grid = (6, 9, 16)
    attn = dataclasses.replace(attention_config("hunyuan-13B", grid), qk_int8=True)
    hexperts = torch.tensor([0, 1, 2] * 8)
    gpu = HunyuanModel(hcfg, dtype=torch.float32, device="cuda", seed=3)
    for block in gpu.blocks:
        block.router.linear.weight.zero_()
        block.router.linear.bias.copy_(4.0 * torch.eye(3, device="cuda")[hexperts].reshape(-1))
    cpu = HunyuanModel(hcfg, dtype=torch.float32, device="meta").to_empty(device="cpu")
    cpu.load_state_dict(gpu.state_dict())
    lat, text, mask, pooled = hy_inputs(torch, grid, torch.device("cuda"), 9)
    args = (lat, torch.tensor([700.0], device="cuda"), text, mask, pooled)
    gd = torch.tensor([6000.0], device="cuda")
    for mode in ("hard", "off"):
        rec = {"cpu": [], "cuda": []}
        with recorded_quantize(rec["cpu"]):
            want = cpu(*(x.cpu() for x in args), guidance=gd.cpu(), attn_cfg=attn,
                       routing_mode=mode).sample
        _build.reset_launches()
        with recorded_quantize(rec["cuda"]):
            res = gpu(*args, guidance=gd, attn_cfg=attn, routing_mode=mode)
        if mode == "hard":
            if not (res.expert_ids == hexperts.numpy()).all():
                raise RuntimeError(f"f32 model check hunyuan: routing {res.expert_ids}")
            expected = hy_hard_launches(np.asarray(res.expert_ids)[None], int8=True, dual=1)
        else:
            expected = {**dict.fromkeys(_build.KERNELS, 0), "flash_manual": 2,
                        "flash_manual_wgmma": 2, "flash_manual_int8": 2, "prologue": 2,
                        "prologue_rows": 2, "fused_norm": 4 + 1 + 1}
        gate(f"hunyuan_{mode}_6x9x16_qk_int8", res.sample.cpu(), want, dict(_build.launches),
             f32_launches(expected, True), TOL_INT8_F32_MODEL,
             int8_flips(rec["cuda"], rec["cpu"]))
    del cpu, gpu
    return out


def run_f32_window_int8_serving(torch, card: str):
    """The two f32 configurations the JAX CLI runs and the port refused on the
    card until now, through cli.sample at Wan-1.3B full width and depth (30
    blocks, routed hard by random routers), one UniPC step x CFG each, after
    a warm-up forward of a 2-block f32 model: --dtype fp32 --resume_dir at
    tile (4, 9, 10) from the config.json ``cli.train --sta_tile 4 9 10``
    writes, at 720p x 29f (8, 45, 80) (cut from 77 frames for the smoke's
    time; the STA heads on sta_window's f32 mode, sta_pipe never), and
    --dtype fp32 --qk_int8 at 480p x 77f (flash_manual only in its int8 mode
    with an f32 v); s per step and peak GiB.  Then wan-tiny, hunyuan-tiny
    and hunyuan-tiny --native_attention (the routing-off arm) through
    cli.sample --dtype fp32 --qk_int8, 2 steps, card against --device cpu
    from the same host-drawn weights, noise and embeddings: final latents
    rel L2 <= 1e-3, routing equal.  Every launch count exact."""
    import dataclasses

    import numpy as np

    from vorta_tpu_torch.cli import sample
    from vorta_tpu_torch.cli.sample import attention_config
    from vorta_tpu_torch.cli.train import attention_config as train_attention_config
    from vorta_tpu_torch.cli.train import parse_args as train_args
    from vorta_tpu_torch.config import WAN_1_3B, WAN_TINY
    from vorta_tpu_torch.models.hunyuan import HUNYUAN_TINY
    from vorta_tpu_torch.models.wan import WanModel
    from vorta_tpu_torch.ops import _build

    check_full_f32(torch)
    res_dir = HERE / "results" / "port_smoke" / "f32_window_int8"  # listed in .gitignore
    res_dir.mkdir(parents=True, exist_ok=True)
    run_dir = res_dir / "wan_720p_29f_4910"
    attn_4910 = train_attention_config(train_args([
        "--synthetic_data", "--output_dir", str(run_dir), "--num_latent_t",
        str(GRID_720P_29F[0]), "--video_height", "720", "--video_width", "1280", "--sta_tile",
        *map(str, WAN_TILE_4910)]))
    if attn_4910.latent_shape != GRID_720P_29F:
        raise RuntimeError(f"trainer geometry {attn_4910.latent_shape}")
    run_dir.mkdir(parents=True, exist_ok=True)
    attn_4910.save(run_dir / "config.json")  # the file the trainer writes
    launches, stats = {}, {}
    for name, grid, attn, argv, sta_kernel, int8 in (
            ("f32_hard_720p_29f_4910", GRID_720P_29F, attn_4910,
             ["--num_frames", "29", "--height", "720", "--width", "1280", "--resume_dir",
              str(run_dir)], "sta_window", False),
            ("f32_hard_480p_77f_qk_int8", GRID_480P_77F, dataclasses.replace(
                attention_config("wan-1_3B", GRID_480P_77F), qk_int8=True),
             ["--num_frames", "77", "--height", "480", "--width", "832", "--qk_int8"],
             "sta_pipe", True)):
        warm = WanModel(dataclasses.replace(WAN_1_3B, num_layers=2), dtype=torch.float32,
                        device="cuda", seed=1)
        warm(torch.randn((1, grid[0], 2 * grid[1], 2 * grid[2], 16), device="cuda"),
             torch.tensor([900.0], device="cuda"), torch.randn((1, TEXT_LEN, 4096), device="cuda"),
             attn_cfg=attn, routing_mode="hard")
        del warm
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        _build.reset_launches()
        res = sample.main(["--model", "wan-1_3B", "--dtype", "fp32", "--random_embeds",
                           "--num_inference_steps", "1", "--seed", "0",
                           "--output", str(res_dir / f"{name}.npy"), *argv])
        peak = torch.cuda.max_memory_allocated() / 2**30
        launches[name] = got = dict(_build.launches)
        tables = np.stack(res.routing)
        want = f32_launches(routed_wan_launches(tables, sta_kernel, 2, int8=int8), True)
        lat = res.latents
        shape = (1, grid[0], 2 * grid[1], 2 * grid[2], 16)
        if (got != want or tuple(lat.shape) != shape or lat.dtype != torch.float32
                or not torch.isfinite(lat).all()):
            raise RuntimeError(f"{name}: launches {got} != {want}, or output "
                               f"{tuple(lat.shape)} {lat.dtype} non-finite")
        if int8 and not (got["flash_manual"] == got["flash_manual_f32"] == got["flash_manual_int8"]
                         == got["flash_manual_int8_tc"] > 0):
            raise RuntimeError(f"{name}: a flash_manual launch outside the int8 f32 mode on the "
                               "tensor cores")
        sta_blocks = int((tables == 2).any(-1).sum())  # blocks with STA heads, over the forwards
        if not int8 and (got["sta_pipe"] or got["sta_window_f32"] != sta_blocks):
            raise RuntimeError(f"{name}: sta_window_f32 {got['sta_window_f32']} is not one "
                               "launch per block with STA heads, or sta_pipe ran")
        heads = np.bincount(tables.reshape(-1), minlength=3)
        stats[name] = {"s_per_step": res.denoise_s / res.steps, "forwards": 2,
                       "build_s": res.build_s, "peak_gib": peak,
                       "heads_per_expert": heads.tolist()}
        log(f"cli.sample --dtype fp32 Wan-1.3B {name}: {stats[name]['s_per_step']:.3f} s per "
            f"UniPC step x CFG (2 forwards), peak {peak:.2f} GiB, on {card}; heads per expert "
            f"{heads.tolist()}; launches exact {got}")
        del res, lat
        torch.cuda.empty_cache()

    for model, cfg, size, extra in (
            ("wan-tiny", WAN_TINY, ["--num_frames", "13", "--height", "64", "--width", "64"], []),
            ("hunyuan-tiny", HUNYUAN_TINY, ["--num_frames", "13", "--height", "96", "--width",
                                            "256"], []),
            ("hunyuan-tiny", HUNYUAN_TINY, ["--num_frames", "13", "--height", "96", "--width",
                                            "256"], ["--native_attention"])):
        emb = tiny_embeds(cfg, res_dir / f"{model}_embeds.npy", 7)
        tag = f"{model}{'_off' if extra else ''}"
        base = ["--model", model, "--dtype", "fp32", "--qk_int8", "--prompt_embeds", emb,
                "--num_inference_steps", "2", "--seed", "0", *size, *extra]
        runs = {}
        for dev in ("cuda", "cpu"):
            _build.reset_launches()
            with host_drawn(torch, sample):
                runs[dev] = sample.main(base + ["--device", dev, "--output",
                                                str(res_dir / f"{tag}_{dev}.npy")])
            if dev == "cuda":
                got = dict(_build.launches)
        res = runs["cuda"]
        if extra:  # routing off: one flash_manual a block, all in the int8 mode
            blocks, dual = cfg.dual_layers + cfg.single_layers, cfg.dual_layers
            want = {**dict.fromkeys(_build.KERNELS, 0), "flash_manual": 2 * blocks,
                    "flash_manual_int8": 2 * blocks, "prologue": 2 * blocks,
                    "fused_norm": 2 * (4 * dual + blocks - dual + 1)}
        else:
            tables = np.stack(res.routing)
            want = (hy_hard_launches(tables, int8=True, sta_kernel="sta_batched",
                                     dual=cfg.dual_layers) if model.startswith("hunyuan") else
                    routed_wan_launches(tables, "sta_pipe", tables.shape[0], int8=True))
        want = f32_launches(want, False)
        if got != want or not got["flash_manual_int8"]:
            raise RuntimeError(f"cli.sample {tag} fp32 --qk_int8: launches {got} != {want}")
        if not all(np.array_equal(a, b) for a, b in zip(runs["cuda"].routing,
                                                         runs["cpu"].routing)):
            raise RuntimeError(f"cli.sample {tag} fp32 --qk_int8: the card routes otherwise")
        a, b = runs["cuda"].latents.cpu(), runs["cpu"].latents
        rel = ((a - b).norm() / b.norm()).item()
        log(f"cli.sample {tag} --dtype fp32 --qk_int8, 2 steps: card vs --device cpu final "
            f"latents rel L2 {rel:.3e} (tolerance 1e-3); routing equal; launches exact {got}")
        if not (torch.isfinite(a).all() and rel <= 1e-3):
            raise RuntimeError(f"cli.sample {tag} fp32 --qk_int8: card and CPU disagree")
        launches[f"f32_qk_int8_sample_{tag.replace('-', '_')}"] = got
        stats[f"sample_{tag}_qk_int8"] = {"rel_l2_vs_cpu": rel,
                                          "s_per_step": res.denoise_s / res.steps}
    return launches, stats


if __name__ == "__main__":
    sys.exit(main())
