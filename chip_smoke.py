#!/usr/bin/env python3
"""Drive the PyTorch port of INDM on one CUDA card and check it.

  python3 chip_smoke.py

Run from the root of a checkout; it needs one card and nothing but the
checkout. Phases (any failure exits non-zero before the result lines):

1. print the card's name and power limit; build the kernels from
   `indm_torch/csrc/` (`build/kernels/`), one nvcc per source, in parallel,
   and beside them print `nvcc -Xptxas -v`'s registers, shared memory and
   spills of the Lipschitz net's three GEMMs (`lipnet_gemm.cu`) and of its
   narrow convs, conv_in and conv_out (`narrow_conv.cu`).
2. hold the GroupNorm(+swish) kernel against its plain version at every
   distinct (shape, activation) that the full-width NCSN++ launches at
   batch 64, in float32 and bfloat16, and time it beside its bound, the
   plain version and `torch.nn.functional.group_norm` (+ `silu`): three
   ways (`timed`: CUDA events around the calls, host and device; a CUDA
   graph, the device alone; the host's enqueue alone), the library call
   by events and in a graph, each shape's share of its bound by the
   graph's time.
3. one full-width score evaluation at batch 64, through the kernel and
   through the plain version, compared; then one more under
   `torch.profiler`: device time by kernel and the device's busy share.
4. one full-width ODE sampling round of `vp/CIFAR10/indm_nll` at batch 64
   (`model.fused_groupnorm=True`) through `indm_torch.sample.run`: output
   shape and finiteness, function evaluations, seconds, images/s, and the
   kernel launches of the round against 95 per score evaluation.
5. a small-input reference: at the tiny geometry of the CPU tests (which
   hold the CPU path against the JAX package), the card (through the
   kernel) against the CPU (the plain version), same weights and noise:
   the score function at several t, the flow inverse, and one ODE round.
5b. the upfirdn2d kernel (kernel 9) against its plain version at every
   distinct (shape, up, down, pad) that the full-width VE NCSN++
   (`ve/CIFAR10/indm`) launches at batch 64 (15 calls per evaluation),
   timed as phase 2 times kernel 1, beside its bytes bound, the plain
   version and one grouped `F.conv2d` (`F.conv_transpose2d` for up = 2).
5c. one full-width VE score evaluation at batch 64 (`model.init_scale=1.0`,
   `model.fused_groupnorm=True`) through kernels 1 and 9 and through their
   plain versions, compared; then one more under `torch.profiler`.
5d. one full-width PC round of `ve/CIFAR10/indm` at batch 64 through
   `indm_torch.sample.run` (VE_NUM_SCALES scales, one Langevin step and
   one reverse-diffusion step each): shape, finiteness, the score
   evaluations made, upfirdn2d launches exactly 15 and GroupNorm launches
   exactly 95 per evaluation, seconds, images/s, seconds per PC step.
5e. the VE small-input reference: at the tiny VE geometry of the CPU tests,
   card against CPU with the same weights and noise: the score function at
   several t and a PC round of VE_SMALL_SCALES scales.
6. the Neumann-chain kernel against its plain version at both full-width
   flow scales (batch 128; 3 channels at 32x32 and 12 at 16x16, width
   512), pre-activated and not, n in {0, 2, 6}, timed beside its
   operations bound, the plain version and the same chain through
   `F.conv2d`; at each scale one call (pre-activated, n = 2) under
   `torch.profiler`: the device time per term of each of its three
   launches (conv_in, the `wgmma` GEMM, conv_out), each term's product one
   `wgmma_3xtf32_kernel` launch and no other GEMM (the libraries' counts).
6b. the fully fused chain (kernel 8) against its plain version at both
   full-width scales, pre-activated and not, with hp and without, n in
   {0, 2, 6}, its products n + 3 `wgmma_3xtf32_kernel` launches and no
   other GEMM, timed beside its operations bound and the plain version;
   for the same (exact) diagonals kernel 7's bits; a term's device time by
   launch as in phase 6; then against `chain_mats` and kernel 7 on the
   same `IResBlock` (h of width 64), the route it replaces, both timed.
6c. the narrow-channel conv (kernel 10) through its benchmark,
   `indm_torch.scripts.bench_narrow_conv` (batch 128, 3 <-> 512 at
   32x32): the script's own bfloat16 run, then float32; each kernel case
   against the plain case and `F.conv2d` (1e-2 of the largest value in
   bfloat16, 1e-4 in float32), timed beside its bound; then conv_in
   alone through narrow_in at both chain scales (batch 128, 3 -> 512 at
   32x32 and 12 -> 512 at 16x16) in float32 and bfloat16, and narrow_out
   in float32 at scale 1, against the same two (float32 conv_in also
   within GEMM_RTOL of the float64 convolution), timed beside the bound
   and `F.conv2d` in the same type, also in a CUDA graph (`graph_ms`).
6d. the Lipschitz net's GEMMs alone (3xTF32 on the tensor cores) through
   their entry points in `indm_torch.ops.lipnet_gemm`: `gemm_3xtf32_kernel`
   (`mma.sync`; the 512-wide products of the float32 backwards, kernels 4
   and 6) at the main path's four products, and the `wgmma` GEMM
   (`wgmma_3xtf32_kernel`; kernels 3, 5, 7 and 8) at its two, beside
   `gemm_3xtf32_kernel` on the same inputs (batch 128): within 1e-5 of the
   float64 product's largest value (the `wgmma` GEMM also no further from
   it than `torch.bmm`), timed beside the bound, the plain version and one
   float32 `torch.bmm`; and the chain's product W1^T t1 on the `wgmma`
   GEMM at both scales (K = 512, N = 1024 and 256) against float64, as
   strictly.
7. the GroupNorm backward kernel against its plain version at the 13
   (shape, activation) pairs of the score net at batch 128, float32 and
   bfloat16, timed as phase 2 times kernel 1, beside its bytes bound, the
   plain version and the autograd backward of `F.group_norm` (+ `F.silu`;
   in a CUDA graph its aten calls).
8. the fused iResBlock pair (forward with the chain and J^T u; analytic
   backward) against its plain versions at both full-width flow scales,
   batch 128, pre-activated and not, n in {0, 2, 6}, timed beside its
   operations bound and the plain versions; at each scale one forward
   (pre-activated, n = 2) under `torch.profiler`: its 512-wide products
   all `wgmma_3xtf32_kernel` launches (n + 4) and none of
   `gemm_3xtf32_kernel`, and a chain term's device time by launch
   (conv_in, the `wgmma` GEMM, conv_out); the same block through the
   chain route of `IResBlock` (chain kernel and one VJP; recompute and
   double backward) and through its fused route.
9. three joint training steps (`step_nll`) of `vp/CIFAR10/indm_nll` at full
   width and batch 128 through `indm_torch.run_lib`, with the config's own
   init and dropout: finite losses, losses = score + flow + logp, both
   nets and the encoder's BatchNorm statistics changed, launches per step
   (GroupNorm forward 95, backward 95, chain 32, fused pair 0), and
   `wgmma_3xtf32_kernel` exactly the sum of n + 2 over the blocks, no
   other GEMM; seconds per step, images/s, peak memory; unprofiled (a
   depth cut that makes room for phase 16; its profile stands in PERF.md).
9c. the same steps with INDM_FUSED_CHAIN=1: launches per step GroupNorm
   95 and 95, fused chain 32, chain 0, the `wgmma` GEMM the sum of n + 2
   and 32 more; kernel 8's time per step at the n drawn, beside its bound,
   its plain version and chain_mats with kernel 7; unprofiled (a depth cut
   that makes room for phase 15; its profile stands in PERF.md).
9b. the fused-stack pair (kernels 5 and 6) against its plain versions at
   both full-width stacks (15 blocks of 3 channels at 32x32, 16 of 12 at
   16x16; batch 128, width 512, hp, n from a seeded Poisson(2)), against
   kernels 3 and 4 looped over the same blocks (the same bits), timed with
   CUDA events around the whole call beside its operations bound, the plain
   versions, the same calls through `FusedStackFn`, and kernels 3 and 4
   looped through `FusedBlockFn`; one forward call under `torch.profiler`
   (its `wgmma` launches, sum of n + 4 over the blocks, none of
   `gemm_3xtf32_kernel`; a chain term's device time by launch).
10. the same steps with `flow.fused_block=True` and INDM_FUSED_STACK=0:
   launches per step GroupNorm 95 and 95, fused forward 32, fused backward
   32, chain 0; the profile must show no convolution of the flow's 512-wide
   layers (the double backward's weight-gradient convolutions are gone),
   and lists the two GEMMs' launches apart: `wgmma_3xtf32_kernel` exactly
   the forwards' sum of n + 4 over the 32 blocks, `gemm_3xtf32_kernel`
   exactly the backwards' 5 a block (the float32 chain routes: no
   `gemm_3xtf32_kernel`).
10b. the same with `flow.fused_block=True` and the switch unset, the
   default fused route: launches per step GroupNorm 95 and 95, fused pair
   1 and 1 (the flow's first block), stack 2 and 2, chain 0, no 512-wide
   flow convolution, and the loss means of the INDM_FUSED_STACK=0 route;
   unprofiled (a depth cut that makes room for phase 16). Phase 10 also
   runs one step with host timers around the step function, the flow's
   forward and the flow's kernel wrappers.
11. a small-input reference for training, in four configurations (the
   chain route, the chain route with INDM_FUSED_CHAIN=1, and the two fused
   routes): one step's losses and gradients at the tiny geometry (width 64
   for kernel 8 and the fused routes, nblocks 3-2 for the stack route),
   card against CPU, same weights and noise, with each route's launches;
   and three in bfloat16, bench.py's flags (nblocks 3-2, width 64) and its
   chain-route flags at width 64 with and without INDM_FUSED_CHAIN=1:
   every loss term within 1e-4 of its largest value, each net's gradients
   no further from the CPU's than a tenth of the CPU's float32 step is
   (the chain-route steps: the latent z, then, with the card's score half
   on the CPU's z, losses and gradients within half of the CPU's
   float32-bfloat16 difference, CHAIN_STEP_GAP_SHARE); the card's float32
   step must fail those limits.
6e. the bfloat16 mode's GEMM alone (`wgmma_bf16_kernel`: `wgmma` with
   both bfloat16 operands through TMA, float32 sums) at its six products
   of the main path (batch 128): within 1e-5 of the float64 product of the
   same values' largest value, timed beside its bound (one pass at the
   dense bfloat16 rate), the plain version and one bfloat16 `torch.bmm`,
   each by CUDA events around the calls and in a CUDA graph (`graph_ms`:
   the wrapper's Python left out); per shape and summed, with TFLOP/s.
8b. kernels 3 and 4 in bfloat16 against their plain bfloat16 versions
   computed in float64 (every rounding point kept, every other sum exact),
   as phase 8 (both scales, pre-activated and not, n in {0, 2, 6}): each
   output within 2e-2 of the float32 version's largest value and nearer
   the plain bfloat16 version than half of the float32 one's distance,
   timed beside the bound and the plain version; the forward's products
   all `wgmma_bf16_kernel` launches (n + 4).
9d. kernels 5 and 6 in bfloat16, as phase 9b, against their plain bfloat16
   versions in float64 (8b's tolerance; the forward block by block on the
   kernel's own carry, as the backward's references take it) and against
   kernels 3 and 4 in bfloat16 looped (the same bits), timed beside the
   bound and the plain versions.
10c. the slice: three steps of the JAX package's benchmark configuration
   (bench.py:56-80: `flow.fused_block`, `flow.logdet_bf16`,
   `flow.mixed_precision`, `model.mixed_precision`, `model.fast_dropout`,
   `model.fused_groupnorm=False`) at full width and batch 128, as phase 9
   checks them: launches per step GroupNorm 0 and 0, fused pair 1 and 1,
   stack 2 and 2, and the bfloat16 GEMM exactly the forwards' n + 4 and
   the backwards' 5 a block (no other GEMM); seconds per step, images/s
   and peak memory beside phase 10b's float32 fused step in this run;
   unprofiled (a depth cut for phase 15).
6f. kernel 7 in bfloat16 (every input bfloat16, acc float32) against its
   plain bfloat16 version on float64 inputs (check_bf16_chain), as phase 6
   (both scales, pre-activated and not, n in {0, 2, 6}); each term's
   product one `wgmma_bf16_kernel` launch and no other GEMM (the libraries'
   counts, and the profiler at n = 2); timed beside its bound (all its
   work as one bfloat16 pass), the plain version and the same
   series through bfloat16 `F.conv2d`.
6g. kernel 8 in bfloat16, as phase 6b, against its plain bfloat16 version
   on float64 inputs, with hp and without, n + 3 `wgmma_bf16_kernel`
   launches a call; then on one `IResBlock` against bfloat16 `chain_mats`
   and kernel 7, the two nearer each other in root mean square than the
   farther is to the float32 route (their diagonals differ) for each of
   CHAIN8_DRAWS seeded eps draws, the smallest margin logged beside the
   largest element's, both timed.
10d. the slice: three steps of bench.py's chain-route flags (10c's flags
   with `flow.fused_block=False`) at full width and batch 128, checked as
   phase 9: launches per step GroupNorm 0 and 0, the bfloat16 chain 32,
   the float32 chain 0, pair 0, stack 0, and `wgmma_bf16_kernel` exactly
   the sum of n + 2 over the blocks, no other GEMM; seconds per step,
   images/s and peak memory beside phase 9's float32 chain route; then the
   same with INDM_FUSED_CHAIN=1 (kernel 8 in bfloat16 32, the GEMM sum of
   n + 2 and 32 more), beside phase 9c.
11b. checkpoints and bits/dim: at full width on the chain route (kernels
   1, 2 and 7) at batch 128, one step of `run_lib.train_steps` written
   to a work directory under `build/`, a fresh `Training` built from it
   and held equal to the saved state bit for bit (every parameter, moment,
   count, EMA shadow, BatchNorm buffer, generator and the batches' place),
   one more step, its four losses within 1e-5 of a straight two-step run
   in the same process (whether the bits are equal is reported), the two
   files' sizes and the save and restore seconds; then `run_lib.evaluate`
   on that checkpoint (no sampling): the NELBO and "NLL correct" sections
   (RK45 at 1e-3) on the synthetic test split's first EVAL_BATCH images,
   finite bits/dim,
   NFE, seconds, seconds per function evaluation and images/s, and the
   NLL section's launches exactly 95 x (NFE + 1) of kernel 1 and 95 x NFE
   of kernel 2 (the NELBO's 190 and 95); one NLL function evaluation timed
   and profiled, the flow's evaluation estimator timed; and at the tiny
   width the card against the CPU with the same weights and draws: the
   ODE's bits/dim within 1e-4 at equal NFE and the NELBO within 1e-5.
11c. the FID variant, `vp/CIFAR10/indm_fid` on the chain route it ships:
   three `step_fid` steps at full width and batch 128 through
   `run_lib.train_steps`, each step's device time split into its two
   phases by CUDA events, launches per step kernel 1 190 and kernel 2 190
   (95 in each phase), kernel 7 32 (phase 1 only), the `wgmma` GEMM the sum
   of n + 2 over the blocks and no other GEMM, peak memory, finite losses,
   both nets and the encoder's statistics moved, the meta pair written;
   one tiny `step_fid` step card against CPU (phase 11's limits, phase 2's
   draws replayed, the CPU's updated flow carried to the card); on phase
   4's 64 images `clean_resize` and InceptionV3's features, card against
   CPU (1e-4), with ms an image for each; then `run_lib.evaluate` on the
   checkpoint (no bits/dim, one round of 64): FID, IS and N with the seeded
   Inception weights ("random"), kernel 1's launches 95 x (NFE + 1), the
   seconds of SciPy's sqrtm on the host beside Newton-Schulz's FID and
   seconds on the card.
12a. kernel 9's backward (`Upfirdn2dFn`: the kernel on the adjoint, the
   taps flipped, up and down swapped, StyleGAN2's adjoint pads) at every
   distinct FIR call of the full-width VE net at batch 128, against
   autograd of the plain version on float64 inputs (FIR_RTOL), one
   forward and one backward launch a call; timed as phase 5b times the
   forward, beside its bytes bound, autograd of the plain version and the
   library's backward (aten's convolution_backward of row 9's grouped
   conv), summed over a training step's 15 launches.
12b. VE training from CIFAR-10 on disk: seeded files in CIFAR-10's own
   python layout under `build/`, then `run_lib.train` on
   `ve/CIFAR10/indm` at full width (nf 128, ch_mult (1, 2, 2, 2), 4 res
   blocks, the 16-16 flow at width 512) and batch 128, three steps with
   both log lines a step: each step's launches exactly kernel 1 and 2 95,
   kernel 7 32, kernel 9 15 forward and 15 backward; finite losses that
   sum, both nets and the encoder's statistics moved, the meta checkpoint;
   seconds a step, images/s, peak memory. Then one tiny VE step, card
   against CPU as phase 11, kernel 9 launched as often backward as forward.
12c. `python -m indm_torch.main` on those files ($INDM_DATA_DIR) at full
   width and batch 128: `--mode train` for two steps and a resume for one
   more, through its entry in this process (both log lines each step, the
   checkpoints' steps), then `--mode eval` with `eval.data_mean` in a
   child process: bits/dim on one test batch of 16
   (RK45 at 1e-3), the latent mean over one training batch, one PC round
   of 64 images at VE_MAIN_SCALES scales, its FID line.
13. CelebA at 64x64 (`vp/CELEBA/*`, `ve/CELEBA/indm`; the flow squeezed to
   32x32x12 and 16x16x48): 13a kernel 7 alone at batch 128 at 12 channels
   on 32x32 and 48 on 16x16 against the plain version on float64 inputs,
   beside its bound, the plain version and the `F.conv2d` chain, with
   conv_in's and conv_out's registers and spills; 13b kernels 1 and 2 at
   the 64x64 net's 95 GroupNorm calls and kernel 9 at the 64x64 VE net's
   15 calls, both ways; 13c three `vp/CELEBA/indm_nll` steps at batch 128
   (kernels 1 and 2 95, kernel 7 32 a step; unprofiled, a depth cut for
   phase 15) and one ODE round of
   CELEBA_SAMPLE_BATCH; 13d one `step_fid` step; 13e `indm_torch.main
   --config ve/CELEBA/indm` on seeded PNGs in CelebA's 178 x 218 geometry
   (CELEBA_IMAGES: one training and one test batch; decoded without PIL):
   two steps (kernel 9 15 each way a step), then `--mode eval` (bits/dim,
   a PC round at CELEBA_MAIN_SCALES scales, FID against the training
   folder's statistics).
14. bench.py's flags (BENCH_TRAIN) on the VE and CelebA configs: 14a at
   batch 128 and width 512, kernels 3-6 at CelebA's first flow scale (12
   channels on 32x32, the backward's padded planes past 48 KB of shared
   memory) in float32 and bfloat16, kernel 7 in bfloat16 at 48 channels on
   16x16 and 12 on 32x32, kernel 8 at 12 on 32x32 in both types, each
   against its plain version and timed (events, a CUDA graph) beside its
   bound, with kernel 7's bfloat16 convs' registers and spills; 14b three
   `vp/CELEBA/indm_nll` steps under BENCH_TRAIN (exact launches a step;
   unprofiled, a depth cut for phase 15); 14c one step each on the
   bfloat16 chain route, with INDM_FUSED_CHAIN=1 and on the float32 fused
   route; 14d two steps each
   of `ve/CELEBA/indm` and `ve/CIFAR10/indm` under BENCH_TRAIN (kernel 9
   15 times each way a step) and a PC round of the mixed-precision VE
   net; 14e the tiny CelebA steps under the flags, card against CPU, at
   two seeds (a gradient exact in bfloat16 may differ by one bfloat16
   step where that step exceeds the limit).
15. the score side: 15a at the tiny geometries of phases 5 and 5e, card
   against CPU with the same weights and draws, the four SDEs' methods
   (SCORE_SIDE_SDE_RTOL), one PC round (SCORE_SIDE_STEPS steps, no flow)
   for every (predictor, corrector) pair that the JAX package runs on each
   SDE, one Euler-Maruyama VP round to the config's t = 1e-5 (its limit
   from the round's move under one ulp of expf, measured on the CPU), the
   denoise search and the extra steps resumed from a cached state (1e-4,
   as phase 5e), and a score-only step, continuous and DDPM (phase 11's
   limits); 15b at full width and batch 64 with kernel 1 on, PC
   rounds of `vp/CIFAR10/indm_nll` (Euler-Maruyama at 50 scales without a
   corrector, and with the Langevin corrector at 25), 15c the same under
   the subVP and GeometricVP SDEs at 20: seconds a step, images/s, kernel
   1's launches exactly 95 per score evaluation counted on the host; 15d
   `python -m indm_torch.sample`'s entry point on `ve/CIFAR10/indm`: a
   plain round at 10 scales, the denoise search resumed from its
   step-(N-2) file (one evaluation; the suffixed files and PNG grid, read
   back), the extra steps resumed at batch 16 (kernels 1 and 9 95 and 15
   an evaluation); 15e score-only training (`flow.model=identity`) at
   batch 128: three `vp/CIFAR10/indm_nll` steps, one with two
   micro-batches under Adam, one `ve/CIFAR10/indm` step (kernels 1 and 2
   95 each way a micro-batch, kernel 9 15 forward and 14 backward: the
   data needs no gradient).
16. the flow side at full width and batch 128 (`phase_flow_side`): 16a
   the bare resflow (`flow.model=resflow`, unconditioned) with
   `flow.actnorm`, three steps on the chain route (kernel 7 32 a step)
   and three with `flow.fused_block` (kernels 3 and 4 on every block, 32
   and 32, no stack across an actnorm), one without actnorm on the fused
   route (the first block's pair, kernels 5 and 6 once a scale with no
   h-projection); 16b the Glow preset `cifar10/glow/glow-gaussian-uni`:
   three joint steps, a PC round of 20 scales through its sampling
   direction, x -> z -> x within ROUNDTRIP_ATOL; 16c one
   `cifar10/macow/macow-base-uni` step (its encoding the autoregressive
   inverse) and a PC round of `macow-cat-uni` with h from the categorical
   prior; 16d `optim.num_micro_batch=2` in `step_nll` and `step_fid` (the
   kernels launched once a chunk); 16e kernel 7 alone at CIFAR-10's
   squeezed scales, 12x16x16 and 48x8x8, against float64 and timed at
   n = 6 in a CUDA graph beside its bound, then one step of
   `resflow-gaussian-uni-squeeze` with `flow.squeeze`. Each path's tiny
   step runs on the card and the CPU (phase 11's limits; the wolf
   generators' shrunk presets, their flow term also allowed twice the
   CPU's own float32 error against float64; 16d at two chunks of 4, the
   summed gradients and the carried BatchNorm statistics).
17. the other score nets (`phase_other_nets`) at full width,
   `flow.model=identity`, `model.fused_groupnorm=True`, through
   `run_lib.train_steps` and `indm_torch.sample`'s entry: 17a DDPM on
   CIFAR-10 (three score-only steps at batch 128, an evaluation at batch
   64, an Euler-Maruyama PC round of 20 scales), 17b NCSN++ with DDPM++
   blocks (an evaluation and a step at batch 128), 17c the 256-pixel VE
   NCSN++ (FIR, both pyramids; an evaluation and a step at batch 8), 17d
   NCSNv2 on CIFAR-10 (two SMLD steps at batch 128, an annealed-Langevin
   round of 10 of 232 scales; `ncsnv2_128` and `ncsnv2_256` at 128 and 256
   pixels, `ncsn`), 17e VDM on gamma(t) labels and its auxiliary state
   saved and restored bit for bit. Launches of kernels 1, 2 and 9 derived
   from each net and held exactly; each evaluation through the kernels
   against the plain versions (SCORE_RTOL); each distinct kernel call held
   against its plain version and timed in a CUDA graph beside its bound;
   seconds a step, images/s, peak memory; the tiny nets card against CPU
   (SMALL_RTOL).
18. a JSON line of the ported kernels (with the launches of kernels 1 and
   2 in the NLL section, of kernels 1, 2 and 7 in a FID step, of kernel 9
   both ways in phase 12b's steps, each one's CelebA numbers under
   "celeba", phase 14's under "bench_flags", phase 15's under
   "launches_score_side", phase 16's under "launches_flow_side",
   kernel 7's 16e calls under "cifar_squeezed", phase 17's under
   "launches_other_nets" and "other_nets_per_eval") and the phases'
   results (phase 11b's under "eval", 11c's under "fid", 12's under
   "ve_train", 13's under "celeba", 14's steps under "bench_flags", 15's
   under "score_side", 16's under "flow_side", 17's under "other_nets"),
   the whole run's seconds, the
   card's name and power limit and, last, `{"ok": true, ...}`.

Bounds of kernels 3-8 and the GEMMs count the 1x1 products and conv_in as
three TF32 passes on the tensor cores and conv_out at float32 FMA, or, in
bfloat16, all of the work as one bfloat16 pass (the note at TF32_FLOPS);
each training phase's profiled step counts both GEMMs' launches inside the
flow kernels.

Sampling weights are random, drawn from the config's seed, with
`model.init_scale = 1.0`: at the VP default of 0 the last conv of each
block starts near 1e-10 and the score net is nearly a chain of skips.
Training starts from the config's own init. TF32 is off for convolutions
and matmuls (f32 numerics, as in JAX).
"""

import collections
import contextlib
import copy
import dataclasses
import json
import math
import os
import shutil
import subprocess
import sys
import time
import traceback

import torch

BATCH = 64
HBM_BYTES_PER_S = 3.35e12  # H100 SXM
F32_FLOPS = 67e12          # H100 SXM, float32 outside the tensor cores
TF32_FLOPS = 495e12        # H100 SXM, dense TF32 on the tensor cores
# The bound of a flow kernel (kernels 3-8) and of the GEMM alone: the larger
# of its operations and its bytes (each input read once, each output
# written once) / HBM_BYTES_PER_S. Operations: 3 x (conv_in + GEMM FLOPs) /
# TF32_FLOPS (the C -> I convs and the 1x1 products run as three TF32
# passes on the tensor cores, 3xTF32) + the other narrow FLOPs (conv_out,
# the narrow weight gradients) / F32_FLOPS; in bfloat16, where every
# operand is bfloat16, all of them at BF16_FLOPS.
# The "SIMT bound", all FLOPs / F32_FLOPS, is kept beside it: it was the
# bound while the GEMM ran on float32 FMA, and keeps the rows comparable.
# arithmetic per element of the kernel: two sums (4), normalise (3),
# swish (about 4)
OPS_PER_ELEMENT = 11
GN_PER_SCORE_EVAL = 95     # 88 in the 44 res blocks, 6 attention, 1 output
TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
SCORE_RTOL = 1e-4
# the tiny geometry of tests/test_golden.py, as the CPU tests run it
SMALL = {"data.image_size": 8, "model.nf": 8, "model.num_res_blocks": 1,
         "model.ch_mult": (1, 1), "model.attn_resolutions": (4,),
         "flow.nblocks": "2-2", "flow.intermediate_dim": 8,
         "eval.rtol": 1e-3, "eval.atol": 1e-3}
SMALL_BATCH = 4
# card vs CPU on the small input. float32 convs and sums in another order:
# 1e-5 relative. At t = 1e-3 the std of the VP marginal is
# sqrt(1 - exp(-1.1e-4)) in float32 (as the JAX package computes it), which
# keeps about 3 digits, and the card's expf may differ from the CPU's by an
# ulp: 1e-3 there. The ODE round: two adaptive solves at rtol = 1e-3 whose
# step sequences may differ on that account; 1e-2 of the largest value.
SMALL_RTOL = 1e-5
SMALL_RTOL_T_EPS = 1e-3
SMALL_ROUND_RTOL = 1e-2
# the VE sampling slice: upfirdn2d launches per score evaluation (two in
# each of the 3 BigGAN down and 3 up blocks, one on each of the 3 levels of
# the residual input pyramid); the PC round's scales, cut from the
# config's 1000 to keep the whole run under 900 s once phases 12 and 13
# came (400 with phase 12, 50 with 13, 25 with 16; each scale is the same
# two evaluations); kernel 9 against its plain version:
# float32 sums of 16 taps in another order, 1e-5 of the output's largest
# value
VE_FIR_PER_EVAL = 15
VE_NUM_SCALES = 25
FIR_RTOL = 1e-5
# the tiny VE geometry of tests/test_torch_ve.py, and its PC round's scales
VE_SMALL = {"data.image_size": 16, "model.nf": 16, "model.num_res_blocks": 1,
            "model.ch_mult": (1, 2), "model.attn_resolutions": (8,),
            "flow.nblocks": "2-2", "flow.intermediate_dim": 8,
            "model.num_scales": 6, "sampling.num_scales": 6}
VE_SMALL_SCALES = VE_SMALL["sampling.num_scales"]
# card vs CPU for the tiny VE round: six fixed steps, no adaptive solver;
# 1e-4 of the largest value, as the CPU test holds the port against JAX
VE_SMALL_ROUND_RTOL = 1e-4
TRAIN_BATCH = 128
TRAIN_STEPS = 3
# launches per training step: the score net's GroupNorms forward and
# backward, and one chain per iResBlock (16 + 16); with flow.fused_block
# one fused forward and one fused backward per iResBlock instead
# (INDM_FUSED_STACK=0); by default the flow's first block through the fused
# pair and each scale's stack of pre-activated blocks (15 and 16) through
# one stack call per direction
PER_STEP = {"group_norm_fwd": 95, "group_norm_bwd": 95, "neumann_chain": 32,
            "fused_neumann_chain": 0, "neumann_chain_bf16": 0,
            "fused_neumann_chain_bf16": 0, "fused_block_fwd": 0,
            "fused_block_bwd": 0, "fused_stack_fwd": 0, "fused_stack_bwd": 0,
            "upfirdn2d": 0, "upfirdn2d_bwd": 0}
# the chain route under INDM_FUSED_CHAIN=1: every block's chain through the
# fully fused chain (kernel 8)
PER_STEP_CHAIN8 = {**PER_STEP, "neumann_chain": 0, "fused_neumann_chain": 32}
PER_STEP_FUSED = {**PER_STEP, "neumann_chain": 0, "fused_block_fwd": 32,
                  "fused_block_bwd": 32}
PER_STEP_STACK = {**PER_STEP, "neumann_chain": 0, "fused_block_fwd": 1,
                  "fused_block_bwd": 1, "fused_stack_fwd": 2,
                  "fused_stack_bwd": 2}
FUSED_TRAIN = {"flow.fused_block": True}
# the tiny step of the chain route with INDM_FUSED_CHAIN=1: kernel 8 needs
# a width of 33 or more, as the fused kernels do
CHAIN8_SMALL = {"flow.intermediate_dim": 64}
# the tiny fused step: the fused kernels need a width of 33 or more; "3-2"
# gives both scales a stack of two blocks
FUSED_SMALL = {"flow.fused_block": True, "flow.intermediate_dim": 64}
STACK_SMALL = {**FUSED_SMALL, "flow.nblocks": "3-2"}
# the stacks of the two full-width scales: (blocks, channels, height = width)
STACK_SCALES = ((15, 3, 32), (16, 12, 16))
# the slice of this port: the JAX package's own benchmark configuration
# (bench.py:56-80), kernels 3-6 in their bfloat16 mode and the score net in
# mixed precision, GroupNorm without the kernel. One training step launches
# the fused pair for the flow's first block, one stack call per scale and
# direction, and no GroupNorm kernel; the tiny step has a stack of two at
# both scales (nblocks 3-2, width 64)
BENCH_TRAIN = {"flow.fused_block": True, "flow.logdet_bf16": True,
               "flow.mixed_precision": True, "model.mixed_precision": True,
               "model.fast_dropout": True, "model.fused_groupnorm": False}
PER_STEP_BENCH = {**PER_STEP_STACK, "group_norm_fwd": 0, "group_norm_bwd": 0}
BENCH_SMALL = {**BENCH_TRAIN, "flow.intermediate_dim": 64,
               "flow.nblocks": "3-2"}
BENCH_SMALL_F32 = {**BENCH_SMALL, "flow.logdet_bf16": False,
                   "flow.mixed_precision": False,
                   "model.mixed_precision": False}
# this slice: the JAX benchmark's chain route (bench.py:56-67 with
# BENCH_FUSED_BLOCK=0), kernels 7 and 8 in their bfloat16 mode: every
# block's chain in bfloat16 through kernel 7 (or kernel 8 under
# INDM_FUSED_CHAIN=1), no GroupNorm kernel, no fused pair or stack; the
# tiny steps at width 64 (kernel 8 needs 33 or more)
CHAIN_BF16_TRAIN = {**BENCH_TRAIN, "flow.fused_block": False}
PER_STEP_CHAIN_BF16 = {**PER_STEP, "group_norm_fwd": 0, "group_norm_bwd": 0,
                       "neumann_chain": 0, "neumann_chain_bf16": 32}
PER_STEP_CHAIN8_BF16 = {**PER_STEP_CHAIN_BF16, "neumann_chain_bf16": 0,
                        "fused_neumann_chain_bf16": 32}
CHAIN_BF16_SMALL = {**CHAIN_BF16_TRAIN, "flow.intermediate_dim": 64}
CHAIN_BF16_SMALL_F32 = {**CHAIN_BF16_SMALL, "flow.logdet_bf16": False,
                        "flow.mixed_precision": False,
                        "model.mixed_precision": False}
# the bfloat16 mode against its plain versions: within 2e-2 of the float32
# output's largest value (the JAX package's bfloat16 bound,
# tests/test_models.py:61) and nearer the plain bfloat16 version than half
# of the float32 one's distance to it (check_bf16_outputs)
BF16_RTOL = 2e-2
# the tiny bfloat16 step, card against CPU (phase 11): the losses within
# 1e-4 of their largest value, each net's largest gradient error within a
# tenth of the largest difference between the CPU's float32 and bfloat16
# steps; the card's float32 step must fail these limits (the control)
BF16_STEP_LOSS_RTOL = 1e-4
BF16_STEP_GAP_SHARE = 0.1
# the tiny chain-route steps under bench.py's flags: there g's output is
# rounded to bfloat16 (JAX's `LipschitzNNet.apply`), so one rounding that
# cuDNN's and the CPU's bfloat16 convs take apart moves z (by 6.1e-5 of a
# largest 0.98 on the training batch's first draw), and where that crosses
# a rounding boundary of the score net in bfloat16 one example's score
# loss jumps by about half a bfloat16 step (0.04 of 19.05, the other
# examples within 2e-6), as large as the whole float32-bfloat16 gap
# (PERF.md, PR 18). So the card's z is held within half of the CPU's
# float32-bfloat16 gap of z, and the card's score half then takes the
# CPU's z by value (its gradient still through the card's flow): the
# losses and each net's gradients within half of the CPU's
# float32-bfloat16 gap, which the card's float32 step (on its own z) must
# miss
CHAIN_STEP_GAP_SHARE = 0.5
# the bfloat16 GEMM alone (phase 6e): the main path's products in that mode
# at batch 128, (M, N, K, bt, pairs, shared weight): W1 or W1^T on
# activations at scale 0 and 1, W1^T on z2b as its two bfloat16 parts, the
# w1 gradient over three pairs (z2b's two parts and the tangent's)
BF16_GEMM_SHAPES = ((512, 1024, 512, False, 1, True),
                    (512, 256, 512, False, 1, True),
                    (512, 1024, 512, False, 2, True),
                    (512, 256, 512, False, 2, True),
                    (512, 512, 1024, True, 3, False),
                    (512, 512, 256, True, 3, False))
# the loss means of the stack route against INDM_FUSED_STACK=0's: every
# block computes the same bits, but the stack sums its log-dets before
# subtracting them (`fused_stack_apply`), the block route one at a time
STACK_LOSS_RTOL = 1e-6
# the fused pair against its plain versions: float32 sums in another order
# (the weight gradients over up to 131 072 rows), each output within 1e-4
# of its largest value
FUSED_RTOL = 1e-4
FUSED_COND = 64   # the width of h, the wolf prior's dimension
# GroupNorm backward against its plain version: float32 sums in another
# order, 1e-4 of the largest value; bf16 dx is rounded once (2e-2), the
# parameter gradients are float32 sums of the same inputs (1e-3).
GN_BWD_TOL = {torch.float32: (1e-4, 1e-4, 1e-4),
              torch.bfloat16: (2e-2, 1e-3, 1e-3)}
# the chain against its plain version: float32 sums in another order over
# up to 4608 products a term, 1e-4 of the largest value
CHAIN_RTOL = 1e-4
CHAIN_NS = (0, 2, 6)
CHAIN8_DRAWS = 8  # eps draws of phase 6g's route comparison
# the flow's scales at full width: (channels, height = width)
CHAIN_SCALES = ((3, 32), (12, 16))
CHAIN_WIDTH = 512
# the profiled chain call of phase 6 (n = 2: four terms), and the names of
# a term's three launches in the profile
SPLIT_N = 2
# the GEMM alone (phase 6d): the main path's four products at batch 128,
# (M, N, K, bt, pairs, shared weight): mat_wide at scale 0 and 1 (the
# weight shared), the w1 gradient over two pairs at scale 0 and 1 (K =
# H*W); within 1e-5 of the float64 product's largest value (the float32
# contract: one TF32 product misses it, tests/test_torch_lipnet_gemm.py)
GEMM_SHAPES = ((512, 1024, 512, False, 1, True),
               (512, 256, 512, False, 1, True),
               (512, 512, 1024, True, 2, False),
               (512, 512, 256, True, 2, False))
GEMM_RTOL = 1e-5
# the `wgmma` GEMM of every float32 product with a weight fixed for the call
# (the forwards of kernels 3 and 5, the chains of kernels 7 and 8, kernel
# 8's layer 1): its two products at batch 128 (phase 6d), (M, N, K): W1 or
# W1^T on a sample's activations at scale 0 and 1; the `gemm_3xtf32_kernel`
# launches of one block's backward (kernel 4's sequence: the primal and
# tangent products, the w1 gradient, the two W1^T products)
WGMMA_SHAPES = ((512, 1024, 512), (512, 256, 512))
WGMMA_KERNEL = "wgmma_3xtf32_kernel"
SPLIT_KERNELS = ("conv_in_kernel", WGMMA_KERNEL, "conv_out_kernel")
BF16_SPLIT_KERNELS = ("conv_in_kernel", "wgmma_bf16_kernel", "conv_out_kernel")
# the bfloat16 mode's GEMM (kernels 3-6 under flow.logdet_bf16 or
# flow.mixed_precision), and each GEMM's kernel by the name its launch
# count has in `lipnet_gemm.device_gemm_launches`
GEMM_BF16_KERNEL = "wgmma_bf16_kernel"
GEMM_KERNELS = {"gemm_3xtf32": "gemm_3xtf32_kernel", "wgmma": WGMMA_KERNEL,
                "gemm_bf16": GEMM_BF16_KERNEL}
BWD_GEMMS_PER_BLOCK = 5
# ptxas's report names no dynamic shared memory: each GEMM's
GEMM_SMEM = {"gemm_3xtf32_kernel": "163840 bytes, lipnet::kGSmem",
             GEMM_BF16_KERNEL: "201792 bytes, lipnet::kXSmem; 168 registers "
                               "at launch, 232 a consumer thread by "
                               "setmaxnreg",
             "conv_in_kernel": "lipnet::InTile<C, T>::kSmem: 212992 bytes "
                               "(C = 12) and 90112 (C = 3) in float32, "
                               "96256 (two weight tiles) and 50176 in "
                               "bfloat16",
             WGMMA_KERNEL: "218160 bytes, lipnet::kWSmem; 168 registers at "
                           "launch, 232 a consumer thread by setmaxnreg"}
# kernel 10 against its plain version and F.conv2d: float32 sums in another
# order, 1e-4 of the largest value; in bfloat16 each rounds a float32 sum
# once, one bfloat16 step apart at most: 1e-2 of it
NARROW_RTOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}
BF16_FLOPS = 989e12        # H100 SXM, dense bf16 on the tensor cores
# card vs CPU, one tiny training step with the same weights, noise and
# diffusion times: the losses to 1e-5 of their largest value (float32 sums
# in another order through both nets, the kernels against their plain
# versions); each gradient tensor to 1e-4 of its largest value floored at
# 1e-4 of its net's largest gradient (the attention's key biases have
# gradients of about 1e-9 that are zero in exact arithmetic).
# The diffusion times t and the weight Z come from the CPU: the JAX
# package's float32 formula, log(1 - exp(-ib(t_min))) with ib(t_min) about
# 1e-6, keeps about one digit, so one ulp of expf moves Z by 0.2 % and a
# small t by up to 10 % (measured on the H100, PERF.md).
TRAIN_SMALL_RTOL = 1e-5
TRAIN_SMALL_GRAD_RTOL = 1e-4
TRAIN_SMALL_GRAD_FLOOR = 1e-4
REPO = os.path.dirname(os.path.abspath(__file__))


def log(*a):
  print(*a, flush=True)


def cuda_ms(fn, iters=20, warmup=3):
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


_WARMUP_STREAM = []


def graph_ms(fn, iters=20, reps=3):
  """fn()'s device time a call without the host's: `iters` calls captured
  in one CUDA graph (after three on a side stream to warm up), replayed
  `reps` times between CUDA events after one replay. cuda_ms counts the
  host's time between launches too, which bounds it where a wrapper's
  Python takes longer than its kernel. One side stream for every call,
  and cuBLAS's workspaces dropped after: cuBLAS keeps one allocated for
  each stream it has run on, which would count in the training phases'
  peak memory."""
  if not _WARMUP_STREAM:
    _WARMUP_STREAM.append(torch.cuda.Stream())
  side = _WARMUP_STREAM[0]
  side.wait_stream(torch.cuda.current_stream())
  with torch.cuda.stream(side):
    for _ in range(3):
      fn()
  torch.cuda.current_stream().wait_stream(side)
  graph = torch.cuda.CUDAGraph()
  with torch.cuda.graph(graph):
    for _ in range(iters):
      fn()
  graph.replay()
  torch.cuda.synchronize()
  start = torch.cuda.Event(enable_timing=True)
  end = torch.cuda.Event(enable_timing=True)
  start.record()
  for _ in range(reps):
    graph.replay()
  end.record()
  torch.cuda.synchronize()
  del graph
  torch._C._cuda_clearCublasWorkspaces()
  return start.elapsed_time(end) / (reps * iters)


def host_ms(fn, reps=3):
  """The host's time to return from fn() with the device idle before it
  (no synchronise after it), the least of `reps`: what enqueuing the call
  costs the host while the launch queue has room."""
  best = math.inf
  for _ in range(reps):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    best = min(best, time.perf_counter() - t0)
  torch.cuda.synchronize()
  return best * 1e3


def timed(fn, library=None):
  """fn() timed three ways: `ms` by cuda_ms (the host's time between
  launches counts where it exceeds the kernel's), `graph_ms` (the device
  alone) and `host_ms` (the enqueue alone); with `library`, the same
  function's PyTorch call by cuda_ms and in a graph."""
  out = {"ms": cuda_ms(fn), "graph_ms": graph_ms(fn), "host_ms": host_ms(fn)}
  if library is not None:
    out["library_ms"] = cuda_ms(library)
    out["library_graph_ms"] = graph_ms(library)
  return out


def smoke_config():
  from indm_torch.configs import get_config
  cfg = get_config("vp/CIFAR10/indm_nll")
  cfg.model.fused_groupnorm = True
  cfg.model.init_scale = 1.0
  cfg.sampling.batch_size = BATCH
  return cfg


def ve_config():
  from indm_torch.configs import get_config
  cfg = get_config("ve/CIFAR10/indm")
  cfg.model.fused_groupnorm = True
  cfg.model.init_scale = 1.0
  cfg.sampling.batch_size = BATCH
  cfg.sampling.num_scales = VE_NUM_SCALES
  return cfg


def set_leaves(cfg, leaves):
  """A copy of cfg with dotted leaves replaced."""
  cfg = copy.deepcopy(cfg)
  for name, value in leaves.items():
    *path, leaf = name.split(".")
    node = cfg
    for part in path:
      node = node[part]
    node[leaf] = value
  return cfg


def phase_card_and_build():
  smi = subprocess.run(["nvidia-smi", "-i", "0",
                        "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, check=True).stdout.strip()
  log(smi)
  from concurrent.futures import ThreadPoolExecutor

  from indm_torch.ops import build
  t0 = time.perf_counter()
  reported = ("lipnet_gemm.cu", "narrow_conv.cu", "neumann_chain.cu")
  with ThreadPoolExecutor(len(reported)) as pool:  # ptxas beside the build
    reports = [pool.submit(build.ptxas_report, src) for src in reported]
    paths = build.build_all()
    reports = [r.result() for r in reports]
  log(f"built {', '.join(os.path.relpath(p, REPO) for p in paths)} in "
      f"{time.perf_counter() - t0:.3f} s")
  # the GEMMs', narrow_conv.cu's convs' and kernel 7's convs' registers,
  # shared memory and spills, one line per kernel; kernel 7's are returned
  # for its CelebA rows (phases 13a and 14a)
  chain_convs = {}
  for src, report in zip(reported, reports):
    kernel = None
    for line in report.splitlines():
      if "Compiling entry function" in line:
        kernel = line.split("'")[1]
      elif kernel and ("registers" in line or "spill" in line):
        if src == "neumann_chain.cu":
          if "conv_" not in kernel:
            continue
          chain_convs.setdefault(kernel, []).append(line.strip())
        smem = [v for k, v in GEMM_SMEM.items() if k in kernel]
        log(f"ptxas -v {src} {kernel}: {line.strip()}"
            + (f" (dynamic shared memory: {smem[0]})" if smem else ""))
  return smi, chain_convs


def group_norm_shapes(model, x, t):
  """(shape, groups, act) -> launches in one forward, from hooks."""
  from indm_torch.models.layers import GroupNorm
  seen = collections.Counter()
  hooks = [m.register_forward_pre_hook(
      lambda mod, args: seen.update([(tuple(args[0].shape), mod.num_groups,
                                      mod.act)]))
           for m in model.modules() if isinstance(m, GroupNorm)]
  try:
    with torch.no_grad():
      model(x, t)
    torch.cuda.synchronize()
  finally:
    for h in hooks:
      h.remove()
  return seen


def phase_group_norm(model, x, t, dtypes=(torch.float32, torch.bfloat16)):
  """Kernel 1 against its plain version at each distinct (shape, act) of
  the score net in each of `dtypes`, timed by `timed` beside its bound,
  the plain version and the library call; returns the float32
  per-evaluation sums, the largest float32 error, the shapes and the rows
  by shape and type."""
  import torch.nn.functional as F
  from indm_torch.ops import group_norm as gn
  shapes = group_norm_shapes(model, x, t)
  n_calls = sum(shapes.values())
  log(f"GroupNorm calls per score evaluation: {n_calls} "
      f"({len(shapes)} distinct shape/act)")
  if n_calls != GN_PER_SCORE_EVAL:
    raise AssertionError(f"expected {GN_PER_SCORE_EVAL} GroupNorm calls, "
                         f"got {n_calls}")
  gen = torch.Generator(device="cuda").manual_seed(0)
  per_eval = {dtype: collections.defaultdict(float) for dtype in dtypes}
  max_err = {dtype: 0.0 for dtype in dtypes}
  by_shape = []
  for (shape, groups, act), count in sorted(shapes.items()):
    c = shape[1]
    scale = 1.0 + 0.2 * torch.randn(c, device="cuda", generator=gen)
    bias = 0.2 * torch.randn(c, device="cuda", generator=gen)
    for dtype in dtypes:
      xs = (0.5 + 1.5 * torch.randn(shape, device="cuda",
                                    generator=gen)).to(dtype)
      y = gn.group_norm_act(xs, scale, bias, groups, act=act)
      y_plain = gn.group_norm_act_plain(xs, scale, bias, groups, act=act)
      torch.cuda.synchronize()
      err = (y.float() - y_plain.float()).abs().max().item()
      tol = TOL[dtype]
      bad = ((y.float() - y_plain.float()).abs()
             > tol + tol * y_plain.float().abs()).any().item()
      if bad or not math.isfinite(err):
        raise AssertionError(f"group_norm {shape} {dtype} {act}: max abs "
                             f"err {err} over tolerance {tol}")
      max_err[dtype] = max(max_err[dtype], err)

      def library():
        out = F.group_norm(xs, groups, scale.to(dtype), bias.to(dtype), 1e-6)
        return F.silu(out) if act == "swish" else out

      times = timed(lambda: gn.group_norm_act(xs, scale, bias, groups,
                                              act=act), library)
      times["plain_ms"] = cuda_ms(lambda: gn.group_norm_act_plain(
          xs, scale, bias, groups, act=act))
      nbytes = 2 * xs.numel() * xs.element_size()
      times["bound_ms"] = max(nbytes / HBM_BYTES_PER_S,
                              OPS_PER_ELEMENT * xs.numel() / F32_FLOPS) * 1e3
      dname = str(dtype).replace("torch.", "")
      log(f"group_norm {list(shape)} groups={groups} act={act} {dname} "
          f"x{count}/eval: max_abs_err={err:.3e} "
          + " ".join(f"{k}={v:.5f}" for k, v in times.items())
          + f" ({times['bound_ms'] / times['graph_ms']:.3f} of the bound "
          "by graph_ms)")
      by_shape.append({"shape": list(shape), "groups": groups, "act": act,
                       "dtype": dname, "count": count, "max_abs_err": err,
                       **times})
      for key, v in times.items():
        per_eval[dtype][key] += count * v
  for dtype, sums in per_eval.items():
    log(f"group_norm per score evaluation ({dtype}, {n_calls} launches): "
        + " ".join(f"{k}={v:.5f}" for k, v in sums.items())
        + f" ({sums['bound_ms'] / sums['graph_ms']:.3f} of the bound by "
        "graph_ms)")
  log("group_norm max_abs_err " + " ".join(
      f"{str(k).replace('torch.', '')}={v:.3e}" for k, v in max_err.items()))
  return (dict(per_eval[torch.float32]), max_err[torch.float32], shapes,
          by_shape)


@contextlib.contextmanager
def plain_group_norm():
  """Route the score net's GroupNorm through the plain version."""
  from indm_torch.ops import group_norm as gn
  kernel = gn.group_norm_act
  gn.group_norm_act = gn.group_norm_act_plain
  try:
    yield
  finally:
    gn.group_norm_act = kernel


def phase_score(cfg, model, x, t):
  from indm_torch import sde as sde_lib
  from indm_torch.models.registry import get_score_fn
  from indm_torch.ops import group_norm as gn
  score_fn = get_score_fn(cfg, sde_lib.get_sde(cfg), model)
  gn.reset_launches()
  s_kernel = score_fn(x, t)
  torch.cuda.synchronize()
  launches = gn.launches
  with plain_group_norm():
    s_plain = score_fn(x, t)
    torch.cuda.synchronize()
    plain_eval_ms = cuda_ms(lambda: score_fn(x, t), iters=3, warmup=1)
  if gn.launches != launches:
    raise AssertionError("the plain run launched the kernel")
  if launches != GN_PER_SCORE_EVAL:
    raise AssertionError(f"score evaluation launched {launches} kernels")
  kernel_eval_ms = cuda_ms(lambda: score_fn(x, t), iters=3, warmup=1)
  ref = s_plain.abs().max().item()
  rel = (s_kernel - s_plain).abs().max().item() / ref
  log(f"score eval [{BATCH},3,32,32]: kernel vs plain max rel err "
      f"{rel:.3e} (limit {SCORE_RTOL}), max |score| {ref:.4g}; "
      f"ms kernel={kernel_eval_ms:.3f} plain={plain_eval_ms:.3f}")
  if not (torch.isfinite(s_kernel).all() and rel <= SCORE_RTOL):
    raise AssertionError("score evaluation through the kernel disagrees")
  return kernel_eval_ms, profile_score_eval(score_fn, x, t)


def profile_score_eval(score_fn, x, t, top=8, ours=("group_norm_fwd",)):
  """Device time of one score evaluation by kernel, and the share of the
  host's wall time (profiler on) in which the device was busy; `ours`
  names the port's kernels (a prefix of their names) whose time and
  launches are reported. Returns {"busy_ms", "wall_ms", "busy_share",
  "<name>_ms", "<name>_launches"}, or None if the profiler saw no device
  time."""
  from torch.profiler import ProfilerActivity, profile
  score_fn(x, t)
  torch.cuda.synchronize()
  with profile(activities=[ProfilerActivity.CPU,
                           ProfilerActivity.CUDA]) as prof:
    t0 = time.perf_counter()
    score_fn(x, t)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
  kernels = [e for e in prof.key_averages()
             if e.device_type == torch.autograd.DeviceType.CUDA]
  busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
  if not kernels:
    log("profile: the profiler saw no device time")
    return None
  out = {"busy_ms": busy_ms, "wall_ms": wall_ms,
         "busy_share": busy_ms / wall_ms}
  shares = []
  for name in ours:
    mine = [e for e in kernels if name in e.key]
    ms = sum(e.self_device_time_total for e in mine) / 1e3
    out[f"{name}_ms"] = ms
    out[f"{name}_launches"] = sum(e.count for e in mine)
    shares.append(f"{name} {ms:.3f} ms in {out[f'{name}_launches']} "
                  f"launches ({ms / busy_ms:.4f} of device time)")
  log(f"profile of one score eval: device busy {busy_ms:.3f} ms of "
      f"{wall_ms:.3f} ms wall ({busy_ms / wall_ms:.4f}); "
      + "; ".join(shares))
  for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:top]:
    log(f"  {e.self_device_time_total / 1e3:9.3f} ms  x{e.count:<4d} "
        f"{e.key[:100]}")
  return out


def phase_sample(cfg, workdir, batch=BATCH):
  """One round through `indm_torch.sample.run` into an emptied `workdir`
  (a round already on disk would be read back, not sampled), the score
  evaluations counted by kernel 1's launches; then the flow inverse
  alone."""
  from indm_torch import sample
  from indm_torch.flows.flow_model import create_flow_model, flow_forward
  from indm_torch.ops import group_norm as gn
  size = cfg.data.image_size
  shutil.rmtree(workdir, ignore_errors=True)
  gn.reset_launches()
  (res,) = sample.run(cfg, workdir, batch=batch, rounds=1, device="cuda",
                      log=log)
  launches = gn.launches
  nfe = res["nfe"]
  expected = GN_PER_SCORE_EVAL * (nfe + 1)  # + the denoise step
  log(f"sample round: nfe={nfe} score evals={nfe + 1} seconds="
      f"{res['seconds']:.3f} images/s={res['images_per_s']:.3f} "
      f"group_norm launches={launches} (expected {expected})")
  if launches != expected or launches == 0:
    raise AssertionError("kernel launches do not match the score "
                         "evaluations of the round")
  for name in ("before", "after"):
    img = res[name]
    if tuple(img.shape) != (batch, size, size, 3):
      raise AssertionError(f"{name}: shape {tuple(img.shape)}")
    if not torch.isfinite(img).all():
      raise AssertionError(f"{name}: non-finite values")
    inside = ((img >= 0) & (img <= 1)).float().mean().item()
    log(f"{name} flow: min={img.min().item():.4g} max={img.max().item():.4g}"
        f" share in [0,1]={inside:.4f}")
  import numpy as np
  with np.load(res["paths"]["after"]) as z:
    if z["samples"].shape != (batch, size, size, 3) or z["samples"].dtype != \
        np.uint8:
      raise AssertionError("the written round has the wrong layout")

  # the flow inverse alone, on the round's own weights and a fresh latent
  flow = create_flow_model(cfg, seed=cfg.seed + 1, device="cuda")
  z = torch.randn(batch, 3, size, size, device="cuda",
                  generator=torch.Generator(device="cuda").manual_seed(1))
  torch.cuda.synchronize()
  t0 = time.perf_counter()
  flow_forward(cfg, flow, z, reverse=True)
  torch.cuda.synchronize()
  steps = flow.resflow.last_inverse_steps
  log(f"flow inverse alone: seconds={time.perf_counter() - t0:.3f} "
      f"fixed-point steps per block={steps} (total {sum(steps)})")
  return res, launches


def phase_small_reference(cfg):
  from indm_torch import run_lib
  from indm_torch.flows.flow_model import flow_forward
  from indm_torch.models.registry import get_score_fn
  small = set_leaves(cfg, SMALL)
  gen = torch.Generator().manual_seed(3)
  size = small.data.image_size
  x = torch.randn(SMALL_BATCH, 3, size, size, generator=gen)
  sampling = {d: run_lib.build_sampling(small, SMALL_BATCH, device=d, seed=7)
              for d in ("cpu", "cuda")}
  eps = torch.randn(SMALL_BATCH, sampling["cpu"].flow_model.discriminator.dim,
                    generator=gen)

  def rel(got, ref):
    return ((got.float().cpu() - ref).abs().max() / ref.abs().max()).item()

  def check(what, err, limit):
    log(f"small reference {what}: card vs cpu max rel err {err:.3e} "
        f"(limit {limit})")
    if not err <= limit:
      raise AssertionError(f"{what} on the card disagrees with the CPU")

  fns = {d: get_score_fn(small, s.sde, s.score_model)
         for d, s in sampling.items()}
  for t in (1e-3, 0.1, 0.5, 1.0):
    vt = torch.full((SMALL_BATCH,), t)
    check(f"score t={t}", rel(fns["cuda"](x.cuda(), vt.cuda()),
                              fns["cpu"](x, vt)),
          SMALL_RTOL_T_EPS if t < 0.1 else SMALL_RTOL)
  inv = {d: flow_forward(small, s.flow_model, x.to(d), reverse=True,
                         prior_eps=eps.to(d))[0]
         for d, s in sampling.items()}
  check("flow inverse", rel(inv["cuda"], inv["cpu"]), SMALL_RTOL)
  rounds = {d: run_lib.sample_round(small, s, prior_noise=x.to(d),
                                    prior_eps=eps.to(d))
            for d, s in sampling.items()}
  after, nfe = {d: r[1] for d, r in rounds.items()}, {
      d: r[3] for d, r in rounds.items()}
  log(f"small reference round: nfe cuda={nfe['cuda']} cpu={nfe['cpu']}")
  if not torch.isfinite(after["cuda"]).all():
    raise AssertionError("the small round on the card is not finite")
  check("ODE round", rel(after["cuda"], after["cpu"].float()),
        SMALL_ROUND_RTOL)


def fir_calls(model, x, t):
  """[(shape, up, down, pad, taps, launches)] of one forward, recorded by
  wrapping the upfirdn2d wrapper, sorted by shape."""
  from indm_torch.ops import upfirdn2d as fir
  seen, taps = collections.Counter(), {}
  kernel = fir.upfirdn2d

  def record(v, k, up=1, down=1, pad=(0, 0)):
    key = (tuple(v.shape), up, down, tuple(pad), k.tobytes())
    seen[key] += 1
    taps[key] = k
    return kernel(v, k, up, down, pad)

  fir.upfirdn2d = record
  try:
    with torch.no_grad():
      model(x, t)
    torch.cuda.synchronize()
  finally:
    fir.upfirdn2d = kernel
  return [key[:4] + (taps[key], n) for key, n in sorted(seen.items())]


def fir_library(x, k, up, down, pad):
  """The same function as one grouped PyTorch call, as the JAX package's
  XLA path computes it: a strided depthwise conv of the padded input, or
  for up = 2 a depthwise transposed conv with stride 2."""
  import torch.nn.functional as F
  c = x.shape[1]
  kh, kw = k.shape
  kt = torch.from_numpy(k).to(x.device)
  if up == 1:
    w = torch.flip(kt, (0, 1)).expand(c, 1, kh, kw).contiguous()
    xp = F.pad(x, (pad[0], pad[1], pad[0], pad[1]))
    return lambda: F.conv2d(xp, w, stride=down, groups=c)
  if down != 1 or kh != kw:
    raise ValueError("the library yardstick takes up = 2 with down = 1")
  w = kt.expand(c, 1, kh, kw).contiguous()
  padding = kh - 1 - pad[0]
  extra = pad[1] - pad[0] + up - 1  # the output padding
  if padding < 0 or not 0 <= extra < up:
    raise ValueError(f"no transposed conv for pads {pad}")
  return lambda: F.conv_transpose2d(x, w, stride=up, padding=padding,
                                    output_padding=extra, groups=c)


def phase_fir(calls):
  """Kernel 9 against its plain version at each distinct call of the
  full-width VE score net, timed by `timed` beside its bytes bound, the
  plain version and the library call; returns the per-evaluation sums,
  the largest error and the rows by shape."""
  from indm_torch.ops import upfirdn2d as fir
  n_calls = sum(call[-1] for call in calls)
  log(f"upfirdn2d calls per VE score evaluation: {n_calls} "
      f"({len(calls)} distinct)")
  if n_calls != VE_FIR_PER_EVAL:
    raise AssertionError(f"expected {VE_FIR_PER_EVAL} upfirdn2d calls, got "
                         f"{n_calls}")
  gen = torch.Generator(device="cuda").manual_seed(9)
  per_eval, max_err = collections.defaultdict(float), 0.0
  by_shape = []
  for shape, up, down, pad, k, count in calls:
    x = torch.randn(shape, device="cuda", generator=gen)
    y = fir.upfirdn2d(x, k, up, down, pad)
    y_plain = fir.upfirdn2d_plain(x, k, up, down, pad)
    library = fir_library(x, k, up, down, pad)
    y_lib = library()
    torch.cuda.synchronize()
    big = y_plain.abs().max().item()
    err = (y - y_plain).abs().max().item()
    lib_err = (y_lib - y_plain).abs().max().item()
    if y.shape != y_plain.shape or not (math.isfinite(err)
                                        and err <= FIR_RTOL * big):
      raise AssertionError(f"upfirdn2d {shape} up={up} down={down} "
                           f"pad={pad}: max abs err {err} over {FIR_RTOL} "
                           f"x {big}")
    if y_lib.shape != y.shape or not lib_err <= FIR_RTOL * big:
      raise AssertionError(f"the library yardstick computes another "
                           f"function at {shape} up={up}")
    max_err = max(max_err, err)
    times = timed(lambda: fir.upfirdn2d(x, k, up, down, pad), library)
    times["plain_ms"] = cuda_ms(lambda: fir.upfirdn2d_plain(x, k, up, down,
                                                            pad))
    nbytes = 4 * (x.numel() + y.numel())
    times["bound_ms"] = nbytes / HBM_BYTES_PER_S * 1e3
    log(f"upfirdn2d {list(shape)} -> {list(y.shape)} up={up} down={down} "
        f"pad={pad} x{count}/eval: max_abs_err={err:.3e} (max |y| "
        f"{big:.3e}) " + " ".join(f"{k_}={v:.5f}" for k_, v in times.items())
        + f" ({times['bound_ms'] / times['graph_ms']:.3f} of the bound by "
        "graph_ms)")
    by_shape.append({"shape": list(shape), "out": list(y.shape), "up": up,
                     "down": down, "pad": list(pad), "count": count,
                     "max_abs_err": err, **times})
    for key, v in times.items():
      per_eval[key] += count * v
  log(f"upfirdn2d per VE score evaluation ({n_calls} launches): "
      + " ".join(f"{k_}={v:.5f}" for k_, v in per_eval.items())
      + f" ({per_eval['bound_ms'] / per_eval['graph_ms']:.3f} of the bound "
      "by graph_ms)")
  return dict(per_eval), max_err, by_shape


@contextlib.contextmanager
def plain_fir():
  """Route the FIR resampling through kernel 9's plain version."""
  from indm_torch.ops import upfirdn2d as fir
  kernel = fir.upfirdn2d
  fir.upfirdn2d = fir.upfirdn2d_plain
  try:
    yield
  finally:
    fir.upfirdn2d = kernel


def phase_ve_score(cfg):
  """Kernel 9's calls, then one full-width VE score evaluation through
  the kernels and through their plain versions; returns the kernel's
  per-evaluation times and largest error, the evaluation's ms, its
  profile and the kernel's rows by shape."""
  from indm_torch import sde as sde_lib
  from indm_torch.models.registry import create_model, get_score_fn
  from indm_torch.ops import group_norm as gn
  from indm_torch.ops import upfirdn2d as fir
  model = create_model(cfg, seed=cfg.seed, device="cuda")
  sde = sde_lib.get_sde(cfg)
  gen = torch.Generator(device="cuda").manual_seed(2)
  x = torch.randn(BATCH, 3, 32, 32, device="cuda", generator=gen)
  t = torch.full((BATCH,), 0.3, device="cuda")
  per_eval, max_err, by_shape = phase_fir(
      fir_calls(model, x, sde.marginal_prob(x, t)[1]))
  score_fn = get_score_fn(cfg, sde, model)
  gn.reset_launches()
  fir.reset_launches()
  s_kernel = score_fn(x, t)
  torch.cuda.synchronize()
  launches = (gn.launches, fir.launches)
  with plain_group_norm(), plain_fir():
    s_plain = score_fn(x, t)
    torch.cuda.synchronize()
    plain_eval_ms = cuda_ms(lambda: score_fn(x, t), iters=3, warmup=1)
  if (gn.launches, fir.launches) != launches:
    raise AssertionError("the plain run launched a kernel")
  if launches != (GN_PER_SCORE_EVAL, VE_FIR_PER_EVAL):
    raise AssertionError(f"a VE score evaluation launched (group_norm, "
                         f"upfirdn2d) = {launches}")
  kernel_eval_ms = cuda_ms(lambda: score_fn(x, t), iters=3, warmup=1)
  ref = s_plain.abs().max().item()
  rel = (s_kernel - s_plain).abs().max().item() / ref
  log(f"VE score eval [{BATCH},3,32,32] t=0.3: kernels vs plain max rel err "
      f"{rel:.3e} (limit {SCORE_RTOL}), max |score| {ref:.4g}; ms "
      f"kernels={kernel_eval_ms:.3f} plain={plain_eval_ms:.3f}")
  if not (torch.isfinite(s_kernel).all() and rel <= SCORE_RTOL):
    raise AssertionError("the VE score evaluation through the kernels "
                         "disagrees")
  profile = profile_score_eval(score_fn, x, t,
                               ours=("group_norm_fwd", "upfirdn2d"))
  return per_eval, max_err, kernel_eval_ms, profile, by_shape


def phase_ve_sample(cfg, workdir):
  """One full-width PC round through `indm_torch.sample.run` into an
  emptied `workdir`, with the evaluations counted by the kernels' launches
  (no GroupNorm kernel without `model.fused_groupnorm`)."""
  from indm_torch import sample
  from indm_torch.ops import group_norm as gn
  from indm_torch.ops import upfirdn2d as fir
  scales = cfg.sampling.num_scales
  log(f"VE PC round: sampling.num_scales={scales} (model.num_scales="
      f"{cfg.model.num_scales}), {cfg.sampling.n_steps_each} corrector "
      f"step(s) and one predictor step per scale")
  shutil.rmtree(workdir, ignore_errors=True)
  gn.reset_launches()
  fir.reset_launches()
  (res,) = sample.run(cfg, workdir, batch=BATCH, rounds=1, device="cuda",
                      log=log)
  launches = {"group_norm_fwd": gn.launches, "upfirdn2d": fir.launches}
  evals = scales * (cfg.sampling.n_steps_each + 1)
  seconds = res["seconds"]
  log(f"VE PC round: score evals={evals} (the sampler reports nfe="
      f"{res['nfe']}, sde.N x 2, as the JAX sampler) seconds={seconds:.3f} "
      f"images/s={res['images_per_s']:.4f} seconds per PC step="
      f"{seconds / scales:.5f} launches {launches}")
  group_norm = GN_PER_SCORE_EVAL if cfg.model.fused_groupnorm else 0
  if launches != {"group_norm_fwd": group_norm * evals,
                  "upfirdn2d": VE_FIR_PER_EVAL * evals}:
    raise AssertionError("kernel launches do not match the score "
                         "evaluations of the PC round")
  for name in ("before", "after"):
    img = res[name]
    if tuple(img.shape) != (BATCH, 32, 32, 3):
      raise AssertionError(f"VE {name}: shape {tuple(img.shape)}")
    if not torch.isfinite(img).all():
      raise AssertionError(f"VE {name}: non-finite values")
    log(f"VE {name} flow: min={img.min().item():.4g} "
        f"max={img.max().item():.4g}")
  import numpy as np
  with np.load(res["paths"]["search"]) as z:
    if z["samples"].shape != (BATCH, 32, 32, 3):
      raise AssertionError("the written search state has the wrong layout")
  return {"num_scales": scales, "score_evals": evals, "nfe": res["nfe"],
          "seconds": seconds, "images_per_s": res["images_per_s"],
          "seconds_per_step": seconds / scales}, launches


def phase_ve_small_reference(cfg):
  """At the tiny VE geometry, the card (through the kernels) against the
  CPU (their plain versions), same weights and noise: the score function
  at several t, and a PC round of VE_SMALL_SCALES scales."""
  from indm_torch import run_lib
  from indm_torch.models.registry import get_score_fn
  from indm_torch.ops import upfirdn2d as fir
  small = set_leaves(cfg, VE_SMALL)
  size = small.data.image_size
  gen = torch.Generator().manual_seed(3)
  shape = (SMALL_BATCH, 3, size, size)
  x = 5 * torch.randn(shape, generator=gen)
  prior = torch.randn(shape, generator=gen)
  sampling = {d: run_lib.build_sampling(small, SMALL_BATCH, device=d, seed=7)
              for d in ("cpu", "cuda")}
  eps = torch.randn(SMALL_BATCH, sampling["cpu"].flow_model.discriminator.dim,
                    generator=gen)
  steps = [([torch.randn(shape, generator=gen)], torch.randn(shape,
                                                             generator=gen))
           for _ in range(VE_SMALL_SCALES)]

  def rel(got, ref):
    return ((got.float().cpu() - ref).abs().max() / ref.abs().max()).item()

  def check(what, err, limit):
    log(f"VE small reference {what}: card vs cpu max rel err {err:.3e} "
        f"(limit {limit})")
    if not err <= limit:
      raise AssertionError(f"VE {what} on the card disagrees with the CPU")

  fns = {d: get_score_fn(small, s.sde, s.score_model)
         for d, s in sampling.items()}
  fir.reset_launches()
  for t in (1e-5, 1e-3, 0.1, 0.5, 1.0):
    vt = torch.full((SMALL_BATCH,), t)
    check(f"score t={t}", rel(fns["cuda"](x.cuda(), vt.cuda()),
                              fns["cpu"](x, vt)), SMALL_RTOL)
  if fir.launches == 0:
    raise AssertionError("the tiny VE score on the card did not launch "
                         "kernel 9")
  rounds = {}
  for d, s in sampling.items():
    on = [([z.to(d) for z in c], p.to(d)) for c, p in steps]
    rounds[d] = run_lib.sample_round(small, s, prior_noise=prior.to(d),
                                     prior_eps=eps.to(d),
                                     step_noise=on.__getitem__)
  if not torch.isfinite(rounds["cuda"][1]).all():
    raise AssertionError("the tiny VE round on the card is not finite")
  for i, what in enumerate(("round before flow", "round after flow",
                            "round step N-2 mean")):
    check(what, rel(rounds["cuda"][i], rounds["cpu"][i].float()),
          VE_SMALL_ROUND_RTOL)


def chain_flops_per_term(b, c, hw, width=CHAIN_WIDTH):
  """(conv_in, simt, gemm) FLOPs of one application of the net: its two
  narrow 3x3 convs, 2 * B*H*W * 9*C*I each, the C -> I one (conv_in, on
  the tensor cores) apart from the I -> C one (conv_out, float32 FMA), and
  the 1x1 product, 2 * B*H*W * I*I."""
  conv = 2 * b * hw * hw * 9 * c * width
  return (conv, conv, 2 * b * hw * hw * width * width)


def scaled(flops, k):
  return tuple(k * f for f in flops)


def added(*flops):
  return tuple(map(sum, zip(*flops)))


def fused_bwd_flops(b, c, hw, preact, width=CHAIN_WIDTH):
  """Kernel 4's (conv_in, simt, gemm) FLOPs: the 1x1 products of six
  applications of the net; four conv_ins (the primal and the tangent
  through W0, the two cotangents through W2^T); on float32 FMA, W0^T's
  conv_out (for the t-stream too with the pre-activation) and the two
  narrow weight gradients, two convs' sums each."""
  conv, _, gemm = chain_flops_per_term(b, c, hw, width)
  return (4 * conv, ((2 if preact else 1) + 4) * conv, 6 * gemm)


def flow_bounds(flops, nbytes, bf16=False):
  """(bound, SIMT bound, "operations" or "bytes") in ms for (conv_in,
  simt, gemm) FLOPs and the bytes moved: the note at TF32_FLOPS. With
  `bf16` (the bfloat16 mode of kernels 3-8) every operand is bfloat16, so
  all the FLOPs count at the card's dense bfloat16 rate."""
  conv_in, simt, gemm = flops
  tensor = conv_in + gemm
  ops = (sum(flops) / BF16_FLOPS if bf16
         else simt / F32_FLOPS + 3 * tensor / TF32_FLOPS)
  by_bytes = nbytes / HBM_BYTES_PER_S
  return (max(ops, by_bytes) * 1e3, sum(flops) / F32_FLOPS * 1e3,
          "operations" if ops >= by_bytes else "bytes")


def flow_bytes(kind, b, c, hw, preact=True, nb=1, width=CHAIN_WIDTH,
               wsize=4):
  """The bytes a flow kernel must move, each input read once and each
  output written once (the weights in the orientations the kernel takes):
  "chain" (kernel 7), "chain8" (kernel 8), "fwd" and "bwd" (kernels 3 and
  4), "stack_fwd" and "stack_bwd" (kernels 5 and 6, nb blocks). The
  image-sized tensors and the log-dets are float32; the weights, biases
  and hp take `wsize` bytes (2 in the bfloat16 mode of kernels 3-6).
  "chain_bf16" and "chain8_bf16": kernels 7 and 8 in bfloat16, every input
  bfloat16 and acc float32."""
  nar, wide = b * c * hw * hw, b * width * hw * hw
  w3, w1, hp = 9 * c * width, width * width, b * width
  if kind in ("chain_bf16", "chain8_bf16"):
    ins = {"chain_bf16": nar + 2 * wide + (nar if preact else 0) + 2 * w3
                         + w1,
           "chain8_bf16": 2 * nar + 3 * w3 + 2 * w1 + 2 * width + hp}[kind]
    return 2 * ins + 4 * nar
  floats, params = {
      "chain": (2 * nar + 2 * wide + (nar if preact else 0), 2 * w3 + w1),
      "chain8": (3 * nar, 3 * w3 + 2 * w1 + 2 * width + hp),
      "fwd": (4 * nar + b, 4 * w3 + 2 * w1 + 2 * width + c + hp),
      "bwd": (5 * nar + b, 5 * w3 + 3 * w1 + 4 * width + c + 2 * hp),
      "stack_fwd": (2 * nar + nb * (3 * nar + b),
                    nb * (4 * w3 + 2 * w1 + 2 * width + c + hp)),
      "stack_bwd": (2 * nar + b + nb * 3 * nar,
                    nb * (5 * w3 + 3 * w1 + 4 * width + c + 2 * hp))}[kind]
  return 4 * floats + wsize * params


def chain_inputs(b, c, hw, preact, gen, width=CHAIN_WIDTH):
  """vareps, diagonals cos(2 pi a) and transposed weights of variance
  1 / fan_in, so that every term of the series stays of order one (a
  Lipschitz net's weights shrink the terms so fast that the later ones
  would not show in the sum)."""
  def randn(*shape):
    return torch.randn(shape, device="cuda", generator=gen)

  ws = [randn(*shape) / math.sqrt(shape[1] * shape[2] * shape[3])
        for shape in ((width, c, 3, 3), (width, width, 1, 1),
                      (c, width, 3, 3))]
  dacts = [torch.cos(2 * math.pi * randn(b, width, hw, hw)) for _ in range(2)]
  if preact:
    dacts.append(torch.cos(2 * math.pi * randn(b, c, hw, hw)))
  return randn(b, c, hw, hw), dacts, ws


def chain_split(args, terms, what, kernels=SPLIT_KERNELS, fused=False):
  """Device time per term of each of a chain term's three launches
  (`kernels`: conv_in, the GEMM, conv_out, each with the chain's epilogue)
  in one call of kernel 7 (`neumann_chain(*args)`) or, with `fused`, of
  kernel 8 (`fused_neumann_chain(*args)`), from torch.profiler, after one
  call to warm up. The libraries' host counts must show `terms` launches
  of the term's GEMM (kernel 8: one more, its layer 1) and none of the
  other GEMMs, and kernel 7's library `terms` launches of each narrow conv
  (`device_conv_launches`), in every profiled call. The profiler loses
  records at times, a few in a long process and every one in a short
  (PERF.md §7), so up to three calls are profiled for one that shows every
  launch once a term; for kernel 8 the times are then per launch the
  profiler saw (what it saw is logged). "all": the call's device time
  (kernel 7: per term; kernel 8: the whole call, its forward included).
  If no profiled call of kernel 7 shows every launch, CUDA events instead
  (conv_in and conv_out as single `narrow_conv` launches at the term's
  shapes, a storing epilogue, float32, the GEMM as the rest of the term's
  time; kernel 8 without device time: not measured)."""
  from torch.profiler import ProfilerActivity, profile

  from indm_torch.ops import narrow_conv as nc
  from indm_torch.ops import lipnet_gemm as lg
  from indm_torch.ops import neumann
  names = kernels
  fn = neumann.fused_neumann_chain if fused else neumann.neumann_chain
  gemm = {v: k for k, v in GEMM_KERNELS.items()}[names[1]]
  want = {**{k: 0 for k in GEMM_KERNELS}, gemm: terms + (1 if fused else 0)}
  term_launches = tuple(zip(names, ("DMul", "DMul", "ChainOut")))
  fn(*args)
  torch.cuda.synchronize()
  for _ in range(3):
    before = lg.device_gemm_launches()
    convs_before = lg.device_conv_launches("neumann_chain.cu")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as p:
      fn(*args)
      torch.cuda.synchronize()
    counts = gemm_counts_since(before)
    if counts != want:
      raise AssertionError(f"chain {what}: GEMM launches {counts}, expected "
                           f"{want}")
    convs = {k: v - convs_before[k] for k, v in
             lg.device_conv_launches("neumann_chain.cu").items()}
    if not fused and convs != {"conv_in": terms, "conv_out": terms}:
      raise AssertionError(f"chain {what}: narrow conv launches {convs} in "
                           f"{terms} terms")
    kernels = [e for e in p.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    seen = {name: sum(e.count for e in kernels
                      if name in e.key and epi in e.key)
            for name, epi in term_launches}
    if kernels and set(seen.values()) == {terms}:
      break
    log(f"{fn.__name__} {what}: the profiler saw {seen} of the launches "
        f"in {terms} terms")
  complete = set(seen.values()) == {terms}
  if kernels and (fused or complete):
    method = "torch.profiler"
    total = sum(e.self_device_time_total for e in kernels) / 1e3
    split = {"all": total if fused else total / terms}
    for name in set(GEMM_KERNELS.values()) - set(names):
      if any(name in e.key for e in kernels):
        raise AssertionError(f"the chain launched {name}")
    if not complete:
      method += f", per launch it saw ({seen} in {terms} terms)"
      log(f"{fn.__name__} {what}: the profiler saw "
          + "; ".join(f"{e.key[:90]} x{e.count}" for e in kernels))
    for name, epi in term_launches:
      mine = [e for e in kernels if name in e.key and epi in e.key]
      split[name] = (sum(e.self_device_time_total for e in mine) / 1e3
                     / seen[name] if seen[name] else math.nan)
  elif fused:
    method = "not measured: the profiler saw no device time"
    split = {}
  else:
    method = ("CUDA events: no profiled call showed every launch; conv_in "
              "and conv_out as narrow_conv launches, gemm the rest")
    vareps, _, ws = (a.float() if torch.is_tensor(a) else
                     [t.float() for t in a] for a in args[:3])
    t2 = torch.randn(vareps.shape[0], ws[0].shape[0], *vareps.shape[2:],
                     device="cuda")
    split = {"all": cuda_ms(lambda: neumann.neumann_chain(*args), 5, 1)
             / terms,
             "conv_in_kernel": cuda_ms(lambda: nc.narrow_conv(vareps, ws[0])),
             "conv_out_kernel": cuda_ms(lambda: nc.narrow_conv(t2, ws[2]))}
    split[names[1]] = (split["all"] - split["conv_in_kernel"]
                       - split["conv_out_kernel"])
  log(f"{fn.__name__} {what} width {CHAIN_WIDTH} preact=True: GEMM "
      f"launches {counts}; device ms per term ({method}) "
      + " ".join(f"{k}={v:.4f}" for k, v in split.items()))
  split["method"] = method
  return split


def phase_chain():
  """The chain kernel against its plain version; returns per-term times
  {(scale, preact): {"ms", "plain_ms", "library_ms"}}, the largest error
  and, per scale, the device time of each launch of a term (`chain_split`,
  pre-activated, n = SPLIT_N)."""
  from indm_torch.flows.resflow import OFFSET_TRAIN, RCDF_TRAIN
  from indm_torch.ops import neumann
  gen = torch.Generator(device="cuda").manual_seed(4)
  per_term, max_err, split = {}, 0.0, {}
  for scale, (c, hw) in enumerate(CHAIN_SCALES):
    flops = chain_flops_per_term(TRAIN_BATCH, c, hw)
    for preact in (False, True):
      vareps, dacts, ws = chain_inputs(TRAIN_BATCH, c, hw, preact, gen)

      if preact:
        split[scale] = chain_split(
            (vareps, dacts, ws, SPLIT_N, OFFSET_TRAIN, RCDF_TRAIN),
            SPLIT_N + OFFSET_TRAIN,
            f"[{TRAIN_BATCH},{c},{hw},{hw}] n={SPLIT_N}")
      for n in CHAIN_NS:
        args = (vareps, dacts, ws, n, OFFSET_TRAIN, RCDF_TRAIN)
        acc = neumann.neumann_chain(*args)
        ref = neumann.neumann_chain_plain(*args)
        torch.cuda.synchronize()
        err = (acc - ref).abs().max().item()
        big = ref.abs().max().item()
        if not (math.isfinite(err) and err <= CHAIN_RTOL * big):
          raise AssertionError(f"neumann_chain scale {scale} preact {preact} "
                               f"n={n}: max abs err {err} over "
                               f"{CHAIN_RTOL} x {big}")
        max_err = max(max_err, err)
        terms = n + OFFSET_TRAIN
        times = {
            "ms": cuda_ms(lambda: neumann.neumann_chain(*args), 3, 1),
            "plain_ms": cuda_ms(lambda: neumann.neumann_chain_plain(*args),
                                3, 1),
            "library_ms": cuda_ms(
                lambda: chain_library(vareps, dacts, ws, n), 3, 1)}
        bound, simt, _ = flow_bounds(
            scaled(flops, terms),
            flow_bytes("chain", TRAIN_BATCH, c, hw, preact))
        total = terms * sum(flops)
        log(f"neumann_chain [{TRAIN_BATCH},{c},{hw},{hw}] width "
            f"{CHAIN_WIDTH} preact={preact} n={n} ({terms} terms): "
            f"max_abs_err={err:.3e} (max |acc| {big:.3e}) "
            + " ".join(f"{k}={v:.4f}" for k, v in times.items())
            + f" bound_ms={bound:.4f} simt_bound_ms={simt:.4f} "
            f"({total / 1e9:.2f} GFLOP, {total / times['ms'] / 1e9:.2f} "
            "TFLOP/s)")
        if n == max(CHAIN_NS):
          per_term[(scale, preact)] = {k: v / terms for k, v in
                                       times.items()}
      del vareps, dacts, ws
      torch.cuda.empty_cache()
  return per_term, max_err, split


def fused_chain_fwd_flops(b, c, hw, width=CHAIN_WIDTH):
  """Kernel 8's forward, the first two layers: (conv_in, simt, gemm)
  FLOPs 2 * B*H*W * 9*C*I, 0 and 2 * B*H*W * I*I."""
  return (2 * b * hw * hw * 9 * c * width, 0,
          2 * b * hw * hw * width * width)


def exact_diagonal_chain(b, c, hw, preact, gen, width=CHAIN_WIDTH):
  """Kernel 8's inputs (x, vareps, its forward weights, biases, the chain's
  weights, hp) whose diagonals are exact, and the same diagonals written
  out for kernel 7: W0 = W1 = 0, so z1 = b0 and z2 = b1, with the biases
  and x on multiples of 1/4, where cos(2 pi z) is 1, 0 or -1 in any
  float32 arithmetic; the chain's weights, vareps and hp random."""
  from indm_torch.ops import neumann
  d = fused_inputs(b, c, hw, gen, width)

  def quarters(*shape):
    return torch.randint(-4, 5, shape, device="cuda", generator=gen) / 4

  w0, w1, w2 = d["ws"]
  x, biases = quarters(b, c, hw, hw), (quarters(width), quarters(width))
  fwd = (torch.zeros_like(w0), torch.zeros_like(w1[:, :, 0, 0]))
  weights_t = [neumann.transpose_conv_weight(w).contiguous()
               for w in (w2, w1, w0)]
  dacts = [torch.cos(2 * math.pi * bias)[None, :, None, None].expand(
      b, width, hw, hw) for bias in biases[::-1]]
  if preact:
    dacts.append(torch.cos(2 * math.pi * x))
  dacts = [torch.where(a.abs() < 0.5, torch.zeros_like(a), a.sign())
           .contiguous() for a in dacts]
  return (x, d["eps"], fwd, biases, weights_t, d["hp"]), dacts


def phase_fused_chain():
  """Kernel 8 against its plain version at both full-width scales,
  pre-activated and not, with hp and without, n in CHAIN_NS, its products
  n + 3 launches of the `wgmma` GEMM and no other GEMM; for the same
  diagonals (exact_diagonal_chain) kernel 7's bits; then against
  `chain_mats` and kernel 7 on the same `IResBlock`, the route it
  replaces. At each scale one call (pre-activated, hp, n = SPLIT_N) under
  torch.profiler: a chain term's device time by launch (chain_split).
  Returns, per (scale, preact), times {name: (ms at n = 0, ms per extra
  n)} with hp, the largest error and the per-scale split."""
  from indm_torch.flows.resflow import OFFSET_TRAIN, RCDF_TRAIN, IResBlock
  from indm_torch.ops import lipnet_gemm as lg
  from indm_torch.ops import neumann
  gen = torch.Generator(device="cuda").manual_seed(9)
  fits, max_err, split = {}, 0.0, {}
  n_lo, n_hi = min(CHAIN_NS), max(CHAIN_NS)

  def check(what, acc, ref):
    err = (acc - ref).abs().max().item()
    big = ref.abs().max().item()
    if not (math.isfinite(err) and err <= CHAIN_RTOL * big):
      raise AssertionError(f"{what}: max abs err {err} over {CHAIN_RTOL} x "
                           f"{big}")
    return err

  for scale, (c, hw) in enumerate(CHAIN_SCALES):
    flops = chain_flops_per_term(TRAIN_BATCH, c, hw)
    fwd_flops = fused_chain_fwd_flops(TRAIN_BATCH, c, hw)
    for preact in (False, True):
      d = fused_inputs(TRAIN_BATCH, c, hw, gen)
      w0, w1, w2 = d["ws"]
      mats = ((w0, w1[:, :, 0, 0]), tuple(d["bs"][:2]),
              [neumann.transpose_conv_weight(w).contiguous()
               for w in (w2, w1, w0)])
      t = collections.defaultdict(dict)
      if preact:
        split[scale] = chain_split(
            (d["x"], d["eps"], *mats, d["hp"], SPLIT_N, OFFSET_TRAIN,
             RCDF_TRAIN, preact), SPLIT_N + OFFSET_TRAIN,
            f"[{TRAIN_BATCH},{c},{hw},{hw}] n={SPLIT_N}", fused=True)
      for hp in (d["hp"], None):
        for n in CHAIN_NS:
          args = (d["x"], d["eps"], *mats, hp, n, OFFSET_TRAIN, RCDF_TRAIN,
                  preact)
          what = (f"fused_neumann_chain [{TRAIN_BATCH},{c},{hw},{hw}] width "
                  f"{CHAIN_WIDTH} preact={preact} hp={hp is not None} n={n}")
          before = lg.device_gemm_launches()
          acc = neumann.fused_neumann_chain(*args)
          gemms = gemm_counts_since(before)
          if gemms != {"gemm_3xtf32": 0, "wgmma": n + OFFSET_TRAIN + 1,
                       "gemm_bf16": 0}:
            raise AssertionError(f"{what}: GEMM launches {gemms}")
          err = check(what, acc, neumann.fused_neumann_chain_plain(*args))
          max_err = max(max_err, err)
          if hp is None:
            log(f"{what}: max_abs_err={err:.3e}")
            continue
          t["ms"][n] = cuda_ms(lambda: neumann.fused_neumann_chain(*args), 3,
                               1)
          t["plain_ms"][n] = cuda_ms(
              lambda: neumann.fused_neumann_chain_plain(*args), 3, 1)
          bound, simt, _ = flow_bounds(
              added(fwd_flops, scaled(flops, n + OFFSET_TRAIN)),
              flow_bytes("chain8", TRAIN_BATCH, c, hw))
          log(f"{what}: max_abs_err={err:.3e} ms={t['ms'][n]:.4f} "
              f"plain_ms={t['plain_ms'][n]:.4f} bound_ms={bound:.4f} "
              f"simt_bound_ms={simt:.4f} ({bound / t['ms'][n]:.3f} of the "
              "bound)")
      del d, mats, args, acc
      torch.cuda.empty_cache()

      # for the same diagonals, kernel 8's chain is kernel 7's bit for bit
      args, dacts = exact_diagonal_chain(TRAIN_BATCH, c, hw, preact, gen)
      for n in (n_lo, SPLIT_N):
        tail = (n, OFFSET_TRAIN, RCDF_TRAIN)
        k8 = neumann.fused_neumann_chain(*args, *tail, preact)
        k7 = neumann.neumann_chain(args[1], dacts, args[4], *tail)
        if not (torch.equal(k8, k7) and k8.abs().max().item() > 0):
          raise AssertionError(
              f"fused_neumann_chain [{TRAIN_BATCH},{c},{hw},{hw}] "
              f"preact={preact} n={n}: not kernel 7's bits for the same "
              f"diagonals (max abs difference {(k8 - k7).abs().max()})")
      log(f"fused_neumann_chain [{TRAIN_BATCH},{c},{hw},{hw}] preact={preact}"
          f": kernel 7's bits for the same (exact) diagonals at n = {n_lo} "
          f"and {SPLIT_N}")
      del args, dacts, k8, k7
      torch.cuda.empty_cache()

      # the same block's chain through kernel 8 and through chain_mats and
      # kernel 7 (the route it replaces), h of width 64
      block = IResBlock(c, CHAIN_WIDTH, cond_dim=FUSED_COND, preact=preact,
                        generator=gen, device="cuda")
      x = torch.randn(TRAIN_BATCH, c, hw, hw, device="cuda", generator=gen)
      h = torch.randn(TRAIN_BATCH, FUSED_COND, device="cuda", generator=gen)
      eps = torch.randn_like(x)
      with torch.no_grad():
        for n in CHAIN_NS:
          tail = (n, OFFSET_TRAIN, RCDF_TRAIN)

          def route():
            weights_t, dacts = block.chain_mats(x, h)
            return neumann.neumann_chain(eps, dacts, weights_t, *tail)

          def fused():
            return neumann.fused_neumann_chain(
                x, eps, *neumann.fused_chain_inputs(block, h), *tail,
                preact)

          err = check(f"fused_neumann_chain against chain_mats and kernel 7, "
                      f"IResBlock [{TRAIN_BATCH},{c},{hw},{hw}] "
                      f"preact={preact} n={n}", fused(), route())
          max_err = max(max_err, err)
          if n in (n_lo, n_hi):
            t["block_ms"][n] = cuda_ms(fused, 3, 1)
            t["chain_mats_k7_ms"][n] = cuda_ms(route, 3, 1)
      log(f"IResBlock [{TRAIN_BATCH},{c},{hw},{hw}] preact={preact}: "
          f"fused chain (weights packed in the call) ms n={n_lo} "
          f"{t['block_ms'][n_lo]:.3f} n={n_hi} {t['block_ms'][n_hi]:.3f}; "
          f"chain_mats and kernel 7 ms n={n_lo} "
          f"{t['chain_mats_k7_ms'][n_lo]:.3f} n={n_hi} "
          f"{t['chain_mats_k7_ms'][n_hi]:.3f}")
      del block, x, h, eps
      torch.cuda.empty_cache()
      fits[(scale, preact)] = {
          k: (v[n_lo], (v[n_hi] - v[n_lo]) / (n_hi - n_lo))
          for k, v in t.items()}
  return fits, max_err, split


def chain_library(vareps, dacts, ws, n):
  """Kernel 7's series through cuDNN, written out with F.conv2d in the
  inputs' type (each diagonal product in it too), acc in float32: the
  library column of rows 7 and 7b."""
  import torch.nn.functional as F
  from indm_torch.flows.resflow import OFFSET_TRAIN, RCDF_TRAIN
  from indm_torch.ops import neumann
  acc, v = torch.zeros_like(vareps, dtype=torch.float32), vareps
  for coeff in neumann.chain_coeffs(n, OFFSET_TRAIN, RCDF_TRAIN):
    for i, w in enumerate(ws):
      v = F.conv2d(v, w, padding=w.shape[-1] // 2)
      if i < len(dacts):
        v = v * dacts[i]
    acc = acc + float(coeff) * v.float()
  return acc


def phase_chain_bf16():
  """Kernel 7 in bfloat16 (every input bfloat16, acc float32) against its
  plain bfloat16 version on float64 inputs (`exact`: every rounding point
  kept, every other sum exact) with check_bf16_chain, the plain float32
  version on the same inputs giving the gap, at both full-width scales,
  pre-activated and not, n in CHAIN_NS; timed beside its bound (all its
  work as one bfloat16 pass), the plain version and the same chain
  through bfloat16 F.conv2d; at each scale one call (pre-activated, n =
  SPLIT_N) under torch.profiler: each term's product one wgmma_bf16_kernel
  launch and no other GEMM. Returns per-term times {(scale, preact):
  {"ms", "plain_ms", "library_ms"}} of the n = 6 calls, the largest error
  and the per-scale split."""
  from indm_torch.flows.resflow import OFFSET_TRAIN, RCDF_TRAIN
  from indm_torch.ops import lipnet_gemm as lg
  from indm_torch.ops import neumann
  bf = torch.bfloat16
  gen = torch.Generator(device="cuda").manual_seed(11)
  per_term, max_err, split = {}, 0.0, {}
  for scale, (c, hw) in enumerate(CHAIN_SCALES):
    flops = chain_flops_per_term(TRAIN_BATCH, c, hw)
    for preact in (False, True):
      vareps, dacts, ws = chain_inputs(TRAIN_BATCH, c, hw, preact, gen)
      vareps, dacts, ws = (vareps.to(bf), [d.to(bf) for d in dacts],
                           [w.to(bf).contiguous() for w in ws])
      if preact:
        split[scale] = chain_split(
            (vareps, dacts, ws, SPLIT_N, OFFSET_TRAIN, RCDF_TRAIN),
            SPLIT_N + OFFSET_TRAIN,
            f"bfloat16 [{TRAIN_BATCH},{c},{hw},{hw}] n={SPLIT_N}",
            BF16_SPLIT_KERNELS)
      for n in CHAIN_NS:
        args = (vareps, dacts, ws, n, OFFSET_TRAIN, RCDF_TRAIN)
        what = (f"neumann_chain bfloat16 [{TRAIN_BATCH},{c},{hw},{hw}] width "
                f"{CHAIN_WIDTH} preact={preact} n={n}")
        before = lg.device_gemm_launches()
        acc = neumann.neumann_chain(*args)
        gemms = gemm_counts_since(before)
        terms = n + OFFSET_TRAIN
        if gemms != {"gemm_3xtf32": 0, "wgmma": 0, "gemm_bf16": terms}:
          raise AssertionError(f"{what}: GEMM launches {gemms}")
        err = check_bf16_chain(
            what, acc,
            exact(neumann.neumann_chain_plain, *args, compute_dtype=bf),
            exact(neumann.neumann_chain_plain, *args),
            neumann.neumann_chain_plain(*args))
        max_err = max(max_err, err)
        times = {
            "ms": cuda_ms(lambda: neumann.neumann_chain(*args), 3, 1),
            "plain_ms": cuda_ms(lambda: neumann.neumann_chain_plain(*args),
                                3, 1),
            "library_ms": cuda_ms(
                lambda: chain_library(vareps, dacts, ws, n), 3, 1)}
        bound, _, by = flow_bounds(
            scaled(flops, terms),
            flow_bytes("chain_bf16", TRAIN_BATCH, c, hw, preact), bf16=True)
        log(f"{what} ({terms} terms): max_abs_err={err:.3e} "
            + " ".join(f"{k}={v:.4f}" for k, v in times.items())
            + f" bound_ms={bound:.4f} ({by}; {bound / times['ms']:.3f} of "
            "the bound)")
        if n == max(CHAIN_NS):
          per_term[(scale, preact)] = {k: v / terms for k, v in
                                       times.items()}
      del vareps, dacts, ws, acc
      torch.cuda.empty_cache()
  return per_term, max_err, split


def phase_fused_chain_bf16():
  """Kernel 8 in bfloat16 against its plain bfloat16 version on float64
  inputs (check_bf16_chain) at both full-width scales, pre-activated and
  not, with hp and without, n in CHAIN_NS, timed with hp beside its bound
  and the plain version; then against bfloat16 `chain_mats` and kernel 7
  on the same `IResBlock` (h of width 64). The two routes' diagonals
  differ (chain_mats rounds 2 pi a to bfloat16 before the cos, kernel 8
  takes it in float32, as in the JAX package), and on a pre-activated
  block both differ from the float32 route by more than BF16_RTOL of its
  largest value (the cos of 2 pi x with x rounded to bfloat16 moves d0 by
  up to a few percent where |x| is large). So the two are held nearer each
  other in root mean square than the farther of them is to the float32
  route, for every one of CHAIN8_DRAWS eps draws (chain8_route_margins);
  both timed.
  Returns, per
  (scale, preact), times {name: (ms at n = 0, ms per extra n)} and the
  largest error."""
  from indm_torch.flows.resflow import OFFSET_TRAIN, RCDF_TRAIN
  from indm_torch.ops import lipnet_gemm as lg
  from indm_torch.ops import neumann
  bf = torch.bfloat16
  gen = torch.Generator(device="cuda").manual_seed(12)
  route_gen = torch.Generator(device="cuda").manual_seed(12)
  fits, max_err = {}, 0.0
  n_lo, n_hi = min(CHAIN_NS), max(CHAIN_NS)
  for scale, (c, hw) in enumerate(CHAIN_SCALES):
    flops = chain_flops_per_term(TRAIN_BATCH, c, hw)
    fwd_flops = fused_chain_fwd_flops(TRAIN_BATCH, c, hw)
    for preact in (False, True):
      d = fused_inputs(TRAIN_BATCH, c, hw, gen)
      w0, w1, w2 = (w.to(bf) for w in d["ws"])
      mats = ((w0, w1[:, :, 0, 0].contiguous()),
              tuple(b.to(bf) for b in d["bs"][:2]),
              [neumann.transpose_conv_weight(w).contiguous()
               for w in (w2, w1, w0)])
      x, eps = d["x"].to(bf), d["eps"].to(bf)
      t = collections.defaultdict(dict)
      for hp in (d["hp"].to(bf), None):
        for n in CHAIN_NS:
          args = (x, eps, *mats, hp, n, OFFSET_TRAIN, RCDF_TRAIN, preact)
          what = (f"fused_neumann_chain bfloat16 [{TRAIN_BATCH},{c},{hw},"
                  f"{hw}] width {CHAIN_WIDTH} preact={preact} "
                  f"hp={hp is not None} n={n}")
          before = lg.device_gemm_launches()
          acc = neumann.fused_neumann_chain(*args)
          gemms = gemm_counts_since(before)
          if gemms != {"gemm_3xtf32": 0, "wgmma": 0,
                       "gemm_bf16": n + OFFSET_TRAIN + 1}:
            raise AssertionError(f"{what}: GEMM launches {gemms}")
          err = check_bf16_chain(
              what, acc,
              exact(neumann.fused_neumann_chain_plain, *args,
                    compute_dtype=bf),
              exact(neumann.fused_neumann_chain_plain, *args),
              neumann.fused_neumann_chain_plain(*args))
          max_err = max(max_err, err)
          if hp is None:
            continue
          t["ms"][n] = cuda_ms(lambda: neumann.fused_neumann_chain(*args), 3,
                               1)
          t["plain_ms"][n] = cuda_ms(
              lambda: neumann.fused_neumann_chain_plain(*args), 3, 1)
          bound, _, by = flow_bounds(
              added(fwd_flops, scaled(flops, n + OFFSET_TRAIN)),
              flow_bytes("chain8_bf16", TRAIN_BATCH, c, hw), bf16=True)
          log(f"{what}: ms={t['ms'][n]:.4f} plain_ms={t['plain_ms'][n]:.4f} "
              f"bound_ms={bound:.4f} ({by}; {bound / t['ms'][n]:.3f} of the "
              "bound)")
      del d, mats, args, x, eps, acc
      torch.cuda.empty_cache()

      # the same block's chain through kernel 8 and through bfloat16
      # chain_mats and kernel 7, drawn as ab_kernels.py draws them
      block, x, h, eps = chain8_route_inputs(c, hw, preact, route_gen)
      margins, largest = chain8_route_margins(block, x, h, eps, preact)
      worst = {n: math.nan if any(map(math.isnan, m)) else min(m)
               for n, m in margins.items()}
      log(f"fused_neumann_chain bfloat16 against bfloat16 chain_mats and "
          f"kernel 7, IResBlock [{TRAIN_BATCH},{c},{hw},{hw}] "
          f"preact={preact}, {CHAIN8_DRAWS} eps draws: smallest margin "
          "(the farther's rms distance from the float32 route over theirs) "
          + " ".join(f"n={n} {m:.4f}" for n, m in worst.items())
          + "; in the largest element "
          + " ".join(f"n={n} {min(m):.4f}" for n, m in largest.items()))
      if not all(m >= 1 for m in worst.values()):  # NaN fails
        raise AssertionError("kernel 8 and chain_mats with kernel 7 in "
                             "bfloat16 are farther apart than from the "
                             "float32 route")
      with torch.no_grad():
        for n in (n_lo, n_hi):
          tail = (n, OFFSET_TRAIN, RCDF_TRAIN)

          def route():
            weights_t, dacts = block.chain_mats(x, h, bf)
            return neumann.neumann_chain(eps[0].to(bf), dacts, weights_t,
                                         *tail)

          def fused():
            return neumann.fused_neumann_chain(
                x.to(bf), eps[0].to(bf),
                *neumann.fused_chain_inputs(block, h, bf), *tail, preact)

          t["block_ms"][n] = cuda_ms(fused, 3, 1)
          t["chain_mats_k7_ms"][n] = cuda_ms(route, 3, 1)
      log(f"IResBlock bfloat16 [{TRAIN_BATCH},{c},{hw},{hw}] preact={preact}: "
          f"fused chain ms n={n_lo} {t['block_ms'][n_lo]:.3f} n={n_hi} "
          f"{t['block_ms'][n_hi]:.3f}; chain_mats and kernel 7 ms n={n_lo} "
          f"{t['chain_mats_k7_ms'][n_lo]:.3f} n={n_hi} "
          f"{t['chain_mats_k7_ms'][n_hi]:.3f}")
      del block, x, h, eps
      torch.cuda.empty_cache()
      fits[(scale, preact)] = {
          k: (v[n_lo], (v[n_hi] - v[n_lo]) / (n_hi - n_lo))
          for k, v in t.items()}
  return fits, max_err


def chain8_route_inputs(c, hw, preact, gen, draws=CHAIN8_DRAWS):
  """Phase 6g's route comparison at one scale: a full-width IResBlock (h
  of width FUSED_COND), x [TRAIN_BATCH, c, hw, hw], h and `draws` eps,
  drawn from `gen` in that order. Phase 6g and ab_kernels.py take the
  cases (scale, then preact False and True) from one generator seeded
  12."""
  from indm_torch.flows.resflow import IResBlock
  block = IResBlock(c, CHAIN_WIDTH, cond_dim=FUSED_COND, preact=preact,
                    generator=gen, device="cuda")
  x = torch.randn(TRAIN_BATCH, c, hw, hw, device="cuda", generator=gen)
  h = torch.randn(TRAIN_BATCH, FUSED_COND, device="cuda", generator=gen)
  eps = [torch.randn(x.shape, device="cuda", generator=gen)
         for _ in range(draws)]
  return block, x, h, eps


def chain8_route_margins(block, x, h, eps_draws, preact):
  """Kernel 8 in bfloat16 against bfloat16 `chain_mats` and kernel 7 on
  one IResBlock, for each eps of eps_draws and n of CHAIN_NS, each with
  the float32 route (float32 chain_mats and kernel 7) as the reference.
  Returns ({n: [rms margin of each draw]}, {n: [max margin of each
  draw]}): a margin is the farther route's distance from the reference
  over the two routes' distance from each other, in root mean square over
  all elements (phase 6g holds every one at 1 or more) or in the largest
  element (logged only). The largest element's ratio sits near 1 at scale
  1 without the pre-activation and misses on 6 of 64 draws, where the JAX
  package's own two routes (interpret-mode Pallas) miss on the same draws
  by the same ratios, while the rms ratio is 1.78 on each of them
  (`tests/test_torch_route_margins.py`, PERF.md)."""
  from indm_torch.flows.resflow import OFFSET_TRAIN, RCDF_TRAIN
  from indm_torch.ops import neumann
  bf = torch.bfloat16
  rms = {n: [] for n in CHAIN_NS}
  largest = {n: [] for n in CHAIN_NS}

  def ratio(far, err):
    return far / err if err != 0 else (math.inf if math.isfinite(far)
                                       else math.nan)

  with torch.no_grad():
    for eps in eps_draws:
      for n in CHAIN_NS:
        tail = (n, OFFSET_TRAIN, RCDF_TRAIN)
        got = neumann.fused_neumann_chain(
            x.to(bf), eps.to(bf), *neumann.fused_chain_inputs(block, h, bf),
            *tail, preact).double()
        weights_t, dacts = block.chain_mats(x, h, bf)
        want = neumann.neumann_chain(eps.to(bf), dacts, weights_t,
                                     *tail).double()
        weights_t, dacts = block.chain_mats(x, h)
        ref = neumann.neumann_chain(eps, dacts, weights_t, *tail).double()
        for out, norm in ((rms, lambda d: d.square().mean().sqrt().item()),
                          (largest, lambda d: d.abs().max().item())):
          out[n].append(ratio(max(norm(a - ref) for a in (got, want)),
                              norm(got - want)))
  return rms, largest


def narrow_conv_bound_ms(kind, b, c, hw, width, dtype):
  """Kernel 10's bound at one kind: the wide operand, the narrow operand
  and the weights once over the memory rate, against 2*B*H*W*9*C*I
  operations over the rate of their type (bf16 on the tensor cores;
  float32: narrow_in, conv_in, as three TF32 passes on the tensor cores,
  narrow_out on float32 FMA); returns (ms, "bytes" or "operations")."""
  size = torch.finfo(dtype).bits // 8
  nbytes = (b * hw * hw * (width + c) + 9 * c * width) * size
  flops = 2 * b * hw * hw * 9 * c * width
  rate = (BF16_FLOPS if dtype == torch.bfloat16
          else TF32_FLOPS / 3 if kind == "narrow_in" else F32_FLOPS)
  by_bytes, by_ops = nbytes / HBM_BYTES_PER_S, flops / rate
  return max(by_bytes, by_ops) * 1e3, ("bytes" if by_bytes >= by_ops
                                       else "operations")


def phase_narrow_conv():
  """Kernel 10 through its benchmark (`indm_torch.scripts.
  bench_narrow_conv`): the script's own run in bfloat16 (the main path,
  launches counted), then the same six cases in float32. Each cuda case
  within NARROW_RTOL of the largest value of the plain case and of
  F.conv2d. Returns {dtype name: {kind: times}} and the bfloat16 run's
  launches and largest error."""
  from indm_torch.ops import narrow_conv as nc
  from indm_torch.scripts import bench_narrow_conv as bench
  out, launches, max_err = {}, {}, 0.0
  for dtype in (torch.bfloat16, torch.float32):
    dname = str(dtype).replace("torch.", "")
    nc.reset_launches()
    if dtype == torch.bfloat16:
      with env_switch("NC_BATCH", str(TRAIN_BATCH)), \
          env_switch("NC_HW", "32"):
        rows = bench.main([])
    else:
      rows = bench.run(TRAIN_BATCH, 32, dtype, "cuda", log=log)
    launches[dname] = nc.launches
    if nc.launches == 0:
      raise AssertionError(f"the {dname} benchmark never launched kernel 10")
    tol = NARROW_RTOL[dtype]
    per_kind = {}
    for r in rows:
      for key in ("max_dev", "max_dev_direct"):
        if not (math.isfinite(r[key]) and r[key] <= tol * r["largest"]):
          raise AssertionError(f"narrow_conv {dname} {r['name']}: {key} "
                               f"{r[key]} over {tol} x {r['largest']}")
      k = per_kind.setdefault(r["kind"], {})
      k[{"plain": "plain_ms", "direct": "library_ms",
         "cuda": "ms"}[r["impl"]]] = r["ms"]
      if r["impl"] == "cuda":
        k["max_abs_err"] = r["max_dev"]
        if dtype == torch.bfloat16:
          max_err = max(max_err, r["max_dev"])
    for kind, k in per_kind.items():
      k["bound_ms"], k["bound_by"] = narrow_conv_bound_ms(
          kind, TRAIN_BATCH, 3, 32, CHAIN_WIDTH, dtype)
      log(f"narrow_conv {kind} {dname} [{TRAIN_BATCH}, 3 <-> "
          f"{CHAIN_WIDTH}, 32, 32]: "
          + " ".join(f"{n}={v:.5f}" if isinstance(v, float) else f"{n}={v}"
                     for n, v in k.items())
          + f" ({k['bound_ms'] / k['ms']:.3f} of the bound)")
    out[dname] = per_kind
  log(f"narrow_conv launches: {launches}")
  out["chain_shapes"] = narrow_conv_chain_shapes()
  return out, launches, max_err


def narrow_conv_chain_shapes():
  """Kernel 10 at the chain's shapes (batch 128): conv_in alone through
  narrow_in at both scales (3 -> 512 at 32x32, 12 -> 512 at 16x16) in
  float32 and bfloat16, and narrow_out in float32 at scale 1 (512 -> 12 at
  16x16). Each against its plain version and F.conv2d (TF32 off) within
  NARROW_RTOL, float32 conv_in also within GEMM_RTOL of F.conv2d on
  float64 inputs (the float32 contract of its 3xTF32 products), timed
  beside its bound, the plain version and F.conv2d in the same type. These
  launches compare; they are not the benchmark's. Returns {name:
  times}."""
  import torch.nn.functional as F
  from indm_torch.ops import narrow_conv as nc
  gen = torch.Generator(device="cuda").manual_seed(10)
  cases = [("narrow_in", c, hw, dtype) for dtype in (torch.float32,
                                                    torch.bfloat16)
           for c, hw in CHAIN_SCALES]
  cases.append(("narrow_out",) + CHAIN_SCALES[1] + (torch.float32,))
  out = {}
  for kind, c, hw, dtype in cases:
    dname = str(dtype).replace("torch.", "")
    cin, cout = (c, CHAIN_WIDTH) if kind == "narrow_in" else (CHAIN_WIDTH, c)
    x = torch.randn(TRAIN_BATCH, cin, hw, hw, device="cuda",
                    generator=gen).to(dtype)
    w = (torch.randn(cout, cin, 3, 3, device="cuda", generator=gen)
         / math.sqrt(9 * cin)).to(dtype)
    got = nc.narrow_conv(x, w)
    tol = NARROW_RTOL[dtype]
    errs = {}
    for name, want in (("plain", nc.narrow_conv_plain(x, w)),
                       ("F.conv2d", F.conv2d(x, w, padding=1))):
      errs[name] = (got.float() - want.float()).abs().max().item()
      big = want.float().abs().max().item()
      if not (math.isfinite(errs[name]) and errs[name] <= tol * big):
        raise AssertionError(f"narrow_conv {kind} {dname} at the chain's "
                             f"shapes {cin} -> {cout} at {hw}x{hw} against "
                             f"{name}: max abs err {errs[name]} over {tol} "
                             f"x {big}")
    if kind == "narrow_in" and dtype == torch.float32:
      want = F.conv2d(x.double(), w.double(), padding=1)
      errs["float64"] = (got.double() - want).abs().max().item()
      big = want.abs().max().item()
      if not (math.isfinite(errs["float64"])
              and errs["float64"] <= GEMM_RTOL * big):
        raise AssertionError(f"narrow_conv {kind} {dname} at the chain's "
                             f"shapes {cin} -> {cout} at {hw}x{hw}: max abs "
                             f"err {errs['float64']} over {GEMM_RTOL} x "
                             f"{big} of the float64 convolution")
      del want
    k = {"ms": cuda_ms(lambda: nc.narrow_conv(x, w), 20, 3),
         "plain_ms": cuda_ms(lambda: nc.narrow_conv_plain(x, w), 20, 3),
         "library_ms": cuda_ms(lambda: F.conv2d(x, w, padding=1), 20, 3),
         "graph_ms": graph_ms(lambda: nc.narrow_conv(x, w)),
         "library_graph_ms": graph_ms(lambda: F.conv2d(x, w, padding=1)),
         "max_abs_err": errs["plain"]}
    if "float64" in errs:
      k["float64_err"] = errs["float64"]
    k["bound_ms"], k["bound_by"] = narrow_conv_bound_ms(
        kind, TRAIN_BATCH, c, hw, CHAIN_WIDTH, dtype)
    log(f"narrow_conv {kind} {dname} [{TRAIN_BATCH}, {cin} -> {cout}, {hw}, "
        f"{hw}] (the chain's shapes): "
        + " ".join(f"{n}={v:.3e}" if n.endswith("_err") else
                   f"{n}={v:.5f}" if isinstance(v, float) else f"{n}={v}"
                   for n, v in k.items())
        + f" ({k['bound_ms'] / k['graph_ms']:.3f} of the bound; in a CUDA "
        f"graph {k['graph_ms'] / k['library_graph_ms']:.3f}x F.conv2d's "
        "time)")
    out[f"{kind}_{dname}_{cin}x{cout}_{hw}"] = k
    del x, w, got
  return out


def gemm_pairs(shape, gen):
  """The pairs of one GEMM shape (M, N, K, bt, pairs, shared weight) at
  batch TRAIN_BATCH: a of variance 1 / K (a weight's scale), b of 1."""
  m, n, k, bt, npairs, shared = shape
  return [(torch.randn((m, k) if shared else (TRAIN_BATCH, m, k),
                       device="cuda", generator=gen) / math.sqrt(k),
           torch.randn((TRAIN_BATCH, n, k) if bt else (TRAIN_BATCH, k, n),
                       device="cuda", generator=gen))
          for _ in range(npairs)]


def phase_gemm():
  """The Lipschitz net's GEMM alone (`indm_torch.ops.lipnet_gemm`) at the
  main path's four products (GEMM_SHAPES, batch 128): within GEMM_RTOL of
  the float64 product's largest value, timed beside its bound, its SIMT
  bound, the plain version and one float32 `torch.bmm` (TF32 off) over the
  pairs joined along K. Returns the times by shape, the sums over the four
  shapes, the largest error and the launches of the timed calls."""
  from indm_torch.ops import lipnet_gemm as lg
  gen = torch.Generator(device="cuda").manual_seed(11)
  by_shape, max_err, launches = {}, 0.0, 0
  for shape in GEMM_SHAPES:
    m, n, k, bt, npairs, shared = shape
    name = (f"{'kBT' if bt else 'mat_wide'} M={m} N={n} K={k} "
            f"pairs={npairs}")
    pairs = gemm_pairs(shape, gen)
    got = lg.lipnet_gemm(pairs, bt=bt)
    want = sum(torch.matmul(a.double(), (b.transpose(1, 2) if bt else
                                         b).double()) for a, b in pairs)
    err = (got.double() - want).abs().max().item()
    big = want.abs().max().item()
    if not (math.isfinite(err) and err <= GEMM_RTOL * big):
      raise AssertionError(f"lipnet_gemm {name}: max abs err {err} over "
                           f"{GEMM_RTOL} x {big} of the float64 product")
    max_err = max(max_err, err)
    # one bmm over the pairs joined along K (joined before the timing)
    if bt:
      lib_a = torch.cat([a for a, _ in pairs], 2)
      lib_b = torch.cat([b for _, b in pairs], 2).transpose(1, 2)
    else:
      lib_a = torch.cat([a.expand(TRAIN_BATCH, m, k) if shared else a
                         for a, _ in pairs], 2)
      lib_b = torch.cat([b for _, b in pairs], 1)
    lg.reset_launches()  # the timed calls count, not the check's
    t = {"ms": cuda_ms(lambda: lg.lipnet_gemm(pairs, bt=bt)),
         "plain_ms": cuda_ms(lambda: lg.lipnet_gemm_plain(pairs, bt)),
         "library_ms": cuda_ms(lambda: torch.bmm(lib_a, lib_b)),
         "max_abs_err": err}
    gemm_flops = 2 * TRAIN_BATCH * m * n * k * npairs
    nbytes = 4 * (sum(a.numel() + b.numel() for a, b in pairs)
                  + got.numel())
    t["bound_ms"], t["simt_bound_ms"], t["bound_by"] = flow_bounds(
        (0, 0, gemm_flops), nbytes)
    lib_err = (torch.bmm(lib_a, lib_b).double() - want).abs().max().item()
    log(f"lipnet_gemm {name} batch {TRAIN_BATCH} "
        f"({gemm_flops / 1e9:.1f} GFLOP): max_abs_err={err:.3e} "
        f"(largest {big:.3e}; torch.bmm {lib_err:.3e}) "
        + " ".join(f"{key}={v:.4f}" for key, v in t.items()
                   if key.endswith("_ms"))
        + f"; TFLOP/s kernel {gemm_flops / t['ms'] / 1e9:.2f}, torch.bmm "
        f"{gemm_flops / t['library_ms'] / 1e9:.2f}; "
        f"{t['bound_ms'] / t['ms']:.3f} of the bound")
    launches += lg.launches
    by_shape[name] = t
    del pairs, got, want, lib_a, lib_b
    torch.cuda.empty_cache()
  total = {key: sum(t[key] for t in by_shape.values())
           for key in ("ms", "plain_ms", "library_ms", "bound_ms",
                       "simt_bound_ms")}
  log(f"lipnet_gemm launches in the timed calls: {launches}")
  return by_shape, total, max_err, launches


def phase_gemm_bf16():
  """The bfloat16 mode's GEMM alone (`lipnet_gemm.lipnet_gemm_bf16`) at
  the main path's six products in that mode (BF16_GEMM_SHAPES, batch
  128), on bfloat16 operands: within GEMM_RTOL of the float64 product of
  the same values' largest value; timed beside its bound (one pass at the
  dense bfloat16 rate), the plain version (float32 matmul of the bfloat16 values) and one
  bfloat16 `torch.bmm` over the pairs joined along K. Returns the times by
  shape, the sums, the largest error and the launches of the timed
  calls."""
  from indm_torch.ops import lipnet_gemm as lg
  gen = torch.Generator(device="cuda").manual_seed(12)
  by_shape, max_err, launches = {}, 0.0, 0
  for shape in BF16_GEMM_SHAPES:
    m, n, k, bt, npairs, shared = shape
    name = (f"{'kBT' if bt else 'mat_wide'} M={m} N={n} K={k} "
            f"pairs={npairs}")
    pairs = [(a.bfloat16(), b.bfloat16()) for a, b in gemm_pairs(shape, gen)]
    got = lg.lipnet_gemm_bf16(pairs, bt=bt)
    want = sum(torch.matmul(a.double(), (b.transpose(1, 2) if bt else
                                         b).double()) for a, b in pairs)
    big = want.abs().max().item()
    err = (got.double() - want).abs().max().item()
    if not (math.isfinite(err) and err <= GEMM_RTOL * big):
      raise AssertionError(f"lipnet_gemm_bf16 {name}: max abs err {err} "
                           f"over {GEMM_RTOL} x {big} of the float64 "
                           "product")
    max_err = max(max_err, err)
    if bt:
      lib_a = torch.cat([a for a, _ in pairs], 2)
      lib_b = torch.cat([b for _, b in pairs], 2).transpose(1, 2)
    else:
      lib_a = torch.cat([a.expand(TRAIN_BATCH, m, k) if shared else a
                         for a, _ in pairs], 2)
      lib_b = torch.cat([b for _, b in pairs], 1)
    lg.reset_launches()  # the timed calls count, not the check's
    t = {"ms": cuda_ms(lambda: lg.lipnet_gemm_bf16(pairs, bt=bt)),
         "plain_ms": cuda_ms(lambda: lg.lipnet_gemm_bf16_plain(pairs, bt)),
         "library_ms": cuda_ms(lambda: torch.bmm(lib_a, lib_b)),
         "graph_ms": graph_ms(lambda: lg.lipnet_gemm_bf16(pairs, bt=bt)),
         "library_graph_ms": graph_ms(lambda: torch.bmm(lib_a, lib_b)),
         "max_abs_err": err}
    gemm_flops = 2 * TRAIN_BATCH * m * n * k * npairs
    nbytes = (2 * sum(a.numel() + b.numel() for a, b in pairs)
              + 4 * got.numel())
    t["bound_ms"], t["simt_bound_ms"], t["bound_by"] = flow_bounds(
        (0, 0, gemm_flops), nbytes, bf16=True)
    log(f"lipnet_gemm_bf16 {name} batch {TRAIN_BATCH} "
        f"({gemm_flops / 1e9:.1f} GFLOP): max_abs_err={err:.3e} (largest "
        f"{big:.3e}) "
        + " ".join(f"{key}={v:.4f}" for key, v in t.items()
                   if key == "ms" or key.endswith("_ms"))
        + f"; TFLOP/s kernel {gemm_flops / t['ms'] / 1e9:.2f}, torch.bmm "
        f"{gemm_flops / t['library_ms'] / 1e9:.2f}; "
        f"{t['bound_ms'] / t['ms']:.3f} of the bound ({t['bound_by']})")
    launches += lg.bf16_launches
    by_shape[name] = t
    del pairs, got, want, lib_a, lib_b
    torch.cuda.empty_cache()
  total = {key: sum(t[key] for t in by_shape.values())
           for key in ("ms", "plain_ms", "library_ms", "graph_ms",
                       "library_graph_ms", "bound_ms", "simt_bound_ms")}
  log(f"lipnet_gemm_bf16 the {len(BF16_GEMM_SHAPES)} products: "
      + " ".join(f"{key}={v:.4f}" for key, v in total.items())
      + f"; {total['ms'] / total['library_ms']:.3f}x torch.bmm's time, "
      f"in a CUDA graph {total['graph_ms'] / total['library_graph_ms']:.3f}"
      f"x; {total['bound_ms'] / total['ms']:.3f} of the bound")
  log(f"lipnet_gemm_bf16 launches in the timed calls: {launches}")
  return by_shape, total, max_err, launches


def phase_wgmma():
  """The `wgmma` GEMM alone (`lipnet_gemm.lipnet_wgmma`, the weight split
  once a call) at its two products (WGMMA_SHAPES, batch 128): within
  GEMM_RTOL of the float64 product's largest value and no further from it
  than float32 `torch.bmm` (TF32 off), timed beside its bound,
  `gemm_3xtf32_kernel` on the same inputs (`lipnet_gemm`), the plain
  version and `torch.bmm`; then the chain's product at both scales
  (`chain_product_errors`). Returns the times by shape, their sums, the
  largest error, the launches of the timed calls and the chain's
  errors."""
  from indm_torch.ops import lipnet_gemm as lg
  gen = torch.Generator(device="cuda").manual_seed(12)
  by_shape, max_err, launches = {}, 0.0, 0
  for m, n, k in WGMMA_SHAPES:
    name = f"wgmma M={m} N={n} K={k}"
    w = torch.randn(m, k, device="cuda", generator=gen) / math.sqrt(k)
    act = torch.randn(TRAIN_BATCH, k, n, device="cuda", generator=gen)
    got = lg.lipnet_wgmma(w, act)
    want = torch.matmul(w.double(), act.double())
    err = (got.double() - want).abs().max().item()
    big = want.abs().max().item()
    lib_w = w.expand(TRAIN_BATCH, m, k)
    lib_err = (torch.bmm(lib_w, act).double() - want).abs().max().item()
    mma_err = (lg.lipnet_gemm([(w, act)]).double() - want).abs().max().item()
    if not (math.isfinite(err) and err <= GEMM_RTOL * big
            and err <= lib_err):
      raise AssertionError(f"lipnet_wgmma {name}: max abs err {err} over "
                           f"{GEMM_RTOL} x {big} of the float64 product, or "
                           f"over torch.bmm's {lib_err}")
    max_err = max(max_err, err)
    lg.reset_launches()  # the timed calls count, not the check's
    t = {"ms": cuda_ms(lambda: lg.lipnet_wgmma(w, act)),
         "mma_ms": cuda_ms(lambda: lg.lipnet_gemm([(w, act)])),
         "plain_ms": cuda_ms(lambda: lg.lipnet_gemm_plain([(w, act)])),
         "library_ms": cuda_ms(lambda: torch.bmm(lib_w, act)),
         "max_abs_err": err, "bmm_err": lib_err, "mma_err": mma_err}
    launches += lg.wgmma_launches
    flops = 2 * TRAIN_BATCH * m * n * k
    nbytes = 4 * (w.numel() + act.numel() + got.numel())
    t["bound_ms"], t["simt_bound_ms"], t["bound_by"] = flow_bounds(
        (0, 0, flops), nbytes)
    log(f"lipnet_wgmma {name} batch {TRAIN_BATCH} ({flops / 1e9:.1f} "
        f"GFLOP): max_abs_err={err:.3e} (largest {big:.3e}; torch.bmm "
        f"{lib_err:.3e}, gemm_3xtf32_kernel {mma_err:.3e}) "
        + " ".join(f"{key}={v:.4f}" for key, v in t.items()
                   if key.endswith("_ms"))
        + f"; TFLOP/s wgmma {flops / t['ms'] / 1e9:.2f}, gemm_3xtf32_kernel "
        f"{flops / t['mma_ms'] / 1e9:.2f}, torch.bmm "
        f"{flops / t['library_ms'] / 1e9:.2f}; "
        f"{t['bound_ms'] / t['ms']:.3f} of the bound")
    by_shape[name] = t
    del w, act, got, want, lib_w
    torch.cuda.empty_cache()
  total = {key: sum(t[key] for t in by_shape.values())
           for key in ("ms", "mma_ms", "plain_ms", "library_ms", "bound_ms",
                       "simt_bound_ms")}
  log(f"lipnet_wgmma launches in the timed calls: {launches}")
  chain = chain_product_errors(gen)
  return (by_shape, total, max(max_err, *(e["err"] for e in chain.values())),
          launches, chain)


def chain_product_errors(gen):
  """The chain's product on the `wgmma` GEMM at both scales (K = 512, N =
  1024 and 256, batch 128): W1^T (the transposed weight, of variance
  1 / K) on t1 = D_out * conv-like activations (a cos(2 pi a) diagonal
  times unit normals), as each term of kernels 7 and 8 runs it, within
  GEMM_RTOL of the float64 product's largest value and no further from it
  than float32 `torch.bmm` (TF32 off). Returns {scale: errors}."""
  from indm_torch.ops import lipnet_gemm as lg
  out = {}
  for scale, (_, hw) in enumerate(CHAIN_SCALES):
    w1 = torch.randn(CHAIN_WIDTH, CHAIN_WIDTH, device="cuda",
                     generator=gen) / math.sqrt(CHAIN_WIDTH)
    w1t = w1.t().contiguous()
    t1 = torch.cos(2 * math.pi * torch.rand(
        TRAIN_BATCH, CHAIN_WIDTH, hw * hw, device="cuda", generator=gen)) \
        * torch.randn(TRAIN_BATCH, CHAIN_WIDTH, hw * hw, device="cuda",
                      generator=gen)
    want = torch.matmul(w1t.double(), t1.double())
    err = (lg.lipnet_wgmma(w1t, t1).double() - want).abs().max().item()
    big = want.abs().max().item()
    lib_err = (torch.bmm(w1t.expand(TRAIN_BATCH, -1, -1), t1).double()
               - want).abs().max().item()
    what = (f"the chain's product W1^T t1 on the wgmma GEMM, scale {scale} "
            f"(K = {CHAIN_WIDTH}, N = {hw * hw}, batch {TRAIN_BATCH})")
    if not (math.isfinite(err) and err <= GEMM_RTOL * big
            and err <= lib_err):
      raise AssertionError(f"{what}: max abs err {err} over {GEMM_RTOL} x "
                           f"{big} of the float64 product, or over "
                           f"torch.bmm's {lib_err}")
    log(f"{what}: max_abs_err={err:.3e} (largest {big:.3e}, "
        f"{err / big:.3e} of it; torch.bmm {lib_err:.3e})")
    out[scale] = {"err": err, "largest": big, "bmm_err": lib_err}
    del w1, w1t, t1, want
    torch.cuda.empty_cache()
  return out


def gemm_counts_since(before):
  """The three GEMMs' launches since `before` (lipnet_gemm.
  device_gemm_launches: counted on the host where each library launches
  them)."""
  from indm_torch.ops import lipnet_gemm as lg
  now = lg.device_gemm_launches()
  return {k: now[k] - before[k] for k in now}


def fwd_split(call, expect, what, gemm="wgmma"):
  """One forward call of kernel 3 or 5, after one call to warm up: its
  512-wide products must be `expect` launches of the GEMM `gemm` (the
  `wgmma` GEMM in float32, "gemm_bf16" in bfloat16) and none of the other
  two (the libraries' launch counts); under torch.profiler, the device
  time per launch of a chain term's three launches (conv_in, the GEMM,
  conv_out, each with the chain's epilogue) and their sum. Returns those
  and the launches."""
  from torch.profiler import ProfilerActivity, profile

  from indm_torch.ops import lipnet_gemm as lg
  kernel = GEMM_KERNELS[gemm]
  term_launches = (("conv_in", ("conv_in_kernel", "lipnet::DMul")),
                   (gemm, (kernel, "lipnet::DMul")),
                   ("conv_out", ("conv_out_kernel", "ChainOut")))
  call()
  torch.cuda.synchronize()
  for _ in range(3):
    before = lg.device_gemm_launches()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as p:
      call()
      torch.cuda.synchronize()
    counts = gemm_counts_since(before)
    kernels = [e for e in p.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    if kernels:
      break
  want = {**{k: 0 for k in GEMM_KERNELS}, gemm: expect}
  if counts != want:
    raise AssertionError(f"{what}: GEMM launches {counts}, expected "
                         f"{want}")

  def pick(keys):
    return [e for e in kernels if all(k in e.key for k in keys)]

  seen = {name: sum(e.count for e in pick((name,)))
          for name in GEMM_KERNELS.values()}
  split = {}
  for label, keys in term_launches:
    mine = pick(keys)
    n = sum(e.count for e in mine)
    split[label] = (sum(e.self_device_time_total for e in mine) / 1e3 / n
                    if n else math.nan)
  split["term"] = sum(split[label] for label, _ in term_launches)
  log(f"{what}: {counts[gemm]} {kernel} launches, none of the other GEMMs "
      f"(the profiler saw {seen}); a chain term's device ms by launch "
      "(torch.profiler, per launch it saw) "
      + " ".join(f"{k}={v:.4f}" for k, v in split.items()))
  split[f"{gemm}_launches"] = counts[gemm]
  split["profiler_saw"] = seen
  return split


def fused_inputs(b, c, hw, gen, width=CHAIN_WIDTH):
  """The fused pair's inputs: x, vareps, the cotangents, normalised-weight
  stand-ins of variance 1 / fan_in (every chain term of order one),
  biases and hp."""
  def randn(*shape):
    return torch.randn(shape, device="cuda", generator=gen)

  ws = [randn(*shape) / math.sqrt(shape[1] * shape[2] * shape[3])
        for shape in ((width, c, 3, 3), (width, width, 1, 1),
                      (c, width, 3, 3))]
  return dict(x=randn(b, c, hw, hw), eps=randn(b, c, hw, hw),
              ybar=randn(b, c, hw, hw), lbar=randn(b), ws=ws,
              bs=[0.1 * randn(width), 0.1 * randn(width), 0.1 * randn(c)],
              hp=0.3 * randn(b, width))


def check_outputs(what, names, got, want):
  """Each output within FUSED_RTOL of its largest value; returns the
  largest absolute error."""
  worst = 0.0
  for name, g, w in zip(names, got, want):
    err = (g - w).abs().max().item()
    big = w.abs().max().item()
    if not (math.isfinite(err) and err <= FUSED_RTOL * big):
      raise AssertionError(f"{what} {name}: max abs err {err} over "
                           f"{FUSED_RTOL} x {big}")
    worst = max(worst, err)
  return worst


GRAD_NAMES = ("xbar", "w0g", "w1g", "w2g", "b0g", "b1g", "b2g", "hbar")


def pair_checked(d, n, preact, dtype, what):
  """Kernels 3 and 4 on `fused_inputs` d at the draw n in `dtype`, held
  against their plain versions (float32: check_outputs; bfloat16: the
  exact plain versions, check_bf16_outputs); kernel 4 twice gives the same
  bits. Returns their arguments and the largest errors, forward and
  backward."""
  from indm_torch.flows.resflow import OFFSET_TRAIN, RCDF_TRAIN
  from indm_torch.ops import fused_block as fb
  args = (d["x"], *d["ws"], *d["bs"], d["hp"], d["eps"], n, OFFSET_TRAIN,
          RCDF_TRAIN, preact)
  out = fb.fused_block_fwd(*args, dtype)
  bargs = (d["x"], d["eps"], out[2], d["ybar"], d["lbar"], *d["ws"],
           *d["bs"][:2], d["hp"], preact)
  grads = fb.fused_block_bwd(*bargs, dtype)
  if dtype == torch.bfloat16:
    e_f = check_bf16_outputs(
        f"fused_block_fwd {what}", ("y", "logdet", "u"), out,
        exact(fb.fused_block_fwd_plain, *args, compute_dtype=dtype),
        exact(fb.fused_block_fwd_plain, *args))
    e_b = check_bf16_outputs(
        f"fused_block_bwd {what}", GRAD_NAMES, grads,
        exact(fb.fused_block_bwd_plain, *bargs, compute_dtype=dtype),
        exact(fb.fused_block_bwd_plain, *bargs))
  else:
    e_f = check_outputs(f"fused_block_fwd {what}", ("y", "logdet", "u"),
                        out, fb.fused_block_fwd_plain(*args))
    e_b = check_outputs(f"fused_block_bwd {what}", GRAD_NAMES, grads,
                        fb.fused_block_bwd_plain(*bargs))
  if not all(torch.equal(a, b) for a, b in
             zip(grads, fb.fused_block_bwd(*bargs, dtype))):
    raise AssertionError(f"fused_block_bwd {what}: two runs differ")
  return args, bargs, e_f, e_b


def stack_checked(blocks, n_all, dtype, what):
  """Kernels 5 and 6 on the stack of `blocks` (`fused_inputs` each; x,
  ybar and lbar the first's) with the draws n_all in `dtype`, held against
  their plain versions (float32: check_outputs; bfloat16: the exact plain
  versions, the forward block by block on its own carry) and against
  kernels 3 and 4 looped over the same blocks (the same bits); kernel 6
  twice gives the same bits. Returns their arguments and the largest
  errors, forward and backward."""
  from indm_torch.flows.resflow import OFFSET_TRAIN, RCDF_TRAIN
  from indm_torch.ops import fused_block as fb
  from indm_torch.ops import fused_stack as fs

  def stacked(get):
    return torch.stack([get(d) for d in blocks])

  ws = [stacked(lambda d, k=k: d["ws"][k]) for k in range(3)]
  bs = [stacked(lambda d, k=k: d["bs"][k]) for k in range(3)]
  hp_all, eps_all = stacked(lambda d: d["hp"]), stacked(lambda d: d["eps"])
  x, ybar, lbar = blocks[0]["x"], blocks[0]["ybar"], blocks[0]["lbar"]
  args = (x, *ws, *bs, hp_all, eps_all, n_all, OFFSET_TRAIN, RCDF_TRAIN,
          True)
  out = fs.fused_stack_fwd(*args, dtype)
  y, ld_all, u_all, xs_all = out
  bargs = (xs_all, eps_all, u_all, ybar, lbar, *ws, *bs[:2], hp_all, True)
  grads = fs.fused_stack_bwd(*bargs, dtype)
  if dtype == torch.bfloat16:
    e_f = check_bf16_outputs(
        f"fused_stack_fwd {what}", ("ys_all", "ld_all", "u_all"),
        (torch.cat([xs_all[1:], y[None]]), ld_all, u_all),
        exact_stack_fwd(out, args, dtype), exact_stack_fwd(out, args))
    e_b = check_bf16_outputs(
        f"fused_stack_bwd {what}", GRAD_NAMES, grads,
        exact(fs.fused_stack_bwd_plain, *bargs, compute_dtype=dtype),
        exact(fs.fused_stack_bwd_plain, *bargs))
  else:
    e_f = check_outputs(f"fused_stack_fwd {what}",
                        ("y", "ld_all", "u_all", "xs_all"), out,
                        fs.fused_stack_fwd_plain(*args))
    e_b = check_outputs(f"fused_stack_bwd {what}", GRAD_NAMES, grads,
                        fs.fused_stack_bwd_plain(*bargs))
  if not all(torch.equal(a, b) for a, b in
             zip(grads, fs.fused_stack_bwd(*bargs, dtype))):
    raise AssertionError(f"fused_stack_bwd {what}: two runs differ")
  same, xj = [], x
  for j, d in enumerate(blocks):
    same.append(torch.equal(xs_all[j], xj))
    xj, ld, u = fb.fused_block_fwd(xj, *d["ws"], *d["bs"], d["hp"], d["eps"],
                                   n_all[j], OFFSET_TRAIN, RCDF_TRAIN, True,
                                   dtype)
    same += [torch.equal(ld_all[j], ld), torch.equal(u_all[j], u)]
  same.append(torch.equal(y, xj))
  cot = ybar
  for j in reversed(range(len(blocks))):
    d = blocks[j]
    cot, *per_block = fb.fused_block_bwd(
        xs_all[j], d["eps"], u_all[j], cot, lbar, *d["ws"], *d["bs"][:2],
        d["hp"], True, dtype)
    same += [torch.equal(s_[j], g) for s_, g in zip(grads[1:], per_block)]
  same.append(torch.equal(grads[0], cot))
  if not all(same):
    raise AssertionError(f"fused stack {what}: {same.count(False)} outputs "
                         "differ from kernels 3 and 4 looped")
  return args, bargs, e_f, e_b


def phase_fused():
  """Kernels 3 and 4 against their plain versions; the chain route and the
  fused route for the same `IResBlock`. Returns, per (scale, preact),
  times {route: (ms at n = 0, ms per extra n)}, the largest errors and,
  per scale, kernel 3's GEMM launches and a chain term's device time by
  launch (`fwd_split`, pre-activated, n = SPLIT_N)."""
  from indm_torch.flows.resflow import OFFSET_TRAIN, RCDF_TRAIN, IResBlock
  from indm_torch.ops import fused_block as fb
  gen = torch.Generator(device="cuda").manual_seed(6)
  fits, max_err, splits = {}, {"fwd": 0.0, "bwd": 0.0}, {}
  n_lo, n_hi = min(CHAIN_NS), max(CHAIN_NS)
  for scale, (c, hw) in enumerate(CHAIN_SCALES):
    flops = chain_flops_per_term(TRAIN_BATCH, c, hw)
    for preact in (False, True):
      d = fused_inputs(TRAIN_BATCH, c, hw, gen)
      t = collections.defaultdict(dict)
      for n in CHAIN_NS:
        args, bargs, err, errb = pair_checked(
            d, n, preact, torch.float32,
            f"scale {scale} preact {preact} n={n}")
        max_err["fwd"] = max(max_err["fwd"], err)
        max_err["bwd"] = max(max_err["bwd"], errb)
        t["fwd"][n] = cuda_ms(lambda: fb.fused_block_fwd(*args), 3, 1)
        t["fwd_plain"][n] = cuda_ms(lambda: fb.fused_block_fwd_plain(*args),
                                    3, 1)
        bound, simt, _ = flow_bounds(
            scaled(flops, n + OFFSET_TRAIN + 2),
            flow_bytes("fwd", TRAIN_BATCH, c, hw))
        log(f"fused_block_fwd [{TRAIN_BATCH},{c},{hw},{hw}] width "
            f"{CHAIN_WIDTH} preact={preact} n={n}: max_abs_err={err:.3e} "
            f"ms={t['fwd'][n]:.4f} plain_ms={t['fwd_plain'][n]:.4f} "
            f"bound_ms={bound:.4f} simt_bound_ms={simt:.4f} "
            f"({bound / t['fwd'][n]:.3f} of the bound); "
            f"fused_block_bwd max_abs_err={errb:.3e}")
      if preact:
        sargs = (d["x"], *d["ws"], *d["bs"], d["hp"], d["eps"], SPLIT_N,
                 OFFSET_TRAIN, RCDF_TRAIN, True)
        splits[f"scale{scale}"] = fwd_split(
            lambda: fb.fused_block_fwd(*sargs), SPLIT_N + OFFSET_TRAIN + 2,
            f"fused_block_fwd [{TRAIN_BATCH},{c},{hw},{hw}] preact=True "
            f"n={SPLIT_N}")
        del sargs
      t["bwd"][n_lo] = t["bwd"][n_hi] = cuda_ms(
          lambda: fb.fused_block_bwd(*bargs), 3, 1)
      t["bwd_plain"][n_lo] = t["bwd_plain"][n_hi] = cuda_ms(
          lambda: fb.fused_block_bwd_plain(*bargs), 3, 1)
      bound, simt, _ = flow_bounds(
          fused_bwd_flops(TRAIN_BATCH, c, hw, preact),
          flow_bytes("bwd", TRAIN_BATCH, c, hw))
      log(f"fused_block_bwd [{TRAIN_BATCH},{c},{hw},{hw}] preact={preact}: "
          f"ms={t['bwd'][n_lo]:.4f} plain_ms={t['bwd_plain'][n_lo]:.4f} "
          f"bound_ms={bound:.4f} simt_bound_ms={simt:.4f} "
          f"({bound / t['bwd'][n_lo]:.3f} of the bound)")
      del d, bargs, args
      torch.cuda.empty_cache()

      # the same block through the flow's two routes, h of width 64
      block = IResBlock(c, CHAIN_WIDTH, cond_dim=FUSED_COND, preact=preact,
                        generator=gen, device="cuda")
      x = torch.randn(TRAIN_BATCH, c, hw, hw, device="cuda", generator=gen)
      x.requires_grad_()
      h = torch.randn(TRAIN_BATCH, FUSED_COND, device="cuda",
                      generator=gen).requires_grad_()
      eps, ybar = (torch.randn_like(x) for _ in range(2))
      lbar = torch.randn(TRAIN_BATCH, device="cuda", generator=gen)
      for route, fused in (("chain_route", False), ("block", True)):
        block.fused_block = fused
        with stack_switch("0"):
          for n in (n_lo, n_hi):
            fwd = cuda_ms(lambda: block(x, h, eps, n), 3, 1)
            both = cuda_ms(lambda: torch.autograd.backward(
                block(x, h, eps, n), (ybar, lbar)), 3, 1)
            t[f"{route}_fwd"][n], t[f"{route}_bwd"][n] = fwd, both - fwd
        log(f"IResBlock [{TRAIN_BATCH},{c},{hw},{hw}] preact={preact} "
            f"{'fused route' if fused else 'chain route'}: forward ms "
            f"n={n_lo} {t[f'{route}_fwd'][n_lo]:.3f} n={n_hi} "
            f"{t[f'{route}_fwd'][n_hi]:.3f}; backward ms "
            f"{t[f'{route}_bwd'][n_hi]:.3f}")
      del block, x, h, eps, ybar
      torch.cuda.empty_cache()
      fits[(scale, preact)] = {
          k: (v[n_lo], (v[n_hi] - v[n_lo]) / (n_hi - n_lo))
          for k, v in t.items()}
  return fits, max_err, splits


def f64(a):
  """a in float64: a tensor, or each tensor of a list or tuple."""
  if torch.is_tensor(a):
    return a.double()
  if isinstance(a, (list, tuple)):
    return type(a)(f64(t) for t in a)
  return a


def exact(plain, *args, compute_dtype=torch.float32):
  """A plain version of kernels 3-8 on `args` in float64: the rounding
  points of `compute_dtype` kept (`fused_block.rounder`), every other sum
  exact. The bfloat16 modes are held against it, since float32 cuDNN convs
  (TF32 off) may run as FFTs, whose error reaches a good part of the
  float32-bfloat16 gap at full width."""
  return plain(*(f64(a) for a in args), compute_dtype)


def exact_stack_fwd(out, args, compute_dtype=torch.float32):
  """Kernel 5's (y, ld_all, u_all) exactly, block by block: block j's plain
  version in float64 (`exact`) on the kernel's own carry xs_all[j], as
  the backward's references take the kernel's xs_all. Returns (ys_all,
  ld_all, u_all), ys_all[j] block j's output. Against a stack in float64
  from x alone, a carry that rounds to the other side of a bfloat16 value
  in one block differs by that value's ulp in every later block, as any
  two implementations whose float32 sums run in another order do."""
  from indm_torch.ops import fused_block as fb
  _, w0s, w1s, w2s, b0s, b1s, b2s, hp_all, eps_all, n_all, *rest = args
  per = [exact(fb.fused_block_fwd_plain, out[3][j], w0s[j], w1s[j], w2s[j],
               b0s[j], b1s[j], b2s[j], None if hp_all is None else hp_all[j],
               eps_all[j], n, *rest, compute_dtype=compute_dtype)
         for j, n in enumerate(n_all)]
  return [torch.stack(t) for t in zip(*per)]


def check_bf16_outputs(what, names, got, want16, want32):
  """The bfloat16 mode against the exact plain bfloat16 and float32
  versions on the same inputs (`exact`), at the CPU test's tolerance
  (tests/test_torch_bf16.py): each output within BF16_RTOL of the float32
  version's largest value and closer to the plain bfloat16 version than
  half of its gap to the float32 one, by the largest element. Logs each
  output's error over its gap; returns the largest absolute error."""
  worst, shares = 0.0, []
  for name, g, r, f in zip(names, got, want16, want32):
    if r is None:
      continue
    err = (g - r).abs().max().item()
    gap = (f - r).abs().max().item()
    big = f.abs().max().item()
    if not (math.isfinite(err) and err <= BF16_RTOL * big
            and err < 0.5 * gap):
      raise AssertionError(
          f"{what} {name}: max abs err {err}, largest value {big}; the "
          f"plain float32 version is {gap} from the plain bfloat16 one")
    shares.append(f"{name} {err / gap:.3f}")
    worst = max(worst, err)
  log(f"{what}: max abs err over the float32-bfloat16 gap: "
      + ", ".join(shares))
  return worst


def check_bf16_chain(what, got, want16, want32, plain):
  """Kernels 7 and 8 in bfloat16 against the exact plain bfloat16 and
  float32 versions on the same inputs (`exact`). Each term rounds its
  three launches' float32 sums to bfloat16; where the kernel's order of a
  sum and the exact one round to neighbouring bfloat16 values, the term
  differs by a whole step there, and later terms carry and multiply such
  differences: over 8 terms the root mean square difference grows to about
  0.7 of the bfloat16-float32 gap, for the plain version summing in
  float32 on the card (`plain`) as for the kernel (PERF.md), and
  the largest difference reaches the largest gap. So the largest error is
  held within BF16_RTOL of the float32 version's largest value, and the
  root mean square error under the root mean square gap (nearer the
  bfloat16 chain than the float32 chain is) and at most the plain
  version's own. Logs the shares; returns the largest absolute error."""
  def rms(t):
    return t.double().pow(2).mean().sqrt().item()

  err, gap = (got - want16).abs().max().item(), (want32 - want16).abs().max(
      ).item()
  r_err, r_gap, r_plain = (rms(got - want16), rms(want32 - want16),
                           rms(plain - want16))
  big = want32.abs().max().item()
  log(f"{what}: max abs err {err:.3e} over the largest gap {gap:.3e}: "
      f"{err / gap:.3f}; rms err over the rms gap {r_err / r_gap:.4f} (the "
      f"plain version in float32 sums {r_plain / r_gap:.4f})")
  if not (math.isfinite(err) and err <= BF16_RTOL * big and r_err < r_gap
          and r_err <= r_plain):
    raise AssertionError(f"{what}: max abs err {err}, largest value {big}, "
                         f"largest gap {gap}; rms err {r_err}, rms gap "
                         f"{r_gap}, the plain version's rms err {r_plain}")
  return err


def phase_fused_bf16():
  """Kernels 3 and 4 in bfloat16 (`compute_dtype=torch.bfloat16`, the
  mode of `flow.logdet_bf16` and `flow.mixed_precision`) against their
  exact plain bfloat16 versions (check_bf16_outputs) at both full-width
  flow scales, batch 128,
  pre-activated and not, n in CHAIN_NS (phase 8's draws), timed beside
  their bound (all their work as one pass at the dense bfloat16 rate)
  and the plain versions; kernel 4 twice gives the same bits. Returns,
  per (scale, preact), {"fwd", "fwd_plain", "bwd", "bwd_plain": (ms at
  n = 0, ms per extra n)}, the largest errors and, per scale, kernel 3's
  launches of the bfloat16 GEMM (n + 4, none of the others) and a chain
  term's device time by launch."""
  from indm_torch.flows.resflow import OFFSET_TRAIN, RCDF_TRAIN
  from indm_torch.ops import fused_block as fb
  bf = torch.bfloat16
  gen = torch.Generator(device="cuda").manual_seed(6)
  fits, max_err, splits = {}, {"fwd": 0.0, "bwd": 0.0}, {}
  n_lo, n_hi = min(CHAIN_NS), max(CHAIN_NS)
  for scale, (c, hw) in enumerate(CHAIN_SCALES):
    flops = chain_flops_per_term(TRAIN_BATCH, c, hw)
    for preact in (False, True):
      d = fused_inputs(TRAIN_BATCH, c, hw, gen)
      t = collections.defaultdict(dict)
      for n in CHAIN_NS:
        args, bargs, err, errb = pair_checked(
            d, n, preact, bf, f"bf16 scale {scale} preact {preact} n={n}")
        max_err["fwd"] = max(max_err["fwd"], err)
        max_err["bwd"] = max(max_err["bwd"], errb)
        t["fwd"][n] = cuda_ms(lambda: fb.fused_block_fwd(*args, bf), 3, 1)
        t["fwd_plain"][n] = cuda_ms(
            lambda: fb.fused_block_fwd_plain(*args, bf), 2, 1)
        bound, _, _ = flow_bounds(
            scaled(flops, n + OFFSET_TRAIN + 2),
            flow_bytes("fwd", TRAIN_BATCH, c, hw, wsize=2), bf16=True)
        log(f"fused_block_fwd bfloat16 [{TRAIN_BATCH},{c},{hw},{hw}] width "
            f"{CHAIN_WIDTH} preact={preact} n={n}: max_abs_err={err:.3e} "
            f"ms={t['fwd'][n]:.4f} plain_ms={t['fwd_plain'][n]:.4f} "
            f"bound_ms={bound:.4f} ({bound / t['fwd'][n]:.3f} of the "
            f"bound); fused_block_bwd bfloat16 max_abs_err={errb:.3e}")
      if preact:
        sargs = (d["x"], *d["ws"], *d["bs"], d["hp"], d["eps"], SPLIT_N,
                 OFFSET_TRAIN, RCDF_TRAIN, True)
        splits[f"scale{scale}"] = fwd_split(
            lambda: fb.fused_block_fwd(*sargs, bf),
            SPLIT_N + OFFSET_TRAIN + 2,
            f"fused_block_fwd bfloat16 [{TRAIN_BATCH},{c},{hw},{hw}] "
            f"preact=True n={SPLIT_N}", gemm="gemm_bf16")
        del sargs
      t["bwd"][n_lo] = t["bwd"][n_hi] = cuda_ms(
          lambda: fb.fused_block_bwd(*bargs, bf), 3, 1)
      t["bwd_plain"][n_lo] = t["bwd_plain"][n_hi] = cuda_ms(
          lambda: fb.fused_block_bwd_plain(*bargs, bf), 2, 1)
      bound, _, _ = flow_bounds(
          fused_bwd_flops(TRAIN_BATCH, c, hw, preact),
          flow_bytes("bwd", TRAIN_BATCH, c, hw, wsize=2), bf16=True)
      log(f"fused_block_bwd bfloat16 [{TRAIN_BATCH},{c},{hw},{hw}] "
          f"preact={preact}: ms={t['bwd'][n_lo]:.4f} "
          f"plain_ms={t['bwd_plain'][n_lo]:.4f} bound_ms={bound:.4f} "
          f"({bound / t['bwd'][n_lo]:.3f} of the bound)")
      fits[(scale, preact)] = {
          k: (v[n_lo], (v[n_hi] - v[n_lo]) / (n_hi - n_lo))
          for k, v in t.items()}
      del d, bargs, args
      torch.cuda.empty_cache()
  return fits, max_err, splits


@contextlib.contextmanager
def env_switch(name, value):
  """The environment variable `name` set to `value`, or unset for None."""
  old = os.environ.pop(name, None)
  if value is not None:
    os.environ[name] = value
  try:
    yield
  finally:
    os.environ.pop(name, None)
    if old is not None:
      os.environ[name] = old


def stack_switch(value):
  """INDM_FUSED_STACK set to `value` ("0": every iResBlock through the
  fused pair), or unset for None (the stacks through the stack kernels)."""
  return env_switch("INDM_FUSED_STACK", value)


def chain_switch(value):
  """INDM_FUSED_CHAIN set to `value` ("1": on the chain route, every
  block's chain through kernel 8), or unset for None (kernel 7)."""
  return env_switch("INDM_FUSED_CHAIN", value)


def phase_fused_stack():
  """Kernels 5 and 6 against their plain versions and against kernels 3
  and 4 looped over the same blocks (the same bits), at both full-width
  stacks. Returns the times of one call per scale and their sums (one
  training step's two calls of each), the largest errors and, per stack,
  the forward's GEMM launches and a chain term's device time by launch
  (`fwd_split`)."""
  import numpy as np
  from indm_torch.flows.resflow import LAMB, OFFSET_TRAIN, RCDF_TRAIN
  from indm_torch.ops import fused_block as fb
  from indm_torch.ops import fused_stack as fs
  gen = torch.Generator(device="cuda").manual_seed(7)
  host_rng = np.random.default_rng(7)
  total, max_err = collections.defaultdict(float), {"fwd": 0.0, "bwd": 0.0}
  splits = {}
  for nb, c, hw in STACK_SCALES:
    blocks = [fused_inputs(TRAIN_BATCH, c, hw, gen) for _ in range(nb)]
    n_all = [int(host_rng.poisson(LAMB)) for _ in range(nb)]
    what = f"{nb} blocks [{TRAIN_BATCH},{c},{hw},{hw}] n={n_all}"
    args, bargs, err, errb = stack_checked(blocks, n_all, torch.float32,
                                           what)
    max_err["fwd"], max_err["bwd"] = (max(max_err["fwd"], err),
                                      max(max_err["bwd"], errb))
    x, ybar, lbar = blocks[0]["x"], blocks[0]["ybar"], blocks[0]["lbar"]
    xs_all, u_all = bargs[0], bargs[2]
    splits[f"{nb}_blocks"] = fwd_split(
        lambda: fs.fused_stack_fwd(*args),
        sum(n + OFFSET_TRAIN + 2 for n in n_all), f"fused_stack_fwd {what}")

    xg = x.clone().requires_grad_()

    def pair(backward):
      yy, ld = xg, 0.0
      for j, d in enumerate(blocks):
        yy, ld_j = fb.FusedBlockFn.apply(yy, *d["ws"], *d["bs"], d["hp"],
                                         d["eps"], n_all[j], OFFSET_TRAIN,
                                         RCDF_TRAIN, True)
        ld = ld + ld_j
      if backward:
        torch.autograd.backward((yy, ld), (ybar, lbar))

    def stack_fn(backward):
      yy, ld = fs.FusedStackFn.apply(xg, *args[1:])
      if backward:
        torch.autograd.backward((yy, ld), (ybar, lbar))

    t = {"fwd": cuda_ms(lambda: fs.fused_stack_fwd(*args), 3, 1),
         "bwd": cuda_ms(lambda: fs.fused_stack_bwd(*bargs), 3, 1),
         "fwd_plain": cuda_ms(lambda: fs.fused_stack_fwd_plain(*args), 2, 1),
         "bwd_plain": cuda_ms(lambda: fs.fused_stack_bwd_plain(*bargs), 2,
                              1),
         "fn_fwd": cuda_ms(lambda: stack_fn(False), 3, 1),
         "fn_both": cuda_ms(lambda: stack_fn(True), 3, 1),
         "pair_fwd": cuda_ms(lambda: pair(False), 3, 1),
         "pair_both": cuda_ms(lambda: pair(True), 3, 1)}
    t["fn_bwd"] = t.pop("fn_both") - t["fn_fwd"]
    t["pair_bwd"] = t.pop("pair_both") - t["pair_fwd"]

    def pair_fwd_calls():
      xj = x
      for j, d in enumerate(blocks):
        xj = fb.fused_block_fwd(xj, *d["ws"], *d["bs"], d["hp"], d["eps"],
                                n_all[j], OFFSET_TRAIN, RCDF_TRAIN, True)[0]

    def pair_bwd_calls():
      cot = ybar
      for j in reversed(range(nb)):
        d = blocks[j]
        cot = fb.fused_block_bwd(xs_all[j], d["eps"], u_all[j], cot, lbar,
                                 *d["ws"], *d["bs"][:2], d["hp"], True)[0]

    # the host's cost of enqueuing each route's calls
    t.update(host_fwd=host_ms(lambda: fs.fused_stack_fwd(*args)),
             host_bwd=host_ms(lambda: fs.fused_stack_bwd(*bargs)),
             host_pair_fwd=host_ms(pair_fwd_calls),
             host_pair_bwd=host_ms(pair_bwd_calls))
    flops = chain_flops_per_term(TRAIN_BATCH, c, hw)
    t["fwd_bound"], t["fwd_simt_bound"], _ = flow_bounds(
        scaled(flops, sum(n + OFFSET_TRAIN + 2 for n in n_all)),
        flow_bytes("stack_fwd", TRAIN_BATCH, c, hw, nb=nb))
    t["bwd_bound"], t["bwd_simt_bound"], _ = flow_bounds(
        scaled(fused_bwd_flops(TRAIN_BATCH, c, hw, True), nb),
        flow_bytes("stack_bwd", TRAIN_BATCH, c, hw, nb=nb))
    log(f"fused_stack {what}: max_abs_err fwd={err:.3e} bwd={errb:.3e}; "
        "the same bits as kernels 3 and 4 looped; ms "
        + " ".join(f"{k}={v:.3f}" for k, v in t.items())
        + f"; of the bound fwd {t['fwd_bound'] / t['fwd']:.3f} "
        f"bwd {t['bwd_bound'] / t['bwd']:.3f}")
    for k, v in t.items():
      total[k] += v
    del blocks, bargs, args, xg, xs_all, u_all
    torch.cuda.empty_cache()
  log("fused_stack per training step (both scales, one call each): "
      + " ".join(f"{k}={v:.3f}" for k, v in total.items()))
  return dict(total), max_err, splits


def phase_fused_stack_bf16():
  """Kernels 5 and 6 in bfloat16 against their exact plain bfloat16
  versions (check_bf16_outputs; the forward block by block on its own
  carry, `exact_stack_fwd`) and against kernels 3 and 4 in bfloat16
  looped over the same blocks (the same bits, which
  carries 8b's per-element check over to the stack), at phase 9b's
  stacks, inputs and draws; timed beside their bound (all their work as
  one bfloat16 pass) and the plain versions. Returns the times of one
  call per scale summed over the scales (one training step's calls), the
  largest errors and, per stack, the forward's bfloat16 GEMM launches and
  a chain term's device time by launch."""
  import numpy as np
  from indm_torch.flows.resflow import LAMB, OFFSET_TRAIN
  from indm_torch.ops import fused_stack as fs
  bf = torch.bfloat16
  gen = torch.Generator(device="cuda").manual_seed(7)
  host_rng = np.random.default_rng(7)
  total, max_err = collections.defaultdict(float), {"fwd": 0.0, "bwd": 0.0}
  splits = {}
  for nb, c, hw in STACK_SCALES:
    blocks = [fused_inputs(TRAIN_BATCH, c, hw, gen) for _ in range(nb)]
    n_all = [int(host_rng.poisson(LAMB)) for _ in range(nb)]
    what = f"bfloat16 {nb} blocks [{TRAIN_BATCH},{c},{hw},{hw}] n={n_all}"
    args, bargs, err, errb = stack_checked(blocks, n_all, bf, what)
    max_err["fwd"], max_err["bwd"] = (max(max_err["fwd"], err),
                                      max(max_err["bwd"], errb))
    splits[f"{nb}_blocks"] = fwd_split(
        lambda: fs.fused_stack_fwd(*args, bf),
        sum(n + OFFSET_TRAIN + 2 for n in n_all), f"fused_stack_fwd {what}",
        gemm="gemm_bf16")
    t = {"fwd": cuda_ms(lambda: fs.fused_stack_fwd(*args, bf), 3, 1),
         "bwd": cuda_ms(lambda: fs.fused_stack_bwd(*bargs, bf), 3, 1),
         "fwd_plain": cuda_ms(lambda: fs.fused_stack_fwd_plain(*args, bf),
                              2, 1),
         "bwd_plain": cuda_ms(lambda: fs.fused_stack_bwd_plain(*bargs, bf),
                              2, 1)}
    flops = chain_flops_per_term(TRAIN_BATCH, c, hw)
    t["fwd_bound"], _, _ = flow_bounds(
        scaled(flops, sum(n + OFFSET_TRAIN + 2 for n in n_all)),
        flow_bytes("stack_fwd", TRAIN_BATCH, c, hw, nb=nb, wsize=2), True)
    t["bwd_bound"], _, _ = flow_bounds(
        scaled(fused_bwd_flops(TRAIN_BATCH, c, hw, True), nb),
        flow_bytes("stack_bwd", TRAIN_BATCH, c, hw, nb=nb, wsize=2), True)
    log(f"fused_stack {what}: max_abs_err fwd={err:.3e} bwd={errb:.3e}; "
        "the same bits as kernels 3 and 4 in bfloat16 looped; ms "
        + " ".join(f"{k}={v:.3f}" for k, v in t.items())
        + f"; of the bound fwd {t['fwd_bound'] / t['fwd']:.3f} "
        f"bwd {t['bwd_bound'] / t['bwd']:.3f}")
    for k, v in t.items():
      total[k] += v
    del blocks, bargs, args
    torch.cuda.empty_cache()
  log("fused_stack bfloat16 per training step (both scales, one call "
      "each): " + " ".join(f"{k}={v:.3f}" for k, v in total.items()))
  return dict(total), max_err, splits


def phase_group_norm_backward(shapes,
                              dtypes=(torch.float32, torch.bfloat16)):
  """The backward kernel pair against its plain version at the score
  net's (shape, act) pairs at batch 128 in each of `dtypes`, timed by
  `timed` beside its bound, the plain version and the library's backward
  (autograd, and its aten calls in a graph); returns the float32 totals
  over one training step's 95 launches, the largest float32 dx error and
  the rows by shape and type (with the plan: threads a row, chunks a
  thread; (0, 0) the one-block-a-row kernel)."""
  import torch.nn.functional as F
  from indm_torch.ops import group_norm as gn
  gen = torch.Generator(device="cuda").manual_seed(5)
  per_step = collections.defaultdict(float)
  max_err = {torch.float32: 0.0, torch.bfloat16: 0.0}
  by_shape = []
  for (shape, groups, act), count in sorted(shapes.items()):
    shape = (TRAIN_BATCH,) + tuple(shape[1:])
    c = shape[1]
    scale = 1.0 + 0.2 * torch.randn(c, device="cuda", generator=gen)
    bias = 0.2 * torch.randn(c, device="cuda", generator=gen)
    for dtype in dtypes:
      xs = (0.5 + 1.5 * torch.randn(shape, device="cuda",
                                    generator=gen)).to(dtype)
      dy = torch.randn(shape, device="cuda", generator=gen).to(dtype)
      args = (xs, dy, scale, bias, groups, 1e-6, act)
      got = gn.group_norm_act_backward(*args)
      want = gn.group_norm_act_backward_plain(*args)
      torch.cuda.synchronize()
      errs = []
      for name, a, b, tol in zip(("dx", "dscale", "dbias"), got, want,
                                 GN_BWD_TOL[dtype]):
        err = (a.float() - b.float()).abs().max().item()
        big = b.float().abs().max().item()
        if not (math.isfinite(err) and err <= tol * big + tol):
          raise AssertionError(f"group_norm backward {shape} {dtype} {act} "
                               f"{name}: max abs err {err} over {tol} x "
                               f"{big}")
        errs.append(err)
      max_err[dtype] = max(max_err[dtype], errs[0])

      x_ = xs.detach().clone().requires_grad_()
      s_ = scale.detach().to(dtype, copy=True).requires_grad_()
      b_ = bias.detach().to(dtype, copy=True).requires_grad_()
      y = F.group_norm(x_, groups, s_, b_, 1e-6)
      y = F.silu(y) if act == "swish" else y
      times = timed(lambda: gn.group_norm_act_backward(*args))
      times["plain_ms"] = cuda_ms(
          lambda: gn.group_norm_act_backward_plain(*args))
      times["library_ms"] = cuda_ms(lambda: torch.autograd.grad(
          y, (x_, s_, b_), dy, retain_graph=True))
      del y
      times["library_graph_ms"] = graph_ms(
          group_norm_backward_library(xs, dy, s_.detach(), b_.detach(),
                                      groups, act))
      times["bound_ms"] = (3 * xs.numel() * xs.element_size()
                           / HBM_BYTES_PER_S * 1e3)
      dname = str(dtype).replace("torch.", "")
      hw = shape[2] * shape[3]
      plan = gn.bwd_plan(c, hw, groups, xs.element_size(),
                         hw % (16 // xs.element_size()) == 0)
      log(f"group_norm_bwd {list(shape)} groups={groups} act={act} {dname} "
          f"plan={plan} x{count}/step: max_abs_err dx={errs[0]:.3e} "
          f"dscale={errs[1]:.3e} dbias={errs[2]:.3e} "
          + " ".join(f"{k}={v:.5f}" for k, v in times.items())
          + f" ({times['bound_ms'] / times['graph_ms']:.3f} of the bound "
          "by graph_ms)")
      by_shape.append({"shape": list(shape), "groups": groups, "act": act,
                       "dtype": dname, "count": count, "max_abs_err": errs,
                       "plan": list(plan), **times})
      if dtype == torch.float32:
        for key, v in times.items():
          per_step[key] += count * v
  log("group_norm_bwd per training step (float32, "
      f"{sum(shapes.values())} launches): "
      + " ".join(f"{k}={v:.5f}" for k, v in per_step.items())
      + f" ({per_step['bound_ms'] / per_step['graph_ms']:.3f} of the bound "
      "by graph_ms)")
  return dict(per_step), max_err[torch.float32], by_shape


def group_norm_backward_library(x, dy, scale, bias, groups, act):
  """The autograd backward of `F.group_norm` (+ `F.silu`) as the aten
  calls it makes, with the forward's statistics and pre-activation made
  beforehand, so that it can run in a CUDA graph."""
  b, c, h, w = x.shape
  pre, mean, rstd = torch.ops.aten.native_group_norm(
      x, scale, bias, b, c, h * w, groups, 1e-6)

  def backward():
    g = torch.ops.aten.silu_backward(dy, pre) if act == "swish" else dy
    return torch.ops.aten.native_group_norm_backward(
        g, x, mean, rstd, scale, b, c, h * w, groups, [True, True, True])

  return backward


def _snapshot(tr):
  """Copies of both nets' parameters and the encoder's running stats."""
  out = {}
  for tag, model in (("score", tr.score_model), ("flow", tr.flow_model)):
    for k, v in model.state_dict().items():
      out[f"{tag}.{k}"] = v.detach().clone()
  return out


def add_bounds(per, key, simt_key, flops, nbytes, bf16=False,
               steps=TRAIN_STEPS):
  """Adds one call's bound and SIMT bound, averaged over the steps."""
  bound, simt, _ = flow_bounds(flops, nbytes, bf16)
  per[key] += bound / steps
  per[simt_key] += simt / steps


def phase_train(per_step, overrides=None, per_term=None, fused_fits=None,
                chain8_fits=None, config="vp/CIFAR10/indm_nll",
                scales=CHAIN_SCALES, host=True, steps=TRAIN_STEPS,
                profile=True):
  """`steps` full-width steps of `config` at batch 128 with `overrides` on
  it, then, with `profile`, one under the profiler (and, with `host`, one
  with host timers). `per_term` (the chain's per-term times), `fused_fits`
  (the fused pair's times) or `chain8_fits` (kernel 8's) turn into times
  per step at the n drawn in the steps; `scales` are the flow's (channels,
  size) in block order. Each block's GEMM launches follow its route
  (`block_routes`)."""
  from indm_torch import run_lib
  from indm_torch.configs import get_config
  from indm_torch.flows.flow_model import flow_compute_dtype
  from indm_torch.flows.resflow import LAMB, OFFSET_TRAIN
  from indm_torch.ops import lipnet_gemm as lg
  cfg = get_config(config)
  cfg.model.fused_groupnorm = True
  cfg.flow.logdet_pallas = True
  for name, value in (overrides or {}).items():
    cfg.set_dotted(name, str(value))
  if cfg.training.batch_size != TRAIN_BATCH:
    raise AssertionError("the config's training batch is not 128")
  tr = run_lib.build_training(cfg, device="cuda")
  blocks = tr.flow_model.resflow.blocks()
  if len(blocks) != 32:
    raise AssertionError(f"{len(blocks)} iResBlocks, expected 32")
  # each block's (scale, pre-activated), and the n its chains will draw
  channels = [c for c, _ in scales]
  kinds = [(channels.index(b.nnet[-1].weight.shape[0]), b.preact)
           for b in blocks]
  n_rng = copy.deepcopy(tr.host_rng)
  ns = [int(n_rng.poisson(LAMB)) for _ in range(len(blocks) * steps)]
  before = _snapshot(tr)
  torch.cuda.synchronize()
  torch.cuda.reset_peak_memory_stats()
  bf16 = flow_compute_dtype(cfg) == torch.bfloat16
  chain8 = (per_step["fused_neumann_chain"]
            + per_step["fused_neumann_chain_bf16"]) > 0
  routes = block_routes(blocks, chain8)
  fused = all(r == "fused" for r in routes)
  wsize = 2 if bf16 else 4
  rows, launches = [], collections.Counter()
  for i in range(steps):
    reset_kernel_counts()
    gemms_before = lg.device_gemm_launches()
    (row,) = run_lib.train_steps(tr, 1, log=log)
    gemms = check_step_gemms(gemm_counts_since(gemms_before),
                             ns[i * len(blocks):(i + 1) * len(blocks)],
                             routes, f"step {i}", bf16)
    counts = kernel_counts()
    log(f"train step {i}: launches {counts}")
    if counts != per_step:
      raise AssertionError(f"step {i} launched {counts}, expected "
                           f"{per_step}")
    launches.update(counts)
    launches.update({GEMM_KERNELS[k]: v for k, v in gemms.items()})
    rows.append(row)
  peak = torch.cuda.max_memory_allocated()
  for row in rows:
    per = [m for m in row["per_example"]]
    if not all(torch.isfinite(m).all() for m in per):
      raise AssertionError(f"step {row['step']}: non-finite losses")
    total = per[1] + per[2] + per[3]
    if not torch.allclose(per[0], total, rtol=1e-5, atol=1e-6):
      raise AssertionError("losses != score + flow + logp")
  after = _snapshot(tr)
  moved = {k for k in before if not torch.equal(before[k], after[k])}
  for tag, what in (("score.all_modules.", "score net parameters"),
                    ("flow.generator.flow.", "residual flow parameters"),
                    ("flow.discriminator.encoder.", "encoder")):
    if not any(k.startswith(tag) for k in moved):
      raise AssertionError(f"the {what} did not change")
  if not any(k.endswith("running_var") for k in moved):
    raise AssertionError("the BatchNorm running statistics did not change")
  secs = sorted(r["seconds"] for r in rows[1:] or rows)
  sec = secs[len(secs) // 2] if len(secs) % 2 else sum(secs) / len(secs)
  train = {"steps": steps, "batch": TRAIN_BATCH,
           "seconds_per_step": sec, "images_per_s": TRAIN_BATCH / sec,
           "peak_memory_gb": peak / 1e9,
           "step_seconds": [r["seconds"] for r in rows],
           "losses": [r["losses"] for r in rows]}
  log(f"train: seconds/step (median of steps 2-{steps}, or the one) "
      f"{sec:.3f}, "
      f"images/s {TRAIN_BATCH / sec:.3f}, peak memory {peak / 1e9:.3f} GB; "
      f"{len(moved)} of {len(before)} tensors changed")

  # kernel times per step, at the n drawn
  per = collections.defaultdict(float)
  for i, n in enumerate(ns):
    scale, preact = kinds[i % len(blocks)]
    c, hw = scales[scale]
    flops = chain_flops_per_term(TRAIN_BATCH, c, hw)
    if per_term is not None:
      terms = n + OFFSET_TRAIN
      for k, v in per_term[(scale, preact)].items():
        per[f"chain_{k}"] += terms * v / steps
      add_bounds(per, "chain_bound_ms", "chain_simt_bound_ms",
                 scaled(flops, terms),
                 flow_bytes("chain_bf16" if bf16 else "chain", TRAIN_BATCH, c,
                            hw, preact), bf16, steps)
    if fused_fits is not None:
      for k, (at0, slope) in fused_fits[(scale, preact)].items():
        per[k] += (at0 + n * slope) / steps
      add_bounds(per, "fwd_bound", "fwd_simt_bound",
                 scaled(flops, n + OFFSET_TRAIN + 2),
                 flow_bytes("fwd", TRAIN_BATCH, c, hw, wsize=wsize), bf16,
                 steps)
      add_bounds(per, "bwd_bound", "bwd_simt_bound",
                 fused_bwd_flops(TRAIN_BATCH, c, hw, preact),
                 flow_bytes("bwd", TRAIN_BATCH, c, hw, wsize=wsize), bf16,
                 steps)
    if chain8_fits is not None:
      for k, (at0, slope) in chain8_fits[(scale, preact)].items():
        per[f"chain8_{k}"] += (at0 + n * slope) / steps
      add_bounds(per, "chain8_bound_ms", "chain8_simt_bound_ms",
                 added(fused_chain_fwd_flops(TRAIN_BATCH, c, hw),
                       scaled(flops, n + OFFSET_TRAIN)),
                 flow_bytes("chain8_bf16" if bf16 else "chain8", TRAIN_BATCH,
                            c, hw), bf16, steps)
  terms = sum(ns) / steps + OFFSET_TRAIN * len(blocks)
  log(f"kernel times per training step ({len(blocks)} blocks, {terms:.1f} "
      "chain terms on average): " + " ".join(f"{k}={v:.3f}" for k, v in
                                            per.items()))
  if not profile:
    del tr
    torch.cuda.empty_cache()
    return train, launches, dict(per)
  # the profiled step's draws come next
  t0 = time.perf_counter()
  prof_ns = [int(n_rng.poisson(LAMB)) for _ in blocks]
  gemms_before = lg.device_gemm_launches()
  train["profile"] = profile_train_step(tr, fused=fused, chain8=chain8)
  train["profiled_step_gemms"] = check_step_gemms(
      gemm_counts_since(gemms_before), prof_ns, routes, "the profiled step",
      bf16)
  if host:
    train["host"] = host_profile_step(tr)
  log(f"the profiled step{' and the host-timed one' if host else ''}, "
      f"with their analysis, took {time.perf_counter() - t0:.1f} s")
  del tr
  torch.cuda.empty_cache()
  return train, launches, dict(per)


# the score net kernels' rows (1, 2 and 9) beside `ms`
SPLIT_TIMES = ("graph_ms: the device alone (the calls in a CUDA graph); "
               "host_ms: the wrapper's enqueue alone; library_graph_ms: "
               "library_ms's call in a CUDA graph")


def device_and_host(per_eval):
  return {k: per_eval[k] for k in ("graph_ms", "host_ms",
                                   "library_graph_ms")}


# device kernels by the port's sources: the lipnet device code belongs to
# the chain in the chain route's configuration and to the fused kernels
# (the pair and the stacks, which share their device code) in the fused ones
FUSED_ONLY = ("fused_ops::", "transpose_stack_kernel")
KERNEL_NAMES = {"group_norm_fwd": ("group_norm_fwd",),
                "group_norm_bwd": ("group_norm_bwd", "sum_over_batch_kernel"),
                "upfirdn2d": ("upfirdn2d",)}


def block_routes(blocks, chain8=False):
  """Each iResBlock's route in a training step: "fused" (kernels 3-6, under
  flow.fused_block where the block's geometry takes them, in_ch < 33 <=
  width, as the JAX package's fused_chain_ok), "chain8" (kernel 8, under
  INDM_FUSED_CHAIN=1 on such a block) or "chain" (kernel 7)."""
  return ["fused" if b.fused_block and b.fused_ok() else
          "chain8" if chain8 and b.fused_ok() else "chain" for b in blocks]


def check_step_gemms(counts, ns, routes, what, bf16=False):
  """A training step's launches of the net's three GEMMs (`counts`, from
  the libraries' counts) against its draws `ns` and its blocks' `routes`
  (one each, in block order, `block_routes`): a fused block's forward
  n + 4 launches (layer 1, n + 2 chain terms, J^T u) on `wgmma` and its
  backward's BWD_GEMMS_PER_BLOCK on `gemm_3xtf32_kernel`, or with `bf16`
  both on `wgmma_bf16_kernel`; a chain block's n + 2 (one a chain term;
  kernel 8 one more for layer 1) on `wgmma`, or with `bf16` on
  `wgmma_bf16_kernel`; none of the others. Returns the counts."""
  from indm_torch.flows.resflow import OFFSET_TRAIN
  fused = [n for n, r in zip(ns, routes) if r == "fused"]
  fwd = sum(n + OFFSET_TRAIN + 2 for n in fused)
  bwd = BWD_GEMMS_PER_BLOCK * len(fused)
  chain = sum(n + OFFSET_TRAIN + (1 if r == "chain8" else 0)
              for n, r in zip(ns, routes) if r != "fused")
  if bf16:
    want = {"gemm_3xtf32": 0, "wgmma": 0, "gemm_bf16": fwd + bwd + chain}
  else:
    want = {"gemm_3xtf32": bwd, "wgmma": fwd + chain, "gemm_bf16": 0}
  log(f"{what}: GEMM launches {counts} (expected {want})")
  if counts != want:
    raise AssertionError(f"{what}: GEMM launches {counts}, expected {want}")
  return counts


def profile_train_step(tr, fused=False, chain8=False, top=12):
  """Device time of one training step by kernel, and the device's busy
  share of the host's wall time (profiler on). With `fused`, no
  convolution of the flow's 512-wide layers may run. With `chain8` the
  lipnet device code is kernel 8's (with its narrow pre-activation pass).
  Both GEMMs' device time and the launches the profiler saw are listed
  apart (their launch counts are checked by the caller)."""
  from indm_torch import run_lib
  from torch.profiler import ProfilerActivity, profile
  with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
               record_shapes=True) as prof:
    t0 = time.perf_counter()
    run_lib.train_steps(tr, 1, log=log)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
  kernels = [e for e in prof.key_averages()
             if e.device_type == torch.autograd.DeviceType.CUDA]
  if not kernels:
    log("profile: the profiler saw no device time")
    return None
  busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
  out = {"wall_ms": wall_ms, "busy_ms": busy_ms, "busy_share":
         busy_ms / wall_ms}
  if fused:
    flow_names = {"fused": ("lipnet::",) + FUSED_ONLY}
  elif chain8:
    flow_names = {"fused_neumann_chain": ("lipnet::", "fused_ops::",
                                          "fused_chain_ops::")}
  else:
    flow_names = {"neumann_chain": ("lipnet::",)}
  names = {**KERNEL_NAMES, **flow_names}
  for name, keys in names.items():
    out[f"{name}_ms"] = sum(e.self_device_time_total for e in kernels
                            if any(k in e.key for k in keys)) / 1e3
  # the net's three GEMMs inside the flow kernels: the float32 backwards'
  # gemm_3xtf32_kernel ("gemm"), WGMMA_KERNEL ("wgmma") and the bfloat16
  # mode's GEMM_BF16_KERNEL ("gemm_bf16")
  for tag, name in (("gemm", GEMM_KERNELS["gemm_3xtf32"]),
                    ("wgmma", WGMMA_KERNEL), ("gemm_bf16", GEMM_BF16_KERNEL)):
    mine = [e for e in kernels if name in e.key]
    out[f"{tag}_ms"] = sum(e.self_device_time_total for e in mine) / 1e3
    out[f"{tag}_launches"] = sum(e.count for e in mine)
  log(f"profile of one training step: device busy {busy_ms:.3f} ms of "
      f"{wall_ms:.3f} ms wall ({busy_ms / wall_ms:.4f}); "
      + " ".join(f"{k}={v:.3f}" for k, v in out.items()
                 if k.endswith("_ms") and k not in ("wall_ms", "busy_ms"))
      + f" {GEMM_KERNELS['gemm_3xtf32']} launches seen="
      f"{out['gemm_launches']} "
      f"{WGMMA_KERNEL} launches seen={out['wgmma_launches']} "
      f"{GEMM_BF16_KERNEL} launches seen={out['gemm_bf16_launches']}")
  for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:top]:
    log(f"  {e.self_device_time_total / 1e3:9.3f} ms  x{e.count:<5d} "
        f"{e.key[:100]}")
  out.update(device_gaps(prof, wall_ms))
  # which convolutions the device time belongs to: (input, weight) shapes
  convs = [e for e in prof.key_averages(group_by_input_shape=True)
           if e.key in ("aten::cudnn_convolution", "aten::convolution_backward")]
  log("convolutions by device time (op, calls, input and weight shapes):")
  for e in sorted(convs, key=lambda e: -e.device_time_total)[:top]:
    log(f"  {e.device_time_total / 1e3:9.3f} ms  x{e.count:<5d} {e.key} "
        f"{e.input_shapes[:3]}")
  flow = [e for e in convs if is_flow_conv(e.input_shapes[:3])]
  out["flow_conv_ms"] = sum(e.device_time_total for e in flow) / 1e3
  log(f"convolutions of the flow's {CHAIN_WIDTH}-wide layers: {len(flow)} "
      f"shapes, {out['flow_conv_ms']:.3f} ms")
  if fused and flow:
    raise AssertionError("the fused step ran convolutions of the flow's "
                         f"{CHAIN_WIDTH}-wide layers: "
                         f"{[e.input_shapes[:3] for e in flow]}")
  return out


def device_gaps(prof, wall_ms, top=8):
  """Where the device idles in a profiled step: the span from its first
  to its last activity (kernels, copies, sets) against the host's wall
  time, and the gaps between consecutive activities inside the span,
  summed by size, with the largest and the activities around them."""
  acts = sorted((e for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA),
                key=lambda e: e.time_range.start)
  if not acts:
    return {}
  gaps, end, before = [], None, None
  for e in acts:
    if end is not None and e.time_range.start > end:
      gaps.append((e.time_range.start - end, before, e.name))
    if end is None or e.time_range.end > end:
      end, before = e.time_range.end, e.name
  span_ms = (end - acts[0].time_range.start) / 1e3
  sizes = {"under_20us": (0, 20), "20us_to_1ms": (20, 1000),
           "over_1ms": (1000, math.inf)}
  by_size = {k: [sum(1 for g in gaps if lo <= g[0] < hi),
                 sum(g[0] for g in gaps if lo <= g[0] < hi) / 1e3]
             for k, (lo, hi) in sizes.items()}
  gap_ms = sum(g[0] for g in gaps) / 1e3
  log(f"device timeline of the step: {len(acts)} activities over "
      f"{span_ms:.3f} ms of the {wall_ms:.3f} ms wall; gaps inside "
      f"{gap_ms:.3f} ms (count, ms by size: {by_size}); largest:")
  for size, a, b in sorted(gaps, key=lambda g: -g[0])[:top]:
    log(f"  {size / 1e3:8.3f} ms  after {a[:60]}  before {b[:60]}")
  return {"activities": len(acts), "span_ms": span_ms, "gap_ms": gap_ms,
          "gaps_by_size": by_size}


def host_profile_step(tr):
  """One more step with host timers (no profiler) around the step function
  (the host's time to enqueue the step, which ends before the losses are
  read), the flow's training forward and each of the flow's kernel
  wrappers, forward and backward. Returns the step's wall ms and the host
  ms and calls of each, to tell the host's share of the step."""
  from indm_torch import run_lib
  from indm_torch.flows.resflow import ResidualFlow
  from indm_torch.ops import fused_block as fb
  from indm_torch.ops import fused_stack as fs
  from indm_torch.ops import neumann
  ms, calls = collections.defaultdict(float), collections.Counter()

  def timed(name, fn):
    def wrapper(*args, **kwargs):
      t0 = time.perf_counter()
      try:
        return fn(*args, **kwargs)
      finally:
        ms[name] += (time.perf_counter() - t0) * 1e3
        calls[name] += 1
    return wrapper

  targets = [(ResidualFlow, "fwdpass"), (neumann, "neumann_chain"),
             (neumann, "fused_neumann_chain"),
             (fb, "fused_block_fwd"), (fb, "fused_block_bwd"),
             (fs, "fused_stack_fwd"), (fs, "fused_stack_bwd")]
  saved = [(obj, name, getattr(obj, name)) for obj, name in targets]
  try:
    for obj, name, fn in saved:
      setattr(obj, name, timed(name, fn))
    (row,) = run_lib.train_steps(
        dataclasses.replace(tr, step_fn=timed("step_fn", tr.step_fn)), 1,
        log=log)
  finally:
    for obj, name, fn in saved:
      setattr(obj, name, fn)
  out = {"wall_ms": row["seconds"] * 1e3, **{f"{k}_ms": v
                                             for k, v in ms.items()},
         "calls": dict(calls)}
  wrappers = sum(v for k, v in ms.items() if k not in ("step_fn", "fwdpass"))
  out["wrappers_ms"] = wrappers
  log(f"host profile of one training step: wall {out['wall_ms']:.3f} ms; "
      f"host ms enqueuing the step {ms['step_fn']:.3f} "
      f"({ms['step_fn'] / out['wall_ms']:.4f} of the wall), in the flow's "
      f"forward {ms['fwdpass']:.3f}, in the flow's kernel wrappers "
      f"{wrappers:.3f} ({wrappers / out['wall_ms']:.4f}): "
      + " ".join(f"{k}={v:.3f}/{calls[k]}" for k, v in ms.items()
                 if k not in ("step_fn", "fwdpass")))
  return out


def is_flow_conv(shapes):
  """Whether a convolution's operands are those of an iResBlock layer or
  of its double backward: a first dimension of the flow's width (a weight
  [512, C, 3, 3] or [512, 512, 1, 1], or the double backward's 512-wide
  activations as a "weight" [512, B, H, W]), or [C, 512, ...] with C the
  flow's 3, 12 or (CelebA) 48 channels. The score net's weights have at
  most 256 outputs (its 512-channel inputs are concatenations) and its
  activations start with the batch; the encoder is at most 96 wide."""
  narrow = [c for c, _ in CHAIN_SCALES + CELEBA_SCALES]
  return any(len(s) == 4 and (s[0] == CHAIN_WIDTH or (
      s[1] == CHAIN_WIDTH and s[0] in narrow)) for s in shapes)


def check_stack_losses(train_stack, train_fused):
  """The default fused route's loss means against INDM_FUSED_STACK=0's in
  the same run: the same function on the same seeds, STACK_LOSS_RTOL for
  the order of the log-det sums."""
  got, want = train_stack["losses"], train_fused["losses"]
  rel = max(abs(a - b) / abs(b) for a, b in zip(got, want))
  log(f"loss means, stack route {got} against INDM_FUSED_STACK=0 {want}: "
      f"max rel diff {rel:.3e} (limit {STACK_LOSS_RTOL}), equal: "
      f"{got == want}")
  if not rel <= STACK_LOSS_RTOL:
    raise AssertionError("the stack route's losses differ from the fused "
                         "pair's")


def grad_rel_err(g_cpu, g_gpu):
  """(the largest gradient error, its name): each tensor's largest error
  over its largest value floored at TRAIN_SMALL_GRAD_FLOOR of its net's
  largest gradient."""
  net_max = {tag: max(v.abs().max().item() for k, v in g_cpu.items()
                      if k.startswith(tag)) for tag in ("score", "flow")}
  grad_err, worst = 0.0, ""
  for k, want in g_cpu.items():
    floor = TRAIN_SMALL_GRAD_FLOOR * net_max[k.split(".")[0]]
    err = ((g_gpu[k] - want).abs().max()
           / (want.abs().max() + floor)).item()
    if err > grad_err:
      grad_err, worst = err, k
  return grad_err, worst


class TakesValue(torch.autograd.Function):
  """`value` forward and the gradient to `z` backward: a latent that
  carries another run's values through this run's graph."""

  @staticmethod
  def forward(ctx, z, value):
    return value.clone()

  @staticmethod
  def backward(ctx, g):
    return g, None


@contextlib.contextmanager
def latent_value(value, seen):
  """The joint step's flow forward appends its latent to `seen` and, where
  `value` is given, hands the score loss `value` in its place
  (`TakesValue`)."""
  from indm_torch import joint
  real = joint.flow_forward

  def flow_forward(*args, **kwargs):
    z, logdet = real(*args, **kwargs)
    seen.append(z.detach().cpu())
    if value is None:
      return z, logdet
    return TakesValue.apply(z, value.to(z.device)), logdet

  joint.flow_forward = flow_forward
  try:
    yield
  finally:
    joint.flow_forward = real


def bf16_step_allowed(want, err, limit):
  """Where the tiny bfloat16 step's gradient errors take one bfloat16 step
  of the value: for a gradient `want` exact in bfloat16 (both sides round
  their float32 sums to bfloat16 once), the elements whose error `err`
  exceeds `limit`, the absolute limit, but not the bfloat16 spacing at
  |want| (8 significant bits). Two
  such sums that fall on either side of a rounding boundary differ by one
  step, which there no share of the float32-bfloat16 gap can hold: in
  `vp/CELEBA/indm_nll`'s tiny step the score net's gradients are its last
  conv's (up to 1.65, the rest under 2e-5), whose bfloat16 step at 1.65,
  2^-7 = 0.0078, exceeds the CPU's whole float32-bfloat16 gap, 0.0068.
  Any other element, and every element of a gradient not exact in
  bfloat16, keeps the limit."""
  if not torch.equal(want.to(torch.bfloat16).float(), want):
    return torch.zeros_like(err, dtype=torch.bool)
  step = torch.exp2(torch.floor(torch.log2(want.abs().clamp_min(2.0 ** -126)))
                    - 7)
  return (err > limit) & (err <= step)


def phase_small_train(cfg, overrides, launches, f32_twin=None,
                      gap_share=None, fir_both_ways=False, seed=7,
                      flow_f64=False):
  """One tiny step's losses and gradients, card against CPU, with
  `overrides` on the tiny config; the card's step must launch the chain,
  the fused pair, the stack pair, the fully fused chain and the two chains
  in bfloat16 `launches` = (chain, pair, stack, fused chain, chain
  bfloat16, fused chain bfloat16) times (the pairs in each direction).
  With `f32_twin` (the overrides with the precision switches off) the
  step is in bfloat16, and the CPU and the card also run the float32
  step: every loss term of the card's bfloat16 step within
  BF16_STEP_LOSS_RTOL of its largest value and, per net, the largest
  gradient error at most BF16_STEP_GAP_SHARE of the largest difference
  between the CPU's float32 and bfloat16 steps; with `gap_share` the
  card's latent z within that share of the CPU's float32-bfloat16
  difference of z, and, with the card's score half on the CPU's z
  (`latent_value`), the losses and the gradients each within that share
  of the CPU's float32-bfloat16 difference instead (CHAIN_STEP_GAP_SHARE
  says why); the card's float32 step, held to the CPU's bfloat16 step the
  same way, must fail. Where the CPU's bfloat16 gradient of a tensor is
  exact in bfloat16 (a weight the net casts to bfloat16), an element may
  differ by one bfloat16 step at its value where that step exceeds the
  limit (`bf16_step_allowed`). With `fir_both_ways`
  (the VE net) the card's step must launch kernel 9 as often backward as
  forward, and at least once. `seed` draws the weights and the step's
  noise. With `flow_f64` (the wolf generators, whose log-det sums
  thousands of terms that cancel to a few units: the tiny MaCow's float32
  log-det is 1.2e-3 of itself off its float64 value on the CPU) the flow
  term and the total are held to TRAIN_SMALL_RTOL of their largest value
  plus twice the CPU's own float32 error of the flow term, measured
  against the same flow forward in float64 on the CPU."""
  from indm_torch import joint, run_lib
  from indm_torch.ops import upfirdn2d as fir
  from indm_torch.flows.flow_model import FlowNoise, sample_flow_noise
  from indm_torch.ops import fused_block as fb
  from indm_torch.ops import fused_stack as fs
  from indm_torch.ops import neumann
  import numpy as np

  def tiny(extra):
    return set_leaves(cfg, {**SMALL, "model.dropout": 0.0,
                            "training.batch_size": SMALL_BATCH,
                            "flow.logdet_pallas": True, **(extra or {})})

  small = tiny(overrides)
  runs = [("cpu", "cpu", small), ("cuda", "cuda", small)]
  if f32_twin is not None:
    runs += [("cpu_f32", "cpu", tiny(f32_twin)),
             ("cuda_f32", "cuda", tiny(f32_twin))]
  trs = {key: (d, c, run_lib.build_training(c, device=d, seed=seed))
         for key, d, c in runs}
  batch = run_lib.next_batch(trs["cpu"][2])
  gen = torch.Generator().manual_seed(seed + 1)
  flow = sample_flow_noise(trs["cpu"][2].flow_model, batch.shape, gen,
                           np.random.default_rng(seed + 2))
  flow64 = (copy.deepcopy(trs["cpu"][2].flow_model).double() if flow_f64
            else None)
  noise = joint.StepNoise(flow, torch.rand(SMALL_BATCH, generator=gen),
                          torch.randn(batch.shape, generator=gen),
                          torch.randn(batch.shape, generator=gen))
  sde = trs["cpu"][2].sde
  t, weight = sde.get_diffusion_time(SMALL_BATCH, sde.get_t_min(device="cpu"),
                                     True, u=noise.u_t)
  out, zs = {}, {}
  for key, (d, c, tr) in trs.items():
    tr.sde.get_diffusion_time = (
        lambda t, w: lambda *args, **kwargs: (t, w))(t.to(d), weight.to(d))
    enc_eps = noise.flow.enc_eps
    nd = joint.StepNoise(
        FlowNoise(None if enc_eps is None else enc_eps.to(d),
                  [(v.to(d), n) for v, n in noise.flow.blocks]),
        noise.u_t.to(d), noise.z.to(d), noise.logp_z.to(d))
    losses = joint.make_joint_losses(c, tr.sde, tr.score_model,
                                     tr.flow_model)
    for lib in (neumann, fb, fs, fir):
      lib.reset_launches()
    seen = []
    given = zs["cpu"] if key == "cuda" and gap_share is not None else None
    with latent_value(given, seen):
      aux = losses(batch.to(d), nd)
    zs[key] = seen[0]
    aux["losses"].mean().backward()
    if key == "cuda" and fir_both_ways:
      torch.cuda.synchronize()
      log(f"the tiny VE step launched kernel 9 {fir.launches} times forward "
          f"and {fir.bwd_launches} backward")
      if not fir.launches == fir.bwd_launches > 0:
        raise AssertionError("the tiny VE step did not launch kernel 9 "
                             "backward for each forward launch")
    if key == "cuda":
      chain, pair, stack, chain8, chain16, chain8_16 = launches
      counts = (neumann.launches, fb.fwd_launches, fb.bwd_launches,
                fs.fwd_launches, fs.bwd_launches, neumann.fused_launches,
                neumann.bf16_launches, neumann.fused_bf16_launches)
      if counts != (chain, pair, pair, stack, stack, chain8, chain16,
                    chain8_16):
        raise AssertionError(f"the tiny step launched (chain, fused forward, "
                             f"fused backward, stack forward, stack "
                             f"backward, fused chain, chain bfloat16, fused "
                             f"chain bfloat16) = {counts}, expected "
                             f"{launches}")
    grads = {f"{tag}.{k}": p.grad.detach().cpu()
             for tag, m in (("score", tr.score_model), ("flow",
                                                         tr.flow_model))
             for k, p in m.named_parameters() if p.grad is not None}
    out[key] = ({k: aux[k].detach().cpu() for k in joint.METRICS}, grads)
  (l_cpu, g_cpu), (l_gpu, g_gpu) = out["cpu"], out["cuda"]
  if set(g_cpu) != set(g_gpu) or len(g_cpu) < 100:
    raise AssertionError("the card and the CPU produced other gradients")
  if f32_twin is not None:
    l32, g32 = out["cpu_f32"]
    gap = collections.defaultdict(float)
    for k, want in g_cpu.items():
      net = k.split(".")[0]
      gap[net] = max(gap[net], (g32[k] - want).abs().max().item())
    loss_gap = max(((l32[k] - l_cpu[k]).abs().max()
                    / l_cpu[k].abs().max()).item() for k in l_cpu)
    loss_limit, share_limit = (
        (BF16_STEP_LOSS_RTOL, BF16_STEP_GAP_SHARE) if gap_share is None
        else (gap_share * loss_gap, gap_share))

    def held(key):
      """The card's step `key` against the CPU's bfloat16 step: (losses'
      largest relative error, per net the largest gradient error over the
      float32-bfloat16 gap, the elements inside their one-step allowance,
      whether all are inside the limits)."""
      losses, grads = out[key]
      lerr = max(((losses[k] - l_cpu[k]).abs().max()
                  / l_cpu[k].abs().max()).item() for k in l_cpu)
      share, stepped = collections.defaultdict(float), collections.Counter()
      for k, want in g_cpu.items():
        if not torch.isfinite(grads[k]).all():
          raise AssertionError(f"non-finite gradient {k} in {key}")
        net = k.split(".")[0]
        err = (grads[k] - want).abs()
        inside = bf16_step_allowed(want, err, share_limit * gap[net])
        stepped[k] = int(inside.sum())
        err = torch.where(inside, torch.zeros_like(err), err)
        share[net] = max(share[net], err.max().item() / gap[net])
      ok = lerr <= loss_limit and all(v <= share_limit
                                      for v in share.values())
      return lerr, dict(share), +stepped, ok

    if gap_share is not None:
      z_gap = (zs["cpu_f32"] - zs["cpu"]).abs().max().item()
      z_err = (zs["cuda"] - zs["cpu"]).abs().max().item()
      log(f"small reference training step in bfloat16 {overrides}: the "
          f"card's z against the CPU's: max abs err {z_err:.3e} (limit "
          f"{gap_share} of the CPU's float32-bfloat16 difference "
          f"{z_gap:.3e}); the card's score half takes the CPU's z")
      if not z_err <= gap_share * z_gap:
        raise AssertionError("the tiny bfloat16 step's latent on the card "
                             "disagrees with the CPU's")
    lerr, share, stepped, ok = held("cuda")
    lerr32, share32, stepped32, ok32 = held("cuda_f32")
    log(f"small reference training step in bfloat16 {overrides} (seed "
        f"{seed}): card vs "
        f"cpu losses max rel err {lerr:.3e} (limit {loss_limit:.3e}; the "
        f"CPU's float32-bfloat16 difference {loss_gap:.3e}); gradients, per "
        f"net, max abs err over the CPU's float32-bfloat16 gap "
        f"{share} (limit {share_limit}; the gaps {dict(gap)}; elements "
        f"within one bfloat16 step {dict(stepped)}); the control, "
        f"the card's float32 step: losses {lerr32:.3e}, gradients "
        f"{share32} (within one step {dict(stepped32)})")
    if not ok:
      raise AssertionError("the tiny bfloat16 training step on the card "
                           "disagrees with the CPU")
    if ok32:
      raise AssertionError("the card's float32 step passes the bfloat16 "
                           "step's limits: they do not tell the modes apart")
    return
  grad_err, worst = grad_rel_err(g_cpu, g_gpu)
  limits = {k: TRAIN_SMALL_RTOL for k in l_cpu}
  gap64 = None
  if flow64 is not None:
    from indm_torch.flows.flow_model import flow_forward
    enc_eps = noise.flow.enc_eps
    _, ld64 = flow_forward(small, flow64, batch.double(), train=True,
                           noise=FlowNoise(None if enc_eps is None
                                           else enc_eps.double(), []))
    d_dim = float(small.data.image_size ** 2 * small.data.num_channels)
    gap64 = (l_cpu["losses_flow"].double() + ld64.detach() / d_dim).abs() \
        .max().item()
    for k in ("losses", "losses_flow"):
      limits[k] += 2 * gap64 / l_cpu[k].abs().max().item()
  errs = {k: ((l_gpu[k] - l_cpu[k]).abs().max()
              / l_cpu[k].abs().max()).item() for k in l_cpu}
  log(f"small reference training step {overrides or {}}: card vs cpu "
      f"losses max rel err {errs} (limits {limits}"
      + ("" if gap64 is None else
         f"; the CPU's float32 flow term off float64 by {gap64:.3e}")
      + f"); gradients max rel err "
      f"{grad_err:.3e} at {worst} (limit {TRAIN_SMALL_GRAD_RTOL}, "
      f"{len(g_cpu)} tensors)")
  if not (all(errs[k] <= limits[k] for k in errs)
          and grad_err <= TRAIN_SMALL_GRAD_RTOL):
    raise AssertionError("the tiny training step on the card disagrees with "
                         "the CPU")


# phase 11b: checkpoints and bits/dim. The training half at full width on
# the chain route (the configs' own route, kernel 7) at batch 128: one
# step written to a work directory under build/, a fresh Training built
# from it, one more step, against two steps in one run. The evaluation
# half: run_lib.evaluate on that checkpoint, the NELBO and "NLL correct"
# sections on the first EVAL_BATCH images of the synthetic test split
# (one batch). Every NLL function evaluation is one score forward with
# autograd (95 GroupNorm forwards, kernel 1) and its VJP (95 backwards,
# kernel 2), and the residual reads the score once more: kernel 1 95 x
# (NFE + 1), kernel 2 95 x NFE in the section.
CKPT_WORKDIR = os.path.join(REPO, "build", "chip_smoke_ckpt")
# one step, saved, then one more after the resume, against two in one run
# (from (2, 1): a depth cut that makes room for phase 17)
CKPT_STEPS = (1, 1)
# one test batch of 16 (of the config's 128: depth cuts that made room for
# phase 14, to 32, and for phase 16, to 16); RK45 at 1e-3, as 12c and 13e
# run it (from the config's 1e-5: a depth cut that makes room for phase 17)
EVAL_BATCH = 16
EVAL_OVERRIDES = {"eval.enable_sampling": False, "eval.num_nelbo": 1,
                  "eval.skip_nll_wrong": True,
                  "eval.batch_size": EVAL_BATCH,
                  "eval.num_test_data": EVAL_BATCH,
                  "eval.rtol": 1e-3, "eval.atol": 1e-3}
# the resumed step's losses against the straight run's: float32 sums in
# another order where cuDNN picks its algorithms again
RESUME_RTOL = 1e-5
# card vs CPU at the tiny width with the same draws: the ODE's bits/dim
# (equal function evaluations; the JAX package's CPU test holds the port
# at 1e-4) and the NELBO at float32 rounding through both nets
EVAL_SMALL_BPD_RTOL = 1e-4
EVAL_SMALL_NELBO_RTOL = 1e-5


def training_state(tr):
  """Device copies of everything a resume must restore: both nets'
  parameters and buffers, the optimizers' moments and counts, the EMAs,
  the generators and the batches' place."""
  out = _snapshot(tr)
  for tag, opt in (("score", tr.score_opt), ("flow", tr.flow_opt)):
    out[f"{tag}.count"] = opt.count
    for i, (m, v) in enumerate(zip(opt.mu, opt.nu)):
      out[f"{tag}.mu.{i}"], out[f"{tag}.nu.{i}"] = m.clone(), v.clone()
  for tag, ema in (("score", tr.score_ema), ("flow", tr.flow_ema)):
    out[f"{tag}.ema_updates"] = ema.num_updates
    for i, e in enumerate(ema.shadow):
      out[f"{tag}.ema.{i}"] = e.clone()
  out["rng"] = (tr.np_rng.bit_generator.state,
                tr.host_rng.bit_generator.state,
                tr.generator.get_state().tolist(),
                tr.batches.rng.bit_generator.state,
                tr.batches._order.tolist(), tr.step)
  return out


def same_state(a, b):
  """The names whose values differ (tensors bit for bit)."""
  return sorted(k for k in a if not (
      torch.equal(a[k], b[k]) if isinstance(a[k], torch.Tensor)
      else a[k] == b[k]))


def phase_checkpoint_train():
  """Phase 11b's training half: returns the config, the checkpoint's
  numbers and whether the resumed step's bits equal the straight run's."""
  import shutil
  from indm_torch import run_lib
  from indm_torch.configs import get_config
  cfg = get_config("vp/CIFAR10/indm_nll")
  cfg.model.fused_groupnorm = True
  cfg.flow.logdet_pallas = True
  cfg.optim.reset = False
  shutil.rmtree(CKPT_WORKDIR, ignore_errors=True)
  first, then = CKPT_STEPS
  tr = run_lib.build_training(cfg, device="cuda", workdir=CKPT_WORKDIR)
  rows = run_lib.train_steps(tr, first, log=log)
  saved = training_state(tr)
  del tr
  torch.cuda.empty_cache()
  resumed = run_lib.build_training(cfg, device="cuda", workdir=CKPT_WORKDIR)
  differ = same_state(saved, training_state(resumed))
  if differ:
    raise AssertionError(f"restored state differs from the saved one: "
                         f"{differ[:5]} ({len(differ)} entries)")
  log(f"checkpoint: restored {len(saved)} entries bit for bit in "
      f"{resumed.restore_seconds:.3f} s")
  (row,) = run_lib.train_steps(resumed, then, log=log)
  del resumed, saved
  torch.cuda.empty_cache()
  straight = run_lib.build_training(cfg, device="cuda")
  want = run_lib.train_steps(straight, first + then, log=log)[-1]
  del straight
  torch.cuda.empty_cache()
  bits_equal = True
  for name, got, ref in zip(("losses", "losses_score", "losses_flow",
                             "losses_logp"), row["per_example"],
                            want["per_example"]):
    err = ((got - ref).abs().max() / ref.abs().max()).item()
    bits_equal = bits_equal and torch.equal(got, ref)
    if not err <= RESUME_RTOL:
      raise AssertionError(f"resumed step {name}: {err:.3e} of the largest "
                           f"value from the straight run")
  meta = os.path.join(CKPT_WORKDIR, "checkpoints-meta")
  out = {"steps": list(CKPT_STEPS),
         "score_file_mb": os.path.getsize(
             os.path.join(meta, "checkpoint.pth")) / 2 ** 20,
         "flow_file_mb": os.path.getsize(
             os.path.join(meta, "flow_checkpoint.pth")) / 2 ** 20,
         "save_seconds": rows[-1]["save_seconds"],
         "restore_seconds": None, "resumed_bits_equal": bits_equal,
         "step_seconds": [r["seconds"] for r in rows] + [row["seconds"]]}
  out["restore_seconds"] = run_lib.build_training(
      cfg, device="cuda", workdir=CKPT_WORKDIR).restore_seconds
  torch.cuda.empty_cache()
  log(f"checkpoint: files {out['score_file_mb']:.1f} + "
      f"{out['flow_file_mb']:.1f} MB, save {out['save_seconds']:.3f} s, "
      f"restore {out['restore_seconds']:.3f} s; the resumed step's losses "
      + ("equal the straight run's bit for bit" if bits_equal else
         f"within {RESUME_RTOL} of the straight run's, not bit for bit"))
  return cfg, out


def phase_checkpoint_eval(cfg):
  """Phase 11b's evaluation half: run_lib.evaluate on the checkpoint with
  the kernels' launches of the NLL section counted, then one NLL function
  evaluation timed and profiled and the flow's evaluation estimator timed
  at EVAL_BATCH. Returns the eval dict and the NLL section's launches."""
  from indm_torch import likelihood, run_lib
  from indm_torch.flows.flow_model import flow_forward
  from indm_torch.models.registry import get_score_fn
  from indm_torch.ops import group_norm as gn
  ecfg = set_leaves(cfg, EVAL_OVERRIDES)
  marks = {}

  def hook(line):
    log(line)
    if "[NELBO" in line and "wall-clock" in line:
      marks["after_nelbo"] = (gn.launches, gn.bwd_launches)

  gn.reset_launches()
  t0 = time.perf_counter()
  res = run_lib.evaluate(ecfg, CKPT_WORKDIR, device="cuda", log=hook)
  total_s = time.perf_counter() - t0
  bpd = res["bpd"]
  fwd, bwd = (gn.launches - marks["after_nelbo"][0],
              gn.bwd_launches - marks["after_nelbo"][1])
  nfe = bpd["nll_correct_nfe"]
  want = (GN_PER_SCORE_EVAL * (nfe + 1), GN_PER_SCORE_EVAL * nfe)
  if (fwd, bwd) != want:
    raise AssertionError(f"NLL section launches kernel 1 {fwd}, kernel 2 "
                         f"{bwd}; expected {want} at NFE {nfe}")
  nelbo_launches = marks["after_nelbo"]
  if nelbo_launches != (2 * GN_PER_SCORE_EVAL, GN_PER_SCORE_EVAL):
    raise AssertionError(f"NELBO section launches {nelbo_launches}")
  for key in ("nelbo", "nelbo_residual", "nll_correct"):
    if not math.isfinite(bpd[key]):
      raise AssertionError(f"{key} bits/dim is not finite: {bpd[key]}")
  if res["step"] != sum(CKPT_STEPS):
    raise AssertionError(f"evaluated step {res['step']}")

  # one NLL function evaluation (score forward with autograd and its VJP)
  # and the flow's evaluation estimator, on the checkpoint's models
  s = run_lib.build_sampling(ecfg, EVAL_BATCH, device="cuda",
                             workdir=CKPT_WORKDIR)
  s.score_model.requires_grad_(False)
  s.flow_model.requires_grad_(False)
  score_fn = get_score_fn(ecfg, s.sde, s.score_model, differentiable=True)
  drift = lambda x, t: s.sde.reverse(score_fn, True).sde(x, t)[0]
  gen = torch.Generator(device="cuda").manual_seed(13)
  size = ecfg.data.image_size
  x = torch.randn(EVAL_BATCH, ecfg.data.num_channels, size, size,
                  device="cuda", generator=gen)
  eps = likelihood.rademacher_like(x, gen)
  t = torch.full((EVAL_BATCH,), 0.5, device="cuda")

  def forward():
    xd = x.detach().requires_grad_(True)
    with torch.enable_grad():
      return xd, drift(xd, t)

  def fe(xx=None, tt=None):
    xd, d = forward()
    return likelihood.div_from(d, xd, eps)

  fe_ms, fwd_ms = cuda_ms(fe, 5, 2), cuda_ms(forward, 5, 2)
  prof = profile_score_eval(fe, x, t,
                            ours=("group_norm_fwd", "group_norm_bwd"))
  torch.cuda.synchronize()
  t0 = time.perf_counter()
  flow_forward(ecfg, s.flow_model, x, train=False)
  torch.cuda.synchronize()
  flow_s = time.perf_counter() - t0
  del s
  torch.cuda.empty_cache()
  nll_s = bpd["nll_correct_seconds"]
  out = {
      "step": res["step"], "evaluate_seconds": total_s,
      "nelbo": {"bpd": bpd["nelbo"], "residual_bpd": bpd["nelbo_residual"],
                "images": bpd["nelbo_images"],
                "seconds": bpd["nelbo_seconds"],
                "seconds_per_image": bpd["nelbo_seconds"]
                / bpd["nelbo_images"],
                "launches": {"group_norm_fwd": nelbo_launches[0],
                             "group_norm_bwd": nelbo_launches[1]}},
      "nll_correct": {"bpd": bpd["nll_correct"], "nfe": nfe,
                      "images": bpd["nll_correct_images"],
                      "seconds": nll_s, "seconds_per_fe": nll_s / nfe,
                      "images_per_s": bpd["nll_correct_images"] / nll_s,
                      "launches": {"group_norm_fwd": fwd,
                                   "group_norm_bwd": bwd}},
      "function_evaluation_ms": fe_ms, "forward_ms": fwd_ms,
      "vjp_ms": fe_ms - fwd_ms, "profile": prof,
      "flow_eval_seconds": flow_s,
      "flow_share_of_bpd_pass": 2 * flow_s / (bpd["nelbo_seconds"] + nll_s)}
  log(f"bits/dim at step {res['step']} (batch {EVAL_BATCH}): NELBO "
      f"{bpd['nelbo']:.5f} ({bpd['nelbo_seconds']:.3f} s); NLL correct "
      f"{bpd['nll_correct']:.5f}, NFE {nfe}, {nll_s:.3f} s, "
      f"{nll_s / nfe * 1e3:.2f} ms per FE, "
      f"{bpd['nll_correct_images'] / nll_s:.3f} images/s; kernel 1 {fwd} "
      f"and kernel 2 {bwd} launches in the NLL section (95 x (NFE + 1), 95 "
      f"x NFE); one FE {fe_ms:.2f} ms (forward {fwd_ms:.2f}); the flow's "
      f"evaluation estimator {flow_s:.3f} s a batch")
  return out


def phase_checkpoint_small(cfg):
  """Phase 11b at the tiny width: the card (kernels) against the CPU
  (plain versions), the same weights and draws: the ODE's bits/dim through
  the flow (equal NFE) and the NELBO at the CPU's diffusion times."""
  import numpy as np
  from indm_torch import likelihood, run_lib
  from indm_torch.flows.flow_model import (FlowNoise, flow_forward,
                                           sample_flow_noise)
  from indm_torch.models.registry import get_score_fn
  small = set_leaves(cfg, {**SMALL, "model.init_scale": 0.0,
                           "eval.rtol": 1e-5, "eval.atol": 1e-5})
  gen = torch.Generator().manual_seed(21)
  x = torch.rand(SMALL_BATCH, 3, 8, 8, generator=gen) * 2 - 1
  shape = x.shape
  draws = likelihood.LikelihoodNoise(
      likelihood.rademacher_like(x, gen), torch.randn(shape, generator=gen),
      likelihood.ResidualNoise(torch.randn(shape, generator=gen),
                               torch.randn(shape, generator=gen)))
  elbo_draws = likelihood.ElboNoise(
      torch.rand(SMALL_BATCH, generator=gen),
      torch.randn(shape, generator=gen), likelihood.rademacher_like(x, gen),
      torch.randn(shape, generator=gen),
      likelihood.ResidualNoise(torch.randn(shape, generator=gen),
                               torch.randn(shape, generator=gen)))
  # the NELBO's diffusion times and weight from the CPU (TRAIN_SMALL_RTOL's
  # note: one ulp of expf moves them by up to 10 % and 0.2 %)
  cpu_sde = run_lib.build_sampling(small, SMALL_BATCH, device="cpu").sde
  t_elbo, z_elbo = cpu_sde.get_diffusion_time(
      SMALL_BATCH, torch.tensor(cpu_sde.eps), True, device="cpu",
      u=elbo_draws.u_t)
  out = {}
  for d in ("cpu", "cuda"):
    s = run_lib.build_sampling(small, SMALL_BATCH, device=d, seed=7)
    s.score_model.requires_grad_(False)
    s.flow_model.requires_grad_(False)
    flow_noise = sample_flow_noise(s.flow_model, shape,
                                   torch.Generator().manual_seed(22),
                                   np.random.default_rng(23))
    flow_noise = FlowNoise(flow_noise.enc_eps.to(d),
                           [(v.to(d), n) for v, n in flow_noise.blocks])
    ff = lambda v: flow_forward(small, s.flow_model, v, train=False,
                                noise=flow_noise)
    move = lambda t: type(t)(*map(move, t)) if isinstance(t, tuple) \
        else t.to(d)
    s.sde.get_diffusion_time = lambda *args, **kwargs: (t_elbo.to(d),
                                                       z_elbo.to(d))
    score_fn = get_score_fn(small, s.sde, s.score_model, differentiable=True)
    bpd, _, nfe = likelihood.get_likelihood_fn(
        small, s.sde, lambda v: v, rtol=small.eval.rtol,
        atol=small.eval.atol)(score_fn, ff, x.to(d), noise=move(draws))
    nelbo, _ = likelihood.get_elbo_fn(small, s.sde, lambda v: v)(
        score_fn, ff, x.to(d), noise=move(elbo_draws))
    out[d] = (bpd.cpu(), nfe, nelbo.cpu())
  (bpd_c, nfe_c, ne_c), (bpd_g, nfe_g, ne_g) = out["cpu"], out["cuda"]
  bpd_err = ((bpd_g - bpd_c).abs() / bpd_c.abs()).max().item()
  ne_err = ((ne_g - ne_c).abs() / ne_c.abs()).max().item()
  log(f"tiny likelihood, card against CPU: NFE {nfe_g} vs {nfe_c}, bpd "
      f"{bpd_err:.3e} relative, NELBO {ne_err:.3e}")
  if nfe_g != nfe_c or not bpd_err <= EVAL_SMALL_BPD_RTOL:
    raise AssertionError(f"tiny bits/dim: NFE {nfe_g} vs {nfe_c}, "
                         f"{bpd_err:.3e} relative")
  if not ne_err <= EVAL_SMALL_NELBO_RTOL:
    raise AssertionError(f"tiny NELBO: {ne_err:.3e} relative")
  return {"nfe": nfe_g, "bpd_rel_err": bpd_err, "nelbo_rel_err": ne_err}


# phase 11c: the FID variant, `vp/CIFAR10/indm_fid` on the chain route it
# ships (flow.fused_block off). A `step_fid` step runs the score net forward
# and back once in each phase (kernels 1 and 2: 2 x 95 launches of each)
# and kernel 7 once a block in phase 1 (32); phase 2's recompute estimates
# no log-det and launches no flow kernel. Its GEMM launches are phase 1's,
# those of the NLL step's chain route (check_step_gemms).
FID_WORKDIR = os.path.join(REPO, "build", "chip_smoke_fid")
PER_STEP_FID = {**PER_STEP, "group_norm_fwd": 2 * GN_PER_SCORE_EVAL,
                "group_norm_bwd": 2 * GN_PER_SCORE_EVAL}
# the evaluation's round: eval.num_samples = sampling.batch_size, as many
# images as phase 4's round, whose images the Inception checks read
FID_SAMPLES = BATCH
FID_EVAL = {"eval.enable_bpd": False, "eval.num_samples": FID_SAMPLES,
            "sampling.batch_size": FID_SAMPLES}
# Inception on the card against the same module on the CPU: float32 convs
# (TF32 off) summed in another order through ~50 layers, 1e-4 of the
# largest value; clean_resize: the same float64 products rounded to float32
# twice on both, 1e-4 on the 0-255 scale
INCEPTION_RTOL = 1e-4
RESIZE_ATOL = 1e-4


def kernel_counts():
  """The host's launch counts of every kernel library of the main path."""
  from indm_torch.ops import fused_block as fb
  from indm_torch.ops import fused_stack as fs
  from indm_torch.ops import group_norm as gn
  from indm_torch.ops import neumann
  from indm_torch.ops import upfirdn2d as fir
  return {"group_norm_fwd": gn.launches, "group_norm_bwd": gn.bwd_launches,
          "neumann_chain": neumann.launches,
          "fused_neumann_chain": neumann.fused_launches,
          "neumann_chain_bf16": neumann.bf16_launches,
          "fused_neumann_chain_bf16": neumann.fused_bf16_launches,
          "fused_block_fwd": fb.fwd_launches,
          "fused_block_bwd": fb.bwd_launches,
          "fused_stack_fwd": fs.fwd_launches,
          "fused_stack_bwd": fs.bwd_launches,
          "upfirdn2d": fir.launches, "upfirdn2d_bwd": fir.bwd_launches}


def reset_kernel_counts():
  from indm_torch.ops import fused_block as fb
  from indm_torch.ops import fused_stack as fs
  from indm_torch.ops import group_norm as gn
  from indm_torch.ops import neumann
  from indm_torch.ops import upfirdn2d as fir
  for lib in (gn, neumann, fb, fs, fir):
    lib.reset_launches()


def fid_config():
  from indm_torch.configs import get_config
  cfg = get_config("vp/CIFAR10/indm_fid")
  cfg.model.fused_groupnorm = True
  cfg.flow.logdet_pallas = True
  cfg.optim.reset = False
  cfg.datadir = REPO  # the repository's cifar10_fid_stats_clean.npz
  if (cfg.training.likelihood_weighting or cfg.flow.get("fused_block", False)
      or cfg.training.batch_size != TRAIN_BATCH):
    raise AssertionError("indm_fid is not the FID step on the chain route "
                         "at batch 128")
  return cfg


def phase_fid_steps(cfg, steps=TRAIN_STEPS, workdir=FID_WORKDIR):
  """Phase 11c's training: `steps` full-width `step_fid` steps through
  `run_lib.train_steps`, each step's device time split at phase 2 by CUDA
  events, the launches of every kernel and GEMM per step, peak memory,
  finite losses, both nets and the encoder's BatchNorm statistics moved;
  then the meta pair written to `workdir` (None: not written). Returns
  the numbers."""
  import shutil
  from indm_torch import run_lib
  from indm_torch.flows.resflow import LAMB
  from indm_torch.ops import lipnet_gemm as lg
  if workdir:
    shutil.rmtree(workdir, ignore_errors=True)
  tr = run_lib.build_training(cfg, device="cuda")
  step_fid = tr.step_fn
  if step_fid.__name__ != "step_fid":
    raise AssertionError(f"the FID config trains with {step_fid.__name__}")
  blocks = tr.flow_model.resflow.blocks()
  n_rng = copy.deepcopy(tr.host_rng)
  ns = [int(n_rng.poisson(LAMB)) for _ in range(len(blocks) * steps)]
  marks = []

  def timed_step(batch, **kw):
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    ev[0].record()
    out = step_fid(batch, phase_hook=lambda name: ev[1].record(), **kw)
    ev[2].record()
    marks.append(ev)
    return out

  tr.step_fn = timed_step
  before = _snapshot(tr)
  torch.cuda.synchronize()
  torch.cuda.reset_peak_memory_stats()
  rows, launches = [], collections.Counter()
  for i in range(steps):
    reset_kernel_counts()
    gemms_before = lg.device_gemm_launches()
    (row,) = run_lib.train_steps(tr, 1, log=log)
    counts = kernel_counts()
    gemms = check_step_gemms(gemm_counts_since(gemms_before),
                             ns[i * len(blocks):(i + 1) * len(blocks)],
                             ["chain"] * len(blocks), f"FID step {i}")
    log(f"FID step {i}: launches {counts}")
    if counts != PER_STEP_FID:
      raise AssertionError(f"FID step {i} launched {counts}, expected "
                           f"{PER_STEP_FID}")
    launches.update(counts)
    launches.update({GEMM_KERNELS[k]: v for k, v in gemms.items()})
    rows.append(row)
  torch.cuda.synchronize()
  peak = torch.cuda.max_memory_allocated()
  for row in rows:
    if not all(torch.isfinite(m).all() for m in row["per_example"]):
      raise AssertionError(f"FID step {row['step']}: non-finite losses")
  after = _snapshot(tr)
  moved = {k for k in before if not torch.equal(before[k], after[k])}
  for tag, what in (("score.all_modules.", "score net parameters"),
                    ("flow.generator.flow.", "residual flow parameters"),
                    ("flow.discriminator.encoder.", "encoder")):
    if not any(k.startswith(tag) for k in moved):
      raise AssertionError(f"the FID step left the {what} as they were")
  if not any(k.endswith("running_var") for k in moved):
    raise AssertionError("the BatchNorm running statistics did not change")
  split = [(a.elapsed_time(b), b.elapsed_time(c)) for a, b, c in marks]
  secs = sorted(r["seconds"] for r in rows[1:] or rows)
  sec = secs[len(secs) // 2] if len(secs) % 2 else sum(secs) / len(secs)
  save_s = None
  if workdir:
    tr.workdir = workdir
    t0 = time.perf_counter()
    run_lib.save_training(tr)
    save_s = time.perf_counter() - t0
  out = {"steps": steps, "batch": TRAIN_BATCH,
         "seconds_per_step": sec, "images_per_s": TRAIN_BATCH / sec,
         "step_seconds": [r["seconds"] for r in rows],
         "phase1_ms": [a for a, _ in split], "phase2_ms": [b for _, b in split],
         "peak_memory_gb": peak / 1e9,
         "losses": {k: [r[k] for r in rows] for k in
                    ("losses", "losses_score", "losses_flow", "losses_logp")},
         "launches_per_step": {k: v // steps for k, v in launches.items()},
         "save_seconds": save_s}
  log(f"FID step: seconds/step (median of steps 2-{steps}, or the one) "
      f"{sec:.4f}, "
      f"images/s {TRAIN_BATCH / sec:.3f}, peak memory {peak / 1e9:.3f} GB; "
      f"device ms by CUDA events, phase 1 / phase 2: "
      + ", ".join(f"{a:.1f} / {b:.1f}" for a, b in split)
      + f"; kernel 1 and 2 {PER_STEP_FID['group_norm_fwd']} launches a step "
      f"each, kernel 7 {PER_STEP_FID['neumann_chain']}; {len(moved)} of "
      f"{len(before)} tensors changed; meta pair written in {save_s} s")
  del tr
  torch.cuda.empty_cache()
  return out


def phase_fid_small(cfg):
  """One tiny `step_fid` step, card against CPU, with the same weights
  and draws (phase 2's included) and phase 11's limits on the four losses
  it returns and on each net's gradients (the flow's of phase 1, the score
  net's of phase 2). Both devices take their diffusion times from the
  CPU, phase 1's importance-sampled and phase 2's uniform (phase 11's
  note), and the card takes the CPU's updated flow at phase 2: the first
  AdamW step is lr x sign(g) wherever |g| is well above 1e-8, so a
  gradient a rounding away from zero moves a weight by 2 x lr there."""
  import numpy as np
  from indm_torch import joint, run_lib
  from indm_torch.flows.flow_model import FlowNoise, sample_flow_noise
  from indm_torch.ops import group_norm as gn
  from indm_torch.ops import neumann
  small = set_leaves(cfg, {**SMALL, "model.dropout": 0.0,
                           "training.batch_size": SMALL_BATCH})
  trs = {d: run_lib.build_training(small, device=d, seed=7)
         for d in ("cpu", "cuda")}
  batch = run_lib.next_batch(trs["cpu"])
  shape, b = batch.shape, SMALL_BATCH
  gen = torch.Generator().manual_seed(8)
  flow = sample_flow_noise(trs["cpu"].flow_model, shape, gen,
                           np.random.default_rng(9))
  dim = trs["cpu"].flow_model.discriminator.dim
  noise = joint.StepNoise(
      flow, torch.rand(b, generator=gen), torch.randn(shape, generator=gen),
      torch.randn(shape, generator=gen),
      joint.Phase2Noise(torch.rand(b, generator=gen),
                        torch.randn(shape, generator=gen),
                        torch.randn(b, dim, generator=gen)))
  sde = trs["cpu"].sde
  t_min = sde.get_t_min(device="cpu")
  fixed = {True: sde.get_diffusion_time(b, t_min, True, u=noise.u_t),
           False: sde.get_diffusion_time(b, t_min, False,
                                         u=noise.phase2.u_t)}
  carried, out = {}, {}
  for d, tr in trs.items():
    times = {k: (t.to(d), w.to(d)) for k, (t, w) in fixed.items()}
    tr.sde.get_diffusion_time = (
        lambda times: lambda bs, t_min, imp, *a, **k: times[bool(imp)])(
            times)
    grads = {}
    for tag, model, opt in (("score", tr.score_model, tr.score_opt),
                            ("flow", tr.flow_model, tr.flow_opt)):
      names = [k for k, _ in model.named_parameters()]

      def recording(opt=opt, names=names, tag=tag, step=opt.step):
        grads.update({f"{tag}.{k}": p.grad.detach().cpu().clone()
                      for k, p in zip(names, opt.params)
                      if p.grad is not None})
        step()

      opt.step = recording

    def hook(name, d=d, flow_model=tr.flow_model):
      if d == "cpu":
        carried.update({k: p.detach().clone()
                        for k, p in flow_model.named_parameters()})
        return
      with torch.no_grad():
        for k, p in flow_model.named_parameters():
          p.copy_(carried[k].to(d))

    enc_eps = noise.flow.enc_eps
    nd = joint.StepNoise(
        FlowNoise(None if enc_eps is None else enc_eps.to(d),
                  [(v.to(d), n) for v, n in noise.flow.blocks]),
        noise.u_t.to(d), noise.z.to(d), noise.logp_z.to(d),
        joint.Phase2Noise(*(v.to(d) for v in noise.phase2[:3])))
    reset_kernel_counts()
    metrics = tr.step_fn(batch.to(d), nd, phase_hook=hook)
    if d == "cuda":
      blocks = len(tr.flow_model.resflow.blocks())
      if (neumann.launches != blocks or gn.launches != gn.bwd_launches
          or gn.launches == 0):
        raise AssertionError(f"the tiny FID step launched kernel 7 "
                             f"{neumann.launches} times ({blocks} blocks), "
                             f"kernels 1 and 2 {gn.launches} and "
                             f"{gn.bwd_launches}")
    out[d] = ([m.cpu() for m in metrics], grads)
  (l_cpu, g_cpu), (l_gpu, g_gpu) = out["cpu"], out["cuda"]
  loss_err = max(((g - c).abs().max() / c.abs().max()).item()
                 for g, c in zip(l_gpu, l_cpu))
  if set(g_cpu) != set(g_gpu) or len(g_cpu) < 100:
    raise AssertionError("the card and the CPU produced other gradients")
  grad_err, worst = grad_rel_err(g_cpu, g_gpu)
  log(f"small reference FID step: card vs cpu losses max rel err "
      f"{loss_err:.3e} (limit {TRAIN_SMALL_RTOL}); gradients max rel err "
      f"{grad_err:.3e} at {worst} (limit {TRAIN_SMALL_GRAD_RTOL}, "
      f"{len(g_cpu)} tensors)")
  if not (loss_err <= TRAIN_SMALL_RTOL and grad_err <= TRAIN_SMALL_GRAD_RTOL):
    raise AssertionError("the tiny FID step on the card disagrees with the "
                         "CPU")
  return {"loss_rel_err": loss_err, "grad_rel_err": grad_err}


def phase_inception(samples_path):
  """Phase 11c's Inception checks on phase 4's round of FID_SAMPLES
  images: `clean_resize` and the features (pool and logits) on the card
  against the same functions and module on the CPU, then the card's ms an
  image for each (CUDA events, batch FID_SAMPLES; the resize with its
  upload)."""
  import numpy as np
  from indm_torch import evaluation
  from indm_torch.metrics import inception
  with np.load(samples_path) as z:
    u8 = z["samples"]
  if u8.shape != (FID_SAMPLES, 32, 32, 3) or u8.dtype != np.uint8:
    raise AssertionError(f"phase 4's round: {u8.shape} {u8.dtype}")
  models = {d: inception.load_inception(device=d) for d in ("cpu", "cuda")}
  if inception.weights_source() != "random":
    raise AssertionError(f"Inception weights from "
                         f"{inception.weights_source()}, not the seeded ones")
  resized = {d: evaluation.clean_resize(u8, device=d).cpu()
             for d in ("cpu", "cuda")}
  resize_err = (resized["cuda"] - resized["cpu"]).abs().max().item()
  feats = {d: evaluation.get_inception_features(u8, models[d], device=d)
           for d in ("cpu", "cuda")}
  errs = [float(np.abs(g - c).max() / np.abs(c).max())
          for g, c in zip(feats["cuda"], feats["cpu"])]
  x = resized["cuda"].cuda() / 255.0

  @torch.no_grad()
  def forward():
    return models["cuda"](x)

  resize_ms = cuda_ms(lambda: evaluation.clean_resize(u8, device="cuda"),
                      5, 1) / FID_SAMPLES
  forward_ms = cuda_ms(forward, 5, 1) / FID_SAMPLES
  out = {"images": FID_SAMPLES, "resize_max_abs_err": resize_err,
         "pool_rel_err": errs[0], "logits_rel_err": errs[1],
         "resize_ms_per_image": resize_ms,
         "forward_ms_per_image": forward_ms,
         "pool_max": float(np.abs(feats["cuda"][0]).max())}
  log(f"Inception on phase 4's {FID_SAMPLES} images, card vs CPU: "
      f"clean_resize max abs err {resize_err:.3e} (0-255 scale, limit "
      f"{RESIZE_ATOL}), pool {errs[0]:.3e}, logits {errs[1]:.3e} of the "
      f"largest value (limit {INCEPTION_RTOL}); on the card "
      f"{resize_ms:.4f} ms an image to resize (upload included), "
      f"{forward_ms:.4f} ms an image through InceptionV3 (batch "
      f"{FID_SAMPLES})")
  if not (resize_err <= RESIZE_ATOL and max(errs) <= INCEPTION_RTOL):
    raise AssertionError("Inception or clean_resize on the card disagrees "
                         "with the CPU")
  del models
  torch.cuda.empty_cache()
  return out


def phase_fid_eval(cfg):
  """Phase 11c's evaluation: `run_lib.evaluate` on the FID steps'
  checkpoint, no bits/dim, one round of FID_SAMPLES images and its FID,
  IS and image count with the seeded weights; kernel 1's launches in the
  round 95 x (NFE + 1); then the same FID by Newton-Schulz on the card
  beside SciPy's sqrtm on the host, each with its seconds."""
  import shutil
  import numpy as np
  from indm_torch import evaluation, run_lib
  from indm_torch.metrics import fid as fid_lib
  from indm_torch.ops import group_norm as gn
  ecfg = set_leaves(cfg, FID_EVAL)
  eval_dir = os.path.join(FID_WORKDIR, "eval")
  shutil.rmtree(eval_dir, ignore_errors=True)
  reset_kernel_counts()
  t0 = time.perf_counter()
  res = run_lib.evaluate(ecfg, FID_WORKDIR, device="cuda", log=log)
  total_s = time.perf_counter() - t0
  report, (rnd,) = res["fid"], res["rounds"]
  want = GN_PER_SCORE_EVAL * (rnd["nfe"] + 1)
  if gn.launches != want:
    raise AssertionError(f"the evaluation's round launched kernel 1 "
                         f"{gn.launches} times, expected {want}")
  if res["step"] != TRAIN_STEPS or res["bpd"] is not None:
    raise AssertionError(f"evaluated step {res['step']}")
  if not (report["num_samples"] == FID_SAMPLES
          and report["weights"] == "random"
          and math.isfinite(report["fid"])
          and math.isfinite(report["inception_score"])):
    raise AssertionError(f"FID report {report}")
  with np.load(os.path.join(eval_dir, "latents_0.npz")) as z:
    pools = z["pool_3"]
  mu, sigma = fid_lib.compute_statistics(pools)
  mu_r, sigma_r, _ = evaluation.dataset_statistics(ecfg, None, device="cuda")
  torch.cuda.synchronize()
  t0 = time.perf_counter()
  ns_fid = float(fid_lib.frechet_distance_newton_schulz(mu, sigma, mu_r,
                                                        sigma_r))
  ns_s = time.perf_counter() - t0
  out = {"step": res["step"], "evaluate_seconds": total_s,
         "round": {k: rnd[k] for k in ("nfe", "seconds", "images_per_s")},
         "fid": report["fid"], "inception_score": report["inception_score"],
         "num_samples": report["num_samples"], "weights": report["weights"],
         "sqrtm_seconds": report["sqrtm_seconds"],
         "newton_schulz_fid": ns_fid, "newton_schulz_seconds": ns_s,
         "group_norm_fwd_launches": gn.launches}
  log(f"evaluate at step {res['step']}: FID {report['fid']:.4f} (sqrtm on "
      f"the host, {report['sqrtm_seconds']:.3f} s), Newton-Schulz on the "
      f"card {ns_fid:.4f} ({ns_s:.3f} s), IS "
      f"{report['inception_score']:.4f}, N {report['num_samples']}, weights "
      f"{report['weights']}; {total_s:.1f} s in all, the round's NFE "
      f"{rnd['nfe']} in {rnd['seconds']:.3f} s. A FID of {FID_SAMPLES} images "
      "through random Inception weights is no quality figure: below 2048 "
      "images the sample covariance is singular and its square root "
      "inexact")
  torch.cuda.empty_cache()
  return out


# phase 12: VE training (`ve/CIFAR10/indm`) from CIFAR-10 on disk. Phase
# 12a holds kernel 9's backward (the adjoint launch of `Upfirdn2dFn`) at the
# VE net's FIR calls at batch 128; 12b runs `run_lib.train` at full width
# and batch 128 on seeded files in CIFAR-10's own layout (VE_DATA_PER_FILE
# images a pickle); 12c runs `python -m indm_torch.main` on the same files:
# train, resume, evaluate with `eval.data_mean`. A training step runs one
# VE net pass each way: kernel 1 and kernel 2 95 times, kernel 9 15 times
# forward and 15 backward, kernel 7 once for each of the 32 iResBlocks.
VE_DATA_DIR = os.path.join(REPO, "build", "chip_smoke_cifar")
VE_DATA_PER_FILE = 256
VE_TRAIN_WORKDIR = os.path.join(REPO, "build", "chip_smoke_ve_train")
VE_MAIN_WORKDIR = os.path.join(REPO, "build", "chip_smoke_ve_main")
PER_STEP_VE = {**PER_STEP, "upfirdn2d": VE_FIR_PER_EVAL,
               "upfirdn2d_bwd": VE_FIR_PER_EVAL}
# the VE train loop of 12b: steps 0..VE_N_ITERS (the JAX loop's count)
VE_N_ITERS = TRAIN_STEPS - 1
# 12c: two steps, one more after the resume (both in this process: a depth
# cut that makes room for phase 17); the evaluation (a child process): bits/dim on one test batch of 16 (of 128: depth cuts that
# made room for phase 14, to 32, and for phase 17, to 16; RK45 at 1e-3),
# the latent mean over one training batch (of two until phase 17), one PC
# round of 64 images at VE_MAIN_SCALES scales
VE_MAIN_SCALES = 10
VE_MAIN_EVAL = {"eval.batch_size": 16,
                "eval.num_test_data": 16, "eval.num_nelbo": 1,
                "eval.skip_nll_wrong": True, "eval.rtol": 1e-3,
                "eval.atol": 1e-3, "eval.data_mean": True,
                "training.num_train_data": TRAIN_BATCH,
                "eval.num_samples": BATCH, "sampling.batch_size": BATCH,
                "sampling.num_scales": VE_MAIN_SCALES}


def write_cifar10(root):
  """Seeded images in CIFAR-10's python layout under
  `<root>/cifar-10-batches-py/`: five training pickles and a test pickle
  of VE_DATA_PER_FILE images each (`data` uint8 [N, 3072] in CHW order,
  `labels`)."""
  import pickle
  import shutil
  import numpy as np
  shutil.rmtree(root, ignore_errors=True)
  base = os.path.join(root, "cifar-10-batches-py")
  os.makedirs(base)
  rng = np.random.default_rng(10)
  for name in [f"data_batch_{i}" for i in range(1, 6)] + ["test_batch"]:
    x = rng.integers(0, 256, (VE_DATA_PER_FILE, 3 * 32 * 32), dtype=np.uint8)
    with open(os.path.join(base, name), "wb") as f:
      pickle.dump({b"data": x, b"labels": list(
          rng.integers(0, 10, VE_DATA_PER_FILE))}, f)


def fir_backward_library(x, dy, k, up, down, pad):
  """The input gradient of row 9's library call (`fir_library`) as
  autograd computes it: aten's convolution_backward of the grouped
  F.conv2d (then the pad's backward, a slice) or, for up = 2, of the
  grouped F.conv_transpose2d."""
  c = x.shape[1]
  kh, kw = k.shape
  kt = torch.from_numpy(k).to(x.device)
  conv_bwd = torch.ops.aten.convolution_backward
  mask = [True, False, False]
  if up == 1:
    w = torch.flip(kt, (0, 1)).expand(c, 1, kh, kw).contiguous()
    import torch.nn.functional as F
    xp = F.pad(x, (pad[0], pad[1], pad[0], pad[1]))
    h, wd = x.shape[2:]

    def call():
      dxp = conv_bwd(dy, xp, w, None, [down, down], [0, 0], [1, 1], False,
                     [0, 0], c, mask)[0]
      return dxp[:, :, pad[0]:pad[0] + h, pad[0]:pad[0] + wd]
    return call
  w = kt.expand(c, 1, kh, kw).contiguous()
  padding = kh - 1 - pad[0]
  extra = pad[1] - pad[0] + up - 1
  return lambda: conv_bwd(dy, x, w, None, [up, up], [padding, padding],
                          [1, 1], True, [extra, extra], c, mask)[0]


def phase_fir_backward(cfg):
  """12a: kernel 9's backward at each distinct FIR call of the full-width
  VE net at batch 128: the input gradient of `Upfirdn2dFn` (one forward
  and one backward launch) against autograd of the plain version on
  float64 inputs, within FIR_RTOL of its largest value; the backward's
  launch timed by `timed` beside its bytes bound, autograd of the plain
  version in float32 and the library's backward (`fir_backward_library`,
  also held to the float64 gradient). Returns the per-step sums (one
  backward pass: VE_FIR_PER_EVAL launches), the largest error and the rows
  by shape."""
  from indm_torch import sde as sde_lib
  from indm_torch.models.registry import create_model
  from indm_torch.ops import upfirdn2d as fir
  import numpy as np
  model = create_model(cfg, seed=cfg.seed, device="cuda")
  sde = sde_lib.get_sde(cfg)
  gen = torch.Generator(device="cuda").manual_seed(12)
  size = cfg.data.image_size
  x = torch.randn(TRAIN_BATCH, 3, size, size, device="cuda", generator=gen)
  t = torch.full((TRAIN_BATCH,), 0.3, device="cuda")
  calls = fir_calls(model, x, sde.marginal_prob(x, t)[1])
  del model, x
  torch.cuda.empty_cache()
  n_calls = sum(call[-1] for call in calls)
  if n_calls != VE_FIR_PER_EVAL:
    raise AssertionError(f"expected {VE_FIR_PER_EVAL} upfirdn2d calls, got "
                         f"{n_calls}")
  per_step, max_err, by_shape = collections.defaultdict(float), 0.0, []
  for shape, up, down, pad, k, count in calls:
    x = torch.randn(shape, device="cuda", generator=gen)
    kk = fir.taps(k).k
    h = shape[2]
    oh = fir.out_size(h, kk.shape[0], up, down, pad)
    dy = torch.randn((shape[0], shape[1], oh, oh), device="cuda",
                     generator=gen)
    adjoint = (np.ascontiguousarray(kk[::-1, ::-1]), down, up,
               fir.adjoint_pads(h, oh, kk.shape[0], up, down, pad))
    fir.reset_launches()
    xr = x.clone().requires_grad_(True)
    y = fir.Upfirdn2dFn.apply(xr, k, up, down, pad)
    (dx,) = torch.autograd.grad(y, xr, dy)
    torch.cuda.synchronize()
    if (fir.launches, fir.bwd_launches) != (1, 1):
      raise AssertionError(f"Upfirdn2dFn launched (forward, backward) = "
                           f"{(fir.launches, fir.bwd_launches)}")
    x64 = x.double().requires_grad_(True)
    (ref,) = torch.autograd.grad(
        fir.upfirdn2d_plain(x64, k, up, down, pad), x64, dy.double())
    big = ref.abs().max().item()
    err = (dx.double() - ref).abs().max().item()
    library = fir_backward_library(x, dy, kk, up, down, pad)
    lib_err = (library().double() - ref).abs().max().item()
    if dx.shape != x.shape or not (math.isfinite(err)
                                   and err <= FIR_RTOL * big):
      raise AssertionError(f"upfirdn2d backward {shape} up={up} down={down} "
                           f"pad={pad}: max abs err {err} over {FIR_RTOL} x "
                           f"{big}")
    if not lib_err <= FIR_RTOL * big:
      raise AssertionError(f"the library's backward computes another "
                           f"function at {shape} up={up}")
    max_err = max(max_err, err)
    times = timed(lambda: fir._launch(dy, *adjoint), library)
    xp = x.clone().requires_grad_(True)
    yp = fir.upfirdn2d_plain(xp, k, up, down, pad)
    times["plain_ms"] = cuda_ms(lambda: torch.autograd.grad(
        yp, xp, dy, retain_graph=True))
    times["bound_ms"] = 4 * (dy.numel() + dx.numel()) / HBM_BYTES_PER_S * 1e3
    log(f"upfirdn2d backward {list(shape)} <- {list(dy.shape)} (adjoint up="
        f"{adjoint[1]} down={adjoint[2]} pad={adjoint[3]}) x{count}/step: "
        f"max_abs_err={err:.3e} (max |dx| {big:.3e}) "
        + " ".join(f"{k_}={v:.5f}" for k_, v in times.items())
        + f" ({times['bound_ms'] / times['graph_ms']:.3f} of the bound by "
        "graph_ms)")
    by_shape.append({"shape": list(shape), "up": up, "down": down,
                     "pad": list(pad), "adjoint_pad": list(adjoint[3]),
                     "count": count, "max_abs_err": err, **times})
    for key, v in times.items():
      per_step[key] += count * v
    del x, dy, xr, y, dx, x64, ref, xp, yp
  fir.reset_launches()
  log(f"upfirdn2d backward per training step ({n_calls} launches): "
      + " ".join(f"{k_}={v:.5f}" for k_, v in per_step.items())
      + f" ({per_step['bound_ms'] / per_step['graph_ms']:.3f} of the bound "
      "by graph_ms)")
  return dict(per_step), max_err, by_shape


def ve_train_config():
  from indm_torch.configs import get_config
  cfg = get_config("ve/CIFAR10/indm")
  cfg.model.fused_groupnorm = True
  cfg.flow.logdet_pallas = True
  cfg.datadir = VE_DATA_DIR
  cfg.training.n_iters = VE_N_ITERS
  cfg.training.log_freq = 1
  cfg.training.snapshot_sampling = False
  if cfg.training.batch_size != TRAIN_BATCH or cfg.model.nf != 128:
    raise AssertionError("the VE config is not at full width and batch 128")
  return cfg


def phase_ve_train(cfg):
  """12b: `run_lib.train` on the seeded files: TRAIN_STEPS steps of
  `step_nll` under VESDE with both log lines a step, each step's launches
  exactly PER_STEP_VE, finite losses that sum, both nets and the encoder's
  statistics moved, the meta pair written at the end; seconds a step,
  images/s and peak memory; then one more step under the profiler."""
  import shutil
  from indm_torch import data as data_lib
  from indm_torch import run_lib
  if data_lib.is_synthetic(cfg):
    raise AssertionError(f"no CIFAR-10 files under {VE_DATA_DIR}")
  shutil.rmtree(VE_TRAIN_WORKDIR, ignore_errors=True)
  rows, seen, lines = [], {}, []

  def on_step(row):
    torch.cuda.synchronize()
    counts = kernel_counts()
    step = {k: v - seen.get(k, 0) for k, v in counts.items()}
    seen.update(counts)
    log(f"VE train step {row['step']}: launches {step}")
    if step != PER_STEP_VE:
      raise AssertionError(f"VE step {row['step']} launched {step}, "
                           f"expected {PER_STEP_VE}")
    rows.append(row)

  def logged(msg):
    lines.append(msg)
    log(msg)

  torch.cuda.synchronize()
  torch.cuda.reset_peak_memory_stats()
  reset_kernel_counts()
  t0 = time.perf_counter()
  tr = run_lib.train(cfg, VE_TRAIN_WORKDIR, device="cuda", log=logged,
                     on_step=on_step)
  torch.cuda.synchronize()
  total_s = time.perf_counter() - t0
  launches = kernel_counts()
  peak = torch.cuda.max_memory_allocated()
  if len(rows) != TRAIN_STEPS or tr.step != TRAIN_STEPS:
    raise AssertionError(f"{len(rows)} steps, step {tr.step}")
  for row in rows:
    per = row["per_example"]
    if not all(torch.isfinite(m).all() for m in per):
      raise AssertionError(f"VE step {row['step']}: non-finite losses")
    if not torch.allclose(per[0], per[1] + per[2] + per[3], rtol=1e-5,
                          atol=1e-3):
      raise AssertionError("VE losses != score + flow + logp")
  for step in range(TRAIN_STEPS):
    for what in ("loss mean", "loss std"):
      if not any(l.startswith(f"step: {step}, {what}: ") for l in lines):
        raise AssertionError(f"no '{what}' line for step {step}")
  meta = os.path.join(VE_TRAIN_WORKDIR, "checkpoints-meta", "checkpoint.pth")
  if torch.load(meta, weights_only=True)["step"] != TRAIN_STEPS:
    raise AssertionError("the meta checkpoint is not at the last step")
  profile = profile_train_step(dataclasses.replace(tr, workdir=None))
  fresh = run_lib.build_training(cfg, device="cuda")
  moved = []
  for tag, a, b in (("score", fresh.score_model, tr.score_model),
                    ("flow", fresh.flow_model, tr.flow_model)):
    sa, sb = a.state_dict(), b.state_dict()
    moved += [f"{tag}.{k}" for k in sa if not torch.equal(sa[k], sb[k])]
  del fresh, tr
  torch.cuda.empty_cache()
  for tag in ("score.all_modules.", "flow.generator.flow.",
              "flow.discriminator.encoder."):
    if not any(k.startswith(tag) for k in moved):
      raise AssertionError(f"{tag} did not change")
  secs = sorted(r["seconds"] for r in rows[1:])
  sec = secs[len(secs) // 2] if len(secs) % 2 else sum(secs) / len(secs)
  out = {"steps": TRAIN_STEPS, "batch": TRAIN_BATCH,
         "seconds_per_step": sec, "images_per_s": TRAIN_BATCH / sec,
         "peak_memory_gb": peak / 1e9,
         "step_seconds": [r["seconds"] for r in rows],
         "losses": [r["losses"] for r in rows], "total_seconds": total_s,
         "launches": launches,
         "launches_per_step": {k: v // TRAIN_STEPS
                               for k, v in launches.items()},
         "data_images": 5 * VE_DATA_PER_FILE, "profile": profile}
  log(f"VE train: seconds/step (median of steps 2-{TRAIN_STEPS}) {sec:.3f}, "
      f"images/s {TRAIN_BATCH / sec:.3f}, peak memory {peak / 1e9:.3f} GB, "
      f"the loop {total_s:.1f} s; launches a step "
      f"{out['launches_per_step']}")
  return out


def run_main(mode, sets):
  """`python -m indm_torch.main --mode MODE --config ve/CIFAR10/indm` on
  the card in a child process (stopped at the end), its output logged;
  raises if it fails."""
  args = [sys.executable, "-m", "indm_torch.main", "--mode", mode,
          "--config", "ve/CIFAR10/indm", "--workdir", VE_MAIN_WORKDIR]
  for k, v in sets.items():
    args += ["--set", f"{k}={v}"]
  t0 = time.perf_counter()
  proc = subprocess.run(args, cwd=REPO, capture_output=True, text=True,
                        env={**os.environ, "INDM_DATA_DIR": VE_DATA_DIR},
                        timeout=600)
  seconds = time.perf_counter() - t0
  for line in (proc.stdout + proc.stderr).splitlines()[-40:]:
    log(f"  [main {mode}] {line}")
  if proc.returncode != 0:
    raise AssertionError(f"python -m indm_torch.main --mode {mode} exited "
                         f"{proc.returncode}")
  return proc.stdout, seconds


def train_in_process(sets):
  """`python -m indm_torch.main --mode train`'s entry with `run_main`'s
  arguments and $INDM_DATA_DIR, in this process; returns the text of its
  log, `<workdir>/stdout.txt`, and the seconds."""
  from indm_torch import main as main_lib
  args = ["--mode", "train", "--config", "ve/CIFAR10/indm", "--workdir",
          VE_MAIN_WORKDIR]
  for k, v in sets.items():
    args += ["--set", f"{k}={v}"]
  old = os.environ.get("INDM_DATA_DIR")
  os.environ["INDM_DATA_DIR"] = VE_DATA_DIR
  t0 = time.perf_counter()
  try:
    main_lib.main(args)
  finally:
    if old is None:
      del os.environ["INDM_DATA_DIR"]
    else:
      os.environ["INDM_DATA_DIR"] = old
  seconds = time.perf_counter() - t0
  torch.cuda.empty_cache()
  with open(os.path.join(VE_MAIN_WORKDIR, "stdout.txt")) as f:
    return f.read(), seconds


def phase_ve_main():
  """12c: `python -m indm_torch.main` on the seeded files (through
  $INDM_DATA_DIR), full width, batch 128: `--mode train` to n_iters 1 (two
  steps), then to 2 (the resume: one step from the meta checkpoint), both
  through its entry in this process (`train_in_process`, the log read from
  `<workdir>/stdout.txt`), then `--mode eval` with VE_MAIN_EVAL
  (`eval.data_mean` on) in a child process.
  Checks both log lines of every step, the checkpoints' steps, finite
  bits/dim, the latent mean and the round's images, and the FID line."""
  import shutil
  import numpy as np
  shutil.rmtree(VE_MAIN_WORKDIR, ignore_errors=True)
  base = {"training.log_freq": 1, "training.snapshot_sampling": False}
  out = {}
  for n_iters, key in ((1, "train"), (2, "resume")):
    stdout, seconds = train_in_process({**base,
                                        "training.n_iters": n_iters})
    out[f"{key}_seconds"] = seconds
    first = 0 if key == "train" else 2
    for step in range(first, n_iters + 1):
      for what in ("loss mean", "loss std"):
        if f"step: {step}, {what}: " not in stdout:
          raise AssertionError(f"{key}: no '{what}' line for step {step}")
    if "synthetic" in stdout:
      raise AssertionError(f"{key} trained on the synthetic set")
    state = torch.load(os.path.join(VE_MAIN_WORKDIR, "checkpoints-meta",
                                    "checkpoint.pth"), weights_only=True)
    if state["step"] != n_iters + 1:
      raise AssertionError(f"{key}: meta checkpoint at step {state['step']}")
  if "Starting training loop at step 2." not in stdout:
    raise AssertionError("the second call did not resume at step 2")
  if not os.path.exists(os.path.join(VE_MAIN_WORKDIR, "stdout.txt")):
    raise AssertionError("no stdout.txt in the work directory")
  stdout, seconds = run_main("eval", {**base, **VE_MAIN_EVAL})
  out["eval_seconds"] = seconds
  for what in ("mean nelbo bpd", "[NLL CORRECT", "latent data mean over",
               "round 0: nfe=", "FID: "):
    if what not in stdout:
      raise AssertionError(f"eval: no '{what}' in the log")
  nll = [l for l in stdout.splitlines() if "[NLL CORRECT" in l
         and "(nfe" in l][-1]
  bpd = float(nll.split("mean nll bpd: ")[1].split(",")[0])
  if not math.isfinite(bpd):
    raise AssertionError(f"eval: bits/dim {bpd}")
  with np.load(os.path.join(VE_MAIN_WORKDIR, "eval", "samples_0.npz")) as z:
    samples = z["samples"]
  if samples.shape != (BATCH, 32, 32, 3) or not np.isfinite(samples).all():
    raise AssertionError(f"eval: samples {samples.shape}")
  out.update({"nll_bpd": bpd, "nll_line": nll,
              "fid_line": [l for l in stdout.splitlines()
                           if "FID: " in l][-1]})
  log(f"VE main: train {out['train_seconds']:.1f} s, resume "
      f"{out['resume_seconds']:.1f} s, eval {out['eval_seconds']:.1f} s; "
      f"{nll}")
  return out


# phase 13: CelebA at 64x64 (`vp/CELEBA/indm_nll`, `vp/CELEBA/indm_fid`,
# `ve/CELEBA/indm`). The flow squeezes the image to 32x32x12 before the
# resflow, which squeezes again to 16x16x48 between its scales: kernel 7
# at 12 channels on 32x32 and at 48 on 16x16 (conv_in's K in six groups,
# conv_out's outputs in four blocks). The score nets run at 64x64: kernel
# 1 and 2's rows four times longer, two of the backward's shapes on its
# one-block-a-row kernel, kernel 9 on 64x64 planes. 13a kernel 7 alone;
# 13b kernels 1, 2 and 9 at the 64x64 nets' calls; 13c three
# `vp/CELEBA/indm_nll` steps at batch 128, then one ODE round at
# CELEBA_SAMPLE_BATCH; 13d one `step_fid` step; 13e `indm_torch.main
# --config ve/CELEBA/indm` on a seeded PNG folder in CelebA's geometry,
# decoded without PIL: two steps with kernel 9's launches checked, then
# `--mode eval` (bits/dim on one test batch, one PC round at
# CELEBA_MAIN_SCALES scales, FID against statistics computed from the
# folder and cached beside it), both in this process.
CELEBA_SCALES = ((12, 32), (48, 16))
CELEBA_NS = (2, 6)
CELEBA_DATA_DIR = os.path.join(REPO, "build", "chip_smoke_celeba")
CELEBA_WORKDIR = os.path.join(REPO, "build", "chip_smoke_celeba_main")
# train/ and test/ files (of 162 770, 19 962): one training batch and one
# test batch (from (256, 128): a depth cut that makes room for phase 17)
CELEBA_IMAGES = (128, 16)
CELEBA_SAMPLE_BATCH = 4    # the VP ODE round's batch (a depth cut)
CELEBA_MAIN_SCALES = 10    # the PC round's scales (of 1000; a depth cut)
# 13e's evaluation: bits/dim on one test batch of 16 (of 128; depth cuts),
# RK45 at 1e-3
CELEBA_MAIN_EVAL = {"eval.batch_size": 16,
                    "eval.num_test_data": 16, "eval.num_nelbo": 1,
                    "eval.skip_nll_wrong": True, "eval.rtol": 1e-3,
                    "eval.atol": 1e-3, "eval.num_samples": BATCH,
                    "sampling.batch_size": BATCH,
                    "sampling.num_scales": CELEBA_MAIN_SCALES}


def celeba_config(name):
  from indm_torch.configs import get_config
  cfg = get_config(name)
  cfg.model.fused_groupnorm = True
  cfg.flow.logdet_pallas = True
  cfg.model.init_scale = 1.0
  if (cfg.data.image_size, cfg.model.nf, cfg.flow.intermediate_dim,
      cfg.training.batch_size) != (64, 128, 512, TRAIN_BATCH):
    raise AssertionError(f"{name} is not CelebA at full width")
  return cfg


def write_celeba(root):
  """Seeded RGB PNGs in CelebA's geometry (178 x 218, its aligned crops)
  under `<root>/celeba/train/` and `test/` (CELEBA_IMAGES), written
  without PIL (`image_io.write_png`, all five row filters)."""
  import shutil
  import numpy as np
  from indm_torch import image_io
  shutil.rmtree(root, ignore_errors=True)
  rng = np.random.default_rng(13)
  for split, n in zip(("train", "test"), CELEBA_IMAGES):
    folder = os.path.join(root, "celeba", split)
    os.makedirs(folder)
    for i in range(n):
      img = (np.cumsum(rng.normal(size=(218, 178, 3)), axis=1) * 8
             + rng.uniform(40, 215)).clip(0, 255).astype(np.uint8)
      image_io.write_png(os.path.join(folder, f"{i:06d}.png"), img)


def phase_celeba_chain(chain_convs):
  """13a: kernel 7 alone at CelebA's two flow scales at batch 128 and
  width 512, pre-activated (n = 2 and 6) and not (n = 6): held against the
  plain version on float64 inputs within CHAIN_RTOL of the largest value;
  at n = 6 its ms beside the bound, the plain version in float32 and the
  `F.conv2d` chain. Returns the per-term times by (scale, pre-activated),
  the largest error, the rows and conv_in's and conv_out's registers and
  spills at 12 and 48 channels."""
  from indm_torch.flows.resflow import OFFSET_TRAIN, RCDF_TRAIN
  from indm_torch.ops import neumann
  gen = torch.Generator(device="cuda").manual_seed(13)
  per_term, max_err, rows = {}, 0.0, []
  for scale, (c, hw) in enumerate(CELEBA_SCALES):
    flops = chain_flops_per_term(TRAIN_BATCH, c, hw)
    for preact in (True, False):
      vareps, dacts, ws = chain_inputs(TRAIN_BATCH, c, hw, preact, gen)
      for n in (CELEBA_NS if preact else CELEBA_NS[-1:]):
        args = (vareps, dacts, ws, n, OFFSET_TRAIN, RCDF_TRAIN)
        acc = neumann.neumann_chain(*args)
        ref = neumann.neumann_chain_plain(
            f64(vareps), f64(dacts), f64(ws), n, OFFSET_TRAIN, RCDF_TRAIN,
            compute_dtype=torch.float32)
        err = (acc.double() - ref).abs().max().item()
        big = ref.abs().max().item()
        del ref
        if not (math.isfinite(err) and err <= CHAIN_RTOL * big):
          raise AssertionError(f"neumann_chain [{TRAIN_BATCH},{c},{hw},{hw}] "
                               f"preact={preact} n={n}: max abs err {err} "
                               f"over {CHAIN_RTOL} x {big} (float64 plain)")
        max_err = max(max_err, err)
        terms = n + OFFSET_TRAIN
        row = {"shape": [TRAIN_BATCH, c, hw, hw], "preact": preact, "n": n,
               "max_abs_err": err, "max_abs": big}
        if n == max(CELEBA_NS):
          times = {
              "ms": cuda_ms(lambda: neumann.neumann_chain(*args), 3, 1),
              "plain_ms": cuda_ms(
                  lambda: neumann.neumann_chain_plain(*args), 3, 1),
              "library_ms": cuda_ms(
                  lambda: chain_library(vareps, dacts, ws, n), 3, 1)}
          bound, simt, by = flow_bounds(
              scaled(flops, terms),
              flow_bytes("chain", TRAIN_BATCH, c, hw, preact))
          row.update(times, bound_ms=bound, simt_bound_ms=simt, bound_by=by)
          per_term[(scale, preact)] = {k: v / terms for k, v in times.items()}
        log(f"CelebA neumann_chain [{TRAIN_BATCH},{c},{hw},{hw}] width "
            f"{CHAIN_WIDTH} preact={preact} n={n} ({terms} terms): "
            f"max_abs_err={err:.3e} against float64 (max |acc| {big:.3e}) "
            + " ".join(f"{k}={v:.4f}" for k, v in row.items()
                       if k == "ms" or k.endswith("_ms"))
            + (f" ({row['bound_ms'] / row['ms']:.3f} of the bound)"
               if "ms" in row else ""))
        rows.append(row)
      del vareps, dacts, ws
      torch.cuda.empty_cache()
  ptxas = {k: v for k, v in chain_convs.items() if "bfloat16" not in k
           and any(f"ILi{c}E" in k for c, _ in CELEBA_SCALES)}
  for k, v in ptxas.items():
    log(f"CelebA kernel 7 ptxas -v {k}: {' | '.join(v)}")
  return per_term, max_err, rows, ptxas


def phase_celeba_score_kernels():
  """13b: kernel 1 (float32) at the 64x64 VP net's 95 GroupNorm calls at
  batch 64 and kernel 2 at the same shapes at batch 128 (two of them on
  the one-block-a-row kernel); kernel 9 at the 64x64 VE net's 15 calls at
  batch 64, and its backward at batch 128; each against its plain
  version, timed beside its bound, the plain version and the library
  call (`phase_group_norm`, `phase_group_norm_backward`, `phase_fir`,
  `phase_fir_backward`). Returns the four results."""
  from indm_torch import sde as sde_lib
  from indm_torch.models.registry import create_model
  out = {}
  gen = torch.Generator(device="cuda").manual_seed(14)
  x = torch.randn(BATCH, 3, 64, 64, device="cuda", generator=gen)
  t = torch.full((BATCH,), 0.3, device="cuda")
  cfg = celeba_config("vp/CELEBA/indm_nll")
  model = create_model(cfg, seed=cfg.seed, device="cuda")
  gn_eval, gn_err, shapes, gn_rows = phase_group_norm(
      model, x, t * 999, dtypes=(torch.float32,))
  del model
  torch.cuda.empty_cache()
  out["group_norm_fwd"] = (gn_eval, gn_err, gn_rows)
  out["group_norm_bwd"] = phase_group_norm_backward(
      shapes, dtypes=(torch.float32,))
  torch.cuda.empty_cache()
  ve = celeba_config("ve/CELEBA/indm")
  model = create_model(ve, seed=ve.seed, device="cuda")
  sde = sde_lib.get_sde(ve)
  out["upfirdn2d"] = phase_fir(fir_calls(model, x,
                                         sde.marginal_prob(x, t)[1]))
  del model
  torch.cuda.empty_cache()
  out["upfirdn2d_bwd"] = phase_fir_backward(ve)
  torch.cuda.empty_cache()
  return out


def phase_celeba_main():
  """13e: `indm_torch.main --config ve/CELEBA/indm` at full width and batch
  128 on the seeded PNG folder (`write_celeba`; `datadir` set to it):
  `--mode train` for two steps in this process, so that each step's
  launches are held to PER_STEP_VE (kernel 9 15 times each way), with
  both log lines in `<workdir>/stdout.txt`, the folder decoded without PIL
  and its `celeba_64.npz` cache written; then `--mode eval` with
  CELEBA_MAIN_EVAL, its log read from `<workdir>/evaluation_history.txt`:
  bits/dim on one test batch, one PC round of 64x64 images, FID."""
  import shutil
  import numpy as np
  from indm_torch import main as main_lib
  from indm_torch import run_lib
  t0 = time.perf_counter()
  write_celeba(CELEBA_DATA_DIR)
  write_s = time.perf_counter() - t0
  shutil.rmtree(CELEBA_WORKDIR, ignore_errors=True)
  sets = {"datadir": CELEBA_DATA_DIR, "training.log_freq": 1,
          "training.snapshot_sampling": False, "training.n_iters": 1}
  argv = ["--mode", "train", "--config", "ve/CELEBA/indm", "--workdir",
          CELEBA_WORKDIR] + [a for k, v in sets.items()
                             for a in ("--set", f"{k}={v}")]
  steps, seen = [], {}

  def on_step(row):
    torch.cuda.synchronize()
    counts = kernel_counts()
    step = {k: v - seen.get(k, 0) for k, v in counts.items()}
    seen.update(counts)
    log(f"CelebA main train step {row['step']}: launches {step}")
    if step != PER_STEP_VE:
      raise AssertionError(f"CelebA step {row['step']} launched {step}, "
                           f"expected {PER_STEP_VE}")
    steps.append((row, step))

  train = run_lib.train
  run_lib.train = lambda *a, **kw: train(*a, on_step=on_step, **kw)
  reset_kernel_counts()
  t0 = time.perf_counter()
  try:
    main_lib.main(argv)
  finally:
    run_lib.train = train
  train_s = time.perf_counter() - t0
  if len(steps) != 2:
    raise AssertionError(f"main --mode train took {len(steps)} steps")
  with open(os.path.join(CELEBA_WORKDIR, "stdout.txt")) as f:
    text = f.read()
  for step in range(2):
    for what in ("loss mean", "loss std"):
      if f"step: {step}, {what}: " not in text:
        raise AssertionError(f"no '{what}' line for step {step}")
  if "synthetic" in text:
    raise AssertionError("main trained on the synthetic set")
  cache = os.path.join(CELEBA_DATA_DIR, "celeba_64.npz")
  with np.load(cache) as z:
    shapes = (z["train"].shape, z["test"].shape)
  if shapes != ((CELEBA_IMAGES[0], 64, 64, 3), (CELEBA_IMAGES[1], 64, 64, 3)):
    raise AssertionError(f"the folder's cache holds {shapes}")
  for row, _ in steps:
    if not all(torch.isfinite(m).all() for m in row["per_example"]):
      raise AssertionError(f"CelebA step {row['step']}: non-finite losses")
  torch.cuda.empty_cache()
  t0 = time.perf_counter()
  main_lib.main(
      ["--mode", "eval"] + argv[2:] + [a for k, v in CELEBA_MAIN_EVAL.items()
                                       for a in ("--set", f"{k}={v}")])
  eval_s = time.perf_counter() - t0
  torch.cuda.empty_cache()
  with open(os.path.join(CELEBA_WORKDIR, "evaluation_history.txt")) as f:
    stdout = f.read()
  for what in ("mean nelbo bpd", "[NLL CORRECT", "round 0: nfe=", "FID: "):
    if what not in stdout:
      raise AssertionError(f"eval: no '{what}' in the log")
  nll = [l for l in stdout.splitlines() if "[NLL CORRECT" in l
         and "(nfe" in l][-1]
  bpd = float(nll.split("mean nll bpd: ")[1].split(",")[0])
  if not math.isfinite(bpd):
    raise AssertionError(f"eval: bits/dim {bpd}")
  with np.load(os.path.join(CELEBA_WORKDIR, "eval", "samples_0.npz")) as z:
    samples = z["samples"]
  if samples.shape != (BATCH, 64, 64, 3) or not np.isfinite(samples).all():
    raise AssertionError(f"eval: samples {samples.shape}")
  out = {"write_seconds": write_s, "train_seconds": train_s,
         "eval_seconds": eval_s,
         "step_seconds": [r["seconds"] for r, _ in steps],
         "losses": [r["losses"] for r, _ in steps],
         "launches_per_step": [step for _, step in steps], "data": shapes,
         "nll_bpd": bpd, "nll_line": nll,
         "fid_line": [l for l in stdout.splitlines() if "FID: " in l][-1]}
  log(f"CelebA main: {sum(CELEBA_IMAGES)} PNGs written in {write_s:.1f} s; "
      f"train (decode, cache, build, two steps, save) {train_s:.1f} s, "
      f"steps {out['step_seconds']}; eval {eval_s:.1f} s; {nll}; "
      f"{out['fid_line']}")
  return out


def celeba_row(celeba, name):
  """A score-net kernel's CelebA numbers for the kernels line: its sums at
  the 64x64 nets' calls (per evaluation at batch 64, or per training step
  at batch 128), the largest error, the rows by shape, and its launches
  in phase 13's runs: a step of 13c for kernels 1 and 2, each step of 13e
  as counted there for kernel 9."""
  out = celeba["score_kernels"][name]
  sums, err, rows = out[0], out[1], out[2]
  if name.startswith("upfirdn"):
    launches = {"main_train_steps": [step[name] for step in
                                     celeba["main"]["launches_per_step"]]}
  else:
    launches = {"train_step": celeba["train_launches"][name] // TRAIN_STEPS}
  if name == "group_norm_fwd":
    launches["round"] = celeba["round"]["group_norm_launches"]
  return {**sums, "max_abs_err": err, "by_shape": rows,
          "launches": launches}


def phase_celeba(chain_convs):
  """Phase 13: 13a-13e. Returns their results."""
  from indm_torch.configs import get_config
  seconds, t0 = {}, time.perf_counter()

  def lap(name):
    nonlocal t0
    seconds[name] = time.perf_counter() - t0
    log(f"-- phase {name} took {seconds[name]:.1f} s")
    t0 = time.perf_counter()

  chain_per_term, chain_err, chain_rows, ptxas = phase_celeba_chain(
      chain_convs)
  lap("13a")
  kernels = phase_celeba_score_kernels()
  lap("13b")
  with chain_switch(None):
    train, launches, per = phase_train(
        PER_STEP, per_term=chain_per_term, config="vp/CELEBA/indm_nll",
        scales=CELEBA_SCALES, host=False, profile=False)
  res, round_launches = phase_sample(
      set_leaves(celeba_config("vp/CELEBA/indm_nll"),
                 {"sampling.batch_size": CELEBA_SAMPLE_BATCH}),
      os.path.join(REPO, "build", "chip_smoke_celeba_sample"),
      batch=CELEBA_SAMPLE_BATCH)
  lap("13c")
  fid = phase_fid_steps(celeba_config("vp/CELEBA/indm_fid"), steps=1,
                        workdir=None)
  lap("13d")
  main_out = phase_celeba_main()
  lap("13e")
  if get_config("ve/CELEBA/indm").model.sigma_max != 90.0:
    raise AssertionError("the CelebA VE config is not at sigma_max 90")
  return {"chain": {"per_term": {f"scale{k[0]}_preact{int(k[1])}": v
                                 for k, v in chain_per_term.items()},
                    "max_abs_err": chain_err, "rows": chain_rows,
                    "ptxas": ptxas},
          "score_kernels": kernels, "train": train,
          "train_launches": dict(launches), "train_kernel_ms": per,
          "round": {"nfe": res["nfe"], "seconds": res["seconds"],
                    "images_per_s": res["images_per_s"],
                    "batch": CELEBA_SAMPLE_BATCH,
                    "group_norm_launches": round_launches},
          "fid_step": fid, "main": main_out, "seconds": seconds}


# phase 14: bench.py's flags (BENCH_TRAIN) on the VE and CelebA configs.
# Under flow.fused_block CelebA's first flow scale (12 channels on 32x32
# after the squeeze) takes the fused pair and stack, whose backward holds
# two padded narrow planes of 13 872 floats in shared memory (111 KB, past
# the 48 KB of a launch without the opt-in); its second (48 channels on
# 16x16), which the JAX package's fused_chain_ok sends to the chain, takes
# kernel 7 in bfloat16 (conv_in's K in six groups of 8 channels). 14a the
# kernels alone at those geometries; 14b three `vp/CELEBA/indm_nll` steps
# under BENCH_TRAIN; 14c one step each on the bfloat16 chain route, with
# INDM_FUSED_CHAIN=1 and on the float32 fused route; 14d two steps each of
# `ve/CELEBA/indm` and `ve/CIFAR10/indm` under BENCH_TRAIN and a PC round
# of the mixed-precision VE net; 14e the tiny CelebA steps under the flags,
# card against CPU.
BENCH_NS = (2, 6)      # 14a's draws; its times at the larger
BENCH_STACK = 15       # CelebA scale 0's stack: blocks 1-15 of 16
BENCH_GRAPH = (2, 2)   # graph_ms's (calls captured, replays) for 14a
# launches a step, derived from the routes: CelebA under BENCH_TRAIN runs
# scale 0's first block through the fused pair and its other 15 through
# one stack call each way, scale 1's 16 blocks (48 channels) through
# kernel 7 in bfloat16, and no GroupNorm kernel
PER_STEP_CELEBA_BENCH = {**PER_STEP_BENCH, "fused_stack_fwd": 1,
                         "fused_stack_bwd": 1, "neumann_chain_bf16": 16}
# the chain route in bfloat16 (CHAIN_BF16_TRAIN): kernel 7 in bfloat16 for
# all 32 blocks; with INDM_FUSED_CHAIN=1 scale 0's 16 blocks through
# kernel 8 in bfloat16 and scale 1's through kernel 7
PER_STEP_CELEBA_CHAIN8_BF16 = {**PER_STEP_CHAIN_BF16, "neumann_chain_bf16": 16,
                               "fused_neumann_chain_bf16": 16}
# flow.fused_block alone (float32): the pair and a stack at scale 0, kernel
# 7 in float32 at scale 1, the GroupNorm kernels 95 times each way
PER_STEP_CELEBA_FUSED = {**PER_STEP_STACK, "fused_stack_fwd": 1,
                         "fused_stack_bwd": 1, "neumann_chain": 16}
# the VE nets besides: kernel 9 15 times each way a step
PER_STEP_VE_BENCH = {**PER_STEP_BENCH, "upfirdn2d": VE_FIR_PER_EVAL,
                     "upfirdn2d_bwd": VE_FIR_PER_EVAL}
PER_STEP_VE_CELEBA_BENCH = {**PER_STEP_CELEBA_BENCH,
                            "upfirdn2d": VE_FIR_PER_EVAL,
                            "upfirdn2d_bwd": VE_FIR_PER_EVAL}
BENCH_VE_STEPS = 2
BENCH_VE_SCALES = 10   # the mixed-precision PC round (of 1000; depth cut)
# 14e: CelebA's tiny geometry, 16x16 images squeezed to 8x8x12 (the fused
# pair and a stack of two at width 64) and 4x4x48 (kernel 7 in bfloat16,
# two blocks), with a wolf preset of the imagenet-64 one's shape at the
# tiny width (the encoder on the squeezed image's 12 planes); the
# configs' own init, as phase 11's tiny steps (at `model.init_scale = 1.0`
# the tiny bfloat16 net carries one rounding apart to about its whole
# float32-bfloat16 gap: 0.73 of it in the score net's gradients and 0.90
# in the flow's, card against CPU, on an H100)
TINY_CELEBA_PRESET = "chip-smoke-tiny-celeba"
TINY_CELEBA_WOLF = {
    "generator": {"flow": {"type": "resflow"}},
    "discriminator": {
        "type": "gaussian",
        "encoder": {"type": "global_resnet_bn", "levels": 3,
                    "in_planes": 12, "hidden_planes": [4, 8, 8],
                    "out_planes": 8, "activation": "elu"},
        "in_dim": 8, "dim": 64,
        "prior": {"type": "flow", "num_steps": 1, "in_features": 64,
                  "hidden_features": 16, "activation": "elu",
                  "transform": "affine", "alpha": 1.0,
                  "coupling_type": "mlp"}},
    "dequantizer": {"type": "uniform"}}
CELEBA_BENCH_SMALL = {**BENCH_TRAIN, "data.image_size": 16,
                      "model.attn_resolutions": (8,),
                      "flow.intermediate_dim": 64, "flow.nblocks": "3-2",
                      "flow.model_config": TINY_CELEBA_PRESET}
# the weights' and the noise's seeds of 14e's steps (each config runs both)
BENCH_SMALL_SEEDS = (7, 17)
CELEBA_BENCH_SMALL_F32 = {**CELEBA_BENCH_SMALL, "flow.logdet_bf16": False,
                          "flow.mixed_precision": False,
                          "model.mixed_precision": False}


def bench_times(fn, plain, flops, nbytes, bf16):
  """fn's time at 14a's geometry: `ms` (CUDA events), `graph_ms` (the
  device alone, BENCH_GRAPH calls in a graph), the plain version's by
  events, and the bound of the work (`flow_bounds`)."""
  bound, _, by = flow_bounds(flops, nbytes, bf16)
  return {"ms": cuda_ms(fn, 2, 1), "graph_ms": graph_ms(fn, *BENCH_GRAPH),
          "plain_ms": cuda_ms(plain, 1, 1), "bound_ms": bound,
          "bound_by": by}


def log_bench(what, t, err):
  library = (f" library_ms={t['library_ms']:.4f}" if "library_ms" in t
             else "")
  log(f"{what}: max_abs_err={err:.3e} ms={t['ms']:.4f} "
      f"graph_ms={t['graph_ms']:.4f} plain_ms={t['plain_ms']:.4f}{library} "
      f"bound_ms={t['bound_ms']:.4f} ({t['bound_by']}; "
      f"{t['bound_ms'] / t['graph_ms']:.3f} of the bound in a graph)")


def bench_pair(dtype, gen):
  """Kernels 3 and 4 at CelebA's first scale in `dtype` (pair_checked),
  pre-activated and not, n in BENCH_NS; timed on the flow's first block
  (not pre-activated) at n = max(BENCH_NS)."""
  from indm_torch.flows.resflow import OFFSET_TRAIN
  from indm_torch.ops import fused_block as fb
  c, hw = CELEBA_SCALES[0]
  bf16, wsize = dtype == torch.bfloat16, 2 if dtype == torch.bfloat16 else 4
  flops = chain_flops_per_term(TRAIN_BATCH, c, hw)
  err, rows = {"fwd": 0.0, "bwd": 0.0}, {}
  for preact in (True, False):
    d = fused_inputs(TRAIN_BATCH, c, hw, gen)
    for n in BENCH_NS:
      what = f"[{TRAIN_BATCH},{c},{hw},{hw}] {dtype} preact={preact} n={n}"
      args, bargs, e_f, e_b = pair_checked(d, n, preact, dtype, what)
      err["fwd"], err["bwd"] = max(err["fwd"], e_f), max(err["bwd"], e_b)
    # the flow's first block, at the larger draw (the loop's last)
    if not preact:
      rows["fwd"] = bench_times(
          lambda: fb.fused_block_fwd(*args, dtype),
          lambda: fb.fused_block_fwd_plain(*args, dtype),
          scaled(flops, n + OFFSET_TRAIN + 2),
          flow_bytes("fwd", TRAIN_BATCH, c, hw, wsize=wsize), bf16)
      rows["bwd"] = bench_times(
          lambda: fb.fused_block_bwd(*bargs, dtype),
          lambda: fb.fused_block_bwd_plain(*bargs, dtype),
          fused_bwd_flops(TRAIN_BATCH, c, hw, preact),
          flow_bytes("bwd", TRAIN_BATCH, c, hw, wsize=wsize), bf16)
      for k in ("fwd", "bwd"):
        log_bench(f"fused_block_{k} {what}", rows[k], err[k])
    del d, args, bargs
    torch.cuda.empty_cache()
  return rows, err


def bench_stack(dtype, gen):
  """Kernels 5 and 6 at CelebA's first scale in `dtype`: one stack of
  BENCH_STACK pre-activated blocks (the step's call) with n from a seeded
  Poisson(2), held by stack_checked; timed beside the bound and the plain
  versions."""
  import numpy as np
  from indm_torch.flows.resflow import LAMB, OFFSET_TRAIN
  from indm_torch.ops import fused_stack as fs
  c, hw = CELEBA_SCALES[0]
  nb, bf16 = BENCH_STACK, dtype == torch.bfloat16
  host_rng = np.random.default_rng(15)
  blocks = [fused_inputs(TRAIN_BATCH, c, hw, gen) for _ in range(nb)]
  n_all = [int(host_rng.poisson(LAMB)) for _ in range(nb)]
  what = f"{nb} blocks [{TRAIN_BATCH},{c},{hw},{hw}] {dtype} n={n_all}"
  args, bargs, e_f, e_b = stack_checked(blocks, n_all, dtype, what)
  flops = chain_flops_per_term(TRAIN_BATCH, c, hw)
  wsize = 2 if bf16 else 4
  rows = {"fwd": bench_times(
      lambda: fs.fused_stack_fwd(*args, dtype),
      lambda: fs.fused_stack_fwd_plain(*args, dtype),
      scaled(flops, sum(n + OFFSET_TRAIN + 2 for n in n_all)),
      flow_bytes("stack_fwd", TRAIN_BATCH, c, hw, nb=nb, wsize=wsize), bf16),
      "bwd": bench_times(
          lambda: fs.fused_stack_bwd(*bargs, dtype),
          lambda: fs.fused_stack_bwd_plain(*bargs, dtype),
          scaled(fused_bwd_flops(TRAIN_BATCH, c, hw, True), nb),
          flow_bytes("stack_bwd", TRAIN_BATCH, c, hw, nb=nb, wsize=wsize),
          bf16)}
  for k, e in (("fwd", e_f), ("bwd", e_b)):
    log_bench(f"fused_stack_{k} {what}; the same bits as kernels 3 and 4 "
              "looped", rows[k], e)
  del blocks, bargs, args
  torch.cuda.empty_cache()
  return rows, {"fwd": e_f, "bwd": e_b}


def bench_chain(gen):
  """Kernel 7 in bfloat16 at CelebA's two scales (48 channels on 16x16:
  the new geometry; 12 on 32x32, where the chain route puts scale 0),
  pre-activated at n in BENCH_NS and not at the larger, against the plain
  version on float64 inputs (check_bf16_chain); timed at the larger n,
  pre-activated, beside its bound, the plain version and the same series
  through bfloat16 F.conv2d. Returns rows by scale and the largest
  error."""
  from indm_torch.flows.resflow import OFFSET_TRAIN, RCDF_TRAIN
  from indm_torch.ops import neumann
  bf = torch.bfloat16
  rows, worst = {}, 0.0
  for scale, (c, hw) in reversed(list(enumerate(CELEBA_SCALES))):
    flops = chain_flops_per_term(TRAIN_BATCH, c, hw)
    for preact in (True, False):
      vareps, dacts, ws = chain_inputs(TRAIN_BATCH, c, hw, preact, gen)
      k7 = (vareps.to(bf), [t.to(bf) for t in dacts], [w.to(bf) for w in ws])
      del vareps, dacts, ws
      for n in (BENCH_NS if preact else BENCH_NS[-1:]):
        args = (*k7, n, OFFSET_TRAIN, RCDF_TRAIN)
        what = f"neumann_chain bfloat16 [{TRAIN_BATCH},{c},{hw},{hw}] " \
               f"preact={preact} n={n}"
        acc = neumann.neumann_chain(*args)
        err = check_bf16_chain(
            what, acc, exact(neumann.neumann_chain_plain, *args,
                             compute_dtype=bf),
            exact(neumann.neumann_chain_plain, *args),
            neumann.neumann_chain_plain(*args))
        worst = max(worst, err)
        if preact and n == max(BENCH_NS):
          terms = n + OFFSET_TRAIN
          row = bench_times(
              lambda: neumann.neumann_chain(*args),
              lambda: neumann.neumann_chain_plain(*args),
              scaled(flops, terms),
              flow_bytes("chain_bf16", TRAIN_BATCH, c, hw, preact), True)
          row["library_ms"] = cuda_ms(lambda: chain_library(*k7, n), 1, 1)
          log_bench(what, row, err)
          rows[f"scale{scale}"] = {**row, "shape": [TRAIN_BATCH, c, hw, hw],
                                   "n": n, "terms": terms}
        del acc
      del k7
      torch.cuda.empty_cache()
  return rows, worst


def bench_chain8(gen):
  """Kernel 8 at CelebA's first scale (12 channels on 32x32, the route of
  INDM_FUSED_CHAIN=1 there) in float32 (against the plain version,
  CHAIN_RTOL) and bfloat16 (check_bf16_chain), pre-activated and not,
  with hp, n in BENCH_NS; timed at the larger n, pre-activated. Returns
  rows by type and the largest errors."""
  from indm_torch.flows.resflow import OFFSET_TRAIN, RCDF_TRAIN
  from indm_torch.ops import neumann
  c, hw = CELEBA_SCALES[0]
  flops = chain_flops_per_term(TRAIN_BATCH, c, hw)
  rows, worst = {}, {}
  for dtype in (torch.float32, torch.bfloat16):
    bf16 = dtype == torch.bfloat16
    worst[str(dtype)] = 0.0
    for preact in (True, False):
      d = fused_inputs(TRAIN_BATCH, c, hw, gen)
      w0, w1, w2 = d["ws"]
      mats = ((w0, w1[:, :, 0, 0]), tuple(d["bs"][:2]),
              [neumann.transpose_conv_weight(w).contiguous()
               for w in (w2, w1, w0)])
      k8 = (d["x"], d["eps"], *mats, d["hp"])
      if bf16:
        k8 = (k8[0].to(dtype), k8[1].to(dtype),
              tuple(w.to(dtype).contiguous() for w in k8[2]),
              tuple(b.to(dtype) for b in k8[3]),
              [w.to(dtype) for w in k8[4]], k8[5].to(dtype))
      del d, mats
      for n in BENCH_NS:
        args = (*k8, n, OFFSET_TRAIN, RCDF_TRAIN, preact)
        what = (f"fused_neumann_chain {dtype} [{TRAIN_BATCH},{c},{hw},{hw}] "
                f"preact={preact} n={n}")
        acc = neumann.fused_neumann_chain(*args)
        if bf16:
          err = check_bf16_chain(
              what, acc, exact(neumann.fused_neumann_chain_plain, *args,
                               compute_dtype=dtype),
              exact(neumann.fused_neumann_chain_plain, *args),
              neumann.fused_neumann_chain_plain(*args))
        else:
          ref = neumann.fused_neumann_chain_plain(*args)
          err = (acc - ref).abs().max().item()
          if not (math.isfinite(err)
                  and err <= CHAIN_RTOL * ref.abs().max().item()):
            raise AssertionError(f"{what}: max abs err {err}")
          del ref
        worst[str(dtype)] = max(worst[str(dtype)], err)
        if preact and n == max(BENCH_NS):
          fwd = fused_chain_fwd_flops(TRAIN_BATCH, c, hw)
          row = bench_times(
              lambda: neumann.fused_neumann_chain(*args),
              lambda: neumann.fused_neumann_chain_plain(*args),
              added(fwd, scaled(flops, n + OFFSET_TRAIN)),
              flow_bytes("chain8_bf16" if bf16 else "chain8", TRAIN_BATCH,
                         c, hw), bf16)
          log_bench(what, row, err)
          rows[str(dtype)] = {**row, "n": n}
        del acc
      del k8
      torch.cuda.empty_cache()
  return rows, worst


def phase_bench_kernels(chain_convs):
  """14a: the kernels alone at CelebA's geometry under bench.py's flags
  and their float32 twins, batch 128, width 512. Returns rows and largest
  errors by kernel, and kernel 7's bfloat16 convs' registers and spills
  at 12 and 48 channels."""
  gen = torch.Generator(device="cuda").manual_seed(15)
  out = {}
  for dtype in (torch.float32, torch.bfloat16):
    tag = "bf16" if dtype == torch.bfloat16 else "f32"
    out[f"pair_{tag}"] = bench_pair(dtype, gen)
    out[f"stack_{tag}"] = bench_stack(dtype, gen)
  out["chain_bf16"] = bench_chain(gen)
  out["chain8"] = bench_chain8(gen)
  ptxas = {k: v for k, v in chain_convs.items() if "bfloat16" in k
           and any(f"ILi{c}E" in k for c, _ in CELEBA_SCALES)}
  for k, v in ptxas.items():
    log(f"kernel 7 bfloat16 ptxas -v {k}: {' | '.join(v)}")
  if not any("ILi48E" in k and "conv_in" in k for k in ptxas):
    raise AssertionError("no ptxas report of conv_in at 48 channels in "
                         "bfloat16")
  out["ptxas"] = ptxas
  return out


def bench_step_row(name, train, launches, per_step):
  """A CelebA or VE step's numbers for the results line, its launches a
  step held to `per_step`."""
  steps = train["steps"]
  per = {k: v // steps for k, v in launches.items() if k in per_step}
  if per != per_step:
    raise AssertionError(f"{name}: {per} a step, expected {per_step}")
  return {**train, "launches_per_step": per}


def phase_bench_steps():
  """14b-14d at full width and batch 128: `vp/CELEBA/indm_nll` under
  BENCH_TRAIN (three steps), one step each on the bfloat16
  chain route (CHAIN_BF16_TRAIN, with and without INDM_FUSED_CHAIN=1) and
  on the float32 fused route (FUSED_TRAIN: the repaired fault), two steps
  each of `ve/CELEBA/indm` and `ve/CIFAR10/indm` under BENCH_TRAIN, each
  step's launches exact (phase_train); then a PC round of the
  mixed-precision VE net (`ve/CIFAR10/indm` under BENCH_TRAIN's model
  flags, BENCH_VE_SCALES scales: kernel 9 15 times an evaluation, no
  GroupNorm kernel)."""
  out = {}
  celeba = dict(config="vp/CELEBA/indm_nll", scales=CELEBA_SCALES,
                host=False)
  with chain_switch(None), stack_switch(None):
    train, launches, _ = phase_train(PER_STEP_CELEBA_BENCH, BENCH_TRAIN,
                                     profile=False, **celeba)
    out["celeba_bench"] = bench_step_row("14b", train, launches,
                                         PER_STEP_CELEBA_BENCH)
    for name, per_step, flags, chain8 in (
        ("celeba_chain_bf16", PER_STEP_CHAIN_BF16, CHAIN_BF16_TRAIN, None),
        ("celeba_chain8_bf16", PER_STEP_CELEBA_CHAIN8_BF16, CHAIN_BF16_TRAIN,
         "1"),
        ("celeba_fused_f32", PER_STEP_CELEBA_FUSED, FUSED_TRAIN, None)):
      with chain_switch(chain8):
        train, launches, _ = phase_train(per_step, flags, steps=1,
                                         profile=False, **celeba)
      out[name] = bench_step_row(name, train, launches, per_step)
    for name, config, per_step, scales in (
        ("ve_celeba_bench", "ve/CELEBA/indm", PER_STEP_VE_CELEBA_BENCH,
         CELEBA_SCALES),
        ("ve_cifar10_bench", "ve/CIFAR10/indm", PER_STEP_VE_BENCH,
         CHAIN_SCALES)):
      train, launches, _ = phase_train(per_step, BENCH_TRAIN, config=config,
                                       scales=scales, host=False,
                                       steps=BENCH_VE_STEPS, profile=False)
      out[name] = bench_step_row(name, train, launches, per_step)
  cfg = set_leaves(ve_config(), {
      **{k: v for k, v in BENCH_TRAIN.items() if k.startswith("model.")},
      "sampling.num_scales": BENCH_VE_SCALES})
  rnd, launches = phase_ve_sample(cfg, os.path.join(REPO, "build",
                                                    "chip_smoke_ve_bench"))
  out["ve_round_bench"] = {**rnd, "launches": launches,
                           "flags": {k: v for k, v in BENCH_TRAIN.items()
                                     if k.startswith("model.")}}
  return out


def phase_bench_small():
  """14e: the tiny CelebA steps under bench.py's flags (CELEBA_BENCH_SMALL:
  the fused pair and a stack of two at 8x8x12, kernel 7 in bfloat16 at
  4x4x48), `vp/CELEBA/indm_nll` and `ve/CELEBA/indm` (kernel 9 both
  ways), card against CPU at each of BENCH_SMALL_SEEDS, at phase 11's
  bfloat16 criteria for a step with blocks on the chain route
  (CHAIN_STEP_GAP_SHARE: scale 1's g rounds its output to bfloat16, as on
  the chain-route slice, so one rounding that the card's and the CPU's
  convs take apart moves z; the card's z is held, then its score half
  takes the CPU's z), each net by its largest gradient error, with the
  float32 control. A gradient exact in bfloat16 may differ by one
  bfloat16 step where that step exceeds the limit (`bf16_step_allowed`):
  without it the score net missed (1.147 of the gap, with or without the
  CPU's z) in two runs on an H100 at the configs' init, one step of its
  last conv's largest gradient, with the losses within 9.3e-7."""
  from indm_torch.configs import get_config
  from indm_torch.configs import wolf_presets
  wolf_presets.PRESETS[TINY_CELEBA_PRESET] = TINY_CELEBA_WOLF
  try:
    for name in ("vp/CELEBA/indm_nll", "ve/CELEBA/indm"):
      cfg = get_config(name)
      for seed in BENCH_SMALL_SEEDS:
        with chain_switch(None), stack_switch(None):
          phase_small_train(cfg, CELEBA_BENCH_SMALL, (0, 1, 1, 0, 2, 0),
                            f32_twin=CELEBA_BENCH_SMALL_F32,
                            gap_share=CHAIN_STEP_GAP_SHARE,
                            fir_both_ways=name.startswith("ve/"), seed=seed)
  finally:
    wolf_presets.PRESETS.pop(TINY_CELEBA_PRESET, None)


def attach_bench(kernels, bench):
  """Phase 14's numbers on the kernels line, under "bench_flags" of each
  kernel they concern: 14a's call at CelebA's geometry (ms, graph_ms,
  plain_ms, bound_ms beside the largest error) and the launches a step of
  each 14b-14d run that launched it (the counters of kernels 3-6 take
  either type)."""
  rows, steps = bench["kernels"], bench["steps"]
  by_name = {k["name"]: k for k in kernels}
  c, hw = CELEBA_SCALES[0]

  def per_step(counter):
    return {run: r["launches_per_step"][counter] for run, r in steps.items()
            if r.get("launches_per_step", {}).get(counter)}

  for name, key, part, counter in (
      ("fused_block_fwd", "pair_f32", "fwd", "fused_block_fwd"),
      ("fused_block_bwd", "pair_f32", "bwd", "fused_block_bwd"),
      ("fused_stack_fwd", "stack_f32", "fwd", "fused_stack_fwd"),
      ("fused_stack_bwd", "stack_f32", "bwd", "fused_stack_bwd"),
      ("fused_block_fwd_bf16", "pair_bf16", "fwd", "fused_block_fwd"),
      ("fused_block_bwd_bf16", "pair_bf16", "bwd", "fused_block_bwd"),
      ("fused_stack_fwd_bf16", "stack_bf16", "fwd", "fused_stack_fwd"),
      ("fused_stack_bwd_bf16", "stack_bf16", "bwd", "fused_stack_bwd")):
    times, err = rows[key]
    by_name[name]["bench_flags"] = {
        **times[part], "max_abs_err": err[part],
        "shape": [TRAIN_BATCH, c, hw, hw],
        "launches_per_step": per_step(counter)}
  chain, err = rows["chain_bf16"]
  by_name["neumann_chain_bf16"]["bench_flags"] = {
      **chain, "max_abs_err": err,
      "launches_per_step": per_step("neumann_chain_bf16")}
  chain8, err8 = rows["chain8"]
  for name, dtype in (("fused_neumann_chain", "torch.float32"),
                      ("fused_neumann_chain_bf16", "torch.bfloat16")):
    by_name[name]["bench_flags"] = {**chain8[dtype],
                                    "max_abs_err": err8[dtype],
                                    "launches_per_step": per_step(name)}
  for name in ("neumann_chain", "group_norm_fwd", "group_norm_bwd",
               "upfirdn2d", "upfirdn2d_bwd"):
    by_name[name]["bench_flags"] = {"launches_per_step": per_step(name)}
  by_name["upfirdn2d"]["bench_flags"]["launches_ve_round"] = steps[
      "ve_round_bench"]["launches"]["upfirdn2d"]


def phase_bench(chain_convs):
  """Phase 14: 14a-14e. Returns their results and seconds."""
  seconds, t0 = {}, time.perf_counter()

  def lap(name):
    nonlocal t0
    seconds[name] = time.perf_counter() - t0
    log(f"-- phase {name} took {seconds[name]:.1f} s")
    t0 = time.perf_counter()

  kernels = phase_bench_kernels(chain_convs)
  lap("14a")
  steps = phase_bench_steps()
  lap("14b-14d")
  phase_bench_small()
  lap("14e")
  return {"kernels": kernels, "steps": steps, "seconds": seconds}


# phase 15: the score side in full. 15a at the tiny geometries of phases 5
# (VP) and 5e (VE), card against CPU with the same weights and draws: the
# four SDEs' methods, one PC round of SCORE_SIDE_STEPS steps for every
# (predictor, corrector) pair the JAX package runs on each SDE (no flow:
# the flow inverse is phase 5's), the denoise search and the extra steps
# resumed from a cached state, and a score-only step (continuous and DDPM)
# with the CPU's diffusion times, as phase 11 holds a joint step. 15b-15c
# at full width and batch 64 with the kernel on, as phases 3 and 4 run
# it: PC rounds of `vp/CIFAR10/indm_nll` (Euler-Maruyama without and with
# the Langevin corrector) and under the subVP and GeometricVP SDEs, kernel
# 1's launches 95 per score evaluation counted on the host. 15d
# `python -m indm_torch.sample`'s entry point on `ve/CIFAR10/indm`: a
# plain round, the denoise search resumed from its step-(N-2) file, and
# the extra steps resumed at a smaller batch. 15e score-only training
# (`flow.model=identity`) at batch 128.
SCORE_SIDE_N = 50            # the tiny SDEs' N: VP's DDPM betas below 1
SCORE_SIDE_STEPS = 3         # the tiny pair rounds' sampling.num_scales
# the VP kinds' tiny rounds end at t = 0.1, not the config's 1e-5: there
# the VP std sqrt(1 - exp(-2.1e-6)) keeps about one digit in float32, and
# one ulp of the card's expf against the CPU's moves a round by some 1e-2
# of its largest value (7e-8 at t = 0.1); subVP's std is the same
# difference. One VP round ends at 1e-5 all the same, held to a limit
# measured in the run (vp_eps_round). VE rounds end at 1e-5
SCORE_SIDE_VP_EPS = 0.1
# ulps apart that the card's expf and the CPU's may be: CUDA's expf within
# 2 of exp (the CUDA C++ Programming Guide's table of single-precision
# functions), torch's CPU exp within 1
EXPF_ULPS = 3
SCORE_SIDE_SDE_RTOL = 1e-5   # float32 formulas, expf/logf/powf in the card's
SCORE_SIDE_ROUND_RTOL = VE_SMALL_ROUND_RTOL
SCORE_SIDE_PAIRS = {
    "vesde": [(p, c) for p in ("euler_maruyama", "reverse_diffusion",
                               "ancestral_sampling", "none")
              for c in ("langevin", "ald", "none")],
    "vpsde": [(p, c) for p in ("euler_maruyama", "reverse_diffusion",
                               "ancestral_sampling", "none")
              for c in ("langevin", "ald", "none")],
    # subVP has no DDPM alphas (both correctors) and no ancestral step
    "subvpsde": [(p, "none") for p in ("euler_maruyama", "reverse_diffusion",
                                       "none")],
    # GeometricVP's discretization needs next_t: no reverse_diffusion in the
    # plain loop
    "gvpsde": [(p, c) for p in ("euler_maruyama", "ancestral_sampling",
                                "none") for c in ("langevin", "ald", "none")],
}
PC_VP_ROUNDS = (("euler_maruyama", "none", 50), ("euler_maruyama",
                                                 "langevin", 25))
PC_SDE_SCALES = 20
PC_VE_SCALES = 10
PC_MORE_STEP_BATCH = 16
PC_WORKDIR = os.path.join(REPO, "build", "chip_smoke_pc")
SCORE_ONLY_STEPS = 3


@contextlib.contextmanager
def counting_evals(cls=None):
  """The score net's forward calls on the host, one per score evaluation,
  while the block runs (`cls`: the net's class, NCSN++ by default)."""
  if cls is None:
    from indm_torch.models.ncsnpp import NCSNpp as cls
  calls, forward = [0], cls.forward

  def counted(self, *args, **kwargs):
    calls[0] += 1
    return forward(self, *args, **kwargs)

  cls.forward = counted
  try:
    yield calls
  finally:
    cls.forward = forward


def max_rel(got, want):
  want = want.float()
  return ((got.float().cpu() - want).abs().max()
          / want.abs().max().clamp_min(1e-30)).item()


def check_rel(what, err, limit):
  log(f"15a {what}: card vs cpu max rel err {err:.3e} (limit {limit})")
  if not err <= limit:
    raise AssertionError(f"{what} on the card disagrees with the CPU")


def score_side_config(cfg, sde, extra=None):
  """The tiny config of the SDE (VP kinds on phase 5's geometry, VE on
  phase 5e's), without a flow."""
  from indm_torch.configs import get_config
  if sde == "vesde":
    base, small = get_config("ve/CIFAR10/indm"), VE_SMALL
  else:
    base, small = cfg, SMALL
  if sde != "vesde":
    small = {**small, "sampling.truncation_time": SCORE_SIDE_VP_EPS}
  leaves = {**small, "model.fused_groupnorm": True, "model.init_scale": 1.0,
            "training.sde": sde, "model.num_scales": SCORE_SIDE_N,
            "sampling.num_scales": SCORE_SIDE_STEPS, "sampling.method": "pc",
            "flow.model": "identity", **(extra or {})}
  return set_leaves(base, leaves)


def nudged_vp_std(sde):
  """A copy of `sde` (a VPSDE) whose std takes exp(2 log_mean_coeff) one
  float32 ulp lower: the std as an expf one ulp apart would make it."""
  sde = copy.copy(sde)

  def marginal_prob(x, t):
    mean, _ = type(sde).marginal_prob(sde, x, t)
    log_mean_coeff = (-0.25 * t ** 2 * (sde.beta_1 - sde.beta_0)
                      - 0.5 * t * sde.beta_0)
    e = torch.exp(2.0 * log_mean_coeff)
    return mean, torch.sqrt(1.0 - torch.nextafter(e, torch.zeros_like(e)))

  sde.marginal_prob = marginal_prob
  return sde


def vp_eps_round(c0, nets, shape, prior, steps, eps):
  """The tiny VP round (Euler-Maruyama, no corrector) ending at the
  config's `eps` instead of SCORE_SIDE_VP_EPS, card against CPU, held to
  SCORE_SIDE_ROUND_RTOL plus EXPF_ULPS times the round's move on the CPU
  when one ulp of expf moves the std (`nudged_vp_std`). Returns the
  error, the move and the limit."""
  from indm_torch import run_lib
  from indm_torch import sampling as sampling_lib
  from indm_torch.data import get_data_inverse_scaler
  c = set_leaves(c0, {"sampling.truncation_time": eps,
                      "sampling.predictor": "euler_maruyama",
                      "sampling.corrector": "none"})
  runs = (("cpu", nets["cpu"]),
          ("cpu_ulp", nets["cpu"]._replace(sde=nudged_vp_std(
              nets["cpu"].sde))),
          ("card", nets["card"]))
  rounds = {}
  for d, s in runs:
    dev = "cuda" if d == "card" else "cpu"
    fn = sampling_lib.get_sampling_fn(
        c, s.sde, shape, get_data_inverse_scaler(c),
        c.sampling.truncation_time, device=dev)
    on = [([z.to(dev) for z in cz], p.to(dev)) for cz, p in steps]
    rounds[d] = run_lib.sample_round(
        c, s._replace(sampling_fn=fn), prior_noise=prior.to(dev),
        step_noise=on.__getitem__)
  if not torch.isfinite(rounds["card"][0]).all():
    raise AssertionError(f"the tiny VP round to t = {eps} on the card is "
                         "not finite")
  move = max(max_rel(rounds["cpu_ulp"][i], rounds["cpu"][i]) for i in (0, 2))
  limit = SCORE_SIDE_ROUND_RTOL + EXPF_ULPS * move
  err = max(max_rel(rounds["card"][i], rounds["cpu"][i]) for i in (0, 2))
  log(f"15a vpsde: the Euler-Maruyama round to t = {eps}: one ulp of expf "
      f"in the std moves it by {move:.3e} of its largest value on the CPU")
  check_rel(f"vpsde round to t = {eps}", err, limit)
  return {"err": err, "ulp_move": move, "limit": limit}


def phase_score_tiny(cfg):
  """15a: at the tiny geometries, card (kernels 1, 2 and 9) against CPU
  (their plain versions)."""
  from indm_torch import losses, run_lib
  from indm_torch import sampling as sampling_lib
  from indm_torch import sde as sde_lib
  from indm_torch.data import get_data_inverse_scaler
  from indm_torch.ops import group_norm as gn
  from indm_torch.ops import upfirdn2d as fir
  gen = torch.Generator().manual_seed(5)
  out = {"sde_err": {}, "pairs": {}, "variants": {}, "score_only": {}}
  for name in SCORE_SIDE_PAIRS:
    c = score_side_config(cfg, name, {"model.num_scales": 1000})
    sdes = {d: sde_lib.get_sde(c) for d in ("cpu", "card")}
    size = c.data.image_size
    x = torch.randn(SMALL_BATCH, 3, size, size, generator=gen)
    # t and next_t apart enough that sqrt(sigma(t)^2 - sigma(next_t)^2)
    # does not magnify a last-bit difference of pow past the limit
    t = torch.tensor([1.0, 0.75, 0.3, 0.1])
    nt = t / 2
    got = {}
    for d, s in sdes.items():
      dev = "cuda" if d == "card" else d
      xd, td, nd = x.to(dev), t.to(dev), nt.to(dev)
      score = lambda x, t: -x * (1 + t[:, None, None, None])
      vals = [*s.sde(xd, td), *s.marginal_prob(xd, td), s.prior_logp(xd),
              *s.discretize(xd, td, nd),
              *s.reverse(score).discretize(xd, td, nd),
              *s.reverse(score, True).sde(xd, td)]
      if name != "gvpsde":
        vals += list(s.discretize(xd, td, None))
      got[d] = vals
    err = max(max_rel(a, b) for a, b in zip(got["card"], got["cpu"]))
    out["sde_err"][name] = err
    check_rel(f"{name} methods", err, SCORE_SIDE_SDE_RTOL)

  fir.reset_launches()
  gn.reset_launches()
  for name, pairs in SCORE_SIDE_PAIRS.items():
    c0 = score_side_config(cfg, name)
    nets = {d: run_lib.build_sampling(c0, SMALL_BATCH, device=dev, seed=7)
            for d, dev in (("cpu", "cpu"), ("card", "cuda"))}
    size = c0.data.image_size
    shape = (SMALL_BATCH, 3, size, size)
    prior = torch.randn(shape, generator=gen)
    steps = [([torch.randn(shape, generator=gen)],
              torch.randn(shape, generator=gen)) for _ in range(100)]
    for pred, corr in pairs:
      c = set_leaves(c0, {"sampling.predictor": pred,
                          "sampling.corrector": corr})
      rounds = {}
      for d, s in nets.items():
        dev = "cuda" if d == "card" else d
        fn = sampling_lib.get_sampling_fn(
            c, s.sde, shape, get_data_inverse_scaler(c),
            c.sampling.truncation_time, device=dev)
        on = [([z.to(dev) for z in cz], p.to(dev)) for cz, p in steps]
        rounds[d] = run_lib.sample_round(
            c, s._replace(sampling_fn=fn), prior_noise=prior.to(dev),
            step_noise=on.__getitem__)
      if not torch.isfinite(rounds["card"][0]).all():
        raise AssertionError(f"the tiny {name} round {pred}+{corr} on the "
                             "card is not finite")
      err = max(max_rel(rounds["card"][i], rounds["cpu"][i])
                for i in (0, 2))
      out["pairs"][f"{name}:{pred}+{corr}"] = err
      if not err <= SCORE_SIDE_ROUND_RTOL:
        raise AssertionError(f"the tiny {name} round {pred}+{corr}: card "
                             f"vs cpu {err:.3e}")
    log(f"15a {name}: {len(pairs)} (predictor, corrector) rounds of "
        f"{SCORE_SIDE_STEPS} steps, card vs cpu max rel err "
        f"{max(out['pairs'][f'{name}:{p}+{q}'] for p, q in pairs):.3e} "
        f"(limit {SCORE_SIDE_ROUND_RTOL})")
    if name == "vpsde":
      out["vp_eps_round"] = vp_eps_round(c0, nets, shape, prior, steps,
                                         cfg.sampling.truncation_time)
    if name != "vesde":
      continue
    # the denoise search and the extra steps, resumed from a cached state
    before = torch.randn(shape, generator=gen)
    for variant, leaves in (("search", {"sampling.pc_denoise": True}),
                            ("more_step", {"sampling.more_step": True})):
      c = set_leaves(c0, {**leaves, "sampling.need_sample": False})
      rounds = {}
      for d, s in nets.items():
        dev = "cuda" if d == "card" else d
        fn = sampling_lib.get_sampling_fn(
            c, s.sde, shape, get_data_inverse_scaler(c),
            c.sampling.truncation_time, device=dev)
        on = [([z.to(dev) for z in cz], p.to(dev)) for cz, p in steps]
        rounds[d] = run_lib.sample_round(
            c, s._replace(sampling_fn=fn), step_noise=on.__getitem__,
            before_data=before.to(dev), final_time=0.2)
      err = max_rel(rounds["card"][0], rounds["cpu"][0])
      out["variants"][variant] = err
      check_rel(f"VE {variant} round resumed from before_data", err,
                SCORE_SIDE_ROUND_RTOL)
  out["launches"] = {"group_norm_fwd": gn.launches, "upfirdn2d": fir.launches}
  if gn.launches == 0 or fir.launches == 0:
    raise AssertionError("the tiny rounds on the card launched no kernel")

  for mode, extra in (("continuous", {}),
                      ("ddpm", {"training.continuous": False,
                                "training.likelihood_weighting": False,
                                "training.importance_sampling": False})):
    c = score_side_config(cfg, "vpsde", {
        **extra, "model.num_scales": 1000, "model.dropout": 0.0,
        "training.batch_size": SMALL_BATCH})
    trs = {d: run_lib.build_training(c, device=dev, seed=7)
           for d, dev in (("cpu", "cpu"), ("card", "cuda"))}
    batch = run_lib.next_batch(trs["cpu"])
    noise = losses.ScoreNoise(
        u_t=torch.rand(SMALL_BATCH, generator=gen),
        z=torch.randn(batch.shape, generator=gen),
        labels=torch.randint(0, 1000, (SMALL_BATCH,), generator=gen))
    sde = trs["cpu"].sde
    times = sde.get_diffusion_time(
        SMALL_BATCH, sde.get_t_min(device="cpu"),
        c.training.importance_sampling, u=noise.u_t)
    got = {}
    gn.reset_launches()
    for d, tr in trs.items():
      dev = tr.device
      tr.sde.get_diffusion_time = (lambda t, w: lambda *a, **k: (t, w))(
          times[0].to(dev), times[1].to(dev))
      nd = losses.ScoreNoise(*(None if v is None else v.to(dev)
                               for v in noise))
      (lv,) = tr.step_fn(batch.to(dev), [nd])
      got[d] = (lv.cpu(), {k: p.grad.detach().cpu()
                           for k, p in tr.score_model.named_parameters()})
    (l_cpu, g_cpu), (l_gpu, g_gpu) = got["cpu"], got["card"]
    loss_err = max_rel(l_gpu, l_cpu)
    floor = TRAIN_SMALL_GRAD_FLOOR * max(v.abs().max().item()
                                         for v in g_cpu.values())
    grad_err = max(((g_gpu[k] - v).abs().max()
                    / (v.abs().max() + floor)).item()
                   for k, v in g_cpu.items())
    out["score_only"][mode] = {"loss_err": loss_err, "grad_err": grad_err,
                               "launches": (gn.launches, gn.bwd_launches)}
    log(f"15a score-only step ({mode}): card vs cpu losses max rel err "
        f"{loss_err:.3e} (limit {TRAIN_SMALL_RTOL}), gradients "
        f"{grad_err:.3e} (limit {TRAIN_SMALL_GRAD_RTOL}, {len(g_cpu)} "
        f"tensors); kernels 1 and 2 launched {gn.launches} and "
        f"{gn.bwd_launches} times")
    if not (loss_err <= TRAIN_SMALL_RTOL
            and grad_err <= TRAIN_SMALL_GRAD_RTOL):
      raise AssertionError("the tiny score-only step on the card disagrees "
                           "with the CPU")
    if not gn.launches == gn.bwd_launches > 0:
      raise AssertionError("the tiny score-only step did not launch "
                           "kernels 1 and 2 alike")
  return out


def pc_round_row(cfg, s, workdir, what):
  """One round of `s` (its sampler for `cfg`) through
  `run_lib.sample_rounds` into `workdir`, the score net's forward calls
  counted on the host: kernel 1 must launch 95 times each."""
  from indm_torch import run_lib
  from indm_torch.ops import group_norm as gn
  gn.reset_launches()
  with counting_evals() as evals:
    (row,) = run_lib.sample_rounds(cfg, s, workdir, BATCH, 1, log=log)
  expected = cfg.sampling.num_scales * (
      (cfg.sampling.n_steps_each if cfg.sampling.corrector != "none" else 0)
      + (1 if cfg.sampling.predictor != "none" else 0))
  scales = cfg.sampling.num_scales
  out = {"what": what, "num_scales": scales, "score_evals": evals[0],
         "nfe": row["nfe"], "seconds": row["seconds"],
         "images_per_s": row["images_per_s"],
         "seconds_per_step": row["seconds"] / scales,
         "group_norm_fwd": gn.launches}
  log(f"{what}: {scales} scales, score evals {evals[0]} (expected "
      f"{expected}), seconds {row['seconds']:.3f}, images/s "
      f"{row['images_per_s']:.3f}, seconds per PC step "
      f"{row['seconds'] / scales:.4f}, kernel 1 launches {gn.launches}")
  if evals[0] != expected or gn.launches != GN_PER_SCORE_EVAL * evals[0]:
    raise AssertionError(f"{what}: kernel 1 launched {gn.launches} times "
                         f"for {evals[0]} score evaluations")
  size = cfg.data.image_size
  for key in ("before", "after"):
    img = row[key]
    if tuple(img.shape) != (BATCH, size, size, 3) or not torch.isfinite(
        img).all():
      raise AssertionError(f"{what}: {key} images wrong or not finite")
  return out


def phase_pc_full(cfg):
  """15b and 15c: PC rounds at full width, batch 64, kernel 1 on."""
  from indm_torch import run_lib
  from indm_torch import sampling as sampling_lib
  from indm_torch import sde as sde_lib
  from indm_torch.data import get_data_inverse_scaler
  base = set_leaves(cfg, {"sampling.method": "pc"})
  s = run_lib.build_sampling(base, BATCH, device="cuda")
  size = cfg.data.image_size
  shape = (BATCH, 3, size, size)
  rows = []
  cases = [(f"15b vp {p}+{c}", {"sampling.predictor": p,
                                "sampling.corrector": c,
                                "sampling.num_scales": n})
           for p, c, n in PC_VP_ROUNDS]
  cases += [(f"15c {name} euler_maruyama", {
      "training.sde": name, "sampling.predictor": "euler_maruyama",
      "sampling.corrector": "none", "sampling.num_scales": PC_SDE_SCALES})
            for name in ("subvpsde", "gvpsde")]
  for i, (what, leaves) in enumerate(cases):
    c = set_leaves(base, leaves)
    sde = sde_lib.get_sde(c)
    fn = sampling_lib.get_sampling_fn(c, sde, shape,
                                      get_data_inverse_scaler(c),
                                      c.sampling.truncation_time)
    rows.append(pc_round_row(c, s._replace(sde=sde, sampling_fn=fn),
                             os.path.join(PC_WORKDIR, f"full_{i}"), what))
  del s
  torch.cuda.empty_cache()
  return rows


def phase_ve_pc_cli():
  """15d: `python -m indm_torch.sample`'s `main` on `ve/CIFAR10/indm`
  (kernels 1 and 9 on): a plain round of PC_VE_SCALES scales at batch 64;
  the denoise search resumed from its step-(N-2) file (one evaluation),
  its suffixed files and PNG; the extra steps resumed from the first
  PC_MORE_STEP_BATCH images of its before-flow file at that batch."""
  import numpy as np
  from indm_torch import image_io, sample, sampling_io
  from indm_torch.ops import group_norm as gn
  from indm_torch.ops import upfirdn2d as fir
  work = os.path.join(PC_WORKDIR, "ve")
  more = os.path.join(PC_WORKDIR, "ve_more_step")
  common = ["--config", "ve/CIFAR10/indm", "--set", "model.init_scale=1.0",
            "--set", "model.fused_groupnorm=true", "--set",
            f"sampling.num_scales={PC_VE_SCALES}"]
  runs = (("plain", work, BATCH, []),
          ("pc_denoise", work, BATCH, ["sampling.pc_denoise=true",
                                       "sampling.need_sample=false"]),
          ("more_step", more, PC_MORE_STEP_BATCH,
           ["sampling.more_step=true", "sampling.need_sample=false"]))
  out = {}
  for what, wd, batch, sets in runs:
    if what == "more_step":
      os.makedirs(os.path.join(more, "eval"), exist_ok=True)
      with np.load(os.path.join(work, "eval",
                                "samples_0_before_flow.npz")) as z:
        np.savez_compressed(os.path.join(more, "eval",
                                         "samples_0_before_flow.npz"),
                            samples=z["samples"][:batch])
    args = [*common, "--batch", str(batch), "--workdir", wd]
    for item in sets:
      args += ["--set", item]
    gn.reset_launches()
    fir.reset_launches()
    with counting_evals() as evals:
      (row,) = sample.main(args)
    expected = {"plain": PC_VE_SCALES * 2, "pc_denoise": 1,
                "more_step": 100 * 2}[what]
    launches = {"group_norm_fwd": gn.launches, "upfirdn2d": fir.launches}
    out[what] = {"batch": batch, "score_evals": evals[0],
                 "seconds": row["seconds"], "resumed": row["resumed"],
                 "files": sorted(os.path.basename(p)
                                 for p in row["paths"].values()),
                 "launches": launches}
    log(f"15d {what}: batch {batch}, score evals {evals[0]} (expected "
        f"{expected}), seconds {row['seconds']:.3f}, resumed "
        f"{row['resumed']}, wrote {out[what]['files']}, launches {launches}")
    if (evals[0] != expected
        or launches != {"group_norm_fwd": GN_PER_SCORE_EVAL * expected,
                        "upfirdn2d": VE_FIR_PER_EVAL * expected}):
      raise AssertionError(f"15d {what}: launches do not match the score "
                           "evaluations")
    if (what != "plain") != (row["resumed"] is not None):
      raise AssertionError(f"15d {what}: resumed {row['resumed']}")
    if not torch.isfinite(row["after"]).all():
      raise AssertionError(f"15d {what}: non-finite images")
  den = os.path.join(work, "eval", "samples_0_denoise_0.0")
  grid = image_io.read_png(den + ".png")
  with np.load(den + ".npz") as z:
    want = sampling_io.image_grid(z["samples"])
  if grid.shape != want.shape or not (grid == want).all():
    raise AssertionError("15d: the PNG grid is not the round's images")
  return out


def phase_score_only():
  """15e: score-only training (`flow.model=identity`) at full width, batch
  128, kernel 1 and 2 on: three steps of `vp/CIFAR10/indm_nll`, one with
  two micro-batches under Adam, one `ve/CIFAR10/indm` step (kernel 9
  both ways)."""
  from indm_torch import run_lib
  from indm_torch.configs import get_config
  runs = (("vp", "vp/CIFAR10/indm_nll", {}, SCORE_ONLY_STEPS, 1),
          ("vp_micro2_adam", "vp/CIFAR10/indm_nll",
           {"optim.num_micro_batch": 2, "optim.optimizer": "Adam"}, 1, 2),
          ("ve", "ve/CIFAR10/indm", {}, 1, 1))
  out = {}
  for what, name, extra, steps, micro in runs:
    c = set_leaves(get_config(name), {
        "flow.model": "identity", "model.fused_groupnorm": True,
        "training.batch_size": TRAIN_BATCH, **extra})
    tr = run_lib.build_training(c, device="cuda")
    torch.cuda.reset_peak_memory_stats()
    reset_kernel_counts()
    rows = run_lib.train_steps(tr, steps, log=log)
    torch.cuda.synchronize()
    counts = kernel_counts()
    secs = [r["seconds"] for r in rows]
    per_step = {"group_norm_fwd": GN_PER_SCORE_EVAL * micro * steps,
                "group_norm_bwd": GN_PER_SCORE_EVAL * micro * steps,
                "upfirdn2d": (VE_FIR_PER_EVAL * micro * steps
                              if name.startswith("ve") else 0)}
    # the pyramid's first FIR call takes the data, which needs no gradient:
    # no backward launch for it (a joint step's latent needs one)
    per_step["upfirdn2d_bwd"] = per_step["upfirdn2d"] // VE_FIR_PER_EVAL * (
        VE_FIR_PER_EVAL - 1)
    got = {k: counts[k] for k in per_step}
    mid = sorted(secs)[len(secs) // 2]
    out[what] = {"seconds_per_step": mid, "seconds": secs,
                 "images_per_s": TRAIN_BATCH / mid,
                 "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
                 "launches": got, "losses": [r["losses"] for r in rows]}
    log(f"15e score-only {what}: {steps} step(s), seconds {secs}, images/s "
        f"{out[what]['images_per_s']:.2f}, peak memory "
        f"{out[what]['peak_memory_gb']:.3f} GB, launches {got} (expected "
        f"{per_step})")
    if got != per_step or any(counts[k] for k in counts if k not in got):
      raise AssertionError(f"15e {what}: launches {counts}")
    if not all(math.isfinite(v) for v in out[what]["losses"]):
      raise AssertionError(f"15e {what}: non-finite losses")
    del tr
    torch.cuda.empty_cache()
  return out


def phase_score_side(cfg):
  """Phase 15, 15a-15e, its rounds written into an emptied PC_WORKDIR."""
  start = time.perf_counter()
  shutil.rmtree(PC_WORKDIR, ignore_errors=True)
  out = {"tiny": phase_score_tiny(cfg)}
  out["pc_full"] = phase_pc_full(cfg)
  out["ve_cli"] = phase_ve_pc_cli()
  out["score_only"] = phase_score_only()
  out["seconds"] = time.perf_counter() - start
  log(f"phase 15 took {out['seconds']:.1f} s")
  return out


# phase 16: the flow side. 16a the bare resflow (`flow.model=resflow`) with
# an actnorm after every block, unconditioned, on the chain route (kernel
# 7, 32 launches a step) and under `flow.fused_block=true` (kernels 3 and
# 4 on every block, 32 and 32: an actnorm between blocks breaks every
# stack), then one step without actnorm on the fused route (the first
# block's pair and one stack a scale, kernels 5 and 6, with no
# h-projection); 16b the Glow preset (`cifar10/glow/glow-gaussian-uni`:
# 4 levels, hidden 512, 28 steps) in the joint step, one PC round through
# its sampling direction and its round trip; 16c a MaCow step
# (`cifar10/macow/macow-base-uni`, the encoding direction its
# autoregressive inverse) and a PC round of `macow-cat-uni` drawing h from
# the categorical prior; 16d `optim.num_micro_batch=2` in `step_nll` and
# `step_fid`; 16e CIFAR-10 squeezed (`resflow-gaussian-uni-squeeze`):
# kernel 7 at 12x16x16 and 48x8x8 alone, then one step. Each small
# reference runs the CPU tests' tiny geometry on the card and the CPU.
WOLF = "flow_models/wolf/wolf_configs/cifar10/"
GLOW_PRESET = WOLF + "glow/glow-gaussian-uni.json"
MACOW_PRESET = WOLF + "macow/macow-base-uni.json"
MACOW_CAT_PRESET = WOLF + "macow/macow-cat-uni.json"
SQUEEZE_PRESET = WOLF + "glow/resflow-gaussian-uni-squeeze.json"
BARE = {"flow.model": "resflow", "flow.actnorm": True}
FLOW_SIDE_STEPS = 3
FLOW_SIDE_WORKDIR = os.path.join(REPO, "build", "chip_smoke_flow_side")
# the flow kernels' launches a step on each new path: the score net's
# GroupNorms as ever, no flow kernel for Glow and MaCow (the JAX package
# has none for them)
PER_STEP_NO_FLOW = {**PER_STEP, "neumann_chain": 0}
# the generators' PC rounds: phase 15c's scales for Glow, half of them for
# MaCow's categorical prior (a depth cut: each scale is one evaluation)
GLOW_PC_SCALES = PC_SDE_SCALES
MACOW_PC_SCALES = 10
# the tiny steps of the wolf generators: the smallest image their four
# levels take, 16x16, and the presets shrunk as the CPU tests shrink them
# (`small_preset`): at the presets' own widths (28 Glow steps at hidden
# 512) the card's float32 sums in another order move the tiny Glow step's
# losses by 2.5e-5 and a coupling's bias gradient by 1.9e-4 of the CPU's
# (on an H100 80GB HBM3 at 700 W, PERF.md), past limits set for the
# resflow's nets
WOLF_SMALL = {"data.image_size": 16, "model.ch_mult": (1, 2),
              "model.attn_resolutions": (8,)}


def small_preset(name):
  """`name` with its widths capped (hidden channels and planes at 8, the
  prior's hidden features at 16, at most 2 steps a level), as
  `tests/test_wolf_flows.py:_shrink_widths` caps them, registered as a
  preset of its own; returns its key."""
  from indm_torch.configs import wolf_presets

  def cap(node):
    if isinstance(node, dict):
      for k, v in node.items():
        if k in ("hidden_channels", "hidden_planes"):
          node[k] = [min(int(c), 8) for c in v]
        elif k == "hidden_features":
          node[k] = min(int(v), 16)
        elif k == "num_steps" and isinstance(v, list):
          node[k] = [[min(int(x), 2) for x in e] if isinstance(e, list)
                     else min(int(e), 2) for e in v]
        else:
          cap(v)
    elif isinstance(node, list):
      for v in node:
        cap(v)
    return node

  key = name + "#small"
  wolf_presets.PRESETS[key] = cap(wolf_presets.load_wolf_params(name))
  return key
# x -> z -> x through the Glow at full width, float32, images in [-1, 1]
ROUNDTRIP_ATOL = 1e-4
# 16d's tiny steps: two chunks of 4, the one-chunk tiny step's batch. A
# chunk of 2 normalises the 8x8 image's encoder at its 1x1 level over two
# values, a BatchNorm that divides by their difference: there the card's
# and the CPU's convolution roundings moved an encoder bias gradient by
# 3.9e-3 of itself (on an H100 80GB HBM3, PERF.md), where the chunks of 4
# of the one-chunk step stay within 1.4e-5
MICRO_SMALL_BATCH = 2 * SMALL_BATCH
# kernel 7 at CIFAR-10's squeezed scales, 12 channels at 16x16 and 48 at
# 8x8 (width 512, batch 128), n = 6 timed
SQUEEZE_SCALES = ((12, 16), (48, 8))


def flow_side_config(name="vp/CIFAR10/indm_nll", leaves=None):
  from indm_torch.configs import get_config
  cfg = get_config(name)
  cfg.model.fused_groupnorm = True
  cfg.flow.logdet_pallas = True
  cfg.sampling.batch_size = BATCH
  cfg = set_leaves(cfg, leaves or {})
  if cfg.training.batch_size != TRAIN_BATCH:
    raise AssertionError(f"{name} does not train at batch {TRAIN_BATCH}")
  return cfg


def flow_side_steps(what, cfg, per_step, steps=FLOW_SIDE_STEPS):
  """`steps` full-width joint steps of `cfg` at batch 128 through
  `run_lib.train_steps`: each step's host launch counts equal to
  `per_step`, finite losses (`step_nll`'s with losses = score + flow +
  logp), both nets moved. Returns the row (seconds per step: the median
  of steps 2 on, or the one)."""
  from indm_torch import run_lib
  tr = run_lib.build_training(cfg, device="cuda")
  before = _snapshot(tr)
  torch.cuda.synchronize()
  torch.cuda.reset_peak_memory_stats()
  rows = []
  for i in range(steps):
    reset_kernel_counts()
    (row,) = run_lib.train_steps(tr, 1, log=log)
    torch.cuda.synchronize()
    counts = kernel_counts()
    if counts != per_step:
      raise AssertionError(f"{what} step {i} launched {counts}, expected "
                           f"{per_step}")
    per = row["per_example"]
    if not all(torch.isfinite(m).all() for m in per):
      raise AssertionError(f"{what} step {i}: non-finite losses")
    if cfg.training.likelihood_weighting and not torch.allclose(
        per[0], per[1] + per[2] + per[3], rtol=1e-5, atol=1e-6):
      # (`step_fid` reports phase 2's score loss beside phase 1's total)
      raise AssertionError(f"{what}: losses != score + flow + logp")
    rows.append(row)
  peak = torch.cuda.max_memory_allocated()
  after = _snapshot(tr)
  moved = {k.split(".")[0] for k in before
           if not torch.equal(before[k], after[k])}
  if moved != {"score", "flow"}:
    raise AssertionError(f"{what}: only {moved} changed")
  secs = sorted(r["seconds"] for r in rows[1:] or rows)
  sec = secs[len(secs) // 2]
  out = {"what": what, "steps": steps, "batch": TRAIN_BATCH,
         "seconds_per_step": sec, "images_per_s": TRAIN_BATCH / sec,
         "step_seconds": [r["seconds"] for r in rows],
         "peak_memory_gb": peak / 1e9, "launches_per_step": per_step,
         "losses": [r["losses"] for r in rows]}
  log(f"{what}: {steps} step(s) at batch {TRAIN_BATCH}, seconds "
      f"{out['step_seconds']}, images/s {out['images_per_s']:.2f}, peak "
      f"memory {out['peak_memory_gb']:.3f} GB, launches a step "
      f"{ {k: v for k, v in per_step.items() if v} }")
  del tr
  torch.cuda.empty_cache()
  return out


def phase_bare_resflow(cfg):
  """16a."""
  chain = flow_side_steps("16a bare resflow + actnorm, chain route",
                          flow_side_config(leaves=BARE), PER_STEP)
  fused = flow_side_steps(
      "16a bare resflow + actnorm, flow.fused_block",
      flow_side_config(leaves={**BARE, **FUSED_TRAIN}), PER_STEP_FUSED)
  stack = flow_side_steps(
      "16a bare resflow, no actnorm, flow.fused_block (stacks)",
      flow_side_config(leaves={"flow.model": "resflow", **FUSED_TRAIN}),
      PER_STEP_STACK, steps=1)
  phase_small_train(cfg, BARE, (4, 0, 0, 0, 0, 0))
  phase_small_train(cfg, {**BARE, **FUSED_SMALL}, (0, 4, 0, 0, 0, 0))
  phase_small_train(cfg, {"flow.model": "resflow", **STACK_SMALL},
                    (0, 1, 2, 0, 0, 0))
  return {"chain": chain, "fused": fused, "stack": stack}


def wolf_roundtrip(cfg, what):
  """x -> z (the encoding direction, h from the posterior) -> x (the
  sampling direction on the same h) at full width, batch 64."""
  from indm_torch.flows.flow_model import create_flow_model
  flow = create_flow_model(cfg, device="cuda")
  gen = torch.Generator(device="cuda").manual_seed(16)
  x = torch.rand(BATCH, 3, 32, 32, device="cuda", generator=gen) * 2 - 1
  with torch.no_grad():
    h, _ = flow.discriminator.sampling_and_kl(
        x, torch.randn(BATCH, flow.discriminator.dim, device="cuda",
                       generator=gen))
    z, ld = flow.gen_module(x, h, reverse=True)
    back, ld_back = flow.gen_module(z, h)
  err = (back - x).abs().max().item()
  ld_err = (ld + ld_back).abs().max().item()
  log(f"{what} round trip x -> z -> x at batch {BATCH}: max abs err "
      f"{err:.3e} (limit {ROUNDTRIP_ATOL}), log-dets' sum {ld_err:.3e}, "
      f"max |z| {z.abs().max().item():.3f}")
  if not (torch.isfinite(z).all() and err <= ROUNDTRIP_ATOL):
    raise AssertionError(f"{what}: the round trip does not return x")
  del flow
  torch.cuda.empty_cache()
  return {"max_abs_err": err, "logdet_sum": ld_err}


def wolf_pc_round(cfg, what, scales, workdir):
  """One PC round (Euler-Maruyama, no corrector) of `scales` scales at
  batch 64 through `run_lib.sample_rounds`: kernel 1 95 times an
  evaluation, then the flow's sampling direction with h from the prior."""
  from indm_torch import run_lib
  c = set_leaves(cfg, {"sampling.method": "pc",
                       "sampling.predictor": "euler_maruyama",
                       "sampling.corrector": "none",
                       "sampling.num_scales": scales})
  s = run_lib.build_sampling(c, BATCH, device="cuda")
  row = pc_round_row(c, s, workdir, what)
  del s
  torch.cuda.empty_cache()
  return row


def phase_glow(cfg):
  """16b."""
  glow = flow_side_config(leaves={"flow.model_config": GLOW_PRESET})
  out = {"train": flow_side_steps("16b Glow (glow-gaussian-uni)", glow,
                                  PER_STEP_NO_FLOW),
         "pc_round": wolf_pc_round(glow, "16b Glow PC round", GLOW_PC_SCALES,
                                   os.path.join(FLOW_SIDE_WORKDIR, "glow")),
         "roundtrip": wolf_roundtrip(glow, "16b Glow")}
  phase_small_train(cfg, {**WOLF_SMALL,
                          "flow.model_config": small_preset(GLOW_PRESET)},
                    (0, 0, 0, 0, 0, 0), flow_f64=True)
  return out


def phase_macow(cfg):
  """16c: one MaCow step at full width and batch 128 (the batch is not cut:
  the autoregressive inverse's cost is its rows, H or W dependent
  evaluations a flow, not the batch), the categorical prior's PC round."""
  macow = flow_side_config(leaves={"flow.model_config": MACOW_PRESET})
  out = {"train": flow_side_steps("16c MaCow (macow-base-uni)", macow,
                                  PER_STEP_NO_FLOW, steps=1),
         "pc_round_cat": wolf_pc_round(
             flow_side_config(leaves={"flow.model_config": MACOW_CAT_PRESET}),
             "16c MaCow categorical prior PC round", MACOW_PC_SCALES,
             os.path.join(FLOW_SIDE_WORKDIR, "macow_cat"))}
  phase_small_train(cfg, {**WOLF_SMALL,
                          "flow.model_config": small_preset(MACOW_PRESET)},
                    (0, 0, 0, 0, 0, 0), flow_f64=True)
  return out


def phase_micro_small(cfg, name):
  """The tiny `name` step with two micro-batches, card against CPU: the
  same weights and draws (one StepNoise a chunk, phase 2's too), the
  diffusion times computed on the CPU (as phase 11's): losses within
  TRAIN_SMALL_RTOL, the summed gradients each net's optimizer was handed
  within TRAIN_SMALL_GRAD_RTOL (`grad_rel_err`), the encoder's statistics
  after both chunks within TRAIN_SMALL_RTOL of the largest of them."""
  from indm_torch import joint, run_lib
  from indm_torch.flows.flow_model import FlowNoise, sample_flow_noise
  from indm_torch.configs import get_config
  import numpy as np
  base = get_config(name)
  base.model.fused_groupnorm = True
  small = set_leaves(base, {**SMALL, "model.dropout": 0.0,
                            "training.batch_size": MICRO_SMALL_BATCH,
                            "flow.logdet_pallas": True,
                            "optim.num_micro_batch": 2})
  trs = {d: run_lib.build_training(small, device=d, seed=7)
         for d in ("cpu", "cuda")}
  batch = run_lib.next_batch(trs["cpu"])
  gen = torch.Generator().manual_seed(8)
  half = (MICRO_SMALL_BATCH // 2,) + tuple(batch.shape[1:])
  fid = not small.training.likelihood_weighting
  noise = []
  for k in range(2):
    flow = sample_flow_noise(trs["cpu"].flow_model, half, gen,
                             np.random.default_rng(9 + k))
    p2 = (joint.Phase2Noise(torch.rand(half[0], generator=gen),
                            torch.randn(half, generator=gen),
                            torch.randn(flow.enc_eps.shape, generator=gen),
                            torch.rand((), generator=gen)) if fid else None)
    noise.append(joint.StepNoise(flow, torch.rand(half[0], generator=gen),
                                 torch.randn(half, generator=gen),
                                 torch.randn(half, generator=gen), p2))
  out = {}
  for d, tr in trs.items():
    if d == "cuda":
      cpu_time = trs["cpu"].sde.get_diffusion_time

      def on_cpu(b, t_min, *args, u=None, cpu_time=cpu_time, **kwargs):
        t, w = cpu_time(b, torch.as_tensor(t_min).cpu(), args[0], None,
                        "cpu", u=u.cpu())
        return t.cuda(), torch.as_tensor(w).cuda()

      tr.sde.get_diffusion_time = on_cpu
    mv = lambda x: None if x is None else x.to(d)
    nd = [joint.StepNoise(
        FlowNoise(mv(n.flow.enc_eps), [(v.to(d), m) for v, m in
                                       n.flow.blocks]),
        mv(n.u_t), mv(n.z), mv(n.logp_z),
        None if n.phase2 is None else joint.Phase2Noise(
            *(mv(x) for x in n.phase2))) for n in noise]
    grads = {}
    for tag, opt in (("score", tr.score_opt), ("flow", tr.flow_opt)):
      names = [k for k, _ in (tr.score_model if tag == "score"
                              else tr.flow_model).named_parameters()]

      def record(opt=opt, tag=tag, names=names, real=opt.step):
        grads.update({f"{tag}.{k}": p.grad.detach().cpu()
                      for k, p in zip(names, opt.params)
                      if p.grad is not None})
        real()

      opt.step = record
    metrics = tr.step_fn(batch.to(d), nd)
    stats = {k: v.detach().cpu() for k, v in tr.flow_model.state_dict()
             .items() if k.endswith(("running_mean", "running_var"))}
    out[d] = ([m.detach().cpu() for m in metrics], grads, stats)
  (l_cpu, g_cpu, s_cpu), (l_gpu, g_gpu, s_gpu) = out["cpu"], out["cuda"]
  loss_err = max(((a - b).abs().max() / b.abs().max()).item()
                 for a, b in zip(l_gpu, l_cpu))
  # the statistics against the largest of them (running means near 0)
  stat_err = max((s_gpu[k] - v).abs().max().item()
                 for k, v in s_cpu.items()) / max(
                     v.abs().max().item() for v in s_cpu.values())
  if set(g_cpu) != set(g_gpu) or len(g_cpu) < 100:
    raise AssertionError("the card and the CPU produced other gradients")
  grad_err, worst = grad_rel_err(g_cpu, g_gpu)
  log(f"16d small reference {name}, two micro-batches: card vs cpu losses "
      f"max rel err {loss_err:.3e} (limit {TRAIN_SMALL_RTOL}); gradients "
      f"max rel err {grad_err:.3e} at {worst} (limit "
      f"{TRAIN_SMALL_GRAD_RTOL}); BatchNorm statistics {stat_err:.3e}")
  if not (loss_err <= TRAIN_SMALL_RTOL and grad_err <= TRAIN_SMALL_GRAD_RTOL
          and stat_err <= TRAIN_SMALL_RTOL and all(
              l.shape == (MICRO_SMALL_BATCH,) for l in l_gpu)):
    raise AssertionError(f"the tiny {name} step with two micro-batches on "
                         "the card disagrees with the CPU")
  return {"loss_err": loss_err, "grad_err": grad_err, "stat_err": stat_err}


def phase_micro(cfg):
  """16d: the joint steps with two micro-batches at batch 128 on the chain
  route (each chunk launches its own kernels), then the small
  references."""
  micro = {"optim.num_micro_batch": 2}
  per2 = {k: 2 * v for k, v in PER_STEP.items()}
  out = {"nll": flow_side_steps("16d step_nll, two micro-batches",
                                flow_side_config(leaves=micro), per2,
                                steps=1),
         "fid": flow_side_steps(
             "16d step_fid, two micro-batches",
             flow_side_config("vp/CIFAR10/indm_fid", micro),
             {**per2, "group_norm_fwd": 4 * GN_PER_SCORE_EVAL,
              "group_norm_bwd": 4 * GN_PER_SCORE_EVAL}, steps=1)}
  out["small"] = {n: phase_micro_small(cfg, n) for n in (
      "vp/CIFAR10/indm_nll", "vp/CIFAR10/indm_fid")}
  return out


def phase_squeeze_chain():
  """16e: kernel 7 at CIFAR-10's squeezed scales, pre-activated (n = 2 and
  6) and not (n = 6), held against its plain version on float64 inputs
  within CHAIN_RTOL of the largest value; at n = 6 its time in a CUDA
  graph beside its bound (`flow_bounds`), the plain version's and the
  `F.conv2d` chain's; then one step of the squeezed preset."""
  from indm_torch.flows.resflow import OFFSET_TRAIN, RCDF_TRAIN
  from indm_torch.ops import neumann
  gen = torch.Generator(device="cuda").manual_seed(16)
  rows, max_err = [], 0.0
  for c, hw in SQUEEZE_SCALES:
    flops = chain_flops_per_term(TRAIN_BATCH, c, hw)
    for preact in (True, False):
      vareps, dacts, ws = chain_inputs(TRAIN_BATCH, c, hw, preact, gen)
      for n in (CELEBA_NS if preact else CELEBA_NS[-1:]):
        args = (vareps, dacts, ws, n, OFFSET_TRAIN, RCDF_TRAIN)
        acc = neumann.neumann_chain(*args)
        ref = neumann.neumann_chain_plain(
            f64(vareps), f64(dacts), f64(ws), n, OFFSET_TRAIN, RCDF_TRAIN,
            compute_dtype=torch.float32)
        err = (acc.double() - ref).abs().max().item()
        big = ref.abs().max().item()
        if not (math.isfinite(err) and err <= CHAIN_RTOL * big):
          raise AssertionError(f"neumann_chain [{TRAIN_BATCH},{c},{hw},{hw}]"
                               f" preact={preact} n={n}: max abs err {err} "
                               f"over {CHAIN_RTOL} x {big}")
        max_err = max(max_err, err)
        row = {"shape": [TRAIN_BATCH, c, hw, hw], "preact": preact, "n": n,
               "max_abs_err": err, "max_abs": big}
        if n == max(CELEBA_NS):
          terms = n + OFFSET_TRAIN
          bound, simt, by = flow_bounds(
              scaled(flops, terms),
              flow_bytes("chain", TRAIN_BATCH, c, hw, preact))
          row.update(
              ms=cuda_ms(lambda: neumann.neumann_chain(*args), 5, 1),
              graph_ms=graph_ms(lambda: neumann.neumann_chain(*args), 5, 2),
              plain_ms=cuda_ms(lambda: neumann.neumann_chain_plain(*args),
                               3, 1),
              library_ms=cuda_ms(lambda: chain_library(vareps, dacts, ws, n),
                                 3, 1),
              bound_ms=bound, simt_bound_ms=simt, bound_by=by)
        log(f"16e neumann_chain [{TRAIN_BATCH},{c},{hw},{hw}] preact="
            f"{preact} n={n}: max_abs_err={err:.3e} (max |acc| {big:.3e}) "
            + " ".join(f"{k}={v:.4f}" for k, v in row.items()
                       if k.endswith("ms"))
            + (f" ({row['bound_ms'] / row['graph_ms']:.3f} of the bound in "
               "the graph)" if "graph_ms" in row else ""))
        rows.append(row)
      del vareps, dacts, ws
      torch.cuda.empty_cache()
  train = flow_side_steps(
      "16e CIFAR-10 squeezed (resflow-gaussian-uni-squeeze)",
      flow_side_config(leaves={"flow.model_config": SQUEEZE_PRESET,
                               "flow.squeeze": True}), PER_STEP, steps=1)
  return {"chain": rows, "max_abs_err": max_err, "train": train}


def phase_flow_side(cfg):
  """Phase 16, 16a-16e."""
  start = time.perf_counter()
  shutil.rmtree(FLOW_SIDE_WORKDIR, ignore_errors=True)
  out, seconds = {}, {}
  for key, run in (("bare", phase_bare_resflow), ("glow", phase_glow),
                   ("macow", phase_macow), ("micro", phase_micro),
                   ("squeeze", lambda _: phase_squeeze_chain())):
    t0 = time.perf_counter()
    out[key] = run(cfg)
    seconds[key] = time.perf_counter() - t0
    log(f"-- phase 16 {key} took {seconds[key]:.1f} s")
  out["seconds"] = time.perf_counter() - start
  out["seconds_by_part"] = seconds
  log(f"phase 16 took {out['seconds']:.1f} s")
  return out


def flow_side_launches(fs, name):
  """A kernel's launches a step on each of phase 16's paths."""
  return {
      "bare_chain": fs["bare"]["chain"]["launches_per_step"][name],
      "bare_fused_actnorm": fs["bare"]["fused"]["launches_per_step"][name],
      "bare_fused_stack": fs["bare"]["stack"]["launches_per_step"][name],
      "glow": fs["glow"]["train"]["launches_per_step"][name],
      "macow": fs["macow"]["train"]["launches_per_step"][name],
      "micro2_nll": fs["micro"]["nll"]["launches_per_step"][name],
      "micro2_fid": fs["micro"]["fid"]["launches_per_step"][name],
      "cifar_squeezed": fs["squeeze"]["train"]["launches_per_step"][name]}


# phase 17: the other score nets, at full width through the normal entry
# points on seeded synthetic data, `flow.model=identity`,
# `model.fused_groupnorm=True`: 17a Ho et al.'s CIFAR-10 DDPM (three
# score-only steps at batch 128, one evaluation at batch 64 kernels against
# plain, an Euler-Maruyama PC round of 20 scales through
# `indm_torch.sample`); 17b NCSN++ with DDPM++ blocks (an evaluation and a
# step at batch 128); 17c the 256-pixel VE NCSN++ geometry of score_sde's
# CelebA-HQ configs (FIR, both pyramids; an evaluation and a step at
# batch 8); 17d NCSNv2 on the NCSNv2 paper's CIFAR-10 settings (232
# scales; sigma from the config's 50 to 0.01, its defaults; two SMLD
# steps at batch 128, an annealed-Langevin round at 10 of its 232 scales
# through `indm_torch.sample`), `ncsnv2_128` and `ncsnv2_256` evaluated at
# 128 and 256 pixels, `ncsn` with a class a noise level; 17e VDM on
# gamma(t) labels and its auxiliary state saved and restored. The launches
# of kernels 1, 2 and 9 are derived from each net before it runs; each
# distinct kernel call of the nets is held against its plain version and
# timed in a CUDA graph beside its bound; the tiny nets run on the card
# and the CPU (SMALL_RTOL). DDPM's evaluations run on perturbed weights
# (`perturbed`), so that its GroupNorms reach the output.
OTHER_WORKDIR = os.path.join(REPO, "build", "chip_smoke_other_nets")
OTHER_COMMON = {"flow.model": "identity", "model.fused_groupnorm": True,
                "model.init_scale": 1.0}
OTHER_NETS = {
    "ddpm_cifar10": ("vp/CIFAR10/indm_nll", {"model.name": "ddpm",
                                             "model.num_res_blocks": 2}),
    "ncsnpp_ddpm_blocks": ("vp/CIFAR10/indm_nll",
                           {"model.resblock_type": "ddpm"}),
    "ncsnpp_256": ("ve/CELEBA/indm", {
        "data.image_size": 256, "model.ch_mult": (1, 1, 2, 2, 2, 2, 2),
        "model.num_res_blocks": 2, "model.attn_resolutions": (16,),
        "model.progressive": "output_skip",
        "model.progressive_input": "input_skip",
        "model.progressive_combine": "sum", "model.fir": True}),
    "ncsnv2_cifar10": ("ve/CIFAR10/indm", {
        "model.name": "ncsnv2_64", "model.normalization": "InstanceNorm++",
        "model.nonlinearity": "elu", "training.continuous": False,
        "training.likelihood_weighting": False,
        "training.importance_sampling": False, "model.num_scales": 232}),
    "vdm": ("vp/CIFAR10/indm_nll", {"model.name": "vdm"}),
}
OTHER_DDPM_STEPS = 3
OTHER_NCSNV2_STEPS = 2
OTHER_256_BATCH = 8
OTHER_DDPM_SCALES = 20
OTHER_ALD_SCALES = 10
# the tiny nets (card against CPU): each config at 16 pixels, nf 16, one
# res block a level; the 256-pixel geometry keeps its pyramids and FIR
OTHER_TINY = {"data.image_size": 16, "model.nf": 16,
              "model.num_res_blocks": 1, "model.ch_mult": (1, 2),
              "model.attn_resolutions": (8,)}


def other_config(name, extra=None):
  from indm_torch.configs import get_config
  base, leaves = OTHER_NETS[name]
  cfg = set_leaves(get_config(base), {**OTHER_COMMON, **leaves,
                                      **(extra or {})})
  if cfg.model.name == "ncsn":
    cfg.model.num_classes = cfg.model.num_scales  # a class a noise level
  return cfg


def other_launches(model):
  """(kernel 1 launches an evaluation, kernel 9 launches an evaluation,
  kernel 9 backward launches a training step), derived from the net: each
  fused GroupNorm once; FIR twice in a BigGAN up or down block, once in a
  FIR resampling module, once a level in a shared pyramid resampler; no
  backward for the resampling of the data (the input pyramid's first
  level, or every level of `input_skip`'s)."""
  from indm_torch.models import layers
  gn_n = sum(isinstance(m, layers.GroupNorm) and m.fused
             for m in model.modules())
  fir_n = data = 0
  for name, m in model.named_modules():
    if isinstance(m, layers.ResnetBlockBigGANpp) and m.fir and (m.up
                                                               or m.down):
      fir_n += 2
    elif isinstance(m, (layers.Upsample, layers.Downsample)) and m.fir:
      uses = (model.num_resolutions - 1 if name.startswith("pyramid_")
              else 1)
      fir_n += uses
      if name == "pyramid_downsample":
        data += uses
  if getattr(model, "progressive_input", "none") == "residual" and fir_n:
    data += 1
  return gn_n, fir_n, fir_n - data


def other_eval_fn(cfg, model, batch, gen, gamma_fn=None):
  """(score_fn, x, t) at `batch` on the card; the VDM net takes
  gamma(t)."""
  from indm_torch import sde as sde_lib
  from indm_torch.models.registry import get_score_fn
  size = cfg.data.image_size
  x = torch.randn(batch, 3, size, size, device="cuda", generator=gen)
  t = torch.rand(batch, device="cuda", generator=gen) * 0.9 + 0.05
  with torch.no_grad():
    kw = {} if gamma_fn is None else {"gamma_t": gamma_fn(t)}
  return get_score_fn(cfg, sde_lib.get_sde(cfg), model, **kw), x, t


def net_calls(model, fn):
  """(Counter of (shape, groups, act) of kernel 1, [(shape, up, down, pad,
  taps, count)] of kernel 9) in one call of fn()."""
  from indm_torch.models.layers import GroupNorm
  from indm_torch.ops import upfirdn2d as fir
  seen, taps, fir_seen = collections.Counter(), {}, collections.Counter()
  hooks = [m.register_forward_pre_hook(
      lambda mod, args: seen.update([(tuple(args[0].shape), mod.num_groups,
                                      mod.kernel_act)]))
           for m in model.modules() if isinstance(m, GroupNorm) and m.fused]
  kernel = fir.upfirdn2d

  def record(v, k, up=1, down=1, pad=(0, 0)):
    key = (tuple(v.shape), up, down, tuple(pad), k.tobytes())
    fir_seen[key] += 1
    taps[key] = k
    return kernel(v, k, up, down, pad)

  fir.upfirdn2d = record
  try:
    with torch.no_grad():
      fn()
    torch.cuda.synchronize()
  finally:
    fir.upfirdn2d = kernel
    for h in hooks:
      h.remove()
  return seen, [key[:4] + (taps[key], n) for key, n in sorted(
      fir_seen.items())]


def other_kernel_rows(what, gn_shapes, fir_calls, bwd_batch):
  """Kernels 1 and 2 at each distinct GroupNorm call (the backward at
  `bwd_batch`), kernel 9 forward and backward at each FIR call, float32,
  against their plain versions (the forward within TOL, the backward
  within GN_BWD_TOL, kernel 9 within FIR_RTOL of the largest value, its
  backward against autograd of the plain version on float64 inputs), each
  timed in a CUDA graph beside its bytes bound; returns the per-evaluation
  (per-step for the backwards) sums and the largest errors."""
  import numpy as np
  from indm_torch.ops import group_norm as gn
  from indm_torch.ops import upfirdn2d as fir
  gen = torch.Generator(device="cuda").manual_seed(17)
  sums = collections.defaultdict(float)
  errs = collections.defaultdict(float)
  rows = []
  for (shape, groups, act), count in sorted(gn_shapes.items()):
    c = shape[1]
    scale = 1.0 + 0.2 * torch.randn(c, device="cuda", generator=gen)
    bias = 0.2 * torch.randn(c, device="cuda", generator=gen)
    xs = 0.5 + 1.5 * torch.randn(shape, device="cuda", generator=gen)
    y = gn.group_norm_act(xs, scale, bias, groups, act=act)
    want = gn.group_norm_act_plain(xs, scale, bias, groups, act=act)
    err = (y - want).abs().max().item()
    tol = TOL[torch.float32]
    if not (math.isfinite(err) and not ((y - want).abs() > tol + tol
                                        * want.abs()).any().item()):
      raise AssertionError(f"17 {what}: group_norm {shape} {act}: {err}")
    fwd_ms = graph_ms(lambda: gn.group_norm_act(xs, scale, bias, groups,
                                                act=act))
    fwd_bound = 2 * 4 * xs.numel() / HBM_BYTES_PER_S * 1e3
    del y, want
    bshape = (bwd_batch,) + tuple(shape[1:])
    xb = 0.5 + 1.5 * torch.randn(bshape, device="cuda", generator=gen)
    dy = torch.randn(bshape, device="cuda", generator=gen)
    args = (xb, dy, scale, bias, groups, 1e-6, act)
    got = gn.group_norm_act_backward(*args)
    ref = gn.group_norm_act_backward_plain(*args)
    berr = 0.0
    for name, a, b, btol in zip(("dx", "dscale", "dbias"), got, ref,
                                GN_BWD_TOL[torch.float32]):
      e = (a - b).abs().max().item()
      if not (math.isfinite(e) and e <= btol * b.abs().max().item() + btol):
        raise AssertionError(f"17 {what}: group_norm backward {bshape} "
                             f"{name}: {e}")
      berr = max(berr, e) if name == "dx" else berr
    del got, ref
    bwd_ms = graph_ms(lambda: gn.group_norm_act_backward(*args))
    bwd_bound = 3 * 4 * xb.numel() / HBM_BYTES_PER_S * 1e3
    plan = gn.bwd_plan(c, shape[2] * shape[3], groups, 4,
                       (shape[2] * shape[3]) % 4 == 0)
    log(f"17 {what} group_norm {list(shape)} groups={groups} act={act} "
        f"x{count}: err {err:.3e} graph_ms {fwd_ms:.5f} bound "
        f"{fwd_bound:.5f} ({fwd_bound / fwd_ms:.3f}); backward "
        f"{list(bshape)} plan={plan}: dx err {berr:.3e} graph_ms "
        f"{bwd_ms:.5f} bound {bwd_bound:.5f} ({bwd_bound / bwd_ms:.3f})")
    rows.append({"kernel": "group_norm", "shape": list(shape),
                 "groups": groups, "act": act, "count": count,
                 "max_abs_err": err, "graph_ms": fwd_ms,
                 "bound_ms": fwd_bound, "bwd_shape": list(bshape),
                 "bwd_plan": list(plan), "bwd_max_abs_err": berr,
                 "bwd_graph_ms": bwd_ms, "bwd_bound_ms": bwd_bound})
    for k, v in (("gn_graph_ms", fwd_ms), ("gn_bound_ms", fwd_bound),
                 ("gn_bwd_graph_ms", bwd_ms), ("gn_bwd_bound_ms", bwd_bound)):
      sums[k] += count * v
    errs["group_norm_fwd"] = max(errs["group_norm_fwd"], err)
    errs["group_norm_bwd"] = max(errs["group_norm_bwd"], berr)
    del xs, xb, dy, args
  for shape, up, down, pad, k, count in fir_calls:
    x = torch.randn(shape, device="cuda", generator=gen)
    y = fir.upfirdn2d(x, k, up, down, pad)
    want = fir.upfirdn2d_plain(x, k, up, down, pad)
    big = want.abs().max().item()
    err = (y - want).abs().max().item()
    if y.shape != want.shape or not err <= FIR_RTOL * big:
      raise AssertionError(f"17 {what}: upfirdn2d {shape} up={up}: {err}")
    fwd_ms = graph_ms(lambda: fir.upfirdn2d(x, k, up, down, pad))
    fwd_bound = 4 * (x.numel() + y.numel()) / HBM_BYTES_PER_S * 1e3
    xg = x.detach().requires_grad_(True)
    yg = fir.upfirdn2d(xg, k, up, down, pad)
    dy = torch.randn(yg.shape, device="cuda", generator=gen)
    (dx,) = torch.autograd.grad(yg, xg, dy)
    x64 = x.double().requires_grad_(True)
    (dwant,) = torch.autograd.grad(
        fir.upfirdn2d_plain(x64, k, up, down, pad), x64, dy.double())
    berr = (dx.double() - dwant).abs().max().item()
    if dx.shape != x.shape or not berr <= FIR_RTOL * dwant.abs().max().item():
      raise AssertionError(f"17 {what}: upfirdn2d backward {shape}: {berr}")
    del x64, dwant, yg
    kk = fir.taps(k).k
    adjoint = (np.ascontiguousarray(kk[::-1, ::-1]), down, up,
               fir.adjoint_pads(shape[2], y.shape[2], kk.shape[0], up, down,
                                pad))
    bwd_ms = graph_ms(lambda: fir._launch(dy, *adjoint))
    bwd_bound = 4 * (dy.numel() + dx.numel()) / HBM_BYTES_PER_S * 1e3
    plan = fir.plane_plan(shape[0] * shape[1], shape[2], shape[3],
                          *y.shape[2:])
    log(f"17 {what} upfirdn2d {list(shape)} -> {list(y.shape)} up={up} "
        f"down={down} pad={pad} x{count} plan={plan}: err {err:.3e} "
        f"graph_ms {fwd_ms:.5f} bound {fwd_bound:.5f} "
        f"({fwd_bound / fwd_ms:.3f}); backward err {berr:.3e} graph_ms "
        f"{bwd_ms:.5f} bound {bwd_bound:.5f} ({bwd_bound / bwd_ms:.3f})")
    rows.append({"kernel": "upfirdn2d", "shape": list(shape),
                 "out": list(y.shape), "up": up, "down": down,
                 "pad": list(pad), "count": count, "plan": plan,
                 "max_abs_err": err, "graph_ms": fwd_ms,
                 "bound_ms": fwd_bound, "bwd_max_abs_err": berr,
                 "bwd_graph_ms": bwd_ms, "bwd_bound_ms": bwd_bound})
    for key, v in (("fir_graph_ms", fwd_ms), ("fir_bound_ms", fwd_bound),
                   ("fir_bwd_graph_ms", bwd_ms),
                   ("fir_bwd_bound_ms", bwd_bound)):
      sums[key] += count * v
    errs["upfirdn2d"] = max(errs["upfirdn2d"], err)
    errs["upfirdn2d_bwd"] = max(errs["upfirdn2d_bwd"], berr)
    del x, y, want, xg, dy, dx
  torch.cuda.empty_cache()
  return dict(sums), dict(errs), rows


def other_eval(what, cfg, batch, gamma_fn=None, model=None):
  """One full-width evaluation through the kernels and through their
  plain versions (SCORE_RTOL), the launches held to those derived from
  the net; then the kernels at the evaluation's calls
  (`other_kernel_rows`, the backward at the config's training batch)."""
  from indm_torch.models.registry import create_model
  if model is None:
    model = create_model(cfg, seed=cfg.seed, device="cuda")
  gn_n, fir_n, _ = other_launches(model)
  gen = torch.Generator(device="cuda").manual_seed(3)
  score_fn, x, t = other_eval_fn(cfg, model, batch, gen, gamma_fn)
  reset_kernel_counts()
  with torch.no_grad():
    s = score_fn(x, t)
  torch.cuda.synchronize()
  counts = kernel_counts()
  want = {k: 0 for k in counts}
  want.update(group_norm_fwd=gn_n, upfirdn2d=fir_n)
  with torch.no_grad(), plain_group_norm(), plain_fir():
    s_plain = score_fn(x, t)
  torch.cuda.synchronize()
  rel = max_rel(s, s_plain.cpu())
  with torch.no_grad():
    eval_ms = cuda_ms(lambda: score_fn(x, t), iters=3, warmup=1)
  log(f"17 {what}: evaluation at batch {batch} launched {counts['group_norm_fwd']} "
      f"and {counts['upfirdn2d']} (derived {gn_n} and {fir_n}); kernels vs "
      f"plain max rel err {rel:.3e} (limit {SCORE_RTOL}); {eval_ms:.3f} ms")
  if counts != want:
    raise AssertionError(f"17 {what}: launches {counts}, derived {want}")
  if not (torch.isfinite(s).all() and rel <= SCORE_RTOL
          and s.shape == x.shape):
    raise AssertionError(f"17 {what}: the evaluation disagrees with plain")
  out = {"batch": batch, "launches": counts, "rel_err_vs_plain": rel,
         "eval_ms": eval_ms}
  if gn_n or fir_n:
    gn_shapes, fir_calls = net_calls(model, lambda: score_fn(x, t))
    sums, errs, rows = other_kernel_rows(what, gn_shapes, fir_calls,
                                         cfg.training.batch_size)
    out.update(per_eval=sums, max_abs_err=errs, by_shape=rows)
  del model, s, s_plain
  torch.cuda.empty_cache()
  return out


def other_steps(what, cfg, steps):
  """`steps` score-only steps through `run_lib.train_steps` at the
  config's batch: the launches a step held to those derived from the net
  (kernel 2 once for each kernel 1 launch; kernel 9's backward but for the
  data's resampling), finite losses; seconds a step (the median), images/s
  and peak memory."""
  from indm_torch import run_lib
  tr = run_lib.build_training(cfg, device="cuda")
  gn_n, fir_n, fir_bwd = other_launches(tr.score_model)
  per_step = {k: 0 for k in kernel_counts()}
  per_step.update(group_norm_fwd=gn_n, group_norm_bwd=gn_n,
                  upfirdn2d=fir_n, upfirdn2d_bwd=fir_bwd)
  torch.cuda.reset_peak_memory_stats()
  reset_kernel_counts()
  rows = run_lib.train_steps(tr, steps, log=log)
  torch.cuda.synchronize()
  counts = kernel_counts()
  secs = [r["seconds"] for r in rows]
  mid = sorted(secs)[len(secs) // 2]
  b = cfg.training.batch_size
  out = {"steps": steps, "batch": b, "seconds": secs,
         "seconds_per_step": mid, "images_per_s": b / mid,
         "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
         "launches_per_step": {k: counts[k] // steps for k in counts},
         "losses": [r["losses"] for r in rows]}
  log(f"17 {what}: {steps} score-only step(s) at batch {b}: seconds "
      f"{secs}, images/s {out['images_per_s']:.2f}, peak memory "
      f"{out['peak_memory_gb']:.3f} GB, launches {counts} (derived "
      f"{per_step} a step)")
  if counts != {k: v * steps for k, v in per_step.items()}:
    raise AssertionError(f"17 {what}: launches {counts}")
  if not all(math.isfinite(v) for v in out["losses"]):
    raise AssertionError(f"17 {what}: non-finite losses")
  del tr
  torch.cuda.empty_cache()
  return out


def other_round(what, name, extra, batch, evals_per_scale, net_cls):
  """One round through `python -m indm_torch.sample`'s `main` on `name`
  with `extra` leaves (into an emptied folder): the score net's calls
  counted on the host, every kernel's launches held to those derived from
  the net (kernel 1 once a fused GroupNorm an evaluation, no other
  kernel), finite images."""
  from indm_torch import sample
  from indm_torch.models.registry import model_classes
  base, leaves = OTHER_NETS[name]
  wd = os.path.join(OTHER_WORKDIR, what)
  shutil.rmtree(wd, ignore_errors=True)
  sets = {**OTHER_COMMON, **leaves, **extra}
  args = ["--config", base, "--batch", str(batch), "--workdir", wd]
  for k, v in sets.items():
    args += ["--set", f"{k}={v}"]
  cfg = other_config(name, extra)
  gn_n = other_launches(model_classes()[cfg.model.name](cfg,
                                                         device="meta"))[0]
  expected = cfg.sampling.num_scales * evals_per_scale
  reset_kernel_counts()
  with counting_evals(net_cls) as evals:
    (row,) = sample.main(args)
  torch.cuda.synchronize()
  counts = kernel_counts()
  want = {k: 0 for k in counts}
  want["group_norm_fwd"] = gn_n * evals[0]
  out = {"batch": batch, "num_scales": cfg.sampling.num_scales,
         "score_evals": evals[0], "nfe": row["nfe"],
         "seconds": row["seconds"], "images_per_s": row["images_per_s"],
         "launches": counts}
  log(f"17 {what}: {out['num_scales']} scales at batch {batch}, score "
      f"evals {evals[0]} (expected {expected}), seconds "
      f"{row['seconds']:.3f}, images/s {row['images_per_s']:.3f}, launches "
      f"{counts} (kernel 1 {gn_n} an evaluation)")
  if evals[0] != expected or counts != want:
    raise AssertionError(f"17 {what}: {evals[0]} evaluations, launches "
                         f"{counts}, derived {want}")
  size = cfg.data.image_size
  if tuple(row["after"].shape) != (batch, size, size, 3) or not \
      torch.isfinite(row["after"]).all():
    raise AssertionError(f"17 {what}: images wrong or not finite")
  return out


def perturbed(model, seed, scale=0.05):
  """`model` with seeded normal noise of `scale` added to every parameter,
  drawn on the CPU (a net on the card and one on the CPU get the same).
  DDPM starts its res blocks' second convs, its attention's output and its
  last conv at ~1e-10 (init scale 0, which `model.init_scale` does not
  reach): at its init the output is nearly a chain of skips, and a wrong
  GroupNorm inside the blocks would pass the comparisons."""
  gen = torch.Generator().manual_seed(seed)
  with torch.no_grad():
    for p in model.parameters():
      p.add_(scale * torch.randn(p.shape, generator=gen).to(p.device))
  return model


def other_tiny(name, extra=None, gamma=False, perturb=False):
  """The tiny net of `name` on the card (kernels) and the CPU (plain
  versions), the same weights (`perturb`: perturbed) and inputs:
  SMALL_RTOL of the largest score."""
  from indm_torch.models.registry import create_model
  from indm_torch.models.vdm import VDMAux, get_gamma_fn
  cfg = other_config(name, {**OTHER_TINY, **(extra or {})})
  gen = torch.Generator().manual_seed(11)
  x = torch.randn(SMALL_BATCH, 3, 16, 16, generator=gen)
  t = torch.rand(SMALL_BATCH, generator=gen) * 0.9 + 0.05
  got = {}
  for d in ("cpu", "cuda"):
    model = create_model(cfg, seed=7, device=d)
    if perturb:
      perturbed(model, 8)
    kw = {}
    if gamma:
      aux = VDMAux(generator=torch.Generator().manual_seed(5)).to(d)
      with torch.no_grad():
        kw["gamma_t"] = get_gamma_fn(aux.gamma, aux.schedule)(t.to(d))
    from indm_torch import sde as sde_lib
    from indm_torch.models.registry import get_score_fn
    with torch.no_grad():
      got[d] = get_score_fn(cfg, sde_lib.get_sde(cfg), model, **kw)(
          x.to(d), t.to(d))
  err = max_rel(got["cuda"], got["cpu"])
  log(f"17 tiny {name}{' ' + str(extra) if extra else ''}: card vs cpu max "
      f"rel err {err:.3e} (limit {SMALL_RTOL})")
  if not err <= SMALL_RTOL:
    raise AssertionError(f"17 tiny {name} on the card disagrees with the "
                         "CPU")
  return err


def phase_other_nets():
  """Phase 17, 17a-17e (see the note above OTHER_NETS)."""
  from indm_torch import run_lib
  from indm_torch.models import ddpm, ncsnv2
  from indm_torch.models.registry import create_model
  from indm_torch.models.vdm import get_gamma_fn
  start = time.perf_counter()
  shutil.rmtree(OTHER_WORKDIR, ignore_errors=True)
  out = {"tiny": {}}
  seconds = {}

  def stamp(part, t0):
    seconds[part] = time.perf_counter() - t0
    log(f"-- phase {part} took {seconds[part]:.1f} s")

  t0 = time.perf_counter()
  cfg = other_config("ddpm_cifar10")
  out["ddpm_cifar10"] = {
      "train": other_steps("17a ddpm", cfg, OTHER_DDPM_STEPS),
      # perturbed, so that every GroupNorm is on the output's path
      "eval": other_eval("17a ddpm", cfg, BATCH, model=perturbed(
          create_model(cfg, seed=cfg.seed, device="cuda"), 9)),
      "round": other_round("17a_ddpm_round", "ddpm_cifar10", {
          "sampling.method": "pc", "sampling.predictor": "euler_maruyama",
          "sampling.corrector": "none",
          "sampling.num_scales": OTHER_DDPM_SCALES}, BATCH, 1, ddpm.DDPM)}
  if out["ddpm_cifar10"]["eval"]["launches"]["group_norm_fwd"] != 49:
    raise AssertionError("17a: DDPM's 49 GroupNorms")
  # min(32, C) groups: every width at most 32 or a multiple of it (the
  # JAX net's flax GroupNorm asserts the same)
  out["tiny"]["ddpm_cifar10"] = other_tiny("ddpm_cifar10",
                                           {"model.ch_mult": (1, 1)},
                                           perturb=True)
  stamp("17a", t0)

  t0 = time.perf_counter()
  cfg = other_config("ncsnpp_ddpm_blocks")
  out["ncsnpp_ddpm_blocks"] = {"eval": other_eval("17b", cfg, TRAIN_BATCH),
                               "train": other_steps("17b", cfg, 1)}
  out["tiny"]["ncsnpp_ddpm_blocks"] = other_tiny("ncsnpp_ddpm_blocks")
  stamp("17b", t0)

  t0 = time.perf_counter()
  cfg = other_config("ncsnpp_256", {"training.batch_size": OTHER_256_BATCH})
  out["ncsnpp_256"] = {"eval": other_eval("17c", cfg, OTHER_256_BATCH),
                       "train": other_steps("17c", cfg, 1)}
  out["tiny"]["ncsnpp_256"] = other_tiny("ncsnpp_256", {
      "model.ch_mult": (1, 1, 2), "model.attn_resolutions": (4,)})
  stamp("17c", t0)

  t0 = time.perf_counter()
  cfg = other_config("ncsnv2_cifar10")
  v2 = {"train": other_steps("17d ncsnv2_64", cfg, OTHER_NCSNV2_STEPS),
        "round": other_round("17d_ald_round", "ncsnv2_cifar10", {
            "sampling.predictor": "none", "sampling.corrector": "ald",
            "sampling.num_scales": OTHER_ALD_SCALES}, BATCH, 1,
            ncsnv2._RefineNet)}
  for net, size in (("ncsnv2_128", 128), ("ncsnv2_256", 256),
                    ("ncsn", 32)):
    c = other_config("ncsnv2_cifar10", {"model.name": net,
                                        "data.image_size": size})
    v2[net] = other_eval(f"17d {net}", c, OTHER_256_BATCH)
  out["ncsnv2_cifar10"] = v2
  for net in ("ncsnv2_64", "ncsn"):
    out["tiny"][net] = other_tiny("ncsnv2_cifar10", {"model.name": net})
  stamp("17d", t0)

  t0 = time.perf_counter()
  cfg = other_config("vdm")
  aux_dir = os.path.join(OTHER_WORKDIR, "vdm")
  aux = run_lib.load_vdm_aux(cfg, aux_dir, seed=5, device="cuda")
  run_lib.save_vdm_aux(aux)
  again = run_lib.load_vdm_aux(cfg, aux_dir, seed=6, device="cuda")
  differ = [k for k, v in aux["model"].state_dict().items()
            if not torch.equal(v, again["model"].state_dict()[k])]
  if differ or not all(torch.equal(a, b) for a, b in zip(
      aux["ema"].shadow, again["ema"].shadow)):
    raise AssertionError(f"17e: the VDM auxiliary state came back as {differ}")
  with torch.no_grad():
    gamma_fn = get_gamma_fn(aux["model"].gamma, aux["model"].schedule)
  out["vdm"] = {"eval": other_eval("17e vdm", cfg, BATCH,
                                   gamma_fn=gamma_fn),
                "aux_restored_bit_for_bit": True}
  out["tiny"]["vdm"] = other_tiny("vdm", gamma=True)
  stamp("17e", t0)
  out["seconds"] = time.perf_counter() - start
  out["seconds_by_part"] = seconds
  log(f"phase 17 took {out['seconds']:.1f} s")
  return out


def other_nets_per_eval(on):
  """The kernels' graph_ms and bounds summed over each phase-17 net's
  evaluation (the backwards' over a training step's calls)."""
  return {net: parts["eval"]["per_eval"] for net, parts in on.items()
          if isinstance(parts, dict) and "per_eval" in parts.get("eval", {})}


def other_nets_launches(on, name):
  """A kernel's launches on each of phase 17's paths: a step ("_step"), an
  evaluation or a round."""
  out = {}
  for net, parts in on.items():
    if net in ("tiny", "seconds", "seconds_by_part"):
      continue
    for part, row in parts.items():
      if isinstance(row, dict) and "launches_per_step" in row:
        out[f"{net}:{part}_step"] = row["launches_per_step"][name]
      elif isinstance(row, dict) and "launches" in row:
        out[f"{net}:{part}"] = row["launches"][name]
  return out

def main():
  if not torch.cuda.is_available():
    print("chip_smoke: no CUDA card; nothing was run", file=sys.stderr)
    return 2
  sys.path.insert(0, REPO)
  try:
    import indm_torch  # noqa: F401
  except ImportError:
    print("chip_smoke: run it from the root of a checkout (indm_torch is "
          "missing)", file=sys.stderr)
    return 2
  from indm_torch import run_lib
  start = time.perf_counter()

  def stamp(what):
    log(f"-- {what}: done at {time.perf_counter() - start:.1f} s")

  try:
    smi, chain_convs = phase_card_and_build()
    cfg = smoke_config()
    run_lib.set_f32_numerics()
    log(f"tf32: cudnn.allow_tf32={torch.backends.cudnn.allow_tf32} "
        f"cuda.matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32}")
    from indm_torch.models.registry import create_model
    model = create_model(cfg, seed=cfg.seed, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(2)
    x = torch.randn(BATCH, 3, 32, 32, device="cuda", generator=gen)
    t = torch.full((BATCH,), 0.3, device="cuda")
    per_eval, max_err, gn_shapes, _ = phase_group_norm(model, x, t * 999)
    vp_eval_ms, vp_profile = phase_score(cfg, model, x, t)
    del model
    torch.cuda.empty_cache()
    res, launches = phase_sample(cfg, os.path.join(REPO, "build",
                                                   "chip_smoke"))
    phase_small_reference(cfg)
    stamp("VP sampling phases 2-5")
    ve_cfg = ve_config()
    fir_per_eval, fir_err, ve_eval_ms, ve_profile, _ = phase_ve_score(
        ve_cfg)
    torch.cuda.empty_cache()
    ve_round, ve_launches = phase_ve_sample(
        ve_cfg, os.path.join(REPO, "build", "chip_smoke_ve"))
    phase_ve_small_reference(ve_cfg)
    torch.cuda.empty_cache()
    stamp("VE sampling phases 5b-5e")
    per_term, chain_err, term_split = phase_chain()
    chain8_fits, chain8_err, term_split8 = phase_fused_chain()
    per_term16, chain16_err, term_split16 = phase_chain_bf16()
    chain8_16_fits, chain8_16_err = phase_fused_chain_bf16()
    narrow, narrow_launches, narrow_err = phase_narrow_conv()
    gemm_by_shape, gemm, gemm_err, gemm_launches = phase_gemm()
    wgmma_by_shape, wgmma, wgmma_err, wgmma_launches, chain_products = (
        phase_wgmma())
    bf16_by_shape, bf16_gemm, bf16_gemm_err, bf16_gemm_launches = (
        phase_gemm_bf16())
    gn_bwd, gn_bwd_err, _ = phase_group_norm_backward(gn_shapes)
    fused_fits, fused_err, fused_split = phase_fused()
    fused16_fits, fused16_err, fused16_split = phase_fused_bf16()
    stack, stack_err, stack_split = phase_fused_stack()
    stack16, stack16_err, stack16_split = phase_fused_stack_bf16()
    stamp("kernel phases 6-9b, 6d-6g")
    # 9, 9c, 10b and 10c unprofiled: depth cuts that make room for phases
    # 15 and 16
    with chain_switch(None):
      train, train_launches, chain = phase_train(PER_STEP, per_term=per_term,
                                                 profile=False)
    with chain_switch("1"):
      train_chain8, chain8_launches, chain8 = phase_train(
          PER_STEP_CHAIN8, chain8_fits=chain8_fits, profile=False)
    with stack_switch("0"):
      train_fused, fused_launches, fused = phase_train(
          PER_STEP_FUSED, FUSED_TRAIN, fused_fits=fused_fits)
    with stack_switch(None):
      train_stack, stack_launches, _ = phase_train(PER_STEP_STACK,
                                                   FUSED_TRAIN, profile=False)
    check_stack_losses(train_stack, train_fused)
    stamp("training phases 9-10b")
    with stack_switch(None):
      train_bench, bench_launches, bench = phase_train(
          PER_STEP_BENCH, BENCH_TRAIN, fused_fits=fused16_fits,
          profile=False)
    log(f"the slice (bench.py's flags) against the float32 fused step of "
        f"phase 10b in this run: seconds/step "
        f"{train_bench['seconds_per_step']:.4f} vs "
        f"{train_stack['seconds_per_step']:.4f}, images/s "
        f"{train_bench['images_per_s']:.3f} vs "
        f"{train_stack['images_per_s']:.3f}, peak memory GB "
        f"{train_bench['peak_memory_gb']:.3f} vs "
        f"{train_stack['peak_memory_gb']:.3f}")
    stamp("the bfloat16 fused training phase 10c")
    # unprofiled (a depth cut that makes room for phase 14)
    with chain_switch(None):
      train_c16, c16_launches, c16 = phase_train(
          PER_STEP_CHAIN_BF16, CHAIN_BF16_TRAIN, per_term=per_term16,
          profile=False)
    with chain_switch("1"):
      train_c8_16, c8_16_launches, c8_16 = phase_train(
          PER_STEP_CHAIN8_BF16, CHAIN_BF16_TRAIN, chain8_fits=chain8_16_fits,
          profile=False)
    for name, t16, t32 in (("chain route", train_c16, train),
                           ("INDM_FUSED_CHAIN=1", train_c8_16, train_chain8)):
      log(f"the slice, the {name} in bfloat16 (bench.py's chain-route flags) "
          f"against the float32 {name} of phase 9 in this run: seconds/step "
          f"{t16['seconds_per_step']:.4f} vs {t32['seconds_per_step']:.4f}, "
          f"images/s {t16['images_per_s']:.3f} vs {t32['images_per_s']:.3f}, "
          f"peak memory GB {t16['peak_memory_gb']:.3f} vs "
          f"{t32['peak_memory_gb']:.3f}")
    stamp("the slice's training phase 10d")
    with chain_switch(None):
      phase_small_train(cfg, {}, (4, 0, 0, 0, 0, 0))
      phase_small_train(cfg, CHAIN_BF16_SMALL, (0, 0, 0, 0, 4, 0),
                        f32_twin=CHAIN_BF16_SMALL_F32,
                        gap_share=CHAIN_STEP_GAP_SHARE)
    with chain_switch("1"):
      phase_small_train(cfg, CHAIN8_SMALL, (0, 0, 0, 4, 0, 0))
      phase_small_train(cfg, CHAIN_BF16_SMALL, (0, 0, 0, 0, 0, 4),
                        f32_twin=CHAIN_BF16_SMALL_F32,
                        gap_share=CHAIN_STEP_GAP_SHARE)
    with stack_switch("0"):
      phase_small_train(cfg, FUSED_SMALL, (0, 4, 0, 0, 0, 0))
    with stack_switch(None):
      phase_small_train(cfg, STACK_SMALL, (0, 1, 2, 0, 0, 0))
      phase_small_train(cfg, BENCH_SMALL, (0, 1, 2, 0, 0, 0),
                        f32_twin=BENCH_SMALL_F32)
    stamp("training references 11")
    ckpt_cfg, ckpt = phase_checkpoint_train()
    ev = {"checkpoint": ckpt, **phase_checkpoint_eval(ckpt_cfg),
          "small": phase_checkpoint_small(cfg)}
    stamp("checkpoints and bits/dim 11b")
    fid_cfg = fid_config()
    fid = {"train": phase_fid_steps(fid_cfg),
           "small": phase_fid_small(fid_cfg),
           "inception": phase_inception(res["paths"]["after"]),
           "eval": phase_fid_eval(fid_cfg)}
    stamp("the FID variant 11c")
    ve_tcfg = ve_train_config()
    write_cifar10(VE_DATA_DIR)
    fir_bwd, fir_bwd_err, fir_bwd_shapes = phase_fir_backward(ve_tcfg)
    ve_train = phase_ve_train(ve_tcfg)
    with chain_switch(None):
      phase_small_train(ve_cfg, VE_SMALL, (4, 0, 0, 0, 0, 0),
                        fir_both_ways=True)
    ve_train["main"] = phase_ve_main()
    ve_train["fir_bwd_by_shape"] = fir_bwd_shapes
    stamp("VE training 12a-12c")
    celeba = phase_celeba(chain_convs)
    stamp("CelebA 13a-13e")
    bench_flags = phase_bench(chain_convs)
    stamp("bench.py's flags on the VE and CelebA configs 14a-14e")
    score_side = phase_score_side(cfg)
    stamp("the score side 15a-15e")
    flow_side = phase_flow_side(cfg)
    stamp("the flow side 16a-16e")
    other_nets = phase_other_nets()
    stamp("the other score nets 17a-17e")
  except Exception:  # any phase failure ends the run without a result
    traceback.print_exc()
    return 1
  steps = (f"{PER_STEP_FUSED['fused_block_fwd']} calls of one training step "
           f"at batch {TRAIN_BATCH} (flow.fused_block, INDM_FUSED_STACK=0), "
           f"n as drawn in its {TRAIN_STEPS} steps, from each (scale, "
           f"pre-activated) block's times at n = {min(CHAIN_NS)} and "
           f"{max(CHAIN_NS)} in isolated calls; profile_pair_ms: the device "
           "time of both kernels in the profiled fused step; "
           "chain_route_ms: the chain route for the same "
           "blocks (chain kernel and one VJP; recompute and double "
           "backward); block_route_ms: the fused route of IResBlock "
           "(normalisation and h-projection included)")
  pair_ms = (train_fused["profile"] or {}).get("fused_ms")
  stack_route_ms = (train_stack.get("profile") or {}).get("fused_ms")
  stack_per = (f"one training step's {PER_STEP_STACK['fused_stack_fwd']} "
               f"calls at batch {TRAIN_BATCH}: the stacks of "
               f"{' and '.join(str(nb) for nb, _, _ in STACK_SCALES)} "
               "blocks at full width, n from a seeded Poisson(2), timed "
               "around the whole call; launches from the "
               f"{TRAIN_STEPS} steps of the default fused route; fn_ms: "
               "the same calls through FusedStackFn; looped_pair_ms: "
               "kernels 3 and 4 looped through FusedBlockFn over the same "
               "blocks (no single PyTorch call computes either); "
               "profile_fused_ms: the device time of all fused kernels "
               "(the stacks and the first block's pair) in the profiled "
               "step of that route; term_split_ms (the forward): per "
               f"stack, one call's {WGMMA_KERNEL} launches and a chain "
               "term's device ms by launch")
  routes = (("chain", train, train_launches),
            ("chain8", train_chain8, chain8_launches),
            ("fused_pair", train_fused, fused_launches),
            ("fused_stack", train_stack, stack_launches),
            ("bench_bf16", train_bench, bench_launches),
            ("chain_bf16", train_c16, c16_launches),
            ("chain8_bf16", train_c8_16, c8_16_launches))

  def gemm_launch_views(name, tag):
    """A GEMM's launches in each route's steps (the libraries' counts),
    what the profiler saw of them and their device time in each profiled
    step."""
    return {
        "launches_by_route": {r: c[name] for r, _, c in routes},
        "profiler_launches_per_step": {
            r: (t.get("profile") or {}).get(f"{tag}_launches")
            for r, t, _ in routes},
        "profile_ms_per_step": {
            r: (t.get("profile") or {}).get(f"{tag}_ms")
            for r, t, _ in routes}}

  kernels = [{
      "name": "group_norm_fwd", "route": "cuda",
      "source": "indm_torch/csrc/group_norm.cu",
      "replaces": "indm_tpu/ops/group_norm_pallas.py:151",
      "launches": launches, "max_abs_err": max_err,
      "ms": per_eval["ms"], "plain_ms": per_eval["plain_ms"],
      "bound_ms": per_eval["bound_ms"], "bound_by": "bytes",
      "library_ms": per_eval["library_ms"],
      **device_and_host(per_eval),
      "profile_ms_per_eval": {
          "vp": (vp_profile or {}).get("group_norm_fwd_ms"),
          "ve": (ve_profile or {}).get("group_norm_fwd_ms")},
      "launches_train": train_launches["group_norm_fwd"],
      "launches_flow_side": flow_side_launches(flow_side, "group_norm_fwd"),
      "launches_eval_nll": ev["nll_correct"]["launches"]["group_norm_fwd"],
      "launches_fid_step": fid["train"]["launches_per_step"][
          "group_norm_fwd"],
      "celeba": celeba_row(celeba, "group_norm_fwd"),
      "launches_other_nets": other_nets_launches(other_nets,
                                                "group_norm_fwd"),
      "other_nets_per_eval": other_nets_per_eval(other_nets),
      "launches_score_side": {
          "pc_rounds": {r["what"]: r["group_norm_fwd"]
                        for r in score_side["pc_full"]},
          "ve_cli": {k: v["launches"]["group_norm_fwd"]
                     for k, v in score_side["ve_cli"].items()},
          "score_only_steps": {k: v["launches"]["group_norm_fwd"]
                               for k, v in score_side["score_only"].items()}},
      "per": f"the {GN_PER_SCORE_EVAL} float32 launches of one score "
             f"evaluation at batch {BATCH}; launches from the round, "
             f"launches_train from the {TRAIN_STEPS} training steps; "
             f"{SPLIT_TIMES}; profile_ms_per_eval: the kernel's device ms "
             "in one profiled VP and VE score evaluation"}, {
      "name": "group_norm_bwd", "route": "cuda",
      "source": "indm_torch/csrc/group_norm.cu",
      "replaces": "indm_tpu/ops/group_norm_pallas.py:176",
      "launches": train_launches["group_norm_bwd"],
      "max_abs_err": gn_bwd_err, "ms": gn_bwd["ms"],
      "plain_ms": gn_bwd["plain_ms"], "bound_ms": gn_bwd["bound_ms"],
      "bound_by": "bytes", "library_ms": gn_bwd["library_ms"],
      **device_and_host(gn_bwd),
      "profile_ms_per_step": (train.get("profile") or {}).get(
          "group_norm_bwd_ms"),
      "launches_eval_nll": ev["nll_correct"]["launches"]["group_norm_bwd"],
      "launches_flow_side": flow_side_launches(flow_side, "group_norm_bwd"),
      "launches_other_nets": other_nets_launches(other_nets,
                                                "group_norm_bwd"),
      "launches_fid_step": fid["train"]["launches_per_step"][
          "group_norm_bwd"],
      "celeba": celeba_row(celeba, "group_norm_bwd"),
      "launches_score_side": {
          "score_only_steps": {k: v["launches"]["group_norm_bwd"]
                               for k, v in score_side["score_only"].items()}},
      "per": f"the {PER_STEP['group_norm_bwd']} float32 launches of one "
             f"training step at batch {TRAIN_BATCH}; {SPLIT_TIMES} (the "
             "library's aten backward calls); profile_ms_per_step: the "
             "kernel pair's device ms in the chain route's profiled "
             "step"}, {
      "name": "neumann_chain", "route": "cuda",
      "source": "indm_torch/csrc/neumann_chain.cu",
      "replaces": "indm_tpu/ops/neumann_pallas.py:176",
      "launches": train_launches["neumann_chain"],
      "launches_fid_step": fid["train"]["launches_per_step"]["neumann_chain"],
      "launches_flow_side": flow_side_launches(flow_side, "neumann_chain"),
      "cifar_squeezed": flow_side["squeeze"]["chain"],
      "max_abs_err": chain_err, "ms": chain["chain_ms"],
      "plain_ms": chain["chain_plain_ms"],
      "bound_ms": chain["chain_bound_ms"], "bound_by": "operations",
      "simt_bound_ms": chain["chain_simt_bound_ms"],
      "library_ms": chain["chain_library_ms"],
      "term_split_ms": {f"scale{k}": v for k, v in term_split.items()},
      "celeba": {**celeba["chain"],
                 "launches_train": celeba["train_launches"]["neumann_chain"],
                 "launches_fid_step": celeba["fid_step"][
                     "launches_per_step"]["neumann_chain"],
                 "per_step": {k: v for k, v in celeba["train_kernel_ms"]
                              .items() if k.startswith("chain_")}},
      "per": f"the {PER_STEP['neumann_chain']} calls of one training step "
             f"at batch {TRAIN_BATCH}, n as drawn in the {TRAIN_STEPS} "
             "steps, from the per-term times of the n = 6 calls; "
             "library_ms: the same series through F.conv2d; "
             "term_split_ms: per scale, the device time of each "
             f"launch of a term (conv_in, {WGMMA_KERNEL}, conv_out; n = "
             f"{SPLIT_N}, pre-activated; method: how it was timed)"}, {
      "name": "fused_block_fwd", "route": "cuda",
      "source": "indm_torch/csrc/fused_block.cu",
      "replaces": "indm_tpu/ops/fused_block.py:280",
      "launches": fused_launches["fused_block_fwd"],
      "launches_flow_side": flow_side_launches(flow_side, "fused_block_fwd"),
      "max_abs_err": fused_err["fwd"], "ms": fused["fwd"],
      "plain_ms": fused["fwd_plain"], "bound_ms": fused["fwd_bound"],
      "bound_by": "operations", "simt_bound_ms": fused["fwd_simt_bound"],
      "library_ms": None,
      "chain_route_ms": fused["chain_route_fwd"],
      "block_route_ms": fused["block_fwd"], "profile_pair_ms": pair_ms,
      "term_split_ms": fused_split,
      "per": f"the {steps}; term_split_ms: per scale, one call's "
             f"{WGMMA_KERNEL} launches and a chain term's device ms by "
             f"launch (pre-activated, n = {SPLIT_N})"}, {
      "name": "fused_block_bwd", "route": "cuda",
      "source": "indm_torch/csrc/fused_block.cu",
      "replaces": "indm_tpu/ops/fused_block.py:467",
      "launches": fused_launches["fused_block_bwd"],
      "launches_flow_side": flow_side_launches(flow_side, "fused_block_bwd"),
      "max_abs_err": fused_err["bwd"], "ms": fused["bwd"],
      "plain_ms": fused["bwd_plain"], "bound_ms": fused["bwd_bound"],
      "bound_by": "operations", "simt_bound_ms": fused["bwd_simt_bound"],
      "library_ms": None,
      "chain_route_ms": fused["chain_route_bwd"],
      "block_route_ms": fused["block_bwd"], "profile_pair_ms": pair_ms,
      "per": f"the {steps}"}] + [{
      "name": f"fused_stack_{d}", "route": "cuda",
      "source": "indm_torch/csrc/fused_stack.cu",
      "replaces": f"indm_tpu/ops/fused_stack.py:{line}",
      "launches": stack_launches[f"fused_stack_{d}"],
      "launches_flow_side": flow_side_launches(flow_side,
                                               f"fused_stack_{d}"),
      "max_abs_err": stack_err[d], "ms": stack[d],
      "plain_ms": stack[f"{d}_plain"], "bound_ms": stack[f"{d}_bound"],
      "bound_by": "operations", "simt_bound_ms": stack[f"{d}_simt_bound"],
      "library_ms": None,
      "fn_ms": stack[f"fn_{d}"], "looped_pair_ms": stack[f"pair_{d}"],
      "profile_fused_ms": stack_route_ms, "per": stack_per,
      **({"term_split_ms": stack_split} if d == "fwd" else {})}
      for d, line in (("fwd", 153), ("bwd", 340))] + [{
      "name": "upfirdn2d", "route": "cuda",
      "source": "indm_torch/csrc/upfirdn2d.cu",
      "replaces": "indm_tpu/ops/upfirdn2d_pallas.py:116",
      "launches": ve_launches["upfirdn2d"], "max_abs_err": fir_err,
      "ms": fir_per_eval["ms"], "plain_ms": fir_per_eval["plain_ms"],
      "bound_ms": fir_per_eval["bound_ms"], "bound_by": "bytes",
      "library_ms": fir_per_eval["library_ms"],
      **device_and_host(fir_per_eval),
      "profile_ms_per_eval": (ve_profile or {}).get("upfirdn2d_ms"),
      "launches_ve_train": ve_train["launches"]["upfirdn2d"],
      "launches_other_nets": other_nets_launches(other_nets, "upfirdn2d"),
      "celeba": celeba_row(celeba, "upfirdn2d"),
      "launches_score_side": {
          "ve_cli": {k: v["launches"]["upfirdn2d"]
                     for k, v in score_side["ve_cli"].items()},
          "score_only_ve_step": score_side["score_only"]["ve"]["launches"][
              "upfirdn2d"]},
      "per": f"the {VE_FIR_PER_EVAL} float32 launches of one VE score "
             f"evaluation at batch {BATCH}; launches from the VE PC round "
             f"of {ve_round['num_scales']} scales, launches_ve_train from "
             f"the {TRAIN_STEPS} VE training steps of phase 12b; "
             "library_ms: one grouped "
             "F.conv2d (F.conv_transpose2d for up = 2) per launch; "
             f"{SPLIT_TIMES}; profile_ms_per_eval: the kernel's device ms "
             "in one profiled VE score evaluation"}, {
      "name": "upfirdn2d_bwd", "route": "cuda",
      "source": "indm_torch/csrc/upfirdn2d.cu",
      "replaces": "indm_tpu/ops/upfirdn2d_pallas.py:116",
      "launches": ve_train["launches"]["upfirdn2d_bwd"],
      "max_abs_err": fir_bwd_err, "ms": fir_bwd["ms"],
      "plain_ms": fir_bwd["plain_ms"], "bound_ms": fir_bwd["bound_ms"],
      "bound_by": "bytes", "library_ms": fir_bwd["library_ms"],
      **device_and_host(fir_bwd),
      "celeba": celeba_row(celeba, "upfirdn2d_bwd"),
      "launches_other_nets": other_nets_launches(other_nets,
                                                "upfirdn2d_bwd"),
      "launches_score_side": {
          "score_only_ve_step": score_side["score_only"]["ve"]["launches"][
              "upfirdn2d_bwd"]},
      "per": f"kernel 9 on the adjoint (Upfirdn2dFn's backward: the taps "
             f"flipped, up and down swapped, the adjoint pads): the "
             f"{VE_FIR_PER_EVAL} float32 launches of one VE training step "
             f"at batch {TRAIN_BATCH}; launches from the {TRAIN_STEPS} steps "
             "of phase 12b; max_abs_err against autograd of the plain "
             "version on float64 inputs; plain_ms: autograd of the plain "
             "version in float32; library_ms: aten's convolution_backward "
             "of row 9's grouped F.conv2d (F.conv_transpose2d for up = 2), "
             f"the call autograd makes; {SPLIT_TIMES}"}, {
      "name": "fused_neumann_chain", "route": "cuda",
      "source": "indm_torch/csrc/fused_chain.cu",
      "replaces": "indm_tpu/ops/neumann_pallas.py:338",
      "launches": chain8_launches["fused_neumann_chain"],
      "max_abs_err": chain8_err, "ms": chain8["chain8_ms"],
      "plain_ms": chain8["chain8_plain_ms"],
      "bound_ms": chain8["chain8_bound_ms"], "bound_by": "operations",
      "simt_bound_ms": chain8["chain8_simt_bound_ms"], "library_ms": None,
      "chain_mats_k7_ms": chain8["chain8_chain_mats_k7_ms"],
      "block_ms": chain8["chain8_block_ms"],
      "profile_ms": (train_chain8.get("profile") or {}).get(
          "fused_neumann_chain_ms"),
      "term_split_ms": {f"scale{k}": v for k, v in term_split8.items()},
      "per": f"the {PER_STEP_CHAIN8['fused_neumann_chain']} calls of one "
             f"training step at batch {TRAIN_BATCH} (INDM_FUSED_CHAIN=1), "
             f"n as drawn in its {TRAIN_STEPS} steps, from each (scale, "
             f"pre-activated) block's times with hp at n = {min(CHAIN_NS)} "
             f"and {max(CHAIN_NS)} in isolated calls; launches from those "
             "steps; no single PyTorch call computes it; chain_mats_k7_ms: "
             "the route it replaces on the same IResBlock (chain_mats, "
             "then kernel 7); block_ms: kernel 8 on that block with its "
             "weights packed in the call (fused_chain_inputs); profile_ms: "
             "its device time in the profiled step; term_split_ms: per "
             "scale, a chain term's device ms by launch (n = "
             f"{SPLIT_N}, pre-activated, hp; all: the whole call)"}, {
      "name": "narrow_conv", "route": "cuda",
      "source": "indm_torch/csrc/narrow_conv.cu",
      "replaces": "scripts/bench_narrow_conv.py:39",
      "launches": narrow_launches["bfloat16"], "max_abs_err": narrow_err,
      **{k: sum(narrow["bfloat16"][kind][k] for kind in narrow["bfloat16"])
         for k in ("ms", "plain_ms", "bound_ms", "library_ms")},
      "bound_by": "+".join(sorted({k["bound_by"] for k in
                                   narrow["bfloat16"].values()})),
      "by_kind": narrow,
      "launches_float32": narrow_launches["float32"],
      "per": f"one call of each kind (narrow_in 3->{CHAIN_WIDTH}, "
             f"narrow_out {CHAIN_WIDTH}->3) at [{TRAIN_BATCH}, 32, 32] in "
             "bfloat16, as `python -m indm_torch.scripts.bench_narrow_conv` "
             "runs them (100 calls after 3, CUDA events); launches from "
             "that run; library_ms: F.conv2d; by_kind: each kind in "
             "bfloat16 and float32"}, {
      "name": "lipnet_gemm", "route": "cuda",
      "source": "indm_torch/csrc/lipnet_gemm.cu",
      "replaces": "indm_tpu/ops/neumann_pallas.py:74",
      "launches": stack_launches[GEMM_KERNELS["gemm_3xtf32"]],
      "max_abs_err": gemm_err, **gemm,
      "bound_by": "+".join(sorted({t["bound_by"] for t in
                                   gemm_by_shape.values()})),
      "by_shape": gemm_by_shape, "launches_timed": gemm_launches,
      **gemm_launch_views(GEMM_KERNELS["gemm_3xtf32"], "gemm"),
      "per": "the Lipschitz net's GEMM alone (lipnet::gemm_3xtf32_kernel, "
             "the device code of the in-kernel products of the float32 "
             "backwards, kernels 4 and 6: `_apply_packed(kind=\"mat\")` at "
             "neumann_pallas.py:74 "
             "and `_wgrad` at fused_block.py:165) through its own entry "
             f"point, one call at each of the main path's {len(GEMM_SHAPES)} "
             f"products at batch {TRAIN_BATCH}, summed (by_shape: each); "
             f"launches: its launches in the {TRAIN_STEPS} steps of the "
             "default fused route (the backwards'), counted by the "
             "libraries where they launch it; launches_by_route: the same "
             "in each route; launches_timed: the timed calls of phase 6d; "
             "profiler_launches_per_step: what the profiler saw in each "
             "route's profiled step; library_ms: one float32 torch.bmm "
             "over the pairs joined along K (TF32 off); plain_ms: the "
             "plain version (torch.matmul per pair)"}, {
      "name": "lipnet_wgmma", "route": "cuda",
      "source": "indm_torch/csrc/lipnet_wgmma.cuh",
      "replaces": "indm_tpu/ops/neumann_pallas.py:74",
      "launches": stack_launches[WGMMA_KERNEL],
      "max_abs_err": wgmma_err, **wgmma,
      "bound_by": "+".join(sorted({t["bound_by"] for t in
                                   wgmma_by_shape.values()})),
      "by_shape": wgmma_by_shape, "launches_timed": wgmma_launches,
      **gemm_launch_views(WGMMA_KERNEL, "wgmma"),
      "chain_product_err": chain_products,
      "per": "the float32 GEMM of a weight fixed for the call alone "
             "(lipnet::wgmma_3xtf32_kernel, the device code of the "
             "in-kernel products of kernels 3, 5, 7 and 8, "
             "`_apply_packed(kind=\"mat\")` at neumann_pallas.py:74: 3xTF32 "
             "wgmma with the activations as the register operand, the "
             "weight split once a call) through its own entry point "
             "(lipnet_gemm.cu's indm_lipnet_wgmma), one call at each of "
             f"its {len(WGMMA_SHAPES)} products at batch {TRAIN_BATCH}, "
             "summed (by_shape: each); launches: its launches in the "
             f"{TRAIN_STEPS} steps of the default fused route (the "
             "forwards'), counted by the libraries where they launch it; "
             "launches_by_route, launches_timed, profiler_launches_per_step "
             "as for lipnet_gemm; profile_ms_per_step: its device time in "
             "each route's profiled step; mma_ms: gemm_3xtf32_kernel on "
             "the same inputs; library_ms: one float32 torch.bmm (TF32 "
             "off); plain_ms: the plain version (torch.matmul); "
             "chain_product_err: the chain's product W1^T t1 against "
             "float64 at each scale"}] + [{
      "name": f"fused_block_{d}_bf16", "route": "cuda",
      "source": "indm_torch/csrc/fused_block.cu",
      "replaces": f"indm_tpu/ops/fused_block.py:{line}",
      "launches": bench_launches[f"fused_block_{d}"],
      "max_abs_err": fused16_err[d], "ms": bench[d],
      "plain_ms": bench[f"{d}_plain"], "bound_ms": bench[f"{d}_bound"],
      "bound_by": "operations", "library_ms": None, "f32_ms": fused[d],
      **({"term_split_ms": fused16_split} if d == "fwd" else {}),
      "per": f"kernel {3 if d == 'fwd' else 4} in bfloat16: the "
             f"{PER_STEP_FUSED['fused_block_fwd']} calls of one training "
             f"step at batch {TRAIN_BATCH} as the float32 row counts them "
             "(every block through the pair), n as drawn in the slice's "
             f"{TRAIN_STEPS} steps (the same draws), from each (scale, "
             "pre-activated) block's bfloat16 times at n = "
             f"{min(CHAIN_NS)} and {max(CHAIN_NS)}; f32_ms: the float32 "
             "row's ms in this run; launches: the slice's steps (the "
             "flow's first block); bound_ms: all the work as one "
             "bfloat16 pass at the dense rate"}
      for d, line in (("fwd", 280), ("bwd", 467))] + [{
      "name": f"fused_stack_{d}_bf16", "route": "cuda",
      "source": "indm_torch/csrc/fused_stack.cu",
      "replaces": f"indm_tpu/ops/fused_stack.py:{line}",
      "launches": bench_launches[f"fused_stack_{d}"],
      "max_abs_err": stack16_err[d], "ms": stack16[d],
      "plain_ms": stack16[f"{d}_plain"], "bound_ms": stack16[f"{d}_bound"],
      "bound_by": "operations", "library_ms": None, "f32_ms": stack[d],
      **({"term_split_ms": stack16_split} if d == "fwd" else {}),
      "per": f"kernel {5 if d == 'fwd' else 6} in bfloat16: one training "
             f"step's {PER_STEP_STACK['fused_stack_fwd']} calls at batch "
             f"{TRAIN_BATCH} (phase 9b's stacks, inputs and draws); f32_ms: "
             "the float32 row's ms in this run; launches: the slice's "
             f"{TRAIN_STEPS} steps"}
      for d, line in (("fwd", 153), ("bwd", 340))] + [{
      "name": "lipnet_gemm_bf16", "route": "cuda",
      "source": "indm_torch/csrc/lipnet_wgmma_bf16.cuh",
      "replaces": "indm_tpu/ops/neumann_pallas.py:74",
      "launches": bench_launches[GEMM_BF16_KERNEL],
      "max_abs_err": bf16_gemm_err, **bf16_gemm,
      "bound_by": "+".join(sorted({t["bound_by"] for t in
                                   bf16_by_shape.values()})),
      "by_shape": bf16_by_shape, "launches_timed": bf16_gemm_launches,
      **gemm_launch_views(GEMM_BF16_KERNEL, "gemm_bf16"),
      "per": "the bfloat16 mode's GEMM alone (lipnet::wgmma_bf16_kernel, "
             "the device code of every 512-wide product of kernels 3-8 in "
             "bfloat16: `_apply_packed(kind=\"mat\")` and `_wgrad` on "
             "bfloat16 operands) through its own entry point "
             "(lipnet_gemm.cu's indm_lipnet_gemm_bf16), one call at each "
             f"of its {len(BF16_GEMM_SHAPES)} products at batch "
             f"{TRAIN_BATCH}, summed (by_shape: each); launches: its "
             f"launches in the slice's {TRAIN_STEPS} steps; "
             "library_ms: one bfloat16 torch.bmm over the pairs "
             "joined along K; plain_ms: the plain version (float32 "
             "torch.matmul of the bfloat16 values)"}, {
      "name": "neumann_chain_bf16", "route": "cuda",
      "source": "indm_torch/csrc/neumann_chain.cu",
      "replaces": "indm_tpu/ops/neumann_pallas.py:176",
      "launches": c16_launches["neumann_chain_bf16"],
      "max_abs_err": chain16_err, "ms": c16["chain_ms"],
      "plain_ms": c16["chain_plain_ms"], "bound_ms": c16["chain_bound_ms"],
      "bound_by": "operations", "library_ms": c16["chain_library_ms"],
      "f32_ms": chain["chain_ms"],
      "term_split_ms": {f"scale{k}": v for k, v in term_split16.items()},
      "per": f"kernel 7 in bfloat16: the "
             f"{PER_STEP_CHAIN_BF16['neumann_chain_bf16']} calls of one "
             f"training step at batch {TRAIN_BATCH} (the chain route under "
             f"bench.py's flags), n as drawn in its {TRAIN_STEPS} steps, "
             "from the per-term times of the n = 6 calls of phase 6f; "
             "launches from those steps; f32_ms: the float32 row's ms in "
             "this run (its own steps' draws); library_ms: the same "
             "series through bfloat16 F.conv2d; bound_ms: all the work "
             "as one bfloat16 pass at the dense rate; term_split_ms: per "
             f"scale, a term's device ms by launch (n = {SPLIT_N}, "
             "pre-activated)"}, {
      "name": "fused_neumann_chain_bf16", "route": "cuda",
      "source": "indm_torch/csrc/fused_chain.cu",
      "replaces": "indm_tpu/ops/neumann_pallas.py:338",
      "launches": c8_16_launches["fused_neumann_chain_bf16"],
      "max_abs_err": chain8_16_err, "ms": c8_16["chain8_ms"],
      "plain_ms": c8_16["chain8_plain_ms"],
      "bound_ms": c8_16["chain8_bound_ms"], "bound_by": "operations",
      "library_ms": None, "f32_ms": chain8["chain8_ms"],
      "chain_mats_k7_ms": c8_16["chain8_chain_mats_k7_ms"],
      "block_ms": c8_16["chain8_block_ms"],
      "profile_ms": (train_c8_16.get("profile") or {}).get(
          "fused_neumann_chain_ms"),
      "per": f"kernel 8 in bfloat16: the "
             f"{PER_STEP_CHAIN8_BF16['fused_neumann_chain_bf16']} calls of "
             f"one training step at batch {TRAIN_BATCH} (INDM_FUSED_CHAIN=1 "
             "under bench.py's chain-route flags), n as drawn in its "
             f"{TRAIN_STEPS} steps, from each (scale, pre-activated) "
             f"block's times with hp at n = {min(CHAIN_NS)} and "
             f"{max(CHAIN_NS)} (phase 6g); launches from those steps; no "
             "single PyTorch call computes it; chain_mats_k7_ms: bfloat16 "
             "chain_mats and kernel 7 on the same IResBlock; block_ms: "
             "kernel 8 on that block with its weights packed in the call; "
             "f32_ms: the float32 row's ms in this run"}]
  attach_bench(kernels, bench_flags)
  log(json.dumps({"kernels": kernels,
                  "round": {"nfe": res["nfe"], "seconds": res["seconds"],
                            "images_per_s": res["images_per_s"],
                            "score_eval_ms": vp_eval_ms,
                            "score_eval_profile": vp_profile},
                  "ve_round": {**ve_round, "score_eval_ms": ve_eval_ms,
                               "score_eval_profile": ve_profile},
                  "train": train, "train_chain8": train_chain8,
                  "train_fused": train_fused,
                  "train_stack": train_stack,
                  "train_bench_bf16": {
                      **train_bench, "flags": BENCH_TRAIN,
                      "f32_fused_seconds_per_step":
                          train_stack["seconds_per_step"],
                      "f32_fused_images_per_s":
                          train_stack["images_per_s"]},
                  "train_chain_bf16": {**train_c16,
                                       "flags": CHAIN_BF16_TRAIN},
                  "train_chain8_bf16": {**train_c8_16,
                                        "flags": CHAIN_BF16_TRAIN},
                  "eval": ev, "fid": fid, "ve_train": ve_train,
                  "celeba": {k: celeba[k] for k in ("train", "round",
                                                    "fid_step", "main",
                                                    "seconds")},
                  "bench_flags": {"steps": bench_flags["steps"],
                                  "seconds": bench_flags["seconds"]},
                  "score_side": score_side,
                  "flow_side": {k: v for k, v in flow_side.items()
                                if k != "squeeze"},
                  "other_nets": other_nets},
                 default=str))
  log(f"chip_smoke: the whole run took {time.perf_counter() - start:.1f} s")
  log(smi)
  log(json.dumps({"ok": True, "device": {
      "platform": "gpu", "kind": torch.cuda.get_device_name(0),
      "count": torch.cuda.device_count()}}))
  return 0


if __name__ == "__main__":
  sys.exit(main())
