#!/usr/bin/env python3
"""Drive the PyTorch port of INDM on one CUDA card and check it.

  python3 chip_smoke.py

Run from the root of a checkout; it needs one card and nothing but the
checkout. Phases (any failure exits non-zero before the result lines):

1. print the card's name and power limit; build the kernels from
   `indm_torch/csrc/` (`build/kernels/`), one nvcc per source, in parallel.
2. hold the GroupNorm(+swish) kernel against its plain version at every
   distinct (shape, activation) that the full-width NCSN++ launches at
   batch 64, in float32 and bfloat16, and time it beside its bound, the
   plain version and `torch.nn.functional.group_norm` (+ `silu`).
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
   timed beside its bytes bound, the plain version and one grouped
   `F.conv2d` (`F.conv_transpose2d` for up = 2).
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
   `F.conv2d`.
6b. the fully fused chain (kernel 8) against its plain version at both
   full-width scales, pre-activated and not, with hp and without, n in
   {0, 2, 6}, timed beside its operations bound and the plain version;
   then against `chain_mats` and kernel 7 on the same `IResBlock` (h of
   width 64), the route it replaces, both timed.
6c. the narrow-channel conv (kernel 10) through its benchmark,
   `indm_torch.scripts.bench_narrow_conv` (batch 128, 3 <-> 512 at
   32x32): the script's own bfloat16 run, then float32; each kernel case
   against the plain case and `F.conv2d` (1e-2 of the largest value in
   bfloat16, 1e-4 in float32), timed beside its bytes bound.
7. the GroupNorm backward kernel against its plain version at the 13
   (shape, activation) pairs of the score net at batch 128, float32 and
   bfloat16, timed beside its bytes bound, the plain version and the
   autograd backward of `F.group_norm` (+ `F.silu`).
8. the fused iResBlock pair (forward with the chain and J^T u; analytic
   backward) against its plain versions at both full-width flow scales,
   batch 128, pre-activated and not, n in {0, 2, 6}, timed beside its
   operations bound and the plain versions; the same block through the
   chain route of `IResBlock` (chain kernel and one VJP; recompute and
   double backward) and through its fused route.
9. three joint training steps (`step_nll`) of `vp/CIFAR10/indm_nll` at full
   width and batch 128 through `indm_torch.run_lib`, with the config's own
   init and dropout: finite losses, losses = score + flow + logp, both
   nets and the encoder's BatchNorm statistics changed, launches per step
   (GroupNorm forward 95, backward 95, chain 32, fused pair 0), seconds
   per step, images/s, peak memory; then one more step under
   `torch.profiler`.
9c. the same steps with INDM_FUSED_CHAIN=1: launches per step GroupNorm
   95 and 95, fused chain 32, chain 0; kernel 8's time per step at the n
   drawn, beside its bound, its plain version and chain_mats with kernel 7.
9b. the fused-stack pair (kernels 5 and 6) against its plain versions at
   both full-width stacks (15 blocks of 3 channels at 32x32, 16 of 12 at
   16x16; batch 128, width 512, hp, n from a seeded Poisson(2)), against
   kernels 3 and 4 looped over the same blocks (the same bits), timed with
   CUDA events around the whole call beside its operations bound, the plain
   versions, the same calls through `FusedStackFn`, and kernels 3 and 4
   looped through `FusedBlockFn`.
10. the same steps with `flow.fused_block=True` and INDM_FUSED_STACK=0:
   launches per step GroupNorm 95 and 95, fused forward 32, fused backward
   32, chain 0; the profile must show no convolution of the flow's 512-wide
   layers (the double backward's weight-gradient convolutions are gone).
10b. the same with `flow.fused_block=True` and the switch unset, the
   default fused route: launches per step GroupNorm 95 and 95, fused pair
   1 and 1 (the flow's first block), stack 2 and 2, chain 0, no 512-wide
   flow convolution, and the loss means of the INDM_FUSED_STACK=0 route.
   Each training configuration also runs one step with host timers around
   the step function, the flow's forward and the flow's kernel wrappers.
11. a small-input reference for training, in four configurations (the
   chain route, the chain route with INDM_FUSED_CHAIN=1, and the two fused
   routes): one step's losses and gradients at the tiny geometry (width 64
   for kernel 8 and the fused routes, nblocks 3-2 for the stack route),
   card against CPU, same weights and noise, with each route's launches.
12. a JSON line of the ported kernels and, last, `{"ok": true, ...}`.

Sampling weights are random, drawn from the config's seed, with
`model.init_scale = 1.0`: at the VP default of 0 the last conv of each
block starts near 1e-10 and the score net is nearly a chain of skips.
Training starts from the config's own init. TF32 is off for convolutions
and matmuls (f32 numerics, as in JAX).
"""

import collections
import contextlib
import copy
import json
import math
import os
import subprocess
import sys
import time
import traceback

import torch

BATCH = 64
HBM_BYTES_PER_S = 3.35e12  # H100 SXM
F32_FLOPS = 67e12          # H100 SXM, float32 outside the tensor cores
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
# the residual input pyramid); the PC round's scales (the config's 1000);
# kernel 9 against its plain version: float32 sums of 16 taps in another
# order, 1e-5 of the output's largest value
VE_FIR_PER_EVAL = 15
VE_NUM_SCALES = 1000
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
            "fused_neumann_chain": 0, "fused_block_fwd": 0,
            "fused_block_bwd": 0, "fused_stack_fwd": 0, "fused_stack_bwd": 0}
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
# the flow's scales at full width: (channels, height = width)
CHAIN_SCALES = ((3, 32), (12, 16))
CHAIN_WIDTH = 512
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
  from indm_torch.ops import build
  t0 = time.perf_counter()
  paths = build.build_all()
  log(f"built {', '.join(os.path.relpath(p, REPO) for p in paths)} in "
      f"{time.perf_counter() - t0:.3f} s")
  return smi


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


def phase_group_norm(model, x, t):
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
  per_eval = collections.defaultdict(float)
  max_err = {torch.float32: 0.0, torch.bfloat16: 0.0}
  for (shape, groups, act), count in sorted(shapes.items()):
    c = shape[1]
    scale = 1.0 + 0.2 * torch.randn(c, device="cuda", generator=gen)
    bias = 0.2 * torch.randn(c, device="cuda", generator=gen)
    for dtype in (torch.float32, torch.bfloat16):
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

      ms = cuda_ms(lambda: gn.group_norm_act(xs, scale, bias, groups,
                                             act=act))
      plain_ms = cuda_ms(lambda: gn.group_norm_act_plain(xs, scale, bias,
                                                         groups, act=act))
      library_ms = cuda_ms(library)
      nbytes = 2 * xs.numel() * xs.element_size()
      bound_ms = max(nbytes / HBM_BYTES_PER_S,
                     OPS_PER_ELEMENT * xs.numel() / F32_FLOPS) * 1e3
      dname = str(dtype).replace("torch.", "")
      log(f"group_norm {list(shape)} groups={groups} act={act} {dname} "
          f"x{count}/eval: max_abs_err={err:.3e} ms={ms:.5f} "
          f"bound_ms={bound_ms:.5f} plain_ms={plain_ms:.5f} "
          f"library_ms={library_ms:.5f}")
      if dtype == torch.float32:
        for key, v in (("ms", ms), ("plain_ms", plain_ms),
                       ("library_ms", library_ms), ("bound_ms", bound_ms)):
          per_eval[key] += count * v
  log(f"group_norm per score evaluation (float32, {n_calls} launches): "
      + " ".join(f"{k}={v:.5f}" for k, v in per_eval.items()))
  log(f"group_norm max_abs_err float32={max_err[torch.float32]:.3e} "
      f"bfloat16={max_err[torch.bfloat16]:.3e}")
  return dict(per_eval), max_err[torch.float32], shapes


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
  profile_score_eval(score_fn, x, t)
  return kernel_eval_ms


def profile_score_eval(score_fn, x, t, top=8,
                       ours=("group_norm_fwd_kernel",)):
  """Device time of one score evaluation by kernel, and the share of the
  host's wall time (profiler on) in which the device was busy; `ours`
  names the port's kernels whose time is reported."""
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
    return
  shares = []
  for name in ours:
    ms = sum(e.self_device_time_total for e in kernels if name in e.key) / 1e3
    shares.append(f"{name} {ms:.3f} ms ({ms / busy_ms:.4f} of device time)")
  log(f"profile of one score eval: device busy {busy_ms:.3f} ms of "
      f"{wall_ms:.3f} ms wall ({busy_ms / wall_ms:.4f}); "
      + "; ".join(shares))
  for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:top]:
    log(f"  {e.self_device_time_total / 1e3:9.3f} ms  x{e.count:<4d} "
        f"{e.key[:100]}")


def phase_sample(cfg, workdir):
  from indm_torch import sample
  from indm_torch.flows.flow_model import create_flow_model, flow_forward
  from indm_torch.ops import group_norm as gn
  gn.reset_launches()
  (res,) = sample.run(cfg, workdir, batch=BATCH, rounds=1, device="cuda",
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
    if tuple(img.shape) != (BATCH, 32, 32, 3):
      raise AssertionError(f"{name}: shape {tuple(img.shape)}")
    if not torch.isfinite(img).all():
      raise AssertionError(f"{name}: non-finite values")
    inside = ((img >= 0) & (img <= 1)).float().mean().item()
    log(f"{name} flow: min={img.min().item():.4g} max={img.max().item():.4g}"
        f" share in [0,1]={inside:.4f}")
  import numpy as np
  with np.load(res["paths"]["after"]) as z:
    if z["samples"].shape != (BATCH, 32, 32, 3) or z["samples"].dtype != \
        np.uint8:
      raise AssertionError("the written round has the wrong layout")

  # the flow inverse alone, on the round's own weights and a fresh latent
  flow = create_flow_model(cfg, seed=cfg.seed + 1, device="cuda")
  z = torch.randn(BATCH, 3, 32, 32, device="cuda",
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
  full-width VE score net, timed beside its bytes bound, the plain
  version and the library call; returns the per-evaluation sums and the
  largest error."""
  from indm_torch.ops import upfirdn2d as fir
  n_calls = sum(call[-1] for call in calls)
  log(f"upfirdn2d calls per VE score evaluation: {n_calls} "
      f"({len(calls)} distinct)")
  if n_calls != VE_FIR_PER_EVAL:
    raise AssertionError(f"expected {VE_FIR_PER_EVAL} upfirdn2d calls, got "
                         f"{n_calls}")
  gen = torch.Generator(device="cuda").manual_seed(9)
  per_eval, max_err = collections.defaultdict(float), 0.0
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
    times = {"ms": cuda_ms(lambda: fir.upfirdn2d(x, k, up, down, pad)),
             "plain_ms": cuda_ms(lambda: fir.upfirdn2d_plain(x, k, up, down,
                                                             pad)),
             "library_ms": cuda_ms(library)}
    nbytes = 4 * (x.numel() + y.numel())
    times["bound_ms"] = nbytes / HBM_BYTES_PER_S * 1e3
    log(f"upfirdn2d {list(shape)} -> {list(y.shape)} up={up} down={down} "
        f"pad={pad} x{count}/eval: max_abs_err={err:.3e} (max |y| "
        f"{big:.3e}) " + " ".join(f"{k_}={v:.5f}" for k_, v in times.items())
        + f" ({times['bound_ms'] / times['ms']:.3f} of the bound)")
    for key, v in times.items():
      per_eval[key] += count * v
  log(f"upfirdn2d per VE score evaluation ({n_calls} launches): "
      + " ".join(f"{k_}={v:.5f}" for k_, v in per_eval.items()))
  return dict(per_eval), max_err


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
  per-evaluation times and largest error."""
  from indm_torch import sde as sde_lib
  from indm_torch.models.registry import create_model, get_score_fn
  from indm_torch.ops import group_norm as gn
  from indm_torch.ops import upfirdn2d as fir
  model = create_model(cfg, seed=cfg.seed, device="cuda")
  sde = sde_lib.get_sde(cfg)
  gen = torch.Generator(device="cuda").manual_seed(2)
  x = torch.randn(BATCH, 3, 32, 32, device="cuda", generator=gen)
  t = torch.full((BATCH,), 0.3, device="cuda")
  per_eval, max_err = phase_fir(fir_calls(model, x,
                                          sde.marginal_prob(x, t)[1]))
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
  profile_score_eval(score_fn, x, t, ours=("group_norm_fwd_kernel",
                                           "upfirdn2d_kernel"))
  return per_eval, max_err, kernel_eval_ms


def phase_ve_sample(cfg, workdir):
  """One full-width PC round through `indm_torch.sample.run`, with the
  evaluations counted by the kernels' launches."""
  from indm_torch import sample
  from indm_torch.ops import group_norm as gn
  from indm_torch.ops import upfirdn2d as fir
  scales = cfg.sampling.num_scales
  log(f"VE PC round: sampling.num_scales={scales} (model.num_scales="
      f"{cfg.model.num_scales}), {cfg.sampling.n_steps_each} corrector "
      f"step(s) and one predictor step per scale")
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
  if launches != {"group_norm_fwd": GN_PER_SCORE_EVAL * evals,
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
  """2 * B*H*W * (9*C*I + I*I + 9*I*C): the three transposed convs."""
  return 2 * b * hw * hw * (9 * c * width + width * width + 9 * width * c)


def fused_bwd_flops(b, c, hw, preact, width=CHAIN_WIDTH):
  """Kernel 4's operations: six applications of the net less the narrow
  3x3 convs it skips (no W2 conv in the recompute and the tangent; no
  t-stream W0^T without the pre-activation)."""
  narrow = 2 * b * hw * hw * 9 * width * c
  return (6 * chain_flops_per_term(b, c, hw, width)
          - (2 if preact else 3) * narrow)


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


def phase_chain():
  """The chain kernel against its plain version; returns per-term times
  {(scale, preact): {"ms", "plain_ms", "library_ms"}} and the largest
  error."""
  import torch.nn.functional as F
  from indm_torch.flows.resflow import OFFSET_TRAIN, RCDF_TRAIN
  from indm_torch.ops import neumann
  gen = torch.Generator(device="cuda").manual_seed(4)
  per_term, max_err = {}, 0.0
  for scale, (c, hw) in enumerate(CHAIN_SCALES):
    flops = chain_flops_per_term(TRAIN_BATCH, c, hw)
    for preact in (False, True):
      vareps, dacts, ws = chain_inputs(TRAIN_BATCH, c, hw, preact, gen)

      def library(n):
        # the same series through cuDNN, written out with F.conv2d
        acc, v = torch.zeros_like(vareps), vareps
        for coeff in neumann.chain_coeffs(n, OFFSET_TRAIN, RCDF_TRAIN):
          for i, w in enumerate(ws):
            v = F.conv2d(v, w, padding=w.shape[-1] // 2)
            if i < len(dacts):
              v = v * dacts[i]
          acc = acc + float(coeff) * v
        return acc

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
            "library_ms": cuda_ms(lambda: library(n), 3, 1)}
        bound_ms = terms * flops / F32_FLOPS * 1e3
        log(f"neumann_chain [{TRAIN_BATCH},{c},{hw},{hw}] width "
            f"{CHAIN_WIDTH} preact={preact} n={n} ({terms} terms): "
            f"max_abs_err={err:.3e} (max |acc| {big:.3e}) "
            + " ".join(f"{k}={v:.4f}" for k, v in times.items())
            + f" bound_ms={bound_ms:.4f} ({terms * flops / 1e9:.2f} GFLOP, "
            f"{terms * flops / times['ms'] / 1e9:.2f} TFLOP/s)")
        if n == max(CHAIN_NS):
          per_term[(scale, preact)] = {k: v / terms for k, v in
                                       times.items()}
      del vareps, dacts, ws
      torch.cuda.empty_cache()
  return per_term, max_err


def fused_chain_fwd_flops(b, c, hw, width=CHAIN_WIDTH):
  """Kernel 8's forward, 2 * B*H*W * (9*C*I + I*I): the first two layers."""
  return 2 * b * hw * hw * (9 * c * width + width * width)


def phase_fused_chain():
  """Kernel 8 against its plain version at both full-width scales,
  pre-activated and not, with hp and without, n in CHAIN_NS; then against
  `chain_mats` and kernel 7 on the same `IResBlock`, the route it
  replaces. Returns, per (scale, preact), times {name: (ms at n = 0, ms
  per extra n)} with hp, and the largest error."""
  from indm_torch.flows.resflow import OFFSET_TRAIN, RCDF_TRAIN, IResBlock
  from indm_torch.ops import neumann
  gen = torch.Generator(device="cuda").manual_seed(9)
  fits, max_err = {}, 0.0
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
      for hp in (d["hp"], None):
        for n in CHAIN_NS:
          args = (d["x"], d["eps"], *mats, hp, n, OFFSET_TRAIN, RCDF_TRAIN,
                  preact)
          what = (f"fused_neumann_chain [{TRAIN_BATCH},{c},{hw},{hw}] width "
                  f"{CHAIN_WIDTH} preact={preact} hp={hp is not None} n={n}")
          err = check(what, neumann.fused_neumann_chain(*args),
                      neumann.fused_neumann_chain_plain(*args))
          max_err = max(max_err, err)
          if hp is None:
            log(f"{what}: max_abs_err={err:.3e}")
            continue
          t["ms"][n] = cuda_ms(lambda: neumann.fused_neumann_chain(*args), 3,
                               1)
          t["plain_ms"][n] = cuda_ms(
              lambda: neumann.fused_neumann_chain_plain(*args), 3, 1)
          bound = (fwd_flops + (n + OFFSET_TRAIN) * flops) / F32_FLOPS * 1e3
          log(f"{what}: max_abs_err={err:.3e} ms={t['ms'][n]:.4f} "
              f"plain_ms={t['plain_ms'][n]:.4f} bound_ms={bound:.4f} "
              f"({bound / t['ms'][n]:.3f} of the bound)")
      del d, mats, args
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
  return fits, max_err


def narrow_conv_bound_ms(b, c, hw, width, dtype):
  """Kernel 10's bound at one kind: the wide operand, the narrow operand
  and the weights once over the memory rate, against 2*B*H*W*9*C*I
  operations over the rate of their type (float32 FMA; bf16 on the tensor
  cores); returns (ms, "bytes" or "operations")."""
  size = torch.finfo(dtype).bits // 8
  nbytes = (b * hw * hw * (width + c) + 9 * c * width) * size
  flops = 2 * b * hw * hw * 9 * c * width
  rate = F32_FLOPS if dtype == torch.float32 else BF16_FLOPS
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
          TRAIN_BATCH, 3, 32, CHAIN_WIDTH, dtype)
      log(f"narrow_conv {kind} {dname} [{TRAIN_BATCH}, 3 <-> "
          f"{CHAIN_WIDTH}, 32, 32]: "
          + " ".join(f"{n}={v:.5f}" if isinstance(v, float) else f"{n}={v}"
                     for n, v in k.items())
          + f" ({k['bound_ms'] / k['ms']:.3f} of the bound)")
    out[dname] = per_kind
  log(f"narrow_conv launches: {launches}")
  return out, launches, max_err


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


def phase_fused():
  """Kernels 3 and 4 against their plain versions; the chain route and the
  fused route for the same `IResBlock`. Returns, per (scale, preact),
  times {route: (ms at n = 0, ms per extra n)} and the largest errors."""
  from indm_torch.flows.resflow import OFFSET_TRAIN, RCDF_TRAIN, IResBlock
  from indm_torch.ops import fused_block as fb
  gen = torch.Generator(device="cuda").manual_seed(6)
  fits, max_err = {}, {"fwd": 0.0, "bwd": 0.0}
  n_lo, n_hi = min(CHAIN_NS), max(CHAIN_NS)
  for scale, (c, hw) in enumerate(CHAIN_SCALES):
    flops = chain_flops_per_term(TRAIN_BATCH, c, hw)
    for preact in (False, True):
      d = fused_inputs(TRAIN_BATCH, c, hw, gen)
      t = collections.defaultdict(dict)
      for n in CHAIN_NS:
        args = (d["x"], *d["ws"], *d["bs"], d["hp"], d["eps"], n,
                OFFSET_TRAIN, RCDF_TRAIN, preact)
        what = f"scale {scale} preact {preact} n={n}"
        out = fb.fused_block_fwd(*args)
        err = check_outputs(f"fused_block_fwd {what}", ("y", "logdet", "u"),
                            out, fb.fused_block_fwd_plain(*args))
        max_err["fwd"] = max(max_err["fwd"], err)
        bargs = (d["x"], d["eps"], out[2], d["ybar"], d["lbar"], *d["ws"],
                 *d["bs"][:2], d["hp"], preact)
        grads = fb.fused_block_bwd(*bargs)
        errb = check_outputs(
            f"fused_block_bwd {what}",
            ("xbar", "w0g", "w1g", "w2g", "b0g", "b1g", "b2g", "hbar"),
            grads, fb.fused_block_bwd_plain(*bargs))
        max_err["bwd"] = max(max_err["bwd"], errb)
        if not all(torch.equal(a, b) for a, b in
                   zip(grads, fb.fused_block_bwd(*bargs))):
          raise AssertionError(f"fused_block_bwd {what}: two runs differ")
        t["fwd"][n] = cuda_ms(lambda: fb.fused_block_fwd(*args), 3, 1)
        t["fwd_plain"][n] = cuda_ms(lambda: fb.fused_block_fwd_plain(*args),
                                    3, 1)
        bound = (n + OFFSET_TRAIN + 2) * flops / F32_FLOPS * 1e3
        log(f"fused_block_fwd [{TRAIN_BATCH},{c},{hw},{hw}] width "
            f"{CHAIN_WIDTH} preact={preact} n={n}: max_abs_err={err:.3e} "
            f"ms={t['fwd'][n]:.4f} plain_ms={t['fwd_plain'][n]:.4f} "
            f"bound_ms={bound:.4f} ({bound / t['fwd'][n]:.3f} of the bound); "
            f"fused_block_bwd max_abs_err={errb:.3e}")
      t["bwd"][n_lo] = t["bwd"][n_hi] = cuda_ms(
          lambda: fb.fused_block_bwd(*bargs), 3, 1)
      t["bwd_plain"][n_lo] = t["bwd_plain"][n_hi] = cuda_ms(
          lambda: fb.fused_block_bwd_plain(*bargs), 3, 1)
      bound = fused_bwd_flops(TRAIN_BATCH, c, hw, preact) / F32_FLOPS * 1e3
      log(f"fused_block_bwd [{TRAIN_BATCH},{c},{hw},{hw}] preact={preact}: "
          f"ms={t['bwd'][n_lo]:.4f} plain_ms={t['bwd_plain'][n_lo]:.4f} "
          f"bound_ms={bound:.4f} ({bound / t['bwd'][n_lo]:.3f} of the bound)")
      del d, out, grads, bargs, args
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
  return fits, max_err


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
  training step's two calls of each) and the largest errors."""
  import numpy as np
  from indm_torch.flows.resflow import LAMB, OFFSET_TRAIN, RCDF_TRAIN
  from indm_torch.ops import fused_block as fb
  from indm_torch.ops import fused_stack as fs
  gen = torch.Generator(device="cuda").manual_seed(7)
  host_rng = np.random.default_rng(7)
  total, max_err = collections.defaultdict(float), {"fwd": 0.0, "bwd": 0.0}
  grad_names = ("xbar", "w0g", "w1g", "w2g", "b0g", "b1g", "b2g", "hbar")
  for nb, c, hw in STACK_SCALES:
    blocks = [fused_inputs(TRAIN_BATCH, c, hw, gen) for _ in range(nb)]
    n_all = [int(host_rng.poisson(LAMB)) for _ in range(nb)]

    def stacked(get):
      return torch.stack([get(d) for d in blocks])

    ws = [stacked(lambda d, k=k: d["ws"][k]) for k in range(3)]
    bs = [stacked(lambda d, k=k: d["bs"][k]) for k in range(3)]
    hp_all, eps_all = stacked(lambda d: d["hp"]), stacked(lambda d: d["eps"])
    x, ybar, lbar = blocks[0]["x"], blocks[0]["ybar"], blocks[0]["lbar"]
    args = (x, *ws, *bs, hp_all, eps_all, n_all, OFFSET_TRAIN, RCDF_TRAIN,
            True)
    what = f"{nb} blocks [{TRAIN_BATCH},{c},{hw},{hw}] n={n_all}"
    out = fs.fused_stack_fwd(*args)
    err = check_outputs(f"fused_stack_fwd {what}",
                        ("y", "ld_all", "u_all", "xs_all"), out,
                        fs.fused_stack_fwd_plain(*args))
    y, ld_all, u_all, xs_all = out
    bargs = (xs_all, eps_all, u_all, ybar, lbar, *ws, *bs[:2], hp_all, True)
    grads = fs.fused_stack_bwd(*bargs)
    errb = check_outputs(f"fused_stack_bwd {what}", grad_names, grads,
                         fs.fused_stack_bwd_plain(*bargs))
    max_err["fwd"], max_err["bwd"] = (max(max_err["fwd"], err),
                                      max(max_err["bwd"], errb))
    if not all(torch.equal(a, b) for a, b in
               zip(grads, fs.fused_stack_bwd(*bargs))):
      raise AssertionError(f"fused_stack_bwd {what}: two runs differ")

    # kernels 3 and 4 looped over the same blocks: the same bits
    same, xj = [], x
    for j, d in enumerate(blocks):
      same.append(torch.equal(xs_all[j], xj))
      xj, ld, u = fb.fused_block_fwd(xj, *d["ws"], *d["bs"], d["hp"],
                                     d["eps"], n_all[j], OFFSET_TRAIN,
                                     RCDF_TRAIN, True)
      same += [torch.equal(ld_all[j], ld), torch.equal(u_all[j], u)]
    same.append(torch.equal(y, xj))
    cot = ybar
    for j in reversed(range(nb)):
      d = blocks[j]
      cot, *per_block = fb.fused_block_bwd(
          xs_all[j], d["eps"], u_all[j], cot, lbar, *d["ws"], *d["bs"][:2],
          d["hp"], True)
      same += [torch.equal(s[j], g) for s, g in zip(grads[1:], per_block)]
    same.append(torch.equal(grads[0], cot))
    if not all(same):
      raise AssertionError(f"fused stack {what}: {same.count(False)} outputs "
                           "differ from kernels 3 and 4 looped")

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
    t["fwd_bound"] = (sum(n + OFFSET_TRAIN + 2 for n in n_all) * flops
                      / F32_FLOPS * 1e3)
    t["bwd_bound"] = (nb * fused_bwd_flops(TRAIN_BATCH, c, hw, True)
                      / F32_FLOPS * 1e3)
    log(f"fused_stack {what}: max_abs_err fwd={err:.3e} bwd={errb:.3e}; "
        "the same bits as kernels 3 and 4 looped; ms "
        + " ".join(f"{k}={v:.3f}" for k, v in t.items())
        + f"; of the bound fwd {t['fwd_bound'] / t['fwd']:.3f} "
        f"bwd {t['bwd_bound'] / t['bwd']:.3f}")
    for k, v in t.items():
      total[k] += v
    del blocks, ws, bs, hp_all, eps_all, out, grads, bargs, args, xg
    torch.cuda.empty_cache()
  log("fused_stack per training step (both scales, one call each): "
      + " ".join(f"{k}={v:.3f}" for k, v in total.items()))
  return dict(total), max_err


def phase_group_norm_backward(shapes):
  """The backward kernel pair against its plain version at the score
  net's (shape, act) pairs at batch 128; returns the float32 totals over
  one training step's 95 launches and the largest float32 dx error."""
  import torch.nn.functional as F
  from indm_torch.ops import group_norm as gn
  gen = torch.Generator(device="cuda").manual_seed(5)
  per_step = collections.defaultdict(float)
  max_err = {torch.float32: 0.0, torch.bfloat16: 0.0}
  for (shape, groups, act), count in sorted(shapes.items()):
    shape = (TRAIN_BATCH,) + tuple(shape[1:])
    c = shape[1]
    scale = 1.0 + 0.2 * torch.randn(c, device="cuda", generator=gen)
    bias = 0.2 * torch.randn(c, device="cuda", generator=gen)
    for dtype in (torch.float32, torch.bfloat16):
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
      ms = cuda_ms(lambda: gn.group_norm_act_backward(*args))
      plain_ms = cuda_ms(lambda: gn.group_norm_act_backward_plain(*args))
      library_ms = cuda_ms(lambda: torch.autograd.grad(
          y, (x_, s_, b_), dy, retain_graph=True))
      del y
      bound_ms = 3 * xs.numel() * xs.element_size() / HBM_BYTES_PER_S * 1e3
      dname = str(dtype).replace("torch.", "")
      log(f"group_norm_bwd {list(shape)} groups={groups} act={act} {dname} "
          f"x{count}/step: max_abs_err dx={errs[0]:.3e} "
          f"dscale={errs[1]:.3e} dbias={errs[2]:.3e} ms={ms:.5f} "
          f"bound_ms={bound_ms:.5f} plain_ms={plain_ms:.5f} "
          f"library_ms={library_ms:.5f}")
      if dtype == torch.float32:
        for key, v in (("ms", ms), ("plain_ms", plain_ms),
                       ("library_ms", library_ms), ("bound_ms", bound_ms)):
          per_step[key] += count * v
  log("group_norm_bwd per training step (float32, "
      f"{sum(shapes.values())} launches): "
      + " ".join(f"{k}={v:.5f}" for k, v in per_step.items()))
  return dict(per_step), max_err[torch.float32]


def _snapshot(tr):
  """Copies of both nets' parameters and the encoder's running stats."""
  out = {}
  for tag, model in (("score", tr.score_model), ("flow", tr.flow_model)):
    for k, v in model.state_dict().items():
      out[f"{tag}.{k}"] = v.detach().clone()
  return out


def phase_train(per_step, overrides=None, per_term=None, fused_fits=None,
                chain8_fits=None):
  """Three full-width steps at batch 128 with `overrides` on the config,
  then one under the profiler. `per_term` (the chain's per-term times),
  `fused_fits` (the fused pair's times) or `chain8_fits` (kernel 8's)
  turn into times per step at the n drawn in the steps."""
  from indm_torch import run_lib
  from indm_torch.configs import get_config
  from indm_torch.flows.resflow import LAMB, OFFSET_TRAIN
  from indm_torch.ops import fused_block as fb
  from indm_torch.ops import fused_stack as fs
  from indm_torch.ops import group_norm as gn
  from indm_torch.ops import neumann
  cfg = get_config("vp/CIFAR10/indm_nll")
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
  channels = [c for c, _ in CHAIN_SCALES]
  kinds = [(channels.index(b.nnet[-1].weight.shape[0]), b.preact)
           for b in blocks]
  n_rng = copy.deepcopy(tr.host_rng)
  ns = [int(n_rng.poisson(LAMB)) for _ in range(len(blocks) * TRAIN_STEPS)]
  before = _snapshot(tr)
  torch.cuda.synchronize()
  torch.cuda.reset_peak_memory_stats()
  rows, launches = [], collections.Counter()
  for i in range(TRAIN_STEPS):
    for lib in (gn, neumann, fb, fs):
      lib.reset_launches()
    (row,) = run_lib.train_steps(tr, 1, log=log, first_step=i)
    counts = {"group_norm_fwd": gn.launches,
              "group_norm_bwd": gn.bwd_launches,
              "neumann_chain": neumann.launches,
              "fused_neumann_chain": neumann.fused_launches,
              "fused_block_fwd": fb.fwd_launches,
              "fused_block_bwd": fb.bwd_launches,
              "fused_stack_fwd": fs.fwd_launches,
              "fused_stack_bwd": fs.bwd_launches}
    log(f"train step {i}: launches {counts}")
    if counts != per_step:
      raise AssertionError(f"step {i} launched {counts}, expected "
                           f"{per_step}")
    launches.update(counts)
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
  secs = sorted(r["seconds"] for r in rows[1:])
  sec = secs[len(secs) // 2] if len(secs) % 2 else sum(secs) / len(secs)
  train = {"steps": TRAIN_STEPS, "batch": TRAIN_BATCH,
           "seconds_per_step": sec, "images_per_s": TRAIN_BATCH / sec,
           "peak_memory_gb": peak / 1e9,
           "step_seconds": [r["seconds"] for r in rows],
           "losses": [r["losses"] for r in rows]}
  log(f"train: seconds/step (median of steps 2-{TRAIN_STEPS}) {sec:.3f}, "
      f"images/s {TRAIN_BATCH / sec:.3f}, peak memory {peak / 1e9:.3f} GB; "
      f"{len(moved)} of {len(before)} tensors changed")

  # kernel times per step, at the n drawn
  per = collections.defaultdict(float)
  for i, n in enumerate(ns):
    scale, preact = kinds[i % len(blocks)]
    c, hw = CHAIN_SCALES[scale]
    flops = chain_flops_per_term(TRAIN_BATCH, c, hw)
    if per_term is not None:
      terms = n + OFFSET_TRAIN
      for k, v in per_term[(scale, preact)].items():
        per[f"chain_{k}"] += terms * v / TRAIN_STEPS
      per["chain_bound_ms"] += terms * flops / F32_FLOPS * 1e3 / TRAIN_STEPS
    if fused_fits is not None:
      for k, (at0, slope) in fused_fits[(scale, preact)].items():
        per[k] += (at0 + n * slope) / TRAIN_STEPS
      per["fwd_bound"] += ((n + OFFSET_TRAIN + 2) * flops / F32_FLOPS * 1e3
                           / TRAIN_STEPS)
      per["bwd_bound"] += (fused_bwd_flops(TRAIN_BATCH, c, hw, preact)
                           / F32_FLOPS * 1e3 / TRAIN_STEPS)
    if chain8_fits is not None:
      for k, (at0, slope) in chain8_fits[(scale, preact)].items():
        per[f"chain8_{k}"] += (at0 + n * slope) / TRAIN_STEPS
      per["chain8_bound_ms"] += (
          (fused_chain_fwd_flops(TRAIN_BATCH, c, hw)
           + (n + OFFSET_TRAIN) * flops) / F32_FLOPS * 1e3 / TRAIN_STEPS)
  terms = sum(ns) / TRAIN_STEPS + OFFSET_TRAIN * len(blocks)
  log(f"kernel times per training step ({len(blocks)} blocks, {terms:.1f} "
      "chain terms on average): " + " ".join(f"{k}={v:.3f}" for k, v in
                                            per.items()))
  fused = bool(cfg.flow.get("fused_block", False))
  train["profile"] = profile_train_step(
      tr, fused=fused, chain8=per_step["fused_neumann_chain"] > 0)
  train["host"] = host_profile_step(tr)
  del tr
  torch.cuda.empty_cache()
  return train, launches, dict(per)


# device kernels by the port's sources: the lipnet device code belongs to
# the chain in the chain route's configuration and to the fused kernels
# (the pair and the stacks, which share their device code) in the fused ones
FUSED_ONLY = ("fused_ops::", "transpose_stack_kernel")
KERNEL_NAMES = {"group_norm_fwd": ("group_norm_fwd_kernel",),
                "group_norm_bwd": ("group_norm_bwd_kernel",
                                   "sum_over_batch_kernel")}


def profile_train_step(tr, fused=False, chain8=False, top=12):
  """Device time of one training step by kernel, and the device's busy
  share of the host's wall time (profiler on). With `fused`, no
  convolution of the flow's 512-wide layers may run. With `chain8` the
  lipnet device code is kernel 8's (with its narrow pre-activation pass)."""
  from indm_torch import run_lib
  from torch.profiler import ProfilerActivity, profile
  with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
               record_shapes=True) as prof:
    t0 = time.perf_counter()
    run_lib.train_steps(tr, 1, log=log, first_step=TRAIN_STEPS)
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
    flow_names = {"fused_neumann_chain": ("lipnet::", "fused_ops::")}
  else:
    flow_names = {"neumann_chain": ("lipnet::",)}
  names = {**KERNEL_NAMES, **flow_names}
  for name, keys in names.items():
    out[f"{name}_ms"] = sum(e.self_device_time_total for e in kernels
                            if any(k in e.key for k in keys)) / 1e3
  log(f"profile of one training step: device busy {busy_ms:.3f} ms of "
      f"{wall_ms:.3f} ms wall ({busy_ms / wall_ms:.4f}); "
      + " ".join(f"{k}={v:.3f}" for k, v in out.items()
                 if k.endswith("_ms") and k not in ("wall_ms", "busy_ms")))
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
        tr._replace(step_fn=timed("step_fn", tr.step_fn)), 1, log=log,
        first_step=TRAIN_STEPS + 1)
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
  flow's 3 or 12 channels. The score net's weights have at most 256
  outputs (its 512-channel inputs are concatenations) and its activations
  start with the batch; the encoder is at most 96 wide."""
  narrow = [c for c, _ in CHAIN_SCALES]
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


def phase_small_train(cfg, overrides, launches):
  """One tiny step's losses and gradients, card against CPU, with
  `overrides` on the tiny config; the card's step must launch the chain,
  the fused pair, the stack pair and the fully fused chain `launches` =
  (chain, pair, stack, fused chain) times (the pairs in each
  direction)."""
  from indm_torch import joint, run_lib
  from indm_torch.flows.flow_model import FlowNoise, sample_flow_noise
  from indm_torch.ops import fused_block as fb
  from indm_torch.ops import fused_stack as fs
  from indm_torch.ops import neumann
  import numpy as np
  small = set_leaves(cfg, {**SMALL, "model.dropout": 0.0,
                           "training.batch_size": SMALL_BATCH,
                           "flow.logdet_pallas": True, **(overrides or {})})
  trs = {d: run_lib.build_training(small, device=d, seed=7)
         for d in ("cpu", "cuda")}
  batch = run_lib.next_batch(trs["cpu"])
  gen = torch.Generator().manual_seed(8)
  flow = sample_flow_noise(trs["cpu"].flow_model, batch.shape, gen,
                           np.random.default_rng(9))
  noise = joint.StepNoise(flow, torch.rand(SMALL_BATCH, generator=gen),
                          torch.randn(batch.shape, generator=gen),
                          torch.randn(batch.shape, generator=gen))
  sde = trs["cpu"].sde
  t, weight = sde.get_diffusion_time(SMALL_BATCH, sde.get_t_min(device="cpu"),
                                     True, u=noise.u_t)
  out = {}
  for d, tr in trs.items():
    tr.sde.get_diffusion_time = (
        lambda t, w: lambda *args, **kwargs: (t, w))(t.to(d), weight.to(d))
    nd = joint.StepNoise(
        FlowNoise(noise.flow.enc_eps.to(d),
                  [(v.to(d), n) for v, n in noise.flow.blocks]),
        noise.u_t.to(d), noise.z.to(d), noise.logp_z.to(d))
    losses = joint.make_joint_losses(small, tr.sde, tr.score_model,
                                     tr.flow_model)
    for lib in (neumann, fb, fs):
      lib.reset_launches()
    aux = losses(batch.to(d), nd)
    aux["losses"].mean().backward()
    if d == "cuda":
      chain, pair, stack, chain8 = launches
      counts = (neumann.launches, fb.fwd_launches, fb.bwd_launches,
                fs.fwd_launches, fs.bwd_launches, neumann.fused_launches)
      if counts != (chain, pair, pair, stack, stack, chain8):
        raise AssertionError(f"the tiny step launched (chain, fused forward, "
                             f"fused backward, stack forward, stack "
                             f"backward, fused chain) = {counts}, expected "
                             f"{launches}")
    grads = {f"{tag}.{k}": p.grad.detach().cpu()
             for tag, m in (("score", tr.score_model), ("flow",
                                                         tr.flow_model))
             for k, p in m.named_parameters() if p.grad is not None}
    out[d] = ({k: v.detach().cpu() for k, v in aux.items()}, grads)
  (l_cpu, g_cpu), (l_gpu, g_gpu) = out["cpu"], out["cuda"]
  loss_err = max(((l_gpu[k] - l_cpu[k]).abs().max()
                  / l_cpu[k].abs().max()).item() for k in l_cpu)
  if set(g_cpu) != set(g_gpu) or len(g_cpu) < 100:
    raise AssertionError("the card and the CPU produced other gradients")
  net_max = {tag: max(v.abs().max().item() for k, v in g_cpu.items()
                      if k.startswith(tag)) for tag in ("score", "flow")}
  grad_err, worst = 0.0, ""
  for k, want in g_cpu.items():
    floor = TRAIN_SMALL_GRAD_FLOOR * net_max[k.split(".")[0]]
    err = ((g_gpu[k] - want).abs().max()
           / (want.abs().max() + floor)).item()
    if err > grad_err:
      grad_err, worst = err, k
  log(f"small reference training step {overrides or {}}: card vs cpu "
      f"losses max rel err "
      f"{loss_err:.3e} (limit {TRAIN_SMALL_RTOL}); gradients max rel err "
      f"{grad_err:.3e} at {worst} (limit {TRAIN_SMALL_GRAD_RTOL}, "
      f"{len(g_cpu)} tensors)")
  if not (loss_err <= TRAIN_SMALL_RTOL and grad_err <= TRAIN_SMALL_GRAD_RTOL):
    raise AssertionError("the tiny training step on the card disagrees with "
                         "the CPU")


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
    smi = phase_card_and_build()
    cfg = smoke_config()
    run_lib.set_f32_numerics()
    log(f"tf32: cudnn.allow_tf32={torch.backends.cudnn.allow_tf32} "
        f"cuda.matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32}")
    from indm_torch.models.registry import create_model
    model = create_model(cfg, seed=cfg.seed, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(2)
    x = torch.randn(BATCH, 3, 32, 32, device="cuda", generator=gen)
    t = torch.full((BATCH,), 0.3, device="cuda")
    per_eval, max_err, gn_shapes = phase_group_norm(model, x, t * 999)
    phase_score(cfg, model, x, t)
    del model
    torch.cuda.empty_cache()
    res, launches = phase_sample(cfg, os.path.join(REPO, "build",
                                                   "chip_smoke"))
    phase_small_reference(cfg)
    stamp("VP sampling phases 2-5")
    ve_cfg = ve_config()
    fir_per_eval, fir_err, ve_eval_ms = phase_ve_score(ve_cfg)
    torch.cuda.empty_cache()
    ve_round, ve_launches = phase_ve_sample(
        ve_cfg, os.path.join(REPO, "build", "chip_smoke_ve"))
    phase_ve_small_reference(ve_cfg)
    torch.cuda.empty_cache()
    stamp("VE sampling phases 5b-5e")
    per_term, chain_err = phase_chain()
    chain8_fits, chain8_err = phase_fused_chain()
    narrow, narrow_launches, narrow_err = phase_narrow_conv()
    gn_bwd, gn_bwd_err = phase_group_norm_backward(gn_shapes)
    fused_fits, fused_err = phase_fused()
    stack, stack_err = phase_fused_stack()
    stamp("kernel phases 6-9b")
    with chain_switch(None):
      train, train_launches, chain = phase_train(PER_STEP, per_term=per_term)
    with chain_switch("1"):
      train_chain8, chain8_launches, chain8 = phase_train(
          PER_STEP_CHAIN8, chain8_fits=chain8_fits)
    with stack_switch("0"):
      train_fused, fused_launches, fused = phase_train(
          PER_STEP_FUSED, FUSED_TRAIN, fused_fits=fused_fits)
    with stack_switch(None):
      train_stack, stack_launches, _ = phase_train(PER_STEP_STACK,
                                                   FUSED_TRAIN)
    check_stack_losses(train_stack, train_fused)
    stamp("training phases 9-10b")
    with chain_switch(None):
      phase_small_train(cfg, {}, (4, 0, 0, 0))
    with chain_switch("1"):
      phase_small_train(cfg, CHAIN8_SMALL, (0, 0, 0, 4))
    with stack_switch("0"):
      phase_small_train(cfg, FUSED_SMALL, (0, 4, 0, 0))
    with stack_switch(None):
      phase_small_train(cfg, STACK_SMALL, (0, 1, 2, 0))
    stamp("training references 11")
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
  stack_route_ms = (train_stack["profile"] or {}).get("fused_ms")
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
               "step of that route")
  kernels = [{
      "name": "group_norm_fwd", "route": "cuda",
      "source": "indm_torch/csrc/group_norm.cu",
      "replaces": "indm_tpu/ops/group_norm_pallas.py:151",
      "launches": launches, "max_abs_err": max_err,
      "ms": per_eval["ms"], "plain_ms": per_eval["plain_ms"],
      "bound_ms": per_eval["bound_ms"], "bound_by": "bytes",
      "library_ms": per_eval["library_ms"],
      "launches_train": train_launches["group_norm_fwd"],
      "per": f"the {GN_PER_SCORE_EVAL} float32 launches of one score "
             f"evaluation at batch {BATCH}; launches from the round, "
             f"launches_train from the {TRAIN_STEPS} training steps"}, {
      "name": "group_norm_bwd", "route": "cuda",
      "source": "indm_torch/csrc/group_norm.cu",
      "replaces": "indm_tpu/ops/group_norm_pallas.py:176",
      "launches": train_launches["group_norm_bwd"],
      "max_abs_err": gn_bwd_err, "ms": gn_bwd["ms"],
      "plain_ms": gn_bwd["plain_ms"], "bound_ms": gn_bwd["bound_ms"],
      "bound_by": "bytes", "library_ms": gn_bwd["library_ms"],
      "per": f"the {PER_STEP['group_norm_bwd']} float32 launches of one "
             f"training step at batch {TRAIN_BATCH}"}, {
      "name": "neumann_chain", "route": "cuda",
      "source": "indm_torch/csrc/neumann_chain.cu",
      "replaces": "indm_tpu/ops/neumann_pallas.py:176",
      "launches": train_launches["neumann_chain"],
      "max_abs_err": chain_err, "ms": chain["chain_ms"],
      "plain_ms": chain["chain_plain_ms"],
      "bound_ms": chain["chain_bound_ms"], "bound_by": "operations",
      "library_ms": chain["chain_library_ms"],
      "per": f"the {PER_STEP['neumann_chain']} calls of one training step "
             f"at batch {TRAIN_BATCH}, n as drawn in the {TRAIN_STEPS} "
             "steps, from the per-term times of the n = 6 calls"}, {
      "name": "fused_block_fwd", "route": "cuda",
      "source": "indm_torch/csrc/fused_block.cu",
      "replaces": "indm_tpu/ops/fused_block.py:280",
      "launches": fused_launches["fused_block_fwd"],
      "max_abs_err": fused_err["fwd"], "ms": fused["fwd"],
      "plain_ms": fused["fwd_plain"], "bound_ms": fused["fwd_bound"],
      "bound_by": "operations", "library_ms": None,
      "chain_route_ms": fused["chain_route_fwd"],
      "block_route_ms": fused["block_fwd"], "profile_pair_ms": pair_ms,
      "per": f"the {steps}"}, {
      "name": "fused_block_bwd", "route": "cuda",
      "source": "indm_torch/csrc/fused_block.cu",
      "replaces": "indm_tpu/ops/fused_block.py:467",
      "launches": fused_launches["fused_block_bwd"],
      "max_abs_err": fused_err["bwd"], "ms": fused["bwd"],
      "plain_ms": fused["bwd_plain"], "bound_ms": fused["bwd_bound"],
      "bound_by": "operations", "library_ms": None,
      "chain_route_ms": fused["chain_route_bwd"],
      "block_route_ms": fused["block_bwd"], "profile_pair_ms": pair_ms,
      "per": f"the {steps}"}] + [{
      "name": f"fused_stack_{d}", "route": "cuda",
      "source": "indm_torch/csrc/fused_stack.cu",
      "replaces": f"indm_tpu/ops/fused_stack.py:{line}",
      "launches": stack_launches[f"fused_stack_{d}"],
      "max_abs_err": stack_err[d], "ms": stack[d],
      "plain_ms": stack[f"{d}_plain"], "bound_ms": stack[f"{d}_bound"],
      "bound_by": "operations", "library_ms": None,
      "fn_ms": stack[f"fn_{d}"], "looped_pair_ms": stack[f"pair_{d}"],
      "profile_fused_ms": stack_route_ms, "per": stack_per}
      for d, line in (("fwd", 153), ("bwd", 340))] + [{
      "name": "upfirdn2d", "route": "cuda",
      "source": "indm_torch/csrc/upfirdn2d.cu",
      "replaces": "indm_tpu/ops/upfirdn2d_pallas.py:116",
      "launches": ve_launches["upfirdn2d"], "max_abs_err": fir_err,
      "ms": fir_per_eval["ms"], "plain_ms": fir_per_eval["plain_ms"],
      "bound_ms": fir_per_eval["bound_ms"], "bound_by": "bytes",
      "library_ms": fir_per_eval["library_ms"],
      "per": f"the {VE_FIR_PER_EVAL} float32 launches of one VE score "
             f"evaluation at batch {BATCH}; launches from the VE PC round "
             f"of {ve_round['num_scales']} scales; library_ms: one grouped "
             "F.conv2d (F.conv_transpose2d for up = 2) per launch"}, {
      "name": "fused_neumann_chain", "route": "cuda",
      "source": "indm_torch/csrc/fused_chain.cu",
      "replaces": "indm_tpu/ops/neumann_pallas.py:338",
      "launches": chain8_launches["fused_neumann_chain"],
      "max_abs_err": chain8_err, "ms": chain8["chain8_ms"],
      "plain_ms": chain8["chain8_plain_ms"],
      "bound_ms": chain8["chain8_bound_ms"], "bound_by": "operations",
      "library_ms": None,
      "chain_mats_k7_ms": chain8["chain8_chain_mats_k7_ms"],
      "block_ms": chain8["chain8_block_ms"],
      "profile_ms": (train_chain8["profile"] or {}).get(
          "fused_neumann_chain_ms"),
      "per": f"the {PER_STEP_CHAIN8['fused_neumann_chain']} calls of one "
             f"training step at batch {TRAIN_BATCH} (INDM_FUSED_CHAIN=1), "
             f"n as drawn in its {TRAIN_STEPS} steps, from each (scale, "
             f"pre-activated) block's times with hp at n = {min(CHAIN_NS)} "
             f"and {max(CHAIN_NS)} in isolated calls; launches from those "
             "steps; no single PyTorch call computes it; chain_mats_k7_ms: "
             "the route it replaces on the same IResBlock (chain_mats, "
             "then kernel 7); block_ms: kernel 8 on that block with its "
             "weights packed in the call (fused_chain_inputs); profile_ms: "
             "its device time in the profiled step"}, {
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
             "bfloat16 and float32"}]
  log(json.dumps({"kernels": kernels,
                  "round": {"nfe": res["nfe"], "seconds": res["seconds"],
                            "images_per_s": res["images_per_s"]},
                  "ve_round": {**ve_round, "score_eval_ms": ve_eval_ms},
                  "train": train, "train_chain8": train_chain8,
                  "train_fused": train_fused,
                  "train_stack": train_stack}))
  log(smi)
  log(json.dumps({"ok": True, "device": {
      "platform": "gpu", "kind": torch.cuda.get_device_name(0),
      "count": torch.cuda.device_count()}}))
  return 0


if __name__ == "__main__":
  sys.exit(main())
