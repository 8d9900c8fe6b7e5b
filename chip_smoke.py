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
6. the Neumann-chain kernel against its plain version at both full-width
   flow scales (batch 128; 3 channels at 32x32 and 12 at 16x16, width
   512), pre-activated and not, n in {0, 2, 6}, timed beside its
   operations bound, the plain version and the same chain through
   `F.conv2d`.
7. the GroupNorm backward kernel against its plain version at the 13
   (shape, activation) pairs of the score net at batch 128, float32 and
   bfloat16, timed beside its bytes bound, the plain version and the
   autograd backward of `F.group_norm` (+ `F.silu`).
8. three joint training steps (`step_nll`) of `vp/CIFAR10/indm_nll` at full
   width and batch 128 through `indm_torch.run_lib`, with the config's own
   init and dropout: finite losses, losses = score + flow + logp, both
   nets and the encoder's BatchNorm statistics changed, launches per step
   (GroupNorm forward 95, backward 95, chain 32), seconds per step,
   images/s, peak memory; then one more step under `torch.profiler`.
9. a small-input reference for training: one step's losses and gradients
   at the tiny geometry, card against CPU, same weights and noise.
10. a JSON line of the ported kernels and, last, `{"ok": true, ...}`.

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
TRAIN_BATCH = 128
TRAIN_STEPS = 3
# launches per training step: the score net's GroupNorms forward and
# backward, and one chain per iResBlock (16 + 16)
PER_STEP = {"group_norm_fwd": 95, "group_norm_bwd": 95, "neumann_chain": 32}
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


def smoke_config():
  from indm_torch.configs import get_config
  cfg = get_config("vp/CIFAR10/indm_nll")
  cfg.model.fused_groupnorm = True
  cfg.model.init_scale = 1.0
  cfg.sampling.batch_size = BATCH
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


def profile_score_eval(score_fn, x, t, top=8):
  """Device time of one score evaluation by kernel, and the share of the
  host's wall time (profiler on) in which the device was busy."""
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
  gn_ms = sum(e.self_device_time_total for e in kernels
              if "group_norm_fwd_kernel" in e.key) / 1e3
  log(f"profile of one score eval: device busy {busy_ms:.3f} ms of "
      f"{wall_ms:.3f} ms wall ({busy_ms / wall_ms:.4f}); group_norm kernel "
      f"{gn_ms:.3f} ms ({gn_ms / busy_ms:.4f} of device time)")
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
  small = copy.deepcopy(cfg)
  for name, value in SMALL.items():
    *path, leaf = name.split(".")
    node = small
    for part in path:
      node = node[part]
    node[leaf] = value
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
      d: r[2] for d, r in rounds.items()}
  log(f"small reference round: nfe cuda={nfe['cuda']} cpu={nfe['cpu']}")
  if not torch.isfinite(after["cuda"]).all():
    raise AssertionError("the small round on the card is not finite")
  check("ODE round", rel(after["cuda"], after["cpu"].float()),
        SMALL_ROUND_RTOL)


def chain_flops_per_term(b, c, hw, width=CHAIN_WIDTH):
  """2 * B*H*W * (9*C*I + I*I + 9*I*C): the three transposed convs."""
  return 2 * b * hw * hw * (9 * c * width + width * width + 9 * width * c)


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


def phase_train(per_term):
  """Three full-width steps at batch 128, then one under the profiler."""
  from indm_torch import run_lib
  from indm_torch.configs import get_config
  from indm_torch.flows.resflow import LAMB, OFFSET_TRAIN, SinAct
  from indm_torch.ops import group_norm as gn
  from indm_torch.ops import neumann
  cfg = get_config("vp/CIFAR10/indm_nll")
  cfg.model.fused_groupnorm = True
  cfg.flow.logdet_pallas = True
  if cfg.training.batch_size != TRAIN_BATCH:
    raise AssertionError("the config's training batch is not 128")
  tr = run_lib.build_training(cfg, device="cuda")
  blocks = tr.flow_model.resflow.blocks()
  if len(blocks) != PER_STEP["neumann_chain"]:
    raise AssertionError(f"{len(blocks)} iResBlocks, expected 32")
  # each block's (scale, pre-activated), and the n its chains will draw
  channels = [c for c, _ in CHAIN_SCALES]
  kinds = [(channels.index(b.nnet[-1].weight.shape[0]),
            isinstance(b.nnet[0], SinAct)) for b in blocks]
  n_rng = copy.deepcopy(tr.host_rng)
  ns = [int(n_rng.poisson(LAMB)) for _ in range(len(blocks) * TRAIN_STEPS)]
  before = _snapshot(tr)
  torch.cuda.synchronize()
  torch.cuda.reset_peak_memory_stats()
  rows, launches = [], collections.Counter()
  for i in range(TRAIN_STEPS):
    gn.reset_launches()
    neumann.reset_launches()
    (row,) = run_lib.train_steps(tr, 1, log=log, first_step=i)
    counts = {"group_norm_fwd": gn.launches,
              "group_norm_bwd": gn.bwd_launches,
              "neumann_chain": neumann.launches}
    log(f"train step {i}: launches {counts}")
    if counts != PER_STEP:
      raise AssertionError(f"step {i} launched {counts}, expected "
                           f"{PER_STEP}")
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

  # the chain's time per step from its per-term times, at the n drawn
  chain = collections.defaultdict(float)
  for i, n in enumerate(ns):
    scale, preact = kinds[i % len(blocks)]
    terms = n + OFFSET_TRAIN
    c, hw = CHAIN_SCALES[scale]
    for k, v in per_term[(scale, preact)].items():
      chain[k] += terms * v / TRAIN_STEPS
    chain["bound_ms"] += (terms * chain_flops_per_term(TRAIN_BATCH, c, hw)
                          / F32_FLOPS * 1e3 / TRAIN_STEPS)
  terms = sum(ns) / TRAIN_STEPS + OFFSET_TRAIN * len(blocks)
  log(f"neumann_chain per training step ({len(blocks)} calls, {terms:.1f} "
      "terms on average): " + " ".join(f"{k}={v:.3f}" for k, v in
                                      chain.items()))
  train["profile"] = profile_train_step(tr)
  del tr
  torch.cuda.empty_cache()
  return train, launches, dict(chain)


KERNEL_NAMES = {"neumann_chain": ("conv_in_kernel", "gemm_dmul_kernel",
                                  "conv_out_kernel"),
                "group_norm_fwd": ("group_norm_fwd_kernel",),
                "group_norm_bwd": ("group_norm_bwd_kernel",
                                   "sum_over_batch_kernel")}


def profile_train_step(tr, top=12):
  """Device time of one training step by kernel, and the device's busy
  share of the host's wall time (profiler on)."""
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
  for name, keys in KERNEL_NAMES.items():
    out[f"{name}_ms"] = sum(e.self_device_time_total for e in kernels
                            if any(k in e.key for k in keys)) / 1e3
  log(f"profile of one training step: device busy {busy_ms:.3f} ms of "
      f"{wall_ms:.3f} ms wall ({busy_ms / wall_ms:.4f}); "
      + " ".join(f"{k}={v:.3f}" for k, v in out.items()
                 if k.endswith("_ms") and k not in ("wall_ms", "busy_ms")))
  for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:top]:
    log(f"  {e.self_device_time_total / 1e3:9.3f} ms  x{e.count:<5d} "
        f"{e.key[:100]}")
  # which convolutions the device time belongs to: (input, weight) shapes
  convs = [e for e in prof.key_averages(group_by_input_shape=True)
           if e.key in ("aten::cudnn_convolution", "aten::convolution_backward")]
  log("convolutions by device time (op, calls, input and weight shapes):")
  for e in sorted(convs, key=lambda e: -e.device_time_total)[:top]:
    log(f"  {e.device_time_total / 1e3:9.3f} ms  x{e.count:<5d} {e.key} "
        f"{e.input_shapes[:3]}")
  return out


def phase_small_train(cfg):
  """One tiny step's losses and gradients, card against CPU."""
  from indm_torch import joint, run_lib
  from indm_torch.flows.flow_model import FlowNoise, sample_flow_noise
  import numpy as np
  small = copy.deepcopy(cfg)
  for name, value in {**SMALL, "model.dropout": 0.0,
                      "training.batch_size": SMALL_BATCH,
                      "flow.logdet_pallas": True}.items():
    *path, leaf = name.split(".")
    node = small
    for part in path:
      node = node[part]
    node[leaf] = value
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
    aux = losses(batch.to(d), nd)
    aux["losses"].mean().backward()
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
  log(f"small reference training step: card vs cpu losses max rel err "
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
    torch.cuda.empty_cache()
    per_term, chain_err = phase_chain()
    gn_bwd, gn_bwd_err = phase_group_norm_backward(gn_shapes)
    train, train_launches, chain = phase_train(per_term)
    phase_small_train(cfg)
  except Exception:  # any phase failure ends the run without a result
    traceback.print_exc()
    return 1
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
      "max_abs_err": chain_err, "ms": chain["ms"],
      "plain_ms": chain["plain_ms"], "bound_ms": chain["bound_ms"],
      "bound_by": "operations", "library_ms": chain["library_ms"],
      "per": f"the {PER_STEP['neumann_chain']} calls of one training step "
             f"at batch {TRAIN_BATCH}, n as drawn in the {TRAIN_STEPS} "
             "steps, from the per-term times of the n = 6 calls"}]
  log(json.dumps({"kernels": kernels,
                  "round": {"nfe": res["nfe"], "seconds": res["seconds"],
                            "images_per_s": res["images_per_s"]},
                  "train": train}))
  log(smi)
  log(json.dumps({"ok": True, "device": {
      "platform": "gpu", "kind": torch.cuda.get_device_name(0),
      "count": torch.cuda.device_count()}}))
  return 0


if __name__ == "__main__":
  sys.exit(main())
